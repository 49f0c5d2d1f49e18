"""FSDP over the mesh's ``data`` axis: the reference's ``"fsdp"`` rule
(``repro/sharding/rules.py``: each weight's d_model / fan-in axis on
``data``) on processes that each hold their own block, beside the
model axis's tensor-parallel blocks.

The reference cuts each weight's "fsdp" dim over ``data`` and its "tp"
(heads, ff, vocab) dim over ``model``, and leaves it to GSPMD to gather
the weight where it is used and to reduce its gradient.  The port runs
one process per rank, so both are written out:

* :class:`Plan`: per leaf of a parameter tree, the dim that ``"fsdp"``
  splits over ``data`` (:func:`data_dims`: under ``LOGICAL_RULES``,
  resolved strictly, or None for a leaf the rule leaves whole: a dim
  ``data`` does not divide, norm weights, biases, any leaf on a data axis
  of 1) and its split over ``model`` (a :class:`TPSplit`, or None where
  the leaf is whole on every model rank; ``steps.tp_splits`` decides).
  The same layout cuts AdamW's ``m`` and ``v`` (``params.train_shard``).
* :func:`gather`: one autograd op.  Forward: every data rank's block of
  a leaf, in rank order, concatenated along its dim (an all-gather over
  ``data`` in the leaf's dtype: callers gather the compute copy, bf16 on
  the card, not the f32 master).  A leaf split on both axes is gathered
  into this model rank's tensor-parallel block, never made whole.
  Backward: the gathered leaf's gradient upcast to f32, summed over the
  data ranks, and this rank's block kept.  Gloo has no CUDA
  ``reduce_scatter``, so the sum is an all-reduce plus a slice, on both
  backends (a reduce-scatter under nccl waits for a machine with two
  cards).  Autograd hands the block back in the leaf's dtype, and the
  cast's backward upcasts it to the master's f32 gradient.
* :func:`data_sum`: a sum over the data ranks in place: whole leaves'
  gradients, the labelled-token counts, the loss, the clip norm's
  squares; :func:`model_sum` the same over the model ranks (the clip
  norm's squares of the leaves split over ``model``); :func:`pod_sum`
  over the pod ranks, and :func:`batch_sum` over both axes that split
  the batch (``LOGICAL_RULES``' ``"batch"``: pod x data): every leaf's
  gradient, the counts and the loss are summed over pod too, since the
  parameters are whole across pods; :func:`data_all_reduce` the batch
  axes' twin of ``models.layers.tp_all_reduce``: an autograd op, the
  sum forward and the identity backward (the MoE load-balance term's
  means over the global batch, ``models.moe.global_stats``), counted as
  its :func:`data_sum` and :func:`pod_sum`.

Every gather and every sum is counted with the bytes it carries, per
axis (``gather.calls`` / ``gather.bytes`` and ``data_sum.calls`` /
``data_sum.bytes`` on ``data``, ``model_sum.calls`` / ``model_sum.bytes``
on ``model``, ``pod_sum.calls`` / ``pod_sum.bytes`` on ``pod``).  On an
axis of size 1 they are no collective and count
nothing.  The checkpoint's assembly of whole leaves
(:func:`whole_on_host`) gathers over both axes; its model gathers are
not counted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..kernels.counter import LaunchCounter
from .rules import logical_spec


@dataclass(frozen=True)
class TPSplit:
    """How a leaf is split over ``model``: along ``dim``, every rank its
    contiguous block in the order of its coordinate; with ``width``, only
    the dim's first ``width`` entries are split and the rest are whole on
    every rank (the SSD mixer's B and C channels, ``models.ssm.TP_LOCAL``).
    Not a tuple, so that tree walks take it as a leaf."""
    dim: int
    width: int | None = None


class Plan(NamedTuple):
    """A train state's layout on a mesh: the mesh and, per parameter
    leaf, the dim split over ``data`` (None: whole on every data rank)
    and the split over ``model`` (a :class:`TPSplit`; None: whole on
    every model rank)."""
    mesh: object
    dims: object
    tp: object

    def state_dims(self):
        """The data dims of a train state ``{"params", "opt": {"m", "v"},
        "step"}``: m and v split as the params, ``step`` whole."""
        return {"params": self.dims,
                "opt": {"m": self.dims, "v": self.dims}, "step": None}

    def state_tp(self):
        """The model splits of a train state, as :meth:`state_dims`."""
        return {"params": self.tp,
                "opt": {"m": self.tp, "v": self.tp}, "step": None}


def _is_meta(x):
    return hasattr(x, "axes") and hasattr(x, "shape")


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(t[k] for t in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v, *(t[i] for t in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def data_dims(meta, mesh):
    """The dim each leaf of ``meta`` (a tree of leaves with ``shape`` and
    logical ``axes``: ``models.lm.param_meta``) splits over ``data`` on
    ``mesh``, strictly, or None where it stays whole (every leaf on a
    data axis of 1)."""
    def dim(m):
        if mesh.shape["data"] == 1:
            return None
        spec = logical_spec(m.shape, m.axes, mesh, strict=True)
        for d, part in enumerate(spec):
            names = (part,) if isinstance(part, str) else part or ()
            if "data" in names:
                return d
        return None

    def walk(t):
        if _is_meta(t):
            return dim(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return tuple(walk(v) for v in t)

    return walk(meta)


def block(t, dim, mesh):
    """This rank's block of the whole tensor ``t`` along ``dim`` over
    ``data``."""
    n = mesh.shape["data"]
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"{n} ways")
    step = t.shape[dim] // n
    return t.narrow(dim, mesh.coords["data"] * step, step)


def model_block(t, split, mesh):
    """This rank's block over ``model`` of ``t``, whole on that axis, by
    ``split`` (a :class:`TPSplit`; None: ``t`` itself)."""
    n = mesh.shape["model"]
    if split is None or n == 1:
        return t
    dim, width = split.dim % t.dim(), split.width
    w = t.shape[dim] if width is None else width
    if w % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} (its first {w}) "
                         f"does not split {n} ways")
    part = t.narrow(dim, mesh.coords["model"] * (w // n), w // n)
    if width is None:
        return part
    return torch.cat([part, t.narrow(dim, width, t.shape[dim] - width)],
                     dim=dim)


def model_parts(t, split, n):
    """(the part of a block ``t`` split over a model axis of ``n``, the
    part whole on every model rank), None where there is none."""
    if split is None or n == 1:
        return None, t
    if split.width is None:
        return t, None
    loc = split.width // n
    return (t.narrow(split.dim, 0, loc),
            t.narrow(split.dim, loc, t.shape[split.dim] - loc))


def model_whole(t, split, mesh):
    """The leaf whole over ``model`` from every model rank's block ``t``
    (one all-gather over ``model``, not counted: a checkpoint's)."""
    n = mesh.shape["model"]
    if split is None or n == 1:
        return t
    parts = mesh.all_gather(t.contiguous(), "model")
    dim = split.dim % t.dim()
    if split.width is None:
        return torch.cat(parts, dim=dim)
    loc = split.width // n
    return torch.cat([p.narrow(dim, 0, loc) for p in parts]
                     + [parts[0].narrow(dim, loc, t.shape[dim] - loc)],
                     dim=dim)


def shard_leaf(t, dim, split, mesh):
    """This rank's block of the whole leaf ``t``: its model block
    (``split``), then that block's data block (``dim``), copied so that
    the whole leaf can be freed."""
    t = model_block(t, split, mesh)
    if dim is not None:
        t = block(t, dim, mesh)
    return t.clone(memory_format=torch.contiguous_format)


def data_sum(t, mesh):
    """Sum ``t`` over the data ranks, in place (one all-reduce, counted;
    nothing on a data axis of 1); returns it."""
    if mesh.shape["data"] == 1:
        return t
    data_sum.calls.add()
    data_sum.bytes.add(t.numel() * t.element_size())
    return mesh.all_reduce(t, "data")


def pod_sum(t, mesh):
    """Sum ``t`` over the pod ranks, in place (one all-reduce, counted;
    nothing without a pod axis above 1); returns it."""
    if mesh.shape.get("pod", 1) == 1:
        return t
    pod_sum.calls.add()
    pod_sum.bytes.add(t.numel() * t.element_size())
    return mesh.all_reduce(t, "pod")


def batch_sum(t, mesh):
    """Sum ``t`` over the ranks that split the batch (``LOGICAL_RULES``:
    pod x data), in place: :func:`data_sum`, then :func:`pod_sum`."""
    return pod_sum(data_sum(t, mesh), mesh)


class _DataAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return batch_sum(x.clone(memory_format=torch.contiguous_format),
                         mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def data_all_reduce(x, mesh):
    """``x`` summed over the ranks that split the batch (a copy;
    :func:`batch_sum`: over data, then over pod where there is one).
    Under autograd its backward is the identity: every such rank's
    consumer reads the same sum, so the ranks' gradients, summed over
    pod and data as every gradient is, make the global one."""
    return _DataAllReduce.apply(x, mesh)


def model_sum(t, mesh):
    """Sum ``t`` over the model ranks, in place (one all-reduce, counted;
    nothing on a model axis of 1); returns it."""
    if mesh.shape["model"] == 1:
        return t
    model_sum.calls.add()
    model_sum.bytes.add(t.numel() * t.element_size())
    return mesh.all_reduce(t, "model")


def gather_blocks(local, dim, mesh):
    """Every data rank's ``local``, in rank order, along ``dim`` (one
    all-gather over ``data``, counted)."""
    out = torch.cat(mesh.all_gather(local, "data"), dim=dim)
    gather.calls.add()
    gather.bytes.add(out.numel() * out.element_size())
    return out


def sum_blocks(grad, dim, mesh):
    """This rank's block of ``grad`` summed over the data ranks, in f32:
    an all-reduce and a slice."""
    return block(data_sum(grad.float().contiguous(), mesh), dim, mesh)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return gather_blocks(local.contiguous(), dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        return sum_blocks(grad, ctx.dim, ctx.mesh), None, None


def gather(local, dim, mesh):
    """The leaf whole over ``data`` from every data rank's block ``local``
    along ``dim`` (autograd: the gradient's f32 sum over the data ranks,
    this rank's block; see the module's docstring)."""
    return _Gather.apply(local, dim, mesh)


def take(tree, dims, mesh, index=None):
    """``tree`` with each split leaf (``dims`` not None) gathered whole
    over ``data``; ``index``: each leaf's ``[index]`` first (one repeat of
    a stacked block, whose split dim moves down by one)."""
    def one(t, d):
        if index is not None:
            t, d = t[index], None if d is None else d - 1
        return t if d is None else gather(t, d, mesh)

    return _map(one, tree, dims)


def whole_on_host(t, dim, mesh, split=None):
    """Rank 0: the whole leaf on the host, assembled from every rank's
    block: gathered over ``data`` along ``dim`` (None: whole there), then
    over ``model`` by ``split`` (None: whole there).  Every rank must call
    it in the same order: it gathers over both axes.  Returns None on the
    other ranks."""
    if dim is not None:
        t = gather_blocks(t.contiguous(), dim, mesh)
    t = model_whole(t, split, mesh)
    return t.to("cpu", copy=True) if mesh.rank == 0 else None


gather.calls = LaunchCounter()
gather.bytes = LaunchCounter()
data_sum.calls = LaunchCounter()
data_sum.bytes = LaunchCounter()
model_sum.calls = LaunchCounter()
model_sum.bytes = LaunchCounter()
pod_sum.calls = LaunchCounter()
pod_sum.bytes = LaunchCounter()

__all__ = ["Plan", "TPSplit", "data_dims", "block", "model_block",
           "model_parts", "model_whole", "shard_leaf", "data_sum",
           "model_sum", "pod_sum", "batch_sum", "data_all_reduce",
           "gather",
           "take", "gather_blocks", "sum_blocks", "whole_on_host"]
