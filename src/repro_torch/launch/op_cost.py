"""Cost model over the aten ops a step runs (PyTorch port of
``repro/launch/hlo_cost.py``).

The reference parses XLA's post-partitioning HLO text and multiplies
loop bodies by their trip counts.  The port has no HLO: ``OpCost`` is a
``TorchDispatchMode`` that sees every aten op as it runs, below
autograd, so a backward's ops and a remat recompute count as they run.
The model's Python loops run every layer, so there is nothing to
multiply.  On meta tensors (``launch/specs.py``) a full-size cell costs
no memory and no device time.

A call of a kernel's wrapper (``kernels/counter.kernel_site``) is
charged as the kernel: its own FLOPs and bytes (the wrapper's ``work``),
and its results as allocated, in place of the ops the call dispatches
(on the CPU or meta its plain version, which may do more: attention's
full score square and its score matrix, where the kernel skips the
masked blocks and keeps no scores).  ``OpCost(kernels=False)`` counts
the plain versions' ops instead, the computation the reference's HLO
holds.

  * flops       — matmul-class ops (``mm``, ``addmm``, ``bmm``,
                  ``baddbmm``, convolutions, SDPA) by
                  ``torch.utils.flop_counter``'s formulas; elementwise
                  ops at 1 flop per result element and reductions at 1
                  per input element, as ``hlo_cost.py`` counts them
                  (copies and converts at none); softmax at 5 per element
                  and sorts at 5, the ops XLA would emit for them;
  * bytes       — operand + result bytes of every op that moves data
                  (views and aliases move none), the upper bound; an
                  in-place op is charged twice the bytes it writes (read
                  and write of the update), as ``hlo_cost.py`` charges a
                  dynamic-update-slice;
  * bytes_fused — the same without elementwise ops and converts
                  (``_FUSED_AWAY``), which a fusing compiler folds into
                  their neighbours; ``bytes_by_op`` breaks it down;
  * bytes_min   — the step's arguments read once and its new results
                  written once, with in-place writes into an argument (a
                  cache slot, an AdamW update) charged at the bytes they
                  write, at most the argument's size (``op_cost`` only);
  * peak_temp   — the most bytes of storage allocated by the ops and
                  alive at once, arguments excluded (a kernel's site:
                  its results, not its scratch).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# flops per element of the first operand, for ops XLA would lower to
# several reduces and elementwise ops (softmax: max, subtract, exp, sum,
# divide) or to a sort
_PER_ELEMENT = {
    aten._softmax: 5, aten._log_softmax: 5,
    aten._softmax_backward_data: 3, aten._log_softmax_backward_data: 3,
    aten.sort: 5, aten.topk: 5, aten.cumsum: 1,
}

# copies and converts: tagged pointwise, but they move data and compute
# nothing (XLA's copy and convert count no flop either)
_COPIES = {aten.clone, aten._to_copy, aten.copy, aten.copy_}

# ops whose traffic a fusing compiler folds into their neighbours, beside
# every op tagged pointwise: converts, and constants it materialises
_FUSED_AWAY = {aten._to_copy, aten.arange, aten.full, aten.fill_,
               aten.fill, aten.zero_, aten.scalar_tensor, aten.lift_fresh}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _key(t) -> int:
    return t.untyped_storage()._cdata


@dataclass
class Cost:
    flops: float = 0.0
    flops_matmul: float = 0.0       # the flop_counter ops alone
    flops_kernels: float = 0.0      # the kernels' sites alone
    bytes: float = 0.0              # every data-moving op (upper bound)
    bytes_fused: float = 0.0        # elementwise and converts fused away
    bytes_min: float = 0.0          # arguments + new results (op_cost)
    argument: int = 0               # the step's argument bytes (op_cost)
    output: int = 0                 # its result bytes (op_cost)
    peak_temp: int = 0              # most op-allocated bytes alive at once
    bytes_by_op: dict = field(default_factory=dict)   # fused breakdown
    # kernel -> [calls, flops, bytes] of its sites
    kernels: dict = field(default_factory=dict)


class OpCost(TorchDispatchMode):
    """Counts every aten op dispatched while it is active (``with
    OpCost() as oc: ...; oc.cost``).  ``args``: tensors (any tree) that
    are the step's arguments, whose storage is not charged to
    ``peak_temp`` and whose in-place writes ``op_cost`` charges to
    ``bytes_min``.  ``kernels``: charge a kernel's site as the kernel
    (the default) or count the ops of its plain version."""

    def __init__(self, args=(), kernels=True):
        super().__init__()
        self.charges_kernels = kernels
        self._hidden = 0                     # inside a kernel's site
        self.cost = Cost()
        self.arg_keys = {_key(t) for t in _tensors(args)}
        self.written: dict[int, int] = {}    # arg storage -> bytes written
        self._refs: dict[int, int] = {}      # live storage -> tensors
        self._sizes: dict[int, int] = {}
        self._live = 0

    def _release(self, key):
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self._live -= self._sizes.pop(key)

    def _track(self, outs, in_keys):
        for t in outs:
            key = _key(t)
            if key in self.arg_keys:
                continue
            if key not in self._refs:
                if key in in_keys:          # an input made before this mode
                    continue
                self._refs[key] = 0
                self._sizes[key] = t.untyped_storage().nbytes()
                self._live += self._sizes[key]
                self.cost.peak_temp = max(self.cost.peak_temp, self._live)
            self._refs[key] += 1
            weakref.finalize(t, self._release, key)

    def kernel(self, name, work, fn, args, kwargs):
        """A kernel's site (``kernel_site``): ``fn(*args, **kwargs)`` with
        its ops hidden, charged ``work()`` and its results' storage."""
        if self._hidden:                     # a site inside a site
            return fn(*args, **kwargs)
        self._hidden += 1
        try:
            out = fn(*args, **kwargs)
            flops, nbytes = work()
        finally:
            self._hidden -= 1
        c = self.cost
        c.flops += flops
        c.flops_kernels += flops
        c.bytes += nbytes
        c.bytes_fused += nbytes
        c.bytes_by_op[name] = c.bytes_by_op.get(name, 0.0) + nbytes
        k = c.kernels.setdefault(name, [0, 0.0, 0.0])
        k[0] += 1
        k[1] += flops
        k[2] += nbytes
        self._track(_tensors(out), {_key(t) for t in _tensors((args, kwargs))})
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._hidden:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        packet = func.overloadpacket
        c = self.cost

        # ---- flops
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            c.flops_matmul += f
        elif packet in _COPIES:
            f = 0.0
        elif torch.Tag.pointwise in func.tags:
            f = float(sum(t.numel() for t in outs))
        elif torch.Tag.reduction in func.tags:
            f = float(ins[0].numel()) if ins else 0.0
        elif packet in _PER_ELEMENT:
            f = float(_PER_ELEMENT[packet] * ins[0].numel())
        else:
            f = 0.0
        c.flops += f

        # ---- bytes
        in_keys = {_key(t) for t in ins}
        written = [a.name for a in func._schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write]
        if written:
            dst = _tensors(kwargs[written[0]] if written[0] in kwargs
                           else args[0])
            size = sum(_nbytes(t) for t in dst)
            others = sum(_nbytes(t) for t in ins
                         if not any(t is d for d in dst))
            # a scatter into a larger tensor writes its update; any other
            # in-place op rewrites its destination
            upd = others if 0 < others < size else size
            b = 2 * upd
            for t in dst:
                key = _key(t)
                if key in self.arg_keys:
                    self.written[key] = self.written.get(key, 0) + (
                        upd * _nbytes(t) // size if size else 0)
        elif outs and all(_key(t) in in_keys for t in outs):
            b = 0                           # a view or an alias
        else:
            b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        c.bytes += b
        if b and packet not in _FUSED_AWAY \
                and torch.Tag.pointwise not in func.tags:
            c.bytes_fused += b
            name = str(packet)
            c.bytes_by_op[name] = c.bytes_by_op.get(name, 0.0) + b
        self._track(outs, in_keys)
        return out


def op_cost(fn, *args, kernels=True, **kwargs):
    """``fn(*args, **kwargs)`` under ``OpCost(kernels=kernels)``: (its
    result, ``Cost``),
    with ``argument`` (the arguments' bytes, each storage once),
    ``output`` (the result's bytes, each storage once) and
    ``bytes_min`` filled in."""
    arg_t = _tensors((args, kwargs))
    mode = OpCost((args, kwargs), kernels)
    with mode:
        out = fn(*args, **kwargs)
    c = mode.cost
    sizes = {}
    for t in arg_t:
        sizes[_key(t)] = t.untyped_storage().nbytes()
    c.argument = sum(sizes.values())
    new, out_sizes = 0, {}
    for t in _tensors(out):
        k = _key(t)
        out_sizes[k] = t.untyped_storage().nbytes()
        if k not in sizes:
            new += out_sizes[k]
    c.output = sum(out_sizes.values())
    c.bytes_min = float(c.argument + new + sum(
        min(w, sizes[k]) for k, w in mode.written.items()))
    return out, c
