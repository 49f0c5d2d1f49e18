"""Logical-axis sharding rules (PyTorch port of
``repro/sharding/rules.py``).

Tensors are annotated with *logical* axis names; rules map them onto the
mesh axes that exist (``data``/``model``).  The rule table, the per-dim
resolution (strict: the dim must divide; padded: at most 2x waste) and the
cross-dim first-wins dedup are the reference's, line for line.  What
differs is what a spec is for.  The reference hands a ``PartitionSpec`` to
GSPMD, which partitions one program over every device; the port runs one
process per rank (``repro_torch.launch.mesh``), each holding only its own
shard, so a spec here is a tuple with one entry per dim (a mesh-axis name,
a tuple of names, or None) that says how to cut a full tensor
(:func:`local_shard`) and what shape a rank holds (:func:`shard_shape`).
:func:`shard` is the identity: a rank's tensors are already its shard.

A mesh is anything with a ``shape`` mapping axis name -> size; the port's
``launch.mesh.Mesh`` also carries this process's rank on each axis.
"""
from __future__ import annotations

import contextlib
import threading

# logical axis -> candidate mesh axes (in order). None -> replicated.
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),                  # replicated in train/prefill compute
    "seq_shard": ("model",),    # decode KV/SSM cache sequence axis
    "embed": (),                # activation d_model
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "ff_act": ("model",),
    "vocab": ("model",),
    "qk_rank": (),              # MLA latent ranks
    # weights: 2-D FSDP x TP
    "fsdp": ("data",),          # weight d_model / fan-in axis
    "tp": ("model",),           # weight fan-out axis (heads*dim, ff, vocab)
    "heads_w": ("model",),      # weight head axis (kept sharded in decode)
    "experts": (),              # experts replicated on the FSDP x TP grid
    "stack": (),                # stacked scan (pattern-repeat) axis
    # ssm
    "ssm_heads": ("model",),
    "ssm_state": (),
    "conv_dim": ("model",),
}


class _Ctx(threading.local):
    mesh = None
    rules: dict[str, tuple[str, ...]] | None = None


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh, rules: dict | None = None):
    """Activate a mesh (and rule overrides) for the model's layers on this
    thread: the serve steps open it around each forward."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, dict(LOGICAL_RULES, **(rules or {}))
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def current_rules() -> dict | None:
    """The active rule set (``LOGICAL_RULES`` with the context's
    overrides), or None outside a context."""
    return _CTX.rules


def resolved_axes(logical: str) -> tuple[str, ...]:
    """Mesh axes the *active* sharding context maps ``logical`` onto —
    () when no mesh is active or every candidate axis is absent."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None:
        return ()
    rules = rules if rules is not None else LOGICAL_RULES
    return tuple(a for a in rules.get(logical, ()) if a in mesh.shape)


def axis_size(mesh, names: tuple[str, ...]) -> int:
    n = 1
    for a in names:
        if a in mesh.shape:
            n *= mesh.shape[a]
    return n


def _resolve_dim(dim: int, logical: str | None, mesh,
                 rules: dict, strict: bool) -> str | tuple[str, ...] | None:
    if logical is None:
        return None
    cands = rules.get(logical, ())
    picked = []
    size = 1
    for a in cands:
        if a not in mesh.shape:
            continue
        nxt = size * mesh.shape[a]
        if strict:
            # argument shardings must divide evenly
            if dim % nxt == 0:
                picked.append(a)
                size = nxt
        elif dim >= nxt:         # constraints may pad (<=2x waste)
            picked.append(a)
            size = nxt
    if not picked:
        return None
    return picked[0] if len(picked) == 1 else tuple(picked)


def logical_spec(shape: tuple[int, ...], logical_axes: tuple[str | None, ...],
                 mesh, rules: dict | None = None,
                 strict: bool = False) -> tuple:
    """One entry per dim of ``shape``: the mesh axis (or tuple of axes)
    the dim is split over, or None (replicated).  The reference's
    ``PartitionSpec`` entries, as a plain tuple."""
    rules = dict(LOGICAL_RULES, **(rules or {})) if rules else LOGICAL_RULES
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {shape} vs logical axes {logical_axes}")
    parts = []
    used: set[str] = set()
    # cross-dim first-wins: a mesh axis taken by an earlier dim is dropped
    # from later dims (serve caches annotate both a sequence dim and a
    # head dim that map to "model"; the active rule set decides which one
    # wins by mapping the other to ())
    for d, la in zip(shape, logical_axes):
        part = _resolve_dim(d, la, mesh, rules, strict)
        if part is not None:
            names = (part,) if isinstance(part, str) else part
            names = tuple(a for a in names if a not in used)
            used.update(names)
            part = (None if not names else
                    names[0] if len(names) == 1 else names)
        parts.append(part)
    return tuple(parts)


def _names(part) -> tuple[str, ...]:
    return () if part is None else (part,) if isinstance(part, str) \
        else tuple(part)


def shard_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape one rank holds of a ``shape`` tensor laid out by
    ``spec`` (a :func:`logical_spec`): each split dim divided by the
    product of its axes' sizes.  Only even splits are held locally (the
    strict specs), so a dim that does not divide raises."""
    out = []
    for d, part in zip(shape, spec):
        n = axis_size(mesh, _names(part))
        if d % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{n} ways (spec {spec})")
        out.append(d // n)
    return tuple(out)


def local_shard(t, spec, mesh):
    """This rank's shard of the full tensor ``t`` laid out by ``spec``: a
    contiguous block of each split dim, block ``index`` where ``index`` is
    the rank's coordinate on the dim's axes (row-major over them).  Needs
    ``mesh.coords`` (axis -> this rank's index on it)."""
    for dim, part in enumerate(spec):
        names = _names(part)
        if not names:
            continue
        n, idx = 1, 0
        for a in names:
            idx = idx * mesh.shape[a] + mesh.coords[a]
            n *= mesh.shape[a]
        size = t.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"{n} ways")
        step = size // n
        t = t.narrow(dim, idx * step, step)
    return t


def shard(x, *logical_axes: str | None):
    """In-model sharding constraint of the reference: the identity here,
    because each process computes on its own shard (the layout is decided
    where the weights and caches are cut, and the collectives are written
    out in ``models.layers``)."""
    del logical_axes
    return x
