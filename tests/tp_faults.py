"""Faults planted in a tensor-parallel follower by ``Session.run``, for
``tests/test_torch_tp.py``.  A module of its own that imports no JAX
and nothing of ``repro``: a follower unpickles these functions by name,
so it imports this module, and it must stay clear of both."""
from repro_torch.models import layers


def mlp_raises_on_rank(state, rank, after):
    """From its ``after``-th dense MLP call on, rank ``rank`` raises (the
    other ranks run as built).  Returns the rank."""
    if state.mesh.rank == rank:
        orig, calls = layers.mlp_dense, [0]

        def faulty(*args, **kw):
            calls[0] += 1
            if calls[0] > after:
                raise RuntimeError(f"planted fault on rank {rank}")
            return orig(*args, **kw)

        from repro_torch.models import blocks
        blocks.mlp_dense = faulty
    return state.mesh.rank


def modules(state):
    """The rank's imported modules that are JAX or the reference."""
    import sys

    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.") or m == "repro"
                  or m.startswith("repro."))
