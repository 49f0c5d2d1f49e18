"""Why jamba-v0.1-52b's tiny config, at two blocks (16 layers), misses
``tests/fsdp_ref.py``'s bars at the second of two train steps on one
device, when one block (8 layers) holds them: three experiments on the
CPU, in f32, printing their figures.

    PYTHONPATH=src python tests/jamba_drift.py      (about 2 minutes)

The setup: the port's single-device ``steps.make_train_step`` against the
reference's ``jax.jit(make_train_step(cfg, None, hp))`` on
``get("jamba-v0.1-52b").tiny(opt_dtype="float32")``, two steps of
``fsdp_ref.batches`` from the reference's ``init_train_state``.

0. The straight run: the port's two steps from the first state, held by
   ``fsdp_ref.misses``.
1. The same state in, the step's gradients out: at each step, from the
   reference's state before it, the port's ``make_grad_step`` against
   ``jax.value_and_grad`` of the reference's loss, leaf by leaf (relative
   L2), and the loss; then the port's whole step 2 from the reference's
   state after step 1, by the bars.
2. Expert ids: each MoE layer's router probabilities and top-k ids, the
   reference's and the port's, at each step from the same state and at
   step 2 of the straight runs (the port from its own step-1 state).
3. AdamW's sensitive elements: after step 1, the elements the bars exempt
   (clipped gradient in (0, ``SENSITIVE``)) and how far apart the two
   runs put them; at step 2 of the straight runs, each leaf that misses
   the bar: its worst element's two gradients, the reference's and the
   port's (from m, ``m = b1 m' + (1 - b1) g``), and m after step 2.
"""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
import repro_torch.models.moe as tmoe  # noqa: E402
from fsdp_ref import HP, SENSITIVE, misses, reference  # noqa: E402
from repro import steps as jsteps  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.models.lm import forward as jforward  # noqa: E402
from repro_torch import steps as tsteps  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.models.lm import forward as tforward  # noqa: E402
from repro_torch.optim import OptHParams  # noqa: E402
from repro_torch.params import train_state_from_numpy  # noqa: E402

ARCH, OVER = "jamba-v0.1-52b", dict(opt_dtype="float32")


def state_leaves(st):
    """A port train state in ``fsdp_ref.misses``' order: m, v, params,
    step."""
    return ([x.detach().clone() for k in ("m", "v")
             for x in tree_leaves(st["opt"][k])]
            + [x.detach().clone() for x in tree_leaves(st["params"])]
            + [st["step"].clone()])


def ref_grads(jcfg, params, batch):
    """The reference's gradients (numpy leaves) and loss of one batch:
    its train step's loss, microbatches summed and divided by accum."""
    def loss_fn(p, micro):
        out = jforward(jsteps.cast_tree(p, jcfg.dtype), jcfg, micro["tokens"],
                       mode="train")
        loss = jsteps._token_loss(out, micro["labels"], jcfg)
        return loss + 0.01 * out["aux"] / max(jcfg.n_layers, 1), loss

    grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    n = batch["tokens"].shape[0]
    total, lsum = None, 0.0
    for a in range(n):
        (_, loss), g = grad(jax.tree.map(jnp.asarray, params),
                            {k: v[a] for k, v in batch.items()})
        total = g if total is None else jax.tree.map(jnp.add, total, g)
        lsum += float(loss)
    return [np.asarray(x) / n for x in jax.tree.leaves(total)], lsum / n


PROBS = {"ref": [], "port": []}


def _recording_routes():
    """Wrap both packages' ``route`` so each call's router probabilities
    are kept (the reference's through a debug callback, in call order)."""
    jroute, troute = jmoe.route, tmoe.route

    def jrec(xn, router, cfg):
        out = jroute(xn, router, cfg)
        probs = jax.nn.softmax(jnp.einsum(
            "bsd,de->bse", xn.astype(jnp.float32),
            router.astype(jnp.float32)), axis=-1)
        jax.debug.callback(lambda p: PROBS["ref"].append(np.asarray(p)),
                           probs, ordered=True)
        return out

    def trec(xn, router, cfg, *a, **k):
        PROBS["port"].append(tmoe.router_probs(xn, router).detach().numpy())
        return troute(xn, router, cfg, *a, **k)

    jmoe.route, tmoe.route = jrec, trec


def route_probs(jcfg, cfg, jparams, tparams, tokens):
    """Each MoE layer's router probabilities of one microbatch's forward:
    (the reference's, the port's)."""
    PROBS["ref"].clear()
    PROBS["port"].clear()
    jax.jit(lambda p, t: jforward(jsteps.cast_tree(p, jcfg.dtype), jcfg, t,
                                  mode="train")["logits"])(
        jax.tree.map(jnp.asarray, jparams), tokens).block_until_ready()
    jax.effects_barrier()
    with torch.no_grad():
        tforward(tparams, cfg, torch.as_tensor(tokens), mode="train")
    return list(PROBS["ref"]), list(PROBS["port"])


def compare_ids(tag, ref_probs, port_probs, k):
    """Print each MoE layer's largest probability gap, its narrowest
    top-k margin (the reference's k-th minus (k+1)-th probability) and
    the tokens whose top-k ids differ; returns the count of those."""
    flips = 0
    for layer, (a, b) in enumerate(zip(ref_probs, port_probs)):
        ia = np.sort(np.argsort(-a, -1, kind="stable")[..., :k], -1)
        ib = np.sort(np.argsort(-b, -1, kind="stable")[..., :k], -1)
        srt = np.sort(a, -1)[..., ::-1]
        margin = srt[..., k - 1] - srt[..., k]
        other = np.argwhere((ia != ib).any(-1))
        flips += len(other)
        print(f"  {tag}, MoE layer {layer}: probabilities apart by "
              f"{np.abs(a - b).max():.2e} at most, narrowest margin "
              f"{margin.min():.2e}, tokens with other ids {len(other)}")
        for t in map(tuple, other):
            print(f"    token {t}: ids {ia[t]} / {ib[t]}, margin "
                  f"{margin[t]:.3e}")
    return flips


def main():
    ref = reference(ARCH, steps=2, **OVER)
    cfg, jcfg = get(ARCH).tiny(**OVER), jget(ARCH).tiny(**OVER)
    step = tsteps.make_train_step(cfg, OptHParams(**HP))
    n = len(jax.tree.leaves(ref.states[0]["params"]))
    print(f"{ARCH} tiny: {cfg.n_layers} layers, {cfg.n_experts} experts, "
          f"top {cfg.top_k}, dispatch {cfg.moe_impl!r}, {n} param leaves")

    # 0. the straight run
    st = train_state_from_numpy(ref.state0, cfg, "cpu")
    metrics, states = [], []
    for b in ref.batches:
        st, m = step(st, b)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(state_leaves(st))
    print("0. straight run: after step 1 "
          f"{len(misses(ref, metrics[:1], states[0]))} bars missed; after "
          "step 2:")
    for line in misses(ref, metrics, states[1]):
        print("  " + line)

    # 1. the same state in, the gradients out
    grad_step = tsteps.make_grad_step(cfg)
    for k, (state, b) in enumerate([(ref.state0, ref.batches[0]),
                                    (ref.states[0], ref.batches[1])]):
        jg, jl = ref_grads(jcfg, state["params"], b)
        tg, tl = grad_step(train_state_from_numpy(state, cfg, "cpu")[
            "params"], b)
        rel = np.array([np.linalg.norm(t.detach().numpy() - j)
                        / (np.linalg.norm(j) or 1.0)
                        for t, j in zip(tree_leaves(tg), jg)])
        print(f"1. step {k + 1} from the reference's state: loss "
              f"{float(tl)!r} vs {jl!r}; gradient leaves' relative L2 error "
              f"median {np.median(rel):.2e}, worst {rel.max():.2e} (leaf "
              f"{rel.argmax()})")
    st = train_state_from_numpy(ref.states[0], cfg, "cpu")
    st, m = step(st, ref.batches[1])
    missed = misses(ref, [{k: float(v) for k, v in m.items()}],
                    state_leaves(st), first=1)
    print("   the port's step 2 from the reference's step-1 state: "
          f"{len(missed)} bars missed")

    # 2. expert ids
    _recording_routes()
    flips = 0
    for k, b in enumerate(ref.batches):
        before = ref.state0 if k == 0 else ref.states[k - 1]
        tparams = train_state_from_numpy(before, cfg, "cpu")["params"]
        for a in range(b["tokens"].shape[0]):
            flips += compare_ids(f"step {k + 1} micro {a}, same state",
                                 *route_probs(jcfg, cfg, before["params"],
                                              tparams, b["tokens"][a]),
                                 cfg.top_k)
    own = train_state_from_numpy(ref.state0, cfg, "cpu")
    own, _ = step(own, ref.batches[0])
    for a in range(ref.batches[1]["tokens"].shape[0]):
        flips += compare_ids(f"step 2 micro {a}, straight runs",
                             *route_probs(jcfg, cfg, ref.states[0]["params"],
                                          own["params"],
                                          ref.batches[1]["tokens"][a]),
                             cfg.top_k)
    print(f"2. tokens routed to other experts, all cases: {flips}")

    # 3. AdamW's sensitive elements
    j1 = [np.asarray(x, np.float32) for x in jax.tree.leaves(ref.states[0])]
    j2 = [np.asarray(x, np.float32) for x in jax.tree.leaves(ref.states[1])]
    t1 = [x.float().numpy() for x in states[0]]
    t2 = [x.float().numpy() for x in states[1]]
    apart, leaves, widest = 0, 0, 0.0
    for i in range(n):
        small = ref.small[0][i]
        gap = np.abs(t1[2 * n + i] - j1[2 * n + i])[small]
        if (gap > 1e-6).any():
            apart += int((gap > 1e-6).sum())
            leaves += 1
            widest = max(widest, float(gap.max()))
    print(f"3. after step 1: {sum(int(s.sum()) for s in ref.small[0])} "
          f"exempt elements (gradient in (0, {SENSITIVE})), {apart} of them "
          f"apart by more than 1e-6 in {leaves} leaves, widest {widest:.3e}")
    b1 = 0.9
    for i in range(n):
        small = ref.small[1][i]
        got, want = t2[2 * n + i], j2[2 * n + i]
        if np.allclose(got[~small], want[~small], rtol=1e-5, atol=1e-6):
            continue
        e = np.unravel_index(np.argmax(np.abs(got - want) * ~small),
                             got.shape)
        g1, tg1 = j1[i][e] / (1 - b1), t1[i][e] / (1 - b1)
        g2 = (j2[i][e] - b1 * j1[i][e]) / (1 - b1)
        tg2 = (t2[i][e] - b1 * t1[i][e]) / (1 - b1)
        print(f"   step 2, param leaf {i}, element {tuple(map(int, e))}: "
              f"apart by {abs(got[e] - want[e]):.3e}; gradient at step 1 "
              f"{g1:.4e} / {tg1:.4e}, at step 2 {g2:.4e} / {tg2:.4e} (apart "
              f"by {abs(tg2 - g2) / abs(g2):.1e} of it); m {j2[i][e]:.3e}")
    for i in range(n):
        got, want = t2[n + i], j2[n + i]
        rel = np.linalg.norm(got - want) / (np.linalg.norm(want) or 1.0)
        if rel <= 1e-4:
            continue
        e = np.unravel_index(np.argmax(np.abs(got - want)), got.shape)
        g2 = (j2[i][e] - b1 * j1[i][e]) / (1 - b1)
        tg2 = (t2[i][e] - b1 * t1[i][e]) / (1 - b1)
        print(f"   step 2, v leaf {i} {got.shape}: relative L2 error "
              f"{rel:.3e}; its widest element {tuple(map(int, e))}: v "
              f"{want[e]:.3e} / {got[e]:.3e}, gradient at step 2 {g2:.4e} / "
              f"{tg2:.4e}")


if __name__ == "__main__":
    main()
