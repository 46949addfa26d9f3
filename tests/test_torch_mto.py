"""The port's eleven MTO methods against the JAX package's
``mto.methods.combine_grads``: seeded numpy per-task gradients over leaves
labelled shared, task and unassigned, the same losses and the same state on
both sides (PCGrad's orders and RLW's normals drawn from the JAX key and
passed in). DWA runs 30 steps (its weights move after 25), NashMTL and UW
3, carrying the state; UW's log-sigma takes the same plain step on both
sides from ``uw_logsigma_grad``. Tolerance: 1e-5 relative per leaf, 1e-4
for MGDA (Frank-Wolfe's 250 steps, in float32 in JAX and in float64 in
the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.mto import methods as jm
from mtd_gan_tpu_torch.mto import methods as pm

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

K = 3
LEAVES = {"s1": ((6, 5), "shared"), "s2": ((9,), "shared"), "t1": ((7,), "task"),
          "t2": ((2, 3), "task"), "u1": ((4,), "unassigned")}
NAMES = sorted(LEAVES)
STEPS = {"dwa": 30, "nashmtl": 3, "uw": 3}


def _grads(rng):
    """Per-task gradients: task 1 partly opposes task 0 on the shared leaves,
    so PCGrad and CAGrad have conflicts to resolve."""
    g = {n: rng.standard_normal((K, *LEAVES[n][0])).astype(np.float32) for n in NAMES}
    for n in ("s1", "s2"):
        g[n][1] = (-0.6 * g[n][0] + 0.8 * g[n][1]).astype(np.float32)
    return g


def _port_state(js):
    to_t = lambda v: None if v is None else torch.tensor(np.asarray(v))
    return pm.MTOState(step=int(js.step), logsigma=to_t(js.logsigma), costs=to_t(js.costs),
                       dwa_weights=to_t(js.dwa_weights), prvs_alpha=to_t(js.prvs_alpha))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("name", jm.METHODS)
def test_combine_grads_matches_jax(name):
    tol = 1e-4 if name == "mgda" else 1e-5
    method = jm.get_method(name, n_tasks=K)
    labels = {n: LEAVES[n][1] for n in NAMES}
    jax_combine = jax.jit(lambda st, r, lv, g: jm.combine_grads(method, st, r, lv, g, labels))
    js = method.init_state()
    ps = pm.MTOState() if name not in ("uw", "dwa", "nashmtl") else _port_state(js)
    port_method = pm.get_method(name, n_tasks=K)
    rng = np.random.default_rng(sum(map(ord, name)))
    for step in range(STEPS.get(name, 1)):
        g = _grads(rng)
        losses = rng.uniform(0.2, 2.0, K).astype(np.float32)
        key = jax.random.PRNGKey(step)
        want, js_new, want_w = jax_combine(js, key, jnp.asarray(losses),
                                           {n: jnp.asarray(v) for n, v in g.items()})
        order = torch.tensor(np.stack([np.asarray(jax.random.permutation(r, K))
                                       for r in jax.random.split(key, K)]))
        draw = torch.tensor(np.asarray(jax.random.normal(key, (K,), jnp.float32)))
        task_grads = [[torch.tensor(g[n][t]) for n in NAMES] for t in range(K)]
        got, ps_new, got_w = pm.combine_grads(
            port_method, task_grads, [labels[n] for n in NAMES], order,
            torch.tensor(losses), ps, draw)
        for n, got_n in zip(NAMES, got):
            w = np.asarray(want[n])
            if got_n is None:  # no step on the port, a zero gradient in JAX
                assert not np.any(w), (name, step, n)
            else:
                assert _rel(got_n, w) < tol, (name, step, n, _rel(got_n, w))
        assert _rel(got_w, want_w) < tol, (name, step, got_w, want_w)
        assert ps_new.step == int(js_new.step) == step + 1
        for field in ("logsigma", "costs", "dwa_weights", "prvs_alpha"):
            jv, pv = getattr(js_new, field), getattr(ps_new, field)
            assert (jv is None) == (pv is None), field
            if jv is not None:
                assert _rel(pv, jv) < tol, (name, step, field)
        if name == "uw":
            grad = pm.uw_logsigma_grad(ps, torch.tensor(losses))
            want_grad = jm.uw_logsigma_grad(js, jnp.asarray(losses))
            assert _rel(grad, want_grad) < 1e-6
            ps_new.logsigma = ps.logsigma - 0.1 * grad
            js_new = js_new.replace(logsigma=js.logsigma - 0.1 * want_grad)
        js, ps = js_new, ps_new
    if name == "dwa":  # past the window the weights have moved off 1
        assert np.abs(ps.dwa_weights.numpy() - 1).max() > 1e-3


def test_check_method_accepts_every_name():
    for name in jm.METHODS:
        assert pm.check_method(name) == name
    assert pm.check_method("") is None and pm.check_method(None) is None
    with pytest.raises(KeyError):
        pm.check_method("nope")


def test_simplex_projection_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        v = (3 * rng.standard_normal(4)).astype(np.float32)
        np.testing.assert_allclose(pm.simplex_project(torch.tensor(v)).numpy(),
                                   np.asarray(jm._simplex_project(jnp.asarray(v))),
                                   atol=1e-6)
