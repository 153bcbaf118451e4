"""The port's AdamW against ``repro.optim.adamw`` (CPU).

The same numpy parameters and gradients go through the reference's
``adamw_update`` and the port's, step after step, for the cosine, linear
and constant schedules, with and without clipping: parameters, moments,
learning rate and gradient norm agree within 1e-6 (float32 arithmetic in
both, summed in another order). The schedules and the clipping agree on
their own, ``adamw_step`` is ``adamw_update`` in place, and the state
stays float32 for bfloat16 parameters.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.optim import adamw as R  # noqa: E402
from repro_torch.optim import adamw as T  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(rng):
    """A nested tree of float32 arrays: a dict with a list inside."""
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "layers": [rng.standard_normal(5).astype(np.float32),
                       rng.standard_normal((2, 2)).astype(np.float32)]}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _assert_tree_close(got, want):
    got_leaves = T._leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("clip", [1.0, 0.0, 0.05],
                         ids=["clip1", "noclip", "clip0.05"])
def test_adamw_update_matches_reference(schedule, clip):
    rng = np.random.default_rng(0)
    kw = dict(lr=5e-3, warmup_steps=2, total_steps=6, schedule=schedule,
              grad_clip=clip, weight_decay=0.1)
    rcfg, tcfg = R.AdamWConfig(**kw), T.AdamWConfig(**kw)
    params = _tree(rng)
    rp, tp = _jax(params), _torch(params)
    rs, ts = R.adamw_init(rp), T.adamw_init(tp)
    for _ in range(5):
        grads = _tree(rng)
        rp, rs, rm = R.adamw_update(rcfg, rp, _jax(grads), rs)
        tp, ts, tm = T.adamw_update(tcfg, tp, _torch(grads), ts)
        _assert_tree_close(tp, rp)
        _assert_tree_close(ts["m"], rs["m"])
        _assert_tree_close(ts["v"], rs["v"])
        assert int(ts["step"]) == int(rs["step"])
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(rm[key]), **TOL)


def test_schedules_match_reference():
    for schedule in ("cosine", "constant"):
        kw = dict(lr=1.0, warmup_steps=10, total_steps=100,
                  schedule=schedule)
        for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
            s = np.int32(step)
            np.testing.assert_allclose(
                float(T.cosine_schedule(T.AdamWConfig(**kw),
                                        torch.tensor(s))),
                float(R.cosine_schedule(R.AdamWConfig(**kw), jnp.asarray(s))),
                **TOL)
            np.testing.assert_allclose(
                float(T.linear_warmup(T.AdamWConfig(**kw), torch.tensor(s))),
                float(R.linear_warmup(R.AdamWConfig(**kw), jnp.asarray(s))),
                **TOL)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    g = _tree(rng)
    for max_norm in (0.1, 1.0, 100.0):
        rc, rn = R.clip_by_global_norm(_jax(g), max_norm)
        tc, tn = T.clip_by_global_norm(_torch(g), max_norm)
        np.testing.assert_allclose(float(tn), float(rn), **TOL)
        _assert_tree_close(tc, rc)
    np.testing.assert_allclose(float(T.global_norm(_torch(g))),
                               float(R.global_norm(_jax(g))), **TOL)


def test_adamw_step_updates_in_place():
    rng = np.random.default_rng(2)
    cfg = T.AdamWConfig(lr=1e-2, warmup_steps=0, schedule="constant")
    ps = [a.requires_grad_() for a in T._leaves(_torch(_tree(rng)))]
    grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(
        np.float32)) for p in ps]
    want, want_state, _ = T.adamw_update(
        cfg, [p.detach().clone() for p in ps], grads, T.adamw_init(ps))
    for p, g in zip(ps, grads):
        p.grad = g.clone()
    state, metrics = T.adamw_step(cfg, ps, T.adamw_init(ps))
    for p, w in zip(ps, want):
        assert torch.equal(p.detach(), w) and p.grad is None
    assert int(state["step"]) == 1 and float(metrics["lr"]) == pytest.approx(
        1e-2)
    with pytest.raises(ValueError, match="no grad"):
        T.adamw_step(cfg, ps, state)


def test_bf16_params_keep_their_dtype_and_fp32_state():
    p = {"x": torch.ones(3, dtype=torch.bfloat16)}
    state = T.adamw_init(p)
    assert state["m"]["x"].dtype == torch.float32
    new, state, _ = T.adamw_update(T.AdamWConfig(), p,
                                   {"x": torch.ones(3, dtype=torch.bfloat16)},
                                   state)
    assert new["x"].dtype == torch.bfloat16
    assert state["v"]["x"].dtype == torch.float32


def test_adamw_converges_quadratic():
    """``tests/test_optim.py``'s quadratic, on the port."""
    cfg = T.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                        total_steps=200, schedule="constant")
    x = torch.tensor([5.0, -3.0], requires_grad=True)
    state = T.adamw_init([x])
    for _ in range(200):
        (x ** 2).sum().backward()
        state, _ = T.adamw_step(cfg, [x], state)
    assert float((x.detach() ** 2).sum()) < 1e-3
