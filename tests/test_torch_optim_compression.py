"""Gradient compression and AdamW on the LM's parameter tree, against
``repro.optim`` (CPU).

* ``optim/compression.py``: int8 and top-k compression with error
  feedback give the reference's outputs bit for bit — q, scale, residual,
  top-k indices (ties to the lower index, as ``lax.top_k``), values,
  the decompressed tensors and the pytree transforms — on float32 and
  bfloat16 gradients, ties and exact halves included;
* ``optim/adamw.py`` on the smoke LM's nested parameter dict (float32 and
  bfloat16 params): float32 moments, clipping, the cosine / linear /
  constant schedules and the ``grad_norm`` / ``lr`` metrics over three
  steps, within 1e-5 (float32 rounding of the same chain).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.optim import compression as RC  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _same(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    if ref.dtype.name == "bfloat16":
        ref = ref.view(np.int16)
    np.testing.assert_array_equal(_np(port), ref)


def _grads(seed, shape=(6, 33), dtype=np.float32):
    """Gradients with ties in |g| and exact halves after scaling."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    g.reshape(-1)[::7] = 0.5  # ties, and q = round(x.5) cases
    g.reshape(-1)[3::11] = -0.5
    return jnp.asarray(g, dtype)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_int8_matches_reference_bit_for_bit(dtype):
    g = _grads(0, dtype=dtype)
    res = jnp.asarray(np.random.default_rng(1).standard_normal(g.shape)
                      * 1e-3, jnp.float32)
    c, r = RC.int8_compress(g, res)
    tc, tr = TC.int8_compress(_t(g), _t(res))
    _same(tc["q"], c["q"])
    _same(tc["scale"], c["scale"])
    _same(tr, r)
    assert tc["q"].dtype == torch.int8
    _same(TC.int8_decompress(tc, _t(g).dtype),
          RC.int8_decompress(c, g.dtype))


def test_round_is_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5])
    np.testing.assert_array_equal(torch.round(x).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_topk_matches_reference_bit_for_bit(frac, dtype):
    g = _grads(2, dtype=dtype)
    res = jnp.zeros(g.shape, jnp.float32)
    c, r = RC.topk_compress(g, res, frac)
    tc, tr = TC.topk_compress(_t(g), _t(res), frac)
    _same(tc["idx"], c["idx"])  # ties in |g|: the lower index first
    _same(tc["vals"], c["vals"])
    _same(tr, r)
    assert tuple(tc["shape"]) == tuple(c["shape"])
    _same(TC.topk_decompress(tc, _t(g).dtype),
          RC.topk_decompress(c, g.dtype))


def test_topk_ties_go_to_the_lower_index():
    g = torch.tensor([1.0, -2.0, 2.0, 2.0, -1.0, 0.0])
    c, r = TC.topk_compress(g, torch.zeros(6), frac=0.5)
    assert c["idx"].tolist() == [1, 2, 3]
    assert r.tolist() == [1.0, 0.0, 0.0, 0.0, -1.0, 0.0]


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_error_feedback_pytree_matches_reference(scheme):
    tree = {"b": _grads(3, (5,)), "a": {"w": _grads(4, (3, 8)),
                                        "v": _grads(5, (4,), jnp.bfloat16)}}
    ttree = jax.tree_util.tree_map(_t, tree)
    res, tres = RC.init_residual(tree), TC.init_residual(ttree)
    for r, tr in zip(jax.tree_util.tree_leaves(res), TA._leaves(tres)):
        _same(tr, r)
        assert tr.dtype == torch.float32
    for _ in range(3):  # the residual carries from step to step
        comp, res = RC.ef_compress_pytree(tree, res, scheme, frac=0.25)
        tcomp, tres = TC.ef_compress_pytree(ttree, tres, scheme, frac=0.25)
        for r, tr in zip(jax.tree_util.tree_leaves(res), TA._leaves(tres)):
            _same(tr, r)
        out = RC.ef_decompress_pytree(comp, tree, scheme)
        tout = TC.ef_decompress_pytree(tcomp, ttree, scheme)
        assert set(tout) == {"a", "b"} and set(tout["a"]) == {"w", "v"}
        for o, to in zip(jax.tree_util.tree_leaves(out), TA._leaves(tout)):
            _same(to, o)


# ---------------------------------------------------------------------------
# AdamW on the LM's parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_on_the_lm_tree_matches_reference(schedule, dtype):
    import dataclasses

    rcfg = dataclasses.replace(ref_smoke("olmoe-1b-7b"), dtype=dtype)
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    tcfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), dtype=dtype)
    tparams = TT.transformer_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=5, schedule=schedule,
               grad_clip=0.5)
    state, tstate = RA.adamw_init(params), TA.adamw_init(tparams)
    assert all(t.dtype == torch.float32 for t in TA._leaves(tstate["m"]))
    rng = np.random.default_rng(7)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype),
            params)
        params, state, m = RA.adamw_update(RA.AdamWConfig(**opt), params,
                                           grads, state)
        tparams, tstate, tm = TA.adamw_update(
            TA.AdamWConfig(**opt), tparams,
            jax.tree_util.tree_map(_t, grads), tstate)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(m[k]), rtol=1e-5,
                                       err_msg=f"step {step} {k}")
        for name, ours, ref in (("m", tstate["m"], state["m"]),
                                ("v", tstate["v"], state["v"])):
            for a, b in zip(TA._leaves(ours), jax.tree_util.tree_leaves(ref)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-7,
                                           err_msg=f"step {step} {name}")
        for a, b in zip(TA._leaves(tparams),
                        jax.tree_util.tree_leaves(params)):
            assert a.dtype == _t(b).dtype
            tol = 1e-5 if dtype == "float32" else 8e-3  # one bf16 ulp
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=tol, atol=tol)
        assert int(tstate["step"]) == int(state["step"]) == step + 1
