"""The port's SSM family against ``repro.models.ssm`` (CPU, plain versions).

Module level, on the same numpy-seeded inputs and the reference's
parameters: ``_causal_conv``, ``_assoc_scan`` (the port's Hillis–Steele
scan against ``jax.lax.associative_scan``: the same affine maps combined
in different trees), ``mamba_block`` (Mamba1, Mamba1 with the fused
projection, Mamba2) and ``mamba_block_decode`` agree in float32 within
rtol 1e-4 / atol 1e-5.

Whole model, falcon-mamba smoke (``ssm_chunk`` 8, S = 16: two chunks, h
carried between them), weights carried by ``transformer_from_numpy``:
logits within 2e-4; ``lm_loss`` and its grads within rtol 2e-3 / atol
2e-4 of ``jax.value_and_grad``; decode equal to the forward within 2e-3
(the reference's own pin, ``tests/test_models.py``); the batcher's tokens
equal to the reference batcher's over several waves (each wave starts
from a zero recurrent state); a fused-projection train step lowers the
loss (``tests/test_perf_variants.py``). The sharding specs of the ssm
leaves and cache equal the reference's, and on the emulated (data 2,
model 4) grid the family runs as the dense one does.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.distributed import sharding as RSH  # noqa: E402
from repro.distributed.context import make_context as r_context  # noqa: E402
from repro.launch.mesh import make_mesh as r_mesh  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import scheduler as RSC  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as TSH  # noqa: E402
from repro_torch.distributed.context import make_context  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, _leaves, adamw_init  # noqa: E402,E501
from repro_torch.serving import scheduler as TSC  # noqa: E402
from repro_torch.train.steps import loss_and_grads, make_train_step  # noqa: E402,E501

ARCH = "falcon-mamba-7b"
MOD = dict(rtol=1e-4, atol=1e-5)
LOGITS = dict(rtol=2e-4, atol=2e-4)
GRAD = dict(rtol=2e-3, atol=2e-4)
DECODE = dict(rtol=2e-3, atol=2e-3)
VARIANTS = {"v1": {}, "v1_fused": dict(ssm_fused_proj=True),
            "v2": dict(ssm_version=2, ssm_heads=2)}


def _cfgs(**changes):
    return (dataclasses.replace(jax_smoke(ARCH), **changes),
            dataclasses.replace(get_smoke_config(ARCH), **changes))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  _np(tree))


def _gen(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_causal_conv_matches_reference():
    x, w, b, pre = (_gen(0, (2, 9, 12)), _gen(1, (4, 12)), _gen(2, (12,)),
                    _gen(3, (2, 3, 12)))
    want = RS._causal_conv(*map(jnp.asarray, (x, w, b, pre)))
    got = TS._causal_conv(*map(torch.from_numpy, (x, w, b, pre)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD)


@pytest.mark.parametrize("q,trail", [(1, (3, 4)), (8, (3, 4)), (13, (5, 2)),
                                     (16, (2, 1, 1))])
def test_assoc_scan_matches_reference(q, trail):
    da = np.exp(-np.abs(_gen(4, (2, q) + trail)))
    dbx, h0 = _gen(5, (2, q) + trail), _gen(6, (2,) + trail)
    if len(trail) == 3:  # mamba2: da broadcasts over [hd, st]
        dbx = _gen(5, (2, q, 2, 3, 4))
        h0 = _gen(6, (2, 2, 3, 4))
    w_all, w_last = RS._assoc_scan(*map(jnp.asarray, (da, dbx, h0)))
    g_all, g_last = TS._assoc_scan(*map(torch.from_numpy, (da, dbx, h0)))
    np.testing.assert_allclose(g_all.numpy(), np.asarray(w_all), **MOD)
    np.testing.assert_allclose(g_last.numpy(), np.asarray(w_last), **MOD)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_mamba_params_has_reference_shapes_and_dtypes(variant):
    cfg, tcfg = _cfgs(**VARIANTS[variant])
    want = RS.init_mamba_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    got = TS.init_mamba_params(torch.Generator().manual_seed(0), tcfg,
                               torch.float32, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[1] == str(want[k].dtype), k
    np.testing.assert_allclose(got["A_log"].numpy(), np.asarray(want["A_log"]))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("s", [16, 12])  # two chunks; one odd chunk
def test_mamba_block_matches_reference(variant, s):
    cfg, tcfg = _cfgs(**VARIANTS[variant])
    p = RS.init_mamba_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    x = _gen(7, (2, s, cfg.d_model))
    want = RS.mamba_block(p, jnp.asarray(x), cfg)
    got = TS.mamba_block(_t(p), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mamba_block_decode_matches_reference(variant):
    cfg, tcfg = _cfgs(**VARIANTS[variant])
    p = RS.init_mamba_params(jax.random.PRNGKey(2), cfg, jnp.float32)
    st = RS.init_ssm_state(cfg, 3, jnp.float32)
    h, conv = _gen(8, st.h.shape, 0.5), _gen(9, st.conv.shape)
    x = _gen(10, (3, 1, cfg.d_model))
    w_out, w_st = RS.mamba_block_decode(
        p, jnp.asarray(x), RS.SSMState(jnp.asarray(h), jnp.asarray(conv)), cfg)
    g_out, g_st = TS.mamba_block_decode(
        _t(p), torch.from_numpy(x),
        TS.SSMState(torch.from_numpy(h), torch.from_numpy(conv)), tcfg)
    np.testing.assert_allclose(g_out.numpy(), np.asarray(w_out), **MOD)
    np.testing.assert_allclose(g_st.h.numpy(), np.asarray(w_st.h), **MOD)
    np.testing.assert_allclose(g_st.conv.numpy(), np.asarray(w_st.conv),
                               **MOD)


@pytest.fixture(scope="module")
def model():
    cfg, tcfg = _cfgs()
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    tp = TT.transformer_from_numpy(_np(params), tcfg, device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return cfg, tcfg, params, tp, toks


def test_forward_matches_reference(model):
    cfg, tcfg, params, tp, toks = model
    want = RT.forward(params, cfg, None, {"tokens": jnp.asarray(toks)})
    got = TT.forward(tp, tcfg, None, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_lm_loss_and_grads_match_jax_value_and_grad(model):
    cfg, tcfg, params, tp, toks = model
    want, wgrads = jax.value_and_grad(lambda p: RT.lm_loss(
        p, cfg, None, {"tokens": jnp.asarray(toks)}))(params)
    loss, grads = loss_and_grads(tp, tcfg, None,
                                 {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(want), **GRAD)
    got, ref = _leaves(grads), jax.tree_util.tree_leaves(wgrads)
    assert len(got) == len(ref)
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)
        assert float(g.abs().sum()) > 0 or float(jnp.abs(w).sum()) == 0


def test_decode_equals_forward(model):
    cfg, tcfg, params, tp, toks = model
    full = TT.forward(tp, tcfg, None, {"tokens": torch.from_numpy(toks)})
    cache = TT.init_decode_cache(tcfg, 2, 16, device="cpu")
    assert cache.k is None and cache.ssm_h.dtype == torch.float32
    h_store = cache.ssm_h
    outs = []
    with torch.no_grad():
        for i in range(toks.shape[1]):
            lg, cache = TT.decode_step(tp, tcfg, None,
                                       torch.from_numpy(toks[:, i:i + 1]),
                                       cache)
            outs.append(lg)
    assert cache.ssm_h is h_store and cache.length == toks.shape[1]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **DECODE)


def test_batcher_tokens_equal_reference(model):
    cfg, tcfg, params, tp, _ = model
    lengths, new = [3, 6, 4, 5, 2, 7, 5], 4

    def requests(mod):
        rng = np.random.default_rng(1)
        return [mod.Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(lengths)]

    outs = []
    for mod, b in ((RSC, RSC.ContinuousBatcher(cfg, params, 3, 16)),
                   (TSC, TSC.ContinuousBatcher(tcfg, tp, 3, 16))):
        reqs = requests(mod)
        for r in reqs:
            b.submit(r)
        stats = b.run()
        outs.append(([r.output for r in reqs], stats.served,
                     stats.generated_tokens))
    assert outs[1] == outs[0]
    assert outs[1][1] == len(lengths)  # three waves of at most 3 slots


def test_batcher_wave_starts_from_zero_state(model):
    _, tcfg, _, tp, _ = model
    b = TSC.ContinuousBatcher(tcfg, tp, 2, 8)
    with torch.no_grad():
        b.cache.ssm_h.fill_(1.0)
        b.cache.ssm_conv.fill_(1.0)
    b.submit(TSC.Request(rid=0, prompt=np.array([1, 2], np.int32),
                         max_new_tokens=1))
    b.run()
    fresh = TSC.ContinuousBatcher(tcfg, tp, 2, 8)
    r = TSC.Request(rid=0, prompt=np.array([1, 2], np.int32),
                    max_new_tokens=1)
    fresh.submit(r)
    fresh.run()
    assert b.stats.served == 1
    # the admitted wave reset the state the filled cache held
    again = TSC.Request(rid=1, prompt=np.array([1, 2], np.int32),
                        max_new_tokens=1)
    b.submit(again)
    b.run()
    assert again.output == r.output


def test_fused_proj_train_step_lowers_the_loss():
    _, tcfg = _cfgs(ssm_fused_proj=True)
    params = TT.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert params["layers"]["ssm"]["x_dbl"].shape[1] == tcfg.d_model
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    step = make_train_step(tcfg, None, AdamWConfig(lr=1e-2, warmup_steps=1))
    opt = adamw_init(params)
    losses = []
    for _ in range(4):
        params, opt, m = step(params, opt, {"tokens": toks})
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]) and float(m["grad_norm"]) > 0
    assert losses[-1] < losses[0]


def _spec_tuple(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharding_specs_equal_reference(variant):
    cfg, tcfg = _cfgs(**VARIANTS[variant])
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    rdist = r_context(r_mesh((2, 4), ("data", "model")))
    tdist = make_context(make_mesh((2, 4), ("data", "model")))
    want = RSH.param_specs(params, cfg, rdist)
    got = TSH.param_specs(_np(params), tcfg, tdist)
    flat_w = jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    flat_g = _leaves(got, is_leaf=TSH._is_spec)
    assert [_spec_tuple(w) for w in flat_w] == [_spec_tuple(g)
                                                for g in flat_g]
    cw = RSH.cache_specs(cfg, rdist, 8)
    cg = TSH.cache_specs(tcfg, tdist, 8)
    assert sorted(cg) == sorted(cw)
    for k in cw:
        assert _spec_tuple(cg[k]) == _spec_tuple(cw[k]), k


def test_ssm_runs_on_the_emulated_grid(model):
    _, tcfg, _, tp, toks = model
    dist = make_context(make_mesh((2, 4), ("data", "model")))
    TSH.place_tree(tp, TSH.param_shardings(tp, tcfg, dist))
    t = torch.from_numpy(toks)
    want = TT.forward(tp, tcfg, None, {"tokens": t})
    got = TT.forward(tp, tcfg, dist, {"tokens": t})
    assert torch.equal(got, want)
    cache = TT.init_decode_cache(tcfg, 2, 16, device="cpu")
    with torch.no_grad():
        lg, _ = TT.decode_step(tp, tcfg, dist, t[:, :1], cache)
    assert lg.shape == (2, 1, tcfg.vocab_size)
