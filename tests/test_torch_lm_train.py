"""LM training on the port against ``repro`` (CPU, plain versions).

The reference's ``init_params`` tree goes to the port through
``transformer_from_numpy``; batches are numpy-seeded. On the float32
smoke config of every dense and moe arch:

* ``lm_loss`` and every gradient leaf equal the reference's
  ``jax.value_and_grad``: loss within 1e-5 relative, grads rtol 1e-4 /
  atol 1e-5;
* params, moments and metrics after one ``make_train_step`` (and with
  ``microbatches=2``) equal the reference step's at the same tolerances
  (the first moment is 0.1·g; a parameter whose first moment lies within
  10× the grads' atol of zero may step by up to 2·lr apart, since
  m / (sqrt(v) + eps) there is not fixed by grads within that atol);
* on the emulated (data 2, model 4) grid the dense step equals the
  port's unsharded step bit for bit, and olmoe-smoke's expert-parallel
  step at ``capacity_factor=8.0`` has grads within 2e-4 of the port's
  dense-MoE step and of the reference's step sharded on its (2, 4) mesh
  (``tests/test_system.py:54-75``), with no backward map built on the
  host;
* ``cfg.remat`` (``torch.utils.checkpoint``) gives the same bits;
* K6's plain backward equals ``jax.grad`` of the reference's RMSNorms at
  the kernel tolerances of ``tests/test_kernels.py:44`` (float32 1e-5,
  bfloat16 6e-2).
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.distributed import sharding as RS  # noqa: E402
from repro.distributed.context import make_context as ref_context  # noqa: E402
from repro.launch.mesh import make_mesh as ref_mesh  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim.adamw import AdamWConfig as RAdamW  # noqa: E402
from repro.optim.adamw import adamw_init as ref_adamw_init  # noqa: E402
from repro.train.steps import make_train_step as ref_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.context import make_context  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as K6  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, _leaves, adamw_init  # noqa: E402,E501
from repro_torch.train.steps import loss_and_grads, make_train_step  # noqa: E402,E501

ROOT = pathlib.Path(__file__).resolve().parents[1]
LM_ARCHS = ["smollm-135m", "qwen2-1.5b", "granite-20b", "deepseek-67b",
            "olmoe-1b-7b", "dbrx-132b"]  # the dense and moe families
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _tokens(cfg, shape=(4, 16), seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _both(arch, cfg_ref=None, cfg_port=None):
    """(reference cfg, reference params, port cfg, port params)."""
    rcfg = cfg_ref or ref_smoke(arch)
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    tcfg = cfg_port or get_smoke_config(arch)
    return rcfg, params, tcfg, TT.transformer_from_numpy(
        _np_tree(params), tcfg, device="cpu")


def _close_leaves(port_tree, ref_tree, what, **tol):
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)  # sorted dict keys
    got = _leaves(port_tree)
    assert len(got) == len(ref_leaves), what
    for i, (g, r) in enumerate(zip(got, ref_leaves)):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(r, np.float32),
                                   err_msg=f"{what} leaf {i}", **tol)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_grads_match_reference(arch):
    rcfg, params, tcfg, tparams = _both(arch)
    toks = _tokens(rcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: RT.lm_loss(p, rcfg, None, b)))(
        params, {"tokens": jnp.asarray(toks)})
    tloss, tgrads = loss_and_grads(tparams, tcfg, None,
                                   {"tokens": torch.from_numpy(toks)})
    assert abs(float(tloss) - float(loss)) <= 1e-5 * abs(float(loss))
    _close_leaves(tgrads, grads, f"{arch} grads", **GRAD)
    # every leaf got a gradient, and the norm gains one that is not zero
    assert all(bool(g.abs().sum() > 0) for g in _leaves(tgrads))


@pytest.mark.parametrize("arch,microbatches", [
    (a, 1) for a in LM_ARCHS] + [("smollm-135m", 2), ("olmoe-1b-7b", 2)])
def test_train_step_matches_reference(arch, microbatches):
    rcfg, params, tcfg, tparams = _both(arch)
    toks = _tokens(rcfg)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    step = jax.jit(ref_train_step(rcfg, None, RAdamW(**opt),
                                  microbatches=microbatches))
    new_p, new_s, m = step(params, ref_adamw_init(params),
                           {"tokens": jnp.asarray(toks)})
    tstep = make_train_step(tcfg, None, AdamWConfig(**opt),
                            microbatches=microbatches)
    tp, ts, tm = tstep(tparams, adamw_init(tparams), {"tokens": toks})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(m[k]), rtol=1e-5,
                                   err_msg=k)
    # params: the grads' tolerance wherever the reference's first moment
    # is well clear of it; where |m| is within 10x the grads' atol of 0,
    # the step's direction m / (sqrt(v) + eps) is not fixed by grads that
    # agree within that atol, and the update differs by at most 2·lr
    lr = float(m["lr"])
    for i, (got, want, mom) in enumerate(zip(
            _leaves(tp), jax.tree_util.tree_leaves(new_p),
            jax.tree_util.tree_leaves(new_s["m"]))):
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        firm = np.abs(np.asarray(mom)) > 10 * GRAD["atol"] * (1 - 0.9)
        np.testing.assert_allclose(got[firm], want[firm],
                                   err_msg=f"{arch} params leaf {i}", **GRAD)
        assert np.all(np.abs(got - want)[~firm] <= 2 * lr + 1e-6)
    _close_leaves(ts["m"], new_s["m"], f"{arch} m", rtol=1e-4, atol=1e-6)
    _close_leaves(ts["v"], new_s["v"], f"{arch} v", rtol=2e-4, atol=1e-9)
    assert int(ts["step"]) == int(new_s["step"]) == 1
    assert all(t.dtype == torch.float32 for t in _leaves(ts["m"]))
    # the step is functional: its input params are untouched
    _close_leaves(tparams, params, f"{arch} params before", rtol=0, atol=0)


def test_microbatches_match_one_batch_on_the_port():
    """``microbatches=2`` against one batch (the reference's
    test_microbatched_step_matches_plain): the loss within 1e-5."""
    cfg = get_smoke_config("smollm-135m")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = _tokens(cfg)
    opt = AdamWConfig(lr=1e-3)
    _, _, m1 = make_train_step(cfg, None, opt)(params, adamw_init(params),
                                               {"tokens": toks})
    _, _, m2 = make_train_step(cfg, None, opt, microbatches=2)(
        params, adamw_init(params), {"tokens": toks})
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5


def test_microbatches_must_divide_the_batch_on_the_port():
    """The port's chosen semantics (ROADMAP's Reference contract): a batch
    that does not divide by ``microbatches`` raises."""
    cfg = get_smoke_config("smollm-135m")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, None, AdamWConfig(lr=1e-3), microbatches=2)
    with pytest.raises(ValueError, match="not divisible by 2 microbatches"):
        step(params, adamw_init(params), {"tokens": _tokens(cfg, (5, 16))})


def test_reference_microbatches_drop_the_batch_tail():
    """Where the port raises, the reference's ``mb_slice`` takes
    n // microbatches rows a slice and drops the rest: its step on 5 rows
    at ``microbatches=2`` is its step on the first 4."""
    rcfg = ref_smoke("smollm-135m")
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    toks = _tokens(rcfg, (5, 16))
    step = jax.jit(ref_train_step(rcfg, None, RAdamW(lr=1e-3),
                                  microbatches=2))
    _, _, m5 = step(params, ref_adamw_init(params),
                    {"tokens": jnp.asarray(toks)})
    _, _, m4 = step(params, ref_adamw_init(params),
                    {"tokens": jnp.asarray(toks[:4])})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m5[k]), float(m4[k]), rtol=1e-6,
                                   err_msg=k)


def test_dense_step_on_the_grid_equals_unsharded():
    """test_system.py's config on the emulated (data 2, model 4) grid:
    one step's loss, params and moments equal the unsharded step's bit
    for bit (one device runs every rank; the grid only checks
    divisibility)."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), d_model=64,
                              n_heads=4, n_kv_heads=2)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = {"tokens": _tokens(cfg, (8, 16))}
    opt = AdamWConfig(lr=1e-3)
    dist = make_context(make_mesh((2, 4), ("data", "model")))
    pu, su, mu = make_train_step(cfg, None, opt)(params, adamw_init(params),
                                                 toks)
    ps, ss, ms = make_train_step(cfg, dist, opt)(params, adamw_init(params),
                                                 toks)
    assert torch.equal(mu["loss"], ms["loss"])
    for a, b in zip(_leaves([pu, su]), _leaves([ps, ss])):
        assert torch.equal(a, b)


def _no_host_maps(monkeypatch):
    """Count every host build of a backward map."""
    built = []
    orig = ops._cached

    def counted(key, kind, build):
        built.append(kind)
        return orig(key, kind, build)

    monkeypatch.setattr(ops, "_cached", counted)
    return built


def test_ep_step_grads_match_dense_and_reference(monkeypatch):
    """olmoe-smoke at capacity 8.0 (no drops): the expert-parallel step's
    grads, each leaf in the global layout, are within 2e-4 of the dense-MoE
    step's and of the reference's sharded step's; the step builds no
    backward map on the host and its loss matches the reference's."""
    rcfg = dataclasses.replace(ref_smoke("olmoe-1b-7b"), capacity_factor=8.0)
    tcfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                               capacity_factor=8.0)
    _, params, _, tparams = _both("olmoe-1b-7b", rcfg, tcfg)
    toks = _tokens(rcfg, (8, 16))
    # the reference, sharded on its (2, 4) mesh
    mesh = ref_mesh((2, 4), ("data", "model"))
    rdist = ref_context(mesh)
    pshard = RS.as_shardings(RS.param_specs(params, rcfg, rdist), rdist)
    bshard = {k: NamedSharding(mesh, v)
              for k, v in RS.batch_specs(rcfg, rdist, 8).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: RT.lm_loss(p, rcfg, rdist, b)),
        in_shardings=(pshard, bshard))(
        jax.device_put(params, pshard),
        jax.device_put({"tokens": jnp.asarray(toks)}, bshard))
    dist = make_context(make_mesh((2, 4), ("data", "model")))
    built = _no_host_maps(monkeypatch)
    ep_loss, ep = loss_and_grads(tparams, tcfg, dist,
                                 {"tokens": torch.from_numpy(toks)})
    assert built == []
    dense_loss, dense = loss_and_grads(tparams, tcfg, None,
                                       {"tokens": torch.from_numpy(toks)})
    tol = dict(rtol=2e-4, atol=2e-4)
    _close_leaves(ep, grads, "EP vs the reference's sharded step", **tol)
    for a, b in zip(_leaves(ep), _leaves(dense)):
        torch.testing.assert_close(a, b, **tol)
    np.testing.assert_allclose(float(ep_loss), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(ep_loss), float(dense_loss), rtol=1e-5)
    # the EP train step itself: finite, every leaf moved
    step = make_train_step(tcfg, dist, AdamWConfig(lr=1e-3))
    new, state, m = step(tparams, adamw_init(tparams), {"tokens": toks})
    assert np.isfinite(float(m["loss"])) and built == []
    assert all(not torch.equal(a, b) for a, b in zip(_leaves(new),
                                                      _leaves(tparams)))


def test_ep_step_at_published_capacity_learns():
    """At the published capacity 1.25 the EP step drops assignments: its
    grads are finite, reach the router and every expert, and a repeated
    batch's loss falls over 5 steps."""
    cfg = get_smoke_config("olmoe-1b-7b")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dist = make_context(make_mesh((2, 4), ("data", "model")))
    toks = {"tokens": _tokens(cfg, (8, 16))}
    _, grads = loss_and_grads(params, cfg, dist, {
        "tokens": torch.from_numpy(toks["tokens"])})
    moe = grads["layers"]["moe"]
    for name in ("router", "w1", "w2", "w3"):
        assert bool(torch.isfinite(moe[name]).all())
    assert bool((moe["w1"].abs().sum((0, 2, 3)) > 0).all())  # every expert
    step = make_train_step(cfg, dist, AdamWConfig(
        lr=3e-3, warmup_steps=1, schedule="constant"))
    state, losses = adamw_init(params), []
    for _ in range(5):
        params, state, m = step(params, state, toks)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_remat_equals_no_remat():
    """``cfg.remat`` recomputes each block in the backward: the same loss
    and grads, bit for bit (olmoe-smoke on the grid, and smollm-smoke);
    a forward whose params need no grad runs its blocks directly."""
    dist = make_context(make_mesh((2, 4), ("data", "model")))
    blocks = []
    plain = TT.checkpoint

    def counted(*a, **k):
        blocks.append(1)
        return plain(*a, **k)

    for arch, d in (("olmoe-1b-7b", dist), ("smollm-135m", None)):
        cfg = get_smoke_config(arch)
        params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = {"tokens": torch.from_numpy(_tokens(cfg, (8, 16)))}
        l0, g0 = loss_and_grads(params, cfg, d, toks)
        remat = dataclasses.replace(cfg, remat=True)
        TT.checkpoint, blocks[:] = counted, []
        try:
            l1, g1 = loss_and_grads(params, remat, d, toks)
            assert len(blocks) == cfg.n_layers
            # a forward that no gradient needs (serving) runs no checkpoint
            TT.forward(params, remat, d, toks)
            assert len(blocks) == cfg.n_layers
        finally:
            TT.checkpoint = plain
        assert torch.equal(l0, l1)
        for a, b in zip(_leaves(g0), _leaves(g1)):
            assert torch.equal(a, b)


def test_norm_grads_flow_past_a_forward_without_grad_fn(monkeypatch):
    """The fault this slice repairs: on the card K6's forward is a ctypes
    launch whose result has no ``grad_fn``, and ``rmsnorm_op`` used to
    return it as it was, so no gradient reached the norm gains or, through
    the normed inputs, the earlier layers. Here the forward is made as
    opaque as the card's (its output detached): ``_RmsNorm`` still gives
    every leaf its gradient, equal to the differentiable CPU run's."""
    cfg = get_smoke_config("smollm-135m")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = {"tokens": torch.from_numpy(_tokens(cfg))}
    _, want = loss_and_grads(params, cfg, None, toks)
    plain = K6.rmsnorm_plain

    def opaque(*a, **k):  # y (and, under grad, r) without a grad_fn
        out = plain(*a, **k)
        return tuple(t.detach() for t in out) if isinstance(out, tuple) \
            else out.detach()

    monkeypatch.setattr(K6, "rmsnorm_plain", opaque)
    _, got = loss_and_grads(params, cfg, None, toks)
    for g, w in zip(_leaves(got), _leaves(want)):
        assert bool(g.abs().sum() > 0)
        assert torch.equal(g, w)


def test_training_loss_decreases():
    """The reference's test_training_loss_decreases on the port: the smoke
    model memorizes one batch."""
    cfg = get_smoke_config("smollm-135m")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, None, AdamWConfig(
        lr=3e-3, warmup_steps=2, total_steps=30, schedule="constant"))
    opt = adamw_init(params)
    batch = {"tokens": _tokens(cfg, (4, 32))}
    losses = []
    for _ in range(30):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5


def test_embedding_and_loss_backward_run_no_atomics(monkeypatch):
    """Under grad the embedding lookup is K1 (plain version here) with a
    K2 fold as its backward, and the loss's gold logit takes a
    non-accumulating backward: no ``index_put(accumulate)`` /
    ``scatter_add`` / ``index_add`` runs in the step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = set()

    class Names(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = str(func)
            if name.startswith("aten.index_put") and (
                    kwargs.get("accumulate") or (len(args) > 3 and args[3])):
                name += " (accumulate)"
            seen.add(name)
            return func(*args, **kwargs)

    cfg = get_smoke_config("olmoe-1b-7b")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dist = make_context(make_mesh((2, 4), ("data", "model")))
    calls = []
    for name in ("gather_rows_plain", "scatter_add_rows_plain"):
        mod = ops._gather if "gather" in name else ops._scatter
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    with Names():
        loss_and_grads(params, cfg, dist, {
            "tokens": torch.from_numpy(_tokens(cfg, (8, 16)))})
    bad = [n for n in seen if "scatter_add" in n or "index_add" in n
           or n.endswith("(accumulate)")]
    assert bad == []
    assert "gather_rows_plain" in calls and "scatter_add_rows_plain" in calls


# ---------------------------------------------------------------------------
# K6's backward (plain version) against jax.grad of the reference RMSNorms
# ---------------------------------------------------------------------------


def _pallas_chain(x, g, eps=1e-5):
    """``rmsnorm_pallas``'s function (``repro/kernels/rmsnorm.py:25-29``)
    in jnp: one rounding after the gain."""
    xf = x.astype(jnp.float32)
    y = xf * jax.lax.rsqrt(jnp.mean(jnp.square(xf), -1, keepdims=True) + eps)
    return (y * g.astype(jnp.float32)).astype(x.dtype)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("rows,d", [
    (4, 32), (128, 64), (16, 128), (3, 48), (37, 576),
    # the backward's layout: group edges (9 rows on 4 or 8 groups), the LM
    # widths, and 8200, past the rows the lanes hold (the wide kernel)
    (133, 576), (9, 2048), (5, 8200)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("round_before_gain", [False, True])
def test_rmsnorm_backward_matches_jax_grad(rows, d, dtype, round_before_gain):
    rng = np.random.default_rng(rows * d)
    x = jnp.asarray(rng.standard_normal((rows, d)), dtype)
    g = jnp.asarray(rng.standard_normal(d), dtype)
    dy = jnp.asarray(rng.standard_normal((rows, d)), dtype)
    fn = RL.rms_norm if round_before_gain else _pallas_chain
    f32 = jnp.float32
    # bfloat16: against jax.grad on float32 copies of the same values (the
    # algorithm, as tests/test_kernels.py holds the forward): JAX's own
    # bfloat16 grad of g sums the rows in bfloat16 — on (128, 64) it is
    # 0.27 off the float64 sum where the port's float32 fold is 0.056 off
    # (checked below)
    _, vjp = jax.vjp(lambda a, b: fn(a, b, 1e-5), x.astype(f32),
                     g.astype(f32))
    want_dx, want_dg = vjp(dy.astype(f32))
    dx, dg = K6.rmsnorm_bwd_plain(_t(x), _t(g), _t(dy), 1e-5,
                                  round_before_gain=round_before_gain)
    assert dx.dtype == _t(x).dtype and dg.dtype == _t(g).dtype
    tol = 1e-5 if dtype == jnp.float32 else 6e-2
    for got, want in ((dx, want_dx), (dg, want_dg)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
    if dtype == jnp.bfloat16:
        _, vjp16 = jax.vjp(lambda a, b: fn(a, b, 1e-5), x, g)
        xf = _t(x).double()
        r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-5)
        xn = xf * r
        if round_before_gain:
            xn = xn.to(torch.bfloat16).double()
        truth = (_t(dy).double() * xn).sum(0)
        jax_err = (_t(vjp16(dy)[1]).double() - truth).abs().max()
        assert (dg.double() - truth).abs().max() <= jax_err + 1e-3


@pytest.mark.parametrize("rows,d", [(1057, 40), (529, 1024), (265, 2048)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("round_before_gain", [False, True])
def test_rmsnorm_backward_chunk_edges_match_jax_grad(rows, d, dtype,
                                                     round_before_gain):
    """Row counts just past the backward's chunk edges (132 · groups rows:
    1056 at 32 lanes, 528 at 64, 264 at 128), where a chunk of rows grows
    by one group: float32 dx and dg within 1e-5 of ``jax.vjp``; bfloat16
    dx within 6e-2 of it, and dg no further from the float64 sum of its
    own terms than JAX's bfloat16 grad. (The float32 copies' vjp does not
    round x·r to bfloat16; over hundreds of rows that rounding moves dg by
    more than 6e-2 on the previous chain as on this one: 0.098 at 529 rows
    of 1024.)"""
    rng = np.random.default_rng(rows * d)
    x = jnp.asarray(rng.standard_normal((rows, d)), dtype)
    g = jnp.asarray(rng.standard_normal(d), dtype)
    dy = jnp.asarray(rng.standard_normal((rows, d)), dtype)
    fn = RL.rms_norm if round_before_gain else _pallas_chain
    f32 = jnp.float32
    _, vjp = jax.vjp(lambda a, b: fn(a, b, 1e-5), x.astype(f32),
                     g.astype(f32))
    want_dx, want_dg = vjp(dy.astype(f32))
    dx, dg = K6.rmsnorm_bwd_plain(_t(x), _t(g), _t(dy), 1e-5,
                                  round_before_gain=round_before_gain)
    if dtype == jnp.float32:
        for got, want in ((dx, want_dx), (dg, want_dg)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        return
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(want_dx, np.float32),
                               rtol=6e-2, atol=6e-2)
    _, vjp16 = jax.vjp(lambda a, b: fn(a, b, 1e-5), x, g)
    xf = _t(x).double()
    xn = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-5)
    if round_before_gain:
        xn = xn.to(torch.bfloat16).double()
    truth = (_t(dy).double() * xn).sum(0)
    jax_err = (_t(vjp16(dy)[1]).double() - truth).abs().max()
    assert (dg.double() - truth).abs().max() <= jax_err + 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_op_under_grad_runs_the_backward_pair(dtype):
    """``rmsnorm_op`` under grad is ``_RmsNorm``: the forward's bits are
    the direct path's, the backward is ``rmsnorm_bwd_plain``'s, and a
    second backward gives the same bits."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 9, 64)).astype(
        np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal(64).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.standard_normal((2, 9, 64)).astype(
        np.float32)).to(dtype)
    want = K6.rmsnorm_bwd_plain(x, g, dy, 1e-5, round_before_gain=True)
    got = []
    for _ in range(2):
        xa, ga = x.clone().requires_grad_(), g.clone().requires_grad_()
        y = ops.rmsnorm_op(xa, ga, 1e-5, round_before_gain=True)
        assert torch.equal(y.detach(), ops.rmsnorm_op(
            x, g, 1e-5, round_before_gain=True))
        y.backward(dy)
        got.append((xa.grad, ga.grad))
    for dx, dg in got:
        assert torch.equal(dx, want[0]) and torch.equal(dg, want[1])


def test_rmsnorm_bwd_plain_folds_dg_in_blocks_of_rows():
    """dg's chain: each chunk of rows (``_bwd_layout``) folded by groups
    (ascending rows), the groups in order into one partial, the partials
    in ascending order; float32 row counts around the group and chunk
    edges (8 groups of 32 lanes at D = 40; chunks of 8 up to 1056 rows,
    then 16) agree with a float64 sum within float32 rounding."""
    rng = np.random.default_rng(0)
    for rows in (1, 7, 8, 9, 17, 1055, 1056, 1057, 2113):
        x = torch.from_numpy(rng.standard_normal((rows, 40)).astype(
            np.float32))
        g = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
        dy = torch.from_numpy(rng.standard_normal((rows, 40)).astype(
            np.float32))
        dx, dg = K6.rmsnorm_bwd_plain(x, g, dy)
        xd = x.double().requires_grad_()
        gd = g.double().requires_grad_()
        (K6.rmsnorm_ref(xd, gd, 1e-5) * dy.double()).sum().backward()
        torch.testing.assert_close(dx.double(), xd.grad, rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(dg.double(), gd.grad, rtol=1e-5,
                                   atol=1e-5)


def test_port_imports_no_jax_and_nothing_of_repro():
    """No module of ``repro_torch`` (nor ``chip_smoke.py``) imports
    ``jax`` or the reference package ``repro``."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(str(path.relative_to(ROOT)), n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro",
                                           "shiro")]
    assert bad == []
