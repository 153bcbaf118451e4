"""The port's expert-parallel MoE path against ``repro.models.moe`` (CPU).

``moe_layer`` with a (data 2, model 4) ``DistContext`` runs ``_moe_ep``
on the grid's emulated ranks; the reference runs its shard_map over 8
host devices. The same params (the reference's ``init_moe_params``) and
inputs (numpy seeds) go through both: the outputs agree in float32
within 2e-4 for both dispatch modes, top-k 1 / 2 / 4, a capacity that
drops nothing and one that drops (0.5), with and without
``shiro_capacity``, and with the fp8 dispatch; the M model ranks' outputs
are equal bit for bit (the reference's output is replicated over the
model axis); the grads match ``jax.grad`` within rtol 2e-3 / atol 2e-4.
The comm log carries Dsz·M·M·cap activation rows per exchange, and the
dedup fills fewer dispatch rows than the classic exchange does for the
same routing.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.distributed.context import DistContext as RDist  # noqa: E402
from repro.launch.mesh import make_mesh as r_make_mesh  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models.config import ModelConfig as RConfig  # noqa: E402
from repro_torch.distributed.context import make_context  # noqa: E402
from repro_torch.kernels import scatter_add_rows as K2  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
GRID = ((2, 4), ("data", "model"))
POD_GRID = ((2, 2, 2), ("pod", "data", "model"))


def _cfgs(**kw):
    base = dict(name="moe-t", family="moe", n_layers=1, d_model=32,
                n_heads=4, n_kv_heads=4, d_ff=48, vocab_size=64,
                n_experts=8, top_k=2, capacity_factor=8.0,
                dtype="float32", remat=False)
    base.update(kw)
    return RConfig(**base), ModelConfig(**base)


def _dists(grid=GRID):
    shape, axes = grid
    batch = tuple(a for a in axes if a != "model")
    return (RDist(mesh=r_make_mesh(shape, axes), batch_axes=batch,
                  model_axis="model"),
            make_context(make_mesh(shape, axes)))


def _inputs(cfg, seed=0, shape=(4, 8)):
    p = RM.init_moe_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    x = np.random.default_rng(seed + 1).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    return (p, jnp.asarray(x),
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()},
            torch.from_numpy(x))


def _reference(p, x, cfg, dist):
    return np.asarray(jax.jit(lambda p, x: RM.moe_layer(p, x, cfg, dist))(
        p, x))


def _check_ep(rcfg, tcfg, grid=GRID, shape=(4, 8)):
    rdist, tdist = _dists(grid)
    jp, jx, tp, tx = _inputs(rcfg, shape=shape)
    want = _reference(jp, jx, rcfg, rdist)
    ranks = TM._moe_ep(tp, tx, tcfg, tdist, tcfg.shiro_dispatch,
                       all_ranks=True)
    for m in range(1, tdist.model_size):  # replicated over the model axis
        assert torch.equal(ranks[m], ranks[0]), m
    got = TM.moe_layer(tp, tx, tcfg, tdist)
    assert torch.equal(got, ranks[0])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    return got, tdist


@pytest.mark.parametrize("shiro_capacity", [False, True])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
@pytest.mark.parametrize("top_k", [1, 2, 4])
@pytest.mark.parametrize("shiro", [True, False])
def test_ep_matches_reference(shiro, top_k, capacity_factor,
                              shiro_capacity):
    rcfg, tcfg = _cfgs(top_k=top_k, shiro_dispatch=shiro,
                       capacity_factor=capacity_factor,
                       shiro_capacity=shiro_capacity)
    _check_ep(rcfg, tcfg)


@pytest.mark.parametrize("shiro", [True, False])
def test_ep_fp8_dispatch_matches_reference(shiro):
    rcfg, tcfg = _cfgs(shiro_dispatch=shiro,
                       moe_dispatch_dtype="float8_e4m3fn")
    got, _ = _check_ep(rcfg, tcfg)
    # the rounding to fp8 shows: the dispatch is not the float32 one
    rcfg32, tcfg32 = _cfgs(shiro_dispatch=shiro)
    _, tdist = _dists()
    _, _, tp, tx = _inputs(rcfg32)
    assert not torch.equal(got, TM.moe_layer(tp, tx, tcfg32, tdist))


def test_ep_on_a_pod_data_model_grid():
    rcfg, tcfg = _cfgs(top_k=2, capacity_factor=1.0)
    _check_ep(rcfg, tcfg, grid=POD_GRID, shape=(8, 4))


def test_fp8_cast_matches_xla():
    """``float8_e4m3fn`` as XLA converts it: round to nearest even, and
    past 464 (the rounding range of 448, the largest finite value), an
    infinity or a NaN gives NaN with the input's sign."""
    v = np.array([0.0, -0.0, 0.3, -1.7, 1e-3, 2e-9, 300.0, 448.0, 449.0,
                  464.0, 465.0, 470.0, 500.0, -500.0, 1e6, np.inf, -np.inf,
                  np.nan], np.float32)
    v = np.concatenate([v, np.random.default_rng(0).standard_normal(
        4096).astype(np.float32) * 50.0])
    for dt in (jnp.float32, jnp.bfloat16):
        x = jnp.asarray(v).astype(dt)
        want = np.asarray(jax.jit(lambda x: x.astype(jnp.float8_e4m3fn))(x))
        tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.float32 if dt == jnp.float32 else torch.bfloat16)
        got = TM.to_dispatch_dtype(tx, torch.float8_e4m3fn)
        assert np.array_equal(got.view(torch.uint8).numpy(),
                              want.view(np.uint8)), dt


def test_ep_grads_match_reference():
    rcfg, tcfg = _cfgs(top_k=2)
    rdist, tdist = _dists()
    jp, jx, tp, tx = _inputs(rcfg)

    def loss(p, x):
        return jnp.sum(RM.moe_layer(p, x, rcfg, rdist) ** 2)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jx)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xg = tx.clone().requires_grad_(True)
    (TM.moe_layer(leaves, xg, tcfg, tdist) ** 2).sum().backward()
    for k in jp:
        np.testing.assert_allclose(leaves[k].grad.numpy(),
                                   np.asarray(gp[k]), **GRAD_TOL)
    np.testing.assert_allclose(xg.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    # the backward ran the transposed exchanges, one per forward one
    assert tdist.comm.rows("model", "bwd") > 0


@pytest.mark.parametrize("shiro_capacity", [False, True])
def test_ep_rows_and_dedup(shiro_capacity):
    """The log: Dsz·M·M·cap activation rows per exchange (dispatch and
    return), the index / gate lists apart. The dedup: for the same
    routing, SHIRO fills fewer dispatch rows than the classic exchange."""
    sent, drops = {}, {}
    for shiro in (True, False):
        rcfg, tcfg = _cfgs(top_k=4, shiro_dispatch=shiro,
                           shiro_capacity=shiro_capacity)
        _, tdist = _dists()
        _, _, tp, tx = _inputs(rcfg)
        with TM.record_dispatch() as rec:
            TM.moe_layer(tp, tx, tcfg, tdist)
        (r,) = rec
        dsz, M = 2, tdist.model_size
        acts = [n for op, _, n in tdist.comm.log if op == "all_to_all@model"]
        assert acts == [dsz * M * M * r["cap"]] * 2
        assert tdist.comm.rows("model") == sum(acts)
        e_loc = tcfg.n_experts // M
        assert tdist.comm.rows("model:meta") == 2 * dsz * M * M * e_loc
        sent[shiro], drops[shiro] = int(r["sent"]), int(r["dropped"])
    assert drops == {True: 0, False: 0}  # capacity 8.0: no drops
    assert sent[True] < sent[False] == 4 * 8 * 4  # tokens x top-k


def test_ep_drops_are_counted():
    rcfg, tcfg = _cfgs(top_k=4, capacity_factor=0.5)
    _, tdist = _dists()
    _, _, tp, tx = _inputs(rcfg)
    with TM.record_dispatch() as rec:
        TM.moe_layer(tp, tx, tcfg, tdist)
    assert int(rec[0]["dropped"]) > 0 and rec[0]["cap"] == 8


def test_ep_repeats_bit_for_bit():
    rcfg, tcfg = _cfgs(top_k=4)
    _, tdist = _dists()
    _, _, tp, tx = _inputs(rcfg)
    assert torch.equal(TM.moe_layer(tp, tx, tcfg, tdist),
                       TM.moe_layer(tp, tx, tcfg, tdist))


def test_dense_fallbacks_follow_reference():
    """dist None, a model axis of 1 or one that does not divide the
    experts: the dense path, as the reference dispatches."""
    rcfg, tcfg = _cfgs(n_experts=6)
    jp, jx, tp, tx = _inputs(rcfg)
    dense = TM._moe_dense(tp, tx, tcfg)
    _, tdist = _dists()  # 6 % 4 != 0
    assert torch.equal(TM.moe_layer(tp, tx, tcfg, tdist), dense)
    one = make_context(make_mesh((8, 1), ("data", "model")))
    assert torch.equal(TM.moe_layer(tp, tx, tcfg, one), dense)
    assert tdist.comm.log == [] and one.comm.log == []


def test_sorted_scatter_maps_equal_host_preparation():
    rng = np.random.default_rng(3)
    for P, S, M in ((3, 17, 5), (2, 1, 1), (4, 40, 9)):
        tgt = rng.integers(-1, M, (P, S)).astype(np.int32)
        tgt[0] = -1  # a rank with no real target
        perm, meta = K2.sorted_scatter_maps(torch.from_numpy(tgt))
        hp, hm = K2.stack_sorted_scatter(tgt)
        assert np.array_equal(perm.numpy(), hp)
        assert np.array_equal(meta.numpy(), hm)


def test_dispatch_capacity_arithmetic_matches_reference():
    """The capacities come from the reference's Python-float arithmetic,
    in its order, at the full configuration's width."""
    from repro_torch.configs import get_config

    cfg = get_config("olmoe-1b-7b")
    for shc in (False, True):
        c = dataclasses.replace(cfg, shiro_capacity=shc, d_model=8, d_ff=8)
        _, tdist = _dists()
        gen = torch.Generator().manual_seed(0)
        p = TM.init_moe_params(gen, c, torch.float32, device="cpu")
        x = torch.randn(8, 128, c.d_model, generator=gen)
        with TM.record_dispatch() as rec:
            TM.moe_layer(p, x, c, tdist)
        t_loc = 4 * 128
        rows = 4 * (1.0 - (1.0 - 1.0 / 4) ** 8) if shc else 8
        assert rec[0]["cap"] == max(8, int(t_loc * rows / 4 * 1.25))
        assert rec[0]["cap_e"] == max(8, int(t_loc * 8 / 64 * 1.25)) == 80
    assert rec[0]["cap"] == 575


def test_rank_in_key_is_the_reference_one_hot_cumsum():
    """``_rank_in_key`` against the reference's slot arithmetic,
    ``cumsum(one_hot(key) & ok) - 1`` read at each entry's key, on every
    entry that is ``ok``."""
    rng = np.random.default_rng(7)
    for R, N, K in ((3, 50, 4), (2, 1, 1), (5, 200, 17)):
        key = rng.integers(0, K, (R, N))
        ok = rng.random((R, N)) < 0.7
        onehot = (key[..., None] == np.arange(K)) & ok[..., None]
        want = np.take_along_axis(np.cumsum(onehot, 1) - 1, key[..., None],
                                  2)[..., 0]
        got = TM._rank_in_key(torch.from_numpy(key), torch.from_numpy(ok), K)
        assert np.array_equal(got.numpy()[ok], want[ok])
