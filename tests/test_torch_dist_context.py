"""The port's emulated grids against ``repro.distributed`` / ``repro.launch``
and the LM under a ``DistContext`` against ``repro.models`` (CPU).

``make_mesh`` / ``make_context`` / ``shard`` / ``logical_to_spec`` carry
the reference's names, sizes and checks; ``MeshComm``'s collectives on a
named axis are the ``jax.lax`` ones; ``attention_decode_seqshard``
(flash-decoding over the cache's length split across the model axis)
matches the reference within 2e-4; ``forward``, ``lm_loss``,
``decode_step`` (also with ``kv_seq_shard``) and ``ContinuousBatcher``
under a (data 2, model 4) and a (pod 2, data 2, model 2) context match
the reference's on olmoe-smoke (the expert-parallel MoE path) and qwen2
smoke: logits within 2e-4, tokens equal. Weights are the reference's
``init_params`` carried by ``transformer_from_numpy``; inputs come from
numpy seeds.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.distributed import context as RC  # noqa: E402
from repro.launch import mesh as RMesh  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import scheduler as RS  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import context as TC  # noqa: E402
from repro_torch.distributed.comm import MeshComm  # noqa: E402
from repro_torch.distributed.topology import (  # noqa: E402
    Topology, TopologyError,
)
from repro_torch.launch import mesh as TMesh  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import scheduler as TS  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
GRIDS = {"data2_model4": ((2, 4), ("data", "model")),
         "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}


def _dists(grid):
    shape, axes = GRIDS[grid]
    return (RC.make_context(RMesh.make_mesh(shape, axes)),
            TC.make_context(TMesh.make_mesh(shape, axes)))


def test_meshes_match_reference():
    for fn, args, kw in ((RMesh.make_production_mesh, (), {}),
                         (RMesh.make_production_mesh, (),
                          {"multi_pod": True}),
                         (RMesh.make_spmm_mesh, (8,), {}),
                         (RMesh.make_spmm_mesh, (8,), {"groups": 2})):
        want = fn(*args, **kw) if "production" not in fn.__name__ else None
        got = getattr(TMesh, fn.__name__)(*args, **kw)
        if want is None:  # 256 / 512 devices: compare the descriptor
            shape = (2, 16, 16) if kw else (16, 16)
            axes = ("pod", "data", "model") if kw else ("data", "model")
            assert dict(got.shape) == dict(zip(axes, shape))
            assert got.axis_names == axes and got.size == int(np.prod(shape))
            continue
        assert dict(got.shape) == dict(want.shape)
        assert got.axis_names == tuple(want.axis_names)
        assert got.size == want.size
    with pytest.raises(ValueError, match="not divisible"):
        TMesh.make_spmm_mesh(8, groups=3)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_context_matches_reference(grid, fsdp):
    shape, axes = GRIDS[grid]
    want = RC.make_context(RMesh.make_mesh(shape, axes), fsdp=fsdp)
    got = TC.make_context(TMesh.make_mesh(shape, axes), fsdp=fsdp)
    for f in ("batch_axes", "model_axis", "pod_axis", "fsdp_axis",
              "batch_size_divisor", "model_size"):
        assert getattr(got, f) == getattr(want, f), f
    for a in axes:
        assert got.axis_size(a) == want.axis_size(a)
    for n in (6, 8, 12):
        assert got.divisible(n, "model") == want.divisible(n, "model")
        assert got.model_axis_if_divisible(n) == \
            want.model_axis_if_divisible(n)

    def one(entry):  # PartitionSpec writes a one-axis tuple as the name
        return entry[0] if isinstance(entry, tuple) and len(entry) == 1 \
            else entry

    for roles in (("batch", None, "model"), ("fsdp", "vocab"), (None,)):
        assert tuple(map(one, TC.logical_to_spec(got, *roles))) == \
            tuple(RC.logical_to_spec(want, *roles))
    assert TC.logical_to_spec(None, "batch") is None
    assert got.layout == got.batch_axes + ("model",)


def test_make_context_refuses_a_grid_less_topology():
    with pytest.raises(TopologyError, match="needs named"):
        TC.make_context(Topology.local(8, device="cpu"))


def test_shard_checks_divisibility_and_is_the_identity():
    _, dist = _dists("data2_model4")
    x = torch.zeros(4, 3, 8)
    assert TC.shard(x, dist, (dist.batch_axes, None, "model")) is x
    assert TC.shard(x, None, None) is x
    with pytest.raises(ValueError, match="not divisible"):
        TC.shard(torch.zeros(3, 3, 8), dist, (dist.batch_axes, None, None))
    with pytest.raises(ValueError, match="not divisible"):
        TC.shard(torch.zeros(4, 3, 6), dist, (None, None, "model"))
    with pytest.raises(TypeError, match="DistContext"):
        TC.shard(x, object(), (None,))


def test_mesh_collectives_are_the_lax_ones():
    """all_to_all / pmax / psum over the model axis of a (data, model)
    grid against shard_map with jax.lax on 8 host devices."""
    from repro.compat import shard_map
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 4, 3, 5)).astype(np.float32)
    mesh = RMesh.make_mesh((2, 4), ("data", "model"))

    def body(v):
        v = v[0, 0]  # this rank's [M(dst), 3, 5]
        a = jax.lax.all_to_all(v, "model", 0, 0, tiled=False)
        return (a[None, None], jax.lax.pmax(v, "model")[None, None],
                jax.lax.psum(v, "model")[None, None])

    spec = P("data", "model", None, None, None)
    want = shard_map(body, mesh=mesh, in_specs=(spec,),
                     out_specs=(spec, spec, spec))(jnp.asarray(x))
    comm = MeshComm({"data": 2, "model": 4})
    layout = ("data", "model")
    tx = torch.from_numpy(x)
    got = (comm.all_to_all(tx, layout, "model"),
           comm.pmax(tx, layout, "model"), comm.psum(tx, layout, "model"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert [op for op, _, _ in comm.log] == \
        ["all_to_all@model", "pmax@model", "psum@model"]
    assert comm.rows("model") == 3 * 2 * 4 * 4 * 3
    assert comm.rows("data") == 0
    pairs = comm.log[0][1]
    assert len(pairs) == 2 * 4 * 4 and all(s // 4 == d // 4 for s, d in pairs)
    with pytest.raises(ValueError, match="lead with"):
        comm.psum(tx[:1], layout, "model")


def _attn_params(rng, d, h, kvh, hd):
    shapes = {"wq": (d, h * hd), "wk": (d, kvh * hd), "wv": (d, kvh * hd),
              "wo": (h * hd, d)}
    return {k: (rng.standard_normal(s) * d ** -0.5).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_seqshard_decode_matches_reference(grid):
    rdist, tdist = _dists(grid)
    rng = np.random.default_rng(3)
    d, h, kvh, hd, smax, b = 32, 4, 2, 8, 16, 4
    p = _attn_params(rng, d, h, kvh, hd)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    k0 = rng.standard_normal((b, kvh, smax, hd)).astype(np.float32)
    v0 = rng.standard_normal((b, kvh, smax, hd)).astype(np.float32)
    step = jax.jit(lambda p, x, c: RL.attention_decode(
        p, x, c, h, kvh, dist=rdist, seq_shard=True))
    for start in (0, 3, smax - 2):  # the write crosses rank boundaries
        jc = RL.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                        jnp.asarray(start, jnp.int32))
        tc = TL.KVCache(torch.from_numpy(k0.copy()),
                        torch.from_numpy(v0.copy()), start)
        for _ in range(min(5, smax - start + 1)):  # the last one past Smax
            x = rng.standard_normal((b, 1, d)).astype(np.float32)
            want, jc = step(jp, jnp.asarray(x), jc)
            got, tc = TL.attention_decode(tp, torch.from_numpy(x), tc, h,
                                          kvh, dist=tdist, seq_shard=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
            np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)
            assert tc.length == int(jc.length)
    assert {op for op, _, _ in tdist.comm.log} == {"pmax@model",
                                                   "psum@model"}
    bad = TL.KVCache(torch.zeros(b, kvh, 10, hd), torch.zeros(
        b, kvh, 10, hd), 0)
    if tdist.model_size == 4:
        with pytest.raises(ValueError, match="not divisible"):
            TL.attention_decode(tp, torch.zeros(b, 1, d), bad, h, kvh,
                                dist=tdist, seq_shard=True)


def _lm(arch, **kw):
    cfg = dataclasses.replace(jax_smoke(arch), **kw)
    tcfg = dataclasses.replace(get_smoke_config(arch), **kw)
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    tp = TT.transformer_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                   tcfg, device="cpu")
    return cfg, params, tcfg, tp


@pytest.mark.parametrize("arch,grid,seq_shard", [
    ("olmoe-1b-7b", "data2_model4", False),
    ("olmoe-1b-7b", "data2_model4", True),
    ("olmoe-1b-7b", "pod2_data2_model2", True),
    ("qwen2-1.5b", "data2_model4", True),
])
def test_forward_and_decode_under_dist_match_reference(arch, grid, seq_shard):
    """At a capacity that drops nothing, so that each decode step's
    logits also equal the forward's (the batcher's test keeps the
    published 1.25, which drops)."""
    rdist, tdist = _dists(grid)
    cfg, params, tcfg, tp = _lm(arch, kv_seq_shard=seq_shard,
                                capacity_factor=8.0)
    b, s, smax = 4, 7, 8
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)
    fwd = jax.jit(lambda p, t: RT.forward(p, cfg, rdist, {"tokens": t}))
    want = np.asarray(fwd(params, jnp.asarray(toks)))
    got = TT.forward(tp, tcfg, tdist, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    loss = jax.jit(lambda p, t: RT.lm_loss(p, cfg, rdist, {"tokens": t}))
    np.testing.assert_allclose(
        float(TT.lm_loss(tp, tcfg, tdist, {"tokens": torch.from_numpy(toks)})),
        float(loss(params, jnp.asarray(toks))), **TOL)
    dec = jax.jit(lambda p, t, c: RT.decode_step(p, cfg, rdist, t, c))
    jc = RT.init_decode_cache(cfg, b, smax)
    tc = TT.init_decode_cache(tcfg, b, smax, device="cpu")
    for j in range(s):
        lj, jc = dec(params, jnp.asarray(toks[:, j:j + 1]), jc)
        lt, tc = TT.decode_step(tp, tcfg, tdist,
                                torch.from_numpy(toks[:, j:j + 1]), tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        np.testing.assert_allclose(lt.numpy()[:, 0], want[:, j], **TOL)
    ops = {op for op, _, _ in tdist.comm.log}
    assert ("all_to_all@model" in ops) == (cfg.family == "moe")
    assert ("psum@model" in ops) == seq_shard


def test_lm_loss_matches_reference_unsharded():
    cfg, params, tcfg, tp = _lm("smollm-135m")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9)).astype(
        np.int32)
    want = float(RT.lm_loss(params, cfg, None, {"tokens": jnp.asarray(toks)}))
    got = TT.lm_loss(tp, tcfg, None, {"tokens": torch.from_numpy(toks)})
    assert got.shape == () and abs(float(got) - want) <= 1e-4 * abs(want)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_batcher_under_dist_matches_reference(grid):
    rdist, tdist = _dists(grid)
    cfg, params, tcfg, tp = _lm("olmoe-1b-7b", kv_seq_shard=True)
    lengths, new = [3, 6, 4, 5, 2, 7], 4

    def requests(mod):
        rng = np.random.default_rng(1)
        return [mod.Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(lengths)]

    def serve(batcher, reqs):
        for r in reqs:
            batcher.submit(r)
        return batcher.run()

    ref = requests(RS)
    ref_stats = serve(RS.ContinuousBatcher(cfg, params, 4, 16, dist=rdist),
                      ref)
    got = requests(TS)
    stats = serve(TS.ContinuousBatcher(tcfg, tp, 4, 16, dist=tdist), got)
    assert [r.output for r in got] == [r.output for r in ref]
    for f in ("served", "generated_tokens", "decode_steps"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    again = requests(TS)
    serve(TS.ContinuousBatcher(tcfg, tp, 4, 16, dist=tdist), again)
    assert [r.output for r in again] == [r.output for r in got]
