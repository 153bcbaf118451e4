"""Sharding rules against ``repro.distributed.sharding`` (CPU).

``param_specs`` / ``opt_state_specs`` / ``batch_specs`` / ``cache_specs``
equal the reference's leaf for leaf — the port writes a spec as a tuple
of axis names where the reference has a ``PartitionSpec`` — on every
arch's smoke and published parameter shapes, over a (data 2, model 4)
grid, a (pod 2, data 2, model 2) grid and with FSDP. ``as_shardings`` /
``place_tree`` place a tree on one device: the leaves themselves, after
the divisibility check of ``DistContext.shard``.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro.configs import ARCHS, get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.distributed import sharding as RS  # noqa: E402
from repro.distributed.context import make_context as ref_context  # noqa: E402
from repro.launch.mesh import make_mesh as ref_mesh  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.distributed.context import make_context  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

GRIDS = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]


def _contexts(shape, axes, fsdp):
    return (ref_context(ref_mesh(shape, axes), fsdp=fsdp),
            make_context(make_mesh(shape, axes), fsdp=fsdp))


def _spec(p) -> tuple:
    return tuple(p)


def _same_tree(port, ref):
    """Every leaf spec of ``ref`` (PartitionSpecs) equals ``port``'s."""
    from jax.sharding import PartitionSpec

    flat, tree = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(flat)
    for path, spec in flat:
        node = port
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert node == _spec(spec), (path, node, spec)


@pytest.fixture(scope="module")
def shapes():
    """Each arch's smoke and published parameter shapes (abstract)."""
    out = {}
    for arch in ARCHS:
        for kind, cfg in (("smoke", ref_smoke(arch)),
                          ("full", ref_config(arch))):
            out[arch, kind] = (cfg, jax.eval_shape(
                lambda cfg=cfg: RT.init_params(jax.random.PRNGKey(0), cfg)))
    return out


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(g[1]))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("kind", ["smoke", "full"])
def test_param_and_opt_specs_equal_reference(shapes, grid, fsdp, kind):
    rdist, tdist = _contexts(*grid, fsdp)
    for arch in ARCHS:
        cfg, tree = shapes[arch, kind]
        ref = RS.param_specs(tree, cfg, rdist)
        port = TS.param_specs(tree, cfg, tdist)
        _same_tree(port, ref)
        _same_tree(TS.opt_state_specs(port), RS.opt_state_specs(ref))


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(g[1]))
def test_batch_and_cache_specs_equal_reference(grid):
    rdist, tdist = _contexts(*grid, False)
    for arch in ARCHS:
        for kind in ("smoke", "full"):
            rcfg = ref_smoke(arch) if kind == "smoke" else ref_config(arch)
            tcfg = get_smoke_config(arch) if kind == "smoke" else \
                get_config(arch)
            for seq_shard in (False, True):
                rc = dataclasses.replace(rcfg, kv_seq_shard=seq_shard)
                tc = dataclasses.replace(tcfg, kv_seq_shard=seq_shard)
                for b in (1, 2, 3, 4, 8, 12):
                    _same_tree(TS.batch_specs(tc, tdist, b),
                               RS.batch_specs(rc, rdist, b))
                    _same_tree(TS.cache_specs(tc, tdist, b),
                               RS.cache_specs(rc, rdist, b))


def test_shardings_place_a_tree_in_place():
    """On one device placement moves nothing; a dim that its axes do not
    divide raises, as the reference's sharding does."""
    from repro_torch.models import transformer as TT

    cfg = get_smoke_config("olmoe-1b-7b")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dist = make_context(make_mesh((2, 4), ("data", "model")))
    sh = TS.param_shardings(params, cfg, dist)
    placed = TS.place_tree(params, sh)
    assert placed["layers"]["moe"]["w1"] is params["layers"]["moe"]["w1"]
    assert sh["layers"]["moe"]["w1"].spec == (None, "model", None, None)
    bsh = TS.as_shardings(TS.batch_specs(cfg, dist, 8), dist)
    toks = torch.zeros((8, 16), dtype=torch.int32)
    assert TS.place_tree({"tokens": toks}, bsh)["tokens"] is toks
    bad = TS.Sharding(dist, ("data", None))
    with pytest.raises(ValueError, match="not divisible"):
        bad.place(torch.zeros((3, 16)))
    assert np.prod([dist.axis_size(a) for a in ("data", "model")]) == 8
