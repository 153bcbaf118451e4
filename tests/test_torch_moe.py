"""The port's MoE layer and MoE dispatch against ``repro.models.moe`` (CPU).

``moe_layer`` (the single-device ``_moe_dense`` path) agrees with the
reference in float32 within 1e-5 on the moe smoke configs; the dispatch
matrix and the classic/SHIRO row counts are array-equal; the dispatch
handle's decisions equal the reference's ``compile_dispatch`` and its C
is within 2e-4 (the executor tolerance) of the dense dispatch.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

MOE_ARCHS = ["olmoe-1b-7b", "dbrx-132b"]
DISPATCH = [("olmoe-1b-7b", 64, 8, 0), ("olmoe-1b-7b", 96, 4, 3),
            ("dbrx-132b", 64, 4, 1)]  # (arch, tokens, M, seed), smoke configs


def _params(cfg, seed):
    p = RM.init_moe_params(jax.random.PRNGKey(seed), cfg, jnp.dtype(cfg.dtype))
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_matches_reference(arch):
    cfg = jax_smoke(arch)
    jp, tp = _params(cfg, 0)
    x = np.random.default_rng(1).standard_normal((2, 7, cfg.d_model)).astype(
        np.float32)
    want = np.asarray(RM.moe_layer(jp, jnp.asarray(x), cfg, None))
    got = TM.moe_layer(tp, torch.from_numpy(x), get_smoke_config(arch))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_top_k_gates_match_reference():
    logits = np.random.default_rng(2).standard_normal((9, 8)).astype(
        np.float32)
    g_want, i_want = RM._top_k_gates(jnp.asarray(logits), 3)
    g_got, i_got = TM._top_k_gates(torch.from_numpy(logits), 3)
    assert np.array_equal(i_got.numpy(), np.asarray(i_want))
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), rtol=1e-6,
                               atol=1e-6)


def test_moe_layer_bf16_activations_use_a_float32_router():
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                              dtype="bfloat16")
    _, tp = _params(jax_smoke("olmoe-1b-7b"), 3)
    tp = {k: v if k == "router" else v.to(torch.bfloat16)
          for k, v in tp.items()}
    x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator().manual_seed(0))
    y = TM.moe_layer(tp, x.to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert bool(torch.isfinite(y.float()).all())


def test_moe_layer_expert_parallel_raises():
    """A model axis that divides the experts runs the expert-parallel path
    (``tests/test_torch_moe_ep.py`` holds it to the reference); one that
    does not takes the dense path, as the reference's ``moe_layer`` does;
    a batch that the batch axes cannot split raises."""
    from repro_torch.distributed.context import make_context
    from repro_torch.launch.mesh import make_mesh

    cfg = get_smoke_config("olmoe-1b-7b")
    _, tp = _params(jax_smoke("olmoe-1b-7b"), 0)
    x = torch.zeros(2, 2, cfg.d_model)
    dist = make_context(make_mesh((2, 4), ("data", "model")))
    assert TM.moe_layer(tp, x, cfg, dist).shape == x.shape
    assert dist.comm.rows("model") > 0  # the all_to_alls ran
    with pytest.raises(ValueError, match="not divisible"):
        TM.moe_layer(tp, x[:1], cfg, dist)

    class Dist:
        model_size = 3  # does not divide the 8 experts: the dense path

    assert TM.moe_layer(tp, x, cfg, Dist()).shape == x.shape


@pytest.mark.parametrize("arch,tokens,M,seed", DISPATCH)
def test_dispatch_matrix_and_comm_rows_equal(arch, tokens, M, seed):
    cfg = jax_smoke(arch)
    want = RM.dispatch_matrix(cfg, tokens, M, seed)
    got = TM.dispatch_matrix(get_smoke_config(arch), tokens, M, seed)
    assert tuple(got.shape) == tuple(want.shape)
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert TM.moe_comm_rows(get_smoke_config(arch), tokens, M, seed) == \
        RM.moe_comm_rows(cfg, tokens, M, seed)


def test_dispatch_matrix_rejects_bad_sizes():
    cfg = get_smoke_config("olmoe-1b-7b")
    with pytest.raises(ValueError, match="divisible"):
        TM.dispatch_matrix(cfg, 10, 4)
    with pytest.raises(ValueError, match="must divide n_experts"):
        TM.dispatch_matrix(cfg, 12, 3)


@pytest.mark.parametrize("arch,tokens,M,seed", DISPATCH[:2])
def test_compile_dispatch_decisions_and_c(arch, tokens, M, seed):
    ref = RM.compile_dispatch(jax_smoke(arch), tokens, M, seed=seed)
    h = TM.compile_dispatch(get_smoke_config(arch), tokens, M, seed=seed,
                            device="cpu")
    assert h.decisions == ref.decisions
    st, rst = h.stats(), ref.stats()
    for key in ("schedule_kind", "schedule_K", "overlap", "volume_rows",
                "volume_rows_padded", "volume_rows_padded_single",
                "pattern_nnz", "shape", "backends"):
        assert st[key] == rst[key], key
    x = np.random.default_rng(seed).standard_normal((tokens, 40)).astype(
        np.float32)
    a = TM.dispatch_matrix(get_smoke_config(arch), tokens, M, seed)
    dense = np.zeros(a.shape, np.float64)
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    dense[rows, a.indices] = a.data
    c = h(torch.from_numpy(x))
    np.testing.assert_allclose(c.double().numpy(), dense @ x, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(ref(jnp.asarray(x))),
                               rtol=2e-4, atol=2e-4)


def test_full_size_dispatch_decisions_equal_reference():
    """The dispatch chip_smoke.py plans: olmoe-1b-7b, 1024 tokens, M = 8."""
    from repro.configs import get_config as jax_config

    ref = RM.compile_dispatch(jax_config("olmoe-1b-7b"), 1024, 8)
    h = TM.compile_dispatch(get_config("olmoe-1b-7b"), 1024, 8, device="cpu")
    assert h.decisions == ref.decisions
