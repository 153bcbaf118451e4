"""The rest of the port's host surface against the JAX package (CPU).

``csr_from_dense`` / ``bsr_from_csr`` / ``BSRMatrix`` give the
reference's arrays; ``balance_stats`` and the named networks equal the
reference's; ``gather_rows_op`` / ``scatter_add_rows_op`` (K1 / K2's plain
versions here) match the reference's ops within 1e-5 and differentiate;
the lowering hooks fire for the same keys as the reference's on the same
call sequence; ``dispatch_session`` has the reference's decisions,
``maybe_replan`` result and C; ``repro_torch.core`` exports every name of
``repro.core``; the three torch examples run on the CPU.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ops as ROps  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops as TOps  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# names of repro.core the port leaves out: none, every one is ported
JAX_ONLY = ()
STATS_KEYS = ("strategy", "plan_strategy", "P", "shape", "backends",
              "default_backend", "schedule_kind", "schedule_K", "overlap",
              "volume_rows", "volume_rows_padded",
              "volume_rows_padded_single", "pattern_nnz",
              "pattern_fingerprint")


def _port_csr(a):
    return T.CSRMatrix(tuple(a.shape), a.indptr.copy(), a.indices.copy(),
                       a.data.copy())


def test_core_exports_cover_the_reference():
    missing = [n for n in R.__all__ if n not in T.__all__]
    assert missing == list(JAX_ONLY)
    assert all(hasattr(T, n) for n in T.__all__)


@pytest.mark.parametrize("shape,block", [((37, 29), (8, 8)),
                                         ((64, 64), (16, 8)),
                                         ((5, 7), (4, 4))])
def test_bsr_from_csr_equals_reference(shape, block):
    rng = np.random.default_rng(sum(shape))
    dense = rng.standard_normal(shape).astype(np.float32)
    dense[rng.random(shape) > 0.1] = 0.0
    want = R.bsr_from_csr(R.csr_from_dense(dense), block)
    csr = T.csr_from_dense(dense)
    ref_csr = R.csr_from_dense(dense)
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(csr, f), getattr(ref_csr, f)), f
    got = T.bsr_from_csr(csr, block)
    assert (got.shape, got.block_shape, got.nblocks) == \
        (want.shape, want.block_shape, want.nblocks)
    for f in ("block_indptr", "block_cols", "blocks"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f

    def to_dense(m):  # a stored edge block that overhangs the matrix
        try:          # makes both refuse, as written
            return m.to_dense()
        except ValueError:
            return None

    if to_dense(want) is None:
        assert to_dense(got) is None
    else:
        assert np.array_equal(to_dense(got), dense)


def test_balance_stats_and_networks_equal_reference(power_law_matrix):
    for a, P in ((power_law_matrix(), 8), (R.random_sparse(64, 64, 0.05, 1),
                                          4), (R.random_sparse(8, 8, 0.0, 0),
                                               2)):
        want = R.balance_stats(R.build_plan(a, P))
        got = T.balance_stats(T.build_plan(_port_csr(a), P))
        assert got == want
    for name in ("TSUBAME_LIKE", "TPU_POD", "AURORA_LIKE"):
        assert dataclasses.asdict(getattr(T, name)) == \
            dataclasses.asdict(getattr(R, name))


def test_gather_and_scatter_ops_match_reference():
    rng = np.random.default_rng(0)
    b = rng.standard_normal((40, 24)).astype(np.float32)
    idx = rng.integers(-1, 40, 57).astype(np.int32)
    want = np.asarray(ROps.gather_rows_op(jnp.asarray(b), jnp.asarray(idx),
                                          bn=8))
    got = TOps.gather_rows_op(torch.from_numpy(b), idx)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    c = rng.standard_normal((30, 24)).astype(np.float32)
    parts = rng.standard_normal((57, 24)).astype(np.float32)
    tgt = rng.integers(-1, 30, 57).astype(np.int32)
    want = np.asarray(ROps.scatter_add_rows_op(jnp.asarray(c),
                                               jnp.asarray(parts), tgt))
    tc = torch.from_numpy(c)
    got = TOps.scatter_add_rows_op(tc, torch.from_numpy(parts), tgt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(tc, torch.from_numpy(c))  # c itself is untouched


def test_gather_and_scatter_ops_differentiate_as_reference():
    rng = np.random.default_rng(1)
    b = rng.standard_normal((20, 8)).astype(np.float32)
    idx = rng.integers(-1, 20, 33).astype(np.int32)
    c = rng.standard_normal((12, 8)).astype(np.float32)
    tgt = rng.integers(-1, 12, 33).astype(np.int32)

    def loss(b, c):
        g = ROps.gather_rows_op(b, jnp.asarray(idx), bn=8)
        return jnp.sum(ROps.scatter_add_rows_op(c, g * g, tgt) ** 2)

    gb, gc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(b), jnp.asarray(c))
    tb = torch.from_numpy(b).requires_grad_(True)
    tc = torch.from_numpy(c).requires_grad_(True)
    g = TOps.gather_rows_op(tb, idx)
    (TOps.scatter_add_rows_op(tc, g * g, tgt) ** 2).sum().backward()
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc), rtol=1e-5,
                               atol=1e-5)


def test_lowering_hooks_fire_as_reference(power_law_matrix):
    a = power_law_matrix()
    cfg = dict(backends=("coo", "bsr"))
    b16 = np.random.default_rng(0).standard_normal((64, 16)).astype(
        np.float32)
    b32 = np.random.default_rng(1).standard_normal((64, 32)).astype(
        np.float32)
    seen = {"ref": [], "port": []}

    def run(mod, h, tag):
        hook = mod.register_lowering_hook(
            lambda handle, key: seen[tag].append((id(handle), key)))
        try:
            for b, be in ((b16, None), (b16, None), (b32, None),
                          (b16, "bsr"), (b32, None), (b16, "bsr")):
                h(b) if be is None else h(b, backend=be)
        finally:
            mod.unregister_lowering_hook(hook)

    ref = R.compile_spmm(a, 8, R.SpmmConfig(**cfg))
    run(R, ref, "ref")
    port = T.compile_spmm(_port_csr(a), 8, T.SpmmConfig(**cfg), device="cpu")
    run(T, port, "port")
    assert [k for _, k in seen["port"]] == [k for _, k in seen["ref"]]
    assert len(seen["port"]) == 3 and {i for i, _ in seen["port"]} == \
        {id(port)}
    port(b16[:, :8])  # a new key, after unregistering: no call
    assert len(seen["port"]) == 3


def test_dispatch_session_matches_reference():
    cfg = jax_smoke("olmoe-1b-7b")
    tcfg = get_smoke_config("olmoe-1b-7b")
    T_, M = 64, 4
    ref = RM.dispatch_session(cfg, T_, M)
    got = TM.dispatch_session(tcfg, T_, M, device="cpu")
    assert got.handle().decisions == ref.handle().decisions
    want, have = ref.handle().stats(), got.handle().stats()
    assert {k: have[k] for k in STATS_KEYS} == \
        {k: want[k] for k in STATS_KEYS}
    x = np.random.default_rng(2).standard_normal(
        (T_, tcfg.d_model)).astype(np.float32)
    dense = RM.dispatch_matrix(cfg, T_, M).to_dense() @ x
    np.testing.assert_allclose(got.handle()(x).numpy(), dense, rtol=2e-4,
                               atol=2e-4)
    for seed in (0, 1):  # the same routing (no drift), then a fresh one
        r = ref.maybe_replan(RM.dispatch_matrix(cfg, T_, M, seed=seed))
        assert got.maybe_replan(TM.dispatch_matrix(tcfg, T_, M,
                                                   seed=seed)) == r
        assert got.handle().decisions == ref.handle().decisions
    dense = RM.dispatch_matrix(cfg, T_, M, seed=1).to_dense() @ x
    np.testing.assert_allclose(got.handle()(x).numpy(), dense, rtol=2e-4,
                               atol=2e-4)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(RL.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(bias)))
    got = TL.layer_norm(*(torch.from_numpy(v) for v in (x, g, bias)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("example", ["torch_quickstart.py",
                                     "torch_serve_batched.py",
                                     "torch_moe_serve.py"])
def test_example_runs_on_the_cpu(example, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / example), "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "✓" in proc.stdout
