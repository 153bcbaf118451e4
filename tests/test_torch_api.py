"""The port's front door against ``repro.compile_spmm`` (CPU, plain versions).

Decisions equal the reference's, C matches it, the executable memo counts
hits, save/load gives a bit-identical C, the CUDA default refuses to run
without a card, the ``hier=`` options build two-tier handles with the
reference's decisions, unported options raise, and the port imports
neither JAX nor the JAX package.
"""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.robustness.guards import NumericalFault  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
STATS_KEYS = ("strategy", "plan_strategy", "P", "shape", "backends",
              "default_backend", "schedule_kind", "schedule_K", "overlap",
              "volume_rows", "volume_rows_padded",
              "volume_rows_padded_single", "pattern_nnz",
              "pattern_fingerprint", "decision_source", "replicate")


def _port_csr(a):
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _b(k=64, n=16, seed=0):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


CONFIGS = [
    dict(backends=("coo", "bsr")),
    dict(backends=("coo", "bsr"), schedule="single"),
    dict(schedule=2, overlap=False),
    dict(schedule="auto", overlap=True, k_max=3),
    dict(strategy="col", n_dense_hint=128),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: ",".join(
    f"{k}={v}" for k, v in c.items()))
def test_decisions_and_stats_equal_reference(cfg, power_law_matrix):
    for a, P in [(power_law_matrix(), 8),
                 (R.random_sparse(64, 64, 0.05, 1), 4)]:
        ref = R.compile_spmm(a, P, R.SpmmConfig(**cfg))
        h = T.compile_spmm(_port_csr(a), P, T.SpmmConfig(**cfg), device="cpu")
        assert h.decisions == ref.decisions
        want, got = ref.stats(), h.stats()
        assert {k: got[k] for k in STATS_KEYS} == \
            {k: want[k] for k in STATS_KEYS}


def test_c_matches_reference_and_cache_counts(power_law_matrix):
    a = power_law_matrix()
    cfg = dict(backends=("coo", "bsr"))
    ref = R.compile_spmm(a, 8, R.SpmmConfig(**cfg))
    h = T.compile_spmm(_port_csr(a), 8, T.SpmmConfig(**cfg), device="cpu")
    b = _b()
    want = np.asarray(ref(b))
    c = h(b)
    assert c.shape == (64, 16) and c.device.type == "cpu"
    np.testing.assert_allclose(c.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h(torch.from_numpy(b), backend="bsr").numpy(),
                               a.to_dense() @ b, rtol=2e-4, atol=2e-4)
    assert h.comm.rows() == h.plan.volume_rows_padded(h.schedule)
    assert torch.equal(h(b), c)  # cache hit, same bits
    info = h.cache_info()
    assert (info["lowerings"], info["hits"]) == (2, 1)
    assert info["keys"] == ((16, "float32", "coo"), (16, "float32", "bsr"))
    assert h.stats()["calls"] == 3


@pytest.mark.parametrize("overlap", [False, True])
def test_save_load_bit_identical(tmp_path, power_law_matrix, overlap):
    h = T.compile_spmm(_port_csr(power_law_matrix()), 8,
                       T.SpmmConfig(backends=("coo", "bsr"), schedule=2,
                                    overlap=overlap), device="cpu")
    path = tmp_path / "plan.shiro"
    h.save(str(path))
    h2 = T.DistSpmm.load(str(path), device="cpu")
    assert h2.decisions == h.decisions and h2.overlap == overlap
    b = _b(seed=3)
    for be in ("coo", "bsr"):
        assert torch.equal(h2(b, backend=be), h(b, backend=be))
    with pytest.raises(T.TopologyError, match="exactly 8"):
        T.DistSpmm.load(str(path), 4, device="cpu")


def test_load_rejects_foreign_files(tmp_path):
    empty = tmp_path / "empty"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        T.DistSpmm.load(str(empty), device="cpu")
    foreign = tmp_path / "foreign"
    import pickle

    foreign.write_bytes(pickle.dumps({"format": "shiro.DistSpmm"}))
    with pytest.raises(ValueError, match="not a saved repro_torch"):
        T.DistSpmm.load(str(foreign), device="cpu")


def test_cuda_default_raises_without_cuda(monkeypatch, power_law_matrix):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.compile_spmm(_port_csr(power_law_matrix()), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Topology.local(4)


@pytest.mark.parametrize("fields,item", [
    (dict(replicate=2), "10"), (dict(replicate="auto"), "10"),
    (dict(measure=True), "11"),
], ids=lambda v: ",".join(f"{k}={x}" for k, x in v.items())
    if isinstance(v, dict) else f"item{v}")
def test_unported_options_raise(fields, item):
    """An option of an open ROADMAP item raises NotImplementedError naming
    the item. Items 10 (replication) and 11 (measured autotuning) are
    ported: their options now build a config that keeps them."""
    cfg = T.SpmmConfig(**fields)
    assert all(getattr(cfg, k) == v for k, v in fields.items())


# the reference's hier exec pieces pass through jax.tree_util, which
# sorts their backend keys, so its ``backends`` is compared as a set
HIER_KEYS = tuple(k for k in STATS_KEYS if k != "backends") + (
    "G", "L", "kernel", "modeled_time_flat", "modeled_time_hier",
    "hier_candidate")


@pytest.mark.parametrize("fields", [
    dict(hier="auto"), dict(hier=(2, 4)),
    dict(kernel="sddmm", hier="auto"), dict(kernel="fused", hier=(2, 4)),
], ids=lambda v: ",".join(f"{k}={x}" for k, x in v.items()))
def test_hier_options_compile(fields, power_law_matrix):
    """The hier configs build a handle with the reference's decisions, and
    its C (and the sampled values / fused C of the sibling kernels)
    matches the reference handle's."""
    a = power_law_matrix()
    cfg = dict(fields, backends=("coo", "bsr"))
    ref = R.compile_spmm(a, 8, R.SpmmConfig(**cfg))
    h = T.compile_spmm(_port_csr(a), 8, T.SpmmConfig(**cfg), device="cpu")
    assert h.strategy == ref.strategy == "hier"
    assert h.decisions == ref.decisions
    want, got = ref.stats(), h.stats()
    assert {k: got[k] for k in HIER_KEYS} == {k: want[k] for k in HIER_KEYS}
    assert set(got["backends"]) == set(want["backends"])
    assert f"hier(G={got['G']},L={got['L']})" in repr(h)
    rng = np.random.default_rng(4)
    x, y = (rng.standard_normal((64, 4)).astype(np.float32)
            for _ in range(2))
    b = _b(seed=4)
    for be in ("coo", "bsr"):
        np.testing.assert_allclose(
            h(b, kernel="spmm", backend=be).numpy(),
            np.asarray(ref(b, kernel="spmm", backend=be)),
            rtol=2e-4, atol=2e-4)
        assert h.comm.rows("g") == h.schedule.volume_rows_padded()
    if fields.get("kernel") == "sddmm":
        vals, want_vals = h(x, y), ref(x, y)
        for piece in vals:
            np.testing.assert_allclose(
                vals[piece].numpy(), np.asarray(want_vals[piece]).reshape(
                    vals[piece].shape), rtol=2e-4, atol=2e-4)
    if fields.get("kernel") == "fused":
        np.testing.assert_allclose(h(x, y, b).numpy(),
                                   np.asarray(ref(x, y, b)),
                                   rtol=2e-4, atol=2e-4)


def test_hier_auto_on_hub_picks_two_tiers():
    """``tests/test_api.py``'s acceptance case on the port: hier="auto"
    on a hub pattern under the TSUBAME-like network keeps (G, L) = (2, 4)."""
    a = R.hub_sparse(64, 64, 2, 2, 0.3, 3)
    h = T.compile_spmm(_port_csr(a), 8, T.SpmmConfig(
        hier="auto", backends=("coo", "bsr")), device="cpu")
    st = h.stats()
    assert h.strategy == "hier" and (st["G"], st["L"]) == (2, 4)
    assert st["modeled_time_hier"] < st["modeled_time_flat"]
    b = _b(seed=1)
    for be in ("coo", "bsr"):
        np.testing.assert_allclose(h(b, backend=be).numpy(),
                                   a.to_dense() @ b, rtol=1e-4, atol=1e-4)
    ref = R.compile_spmm(a, 8, R.SpmmConfig(hier="auto"))
    assert h.decisions == ref.decisions


def test_hier_forced_single_round(power_law_matrix):
    a = power_law_matrix()
    cfg = dict(hier=(4, 2), schedule="single", backends=("coo", "bsr"))
    ref = R.compile_spmm(a, 8, R.SpmmConfig(**cfg))
    h = T.compile_spmm(_port_csr(a), 8, T.SpmmConfig(**cfg), device="cpu")
    st = h.stats()
    assert (st["G"], st["L"], st["schedule_kind"]) == (4, 2, "single")
    assert h.decisions == ref.decisions
    assert st["volume_rows_padded"] == st["volume_rows_padded_single"] == \
        ref.stats()["volume_rows_padded"]
    b = _b(seed=2)
    c = h(b, backend="bsr")
    np.testing.assert_allclose(c.numpy(), a.to_dense() @ b, rtol=2e-4,
                               atol=2e-4)
    assert [op for op, _, _ in h.comm.log] == [
        "all_to_all@g", "psum_scatter@l", "all_to_all@g", "all_gather@l"]
    with pytest.raises(ValueError, match="incompatible with P=8"):
        T.compile_spmm(_port_csr(a), 8, hier=(3, 2), device="cpu")
    with pytest.raises(ValueError, match="hier must be"):
        T.SpmmConfig(hier=4)


@pytest.mark.parametrize("schedule", ["single", 2])
def test_hier_save_load_bit_identical(tmp_path, power_law_matrix, schedule):
    h = T.compile_spmm(_port_csr(power_law_matrix()), 8,
                       T.SpmmConfig(backends=("coo", "bsr"), hier=(2, 4),
                                    schedule=schedule, overlap=True),
                       device="cpu")
    path = tmp_path / "hier.shiro"
    h.save(str(path))
    h2 = T.DistSpmm.load(str(path), device="cpu")
    assert h2.strategy == "hier" and h2.decisions == h.decisions
    assert h2.stats()["G"] == 2 and h2.overlap == h.overlap
    b = _b(seed=6)
    for be in ("coo", "bsr"):
        assert torch.equal(h2(b, backend=be), h(b, backend=be))


def test_guards(power_law_matrix):
    a = _port_csr(power_law_matrix())
    h = T.compile_spmm(a, 4, device="cpu")
    with pytest.raises(ValueError, match="K=64"):
        h(_b(k=32))
    with pytest.raises(TypeError, match="floating point"):
        h(np.ones((64, 4), np.int32))
    b = _b()
    b[5, 2] = np.nan
    with pytest.raises(NumericalFault, match="non-finite C"):
        h(b)
    assert h.numerical_faults == 1
    unchecked = T.compile_spmm(a, 4, device="cpu", check=False)
    assert torch.isnan(unchecked(b)).any()
    bad = dataclasses.replace(a, data=a.data.copy())
    bad.data[0] = np.inf
    with pytest.raises(NumericalFault, match="non-finite nonzero"):
        T.compile_spmm(bad, 4, device="cpu")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "shiro"), \
                f"{path.relative_to(ROOT)} imports {mod}"
    # and at run time: importing the whole port loads no JAX module
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels.ops;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'shiro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
