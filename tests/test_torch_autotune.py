"""The port's measured autotuning against ``repro.core.autotune`` (CPU).

The candidate list and its model times, the memory estimates and the
modeled time of a decision equal the reference's on the same plans; with
the timing replaced in both packages by one table of fixed times, both
pick the same winner and the same decisions. The on-disk cache (port
only): a hit does zero profiling with bit-identical C, a torch version
or topology change misses, corrupt and zero-byte entries warn and
re-profile, ``REPRO_MEASURE`` overrides, no cache directory means model
only. Donation never changes C, never touches the caller's tensor,
releases the private copy after its last read, and is applied where the
reference applies it.
"""
import json
import weakref

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import api as r_api  # noqa: E402
from repro.core import autotune as r_autotune  # noqa: E402
from repro.distributed.topology import Topology as RTopology  # noqa: E402
from repro_torch import SpmmConfig, Topology, compile_spmm  # noqa: E402
from repro_torch.core import api as t_api  # noqa: E402
from repro_torch.core import autotune  # noqa: E402
from repro_torch.core import dist_spmm  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.core.comm_model import TSUBAME_LIKE  # noqa: E402
from repro_torch.robustness import Fault, inject  # noqa: E402

P, N = 8, 16


def _port_csr(a):
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _b(k=64, n=N, seed=0):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


@pytest.fixture
def counted_profiles():
    events = []
    hook = autotune.register_profile_hook(events.append)
    yield events
    autotune.unregister_profile_hook(hook)


@pytest.fixture
def no_env(monkeypatch):
    for mod in (autotune, r_autotune):
        monkeypatch.delenv(mod.CACHE_ENV, raising=False)
        monkeypatch.delenv(mod.MEASURE_ENV, raising=False)


@pytest.fixture
def cache_env(tmp_path, monkeypatch, no_env):
    d = tmp_path / "atc"
    monkeypatch.setenv(autotune.CACHE_ENV, str(d))
    return d


def _cfg(**kw):
    """Small, fast measured config: one candidate, one timed run."""
    base = dict(backends=("coo",), schedule=2, overlap=False,
                n_dense_hint=N, profile_topk=1, profile_iters=1,
                profile_warmup=0)
    base.update(kw)
    return SpmmConfig(**base)


def _sans_source(h) -> dict:
    return {k: v for k, v in h.decisions.items() if k != "decision_source"}


ENUM_CONFIGS = [
    dict(),
    dict(hier="auto"),
    dict(hier=(2, 4), overlap=True),
    dict(schedule="single", hier="auto"),
    dict(schedule=3, overlap=False),
    dict(overlap=True, k_max=3, n_dense_hint=128),
]


@pytest.mark.parametrize("cfg", ENUM_CONFIGS, ids=lambda c: ",".join(
    f"{k}={v}" for k, v in c.items()) or "default")
def test_candidates_and_model_times_equal_reference(cfg, power_law_matrix):
    a = power_law_matrix()
    out = []
    for pkg, at, a_ in ((R, r_autotune, a), (t_api, autotune, _port_csr(a))):
        build_plan = pkg.build_plan
        build_hier_plan = pkg.build_hier_plan
        config = (R.SpmmConfig if pkg is R else SpmmConfig)(**cfg)
        plan = build_plan(a_, P, config.strategy, pad_to=config.pad_to)
        hc = None
        if config.hier is not None:
            G, L = (2, 4) if config.hier == "auto" else config.hier
            hc = build_hier_plan(plan, G, L, pad_to=config.pad_to)
        cands = at._enumerate(plan, hc, config, TSUBAME_LIKE)
        out.append([(c.tier, c.kind, c.K, c.overlap, c.model_time)
                    for c in cands])
    assert out[0] == out[1]
    assert len(out[1]) >= 1


MEM_CONFIGS = [
    dict(), dict(hier="auto"), dict(schedule="single"),
    dict(replicate=2), dict(replicate="auto", n_dense_hint=128),
    dict(overlap=True, schedule=2),
]


@pytest.mark.parametrize("cfg", MEM_CONFIGS, ids=lambda c: ",".join(
    f"{k}={v}" for k, v in c.items()) or "default")
def test_memory_estimates_and_modeled_time_equal_reference(
        cfg, power_law_matrix, no_env):
    a = power_law_matrix()
    for p in (4, 8):
        ref = r_api._plan_and_tune(a, p, R.SpmmConfig(**cfg),
                                   RTopology.local(P))
        ours = t_api._plan_and_tune(_port_csr(a), p, SpmmConfig(**cfg),
                                    Topology.local(P, "cpu"))
        rc, tc = R.SpmmConfig(**cfg), SpmmConfig(**cfg)
        assert autotune.estimate_device_bytes(ours[0], ours[2], tc) == \
            r_autotune.estimate_device_bytes(ref[0], ref[2], rc)
        assert autotune.rung_device_bytes(ours[0], ours[2], ours[3], tc) == \
            r_autotune.rung_device_bytes(ref[0], ref[2], ref[3], rc)
        assert autotune.decision_modeled_time(ours[3]) == \
            r_autotune.decision_modeled_time(ref[3])
    measured = dict(ours[3], total_allocation_size=12345)
    assert autotune.rung_device_bytes(ours[0], ours[2], measured, tc) == \
        12345


def _table_time(info) -> float:
    """One table of fixed times for both packages: bsr, overlap and deep
    schedules win, the hier tier loses."""
    t = {"coo": 1.0, "bsr": 0.93}[info["backend"]]
    t += 0.02 * (info["K"] or 5) - 0.04 * bool(info["overlap"])
    return t + (0.3 if info["tier"] == "hier" else 0.0)


@pytest.mark.parametrize("cfg", [
    dict(backends=("coo", "bsr")),
    dict(backends=("coo", "bsr"), hier="auto", profile_topk=4),
    dict(hier=(2, 4)),
    dict(schedule="single", backends=("bsr", "coo")),
], ids=["flat", "hier-auto", "hier-forced", "single"])
def test_fixed_time_table_picks_the_references_winner(
        cfg, power_law_matrix, monkeypatch, tmp_path, no_env):
    seen = {"ref": [], "port": []}

    def fake(tag):
        def profile(handle, b, backend, *, warmup, iters, info):
            seen[tag].append(dict(info))
            return _table_time(info)
        return profile

    monkeypatch.setattr(r_autotune, "profile_candidate", fake("ref"))
    monkeypatch.setattr(autotune, "profile_candidate", fake("port"))
    a = power_law_matrix()
    ref = R.compile_spmm(a, P, R.SpmmConfig(measure=True, **cfg))
    h = compile_spmm(_port_csr(a), P, SpmmConfig(measure=True, **cfg),
                     device="cpu")
    assert seen["ref"] == seen["port"] and seen["port"]
    assert h.decisions == ref.decisions
    assert h.decisions["decision_source"] == "measured"
    assert h.default_backend == ref.default_backend
    assert h.strategy == ref.strategy and h.overlap == ref.overlap
    b = _b(seed=2)
    np.testing.assert_allclose(h(b).numpy(), np.asarray(ref(b)),
                               rtol=2e-4, atol=2e-4)
    # the cache records agree too, the version stamps apart
    recs = []
    for pkg, at in ((R, r_autotune), (None, autotune)):
        d = tmp_path / ("ref" if pkg else "port")
        monkeypatch.setenv(at.CACHE_ENV, str(d))
        if pkg:
            R.compile_spmm(a, P, R.SpmmConfig(measure=True, **cfg))
        else:
            compile_spmm(_port_csr(a), P, SpmmConfig(measure=True, **cfg),
                         device="cpu")
        (entry,) = d.glob("*.json")
        rec = json.loads(entry.read_text())
        recs.append({k: v for k, v in rec.items()
                     if k not in ("jax", "torch", "repro")})
        monkeypatch.delenv(at.CACHE_ENV)
    assert recs[0] == recs[1]


def test_cache_hit_zero_profiling_bit_identical(power_law_matrix, cache_env,
                                                counted_profiles):
    a = _port_csr(power_law_matrix())
    h1 = compile_spmm(a, P, _cfg(), device="cpu")
    assert h1.decisions["decision_source"] == "measured"
    assert h1.decisions["measured_time"] > 0
    n_first = len(counted_profiles)
    assert n_first > 0
    assert list(cache_env.glob("*.json")), "no cache file written"
    h2 = compile_spmm(a, P, _cfg(), device="cpu")
    assert len(counted_profiles) == n_first  # zero new profiling runs
    assert h2.decisions["decision_source"] == "cache"
    assert _sans_source(h2) == _sans_source(h1)
    b = _b(seed=1)
    assert torch.equal(h2(b), h1(b))


def test_torch_version_change_misses(power_law_matrix, cache_env,
                                     counted_profiles, monkeypatch):
    a = _port_csr(power_law_matrix())
    compile_spmm(a, P, _cfg(), device="cpu")
    n_first = len(counted_profiles)
    monkeypatch.setattr(autotune, "torch_version", lambda: "torch 9.9 cuda 99")
    h = compile_spmm(a, P, _cfg(), device="cpu")
    assert len(counted_profiles) > n_first
    assert h.decisions["decision_source"] == "measured"
    assert len(list(cache_env.glob("*.json"))) == 2


def test_topology_change_misses(power_law_matrix, cache_env,
                                counted_profiles, monkeypatch):
    a = _port_csr(power_law_matrix())
    compile_spmm(a, P, _cfg(), device="cpu")
    n_first = len(counted_profiles)
    h = compile_spmm(a, 4, _cfg(), device="cpu")  # another substrate
    assert len(counted_profiles) > n_first
    assert h.decisions["decision_source"] == "measured"
    # the device's kind is part of the substrate: another card misses
    n_second = len(counted_profiles)
    monkeypatch.setattr(Topology, "device_kind", lambda self: "other card")
    compile_spmm(a, 4, _cfg(), device="cpu")
    assert len(counted_profiles) > n_second


@pytest.mark.parametrize("damage", ["{ not json at all", ""],
                         ids=["garbage", "zero-byte"])
def test_damaged_entry_warns_and_reprofiles(power_law_matrix, cache_env,
                                            counted_profiles, damage):
    a = _port_csr(power_law_matrix())
    compile_spmm(a, P, _cfg(), device="cpu")
    n_first = len(counted_profiles)
    (entry,) = cache_env.glob("*.json")
    entry.write_text(damage)
    with pytest.warns(UserWarning, match="unreadable"):
        h = compile_spmm(a, P, _cfg(), device="cpu")
    assert h.decisions["decision_source"] == "measured"
    assert len(counted_profiles) > n_first
    n_second = len(counted_profiles)
    h3 = compile_spmm(a, P, _cfg(), device="cpu")  # the rewrite hits
    assert len(counted_profiles) == n_second
    assert h3.decisions["decision_source"] == "cache"


def test_autotune_corrupt_fault_reprofiles_and_rewrites(
        power_law_matrix, cache_env, counted_profiles):
    a = _port_csr(power_law_matrix())
    with inject([Fault(kind="autotune_corrupt", site="autotune_cache",
                       mode="empty")]) as plan:
        compile_spmm(a, P, _cfg(), device="cpu")
    assert plan.fired("autotune_corrupt") == 1
    (entry,) = cache_env.glob("*.json")
    assert entry.stat().st_size == 0  # torn to zero bytes
    n_first = len(counted_profiles)
    with pytest.warns(UserWarning, match="zero-byte entry"):
        compile_spmm(a, P, _cfg(), device="cpu")
    assert len(counted_profiles) > n_first
    assert entry.stat().st_size > 0  # rewritten
    h3 = compile_spmm(a, P, _cfg(), device="cpu")
    assert h3.stats()["decision_source"] == "cache"


def test_cache_put_is_atomic(tmp_path):
    cache = autotune.AutotuneCache(str(tmp_path))
    (tmp_path / "k.json").write_text("")
    with pytest.warns(UserWarning, match="zero-byte entry"):
        assert cache.get("k") is None
    cache.put("k", {"tier": "flat"})
    assert cache.get("k")["tier"] == "flat"
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".tmp"]


def test_repro_measure_overrides(power_law_matrix, cache_env,
                                 counted_profiles, monkeypatch):
    a = _port_csr(power_law_matrix())
    monkeypatch.setenv(autotune.MEASURE_ENV, "0")
    h = compile_spmm(a, P, _cfg(measure=True), device="cpu")
    assert counted_profiles == []
    assert h.decisions["decision_source"] == "model"
    assert h.stats()["measured_time"] is None
    monkeypatch.setenv(autotune.MEASURE_ENV, "1")
    monkeypatch.delenv(autotune.CACHE_ENV)
    h = compile_spmm(a, P, _cfg(measure=False), device="cpu")
    assert len(counted_profiles) > 0
    assert h.decisions["decision_source"] == "measured"


def test_no_cache_dir_means_model_only(power_law_matrix, no_env,
                                       counted_profiles):
    a = _port_csr(power_law_matrix())
    h = compile_spmm(a, P, _cfg(), device="cpu")  # measure="auto"
    assert counted_profiles == []
    assert h.decisions["decision_source"] == "model"
    h = compile_spmm(a, P, _cfg(measure=True), device="cpu")
    assert len(counted_profiles) > 0
    assert h.decisions["decision_source"] == "measured"


def test_measured_profiles_run_the_handle(power_law_matrix, no_env,
                                          counted_profiles):
    a = _port_csr(power_law_matrix())
    h = compile_spmm(a, P, SpmmConfig(backends=("coo", "bsr"), hier="auto",
                                      measure=True, profile_warmup=0),
                     device="cpu")
    infos = {(i["tier"], i["kind"], i["K"], i["overlap"], i["backend"])
             for i in counted_profiles}
    assert len(infos) == 6  # top 3 candidates x 2 backends
    assert h.decisions["backend"] in ("coo", "bsr")
    assert h.default_backend == h.decisions["backend"]
    b = _b(seed=3)
    np.testing.assert_allclose(h(b).numpy(), a.to_dense() @ b,
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# donation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,cfg", [
    ((64, 64), dict()), ((64, 32), dict()), ((64, 64), dict(kernel="sddmm")),
    ((64, 64), dict(kernel="fused")), ((64, 64), dict(replicate=2)),
    ((64, 64), dict(donate=False)), ((64, 64), dict(hier=(2, 4))),
], ids=["square", "non-square", "sddmm", "fused", "replicated", "off",
        "hier"])
def test_donated_buffers_equal_reference(shape, cfg, power_law_matrix):
    a = power_law_matrix(m=shape[0], k=shape[1])
    ref = R.compile_spmm(a, P, R.SpmmConfig(**cfg))
    h = compile_spmm(_port_csr(a), P, SpmmConfig(**cfg), device="cpu")
    assert h.stats()["donated_buffers"] == ref.stats()["donated_buffers"]


@pytest.mark.parametrize("cfg", [
    dict(schedule="single"), dict(schedule=4, overlap=False),
    dict(schedule=4, overlap=True), dict(hier=(2, 4), schedule=2,
                                         overlap=True),
    dict(hier=(2, 4), schedule="single"),
], ids=["single", "staged", "overlapped", "hier-overlapped", "hier-single"])
def test_donation_never_changes_c(cfg, power_law_matrix, monkeypatch):
    a = _port_csr(power_law_matrix())
    donated = []
    fn = dist_spmm.hier_spmm if "hier" in cfg else dist_spmm.flat_spmm
    name = fn.__name__

    def spy(ex, b, *args, **kw):
        donated.append(isinstance(b, list))
        return fn(ex, b, *args, **kw)

    monkeypatch.setattr(t_api, name, spy)
    # a non-contiguous view: each call makes a private contiguous copy,
    # which a donating handle hands over (and a coo diagonal writes C into)
    b = torch.from_numpy(_b(seed=5).T.copy()).T
    keep = b.clone()
    outs = [compile_spmm(a, P, SpmmConfig(backends=("coo", "bsr"),
                                          donate=d, **cfg), device="cpu")
            for d in (True, False)]
    cs = [(h(b), h(b, backend="bsr")) for h in outs]
    assert donated == [True, True, False, False]
    assert torch.equal(cs[0][0], cs[1][0]) and torch.equal(cs[0][1],
                                                           cs[1][1])
    assert torch.equal(b, keep)


def test_donation_spares_the_callers_tensor(power_law_matrix, monkeypatch):
    a = _port_csr(power_law_matrix())
    donated = []
    orig = dist_spmm.flat_spmm

    def spy(ex, b, *args, **kw):
        donated.append(isinstance(b, list))
        return orig(ex, b, *args, **kw)

    monkeypatch.setattr(t_api, "flat_spmm", spy)
    h = compile_spmm(a, P, SpmmConfig(schedule=2), device="cpu")
    assert h._donate
    b = torch.from_numpy(_b(seed=6))
    keep = b.clone()
    c1 = h(b)                      # the caller's own tensor: never donated
    bt = torch.from_numpy(_b(seed=6).T.copy()).T  # non-contiguous view
    c2 = h(bt)                     # a private contiguous copy: donated
    assert donated == [False, True]
    assert torch.equal(b, keep) and torch.equal(bt, keep)
    assert torch.equal(c1, c2) and torch.equal(h(b), c1)


def test_donation_spares_a_callers_numpy_array(power_law_matrix,
                                               monkeypatch):
    """On the CPU a numpy B becomes a tensor over the caller's own memory:
    no copy is made, so nothing is donated and the array keeps its
    values, though a donated coo diagonal writes C over its operand."""
    a = _port_csr(power_law_matrix())
    donated = []
    orig = dist_spmm.flat_spmm

    def spy(ex, b, *args, **kw):
        donated.append(isinstance(b, list))
        return orig(ex, b, *args, **kw)

    monkeypatch.setattr(t_api, "flat_spmm", spy)
    h = compile_spmm(a, P, SpmmConfig(schedule=2), device="cpu")
    b = _b(seed=7)
    keep = b.copy()
    c = h(b)
    assert donated == [False]
    np.testing.assert_array_equal(b, keep)
    assert torch.equal(h(torch.from_numpy(b.T.copy()).T.contiguous()), c)
    bg = torch.from_numpy(_b(seed=6).T.copy()).requires_grad_(True).T
    h(bg)                          # a B that requires grad: never donated
    assert donated[-1] is False


def test_executor_releases_a_donated_b_after_its_last_read(
        power_law_matrix, monkeypatch):
    """The staged body's last read of B is the diagonal compute; by the
    aggregation ④ nothing holds the donated tensor any more."""
    a = _port_csr(power_law_matrix())
    h = compile_spmm(a, P, SpmmConfig(schedule=2, overlap=False),
                     device="cpu")
    b = torch.from_numpy(_b(seed=7))
    ref = weakref.ref(b)
    alive = []
    orig = dist_spmm.scatter_add_rows_exec_op

    def agg(*args, **kw):
        alive.append(ref() is not None)
        return orig(*args, **kw)

    monkeypatch.setattr(dist_spmm, "scatter_add_rows_exec_op", agg)
    want = dist_spmm.flat_spmm(h.ex, b.clone())
    held = [b]
    del b
    c = dist_spmm.flat_spmm(h.ex, held)
    assert held == [] and alive == [True, False]
    assert torch.equal(c, want)


def test_memory_per_executable_on_the_cpu(power_law_matrix):
    """No allocator stats off the card: the key is recorded with {} and
    stats() falls back to the decisions' figure (None, model-only)."""
    h = compile_spmm(_port_csr(power_law_matrix()), P, device="cpu")
    h(_b())
    assert h._memory == {(N, "float32", "coo"): {}}
    assert h.stats()["total_allocation_size"] is None
