"""The port's wave server and elastic controller against the reference's.

Ports the wave, elastic and chaos cases of ``tests/test_serving_elastic.py``
and the bounded-events case of ``tests/test_fleet.py`` at the reference's
sizes and seeds. The same scenario runs through both packages: host-side
decisions (mesh plans, controller events, rungs) and every server counter
are equal to the reference's; each wave's C is ``torch.equal`` to the
port's cold ``compile_spmm`` on the (P, pattern) it was served under and
within 2e-4 of the reference's C on the same numpy inputs.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.configs import get_smoke_config as r_smoke_config  # noqa: E402
from repro.core.api import SpmmConfig as RConfig  # noqa: E402
from repro.core.api import compile_spmm as r_compile  # noqa: E402
from repro.core.session import SpmmSession as RSession  # noqa: E402
from repro.core.sparse import power_law_sparse as r_power_law  # noqa: E402
from repro.robustness import Fault as RFault  # noqa: E402
from repro.robustness import faults as r_faults  # noqa: E402
from repro.robustness import inject as r_inject  # noqa: E402
from repro.serving.scheduler import SpmmRequest as RRequest  # noqa: E402
from repro.serving.scheduler import SpmmWaveServer as RServer  # noqa: E402
from repro.train import elastic as r_elastic  # noqa: E402
from repro_torch import (  # noqa: E402
    ElasticController, SpmmConfig, SpmmRequest, SpmmSession,
    SpmmWaveServer, compile_spmm, propose_mesh,
)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.core.planner import plan_build_count  # noqa: E402
from repro_torch.robustness import Fault, faults, inject  # noqa: E402

TOL = 2e-4


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from repro.core import autotune as r_autotune
    from repro_torch.core import autotune

    for mod in (autotune, r_autotune):
        monkeypatch.delenv(mod.CACHE_ENV, raising=False)
        monkeypatch.delenv(mod.MEASURE_ENV, raising=False)
    for mod in (faults, r_faults):
        monkeypatch.delenv(mod.FAULTS_ENV, raising=False)
        mod.uninstall()
    yield
    faults.uninstall()
    r_faults.uninstall()


def _port_csr(a):
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _b(seed, k=64, n=16):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


def _stats(server) -> dict:
    return dataclasses.asdict(server.stats)


def _check_c(got: torch.Tensor, cold: torch.Tensor, ref) -> None:
    """The port's served C: bit for bit its cold compile's, on the CPU,
    and within 2e-4 of the reference's C."""
    assert got.device.type == "cpu" and torch.equal(got, cold)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# the elastic controller's decisions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,census,batch", [
    ("qwen2-1.5b", 256, 256), ("olmoe-1b-7b", 48, 96),
    ("qwen2-1.5b", 192, 256), ("qwen2-1.5b", 0, 8)])
def test_propose_mesh_equals_reference(arch, census, batch):
    ours = propose_mesh(get_smoke_config(arch), census, batch)
    ref = r_elastic.propose_mesh(r_smoke_config(arch), census, batch)
    if ref is None:
        assert ours is None
        return
    assert (ours.shape, ours.axes, ours.reason, ours.size) == \
        (ref.shape, ref.axes, ref.reason, ref.size)
    assert ours.size <= census
    cfg = get_smoke_config(arch)
    if cfg.is_moe:
        assert cfg.n_experts % ours.shape[1] == 0
    assert batch % ours.shape[0] == 0


def test_elastic_controller_remesh_on_loss():
    ctl = ElasticController(get_smoke_config("qwen2-1.5b"), global_batch=256)
    ref = r_elastic.ElasticController(r_smoke_config("qwen2-1.5b"),
                                      global_batch=256)
    for census in (256, 256, 192, 0, 192):
        changed, plan = ctl.on_census(census)
        r_changed, r_plan = ref.on_census(census)
        assert changed == r_changed
        assert (plan is None) == (r_plan is None)
        if plan is not None:
            assert plan.shape == r_plan.shape
    assert ctl.events == ref.events and len(ctl.events) == 3


# ---------------------------------------------------------------------------
# waves over a static handle; the bounded event ring
# ---------------------------------------------------------------------------


def test_wave_server_static_handle(power_law_matrix):
    a = power_law_matrix()
    handle = compile_spmm(_port_csr(a), 8, SpmmConfig(schedule="auto"),
                          device="cpu")
    r_handle = r_compile(a, 8, RConfig(schedule="auto"))
    b = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    server, ref = SpmmWaveServer(handle, max_batch=3), RServer(
        r_handle, max_batch=3)
    reqs = [SpmmRequest(rid=rid, b=b) for rid in range(7)]
    for rid, req in enumerate(reqs):
        server.submit(req)
        ref.submit(RRequest(rid=rid, b=b))
    stats = server.run()
    ref.run()
    assert stats.served == 7 and stats.waves == 3  # 3+3+1
    assert stats.swaps == 0 and stats.dropped_waves == 0
    assert _stats(server) == _stats(ref)
    assert [r.wave for r in reqs] == [0, 0, 0, 1, 1, 1, 2]
    cold = compile_spmm(_port_csr(a), 8, SpmmConfig(schedule="auto"),
                        device="cpu")(b)
    for r in reqs:
        _check_c(r.output, cold, r_handle(b))


def test_wave_server_events_bounded(power_law_matrix):
    a = power_law_matrix()
    handle = compile_spmm(_port_csr(a), 4, device="cpu")
    r_handle = r_compile(a, 4)
    kw = dict(max_batch=1, max_retries=5, backoff=0.0, degrade=False,
              max_events=2)
    server, ref = SpmmWaveServer(handle, **kw), RServer(r_handle, **kw)
    b = _b(7, n=8)
    server.submit(SpmmRequest(rid=0, b=b))
    ref.submit(RRequest(rid=0, b=b))
    with inject([Fault(kind="wave_error", site="wave", times=3)]):
        server.run()
    with r_inject([RFault(kind="wave_error", site="wave", times=3)]):
        ref.run()
    # three failed attempts logged, ring keeps only the newest two
    assert server.events_total == ref.events_total == 3
    assert len(server.events) == 2
    assert all(e["action"] == "wave_failed" for e in server.events)
    assert [e["attempt"] for e in server.events] == \
        [e["attempt"] for e in ref.events] == [1, 2]
    assert server.stats.dropped_waves == 0 and server.stats.served == 1
    assert _stats(server) == _stats(ref)


def test_wave_server_drops_after_max_retries(power_law_matrix):
    """Retries exhausted: the wave is requeued whole, counted once in
    ``dropped_waves`` and the failure surfaces, as in the reference."""
    a = power_law_matrix()
    handle = compile_spmm(_port_csr(a), 4, device="cpu")
    server = SpmmWaveServer(handle, max_batch=2, max_retries=1, backoff=0.0)
    reqs = [SpmmRequest(rid=i, b=_b(i)) for i in range(2)]
    for r in reqs:
        server.submit(r)
    with inject([Fault(kind="wave_error", site="wave", times=2)]):
        with pytest.raises(faults.InjectedFault):
            server.run()
    assert server.stats.dropped_waves == 1 and server.stats.failed_waves == 2
    assert list(server.queue) == reqs and all(r.output is None for r in reqs)
    server.run()
    assert server.stats.served == 2 and not server.queue


# ---------------------------------------------------------------------------
# session lifecycle x wave serving: grow -> shrink -> drift; chaos
# ---------------------------------------------------------------------------


class _Both:
    """One scenario through the port and the reference side by side."""

    def __init__(self, a, cfg: dict, ladder, **server_kw):
        self.cfg = cfg
        self.session = SpmmSession.build(_port_csr(a), 8, SpmmConfig(**cfg),
                                         p_ladder=ladder, device="cpu")
        self.r_session = RSession.build(a, 8, RConfig(**cfg),
                                        p_ladder=ladder)
        self.ctl = ElasticController(get_smoke_config("qwen2-1.5b"),
                                     global_batch=8)
        self.r_ctl = r_elastic.ElasticController(
            r_smoke_config("qwen2-1.5b"), global_batch=8)
        self.ctl.attach_spmm(self.session)
        self.r_ctl.attach_spmm(self.r_session)
        self.server = SpmmWaveServer(self.session, **server_kw)
        self.r_server = RServer(self.r_session, **server_kw)
        self._cold = {}

    def census(self, n):
        assert self.ctl.on_census(n)[0] == self.r_ctl.on_census(n)[0]
        assert self.ctl.events == self.r_ctl.events
        assert self.session.current_P == self.r_session.current_P

    def submit(self, rids, b):
        reqs = [SpmmRequest(rid=rid, b=b) for rid in rids]
        r_reqs = [RRequest(rid=rid, b=b) for rid in rids]
        for r, rr in zip(reqs, r_reqs):
            self.server.submit(r)
            self.r_server.submit(rr)
        return reqs, r_reqs

    def run(self):
        self.server.run()
        self.r_server.run()
        assert _stats(self.server) == _stats(self.r_server)

    def check(self, reqs, r_reqs, a, P, b):
        """C equals the port's cold compile on (P, pattern) — one cold
        compile per distinct pair — and the reference's served C."""
        key = (P, id(a))
        if key not in self._cold:
            self._cold[key] = compile_spmm(_port_csr(a), P,
                                           SpmmConfig(**self.cfg),
                                           device="cpu")
        cold = self._cold[key](b)
        for r, rr in zip(reqs, r_reqs):
            assert r.wave == rr.wave
            _check_c(r.output, cold, rr.output)


def test_grow_shrink_drift_hot_swap_serving(power_law_matrix):
    a = power_law_matrix()
    s = _Both(a, dict(schedule="auto"), (4, 8), max_batch=2)
    s.census(8)
    b = np.random.default_rng(1).standard_normal((64, 16)).astype(np.float32)

    reqs = s.submit([0, 1], b)
    s.run()
    s.check(*reqs, a, 8, b)

    # shrink to the P=4 rung — pre-planned, so NO MWVC re-run
    n0 = plan_build_count()
    s.census(5)
    assert s.session.current_P == 4 and plan_build_count() == n0
    reqs = s.submit([2, 3], b)
    s.run()
    s.check(*reqs, a, 4, b)

    # grow back to the full fleet
    n1 = plan_build_count()
    s.census(8)
    assert s.session.current_P == 8 and plan_build_count() == n1
    reqs = s.submit([4, 5], b)
    s.run()
    s.check(*reqs, a, 8, b)

    # the pattern drifts past the threshold: off-path replan, warm swap
    a_new = r_power_law(64, 64, 400, 1.2, seed=91)
    drift, swapped = s.session.maybe_replan(_port_csr(a_new))
    assert (drift, swapped) == s.r_session.maybe_replan(a_new)
    assert swapped and drift > s.session.config.drift_threshold
    reqs = s.submit([6, 7], b)
    s.run()
    s.check(*reqs, a_new, 8, b)

    stats = s.server.stats
    assert stats.dropped_waves == 0  # the hot-swap contract
    assert stats.served == 8 and stats.waves == 4
    assert stats.swaps == 3  # shrink, grow, drift replan
    assert s.session.handle().stats()["drift"] == drift


def test_chaos_kill_degrade_drift_replan_serving(power_law_matrix):
    a = power_law_matrix()
    s = _Both(a, dict(schedule="auto"), (4, 8), max_batch=4, max_retries=2,
              backoff=0.0)
    s.census(8)
    assert s.session.current_P == 8
    b = np.random.default_rng(3).standard_normal((64, 16)).astype(np.float32)
    reqs = s.submit(range(3), b)

    # the P=8 rung fails twice: the first retry re-resolves, the second
    # drives the session down to the surviving rung
    with inject([Fault(kind="wave_error", site="wave", times=2)]) as plan, \
            r_inject([RFault(kind="wave_error", site="wave",
                             times=2)]) as r_plan:
        s.run()
    assert plan.fired("wave_error") == r_plan.fired("wave_error") == 2
    stats = s.server.stats
    assert stats.failed_waves == 2 and stats.retried_waves == 1
    assert stats.degraded_rungs == 1 and stats.dropped_waves == 0
    assert s.session.current_P == s.r_session.current_P == 4
    assert [e["action"] for e in s.server.events] == \
        [e["action"] for e in s.r_server.events]
    s.check(*reqs, a, 4, b)

    # capacity returns, then the pattern drifts: a replan serves clean
    s.session.on_resize(8)
    s.r_session.on_resize(8)
    a_new = r_power_law(64, 64, 400, 1.2, seed=91)
    drift, swapped = s.session.maybe_replan(_port_csr(a_new))
    assert (drift, swapped) == s.r_session.maybe_replan(a_new)
    assert swapped and drift > s.session.config.drift_threshold
    reqs = s.submit([10, 11], b)
    s.run()
    s.check(*reqs, a_new, 8, b)
    assert s.server.stats.dropped_waves == 0
    assert s.server.stats.served == 5
