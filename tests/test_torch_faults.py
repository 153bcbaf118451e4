"""The port's fault-injection harness against ``repro.robustness.faults``.

One ``REPRO_FAULTS`` plan drives both packages: the same sequence of
``take()`` calls fires the same faults, and ``to_env()`` writes the same
string. With no plan installed every hook returns its input (the same
object) and a guarded handle's C equals the unguarded executor's bit for
bit; ``nan_poison`` at ``operand`` is caught at build and at ``output``
raises ``NumericalFault``.
"""
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.robustness import faults as r_faults  # noqa: E402
from repro_torch import SpmmConfig, SpmmSession, compile_spmm  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.core.dist_spmm import flat_spmm  # noqa: E402
from repro_torch.robustness import faults  # noqa: E402
from repro_torch.robustness import (  # noqa: E402
    Fault, FaultPlan, InjectedFault, NumericalFault, inject,
)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for mod in (faults, r_faults):
        monkeypatch.delenv(mod.FAULTS_ENV, raising=False)
        monkeypatch.delenv(mod.EPOCH_ENV, raising=False)
        mod.uninstall()
    yield
    faults.uninstall()
    r_faults.uninstall()


def _port_csr(a):
    return t_sparse.CSRMatrix(tuple(a.shape), a.indptr.copy(),
                              a.indices.copy(), a.data.copy())


def _b(k=64, n=16, seed=0):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


# (fault dicts, epoch, the take() sequence as (kind, site, rank))
SEQUENCES = [
    ([dict(kind="wave_error", site="s", after=1, times=2)], 0,
     [("wave_error", "s", None)] * 5),
    ([dict(kind="worker_kill", site="stage:serve", rank=1)], 0,
     [("worker_kill", "stage:init", 1), ("worker_kill", "stage:serve", 0),
      ("worker_kill", "stage:serve", 1), ("worker_kill", "stage:serve", 1)]),
    ([dict(kind="wave_error")], 0, [("wave_error", "anything", None)] * 2),
    ([dict(kind="wave_error", epoch=1)], 0, [("wave_error", "x", None)] * 3),
    ([dict(kind="wave_error", epoch=1, times=2)], 1,
     [("wave_error", "x", 0)] * 3),
    ([dict(kind="nan_poison", site="output", times=2),
      dict(kind="nan_poison", site="operand"),
      dict(kind="autotune_corrupt", site="autotune_cache", mode="empty"),
      dict(kind="torn_checkpoint", site="atomic_dir", file="rung")], 0,
     [("nan_poison", "operand", None), ("nan_poison", "output", None),
      ("autotune_corrupt", "autotune_cache", None),
      ("nan_poison", "output", None), ("nan_poison", "output", None),
      ("torn_checkpoint", "atomic_dir", None),
      ("nan_poison", "operand", None), ("collective_delay", "wave", None)]),
]


@pytest.mark.parametrize("spec,epoch,calls", SEQUENCES,
                         ids=[f"seq{i}" for i in range(len(SEQUENCES))])
def test_take_sequence_fires_as_the_reference(spec, epoch, calls):
    ours = FaultPlan([dict(f) for f in spec], epoch=epoch)
    ref = r_faults.FaultPlan([dict(f) for f in spec], epoch=epoch)
    got = [ours.take(*c) is not None for c in calls]
    want = [ref.take(*c) is not None for c in calls]
    assert got == want
    assert [(f.seen, f.hits) for f in ours.faults] == \
        [(f.seen, f.hits) for f in ref.faults]
    for kind in faults.FAULT_KINDS:
        assert ours.fired(kind) == ref.fired(kind)
    assert ours.to_env() == ref.to_env()


def test_window_and_matching():
    plan = FaultPlan([Fault(kind="wave_error", site="s", after=1, times=2)])
    assert [plan.take("wave_error", "s") is not None for _ in range(5)] == \
        [False, True, True, False, False]
    assert plan.fired("wave_error") == 2
    kill = FaultPlan([Fault(kind="worker_kill", site="stage:serve", rank=1)])
    assert kill.take("worker_kill", "stage:init", 1) is None
    assert kill.take("worker_kill", "stage:serve", 0) is None
    assert kill.take("worker_kill", "stage:serve", 1) is not None
    assert FaultPlan([Fault(kind="wave_error", epoch=1)]).take(
        "wave_error", "x") is None


@pytest.mark.parametrize("kw,match", [
    (dict(kind="meteor_strike"), "unknown fault kind"),
    (dict(kind="wave_error", times=0), "times >= 1"),
    (dict(kind="wave_error", after=-1), "times >= 1"),
    (dict(kind="autotune_corrupt", mode="subtle"), "corruption mode"),
])
def test_fault_validation_as_the_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        Fault(**kw)
    with pytest.raises(ValueError, match=match):
        r_faults.Fault(**kw)


def test_env_roundtrip_and_one_plan_for_both(tmp_path):
    plan = FaultPlan([Fault(kind="wave_error", site="wave", times=3),
                      Fault(kind="worker_kill", rank=1, epoch=2)])
    spec = plan.to_env()
    assert spec == r_faults.FaultPlan(
        [r_faults.Fault(kind="wave_error", site="wave", times=3),
         r_faults.Fault(kind="worker_kill", rank=1, epoch=2)]).to_env()
    back = FaultPlan.from_env({faults.FAULTS_ENV: spec})
    assert [f.to_dict() for f in back.faults] == \
        [f.to_dict() for f in plan.faults]
    ref = r_faults.FaultPlan.from_env({r_faults.FAULTS_ENV: spec})
    assert [f.to_dict() for f in ref.faults] == \
        [f.to_dict() for f in back.faults]
    p = tmp_path / "plan.json"
    p.write_text(spec)
    env = {faults.FAULTS_ENV: f"@{p}", faults.EPOCH_ENV: "2"}
    back2 = FaultPlan.from_env(env)
    assert back2.epoch == 2 == r_faults.FaultPlan.from_env(env).epoch
    assert back2.take("worker_kill", "stage:init", 1) is not None
    assert FaultPlan.from_env({}) is None
    assert FaultPlan.from_env({faults.FAULTS_ENV: '{"kind": "wave_error"}'}
                              ).faults[0].kind == "wave_error"
    with pytest.raises(ValueError, match="not valid JSON"):
        FaultPlan.from_env({faults.FAULTS_ENV: "{nope"})
    assert (faults.FAULTS_ENV, faults.EPOCH_ENV, faults.KILL_EXIT_CODE) == \
        (r_faults.FAULTS_ENV, r_faults.EPOCH_ENV, r_faults.KILL_EXIT_CODE)


def test_env_activation_and_inject_restore(monkeypatch):
    monkeypatch.setenv(faults.FAULTS_ENV,
                       '[{"kind": "wave_error", "site": "wave"}]')
    faults.uninstall()  # force a re-read of the env
    env_plan = faults.active_plan()
    assert env_plan is not None and env_plan.faults[0].kind == "wave_error"
    with inject([Fault(kind="collective_delay", delay=0.0)]) as plan:
        assert faults.active_plan() is plan
        assert faults.maybe_delay("wave") == 0.0
        assert plan.fired("collective_delay") == 1
    assert faults.active_plan() is env_plan  # restored
    with pytest.raises(InjectedFault, match="wave_error at 'wave'"):
        faults.maybe_error("wave")
    faults.install(None)
    assert faults.active_plan() is None  # an explicit install wins


def test_every_hook_is_a_no_op_without_a_plan(tmp_path, power_law_matrix):
    assert faults.active_plan() is None
    t = torch.randn(4, 3)
    arr = np.ones((2, 2), np.float32)
    a = _port_csr(power_law_matrix())
    assert faults.maybe_poison_array(t) is t
    assert faults.maybe_poison_array(arr, site="operand") is arr
    assert faults.maybe_poison_values(a) is a
    assert faults.fire("wave_error", "wave") is None
    assert faults.maybe_kill("stage:init", 0) is None
    assert faults.maybe_delay("wave") == 0.0
    assert faults.maybe_error("wave") is None
    f = tmp_path / "entry.json"
    f.write_text("{}")
    assert faults.maybe_corrupt_file("autotune_corrupt", "autotune_cache",
                                     str(f)) is False
    assert f.read_text() == "{}"
    (tmp_path / "stage").mkdir()
    (tmp_path / "stage" / "x.bin").write_bytes(b"abcd")
    assert faults.maybe_tear_dir("atomic_dir", str(tmp_path / "stage")) \
        is None
    assert (tmp_path / "stage" / "x.bin").read_bytes() == b"abcd"


def test_poison_array_returns_a_poisoned_clone():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    with inject([Fault(kind="nan_poison", site="output")]) as plan:
        out = faults.maybe_poison_array(t, site="output")
        assert faults.maybe_poison_array(t, site="output") is t  # times=1
    assert plan.fired("nan_poison") == 1
    assert out is not t and torch.isnan(out[0, 0])
    assert torch.equal(out[0, 1:], t[0, 1:]) and torch.equal(out[1], t[1])
    assert not torch.isnan(t).any()  # the caller's tensor is untouched


def test_nan_poison_operand_caught_at_build(power_law_matrix):
    a = _port_csr(power_law_matrix())
    with inject([Fault(kind="nan_poison", site="operand")]) as plan:
        with pytest.raises(NumericalFault, match="non-finite"):
            SpmmSession.build(a, 4, SpmmConfig(schedule="auto"),
                              device="cpu")
    assert plan.fired("nan_poison") == 1
    assert np.isfinite(a.data).all()  # the poison hit a copy
    # check=False is the documented footgun: NaN reaches C
    with inject([Fault(kind="nan_poison", site="operand")]):
        h = compile_spmm(a, 4, SpmmConfig(schedule="auto", check=False),
                         device="cpu")
    assert torch.isnan(h(_b())).any()


def test_nan_poison_output_raises_numerical_fault(power_law_matrix):
    a = _port_csr(power_law_matrix())
    h = compile_spmm(a, 4, SpmmConfig(schedule="auto"), device="cpu")
    b = _b()
    assert torch.equal(h(b), h(b))  # healthy first
    with inject([Fault(kind="nan_poison", site="output")]):
        with pytest.raises(NumericalFault, match=r"C\[0, 0\]"):
            h(b)
    stats = h.stats()
    assert stats["numerical_faults"] == 1 and stats["check"] == "auto"
    unchecked = compile_spmm(a, 4, SpmmConfig(schedule="auto", check=False),
                             device="cpu")
    with inject([Fault(kind="nan_poison", site="output")]):
        assert torch.isnan(unchecked(b)[0, 0])
    # the sibling kernels' outputs carry the same hook
    hs = compile_spmm(a, 4, SpmmConfig(kernel="sddmm"), device="cpu")
    with inject([Fault(kind="nan_poison", site="output")]):
        with pytest.raises(NumericalFault, match="non-finite"):
            hs(_b(seed=1), _b(seed=2))


@pytest.mark.parametrize("cfg", [dict(schedule="auto"),
                                 dict(schedule=2, overlap=True),
                                 dict(hier=(2, 2), schedule="single")],
                         ids=["auto", "k2-overlap", "hier"])
def test_no_plan_check_off_is_bit_identical(power_law_matrix, cfg):
    """With no plan the guards observe, never perturb: check="auto" C,
    check=False C and the bare executor's C carry the same bits."""
    a = _port_csr(power_law_matrix())
    b = _b(seed=4)
    checked = compile_spmm(a, 4, SpmmConfig(**cfg), device="cpu")
    unchecked = compile_spmm(a, 4, SpmmConfig(check=False, **cfg),
                             device="cpu")
    c = checked(b)
    assert torch.equal(c, unchecked(b))
    if checked.hier is None:
        bare = flat_spmm(checked.ex, torch.from_numpy(b),
                         overlap=checked.overlap)
        assert torch.equal(c, bare)


def test_poison_values_copies_the_operand(power_law_matrix):
    a = _port_csr(power_law_matrix())
    with inject([Fault(kind="nan_poison", site="operand")]):
        poisoned = faults.maybe_poison_values(a)
    assert np.isnan(poisoned.data[0]) and np.isfinite(a.data).all()
    empty = t_sparse.CSRMatrix((4, 4), np.zeros(5, np.int32),
                               np.zeros(0, np.int32),
                               np.zeros(0, np.float32))
    with inject([Fault(kind="nan_poison", site="operand")]):
        assert faults.maybe_poison_values(empty) is empty


def test_corrupt_modes_match_the_reference(tmp_path):
    for mode in ("empty", "truncate", "garbage"):
        ours, ref = tmp_path / f"o-{mode}", tmp_path / f"r-{mode}"
        for f in (ours, ref):
            f.write_bytes(bytes(range(200)))
        faults.corrupt_file(str(ours), mode)
        r_faults.corrupt_file(str(ref), mode)
        assert ours.read_bytes() == ref.read_bytes()
        assert os.path.getsize(ours) < 200 or mode == "garbage"
