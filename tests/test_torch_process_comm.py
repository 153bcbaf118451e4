"""SHIRO across two real processes on the CPU: ``ProcessComm`` and the
executors on a rank span.

One module-scoped fleet (``launch_local(2, 4, device="cpu")``, gloo, a
deadline on every wait) runs ``tests/_torch_mp_worker.py`` in each
process; the tests read what the processes wrote. Each ``ProcessComm``
collective equals ``LocalComm``'s on the stacked tensor bit for bit, and
the processes' rows sum to LocalComm's. Every executor body (single,
bucketed staged, bucketed overlapped) on the flat tier, the two-tier one
at ``hier="auto"`` (the fleet's (2, 4)) and at an explicit (4, 2), and
the replicated tier (c = 2), on a 1024-node power-law and a uniform
matrix, on coo and bsr: each process's C rows ``torch.equal`` to the
same rows of the emulated run of the same plan on ``Topology.local(8)``,
rows per axis summed over the processes equal to the emulated log's, a
slab operand passing through; the same C within 2e-4 of
``repro.compile_spmm`` on 8 host devices with the same ``NetworkSpec``,
and the decisions equal to the reference's. One flat SDDMM and one hier
FusedMM equal the emulated ones.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import _torch_mp_worker as W  # noqa: E402

FLEET_TIMEOUT = 300.0

COLLECTIVES = (
    ["all_to_all", "ppermute_partial", "shift3"]
    + [f"{op}_G{G}" for G in (2, 4)
       for op in ("group_all_to_all", "group_shift", "local_all_gather")]
    + [f"local_psum_scatter_G{G}_dim{d}" for G in (2, 4) for d in (1, 0)]
    + [f"{op}_c{C}" for C in (2, 4)
       for op in ("replicate", "lane_shift", "replica_psum_scatter")]
    + [f"lane_shift_c{C}_lane1" for C in (2, 4)])
EXEC = [(m, tier, body, be) for m, tier, body in W.exec_cases()
        for be in W.BACKENDS]
# the tier whose collectives carry the plan's volume, by LocalComm axis
VOLUME_AXIS = {"flat": "None", "hier_auto": "g", "hier42": "g",
               "repl2": "s"}


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    from repro_torch.launch.multiprocess import launch_local

    out = tmp_path_factory.mktemp("fleet")
    rc = launch_local(2, 4, timeout=FLEET_TIMEOUT, device="cpu",
                      argv=[sys.executable, str(HERE / "_torch_mp_worker.py"),
                            str(out)])
    assert rc == 0, f"the fleet failed (exit {rc})"
    res = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    rows = [dict(np.load(out / f"rank{r}.npz")) for r in (0, 1)]
    return res, rows


def test_fleet_topology(fleet):
    res, _ = fleet
    assert [r["span"] for r in res] == [[0, 4], [4, 8]]
    for r in res:
        assert r["topology"] == {"kind": "multiprocess", "P": 8,
                                 "tiers": [2, 4], "n_hosts": 2,
                                 "platform": "cpu"}
        assert r["network"] == "derived-cpu-2x4"
        assert r["auto_grouping"] == [2, 4]
        assert r["narrow4"] == {
            "spans": [[0, 4], [4, 4]],
            "describe": {"kind": "multiprocess", "P": 4, "tiers": None,
                         "n_hosts": 2, "platform": "cpu"}}
        assert r["fused_tier"] == ["hier", 2, 4]


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_equals_localcomm(fleet, name):
    res, _ = fleet
    for r in res:
        got = r["comm"][name]
        assert got["equal"], f"rank span {r['span']}: {name} != LocalComm"
        assert got["fleet_rows"] == got["local_rows"] > 0
    # the processes agree on the fleet's sums
    assert res[0]["comm"][name] == {**res[1]["comm"][name],
                                    "equal": res[0]["comm"][name]["equal"]}


@pytest.mark.parametrize("m,tier,body,be", EXEC,
                         ids=["-".join(c) for c in EXEC])
def test_executor_equals_emulated(fleet, m, tier, body, be):
    res, _ = fleet
    name = W.case_name(m, tier, body, be)
    for r in res:
        got = r["exec"][name]
        assert got["equal"], f"{name}: span {r['span']} C != emulated"
        assert got["slab_equal"], f"{name}: a slab operand changed C"
        for axis, (fleet_rows, local_rows) in got["rows"].items():
            assert fleet_rows == local_rows, f"{name} axis {axis}"
        assert got["rows"][VOLUME_AXIS[tier]][0] == got["volume_rows_padded"]
        assert got["transport"]["staged_bytes"] == 0  # CPU: no staging
        assert got["transport"]["exchanges"] >= 1
    got = res[0]["exec"][name]
    if tier != "repl2":  # the plan's padded slow-tier rows, as sent
        assert got["crossing"] == got["plan_crossing"] > 0
    if tier == "hier_auto" and body != "single":
        # G = processes: every group shift leaves the process
        assert got["crossing"] == got["crossing_g"] \
            == got["volume_rows_padded"]
    if tier == "hier_auto":
        d = res[0]["decisions"][W.case_name(m, tier, body)]
        assert (d["strategy"], d["G"], d["L"]) == ("hier", 2, 4)
    if tier == "flat":
        assert got["crossing_g"] == 0 < got["crossing"] \
            < got["volume_rows_padded"]


@pytest.mark.parametrize("name", [f"{k}-{be}" for k in ("sddmm-flat",
                                                         "fused-hier_auto")
                                  for be in W.BACKENDS])
def test_sddmm_fused_equal_emulated(fleet, name):
    res, _ = fleet
    for r in res:
        assert r["exec"][name]["equal"], f"span {r['span']}: {name}"


def _reference_config(tier, body):
    from repro.core.api import SpmmConfig
    from repro.core.comm_model import NetworkSpec

    fields = dict(W.TIERS[tier], backends=("coo",),
                  net=NetworkSpec("derived-cpu-2x4", 50e9, 10e9,
                                  group_size=4))
    if tier != "repl2":
        fields.update(W.BODIES[body])
    return SpmmConfig(**fields)


@pytest.mark.parametrize("m,tier,body", W.exec_cases(),
                         ids=["-".join(c) for c in W.exec_cases()])
def test_decisions_match_reference(fleet, m, tier, body):
    pytest.importorskip("jax")
    from repro.core.api import compile_spmm
    from repro.core.sparse import power_law_sparse, random_sparse

    a = {"powerlaw": lambda: power_law_sparse(1024, 1024, 8192, 1.2, 2),
         "uniform": lambda: random_sparse(1024, 1024, 0.008, 1)}[m]()
    port = W.MATRICES[m]()
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(port, f), getattr(a, f))
    st = compile_spmm(a, 8, _reference_config(tier, body)).stats()
    res, _ = fleet
    want = {k: st.get(k) for k in W.DECISION_KEYS}
    if want["hier_candidate"] is not None:
        want["hier_candidate"] = list(want["hier_candidate"])
    for r in res:
        assert r["decisions"][W.case_name(m, tier, body)] == want


@pytest.mark.parametrize("m,tier", [(m, t) for m in W.MATRICES
                                    for t in W.TIERS])
def test_c_matches_jax(fleet, m, tier):
    pytest.importorskip("jax")
    from repro.core.api import compile_spmm
    from repro.core.sparse import power_law_sparse, random_sparse

    a = {"powerlaw": lambda: power_law_sparse(1024, 1024, 8192, 1.2, 2),
         "uniform": lambda: random_sparse(1024, 1024, 0.008, 1)}[m]()
    b = W._gen(20, (1024, W.N_COLS))
    c_ref = np.asarray(compile_spmm(a, 8, _reference_config(tier, "staged"))(b))
    res, rows = fleet
    name = W.case_name(m, tier, "staged")
    for r, got in zip(res, rows):
        want = np.concatenate([c_ref[s:e] for s, e in r["blocks"][name]])
        for be in W.BACKENDS:
            np.testing.assert_allclose(got[f"{name}-{be}"], want, rtol=2e-4,
                                       atol=2e-4, err_msg=f"{name}-{be}")
