"""``repro_torch.launch.hlo_analysis`` against ``repro.launch.hlo_analysis``.

* ``roofline`` with the reference's hardware constants equals the
  reference's on ``tests/test_gnn_hlo.py``'s inputs and two more; with
  the port's (H100 datasheet figures) the same inputs give the H100
  terms.
* ``collective_bytes`` reads the communicator's log: on the uniform and
  power-law P = 8 SpMM plans, single round and bucketed, coo and bsr, one
  call's per-rank bytes × P equal ``volume_rows_padded`` × N × itemsize,
  and ``collective_rows`` equals ``volume_rows_padded / P`` — the check
  the reference's HLO pin (``tests/test_comm_schedule.py::
  test_acceptance_powerlaw_p8_bytes_and_volumes``) makes, held through
  the log; the bucketed schedule moves at most half the single round's
  bytes on the power-law matrix, as that pin asks.
* A call under grad logs its backward with the forward's bytes.
* Every op name of the port's communicators maps onto an HLO kind.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro.launch import hlo_analysis as RH  # noqa: E402
from repro_torch.core import comm_schedule as t_sched  # noqa: E402
from repro_torch.core import dist_spmm as t_dist  # noqa: E402
from repro_torch.core import planner as t_plan  # noqa: E402
from repro_torch.core.sparse import (  # noqa: E402
    power_law_sparse, random_sparse,
)
from repro_torch.distributed.comm import LocalComm, MeshComm  # noqa: E402
from repro_torch.launch import hlo_analysis as TH  # noqa: E402

P, N = 8, 16
ROOF_CASES = [
    # tests/test_gnn_hlo.py:83-89's
    ({"flops": 197e12, "bytes accessed": 819e9}, {"total": 50e9}, 4,
     4 * 197e12),
    # compute-bound, no model flops
    ({"flops": 5e15, "bytes accessed": 1e11}, {"total": 1e9}, 256, None),
    # collective-bound, a partial useful-flops ratio
    ({"flops": 1e12, "bytes accessed": 2e10}, {"total": 4e11}, 8, 3e12),
]
MATRICES = {"uniform": lambda: random_sparse(64, 64, 0.05, 1),
            "powerlaw": lambda: power_law_sparse(64, 64, 400, 1.2, 2)}


@pytest.mark.parametrize("case", range(len(ROOF_CASES)))
def test_roofline_equals_the_reference_with_its_constants(case):
    cost, coll, chips, mf = ROOF_CASES[case]
    want = RH.roofline(cost, coll, chips=chips, model_flops=mf)
    got = TH.roofline(cost, coll, chips=chips, model_flops=mf, hw=RH.HW)
    assert {k: got[k] for k in want} == want
    assert got["collective_slow"] == coll["total"] / RH.HW["dcn_bw"]


@pytest.mark.parametrize("case", range(len(ROOF_CASES)))
def test_roofline_on_h100_datasheet_terms(case):
    cost, coll, chips, mf = ROOF_CASES[case]
    got = TH.roofline(cost, coll, chips=chips, model_flops=mf)
    assert TH.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                     "ici_bw": 450e9, "dcn_bw": 50e9}
    terms = {"compute": cost["flops"] / 989e12,
             "memory": cost["bytes accessed"] / 3.35e12,
             "collective": coll["total"] / 450e9}
    assert {k: got[k] for k in terms} == terms
    assert got["bottleneck"] == max(terms, key=terms.get)
    assert got["bound_time"] == max(terms.values())
    assert got["collective_slow"] == coll["total"] / 50e9
    if mf:
        assert got["roofline_fraction"] == \
            mf / (chips * 989e12) / got["bound_time"]


def _handle(name, K):
    a = MATRICES[name]()
    plan = t_plan.build_plan(a, P, "joint")
    sched = None if K is None else t_sched.build_comm_schedule(plan, K=K)
    return plan, sched, t_dist.flat_exec_arrays(plan, backends=("coo", "bsr"),
                                                schedule=sched)


@pytest.mark.parametrize("backend", ["coo", "bsr"])
@pytest.mark.parametrize("K", [None, 4])
@pytest.mark.parametrize("name", list(MATRICES))
def test_log_bytes_equal_volume_rows_padded(name, K, backend):
    plan, sched, ex = _handle(name, K)
    b = np.random.default_rng(0).standard_normal((64, N)).astype(np.float32)
    comm = LocalComm(P)
    t_dist.flat_spmm(ex, torch.from_numpy(b), comm, backend=backend)
    coll = TH.collective_bytes(comm)
    want = plan.volume_rows_padded(sched)
    assert coll["total"] * P == want * N * 4
    assert TH.collective_rows(coll, N) == want / P
    kind = "all-to-all" if K is None else "collective-permute"
    assert set(coll) == {kind, "total"}
    whole = TH.collective_bytes(comm, per_rank=False)
    assert whole["total"] == want * N * 4


def test_bucketed_moves_at_most_half_the_single_round():
    """The reference pin's bytes claim on the power-law matrix."""
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, N)).astype(np.float32))
    totals = {}
    for K in (None, 4):
        _, _, ex = _handle("powerlaw", K)
        comm = LocalComm(P)
        t_dist.flat_spmm(ex, b, comm, backend="coo")
        totals[K] = TH.collective_bytes(comm)["total"]
    assert totals[4] <= 0.5 * totals[None], totals


@pytest.mark.parametrize("K", [None, 4])
def test_train_call_logs_backward_bytes_equal_to_forward(K):
    _, _, ex = _handle("powerlaw", K)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (64, N)).astype(np.float32)).requires_grad_(True)
    comm = LocalComm(P)
    c = t_dist.flat_spmm(ex, b, comm, backend="coo")
    fwd = TH.collective_bytes(comm)["total"]
    (0.5 * (c * c).sum()).backward()
    both = TH.collective_bytes(comm)["total"]
    assert fwd > 0 and both == 2 * fwd
    bwd = sum(n for (op, _, _), n in zip(comm.log, comm.nbytes)
              if op.startswith("bwd:"))
    assert bwd * 1.0 / P == fwd


def test_every_op_name_has_a_kind_and_mesh_bytes_are_per_rank():
    names = ["all_to_all", "ppermute", "all_to_all@g", "ppermute@g",
             "psum_scatter@l", "all_gather@l", "broadcast@r", "ppermute@s",
             "psum_scatter@r", "all_to_all@model", "all_to_all@model:meta",
             "psum@model", "pmax@model"]
    kinds = [TH._kind(n) for n in names] + [TH._kind("bwd:psum@model")]
    assert set(kinds) == {"all-to-all", "collective-permute", "all-reduce",
                          "reduce-scatter", "all-gather"}
    with pytest.raises(ValueError, match="no HLO kind"):
        TH._kind("gossip")
    comm = MeshComm({"data": 2, "model": 4})
    x = torch.zeros((2, 4, 4, 3, 5), dtype=torch.bfloat16)
    comm.all_to_all(x, ("data", "model"), "model")
    # 2·4 ranks' operands of 4·3 rows of 5 bf16 each, per rank
    assert TH.collective_bytes(comm) == {"all-to-all": 4 * 3 * 5 * 2,
                                         "total": 4 * 3 * 5 * 2}
    assert TH.DTYPE_BYTES[torch.bfloat16] == 2
    assert TH.DTYPE_BYTES[torch.float32] == 4
