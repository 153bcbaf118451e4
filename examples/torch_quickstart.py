"""Quickstart: the SHIRO front door of the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The PyTorch counterpart of ``examples/quickstart.py``, at its sizes:
``repro_torch.compile_spmm`` plans communication (exact MWVC covers,
paper Eq. 9), picks the realization (flat vs hierarchical executor,
single vs bucketed schedule, local backend layouts) and returns a
prepared ``DistSpmm`` handle over 8 ranks emulated on one device;
``handle(b)`` reuses its memo per call shape. On the card the handle
runs the hand-written kernels (K1, K2, and K3 / K4 on the bsr backend);
``--device cpu`` runs their plain versions.
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import (
    DistSpmm, SpmmConfig, SpmmSession, compile_spmm, strategy_volumes,
)
from repro_torch.core.planner import plan_build_count
from repro_torch.core.sparse import hub_sparse, power_law_sparse


def _host(c) -> np.ndarray:
    return c.detach().cpu().numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = args.device
    P, N = 8, 32
    a = power_law_sparse(512, 512, 8192, 1.4, seed=0)
    b = np.random.default_rng(0).standard_normal((512, N)).astype(np.float32)

    vols = strategy_volumes(a, P, N)
    print("communication bytes by strategy (paper Eqs. 1-3, 9):")
    for k in ("block", "col", "row", "joint"):
        print(f"  {k:6s} {vols[k]:>12,}")
    print(f"  joint reduction vs best single: "
          f"{100 * (1 - vols['joint'] / min(vols['col'], vols['row'])):.1f}%")

    # one front door: plan + pick + prepare, then just call it
    handle = compile_spmm(a, P, SpmmConfig(backends=("coo", "bsr"),
                                           schedule="auto"), device=dev)
    out = handle(b)
    np.testing.assert_allclose(_host(out), a.to_dense() @ b,
                               rtol=2e-3, atol=2e-3)
    st = handle.stats()
    print(f"\n{handle}")
    print(f"picked: schedule={st['schedule_kind']}/K={st['schedule_K']}, "
          f"padded rows {st['volume_rows_padded_single']} -> "
          f"{st['volume_rows_padded']} (analytic {st['volume_rows']})")
    print("flat SpMM == dense reference  ✓")
    handle(b)  # same shape: served from the memo
    print(f"memo: {handle.cache_info()['lowerings']} entr(ies), "
          f"{handle.cache_info()['hits']} hit(s)")

    # hub-structured traffic + a two-tier network -> the model picks the
    # hierarchical executor (paper §6) by the α-β model
    ah = hub_sparse(512, 512, 4, 4, 0.35, seed=1)
    hh = compile_spmm(ah, P, SpmmConfig(hier="auto", schedule="auto"),
                      device=dev)
    out2 = hh(b)
    np.testing.assert_allclose(_host(out2), ah.to_dense() @ b,
                               rtol=2e-3, atol=2e-3)
    sh = hh.stats()
    print(f"\n{hh}")
    print(f"hub pattern: chose the {sh['strategy']} executor "
          f"(modeled flat {sh['modeled_time_flat'] * 1e6:.1f}us vs "
          f"hier {sh['modeled_time_hier'] * 1e6:.1f}us)")
    print("hierarchical SpMM == dense reference  ✓")

    # ship the preprocessed plan: serving fleets load it without MWVC
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "shiro_quickstart.plan")
        hh.save(path)
        loaded = DistSpmm.load(path, P, device=dev)
        assert np.array_equal(_host(loaded(b)), _host(out2))
    print("save -> load -> bit-identical C  ✓")

    # lifecycle: a session owns a P-ladder + the sparsity snapshot, so
    # fleet resizes pick a pre-planned rung (no MWVC) and pattern drift
    # triggers an off-path replan with a warm hot-swap
    sess = SpmmSession.build(a, P, SpmmConfig(schedule="auto"),
                             p_ladder=(4, 8), device=dev)
    n_plans = plan_build_count()
    sess.on_resize(4)  # lose half the fleet -> nearest rung
    assert plan_build_count() == n_plans  # pre-planned: no MWVC re-run
    np.testing.assert_allclose(_host(sess.handle()(b)), a.to_dense() @ b,
                               rtol=2e-3, atol=2e-3)
    a_drift = power_law_sparse(512, 512, 8192, 1.4, seed=3)
    drift, swapped = sess.maybe_replan(a_drift)
    assert swapped and np.allclose(_host(sess.handle()(b)),
                                   a_drift.to_dense() @ b, atol=2e-3)
    print(f"session: resize -> rung P=4 (0 new plans), "
          f"drift {drift:.2f} -> replan + hot-swap  ✓")


if __name__ == "__main__":
    main()
