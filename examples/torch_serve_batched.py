"""Batched request serving through the wave scheduler, on the port.

    PYTHONPATH=src python examples/torch_serve_batched.py [--requests 12]
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu

The PyTorch counterpart of ``examples/serve_batched.py``, at its sizes:
streams a queue of prompts with varying token budgets through
``ContinuousBatcher`` (slot-packed waves over the port's decode step;
every RMSNorm is K6 on the card) and reports throughput + slot
occupancy. Then the SHIRO plan-shipping path for fleet serving:
``compile_spmm`` once, ``save`` the preprocessed plan, ``DistSpmm.load``
it in each replica (no MWVC re-run) and serve a shape-varying request
stream off the handle's memo; and wave serving across a drift replan.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import init_params
from repro_torch.serving.scheduler import ContinuousBatcher, Request


def _sync(dev: str) -> None:
    if dev.startswith("cuda"):
        torch.cuda.synchronize()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = args.device

    cfg = get_smoke_config("qwen2-1.5b")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    batcher = ContinuousBatcher(cfg, params, max_batch=args.slots,
                                max_len=64)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        batcher.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size,
                                rng.integers(3, 9)).astype(np.int32),
            max_new_tokens=int(rng.integers(2, args.max_new + 1))))

    t0 = time.perf_counter()
    stats = batcher.run()
    dt = time.perf_counter() - t0
    print(f"served {stats.served} requests, {stats.generated_tokens} tokens "
          f"in {dt:.2f}s ({stats.generated_tokens / dt:.1f} tok/s)")
    print(f"decode steps: {stats.decode_steps}; "
          f"mean slot occupancy {stats.mean_occupancy:.2f}")
    assert stats.served == args.requests
    print("every request served  ✓")

    serve_spmm_fleet(args.requests, dev)


def serve_spmm_fleet(n_requests: int, dev: str) -> None:
    """Plan once, ship the plan, serve many shapes from the memo."""
    from repro_torch.core import DistSpmm, SpmmConfig, compile_spmm
    from repro_torch.core.sparse import power_law_sparse

    a = power_law_sparse(512, 512, 8192, 1.4, seed=0)
    t0 = time.perf_counter()
    handle = compile_spmm(a, 8, SpmmConfig(schedule="auto"), device=dev)
    plan_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plan.shiro")
        handle.save(path)
        t0 = time.perf_counter()
        replica = DistSpmm.load(path, 8, device=dev)  # each serving process
        load_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    shapes = [16 if i % 2 else 32 for i in range(max(n_requests, 4))]
    t0 = time.perf_counter()
    for n_cols in shapes:
        b = rng.standard_normal((512, n_cols)).astype(np.float32)
        replica(b)
    _sync(dev)
    dt = time.perf_counter() - t0
    ci = replica.cache_info()
    print(f"\nSHIRO spmm fleet path: plan {plan_s:.2f}s once, replica load "
          f"{load_s:.2f}s (no MWVC)")
    print(f"served {len(shapes)} spmm requests in {dt:.2f}s: "
          f"{ci['lowerings']} memo entries for {len(set(shapes))} shapes, "
          f"{ci['hits']} hits")
    assert ci["lowerings"] == len(set(shapes))
    print("plan shipped, replica served from its memo  ✓")

    serve_spmm_hot_swap(dev)


def serve_spmm_hot_swap(dev: str) -> None:
    """Wave serving across a drift replan: zero dropped waves."""
    from repro_torch.core import SpmmConfig, SpmmSession
    from repro_torch.core.sparse import power_law_sparse
    from repro_torch.serving.scheduler import SpmmRequest, SpmmWaveServer

    a = power_law_sparse(256, 256, 4096, 1.4, seed=0)
    session = SpmmSession.build(a, 8, SpmmConfig(schedule="auto"),
                                device=dev)
    server = SpmmWaveServer(session, max_batch=4)
    rng = np.random.default_rng(2)

    b0 = rng.standard_normal((256, 16)).astype(np.float32)
    for rid in range(4):
        server.submit(SpmmRequest(rid=rid, b=b0))
    server.run()

    # the pattern drifts mid-stream; the replan + warm swap happens off
    # the wave path, the next wave serves the new plan
    a2 = power_law_sparse(256, 256, 4096, 1.4, seed=5)
    drift, swapped = session.maybe_replan(a2)
    reqs = [SpmmRequest(rid=rid, b=b0) for rid in range(4, 8)]
    for r in reqs:
        server.submit(r)
    stats = server.run()
    print(f"\nhot-swap serving: drift {drift:.2f} -> replan; "
          f"{stats.served} served over {stats.waves} waves, "
          f"{stats.swaps} swap(s), {stats.dropped_waves} dropped")
    assert stats.dropped_waves == 0
    np.testing.assert_allclose(reqs[-1].output.cpu().numpy(),
                               a2.to_dense() @ b0, rtol=2e-4, atol=2e-4)
    print("waves served across the swap, none dropped  ✓")


if __name__ == "__main__":
    main()
