"""Batched serving of a MoE LM with SHIRO-planned expert dispatch, on the port.

    PYTHONPATH=src python examples/torch_moe_serve.py [--tokens 32] [--batch 8]
    PYTHONPATH=src python examples/torch_moe_serve.py --device cpu

The PyTorch counterpart of ``examples/moe_serve.py``, at its sizes:
prefills a batch of prompts, then decodes tokens step by step through
the expert-parallel MoE path on a (data 2, model 4) grid —
``DistContext(make_mesh((2, 4), ("data", "model")))``, its 8 ranks
emulated on one device, the all_to_alls on the model axis logged by the
grid's comm — with SHIRO's dedup + pre-aggregated combine. Reports
tokens/s and the dispatch-row savings vs the classic per-assignment
exchange, and checks the front door's dispatch SpMM against the dense
dispatch.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.context import DistContext
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.moe import (
    compile_dispatch, dispatch_matrix, moe_comm_rows,
)
from repro_torch.models.transformer import (
    decode_step, forward, init_decode_cache, init_params,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = args.device

    cfg = get_smoke_config("olmoe-1b-7b")
    cfg = dataclasses.replace(cfg, capacity_factor=4.0)
    mesh = make_mesh((2, 4), ("data", "model"))
    dist = DistContext(mesh=mesh, batch_axes=("data",), model_axis="model")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)

    classic, shiro = moe_comm_rows(cfg, tokens=args.batch * args.prompt_len,
                                   M=dist.model_size)
    print(f"model: {cfg.name} ({cfg.n_experts} experts, top-{cfg.top_k}); "
          f"mesh {dict(mesh.shape)}")
    print(f"SHIRO dispatch rows: {shiro} vs classic {classic} "
          f"(-{100 * (1 - shiro / classic):.1f}%)")

    # the dispatch exchange through the front door: the routing snapshot
    # becomes a sparse operand, and the handle's MWVC cover rediscovers
    # the (token, rank) dedup from the pattern alone
    T, M = args.batch * args.prompt_len, dist.model_size
    handle = compile_dispatch(cfg, tokens=T, M=M, device=dev)
    hs = handle.stats()
    print(f"dispatch handle: {handle}")
    print(f"  schedule={hs['schedule_kind']}/K={hs['schedule_K']};"
          f" cross-rank rows {hs['volume_rows']} "
          f"(padded {hs['volume_rows_padded_single']} -> "
          f"{hs['volume_rows_padded']})")
    x = np.random.default_rng(1).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        handle(x).cpu().numpy(), dispatch_matrix(cfg, T, M).to_dense() @ x,
        rtol=2e-4, atol=2e-4)
    print("  dispatch SpMM == dense dispatch  ✓")

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)

    # prefill: forward pass over the prompts (teacher-forced logits)
    logits = forward(params, cfg, dist, {"tokens": prompts})
    print(f"prefill OK: logits {tuple(logits.shape)}; model-axis activation "
          f"rows {dist.comm.rows('model')}")

    # decode loop: feed prompts token-by-token, then sample greedily
    cache = init_decode_cache(cfg, args.batch,
                              args.prompt_len + args.tokens + 1, device=dev)
    for i in range(args.prompt_len):
        lg, cache = decode_step(params, cfg, dist, prompts[:, i:i + 1], cache)
    tok = lg[:, -1:].argmax(-1)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        lg, cache = decode_step(params, cfg, dist, tok, cache)
        tok = lg[:, -1:].argmax(-1)
        out_tokens.append(tok)
    seq = torch.cat(out_tokens, 1).cpu().numpy()  # waits for the device
    dt = time.perf_counter() - t0
    total = args.tokens * args.batch
    print(f"decoded {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, 8 emulated ranks on {dev})")
    print(f"first sampled sequence: {seq[0][:16].tolist()} ...")
    assert seq.shape == (args.batch, args.tokens + 1)
    print("expert-parallel prefill and decode  ✓")


if __name__ == "__main__":
    main()
