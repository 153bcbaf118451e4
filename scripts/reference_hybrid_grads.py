"""zamba2-2.7b's first-step gradients in float32 and bfloat16 against
float64, on the CPU, in the JAX package (the reference) and in the port,
from the same weights and tokens: how far float32 itself sits from
float64 on the hybrid model, the reading behind the norm-wise hold of
``chip_smoke.py``'s zamba2 train check (``FAMILY_TRAIN_F32``).

The model is zamba2's first ``--layers`` layers (12: two groups of
``attn_every`` 6, the shared block applied twice), its widths scaled by
``--width`` (d_model, heads, d_ff and SSM heads; the head sizes, the
state, the 128-token scan chunk and the vocabulary stay as published),
with the reference's ``init_params`` weights drawn in bfloat16 as the
card's model holds them. The tokens are ``SyntheticLM(vocab, --seq,
--batch, seed=0).batch(0)``, the train check's. Runs:

* ``ref32``, ``ref16``: the reference's ``jax.value_and_grad(lm_loss)``
  under ``jax.jit`` (as its train step runs it), with the model in
  float32, and in bfloat16 (the control);
* ``ref32e``: the reference in float32 op by op, as the port runs: no
  ``jax.jit`` and ``scan_layers=False`` (a ``lax.scan`` over the layers
  compiles its body as one program, which rounds differently);
* ``port32``, ``port16``, ``port64``: the port's ``loss_and_grads`` on
  the CPU (the kernels' plain versions), in float32, bfloat16 and
  float64.

The reference has no float64 run: its SSM scan mixes a float32 state
with float64 operands and ``lax.associative_scan`` refuses them, so
every run is read against ``port64``, the one oracle. It is not
float64 throughout either: the port keeps the reference's float32 steps
whatever the model's dtype (the loss's log-softmax, attention's softmax,
RoPE). For each pair it prints the worst leaves' ||g - g64|| / ||g64||
and their element-wise error over rtol 2e-3 / atol 2e-4 (max |g - g64|
/ (2e-4 + 2e-3 |g64|)), the shared block's worst, and with ``--json``
every leaf's; ``port32 vs ref32e`` holds two float32 runs against each
other the same way.

A forward probe (no gradient) then reads the logits' ||l - l64|| /
||l64|| of: both reference float32 runs; the port's float32; the port's
float32 with its SSM scan and state in float64 (``_state_dtype``); and
the port's float32 with only the B / C projection ``x @ bc_proj`` in
float64 — which of its float32 roundings the model amplifies. Run from
the repo root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_hybrid_grads.py \\
        [--layers 12] [--width 0.25] [--batch 2] [--seq 128] [--json PATH]

At ``--width 0.25``, 12 layers and 2 × 128 tokens it holds 6.4 GB of
host memory and takes about 5 minutes.
"""
import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import _leaves
from repro_torch.train.steps import loss_and_grads

ARCH = "zamba2-2.7b"
RTOL, ATOL = 2e-3, 2e-4


def _names(tree, prefix=""):
    """Leaf names in sorted-key order (jax's and ``_leaves``')."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1]


def scaled(cfg, layers: int, width: float):
    """The config cut to ``layers`` and its widths scaled by ``width``."""
    return dataclasses.replace(
        cfg, n_layers=layers, d_model=int(cfg.d_model * width),
        n_heads=int(cfg.n_heads * width), n_kv_heads=int(cfg.n_kv_heads
                                                         * width),
        d_ff=int(cfg.d_ff * width), ssm_heads=int(cfg.ssm_heads * width))


def errors(got: dict, want: dict) -> list:
    """Per leaf (norm-wise, element-wise over RTOL / ATOL, name), in
    ``got``'s order; both {name: float64 array}."""
    out = []
    for name, g in got.items():
        w = want[name]
        out.append((float(np.linalg.norm(g - w) / np.linalg.norm(w)),
                    float((np.abs(g - w) / (ATOL + RTOL * np.abs(w))).max()),
                    name))
    return out


def summary(rows: list) -> dict:
    """The worst leaves by each measure and the shared block's worst."""
    by_norm = sorted(rows, reverse=True)
    by_elem = sorted(rows, key=lambda r: -r[1])
    shared = [r for r in rows if r[2].startswith("shared_attn/")]
    return {
        "worst_norm": [(n, f"{a:.3g}", f"{e:.3g}") for a, e, n in by_norm[:3]],
        "worst_elem": [(n, f"{a:.3g}", f"{e:.3g}") for a, e, n in by_elem[:3]],
        "max_norm": by_norm[0][0], "max_elem": by_elem[0][1],
        "shared_max_norm": max(r[0] for r in shared),
        "shared_max_elem": max(r[1] for r in shared),
        "leaves_over_2e-3_norm": int(sum(r[0] > RTOL for r in rows)),
        "leaves_over_1_elem": int(sum(r[1] > 1 for r in rows)),
        "leaves": len(rows)}


def probe(rcfg, tcfg, np16, tokens, port_params) -> dict:
    """The forward logits' ||l - l64|| / ||l64|| of the float32 runs
    against the port's float64, with one piece of the port's float32 at
    a time in float64 (see the module's docstring)."""
    from repro_torch.models import ssm as TS

    batch = {"tokens": torch.from_numpy(tokens)}

    def port(dtype):
        with torch.no_grad():
            return TT.forward(port_params(dtype), dataclasses.replace(
                tcfg, dtype=dtype), None, batch).double().numpy()

    def ref(compiled: bool):
        cfg = dataclasses.replace(rcfg, dtype="float32",
                                  scan_layers=compiled)
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                   np16)
        fn = lambda p, t: RT.forward(p, cfg, None, {"tokens": t})  # noqa
        return np.asarray((jax.jit(fn) if compiled else fn)(
            p, jnp.asarray(tokens)), np.float64)

    want = port("float64")
    got = {"ref32 (jit, lax.scan over layers)": ref(True),
           "ref32e (op by op)": ref(False), "port32": port("float32")}
    state_dtype = TS._state_dtype
    TS._state_dtype = lambda dtype: torch.float64
    try:
        got["port32, SSM scan and state in float64"] = port("float32")
    finally:
        TS._state_dtype = state_dtype
    p32 = port_params("float32")
    bc = {w.data_ptr() for w in p32["layers"]["ssm"]["bc_proj"].unbind(0)}
    matmul = torch.Tensor.__matmul__

    def bc_in_64(a, b):
        if b.data_ptr() in bc and a.dtype == torch.float32:
            return matmul(a.double(), b.double()).float()
        return matmul(a, b)

    torch.Tensor.__matmul__ = bc_in_64
    try:
        with torch.no_grad():
            got["port32, x @ bc_proj in float64"] = TT.forward(
                p32, dataclasses.replace(tcfg, dtype="float32"), None,
                batch).double().numpy()
    finally:
        torch.Tensor.__matmul__ = matmul
    out = {k: float(np.linalg.norm(v - want) / np.linalg.norm(want))
           for k, v in got.items()}
    for k, v in out.items():
        print(f"forward logits, {k} vs port64: {v:.3g}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args()
    t0 = time.perf_counter()
    rcfg = scaled(ref_config(ARCH), args.layers, args.width)
    tcfg = scaled(get_config(ARCH), args.layers, args.width)
    params16 = RT.init_params(jax.random.PRNGKey(0), rcfg)  # bfloat16
    np16 = jax.tree_util.tree_map(np.asarray, params16)
    tokens = SyntheticLM(rcfg.vocab_size, args.seq, args.batch,
                         seed=0).batch(0)["tokens"]
    print(f"{rcfg.name}: {args.layers} layers, width x{args.width} "
          f"(d_model {rcfg.d_model}, heads {rcfg.n_heads}, d_ff "
          f"{rcfg.d_ff}, ssm_heads {rcfg.ssm_heads}, state "
          f"{rcfg.ssm_state}, chunk {rcfg.ssm_chunk}, vocab "
          f"{rcfg.vocab_size}), {sum(a.size for a in jax.tree_util.tree_leaves(np16)):,}"
          f" parameters; tokens {tokens.shape}", flush=True)

    def ref_run(dtype: str):
        cfg = dataclasses.replace(rcfg, dtype=dtype)
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), np16)
        loss, g = jax.jit(jax.value_and_grad(
            lambda p, t: RT.lm_loss(p, cfg, None, {"tokens": t})))(
                p, jnp.asarray(tokens))
        names = list(_names(g))
        return float(loss), {n: np.asarray(a, np.float64) for n, a in zip(
            names, jax.tree_util.tree_leaves(g))}

    def ref_eager(dtype: str):
        cfg = dataclasses.replace(rcfg, dtype=dtype, scan_layers=False)
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), np16)
        loss, g = jax.value_and_grad(
            lambda p, t: RT.lm_loss(p, cfg, None, {"tokens": t}))(
                p, jnp.asarray(tokens))
        return float(loss), {n: np.asarray(a, np.float64) for n, a in zip(
            _names(g), jax.tree_util.tree_leaves(g))}

    def port_params(dtype: str):
        p = TT.transformer_from_numpy(np16, tcfg, device="cpu")
        return TT._tree_map(lambda t: t.to(getattr(torch, dtype)), p)

    def port_run(dtype: str):
        cfg = dataclasses.replace(tcfg, dtype=dtype)
        loss, g = loss_and_grads(port_params(dtype), cfg, None,
                                 {"tokens": torch.from_numpy(tokens)})
        return float(loss), {n: t.double().numpy() for n, t in zip(
            _names(g), _leaves(g))}

    runs = {}
    for tag, fn, dtype in (("ref32", ref_run, "float32"),
                           ("ref32e", ref_eager, "float32"),
                           ("ref16", ref_run, "bfloat16"),
                           ("port32", port_run, "float32"),
                           ("port16", port_run, "bfloat16"),
                           ("port64", port_run, "float64")):
        t1 = time.perf_counter()
        runs[tag] = fn(dtype)
        print(f"{tag}: loss {runs[tag][0]:.8f} "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)

    out = {"config": dict(arch=ARCH, layers=args.layers, width=args.width,
                          batch=args.batch, seq=args.seq,
                          d_model=rcfg.d_model),
           "loss": {k: v[0] for k, v in runs.items()}, "pairs": {}}
    for got, want in (("ref32", "port64"), ("ref32e", "port64"),
                      ("port32", "port64"), ("port32", "ref32e"),
                      ("ref16", "port64"), ("port16", "port64")):
        rows = errors(runs[got][1], runs[want][1])
        s = summary(rows)
        out["pairs"][f"{got} vs {want}"] = dict(
            s, per_leaf={n: [a, e] for a, e, n in rows})
        print(f"{got} vs {want}: max ||g - g64|| / ||g64|| "
              f"{s['max_norm']:.3g} ({s['leaves_over_2e-3_norm']} of "
              f"{s['leaves']} leaves over 2e-3), max element-wise "
              f"{s['max_elem']:.3g} ({s['leaves_over_1_elem']} leaves over 1)"
              f"; shared_attn {s['shared_max_norm']:.3g} / "
              f"{s['shared_max_elem']:.3g}; worst norm-wise "
              f"{s['worst_norm']}; worst element-wise {s['worst_elem']}",
              flush=True)
    out["forward_probe"] = probe(rcfg, tcfg, np16, tokens, port_params)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
