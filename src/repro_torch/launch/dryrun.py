"""Dry run: each (arch × shape × mesh) cell's step traced on the meta device.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell for 256 or 512 placeholder host devices and reads XLA's memory and
cost analyses and the compiled HLO's collectives. The port has no XLA:
it runs the cell's step on ``meta`` tensors (shapes only: nothing is
drawn, allocated or computed) and counts what the step does.

Per cell (the reference's record, fields kept):

* ``memory`` — per rank, the counterpart of XLA's ``memory_analysis``:
  ``argument_size_in_bytes`` sums the step's operands — the params (and
  AdamW's state in train), the batch or the decode token, the cache (and
  ``enc_out`` for encdec) — each leaf's bytes divided by the product of
  the axis sizes its spec shards it over (``distributed/sharding.py``'s
  ``param_specs``, ``opt_state_specs``, ``batch_specs``,
  ``cache_specs``); ``output_size_in_bytes`` the step's results on the
  same rule (new params and state and three 0-d metrics; the logits,
  vocabulary over the model axis, padded where it does not divide, as
  GSPMD pads; the decode cache); ``alias_size_in_
  bytes`` the donated params, state and cache, as the reference donates
  them — the train cell traces the donating step (``make_train_step(...,
  donate=True)``), whose new params and state are its arguments' own
  storages; ``temp_size_in_bytes`` the peak of the live bytes of the
  storages the step makes, its outputs left out (an output that aliases
  an argument is no new storage), from a dispatch mode
  that adds each new storage's bytes and takes them off when it is
  freed. The trace runs at one data rank's batch (the global batch over
  the axes ``batch_specs`` shards it on, at least 1) with the model axis
  unsharded, so ``temp`` is an upper bound for a rank whose activations
  the model axis would split (``temp_basis`` says so).
* ``cost`` — per chip: ``flops`` from ``FlopCounterMode`` over the step,
  ``bytes accessed`` the sum of every dispatched op's operand and result
  bytes (views and ``empty`` move none; the kernels' meta calls add
  theirs, ``kernels.ops.meta_calls``), what the eager program moves.
  Both are traced at one data rank's batch on one data rank's slice of
  the grid (``trace_grid``: the batch axes at size 1, the model axis
  whole), so they hold that data group's M chips' work: scaled by the
  data ranks and divided by the chips, that is the trace over M.
* ``collectives`` — per rank, two parts and their ``total``:
  ``traced``, ``hlo_analysis.collective_bytes`` of the step's own log
  (the expert-parallel dispatch of the ``moe`` cells), and
  ``implied_by_specs``, closed forms for the collectives the reference's
  SPMD program runs and the port's emulated grid does not (``_implied``).
* ``roofline`` — ``hlo_analysis.roofline`` on H100 datasheet constants.

The eager trace runs every loop (layers, flash chunks, scan chunks), so
the reference's flash add-back is 0 here (the field is kept). With
``probes`` the cell traces two shallow probes (``_probe_cfg``: the
config cut to ``PROBES`` depth units, layers or hybrid groups, ``remat``
kept, so they trace the step the full config runs) and extrapolates
flops, bytes accessed, collectives and the temp peak linearly to the full
depth (``_units``): ``roofline`` and ``roofline_corrected`` then hold
the same figures (``extrapolated`` says so). The probes are 2 and 3
units deep where the reference's are 1 and 2: a 1-unit trace is not yet
steady (its bytes and its peak differ from what each later unit adds),
while from 2 units on every unit adds the same flops, bytes and
collectives, and the same live bytes where the peak is one line in the
depth — every step without ``remat``. Under ``remat`` a train step's
peak is the larger of two lines (the end of the forward, holding every
block's saved input; the backward, holding every block's weight
gradients until they are stacked), so its probes give a lower bound
(``temp_exact`` false). A config no deeper than the deeper probe, and
``--no-probes``, trace the full depth.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
  python -m repro_torch.launch.dryrun --all --multi-pod --no-probes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..distributed.context import make_context
from ..distributed.sharding import (
    batch_specs, cache_specs, opt_state_specs, param_specs,
)
from ..distributed.topology import Topology
from ..kernels import ops
from ..models.config import ModelConfig
from ..models.transformer import decode_step
from ..optim.adamw import AdamWConfig
from ..train.steps import make_prefill_step, make_train_step
from .hlo_analysis import collective_bytes, roofline
from .mesh import EmulatedMesh, make_production_mesh
from .specs import (
    SHAPES, ShapeSpec, abstract_cache, abstract_opt_state, abstract_params,
    cell_status, input_specs,
)

__all__ = ["run_cell", "trace_step", "main"]

META = torch.device("meta")
TEMP_BASIS = ("one data rank's batch with the model axis unsharded: an "
              "upper bound for a rank whose activations the model axis "
              "would split")


# ---------------------------------------------------------------------------
# the trace: flops, bytes accessed, live bytes, collectives
# ---------------------------------------------------------------------------


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tracker(TorchDispatchMode):
    """Every dispatched op's operand and result bytes, and the storages it
    makes: each new one's bytes join the live set until it is freed
    (``events`` in order, keyed by a number of each storage's own: a
    freed storage's address may come back for a later one)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.events = []  # (storage number, +bytes | -bytes)
        self._live = {}  # address -> (storage number, bytes)
        self._before = set()  # addresses of storages made before the trace

    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _watch(self, st, key: int, made: bool) -> None:
        def gone():
            if made:
                uid, n = self._live.pop(key)
                self.events.append((uid, -n))
            else:
                self._before.discard(key)
        weakref.finalize(st, gone)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        in_keys = set()
        for t in ins:
            k = self._key(t)
            in_keys.add(k)
            if k not in self._live and k not in self._before:
                self._before.add(k)
                self._watch(t.untyped_storage(), k, False)
        outs = list(_tensors(out))
        name = func.overloadpacket.__name__
        view = not func._schema.is_mutable and outs and all(
            self._key(t) in in_keys for t in outs)
        if not (view or name.startswith(("empty", "new_empty"))):
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            k = self._key(t)
            if k in self._live or k in self._before:
                continue
            st = t.untyped_storage()
            uid, n = len(self.events), st.nbytes()
            self._live[k] = (uid, n)
            self.events.append((uid, n))
            self._watch(st, k, True)
        return out

    def numbers(self, tensors) -> set:
        """The storage numbers of the live ``tensors`` made in the trace."""
        return {self._live[k][0] for k in map(self._key, tensors)
                if k in self._live}

    def peak(self, leave_out=()) -> int:
        """The peak of the live bytes, the storages ``leave_out`` numbers
        left out."""
        skip = set(leave_out)
        cur = top = 0
        for uid, n in self.events:
            if uid in skip:
                continue
            cur += n
            top = max(top, cur)
        return top


def trace_step(step, *args) -> Dict[str, Any]:
    """Run ``step(*args)`` under the trackers: its result, ``flops``,
    ``bytes`` (operands and results of every op, the kernels' meta calls
    included), ``temp`` (the peak of live bytes the step made, its
    outputs left out), ``peak`` (the same with its outputs: what the step
    holds above its arguments at its top) and ``kernel_calls``, the
    kernels' meta calls it made by kernel (``ops.meta_calls``; a meta
    call launches nothing)."""
    before = ops.meta_calls()
    tracker = _Tracker()
    with FlopCounterMode(display=False) as fc, tracker:
        out = step(*args)
    outs = tracker.numbers(_tensors(out))
    made = {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v}
            for k, v in ops.meta_calls().items()}
    made = {k: v for k, v in made.items() if v["calls"]}
    return {"out": out, "flops": float(fc.get_total_flops()),
            "bytes": float(tracker.bytes
                           + sum(v["bytes"] for v in made.values())),
            "temp": float(tracker.peak(outs)),
            "peak": float(tracker.peak()),
            "kernel_calls": {k: v["calls"] for k, v in made.items()}}


# ---------------------------------------------------------------------------
# per-rank bytes by spec
# ---------------------------------------------------------------------------


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec_leaves(tree, specs):
    """(tensor, spec) pairs of ``tree`` against its spec tree."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _spec_leaves(tree[k], specs[k])
    elif isinstance(tree, torch.Tensor):
        yield tree, specs
    else:  # a list or tuple
        for v, s in zip(tree, specs):
            yield from _spec_leaves(v, s)


def _per_rank(t: torch.Tensor, spec, sizes: Dict[str, int]) -> float:
    n = math.prod(sizes[a] for e in (spec or ()) for a in _axes(e))
    return _nbytes(t) / n


def _tree_bytes(tree, specs, sizes) -> float:
    return sum(_per_rank(t, s, sizes) for t, s in _spec_leaves(tree, specs))


def _batch_split(spec, sizes) -> int:
    """The ranks a batch dim's spec entry splits it over."""
    return math.prod(sizes[a] for a in _axes(spec[0]))


def _cache_bytes(cache, cspecs, sizes) -> float:
    return sum(_per_rank(getattr(cache, f), cspecs[f], sizes)
               for f in cspecs if f != "length"
               and getattr(cache, f) is not None)


# ---------------------------------------------------------------------------
# the collectives the reference's SPMD program runs and the grid does not
# ---------------------------------------------------------------------------


def _tp_blocks(cfg: ModelConfig, shape: ShapeSpec, M: int):
    """(count, sequence length) of the activations the model axis
    all-reduces in one forward: each block whose output projection is
    sharded over it (attention ``wo``, MLP ``w2``, Mamba ``out_proj``;
    the expert-parallel MoE exchanges instead, traced), and the
    embedding lookup when the vocabulary is sharded."""
    if M == 1:
        return []
    if shape.mode == "decode":
        s_dec, s_enc = 1, cfg.frontend_len
    else:
        s_dec = shape.seq_len
        s_enc = cfg.frontend_len
    attn = (cfg.n_heads * cfg.head_dim) % M == 0
    ffn = cfg.d_ff % M == 0 and not cfg.is_moe
    ssm = cfg.is_ssm and cfg.d_inner % M == 0
    out = []
    if cfg.vocab_size % M == 0:
        out.append((1, s_dec))
    L = cfg.n_layers
    if cfg.family == "ssm":
        out.append((L * ssm, s_dec))
    elif cfg.family == "hybrid":
        groups = L // max(cfg.attn_every, 1)
        out.append((groups * cfg.attn_every * ssm, s_dec))
        out.append((groups * (attn + (cfg.d_ff % M == 0)), s_dec))
    else:
        out.append((L * (attn + ffn), s_dec))
        if cfg.family == "encdec":
            out.append((L * attn, s_dec))  # the cross blocks
            if shape.mode != "decode":
                out.append((cfg.n_enc_layers * (attn + ffn), s_enc))
    return [(n, s) for n, s in out if n]


def _implied(cfg: ModelConfig, shape: ShapeSpec, params, pspecs,
             sizes: Dict[str, int], b_local: int) -> Dict[str, float]:
    """Per-rank bytes of the collectives the reference's SPMD program
    runs and the emulated grid does not:

    * FSDP (``cfg.fsdp``): each leaf sharded over the data axis is
      all-gathered before use — its shard's bytes once in a forward, once
      more when ``remat`` recomputes the forward in a train step — and
      its gradient reduce-scattered once in a train step, whose operand
      is the leaf gathered over the data axis (shard × data size);
    * tensor parallelism: each block output the model axis shards
      (``_tp_blocks``) is all-reduced over it, an operand of one data
      rank's activations ``b_local · seq · d_model`` in the model's
      dtype: once in a forward, and in a train step once more for the
      input gradient in the backward and once more again under
      ``remat``.
    """
    out: Dict[str, float] = {}
    train = shape.mode == "train"
    remat = bool(cfg.remat) and train
    data = sizes.get("data", 1)
    if cfg.fsdp and data > 1:
        gathers = 1 + remat
        for t, spec in _spec_leaves(params, pspecs):
            if any("data" in _axes(e) for e in spec):
                shard = _per_rank(t, spec, sizes)
                out["all-gather"] = out.get("all-gather", 0) + gathers * shard
                if train:
                    out["reduce-scatter"] = out.get("reduce-scatter", 0) \
                        + shard * data
    M = sizes["model"]
    elt = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    uses = 1 + (1 + remat if train else 0)
    for n, s in _tp_blocks(cfg, shape, M):
        out["all-reduce"] = out.get("all-reduce", 0) \
            + uses * n * b_local * s * cfg.d_model * elt
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def _mesh_name(mesh: EmulatedMesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def _trace_mesh(mesh: EmulatedMesh) -> EmulatedMesh:
    """One data rank's slice of ``mesh``: the batch axes at size 1, the
    model axis whole; a fresh communicator, so its log holds this trace
    alone."""
    shape = [n if a == "model" else 1 for a, n in mesh.shape.items()]
    return EmulatedMesh(shape, mesh.axis_names)


def _account(cfg: ModelConfig, shape: ShapeSpec, mesh: EmulatedMesh,
             b_local: int) -> Dict[str, Any]:
    """Trace the cell's step at one data rank's batch on one data rank's
    slice of the grid: the trace figures and the step's outputs."""
    tdist = make_context(_trace_mesh(mesh), fsdp=cfg.fsdp)
    local = dataclasses.replace(shape, global_batch=b_local)
    params = abstract_params(cfg)
    if shape.mode == "train":
        step = make_train_step(cfg, tdist, AdamWConfig(), donate=True)
        res = trace_step(step, params, abstract_opt_state(cfg),
                         input_specs(cfg, local))
    elif shape.mode == "prefill":
        res = trace_step(make_prefill_step(cfg, tdist), params,
                         input_specs(cfg, local))
    else:
        cache = abstract_cache(cfg, b_local, shape.seq_len + 16)
        token = input_specs(cfg, local)["token"]
        enc = (torch.empty((b_local, cfg.frontend_len, cfg.d_model),
                           dtype=getattr(torch, cfg.dtype), device=META)
               if cfg.family == "encdec" else None)

        def step(params, token, cache):
            with torch.no_grad():
                return decode_step(params, cfg, tdist, token, cache, enc)

        res = trace_step(step, params, token, cache)
    res["traced"] = collective_bytes(tdist.comm)
    return res


def _units(cfg: ModelConfig) -> int:
    """Linear depth units for probe extrapolation."""
    if cfg.family == "hybrid":
        return cfg.n_layers // max(cfg.attn_every, 1)
    return cfg.n_layers


def _probe_cfg(cfg: ModelConfig, units: int) -> ModelConfig:
    """The config cut to ``units`` depth units (``remat`` as it is)."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=units * cfg.attn_every)
    kw = dict(n_layers=units)
    if cfg.family == "encdec":
        kw["n_enc_layers"] = units
    return dataclasses.replace(cfg, **kw)


PROBES = (2, 3)  # the depth units of the two probes


def _trace(cfg, shape, mesh, b_local, probes: bool):
    """The trace figures of the full depth: traced, or extrapolated from
    the ``PROBES``; a config no deeper than the deeper probe is traced
    whole."""
    u = _units(cfg)
    if not probes or u <= PROBES[1]:
        res = _account(cfg, shape, mesh, b_local)
        return res, res["traced"], False
    lo, hi = PROBES
    p1, p2 = (_account(_probe_cfg(cfg, n), shape, mesh, b_local)
              for n in PROBES)

    def lin(a, b):
        return a + (u - lo) * (b - a) / (hi - lo)

    res = {k: lin(p1[k], p2[k]) for k in ("flops", "bytes", "temp")}
    res["out"] = p1["out"]
    calls1, calls2 = p1["kernel_calls"], p2["kernel_calls"]
    res["kernel_calls"] = {k: round(lin(calls1.get(k, 0), calls2.get(k, 0)))
                           for k in set(calls1) | set(calls2)}
    kinds = set(p1["traced"]) | set(p2["traced"])
    traced = {k: lin(p1["traced"].get(k, 0), p2["traced"].get(k, 0))
              for k in kinds}
    return res, traced, True


def account(cfg: ModelConfig, shape: ShapeSpec, mesh: EmulatedMesh,
            probes: bool = True) -> Dict[str, Any]:
    """The record's figures for ``cfg`` × ``shape`` on ``mesh`` (any
    grid with a model axis): ``memory``, ``cost``, ``collectives``,
    ``roofline`` and what they rest on."""
    t0 = time.time()
    dist = make_context(mesh, fsdp=cfg.fsdp)
    sizes = dict(mesh.shape)
    chips = mesh.size
    M = sizes["model"]
    b, s = shape.global_batch, shape.seq_len
    params = abstract_params(cfg)
    pspecs = param_specs(params, cfg, dist)
    p_bytes = _tree_bytes(params, pspecs, sizes)
    bspecs = batch_specs(cfg, dist, b)
    split = _batch_split(bspecs["tokens"], sizes)
    b_local = max(b // split, 1)

    res, traced, extrapolated = _trace(cfg, shape, mesh, b_local, probes)

    elt = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()

    def logits_bytes(t):
        # vocabulary over the model axis, padded where it does not divide
        return _nbytes(t) / cfg.vocab_size * -(-cfg.vocab_size // M)

    mem: Dict[str, float] = {}
    if shape.mode == "train":
        ospecs = opt_state_specs(pspecs)
        o_bytes = _tree_bytes(abstract_opt_state(cfg), ospecs, sizes)
        batch = input_specs(cfg, shape)
        in_bytes = _tree_bytes(batch, bspecs, sizes)
        mem["argument_size_in_bytes"] = p_bytes + o_bytes + in_bytes
        # new params and state, and the loss, grad norm and lr
        mem["output_size_in_bytes"] = p_bytes + o_bytes + 3 * 4
        mem["alias_size_in_bytes"] = p_bytes + o_bytes
        model_flops = 6.0 * cfg.active_params_count() * b * s
    elif shape.mode == "prefill":
        batch = input_specs(cfg, shape)
        mem["argument_size_in_bytes"] = p_bytes + _tree_bytes(
            batch, bspecs, sizes)
        logits = next(iter(_tensors(res["out"])))
        mem["output_size_in_bytes"] = logits_bytes(logits)
        mem["alias_size_in_bytes"] = 0.0
        model_flops = 2.0 * cfg.active_params_count() * b * s
    else:
        cspecs = cache_specs(cfg, dist, b)
        c_bytes = _cache_bytes(abstract_cache(cfg, b, s + 16), cspecs, sizes)
        token = input_specs(cfg, shape)["token"]
        tok_bytes = _nbytes(token) / split
        enc_bytes = (b * cfg.frontend_len * cfg.d_model * elt / split
                     if cfg.family == "encdec" else 0.0)
        mem["argument_size_in_bytes"] = p_bytes + tok_bytes + c_bytes \
            + enc_bytes
        logits = res["out"][0]
        mem["output_size_in_bytes"] = logits_bytes(logits) + c_bytes
        mem["alias_size_in_bytes"] = c_bytes
        model_flops = 2.0 * cfg.active_params_count() * b
    mem["temp_size_in_bytes"] = res["temp"]
    mem["generated_code_size_in_bytes"] = 0.0

    implied = _implied(cfg, shape, params, pspecs, sizes, b_local)
    coll = {"traced": traced, "implied_by_specs": implied,
            "total": traced.get("total", 0) + implied["total"]}
    cost = {"flops": res["flops"] / M, "bytes accessed": res["bytes"] / M}
    roof = roofline(cost, coll, chips=chips, model_flops=model_flops)
    roof["attention_correction_flops_per_chip"] = 0.0
    trace_s = round(time.time() - t0, 2)
    exact = not (extrapolated and cfg.remat and shape.mode == "train")
    return {"memory": mem, "temp_basis": TEMP_BASIS, "temp_exact": exact,
            "cost": cost,
            "collectives": coll, "roofline": roof,
            "roofline_corrected": {**roof, "probe_units": _units(cfg),
                                   "extrapolated": extrapolated},
            "probe_units": _units(cfg), "extrapolated": extrapolated,
            "trace_grid": _mesh_name(_trace_mesh(mesh)),
            "batch_per_data_rank": b_local,
            "kernel_calls": res["kernel_calls"],
            "trace_s": trace_s, "compile_s": trace_s}


def run_cell(arch, shape_name, multi_pod: bool = False,
             opt_overrides: Optional[dict] = None, probes: bool = True,
             mesh: Optional[EmulatedMesh] = None) -> Dict[str, Any]:
    """Trace one cell; returns the dry-run record.

    ``arch`` is a name of ``configs.ARCHS`` or a ``ModelConfig``,
    ``shape_name`` a name of ``SHAPES`` or a ``ShapeSpec``; ``mesh``
    (default: ``make_production_mesh(multi_pod)``) any grid with a model
    axis."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if opt_overrides:
        cfg = dataclasses.replace(cfg, **opt_overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    rec: Dict[str, Any] = {
        "arch": arch if isinstance(arch, str) else cfg.name,
        "shape": shape.name, "mesh": _mesh_name(mesh), "mode": shape.mode,
        # records of different torch / CUDA builds trace different ops:
        # tag them so roofline comparisons never mix them
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }
    status = cell_status(cfg, shape)
    rec["status"] = status
    if status != "run":
        return rec
    rec["topology"] = Topology.from_mesh(mesh, device="cpu").describe()
    rec.update(account(cfg, shape, mesh, probes))
    rec["params"] = cfg.params_count()
    rec["active_params"] = cfg.active_params_count()
    rec["chips"] = mesh.size
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description="SHIRO dry run on the meta "
                                             "device")
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell on the chosen mesh")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--no-probes", action="store_true",
                    help="trace the full depth instead of the "
                         f"{PROBES[0]}- and {PROBES[1]}-unit probes")
    args = ap.parse_args()

    cells = ([(a, sh) for a in ARCHS for sh in SHAPES]
             if args.all else [(args.arch, args.shape)])
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("--arch and --shape required unless --all")

    for arch, shape_name in cells:
        try:
            rec = run_cell(arch, shape_name, multi_pod=args.multi_pod,
                           probes=not args.no_probes)
        except Exception as e:  # record failures; the sweep goes on
            rec = {"arch": arch, "shape": shape_name,
                   "mesh": "2x16x16" if args.multi_pod else "16x16",
                   "status": f"FAIL({type(e).__name__})",
                   "error": str(e)[:2000],
                   "traceback": traceback.format_exc()[-4000:]}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
