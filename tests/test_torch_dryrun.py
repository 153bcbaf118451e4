"""``repro_torch.launch.dryrun``: every cell's step traced on the meta device.

* ``run_cell`` at a small ``ShapeSpec`` on every arch's smoke config ×
  train / prefill / decode gives ``status`` "run" and every field of the
  reference's record;
* ``params``, ``active_params`` and ``model_flops`` equal the
  reference's;
* per-rank argument bytes equal XLA's ``memory_analysis()`` of the
  reference's compiled step (``repro.launch.dryrun._compile_one``) at
  smoke size on a (2, 4) mesh of the 8 CPU devices, apart from the leaves
  named here: the decode cache's ``length`` (an int32 in the reference's
  cache, a host integer in the port's) and the params a decode step does
  not read (the encdec's encoder and the adapter), which XLA prunes from
  the compiled arguments;
* the probes' extrapolation equals the full-depth trace (flops, bytes,
  collectives; the temp peak wherever it is one line in the depth);
* one flash call's traced flops are 4·b·q·kv·h·hd: the port runs every
  chunk, the ones the causal mask empties too;
* ``long_500k`` is skipped for full-attention archs;
* ``scripts/make_experiments.py`` tabulates the CLI's records;
* the meta route: no call reaches a CUDA wrapper or a plain version,
  each kernel's meta calls are counted apart and the launch counts stay
  at zero, ``on_card`` still raises for meta;
* two consecutive cells' collectives do not mix.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402,E501
from repro_torch.kernels import gather_rows as K1  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as K6  # noqa: E402
from repro_torch.kernels import scatter_add_rows as K2  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.specs import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.models.layers import flash_attention  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
AXES = ("data", "model")
MODES = ("train", "prefill", "decode")
FIELDS = ("arch", "shape", "mesh", "mode", "torch", "cuda", "status",
          "topology", "params", "active_params", "chips", "memory", "cost",
          "collectives", "roofline", "roofline_corrected", "probe_units",
          "trace_s", "compile_s", "temp_basis")
MEMORY = ("argument_size_in_bytes", "output_size_in_bytes",
          "temp_size_in_bytes", "generated_code_size_in_bytes",
          "alias_size_in_bytes")
FAMILY_ARCHS = ("qwen2-1.5b", "olmoe-1b-7b", "falcon-mamba-7b",
                "zamba2-2.7b", "seamless-m4t-medium", "llava-next-mistral-7b")


def _shape(mode, b=8, s=32):
    return ShapeSpec(f"smoke_{mode}", s, b, mode)


def _mesh(shape=(2, 4)):
    return make_mesh(shape, AXES)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_gives_every_field(arch, mode):
    rec = TD.run_cell(get_smoke_config(arch), _shape(mode), mesh=_mesh())
    assert rec["status"] == "run"
    assert set(FIELDS) <= set(rec), set(FIELDS) - set(rec)
    assert set(MEMORY) <= set(rec["memory"])
    assert all(v >= 0 for v in rec["memory"].values())
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    coll = rec["collectives"]
    assert set(coll) == {"traced", "implied_by_specs", "total"}
    assert coll["total"] == coll["traced"]["total"] + \
        coll["implied_by_specs"]["total"]
    assert rec["roofline"]["bound_time"] > 0
    assert rec["roofline_corrected"]["attention_correction_flops_per_chip"] \
        == 0.0
    assert rec["mesh"] == "2x4" and rec["chips"] == 8
    assert rec["kernel_calls"]["rmsnorm"] > 0
    if mode == "train":
        assert rec["kernel_calls"]["rmsnorm_bwd"] > 0
    json.dumps(rec)


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_equal_the_reference(arch):
    cfg, rcfg = get_smoke_config(arch), ref_smoke(arch)
    sh = _shape("train")
    rec = TD.run_cell(cfg, sh, mesh=_mesh())
    assert rec["params"] == rcfg.params_count()
    assert rec["active_params"] == rcfg.active_params_count()
    assert rec["roofline"]["model_flops"] == \
        6.0 * rcfg.active_params_count() * sh.global_batch * sh.seq_len
    full, rfull = get_config(arch), ref_config(arch)
    assert full.params_count() == rfull.params_count()
    assert full.active_params_count() == rfull.active_params_count()


def _ref_memory(arch, mode):
    """XLA's memory analysis of the reference's compiled smoke step on a
    (2, 4) mesh of the 8 CPU devices."""
    import time

    jax.devices()  # the backend first, with tests/conftest.py's 8 devices
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as RD  # sets XLA_FLAGS on import
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    from repro.distributed.context import make_context
    from repro.launch.mesh import make_mesh as ref_mesh
    from repro.launch.specs import ShapeSpec as RShape

    rcfg = ref_smoke(arch)
    mesh = ref_mesh((2, 4), AXES)
    rec = RD._compile_one(rcfg, RShape(f"smoke_{mode}", 32, 8, mode), mesh,
                          make_context(mesh, fsdp=rcfg.fsdp), time.time(), 8)
    return rec["memory"]


def _unread_by_decode(cfg, mesh):
    """Per-rank bytes of the params a decode step does not read: XLA
    prunes them from the compiled arguments (``jax.jit``'s
    ``keep_unused=False``)."""
    from repro_torch.distributed.context import make_context
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.launch.specs import abstract_params

    params = abstract_params(cfg)
    specs = param_specs(params, cfg, make_context(mesh, fsdp=cfg.fsdp))
    sizes = dict(mesh.shape)
    unread = {}
    for leaf in ("encoder", "adapter"):
        if leaf in params:
            unread[leaf] = TD._tree_bytes(params[leaf], specs[leaf], sizes)
    return unread


@pytest.mark.parametrize("arch,mode", [
    ("qwen2-1.5b", "train"), ("qwen2-1.5b", "decode"),
    ("olmoe-1b-7b", "train"), ("olmoe-1b-7b", "decode"),
    ("zamba2-2.7b", "train"), ("zamba2-2.7b", "decode"),
    ("seamless-m4t-medium", "decode"), ("llava-next-mistral-7b", "decode")])
def test_argument_bytes_equal_xla(arch, mode):
    cfg = get_smoke_config(arch)
    mesh = _mesh()
    got = TD.run_cell(cfg, _shape(mode), mesh=mesh)["memory"]
    want = _ref_memory(arch, mode)["argument_size_in_bytes"]
    # leaves one side counts and the other does not, by name
    only_xla = {"cache.length": 4} if mode == "decode" else {}
    only_port = _unread_by_decode(cfg, mesh) if mode == "decode" else {}
    assert got["argument_size_in_bytes"] - sum(only_port.values()) \
        + sum(only_xla.values()) == want, (only_xla, only_port)


def _deep(arch, units=5, **changes):
    cfg = get_smoke_config(arch)
    cfg = TD._probe_cfg(cfg, units)
    return dataclasses.replace(cfg, **changes)


@pytest.mark.parametrize("mode,remat", [("train", False), ("train", True),
                                        ("prefill", False),
                                        ("decode", False)])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_probes_extrapolate_to_the_full_depth(arch, mode, remat):
    cfg = _deep(arch, remat=remat)
    sh = _shape(mode)
    probed = TD.run_cell(cfg, sh, mesh=_mesh())
    full = TD.run_cell(cfg, sh, mesh=_mesh(), probes=False)
    assert probed["extrapolated"] and not full["extrapolated"]
    for key in ("flops", "bytes accessed"):
        assert probed["cost"][key] == pytest.approx(full["cost"][key],
                                                    rel=1e-12)
    assert probed["collectives"]["total"] == pytest.approx(
        full["collectives"]["total"], rel=1e-12)
    t_probe = probed["memory"]["temp_size_in_bytes"]
    t_full = full["memory"]["temp_size_in_bytes"]
    if remat and mode == "train":
        # the larger of two lines in the depth: two probes give a bound
        assert not probed["temp_exact"] and t_probe <= t_full
    else:
        assert probed["temp_exact"] and t_probe == pytest.approx(t_full,
                                                                 rel=1e-12)
    assert probed["roofline"] == {k: v for k, v in
                                  probed["roofline_corrected"].items()
                                  if k not in ("probe_units", "extrapolated")}


@pytest.mark.parametrize("q,kv,causal", [(2048, 2048, True),
                                         (1024, 3072, False)])
def test_flash_flops_are_the_closed_form(q, kv, causal):
    b, h, kvh, hd = 2, 8, 2, 64
    meta = dict(device="meta", dtype=torch.bfloat16)
    res = TD.trace_step(lambda: flash_attention(
        torch.empty((b, h, q, hd), **meta), torch.empty((b, kvh, kv, hd),
                                                        **meta),
        torch.empty((b, kvh, kv, hd), **meta), causal=causal))
    assert res["flops"] == 4 * b * q * kv * h * hd
    assert tuple(res["out"].shape) == (b, h, q, hd)


@pytest.mark.parametrize("arch", ARCHS)
def test_long_500k_is_skipped_for_full_attention(arch):
    cfg = get_config(arch)
    if cfg.sub_quadratic:
        assert TD.cell_status(cfg, SHAPES["long_500k"]) == "run"
        return
    rec = TD.run_cell(arch, "long_500k")
    assert rec["status"] == "SKIP(full-attention)"
    assert "memory" not in rec and rec["mesh"] == "16x16"


def test_cli_records_tabulate(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch, shape in (("qwen2-1.5b", "decode_32k"),
                        ("smollm-135m", "long_500k")):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", str(out)],
            capture_output=True, text=True, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["run", "SKIP(full-attention)"]
    assert recs[0]["memory"]["argument_size_in_bytes"] > 0
    assert recs[0]["roofline_corrected"]["bottleneck"] in (
        "compute", "memory", "collective")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "make_experiments.py"),
         str(out)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "| qwen2-1.5b | decode_32k | decode | run |" in proc.stdout
    assert "| smollm-135m | long_500k |" in proc.stdout
    assert "FAILED cells: 0" in proc.stdout


def test_meta_reaches_no_cuda_wrapper_and_counts_no_launch(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a meta call reached a kernel or its plain "
                             "version")

    for mod, names in ((K1, ("gather_rows_cuda", "gather_rows_plain",
                             "gather_rows_scaled_cuda",
                             "gather_rows_scaled_plain")),
                       (K2, ("scatter_add_rows_cuda",
                             "scatter_add_rows_plain")),
                       (K6, ("rmsnorm_cuda", "rmsnorm_plain",
                             "rmsnorm_bwd_cuda", "rmsnorm_bwd_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    ops.reset_launch_counts()
    before = ops.meta_calls()
    rec = TD.run_cell(get_smoke_config("olmoe-1b-7b"), _shape("train"),
                      mesh=_mesh())
    # a meta call launches nothing: the launch counts stay at zero, and
    # the meta calls the trace made are the record's
    assert set(ops.launch_counts().values()) == {0}
    after = ops.meta_calls()
    for k in ("gather_rows", "scatter_add_rows", "rmsnorm", "rmsnorm_bwd"):
        made = after[k]["calls"] - before.get(k, {}).get("calls", 0)
        assert made > 0 and made == rec["kernel_calls"][k], k
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.on_card(torch.empty(1, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        ops.pack_rows_op(torch.empty((1, 4, 2), device="meta"),
                         torch.zeros((1, 3), dtype=torch.int32))


def test_meta_ops_give_the_kernels_shapes():
    m = dict(device="meta")
    i32 = dict(device="meta", dtype=torch.int32)
    b = torch.empty((2, 5, 3), dtype=torch.bfloat16, **m)
    idx = torch.empty((2, 4), **i32)
    ops.reset_launch_counts()
    before = ops.meta_calls()
    out = ops.pack_rows_op(b, idx)
    c = torch.empty((2, 6, 3), dtype=torch.bfloat16, **m)
    perm, meta = K2.sorted_scatter_maps(idx)
    got = ops.scatter_add_rows_exec_op(c, out, perm, meta)
    x = torch.empty((4, 7), dtype=torch.bfloat16, **m)
    y = ops.rmsnorm_op(x, torch.empty(7, dtype=torch.bfloat16, **m))
    k3 = ops.bsr_spmm_op(torch.empty((2, 1, 2), **i32),
                         torch.empty((2, 1, 2, 8, 8), **m),
                         torch.empty((2, 16, 3), **m), 8)
    traffic = {k: v["bytes"] - before.get(k, {}).get("bytes", 0)
               for k, v in ops.meta_calls().items()}
    traffic = {k: v for k, v in traffic.items() if v}
    assert tuple(out.shape) == (2, 4, 3) and out.dtype == torch.bfloat16
    assert got is c and perm.shape == (2, 4) and meta.shape == (2, 5)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert tuple(k3.shape) == (2, 8, 3)
    assert traffic["gather_rows"] == (b.numel() * 2 + idx.numel() * 4
                                      + out.numel() * 2)
    assert set(traffic) == {"gather_rows", "scatter_add_rows", "rmsnorm",
                            "bsr_spmm"}
    assert set(ops.launch_counts().values()) == {0}


def test_consecutive_cells_do_not_mix_collectives():
    ep = get_smoke_config("olmoe-1b-7b")
    dense = get_smoke_config("qwen2-1.5b")
    first = TD.run_cell(ep, _shape("decode"), mesh=_mesh())
    assert first["collectives"]["traced"]["all-to-all"] > 0
    after = TD.run_cell(dense, _shape("decode"), mesh=_mesh())
    assert after["collectives"]["traced"] == {"total": 0}
    again = TD.run_cell(ep, _shape("decode"), mesh=_mesh())
    assert again["collectives"]["traced"] == first["collectives"]["traced"]
    # a step built on the same mesh's context logs into one communicator:
    # the cell traces on a fresh one
    from repro_torch.distributed.context import make_context

    mesh = _mesh()
    make_context(mesh).comm.log.append(("all_to_all@model", (), 1))
    make_context(mesh).comm.nbytes.append(1)
    rec = TD.run_cell(dense, _shape("decode"), mesh=mesh)
    assert rec["collectives"]["traced"] == {"total": 0}
    assert np.isfinite(rec["roofline"]["bound_time"])


def test_a_vocabulary_the_model_axis_does_not_divide():
    """seamless-m4t-medium's 256,206 over 16 model ranks: the logits keep
    the vocabulary whole where the model axis does not divide it (the
    head's own spec), so the step runs on the grid, on meta and on the
    CPU alike; the record's logits bytes are the padded shard the
    reference's jitted constraint makes."""
    from repro_torch.distributed.context import make_context
    from repro_torch.models import transformer as TT

    cfg = dataclasses.replace(get_smoke_config("seamless-m4t-medium"),
                              vocab_size=250)
    rec = TD.run_cell(cfg, _shape("prefill"), mesh=_mesh())
    assert rec["status"] == "run"
    # one data rank's 4 rows × 32 positions × ceil(250 / 4) float32
    assert rec["memory"]["output_size_in_bytes"] == 4 * 32 * 63 * 4
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 250, (4, 6))),
             "enc_embeds": torch.from_numpy(rng.standard_normal(
                 (4, cfg.frontend_len, cfg.d_model)).astype(np.float32))}
    with torch.no_grad():
        assert torch.equal(TT.forward(params, cfg, make_context(_mesh()),
                                      batch),
                           TT.forward(params, cfg, None, batch))
