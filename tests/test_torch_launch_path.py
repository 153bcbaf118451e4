"""The kernels' shared launch path (``kernels.build``) and K6's dispatch, on
the CPU.

The library is loaded once and then handed out without the lock; the raw
stream accessor is looked up at the first launch, not at import (CPU
builds of torch lack it); a CPU tensor takes the plain version and counts
no launch, and the CUDA wrappers raise on CPU operands. Launches on the
card are tested in ``tests/test_torch_cuda.py``.
"""
import importlib.util

import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels import rmsnorm as K6
from repro_torch.kernels import sddmm as K5


def test_importing_build_needs_no_cuda_accessor(monkeypatch):
    monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream", raising=False)
    spec = importlib.util.spec_from_file_location("_build_probe",
                                                  build.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod._raw_stream is None and mod._lib is None


def test_stream_of_resolves_the_accessor_once(monkeypatch):
    asked = []

    def raw_stream(index):
        asked.append(index)
        return 1000 + index

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", raw_stream,
                        raising=False)
    monkeypatch.setattr(build, "_raw_stream", None)
    t = torch.zeros(2)
    assert build.stream_of(t) == 1000 + t.get_device()
    monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream")
    assert build.stream_of(t) == 1000 + t.get_device()  # kept from the first
    assert asked == [t.get_device()] * 2


def test_library_skips_the_lock_once_loaded(monkeypatch):
    class Refuse:
        def __enter__(self):
            raise AssertionError("library() took the lock after loading")

        def __exit__(self, *exc):
            return False

    loaded = object()
    monkeypatch.setattr(build, "_lib", loaded)
    monkeypatch.setattr(build, "_lock", Refuse())
    assert build.library() is loaded


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_op_on_cpu_runs_plain_without_launches(dtype):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 64), generator=gen).to(dtype)
    g = torch.randn(64, generator=gen).to(dtype)
    before = ops.launch_counts()
    out = ops.rmsnorm_op(x, g, 1e-5, round_before_gain=True)
    assert ops.launch_counts() == before
    assert torch.equal(out, K6.rmsnorm_plain(x, g, 1e-5,
                                             round_before_gain=True))
    with pytest.raises(ValueError, match="different devices"):
        ops.rmsnorm_op(x, g.to("meta"))


def test_cuda_wrappers_raise_on_cpu_operands():
    x, g = torch.randn(4, 16), torch.randn(16)
    with pytest.raises(ValueError, match="CUDA device"):
        K6.rmsnorm_cuda(x, g)
    cols = torch.zeros((1, 1, 1), dtype=torch.int32)
    blocks = torch.ones((1, 1, 1, 8, 8))
    x3, y3 = torch.randn(1, 1, 8, 4), torch.randn(1, 1, 8, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        K5.bsr_sddmm_cuda(cols, blocks, x3, y3)
