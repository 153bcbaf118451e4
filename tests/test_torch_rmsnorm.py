"""K6's oracle and plain version against the JAX package's RMSNorms (CPU).

``rmsnorm_ref`` with ``round_before_gain=False`` is held against
``rmsnorm_pallas`` (interpret mode) and with ``True`` against the model's
``layers.rms_norm``, at ``test_rmsnorm_kernel_matches_ref``'s four shapes
and inputs: float32 within 1e-6, bfloat16 bit-equal or one bf16 ulp
apart (the sum of squares and ``rsqrt`` round differently in the two
frameworks). The plain version ``rmsnorm_plain`` repeats the kernel's
float32 chain (its own order of the sum of squares) and is held against
the oracle: float32 within 1e-6; bfloat16 within one ulp of |y| with one
rounding, and with two roundings (``round_before_gain=True``) within one
ulp of the rounded ``x·r`` carried through the gain plus one ulp of |y|
— r differs in its last float32 bit now and then, which can move
``cast(x·r)`` by one bf16 ulp, and the gain scales that step. The CUDA
kernel itself is held against the plain version, bit for bit, in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro.models.layers import rms_norm as jax_rms_norm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as K6  # noqa: E402
from repro_torch.kernels.ref import rmsnorm_ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

# test_serving_elastic.py::test_rmsnorm_kernel_matches_ref's shapes
SHAPES = [(4, 32, np.float32), (128, 64, np.float32),
          (16, 128, jnp.bfloat16), (3, 48, np.float32)]


def _inputs(rows, d, dtype):
    """The reference test's inputs: numpy seed rows·d, cast to dtype."""
    rng = np.random.default_rng(rows * d)
    x = jnp.asarray(rng.standard_normal((rows, d)), dtype)
    g = jnp.asarray(rng.standard_normal(d), dtype)
    return x, g


def _t(a) -> torch.Tensor:
    """A jax array as a torch tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bf16_ulp(y: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |y| (8 significant bits)."""
    mag = y.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def assert_rms_close(got: torch.Tensor, want: torch.Tensor,
                     carried: torch.Tensor = None) -> None:
    """float32 within 1e-6; bfloat16 within one ulp of |y|, plus
    ``carried`` (an intermediate rounding's step carried to y)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        return
    diff = (got.float() - want.float()).abs()
    tol = bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
    if carried is not None:
        tol = tol + carried
    assert bool((diff <= tol).all()), f"max diff {diff.max()}"


def two_rounding_step(x: torch.Tensor, g: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """One bf16 ulp of the rounded ``cast(x·r)``, times |g|."""
    xf = x.float()
    inter = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)).to(
        torch.bfloat16)
    return bf16_ulp(inter) * g.float().abs()


@pytest.mark.parametrize("rows,d,dtype", SHAPES)
def test_ref_matches_pallas_kernel(rows, d, dtype):
    x, g = _inputs(rows, d, dtype)
    want = _t(rmsnorm_pallas(x, g, interpret=True, br=8))
    got = rmsnorm_ref(_t(x), _t(g), round_before_gain=False)
    assert_rms_close(got, want)
    assert_rms_close(K6.rmsnorm_plain(_t(x), _t(g)), got)


@pytest.mark.parametrize("rows,d,dtype", SHAPES)
def test_ref_round_before_gain_matches_model_rms_norm(rows, d, dtype):
    x, g = _inputs(rows, d, dtype)
    want = _t(jax_rms_norm(x, g))
    got = rmsnorm_ref(_t(x), _t(g), round_before_gain=True)
    assert_rms_close(got, want)
    # the port's layers.rms_norm takes the kernel's chain on the CPU
    assert torch.equal(layers.rms_norm(_t(x), _t(g)),
                       K6.rmsnorm_plain(_t(x), _t(g), round_before_gain=True))


@pytest.mark.parametrize("rows,d,dtype", SHAPES + [
    (1024, 2048, jnp.bfloat16), (8, 2048, jnp.bfloat16), (7, 50, np.float32),
    (5, 1001, jnp.bfloat16), (3, 3000, np.float32)])
@pytest.mark.parametrize("round_before_gain", [False, True])
def test_plain_kernel_chain_matches_oracle(rows, d, dtype, round_before_gain):
    """The kernel's order of the sum of squares (padded steps of 256
    threads x 16 bytes, xor butterflies, 8 warp sums) against torch's."""
    x, g = (_t(a) for a in _inputs(rows, d, dtype))
    got = K6.rmsnorm_plain(x, g, round_before_gain=round_before_gain)
    want = rmsnorm_ref(x, g, round_before_gain=round_before_gain)
    carried = two_rounding_step(x, g) if round_before_gain else None
    assert_rms_close(got, want, carried)


@pytest.mark.parametrize("d,dtype", [(50, np.float32), (1001, jnp.bfloat16),
                                     (2048, jnp.bfloat16)])
def test_plain_r_is_the_kernels_chain(d, dtype):
    """``_kernel_r`` against a literal, element-by-element walk of the
    kernel's threads in float32: the same r, bit for bit."""
    x = _t(_inputs(2, d, dtype)[0])
    n = 16 // x.element_size()
    got = K6._kernel_r(x, 1e-5)[:, 0].numpy()
    f = np.float32
    for row in range(x.shape[0]):
        xs = x[row].float().numpy()
        ss = np.zeros(256, f)
        for t in range(256):
            for j in range(t * n, d, 256 * n):
                for i in range(n):
                    v = xs[j + i] if j + i < d else f(0)
                    ss[t] = f(ss[t] + f(v * v))
        for off in (16, 8, 4, 2, 1):
            ss = (ss + ss[np.arange(256) ^ off]).astype(f)
        total = f(0)
        for w in range(8):
            total = f(total + ss[32 * w])
        arg = f(f(total / f(d)) + f(1e-5))
        assert got[row] == f(1.0 / np.sqrt(np.float64(arg))), row


@pytest.mark.parametrize("rows,d,dtype", SHAPES)
def test_the_flag_only_matters_below_float32(rows, d, dtype):
    x, g = (_t(a) for a in _inputs(rows, d, dtype))
    one = rmsnorm_ref(x, g, round_before_gain=False)
    two = rmsnorm_ref(x, g, round_before_gain=True)
    if x.dtype == torch.float32:
        assert torch.equal(one, two)  # x·r·g in float32 either way
    else:
        assert_rms_close(one, two)  # one extra rounding: at most one ulp
        assert not torch.equal(one, two)  # and it shows on these inputs


def test_op_dispatches_cpu_to_plain_without_launches():
    x, g = (_t(a) for a in _inputs(16, 128, jnp.bfloat16))
    before = ops.launch_counts()
    out = ops.rmsnorm_op(x.reshape(2, 8, 128), g, 1e-5,
                         round_before_gain=True)
    assert ops.launch_counts() == before
    assert "rmsnorm" in before
    assert torch.equal(out.reshape(16, 128),
                       K6.rmsnorm_plain(x, g, 1e-5, round_before_gain=True))


def test_plain_keeps_float64_and_rejects_bad_operands():
    x = torch.randn(3, 8, dtype=torch.float64)
    g = torch.randn(8, dtype=torch.float64)
    want = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-5) * g
    torch.testing.assert_close(K6.rmsnorm_plain(x, g), want, rtol=1e-14,
                               atol=1e-14)
    with pytest.raises(TypeError, match="gain dtype"):
        K6.rmsnorm_plain(x, g.float())
    with pytest.raises(ValueError, match="x \\[..., D\\] and g \\[D\\]"):
        K6.rmsnorm_plain(x, g[:4])
    with pytest.raises(ValueError, match="CUDA device"):
        K6.rmsnorm_cuda(x.float(), g.float())
