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


# and smollm's width and d_ff at the rows of a few tokens
PARITY_SHAPES = SHAPES + [(16, 576, jnp.bfloat16), (8, 1536, jnp.bfloat16)]


@pytest.mark.parametrize("rows,d,dtype", PARITY_SHAPES)
def test_ref_matches_pallas_kernel(rows, d, dtype):
    x, g = _inputs(rows, d, dtype)
    want = _t(rmsnorm_pallas(x, g, interpret=True, br=8))
    got = rmsnorm_ref(_t(x), _t(g), round_before_gain=False)
    assert_rms_close(got, want)
    assert_rms_close(K6.rmsnorm_plain(_t(x), _t(g)), got)


@pytest.mark.parametrize("rows,d,dtype", PARITY_SHAPES)
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


FWD_WIDTHS = (50, 576, 1001, 1536, 2048, 4096, 8192)


def test_fwd_layout_fixes_lanes():
    """``_fwd_layout``: the smallest power of two from 32 to 256 whose
    lanes hold a row in four 16-byte chunks each (8 bfloat16 or 4 float32
    elements a chunk); 256 past that, where the wide kernel takes the row
    (bfloat16 D > 8192, float32 D > 4096)."""
    L = K6._fwd_layout
    assert [L(d, 2) for d in FWD_WIDTHS] == [32, 32, 32, 64, 64, 128, 256]
    assert [L(d, 4) for d in FWD_WIDTHS] == [32, 64, 64, 128, 128, 256, 256]

    def wide(d, es):
        return -(-(-(-d // (16 // es))) // L(d, es)) > K6.HELD

    assert [d for d in FWD_WIDTHS + (4100, 8200) if wide(d, 2)] == [8200]
    assert [d for d in FWD_WIDTHS + (4100, 8200) if wide(d, 4)] == \
        [8192, 4100, 8200]
    assert not wide(4096, 4) and L(4097, 4) == 256 and wide(4097, 4)
    assert not wide(8192, 2) and wide(8193, 2)
    # the backward takes the same lanes
    for d in FWD_WIDTHS:
        for es in (2, 4):
            assert K6._bwd_layout(1024, d, es)[0] == L(d, es)


def _lane_group_r(x: torch.Tensor, lanes: int, eps: float = 1e-5):
    """r per row of x [R, D] as the rows kernel forms it on ``lanes``
    lanes a row, walked in float32: lane l holds chunks c = k·lanes + l
    (k < 4) and keeps one sum for each of the 256-thread block's threads
    t = l + m·lanes it stands for (chunk c: thread c mod 256, step c div
    256), adding its squares in (step, element) order; one xor butterfly
    per virtual warp q + m·lanes/32 (32 consecutive lanes of the group's
    warp q) that holds a chunk; the 8 warp sums in ascending order, the
    empty ones skipped."""
    f = np.float32
    n = 16 // x.element_size()
    rows, d = x.shape
    nvec = -(-d // n)
    assert -(-nvec // lanes) <= K6.HELD
    virt = 256 // lanes
    v = min(K6.HELD, virt)
    xs = x.float().numpy()
    out = np.zeros(rows, f)
    for row in range(rows):
        vs = np.zeros((lanes, v), f)  # [lane, virtual thread m]
        for lane in range(lanes):
            for k in range(K6.HELD):
                c = k * lanes + lane
                if c >= nvec:
                    continue
                t, s = c % 256, c // 256
                assert (t, s) == (lane + (k % virt) * lanes, k // virt)
                for i in range(n):
                    e = xs[row, c * n + i] if c * n + i < d else f(0)
                    vs[lane, k % virt] = f(vs[lane, k % virt] + f(e * e))
        warps = lanes // 32
        wsum = np.zeros((warps, v), f)
        idx = np.arange(32)
        for q in range(warps):
            for m in range(v):
                if 32 * q + m * lanes >= nvec:
                    continue  # holds no chunk: +0.0
                w = vs[32 * q:32 * q + 32, m].copy()
                for off in (16, 8, 4, 2, 1):
                    w = (w + w[idx ^ off]).astype(f)
                assert (w == w[0]).all()
                wsum[q, m] = w[0]
        total = f(0)
        for m in range(v):
            for q in range(warps):  # block warp q + m·warps, ascending
                total = f(total + wsum[q, m])
        arg = f(f(total / f(d)) + f(eps))
        out[row] = f(1.0 / np.sqrt(np.float64(arg)))
    return out


LANE_CASES = [(lanes, d, dtype) for lanes in (32, 64, 128, 256)
              for d in FWD_WIDTHS for dtype in (np.float32, jnp.bfloat16)
              if -(-(-(-d // (4 if dtype == np.float32 else 8))) // lanes)
              <= 4]


@pytest.mark.parametrize("lanes,d,dtype", LANE_CASES, ids=str)
def test_lane_groups_keep_the_256_thread_r(lanes, d, dtype):
    """The rows kernel's sum of squares on any lanes that hold the row is
    the 256-thread block's chain: the walk of ``_lane_group_r`` gives
    ``_kernel_r``'s r bit for bit, for rows of ordinary, large and tiny
    magnitudes."""
    x = _t(_inputs(3, d, dtype)[0])
    x[1] *= 1e4
    x[2] *= 1e-3
    want = K6._kernel_r(x, 1e-5)[:, 0].numpy()
    assert np.array_equal(_lane_group_r(x, lanes), want)


def test_new_r_hands_out_each_tensor_once():
    """``_new_r``: float32 tensors of x's leading shape, R_BATCH from one
    allocation, no two of them sharing an element; another shape or
    stream gets its own batch, and the batch lives on in the views
    handed out."""
    K6._R_VIEWS.clear()
    x = torch.zeros((2, 3, 8), dtype=torch.bfloat16)
    rs = [K6._new_r(x, 7) for _ in range(K6.R_BATCH + 1)]
    assert all(r.shape == (2, 3) and r.dtype == torch.float32 for r in rs)
    spans = sorted((r.data_ptr(), r.data_ptr() + r.numel() * 4) for r in rs)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    for i, r in enumerate(rs):
        r.fill_(float(i))
    assert all(bool((r == i).all()) for i, r in enumerate(rs))
    other = K6._new_r(torch.zeros((5, 8)), 7)
    assert other.shape == (5,)
    assert K6._new_r(x, 8).data_ptr() not in {r.data_ptr() for r in rs}
    K6._R_VIEWS.clear()
    assert bool((rs[0] == 0).all()) and bool((rs[-1] == K6.R_BATCH).all())


@pytest.mark.parametrize("rows,d,dtype", SHAPES + [
    (7, 50, np.float32), (5, 1001, jnp.bfloat16)])
@pytest.mark.parametrize("round_before_gain", [False, True])
def test_plain_returns_the_kernels_r(rows, d, dtype, round_before_gain):
    """``return_r``: y the same bits as without it, r [rows] float32 ==
    ``_kernel_r`` (the forward's chain), for a 3-d x too."""
    x, g = (_t(a) for a in _inputs(rows, d, dtype))
    y = K6.rmsnorm_plain(x, g, round_before_gain=round_before_gain)
    y2, r = K6.rmsnorm_plain(x, g, round_before_gain=round_before_gain,
                             return_r=True)
    assert torch.equal(y2, y)
    assert r.dtype == torch.float32 and r.shape == (rows,)
    assert torch.equal(r, K6._kernel_r(x, 1e-5)[:, 0])
    y3, r3 = K6.rmsnorm_plain(x[None], g, return_r=True,
                              round_before_gain=round_before_gain)
    assert torch.equal(y3[0], y) and torch.equal(r3[0], r)


# (rows, d, dtype): the LM training shapes, rows around the chunk and
# group edges of _bwd_layout, widths the lanes hold at 256 lanes and past
# them (the wide kernel)
BWD_CASES = [(1024, 2048, torch.bfloat16), (2048, 576, torch.bfloat16),
             (133, 576, torch.float32), (1057, 40, torch.float32),
             (529, 2048, torch.float32), (3, 4104, torch.bfloat16),
             (3, 4104, torch.float32), (5, 8200, torch.bfloat16),
             (7, 50, torch.bfloat16)]


def _bwd_inputs(rows, d, dtype, seed=0):
    rng = np.random.default_rng(seed + rows * d)
    x, dy = (torch.from_numpy(rng.standard_normal((rows, d)).astype(
        np.float32)).to(dtype) for _ in range(2))
    g = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(dtype)
    return x, g, dy


def test_bwd_layout_fixes_lanes_groups_and_chunks():
    """``_bwd_layout``: the smallest lane count whose lanes hold a row in
    four 16-byte chunks, 256 / lanes rows at once, chunks a multiple of
    the groups near rows / 132; the LM training shapes fill 128 blocks."""
    L = K6._bwd_layout
    assert L(1024, 2048, 2) == (64, 4, 8)  # olmoe-train: 128 blocks
    assert L(2048, 576, 2) == (32, 8, 16)  # smollm-train: 128 blocks
    assert L(1024, 2048, 4) == (128, 2, 8)
    assert L(1, 40, 4) == (32, 8, 8)
    assert [L(n, 40, 4)[2] for n in (1056, 1057, 2112, 2113)] == \
        [8, 16, 16, 24]
    assert [L(n, 1024, 4)[2] for n in (528, 529)] == [4, 8]  # 64 lanes
    assert [L(n, 8192, 2)[2] for n in (132, 133)] == [1, 2]  # 256 lanes
    held = 256 * K6.HELD  # 16-byte chunks the lanes of a block hold
    for es in (2, 4):
        n = 16 // es
        assert L(1, held * n, es)[0] == 256
        assert L(1, held * n // 2, es)[0] == 128
        assert L(1, held * n + n, es)[:2] == (256, 1)  # the wide kernel


@pytest.mark.parametrize("lanes", [32, 64, 128, 256])
@pytest.mark.parametrize("d,dtype", [(40, torch.float32),
                                     (576, torch.bfloat16),
                                     (2050, torch.float32)])
def test_bwd_row_sum_is_the_lanes_chain(lanes, d, dtype):
    """``_chain_sum`` with the backward's lanes against a literal walk of
    them in float32: lane t adds its elements (c·lanes + t)·n + i in (c,
    i) order, xor butterflies fold each warp, the warp sums are added in
    order from 0 — the same bits."""
    x = _bwd_inputs(3, d, dtype)[0].float()
    n = 16 // torch.empty((), dtype=dtype).element_size()
    got = K6._chain_sum(x * x, n, lanes).numpy()
    f = np.float32
    for row in range(x.shape[0]):
        t2 = (x[row] * x[row]).numpy()
        ss = np.zeros(lanes, f)
        for t in range(lanes):
            for j in range(t * n, d, lanes * n):
                for i in range(n):
                    ss[t] = f(ss[t] + (t2[j + i] if j + i < d else f(0)))
        for off in (16, 8, 4, 2, 1):
            idx = np.arange(lanes)
            ss = (ss + ss[(idx // 32) * 32 + ((idx % 32) ^ off)]).astype(f)
        total = f(0)
        for w in range(lanes // 32):
            total = f(total + ss[32 * w])
        assert got[row] == total, row


@pytest.mark.parametrize("rows,d", [(1, 40), (9, 40), (133, 40),
                                    (1057, 40), (30, 2048)])
def test_bwd_plain_dg_is_the_groups_and_chunks_chain(rows, d):
    """dg against a literal walk of the kernel's fold: each group adds its
    rows of a chunk (first + it·groups + k) in ascending order from 0, the
    groups are added in order from 0 into the chunk's partial row, the
    partials in ascending chunk order from 0 — the same bits."""
    x, g, dy = _bwd_inputs(rows, d, torch.float32)
    _, dg = K6.rmsnorm_bwd_plain(x, g, dy, round_before_gain=True)
    lanes, groups, chunk = K6._bwd_layout(rows, d, 4)
    prod = (dy * (x * K6._kernel_r(x, 1e-5))).numpy()
    f = np.float32
    want = np.zeros(d, f)
    for first in range(0, rows, chunk):
        part = np.zeros(d, f)
        for k in range(groups):
            acc = np.zeros(d, f)
            for row in range(first + k, min(first + chunk, rows), groups):
                acc = (acc + prod[row]).astype(f)
            part = (part + acc).astype(f)
        want = (want + part).astype(f)
    assert np.array_equal(dg.numpy(), want)


@pytest.mark.parametrize("rows,d,dtype", BWD_CASES, ids=str)
@pytest.mark.parametrize("round_before_gain", [False, True])
def test_bwd_plain_with_saved_r_equals_without(rows, d, dtype,
                                               round_before_gain):
    """The forward's r handed to the backward gives the bits of the
    backward that forms r itself in the forward's chain."""
    x, g, dy = _bwd_inputs(rows, d, dtype)
    _, r = K6.rmsnorm_plain(x, g, round_before_gain=round_before_gain,
                            return_r=True)
    want = K6.rmsnorm_bwd_plain(x, g, dy, round_before_gain=round_before_gain)
    got = K6.rmsnorm_bwd_plain(x, g, dy, round_before_gain=round_before_gain,
                               r=r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("rows,d,dtype", [(133, 576, torch.bfloat16),
                                          (1057, 40, torch.float32),
                                          (3, 4104, torch.float32)], ids=str)
def test_rmsnorm_op_backward_on_cpu_is_the_plain_chain(rows, d, dtype):
    """``_RmsNorm`` on the CPU: the forward hands its r to the backward,
    whose dx and dg are ``rmsnorm_bwd_plain``'s bits."""
    x, g, dy = _bwd_inputs(rows, d, dtype)
    xa, ga = x.clone().requires_grad_(), g.clone().requires_grad_()
    y = ops.rmsnorm_op(xa.view(1, rows, d), ga, 1e-5, round_before_gain=True)
    assert torch.equal(y.detach()[0], K6.rmsnorm_plain(
        x, g, 1e-5, round_before_gain=True))
    y.backward(dy.view(1, rows, d))
    dx, dg = K6.rmsnorm_bwd_plain(x, g, dy, 1e-5, round_before_gain=True)
    assert torch.equal(xa.grad, dx) and torch.equal(ga.grad, dg)


def test_plain_float64_r_and_backward_take_the_saved_r():
    """float64 (the reference runs): r in x's dtype, and the backward with
    it equals the backward without it."""
    x, g, dy = (torch.randn(4, 24, dtype=torch.float64) for _ in range(3))
    g = g[0]
    _, r = K6.rmsnorm_plain(x, g, return_r=True)
    assert r.dtype == torch.float64 and r.shape == (4,)
    want = K6.rmsnorm_bwd_plain(x, g, dy)
    got = K6.rmsnorm_bwd_plain(x, g, dy, r=r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
