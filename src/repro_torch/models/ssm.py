"""Mamba1 selective scan and Mamba2 SSD blocks.

Port of ``repro/models/ssm.py``: the same chunked scan. A Python loop over
the sequence's chunks of ``cfg.ssm_chunk`` tokens carries the recurrent
state h [B, d_inner, d_state] (Mamba2: [B, heads, head_dim, d_state]);
inside a chunk the recurrence h_t = a_t·h_{t-1} + b_t is a log-depth scan
of the affine maps (a, b) in PyTorch (``_assoc_scan``), so the per-token
expansion [B, Q, d_inner, d_state] exists for one chunk at a time. The
reference's scan is ``jax.lax.associative_scan``, not a Pallas kernel, so
no kernel of the port stands behind it; the projections are
``torch.matmul``. Both scans combine the same maps in different trees, so
the two agree within float32 rounding, not bit for bit. The scan and the
state run in float32 (float64 for a float64 model, the checks' oracle).

Decode is one recurrence update a token: O(1) state, no cache growth.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import normal

__all__ = [
    "SSMState", "init_mamba_params", "mamba_block", "mamba_block_decode",
    "init_ssm_state",
]


@dataclasses.dataclass
class SSMState:
    """Recurrent state for one SSM layer."""

    # mamba1: [B, d_inner, d_state]; mamba2: [B, nh, hd, d_state]
    h: torch.Tensor
    conv: torch.Tensor  # [B, conv_w - 1, d_inner] rolling conv inputs


def _dt_rank(cfg: ModelConfig) -> int:
    return max(cfg.d_model // 16, 1)


def _heads(cfg: ModelConfig) -> int:
    return cfg.ssm_heads or max(cfg.d_inner // 64, 1)


def init_mamba_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype: torch.dtype, device="cuda") -> dict:
    """Random weights with the reference's names, shapes, dtypes and
    scales, drawn from ``gen`` (on ``device``)."""
    d, di, st, cw = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    sc = d ** -0.5
    p = {
        "in_proj_x": normal(gen, (d, di), sc, dtype, device),
        "in_proj_z": normal(gen, (d, di), sc, dtype, device),
        "conv_w": normal(gen, (cw, di), 0.1, dtype, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": normal(gen, (di, d), di ** -0.5, dtype, device),
        "D": torch.ones((di,), dtype=dtype, device=device),
    }
    if cfg.ssm_version == 1:
        dtr = _dt_rank(cfg)
        # the fused variant computes dbl from the block input x
        dbl_in = d if cfg.ssm_fused_proj else di
        a = torch.arange(1, st + 1, dtype=torch.float32, device=device)
        p.update({
            "x_dbl": normal(gen, (dbl_in, dtr + 2 * st), dbl_in ** -0.5,
                            dtype, device),
            "dt_proj": normal(gen, (dtr, di), dtr ** -0.5, dtype, device),
            "dt_bias": torch.zeros((di,), dtype=dtype, device=device),
            "A_log": torch.log(a).expand(di, st).contiguous(),
        })
    else:
        nh = _heads(cfg)
        p.update({
            "bc_proj": normal(gen, (d, 2 * st), sc, dtype, device),
            "dt_proj2": normal(gen, (d, nh), sc, dtype, device),
            "dt_bias": torch.zeros((nh,), dtype=dtype, device=device),
            "A_log": torch.log(torch.full((nh,), 2.0, dtype=torch.float32,
                                          device=device)),
        })
    return p


def _state_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device="cuda") -> SSMState:
    di, st, cw = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    if cfg.ssm_version == 1:
        shape = (batch, di, st)
    else:
        nh = _heads(cfg)
        shape = (batch, nh, di // nh, st)
    return SSMState(
        h=torch.zeros(shape, dtype=_state_dtype(dtype), device=device),
        conv=torch.zeros((batch, cw - 1, di), dtype=dtype, device=device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prepend: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: [B, S, di], w: [cw, di]; the
    taps added in order, as the reference unrolls them."""
    cw, s = w.shape[0], x.shape[1]
    xp = torch.cat([prepend, x], dim=1)  # [B, S+cw-1, di]
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _assoc_scan(da: torch.Tensor, dbx: torch.Tensor, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within-chunk linear recurrence h_t = da_t·h_{t-1} + dbx_t.

    da / dbx: [B, Q, ...] (da may broadcast over the trailing dims);
    h0: [B, ...]. Returns (h_all [B, Q, ...], h_last). h0 is folded into
    the first element, then the affine maps are combined by a
    Hillis–Steele scan: at offset k = 1, 2, 4, … each t ≥ k takes
    (a_{t-k}·a_t, b_t + a_t·b_{t-k}), the reference's ``op(l, r)``. Each
    level builds new tensors (autograd differentiates through it)."""
    first = dbx[:, :1] + da[:, :1] * h0[:, None]
    a, b = da, torch.cat([first, dbx[:, 1:]], dim=1)
    q, k = a.shape[1], 1
    while k < q:
        b = torch.cat([b[:, :k], b[:, k:] + a[:, k:] * b[:, :-k]], dim=1)
        if 2 * k < q:  # the last level's a is not read
            a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return b, b[:, -1]


def _chunks(t: torch.Tensor, q: int):
    return t.split(q, dim=1)


def mamba_block(params: dict, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """Full-sequence Mamba block (training / prefill). x: [B, S, D]."""
    b, s, _ = x.shape
    di, st = cfg.d_inner, cfg.ssm_state
    q = min(cfg.ssm_chunk, s)
    if s % q:
        q = s  # one chunk for odd smoke shapes, as the reference
    f32 = _state_dtype(x.dtype)
    xi = x @ params["in_proj_x"]
    z = x @ params["in_proj_z"]
    xi = _causal_conv(xi, params["conv_w"], params["conv_b"],
                      xi.new_zeros((b, cfg.ssm_conv - 1, di)))
    xi = F.silu(xi)

    ys = []
    if cfg.ssm_version == 1:
        dtr = _dt_rank(cfg)
        dbl = (x if cfg.ssm_fused_proj else xi) @ params["x_dbl"]
        dt = F.softplus(dbl[..., :dtr] @ params["dt_proj"]
                        + params["dt_bias"])
        bmat = dbl[..., dtr:dtr + st]
        cmat = dbl[..., dtr + st:]
        a = -torch.exp(params["A_log"].to(f32))  # [di, st]
        h = torch.zeros((b, di, st), dtype=f32, device=x.device)
        for xc, dtc, bc, cc in zip(*(_chunks(t, q) for t in
                                     (xi, dt, bmat, cmat))):
            da = torch.exp(dtc[..., None].to(f32) * a)  # [B, Q, di, st]
            dbx = (dtc * xc)[..., None].to(f32) * bc[..., None, :].to(f32)
            h_all, h = _assoc_scan(da, dbx, h)
            y = torch.matmul(h_all, cc.to(f32)[..., None])[..., 0]
            ys.append(y.to(x.dtype))
    else:
        nh = _heads(cfg)
        hd = di // nh
        bmat, cmat = (x @ params["bc_proj"]).chunk(2, dim=-1)
        dt = F.softplus(x @ params["dt_proj2"] + params["dt_bias"])
        a = -torch.exp(params["A_log"].to(f32))  # [nh]
        h = torch.zeros((b, nh, hd, st), dtype=f32, device=x.device)
        for xc, dtc, bc, cc in zip(*(_chunks(t, q) for t in
                                     (xi, dt, bmat, cmat))):
            qc = xc.shape[1]
            xh = xc.reshape(b, qc, nh, hd)
            da = torch.exp(dtc.to(f32) * a)[..., None, None]  # [B,Q,nh,1,1]
            dbx = (dtc[..., None] * xh)[..., None].to(f32) \
                * bc[:, :, None, None, :].to(f32)  # [B, Q, nh, hd, st]
            h_all, h = _assoc_scan(da, dbx, h)
            y = torch.matmul(h_all, cc.to(f32)[:, :, None, :, None])[..., 0]
            ys.append(y.reshape(b, qc, di).to(x.dtype))
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + xi * params["D"]
    y = y * F.silu(z)
    return y @ params["out_proj"]


def mamba_block_decode(params: dict, x: torch.Tensor, state: SSMState,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, SSMState]:
    """Single-token decode step. x: [B, 1, D] -> (out [B, 1, D], state)."""
    b = x.shape[0]
    di, st = cfg.d_inner, cfg.ssm_state
    f32 = _state_dtype(x.dtype)
    xi = x @ params["in_proj_x"]  # [B, 1, di]
    z = x @ params["in_proj_z"]
    conv_in = torch.cat([state.conv, xi], dim=1)  # [B, cw, di]
    xi1 = torch.einsum("bcd,cd->bd", conv_in, params["conv_w"]) \
        + params["conv_b"]
    xi1 = F.silu(xi1)  # [B, di]
    new_conv = conv_in[:, 1:]

    if cfg.ssm_version == 1:
        dtr = _dt_rank(cfg)
        dbl = (x[:, 0] if cfg.ssm_fused_proj else xi1) @ params["x_dbl"]
        dt = F.softplus(dbl[..., :dtr] @ params["dt_proj"]
                        + params["dt_bias"])
        bmat = dbl[..., dtr:dtr + st]
        cmat = dbl[..., dtr + st:]
        a = -torch.exp(params["A_log"].to(f32))
        da = torch.exp(dt[..., None].to(f32) * a)  # [B, di, st]
        dbx = (dt * xi1)[..., None].to(f32) * bmat[:, None, :].to(f32)
        h = da * state.h + dbx
        y = torch.matmul(h, cmat.to(f32)[..., None])[..., 0].to(x.dtype)
    else:
        nh = _heads(cfg)
        hd = di // nh
        bmat, cmat = (x[:, 0] @ params["bc_proj"]).chunk(2, dim=-1)
        dt = F.softplus(x[:, 0] @ params["dt_proj2"] + params["dt_bias"])
        a = -torch.exp(params["A_log"].to(f32))
        da = torch.exp(dt.to(f32) * a)  # [B, nh]
        xh = xi1.reshape(b, nh, hd)
        dbx = (dt[..., None] * xh)[..., None].to(f32) \
            * bmat[:, None, None, :].to(f32)
        h = da[..., None, None] * state.h + dbx
        y = torch.matmul(h, cmat.to(f32)[:, None, :, None])[..., 0]
        y = y.reshape(b, di).to(x.dtype)

    y = y + xi1 * params["D"]
    y = y * F.silu(z[:, 0])
    out = (y @ params["out_proj"])[:, None]
    return out, SSMState(h=h, conv=new_conv)
