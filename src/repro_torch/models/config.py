"""Model configuration for every assigned architecture family.

A copy of ``repro/models/config.py`` (pure data, no JAX in it), so the
port imports nothing of the JAX package. The port runs the ``dense``,
``moe`` and ``ssm`` families so far (ROADMAP item 17 holds the rest).

One frozen dataclass covers dense / GQA transformers, MoE, Mamba1/Mamba2
SSMs, the zamba2 hybrid, the seamless enc-dec, and the modality-stub
archs (audio/vlm: the transformer backbone is exact; the frontend supplies
precomputed frame/patch embeddings per the assignment note).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"  # swiglu | gelu
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SHIRO-planned expert-parallel dispatch (token dedup + partial
    # combine pre-aggregation over the hierarchical mesh) — the paper's
    # technique as a first-class feature for MoE archs.
    shiro_dispatch: bool = True
    # Size the (token, rank) activation buffers for the EXPECTED number of
    # unique destination ranks under SHIRO dedup (M·(1-(1-1/M)^k)) instead
    # of the worst-case top_k — a §Perf beyond-paper optimization that
    # shrinks both HBM traffic and all_to_all bytes (EXPERIMENTS.md §Perf).
    shiro_capacity: bool = False
    # Dispatch-buffer dtype for the EP all_to_all (fp8 halves both HBM
    # buffer traffic and collective bytes; compute stays bf16 after the
    # receive — DeepSeek-V3-style). §Perf beyond-paper optimization.
    moe_dispatch_dtype: str = "none"  # none | float8_e4m3fn

    # --- SSM (Mamba1 / Mamba2) ----------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1  # 1 = Mamba1 selective scan, 2 = Mamba2 SSD
    ssm_chunk: int = 128  # chunked-scan length (TPU adaptation)
    ssm_heads: int = 0  # Mamba2 value heads (0 = derive d_inner//64)
    # Mamba2-style fused projections (§Perf beyond-paper variant): compute
    # dt/B/C from the raw block input x (replicated d_model contraction)
    # instead of the conv output xi (sharded d_inner contraction) — this
    # removes the per-layer all-reduce of the dbl tensor under tensor
    # parallelism. Model variant: numerics differ from faithful mamba1.
    ssm_fused_proj: bool = False

    # --- hybrid (zamba2): shared attention block every k SSM blocks ----
    attn_every: int = 0

    # --- enc-dec (seamless) --------------------------------------------
    n_enc_layers: int = 0

    # --- modality frontend stub ----------------------------------------
    frontend: Optional[str] = None  # audio | vision
    frontend_len: int = 0  # frames / patches supplied by the stub

    # --- numerics / distribution ---------------------------------------
    dtype: str = "bfloat16"
    fsdp: bool = False  # additionally shard params over the data axis
    remat: bool = True
    # scan-over-layers keeps HLO O(1) in depth but XLA cost_analysis counts
    # while bodies ONCE; the dry-run compiles unrolled shallow probes
    # (scan_layers=False) to recover exact per-layer roofline terms.
    scan_layers: bool = True
    # Shard the KV-cache LENGTH dimension over the model axis when KV heads
    # cannot be sharded (GQA with few kv heads) — flash-decoding-style
    # sequence parallelism for decode; §Perf beyond-paper optimization.
    kv_seq_shard: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def sub_quadratic(self) -> bool:
        """True when 500k-context decode is feasible (recurrent state)."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (enc-dec has a decoder)

    def params_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.mlp == "swiglu":
            per_mlp = 3 * d * f
        else:
            per_mlp = 2 * d * f
        if self.is_moe:
            per_mlp = self.n_experts * per_mlp + d * self.n_experts
        per_ssm = 0
        if self.is_ssm:
            di, st = self.d_inner, self.ssm_state
            if self.ssm_version == 1:
                per_ssm = 2 * d * di + di * self.ssm_conv + di * (2 * st + d // 16) \
                    + di * st + di + di * d
            else:
                nh = self.ssm_heads or max(di // 64, 1)
                per_ssm = d * (2 * di + 2 * st + nh) + di * self.ssm_conv + di * d
        total = emb
        if self.family == "ssm":
            total += self.n_layers * (per_ssm + 2 * d)
        elif self.family == "hybrid":
            n_attn = self.n_layers // max(self.attn_every, 1)
            total += self.n_layers * (per_ssm + 2 * d)
            total += (per_attn + per_mlp + 2 * d)  # shared attn block (one copy)
            _ = n_attn
        elif self.family == "encdec":
            total += self.n_enc_layers * (per_attn + per_mlp + 2 * d)
            # decoder has self + cross attention
            total += self.n_layers * (2 * per_attn + per_mlp + 3 * d)
        else:
            total += self.n_layers * (per_attn + per_mlp + 2 * d)
        return int(total)

    def active_params_count(self) -> int:
        """Active parameters per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.params_count()
        d, f = self.d_model, self.d_ff
        per_mlp_all = self.n_experts * 3 * d * f
        per_mlp_act = self.top_k * 3 * d * f
        return int(self.params_count() - self.n_layers * (per_mlp_all - per_mlp_act))
