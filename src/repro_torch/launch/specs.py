"""Shape suite and input stand-ins for every (arch × shape) cell.

Port of ``repro/launch/specs.py``. The four input shapes:
  train_4k     seq 4096  × global_batch 256  → train_step
  prefill_32k  seq 32768 × global_batch 32   → prefill (serve) step
  decode_32k   seq 32768 × global_batch 128  → decode step (1 new token,
                                               cache length = seq)
  long_500k    seq 524288 × global_batch 1   → decode step; SUB-QUADRATIC
               ONLY (ssm/hybrid); full-attention archs are SKIPped.

The counterpart of ``jax.eval_shape`` is the ``meta`` device: the
abstract trees come from the same ``init_params`` / ``adamw_init`` /
``init_decode_cache`` that build the real ones, on ``device="meta"``, so
nothing is drawn or allocated for the full configs (the dry-run
contract), and ``input_specs`` returns meta tensors as the stand-ins.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..models.config import ModelConfig
from ..models.transformer import DecodeCache, init_decode_cache, init_params
from ..optim.adamw import adamw_init

__all__ = ["SHAPES", "ShapeSpec", "cell_status", "input_specs",
           "abstract_params", "abstract_opt_state", "abstract_cache"]

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_status(cfg: ModelConfig, shape: ShapeSpec) -> str:
    """'run' or 'SKIP(reason)' per the assignment rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "SKIP(full-attention)"
    return "run"


def _sds(shape, dtype) -> torch.Tensor:
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return torch.empty(tuple(shape), dtype=dt, device=META)


def abstract_params(cfg: ModelConfig) -> Any:
    return init_params(cfg, None, device=META)


def abstract_opt_state(cfg: ModelConfig) -> Any:
    return adamw_init(abstract_params(cfg))


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int
                   ) -> DecodeCache:
    return init_decode_cache(cfg, batch, max_len, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Model-input stand-ins for one cell (excluding params/opt/cache)."""
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    if shape.mode in ("train", "prefill"):
        s_tok = s
        out: Dict[str, Any] = {}
        if cfg.family == "encdec":
            out["enc_embeds"] = _sds((b, cfg.frontend_len, d), cfg.dtype)
        elif cfg.frontend is not None:
            # modality prefix counts toward the sequence budget
            s_tok = max(s - cfg.frontend_len, 1)
            out["prefix_embeds"] = _sds((b, cfg.frontend_len, d), cfg.dtype)
        out["tokens"] = _sds((b, s_tok), torch.int32)
        return out
    # decode: one new token; cache sized to hold seq_len + 1
    return {"token": _sds((b, 1), torch.int32)}
