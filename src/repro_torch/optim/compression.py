"""Error-feedback gradient compression for the data-parallel reduction.

Port of ``repro/optim/compression.py``: the same two schemes, the same
arithmetic in float32, as pure transforms of a gradient tree (a tensor or
nested dicts / lists / tuples of them, dict keys in sorted order as
``optim.adamw`` walks them):

* int8 quantization with one per-tensor scale (``max|g| / 127``) and
  error feedback: the quantization residual is carried to the next step.
  ``torch.round`` rounds half to even, as ``jnp.round`` does;
* top-k sparsification with error feedback (k = ``int(numel · frac)``,
  at least 1). Ties in |g| go to the lower flat index, as ``lax.top_k``
  breaks them: a stable descending sort of |g|, its first k entries.

``*_compress`` returns (compressed form, new residual); ``*_decompress``
rebuilds a dense tensor. ``ef_compress_pytree`` / ``ef_decompress_pytree``
map them over a tree.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .adamw import _leaves, _map, _rebuild

__all__ = ["int8_compress", "int8_decompress", "topk_compress",
           "topk_decompress", "init_residual", "ef_compress_pytree",
           "ef_decompress_pytree"]


def _is_packed(x: Any) -> bool:
    return isinstance(x, dict) and ("q" in x or "idx" in x)


def init_residual(params: Any) -> Any:
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def int8_compress(g: torch.Tensor, residual: torch.Tensor
                  ) -> Tuple[dict, torch.Tensor]:
    gf = g.float() + residual
    scale = gf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_residual = gf - q.float() * scale
    return {"q": q, "scale": scale}, new_residual


def int8_decompress(c: dict, dtype: torch.dtype) -> torch.Tensor:
    return (c["q"].float() * c["scale"]).to(dtype)


def topk_compress(g: torch.Tensor, residual: torch.Tensor,
                  frac: float = 0.01) -> Tuple[dict, torch.Tensor]:
    gf = (g.float() + residual).reshape(-1)
    k = max(1, int(gf.numel() * frac))
    order = torch.sort(gf.abs(), descending=True, stable=True).indices
    idx = order[:k]
    kept = gf[idx]
    new_residual = gf.clone()
    new_residual[idx] = 0.0
    return ({"idx": idx.to(torch.int32), "vals": kept,
             "shape": tuple(g.shape)}, new_residual.reshape(g.shape))


def topk_decompress(c: dict, dtype: torch.dtype) -> torch.Tensor:
    numel = 1
    for n in c["shape"]:
        numel *= int(n)
    flat = torch.zeros(numel, dtype=torch.float32, device=c["vals"].device)
    flat[c["idx"].long()] = c["vals"]
    return flat.reshape(c["shape"]).to(dtype)


def ef_compress_pytree(grads: Any, residuals: Any, scheme: str = "int8",
                       frac: float = 0.01) -> Tuple[Any, Any]:
    if scheme == "int8":
        fn = int8_compress
    else:
        def fn(g, r):
            return topk_compress(g, r, frac)
    outs = [fn(g, r) for g, r in zip(_leaves(grads), _leaves(residuals))]
    return (_rebuild(grads, iter(o[0] for o in outs)),
            _rebuild(grads, iter(o[1] for o in outs)))


def ef_decompress_pytree(comp: Any, like: Any, scheme: str = "int8") -> Any:
    fn = int8_decompress if scheme == "int8" else topk_decompress
    outs = [fn(c, ref.dtype) for c, ref in zip(_leaves(comp, _is_packed),
                                                _leaves(like))]
    return _rebuild(like, iter(outs))
