"""GAT inference on the port's FusedMM handle.

Port of the GAT half of ``repro/models/gnn.py`` (forward only; gradients
and training wait for ROADMAP item 9, and GCN, which the reference only
trains, with them). Per-edge attention is an SDDMM on the adjacency
pattern (``e_ij = leaky_relu(a_ij · q_i · k_j)`` for stored edges only)
and the aggregation is the SpMM of those edge scores with the value
features — ``H' = leaky_relu(A ⊙ (Q Kᵀ)) @ V`` — served by one
``kernel="fused"`` handle, so both phases share a single communication
phase. The attention is the reference's unnormalized form (no per-row
softmax). Requires a square adjacency (Q/K/V all index the same nodes).

Weights carry over from the reference as numpy: ``gat_from_numpy`` takes
the list of per-layer dicts ``GAT.init`` returns there (arrays converted
with ``np.asarray``) and builds the port's module with the same values.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Union

import numpy as np
import torch
from torch import nn

from ..core.sparse import COOMatrix, CSRMatrix, csr_from_coo

__all__ = ["normalize_adjacency", "GAT", "gat_forward", "gat_from_numpy"]

FusedFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def normalize_adjacency(a: CSRMatrix, add_self_loops: bool = True) -> CSRMatrix:
    """Â = D^{-1/2} (A + I) D^{-1/2} (Kipf-Welling)."""
    coo = a.to_coo()
    rows, cols, vals = coo.row, coo.col, np.abs(coo.val)
    if add_self_loops:
        n = a.shape[0]
        rows = np.concatenate([rows, np.arange(n, dtype=np.int32)])
        cols = np.concatenate([cols, np.arange(n, dtype=np.int32)])
        vals = np.concatenate([vals, np.ones(n, np.float32)])
    deg = np.zeros(a.shape[0], np.float64)
    np.add.at(deg, rows, vals)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    vals = vals * dinv[rows] * dinv[cols]
    return csr_from_coo(COOMatrix(a.shape, rows, cols, vals.astype(np.float32)))


class GATLayer(nn.Module):
    """One layer's projections: queries/keys (width ``att_dim``) and values
    (the layer's output width, plus a bias)."""

    def __init__(self, d_in: int, d_out: int, att_dim: int, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wq = nn.Parameter(torch.zeros((d_in, att_dim), **kw))
        self.wk = nn.Parameter(torch.zeros((d_in, att_dim), **kw))
        self.wv = nn.Parameter(torch.zeros((d_in, d_out), **kw))
        self.b = nn.Parameter(torch.zeros((d_out,), **kw))


class GAT(nn.Module):
    """A GAT served by one fused handle per call (``gat_forward``).

    The layer widths are the reference's: ``feat_dim`` → ``hidden`` (×
    ``n_layers - 1``) → ``n_classes``, with ``att_dim``-wide attention.
    Parameters start at zero; ``load_numpy`` / ``gat_from_numpy`` set
    them from the reference's ``GAT.init`` layout.
    """

    def __init__(self, n_nodes: int, feat_dim: int, hidden: int,
                 n_classes: int, n_layers: int = 2, att_dim: int = 16, *,
                 device: Union[str, torch.device] = "cuda",
                 dtype=torch.float32):
        super().__init__()
        self.n_nodes = int(n_nodes)
        self.att_dim = int(att_dim)
        dims = [feat_dim] + [hidden] * (n_layers - 1) + [n_classes]
        self.layers = nn.ModuleList(
            GATLayer(dims[i], dims[i + 1], att_dim, device=device,
                     dtype=dtype) for i in range(n_layers))

    @torch.no_grad()
    def load_numpy(self, params: List[Mapping[str, np.ndarray]]) -> "GAT":
        """Copy the reference's per-layer {"wq", "wk", "wv", "b"} arrays in."""
        if len(params) != len(self.layers):
            raise ValueError(f"{len(params)} parameter dicts for "
                             f"{len(self.layers)} layers")
        for i, (layer, lp) in enumerate(zip(self.layers, params)):
            for name in ("wq", "wk", "wv", "b"):
                dst = getattr(layer, name)
                src = torch.from_numpy(np.asarray(lp[name], np.float32))
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"layer {i} {name}: shape "
                                     f"{tuple(src.shape)}, the model wants "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        return self

    def forward(self, feats: torch.Tensor, fused_fn: FusedFn) -> torch.Tensor:
        return gat_forward(self, feats, fused_fn)


def gat_from_numpy(params: List[Mapping[str, np.ndarray]],
                   n_nodes: int = 0, *,
                   device: Union[str, torch.device] = "cuda") -> GAT:
    """The port's GAT with the reference's weights (``GAT.init`` output as
    numpy arrays) on ``device``; the widths are read off the arrays."""
    if not params:
        raise ValueError("a GAT needs at least one layer")
    dims = [int(np.shape(lp["wv"])[0]) for lp in params]
    dims.append(int(np.shape(params[-1]["wv"])[1]))
    hidden = dims[1] if len(params) > 1 else dims[-1]
    model = GAT(n_nodes, dims[0], hidden, dims[-1], n_layers=len(params),
                att_dim=int(np.shape(params[0]["wq"])[1]), device=device)
    for i, layer in enumerate(model.layers):
        if layer.wv.shape[1] != dims[i + 1]:
            raise ValueError(f"layer {i} widths {dims} are not the GAT's "
                             f"feat → hidden → classes ladder")
    return model.load_numpy(params)


@torch.no_grad()
def gat_forward(model: GAT, feats: torch.Tensor, fused_fn: FusedFn
                ) -> torch.Tensor:
    """fused_fn(q, k, v) -> edge(A ⊙ (q kᵀ)) @ v — one comm phase/layer.

    ``fused_fn`` is a fused DistSpmm handle (or any closure with that
    contract); the edge nonlinearity lives in the handle. Inference only:
    runs without autograd.
    """
    h = feats
    n = len(model.layers)
    for i, layer in enumerate(model.layers):
        q = h @ layer.wq
        k = h @ layer.wk
        v = h @ layer.wv + layer.b
        h = fused_fn(q, k, v)
        if i < n - 1:
            h = torch.relu(h)
    return h
