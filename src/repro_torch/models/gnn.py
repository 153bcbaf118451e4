"""GCN + GAT on the port's distributed kernels: forward, loss, training.

Port of ``repro/models/gnn.py``. Full-batch GCN: each layer is ``H' =
act(Â · (H W + b))`` where Â is the normalized adjacency, and the
aggregation is the distributed SpMM of a ``compile_spmm`` handle (through
``make_spmm_fn``). GAT: per-edge attention is an SDDMM on the adjacency
pattern (``e_ij = leaky_relu(a_ij · q_i · k_j)`` for stored edges only)
and the aggregation is the SpMM of those edge scores with the value
features — ``H' = leaky_relu(A ⊙ (Q Kᵀ)) @ V`` — served by one
``kernel="fused"`` handle, so both phases share a single communication
phase. The attention is the reference's unnormalized form (no per-row
softmax). Requires a square adjacency (Q/K/V all index the same nodes).

Both forwards are differentiable through the handles (coo, on every tier;
see ``kernels.ops``), so ``gcn_loss`` / ``gat_loss`` train with
``loss.backward()`` and ``optim.adamw``. On a ``Topology.multiprocess``
fleet the same calls train across processes: each process holds the
dense weights whole, its rows of the features and of C, and a loss that
is its share of the global mean (its rows' terms over N); after
``backward()`` the handle's ``comm.reduce_grads(params)`` sums the
weight gradients over the processes in process order, so every process
steps to the same bits. A caller that only infers runs
under ``torch.no_grad()`` (a bsr SpMM or fused call under grad raises, as
the reference has no JVP for it).

Weights carry over from the reference as numpy: ``gcn_from_numpy`` /
``gat_from_numpy`` take the list of per-layer dicts ``GCN.init`` /
``GAT.init`` return there (arrays converted with ``np.asarray``) and build
the port's module with the same values; ``to_numpy`` gives them back in
that layout. ``gcn_params`` / ``gat_params`` draw weights in that layout
and scale from a numpy seed.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.sparse import COOMatrix, CSRMatrix, csr_from_coo

__all__ = ["normalize_adjacency", "GCN", "gcn_forward", "gcn_loss",
           "gcn_from_numpy", "gcn_params", "GAT", "gat_forward", "gat_loss",
           "gat_from_numpy", "gat_params"]

SpmmFn = Callable[[torch.Tensor], torch.Tensor]
FusedFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
Params = List[Dict[str, np.ndarray]]


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


def _ladder(feat_dim: int, hidden: int, n_classes: int, n_layers: int
            ) -> List[int]:
    return [feat_dim] + [hidden] * (n_layers - 1) + [n_classes]


def gcn_params(dims: Sequence[int], seed: int = 0) -> Params:
    """numpy weights in ``GCN.init``'s layout and scale: per layer ``w``
    [d_in, d_out] ~ N(0, 1)·d_in^-½ and a zero ``b``."""
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d_in, d_out)) * d_in ** -0.5
                   ).astype(np.float32),
             "b": np.zeros(d_out, np.float32)}
            for d_in, d_out in zip(dims[:-1], dims[1:])]


def gat_params(dims: Sequence[int], att_dim: int, seed: int = 0) -> Params:
    """numpy weights in ``GAT.init``'s layout and scale: per layer ``wq``
    / ``wk`` [d_in, att_dim], ``wv`` [d_in, d_out], all N(0, 1)·d_in^-½,
    and a zero ``b``."""
    rng = np.random.default_rng(seed)
    out = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        layer = {name: (rng.standard_normal((d_in, width)) * d_in ** -0.5
                        ).astype(np.float32)
                 for name, width in (("wq", att_dim), ("wk", att_dim),
                                     ("wv", d_out))}
        layer["b"] = np.zeros(d_out, np.float32)
        out.append(layer)
    return out


class _Layers(nn.Module):
    """The per-layer parameter dicts both models keep, in the reference's
    layout (``NAMES`` per layer)."""

    NAMES: tuple = ()

    def load_numpy(self, params: Sequence[Mapping[str, np.ndarray]]):
        """Copy the reference's per-layer arrays in (shapes checked)."""
        if len(params) != len(self.layers):
            raise ValueError(f"{len(params)} parameter dicts for "
                             f"{len(self.layers)} layers")
        with torch.no_grad():
            for i, (layer, lp) in enumerate(zip(self.layers, params)):
                for name in self.NAMES:
                    dst = getattr(layer, name)
                    src = torch.from_numpy(np.asarray(lp[name], np.float32))
                    if tuple(src.shape) != tuple(dst.shape):
                        raise ValueError(
                            f"layer {i} {name}: shape {tuple(src.shape)}, "
                            f"the model wants {tuple(dst.shape)}")
                    dst.copy_(src)
        return self

    def to_numpy(self) -> Params:
        """The parameters as the reference's per-layer dicts (float32)."""
        return [{name: getattr(layer, name).detach().float().cpu().numpy()
                 for name in self.NAMES} for layer in self.layers]


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype))


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------


class GCNLayer(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.w = _param((d_in, d_out), device, dtype)
        self.b = _param((d_out,), device, dtype)


class GCN(_Layers):
    """A full-batch GCN whose aggregation is a SHIRO SpMM (``gcn_forward``).

    The layer widths are the reference's: ``feat_dim`` → ``hidden`` (×
    ``n_layers - 1``) → ``n_classes``. Parameters start at zero;
    ``load_numpy`` / ``gcn_from_numpy`` set them from the reference's
    ``GCN.init`` layout.
    """

    NAMES = ("w", "b")

    def __init__(self, n_nodes: int, feat_dim: int, hidden: int,
                 n_classes: int, n_layers: int = 2, *,
                 device: Union[str, torch.device] = "cuda",
                 dtype=torch.float32):
        super().__init__()
        self.n_nodes = int(n_nodes)
        dims = _ladder(feat_dim, hidden, n_classes, n_layers)
        self.layers = nn.ModuleList(
            GCNLayer(dims[i], dims[i + 1], device=device, dtype=dtype)
            for i in range(n_layers))

    def forward(self, feats: torch.Tensor, spmm_fn: SpmmFn) -> torch.Tensor:
        return gcn_forward(self, feats, spmm_fn)


def _from_numpy(cls, params, n_nodes, device, wide: str, **kw):
    """A ``cls`` with the widths read off ``params`` (``wide`` names the
    [d_in, d_out] array of a layer) and their values."""
    if not params:
        raise ValueError(f"a {cls.__name__} needs at least one layer")
    dims = [int(np.shape(lp[wide])[0]) for lp in params]
    dims.append(int(np.shape(params[-1][wide])[1]))
    hidden = dims[1] if len(params) > 1 else dims[-1]
    model = cls(n_nodes, dims[0], hidden, dims[-1], n_layers=len(params),
                device=device, **kw)
    for i, layer in enumerate(model.layers):
        if getattr(layer, wide).shape[1] != dims[i + 1]:
            raise ValueError(f"layer {i} widths {dims} are not the "
                             f"{cls.__name__}'s feat → hidden → classes "
                             f"ladder")
    return model.load_numpy(params)


def gcn_from_numpy(params: Sequence[Mapping[str, np.ndarray]],
                   n_nodes: int = 0, *,
                   device: Union[str, torch.device] = "cuda") -> GCN:
    """The port's GCN with the reference's weights (``GCN.init`` output as
    numpy arrays) on ``device``; the widths are read off the arrays."""
    return _from_numpy(GCN, params, n_nodes, device, "w")


def gcn_forward(model: GCN, feats: torch.Tensor, spmm_fn: SpmmFn
                ) -> torch.Tensor:
    """spmm_fn(H) -> Â·H (a SHIRO handle through ``make_spmm_fn``, or any
    closure with that contract)."""
    h = feats
    n = len(model.layers)
    for i, layer in enumerate(model.layers):
        h = spmm_fn(h @ layer.w + layer.b)
        if i < n - 1:
            h = torch.relu(h)
    return h


def _fleet_handle(fn):
    """The handle behind ``fn`` (a ``DistSpmm``, or ``make_spmm_fn``'s
    closure over one) when it runs on a fleet of processes; else None."""
    h = fn if hasattr(fn, "row_blocks") else getattr(fn, "handle", None)
    if h is not None and h.topology.is_multiprocess:
        return h
    return None


def _xent(logits: torch.Tensor, labels: torch.Tensor, fleet=None
          ) -> torch.Tensor:
    """mean(logsumexp(logits) - logits[label]) in float32 or wider; the
    gold logit through a one-hot product (exact: one nonzero term).

    On a fleet (``fleet``: the handle whose C rows ``logits`` are) the
    mean is over the GLOBAL node count: this process's share, the sum of
    its rows' terms over N, with the labels of the rows
    ``fleet.row_blocks()`` names (``labels`` whole, or those rows
    already). The shares' sum over the processes is the loss, and each
    process's ``backward()`` of its share gives the gradient of that sum
    (the exchanges carry the other processes' parts)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    if fleet is not None and labels.shape[0] != logits.shape[0]:
        labels = torch.cat([labels[s:e] for s, e in fleet.row_blocks()])
    logz = torch.logsumexp(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    terms = logz - (logits * onehot).sum(-1)
    if fleet is None:
        return torch.mean(terms)
    return terms.sum() / fleet.plan.shape[0]


def gcn_loss(model: GCN, feats: torch.Tensor, labels: torch.Tensor,
             spmm_fn: SpmmFn) -> torch.Tensor:
    """Mean cross-entropy of the GCN's logits against ``labels`` (on a
    fleet, this process's share of it: ``_xent``)."""
    return _xent(gcn_forward(model, feats, spmm_fn), labels,
                 _fleet_handle(spmm_fn))


# ---------------------------------------------------------------------------
# GAT
# ---------------------------------------------------------------------------


class GATLayer(nn.Module):
    """One layer's projections: queries/keys (width ``att_dim``) and values
    (the layer's output width, plus a bias)."""

    def __init__(self, d_in: int, d_out: int, att_dim: int, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.wq = _param((d_in, att_dim), device, dtype)
        self.wk = _param((d_in, att_dim), device, dtype)
        self.wv = _param((d_in, d_out), device, dtype)
        self.b = _param((d_out,), device, dtype)


class GAT(_Layers):
    """A GAT served by one fused handle per call (``gat_forward``).

    The layer widths are the reference's: ``feat_dim`` → ``hidden`` (×
    ``n_layers - 1``) → ``n_classes``, with ``att_dim``-wide attention.
    Parameters start at zero; ``load_numpy`` / ``gat_from_numpy`` set
    them from the reference's ``GAT.init`` layout.
    """

    NAMES = ("wq", "wk", "wv", "b")

    def __init__(self, n_nodes: int, feat_dim: int, hidden: int,
                 n_classes: int, n_layers: int = 2, att_dim: int = 16, *,
                 device: Union[str, torch.device] = "cuda",
                 dtype=torch.float32):
        super().__init__()
        self.n_nodes = int(n_nodes)
        self.att_dim = int(att_dim)
        dims = _ladder(feat_dim, hidden, n_classes, n_layers)
        self.layers = nn.ModuleList(
            GATLayer(dims[i], dims[i + 1], att_dim, device=device,
                     dtype=dtype) for i in range(n_layers))

    def forward(self, feats: torch.Tensor, fused_fn: FusedFn) -> torch.Tensor:
        return gat_forward(self, feats, fused_fn)


def gat_from_numpy(params: Sequence[Mapping[str, np.ndarray]],
                   n_nodes: int = 0, *,
                   device: Union[str, torch.device] = "cuda") -> GAT:
    """The port's GAT with the reference's weights (``GAT.init`` output as
    numpy arrays) on ``device``; the widths are read off the arrays."""
    if not params:
        raise ValueError("a GAT needs at least one layer")
    return _from_numpy(GAT, params, n_nodes, device, "wv",
                       att_dim=int(np.shape(params[0]["wq"])[1]))


def gat_forward(model: GAT, feats: torch.Tensor, fused_fn: FusedFn
                ) -> torch.Tensor:
    """fused_fn(q, k, v) -> edge(A ⊙ (q kᵀ)) @ v — one comm phase/layer.

    ``fused_fn`` is a fused DistSpmm handle (or any closure with that
    contract); the edge nonlinearity lives in the handle.
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


def gat_loss(model: GAT, feats: torch.Tensor, labels: torch.Tensor,
             fused_fn: FusedFn) -> torch.Tensor:
    """Mean cross-entropy of the GAT's logits against ``labels`` (on a
    fleet, this process's share of it: ``_xent``)."""
    return _xent(gat_forward(model, feats, fused_fn), labels,
                 _fleet_handle(fused_fn))
