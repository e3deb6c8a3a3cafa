"""Graph utilities for the MMRec family (port of
``segmminterest_tpu/mmrec/graph.py``).

Behavioral spec: reference SkipPredBaseline/MMRec/src/models/freedom.py
(get_norm_adj_mat :135-159, get_knn_adj_mat :84-101,
compute_normalized_laplacian :126-133, pre_epoch_processing :161-176).

The host functions (``bipartite_norm_edges``, ``knn_item_graph``,
``global_weighted_knn_graph``) are numpy, call for call the JAX package's,
so their edges and values are the same bits. The message passing is
``index_add`` over static edge arrays on the tensors' device: the same
edges give the same sums up to the order of the additions (atomic on the
card); the gathers are ``index_select``, whose gradient is an ``index_add``
too (an indexed read's would sort its indices on the card).
``knn_edges_device`` and ``global_weighted_knn_graph_device`` build
the global kNN graphs row-chunked on the device (``x @ x.T`` and
``torch.topk``); LATTICE's frozen graph is built there, since the host
function is quadratic in the items.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def bipartite_norm_edges(users: np.ndarray, items: np.ndarray,
                         n_users: int, n_items: int):
    """Symmetric-normalized bipartite adjacency as (edge_u, edge_i, value):
    value = 1/sqrt(deg_u * deg_i) (get_norm_adj_mat)."""
    du = np.bincount(users, minlength=n_users).astype(np.float64) + 1e-7
    di = np.bincount(items, minlength=n_items).astype(np.float64) + 1e-7
    values = 1.0 / np.sqrt(du[users] * di[items])
    return (users.astype(np.int32), items.astype(np.int32),
            values.astype(np.float32))


def propagate(u_emb, i_emb, edge_u, edge_i, values):
    """One user<->item message-passing step of the normalized adjacency:
    returns (new_u, new_i)."""
    v = values[:, None]
    new_u = torch.zeros_like(u_emb).index_add(
        0, edge_u, i_emb.index_select(0, edge_i) * v)
    new_i = torch.zeros_like(i_emb).index_add(
        0, edge_i, u_emb.index_select(0, edge_u) * v)
    return new_u, new_i


def masked_norm_values(edge_u, edge_i, keep, n_users, n_items):
    """Renormalize the kept-edge subset (FREEDOM pre_epoch_processing /
    _normalize_adj_m): 1/sqrt(row_deg * col_deg) over kept edges, zero for
    dropped ones — a static-shape form of degree-sensitive edge pruning."""
    keep_f = keep.to(torch.float32)
    du = torch.zeros(n_users, device=keep.device).index_add_(
        0, edge_u, keep_f) + 1e-7
    di = torch.zeros(n_items, device=keep.device).index_add_(
        0, edge_i, keep_f) + 1e-7
    return keep_f / torch.sqrt(du[edge_u] * di[edge_i])


def knn_item_graph(features: np.ndarray, knn_k: int,
                   batch: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """kNN item-item graph over L2-normalized modal features with the
    reference's BATCHED quirk (get_knn_adj_mat_batch): similarities are
    computed within each 1024-item batch only, so neighbors never cross batch
    boundaries. Returns (edges (N*k, 2) int32, laplacian values (N*k,))."""
    x = features / (np.linalg.norm(features, axis=-1, keepdims=True) + 1e-12)
    n = x.shape[0]
    rows, cols = [], []
    for start in range(0, n, batch):
        chunk = x[start:start + batch]
        sim = chunk @ chunk.T
        k = min(knn_k, sim.shape[1])
        idx = np.argpartition(-sim, kth=k - 1, axis=1)[:, :k]
        # order by similarity like torch.topk
        order = np.take_along_axis(sim, idx, 1).argsort(axis=1)[:, ::-1]
        idx = np.take_along_axis(idx, order, 1)
        rows.append(np.repeat(np.arange(start, start + chunk.shape[0]), k))
        cols.append((idx + start).reshape(-1))
    rows = np.concatenate(rows).astype(np.int32)
    cols = np.concatenate(cols).astype(np.int32)
    # normalized laplacian values (compute_normalized_laplacian)
    deg = np.bincount(rows, minlength=n).astype(np.float64) + 1e-7
    values = (deg[rows] ** -0.5) * (deg[cols] ** -0.5)
    return np.stack([rows, cols], 1), values.astype(np.float32)


def global_weighted_knn_graph(features: np.ndarray, knn_k: int,
                              chunk: int = 4096
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """GLOBAL sim-weighted kNN graph — LATTICE's original_adj
    (lattice.py:72-76 via utils.build_sim + build_knn_neighbourhood +
    compute_normalized_laplacian): neighbors come from the full cosine
    similarity matrix (unlike FREEDOM's block-local quirk), edge values are
    the cosines, and the laplacian normalizes by the SIM rowsums.
    Row-chunked so the dense n x n similarity never materializes. On the
    host; :func:`global_weighted_knn_graph_device` is the runner's."""
    x = np.asarray(features, np.float32)
    x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    n = x.shape[0]
    k = min(knn_k, n)
    cols = np.empty((n, k), np.int32)
    sims = np.empty((n, k), np.float32)
    for start in range(0, n, chunk):
        sim = x[start:start + chunk] @ x.T
        idx = np.argpartition(-sim, kth=k - 1, axis=1)[:, :k]
        order = np.take_along_axis(sim, idx, 1).argsort(axis=1)[:, ::-1]
        idx = np.take_along_axis(idx, order, 1)
        cols[start:start + chunk] = idx
        sims[start:start + chunk] = np.take_along_axis(sim, idx, 1)
    rows = np.repeat(np.arange(n, dtype=np.int32), k)
    cols = cols.reshape(-1)
    vals = sims.reshape(-1).astype(np.float64)
    rowsum = np.bincount(rows, weights=vals, minlength=n)
    d = np.where(rowsum > 0, rowsum, np.inf) ** -0.5
    values = d[rows] * vals * d[cols]
    return np.stack([rows, cols], 1), values.astype(np.float32)


def _topk_rows(x, k: int, chunk: int):
    """(sims, cols) of the k largest of ``x[r] . x`` for every row r, in
    descending order, ``chunk`` rows of ``x @ x.T`` at a time."""
    sims, cols = [], []
    for start in range(0, x.shape[0], chunk):
        s, c = torch.topk(x[start:start + chunk] @ x.T, k, dim=1)
        sims.append(s)
        cols.append(c)
    return torch.cat(sims), torch.cat(cols)


def global_weighted_knn_graph_device(features: torch.Tensor, knn_k: int,
                                     chunk: int = 2048
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`global_weighted_knn_graph` on ``features``' device: the same
    cosines (fp32) and top-k, the laplacian's rowsums and values in fp64,
    the values returned in fp32. The same edges as the host's where no two
    cosines of a row tie at its k-th place."""
    x = features.to(torch.float32)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    n = x.shape[0]
    k = min(knn_k, n)
    sims, cols = _topk_rows(x, k, chunk)
    rows = torch.arange(n, device=x.device).repeat_interleave(k)
    cols = cols.reshape(-1)
    sims = sims.reshape(-1).to(torch.float64)
    rowsum = torch.zeros(n, dtype=torch.float64,
                         device=x.device).index_add_(0, rows, sims)
    d = torch.where(rowsum > 0, rowsum, torch.inf) ** -0.5
    values = d[rows] * sims * d[cols]
    return torch.stack([rows, cols], 1), values.to(torch.float32)


def knn_edges_device(features: torch.Tensor, knn_k: int,
                     chunk: int = 2048) -> torch.Tensor:
    """On-device global kNN STRUCTURE over cosine similarity, row-chunked so
    peak memory is chunk x n — LATTICE's per-epoch graph rebuild
    (lattice.py:141-142 build_sim + topk) with a fixed (n*k, 2) output
    (int64, torch's index type, where JAX's is int32)."""
    x = features / (torch.linalg.norm(features, dim=-1, keepdim=True)
                    + 1e-12)
    n = x.shape[0]
    k = min(knn_k, n)
    _, cols = _topk_rows(x, k, chunk)
    rows = torch.arange(n, device=x.device).repeat_interleave(k)
    return torch.stack([rows, cols.reshape(-1)], 1)


def weighted_laplacian_values(edges, proj, n_items: int):
    """Differentiable sim-weighted normalized-laplacian edge values over a
    given structure (lattice.py:154 compute_normalized_laplacian on the
    learned adjacency): v_ij = cos_ij / sqrt(rowsum_i * rowsum_j)."""
    pn = proj / (torch.linalg.norm(proj, dim=-1, keepdim=True) + 1e-12)
    src, dst = edges[:, 0], edges[:, 1]
    sims = (pn.index_select(0, src) * pn.index_select(0, dst)).sum(-1)
    rowsum = torch.zeros(n_items, dtype=sims.dtype,
                         device=sims.device).index_add(0, src, sims)
    d = torch.where(rowsum > 0, rowsum, torch.inf) ** -0.5
    return d[src] * sims * d[dst]


def item_graph_propagate(h, edges, values):
    """h_next[i] = sum_j A[i, j] h[j] over the item kNN graph."""
    msgs = h.index_select(0, edges[:, 1]) * values[:, None]
    return torch.zeros_like(h).index_add(0, edges[:, 0], msgs)
