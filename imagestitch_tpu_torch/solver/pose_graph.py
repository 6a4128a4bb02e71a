"""2-D translation pose-graph solver.

Port of ``imagestitch_tpu/solver/pose_graph.py`` on one device.  The
reference chains pairwise offsets by prefix sum, so its drift is unbounded
(Stitcher.py:404-405); here the pairwise offsets and their confidences
form a pose graph solved by weighted least squares,

    minimize  sum_k w_k || p[b_k] - p[a_k] - m_k ||^2      (p[0] pinned),

whose normal equations are a weighted graph Laplacian (the row and column
systems solved together) by float32 conjugate gradients.

Two choices keep the card's run equal to itself from run to run:
  * the Laplacian's scatter-adds run as a gather table, each node summing
    its edges' terms in the order XLA's scatter adds them on the CPU (the
    ``a`` ends in edge order, then the ``b`` ends), never through
    ``index_add_``, which accumulates in any order on CUDA;
  * the JAX ``while_loop`` (at most ``iters`` steps, ending once the
    residual's square norm is at most 1e-10) runs as ``iters`` steps
    that keep their state once the residual is that small, so the host
    reads nothing back until the end.

Over a device mesh (JAX pose_graph.py:122-165) the edges are padded with
zero weight to a multiple of the shard count and split into equal blocks,
one a shard; each shard builds the rhs and the Laplacian's matvec over its
own edges, and ``parallel.mesh.psum`` adds the shards' partial sums in
shard order.  The CG's vectors live on shard 0's device, replicated to
every shard for its matvec.  The card's positions equal the CPU's at the
same shard count; they are not the single-device solve's, whose sums run
in another order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class PoseGraph:
    """Edge list with measurements (drow, dcol) and confidence weights."""
    edges_a: np.ndarray        # (E,) int32 source node
    edges_b: np.ndarray        # (E,) int32 target node
    measurements: np.ndarray   # (E, 2) float32
    weights: np.ndarray        # (E,) float32 (0 = disabled/padding)
    n_nodes: int

    @classmethod
    def from_chain(cls, offsets: Sequence[Tuple[float, float]],
                   confidences: Optional[Sequence[float]] = None
                   ) -> "PoseGraph":
        """Sequential chain graph — the reference's prefix-sum structure."""
        e = len(offsets)
        w = np.ones(e, np.float32) if confidences is None else \
            np.asarray(confidences, np.float32)
        return cls(edges_a=np.arange(e, dtype=np.int32),
                   edges_b=np.arange(1, e + 1, dtype=np.int32),
                   measurements=np.asarray(offsets, np.float32).reshape(e, 2),
                   weights=w, n_nodes=e + 1)

    def with_extra_edges(self, a, b, m, w) -> "PoseGraph":
        return PoseGraph(
            edges_a=np.concatenate([self.edges_a, np.asarray(a, np.int32)]),
            edges_b=np.concatenate([self.edges_b, np.asarray(b, np.int32)]),
            measurements=np.concatenate(
                [self.measurements, np.asarray(m, np.float32).reshape(-1, 2)]),
            weights=np.concatenate([self.weights, np.asarray(w, np.float32)]),
            n_nodes=self.n_nodes)


_PIN = 1e6  # gauge prior stiffness on node 0


def _node_table(ea: np.ndarray, eb: np.ndarray, n: int) -> np.ndarray:
    """(n, degree) rows into the (2E + 1)-row term table [a-end terms;
    b-end terms; zero]: node i's terms in the order the two scatters add
    them (edges whose ``a`` is i in edge order, then edges whose ``b`` is
    i), padded with the zero row."""
    e = len(ea)
    slots = [[] for _ in range(n)]
    for k, i in enumerate(ea.tolist()):
        slots[i].append(k)
    for k, i in enumerate(eb.tolist()):
        slots[i].append(e + k)
    deg = max(1, max(len(s) for s in slots))
    return np.asarray([s + [2 * e] * (deg - len(s)) for s in slots],
                      np.int64)


def _scatter(terms_a: torch.Tensor, terms_b: torch.Tensor,
             table: torch.Tensor) -> torch.Tensor:
    """y[i] = sum of node i's terms, left to right from 0, as XLA's
    ``y.at[ea].add(terms_a)`` then ``.at[eb].add(terms_b)`` adds them."""
    terms = torch.cat([terms_a, terms_b, terms_a.new_zeros(1, 2)])
    y = terms[table[:, 0]]
    for j in range(1, table.shape[1]):
        y = y + terms[table[:, j]]
    return y


def _edge_matvec(p: torch.Tensor, ea: torch.Tensor, eb: torch.Tensor,
                 w: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """y = L @ p over the edges; (N, 2) -> (N, 2)."""
    wd = w[:, None] * (p[ea] - p[eb])
    return _scatter(wd, -wd, table)


def _edge_rhs(m: torch.Tensor, w: torch.Tensor, table: torch.Tensor
              ) -> torch.Tensor:
    wm = w[:, None] * m
    return _scatter(-wm, wm, table)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) of float32 tensors: the exact products summed in float64
    and rounded once to float32, so the card and the CPU give the same bits
    whatever order each reduction takes (an unconverged CG's iterate
    follows every rounding of its dot products)."""
    return torch.sum(a.to(torch.float64) * b.to(torch.float64)).to(a.dtype)


def _cg(matvec, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain CG from 0: ``iters`` steps, each kept only while the
    residual's square norm exceeds 1e-10 (the JAX ``while_loop``'s
    condition), with no readback."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = _dot(r, r)
    for _ in range(iters):
        go = rs > 1e-10
        ap = matvec(p)
        alpha = rs / (_dot(p, ap) + 1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * ap
        rs_n = _dot(r_n, r_n)
        beta = rs_n / (rs + 1e-30)
        p_n = r_n + beta * p
        x, r, p, rs = (torch.where(go, new, old) for new, old in
                       ((x_n, x), (r_n, r), (p_n, p), (rs_n, rs)))
    return x


class _Edges:
    """One block of edges on ``dev``: endpoints, weights, measurements and
    the node table of the block's scatters."""

    def __init__(self, ea, eb, m, w, n: int, dev):
        on = lambda a, dt: torch.as_tensor(np.asarray(a)).to(dev, dt)
        self.ea = on(ea, torch.int64)
        self.eb = on(eb, torch.int64)
        self.m = on(m, torch.float32).reshape(-1, 2)
        self.w = on(w, torch.float32)
        self.table = on(_node_table(np.asarray(ea), np.asarray(eb), n),
                        torch.int64)

    def matvec(self, p: torch.Tensor) -> torch.Tensor:
        return _edge_matvec(p, self.ea, self.eb, self.w, self.table)

    def rhs(self) -> torch.Tensor:
        return _edge_rhs(self.m, self.w, self.table)


def _pin(y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The gauge prior on node 0: y[0] += _PIN * p[0]."""
    return torch.cat([y[:1] + _PIN * p[:1], y[1:]])


def solve(graph: PoseGraph, iters: Optional[int] = None, mesh=None,
          device="cuda") -> np.ndarray:
    """Absolute (N, 2) float32 poses with pose[0] == (0, 0), solved on
    ``device`` (the card unless the caller passes ``device="cpu"``) or,
    with a ``mesh`` (``parallel.mesh.Mesh``), edge-sharded over its
    devices.  ``iters``: at most this many CG steps (default
    max(2 N, 64))."""
    n = graph.n_nodes
    iters = iters if iters is not None else max(2 * n, 64)
    if mesh is not None:
        from ..parallel.mesh import pad_to_multiple
        d = mesh.size
        pad = pad_to_multiple(max(len(graph.edges_a), d), d) - \
            len(graph.edges_a)
        ea = np.pad(graph.edges_a, (0, pad))
        eb = np.pad(graph.edges_b, (0, pad))
        m = np.pad(graph.measurements, ((0, pad), (0, 0)))
        w = np.pad(graph.weights, (0, pad))   # zero weight disables padding
        x = sharded_solve_fn(mesh, n, iters)(ea, eb, m, w)
    else:
        dev = resolve_device(device, "solve")
        edges = _Edges(graph.edges_a, graph.edges_b, graph.measurements,
                       graph.weights, n, dev)
        x = _cg(lambda p: _pin(edges.matvec(p), p), edges.rhs(), iters)
    return (x - x[0:1]).cpu().numpy()


def sharded_solve_fn(mesh, n: int, iters: int):
    """The edge-sharded CG solve over ``mesh`` as a callable of the padded
    edge arrays (ea, eb, m, w), whose length is a multiple of the shard
    count; returns the (n, 2) iterate on shard 0's device."""
    from ..parallel.mesh import psum, replicate

    def run(ea, eb, m, w):
        per = len(ea) // mesh.size
        blocks = [_Edges(ea[i * per:(i + 1) * per], eb[i * per:(i + 1) * per],
                         m[i * per:(i + 1) * per], w[i * per:(i + 1) * per],
                         n, dev) for i, dev in enumerate(mesh.devices)]

        def matvec(p):
            ys = [e.matvec(pi) for e, pi in zip(blocks, replicate(p, mesh))]
            return _pin(psum(ys, mesh)[0], p)

        return _cg(matvec, psum([e.rhs() for e in blocks], mesh)[0], iters)

    return run


def chain_positions(offsets: Sequence[Tuple[float, float]]) -> np.ndarray:
    """Prefix-sum baseline (the reference's accumulation) for comparison."""
    return np.concatenate([np.zeros((1, 2)),
                           np.cumsum(np.asarray(offsets, np.float64), axis=0)])
