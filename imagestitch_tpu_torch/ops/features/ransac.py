"""Homography RANSAC offset estimation (reference ImageUtility.py:180-210).

Port of ``imagestitch_tpu/ops/features/ransac.py``: the reference's
``getOffsetByRansac`` (``cv2.findHomography(ptsA, ptsB, cv2.RANSAC, 3)``,
the inlier count against offsetEvaluate, and the NEGATED, int-truncated
translation column of H), batched over a leading pair axis:

  * ``N_ITERS`` hypotheses a pair, each a 4-match minimal sample: every
    valid slot gets a uniform key from ``jax.random``'s threefry bits
    (``prng.py``), invalid slots -1, and the sample is the top 4 keys,
    ties to the lower slot as ``lax.top_k`` breaks them (a stable sort);
  * each sample's exact DLT (h33 = 1): the 8x8 system solved by LU with
    partial pivoting in float32 torch ops in LAPACK's order (``_solve``),
    which never raises: an exactly zero pivot gives non-finite H, as in
    jax;
  * scoring: squared reprojection error <= tol^2 over the valid matches,
    non-finite H scores zero; the first hypothesis of the highest count
    wins (``argmax``);
  * two rounds of a Hartley-normalized least-squares DLT refit over the
    winner's inliers (the 9x9 normal matrix's smallest eigenvector), then
    the final inlier count (0 with fewer than 4 valid matches).

The JAX package draws pair ``slot`` of a call over ``P`` pairs from
``split(PRNGKey(_SEED), P)[slot]``; the callers pass each pair's (P, slot)
from the JAX package's batching (``draws``), whatever the port batches.
The uniforms depend only on (P, N_ITERS, K) and are made once a shape
(``_uniforms``).

Not bit-equal: jax solves the 8x8 systems with LAPACK's getrf and trsm,
whose summation order and FMAs this elimination does not reproduce, and
the refit runs in float64 on the host here (jax: float32 eigh).  The DLT
of pixel coordinates is ill-conditioned, so single hypotheses differ; the
inlier counts, and the integer offsets where the consensus has 8 or more
matches, are held equal to jax's (tests/test_torch_ransac.py,
tools/torch_ransac_parity.py).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from . import prng
from .detect import _fma

#: fixed hypothesis count (the JAX package's sizing bound)
N_ITERS = 128
#: deterministic sampling seed (the JAX package's)
_SEED = 0x5713


@functools.lru_cache(maxsize=8)
def _uniforms(batch: int, n_iters: int, k: int, device: torch.device
              ) -> torch.Tensor:
    """(batch, n_iters, k) float32 draws of ``split(PRNGKey(_SEED),
    batch)``, made once a shape and device (callers only read them)."""
    keys = prng.split(prng.prng_key(_SEED, device), batch)
    return prng.uniform(keys, (n_iters, k))


def pair_uniforms(draws: Sequence[Tuple[int, int]], n_iters: int, k: int,
                  device) -> torch.Tensor:
    """(len(draws), n_iters, k) uniforms: pair i takes the key of slot
    ``draws[i][1]`` of a JAX call over ``draws[i][0]`` pairs."""
    out = torch.empty((len(draws), n_iters, k), dtype=torch.float32,
                      device=device)
    for b in sorted({b for b, _ in draws}):
        rows = [i for i, (bb, _) in enumerate(draws) if bb == b]
        slots = torch.tensor([draws[i][1] for i in rows], device=device)
        out[torch.tensor(rows, device=device)] = _uniforms(
            b, n_iters, k, torch.device(device))[slots]
    return out


def sample_indices(valid: torch.Tensor, n_iters: int = N_ITERS,
                   draws: Optional[Sequence[Tuple[int, int]]] = None
                   ) -> torch.Tensor:
    """Each pair's (n_iters, 4) sample of slot indices: the 4 largest keys,
    invalid slots keyed -1, ties to the lower index.  ``valid``: (P, K);
    ``draws``: each pair's (batch, slot) of the JAX call it mirrors
    (default: the P pairs as one call)."""
    p, k = valid.shape
    draws = [(p, i) for i in range(p)] if draws is None else draws
    u = pair_uniforms(draws, n_iters, k, valid.device)
    keys = torch.where(valid[:, None, :], u, torch.full_like(u, -1.0))
    _, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
    return idx[..., :4]


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., n, n) x = b, float32 torch ops on the tensors' device,
    in the order of LAPACK's unblocked left-looking LU (getf2) as OpenBLAS
    runs it: column j first takes the dot products of the rows above it,
    then one fused multiply-add chain for the rows from j down, then the
    first largest |pivot| (rows swapped whole) and the multipliers by the
    pivot's reciprocal; forward and back substitution as trsm orders them.
    Never raises: an exactly zero pivot gives inf or nan, a nearly singular
    system finite garbage, as jax's solve does (on collinear samples, the
    same systems come out non-finite)."""
    n = a.shape[-1]
    a = torch.cat([a, b[..., None]], dim=-1)                 # (..., n, n+1)
    rows = torch.arange(n, device=a.device)
    for j in range(n):
        for i in range(1, j):
            dot = a[..., i, 0] * a[..., 0, j]
            for k in range(1, i):
                dot = dot + a[..., i, k] * a[..., k, j]
            a[..., i, j] = a[..., i, j] - dot
        if j > 0:
            acc = a[..., j:, 0] * a[..., 0, j, None]
            for k in range(1, j):
                acc = _fma(a[..., j:, k], a[..., k, j, None], acc)
            a[..., j:, j] = a[..., j:, j] - acc
        p = j + torch.argmax(a[..., j:, j].abs(), dim=-1)    # (...)
        perm = rows.expand(*p.shape, n).clone()
        perm[..., j] = p
        perm.scatter_(-1, p[..., None], j)
        a = a.gather(-2, perm[..., None].expand(*a.shape))
        a[..., j + 1:, j] = a[..., j + 1:, j] * (1.0 / a[..., j, j, None])
    x = a[..., n].clone()
    for k in range(n):
        x[..., k + 1:] = x[..., k + 1:] - x[..., k, None] * a[..., k + 1:, k]
    for k in range(n - 1, -1, -1):
        x[..., k] = x[..., k] / a[..., k, k]
        x[..., :k] = x[..., :k] - x[..., k, None] * a[..., :k, k]
    return x


def _dlt_exact(px, py, qx, qy) -> torch.Tensor:
    """Exact homography from 4 correspondences (p -> q), h33 = 1: (..., 4)
    coordinates -> (..., 3, 3) (non-finite entries when degenerate)."""
    zeros = torch.zeros_like(px)
    ones = torch.ones_like(px)
    rows_u = torch.stack([px, py, ones, zeros, zeros, zeros,
                          -qx * px, -qx * py], dim=-1)
    rows_v = torch.stack([zeros, zeros, zeros, px, py, ones,
                          -qy * px, -qy * py], dim=-1)
    a = torch.cat([rows_u, rows_v], dim=-2)                  # (..., 8, 8)
    h = _solve(a, torch.cat([qx, qy], dim=-1))
    return torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(
        *h.shape[:-1], 3, 3)


def _project(h: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Apply (..., 3, 3) homographies to (..., K) points."""
    e = lambda i, j: h[..., i, j, None]
    w = e(2, 0) * x + e(2, 1) * y + e(2, 2)
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    u = (e(0, 0) * x + e(0, 1) * y + e(0, 2)) / w
    v = (e(1, 0) * x + e(1, 1) * y + e(1, 2)) / w
    return u, v


def _inliers(h, px, py, qx, qy, valid, tol_sq: float) -> torch.Tensor:
    u, v = _project(h, px, py)
    err = (u - qx) ** 2 + (v - qy) ** 2
    finite = torch.isfinite(h).all(dim=-1).all(dim=-1)
    return valid & (err <= tol_sq) & finite[..., None]


def _refit_dlt(px, py, qx, qy, weight) -> torch.Tensor:
    """Weighted least-squares DLT over the consensus set, (P, K) -> (P, 3,
    3): Hartley normalization on both sides, the smallest eigenvector of
    the 9x9 normal matrix, denormalized and scaled to h33 = 1.  In float64
    on the host (the JAX package: float32 on its device), whatever device
    the points lie on: with fewer than 4 inliers (or collinear ones) the
    normal matrix has a null space of more than one dimension, and only
    one eigensolver on one input picks the same member of it on the card
    as on the CPU."""
    device = px.device
    px, py, qx, qy, w = (t.to("cpu", torch.float64) for t in (
        px, py, qx, qy, weight))
    one = torch.ones((), dtype=torch.float64, device=px.device)

    def norm(x, y):
        nw = torch.clamp_min(w.sum(-1, keepdim=True), 1.0)
        mx = (x * w).sum(-1, keepdim=True) / nw
        my = (y * w).sum(-1, keepdim=True) / nw
        d = torch.sqrt((x - mx) ** 2 + (y - my) ** 2)
        s = torch.sqrt(2.0 * one) / torch.clamp_min(
            (d * w).sum(-1, keepdim=True) / nw, 1e-9)
        z = torch.zeros_like(s)
        t = torch.stack([torch.cat([s, z, -s * mx], -1),
                         torch.cat([z, s, -s * my], -1),
                         torch.cat([z, z, torch.ones_like(s)], -1)], dim=-2)
        return (x - mx) * s, (y - my) * s, t

    pxn, pyn, tp = norm(px, py)
    qxn, qyn, tq = norm(qx, qy)
    zeros = torch.zeros_like(pxn)
    ones = torch.ones_like(pxn)
    ru = torch.stack([pxn, pyn, ones, zeros, zeros, zeros,
                      -qxn * pxn, -qxn * pyn, -qxn], dim=-1)
    rv = torch.stack([zeros, zeros, zeros, pxn, pyn, ones,
                      -qyn * pxn, -qyn * pyn, -qyn], dim=-1)
    a = torch.cat([ru * w[..., None], rv * w[..., None]], dim=-2)
    _, vecs = torch.linalg.eigh(a.transpose(-1, -2) @ a)
    h = vecs[..., :, 0].reshape(-1, 3, 3)                    # smallest eig
    h_full, _ = torch.linalg.solve_ex(tq, h @ tp)            # denormalize
    h22 = h_full[:, 2, 2]
    scale = torch.where(h22.abs() < 1e-12, torch.full_like(h22, 1e-12), h22)
    return (h_full / scale[:, None, None]).to(device, torch.float32)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: truncation toward zero,
    saturating, nan -> 0."""
    t = torch.trunc(torch.nan_to_num(x.to(torch.float64), nan=0.0))
    return t.clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def ransac_homography_batch(rows_a: torch.Tensor, cols_a: torch.Tensor,
                            rows_b: torch.Tensor, cols_b: torch.Tensor,
                            valid: torch.Tensor, tol: float = 3.0,
                            n_iters: int = N_ITERS,
                            draws: Optional[Sequence[Tuple[int, int]]] = None
                            ):
    """Batched reference-semantics RANSAC offset, (P, K) matched (row, col)
    coordinates of A and B and validity -> ``(drow, dcol, n_inliers,
    any_valid, srow, scol)``: the int-truncated offsets
    ``(-int(H[1,2]), -int(H[0,2]))``, the inlier count, whether a model was
    estimated, and the float offsets.  ``draws``: each pair's (batch, slot)
    of the JAX call whose keys it takes (``sample_indices``)."""
    tol_sq = float(tol) ** 2
    # cv2 frame: x = col, y = row; H maps A -> B
    px, py, qx, qy = cols_a, rows_a, cols_b, rows_b
    p, k = px.shape
    n_valid = valid.sum(-1)
    idx = sample_indices(valid, n_iters, draws).reshape(p, -1)
    take = lambda t: t.gather(1, idx).reshape(p, n_iters, 4)
    hs = _dlt_exact(take(px), take(py), take(qx), take(qy))  # (P, I, 3, 3)
    counts = _inliers(hs, px[:, None], py[:, None], qx[:, None],
                      qy[:, None], valid[:, None], tol_sq).sum(-1)
    best = torch.argmax(counts, dim=-1)                      # first max
    h_fin = hs[torch.arange(p, device=px.device), best]      # (P, 3, 3)
    for _ in range(2):
        inl = _inliers(h_fin, px, py, qx, qy, valid, tol_sq)
        h_ref = _refit_dlt(px, py, qx, qy, inl.to(torch.float32))
        ok = torch.isfinite(h_ref).all(dim=-1).all(dim=-1)
        h_fin = torch.where(ok[:, None, None], h_ref, h_fin)
    inl = _inliers(h_fin, px, py, qx, qy, valid, tol_sq)
    n_fin = torch.where(n_valid >= 4, inl.sum(-1),
                        torch.zeros_like(n_valid)).to(torch.int32)
    tx, ty = h_fin[:, 0, 2], h_fin[:, 1, 2]
    return (-_to_int32(ty), -_to_int32(tx), n_fin, n_fin > 0, -ty, -tx)
