"""K3 and K5: fused all-pairs squared-L2 + top-2 (+ matched coordinates).

Ports of ``imagestitch_tpu/ops/pallas/matcher.py::top2_l2_coords`` (K3) and
``::top2_l2`` (K5).  Both run the CUDA kernel of ``csrc/matcher.cu``; K5 is
its mode without the coordinate outputs.  ``top2_l2_coords_plain`` and
``top2_l2_plain`` are the same functions in plain PyTorch (the XLA paths
``match_batch_coords`` / ``match_batch`` with ``use_pallas=False`` of the
JAX package).  Batched over a leading axis: the pooled replay matches
pairs x configs in one call, the whole-image path pairs.  The Pallas K5
takes only query counts that are multiples of 256 (match.py:126 routes the
rest to XLA); the CUDA kernel takes any count, so every L2 ``match_batch``
on a CUDA tensor runs it.
"""
from __future__ import annotations

import torch

from ..features.match import _BIG, _pairwise_sq_l2, _top2_min

#: launches of the K3 kernel since the counter was last set to 0
LAUNCHES = 0
#: launches of the K5 kernel since the counter was last set to 0
TOP2_LAUNCHES = 0


def top2_l2_plain(da, db, valid_b):
    """(B, Ka, D), (B, Kb, D), (B, Kb) -> (d0, i0, d1), each (B, Ka)."""
    dist = _pairwise_sq_l2(da, db)
    dist = torch.where(valid_b[:, None, :], dist, torch.full_like(dist, _BIG))
    d0, i0, d1 = _top2_min(dist)
    return d0, i0.to(torch.int32), d1


def top2_l2_coords_plain(da, db, valid_b, rows_b, cols_b):
    """(B, Ka, D), (B, Kb, D), (B, Kb) x3 -> (d0, i0, d1, rb_sel, cb_sel)."""
    d0, i0, d1 = top2_l2_plain(da, db, valid_b)
    i0l = i0.long()
    return d0, i0, d1, rows_b.gather(1, i0l), cols_b.gather(1, i0l)


def _check_kernel_args(name, da, tensors, valid_b):
    d = da.shape[2]
    if d % 32 or not 32 <= d <= 128:
        raise ValueError(f"{name} kernel: D={d} must be 32, 64, 96 or 128")
    for t in (da, *tensors):
        if t.dtype != torch.float32 or t.device != da.device:
            raise TypeError(f"{name} kernel needs float32 tensors on one "
                            f"device")
    if valid_b.dtype != torch.bool or valid_b.device != da.device:
        raise TypeError(f"{name} kernel needs a bool valid_b")


def _check_shapes(name, da, db, *per_train):
    if da.dim() != 3 or db.dim() != 3 or da.shape[0] != db.shape[0] \
            or da.shape[2] != db.shape[2]:
        raise ValueError(f"{name}: shapes {tuple(da.shape)} "
                         f"{tuple(db.shape)}")
    for t in per_train:
        if tuple(t.shape) != tuple(db.shape[:2]):
            raise ValueError(f"{name}: per-train-row input "
                             f"{tuple(t.shape)} for {tuple(db.shape)}")


def _launch(da, db, valid_b, rows_b, cols_b):
    from ... import _build
    global LAUNCHES
    b, ka, d = da.shape
    kb = db.shape[1]
    dev = da.device
    out_f = lambda: torch.empty((b, ka), dtype=torch.float32, device=dev)
    d0, d1, rb_sel, cb_sel = out_f(), out_f(), out_f(), out_f()
    i0 = torch.empty((b, ka), dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.matcher_launch(
        da.data_ptr(), db.data_ptr(), valid_b.data_ptr(), rows_b.data_ptr(),
        cols_b.data_ptr(), b, ka, kb, d, d0.data_ptr(), i0.data_ptr(),
        d1.data_ptr(), rb_sel.data_ptr(), cb_sel.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "top2_l2_coords")
    LAUNCHES += 1
    return d0, i0, d1, rb_sel, cb_sel


def top2_l2_coords(da: torch.Tensor, db: torch.Tensor, valid_b: torch.Tensor,
                   rows_b: torch.Tensor, cols_b: torch.Tensor,
                   use_kernel: bool = True):
    """Squared-L2 top-2 per query row plus the matched train coordinates.

    Returns (d0, i0, d1, rb_sel, cb_sel), each (B, Ka); i0 is the first
    argmin, d1 the minimum over the other columns, invalid train rows count
    as 3.4e38.  A CUDA tensor runs the CUDA kernel unless ``use_kernel`` is
    False; a CPU tensor runs the plain version.
    """
    _check_shapes("top2_l2_coords", da, db, valid_b, rows_b, cols_b)
    if da.is_cuda and use_kernel:
        _check_kernel_args("top2_l2_coords", da, (db, rows_b, cols_b),
                           valid_b)
        return _launch(da.contiguous(), db.contiguous(), valid_b.contiguous(),
                       rows_b.contiguous(), cols_b.contiguous())
    return top2_l2_coords_plain(da, db, valid_b, rows_b, cols_b)


def _launch_top2(da, db, valid_b):
    from ... import _build
    global TOP2_LAUNCHES
    b, ka, d = da.shape
    kb = db.shape[1]
    dev = da.device
    d0 = torch.empty((b, ka), dtype=torch.float32, device=dev)
    d1 = torch.empty((b, ka), dtype=torch.float32, device=dev)
    i0 = torch.empty((b, ka), dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.matcher_top2_launch(
        da.data_ptr(), db.data_ptr(), valid_b.data_ptr(), b, ka, kb, d,
        d0.data_ptr(), i0.data_ptr(), d1.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "top2_l2")
    TOP2_LAUNCHES += 1
    return d0, i0, d1


def top2_l2(da: torch.Tensor, db: torch.Tensor, valid_b: torch.Tensor,
            use_kernel: bool = True):
    """Squared-L2 top-2 per query row: (d0, i0, d1), each (B, Ka), with the
    semantics of ``top2_l2_coords``.  A CUDA tensor runs the CUDA kernel
    unless ``use_kernel`` is False; a CPU tensor runs the plain version.
    """
    _check_shapes("top2_l2", da, db, valid_b)
    if da.is_cuda and use_kernel:
        _check_kernel_args("top2_l2", da, (db,), valid_b)
        return _launch_top2(da.contiguous(), db.contiguous(),
                            valid_b.contiguous())
    return top2_l2_plain(da, db, valid_b)
