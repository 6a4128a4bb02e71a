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

The kernel computes the products with 3xTF32 tensor-core MMAs at FP32
accuracy and, where the grid of (query tiles x batch) blocks is small,
splits the train axis into ``num_splits`` ranges that a merge kernel folds
(one wrapper call, one count).
"""
from __future__ import annotations

import functools

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


#: queries per block and train rows per tile of the CUDA kernel
TILE = 128


def num_splits(batch: int, ka: int, kb: int, sms: int) -> int:
    """Train-axis splits S for a grid of ``batch`` x ceil(ka / TILE)
    blocks on ``sms`` SMs (one block an SM): the S of least modelled time,
    waves x (tiles a split + 0.5 for the query tile's load) + 1 tile for
    the merge when S > 1, among S whose splits all hold whole tiles; ties
    go to the smaller S."""
    blocks = batch * -(-ka // TILE)
    tiles = -(-kb // TILE)
    best, best_cost = 1, None
    for s in range(1, tiles + 1):
        per = -(-tiles // s)
        if (s - 1) * per >= tiles:     # a split would be empty
            continue
        cost = -(-blocks * s // sms) * (per + 0.5) + (s > 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _run(name, da, db, valid_b, rows_b=None, cols_b=None):
    """One launch of the CUDA kernel (and its merge when S > 1): K3 with
    the coordinates, K5 without.  Allocates the outputs and the splits'
    scratch."""
    from ... import _build
    b, ka, d = da.shape
    kb = db.shape[1]
    dev = da.device
    splits = num_splits(b, ka, kb, _sm_count(dev))
    out_f = lambda: torch.empty((b, ka), dtype=torch.float32, device=dev)
    d0, d1 = out_f(), out_f()
    i0 = torch.empty((b, ka), dtype=torch.int32, device=dev)
    # the splits' (d0, i0, d1) planes, alive until the launch is enqueued
    part = (torch.empty((3, splits, b, ka), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    scratch = part.data_ptr() if part is not None else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.library()
    if rows_b is None:
        with torch.cuda.device(dev):           # the launch's current card
            err = lib.matcher_top2_launch(
                da.data_ptr(), db.data_ptr(), valid_b.data_ptr(), b, ka, kb,
                d, splits, scratch, d0.data_ptr(), i0.data_ptr(),
                d1.data_ptr(), stream)
        _build.check(err, name)
        return d0, i0, d1
    rb_sel, cb_sel = out_f(), out_f()
    with torch.cuda.device(dev):               # the launch's current card
        err = lib.matcher_launch(
            da.data_ptr(), db.data_ptr(), valid_b.data_ptr(),
            rows_b.data_ptr(), cols_b.data_ptr(), b, ka, kb, d, splits,
            scratch, d0.data_ptr(), i0.data_ptr(), d1.data_ptr(),
            rb_sel.data_ptr(), cb_sel.data_ptr(), stream)
    _build.check(err, name)
    return d0, i0, d1, rb_sel, cb_sel


def _launch(da, db, valid_b, rows_b, cols_b):
    global LAUNCHES
    out = _run("top2_l2_coords", da, db, valid_b, rows_b, cols_b)
    LAUNCHES += 1
    return out


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
    global TOP2_LAUNCHES
    out = _run("top2_l2", da, db, valid_b)
    TOP2_LAUNCHES += 1
    return out


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
