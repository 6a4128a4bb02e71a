"""Tensor-parallel 2-D FFT phase correlation of one oversized pair.

Port of ``imagestitch_tpu/parallel/tp_fft.py``.  A pair whose padded
surfaces exceed one device's budget (the whole-image phase registration of
``core/registration.register_sequence_phase_whole``) is correlated with
the 2-D FFT split over a ``parallel.mesh.Mesh``: the classic
transpose-decomposed FFT, with the transposes as ``mesh.all_to_all``.

Layout (D shards, padded shape (HP, WP), both multiples of D):
  x          : shard i holds rows [i HP/D, (i + 1) HP/D), (HP/D, WP)
  fft dim 1  : local                              -> (HP/D, WP)
  all_to_all(split 1, concat 0)                   -> (HP, WP/D)
  fft dim 0  : local, the full column transform
  cross-power, ifft dim 0
  all_to_all(split 0, concat 1)                   -> (HP/D, WP)
  ifft dim 1 : the correlation surface, row-sharded.
The peak comes from each shard's max and first argmax through
``all_gather`` (the first shard wins a tie, as ``argmax`` does), and the
5-row window around it is assembled by ``psum`` of each shard's own rows.
The window WRAPS at the padded border, as JAX's does: it differs from
cv2's clipped window only for shifts within 2 px of the largest the padded
size can represent, which 2x padding rules out.  The centroid is taken in
fftshift coordinates.  No device ever holds the whole padded surface.

Per pair: 3 ``all_to_all`` (one forward transform each, one back), 2
``all_gather`` and 1 ``psum`` (``mesh.COLLECTIVES``).  The FFTs are
``torch.fft`` on each shard's device; every division is by a tensor (on a
CUDA tensor PyTorch divides by a Python scalar as a multiply by its
reciprocal).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import phase_corr
from . import mesh as mesh_mod


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _row_blocks(x, mesh, hp: int, wp: int):
    """Shard i's (hp / D, wp) block of ``x`` zero-padded to (hp, wp),
    built on its own device from the rows it covers."""
    x = torch.as_tensor(np.asarray(x, np.float32)) \
        if not isinstance(x, torch.Tensor) else x.to(torch.float32)
    h, w = x.shape
    hl = hp // mesh.size
    out = []
    for i, dev in enumerate(mesh.devices):
        blk = torch.zeros((hl, wp), dtype=torch.float32, device=dev)
        r0, r1 = i * hl, min((i + 1) * hl, h)
        if r1 > r0:
            blk[:r1 - r0, :w] = x[r0:r1].to(dev)
        out.append(blk)
    return out


def _forward(blocks, mesh):
    f1 = [torch.fft.fft(x.to(torch.complex64), dim=1) for x in blocks]
    cols = mesh_mod.all_to_all(f1, mesh, split_dim=1, concat_dim=0)
    return [torch.fft.fft(c, dim=0) for c in cols]          # (hp, wp / D)


def _cross_power(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    p = fa * torch.conj(fb)
    den = (p.abs() + torch.finfo(torch.float32).tiny)[..., None]
    return torch.view_as_complex(torch.view_as_real(p) / den)


def phase_correlate_sharded(a, b, mesh, hp: Optional[int] = None,
                            wp: Optional[int] = None
                            ) -> Tuple[float, float, float]:
    """Phase-correlate ONE pair of (h, w) images (numpy or tensors) with
    the FFT split over ``mesh``.  ``hp``/``wp`` default to the optimal DFT
    sizes, each rounded up to a multiple of the shard count.

    Returns (shift_x, shift_y, response) in cv2's (x = col, y = row)
    convention, as ``ops.phase_corr._phase_correlate_one``.
    """
    h, w = a.shape
    d = mesh.size
    hp = _pad_to(hp or phase_corr.optimal_dft_size(h), d)
    wp = _pad_to(wp or phase_corr.optimal_dft_size(w), d)
    hl = hp // d
    fa = _forward(_row_blocks(a, mesh, hp, wp), mesh)
    fb = _forward(_row_blocks(b, mesh, hp, wp), mesh)
    ic = [torch.fft.ifft(_cross_power(x, y), dim=0) for x, y in zip(fa, fb)]
    rows = mesh_mod.all_to_all(ic, mesh, split_dim=0, concat_dim=1)
    c = [torch.fft.ifft(r, dim=1).real for r in rows]      # (hl, wp) each

    # the global peak: each shard's max and first argmax, gathered
    loc_m = [x.reshape(-1).max().reshape(1) for x in c]
    loc_i = [x.reshape(-1).argmax().reshape(1) + i * hl * wp
             for i, x in enumerate(c)]
    gm = mesh_mod.all_gather(loc_m, mesh)
    gi = mesh_mod.all_gather(loc_i, mesh)
    gidx = int(gi[int(torch.argmax(gm))])
    pr, pc = gidx // wp, gidx % wp

    # the 5-row window, wrapped, assembled from the rows each shard owns
    offs = np.arange(-2, 3)
    need = (pr + offs) % hp
    contrib = []
    for i, (x, dev) in enumerate(zip(c, mesh.devices)):
        own = torch.as_tensor((need >= i * hl) & (need < (i + 1) * hl),
                              device=dev)
        lidx = torch.as_tensor(np.clip(need - i * hl, 0, hl - 1), device=dev)
        contrib.append(torch.where(own[:, None], x[lidx],
                                   torch.zeros((), device=dev)))
    win_rows = mesh_mod.psum(contrib, mesh)[0]             # (5, wp)
    win = win_rows[:, torch.as_tensor((pc + offs) % wp,
                                      device=win_rows.device)]

    # centroid in fftshift coordinates: the rolled peak q = (p + n/2) mod n
    f32 = dict(dtype=torch.float32, device=win.device)
    qr = torch.tensor(float((pr + hp // 2) % hp), **f32)
    qc = torch.tensor(float((pc + wp // 2) % wp), **f32)
    off = torch.as_tensor(offs, **f32)
    s = win.sum()
    den = s + torch.finfo(torch.float32).tiny
    cr = qr + (win * off[:, None]).sum() / den
    cc = qc + (win * off[None, :]).sum() / den
    # the inverse FFT's 1/(hp wp) makes s cv2's normalized response
    sx = torch.tensor(wp / 2.0, **f32) - cc
    sy = torch.tensor(hp / 2.0, **f32) - cr
    return float(sx), float(sy), float(s)


def phase_correlate_auto(a, b, mesh, per_chip_budget_bytes: int = 2 << 30,
                         device="cuda") -> Tuple[float, float, float]:
    """One device's phase correlation, or the sharded one when the padded
    working set would exceed ``per_chip_budget_bytes`` on one device.

    Working-set model: about six padded complex64 surfaces live at the
    peak of the one-device pipeline (two spectra, the cross-power, the
    inverse and temporaries), ``6 * hp * wp * 8`` bytes.  The one-device
    route runs on the mesh's first device, or on ``device`` without a
    mesh (the card unless the caller passes ``device="cpu"``).
    """
    h, w = a.shape
    hp = phase_corr.optimal_dft_size(h)
    wp = phase_corr.optimal_dft_size(w)
    working = 6 * hp * wp * 8
    if mesh is None or mesh.size == 1 or working <= per_chip_budget_bytes:
        dev = mesh.devices[0] if mesh is not None else \
            resolve_device(device, "phase_correlate_auto")
        ta, tb = (torch.as_tensor(np.asarray(x, np.float32))
                  if not isinstance(x, torch.Tensor) else x.to(torch.float32)
                  for x in (a, b))
        sx, sy, resp = phase_corr._phase_correlate_one(
            ta.to(dev)[None], tb.to(dev)[None], hp, wp)
        return float(sx[0]), float(sy[0]), float(resp[0])
    return phase_correlate_sharded(a, b, mesh, hp, wp)
