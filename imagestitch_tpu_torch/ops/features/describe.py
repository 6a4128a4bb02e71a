"""SURF, SIFT and ORB descriptors at fixed capacity, upright and oriented.

Port of ``imagestitch_tpu/ops/features/describe.py``: the 18x18 window
gather with CLIP semantics, the 3-tap smoothed central-difference
gradients, the Gaussian-weighted 4x4 subregion sums (4 channels, or 8
sign-split channels for SURF-128) or 8 orientation bins (SIFT-128, glibc's
``atan2f`` as XLA's CPU code calls it: ``_atan2f``), the L2
normalisation, and ORB's BRIEF bits (the pattern drawn by numpy's
``default_rng(7)``, rotated by the intensity-centroid angle unless
upright; ``wta_k`` > 2 as one-hot symbols).  Oriented descriptors first estimate the cv2-SURF dominant
orientation on a 29x29 patch (Haar responses on the radius-6 sample
circle, sliding pi/3 window), then sample the 18x18 grid rotated by it
bilinearly from that patch; for SIFT each of those steps rounds as XLA's
CPU code rounds it (``xla_bits``), so its bins are the JAX package's.
``describe_from_pyramid`` /
``describe_from_atlas`` / ``describe_batch`` are the dense path (the
score-map pool describes through ``describe_from_atlas``, over the atlas its
K4 call read); the fused pool calls the atlas kernel
(``ops/kernels/describe.py``), whose plain version is built from the
helpers here.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from ..fusion.blend import _cosf, _sinf
from .detect import _fma, _sep_conv2

_S = 16          # sample grid edge (SxS window)
_SUB = 4         # 4x4 subregions
_ORB_BITS = 256  # number of BRIEF tests

#: guard rows between atlas bands — covers the largest descriptor window
#: margin (the oriented gather patch: 29 px -> margin 14).
ATLAS_GUARD = 16


@dataclasses.dataclass(frozen=True)
class DescribeParams:
    """Static descriptor configuration."""
    family: str = "surf"    # "surf" | "surf-extended" | "sift" | "orb"
    upright: bool = False   # ImageUtility.py:28 (False = oriented)
    patch_size: int = 31    # ORB BRIEF patch edge (ImageUtility.py:37)
    wta_k: int = 2          # points per BRIEF test (ImageUtility.py:36)


def descriptor_dim(params: DescribeParams) -> int:
    """Descriptor length: 256 bits (256 x wta_k one-hot for wta_k > 2) for
    ORB, 64 for SURF, 128 for SURF-128 and SIFT."""
    if params.family == "orb":
        return _ORB_BITS * (params.wta_k if params.wta_k > 2 else 1)
    return 64 if params.family == "surf" else 128


def _gauss_weight(s: int, sigma: float) -> np.ndarray:
    ax = np.arange(s, dtype=np.float64) - (s - 1) / 2.0
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    w = np.outer(g, g)
    return (w / w.sum()).astype(np.float32)


def window_weight() -> np.ndarray:
    """(S, S) float32 Gaussian window weight, scaled as describe_batch uses
    it (``_gauss_weight(S, S/2) * S * S``)."""
    return _gauss_weight(_S, _S / 2.0) * _S * _S


_WEIGHT_TABLES = {}


def weight_table(device) -> torch.Tensor:
    """``window_weight()`` as an (S, S) float32 tensor on ``device``, built
    and copied there once per device; later calls make no copy."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    table = _WEIGHT_TABLES.get(device)
    if table is None:
        table = torch.from_numpy(window_weight()).to(device)
        _WEIGHT_TABLES[device] = table
    return table


def _gather_windows(image: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
                    size: int) -> torch.Tensor:
    """(K, size, size) windows at integer starts, clamped so each window
    lies inside ``image`` (the XLA gather's CLIP mode)."""
    h, w = image.shape
    r0 = r0.long().clamp(0, h - size)
    c0 = c0.long().clamp(0, w - size)
    ar = torch.arange(size, device=image.device)
    return image[(r0[:, None] + ar)[:, :, None], (c0[:, None] + ar)[:, None, :]]


def _patch_gather(image: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                  size: int, margin: int) -> torch.Tensor:
    """(K, size, size) windows centered on each (rounded) keypoint."""
    r0 = torch.round(rows).to(torch.int32) - margin
    c0 = torch.round(cols).to(torch.int32) - margin
    return _gather_windows(image, r0, c0, size)


def _grads_from_samples(q: torch.Tensor):
    """(K, S+2, S+2) samples -> smoothed (K, S, S) gradients (3-tap box +
    central difference)."""
    sm = 0.25 * q[:, :-2, :] + 0.5 * q[:, 1:-1, :] + 0.25 * q[:, 2:, :]
    gx = 0.5 * sm[:, :, :-2] - 0.5 * sm[:, :, 2:]
    dr = 0.5 * q[:, :-2, :] - 0.5 * q[:, 2:, :]
    gy = 0.25 * dr[:, :, :-2] + 0.5 * dr[:, :, 1:-1] + 0.25 * dr[:, :, 2:]
    return gx, gy


def _surf_from_grads(gx: torch.Tensor, gy: torch.Tensor, extended: bool
                     ) -> torch.Tensor:
    """(K, S, S) weighted gradients -> (K, 64|128) SURF vector."""
    k = gx.shape[0]
    sub = _S // _SUB
    gxs = gx.reshape(k, _SUB, sub, _SUB, sub)
    gys = gy.reshape(k, _SUB, sub, _SUB, sub)
    zero = torch.zeros_like(gxs)
    s = lambda t: t.sum(dim=(2, 4))
    if not extended:
        feats = torch.stack([s(gxs), s(gys), s(gxs.abs()), s(gys.abs())],
                            dim=-1)                            # (K, 4, 4, 4)
    else:
        pos_y = gys >= 0
        pos_x = gxs >= 0
        feats = torch.stack([
            s(torch.where(pos_y, gxs, zero)),
            s(torch.where(~pos_y, gxs, zero)),
            s(torch.where(pos_y, gxs.abs(), zero)),
            s(torch.where(~pos_y, gxs.abs(), zero)),
            s(torch.where(pos_x, gys, zero)),
            s(torch.where(~pos_x, gys, zero)),
            s(torch.where(pos_x, gys.abs(), zero)),
            s(torch.where(~pos_x, gys.abs(), zero)),
        ], dim=-1)                                             # (K, 4, 4, 8)
    d = feats.reshape(k, -1)
    return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)


def _bilinear_from_patch(patch: torch.Tensor, pr: torch.Tensor,
                         pc: torch.Tensor, xla_bits: bool = False
                         ) -> torch.Tensor:
    """Bilinear samples of (K, G, G) patches at float patch coordinates
    (K, ...); the 2x2 cell is clamped inside the patch.  ``xla_bits``: the
    four products summed as XLA's CPU code sums them: the second product
    first, then each other one's last multiply fused into the running sum
    (rounded once)."""
    k, g, _ = patch.shape
    shape = pr.shape
    r0 = torch.floor(pr).to(torch.int64).clamp(0, g - 2)
    c0 = torch.floor(pc).to(torch.int64).clamp(0, g - 2)
    fr = (pr - r0).clamp(0.0, 1.0)
    fc = (pc - c0).clamp(0.0, 1.0)
    flat = patch.reshape(k, g * g)

    def take(r, c):
        return flat.gather(1, (r * g + c).reshape(k, -1)).reshape(shape)

    if xla_bits:
        out = take(r0, c0 + 1) * (1 - fr) * fc
        out = _fma(take(r0, c0) * (1 - fr), 1 - fc, out)
        out = _fma(take(r0 + 1, c0) * fr, 1 - fc, out)
        return _fma(take(r0 + 1, c0 + 1) * fr, fc, out)
    return (take(r0, c0) * (1 - fr) * (1 - fc)
            + take(r0, c0 + 1) * (1 - fr) * fc
            + take(r0 + 1, c0) * fr * (1 - fc)
            + take(r0 + 1, c0 + 1) * fr * fc)


def _rot(theta: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
         xla_bits: bool = False):
    """Rotate (row=u, col=v) offsets by per-keypoint theta (K,);
    ``xla_bits``: the cosine and sine as glibc's float32 ``cosf`` and
    ``sinf``, which XLA's CPU code calls."""
    ct = _cosf(theta) if xla_bits else torch.cos(theta)
    st = _sinf(theta) if xla_bits else torch.sin(theta)
    while ct.dim() < u.dim():
        ct = ct[..., None]
        st = st[..., None]
    return ct * u - st * v, st * u + ct * v


_ORI_G = 29          # oriented gather patch edge
_ORI_R = _ORI_G // 2

# cv2-SURF orientation constants: samples on a radius-6 circle of the sigma
# grid, Gaussian sigma 2.5, sliding pi/3 window advanced in 5-degree steps.
_ORI_SPACING = 2           # px per sigma unit on the fixed 29px patch
_ORI_RADIUS = 6            # sample circle radius (sigma units)
_ORI_HAAR = 4 * _ORI_SPACING   # Haar wavelet edge (4 sigma)
_ORI_WIN = np.pi / 3.0
_ORI_STEPS = 72            # 360 / 5 degrees


def _ori_sample_layout():
    """Static sample coordinates + Gaussian weights of the cv2 scheme."""
    pts = []
    wts = []
    for i in range(-_ORI_RADIUS, _ORI_RADIUS + 1):
        for j in range(-_ORI_RADIUS, _ORI_RADIUS + 1):
            if i * i + j * j < _ORI_RADIUS * _ORI_RADIUS:
                pts.append((i, j))
                wts.append(float(np.exp(-(i * i + j * j) /
                                        (2.0 * 2.5 * 2.5))))
    return np.asarray(pts, np.int32), np.asarray(wts, np.float32)


_ORI_PTS, _ORI_WTS = _ori_sample_layout()
#: float32 start angle of each sliding window
_ORI_STARTS = np.arange(_ORI_STEPS, dtype=np.float32) * (2 * np.pi / _ORI_STEPS)


def _window_sum_xla(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order of XLA's CPU matrix-vector
    product (its tiled GEMV): 8 lane sums over the whole blocks of 8, the
    lanes added pairwise ((0+1)+(2+3))+((4+5)+(6+7)), and the tail's
    sequential sum added in front."""
    n = v.shape[-1]
    nb = n // 8
    blocks = v[..., :nb * 8].unflatten(-1, (nb, 8))
    acc = blocks[..., 0, :]
    for t in range(1, nb):
        acc = acc + blocks[..., t, :]
    while acc.shape[-1] > 1:
        acc = acc[..., 0::2] + acc[..., 1::2]
    if nb * 8 == n:
        return acc[..., 0]
    tail = v[..., nb * 8]
    for j in range(nb * 8 + 1, n):
        tail = tail + v[..., j]
    return tail + acc[..., 0]


def _dominant_orientation(patch: torch.Tensor, xla_bits: bool = False
                          ) -> torch.Tensor:
    """cv2-SURF dominant orientation per patch (K, G, G) -> (K,) radians.

    Haar x/y responses at the radius-6 circle samples (box sums from the
    patch's integral image), Gaussian-weighted (sigma 2.5); the pi/3 window
    (72 starts, 5 degrees apart) whose summed response vector is longest
    gives the angle.  ``xla_bits``: both angles by glibc's ``atan2f`` and
    the window sums in the order of XLA's CPU code (``_window_sum_xla``),
    so the angle is the JAX package's bit for bit.
    """
    ii = torch.cumsum(torch.cumsum(patch, dim=1), dim=2)
    ii = torch.nn.functional.pad(ii, (1, 0, 1, 0))
    dev = patch.device

    def box(r0, c0, r1, c1):
        # sums over patch[r0:r1, c0:c1] at every sample: (K, S)
        return ii[:, r1, c1] - ii[:, r0, c1] - ii[:, r1, c0] + ii[:, r0, c0]

    half = _ORI_HAAR // 2
    r = torch.from_numpy(_ORI_R + _ORI_PTS[:, 0] * _ORI_SPACING).to(dev)
    c = torch.from_numpy(_ORI_R + _ORI_PTS[:, 1] * _ORI_SPACING).to(dev)
    r0, r1, c0, c1 = r - half, r + half, c - half, c + half
    wt = torch.from_numpy(_ORI_WTS).to(dev)
    # Haar dx: right half minus left half; dy: bottom minus top
    x = (box(r0, c, r1, c1) - box(r0, c0, r1, c)) * wt         # (K, S)
    y = (box(r, c0, r1, c1) - box(r0, c0, r, c1)) * wt
    atan2 = _atan2f if xla_bits else torch.atan2
    two_pi = torch.tensor(2 * np.pi, dtype=torch.float32, device=patch.device)
    ang = atan2(y, x)                            # (-pi, pi]
    ang = torch.where(ang < 0, ang + two_pi, ang)
    starts = torch.from_numpy(_ORI_STARTS).to(patch.device)
    # membership: (angle - start) mod 2pi < pi/3
    d = ang[:, None, :] - starts[None, :, None]
    d = torch.where(d < 0, d + two_pi, d)
    m = (d < torch.tensor(_ORI_WIN, dtype=torch.float32,
                          device=patch.device)).to(torch.float32)  # (K, W, S)
    if xla_bits:
        sx = _window_sum_xla(m * x[:, None, :])
        sy = _window_sum_xla(m * y[:, None, :])
    else:
        sx = torch.einsum("kws,ks->kw", m, x)
        sy = torch.einsum("kws,ks->kw", m, y)
    best = torch.argmax(sx * sx + sy * sy, dim=-1, keepdim=True)
    return atan2(sy.gather(1, best)[:, 0], sx.gather(1, best)[:, 0])


def _oriented_patch_grads(image: torch.Tensor, rows: torch.Tensor,
                          cols: torch.Tensor, xla_bits: bool = False):
    """Keypoint-frame gradients: the dominant orientation of a 29x29 patch,
    then the (S+2)^2 grid rotated by it, sampled bilinearly from the patch.

    The grid is rotated by -theta, so its v axis maps onto the dominant
    direction (row=sin, col=cos) and an image rotation cancels (the sign of
    imagestitch_tpu/ops/features/describe.py:236-243).  ``xla_bits`` (the
    SIFT route): the angle, the rotation and the bilinear sum as XLA's CPU
    code rounds them, so SIFT's bins are the JAX package's; oriented SURF
    keeps the faster torch ops (its sums move by ulps, not bins)."""
    patch = _patch_gather(image, rows, cols, _ORI_G, _ORI_R)
    theta = _dominant_orientation(patch, xla_bits)
    base = torch.arange(_S + 2, dtype=torch.float32,
                        device=image.device) - (_S + 1) / 2.0
    u = base[:, None].expand(_S + 2, _S + 2)
    v = base[None, :].expand(_S + 2, _S + 2)
    ru, rv = _rot(-theta, u[None], v[None], xla_bits)
    q = _bilinear_from_patch(patch, ru + _ORI_R, rv + _ORI_R, xla_bits)
    return _grads_from_samples(q)


# glibc's float32 atan2 (sysdeps/ieee754/flt-32/e_atan2f.c, s_atanf.c; the
# fdlibm algorithm), which XLA's CPU code calls for the JAX package
_ATAN_HI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
            1.5707962513e+00)
_ATAN_LO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
            7.5497894159e-08)
_ATAN_T = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
           -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
           6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
           -3.6531571299e-02, 1.6285819933e-02)
_PI, _PI_LO = 3.1415927410e+00, -8.7422776573e-08
_PI_O_2 = 1.5707963705e+00


@functools.lru_cache(maxsize=None)
def _const(value: float, device: torch.device) -> torch.Tensor:
    """A float32 scalar tensor on ``device``, made and copied there once:
    a divisor on the card must be a tensor (a Python-scalar divisor is a
    multiply by its reciprocal), and a fresh copy each call would make the
    host wait for the card."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``atanf`` of a float32 tensor of finite values >= 0 below
    2^25, each operation rounded to float32 (the constants are float32
    values; a float32 tensor's sum or product with a Python float rounds
    once in float32)."""
    # argument reduction: id -1 below 7/16, 0 below 11/16, 1 below 19/16,
    # 2 below 39/16, else 3
    r0 = (2.0 * x - 1.0) / (2.0 + x)
    r1 = (x - 1.0) / (x + 1.0)
    r2 = (x - 1.5) / (1.5 * x + 1.0)
    r3 = torch.full_like(x, -1.0) / x
    ids = ((x >= 0.4375).to(torch.int64) + (x >= 0.6875) + (x >= 1.1875)
           + (x >= 2.4375))
    red = torch.stack([x, r0, r1, r2, r3]).gather(0, ids[None])[0]
    t = _ATAN_T
    z = red * red
    w = z * z
    s1 = z * (t[0] + w * (t[2] + w * (t[4] + w * (t[6] + w * (t[8]
                                                              + w * t[10])))))
    s2 = w * (t[1] + w * (t[3] + w * (t[5] + w * (t[7] + w * t[9]))))
    small = red - red * (s1 + s2)
    hi = torch.zeros_like(x)
    lo = torch.zeros_like(x)
    for k in range(4):
        hi = torch.where(ids == k + 1, _ATAN_HI[k], hi)
        lo = torch.where(ids == k + 1, _ATAN_LO[k], lo)
    big = hi - ((red * (s1 + s2) - lo) - red)
    out = torch.where(ids == 0, small, big)
    return torch.where(x < 2.0 ** -29, x, out)


def _atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's ``atan2f`` of float32 tensors (finite values), elementwise in
    float32 torch ops, the same on the card and the CPU: atanf(|y / x|),
    then the quadrant by the signs; exact zeros and ratios beyond 2^60
    as glibc takes them."""
    ay, ax = y.abs(), x.abs()
    q = ay / torch.where(ax == 0, torch.ones_like(ax), ax)
    # exponent difference of |y| and |x| (k of glibc)
    k = torch.frexp(ay)[1] - torch.frexp(ax)[1]
    z = _atanf(torch.where(q < 2.0 ** 25, q, torch.ones_like(q)))
    z = torch.where(q >= 2.0 ** 25,
                    _f32(np.float32(_ATAN_HI[3]) + np.float32(_ATAN_LO[3])),
                    z)
    z = torch.where(k > 60, _f32(np.float32(_PI_O_2) + np.float32(0.5)
                                 * np.float32(_PI_LO)), z)
    neg_x = torch.signbit(x)
    z = torch.where(neg_x & (k < -60), torch.zeros_like(z), z)
    pos = torch.where(neg_x, _PI - (z - _PI_LO), z)
    out = torch.where(torch.signbit(y),
                      torch.where(neg_x, (z - _PI_LO) - _PI, -z), pos)
    # y == 0: +-0 for x >= +0, +-pi for x <= -0; x == 0: +-pi/2
    at_y0 = torch.where(neg_x, torch.where(torch.signbit(y), -_PI, _PI), y)
    at_x0 = torch.where(torch.signbit(y), -_PI_O_2, _PI_O_2)
    out = torch.where(ax == 0, at_x0, out)
    return torch.where(ay == 0, at_y0, out)


def _sift_from_grads(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """(K, S, S) weighted gradients -> (K, 128) SIFT vector: the magnitude
    of each gradient into one of 8 orientation bins (glibc's atan2f, the
    bin ``floor((ori + pi) / (pi / 4)) % 8``) of its 4x4 subregion, L2
    normalised, clipped at 0.2, normalised again.  gx * gx + gy * gy
    rounds once, as XLA fuses it."""
    k = gx.shape[0]
    mag = torch.sqrt(_fma(gx, gx, gy * gy))
    ori = _atan2f(gy, gx)
    width = _const(2 * np.pi / 8, gx.device)
    b = torch.remainder(torch.floor((ori + np.pi) / width).to(torch.int64), 8)
    onehot = torch.nn.functional.one_hot(b, 8).to(mag.dtype) * mag[..., None]
    sub = _S // _SUB
    hist = onehot.reshape(k, _SUB, sub, _SUB, sub, 8).sum(dim=(2, 4))
    d = hist.reshape(k, 128)
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)
    d = torch.clamp_max(d, 0.2)
    return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)


@functools.lru_cache(maxsize=8)
def _orb_pattern(patch_size: int, wta_k: int, seed: int = 7) -> np.ndarray:
    """Fixed BRIEF sampling pattern: (_ORB_BITS, max(wta_k, 2), 2) float32
    offsets in the patch (Gaussian, sigma = patch / 5), clipped one pixel
    inside; numpy's ``default_rng(seed)`` draws it, as in the JAX package."""
    rng = np.random.default_rng(seed)
    half = patch_size // 2
    pts = np.clip(rng.normal(0, patch_size / 5.0,
                             (_ORB_BITS, max(wta_k, 2), 2)),
                  -(half - 1), half - 1)
    return pts.astype(np.float32)


def _orb_theta(patch: torch.Tensor, half: int) -> torch.Tensor:
    """ORB's intensity-centroid orientation: atan2(m01, m10) over the
    patch disk of radius ``half``."""
    g = patch.shape[-1]
    ax = torch.arange(g, dtype=torch.float32,
                      device=patch.device) - (g - 1) / 2.0
    rr = ax[:, None].expand(g, g)
    cc = ax[None, :].expand(g, g)
    disk = (rr * rr + cc * cc) <= float(half * half)
    pw = torch.where(disk, patch, torch.zeros_like(patch))
    m01 = (pw * rr).sum(dim=(1, 2))
    m10 = (pw * cc).sum(dim=(1, 2))
    return _atan2f(m01, m10)


def _orb_bits(image: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
              smooth: torch.Tensor, params: DescribeParams) -> torch.Tensor:
    """(K, D) float {0, 1} BRIEF bits (the float form feeds the Hamming
    product): one patch gather a keypoint from the pre-smoothed image, then
    the ``wta_k`` x 256 test points sampled bilinearly from it, rotated by
    -theta unless ``upright``.  ``wta_k`` <= 2: bit = p0 < p1; above, each
    test's argmax as a one-hot symbol of ``wta_k`` bits."""
    half = params.patch_size // 2
    # rotated points reach sqrt(2) * half; +2 bilinear/round margin
    g = 2 * (int(np.ceil(half * np.sqrt(2.0))) + 2) + 1
    margin = g // 2
    k = rows.shape[0]
    patch = _patch_gather(smooth, rows, cols, g, margin)
    pts = torch.from_numpy(_orb_pattern(params.patch_size,
                                        params.wta_k)).to(image.device)
    pu = pts[None, :, :, 0].expand(k, *pts.shape[:2])
    pv = pts[None, :, :, 1].expand(k, *pts.shape[:2])
    if params.upright:
        ru, rv = pu, pv
    else:
        ru, rv = _rot(-_orb_theta(patch, half), pu, pv)
    vals = _bilinear_from_patch(patch, ru + margin, rv + margin)
    if params.wta_k <= 2:
        return (vals[:, :, 0] < vals[:, :, 1]).to(torch.float32)
    sym = torch.argmax(vals[:, :, :params.wta_k], dim=-1)
    onehot = torch.nn.functional.one_hot(sym, params.wta_k)
    return onehot.to(torch.float32).reshape(k, _ORB_BITS * params.wta_k)


def describe_windows(q: torch.Tensor, extended: bool) -> torch.Tensor:
    """(K, 18, 18) sample windows -> (K, 64|128) upright SURF."""
    gw = weight_table(q.device)
    gx, gy = _grads_from_samples(q)
    return _surf_from_grads(gx * gw, gy * gw, extended)


def describe_batch(images: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                   params: DescribeParams = DescribeParams()) -> torch.Tensor:
    """Descriptors for a (P, H, W) batch with (P, K) keypoints -> (P, K, D)
    float32: SURF or SIFT (upright or oriented) or ORB bits, whose image is
    first smoothed by [0.25, 0.5, 0.25] on both axes."""
    x = images.to(torch.float32)
    if params.family == "orb":
        box = np.array([0.25, 0.5, 0.25], np.float32)
        smooth = _sep_conv2(x, box, box, fused=True)
        return torch.stack([_orb_bits(x[p], rows[p], cols[p], smooth[p],
                                      params) for p in range(x.shape[0])])
    gw = weight_table(x.device)
    out = []
    for p in range(x.shape[0]):
        if params.upright:
            gx, gy = _grads_from_samples(
                _patch_gather(x[p], rows[p], cols[p], _S + 2, _S // 2))
        else:
            gx, gy = _oriented_patch_grads(
                x[p], rows[p], cols[p], xla_bits=params.family == "sift")
        if params.family == "sift":
            out.append(_sift_from_grads(gx * gw, gy * gw))
        else:
            out.append(_surf_from_grads(gx * gw, gy * gw,
                                        params.family == "surf-extended"))
    return torch.stack(out)


def pyramid_atlas(octave_images: Sequence[torch.Tensor]):
    """Stack octave images into one vertical float32 atlas, each band
    zero-padded to the octave-0 width and wrapped in ``ATLAS_GUARD`` zero
    rows -> (atlas, first atlas row of each band)."""
    w0 = octave_images[0].shape[1]
    bands, offsets = [], []
    off = 0
    for im in octave_images:
        h_o, w_o = im.shape
        bands.append(torch.nn.functional.pad(
            im.to(torch.float32), (0, w0 - w_o, ATLAS_GUARD, ATLAS_GUARD)))
        offsets.append(off + ATLAS_GUARD)
        off += h_o + 2 * ATLAS_GUARD
    return torch.cat(bands, dim=0), offsets


def describe_from_pyramid(octave_images: Sequence[torch.Tensor],
                          r_loc: torch.Tensor, c_loc: torch.Tensor,
                          octave_ids: torch.Tensor,
                          params: DescribeParams) -> torch.Tensor:
    """Describe keypoints spread across octave images with ONE batched call
    over the ``pyramid_atlas``."""
    return describe_from_atlas(*pyramid_atlas(octave_images), r_loc, c_loc,
                               octave_ids, params)


def describe_from_atlas(atlas: torch.Tensor, offsets: Sequence[int],
                        r_loc: torch.Tensor, c_loc: torch.Tensor,
                        octave_ids: torch.Tensor,
                        params: DescribeParams) -> torch.Tensor:
    """``describe_from_pyramid`` over an atlas already built: octave ``o``'s
    image starts at atlas row ``offsets[o]``."""
    offs = torch.tensor(offsets, dtype=torch.float32)
    if atlas.is_cuda:                    # from pinned memory: no host wait
        offs = offs.pin_memory().to(atlas.device, non_blocking=True)
    band_off = offs[octave_ids.long()]
    return describe_batch(atlas[None], (r_loc + band_off)[None], c_loc[None],
                          params)[0]
