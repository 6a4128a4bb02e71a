"""K4 (doh_score_map): the port's plain version against the Pallas kernel in
interpret mode, and the CUDA kernel against the plain version on a GPU.

Inputs are seeded numpy textures with sub-pixel blob centres and noise, at
odd and even sizes (the Pallas kernel pads rows to its 64-row tile and
columns to a lane multiple, both with edge replication)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagestitch_tpu.ops.pallas import doh as jdoh
from imagestitch_tpu_torch.ops.kernels import doh as tdoh
from imagestitch_tpu_torch.utils import synthetic

SPACINGS = [2.0 ** (1.0 / 3.0), 1.6]


def _image(seed, h, w):
    return synthetic.textured(np.random.default_rng(seed), h, w)


@pytest.mark.parametrize("spacing", SPACINGS)
@pytest.mark.parametrize("hw", [(160, 200), (157, 203)])
def test_plain_matches_pallas_interpret(spacing, hw):
    """NMS masks equal, score and raw within 1e-4 relative (XLA on the CPU
    may contract the correlations into FMAs; the plain version rounds every
    product)."""
    img = _image(11, *hw)
    ref_s, ref_r = (np.asarray(a) for a in jdoh.doh_score_map(
        jnp.asarray(img), threshold=10.0, border=8, spacing=spacing,
        interpret=True))
    got_s, got_r = tdoh.doh_score_map(torch.as_tensor(img), threshold=10.0,
                                      border=8, spacing=spacing)
    assert got_s.shape == got_r.shape == hw
    assert got_s.dtype == got_r.dtype == torch.float32
    np.testing.assert_array_equal(got_s.numpy() > 0, ref_s > 0)
    assert (ref_s > 0).sum() > 100
    scale = np.abs(ref_r).max()
    np.testing.assert_allclose(got_s.numpy(), ref_s, rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(got_r.numpy(), ref_r, rtol=1e-4,
                               atol=1e-4 * scale)


def test_score_map_and_select_agree():
    """K1 and K4 share the response stage: each row's top-3 live scores of
    the score map are K1's candidates, and the raw response at them gives
    K1's sub-pixel offsets (detect.refine_subpixel on raw)."""
    from imagestitch_tpu_torch.ops.features import detect
    img = torch.as_tensor(_image(5, 120, 150))
    score, raw = tdoh.doh_score_map(img, border=4)
    sc, col, dr, dc = tdoh.doh_select(img, r_cands=3, border=4)
    top = torch.sort(score, dim=1, descending=True, stable=True)
    torch.testing.assert_close(sc, top.values[:, :3], rtol=0, atol=0)
    live = sc > 0
    torch.testing.assert_close(col[live], top.indices[:, :3][live].int())
    rr = torch.arange(120)[:, None].expand_as(col)[live]
    ref_dr, ref_dc = detect.refine_subpixel(raw, rr, col[live])
    torch.testing.assert_close(dr[live], ref_dr, rtol=0, atol=0)
    torch.testing.assert_close(dc[live], ref_dc, rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("spacing", SPACINGS)
def test_cuda_kernel_matches_plain(cuda_device, spacing):
    """Bit-equal to the plain version (same products and sums, no FMA
    contraction), on a size that is neither a multiple of the 8-row nor of
    the 128-column tile."""
    x = torch.as_tensor(_image(3, 701, 903), device=cuda_device)
    before = tdoh.SCORE_MAP_LAUNCHES
    got = tdoh.doh_score_map(x, spacing=spacing, border=2)
    assert tdoh.SCORE_MAP_LAUNCHES == before + 1
    ref = tdoh.doh_score_map(x, spacing=spacing, border=2, use_kernel=False)
    assert tdoh.SCORE_MAP_LAUNCHES == before + 1
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert int((got[0] > 0).sum()) > 1000
