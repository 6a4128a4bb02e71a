"""K1 over a frame's octaves in one call (``doh_select_octaves``): the CPU
route against ``doh_select_plain`` per octave and against the Pallas kernel
in interpret mode, the tap tables built once, and on a GPU the one-launch
kernel bit-equal to the plain version at full size and at ragged sizes.

Inputs are seeded textures with sub-pixel blob centres and noise, so no
two candidates tie exactly.  Empty slots (score <= 0) carry arbitrary
other fields and are compared by score only."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagestitch_tpu.ops.pallas import doh as jdoh
from imagestitch_tpu_torch import FeatureConfig, StitchConfig
from imagestitch_tpu_torch.core import feature_registration as freg
from imagestitch_tpu_torch.ops.features import describe as tdescribe
from imagestitch_tpu_torch.ops.features import detect as tdetect
from imagestitch_tpu_torch.ops.kernels import doh as tdoh
from imagestitch_tpu_torch.utils import synthetic

RAGGED = [(157, 203), (300, 389)]
DPARAMS = freg._detect_params(StitchConfig(features=FeatureConfig(
    upright=True)))
TAPS = dict(threshold=DPARAMS.threshold, n_scales=DPARAMS.n_octave_layers,
            base_sigma=DPARAMS.base_sigma,
            spacing=2.0 ** (1.0 / DPARAMS.n_octave_layers))


def _image(seed, h, w):
    return torch.as_tensor(synthetic.textured(np.random.default_rng(seed),
                                              h, w))


def _two_bands(img):
    """The image and its 2x2 pool as bands of one pyramid atlas."""
    octs = [img.to(torch.float32), tdetect._pool2(img.to(torch.float32))]
    atlas, offs = tdescribe.pyramid_atlas(octs)
    bands = [(off, *x.shape, b, rc)
             for x, off, b, rc in zip(octs, offs, (8, 4), (4, 2))]
    return octs, atlas, bands


def _assert_same(got, ref):
    """Scores equal everywhere; columns and offsets on the live slots."""
    sc, col, dr, dc = got
    rsc, rcol, rdr, rdc = ref
    live = rsc > 0
    assert int(live.sum()) > 0
    assert torch.equal(sc, rsc)
    assert torch.equal(col[live], rcol[live])
    assert torch.equal(dr[live], rdr[live]) and torch.equal(dc[live],
                                                            rdc[live])


def _per_octave_plain(octs, bands):
    return [tdoh.doh_select_plain(x, rc, border=b, **TAPS)
            for x, (_, _, _, b, rc) in zip(octs, bands)]


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cpu_route_equals_plain_per_octave(two_threads):
    """A frame's octaves, stacked as select_candidates stacks them."""
    octs, atlas, bands = freg.octave_atlas(_image(1, 520, 600), DPARAMS)
    assert len(bands) == 3 and [b[4] for b in bands] == [4, 2, 2]
    got = tdoh.doh_select_octaves(atlas, bands, **TAPS)
    for g, r, (_, h, _, _, rc) in zip(
            got, _per_octave_plain([x for _, x, _ in octs], bands), bands):
        assert g[0].shape == (h, rc) and g[1].dtype == torch.int32
        _assert_same(g, r)


@pytest.mark.parametrize("hw", RAGGED)
def test_cpu_route_ragged_sizes(two_threads, hw):
    octs, atlas, bands = _two_bands(_image(2, *hw))
    got = tdoh.doh_select_octaves(atlas, bands, **TAPS)
    for g, r in zip(got, _per_octave_plain(octs, bands)):
        _assert_same(g, r)


def test_cpu_route_matches_pallas_interpret(two_threads):
    octs, atlas, bands = _two_bands(_image(3, *RAGGED[0]))
    got = tdoh.doh_select_octaves(atlas, bands, **TAPS)
    for x, (_, _, _, b, rc), g in zip(octs, bands, got):
        ref = jdoh.doh_select(jnp.asarray(x.numpy()), r_cands=rc, border=b,
                              interpret=True, **TAPS)
        ref = [torch.as_tensor(np.array(a)) for a in ref]
        live = ref[0] > 0
        torch.testing.assert_close(g[0], ref[0], rtol=1e-5, atol=1e-4)
        assert torch.equal(g[0] > 0, live)
        assert torch.equal(g[1][live], ref[1][live].to(torch.int32))
        for k in (2, 3):
            torch.testing.assert_close(g[k][live], ref[k][live], rtol=0,
                                       atol=1e-5)


def test_tap_tables_built_once(monkeypatch):
    calls = []
    scale_taps = tdoh._scale_taps
    monkeypatch.setattr(tdoh, "_scale_taps",
                        lambda *a: calls.append(a) or scale_taps(*a))
    tdoh._tap_tables.cache_clear()
    first = tdoh._tap_tables(3, 1.2, 1.6)
    again = tdoh._tap_tables(3, 1.2, 1.6)
    assert len(calls) == 1 and all(a is b for a, b in zip(first, again))
    assert not any(a.flags.writeable for a in first)
    tdoh._tap_tables(3, 1.2, 2.0 ** (1.0 / 3.0))
    assert len(calls) == 2
    tdoh._tap_tables.cache_clear()


def test_select_candidates_makes_one_call(two_threads, monkeypatch):
    calls = []
    octaves = tdoh.doh_select_octaves
    monkeypatch.setattr(tdoh, "doh_select_octaves",
                        lambda atlas, bands, **kw: calls.append(bands)
                        or octaves(atlas, bands, **kw))
    freg.select_candidates(_image(4, 520, 600), DPARAMS)
    assert len(calls) == 1 and len(calls[0]) == 3


def test_bands_outside_the_kernel_raise():
    atlas = torch.zeros(40, 50)
    with pytest.raises(ValueError, match="r_cands"):
        tdoh.doh_select_octaves(atlas, [(0, 40, 50, 8, 9)])
    with pytest.raises(ValueError, match="outside"):
        tdoh.doh_select_octaves(atlas, [(10, 40, 50, 8, 4)])
    with pytest.raises(ValueError, match="octaves"):
        tdoh.doh_select_octaves(atlas, [(0, 4, 5, 1, 1)] * 9)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_one_launch_bit_equal_full_size(cuda_device):
    """The four octaves of a 1936x2584 frame, one kernel call."""
    frame = synthetic.sequence(7, (1936, 2584), [(0.5, 0.5)])[0][0]
    octs, atlas, bands = freg.octave_atlas(
        torch.as_tensor(frame, device=cuda_device), DPARAMS)
    assert len(bands) == 4
    before = tdoh.LAUNCHES
    got = tdoh.doh_select_octaves(atlas, bands, **TAPS)
    assert tdoh.LAUNCHES == before + 1
    ref = tdoh.doh_select_octaves(atlas, bands, use_kernel=False, **TAPS)
    for g, r in zip(got, ref):
        _assert_same(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", RAGGED)
def test_cuda_ragged_bit_equal(cuda_device, hw):
    octs, atlas, bands = _two_bands(_image(5, *hw).to(cuda_device))
    before = tdoh.LAUNCHES
    got = tdoh.doh_select_octaves(atlas, bands, **TAPS)
    assert tdoh.LAUNCHES == before + 1
    for g, r in zip(got, _per_octave_plain(octs, bands)):
        _assert_same(g, r)
