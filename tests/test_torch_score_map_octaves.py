"""K4 over a frame's octave bands in one call (``doh_score_map_octaves``)
and the score-map pool on it.

On the CPU: the ordering of compacted survivors (``top_k_from_survivors``)
against ``_top_k_stable`` of the full score map, the survivors fed in a
shuffled order as the kernel's atomics may leave them; the pool against the
JAX package's ``_detect_describe_image_pallas`` (its K4 in interpret mode);
the pool's launch-ahead order.  On a GPU: the one-launch kernel route
bit-equal to the plain route in every slot and raw value, and the pool's
kernel route equal to its plain route."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagestitch_tpu.core import feature_registration as jfr
from imagestitch_tpu.ops.features import describe as jdescribe
from imagestitch_tpu.ops.features import detect as jdetect
from imagestitch_tpu.ops.pallas import doh as jdoh
from imagestitch_tpu_torch import FeatureConfig, StitchConfig
from imagestitch_tpu_torch.core import feature_registration as freg
from imagestitch_tpu_torch.ops.features import describe as tdescribe
from imagestitch_tpu_torch.ops.features import detect as tdetect
from imagestitch_tpu_torch.ops.kernels import doh as tdoh
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import two_threads

DPARAMS = freg._detect_params(StitchConfig(features=FeatureConfig()))
TAPS = dict(threshold=DPARAMS.threshold, n_scales=DPARAMS.n_octave_layers,
            base_sigma=DPARAMS.base_sigma,
            spacing=2.0 ** (1.0 / DPARAMS.n_octave_layers))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _image(seed, h, w):
    return torch.as_tensor(synthetic.textured(np.random.default_rng(seed),
                                              h, w))


def _budgets(bands, max_kp=6144):
    return [min(tdetect.octave_budget(max_kp, o, DPARAMS.octave_topk_decay),
                h * w) for o, (_, h, w, *_) in enumerate(bands)]


def _ties(score):
    """Every third survivor takes the score of the first: equal scores at
    distinct indices."""
    flat = score.reshape(-1).clone()
    live = flat.nonzero()[:, 0]
    flat[live[::3]] = float(flat[live[0]])
    return flat.view_as(score)


# (image, border, kk from the survivor count n, score edit)
CASES = {
    "equal_scores": (lambda: _image(1, 60, 70), 4, lambda n: n // 2 + 7,
                     _ties),
    # border 1: row 0 holds w = 53 zeros, and the fill of kk - n = 150
    # runs on into row 2, past a survivor there
    "fill_past_row_0": (lambda: _image(2, 40, 53), 1, lambda n: n + 150,
                        None),
    "kk_below_count": (lambda: _image(3, 64, 64), 8, lambda n: n // 3,
                       None),
    "blank_band": (lambda: torch.full((30, 41), 17.0), 2, lambda n: 100,
                   None),
}


def _band(case):
    """(flat score map, survivor indices, kk) of one CASES entry."""
    make, border, kk_of, edit = CASES[case]
    score, _ = tdoh.doh_score_map_plain(make(), border=border, **TAPS)
    if edit is not None:
        score = edit(score)
    flat = score.reshape(-1)
    live = (flat > 0).nonzero()[:, 0]
    return flat, live, kk_of(live.numel())


@pytest.mark.parametrize("case", list(CASES))
def test_survivor_ordering_equals_stable_sort(case):
    """The case's band is band 1 of two; band 0 (the "kk_below_count"
    band) shares the list, its keys shuffled in among band 1's."""
    bands = [_band("kk_below_count"), _band(case)]
    flat, live, kk = bands[1]
    n = live.numel()
    assert (n == 0) == (case == "blank_band")
    keys = torch.cat([tdoh.survivor_keys(f[v], v, b)
                      for b, (f, v, _) in enumerate(bands)])
    keys = keys[torch.as_tensor(np.random.default_rng(0).permutation(
        keys.numel()))]
    got = tdoh.top_k_from_survivors(
        keys, [v.numel() for _, v, _ in bands],
        [f.numel() for f, _, _ in bands], [k for _, _, k in bands])
    for (got_s, got_i), (f, _, k) in zip(got, bands):
        ref_s, ref_i = tdoh._top_k_stable(f, k)
        assert got_s.dtype == torch.float32 and got_i.dtype == torch.int64
        assert torch.equal(got_s, ref_s) and torch.equal(got_i, ref_i)
    fill = got[1][1][min(n, kk):]
    if case == "blank_band":
        assert torch.equal(fill, torch.arange(kk))
    elif case == "fill_past_row_0":     # not 0..kk-n-1: it skips a survivor
        assert fill[-1] >= 2 * 53
        assert not torch.equal(fill, torch.arange(kk - n))
    else:
        assert fill.numel() == 0


def test_score_map_pool_matches_jax(monkeypatch):
    """Three octaves, oriented: the same live slots in the same order,
    scores and positions to float32 rounding, descriptors to 1e-4 on 99%
    of slots (test_torch_oriented.py's tolerances)."""
    monkeypatch.setattr(jdoh, "doh_score_map",
                        functools.partial(jdoh.doh_score_map, interpret=True))
    img = np.rint(synthetic.textured(np.random.default_rng(17), 600, 700)
                  ).astype(np.uint8)
    max_kp = 2048
    fam = "surf-extended"
    ref = [np.asarray(a) for a in jfr._detect_describe_image_pallas(
        jnp.asarray(img), max_kp, jdetect.DetectParams(),
        jdescribe.DescribeParams(family=fam, upright=False))]
    assert len(freg.octaves(torch.as_tensor(img), DPARAMS)) == 3
    got = [a.numpy() for a in freg.score_map_pool(
        torch.as_tensor(img), max_kp, tdetect.DetectParams(),
        tdescribe.DescribeParams(family=fam, upright=False))]
    assert got[3].shape == ref[3].shape == (max_kp, 128)
    live = ref[2] > 0
    np.testing.assert_array_equal(got[2] > 0, live)
    assert live.sum() > 1000
    np.testing.assert_allclose(got[2][live], ref[2][live], rtol=1e-5, atol=0)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g[live], r[live], rtol=0, atol=1e-4)
    err = np.abs(got[3][live] - ref[3][live]).max(axis=1)
    assert (err < 1e-4).mean() >= 0.99


def test_pool_launches_the_next_frame_first(monkeypatch):
    """One K4 call a frame, frame i + 1's launched before frame i's
    survivors are read; the atlas the describe reads is K4's."""
    events = []
    launch = tdoh.launch_score_map_octaves

    def logged(atlas, bands, kks, **kw):
        k = sum(e[0] == "launch" for e in events)
        events.append(("launch", k))
        finish = launch(atlas, bands, kks, **kw)
        return lambda: events.append(("finish", k)) or finish()

    monkeypatch.setattr(tdoh, "launch_score_map_octaves", logged)
    atlases = []
    from_atlas = tdescribe.describe_from_atlas
    monkeypatch.setattr(tdescribe, "describe_from_atlas",
                        lambda atlas, *a: atlases.append(atlas)
                        or from_atlas(atlas, *a))
    images = torch.stack([_image(s, 300, 260) for s in (4, 5, 6)])
    pool = freg.pool_features(images, DPARAMS, freg._describe_params(
        StitchConfig()), max_pool=700)
    assert events == [("launch", 0), ("launch", 1), ("finish", 0),
                      ("launch", 2), ("finish", 1), ("finish", 2)]
    _, atlas, _ = freg.octave_atlas(images[2], DPARAMS)
    assert torch.equal(atlases[2], atlas)
    single = freg.score_map_pool(images[2], 700, DPARAMS,
                                 freg._describe_params(StitchConfig()))
    for p, s in zip(pool, single):
        assert torch.equal(p[2], s)


def test_bad_budgets_and_threshold_raise():
    _, atlas, bands = freg.octave_atlas(_image(7, 60, 50), DPARAMS)
    with pytest.raises(ValueError, match="kk_per_band"):
        tdoh.doh_score_map_octaves(atlas, bands, [60 * 50 + 1])
    with pytest.raises(ValueError, match="kk_per_band"):
        tdoh.doh_score_map_octaves(atlas, bands, [0])
    with pytest.raises(ValueError, match="threshold"):
        tdoh.doh_score_map_octaves(atlas, bands, [10], threshold=-1.0)
    with pytest.raises(ValueError, match="outside"):
        tdoh.doh_score_map_octaves(atlas[:40], bands, [10])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(1936, 2584), (701, 903)])
def test_cuda_one_launch_bit_equal(cuda_device, hw):
    """Every slot's score and index and every raw value bit-equal to the
    plain route, in one launch; on the odd size the last band's budget is
    all its pixels, so its slots end in the zero fill."""
    if hw == (1936, 2584):
        img = synthetic.sequence(7, hw, [(0.5, 0.5)])[0][0]
    else:
        img = synthetic.textured(np.random.default_rng(8), *hw)
    _, atlas, bands = freg.octave_atlas(torch.as_tensor(img,
                                                        device=cuda_device),
                                        DPARAMS)
    kks = _budgets(bands)
    if hw != (1936, 2584):
        kks[-1] = bands[-1][1] * bands[-1][2]
    before = tdoh.SCORE_MAP_LAUNCHES
    got = tdoh.doh_score_map_octaves(atlas, bands, kks, **TAPS)
    assert tdoh.SCORE_MAP_LAUNCHES == before + 1
    ref = tdoh.doh_score_map_octaves(atlas, bands, kks, use_kernel=False,
                                     **TAPS)
    assert tdoh.SCORE_MAP_LAUNCHES == before + 1
    assert len(got) == (4 if hw == (1936, 2584) else 3)
    for (s, i, raw), (rs, ri, rraw) in zip(got, ref):
        assert torch.equal(s, rs) and torch.equal(i, ri)
        assert torch.equal(raw, rraw)
        assert int((s > 0).sum()) > 0
    if hw != (1936, 2584):
        assert float(got[-1][0][-1]) == 0.0


@pytest.mark.cuda
def test_cuda_score_map_pool_kernel_equals_plain(cuda_device):
    """Rows, cols and scores bit-equal, descriptors within 1e-5 (the same
    dense describe on the same atlas)."""
    img = torch.as_tensor(synthetic.sequence(7, (1936, 2584), [(0.5, 0.5)]
                                             )[0][0], device=cuda_device)
    sp = freg._describe_params(StitchConfig())
    before = tdoh.SCORE_MAP_LAUNCHES
    got = freg.score_map_pool(img, 6144, DPARAMS, sp)
    assert tdoh.SCORE_MAP_LAUNCHES == before + 1
    ref = freg.score_map_pool(img, 6144, DPARAMS, sp, use_kernels=False)
    for g, r in zip(got[:3], ref[:3]):
        assert torch.equal(g, r)
    assert int((got[2] > 0).sum()) > 5000
    torch.testing.assert_close(got[3], ref[3], rtol=0, atol=1e-5)
