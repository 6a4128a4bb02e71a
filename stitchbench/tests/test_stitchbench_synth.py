"""The card's generator against a frozen numpy copy of the port's
``utils/synthetic.py`` (texture, color planes, bilinear frames), fed the
same draws, at a small size; and the project geometry."""
import numpy as np
import pytest
import torch

from stitchbench import project, synth

TEX = {"density": 4e-3, "sigmas": [1.2, 1.8, 2.6], "amp": [40.0, 160.0],
       "level": 20.0, "noise": 1.0}


# ---- frozen numpy copy of utils/synthetic.py (textured, sample), its
# random draws passed in
def _blur_np(x, sigma):
    r = int(np.ceil(3 * sigma))
    t = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    h, w = x.shape
    xp = np.pad(x, r)
    y = sum(xp[i:i + h, :] * k[i] for i in range(2 * r + 1))
    return sum(y[:, i:i + w] * k[i] for i in range(2 * r + 1))


def _textured_np(h, w, blobs, noise):
    tex = np.full((h, w), 20.0, np.float32)
    for sigma, (y, x, amp) in zip((1.2, 1.8, 2.6), blobs):
        y0 = np.minimum(np.floor(y).astype(np.int64), h - 2)
        x0 = np.minimum(np.floor(x).astype(np.int64), w - 2)
        fy, fx = y - y0, x - x0
        imp = np.zeros((h, w), np.float32)
        for dy, dx, wt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                           (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            np.add.at(imp, (y0 + dy, x0 + dx), (amp * wt).astype(np.float32))
        tex += _blur_np(imp, sigma)
    tex += noise
    return np.clip(tex, 0, 255).astype(np.float32)


def _sample_np(tex, r, c, h, w):
    r0, c0 = int(np.floor(r)), int(np.floor(c))
    fr, fc = np.float32(r - r0), np.float32(c - c0)
    t = tex[r0:r0 + h + 1, c0:c0 + w + 1]
    out = ((1 - fr) * (1 - fc) * t[:-1, :-1] + (1 - fr) * fc * t[:-1, 1:]
           + fr * (1 - fc) * t[1:, :-1] + fr * fc * t[1:, 1:])
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def test_texture_and_frames_match_the_numpy_rules():
    h, w = 96, 128
    gen = torch.Generator().manual_seed(5)
    blobs = synth.draw_blobs(gen, h, w, TEX)
    noise = torch.randn((h, w), generator=gen)
    got = synth.texture_from_draws(h, w, TEX, blobs, noise).numpy()
    want = _textured_np(h, w, [tuple(t.numpy() for t in b) for b in blobs],
                        noise.numpy())
    assert len(blobs[0][0]) == int(4e-3 * h * w) // 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    for r, c in ((0.37, 0.29), (10.81, 3.5), (20.0, 30.25)):
        a = synth.sample(torch.from_numpy(want), r, c, 40, 60).numpy()
        b = _sample_np(want, r, c, 40, 60)
        assert np.array_equal(a, b)


def test_color_planes_follow_gain_and_offset():
    gen = torch.Generator().manual_seed(1)
    base = torch.full((32, 32), 100.0)
    planes = synth.color_planes(gen, base, [[0.75, 20.0], [1.0, 0.0],
                                            [0.9, 10.0]], 1.0)
    means = [float(p.mean()) for p in planes]
    assert means == pytest.approx([95.0, 100.0, 100.0], abs=0.5)


def test_project_geometry_is_the_same_set_for_every_seed(tiny):
    a, b = project.positions(tiny, 1), project.positions(tiny, 2 ** 33 + 7)
    steps = tiny["geometry"]["steps"]
    for pos in (a, b):
        d = np.diff(pos, axis=0)
        # frame 1 is dropped: the first pair spans steps 0 and 1
        extra = d - np.asarray([np.add(steps[0], steps[1])] + steps[2:])
        assert np.all((extra[0] >= 0.3) & (extra[0] <= 1.7))
        assert np.all((extra[1:] >= 0.15) & (extra[1:] <= 0.85))
        frac = d - np.trunc(d)
        assert np.all(np.abs(frac) > 1e-3)
        assert pos.min() == pytest.approx(tiny["margin"])
    assert not np.array_equal(a, b)
    line = dict(tiny, geometry={"kind": "line", "rows": [-5, 3, 9],
                                "cols": [-300, -310, -320]})
    for seed in (3, 4):
        d = np.diff(project.positions(line, seed), axis=0)
        assert sorted(np.floor(d[:, 1]).tolist()) == [-320, -310, -300]


def test_build_is_seeded(tiny):
    tiny["frame_hw"] = [64, 80]
    tiny["geometry"] = {"kind": "line", "rows": [3, -2], "cols": [-50, -45]}
    one = project.build(tiny, 123, torch.device("cpu"))
    two = project.build(tiny, 123, torch.device("cpu"))
    other = project.build(tiny, 124, torch.device("cpu"))
    assert one.color.shape == (3, 64, 80, 3) and one.color.dtype == np.uint8
    assert np.array_equal(one.color, two.color)
    assert not np.array_equal(one.color, other.color)
    np.testing.assert_allclose(one.truth, np.diff(one.positions, axis=0))
