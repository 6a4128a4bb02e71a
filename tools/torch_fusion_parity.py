#!/usr/bin/env python3
"""How far the port's fusion modes are from the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_fusion_parity.py

Composes a gray serpentine of sub-pixel-blob frames (utils/synthetic.py,
seed 7; 10 frames of 484 x 646, a quarter of the smoke's 1936 x 2584 on
each axis, 5 down, 1 right, 4 up at the smoke's overlap fractions) with
the true integer offsets, in every fusion mode, through both packages'
``compose`` on the CPU, and prints one JSON line: for each mode the share
of the fused-rect pixels that differ, the largest difference, and whether
every pixel outside the fused rects is equal.  Imports both packages, as
the tests do; the port itself never imports jax.
"""
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from imagestitch_tpu import StitchConfig as JStitchConfig  # noqa: E402
from imagestitch_tpu.core import compose as jcompose  # noqa: E402
from imagestitch_tpu_torch import StitchConfig  # noqa: E402
from imagestitch_tpu_torch.core import compose as tcompose  # noqa: E402
from imagestitch_tpu_torch.utils import synthetic  # noqa: E402

MODES = ("notFuse", "average", "maximum", "minimum", "fadeInAndFadeOut",
         "trigonometric", "multiBandBlending", "optimalSeamLine")


def main():
    torch.set_num_threads(2)
    h, w = 484, 646
    positions = synthetic.serpentine_positions(5, 2, (447.59, 612.55))
    frames, truth = synthetic.sequence(7, (h, w), positions)
    offsets = [tuple(int(v) for v in t) for t in truth]
    _, steps, _ = tcompose.plan_compose(offsets, (h, w), StitchConfig())
    fused = np.zeros(tcompose.compute_placement(offsets, (h, w)).canvas_shape,
                     bool)
    rects = []
    for s in steps:
        if s[0] == "fuse":
            (rr, rc), (rh, rw) = s[3], s[4]
            fused[rr:rr + rh, rc:rc + rw] = True
            rects.append((rh, rw))
    out = {"frames": [len(frames), h, w], "offsets": offsets,
           "rects": rects, "fused_pixels": int(fused.sum()), "modes": {}}
    for mode in MODES:
        got = tcompose.compose(frames, offsets, StitchConfig(fuse_method=mode),
                               device="cpu")
        ref = np.asarray(jcompose.compose(frames, offsets,
                                          JStitchConfig(fuse_method=mode)))
        diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        out["modes"][mode] = {
            "fused_share_differ": float((diff[fused] != 0).mean()),
            "max_diff": int(diff.max()),
            "outside_equal": not bool(diff[~fused].any())}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
