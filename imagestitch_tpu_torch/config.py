"""Frozen configuration of the PyTorch/CUDA port.

The same fields, defaults and validation as ``imagestitch_tpu/config.py``
(every knob of the reference's class-attribute config block, reference:
ImageUtility.py:7-50, Stitcher.py:25-33, Main.py:5-14), plus one field of
its own, ``use_kernels``.  ``use_pallas`` chooses the pools as the JAX
package does on a TPU: True takes the kernel pools (K1/K2, or K4),
False the XLA detector's pool.  ``use_kernels`` chooses, for CUDA tensors,
between the hand-written Hopper kernels (True) and their plain PyTorch
versions (False; the tests and the smoke's comparison).  Field comments
below that speak of the TPU describe the JAX package's behaviour, which
the port reproduces.
"""
from __future__ import annotations

import dataclasses

# Direction convention (identical to reference Stitcher.py:26-27):
#   1: image A on top,    image B below      (overlap: A bottom strip / B top strip)
#   2: image A on left,   image B on right   (overlap: A right strip  / B left strip)
#   3: image A below,     image B on top     (overlap: A top strip    / B bottom strip)
#   4: image A on right,  image B on left    (overlap: A left strip   / B right strip)
DIRECTIONS = (1, 2, 3, 4)


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Feature detection / description / matching knobs.

    Parity with reference ImageUtility.py:14-40 (SURF/ORB parameter block).
    The TPU detector is a determinant-of-Hessian (SURF-family) or FAST-score
    (ORB-family) response computed as batched convolutions, with fixed-capacity
    top-K keypoints so every shape is static under jit.
    """
    method: str = "surf"              # "sift" | "surf" | "orb" (detector family)
    max_keypoints: int = 1024          # per-attempt capacity (reference: unbounded)
    pool_keypoints: int = 6144         # full-frame pool for the detect-once
                                       # fast path (per-strip top-K drawn from it)
    strict_roi_detect: bool = False    # True: detect per-ROI exactly like the
                                       # reference (slower; the pooled path is
                                       # offset-equivalent, see
                                       # core/feature_registration.py)
    box_filter: bool = False           # True: the reference detector's actual
                                       # integral-image SURF box filters
                                       # (ImageUtility.py:255-262) instead of
                                       # Gaussian-derivative DoH
    subpixel: bool = True              # quadratic sub-pixel keypoint positions
                                       # (cv2 keypoints are float; integer
                                       # quantization biases the mode vote)
    search_ratio: float = 0.75         # Lowe ratio test (ImageUtility.py:17)
    hessian_threshold: float = 10.0    # detector response floor.  The
                                       # reference's 100 (ImageUtility.py:23) is
                                       # in SURF *box-filter* response units;
                                       # our Gaussian-derivative DoH scale
                                       # differs — 10 keeps low-contrast (REM)
                                       # frames detectable while top-K bounds
                                       # the work either way
    n_octaves: int = 4                 # ImageUtility.py:24
    n_octave_layers: int = 3           # ImageUtility.py:25
    extended: bool = True              # 128-dim SURF descriptors (ImageUtility.py:26)
    upright: bool = False              # ImageUtility.py:28
    auto_upright: bool = True          # engine fast path: register with
                                       # UPRIGHT descriptors first (micrograph
                                       # stages translate without rotating, so
                                       # orientation estimation — ~85% of
                                       # detect/describe device time — buys
                                       # nothing), falling back to oriented
                                       # descriptors for any pair that fails.
                                       # Set False for strict single-pass
                                       # reference behavior.
    octave_topk_decay: int = 4         # per-octave keypoint budget divisor
                                       # (see ops/features/detect.DetectParams)
    fused_select: bool = True          # TPU pooled path: fuse candidate
                                       # selection + subpixel into the Pallas
                                       # DoH kernel (per-row top-R structural
                                       # capacity) and describe via the
                                       # band-streaming atlas kernel — every
                                       # XLA top-k/gather at k~6k costs ms on
                                       # the v5e (ops/pallas/doh.doh_select).
                                       # False: round-3 approx_max_k pool.
    orb_n_features: int = 5000         # ImageUtility.py:31
    orb_scale_factor: float = 1.2      # ImageUtility.py:32
    orb_n_levels: int = 8              # ImageUtility.py:33
    orb_edge_threshold: int = 31       # ImageUtility.py:34
    orb_first_level: int = 0           # ImageUtility.py:35
    orb_wta_k: int = 2                 # ImageUtility.py:36
    orb_patch_size: int = 31           # ImageUtility.py:37
    orb_fast_threshold: int = 20       # ImageUtility.py:38
    orb_max_distance: int = 30         # Hamming accept threshold (ImageUtility.py:40)


@dataclasses.dataclass(frozen=True)
class EnhanceConfig:
    """Contrast-enhancement preprocessing (reference ImageUtility.py:47-50)."""
    enabled: bool = False
    use_clahe: bool = False
    clip_limit: float = 20.0
    tile_size: int = 5


@dataclasses.dataclass(frozen=True)
class StitchConfig:
    """Top-level engine configuration.

    Every reference knob appears here; additional fields configure the
    TPU-native execution (batching, sharding, solver) that the serial
    reference lacks.
    """
    # --- registration strategy -------------------------------------------------
    # "feature_incre"  : incremental ROI feature search (Stitcher.py:306)
    # "feature"        : whole-image feature search w/ B-feature cache (Stitcher.py:260)
    # "phase_incre"    : incremental ROI phase correlation (Stitcher.py:205)
    # "phase"          : whole-image phase correlation (repaired version of the
    #                    vestigial Stitcher.py:184 path)
    # "hybrid"         : feature_incre with per-pair phase_incre fallback
    #                    (new capability — fewer segment breaks than either)
    registration: str = "feature_incre"
    offset_calculate: str = "mode"     # "mode" | "ransac" (ImageUtility.py:43)
                                       # | "ransac_translation" (extra: pure
                                       # translation-consensus RANSAC, no
                                       # reference analog).  "ransac" is the
                                       # reference's homography RANSAC
                                       # (cv2.findHomography(RANSAC, 3) +
                                       # inlier count, ImageUtility.py:198),
                                       # batched 4-pt DLT (ops/features/
                                       # ransac.py).
    offset_evaluate: int = 3           # modal-count / inlier acceptance (ImageUtility.py:44)
    roi_ratio: float = 0.1             # incremental ROI growth step (ImageUtility.py:16)
    phase_response_threshold: float = 0.15  # Stitcher.py:30
    direction: int = 1                 # initial search direction (Stitcher.py:26)
    direct_incre: int = 1              # direction rotation increment (Stitcher.py:28)

    # --- imaging ---------------------------------------------------------------
    color_mode: bool = True            # compose in color (Stitcher.py:25)
    fuse_method: str = "fadeInAndFadeOut"  # Stitcher.py:29 / Main.py:14
    features: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    enhance: EnhanceConfig = dataclasses.field(default_factory=EnhanceConfig)

    # --- global alignment (new capability; reference chains offsets only) ------
    use_global_solver: bool = False    # pose-graph least squares over pairwise
                                       # offsets (+confidence weights) before
                                       # composition; sub-pixel chain refinement
    solver_iters: int = 0              # 0 = auto (2 * n_tiles)

    # --- TPU execution ---------------------------------------------------------
    # changelog: the round-1 ``canvas_block`` field was removed — the sharded
    # composer derives its row-block size from the mesh (rows / n_devices),
    # so a user-set block edge had nothing left to control.
    pair_batch: int = 0                # 0 = all pairs in one dispatch
    stream_output: bool = False        # delta-only panorama materialization
                                       # (core/stream_out.py): device composes,
                                       # host rebuilds from frames it already
                                       # owns + a fused-rect-only readback;
                                       # color composes host-side with the
                                       # CPU-backend fusion kernels (zero
                                       # color bytes cross the link).  Wins
                                       # when the host<->device link is thin;
                                       # default off (full readback).
    compute_dtype: str = "float32"     # detector conv/response dtype
                                       # ("bfloat16" halves response-map HBM
                                       # traffic; FFTs always run float32)
    use_pallas: bool = True            # the kernel pools (K1/K2 or K4);
                                       # False: the XLA detector's pool
    use_kernels: bool = True           # CUDA kernels for CUDA tensors
                                       # (False: their plain PyTorch versions)
    phase_hbm_budget: int = 2 << 30    # per-chip budget for the whole-image
                                       # phase path's padded FFT working set;
                                       # with a mesh, over-budget pairs route
                                       # through the tensor-parallel sharded
                                       # FFT (parallel/tp_fft.py)

    # --- logging / evaluation (ImageUtility.py:9-12) ---------------------------
    print_log: bool = False
    evaluate: bool = False
    output_address: str = "result/"
    evaluate_file: str = "evaluate.txt"

    def replace(self, **kw) -> "StitchConfig":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if self.registration not in ("feature_incre", "feature", "phase_incre",
                                     "phase", "hybrid"):
            raise ValueError(f"unknown registration strategy: {self.registration}")
        if self.offset_calculate not in ("mode", "ransac",
                                         "ransac_translation"):
            raise ValueError(f"unknown offset calculator: {self.offset_calculate}")
        if self.direction not in DIRECTIONS:
            raise ValueError(f"direction must be in {DIRECTIONS}")
        if self.direct_incre not in (-1, 0, 1):
            raise ValueError("direct_incre must be -1, 0 or 1")


def direction_increase(direction: int, direct_incre: int) -> int:
    """Rotate the search direction, wrapping inside [1, 4].

    Exact semantics of reference Stitcher.py:36-47 (5 wraps to 1, 0 wraps to 4).
    """
    direction += direct_incre
    if direction == 5:
        direction = 1
    if direction == 0:
        direction = 4
    return direction


def max_roi_scale(roi_ratio: float) -> int:
    """Number of ROI growth scales: maxI semantics of Stitcher.py:316.

    ``maxI = floor(0.5 / roiRatio) + 2`` and scales run ``i in [1, maxI)``;
    e.g. roi_ratio 0.2 -> i in {1,2,3}, roi_ratio 0.1 -> i in {1..6}.
    """
    import math
    return int(math.floor(0.5 / roi_ratio) + 1) + 1
