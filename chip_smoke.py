#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (imagestitch_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line of output each:
  1. record   — GPU name and power limit (nvidia-smi), torch/CUDA/nvcc;
  2. build    — compile the CUDA kernels of csrc/ for sm_90a, one nvcc per
                source, all started together;
  3. kernels  — each kernel against its plain PyTorch version at the
                shapes its paths give it, with CUDA-event times of both
                (device time: the host enqueues the timed calls while the
                stream sleeps; the K1 and K2 wrappers' host time a call is
                printed beside), its bound (the least time the card could
                take: the larger of its FP32 operations over 67 TFLOP/s
                (K3 and K5: their three TF32 products per multiply-add
                over 495 TFLOP/s, the FP32 bound printed beside) and its
                bytes, each input read once and each output written
                once, over 3.35 TB/s) and, where one PyTorch call
                computes the same function, that call's time:
                K1 in one call over the four octave bands of a 1936x2584
                frame's atlas (as the fused pool calls it) and K4 in one
                call over the same bands at the score-map pool's budgets
                (every slot and raw value bit-equal to the plain version;
                its full-map mode per octave bit-equal too), K2 on
                that frame's 11,616 candidates, K3 on 16 pairs x 4 configs
                x 1024 x 1024 x 128, K5 on 1024 x 1024 x 128 (the oriented
                mini pool; its own entry "at_1024" in K5's record, faster
                than its plain version), 11,616 x 11,616 x 128 (the
                fused pool) and 10 x 11,616 x 11,616 x 128 (path (d)'s
                one call over every pair; the entry "path_d", whose
                argmins may differ where the two rows' float64 distances
                tie within 1e-5), K6
                on its prototype's micro-benchmark (6,144 windows of 24
                rows x 128 columns of a 4096x2688 atlas), which is also
                its only path: one call with the counts from 0;
  4. paths    — Stitcher.stitch_batch, with kernels and then with their
                plain versions, on a seeded 1936x2584 serpentine of 10
                frames (5 down, 1 right, 4 up) plus, where named, an 11th
                frame of an unrelated texture:
                (a) feature_incre, default FeatureConfig (11 frames): the
                    upright pool registers pairs 0-8, pair 9 goes to the
                    oriented fallback (K4 over its 2 frames) and fails;
                (b) feature_incre, auto_upright=False (10 frames): every
                    frame through the oriented score-map pool;
                (c) feature_incre, upright over the score-map pool
                    (fused_select=False, 10 frames);
                (d) feature, default FeatureConfig (11 frames): whole-image
                    match (K5) and vote of every pair over the fused pool,
                    and the oriented retry (K4, a 1024-slot pool) of pair 9
                    when it fails with some valid matches: two K5 calls,
                    one for every pair of the sequence and one for the
                    retry.
                Each path: every registered pair within 1 px of the truth,
                kernel run == plain run, each of its kernels launched (K4
                once a frame of the score-map pool).
  5. files    — the user's workflow, PNG files on disk to panoramas on
                disk: the same 11 frames in BGR color (seeds 7 and 99,
                utils/synthetic.color_sequence) written as PNG into
                <tmp>/proj/1/, then the port's CLI
                (``cli.main(["stitch", proj, out, "--device", "cuda",
                ...])``) with the StitchConfig() defaults:
                (e) color composed on the device;
                (f) --stream-output: color composed on the host in float64;
                (g) --gray --stream-output: the fused pipelined ingest
                    (pinned side-stream copies), then the host float64
                    composer (C++ runtime present) or the device composer
                    with a rect-only readback (runtime absent).
                Each path: exactly stitching_result_1_1.png (10 frames) and
                stitching_result_1_2.png (the lone frame) are written and
                decode to a Stitcher.stitch_files run's panoramas; pairs
                0-8 within 1 px of the truth; kernel run == plain run; the
                device panoramas of (e) and (g) == the CPU composer's;
                K1-K4 launched; then one line of phase times (decode, H2D,
                register, compose, D2H, imwrite), CUDA events for the
                device phases.
  6. phase    — the phase-correlation registrations through
                Stitcher.stitch_batch on a second seeded serpentine of 10
                1936x2584 frames (5 down, 1 right, 4 up, steps of the iron
                demo's 1698 rows and 2284 columns, so that the strip-local
                shifts stay inside the circular range at roi_ratio 0.2)
                plus the unrelated 11th frame:
                (h) phase_incre, (i) phase (whole frames, 2x linear
                padding), (j) hybrid (feature_incre, default FeatureConfig,
                with phase for the pairs it leaves).
                Each path: registered pairs within 1 px of the truth; the
                records' integer fields equal the JAX package's (EXPECTED,
                from tests/test_torch_phase_paths.py's full-size test) and
                the port's CPU records on the same frames (the phase part
                only for (j)), sub-pixel offsets within 1e-3 px of the
                CPU's; panoramas equal the CPU run's; (h), (i) launch no
                kernel, (j) K1-K4.  Then one line of the phase searches'
                device times (CUDA events), attempts and dispatches.
  7. fusion   — path (k), the other fusion modes on the feature set's
                first segment (10 gray frames, path (a)'s offsets): each of
                notFuse, average, maximum, minimum, trigonometric,
                multiBandBlending and optimalSeamLine composed on the card
                (``compose``, ``return_device``, CUDA-event ms) against the
                port's CPU composer on the same frames: every mode
                bit-equal; the seam's
                energy and mask of every fusion rect, card against CPU
                (the mask from the same energy), and the DP's wall; the
                host float64 composer (``compose_host``) of every mode it
                runs within one level of the card's panorama on under
                1e-2 of values; the odd layout of
                tests/test_torch_pyramid_seam.py (4 x 256x320, pyramid
                levels of odd size) in multiBandBlending and
                optimalSeamLine, card == CPU bit for bit; color multiband
                and seam raise; then the
                CLI, ``--gray --stream-output --fuse-method
                multiBandBlending``, on the 11 frames as gray PNGs: exactly
                the two expected files, decoding to a stitch_files run's
                panoramas.  Launches no kernel.
  8. slice    — the configurations of strict-ROI detection, enhancement,
                the XLA detector's pool and RANSAC, on the feature set
                through Stitcher.stitch_batch:
                (l) feature_incre, offset_calculate="ransac" (11 frames):
                    the fused pool (K1, K2), homography RANSAC over every
                    strip match (K3);
                (m) feature_incre, use_pallas=False (11 frames): the XLA
                    detector's pool, upright then oriented for pair 9; only
                    K3 launches;
                (n) feature_incre, strict_roi_detect, CLAHE,
                    ransac_translation (the first 7 frames): every strip
                    enhanced and detected by the XLA detector, matched by
                    K5;
                (o) feature, equalized frames, "ransac" (11 frames): the
                    XLA pool of the enhanced frames, K5 over every pair;
                (w) (m) with compute_dtype="bfloat16": the XLA detector's
                    pool in bfloat16, checked as (m).
                Each path: its launch counts; kernel run == plain run
                (records, sub-pixel offsets, panoramas); the integer
                records of the card equal the port's CPU run's, on all 11
                frames for (l), on the first 4 for (m), (n) and (o) (the
                card runs those 4 too; the CPU's XLA detector takes
                seconds a full frame), sub-pixel within 1e-3 px; every
                registered pair within 1 px of the truth on (m) and (n);
                on (l) every pair registered in its true direction
                (homography RANSAC accepts a coincidental fit of any 4
                matches of strips that do not overlap, as the reference's
                estimator does, so every pair's first attempt passes and
                K4's fallback does not run); on (o) within 5 px (the
                translation column of a homography fit over whole
                frames).  One line a path with its warm walls.
  10. families and solver — on the feature set through
                Stitcher.stitch_batch, as phase 8's paths are checked:
                (p) feature_incre, method="sift" (11 frames): the
                    score-map pool (K4 once a frame), K3 on the 128-dim
                    SIFT descriptors, the oriented fallback of pair 9 (K4
                    over its 2 frames);
                (q) feature_incre, method="orb" (11 frames): the XLA
                    corner pool (FAST-9, Harris, the linear-resize
                    pyramid, BRIEF bits) and Hamming matches; no kernel;
                    within 2 px of the truth (the truncated mean of
                    ORB's displacements, 0.6 px low, as in jax);
                (r) feature_incre, box_filter=True (11 frames): the XLA
                    box-filter pool, then K3;
                (s) feature_incre, use_global_solver=True (the first 10
                    frames): the fused pool (K1, K2), K3, loop closure,
                    the pose-graph solve and compose_from_positions; then
                    the solve again on the card and the CPU from the
                    card's records (at least one loop edge, the same
                    edges, positions within 1e-2 px and equal once
                    rounded, the card's solve equal from run to run, the
                    panorama the CPU composer's from the CPU's positions)
                    and the CLI with --use-solver --stream-output on the
                    11 color PNGs (the solved segment through
                    compose_host_positions; the files decode to a
                    stitch_files run's panoramas).
  11. oriented SIFT — (p') feature_incre, method="sift",
                auto_upright=False (11 frames), as phase 8's paths are
                checked: every frame through the score-map pool (K4 once a
                frame; no fallback), K3 in the replay; then frame 0's SIFT
                pool on the card against the CPU (the keypoints equal, the
                descriptor rows beyond 1e-5 within ORIENTED_SIFT_SHARE) and
                the oriented describe's device ms, SURF-128 beside SIFT.
  12. evaluation — (t), each part timed by utils/profiling.PhaseTimer:
                (t1) eval.synthetic.run(25, 40, iters=400): 1,000 tiles,
                    1,935 edges, the error under 2 px and a third of the
                    chain's; the solve equal from run to run and within
                    1e-2 px of the port's CPU solve;
                (t2) eval.accuracy.evaluate_dataset on the first 10 frames
                    written as gray JPEGs under
                    <tmp>/demo/dendriticCrystal/1/, its dataset_configs()
                    entry: every pair within 1 px of the truth, == the
                    plain run, K1, K2 and K3 counted; the cv2.SIFT oracle's
                    compared pairs within 2 px where cv2 has SIFT (else the
                    line says the oracle was absent);
                (t3) eval.loop_closure_demo.run on the same root: (s)'s
                    loop edges, solved residuals no larger than the
                    chain's, the report within 1e-2 px of the CPU run's;
                (t4) utils.image.resize of (a)'s panorama by 0.5 and
                    rectify_final of it with two corners blanked, against
                    the CPU (resize and rectify equal).
  13. mesh    — (u), the device mesh (parallel/), 4 shards sharing the
                one card: (u1) feature_incre (default FeatureConfig, 11
                frames padded to 12) and (u2) feature through
                Stitcher(mesh=...), each == the single-device run and the
                sharded plain run (records, panoramas), K1/K2 12 times;
                (u3) compose_sharded of (a)'s offsets in all 8 gray modes
                == the card's compose; (u4) the edge-sharded solve of
                (s)'s graph and of the 1,000-tile grid, card == CPU bit
                for bit; (u5) eval.stretch.run at 32 x 32 tiles of
                96 x 128 and at 4 x 4 tiles of 1936 x 2584, the solved
                RMSE below the chain's; (u6) eval.compose_bench and
                eval.scaling at 1, 2 and 4 shards; (u7) the CLI's --mesh
                auto stitches and --mesh 2 exits non-zero.  One "mesh (u)"
                line; no number of it is a scaling measurement.
  14. tp_fft  — (v), (i)'s whole-frame phase registration through
                Stitcher(mesh=4 shards of the card) with phase_hbm_budget
                256 MiB, under a pair's ~0.97 GB: each pair's FFT split
                over the shards (parallel/tp_fft.py); integer records ==
                (i)'s, sub-pixel within 5e-3 px, confidence within 1e-3,
                3 all_to_all, 2 all_gather and 1 psum a pair.  One
                "phase (v)" line.
  9. pool split — (b)'s score-map pool once more: its device ms a frame
                by stage (torch.profiler, tools/torch_pool_split.py) and
                the card's busy share; last, because the profiler slows
                the process's later CUDA calls.
Then the smoke's total seconds, one JSON line with the per-kernel record
and, last, the device line.
Any failed check raises: the exit code is nonzero and no result line is
printed.  Float32 throughout: TF32 is off for matmuls and cuDNN.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time


#: one H100 SXM at 700 W (NVIDIA's data sheet): float32 outside the tensor
#: cores, TF32 on the tensor cores (dense), and device memory
FP32_PEAK = 67e12
TF32_PEAK = 495e12
HBM_RATE = 3.35e12
#: the share of oriented SIFT descriptor rows that may lie beyond 1e-5
#: of the reference (tests/test_torch_oriented_sift.py); card against CPU
ORIENTED_SIFT_SHARE = 0.02
#: FP32 operations of K2 per keypoint (csrc/describe.cu): 256 samples of 37
#: (two 3-tap smoothings 10, two differences 3 + 9 + 5, the window weight 2,
#: the 8 sign-split sums 8), then the norm's 128 squares, 128 adds and 128
#: divides, a square root and its guard
DESCRIBE_OPS = 256 * 37 + 3 * 128 + 2


#: the JAX package's records on the CPU for path (h), (i) and the phase part
#: of (j) on the phase frames (tests/test_torch_phase_paths.py::
#: test_cuda_full_size_phase_paths_match_jax prints them): (ok, offset,
#: direction, scale, attempts), the offset of a failed pair not compared
_DOWN, _UP = (1698, 0), (-1698, 0)
EXPECTED = {
    "phase_incre": [(True, _DOWN, 1, 1, 1)] * 4 + [(True, (0, 2284), 2, 1, 2),
                                                   (True, _UP, 3, 1, 2)]
    + [(True, _UP, 3, 1, 1)] * 3 + [(False, None, 0, 0, 12)],
    "phase": [(True, _DOWN, 1, 0, 1)] * 4 + [(True, (0, 2284), 1, 0, 1)]
    + [(True, _UP, 1, 0, 1)] * 4 + [(False, None, 0, 0, 1)],
    # pair 9, the only pair the features leave, searched from direction 3:
    # every (direction, scale) of roi_ratio 0.2 fails
    "hybrid": [(False, None, 0, 0, 12)],
}


def doh_operations(h, w, radii):
    """FP32 operations of K1/K4's response stage and NMS on one (h, w)
    octave (csrc/doh_common.cuh): per scale of radius r (2r + 1 taps), three
    vertical correlations on the (h + 2) x (w + 2 + 2r) band and three
    horizontal ones on the (h + 2) x (w + 2) ring, 2 * taps - 1 operations
    each per sample; the determinant (4) and the scale max (1) on the ring;
    then the 8 neighbour maxima and the centre test of the NMS."""
    ring = (h + 2) * (w + 2)
    ops = 9 * h * w
    for s, r in enumerate(radii):
        taps = 2 * r + 1
        ops += 3 * (2 * taps - 1) * ((h + 2) * (w + 2 + 2 * r) + ring)
        ops += (4 + (s > 0)) * ring
    return ops


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device milliseconds of ``fn`` over ``iters`` calls (CUDA
    events).  The stream first sleeps ~10 ms on the card, so the host has
    enqueued the calls before the start event runs: the events time the
    device's work, not the wrappers' host overhead (``host_us``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters=100):
    """Mean host microseconds of one call of ``fn`` (enqueue only)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def check_top2(torch, name, got, ref):
    """d0/d1 within 1e-5; the argmin may differ only where the two smallest
    distances tie within 1e-5.  Returns (max abs err, argmin ties)."""
    (d0k, i0k, d1k), (d0p, i0p, d1p) = got[:3], ref[:3]
    torch.testing.assert_close(d0k, d0p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d1k, d1p, rtol=1e-5, atol=1e-5)
    differ = i0k != i0p.to(torch.int32)
    tied = (d1p - d0p) <= 1e-5 * d1p.abs().clamp_min(1e-30)
    if bool((differ & ~tied).any()):
        raise AssertionError(f"{name}: {int((differ & ~tied).sum())} "
                             f"argmins differ without a tie")
    return (max(float((d0k - d0p).abs().max()),
                float((d1k - d1p).abs().max())), int(differ.sum()))


def check_top2_exact_ties(torch, name, got, ref, da, db, valid_b):
    """``check_top2``'s d0/d1 tolerance; where the argmins differ, the
    kernel's row is valid and the two chosen train rows' float64 distances
    to the query lie within that tolerance of each other: a tie in exact
    arithmetic.  For a shape with many small-distance near-ties, where the
    float32 sum |a|^2 + |b|^2 - 2ab errs by about 1e-6 whatever d is, in the
    kernel and in the plain version alike.  Returns (max abs err, argmins
    that differ, their largest float64 gap)."""
    (d0k, i0k, d1k), (d0p, i0p, d1p) = got[:3], ref[:3]
    torch.testing.assert_close(d0k, d0p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d1k, d1p, rtol=1e-5, atol=1e-5)
    bi, qi = (i0k.long() != i0p.long()).nonzero(as_tuple=True)
    ik, ip = i0k[bi, qi].long(), i0p[bi, qi].long()
    q = da[bi, qi].double()
    dk = ((q - db[bi, ik].double()) ** 2).sum(-1)
    dp = ((q - db[bi, ip].double()) ** 2).sum(-1)
    gap = (dk - dp).abs()
    if not bool(valid_b[bi, ik].all()) or bool((gap > 1e-5 + 1e-5 * dp).any()):
        raise AssertionError(f"{name}: argmins differ beyond a float64 tie")
    return (max(float((d0k - d0p).abs().max()),
                float((d1k - d1p).abs().max())), len(bi),
            float(gap.max()) if len(bi) else 0.0)


def timed(torch, fn):
    """``fn()`` once, with its CUDA-event ms and its host-clock ms."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA GPU")
    import numpy as np
    from imagestitch_tpu_torch import FeatureConfig, StitchConfig, Stitcher
    from imagestitch_tpu_torch import _build, cli
    import torch.nn.functional as F
    from imagestitch_tpu_torch.core import compose as compose_mod
    from imagestitch_tpu_torch.core import feature_registration as freg
    from imagestitch_tpu_torch.core import registration as treg
    from imagestitch_tpu_torch.core import stream_out
    from imagestitch_tpu_torch.io import codec, dataset, native_loader
    from imagestitch_tpu_torch.io.dataset import ImageBatch
    from imagestitch_tpu_torch.ops.features import detect
    from imagestitch_tpu_torch.ops.kernels import describe as kdesc
    from imagestitch_tpu_torch.ops.kernels import doh as kdoh
    from imagestitch_tpu_torch.ops.kernels import matcher as kmatch
    from imagestitch_tpu_torch.ops.kernels import window_sum as kws
    from imagestitch_tpu_torch.utils import synthetic
    from imagestitch_tpu_torch.utils.records import SequenceReport

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. record
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(smi)
    print(f"record: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{nvcc[-1]}; TF32 off (matmul {torch.backends.cuda.matmul.allow_tf32},"
          f" cudnn {torch.backends.cudnn.allow_tf32})")

    # ---- 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.last_build_seconds:.2f} s) for "
          f"{[f.name for f in _build.sources()]} + "
          f"{[f.name for f in _build.headers()]}")

    # ---- data: a 10-frame serpentine and one unrelated frame
    h, w = 1936, 2584
    t0 = time.perf_counter()
    positions = synthetic.serpentine_positions(5, 2, (1790.37, 2450.21))
    seq, truth = synthetic.sequence(7, (h, w), positions)
    other, _ = synthetic.sequence(99, (h, w), [(0.5, 0.5)])
    frames = np.concatenate([seq, other])
    print(f"data: {frames.shape} uint8 (serpentine + 1 unrelated frame) in "
          f"{time.perf_counter() - t0:.1f} s; true offsets "
          f"{[tuple(round(v, 2) for v in t) for t in truth.tolist()]}")
    base = StitchConfig(registration="feature_incre", direction=1,
                        direct_incre=1, roi_ratio=0.2, color_mode=False,
                        fuse_method="fadeInAndFadeOut")
    cfg_up = base.replace(features=FeatureConfig(upright=True))
    dparams = freg._detect_params(cfg_up)
    sparams = freg._describe_params(cfg_up)
    gray = torch.as_tensor(frames, device=dev)

    # ---- launch counts: set to 0 before a path, read after it
    counters = {"doh_select": (kdoh, "LAUNCHES"),
                "doh_score_map": (kdoh, "SCORE_MAP_LAUNCHES"),
                "describe_atlas": (kdesc, "LAUNCHES"),
                "top2_l2_coords": (kmatch, "LAUNCHES"),
                "top2_l2": (kmatch, "TOP2_LAUNCHES"),
                "window_colsum": (kws, "LAUNCHES")}
    total = dict.fromkeys(counters, 0)

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts(label, expect):
        """The counts since zero_counts(), checked against ``expect``
        (None: at least one launch) and added to the totals."""
        launches = {k: getattr(mod, attr)
                    for k, (mod, attr) in counters.items()}
        for name, want in expect.items():
            if (launches[name] == 0) if want is None else \
                    (launches[name] != want):
                raise AssertionError(f"{label}: {name} launched "
                                     f"{launches[name]} times, want "
                                     f"{'> 0' if want is None else want}")
        for k, v in launches.items():
            total[k] += v
        return launches

    # ---- 3. each kernel against its plain version
    records = []

    def bound(ops, nbytes, peak=FP32_PEAK):
        """(bound ms, its term): ``ops`` operations at ``peak`` against
        ``nbytes`` bytes (each input read once, each output written once)
        at the memory rate."""
        t_ops, t_bytes = ops / peak, nbytes / HBM_RATE
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    def record(name, source, replaces, err, ms, plain_ms, ops, nbytes,
               library_ms=None, peak=FP32_PEAK, **extra):
        """One kernel's line; ``ops`` operations at ``peak`` (FP32 on the
        CUDA cores unless the kernel's route is another) and ``nbytes``
        bytes give its bound."""
        bound_ms, bound_by = bound(ops, nbytes, peak)
        records.append(dict(name=name, route="cuda",
                            source=f"imagestitch_tpu_torch/csrc/{source}",
                            replaces=replaces, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms,
                            **extra))

    # K1 and K4: the four octaves of frame 0, as the pools call them: each
    # in one call over the octave bands of the frame's atlas
    spacing = 2.0 ** (1.0 / dparams.n_octave_layers)
    octs, core, bands = freg.octave_atlas(gray[0], dparams)
    octaves = [(xo.contiguous(), bo) for _, xo, bo in octs]
    taps = dict(threshold=dparams.threshold, n_scales=dparams.n_octave_layers,
                base_sigma=dparams.base_sigma, spacing=spacing)
    k1 = lambda use: kdoh.doh_select_octaves(core, bands, use_kernel=use,
                                             **taps)
    live_n = 0
    for (sk, ck, dk, ek), (sp, cp, dp, ep) in zip(k1(True), k1(False)):
        live = sp > 0
        # bit-equal: every score, and the column and sub-pixel offsets of
        # every live slot (an empty slot's other fields are arbitrary)
        if not (torch.equal(sk, sp) and torch.equal(ck[live], cp[live])
                and torch.equal(dk[live], dp[live])
                and torch.equal(ek[live], ep[live])):
            raise AssertionError("doh_select: not bit-equal to the plain "
                                 "version")
        live_n += int(live.sum())
    radii = kdoh._tap_tables(dparams.n_octave_layers, dparams.base_sigma,
                             spacing)[0].tolist()
    doh_ops = sum(doh_operations(*x.shape, radii) for x, _ in octaves)
    px = sum(x.numel() for x, _ in octaves)
    record("doh_select", "doh_select.cu",
           "imagestitch_tpu/ops/pallas/doh.py:285", 0.0,
           cuda_ms(torch, lambda: k1(True)),
           cuda_ms(torch, lambda: k1(False), iters=5), doh_ops,
           4 * px + sum(16 * h * rc for _, h, _, _, rc in bands))
    wrapper_us = {"K1": host_us(torch, lambda: k1(True))}

    # K4: one call over the same bands at the score-map pool's budgets (the
    # 6,144 slots of paths (b) and (c)), every slot and raw value bit-equal;
    # then its full-map mode (doh_score_map) per octave, bit-equal too
    kks = [min(detect.octave_budget(FeatureConfig().pool_keypoints, o,
                                    dparams.octave_topk_decay), bh * bw)
           for o, (_, bh, bw, _, _) in enumerate(bands)]
    k4 = lambda use: kdoh.doh_score_map_octaves(core, bands, kks,
                                                use_kernel=use, **taps)
    for (sk, ik, rk), (sp, ip, rp) in zip(k4(True), k4(False)):
        if not (torch.equal(sk, sp) and torch.equal(ik, ip)
                and torch.equal(rk, rp)):
            raise AssertionError("doh_score_map_octaves: not bit-equal to "
                                 "the plain version")
    k4_launch = lambda: kdoh._launch_score_map(core, bands, full_map=False,
                                               **taps)
    _, _, keys4, counts4 = k4_launch()
    *survivors, total4 = counts4.tolist()
    full4 = lambda use: [kdoh.doh_score_map(x, border=bo, use_kernel=use,
                                            **taps) for x, bo in octaves]
    live4 = []
    for (sk, rk), (sp, rp) in zip(full4(True), full4(False)):
        if not (torch.equal(sk, sp) and torch.equal(rk, rp)):
            raise AssertionError("doh_score_map: not bit-equal to the plain "
                                 "version")
        live4.append(int((sp > 0).sum()))
    if survivors != live4:
        raise AssertionError(f"doh_score_map_octaves: {survivors} survivors,"
                             f" the plain maps hold {live4}")
    k4_order = lambda: kdoh.top_k_from_survivors(
        keys4[:total4], survivors, [bh * bw for _, bh, bw, _, _ in bands],
        kks)
    # bytes: the bands read and the raw response written once, a key per
    # survivor, the counts
    record("doh_score_map", "doh_score_map.cu",
           "imagestitch_tpu/ops/pallas/doh.py:337", 0.0,
           cuda_ms(torch, k4_launch), cuda_ms(torch, lambda: k4(False),
                                              iters=5), doh_ops,
           8 * px + 8 * sum(survivors) + 4 * len(bands),
           survivors=survivors, budgets=kks,
           ordering_ms=cuda_ms(torch, k4_order),
           call_ms=sorted(timed(torch, lambda: k4(True))[2]
                          for _ in range(11))[5],
           full_map_ms=cuda_ms(torch, lambda: full4(True)))

    # K2: every candidate of frame 0 from the atlas the pool builds
    _, _, _, atlas, r0, c0 = freg.select_candidates(gray[0], dparams)
    k2 = lambda use: kdesc.describe_atlas(atlas, r0, c0, extended=True,
                                          use_kernel=use)
    dk, dp = k2(True), k2(False)
    if dk.shape != (11616, 128):
        raise AssertionError(f"describe_atlas: shape {tuple(dk.shape)}")
    torch.testing.assert_close(dk, dp, rtol=0, atol=1e-5)
    # bytes: the atlas pixels the 18x18 windows cover (starts clamped as the
    # kernel clamps them), the starts, the weight table, the descriptors
    win = torch.arange(kdesc.WIN, device=dev)
    rr = r0.long().clamp(0, atlas.shape[0] - kdesc.WIN)[:, None, None] + \
        win[None, :, None]
    cc = c0.long().clamp(0, atlas.shape[1] - kdesc.WIN)[:, None, None] + \
        win[None, None, :]
    covered = torch.zeros(atlas.shape, dtype=torch.bool, device=dev)
    covered[rr, cc] = True
    record("describe_atlas", "describe.cu",
           "imagestitch_tpu/ops/pallas/describe.py:226",
           float((dk - dp).abs().max()), cuda_ms(torch, lambda: k2(True)),
           cuda_ms(torch, lambda: k2(False)), DESCRIBE_OPS * r0.numel(),
           4 * int(covered.sum()) + 8 * r0.numel() + 4 * 256 + 4 * dk.numel())
    wrapper_us["K2"] = host_us(torch, lambda: k2(True))

    # K3: 16 pair slots x 4 directions at scale 1 from the serpentine's pool
    pool = freg.pool_features(gray[:10], dparams, sparams)
    idx = torch.as_tensor(freg.reg.pad_indices(np.arange(9, dtype=np.int32))[0],
                          dtype=torch.long, device=dev)
    ratio = cfg_up.roi_ratio
    sides = [(freg._select_strip(pool, idx, freg._strip_bounds(d, "first", ratio, h, w), 1024),
              freg._select_strip(pool, idx + 1, freg._strip_bounds(d, "second", ratio, h, w), 1024))
             for d in (1, 2, 3, 4)]
    cat = lambda s, j: torch.cat([x[s][j] for x in sides]).contiguous()
    da, db, vb, rb, cb = cat(0, 3), cat(1, 3), cat(1, 2), cat(1, 0), cat(1, 1)
    if tuple(da.shape) != (64, 1024, 128):
        raise AssertionError(f"matcher: shape {tuple(da.shape)}")
    k3 = lambda use: kmatch.top2_l2_coords(da, db, vb, rb, cb, use_kernel=use)
    got, ref = k3(True), k3(False)
    err3, ties3 = check_top2(torch, "top2_l2_coords", got, ref)
    same = got[1] == ref[1].to(torch.int32)
    if not (torch.equal(got[3][same], ref[3][same])
            and torch.equal(got[4][same], ref[4][same])):
        raise AssertionError("top2_l2_coords: matched coordinates differ")
    bsz, ka, dim = da.shape
    # 3xTF32: three tensor-core products per multiply-add; the FP32 bound of
    # the same products on the CUDA cores is kept beside it
    k3_ops = 2 * bsz * ka * db.shape[1] * dim
    k3_bytes = (4 * (da.numel() + db.numel() + 2 * rb.numel() + 5 * bsz * ka)
                + vb.numel())
    record("top2_l2_coords", "matcher.cu",
           "imagestitch_tpu/ops/pallas/matcher.py:150", err3,
           cuda_ms(torch, lambda: k3(True)), cuda_ms(torch, lambda: k3(False)),
           3 * k3_ops, k3_bytes, peak=TF32_PEAK, shape=list(da.shape),
           fp32_bound_ms=bound(k3_ops, k3_bytes)[0])
    # the nearest PyTorch yardstick is two calls (Euclidean, no mask), so
    # it is a note and not the kernel's library_ms
    cdist_ms = {"K3": cuda_ms(torch, lambda: torch.cdist(da, db).topk(
        2, largest=False))}

    # K5: frames 0 and 1 of the oriented 1024-slot mini pool, and of the
    # fused 11,616-slot pool (one whole-image pair each), then path (d)'s
    # one call over every adjacent pair of the 11 frames' fused pool
    sp_or = dataclasses.replace(sparams, upright=False)
    mini = freg.pool_features(gray[:2], dparams, sp_or, max_pool=1024)
    whole = freg.pool_features(gray, dparams, sparams)
    k5_sets = [(m[3][:1].contiguous(), m[3][1:2].contiguous(),
                (m[2][1:2] > 0).contiguous()) for m in (mini, pool)]
    k5_sets.append((whole[3][:-1].contiguous(), whole[3][1:].contiguous(),
                    (whole[2][1:] > 0).contiguous()))
    if [tuple(s[0].shape) for s in k5_sets] != [(1, 1024, 128),
                                                (1, 11616, 128),
                                                (10, 11616, 128)]:
        raise AssertionError(f"top2_l2: shapes {[s[0].shape for s in k5_sets]}")
    k5 = []
    for i, (a, b, v) in enumerate(k5_sets):
        run5 = lambda use: kmatch.top2_l2(a, b, v, use_kernel=use)
        if i < 2:
            e, t = check_top2(torch, "top2_l2", run5(True), run5(False))
        else:   # path (d)'s pairs hold near-ties of d ~ 1e-3 (PERF.md)
            e, t, gap = check_top2_exact_ties(torch, "top2_l2", run5(True),
                                              run5(False), a, b, v)
        ops = 2 * a.shape[0] * a.shape[1] * b.shape[1] * a.shape[2]
        nbytes = 4 * (a.numel() + b.numel() + 3 * a.shape[0] * a.shape[1]) \
            + v.numel()
        b_ms, b_by = bound(3 * ops, nbytes, TF32_PEAK)
        k5.append(dict(shape=list(a.shape), max_abs_err=e, argmin_ties=t,
                       ms=cuda_ms(torch, lambda: run5(True)),
                       plain_ms=cuda_ms(torch, lambda: run5(False), iters=5),
                       bound_ms=b_ms, bound_by=b_by,
                       fp32_bound_ms=bound(ops, nbytes)[0]))
        if i < 2:   # cdist's 10 x 11,616^2 matrix would take 5.4 GB again
            k5[-1]["cdist_topk_ms"] = cuda_ms(torch, lambda: torch.cdist(
                a, b).topk(2, largest=False), iters=5)
        else:
            k5[-1]["argmin_tie_gap_fp64"] = gap
    a5, b5, v5 = k5_sets[1]
    record("top2_l2", "matcher.cu", "imagestitch_tpu/ops/pallas/matcher.py:93",
           k5[1]["max_abs_err"], k5[1]["ms"], k5[1]["plain_ms"],
           3 * 2 * a5.shape[1] * b5.shape[1] * a5.shape[2],
           4 * (a5.numel() + b5.numel() + 3 * a5.shape[1]) + v5.numel(),
           peak=TF32_PEAK, shape=list(a5.shape),
           fp32_bound_ms=k5[1]["fp32_bound_ms"],
           at_1024={k: v for k, v in k5[0].items() if k != "cdist_topk_ms"},
           path_d=k5[2])
    cdist_ms["K5"] = k5[1]["cdist_topk_ms"]
    cdist_ms["K5 1024^2"] = k5[0]["cdist_topk_ms"]
    if not k5[0]["ms"] < k5[0]["plain_ms"]:
        raise AssertionError(f"top2_l2 at 1024^2: {k5[0]['ms']:.4f} ms, "
                             f"plain {k5[0]['plain_ms']:.4f} ms")

    # K6: its prototype's micro-benchmark (profile_r4_micro2.py:115-125),
    # its only path: one call with the counts from 0, then the checks
    rng = np.random.default_rng(0)
    ha6, wa6, k6 = 3840, 2688, 6144
    atlas6 = rng.random((ha6 + 256, wa6), np.float32)
    r06 = np.sort(rng.integers(0, ha6 - 24, k6)).astype(np.int32)
    ca6 = (rng.integers(0, (wa6 - 256) // 128, k6) * 128).astype(np.int32)
    a6, r6, c6 = (torch.as_tensor(x, device=dev) for x in (atlas6, r06, ca6))
    zero_counts()
    out6 = kws.window_colsum(a6, r6, c6)
    torch.cuda.synchronize()
    read_counts("K6 micro-benchmark", {"window_colsum": 1})
    if not torch.equal(out6, kws.window_colsum(a6, r6, c6, use_kernel=False)):
        raise AssertionError("window_colsum: not bit-equal to the plain "
                             "version")
    # the script's own check (:172-173), on every window
    script = np.stack([atlas6[r:r + 24, c:c + 256].sum(0)[:128]
                       for r, c in zip(r06, ca6)])
    err6 = float(np.abs(out6.cpu().numpy() - script).max())
    if err6 > 1e-5:
        raise AssertionError(f"window_colsum: {err6} from the script's check")
    # one PyTorch call of the same function: a sum-bag over 128-column
    # segments of the atlas rows
    seg = wa6 // 128
    bags = ((r6.long()[:, None] + torch.arange(24, device=dev)) * seg
            + (c6.long() // 128)[:, None])
    bag_sum = lambda: F.embedding_bag(bags, a6.view(-1, 128), mode="sum")
    torch.testing.assert_close(bag_sum(), out6, rtol=0, atol=1e-5)
    touched = np.zeros((ha6 + 256, seg), bool)
    for i in range(24):
        touched[r06 + i, ca6 // 128] = True
    record("window_colsum", "window_colsum.cu",
           "scripts/profile_r4_micro2.py:150", 0.0,
           cuda_ms(torch, lambda: kws._launch(a6, r6, c6, 24, 128)),
           cuda_ms(torch, lambda: kws.window_colsum_plain(a6, r6, c6)),
           23 * k6 * 128, 512 * int(touched.sum()) + 8 * k6 + 4 * out6.numel(),
           cuda_ms(torch, bag_sum))
    k4r = next(r for r in records if r["name"] == "doh_score_map")
    print("kernels: " + "; ".join(
        f"{r['name']} max_abs_err {r['max_abs_err']:.3g}, {r['ms']:.4f} ms "
        f"(plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
        f"{r['bound_by']}, library {r['library_ms']})" for r in records)
        + "; K3/K5 on the tensor cores (3xTF32): " + "; ".join(
            f"{r['name']} {r['shape']} max |d - d_plain| "
            f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms (3 TF32 products at 495 TFLOP/s; FP32 "
            f"{r['fp32_bound_ms']:.4f} ms)" for r in records
            if r["name"] in ("top2_l2_coords", "top2_l2"))
        + "".join(
            f"; top2_l2 {r['shape']} max |d - d_plain| "
            f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; FP32 {r['fp32_bound_ms']:.4f} ms)"
            for r in (k5[0], k5[2]))
        + f"; path (d) argmins differing on float64 ties "
        f"{k5[2]['argmin_ties']}, largest gap "
        f"{k5[2]['argmin_tie_gap_fp64']:.3g}"
        + f"; K1 live slots {live_n}, bit-equal, its bit-equal ceiling "
        f"{2 * records[0]['bound_ms']:.4f} ms (no FMA: half the FP32 rate); "
        f"K4 in one call over the 4 bands at budgets {k4r['budgets']}: "
        f"survivors {k4r['survivors']}, every slot and raw value bit-equal, "
        f"the survivors' ordering {k4r['ordering_ms']:.4f} ms (events), the "
        f"whole call {k4r['call_ms']:.4f} ms (host clock, median of 11, "
        f"count readback included), full-map mode per octave "
        f"{k4r['full_map_ms']:.4f} ms, bit-equal; wrapper host time a call "
        f"(enqueue, host clock) K1 {wrapper_us['K1']:.1f} us, K2 "
        f"{wrapper_us['K2']:.1f} us; K3 "
        f"argmin ties {ties3}; K5 argmin ties "
        f"{sum(r['argmin_ties'] for r in k5)}; cdist + topk "
        f"(not the same function: Euclidean, unmasked) K3 shape "
        f"{cdist_ms['K3']:.4f} ms, K5 shape {cdist_ms['K5']:.4f} ms, K5 "
        f"1024^2 {cdist_ms['K5 1024^2']:.4f} ms; K6 "
        f"from the script's numpy check {err6:.3g}, windows touch "
        f"{int(touched.sum())} row segments of 512 B")

    # ---- 4. the paths end to end

    def records_of(report):
        return (report.num_ok, report.offsets, report.confidences,
                report.directions, report.scales, report.attempts)

    def check_run(label, res, res_plain, segments):
        """Segments, offsets against the truth, kernel run == plain run."""
        if [r.file_range for r in res] != segments:
            raise AssertionError(f"{label}: segments "
                                 f"{[r.file_range for r in res]}")
        for k, (off, t) in enumerate(zip(res[0].offsets, truth)):
            if abs(off[0] - t[0]) >= 1 or abs(off[1] - t[1]) >= 1:
                raise AssertionError(f"{label}: pair {k}: offset {off}, "
                                     f"truth {t}")
        if [r.offsets for r in res] != [r.offsets for r in res_plain] or \
                records_of(res[0].report) != records_of(res_plain[0].report) \
                or not all(np.array_equal(a.image, b.image)
                           for a, b in zip(res, res_plain)):
            raise AssertionError(f"{label}: kernel run differs from the "
                                 f"plain run")
        return res[0].report

    def run_path(label, cfg, n, segments, expect):
        """Kernel run (counts from 0) and plain run of one path; checks
        segments, offsets against the truth, kernel == plain, launches."""
        batch = ImageBatch(gray=frames[:n], color=None,
                           files=[f"frame-{i}" for i in range(n)])
        Stitcher(cfg, device=dev).stitch_batch(batch)          # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = Stitcher(cfg, device=dev).stitch_batch(batch)
        wall = time.perf_counter() - t0
        launches = read_counts(label, expect)
        t0 = time.perf_counter()
        res_plain = Stitcher(cfg.replace(use_kernels=False),
                             device=dev).stitch_batch(batch)
        wall_plain = time.perf_counter() - t0
        report = check_run(label, res, res_plain, segments)
        pano = res[0].image
        if pano.dtype != np.uint8 or pano.ndim != 2 or (pano > 0).mean() < 0.9:
            raise AssertionError(f"{label}: panorama {pano.dtype} {pano.shape}")
        print(f"slice {label}: {n} x {h}x{w} frames, {report.num_ok}/"
              f"{report.num_pairs} pairs, segments "
              f"{[r.file_range for r in res]}, offsets {report.offsets} "
              f"(confidence {report.confidences}, directions "
              f"{report.directions}), panorama {pano.shape}; warm wall "
              f"{wall:.3f} s with kernels, {wall_plain:.3f} s plain; "
              f"launches {launches}")
        return report

    rep = run_path("(a) feature_incre default", base.replace(
        features=FeatureConfig()), 11, [(0, 10), (10, 11)],
        {"doh_select": 11, "describe_atlas": 11, "top2_l2_coords": None,
         "doh_score_map": 2, "top2_l2": 0})
    if sorted(set(rep.directions[:9])) != [1, 2, 3] or \
            not rep.confidences[9] > 0:
        raise AssertionError(f"(a): directions {rep.directions}, "
                             f"confidences {rep.confidences}")
    offsets_a = rep.offsets[:9]     # path (k) composes with these
    run_path("(b) feature_incre auto_upright=False", base.replace(
        features=FeatureConfig(auto_upright=False)), 10, [(0, 10)],
        {"doh_score_map": 10, "top2_l2_coords": None, "doh_select": 0})
    run_path("(c) feature_incre upright score map", base.replace(
        features=FeatureConfig(upright=True, fused_select=False)), 10,
        [(0, 10)], {"doh_score_map": 10, "top2_l2_coords": None,
                    "doh_select": 0})
    run_path("(d) feature default", base.replace(
        registration="feature", features=FeatureConfig()), 11,
        [(0, 10), (10, 11)],
        {"top2_l2": 2, "doh_select": 11, "describe_atlas": 11,
         "doh_score_map": 2})

    # ---- 5. files to files through the CLI, StitchConfig() defaults
    t0 = time.perf_counter()
    colors = np.concatenate([
        synthetic.color_sequence(7, (h, w), positions)[0],
        synthetic.color_sequence(99, (h, w), [(0.5, 0.5)])[0]])
    t_data = time.perf_counter() - t0
    outputs = ["stitching_result_1_1.png", "stitching_result_1_2.png"]
    expect = {"doh_select": 11, "describe_atlas": 11, "top2_l2_coords": None,
              "doh_score_map": 2, "top2_l2": 0}

    def phase_times(label, cfg, res):
        """The path's phases once more, one at a time: decode, H2D,
        register, compose, D2H, imwrite.  Checks that the records are
        register_sequence_features_incre's on the decoded frames and that
        the panorama is the path's."""
        color = cfg.color_mode
        batch, _, dec_ms = timed(torch, lambda: dataset.load_batch(files,
                                                                   color))
        if color and not np.array_equal(batch.color, colors):
            raise AssertionError(f"{label}: decoded frames differ from the "
                                 f"written ones")
        pinned = torch.from_numpy(batch.gray).pin_memory()
        gray_dev, h2d_ms, _ = timed(torch, lambda: pinned.to(
            dev, non_blocking=True))
        recs, reg_ms, _ = timed(torch, lambda: (
            freg.register_sequence_features_incre(gray_dev, cfg, device=dev)))
        if records_of(SequenceReport.from_records(recs)) != \
                records_of(res[0].report):
            raise AssertionError(f"{label}: records differ from "
                                 f"register_sequence_features_incre's")
        offs = res[0].offsets
        parts = [f"decode {dec_ms:.1f} ms (host, {len(files)} files)",
                 f"H2D gray {h2d_ms:.3f} ms (events, pinned, "
                 f"{pinned.numel()} B)", f"register {reg_ms:.1f} ms (events)"]
        if color and not cfg.stream_output:
            color_dev, ms, _ = timed(torch, lambda: torch.as_tensor(
                batch.color[:10]).to(dev))
            parts.append(f"H2D color {ms:.3f} ms (events, pageable, "
                         f"{color_dev.numel()} B)")
            pano_dev, ms, _ = timed(torch, lambda: compose_mod.compose(
                color_dev, offs, cfg, return_device=True))
            parts.append(f"compose {ms:.1f} ms (events, device, int16 "
                         f"canvas {pano_dev.numel() * 2} B)")
            pano, ms, _ = timed(torch, lambda: pano_dev.cpu().numpy())
            parts.append(f"D2H {ms:.3f} ms (events, pageable, "
                         f"{pano.nbytes} B)")
        elif color or native_loader.get_lib() is not None:
            frames_host = batch.color if color else batch.gray
            pano, _, ms = timed(torch, lambda: stream_out.compose_host(
                frames_host[:10], offs, cfg))
            parts.append(f"compose {ms:.1f} ms (host float64, "
                         f"{native_loader.route()} route, int16 canvas "
                         f"{pano.size * 2} B); D2H none")
        else:
            _, steps, _ = compose_mod.plan_compose(offs, (h, w), cfg)
            rect_px = sum(p[2] * p[3] for p in
                          stream_out.visible_rect_pieces(steps, (h, w)))
            pano, ms, _ = timed(torch, lambda: stream_out.compose_streamed(
                batch.gray[:10], offs, cfg, frames_dev=gray_dev[:10]))
            parts.append(f"compose_streamed {ms:.1f} ms (events: device "
                         f"compose, D2H of {rect_px} B of visible fusion "
                         f"rects, host paste replay)")
        if not np.array_equal(pano, res[0].image):
            raise AssertionError(f"{label}: the phase-by-phase panorama "
                                 f"differs")
        _, _, ms = timed(torch, lambda: codec.imwrite(
            os.path.join(work, "phase.png"), pano))
        parts.append(f"imwrite {ms:.1f} ms (host, PNG, {pano.nbytes} B)")
        return "; ".join(parts)

    def run_files(label, flags):
        """The CLI on the project (counts from 0), then a warm
        Stitcher.stitch_files run and a plain one; returns the warm run's
        results and its configuration."""
        out = os.path.join(work, label[1])
        argv = ["stitch", proj, out, "--device", "cuda", "--file-extension",
                "png", "--output-extension", "png"] + flags
        cfg = cli.config_from_args(cli.build_parser().parse_args(argv)
                                   ).replace(print_log=False)
        zero_counts()
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise AssertionError(f"{label}: the CLI returned nonzero")
        wall_cli = time.perf_counter() - t0
        launches = read_counts(label, expect)
        if sorted(os.listdir(out)) != outputs:
            raise AssertionError(f"{label}: wrote {sorted(os.listdir(out))}")
        t0 = time.perf_counter()
        res = Stitcher(cfg, device=dev).stitch_files(files)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_plain = Stitcher(cfg.replace(use_kernels=False),
                             device=dev).stitch_files(files)
        wall_plain = time.perf_counter() - t0
        report = check_run(label, res, res_plain, [(0, 10), (10, 11)])
        for name, r in zip(outputs, res):
            if not np.array_equal(codec.imread(os.path.join(out, name),
                                               cfg.color_mode), r.image):
                raise AssertionError(f"{label}: {name} differs from "
                                     f"stitch_files' panorama")
        pano = res[0].image
        shape = compose_mod.compute_placement(res[0].offsets, (h, w)
                                              ).canvas_shape
        shape += (3,) if cfg.color_mode else ()
        covered = pano.reshape(shape[0], shape[1], -1).max(-1) > 0
        if pano.dtype != np.uint8 or pano.shape != shape or \
                covered.mean() < 0.9:
            raise AssertionError(f"{label}: panorama {pano.dtype} "
                                 f"{pano.shape}, want {shape}")
        if cfg.color_mode and not all(
                (pano[..., a] != pano[..., b]).mean() > 0.5
                for a, b in ((0, 1), (1, 2), (0, 2))):
            raise AssertionError(f"{label}: the color channels agree")
        phases = phase_times(label, cfg, res)
        print(f"slice {label}: {len(files)} PNG files -> {outputs}, "
              f"{report.num_ok}/{report.num_pairs} pairs, offsets "
              f"{report.offsets} (confidence {report.confidences}), "
              f"panorama {pano.shape}; CLI wall {wall_cli:.3f} s; warm wall "
              f"{wall:.3f} s with kernels, {wall_plain:.3f} s plain; phases: "
              f"{phases}; launches {launches}")
        return res, cfg

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        proj = os.path.join(work, "proj")
        t0 = time.perf_counter()
        for i, im in enumerate(colors):
            codec.imwrite(os.path.join(proj, "1", f"tile_{i:02d}.png"), im)
        files = dataset.list_project_images(proj, 1, "png")
        decoder = (f"cv2 {codec.cv2.__version__}" if codec._HAS_CV2
                   else "PIL")
        print(f"files: {len(files)} BGR frames {colors.shape[1:]} made in "
              f"{t_data:.1f} s, written as PNG in "
              f"{time.perf_counter() - t0:.1f} s; codec {decoder}; C++ host "
              f"runtime: {native_loader.route()} route")
        res_e, cfg_e = run_files("(e) CLI color", [])
        # the CPU composer is the JAX composer's arithmetic (CPU tests)
        if not np.array_equal(compose_mod.compose(
                colors[:10], res_e[0].offsets, cfg_e, device="cpu"),
                res_e[0].image):
            raise AssertionError("(e): the device panorama differs from the "
                                 "CPU composer's")
        print("(e) device color panorama == the CPU composer's")
        res_f, _ = run_files("(f) CLI color --stream-output",
                             ["--stream-output"])
        if records_of(res_f[0].report) != records_of(res_e[0].report):
            raise AssertionError("(f): records differ from (e)'s")
        diff = np.abs(res_f[0].image.astype(np.int16)
                      - res_e[0].image.astype(np.int16))
        if diff.max() > 1 or (diff != 0).mean() >= 1e-2:
            raise AssertionError(f"(f): host float64 against the device "
                                 f"composer: max diff {diff.max()}, "
                                 f"{(diff != 0).mean():.3g} differ")
        print(f"(f) against (e): {int((diff != 0).sum())} of {diff.size} "
              f"values differ, by at most {int(diff.max())}")
        res_g, cfg_g = run_files("(g) CLI --gray --stream-output",
                                 ["--gray", "--stream-output"])
        gray_g = dataset.load_batch(files[:10], False).gray
        ref = compose_mod.compose(torch.as_tensor(gray_g, device=dev),
                                  res_g[0].offsets, cfg_g)
        if not np.array_equal(ref, compose_mod.compose(
                gray_g, res_g[0].offsets, cfg_g, device="cpu")):
            raise AssertionError("(g): the device gray panorama differs from "
                                 "the CPU composer's")
        diff = np.abs(res_g[0].image.astype(np.int16) - ref.astype(np.int16))
        if native_loader.get_lib() is not None:
            route = "compose_host"
            ok = diff.max() <= 1 and (diff != 0).mean() < 1e-2
        else:
            route = "compose_streamed"
            ok = diff.max() == 0
        if not ok:
            raise AssertionError(f"(g): {route} against the device composer: "
                                 f"max diff {diff.max()}")
        print(f"(g) {route} against the device composer (== the CPU "
              f"composer): {int((diff != 0).sum())} of {diff.size} pixels "
              f"differ")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 6. the phase-correlation registrations
    t0 = time.perf_counter()
    ppos = synthetic.serpentine_positions(5, 2, (1698.37, 2284.21))
    pseq, ptruth = synthetic.sequence(7, (h, w), ppos)
    pframes = np.concatenate([pseq, other])
    pbatch = ImageBatch(gray=pframes, color=None,
                        files=[f"phase-{i}" for i in range(len(pframes))])
    pgray = torch.as_tensor(pframes, device=dev)
    print(f"phase data: {pframes.shape} uint8 in "
          f"{time.perf_counter() - t0:.1f} s; true offsets "
          f"{[tuple(round(v, 2) for v in t) for t in ptruth.tolist()]}")

    class Recording(Stitcher):
        """The Stitcher, keeping the records of its last registration."""

        def register(self, gray):
            self.records = super().register(gray)
            return self.records

    def integers(recs):
        # a failed whole-image record's offset is a noise peak: not compared
        return [(r.ok, tuple(r.offset) if r.ok else None, r.direction,
                 r.scale, r.attempts) for r in recs]

    def hold(label, got, ref, what, atol=1e-3):
        """Integer fields of ``got`` equal ``ref``'s (records or tuples);
        with records, the sub-pixel offsets within ``atol`` px.  Returns the
        largest sub-pixel and response gaps."""
        want = ref if ref and isinstance(ref[0], tuple) else integers(ref)
        if integers(got) != want:
            raise AssertionError(f"{label}: records {integers(got)}, "
                                 f"{what}'s {want}")
        if ref and isinstance(ref[0], tuple):
            return 0.0, 0.0
        sub = max([abs(a - b) for g, r in zip(got, ref) if g.ok
                   for a, b in zip(g.offset_subpix, r.offset_subpix)],
                  default=0.0)
        resp = max(abs(g.confidence - r.confidence) for g, r in zip(got, ref))
        if sub > atol:
            raise AssertionError(f"{label}: sub-pixel offsets {sub} px from "
                                 f"{what}'s")
        return sub, resp

    def run_phase_path(label, cfg, expect, segments):
        """Warm-up, then the counted run; checks segments, launches and
        every registered pair against the truth.  Returns the Stitcher, its
        results and the warm wall."""
        Recording(cfg, device=dev).stitch_batch(pbatch)
        torch.cuda.synchronize()
        zero_counts()
        st = Recording(cfg, device=dev)
        t0 = time.perf_counter()
        res = st.stitch_batch(pbatch)
        wall = time.perf_counter() - t0
        launches = read_counts(label, expect)
        if [r.file_range for r in res] != segments:
            raise AssertionError(f"{label}: segments "
                                 f"{[r.file_range for r in res]}")
        for k, (r, t) in enumerate(zip(st.records, ptruth)):
            if r.ok and max(abs(r.offset[0] - t[0]),
                            abs(r.offset[1] - t[1])) >= 1:
                raise AssertionError(f"{label}: pair {k}: offset {r.offset}, "
                                     f"truth {t}")
        pano = res[0].image
        if pano.dtype != np.uint8 or pano.ndim != 2 or (pano > 0).mean() < 0.9:
            raise AssertionError(f"{label}: panorama {pano.dtype} "
                                 f"{pano.shape}")
        return st, res, wall, launches

    def report_line(label, st, res, wall, launches, gaps):
        rep = res[0].report
        subpix = [tuple(round(v, 4) for v in r.offset_subpix)
                  for r in st.records]
        print(f"slice {label}: {len(pframes)} x {h}x{w} frames, "
              f"{rep.num_ok}/{rep.num_pairs} pairs, segments "
              f"{[r.file_range for r in res]}, offsets {rep.offsets}, "
              f"sub-pixel {subpix} "
              f"(confidence {[round(c, 4) for c in rep.confidences]}, "
              f"directions {rep.directions}, scales {rep.scales}, attempts "
              f"{rep.attempts}), panorama {res[0].image.shape}; card against "
              f"CPU: sub-pixel gap {gaps[0]:.3g} px, response gap "
              f"{gaps[1]:.3g}; warm wall {wall:.3f} s; launches {launches}")

    no_kernel = dict.fromkeys(counters, 0)
    phase_segments = [(0, 10), (10, 11)]
    searches = []
    for label, reg in (("(h) phase_incre", "phase_incre"),
                       ("(i) phase", "phase")):
        cfg = base.replace(registration=reg)
        st, res, wall, launches = run_phase_path(
            label, cfg, no_kernel, phase_segments)
        hold(label, st.records, EXPECTED[reg], "the JAX package")
        if reg == "phase":
            records_i = list(st.records)
        cpu = Recording(cfg, device="cpu")
        cres = cpu.stitch_batch(pbatch)
        # whole frames pad to 3888x5184: float32 FFTs of 20M points in two
        # libraries move the centroid by up to ~1e-3 px
        gaps = hold(label, st.records, cpu.records, "the CPU",
                    5e-3 if reg == "phase" else 1e-3)
        if [r.file_range for r in cres] != [r.file_range for r in res] or \
                not all(np.array_equal(a.image, b.image)
                        for a, b in zip(res, cres)):
            raise AssertionError(f"{label}: panoramas differ from the CPU's")
        report_line(label, st, res, wall, launches, gaps)
        fn = (treg.register_sequence_phase if reg == "phase_incre"
              else treg.register_sequence_phase_whole)
        recs, ms, _ = timed(torch, lambda: fn(pgray, cfg))
        searches.append(f"{label} {ms:.2f} ms, {sum(r.attempts for r in recs)}"
                        f" attempts, " + (
                            f"{treg.LAST_PHASE_STATS['dispatches']} dispatches"
                            if reg == "phase_incre" else
                            f"1 dispatch of {len(recs)} pairs"))

    label = "(j) hybrid"
    cfg = base.replace(registration="hybrid")
    st, res, wall, launches = run_phase_path(
        label, cfg, {"doh_select": 11, "describe_atlas": 11,
                     "top2_l2_coords": None, "doh_score_map": 2,
                     "top2_l2": 0, "window_colsum": 0},
        phase_segments)
    feat = freg.register_sequence_features_incre(pgray, cfg)
    failed = [k for k, r in enumerate(feat) if not r.ok]
    if [st.records[k] for k in range(len(feat)) if k not in failed] != \
            [r for k, r in enumerate(feat) if k not in failed]:
        raise AssertionError(f"{label}: a feature-ok pair lost its record")
    if treg.LAST_PHASE_STATS["pairs_evaluated"] != failed:
        raise AssertionError(f"{label}: the phase fallback evaluated pairs "
                             f"{treg.LAST_PHASE_STATS['pairs_evaluated']}, "
                             f"not the failed {failed}")
    direction = next((feat[k].direction for k in range(failed[0] - 1, -1, -1)
                      if feat[k].ok and feat[k].direction), cfg.direction)
    part = [st.records[k] for k in failed]
    hold(label, part, EXPECTED["hybrid"], "the JAX package")
    pcfg = cfg.replace(direction=direction)
    gaps = hold(label, part, treg.register_sequence_phase(
        pframes, pcfg, pairs=failed, device="cpu"), "the CPU")
    report_line(label, st, res, wall, launches, gaps)
    recs, ms, _ = timed(torch, lambda: treg.register_sequence_phase(
        pgray, pcfg, pairs=failed))
    searches.append(f"{label} phase part (pairs {failed}, from direction "
                    f"{direction}) {ms:.2f} ms, "
                    f"{sum(r.attempts for r in recs)} attempts, "
                    f"{treg.LAST_PHASE_STATS['dispatches']} dispatches")
    print("phase searches (events, host replay included): "
          + "; ".join(searches))

    # ---- 7. path (k): the other fusion modes on the feature set's first
    # segment, with path (a)'s offsets; no kernel lies on this path
    from imagestitch_tpu_torch.ops.fusion import seam as fseam
    seg = frames[:10]
    _, ksteps, _ = compose_mod.plan_compose(offsets_a, (h, w), base)
    fused_px = np.zeros(compose_mod.compute_placement(
        offsets_a, (h, w)).canvas_shape, bool)
    for st_ in ksteps:
        if st_[0] == "fuse":
            (rr, rc), (rh, rw) = st_[3], st_[4]
            fused_px[rr:rr + rh, rc:rc + rw] = True
    fusion = []
    for mode in ("notFuse", "average", "maximum", "minimum", "trigonometric",
                 "multiBandBlending", "optimalSeamLine"):
        label = f"(k) {mode}"
        kcfg = base.replace(fuse_method=mode)
        compose_mod.compose(gray[:10], offsets_a, kcfg)            # warm-up
        zero_counts()
        pano_dev, ms, wall = timed(torch, lambda: compose_mod.compose(
            gray[:10], offsets_a, kcfg, return_device=True))
        read_counts(label, no_kernel)
        if pano_dev.device.type != "cuda":
            raise AssertionError(f"{label}: composed on {pano_dev.device}")
        pano = pano_dev.cpu().numpy()
        cpu = compose_mod.compose(seg, offsets_a, kcfg, device="cpu")
        diff = np.abs(pano.astype(np.int16) - cpu.astype(np.int16))
        frac = float((diff[fused_px] != 0).mean())
        if pano.shape != fused_px.shape or (pano > 0).mean() < 0.9:
            raise AssertionError(f"{label}: panorama {pano.shape}")
        if diff.any():
            raise AssertionError(f"{label}: card against the CPU: max "
                                 f"diff {diff.max()}, {frac:.3g} of the "
                                 f"fused-rect pixels differ")
        item = (f"{mode} {ms:.2f} ms (wall {wall:.1f}), {frac:.3g} of "
                f"fused differ")
        if mode in compose_mod._PADDABLE_METHODS:
            host = stream_out.compose_host(seg, offsets_a, kcfg)
            hd = np.abs(host.astype(np.int16) - pano.astype(np.int16))
            if hd.max() > 1 or (hd != 0).mean() >= 1e-2:
                raise AssertionError(f"{label}: host float64 against the "
                                     f"card: max diff {hd.max()}, "
                                     f"{(hd != 0).mean():.3g} differ")
            item += (f", host f64 ({native_loader.route()}) "
                     f"{(hd != 0).mean():.3g} of values differ")
        fusion.append(item)
    # the odd layout of tests/test_torch_pyramid_seam.py (pyramid levels
    # of odd size, the resize of ops/fusion/pyramid.py): card == CPU
    opos = synthetic.serpentine_positions(2, 2, (192.37, 224.21))
    oframes = synthetic.sequence(11, (256, 320), opos)[0]
    odd_offsets = [(190, 3), (1, 221), (-187, -2)]
    for mode in ("multiBandBlending", "optimalSeamLine"):
        ocfg = base.replace(fuse_method=mode)
        zero_counts()
        got = compose_mod.compose(oframes, odd_offsets, ocfg)
        read_counts(f"(k) odd {mode}", no_kernel)
        if not np.array_equal(got, compose_mod.compose(
                oframes, odd_offsets, ocfg, device="cpu")):
            raise AssertionError(f"(k) odd layout {mode}: card differs "
                                 f"from the CPU")
    fusion.append("odd layout (4 x 256x320, levels of odd size): "
                  "multiBandBlending and optimalSeamLine card == CPU")
    # the seam of every fusion rect: the card's energy against the CPU's
    # on the same rects, the CPU's mask from the card's energy
    rois = []
    real_fuse = fseam.fuse_optimal_seam

    def keep_rois(a, b):
        rois.append((a.clone(), b.clone()))
        return real_fuse(a, b)
    fseam.fuse_optimal_seam = keep_rois
    try:
        compose_mod.compose(gray[:10], offsets_a,
                            base.replace(fuse_method="optimalSeamLine"))
    finally:
        fseam.fuse_optimal_seam = real_fuse
    dp_walls, e_gap = [], 0.0
    for a, b in rois:
        pa, pb = fseam._prefill_background(a, b)
        e_dev = fseam.seam_energy(pa, pb)
        e_cpu = fseam.seam_energy(pa.cpu(), pb.cpu())
        gap = float(((e_dev.cpu() - e_cpu).abs()
                     / e_cpu.abs().clamp_min(1e-30)).max())
        if gap > 1e-5:
            raise AssertionError(f"(k) seam energy: {gap:.3g} relative "
                                 f"from the CPU's")
        e_gap = max(e_gap, gap)
        m_dev, _, dp_wall = timed(torch, lambda: fseam.find_optimal_seam(
            e_dev))
        if not torch.equal(m_dev.cpu(), fseam.find_optimal_seam(
                e_dev.cpu())):
            raise AssertionError(f"(k) seam mask of a {tuple(a.shape)} rect "
                                 f"differs from the CPU's")
        dp_walls.append((tuple(a.shape), round(dp_wall, 1)))
    for mode in compose_mod._GRAY_ONLY_METHODS:
        try:
            compose_mod.compose(np.zeros((2, 8, 8, 3), np.uint8), [(4, 0)],
                                base.replace(fuse_method=mode))
        except ValueError:
            continue
        raise AssertionError(f"(k) color {mode} did not raise")
    # the CLI on the 11 frames as gray PNGs
    work = tempfile.mkdtemp(prefix="chip_smoke_k_")
    try:
        proj = os.path.join(work, "proj")
        for i, im in enumerate(frames):
            codec.imwrite(os.path.join(proj, "1", f"tile_{i:02d}.png"), im)
        files = dataset.list_project_images(proj, 1, "png")
        out = os.path.join(work, "k")
        argv = ["stitch", proj, out, "--device", "cuda", "--file-extension",
                "png", "--output-extension", "png", "--gray",
                "--stream-output", "--fuse-method", "multiBandBlending",
                "--quiet"]
        kcfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        zero_counts()
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise AssertionError("(k) CLI: returned nonzero")
        wall_cli = time.perf_counter() - t0
        read_counts("(k) CLI", expect)
        if sorted(os.listdir(out)) != outputs:
            raise AssertionError(f"(k) CLI: wrote {sorted(os.listdir(out))}")
        res = Stitcher(kcfg, device=dev).stitch_files(files)
        for name, r in zip(outputs, res):
            if not np.array_equal(codec.imread(os.path.join(out, name),
                                               False), r.image):
                raise AssertionError(f"(k) CLI: {name} differs from "
                                     f"stitch_files' panorama")
        if res[0].offsets != offsets_a:
            raise AssertionError(f"(k) CLI: offsets {res[0].offsets}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"fusion (k): {len(seg)} x {h}x{w} gray frames, path (a)'s "
          f"offsets, {int(fused_px.sum())} fused-rect pixels; card against "
          f"the CPU composer, device ms (events, wall ms host clock): "
          + "; ".join(fusion) + f"; seam energy card/CPU max relative gap "
          f"{e_gap:.3g}, masks equal, DP wall ms by rect {dp_walls}; color "
          f"multiband and seam raise; CLI --gray --stream-output "
          f"--fuse-method multiBandBlending {wall_cli:.3f} s -> {outputs}, "
          f"== stitch_files")

    # ---- 8. the slice of strict-ROI detection, enhancement, the XLA pool
    # and RANSAC: paths (l)-(o) on the feature set
    def slice_path(label, cfg, n, expect, n_cpu, px=1, true_direction=False):
        """Warm-up, the counted kernel run, the plain run, and the port's
        CPU run on the first ``n_cpu`` frames against the card's on the
        same frames.  Every registered pair within ``px`` of the truth, or
        with ``true_direction`` every pair registered in its true direction
        (homography RANSAC accepts a coincidental 4-match fit of strips
        that do not overlap, as the reference's estimator does)."""
        batch = ImageBatch(gray=frames[:n], color=None,
                           files=[f"frame-{i}" for i in range(n)])
        Recording(cfg, device=dev).stitch_batch(batch)         # warm-up
        torch.cuda.synchronize()
        zero_counts()
        st = Recording(cfg, device=dev)
        t0 = time.perf_counter()
        res = st.stitch_batch(batch)
        wall = time.perf_counter() - t0
        launches = read_counts(label, expect)
        t0 = time.perf_counter()
        plain = Recording(cfg.replace(use_kernels=False), device=dev)
        res_plain = plain.stitch_batch(batch)
        wall_plain = time.perf_counter() - t0
        hold(label, st.records, plain.records, "the plain run")
        if records_of(res[0].report) != records_of(res_plain[0].report) or \
                not all(np.array_equal(a.image, b.image)
                        for a, b in zip(res, res_plain)):
            raise AssertionError(f"{label}: kernel run differs from the "
                                 f"plain run")
        small = ImageBatch(gray=frames[:n_cpu], color=None,
                           files=[f"frame-{i}" for i in range(n_cpu)])
        card = st if n_cpu == n else Recording(cfg, device=dev)
        if n_cpu != n:
            card.stitch_batch(small)
        cpu = Recording(cfg, device="cpu")
        t0 = time.perf_counter()
        cpu.stitch_batch(small)
        wall_cpu = time.perf_counter() - t0
        rep = res[0].report
        # the serpentine's steps: down (1), right (2), up (3)
        true_dir = [1 if t[0] > 1000 else 3 if t[0] < -1000 else 2
                    for t in truth]
        near = [k for k, (r, t) in enumerate(zip(st.records, truth))
                if r.ok and max(abs(r.offset[0] - t[0]),
                                abs(r.offset[1] - t[1])) < px]
        print(f"slice {label}: {n} x {h}x{w} frames, {rep.num_ok}/"
              f"{rep.num_pairs} pairs, pairs {near} within {px} px of the "
              f"truth, segments {[r.file_range for r in res]}, offsets "
              f"{rep.offsets} (confidence {rep.confidences}, directions "
              f"{rep.directions}, scales {rep.scales}), panorama "
              f"{res[0].image.shape}; warm wall {wall:.3f} s with kernels, "
              f"{wall_plain:.3f} s plain; launches {launches}; CPU run of "
              f"the first {n_cpu} frames {wall_cpu:.1f} s")
        for k, (r, t) in enumerate(zip(st.records, truth)):
            if r.ok and k not in near and (not true_direction
                                           or r.direction == true_dir[k]):
                raise AssertionError(f"{label}: pair {k}: offset {r.offset} "
                                     f"(direction {r.direction}), truth {t}")
        if any(r.image.dtype != np.uint8 or r.image.ndim != 2 for r in res):
            raise AssertionError(f"{label}: panoramas not 2-D uint8")
        sub, _ = hold(label, card.records, cpu.records, "the CPU run")
        print(f"slice {label}: integer records == the CPU run's on the "
              f"first {n_cpu} frames, sub-pixel within {sub:.3g} px")
        return st, res

    from imagestitch_tpu_torch import EnhanceConfig
    no_pool = {"doh_select": 0, "describe_atlas": 0, "doh_score_map": 0}
    # (l): every pair's first attempt is accepted (no pair fails, so the
    # oriented fallback and K4 do not run); from the row step on, the
    # persisting direction 1 meets strips that do not overlap
    slice_path("(l) feature_incre ransac", base.replace(
        offset_calculate="ransac", features=FeatureConfig()), 11,
        {"doh_select": 11, "describe_atlas": 11, "top2_l2_coords": None,
         "doh_score_map": 0, "top2_l2": 0}, 11, true_direction=True)
    slice_path("(m) feature_incre use_pallas=False", base.replace(
        use_pallas=False, features=FeatureConfig()), 11,
        dict(no_pool, top2_l2_coords=None, top2_l2=0), 4)
    # (w): (m) with the bfloat16 detector (compute_dtype reaches only the
    # XLA detector's pools)
    slice_path("(w) feature_incre use_pallas=False bfloat16", base.replace(
        use_pallas=False, compute_dtype="bfloat16",
        features=FeatureConfig()), 11,
        dict(no_pool, top2_l2_coords=None, top2_l2=0), 4)
    slice_path("(n) feature_incre strict CLAHE ransac_translation",
               base.replace(offset_calculate="ransac_translation",
                            enhance=EnhanceConfig(enabled=True,
                                                  use_clahe=True),
                            features=FeatureConfig(strict_roi_detect=True)),
               7, dict(no_pool, top2_l2=None, top2_l2_coords=0), 4)
    # (o): the translation column of a homography fit over whole frames
    # that overlap by 7.5% lies up to a few px from the offset
    slice_path("(o) feature equalize ransac", base.replace(
        registration="feature", offset_calculate="ransac",
        enhance=EnhanceConfig(enabled=True), features=FeatureConfig()), 11,
        dict(no_pool, top2_l2=None, top2_l2_coords=0), 4, px=5)

    # ---- 10. the other detector and descriptor families and the global
    # solver: paths (p)-(s) on the feature set
    from imagestitch_tpu_torch.solver import loop_closure, pose_graph
    slice_path("(p) feature_incre sift", base.replace(
        features=FeatureConfig(method="sift")), 11,
        dict(no_pool, doh_score_map=None, top2_l2_coords=None, top2_l2=0), 4)
    # (q): ORB's matched displacements average about 0.6 px below the
    # truth on these frames (the JAX package's too: 1789.81 for 1790.37 on
    # pair 0), and the replay truncates the mean, so the integer offsets
    # lie up to 1.4 px from the truth
    slice_path("(q) feature_incre orb", base.replace(
        features=FeatureConfig(method="orb")), 11,
        dict(no_pool, top2_l2_coords=0, top2_l2=0), 4, px=2)
    slice_path("(r) feature_incre box_filter", base.replace(
        features=FeatureConfig(box_filter=True)), 11,
        dict(no_pool, top2_l2_coords=None, top2_l2=0), 4)
    cfg_s = base.replace(use_global_solver=True, features=FeatureConfig())
    st, res = slice_path("(s) feature_incre use_global_solver", cfg_s, 10,
                         {"doh_select": 10, "describe_atlas": 10,
                          "top2_l2_coords": None, "doh_score_map": 0,
                          "top2_l2": 0}, 4)
    # the solve once more, on the card and on the CPU, from the card's
    # records: positions within 1e-2 px and equal once rounded, the
    # panorama the CPU composer's from the CPU's positions
    subpix = [r.offset_subpix for r in st.records]
    conf = [max(r.confidence, 1e-3) for r in st.records]
    chain = pose_graph.chain_positions(subpix)
    solved = []
    for where, imgs in ((dev, gray[:10]), ("cpu", frames[:10])):
        graph, n_loop = loop_closure.close_loops(
            imgs, pose_graph.PoseGraph.from_chain(subpix, conf), chain,
            (h, w), device=where)
        pos, _, ms = timed(torch, lambda: pose_graph.solve(graph,
                                                           device=where))
        solved.append((n_loop, pos, ms, graph))
    (n_card, pos_card, solve_ms, g_card), (n_cpu, pos_cpu, _, _) = solved
    pos_gap = float(np.abs(pos_card - pos_cpu).max())
    if n_card < 1 or n_card != n_cpu or pos_gap > 1e-2 or not \
            np.array_equal(np.round(pos_card.astype(np.float64)),
                           np.round(pos_cpu.astype(np.float64))):
        raise AssertionError(f"(s): {n_card} loop edges on the card, "
                             f"{n_cpu} on the CPU; positions {pos_gap} px "
                             f"apart")
    cpu_pano = compose_mod.compose_from_positions(frames[:10], pos_cpu,
                                                  cfg_s, device="cpu")
    if not np.array_equal(res[0].image, cpu_pano):
        raise AssertionError("(s): the panorama differs from the CPU "
                             "composer's from the CPU's positions")
    if pose_graph.solve(g_card, device=dev).tobytes() != pos_card.tobytes():
        raise AssertionError("(s): the card's solve differs from run to run")
    # the CLI on the 11 color PNGs with the solver and host output: the
    # solved segment through compose_host_positions
    host_calls = []
    orig_host = stream_out.compose_host_positions

    def counted_host(*a, **kw):
        host_calls.append(a[0].shape)
        return orig_host(*a, **kw)

    stream_out.compose_host_positions = counted_host
    work = tempfile.mkdtemp(prefix="chip_smoke_s_")
    try:
        proj = os.path.join(work, "proj")
        for i, im in enumerate(colors):
            codec.imwrite(os.path.join(proj, "1", f"tile_{i:02d}.png"), im)
        files = dataset.list_project_images(proj, 1, "png")
        out = os.path.join(work, "s")
        argv = ["stitch", proj, out, "--device", "cuda", "--file-extension",
                "png", "--output-extension", "png", "--use-solver",
                "--stream-output", "--quiet"]
        scfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        zero_counts()
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise AssertionError("(s) CLI: returned nonzero")
        wall_cli = time.perf_counter() - t0
        read_counts("(s) CLI", {"doh_select": 11, "describe_atlas": 11,
                                "top2_l2_coords": None})
        if sorted(os.listdir(out)) != outputs or len(host_calls) != 1:
            raise AssertionError(f"(s) CLI: wrote {sorted(os.listdir(out))}"
                                 f", host composer calls {host_calls}")
        res_cli = Stitcher(scfg, device=dev).stitch_files(files)
        for name, r in zip(outputs, res_cli):
            if not np.array_equal(codec.imread(os.path.join(out, name),
                                               True), r.image):
                raise AssertionError(f"(s) CLI: {name} differs from "
                                     f"stitch_files' panorama")
    finally:
        stream_out.compose_host_positions = orig_host
        shutil.rmtree(work, ignore_errors=True)
    print(f"solver (s): {n_card} loop-closure edges (card and CPU), "
          f"positions card/CPU within {pos_gap:.3g} px and equal rounded, "
          f"the card's solve {solve_ms:.1f} ms wall, equal from run to run; "
          f"panorama {res[0].image.shape} == the CPU composer's from the "
          f"CPU's positions; CLI --use-solver --stream-output {wall_cli:.3f}"
          f" s -> {outputs} through compose_host_positions "
          f"{host_calls[0]}, == stitch_files")

    # ---- 11. path (p'): oriented SIFT, every frame through the score-map
    # pool with glibc's angles and XLA's sums (no fallback: no pair is
    # upright to begin with)
    cfg_p2 = base.replace(features=FeatureConfig(method="sift",
                                                 auto_upright=False))
    slice_path("(p') feature_incre sift oriented", cfg_p2, 11,
               dict(no_pool, doh_score_map=11, top2_l2_coords=None,
                    top2_l2=0), 4)
    sp_sift = freg._describe_params(cfg_p2)
    dp_sift = freg._detect_params(cfg_p2)
    kw_pool = dict(max_pool=FeatureConfig().pool_keypoints)
    pool_card = freg.pool_features(gray[:1], dp_sift, sp_sift, **kw_pool)
    pool_cpu = freg.pool_features(torch.as_tensor(frames[:1]), dp_sift,
                                  sp_sift, **kw_pool)
    for a, b in zip(pool_card[:3], pool_cpu[:3]):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("(p'): the card's SIFT pool keypoints "
                                 "differ from the CPU's")
    live = pool_cpu[2][0] > 0
    rows_bad = ((pool_card[3][0].cpu() - pool_cpu[3][0]).abs().amax(-1)
                > 1e-5)[live]
    share_p = float(rows_bad.float().mean())
    if share_p > ORIENTED_SIFT_SHARE:
        raise AssertionError(f"(p'): {share_p:.4f} of the oriented SIFT "
                             f"rows differ card against CPU")
    # the oriented describe of frame 0 at its pool's keypoints: SURF-128
    # (the torch ops) against SIFT (glibc's angles and XLA's sums), device
    # ms by CUDA events (5 calls, enqueued while the stream sleeps)
    from imagestitch_tpu_torch.ops.features import describe as fdesc
    img0 = gray[:1].to(torch.float32)
    kp_r, kp_c = pool_card[0][:1], pool_card[1][:1]
    desc_ms = {fam: cuda_ms(torch, lambda: fdesc.describe_batch(
        img0, kp_r, kp_c, fdesc.DescribeParams(family=fam, upright=False)),
        iters=5, warmup=2) for fam in ("surf-extended", "sift")}
    print(f"(p') oriented SIFT rows card against CPU: {int(rows_bad.sum())} "
          f"of {int(live.sum())} beyond 1e-5 ({share_p:.4f}, bound "
          f"{ORIENTED_SIFT_SHARE}); oriented describe of frame 0's "
          f"{kp_r.numel()} pool keypoints, device ms: SURF-128 "
          f"{desc_ms['surf-extended']:.4f}, SIFT {desc_ms['sift']:.4f}; "
          f"{smi}")

    # ---- 12. path (t): the single-device evaluation, phase by phase
    import cv2
    from imagestitch_tpu_torch.eval import accuracy as eval_acc
    from imagestitch_tpu_torch.eval import loop_closure_demo as eval_lcd
    from imagestitch_tpu_torch.eval import synthetic as eval_syn
    from imagestitch_tpu_torch.utils import image as uimage
    from imagestitch_tpu_torch.utils.profiling import PhaseTimer
    timer = PhaseTimer()
    # (t1) the 25 x 40 grid, 400 CG steps: the card's solve against its
    # own rerun and the port's CPU solve
    with timer.phase("t1 synthetic.run"):
        grid = eval_syn.run(25, 40, iters=400)
    if (grid.n_tiles, grid.n_edges, grid.n_devices) != (1000, 1935, 1) or \
            not grid.mean_abs_err_px < min(
                2.0, grid.chain_mean_abs_err_px / 3):
        raise AssertionError(f"(t1): {grid}")
    g_grid, _ = eval_syn.make_grid_graph(25, 40)
    pos_grid = [pose_graph.solve(g_grid, iters=400, device=where)
                for where in (dev, dev, "cpu")]
    gap_t1 = float(np.abs(pos_grid[0] - pos_grid[2]).max())
    if pos_grid[0].tobytes() != pos_grid[1].tobytes() or gap_t1 > 1e-2:
        raise AssertionError(f"(t1): the card's solve is {gap_t1} px from "
                             f"the CPU's or differs from run to run")
    # (t2), (t3): the first 10 frames of the feature set as gray JPEGs in
    # the demo layout
    work = tempfile.mkdtemp(prefix="chip_smoke_t_")
    try:
        droot = os.path.join(work, "demo")
        ddir = os.path.join(droot, "dendriticCrystal", "1")
        os.makedirs(ddir)
        for i in range(10):
            if not cv2.imwrite(os.path.join(ddir, f"img_{i:03d}.jpg"),
                               frames[i]):
                raise AssertionError("(t): JPEG not written")
        cfg_t2 = eval_acc.dataset_configs()["dendriticCrystal"]
        has_oracle = hasattr(cv2, "SIFT_create")
        eval_acc.evaluate_dataset(droot, "dendriticCrystal", cfg_t2,
                                  use_oracle=False)               # warm-up
        torch.cuda.synchronize()
        zero_counts()
        with timer.phase("t2 evaluate_dataset"):
            acc = eval_acc.evaluate_dataset(droot, "dendriticCrystal",
                                            cfg_t2, use_oracle=has_oracle)
        read_counts("(t2)", {"doh_select": 10, "describe_atlas": 10,
                             "top2_l2_coords": None})
        acc_plain = eval_acc.evaluate_dataset(
            droot, "dendriticCrystal", cfg_t2.replace(use_kernels=False),
            use_oracle=False)
        far = [k for k, (o, t) in enumerate(zip(acc.offsets, truth))
               if max(abs(o[0] - t[0]), abs(o[1] - t[1])) >= 1]
        if acc.num_ok != 9 or far or acc.offsets != acc_plain.offsets or \
                acc.num_ok != acc_plain.num_ok:
            raise AssertionError(f"(t2): {acc.num_ok} of 9 pairs, pairs "
                                 f"{far} 1 px or more from the truth; "
                                 f"offsets {acc.offsets}, plain run "
                                 f"{acc_plain.offsets}")
        if has_oracle:
            if acc.compared_pairs < 1 or acc.max_abs_err_px > 2:
                raise AssertionError(f"(t2): the cv2.SIFT oracle compared "
                                     f"{acc.compared_pairs} pairs, max "
                                     f"error {acc.max_abs_err_px} px")
            oracle = (f"the cv2.SIFT oracle on {acc.compared_pairs} pairs: "
                      f"max {acc.max_abs_err_px} px, {acc.within_1px} "
                      f"within 1 px, NCC wins {acc.ncc_wins}")
        else:
            oracle = "the cv2.SIFT oracle absent (cv2 has no SIFT_create)"
        # (t3): the drift report, card against the port's CPU run
        zero_counts()
        with timer.phase("t3 loop_closure_demo.run"):
            drift = eval_lcd.run(droot)
        read_counts("(t3)", {"doh_select": 10, "describe_atlas": 10,
                             "top2_l2_coords": None})
        drift_cpu = eval_lcd.run(droot, device="cpu")
        gap_t3 = max(abs(getattr(drift, f) - getattr(drift_cpu, f))
                     for f in ("chain_mean_residual_px",
                               "chain_max_residual_px",
                               "solved_mean_residual_px",
                               "solved_max_residual_px"))
        if drift.n_loop_edges != n_card or \
                drift.n_loop_edges != drift_cpu.n_loop_edges or \
                drift.solved_mean_residual_px > \
                drift.chain_mean_residual_px or \
                drift.solved_max_residual_px > drift.chain_max_residual_px \
                or gap_t3 > 1e-2:
            raise AssertionError(f"(t3): {drift} on the card, {drift_cpu} "
                                 f"on the CPU; (s) had {n_card} loop edges")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # (t4): path (a)'s panorama halved, and rectified with one diagonal
    # pair of its corners blanked (the rotating branch)
    pano_a = compose_mod.compose(gray[:10], offsets_a, base)
    with timer.phase("t4 resize"):
        half = uimage.resize(pano_a, 0.5)
    half_cpu = uimage.resize(pano_a, 0.5, device="cpu")
    rd = np.abs(half.astype(np.int16) - half_cpu.astype(np.int16))
    tilted = pano_a.copy()
    tilted[:10, :10] = 0
    tilted[-10:, -10:] = 0
    with timer.phase("t4 rectify_final"):
        rect = uimage.rectify_final(tilted)
    if rd.any() or \
            not np.array_equal(rect, uimage.rectify_final(tilted,
                                                          device="cpu")) \
            or np.array_equal(rect, tilted):
        raise AssertionError(f"(t4): resize {int((rd != 0).sum())} values "
                             f"off the CPU's (max {rd.max()}); rectify "
                             f"against the CPU's")
    print(f"eval (t): (t1) {grid.n_tiles} tiles, {grid.n_edges} edges, "
          f"error {grid.mean_abs_err_px:.4f} px (chain "
          f"{grid.chain_mean_abs_err_px:.4f}), solve "
          f"{grid.solve_seconds * 1e3:.1f} ms, card/CPU {gap_t1:.3g} px, "
          f"equal from run to run; (t2) {acc.num_ok}/{acc.num_pairs} pairs "
          f"within 1 px of the truth, == the plain run, {oracle}; (t3) "
          f"{drift.n_loop_edges} loop edges, residual mean/max chain "
          f"{drift.chain_mean_residual_px:.3f}/"
          f"{drift.chain_max_residual_px:.3f} px, solved "
          f"{drift.solved_mean_residual_px:.3f}/"
          f"{drift.solved_max_residual_px:.3f} px, card/CPU {gap_t3:.3g} "
          f"px; (t4) resize {pano_a.shape} -> {half.shape}, "
          f"{int((rd != 0).sum())} values off the CPU's, rectify == the "
          f"CPU's; walls (PhaseTimer, s) {timer.report()}; {smi}")

    # ---- 13. path (u): the device mesh, 4 shards sharing the one card
    # (the decomposition: halo, block rows, reduction order; no number
    # here is a scaling measurement)
    from imagestitch_tpu_torch.eval import compose_bench as eval_cb
    from imagestitch_tpu_torch.eval import scaling as eval_sc
    from imagestitch_tpu_torch.eval import stretch as eval_st
    from imagestitch_tpu_torch.parallel import compose_sharded as pcs
    from imagestitch_tpu_torch.parallel.mesh import make_mesh
    t_u = time.perf_counter()
    mesh4 = make_mesh(devices=[dev] * 4, axis="frames")
    mesh4_cpu = make_mesh(devices=["cpu"] * 4)
    batch11 = ImageBatch(gray=frames, color=None,
                         files=[f"frame-{i}" for i in range(11)])
    walls_u = {}

    def mesh_path(label, cfg, expect, votes=True):
        """The sharded run (counts from 0; after a warm-up), its plain run,
        and the single-device run on the card: records (with the vote
        counts unless ``votes`` is False) and panoramas equal.  Returns the
        sharded run's launches and report."""
        Stitcher(cfg, mesh=mesh4).stitch_batch(batch11)        # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = Stitcher(cfg, mesh=mesh4).stitch_batch(batch11)
        walls_u[label] = time.perf_counter() - t0
        launches = read_counts(label, expect)
        single = Stitcher(cfg, device=dev).stitch_batch(batch11)
        plain = Stitcher(cfg.replace(use_kernels=False),
                         mesh=mesh4).stitch_batch(batch11)
        key = lambda rs: ([r.file_range for r in rs],
                          [r.offsets for r in rs],
                          records_of(rs[0].report)[slice(None) if votes
                                                   else slice(0, 2)],
                          records_of(rs[0].report)[3:])
        for other, what in ((single, "the single-device run"),
                            (plain, "the sharded plain run")):
            if key(res) != key(other) or not all(
                    np.array_equal(a.image, b.image)
                    for a, b in zip(res, other)):
                raise AssertionError(f"{label}: differs from {what}")
        return launches, res[0].report

    # (u1): the flagship, 12 frames on 4 shards (the 11th repeated as the
    # 12th, whose records are never read), then the fallback on one device
    launch_u1, rep_u1 = mesh_path(
        "(u1) feature_incre sharded", base.replace(features=FeatureConfig()),
        {"doh_select": 12, "describe_atlas": 12, "top2_l2_coords": None,
         "doh_score_map": 2, "top2_l2": 0})
    if rep_u1.offsets[:9] != offsets_a:
        raise AssertionError(f"(u1): offsets {rep_u1.offsets}, (a) "
                             f"{offsets_a}")
    # (u2): whole-image feature through the halo'd all-pairs step (K3) and
    # the oriented retry on one device (K5); the step matches each frame's
    # top max_keypoints by score (JAX pooled_sharded.py:306), the single
    # device the whole pool, so the vote counts are not compared
    launch_u2, rep_u2 = mesh_path(
        "(u2) feature sharded", base.replace(registration="feature",
                                             features=FeatureConfig()),
        {"doh_select": 12, "describe_atlas": 12, "top2_l2_coords": None},
        votes=False)
    # (u3): the sharded canvas of (a)'s offsets in every gray mode against
    # the card's compose, bit-equal; each panorama left on the card, so
    # the events time the composition alone (as path (k)'s)
    modes_u3 = ["notFuse", "average", "maximum", "minimum",
                "fadeInAndFadeOut", "trigonometric", "multiBandBlending",
                "optimalSeamLine"]
    ms_u3 = {}
    for mode in modes_u3:
        cfg_m = base.replace(fuse_method=mode)
        (got, _), ms, _ = timed(torch, lambda: pcs.compose_sharded(
            gray[:10], offsets_a, cfg_m, mesh4, return_device=True))
        ref, ms_one, _ = timed(torch, lambda: compose_mod.compose(
            gray[:10], offsets_a, cfg_m, return_device=True))
        ms_u3[mode] = (ms, ms_one)
        if not torch.equal(got, ref):
            raise AssertionError(f"(u3) {mode}: the sharded canvas differs "
                                 f"from compose's")
    stats_u3 = dict(pcs.LAST_COMPOSE_STATS)
    # (u4): the edge-sharded solve of (s)'s graph and of (t1)'s 1,000-tile
    # grid: card == CPU bit for bit at 4 shards
    ms_u4 = []
    for g_u4, it in ((g_card, None), (g_grid, 400)):
        pos4, _, ms = timed(torch, lambda: pose_graph.solve(g_u4, iters=it,
                                                            mesh=mesh4))
        if pos4.tobytes() != pose_graph.solve(g_u4, iters=it,
                                              mesh=mesh4_cpu).tobytes():
            raise AssertionError(f"(u4): the card's sharded solve of "
                                 f"{g_u4.n_nodes} nodes differs from the "
                                 f"CPU's")
        ms_u4.append(ms)
    # (u5): the stretch flow at its default 32 x 32 grid of 96 x 128 tiles,
    # and at 4 x 4 full-size tiles (cut from the JAX package's 16 x 16
    # real-size run for time)
    st_u5 = [eval_st.run(devices=[dev] * 4),
             eval_st.run(grid=4, tile=(h, w), devices=[dev] * 4)]
    for r in st_u5:
        if not r.solved_rmse_px < r.chain_rmse_px or r.backend != "cuda":
            raise AssertionError(f"(u5): {r}")
    # (u6): compose_bench and scaling at 1, 2 and 4 shards
    cb_u6 = [eval_cb.run(devices=[dev] * d, repeats=2) for d in (1, 2, 4)]
    sc_u6 = eval_sc.run(device_counts=[1, 2, 4], devices=[dev] * 4,
                        repeats=2)
    if any(r.sharded_fuse_psums != 23 for r in cb_u6) or \
            [p.n_devices for p in sc_u6.points] != [1, 2, 4]:
        raise AssertionError(f"(u6): {cb_u6}, {sc_u6}")
    # (u7): the CLI, --mesh auto (one card: a one-shard mesh) and --mesh 2
    work = tempfile.mkdtemp(prefix="chip_smoke_u_")
    try:
        proj = os.path.join(work, "proj")
        for i in range(4):
            codec.imwrite(os.path.join(proj, "1", f"tile_{i:02d}.png"),
                          frames[i])
        argv = ["stitch", proj, os.path.join(work, "out"), "--gray",
                "--file-extension", "png", "--output-extension", "png",
                "--quiet"]
        if cli.main(argv + ["--mesh", "auto"]) != 0 or os.listdir(
                os.path.join(work, "out")) != ["stitching_result_1.png"]:
            raise AssertionError("(u7): --mesh auto did not stitch")
        try:
            cli.main(argv + ["--mesh", "2"])
            code_u7 = 0
        except SystemExit as e:
            code_u7, msg_u7 = e.code, str(e)
        if code_u7 in (0, None):
            raise AssertionError("(u7): --mesh 2 on one card exited 0")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"mesh (u): 4 shards on one card ({smi}; shards share the card: "
          f"no scaling measurement); (u1) feature_incre {rep_u1.num_ok}/"
          f"{rep_u1.num_pairs} pairs == (a) single-device and the sharded "
          f"plain run, records and panorama, launches {launch_u1} (K1 and "
          f"K2 12 against (a)'s 11: the 12th is the 11th frame repeated to "
          f"fill the 4 shards, its records never read), warm wall "
          f"{walls_u['(u1) feature_incre sharded']:.3f} s; (u2) feature "
          f"{rep_u2.num_ok}/{rep_u2.num_pairs} pairs == (d) single-device, "
          f"launches {launch_u2}, warm wall "
          f"{walls_u['(u2) feature sharded']:.3f} s; (u3) compose_sharded of "
          f"(a)'s offsets == compose in all 8 gray modes, device ms "
          f"(events, sharded/compose) "
          + ", ".join(f"{k} {a:.2f}/{b:.2f}" for k, (a, b) in ms_u3.items())
          + f", {stats_u3['fuse_psums']} psums of "
          f"{stats_u3['psum_payload_bytes']} B a panorama; (u4) sharded "
          f"solve card == CPU bit for bit: (s)'s graph {ms_u4[0]:.1f} ms, "
          f"1,000 tiles x 400 steps {ms_u4[1]:.1f} ms (events); (u5) stretch "
          + "; ".join(f"{r.n_tiles} x {r.tile_shape} tiles: "
                      f"{r.registered_ok} registered, {r.loop_edges} loop "
                      f"edges, RMSE chain {r.chain_rmse_px} -> solved "
                      f"{r.solved_rmse_px} px, s register {r.register_s} "
                      f"verify {r.verify_s} solve {r.solve_s} compose "
                      f"{r.compose_s}, canvas {r.canvas_shape}"
                      for r in st_u5)
          + "; (u6) compose_bench fps single/sharded "
          + ", ".join(f"{r.n_devices} shards {r.single_fps}/{r.sharded_fps}"
                      for r in cb_u6)
          + "; scaling (phase) fps "
          + ", ".join(f"{p.n_devices} shards {p.frames_per_s}"
                      for p in sc_u6.points)
          + f"; (u7) --mesh auto stitched, --mesh 2 exited with "
          f"{msg_u7!r}; {time.perf_counter() - t_u:.1f} s in all")

    # ---- 14. path (v): (i)'s whole-frame phase registration with each
    # pair's FFT split over 4 shards of the one card (parallel/tp_fft.py):
    # a budget under the ~0.97 GB a pair's padded surfaces take forces it
    from imagestitch_tpu_torch.parallel import mesh as pmesh
    cfg_v = base.replace(registration="phase", phase_hbm_budget=256 << 20)
    treg.register_sequence_phase_whole(pgray[:2], cfg_v, mesh=mesh4)
    torch.cuda.synchronize()
    zero_counts()
    pmesh.reset_collectives()
    t0 = time.perf_counter()
    recs_v = Stitcher(cfg_v, mesh=mesh4).register(pgray)
    torch.cuda.synchronize()
    wall_v = time.perf_counter() - t0
    read_counts("(v) phase tp_fft", no_kernel)
    coll_v = dict(pmesh.COLLECTIVES)
    n_pairs = len(recs_v)
    if (coll_v["all_to_all"], coll_v["all_gather"], coll_v["psum"]) != (
            3 * n_pairs, 2 * n_pairs, n_pairs):
        raise AssertionError(f"(v): collectives {coll_v}")
    sub_v, resp_v = hold("(v) phase tp_fft", recs_v, records_i, "(i)", 5e-3)
    if resp_v > 1e-3:
        raise AssertionError(f"(v): confidence {resp_v} from (i)'s")
    print(f"phase (v): {n_pairs} pairs of {tuple(pgray.shape[1:])} frames, "
          f"each FFT split over 4 shards of one card ({smi}); integer "
          f"records == (i)'s, sub-pixel within {sub_v:.3g} px, confidence "
          f"within {resp_v:.3g}; wall {wall_v:.3f} s; collectives "
          + ", ".join(f"{k} {v}" for k, v in coll_v.items()))

    # ---- 9. the score-map pool's device time a frame, by stage (path
    # (b)'s pool).  Last: after torch.profiler has traced the card, every
    # later CUDA call of this process runs slower (the paths' walls of
    # phases 5 and 6 rose by up to 40% when this ran before them)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import torch_pool_split
    pool_b = lambda: freg.pool_features(
        gray[:10], dparams, sp_or, max_pool=FeatureConfig().pool_keypoints)
    pool_b()
    wall = sorted(timed(torch, pool_b)[2] for _ in range(5))[2]
    device_ms, split = torch_pool_split.device_split(pool_b, 10)
    print("pool split ((b)'s oriented score-map pool, 10 frames, "
          "torch.profiler): device ms a frame " + ", ".join(
              f"{k} {v:.4f}" for k, v in split.items())
          + f"; device {device_ms:.2f} ms, host wall {wall:.2f} ms (median "
          f"of 5, unprofiled), busy share {device_ms / wall:.3f}")

    for r in records:
        r["launches"] = total[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} was not launched by the paths")
    print(f"smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
