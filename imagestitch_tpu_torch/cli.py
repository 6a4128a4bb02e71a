"""Command-line driver of the PyTorch/CUDA port.

Port of ``imagestitch_tpu/cli.py``: the same ``stitch`` subcommand with the
same arguments, defaults and configuration (color composition unless
``--gray``), with ``--device`` in place of the JAX package's
``--platform``.  ``--mesh N`` drives the first N cards as one mesh (JAX
cli.py:81-82, :149-156; ``auto``: every card), or N CPU shards with
``--device cpu``; asking for more cards than there are exits non-zero.

  python -m imagestitch_tpu_torch.cli stitch demoImages/dendriticCrystal \\
      out/dc --registration feature_incre --direction 1 --direct-incre 1
"""
from __future__ import annotations

import argparse
import sys

import torch

from .config import EnhanceConfig, FeatureConfig, StitchConfig
from .core.stitcher import Stitcher


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="imagestitch_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("stitch", help="stitch project sub-directories")
    s.add_argument("project", help="project directory (contains 1/, 2/, ...)")
    s.add_argument("output", help="output directory")
    s.add_argument("--file-num", type=int, default=1,
                   help="number of numbered sub-projects")
    s.add_argument("--start-num", type=int, default=1)
    s.add_argument("--file-extension", default="jpg")
    s.add_argument("--output-extension", default="jpg")
    s.add_argument("--registration", default="feature_incre",
                   choices=["feature_incre", "feature", "phase_incre", "phase",
                            "hybrid"])
    s.add_argument("--feature-method", default="surf",
                   choices=["surf", "sift", "orb"])
    s.add_argument("--offset-calculate", default="mode",
                   choices=["mode", "ransac", "ransac_translation"])
    s.add_argument("--offset-evaluate", type=int, default=3)
    s.add_argument("--roi-ratio", type=float, default=0.2)
    s.add_argument("--search-ratio", type=float, default=0.75)
    s.add_argument("--direction", type=int, default=1, choices=[1, 2, 3, 4])
    s.add_argument("--direct-incre", type=int, default=1, choices=[-1, 0, 1])
    s.add_argument("--fuse-method", default="fadeInAndFadeOut",
                   choices=["notFuse", "average", "maximum", "minimum",
                            "fadeInAndFadeOut", "trigonometric",
                            "multiBandBlending", "optimalSeamLine"])
    s.add_argument("--gray", action="store_true",
                   help="compose grayscale (default: color)")
    s.add_argument("--enhance", action="store_true")
    s.add_argument("--clahe", action="store_true")
    s.add_argument("--clip-limit", type=float, default=20.0)
    s.add_argument("--tile-size", type=int, default=5)
    s.add_argument("--max-keypoints", type=int, default=1024)
    s.add_argument("--hessian-threshold", type=float, default=10.0)
    s.add_argument("--box-filter", action="store_true",
                   help="use the reference's integral-image SURF box-filter "
                        "response instead of Gaussian-derivative DoH")
    s.add_argument("--upright", action="store_true",
                   help="skip descriptor orientation (surfIsUpright)")
    s.add_argument("--phase-response-threshold", type=float, default=0.15)
    s.add_argument("--evaluate", action="store_true",
                   help="append per-pair log lines to the evaluate file "
                        "(reference printAndWrite sink)")
    s.add_argument("--evaluate-file", default="evaluate.txt")
    s.add_argument("--stream-output", action="store_true",
                   help="compose color on the host in float64 (no color "
                        "bytes cross the link); gray on the host in float64 "
                        "or, without the C++ runtime, on the device with a "
                        "rect-only readback")
    s.add_argument("--use-solver", action="store_true",
                   help="refine the offset chain with the global pose-graph "
                        "solver before composition")
    s.add_argument("--report", help="write per-pair JSON report here")
    s.add_argument("--quiet", action="store_true")
    s.add_argument("--mesh", default=None,
                   help="shard count of the device mesh ('auto' = "
                        "every visible card): frame-sharded registration "
                        "and sharded-canvas composition; with --device cpu, "
                        "that many CPU shards")
    s.add_argument("--device", default="cuda",
                   help="torch device that registers and composes "
                        "(default: cuda, which raises without CUDA; "
                        "--device cpu runs on the CPU)")
    return p


def config_from_args(args) -> StitchConfig:
    return StitchConfig(
        registration=args.registration,
        offset_calculate=args.offset_calculate,
        offset_evaluate=args.offset_evaluate,
        roi_ratio=args.roi_ratio,
        phase_response_threshold=args.phase_response_threshold,
        direction=args.direction,
        direct_incre=args.direct_incre,
        color_mode=not args.gray,
        fuse_method=args.fuse_method,
        use_global_solver=args.use_solver,
        stream_output=args.stream_output,
        features=FeatureConfig(method=args.feature_method,
                               max_keypoints=args.max_keypoints,
                               search_ratio=args.search_ratio,
                               hessian_threshold=args.hessian_threshold,
                               box_filter=args.box_filter,
                               upright=args.upright),
        enhance=EnhanceConfig(enabled=args.enhance, use_clahe=args.clahe,
                              clip_limit=args.clip_limit,
                              tile_size=args.tile_size),
        print_log=not args.quiet,
        evaluate=args.evaluate,
        evaluate_file=args.evaluate_file,
        output_address=args.output,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command != "stitch":
        return 1
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch.cuda.is_available() "
                         f"is False; pass --device cpu to run on the CPU")
    mesh = None
    if args.mesh:
        from .parallel.mesh import make_mesh
        n = torch.cuda.device_count() if args.mesh == "auto" else \
            int(args.mesh)
        try:
            mesh = make_mesh(n, axis="frames", devices=[device] * n
                             if device.type == "cpu" else None)
        except RuntimeError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}")
    st = Stitcher(config_from_args(args), mesh=mesh, device=device)
    written = st.stitch_project_set(
        args.project, args.output, args.file_num, start_num=args.start_num,
        file_extension=args.file_extension,
        output_extension=args.output_extension)
    if not args.quiet:
        for w in written:
            print(f"wrote {w}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
