"""imagestitch_tpu_torch — the PyTorch/CUDA port of imagestitch_tpu.

Registration by all five strategies of the JAX package (pooled
``feature_incre`` with its oriented fallback, whole-image ``feature``,
incremental and whole-image phase correlation, and ``hybrid``; upright or
oriented SURF or SIFT over the fused or the score-map pool, box-filter
SURF and ORB over the XLA detector; host replay of the reference's scale
x direction search), on the card unless the caller asks for the CPU; the
global pose-graph solver with loop closure (``solver/``); composition in
every fusion mode of the JAX package, in
color (the default) or gray (multiband and the optimal seam: gray only),
on the device or, with ``stream_output``, on the host in float64;
pipelined file ingest, registration checkpoints,
``Stitcher.stitch_project_set`` and the CLI (``python -m
imagestitch_tpu_torch.cli stitch ...``); the same Stitcher over a device
mesh (``parallel/``: frame-sharded registration, the sharded canvas, the
edge-sharded solve, the multi-process runtime), in PyTorch, with hand-written
CUDA kernels for Hopper (``csrc/``) where the JAX package runs Pallas
kernels, and the shared C++ host runtime (``native/``) where it runs
that.  Imports torch only — never jax or the JAX package.
"""
from .config import (EnhanceConfig, FeatureConfig, StitchConfig,
                     direction_increase)
from .core import registration
from .core.compose import compose, compute_placement
from .core.stitcher import Stitcher, StitchResult
from .core.stream_out import (compose_color_host, compose_host,
                              compose_host_positions, compose_streamed)
from .io.dataset import ImageBatch, load_batch

__version__ = "0.1.0"

# the JAX package's exports, in its order
__all__ = [
    "StitchConfig", "FeatureConfig", "EnhanceConfig", "direction_increase",
    "Stitcher", "StitchResult", "compose", "compute_placement",
    "compose_streamed", "compose_color_host", "compose_host",
    "compose_host_positions", "registration",
]
