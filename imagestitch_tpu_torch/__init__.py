"""imagestitch_tpu_torch — the PyTorch/CUDA port of imagestitch_tpu.

Feature registration (pooled ``feature_incre`` with its oriented fallback,
and whole-image ``feature``; upright or oriented SURF over the fused or the
score-map pool; host replay of the reference's scale x direction search)
and fade composition on gray frames, in PyTorch, with hand-written CUDA
kernels for Hopper (``csrc/``) where the JAX package runs Pallas kernels.
Imports torch only — never jax or the JAX package.
"""
from .config import EnhanceConfig, FeatureConfig, StitchConfig
from .core.compose import compose
from .core.stitcher import Stitcher, StitchResult

__all__ = ["StitchConfig", "FeatureConfig", "EnhanceConfig", "Stitcher",
           "StitchResult", "compose"]
