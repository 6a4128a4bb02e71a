"""Carry a JAX-package configuration across to the port.

The system has no learned weights: what a run of ``imagestitch_tpu`` and a
run of this package must share is the configuration and the constant tap
tables, and the tables are rebuilt from the configuration by the same numpy
code (``ops/features/detect._gauss_kernels``, ``ops/kernels/doh._scale_taps``,
``ops/features/describe._gauss_weight``).  ``config_from_jax`` takes the JAX
``StitchConfig`` (or its ``dataclasses.asdict`` form) without importing the
JAX package, so the port stays free of jax.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from .config import EnhanceConfig, FeatureConfig, StitchConfig

def _as_dict(obj: Any) -> dict:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if isinstance(obj, Mapping):
        return dict(obj)
    raise TypeError(f"expected a StitchConfig dataclass or a dict, got "
                    f"{type(obj).__name__}")


def config_from_jax(obj_or_dict: Any) -> StitchConfig:
    """JAX ``StitchConfig`` (or its dict form) -> port ``StitchConfig``.

    Every JAX field keeps its name (``use_pallas`` included); the port's own
    ``use_kernels`` keeps its default.  Unknown fields raise ``TypeError``
    rather than being dropped, so a field added to one package and not the
    other is caught at the first call.
    """
    d = _as_dict(obj_or_dict)
    if "features" in d:
        d["features"] = FeatureConfig(**_as_dict(d["features"]))
    if "enhance" in d:
        d["enhance"] = EnhanceConfig(**_as_dict(d["enhance"]))
    return StitchConfig(**d)
