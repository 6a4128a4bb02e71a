"""Port config against the JAX package: the same fields (``use_pallas``
under its own name) plus the port's own ``use_kernels``, and
config_from_jax.  The constant tables are in test_torch_tables.py."""
import dataclasses

import pytest

from imagestitch_tpu import config as jconfig

from imagestitch_tpu_torch import config as tconfig
from imagestitch_tpu_torch.convert import config_from_jax

#: fields of the port that the JAX package does not have
PORT_ONLY = {"StitchConfig": ["use_kernels"]}


def _fields(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)
            if f.default is not dataclasses.MISSING}


@pytest.mark.parametrize("name", ["StitchConfig", "FeatureConfig",
                                  "EnhanceConfig"])
def test_field_sets_differ_only_by_rename(name):
    jf = _fields(getattr(jconfig, name))
    tf = _fields(getattr(tconfig, name))
    own = PORT_ONLY.get(name, [])
    assert {k: v for k, v in tf.items() if k not in own} == jf
    assert tf.get("use_kernels", True) is True
    assert [f.name for f in dataclasses.fields(getattr(tconfig, name))
            if f.name not in own] == \
        [f.name for f in dataclasses.fields(getattr(jconfig, name))]


def test_helpers_match():
    for d in (1, 2, 3, 4):
        for inc in (-1, 0, 1):
            assert tconfig.direction_increase(d, inc) == \
                jconfig.direction_increase(d, inc)
    for r in (0.05, 0.1, 0.2, 0.25, 0.5):
        assert tconfig.max_roi_scale(r) == jconfig.max_roi_scale(r)
    with pytest.raises(ValueError):
        tconfig.StitchConfig(registration="nope")


@pytest.mark.parametrize("as_dict", [False, True])
def test_config_from_jax(as_dict):
    jcfg = jconfig.StitchConfig(
        registration="feature_incre", direction=2, direct_incre=-1,
        roi_ratio=0.2, color_mode=False, use_pallas=False,
        features=jconfig.FeatureConfig(upright=True, max_keypoints=256,
                                       hessian_threshold=12.5),
        enhance=jconfig.EnhanceConfig(clip_limit=7.0))
    src = dataclasses.asdict(jcfg) if as_dict else jcfg
    cfg = config_from_jax(src)
    assert isinstance(cfg, tconfig.StitchConfig)
    assert cfg.use_pallas is False and cfg.use_kernels is True
    assert cfg.direction == 2 and cfg.direct_incre == -1
    assert cfg.features == tconfig.FeatureConfig(
        upright=True, max_keypoints=256, hessian_threshold=12.5)
    assert cfg.enhance == tconfig.EnhanceConfig(clip_limit=7.0)
    with pytest.raises(TypeError):
        config_from_jax({"no_such_field": 1})
