"""The port's registrars and ingest take the card by default and keep the
JAX package's signatures and exports.

- Every registrar, ``phase_correlate_batch`` and the three pipelined
  ingest functions, given numpy frames and no ``device``, raise without
  CUDA, naming ``device='cpu'``; a tensor stays where it lies.
- The ingest functions take the JAX parameters in the JAX places, with
  ``device`` keyword-only, and ``Stitcher.stitch_files`` passes it by
  keyword.
- ``imagestitch_tpu_torch.__all__`` is the JAX package's, in its order,
  ``compose_host_positions`` included, and both have the solver modules."""
import inspect

import numpy as np
import pytest
import torch

import imagestitch_tpu
import imagestitch_tpu_torch
from imagestitch_tpu.io import prefetch as jprefetch
from imagestitch_tpu_torch import StitchConfig, Stitcher
from imagestitch_tpu_torch.core import feature_registration as tfr
from imagestitch_tpu_torch.core import registration as treg
from imagestitch_tpu_torch.io import codec, prefetch
from imagestitch_tpu_torch.ops import phase_corr as tpc
from test_torch_device import no_cuda  # noqa: F401 (a fixture)
from test_torch_jax_chain import two_threads

INGEST = ("pooled_features_pipelined", "load_batch_pipelined",
          "register_sequence_pipelined")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _frames(n=3, h=48, w=64):
    return np.random.default_rng(0).integers(0, 255, (n, h, w), np.uint8)


def _cfg(registration):
    return StitchConfig(registration=registration, direction=1,
                        direct_incre=1, roi_ratio=0.2, color_mode=False)


def test_registrars_without_device_need_cuda(no_cuda):
    frames = _frames()
    calls = [
        (treg.register_sequence_phase, "phase_incre"),
        (treg.register_sequence_phase_whole, "phase"),
        (treg.register_sequence_hybrid, "hybrid"),
        (treg.register_sequence_features_incre, "feature_incre"),
        (treg.register_sequence_features, "feature"),
        (tfr.register_sequence_features_incre, "feature_incre"),
        (tfr.register_sequence_features, "feature"),
    ]
    for fn, registration in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(frames, _cfg(registration))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpc.phase_correlate_batch(frames[:1], frames[1:2])


def test_tensors_stay_where_they_lie(no_cuda):
    """A CPU tensor with no ``device`` registers on the CPU (no raise), as
    numpy frames do with ``device="cpu"``."""
    frames = _frames()
    cfg = _cfg("phase_incre")
    got = treg.register_sequence_phase(torch.as_tensor(frames), cfg)
    assert got == treg.register_sequence_phase(frames, cfg, device="cpu")
    a = torch.as_tensor(frames[:2], dtype=torch.float32)
    out = tpc.phase_correlate_batch(a, a)
    ref = tpc.phase_correlate_batch(frames[:2], frames[:2], device="cpu")
    for g, r in zip(out, ref):
        np.testing.assert_array_equal(g, r)


def test_stitcher_registers_on_its_device(monkeypatch):
    """``Stitcher.register`` moves a tensor that lies elsewhere to the
    Stitcher's device before its registrar sees it (the registrars leave a
    tensor where it lies).  The meta device stands in for the card."""
    registrars = {"phase_incre": "register_sequence_phase",
                  "phase": "register_sequence_phase_whole",
                  "feature_incre": "register_sequence_features_incre",
                  "feature": "register_sequence_features",
                  "hybrid": "register_sequence_hybrid"}
    seen = {}

    def recorder(registration):
        def registrar(images, cfg, device):
            seen[registration] = (images.device, device)
            return []
        return registrar

    meta = torch.device("meta")
    for registration, name in registrars.items():
        monkeypatch.setattr(treg, name, recorder(registration))
        Stitcher(_cfg(registration), device="meta").register(
            torch.as_tensor(_frames()))
    assert seen == dict.fromkeys(registrars, (meta, meta))


def _write(tmp_path, frames):
    files = [str(tmp_path / f"t{i:02d}.png") for i in range(len(frames))]
    for f, im in zip(files, frames):
        codec.imwrite(f, im)
    return files


def test_ingest_without_device_needs_cuda(no_cuda, tmp_path):
    frames = _frames()
    files = _write(tmp_path, frames)
    cfg = _cfg("feature_incre")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prefetch.pooled_features_pipelined(files, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prefetch.register_sequence_pipelined(files, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prefetch.load_batch_pipelined(files, False)
    # to_device=False, as in the JAX package: the gray batch stays on the
    # host, and no device is asked for
    batch = prefetch.load_batch_pipelined(files, False, False, 2)
    assert isinstance(batch.gray, np.ndarray)
    np.testing.assert_array_equal(batch.gray, frames)
    on_cpu = prefetch.load_batch_pipelined(files, False, True, 2,
                                           device="cpu")
    np.testing.assert_array_equal(on_cpu.gray.numpy(), frames)


@pytest.mark.parametrize("name", INGEST)
def test_ingest_signatures_are_the_jax_ones(name):
    """Positional parameters by name, order and default as in the JAX
    package; ``device`` is keyword-only and defaults to the card."""
    ours = inspect.signature(getattr(prefetch, name)).parameters
    jax = inspect.signature(getattr(jprefetch, name)).parameters
    positional = [(p.name, p.default) for p in ours.values()
                  if p.kind is p.POSITIONAL_OR_KEYWORD]
    assert positional == [(p.name, p.default) for p in jax.values()]
    assert ours["device"].kind is inspect.Parameter.KEYWORD_ONLY
    assert ours["device"].default == "cuda"


@pytest.mark.parametrize("color_mode", [False, True])
def test_stitch_files_passes_the_device_by_keyword(monkeypatch, color_mode):
    seen = {}

    def record(name, result):
        def fn(*args, **kwargs):
            seen[name] = (args, kwargs)
            return result
        return fn

    frames = _frames(1)
    monkeypatch.setattr(prefetch, "register_sequence_pipelined", record(
        "register", ([], torch.as_tensor(frames), None)))
    monkeypatch.setattr(prefetch, "load_batch_pipelined", record(
        "load", prefetch.dataset.ImageBatch(
            gray=frames, color=np.stack([frames[0]] * 3, -1)[None],
            files=["f0"])))
    cfg = _cfg("feature_incre").replace(color_mode=color_mode)
    Stitcher(cfg, device="cpu").stitch_files(["f0"])
    (name, (args, kwargs)), = seen.items()
    assert name == ("load" if color_mode else "register")
    assert kwargs["device"] == torch.device("cpu")
    assert all(not isinstance(a, torch.device) for a in args)


def test_exports_are_the_jax_package_ones():
    want = list(imagestitch_tpu.__all__)
    assert imagestitch_tpu_torch.__all__ == want
    import imagestitch_tpu.solver.loop_closure as jlc
    import imagestitch_tpu.solver.pose_graph as jpg
    from imagestitch_tpu_torch.solver import loop_closure, pose_graph
    for jmod, tmod in ((jpg, pose_graph), (jlc, loop_closure)):
        for name in ("PoseGraph", "solve", "sharded_solve_fn",
                     "chain_positions", "propose_edges", "verify_edges",
                     "close_loops"):
            assert hasattr(tmod, name) == hasattr(jmod, name), name
    for name in want:
        assert hasattr(imagestitch_tpu_torch, name), name
    assert imagestitch_tpu_torch.__version__ == imagestitch_tpu.__version__
    assert imagestitch_tpu_torch.registration is treg
    assert imagestitch_tpu_torch.direction_increase(4, 1) == 1
    assert imagestitch_tpu_torch.compute_placement(
        [(10, 0)], (20, 30)).canvas_shape == (30, 30)
