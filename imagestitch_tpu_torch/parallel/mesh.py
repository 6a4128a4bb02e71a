"""A 1-D device mesh driven from one process, and its collectives.

Port of ``imagestitch_tpu/parallel/mesh.py`` (:21-39).  The JAX package
drives every device of a ``jax.sharding.Mesh`` from one process through
``shard_map``; here a ``Mesh`` is a list of ``torch.device``s, a sharded
batch is a list of per-shard tensors (shard i on ``mesh.devices[i]``), and
a collective is a plain function over that list:
  * ``ppermute`` sends each shard's tensor to its predecessor (the
    explicit halo of the frame-sharded registration: shard i receives
    shard i + 1's, the last shard shard 0's, as JAX's ring
    ``[(i, (i - 1) % d)]``);
  * ``psum`` sums in shard order on shard 0's device and copies the sum
    back to every shard.  The order is fixed, so the card and the CPU sum
    alike;
  * ``all_gather`` concatenates the shards on shard 0's device (the
    sharded outputs JAX reads back);
  * ``all_to_all`` is JAX's tiled ``lax.all_to_all``: shard i's j-th
    chunk along ``split_dim`` goes to shard j, which concatenates the
    chunks it receives in shard order along ``concat_dim`` (the transpose
    of the tensor-parallel FFT, ``parallel/tp_fft.py``).
Each call adds to ``COLLECTIVES``: its calls and the bytes each payload
holds.

The axes of the JAX package (``pairs``, ``edges``, ``blocks``, ``frames``)
are names of the same data-parallel axis at different stages.  A mesh may
repeat a device: the JAX tests force 8 host devices, and ``["cpu"] * 8``
is their counterpart; ``["cuda:0"] * 4`` runs four shards on one card,
which checks the decomposition (halo, block rows, reduction order) and
says nothing of speed.  Multi-process runs go through
``parallel/distributed.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

#: calls and payload bytes of every collective since the last reset
COLLECTIVES: Dict[str, int] = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()
    for op in ("psum", "ppermute", "all_gather", "all_to_all"):
        COLLECTIVES[op] = 0
        COLLECTIVES[f"{op}_bytes"] = 0


reset_collectives()


def _flat(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        else:
            yield from _flat(x)


def _count(op: str, xs) -> None:
    COLLECTIVES[op] += 1
    COLLECTIVES[f"{op}_bytes"] += sum(t.numel() * t.element_size()
                                      for t in _flat(xs))


def _to(x, dev):
    """A tensor, or a tuple or list of them, on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return type(x)(_to(t, dev) for t in x)


class Mesh:
    """A 1-D mesh: ``devices`` (torch.device, repeats allowed) along one
    axis named ``axis_names[0]``."""

    def __init__(self, devices: Sequence, axis_names=("dp",)):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names})")


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: all of
    them), or, with no ``devices``, over the first ``n_devices`` CUDA cards
    (default: every card).  Asking for more than there are raises: JAX's
    ``jax.devices()[:n]`` quietly gives fewer, and a missing card must not
    pass unseen."""
    if devices is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n < 1 or n > count:
            raise RuntimeError(f"make_mesh({n_devices}): {count} CUDA "
                               f"device(s) visible; pass devices=[...] for "
                               f"a mesh of CPU shards")
        return Mesh([torch.device("cuda", i) for i in range(n)], (axis,))
    devices = list(devices)
    n = len(devices) if n_devices is None else n_devices
    if n < 1 or n > len(devices):
        raise RuntimeError(f"make_mesh({n_devices}): {len(devices)} "
                           f"device(s) given")
    return Mesh(devices[:n], (axis,))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard(x, mesh: Mesh) -> List[torch.Tensor]:
    """Split the leading axis of ``x`` (numpy or tensor) into ``mesh.size``
    equal blocks, block i on ``mesh.devices[i]``."""
    x = torch.as_tensor(x)
    if x.shape[0] % mesh.size:
        raise ValueError(f"shard: {x.shape[0]} rows do not split into "
                         f"{mesh.size} equal blocks")
    per = x.shape[0] // mesh.size
    return [x[i * per:(i + 1) * per].to(dev)
            for i, dev in enumerate(mesh.devices)]


def replicate(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``x`` on every shard's device (a no-op where it lies already)."""
    return [x.to(dev) for dev in mesh.devices]


def ppermute(xs: Sequence, mesh: Mesh) -> list:
    """Shard i receives shard (i + 1) % d's tensor (or tuple of tensors, in
    one collective).  On a one-shard mesh the shard keeps its own, and
    nothing moves."""
    if mesh.size == 1:
        return list(xs)
    _count("ppermute", xs)
    d = mesh.size
    return [_to(xs[(i + 1) % d], dev) for i, dev in enumerate(mesh.devices)]


def psum(xs: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The sum of the shards' tensors, ((x0 + x1) + x2) + ..., on shard
    0's device, copied back to every shard."""
    _count("psum", xs[:1])
    total = xs[0].to(mesh.devices[0])
    for x in xs[1:]:
        total = total + x.to(total.device)
    return replicate(total, mesh)


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh, dim: int = 0
               ) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` on shard 0's
    device."""
    _count("all_gather", xs)
    return torch.cat([x.to(mesh.devices[0]) for x in xs], dim=dim)


def all_to_all(xs: Sequence[torch.Tensor], mesh: Mesh, split_dim: int,
               concat_dim: int) -> List[torch.Tensor]:
    """Tiled all-to-all: shard j receives chunk j (along ``split_dim``) of
    every shard's tensor, concatenated in shard order along
    ``concat_dim`` on its own device.  ``split_dim``'s size must divide by
    the shard count."""
    d = mesh.size
    if xs[0].shape[split_dim] % d:
        raise ValueError(f"all_to_all: size {xs[0].shape[split_dim]} of "
                         f"dim {split_dim} does not split into {d} chunks")
    _count("all_to_all", xs)
    chunks = [x.chunk(d, dim=split_dim) for x in xs]
    return [torch.cat([chunks[i][j].to(dev) for i in range(d)],
                      dim=concat_dim)
            for j, dev in enumerate(mesh.devices)]
