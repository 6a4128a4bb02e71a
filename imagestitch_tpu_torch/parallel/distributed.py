"""The multi-process runtime.

Port of ``imagestitch_tpu/parallel/distributed.py`` (:1-85).  The JAX
package brings processes up with ``jax.distributed.initialize``; here
``torch.distributed`` carries only this module, as ``jax.distributed``
does there: NCCL where a process drives CUDA cards, gloo on the CPU.  Each
process drives its local mesh (``parallel.mesh``) from one thread; only
the small per-pair records cross between processes.

With no arguments ``initialize`` runs one process over its local mesh, so
the same code runs from one CPU to several hosts.
``parallel/multiproc_worker.py`` runs one process of such a bring-up.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh, make_mesh, shard


@dataclasses.dataclass
class RuntimeContext:
    mesh: Mesh                 # this process's local mesh
    process_index: int
    process_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, axis: str = "dp",
               devices: Optional[Sequence] = None) -> RuntimeContext:
    """Join the process group at ``coordinator_address`` (``tcp://host:
    port``, or ``host:port``, or ``file://path``) as process ``process_id``
    of ``num_processes``, and build the local mesh over ``devices``: by
    default every visible card for one process, and card ``process_id %
    count`` for each of several.  NCCL joins processes whose mesh is on
    CUDA cards, gloo those on the CPU.  Without an address: one process."""
    nproc = num_processes or 1
    if devices is None:
        count = torch.cuda.device_count()
        devices = None if nproc == 1 else \
            [torch.device("cuda", (process_id or 0) % max(count, 1))]
    mesh = make_mesh(axis=axis, devices=devices)
    if coordinator_address is None:
        if nproc > 1:
            raise ValueError("initialize: several processes need a "
                             "coordinator_address")
        return RuntimeContext(mesh=mesh, process_index=0, process_count=1)
    import torch.distributed as dist
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    backend = "nccl" if mesh.devices[0].type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=nproc, rank=process_id)
    return RuntimeContext(mesh=mesh, process_index=dist.get_rank(),
                          process_count=dist.get_world_size())


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def host_shard(files: Sequence[str], ctx: RuntimeContext,
               overlap: int = 1) -> List[str]:
    """The slice of a sequential dataset THIS process should decode.

    Pair registration needs ``overlap`` trailing neighbour frames, so that
    pair (k, k + 1) at a shard boundary needs no image from another
    process: only the small offset records travel."""
    n = len(files)
    per = -(-n // ctx.process_count)
    s = ctx.process_index * per
    e = min(n, s + per + overlap)
    return list(files[s:e])


def make_global_batch(local, ctx: RuntimeContext) -> List[torch.Tensor]:
    """This process's batch placed on its local mesh: the leading axis
    split into one equal block a shard (the counterpart of
    ``jax.make_array_from_process_local_data``)."""
    return shard(local, ctx.mesh)


def all_gather_records(values: np.ndarray, ctx: RuntimeContext
                       ) -> np.ndarray:
    """Every process's (k_i, ...) record rows, concatenated in process
    order on every process (``dist.all_gather``; the row counts may
    differ)."""
    if ctx.process_count == 1:
        return values
    import torch.distributed as dist
    dev = ctx.mesh.devices[0]
    local = torch.as_tensor(np.ascontiguousarray(values)).to(dev)
    count = torch.tensor([local.shape[0]], device=dev)
    counts = [torch.zeros_like(count) for _ in range(ctx.process_count)]
    dist.all_gather(counts, count)
    n_max = max(int(c) for c in counts)
    pad = torch.zeros((n_max,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=dev)
    pad[:local.shape[0]] = local
    parts = [torch.empty_like(pad) for _ in range(ctx.process_count)]
    dist.all_gather(parts, pad)
    return torch.cat([p[:int(c)] for p, c in zip(parts, counts)]
                     ).cpu().numpy()
