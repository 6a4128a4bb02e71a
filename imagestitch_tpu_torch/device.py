"""The port's device policy: every entry point takes the card unless the
caller asks for the CPU, and none falls back to it.  Beside it, the
route of host frames to a card (``to_device``): chunk by chunk through a
small ring of page-locked blocks that lives as long as the process."""
import threading
from typing import Dict, Iterator, List

import torch

from .utils import profiling

#: bytes of one page-locked staging block, and the blocks in a card's
#: ring (128 MB locked).  tools/torch_upload_rate.py on an H100's 8-core
#: host: a 1.34 GB batch went up at 10.9-11.3, 12.8 and 16.9-20.0 GB/s
#: through four blocks of 4, 16 and 64 MB, and at 14.8 GB/s through two
#: of 64 MB (a 0.45 GB batch: 8.7-9.5, 12.8-12.9, 12.8-14.5 and 14.5).
#: A block's copy to the card (46 GB/s) takes a third of its fill, so a
#: second block already keeps the copies behind the host.
STAGE_BYTES = 64 << 20
STAGE_BLOCKS = 2


def resolve_device(device, caller: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises,
    naming ``device='cpu'`` (no entry point falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device={str(device)!r}): "
                           f"torch.cuda.is_available() is False; pass "
                           f"device='cpu' to run on the CPU")
    return device


def chunk_views(src: torch.Tensor,
                chunk: int) -> Iterator[List[torch.Tensor]]:
    """The elements of ``src`` (any strides) in C order, in chunks of
    ``chunk`` elements (the last one shorter): each chunk as the views of
    ``src`` that cover it, in order.  Nothing is copied."""
    n = src.numel()
    for a in range(0, n, chunk):
        yield _views(src, a, min(a + chunk, n))


def _views(t: torch.Tensor, a: int, b: int) -> List[torch.Tensor]:
    """Views of ``t`` that cover its C-order elements [a, b), in order:
    whole rows of the first dimension as one slice, partial rows by
    recursion into the row."""
    if t.dim() <= 1 or t.is_contiguous():
        return [t.reshape(-1)[a:b]]
    row = t[0].numel()
    i, out = a // row, []
    if a > i * row:                               # the first row, partly
        end = min(b, (i + 1) * row)
        out += _views(t[i], a - i * row, end - i * row)
        a, i = end, i + 1
    whole = (b - a) // row
    if whole:
        out.append(t[i:i + whole])
        a, i = a + whole * row, i + whole
    if a < b:                                     # the last row, partly
        out += _views(t[i], 0, b - a)
    return out


def fill(block: torch.Tensor, views: List[torch.Tensor]) -> int:
    """Copy ``views`` one after another into the front of ``block`` (a
    1-D tensor of their dtype); returns the elements written."""
    n = 0
    for v in views:
        block[n:n + v.numel()].view(v.shape).copy_(v)
        n += v.numel()
    return n


class StagingRing:
    """Host tensors to one card through ``blocks`` page-locked blocks of
    ``block_bytes`` each, locked as the first uploads reach them and reused
    by every later one.

    ``upload`` allocates the card's tensor on a side stream, then, chunk
    by chunk, waits until the next block's last copy has left it, fills
    the block from the host tensor with torch's threaded ``copy_`` and
    queues the block's copy to the card on the side stream.  So the fill
    of chunk i + 1 overlaps the copy of chunk i.  The current stream waits
    for the last copy and the host returns without waiting for it.  Where
    no block can be locked, the tensor goes up from pageable memory.
    Counts ``UPLOAD_CHUNKS``, ``UPLOAD_CHUNKS_REUSED`` (chunks through a
    block an earlier chunk had used) and ``UPLOAD_PAGEABLE``."""

    def __init__(self, device, block_bytes: int = STAGE_BYTES,
                 blocks: int = STAGE_BLOCKS):
        self.device = torch.device(device)
        self.block_bytes = block_bytes
        self.blocks: List[torch.Tensor] = []
        self._size = blocks
        self._events: List[torch.cuda.Event] = []
        self._next = self._used = 0
        self._stream = torch.cuda.Stream(self.device)
        self._lock = threading.Lock()

    def _block(self, k: int) -> bool:
        """Whether block ``k`` exists, locking it if it is the next one."""
        if k < len(self.blocks):
            return True
        try:
            block = torch.empty(self.block_bytes, dtype=torch.uint8,
                                pin_memory=True)
        except RuntimeError:
            return False
        self.blocks.append(block)
        self._events.append(torch.cuda.Event())
        return True

    def upload(self, src: torch.Tensor) -> torch.Tensor:
        """``src``, a CPU tensor, as a new tensor on the ring's card."""
        with self._lock:
            if not self._block(0):
                profiling.count("UPLOAD_PAGEABLE")
                return src.to(self.device)
            main = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._stream):
                dst = torch.empty(src.shape, dtype=src.dtype,
                                  device=self.device)
                flat = dst.view(-1)
                a = last = 0
                chunk = self.block_bytes // src.element_size()
                for views in chunk_views(src, chunk):
                    k = self._next
                    if not self._block(k):        # the ring stays smaller
                        k, self._size = 0, len(self.blocks)
                    reused = k < self._used
                    self._used = max(self._used, k + 1)
                    self._next, last = (k + 1) % self._size, k
                    self._events[k].synchronize()
                    block = self.blocks[k].view(src.dtype)
                    n = fill(block, views)
                    flat[a:a + n].copy_(block[:n], non_blocking=True)
                    self._events[k].record(self._stream)
                    a += n
                    profiling.count("UPLOAD_CHUNKS")
                    if reused:
                        profiling.count("UPLOAD_CHUNKS_REUSED")
            main.wait_event(self._events[last])
            dst.record_stream(main)
            return dst


_RINGS: Dict[int, StagingRing] = {}
_RINGS_LOCK = threading.Lock()


def to_device(x, device) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) on ``device``.  A host array or
    CPU tensor bound for a card goes through that card's ``StagingRing``,
    made at the first such upload; the card's tensor is ready for work
    queued on the current stream, and the host may change ``x`` at once.
    Everything else moves as ``torch.as_tensor(x).to(device)``."""
    device = torch.device(device)
    t = torch.as_tensor(x)
    if device.type != "cuda" or t.device.type != "cpu" or t.numel() == 0:
        return t.to(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    with _RINGS_LOCK:
        ring = _RINGS.get(index)
        if ring is None:
            ring = _RINGS[index] = StagingRing(torch.device("cuda", index))
    return ring.upload(t)
