#!/usr/bin/env python3
"""Time host-to-card copies of a project's frames.

    python3 tools/torch_upload_rate.py [--reps 5]

needs a CUDA card.  For a 1.34 GB color batch (89 x 1936 x 2584 x 3
uint8, the dendritic grid's frames) and its 0.45 GB gray batch, it times:

- ``pageable``: ``torch.from_numpy(host).to("cuda")`` (the Stitcher's
  route before the staging ring);
- ``pinned_whole``: a page-locked buffer of the whole batch, made once,
  filled from the host array with ``copy_``, then one non-blocking copy
  to the card (``fill_ms`` the fill alone, ``dma_ms`` the copy alone by
  CUDA events, ``dma_GB_per_s`` the link's rate from page-locked memory);
- ``staged_<n>MBx<k>``: ``device.StagingRing`` of k blocks of n MB (four
  of 4, 16 and 64 MB, two of 64 MB; made and warmed once): ``return_ms``
  until the call returns, and the time until the card has the batch;
- ``fill_<n>MB``: ``copy_`` of one block's worth of the host array into a
  page-locked block, the ring's host step alone.

Each entry gives the median of ``--reps`` runs after one warm-up:
``host_ms`` from the call until the card holds the batch (the stream
synchronised) and ``GB_per_s`` from it.  Prints one JSON line with the
card's name and power limit, torch's CPU threads and the host's cores.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SHAPES = {"color_1.34GB": (89, 1936, 2584, 3),
          "gray_0.45GB": (89, 1936, 2584)}
RINGS = ((4, 4), (16, 4), (64, 4), (64, 2))       # (MB a block, blocks)


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _median_ms(torch, fn, reps):
    """Medians over ``reps`` runs (after one warm-up) of the host ms from
    calling ``fn`` until the card is idle, and of any ms ``fn`` returns
    in a dict."""
    runs = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extra = fn() or {}
        torch.cuda.synchronize()
        runs.append(dict(extra, host_ms=(time.perf_counter() - t0) * 1e3))
    return {k: statistics.median(r[k] for r in runs[1:]) for k in runs[0]}


def measure(reps: int) -> dict:
    import torch
    from imagestitch_tpu_torch import device
    if not torch.cuda.is_available():
        raise SystemExit("torch_upload_rate: needs a CUDA card")
    out = {"device": torch.cuda.get_device_name(0),
           "power_limit": _power_limit(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "threads": torch.get_num_threads(),
           "cpus": os.cpu_count(), "reps": reps, "sizes": {}}
    for label, shape in SHAPES.items():
        host = torch.randint(0, 256, shape, dtype=torch.uint8,
                             device="cuda").cpu()
        nbytes = host.numel()
        flat = host.view(-1)
        entry = {"bytes": nbytes}

        def pageable():
            host.to("cuda")

        whole = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

        def pinned_whole():
            t0 = time.perf_counter()
            whole.copy_(flat)
            fill = (time.perf_counter() - t0) * 1e3
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst = whole.to("cuda", non_blocking=True)
            end.record()
            end.synchronize()
            assert dst.numel() == nbytes
            return {"fill_ms": fill, "dma_ms": start.elapsed_time(end)}

        entry["pageable"] = _median_ms(torch, pageable, reps)
        entry["pinned_whole"] = _median_ms(torch, pinned_whole, reps)
        entry["pinned_whole"]["dma_GB_per_s"] = \
            nbytes / entry["pinned_whole"]["dma_ms"] / 1e6
        del whole
        for mb, blocks in RINGS:
            ring = device.StagingRing("cuda", block_bytes=mb << 20,
                                      blocks=blocks)

            def staged():
                t0 = time.perf_counter()
                ring.upload(host)
                return {"return_ms": (time.perf_counter() - t0) * 1e3}

            entry[f"staged_{mb}MBx{blocks}"] = _median_ms(torch, staged, reps)
            got = ring.upload(host)
            assert torch.equal(got.cpu(), host)
            block = ring.blocks[0]
            piece = flat[:mb << 20]

            def fill():
                block[:piece.numel()].copy_(piece)

            entry[f"fill_{mb}MB"] = _median_ms(torch, fill, reps)
            entry[f"fill_{mb}MB"]["GB_per_s"] = \
                piece.numel() / entry[f"fill_{mb}MB"]["host_ms"] / 1e6
            del ring, block, got
        for name, r in entry.items():
            if isinstance(r, dict) and "GB_per_s" not in r:
                r["GB_per_s"] = nbytes / r["host_ms"] / 1e6
        out["sizes"][label] = entry
        del host, flat
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    print(json.dumps(measure(ap.parse_args().reps)))


if __name__ == "__main__":
    main()
