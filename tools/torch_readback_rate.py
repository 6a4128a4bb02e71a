#!/usr/bin/env python3
"""Time copies between the card and the host at a panorama's size.

    python3 tools/torch_readback_rate.py [--reps 10]

needs a CUDA card.  For a 1.13 GB buffer (a 25,600 x 14,700 x 3 uint8
panorama, the dendritic grid's) and a 144 MB one (the zircon line's), it
times the device-to-host copy three ways:

- ``pageable``: ``src.cpu()``, a fresh pageable array each time (what
  ``core/compose`` did before it read back into page-locked memory);
- ``pinned_fresh``: a fresh ``torch.empty(..., pin_memory=True)`` each
  time (the host allocator's cache emptied between runs where torch can:
  ``_host_emptyCache`` or ``_accelerator_emptyHostCache``), then a
  non-blocking ``copy_``;
- ``pinned_reused``: one page-locked buffer, written again each time;

and, for the upload that comes next, host-to-device from pageable and
from page-locked memory.  Each entry gives the medians of ``--reps`` runs:
device ms between CUDA events around the copy, host ms from before the
call to after the stream's synchronise, and GB/s from the device ms; for
``pinned_fresh`` also the host ms of the allocation alone; and, where
torch counts them, the page-locked blocks the host allocator made during
the entry's runs (``host_allocs``).  Prints one JSON line with the card's
name and power limit.
"""
import argparse
import json
import statistics
import subprocess
import time

SIZES = {"1.13GB": (25_600, 14_700, 3), "144MB": (4_000, 12_000, 3)}


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _host_allocs(torch):
    """Page-locked blocks the host allocator has made so far, where torch
    counts them (``torch.cuda.host_memory_stats``), else None."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return None if stats is None else stats().get("num_host_alloc")


def _time(torch, fn, reps):
    """Medians of ``reps`` calls of ``fn(start, end)``, which records the
    two CUDA events around its copy and returns the host ms of anything it
    times on its own (or None)."""
    dev_ms, host_ms, extra_ms = [], [], []
    for _ in range(reps + 1):                    # the first is a warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extra = fn(start, end)
        torch.cuda.current_stream().synchronize()
        host = (time.perf_counter() - t0) * 1e3
        dev_ms.append(start.elapsed_time(end))
        host_ms.append(host)
        extra_ms.append(extra)
    out = {"device_ms": statistics.median(dev_ms[1:]),
           "host_ms": statistics.median(host_ms[1:])}
    if extra_ms[1] is not None:
        out["alloc_ms"] = statistics.median(extra_ms[1:])
    return out


def measure(reps: int) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_readback_rate: needs a CUDA card")
    empty_host_cache = getattr(torch._C, "_host_emptyCache", None) or \
        getattr(torch._C, "_accelerator_emptyHostCache", None)
    out = {"device": torch.cuda.get_device_name(0),
           "power_limit": _power_limit(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "reps": reps, "sizes": {}}
    for label, shape in SIZES.items():
        nbytes = shape[0] * shape[1] * shape[2]
        src = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda")
        reused = torch.empty(shape, dtype=torch.uint8, pin_memory=True)

        def pageable(start, end):
            start.record()
            src.cpu()
            end.record()

        def pinned_fresh(start, end):
            if empty_host_cache is not None:
                empty_host_cache()
            t0 = time.perf_counter()
            buf = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            alloc = (time.perf_counter() - t0) * 1e3
            start.record()
            buf.copy_(src, non_blocking=True)
            end.record()
            return alloc

        def pinned_reused(start, end):
            start.record()
            reused.copy_(src, non_blocking=True)
            end.record()

        host_src = reused.numpy().copy()         # pageable, same bytes

        def htod_pageable(start, end):
            start.record()
            src.copy_(torch.from_numpy(host_src))
            end.record()

        def htod_pinned(start, end):
            start.record()
            src.copy_(reused, non_blocking=True)
            end.record()

        entry = {"bytes": nbytes}
        for name, fn in (("pageable", pageable),
                         ("pinned_fresh", pinned_fresh),
                         ("pinned_reused", pinned_reused),
                         ("htod_pageable", htod_pageable),
                         ("htod_pinned", htod_pinned)):
            allocs = _host_allocs(torch)
            r = _time(torch, fn, reps)
            if allocs is not None:
                r["host_allocs"] = _host_allocs(torch) - allocs
            r["GB_per_s"] = nbytes / r["device_ms"] / 1e6
            entry[name] = r
        assert torch.equal(torch.from_numpy(reused.numpy()), src.cpu())
        out["sizes"][label] = entry
        del src, reused, host_src
        if empty_host_cache is not None:
            empty_host_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    print(json.dumps(measure(ap.parse_args().reps)))


if __name__ == "__main__":
    main()
