"""Registration checkpoint / resume.

Port of ``imagestitch_tpu/core/checkpoint.py``: the per-pair records of a
registered sequence as JSON (format version 1, the same keys), written
atomically, so that composition can run again without registration and a
checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

from .registration import PairRegistration

_VERSION = 1


def save_registration(path: str, files: List[str],
                      records: List[PairRegistration]) -> None:
    payload = {
        "version": _VERSION,
        "files": list(files),
        "records": [dataclasses.asdict(r) for r in records],
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint


def load_registration(path: str, files: Optional[List[str]] = None
                      ) -> Optional[List[PairRegistration]]:
    """The checkpointed records; None when the file is absent, of another
    version, or of another file list (a stale checkpoint)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        payload = json.load(f)
    if payload.get("version") != _VERSION:
        return None
    if files is not None and list(files) != payload["files"]:
        return None
    out = []
    for d in payload["records"]:
        d["offset"] = tuple(d["offset"])
        d["offset_subpix"] = tuple(d["offset_subpix"])
        out.append(PairRegistration(**d))
    return out
