"""Accuracy harness: registration quality on the demo datasets.

Port of ``imagestitch_tpu/eval/accuracy.py``.  Metric: the offset error
(px, Chebyshev) against goldens:
  * dendriticCrystal -- the reference's own 89-offset chain
    (Stitcher.py:87), adapted for the missing 1-002 frame;
  * the other datasets publish no goldens; an independent cv2.SIFT +
    mode-vote oracle (the reference's decision rule on OpenCV's detector)
    gives per-pair cross-checks where cv2 has SIFT, and the overlap NCC
    arbitrates disputes at the pixel level (host numpy, float64).

Each dataset runs the configuration the reference's Main.py gives it
(Main.py:17-51), registered by the port on ``device`` (the card unless the
caller passes ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import FeatureConfig, StitchConfig
from ..core import feature_registration as freg
from ..core import registration as reg
from ..device import resolve_device
from ..io import dataset

# Reference golden chain for the 90-image dendritic grid (Stitcher.py:87).
DENDRITIC_GOLDEN_90 = [
    [1784, 2], [1805, 2], [1809, 2], [1775, 2], [1760, 2], [1846, 2],
    [1809, 1], [1812, 2], [1786, 1], [1818, 3], [1786, 2], [1802, 2],
    [1722, 1], [1211, 1], [-10, 2411], [-1734, -1], [-1808, -1], [-1788, -3],
    [-1754, -1], [-1727, -2], [-1790, -3], [-1785, -2], [-1778, -1],
    [-1807, -2], [-1767, -2], [-1822, -3], [-1677, -2], [-1778, -2],
    [-1440, -1], [-2, 2410], [1758, 2], [1792, 2], [1794, 2], [1840, 3],
    [1782, 2], [1802, 3], [1782, 2], [1763, 3], [1738, 2], [1837, 3],
    [1781, 2], [1788, 18], [1712, 0], [1271, -11], [-3, 2478], [-1787, -1],
    [-1812, -2], [-1822, -2], [-1762, -1], [-1725, -2], [-1884, -2],
    [-1754, -2], [-1747, -1], [-1666, -1], [-1874, -3], [-1695, -2],
    [-1672, -1], [-1816, -2], [-1411, -1], [-4, 2431], [1874, 3], [1706, -3],
    [1782, 2], [1794, 2], [1732, 3], [1838, 3], [1721, 1], [1783, 3],
    [1805, 2], [1725, 3], [1828, 1], [1774, 3], [1776, 1], [1201, 1],
    [-16, 2405], [-1821, 0], [-1843, -2], [-1758, -2], [-1742, -3],
    [-1814, -2], [-1817, -2], [-1848, -2], [-1768, -2], [-1749, -2],
    [-1765, -2], [-1659, -2], [-1832, -2], [-1791, -2], [-1197, -1],
]


def dendritic_golden_89() -> List[Tuple[int, int]]:
    """Golden chain for the shipped 89-frame set (1-002 missing -> the first
    shipped pair spans golden offsets 0+1, which exceeds the frame height:
    physically unstitchable, expected FAIL)."""
    g = DENDRITIC_GOLDEN_90
    first = (g[0][0] + g[1][0], g[0][1] + g[1][1])
    return [first] + [tuple(x) for x in g[2:]]


# (name, config) as Main.py:17-51 runs them
def dataset_configs(feature_method: str = "surf") -> Dict[str, StitchConfig]:
    # the reference's whole-image path detects UNBOUNDED keypoints
    # (ImageUtility.py:255-262); 4096 capacity matches cv2's typical yield
    # on these frames (2-4.4k)
    feat = FeatureConfig(method=feature_method, max_keypoints=4096)
    base = dict(offset_calculate="mode", offset_evaluate=3, roi_ratio=0.2,
                fuse_method="fadeInAndFadeOut", features=feat)
    return {
        "iron": StitchConfig(registration="feature_incre", direction=1,
                             direct_incre=0, **base),
        "dendriticCrystal": StitchConfig(registration="feature_incre",
                                         direction=1, direct_incre=1, **base),
        "zirconBSE": StitchConfig(registration="feature", direction=4,
                                  direct_incre=0, **base),
        "zirconCL": StitchConfig(registration="feature", direction=4,
                                 direct_incre=0, **base),
        "zirconREM": StitchConfig(registration="feature", direction=4,
                                  direct_incre=0, **base),
        "zirconTEM": StitchConfig(registration="feature", direction=4,
                                  direct_incre=0, **base),
    }


def _sift_oracle_offset(a: np.ndarray, b: np.ndarray
                        ) -> Optional[Tuple[int, int]]:
    """Independent whole-image cv2.SIFT + reference mode-vote oracle."""
    try:
        import cv2
    except Exception:
        return None
    sift = cv2.SIFT_create()
    ka, da = sift.detectAndCompute(a, None)
    kb, db = sift.detectAndCompute(b, None)
    if da is None or db is None or len(ka) < 2 or len(kb) < 2:
        return None
    bf = cv2.BFMatcher()
    raw = bf.knnMatch(da, db, 2)
    from collections import Counter
    votes = Counter()
    order: Dict[Tuple[int, int], int] = {}
    for m in raw:
        if len(m) == 2 and m[0].distance < 0.75 * m[1].distance:
            pa = ka[m[0].queryIdx].pt
            pb = kb[m[0].trainIdx].pt
            d = (int(pa[1] - pb[1]), int(pa[0] - pb[0]))
            if d == (0, 0):
                continue
            votes[d] += 1
            order.setdefault(d, len(order))
    if not votes:
        return None
    best = max(votes.items(), key=lambda kv: (kv[1], -order[kv[0]]))
    if best[1] < 3:
        return None
    return best[0]


def overlap_ncc(a: np.ndarray, b: np.ndarray,
                offset: Tuple[int, int]) -> Optional[float]:
    """Pearson correlation of the overlap pixels when B sits at A + offset.

    The verification metric that needs no third estimator: for candidate
    integer translations of the same pair, the one that explains the pixels
    better scores higher.  Returns None when the offset leaves no overlap
    (or a degenerate constant patch).
    """
    h, w = a.shape[:2]
    hb, wb = b.shape[:2]
    dr, dc = int(offset[0]), int(offset[1])
    r0, r1 = max(0, dr), min(h, dr + hb)
    c0, c1 = max(0, dc), min(w, dc + wb)
    if r1 - r0 < 8 or c1 - c0 < 8:
        return None
    pa = a[r0:r1, c0:c1].astype(np.float64)
    pb = b[r0 - dr:r1 - dr, c0 - dc:c1 - dc].astype(np.float64)
    pa -= pa.mean()
    pb -= pb.mean()
    denom = np.sqrt((pa * pa).sum() * (pb * pb).sum())
    if denom == 0:
        return None
    return float((pa * pb).sum() / denom)


def ncc_argmax_sweep(a: np.ndarray, b: np.ndarray,
                     candidates: List[Tuple[int, int]], radius: int = 4
                     ) -> Tuple[Optional[Tuple[int, int]], Optional[float]]:
    """Exhaustive integer-NCC adjudication: the overlap NCC at every
    integer offset within ``radius`` px (Chebyshev) of each candidate ->
    (argmax_offset, argmax_ncc), an estimator-free measurement of which
    translation best explains the pixels (the rule adjudicated: the mode
    vote over match displacements, ImageUtility.py:139-178)."""
    seen = {}
    for cr, cc in candidates:
        for dr in range(-radius, radius + 1):
            for dc in range(-radius, radius + 1):
                off = (int(cr) + dr, int(cc) + dc)
                if off in seen:
                    continue
                seen[off] = overlap_ncc(a, b, off)
    live = {k: v for k, v in seen.items() if v is not None}
    if not live:
        return None, None
    best = max(live.items(), key=lambda kv: kv[1])
    return best[0], float(best[1])


@dataclasses.dataclass
class DatasetAccuracy:
    name: str
    num_pairs: int
    num_ok: int
    mean_abs_err_px: Optional[float]
    max_abs_err_px: Optional[float]
    within_1px: Optional[int]
    compared_pairs: int
    offsets: List[Tuple[int, int]]
    #: norm used by mean/max_abs_err AND within_1px: Chebyshev (max of the
    #: per-axis absolute errors), stated here so the JSON is unambiguous
    error_norm: str = "chebyshev_px"
    # with the per-pair phase fallback the Stitcher applies
    # (registration="hybrid" semantics; see core/registration.py)
    num_ok_fallback: Optional[int] = None
    mean_abs_err_fallback_px: Optional[float] = None
    # pixel-level verification: datasets without published goldens get
    # their "golden" from the cv2.SIFT oracle, itself a few px off when
    # pairs carry slight stage rotation; the overlap NCC under each
    # candidate offset needs no third estimator.  ncc_wins counts compared
    # pairs where our offset's overlap NCC >= the oracle's
    mean_overlap_ncc: Optional[float] = None
    mean_overlap_ncc_golden: Optional[float] = None
    ncc_wins: Optional[int] = None
    # per-pair evidence table: {pair, ours, golden, ncc_ours, ncc_golden,
    # and for DISPUTED pairs ncc_argmax/ncc_argmax_val/ours_is_argmax}
    pair_detail: Optional[List[dict]] = None
    # exhaustive-NCC adjudication over disputed pairs (ours != golden):
    # of those, how many have OUR offset == the NCC argmax over the +-4 px
    # neighborhood of both candidates vs the golden
    disputed_pairs: Optional[int] = None
    disputed_ours_argmax: Optional[int] = None
    disputed_golden_argmax: Optional[int] = None


def _score(recs, goldens, shape):
    errs, within1, compared = [], 0, 0
    for r, g in zip(recs, goldens):
        if g is None or not r.ok:
            continue
        # skip goldens that are physically impossible (missing-frame pair)
        if abs(g[0]) >= shape[0] or abs(g[1]) >= shape[1]:
            continue
        compared += 1
        # ONE norm everywhere (Chebyshev): see DatasetAccuracy.error_norm
        e = max(abs(r.offset[0] - g[0]), abs(r.offset[1] - g[1]))
        errs.append(e)
        if e <= 1:
            within1 += 1
    return errs, within1, compared


def evaluate_dataset(demo_root: str, name: str, cfg: StitchConfig,
                     use_oracle: bool = True,
                     device="cuda") -> DatasetAccuracy:
    """Register ``<demo_root>/<name>/1/*.jpg`` (gray) with ``cfg`` on
    ``device`` and score it against the goldens; failed pairs are scored
    again with the phase fallback the Stitcher's ``hybrid`` applies."""
    dev = resolve_device(device, "evaluate_dataset")
    files = dataset.list_project_images(os.path.join(demo_root, name), 1)
    batch = dataset.load_batch(files, color_mode=False)
    if cfg.registration == "feature_incre":
        recs = freg.register_sequence_features_incre(batch.gray, cfg,
                                                     device=dev)
    elif cfg.registration == "feature":
        recs = freg.register_sequence_features(batch.gray, cfg, device=dev)
    else:
        recs = reg.register_sequence_phase(batch.gray, cfg, device=dev)

    goldens: List[Optional[Tuple[int, int]]]
    if name == "dendriticCrystal" and len(recs) == 88:
        goldens = list(dendritic_golden_89())
    elif use_oracle:
        goldens = [_sift_oracle_offset(batch.gray[k], batch.gray[k + 1])
                   for k in range(len(recs))]
    else:
        goldens = [None] * len(recs)

    shape = batch.gray.shape[1:3]
    errs, within1, compared = _score(recs, goldens, shape)

    num_ok_fb = None
    mean_fb = None
    if any(not r.ok for r in recs):
        phase = reg.register_sequence_phase(batch.gray, cfg, device=dev)
        fb = [r if r.ok else p for r, p in zip(recs, phase)]
        errs_fb, _, _ = _score(fb, goldens, shape)
        num_ok_fb = sum(r.ok for r in fb)
        mean_fb = float(np.mean(errs_fb)) if errs_fb else None

    ncc_ours, ncc_gold, wins = [], [], 0
    detail = []
    for k, (r, gld) in enumerate(zip(recs, goldens)):
        if gld is None or not r.ok:
            continue
        if abs(gld[0]) >= shape[0] or abs(gld[1]) >= shape[1]:
            continue
        no = overlap_ncc(batch.gray[k], batch.gray[k + 1], r.offset)
        ng = overlap_ncc(batch.gray[k], batch.gray[k + 1], gld)
        if no is None or ng is None:
            continue
        ncc_ours.append(no)
        ncc_gold.append(ng)
        wins += no >= ng - 1e-4
        row = {"pair": k, "ours": list(r.offset), "golden": list(gld),
               "ncc_ours": round(no, 6), "ncc_golden": round(ng, 6)}
        if tuple(r.offset) != tuple(gld):
            # disputed: measure the best integer offset outright
            amax, aval = ncc_argmax_sweep(batch.gray[k], batch.gray[k + 1],
                                          [tuple(r.offset), tuple(gld)])
            if amax is not None:
                row["ncc_argmax"] = list(amax)
                row["ncc_argmax_val"] = round(aval, 6)
                row["ours_is_argmax"] = amax == tuple(r.offset)
                row["golden_is_argmax"] = amax == tuple(gld)
        detail.append(row)

    n_disp = sum("ncc_argmax" in d for d in detail) or None
    return DatasetAccuracy(
        name=name, num_pairs=len(recs), num_ok=sum(r.ok for r in recs),
        mean_abs_err_px=float(np.mean(errs)) if errs else None,
        max_abs_err_px=float(np.max(errs)) if errs else None,
        within_1px=within1 if compared else None,
        compared_pairs=compared,
        offsets=[tuple(r.offset) for r in recs],
        num_ok_fallback=num_ok_fb,
        mean_abs_err_fallback_px=mean_fb,
        mean_overlap_ncc=float(np.mean(ncc_ours)) if ncc_ours else None,
        mean_overlap_ncc_golden=float(np.mean(ncc_gold)) if ncc_gold else None,
        ncc_wins=wins if ncc_ours else None,
        pair_detail=detail or None,
        disputed_pairs=n_disp,
        disputed_ours_argmax=(sum(d.get("ours_is_argmax", False)
                                  for d in detail) if n_disp else None),
        disputed_golden_argmax=(sum(d.get("golden_is_argmax", False)
                                    for d in detail) if n_disp else None))


def run(demo_root: str, names: Optional[List[str]] = None,
        feature_method: str = "surf",
        device="cuda") -> Dict[str, DatasetAccuracy]:
    """``evaluate_dataset`` for every dataset of ``dataset_configs`` that
    ``demo_root`` holds (or those of them in ``names``)."""
    cfgs = dataset_configs(feature_method)
    out = {}
    for name, cfg in cfgs.items():
        if names and name not in names:
            continue
        if not os.path.isdir(os.path.join(demo_root, name)):
            continue
        out[name] = evaluate_dataset(demo_root, name, cfg, device=device)
    return out


# Detector-mode columns for the side-by-side table:
#   default    -- Gaussian-derivative DoH, auto-upright fast path (the
#                 production defaults);
#   box_filter -- the reference detector's integral-image SURF box filters
#                 (ImageUtility.py:255-262), oriented descriptors;
#   parity     -- Gaussian DoH, oriented descriptors, flat octave budgets.
MODES = {
    "default": {},
    "box_filter": {"box_filter": True, "auto_upright": False,
                   "octave_topk_decay": 1},
    "parity": {"auto_upright": False, "octave_topk_decay": 1},
}


def run_modes(demo_root: str, names: Optional[List[str]] = None,
              modes: Optional[List[str]] = None, device="cuda"
              ) -> Dict[str, Dict[str, DatasetAccuracy]]:
    """Side-by-side detector-mode accuracy: {mode: {dataset: result}}."""
    out: Dict[str, Dict[str, DatasetAccuracy]] = {}
    for mode in (modes or list(MODES)):
        patch = MODES[mode]
        res = {}
        for name, cfg in dataset_configs().items():
            if names and name not in names:
                continue
            if not os.path.isdir(os.path.join(demo_root, name)):
                continue
            if patch:
                cfg = cfg.replace(features=dataclasses.replace(cfg.features,
                                                               **patch))
            res[name] = evaluate_dataset(demo_root, name, cfg,
                                         device=device)
        out[mode] = res
    return out


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--demo-root", required=True,
                   help="directory of <dataset>/1/*.jpg sequences")
    p.add_argument("--datasets", nargs="*")
    p.add_argument("--feature-method", default="surf")
    p.add_argument("--modes", nargs="*",
                   help=f"detector-mode columns from {list(MODES)}; "
                        f"side-by-side output")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if args.modes:
        res2 = run_modes(args.demo_root, args.datasets, args.modes,
                         device=args.device)
        payload = {m: {k: dataclasses.asdict(v) for k, v in r.items()}
                   for m, r in res2.items()}
    else:
        res = run(args.demo_root, args.datasets, args.feature_method,
                  device=args.device)
        payload = {k: dataclasses.asdict(v) for k, v in res.items()}
    txt = json.dumps(payload, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    print(txt)


if __name__ == "__main__":
    main()
