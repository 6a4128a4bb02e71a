"""Host-side image decode/encode.

Port of ``imagestitch_tpu/io/codec.py``: JPEG/PNG through OpenCV when it is
installed, PIL otherwise; decode is optional, and a machine with neither
raises at the first decode, not at import.  Bytes are read first, as the
reference does for non-ASCII paths (Stitcher.py:68-69).  Color is BGR on
both routes (PIL's RGB is reversed on read and on write).  The gray of a
color frame is io/dataset.bgr_to_gray, cv2's fixed-point rule.
"""
from __future__ import annotations

import os

import numpy as np

try:  # pragma: no cover - environment probe
    import cv2  # type: ignore

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False

try:  # pragma: no cover - environment probe
    from PIL import Image  # type: ignore

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    Image = None
    _HAS_PIL = False


def imread(path: str, color: bool) -> np.ndarray:
    """Decode an image file: uint8 (H, W), or (H, W, 3) BGR when ``color``."""
    data = np.fromfile(path, dtype=np.uint8)
    if _HAS_CV2:
        flag = cv2.IMREAD_COLOR if color else cv2.IMREAD_GRAYSCALE
        img = cv2.imdecode(data, flag)
        if img is None:
            raise IOError(f"failed to decode image: {path}")
        return img
    if _HAS_PIL:
        import io as _io

        with Image.open(_io.BytesIO(data.tobytes())) as im:
            if color:
                arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
                return arr[..., ::-1].copy()  # RGB -> BGR
            return np.asarray(im.convert("L"), dtype=np.uint8)
    raise RuntimeError("no image decoder available (need cv2 or PIL)")


def imwrite(path: str, image: np.ndarray) -> None:
    """Encode and write an image (BGR for color input)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    if _HAS_CV2:
        if not cv2.imwrite(path, image):
            raise IOError(f"failed to write image: {path}")
        return
    if _HAS_PIL:
        Image.fromarray(image[..., ::-1] if image.ndim == 3 else image
                        ).save(path)
        return
    raise RuntimeError("no image encoder available (need cv2 or PIL)")
