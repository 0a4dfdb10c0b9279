"""Host-side image file I/O (port of nle_tpu/utils/imageio.py).

Images are exchanged as (H, W, 3) uint8 BGR arrays, the reference's
cv::imread/imwrite contract (reference src/enhance.cpp:33,47), with the
JAX package's error contract: a file that cannot be read or decoded raises
FileNotFoundError from imread_bgr and ValueError from imdecode_bgr. OpenCV
is used when present, else Pillow.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2

    _HAVE_CV2 = True
except Exception:  # pragma: no cover
    _HAVE_CV2 = False


def _pil_to_bgr(im) -> np.ndarray:
    # cv2.imread applies EXIF orientation; the Pillow path matches it.
    from PIL import ImageOps

    im = ImageOps.exif_transpose(im)
    rgb = np.asarray(im.convert("RGB"))
    return rgb[..., ::-1].copy()


def imread_bgr(path: str) -> np.ndarray:
    if _HAVE_CV2:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"Failed to read file from {path}")
        return img
    from PIL import Image

    try:
        # Pillow decodes lazily: the convert must sit inside the try.
        return _pil_to_bgr(Image.open(path))
    except FileNotFoundError:
        raise
    except Exception as e:
        raise FileNotFoundError(f"Failed to read file from {path}") from e


def imdecode_bgr(data: bytes) -> np.ndarray:
    """Encoded image bytes (PNG/BMP/JPEG...) as (H, W, 3) uint8 BGR.
    Undecodable input raises ValueError, always (cv2.imdecode raises
    cv2.error on an empty buffer: that too becomes ValueError)."""
    if _HAVE_CV2:
        try:
            img = cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_COLOR)
        except cv2.error as e:
            raise ValueError(f"Could not decode image bytes: {e}") from e
        if img is None:
            raise ValueError("Could not decode image bytes")
        return img
    import io

    from PIL import Image

    try:
        return _pil_to_bgr(Image.open(io.BytesIO(data)))
    except Exception as e:
        raise ValueError("Could not decode image bytes") from e


def imencode_png(img_bgr_u8: np.ndarray) -> bytes:
    """Encode a (H, W, 3) uint8 BGR array as PNG bytes."""
    img = np.asarray(img_bgr_u8)
    if _HAVE_CV2:
        ok, buf = cv2.imencode(".png", img)
        if not ok:
            raise ValueError("PNG encode failed")
        return buf.tobytes()
    import io

    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(img[..., ::-1]).save(out, "PNG")
    return out.getvalue()


def imwrite_bgr(path: str, img_bgr_u8: np.ndarray) -> None:
    img = np.asarray(img_bgr_u8)
    if _HAVE_CV2:
        if not cv2.imwrite(path, img):
            raise IOError(f"Failed to write {path}")
        return
    from PIL import Image

    Image.fromarray(img[..., ::-1]).save(path)
