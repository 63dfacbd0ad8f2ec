"""Image table source and sink of the PyTorch port (see
``mmlspark_tpu/io/image.py``).

Analog of the reference's OpenCV-backed image reader
(ref: src/io/image/src/main/scala/Image.scala:22-75, ImageFileFormat.scala:25):
reads a directory (recursively, with sampling and zip inspection) into an
image struct column {path, height, width, channels, mode, data} with BGR
uint8 HWC data, the reference's OpenCV storage convention.

``decode_image`` tries the decoders in the JAX package's order: the
port's native codecs (``csrc/imgcodec.cpp``, libjpeg and libpng, through
``io/native_image.py``), then ``cv2``, then ``PIL``; bytes none of them
decodes give ``None``. The first decode each decoder serves is logged,
with the reason the native codecs are missing when they are.
"""

from __future__ import annotations

import io as _io
import os
import threading
from typing import Optional

import numpy as np

from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.schema import ImageSchema, Schema
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.io import native_image

log = get_logger("io.image")

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif",
                    ".tiff", ".webp")

_LOGGED: set = set()
_LOG_LOCK = threading.Lock()


def _note_decoder(name: str) -> None:
    """Log, once per process, that ``name`` decoded an image."""
    with _LOG_LOCK:
        if name in _LOGGED:
            return
        _LOGGED.add(name)
    why = ""
    if name != "native":
        why = (" (the native codecs are unavailable: "
               f"{native_image.codec_error()})"
               if not native_image.codec_available() else "")
    log.info("image decode: %s%s", name, why)


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """bytes -> BGR HWC uint8 array, or None on failure
    (ref: Image.scala:47-75 decode semantics: undecodable -> null row)."""
    if native_image.codec_available():
        rgb = native_image.decode_image(data)
        if rgb is not None:
            _note_decoder("native")
            return rgb[:, :, ::-1].copy()      # RGB -> BGR convention
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, dtype=np.uint8),
                           cv2.IMREAD_COLOR)
        if img is None:
            return None
        _note_decoder("cv2")
        return img[:, :, None] if img.ndim == 2 else img
    try:
        from PIL import Image as PILImage
    except ImportError:
        return None
    try:
        img = PILImage.open(_io.BytesIO(data)).convert("RGB")
    except (OSError, ValueError, SyntaxError,
            PILImage.DecompressionBombError):
        return None
    _note_decoder("PIL")
    return np.asarray(img)[:, :, ::-1].copy()  # RGB -> BGR


def encode_image(img: np.ndarray, ext: str = ".png") -> bytes:
    import cv2
    ok, buf = cv2.imencode(ext, img)
    if not ok:
        raise ValueError(f"failed to encode image as {ext}")
    return buf.tobytes()


def read_images(path: str,
                recursive: bool = True,
                sample_ratio: float = 1.0,
                inspect_zip: bool = True,
                seed: int = 0,
                column_name: str = "image",
                drop_undecodable: bool = True) -> DataTable:
    from mmlspark_tpu_torch.io.binary import _iter_source
    rows = []
    for p, data in _iter_source(path, recursive=recursive,
                                inspect_zip=inspect_zip,
                                sample_ratio=sample_ratio, seed=seed):
        if not p.lower().endswith(IMAGE_EXTENSIONS):
            continue
        img = decode_image(data)
        if img is None:
            if drop_undecodable:
                continue
            rows.append({column_name: None})
        else:
            rows.append({column_name: ImageSchema.make_row(p, img, "BGR")})
    schema = Schema([ImageSchema.field(column_name)])
    if not rows:
        return DataTable({column_name: []}, schema)
    return DataTable.from_rows(rows, schema)


def write_images(table: DataTable, directory: str,
                 column_name: str = "image", ext: str = ".png") -> None:
    """ref: src/io/image ImageWriter."""
    os.makedirs(directory, exist_ok=True)
    used = set()
    for i, row in enumerate(table.rows()):
        img = row[column_name]
        if img is None:
            continue
        base = os.path.basename(str(img.get(ImageSchema.PATH, f"img_{i}")))
        stem = os.path.splitext(base)[0] or f"img_{i}"
        # uniquify: recursive reads can yield identical basenames from
        # different subdirectories
        name, k = stem, 1
        while name in used:
            name = f"{stem}_{k}"
            k += 1
        used.add(name)
        out = os.path.join(directory, f"{name}{ext}")
        with open(out, "wb") as f:
            f.write(encode_image(np.asarray(img[ImageSchema.DATA]), ext))
