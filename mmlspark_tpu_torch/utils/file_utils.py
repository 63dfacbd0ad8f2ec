"""File helpers of the PyTorch port: its copy of
``mmlspark_tpu/utils/file_utils.py`` (ref: src/core/env FileUtilities /
StreamUtilities)."""

from __future__ import annotations

import fnmatch
import hashlib
import os
import zipfile
from typing import Iterator, List, Optional, Tuple


def recursive_list_files(directory: str, pattern: Optional[str] = None,
                         recursive: bool = True) -> List[str]:
    out: List[str] = []
    if recursive:
        for root, _dirs, files in os.walk(directory):
            for f in sorted(files):
                if pattern is None or fnmatch.fnmatch(f, pattern):
                    out.append(os.path.join(root, f))
    else:
        for f in sorted(os.listdir(directory)):
            p = os.path.join(directory, f)
            if os.path.isfile(p) and (pattern is None or fnmatch.fnmatch(f, pattern)):
                out.append(p)
    return out


def iter_binary_files(directory: str, pattern: Optional[str] = None,
                      recursive: bool = True,
                      inspect_zip: bool = True,
                      sample_ratio: float = 1.0,
                      seed: int = 0) -> Iterator[Tuple[str, bytes]]:
    """Yield (path, bytes), descending into zip files like the reference's
    binary reader (ref: src/io/binary/.../BinaryFileFormat.scala:116 zip
    inspection + sampling)."""
    import random
    rng = random.Random(seed)
    for path in recursive_list_files(directory, None, recursive):
        if inspect_zip and path.endswith(".zip"):
            with zipfile.ZipFile(path) as zf:
                for info in zf.infolist():
                    if info.is_dir():
                        continue
                    name = os.path.basename(info.filename)
                    if pattern and not fnmatch.fnmatch(name, pattern):
                        continue
                    if sample_ratio < 1.0 and rng.random() > sample_ratio:
                        continue
                    yield (f"{path}/{info.filename}", zf.read(info))
        else:
            if pattern and not fnmatch.fnmatch(os.path.basename(path), pattern):
                continue
            if sample_ratio < 1.0 and rng.random() > sample_ratio:
                continue
            with open(path, "rb") as f:
                yield (path, f.read())


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
