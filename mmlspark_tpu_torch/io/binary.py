"""Binary-file table source of the PyTorch port (see
``mmlspark_tpu/io/binary.py``).

Analog of the reference's HadoopFsRelation binary source
(ref: src/io/binary/src/main/scala/BinaryFileFormat.scala:116,
BinaryFileReader.scala:18): directory-recursive, zip-inspecting, sampled
reads into a {path, bytes} struct column. Local paths (bare or
``file://``) walk the directory; remote schemes (``http(s)://`` with an
``_index.json``, ``webdav(s)://``, or any registered scheme) list and
read through the filesystem registry (``utils/filesystem.py``).
"""

from __future__ import annotations

import fnmatch
import io as _io
import random
import zipfile
from typing import Iterator, Optional, Tuple

from mmlspark_tpu_torch.core.schema import BinaryFileSchema, Schema
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.utils import filesystem as fslib
from mmlspark_tpu_torch.utils.file_utils import iter_binary_files


def _iter_source(path: str, pattern: Optional[str] = None,
                 recursive: bool = True, inspect_zip: bool = True,
                 sample_ratio: float = 1.0, seed: int = 0
                 ) -> Iterator[Tuple[str, bytes]]:
    """(path, bytes) of every file under ``path``. Local dirs use the
    zip-inspecting iterator; remote schemes go through the filesystem
    registry (ref: HadoopUtils / HDFSRepo remote reads,
    ModelDownloader.scala:54-124). Zip archives are descended into on
    both paths."""
    if fslib.scheme_of(path) == "file":
        yield from iter_binary_files(
            fslib.LocalFileSystem._strip(path), pattern=pattern,
            recursive=recursive, inspect_zip=inspect_zip,
            sample_ratio=sample_ratio, seed=seed)
        return
    rng = random.Random(seed)
    fs = fslib.get_filesystem(path)
    for p in fs.list_files(path, None, recursive):
        leaf = p.rsplit("/", 1)[-1]
        if inspect_zip and p.lower().endswith(".zip"):
            with zipfile.ZipFile(_io.BytesIO(fs.read_bytes(p))) as zf:
                for info in zf.infolist():
                    if info.is_dir():
                        continue
                    name = info.filename.rsplit("/", 1)[-1]
                    if pattern and not fnmatch.fnmatch(name, pattern):
                        continue
                    if sample_ratio < 1.0 and rng.random() > sample_ratio:
                        continue
                    yield f"{p}/{info.filename}", zf.read(info)
        else:
            # filter BEFORE fetching — non-matching remote files must
            # not be downloaded at all
            if pattern and not fnmatch.fnmatch(leaf, pattern):
                continue
            if sample_ratio < 1.0 and rng.random() > sample_ratio:
                continue
            yield p, fs.read_bytes(p)


def read_binary_files(path: str,
                      recursive: bool = True,
                      pattern: Optional[str] = None,
                      sample_ratio: float = 1.0,
                      inspect_zip: bool = True,
                      seed: int = 0,
                      column_name: str = "value") -> DataTable:
    rows = [
        {column_name: BinaryFileSchema.make_row(p, data)}
        for p, data in _iter_source(
            path, pattern=pattern, recursive=recursive,
            inspect_zip=inspect_zip, sample_ratio=sample_ratio, seed=seed)
    ]
    schema = Schema([BinaryFileSchema.field(column_name)])
    if not rows:
        return DataTable({column_name: []}, schema)
    return DataTable.from_rows(rows, schema)
