"""Binary-file table source of the PyTorch port (see
``mmlspark_tpu/io/binary.py``).

Analog of the reference's HadoopFsRelation binary source
(ref: src/io/binary/src/main/scala/BinaryFileFormat.scala:116,
BinaryFileReader.scala:18): directory-recursive, zip-inspecting, sampled
reads into a {path, bytes} struct column. Local paths (bare or
``file://``) only: the JAX package reads remote schemes through its
filesystem registry (``utils/filesystem.py``), which the port has not
ported yet, so a remote path raises ``NotImplementedError`` naming its
ROADMAP.md item.
"""

from __future__ import annotations

import urllib.parse
from typing import Iterator, Optional, Tuple

from mmlspark_tpu_torch.core.schema import BinaryFileSchema, Schema
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.utils.file_utils import iter_binary_files

FILESYSTEM_ITEM = "DNN training: checkpoint/resume"


def local_path(path: str) -> str:
    """``path`` as a local path (``file://`` stripped); a remote scheme
    raises ``NotImplementedError`` (the scheme test of the JAX package's
    ``filesystem.scheme_of``: one-letter schemes are drive letters)."""
    scheme = urllib.parse.urlparse(path).scheme
    if len(scheme) > 1 and scheme != "file":
        raise NotImplementedError(
            f"reading {scheme}:// paths needs the filesystem registry "
            f"(utils/filesystem.py), which is not ported yet: ROADMAP.md, "
            f"'{FILESYSTEM_ITEM}'")
    return path[len("file://"):] if path.startswith("file://") else path


def _iter_source(path: str, pattern: Optional[str] = None,
                 recursive: bool = True, inspect_zip: bool = True,
                 sample_ratio: float = 1.0, seed: int = 0
                 ) -> Iterator[Tuple[str, bytes]]:
    """(path, bytes) of every file under a local ``path``, zip archives
    descended into."""
    yield from iter_binary_files(
        local_path(path), pattern=pattern, recursive=recursive,
        inspect_zip=inspect_zip, sample_ratio=sample_ratio, seed=seed)


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
