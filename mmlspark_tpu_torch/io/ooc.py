"""Out-of-core chunked ingest: tables bigger than host RAM.

The PyTorch port's own copy of ``mmlspark_tpu/io/ooc.py``.
``ChunkedTable`` is a REPLAYABLE stream of bounded DataTable chunks,
read from:

- **memory-mapped .npy columns** (``from_npy``): one ``np.load(...,
  mmap_mode='r')`` per column, sliced into chunks;
- **Arrow IPC files** (``from_arrow_ipc``): memory-mapped, a record
  batch at a time. ``pyarrow`` is imported inside the Arrow functions
  only, so the rest of the module works where it is not installed;
- **in-process generators** (``from_generator``): a zero-arg factory
  yielding DataTable / dict chunks;
- **an in-memory table** (``from_table``): slicing for tests and parity
  baselines.

Iteration runs the DECODE on a prefetch worker thread
(``utils/prefetch.ThreadedPrefetcher``; host-only numpy work, never a
torch device call, which stays on the consumer's thread): while the
consumer works on chunk *k*, the worker decodes chunk *k+1*, up to
``prefetch_depth`` chunks ahead. Per-chunk decode / wait walls land in
``core.metrics.ooc_histograms()``, and ``stats`` tracks rows, bytes and
peaks, so a caller can assert its bounded-memory claim from tracked
bytes (peak in flight = (depth + 2) x peak chunk bytes) beside the
process RSS.

Consumers: GBDT ``train`` through ``as_xy`` and the GBDT estimators'
``fit``. (The JAX package's ``ReplayWindow``, which only its control
plane reads, is not ported yet: ROADMAP.md §1 item 15.)
"""

from __future__ import annotations

import threading
import time
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, Optional,
)

import numpy as np

from mmlspark_tpu_torch.core import metrics as MC
from mmlspark_tpu_torch.core.schema import Schema
from mmlspark_tpu_torch.core.sparse import CSRMatrix
from mmlspark_tpu_torch.core.table import DataTable, features_matrix
from mmlspark_tpu_torch.utils.prefetch import ThreadedPrefetcher


def table_nbytes(table: DataTable) -> int:
    """Tracked host bytes of one table: exact for array columns (incl.
    CSR parts), estimated for Python-object columns (strings by length,
    token lists by element count) — the accounting unit behind the
    bounded-memory assertions."""
    total = 0
    for name in table.column_names:
        col = table[name]
        if isinstance(col, np.ndarray):
            total += col.nbytes
            continue
        if isinstance(col, CSRMatrix):
            total += int(col.data.nbytes + col.indices.nbytes
                         + col.indptr.nbytes)
            continue
        for v in col:
            if v is None:
                total += 8
            elif isinstance(v, str):
                total += 49 + len(v)          # CPython str overhead
            elif isinstance(v, (bytes, bytearray)):
                total += 33 + len(v)
            elif isinstance(v, np.ndarray):
                total += v.nbytes
            elif isinstance(v, (list, tuple)):
                total += 56 + 8 * len(v) + sum(
                    49 + len(t) if isinstance(t, str) else 32
                    for t in v)
            else:
                total += 32
    return total


def current_rss_bytes() -> int:
    """This process's resident set right now (/proc; 0 if unreadable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def peak_rss_bytes() -> int:
    """This process's high-water resident set (ru_maxrss)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class OOCStats:
    """Per-source ingest accounting (thread-safe: the decode side runs
    on the prefetch worker)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.chunks = 0
        self.rows = 0
        self.bytes_total = 0
        self.peak_chunk_bytes = 0
        self.decode_s = 0.0
        self.depth = 0          # prefetch depth of the last iteration

    def note_chunk(self, rows: int, nbytes: int, decode_s: float) -> None:
        with self._lock:
            self.chunks += 1
            self.rows += rows
            self.bytes_total += nbytes
            self.peak_chunk_bytes = max(self.peak_chunk_bytes, nbytes)
            self.decode_s += decode_s

    def tracked_peak_bytes(self) -> int:
        """Upper bound on host bytes this source holds IN FLIGHT:
        ``prefetch_depth`` buffered chunks + one being decoded + one
        being consumed, each at most the largest chunk seen."""
        with self._lock:
            return (self.depth + 2) * self.peak_chunk_bytes

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"chunks": self.chunks, "rows": self.rows,
                    "bytes_total": self.bytes_total,
                    "peak_chunk_bytes": self.peak_chunk_bytes,
                    "tracked_peak_bytes":
                        (self.depth + 2) * self.peak_chunk_bytes,
                    "decode_s": round(self.decode_s, 4)}

    def reset(self) -> None:
        with self._lock:
            self.chunks = self.rows = self.bytes_total = 0
            self.peak_chunk_bytes = 0
            self.decode_s = 0.0


def _as_table(chunk: Any) -> DataTable:
    if isinstance(chunk, DataTable):
        return chunk
    if isinstance(chunk, dict):
        return DataTable(chunk)
    raise TypeError(
        f"chunk factories must yield DataTable or column-dict chunks; "
        f"got {type(chunk).__name__}")


class ChunkedTable:
    """A replayable, bounded-memory stream of DataTable chunks.

    ``factory`` is a zero-arg callable returning a fresh iterator of
    chunks — every ``__iter__``/``chunks()`` call replays the source
    from the start (the contract streaming fits and multi-epoch
    training need). The table itself never holds more than the chunks
    in flight.
    """

    def __init__(self, factory: Callable[[], Iterable[Any]], *,
                 schema: Optional[Schema] = None,
                 num_rows: Optional[int] = None,
                 prefetch_depth: int = 2,
                 label: str = "chunked",
                 instrument: bool = True):
        if not callable(factory):
            raise TypeError(
                "ChunkedTable needs a ZERO-ARG factory returning a "
                "fresh chunk iterator (replayability); got "
                f"{type(factory).__name__}. Wrap a one-shot generator "
                "in a list of chunks or a real factory.")
        self._factory = factory
        self._schema = schema
        self._num_rows = num_rows
        self.prefetch_depth = max(0, int(prefetch_depth))
        self.label = label
        # derived tables (map / transform_chunked outputs) pass False:
        # only TRUE sources feed the ``decode`` phase histogram, so the
        # overlap math never double-counts a chunk's wall
        self.instrument = bool(instrument)
        self.stats = OOCStats()

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_table(table: DataTable, chunk_rows: int = 65536,
                   prefetch_depth: int = 2) -> "ChunkedTable":
        """Slice an in-memory table into a chunk stream (tests/parity
        baselines — the source data is already materialized)."""
        chunk_rows = max(1, int(chunk_rows))

        def factory():
            for start in range(0, max(len(table), 1), chunk_rows):
                yield table.slice(start, min(start + chunk_rows,
                                             len(table)))

        return ChunkedTable(factory, schema=table.schema,
                            num_rows=len(table),
                            prefetch_depth=prefetch_depth,
                            label="from_table")

    @staticmethod
    def from_generator(factory: Callable[[], Iterable[Any]],
                       num_rows: Optional[int] = None,
                       prefetch_depth: int = 2) -> "ChunkedTable":
        """Wrap a zero-arg factory of DataTable/dict chunks (synthetic
        generators, network readers)."""
        return ChunkedTable(factory, num_rows=num_rows,
                            prefetch_depth=prefetch_depth,
                            label="from_generator")

    @staticmethod
    def from_arrow_ipc(path: str, chunk_rows: Optional[int] = None,
                       columns: Optional[List[str]] = None,
                       prefetch_depth: int = 2) -> "ChunkedTable":
        """Stream record batches from an Arrow IPC file (file or stream
        format), memory-mapped: numeric buffers decode as zero-copy
        views into the mapping, so the OS pages the file in chunk by
        chunk. ``chunk_rows`` re-slices writer-sized batches; string /
        list columns materialize per CHUNK (never the file)."""
        import pyarrow as pa          # hard dep of this source only

        def open_reader(source):
            try:
                return pa.ipc.open_file(source)
            except pa.ArrowInvalid:
                return pa.ipc.open_stream(source)

        def batches(reader):
            if hasattr(reader, "num_record_batches"):   # file format
                for i in range(reader.num_record_batches):
                    yield reader.get_batch(i)
            else:
                yield from reader

        def factory():
            with pa.memory_map(path) as mm:
                reader = open_reader(mm)
                for rb in batches(reader):
                    if columns is not None:
                        rb = rb.select(columns)
                    if chunk_rows is None or rb.num_rows <= chunk_rows:
                        yield _record_batch_to_table(rb)
                        continue
                    for off in range(0, rb.num_rows, chunk_rows):
                        yield _record_batch_to_table(
                            rb.slice(off, min(chunk_rows,
                                              rb.num_rows - off)))

        return ChunkedTable(factory, prefetch_depth=prefetch_depth,
                            label=f"arrow:{path}")

    @staticmethod
    def from_npy(columns: Dict[str, Any], chunk_rows: int = 65536,
                 prefetch_depth: int = 2) -> "ChunkedTable":
        """Chunk memory-mapped ``.npy`` columns: ``columns`` maps
        column name -> path (loaded with ``mmap_mode='r'``) or an
        already-loaded array/memmap. Chunks COPY their slice out of the
        mapping (bounded by chunk_rows; the accounting stays honest)."""
        chunk_rows = max(1, int(chunk_rows))

        def open_cols() -> Dict[str, np.ndarray]:
            out = {}
            for name, src in columns.items():
                out[name] = (np.load(src, mmap_mode="r")
                             if isinstance(src, str) else src)
            return out

        def factory():
            cols = open_cols()
            n = min(len(c) for c in cols.values())
            for start in range(0, max(n, 1), chunk_rows):
                stop = min(start + chunk_rows, n)
                yield DataTable({name: np.array(c[start:stop])
                                 for name, c in cols.items()})

        return ChunkedTable(factory, prefetch_depth=prefetch_depth,
                            label="npy")

    # -- stream access ------------------------------------------------------

    def _instrumented(self) -> Iterator[DataTable]:
        hists = MC.ooc_histograms()
        it = iter(self._factory())
        while True:
            t0 = time.perf_counter()
            try:
                chunk = next(it)
            except StopIteration:
                return
            chunk = _as_table(chunk)
            dt = time.perf_counter() - t0
            if self.instrument:
                hists["decode"].observe(dt * 1e3)
            self.stats.note_chunk(len(chunk), table_nbytes(chunk), dt)
            if self._schema is None:
                self._schema = chunk.schema
            yield chunk

    def chunks(self, prefetch_depth: Optional[int] = None
               ) -> Iterator[DataTable]:
        """Iterate DataTable chunks. With ``prefetch_depth > 0`` the
        decode runs on a worker thread, ``depth`` chunks ahead of the
        consumer; the consumer's actual blocked time lands in the
        ``wait`` phase histogram (near-zero == ingest fully hidden)."""
        depth = (self.prefetch_depth if prefetch_depth is None
                 else max(0, int(prefetch_depth)))
        self.stats.depth = depth
        src = self._instrumented()
        if depth == 0:
            return src
        hists = MC.ooc_histograms()

        def gen():
            feed = ThreadedPrefetcher(src, lambda t: t, depth=depth)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = next(feed)
                    except StopIteration:
                        return
                    hists["wait"].observe(
                        (time.perf_counter() - t0) * 1e3)
                    yield item
            finally:
                feed.close()

        return gen()

    def __iter__(self) -> Iterator[DataTable]:
        return self.chunks()

    # -- metadata -----------------------------------------------------------

    @property
    def schema(self) -> Schema:
        """Schema of the first chunk (peeked lazily, cached)."""
        if self._schema is None:
            self._schema = self.peek().schema
        return self._schema

    def peek(self) -> DataTable:
        """Decode and return the FIRST chunk (fresh pass, nothing
        retained)."""
        for chunk in self._factory():
            return _as_table(chunk)
        raise ValueError(f"empty chunk stream ({self.label})")

    @property
    def num_rows(self) -> Optional[int]:
        """Total rows when known (constructor / a completed
        ``count_rows`` pass); None otherwise — counting may cost a
        full decode pass."""
        return self._num_rows

    def count_rows(self) -> int:
        if self._num_rows is None:
            self._num_rows = sum(
                len(c) for c in self.chunks(prefetch_depth=0))
        return self._num_rows

    # -- derived streams ----------------------------------------------------

    def map(self, fn: Callable[[DataTable], DataTable],
            label: Optional[str] = None) -> "ChunkedTable":
        """Lazy per-chunk transform (must preserve row counts — e.g. a
        fitted stage's ``transform``). The returned table replays
        through ``fn`` on every pass; with prefetch, ``fn`` runs on the
        worker thread, overlapping the consumer."""
        src = self

        def factory():
            for chunk in src.chunks(prefetch_depth=0):
                yield fn(chunk)

        return ChunkedTable(factory, num_rows=self._num_rows,
                            prefetch_depth=self.prefetch_depth,
                            label=label or f"{self.label}|map",
                            instrument=False)

    def as_xy(self, features_col: str = "features",
              label_col: str = "label",
              weight_col: Optional[str] = None) -> Callable:
        """Replayable zero-arg factory of ``(X, y[, w])`` shard tuples
        — the GBDT ``train()`` streaming-ingest shape (chunk-local
        densification only)."""
        src = self

        def factory():
            for t in src.chunks():
                X = features_matrix(t, features_col)
                y = np.asarray(t[label_col], dtype=np.float64)
                if weight_col is not None:
                    yield X, y, np.asarray(t[weight_col], np.float64)
                else:
                    yield X, y

        return factory

    def materialize(self) -> DataTable:
        """Concatenate EVERY chunk into one in-memory DataTable — the
        explicit opt-out of bounded memory (parity baselines, small
        streams). Hot paths never call this."""
        parts = list(self.chunks(prefetch_depth=0))
        if not parts:
            raise ValueError(f"empty chunk stream ({self.label})")
        return DataTable.concat(parts)

    def __repr__(self) -> str:
        n = "?" if self._num_rows is None else self._num_rows
        return (f"ChunkedTable({self.label}, rows={n}, "
                f"prefetch={self.prefetch_depth})")


def _record_batch_to_table(rb) -> DataTable:
    """One Arrow record batch -> DataTable chunk. Numeric/bool columns
    decode via ``to_numpy`` (zero-copy views of the IPC mapping when
    null-free); strings and token lists materialize chunk-locally."""
    cols: Dict[str, Any] = {}
    for name, arr in zip(rb.schema.names, rb.columns):
        import pyarrow.types as pt
        t = arr.type
        if pt.is_floating(t) or pt.is_integer(t) or pt.is_boolean(t):
            try:
                cols[name] = arr.to_numpy(zero_copy_only=True)
            except Exception:  # noqa: BLE001 — nulls: masked copy
                cols[name] = arr.to_numpy(zero_copy_only=False)
        elif pt.is_fixed_size_list(t) and (
                pt.is_floating(t.value_type)
                or pt.is_integer(t.value_type)):
            flat = arr.flatten().to_numpy(zero_copy_only=False)
            cols[name] = flat.reshape(len(arr), t.list_size)
        else:
            cols[name] = arr.to_pylist()
    return DataTable(cols)


def write_arrow_ipc(source, path: str,
                    chunk_rows: Optional[int] = None) -> int:
    """Write a DataTable / ChunkedTable / iterable of chunks to an
    Arrow IPC FILE (the ``from_arrow_ipc`` round-trip, used
    to stage on-disk inputs). Vector columns write as fixed-size lists.
    Returns rows written."""
    import pyarrow as pa

    if isinstance(source, DataTable):
        chunks: Iterable[DataTable] = (
            source.batches(chunk_rows) if chunk_rows else [source])
    elif isinstance(source, ChunkedTable):
        chunks = source.chunks(prefetch_depth=0)
    else:
        chunks = (_as_table(c) for c in source)

    writer = None
    rows = 0
    try:
        for table in chunks:
            arrays, names = [], []
            for name in table.column_names:
                col = table[name]
                if isinstance(col, np.ndarray) and col.ndim == 2:
                    inner = pa.array(col.reshape(-1))
                    arrays.append(pa.FixedSizeListArray.from_arrays(
                        inner, col.shape[1]))
                else:
                    arrays.append(pa.array(
                        col if isinstance(col, np.ndarray)
                        else list(col)))
                names.append(name)
            rb = pa.record_batch(arrays, names=names)
            if writer is None:
                writer = pa.ipc.new_file(path, rb.schema)
            writer.write_batch(rb)
            rows += rb.num_rows
    finally:
        if writer is not None:
            writer.close()
    return rows


def refuse_chunked(table: Any, what: str) -> None:
    """Raise for a ``ChunkedTable`` handed to a stage whose streamed
    path the port does not have yet (the AutoML fits and
    ``SummarizeData``)."""
    if isinstance(table, ChunkedTable):
        raise NotImplementedError(
            f"{what} on a ChunkedTable is not ported yet: ROADMAP.md, "
            f"'Out-of-core ingest'")
