"""Text featurization pipeline: the PyTorch port's copy of
``mmlspark_tpu/stages/text.py`` (host numpy, no device work).

The reference's text-featurizer (ref:
src/text-featurizer/src/main/scala/TextFeaturizer.scala:179-386): a
one-call Estimator composing tokenize → stop-word removal → n-grams →
hashing-TF or count-vectorize → IDF, plus the individual building-block
stages. Token hashing is the same FNV-1a as the JAX package's, over the
same columnar kernels, so hashed counts and level codes are bitwise
equal to it. The kernels take pyarrow's one-pass flatten / dictionary
encode when pyarrow imports, and a numpy path (``_flatten_tokens``,
``np.unique``) when it does not; both give the same arrays. Hash width
defaults to 2^12 (the reference's 262144 assumed Spark sparse vectors;
``sparse=True`` keeps that width as a CSR column).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.params import (
    BoolParam, HasInputCol, HasOutputCol, IntParam, ListParam, StringParam,
)
from mmlspark_tpu_torch.core.schema import Field, Schema, LIST, VECTOR
from mmlspark_tpu_torch.core.stage import Estimator, Model, Transformer
from mmlspark_tpu_torch.core.table import DataTable

# A small default English stop-word list (the reference delegates to
# SparkML's StopWordsRemover defaults).
DEFAULT_STOP_WORDS = [
    "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
    "in", "into", "is", "it", "no", "not", "of", "on", "or", "such",
    "that", "the", "their", "then", "there", "these", "they", "this",
    "to", "was", "will", "with", "i", "you", "he", "she", "we", "our",
]


class Tokenizer(Transformer, HasInputCol, HasOutputCol):
    """Regex tokenizer (ref: TextFeaturizer tokenizer step)."""

    pattern = StringParam("token-splitting regex", default=r"\s+")
    gaps = BoolParam("pattern matches gaps (True) or tokens (False)",
                     default=True)
    minTokenLength = IntParam("drop shorter tokens", default=1)
    toLowercase = BoolParam("lowercase first", default=True)

    def transform(self, table: DataTable) -> DataTable:
        pat = re.compile(self.get("pattern"))
        min_len = self.get("minTokenLength")
        out = []
        for s in table[self.get_input_col()]:
            if s is None:
                out.append([])
                continue
            if self.get("toLowercase"):
                s = s.lower()
            toks = pat.split(s) if self.get("gaps") else pat.findall(s)
            out.append([t for t in toks if len(t) >= min_len])
        return table.with_column(self.get_output_col(), out,
                                 Field(self.get_output_col(), LIST))

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.add_or_replace(Field(self.get_output_col(), LIST))


class StopWordsRemover(Transformer, HasInputCol, HasOutputCol):
    stopWords = ListParam("words to remove", default=None)
    caseSensitive = BoolParam("case sensitive matching", default=False)

    def transform(self, table: DataTable) -> DataTable:
        words = self.get("stopWords") or DEFAULT_STOP_WORDS
        if not self.get("caseSensitive"):
            stop = {w.lower() for w in words}
            pred = lambda t: t.lower() not in stop  # noqa: E731
        else:
            stop = set(words)
            pred = lambda t: t not in stop  # noqa: E731
        out = [[t for t in toks if pred(t)]
               for toks in table[self.get_input_col()]]
        return table.with_column(self.get_output_col(), out,
                                 Field(self.get_output_col(), LIST))

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.add_or_replace(Field(self.get_output_col(), LIST))


class NGram(Transformer, HasInputCol, HasOutputCol):
    n = IntParam("n-gram length", default=2)

    def transform(self, table: DataTable) -> DataTable:
        n = self.get("n")
        out = []
        for toks in table[self.get_input_col()]:
            out.append([" ".join(toks[i:i + n])
                        for i in range(len(toks) - n + 1)])
        return table.with_column(self.get_output_col(), out,
                                 Field(self.get_output_col(), LIST))

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.add_or_replace(Field(self.get_output_col(), LIST))


class HashingTF(Transformer, HasInputCol, HasOutputCol):
    """Feature hashing to a fixed-width count vector
    (ref: TextFeaturizer numFeatures default 262144 / 2^18; the dense
    default here is 2^12 because a dense 2^18 row is ~1 MB — but set
    ``sparse=True`` for the reference's native behavior: CSR output at
    any width with no dense materialization, the analog of the
    reference's SparseVector output, Featurize.scala:13-19).

    Counting is columnar: all tokens flatten into one array, each
    DISTINCT token hashes once (memoized across calls), and per-row
    bucket counts come out of one vectorized key sort — bit-identical
    to the per-row/per-token dict loop it replaced (counts are small
    integers, exact in float32)."""

    numFeatures = IntParam("hash space size", default=1 << 12)
    binary = BoolParam("presence instead of counts", default=False)
    sparse = BoolParam("emit a CSR sparse column instead of dense rows",
                       default=False)

    def transform(self, table: DataTable) -> DataTable:
        m = self.get("numFeatures")
        binary = self.get("binary")
        out_col = self.get_output_col()
        col = table[self.get_input_col()]
        if self.get("sparse"):
            csr = hash_counts_csr(col, m, binary)
            return table.with_column(
                out_col, csr, Field(out_col, VECTOR, {"sparse": True}))
        arr = hash_counts_dense(col, m, binary)
        return table.with_column(out_col, arr, Field(out_col, VECTOR))

    def transform_schema(self, schema: Schema) -> Schema:
        meta = {"sparse": True} if self.get("sparse") else {}
        return schema.add_or_replace(
            Field(self.get_output_col(), VECTOR, meta))


def _hash_counts(toks, m: int, binary: bool) -> dict:
    """Per-row reference implementation (the pre-vectorization loop).
    Kept as the bit-parity oracle for the columnar kernels below and for
    callers that genuinely hold one row."""
    out: dict = {}
    for t in toks or []:
        idx = _stable_hash(str(t)) % m
        if binary:
            out[idx] = 1.0
        else:
            out[idx] = out.get(idx, 0.0) + 1.0
    return out


def _stable_hash(s: str) -> int:
    """Deterministic across processes (unlike builtin hash)."""
    h = 2166136261
    for ch in s.encode("utf-8"):
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h


# distinct-token hash memo, shared by HashingTF and Featurize's hash
# kind: a token's FNV hash never changes, so repeated transforms (CV
# folds re-featurizing the same corpus) skip the per-character Python
# loop entirely. Bounded so an unbounded-cardinality stream cannot grow
# it without limit — once full, new tokens still hash, just uncached.
_HASH_MEMO: Dict[str, int] = {}
_HASH_MEMO_MAX = 1 << 20


def _hash_distinct(tokens) -> np.ndarray:
    """Hash an iterable of DISTINCT token strings (memoized)."""
    memo = _HASH_MEMO
    out = np.empty(len(tokens), np.int64)
    for i, t in enumerate(tokens):
        h = memo.get(t)
        if h is None:
            h = _stable_hash(t)
            if len(memo) < _HASH_MEMO_MAX:
                memo[t] = h
        out[i] = h
    return out


def _flatten_tokens(token_lists) -> tuple:
    """Token-list column -> (flat token array, row index per token, n).

    The only remaining per-token Python is the append; hashing and
    counting downstream are vectorized over the flat arrays. This is
    the FALLBACK flatten — the hot path goes through arrow
    (``_arrow_flatten``) and never materializes per-token Python."""
    flat: List[str] = []
    lens: List[int] = []
    for toks in token_lists:
        toks = toks if toks is not None else []
        lens.append(len(toks))
        for t in toks:
            flat.append(t if type(t) is str else str(t))
    n = len(lens)
    row_idx = np.repeat(np.arange(n, dtype=np.int64),
                        np.asarray(lens, dtype=np.int64))
    if not flat:
        return np.empty(0, dtype="U1"), row_idx, n
    arr = np.asarray(flat)
    if arr.dtype == object:   # non-str slipped through (paranoia)
        arr = arr.astype(str)
    return arr, row_idx, n


def _arrow_flatten(token_lists):
    """Token-list column -> (flat pyarrow StringArray, per-row token
    counts) in ONE C pass, or None when the fast path does not apply
    (no pyarrow, non-string tokens, None tokens inside a row — the
    fallback stringifies those like the per-row loop always did)."""
    try:
        import pyarrow as pa
    except ImportError:   # the numpy path below gives the same arrays
        return None
    try:
        arr = pa.array(token_lists, type=pa.list_(pa.string()))
    except (pa.lib.ArrowInvalid, pa.lib.ArrowTypeError, TypeError):
        return None
    flat = arr.values
    if flat.null_count:
        return None   # None TOKENS stringify to "None" in the fallback
    offsets = np.asarray(arr.offsets, dtype=np.int64)
    # null ROWS (None token-list): pa.array appends no child values and
    # repeats the offset, so diff() is 0 there — same as the fallback's
    # "None -> []" normalization
    return flat, np.diff(offsets)


def _fnv_string_array(sa) -> np.ndarray:
    """Vectorized ``_stable_hash`` over a pyarrow StringArray: FNV-1a
    straight over the arrow buffer's utf-8 bytes (bit-exact for ANY
    content — multibyte, embedded NUL), grouped by byte length so each
    group runs W fused numpy ops with no padding or masks."""
    V = len(sa)
    offsets_buf, data_buf = sa.buffers()[1], sa.buffers()[2]
    offsets = np.frombuffer(offsets_buf, np.int32,
                            count=V + 1 + sa.offset)[sa.offset:]
    starts = offsets[:-1].astype(np.int64)
    lens = (offsets[1:] - offsets[:-1]).astype(np.int64)
    data = (np.frombuffer(data_buf, np.uint8)
            if data_buf is not None else np.empty(0, np.uint8))
    h = np.full(V, 2166136261, np.uint32)
    prime = np.uint32(16777619)
    for ln in np.unique(lens):
        if ln == 0:
            continue   # FNV("") is the offset basis, already in h
        sel = np.nonzero(lens == ln)[0]
        chars = data[starts[sel][:, None]
                     + np.arange(ln)].astype(np.uint32)
        hh = h[sel]
        for j in range(int(ln)):
            hh = (hh ^ chars[:, j]) * prime
        h[sel] = hh
    return h.astype(np.int64)


# vocabularies up to this size hash through the scalar memo (cross-call
# cache: CV folds re-featurizing the same corpus hash nothing); larger
# ones go through the vectorized byte kernel instead of 1M+ dict probes
_VECTOR_HASH_MIN_VOCAB = 4096


def _buckets_from_flat(flat, m: int) -> np.ndarray:
    """Flat pyarrow StringArray -> per-token hash bucket (int64).

    Dictionary encoding dedups in C, so each DISTINCT token hashes once
    (memoized scalar FNV for small vocabularies, the vectorized byte
    kernel for large ones); the int32 indices come back zero-copy."""
    dic = flat.dictionary_encode()
    vocab = dic.dictionary
    if len(vocab) <= _VECTOR_HASH_MIN_VOCAB:
        hashes = _hash_distinct(vocab.to_pylist())
    else:
        hashes = _fnv_string_array(vocab)
    inv = np.asarray(dic.indices)   # zero-copy int32
    return (hashes % np.int64(m))[inv]


def _token_buckets(token_lists, m: int) -> tuple:
    """Token-list column -> (row_idx, bucket) index arrays + n: every
    token's hash bucket, one entry per token, rows ascending.

    Hot path: ONE pyarrow C pass flattens the column, then
    ``_buckets_from_flat``. Fallback (no pyarrow / non-str / None
    tokens): Python flatten + np.unique vocabulary, same memoized
    hashing."""
    n = len(token_lists)
    fast = _arrow_flatten(token_lists)
    if fast is not None:
        flat, row_lens = fast
        row_idx = np.repeat(np.arange(n, dtype=np.int64), row_lens)
        if len(flat) == 0:
            return row_idx, np.empty(0, np.int64), n
        return row_idx, _buckets_from_flat(flat, m), n
    flat, row_idx, n = _flatten_tokens(token_lists)
    if flat.size == 0:
        return row_idx, np.empty(0, np.int64), n
    vocab, inv = np.unique(flat, return_inverse=True)
    return row_idx, (_hash_distinct(vocab.tolist()) % m)[inv], n


def _hash_key_counts(token_lists, m: int, binary: bool) -> tuple:
    """Shared columnar TF kernel: returns (rows, cols, values, n) with
    one entry per distinct (row, bucket) pair, sorted by row then
    bucket — exactly the CSR layout ``CSRMatrix.from_rows`` produced
    from the per-row dict loop."""
    row_idx, buckets, n = _token_buckets(token_lists, m)
    if len(buckets) == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float32), n)
    keys = row_idx * np.int64(m) + buckets
    uniq_keys, counts = np.unique(keys, return_counts=True)
    rows = uniq_keys // m
    cols = uniq_keys % m
    values = (np.ones(len(uniq_keys), np.float32) if binary
              else counts.astype(np.float32))
    return rows, cols, values, n


def _scatter_counts(row_idx: np.ndarray, buckets: np.ndarray,
                    view: np.ndarray, m: int, binary: bool) -> None:
    """(row, bucket) index arrays -> counts, written over ``view``
    ((rows, m) float32). Per-row-block bincount: row_idx is ascending,
    so each block of rows is one contiguous slice; keys are built
    block-relative on cache-hot slices and the int64 count temp stays
    cache-sized (~2 MB) while the cast writes straight into the view."""
    n = len(view)
    if len(buckets) == 0:
        view[:] = 0.0
        return
    block = max(1, (1 << 18) // m)
    bounds = np.searchsorted(row_idx, np.arange(0, n + block, block))
    for b in range(len(bounds) - 1):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        r0 = b * block
        rows_here = min(block, n - r0)
        keys = (row_idx[lo:hi] - r0) * m + buckets[lo:hi]
        view[r0:r0 + rows_here] = np.bincount(
            keys, minlength=rows_here * m).reshape(rows_here, m)
    if binary:
        np.minimum(view, 1.0, out=view)


def _arrow_string_codes(values, index: Dict[Any, int]
                        ) -> Optional[np.ndarray]:
    """Level codes via ONE pyarrow dictionary-encode pass: a dict probe
    per DISTINCT value, None rows -> -1 with no Python scan. None when
    the fast path does not apply (no pyarrow, non-string values)."""
    try:
        import pyarrow as pa
    except ImportError:   # the numpy path below gives the same arrays
        return None
    try:
        arr = pa.array(values, type=pa.string())
    except (pa.lib.ArrowInvalid, pa.lib.ArrowTypeError, TypeError):
        return None
    dic = arr.dictionary_encode()
    vocab = dic.dictionary.to_pylist()
    lut = np.fromiter((index.get(v, -1) for v in vocab), np.int64,
                      count=len(vocab))
    idx = dic.indices
    if idx.null_count:
        idx = idx.fill_null(len(vocab))     # None rows -> sentinel
        lut = np.append(lut, np.int64(-1))  # sentinel -> -1
    return lut[np.asarray(idx, dtype=np.int64)]


def string_codes(values, levels: List[Any]) -> np.ndarray:
    """Map a string column to level codes (int64; -1 = unseen/None) —
    one dict probe per DISTINCT value (pyarrow dictionary encode, or a
    np.unique LUT without pyarrow). Columns that aren't clean string
    arrays (mixed types) keep the exact per-row dict probe of the
    original loop."""
    index = {v: i for i, v in enumerate(levels)}
    vals = values if isinstance(values, (list, np.ndarray)) \
        else list(values)
    codes = _arrow_string_codes(vals, index)
    if codes is not None:
        return codes
    try:
        arr = np.asarray(vals)
    except Exception:  # noqa: BLE001
        arr = None
    if arr is not None and arr.dtype.kind in ("U", "S") and arr.ndim == 1:
        uniq, inv = np.unique(arr, return_inverse=True)
        lut = np.fromiter((index.get(u, -1) for u in uniq.tolist()),
                          np.int64, count=len(uniq))
        return lut[inv.reshape(-1)]
    return np.fromiter((index.get(v, -1) for v in vals), np.int64,
                       count=len(vals))


# rows per pipeline stage: big enough that arrow/numpy kernels amortize,
# small enough that ~8+ chunks keep both pipeline stages busy on 1M rows
_PIPELINE_ROWS = 1 << 17


def _hash_counts_pipelined(token_lists, m: int, binary: bool,
                           out: np.ndarray) -> bool:
    """Two-stage pipeline over row chunks: the MAIN thread runs the
    GIL-bound python->arrow conversion for chunk k while ONE worker
    thread runs chunk k-1's C-side work (dictionary encode, hashing,
    bincount scatter — all GIL-releasing) into its disjoint row slice
    of ``out``. Returns False (caller redoes the single-shot path) if
    any chunk needs the non-arrow fallback."""
    from concurrent.futures import ThreadPoolExecutor

    n = len(token_lists)

    def work(flat, row_lens, view):
        if len(flat) == 0:
            view[:] = 0.0
            return
        row_idx = np.repeat(np.arange(len(view), dtype=np.int64),
                            row_lens)
        _scatter_counts(row_idx, _buckets_from_flat(flat, m), view, m,
                        binary)

    with ThreadPoolExecutor(1, thread_name_prefix="tf-hash") as pool:
        futs = []
        for a in range(0, n, _PIPELINE_ROWS):
            sub = token_lists[a:a + _PIPELINE_ROWS]
            fast = _arrow_flatten(sub)
            if fast is None:
                for f in futs:
                    f.result()
                return False
            flat, row_lens = fast
            futs.append(pool.submit(work, flat, row_lens,
                                    out[a:a + len(sub)]))
        for f in futs:
            f.result()   # surface worker errors
    return True


def hash_counts_dense(token_lists, m: int, binary: bool = False,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized hashing-TF -> dense (N, m) float32 counts.

    ``out`` (an (N, m) float32 array or view, e.g. a column slice of a
    preassembled features matrix) is fully overwritten when given —
    counts land in place with no (N, m) temporary. Large columns run
    the two-stage ingest pipeline (``_hash_counts_pipelined``)."""
    n = len(token_lists)
    if out is None:
        out = np.empty((n, m), dtype=np.float32)
    if n >= 2 * _PIPELINE_ROWS:
        try:
            sliceable = token_lists[0:0] is not None
        except TypeError:
            sliceable = False
        if sliceable and _hash_counts_pipelined(token_lists, m, binary,
                                                out):
            return out
    row_idx, buckets, _ = _token_buckets(token_lists, m)
    _scatter_counts(row_idx, buckets, out, m, binary)
    return out


def hash_counts_csr(token_lists, m: int, binary: bool = False):
    """Vectorized hashing-TF -> CSRMatrix, never densified (the
    reference's SparseVector path, Featurize.scala:13-19)."""
    from mmlspark_tpu_torch.core.sparse import CSRMatrix
    rows, cols, values, n = _hash_key_counts(token_lists, m, binary)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return CSRMatrix(values, cols.astype(np.int32), indptr, (n, m))


class CountVectorizer(Estimator, HasInputCol, HasOutputCol):
    """Vocabulary-based term counting (TextFeaturizer's non-hashing
    path)."""

    vocabSize = IntParam("max vocabulary size", default=1 << 12)
    minDF = IntParam("min docs containing a term", default=1)

    def fit(self, table: DataTable) -> "CountVectorizerModel":
        df_counts: Dict[str, int] = {}
        tf_totals: Dict[str, int] = {}
        for toks in table[self.get_input_col()]:
            for t in set(toks):
                df_counts[t] = df_counts.get(t, 0) + 1
            for t in toks:
                tf_totals[t] = tf_totals.get(t, 0) + 1
        vocab = [t for t, c in df_counts.items() if c >= self.get("minDF")]
        vocab.sort(key=lambda t: (-tf_totals[t], t))
        vocab = vocab[:self.get("vocabSize")]
        return (CountVectorizerModel(vocabulary=vocab)
                .set("inputCol", self.get_input_col())
                .set("outputCol", self.get_output_col()))


class CountVectorizerModel(Model, HasInputCol, HasOutputCol):
    vocabulary = ListParam("ordered vocabulary", default=None)

    def transform(self, table: DataTable) -> DataTable:
        vocab = self.get("vocabulary") or []
        index = {t: i for i, t in enumerate(vocab)}
        rows = []
        for toks in table[self.get_input_col()]:
            v = np.zeros(len(vocab), dtype=np.float32)
            for t in toks:
                i = index.get(t)
                if i is not None:
                    v[i] += 1.0
            rows.append(v)
        arr = np.stack(rows) if rows else np.zeros((0, len(vocab)),
                                                   np.float32)
        return table.with_column(self.get_output_col(), arr,
                                 Field(self.get_output_col(), VECTOR))

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.add_or_replace(Field(self.get_output_col(), VECTOR))


class IDF(Estimator, HasInputCol, HasOutputCol):
    """Inverse document frequency weighting (ref: TextFeaturizer IDF
    step)."""

    minDocFreq = IntParam("min doc frequency", default=0)

    def fit(self, table: DataTable) -> "IDFModel":
        col = table[self.get_input_col()]
        mat = np.stack([np.asarray(v) for v in col])
        n_docs = mat.shape[0]
        doc_freq = (mat > 0).sum(axis=0)
        idf = np.log((n_docs + 1.0) / (doc_freq + 1.0))
        idf[doc_freq < self.get("minDocFreq")] = 0.0
        return (IDFModel(idf=idf.astype(np.float32))
                .set("inputCol", self.get_input_col())
                .set("outputCol", self.get_output_col()))


class IDFModel(Model, HasInputCol, HasOutputCol):
    from mmlspark_tpu_torch.core.params import ArrayParam as _AP
    idf = _AP("idf weight vector", default=None)

    def transform(self, table: DataTable) -> DataTable:
        idf = np.asarray(self.get("idf"))
        col = table[self.get_input_col()]
        mat = np.stack([np.asarray(v) for v in col]) * idf[None, :]
        return table.with_column(self.get_output_col(),
                                 mat.astype(np.float32),
                                 Field(self.get_output_col(), VECTOR))

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.add_or_replace(Field(self.get_output_col(), VECTOR))


class TextFeaturizer(Estimator, HasInputCol, HasOutputCol):
    """One-call text → feature-vector pipeline
    (ref: TextFeaturizer.scala:179 — the param surface mirrors the
    reference: useTokenizer/useStopWordsRemover/useNGram/useIDF,
    numFeatures, nGramLength, binary, etc.)."""

    useTokenizer = BoolParam("tokenize strings", default=True)
    tokenizerPattern = StringParam("token regex", default=r"\s+")
    tokenizerGaps = BoolParam("regex matches gaps", default=True)
    minTokenLength = IntParam("min token length", default=1)
    toLowercase = BoolParam("lowercase", default=True)
    useStopWordsRemover = BoolParam("remove stop words", default=False)
    stopWords = ListParam("stop words (None = default list)", default=None)
    caseSensitiveStopWords = BoolParam("case sensitive", default=False)
    useNGram = BoolParam("add n-grams", default=False)
    nGramLength = IntParam("n-gram length", default=2)
    useHashingTF = BoolParam("hashingTF (True) or countVectorizer",
                             default=True)
    numFeatures = IntParam("hash space size", default=1 << 12)
    binary = BoolParam("binary term counts", default=False)
    vocabSize = IntParam("count-vectorizer vocab size", default=1 << 12)
    minDF = IntParam("count-vectorizer min doc freq", default=1)
    useIDF = BoolParam("apply IDF weighting", default=True)
    minDocFreq = IntParam("IDF min doc freq", default=1)

    def fit(self, table: DataTable) -> "TextFeaturizerModel":
        from mmlspark_tpu_torch.core.stage import Pipeline
        col = self.get_input_col()
        stages: List[Any] = []
        cur = col
        if self.get("useTokenizer"):
            stages.append(Tokenizer(
                inputCol=cur, outputCol="_tf_tokens",
                pattern=self.get("tokenizerPattern"),
                gaps=self.get("tokenizerGaps"),
                minTokenLength=self.get("minTokenLength"),
                toLowercase=self.get("toLowercase")))
            cur = "_tf_tokens"
        if self.get("useStopWordsRemover"):
            stages.append(StopWordsRemover(
                inputCol=cur, outputCol="_tf_nostop",
                stopWords=self.get_or_none("stopWords"),
                caseSensitive=self.get("caseSensitiveStopWords")))
            cur = "_tf_nostop"
        if self.get("useNGram"):
            stages.append(NGram(inputCol=cur, outputCol="_tf_ngrams",
                                n=self.get("nGramLength")))
            cur = "_tf_ngrams"
        if self.get("useHashingTF"):
            stages.append(HashingTF(
                inputCol=cur, outputCol="_tf_tf",
                numFeatures=self.get("numFeatures"),
                binary=self.get("binary")))
        else:
            stages.append(CountVectorizer(
                inputCol=cur, outputCol="_tf_tf",
                vocabSize=self.get("vocabSize"), minDF=self.get("minDF")))
        cur = "_tf_tf"
        if self.get("useIDF"):
            stages.append(IDF(inputCol=cur, outputCol=self.get_output_col(),
                              minDocFreq=self.get("minDocFreq")))
        else:
            stages.append(RenameTo(inputCol=cur,
                                   outputCol=self.get_output_col()))
        fitted = Pipeline(stages).fit(table)
        temp = [c for c in ("_tf_tokens", "_tf_nostop", "_tf_ngrams",
                            "_tf_tf") if c != self.get_output_col()]
        return TextFeaturizerModel(pipeline=fitted, tempCols=temp)


class RenameTo(Transformer, HasInputCol, HasOutputCol):
    """Internal: copy a column under a new name."""

    def transform(self, table: DataTable) -> DataTable:
        return table.with_column(self.get_output_col(),
                                 table[self.get_input_col()])


class TextFeaturizerModel(Model):
    from mmlspark_tpu_torch.core.params import StageParam as _SP
    pipeline = _SP("fitted internal pipeline", default=None)
    tempCols = ListParam("intermediate columns to drop", default=None)

    def transform(self, table: DataTable) -> DataTable:
        out = self.get("pipeline").transform(table)
        for c in self.get("tempCols") or []:
            if c in out:
                out = out.drop(c)
        return out
