"""PyTorch port: the text stages and the columnar hashing kernels
(``mmlspark_tpu_torch/stages/text.py``) against the JAX package, on the
CPU.

The scenarios of ``tests/test_text.py`` and the hashing cases of
``tests/test_automl.py`` run through both packages on the same inputs.
Tolerance, stated: bitwise everywhere (host numpy in both packages: the
FNV buckets, the counts, the vocabulary order, the IDF weights). The
port's kernels take pyarrow's path when pyarrow imports and a numpy
path when it does not (the card machine has no pyarrow); both are run
here, the second with ``sys.modules["pyarrow"] = None``, and held
bitwise to each other and to the per-row oracle.
"""

import sys

import numpy as np
import pytest

from mmlspark_tpu.core.stage import load_stage as jload_stage
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.stages import text as J

from mmlspark_tpu_torch.core.sparse import CSRMatrix
from mmlspark_tpu_torch.core.stage import load_stage as pload_stage
from mmlspark_tpu_torch.core.table import DataTable as PTable
from mmlspark_tpu_torch.stages import text as P

DOCS = {"text": ["The quick brown fox", "lazy dogs sleep all day",
                 "quick quick fox runs", None, "A an THE dog"],
        "label": [0.0, 1.0, 0.0, 1.0, 0.0]}


def _col_equal(a, b, name):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), name
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    elif type(a).__name__ == "CSRMatrix":
        assert type(b).__name__ == "CSRMatrix" and a.shape == b.shape
        for k in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    else:
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=name)
            else:
                assert x == y, name


def assert_tables_equal(p, j):
    """Bitwise: the same columns in the same order, the same schema and
    the same values."""
    assert p.column_names == j.column_names
    assert p.schema.to_json() == j.schema.to_json()
    for c in j.column_names:
        _col_equal(p[c], j[c], c)


def _tokens(n=120, seed=2, vocab=30):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    rows = [[words[j] for j in rng.integers(0, vocab, ln)]
            for ln in rng.integers(0, 9, n)]
    rows[0] = []
    return rows


# ---------------------------------------------------------------------------
# the stages of tests/test_text.py through both packages
# ---------------------------------------------------------------------------

TOKENIZED = [
    ("Tokenizer", {}),
    ("Tokenizer", {"toLowercase": False, "minTokenLength": 4}),
    ("Tokenizer", {"pattern": r"\w+", "gaps": False}),
]
ON_TOKENS = [
    ("StopWordsRemover", {}),
    ("StopWordsRemover", {"caseSensitive": True}),
    ("StopWordsRemover", {"stopWords": ["quick", "fox"]}),
    ("NGram", {}),
    ("NGram", {"n": 3}),
    ("HashingTF", {"numFeatures": 32}),
    ("HashingTF", {"numFeatures": 32, "binary": True}),
    ("HashingTF", {"numFeatures": 1 << 18, "sparse": True}),
]


@pytest.mark.parametrize("name,kw", TOKENIZED)
def test_tokenizer_matches_jax(name, kw):
    j = getattr(J, name)(inputCol="text", outputCol="toks", **kw) \
        .transform(JTable(DOCS))
    p = getattr(P, name)(inputCol="text", outputCol="toks", **kw) \
        .transform(PTable(DOCS))
    assert_tables_equal(p, j)


def _tokenized(pkg, table):
    return pkg.Tokenizer(inputCol="text", outputCol="toks").transform(table)


@pytest.mark.parametrize("name,kw", ON_TOKENS)
def test_token_stage_matches_jax(name, kw):
    jt, pt = _tokenized(J, JTable(DOCS)), _tokenized(P, PTable(DOCS))
    j = getattr(J, name)(inputCol="toks", outputCol="out", **kw).transform(jt)
    p = getattr(P, name)(inputCol="toks", outputCol="out", **kw).transform(pt)
    assert_tables_equal(p, j)


def test_reference_scenarios_hold_in_the_port():
    t = _tokenized(P, PTable(DOCS))
    assert t["toks"][0] == ["the", "quick", "brown", "fox"]
    assert t["toks"][3] == []
    clean = P.StopWordsRemover(inputCol="toks", outputCol="c").transform(t)
    assert "the" not in clean["c"][0] and "quick" in clean["c"][0]
    tf = P.HashingTF(inputCol="toks", outputCol="tf",
                     numFeatures=32).transform(t)["tf"]
    assert tf[2][P._stable_hash("quick") % 32] == 2.0
    assert P._stable_hash("a") != P._stable_hash("b")


def test_count_vectorizer_and_idf_match_jax():
    jt, pt = _tokenized(J, JTable(DOCS)), _tokenized(P, PTable(DOCS))
    jcv = J.CountVectorizer(inputCol="toks", outputCol="cv", minDF=1).fit(jt)
    pcv = P.CountVectorizer(inputCol="toks", outputCol="cv", minDF=1).fit(pt)
    assert pcv.get("vocabulary") == jcv.get("vocabulary")
    assert pcv.get("vocabulary")[0] == "quick"   # most frequent first
    jt, pt = jcv.transform(jt), pcv.transform(pt)
    assert_tables_equal(pt, jt)
    jidf = J.IDF(inputCol="cv", outputCol="tfidf", minDocFreq=2).fit(jt)
    pidf = P.IDF(inputCol="cv", outputCol="tfidf", minDocFreq=2).fit(pt)
    np.testing.assert_array_equal(pidf.get("idf"), jidf.get("idf"))
    assert_tables_equal(pidf.transform(pt), jidf.transform(jt))


FEATURIZERS = [
    {"numFeatures": 64},
    {"useHashingTF": False, "useIDF": False},
    {"useNGram": True, "nGramLength": 2, "numFeatures": 128},
    {"useStopWordsRemover": True, "numFeatures": 64, "binary": True},
    {"useTokenizer": True, "tokenizerPattern": r"\w+",
     "tokenizerGaps": False, "minDocFreq": 2, "numFeatures": 16},
]


@pytest.mark.parametrize("kw", FEATURIZERS,
                         ids=[str(i) for i in range(len(FEATURIZERS))])
def test_text_featurizer_matches_jax(kw):
    docs = {"text": DOCS["text"][:3] + ["dogs sleep", "fox fox runs"]}
    jm = J.TextFeaturizer(inputCol="text", outputCol="feats", **kw) \
        .fit(JTable(docs))
    pm = P.TextFeaturizer(inputCol="text", outputCol="feats", **kw) \
        .fit(PTable(docs))
    p, j = pm.transform(PTable(docs)), jm.transform(JTable(docs))
    assert "_tf_tokens" not in p.column_names
    assert_tables_equal(p, j)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_text_featurizer_model_crosses_packages(tmp_path, direction):
    docs = {"text": DOCS["text"][:3]}
    path = str(tmp_path / "tf")
    if direction == "jax_to_port":
        J.TextFeaturizer(inputCol="text", outputCol="feats",
                         numFeatures=64).fit(JTable(docs)).save(path)
        loaded = pload_stage(path)
        assert type(loaded).__module__.startswith("mmlspark_tpu_torch.")
    else:
        P.TextFeaturizer(inputCol="text", outputCol="feats",
                         numFeatures=64).fit(PTable(docs)).save(path)
        loaded = jload_stage(path)
        assert type(loaded).__module__.startswith("mmlspark_tpu.")
    ref = J.TextFeaturizer(inputCol="text", outputCol="feats",
                           numFeatures=64).fit(JTable(docs))
    got = loaded.transform((PTable if direction == "jax_to_port"
                            else JTable)(docs))["feats"]
    np.testing.assert_array_equal(got, ref.transform(JTable(docs))["feats"])


# ---------------------------------------------------------------------------
# the columnar kernels, with and without pyarrow
# ---------------------------------------------------------------------------

STRINGS = ([f"tok{i}" for i in range(300)]
           + ["", "héllo", "日本語", "a" * 40, "mixedß1", "\x00nul"])


def test_stable_hash_matches_jax():
    assert [P._stable_hash(s) for s in STRINGS] == \
        [J._stable_hash(s) for s in STRINGS]


def test_vectorized_byte_fnv_matches_scalar_and_jax():
    pa = pytest.importorskip("pyarrow")
    arr = pa.array(STRINGS, type=pa.string())
    got = P._fnv_string_array(arr)
    np.testing.assert_array_equal(got, J._fnv_string_array(arr))
    assert [int(x) for x in got] == [P._stable_hash(s) for s in STRINGS]


def _rowloop_counts(toks, m, binary=False):
    ref = np.zeros((len(toks), m), np.float32)
    for i, row in enumerate(toks):
        for idx, cnt in J._hash_counts(row, m, binary).items():
            ref[i, idx] = cnt
    return ref


@pytest.mark.parametrize("arrow", [True, False], ids=["pyarrow", "numpy"])
@pytest.mark.parametrize("binary", [False, True])
def test_hash_counts_dense_match_jax_and_oracle(arrow, binary, monkeypatch):
    toks = _tokens(n=150, seed=3)
    toks[5] = None
    ref = J.hash_counts_dense(toks, 32, binary)
    if not arrow:
        monkeypatch.setitem(sys.modules, "pyarrow", None)
    got = P.hash_counts_dense(toks, 32, binary)
    np.testing.assert_array_equal(got, _rowloop_counts(toks, 32, binary))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("arrow", [True, False], ids=["pyarrow", "numpy"])
def test_hash_counts_csr_match_jax(arrow, monkeypatch):
    toks = _tokens(n=150, seed=8)
    toks[7] = [1, 2, 1]        # non-string tokens, stringified
    ref = J.hash_counts_csr(toks, 64)
    if not arrow:
        monkeypatch.setitem(sys.modules, "pyarrow", None)
    got = P.hash_counts_csr(toks, 64)
    assert isinstance(got, CSRMatrix) and got.shape == ref.shape
    for k in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))


def test_fallback_flatten_equals_arrow_buckets(monkeypatch):
    toks = _tokens(n=80, seed=4)
    jrows, jbuckets, jn = J._token_buckets(toks, 16)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    assert P._arrow_flatten(toks) is None
    rows, buckets, n = P._token_buckets(toks, 16)
    assert n == jn
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(buckets, jbuckets)


@pytest.mark.parametrize("arrow", [True, False], ids=["pyarrow", "numpy"])
def test_string_codes_match_jax(arrow, monkeypatch):
    levels = ["alpha", "beta", "gamma"]
    vals = ["beta", None, "zeta", "alpha", "gamma", "beta", None]
    ref = J.string_codes(vals, levels)
    ref_mixed = J.string_codes([1, "alpha", 2.0], [2.0, "alpha"])
    if not arrow:
        monkeypatch.setitem(sys.modules, "pyarrow", None)
    got = P.string_codes(vals, levels)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [1, -1, -1, 0, 2, 1, -1])
    np.testing.assert_array_equal(
        P.string_codes([1, "alpha", 2.0], [2.0, "alpha"]), ref_mixed)


def test_large_vocab_kernel_parity(monkeypatch):
    pytest.importorskip("pyarrow")
    monkeypatch.setattr(P, "_VECTOR_HASH_MIN_VOCAB", 8)
    toks = _tokens(n=200, seed=10)
    np.testing.assert_array_equal(P.hash_counts_dense(toks, 32),
                                  _rowloop_counts(toks, 32))


@pytest.mark.parametrize("arrow", [True, False], ids=["pyarrow", "numpy"])
def test_pipelined_ingest_parity(arrow, monkeypatch):
    if not arrow:
        monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setattr(P, "_PIPELINE_ROWS", 16)
    toks = _tokens(n=150, seed=11)
    out = np.empty((150, 32), np.float32)
    got = P.hash_counts_dense(toks, 32, out=out)
    assert got is out
    np.testing.assert_array_equal(got, _rowloop_counts(toks, 32))


def test_pipelined_ingest_falls_back_mid_stream(monkeypatch):
    monkeypatch.setattr(P, "_PIPELINE_ROWS", 16)
    toks = _tokens(n=100, seed=12)
    toks[90] = [1, 2, 1]
    np.testing.assert_array_equal(P.hash_counts_dense(toks, 32),
                                  _rowloop_counts(toks, 32))


def test_hash_memo_consistent_and_bounded(monkeypatch):
    words = [f"memo_port_tok_{i}" for i in range(50)]
    first = P._hash_distinct(words)
    np.testing.assert_array_equal(first, P._hash_distinct(words))
    assert [int(h) for h in first] == [J._stable_hash(w) for w in words]
    monkeypatch.setattr(P, "_HASH_MEMO", {})
    monkeypatch.setattr(P, "_HASH_MEMO_MAX", 10)
    more = [f"memo_bound_{i}" for i in range(40)]
    got = P._hash_distinct(more)
    assert len(P._HASH_MEMO) == 10
    assert [int(h) for h in got] == [J._stable_hash(w) for w in more]


@pytest.mark.parametrize("arrow", [True, False], ids=["pyarrow", "numpy"])
def test_hashing_tf_dense_equals_sparse(arrow, monkeypatch):
    if not arrow:
        monkeypatch.setitem(sys.modules, "pyarrow", None)
    t = PTable({"toks": _tokens(seed=9)})
    dense = P.HashingTF(inputCol="toks", outputCol="tf",
                        numFeatures=32).transform(t)["tf"]
    sparse = P.HashingTF(inputCol="toks", outputCol="tf", numFeatures=32,
                         sparse=True).transform(t)["tf"]
    np.testing.assert_array_equal(dense, sparse.toarray())
