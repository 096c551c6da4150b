"""bm25_topk_segsum must produce identical results to the scatter path."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpurag.core.config import BM25Config
from tpurag.index.inverted import InvertedIndex, _bucket_score
from tpurag.kernels.bm25 import (_gather_candidates, bm25_topk,
                                 bm25_topk_segsum, merge_segsum_full_xla,
                                 segsum_topk_candidates)
from tpurag.kernels.runtime import NEG_INF


def make_args(rng, n=3000, vocab=200, b=6, t=5, p_max=64):
    df = rng.integers(1, p_max, vocab)
    starts_host = np.zeros(vocab + 1, np.int64)
    np.cumsum(df, out=starts_host[1:])
    nnz = int(starts_host[-1])
    # doc ids ascending within each term (as InvertedIndex builds them);
    # tail-padded by p_max like the index build does.
    post_doc = np.full(nnz + p_max, 2**30, np.int32)
    for v in range(vocab):
        s, e = starts_host[v], starts_host[v + 1]
        post_doc[s:e] = np.sort(rng.choice(n, e - s, replace=False))
    post_impact = np.where(
        post_doc < n, rng.uniform(0.5, 2.0, nnz + p_max), 0.0
    ).astype(np.float32)
    dnorm = rng.uniform(0.4, 2.2, n).astype(np.float32)
    tid = rng.integers(0, vocab, (b, t))
    starts = starts_host[tid].astype(np.int32)
    lens = df[tid].astype(np.int32)
    # zero out some term slots (unused)
    lens[:, -1] = 0
    idf = rng.uniform(0.5, 3.0, (b, t)).astype(np.float32)
    return (jnp.asarray(starts), jnp.asarray(lens), jnp.asarray(idf),
            jnp.asarray(post_doc), jnp.asarray(post_impact),
            jnp.asarray(dnorm), jnp.int32(n))


def _assert_topk_close(v1, i1, v2, i2):
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-4)
    # ids may differ on exact ties; compare where scores are distinct
    v = np.asarray(v1)
    distinct = np.abs(v - np.roll(v, 1, axis=1)) > 1e-6
    np.testing.assert_array_equal(
        np.asarray(i1)[distinct], np.asarray(i2)[distinct])


def test_segsum_matches_scatter(rng):
    args = make_args(rng)
    v1, i1 = bm25_topk(*args, k=10, p_max=64)
    st, ln, idf, pd, pi, dn, nv = args
    v2, i2 = bm25_topk_segsum(st, ln, idf, pd, pi, nv, k=10, p_max=64)
    _assert_topk_close(v1, i1, v2, i2)


def test_segsum_duplicate_doc_merge(rng):
    # Same doc in two terms' postings -> contributions must sum.
    starts = jnp.asarray(np.asarray([[0, 2]], np.int32))
    lens = jnp.asarray(np.asarray([[2, 2]], np.int32))
    idf = jnp.asarray(np.asarray([[1.0, 2.0]], np.float32))
    post_doc = jnp.asarray(np.asarray([3, 7, 3, 9, 2**30, 2**30], np.int32))
    post_impact = jnp.asarray(
        np.asarray([1.1, 1.1, 1.1, 1.1, 0.0, 0.0], np.float32))
    v, i = bm25_topk_segsum(starts, lens, idf, post_doc, post_impact,
                            jnp.int32(16), k=3, p_max=2)
    got = {int(d): float(s) for s, d in zip(np.asarray(v)[0], np.asarray(i)[0]) if d >= 0}
    assert abs(got[3] - 3.0 * 1.1) < 1e-5   # idf 1+2
    assert abs(got[7] - 1.1) < 1e-5
    assert abs(got[9] - 2.2) < 1e-5


@pytest.mark.parametrize("t,p_max", [(4, 64), (1, 32), (8, 16)])
def test_segsum_candidates_match_scatter(rng, t, p_max):
    # The index's scoring tail (segsum_topk_candidates over gathered
    # candidates) against the scatter-add oracle, one term slot zeroed.
    args = make_args(rng, t=t, p_max=p_max)
    st, ln, idf, pd, pi, dn, nv = args
    v1, i1 = bm25_topk(*args, k=10, p_max=p_max)
    doc, con = _gather_candidates(st, ln, idf, pd, pi, nv, p_max)
    v2, i2 = segsum_topk_candidates(doc, con, k=10, window=t)
    _assert_topk_close(v1, i1, v2, i2)


def test_segsum_no_hits():
    starts = jnp.asarray(np.zeros((2, 3), np.int32))
    lens = jnp.asarray(np.zeros((2, 3), np.int32))
    idf = jnp.asarray(np.ones((2, 3), np.float32))
    post_doc = jnp.asarray(np.full(8, 2**30, np.int32))
    post_impact = jnp.asarray(np.zeros(8, np.float32))
    v, i = bm25_topk_segsum(starts, lens, idf, post_doc, post_impact,
                            jnp.int32(8), k=3, p_max=4)
    assert np.all(np.asarray(i) == -1)
    assert np.all(np.asarray(v) <= NEG_INF / 2)


def test_inverted_index_segsum_default():
    docs = ["quick fox", "lazy dog", "fox and dog and fox"]
    a = InvertedIndex(BM25Config(width_classes=True))
    b = InvertedIndex(BM25Config(width_classes=False))
    for i, d in enumerate(docs):
        a.add(i, d)
        b.add(i, d)
    sa, ia = a.search(["fox dog"], k=3)
    sb, ib = b.search(["fox dog"], k=3)
    np.testing.assert_allclose(sa, sb, atol=1e-5)
    np.testing.assert_array_equal(ia, ib)


def test_width_classes_match_uniform_padding(rng):
    """Width-classed batching is a pure performance transform: results
    must be identical to padding the whole batch to one width."""
    words = [f"w{i}" for i in range(80)]
    probs = (1.0 / (1 + np.arange(80)) ** 1.1)
    probs /= probs.sum()
    docs = [" ".join(rng.choice(words, size=20, p=probs)) for _ in range(800)]
    a = InvertedIndex(BM25Config(width_classes=True))
    b = InvertedIndex(BM25Config(width_classes=False))
    for i, d in enumerate(docs):
        a.add(i, d)
        b.add(i, d)
    queries = [" ".join(rng.choice(words, size=3, p=probs)) for _ in range(12)]
    sa, ia = a.search(queries, k=10)
    sb, ib = b.search(queries, k=10)
    np.testing.assert_allclose(sa, sb, atol=1e-5)
    np.testing.assert_array_equal(ia, ib)


def test_heads_identical_when_df_small():
    docs = ["alpha beta", "beta gamma", "gamma alpha delta"]
    a = InvertedIndex(BM25Config(head_m=256))
    b = InvertedIndex(BM25Config(exact_scoring=True))
    for i, d in enumerate(docs):
        a.add(i, d)
        b.add(i, d)
    sa, ia = a.search(["alpha gamma"], k=3)
    sb, ib = b.search(["alpha gamma"], k=3)
    np.testing.assert_allclose(sa, sb, atol=1e-5)
    np.testing.assert_array_equal(ia, ib)


def test_max_df_ratio_drops_stopwords():
    docs = [f"the document number {i}" for i in range(10)]
    idx = InvertedIndex(BM25Config(max_df_ratio=0.5))
    for i, d in enumerate(docs):
        idx.add(i, d)
    # 'the' and 'document' appear in every doc -> dropped; 'number' too.
    s, i = idx.search(["the document 3"], k=3)
    assert int(i[0][0]) == 3  # only the distinctive term scores


@pytest.mark.parametrize("t", [1, 2, 4])
def test_merge_segsum_full_matches_numpy(rng, t):
    """Wide-class full rows: docs ascending, each doc's exact sum at its
    segment-end lane, NEG_INF elsewhere; parked lanes stay parked."""
    b, p = 5, 64
    doc = np.full((b, t, p), 2**30, np.int32)
    con = np.zeros((b, t, p), np.float32)
    for r in range(b):
        for j in range(t):
            m = int(rng.integers(0, p))
            doc[r, j, :m] = np.sort(rng.choice(300, m, replace=False))
            con[r, j, :m] = rng.uniform(0.1, 2.0, m)
    seg, doc_s = merge_segsum_full_xla(jnp.asarray(doc.reshape(b, t * p)),
                                       jnp.asarray(con.reshape(b, t * p)),
                                       p=p, t=t)
    seg, doc_s = np.asarray(seg), np.asarray(doc_s)
    assert (np.diff(doc_s, axis=1) >= 0).all()
    for r in range(b):
        want = {}
        for d, c in zip(doc[r].ravel(), con[r].ravel()):
            if d < 2**30:
                want[int(d)] = want.get(int(d), 0.0) + float(c)
        live = seg[r] > NEG_INF / 2
        got = dict(zip(doc_s[r][live].tolist(), seg[r][live].tolist()))
        assert got.keys() == want.keys()
        np.testing.assert_allclose([got[d] for d in sorted(want)],
                                   [want[d] for d in sorted(want)],
                                   rtol=1e-5)


def test_wide_class_bucket_score_matches_numpy(rng):
    """A class at t=8, p_max=4096 (query terms with df > 2048) scores
    through the same sort + segsum tail: exact against per-doc sums."""
    t, p_max, n_terms, g = 8, 4096, 4, 8
    doc_mat = np.full((n_terms + 1, p_max), 2**30, np.int32)
    imp_mat = np.zeros((n_terms + 1, p_max), np.float32)
    for r in range(1, n_terms + 1):
        m = int(rng.integers(2100, p_max))
        doc_mat[r, :m] = np.sort(
            rng.choice(100_000, m, replace=False)).astype(np.int32)
        imp_mat[r, :m] = rng.uniform(0.2, 2.0, m)
    mats = ((jnp.asarray(doc_mat), jnp.asarray(imp_mat)),)
    bucketw = np.full((g, t), p_max, np.int32)
    rowid = rng.integers(1, n_terms + 1, (g, t)).astype(np.int32)
    idf = rng.uniform(0.5, 2.5, (g, t)).astype(np.float32)
    v, i = _bucket_score(jnp.asarray(bucketw), jnp.asarray(rowid),
                         jnp.asarray(idf), mats, k=10, p_max=p_max, t=t,
                         widths=(p_max,))
    scores = np.zeros((g, 100_000), np.float64)
    for r in range(g):
        for j in range(t):
            row = rowid[r, j]
            live = doc_mat[row] < 2**30
            np.add.at(scores[r], doc_mat[row][live],
                      idf[r, j] * imp_mat[row][live].astype(np.float64))
    ev = -np.sort(-scores, axis=1)[:, :10]
    np.testing.assert_allclose(np.asarray(v), ev, rtol=1e-5)
    got = np.take_along_axis(scores, np.asarray(i), axis=1)
    np.testing.assert_allclose(got, ev, rtol=1e-5)
