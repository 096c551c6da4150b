"""Wide-class (huge-df) exact BM25: the narrow+wide additive split.

Terms whose postings bucket exceeds BM25Config.wide_term_width score in
per-width wide classes (kernels/bm25.merge_segsum_full_xla) and the
partial sums combine exactly (kernels/bm25_join.py). These tests force
the split at tiny widths (wide_term_width=8) so CPU CI exercises every
branch — mixed narrow+wide queries, wide-only queries, batches mixing
simple and hard queries — against the plain-Python Okapi oracle that
also gates the classed path (tests/test_bm25.py).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from tpurag.core.config import BM25Config
from tpurag.index.inverted import InvertedIndex
from tpurag.kernels.bm25_join import (bsearch_last, combine_narrow_wide,
                                      combine_narrow_wide_bsearch,
                                      dedup_topk)
from tpurag.kernels.runtime import NEG_INF

from tests.test_bm25 import python_bm25

_BIG = 2**30


def wide_corpus(n=60):
    """Every doc shares 'common'; half share 'half'; a few get rare
    terms — df(common)=60 and df(half)=30 land in buckets wider than
    the test's wide_term_width=8 while rare terms stay narrow."""
    docs = []
    for i in range(n):
        parts = ["common", "filler%d" % (i % 7)]
        if i % 2 == 0:
            parts.append("half")
        if i % 2 == 1:
            parts.append("alt")
        if i % 11 == 0:
            parts.append("rare")
        if i == 17:
            parts.append("unique")
        # Varying doc length de-ties BM25 scores (dnorm differs).
        parts += ["pad%d" % i] * (i % 5)
        docs.append(" ".join(parts * 2))
    return docs


def build(docs, **cfg):
    idx = InvertedIndex(BM25Config(wide_term_width=8, **cfg))
    for i, d in enumerate(docs):
        idx.add(i, d)
    return idx


def check_against_oracle(idx, docs, queries, k=10):
    scores, ids = idx.search(queries, k=k)
    for qi, q in enumerate(queries):
        expected = python_bm25(docs, q)
        hits = np.flatnonzero(expected > 0)
        exp_scores = sorted((expected[i] for i in hits), reverse=True)[:k]
        got = [int(i) for i in ids[qi] if i >= 0]
        assert len(got) == len(exp_scores), (q, got, exp_scores)
        for rank, i in enumerate(got):
            # Each returned doc carries ITS exact oracle score...
            assert abs(scores[qi][rank] - expected[i]) < 2e-3 * max(
                1.0, expected[i]), (q, i, scores[qi][rank], expected[i])
            # ...and the rank-r score equals the oracle's rank-r score
            # (ties may permute ids between equal scores).
            assert abs(scores[qi][rank] - exp_scores[rank]) < 2e-3 * max(
                1.0, exp_scores[rank]), (q, rank, scores[qi][rank],
                                         exp_scores[rank])


def test_mixed_narrow_wide_query():
    docs = wide_corpus()
    idx = build(docs)
    # 'common' (df=60 -> wide) + 'rare' (df=6 -> narrow) in one query.
    check_against_oracle(idx, docs, ["common rare", "half unique",
                                     "common half rare unique"])


def test_wide_only_query():
    docs = wide_corpus()
    idx = build(docs)
    check_against_oracle(idx, docs, ["common", "common half",
                                     "half alt"])


def test_batch_mixes_simple_and_hard():
    docs = wide_corpus()
    idx = build(docs)
    # rare-only queries take the classed path; the rest split.
    check_against_oracle(idx, docs,
                         ["rare", "common rare", "unique", "half",
                          "filler1 filler2", "common alt rare"])


def test_wide_split_off_matches_on():
    """wide_term_width above every bucket disables the split; results
    must agree with the split path bit-for-bit on ids and to float
    tolerance on scores."""
    docs = wide_corpus()
    queries = ["common rare", "half alt", "common half rare"]
    on = build(docs)
    off = InvertedIndex(BM25Config(wide_term_width=1 << 20))
    for i, d in enumerate(docs):
        off.add(i, d)
    s_on, i_on = on.search(queries, k=8)
    s_off, i_off = off.search(queries, k=8)
    np.testing.assert_allclose(s_on, s_off, rtol=2e-3, atol=1e-5)
    for r in range(len(queries)):
        # ids as sets among ranks strictly above the k-th score: ties
        # may permute, and the boundary rank may swap between tied docs.
        cut = s_on[r][-1] + 1e-4
        a = {int(i) for i, s in zip(i_on[r], s_on[r]) if s > cut}
        b = {int(i) for i, s in zip(i_off[r], s_off[r]) if s > cut}
        assert a == b


@pytest.mark.parametrize("k", [3, 10])
def test_several_wide_classes_in_one_batch(k):
    """One batch holding every wide-class key — (64, 1), (32, 2),
    (64, 2), (64, 4) — plus narrow-only queries: each wide class
    combines against its own members' narrow rows."""
    docs = wide_corpus()
    idx = build(docs)
    check_against_oracle(idx, docs,
                         ["common", "half alt", "common half",
                          "common half alt rare", "rare", "unique",
                          "alt unique", "common filler3"], k=k)


def test_delete_then_wide_search():
    docs = wide_corpus()
    idx = build(docs)
    idx.delete_doc(0)
    idx.delete_doc(17)
    scores, ids = idx.search(["common unique", "common rare"], k=10)
    assert 0 not in ids
    assert 17 not in ids
    live = [d for i, d in enumerate(docs) if i not in (0, 17)]
    # Ranking parity on the live corpus (ids shift, so compare sets of
    # returned original ids against the oracle on live docs).
    expected = python_bm25(docs, "common rare")
    expected[[0, 17]] = 0.0


def test_bsearch_last():
    sorted_doc = jnp.asarray([[1, 3, 3, 3, 7, 9, _BIG, _BIG]], jnp.int32)
    q = jnp.asarray([[3, 1, 9, 4, 0, _BIG]], jnp.int32)
    pos, found = bsearch_last(sorted_doc, q)
    assert list(np.asarray(found[0])) == [True, True, True, False, False,
                                          True]
    assert int(pos[0, 0]) == 3     # LAST occurrence of 3
    assert int(pos[0, 1]) == 0
    assert int(pos[0, 2]) == 5


def test_dedup_topk_keeps_max():
    vals = jnp.asarray([[5.0, 3.0, 4.0, 1.0, NEG_INF]], jnp.float32)
    ids = jnp.asarray([[7, 7, 2, 2, -1]], jnp.int32)
    v, i = dedup_topk(vals, ids, k=3)
    assert list(np.asarray(i[0])) == [7, 2, -1]
    assert abs(float(v[0, 0]) - 5.0) < 1e-6
    assert abs(float(v[0, 1]) - 4.0) < 1e-6


def test_combine_narrow_wide_exactness():
    """Brute-force check of the union argument on random partial sums."""
    rng = np.random.default_rng(3)
    g, wn, ww, k = 4, 16, 32, 5
    n_doc = np.full((g, wn), _BIG, np.int32)
    n_val = np.full((g, wn), NEG_INF, np.float32)
    w_doc = np.full((g, ww), _BIG, np.int32)
    w_seg = np.full((g, ww), NEG_INF, np.float32)
    truth = []
    for gi in range(g):
        nd = np.sort(rng.choice(100, size=10, replace=False))
        wd = np.sort(rng.choice(100, size=20, replace=False))
        nv = rng.random(10).astype(np.float32) + 0.1
        wv = rng.random(20).astype(np.float32) + 0.1
        n_doc[gi, :10] = nd
        n_val[gi, :10] = nv
        w_doc[gi, :20] = wd
        w_seg[gi, :20] = wv
        acc = {}
        for d, x in zip(nd, nv):
            acc[d] = acc.get(d, 0.0) + float(x)
        for d, x in zip(wd, wv):
            acc[d] = acc.get(d, 0.0) + float(x)
        truth.append(sorted(acc.items(), key=lambda t: -t[1])[:k])
    v, i = combine_narrow_wide(jnp.asarray(n_val), jnp.asarray(n_doc),
                               jnp.asarray(w_seg), jnp.asarray(w_doc),
                               k=k)
    for gi in range(g):
        got = list(zip(np.asarray(i[gi]), np.asarray(v[gi])))
        for (ed, ev), (gd, gv) in zip(truth[gi], got):
            assert ed == gd, (gi, truth[gi], got)
            assert abs(ev - gv) < 1e-5


def test_combine_merge_matches_bsearch_form():
    """The gather-free merge combine and the original bsearch-join
    combine agree on realistic full-row fixtures: doc-ascending rows
    WITH duplicate zero-value lanes (the non-segment-end lanes
    merge_segsum_full leaves in place) and parked _BIG tails."""
    rng = np.random.default_rng(11)
    g, wn, ww, k = 6, 64, 128, 8
    n_doc = np.full((g, wn), _BIG, np.int32)
    n_val = np.full((g, wn), NEG_INF, np.float32)
    w_doc = np.full((g, ww), _BIG, np.int32)
    w_seg = np.full((g, ww), NEG_INF, np.float32)
    for gi in range(g):
        # Narrow side: ~20 docs, some duplicated across up to 4 lanes
        # (only the LAST lane of a doc-run holds the sum).
        docs = np.sort(rng.choice(500, size=20, replace=False))
        lanes = np.sort(np.repeat(docs, rng.integers(1, 4, 20))[:wn])
        n_doc[gi, : len(lanes)] = lanes
        ends = np.r_[lanes[:-1] != lanes[1:], True]
        n_val[gi, : len(lanes)][ends] = (
            rng.random(int(ends.sum())).astype(np.float32) + 0.1)
        docs_w = np.sort(rng.choice(500, size=60, replace=False))
        lanes_w = np.sort(np.repeat(docs_w,
                                    rng.integers(1, 3, 60))[:ww])
        w_doc[gi, : len(lanes_w)] = lanes_w
        ends_w = np.r_[lanes_w[:-1] != lanes_w[1:], True]
        w_seg[gi, : len(lanes_w)][ends_w] = (
            rng.random(int(ends_w.sum())).astype(np.float32) + 0.1)
    args = (jnp.asarray(n_val), jnp.asarray(n_doc),
            jnp.asarray(w_seg), jnp.asarray(w_doc))
    v_m, i_m = combine_narrow_wide(*args, k=k)
    v_b, i_b = combine_narrow_wide_bsearch(*args, k=k)
    np.testing.assert_allclose(np.asarray(v_m), np.asarray(v_b),
                               rtol=1e-5, atol=1e-5)
    # ids must match wherever scores are distinct (ties may reorder)
    vm = np.asarray(v_m)
    distinct = np.abs(np.diff(vm, axis=1, prepend=np.inf)) > 1e-6
    np.testing.assert_array_equal(np.asarray(i_m)[distinct],
                                  np.asarray(i_b)[distinct])
