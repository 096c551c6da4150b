"""Sharded BM25 (shard/bm25.py) parity vs the single-device index on the
virtual 8-device CPU mesh (round-2 verdict item 3 — the reference scales
keyword search as a separate Meilisearch server, meilisearch.ts:27-259)."""

import numpy as np
import pytest

from tpurag.core.config import BM25Config
from tpurag.index.inverted import InvertedIndex
from tpurag.shard.bm25 import ShardedInvertedIndex
from tpurag.shard.mesh import make_mesh

VOCAB = [f"w{i}" for i in range(220)] + ["你好", "世界", "quick", "fox"]


def corpus(rng, n):
    return [" ".join(rng.choice(VOCAB, rng.integers(3, 30)))
            for _ in range(n)]


def build_pair(rng, n=400, batch=True):
    docs = corpus(rng, n)
    single = InvertedIndex(BM25Config())
    mesh = make_mesh([("data", 8)])
    sharded = ShardedInvertedIndex(BM25Config(), mesh=mesh)
    ids = list(range(n))
    if batch:
        single.add_batch(ids, docs)
        sharded.add_batch(ids, docs)
    else:
        for i, t in zip(ids, docs):
            single.add(i, t)
            sharded.add(i, t)
    return single, sharded


QUERIES = ["w1 w2 w17", "quick fox", "你好", "w200", "w3 w3 w9 w120 w44"]


def assert_topk_equivalent(s1, i1, s2, i2, rtol=2e-4):
    """Same scores in order; same id SETS within each tied-score level
    (tie ORDER across implementations is unspecified: the packed merge
    ties by larger doc id, select_topk by smaller)."""
    s1, i1, s2, i2 = map(np.asarray, (s1, i1, s2, i2))
    np.testing.assert_allclose(s1, s2, rtol=rtol, atol=1e-5)
    for b in range(s1.shape[0]):
        # Cluster the (descending) score rows at gaps > tol: within a
        # cluster the two implementations may order ids differently, so
        # compare id SETS per cluster; the final (cutoff) cluster may
        # hold a different tied subset — sizes only.
        row = s1[b]
        gaps = np.where(np.abs(np.diff(row))
                        > 1e-3 * np.maximum(np.abs(row[:-1]), 1.0))[0] + 1
        bounds = [0, *gaps.tolist(), len(row)]
        for ci in range(len(bounds) - 1):
            lo, hi = bounds[ci], bounds[ci + 1]
            a = {int(x) for x in i1[b, lo:hi]}
            c = {int(x) for x in i2[b, lo:hi]}
            if hi == len(row):
                assert len(a) == len(c), (b, lo, hi, a, c)
            else:
                assert a == c, (b, lo, hi, a, c)


def test_sharded_bm25_matches_single(rng):
    single, sharded = build_pair(rng)
    s1, i1 = single.search(QUERIES, k=10)
    s2, i2 = sharded.search(QUERIES, k=10)
    assert_topk_equivalent(s1, i1, s2, i2)


def test_sharded_bm25_device_result_masks_empty_slots(rng):
    # Fewer hits than k: the device-side result (what hybrid fusion
    # reads) must carry -1 in the empty slots, as the single index does,
    # never a hit's id again.
    single, sharded = build_pair(rng)
    q = ["quick fox zzz-unseen"]
    for idx in (single, sharded):
        s, i = idx.search(q, k=400, as_device=True)
        s, i = np.asarray(s)[0], np.asarray(i)[0]
        live = s > -1e38
        assert live.sum() < 400
        assert (i[~live] == -1).all()
        assert len(set(i[live].tolist())) == live.sum()


def test_sharded_bm25_scores_are_global_bm25(rng):
    """Impacts must bake the GLOBAL avgdl and idf the GLOBAL df — a
    shard-local formula would diverge on skewed doc lengths."""
    single = InvertedIndex(BM25Config())
    mesh = make_mesh([("data", 8)])
    sharded = ShardedInvertedIndex(BM25Config(), mesh=mesh)
    # deliberately skewed: long docs land on even ids, short on odd
    for i in range(160):
        text = ("alpha beta " * (30 if i % 2 == 0 else 1)) + f" w{i % 13}"
        single.add(i, text)
        sharded.add(i, text)
    s1, i1 = single.search(["alpha w3", "beta"], k=8)
    s2, i2 = sharded.search(["alpha w3", "beta"], k=8)
    assert_topk_equivalent(s1, i1, s2, i2)


def test_sharded_bm25_deletes_and_tail_adds(rng):
    single, sharded = build_pair(rng, n=300)
    _ = single.search(["w1"], 4)          # freeze main segments
    _ = sharded.search(["w1"], 4)
    # tail adds after the first build
    extra = corpus(rng, 40)
    single.add_batch(range(300, 340), extra)
    sharded.add_batch(range(300, 340), extra)
    # deletes (tombstone + overfetch)
    for d in (3, 17, 301):
        single.delete_doc(d)
        sharded.delete_doc(d)
    # Equal-stats comparison: the single index freezes main-segment
    # impacts until its own compaction policy fires, while the sharded
    # index recompacts parts on mutation — compact the single one so
    # both score with the same (fresh) avgdl/df.
    single.compact()
    s1, i1 = single.search(QUERIES, k=10)
    s2, i2 = sharded.search(QUERIES, k=10)
    assert_topk_equivalent(s1, i1, s2, i2)
    assert 3 not in set(np.asarray(i2).ravel().tolist())


def test_sharded_bm25_empty_and_missing_terms(rng):
    mesh = make_mesh([("data", 8)])
    sharded = ShardedInvertedIndex(BM25Config(), mesh=mesh)
    s, i = sharded.search(["anything"], k=5)
    assert (i == -1).all()
    single, sharded = build_pair(rng, n=64)
    s1, i1 = single.search(["zzz_absent"], k=5)
    s2, i2 = sharded.search(["zzz_absent"], k=5)
    np.testing.assert_array_equal(i1, i2)


def test_sharded_bm25_termless_docs(rng):
    """Docs that tokenize to nothing: layouts are empty but n_docs > 0 —
    search must return empties, not crash."""
    mesh = make_mesh([("data", 8)])
    sharded = ShardedInvertedIndex(BM25Config(), mesh=mesh)
    for i in range(12):
        sharded.add(i, "!!! ???")
    s, i = sharded.search(["anything"], k=4)
    assert (i == -1).all()


def test_mesh_kb_with_sharded_bm25_roundtrip(rng, tmp_path):
    """KnowledgeBase(mesh) wires the sharded keyword leg; hybrid works
    and save/load round-trips the partitioned postings."""
    from tpurag import KnowledgeBase

    mesh = make_mesh([("data", 8)])
    kb = KnowledgeBase("m", dim=64, mesh=mesh)
    assert isinstance(kb.inverted, ShardedInvertedIndex)
    docs = corpus(rng, 96)
    for i, t in enumerate(docs):
        kb.add_document(f"doc{i}", t)
    r = kb.search(docs[7][:30], top_k=5, mode="hybrid")
    assert r.results
    rk = kb.search("quick fox", top_k=5, mode="keyword")
    kb.save(tmp_path / "kb")
    kb2 = KnowledgeBase.load(tmp_path / "kb", mesh=mesh)
    assert isinstance(kb2.inverted, ShardedInvertedIndex)
    rk2 = kb2.search("quick fox", top_k=5, mode="keyword")
    assert [x.chunk_id for x in rk.results] == \
        [x.chunk_id for x in rk2.results]


def test_sharded_bm25_save_load(rng, tmp_path):
    _, sharded = build_pair(rng, n=200)
    base_s, base_i = sharded.search(QUERIES, k=8)
    sharded.save(tmp_path / "sb")
    mesh = make_mesh([("data", 8)])
    re = ShardedInvertedIndex.load(tmp_path / "sb", BM25Config(), mesh=mesh)
    s, i = re.search(QUERIES, k=8)
    np.testing.assert_array_equal(base_i, i)
    np.testing.assert_allclose(base_s, s, rtol=2e-4, atol=1e-5)


def test_mesh_kb_hybrid_ivf_full_probe_parity(rng):
    """mode='hybrid_ivf' on a mesh KB: the sharded IVF dense leg (all
    clusters probed => exhaustive) + sharded BM25 + RRF must rank like
    mode='hybrid' on the same mesh KB."""
    import dataclasses

    from tpurag import KnowledgeBase
    from tpurag.core.config import EngineConfig

    mesh = make_mesh([("data", 8)])
    base = EngineConfig()
    cfg = dataclasses.replace(
        base, ivf=dataclasses.replace(base.ivf, n_lists=8, n_probe=8))
    kb = KnowledgeBase("m-hivf", dim=64, mesh=mesh, config=cfg)
    docs = corpus(rng, 128)
    for i, t in enumerate(docs):
        kb.add_document(f"doc{i}", t)
    kb.build_ivf()
    for q in (docs[7][:30], "quick fox", "你好 世界"):
        a = kb.search(q, top_k=5, mode="hybrid")
        b = kb.search(q, top_k=5, mode="hybrid_ivf")
        assert [r.chunk_id for r in a.results] == \
               [r.chunk_id for r in b.results], q
    # Post-snapshot adds are covered by the tail merge + live BM25 leg.
    kb.add_document("fresh", "zebra stripes gallop " * 4)
    r = kb.search("zebra stripes", top_k=5, mode="hybrid_ivf")
    assert r.results and r.results[0].doc_name == "fresh"
