import jax.numpy as jnp
import numpy as np
import pytest

from tpurag.kernels.quant import (dense_topk_q8, dense_topk_xla_q8,
                                  quantize_rows, rescore_topk)
from tpurag.kernels.runtime import NEG_INF


def make_data(rng, n=500, d=64, b=5):
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q, emb


def test_quantize_rows_roundtrip(rng):
    _, emb = make_data(rng, n=64, d=32)
    q8, s = quantize_rows(jnp.asarray(emb))
    deq = np.asarray(q8, np.float32) * np.asarray(s)[:, None]
    # max-abs scale => elementwise error <= scale/2 = max|row|/254
    err = np.abs(deq - emb)
    bound = np.abs(emb).max(axis=1, keepdims=True) / 254 + 1e-7
    assert (err <= bound).all()
    # Zero rows quantize to zeros with zero scale.
    q8z, sz = quantize_rows(jnp.zeros((3, 32)))
    assert np.all(np.asarray(q8z) == 0) and np.all(np.asarray(sz) == 0)


def np_q8_topk(q, emb, n_valid, k):
    """NumPy reference of the int8 scan: per-row max-abs quantization,
    int64 dots, row scales applied after, (value desc, id asc) order."""
    def quant(x):
        m = np.abs(x).max(axis=1)
        s = m / np.float32(127.0)
        q8 = np.clip(np.round(x / np.maximum(s, 1e-30)[:, None]), -127, 127)
        return q8.astype(np.int64), np.where(m > 0, s, 0).astype(np.float32)

    q8, qs = quant(q)
    e8, es = quant(emb)
    raw = (q8 @ e8.T).astype(np.float32) * es[None, :]
    raw[:, n_valid:] = -np.inf
    ids = np.argsort(-raw, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(raw, ids, axis=1) * qs[:, None]
    return vals, ids


@pytest.mark.parametrize(
    "n,d,b,k,nv",
    [(700, 48, 3, 8, 700), (900, 128, 9, 16, 900), (333, 40, 2, 5, 300)])
def test_xla_q8_matches_numpy(rng, n, d, b, k, nv):
    # int32 arithmetic is exact, so the ranking matches the reference.
    q, emb = make_data(rng, n, d, b)
    xv, xi = dense_topk_xla_q8(*quantize_rows(jnp.asarray(q)),
                               *quantize_rows(jnp.asarray(emb)),
                               jnp.int32(nv), k)
    ev, ei = np_q8_topk(q, emb, nv, k)
    assert np.asarray(xi).max() < nv
    np.testing.assert_array_equal(np.asarray(xi), ei)
    np.testing.assert_allclose(np.asarray(xv), ev, rtol=1e-5)


def test_xla_q8_k_past_n_valid_marks_empty(rng):
    # k > n_valid: padding columns come back as id -1, whatever q_scale.
    q, emb = make_data(rng, n=128, d=32, b=3)
    xv, xi = dense_topk_xla_q8(*quantize_rows(jnp.asarray(q)),
                               *quantize_rows(jnp.asarray(emb)),
                               jnp.int32(4), 8)
    xi = np.asarray(xi)
    assert (xi[:, :4] >= 0).all() and (xi[:, 4:] == -1).all()


def test_rescore_topk_exact(rng):
    q, emb = make_data(rng, n=200, d=32, b=4)
    # Candidates = the true top-12 (shuffled) + some noise + a -1 slot.
    scores = q @ emb.T
    top12 = np.argsort(-scores, axis=1)[:, :12]
    cand = np.concatenate([top12[:, ::-1],
                           np.full((4, 1), -1, np.int64),
                           top12[:, :3]], axis=1).astype(np.int32)
    vals, ids = rescore_topk(jnp.asarray(q), jnp.asarray(emb),
                             jnp.asarray(cand), 5)
    exp = np.sort(-scores, axis=1)
    np.testing.assert_allclose(np.asarray(vals), -exp[:, :5], atol=1e-5)
    np.testing.assert_array_equal(np.asarray(ids), top12[:, :5])


def test_q8_rescore_recall_vs_exact(rng):
    # End-to-end: int8 scan + bf16 rescore recovers exact top-10 ids at
    # >= 0.99 recall on a realistic shape (d=1024 normalized gaussians).
    n, d, b, k = 4096, 1024, 16, 10
    q, emb = make_data(rng, n, d, b)
    embj = jnp.asarray(emb)
    e8, es = quantize_rows(embj)
    vals, ids = dense_topk_q8(jnp.asarray(q), e8, es, n, k,
                              rescore_emb=embj)
    exact = np.argsort(-(q @ emb.T), axis=1)[:, :k]
    hits = sum(len(set(np.asarray(ids)[i]) & set(exact[i]))
               for i in range(b))
    recall = hits / (b * k)
    assert recall >= 0.99, recall
    # Rescored scores are exact cosines.
    exp = np.take_along_axis(q @ emb.T, np.asarray(ids), axis=1)
    np.testing.assert_allclose(np.asarray(vals), exp, atol=1e-5)


def test_q8_no_rescore_recall(rng):
    # Pure int8 ranking (no rescore) still lands >= 0.9 recall@10.
    n, d, b, k = 4096, 1024, 16, 10
    q, emb = make_data(rng, n, d, b)
    e8, es = quantize_rows(jnp.asarray(emb))
    _, ids = dense_topk_q8(jnp.asarray(q), e8, es, n, k)
    exact = np.argsort(-(q @ emb.T), axis=1)[:, :k]
    hits = sum(len(set(np.asarray(ids)[i]) & set(exact[i]))
               for i in range(b))
    assert hits / (b * k) >= 0.9


class TestDenseIndexQuant:
    def test_search_matches_exact(self, rng):
        from tpurag.index.dense import DenseIndex

        # fp32 storage on both sides: the rescore computes fp32, so the
        # only possible divergence is an int8 candidate-set miss.
        emb = rng.standard_normal((300, 64)).astype(np.float32)
        idx = DenseIndex(dim=64, dtype=jnp.float32, quant=True)
        idx.add(emb)
        ex = DenseIndex(dim=64, dtype=jnp.float32)
        ex.add(emb)
        q = rng.standard_normal((4, 64)).astype(np.float32)
        sq, iq = idx.search(q, k=5)
        se, ie = ex.search(q, k=5)
        np.testing.assert_array_equal(np.asarray(iq), np.asarray(ie))
        np.testing.assert_allclose(np.asarray(sq), np.asarray(se),
                                   atol=1e-4)

    def test_add_delete_grow_keeps_sidecar_consistent(self, rng):
        from tpurag.index.dense import DenseIndex

        idx = DenseIndex(dim=32, quant=True, capacity=128)
        a = rng.standard_normal((100, 32)).astype(np.float32)
        idx.add(a)
        idx.delete([7])
        idx.add(rng.standard_normal((200, 32)).astype(np.float32))  # grow
        assert idx._q8.shape[0] == idx.capacity
        assert idx._qscale.shape == (idx.capacity,)
        s, ids = idx.search(a[7:8], k=3)
        assert 7 not in np.asarray(ids)
        # Deleted + padding rows carry zero scale.
        assert float(np.asarray(idx._qscale)[7]) == 0.0
        assert np.all(np.asarray(idx._qscale)[idx.n_active:] == 0.0)

    def test_save_load_rebuilds_sidecar(self, rng, tmp_path):
        from tpurag.index.dense import DenseIndex

        idx = DenseIndex(dim=24, quant=True)
        vecs = rng.standard_normal((50, 24)).astype(np.float32)
        idx.add(vecs)
        idx.save(tmp_path / "dq")
        idx2 = DenseIndex.load(tmp_path / "dq", quant=True)
        assert idx2.quant and idx2._q8 is not None
        s1, i1 = idx.search(vecs[:3], k=4)
        s2, i2 = idx2.search(vecs[:3], k=4)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_kb_quant_roundtrip(self, rng, tmp_path):
        from tpurag import KnowledgeBase

        kb = KnowledgeBase("q", dim=64, quant=True)
        kb.add_document("a.md", "alpha beta gamma. " * 30)
        kb.add_document("b.md", "delta epsilon zeta. " * 30)
        r = kb.search("alpha beta", top_k=2, mode="vector")
        assert r.results
        kb.save(tmp_path / "kb")
        kb2 = KnowledgeBase.load(tmp_path / "kb")
        assert kb2.quant and kb2.dense.quant
        r2 = kb2.search("alpha beta", top_k=2, mode="vector")
        assert [x.text for x in r.results] == [x.text for x in r2.results]


def test_rescore_topk_drops_repeated_ids(rng):
    # Candidate lists merged from several sources may repeat an id: the
    # rescore keeps one copy, so the top-k holds k distinct rows.
    q, emb = make_data(rng, n=64, d=32, b=2)
    top = np.argsort(-(q @ emb.T), axis=1)[:, :4].astype(np.int32)
    cand = np.concatenate([top, top, top[:, :2]], axis=1)
    vals, ids = rescore_topk(jnp.asarray(q), jnp.asarray(emb),
                             jnp.asarray(cand), 4)
    np.testing.assert_array_equal(np.asarray(ids), top)


def test_rescore_never_resurrects_padding_rows(rng):
    # m > n_valid: padding columns surface as NEG_INF candidates with
    # REAL in-range ids (they beat the init sentinels on the id
    # tie-break); the rescore must not turn those zero rows into 0.0
    # hits ranked above live rows with negative cosine.
    d, n_valid, k = 32, 5, 6
    emb = np.zeros((128, d), np.float32)
    # 5 live rows, all with NEGATIVE cosine to the query.
    q = np.ones((1, d), np.float32) / np.sqrt(d)
    emb[:n_valid] = -q + 0.01 * rng.standard_normal((n_valid, d))
    emb[:n_valid] /= np.linalg.norm(emb[:n_valid], axis=1, keepdims=True)
    embj = jnp.asarray(emb)
    e8, es = quantize_rows(embj)
    vals, ids = dense_topk_q8(jnp.asarray(q), e8, es, n_valid, k,
                              rescore_emb=embj)
    ids = np.asarray(ids)[0]
    vals = np.asarray(vals)[0]
    live = ids[ids >= 0]
    assert (live < n_valid).all(), f"padding rows resurfaced: {ids}"
    assert (vals[ids >= 0] < 0).all(), vals


def test_sharded_q8_partial_last_shard(rng):
    # n_active far below capacity: every shard's n_local < m.
    from tpurag.shard.mesh import make_mesh
    from tpurag.index.dense import DenseIndex

    mesh = make_mesh([("data", 8)])
    idx = DenseIndex(dim=32, dtype=jnp.float32, mesh=mesh, quant=True,
                     capacity=1024)
    emb = rng.standard_normal((9, 32)).astype(np.float32)
    idx.add(emb)
    s, ids = idx.search(emb[:2], k=4)
    ids = np.asarray(ids)
    assert ids.max() < 9
    assert int(ids[0, 0]) == 0 and int(ids[1, 0]) == 1
