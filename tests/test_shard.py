"""Sharded search on the virtual 8-device CPU mesh (SURVEY.md §4c)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurag.kernels.dense import dense_topk_xla
from tpurag.shard.mesh import make_mesh
from tpurag.shard.search import shard_corpus, sharded_dense_topk


def make_data(rng, n, d, b):
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return jnp.asarray(q), jnp.asarray(emb)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device(rng):
    q, emb = make_data(rng, n=1024, d=64, b=4)
    mesh = make_mesh([("data", 8)])
    emb_sharded = shard_corpus(emb, mesh)
    sv, si = sharded_dense_topk(q, emb_sharded, jnp.int32(1024), 10, mesh=mesh)
    xv, xi = dense_topk_xla(q, emb, jnp.int32(1024), 10)
    np.testing.assert_allclose(np.asarray(sv), np.asarray(xv), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(si), np.asarray(xi))


def test_sharded_respects_global_n_valid(rng):
    # n_valid cuts into the middle of shard 3.
    q, emb = make_data(rng, n=800, d=32, b=3)
    mesh = make_mesh([("data", 8)])
    n_valid = 350
    sv, si = sharded_dense_topk(q, shard_corpus(emb, mesh),
                                jnp.int32(n_valid), 8, mesh=mesh)
    xv, xi = dense_topk_xla(q, emb, jnp.int32(n_valid), 8)
    np.testing.assert_array_equal(np.asarray(si), np.asarray(xi))
    assert np.asarray(si).max() < n_valid


def test_batch_and_data_axes(rng):
    q, emb = make_data(rng, n=512, d=32, b=8)
    mesh = make_mesh([("batch", 2), ("data", 4)])
    emb_sharded = shard_corpus(emb, mesh)
    sv, si = sharded_dense_topk(q, emb_sharded, jnp.int32(512), 5,
                                mesh=mesh, batch_axis="batch")
    xv, xi = dense_topk_xla(q, emb, jnp.int32(512), 5)
    np.testing.assert_array_equal(np.asarray(si), np.asarray(xi))


def test_sharded_bf16_corpus_matches_single(rng):
    # The product storage dtype: per-shard scans of a bf16 corpus merge
    # to the single-device result.
    q, emb = make_data(rng, n=512, d=32, b=2)
    emb = jnp.asarray(emb, jnp.bfloat16)
    mesh = make_mesh([("data", 8)])
    sv, si = sharded_dense_topk(q, shard_corpus(emb, mesh), jnp.int32(512), 4,
                                mesh=mesh)
    xv, xi = dense_topk_xla(q, emb, jnp.int32(512), 4)
    np.testing.assert_array_equal(np.asarray(si), np.asarray(xi))
    np.testing.assert_allclose(np.asarray(sv), np.asarray(xv), atol=1e-6)


def test_sharded_dense_index(rng):
    """DenseIndex with a mesh: adds re-place shards; search merges."""
    import jax.numpy as jnp_

    from tpurag.index.dense import DenseIndex

    mesh = make_mesh([("data", 8)])
    idx = DenseIndex(dim=32, dtype=jnp_.float32, capacity=1024, mesh=mesh)
    vecs = rng.standard_normal((300, 32)).astype(np.float32)
    idx.add(vecs)
    s, i = idx.search(vecs[17:18], k=3)
    assert int(np.asarray(i)[0, 0]) == 17
    # growth across the sharded layout
    idx.add(rng.standard_normal((1200, 32)).astype(np.float32))
    assert idx.capacity % (128 * 8) == 0
    s, i = idx.search(vecs[17:18], k=1)
    assert int(np.asarray(i)[0, 0]) == 17


def test_sharded_kb_end_to_end(rng):
    from tpurag import KnowledgeBase

    mesh = make_mesh([("data", 8)])
    kb = KnowledgeBase("sharded", mesh=mesh)
    kb.add_document("a", "the quick brown fox jumps over the lazy dog")
    kb.add_document("b", "bake bread with flour water salt and yeast")
    r = kb.search("quick brown fox jumps", top_k=2)
    assert r.results and r.results[0].doc_name == "a"


def test_indivisible_corpus_raises(rng):
    q, emb = make_data(rng, n=500, d=32, b=2)
    mesh = make_mesh([("data", 8)])
    with pytest.raises(ValueError):
        sharded_dense_topk(q, emb, jnp.int32(500), 4, mesh=mesh)


class TestShardedQuant:
    def test_q8_rescore_matches_exact(self, rng):
        from tpurag.kernels.quant import quantize_rows
        from tpurag.shard.search import sharded_dense_topk_q8

        q, emb = make_data(rng, n=2048, d=256, b=4)
        mesh = make_mesh([("data", 8)])
        e8, es = quantize_rows(emb)
        sv, si = sharded_dense_topk_q8(
            q, shard_corpus(e8, mesh),
            jax.device_put(es, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("data"))),
            shard_corpus(emb, mesh), jnp.int32(2048), 10, mesh=mesh)
        xv, xi = dense_topk_xla(q, emb, jnp.int32(2048), 10)
        np.testing.assert_array_equal(np.asarray(si), np.asarray(xi))
        np.testing.assert_allclose(np.asarray(sv), np.asarray(xv), atol=1e-4)

    def test_dense_index_mesh_quant(self, rng):
        from tpurag.index.dense import DenseIndex

        mesh = make_mesh([("data", 8)])
        emb = rng.standard_normal((900, 64)).astype(np.float32)
        idx = DenseIndex(dim=64, dtype=jnp.float32, mesh=mesh, quant=True)
        idx.add(emb)
        ex = DenseIndex(dim=64, dtype=jnp.float32)
        ex.add(emb)
        qv = rng.standard_normal((3, 64)).astype(np.float32)
        sq, iq = idx.search(qv, k=6)
        se, ie = ex.search(qv, k=6)
        np.testing.assert_array_equal(np.asarray(iq), np.asarray(ie))
        np.testing.assert_allclose(np.asarray(sq), np.asarray(se), atol=1e-4)
