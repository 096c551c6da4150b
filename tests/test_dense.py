import jax.numpy as jnp
import numpy as np
import pytest

from tpurag.index.dense import DenseIndex, l2_normalize
from tpurag.kernels import dense as dense_mod
from tpurag.kernels.dense import (TRITON_MAX_K, dense_route,
                                  dense_topk_triton, dense_topk_xla)
from tpurag.kernels.runtime import NEG_INF


def make_data(rng, n=500, d=64, b=5):
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q, emb


def np_oracle(q, emb, k):
    scores = q @ emb.T
    ids = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, ids, axis=1), ids


def test_dense_topk_xla_matches_numpy(rng):
    q, emb = make_data(rng)
    vals, ids = dense_topk_xla(jnp.asarray(q), jnp.asarray(emb),
                               jnp.int32(emb.shape[0]), 10)
    ev, ei = np_oracle(q, emb, 10)
    np.testing.assert_allclose(np.asarray(vals), ev, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(ids), ei)


def test_dense_topk_xla_respects_n_valid(rng):
    q, emb = make_data(rng)
    n_valid = 200
    vals, ids = dense_topk_xla(jnp.asarray(q), jnp.asarray(emb),
                               jnp.int32(n_valid), 10)
    assert np.asarray(ids).max() < n_valid
    ev, ei = np_oracle(q, emb[:n_valid], 10)
    np.testing.assert_allclose(np.asarray(vals), ev, atol=1e-5)


def _bf16_data(rng, n, d, b):
    q, emb = make_data(rng, n, d, b)
    return jnp.asarray(q), jnp.asarray(emb, jnp.bfloat16)


def _assert_same_topk(pv, pi, xv, xi):
    xv, xi, pv, pi = map(np.asarray, (xv, xi, pv, pi))
    valid = xv > NEG_INF / 2
    np.testing.assert_array_equal(pi[valid], xi[valid])
    assert np.all(pi[~valid] == -1)
    np.testing.assert_allclose(pv[valid], xv[valid], atol=1e-5)


@pytest.mark.parametrize(
    "b,n,d,k,nv,splits",
    [
        (3, 700, 48, 8, 700, None),     # one query tile, default splits
        (9, 900, 128, 16, 900, None),   # k at the kernel's cap
        (70, 2048, 128, 5, 1500, 3),    # two query tiles, k not pow2
        (7, 300, 64, 8, 300, 2),        # n not a tile multiple: overlap
        (16, 5000, 128, 8, 4777, None),  # n_valid mid-tile masking
        (130, 2500, 96, 5, 2500, 4),    # three query tiles, d % 64 != 0
        (3, 10, 32, 8, 4, 1),           # k > n_valid: sentinel -1 ids
        (9, 257, 130, 3, 200, 2),       # odd d and n, splits past n_valid
    ],
)
def test_dense_topk_triton_matches_xla(rng, b, n, d, k, nv, splits):
    q, emb = _bf16_data(rng, n, d, b)
    xv, xi = dense_topk_xla(q, emb, jnp.int32(nv), k)
    pv, pi = dense_topk_triton(q, emb, jnp.int32(nv), k, splits=splits,
                               interpret=True)
    _assert_same_topk(pv, pi, xv, xi)


def test_dense_topk_triton_ties_prefer_smaller_id(rng):
    # Every row duplicated: each score appears twice and the top-k must
    # keep the smaller id of each pair, as lax.top_k does.
    q, emb = make_data(rng, n=200, d=64, b=4)
    emb = np.concatenate([emb, emb])
    qj, ej = jnp.asarray(q), jnp.asarray(emb, jnp.bfloat16)
    xv, xi = dense_topk_xla(qj, ej, jnp.int32(400), 8)
    pv, pi = dense_topk_triton(qj, ej, jnp.int32(400), 8, splits=3,
                               interpret=True)
    _assert_same_topk(pv, pi, xv, xi)


def test_dense_topk_triton_ignores_rows_past_n_valid(rng):
    # Rows past n_valid hold NaN: no split may let them into the result.
    q, emb = make_data(rng, n=1024, d=64, b=5)
    emb[600:] = np.nan
    qj, ej = jnp.asarray(q), jnp.asarray(emb, jnp.bfloat16)
    xv, xi = dense_topk_xla(qj, ej[:600], jnp.int32(600), 8)
    pv, pi = dense_topk_triton(qj, ej, jnp.int32(600), 8, splits=4,
                               interpret=True)
    _assert_same_topk(pv, pi, xv, xi)


def test_dense_topk_triton_rejects_large_k(rng):
    q, emb = _bf16_data(rng, 256, 32, 2)
    with pytest.raises(ValueError, match="dense_topk_xla"):
        dense_topk_triton(q, emb, jnp.int32(256), TRITON_MAX_K + 1,
                          interpret=True)


@pytest.mark.parametrize(
    "platform_name,dtype,k,route",
    [
        ("gpu", jnp.bfloat16, 8, "triton"),
        ("gpu", jnp.bfloat16, TRITON_MAX_K, "triton"),
        ("gpu", jnp.bfloat16, TRITON_MAX_K + 1, "xla"),   # overfetch paths
        ("gpu", jnp.float32, 8, "xla"),                   # fp32 corpora
        ("cpu", jnp.bfloat16, 8, "xla"),
    ],
)
def test_dense_route(platform_name, dtype, k, route):
    assert dense_route(platform_name, dtype, k) == route


@pytest.mark.parametrize("k,expect_kernel", [(8, True), (32, False)])
def test_dense_topk_gpu_dispatch_never_interprets(rng, monkeypatch, k,
                                                  expect_kernel):
    """On the GPU, dense_topk compiles the kernel (no interpret flag ever
    reaches it) and sends k > TRITON_MAX_K to XLA."""
    calls = []

    def spy(queries, emb, n_valid, kk, **kw):
        calls.append(kw)
        return dense_topk_xla(queries, emb, n_valid, kk)

    monkeypatch.setattr(dense_mod, "platform", lambda: "gpu")
    monkeypatch.setattr(dense_mod, "dense_topk_triton", spy)
    q, emb = _bf16_data(rng, 300, 32, 3)
    v, i = dense_mod.dense_topk(q, emb, jnp.int32(300), k)
    assert i.shape == (3, k)
    assert bool(calls) == expect_kernel
    assert all(not kw.get("interpret", False) for kw in calls)


class TestDenseIndex:
    def test_add_search_roundtrip(self, rng):
        idx = DenseIndex(dim=32, dtype=jnp.float32, capacity=128)
        vecs = rng.standard_normal((50, 32)).astype(np.float32)
        ids = idx.add(vecs)
        assert list(ids) == list(range(50))
        scores, out = idx.search(vecs[7:8], k=1)
        assert int(np.asarray(out)[0, 0]) == 7
        assert float(np.asarray(scores)[0, 0]) == pytest.approx(1.0, abs=1e-5)

    def test_growth(self, rng):
        idx = DenseIndex(dim=16, dtype=jnp.float32, capacity=128)
        for _ in range(5):
            idx.add(rng.standard_normal((100, 16)).astype(np.float32))
        assert len(idx) == 500
        assert idx.capacity >= 500
        q = rng.standard_normal((1, 16)).astype(np.float32)
        scores, ids = idx.search(q, k=10)
        assert np.asarray(ids).min() >= 0

    def test_delete_tombstones(self, rng):
        idx = DenseIndex(dim=16, dtype=jnp.float32)
        vecs = rng.standard_normal((20, 16)).astype(np.float32)
        idx.add(vecs)
        idx.delete([3])
        scores, ids = idx.search(vecs[3:4], k=5)
        assert 3 not in np.asarray(ids)
        assert len(idx) == 19

    def test_save_load(self, rng, tmp_path):
        idx = DenseIndex(dim=24, dtype=jnp.float32)
        vecs = rng.standard_normal((30, 24)).astype(np.float32)
        idx.add(vecs)
        idx.delete([1, 2])
        idx.save(tmp_path / "dense")
        idx2 = DenseIndex.load(tmp_path / "dense")
        assert len(idx2) == 28
        s1, i1 = idx.search(vecs[:3], k=4)
        s2, i2 = idx2.search(vecs[:3], k=4)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), atol=1e-5)

    def test_empty_search(self):
        idx = DenseIndex(dim=8)
        scores, ids = idx.search(np.ones((2, 8), np.float32), k=3)
        assert np.all(np.asarray(ids) == -1)
        assert np.all(np.asarray(scores) <= NEG_INF / 2)

    def test_normalization(self, rng):
        v = rng.standard_normal((4, 8)).astype(np.float32) * 100
        out = np.asarray(l2_normalize(v))
        np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,k", [(768, 100_352, 8), (5, 4096, 16)])
def test_dense_topk_triton_compiled_matches_xla(rng, b, n, k):
    """The kernel as the card compiles it (no interpret mode)."""
    q, emb = _bf16_data(rng, n, 1024, b)
    xv, xi = dense_topk_xla(q, emb, jnp.int32(n - 3), k)
    pv, pi = dense_topk_triton(q, emb, jnp.int32(n - 3), k)
    xv, xi, pv, pi = map(np.asarray, (xv, xi, pv, pi))
    np.testing.assert_allclose(pv, xv, atol=1e-5)
    # ids agree except where two scores sit within fp32 summation noise
    sep = np.abs(np.diff(xv, axis=1)) > 1e-5
    gap = (np.pad(sep, ((0, 0), (1, 0)), constant_values=True)
           & np.pad(sep, ((0, 0), (0, 1)), constant_values=True))
    np.testing.assert_array_equal(pi[gap], xi[gap])
