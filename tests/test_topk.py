import jax.numpy as jnp
import numpy as np

from tpurag.kernels.runtime import NEG_INF
import pytest

from tpurag.kernels.topk import merge_topk, select_topk


def np_topk(scores, ids, k):
    order = np.lexsort((ids, -scores), axis=1)[:, :k]
    return (
        np.take_along_axis(scores, order, axis=1),
        np.take_along_axis(ids, order, axis=1),
    )


def test_select_topk_matches_numpy(rng):
    b, n, k = 7, 300, 10
    scores = rng.standard_normal((b, n)).astype(np.float32)
    ids = np.tile(np.arange(n, dtype=np.int32), (b, 1))
    vals, out = select_topk(jnp.asarray(scores), jnp.asarray(ids), k)
    ev, ei = np_topk(scores, ids, k)
    np.testing.assert_allclose(np.asarray(vals), ev, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(out), ei)


def test_select_topk_tie_break_smallest_id(rng):
    scores = np.array([[1.0, 1.0, 1.0, 0.5]], np.float32)
    ids = np.array([[5, 2, 9, 1]], np.int32)
    vals, out = select_topk(jnp.asarray(scores), jnp.asarray(ids), 3)
    np.testing.assert_array_equal(np.asarray(out), [[2, 5, 9]])


def test_merge_topk(rng):
    b, k = 4, 6
    va = rng.standard_normal((b, k)).astype(np.float32)
    vb = rng.standard_normal((b, k)).astype(np.float32)
    ia = np.tile(np.arange(k, dtype=np.int32), (b, 1))
    ib = np.tile(np.arange(k, 2 * k, dtype=np.int32), (b, 1))
    vals, ids = merge_topk(jnp.asarray(va), jnp.asarray(ia),
                           jnp.asarray(vb), jnp.asarray(ib), k)
    allv = np.concatenate([va, vb], axis=1)
    alli = np.concatenate([ia, ib], axis=1)
    ev, ei = np_topk(allv, alli, k)
    np.testing.assert_allclose(np.asarray(vals), ev, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(ids), ei)


def test_select_topk_all_neg_inf():
    scores = np.full((2, 8), NEG_INF, np.float32)
    ids = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    vals, out = select_topk(jnp.asarray(scores), jnp.asarray(ids), 3)
    assert np.all(np.asarray(vals) <= NEG_INF / 2)


@pytest.mark.parametrize(
    "b,n,k",
    [(1, 5, 5),      # k == N: full sort
     (3, 7, 3),      # odd widths
     (4, 64, 1),     # k = 1
     (2, 1000, 16),  # wide row
     (9, 33, 13)])   # k not a power of two
def test_select_topk_shapes(rng, b, n, k):
    scores = rng.standard_normal((b, n)).astype(np.float32)
    ids = np.stack([rng.permutation(n) for _ in range(b)]).astype(np.int32)
    vals, out = select_topk(jnp.asarray(scores), jnp.asarray(ids), k)
    ev, ei = np_topk(scores, ids, k)
    np.testing.assert_allclose(np.asarray(vals), ev, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(out), ei)


@pytest.mark.parametrize("levels", [2, 5])
def test_select_topk_many_ties_vs_oracle(rng, levels):
    # Few distinct values: every extraction step resolves a tie by id.
    b, n, k = 6, 200, 12
    scores = rng.integers(0, levels, (b, n)).astype(np.float32)
    ids = np.stack([rng.permutation(5 * n)[:n] for _ in range(b)]
                   ).astype(np.int32)
    vals, out = select_topk(jnp.asarray(scores), jnp.asarray(ids), k)
    ev, ei = np_topk(scores, ids, k)
    np.testing.assert_allclose(np.asarray(vals), ev)
    np.testing.assert_array_equal(np.asarray(out), ei)


def test_select_topk_empty_slots_sink(rng):
    # NEG_INF lanes (empty candidates) rank below every live value.
    scores = rng.standard_normal((3, 20)).astype(np.float32)
    scores[:, ::2] = NEG_INF
    ids = np.tile(np.arange(20, dtype=np.int32), (3, 1))
    vals, out = select_topk(jnp.asarray(scores), jnp.asarray(ids), 12)
    vals, out = np.asarray(vals), np.asarray(out)
    assert (vals[:, :10] > NEG_INF / 2).all()
    assert (out[:, :10] % 2 == 1).all()
    assert (vals[:, 10:] <= NEG_INF / 2).all()


def test_select_topk_never_repeats_a_winner():
    # Two live lanes, k=5: the empty slots take the NEG_INF lanes' ids,
    # never a live winner's id a second time.
    scores = np.full((1, 6), NEG_INF, np.float32)
    scores[0, 4], scores[0, 1] = 2.0, 1.0
    ids = np.array([[50, 10, 60, 70, 5, 80]], np.int32)
    vals, out = select_topk(jnp.asarray(scores), jnp.asarray(ids), 5)
    vals, out = np.asarray(vals), np.asarray(out)
    assert out[0, :2].tolist() == [5, 10]
    assert out[0, 2:].tolist() == [50, 60, 70]
    assert (vals[0, 2:] == np.float32(NEG_INF)).all()


@pytest.mark.parametrize("ka,kb,k", [(4, 9, 6), (8, 8, 16), (3, 5, 1)])
def test_merge_topk_shapes(rng, ka, kb, k):
    b = 5
    va = rng.standard_normal((b, ka)).astype(np.float32)
    vb = rng.standard_normal((b, kb)).astype(np.float32)
    ia = np.tile(np.arange(ka, dtype=np.int32), (b, 1))
    ib = np.tile(np.arange(100, 100 + kb, dtype=np.int32), (b, 1))
    vals, ids = merge_topk(jnp.asarray(va), jnp.asarray(ia),
                           jnp.asarray(vb), jnp.asarray(ib), k)
    ev, ei = np_topk(np.concatenate([va, vb], 1),
                     np.concatenate([ia, ib], 1), k)
    np.testing.assert_allclose(np.asarray(vals), ev, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(ids), ei)


def test_merge_topk_equal_values_across_sets():
    # Equal values in both sets: smaller id wins, whichever set holds it.
    va = np.array([[2.0, 1.0, 1.0, 0.0]], np.float32)
    ia = np.array([[7, 9, 11, 13]], np.int32)
    vb = np.array([[1.0, 1.0, 1.0, -1.0]], np.float32)
    ib = np.array([[3, 8, 10, 1]], np.int32)
    vals, ids = merge_topk(jnp.asarray(va), jnp.asarray(ia),
                           jnp.asarray(vb), jnp.asarray(ib), 4)
    np.testing.assert_allclose(np.asarray(vals)[0], [2.0, 1.0, 1.0, 1.0])
    np.testing.assert_array_equal(np.asarray(ids)[0], [7, 3, 8, 9])
