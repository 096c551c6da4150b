"""BM25 scoring on device.

Reference keyword search is an external Meilisearch (Rust) server queried
over HTTP (src/lib/meilisearch.ts:210-244). Here the inverted index lives
on-device as flat CSR arrays and a query batch is scored in one fused XLA
computation.

Design decisions:
- Per-posting BM25 impacts are PRECOMPUTED at index-build time:
  impact[j] = tf_j * (k1+1) / (tf_j + k1*(1 - b + b*dl_j/avgdl)).
  Query-time contribution is just idf_t * impact[j], so scoring needs no
  random per-posting lookups.
- Postings are fetched with contiguous dynamic slices (each term's
  postings are adjacent in the CSR arrays), not element gathers.
- Duplicate-doc merging (a doc matching several query terms) uses
  sort + windowed segment reduction over the (B, T*p_max) candidate
  list. `bm25_topk` is the scatter-add form of the same
  scores, kept as the cross-check oracle.

Docs with zero matching terms come back as id=-1. `p_max` is a static
padding bucket; the index layer buckets to powers of two.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpurag.kernels.runtime import NEG_INF
from tpurag.kernels.sortmerge import merge_sorted_lists

_BIG = 2**30


def _slice_postings(post_doc, post_impact, starts, p_max: int):
    """(B, T) CSR starts -> contiguous (B, T, P) slices of both arrays."""

    def one(s):
        return (
            jax.lax.dynamic_slice(post_doc, (s,), (p_max,)),
            jax.lax.dynamic_slice(post_impact, (s,), (p_max,)),
        )

    return jax.vmap(jax.vmap(one))(starts)


def _gather_candidates(starts, lens, idf, post_doc, post_impact,
                       n_valid, p_max: int):
    """Common head: -> (B, T*P) candidate (doc, contribution) arrays with
    invalid lanes parked at doc=_BIG / contribution=0."""
    b, t = starts.shape
    nnz = post_doc.shape[0]
    safe_starts = jnp.clip(starts, 0, max(nnz - p_max, 0))
    doc, imp = _slice_postings(post_doc, post_impact, safe_starts, p_max)
    off = jax.lax.broadcasted_iota(jnp.int32, (b, t, p_max), 2)
    valid = (off < lens[:, :, None]) & (doc < n_valid)
    contrib = jnp.where(valid, idf[:, :, None] * imp, 0.0)
    doc = jnp.where(valid, doc, _BIG)
    return doc.reshape(b, t * p_max), contrib.reshape(b, t * p_max)


@functools.partial(jax.jit, static_argnames=("k", "p_max"))
def bm25_topk_segsum(
    starts: jax.Array,       # (B, T) int32: postings offset per query term
    lens: jax.Array,         # (B, T) int32: postings length (0 = unused)
    idf: jax.Array,          # (B, T) float32
    post_doc: jax.Array,     # (nnz,) int32, doc-ascending per term
    post_impact: jax.Array,  # (nnz,) float32 precomputed impacts
    n_valid: jax.Array,      # scalar int32
    k: int,
    p_max: int,
):
    """Sort + segment-sum BM25 top-k (the default, scatter-free path)."""
    b, t = starts.shape
    doc, contrib = _gather_candidates(starts, lens, idf, post_doc,
                                      post_impact, n_valid, p_max)
    return segsum_topk_candidates(doc, contrib, k=k, window=t)


@functools.partial(jax.jit, static_argnames=("k", "p_max"))
def bm25_topk(
    starts: jax.Array,
    lens: jax.Array,
    idf: jax.Array,
    post_doc: jax.Array,
    post_impact: jax.Array,
    dnorm_unused,            # kept for signature stability; impacts are baked
    n_valid: jax.Array,
    k: int,
    p_max: int,
):
    """Scatter-add reference path (used for cross-checks)."""
    b, t = starts.shape
    n = int(n_valid) if isinstance(n_valid, int) else None
    doc, contrib = _gather_candidates(starts, lens, idf, post_doc,
                                      post_impact, n_valid, p_max)
    n_rows = dnorm_unused.shape[0] if hasattr(dnorm_unused, "shape") else n
    scores = jnp.zeros((b, n_rows + 1), jnp.float32)
    brow = jax.lax.broadcasted_iota(jnp.int32, doc.shape, 0)
    scores = scores.at[brow.reshape(-1),
                       jnp.minimum(doc, n_rows).reshape(-1)].add(
        contrib.reshape(-1), mode="drop")
    scores = scores[:, :n_rows]
    col = jax.lax.broadcasted_iota(jnp.int32, (b, n_rows), 1)
    scores = jnp.where((col < n_valid) & (scores > 0.0), scores, NEG_INF)
    kk = min(k, n_rows)
    vals, ids = jax.lax.top_k(scores, kk)
    ids = jnp.where(vals <= NEG_INF / 2, -1, ids.astype(jnp.int32))
    if kk < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - kk)), constant_values=NEG_INF)
        ids = jnp.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
    return vals, ids


@functools.partial(jax.jit, static_argnames=("k", "window"))
def segsum_topk_candidates(doc: jax.Array, contrib: jax.Array, k: int,
                           window: int):
    """Sort + segment-sum + top-k over prepared candidates (B, W): doc ids
    with invalid lanes parked at _BIG, contributions >= 0, each doc at
    most `window` times per row (once per query-term slot). The scoring
    tail of every narrow width class (index/inverted.py).

    The per-doc sums are window-1 shift-adds over the doc-sorted row —
    sums of at most `window` terms, exact to fp32 rounding, where a
    cumsum over the whole row would lose digits to cancellation."""
    from tpurag.kernels.bm25_join import window_segsum

    b, w = doc.shape
    doc_s, contrib_s = jax.lax.sort((doc, contrib), dimension=1, num_keys=1)
    seg, _ = window_segsum(doc_s, contrib_s, window)
    seg = jnp.where(doc_s < _BIG, seg, NEG_INF)
    if seg.shape[1] < k:
        pad = k - seg.shape[1]
        seg = jnp.pad(seg, ((0, 0), (0, pad)), constant_values=NEG_INF)
        doc_s = jnp.pad(doc_s, ((0, 0), (0, pad)), constant_values=_BIG)
    vals, pos = jax.lax.top_k(seg, k)
    ids = jnp.take_along_axis(doc_s, pos, axis=1).astype(jnp.int32)
    empty = vals <= 0.0
    return jnp.where(empty, NEG_INF, vals), jnp.where(empty, -1, ids)


def merge_segsum_full_xla(doc: jax.Array, con: jax.Array, p: int,
                          t: int = 1):
    """Wide-class form: (B, W=t*p) candidates whose P-blocks are each
    doc-ascending -> the FULL row (seg, doc_sorted): doc_sorted monotone
    ascending with parked lanes at 2^30, seg the exact per-doc sum at
    each segment-end lane and NEG_INF elsewhere. The doc-sorted row is
    the input of the exact narrow+wide combine (kernels/bm25_join.py).

    Bitonic merge tree over the presorted P-blocks
    (kernels/sortmerge.py — not a full lax.sort) + windowed shift-add
    segment reduction (a doc appears at most once per term list, so t-1
    shift-adds replace the cumsum+cummax pair)."""
    from tpurag.kernels.bm25_join import window_segsum

    b, w = doc.shape
    if t == 1:
        # Already sorted with unique docs: no merge, no segsum.
        return jnp.where(doc < _BIG, con, NEG_INF), doc
    doc_s, con_s = merge_sorted_lists(
        doc.reshape(b, t, p), con.reshape(b, t, p))
    tot, _ = window_segsum(doc_s, con_s, t)
    seg = jnp.where((doc_s < _BIG) & (tot > NEG_INF / 2), tot, NEG_INF)
    return seg, doc_s


def rank_compat(scores: jax.Array) -> jax.Array:
    """Meilisearch returns no scores; the reference converts rank -> score
    as 1/(rank+1) (src/lib/meilisearch.ts:235). Apply over (B, k) top-k
    output, preserving -inf empties."""
    b, k = scores.shape
    rr = 1.0 / (jnp.arange(k, dtype=jnp.float32) + 1.0)
    return jnp.where(scores <= NEG_INF / 2, NEG_INF, jnp.broadcast_to(rr, (b, k)))
