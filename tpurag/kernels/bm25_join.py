"""Exact narrow+wide BM25 score combination.

BM25 is additive across query terms, so a query's terms can be scored
in independent groups — narrow terms (bucket width <= 2048) through the
sort + segment-sum tail, huge-df terms at their own width through the
wide merge (kernels/bm25.merge_segsum_full_xla) — provided the partial
per-doc sums are combined EXACTLY afterwards. The reference gets this
accuracy from Meilisearch's full-postings scoring
(src/lib/meilisearch.ts:210-244); without the split every term would
pad to the widest term's bucket.

The combine exploits that BOTH group outputs are already doc-ascending
by construction, so no per-lane indexing is needed at all:

1. treat each side as a (doc, contribution) list — valid segment-end
   lanes carry the per-doc partial sum, every other lane contributes 0
   at its existing doc id (keeping the row sorted);
2. one bitonic 2-list merge (kernels/sortmerge.merge_sorted_lists —
   log2(2W) compare-exchange stages of min/max/where);
3. a windowed shift-add segment sum over the merged row: every doc's
   segment-end lane now holds its EXACT narrow+wide total;
4. one top-k. Exactness is direct: every doc present on either side
   gets its true total, so top-k of the totals is the true top-k.

The binary-search join form (suffix _bsearch: log2(Ww) rounds of
take_along_axis + a two-sided top-k union) is kept as the parity-test
reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpurag.kernels.runtime import NEG_INF

_BIG = 2**30


def bsearch_last(sorted_doc: jax.Array, q: jax.Array):
    """Per-row binary search: for each q[g, j], the LAST index i with
    sorted_doc[g, i] == q[g, j] (the segment-end lane), else found=False.

    sorted_doc: (G, W) monotone non-decreasing int32 (parked lanes at
    2^30 sort to the end). q: (G, Q) int32. Returns (pos, found) with
    pos clipped to [0, W). Static log2(W)+1 rounds of gathers."""
    g, w = sorted_doc.shape
    lo = jnp.full(q.shape, -1, jnp.int32)          # doc[lo] <= q invariant
    hi = jnp.full(q.shape, w, jnp.int32)           # doc[hi] > q invariant
    rounds = max(1, (w + 1).bit_length())
    for _ in range(rounds):
        mid = (lo + hi) >> 1
        dv = jnp.take_along_axis(sorted_doc, jnp.clip(mid, 0, w - 1),
                                 axis=1)
        le = dv <= q
        lo = jnp.where(le & (hi - lo > 1), mid, lo)
        hi = jnp.where((~le) & (hi - lo > 1), mid, hi)
    pos = jnp.clip(lo, 0, w - 1)
    dv = jnp.take_along_axis(sorted_doc, pos, axis=1)
    return pos, (lo >= 0) & (dv == q)


def join_add(n_val: jax.Array, n_doc: jax.Array,
             w_seg: jax.Array, w_doc: jax.Array) -> jax.Array:
    """Add each narrow doc's wide partial sum to its narrow partial sum.

    n_val: (G, Wn) narrow per-doc sums at segment-end lanes, NEG_INF
    elsewhere. n_doc: (G, Wn) docs (any order). w_seg/w_doc: (G, Ww)
    wide merge output (doc-sorted; sums at end lanes). Non-end and
    parked narrow lanes stay at ~NEG_INF (adding a finite wide sum to
    NEG_INF cannot lift them into any top-k)."""
    pos, found = bsearch_last(w_doc, n_doc)
    wv = jnp.take_along_axis(w_seg, pos, axis=1)
    return n_val + jnp.where(found & (wv > NEG_INF / 2), wv, 0.0)


def dedup_topk(vals: jax.Array, ids: jax.Array, k: int):
    """Top-k by value over (G, M) lanes with duplicate ids resolved to
    their MAX value (G small-M union rows; M = 3*kk typically). Empty
    lanes: val <= NEG_INF/2 or id < 0."""
    g, m = vals.shape
    ids_s, vals_s = jax.lax.sort((ids, vals), dimension=1, num_keys=2)
    # Ascending (id, val): the last lane of each id-run holds its max.
    nxt = jnp.concatenate(
        [ids_s[:, 1:], jnp.full((g, 1), -2, ids_s.dtype)], axis=1)
    keep = (ids_s != nxt) & (ids_s >= 0) & (vals_s > NEG_INF / 2)
    masked = jnp.where(keep, vals_s, NEG_INF)
    kk = min(k, m)
    v, pos = jax.lax.top_k(masked, kk)
    i = jnp.take_along_axis(ids_s, pos, axis=1)
    empty = v <= NEG_INF / 2
    v = jnp.where(empty, NEG_INF, v)
    i = jnp.where(empty, -1, i)
    if kk < k:
        v = jnp.pad(v, ((0, 0), (0, k - kk)), constant_values=NEG_INF)
        i = jnp.pad(i, ((0, 0), (0, k - kk)), constant_values=-1)
    return v, i


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def window_segsum(doc: jax.Array, con: jax.Array, window: int):
    """Per-doc totals at segment-END lanes over a doc-ascending row
    where each doc spans at most `window` lanes: window-1 shift-adds
    instead of a cumsum + cummax pair (2*log2(W) HBM passes vs ~window;
    at W=128k the scans are ~34 passes while window is <= 12). Returns
    (seg, is_end): seg = total at end lanes, NEG_INF elsewhere."""
    g, w = doc.shape
    nxt = jnp.concatenate(
        [doc[:, 1:], jnp.full((g, 1), -1, doc.dtype)], axis=1)
    is_end = doc != nxt
    total = con
    for j in range(1, min(window, w)):
        dj = jnp.concatenate(
            [jnp.full((g, j), -1, doc.dtype), doc[:, :-j]], axis=1)
        cj = jnp.concatenate(
            [jnp.zeros((g, j), con.dtype), con[:, :-j]], axis=1)
        total = total + jnp.where(dj == doc, cj, 0.0)
    return jnp.where(is_end, total, NEG_INF), is_end


def tiled_topk(seg: jax.Array, doc: jax.Array, k: int,
               tile: int = 4096):
    """Exact top-k over very wide rows in two stages: per-tile top-k
    (the global top-k is a subset of the per-tile winners), then top-k
    of the (G, W/tile * k) survivors — two cheap top_k calls instead of
    one over the full row."""
    g, w = seg.shape
    if w <= 2 * tile or w % tile:
        vals, pos = jax.lax.top_k(seg, k)
        return vals, jnp.take_along_axis(doc, pos, axis=1)
    m = w // tile
    v1, p1 = jax.lax.top_k(seg.reshape(g * m, tile), k)
    i1 = jnp.take_along_axis(doc.reshape(g * m, tile), p1, axis=1)
    v2, p2 = jax.lax.top_k(v1.reshape(g, m * k), k)
    i2 = jnp.take_along_axis(i1.reshape(g, m * k), p2, axis=1)
    return v2, i2


@functools.partial(jax.jit, static_argnames=("k", "window"))
def combine_narrow_wide(n_val, n_doc, w_seg, w_doc, k: int,
                        window: int = 12):
    """Gather-free exact combine -> (G, k) (vals, ids). See the module
    docstring. n_val/n_doc (G, Wn), w_seg/w_doc (G, Ww): doc-ascending
    rows with per-doc partial sums at valid lanes (> NEG_INF/2),
    parked lanes at doc=2^30. `window` bounds how many lanes one doc
    may span on the two sides COMBINED (narrow rows keep up to t_query
    zero-contribution duplicate lanes per doc, wide rows up to their
    class t) — callers pass max_narrow_t + wide_t."""
    from tpurag.kernels.sortmerge import merge_sorted_lists

    g, wn = n_val.shape
    ww = w_seg.shape[1]
    # Valid lanes carry their sum; every other lane contributes 0 at
    # its existing doc id, which keeps both rows doc-ascending.
    cn = jnp.where(n_val > NEG_INF / 2, n_val, 0.0)
    cw = jnp.where(w_seg > NEG_INF / 2, w_seg, 0.0)
    dn, dw = n_doc, w_doc
    p = _next_pow2(max(wn, ww))
    if wn < p:
        dn = jnp.pad(dn, ((0, 0), (0, p - wn)), constant_values=_BIG)
        cn = jnp.pad(cn, ((0, 0), (0, p - wn)))
    if ww < p:
        dw = jnp.pad(dw, ((0, 0), (0, p - ww)), constant_values=_BIG)
        cw = jnp.pad(cw, ((0, 0), (0, p - ww)))
    doc, con = merge_sorted_lists(jnp.stack([dn, dw], axis=1),
                                  jnp.stack([cn, cw], axis=1))
    tot, _ = window_segsum(doc, con, window)
    seg = jnp.where((doc < _BIG) & (tot > 0.0), tot, NEG_INF)
    vals, ids = tiled_topk(seg, doc, k)
    ids = ids.astype(jnp.int32)
    empty = vals <= NEG_INF / 2
    return (jnp.where(empty, NEG_INF, vals),
            jnp.where(empty, -1, ids))


@functools.partial(jax.jit, static_argnames=("k",))
def combine_narrow_wide_bsearch(n_val, n_doc, w_seg, w_doc, k: int):
    """Binary-search-join form (original): joined-narrow top-k ∪
    raw-wide top-2k. Exact (the union argument: joined values are true
    totals so nothing outranks a true-top narrow-match doc; any doc
    outside the wide top-2k has >= 2k docs with larger raw wide sums,
    at most k of which are narrow-match duplicates). Kept as the
    parity-test reference (see module docstring)."""
    joined = join_add(n_val, n_doc, w_seg, w_doc)
    kn = min(k, joined.shape[1])
    jv, jpos = jax.lax.top_k(joined, kn)
    ji = jnp.take_along_axis(n_doc, jpos, axis=1)
    ji = jnp.where(jv > NEG_INF / 2, ji, -1)
    kw = min(2 * k, w_seg.shape[1])
    wv, wpos = jax.lax.top_k(w_seg, kw)
    wi = jnp.take_along_axis(w_doc, wpos, axis=1)
    wi = jnp.where((wv > NEG_INF / 2) & (wi < _BIG), wi, -1)
    return dedup_topk(jnp.concatenate([jv, wv], axis=1),
                      jnp.concatenate([ji, wi], axis=1), k)
