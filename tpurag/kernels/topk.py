"""Partial top-k with explicit candidate ids.

An unrolled k-step select: each step extracts the row max, breaks ties
toward the smallest id, and masks the winner out. Used where candidate
ids are not column positions — merging per-shard, per-split or
per-segment candidate sets — so the tie-break follows the ids
(value desc, id asc), the order `lax.top_k` gives over a full row.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpurag.kernels.runtime import NEG_INF

_BIG_ID = 2**31 - 1  # python int: inlined as a literal inside kernels


def select_topk(scores: jax.Array, ids: jax.Array, k: int):
    """Top-k of each row of `scores` with explicit candidate `ids`.

    Args:
      scores: (B, N) float32.
      ids: (B, N) int32, unique per row (used for deterministic tie-breaks).
      k: static number of winners.

    Returns:
      (vals, out_ids): each (B, k), sorted descending by score. Once a
      row's real candidates run out, its slots take the NEG_INF lanes'
      ids in id order (callers mask ids where vals <= NEG_INF / 2); a
      winner never comes back, because it is masked below NEG_INF.
    """
    s = scores.astype(jnp.float32)
    vals, outs = [], []
    for _ in range(k):
        m = jnp.max(s, axis=1, keepdims=True)                     # (B, 1)
        is_max = s >= m
        win = jnp.min(jnp.where(is_max, ids, _BIG_ID), axis=1, keepdims=True)
        chosen = ids == win
        vals.append(jnp.maximum(m, NEG_INF))
        outs.append(win)
        s = jnp.where(chosen, -jnp.inf, s)
    return (
        jnp.concatenate(vals, axis=1),
        jnp.concatenate(outs, axis=1),
    )


def merge_topk(vals_a, ids_a, vals_b, ids_b, k: int):
    """Merge two (B, ka)/(B, kb) sorted-or-not candidate sets into top-k."""
    vals = jnp.concatenate([vals_a, vals_b], axis=1)
    ids = jnp.concatenate([ids_a, ids_b], axis=1)
    return select_topk(vals, ids, k)
