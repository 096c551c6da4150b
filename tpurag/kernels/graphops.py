"""Device-side graph ops: padded CSR neighbor expansion.

Reference behavior: LightRAG's local/global query modes walk the entity
graph one hop from kNN seed entities (lightrag-hku; surfaced through
lightrag-service/main.py:375-419). On device the adjacency is flat CSR
(neighbor ids + offsets) and the 1-hop expansion is a padded gather —
static shapes (B, K, max_neighbors), -1 beyond each node's degree."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("max_neighbors",))
def expand_neighbors(seed_ids: jax.Array,      # (B, K) int32, -1 = empty
                     nbr_offsets: jax.Array,   # (E+1,) int32 CSR offsets
                     nbr_flat: jax.Array,      # (nnz,) int32 neighbor ids
                     max_neighbors: int):
    """Gather up to max_neighbors 1-hop neighbors per seed entity.

    Returns (B, K, max_neighbors) int32, -1-padded.
    """
    nnz = nbr_flat.shape[0]
    safe = jnp.clip(seed_ids, 0, nbr_offsets.shape[0] - 2)
    start = nbr_offsets[safe]                      # (B, K)
    deg = nbr_offsets[safe + 1] - start
    off = jax.lax.broadcasted_iota(jnp.int32, (*seed_ids.shape, max_neighbors), 2)
    valid = (off < deg[..., None]) & (seed_ids[..., None] >= 0)
    idx = jnp.clip(start[..., None] + off, 0, max(nnz - 1, 0))
    out = nbr_flat[idx]
    return jnp.where(valid, out, -1)


@functools.partial(jax.jit, static_argnames=("max_chunks",))
def gather_chunks(ent_ids: jax.Array,          # (B, M) int32, -1 = empty
                  chunk_offsets: jax.Array,    # (E+1,) int32
                  chunk_flat: jax.Array,       # (nnz,) int32 chunk ids
                  max_chunks: int):
    """Entity ids -> their source chunk ids, (B, M, max_chunks), -1-padded."""
    return expand_neighbors(ent_ids, chunk_offsets, chunk_flat, max_chunks)
