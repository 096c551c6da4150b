"""Sharded corpus search: per-shard top-k + all-gather merge.

Design (SURVEY.md §2.12/§5.8): shard the chunk axis of the embedding
matrix over the 'data' mesh axis; each device scans only its local rows
(memory-bandwidth-parallel); per-shard top-k candidates — k·(score,id)
pairs, a few KB — are all-gathered and merged on every device. The bytes
on the interconnect are O(B·k·shards), independent of corpus size: the
corpus never moves.

The query batch can additionally shard over a 'batch' axis (data-parallel
query streams); each batch shard runs the same corpus-sharded search.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from tpurag.kernels.dense import dense_topk
from tpurag.kernels.quant import (dense_topk_xla_q8, quantize_rows,
                                  rescore_topk)
from tpurag.kernels.topk import select_topk


def _local_search(q, emb_local, n_valid, k, shard_rows, data_axis):
    """Runs per-device inside shard_map."""
    shard_idx = jax.lax.axis_index(data_axis)
    offset = shard_idx * shard_rows
    n_local = jnp.clip(n_valid - offset, 0, shard_rows)
    vals, ids = dense_topk(q, emb_local, n_local, k)
    gids = jnp.where(ids >= 0, ids + offset, -1)
    # All-gather the tiny candidate sets and merge everywhere.
    all_vals = jax.lax.all_gather(vals, data_axis, axis=1, tiled=True)
    all_ids = jax.lax.all_gather(gids, data_axis, axis=1, tiled=True)
    # Re-unique ids for tie-breaking: -1 empties share an id; map them to
    # distinct sentinels so select_topk stays deterministic.
    pos = jax.lax.broadcasted_iota(jnp.int32, all_ids.shape, 1)
    tb = jnp.where(all_ids >= 0, all_ids, 2**30 + pos)
    vals_k, tb_k = select_topk(all_vals, tb, k)
    return vals_k, jnp.where(tb_k >= 2**30, -1, tb_k)


def _local_search_q8(q, q8, qs, e8_local, es_local, emb_local, n_valid, k,
                     overfetch, shard_rows, data_axis):
    """Quantized per-device search: int8 scan at m = overfetch*k, then an
    exact rescore of the m candidates against the LOCAL full-precision
    rows — the gather never crosses shards, so the only inter-device
    traffic stays the O(B*k*shards) candidate all-gather. Per-shard
    results are exact local top-k (given the int8 pass captures them in
    its top-m), so the merged global top-k matches the exact scan."""
    shard_idx = jax.lax.axis_index(data_axis)
    offset = shard_idx * shard_rows
    n_local = jnp.clip(n_valid - offset, 0, shard_rows)
    m = min(overfetch * k, shard_rows)
    cv, cand = dense_topk_xla_q8(q8, qs, e8_local, es_local, n_local, m)
    del cv  # the q8 scan returns ids == -1 for padding/no-candidate
    vals, ids = rescore_topk(q, emb_local, cand, k)
    gids = jnp.where(ids >= 0, ids + offset, -1)
    all_vals = jax.lax.all_gather(vals, data_axis, axis=1, tiled=True)
    all_ids = jax.lax.all_gather(gids, data_axis, axis=1, tiled=True)
    pos = jax.lax.broadcasted_iota(jnp.int32, all_ids.shape, 1)
    tb = jnp.where(all_ids >= 0, all_ids, 2**30 + pos)
    vals_k, tb_k = select_topk(all_vals, tb, k)
    return vals_k, jnp.where(tb_k >= 2**30, -1, tb_k)


@functools.partial(
    jax.jit,
    static_argnames=("k", "overfetch", "mesh", "data_axis", "batch_axis"),
)
def sharded_dense_topk_q8(
    queries: jax.Array,   # (B, D) float, L2-normalized
    emb_i8: jax.Array,    # (N, D) int8, row-sharded over 'data'
    e_scale: jax.Array,   # (N,) fp32, sharded like emb_i8
    emb: jax.Array,       # (N, D) storage dtype, sharded — rescore source
    n_valid: jax.Array,
    k: int,
    mesh: Mesh,
    overfetch: int = 2,
    data_axis: str = "data",
    batch_axis: Optional[str] = None,
):
    """Corpus-sharded int8 scan + per-shard exact rescore (see
    _local_search_q8). Same contract as sharded_dense_topk."""
    n = emb_i8.shape[0]
    n_shards = mesh.shape[data_axis]
    if n % n_shards:
        raise ValueError(f"corpus rows {n} not divisible by {n_shards} shards")
    shard_rows = n // n_shards
    q8, qs = quantize_rows(queries)
    qspec = P(batch_axis, None)
    fn = shard_map(
        functools.partial(
            _local_search_q8, k=k, overfetch=overfetch,
            shard_rows=shard_rows, data_axis=data_axis),
        mesh=mesh,
        in_specs=(qspec, qspec, P(batch_axis), P(data_axis, None),
                  P(data_axis), P(data_axis, None), P()),
        out_specs=(qspec, qspec),
        check_vma=False,
    )
    return fn(queries.astype(jnp.float32), q8, qs, emb_i8, e_scale,
              emb, jnp.asarray(n_valid, jnp.int32))


@functools.partial(
    jax.jit,
    static_argnames=("k", "mesh", "data_axis", "batch_axis"),
)
def sharded_dense_topk(
    queries: jax.Array,   # (B, D)
    emb: jax.Array,       # (N, D), N divisible by mesh['data']
    n_valid: jax.Array,   # scalar int32 (global row count)
    k: int,
    mesh: Mesh,
    data_axis: str = "data",
    batch_axis: Optional[str] = None,
):
    """Corpus-sharded dense top-k over a device mesh.

    Returns (scores, ids) (B, k), replicated over 'data' (sharded over
    'batch' if batch_axis is given)."""
    n = emb.shape[0]
    n_shards = mesh.shape[data_axis]
    if n % n_shards:
        raise ValueError(f"corpus rows {n} not divisible by {n_shards} shards")
    shard_rows = n // n_shards
    qspec = P(batch_axis, None)
    fn = shard_map(
        functools.partial(
            _local_search, k=k, shard_rows=shard_rows,
            data_axis=data_axis),
        mesh=mesh,
        in_specs=(qspec, P(data_axis, None), P()),
        out_specs=(qspec, qspec),
        check_vma=False,
    )
    return fn(queries, emb, jnp.asarray(n_valid, jnp.int32))


def shard_corpus(emb, mesh: Mesh, data_axis: str = "data"):
    """Place an (N, D) matrix row-sharded over the mesh's data axis."""
    return jax.device_put(emb, NamedSharding(mesh, P(data_axis, None)))
