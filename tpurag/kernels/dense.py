"""Dense cosine-similarity + top-k.

The reference computes brute-force cosine over every chunk embedding in
JavaScript, materializing all scores (src/lib/hybrid-search.ts:217-247,
src/lib/github/module-graph-builder.ts:514-529). Embeddings and queries
are pre-normalized by the index layer, so the dot product IS the cosine
score. Two forms, one contract:

- `dense_topk_xla`: one matmul writes the whole (B, N) fp32 score matrix,
  then `lax.top_k` reads it back. The reference for every other form and
  the path for fp32 corpora and large k.
- `dense_topk_triton`: a Pallas kernel compiled through Triton for the
  GPU. The grid is (query tile, corpus split); each program loops over
  its corpus slice in tiles, runs a bf16 tensor-core product with fp32
  accumulation, and folds each tile into a per-query top-k held in
  registers — the score matrix never reaches device memory. Programs
  write (B, splits*kp) candidates that XLA merges with `select_topk`.

`dense_topk` routes between them (`dense_route`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tpurag.kernels.runtime import (NEG_INF, cdiv, next_pow2, pad_axis,
                                    platform, round_up)
from tpurag.kernels.topk import select_topk

_BIG_ID = 2**30
# Largest k the Triton kernel takes: its k extraction passes per tile grow
# with k, and overfetching callers (tombstones, quant rescoring) ask for
# more than the interactive top-8.
TRITON_MAX_K = 16
_BQ = 64                 # query rows per program (one wgmma M tile)
# Corpus rows per tile, feature columns per dot, warps and pipeline
# stages: the best of a sweep on an H100 at 100k x 1024 (b=768) and
# 1M x 1024 (b=512) over 64/128/256-row tiles, 4/8 warps, 2/3 stages.
_TILE_N, _BLOCK_D, _NUM_WARPS, _NUM_STAGES = 128, 64, 4, 3
# Programs to keep in flight: two per SM of an H100 (132 SMs), so the
# corpus splits fill the card even at a few query tiles.
_PROGRAMS_IN_FLIGHT = 264


@functools.partial(jax.jit, static_argnames=("k",))
def dense_topk_xla(queries: jax.Array, emb: jax.Array, n_valid: jax.Array, k: int):
    """Oracle: full (B, N) scores via one matmul, then lax.top_k.

    Args:
      queries: (B, D), L2-normalized.
      emb: (N, D), L2-normalized, any float dtype.
      n_valid: scalar int32 — rows of emb beyond this are padding.
      k: static top-k.

    Returns:
      (scores, ids): (B, k) float32 descending, (B, k) int32.
    """
    scores = jax.lax.dot_general(
        queries.astype(emb.dtype),
        emb,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    col = jax.lax.broadcasted_iota(jnp.int32, scores.shape, 1)
    scores = jnp.where(col < n_valid, scores, NEG_INF)
    vals, ids = jax.lax.top_k(scores, k)
    return vals, ids.astype(jnp.int32)


def dense_route(platform_name: str, dtype, k: int) -> str:
    """'triton' for a bf16 corpus at k <= TRITON_MAX_K on the GPU, else
    'xla'. Interpret mode is never a route: only tests ask for it."""
    if (platform_name == "gpu" and jnp.dtype(dtype) == jnp.bfloat16
            and k <= TRITON_MAX_K):
        return "triton"
    return "xla"


def _dense_topk_triton_kernel(nv_ref, q_ref, e_ref, ov_ref, oi_ref, *,
                              k: int, kp: int, tile_n: int, block_d: int,
                              dp: int, tiles_per_split: int, n_rows: int):
    """One (query tile, corpus split) program.

    The running set (rv, ri) holds kp >= k slots. A tile's j-th best
    candidate replaces the set's worst slot when it beats it; a tile
    stops after k passes or as soon as no row's best beats its worst
    slot. Every global top-k row enters its slice's set and is never
    evicted (k others would have to beat it), so the merged slices are
    exact. Ties keep the smaller id: argmax takes the lowest lane, tiles
    run in id order, and among equal worst slots the largest id goes.

    A tile that would run past the last row is read from n_rows - tile_n
    instead, and the rows it shares with the tile before are masked, so
    the corpus is never padded."""
    i = pl.program_id(0)
    s = pl.program_id(1)
    n_valid = jnp.minimum(nv_ref[0], n_rows)
    row_lo = s * (tiles_per_split * tile_n)
    live = jnp.maximum(n_valid - row_lo, 0)
    n_tiles = jnp.minimum(jax.lax.div(live + (tile_n - 1), tile_n),
                          tiles_per_split)
    q_rows = pl.ds(i * _BQ, _BQ)
    lane = jnp.arange(tile_n, dtype=jnp.int32)

    def tile(t, carry):
        rv, ri = carry
        r0 = row_lo + t * tile_n
        rs = jnp.minimum(r0, n_rows - tile_n)       # first row read

        def dchunk(c, acc):
            d0 = pl.multiple_of(c * block_d, block_d)
            qd = q_ref[q_rows, pl.ds(d0, block_d)]
            ed = e_ref[pl.ds(rs, tile_n), pl.ds(d0, block_d)]
            return acc + pl.dot(qd, ed, trans_b=True)

        acc = jax.lax.fori_loop(0, dp // block_d, dchunk,
                                jnp.zeros((_BQ, tile_n), jnp.float32))
        row = rs + lane
        sc = jnp.where(((row >= r0) & (row < n_valid))[None, :], acc, NEG_INF)

        def improves(c):
            j, sc, rv, _ = c
            gain = jnp.max(sc, axis=1) > jnp.min(rv, axis=1)
            return (j < k) & (jnp.max(gain.astype(jnp.int32)) > 0)

        def extract(c):
            j, sc, rv, ri = c
            m = jnp.max(sc, axis=1)
            a = jax.lax.argmax(sc, 1, jnp.int32)
            rmin = jnp.min(rv, axis=1)
            evict = jnp.max(jnp.where(rv == rmin[:, None], ri, -1), axis=1)
            put = (ri == evict[:, None]) & (m > rmin)[:, None]
            rv = jnp.where(put, m[:, None], rv)
            ri = jnp.where(put, (rs + a)[:, None], ri)
            sc = jnp.where(lane[None, :] == a[:, None], NEG_INF, sc)
            return j + 1, sc, rv, ri

        _, _, rv, ri = jax.lax.while_loop(improves, extract, (0, sc, rv, ri))
        return rv, ri

    rv0 = jnp.full((_BQ, kp), NEG_INF, jnp.float32)
    ri0 = _BIG_ID + s * kp + jnp.broadcast_to(
        jnp.arange(kp, dtype=jnp.int32)[None, :], (_BQ, kp))
    rv, ri = jax.lax.fori_loop(0, n_tiles, tile, (rv0, ri0))
    ov_ref[...] = rv
    oi_ref[...] = ri


@functools.partial(jax.jit, static_argnames=("k", "splits", "interpret"))
def dense_topk_triton(queries, emb, n_valid, k: int, *,
                      splits: int | None = None, interpret: bool = False):
    """Fused matmul + top-k (see the module docstring). Same contract as
    dense_topk_xla. k <= TRITON_MAX_K. Rows past n_valid are never read:
    each split stops at the last tile holding a live row. splits: corpus
    splits per query tile (default: enough programs to fill the card)."""
    if k > TRITON_MAX_K:
        raise ValueError(f"k={k} > {TRITON_MAX_K}: use dense_topk_xla")
    tile_n, block_d = _TILE_N, _BLOCK_D
    b, d = queries.shape
    kp = max(next_pow2(k), 8)
    bp = round_up(max(b, 1), _BQ)
    dp = round_up(d, block_d)
    q = pad_axis(pad_axis(queries.astype(emb.dtype), 0, bp), 1, dp)
    # The corpus is passed as it lies (the last tile overlaps the one
    # before); only a corpus shorter than one tile, or a width that is not
    # a multiple of block_d, pays a padded copy.
    e = pad_axis(pad_axis(emb, 0, max(emb.shape[0], tile_n)), 1, dp)
    n_tiles = cdiv(e.shape[0], tile_n)
    q_tiles = bp // _BQ
    if splits is None:
        splits = cdiv(_PROGRAMS_IN_FLIGHT, q_tiles)
    splits = max(1, min(splits, n_tiles))
    tiles_per_split = cdiv(n_tiles, splits)
    splits = cdiv(n_tiles, tiles_per_split)
    nv = jnp.asarray(n_valid, jnp.int32).reshape((1,))
    kernel = functools.partial(
        _dense_topk_triton_kernel, k=k, kp=kp, tile_n=tile_n,
        block_d=block_d, dp=dp, tiles_per_split=tiles_per_split,
        n_rows=e.shape[0])
    whole = pl.BlockSpec()
    out_spec = pl.BlockSpec((_BQ, kp), lambda i, s: (i, s))
    vals, ids = pl.pallas_call(
        kernel,
        grid=(q_tiles, splits),
        in_specs=[whole, whole, whole],
        out_specs=[out_spec, out_spec],
        out_shape=[jax.ShapeDtypeStruct((bp, splits * kp), jnp.float32),
                   jax.ShapeDtypeStruct((bp, splits * kp), jnp.int32)],
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=_NUM_STAGES),
        interpret=interpret,
        name="dense_topk",
    )(nv, q, e)
    v, i = select_topk(vals[:b], ids[:b], k)
    return v, jnp.where((i >= _BIG_ID) | (v <= NEG_INF / 2), -1, i)


def dense_topk(queries, emb, n_valid, k: int):
    """Dense top-k on the route `dense_route` picks for this platform."""
    if dense_route(platform(), emb.dtype, k) == "triton":
        return dense_topk_triton(queries, emb, n_valid, k)
    return dense_topk_xla(queries, emb, n_valid, k)
