"""Hybrid (dense + keyword) retrieval with RRF fusion.

Mirrors hybridSearch (src/lib/hybrid-search.ts:275-362):
  1. dense cosine top-k, then drop hits below the preset's min vector score
     (pre-RRF filtering, hybrid-search.ts:253-262);
  2. BM25 keyword top-k (the reference's Meilisearch call);
  3. reciprocal-rank fusion with preset weights / rrf_k / both-bonus;
  4. cut to final_top_k.

Unlike the reference — which runs the two searches sequentially over HTTP
(hybrid-search.ts:303,325) — both legs here are device computations
launched back-to-back and fused on-device.

Source bit layout in the returned mask: bit 0 = vector, bit 1 = keyword.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from tpurag.core.config import HybridPreset
from tpurag.index.dense import DenseIndex
from tpurag.index.inverted import InvertedIndex
from tpurag.kernels.fusion import rrf_fuse
from tpurag.kernels.runtime import NEG_INF

SOURCE_BITS = ("vector", "keyword")


def apply_min_score(scores, ids, min_score: float):
    """Invalidate candidates below the cosine threshold (pre-RRF filter)."""
    keep = scores >= min_score
    return jnp.where(keep, scores, NEG_INF), jnp.where(keep, ids, -1)


def hybrid_search(
    dense: DenseIndex,
    inverted: InvertedIndex | None,
    query_vecs,
    query_texts: list[str],
    preset: HybridPreset,
    dense_search=None,
    sync: bool = True,
):
    """Batch hybrid search.

    dense_search: optional (query_vecs, k) -> (scores, ids) device-leg
    override — e.g. the KB's IVF+tail leg (mode='hybrid_ivf'), whose
    probe-scan cost scales with nprobe·c_max instead of the corpus.

    sync=False leaves the fused triple ON DEVICE (async-dispatched, not
    yet executed): the pipelined serving path dispatches batch N+1's
    search while batch N's device work drains, then pays its one host
    sync in a separate finalize phase (round-4 verdict item 4).

    Returns (scores, ids, src_bits) — (B, final_top_k) arrays; empty slots
    are (-inf, -1, 0).
    """
    import jax

    v_scores, v_ids = (dense_search or dense.search)(
        query_vecs, preset.vector_top_k)
    v_scores, v_ids = apply_min_score(v_scores, v_ids, preset.min_vector_score)

    if inverted is not None and len(inverted) > 0:
        # as_device: both legs + fusion stay on-device; the single
        # device_get below is the only host sync the whole search pays.
        k_scores, k_ids = inverted.search(query_texts, preset.keyword_top_k,
                                          as_device=True)
        if (preset.min_keyword_coverage > 0.0
                and not inverted.config.rank_compat_scores):
            # (rank-compat mode emits 1/(rank+1) pseudo-scores, which
            # carry no match-mass information — gate only on true BM25.)
            # Keyword-leg confidence gate (see HybridPreset): when even
            # the BEST BM25 hit matches under min_keyword_coverage of
            # the query's idf mass, the leg is lexical noise (e.g. only
            # function words matched) — RRF would hand its rank-0 noise
            # more mass than the vector leg's rank-5 truth. Per-query
            # all-or-nothing on the leg, keyed off the top score.
            mass = jnp.asarray(inverted.query_idf_mass(query_texts))
            best = jnp.max(k_scores, axis=1, keepdims=True)
            confident = best >= preset.min_keyword_coverage * mass[:, None]
            k_ids = jnp.where(confident, k_ids, -1)
    else:
        # Keyword index unavailable -> vector-only degradation
        # (reference: hybrid-search.ts:322-330).
        b = v_ids.shape[0]
        k_ids = jnp.full((b, preset.keyword_top_k), -1, jnp.int32)

    fused_scores, fused_ids, bits = rrf_fuse(
        (v_ids, k_ids),
        weights=(preset.vector_weight, preset.keyword_weight),
        final_k=preset.final_top_k,
        rrf_k=preset.rrf_k,
        both_bonus=preset.both_bonus,
    )
    if sync:
        fused_scores, fused_ids, bits = jax.device_get(
            (fused_scores, fused_ids, bits))
    return fused_scores, fused_ids, bits


def decode_bits(bits: int, names: tuple[str, ...] = SOURCE_BITS) -> tuple[str, ...]:
    return tuple(n for i, n in enumerate(names) if bits & (1 << i))
