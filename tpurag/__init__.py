"""tpurag — an accelerator-resident retrieval framework (JAX/XLA/Pallas).

A ground-up rebuild of the capabilities of gong9/rag-era as a single
device-resident index-and-query engine:

- dense chunk-embedding search: fused cosine-similarity + top-k over
  bf16/fp32 matrices in device memory (a Pallas/Triton kernel on the
  GPU; reference: brute-force JS cosine, src/lib/hybrid-search.ts:217-247)
- keyword search: device-resident BM25 inverted index scored by sort +
  segment-sum (reference: Meilisearch server, src/lib/meilisearch.ts)
- hybrid fusion: reciprocal-rank-fusion rank-merge kernel
  (reference: src/lib/hybrid-search.ts:129-208)
- memory: freshness-decay fusion (reference: src/lib/memory/freshness.ts)
- graph RAG: entity/relation embedding kNN + 1-hop expansion
  (reference: LightRAG sidecar, lightrag-service/main.py)
- scale: IVF partitioning + shard_map corpus sharding over a device mesh.

Public API lives in :mod:`tpurag.api`.
"""

__version__ = "0.1.0"

from tpurag.api.knowledge_base import KnowledgeBase  # noqa: F401
from tpurag.core.config import (  # noqa: F401
    EngineConfig,
    HybridPreset,
    PRESETS,
)
