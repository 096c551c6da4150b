"""Memory store: dual-write host record + vector row in the shared index,
plus a dedicated MEMORY SEGMENT for memory-only recall.

Reference: src/lib/memory/store.ts — memories are written both to Prisma
and as vector nodes tagged metadata.type='memory' inside the *same* KB
index (store.ts:36-82); retrieval over-fetches x2, filters to memory rows,
applies the relevance threshold, and scores 0.7*relevance + 0.3*freshness
(store.ts:160). Unlike the reference — where vector delete was never
implemented (store.ts:240-249) — deletes here tombstone the dense row too.

Design note: filtering memory rows out of a shared-index top-k needs
an over-fetch that grows with the corpus (top-~N at 100k chunks — the
round-1 flaw). Instead, memory vectors ALSO live in a small dedicated
DenseIndex (the "memory segment"): memory-only recall and the 0.9 dup
check scan just the memories at a true x2 over-fetch, while the shared
index keeps serving unified retrieval (engine.ts:242-253) untouched.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from tpurag.core.config import MemoryConfig
from tpurag.core.types import Chunk, MemoryEntry
from tpurag.memory.freshness import combined_memory_scores, freshness_scores


class MemoryStore:
    def __init__(self, kb, config: Optional[MemoryConfig] = None):
        """kb: the KnowledgeBase whose dense index memories share."""
        from tpurag.index.dense import DenseIndex

        self.kb = kb
        self.config = config or MemoryConfig()
        self.entries: dict[int, MemoryEntry] = {}  # kb chunk_id -> entry
        # Memory segment: memory vectors only (single-device — memories
        # are few; the sharded corpus path is for documents).
        self.segment = DenseIndex(kb.dim, dtype=kb.dense.dtype,
                                  capacity=256)
        self._seg_to_kb: list[int] = []            # segment row -> chunk id
        self._kb_to_seg: dict[int, int] = {}

    def add(self, entry: MemoryEntry, now: Optional[float] = None) -> int:
        """Store a memory; returns its chunk id, or the existing id if a
        near-duplicate (cosine >= 0.9, store.ts:274-285) already exists."""
        now = now or time.time()
        chunk = Chunk(text=entry.content, source="memory",
                      metadata={"memory_type": entry.memory_type})
        vec = np.asarray(self.kb.embedder([chunk.display_text()]))
        dup = self._find_duplicate(vec)
        if dup is not None:
            return dup
        [cid] = self.kb.add_chunks([chunk], vectors=vec)
        [seg_row] = self.segment.add(vec)
        self._seg_to_kb.append(cid)
        self._kb_to_seg[cid] = int(seg_row)
        entry.memory_id = cid
        entry.created_at = entry.created_at or now
        entry.last_accessed_at = now
        self.entries[cid] = entry
        return cid

    def _find_duplicate(self, vec: np.ndarray) -> Optional[int]:
        """Dup check against the memory segment only — document chunks
        can never crowd the candidate window (round-1 advisor finding)."""
        if len(self.segment) == 0:
            return None
        scores, ids = self.segment.search(vec, k=min(8, len(self.segment)))
        for s, i in zip(np.asarray(scores)[0], np.asarray(ids)[0]):
            if int(i) >= 0 and float(s) >= self.config.dedup_similarity:
                cid = self._seg_to_kb[int(i)]
                if cid in self.entries:
                    return cid
        return None

    def retrieve(self, query: str, k: int = 5,
                 now: Optional[float] = None) -> list[tuple[MemoryEntry, float]]:
        """Top-k memories by 0.7*relevance + 0.3*freshness, thresholded.

        Scans the memory segment at x2 over-fetch (store.ts retrieve) —
        O(memories), not O(corpus)."""
        now = now or time.time()
        if not self.entries:
            return []
        vec = self.kb.embedder([query])
        kk = min(k * self.config.overfetch_factor, len(self.segment))
        if kk == 0:
            return []
        scores, ids = self.segment.search(vec, k=kk)
        cand: list[tuple[MemoryEntry, float]] = []
        for s, i in zip(np.asarray(scores)[0], np.asarray(ids)[0]):
            if int(i) < 0 or float(s) < self.config.relevance_threshold:
                continue
            e = self.entries.get(self._seg_to_kb[int(i)])
            if e is not None:
                cand.append((e, float(s)))
        if not cand:
            return []
        fresh = freshness_scores(
            [e.confidence for e, _ in cand],
            [e.last_accessed_at for e, _ in cand],
            [e.access_count for e, _ in cand],
            now, self.config.freshness,
        )
        combined = np.asarray(combined_memory_scores(
            [r for _, r in cand], fresh,
            self.config.relevance_weight, self.config.freshness_weight))
        order = np.argsort(-combined, kind="stable")[:k]
        return [(cand[i][0], float(combined[i])) for i in order]

    def touch(self, entries: list[MemoryEntry], now: Optional[float] = None) -> None:
        """Access bump (store.ts:207-235)."""
        now = now or time.time()
        for e in entries:
            e.access_count += 1
            e.last_accessed_at = now

    def delete(self, memory_id: int) -> bool:
        e = self.entries.pop(memory_id, None)
        if e is None:
            return False
        self.kb.dense.delete([memory_id])
        self.kb.chunks.mark_deleted(memory_id)
        seg_row = self._kb_to_seg.pop(memory_id, None)
        if seg_row is not None:
            self.segment.delete([seg_row])
        return True

    def __len__(self) -> int:
        return len(self.entries)
