"""KnowledgeBase — the user-facing facade.

Replaces the reference's KB lifecycle spread across Next.js API routes +
LlamaIndex + Meilisearch + Prisma (SURVEY.md §2.9): one object owning the
dense index, the inverted index, and host-side chunk metadata, with
ingest, hybrid/dense/keyword search, and save/load.
"""

from __future__ import annotations

import json
import pathlib
import threading
from typing import Callable, Optional, Sequence

import numpy as np

from tpurag.core.chunkstore import ChunkStore
from tpurag.utils.locks import RWLock
from tpurag.core.config import EngineConfig, HybridPreset, PRESETS
from tpurag.core.types import Chunk, SearchResponse, SearchResult
from tpurag.engine.hybrid import decode_bits, hybrid_search
from tpurag.index.dense import DenseIndex
from tpurag.index.inverted import InvertedIndex
from tpurag.ingest.chunker import chunk_text
from tpurag.ingest.embedder import HashEmbedder
from tpurag.kernels.runtime import NEG_INF

Embedder = Callable[[list[str]], np.ndarray]


class KnowledgeBase:
    def __init__(
        self,
        name: str = "kb",
        embedder: Optional[Embedder] = None,
        config: Optional[EngineConfig] = None,
        dim: Optional[int] = None,
        mesh=None,
        quant: bool = False,
        store: str = "device",
        backing=None,
    ):
        """mesh: optional jax.sharding.Mesh with a 'data' axis — the dense
        corpus shards across it (per-shard top-k + all-gather merge).
        quant: int8-sidecar dense scans with exact bf16 rescoring
        (index/dense.py); under a mesh the sidecar shards with the
        rows and rescoring stays shard-local.
        store: 'device' (default) or 'host' — host-store KBs hold the
        raw corpus in host RAM (10M-chunk scale on one chip: build_ivf()
        streams the HBM-resident int8 IVF partition from it in bounded
        memory and mode='ivf' serves it; exhaustive modes stream row
        tiles through the chip).
        backing: optional file path — the host-store matrix then lives
        in a disk-backed memmap, so even the raw corpus (20 GB at
        10M x 1024 bf16) never has to fit host RAM."""
        self.name = name
        self.config = config or EngineConfig()
        self.embedder = embedder or HashEmbedder(dim or 256)
        self.dim = dim or getattr(self.embedder, "dim", self.config.device.dim)
        self.quant = bool(quant)
        self.store = store
        self.dense = DenseIndex(
            self.dim,
            dtype=self.config.device.dtype,
            capacity=self.config.device.min_capacity,
            mesh=mesh,
            quant=quant,
            store=store,
            backing=backing,
        )
        if mesh is not None:
            # Keyword leg shards with the dense corpus: doc-partitioned
            # postings + per-shard scoring + candidate all-gather merge
            # (shard/bm25.py; the reference scales this as a separate
            # Meilisearch server, meilisearch.ts:27).
            from tpurag.shard.bm25 import ShardedInvertedIndex

            self.inverted = ShardedInvertedIndex(self.config.bm25,
                                                 mesh=mesh)
        else:
            self.inverted = InvertedIndex(self.config.bm25)
        # Columnar store: list[Chunk]-compatible reads (indexing, slices,
        # iteration) at ~5x less host RAM per chunk — 10M-chunk KBs fit.
        self.chunks = ChunkStore()
        self._doc_chunks: dict[str, list[int]] = {}
        self._ivf = None
        self._ivf_built_at = 0  # n_active snapshot the IVF was built from
        self._ivf_seed = 0      # seed of the last build, reused on refresh
        self._ivf_refreshing = False  # single-flight background rebuild
        self._ivf_refresh_flag = threading.Lock()
        self._ivf_refresh_thread: Optional[threading.Thread] = None
        # Thread safety: searches are READS (device matrices are
        # immutable once built; segment swaps rebind references) and run
        # concurrently; mutations take the exclusive side (round-2
        # verdict item 6 — the old RLock serialized readers against
        # readers). The inverted index single-flights its lazy
        # compaction behind its own small lock, so a read can still
        # trigger it safely.
        self._mutex = RWLock()

    # -- ingest --------------------------------------------------------------

    def add_document(self, name: str, text: str, doc_id: str = "",
                     source: str = "document", metadata: dict | None = None) -> list[int]:
        """Chunk + embed + index one document. Returns chunk ids."""
        doc_id = doc_id or name
        pieces = chunk_text(text, self.config.chunking)
        chunks = [
            Chunk(text=p, doc_id=doc_id, doc_name=name, chunk_index=i,
                  source=source, metadata=dict(metadata or {}))
            for i, p in enumerate(pieces)
        ]
        return self.add_chunks(chunks)

    def add_chunks(self, chunks: Sequence[Chunk],
                   vectors: Optional[np.ndarray] = None) -> list[int]:
        """Index pre-chunked units (vectors optional: embedded here if absent).

        The indexed text includes the '【文档: name】' header the reference
        prepends (src/lib/llm/index-manager.ts:75-97), so doc names are
        keyword-searchable."""
        if not chunks:
            return []
        with self._mutex.write():
            return self._add_chunks_locked(chunks, vectors)

    def _add_chunks_locked(self, chunks, vectors):
        texts = [c.display_text() for c in chunks]
        if vectors is None:
            vectors = self.embedder(texts)
        # vectors may be a device array (pipelined ingest): pass it
        # through — dense.add normalizes on device, no host round-trip.
        ids = self.dense.add(vectors)
        for cid, chunk in zip(ids, chunks):
            got = self.chunks.append(chunk)  # stamps indexed_at
            assert got == int(cid)
            self._doc_chunks.setdefault(chunk.doc_id, []).append(int(cid))
        # Batched keyword ingest: one native tokenize+count call for the
        # whole chunk batch (index/inverted.py:add_batch).
        self.inverted.add_batch([int(i) for i in ids], texts)
        self._maybe_refresh_ivf_locked()
        return [int(i) for i in ids]

    def delete_document(self, doc_id: str) -> int:
        """Delete all chunks of a document from BOTH indexes: dense rows
        tombstone, keyword postings tombstone with overfetch until the
        index's next compaction (meilisearch.ts:193-194 delete-by-filter
        parity; round 1 left dead postings live forever)."""
        with self._mutex.write():
            return self._delete_document_locked(doc_id)

    def _delete_document_locked(self, doc_id: str) -> int:
        ids = self._doc_chunks.pop(doc_id, [])
        if ids:
            self.dense.delete(ids)
            self.inverted.delete_docs(ids)
            for cid in ids:
                self.chunks.mark_deleted(cid)
        return len(ids)

    # -- query ---------------------------------------------------------------

    def _preset(self, preset: str | HybridPreset | None) -> HybridPreset:
        if isinstance(preset, HybridPreset):
            return preset
        return PRESETS[preset or self.config.preset]

    def search(self, query: str, top_k: int | None = None,
               mode: str = "hybrid",
               preset: str | HybridPreset | None = None) -> SearchResponse:
        return self.search_batch([query], top_k=top_k, mode=mode,
                                 preset=preset)[0]

    def search_batch(self, queries: list[str], top_k: int | None = None,
                     mode: str = "hybrid",
                     preset: str | HybridPreset | None = None,
                     vectors=None) -> list[SearchResponse]:
        """vectors: optional (B, dim) pre-computed query embeddings —
        skips the embedder (external encoders, eval oracles); `queries`
        texts are still used for the keyword leg and highlighting."""
        p = self._preset(preset)
        if top_k is not None:
            import dataclasses
            p = dataclasses.replace(p, final_top_k=top_k)
        with self._mutex.read():
            return self._search_batch_locked(queries, p, mode, vectors)

    def search_batch_dispatch(self, queries: list[str],
                              top_k: int | None = None,
                              mode: str = "hybrid",
                              preset: str | HybridPreset | None = None,
                              vectors=None):
        """Phase-split search for pipelined serving (round-4 verdict
        item 4): performs all host-side prep and LAUNCHES the device
        computation (JAX async dispatch), returning a zero-arg
        finalize() that pays the one host sync and assembles responses.
        Between dispatch and finalize the device drains this batch
        while the host tokenizes/dispatches the next one.

        Safe across a mutation window: jax arrays are immutable, so the
        in-flight computation sees the index snapshot taken at dispatch
        time; finalize re-acquires the read lock only for the host-side
        chunk-store assembly (deleted chunks drop out there)."""
        p = self._preset(preset)
        if top_k is not None:
            import dataclasses
            p = dataclasses.replace(p, final_top_k=top_k)
        with self._mutex.read():
            triple = self._dispatch_locked(queries, p, mode, vectors)

        def finalize() -> list[SearchResponse]:
            import jax

            scores, ids, bits = triple
            if not isinstance(scores, np.ndarray):
                scores, ids, bits = jax.device_get((scores, ids, bits))
            with self._mutex.read():
                return [self._assemble(q, scores[b], ids[b], bits[b])
                        for b, q in enumerate(queries)]

        return finalize

    def _search_batch_locked(self, queries, p, mode, vectors=None):
        import jax

        scores, ids, bits = self._dispatch_locked(queries, p, mode, vectors)
        if not isinstance(scores, np.ndarray):
            scores, ids, bits = jax.device_get((scores, ids, bits))
        return [
            self._assemble(q, scores[b], ids[b], bits[b])
            for b, q in enumerate(queries)
        ]

    def _dispatch_locked(self, queries, p, mode, vectors=None):
        """Launch the device computation for one search batch; returns
        the (scores, ids, bits) triple — device-resident (async) for
        device modes, host ndarrays for host-only paths."""
        if mode == "keyword":
            qv = None  # the keyword leg never embeds — skip the encoder
        elif vectors is not None:
            qv = vectors
        elif hasattr(self.embedder, "encode_async"):
            # Keep the query embedding ON DEVICE (async dispatch): the
            # dense leg consumes it directly, dropping one blocking
            # host round-trip per request.
            qv = self.embedder.encode_async(queries)
        else:
            qv = self.embedder(queries)
        if mode == "hybrid":
            scores, ids, bits = hybrid_search(self.dense, self.inverted, qv,
                                              queries, p, sync=False)
        elif mode == "vector":
            import jax.numpy as jnp_

            s, i = self.dense.search(qv, p.final_top_k)
            keep = s >= p.min_vector_score
            scores = jnp_.where(keep, s, NEG_INF)
            ids = jnp_.where(keep, i, -1)
            bits = jnp_.where(ids >= 0, 1, 0)
        elif mode == "keyword":
            import jax.numpy as jnp_

            scores, ids = self.inverted.search(queries, p.final_top_k,
                                               as_device=True)
            bits = jnp_.where(ids >= 0, 2, 0)
        elif mode == "ivf":
            import jax.numpy as jnp_

            s, i = self._ivf_leg(qv, p.final_top_k)
            keep = s >= p.min_vector_score
            scores = jnp_.where(keep, s, NEG_INF)
            ids = jnp_.where(keep, i, -1)
            bits = jnp_.where(ids >= 0, 1, 0)
        elif mode == "hybrid_ivf":
            # The >=1M-corpus hybrid operating point: the exact dense
            # scan's cost scales with N, while the IVF probe-scan costs
            # nprobe*c_max rows. Same BM25 leg and
            # RRF semantics as mode='hybrid'; dense candidates come
            # from the IVF partition + exact active-tail merge.
            scores, ids, bits = hybrid_search(
                self.dense, self.inverted, qv, queries, p,
                dense_search=self._ivf_leg, sync=False)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        return scores, ids, bits

    def _ivf_leg(self, qv, k: int):
        """Device-side dense leg over the IVF partition, k candidates:
        probe-scan + exact scan of the post-snapshot active tail
        (growable-segment design: IVF partition + active segment,
        compacted by build_ivf()). Returns (scores, ids) jax arrays."""
        import jax.numpy as jnp_

        if self._ivf is None:
            raise ValueError("no IVF index: call kb.build_ivf() first")
        s, i = self._ivf.search(qv, k=k)
        if self.dense.mesh is not None:
            # Sharded IVF output: commit to the default device so the
            # downstream merge/fusion never mixes shardings in one op.
            s, i = jnp_.asarray(np.asarray(s)), jnp_.asarray(np.asarray(i))
        tail = self.dense.n_active - self._ivf_built_at
        if tail <= 0:
            return jnp_.asarray(s), jnp_.asarray(i)
        from tpurag.index.dense import l2_normalize
        from tpurag.kernels.dense import dense_topk_xla
        from tpurag.kernels.topk import merge_topk

        if self.dense.mesh is not None:
            # Mesh layout: gather the (small) tail to the default
            # device — slicing a row-sharded matrix mid-shard
            # would force an implicit reshard every query.
            tail_emb = jnp_.asarray(np.asarray(
                self.dense.embeddings[self._ivf_built_at:
                                      self.dense.n_active],
                np.float32), self.dense.dtype)
        elif self.store == "host":
            # Host store: slice to n_active, NOT capacity — the
            # trailing padding would be a multi-GB device upload
            # per query (review finding). Pad to a pow2 bucket
            # so tail growth compiles O(log n) variants.
            from tpurag.kernels.runtime import round_up as _ru

            raw = np.asarray(self.dense.embeddings[
                self._ivf_built_at:self.dense.n_active])
            bucket = 1 << max(int(_ru(tail, 128)) - 1, 1).bit_length()
            if bucket > len(raw):
                raw = np.concatenate([raw, np.zeros(
                    (bucket - len(raw), raw.shape[1]), raw.dtype)])
            tail_emb = raw
        else:
            # Device store: the capacity slice stays in HBM (no
            # transfer) and keeps a stable compiled shape.
            tail_emb = self.dense.embeddings[self._ivf_built_at:]
        kk = min(k, tail)
        t_s, t_i = dense_topk_xla(
            l2_normalize(qv).astype(tail_emb.dtype), tail_emb,
            jnp_.int32(tail), kk)
        t_i = jnp_.where(t_i >= 0, t_i + self._ivf_built_at, -1)
        if kk < k:
            padw = k - kk
            t_s = jnp_.pad(t_s, ((0, 0), (0, padw)),
                           constant_values=NEG_INF)
            t_i = jnp_.pad(t_i, ((0, 0), (0, padw)),
                           constant_values=-1)
        return merge_topk(jnp_.asarray(s), jnp_.asarray(i), t_s, t_i, k)

    def _assemble(self, query: str, scores, ids, bits) -> SearchResponse:
        from tpurag.index.inverted import highlight
        from tpurag.ingest.tokenizer import tokenize_query

        qtoks = tokenize_query(query)
        results = []
        for s, i, bt in zip(scores, ids, bits):
            i = int(i)
            if i < 0 or s <= NEG_INF / 2:
                continue
            c = self.chunks[i]
            if c.metadata.get("deleted"):
                continue
            found_in = decode_bits(int(bt))
            results.append(SearchResult(
                chunk_id=i, score=float(s), text=c.text, doc_name=c.doc_name,
                source=c.source, found_in=found_in,
                highlighted=(highlight(c.text, qtoks)
                             if "keyword" in found_in else ""),
                metadata=c.metadata,
            ))
        stats = {
            "total": len(results),
            "by_source": {},
        }
        for r in results:
            for src in (r.found_in or (r.source,)):
                stats["by_source"][src] = stats["by_source"].get(src, 0) + 1
        return SearchResponse(results=results, query=query, stats=stats)

    def build_ivf(self, seed: int = 0):
        """Snapshot the dense corpus into an IVF partition for the
        low-latency small-batch mode (mode='ivf'); rows added afterwards
        stay searchable via an exact tail-segment scan until the next
        rebuild (SURVEY.md §7.3 growable-segment design).

        With a mesh, builds the cluster-partitioned ShardedIVFIndex
        (benchmark config 5: 10M chunks IVF-sharded over the mesh)."""
        with self._mutex.write():
            return self._build_ivf_locked(seed)

    def _build_ivf_locked(self, seed: int):
        n = self.dense.n_active
        self._ivf = self._build_ivf_partition(n, seed)
        self._ivf_built_at = n
        self._ivf_seed = seed
        return self._ivf

    def _build_ivf_partition(self, n: int, seed: int):
        """Build an IVF partition over dense rows [0, n) WITHOUT mutating
        KB state. Safe to run outside the lock: the dense store is
        append-only (deletes tombstone, rows never move), so rows below
        a snapshotted n are immutable while ingest continues."""
        if self.dense.mesh is not None:
            from tpurag.shard.ivf import ShardedIVFIndex

            # Streaming build here too: bounded row blocks via
            # dense.get_rows instead of a full host fp32 copy (40 GB at
            # 10M x 1024).
            return ShardedIVFIndex(
                self.config.ivf, mesh=self.dense.mesh,
                data_axis=self.dense.data_axis,
            ).build_streaming(self.dense.get_rows, n,
                              dtype=self.dense.dtype, seed=seed,
                              release=self.dense.drop_page_cache)
        from tpurag.index.ivf import IVFIndex

        # Streaming build: reads bounded row blocks via
        # dense.get_rows instead of materializing the corpus as host
        # fp32 (40 GB x2 at 10M x 1024 — round-2 verdict item 2).
        return IVFIndex(self.config.ivf).build_streaming(
            self.dense.get_rows, n, dtype=self.dense.dtype,
            seed=seed, quant=self.quant,
            release=self.dense.drop_page_cache)

    # -- IVF auto-refresh (round-4 verdict item 5) -------------------------

    def _maybe_refresh_ivf_locked(self) -> None:
        """Write-lock-held ingest hook: when the exact-scanned tail
        outgrows the IVF partition by auto_refresh_ratio (and the churn
        floor), kick a single-flight background rebuild. Mirrors the
        inverted index's TAIL_COMPACT_RATIO policy — without this,
        sustained ingest silently degrades mode='ivf' latency toward
        exact-scan cost (round-3 verdict, weak item 6)."""
        ratio = self.config.ivf.auto_refresh_ratio
        if self._ivf is None or not ratio:
            return
        tail = self.dense.n_active - self._ivf_built_at
        if tail < max(self.config.ivf.auto_refresh_min_rows,
                      ratio * max(self._ivf_built_at, 1)):
            return
        with self._ivf_refresh_flag:
            if self._ivf_refreshing:
                return
            self._ivf_refreshing = True
        t = threading.Thread(target=self._ivf_refresh_worker, daemon=True)
        self._ivf_refresh_thread = t
        t.start()

    def _ivf_refresh_worker(self) -> None:
        try:
            with self._mutex.read():
                n = self.dense.n_active
                if n <= self._ivf_built_at:
                    return  # raced with a manual build_ivf()
            # Reuse the seed of the original build: a refresh must not
            # silently switch a custom-seeded KB to seed-0 partitions
            # (recall characteristics stay reproducible across runs).
            new_ivf = self._build_ivf_partition(n, seed=self._ivf_seed)
            with self._mutex.write():
                if self._ivf_built_at >= n:
                    return  # a newer partition won the race
                self._ivf = new_ivf
                self._ivf_built_at = n
        except Exception:  # background QoS: degraded latency, never a crash
            import traceback

            traceback.print_exc()
        finally:
            with self._ivf_refresh_flag:
                self._ivf_refreshing = False

    def wait_ivf_refresh(self, timeout: float | None = 30.0) -> None:
        """Block until any in-flight background IVF rebuild finishes
        (tests / orderly shutdown)."""
        t = self._ivf_refresh_thread
        if t is not None:
            t.join(timeout=timeout)

    # -- persistence -----------------------------------------------------------

    def save(self, directory) -> None:
        with self._mutex.write():  # a consistent snapshot across indexes
            self._save_locked(directory)

    def _save_locked(self, directory) -> None:
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        self.dense.save(d / "dense")
        self.inverted.save(d / "inverted")
        ivf_kind = None
        if self._ivf is not None:
            from tpurag.shard.ivf import ShardedIVFIndex

            if isinstance(self._ivf, ShardedIVFIndex):
                ivf_kind = "sharded"
                self._ivf.save(d / "ivf_sharded")
            else:
                ivf_kind = "single"
                self._ivf.save(d / "ivf")
        # Persist the embedder so load() reconstructs the SAME vector
        # space (an encoder KB reloaded with a different embedder would
        # silently mis-retrieve).
        emb_info: dict = {"kind": "custom"}
        if isinstance(self.embedder, HashEmbedder):
            emb_info = {"kind": "hash", "dim": self.embedder.dim,
                        "seed": self.embedder.seed}
        else:
            from tpurag.models.encoder import EncoderEmbedder

            if isinstance(self.embedder, EncoderEmbedder):
                self.embedder.save(d / "encoder")
                emb_info = {"kind": "encoder",
                            "seq_len": self.embedder.seq_len,
                            "tokenizer": self.embedder.tokenizer is not None}
                if self.embedder.tokenizer is not None:
                    self.embedder.tokenizer.save(d / "tokenizer.json")
        meta = {
            "name": self.name,
            "dim": self.dim,
            "quant": self.quant,
            "store": self.store,
            # Scoring-semantics config travels with the index: impacts
            # are baked from k1/b at layout time and head_m truncates
            # the layout, so a reload that silently reverted any of
            # these to defaults would re-lay future segments (and
            # re-score) under different semantics than the persisted
            # matrices. (width_ladder etc. stay runtime performance
            # knobs.)
            "bm25": {"k1": self.config.bm25.k1,
                     "b": self.config.bm25.b,
                     "rank_compat_scores":
                         self.config.bm25.rank_compat_scores,
                     "max_df_ratio": self.config.bm25.max_df_ratio,
                     "head_m": self.config.bm25.head_m,
                     "exact_scoring": self.config.bm25.exact_scoring},
            "embedder": emb_info,
            "ivf": ivf_kind,
            "ivf_built_at": self._ivf_built_at,
            "ivf_seed": self._ivf_seed,
            # Chunks stream to a JSONL sidecar: json.dumps of a 10M-dict
            # list would materialize gigabytes; one line per chunk keeps
            # save AND load memory bounded.
            "chunks_file": "chunks.jsonl",
            "doc_chunks": self._doc_chunks,
        }
        (d / "kb.json").write_text(json.dumps(meta, ensure_ascii=False))
        with open(d / "chunks.jsonl", "w", encoding="utf-8") as f:
            for cd in self.chunks.to_dicts():
                f.write(json.dumps(cd, ensure_ascii=False))
                f.write("\n")

    @classmethod
    def load(cls, directory, embedder: Optional[Embedder] = None,
             config: Optional[EngineConfig] = None,
             mesh=None, store: Optional[str] = None,
             backing=None) -> "KnowledgeBase":
        """mesh: optional — reload the dense corpus row-sharded over its
        'data' axis (and the IVF partition, if it was saved sharded).
        store: override the persisted storage mode (e.g. reload a
        host-store KB into HBM on a bigger chip, or vice versa)."""
        d = pathlib.Path(directory)
        meta = json.loads((d / "kb.json").read_text())
        store = store or meta.get("store", "device")
        if embedder is None:
            info = meta.get("embedder") or {}
            if info.get("kind") == "hash":
                embedder = HashEmbedder(info["dim"], seed=info.get("seed", 0))
            elif info.get("kind") == "encoder":
                from tpurag.models.encoder import EncoderEmbedder

                tok = None
                if info.get("tokenizer"):
                    from tpurag.ingest.subword import SubwordTokenizer

                    tok = SubwordTokenizer.load(d / "tokenizer.json")
                embedder = EncoderEmbedder.load(
                    d / "encoder", seq_len=info.get("seq_len", 128),
                    tokenizer=tok)
        quant = bool(meta.get("quant", False))
        if config is None and meta.get("bm25"):
            import dataclasses

            base = EngineConfig()
            config = dataclasses.replace(
                base, bm25=dataclasses.replace(base.bm25, **meta["bm25"]))
        kb = cls(meta["name"], embedder=embedder, config=config,
                 dim=meta["dim"], mesh=mesh, quant=quant, store=store,
                 backing=None)  # throwaway ctor index, replaced below
        kb.dense = DenseIndex.load(d / "dense", mesh=mesh, quant=quant,
                                   store=store, backing=backing)
        if (d / "inverted").is_dir():  # doc-partitioned (mesh) save
            if mesh is None:
                raise ValueError(
                    "this KB was saved with a doc-partitioned (sharded) "
                    "keyword index; pass the mesh it was built on to "
                    "KnowledgeBase.load (or re-ingest single-device)")
            from tpurag.shard.bm25 import ShardedInvertedIndex

            kb.inverted = ShardedInvertedIndex.load(
                d / "inverted", kb.config.bm25, mesh=mesh)
        else:
            kb.inverted = InvertedIndex.load(d / "inverted", kb.config.bm25)
        if meta.get("chunks_file"):
            kb.chunks = ChunkStore()
            with open(d / meta["chunks_file"], encoding="utf-8") as f:
                for line in f:
                    kb.chunks.append(Chunk(**json.loads(line)))
        else:  # legacy inline-list saves
            kb.chunks = ChunkStore.from_dicts(meta["chunks"])
        kb._doc_chunks = {k: [int(x) for x in v] for k, v in meta["doc_chunks"].items()}
        ivf_kind = meta.get("ivf")
        if ivf_kind == "sharded" and mesh is not None:
            from tpurag.shard.ivf import ShardedIVFIndex

            kb._ivf = ShardedIVFIndex.load(d / "ivf_sharded", mesh=mesh,
                                           config=kb.config.ivf)
            kb._ivf_built_at = int(meta.get("ivf_built_at", 0))
            kb._ivf_seed = int(meta.get("ivf_seed", 0))
        elif ivf_kind == "single":
            from tpurag.index.ivf import IVFIndex

            kb._ivf = IVFIndex.load(d / "ivf", config=kb.config.ivf,
                                    dtype=kb.dense.dtype)
            kb._ivf_built_at = int(meta.get("ivf_built_at", 0))
            kb._ivf_seed = int(meta.get("ivf_seed", 0))
        # else: mode='ivf' needs build_ivf() after load (documented).
        return kb

    def __len__(self) -> int:
        return len(self.dense)
