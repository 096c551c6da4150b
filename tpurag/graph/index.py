"""Graph index: entity/relation embedding kNN + CSR adjacency.

The device-resident replacement for the LightRAG Python sidecar
(lightrag-service/main.py): entity and relation descriptions are embedded
into two DenseIndex instances on the same engine; the entity graph is flat
CSR adjacency on device; query modes mirror LightRAG's
local/global/hybrid/naive (main.py:375-419):

- local:  query -> entity kNN -> 1-hop neighbors -> source chunks
- global: query -> relation kNN -> endpoint entities -> source chunks
- hybrid: union(local, global)
- naive:  plain dense chunk search (no graph)

GraphML-ish exports for visualization parity with /graph/{kb}
(main.py:466-609) come from `export_graph`.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from tpurag.core.config import GraphConfig
from tpurag.core.types import Entity, Relation
from tpurag.graph.extract import LLMFn, TermStats, extract_graph
from tpurag.index.dense import DenseIndex
from tpurag.kernels.graphops import expand_neighbors, gather_chunks

Embedder = Callable[[list[str]], np.ndarray]


class GraphIndex:
    def __init__(self, embedder: Embedder, dim: Optional[int] = None,
                 config: Optional[GraphConfig] = None):
        self.config = config or GraphConfig()
        self.embedder = embedder
        dim = dim or getattr(embedder, "dim", 256)
        self.entities: list[Entity] = []
        self.relations: list[Relation] = []
        self._by_name: dict[str, int] = {}
        self.ent_index = DenseIndex(dim, dtype=jnp.float32, capacity=1024)
        self.rel_index = DenseIndex(dim, dtype=jnp.float32, capacity=1024)
        self._adj: Optional[tuple] = None          # CSR entity -> entity
        self._chunk_csr: Optional[tuple] = None    # CSR entity -> chunk
        self._dirty = True
        # Corpus df stats driving the LLM-free lowercase salience
        # extractor (graph/extract.py). Incrementally fed by every
        # ingest_chunk; ingest_chunks() primes it corpus-wide first so
        # bulk builds are order-independent.
        self.term_stats = TermStats()

    # -- build ---------------------------------------------------------------

    def ingest_chunks(self, chunks: list[tuple[int, str]],
                      llm: Optional[LLMFn] = None) -> tuple[int, int]:
        """Bulk build: prime the salience df table over the WHOLE corpus,
        then extract each chunk — lowercase corpora get full-corpus
        statistics for every chunk (per-chunk ingest_chunk sees only the
        docs ingested before it). Returns total (entities, relations)."""
        for _, text in chunks:
            self.term_stats.add(text)
        te = tr = 0
        for cid, text in chunks:
            e, r = self.ingest_chunk(cid, text, llm=llm, _stats_fed=True)
            te += e
            tr += r
        return te, tr

    def ingest_chunk(self, chunk_id: int, text: str,
                     llm: Optional[LLMFn] = None,
                     _stats_fed: bool = False) -> tuple[int, int]:
        """Extract + merge entities/relations of one chunk into the graph."""
        if not _stats_fed:
            self.term_stats.add(text)
        ents, rels = extract_graph(text, chunk_id, llm=llm,
                                   stats=self.term_stats)
        new_ents: list[Entity] = []
        for e in ents:
            key = e.name.lower()
            eid = self._by_name.get(key)
            if eid is None:
                e.entity_id = len(self.entities)
                self._by_name[key] = e.entity_id
                self.entities.append(e)
                new_ents.append(e)
            else:
                known = self.entities[eid]
                for cid in e.source_chunk_ids:
                    if cid not in known.source_chunk_ids:
                        known.source_chunk_ids.append(cid)
        if new_ents:
            vecs = self.embedder([f"{e.name}: {e.description}" for e in new_ents])
            self.ent_index.add(vecs)
        kept_rels = []
        for r in rels:
            if r.src.lower() in self._by_name and r.dst.lower() in self._by_name:
                r.relation_id = len(self.relations)
                self.relations.append(r)
                kept_rels.append(r)
        if kept_rels:
            vecs = self.embedder(
                [f"{r.src} -> {r.dst}: {r.description} {r.keywords}" for r in kept_rels])
            self.rel_index.add(vecs)
        self._dirty = True
        return len(new_ents), len(kept_rels)

    def _build_csr(self) -> None:
        e = len(self.entities)
        nbrs: list[set[int]] = [set() for _ in range(e)]
        for r in self.relations:
            a = self._by_name[r.src.lower()]
            b = self._by_name[r.dst.lower()]
            nbrs[a].add(b)
            nbrs[b].add(a)
        off = np.zeros(e + 1, np.int32)
        flat: list[int] = []
        for i, s in enumerate(nbrs):
            off[i] = len(flat)
            flat.extend(sorted(s))
        off[e] = len(flat)
        self._adj = (jnp.asarray(off), jnp.asarray(np.asarray(flat or [0], np.int32)))

        coff = np.zeros(e + 1, np.int32)
        cflat: list[int] = []
        for i, ent in enumerate(self.entities):
            coff[i] = len(cflat)
            cflat.extend(c for c in ent.source_chunk_ids if c >= 0)
        coff[e] = len(cflat)
        self._chunk_csr = (jnp.asarray(coff),
                           jnp.asarray(np.asarray(cflat or [0], np.int32)))
        self._dirty = False

    # -- query ---------------------------------------------------------------

    def entity_knn(self, query: str, k: Optional[int] = None):
        k = k or self.config.entity_top_k
        if not self.entities:
            return []
        vec = self.embedder([query])
        scores, ids = self.ent_index.search(vec, k=min(k, len(self.entities)))
        return [(int(i), float(s)) for s, i in
                zip(np.asarray(scores)[0], np.asarray(ids)[0]) if i >= 0]

    def relation_knn(self, query: str, k: Optional[int] = None):
        k = k or self.config.relation_top_k
        if not self.relations:
            return []
        vec = self.embedder([query])
        scores, ids = self.rel_index.search(vec, k=min(k, len(self.relations)))
        return [(int(i), float(s)) for s, i in
                zip(np.asarray(scores)[0], np.asarray(ids)[0]) if i >= 0]

    def _seed_to_chunks(self, seed_ids: list[int], seed_scores: list[float],
                        expand: bool = True) -> dict[int, float]:
        """Seed entities -> (optionally) 1-hop neighbors -> chunk scores."""
        if self._dirty:
            self._build_csr()
        if not seed_ids:
            return {}
        seeds = jnp.asarray(np.asarray([seed_ids], np.int32))
        ent_set = {int(i): float(s) for i, s in zip(seed_ids, seed_scores)}
        if expand and self.config.expand_hops >= 1:
            nbrs = np.asarray(expand_neighbors(
                seeds, *self._adj, self.config.max_neighbors))[0]
            for row, base in zip(nbrs, seed_scores):
                for n in row:
                    n = int(n)
                    if n >= 0 and n not in ent_set:
                        ent_set[n] = 0.5 * float(base)  # neighbor discount
        ids = np.asarray([list(ent_set.keys())], np.int32)
        chunks = np.asarray(gather_chunks(
            jnp.asarray(ids), *self._chunk_csr, self.config.max_neighbors))[0]
        out: dict[int, float] = {}
        for (eid, escore), row in zip(ent_set.items(), chunks):
            for c in row:
                c = int(c)
                if c >= 0:
                    out[c] = max(out.get(c, 0.0), escore)
        return out

    def search_chunks(self, query: str, mode: str = "hybrid",
                      k: int = 8) -> list[tuple[int, float]]:
        """Graph-mediated chunk retrieval; returns [(chunk_id, score)].

        Modes local/global/hybrid per LightRAG (main.py:398-415); 'naive'
        is handled by the caller via plain dense search."""
        scores: dict[int, float] = {}
        if mode in ("local", "hybrid"):
            seeds = self.entity_knn(query)
            scores.update(self._seed_to_chunks(
                [i for i, _ in seeds], [s for _, s in seeds]))
        if mode in ("global", "hybrid"):
            rels = self.relation_knn(query)
            ent_ids, ent_scores = [], []
            for rid, s in rels:
                r = self.relations[rid]
                for name in (r.src, r.dst):
                    eid = self._by_name.get(name.lower())
                    if eid is not None:
                        ent_ids.append(eid)
                        ent_scores.append(s)
            glob = self._seed_to_chunks(ent_ids, ent_scores, expand=False)
            for c, s in glob.items():
                scores[c] = max(scores.get(c, 0.0), s)
        return sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:k]

    # -- viz export (parity: GET /graph/{kb}, main.py:466-609) ---------------

    def export_graph(self, limit: int = 100) -> dict:
        nodes = [
            {"id": e.name, "type": e.entity_type, "description": e.description}
            for e in self.entities[:limit]
        ]
        names = {n["id"] for n in nodes}
        edges = [
            {"source": r.src, "target": r.dst, "description": r.description,
             "weight": r.weight}
            for r in self.relations
            if r.src in names and r.dst in names
        ][:limit]
        return {"nodes": nodes, "edges": edges,
                "stats": {"entities": len(self.entities),
                          "relations": len(self.relations)}}

    def __len__(self) -> int:
        return len(self.entities)

    # -- persistence (SURVEY.md §5.4: LightRAG persists GraphML + vector
    # stores per working_dir; here one directory with JSON + npz shards) --

    def save(self, directory) -> None:
        import dataclasses
        import json
        import pathlib

        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        self.ent_index.save(d / "entities")
        self.rel_index.save(d / "relations")
        (d / "graph.json").write_text(json.dumps({
            "entities": [dataclasses.asdict(e) for e in self.entities],
            "relations": [dataclasses.asdict(r) for r in self.relations],
        }, ensure_ascii=False))

    @classmethod
    def load(cls, directory, embedder, config=None) -> "GraphIndex":
        import json
        import pathlib

        d = pathlib.Path(directory)
        data = json.loads((d / "graph.json").read_text())
        g = cls(embedder, config=config)
        g.entities = [Entity(**e) for e in data["entities"]]
        g.relations = [Relation(**r) for r in data["relations"]]
        g._by_name = {e.name.lower(): e.entity_id for e in g.entities}
        g.ent_index = DenseIndex.load(d / "entities")
        g.rel_index = DenseIndex.load(d / "relations")
        g._dirty = True
        return g
