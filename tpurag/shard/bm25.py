"""Sharded BM25: doc-partitioned postings over the 'data' mesh axis.

The reference scales keyword search by running Meilisearch as a separate
server process and batching documents into it over HTTP
(src/lib/meilisearch.ts:27-259, batch ingest :137-158). Here the
postings are partitioned BY DOCUMENT over the same `data` mesh axis the
dense corpus shards across —

- routing: global doc id g lives on shard p = g % S as local id l = g // S
  (stable under growth, balanced for monotone chunk ids);
- each shard holds its own bucket-matrix layout (index/inverted.py) built
  from its local postings, with impacts baked using the GLOBAL average
  doc length (avgdl_override) and queries weighted by GLOBAL idf, so
  scores match a single-device index bit-for-near-bit;
- one shard_map program: every device gathers + scores its local bucket
  matrices (the same sort + segsum + top-k tail), translates local
  winners back to global ids (l*S + p), all-gathers the k·(score, id)
  candidates — O(B·k·S) bytes, postings never move — and merges the
  global top-k on every device.

Mutations (add/delete) route to the owning part and invalidate the
stacked device layout; the next search rebuilds it (compacting every
part), mirroring the single index's compaction policy at shard
granularity.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpurag.core.config import BM25Config
from tpurag.index.inverted import (InvertedIndex, _BIG, _bucket_score,
                                   _next_pow2)
from tpurag.kernels.runtime import NEG_INF, round_up
from tpurag.kernels.topk import select_topk
from tpurag.ingest.tokenizer import tokenize_query


def _local_bm25(bucketw, rowid, idf, mats_flat, *, k, k_local, p_max, t,
                widths, data_axis, n_shards):
    """Per-device body: score the local shard, globalize ids, all-gather
    candidates, merge everywhere (same pattern as shard.search)."""
    p = jax.lax.axis_index(data_axis)
    mats = tuple((mats_flat[2 * i][0], mats_flat[2 * i + 1][0])
                 for i in range(len(widths)))
    s, i = _bucket_score(bucketw[0], rowid[0], idf[0], mats, k=k_local,
                         p_max=p_max, t=t, widths=widths)
    gids = jnp.where((i >= 0) & (s > NEG_INF / 2),
                     i * n_shards + p.astype(jnp.int32), -1)
    all_v = jax.lax.all_gather(s, data_axis, axis=1, tiled=True)
    all_i = jax.lax.all_gather(gids, data_axis, axis=1, tiled=True)
    pos = jax.lax.broadcasted_iota(jnp.int32, all_i.shape, 1)
    tb = jnp.where(all_i >= 0, all_i, 2**30 + pos)
    vals_k, tb_k = select_topk(all_v, tb, k)
    return vals_k, jnp.where(tb_k >= 2**30, -1, tb_k)


@functools.partial(
    jax.jit,
    static_argnames=("k", "k_local", "p_max", "t", "widths", "mesh",
                     "data_axis"))
def sharded_bm25_topk(bucketw, rowid, idf, mats, k: int, k_local: int,
                      p_max: int, t: int, widths: tuple,
                      mesh: Mesh, data_axis: str = "data"):
    """bucketw/rowid/idf: (S, B, T) per-shard query tables; mats: flat
    tuple (doc_0, imp_0, doc_1, imp_1, ...) of (S, R_w+1, w) stacked
    bucket matrices. k_local: per-shard candidates (k <= S*k_local).
    Returns (B, k) global (scores, ids), replicated."""
    n_shards = mesh.shape[data_axis]
    fn = shard_map(
        functools.partial(
            _local_bm25, k=k, k_local=k_local, p_max=p_max, t=t,
            widths=widths, data_axis=data_axis, n_shards=n_shards),
        mesh=mesh,
        in_specs=(P(data_axis, None, None), P(data_axis, None, None),
                  P(data_axis, None, None),
                  tuple(P(data_axis, None, None) for _ in mats)),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )
    return fn(bucketw, rowid, idf, tuple(mats))


class ShardedInvertedIndex:
    """Doc-partitioned BM25 index over a mesh's data axis.

    API mirrors InvertedIndex (add / add_batch / delete_doc / search /
    search_tokens / save / load) with GLOBAL doc ids throughout."""

    def __init__(self, config: Optional[BM25Config] = None, *, mesh: Mesh,
                 data_axis: str = "data"):
        self.config = config or BM25Config()
        self.mesh = mesh
        self.data_axis = data_axis
        self.n_shards = mesh.shape[data_axis]
        self.parts = [InvertedIndex(self.config)
                      for _ in range(self.n_shards)]
        self._stacked = None   # (widths, mats_dev, max_rows) device layout
        import threading

        self._build_lock = threading.Lock()  # single-flight relayouts

    # -- routing -------------------------------------------------------------

    def _route(self, doc_id: int) -> tuple[int, int]:
        return doc_id % self.n_shards, doc_id // self.n_shards

    @property
    def n_docs(self) -> int:
        return sum(p.n_docs for p in self.parts)

    def __len__(self) -> int:
        return self.n_docs

    @property
    def _total_tokens(self) -> int:
        return sum(p._total_tokens for p in self.parts)

    # -- mutation ------------------------------------------------------------

    def add(self, doc_id: int, text: str) -> None:
        p, l = self._route(int(doc_id))
        self.parts[p].add(l, text)
        self._stacked = None

    def add_batch(self, ids, texts) -> None:
        buckets: list[tuple[list[int], list[str]]] = [
            ([], []) for _ in range(self.n_shards)]
        for i, t in zip(ids, texts):
            p, l = self._route(int(i))
            buckets[p][0].append(l)
            buckets[p][1].append(t)
        for part, (lids, ltexts) in zip(self.parts, buckets):
            if lids:
                part.add_batch(lids, ltexts)
        self._stacked = None

    def delete_doc(self, doc_id: int) -> None:
        p, l = self._route(int(doc_id))
        self.parts[p].delete_doc(l)
        self._stacked = None

    def delete_docs(self, ids) -> None:
        for i in np.atleast_1d(ids):
            self.delete_doc(int(i))

    # -- device layout ---------------------------------------------------------

    def _ensure_stacked(self) -> None:
        if self._stacked is not None:
            return
        with self._build_lock:
            if self._stacked is None:
                self._build_stacked()

    def _build_stacked(self) -> None:
        # Global BM25 stats must be frozen into every part's impacts.
        avgdl = self._total_tokens / max(self.n_docs, 1)
        for part in self.parts:
            part.avgdl_override = avgdl
            part.compact()
        widths = tuple(sorted({w for part in self.parts
                               for w in part._main.widths}))
        mats_dev = []
        for w in widths:
            rows = max((part._main.mats[part._main.widths.index(w)][0]
                        .shape[0] if w in part._main.widths else 1)
                       for part in self.parts)
            doc = np.full((self.n_shards, rows, w), _BIG, np.int32)
            imp = np.zeros((self.n_shards, rows, w), np.float32)
            for s, part in enumerate(self.parts):
                if w not in part._main.widths:
                    continue
                dm, im = part._main.mats[part._main.widths.index(w)]
                doc[s, : dm.shape[0]] = np.asarray(dm)
                imp[s, : im.shape[0]] = np.asarray(im)
            spec = NamedSharding(self.mesh, P(self.data_axis, None, None))
            mats_dev.append(jax.device_put(doc, spec))
            mats_dev.append(jax.device_put(imp, spec))
        self._stacked = (widths, tuple(mats_dev))

    # -- query ---------------------------------------------------------------

    def _global_df(self, term: str) -> int:
        df = 0
        for part in self.parts:
            tid = part.vocab.get(term)
            if tid is not None:
                df += len(part._postings_doc[tid])
        return df

    def query_idf_mass(self, queries: list[str]) -> np.ndarray:
        """Global-df analogue of InvertedIndex.query_idf_mass (the
        hybrid keyword-coverage gate's normalizer): Σ idf over all
        query tokens, df summed across shards, OOV terms at the
        formula's maximum."""
        from tpurag.index.inverted import tokenize_query

        df_live = max(self.n_docs, 1)
        out = np.zeros(len(queries), np.float32)
        for qi, q in enumerate(queries):
            mass = 0.0
            for tok in tokenize_query(q):
                df = min(self._global_df(tok), df_live)
                mass += math.log(1.0 + (df_live - df + 0.5) / (df + 0.5))
            out[qi] = mass
        return out

    def search(self, queries: list[str], k: int, as_device: bool = False):
        return self.search_tokens([tokenize_query(q) for q in queries], k,
                                  as_device=as_device)

    def search_tokens(self, token_lists: list[list[str]], k: int,
                      as_device: bool = False):
        bsz = len(token_lists)
        if self.n_docs == 0:
            s = np.full((bsz, k), NEG_INF, np.float32)
            i = np.full((bsz, k), -1, np.int32)
            return (jnp.asarray(s), jnp.asarray(i)) if as_device else (s, i)
        self._ensure_stacked()
        widths, mats_dev = self._stacked
        if not widths:  # docs exist but none produced a term
            s = np.full((bsz, k), NEG_INF, np.float32)
            i = np.full((bsz, k), -1, np.int32)
            return (jnp.asarray(s), jnp.asarray(i)) if as_device else (s, i)
        S = self.n_shards
        df_live = max(self.n_docs, 1)
        df_cap = int(self.config.max_df_ratio * df_live)

        # Query rows: terms filtered by GLOBAL df; idf from GLOBAL stats.
        rows: list[list[tuple[str, float]]] = []
        t_len = 1
        for toks in token_lists:
            row = []
            for term in toks:
                df = self._global_df(term)
                if df == 0:
                    continue
                if self.config.max_df_ratio < 1.0 and df > df_cap:
                    continue
                df = min(df, df_live)
                row.append((term, math.log(
                    1.0 + (df_live - df + 0.5) / (df + 0.5))))
            rows.append(row)
            t_len = max(t_len, len(row))
        t_max = _next_pow2(t_len)

        bucketw = np.zeros((S, bsz, t_max), np.int32)
        rowid = np.zeros((S, bsz, t_max), np.int32)
        idf = np.zeros((S, bsz, t_max), np.float32)
        ladder = tuple(sorted(self.config.width_ladder or ()))
        for s, part in enumerate(self.parts):
            lay = part._main
            v = len(lay.term_bucket)
            for bi, row in enumerate(rows):
                for ti, (term, w_idf) in enumerate(row):
                    tid = part.vocab.get(term)
                    if tid is None or tid >= v or lay.term_bucket[tid] == 0:
                        continue
                    bucketw[s, bi, ti] = lay.term_bucket[tid]
                    rowid[s, bi, ti] = lay.term_row[tid] + 1
                    idf[s, bi, ti] = w_idf

        def ladder_w(p: int) -> int:
            for w in ladder:
                if w >= p:
                    return w
            return int(p)

        # Width-class the batch like the single-device _score: each
        # query runs at ITS OWN (padded) postings width / term count —
        # one wide query must not pad every other query's lanes.
        q_pmax = bucketw.max(axis=(0, 2))          # (bsz,) over shards
        if self.config.width_classes and bsz > 1:
            groups: dict[tuple[int, int], list[int]] = {}
            for bi in range(bsz):
                key = (ladder_w(max(int(q_pmax[bi]), 16)),
                       _next_pow2(max(len(rows[bi]), 1)))
                groups.setdefault(key, []).append(bi)
        else:
            groups = {(ladder_w(max(int(q_pmax.max()), 16)), t_max):
                      list(range(bsz))}

        # Overfetch past tombstones (translated to global ids below).
        dead = {l * S + p for p, part in enumerate(self.parts)
                for l in part._dead}
        extra = round_up(len(dead), 8) if dead else 0
        kk = min(k + extra, max(self.n_docs, 1))
        scores = jnp.full((bsz, kk), NEG_INF, jnp.float32)
        ids = jnp.full((bsz, kk), -1, jnp.int32)
        for (p_cls, t_cls), members in groups.items():
            sel = np.asarray(members, np.int32)
            k_local = min(kk, t_cls * p_cls)  # <= t*p lanes per shard
            kk_cls = min(kk, S * k_local)
            s_c, i_c = sharded_bm25_topk(
                jnp.asarray(bucketw[:, sel, :t_cls]),
                jnp.asarray(rowid[:, sel, :t_cls]),
                jnp.asarray(idf[:, sel, :t_cls]),
                mats_dev, k=kk_cls, k_local=k_local, p_max=p_cls,
                t=t_cls, widths=widths, mesh=self.mesh,
                data_axis=self.data_axis)
            if kk_cls < kk:
                s_c = jnp.pad(s_c, ((0, 0), (0, kk - kk_cls)),
                              constant_values=NEG_INF)
                i_c = jnp.pad(i_c, ((0, 0), (0, kk - kk_cls)),
                              constant_values=-1)
            scores = scores.at[jnp.asarray(sel)].set(s_c)
            ids = ids.at[jnp.asarray(sel)].set(i_c)
        if dead:
            dead_dev = jnp.asarray(np.fromiter(dead, np.int32, len(dead)))
            hit = jnp.isin(ids, dead_dev)
            scores = jnp.where(hit, NEG_INF, scores)
            order = jnp.argsort(-scores, axis=1, stable=True)
            scores = jnp.take_along_axis(scores, order, axis=1)
            ids = jnp.take_along_axis(ids, order, axis=1)
            ids = jnp.where(scores <= NEG_INF / 2, -1, ids)
        scores, ids = scores[:, :k], ids[:, :k]
        if scores.shape[1] < k:
            scores = jnp.pad(scores, ((0, 0), (0, k - scores.shape[1])),
                             constant_values=NEG_INF)
            ids = jnp.pad(ids, ((0, 0), (0, k - ids.shape[1])),
                          constant_values=-1)
        from tpurag.kernels.bm25 import rank_compat

        if self.config.rank_compat_scores:
            scores = rank_compat(scores)
        if as_device:
            return scores, ids
        return np.asarray(scores), np.asarray(ids)

    # -- persistence -----------------------------------------------------------

    def save(self, path) -> None:
        import json
        import pathlib

        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        # Shard count is part of the DATA layout (doc g -> part g%S as
        # local g//S): a reload under a different S would corrupt every
        # global id silently (review finding) — record and validate it.
        (path / "meta.json").write_text(json.dumps(
            {"n_shards": self.n_shards, "n_docs": self.n_docs}))
        for p, part in enumerate(self.parts):
            part.save(path / f"part{p:03d}")

    @classmethod
    def load(cls, path, config: Optional[BM25Config] = None, *, mesh: Mesh,
             data_axis: str = "data") -> "ShardedInvertedIndex":
        import json
        import pathlib

        idx = cls(config, mesh=mesh, data_axis=data_axis)
        path = pathlib.Path(path)
        meta_f = path / "meta.json"
        saved_s = (json.loads(meta_f.read_text())["n_shards"]
                   if meta_f.exists()
                   else len(list(path.glob("part*.meta.json"))) or
                   len({p.name.split(".")[0]
                        for p in path.glob("part*")}))
        if saved_s != idx.n_shards:
            raise ValueError(
                f"sharded BM25 index was saved with {saved_s} shards; "
                f"the current mesh has {idx.n_shards} on "
                f"{data_axis!r} — doc routing (g % S) is baked into the "
                "partition, reload on a matching mesh or re-ingest")
        idx.parts = [InvertedIndex.load(path / f"part{p:03d}",
                                        idx.config)
                     for p in range(idx.n_shards)]
        return idx
