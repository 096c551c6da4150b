"""Inverted index (keyword search) — the Meilisearch replacement.

Host side: vocabulary + per-term postings accumulated incrementally
(Meilisearch ingests 500-doc batches over HTTP, src/lib/meilisearch.ts:137).

Device layout:
- Postings live in per-width BUCKET MATRICES: each term's doc-sorted
  postings (+ build-time precomputed BM25 impacts) occupy one row of the
  (n_terms_w, w) matrix for its power-of-two width bucket, padded with
  doc=_BIG / impact=0. Query-time fetches are then plain row gathers,
  and fetching every term at its own bucket width costs only ~2x the
  final class width (geometric sum).
- Queries are width-classed: each query runs at the max bucket width of
  its own terms, rounded up to BM25Config.width_ladder (bounds compiled
  variants).
- Scoring tail = sort + segment-sum + top-k (kernels/bm25.py); queries
  with huge-df terms split into narrow + wide groups combined exactly
  (kernels/bm25_join.py).

MUTABILITY (growable-segment design, same idea as the dense side):
- adds after the first build land in a TAIL SEGMENT: small per-term
  bucket matrices rebuilt lazily in O(tail_nnz) — the MAIN segment is
  never re-walked (the reference's Meilisearch also absorbs adds
  incrementally; round-1 rebuilt everything per mutation).
- per-document delete (meilisearch.ts:193-194 deleteDocuments filter):
  dead ids are masked by candidate OVERFETCH + host filter, so top-k
  counts are unaffected; postings are physically dropped at the next
  compaction.
- compact() merges the tail + drops dead postings + refreshes BM25
  global stats; it runs automatically once the tail outgrows 25% of the
  main segment or deletes exceed 10% of docs. Between compactions,
  main-segment impacts keep their build-time avgdl and idf counts dead
  docs (bounded, documented drift — standard incremental-index policy).

`rank_compat_scores` reproduces the reference's 1/(rank+1) rank-to-score
conversion (meilisearch.ts:235); default is true Okapi BM25.
`highlight` reproduces the **-wrapped match markup
(meilisearch.ts:222-233).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np

from tpurag.core.config import BM25Config
from tpurag.ingest.tokenizer import tokenize, tokenize_query
from tpurag.kernels.bm25 import (merge_segsum_full_xla, rank_compat,
                                 segsum_topk_candidates)
from tpurag.kernels.bm25_join import combine_narrow_wide
from tpurag.kernels.runtime import NEG_INF, round_up

try:  # C++-accelerated tokenize/count path (optional).
    from tpurag.native import loader as _native
except Exception:  # pragma: no cover
    _native = None

_BIG = 2**30


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length() if x > 2 else max(x, 1)


def _assemble(bucketw, rowid, idf, mats, p_max: int, t: int, widths):
    """Gather (g, t, p_max) candidate (doc, idf*impact) arrays from the
    bucket matrices — each term slot's P-block PLAIN doc-ascending,
    invalid lanes parked at doc=_BIG / contribution 0."""
    g = bucketw.shape[0]
    doc = jnp.full((g, t, p_max), _BIG, jnp.int32)
    con = jnp.zeros((g, t, p_max), jnp.float32)
    for w, (doc_mat, imp_mat) in zip(widths, mats):
        if w > p_max:
            continue
        mask = bucketw == w
        rows = jnp.where(mask, rowid, 0)
        d = jnp.take(doc_mat, rows, axis=0)          # (g, t, w)
        im = jnp.take(imp_mat, rows, axis=0)
        if w < p_max:
            d = jnp.pad(d, ((0, 0), (0, 0), (0, p_max - w)),
                        constant_values=_BIG)
            im = jnp.pad(im, ((0, 0), (0, 0), (0, p_max - w)))
        doc = jnp.where(mask[:, :, None], d, doc)
        con = jnp.where(mask[:, :, None], im, con)
    con = idf[:, :, None] * con
    return doc, con


@functools.partial(jax.jit, static_argnames=("k", "p_max", "t", "widths"))
def _bucket_score(bucketw, rowid, idf, mats, k: int, p_max: int, t: int,
                  widths: tuple[int, ...]):
    """Assemble (g, t, p_max) candidates from bucket matrices by row
    gather, apply idf, and run the sort + segsum top-k tail.

    bucketw/rowid/idf: (g, t) int32/int32/float32 per query-term slot
    (bucketw 0 = empty slot). mats: tuple of (doc, imp) matrix pairs
    aligned with `widths`."""
    doc, con = _assemble(bucketw, rowid, idf, mats, p_max, t, widths)
    g = bucketw.shape[0]
    return segsum_topk_candidates(doc.reshape(g, t * p_max),
                                  con.reshape(g, t * p_max), k=k, window=t)


@functools.partial(jax.jit, static_argnames=("p_max", "t", "widths"))
def _class_full_rows(bucketw, rowid, idf, mats, p_max: int, t: int,
                     widths):
    """One class -> full doc-sorted segsummed rows (seg, doc_s), each
    (g, t*p_max): exact per-doc partial sums at segment-end lanes."""
    doc, con = _assemble(bucketw, rowid, idf, mats, p_max, t, widths)
    g = bucketw.shape[0]
    return merge_segsum_full_xla(doc.reshape(g, t * p_max),
                                 con.reshape(g, t * p_max), p=p_max, t=t)


def wide_flow(n_classes, w_classes, h: int, kk: int, wn_max: int, mats,
              widths):
    """Device-side flow for queries containing wide terms; traceable
    (called inside jit by bench.py's chained step, or eagerly by
    _score_wide where each _class_full_rows call is itself jitted).

    n_classes/w_classes: lists of (p_max, t, sel, n_real, bucketw,
    rowid, idf) — sel (g,) int32 positions into the h-row output,
    n_real <= g the unpadded member count. Narrow classes fill an
    (h, wn_max) full-row buffer; each wide class then combines against
    its members' narrow rows (kernels/bm25_join.combine_narrow_wide).
    Returns (h, kk) scores/ids."""
    n_val = jnp.full((h, wn_max), NEG_INF, jnp.float32)
    n_doc = jnp.full((h, wn_max), _BIG, jnp.int32)
    for (p_max, t, sel, n_real, bw, ri, idf) in n_classes:
        seg, doc_s = _class_full_rows(bw, ri, idf, mats, p_max=p_max, t=t,
                                      widths=widths)
        if seg.shape[1] < wn_max:
            pad = wn_max - seg.shape[1]
            seg = jnp.pad(seg, ((0, 0), (0, pad)),
                          constant_values=NEG_INF)
            doc_s = jnp.pad(doc_s, ((0, 0), (0, pad)),
                            constant_values=_BIG)
        n_val = n_val.at[sel].set(seg[:n_real])
        n_doc = n_doc.at[sel].set(doc_s[:n_real])
    # One doc spans at most max_narrow_t + wide_t lanes across the two
    # merged sides (once per query-term slot per side) — the static
    # window for the shift-add segment sum inside the combine.
    max_tn = max((t for (_, t, *_) in n_classes), default=0)
    scores = jnp.full((h, kk), NEG_INF, jnp.float32)
    ids = jnp.full((h, kk), -1, jnp.int32)
    for (p_max, t, sel, n_real, bw, ri, idf) in w_classes:
        w_seg, w_doc = _class_full_rows(bw, ri, idf, mats, p_max=p_max,
                                        t=t, widths=widths)
        s, i = combine_narrow_wide(n_val[sel], n_doc[sel],
                                   w_seg[:n_real], w_doc[:n_real], k=kk,
                                   window=max(2, max_tn + t))
        scores = scores.at[sel].set(s)
        ids = ids.at[sel].set(i)
    return scores, ids


@dataclasses.dataclass
class _Layout:
    """One device-resident postings segment."""

    widths: tuple
    mats: tuple               # ((doc, imp) jnp pairs) aligned with widths
    term_bucket: np.ndarray   # (V,) int32 bucket width, 0 = term absent
    term_row: np.ndarray      # (V,) int32 row index (0 = pad row)
    nnz: int = 0


def highlight(text: str, query_tokens: list[str],
              mark: str = "**") -> str:
    """Wrap query-term matches in `mark` (meilisearch.ts:222-233
    _formatted content with highlightPreTag/PostTag)."""
    toks = sorted({t for t in query_tokens if t}, key=len, reverse=True)
    if not toks:
        return text
    pat = re.compile("|".join(re.escape(t) for t in toks), re.IGNORECASE)
    return pat.sub(lambda m: f"{mark}{m.group(0)}{mark}", text)


class InvertedIndex:
    # Auto-compaction policy (tail/delete growth bounds).
    TAIL_COMPACT_RATIO = 0.25
    TAIL_COMPACT_MIN = 4096
    DEAD_COMPACT_RATIO = 0.10
    DEAD_COMPACT_MIN = 64

    def __init__(self, config: BM25Config | None = None):
        self.config = config or BM25Config()
        self.vocab: dict[str, int] = {}
        self._postings_doc: list[list[int]] = []   # per-term doc ids
        self._postings_tf: list[list[int]] = []    # per-term frequencies
        self.doc_len: list[int] = []               # tokens per doc id
        self.n_docs = 0                            # live docs
        self._total_tokens = 0                     # live token count
        # Segments.
        self._main: _Layout | None = None
        self._main_count: list[int] = []  # per-term postings in main
        self._tail: _Layout | None = None
        self._tail_nnz = 0
        self._dead: set[int] = set()      # deleted ids still in layouts
        self._builds = 0                  # full compactions (observable)
        # Sharded wrapper hook: parts of a doc-partitioned index must
        # bake impacts with the GLOBAL average doc length, not their
        # shard-local one, for score parity with a single index.
        self.avgdl_override: float | None = None
        # Searches are reads under the KB's RWLock, but a read can
        # trigger the lazy compaction — single-flight it so concurrent
        # readers never rebuild layouts simultaneously.
        import threading

        self._build_lock = threading.Lock()

    # -- build ---------------------------------------------------------------

    def add(self, doc_id: int, text: str) -> None:
        """Index one document under external integer id `doc_id`.

        doc_id must equal the dense-index row id so RRF fusion can match
        candidates across sources by id. After the first build, postings
        land in the tail segment — no main-segment rebuild."""
        if _native is not None and _native.available():
            counts = _native.term_counts(text)
        else:
            counts: dict[str, int] = {}
            for tok in tokenize(text):
                counts[tok] = counts.get(tok, 0) + 1
        total = 0
        for term, c in counts.items():
            tid = self.vocab.get(term)
            if tid is None:
                tid = len(self.vocab)
                self.vocab[term] = tid
                self._postings_doc.append([])
                self._postings_tf.append([])
                self._main_count.append(0)
            self._postings_doc[tid].append(doc_id)
            self._postings_tf[tid].append(c)
            total += c
        while len(self.doc_len) <= doc_id:
            self.doc_len.append(0)
        self.doc_len[doc_id] = total
        self.n_docs += 1
        self._total_tokens += total
        if self._main is not None:
            self._tail_nnz += len(counts)
            self._tail = None  # lazily rebuilt (O(tail_nnz))

    def add_batch(self, ids, texts) -> None:
        """Index a batch. With the native library this is ONE C call
        (tokenize + count, packed arrays back) plus grouped bulk
        postings extends — one list.extend per term instead of one
        append per posting (measured 19k -> 25k docs/s on the 1-core
        host at 120-token docs; the reference batches its Meilisearch
        ingest the same way, meilisearch.ts:137)."""
        ids = [int(i) for i in ids]
        texts = list(texts)
        if (len(ids) < 8 or _native is None
                or not _native.batch_available()):
            for i, t in zip(ids, texts):
                self.add(i, t)
            return
        if _native.postings_available():
            self._add_batch_grouped(ids, texts)
            return
        terms, doc_nt, pairs = _native.batch_term_counts(texts)
        tid_of = np.empty(max(len(terms), 1), np.int64)
        for u, term in enumerate(terms):
            tid = self.vocab.get(term)
            if tid is None:
                tid = len(self.vocab)
                self.vocab[term] = tid
                self._postings_doc.append([])
                self._postings_tf.append([])
                self._main_count.append(0)
            tid_of[u] = tid
        doc_of_pair = np.repeat(np.asarray(ids, np.int64), doc_nt)
        cnts = pairs[:, 1].astype(np.int64)
        ptids = tid_of[pairs[:, 0]]
        # Group pairs by term (stable: preserves doc arrival order
        # within each term, matching sequential add()).
        order = np.argsort(ptids, kind="stable")
        sp, sd, sc = ptids[order], doc_of_pair[order], cnts[order]
        if len(sp):  # a batch of all-stopword/punct docs has no pairs
            bounds = np.flatnonzero(np.diff(sp)) + 1
            starts = np.concatenate(([0], bounds))
            ends = np.concatenate((bounds, [len(sp)]))
            for a, b in zip(starts.tolist(), ends.tolist()):
                tid = int(sp[a])
                self._postings_doc[tid].extend(sd[a:b].tolist())
                self._postings_tf[tid].extend(sc[a:b].tolist())
        totals = np.zeros(len(ids), np.int64)
        np.add.at(totals, np.repeat(np.arange(len(ids)), doc_nt), cnts)
        top = max(ids)
        if len(self.doc_len) <= top:
            self.doc_len.extend([0] * (top + 1 - len(self.doc_len)))
        for i, t in zip(ids, totals.tolist()):
            self.doc_len[i] = t
        self.n_docs += len(ids)
        self._total_tokens += int(totals.sum())
        if self._main is not None:
            self._tail_nnz += len(pairs)
            self._tail = None  # lazily rebuilt (O(tail_nnz))

    def _add_batch_grouped(self, ids: list[int], texts: list[str]) -> None:
        """Batch add via the round-3 native ABI: tokenize + count + group
        by term all happen in ONE C call (tokenizer.cc:tr_batch_postings),
        so the Python side is just vocab mapping + per-term bulk extends —
        no argsort, no pair restructuring (measured 7.1k -> 32.3k docs/s
        at 200-token docs on the 1-core host, benchmarks/ingest_bench.py)."""
        terms, doc_total, gcount, gdoc, gcnt = _native.batch_postings(texts)
        tid_of = np.empty(max(len(terms), 1), np.int64)
        for u, term in enumerate(terms):
            tid = self.vocab.get(term)
            if tid is None:
                tid = len(self.vocab)
                self.vocab[term] = tid
                self._postings_doc.append([])
                self._postings_tf.append([])
                self._main_count.append(0)
            tid_of[u] = tid
        gids = np.asarray(ids, np.int64)[gdoc]  # global doc id per pair
        ends = np.cumsum(gcount)
        starts = ends - gcount
        gcnt64 = gcnt.astype(np.int64)
        for u, (a, b) in enumerate(zip(starts.tolist(), ends.tolist())):
            if a == b:
                continue
            tid = int(tid_of[u])
            self._postings_doc[tid].extend(gids[a:b].tolist())
            self._postings_tf[tid].extend(gcnt64[a:b].tolist())
        top = max(ids)
        if len(self.doc_len) <= top:
            self.doc_len.extend([0] * (top + 1 - len(self.doc_len)))
        totals = doc_total.tolist()
        for i, t in zip(ids, totals):
            self.doc_len[i] = t
        self.n_docs += len(ids)
        self._total_tokens += int(doc_total.sum())
        if self._main is not None:
            self._tail_nnz += int(len(gdoc))
            self._tail = None  # lazily rebuilt (O(tail_nnz))

    def delete_doc(self, doc_id: int) -> None:
        """Tombstone one document (meilisearch.ts:193-194). Search
        overfetches past dead ids until the next compaction physically
        drops the postings."""
        doc_id = int(doc_id)
        if doc_id in self._dead or doc_id >= len(self.doc_len):
            return
        self._dead.add(doc_id)
        self.n_docs = max(self.n_docs - 1, 0)
        self._total_tokens -= self.doc_len[doc_id]

    def delete_docs(self, ids) -> None:
        for i in np.atleast_1d(ids):
            self.delete_doc(int(i))

    @property
    def _avgdl(self) -> float:
        if self.avgdl_override is not None:
            return max(self.avgdl_override, 1.0)
        return max(self._total_tokens / max(self.n_docs, 1), 1.0)

    def _impacts(self, tid: int, start: int, end: int, dnorm: np.ndarray):
        docs = np.asarray(self._postings_doc[tid][start:end], np.int64)
        tfs = np.asarray(self._postings_tf[tid][start:end], np.float32)
        k1 = self.config.k1
        return docs, tfs * (k1 + 1.0) / (tfs + dnorm[docs])

    def _dnorm(self) -> np.ndarray:
        n = len(self.doc_len)
        dl = np.asarray(self.doc_len, np.float32) if n else np.zeros(
            1, np.float32)
        k1, b = self.config.k1, self.config.b
        return np.maximum(k1 * (1.0 - b + b * dl / self._avgdl), 1e-6)

    def _build_layout(self, ranges: list[tuple[int, int]]) -> _Layout:
        """Build one segment layout from per-term posting ranges.

        Packing is fully vectorized (one flat scatter per width bucket)
        — postings arrive doc-ascending (chunk ids are monotone), so no
        per-term sort is needed. The per-term python loop survives only
        on the head_m (impact-pruned) path. ~12x faster than per-term
        packing; matters at compaction time on multi-million-doc KBs."""
        v = len(self._postings_doc)
        dnorm = self._dnorm()
        head_m = self.config.head_m if not self.config.exact_scoring else 0
        term_bucket = np.zeros(v, np.int32)
        term_row = np.zeros(v, np.int32)
        by_width: dict[int, list[int]] = {}
        nnz = 0
        for tid in range(v):
            s, e = ranges[tid]
            cnt = e - s
            if cnt <= 0:
                continue
            eff = min(cnt, head_m) if head_m > 0 else cnt
            w = _next_pow2(max(eff, 16))
            term_bucket[tid] = w
            term_row[tid] = len(by_width.setdefault(w, []))
            by_width[w].append(tid)
            nnz += cnt
        k1 = self.config.k1
        mats = []
        widths = tuple(sorted(by_width))
        for w in widths:
            tids = by_width[w]
            doc_mat = np.full((len(tids) + 1, w), _BIG, np.int32)
            imp_mat = np.zeros((len(tids) + 1, w), np.float32)
            if head_m > 0 and any(
                    ranges[t][1] - ranges[t][0] > w for t in tids):
                for row, tid in enumerate(tids):
                    s, e = ranges[tid]
                    docs, imps = self._impacts(tid, s, e, dnorm)
                    if len(docs) > w:
                        # Impact-ordered head: keep top-w by impact,
                        # doc-sorted (approximate; BM25Config.head_m).
                        top = np.argpartition(-imps, w - 1)[:w]
                        top = top[np.argsort(docs[top], kind="stable")]
                        docs, imps = docs[top], imps[top]
                    doc_mat[row + 1, : len(docs)] = docs
                    imp_mat[row + 1, : len(imps)] = imps
            else:
                lens = np.fromiter(
                    (ranges[t][1] - ranges[t][0] for t in tids), np.int64,
                    len(tids))
                total = int(lens.sum())
                docs = np.empty(total, np.int64)
                tfs = np.empty(total, np.float32)
                pos = 0
                for tid, ln in zip(tids, lens):
                    s, e = ranges[tid]
                    docs[pos:pos + ln] = self._postings_doc[tid][s:e]
                    tfs[pos:pos + ln] = self._postings_tf[tid][s:e]
                    pos += ln
                rows = np.repeat(np.arange(1, len(tids) + 1), lens)
                # Rows must be doc-sorted for the wide-class merge tree;
                # adds are normally monotone — verify, lexsort otherwise.
                if total > 1 and not np.all((np.diff(docs) >= 0)
                                            | (np.diff(rows) != 0)):
                    order = np.lexsort((docs, rows))
                    docs, tfs = docs[order], tfs[order]
                imps = tfs * (k1 + 1.0) / (tfs + dnorm[docs])
                # Row 0 is the pad row (gathered by empty slots).
                offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
                cols = np.arange(total) - np.repeat(offs, lens)
                doc_mat[rows, cols] = docs
                imp_mat[rows, cols] = imps
            mats.append((jnp.asarray(doc_mat), jnp.asarray(imp_mat)))
        return _Layout(widths=widths, mats=tuple(mats),
                       term_bucket=term_bucket, term_row=term_row, nnz=nnz)

    def compact(self) -> None:
        """Full rebuild: drop dead postings, absorb the tail, refresh
        BM25 global stats. O(total nnz) — amortized by the policy."""
        if self._dead:
            for tid in range(len(self._postings_doc)):
                docs = self._postings_doc[tid]
                if not any(d in self._dead for d in docs):
                    continue
                tfs = self._postings_tf[tid]
                keep = [j for j, d in enumerate(docs)
                        if d not in self._dead]
                self._postings_doc[tid] = [docs[j] for j in keep]
                self._postings_tf[tid] = [tfs[j] for j in keep]
            for d in self._dead:
                self.doc_len[d] = 0
            self._dead = set()
        self._main_count = [len(p) for p in self._postings_doc]
        self._main = self._build_layout(
            [(0, c) for c in self._main_count])
        self._tail = None
        self._tail_nnz = 0
        self._builds += 1

    # Back-compat alias (round-1 name).
    _build_device = compact

    def _needs_compact(self) -> bool:
        if self._main is None:
            return True
        if self._tail_nnz > max(self.TAIL_COMPACT_MIN,
                                self.TAIL_COMPACT_RATIO * self._main.nnz):
            return True
        if len(self._dead) > max(self.DEAD_COMPACT_MIN,
                                 self.DEAD_COMPACT_RATIO * max(self.n_docs, 1)):
            return True
        return False

    def _tail_layout(self) -> _Layout:
        if self._tail is None:
            self._tail = self._build_layout(
                [(c, len(p)) for c, p in
                 zip(self._main_count, self._postings_doc)])
        return self._tail

    # -- query ---------------------------------------------------------------

    def query_idf_mass(self, queries: list[str]) -> np.ndarray:
        """Per-query total idf mass: Σ idf over ALL query tokens,
        including out-of-vocabulary ones (df=0 → the Okapi formula's
        maximum idf). best_bm25_score / idf_mass ≈ the idf-weighted
        fraction of the query a hit actually matched (per-term impact
        tops out near 1 at tf=1/avg length), which is the confidence
        signal the hybrid engine's keyword-coverage gate thresholds on
        (engine/hybrid.py; the reference's analogue is its
        keyword-coverage rerank term, dedup-filter.ts:132-155).
        Host-side numpy, O(total query tokens)."""
        df_live = max(self.n_docs, 1)
        out = np.zeros(len(queries), np.float32)
        for qi, q in enumerate(queries):
            mass = 0.0
            for tok in tokenize_query(q):
                tid = self.vocab.get(tok)
                df = (0 if tid is None
                      else min(len(self._postings_doc[tid]), df_live))
                mass += math.log(1.0 + (df_live - df + 0.5) / (df + 0.5))
            out[qi] = mass
        return out

    def search(self, queries: list[str], k: int, as_device: bool = False):
        """BM25 top-k for a batch of text queries.

        Returns (scores, ids) as (B, k) float32/int32 numpy arrays;
        empty slots are (-inf, -1). as_device=True skips the final
        host transfer and returns jax arrays (for callers that fuse
        further on-device, e.g. hybrid RRF)."""
        bqueries = [tokenize_query(q) for q in queries]
        return self.search_tokens(bqueries, k, as_device=as_device)

    def _score(self, rows: list[list[int]], kk: int,
               layout: _Layout) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Score one segment: width-class the queries against this
        layout's buckets and run the fused scoring tail per class.
        Queries containing huge-df terms (bucket width >
        config.wide_term_width) split additively into narrow + wide
        groups combined exactly (kernels/bm25_join.py) — the wide terms
        no longer drag the whole query's class width up.

        Returns DEVICE arrays: per-class results scatter into one
        (B, kk) device buffer instead of syncing to host per class —
        a search launches every class back-to-back and the caller
        converts once (each avoided sync is a full host round-trip,
        a device-to-host wait)."""
        bsz = len(rows)
        scores = jnp.full((bsz, kk), NEG_INF, jnp.float32)
        ids = jnp.full((bsz, kk), -1, jnp.int32)
        if not layout.mats:
            return scores, ids
        tb = layout.term_bucket
        v = len(tb)  # terms born after this layout was built are absent
        wide_w = self.config.wide_term_width
        wide_rows = [[t for t in tids if t < v and tb[t] > wide_w]
                     for tids in rows]
        hard = [bi for bi in range(bsz) if wide_rows[bi]]
        if not hard:
            return self._score_classed(rows, kk, layout, scores, ids,
                                       list(range(bsz)))
        simple = [bi for bi in range(bsz) if not wide_rows[bi]]
        if simple:
            scores, ids = self._score_classed(
                [rows[bi] for bi in simple], kk, layout, scores, ids,
                simple)
        narrow_rows = [[t for t in rows[bi]
                        if t < v and 0 < tb[t] <= wide_w] for bi in hard]
        s, i = self._score_wide(narrow_rows,
                                [wide_rows[bi] for bi in hard],
                                kk, layout)
        sel = jnp.asarray(np.asarray(hard, np.int32))
        scores = scores.at[sel].set(s[:, :kk])
        ids = ids.at[sel].set(i[:, :kk])
        return scores, ids

    def _score_classed(self, rows: list[list[int]], kk: int,
                       layout: _Layout, scores, ids, members_map):
        """The classed fused path for queries without wide terms:
        scatter results into (scores, ids) at members_map positions."""
        bsz = len(rows)
        ladder = tuple(sorted(self.config.width_ladder or ()))
        tb, tr = layout.term_bucket, layout.term_row
        v = len(tb)

        def row_pmax(tids):
            p = max((int(tb[t]) for t in tids if t < v and tb[t] > 0),
                    default=16)
            for w in ladder:
                if w >= p:
                    return w
            return p

        if self.config.width_classes and bsz > 1:
            groups: dict[tuple[int, int], list[int]] = {}
            for bi, tids in enumerate(rows):
                key = (row_pmax(tids), _next_pow2(max(len(tids), 1)))
                groups.setdefault(key, []).append(bi)
        else:
            groups = {(max((row_pmax(r) for r in rows), default=16),
                       _next_pow2(max((len(r) for r in rows), default=1)))
                      : list(range(bsz))}

        df_live = max(self.n_docs, 1)
        for (p_max, t_max), members in groups.items():
            # A class can't yield more candidates than it has lanes.
            k_eff = min(kk, t_max * p_max)
            g = len(members)
            bucketw = np.zeros((g, t_max), np.int32)
            rowid = np.zeros((g, t_max), np.int32)
            idf = np.zeros((g, t_max), np.float32)
            for gi, bi in enumerate(members):
                for ti, tid in enumerate(rows[bi]):
                    if tid >= v or tb[tid] == 0:
                        continue  # term absent from this segment
                    bucketw[gi, ti] = tb[tid]
                    rowid[gi, ti] = tr[tid] + 1  # +1: row 0 = pad
                    # df counts dead postings until compaction; clamp to
                    # the live doc count so Okapi idf stays positive
                    # (negative contributions read as empty lanes in the
                    # segsum tail).
                    df = min(len(self._postings_doc[tid]), df_live)
                    idf[gi, ti] = math.log(
                        1.0 + (df_live - df + 0.5) / (df + 0.5))
            s, i = _bucket_score(
                jnp.asarray(bucketw), jnp.asarray(rowid), jnp.asarray(idf),
                layout.mats, k=k_eff, p_max=p_max, t=t_max,
                widths=layout.widths)
            if s.shape[1] < kk:
                s = jnp.pad(s, ((0, 0), (0, kk - s.shape[1])),
                            constant_values=NEG_INF)
                i = jnp.pad(i, ((0, 0), (0, kk - i.shape[1])),
                            constant_values=-1)
            sel = jnp.asarray(
                np.asarray([members_map[bi] for bi in members], np.int32))
            scores = scores.at[sel].set(s[:, :kk])
            ids = ids.at[sel].set(i[:, :kk])
        return scores, ids

    def _score_wide(self, narrow_rows: list[list[int]],
                    wide_rows: list[list[int]], kk: int,
                    layout: _Layout):
        """Queries with huge-df terms. Narrow terms produce full
        doc-sorted segsummed rows (one fused merge per narrow class);
        wide terms produce the same per (own-width, term-count) wide
        class; kernels/bm25_join.combine_narrow_wide adds the partial
        sums exactly and returns top-kk. Candidate width is each
        TERM's own bucket width — a df-20k term no longer pads the
        query's 7 narrow terms to 32768 lanes, and nothing here runs
        a full lax.sort."""
        h = len(narrow_rows)
        ladder = tuple(sorted(self.config.width_ladder or ()))
        tb, tr = layout.term_bucket, layout.term_row
        df_live = max(self.n_docs, 1)

        def idf_of(tid):
            df = min(len(self._postings_doc[tid]), df_live)
            return math.log(1.0 + (df_live - df + 0.5) / (df + 0.5))

        def class_inputs(members, rows_of, t_max):
            g = len(members)
            bucketw = np.zeros((g, t_max), np.int32)
            rowid = np.zeros((g, t_max), np.int32)
            idf = np.zeros((g, t_max), np.float32)
            for gi, hi in enumerate(members):
                for ti, tid in enumerate(rows_of[hi]):
                    bucketw[gi, ti] = tb[tid]
                    rowid[gi, ti] = tr[tid] + 1  # +1: row 0 = pad
                    idf[gi, ti] = idf_of(tid)
            return (jnp.asarray(bucketw), jnp.asarray(rowid),
                    jnp.asarray(idf))

        # Narrow side: full rows scattered into one (h, wn_max) buffer
        # so each wide class can select its members' rows directly.
        def row_pmax_n(tids):
            p = max((int(tb[t]) for t in tids), default=16)
            for w in ladder:
                if w >= p:
                    return w
            return p

        n_groups: dict[tuple[int, int], list[int]] = {}
        for hi, tids in enumerate(narrow_rows):
            key = (row_pmax_n(tids), _next_pow2(max(len(tids), 1)))
            n_groups.setdefault(key, []).append(hi)
        wn_max = max(p * t for (p, t) in n_groups)
        w_groups: dict[tuple[int, int], list[int]] = {}
        for hi, tids in enumerate(wide_rows):
            key = (max(int(tb[t]) for t in tids),
                   _next_pow2(max(len(tids), 1)))
            w_groups.setdefault(key, []).append(hi)

        def to_class_list(groups, rows_of):
            out = []
            for (p_max, t_max), members in groups.items():
                bw, ri, idf = class_inputs(members, rows_of, t_max)
                sel = jnp.asarray(np.asarray(members, np.int32))
                out.append((p_max, t_max, sel, len(members), bw, ri, idf))
            return out

        return wide_flow(to_class_list(n_groups, narrow_rows),
                         to_class_list(w_groups, wide_rows),
                         h=h, kk=kk, wn_max=wn_max, mats=layout.mats,
                         widths=layout.widths)

    def search_tokens(self, token_lists: list[list[str]], k: int,
                      as_device: bool = False):
        bsz = len(token_lists)
        with self._build_lock:  # single-flight the lazy compaction
            if self._needs_compact():
                self.compact()
            main, tail_nnz = self._main, self._tail_nnz
        n = len(self.doc_len)
        if n == 0 or self.n_docs == 0:
            empty_s = np.full((bsz, k), NEG_INF, np.float32)
            empty_i = np.full((bsz, k), -1, np.int32)
            if as_device:
                return jnp.asarray(empty_s), jnp.asarray(empty_i)
            return empty_s, empty_i
        df_cap = int(self.config.max_df_ratio * max(self.n_docs, 1))
        rows = []
        for toks in token_lists:
            tids = [self.vocab[t] for t in toks if t in self.vocab]
            if self.config.max_df_ratio < 1.0:
                tids = [t for t in tids
                        if len(self._postings_doc[t]) <= df_cap]
            rows.append(tids)

        # Overfetch past tombstones (dead ids filtered below), rounded
        # to bound compiled kernel variants.
        extra = round_up(len(self._dead), 8) if self._dead else 0
        kk = min(k + extra, max(n, 1))

        # Device-resident until the single final conversion: every
        # branch below launches async and the one np.asarray pair at
        # the bottom is the only host sync the whole search pays.
        scores, ids = self._score(rows, kk, main)
        if tail_nnz:
            with self._build_lock:
                tail = self._tail_layout()
            s2, i2 = self._score(rows, kk, tail)
            # Main/tail doc sets are disjoint (tail = docs added after
            # the last compaction): plain candidate merge.
            from tpurag.kernels.topk import merge_topk

            scores, ids = merge_topk(scores, ids, s2, i2, kk)
            ids = jnp.where(scores <= NEG_INF / 2, -1, ids)
        if self._dead:
            dead_dev = jnp.asarray(np.fromiter(self._dead, np.int32,
                                               len(self._dead)))
            dead = jnp.isin(ids, dead_dev)
            scores = jnp.where(dead, NEG_INF, scores)
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
        if self.config.rank_compat_scores:
            scores = rank_compat(scores)
        if as_device:
            return scores, ids
        return np.asarray(scores), np.asarray(ids)

    def __len__(self) -> int:
        return self.n_docs

    # -- persistence (binary postings, SURVEY.md §5.4) -----------------------

    def save(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        offsets = np.zeros(len(self._postings_doc) + 1, np.int64)
        np.cumsum([len(p) for p in self._postings_doc], out=offsets[1:])
        flat_doc = np.fromiter(
            (d for p in self._postings_doc for d in p), np.int32,
            int(offsets[-1]))
        flat_tf = np.fromiter(
            (t for p in self._postings_tf for t in p), np.int32,
            int(offsets[-1]))
        np.savez(
            path,
            vocab=json.dumps(self.vocab, ensure_ascii=False),
            doc_len=np.asarray(self.doc_len, np.int32),
            n_docs=self.n_docs,
            total_tokens=self._total_tokens,
            post_offsets=offsets,
            post_doc=flat_doc,
            post_tf=flat_tf,
            dead=np.fromiter(self._dead, np.int32, len(self._dead)),
        )

    @classmethod
    def load(cls, path, config: BM25Config | None = None) -> "InvertedIndex":
        data = np.load(pathlib.Path(path).with_suffix(".npz"),
                       allow_pickle=False)
        idx = cls(config)
        idx.vocab = json.loads(str(data["vocab"]))
        idx.doc_len = [int(x) for x in data["doc_len"]]
        idx.n_docs = int(data["n_docs"])
        if "post_offsets" in data:
            offs = data["post_offsets"]
            fd = data["post_doc"]
            ft = data["post_tf"]
            idx._postings_doc = [fd[offs[i]:offs[i + 1]].tolist()
                                 for i in range(len(offs) - 1)]
            idx._postings_tf = [ft[offs[i]:offs[i + 1]].tolist()
                                for i in range(len(offs) - 1)]
            idx._total_tokens = int(data["total_tokens"])
            idx._dead = set(int(x) for x in data["dead"])
        else:  # round-1 JSON format
            p = json.loads(str(data["postings"]))
            idx._postings_doc = p["doc"]
            idx._postings_tf = p["tf"]
            idx._total_tokens = sum(idx.doc_len)
        idx._main_count = [0] * len(idx._postings_doc)
        return idx
