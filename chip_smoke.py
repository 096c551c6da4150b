"""One pass over tpurag's main path on one NVIDIA GPU, checked against NumPy.

    python chip_smoke.py                # one card, the phases below
    python chip_smoke.py --four-cards   # the sharded path on four cards
    python chip_smoke.py --rehearse --n 20000   # CPU dry run, no result

Phases, each printed as one line (name, seconds, result, tolerance):

  A  hybrid at real size: KnowledgeBase("smoke", dim=1024), bf16 storage,
     --n chunks (default 1,000,000) of seeded Zipf text (vocab 50k, ~40
     tokens) with seeded clustered unit vectors, 512 queries in hybrid,
     vector and keyword modes, top-8, against NumPy: dense scores in
     float64 over the bf16-rounded corpus and queries, Okapi BM25 from the
     generated tokens, host-side RRF with the preset's constants.
  B  IVF on that KB (kb.build_ivf): full probe equals exact, recall@10 at
     the tuned nprobe, modes ivf and hybrid_ivf; then the same on a
     quant=True KB, whose int8 scan must hold a bounded working set.
  C  the served path: RagServer in-process, POST /search equals kb.search.
  D  the on-chip encoder: EncoderConfig.base() from random init, 64 chunks
     through EncoderEmbedder against the float32 forward at "highest"
     matmul precision.
  E  the dense Triton kernel compiled at 100k x 1024 (b=768) and 1M x 1024
     (b=512): memory analysis, times beside dense_topk_xla, and the
     phase-A reference; then KnowledgeBase.search_batch on the phase-A KB
     timed with the dense leg on the kernel and on dense_topk_xla.

Any failed check raises and the script exits non-zero; on success the last
line of standard output is one JSON object naming the device. Without a GPU
it exits non-zero before measuring anything.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

K = 8
N_QUERIES = 512
DIM = 1024
VOCAB = 50_000
SEED = 0


# -- reference arithmetic (NumPy only) ------------------------------------


def bf16_round(x) -> np.ndarray:
    """float32 values rounded to bfloat16, as the device stores them."""
    import ml_dtypes

    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def normalize_f32(x) -> np.ndarray:
    """Row L2 normalization in float32 (the index's formula)."""
    x = np.asarray(x, np.float32)
    n = np.sqrt(np.sum(x * x, axis=1, keepdims=True))
    return x / np.maximum(n, np.float32(1e-30))


def topk_rows(scores: np.ndarray, ids: np.ndarray, k: int):
    """Top-k of each row by (score desc, id asc)."""
    order = np.lexsort((ids, -scores), axis=1)[:, :k]
    return (np.take_along_axis(scores, order, axis=1),
            np.take_along_axis(ids, order, axis=1))


def np_dense_topk(q: np.ndarray, corpus, n: int, k: int,
                  block: int = 1 << 16):
    """Exact cosine top-k in float64 over rows [0, n) of `corpus` (any
    float dtype, already as the device holds it); q (B, D) likewise."""
    q64 = np.asarray(q, np.float64)
    best_v = np.full((len(q), k), -np.inf)
    best_i = np.full((len(q), k), -1, np.int64)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        s = q64 @ np.asarray(corpus[lo:hi], np.float64).T
        m = min(k, hi - lo)
        part = np.argpartition(-s, m - 1, axis=1)[:, :m]
        cand_v = np.concatenate(
            [best_v, np.take_along_axis(s, part, axis=1)], axis=1)
        cand_i = np.concatenate([best_i, part + lo], axis=1)
        best_v, best_i = topk_rows(cand_v, cand_i, k)
    return best_v, best_i


@dataclasses.dataclass
class Postings:
    """Term-major postings built from the generated tokens alone."""

    start: np.ndarray    # (V+1,) offsets into doc/tf
    doc: np.ndarray      # (nnz,) doc ids, ascending per term
    tf: np.ndarray       # (nnz,) term frequencies
    dl: np.ndarray       # (n,) tokens per doc
    n: int

    @classmethod
    def build(cls, tok: np.ndarray, lens: np.ndarray, vocab: int):
        n = len(lens)
        doc_of = np.repeat(np.arange(n, dtype=np.int64), lens)
        key, tf = np.unique(tok.astype(np.int64) * n + doc_of,
                            return_counts=True)
        term, doc = np.divmod(key, n)
        start = np.zeros(vocab + 1, np.int64)
        np.cumsum(np.bincount(term, minlength=vocab), out=start[1:])
        return cls(start, doc, tf, np.asarray(lens, np.int64), n)

    def df(self, t: int) -> int:
        return int(self.start[t + 1] - self.start[t])

    def idf(self, t: int) -> float:
        df = self.df(t)
        return float(np.log(1.0 + (self.n - df + 0.5) / (df + 0.5)))


def np_bm25_topk(post: Postings, query_terms: list[list[int]], k: int,
                 k1: float = 1.2, b: float = 0.75):
    """Okapi BM25 top-k per query (scores > 0 only), float64:
    sum over query terms of idf * tf (k1+1) / (tf + k1 (1 - b + b dl/avgdl)),
    idf = log(1 + (N - df + 0.5) / (df + 0.5))."""
    avgdl = max(post.dl.sum() / max(post.n, 1), 1.0)
    dnorm = k1 * (1.0 - b + b * post.dl / avgdl)
    acc = np.zeros(post.n)
    vals = np.full((len(query_terms), k), -np.inf)
    ids = np.full((len(query_terms), k), -1, np.int64)
    for qi, terms in enumerate(query_terms):
        touched = []
        for t in terms:
            s, e = post.start[t], post.start[t + 1]
            d, tf = post.doc[s:e], post.tf[s:e]
            acc[d] += post.idf(t) * tf * (k1 + 1.0) / (tf + dnorm[d])
            touched.append(d)
        if touched:
            d = np.unique(np.concatenate(touched))
            sc = acc[d]
            acc[d] = 0.0
            v, i = topk_rows(sc[None], d[None], min(k, len(d)))
            live = v[0] > 0
            vals[qi, :live.sum()] = v[0][live]
            ids[qi, :live.sum()] = i[0][live]
    return vals, ids


def np_rrf(legs, weights, rrf_k: int, both_bonus: float, final_k: int):
    """Reciprocal-rank fusion of ranked id lists (-1 = empty slot):
    sum_s w_s / (rrf_k + rank + 1), plus both_bonus for ids in >= 2
    lists; ties by smaller id. Returns (scores, ids) per query."""
    out_v, out_i = [], []
    for q in range(len(legs[0])):
        score, hits = {}, {}
        for leg, w in zip(legs, weights):
            for r, i in enumerate(leg[q]):
                if i >= 0:
                    score[i] = score.get(i, 0.0) + w / (rrf_k + r + 1.0)
                    hits[i] = hits.get(i, 0) + 1
        ranked = sorted(((-(s + (both_bonus if hits[i] >= 2 else 0.0)), i)
                         for i, s in score.items()))[:final_k]
        out_v.append([-s for s, _ in ranked])
        out_i.append([i for _, i in ranked])
    return out_v, out_i


def check_topk(name, got_v, got_i, ref_v, ref_i, atol=0.0, rtol=0.0,
               gap=1e-5):
    """Device top-k lists against the reference: every returned id's
    score matches the reference score at its rank, and ids match except
    where the reference's neighbouring scores are closer than `gap`
    (relative when rtol is set). Returns a summary; raises on failure."""
    worst, checked, tied = 0.0, 0, 0
    for q in range(len(ref_i)):
        rv = np.asarray(ref_v[q], np.float64)
        ri = np.asarray(ref_i[q])
        live = ri >= 0
        rv, ri = rv[live], ri[live]
        gv = np.asarray(got_v[q], np.float64)
        gi = np.asarray(got_i[q])
        if len(gi) != len(ri):
            raise AssertionError(f"{name}: query {q} returned {len(gi)} "
                                 f"hits, reference {len(ri)}")
        if not len(ri):
            continue
        tol = atol + rtol * np.abs(rv)
        err = np.abs(gv - rv)
        if (err > tol).any():
            raise AssertionError(
                f"{name}: query {q} scores {gv} vs reference {rv}")
        worst = max(worst, float((err / np.maximum(tol, 1e-30)).max(
            initial=0.0)))
        g = gap * (np.abs(rv) if rtol else 1.0)
        sep = np.abs(np.diff(rv)) >= (g[1:] if rtol else g)
        clear = (np.r_[True, sep] & np.r_[sep, True])
        if (gi[clear] != ri[clear]).any():
            raise AssertionError(
                f"{name}: query {q} ids {gi} vs reference {ri}")
        checked += int(clear.sum())
        tied += int((~clear).sum())
    return (f"{checked} ranks equal, {tied} within the tie gap, "
            f"worst error {worst:.3g} of the tolerance")


# -- data -------------------------------------------------------------------


def zipf_tokens(rng, n: int, vocab: int, mean_len: int = 40):
    """Per-doc lengths ~ Poisson(mean_len) and Zipf(s=1) term ids."""
    lens = np.maximum(rng.poisson(mean_len, n), 5).astype(np.int64)
    p = 1.0 / np.arange(1, vocab + 1)
    cdf = np.cumsum(p / p.sum())
    tok = np.searchsorted(cdf, rng.random(int(lens.sum()))).astype(np.int32)
    return np.minimum(tok, vocab - 1), lens


def doc_texts(tok: np.ndarray, lens: np.ndarray) -> list[str]:
    words = np.array([f"w{i}" for i in range(VOCAB)], dtype=object)
    flat = words[tok]
    ends = np.cumsum(lens)
    # One joined string split at doc boundaries: far fewer Python-level
    # joins than one per doc.
    flat[ends - 1] = np.char.add(flat[ends - 1].astype(str), "\n").astype(
        object)
    return " ".join(flat).replace("\n ", "\n").rstrip("\n").split("\n")


def clustered_vectors(seed: int, n: int, d: int, n_centers: int = 2048,
                      block: int = 1 << 16):
    """Seeded unit-scale vectors around n_centers directions (float32)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    out = np.empty((n, d), np.float32)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        c = centers[rng.integers(0, n_centers, hi - lo)]
        out[lo:hi] = c + rng.standard_normal((hi - lo, d), np.float32)
    return out


def query_texts(rng, n_q: int, vocab: int):
    """2-4 distinct terms each, uniform over vocabulary ranks >= 100
    (the head of a Zipf vocabulary is stopwords queries rarely carry)."""
    terms = []
    for _ in range(n_q):
        m = int(rng.integers(2, 5))
        terms.append(list(dict.fromkeys(
            int(t) for t in rng.integers(100, vocab, m))))
    return [" ".join(f"w{t}" for t in ts) for ts in terms], terms


# -- run --------------------------------------------------------------------


def card() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or f"nvidia-smi: {r.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def build_native() -> str:
    """Build the native tokenizer from its committed source."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tpurag", "native", "build.sh")
    try:
        r = subprocess.run(["sh", script], capture_output=True, text=True,
                           timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not built ({e})"
    if r.returncode:
        return f"not built ({r.stderr.strip()[-200:]})"
    return "built"


class Phases:
    def __init__(self):
        self.t0 = None

    def start(self):
        self.t0 = time.perf_counter()

    def done(self, name: str, result: str, tol: str):
        dt = time.perf_counter() - self.t0
        print(f"phase {name}: {dt:.2f}s ok: {result} (tolerance: {tol})",
              flush=True)


def smoke_preset():
    """The document preset with the cosine floor off: random corpus
    vectors score far below 0.3, and the check needs every dense hit."""
    from tpurag.core.config import PRESETS

    return dataclasses.replace(PRESETS["document"], min_vector_score=-1.0)


def make_kb(name, chunks, vecs, quant=False, mesh=None):
    from tpurag import KnowledgeBase

    kb = KnowledgeBase(name, dim=DIM, quant=quant, mesh=mesh)
    step = 1 << 18
    for lo in range(0, len(chunks), step):
        kb.add_chunks(chunks[lo:lo + step], vectors=vecs[lo:lo + step])
    return kb


def hits(responses):
    """search_batch responses -> (scores, ids) ragged lists."""
    return ([[r.score for r in resp.results] for resp in responses],
            [[r.chunk_id for r in resp.results] for resp in responses])


def phase_a(ph, kb, data):
    preset = smoke_preset()
    qs, qterms, qv = data["queries"], data["qterms"], data["qv"]
    ph.start()
    vec = kb.search_batch(qs, top_k=K, mode="vector", preset=preset)
    key = kb.search_batch(qs, top_k=K, mode="keyword", preset=preset)
    hyb = kb.search_batch(qs, top_k=K, mode="hybrid", preset=preset)
    dev_s = time.perf_counter() - ph.t0
    rv, ri = data["ref_dense10"]
    msg = check_topk("A/vector", *hits(vec), rv[:, :K], ri[:, :K], atol=1e-5)
    ph.done("A/vector", f"{len(qs)} queries over {data['n']} chunks; {msg}",
            "score 1e-5 abs; ids equal where the reference gap >= 1e-5")
    ph.start()
    bv, bi = np_bm25_topk(data["post"], qterms, K)
    msg = check_topk("A/keyword", *hits(key), bv, bi, rtol=1e-5)
    ph.done("A/keyword", msg,
            "score rtol 1e-5; ids equal where the reference gap >= 1e-5 rel")
    ph.start()
    # Host RRF over the reference legs, with the keyword-coverage gate.
    post = data["post"]
    mass = np.array([sum(post.idf(t) for t in ts) for ts in qterms])
    gate = bv[:, 0] >= preset.min_keyword_coverage * mass
    k_leg = np.where(gate[:, None], bi, -1)
    fv, fi = np_rrf((ri[:, :K], k_leg),
                    (preset.vector_weight, preset.keyword_weight),
                    preset.rrf_k, preset.both_bonus, preset.final_top_k)
    gv, gi = hits(hyb)
    _, dvi = hits(vec)
    _, dki = hits(key)
    agree = 0
    for q in range(len(qs)):
        legs_ok = (list(dvi[q]) == list(ri[q, :K])
                   and list(dki[q]) == [i for i in bi[q] if i >= 0])
        if not legs_ok:
            continue
        agree += 1
        if list(gi[q]) != list(fi[q]) or not np.allclose(
                gv[q], fv[q], atol=1e-6):
            raise AssertionError(f"A/hybrid: query {q} fused {gi[q]} "
                                 f"{gv[q]} vs reference {fi[q]} {fv[q]}")
    if agree < len(qs) // 2:
        raise AssertionError(f"A/hybrid: legs agree on only {agree} queries")
    ph.done("A/hybrid", f"fused ids equal on all {agree} queries whose legs "
            f"match the reference; device time of the three modes "
            f"{dev_s:.2f}s incl. compile",
            "fused score 1e-6 abs, ids exact")


def ivf_checks(ph, kb, data, label):
    """Phase B body for one KB: build, full probe, tuned recall, modes."""
    import jax

    preset = smoke_preset()
    ph.start()
    ivf = kb.build_ivf(seed=SEED)
    ph.done(f"{label}/build", f"{ivf.n_lists} lists, c_max {ivf.c_max}, "
            f"int8 layout {'yes' if ivf.emb_ivf_q8 is not None else 'no'}",
            "builds")
    ph.start()
    qv = data["qv"]
    rv, ri = data["ref_dense10"]
    v, i = ivf.search(qv, k=10, nprobe=ivf.n_lists)
    v, i = np.asarray(v), np.asarray(i)
    if ivf.emb_ivf_q8 is None:
        # The IVF build re-normalizes the stored rows before packing;
        # exact search over the packed rows is the reference.
        n = data["n"]
        packed = stored_rows(ivf.emb_ivf, n, np.asarray(ivf.row_ids[:n]))
        moved = int((packed != data["corpus"]).sum())
        pv, pi = np_dense_topk(device_queries(qv), packed, n, 10)
        msg = (check_topk(f"{label}/full-probe", v, i, pv, pi, atol=1e-5)
               + f"; packed rows differ from the dense rows in {moved} "
               f"of {n * DIM} elements")
        tol = "equals exact: score 1e-5 abs, ids where gap >= 1e-5"
    else:
        rec = np.mean([len(set(i[q]) & set(ri[q])) / 10
                       for q in range(len(ri))])
        if rec < 0.95:
            raise AssertionError(f"{label}/full-probe recall {rec:.4f}")
        msg = f"int8 scan + exact rescore, recall@10 {rec:.4f}"
        tol = "recall@10 >= 0.95"
    ph.done(f"{label}/full-probe", msg, tol)
    ph.start()
    dq, (dv, di) = data["doc_queries"], data["ref_doc10"]
    nprobe = ivf.tune_nprobe(dq, di, k=10, target_recall=0.95)
    _, gi = ivf.search(dq, k=10, nprobe=nprobe)
    gi = np.asarray(gi)
    rec = np.mean([len(set(gi[q]) & set(di[q])) / 10 for q in range(len(di))])
    if rec < 0.95:
        raise AssertionError(f"{label}/tuned: recall {rec:.4f} at {nprobe}")
    ph.done(f"{label}/tuned", f"nprobe {nprobe} of {ivf.n_lists}: "
            f"recall@10 {rec:.4f} on {len(dq)} document-like queries",
            "recall@10 >= 0.95")
    ph.start()
    qs = data["queries"]
    ivf_r = kb.search_batch(qs, top_k=K, mode="ivf", preset=preset)
    hyb_r = kb.search_batch(qs, top_k=K, mode="hybrid_ivf", preset=preset)
    key_r = kb.search_batch(qs, top_k=K, mode="keyword", preset=preset)
    _, iv_i = hits(ivf_r)
    _, kw_i = hits(key_r)
    post = data["post"]
    mass = np.array([sum(post.idf(t) for t in ts) for ts in data["qterms"]])
    kw_s = [[r.score for r in resp.results] for resp in key_r]
    legs_k = [ids if (s and s[0] >= preset.min_keyword_coverage * m) else []
              for ids, s, m in zip(kw_i, kw_s, mass)]
    pad = lambda rows: [list(r) + [-1] * (K - len(r)) for r in rows]  # noqa
    fv, fi = np_rrf((pad(iv_i), pad(legs_k)),
                    (preset.vector_weight, preset.keyword_weight),
                    preset.rrf_k, preset.both_bonus, preset.final_top_k)
    gv, gi = hits(hyb_r)
    for q in range(len(qs)):
        if list(gi[q]) != list(fi[q]):
            raise AssertionError(f"{label}/hybrid_ivf: query {q} {gi[q]} "
                                 f"vs RRF of its legs {fi[q]}")
    rec8 = np.mean([len(set(iv_i[q]) & set(ri[q, :K])) / K
                    for q in range(len(qs))])
    stats = jax.devices()[0].memory_stats() or {}
    ph.done(f"{label}/modes", f"ivf + hybrid_ivf for {len(qs)} queries; "
            f"fused = host RRF of the device legs; ivf recall@8 at the "
            f"default nprobe {rec8:.3f}; peak_bytes_in_use "
            f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB",
            "fused ids exact")
    return ivf


def quant_working_set(ph, ivf, qv):
    """The int8 search's compiled working set against an f32 copy."""
    import jax

    from tpurag.index.ivf import _ivf_search

    ph.start()
    dev = jax.devices()[0]
    before = (dev.memory_stats() or {}).get("bytes_in_use", 0)
    comp = _ivf_search.lower(
        qv, ivf.centroids, ivf.emb_ivf_q8, ivf.row_table, ivf.row_ids,
        k=10, nprobe=64, c_max=ivf.c_max, cluster_scales=ivf.cluster_scales,
        rescore_emb=ivf.emb_ivf).compile()
    temp = comp.memory_analysis().temp_size_in_bytes
    jax.block_until_ready(comp(qv, ivf.centroids, ivf.emb_ivf_q8,
                               ivf.row_table, ivf.row_ids,
                               cluster_scales=ivf.cluster_scales,
                               rescore_emb=ivf.emb_ivf))
    stats = dev.memory_stats() or {}
    f32_copy = ivf.emb_ivf_q8.size * 4
    if temp >= f32_copy / 4:
        raise AssertionError(f"B-quant/memory: temp {temp} vs f32 copy "
                             f"{f32_copy}")
    ph.done("B-quant/memory",
            f"int8 layout {ivf.emb_ivf_q8.nbytes / 2**30:.2f} GiB; compiled "
            f"search temp {temp / 2**30:.3f} GiB for {qv.shape[0]} queries "
            f"x 64 probes; an f32 copy would be {f32_copy / 2**30:.2f} GiB; "
            f"bytes_in_use {before / 2**30:.2f} GiB before, "
            f"peak_bytes_in_use {stats.get('peak_bytes_in_use', 0) / 2**30:.2f}"
            " GiB", "temp < 1/4 of an f32 copy")


def phase_c(ph, kb, data):
    import urllib.request

    from tpurag.api.server import RagServer

    ph.start()
    srv = RagServer(kb)
    httpd = srv.serve(host="127.0.0.1", port=0, background=True)
    port = httpd.server_address[1]
    try:
        n = 0
        for mode in ("hybrid", "keyword"):
            for q in data["queries"][:4]:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/search",
                    data=json.dumps({"query": q, "top_k": K,
                                     "mode": mode}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    got = json.loads(r.read())["results"]
                want = kb.search(q, top_k=K, mode=mode).results
                if ([h["chunk_id"] for h in got] != [w.chunk_id for w in want]
                        or not np.allclose([h["score"] for h in got],
                                           [w.score for w in want],
                                           rtol=1e-6)):
                    raise AssertionError(f"C: {mode} {q!r}: served {got} "
                                         f"vs kb.search {want}")
                n += 1
    finally:
        srv.shutdown()
    ph.done("C/served", f"{n} POST /search answers equal kb.search "
            f"(port {port})", "ids exact, score rtol 1e-6")


def phase_d(ph, data, rehearse: bool):
    import jax
    import jax.numpy as jnp

    from tpurag.models.encoder import (EncoderConfig, EncoderEmbedder,
                                       encode_tokens)

    ph.start()
    # A rehearsal on the CPU cuts depth to one layer; widths stay.
    cfg = EncoderConfig.base(**({"n_layers": 1} if rehearse else {}))
    emb = EncoderEmbedder(cfg, seed=SEED, seq_len=cfg.max_len)
    texts = [" ".join(data["texts"][i:i + 12]) for i in range(0, 64 * 12, 12)]
    got = np.asarray(emb(texts))
    ids, mask = emb._tokens(texts)
    p32 = jax.tree.map(lambda x: x.astype(jnp.float32), emb.params)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(encode_tokens(p32, ids, mask, n_heads=cfg.n_heads,
                                       ln_eps=cfg.ln_eps))
    cos = np.sum(got * ref, axis=1) / (np.linalg.norm(got, axis=1)
                                       * np.linalg.norm(ref, axis=1))
    if not (np.isfinite(got).all() and got.shape == (64, cfg.out_dim)
            and cos.min() >= 0.99):
        raise AssertionError(f"D: shape {got.shape}, min cosine {cos.min()}")
    ph.done("D/encoder", f"BERT-base {cfg.n_layers}L/{cfg.dim}, seq "
            f"{cfg.max_len}, bf16: 64 chunks, min per-row cosine vs the "
            f"float32 forward {cos.min():.5f}", "cosine >= 0.99")


def median_ms(fn, *args, reps=20):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def phase_e(ph, corpus_dev, data, rehearse: bool):
    import jax
    import jax.numpy as jnp

    from tpurag.index.dense import l2_normalize
    from tpurag.kernels.dense import dense_topk_triton, dense_topk_xla

    n_all = data["n"]
    cases = [(768, min(100_352, n_all)), (512, n_all)]
    for b, n in cases:
        ph.start()
        q = l2_normalize(jnp.asarray(data["qv_e"][:b]))
        emb = corpus_dev[:n] if n < corpus_dev.shape[0] else corpus_dev
        nv = jnp.int32(n)
        kern = jax.jit(lambda q, e, nv: dense_topk_triton(
            q, e, nv, K, interpret=rehearse))
        comp = kern.lower(q, emb, nv).compile()
        mem = comp.memory_analysis()
        v, i = comp(q, emb, nv)
        if b == len(data["queries"]) and n == n_all:
            rv, ri = data["ref_dense10"]
        else:
            rv, ri = np_dense_topk(device_queries(data["qv_e"][:b]),
                                   data["corpus"], n, 10)
        msg = check_topk(f"E/{b}x{n}", np.asarray(v), np.asarray(i),
                         rv[:, :K], ri[:, :K], atol=1e-5)
        t_kern = median_ms(comp, q, emb, nv)
        xla = jax.jit(lambda q, e, nv: dense_topk_xla(q, e, nv, K))
        t_xla = median_ms(xla, q, emb, nv)
        ph.done(f"E/triton b={b} n={n}",
                f"{msg}; kernel {t_kern:.3f} ms vs dense_topk_xla "
                f"{t_xla:.3f} ms (median of 20); memory_analysis: "
                f"temp {mem.temp_size_in_bytes} B, output "
                f"{mem.output_size_in_bytes} B",
                "score 1e-5 abs; ids equal where the reference gap >= 1e-5")


@contextlib.contextmanager
def dense_leg_on(route: str):
    """Run the dense leg on `route`: 'triton' as the router picks, or
    'xla' forced (the comparison the kernel has to win end to end)."""
    import tpurag.kernels.dense as dense_mod

    orig = dense_mod.dense_route
    if route == "xla":
        dense_mod.dense_route = lambda *a: "xla"
    try:
        yield
    finally:
        dense_mod.dense_route = orig


def phase_e2e(ph, kb, data, reps: int = 5):
    """search_batch wall time per mode, dense leg on the kernel vs XLA,
    interleaved so both see the same host load."""
    from tpurag.kernels.dense import dense_route
    from tpurag.kernels.runtime import platform

    preset = smoke_preset()
    qs = data["queries"]
    kernel = dense_route(platform(), kb.dense.dtype, preset.vector_top_k)
    for mode in ("vector", "hybrid"):
        ph.start()
        ts = {"triton": [], "xla": []}
        ids = {}
        for rep in range(reps + 1):
            for route in ("triton", "xla"):
                with dense_leg_on(route):
                    t0 = time.perf_counter()
                    r = kb.search_batch(qs, top_k=K, mode=mode, preset=preset)
                    dt = time.perf_counter() - t0
                if rep:                       # rep 0 compiles
                    ts[route].append(dt)
                ids[route] = [[h.chunk_id for h in x.results] for x in r]
        same = sum(a == b for a, b in zip(ids["triton"], ids["xla"]))
        med = {r: 1e3 * float(np.median(v)) for r, v in ts.items()}
        ph.done(f"A/e2e {mode}",
                f"search_batch of {len(qs)} queries: dense leg on "
                f"{kernel} {med['triton']:.1f} ms, on dense_topk_xla "
                f"{med['xla']:.1f} ms (median of {reps}); same ids on "
                f"{same}/{len(qs)} queries", "timing only")


def generate(n: int, rng):
    """All seeded host data of phase A: texts, vectors, postings, queries."""
    from tpurag.core.types import Chunk
    from tpurag.ingest.embedder import HashEmbedder

    tok, lens = zipf_tokens(rng, n, VOCAB)
    texts = doc_texts(tok, lens)
    chunks = [Chunk(text=t, doc_id=f"d{i >> 8}") for i, t in enumerate(texts)]
    vecs = clustered_vectors(SEED + 1, n, DIM)
    queries, qterms = query_texts(rng, N_QUERIES, VOCAB)
    extra, _ = query_texts(rng, 768 - N_QUERIES, VOCAB)
    hasher = HashEmbedder(DIM)
    qv = hasher(queries)
    doc_rows = rng.choice(n, 64, replace=False)
    dq = normalize_f32(vecs[doc_rows]) + rng.standard_normal(
        (64, DIM)).astype(np.float32) * np.float32(0.5 / np.sqrt(DIM))
    return {
        "n": n, "texts": texts, "chunks": chunks, "vecs": vecs,
        "queries": queries, "qterms": qterms, "qv": qv,
        "qv_e": np.concatenate([qv, hasher(extra)]),
        "post": Postings.build(tok, lens, VOCAB), "doc_queries": dq,
    }


def device_queries(q) -> np.ndarray:
    """Queries as the dense scan sees them: normalized on the device in
    float32 (the index's own step), then rounded to bfloat16."""
    import jax.numpy as jnp

    from tpurag.index.dense import l2_normalize

    return np.asarray(l2_normalize(jnp.asarray(q)).astype(jnp.bfloat16),
                      np.float32)


def stored_rows(mat, n: int, row_ids=None, block: int = 1 << 16):
    """Rows [0, n) of a device matrix as host bfloat16; with row_ids
    (a packed IVF layout) put each packed row back at its original id."""
    import ml_dtypes

    out = np.empty((n, mat.shape[1]), ml_dtypes.bfloat16)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        rows = np.asarray(mat[lo:hi]).astype(ml_dtypes.bfloat16)
        if row_ids is None:
            out[lo:hi] = rows
        else:
            out[row_ids[lo:hi]] = rows
    return out


def references(ph, kb, data):
    """Phase-A references over the rows the KB stores. The corpus was
    normalized on the device in float32; NumPy's own float32 normalize
    rounds a few elements to the neighbouring bfloat16 value (another
    reduction order), so the scan is checked against the stored bytes
    and the normalization by that count."""
    ph.start()
    n = data["n"]
    corpus = stored_rows(kb.dense.embeddings, n)
    flips = 0
    for lo in range(0, n, 1 << 16):
        mine = bf16_round(normalize_f32(data["vecs"][lo:lo + (1 << 16)]))
        flips += int((mine != corpus[lo:lo + (1 << 16)].astype(
            np.float32)).sum())
    if flips > 1e-4 * n * DIM:
        raise AssertionError(f"ref: {flips} stored elements differ from "
                             "NumPy's normalize + bf16 rounding")
    data["corpus"] = corpus
    data["ref_dense10"] = np_dense_topk(device_queries(data["qv"]), corpus,
                                        n, 10)
    data["ref_doc10"] = np_dense_topk(device_queries(data["doc_queries"]),
                                      corpus, n, 10)
    ph.done("ref", f"stored corpus equals NumPy normalize + bf16 except "
            f"{flips} of {n * DIM} elements; float64 top-10 references",
            "<= 1e-4 of elements one bf16 step apart")


def four_cards(ph, data):
    """Sharded KB over a 4-card 'data' mesh against a one-card KB."""
    import jax

    from tpurag.shard.mesh import make_mesh

    preset = smoke_preset()
    mesh = make_mesh([("data", 4)], devices=jax.devices()[:4])
    ph.start()
    one = make_kb("one", data["chunks"], data["vecs"])
    sh = make_kb("sharded", data["chunks"], data["vecs"], mesh=mesh)
    references(ph, one, data)
    ph.start()
    per = [(d.memory_stats() or {}).get("bytes_in_use", 0)
           for d in jax.devices()[:4]]
    shards = [s.data.nbytes for s in sh.dense.embeddings.addressable_shards]
    ph.done("4/build", f"dense corpus bytes per card {shards}; "
            f"bytes_in_use per card {[round(b / 2**30, 2) for b in per]} GiB",
            "each card holds a quarter of the corpus")
    if len(set(shards)) != 1 or shards[0] * 4 != sh.dense.embeddings.nbytes:
        raise AssertionError(f"4/build: uneven corpus shards {shards}")
    qs = data["queries"]
    got = {}
    for mode in ("vector", "keyword", "hybrid"):
        ph.start()
        a = hits(one.search_batch(qs, top_k=K, mode=mode, preset=preset))
        b = hits(sh.search_batch(qs, top_k=K, mode=mode, preset=preset))
        got[mode] = a, b
        if mode == "hybrid":
            # Tied keyword or vector hits may order differently across
            # shards, and RRF turns a tie into a rank: fused lists must
            # agree wherever both legs agree.
            same_legs = [q for q in range(len(qs))
                         if all(got[m][0][1][q] == got[m][1][1][q]
                                for m in ("vector", "keyword"))]
            for q in same_legs:
                if (a[1][q] != b[1][q]
                        or not np.allclose(a[0][q], b[0][q], atol=1e-6)):
                    raise AssertionError(f"4/hybrid: query {q} sharded "
                                         f"{b[1][q]} vs one-card {a[1][q]}")
            if len(same_legs) < len(qs) // 2:
                raise AssertionError(f"4/hybrid: legs agree on only "
                                     f"{len(same_legs)} queries")
            ph.done("4/hybrid", f"sharded fused ids equal one-card on all "
                    f"{len(same_legs)} of {len(qs)} queries whose legs "
                    "match", "fused score 1e-6 abs, ids exact")
            continue
        rtol = 1e-5 if mode == "keyword" else 0.0
        atol = 1e-5 if mode == "vector" else 0.0
        msg = check_topk(f"4/{mode}", b[0], b[1],
                         [np.asarray(x) for x in a[0]],
                         [np.asarray(x) for x in a[1]], atol=atol, rtol=rtol)
        ph.done(f"4/{mode}", f"sharded vs one-card, {len(qs)} queries; {msg}",
                "one-card scores; ids equal up to ties")
    ph.start()
    ivf_one = one.build_ivf(seed=SEED)
    ivf_sh = sh.build_ivf(seed=SEED)
    qv = data["qv"]
    rv, ri = data["ref_dense10"]
    _, i1 = ivf_one.search(qv, k=10, nprobe=ivf_one.n_lists)
    v4, i4 = ivf_sh.search(qv, k=10, nprobe=ivf_sh.n_lists)
    msg = check_topk("4/ivf", np.asarray(v4), np.asarray(i4), rv, ri,
                     atol=1e-5)
    if not all(set(a) == set(b) for a, b in zip(np.asarray(i1),
                                                np.asarray(i4))):
        raise AssertionError("4/ivf: sharded full probe differs from one-card")
    ph.done("4/ivf", f"full probe, sharded == one-card == exact; {msg}",
            "score 1e-5 abs; ids equal up to ties")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="chunks in the phase-A corpus")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    ap.add_argument("--rehearse", action="store_true",
                    help="run on any backend at --n; prints no result")
    args = ap.parse_args(argv)

    import jax

    platform = jax.default_backend()
    if platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: needs a GPU, jax.default_backend() is "
              f"{platform!r}; nothing run", file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(jax.devices()) < need:
        print(f"chip_smoke: needs {need} devices, found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2

    from tpurag.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    native = build_native()
    dev = jax.devices()[0]
    print(f"env: jax {jax.__version__}; device {dev.platform} "
          f"{dev.device_kind} x{len(jax.devices())}; card {card()}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache "
          f"{cache}; native tokenizer {native}", flush=True)

    ph = Phases()
    ph.start()
    data = generate(args.n, np.random.default_rng(SEED))
    ph.done("data", f"{args.n} chunks, {len(data['post'].doc)} postings, "
            "host data built", "-")

    if args.four_cards:
        four_cards(ph, data)
    else:
        ph.start()
        kb = make_kb("smoke", data["chunks"], data["vecs"])
        ph.done("A/ingest", f"{len(kb)} chunks through add_chunks", "-")
        references(ph, kb, data)
        phase_a(ph, kb, data)
        phase_e2e(ph, kb, data)
        ivf_checks(ph, kb, data, "B")
        phase_c(ph, kb, data)
        del kb
        gc.collect()
        ph.start()
        kbq = make_kb("smoke-q8", data["chunks"], data["vecs"], quant=True)
        ph.done("B-quant/ingest", f"{len(kbq)} chunks, quant=True", "-")
        ivf = ivf_checks(ph, kbq, data, "B-quant")
        quant_working_set(ph, ivf, jax.numpy.asarray(data["qv"][:64]))
        corpus_dev = kbq.dense.embeddings
        del ivf
        phase_d(ph, data, args.rehearse)
        phase_e(ph, corpus_dev, data, args.rehearse)

    print(f"card: {card()}", flush=True)
    if args.rehearse:
        print(f"rehearsal on {platform}: no result", file=sys.stderr)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
