"""Performance benchmark suite: one function per benchmark configuration.

Each config returns {"metric", "value", "unit", ...} dicts; `bench.py`
at the repo root runs config 2 (the headline) on its own. On a GPU the
configs run their full shapes with a bf16 corpus; on any other backend
they scale down to fp32 toy shapes so the suite smoke-runs on the CPU.

Timing method: ITERS iterations chained inside one jit via lax.fori_loop
with per-iteration input rotation, so per-dispatch host overhead
amortizes away."""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np


def _full() -> bool:
    """Full shapes and a bf16 corpus: only on the GPU."""
    from tpurag.kernels.runtime import platform

    return platform() == "gpu"


def _chain_time(step_fn, iters: int = 10, reps: int = 4) -> float:
    """Per-iteration seconds of `step_fn(i) -> scalar` chained in one jit."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(x0):
        def body(i, acc):
            return acc + step_fn(i)
        return jax.lax.fori_loop(0, iters, body, x0)

    float(loop(jnp.float32(0.0)))  # compile + host read (forces completion)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(loop(jnp.float32(0.0)))
        ts.append(time.perf_counter() - t0)
    return min(ts) / iters


def _random_corpus(rng, n, d):
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb


def config1_exact_dense(seed: int = 0) -> dict:
    """Single KB ~1k chunks, fp32 cosine top-3, exactness vs numpy."""
    import jax.numpy as jnp

    from tpurag.kernels.dense import dense_topk_xla

    rng = np.random.default_rng(seed)
    n, d, b, k = 1024, 1024, 64, 3
    emb = _random_corpus(rng, n, d)
    q = _random_corpus(rng, b, d)
    vals, ids = dense_topk_xla(jnp.asarray(q), jnp.asarray(emb),
                               jnp.int32(n), k)
    ref_ids = np.argsort(-(q @ emb.T), axis=1, kind="stable")[:, :k]
    recall = float(np.mean([
        len(set(np.asarray(ids)[i]) & set(ref_ids[i])) / k for i in range(b)]))
    emb_dev = jnp.asarray(emb)
    q_dev = jnp.asarray(q)

    def step(i):
        v, _ = dense_topk_xla(q_dev * (1 + i.astype(jnp.float32) * 1e-7),
                              emb_dev, np.int32(n), k)
        return v.sum()

    sec = _chain_time(step)
    return {"metric": "exact_dense_recall", "value": recall, "unit": "recall@3",
            "qps": b / sec, "p50_ms": sec * 1e3}


def config2_hybrid(seed: int = 0, n: Optional[int] = None) -> dict:
    """Hybrid top-8 dense+BM25+RRF. The headline config (see /bench.py)."""
    import jax.numpy as jnp

    from tpurag.kernels.bm25 import bm25_topk_segsum
    from tpurag.kernels.dense import dense_topk
    from tpurag.kernels.fusion import rrf_fuse

    full = _full()
    rng = np.random.default_rng(seed)
    n = n or (100_000 if full else 8_192)
    d = 1024 if full else 256
    b = 512 if full else 32
    vocab = 50_000 if full else 2_000
    p_max, tq, k = (2048 if full else 128), 8, 8

    emb_dev = jnp.asarray(_random_corpus(rng, n, d),
                          jnp.bfloat16 if full else jnp.float32)
    q_dev = jnp.asarray(_random_corpus(rng, b, d))
    df = np.clip((p_max * (1 + np.arange(vocab)) ** -0.5), 16, p_max).astype(np.int64)
    sh = np.zeros(vocab + 1, np.int64)
    np.cumsum(df, out=sh[1:])
    nnz = int(sh[-1])
    pd = jnp.asarray(np.sort(rng.integers(0, n, (nnz + p_max,)).astype(np.int32)))
    pi = jnp.asarray(rng.uniform(0.3, 2.2, (nnz + p_max,)).astype(np.float32))
    tid = rng.integers(0, vocab, (b, tq))
    qs = jnp.asarray(sh[tid].astype(np.int32))
    ql = jnp.asarray(df[tid].astype(np.int32))
    qi = jnp.asarray(rng.uniform(0.5, 3.0, (b, tq)).astype(np.float32))
    nv = np.int32(n)  # host scalar: a jnp scalar const stalls lower()

    def step(i):
        qq = q_dev * (1.0 + i.astype(jnp.float32) * 1e-7)
        v_s, v_i = dense_topk(qq, emb_dev, nv, k)
        k_s, k_i = bm25_topk_segsum(
            jnp.roll(qs, i, axis=0), jnp.roll(ql, i, axis=0),
            jnp.roll(qi, i, axis=0), pd, pi, nv, k=k, p_max=p_max)
        s, ids, bits = rrf_fuse((v_i, k_i), weights=(1.0, 1.0), final_k=k)
        return s.sum()

    sec = _chain_time(step, iters=10 if full else 3)
    return {"metric": "hybrid_qps_per_chip", "value": b / sec, "unit": "QPS",
            "p50_ms": sec * 1e3, "n": n, "batch": b}


def config3_memory_fusion(seed: int = 0) -> dict:
    """Unified memory+RAG: 3-source RRF with freshness-decay weighting."""
    import jax.numpy as jnp

    from tpurag.kernels.fusion import rrf_fuse
    from tpurag.memory.freshness import combined_memory_scores, freshness_scores

    rng = np.random.default_rng(seed)
    b, k = 256, 8
    now = 1.7e9
    mem_ids = jnp.asarray(rng.integers(0, 1000, (b, 8)).astype(np.int32))
    rag_ids = jnp.asarray(rng.integers(0, 1000, (b, 8)).astype(np.int32))
    hist_ids = jnp.asarray(rng.integers(0, 1000, (b, 4)).astype(np.int32))
    conf = rng.uniform(0.5, 1.0, 64).astype(np.float32)
    last = now - rng.uniform(0, 100, 64) * 3600
    cnt = rng.integers(0, 20, 64)
    fresh = freshness_scores(conf, last, cnt, now)
    _ = combined_memory_scores(np.full(64, 0.8, np.float32), fresh)

    def step(i):
        s, ids, bits = rrf_fuse(
            (jnp.roll(mem_ids, i, axis=0), jnp.roll(rag_ids, i, axis=0),
             jnp.roll(hist_ids, i, axis=0)),
            weights=(1.2, 1.0, 0.6), final_k=k)  # merger.ts:18-23 weights
        return s.sum()

    sec = _chain_time(step)
    return {"metric": "memory_fusion_qps", "value": b / sec, "unit": "QPS",
            "p50_ms": sec * 1e3}


def config4_graph(seed: int = 0) -> dict:
    """Entity kNN + 1-hop expansion at scale (1M entities on the GPU)."""
    import jax.numpy as jnp

    from tpurag.kernels.dense import dense_topk
    from tpurag.kernels.graphops import expand_neighbors

    full = _full()
    rng = np.random.default_rng(seed)
    n_ent = 1_000_000 if full else 10_000
    d = 1024 if full else 128
    b, k, max_nbr = 256 if full else 16, 16, 32
    emb = jnp.asarray(_random_corpus(rng, n_ent, d),
                      jnp.bfloat16 if full else jnp.float32)
    q = jnp.asarray(_random_corpus(rng, b, d))
    deg = rng.integers(1, max_nbr, n_ent)
    off = np.zeros(n_ent + 1, np.int64)
    np.cumsum(deg, out=off[1:])
    flat = jnp.asarray(rng.integers(0, n_ent, int(off[-1])).astype(np.int32))
    offs = jnp.asarray(off.astype(np.int32))
    nv = np.int32(n_ent)  # host scalar: a jnp scalar const stalls lower()

    def step(i):
        qq = q * (1.0 + i.astype(jnp.float32) * 1e-7)
        _, ids = dense_topk(qq, emb, nv, k)
        nbrs = expand_neighbors(ids, offs, flat, max_nbr)
        return jnp.sum(nbrs >= 0).astype(jnp.float32)

    sec = _chain_time(step, iters=5)
    return {"metric": "graph_search_qps", "value": b / sec, "unit": "QPS",
            "n_entities": n_ent, "p50_ms": sec * 1e3}


def config5_sharded(seed: int = 0) -> dict:
    """Config 5: IVF-sharded corpus over every device, recall@10 gated
    >= 0.95 against the exact sharded oracle by the nprobe autotuner,
    then QPS at the tuned budget.

    10M chunks on four or more GPUs; small shapes elsewhere (the
    1M x 1024 virtual-mesh gate lives in
    tests/test_shard_ivf.py::test_sharded_ivf_recall_gate_1m). On one
    device it reports `skipped`."""
    import jax
    import jax.numpy as jnp

    from tpurag.core.config import IVFConfig
    from tpurag.shard.ivf import ShardedIVFIndex
    from tpurag.shard.mesh import make_mesh
    from tpurag.shard.search import shard_corpus, sharded_dense_topk

    full = _full()
    rng = np.random.default_rng(seed)
    devices = jax.devices()
    n_dev = len(devices)
    if n_dev < 2:
        return {"metric": "sharded_ivf_qps", "value": None, "unit": "QPS",
                "skipped": f"needs >= 2 devices, found {n_dev}"}
    big = full and n_dev >= 4
    n = 10_000_000 if big else 16_384 * n_dev
    d = 1024 if full else 128
    b, k = 64, 10
    n_centers = 1024 if big else 64
    mesh = make_mesh([("data", n_dev)], devices=devices)

    # Clustered corpus (IVF's operating regime; uniform-random vectors
    # have no cluster structure for ANY ANN method to exploit). Noise is
    # RELATIVE (unit-normalized then scaled) so cluster tightness is
    # dimension-independent.
    centers = _random_corpus(rng, n_centers, d)
    which = rng.integers(0, n_centers, n)
    emb = centers[which] + 0.3 * _random_corpus(rng, n, d)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = (emb[rng.choice(n, b, replace=False)]
         + 0.1 * _random_corpus(rng, b, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    cfg = IVFConfig(n_lists=4096 if big else 256,
                    kmeans_iters=6, sample_size=262_144 if big else 32_768)
    dtype = jnp.bfloat16 if full else jnp.float32
    idx = ShardedIVFIndex(cfg, mesh=mesh).build(emb, dtype=dtype, seed=seed)

    # Exact sharded oracle for the recall gate.
    emb_sharded = shard_corpus(jnp.asarray(emb, dtype), mesh)
    _, exact_ids = sharded_dense_topk(
        jnp.asarray(q, dtype), emb_sharded, jnp.int32(n), k, mesh=mesh)
    nprobe = idx.tune_nprobe(q, np.asarray(exact_ids), k=k,
                             target_recall=0.95)
    _, ids = idx.search(q, k=k, nprobe=nprobe)
    got = np.asarray(ids)
    exact = np.asarray(exact_ids)
    recall = float(np.mean([
        len(set(got[i]) & set(exact[i])) / k for i in range(b)]))

    q_dev = jnp.asarray(q)

    def run_once():
        s, _ = idx.search(q_dev, k=k, nprobe=nprobe)
        return float(np.asarray(s).sum())

    run_once()
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_once()
        ts.append(time.perf_counter() - t0)
    sec = min(ts)
    return {"metric": "sharded_ivf_qps", "value": b / sec, "unit": "QPS",
            "n": n, "devices": n_dev, "p50_ms": sec * 1e3,
            "recall_at_10": recall, "nprobe": nprobe,
            "n_lists": idx.n_lists}


def config6_ingest(seed: int = 0, shape: str = "small") -> dict:
    """Ingest throughput: chunk -> tokenize -> on-chip encode -> index
    (chunks/sec), double-buffered host feed (ingest/pipeline.py).
    The 'one on-device pipeline' north star, measured.

    shape="base" swaps in the production BERT-base encoder
    (EncoderConfig.base(): 12L/768/512-token, ~110M params) so the
    recorded chunks/s reflects a real embedding model, not the 4L toy."""
    from tpurag.api.knowledge_base import KnowledgeBase
    from tpurag.ingest.pipeline import ingest_documents
    from tpurag.models.encoder import EncoderConfig, EncoderEmbedder

    full = _full()
    rng = np.random.default_rng(seed)
    if full and shape == "base":
        cfg = EncoderConfig.base(max_len=512)
        n_docs, words = 48, 3000
    elif full:
        cfg = EncoderConfig(dim=512, n_layers=4, n_heads=8, out_dim=1024,
                            max_len=128, dtype="bfloat16")
        n_docs, words = 64, 3000
    elif shape == "base":
        # CPU smoke of the base-shape path: same layer count, tiny width.
        cfg = EncoderConfig.base(dim=128, n_heads=4, max_len=32,
                                 out_dim=128, dtype="float32")
        n_docs, words = 4, 200
    else:
        cfg = EncoderConfig(dim=128, n_layers=2, n_heads=4, out_dim=128,
                            max_len=64, dtype="float32")
        n_docs, words = 8, 800
    emb = EncoderEmbedder(cfg, seq_len=cfg.max_len)
    vocab = [f"word{i}" for i in range(2000)]

    def doc(i):
        return (f"doc{i}", " ".join(
            vocab[j] for j in rng.integers(0, len(vocab), words)))

    # Warm-up: run the identical doc stream once so every pow2 batch
    # bucket (full batches + the remainder) is compiled before timing.
    kb0 = KnowledgeBase("warm", embedder=emb, dim=emb.dim)
    ingest_documents(kb0, (doc(i) for i in range(n_docs)), batch_size=256)

    kb = KnowledgeBase("ingest-bench", embedder=emb, dim=emb.dim)
    stats = ingest_documents(kb, (doc(i) for i in range(n_docs)),
                             batch_size=256)
    return {"metric": "ingest_chunks_per_sec",
            "value": stats["chunks_per_sec"], "unit": "chunks/s",
            "chunks": stats["chunks"], "seconds": stats["seconds"],
            "encoder": dataclasses_summary(cfg)}


def dataclasses_summary(cfg) -> str:
    return (f"dim{cfg.dim} L{cfg.n_layers} out{cfg.out_dim} "
            f"seq{cfg.max_len} {cfg.dtype}")


def config7_ivf_latency(seed: int = 0) -> dict:
    """Small-batch latency: IVF vs exact scan on one device (IVF's
    operating regime per index/ivf.py — exact amortizes over big
    batches; IVF wins when gathers replace a full scan for few queries).
    2M x 1024 bf16 (4 GB) on the GPU; small shapes elsewhere."""
    import jax
    import jax.numpy as jnp

    from tpurag.core.config import IVFConfig
    from tpurag.index.ivf import IVFIndex, ivf_scan
    from tpurag.kernels.dense import dense_topk

    full = _full()
    rng = np.random.default_rng(seed)
    if full:
        n, d, b, k = 2_000_000, 1024, 8, 10
        cfg = IVFConfig(n_lists=2048, kmeans_iters=6, sample_size=262_144)
        n_centers = 2048
    else:
        n, d, b, k = 65_536, 128, 8, 10
        cfg = IVFConfig(n_lists=256, kmeans_iters=4, sample_size=16_384)
        n_centers = 128

    centers = _random_corpus(rng, n_centers, d)
    which = rng.integers(0, n_centers, n)
    emb = centers[which] + 0.3 * _random_corpus(rng, n, d)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = (emb[rng.choice(n, b, replace=False)]
         + 0.1 * _random_corpus(rng, b, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_dev = jnp.asarray(q)

    dtype = jnp.bfloat16 if full else jnp.float32
    idx = IVFIndex(cfg).build(emb, dtype=dtype, seed=seed)
    # Exact baseline over the SAME cluster-major device matrix: its first
    # n rows are the corpus (the spare last row is never live).
    emb_dev = idx.emb_ivf
    rid = np.asarray(idx.row_ids)
    _, rows = dense_topk(q_dev, emb_dev, np.int32(n), k)
    exact_ids = rid[np.asarray(rows)]
    nprobe = idx.tune_nprobe(q, exact_ids, k=k, target_recall=0.95)
    _, ids = idx.search(q, k=k, nprobe=nprobe)
    recall = float(np.mean([
        len(set(np.asarray(ids)[i]) & set(exact_ids[i])) / k
        for i in range(b)]))

    # Chained-iteration timing. The corpus/table arrays are EXPLICIT jit
    # arguments — closing over a 4 GB device array would bake it into
    # the compiled program as a constant.
    iters = 10

    @jax.jit
    def exact_chain(x0, qd, embd):
        def body(i, acc):
            qq = qd * (1.0 + i.astype(jnp.float32) * 1e-7)
            s, _ = dense_topk(qq, embd, np.int32(n), k)
            return acc + s.sum()
        return jax.lax.fori_loop(0, iters, body, x0)

    @jax.jit
    def ivf_chain(x0, qd, cents, embi, table, rowids):
        def body(i, acc):
            qq = qd * (1.0 + i.astype(jnp.float32) * 1e-7)
            s, _ = ivf_scan(qq, cents, embi, table, rowids,
                            k=k, nprobe=nprobe, c_max=idx.c_max)
            return acc + s.sum()
        return jax.lax.fori_loop(0, iters, body, x0)

    def timed(fn, *args, reps=3):
        float(fn(jnp.float32(0.0), *args))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(fn(jnp.float32(0.0), *args))
            ts.append(time.perf_counter() - t0)
        return min(ts) / iters

    t_exact = timed(exact_chain, q_dev, emb_dev)
    t_ivf = timed(ivf_chain, q_dev, idx.centroids, idx.emb_ivf,
                  idx.row_table, idx.row_ids)
    return {"metric": "ivf_speedup_smallbatch",
            "value": t_exact / max(t_ivf, 1e-9), "unit": "x vs exact scan",
            "n": n, "batch": b, "nprobe": nprobe, "n_lists": idx.n_lists,
            "recall_at_10": recall,
            "exact_p50_ms": t_exact * 1e3, "ivf_p50_ms": t_ivf * 1e3}


def config8_chat(seed: int = 0) -> dict:
    """Chat operating point: hybrid (dense+BM25+RRF) device p50/p99 at
    batch 1 and 8 — the reference's actual one-query-per-request shape
    (src/app/api/chat/query/route.ts). Runs
    benchmarks/chat_latency.py's device measurement in this process, so
    one process holds the device."""
    import importlib.util
    import pathlib

    script = (pathlib.Path(__file__).resolve().parents[2]
              / "benchmarks" / "chat_latency.py")
    spec = importlib.util.spec_from_file_location("chat_latency", script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    dev = mod.device_hybrid_latency(_full())
    b1, b8 = dev[1], dev[8]
    return {
        "metric": "chat_device_p50_ms",
        "value": round(b1["device_p50_ms"], 3),
        "unit": "ms (hybrid top-8, batch 1, device-chained)",
        "b1_p99_ms": round(b1["device_p99_ms"], 3),
        "b8_p50_ms": round(b8["device_p50_ms"], 3),
        "b8_p99_ms": round(b8["device_p99_ms"], 3),
        "null_launch_p50_ms": round(dev["null_rtt_p50_ms"], 2),
    }


CONFIGS = {
    "exact_dense": config1_exact_dense,
    "hybrid": config2_hybrid,
    "memory_fusion": config3_memory_fusion,
    "graph": config4_graph,
    "sharded": config5_sharded,
    "ingest": config6_ingest,
    "ingest_base": functools.partial(config6_ingest, shape="base"),
    "ivf_latency": config7_ivf_latency,
    "chat": config8_chat,
}


def run_all(names: Optional[list[str]] = None) -> list[dict]:
    out = []
    for name in (names or list(CONFIGS)):
        out.append({"config": name, **CONFIGS[name]()})
    return out
