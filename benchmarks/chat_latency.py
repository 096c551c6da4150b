"""Chat operating point: hybrid p50/p99 at b=1 and b=8 + server e2e.

The reference serves ONE query per request (src/app/api/chat/query/
route.ts:15-113); the headline b=1024 throughput number does not prove
the interactive case. This benchmark measures:

1. Device hybrid latency (dense top-k + width-classed BM25 + RRF) at
   batch 1 and 8 over the headline corpus shape (100k x 1024 bf16 on the
   GPU; a small fp32 shape elsewhere). Reported two ways:
     - device p50/p99: chained-iteration timing (lax.fori_loop, /iters);
     - launch p50/p99: single-launch wall time, host dispatch included;
       the separately measured null-launch time is reported beside it.
2. End-to-end server latency: RagServer + BatchingExecutor under
   concurrent HTTP load (16 clients) on a real KnowledgeBase.

Usage: python benchmarks/chat_latency.py [--server-docs N]
           [--device-only | --server-only]
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def pctl(xs, p):
    return float(np.percentile(np.asarray(xs), p))


def device_hybrid_latency(full: bool):
    """full: the headline shape in bf16 (GPU runs); else a CPU toy."""
    import jax
    import jax.numpy as jnp

    from tpurag.index.inverted import _bucket_score
    from tpurag.kernels.dense import dense_topk
    from tpurag.kernels.fusion import rrf_fuse

    if full:
        n, d, vocab, iters, launches = 100_000, 1024, 50_000, 50, 30
    else:
        n, d, vocab, iters, launches = 20_000, 256, 5_000, 3, 5
    k, t_query = 8, 8
    rng = np.random.default_rng(0)
    log(f"[device] corpus n={n} d={d}")
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    n_pad = -(-n // 2048) * 2048
    if n_pad != n:
        emb = np.concatenate([emb, np.zeros((n_pad - n, d), np.float32)])
    if full:
        # Cast to bf16 on the host: the upload moves half the bytes.
        import ml_dtypes

        emb_dev = jnp.asarray(emb.astype(ml_dtypes.bfloat16))
    else:
        emb_dev = jnp.asarray(emb, jnp.float32)

    # Bucket-matrix BM25 layout (index/inverted.py), Zipf dfs — identical
    # construction to bench.py so numbers compare.
    df_max = 2048
    df = np.clip((df_max * (1 + np.arange(vocab)) ** -0.5), 16, df_max
                 ).astype(np.int64)
    ladder = (64, 256, 1024, 2048)

    def next_pow2(x):
        return 1 << max(int(x) - 1, 1).bit_length() if x > 2 else max(x, 1)

    term_bucket = np.zeros(vocab, np.int32)
    term_row = np.zeros(vocab, np.int32)
    by_width: dict[int, list[int]] = {}
    for tidx in range(vocab):
        w = max(next_pow2(int(df[tidx])), 16)
        term_bucket[tidx] = w
        term_row[tidx] = len(by_width.setdefault(w, []))
        by_width[w].append(tidx)
    big = 2**30
    widths = tuple(sorted(by_width))
    mats = []
    for w in widths:
        tids_w = by_width[w]
        doc_mat = np.full((len(tids_w) + 1, w), big, np.int32)
        imp_mat = np.zeros((len(tids_w) + 1, w), np.float32)
        for row, tidx in enumerate(tids_w):
            m = int(df[tidx])
            doc_mat[row + 1, :m] = np.sort(
                rng.choice(n, m, replace=False).astype(np.int32))
            imp_mat[row + 1, :m] = rng.uniform(0.3, 2.2, m)
        mats.append((jnp.asarray(doc_mat), jnp.asarray(imp_mat)))
    mats = tuple(mats)
    n_valid = np.int32(n)  # host scalar: a jnp scalar const stalls lower()
    wprob = (1 + np.arange(vocab)) ** -0.7
    wprob /= wprob.sum()

    def ladder_width(p):
        for w in ladder:
            if w >= p:
                return w
        return p

    results = {}
    for b in (1, 8):
        tid = rng.choice(vocab, size=(b, t_query), p=wprob)
        # Chat queries are single requests: one width class at the
        # batch's max ladder width (the server pads a lone query the
        # same way).
        p_max = ladder_width(int(term_bucket[tid].max()))
        gb = max(8, -(-b // 8) * 8)
        gsel = np.resize(np.arange(b), gb)
        bw_g = jnp.asarray(term_bucket[tid[gsel]])
        row_g = jnp.asarray((term_row[tid[gsel]] + 1).astype(np.int32))
        idf_g = jnp.asarray(
            rng.uniform(0.5, 3.0, (gb, t_query)).astype(np.float32))
        q = rng.standard_normal((b, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        q_dev = jnp.asarray(q)

        def step(i, emb_arg, q_arg, mats_arg, bw, row, idf):
            qq = q_arg * (1.0 + i.astype(jnp.float32) * 1e-7)
            v_s, v_i = dense_topk(qq, emb_arg, n_valid, k)
            k_s, k_i = _bucket_score(
                jnp.roll(bw, i, axis=0), jnp.roll(row, i, axis=0),
                jnp.roll(idf, i, axis=0), mats_arg, k=k, p_max=p_max,
                t=t_query, widths=widths)
            s, ids, bits = rrf_fuse((v_i, k_i[:b]), weights=(1.0, 1.0),
                                    final_k=k)
            return s.sum()

        import jax as _jax

        @_jax.jit
        def chained(x0, emb_arg, q_arg, mats_arg, bw, row, idf):
            return _jax.lax.fori_loop(
                0, iters,
                lambda i, acc: acc + step(i, emb_arg, q_arg, mats_arg,
                                          bw, row, idf), x0)

        @_jax.jit
        def single(x0, emb_arg, q_arg, mats_arg, bw, row, idf):
            # np scalar, not jnp: a device scalar captured at trace time
            # stalls lower() behind pending uploads (see bench.py).
            return step(np.int32(0), emb_arg, q_arg, mats_arg, bw, row,
                        idf) + x0

        args = (emb_dev, q_dev, mats, bw_g, row_g, idf_g)
        t0 = time.perf_counter()
        float(chained(jnp.float32(0.0), *args))
        float(single(jnp.float32(0.0), *args))
        compile_s = time.perf_counter() - t0
        log(f"[device] b={b} compile+first: {compile_s:.1f}s")

        chained_ts, single_ts = [], []
        for _ in range(launches):
            t0 = time.perf_counter()
            float(chained(jnp.float32(0.0), *args))
            chained_ts.append((time.perf_counter() - t0) / iters)
        for _ in range(launches):
            t0 = time.perf_counter()
            float(single(jnp.float32(0.0), *args))
            single_ts.append(time.perf_counter() - t0)
        results[b] = {
            "device_p50_ms": pctl(chained_ts, 50) * 1e3,
            "device_p99_ms": pctl(chained_ts, 99) * 1e3,
            "launch_p50_ms": pctl(single_ts, 50) * 1e3,
            "launch_p99_ms": pctl(single_ts, 99) * 1e3,
            "compile_s": compile_s,
        }
        log(f"[device] b={b} " + json.dumps(results[b]))

    # Null launch: the fixed host cost of one dispatch and read-back.
    import jax as _jax
    import jax.numpy as jnp

    @_jax.jit
    def null(x):
        return x + 1.0

    float(null(jnp.float32(0.0)))
    rtts = []
    for _ in range(30):
        t0 = time.perf_counter()
        float(null(jnp.float32(0.0)))
        rtts.append(time.perf_counter() - t0)
    results["null_rtt_p50_ms"] = pctl(rtts, 50) * 1e3
    log(f"[device] null-launch RTT p50: {results['null_rtt_p50_ms']:.2f}ms")
    return results


def server_latency(n_docs: int):
    """Concurrent HTTP load through RagServer's BatchingExecutor."""
    import concurrent.futures
    import urllib.request

    from tpurag.api.knowledge_base import KnowledgeBase
    from tpurag.api.server import RagServer

    rng = np.random.default_rng(1)
    vocab = [f"term{i}" for i in range(4000)]
    kb = KnowledgeBase("chat-bench", dim=256)
    log(f"[server] ingesting {n_docs} docs ...")
    docs = [" ".join(vocab[j] for j in rng.integers(0, len(vocab), 60))
            for _ in range(n_docs)]
    for i, text in enumerate(docs):
        kb.add_document(f"d{i}", text)
    # Cold compiles of the batch buckets can exceed the 30s default
    # per-request budget; the warm-up below absorbs them.
    srv = RagServer(kb, search_timeout_s=900.0)
    httpd = srv.serve(port=0, background=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    queries = [" ".join(vocab[j] for j in rng.integers(0, 400, 4))
               for _ in range(256)]

    def one(q):
        data = json.dumps({"query": q, "top_k": 8}).encode()
        req = urllib.request.Request(
            base + "/search", data=data, method="POST",
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            r.read()
        return time.perf_counter() - t0

    try:
        # Warm both sequential (batch=1) and concurrent (pow2 batch
        # buckets formed by the BatchingExecutor) compile variants: an
        # unwarmed bucket pays a compile mid-measurement, which
        # shows up as a multi-second p99 that a warm server never sees.
        def warm(q):
            try:
                one(q)
            except Exception as e:       # tolerate warmup-only failures
                log(f"[server] warmup request failed: {e}")

        for q in queries[:8]:
            warm(q)
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            list(ex.map(warm, queries))
        # A failed request (timeout, reset) must not abort the whole
        # run — count it per pass and keep measuring; a non-zero error
        # count is itself a result the summary reports. Percentiles of
        # an all-failed pass report null rather than crashing.
        errors = []

        def tolerant(q):
            try:
                return one(q)
            except Exception as e:
                errors.append(repr(e))
                return None

        def ms(vals, p):
            return pctl(vals, p) * 1e3 if vals else None

        # Sequential pass: per-request service latency with no queueing.
        seq = [v for q in queries[:64] if (v := tolerant(q)) is not None]
        errors_seq, errors[:] = len(errors), []
        lat = []
        t_start = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            for v in ex.map(tolerant, queries):
                if v is not None:
                    lat.append(v)
        wall = time.perf_counter() - t_start
        if errors_seq or errors:
            log(f"[server] failed requests: {errors_seq} sequential, "
                f"{len(errors)} concurrent"
                + (f", e.g. {errors[0]}" if errors else ""))
        return {
            "n_docs": n_docs, "clients": 16, "requests": len(queries),
            "errors_seq": errors_seq, "errors_concurrent": len(errors),
            "seq_p50_ms": ms(seq, 50),
            "seq_p99_ms": ms(seq, 99),
            "e2e_p50_ms": ms(lat, 50),
            "e2e_p99_ms": ms(lat, 99),
            "throughput_qps": len(lat) / wall,
        }
    finally:
        srv.shutdown()


def main():
    import jax

    from tpurag.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    full = jax.default_backend() == "gpu"
    log(f"backend={jax.default_backend()}")

    n_docs = 4000 if full else 400
    if "--server-docs" in sys.argv:
        n_docs = int(sys.argv[sys.argv.index("--server-docs") + 1])

    dev = (None if "--server-only" in sys.argv
           else device_hybrid_latency(full))
    srvr = (None if "--device-only" in sys.argv
            else server_latency(n_docs))
    print(json.dumps({"device": dev, "server": srvr}, indent=2))


if __name__ == "__main__":
    main()
