"""Headline benchmark: hybrid QPS on one GPU (top-8 RRF over a 100k corpus).

    python bench.py              # needs a GPU; exits non-zero without one
    python bench.py --rehearse   # CPU toy shape (n=20k, d=256, b=64)

Prints ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline"}, plus human-readable detail lines on stderr (device,
card and power limit, per-point timings).

Operating point: sweeps the batch axis (1024, 768, 512) and reports the
highest-QPS point whose p50 batch latency also meets the <5 ms gate. All
swept points are logged to stderr.

The measured step is the full fused hybrid query path on-device:
  one dense cosine top-k over the whole batch (bf16 corpus; the fused
  matmul + top-k kernel on the GPU, kernels/dense.py)
  + BM25 per width class: bucket-matrix row gathers + the sort +
    segment-sum + top-k tail at each class's ladder width, and the exact
    narrow + wide split for queries holding huge-df terms
  + RRF rank-merge fusion to top-8.

Storage and query layout mirror index/inverted.py exactly (per-width
bucket matrices, row 0 = pad, precomputed impacts, width-classed
batching with query classes rounded up to BM25Config.width_ladder).
Query terms are Zipf-sampled (frequent terms likelier in queries, like
real query logs).
"""

from __future__ import annotations

import functools
import json
import sys
import time

import numpy as np

BASELINE_QPS = 50_000.0    # the build target: hybrid QPS per device
P50_GATE_MS = 5.0
WIDTH_LADDER = (64, 256, 1024, 2048)  # BM25Config.width_ladder default


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length() if x > 2 else max(int(x), 1)


def _ladder_width(p: int) -> int:
    for w in WIDTH_LADDER:
        if w >= p:
            return w
    return p


def card() -> str:
    """nvidia-smi's name and power limit of the card (or why not)."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main():
    import os

    rehearse = "--rehearse" in sys.argv
    import jax
    import jax.numpy as jnp

    from tpurag.utils.compile_cache import enable_compile_cache

    backend = jax.default_backend()
    if backend != "gpu" and not rehearse:
        print(f"bench.py: needs a GPU, jax.default_backend() is "
              f"{backend!r} (--rehearse runs the CPU toy shape)",
              file=sys.stderr)
        sys.exit(2)
    enable_compile_cache()
    dev = jax.devices()[0]
    log(f"backend={backend} device={dev.device_kind} "
        f"x{len(jax.devices())} card={card()} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")

    # Config 2 shape: 100k chunks, dim 1024, top-8 hybrid. Batch points
    # ordered by descending expected QPS; the sweep stops once a point
    # meets the p50 gate with margin.
    if not rehearse:
        n, d, vocab = 100_000, 1024, 50_000
        batches = (1024, 768, 512)
        if os.environ.get("TPURAG_BENCH_N"):
            # Corpus-size override (e.g. TPURAG_BENCH_N=1000000 for the
            # >=1M-chunk hybrid point): postings scale with n at a fixed
            # ~50-postings/doc density, vocab with sqrt(n).
            n = int(os.environ["TPURAG_BENCH_N"])
            vocab = max(50_000, int(5_000 * (n / 100_000) ** 0.5) * 10)
        if os.environ.get("TPURAG_BENCH_BATCHES"):  # diagnostics
            batches = tuple(int(x) for x in
                            os.environ["TPURAG_BENCH_BATCHES"].split(","))
        # Chained device iterations per launch amortize the per-launch
        # host overhead into the per-batch latency.
        iters = int(os.environ.get("TPURAG_BENCH_ITERS", "100"))
    else:  # CPU rehearsal: control flow only, no device numbers
        n, d, vocab = 20_000, 256, 5_000
        batches = (64,)
        iters = 3

    k, t_query, df_max = 8, 8, 2048
    if n > 100_000:
        df_max = int(2048 * n / 100_000)  # keep postings/doc density
    if os.environ.get("TPURAG_BENCH_DFMAX"):  # diagnostics (wide classes)
        df_max = int(os.environ["TPURAG_BENCH_DFMAX"])
    # Impact-ordered pruning (BM25Config.head_m): terms with df > head_m
    # score only their top-head_m-impact postings (approximate; bounds
    # the wide classes past ~512k docs). 0 = exact.
    head_m = int(os.environ.get("TPURAG_BENCH_HEADM", "0"))

    from tpurag.index.inverted import _bucket_score, wide_flow
    from tpurag.kernels.dense import dense_topk
    from tpurag.kernels.fusion import rrf_fuse

    # Bisect aid: TPURAG_BENCH_SKIP=dense,simple,wide disables legs of
    # the fused step (diagnosing device faults leg by leg). With the
    # dense leg off the corpus is never touched — use a tiny stand-in
    # so each bisect run skips the multi-minute build/upload.
    skip = set(filter(None, os.environ.get(
        "TPURAG_BENCH_SKIP", "").split(",")))

    rng = np.random.default_rng(0)
    n_full = n
    if "dense" in skip:
        n = 2048
    log(f"building synthetic corpus n={n} d={d} ...")
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    # Pre-pad rows to a tile multiple (production DenseIndex capacities
    # are multiples of 128) so no wrapper re-pads the corpus per step.
    n_pad = -(-n // 2048) * 2048
    if n_pad != n:
        emb = np.concatenate(
            [emb, np.zeros((n_pad - n, d), np.float32)], axis=0)
    # bf16 storage, as DenseIndex keeps it; cast on the host so the
    # upload moves half the bytes.
    import ml_dtypes

    emb_dev = jnp.asarray(emb.astype(ml_dtypes.bfloat16))
    del emb

    # Opt-in experiment: int8 dense scan + exact rescore for the dense
    # leg (TPURAG_BENCH_QUANT=1); recall is guarded by the 2x-overfetch
    # exact rescore against the bf16 matrix (same guarantee as
    # quant=True production KBs).
    quant = bool(os.environ.get("TPURAG_BENCH_QUANT"))
    if quant:
        from tpurag.kernels.quant import quantize_rows

        # Quantize from the device-resident bf16 corpus (same source as
        # production quant=True KBs).
        q8_dev, qscale_dev = quantize_rows(emb_dev)
        emb_dev = (q8_dev, qscale_dev, emb_dev)

    # Synthetic Zipf inverted index in the production bucket-matrix layout
    # (index/inverted.py): per-width (n_terms+1, w) doc/impact matrices,
    # doc-sorted rows, row 0 = pad, impacts precomputed.
    df = np.clip((df_max * (1 + np.arange(vocab)) ** -0.5), 16, df_max
                 ).astype(np.int64)
    term_bucket = np.zeros(vocab, np.int32)
    term_row = np.zeros(vocab, np.int32)
    by_width: dict[int, list[int]] = {}
    for tidx in range(vocab):
        m_eff = min(int(df[tidx]), head_m) if head_m else int(df[tidx])
        wdt = max(_next_pow2(m_eff), 16)
        term_bucket[tidx] = wdt
        term_row[tidx] = len(by_width.setdefault(wdt, []))
        by_width[wdt].append(tidx)
    big = 2**30
    widths = tuple(sorted(by_width))
    mats = []
    nnz = 0
    for wdt in widths:
        tids_w = by_width[wdt]
        doc_mat = np.full((len(tids_w) + 1, wdt), big, np.int32)
        imp_mat = np.zeros((len(tids_w) + 1, wdt), np.float32)
        for row, tidx in enumerate(tids_w):
            m = int(df[tidx])
            docs = np.sort(rng.choice(n_full, m, replace=False).astype(np.int32))
            imps = rng.uniform(0.3, 2.2, m).astype(np.float32)
            if head_m and m > head_m:
                # Mirror _build_layout's head path: keep the top-head_m
                # postings by impact, doc-sorted.
                top = np.argpartition(-imps, head_m - 1)[:head_m]
                top = top[np.argsort(docs[top], kind="stable")]
                docs, imps, m = docs[top], imps[top], head_m
            doc_mat[row + 1, :m] = docs
            imp_mat[row + 1, :m] = imps
            nnz += m
        mats.append((jnp.asarray(doc_mat), jnp.asarray(imp_mat)))
    mats = tuple(mats)
    # np (host) scalar, NOT jnp: a device scalar captured as a jaxpr
    # constant forces a device sync inside lower().
    n_valid = np.int32(n)
    log(f"inverted index nnz={nnz} widths={widths}")

    wprob = (1 + np.arange(vocab)) ** -0.7
    wprob /= wprob.sum()

    WIDE_W = WIDTH_LADDER[-1]  # BM25Config.wide_term_width default

    def build_point(b: int):
        """One operating point at batch size b: returns a chained-step fn."""
        # Zipf-weighted query terms; width-classed at LADDER widths.
        # Queries containing huge-df terms (bucket > 2048) split into
        # narrow + wide groups combined exactly — mirrors
        # index/inverted.py _score/_score_wide (round-4 exact wide path).
        tid = rng.choice(vocab, size=(b, t_query), p=wprob)
        tb_q = term_bucket[tid]                      # (b, t)
        is_wide = tb_q > WIDE_W
        hard = np.where(is_wide.any(axis=1))[0]
        simple = np.where(~is_wide.any(axis=1))[0]
        q_pmax = np.array([_ladder_width(p) for p in tb_q.max(axis=1)])
        classes = [(int(p), simple[q_pmax[simple] == p])
                   for p in sorted(set(q_pmax[simple].tolist()))]
        classes = [(p, s) for p, s in classes if len(s)]
        log(f"b={b} simple classes: "
            + ", ".join(f"p={p}: {len(s)}" for p, s in classes)
            + f"; hard (wide-term) queries: {len(hard)}")

        q = rng.standard_normal((b, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        q_dev = jnp.asarray(q)
        idf_all = rng.uniform(0.5, 3.0, (b, t_query)).astype(np.float32)

        def group_const(p_max, sel, bw, ri, idf):
            gb = max(8, -(-len(sel) // 8) * 8)  # pad rows to 8-multiple
            pad = gb - len(sel)
            if pad:
                bw = np.pad(bw, ((0, pad), (0, 0)))
                ri = np.pad(ri, ((0, pad), (0, 0)))
                idf = np.pad(idf, ((0, pad), (0, 0)))
            return (int(p_max), jnp.asarray(sel.astype(np.int32)),
                    len(sel), jnp.asarray(bw), jnp.asarray(ri),
                    jnp.asarray(idf))

        class_const = [
            group_const(p_max, sel, tb_q[sel],
                        (term_row[tid[sel]] + 1).astype(np.int32),
                        idf_all[sel])
            for p_max, sel in classes]

        # Hard queries: narrow side keeps all t_query slots with wide
        # slots parked (bucketw 0); wide side compacts wide terms into
        # pow2(t_w) slots at the class's own width.
        n_const, w_const = [], []
        wn_max = 16
        if len(hard):
            nb = np.where(is_wide, 0, tb_q)          # (b, t) narrow view
            nr = np.where(is_wide, 0, term_row[tid] + 1).astype(np.int32)
            n_pmax = np.array([_ladder_width(max(p, 16))
                               for p in nb[hard].max(axis=1)])
            for p in sorted(set(n_pmax.tolist())):
                sel = hard[n_pmax == p]
                n_const.append(group_const(
                    p, sel, nb[sel], nr[sel],
                    np.where(is_wide[sel], 0, idf_all[sel])))
                wn_max = max(wn_max, p * t_query)
            w_counts = is_wide[hard].sum(axis=1)
            w_pmax = np.where(is_wide[hard], tb_q[hard], 0).max(axis=1)
            w_tw = np.array([_next_pow2(c) for c in w_counts])
            for key in sorted({(int(p), int(t))
                               for p, t in zip(w_pmax, w_tw)}):
                p_w, t_w = key
                sel = hard[(w_pmax == p_w) & (w_tw == t_w)]
                g = len(sel)
                bw = np.zeros((g, t_w), np.int32)
                ri = np.zeros((g, t_w), np.int32)
                idf = np.zeros((g, t_w), np.float32)
                for gi, bi in enumerate(sel):
                    slots = np.where(is_wide[bi])[0]
                    bw[gi, : len(slots)] = tb_q[bi, slots]
                    ri[gi, : len(slots)] = term_row[tid[bi, slots]] + 1
                    idf[gi, : len(slots)] = idf_all[bi, slots]
                w_const.append(group_const(p_w, sel, bw, ri, idf))
            log(f"b={b} hard classes: narrow "
                + ",".join(f"p{p}" for p, *_ in
                           [(c[0],) for c in n_const])
                + " wide "
                + ",".join(f"(p{c[0]},t{c[4].shape[1]})"
                           for c in w_const))

        # Static per-class metadata (shapes/p_max) stays closed over;
        # every ARRAY rides through jit arguments as a pytree — a
        # closed-over device array would become a lowering constant
        # baked into the compiled program.
        def split_const(const):
            meta = [(p_max, n_real, bw.shape[1])
                    for (p_max, _, n_real, bw, *_) in const]
            arrs = tuple((sel, bw, ri, idf)
                         for _, sel, _, bw, ri, idf in const)
            return meta, arrs

        # Bisect aid: TPURAG_BENCH_NSLICE / TPURAG_BENCH_WSLICE = "a:b"
        # keep only that slice of the narrow/wide hard classes.
        def _slice_env(name, lst):
            v = os.environ.get(name)
            if not v:
                return lst
            a, _, bnd = v.partition(":")
            return lst[int(a or 0):int(bnd) if bnd else None]

        n_const = _slice_env("TPURAG_BENCH_NSLICE", n_const)
        w_const = _slice_env("TPURAG_BENCH_WSLICE", w_const)

        class_meta, class_arrs = split_const(class_const)
        n_meta, n_arrs = split_const(n_const)
        w_meta, w_arrs = split_const(w_const)
        class_arrs = (class_arrs, n_arrs, w_arrs,
                      jnp.asarray(hard.astype(np.int32)))

        # Bisect aid: TPURAG_BENCH_SKIP=dense,simple,wide disables legs
        # of the fused step (diagnosing device faults leg by leg).
        skip = set(filter(None, os.environ.get(
            "TPURAG_BENCH_SKIP", "").split(",")))

        def step(i, emb_arg, q_arg, mats_arg, carrs):
            qq = q_arg * (1.0 + i.astype(jnp.float32) * 1e-7)
            if "dense" in skip:
                v_s = jnp.zeros((b, k), jnp.float32)
                v_i = jnp.full((b, k), -1, jnp.int32)
            elif quant:
                from tpurag.kernels.quant import dense_topk_q8

                q8_a, qs_a, emb_a = emb_arg
                v_s, v_i = dense_topk_q8(qq, q8_a, qs_a, n_valid, k,
                                         rescore_emb=emb_a)
            else:
                v_s, v_i = dense_topk(qq, emb_arg, n_valid, k)
            # Per-class BM25 at its ladder width; scatter class results
            # back into one (B, k) candidate table for fusion.
            carrs_c, carrs_n, carrs_w, hard_sel = carrs
            k_i_full = jnp.full((b, k), -1, jnp.int32)
            for (p_max, n_real, t_c), (sel, bw_g, row_g, idf_g) in zip(
                    class_meta, carrs_c):
                if "simple" in skip:
                    break
                k_s, k_i = _bucket_score(
                    jnp.roll(bw_g, i, axis=0), jnp.roll(row_g, i, axis=0),
                    jnp.roll(idf_g, i, axis=0), mats_arg,
                    k=k, p_max=p_max, t=t_c, widths=widths)
                k_i_full = k_i_full.at[sel].set(k_i[:n_real])
            if w_meta and "wide" not in skip:
                # Hard queries: exact narrow+wide split (wide_flow).
                def flow_classes(meta, arrs):
                    out = []
                    for m, (sel, bw_g, row_g, idf_g) in zip(meta, arrs):
                        p_max, n_real, t_c = m
                        out.append((p_max, t_c, sel, n_real,
                                    jnp.roll(bw_g, i, axis=0),
                                    jnp.roll(row_g, i, axis=0),
                                    jnp.roll(idf_g, i, axis=0)))
                    return out

                wf_s, wf_i = wide_flow(
                    flow_classes(n_meta, carrs_n),
                    flow_classes(w_meta, carrs_w),
                    h=b, kk=k, wn_max=wn_max, mats=mats_arg,
                    widths=widths)
                k_i_full = k_i_full.at[hard_sel].set(wf_i[hard_sel])
            s, ids, bits = rrf_fuse((v_i, k_i_full), weights=(1.0, 1.0),
                                    final_k=k)
            return s.sum()

        # Amortized timing: ITERS query batches chained inside one jit, so
        # per-launch host overhead amortizes away. Inputs rotate per
        # iteration so nothing hoists.
        @jax.jit
        def chained(x0, emb_arg, q_arg, mats_arg, carrs):
            return jax.lax.fori_loop(
                0, iters,
                lambda i, acc: acc + step(i, emb_arg, q_arg, mats_arg,
                                          carrs), x0)

        return functools.partial(chained, q_arg=q_dev, mats_arg=mats,
                                 carrs=class_arrs)

    points = []
    for b in batches:
        chained0 = build_point(b)
        chained = lambda x0: chained0(x0, emb_arg=emb_dev)  # noqa: E731
        if "--key-probe" in sys.argv:
            # Print the canonicalized-computation hash (no compile):
            # diagnosing cross-process cache-key stability.
            import hashlib

            from jax._src import cache_key as _ck

            inner, kw = chained0.func, dict(chained0.keywords)
            low = inner.lower(jnp.float32(0.0), emb_arg=emb_dev, **kw)
            module = low.compiler_ir(dialect="stablehlo")
            ir_bytes = _ck._canonicalize_ir(module, _ck.IgnoreCallbacks.NO)
            log(f"b={b} canonical-IR bytes={len(ir_bytes)} "
                f"hash={hashlib.sha256(ir_bytes).hexdigest()[:16]}")
            return
        log(f"b={b}: compiling ...")
        t0 = time.perf_counter()
        inner, kw = chained0.func, dict(chained0.keywords)
        low = inner.lower(jnp.float32(0.0), emb_arg=emb_dev, **kw)
        t1 = time.perf_counter()
        comp = low.compile()
        t2 = time.perf_counter()
        float(comp(jnp.float32(0.0), emb_arg=emb_dev, **kw).block_until_ready())
        compile_s = time.perf_counter() - t0
        log(f"b={b}: first call (compile+run): {compile_s:.1f}s "
            f"[trace+lower {t1 - t0:.1f}s, compile/cache-load {t2 - t1:.1f}s,"
            f" first-exec {compile_s - (t2 - t0):.1f}s]")
        if "--stages" in sys.argv:  # diagnose where the first call goes
            import jax as _jax

            inner = chained0.func  # the jitted chained
            kw = dict(chained0.keywords)
            t0 = time.perf_counter()
            low = inner.lower(jnp.float32(0.0), emb_arg=emb_dev, **kw)
            t1 = time.perf_counter()
            comp = low.compile()
            t2 = time.perf_counter()
            _jax.block_until_ready(
                comp(jnp.float32(0.0), emb_arg=emb_dev, **kw))
            t3 = time.perf_counter()
            log(f"b={b} stages: lower={t1 - t0:.1f}s "
                f"compile(cached)={t2 - t1:.1f}s exec1={t3 - t2:.1f}s")

        ts = []
        for _ in range(4):
            t0 = time.perf_counter()
            float(chained(jnp.float32(0.0)))
            ts.append((time.perf_counter() - t0) / iters)
        p50 = float(np.percentile(ts, 50))
        qps = b / p50
        log(f"b={b} p50_batch_latency={p50 * 1e3:.3f}ms "
            f"min={min(ts) * 1e3:.3f}ms qps={qps:,.0f}")
        points.append({"b": b, "p50_ms": p50 * 1e3, "qps": qps,
                       "compile_s": compile_s})
        # Margin banking: keep sweeping until some compliant point has
        # >=15% latency margin (or two compliant points exist to choose
        # between), so run-to-run drift does not flip the gate.
        compliant_now = [p for p in points if p["p50_ms"] < P50_GATE_MS]
        if (any(p["p50_ms"] <= 0.85 * P50_GATE_MS for p in compliant_now)
                or len(compliant_now) >= 2):
            break

    compliant = [p for p in points if p["p50_ms"] < P50_GATE_MS]
    if compliant:
        # Prefer a >=15%-margin point when its QPS is within 5% of the
        # best compliant point's.
        best = max(compliant, key=lambda p: p["qps"])
        safe = [p for p in compliant if p["p50_ms"] <= 0.85 * P50_GATE_MS]
        if safe:
            best_safe = max(safe, key=lambda p: p["qps"])
            if best_safe["qps"] >= 0.95 * best["qps"]:
                best = best_safe
    else:
        best = min(points, key=lambda p: p["p50_ms"])
    log("chosen point: " + json.dumps(best))

    print(json.dumps({
        "metric": "hybrid_qps_per_chip",
        "value": round(best["qps"], 1),
        "unit": f"QPS (top-{k} RRF, {n // 1000}k chunks, dim {d}, "
                + (f"head_m={head_m}, " if head_m else "")
                + f"batch {best['b']}, p50 batch latency "
                f"{best['p50_ms']:.2f}ms < {P50_GATE_MS:.0f}ms gate"
                f"{'' if compliant else ' MISSED'}, backend {backend})",
        "vs_baseline": round(best["qps"] / BASELINE_QPS, 3),
    }))


if __name__ == "__main__":
    main()
