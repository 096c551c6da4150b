"""IVF (inverted-file) partitioned dense index.

No reference equivalent — the reference is exact-only brute force
(SURVEY.md §2.1). The recall target is recall@10 >= 0.95 against the
exact oracle.

Design note: for LARGE query batches, exact search is already efficient
— one (B, D)x(D, N) matmul amortizes every corpus byte read across the
whole batch, so IVF's skipped clusters buy little (with random batched
queries nearly every cluster is probed by someone). IVF here targets the
complementary regime: SMALL batches / single-query latency, and corpora
whose int8 layout fits the device where the exact matrix does not;
scanning nprobe*Cmax gathered rows instead of all N cuts work by
~N/(nprobe*Cmax). Recall accounting always runs against the exact
oracle (SURVEY.md §7.3).

Layout: k-means centroids (C, D); corpus rows reordered cluster-major in
one flat (N+1, D) device matrix (bf16, or int8 with one scale per
cluster); a (C, Cmax) row-id table (-1 padded) drives per-probe gathers.
Search loops over probes, folding each probe's scores into a running
top-k (static shapes throughout).
"""

from __future__ import annotations

import functools
import json
import pathlib
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpurag.core.config import IVFConfig
from tpurag.index.dense import l2_normalize
from tpurag.utils.mem import drop_memmap_pages  # re-exported (shard/ivf uses it)
from tpurag.kernels.quant import quantize_rows, rescore_topk
from tpurag.kernels.runtime import NEG_INF, round_up
from tpurag.kernels.topk import merge_topk, select_topk

_BIG = 2**30


@functools.partial(jax.jit, static_argnames=("n_iters",), donate_argnums=(1,))
def _kmeans(data, centroids, n_iters: int):
    """Lloyd iterations on-device (cosine/spherical k-means: data and
    centroids L2-normalized, assignment by max dot)."""

    def step(cents, _):
        cents = cents / jnp.maximum(
            jnp.linalg.norm(cents, axis=1, keepdims=True), 1e-30)
        scores = jnp.dot(data, cents.T, preferred_element_type=jnp.float32)
        assign = jnp.argmax(scores, axis=1)
        onehot = jax.nn.one_hot(assign, cents.shape[0], dtype=jnp.float32)
        sums = jnp.dot(onehot.T, data, preferred_element_type=jnp.float32)
        counts = jnp.sum(onehot, axis=0)[:, None]
        new = jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), cents)
        return new, None

    cents, _ = jax.lax.scan(step, centroids.astype(jnp.float32), None,
                            length=n_iters)
    return cents / jnp.maximum(
        jnp.linalg.norm(cents, axis=1, keepdims=True), 1e-30)


def _host_normalize(vectors) -> np.ndarray:
    """L2-normalize on host: IVF builds handle multi-GB snapshots (8GB
    at 2M x 1024 fp32) — a device normalize would need in+out buffers in
    device memory at once, on top of the corpus it indexes."""
    data = np.array(vectors, np.float32, copy=True)
    norms = np.linalg.norm(data, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    data /= norms
    return data


def ivf_scan(q, centroids, emb_ivf, row_table, row_ids,
             k: int, nprobe: int, c_max: int, cluster_scales=None,
             rescore_emb=None, overfetch: int = 2, nprobe_dyn=None):
    """Traceable IVF probe-scan body (shared by the single-device jit and
    the shard_map per-device path in tpurag.shard.ivf).

    q: (B, D) normalized. Returns (B, k) scores + ORIGINAL row ids
    (row_ids[-1]-padded clusters and empty slots come back as -1).

    cluster_scales: optional (C,) fp32 — emb_ivf is then the int8
    per-cluster-quantized matrix. Each probe gathers its int8 rows and
    widens only that block to bf16 (exact for |v| <= 127); the dot with
    the row-quantized query accumulates in fp32 (exact: products <= 127^2
    summed over D <= 1024 stay below 2^24), and the cluster scale applies
    after the dot. The corpus is never widened as a whole. rescore_emb
    (the full-precision packed matrix) overfetches overfetch*k int8
    candidates and re-ranks them exactly.

    nprobe_dyn: optional RUNTIME probe count <= nprobe — the scan runs
    only that many probes, so one compile at the static nprobe serves a
    whole tuning ladder (IVFIndex.tune_nprobe)."""
    b = q.shape[0]
    cscores = jnp.dot(q, centroids.T, preferred_element_type=jnp.float32)
    _, probe = jax.lax.top_k(cscores, nprobe)          # (B, nprobe)
    quant = cluster_scales is not None
    m = overfetch * k if (quant and rescore_emb is not None) else k
    if quant:
        q8, qs = quantize_rows(q)
        q_op = q8.astype(jnp.bfloat16)
    else:
        q_op = q.astype(emb_ivf.dtype)

    def scan_probe(p, carry):
        run_v, run_i = carry
        cl = probe[:, p]                                # (B,)
        rows = row_table[cl]                            # (B, Cmax) ivf rows
        valid = rows >= 0
        safe = jnp.where(valid, rows, 0)
        vecs = emb_ivf[safe].astype(q_op.dtype)         # (B, Cmax, D)
        s = jnp.einsum("bd,bcd->bc", q_op, vecs,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        if quant:
            s = s * cluster_scales[cl][:, None]
        s = jnp.where(valid, s, NEG_INF)
        tv, ti = select_topk(s, jnp.where(valid, safe, _BIG - 1),
                             min(m, c_max))
        return merge_topk(run_v, run_i, tv, ti, m)

    init = (jnp.full((b, m), NEG_INF),
            _BIG + jax.lax.broadcasted_iota(jnp.int32, (b, m), 1))
    n_live = (nprobe if nprobe_dyn is None
              else jnp.minimum(jnp.asarray(nprobe_dyn, jnp.int32), nprobe))
    vals, ivf_rows = jax.lax.fori_loop(0, n_live, scan_probe, init)
    if quant:
        if rescore_emb is not None:
            cand = jnp.where((ivf_rows >= _BIG) | (vals <= NEG_INF / 2), -1,
                             ivf_rows)
            vals, ivf_rows = rescore_topk(q.astype(jnp.float32), rescore_emb,
                                          cand, k)
            ivf_rows = jnp.where(ivf_rows < 0, _BIG, ivf_rows)
        else:
            # Scale only live entries: NEG_INF * qs would drift above
            # the empty-detection threshold.
            vals = jnp.where(vals <= NEG_INF / 2, NEG_INF,
                             vals * qs[:, None])
    empty = (vals <= NEG_INF / 2) | (ivf_rows >= _BIG)
    orig = row_ids[jnp.clip(ivf_rows, 0, row_ids.shape[0] - 1)]
    return jnp.where(empty, NEG_INF, vals), jnp.where(empty, -1, orig)


@functools.partial(jax.jit, static_argnames=("k", "nprobe", "c_max"))
def _ivf_search(q, centroids, emb_ivf, row_table, row_ids,
                k: int, nprobe: int, c_max: int, cluster_scales=None,
                rescore_emb=None, nprobe_dyn=None):
    return ivf_scan(q, centroids, emb_ivf, row_table, row_ids,
                    k=k, nprobe=nprobe, c_max=c_max,
                    cluster_scales=cluster_scales, rescore_emb=rescore_emb,
                    nprobe_dyn=nprobe_dyn)


def split_oversized(cents: np.ndarray, assign: np.ndarray,
                    data: np.ndarray, factor: Optional[float]):
    """Split clusters larger than cap = factor x mean into contiguous
    parts of <= cap rows, each part getting its own (re-averaged)
    centroid. Returns (cents, assign, counts).

    Why: every probe gathers (B, Cmax, D) rows — the row table is sized
    by the LARGEST cluster — so a k-means size skew multiplies every
    probe's gather. Capping converts the skew into a few extra lists:
    part centroids sit near the parent's mean, so a query probing the
    region ranks the parts adjacently and scans the same rows — recall
    at equal rows-scanned is unchanged while Cmax shrinks ~factor x
    skew."""
    n_lists = cents.shape[0]
    counts = np.bincount(assign, minlength=n_lists)
    if not factor or n_lists == 0:
        return cents, assign, counts
    mean = max(int(np.ceil(counts.sum() / max(n_lists, 1))), 8)
    cap = int(round_up(int(np.ceil(factor * mean)), 8))
    big = np.where(counts > cap)[0]
    if len(big) == 0:
        return cents, assign, counts
    cents = np.array(cents, np.float32, copy=True)
    assign = np.array(assign, copy=True)  # never mutate the caller's
    extra = []
    next_id = n_lists
    for c in big:
        rows = np.where(assign == c)[0]
        for gi, g in enumerate(np.array_split(
                rows, int(np.ceil(len(rows) / cap)))):
            m = data[g].mean(axis=0)
            m /= max(float(np.linalg.norm(m)), 1e-30)
            if gi == 0:
                cents[c] = m
            else:
                assign[g] = next_id
                extra.append(m[None])
                next_id += 1
    cents = np.concatenate([cents] + extra, axis=0)
    counts = np.bincount(assign, minlength=next_id)
    return cents, assign, counts


def kmeans_assign(data: np.ndarray, cfg: IVFConfig, seed: int = 0):
    """Spherical k-means over host-resident normalized `data` (N, D) f32.

    Returns (centroids (C, D) np.float32, assign (N,) np.int32, n_lists).
    Shared by the single-device IVFIndex and tpurag.shard.ivf."""
    n, _ = data.shape
    n_lists = min(cfg.n_lists, max(n // 8, 1))
    rng = np.random.default_rng(seed)
    sample = data[rng.choice(n, min(n, cfg.sample_size), replace=False)]
    init = data[rng.choice(n, n_lists, replace=False)]
    cents = _kmeans(jnp.asarray(sample), jnp.asarray(init), cfg.kmeans_iters)
    assign = np.empty(n, np.int32)
    step = 262_144
    for s in range(0, n, step):
        sc = jnp.dot(jnp.asarray(data[s:s + step]), cents.T,
                     preferred_element_type=jnp.float32)
        assign[s:s + step] = np.asarray(jnp.argmax(sc, axis=1))
    return np.asarray(cents, np.float32), assign, n_lists


def _np_storage(dtype) -> np.dtype:
    """numpy dtype matching a jnp storage dtype (bf16 via ml_dtypes)."""
    if jnp.dtype(dtype) == jnp.bfloat16:
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(dtype)


def _norm_block(blk) -> np.ndarray:
    """f32-normalize one row block (bounded by the block size)."""
    out = np.asarray(blk, np.float32)
    if out.base is not None or out is blk:
        out = out.copy()
    norms = np.sqrt(np.einsum("nd,nd->n", out, out))
    out /= np.maximum(norms, 1e-30)[:, None]
    return out


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_rows(dst, rows, idx):
    """Pack one staged block into the device-resident IVF layout."""
    return dst.at[idx].set(rows.astype(dst.dtype))


@jax.jit
def _assign_rows(rows, cents):
    """Nearest-centroid assignment for one uploaded block. int8 rows are
    per-ROW quantized — a positive per-row scale cannot change that
    row's argmax — so routing from the staged bytes is exact up to
    quantization rounding. bf16 operands with f32 accumulation: the
    tensor cores run bf16 far faster than f32 and boundary-row routing
    noise is immaterial to recall (assignments are re-scored at query
    time)."""
    sc = jax.lax.dot_general(
        rows.astype(jnp.bfloat16), cents.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)
    return jnp.argmax(sc, axis=1).astype(jnp.int32)


def sample_kmeans(source, n: int, n_lists: int, cfg, rng) -> np.ndarray:
    """k-means centroids from RANGED sample reads (bounded memory):
    returns a writable (n_lists, D) f32 array."""
    want = min(n, cfg.sample_size)
    n_ranges = max(1, min(64, want // 1024)) if want > 2048 else 1
    per = -(-want // n_ranges)
    parts = []
    for r in range(n_ranges):
        lo = (r * n) // n_ranges
        parts.append(_norm_block(source(lo, min(lo + per, n))))
    sample = np.concatenate(parts)[:want]
    del parts
    init = sample[rng.choice(len(sample), n_lists, replace=False)]
    return np.array(_kmeans(jnp.asarray(sample), jnp.asarray(init),
                            cfg.kmeans_iters), np.float32)


def stage_and_assign(source, n: int, d: int, stage_path, stage_np,
                     quant: bool, block: int, cents: np.ndarray,
                     note=lambda m: None, release=None):
    """Pass 1 of a streaming build: stage normalized rows on disk
    (per-row int8 when quant) and assign each block on device.
    release: optional callback dropping the SOURCE's page cache (e.g.
    DenseIndex.drop_page_cache), called every few blocks alongside the
    staging memmap's own page drop.
    Returns (staged memmap, rscale (N,) f32 or None, assign (N,) i32)."""
    staged = np.lib.format.open_memmap(
        stage_path, mode="w+", dtype=stage_np, shape=(n, d))
    rscale = np.empty(n, np.float32) if quant else None
    assign = np.empty(n, np.int32)
    cents_dev = jnp.asarray(cents)
    for s in range(0, n, block):
        e = min(s + block, n)
        blk = _norm_block(source(s, e))
        if quant:
            m = np.abs(blk).max(axis=1)
            sc = np.where(m > 0, m, 1.0) / 127.0
            up = np.clip(np.rint(blk / sc[:, None]), -127, 127
                         ).astype(np.int8)
            staged[s:e] = up
            rscale[s:e] = sc
        else:
            up = blk.astype(stage_np)
            staged[s:e] = up
        if e - s < block:  # pad: one compiled shape per block size
            up = np.concatenate(
                [up, np.zeros((block - (e - s), d), up.dtype)], axis=0)
        assign[s:e] = np.asarray(
            _assign_rows(jnp.asarray(up), cents_dev))[: e - s]
        note(f"assigned {e}/{n}")
        if (s // block) % 8 == 7:
            drop_memmap_pages(staged)
            if release is not None:
                release()
    staged.flush()
    drop_memmap_pages(staged)
    if release is not None:
        release()
    return staged, rscale, assign


def split_oversized_streaming(cents, assign, counts, factor, staged,
                              rscale=None):
    """split_oversized from DISK-staged rows (part centroids averaged
    from the staged bytes; dequantized when rscale is given). Mutates
    cents/assign in place where possible; returns (cents, assign,
    counts)."""
    n_lists = len(counts)
    n = len(assign)
    if not factor or not n_lists:
        return cents, assign, counts
    mean = max(int(np.ceil(n / max(n_lists, 1))), 8)
    cap = int(round_up(int(np.ceil(factor * mean)), 8))
    big = np.where(counts > cap)[0]
    extra = []
    next_id = n_lists
    for c in big:
        rows_c = np.where(assign == c)[0]
        for gi, g in enumerate(np.array_split(
                rows_c, int(np.ceil(len(rows_c) / cap)))):
            rows_f = staged[g].astype(np.float32)
            if rscale is not None:
                rows_f *= rscale[g][:, None]
            m = rows_f.mean(axis=0)
            m /= max(float(np.linalg.norm(m)), 1e-30)
            if gi == 0:
                cents[c] = m
            else:
                assign[g] = next_id
                extra.append(m[None])
                next_id += 1
    if extra:
        cents = np.concatenate([cents] + extra, axis=0)
    return cents, assign, np.bincount(assign, minlength=next_id)


def pack_layout(assign: np.ndarray, counts: np.ndarray):
    """Cluster-major packed layout for n rows over len(counts) lists.

    Returns (order, row_table, c_max): original row order[j] lands at
    packed row j; row_table (C, c_max) int32 lists each cluster's packed
    rows, -1 padded. Packed matrices hold n + 1 rows — the spare last
    row takes block-upload padding and is never listed."""
    n = len(assign)
    c_max = int(round_up(max(int(counts.max()), 1), 8))
    starts = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    order = np.argsort(assign, kind="stable")
    cl_sorted = assign[order]
    row_table = np.full((len(counts), c_max), -1, np.int32)
    row_table[cl_sorted, np.arange(n) - starts[cl_sorted]] = np.arange(
        n, dtype=np.int32)
    return order, row_table, c_max


class IVFIndex:
    """Built once from a snapshot of vectors (rebuild to refresh — the
    active/incremental segment stays on the exact path)."""

    def __init__(self, config: Optional[IVFConfig] = None):
        self.config = config or IVFConfig()
        self.centroids = None        # (C, D) f32
        self.emb_ivf = None          # (N+1, D) storage dtype
        self.row_table = None        # (C, Cmax) int32 ivf-row ids, -1 pad
        self.row_ids = None          # (N+1,) int32 original ids
        self.emb_ivf_q8 = None       # (N+1, D) int8 (quant builds)
        self.cluster_scales = None   # (C,) fp32 per-cluster dequant scale
        self.n = 0
        self.c_max = 0

    def build(self, vectors, dtype=jnp.bfloat16,
              seed: int = 0, quant: bool = False) -> "IVFIndex":
        """quant: also store a per-CLUSTER max-abs int8 copy of the
        packed rows — search then scans int8 (half the gathered bytes)
        and rescores exactly; one scale per cluster keeps the dequant a
        scalar multiply after the dot."""
        cfg = self.config
        data = _host_normalize(vectors)
        n, d = data.shape
        cents, assign, n_lists = kmeans_assign(data, cfg, seed=seed)
        n_lists_before = n_lists
        cents, assign, counts = split_oversized(
            cents, assign, data, cfg.max_cluster_factor)
        n_lists = len(counts)
        # split_oversized grows n_lists, so a fixed config.n_probe would
        # silently scan a smaller corpus fraction after a skewed build;
        # scale the DEFAULT nprobe by the growth (advisor finding).
        self.nprobe_scale = n_lists / max(n_lists_before, 1)
        order, row_table, self.c_max = pack_layout(assign, counts)
        packed = data[order]
        emb = np.zeros((n + 1, d), np.float32)
        emb[:n] = packed
        row_ids = np.full(n + 1, -1, np.int32)
        row_ids[:n] = order
        self.centroids = jnp.asarray(cents)
        self.emb_ivf = jnp.asarray(emb, dtype)
        self.row_ids = jnp.asarray(row_ids)
        self.row_table = jnp.asarray(row_table)
        if quant:
            rowmax = np.abs(data).max(axis=1)
            cl_max = np.zeros(n_lists, np.float32)
            np.maximum.at(cl_max, assign, rowmax)
            scales = np.where(cl_max > 0, cl_max / 127.0, 1.0)
            e8 = np.zeros((n + 1, d), np.int8)
            e8[:n] = np.clip(
                np.round(packed / scales[assign[order]][:, None]),
                -127, 127).astype(np.int8)
            self.emb_ivf_q8 = jnp.asarray(e8)
            self.cluster_scales = jnp.asarray(scales.astype(np.float32))
        self.n = n
        self.n_lists = n_lists
        return self

    def build_streaming(self, source, n: int, *, dtype=jnp.bfloat16,
                        seed: int = 0, quant: bool = False,
                        block: int = 1 << 18, stage_dir=None,
                        keep_rescore: Optional[bool] = None,
                        progress=None, release=None) -> "IVFIndex":
        """Build from a BLOCK SOURCE in bounded host memory (round-2
        verdict item 2: the old path materialized the whole corpus as
        host fp32 — ~40 GB twice at 10M x 1024 — so the product API could
        never reach the 10M target its own benchmark proved).

        source(lo, hi) -> (hi-lo, D) rows (any float dtype, raw or
        normalized); typically ``DenseIndex.get_rows``. Peak host memory
        is O(block x D) + O(n) int32/f32 bookkeeping: staged rows live in
        a disk-backed memmap (stage_dir or a temp dir, deleted after),
        and the packed layout goes straight to the DEVICE block by block.

        quant: stage per-ROW int8 (half the disk/upload bytes), pack the
        per-CLUSTER-requantized int8 matrix (ratio <= 1 by construction).
        keep_rescore: also pack the full-precision matrix for exact
        rescoring — default keeps it only while the bf16 copy stays under
        ~6 GB of device memory.
        """
        import shutil
        import tempfile

        cfg = self.config
        d = int(np.asarray(source(0, 1)).shape[1])
        n_lists = min(cfg.n_lists, max(n // 8, 1))
        rng = np.random.default_rng(seed)

        def note(msg):
            if progress:
                progress(msg)

        # -- k-means on a sample: ranged reads only ------------------------
        cents = sample_kmeans(source, n, n_lists, cfg, rng)
        note(f"k-means done ({n_lists} lists)")

        # -- pass 1: stage rows on disk + assign on device -----------------
        own_stage = stage_dir is None
        stage = pathlib.Path(stage_dir
                             or tempfile.mkdtemp(prefix="tpurag_ivf_"))
        stage.mkdir(parents=True, exist_ok=True)
        if quant:
            stage_np = np.dtype(np.int8)
        else:
            stage_np = _np_storage(dtype)
        staged, rscale, assign = stage_and_assign(
            source, n, d, stage / "rows.npy", stage_np, quant, block,
            cents, note=note, release=release)
        n_lists_before = n_lists

        # -- split oversized clusters (streamed part centroids) ------------
        counts = np.bincount(assign, minlength=n_lists)
        cents, assign, counts = split_oversized_streaming(
            cents, assign, counts, cfg.max_cluster_factor, staged, rscale)
        drop_memmap_pages(staged)  # split walked the fat clusters
        n_lists = len(counts)
        self.nprobe_scale = n_lists / max(n_lists_before, 1)

        # -- layout (identical shapes/contracts to build()) ----------------
        order, row_table, self.c_max = pack_layout(assign, counts)
        total = n + 1
        dest_orig = np.empty(n, np.int64)
        dest_orig[order] = np.arange(n)
        row_ids = np.full(total, -1, np.int32)
        row_ids[:n] = order
        del order

        # -- pass 2: pack block-by-block straight into device memory ------
        if quant:
            cl_max = np.zeros(n_lists, np.float32)
            np.maximum.at(cl_max, assign, rscale)
            scales = np.where(cl_max > 0, cl_max, 1.0).astype(np.float32)
            if keep_rescore is None:
                keep_rescore = total * d * 2 <= 6e9
            dest = jnp.zeros((total, d), jnp.int8)
            dest_fp = (jnp.zeros((total, d), dtype)
                       if keep_rescore else None)
        else:
            dest = jnp.zeros((total, d), dtype)
            dest_fp = None
        for s in range(0, n, block):
            e = min(s + block, n)
            rows = np.asarray(staged[s:e])
            idx = dest_orig[s:e].astype(np.int32)
            if quant:
                ratio = rscale[s:e] / scales[assign[s:e]]
                rows_q = np.clip(
                    np.rint(rows.astype(np.float32) * ratio[:, None]),
                    -127, 127).astype(np.int8)
            else:
                rows_q = rows
            if e - s < block:  # pad to the compiled shape; total-1 is
                pad = block - (e - s)  # always layout padding, never live
                rows_q = np.concatenate(
                    [rows_q, np.zeros((pad, d), rows_q.dtype)], axis=0)
                idx = np.concatenate(
                    [idx, np.full(pad, total - 1, np.int32)])
            idx_dev = jnp.asarray(idx)
            dest = _scatter_rows(dest, jnp.asarray(rows_q), idx_dev)
            # Bound in-flight copies: backends that ignore donation
            # (CPU) would otherwise stack one O(total) dest per block
            # until GC catches up — the opposite of a bounded build.
            dest.block_until_ready()
            if dest_fp is not None:
                # Re-read the ORIGINAL rows for the rescore copy — a
                # dequantized int8 round-trip would bake quantization
                # noise into the "exact" rescore matrix.
                fp = _norm_block(source(s, e)).astype(_np_storage(dtype))
                if e - s < block:
                    fp = np.concatenate(
                        [fp, np.zeros((block - (e - s), d), fp.dtype)],
                        axis=0)
                dest_fp = _scatter_rows(dest_fp, jnp.asarray(fp), idx_dev)
            note(f"packed {e}/{n}")
            if (s // block) % 8 == 7:
                drop_memmap_pages(staged)
                if dest_fp is not None and release is not None:
                    release()  # the rescore path re-reads the source
        del staged
        if own_stage:
            shutil.rmtree(stage, ignore_errors=True)

        self.centroids = jnp.asarray(cents)
        if quant:
            self.emb_ivf_q8 = dest
            self.cluster_scales = jnp.asarray(scales)
            self.emb_ivf = dest_fp  # None when the fp copy can't fit
        else:
            self.emb_ivf = dest
            self.emb_ivf_q8 = None
            self.cluster_scales = None
        self.row_ids = jnp.asarray(row_ids)
        self.row_table = jnp.asarray(row_table)
        self.n = n
        self.n_lists = n_lists
        return self

    def search(self, queries, k: int, nprobe: Optional[int] = None,
               nprobe_dyn=None):
        """nprobe_dyn: optional RUNTIME probe count <= the static nprobe
        cap — the scan stops after that many probes. One compile at the
        cap then serves a whole tuning ladder (tune_nprobe); production
        searches pass the static nprobe alone.

        Quant builds scan the int8 layout (ivf_scan) and rescore against
        the packed full-precision rows when the build kept them."""
        if nprobe is None:
            nprobe = int(np.ceil(self.config.n_probe
                                 * getattr(self, "nprobe_scale", 1.0)))
        nprobe = min(nprobe, self.n_lists)
        q = l2_normalize(queries)
        if q.ndim == 1:
            q = q[None]
        if self.emb_ivf_q8 is not None:
            return _ivf_search(q, self.centroids, self.emb_ivf_q8,
                               self.row_table, self.row_ids, k=k,
                               nprobe=nprobe, c_max=self.c_max,
                               cluster_scales=self.cluster_scales,
                               rescore_emb=self.emb_ivf,
                               nprobe_dyn=nprobe_dyn)
        return _ivf_search(q, self.centroids, self.emb_ivf, self.row_table,
                           self.row_ids, k=k, nprobe=nprobe,
                           c_max=self.c_max, nprobe_dyn=nprobe_dyn)

    def tune_nprobe(self, queries, exact_ids, k: int = 10,
                    target_recall: float = 0.95,
                    shared_shape: bool = True) -> int:
        """Smallest nprobe whose recall@k vs the exact oracle meets the
        target (the recall gate). exact_ids: (B, k) from exact search.

        Doubles to bracket the target, then binary-searches inside the
        bracket — returns the MINIMAL passing nprobe, not the first
        passing power of two (an over-probed default scans up to 2x the
        rows it needs on every production query).

        shared_shape (default on): compile ONE search at a static cap and
        drive the ladder through the runtime nprobe_dyn probe count
        instead of one compiled variant per ladder point; the cap
        (max(2*config.n_probe, 64)) escalates — one recompile per 4x —
        only if recall at the full cap still misses the target."""
        exact = np.asarray(exact_ids)

        def _recall(ids) -> float:
            got = np.asarray(ids)
            return float(np.mean([
                len(set(got[i]) & set(exact[i])) / max(len(set(exact[i])), 1)
                for i in range(exact.shape[0])
            ]))

        if shared_shape:
            cap = int(min(self.n_lists,
                          max(2 * int(np.ceil(self.config.n_probe)), 64)))

            def recall_at(nprobe: int) -> float:
                _, ids = self.search(queries, k=k, nprobe=cap,
                                     nprobe_dyn=np.int32(min(nprobe, cap)))
                return _recall(ids)

            while recall_at(cap) < target_recall and cap < self.n_lists:
                cap = int(min(self.n_lists, cap * 4))
        else:
            def recall_at(nprobe: int) -> float:
                _, ids = self.search(queries, k=k, nprobe=nprobe)
                return _recall(ids)

        lo, hi = 0, 1    # lo: last failing, hi: first passing candidate
        while hi < self.n_lists and recall_at(hi) < target_recall:
            lo, hi = hi, hi * 2
        hi = min(hi, self.n_lists)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if recall_at(mid) >= target_recall:
                hi = mid
            else:
                lo = mid
        return hi

    def save(self, path) -> None:
        """Artifacts keep the STORAGE dtype: a bf16 partition saves as
        uint16-viewed bytes (half the disk + half the upload on reload
        — jnp.asarray(f32, bf16) would ship f32 bytes and cast
        on-device), mirroring DenseIndex.save."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        extra = {}
        if self.emb_ivf_q8 is not None:
            extra["emb_q8"] = np.asarray(self.emb_ivf_q8)
            extra["cluster_scales"] = np.asarray(self.cluster_scales)
        if self.emb_ivf is None:  # quant-only layout (no fp copy fits)
            emb_np, bf16, emb_dtype = np.zeros((0, 1), np.float32), False, "none"
        else:
            emb_np = np.asarray(self.emb_ivf)
            bf16 = self.emb_ivf.dtype == jnp.bfloat16
            emb_dtype = "bfloat16" if bf16 else str(emb_np.dtype)
        np.savez(
            path,
            centroids=np.asarray(self.centroids, np.float32),
            emb=emb_np.view(np.uint16) if bf16 else emb_np,
            row_table=np.asarray(self.row_table),
            row_ids=np.asarray(self.row_ids),
            meta=json.dumps({"n": self.n, "c_max": self.c_max,
                             "n_lists": self.n_lists,
                             "nprobe_scale": getattr(self, "nprobe_scale",
                                                     1.0),
                             "emb_dtype": emb_dtype,
                             "quant": self.emb_ivf_q8 is not None}),
            **extra,
        )

    @classmethod
    def load(cls, path, config: Optional[IVFConfig] = None,
             dtype=jnp.bfloat16) -> "IVFIndex":
        data = np.load(pathlib.Path(path).with_suffix(".npz"))
        meta = json.loads(str(data["meta"]))
        idx = cls(config)
        idx.centroids = jnp.asarray(data["centroids"])
        saved = meta.get("emb_dtype", "float32")  # legacy saves: f32
        if saved == "none":  # quant-only layout: no fp matrix persisted
            idx.emb_ivf = None
        elif saved == "bfloat16":
            emb = jnp.asarray(data["emb"]).view(jnp.bfloat16)
            idx.emb_ivf = (emb if dtype == jnp.bfloat16
                           else jnp.asarray(emb, dtype))
        else:
            idx.emb_ivf = jnp.asarray(data["emb"], dtype)
        idx.row_table = jnp.asarray(data["row_table"])
        # Saves with cluster-aligned starts carry padding rows between
        # clusters; row_table lists only live rows, so they load as is.
        idx.row_ids = jnp.asarray(data["row_ids"])
        if meta.get("quant"):
            idx.emb_ivf_q8 = jnp.asarray(data["emb_q8"])
            idx.cluster_scales = jnp.asarray(data["cluster_scales"])
        idx.n = meta["n"]
        idx.c_max = meta["c_max"]
        idx.n_lists = meta["n_lists"]
        idx.nprobe_scale = meta.get("nprobe_scale", 1.0)
        return idx
