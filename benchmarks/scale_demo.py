"""One-device scale demonstration: the dense scan at multi-million chunks.

A corpus sharded over a 'data' mesh (shard/search.py) scans one row
block per device in parallel and merges O(B*k*shards) candidates. This
script measures the per-device shard scan (dense_topk: the fused Triton
kernel on the GPU) at a shard of n_chunks x 1024 bf16.

Usage: python benchmarks/scale_demo.py [n_chunks]
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(n: int = 2_000_000):
    import jax
    import jax.numpy as jnp

    from tpurag.kernels.dense import dense_topk
    from tpurag.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    d, b, k = 1024, 512, 8
    rng = np.random.default_rng(0)
    print(f"building {n:,} x {d} bf16 corpus "
          f"({n * d * 2 / 1e9:.1f} GB on the device)...", file=sys.stderr,
          flush=True)
    # Build on-device in slabs to avoid an 8GB host f32 intermediate.
    slabs = []
    slab_rows = 250_000
    for s in range(0, n, slab_rows):
        rows = min(slab_rows, n - s)
        x = rng.standard_normal((rows, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        slabs.append(jnp.asarray(x, jnp.bfloat16))
    emb = jnp.concatenate(slabs, axis=0)
    del slabs
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_dev = jnp.asarray(q)
    nv = jnp.int32(n)

    iters = 10

    @jax.jit
    def chained(x0, emb_arg):  # corpus as an arg, not a captured constant
        def body(i, acc):
            qq = q_dev * (1.0 + i.astype(jnp.float32) * 1e-7)
            v, ids = dense_topk(qq, emb_arg, nv, k)
            return acc + v.sum()
        return jax.lax.fori_loop(0, iters, body, x0)

    t0 = time.perf_counter()
    float(chained(jnp.float32(0.0), emb))
    print(f"compile+first: {time.perf_counter() - t0:.0f}s",
          file=sys.stderr, flush=True)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        float(chained(jnp.float32(0.0), emb))
        ts.append((time.perf_counter() - t0) / iters)
    sec = min(ts)
    corpus_gb = n * d * 2 / 1e9
    print(json.dumps({
        "metric": "dense_scan_per_device",
        "device": jax.devices()[0].device_kind,
        "n_chunks": n,
        "batch": b,
        "ms_per_batch": round(sec * 1e3, 2),
        "qps": round(b / sec, 1),
        "corpus_gb": round(corpus_gb, 2),
        "effective_read_gbps": round(corpus_gb / sec, 1),
        "note": ("per-device shard scan; a sharded corpus runs one of "
                 "these per device + an O(B*k*shards) merge"),
    }))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000)
