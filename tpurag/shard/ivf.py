"""IVF-sharded corpus search over a device mesh.

The reference is exact-only brute force (src/lib/hybrid-search.ts:217-247,
no ANN anywhere); the target is recall@10 >= 0.95 vs the exact oracle at
corpus sizes that need several devices.

Design (cluster-partitioned IVF):
- One GLOBAL spherical k-means (index/ivf.kmeans_assign) over the corpus.
- Clusters are partitioned across the mesh's 'data' axis by greedy
  size-balancing (largest cluster -> lightest shard), so every shard
  holds ~N/S rows and the probe-scan work stays balanced.
- Each shard owns its clusters end-to-end: local centroids, local
  cluster-major row matrix, local (C_l, Cmax) row table, and the rows'
  ORIGINAL global ids. A query probes each shard's top-nprobe_local
  LOCAL centroids (distributed IVF semantics: S * nprobe_local total
  probes) and scans only those clusters — per-shard HBM traffic is
  nprobe_local * Cmax rows instead of N/S.
- Per-shard top-k candidates (k (score, id) pairs, a few KB) are
  all-gathered and merged on every device — the same wire
  pattern as shard.search.sharded_dense_topk: bytes on the interconnect
  are O(B * k * S), independent of corpus size.

The recall gate always runs against the exact sharded oracle
(tune_nprobe), mirroring SURVEY.md §7.3's recall accounting.
"""

from __future__ import annotations

import functools
import json
import pathlib
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpurag.core.config import IVFConfig
from tpurag.index.dense import l2_normalize
from tpurag.index.ivf import _host_normalize, ivf_scan, kmeans_assign
from tpurag.kernels.runtime import round_up
from tpurag.kernels.topk import select_topk


@functools.partial(
    jax.jit,
    static_argnames=("k", "nprobe_l", "c_max", "mesh", "data_axis",
                     "batch_axis"),
)
def _sharded_ivf_search(q, cents_g, emb_g, table_g, ids_g, k: int,
                        nprobe_l: int, c_max: int, mesh: Mesh,
                        data_axis: str = "data",
                        batch_axis: Optional[str] = None):
    """q: (B, D) normalized. Global arrays are stacked per-shard blocks
    sharded over `data_axis`. Returns (B, k) scores + original ids,
    replicated over 'data' (sharded over `batch_axis` if given)."""

    def local(q_l, cents_l, emb_l, table_l, ids_l):
        vals, orig = ivf_scan(q_l, cents_l, emb_l, table_l, ids_l,
                              k=k, nprobe=nprobe_l, c_max=c_max)
        all_vals = jax.lax.all_gather(vals, data_axis, axis=1, tiled=True)
        all_ids = jax.lax.all_gather(orig, data_axis, axis=1, tiled=True)
        # -1 empties share an id; remap to distinct sentinels so the
        # select stays deterministic, then map back.
        pos = jax.lax.broadcasted_iota(jnp.int32, all_ids.shape, 1)
        tb = jnp.where(all_ids >= 0, all_ids, 2**30 + pos)
        v, t = select_topk(all_vals, tb, k)
        return v, jnp.where(t >= 2**30, -1, t)

    qspec = P(batch_axis, None)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(qspec, P(data_axis, None), P(data_axis, None),
                  P(data_axis, None), P(data_axis)),
        out_specs=(qspec, qspec),
        check_vma=False,
    )
    return fn(q, cents_g, emb_g, table_g, ids_g)


def partition_clusters(counts: np.ndarray, n_shards: int) -> list[list[int]]:
    """Greedy size-balanced partition: largest cluster to lightest shard.
    Returns per-shard cluster-id lists."""
    order = np.argsort(-counts, kind="stable")
    loads = np.zeros(n_shards, np.int64)
    bins: list[list[int]] = [[] for _ in range(n_shards)]
    for c in order:
        s = int(np.argmin(loads))
        bins[s].append(int(c))
        loads[s] += int(counts[c])
    return bins


class ShardedIVFIndex:
    """Cluster-partitioned IVF over the mesh's data axis.

    nprobe semantics: `nprobe` is the TOTAL probe budget; each shard
    probes nprobe_local = max(1, ceil(nprobe / n_shards)) of its own
    centroids (distributed-IVF candidate generation — at equal budget
    this probes a slightly different, usually better-recall, cluster set
    than global top-nprobe)."""

    def __init__(self, config: Optional[IVFConfig] = None,
                 mesh: Optional[Mesh] = None, data_axis: str = "data"):
        self.config = config or IVFConfig()
        self.mesh = mesh
        self.data_axis = data_axis
        self.cents_g = None    # (S*Cl, D) f32, zero-padded, data-sharded
        self.emb_g = None      # (S*Nl, D) storage dtype, data-sharded
        self.table_g = None    # (S*Cl, Cmax) int32 LOCAL row ids, -1 pad
        self.ids_g = None      # (S*Nl,) int32 original global ids, -1 pad
        self.n = 0
        self.c_max = 0
        self.c_local = 0       # clusters per shard (padded)
        self.n_lists = 0

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.data_axis]

    def _shard_layout(self, counts: np.ndarray):
        """Cluster -> (shard, local start) placement, packed per shard.
        Returns (bins, n_local): n_local rows per shard, the largest
        shard load plus one spare padding row, rounded to 8."""
        bins = partition_clusters(counts, self.n_shards)
        self.c_local = max(
            int(round_up(max((len(b) for b in bins), default=1), 8)), 8)
        load = max((int(sum(int(counts[c]) for c in b)) for b in bins),
                   default=0)
        return bins, int(round_up(load + 1, 8))

    def build(self, vectors, mesh: Optional[Mesh] = None,
              dtype=jnp.bfloat16, seed: int = 0) -> "ShardedIVFIndex":
        if mesh is not None:
            self.mesh = mesh
        assert self.mesh is not None, "ShardedIVFIndex needs a mesh"
        s_count = self.n_shards
        cfg = self.config
        data = _host_normalize(vectors)
        n, d = data.shape
        cents, assign, n_lists = kmeans_assign(data, cfg, seed=seed)
        from tpurag.index.ivf import split_oversized

        cents, assign, counts = split_oversized(
            cents, assign, data, cfg.max_cluster_factor)
        n_lists = len(counts)
        self.c_max = int(round_up(max(int(counts.max()), 1), 8))
        bins, n_local = self._shard_layout(counts)

        # Rows grouped cluster-major once; then sliced per shard.
        order = np.argsort(assign, kind="stable")
        starts = np.zeros(n_lists + 1, np.int64)
        np.cumsum(counts, out=starts[1:])

        cents_g = np.zeros((s_count * self.c_local, d), np.float32)
        emb_g = np.zeros((s_count * n_local, d), np.float32)
        table_g = np.full((s_count * self.c_local, self.c_max), -1, np.int32)
        ids_g = np.full((s_count * n_local,), -1, np.int32)
        for s, clusters in enumerate(bins):
            pos = 0
            for li, c in enumerate(clusters):
                rows = order[starts[c]:starts[c + 1]]
                m = len(rows)
                emb_g[s * n_local + pos: s * n_local + pos + m] = data[rows]
                ids_g[s * n_local + pos: s * n_local + pos + m] = rows
                table_g[s * self.c_local + li, :m] = np.arange(
                    pos, pos + m, dtype=np.int32)
                cents_g[s * self.c_local + li] = cents[c]
                pos += m

        sh2 = NamedSharding(self.mesh, P(self.data_axis, None))
        sh1 = NamedSharding(self.mesh, P(self.data_axis))
        self.cents_g = jax.device_put(jnp.asarray(cents_g), sh2)
        self.emb_g = jax.device_put(jnp.asarray(emb_g, dtype), sh2)
        self.table_g = jax.device_put(jnp.asarray(table_g), sh2)
        self.ids_g = jax.device_put(jnp.asarray(ids_g), sh1)
        self.n = n
        self.n_lists = n_lists
        return self

    def build_streaming(self, source, n: int, *, mesh: Optional[Mesh] = None,
                        dtype=jnp.bfloat16, seed: int = 0,
                        block: int = 1 << 18, stage_dir=None,
                        progress=None, release=None) -> "ShardedIVFIndex":
        """Build the cluster-partitioned layout from a BLOCK SOURCE in
        bounded host memory (the mesh-path twin of
        IVFIndex.build_streaming): k-means on ranged sample reads,
        disk-staged rows + device-assigned blocks, then each block
        scatters straight into the data-sharded device matrix — the
        host never materializes the corpus (~40 GB of fp32 at
        10M x 1024)."""
        import shutil
        import tempfile

        from tpurag.index.ivf import (_np_storage, _scatter_rows,
                                      drop_memmap_pages, sample_kmeans,
                                      split_oversized_streaming,
                                      stage_and_assign)

        if mesh is not None:
            self.mesh = mesh
        assert self.mesh is not None, "ShardedIVFIndex needs a mesh"
        s_count = self.n_shards
        cfg = self.config

        def note(msg):
            if progress:
                progress(msg)

        d = int(np.asarray(source(0, 1)).shape[1])
        n_lists = min(cfg.n_lists, max(n // 8, 1))
        rng = np.random.default_rng(seed)
        cents = sample_kmeans(source, n, n_lists, cfg, rng)
        note(f"k-means done ({n_lists} lists)")

        own_stage = stage_dir is None
        stage = pathlib.Path(stage_dir
                             or tempfile.mkdtemp(prefix="tpurag_sivf_"))
        stage.mkdir(parents=True, exist_ok=True)
        staged, _, assign = stage_and_assign(
            source, n, d, stage / "rows.npy", _np_storage(dtype),
            False, block, cents, note=note, release=release)

        counts = np.bincount(assign, minlength=n_lists)
        cents, assign, counts = split_oversized_streaming(
            cents, assign, counts, cfg.max_cluster_factor, staged)
        drop_memmap_pages(staged)  # split walked the fat clusters
        n_lists = len(counts)
        self.c_max = int(round_up(max(int(counts.max()), 1), 8))
        bins, n_local = self._shard_layout(counts)

        # Per-cluster placement (shard id, local start) — then a global
        # destination index per ORIGINAL row, so arrival-order blocks
        # scatter directly into the sharded matrix.
        shard_of = np.zeros(n_lists, np.int64)
        pos_of = np.zeros(n_lists, np.int64)
        li_of = np.zeros(n_lists, np.int64)
        cents_g = np.zeros((s_count * self.c_local, d), np.float32)
        table_g = np.full((s_count * self.c_local, self.c_max), -1,
                          np.int32)
        for s, clusters in enumerate(bins):
            pos = 0
            for li, c in enumerate(clusters):
                m = int(counts[c])
                shard_of[c], pos_of[c], li_of[c] = s, pos, li
                cents_g[s * self.c_local + li] = cents[c]
                table_g[s * self.c_local + li, :m] = np.arange(
                    pos, pos + m, dtype=np.int32)
                pos += m

        order = np.argsort(assign, kind="stable")
        starts_nopad = np.zeros(n_lists + 1, np.int64)
        np.cumsum(counts, out=starts_nopad[1:])
        cl_sorted = assign[order]
        within = np.arange(n) - starts_nopad[cl_sorted]
        dest_sorted = (shard_of[cl_sorted] * n_local
                       + pos_of[cl_sorted] + within)
        dest_orig = np.empty(n, np.int64)
        dest_orig[order] = dest_sorted
        ids_g = np.full((s_count * n_local,), -1, np.int32)
        ids_g[dest_sorted] = order.astype(np.int32)
        del order, cl_sorted, within, dest_sorted

        sh2 = NamedSharding(self.mesh, P(self.data_axis, None))
        sh1 = NamedSharding(self.mesh, P(self.data_axis))
        emb_g = jax.device_put(
            jnp.zeros((s_count * n_local, d), dtype), sh2)
        for s in range(0, n, block):
            e = min(s + block, n)
            rows = np.asarray(staged[s:e])
            idx = dest_orig[s:e].astype(np.int32)
            if e - s < block:  # total-1 is always tail padding
                pad = block - (e - s)
                rows = np.concatenate(
                    [rows, np.zeros((pad, d), rows.dtype)], axis=0)
                idx = np.concatenate(
                    [idx, np.full(pad, s_count * n_local - 1, np.int32)])
            emb_g = _scatter_rows(emb_g, jnp.asarray(rows),
                                  jnp.asarray(idx))
            emb_g.block_until_ready()  # bound copies where donation is off
            note(f"packed {e}/{n}")
            if (s // block) % 8 == 7:
                drop_memmap_pages(staged)
        del staged
        if own_stage:
            shutil.rmtree(stage, ignore_errors=True)
        if emb_g.sharding != sh2:  # scatter must not silently reshard
            emb_g = jax.device_put(emb_g, sh2)

        self.cents_g = jax.device_put(jnp.asarray(cents_g), sh2)
        self.emb_g = emb_g
        self.table_g = jax.device_put(jnp.asarray(table_g), sh2)
        self.ids_g = jax.device_put(jnp.asarray(ids_g), sh1)
        self.n = n
        self.n_lists = n_lists
        return self

    def _nprobe_local(self, nprobe: int) -> int:
        """Probes per shard for a total budget of `nprobe`: an even split,
        except that a budget of n_lists or more scans every local cluster
        (size balancing can give one shard more than n_lists/S lists)."""
        if nprobe >= self.n_lists:
            return self.c_local
        return max(min(-(-nprobe // self.n_shards), self.c_local), 1)

    def search(self, queries, k: int, nprobe: Optional[int] = None,
               batch_axis: Optional[str] = None):
        nprobe = nprobe or self.config.n_probe
        q = l2_normalize(queries)
        if q.ndim == 1:
            q = q[None]
        return _sharded_ivf_search(
            q, self.cents_g, self.emb_g, self.table_g, self.ids_g,
            k=k, nprobe_l=self._nprobe_local(nprobe), c_max=self.c_max,
            mesh=self.mesh, data_axis=self.data_axis, batch_axis=batch_axis)

    def tune_nprobe(self, queries, exact_ids, k: int = 10,
                    target_recall: float = 0.95,
                    start: Optional[int] = None) -> int:
        """Smallest total-probe budget meeting the recall gate vs the
        exact oracle, doubling from `start`
        (default: n_shards — one probe per shard)."""
        exact = np.asarray(exact_ids)

        def recall_at(nprobe: int) -> float:
            _, ids = self.search(queries, k=k, nprobe=nprobe)
            got = np.asarray(ids)
            return float(np.mean([
                len(set(got[i]) & set(exact[i])) / max(len(set(exact[i])), 1)
                for i in range(exact.shape[0])
            ]))

        cap = self.n_lists * 2
        lo = 0
        hi = max(int(start or self.n_shards), self.n_shards)
        while hi < cap and recall_at(hi) < target_recall:
            lo, hi = hi, min(hi * 2, cap)
        if hi >= cap and recall_at(cap) < target_recall:
            # Target unreachable even probing everything: return the
            # full budget (n_lists), never an over-probe that still
            # fails (review finding).
            return self.n_lists
        # Effective budgets move in steps of n_shards (per-shard probes
        # are ceil(nprobe / S)); binary-search the minimal passing
        # multiple inside the bracket, like IVFIndex.tune_nprobe.
        step = self.n_shards
        while hi - lo > step:
            mid = ((lo + hi) // 2) // step * step
            if mid <= lo:
                break
            if recall_at(mid) >= target_recall:
                hi = mid
            else:
                lo = mid
        return hi

    # -- persistence: one artifact per shard (SURVEY.md §5.4) --------------

    def save(self, directory) -> None:
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        s_count = self.n_shards
        cl, nl = self.c_local, self.emb_g.shape[0] // s_count
        for s in range(s_count):
            np.savez(
                d / f"ivf_shard_{s:03d}",
                cents=np.asarray(self.cents_g[s * cl:(s + 1) * cl],
                                 np.float32),
                emb=np.asarray(self.emb_g[s * nl:(s + 1) * nl],
                               np.float32).astype(np.float32),
                table=np.asarray(self.table_g[s * cl:(s + 1) * cl]),
                ids=np.asarray(self.ids_g[s * nl:(s + 1) * nl]),
            )
        (d / "ivf_meta.json").write_text(json.dumps({
            "n": self.n, "c_max": self.c_max, "c_local": self.c_local,
            "n_lists": self.n_lists, "n_shards": s_count,
            "dtype": str(self.emb_g.dtype),
        }))

    @classmethod
    def load(cls, directory, mesh: Mesh,
             config: Optional[IVFConfig] = None,
             data_axis: str = "data") -> "ShardedIVFIndex":
        d = pathlib.Path(directory)
        meta = json.loads((d / "ivf_meta.json").read_text())
        idx = cls(config, mesh=mesh, data_axis=data_axis)
        if idx.n_shards != meta["n_shards"]:
            raise ValueError(
                f"mesh has {idx.n_shards} shards; artifacts were saved "
                f"with {meta['n_shards']} — rebuild or match the mesh")
        parts = [np.load(d / f"ivf_shard_{s:03d}.npz")
                 for s in range(meta["n_shards"])]
        sh2 = NamedSharding(mesh, P(data_axis, None))
        sh1 = NamedSharding(mesh, P(data_axis))
        idx.cents_g = jax.device_put(
            jnp.asarray(np.concatenate([p["cents"] for p in parts])), sh2)
        idx.emb_g = jax.device_put(
            jnp.asarray(np.concatenate([p["emb"] for p in parts]),
                        jnp.dtype(meta["dtype"])), sh2)
        idx.table_g = jax.device_put(
            jnp.asarray(np.concatenate([p["table"] for p in parts])), sh2)
        # Saves with cluster-aligned starts carry padding rows between
        # clusters; table lists only live rows, so they load as is.
        idx.ids_g = jax.device_put(
            jnp.asarray(np.concatenate([p["ids"] for p in parts])), sh1)
        idx.n = meta["n"]
        idx.c_max = meta["c_max"]
        idx.c_local = meta["c_local"]
        idx.n_lists = meta["n_lists"]
        return idx
