"""Device-resident dense vector index.

The reference's vector store is a LlamaIndex JSON-persisted list scanned by
JS cosine (src/lib/llm/index-manager.ts:227, hybrid-search.ts:217-247) and
is wiped + rebuilt on every ingest (index-manager.ts:46-51). Here the index
is a growable, padded (capacity, D) matrix resident in device HBM:

- rows are L2-normalized at insert, so dot == cosine;
- capacity grows by doubling (static shapes per capacity -> XLA re-jits
  only on growth, not per insert), enabling *incremental* adds — which the
  reference's memory subsystem needs on every conversation turn
  (src/lib/memory/store.ts:36-82) but its wipe-and-rebuild store cannot do;
- deletes tombstone the row (zeroed vector + host-side filter with
  overfetch); the reference never implemented vector deletes at all
  (store.ts:240-249).
"""

from __future__ import annotations

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from tpurag.kernels.dense import dense_topk
from tpurag.kernels.quant import dense_topk_q8, quantize_rows
from tpurag.kernels.runtime import NEG_INF, round_up
from tpurag.kernels.topk import merge_topk


def l2_normalize(x, eps: float = 1e-30):
    x = jnp.asarray(x, jnp.float32)
    norm = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
    return x / jnp.maximum(norm, eps)


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_rows(buf, rows, start):
    return jax.lax.dynamic_update_slice(buf, rows.astype(buf.dtype), (start, 0))


@functools.partial(jax.jit, donate_argnums=(0,))
def _zero_rows(buf, ids):
    """ids: traced (M,) int32, padded by repeating a valid id (the
    scatter is a set-to-zero, so duplicates are idempotent). Traced ids
    + pow2-padded M keep the compile cache bounded on a long-lived
    server with ongoing deletes (round-1 advisor finding)."""
    return buf.at[ids].set(0)


HOST_SCAN_BLOCK = 1 << 18  # rows per device upload in host-store scans


def _host_dtype(dtype):
    """The numpy dtype matching a jnp storage dtype (bf16 via ml_dtypes)."""
    if jnp.dtype(dtype) == jnp.bfloat16:
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(dtype)


class DenseIndex:
    def __init__(self, dim: int, dtype=jnp.bfloat16, capacity: int = 4096,
                 mesh=None, data_axis: str = "data", quant: bool = False,
                 store: str = "device", backing=None):
        """mesh: optional jax.sharding.Mesh — rows shard over `data_axis`
        and searches run per-shard top-k + all-gather merge
        (tpurag.shard.search). Single-device layout otherwise.

        quant: keep an int8 max-abs sidecar of the corpus and scan THAT
        (half the bytes a scan reads), then rescore the 2k-overfetched
        candidates against the full-precision rows — final scores stay
        exact cosines (kernels/quant.py). Under a mesh the sidecar shards
        with the rows and the rescore stays shard-local
        (shard.search.sharded_dense_topk_q8).

        store: 'device' (default) keeps the matrix in HBM; 'host' keeps
        it in host RAM (storage dtype) for corpora larger than device
        memory — exhaustive search streams HOST_SCAN_BLOCK-row tiles
        through the chip and merges top-k, and kb.build_ivf() streams the
        IVF partition from it in bounded memory (the production 10M-chunk
        path: the IVF layout fits HBM int8 where the raw bf16 corpus
        would not).

        backing: optional file path for the host store — the matrix then
        lives in a disk-backed memmap (20 GB at 10M x 1024 bf16), so even
        the raw corpus never has to fit host RAM; the page cache absorbs
        the working set and drop_page_cache() releases it after bulk
        passes."""
        if store not in ("device", "host"):
            raise ValueError(f"unknown store {store!r}")
        if store == "host" and mesh is not None:
            raise ValueError("store='host' is a single-process layout; "
                             "use the mesh path for sharded corpora")
        self.dim = dim
        self.dtype = jnp.dtype(dtype)
        self.mesh = mesh
        self.data_axis = data_axis
        self.quant = bool(quant)
        self.store = store
        self._q8 = None
        self._qscale = None
        self._row_multiple = 128
        if mesh is not None:
            self._row_multiple = 128 * mesh.shape[data_axis]
        self.capacity = round_up(max(capacity, 128), self._row_multiple)
        self._backing = None
        if store == "host":
            if backing is not None:
                self._backing = pathlib.Path(backing)
                self._backing.parent.mkdir(parents=True, exist_ok=True)
                self._emb = np.lib.format.open_memmap(
                    self._backing, mode="w+", dtype=_host_dtype(dtype),
                    shape=(self.capacity, dim))
            else:
                self._emb = np.zeros((self.capacity, dim),
                                     _host_dtype(dtype))
        else:
            self._emb = self._place(
                jnp.zeros((self.capacity, dim), self.dtype))
        self.n_active = 0
        self._deleted: set[int] = set()

    def _place(self, arr):
        if self.mesh is None:
            return arr
        from tpurag.shard.search import shard_corpus

        return shard_corpus(arr, self.mesh, self.data_axis)

    def _place1(self, arr):
        """Row-shard a 1-D per-row array (the quant scales)."""
        if self.mesh is None:
            return arr
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.device_put(
            arr, NamedSharding(self.mesh, P(self.data_axis)))

    # -- mutation ----------------------------------------------------------

    def _grow_to(self, need: int) -> None:
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        if new_cap != self.capacity:
            if self.store == "host":
                if self._backing is not None:
                    tmp = self._backing.with_suffix(".grow")
                    grown = np.lib.format.open_memmap(
                        tmp, mode="w+", dtype=self._emb.dtype,
                        shape=(new_cap, self.dim))
                    step = max(HOST_SCAN_BLOCK, 1)
                    for s in range(0, self.capacity, step):
                        e = min(s + step, self.capacity)
                        grown[s:e] = self._emb[s:e]
                    grown.flush()
                    del self._emb
                    # rename keeps the inode `grown` maps — no reopen
                    # (an npy reopen would also lose the ml_dtypes bf16
                    # descr, which round-trips as void in the header)
                    tmp.replace(self._backing)
                    self._emb = grown
                else:
                    grown = np.zeros((new_cap, self.dim), self._emb.dtype)
                    grown[: self.capacity] = self._emb
                    self._emb = grown
                self.capacity = new_cap
                return
            pad = jnp.zeros((new_cap - self.capacity, self.dim), self.dtype)
            self._emb = self._place(jnp.concatenate([self._emb, pad], axis=0))
            if self.quant and self._q8 is not None:
                grow = new_cap - self.capacity
                self._q8 = self._place(jnp.concatenate(
                    [self._q8, jnp.zeros((grow, self.dim), jnp.int8)],
                    axis=0))
                self._qscale = self._place1(jnp.concatenate(
                    [self._qscale, jnp.zeros((grow,), jnp.float32)],
                    axis=0))
            self.capacity = new_cap

    def add(self, vectors) -> np.ndarray:
        """Insert (M, D) raw vectors; returns their int32 row ids."""
        if self.store == "host":
            return self._add_host(vectors)
        vecs = l2_normalize(vectors)
        m = vecs.shape[0]
        if vecs.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: {vecs.shape[1]} != {self.dim}")
        self._grow_to(self.n_active + m)
        self._emb = _write_rows(self._emb, vecs, self.n_active)
        if self.quant:
            if self._q8 is None:
                self._q8 = self._place(
                    jnp.zeros((self.capacity, self.dim), jnp.int8))
                self._qscale = self._place1(
                    jnp.zeros((self.capacity,), jnp.float32))
            # Quantize from the STORAGE-dtype rows (not the fp32 input):
            # load() rebuilds the sidecar from self._emb, so quantizing
            # the same source keeps int8 codes — and therefore the
            # candidate set near the recall boundary — bit-identical
            # across a save/load round-trip.
            r8, rs = quantize_rows(vecs.astype(self.dtype))
            self._q8 = jax.lax.dynamic_update_slice(
                self._q8, r8, (self.n_active, 0))
            self._qscale = jax.lax.dynamic_update_slice(
                self._qscale, rs, (self.n_active,))
        ids = np.arange(self.n_active, self.n_active + m, dtype=np.int32)
        self.n_active += m
        return ids

    def _add_host(self, vectors) -> np.ndarray:
        """Host-store insert: numpy normalize (f32) -> storage cast —
        no device round-trip, bounded by the batch size."""
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        m = vecs.shape[0]
        if vecs.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: {vecs.shape[1]} != {self.dim}")
        norms = np.sqrt(np.einsum("nd,nd->n", vecs, vecs))
        vecs = vecs / np.maximum(norms, 1e-30)[:, None]
        self._grow_to(self.n_active + m)
        self._emb[self.n_active:self.n_active + m] = vecs.astype(
            self._emb.dtype)
        ids = np.arange(self.n_active, self.n_active + m, dtype=np.int32)
        self.n_active += m
        return ids

    def delete(self, ids) -> None:
        ids = [int(i) for i in np.atleast_1d(ids)]
        live = [i for i in ids if 0 <= i < self.n_active and i not in self._deleted]
        if not live:
            return
        self._deleted.update(live)
        if self.store == "host":
            self._emb[np.asarray(live, np.int64)] = 0
            return
        m = 1 << max(len(live) - 1, 0).bit_length()  # pad to pow2 bucket
        padded = np.full(m, live[0], np.int32)
        padded[: len(live)] = sorted(live)
        self._emb = _zero_rows(self._emb, jnp.asarray(padded))
        if self.quant and self._q8 is not None:
            ids_dev = jnp.asarray(padded)
            self._q8 = _zero_rows(self._q8, ids_dev)
            self._qscale = self._qscale.at[ids_dev].set(0.0)

    # -- query -------------------------------------------------------------

    def search(self, queries, k: int):
        """Top-k cosine. queries: (B, D) raw (normalized here).

        Returns (scores, ids) as (B, k) float32 / int32 device arrays;
        tombstoned and empty slots come back as score=-inf, id=-1.
        """
        if self.n_active == 0:
            b = np.asarray(queries).shape[0]
            return (jnp.full((b, k), NEG_INF), jnp.full((b, k), -1, jnp.int32))
        q = l2_normalize(queries)
        if q.ndim == 1:
            q = q[None, :]
        # Overfetch to absorb tombstones, then host-filter.
        extra = min(len(self._deleted), max(self.n_active - k, 0))
        kk = min(k + extra, self.n_active)
        if self.store == "host":
            scores, ids = self._search_host(q, kk)
        elif self.mesh is not None:
            from tpurag.shard.search import (sharded_dense_topk,
                                             sharded_dense_topk_q8)

            if self.quant and self._q8 is not None:
                scores, ids = sharded_dense_topk_q8(
                    q, self._q8, self._qscale, self._emb,
                    jnp.int32(self.n_active), kk, mesh=self.mesh,
                    data_axis=self.data_axis)
            else:
                scores, ids = sharded_dense_topk(
                    q.astype(self.dtype), self._emb,
                    jnp.int32(self.n_active), kk, mesh=self.mesh,
                    data_axis=self.data_axis)
        elif self.quant and self._q8 is not None:
            scores, ids = dense_topk_q8(
                q, self._q8, self._qscale, jnp.int32(self.n_active), kk,
                rescore_emb=self._emb)
        else:
            scores, ids = dense_topk(q, self._emb, jnp.int32(self.n_active), kk)
        if self._deleted:
            s = np.asarray(scores)
            i = np.asarray(ids)
            dead = np.isin(i, np.fromiter(self._deleted, np.int32, len(self._deleted)))
            s = np.where(dead, np.float32(NEG_INF), s)
            order = np.argsort(-s, axis=1, kind="stable")[:, :k]
            s = np.take_along_axis(s, order, axis=1)
            i = np.where(s <= NEG_INF / 2, -1, np.take_along_axis(i, order, axis=1))
            return jnp.asarray(s), jnp.asarray(i)
        return scores[:, :k], ids[:, :k]

    def _search_host(self, q, kk: int):
        """Exhaustive scan of the host-store matrix: stream fixed-size row
        tiles through the device and fold a running top-k (correct at any
        corpus size; latency is upload-bound — serve big host-store KBs
        via mode='ivf', this is the exactness oracle/tail path)."""
        from tpurag.kernels.dense import dense_topk_xla

        block = min(HOST_SCAN_BLOCK,
                    int(round_up(max(self.n_active, 128), 128)))
        qd = q.astype(self.dtype)
        b = qd.shape[0]
        run_v = jnp.full((b, kk), NEG_INF)
        run_i = jnp.full((b, kk), -1, jnp.int32)
        for s in range(0, self.n_active, block):
            m = min(block, self.n_active - s)
            rows = self._emb[s:s + m]
            if m < block:  # pad: one compiled shape per (block, kk)
                pad = np.zeros((block - m, self.dim), self._emb.dtype)
                rows = np.concatenate([rows, pad], axis=0)
            v, i = dense_topk_xla(qd, jnp.asarray(rows), np.int32(m),
                                  min(kk, block))
            i = jnp.where(i >= 0, i + s, i)
            run_v, run_i = merge_topk(run_v, run_i, v, i, kk)
        return run_v, run_i

    def drop_page_cache(self) -> None:
        """Disk-backed host store: flush dirty pages and advise the
        kernel to drop the mapping's resident pages — call between bulk
        ingest/build passes to keep RSS near the block size instead of
        the corpus size. No-op for RAM/device stores."""
        if self.store != "host" or self._backing is None:
            return
        from tpurag.utils.mem import drop_memmap_pages

        drop_memmap_pages(self._emb)

    def get_rows(self, lo: int, hi: int) -> np.ndarray:
        """Host copy of rows [lo, hi) in the STORAGE dtype — the bounded
        block accessor streaming IVF builds read from (works for both
        store modes; device mode pays one transfer per call)."""
        if self.store == "host":
            return self._emb[lo:hi]
        return np.asarray(self._emb[lo:hi])

    def get_vectors(self, ids) -> np.ndarray:
        if self.store == "host":
            return self._emb[np.asarray(ids, np.int64)].astype(np.float32)
        return np.asarray(self._emb[jnp.asarray(ids, jnp.int32)], np.float32)

    @property
    def embeddings(self) -> jax.Array:
        """The padded device matrix (capacity, D) — for sharded/IVF layers."""
        return self._emb

    def __len__(self) -> int:
        return self.n_active - len(self._deleted)

    # -- persistence (SURVEY.md §5.4) ----------------------------------------
    #
    # Artifacts: <path>.meta.json + one raw .npy per shard
    # (<path>.emb.npy single-device, <path>.emb.shardNNN.npy sharded).
    # The matrix is stored in its STORAGE dtype — bf16 rows persist as
    # their raw 2-byte payloads via a uint16 view (round 1 upconverted
    # to fp32: 2x artifact size) — and .npy files reload with
    # np.load(mmap_mode='r'): the host never materializes fp32, and a
    # multi-host process can map only its own shard file.

    def _storage_view(self, arr: np.ndarray) -> np.ndarray:
        if self.dtype == jnp.bfloat16:
            return np.asarray(arr).view(np.uint16)
        return np.asarray(arr, self.dtype)

    def save(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        n_shards = self.mesh.shape[self.data_axis] if self.mesh else 1
        meta = {
            "dim": self.dim,
            "dtype": self.dtype.name,
            "n_active": self.n_active,
            "deleted": sorted(self._deleted),
            "n_shards": n_shards,
            "capacity": self.capacity,
        }
        (path.parent / (path.name + ".meta.json")).write_text(
            json.dumps(meta))
        if n_shards == 1:
            np.save(path.parent / (path.name + ".emb.npy"),
                    self._storage_view(self._emb[: self.n_active]))
            return
        rs = self.capacity // n_shards  # contiguous row blocks = sharding
        for s in range(n_shards):
            lo, hi = s * rs, min((s + 1) * rs, self.n_active)
            rows = self._emb[lo:max(hi, lo)]
            np.save(path.parent / (path.name + f".emb.shard{s:03d}.npy"),
                    self._storage_view(rows))

    def _rebuild_quant(self) -> None:
        """(Re)quantize the whole live matrix into the int8 sidecar —
        one pass at load time; zero rows (padding/tombstones) get scale 0
        so they can never outrank a live row."""
        if self.store == "host":  # host scans read the storage rows
            return
        q8, qs = quantize_rows(self._emb)
        self._q8, self._qscale = self._place(q8), self._place1(qs)

    @classmethod
    def load(cls, path, mesh=None, data_axis: str = "data",
             quant: bool = False, store: str = "device",
             backing=None) -> "DenseIndex":
        """quant: rebuild the int8 scan sidecar after the rows load (the
        sidecar is derived data — never persisted).

        store='host': reload into host RAM instead of HBM (same artifact
        format; block-copied from the mmap, never materialized as f32).
        backing: with store='host', reload into a DISK-backed memmap at
        this path instead of RAM — without it a 10M-row KB that was
        built disk-backed would OOM the host it was built on (review
        finding)."""
        path = pathlib.Path(path)
        meta_file = path.parent / (path.name + ".meta.json")
        if not meta_file.exists():  # legacy round-1 .npz (fp32)
            data = np.load(path.with_suffix(".npz"), allow_pickle=False)
            meta = json.loads(str(data["meta"]))
            idx = cls(meta["dim"], dtype=meta["dtype"],
                      capacity=max(meta["n_active"], 128),
                      mesh=mesh, data_axis=data_axis, quant=quant,
                      store=store, backing=backing)
            if meta["n_active"]:
                idx._grow_to(meta["n_active"])
                if store == "host":
                    idx._emb[: meta["n_active"]] = np.asarray(
                        data["emb"]).astype(idx._emb.dtype)
                else:
                    idx._emb = _write_rows(idx._emb,
                                           jnp.asarray(data["emb"]), 0)
                idx.n_active = meta["n_active"]
            idx._deleted = set(meta["deleted"])
            if idx.quant:
                idx._rebuild_quant()
            return idx
        meta = json.loads(meta_file.read_text())
        idx = cls(meta["dim"], dtype=meta["dtype"],
                  capacity=max(meta["n_active"], 128),
                  mesh=mesh, data_axis=data_axis, quant=quant, store=store,
                  backing=backing)

        def as_storage(arr):
            if idx.dtype == jnp.bfloat16:
                return jnp.asarray(arr).view(jnp.bfloat16)
            return jnp.asarray(arr)

        if meta["n_shards"] == 1:
            mm = np.load(path.parent / (path.name + ".emb.npy"),
                         mmap_mode="r")
            parts = [mm]
        else:
            parts = [np.load(path.parent
                             / (path.name + f".emb.shard{s:03d}.npy"),
                             mmap_mode="r")
                     for s in range(meta["n_shards"])]
        pos = 0
        idx._grow_to(meta["n_active"])
        for mm in parts:
            if len(mm) == 0:
                continue
            if store == "host":
                raw = np.asarray(mm)
                if idx.dtype == jnp.bfloat16:
                    raw = raw.view(idx._emb.dtype)
                idx._emb[pos:pos + len(mm)] = raw
            else:
                idx._emb = _write_rows(idx._emb, as_storage(np.asarray(mm)),
                                       pos)
            pos += len(mm)
        idx.n_active = meta["n_active"]
        idx._deleted = set(meta["deleted"])
        if idx.quant:
            idx._rebuild_quant()
        return idx
