import jax.numpy as jnp
import numpy as np
import pytest

from tpurag.core.config import IVFConfig
from tpurag.index.ivf import IVFIndex
from tpurag.kernels.dense import dense_topk_xla
from tpurag.index.dense import l2_normalize


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(42)
    # Clustered data (realistic for IVF): 32 gaussian blobs.
    centers = rng.standard_normal((32, 48)).astype(np.float32) * 3
    data = np.concatenate([
        centers[i] + rng.standard_normal((128, 48)).astype(np.float32)
        for i in range(32)
    ])
    rng.shuffle(data)
    return data


@pytest.fixture(scope="module")
def ivf(corpus):
    return IVFIndex(IVFConfig(n_lists=64, n_probe=8, kmeans_iters=5)).build(
        corpus, dtype=jnp.float32)


def exact(corpus, q, k):
    emb = jnp.asarray(np.asarray(l2_normalize(corpus)))
    return dense_topk_xla(l2_normalize(q), emb, jnp.int32(len(corpus)), k)


def test_full_probe_equals_exact(corpus, ivf):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((5, 48)).astype(np.float32)
    _, ei = exact(corpus, jnp.asarray(q), 10)
    sv, si = ivf.search(q, k=10, nprobe=ivf.n_lists)
    # Probing every list is exhaustive -> identical id sets.
    for a, b in zip(np.asarray(si), np.asarray(ei)):
        assert set(a) == set(b)


def test_recall_at_10_meets_target(corpus, ivf):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((20, 48)).astype(np.float32)
    _, ei = exact(corpus, jnp.asarray(q), 10)
    _, si = ivf.search(q, k=10, nprobe=16)
    recalls = [
        len(set(np.asarray(si)[i]) & set(np.asarray(ei)[i])) / 10
        for i in range(20)
    ]
    assert float(np.mean(recalls)) >= 0.95


def test_tune_nprobe(corpus, ivf):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((10, 48)).astype(np.float32)
    _, ei = exact(corpus, jnp.asarray(q), 10)
    np_star = ivf.tune_nprobe(q, ei, k=10, target_recall=0.95)
    assert 1 <= np_star <= ivf.n_lists
    _, si = ivf.search(q, k=10, nprobe=np_star)
    recall = np.mean([
        len(set(np.asarray(si)[i]) & set(np.asarray(ei)[i])) / 10
        for i in range(10)
    ])
    assert recall >= 0.95


def test_single_query_vector(corpus, ivf):
    q = corpus[7]
    sv, si = ivf.search(q, k=1, nprobe=8)
    assert int(np.asarray(si)[0, 0]) == 7
    assert float(np.asarray(sv)[0, 0]) == pytest.approx(1.0, abs=1e-4)


def test_save_load(corpus, ivf, tmp_path):
    ivf.save(tmp_path / "ivf")
    ivf2 = IVFIndex.load(tmp_path / "ivf", dtype=jnp.float32)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 48)).astype(np.float32)
    s1, i1 = ivf.search(q, k=5, nprobe=8)
    s2, i2 = ivf2.search(q, k=5, nprobe=8)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_kb_ivf_mode_with_tail_segment(rng):
    """KB IVF mode: snapshot + exact tail scan for post-build adds."""
    from tpurag import KnowledgeBase
    from tpurag.core.config import EngineConfig, IVFConfig

    cfg = EngineConfig(ivf=IVFConfig(n_lists=16, n_probe=16, kmeans_iters=3))
    kb = KnowledgeBase("ivf-kb", config=cfg)
    for i in range(40):
        kb.add_document(f"doc{i}", f"document number {i} about topic "
                                   f"{['ships', 'birds', 'rocks'][i % 3]} "
                                   * 4)
    kb.build_ivf()
    r = kb.search("document about birds topic", mode="ivf", top_k=5)
    assert r.results and all("birds" in x.text or "document" in x.text
                             for x in r.results)
    # Tail segment: new doc added AFTER the IVF build must be findable.
    kb.add_document("fresh", "a brand new unique document about zeppelins "
                             "and airships flying high " * 3)
    r2 = kb.search("zeppelins airships unique document", mode="ivf", top_k=3)
    assert r2.results and r2.results[0].doc_name == "fresh"


def test_small_corpus():
    rng = np.random.default_rng(5)
    data = rng.standard_normal((40, 16)).astype(np.float32)
    ivf = IVFIndex(IVFConfig(n_lists=128, kmeans_iters=3)).build(
        data, dtype=jnp.float32)
    assert ivf.n_lists <= 40 // 8
    _, si = ivf.search(data[3], k=1, nprobe=ivf.n_lists)
    assert int(np.asarray(si)[0, 0]) == 3


def np_probe_scan(ivf, q, k, nprobe):
    """NumPy reference of the probe scan over the packed layout: top
    nprobe centroids, every row of those clusters scored, top-k by
    (score desc, packed row asc), mapped to original ids."""
    emb = np.asarray(ivf.emb_ivf, np.float64)
    table = np.asarray(ivf.row_table)
    row_ids = np.asarray(ivf.row_ids)
    cs = q @ np.asarray(ivf.centroids).T
    out_v, out_i = [], []
    for b in range(q.shape[0]):
        probe = np.argsort(-cs[b], kind="stable")[:nprobe]
        rows = np.concatenate([table[c][table[c] >= 0] for c in probe])
        sc = emb[rows] @ q[b].astype(np.float64)
        order = np.lexsort((rows, -sc))[:k]
        out_v.append(sc[order])
        out_i.append(row_ids[rows[order]])
    return np.stack(out_v), np.stack(out_i)


def test_probe_scan_matches_numpy(corpus, ivf):
    rng = np.random.default_rng(3)
    q = np.asarray(l2_normalize(
        rng.standard_normal((4, 48)).astype(np.float32)))
    xv, xi = ivf.search(jnp.asarray(q), k=10, nprobe=8)
    ev, ei = np_probe_scan(ivf, q, 10, 8)
    np.testing.assert_array_equal(np.asarray(xi), ei)
    np.testing.assert_allclose(np.asarray(xv), ev, atol=1e-5)


def test_full_probe_small_clusters():
    rng = np.random.default_rng(5)
    data = rng.standard_normal((40, 32)).astype(np.float32)
    ivf = IVFIndex(IVFConfig(n_lists=16, n_probe=16, kmeans_iters=3)).build(
        data, dtype=jnp.float32)
    q = np.asarray(l2_normalize(
        rng.standard_normal((2, 32)).astype(np.float32)))
    _, pi = ivf.search(jnp.asarray(q), k=10, nprobe=ivf.n_lists)
    # Exhaustive probe of a 40-row corpus -> top-10 == exact top-10.
    _, ei = exact(data, jnp.asarray(q), 10)
    np.testing.assert_array_equal(np.sort(np.asarray(pi)),
                                  np.sort(np.asarray(ei)))


def test_quant_build_scan_recall(corpus):
    from tpurag.index.ivf import _ivf_search

    ivf = IVFIndex(IVFConfig(n_lists=64, n_probe=8, kmeans_iters=5)).build(
        corpus, dtype=jnp.float32, quant=True)
    assert ivf.emb_ivf_q8 is not None
    assert ivf.cluster_scales.shape == (ivf.n_lists,)
    rng = np.random.default_rng(9)
    q = np.asarray(l2_normalize(
        rng.standard_normal((4, 48)).astype(np.float32)))
    # int8 scan without rescore (a quant-only layout's search).
    qv, qi = _ivf_search(jnp.asarray(q), ivf.centroids, ivf.emb_ivf_q8,
                         ivf.row_table, ivf.row_ids, k=10,
                         nprobe=ivf.n_lists, c_max=ivf.c_max,
                         cluster_scales=ivf.cluster_scales)
    # Full probe == exhaustive: int8 ranking must recover >= 0.9 of the
    # exact top-10, and surviving scores must be near the exact cosines.
    _, ei = exact(corpus, jnp.asarray(q), 10)
    ei = np.asarray(ei)
    qi = np.asarray(qi)
    hits = sum(len(set(qi[i].tolist()) & set(ei[i].tolist()))
               for i in range(4))
    assert hits / 40 >= 0.9, hits / 40
    emb = np.asarray(l2_normalize(corpus))
    exact_scores = np.take_along_axis(q @ emb.T, qi, axis=1)
    np.testing.assert_allclose(np.asarray(qv), exact_scores, atol=0.03)


def test_quant_save_load(corpus, tmp_path):
    ivf = IVFIndex(IVFConfig(n_lists=32, kmeans_iters=3)).build(
        corpus, dtype=jnp.float32, quant=True)
    ivf.save(tmp_path / "q")
    ivf2 = IVFIndex.load(tmp_path / "q", dtype=jnp.float32)
    assert ivf2.emb_ivf_q8 is not None
    np.testing.assert_array_equal(np.asarray(ivf.emb_ivf_q8),
                                  np.asarray(ivf2.emb_ivf_q8))
    np.testing.assert_allclose(np.asarray(ivf.cluster_scales),
                               np.asarray(ivf2.cluster_scales))


def test_quant_scan_with_rescore_matches_float(corpus):
    ivf = IVFIndex(IVFConfig(n_lists=64, n_probe=8, kmeans_iters=5)).build(
        corpus, dtype=jnp.float32, quant=True)
    rng = np.random.default_rng(11)
    q = np.asarray(l2_normalize(
        rng.standard_normal((4, 48)).astype(np.float32)))
    # A quant build's search scans int8 and rescores against emb_ivf.
    qv, qi = ivf.search(jnp.asarray(q), k=10, nprobe=ivf.n_lists)
    _, ei = exact(corpus, jnp.asarray(q), 10)
    ei, qi = np.asarray(ei), np.asarray(qi)
    hits = sum(len(set(qi[i].tolist()) & set(ei[i].tolist()))
               for i in range(4))
    assert hits / 40 >= 0.975, hits / 40
    # Rescored scores are exact (fp32 storage here).
    emb = np.asarray(l2_normalize(corpus))
    exp = np.take_along_axis(q @ emb.T, qi, axis=1)
    np.testing.assert_allclose(np.asarray(qv), exp, atol=1e-4)


def test_int8_scan_matches_dequantized_numpy(corpus):
    """The int8 probe scan (no rescore) ranks exactly as a NumPy scan of
    the dequantized rows against the row-quantized query does."""
    from tpurag.index.ivf import _ivf_search
    from tpurag.kernels.quant import quantize_rows

    ivf = IVFIndex(IVFConfig(n_lists=32, n_probe=8, kmeans_iters=3)).build(
        corpus, dtype=jnp.float32, quant=True)
    rng = np.random.default_rng(13)
    q = np.asarray(l2_normalize(
        rng.standard_normal((5, 48)).astype(np.float32)))
    v, i = _ivf_search(jnp.asarray(q), ivf.centroids, ivf.emb_ivf_q8,
                       ivf.row_table, ivf.row_ids, k=10, nprobe=6,
                       c_max=ivf.c_max, cluster_scales=ivf.cluster_scales)
    q8, qs = (np.asarray(x) for x in quantize_rows(jnp.asarray(q)))
    e8 = np.asarray(ivf.emb_ivf_q8)
    table = np.asarray(ivf.row_table)
    # Probes are chosen with the float query, rows scored in int8.
    cs = q @ np.asarray(ivf.centroids).T
    ev2, ei2 = [], []
    for b in range(5):
        probe = np.argsort(-cs[b], kind="stable")[:6]
        rows = np.concatenate([table[c][table[c] >= 0] for c in probe])
        cl = np.concatenate([np.full((table[c] >= 0).sum(), c)
                             for c in probe])
        sc = (e8[rows].astype(np.float64) @ q8[b].astype(np.float64)
              * np.asarray(ivf.cluster_scales, np.float64)[cl] * qs[b])
        order = np.lexsort((rows, -sc))[:10]
        ev2.append(sc[order])
        ei2.append(np.asarray(ivf.row_ids)[rows[order]])
    np.testing.assert_array_equal(np.asarray(i), np.stack(ei2))
    np.testing.assert_allclose(np.asarray(v), np.stack(ev2), rtol=1e-5)


def test_split_oversized_caps_cmax_and_keeps_recall():
    """A heavily skewed corpus (one blob holding half the rows) must
    build with c_max capped near factor x mean (index/ivf.py:
    split_oversized) and still pass the recall gate: part centroids
    rank adjacently, so recall at equal rows-scanned is preserved."""
    rng = np.random.default_rng(23)
    big = rng.standard_normal((1, 48)).astype(np.float32) * 3 \
        + 0.3 * rng.standard_normal((2048, 48)).astype(np.float32)
    rest = np.concatenate([
        c + rng.standard_normal((64, 48)).astype(np.float32)
        for c in rng.standard_normal((32, 48)).astype(np.float32) * 3])
    data = np.concatenate([big, rest])
    rng.shuffle(data)
    cfg = IVFConfig(n_lists=32, n_probe=8, kmeans_iters=5,
                    max_cluster_factor=2.0)
    ivf = IVFIndex(cfg).build(data, dtype=jnp.float32)
    mean = len(data) / ivf.n_lists
    assert ivf.c_max <= 2.0 * mean + 16, (ivf.c_max, mean)
    assert ivf.n_lists > 32  # the blob split into extra lists
    q = np.asarray(l2_normalize(
        data[rng.choice(len(data), 16, replace=False)]
        + 0.05 * rng.standard_normal((16, 48)).astype(np.float32)))
    _, ei = exact(data, jnp.asarray(q), 10)
    np_tuned = ivf.tune_nprobe(jnp.asarray(q), ei, k=10,
                               target_recall=0.95)
    _, ids = ivf.search(jnp.asarray(q), k=10, nprobe=np_tuned)
    got, ei = np.asarray(ids), np.asarray(ei)
    recall = np.mean([len(set(got[i]) & set(ei[i])) / 10
                      for i in range(16)])
    assert recall >= 0.95, recall


@pytest.fixture(scope="module")
def big_ivf():
    """Few large clusters (mean 512 rows): the shape of a production
    build, where one probe gathers hundreds of rows."""
    rng = np.random.default_rng(31)
    centers = rng.standard_normal((8, 48)).astype(np.float32) * 3
    data = np.concatenate([
        centers[i] + rng.standard_normal((512, 48)).astype(np.float32)
        for i in range(8)])
    rng.shuffle(data)
    ivf = IVFIndex(IVFConfig(n_lists=8, n_probe=4, kmeans_iters=4)).build(
        data, dtype=jnp.float32)
    return data, ivf


def test_pack_layout_lists_every_row_once():
    from tpurag.index.ivf import pack_layout

    assign = np.array([2, 0, 2, 1, 0, 2, 2], np.int32)
    counts = np.bincount(assign, minlength=4)          # cluster 3 empty
    order, table, c_max = pack_layout(assign, counts)
    assert c_max == 8 and table.shape == (4, 8)
    np.testing.assert_array_equal(assign[order], np.sort(assign))
    live = table[table >= 0]
    np.testing.assert_array_equal(np.sort(live), np.arange(7))
    for c in range(4):
        rows = table[c][table[c] >= 0]
        assert (assign[order[rows]] == c).all() and len(rows) == counts[c]
    assert (table[3] == -1).all()


def test_full_probe_equals_exact_large_clusters(big_ivf):
    data, ivf = big_ivf
    rng = np.random.default_rng(37)
    q = jnp.asarray(np.asarray(l2_normalize(
        rng.standard_normal((4, 48)).astype(np.float32))))
    v, i = ivf.search(q, k=10, nprobe=ivf.n_lists)
    ev, ei = exact(data, q, 10)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ei))
    np.testing.assert_allclose(np.asarray(v), np.asarray(ev), atol=1e-5)


def test_quant_full_probe_with_rescore_equals_exact(big_ivf):
    data, _ = big_ivf
    ivf = IVFIndex(IVFConfig(n_lists=8, n_probe=4, kmeans_iters=4)).build(
        data, dtype=jnp.float32, quant=True)
    rng = np.random.default_rng(41)
    q = jnp.asarray(np.asarray(l2_normalize(
        rng.standard_normal((4, 48)).astype(np.float32))))
    v, i = ivf.search(q, k=10, nprobe=ivf.n_lists)
    ev, ei = exact(data, q, 10)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ei))
    np.testing.assert_allclose(np.asarray(v), np.asarray(ev), atol=1e-5)


def test_quant_only_streaming_layout_searches_int8(big_ivf):
    """keep_rescore=False keeps ONLY the int8 layout on the device:
    search scans it directly (no float copy is made) at recall >= 0.9."""
    data, _ = big_ivf
    ivf = IVFIndex(IVFConfig(n_lists=8, n_probe=8, kmeans_iters=3)
                   ).build_streaming(lambda lo, hi: data[lo:hi], len(data),
                                     dtype=jnp.float32, quant=True,
                                     block=1024, keep_rescore=False)
    assert ivf.emb_ivf is None and ivf.emb_ivf_q8.dtype == jnp.int8
    rng = np.random.default_rng(43)
    q = jnp.asarray(np.asarray(l2_normalize(
        rng.standard_normal((8, 48)).astype(np.float32))))
    _, i = ivf.search(q, k=10, nprobe=ivf.n_lists)
    _, ei = exact(data, q, 10)
    i, ei = np.asarray(i), np.asarray(ei)
    recall = np.mean([len(set(i[r]) & set(ei[r])) / 10 for r in range(8)])
    assert recall >= 0.9, recall
    assert not any(np.asarray(x).dtype == np.float32
                   and np.asarray(x).shape[0] == len(data) + 1
                   for x in vars(ivf).values() if hasattr(x, "shape"))


def test_quant_scan_working_set_stays_below_a_float_copy(corpus):
    """The compiled int8 search holds a working set bounded by
    B x Cmax rows per probe: its temporaries stay well under the f32
    copy of the layout that a whole-corpus dequantize would need."""
    from tpurag.index.ivf import _ivf_search

    ivf = IVFIndex(IVFConfig(n_lists=64, n_probe=4, kmeans_iters=3)).build(
        corpus, dtype=jnp.float32, quant=True)
    q = jnp.asarray(np.asarray(l2_normalize(corpus[:2])))
    compiled = _ivf_search.lower(
        q, ivf.centroids, ivf.emb_ivf_q8, ivf.row_table, ivf.row_ids, k=10,
        nprobe=4, c_max=ivf.c_max, cluster_scales=ivf.cluster_scales
    ).compile()
    temp = compiled.memory_analysis().temp_size_in_bytes
    f32_copy = ivf.emb_ivf_q8.size * 4
    assert temp < f32_copy / 4, (temp, f32_copy)


def test_legacy_aligned_save_loads(big_ivf, tmp_path):
    """Saves whose clusters start on aligned rows (padding rows between
    clusters, cluster_starts/cluster_counts arrays, align in meta) load
    and search exactly: row_table lists only live rows."""
    import json

    data, ivf = big_ivf
    table = np.asarray(ivf.row_table)
    emb = np.asarray(ivf.emb_ivf)
    row_ids = np.asarray(ivf.row_ids)
    align, pos = 128, 0
    new_table = np.full_like(table, -1)
    starts, counts = [], []
    rows_out, ids_out = [], []
    for c in range(ivf.n_lists):
        live = table[c][table[c] >= 0]
        m = len(live)
        starts.append(pos)
        counts.append(m)
        new_table[c, :m] = np.arange(pos, pos + m)
        pad = -m % align
        rows_out += [emb[live], np.zeros((pad, emb.shape[1]), np.float32)]
        ids_out += [row_ids[live], np.full(pad, -1, np.int32)]
        pos += m + pad
    np.savez(tmp_path / "old", centroids=np.asarray(ivf.centroids),
             emb=np.concatenate(rows_out), row_table=new_table,
             row_ids=np.concatenate(ids_out).astype(np.int32),
             cluster_starts=np.asarray(starts, np.int32),
             cluster_counts=np.asarray(counts, np.int32),
             meta=json.dumps({"n": ivf.n, "c_max": ivf.c_max,
                              "n_lists": ivf.n_lists, "align": align,
                              "emb_dtype": "float32", "quant": False}))
    old = IVFIndex.load(tmp_path / "old", dtype=jnp.float32)
    q = jnp.asarray(np.asarray(l2_normalize(data[:3])))
    np.testing.assert_array_equal(
        np.asarray(old.search(q, k=10, nprobe=ivf.n_lists)[1]),
        np.asarray(ivf.search(q, k=10, nprobe=ivf.n_lists)[1]))


def test_save_load_bf16_storage_dtype(corpus, tmp_path):
    """bf16 partitions persist as uint16-viewed bytes (half the disk /
    upload) and reload bit-exact; legacy f32 saves still load."""
    ivf = IVFIndex(IVFConfig(n_lists=32, kmeans_iters=3)).build(
        corpus, dtype=jnp.bfloat16)
    ivf.save(tmp_path / "b")
    z = np.load(tmp_path / "b.npz")
    assert z["emb"].dtype == np.uint16  # storage bytes, not f32
    ivf2 = IVFIndex.load(tmp_path / "b", dtype=jnp.bfloat16)
    assert ivf2.emb_ivf.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(ivf.emb_ivf).view(np.uint16),
        np.asarray(ivf2.emb_ivf).view(np.uint16))
    rng = np.random.default_rng(5)
    q = jnp.asarray(np.asarray(l2_normalize(
        rng.standard_normal((2, 48)).astype(np.float32))))
    s1, i1 = ivf.search(q, k=5, nprobe=8)
    s2, i2 = ivf2.search(q, k=5, nprobe=8)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2))


def test_kb_ivf_auto_refresh_on_sustained_ingest(rng):
    """Round-4 verdict item 5: sustained ingest past the tail-growth
    bound must trigger a background IVF rebuild (single-flight), so
    mode='ivf' latency stays bounded instead of degrading toward the
    exact tail scan. The partition snapshot advances and new docs are
    served from the partition, not the tail."""
    from tpurag import KnowledgeBase
    from tpurag.core.config import EngineConfig, IVFConfig

    cfg = EngineConfig(ivf=IVFConfig(
        n_lists=8, n_probe=8, kmeans_iters=2,
        auto_refresh_ratio=0.25, auto_refresh_min_rows=8))
    kb = KnowledgeBase("ivf-refresh", config=cfg)
    for i in range(40):
        kb.add_document(f"doc{i}", f"document number {i} about topic "
                                   f"{['ships', 'birds', 'rocks'][i % 3]} "
                                   * 4)
    kb.build_ivf()
    built0 = kb._ivf_built_at
    # Stream enough docs to exceed 25% tail growth (+ the 8-row floor).
    for i in range(40, 80):
        kb.add_document(f"doc{i}", f"later document {i} about "
                                   f"{['gears', 'levers'][i % 2]} " * 4)
    kb.wait_ivf_refresh()
    assert kb._ivf_built_at > built0, "background rebuild never swapped in"
    assert kb.dense.n_active - kb._ivf_built_at \
        < max(8, 0.25 * kb._ivf_built_at) + 40  # tail bounded again
    r = kb.search("later document about gears", mode="ivf", top_k=3)
    assert r.results and any("gears" in x.text for x in r.results)


def test_kb_ivf_auto_refresh_disabled(rng):
    from tpurag import KnowledgeBase
    from tpurag.core.config import EngineConfig, IVFConfig

    cfg = EngineConfig(ivf=IVFConfig(
        n_lists=8, n_probe=8, kmeans_iters=2, auto_refresh_ratio=None))
    kb = KnowledgeBase("ivf-norefresh", config=cfg)
    for i in range(30):
        kb.add_document(f"doc{i}", f"document {i} about ships " * 4)
    kb.build_ivf()
    built0 = kb._ivf_built_at
    for i in range(30, 90):
        kb.add_document(f"doc{i}", f"later document {i} levers " * 4)
    kb.wait_ivf_refresh()
    assert kb._ivf_built_at == built0  # policy off: tail only
    r = kb.search("later levers document", mode="ivf", top_k=3)
    assert r.results  # still served via the exact tail scan


def test_nprobe_dyn_mask_matches_static(big_ivf):
    """Shared-shape tuning: a search compiled at a static nprobe cap
    that stops after a runtime nprobe_dyn probes returns exactly what a
    static nprobe-point search returns."""
    _assert_nprobe_dyn_matches_static(big_ivf[1])


def test_nprobe_dyn_mask_matches_static_quant(big_ivf):
    """The same on the int8 layout (int8 scan + exact rescore)."""
    ivf = IVFIndex(IVFConfig(n_lists=8, n_probe=4, kmeans_iters=4)
                   ).build(big_ivf[0], dtype=jnp.float32, quant=True)
    _assert_nprobe_dyn_matches_static(ivf)


def _assert_nprobe_dyn_matches_static(ivf):
    rng = np.random.default_rng(41)
    q = jnp.asarray(np.asarray(l2_normalize(
        rng.standard_normal((4, 48)).astype(np.float32))))
    for np_small in (1, 2, 4):
        sv, si = ivf.search(q, k=10, nprobe=np_small)
        dv, di = ivf.search(q, k=10, nprobe=ivf.n_lists,
                            nprobe_dyn=np.int32(np_small))
        np.testing.assert_array_equal(np.asarray(di), np.asarray(si))
        np.testing.assert_allclose(np.asarray(dv), np.asarray(sv),
                                   atol=1e-5)


def test_tune_nprobe_shared_shape_matches_per_point(big_ivf):
    """tune_nprobe(shared_shape=...) must pick the same minimal nprobe
    either way."""
    data, ivf = big_ivf
    rng = np.random.default_rng(43)
    q = np.asarray(l2_normalize(
        rng.standard_normal((16, 48)).astype(np.float32)))
    _, ei = exact(data, jnp.asarray(q), 10)
    a = ivf.tune_nprobe(jnp.asarray(q), ei, k=10, shared_shape=False)
    b = ivf.tune_nprobe(jnp.asarray(q), ei, k=10, shared_shape=True)
    assert a == b
