"""chip_smoke.py: its NumPy references, its checks, and its refusal to run
without a GPU (the GPU run itself is `python chip_smoke.py` on a card)."""

import importlib.util
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from tpurag.kernels.bm25 import bm25_topk
from tpurag.kernels.fusion import rrf_fuse

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
sys.modules["chip_smoke"] = cs        # dataclasses look their module up
_spec.loader.exec_module(cs)


def brute_topk(q, corpus, k):
    s = np.asarray(q, np.float64) @ np.asarray(corpus, np.float64).T
    order = np.lexsort((np.broadcast_to(np.arange(s.shape[1]), s.shape),
                        -s), axis=1)[:, :k]
    return np.take_along_axis(s, order, axis=1), order


@pytest.mark.parametrize("n,k,block", [(300, 8, 64), (257, 10, 1000),
                                       (40, 5, 7)])
def test_np_dense_topk_matches_brute_force(rng, n, k, block):
    q = rng.standard_normal((6, 16)).astype(np.float32)
    corpus = rng.standard_normal((n + 5, 16)).astype(np.float32)
    v, i = cs.np_dense_topk(q, corpus, n, k, block=block)
    ev, ei = brute_topk(q, corpus[:n], k)
    np.testing.assert_allclose(v, ev, rtol=1e-12)
    np.testing.assert_array_equal(i, ei)


def test_topk_rows_breaks_ties_by_smaller_id():
    s = np.array([[1.0, 2.0, 2.0, 0.5]])
    ids = np.array([[7, 9, 3, 1]])
    v, i = cs.topk_rows(s, ids, 3)
    assert i.tolist() == [[3, 9, 7]] and v.tolist() == [[2.0, 2.0, 1.0]]


def test_bf16_round_and_normalize():
    x = np.array([[3.0, 4.0], [0.0, 0.0]], np.float32)
    n = cs.normalize_f32(x)
    np.testing.assert_allclose(n[0], [0.6, 0.8], rtol=1e-7)
    assert (n[1] == 0).all()
    r = cs.bf16_round(np.array([1.0 + 2 ** -10], np.float32))
    assert r[0] == 1.0          # below bf16's 8-bit mantissa


def _postings_fixture(rng, n=60, vocab=40):
    tok, lens = cs.zipf_tokens(rng, n, vocab, mean_len=12)
    return tok, lens, cs.Postings.build(tok, lens, vocab)


def test_postings_build_counts_every_token(rng):
    tok, lens, post = _postings_fixture(rng)
    assert post.tf.sum() == len(tok)
    assert post.start[-1] == len(post.doc)
    docs = np.repeat(np.arange(post.n), lens)
    for t in range(5):
        d = post.doc[post.start[t]:post.start[t + 1]]
        assert (np.diff(d) > 0).all()
        assert set(d.tolist()) == set(docs[tok == t].tolist())


def test_np_bm25_matches_the_scatter_oracle(rng):
    """The reference BM25 against kernels/bm25.py's scatter form fed the
    same impacts (tf (k1+1) / (tf + k1 (1 - b + b dl/avgdl)))."""
    tok, lens, post = _postings_fixture(rng)
    k1, b = 1.2, 0.75
    avgdl = post.dl.sum() / post.n
    imp = post.tf * (k1 + 1) / (post.tf + k1 * (1 - b + b * post.dl[post.doc]
                                                / avgdl))
    queries = [[1, 2, 5], [0], [7, 30, 39]]
    rv, ri = cs.np_bm25_topk(post, queries, 6, k1=k1, b=b)
    t = 3
    starts = np.zeros((len(queries), t), np.int32)
    lens_q = np.zeros((len(queries), t), np.int32)
    idf = np.zeros((len(queries), t), np.float32)
    for qi, terms in enumerate(queries):
        for j, term in enumerate(terms):
            starts[qi, j] = post.start[term]
            lens_q[qi, j] = post.df(term)
            idf[qi, j] = post.idf(term)
    p_max = int(max(post.df(x) for ts in queries for x in ts))
    pad = np.zeros(p_max, np.int64)
    v, i = bm25_topk(jnp.asarray(starts), jnp.asarray(lens_q),
                     jnp.asarray(idf),
                     jnp.asarray(np.r_[post.doc, pad].astype(np.int32)),
                     jnp.asarray(np.r_[imp, pad].astype(np.float32)),
                     jnp.zeros(post.n), jnp.int32(post.n), k=6, p_max=p_max)
    msg = cs.check_topk("bm25", np.asarray(v), np.asarray(i), rv, ri,
                        rtol=1e-5)
    assert "ranks equal" in msg


def test_np_rrf_matches_the_fusion_kernel(rng):
    legs = (rng.integers(0, 12, (5, 6)).astype(np.int32),
            rng.integers(0, 12, (5, 4)).astype(np.int32))
    legs = tuple(np.stack([_distinct(r) for r in leg]) for leg in legs)
    legs[1][2] = -1                       # an empty keyword leg
    w, rrf_k, bonus = (1.0, 0.7), 60, 0.1
    fv, fi = cs.np_rrf(legs, w, rrf_k, bonus, 6)
    dv, di, _ = rrf_fuse(tuple(jnp.asarray(x) for x in legs), weights=w,
                         final_k=6, rrf_k=rrf_k, both_bonus=bonus)
    dv, di = np.asarray(dv), np.asarray(di)
    for q in range(5):
        n = len(fi[q])
        assert di[q, :n].tolist() == fi[q]
        np.testing.assert_allclose(dv[q, :n], fv[q], rtol=1e-6)


def _distinct(row):
    out, seen = [], set()
    for x in row.tolist():
        if x in seen:
            x = -1
        seen.add(x)
        out.append(x)
    return np.asarray(out, np.int32)


def test_check_topk_accepts_ties_and_rejects_swaps():
    ref_v = np.array([[0.9, 0.5, 0.5 - 1e-7, 0.1]])
    ref_i = np.array([[4, 2, 3, 8]])
    # Ids 2 and 3 sit within the tie gap: either order passes.
    cs.check_topk("t", ref_v, np.array([[4, 3, 2, 8]]), ref_v, ref_i,
                  atol=1e-5)
    with pytest.raises(AssertionError):
        cs.check_topk("t", ref_v, np.array([[8, 2, 3, 4]]), ref_v, ref_i,
                      atol=1e-5)
    with pytest.raises(AssertionError):
        cs.check_topk("t", ref_v + 1e-3, ref_i, ref_v, ref_i, atol=1e-5)


def test_doc_texts_round_trip(rng):
    tok, lens = cs.zipf_tokens(rng, 30, cs.VOCAB, mean_len=8)
    texts = cs.doc_texts(tok, lens)
    assert len(texts) == 30
    back = [int(w[1:]) for t in texts for w in t.split()]
    assert back == tok.tolist()


def test_refuses_to_run_without_a_gpu(capsys):
    rc = cs.main([])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
