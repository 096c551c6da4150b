"""Inverted-index ingest throughput: Python vs native pair-ABI vs native
grouped-ABI.

The reference outsources keyword ingest to the Meilisearch (Rust) server
in 500-doc batches (src/lib/meilisearch.ts:137-158); tpurag ingests
in-process. This bench isolates the host-side tokenize+index cost per
path (no device work — postings upload is lazy):

  python   per-doc add(): Python tokenizer + dict counting
  pairs    tr_batch_term_counts (v1 ABI): C++ tokenize+count, numpy
           argsort grouping on the Python side
  grouped  tr_batch_postings (v2 ABI): C++ tokenize+count+group — one C
           call, Python just maps vocab ids and bulk-extends

Usage: python benchmarks/ingest_bench.py [n_docs] [tokens_per_doc]
"""

from __future__ import annotations

import pathlib
import random
import string
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def make_docs(n: int, tokens: int, vocab_size: int = 20_000) -> list[str]:
    rng = random.Random(0)
    words = ["".join(rng.choices(string.ascii_lowercase,
                                 k=rng.randint(3, 9)))
             for _ in range(vocab_size)]
    # 5% CJK docs so the bigram path is exercised
    cjk = "向量检索和关键词检索的混合搜索每层都有延迟预算"
    docs = []
    for i in range(n):
        body = " ".join(rng.choices(words, k=tokens))
        if i % 20 == 0:
            body = cjk + " " + body
        docs.append(body)
    return docs


def bench(path: str, docs: list[str]) -> float:
    import jax

    jax.config.update("jax_platforms", "cpu")  # host-only: no device work
    from tpurag.index import inverted
    from tpurag.index.inverted import InvertedIndex

    idx = InvertedIndex()
    ids = list(range(len(docs)))
    t0 = time.perf_counter()
    if path == "python":
        for i, t in zip(ids, docs):
            idx.add(i, t)
    elif path == "pairs":
        native = inverted._native
        orig = native.postings_available
        native.postings_available = lambda: False
        try:
            idx.add_batch(ids, docs)
        finally:
            native.postings_available = orig
    else:
        idx.add_batch(ids, docs)
    dt = time.perf_counter() - t0
    assert idx.n_docs == len(docs)
    return dt


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
    tokens = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    docs = make_docs(n, tokens)

    from tpurag.native import loader

    paths = ["python"]
    if loader.batch_available():
        paths.append("pairs")
    if loader.postings_available():
        paths.append("grouped")

    print(f"ingest bench: {n} docs x ~{tokens} tokens")
    base = None
    for path in paths:
        # python per-doc add is slow; subsample it and scale
        sub = docs[: max(n // 10, 1000)] if path == "python" else docs
        dt = bench(path, sub)
        dps = len(sub) / dt
        if base is None:
            base = dps
        print(f"  {path:8s} {dps:10,.0f} docs/s   ({dt:.3f}s / {len(sub)}"
              f" docs)   {dps / base:.2f}x")


if __name__ == "__main__":
    main()
