"""Command-line interface.

The reference's surface is a web UI + 24 REST routes (SURVEY.md §2.9-2.10);
the framework's equivalent surface is this CLI plus the HTTP shim.

  python -m tpurag ingest  DIR_OR_FILES --kb PATH
  python -m tpurag search  "query" --kb PATH [--mode hybrid|vector|keyword|graph]
  python -m tpurag chat    --kb PATH            (agent REPL, offline mode)
  python -m tpurag eval    --kb PATH [-n N]
  python -m tpurag bench   [--config NAME]
  python -m tpurag serve   --kb PATH [--port 8080]
  python -m tpurag graph   --kb PATH            (build entity graph)
  python -m tpurag stats   --kb PATH
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def _load_kb(path: str, create: bool = False, store: str | None = None,
             backing: str | None = None):
    from tpurag import KnowledgeBase

    p = pathlib.Path(path)
    if (p / "kb.json").exists():
        return KnowledgeBase.load(p, store=store, backing=backing)
    if create:
        return KnowledgeBase(p.name or "kb")
    sys.exit(f"no knowledge base at {path} (run `ingest` first)")


def _load_graph(kb, path: str):
    from tpurag.graph.index import GraphIndex

    g = GraphIndex(kb.embedder)
    g.ingest_chunks([(cid, c.text) for cid, c in enumerate(kb.chunks)
                     if not c.metadata.get("deleted")])
    return g


def cmd_ingest(args):
    from tpurag.ingest.documents import DOC_SUFFIXES, load_document
    from tpurag.ingest.pipeline import ingest_documents

    embedder = None
    if getattr(args, "hf_encoder", None):
        from tpurag.models.encoder import EncoderEmbedder

        embedder = EncoderEmbedder.from_hf(args.hf_encoder)
    elif getattr(args, "encoder_ckpt", None):
        from tpurag.models.encoder import EncoderEmbedder

        embedder = EncoderEmbedder.load(args.encoder_ckpt)
    elif getattr(args, "encoder", False):
        from tpurag.models.encoder import EncoderEmbedder

        embedder = EncoderEmbedder()  # random-init on-chip encoder
    quant = bool(getattr(args, "quant", False))
    store = getattr(args, "store", "device") or "device"
    backing = getattr(args, "backing", None)
    head_m = int(getattr(args, "bm25_head", 0) or 0)
    config = None
    if head_m:
        import dataclasses

        from tpurag.core.config import EngineConfig

        base = EngineConfig()
        config = dataclasses.replace(
            base, bm25=dataclasses.replace(base.bm25, head_m=head_m))
    if (embedder is not None or quant or store != "device" or config) \
            and not pathlib.Path(args.kb, "kb.json").exists():
        from tpurag import KnowledgeBase

        kb = KnowledgeBase(pathlib.Path(args.kb).name or "kb",
                           embedder=embedder, quant=quant, config=config,
                           store=store, backing=backing)
    else:
        # store/backing are honored on reload (KnowledgeBase.load
        # overrides); the persisted embedder always wins.
        kb = _load_kb(args.kb, create=True,
                      store=(store if store != "device" else None),
                      backing=backing)
        if quant and not getattr(kb, "quant", False):
            print("warning: --quant ignored — KB at %s already exists "
                  "without quantization (rebuild the KB to enable it)"
                  % args.kb, file=sys.stderr)
        if head_m and kb.config.bm25.head_m != head_m:
            print("warning: --bm25-head ignored — KB at %s already "
                  "exists with head_m=%d (its persisted scoring config "
                  "wins; rebuild to change it)"
                  % (args.kb, kb.config.bm25.head_m), file=sys.stderr)
        if embedder is not None:
            print("warning: --encoder/--hf-encoder ignored — KB at %s "
                  "already exists; its persisted embedder defines the "
                  "vector space" % args.kb, file=sys.stderr)
    docs = []
    for src in args.paths:
        p = pathlib.Path(src)
        if p.is_dir():
            for f in sorted(p.rglob("*")):
                if f.suffix.lower() in DOC_SUFFIXES and f.is_file():
                    docs.append(load_document(f))
        elif p.is_file():
            docs.append(load_document(p))
    if getattr(args, "train_tokenizer", 0) and hasattr(kb.embedder,
                                                       "tokenizer"):
        from tpurag.ingest.subword import SubwordTokenizer

        kb.embedder.tokenizer = SubwordTokenizer.train(
            (t for _, t in docs), vocab_size=args.train_tokenizer)
    if args.code:
        from tpurag.code import create_code_chunks, walk_code_files

        for src in args.paths:
            kb.add_chunks(create_code_chunks(walk_code_files(src)))
        stats = {"docs": 0, "chunks": len(kb), "seconds": 0}
    else:
        stats = ingest_documents(kb, docs)
    kb.save(args.kb)
    print(json.dumps({"ingested": stats, "total_chunks": len(kb)}))


def cmd_search(args):
    kb = _load_kb(args.kb)
    if args.mode == "graph":
        g = _load_graph(kb, args.kb)
        hits = g.search_chunks(args.query, k=args.top_k)
        for cid, score in hits:
            c = kb.chunks[cid]
            print(f"[{c.doc_name}#{c.chunk_index}] score={score:.3f}")
            print(c.text[:300])
    else:
        if args.mode in ("ivf", "hybrid_ivf") and kb._ivf is None:
            # persisted IVF wins; build on the fly otherwise
            kb.build_ivf()
        resp = kb.search(args.query, top_k=args.top_k, mode=args.mode)
        print(resp.format(args.top_k))
        print(f"\n-- {resp.stats}")


def cmd_build_ivf(args):
    """Snapshot the dense corpus into the IVF partition and persist it
    (the low-latency serving mode; streaming build, bounded host
    memory)."""
    kb = _load_kb(args.kb)
    ivf = kb.build_ivf(seed=args.seed)
    kb.save(args.kb)
    print(json.dumps({
        "n": ivf.n, "n_lists": ivf.n_lists,
        "quant": getattr(ivf, "emb_ivf_q8", None) is not None,
        "fp_rescore": getattr(ivf, "emb_ivf", None) is not None,
    }))


def cmd_chat(args):
    from tpurag.agent.react import Agent
    from tpurag.memory.service import MemoryService

    kb = _load_kb(args.kb)
    mem = MemoryService(kb)
    agent = Agent(kb, memory=mem)
    history: list[dict] = []
    print("tpurag chat (offline deterministic mode; ctrl-d to exit)")
    while True:
        try:
            q = input("you> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not q:
            continue
        res = agent.query(q, history=history)
        print(f"rag> {res.answer}\n")
        history += [{"role": "user", "content": q},
                    {"role": "assistant", "content": res.answer}]


def cmd_eval(args):
    from tpurag.agent.react import Agent
    from tpurag.eval.service import EvalService

    kb = _load_kb(args.kb)
    agent = Agent(kb)
    run = EvalService(agent).run(
        n=args.n, on_progress=lambda r: print(
            f"  {r.progress}/{r.total}", file=sys.stderr))
    print(json.dumps({"status": run.status, "averages": run.averages,
                      "questions": [r.question.question for r in run.results]},
                     ensure_ascii=False, indent=2))


def cmd_bench(args):
    from tpurag.eval.bench import CONFIGS, run_all
    from tpurag.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    names = [args.config] if args.config else None
    for out in run_all(names):
        print(json.dumps(out))


def cmd_serve(args):
    from tpurag.agent.react import Agent
    from tpurag.api.code_routes import CodebaseManager
    from tpurag.api.server import RagServer

    kb = _load_kb(args.kb)
    agent = Agent(kb)
    server = RagServer(kb, agent=agent,
                       data_dir=args.data_dir or args.kb,
                       codebases=CodebaseManager(dim=kb.dim))
    print(f"serving on http://{args.host}:{args.port}", file=sys.stderr)
    server.serve(args.host, args.port)


def cmd_codechat(args):
    """Composed code chat over a repository (chat/route.ts:8-373)."""
    from tpurag.api.code_routes import CodebaseManager

    mgr = CodebaseManager()
    cb = mgr.register(args.repo)
    mgr.process(cb, progress=lambda pct, step: print(
        f"  [{pct:3d}%] {step}", file=sys.stderr))
    res = mgr.chat(cb.cb_id, args.question)
    print(res.answer)
    if res.sources:
        print("\n-- sources --")
        for s in res.sources:
            loc = f"{s['filePath']}:{s.get('startLine', '?')}"
            print(f"  [{s['type']}] {s['name']} @ {loc}")


def cmd_graph(args):
    kb = _load_kb(args.kb)
    g = _load_graph(kb, args.kb)
    print(json.dumps(g.export_graph(limit=args.limit), ensure_ascii=False))


def cmd_stats(args):
    kb = _load_kb(args.kb)
    print(json.dumps({
        "chunks": len(kb),
        "docs": len(kb._doc_chunks),
        "dim": kb.dim,
        "capacity": kb.dense.capacity,
        "vocab": len(kb.inverted.vocab),
    }))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpurag")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("ingest", help="index documents into a KB")
    p.add_argument("paths", nargs="+")
    p.add_argument("--kb", required=True)
    p.add_argument("--code", action="store_true",
                   help="treat paths as code repositories")
    p.add_argument("--encoder", action="store_true",
                   help="embed with the on-chip transformer encoder "
                        "(persisted with the KB)")
    p.add_argument("--encoder-ckpt", default=None,
                   help="npz encoder checkpoint to embed with")
    p.add_argument("--train-tokenizer", type=int, default=0, metavar="V",
                   help="train a BPE tokenizer (vocab size V) on the "
                        "ingested docs for the encoder")
    p.add_argument("--store", choices=("device", "host"), default="device",
                   help="corpus storage tier: HBM (default) or host "
                        "RAM/disk — for corpora larger than device memory")
    p.add_argument("--backing", default=None, metavar="PATH",
                   help="with --store host: disk-backed memmap path "
                        "(the raw corpus never has to fit host RAM)")
    p.add_argument("--hf-encoder", default=None, metavar="DIR",
                   help="embed with a local BERT-family HF checkpoint "
                        "(models/import_hf.py; torch-verified numerics)")
    p.add_argument("--bm25-head", type=int, default=0, metavar="M",
                   help="impact-ordered BM25 pruning: terms with df>M "
                        "keep only their top-M-impact postings "
                        "(recommended 2048 past ~512k docs; 0 = exact; "
                        "persists with the KB)")
    p.add_argument("--quant", action="store_true",
                   help="int8-sidecar dense scans with exact rescoring "
                        "(new KBs only; persisted in kb.json)")
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser("build-ivf", help="snapshot the corpus into the "
                       "IVF partition (streaming, bounded host memory)")
    p.add_argument("--kb", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_build_ivf)

    p = sub.add_parser("search")
    p.add_argument("query")
    p.add_argument("--kb", required=True)
    p.add_argument("--mode", default="hybrid",
                   choices=["hybrid", "vector", "keyword", "graph", "ivf",
                            "hybrid_ivf"])
    p.add_argument("--top-k", type=int, default=5)
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("chat")
    p.add_argument("--kb", required=True)
    p.set_defaults(fn=cmd_chat)

    p = sub.add_parser("eval")
    p.add_argument("--kb", required=True)
    p.add_argument("-n", type=int, default=5)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("bench")
    p.add_argument("--config", default=None)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("serve")
    p.add_argument("--kb", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--data-dir", default=None,
                   help="directory /save targets are confined to "
                        "(default: the KB directory)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("codechat", help="one-shot code chat over a repo")
    p.add_argument("question")
    p.add_argument("--repo", required=True)
    p.set_defaults(fn=cmd_codechat)

    p = sub.add_parser("graph")
    p.add_argument("--kb", required=True)
    p.add_argument("--limit", type=int, default=100)
    p.set_defaults(fn=cmd_graph)

    p = sub.add_parser("stats")
    p.add_argument("--kb", required=True)
    p.set_defaults(fn=cmd_stats)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
