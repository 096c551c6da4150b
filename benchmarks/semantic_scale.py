"""Semantic retrieval PAST toy scale.

No pretrained checkpoint exists in this zero-egress image (no HF cache,
no local safetensors), so the reference's externally-trained-embedding
leg (src/lib/llm/config.ts:31) is exercised the only honest way
available: train the on-chip encoder (models/train.py) well past the
test fixture's scale on a HARD synthetic corpus, then measure semantic
retrieval through the PRODUCT path (KnowledgeBase.search).

Why this fixture is hard (vs tests/test_semantic.py's 64-topic toy):
- Register shift: documents use formal English ("purchase, physician,
  automobile"), queries use casual synonyms ("buy, doctor, car") — the
  content words are DISJOINT, so lexical methods cannot rank on them.
- Partial lexical overlap on function words ("the", "about", "and"):
  the HashEmbedder baseline is not strawmanned to exact-zero cosine —
  it sees real, equally-distracting token collisions.
- Compositional relevance: a topic is a SET of 4 concepts; every topic
  ships 3 sibling distractor docs sharing 3 of its 4 concepts, so
  bag-of-one-word matching ranks siblings at the top.
- Held-out composition: eval queries come from topics whose 4-concept
  COMBINATION never appears in training (the synonym pairs themselves
  are trained — that is the word-level association a real embedding
  model learns from data; the composition is what must generalize).

Scale class: BPE-2048 subword vocab (ingest/subword.py), dim-256
4-layer 8-head encoder (~3.3M params), seq_len 32, 3000 InfoNCE steps
at batch 256 on the device — roughly 50x the toy fixture's training
compute, through the same train_contrastive entry the CLI uses.

Output: one JSON line per embedder config with recall@1/recall@10
through KnowledgeBase, plus a hybrid-mode row for the trained encoder.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# (formal document word, casual query word) — disjoint registers.
SYNONYMS = [
    ("purchase", "buy"), ("automobile", "car"), ("physician", "doctor"),
    ("residence", "home"), ("beverage", "drink"), ("infant", "baby"),
    ("canine", "dog"), ("feline", "cat"), ("currency", "money"),
    ("employment", "job"), ("attorney", "lawyer"), ("cinema", "movies"),
    ("photograph", "photo"), ("television", "tv"), ("telephone", "phone"),
    ("refrigerator", "fridge"), ("mathematics", "math"),
    ("examination", "test"), ("university", "college"),
    ("adolescent", "teen"), ("obstruction", "blockage"),
    ("precipitation", "rain"), ("velocity", "speed"),
    ("temperature", "heat"), ("illumination", "light"),
    ("nourishment", "food"), ("slumber", "sleep"), ("ailment", "sickness"),
    ("remedy", "cure"), ("vessel", "ship"), ("aviation", "flying"),
    ("locomotive", "train"), ("bicycle", "bike"), ("pedestrian", "walker"),
    ("intoxicated", "drunk"), ("fatigued", "tired"),
    ("courageous", "brave"), ("economical", "cheap"),
    ("expensive", "pricey"), ("enormous", "huge"), ("minuscule", "tiny"),
    ("rapid", "fast"), ("lethargic", "slow"), ("furious", "angry"),
    ("elated", "happy"), ("melancholy", "sad"), ("perspiration", "sweat"),
    ("respiration", "breathing"), ("cardiology", "hearts"),
    ("dentistry", "teeth"), ("optometry", "eyes"), ("dermatology", "skin"),
    ("horticulture", "gardening"), ("culinary", "cooking"),
    ("apparel", "clothes"), ("footwear", "shoes"),
    ("timepiece", "watch"), ("spectacles", "glasses"),
    ("umbrella", "brolly"), ("luggage", "bags"), ("passport", "papers"),
    ("itinerary", "plans"), ("accommodation", "lodging"),
    ("restaurant", "diner"), ("supermarket", "store"),
    ("pharmacy", "drugstore"), ("petroleum", "gas"),
    ("electricity", "power"), ("insulation", "padding"),
    ("foundation", "base"), ("renovation", "remodel"),
    ("mortgage", "loan"), ("insurance", "coverage"),
    ("taxation", "taxes"), ("legislation", "laws"),
    ("election", "vote"), ("negotiation", "talks"),
    ("agriculture", "farming"), ("irrigation", "watering"),
    ("fertilizer", "manure"), ("harvest", "crop"),
    ("livestock", "cattle"), ("poultry", "chickens"),
    ("apiary", "beehive"), ("vineyard", "grapes"),
    ("orchard", "fruit"), ("lumber", "wood"), ("quarry", "stone"),
    ("excavation", "digging"), ("demolition", "teardown"),
    ("construction", "building"), ("machinery", "equipment"),
    ("maintenance", "upkeep"), ("lubricant", "oil"),
    ("adhesive", "glue"), ("fastener", "screw"),
    ("carpentry", "woodwork"), ("plumbing", "pipes"),
    ("ventilation", "airflow"), ("combustion", "burning"),
    ("navigation", "steering"), ("communication", "messaging"),
    ("encryption", "scrambling"), ("computation", "calculating"),
    ("automation", "robots"), ("manufacture", "making"),
    ("distribution", "shipping"), ("inventory", "stock"),
    ("procurement", "sourcing"), ("advertisement", "ads"),
    ("subscription", "membership"), ("transaction", "payment"),
    ("withdrawal", "cashout"), ("deposit", "paying"),
    ("investment", "investing"), ("dividend", "payout"),
    ("inflation", "prices"), ("recession", "downturn"),
    ("unemployment", "jobless"), ("retirement", "pension"),
]

DOC_TEMPLATES = [
    "This document concerns {0}, with further material on {1}, "
    "{2} and {3}.",
    "An overview of {0} together with {1}; in addition, {2} and {3} "
    "are examined in detail.",
    "The report addresses {0} and {1}, followed by a discussion of "
    "{2} alongside {3}.",
    "Analysis of {0}: relation to {1}, implications for {2}, and the "
    "role of {3}.",
]

QUERY_TEMPLATES = [
    "stuff about {0} and {1} and also {2} {3}",
    "looking for info on {0} {1} with some {2} and {3}",
    "anything about {0} plus {1} plus {2} plus {3}",
    "need help with {0} and {1}, maybe {2} or {3}",
]


def topic_text(rng, concepts, formal: bool) -> str:
    words = [SYNONYMS[c][0 if formal else 1] for c in concepts]
    order = rng.permutation(4)
    tmpl = (DOC_TEMPLATES if formal else QUERY_TEMPLATES)[
        rng.integers(0, 4)]
    return tmpl.format(*[words[i] for i in order])


def make_topics(rng, n_topics: int):
    """Distinct 4-concept sets; later topics may share <=3 concepts."""
    seen, topics = set(), []
    while len(topics) < n_topics:
        c = tuple(sorted(rng.choice(len(SYNONYMS), 4, replace=False)))
        if c not in seen:
            seen.add(c)
            topics.append(c)
    return topics


def siblings_of(rng, topic, seen):
    """3 hard negatives sharing exactly 3 of the topic's 4 concepts."""
    out = []
    while len(out) < 3:
        keep = list(topic)
        drop = rng.integers(0, 4)
        repl = int(rng.integers(0, len(SYNONYMS)))
        if repl in topic:
            continue
        keep[drop] = repl
        c = tuple(sorted(keep))
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out


def evaluate(kb, rng, topics_eval, doc_name, k=10, mode="vector"):
    hits1 = hits10 = 0
    for t in topics_eval:
        q = topic_text(rng, t, formal=False)
        r = kb.search(q, top_k=k, mode=mode)
        names = [x.doc_name for x in r.results]
        if names and names[0] == doc_name[t]:
            hits1 += 1
        if doc_name[t] in names:
            hits10 += 1
    n = len(topics_eval)
    return hits1 / n, hits10 / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--topics", type=int, default=4000)
    ap.add_argument("--held-out", type=int, default=256)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--pairs-per-topic", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    print(f"backend={jax.default_backend()}", file=sys.stderr, flush=True)

    from tpurag import KnowledgeBase
    from tpurag.ingest.embedder import HashEmbedder
    from tpurag.ingest.subword import SubwordTokenizer
    from tpurag.models.encoder import EncoderConfig, EncoderEmbedder
    from tpurag.models.train import train_contrastive

    rng = np.random.default_rng(0)
    topics = make_topics(rng, args.topics)
    train_topics = topics[: -args.held_out]
    eval_topics = topics[-args.held_out:]

    # Corpus: 1 doc per topic + 3 sibling hard negatives per EVAL topic.
    seen = set(topics)
    docs = {}
    for i, t in enumerate(topics):
        docs[f"doc{i}"] = (t, topic_text(rng, t, formal=True))
    doc_name = {t: f"doc{i}" for i, t in enumerate(topics)}
    sib_id = len(topics)
    for t in eval_topics:
        for s in siblings_of(rng, t, seen):
            docs[f"doc{sib_id}"] = (s, topic_text(rng, s, formal=True))
            sib_id += 1
    print(f"corpus: {len(docs)} docs ({len(eval_topics)} eval topics "
          f"x 3 siblings)", file=sys.stderr, flush=True)

    # Training pairs: TRAIN topics only — eval compositions are unseen.
    pairs = []
    for t in train_topics:
        for _ in range(args.pairs_per_topic):
            pairs.append((topic_text(rng, t, formal=True),
                          topic_text(rng, t, formal=False)))
    rng.shuffle(pairs)

    tok = SubwordTokenizer.train(
        (txt for _, (_, txt) in docs.items()), vocab_size=2048)
    cfg = EncoderConfig(vocab_size=tok.vocab_size, dim=args.dim,
                        n_layers=args.layers, n_heads=8,
                        max_len=args.seq_len, out_dim=args.dim,
                        dtype="float32")

    t0 = time.perf_counter()
    params = train_contrastive(
        cfg, pairs, tokenizer=tok, steps=args.steps, batch=args.batch,
        seed=0, seq_len=args.seq_len,
        log=lambda m: print(m, file=sys.stderr, flush=True))
    train_s = time.perf_counter() - t0
    n_params = sum(int(np.prod(x.shape))
                   for x in jax.tree_util.tree_leaves(params))
    print(f"trained {n_params/1e6:.2f}M params in {train_s:.1f}s",
          file=sys.stderr, flush=True)

    erng = np.random.default_rng(1)
    results = []
    embedders = [
        ("hash", HashEmbedder(args.dim)),
        ("encoder-untrained", EncoderEmbedder(
            cfg, seed=7, seq_len=args.seq_len, tokenizer=tok)),
        ("encoder-trained", EncoderEmbedder(
            cfg, params=params, seq_len=args.seq_len, tokenizer=tok)),
    ]
    for name, emb in embedders:
        kb = KnowledgeBase(f"sem-{name}", embedder=emb)
        t0 = time.perf_counter()
        for d, (_, txt) in docs.items():
            kb.add_document(d, txt)
        build_s = time.perf_counter() - t0
        modes = ["vector"] + (["hybrid"] if name == "encoder-trained"
                              else [])
        for mode in modes:
            t0 = time.perf_counter()
            r1, r10 = evaluate(kb, np.random.default_rng(erng.integers(
                2**31)), eval_topics, doc_name, mode=mode)
            row = {"embedder": name, "mode": mode,
                   "recall@1": round(r1, 4), "recall@10": round(r10, 4),
                   "docs": len(docs), "eval_queries": len(eval_topics),
                   "build_s": round(build_s, 1),
                   "eval_s": round(time.perf_counter() - t0, 1)}
            if name == "encoder-trained":
                row.update(train_s=round(train_s, 1),
                           params_m=round(n_params / 1e6, 2),
                           steps=args.steps)
            results.append(row)
            print(json.dumps(row), flush=True)

    with open("benchmarks/results_semantic_scale.json", "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
