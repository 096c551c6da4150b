"""ContextEngine — the 7-stage context-building pipeline.

Reference: src/lib/context/engine.ts:79-219 —
  1. intent analysis
  2. retrieval decision (rules)
  3. unified retrieval: memory + documents in ONE index, one hybrid
     search with min vector score 0.4 (engine.ts:242-246), split
     afterwards by source tag (:253)
  4. history summary block
  5. multi-source merge under the token budget
  6. intent alignment (priority rescale + instruction)
  7. compression when usage > 85% (:174-199)

Stage 3/5's heavy lifting is on-device (hybrid_search); the rest is
host-side prompt assembly. All thresholds mirror the reference's."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from tpurag.context.compress import compress
from tpurag.context.decision import make_retrieval_decision
from tpurag.context.dedup import process_results
from tpurag.context.intent import Intent, analyze_intent
from tpurag.context.history import HistorySummarizer
from tpurag.context.merger import (
    ContextChunk,
    ContextStats,
    assemble,
    merge_sources,
    normalize,
)
from tpurag.core.config import EngineConfig, PRESETS
from tpurag.core.types import QueryTrace

# Intent guidance (intent-aligner.ts:40-48; greeting/small_talk/datetime
# intentionally have none).
_INTENT_INSTRUCTIONS = {
    "document_summary": "Summarize and synthesize the information above.",
    "knowledge_query": "Answer the question from the information above.",
    "comparison": "Compare and contrast using the information above.",
    "draw_diagram": "Generate the diagram from the information above.",
    "web_search": "Answer based on the search results.",
    "instruction": "Carry out the user's instruction using the "
                   "information above.",
}


@dataclasses.dataclass
class BuiltContext:
    text: str
    intent: Intent
    stats: ContextStats
    chunks: list[ContextChunk]
    memories: list
    documents: list
    trace: QueryTrace


class ContextEngine:
    def __init__(self, kb, memory_service=None,
                 config: Optional[EngineConfig] = None,
                 llm: Optional[Callable[[str], str]] = None):
        from tpurag.context.adaptive import TaskTracker

        self.kb = kb
        self.memory = memory_service
        self.config = config or EngineConfig()
        self.llm = llm
        self.history_summarizer = HistorySummarizer(self.config.context, llm)
        self.tasks = TaskTracker()  # engine.ts:108-123 runs getTaskState
        #                             in the parallel retrieval stage

    def build_context(self, query: str,
                      history: Optional[list[dict]] = None,
                      max_tokens: Optional[int] = None,
                      now: Optional[float] = None,
                      session_id: str = "default") -> BuiltContext:
        cfg = self.config.context
        budget = max_tokens or cfg.agent_token_budget
        now = now or time.time()
        trace = QueryTrace(question=query)
        t0 = time.perf_counter()

        # 1. intent
        intent = analyze_intent(query, history, llm=self.llm)
        trace.intent = intent.intent
        trace.record("intent", time.perf_counter() - t0)
        if intent.skip_agent:
            budget = min(budget, cfg.greeting_token_budget)

        # 2. retrieval decision
        decision = make_retrieval_decision(query, budget)

        # 3. unified retrieval (memory + documents share the dense index;
        #    one hybrid search at minVectorScore 0.4, split by source).
        memories: list[tuple[str, float]] = []
        documents: list[tuple[str, float]] = []
        if decision.should_retrieve and len(self.kb) > 0:
            t1 = time.perf_counter()
            preset = dataclasses.replace(
                PRESETS["unified"], final_top_k=decision.top_k + 10)
            resp = self.kb.search(query, preset=preset, mode="hybrid")
            results = process_results(resp.results, query, cfg)
            # RRF fused scores live in (0, rrf_max]; dividing by the
            # preset's theoretical maximum (rank 0 in both sources +
            # both-bonus) maps them onto [0, 1] exactly — downstream
            # memory/document confidences compare on that scale.
            inv_max = 1.0 / preset.rrf_max
            for r in results:
                conf = min(max(r.score * inv_max, 0.0), 1.0)
                if r.source == "memory":
                    memories.append((r.text, conf))
                else:
                    documents.append((r.text, conf))
            documents = documents[: decision.top_k]
            trace.record("retrieval", time.perf_counter() - t1)
            trace.retrieved = results

        # Memory-service recall adds freshness-scored memories beyond what
        # sits in the shared index (store.ts scoring).
        if self.memory is not None:
            for e, s in self.memory.recall(query, k=5, now=now):
                memories.append((e.content, s))

        # 4. history block + task state (engine.ts:108-123 gathers both
        #    alongside retrieval).
        summary, recent = ("", history or [])
        if history:
            summary, recent = self.history_summarizer.summarize(history)
        history_items = ([(summary, 0.8)] if summary else [])
        task = self.tasks.observe(session_id, query, now=now)
        if task and task.description:
            history_items.append((f"Current task: {task.description}", 0.7))

        # 5. merge under budget with source weights
        chunks: list[ContextChunk] = []
        chunks += normalize(memories, "memory", cfg.weights)
        chunks += normalize(documents, "rag", cfg.weights)
        chunks += normalize(history_items, "history", cfg.weights)

        # 6. intent alignment: rescale priorities by the intent's
        #    source weights (intent-aligner.ts:16-27).
        iw = intent.weights
        for c in chunks:
            c.priority *= iw.get(c.source, 1.0)
        kept, stats = merge_sources(chunks, budget, cfg)
        text = assemble(kept)
        if intent.keywords and text:
            # intent-aligner.ts:52-56 keyword hint.
            text += f"\n\nFocus keywords: {', '.join(intent.keywords)}"
        instruction = _INTENT_INSTRUCTIONS.get(intent.intent)
        if instruction:
            text = f"{text}\n\n## Guidance\n{instruction}" if text else instruction

        # 7. compression past 85% usage (engine.ts:174-199)
        if stats.usage > cfg.compression_trigger:
            t2 = time.perf_counter()
            text = compress(text, cfg.compression_target, llm=self.llm,
                            keywords=intent.keywords or query.split())
            trace.record("compression", time.perf_counter() - t2)

        trace.record("total", time.perf_counter() - t0)
        return BuiltContext(text=text, intent=intent, stats=stats,
                            chunks=kept, memories=memories,
                            documents=documents, trace=trace)

    def process_conversation_end(self, user: str, assistant: str = "",
                                 now: Optional[float] = None) -> list[int]:
        """Post-turn memory extraction (engine.ts:317, agent.ts:678)."""
        if self.memory is None:
            return []
        return self.memory.process_conversation_end(user, assistant, now=now)
