"""Intelligence runner agent: background text analytics over a document.

Capability parity with reference packages/agents/intelligence-runner-agent
(457 LoC: `intelRunner.ts`, `textAnalytics.ts` — run by the agent
scheduler, writes results into an "insights" map): exactly one client in
the session wins the intelligence task via AgentScheduler; it watches the
SharedString and republishes analytics into a SharedMap all clients can
read. Providers are pluggable callables `str -> dict` (the reference calls
external translation/sentiment services; the built-ins here are
self-contained)."""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

TASK_ID = "intelligence-runner"


# -- built-in providers (textAnalytics.ts role) ---------------------------
def text_analytics(text: str) -> dict:
    words = re.findall(r"[\w']+", text)
    sentences = [s for s in re.split(r"[.!?]+", text) if s.strip()]
    return {
        "charCount": len(text),
        "wordCount": len(words),
        "sentenceCount": len(sentences),
        "avgWordLength": (sum(map(len, words)) / len(words)) if words else 0.0,
    }


_POSITIVE = frozenset("good great excellent love happy wonderful best "
                      "fantastic amazing nice".split())
_NEGATIVE = frozenset("bad terrible awful hate sad worst horrible poor "
                      "wrong broken".split())


def sentiment(text: str) -> dict:
    words = [w.lower() for w in re.findall(r"[\w']+", text)]
    pos = sum(w in _POSITIVE for w in words)
    neg = sum(w in _NEGATIVE for w in words)
    score = (pos - neg) / max(1, pos + neg)
    return {"positive": pos, "negative": neg, "score": score}


_STOPWORDS = frozenset("the a an and or of to in is are was were be on at "
                       "it this that with for as by from".split())


def key_phrases(text: str, top: int = 5) -> dict:
    counts: Dict[str, int] = {}
    for word in re.findall(r"[\w']+", text.lower()):
        if word not in _STOPWORDS and len(word) > 2:
            counts[word] = counts.get(word, 0) + 1
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:top]
    return {"phrases": [w for w, _ in ranked]}


DEFAULT_PROVIDERS: Dict[str, Callable[[str], dict]] = {
    "textAnalytics": text_analytics,
    "sentiment": sentiment,
    "keyPhrases": key_phrases,
}


class IntelligenceRunner:
    """Watches a SharedString; when this client holds the intelligence task,
    recomputes provider outputs every `batch_size` edits (the reference
    batches op-triggered runs the same way) into the insights map."""

    def __init__(self, scheduler, text, insights,
                 providers: Optional[Dict[str, Callable[[str], dict]]] = None,
                 batch_size: int = 1):
        self.scheduler = scheduler
        self.text = text
        self.insights = insights
        self.providers = dict(providers or DEFAULT_PROVIDERS)
        self.batch_size = batch_size
        self.runs = 0
        self._edits_since_run = 0
        self._started = False

    def start(self) -> None:
        """Volunteer for the task; the winner begins analyzing."""
        if not self._started:
            self._started = True
            self.text.on("sequenceDelta", self._on_delta)
        self.scheduler.pick(TASK_ID, self._run_once)

    @property
    def is_runner(self) -> bool:
        return self.scheduler.picked(TASK_ID)

    def stop(self) -> None:
        self.scheduler.release(TASK_ID)

    # -- internals ---------------------------------------------------------
    def _on_delta(self, *_args) -> None:
        if not self.is_runner:
            return
        self._edits_since_run += 1
        if self._edits_since_run >= self.batch_size:
            self._run_once()

    def _run_once(self) -> None:
        self._edits_since_run = 0
        self.runs += 1
        content = self.text.get_text()
        for name, provider in self.providers.items():
            self.insights.set(name, provider(content))
        self.insights.set("meta", {
            "runner": self.scheduler.container.delta_manager.client_id,
            "sequenceNumber":
                self.scheduler.container.protocol.sequence_number,
        })
