"""Service load/stress rig.

Capability parity with reference packages/test/service-load-test
(`nodeStressTest.ts:24-33`, `loadTestDataStore.ts`): a configurable
profile — documents × clients-per-doc × ops, with an op mix across DDS
types — driven against any service through its driver factory; reports
throughput and verifies full cross-client convergence per document at the
end (the rig doubles as an eventual-consistency checker, SURVEY.md §5
race detection)."""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..capacity.workload import OpMix, closed_loop_schedule
from ..dds.counter import SharedCounter
from ..dds.map import SharedMap
from ..dds.sequence import SharedString
from ..loader.container import Container, Loader


@dataclass
class LoadProfile:
    """Mirrors the reference's profile knobs (docs, clients, op budget)."""

    documents: int = 2
    clients_per_document: int = 2
    ops_per_client: int = 50
    seed: int = 0
    # Op mix weights: (map set, string insert, string remove, counter inc)
    weights: tuple = (4, 3, 1, 2)
    reconnect_probability: float = 0.0  # per-op chance to drop + resubmit
    # True: string edits follow the keystroke model (bursts at a moving
    # cursor, backspaces, word deletes, pastes, format sweeps —
    # testing/traces.py) instead of uniform-random positions; the
    # position-locality distribution real editors produce.
    keystroke_trace: bool = False


@dataclass
class LoadResult:
    total_ops: int = 0
    elapsed_s: float = 0.0
    documents: int = 0
    divergences: List[str] = field(default_factory=list)

    @property
    def ops_per_second(self) -> float:
        return self.total_ops / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def converged(self) -> bool:
        return not self.divergences


class LoadRunner:
    """`loader_factory()` must yield a FRESH Loader per client (each client
    is its own wire identity), all bound to the same service."""

    def __init__(self, loader_factory: Callable[[], Loader]):
        self.loader_factory = loader_factory
        self._cursors: Dict[tuple, int] = {}  # (doc, client) -> position

    def _setup_document(self, doc_id: str, n_clients: int
                        ) -> List[Container]:
        creator = self.loader_factory()
        c0 = creator.create_detached(doc_id)
        ds = c0.runtime.create_datastore("load")
        ds.create_channel("map", SharedMap.TYPE)
        ds.create_channel("text", SharedString.TYPE)
        ds.create_channel("counter", SharedCounter.TYPE)
        c0.attach()
        containers = [c0]
        for _ in range(n_clients - 1):
            containers.append(self.loader_factory().resolve(doc_id))
        return containers

    def _one_op(self, rng: random.Random, client_index: int, op_index: int,
                container: Container, profile: LoadProfile) -> None:
        ds = container.runtime.get_datastore("load")
        # The one op-mix implementation in the tree (capacity/workload.py):
        # consumes the profile RNG exactly as the historical inline
        # rng.choices did, so seeded replays pick identical kinds.
        kind = OpMix(profile.weights).draw(rng)
        if kind == "map":
            # JSON-canonical values only: the writer keeps the submitted
            # object while replicas see its wire round-trip (a tuple would
            # come back as a list — same as the reference, which stores the
            # local JS object as-is).
            ds.get_channel("map").set(
                f"k{rng.randrange(32)}", [client_index, op_index])
        elif kind == "insert":
            text = ds.get_channel("text")
            pos = rng.randrange(text.get_length() + 1)
            text.insert_text(pos, f"c{client_index}.{op_index};")
        elif kind == "remove":
            text = ds.get_channel("text")
            length = text.get_length()
            if length > 2:
                start = rng.randrange(length - 1)
                text.remove_text(start,
                                 min(length, start + rng.randrange(1, 4)))
        else:
            ds.get_channel("counter").increment(rng.randrange(1, 5))

    def _trace_op(self, rng: random.Random, doc_id: str, client_index: int,
                  container: Container) -> None:
        """One keystroke-model edit against the live channel (the editing
        shape of traces.keystroke_trace, driven interactively)."""
        from .traces import WORDS

        text = container.runtime.get_datastore("load").get_channel("text")
        length = text.get_length()
        key = (doc_id, client_index)
        cur = min(self._cursors.get(key, 0), length)
        roll = rng.random()
        if roll < 0.74:  # keystroke
            word = rng.choice(WORDS)
            ch = word[rng.randrange(len(word))] if rng.random() < 0.85 \
                else " "
            text.insert_text(cur, ch)
            cur += 1
        elif roll < 0.84:  # backspace
            if cur > 0:
                text.remove_text(cur - 1, cur)
                cur -= 1
        elif roll < 0.90:  # word/selection delete
            if length >= 4:
                span = min(rng.randrange(2, 25), length)
                start = max(0, min(cur - span // 2, length - span))
                text.remove_text(start, start + span)
                cur = start
        elif roll < 0.94:  # paste
            n = rng.randrange(20, 121)
            blob = " ".join(rng.choice(WORDS)
                            for _ in range(max(1, n // 6)))[:n]
            text.insert_text(cur, blob)
            cur += len(blob)
        elif roll < 0.98:  # format sweep
            if length >= 2:
                span = min(rng.randrange(5, 81), length)
                start = max(0, min(cur - span // 2, length - span))
                text.annotate_range(start, start + span,
                                    {"fmt": rng.randrange(4)})
        else:  # cursor jump
            cur = rng.randrange(length + 1) if length else 0
        self._cursors[key] = cur

    def run(self, profile: Optional[LoadProfile] = None) -> LoadResult:
        profile = profile or LoadProfile()
        result = LoadResult(documents=profile.documents)
        rng = random.Random(profile.seed)
        docs: Dict[str, List[Container]] = {}
        for d in range(profile.documents):
            doc_id = f"load-doc-{d}"
            docs[doc_id] = self._setup_document(
                doc_id, profile.clients_per_document)
        started = time.perf_counter()
        # The shared closed-loop schedule (capacity/workload.py): the
        # same (doc, op, client) nesting order this rig has always
        # driven, now defined once for rig and soak alike.
        doc_list = list(docs.items())
        for d, op_index, client_index in closed_loop_schedule(
                profile.documents, profile.clients_per_document,
                profile.ops_per_client):
            doc_id, containers = doc_list[d]
            container = containers[client_index]
            if (profile.reconnect_probability
                    and rng.random() < profile.reconnect_probability):
                container.reconnect()
            if profile.keystroke_trace:
                self._trace_op(rng, doc_id, client_index, container)
            else:
                self._one_op(rng, client_index, op_index, container,
                             profile)
            result.total_ops += 1
        result.elapsed_s = time.perf_counter() - started
        # -- convergence audit (the race detector role) ---------------------
        for doc_id, containers in docs.items():
            views = []
            for container in containers:
                ds = container.runtime.get_datastore("load")
                m = ds.get_channel("map")
                views.append({
                    "map": {k: m.get(k) for k in sorted(m.keys())},
                    "text": ds.get_channel("text").get_text(),
                    "counter": ds.get_channel("counter").value,
                })
            for i, view in enumerate(views[1:], start=1):
                if view != views[0]:
                    result.divergences.append(
                        f"{doc_id}: client {i} diverged from client 0")
        return result
