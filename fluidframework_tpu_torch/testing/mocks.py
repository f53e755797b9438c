"""MockSequencedEnvironment: a mini ordering service + N container runtimes
(a port of fluidframework_tpu's testing/mocks.py).

Capability parity with reference test-runtime-utils
(mocks.ts:108 MockContainerRuntimeFactory — "collects submitted ops, stamps
seq numbers, redelivers to all connected mocks" — and mocksForReconnection
.ts:18,83): join ops, per-client FIFO queues, minimum-sequence-number
tracking deli-style (min over in-flight refSeqs), disconnect/reconnect with
op loss and resubmission. Its runtimes run on `device` (None means
"cuda"; tests pass "cpu").
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from ..core.device import resolve_device
from ..protocol.messages import MessageType, SequencedDocumentMessage
from ..runtime.container_runtime import ContainerRuntime
from ..runtime.datastore_runtime import ChannelRegistry


class _ClientState:
    def __init__(self, client_id: str, runtime: ContainerRuntime):
        self.client_id = client_id
        self.runtime = runtime
        self.connected = True
        self.queue: List[Tuple[str, dict, int, int]] = []  # type, contents, csn, refseq
        self.buffered: List[SequencedDocumentMessage] = []
        self.csn = 0
        self.last_seen_seq = 0


class MockSequencedEnvironment:
    def __init__(self, registry: Optional[ChannelRegistry] = None,
                 device=None):
        self.registry = registry
        self.device = resolve_device(device)
        self.clients: Dict[str, _ClientState] = {}
        self.seq = 0
        self._id_counter = 0

    # -- clients -----------------------------------------------------------
    def create_runtime(self, client_id: Optional[str] = None
                       ) -> ContainerRuntime:
        self._id_counter += 1
        client_id = client_id or f"client-{self._id_counter}"
        runtime = ContainerRuntime(registry=self.registry,
                                   device=self.device)
        state = _ClientState(client_id, runtime)
        self.clients[client_id] = state

        def submit_fn(mtype, contents, before_send=None, _state=state):
            _state.csn += 1
            if before_send is not None:
                before_send(_state.csn)
            _state.queue.append(
                (mtype, contents, _state.csn, _state.last_seen_seq))
            return _state.csn

        runtime.set_local_client(client_id)
        runtime.attach(submit_fn)
        # Join op enters the sequenced stream.
        state.queue.insert(0, (MessageType.CLIENT_JOIN,
                               {"clientId": client_id}, 0, 0))
        return runtime

    # -- connection churn ---------------------------------------------------
    def disconnect(self, runtime: ContainerRuntime) -> None:
        state = self._state_of(runtime)
        state.connected = False
        state.queue.clear()  # in-flight ops are lost
        runtime.set_connected(False)

    def reconnect(self, runtime: ContainerRuntime) -> None:
        state = self._state_of(runtime)
        # Catch up on everything missed while away.
        for msg in state.buffered:
            runtime.process(msg)
            state.last_seen_seq = msg.sequence_number
        state.buffered.clear()
        state.connected = True
        # New wire identity (new join), like a real reconnect.
        self._id_counter += 1
        new_id = f"{state.client_id}#r{self._id_counter}"
        del self.clients[state.client_id]
        state.client_id = new_id
        self.clients[new_id] = state
        state.queue.append((MessageType.CLIENT_JOIN,
                            {"clientId": new_id}, 0, state.last_seen_seq))
        runtime.set_connected(True, new_id)  # triggers resubmission

    def _state_of(self, runtime: ContainerRuntime) -> _ClientState:
        for state in self.clients.values():
            if state.runtime is runtime:
                return state
        raise KeyError("unknown runtime")

    # -- sequencing ---------------------------------------------------------
    def _min_seq(self) -> int:
        """Deli MSN rule: min over connected clients of (refSeq of oldest
        in-flight op, else last seen seq)."""
        floors = []
        for state in self.clients.values():
            if not state.connected:
                continue
            if state.queue:
                floors.append(min(entry[3] for entry in state.queue))
            else:
                floors.append(state.last_seen_seq)
        return min(floors) if floors else self.seq

    def process_some(self, rng: random.Random, limit: int = 10**9) -> int:
        """Sequence up to `limit` queued ops in a random per-client-order-
        preserving interleave; deliver to connected, buffer for others."""
        processed = 0
        while processed < limit:
            live = [s for s in self.clients.values()
                    if s.queue and s.connected]
            if not live:
                break
            state = rng.choice(live)
            mtype, contents, csn, ref_seq = state.queue.pop(0)
            self.seq += 1
            msg = SequencedDocumentMessage(
                client_id=state.client_id,
                sequence_number=self.seq,
                minimum_sequence_number=min(self._min_seq(), self.seq - 1),
                client_sequence_number=csn,
                reference_sequence_number=ref_seq,
                type=mtype,
                contents=contents,
            )
            for target in self.clients.values():
                if target.connected:
                    target.runtime.process(msg)
                    target.last_seen_seq = self.seq
                else:
                    target.buffered.append(msg)
            processed += 1
        return processed

    def process_all(self, rng: Optional[random.Random] = None) -> int:
        return self.process_some(rng or random.Random(0))
