"""Op-tensor bridge: gRPC ingress for packed op batches (a port of
fluidframework_tpu's server/bridge.py).

Capability parity with the reference's client↔service wire at partition
scale (SURVEY.md §2.7 / BASELINE north star: "Node↔Python gRPC bridge with
packed op tensors... the gRPC hop must amortize via partition-sized
batches"): an external producer — a JS front door, another host, a replay
rig — ships a whole partition batch of ops as ONE packed int32 tensor
frame; the bridge runs the north-star step (server/pipeline.full_step:
the ticket scan, the merge-tree apply and the summary length, each a
hand-written CUDA kernel on the card) and returns the ticketed
assignments in one packed reply.

No protoc codegen: methods are registered with identity (bytes) serializers
and a fixed little-endian frame layout, so any language with a gRPC client
and a struct packer can speak it:

  request  := header(int32 x2: n_docs, n_steps) ++ 10 column tensors
              (PackedOps field order, int32 [n_docs, n_steps], C order)
  response := header(int32 x2) ++ seq[int32 B,T] ++ min_seq[int32 B,T]
              ++ nack[int32 B,T] ++ total_len[int32 B]

Sessions are keyed by metadata ("session-id") and the batch's document
count; each session owns persistent device state, so successive batches
continue the same documents. `OpBridge` is the transport-free core (decode,
the copy to the device, the step, the copy back and encode), which a
caller without grpc drives through `submit`; `OpBridgeServer` puts it
behind gRPC, which it imports when it is constructed.
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..mergetree.oppack import PackedOps

SERVICE = "fluidframework.OpBridge"
_HEADER = np.dtype("<i4")


def encode_ops(cols: Dict[str, np.ndarray]) -> bytes:
    """Pack gen_traces-style columns (PackedOps field order) into a frame."""
    first = cols[PackedOps._fields[0]]
    b, t = first.shape
    parts = [np.asarray([b, t], dtype=_HEADER).tobytes()]
    for field in PackedOps._fields:
        col = np.ascontiguousarray(cols[field], dtype=np.int32)
        if col.shape != (b, t):
            raise ValueError(f"column {field} shape {col.shape}")
        parts.append(col.tobytes())
    return b"".join(parts)


def _check_frame(frame: bytes, b: int, t: int, planes: int) -> None:
    if b < 0 or t < 0 or len(frame) != 8 + 4 * planes * b * t:
        raise ValueError(f"frame of {len(frame)} bytes does not hold "
                         f"[{b}, {t}] planes")


def decode_ops(frame: bytes):
    """(n_docs, n_steps, {field: read-only int32 [B, T] view})."""
    b, t = (int(x) for x in np.frombuffer(frame, dtype=_HEADER, count=2))
    _check_frame(frame, b, t, len(PackedOps._fields))
    size = b * t * 4
    offset = 8
    cols = {}
    for field in PackedOps._fields:
        cols[field] = np.frombuffer(
            frame, dtype=np.int32, count=b * t, offset=offset
        ).reshape(b, t)
        offset += size
    return b, t, cols


def encode_reply(seq: np.ndarray, min_seq: np.ndarray, nack: np.ndarray,
                 total_len: np.ndarray) -> bytes:
    b, t = seq.shape
    return b"".join([
        np.asarray([b, t], dtype=_HEADER).tobytes(),
        np.ascontiguousarray(seq, np.int32).tobytes(),
        np.ascontiguousarray(min_seq, np.int32).tobytes(),
        np.ascontiguousarray(nack, np.int32).tobytes(),
        np.ascontiguousarray(total_len, np.int32).tobytes(),
    ])


def decode_reply(frame: bytes):
    b, t = np.frombuffer(frame, dtype=_HEADER, count=2)
    b, t = int(b), int(t)
    n = b * t
    seq = np.frombuffer(frame, np.int32, n, 8).reshape(b, t)
    min_seq = np.frombuffer(frame, np.int32, n, 8 + 4 * n).reshape(b, t)
    nack = np.frombuffer(frame, np.int32, n, 8 + 8 * n).reshape(b, t)
    total = np.frombuffer(frame, np.int32, b, 8 + 12 * n)
    return {"seq": seq, "minSeq": min_seq, "nack": nack, "totalLen": total}


class _Session:
    def __init__(self, n_docs: int, capacity: int, device: torch.device):
        from ..mergetree.state import make_state
        from . import ticket_kernel as tk
        self.tstate = tk.make_ticket_state(8, batch=n_docs, device=device)
        self.mstate = make_state(capacity, 1, batch=n_docs, device=device)
        self.lock = threading.Lock()


class OpBridge:
    """The bridge without its transport: sessions, and one request frame
    in, one reply frame out. device None is the card (raises without
    CUDA); tests pass device="cpu"."""

    def __init__(self, capacity: int = 256,
                 device: str | torch.device | None = None):
        from .pipeline import full_step
        self.device = resolve_device(device)
        self._full_step = full_step
        self.capacity = capacity
        self.sessions: Dict[Tuple[str, int], _Session] = {}
        self._lock = threading.Lock()
        # RPCs arrive on a pool of threads. Steps of different sessions
        # run one at a time: they share the card's one stream, and the
        # kernels' launch counters and the first build's compile-ledger
        # entry are updated without a lock of their own.
        self._step_lock = threading.Lock()

    # -- the stages of submit, each callable (and timed) on its own -------
    def to_device(self, cols: Dict[str, np.ndarray]):
        """(RawOps, PackedOps) on the bridge's device: the ten columns in
        one copy (through pinned memory to the card)."""
        from . import ticket_kernel as tk
        block = np.stack([cols[f] for f in PackedOps._fields])
        if self.device.type == "cuda":
            host = torch.empty(block.shape, dtype=torch.int32,
                               pin_memory=True)
            host.numpy()[...] = block
            dev = host.to(self.device, non_blocking=True)
        else:
            dev = torch.from_numpy(block).to(self.device)
        ops = PackedOps(*dev.unbind(0))
        raw = tk.RawOps(client=ops.client, client_seq=ops.seq,
                        ref_seq=ops.ref_seq)
        return raw, ops

    def session(self, session_id: str, n_docs: int) -> _Session:
        key = (session_id, n_docs)
        with self._lock:
            session = self.sessions.get(key)
            if session is None:
                session = _Session(n_docs, self.capacity, self.device)
                self.sessions[key] = session
            return session

    def step(self, session_id: str, raw, ops):
        """Advance the session's state by one batch; (Ticketed, total_len).
        A step that raises evicts its session, so the next request for it
        starts from fresh state (the JAX bridge's contract: its donated
        buffers are gone after a failed step)."""
        n_docs = ops.kind.shape[0]
        session = self.session(session_id, n_docs)
        with session.lock, self._step_lock:
            try:
                session.tstate, session.mstate, ticketed, total_len = \
                    self._full_step(session.tstate, session.mstate, raw,
                                    ops)
            except Exception:
                with self._lock:
                    self.sessions.pop((session_id, n_docs), None)
                raise
        return ticketed, total_len

    @staticmethod
    def reply(ticketed, total_len) -> bytes:
        """The reply frame, from one device-to-host copy of its planes;
        byte-equal to encode_reply of the same outputs."""
        b, t = ticketed.seq.shape
        flat = torch.cat([ticketed.seq.reshape(-1),
                          ticketed.min_seq.reshape(-1),
                          ticketed.nacked.to(torch.int32).reshape(-1),
                          total_len.to(torch.int32).reshape(-1)]).cpu()
        return np.asarray([b, t], dtype=_HEADER).tobytes() + \
            flat.numpy().tobytes()

    def submit(self, session_id: str, request: bytes) -> bytes:
        """One batch: decode, the copy to the device, the step, the copy
        back and encode."""
        _b, _t, cols = decode_ops(request)
        raw, ops = self.to_device(cols)
        ticketed, total_len = self.step(session_id, raw, ops)
        return self.reply(ticketed, total_len)


class OpBridgeServer(OpBridge):
    """OpBridge behind gRPC (imported here: the transport is optional)."""

    def __init__(self, capacity: int = 256, port: int = 0,
                 max_workers: int = 4,
                 device: str | torch.device | None = None):
        import grpc
        super().__init__(capacity=capacity, device=device)
        service = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                if handler_call_details.method == f"/{SERVICE}/SubmitBatch":
                    return grpc.unary_unary_rpc_method_handler(
                        service._submit_batch)
                if handler_call_details.method == f"/{SERVICE}/Ping":
                    return grpc.unary_unary_rpc_method_handler(
                        lambda req, ctx: b"pong")
                return None

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers((Handler(),))
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")

    def start(self) -> "OpBridgeServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop(grace=1)

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    # -- the one hot RPC ----------------------------------------------------
    def _submit_batch(self, request: bytes, context) -> bytes:
        session_id = dict(context.invocation_metadata()).get(
            "session-id", "default")
        return self.submit(session_id, request)


class OpBridgeClient:
    def __init__(self, address: str, session_id: str = "default"):
        import grpc
        self._channel = grpc.insecure_channel(address)
        self.session_id = session_id
        self._submit = self._channel.unary_unary(
            f"/{SERVICE}/SubmitBatch",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        self._ping = self._channel.unary_unary(
            f"/{SERVICE}/Ping",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b)

    def ping(self) -> bool:
        return self._ping(b"") == b"pong"

    def submit_batch(self, cols: Dict[str, np.ndarray]) -> dict:
        reply = self._submit(encode_ops(cols),
                             metadata=(("session-id", self.session_id),))
        return decode_reply(reply)

    def close(self) -> None:
        self._channel.close()
