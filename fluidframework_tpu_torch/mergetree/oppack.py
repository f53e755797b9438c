"""Packing host op streams into int32 op columns [B, T].

The hot path never iterates Python objects: ops are packed into int32
columns (documents x time), padded with NOOP rows, and the apply steps over
T applying one op per document per step. pack_ops packs with the C packer
(native/src/oppack.cpp, built at first use); pack_ops_plain is the same
packing in numpy. The tensors are placed on a device by
interop.packed_ops_from_numpy.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


class OpKind:
    NOOP = 0
    INSERT = 1
    REMOVE = 2
    ANNOTATE = 3
    ACK_INSERT = 4
    ACK_REMOVE = 5
    INSERT_RUN = 6  # up to RUN_K packed cursor-advance inserts, one step


# A same-(client, refSeq) typing burst with cursor-advancing positions
# packs into one INSERT_RUN step of up to RUN_K rows: one visibility pass,
# one shift by RUN_K and RUN_K row fills, with every row keeping its own
# seq, op_id and length (padding rows are born dead: length 0, rem_seq 0).
RUN_K = 8
RUN_MIN = 5  # shorter runs stay plain inserts (padding would cost rows)


class RunCols(NamedTuple):
    """Per-step sub-insert columns for INSERT_RUN ops: [B, T, K] (or
    [T, K] unbatched) int32; length 0 marks padding slots, and no length
    is negative."""

    length: torch.Tensor
    seq: torch.Tensor
    op_id: torch.Tensor


class HostOp(NamedTuple):
    """One op in host form, positions relative to (ref_seq, client)."""

    kind: int
    seq: int            # DEV_UNASSIGNED for a pending local submit
    ref_seq: int
    client: int
    pos1: int = 0
    pos2: int = 0       # remove/annotate end (exclusive)
    op_id: int = -1     # global id: insert text payload / annotate pset
    new_len: int = 0    # insert payload length
    local_seq: int = 0  # local seq for pending submits; ack target
    msn: int = 0


class PackedOps(NamedTuple):
    """Int32 op columns, each [B, T] (or [T] unbatched)."""

    kind: torch.Tensor
    seq: torch.Tensor
    ref_seq: torch.Tensor
    client: torch.Tensor
    pos1: torch.Tensor
    pos2: torch.Tensor
    op_id: torch.Tensor
    new_len: torch.Tensor
    local_seq: torch.Tensor
    msn: torch.Tensor

    @property
    def steps(self) -> int:
        return self.kind.shape[-1]


FIELDS = PackedOps._fields

_NATIVE_PACK = None
_native_lock = threading.Lock()

# pack_into's negative codes (native/src/oppack.cpp) -> the error raised.
_NATIVE_ERRORS = {
    -1: (TypeError, "streams and each stream must be sequences"),
    -2: (TypeError, "streams changed length while packing"),
    -3: (TypeError, "each op must be a HostOp (a tuple of "
                    f"{len(FIELDS)} integers)"),
    -4: (TypeError, "an op field is not an integer"),
    -5: (OverflowError, "an op field lies outside int32"),
}


def native_packer():
    """The C packer (native/src/oppack.cpp), built with g++ on the first
    call and loaded with ctypes.PyDLL (it walks Python objects, so the GIL
    stays held). A failed build raises NativeBuildError; a library that
    cannot load raises OSError or AttributeError. Nothing falls back."""
    global _NATIVE_PACK
    with _native_lock:
        if _NATIVE_PACK is None:
            import ctypes

            from ..native.build import ensure_built

            fn = ctypes.PyDLL(ensure_built("oppack")).pack_into
            fn.argtypes = [ctypes.py_object, ctypes.c_void_p, ctypes.c_long,
                           ctypes.c_long, ctypes.c_long,
                           ctypes.POINTER(ctypes.c_longlong)]
            fn.restype = ctypes.c_long
            _NATIVE_PACK = fn
        return _NATIVE_PACK


def _steps(streams: List[List[HostOp]], steps: Optional[int]) -> int:
    t = steps if steps is not None else max((len(s) for s in streams),
                                            default=0)
    return max(t, 1)


def pack_ops(streams: List[List[HostOp]], steps: Optional[int] = None
             ) -> Dict[str, np.ndarray]:
    """Pack per-document op lists into numpy [B, T] int32 columns keyed by
    PackedOps field, NOOP-padded (all-zero rows), with the C packer.

    Raises ValueError when a document has more ops than `steps`,
    TypeError when an op is not a HostOp of integers and OverflowError
    when a field lies outside int32."""
    import ctypes

    b, t = len(streams), _steps(streams, steps)
    buf = np.zeros((len(FIELDS), b, t), np.int32)
    where = ctypes.c_longlong(0)
    rc = native_packer()(streams, buf.ctypes.data, b, t, len(FIELDS),
                         ctypes.byref(where))
    if rc > 0:
        d = rc - 1
        raise ValueError(f"doc {d}: {len(streams[d])} ops > {t} steps")
    if rc < 0:
        err, what = _NATIVE_ERRORS[rc]
        d, i = where.value >> 32, where.value & 0xFFFFFFFF
        raise err(f"{what} (doc {d}, op {i})")
    return {f: buf[j] for j, f in enumerate(FIELDS)}


def pack_ops_plain(streams: List[List[HostOp]],
                   steps: Optional[int] = None) -> Dict[str, np.ndarray]:
    """pack_ops in numpy, one document at a time: the reference the C
    packer is held against."""
    b, t = len(streams), _steps(streams, steps)
    buf = np.zeros((len(FIELDS), b, t), np.int32)
    for d, stream in enumerate(streams):
        if len(stream) > t:
            raise ValueError(f"doc {d}: {len(stream)} ops > {t} steps")
        if stream:
            buf[:, d, :len(stream)] = np.asarray(stream, np.int64).T
    return {f: buf[j] for j, f in enumerate(FIELDS)}


def pack_single(stream: List[HostOp], steps: Optional[int] = None
                ) -> Dict[str, np.ndarray]:
    """Pack one document's ops into unbatched [T] numpy columns."""
    return {f: col[0] for f, col in pack_ops([stream], steps).items()}


class RunSlot(NamedTuple):
    """A packed insert run: RUN_MIN..RUN_K cursor-advance inserts, one
    step."""

    ops: tuple  # HostOps, in order


def pack_run_slots(host_ops: List[HostOp],
                   base_seq: Optional[int] = None) -> List:
    """Greedy maximal-run detection over ONE channel's sequenced stream:
    consecutive acked INSERTs by one client whose positions advance with
    the cursor (pos_{i+1} == pos_i + len_i) collapse into RunSlots of up
    to RUN_K; runs shorter than RUN_MIN (and every other op) stay plain.

    The packed phase applies every member at the first member's
    perspective (r_1, client). That equals per-op application when no
    foreign op on this tree was sequenced in (r_1, r_i], which two
    stream-visible conditions guarantee: r_1 >= the previous stream op's
    seq (`base_seq` seeds the stream head), and members are
    stream-consecutive with monotone refs."""
    from .constants import DEV_UNASSIGNED

    slots: List = []
    i, n = 0, len(host_ops)
    last_seq = base_seq  # seq of the last preceding op in this stream
    while i < n:
        op = host_ops[i]
        j = i + 1
        if (op.kind == OpKind.INSERT and op.seq != DEV_UNASSIGNED
                and op.new_len > 0
                and last_seq is not None and op.ref_seq >= last_seq):
            cursor = op.pos1 + op.new_len
            prev_seq = op.seq
            prev_ref = op.ref_seq
            while j < n:
                nxt = host_ops[j]
                if (nxt.kind == OpKind.INSERT
                        and nxt.seq != DEV_UNASSIGNED
                        and nxt.client == op.client
                        and nxt.seq > prev_seq
                        and prev_ref <= nxt.ref_seq < nxt.seq
                        and nxt.pos1 == cursor and nxt.new_len > 0):
                    cursor += nxt.new_len
                    prev_seq = nxt.seq
                    prev_ref = nxt.ref_seq
                    j += 1
                    continue
                break
        run = list(host_ops[i:j])
        while len(run) >= RUN_K:
            slots.append(RunSlot(tuple(run[:RUN_K])))
            run = run[RUN_K:]
        if len(run) >= RUN_MIN:
            slots.append(RunSlot(tuple(run)))
        else:
            slots.extend(run)
        for o in host_ops[i:j]:
            if o.seq != DEV_UNASSIGNED:
                last_seq = o.seq if last_seq is None \
                    else max(last_seq, o.seq)
        i = j
    return slots


def pack_slots(slots: List, steps: Optional[int] = None
               ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Pack a mixed plain-op / RunSlot stream into unbatched [T] numpy op
    columns keyed by PackedOps field, and [T, RUN_K] run columns keyed by
    RunCols field (zeros, op_id -1, where the step is not a run)."""
    t = steps if steps is not None else max(len(slots), 1)
    base: List[HostOp] = []
    for s in slots:
        if isinstance(s, RunSlot):
            base.append(HostOp(
                kind=OpKind.INSERT_RUN, seq=s.ops[-1].seq,
                ref_seq=s.ops[0].ref_seq, client=s.ops[0].client,
                pos1=s.ops[0].pos1, pos2=0, op_id=-1,
                new_len=sum(o.new_len for o in s.ops),
                local_seq=0, msn=s.ops[-1].msn))
        else:
            base.append(s)
    packed = pack_single(base, steps=t)
    rl = np.zeros((t, RUN_K), np.int32)
    rs = np.zeros((t, RUN_K), np.int32)
    ri = np.full((t, RUN_K), -1, np.int32)
    for idx, s in enumerate(slots):
        if isinstance(s, RunSlot):
            for k, op in enumerate(s.ops):
                rl[idx, k] = op.new_len
                rs[idx, k] = op.seq
                ri[idx, k] = op.op_id
    return packed, {"length": rl, "seq": rs, "op_id": ri}
