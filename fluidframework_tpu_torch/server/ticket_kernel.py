"""Deli ticketing, batched over documents, in plain PyTorch.

Counterpart of fluidframework_tpu's server/ticket_kernel.py. The sequencer
assigns each raw op a sequenceNumber and a minimumSequenceNumber (min over
per-client refSeqs, a masked min over a [B, K] client table here), nacks
stale refSeqs and drops duplicate clientSeqs. The JAX version is a
`lax.scan` over T with `vmap` over docs, not a Pallas kernel; here it is a
Python loop over T whose every step is vectorized over [B, K].
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.device import resolve_device

INT32_MAX = 2**31 - 1


class MsgKind:
    """Wire message classes the sequencer distinguishes: OP covers every
    client-authored message, JOIN/LEAVE mutate the client table, SYSTEM is a
    server-generated message that sequences unconditionally."""

    NOOP = 0
    OP = 1
    JOIN = 2
    LEAVE = 3
    SYSTEM = 4


class TicketState(NamedTuple):
    """Per-document sequencing state, [B, K] tables and [B] scalars.

    client_ids   connected client ordinals (-1 = free slot)
    client_ref   each client's latest referenceSequenceNumber
    client_cseq  each client's last clientSequenceNumber (dup guard)
    next_seq     next sequenceNumber to assign
    min_seq      current minimumSequenceNumber
    overflow     bool: a JOIN arrived with no free client slot
    """

    client_ids: torch.Tensor
    client_ref: torch.Tensor
    client_cseq: torch.Tensor
    next_seq: torch.Tensor
    min_seq: torch.Tensor
    overflow: torch.Tensor


class RawOps(NamedTuple):
    """Unsequenced client ops, [B, T], NOOP = client -1. Without a `kind`
    column every op with client >= 0 is an OP and unknown clients
    auto-join on first op."""

    client: torch.Tensor
    client_seq: torch.Tensor
    ref_seq: torch.Tensor
    kind: Optional[torch.Tensor] = None


class Ticketed(NamedTuple):
    """Per-op ticketing results, [B, T]."""

    seq: torch.Tensor          # assigned sequence number (0 = not sequenced)
    min_seq: torch.Tensor      # msn stamped on the op
    nacked: torch.Tensor       # bool: stale refSeq or client not joined
    not_joined: torch.Tensor   # bool: nack was for an un-joined client
    empty_after: torch.Tensor  # bool: client table empty after this message


def make_ticket_state(clients_capacity: int, batch: int,
                      device: str | torch.device | None = None
                      ) -> TicketState:
    """Fresh [batch, clients_capacity] ticket state; device defaults to
    "cuda" and raises when CUDA is absent."""
    dev = resolve_device(device)

    def full(value, *dims):
        return torch.full((batch, *dims), value, dtype=torch.int32,
                          device=dev)

    return TicketState(
        client_ids=full(-1, clients_capacity),
        client_ref=full(INT32_MAX, clients_capacity),
        client_cseq=full(0, clients_capacity),
        next_seq=full(1),
        min_seq=full(0),
        overflow=torch.zeros(batch, dtype=torch.bool, device=dev),
    )


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 when none (the
    `jnp.argmax` tie and all-False rule), as int64 for gather."""
    k = mask.shape[-1]
    lanes = torch.arange(k, device=mask.device)
    first = torch.where(mask, lanes, k).amin(dim=-1)
    return torch.where(first == k, 0, first)


def _ticket_one(s: TicketState, kind, client, client_seq, ref_seq,
                require_join: bool) -> Tuple[TicketState, Tuple]:
    """Ticket one message per document ([B] columns): join/leave table
    updates, dup drop, stale nack, seq/MSN assignment as masked updates."""
    k = s.client_ids.shape[-1]
    col = client[:, None]
    has_client = client >= 0
    is_op = (kind == MsgKind.OP) & has_client
    is_join = (kind == MsgKind.JOIN) & has_client
    is_leave = (kind == MsgKind.LEAVE) & has_client
    is_system = kind == MsgKind.SYSTEM

    # Leave first: evict the client from the MSN calculation.
    gone = is_leave[:, None] & (s.client_ids == col)
    ids0 = torch.where(gone, -1, s.client_ids)
    ref0 = torch.where(gone, INT32_MAX, s.client_ref)
    leave_ok = is_leave & gone.any(dim=1)

    slot_mask = ids0 == col
    known = has_client & slot_mask.any(dim=1)
    free = ids0 == -1
    have_free = free.any(dim=1)
    slot = torch.where(known, _first_true(slot_mask), _first_true(free))

    auto_join = is_op & ~known & have_free & (not require_join)
    active = (is_op & known) | auto_join
    prev_cseq = torch.where(
        known, s.client_cseq.gather(1, slot[:, None])[:, 0], 0)
    # The dup check wins over the stale-refSeq nack: a redelivered op stays
    # a silent drop.
    dup = is_op & known & (client_seq <= prev_cseq)
    stale = is_op & (ref_seq < s.min_seq) & ~dup
    not_joined = is_op & ~active
    nacked = stale | not_joined
    op_ticket = is_op & ~dup & ~nacked

    join_ok = is_join & (known | have_free)
    join_full = is_join & ~known & ~have_free

    onehot = torch.arange(k, device=slot.device) == slot[:, None]
    upd_op = op_ticket[:, None] & onehot
    upd_join = join_ok[:, None] & onehot
    client_ids = torch.where(upd_op | upd_join, col, ids0)
    client_ref = torch.where(
        upd_op, ref_seq[:, None],
        torch.where(upd_join, (s.next_seq - 1)[:, None], ref0))
    client_cseq = torch.where(
        upd_op, client_seq[:, None],
        torch.where(upd_join, 0, s.client_cseq))

    ticket = op_ticket | join_ok | join_full | leave_ok | is_system
    seq = torch.where(ticket, s.next_seq, 0)
    # MSN: min over active clients' refSeqs, monotone, clamped below the
    # just-assigned seq.
    active_refs = torch.where(client_ids >= 0, client_ref, INT32_MAX)
    heap_min = active_refs.amin(dim=1)
    msn = torch.where(heap_min == INT32_MAX, s.min_seq,
                      torch.maximum(s.min_seq, heap_min))
    msn = torch.minimum(msn, s.next_seq - 1)
    s2 = TicketState(
        client_ids=client_ids,
        client_ref=client_ref,
        client_cseq=client_cseq,
        next_seq=torch.where(ticket, s.next_seq + 1, s.next_seq),
        min_seq=torch.where(ticket, msn, s.min_seq),
        overflow=s.overflow | join_full,
    )
    empty_after = ~(client_ids >= 0).any(dim=1)
    return s2, (seq, s2.min_seq, nacked, not_joined, empty_after)


def scan_tickets(state: TicketState, ops: RawOps,
                 require_join: bool = False
                 ) -> Tuple[TicketState, Ticketed]:
    """Ticket [B, T] message streams, stepping over T."""
    kind = ops.kind if ops.kind is not None else torch.where(
        ops.client >= 0, MsgKind.OP, MsgKind.NOOP).to(torch.int32)
    outs = []
    for t in range(ops.client.shape[-1]):
        state, out = _ticket_one(state, kind[:, t], ops.client[:, t],
                                 ops.client_seq[:, t], ops.ref_seq[:, t],
                                 require_join)
        outs.append(out)
    if not outs:
        b = ops.client.shape[0]
        empty_i = torch.zeros((b, 0), dtype=torch.int32,
                              device=ops.client.device)
        empty_b = empty_i.bool()
        return state, Ticketed(empty_i, empty_i, empty_b, empty_b, empty_b)
    return state, Ticketed(*(torch.stack(col, dim=1) for col in zip(*outs)))


def ticket_ops_batched(state: TicketState, ops: RawOps
                       ) -> Tuple[TicketState, Ticketed]:
    """Ticket [B, T] streams; unknown clients auto-join on first op."""
    return scan_tickets(state, ops)


def sequence_batched_strict(state: TicketState, ops: RawOps
                            ) -> Tuple[TicketState, Ticketed]:
    """The serving-path contract: a MsgKind column is given, and un-joined
    clients nack."""
    return scan_tickets(state, ops, require_join=True)


def evict_clients_batched(state: TicketState, clients: torch.Tensor
                          ) -> TicketState:
    """Evict one client per document ([B] tensor, -1 = none)."""
    gone = state.client_ids == clients[:, None]
    return state._replace(
        client_ids=torch.where(gone, -1, state.client_ids),
        client_ref=torch.where(gone, INT32_MAX, state.client_ref),
    )
