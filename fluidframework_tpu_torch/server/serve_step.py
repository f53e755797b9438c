"""The fast serving flush's device program, and the paged serving
megakernel.

Counterpart of fluidframework_tpu's server/serve_step.py. One window is:
[B, T] deli ticketing for the whole partition, then for each merge group
and each LWW bucket the apply of its admitted ops (each op's assigned
seq/msn gathered from the ticket output by (doc lane, step)), then one
int16 vector (`flat16`) packing everything the host reads back. The
megakernel runs K staged windows over paged merge lanes: gather each page
group's documents once, apply the K windows to the gathered views, scatter
the views back.

Differences from the JAX program, none of which changes a result:
- there is no `fused` argument. CUDA tensors launch the fused-apply kernel
  (kernels/csrc/fused_apply.cu, the runs= and extract=True variants where
  the megakernel needs them) and CPU tensors run its plain version; a view
  capacity above `max_fused_capacity` raises ValueError, because the scan
  apply JAX uses there is not ported;
- every apply runs. JAX skips the apply of an all-NOOP group under
  `noop_skip`; a NOOP stream is an exact identity, so the port launches
  anyway, and `noop_skip` only counts such applies in the stats plane;
- JAX donates its operands. Here `serve_megakernel` scatters into the
  given pool in place and returns it, and `serve_megakernel_keep` copies
  the pool first and leaves every input unchanged. The other states are
  returned as new tensors either way.

Nothing in a ring syncs with the host: no `.item()`, no branch on a tensor
and no boolean-mask indexing.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..mergetree import kernel
from ..mergetree import pallas_apply as pa
from ..mergetree.oppack import OpKind, PackedOps, RunCols
from ..telemetry.device_stats import N_SERVE
from . import lww_kernel as lk
from . import ticket_kernel as tk

Stage = Optional[Callable[[str], None]]


class RingArgs(NamedTuple):
    """The staged arguments of one megakernel ring after (tstate, pool,
    lww_states), in call order: serve_megakernel(tstate, pool, lww,
    *ring). Each field is a tensor or a tuple with one entry per page group
    (runs_xs entries may be None) or per LWW bucket; testing/serving.py
    builds it with numpy arrays and interop.ring_args_from_numpy places
    it on a device."""

    ticket_xs: object   # [K, 4, B, T]
    page_ids: Tuple     # per group [n_pad, p2]
    counts: Tuple       # per group [n_pad]
    min_seqs: Tuple
    seqs: Tuple
    merge_xs: Tuple     # per group [K, 12, n_pad, Tm]
    lww_xs: Tuple       # per bucket [K, 6, lanes, Tm]
    runs_xs: Tuple      # per group [K, 4, n_pad, Tm, RUN_K] or None


_MERGE_KINDS = (OpKind.INSERT, OpKind.REMOVE, OpKind.ANNOTATE,
                OpKind.ACK_INSERT, OpKind.ACK_REMOVE, OpKind.INSERT_RUN)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _i16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int16)


def halves(x32: torch.Tensor) -> List[torch.Tensor]:
    """int32 -> [(lo, hi)] int16 halves; lo may land negative in int16
    (bit 15), and the host re-masks it with & 0xFFFF."""
    return [_i16(x32 & 0xFFFF), _i16(x32 >> 16)]


def admit_merge_ops(seq_bt: torch.Tensor, msn_bt: torch.Tensor,
                    mc: torch.Tensor, mr: Optional[torch.Tensor]):
    """One group's staged merge columns -> the ops its apply takes.

    mc is [12, lanes, Tm]: the 10 PackedOps columns, doc_idx, t_idx. Each
    op takes the seq/msn its ticket step was assigned; an op whose message
    was not sequenced becomes a NOOP. mr ([4, lanes, Tm, RUN_K]: member
    length, op_id, doc lane, ticket step) gives each INSERT_RUN member its
    own ticketed seq; a member the ticket pass dropped voids the whole
    slot and flags the lane (the host packed the run on a prediction).
    Returns (ops, runs or None, over_extra [lanes] bool or None)."""
    di, ti = mc[10].long(), mc[11].long()
    seq_g, msn_g = seq_bt[di, ti], msn_bt[di, ti]
    kind = mc[0]
    ok = (kind != OpKind.NOOP) & (seq_g > 0)
    runs = over_extra = None
    if mr is not None:
        sub_len, sub_oid = mr[0], mr[1]
        sub_seq = seq_bt[mr[2].long(), mr[3].long()]
        expected = sub_len > 0
        mispredict = (kind == OpKind.INSERT_RUN) & \
            (expected & (sub_seq <= 0)).any(dim=-1)
        ok = ok & ~mispredict
        runs = RunCols(length=sub_len.contiguous(),
                       seq=torch.where(expected, sub_seq, 0),
                       op_id=sub_oid.contiguous())
        over_extra = mispredict.any(dim=-1)
    ops = PackedOps(
        kind=torch.where(ok, kind, OpKind.NOOP),
        seq=torch.where(ok, seq_g, 0),
        ref_seq=mc[2], client=mc[3], pos1=mc[4], pos2=mc[5], op_id=mc[6],
        new_len=mc[7], local_seq=mc[8],
        msn=torch.where(ok, msn_g, 0))
    return ops, runs, over_extra


def _serve_window_impl(tstate, ticket_cols, merge_states, merge_cols,
                       lww_states, lww_cols, merge_runs=None,
                       noop_skip=False, stats=False, paged_scalars=False,
                       plain=False, stage: Stage = None):
    """One window: the body shared by serve_window, serve_burst and the
    megakernel.

    ticket_cols: [4, B, T] int32 (kind, client, cseq, refseq).
    merge_cols:  per group [12, lanes, Tm] (admit_merge_ops).
    merge_runs:  per group [4, lanes, Tm, RUN_K] or None.
    lww_cols:    per bucket [6, lanes, Tm] (kind, key, val, delta,
                 doc_idx, t_idx).
    Returns (tstate', merge_states', lww_states', flat16, msn32). flat16,
    byte for byte the JAX layout: [seq_delta B*T | msn_delta B*T |
    flags B*T | next_seq (lo B, hi B) | msn_base (lo B, hi B) | msn_ok bit
    | overflow-any bits | per-lane overflow planes (merge then LWW) |
    per-lane occupancy planes (same order) | (paged_scalars) per group
    count, min_seq, seq as int32 halves | (stats) the device_stats
    SERVE_SLOTS plane as int32 halves]; msn32 is the exact [B, T] msn
    plane. `paged_scalars` is the megakernel mode: each merge apply also
    returns the narrow tuple (overflow int16, count, min_seq, seq),
    written by the kernel's extract variant. `plain` composes the plain
    PyTorch versions on any device (the kernels' reference). `stage`, if
    given, is called with each stage's name as it ends: "ticket", then per
    merge group "admit" and "apply_<variant>" (pallas_apply.variant_name),
    then "lww" and "pack"."""
    mark = stage or (lambda _name: None)
    apply = pa.apply_ops_fused_plain if plain else pa.apply_ops_fused
    raw = tk.RawOps(client=ticket_cols[1], client_seq=ticket_cols[2],
                    ref_seq=ticket_cols[3], kind=ticket_cols[0])
    tstate, ticketed = tk.scan_tickets(tstate, raw, require_join=True)
    seq_bt, msn_bt = ticketed.seq, ticketed.min_seq
    mark("ticket")

    if merge_runs is None:
        merge_runs = [None] * len(merge_cols)
    zero = torch.zeros((), dtype=torch.int32, device=seq_bt.device)
    st_kind = [zero] * len(_MERGE_KINDS)
    st_lww = zero
    st_skips = zero
    new_merge, merge_narrow = [], []
    for mstate, mc, mr in zip(merge_states, merge_cols, merge_runs):
        ops2, runs, over_extra = admit_merge_ops(seq_bt, msn_bt, mc, mr)
        if stats:
            st_kind = [s + (ops2.kind == kv).sum(dtype=torch.int32)
                       for s, kv in zip(st_kind, _MERGE_KINDS)]
            if noop_skip:
                st_skips = st_skips + _i32(~(ops2.kind != OpKind.NOOP).any())
        mark("admit")
        if paged_scalars:
            out, nr = apply(mstate, ops2, runs=runs, extract=True)
        else:
            out, nr = apply(mstate, ops2, runs=runs), None
        if over_extra is not None:
            # The voided slot's flag reaches the carried state and the
            # narrow plane the host reads.
            out = out._replace(overflow=out.overflow | over_extra)
            if nr is not None:
                nr = (nr[0] | _i16(over_extra),) + tuple(nr[1:])
        new_merge.append(out)
        merge_narrow.append(nr)
        mark("apply_" + pa.variant_name(runs, paged_scalars))

    new_lww = []
    for lstate, lc in zip(lww_states, lww_cols):
        seq_g = seq_bt[lc[4].long(), lc[5].long()]
        ok = (lc[0] != lk.LwwKind.NOOP) & (seq_g > 0)
        ops = lk.LwwOps(kind=torch.where(ok, lc[0], lk.LwwKind.NOOP),
                        key=lc[1], val=lc[2], delta=lc[3],
                        seq=torch.where(ok, seq_g, 0))
        if stats:
            st_lww = st_lww + (ops.kind != lk.LwwKind.NOOP).sum(
                dtype=torch.int32)
            if noop_skip:
                st_skips = st_skips + _i32(
                    ~(ops.kind != lk.LwwKind.NOOP).any())
        new_lww.append(lk.apply_lww_batched(lstate, ops))
    mark("lww")

    flags = _i32(ticketed.nacked) | (_i32(ticketed.not_joined) << 1)
    bits = [_i32(tstate.overflow.any())[None]]
    bits += [_i32(s.overflow.any())[None] for s in new_merge]
    bits += [_i32(s.overflow.any())[None] for s in new_lww]
    if paged_scalars:
        planes = [nr[0] for nr in merge_narrow]
    else:
        planes = [_i16(s.overflow) for s in new_merge]
    planes += [_i16(s.overflow) for s in new_lww]
    if paged_scalars:
        # int16 view of the group counts; the host adopts the exact int32
        # values from the paged tail below.
        planes += [_i16(nr[1]) for nr in merge_narrow]
    else:
        planes += [_i16(s.count) for s in new_merge]
    planes += [_i16((s.key >= 0).sum(dim=-1)) for s in new_lww]

    admitted = seq_bt > 0
    next32 = _i32(tstate.next_seq)
    seq_d = torch.where(admitted, next32[:, None] - seq_bt, -1)
    big = 1 << 30
    msn_base = torch.where(admitted, msn_bt, big).amin(dim=1)
    msn_base = torch.where(msn_base == big, 0, msn_base)
    msn_d = torch.where(admitted, msn_bt - msn_base[:, None], 0)
    msn_ok = _i32(msn_d.max() < 32000)
    msn_d = torch.clamp(msn_d, max=32000)

    paged_tail = []
    if paged_scalars:
        for nr in merge_narrow:
            paged_tail += halves(nr[1]) + halves(nr[2]) + halves(nr[3])

    stats_tail = []
    if stats:
        def total(xs):
            return sum(xs, zero)
        st_vec = torch.stack(st_kind + [
            st_lww,
            admitted.sum(dtype=torch.int32),
            ticketed.nacked.sum(dtype=torch.int32),
            ticketed.not_joined.sum(dtype=torch.int32),
            total(s.overflow.sum(dtype=torch.int32) for s in new_merge),
            total(s.overflow.sum(dtype=torch.int32) for s in new_lww),
            st_skips,
            total(s.count.sum(dtype=torch.int32) for s in new_merge),
            total((s.key >= 0).sum(dtype=torch.int32) for s in new_lww),
        ])
        assert st_vec.shape == (N_SERVE,)
        stats_tail = halves(st_vec)

    flat16 = torch.cat(
        [_i16(seq_d.reshape(-1)), _i16(msn_d.reshape(-1)),
         _i16(flags.reshape(-1))]
        + halves(next32) + halves(msn_base)
        + [_i16(torch.cat([msn_ok[None]] + bits))]
        + planes + paged_tail + stats_tail)
    mark("pack")
    return tstate, new_merge, new_lww, flat16, msn_bt


def serve_window(tstate, ticket_cols, merge_states, merge_cols, lww_states,
                 lww_cols, merge_runs=None, stats=False):
    """One fast window over capacity buckets (see _serve_window_impl for
    the contract and the flat16 layout). The JAX version donates the
    states; here they are returned as new tensors and the inputs are left
    as they were, so serve_window_keep is the same function."""
    return _serve_window_impl(tstate, ticket_cols, merge_states, merge_cols,
                              lww_states, lww_cols, merge_runs, stats=stats)


serve_window_keep = serve_window


def serve_burst(tstate, merge_states, lww_states, ticket_xs, merge_xs,
                lww_xs, runs_xs, stats=False):
    """K serving windows back to back (the fused serving burst):
    ticket_xs [K, 4, B, T], merge_xs per bucket [K, 12, lanes, Tm],
    lww_xs per bucket [K, 6, lanes, Tm], runs_xs per bucket
    [K, 4, lanes, Tm, RUN_K] or None. Returns (tstate', merge_states',
    lww_states', flat16 [K, flat], msn [K, B, T])."""
    ts, ms, ls = tstate, list(merge_states), list(lww_states)
    flats, msns = [], []
    for k in range(ticket_xs.shape[0]):
        ts, ms, ls, flat16, msn32 = _serve_window_impl(
            ts, ticket_xs[k], ms, [x[k] for x in merge_xs], ls,
            [x[k] for x in lww_xs],
            [None if r is None else r[k] for r in runs_xs],
            noop_skip=True, stats=stats)
        flats.append(flat16)
        msns.append(msn32)
    return ts, ms, ls, torch.stack(flats), torch.stack(msns)


def _serve_megakernel(tstate, pool, lww_states, ticket_xs,
                      page_ids: Sequence[torch.Tensor], counts, min_seqs,
                      seqs, merge_xs, lww_xs, runs_xs, stats=False,
                      plain=False, stage: Stage = None):
    """K fast serving windows over PAGED merge lanes.

    1. gather each group's documents once by page id (kernel.gather_pages:
       the view capacity is the group's page bucket);
    2. run the K stacked windows with _serve_window_impl as the body,
       the gathered views + LWW states + ticket state as the carry; each
       group x window apply is one launch of the fused-apply kernel with
       the extract variant (and the runs variant where the group has run
       columns);
    3. scatter each group's final view back through its page table, in
       place on `pool`.

    page_ids/counts/min_seqs/seqs: per group, [n_pad, p2] int32 tables
    (-1 = padding) and [n_pad] scalars, fixed for the whole ring.
    merge_xs per group [K, 12, n_pad, Tm]; runs_xs per group
    [K, 4, n_pad, Tm, RUN_K] or None; lww_xs per bucket [K, 6, lanes, Tm].
    Returns (tstate', pool', lww_states', flat16_k [K, flat],
    msn_k [K, B, T], pre_views)."""
    mark = stage or (lambda _name: None)
    pre = tuple(kernel.gather_pages(pool, p, c, m, s)
                for p, c, m, s in zip(page_ids, counts, min_seqs, seqs))
    mark("gather")
    ts, ms, ls = tstate, list(pre), list(lww_states)
    flats, msns = [], []
    for k in range(ticket_xs.shape[0]):
        ts, ms, ls, flat16, msn32 = _serve_window_impl(
            ts, ticket_xs[k], ms, [x[k] for x in merge_xs], ls,
            [x[k] for x in lww_xs],
            [None if r is None else r[k] for r in runs_xs],
            noop_skip=True, stats=stats, paged_scalars=True, plain=plain,
            stage=stage)
        flats.append(flat16)
        msns.append(msn32)
    for p, out in zip(page_ids, ms):
        kernel.scatter_pages(pool, p, out)
    mark("scatter")
    return ts, pool, ls, torch.stack(flats), torch.stack(msns), pre


def make_serve_megakernel(keep: bool, plain: bool = False):
    """Build serve_megakernel(tstate, pool, lww_states, ticket_xs,
    page_ids, counts, min_seqs, seqs, merge_xs, lww_xs, runs_xs,
    stats=False, stage=None).

    keep=False scatters into `pool` in place (the JAX donating twin);
    keep=True copies the pool first, so no input changes. plain=True
    composes the plain PyTorch versions on any device: the reference the
    kernels are held to."""

    def serve(tstate, pool, lww_states, ticket_xs, page_ids, counts,
              min_seqs, seqs, merge_xs, lww_xs, runs_xs, stats=False,
              stage: Stage = None):
        if keep:
            pool = type(pool)(*(t.clone() for t in pool))
        return _serve_megakernel(tstate, pool, lww_states, ticket_xs,
                                 page_ids, counts, min_seqs, seqs, merge_xs,
                                 lww_xs, runs_xs, stats=stats, plain=plain,
                                 stage=stage)

    return serve


serve_megakernel = make_serve_megakernel(keep=False)
serve_megakernel_keep = make_serve_megakernel(keep=True)


def flat16_layout(batch: int, steps: int, merge_lanes: Sequence[int],
                  lww_lanes: Sequence[int], paged_scalars: bool,
                  stats: bool) -> dict:
    """Offsets of each section of one window's flat16: {name: (start,
    stop)}. Sections: seq_d, msn_d, flags, next_lo, next_hi, msn_base_lo,
    msn_base_hi, bits, overflow, occupancy, paged_tail, stats."""
    sizes = [("seq_d", batch * steps), ("msn_d", batch * steps),
             ("flags", batch * steps), ("next_lo", batch),
             ("next_hi", batch), ("msn_base_lo", batch),
             ("msn_base_hi", batch),
             ("bits", 2 + len(merge_lanes) + len(lww_lanes)),
             ("overflow", sum(merge_lanes) + sum(lww_lanes)),
             ("occupancy", sum(merge_lanes) + sum(lww_lanes)),
             ("paged_tail", 6 * sum(merge_lanes) if paged_scalars else 0),
             ("stats", 2 * N_SERVE if stats else 0)]
    out, at = {}, 0
    for name, n in sizes:
        out[name] = (at, at + n)
        at += n
    out["total"] = (0, at)
    return out


def paged_scalars_of(flat16, layout: dict, merge_lanes: Sequence[int]):
    """Decode the paged tail of one window's flat16 (numpy int16) into
    per-group exact int32 (count, min_seq, seq) arrays."""
    lo, hi = layout["paged_tail"]
    tail = np.asarray(flat16[lo:hi]).astype(np.int64)
    out, at = [], 0
    for n in merge_lanes:
        vals = []
        for _ in range(3):
            x_lo = tail[at:at + n] & 0xFFFF
            x_hi = tail[at + n:at + 2 * n]
            vals.append((x_lo | (x_hi << 16)).astype(np.int32))
            at += 2 * n
        out.append(tuple(vals))
    return out
