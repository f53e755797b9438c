"""The fast serving flush's device program, and the paged serving
megakernel.

Counterpart of fluidframework_tpu's server/serve_step.py. One window is:
[B, T] deli ticketing for the whole partition, then for each merge group
and each LWW bucket the apply of its admitted ops (each op's assigned
seq/msn gathered from the ticket output by (doc lane, step)), then one
int16 vector (`flat16`) packing everything the host reads back. The
megakernel runs K staged windows over paged merge lanes: gather each page
group's documents once, apply the K windows to the gathered views, scatter
the views back. The paged burst (`serve_paged_burst`) applies K stacked op
chunks to one page group the same way, with no ticketing.

Differences from the JAX program, none of which changes a result:
- the ticketing is one launch of the ticket-scan kernel
  (kernels/csrc/ticket_scan.cu) for CUDA tensors, its plain version for
  CPU tensors and under `plain`; so are each merge group's admission
  (kernels/csrc/window_admit.cu, admit_merge_ops), each LWW bucket's
  admission, apply and occupancy count (kernels/csrc/lww_scan.cu,
  lww_kernel.apply_lww_window) and the flat16 pack
  (kernels/csrc/window_pack.cu, _pack_window);
- `fused` is a plain switch, not a probe. With it (the default) CUDA
  tensors launch the fused-apply kernel (kernels/csrc/fused_apply.cu, the
  runs= and extract=True variants where the megakernel needs them) and CPU
  tensors run its plain version. A merge group whose capacity exceeds
  `max_fused_capacity`, or every group with fused=False (the mesh
  lambda's choice, as JAX's `_fused_serve` is off on a mesh), takes the
  scan apply, as JAX's does (mergetree/kernel._scan_ops:
  kernels/csrc/scan_apply.cu on the card), and its narrow tuple is derived
  from the scan's output;
- states placed on a mesh run each dp shard's lanes on its shard
  (_serve_window_impl);
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

import ctypes
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import build
from ..mergetree import kernel
from ..mergetree import pallas_apply as pa
from ..mergetree.oppack import OpKind, PackedOps, RunCols
from ..parallel.mesh import (P, Sharded, gather, gather_tree, map_dp,
                             note_launch, place, replicate)
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


#: The in-place forms: callable -> the argument positions whose tensors it
#: writes in place (JAX's donate_argnums; the `_keep` twins write nothing).
#: fluidlint's lifecycle rules read this table; nothing reads it at run
#: time.
IN_PLACE_ARGS = {"serve_paged_burst": (0,), "serve_megakernel": (1,)}

_MERGE_KINDS = (OpKind.INSERT, OpKind.REMOVE, OpKind.ANNOTATE,
                OpKind.ACK_INSERT, OpKind.ACK_REMOVE, OpKind.INSERT_RUN)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _i16(x: torch.Tensor) -> torch.Tensor:
    # fluidlint: disable=DTYPE_DRIFT — the narrow int16 wire (flat16)
    return x.to(torch.int16)


def halves(x32: torch.Tensor) -> List[torch.Tensor]:
    """int32 -> [(lo, hi)] int16 halves; lo may land negative in int16
    (bit 15), and the host re-masks it with & 0xFFFF."""
    return [_i16(x32 & 0xFFFF), _i16(x32 >> 16)]


def admit_merge_ops_plain(seq_bt: torch.Tensor, msn_bt: torch.Tensor,
                          mc: torch.Tensor, mr: Optional[torch.Tensor]):
    """Plain PyTorch version of one group's admission: staged merge
    columns -> the ops its apply takes, on any device.

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


def admit_merge_ops(seq_bt: torch.Tensor, msn_bt: torch.Tensor,
                    mc: torch.Tensor, mr: Optional[torch.Tensor]):
    """One group's admission (admit_merge_ops_plain's result): the plain
    version for CPU tensors; for CUDA tensors one launch of
    kernels/csrc/window_admit.cu, or ValueError for tensors it does not
    take. An index into the ticket planes counts from its end when
    negative and clamps into range (JAX's gather rule; the plain version's
    indexing raises on an index out of range). The columns the admission
    does not change are views of `mc` either way."""
    if mc.device.type == "cpu":
        return admit_merge_ops_plain(seq_bt, msn_bt, mc, mr)
    return _admit_launch(seq_bt, msn_bt, mc, mr)


def _on_card(device: torch.device) -> bool:
    """Whether the kernel's tensors may lie on `device`: a CUDA device.
    (The emulator tests, which run the CUDA sources on the CPU, stand in
    for it.)"""
    return device.type == "cuda"


def _check_tensors(what: str, want, device) -> None:
    """Raise ValueError unless each (name, tensor, dtype, shape) has that
    type and shape, is contiguous and lies on `device`, a CUDA device."""
    for name, x, dtype, shape in want:
        if x.dtype != dtype:
            raise ValueError(f"{what}: {name} is {x.dtype}, not {dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, "
                             f"not {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    for name, x, _dtype, _shape in want:
        if not _on_card(x.device) or x.device != device:
            raise ValueError(f"{what}: {name} is on {x.device}, not the "
                             f"CUDA device {device}")


def _admit_launch(seq_bt, msn_bt, mc, mr):
    """One window_admit.cu launch over CUDA tensors, counted in
    admit_merge_ops.launches."""
    if mc.dim() != 3 or seq_bt.dim() != 2 or 0 in mc.shape \
            or 0 in seq_bt.shape:
        raise ValueError(f"admit_merge_ops: the kernel takes [12, lanes, "
                         f"Tm] columns and [B, T] planes, not "
                         f"{tuple(mc.shape)} and {tuple(seq_bt.shape)}")
    _, lanes, tm = mc.shape
    want = [("seq_bt", seq_bt, torch.int32, seq_bt.shape),
            ("msn_bt", msn_bt, torch.int32, seq_bt.shape),
            ("mc", mc, torch.int32, (12, lanes, tm))]
    run_k = 0
    if mr is not None:
        run_k = mr.shape[-1] if mr.dim() == 4 else 0
        want.append(("mr", mr, torch.int32, (4, lanes, tm, max(run_k, 1))))
    _check_tensors("admit_merge_ops", want, mc.device)
    dev = mc.device
    kind, seq, msn = (torch.empty((lanes, tm), dtype=torch.int32,
                                  device=dev) for _ in range(3))
    run_seq = over_extra = None
    if mr is not None:
        run_seq = torch.empty((lanes, tm, run_k), dtype=torch.int32,
                              device=dev)
        over_extra = torch.empty(lanes, dtype=torch.bool, device=dev)
    ptrs = [seq_bt.data_ptr(), msn_bt.data_ptr(), mc.data_ptr(),
            None if mr is None else mr.data_ptr(), kind.data_ptr(),
            seq.data_ptr(), msn.data_ptr(),
            None if run_seq is None else run_seq.data_ptr(),
            None if over_extra is None else over_extra.data_ptr()]
    lib = build.library()
    build.check(lib.fluid_window_admit(
        (ctypes.c_void_p * len(ptrs))(*ptrs), lanes, tm, run_k,
        seq_bt.shape[0], seq_bt.shape[1],
        ctypes.c_void_p(build.stream_handle())), "admit_merge_ops")
    admit_merge_ops.launches += 1
    note_launch("window_admit")
    runs = None if mr is None else RunCols(length=mr[0], seq=run_seq,
                                           op_id=mr[1])
    ops = PackedOps(kind=kind, seq=seq, ref_seq=mc[2], client=mc[3],
                    pos1=mc[4], pos2=mc[5], op_id=mc[6], new_len=mc[7],
                    local_seq=mc[8], msn=msn)
    return ops, runs, over_extra


admit_merge_ops.launches = 0


def _mesh_of(tree):
    """The mesh a tree's first leaf is placed on, or None."""
    leaf = tree[0]
    return leaf.mesh if isinstance(leaf, Sharded) else None


def _serve_window_impl(tstate, ticket_cols, merge_states, merge_cols,
                       lww_states, lww_cols, merge_runs=None,
                       noop_skip=False, stats=False, paged_scalars=False,
                       plain=False, stage: Stage = None, fused=True):
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
    written by the fused kernel's extract variant, or derived from the
    scan apply's output for a group above `max_fused_capacity`. `plain`
    composes the plain PyTorch versions on any device (the kernels'
    reference). `fused=False` takes the scan apply for every group (the
    mesh lambda's choice, as JAX's `_fused_serve` off). `stage`, if given,
    is called with each stage's name as it ends: "ticket", then per merge
    group "admit" and "apply_<variant>" (pallas_apply.variant_name) for
    the fused apply or "apply_scan_<plain|runs>" for the scan apply, then
    "lww" and "pack".

    A ticket state placed on a mesh (parallel/mesh.shard_docs) tickets
    each dp shard's lanes on its shard, and its [B, T] results come to the
    home device (the window's one gather). A merge or LWW state placed on
    the mesh applies each shard's lanes on its shard, from the gathered
    results copied to every shard; a plain state (a paged view gathered
    to the home device) applies there. flat16 and msn32 are built on the
    home device, the same bytes either way."""
    mark = stage or (lambda _name: None)
    fused_fn = pa.apply_ops_fused_plain if plain else pa.apply_ops_fused
    ticket = tk.scan_tickets_plain if plain else tk.scan_tickets

    def tick(ts, tc):
        raw = tk.RawOps(client=tc[1], client_seq=tc[2], ref_seq=tc[3],
                        kind=tc[0])
        return ticket(ts, raw, require_join=True)

    mesh = _mesh_of(tstate)
    if mesh is None:
        tstate, ticketed = tick(tstate, ticket_cols)
    else:
        tstate, ticketed = map_dp(tick, mesh, tstate,
                                  place(ticket_cols, mesh, P(None, "dp")))
        ticketed = gather_tree(ticketed)
        seq_rep = replicate(mesh, ticketed.seq)
        msn_rep = replicate(mesh, ticketed.min_seq)
    seq_bt, msn_bt = ticketed.seq, ticketed.min_seq
    mark("ticket")

    def merge_one(mstate, mc, mr, seq_g, msn_g, mark_admit=mark):
        if plain:
            ops2, runs, over_extra = admit_merge_ops_plain(seq_g, msn_g, mc,
                                                           mr)
        else:
            ops2, runs, over_extra = admit_merge_ops(seq_g, msn_g, mc, mr)
        mark_admit("admit")
        limit = pa.max_fused_capacity(mstate.overlap_slots,
                                      mstate.anno_slots)
        if fused and mstate.capacity <= limit:
            if paged_scalars:
                out, nr = fused_fn(mstate, ops2, runs=runs, extract=True)
            else:
                out, nr = fused_fn(mstate, ops2, runs=runs), None
            name = "apply_" + pa.variant_name(runs, paged_scalars)
        else:
            scan = kernel.scan_ops_plain if plain else kernel._scan_ops
            out = scan(mstate, ops2, batched=True, runs=runs)
            nr = pa.narrow_of(out) if paged_scalars else None
            name = "apply_scan_" + ("plain" if runs is None else "runs")
        if over_extra is not None:
            # The voided slot's flag reaches the carried state and the
            # narrow plane the host reads.
            out = out._replace(overflow=out.overflow | over_extra)
            if nr is not None:
                nr = (nr[0] | _i16(over_extra),) + tuple(nr[1:])
        return out, nr, ops2.kind, name

    def lww_one(lstate, lc, seq_g):
        # (state, admitted kinds, occupancy): one lww_scan.cu launch on
        # the card.
        if plain:
            return lk.apply_lww_window_plain(lstate, lc, seq_g)
        return lk.apply_lww_window(lstate, lc, seq_g)

    if merge_runs is None:
        merge_runs = [None] * len(merge_cols)
    new_merge, merge_narrow, merge_sums = [], [], []
    for mstate, mc, mr in zip(merge_states, merge_cols, merge_runs):
        m_mesh = _mesh_of(mstate)
        if m_mesh is None:
            out, nr, kinds, name = merge_one(mstate, mc, mr, seq_bt, msn_bt)
            over, count = out.overflow, out.count
        else:
            cut = P(None, "dp")
            out, nr, kinds, name = map_dp(
                lambda *a: merge_one(*a, mark_admit=lambda _n: None),
                m_mesh, mstate, place(mc, m_mesh, cut),
                None if mr is None else place(mr, m_mesh, cut),
                seq_rep, msn_rep)
            kinds, over, count = (gather(kinds), gather(out.overflow),
                                  gather(out.count))
            mark("admit")
        new_merge.append(out)
        merge_narrow.append(nr)
        merge_sums.append((over, count, kinds))
        mark(name)

    new_lww, lww_sums = [], []
    for lstate, lc in zip(lww_states, lww_cols):
        l_mesh = _mesh_of(lstate)
        if l_mesh is None:
            out, kinds, occ = lww_one(lstate, lc, seq_bt)
            over = out.overflow
        else:
            out, kinds, occ = map_dp(lww_one, l_mesh, lstate,
                                     place(lc, l_mesh, P(None, "dp")),
                                     seq_rep)
            kinds, occ, over = gather(kinds), gather(occ), \
                gather(out.overflow)
        new_lww.append(out)
        lww_sums.append((over, occ, kinds))
    mark("lww")

    tstate_home = gather_tree(tstate) if mesh is not None else tstate
    pack_args = (tstate_home, ticketed, merge_sums, merge_narrow, lww_sums,
                 noop_skip, stats, paged_scalars)
    if plain:
        flat16 = _pack_window_plain(*pack_args)
    else:
        flat16 = _pack_window(*pack_args)
    mark("pack")
    return tstate, new_merge, new_lww, flat16, msn_bt


def _pack_window_plain(tstate, ticketed, merge_sums, merge_narrow,
                       lww_sums, noop_skip, stats, paged_scalars
                       ) -> torch.Tensor:
    """Plain PyTorch version of the window's flat16 (layout in
    _serve_window_impl) from the ticket state and results and, per merge
    group (overflow, count, kind plane) and per LWW bucket (overflow,
    occupancy, kind plane), all on one device."""
    seq_bt, msn_bt = ticketed.seq, ticketed.min_seq
    zero = torch.zeros((), dtype=torch.int32, device=seq_bt.device)
    flags = _i32(ticketed.nacked) | (_i32(ticketed.not_joined) << 1)
    bits = [_i32(tstate.overflow.any())[None]]
    bits += [_i32(over.any())[None] for over, _, _ in merge_sums]
    bits += [_i32(over.any())[None] for over, _, _ in lww_sums]
    if paged_scalars:
        planes = [nr[0] for nr in merge_narrow]
    else:
        planes = [_i16(over) for over, _, _ in merge_sums]
    planes += [_i16(over) for over, _, _ in lww_sums]
    if paged_scalars:
        # int16 view of the group counts; the host adopts the exact int32
        # values from the paged tail below.
        planes += [_i16(nr[1]) for nr in merge_narrow]
    else:
        planes += [_i16(count) for _, count, _ in merge_sums]
    planes += [_i16(occ) for _, occ, _ in lww_sums]

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

        st_kind = [total((kinds == kv).sum(dtype=torch.int32)
                         for _, _, kinds in merge_sums)
                   for kv in _MERGE_KINDS]
        st_lww = total((kinds != lk.LwwKind.NOOP).sum(dtype=torch.int32)
                       for _, _, kinds in lww_sums)
        st_skips = zero
        if noop_skip:
            st_skips = total(
                [_i32(~(kinds != OpKind.NOOP).any())
                 for _, _, kinds in merge_sums]
                + [_i32(~(kinds != lk.LwwKind.NOOP).any())
                   for _, _, kinds in lww_sums])
        st_vec = torch.stack(st_kind + [
            st_lww,
            admitted.sum(dtype=torch.int32),
            ticketed.nacked.sum(dtype=torch.int32),
            ticketed.not_joined.sum(dtype=torch.int32),
            total(over.sum(dtype=torch.int32) for over, _, _ in merge_sums),
            total(over.sum(dtype=torch.int32) for over, _, _ in lww_sums),
            st_skips,
            total(count.sum(dtype=torch.int32)
                  for _, count, _ in merge_sums),
            total(occ.sum(dtype=torch.int32) for _, occ, _ in lww_sums),
        ])
        assert st_vec.shape == (N_SERVE,)
        stats_tail = halves(st_vec)

    return torch.cat(
        [_i16(seq_d.reshape(-1)), _i16(msn_d.reshape(-1)),
         _i16(flags.reshape(-1))]
        + halves(next32) + halves(msn_base)
        + [_i16(torch.cat([msn_ok[None]] + bits))]
        + planes + paged_tail + stats_tail)


def _pack_window(tstate, ticketed, merge_sums, merge_narrow, lww_sums,
                 noop_skip, stats, paged_scalars) -> torch.Tensor:
    """The window's flat16 (_pack_window_plain's result): the plain
    version for CPU tensors; for CUDA tensors one launch of
    kernels/csrc/window_pack.cu, or ValueError for tensors it does not
    take."""
    if ticketed.seq.device.type == "cpu":
        return _pack_window_plain(tstate, ticketed, merge_sums,
                                  merge_narrow, lww_sums, noop_skip, stats,
                                  paged_scalars)
    return _pack_launch(tstate, ticketed, merge_sums, merge_narrow,
                        lww_sums, noop_skip, stats, paged_scalars)


#: The pack kernel takes at most this many merge groups and LWW buckets
#: together (its pointer table rides in the kernel's parameters).
PACK_MAX_ENTRIES = 32


def _pack_launch(tstate, ticketed, merge_sums, merge_narrow, lww_sums,
                 noop_skip, stats, paged_scalars) -> torch.Tensor:
    """One window_pack.cu launch over CUDA tensors, counted in
    _pack_window.launches."""
    seq_bt = ticketed.seq
    if seq_bt.dim() != 2 or 0 in seq_bt.shape:
        raise ValueError(f"_pack_window: the kernel takes a non-empty "
                         f"[B, T] window, not {tuple(seq_bt.shape)}")
    entries = len(merge_sums) + len(lww_sums)
    if entries > PACK_MAX_ENTRIES:
        raise ValueError(f"_pack_window: the kernel takes at most "
                         f"{PACK_MAX_ENTRIES} groups and buckets, not "
                         f"{entries}")
    b, t = seq_bt.shape
    # fluidlint: disable=DTYPE_DRIFT — the narrow int16 wire (flat16)
    i32, i16, boolean = torch.int32, torch.int16, torch.bool
    want = [("next_seq", tstate.next_seq, i32, (b,)),
            ("tstate.overflow", tstate.overflow, boolean, (b,)),
            ("seq", seq_bt, i32, (b, t)),
            ("min_seq", ticketed.min_seq, i32, (b, t)),
            ("nacked", ticketed.nacked, boolean, (b, t)),
            ("not_joined", ticketed.not_joined, boolean, (b, t))]
    rows = [(over, count, kinds, nr if paged_scalars else None)
            for (over, count, kinds), nr in zip(merge_sums, merge_narrow)]
    rows += [(over, occ, kinds, None) for over, occ, kinds in lww_sums]
    for e, (over, count, kinds, nr) in enumerate(rows):
        n = over.shape[0] if over.dim() == 1 else -1
        tm = kinds.shape[-1] if kinds.dim() == 2 else -1
        want += [(f"entry {e} overflow", over, boolean, (n,)),
                 (f"entry {e} count", count, i32, (n,)),
                 (f"entry {e} kinds", kinds, i32, (n, tm))]
        if nr is not None:
            want += [(f"entry {e} narrow overflow", nr[0], i16, (n,))]
            want += [(f"entry {e} narrow {j}", x, i32, (n,))
                     for j, x in enumerate(nr[1:], 1)]
    _check_tensors("_pack_window", want, seq_bt.device)
    lanes = [over.shape[0] for over, _, _, _ in rows]
    g = len(merge_sums)
    layout = flat16_layout(b, t, lanes[:g], lanes[g:], paged_scalars, stats)
    lib = build.library()
    out = torch.empty(layout["total"][1], dtype=i16, device=seq_bt.device)
    scratch = torch.zeros(lib.fluid_window_pack_scratch_words(), dtype=i32,
                          device=seq_bt.device)
    ptrs = [x.data_ptr() for x in (tstate.next_seq, tstate.overflow, seq_bt,
                                   ticketed.min_seq, ticketed.nacked,
                                   ticketed.not_joined, out, scratch)]
    ints = []
    over_at, occ_at = layout["overflow"][0], layout["occupancy"][0]
    tail_at = layout["paged_tail"][0]
    for e, (over, count, kinds, nr) in enumerate(rows):
        ptrs += [over.data_ptr(), count.data_ptr(), kinds.data_ptr()]
        ptrs += [None] * 4 if nr is None else [x.data_ptr() for x in nr]
        n = lanes[e]
        ints += [n, kinds.shape[-1], int(e >= g), over_at, occ_at, tail_at]
        over_at, occ_at = over_at + n, occ_at + n
        tail_at += 6 * n if nr is not None else 0
    build.check(lib.fluid_window_pack(
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * max(len(ints), 1))(*ints), b, t, entries,
        layout["bits"][0], layout["stats"][0] if stats else -1,
        int(bool(noop_skip)), ctypes.c_void_p(build.stream_handle())),
        "_pack_window")
    _pack_window.launches += 1
    note_launch("window_pack")
    return out


_pack_window.launches = 0


def serve_window(tstate, ticket_cols, merge_states, merge_cols, lww_states,
                 lww_cols, merge_runs=None, stats=False, fused=True):
    """One fast window over capacity buckets (see _serve_window_impl for
    the contract and the flat16 layout). The JAX version donates the
    states; here they are returned as new tensors and the inputs are left
    as they were, so serve_window_keep is the same function."""
    return _serve_window_impl(tstate, ticket_cols, merge_states, merge_cols,
                              lww_states, lww_cols, merge_runs, stats=stats,
                              fused=fused)


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


def _serve_paged_burst(pool, page_ids, counts, min_seqs, seqs,
                       ops_xs: PackedOps, stats=False, plain=False):
    pre = kernel.gather_pages(pool, page_ids, counts, min_seqs, seqs)
    view, over_k, stats_k = pre, [], []
    for k in range(ops_xs.kind.shape[0]):
        ops = PackedOps(*(col[k] for col in ops_xs))
        view = kernel._scan_group(view, ops, plain, kernel.pool_mesh(pool))
        over_k.append(view.overflow)
        if stats:
            stats_k.append(kernel.paged_stats_vec(ops, view))
    kernel.scatter_pages(pool, page_ids, view)
    base = (pool, page_ids, view.count, view.min_seq, view.seq,
            view.overflow, torch.stack(over_k), pre)
    if stats:
        return base + (torch.stack(stats_k),)
    return base


def serve_paged_burst(pool, page_ids, counts, min_seqs, seqs,
                      ops_xs: PackedOps, stats=False, plain=False):
    """K op chunks over one group of PAGED documents (the paged serving
    burst): gather the documents' pages once, apply the K stacked [B, T]
    op chunks (ops_xs fields are [K, B, T]) one after another with the
    gathered view as the carry, scatter the view back into `pool` in
    place. Each chunk is one scan apply (kernel._scan_ops(batched=True):
    scan_apply.cu for CUDA tensors); plain=True runs the plain scan on
    any device. An all-NOOP chunk (K padded to a power of two) is an
    exact identity.

    Returns (pool, page_ids, count, min_seq, seq, overflow, over_k,
    pre_view[, stats_k]): over_k [K, B] is each chunk's overflow plane
    (sticky across chunks), pre_view the gathered pre-burst view that
    rollback_pages scatters back over flagged documents, and stats=True
    appends the per-chunk [K, N_PAGED] plane (kernel.paged_stats_vec)."""
    return _serve_paged_burst(pool, page_ids, counts, min_seqs, seqs,
                              ops_xs, stats, plain)


def serve_paged_burst_keep(pool, page_ids, counts, min_seqs, seqs,
                           ops_xs: PackedOps, stats=False, plain=False):
    """serve_paged_burst on a copy of the pool: no input changes."""
    # fluidlint: disable=MISSING_DONATE — the non-mutating twin: a mesh
    # pool and a risky burst's retry keep the pre-burst pool
    return _serve_paged_burst(kernel._copy_pool(pool), page_ids, counts,
                              min_seqs, seqs, ops_xs, stats, plain)


def _serve_megakernel(tstate, pool, lww_states, ticket_xs,
                      page_ids: Sequence[torch.Tensor], counts, min_seqs,
                      seqs, merge_xs, lww_xs, runs_xs, stats=False,
                      plain=False, stage: Stage = None, fused=True):
    """K fast serving windows over PAGED merge lanes.

    1. gather each group's documents once by page id (kernel.gather_pages:
       the view capacity is the group's page bucket);
    2. run the K stacked windows with _serve_window_impl as the body,
       the gathered views + LWW states + ticket state as the carry; each
       group x window apply is one launch of the fused-apply kernel with
       the extract variant (and the runs variant where the group has run
       columns), or of the scan-apply kernel for a group above
       max_fused_capacity;
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
            stage=stage, fused=fused)
        flats.append(flat16)
        msns.append(msn32)
    for p, out in zip(page_ids, ms):
        kernel.scatter_pages(pool, p, out)
    mark("scatter")
    return ts, pool, ls, torch.stack(flats), torch.stack(msns), pre


def make_serve_megakernel(keep: bool, plain: bool = False):
    """Build serve_megakernel(tstate, pool, lww_states, ticket_xs,
    page_ids, counts, min_seqs, seqs, merge_xs, lww_xs, runs_xs,
    stats=False, stage=None, fused=True).

    keep=False scatters into `pool` in place (the JAX donating twin);
    keep=True copies the pool first, so no input changes. plain=True
    composes the plain PyTorch versions on any device: the reference the
    kernels are held to."""

    def serve(tstate, pool, lww_states, ticket_xs, page_ids, counts,
              min_seqs, seqs, merge_xs, lww_xs, runs_xs, stats=False,
              stage: Stage = None, fused=True):
        if keep:
            # fluidlint: disable=MISSING_DONATE — the non-mutating twin:
            # a mesh pool and a ring holding a risky window keep the pool
            pool = kernel._copy_pool(pool)
        return _serve_megakernel(tstate, pool, lww_states, ticket_xs,
                                 page_ids, counts, min_seqs, seqs, merge_xs,
                                 lww_xs, runs_xs, stats=stats, plain=plain,
                                 stage=stage, fused=fused)

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
