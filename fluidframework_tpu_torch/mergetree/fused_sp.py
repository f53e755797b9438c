"""The fused apply with the capacity axis sharded (counterpart of
fluidframework_tpu's mergetree/fused_sp.py).

The fused formulation (pallas_apply.py) composed with sequence
parallelism: the same batched body (`pallas_apply._apply_one_batched`)
runs on per-shard lane tiles, and the coordination across shards is a few
per-document scalars and boundary rows for each op phase, the partial-length
reduction the reference keeps in its PartialSequenceLengths trees
(packages/dds/merge-tree/src/partialLengths.ts:63).

Two forms, bit-identical to each other, to the single-shard fused
apply and to the scan apply with `sp_shards` (tests/test_torch_fused_sp.py):

- `apply_ops_fused_sp`: one device, the lane context's prefix sum in the
  two-level form (`gspmd_lanes`; kernel._cumsum_sp's blocks). In JAX the
  form is a hint that lets GSPMD keep the inner cumsum shard-local.
- `apply_ops_fused_shardmap`: explicit, over a mesh. Each grid entry holds
  its tile ([B/dp, C/sp] planes) on its own device. Only the lane context
  (`shard_lanes`) crosses tiles: psum and pmin for the any / first /
  masked-sum reductions, the two-level all-gathered scan for visibility,
  and one batched boundary exchange carrying the shifted rows of every
  plane for each structural shift. Every cross-shard message is O(B)
  scalars or O(B * shift) boundary rows, never the table.

JAX compiles both as XLA programs. Here, for CUDA tensors, the mesh form
launches kernels/csrc/fused_sp.cu once per dp row, on that row's device:
each document is a thread-block cluster whose ranks are the tiles, read
and written where they lie, and the lane context crosses them through
distributed shared memory (the kernel's header). The one-device form
launches kernels/csrc/scan_apply.cu through kernel.scan_apply, whose
kernel computes it as it is (its sp_shards names only the formulation of
the prefix sums). For CPU tensors both run the plain versions, `apply_ops_fused_sp_plain` and `apply_ops_fused_shardmap_plain`
(whose mesh form runs the body once over all tiles in lockstep: `Tiles`,
every torch call applied part by part, the lane context crossing tiles by
explicit copies within each dp row). Anything else raises ValueError.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional

import torch

from ..kernels import build
from ..parallel.mesh import (Mesh, P, from_blocks, gather_tree, is_sharded,
                             note_launch, on_shard, place, row_all_gather,
                             row_permute, row_reduce)
from . import pallas_apply as pa
from .kernel import (LIVE_THREADS, MAX_CLUSTER, SMEM_LIMIT_BYTES,
                     _check_scan_shape, _on_device, scan_apply,
                     shared_table_bytes)
from .oppack import RUN_K, PackedOps, RunCols
from .state import DocState


# ---------------------------------------------------------------------------
# one device: the two-level prefix sum
# ---------------------------------------------------------------------------

def _two_level_cumsum_excl(sp_shards: int):
    def cumsum_excl(x):
        b, c = x.shape
        if sp_shards <= 1 or c % sp_shards:
            return torch.cumsum(x, dim=1, dtype=torch.int32) - x
        local = torch.cumsum(x.reshape(b, sp_shards, c // sp_shards),
                             dim=2, dtype=torch.int32)
        totals = local[..., -1]
        offsets = torch.cumsum(totals, dim=1, dtype=torch.int32) - totals
        return (local + offsets[..., None]).reshape(b, c) - x

    return cumsum_excl


def gspmd_lanes(total: int, sp_shards: int) -> pa.Lanes:
    """Whole-axis lane primitives with the prefix sum in sp_shards
    blocks plus an exclusive scan of the block totals."""
    return pa.local_lanes(total)._replace(
        cumsum_excl=_two_level_cumsum_excl(sp_shards))


def _fused_sp_body(state: DocState, ops: PackedOps, sp_shards: int,
                   runs=None) -> DocState:
    k, a = state.overlap_slots, state.anno_slots
    fields, cols = pa.op_cols(ops, runs)
    st = pa._stream_loop(pa._to_planes(state), ops.steps, fields, cols, k,
                         a, gspmd_lanes(state.capacity, sp_shards),
                         runs is not None)
    return pa._from_planes(st, k, a)


def apply_ops_fused_sp_plain(state: DocState, ops: PackedOps,
                             sp_shards: int, runs=None) -> DocState:
    """Plain PyTorch version of apply_ops_fused_sp: the fused formulation
    with the two-level prefix sums, on one device, any shape. Leaves its
    input as it was."""
    return _fused_sp_body(state, ops, sp_shards, runs)


# ---------------------------------------------------------------------------
# a mesh: per-shard tiles in lockstep, explicit exchanges
# ---------------------------------------------------------------------------

def _count(tree) -> int:
    if isinstance(tree, Tiles):
        return len(tree.parts)
    if isinstance(tree, (list, tuple)):
        for x in tree:
            n = _count(x)
            if n:
                return n
    if isinstance(tree, dict):
        return _count(list(tree.values()))
    return 0


def _pick(tree, i: int):
    if isinstance(tree, Tiles):
        return tree.parts[i]
    if isinstance(tree, (list, tuple)):
        return type(tree)(_pick(x, i) for x in tree)
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree


class Tiles:
    """One value of the tile body: a part per grid entry (row-major over
    (dp, sp)), each on its entry's device. Torch functions, operators and
    tensor methods apply part by part, so the fused body runs once over
    every tile in lockstep; only the lane context moves data between
    parts."""

    __slots__ = ("parts",)
    __hash__ = None

    def __init__(self, parts):
        self.parts = list(parts)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        n = _count((args, kwargs))
        return cls([func(*_pick(args, i), **_pick(kwargs, i))
                    for i in range(n)])

    def __getattr__(self, name):
        values = [getattr(p, name) for p in self.parts]

        def method(*args, **kwargs):
            return Tiles([v(*_pick(args, i), **_pick(kwargs, i))
                          for i, v in enumerate(values)])
        return method


def _part_op(name):
    def op(self, *args):
        return Tiles([getattr(p, name)(*_pick(args, i))
                      for i, p in enumerate(self.parts)])
    op.__name__ = name
    return op


for _name in ("__and__", "__rand__", "__or__", "__ror__", "__xor__",
              "__invert__", "__eq__", "__ne__", "__lt__", "__le__",
              "__gt__", "__ge__", "__add__", "__radd__", "__sub__",
              "__rsub__", "__mul__", "__rmul__", "__neg__", "__getitem__",
              "__lshift__", "__rshift__"):
    setattr(Tiles, _name, _part_op(_name))


def shard_lanes(mesh: Mesh, total: int, local_width: int,
                stats: dict) -> pa.Lanes:
    """Lane primitives over [B/dp, C/sp] tiles. Per-document scalars
    (slots, any / masked reductions) come out of psum / pmin within each
    dp row, so every tile of a row holds the same copy and the scalar
    planes (count, seq, ...) evolve alike on each. `stats` counts the
    boundary exchanges and the collectives."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    grid = [(i, j) for i in range(dp) for j in range(sp)]
    iotas = Tiles(j * local_width + torch.arange(
        local_width, dtype=torch.int32, device=mesh.device(i, j))
        for i, j in grid)

    def per_row(parts: List[torch.Tensor], fn) -> Tiles:
        out = []
        for i in range(dp):
            out.extend(fn(parts[i * sp:(i + 1) * sp], i))
        stats["collectives"] += 1
        return Tiles(out)

    def reduce(parts, op) -> Tiles:
        return per_row(parts, lambda row, i: row_reduce(mesh, row, i, op))

    def first_true(m: Tiles) -> Tiles:
        local = [torch.where(p, it, total).amin(dim=1, keepdim=True)
                 for p, it in zip(m.parts, iotas.parts)]
        return reduce(local, torch.minimum)

    def masked_scalar(v: Tiles, m: Tiles) -> Tiles:
        local = [torch.where(mp, vp, 0).sum(dim=1, keepdim=True,
                                            dtype=torch.int32)
                 for vp, mp in zip(v.parts, m.parts)]
        return reduce(local, torch.add)

    def cumsum_excl(x: Tiles) -> Tiles:
        # The two-level collective scan (parallel/seq_scan.py): local
        # cumsum + all-gathered shard totals, masked to my predecessors.
        incl = [torch.cumsum(p, dim=1, dtype=torch.int32) for p in x.parts]
        totals = [c[:, -1:] for c in incl]

        def row(parts, i):
            out = []
            for j in range(sp):
                seen = row_all_gather(mesh, parts, i, j)
                acc = incl[i * sp + j]
                for t in seen[:j]:
                    acc = acc + t
                out.append(acc - x.parts[i * sp + j])
            return out
        return per_row(totals, row)

    def roll_many(xs: List[Tiles], n: int) -> List[Tiles]:
        # One exchange for the whole plane set: the n boundary columns of
        # every plane stacked into one [P, B, n] message per tile. The wrap
        # from the last shard into shard 0 is jnp.roll's cyclic wrap; the
        # caller's masked fills always overwrite those lanes, as in the
        # single-shard roll.
        if n >= local_width:
            raise ValueError(f"shift {n} >= shard tile {local_width}: raise "
                             f"capacity or lower sp")
        tails = [torch.stack([x.parts[g][:, local_width - n:] for x in xs])
                 for g in range(len(grid))]
        incoming = []
        for i in range(dp):
            incoming.extend(row_permute(mesh, tails[i * sp:(i + 1) * sp],
                                        i))
        stats["exchanges"] += 1
        return [Tiles(torch.cat([incoming[g][m], x.parts[g][:, :-n]],
                                dim=1) for g in range(len(grid)))
                for m, x in enumerate(xs)]

    return pa.Lanes(
        total=total,
        iota=lambda _x: iotas,
        any_lane=lambda m: reduce(
            [p.any(dim=1, keepdim=True) for p in m.parts],
            torch.logical_or),
        first_true=first_true,
        masked_scalar=masked_scalar,
        cumsum_excl=cumsum_excl,
        roll=lambda x, n: roll_many([x], n)[0],
        roll_many=roll_many,
    )


def _tiles(x, mesh: Mesh, spec, plane=None) -> Tiles:
    """The blocks of `x` placed under `spec`, one part per grid entry
    (the plane-th slot of a [B, C, K] leaf when `plane` is given)."""
    xs = place(x, mesh, spec)
    parts = [xs.block(i, j) for i in range(mesh.shape["dp"])
             for j in range(mesh.shape["sp"])]
    if plane is not None:
        parts = [p[..., plane] for p in parts]
    return Tiles(parts)


def _grid(mesh: Mesh, parts: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    sp = mesh.shape["sp"]
    return [[p.contiguous() for p in parts[i * sp:(i + 1) * sp]]
            for i in range(mesh.shape["dp"])]


def apply_ops_fused_shardmap_plain(state: DocState, ops: PackedOps,
                                   mesh: Mesh, runs=None,
                                   dp_axis: str = "dp",
                                   sp_axis: str = "sp") -> DocState:
    """Plain PyTorch version of apply_ops_fused_shardmap: the fused body
    once over every tile in lockstep (`Tiles`), the lane context crossing
    the tiles by explicit copies. `state` and `ops` are tensors or
    Sharded; returns a DocState of Sharded leaves (lane planes
    P('dp', 'sp'), per-document scalars P('dp')) and leaves its input as it
    was. Counts its structural-shift exchanges, collectives and op steps
    in apply_ops_fused_shardmap.exchanges / .collectives / .ops."""
    if (dp_axis, sp_axis) != ("dp", "sp"):
        raise ValueError("the port's meshes name their axes ('dp', 'sp')")
    sp = mesh.shape[sp_axis]
    b, c = state.length.shape
    if c % sp:
        raise ValueError(f"capacity {c} not divisible by sp={sp}")
    k, a = state.overlap_slots, state.anno_slots
    lane_spec, row_spec = P("dp", "sp"), P("dp", None)
    st = {name: _tiles(getattr(state, name), mesh, lane_spec)
          for name in pa._SEG_PLANES}
    for i in range(k):
        st[f"rc{i}"] = _tiles(state.rem_clients, mesh,
                              P("dp", "sp", None), plane=i)
    for i in range(a):
        st[f"an{i}"] = _tiles(state.anno, mesh, P("dp", "sp", None),
                              plane=i)
    for name in ("count", "min_seq", "seq", "overflow"):
        st[name] = _tiles(getattr(state, name), mesh, P("dp"))[:, None]
    if is_sharded(runs):
        runs = gather_tree(runs)
    fields, cols = pa.op_cols(ops, runs)
    col_tiles = {f: _tiles(cols[f], mesh, row_spec) for f in fields}

    stats = {"exchanges": 0, "collectives": 0}
    ln = shard_lanes(mesh, c, c // sp, stats)
    out = pa._stream_loop(st, ops.steps, fields, col_tiles, k, a, ln,
                          runs is not None)
    apply_ops_fused_shardmap.exchanges += stats["exchanges"]
    apply_ops_fused_shardmap.collectives += stats["collectives"]
    apply_ops_fused_shardmap.ops += ops.steps

    def lanes(name):
        return from_blocks(mesh, lane_spec, _grid(mesh, out[name].parts))

    def slots(prefix, n):
        parts = [torch.stack([out[f"{prefix}{i}"].parts[g]
                              for i in range(n)], -1)
                 for g in range(len(out["length"].parts))]
        return from_blocks(mesh, P("dp", "sp", None), _grid(mesh, parts))

    def scalar(name):
        return from_blocks(mesh, P("dp"), _grid(
            mesh, [p[:, 0] for p in out[name].parts]))

    return DocState(
        **{name: lanes(name) for name in pa._SEG_PLANES},
        rem_clients=slots("rc", k), anno=slots("an", a),
        count=scalar("count"), min_seq=scalar("min_seq"),
        seq=scalar("seq"), overflow=scalar("overflow"))


# ---------------------------------------------------------------------------
# the kernel wrappers (kernels/csrc/fused_sp.cu)
# ---------------------------------------------------------------------------

class SpGeometry(NamedTuple):
    """How one fused-sp launch is laid out on the card."""
    blocks: int      # per document: the cluster's ranks
    tile: int        # slots each rank holds, C / blocks
    threads: int     # per block
    smem_bytes: int  # dynamic shared memory per block


def sp_geometry(capacity: int, k_slots: int, a_slots: int,
                blocks: int) -> SpGeometry:
    """The geometry of a fused-sp launch over tables of capacity C in
    clusters of `blocks` ranks: a rank's tile in its shared memory as
    scan_apply.cu's cluster path lays it out (kernel.shared_table_bytes),
    threads the tile rounded up to 32, at most kernel.LIVE_THREADS.
    Raises ValueError outside 1..MAX_CLUSTER ranks, outside the scan
    kernel's K, A and C, or where a tile passes SMEM_LIMIT_BYTES."""
    _check_scan_shape(capacity, k_slots, a_slots)
    if not 1 <= blocks <= MAX_CLUSTER:
        raise ValueError(f"fused_sp: sp={blocks} ranks; a cluster on one "
                         f"card takes 1..{MAX_CLUSTER}")
    tile = -(-capacity // blocks)
    smem = shared_table_bytes(capacity, k_slots, a_slots, blocks)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"fused_sp: a tile of {tile} slots (C={capacity} over {blocks} "
            f"ranks, K={k_slots}, A={a_slots}) needs {smem} bytes of "
            f"shared memory, above SMEM_LIMIT_BYTES={SMEM_LIMIT_BYTES}")
    return SpGeometry(blocks, tile, min(-(-tile // 32) * 32, LIVE_THREADS),
                      smem)


def _device_of(device) -> torch.device:
    """`device` with its index: a CUDA device named without one is the
    current CUDA device, as torch places a tensor there."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _check_tensor(what: str, t: torch.Tensor, shape, dtype,
                  device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() \
            or _device_of(t.device) != _device_of(device):
        raise ValueError(
            f"fused_sp: {what} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device} (got {t.dtype} "
            f"{tuple(t.shape)} on {t.device})")


def _check_columns(ops: PackedOps, runs: Optional[RunCols], b: int,
                   device: torch.device) -> None:
    for name, t in zip(PackedOps._fields, ops):
        _check_tensor(f"ops.{name}", t, (b, ops.steps), torch.int32, device)
    for name, t in zip(RunCols._fields, runs or ()):
        _check_tensor(f"runs.{name}", t, (b, ops.steps, RUN_K), torch.int32,
                      device)


_LEAVES = pa._SEG_PLANES + ("rem_clients", "anno")
_SCALARS = ("count", "min_seq", "seq", "overflow")


def apply_ops_fused_sp(state: DocState, ops: PackedOps, sp_shards: int,
                       runs: Optional[RunCols] = None) -> DocState:
    """The fused formulation with the two-level prefix sums on one device:
    [B, T] op streams (and [B, T, RUN_K] runs) applied to B documents,
    into a new state; the input is left as it was. For CPU tensors the
    plain version; for CUDA tensors kernel.scan_apply (kernels/csrc/
    scan_apply.cu on its measured geometry, any capacity): sp_shards only
    names the prefix sums' formulation, the same integer sum, so the scan
    apply's kernel computes this form as it is. Anything else raises
    ValueError."""
    dev = state.length.device
    if dev.type == "cpu":
        return apply_ops_fused_sp_plain(state, ops, sp_shards, runs)
    if dev.type != "cuda":
        raise ValueError(f"fused_sp: the state is on {dev}: the kernel "
                         "takes CUDA tensors, the plain version CPU ones")
    return scan_apply(state, ops, runs, sp_shards)


def apply_ops_fused_shardmap(state: DocState, ops: PackedOps, mesh: Mesh,
                             runs: Optional[RunCols] = None,
                             dp_axis: str = "dp",
                             sp_axis: str = "sp") -> DocState:
    """The fused apply over `mesh` with the capacity axis sharded over
    `sp_axis` and the documents over `dp_axis`. `state`, `ops` and `runs`
    are tensors or Sharded; returns a DocState of Sharded leaves (lane
    planes P('dp', 'sp'), per-document scalars P('dp')) and leaves its
    input as it was. On a mesh of CUDA entries, launch_shardmap (one
    launch of kernels/csrc/fused_sp.cu per dp row); on a mesh of CPU
    entries, the plain version; any other mesh raises ValueError."""
    if (dp_axis, sp_axis) != ("dp", "sp"):
        raise ValueError("the port's meshes name their axes ('dp', 'sp')")
    kinds = {torch.device(d).type for d in mesh.devices.reshape(-1)}
    if kinds == {"cpu"}:
        return apply_ops_fused_shardmap_plain(state, ops, mesh, runs)
    if kinds != {"cuda"}:
        raise ValueError(f"fused_sp: the mesh's entries "
                         f"{list(mesh.devices.reshape(-1))} must all be "
                         "CUDA devices (the kernel) or all CPU (the plain "
                         "version)")
    return launch_shardmap(state, ops, mesh, runs)


def launch_shardmap(state: DocState, ops: PackedOps, mesh: Mesh,
                    runs: Optional[RunCols] = None) -> DocState:
    """apply_ops_fused_shardmap's kernel path, whatever the mesh's device
    type: one launch of fused_sp.cu per dp row, on that row's device, a
    cluster of sp ranks per document, rank j on tile (i, j), read and
    written where it lies; every tile of the row gets its copy of the
    scalars, which the kernel reads from the row's first tile. Refused
    with ValueError before any launch: C % sp != 0, a shift (1, or RUN_K
    with runs) as wide as the tile, sp above MAX_CLUSTER, a tile whose
    planes and view planes pass SMEM_LIMIT_BYTES, a dp row over more than
    one device (no cluster spans cards; the sp form across cards is not
    ported). Counted in the module's `launches`, and under each row's
    first shard by parallel.mesh.note_launch."""
    global launches
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    b, c = state.length.shape
    if c % sp:
        raise ValueError(f"capacity {c} not divisible by sp={sp}")
    k, a = state.overlap_slots, state.anno_slots
    tile = c // sp
    shift = RUN_K if runs is not None else 1
    if ops.steps and shift >= tile:
        raise ValueError(f"shift {shift} >= shard tile {tile}: raise "
                         f"capacity or lower sp")
    geo = sp_geometry(c, k, a, sp)
    for i in range(dp):
        row = {_device_of(mesh.device(i, j)) for j in range(sp)}
        if len(row) > 1:
            raise ValueError(
                f"fused_sp: dp row {i} lies on {sorted(map(str, row))}: a "
                "cluster runs on one card, and the sp form across cards "
                "is not ported")
    lane_spec, slot_spec = P("dp", "sp"), P("dp", "sp", None)
    lanes = {name: place(getattr(state, name), mesh, lane_spec)
             for name in pa._SEG_PLANES}
    lanes["rem_clients"] = place(state.rem_clients, mesh, slot_spec)
    lanes["anno"] = place(state.anno, mesh, slot_spec)
    scalars = {name: place(getattr(state, name), mesh, P("dp"))
               for name in _SCALARS}
    cols = PackedOps(*(place(x, mesh, P("dp", None)) for x in ops))
    if runs is not None:
        runs = RunCols(*(place(x, mesh, P("dp", None, None)) for x in runs))
    rows = b // dp
    out_lanes = {name: [] for name in _LEAVES}
    out_scalars = {name: [] for name in _SCALARS}
    for i in range(dp):
        dev = mesh.device(i, 0)
        ins = {name: [x.block(i, j) for j in range(sp)]
               for name, x in lanes.items()}
        for name, blocks in ins.items():
            per = (getattr(state, name).shape[2],) \
                if name in ("rem_clients", "anno") else ()
            for j, t in enumerate(blocks):
                _check_tensor(f"tile ({i}, {j}) of state.{name}", t,
                              (rows, tile) + per, torch.int32, dev)
        outs = {name: [torch.empty_like(t) for t in blocks]
                for name, blocks in ins.items()}
        sc_out = {name: [torch.empty_like(x.block(i, j)) for j in range(sp)]
                  for name, x in scalars.items()}
        sc_in = [scalars[name].block(i, 0) for name in _SCALARS]
        for name, t in zip(_SCALARS, sc_in):
            _check_tensor(f"state.{name} of row {i}", t, (rows,),
                          torch.bool if name == "overflow" else torch.int32,
                          dev)
        row_ops = PackedOps(*(x.block(i, 0) for x in cols))
        row_runs = None if runs is None else \
            RunCols(*(x.block(i, 0) for x in runs))
        _check_columns(row_ops, row_runs, rows, dev)
        with on_shard(mesh, i, 0), _on_device(dev):
            # The tile table (addresses, leaf by leaf, rank by rank; then
            # the output scalars, copy by copy) goes to the device as an
            # int64 tensor, the scalars and columns as pointers.
            table = torch.tensor(
                [t.data_ptr() for name in _LEAVES for t in ins[name]]
                + [t.data_ptr() for name in _LEAVES for t in outs[name]]
                + [t.data_ptr() for name in _SCALARS
                   for t in sc_out[name]], dtype=torch.int64).to(dev)
            ptrs = [t.data_ptr() for t in (*sc_in, *row_ops,
                                           *(row_runs or ()))]
            arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
            lib = build.library()
            launches += 1
            note_launch("fused_sp")
            build.check(lib.fluid_fused_sp(
                arr, ctypes.c_void_p(table.data_ptr()), rows, c, k, a,
                ops.steps, int(runs is not None), geo.blocks, geo.threads,
                geo.smem_bytes, ctypes.c_void_p(build.stream_handle())),
                "fused_sp")
        for name in _LEAVES:
            out_lanes[name].append(outs[name])
        for name in _SCALARS:
            out_scalars[name].append(sc_out[name])
    return DocState(
        **{name: from_blocks(mesh, lane_spec, out_lanes[name])
           for name in pa._SEG_PLANES},
        rem_clients=from_blocks(mesh, slot_spec, out_lanes["rem_clients"]),
        anno=from_blocks(mesh, slot_spec, out_lanes["anno"]),
        **{name: from_blocks(mesh, P("dp"), out_scalars[name])
           for name in _SCALARS})


def reset_counts() -> None:
    """Zero fused_sp.cu's launch count (the module's `launches`) and
    apply_ops_fused_shardmap's exchange, collective and op counts (the
    plain mesh form's)."""
    global launches
    launches = 0
    apply_ops_fused_shardmap.exchanges = 0
    apply_ops_fused_shardmap.collectives = 0
    apply_ops_fused_shardmap.ops = 0


launches = 0
reset_counts()
