"""Device meshes and sharded leaves (counterpart of fluidframework_tpu's
parallel/mesh.py).

One process drives every device of a mesh, as JAX's single controller
does: a `Mesh` is a [dp, sp] grid of torch devices, and the devices may
repeat (eight entries of `cpu` in the tests, four entries of `cuda:0` on
one card, `cuda:0..3` on a host with four). Documents shard over 'dp'
(the lane or page axis of every batch); the capacity axis of a long
document can shard over 'sp', and only where its width divides evenly.

A sharded leaf (`Sharded`) is one tensor per grid entry, each on its
entry's device: the dp axis cuts the leaf's dp-named axis into dp equal
blocks, the sp axis its sp-named axis; an axis that names no mesh axis is
whole in every block, so a leaf that does not name 'sp' is held once per
entry of its dp row. Code touches shards only through `place` /
`shard_docs` / `replicate`, `gather` (back to one tensor), `take_rows` /
`set_rows` (a gather / scatter of leading-axis rows through their owning
shards), `map_dp` (a function run once per dp shard on its blocks) and the
explicit collectives below. Every transfer of a block between a shard and
another grid entry or the dispatching device is one copy, counted in
`Mesh.copies`; on one card such a copy stays on the card.

Kernel launches name their shard: `map_dp` and `on_shard` set the current
shard, and each kernel wrapper calls `note_launch`, which counts the
launch under (kernel, shard) in `shard_launches`.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

AXES = ("dp", "sp")


class PartitionSpec(tuple):
    """Which mesh axis cuts each axis of a leaf (None: not cut). Its str()
    is JAX's, so spec tables compare across the packages."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__

    def normalized(self) -> "PartitionSpec":
        """The spec without trailing Nones (P('dp', None) is P('dp'))."""
        axes = list(self)
        while axes and axes[-1] is None:
            axes.pop()
        return PartitionSpec(*axes)


P = PartitionSpec


class Mesh:
    """A [dp, sp] grid of torch devices with axis names ("dp", "sp");
    `shape` is a dict, as JAX's."""

    def __init__(self, devices: np.ndarray, axis_names=AXES):
        if devices.ndim != 2 or tuple(axis_names) != AXES:
            raise ValueError("a mesh is a [dp, sp] grid named ('dp', 'sp')")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, devices.shape))
        self.copies = 0  # block transfers made by gathers and collectives

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def home(self) -> torch.device:
        """The dispatching device: grid entry (0, 0)."""
        return self.devices[0, 0]

    def device(self, i: int, j: int = 0) -> torch.device:
        return self.devices[i, j]

    def flat(self, i: int, j: int = 0) -> int:
        """The shard index of grid entry (i, j), row-major."""
        return i * self.shape["sp"] + j

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, " \
            f"devices={[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(dp: Optional[int] = None, sp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A [dp, sp] mesh over `devices` (torch devices or their names; they
    may repeat). None means every visible CUDA device, and raises when
    there is none: there is no CPU fallback, so a CPU mesh names its
    devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(): CUDA is not available; a mesh defaults to "
                "every visible CUDA device. Pass devices=[...] (a list of "
                "'cpu' entries runs the plain versions)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp({dp}) x sp({sp}) != device count {n}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, sp))


# ---------------------------------------------------------------------------
# sharded leaves
# ---------------------------------------------------------------------------

class Sharded:
    """One leaf sharded over a mesh: `blocks[i][j]` is the block grid entry
    (i, j) holds, on `mesh.device(i, j)`. `shape` is the global shape."""

    __slots__ = ("mesh", "spec", "blocks", "shape", "dtype")

    def __init__(self, mesh: Mesh, spec: PartitionSpec,
                 blocks: List[List[torch.Tensor]], shape):
        self.mesh = mesh
        self.spec = spec
        self.blocks = blocks
        self.shape = torch.Size(shape)
        self.dtype = blocks[0][0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return len(self.shape)

    def block(self, i: int, j: int = 0) -> torch.Tensor:
        return self.blocks[i][j]

    @property
    def device_set(self) -> set:
        return {b.device for row in self.blocks for b in row}

    def __repr__(self) -> str:
        return f"Sharded({tuple(self.shape)}, {self.spec}, {self.dtype})"


def _cut(shape, spec: PartitionSpec, mesh: Mesh) -> List[Optional[str]]:
    axes = list(spec) + [None] * (len(shape) - len(spec))
    if len(axes) > len(shape):
        raise ValueError(f"spec {spec} has more axes than shape "
                         f"{tuple(shape)}")
    for ax, name in enumerate(axes):
        if name is None:
            continue
        if name not in mesh.shape:
            raise ValueError(f"spec {spec} names unknown mesh axis {name!r}")
        if shape[ax] % mesh.shape[name]:
            raise ValueError(
                f"axis {ax} of shape {tuple(shape)} is not divisible by "
                f"{name}={mesh.shape[name]} (spec {spec})")
    return axes


def _block_index(shape, axes, mesh: Mesh, i: int, j: int) -> tuple:
    sl = []
    for ax, name in enumerate(axes):
        if name is None:
            sl.append(slice(None))
            continue
        w = shape[ax] // mesh.shape[name]
        k = i if name == "dp" else j
        sl.append(slice(k * w, (k + 1) * w))
    return tuple(sl)


def _copy_to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A fresh contiguous copy of `x` on `device` (never a view of x)."""
    return x.to(device, copy=True).contiguous()


def place(x, mesh: Mesh, spec: PartitionSpec) -> Sharded:
    """`x` (a tensor, numpy array or Sharded) placed on `mesh` under
    `spec`. A Sharded already so placed comes back as it is; any other is
    gathered and cut again."""
    if isinstance(x, Sharded):
        if x.mesh is mesh and x.spec.normalized() == spec.normalized():
            return x
        x = gather(x)
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    axes = _cut(x.shape, spec, mesh)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    blocks = [[_copy_to(x[_block_index(x.shape, axes, mesh, i, j)],
                        mesh.device(i, j))
               for j in range(sp)] for i in range(dp)]
    mesh.copies += dp * sp
    return Sharded(mesh, PartitionSpec(*spec), blocks, x.shape)


def from_blocks(mesh: Mesh, spec: PartitionSpec,
                blocks: List[List[torch.Tensor]]) -> Sharded:
    """A Sharded from blocks already on their entries' devices."""
    axes = list(spec)
    shape = list(blocks[0][0].shape)
    for ax, name in enumerate(axes):
        if name is not None:
            shape[ax] *= mesh.shape[name]
    return Sharded(mesh, spec, blocks, shape)


def gather(x, device=None):
    """`x` as one tensor on `device` (default the mesh's home device). A
    tensor comes back as it is (moved to `device` when one is named)."""
    if not isinstance(x, Sharded):
        return x if device is None or not isinstance(x, torch.Tensor) \
            else x.to(device)
    mesh = x.mesh
    dev = torch.device(device) if device is not None else mesh.home
    axes = list(x.spec) + [None] * (x.ndim - len(x.spec))
    dp_ax = axes.index("dp") if "dp" in axes else None
    sp_ax = axes.index("sp") if "sp" in axes else None
    rows = range(mesh.shape["dp"]) if dp_ax is not None else range(1)
    cols = range(mesh.shape["sp"]) if sp_ax is not None else range(1)
    parts = []
    for i in rows:
        row = [x.block(i, j).to(dev) for j in cols]
        parts.append(torch.cat(row, dim=sp_ax) if sp_ax is not None
                     else row[0])
    mesh.copies += len(rows) * len(cols)
    out = torch.cat(parts, dim=dp_ax) if dp_ax is not None else parts[0]
    return out.contiguous()


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of NamedTuples, dicts, lists and tuples (None
    stays None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def gather_tree(tree, device=None):
    return tree_map(lambda x: gather(x, device), tree)


def is_sharded(tree) -> bool:
    """True when some leaf of `tree` is a Sharded."""
    found = []
    tree_map(lambda x: found.append(isinstance(x, Sharded)), tree)
    return any(found)


def doc_spec(x, mesh: Mesh, seq_sharded: bool = False) -> PartitionSpec:
    """shard_docs' spec for one leaf: the leading axis over 'dp'; with
    seq_sharded, the second (capacity) axis of a rank >= 2 leaf over 'sp'
    when it divides evenly (small side tables replicate along sp)."""
    if len(x.shape) == 0:
        return P()
    spec = [None] * len(x.shape)
    spec[0] = "dp"
    sp = mesh.shape["sp"]
    if seq_sharded and len(x.shape) >= 2 and sp > 1 \
            and x.shape[1] % sp == 0:
        spec[1] = "sp"
    return P(*spec)


def shard_docs(mesh: Mesh, state, seq_sharded: bool = False):
    """Place a batched tree: every leaf's leading axis over 'dp'; with
    seq_sharded, the capacity axis of rank >= 2 leaves over 'sp'."""
    return tree_map(lambda x: place(x, mesh, doc_spec(x, mesh, seq_sharded)),
                    state)


def replicate(mesh: Mesh, tree):
    """Every leaf whole on every grid entry."""
    return tree_map(lambda x: place(x, mesh, P()), tree)


# ---------------------------------------------------------------------------
# the current shard and launches per shard
# ---------------------------------------------------------------------------

_current = threading.local()


def current_shard() -> Optional[int]:
    return getattr(_current, "shard", None)


@contextlib.contextmanager
def on_shard(mesh: Mesh, i: int, j: int = 0):
    """Run the body as shard (i, j): launches are counted under its
    index, and a CUDA entry's device is the current CUDA device."""
    prev = current_shard()
    _current.shard = mesh.flat(i, j)
    dev = mesh.device(i, j)
    try:
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                yield
        else:
            yield
    finally:
        _current.shard = prev


def note_launch(name: str) -> None:
    """Count one launch of kernel `name` under the current shard (a launch
    outside any shard is not counted here)."""
    shard = current_shard()
    if shard is None:
        return
    per = shard_launches.setdefault(name, {})
    per[shard] = per.get(shard, 0) + 1


shard_launches: Dict[str, Dict[int, int]] = {}


def reset_shard_launches() -> None:
    shard_launches.clear()


# ---------------------------------------------------------------------------
# per-shard maps and row access
# ---------------------------------------------------------------------------

def _local(leaf, i: int, j: int = 0):
    return leaf.block(i, j) if isinstance(leaf, Sharded) else leaf


def map_dp(fn: Callable, mesh: Mesh, *args):
    """fn(*args_i) once per dp shard i, on grid entry (i, 0), where args_i
    holds each Sharded leaf's block (i, 0) and every other leaf as it is.
    Returns fn's result tree with each tensor leaf assembled as a Sharded
    over dp (P('dp'): its leading axis cut), each block held on its
    row's every entry (a copy for sp > 1); None and other leaves come from
    shard 0."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    outs = []
    for i in range(dp):
        local = [tree_map(lambda x: _local(x, i), a) for a in args]
        with on_shard(mesh, i):
            outs.append(fn(*local))

    def join(*leaves):
        if not isinstance(leaves[0], torch.Tensor):
            return leaves[0]
        blocks = []
        for i, b in enumerate(leaves):
            row = [b]
            for j in range(1, sp):
                row.append(_copy_to(b, mesh.device(i, j)))
            mesh.copies += sp - 1
            blocks.append(row)
        spec = P(*(["dp"] + [None] * (b.dim() - 1)))
        return from_blocks(mesh, spec, blocks)

    return tree_map(join, *outs)


def _dp_axis(x: Sharded) -> int:
    if not x.spec or x.spec[0] != "dp" or "sp" in x.spec:
        raise ValueError(f"row access needs a leading-axis dp leaf "
                         f"(got {x.spec})")
    return x.shape[0] // x.mesh.shape["dp"]


def _owners(rows, per: int):
    rows = np.asarray(rows, np.int64).reshape(-1)
    shard = rows // per
    for i in np.unique(shard):
        pos = np.nonzero(shard == i)[0]
        yield int(i), pos, rows[pos] - i * per


def take_rows(x: Sharded, rows, device=None) -> torch.Tensor:
    """Rows `rows` (global host ints) of a dp leaf, gathered from their
    shards onto `device` (default the home device), in `rows`' order."""
    per = _dp_axis(x)
    mesh = x.mesh
    dev = torch.device(device) if device is not None else mesh.home
    n = len(np.asarray(rows).reshape(-1))
    out = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
    for i, pos, local in _owners(rows, per):
        blk = x.block(i)
        idx = torch.as_tensor(local, device=blk.device)
        out[torch.as_tensor(pos, device=dev)] = blk[idx].to(dev)
        mesh.copies += 1
    return out


def set_rows(x: Sharded, rows, values: torch.Tensor) -> Sharded:
    """A new Sharded whose rows `rows` are `values` ([k, ...]), each
    written into its owning shard (every entry of that shard's row);
    untouched blocks are shared with `x`, which is left as it was."""
    per = _dp_axis(x)
    mesh = x.mesh
    blocks = [list(row) for row in x.blocks]
    for i, pos, local in _owners(rows, per):
        for j in range(mesh.shape["sp"]):
            blk = blocks[i][j]
            idx = torch.as_tensor(local, device=blk.device)
            v = values[torch.as_tensor(pos, device=values.device)]
            blocks[i][j] = blk.index_put((idx,), v.to(blk.device))
            mesh.copies += 1
    return Sharded(mesh, x.spec, blocks, x.shape)


def write_rows(x: Sharded, rows, values: torch.Tensor) -> None:
    """Write `values` ([k, ...]) into rows `rows` of a dp leaf in place:
    each row into its owning shard's blocks (every entry of the row)."""
    per = _dp_axis(x)
    mesh = x.mesh
    for i, pos, local in _owners(rows, per):
        v = values[torch.as_tensor(pos, device=values.device)]
        for j in range(mesh.shape["sp"]):
            blk = x.block(i, j)
            blk[torch.as_tensor(local, device=blk.device)] = v.to(blk.device)
            mesh.copies += 1


def clone(x: Sharded) -> Sharded:
    """A copy of every block (the same placement)."""
    return Sharded(x.mesh, x.spec, [[b.clone() for b in row]
                                    for row in x.blocks], x.shape)


def row_of(x: Sharded, j: int) -> torch.Tensor:
    """Row j of a dp leaf, on the home device."""
    per = _dp_axis(x)
    x.mesh.copies += 1
    return x.block(j // per)[j % per].to(x.mesh.home)


# ---------------------------------------------------------------------------
# explicit collectives within a dp row (over its sp entries)
# ---------------------------------------------------------------------------

def row_all_gather(mesh: Mesh, parts: List[torch.Tensor], i: int,
                   j: int) -> List[torch.Tensor]:
    """Every part of dp row i (one per sp entry) copied to entry (i, j)."""
    dev = mesh.device(i, j)
    mesh.copies += len(parts) - 1
    return [p.to(dev) for p in parts]


def row_reduce(mesh: Mesh, parts: List[torch.Tensor], i: int,
               op: Callable) -> List[torch.Tensor]:
    """op folded over dp row i's parts on entry (i, 0), the result copied
    back to every entry of the row (psum, pmin)."""
    home = mesh.device(i, 0)
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p.to(home))
    out = [acc] + [acc.to(mesh.device(i, j)) for j in range(1, len(parts))]
    mesh.copies += 2 * (len(parts) - 1)
    return out


def row_permute(mesh: Mesh, parts: List[torch.Tensor],
                i: int) -> List[torch.Tensor]:
    """ppermute j -> j + 1 (mod sp) within dp row i: entry j receives the
    part of entry j - 1, and entry 0 that of the last entry (the cyclic
    wrap)."""
    sp = len(parts)
    mesh.copies += sp
    return [parts[(j - 1) % sp].to(mesh.device(i, j)) for j in range(sp)]
