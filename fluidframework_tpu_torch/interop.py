"""Carrying state between numpy and the port's tensor tuples.

Each `*_from_numpy` takes a dict of numpy arrays keyed by field name (for
example a JAX-package NamedTuple passed through `np.asarray` field by
field) and builds the port's tuple on `device` with the dtypes unchanged.
`to_numpy` goes the other way for any of the tuples. device defaults to
"cuda" and raises when CUDA is absent.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Type

import numpy as np
import torch

from .core.device import resolve_device
from .mergetree.oppack import PackedOps, RunCols
from .mergetree.state import DocState
from .server.lww_kernel import LwwState
from .server.serve_step import RingArgs
from .server.ticket_kernel import RawOps, TicketState


def _build(cls: Type[NamedTuple], arrays: Dict[str, np.ndarray], device,
           optional=()) -> NamedTuple:
    dev = resolve_device(device)
    fields = {}
    for name in cls._fields:
        if name in optional and arrays.get(name) is None:
            fields[name] = None
            continue
        # a C-ordered copy that keeps 0-d scalars 0-d (a single
        # document's count, min_seq, seq, overflow)
        arr = np.array(arrays[name], order="C")
        fields[name] = torch.from_numpy(arr).to(dev)
    return cls(**fields)


def doc_state_from_numpy(arrays: Dict[str, np.ndarray],
                         device=None) -> DocState:
    return _build(DocState, arrays, device)


def ticket_state_from_numpy(arrays: Dict[str, np.ndarray],
                            device=None) -> TicketState:
    return _build(TicketState, arrays, device)


def packed_ops_from_numpy(arrays: Dict[str, np.ndarray],
                          device=None) -> PackedOps:
    return _build(PackedOps, arrays, device)


def raw_ops_from_numpy(arrays: Dict[str, np.ndarray],
                       device=None) -> RawOps:
    """RawOps; the `kind` column is optional (absent or None = no column)."""
    return _build(RawOps, arrays, device, optional=("kind",))


def run_cols_from_numpy(arrays: Dict[str, np.ndarray],
                        device=None) -> RunCols:
    return _build(RunCols, arrays, device)


def lww_state_from_numpy(arrays: Dict[str, np.ndarray],
                         device=None) -> LwwState:
    return _build(LwwState, arrays, device)


def page_pool_from_numpy(arrays: Dict[str, np.ndarray],
                         device=None) -> DocState:
    """A page pool: a DocState whose leading axis is pages and whose
    capacity axis is PAGE_ROWS."""
    return _build(DocState, arrays, device)


def ring_args_from_numpy(ring: RingArgs, device=None) -> RingArgs:
    """A staged megakernel ring (numpy arrays, testing/serving.py) on
    `device`, entry by entry; None entries of runs_xs stay None."""
    dev = resolve_device(device)

    def put(x):
        if x is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(x).copy()).to(dev)

    return RingArgs(*(tuple(put(x) for x in field)
                      if isinstance(field, (tuple, list)) else put(field)
                      for field in ring))


def to_numpy(tup: NamedTuple) -> Dict[str, np.ndarray]:
    """Any of the port's tuples -> dict of host numpy arrays (None fields
    are left out)."""
    return {name: value.detach().cpu().numpy()
            for name, value in zip(tup._fields, tup) if value is not None}
