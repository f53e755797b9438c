"""The device telemetry planes: the slot layouts and the host-side fold
into counters (a port of fluidframework_tpu's telemetry/device_stats.py).

The device programs emit a compact int32 stats plane in the readback they
already pay for: server/serve_step.py with stats=True packs the
SERVE_SLOTS plane into its flat16 result (as lo/hi int16 halves); the
paged apply and burst (mergetree/kernel.paged_stats_vec) return one
PAGED_SLOTS vector per apply or chunk; the fused zamboni + extraction
(kernel.compact_extract_batched(stats=True)) returns the pre-compaction
counts from which the caller builds the EXTRACT_SLOTS vector. This module
folds them into the counters surface:

  * every fold takes the device vector and, where there is one, a
    host-derived mirror; both land as counters (``device.serving.*`` vs
    ``host.serving.*``), so device-vs-host reconciliation is a counter
    diff (``reconcile``);
  * ``begin_flush`` / ``flush_facts`` give a flush span the deltas of the
    device-measured facts retired during it.

The process-wide toggle (``enabled`` / ``set_enabled``) is what callers
pass as ``stats=``; JAX's ``FLUID_DEVICE_STATS`` environment switch has no
counterpart.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

from . import counters as _counters

# -- slot layouts ------------------------------------------------------------
# Index order is THE contract between the device code (serve_step's
# windows, kernel.paged_stats_vec, the extraction's pre-compaction counts)
# and the host decode: append-only, never reorder.

# One serving window (rides the flat16 narrow result as 2*N int16).
SERVE_SLOTS = (
    "ops_insert",          # admitted merge ops by kind (post nack/void)
    "ops_remove",
    "ops_annotate",
    "ops_ack_insert",
    "ops_ack_remove",
    "ops_insert_run",
    "lww_ops",             # admitted LWW ops (any kind)
    "ticket_admitted",     # sequenced messages (ops + joins + system)
    "ticket_nacked",
    "ticket_not_joined",
    "merge_overflow_lanes",
    "lww_overflow_lanes",
    "noop_skipped_applies",  # all-NOOP applies (skipped by the JAX burst)
    "merge_rows_live",     # post-window fill (sum of lane counts)
    "lww_keys_live",
)
N_SERVE = len(SERVE_SLOTS)

# One paged apply / paged-burst chunk.
PAGED_SLOTS = (
    "ops_insert",
    "ops_remove",
    "ops_annotate",
    "ops_ack_insert",
    "ops_ack_remove",
    "ops_insert_run",
    "overflow_docs",
    "rows_live",           # post-apply live rows across the group
)
N_PAGED = len(PAGED_SLOTS)

# One fused zamboni+extract dispatch (bucketed or paged).
EXTRACT_SLOTS = (
    "docs",
    "rows_live",           # post-compaction live rows
    "rows_reclaimed",      # zamboni reclaim: pre minus post live rows
)
N_EXTRACT = len(EXTRACT_SLOTS)

# Slots folded as monotone counters; the rest are point-in-time gauges.
_SERVE_GAUGES = {"merge_rows_live", "lww_keys_live"}

# -- process-wide toggle -----------------------------------------------------

_lock = threading.Lock()
_enabled = True


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Flip the process-wide toggle (callers pass it as `stats=` at
    dispatch; results are bit-identical either way)."""
    global _enabled
    with _lock:
        _enabled = bool(on)


# -- folds -------------------------------------------------------------------

def _fold(prefix: str, slots: Sequence[str], vec, gauges=frozenset()):
    for name, value in zip(slots, vec):
        v = float(value)
        if name in gauges:
            _counters.gauge(f"{prefix}.{name}", v)
        elif v:
            _counters.increment(f"{prefix}.{name}", v)


def fold_serve(device_vec, host_vec=None) -> None:
    """Fold one window's device stats vector (int order = SERVE_SLOTS)
    into ``device.serving.*``; ``host_vec`` — the host-derived mirror
    computed from the same window's staging + decoded ticket results —
    lands as ``host.serving.*`` so device-vs-host reconciliation is a
    counter diff."""
    _fold("device.serving", SERVE_SLOTS, device_vec, _SERVE_GAUGES)
    if host_vec is not None:
        _fold("host.serving", SERVE_SLOTS, host_vec, _SERVE_GAUGES)
        for name, d, h in zip(SERVE_SLOTS, device_vec, host_vec):
            if name not in _SERVE_GAUGES and int(d) != int(h):
                _counters.increment("device.serving.reconcile_mismatch")
                break


def fold_paged(device_vec, host_vec=None) -> None:
    _fold("device.paged", PAGED_SLOTS, device_vec)
    if host_vec is not None:
        _fold("host.paged", PAGED_SLOTS, host_vec)
        for name, d, h in zip(PAGED_SLOTS, device_vec, host_vec):
            if name != "rows_live" and int(d) != int(h):
                _counters.increment("device.paged.reconcile_mismatch")
                break


def fold_extract(device_vec) -> None:
    _fold("device.extract", EXTRACT_SLOTS, device_vec)


# -- flush-span enrichment ---------------------------------------------------
# The serving.flush span gains device-measured sub-facts: the sequencer
# snapshots these keys at flush start and stamps the deltas at flush
# end (windows retired during the flush — including deferred windows
# from earlier flushes draining now — attribute here).

_FLUSH_KEYS = (
    ("dev_ops", ("device.serving.ops_insert",
                 "device.serving.ops_remove",
                 "device.serving.ops_annotate",
                 "device.serving.ops_ack_insert",
                 "device.serving.ops_ack_remove",
                 "device.serving.ops_insert_run",
                 "device.serving.lww_ops")),
    ("dev_admitted", ("device.serving.ticket_admitted",)),
    ("dev_nacked", ("device.serving.ticket_nacked",)),
    ("dev_overflow_lanes", ("device.serving.merge_overflow_lanes",
                            "device.serving.lww_overflow_lanes")),
    ("dev_noop_skips", ("device.serving.noop_skipped_applies",)),
    ("dev_zamboni_rows", ("device.extract.rows_reclaimed",
                          "zamboni.rows_reclaimed")),
)


def begin_flush() -> tuple:
    return tuple(sum(_counters.get(c) for c in cs)
                 for _, cs in _FLUSH_KEYS)


def flush_facts(token: tuple) -> Dict[str, int]:
    """Non-zero deltas since ``begin_flush`` — the serving.flush span's
    device-measured attributes."""
    out: Dict[str, int] = {}
    for (name, cs), before in zip(_FLUSH_KEYS, token):
        delta = sum(_counters.get(c) for c in cs) - before
        if delta:
            out[name] = int(delta)
    return out


def snapshot() -> Dict[str, float]:
    """Every device.*/host.* stats counter — the /health block."""
    return {k: v for k, v in _counters.snapshot().items()
            if k.startswith(("device.", "host."))}


def reconcile() -> Optional[dict]:
    """Device-vs-host totals for the countable serving slots: {slot:
    (device, host)} for any slot that disagrees, or None when exact."""
    snap = _counters.snapshot()
    bad = {}
    for name in SERVE_SLOTS:
        if name in _SERVE_GAUGES:
            continue
        d = snap.get(f"device.serving.{name}", 0.0)
        h = snap.get(f"host.serving.{name}", 0.0)
        if int(d) != int(h):
            bad[name] = (int(d), int(h))
    return bad or None
