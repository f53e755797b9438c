"""The serving window's device telemetry plane: slot names only.

A copy of the SERVE_SLOTS layout of fluidframework_tpu's
telemetry/device_stats.py, so that server/serve_step.py with stats=True
packs the same int32 plane into its flat16 result (as lo/hi int16 halves).
Index order is the contract with the host decode: append-only, never
reorder. The host-side fold into counters is not ported yet.
"""

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
