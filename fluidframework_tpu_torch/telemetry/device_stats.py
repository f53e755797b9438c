"""The device telemetry planes: slot names only.

Copies of the SERVE_SLOTS and PAGED_SLOTS layouts of fluidframework_tpu's
telemetry/device_stats.py: server/serve_step.py with stats=True packs the
SERVE_SLOTS int32 plane into its flat16 result (as lo/hi int16 halves),
and the paged apply and burst (mergetree/kernel.paged_stats_vec) return
one PAGED_SLOTS vector per apply or chunk. Index order is the contract
with the host decode: append-only, never reorder. The host-side fold into
counters is not ported yet.
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
