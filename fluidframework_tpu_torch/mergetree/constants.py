"""Merge-tree constants and device sentinels (copied from
fluidframework_tpu's mergetree/constants.py; the port keeps its own copy and imports nothing of
the JAX package).

Pending-unassigned is INT32_MAX so that the visibility comparison
`ins_seq <= ref_seq` is false for pending segments without a special case.
No comparison may widen these, and no `+1` may touch an `ins_seq` sentinel.
"""

UNIVERSAL_SEQ = 0       # visible to everyone (snapshot-loaded segments)
UNASSIGNED_SEQ = -1     # host side: local pending, not yet sequenced
NON_COLLAB_CLIENT = -2  # host side: a perspective that sees only acked ops

# Segment kinds
SEG_TEXT = 0
SEG_MARKER = 1

DEV_UNASSIGNED = 2**31 - 1   # pending ins_seq / rem_seq on device
DEV_NO_REMOVE = 2**31 - 2    # rem_seq sentinel: never removed
MAX_OVERLAP_CLIENTS = 3      # device-side overlapping-remove client slots

# Paged lane memory: segment rows live in fixed-size pages of this many rows
# (a keystroke document costs one page).
PAGE_ROWS = 64

# The serving window op-depth grid (one apply shape per (capacity, T) pair).
DEFAULT_T_BUCKETS = (1, 4, 16, 64, 256)

# The scalar oracle's default text segment granularity: adjacent acked
# segments coalesce up to this many characters (reference mergeTree.ts
# TextSegmentGranularity).
TEXT_SEGMENT_GRANULARITY = 256

# Summary body chunk size in characters (reference snapshotV1.ts:40).
SNAPSHOT_CHUNK_SIZE = 10000
