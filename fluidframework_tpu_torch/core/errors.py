"""Cross-layer error contracts (a copy of fluidframework_tpu's
core/errors.py: exception types shared across layers without import
edges)."""


class BulkApplyUnsupported(Exception):
    """A channel cannot apply a given batch in bulk; the caller must fall
    back to per-op processing. Raisers guarantee channel state is untouched.
    The merge-tree engine's catchup.Unmodelable subclasses this."""
