"""Cross-layer error contracts (a copy of fluidframework_tpu's
core/errors.py: exception types shared across layers without import
edges)."""


class BulkApplyUnsupported(Exception):
    """A channel cannot apply a given batch in bulk; the caller must fall
    back to per-op processing. Raisers guarantee channel state is untouched.
    The merge-tree engine's catchup.Unmodelable subclasses this."""


class CapacityExceeded(ValueError):
    """More segment rows than the table being built can hold. A
    ValueError, as the JAX package raises it; a type of its own so the
    lane stores can degrade a lane for this and for nothing else a
    ValueError may carry (the scan-apply wrapper refuses a shape with a
    plain ValueError, which must propagate)."""
