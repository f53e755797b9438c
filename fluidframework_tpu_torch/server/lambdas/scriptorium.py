"""The delta store's read side (reference scriptorium/lambda.ts and
alfred's delta REST route).

Counterpart of fluidframework_tpu's server/lambdas/scriptorium.py, the
range query only: the sequencer replays a document's persisted deltas
through it on a crash restart. The scriptorium lambda itself is not here.
"""

from __future__ import annotations

from typing import List

from ..database import Collection


def delta_key(doc: dict):
    """The delta store's unique key: (document id, sequence number)."""
    return (doc["documentId"], doc["sequence_number"])


def query_deltas(deltas: Collection, document_id: str, from_seq: int = 0,
                 to_seq=None) -> List[dict]:
    """Rows with from_seq < seq <= to_seq, ordered by seq."""
    hi = to_seq if to_seq is not None else 2 ** 62
    out = deltas.find(
        lambda d: d["documentId"] == document_id
        and from_seq < d["sequence_number"] <= hi)
    out.sort(key=lambda d: d["sequence_number"])
    return out
