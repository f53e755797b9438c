"""Wire protocol: message types (a port of fluidframework_tpu's protocol
package; summary trees, quorum and the protocol state machine are not
ported yet).

Capability parity with the reference's `protocol-definitions` package
(reference: server/routerlicious/packages/protocol-definitions/src/protocol.ts).
"""

from .messages import (
    MessageType,
    ITrace,
    DocumentMessage,
    SequencedDocumentMessage,
    NackContent,
    Nack,
    SignalMessage,
    Boxcar,
    NACK_BAD_REF_SEQ,
    NACK_DUPLICATE,
)
