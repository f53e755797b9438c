"""Wire protocol: message types, summary trees, quorum, protocol state
machine (a port of fluidframework_tpu's protocol package).

Capability parity with the reference's `protocol-definitions` + `protocol-base`
packages (reference: server/routerlicious/packages/protocol-definitions/src/protocol.ts,
protocol-base/src/{quorum,protocol}.ts).
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
from .summary import (
    SummaryType,
    SummaryTree,
    SummaryBlob,
    SummaryHandle,
    SummaryAttachment,
    summary_tree_to_dict,
    summary_tree_from_dict,
)
from .quorum import Quorum, QuorumProposal, SequencedClient
from .protocol_handler import ProtocolOpHandler, ProtocolState, ProtocolError
