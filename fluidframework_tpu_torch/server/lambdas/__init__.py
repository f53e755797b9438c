"""Partition lambdas (reference routerlicious lambdas, SURVEY.md §2.5):
Deli (sequencer), Scriptorium (delta persistence), Scribe (server-side
summaries + ack/nack), Broadcaster (fan-out), Copier (raw-op capture),
Foreman (task distribution); the device sequencer's lambda is
server/tpu_sequencer.py."""

from .base import IPartitionLambda, LambdaContext
from .deli import DeliLambda
from .scriptorium import ScriptoriumLambda
from .scribe import ScribeLambda
from .broadcaster import BroadcasterLambda
from .copier import CopierLambda
from .foreman import ForemanLambda
