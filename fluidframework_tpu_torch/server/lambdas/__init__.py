"""Partition lambdas (reference routerlicious lambdas, SURVEY.md §2.5): the
lambda SPI (`IPartitionLambda`, `LambdaContext`) and the delta store's
range query (`scriptorium.query_deltas`); the lambdas themselves, apart
from the sequencer's (server/tpu_sequencer.py), are not ported yet."""

from .base import IPartitionLambda, LambdaContext
