"""Partition lambdas (reference routerlicious lambdas, SURVEY.md §2.5): the
lambda SPI only so far (`IPartitionLambda`, `LambdaContext`); the lambdas
themselves are not ported yet."""

from .base import IPartitionLambda, LambdaContext
