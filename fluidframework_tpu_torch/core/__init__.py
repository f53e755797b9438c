"""Shared collections and utilities of the PyTorch port."""

from .collections import Heap, IntervalTree, RangeTracker, RedBlackTree
from .config import ConfigProvider
from .device import resolve_device
from .errors import BulkApplyUnsupported
from .events import Deferred, TypedEventEmitter
from .trace import Trace

__all__ = ["BulkApplyUnsupported", "ConfigProvider", "Deferred", "Heap",
           "IntervalTree", "RangeTracker", "RedBlackTree", "Trace",
           "TypedEventEmitter", "resolve_device"]
