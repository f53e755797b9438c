"""Shared utilities of the PyTorch port."""

from .device import resolve_device

__all__ = ["resolve_device"]
