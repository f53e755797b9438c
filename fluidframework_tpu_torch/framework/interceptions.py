"""DDS interception wrappers.

Capability parity with reference packages/framework/dds-interceptions
(README:1-8): wrap a DDS so every local mutation passes through a callback
that can rewrite its arguments — e.g. stamping attribution properties on
SharedString edits or augmenting SharedMap values — without the consumer
knowing."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


def create_shared_string_with_interception(
        shared_string,
        props_interceptor: Callable[[Optional[dict]], Optional[dict]]):
    """Returns a facade whose insert/annotate calls run their props through
    `props_interceptor` (reference createSharedStringWithInterception)."""

    class _Intercepted:
        def __getattr__(self, name):
            return getattr(shared_string, name)

        def insert_text(self, pos, text, props=None):
            shared_string.insert_text(pos, text, props_interceptor(props))

        def insert_marker(self, pos, props=None):
            shared_string.insert_marker(pos, props_interceptor(props))

        def annotate_range(self, start, end, props):
            shared_string.annotate_range(start, end,
                                         props_interceptor(props) or {})

    return _Intercepted()


def create_shared_map_with_interception(
        shared_map,
        set_interceptor: Callable[[str, Any], Any]):
    """Returns a facade whose set() values run through `set_interceptor`
    (reference createDirectoryWithInterception family)."""

    class _Intercepted:
        def __getattr__(self, name):
            return getattr(shared_map, name)

        def set(self, key, value):
            return shared_map.set(key, set_interceptor(key, value))

    return _Intercepted()
