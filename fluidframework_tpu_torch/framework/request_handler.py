"""Request routing: URL -> component resolution.

Capability parity with reference packages/runtime/runtime-utils
RequestParser + packages/framework/request-handler: parse "/store/channel"
paths, route through handler chains (first handler that resolves wins).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional
from urllib.parse import parse_qs, urlparse


class RequestParser:
    def __init__(self, url: str):
        parsed = urlparse(url)
        self.url = url
        self.path_parts: List[str] = [p for p in parsed.path.split("/") if p]
        self.query = {k: v[0] for k, v in parse_qs(parsed.query).items()}

    def is_leaf(self, elements: int) -> bool:
        return len(self.path_parts) == elements

    def sub_request(self, start: int) -> "RequestParser":
        return RequestParser("/" + "/".join(self.path_parts[start:]))


RouteHandler = Callable[[RequestParser, Any], Optional[Any]]


class RequestHandlerChain:
    """First handler returning non-None wins (reference
    buildRuntimeRequestHandler)."""

    def __init__(self, *handlers: RouteHandler):
        self.handlers: List[RouteHandler] = list(handlers)

    def add(self, handler: RouteHandler) -> None:
        self.handlers.append(handler)

    def request(self, url: str, context: Any = None) -> Any:
        parser = RequestParser(url)
        for handler in self.handlers:
            result = handler(parser, context)
            if result is not None:
                return result
        raise KeyError(f"no handler resolved {url!r}")


def datastore_route_handler(runtime) -> RouteHandler:
    """Routes /storeId[/channelId] into the runtime's stores/channels."""

    def handler(parser: RequestParser, _context):
        if not parser.path_parts:
            return None
        store_id = parser.path_parts[0]
        if store_id not in runtime.datastores:
            return None
        store = runtime.datastores[store_id]
        if parser.is_leaf(1):
            return store
        channel_id = parser.path_parts[1]
        if channel_id in store.channels:
            return store.channels[channel_id]
        return None

    return handler
