"""Isolation proxy driver: the whole driver interface over a serialized
message boundary.

Capability parity with reference packages/drivers/iframe-driver (801 LoC:
`innerDocumentService.ts` / `outerDocumentServiceFactory.ts` — the driver
proxied across an iframe via comlink/postMessage so untrusted app code
never holds service credentials): here the boundary is a pair of transport
callables carrying ONLY JSON-serializable dicts. The host side
(`DriverProxyHost`) owns the real driver; the sandboxed side
(`ProxyDocumentService`) implements the full `IDocumentService` contract by
request/response messages, with sequenced ops pushed as serialized events.
Wrap the transport in json round-trips (as the tests do) and the isolation
is machine-checked.

A port of fluidframework_tpu's loader/drivers/proxy.py (host only).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, List, Optional

from ...core.events import TypedEventEmitter
from ...protocol.messages import (DocumentMessage,
                                  SequencedDocumentMessage, SignalMessage)
from ...protocol.summary import (summary_tree_from_dict,
                                 summary_tree_to_dict)
from .base import (IDocumentDeltaConnection, IDocumentDeltaStorageService,
                   IDocumentService, IDocumentServiceFactory,
                   IDocumentStorageService)
from .file import message_from_json, message_to_json


def _doc_message_to_json(m: DocumentMessage) -> dict:
    return {"clientSequenceNumber": m.client_sequence_number,
            "referenceSequenceNumber": m.reference_sequence_number,
            "type": m.type, "contents": m.contents, "data": m.data}


def _doc_message_from_json(d: dict) -> DocumentMessage:
    return DocumentMessage(
        client_sequence_number=d["clientSequenceNumber"],
        reference_sequence_number=d["referenceSequenceNumber"],
        type=d["type"], contents=d.get("contents"), data=d.get("data"))


class DriverProxyHost:
    """The privileged side (reference OuterDocumentServiceFactory): holds
    the real factory; executes serialized requests; pushes connection
    events outward through `event_sink(event_dict)` callables registered
    per connection id."""

    def __init__(self, factory: IDocumentServiceFactory):
        self.factory = factory
        self._services: Dict[str, IDocumentService] = {}
        self._connections: Dict[int, Any] = {}
        self._conn_ids = itertools.count(1)
        self._event_sinks: Dict[int, Callable[[dict], None]] = {}
        self._lock = threading.RLock()

    def set_event_sink(self, conn_id: int,
                       sink: Callable[[dict], None]) -> None:
        with self._lock:
            self._event_sinks[conn_id] = sink

    def _service(self, document_id: str) -> IDocumentService:
        with self._lock:
            if document_id not in self._services:
                self._services[document_id] = \
                    self.factory.create_document_service(document_id)
            return self._services[document_id]

    # -- the single request entry point ------------------------------------
    def handle(self, request: dict) -> dict:
        """Execute one serialized driver request; returns a serializable
        response. Errors come back as {"error", "kind"} (comlink's thrown-
        error marshalling)."""
        try:
            return {"result": self._dispatch(request)}
        except FileNotFoundError as exc:
            return {"error": str(exc), "kind": "notFound"}
        except PermissionError as exc:
            return {"error": str(exc), "kind": "permission"}
        except Exception as exc:  # noqa: BLE001 — marshal, don't leak
            return {"error": repr(exc), "kind": "generic"}

    def _dispatch(self, request: dict):
        op = request["op"]
        doc = request.get("documentId", "")
        if op == "getSummary":
            summary = self._service(doc).connect_to_storage().get_summary(
                request.get("version"))
            return None if summary is None else summary_tree_to_dict(summary)
        if op == "uploadSummary":
            handle = self._service(doc).connect_to_storage().upload_summary(
                summary_tree_from_dict(request["summary"]),
                parent=request.get("parent"),
                initial=request.get("initial", False))
            return handle
        if op == "getVersions":
            return self._service(doc).connect_to_storage().get_versions(
                request.get("count", 1))
        if op == "getDeltas":
            msgs = self._service(doc).connect_to_delta_storage().get(
                request.get("fromSeq", 0), request.get("toSeq"))
            return [message_to_json(m) for m in msgs]
        if op == "connect":
            conn = self._service(doc).connect_to_delta_stream(
                request.get("clientDetails"))
            conn_id = next(self._conn_ids)
            with self._lock:
                self._connections[conn_id] = conn
            conn.on("op", lambda m, cid=conn_id: self._push(
                cid, {"event": "op", "message": message_to_json(m)}))
            conn.on("nack", lambda n, cid=conn_id: self._push(
                cid, {"event": "nack", "nack": n if isinstance(n, dict)
                      else {"content": str(n)}}))
            conn.on("signal", lambda s, cid=conn_id: self._push(
                cid, {"event": "signal", "clientId": s.client_id,
                      "content": s.content}))
            conn.on("disconnect", lambda cid=conn_id: self._push(
                cid, {"event": "disconnect"}))
            return {"connectionId": conn_id, "clientId": conn.client_id}
        if op == "submit":
            conn = self._connections[request["connectionId"]]
            conn.submit([_doc_message_from_json(d)
                         for d in request["messages"]])
            return True
        if op == "submitSignal":
            conn = self._connections[request["connectionId"]]
            conn.submit_signal(request.get("content"))
            return True
        if op == "closeConnection":
            conn = self._connections.pop(request["connectionId"], None)
            if conn is not None:
                conn.close()
            return True
        raise ValueError(f"unknown driver op {op!r}")

    def _push(self, conn_id: int, event: dict) -> None:
        sink = self._event_sinks.get(conn_id)
        if sink is not None:
            sink(event)


# -- sandboxed side --------------------------------------------------------
class ProxyStorageService(IDocumentStorageService):
    def __init__(self, call, document_id: str):
        self._call = call
        self.document_id = document_id

    def get_summary(self, version: Optional[str] = None):
        data = self._call({"op": "getSummary", "documentId": self.document_id,
                           "version": version})
        return None if data is None else summary_tree_from_dict(data)

    def upload_summary(self, summary, parent=None, initial=False) -> str:
        return self._call({"op": "uploadSummary",
                           "documentId": self.document_id,
                           "summary": summary_tree_to_dict(summary),
                           "parent": parent, "initial": initial})

    def get_versions(self, count: int = 1) -> List[str]:
        return self._call({"op": "getVersions",
                           "documentId": self.document_id, "count": count})


class ProxyDeltaStorage(IDocumentDeltaStorageService):
    def __init__(self, call, document_id: str):
        self._call = call
        self.document_id = document_id

    def get(self, from_seq: int, to_seq: Optional[int] = None
            ) -> List[SequencedDocumentMessage]:
        rows = self._call({"op": "getDeltas", "documentId": self.document_id,
                           "fromSeq": from_seq, "toSeq": to_seq})
        return [message_from_json(d) for d in rows]


class ProxyDeltaConnection(TypedEventEmitter, IDocumentDeltaConnection):
    def __init__(self, call, document_id: str,
                 register_sink: Callable[[int, Callable[[dict], None]], None],
                 client_details: Optional[dict]):
        TypedEventEmitter.__init__(self)
        self._call = call
        info = call({"op": "connect", "documentId": document_id,
                     "clientDetails": client_details})
        self.connection_id = info["connectionId"]
        self.client_id = info["clientId"]
        register_sink(self.connection_id, self._on_event)

    def _on_event(self, event: dict) -> None:
        kind = event["event"]
        if kind == "op":
            self.emit("op", message_from_json(event["message"]))
        elif kind == "nack":
            self.emit("nack", event.get("nack"))
        elif kind == "signal":
            self.emit("signal", SignalMessage(
                client_id=event.get("clientId"),
                content=event.get("content")))
        elif kind == "disconnect":
            self.emit("disconnect")

    def submit(self, messages: List[DocumentMessage]) -> None:
        self._call({"op": "submit", "connectionId": self.connection_id,
                    "messages": [_doc_message_to_json(m) for m in messages]})

    def submit_signal(self, content) -> None:
        self._call({"op": "submitSignal", "connectionId": self.connection_id,
                    "content": content})

    def close(self) -> None:
        self._call({"op": "closeConnection",
                    "connectionId": self.connection_id})


class ProxyDocumentService(IDocumentService):
    def __init__(self, transport: Callable[[dict], dict], document_id: str,
                 register_sink: Callable[[int, Callable[[dict], None]], None]):
        self.transport = transport
        self.document_id = document_id
        self.register_sink = register_sink

    def _call(self, request: dict):
        response = self.transport(request)
        if "error" in response:
            kind = response.get("kind")
            if kind == "notFound":
                raise FileNotFoundError(response["error"])
            if kind == "permission":
                raise PermissionError(response["error"])
            raise RuntimeError(response["error"])
        return response.get("result")

    def connect_to_storage(self):
        return ProxyStorageService(self._call, self.document_id)

    def connect_to_delta_storage(self):
        return ProxyDeltaStorage(self._call, self.document_id)

    def connect_to_delta_stream(self, client_details: Optional[dict] = None):
        return ProxyDeltaConnection(self._call, self.document_id,
                                    self.register_sink, client_details)


class ProxyDocumentServiceFactory(IDocumentServiceFactory):
    """The sandboxed factory (reference InnerDocumentServiceFactory). Built
    from a request transport + an event-sink registrar — in tests both sides
    of a `DriverProxyHost` with json.dumps round-trips in between."""

    def __init__(self, transport: Callable[[dict], dict],
                 register_sink: Callable[[int, Callable[[dict], None]],
                                         None]):
        self.transport = transport
        self.register_sink = register_sink

    @staticmethod
    def over_host(host: DriverProxyHost,
                  codec: Optional[Callable[[dict], dict]] = None
                  ) -> "ProxyDocumentServiceFactory":
        """Wire directly to a host, optionally forcing every payload
        through `codec` (e.g. a json round-trip) in both directions."""
        codec = codec or (lambda d: d)

        def transport(request: dict) -> dict:
            return codec(host.handle(codec(request)))

        def register_sink(conn_id: int, sink: Callable[[dict], None]):
            host.set_event_sink(conn_id, lambda event: sink(codec(event)))

        return ProxyDocumentServiceFactory(transport, register_sink)

    def create_document_service(self, document_id: str) -> IDocumentService:
        return ProxyDocumentService(self.transport, document_id,
                                    self.register_sink)
