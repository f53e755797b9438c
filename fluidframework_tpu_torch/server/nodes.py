"""Multi-node ordering: document->node reservations with takeover.

Capability parity with reference memory-orderer's multi-node mode
(`memory-orderer/src/{reservationManager.ts,nodeManager.ts,localNode.ts,
proxyOrderer.ts}`, SURVEY.md §2.6.4): each document is owned by exactly one
orderer node via a leased reservation persisted in the shared database;
clients may connect through any node — non-owners forward to the owner
(proxy orderer); when the owner dies or its lease expires another node
takes the reservation over and resumes sequencing from the deli/scribe
checkpoints in the shared database, so sequence numbers continue without
gaps or duplicates.

TPU deployment shape: nodes are hosts of a pod slice; the shared
DatabaseManager/Historian stand in for the durable Mongo/git services; the
per-document core is the same lambda pipeline the single-node path runs
(one `LocalServer` per owned document, mirroring the reference's
LocalOrderer-per-document), so a takeover is "construct pipeline from
checkpoint" — the state handed over is the checkpoint, never the log.

A port of fluidframework_tpu's server/nodes.py. With
`server_cls=TpuLocalServer` each owned document's core runs on the card
(the class's default device; pass functools.partial(TpuLocalServer,
device=...) for another), and raises without CUDA when the first
document is owned.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

from ..core.events import TypedEventEmitter
from .database import Collection, DatabaseManager
from .lambdas.scriptorium import query_deltas
from .local_server import Connection, LocalServer
from .storage import Historian


class DocumentCheckpoints:
    """One document's view of the shared sequencer checkpoint Collection:
    every row this view writes carries ``coreDocument``, and every read
    filters on it. Each owned document runs its own core (one sequencer
    lambda), and a TpuSequencerLambda checkpoints its whole dump into one
    ``kind == "tpu-sequencer"`` row; over the bare shared collection the
    cores of a node's documents overwrite each other's row, so a takeover
    restored another core's stale dump for every document but the last
    one written (ROADMAP Queue 3 item 11). Presents the find / find_one /
    upsert surface the sequencer lambdas use."""

    def __init__(self, inner: Collection, document_id: str):
        self.inner = inner
        self.document_id = document_id

    def _scope(self, predicate):
        doc = self.document_id
        return lambda d: d.get("coreDocument") == doc and predicate(d)

    def find(self, predicate) -> List[dict]:
        return self.inner.find(self._scope(predicate))

    def find_one(self, predicate) -> Optional[dict]:
        return self.inner.find_one(self._scope(predicate))

    def upsert(self, match, doc: dict) -> None:
        doc = dict(doc)
        doc["coreDocument"] = self.document_id
        self.inner.upsert(self._scope(match), doc)

    def __len__(self) -> int:
        return len(self.find(lambda d: True))


class DocumentDatabase:
    """The shared DatabaseManager as one document's core sees it: its
    sequencer checkpoints scoped to the document (DocumentCheckpoints),
    every other collection shared as it is."""

    CHECKPOINTS = "deliCheckpoints"

    def __init__(self, db: DatabaseManager, document_id: str):
        self.db = db
        self.document_id = document_id

    def collection(self, name: str, *args, **kwargs):
        inner = self.db.collection(name, *args, **kwargs)
        if name == self.CHECKPOINTS:
            return DocumentCheckpoints(inner, self.document_id)
        return inner

    def __getattr__(self, name):
        return getattr(self.db, name)


class NodeManager:
    """Node liveness registry (reference nodeManager.ts): nodes heartbeat
    into the shared db; a node is alive if its last heartbeat is fresh."""

    def __init__(self, nodes: Collection, heartbeat_timeout_s: float = 30.0):
        self.nodes = nodes
        self.heartbeat_timeout_s = heartbeat_timeout_s

    def register(self, node_id: str, now: Optional[float] = None) -> None:
        self.heartbeat(node_id, now)

    def heartbeat(self, node_id: str, now: Optional[float] = None) -> None:
        ts = time.time() if now is None else now
        self.nodes.upsert(lambda d: d.get("nodeId") == node_id,
                          {"nodeId": node_id, "lastHeartbeat": ts,
                           "alive": True})

    def mark_dead(self, node_id: str) -> None:
        row = self.nodes.find_one(lambda d: d.get("nodeId") == node_id)
        if row:
            row["alive"] = False
            self.nodes.upsert(lambda d: d.get("nodeId") == node_id, row)

    def is_alive(self, node_id: str, now: Optional[float] = None) -> bool:
        row = self.nodes.find_one(lambda d: d.get("nodeId") == node_id)
        if row is None or not row.get("alive"):
            return False
        ts = time.time() if now is None else now
        return ts - row["lastHeartbeat"] <= self.heartbeat_timeout_s


class ReservationManager:
    """Leased document->node ownership (reference reservationManager.ts).
    `get_or_reserve` returns the current owner, taking the reservation
    over when it is expired or its owner is no longer alive."""

    def __init__(self, reservations: Collection, node_manager: NodeManager,
                 lease_s: float = 60.0):
        self.reservations = reservations
        self.node_manager = node_manager
        self.lease_s = lease_s
        # Reservation decisions must be atomic per process (the reference
        # leans on Mongo's atomic update; the in-memory db needs a lock).
        self._lock = threading.Lock()

    def get_or_reserve(self, key: str, node_id: str,
                       now: Optional[float] = None) -> str:
        ts = time.time() if now is None else now
        with self._lock:
            row = self.reservations.find_one(lambda d: d.get("key") == key)
            if row is not None:
                owner = row["nodeId"]
                if (row["expires"] > ts
                        and self.node_manager.is_alive(owner, ts)):
                    return owner
            # Expired / dead owner / unreserved: take it.
            self.reservations.upsert(
                lambda d: d.get("key") == key,
                {"key": key, "nodeId": node_id,
                 "expires": ts + self.lease_s})
            return node_id

    def owner(self, key: str) -> Optional[str]:
        row = self.reservations.find_one(lambda d: d.get("key") == key)
        return row["nodeId"] if row else None

    def extend(self, key: str, node_id: str,
               now: Optional[float] = None) -> bool:
        """Renew the lease; False if the reservation moved elsewhere."""
        ts = time.time() if now is None else now
        with self._lock:
            row = self.reservations.find_one(lambda d: d.get("key") == key)
            if row is None or row["nodeId"] != node_id:
                return False
            self.reservations.upsert(
                lambda d: d.get("key") == key,
                {"key": key, "nodeId": node_id,
                 "expires": ts + self.lease_s})
            return True

    def release(self, key: str, node_id: str) -> None:
        with self._lock:
            row = self.reservations.find_one(lambda d: d.get("key") == key)
            if row is not None and row["nodeId"] == node_id:
                self.reservations.upsert(
                    lambda d: d.get("key") == key,
                    {"key": key, "nodeId": node_id, "expires": 0.0})


class ProxyConnection(TypedEventEmitter):
    """A client connection held through a non-owning node (reference
    proxyOrderer.ts): submit/disconnect forward to the owner's connection;
    op/nack/disconnect events relay back."""

    def __init__(self, remote: Connection, via_node: str):
        super().__init__()
        self.remote = remote
        self.via_node = via_node
        self.client_id = remote.client_id
        remote.on("op", lambda msg: self.emit("op", msg))
        remote.on("nack", lambda nack: self.emit("nack", nack))
        remote.on("signal", lambda sig: self.emit("signal", sig))
        remote.on("disconnect", lambda: self.emit("disconnect"))

    @property
    def connected(self) -> bool:
        return self.remote.connected

    def submit(self, messages) -> None:
        self.remote.submit(messages)

    def submit_signal(self, content) -> None:
        self.remote.submit_signal(content)

    def disconnect(self) -> None:
        self.remote.disconnect()


class OrdererNode:
    """One orderer host. Owns a set of documents (per-document lambda
    cores) and proxies the rest (reference localNode.ts)."""

    def __init__(self, cluster: "Cluster", node_id: str):
        self.cluster = cluster
        self.node_id = node_id
        self.cores: Dict[str, LocalServer] = {}
        self.proxies: List[ProxyConnection] = []
        self.running = True
        self._lock = threading.RLock()
        cluster.node_manager.register(node_id)

    # -- ownership ---------------------------------------------------------
    def _own_core(self, document_id: str) -> LocalServer:
        """Create (or reuse) this node's pipeline for a document it owns.
        Construction restores deli/scribe checkpoints from the shared db —
        the takeover path."""
        with self._lock:
            core = self.cores.get(document_id)
            if core is not None:
                return core
            had_checkpoint = self.cluster.deli_checkpoint(document_id)
            core = self.cluster.server_cls(
                tenant_id=self.cluster.tenant_id,
                db=DocumentDatabase(self.cluster.db, document_id),
                historian=self.cluster.historian)
            # Fencing gate: every pump (i.e. every batch of sequencing work)
            # first renews this node's lease on the document. If the
            # reservation has moved — another node took over while this one
            # was idle/partitioned — the pump aborts BEFORE sequencing
            # anything and the core self-fences, so two cores can never
            # write forked histories for one document (split-brain guard).
            core.pump_gate = (
                lambda doc_id=document_id: self._renew_or_fence(doc_id))
            self.cores[document_id] = core
            if had_checkpoint:
                self._evict_stale_clients(core, document_id, had_checkpoint)
            return core

    def _renew_or_fence(self, document_id: str) -> bool:
        """Renew liveness + lease for one owned document; on failure drop
        the core and disconnect its clients (they reconnect through a
        surviving node, which owns the reservation now)."""
        if not self.running:
            return False
        self.cluster.node_manager.heartbeat(self.node_id)
        if self.cluster.reservations.extend(document_id, self.node_id):
            return True
        self._fence(document_id)
        return False

    def _fence(self, document_id: str) -> None:
        with self._lock:
            core = self.cores.pop(document_id, None)
        if core is None:
            return
        for conns in list(core._connections.values()):
            for conn in list(conns):
                conn.connected = False
                conn.emit("disconnect")

    def _evict_stale_clients(self, core: LocalServer, document_id: str,
                             checkpoint: dict) -> None:
        """The previous owner's clients can never speak again (their
        connections died with it). Sequence server-generated leaves for
        them — the reference deli's client-eviction path — so the MSN is
        not pinned at a dead client's refSeq forever."""
        import json as _json
        from ..protocol.messages import DocumentMessage, MessageType
        for entry in checkpoint.get("clients", []):
            core._send_system(document_id, DocumentMessage(
                client_sequence_number=0,
                reference_sequence_number=-1,
                type=MessageType.CLIENT_LEAVE,
                data=_json.dumps({"clientId": entry["clientId"]})))
        core.pump()

    # -- client surface ----------------------------------------------------
    def connect(self, document_id: str, details: Optional[dict] = None):
        """Connect a client to a document through this node: a direct
        connection when this node owns it, a ProxyConnection otherwise."""
        if not self.running:
            raise ConnectionError(f"node {self.node_id} is stopped")
        self.heartbeat()
        owner = self.cluster.reservations.get_or_reserve(
            document_id, self.node_id)
        if owner == self.node_id:
            return self._own_core(document_id).connect(document_id, details)
        peer = self.cluster.node(owner)
        remote = peer._own_core(document_id).connect(document_id, details)
        proxy = ProxyConnection(remote, via_node=self.node_id)
        with self._lock:
            self.proxies.append(proxy)
        return proxy

    def get_deltas(self, document_id: str, from_seq: int = 0,
                   to_seq: Optional[int] = None) -> List[dict]:
        return query_deltas(self.cluster.deltas, document_id, from_seq,
                            to_seq)

    def heartbeat(self) -> None:
        self.cluster.node_manager.heartbeat(self.node_id)
        for doc_id in list(self.cores):
            if not self.cluster.reservations.extend(doc_id, self.node_id):
                self._fence(doc_id)

    def stop(self) -> None:
        """Simulate node death: drop client connections, stop heartbeating.
        Checkpoints stay in the shared db for the next owner."""
        with self._lock:
            self.running = False
            for doc_id, core in self.cores.items():
                for conn in [c for conns in core._connections.values()
                             for c in conns]:
                    conn.connected = False
                    conn.emit("disconnect")
            self.cores.clear()
            # Clients that entered through this node as a proxy lose their
            # path too: sever at the owner's end so 'disconnect' fires and
            # ProxyConnection.connected goes False.
            proxies, self.proxies = self.proxies, []
        for proxy in proxies:
            if proxy.remote.connected:
                proxy.remote.disconnect()
        self.cluster.node_manager.mark_dead(self.node_id)


class Cluster:
    """A set of orderer nodes over shared durable services (the multi-node
    deployment in one process; reference docker-compose scale-out)."""

    def __init__(self, tenant_id: str = "cluster",
                 heartbeat_timeout_s: float = 30.0, lease_s: float = 60.0,
                 server_cls=LocalServer):
        """server_cls: the per-document pipeline class — LocalServer
        (scalar deli) or TpuLocalServer (device-batched sequencer); both
        restore from the shared checkpoint collections on takeover."""
        self.tenant_id = tenant_id
        self.server_cls = server_cls
        self.db = DatabaseManager()
        self.historian = Historian()
        self.node_manager = NodeManager(self.db.collection("nodes"),
                                        heartbeat_timeout_s)
        self.reservations = ReservationManager(
            self.db.collection("reservations"), self.node_manager, lease_s)
        self._nodes: Dict[str, OrdererNode] = {}
        self._counter = itertools.count(1)

    @property
    def deltas(self) -> Collection:
        from .lambdas.scriptorium import delta_key
        return self.db.collection("deltas", unique_key=delta_key)

    def deli_checkpoint(self, document_id: str) -> Optional[dict]:
        """Checkpointed sequencing state for a doc, normalized to the
        scalar shape ({"clients": [{"clientId": ...}], ...}) — reads the
        scalar deli's per-doc row or the TPU sequencer's consolidated dump
        (server/tpu_sequencer.py _checkpoint)."""
        ckpts = DocumentDatabase(self.db, document_id).collection(
            DocumentDatabase.CHECKPOINTS)
        # "state" in d: skip handed-off tombstones (live rebalancing
        # leaves one on the document's old partition; server/sharding.py).
        row = ckpts.find_one(
            lambda d: d.get("documentId") == document_id and "state" in d)
        if row:
            return row["state"]
        tpu = ckpts.find_one(lambda d: d.get("kind") == "tpu-sequencer")
        if not tpu:
            return None
        dump = tpu["state"]
        doc = dump.get("docs", {}).get(document_id)
        if doc is None:
            return None
        lane = doc["lane"]
        tstate = dump["tstate"]
        by_ordinal = {int(v): k for k, v in doc["interner"].items()}
        clients = [{"clientId": by_ordinal[int(o)]}
                   for o in tstate["client_ids"][lane]
                   if int(o) >= 0 and int(o) in by_ordinal]
        return {"sequenceNumber": int(tstate["next_seq"][lane]) - 1,
                "clients": clients}

    def create_node(self, node_id: Optional[str] = None) -> OrdererNode:
        nid = node_id or f"node-{next(self._counter)}"
        node = OrdererNode(self, nid)
        self._nodes[nid] = node
        return node

    def node(self, node_id: str) -> OrdererNode:
        return self._nodes[node_id]

    def live_nodes(self) -> List[OrdererNode]:
        return [n for n in self._nodes.values() if n.running]
