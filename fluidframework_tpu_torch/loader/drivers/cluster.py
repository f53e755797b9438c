"""Cluster driver: the local driver's multi-node sibling.

Connects a Loader/Container to a `server.nodes.Cluster` through a chosen
entry node (any node reaches any document — non-owners proxy, reference
proxyOrderer.ts). `set_node()` repoints the factory after a node failure;
the next (re)connect goes through the new node, which takes the document
reservation over and resumes from the shared checkpoints.

A port of fluidframework_tpu's loader/drivers/cluster.py.
"""

from __future__ import annotations

from typing import List, Optional

from ...protocol.summary import SummaryTree
from ...server.nodes import Cluster, OrdererNode
from ...telemetry.counters import record_swallow
from .base import (
    IDocumentDeltaConnection,
    IDocumentDeltaStorageService,
    IDocumentService,
    IDocumentServiceFactory,
    IDocumentStorageService,
)
from .local import _row_to_message


class ClusterDocumentStorageService(IDocumentStorageService):
    def __init__(self, cluster: Cluster, document_id: str,
                 historian_tier=None):
        self.cluster = cluster
        self.document_id = document_id
        self.historian_tier = historian_tier
        self.store = cluster.historian.store(cluster.tenant_id, document_id)

    def get_summary(self, version: Optional[str] = None):
        tier = self.historian_tier
        if tier is not None:
            # Reads ride the cache tier; a dead/poisoned tier degrades to
            # the direct store below (same contract as the network
            # driver's historian fallback).
            try:
                from ...protocol.summary import summary_tree_from_dict
                data = tier.read_summary_dict(
                    self.cluster.tenant_id, self.document_id,
                    commit_sha=version)
                return (summary_tree_from_dict(data)
                        if data is not None else None)
            except Exception:  # noqa: BLE001 — tier failure, not data
                # Degrade to the direct store read below; counted so a
                # dead historian tier is visible as a rate, not silence.
                record_swallow("driver.historian_tier")
        return self.cluster.historian.read_summary(
            self.cluster.tenant_id, self.document_id, commit_sha=version)

    def upload_summary(self, summary: SummaryTree,
                       parent: Optional[str] = None,
                       initial: bool = False) -> str:
        return self.store.write_summary(summary, base_commit=parent,
                                        advance_ref=initial)

    def get_versions(self, count: int = 1) -> List[str]:
        return [c.sha for c in self.store.list_commits(limit=count)]


class ClusterDeltaStorageService(IDocumentDeltaStorageService):
    def __init__(self, factory: "ClusterDocumentServiceFactory",
                 document_id: str):
        self.factory = factory
        self.document_id = document_id

    def get(self, from_seq: int, to_seq: Optional[int] = None):
        rows = self.factory.node.get_deltas(self.document_id, from_seq,
                                            to_seq)
        return [_row_to_message(r) for r in rows]


class ClusterDocumentDeltaConnection(IDocumentDeltaConnection):
    def __init__(self, node: OrdererNode, document_id: str,
                 client_details: Optional[dict]):
        self._conn = node.connect(document_id, client_details)
        self.client_id = self._conn.client_id

    def submit(self, messages) -> None:
        self._conn.submit(messages)

    def submit_signal(self, content) -> None:
        self._conn.submit_signal(content)

    def on(self, event, fn) -> None:
        self._conn.on(event, fn)

    def off(self, event, fn) -> None:
        self._conn.off(event, fn)

    def close(self) -> None:
        self._conn.disconnect()


class ClusterDocumentService(IDocumentService):
    def __init__(self, factory: "ClusterDocumentServiceFactory",
                 document_id: str):
        self.factory = factory
        self.document_id = document_id

    def connect_to_storage(self):
        return ClusterDocumentStorageService(
            self.factory.cluster, self.document_id,
            historian_tier=self.factory.historian_tier)

    def connect_to_delta_storage(self):
        return ClusterDeltaStorageService(self.factory, self.document_id)

    def connect_to_delta_stream(self, client_details=None):
        # Resolved at call time so reconnects pick up a node switched via
        # set_node() after the previous entry node died.
        return ClusterDocumentDeltaConnection(self.factory.node,
                                              self.document_id,
                                              client_details)


class ClusterDocumentServiceFactory(IDocumentServiceFactory):
    def __init__(self, cluster: Cluster, node: OrdererNode,
                 historian_tier=None):
        """historian_tier: an embedded server/historian.py HistorianTier
        over the cluster's shared store — summary reads then serve from
        its cache on every node, surviving node failovers (the cache is
        keyed by content, not by node)."""
        self.cluster = cluster
        self.node = node
        self.historian_tier = historian_tier

    def set_node(self, node: OrdererNode) -> None:
        """Repoint at a different entry node (failover)."""
        self.node = node

    def create_document_service(self, document_id: str) -> IDocumentService:
        return ClusterDocumentService(self, document_id)
