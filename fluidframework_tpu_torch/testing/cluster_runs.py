"""The cluster takeover scenario, run the same way on either package.

`run` builds a Cluster of `nodes` orderer nodes (server/nodes.py) whose
per-document cores are the package's TpuLocalServer (the device
sequencer), and drives `docs` documents through the package's Loader and
cluster driver (loader/drivers/cluster.py), the way a multi-node
deployment serves them:

1. writer 0 of each document creates it detached with one SharedString
   ("text"), types a header and attaches it through node A, which takes
   the document's reservation; writers 1 and 2 resolve it, writer 2
   through node B (a proxy connection to A's core);
2. `before` waves: in each, every writer of every document types `ops`
   edits (inserts, removes, annotates at seeded places), and the owning
   cores pump once a document;
3. node A dies (OrdererNode.stop): every writer's connection drops, the
   proxied one included;
4. each writer's factory is pointed at node B and it reconnects. Node B
   takes each reservation over and builds the document's core, which
   restores the device sequencer from the document's checkpoint and
   rebuilds its merge lanes from the shared deltas; the core then
   sequences a leave for each of A's clients (the stale clients'
   eviction);
5. `after` more waves, and a late reader resolves each document through
   the last node.

`run` returns sha256 digests (testing/lambda_runs.py `digest`) of each
document's texts (every writer's, the late reader's, and the text the
owner's device lanes hold), of its delta stream (seq, msn, type, client,
clientSeq, refSeq and contents of each persisted row) and of the client
ids the takeover evicted, with counts: the sequenced messages, the
operations persisted against the operations typed, the evicted clients,
the documents whose seqs run 1..n without a gap or a repeat
(`contiguous`) and those whose texts all agree (`agreed`). Two runs
compare by equality.

What a run takes from outside is pinned as testing/client_runs.py pins
it (`pinned`): the client ids, the commit clock, the delta manager's idle
clock, the `random` state and the forced bulk route. The nodes' heartbeat
and lease run on the wall clock with an hour of slack, so no lease ends
inside a run. The cores run with auto_pump off and are pumped once a
document a wave, so a wave of a document is one window of the sequencer.

A package's Cluster overwrites one checkpoint row from every document's
core unless the cores' checkpoints are scoped by document, as the port's
nodes.py does (DocumentDatabase; ROADMAP Queue 3 item 11). `run` gives a
package without that scoping the same repair for its run
(`reference_repair`), so that the JAX package's run can serve as the
golden; `run(..., repair=False)` leaves the package as it is.

The scenario takes a `ClusterPackage` of one package's modules plus the
keyword arguments of its TpuLocalServer and Loader (device="cuda" or
"cpu" for the port). chip_smoke.py phase 21 (b) runs it on the card and,
in a child process, on the CPU; tests/test_torch_cluster_golden.py runs
it through the JAX package to build testing/golden/cluster_golden.json.
`run_counted` also returns the ticket-scan and scan-apply launches the
package's counters read. Apart from `port_package`, this module needs
neither torch nor JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import random
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional

from .client_runs import pinned
from .lambda_runs import digest
from .server_runs import _Cfg

STORE = "default"
CHANNEL = "text"
WRITERS = 3
LEASE_S = 3600.0


class ClusterPackage(NamedTuple):
    local_server: Any      # server/local_server module
    storage: Any           # server/storage module
    delta_manager: Any     # loader/delta_manager module
    sequence: Any          # dds/sequence module
    container: Any         # loader/container module
    nodes: Any             # server/nodes module
    cluster_driver: Any    # loader/drivers/cluster module
    scriptorium: Any       # server/lambdas/scriptorium module
    server_kwargs: dict    # extra TpuLocalServer arguments (device=...)
    loader_kwargs: dict    # extra Loader arguments (device=...)
    # {kernel: launches} of the package's kernels, where it has them.
    launches: Optional[Callable[[], Dict[str, int]]] = None


def port_package(device) -> ClusterPackage:
    """The port's ClusterPackage on `device` (its modules import torch, so
    they load here, on the first call)."""
    from ..dds import sequence
    from ..loader import container, delta_manager
    from ..loader.drivers import cluster
    from ..mergetree import kernel
    from ..server import local_server, nodes, storage
    from ..server import ticket_kernel as tk
    from ..server.lambdas import scriptorium

    def launches() -> Dict[str, int]:
        return {"ticket_scan": tk.scan_tickets.launches,
                "scan_apply": kernel.scan_apply.launches}

    return ClusterPackage(local_server, storage, delta_manager, sequence,
                          container, nodes, cluster, scriptorium,
                          {"device": device}, {"device": device}, launches)


class Spec(NamedTuple):
    """`docs` documents of WRITERS writers on `nodes` nodes; `before`
    waves before the owner dies and `after` waves after, `ops` edits a
    writer a wave."""
    docs: int = 2
    nodes: int = 2
    before: int = 2
    after: int = 2
    ops: int = 8
    seed: int = 31


def config() -> dict:
    """The cores' configuration: admission's queue above any wave, and
    the wall-clock ghost-client eviction off."""
    return {"admission.queueLimit": 65536, "deli.clientTimeoutMsec": 0}


@contextlib.contextmanager
def reference_repair(pkg: ClusterPackage) -> Iterator[None]:
    """Scopes each document core's sequencer checkpoints by document for a
    package whose nodes module does not (ROADMAP Queue 3 item 11): while
    an OrdererNode builds a document's core, and while the Cluster reads
    that document's checkpoint, the cluster's database is the port's
    DocumentDatabase over it. A package that scopes them already is left
    as it is."""
    if hasattr(pkg.nodes, "DocumentDatabase"):
        yield
        return
    from ..server.nodes import DocumentDatabase

    node_cls, cluster_cls = pkg.nodes.OrdererNode, pkg.nodes.Cluster
    own_core, deli_checkpoint = node_cls._own_core, \
        cluster_cls.deli_checkpoint

    @contextlib.contextmanager
    def scoped(cluster, document_id):
        shared = cluster.db
        cluster.db = DocumentDatabase(shared, document_id)
        try:
            yield
        finally:
            cluster.db = shared

    def repaired_own_core(self, document_id):
        with self._lock, scoped(self.cluster, document_id):
            return own_core(self, document_id)

    def repaired_deli_checkpoint(self, document_id):
        if isinstance(self.db, DocumentDatabase):
            return deli_checkpoint(self, document_id)
        with scoped(self, document_id):
            return deli_checkpoint(self, document_id)

    node_cls._own_core = repaired_own_core
    cluster_cls.deli_checkpoint = repaired_deli_checkpoint
    try:
        yield
    finally:
        node_cls._own_core = own_core
        cluster_cls.deli_checkpoint = deli_checkpoint


def run(pkg: ClusterPackage, spec: Spec, repair: bool = True) -> dict:
    """The scenario on one package: its digests and counts."""
    return run_counted(pkg, spec, repair)[0]


def run_counted(pkg: ClusterPackage, spec: Spec,
                repair: bool = True):
    """`run`'s result, and the package's kernel launches during it ({}
    where it has no counters). The launches stay out of the result, which
    the CPU and the card must agree on."""
    launches = pkg.launches or dict
    before = launches()
    guard = reference_repair(pkg) if repair else contextlib.nullcontext()
    with guard, pinned(pkg, spec.seed):
        result = _Run(pkg, spec).run()
    after = launches()
    return result, {k: after[k] - before.get(k, 0) for k in after}


class _Run:
    def __init__(self, pkg: ClusterPackage, spec: Spec):
        if spec.nodes < 2:
            raise ValueError("a takeover needs two nodes or more")
        self.pkg, self.spec = pkg, spec
        server_cls = functools.partial(
            pkg.local_server.TpuLocalServer, auto_pump=False,
            config=_Cfg(config()), **pkg.server_kwargs)
        self.cluster = pkg.nodes.Cluster(
            tenant_id="cluster", heartbeat_timeout_s=LEASE_S,
            lease_s=LEASE_S, server_cls=server_cls)
        self.nodes = [self.cluster.create_node(f"node-{chr(65 + n)}")
                      for n in range(spec.nodes)]
        self.docs = [f"doc{d}" for d in range(spec.docs)]
        # doc -> [(factory, container)] for its writers.
        self.writers: Dict[str, List[tuple]] = {}
        self.typed = {doc: 0 for doc in self.docs}
        self.wave_no = 0

    def loader(self, node):
        P = self.pkg
        factory = P.cluster_driver.ClusterDocumentServiceFactory(
            self.cluster, node)
        return factory, P.container.Loader(factory, **P.loader_kwargs)

    def pump(self) -> None:
        """Every live node's cores, to quiescence."""
        for _ in range(64):
            moved = 0
            for node in self.cluster.live_nodes():
                for core in list(node.cores.values()):
                    moved += core.pump()
            if not moved:
                return
        raise RuntimeError("the cluster's cores did not quiesce")

    @staticmethod
    def text_of(container):
        return container.runtime.get_datastore(STORE).get_channel(CHANNEL)

    def setup(self) -> None:
        a, b = self.nodes[0], self.nodes[1]
        for doc in self.docs:
            fa, la = self.loader(a)
            c0 = la.create_detached(doc)
            ds = c0.runtime.create_datastore(STORE)
            ds.create_channel(CHANNEL, self.pkg.sequence.SharedString.TYPE)
            ds.get_channel(CHANNEL).insert_text(0, f"{doc} base text ")
            c0.attach()
            self.pump()
            writers = [(fa, c0)]
            for w in range(1, WRITERS):
                f, loader = self.loader(b if w == WRITERS - 1 else a)
                writers.append((f, loader.resolve(doc)))
                self.pump()
            self.writers[doc] = writers

    def wave(self) -> None:
        wave, self.wave_no = self.wave_no, self.wave_no + 1
        for doc in self.docs:
            for w, (_, c) in enumerate(self.writers[doc]):
                rng = random.Random(repr((self.spec.seed, doc, w, wave)))
                s = self.text_of(c)
                tag = f"{chr(97 + w)}{wave}"
                for i in range(self.spec.ops):
                    n = s.get_length()
                    r = rng.random()
                    if n > 8 and r < 0.2:
                        at = rng.randrange(n - 1)
                        s.remove_text(at, min(n, at + rng.randrange(1, 4)))
                    elif n > 4 and r < 0.3:
                        at = rng.randrange(n - 1)
                        s.annotate_range(at, at + 1, {"w": tag})
                    else:
                        s.insert_text(rng.randrange(n + 1),
                                      f"{tag}{i % 10}")
                    self.typed[doc] += 1
            self.pump()

    def take_over(self) -> Dict[str, list]:
        """Node A dies; every writer reconnects through node B. Returns,
        per document, the client ids of A's era."""
        a, b = self.nodes[0], self.nodes[1]
        stale = {doc: sorted({c.delta_manager.client_id
                              for _, c in self.writers[doc]})
                 for doc in self.docs}
        a.stop()
        dropped = [c.connected for doc in self.docs
                   for _, c in self.writers[doc]]
        if any(dropped):
            raise RuntimeError("a writer kept its connection through the "
                               "owner's death")
        for doc in self.docs:
            for f, c in self.writers[doc]:
                f.set_node(b)
                c.reconnect()
                self.pump()
        return stale

    def persisted(self, doc: str) -> List[dict]:
        return self.pkg.scriptorium.query_deltas(self.cluster.deltas, doc)

    def run(self) -> dict:
        self.setup()
        for _ in range(self.spec.before):
            self.wave()
        stale = self.take_over()
        for _ in range(self.spec.after):
            self.wave()
        last = self.nodes[-1]
        _, reader_loader = self.loader(last)
        texts, streams, evicted = {}, {}, {}
        contiguous = agreed = ops = op_rows = 0
        owners = {}
        for doc in self.docs:
            reader = reader_loader.resolve(doc)
            self.pump()
            owner = self.cluster.reservations.owner(doc)
            owners[doc] = owner
            core = self.cluster.node(owner).cores[doc]
            seen = [self.text_of(c).get_text()
                    for _, c in self.writers[doc]]
            seen.append(self.text_of(reader).get_text())
            seen.append(core.sequencer().channel_text(doc, STORE, CHANNEL))
            agreed += len(set(seen)) == 1
            texts[doc] = seen
            rows = self.persisted(doc)
            seqs = [r["sequence_number"] for r in rows]
            contiguous += seqs == list(range(1, len(seqs) + 1))
            ops += len(rows)
            op_rows += sum(1 for r in rows if r["type"] == "op"
                           and r.get("client_id"))
            streams[doc] = [
                [r["sequence_number"], r["minimum_sequence_number"],
                 r["type"], r.get("client_id"),
                 r["client_sequence_number"],
                 r["reference_sequence_number"],
                 json.dumps(r.get("contents"), sort_keys=True),
                 r.get("data")] for r in rows]
            left = {json.loads(r["data"])["clientId"] for r in rows
                    if r["type"] == "leave" and r.get("data")}
            evicted[doc] = sorted(set(stale[doc]) & left)
            reader.close()
        for doc in self.docs:
            for _, c in self.writers[doc]:
                c.close()
        return {"docs": len(self.docs), "nodes": self.spec.nodes,
                "waves": self.wave_no, "owners": owners,
                "ops": ops, "op_rows": op_rows,
                "typed": sum(self.typed.values()),
                "evicted": sum(len(v) for v in evicted.values()),
                "stale": sum(len(v) for v in stale.values()),
                "contiguous": contiguous, "agreed": agreed,
                "chars": sum(len(t[0]) for t in texts.values()),
                "texts": digest(texts), "streams": digest(streams),
                "evicted_ids": digest(evicted)}
