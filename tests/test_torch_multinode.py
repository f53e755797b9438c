"""Multi-node ordering tests: reservations, proxying through non-owners,
owner death -> takeover resuming from shared checkpoints (reference
memory-orderer reservationManager/localNode/proxyOrderer, SURVEY §2.6.4).

A mirror of tests/test_multinode.py: every assertion of the JAX file, run
through fluidframework_tpu_torch on the CPU (device="cpu" for every
Loader and TpuLocalServer).
"""

import functools

from fluidframework_tpu_torch.dds.counter import SharedCounter
from fluidframework_tpu_torch.dds.sequence import SharedString
from fluidframework_tpu_torch.loader import container as _container
from fluidframework_tpu_torch.loader.drivers.cluster import (
    ClusterDocumentServiceFactory,
)
from fluidframework_tpu_torch.server.nodes import Cluster


# The port runs on the card unless told otherwise; these tests run on
# the CPU.
Loader = functools.partial(_container.Loader, device="cpu")


class TestReservations:
    def test_first_claim_wins_and_sticks(self):
        cluster = Cluster()
        a = cluster.create_node("A")
        b = cluster.create_node("B")
        assert cluster.reservations.get_or_reserve("doc", "A") == "A"
        assert cluster.reservations.get_or_reserve("doc", "B") == "A"
        assert cluster.reservations.owner("doc") == "A"

    def test_expired_lease_taken_over(self):
        cluster = Cluster(lease_s=60.0)
        cluster.create_node("A")
        cluster.create_node("B")
        assert cluster.reservations.get_or_reserve("doc", "A", now=1000) == "A"
        # Still leased at t=1030.
        assert cluster.reservations.get_or_reserve("doc", "B", now=1030) == "A"
        # Expired at t=1061 (heartbeats too old anyway -> dead owner).
        assert cluster.reservations.get_or_reserve("doc", "B", now=1061.1) == "B"

    def test_dead_owner_taken_over_before_lease_expiry(self):
        cluster = Cluster(lease_s=3600.0)
        a = cluster.create_node("A")
        cluster.create_node("B")
        cluster.reservations.get_or_reserve("doc", "A")
        a.stop()  # marks dead in the node registry
        assert cluster.reservations.get_or_reserve("doc", "B") == "B"

    def test_extend_only_by_owner(self):
        cluster = Cluster()
        cluster.create_node("A")
        cluster.create_node("B")
        cluster.reservations.get_or_reserve("doc", "A")
        assert cluster.reservations.extend("doc", "A") is True
        assert cluster.reservations.extend("doc", "B") is False


class TestProxy:
    def test_clients_on_different_nodes_converge(self):
        cluster = Cluster()
        node_a = cluster.create_node("A")
        node_b = cluster.create_node("B")

        fa = ClusterDocumentServiceFactory(cluster, node_a)
        fb = ClusterDocumentServiceFactory(cluster, node_b)
        la, lb = Loader(fa), Loader(fb)

        c1 = la.create_detached("doc")
        ds = c1.runtime.create_datastore("default")
        text = ds.create_channel("text", SharedString.TYPE)
        text.insert_text(0, "base")
        c1.attach()

        # Second client enters through the NON-owning node B -> proxy path.
        assert cluster.reservations.owner("doc") == "A"
        c2 = lb.resolve("doc")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert t2.get_text() == "base"

        t2.insert_text(4, "+B")
        text.insert_text(0, "A+")
        assert text.get_text() == t2.get_text() == "A+base+B"
        # Ownership did not move.
        assert cluster.reservations.owner("doc") == "A"


class TestTakeover:
    def test_owner_death_takeover_resumes_sequencing(self):
        cluster = Cluster()
        node_a = cluster.create_node("A")
        node_b = cluster.create_node("B")

        fa = ClusterDocumentServiceFactory(cluster, node_a)
        la = Loader(fa)
        c1 = la.create_detached("doc")
        ds = c1.runtime.create_datastore("default")
        counter = ds.create_channel("n", SharedCounter.TYPE)
        c1.attach()
        counter.increment(7)
        seq_before = c1.delta_manager.last_sequence_number
        assert counter.value == 7

        # Owner dies; the container sees the disconnect.
        node_a.stop()
        assert not c1.connected

        # Client fails over to node B: reservation moves, deli resumes from
        # the shared checkpoint, and the pending/new ops sequence without
        # restarting sequence numbers.
        fa.set_node(node_b)
        c1.reconnect()
        assert c1.connected
        assert cluster.reservations.owner("doc") == "B"
        counter.increment(3)
        assert counter.value == 10
        assert c1.delta_manager.last_sequence_number > seq_before

        # A fresh client through B sees the full converged state.
        c2 = Loader(ClusterDocumentServiceFactory(cluster, node_b)
                    ).resolve("doc")
        n2 = c2.runtime.get_datastore("default").get_channel("n")
        assert n2.value == 10

    def test_takeover_sequences_leaves_for_dead_clients(self):
        cluster = Cluster()
        node_a = cluster.create_node("A")
        node_b = cluster.create_node("B")
        fa = ClusterDocumentServiceFactory(cluster, node_a)
        la = Loader(fa)
        c1 = la.create_detached("doc")
        ds = c1.runtime.create_datastore("default")
        ds.create_channel("n", SharedCounter.TYPE)
        c1.attach()
        assert len(c1.audience.members) == 1

        node_a.stop()
        fa.set_node(node_b)
        c1.reconnect()
        # Exactly one member again: the takeover evicted the dead identity
        # (server-sequenced leave), and the reconnect joined the new one.
        assert len(c1.audience.members) == 1

    def test_stale_owner_fences_instead_of_forking(self):
        """Split-brain guard: once the reservation moves, the old owner's
        core must refuse to sequence (pump gate) and drop its clients."""
        cluster = Cluster(lease_s=60.0)
        node_a = cluster.create_node("A")
        node_b = cluster.create_node("B")
        fa = ClusterDocumentServiceFactory(cluster, node_a)
        c1 = Loader(fa).create_detached("doc")
        ds = c1.runtime.create_datastore("default")
        counter = ds.create_channel("n", SharedCounter.TYPE)
        c1.attach()
        counter.increment(1)
        deltas_before = len(cluster.node("A").get_deltas("doc"))

        # Steal the reservation (as a takeover after A's lease lapsed
        # would) while A is still running with connected clients.
        with cluster.reservations._lock:
            cluster.reservations.reservations.upsert(
                lambda d: d.get("key") == "doc",
                {"key": "doc", "nodeId": "B", "expires": 2 ** 62})

        # A's next sequencing attempt self-fences: the pump gate aborts
        # before ticketing, the op is never persisted, and the stale
        # client is disconnected.
        counter.increment(99)
        assert not c1.connected
        assert "doc" not in node_a.cores
        assert len(cluster.node("B").get_deltas("doc")) == deltas_before

        # The fenced op was never sequenced but lives on in the client's
        # pending state; more offline edits buffer behind it. Failing over
        # to the new owner replays them all — no op loss through fencing.
        counter.increment(1)
        fa.set_node(node_b)
        c1.reconnect()
        assert counter.value == 101
        c2 = Loader(ClusterDocumentServiceFactory(cluster, node_b)
                    ).resolve("doc")
        assert c2.runtime.get_datastore("default").get_channel("n").value \
            == 101

    def test_summaries_survive_takeover(self):
        cluster = Cluster()
        node_a = cluster.create_node("A")
        node_b = cluster.create_node("B")
        fa = ClusterDocumentServiceFactory(cluster, node_a)
        la = Loader(fa)
        c1 = la.create_detached("doc")
        ds = c1.runtime.create_datastore("default")
        text = ds.create_channel("text", SharedString.TYPE)
        text.insert_text(0, "durable")
        c1.attach()
        acks = []
        c1.summarize(lambda h, ack, c: acks.append(ack))
        node_a.cores["doc"].pump()
        assert acks == [True]

        node_a.stop()
        # Late client loads from the summary through node B (shared git).
        c2 = Loader(ClusterDocumentServiceFactory(cluster, node_b)
                    ).resolve("doc")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert t2.get_text() == "durable"
