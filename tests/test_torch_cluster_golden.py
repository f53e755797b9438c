"""The committed cluster golden (fluidframework_tpu_torch/testing/golden/
cluster_golden.json): the JAX package's multi-node ordering on its
TpuLocalServer cores through an owner's death and a takeover
(testing/cluster_runs.py), as digests.

chip_smoke.py phase 21 (b) holds the port's cluster on the card against
the card section (golden.CLUSTER_CARD). Here the file's invariants are
checked, both sections are rebuilt through the JAX package and run
through the port on the CPU, and the reference's shared checkpoint row is
shown losing a takeover (ROADMAP Queue 3 item 11). Regenerate the file
only on a deliberate change of the scenario:

    JAX_PLATFORMS=cpu python tests/test_torch_cluster_golden.py --write
"""

from __future__ import annotations

import sys

import pytest
import torch

from fluidframework_tpu_torch.testing import cluster_runs, golden

torch.set_num_threads(1)

CARD = cluster_runs.Spec(**golden.CLUSTER_CARD)
SMALL = cluster_runs.Spec(**golden.CLUSTER_SMALL)


def jax_package() -> cluster_runs.ClusterPackage:
    from fluidframework_tpu.dds import sequence
    from fluidframework_tpu.loader import container, delta_manager
    from fluidframework_tpu.loader.drivers import cluster
    from fluidframework_tpu.server import local_server, nodes, storage
    from fluidframework_tpu.server.lambdas import scriptorium
    return cluster_runs.ClusterPackage(
        local_server, storage, delta_manager, sequence, container, nodes,
        cluster, scriptorium, {}, {})


def build_cluster_golden(pkg) -> dict:
    return {"card": cluster_runs.run(pkg, CARD),
            "small": cluster_runs.run(pkg, SMALL)}


class TestClusterGolden:
    @pytest.mark.parametrize("size", ["card", "small"])
    def test_golden_holds_the_takeover(self, size):
        """Every document moved to node B, no seq was reused or skipped,
        every operation typed was persisted, every client of the dead
        owner was evicted, and every text agrees (writers, late reader,
        the owner's device lanes)."""
        spec = CARD if size == "card" else SMALL
        g = golden.load_cluster()[size]
        assert g["docs"] == spec.docs and g["nodes"] == spec.nodes
        assert set(g["owners"].values()) == {"node-B"}
        assert g["contiguous"] == g["agreed"] == spec.docs
        assert g["op_rows"] == g["typed"] == \
            spec.docs * cluster_runs.WRITERS * spec.ops * \
            (spec.before + spec.after)
        assert g["evicted"] == g["stale"] == \
            spec.docs * cluster_runs.WRITERS
        assert g["waves"] == spec.before + spec.after

    def test_port_small_matches_golden(self):
        assert cluster_runs.run(cluster_runs.port_package("cpu"),
                                SMALL) == golden.load_cluster()["small"]

    def test_port_card_matches_golden(self):
        assert cluster_runs.run(cluster_runs.port_package("cpu"),
                                CARD) == golden.load_cluster()["card"]

    def test_jax_small_matches_golden(self):
        assert cluster_runs.run(jax_package(), SMALL) == \
            golden.load_cluster()["small"]

    def test_reference_takeover_restores_a_stale_checkpoint(self):
        """Queue 3 item 11: without per-document scoping every core of the
        JAX Cluster writes the one "tpu-sequencer" checkpoint row, so the
        next owner restores another core's dump for the first document,
        and that document's ops after the takeover are lost; the port's
        Cluster (and the JAX one under cluster_runs.reference_repair)
        keeps them."""
        broken = cluster_runs.run(jax_package(), SMALL, repair=False)
        assert broken["agreed"] < SMALL.docs
        assert broken["op_rows"] < broken["typed"]
        port = cluster_runs.run(cluster_runs.port_package("cpu"), SMALL,
                                repair=False)
        assert port == golden.load_cluster()["small"]

    def test_repair_is_undone(self):
        pkg = jax_package()
        before = (pkg.nodes.OrdererNode._own_core,
                  pkg.nodes.Cluster.deli_checkpoint)
        cluster_runs.run(pkg, cluster_runs.Spec(docs=1, before=1, after=1,
                                                ops=2))
        assert (pkg.nodes.OrdererNode._own_core,
                pkg.nodes.Cluster.deli_checkpoint) == before

    def test_committed_card_matches_jax(self):
        assert cluster_runs.run(jax_package(), CARD) == \
            golden.load_cluster()["card"]


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_cluster_golden.py --write")
    golden.save_cluster(build_cluster_golden(jax_package()))
    print(f"wrote {golden.CLUSTER_GOLDEN_PATH} "
          f"({golden.CLUSTER_GOLDEN_PATH.stat().st_size} bytes)")
