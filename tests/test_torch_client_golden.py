"""The committed client-stack golden (fluidframework_tpu_torch/testing/
golden/client_golden.json): the JAX package's Loader, local driver,
runtime and DDSes on its TpuLocalServer through testing/client_runs.py,
as digests.

chip_smoke.py phase 19 holds the port's client stack on the card against
the card section (golden.CLIENT_CARD). Here the file's invariants are
checked, and both sections are rebuilt through the JAX package, and the
small one run through the port, all on the CPU. Regenerate the file only
on a deliberate change of the scenario:

    JAX_PLATFORMS=cpu python tests/test_torch_client_golden.py --write
"""

from __future__ import annotations

import sys

import pytest
import torch

from fluidframework_tpu_torch.testing import client_runs, golden

# One intra-op thread for the port's CPU tensors in this process. Under
# pytest-xdist every worker imports this module, so this holds for the
# whole run: six workers each spinning up a thread per core oversubscribe
# the host, and the port's plain scans then run about thirtyfold slower
# (six concurrent runs of test_torch_lambda_golden's mixed case: 283 s
# each against 9.7 s with one thread each, on an 8-core host).
torch.set_num_threads(1)

CARD = client_runs.Spec(**golden.CLIENT_CARD)
SMALL = client_runs.Spec(**golden.CLIENT_SMALL)


def jax_package() -> client_runs.ClientPackage:
    from fluidframework_tpu.dds import (counter, directory, map, matrix,
                                        sequence)
    from fluidframework_tpu.loader import container, delta_manager
    from fluidframework_tpu.loader.drivers import local
    from fluidframework_tpu.mergetree import client
    from fluidframework_tpu.protocol import summary
    from fluidframework_tpu.server import local_server, storage
    from fluidframework_tpu.telemetry import counters
    return client_runs.ClientPackage(
        local_server, storage, summary, counters, container, delta_manager,
        local, client, sequence, matrix, map, directory, counter, {}, {})


def build_client_golden(pkg) -> dict:
    return {"card": client_runs.run(pkg, CARD),
            "small": client_runs.run(pkg, SMALL)}


class TestClientGolden:
    @pytest.mark.parametrize("size", ["card", "small"])
    def test_golden_covers_every_kind(self, size):
        """Each late joiner's kind took its path: kinds 1 and 4 reached
        apply_bulk, every kind-3 reader adopted an artifact, the read
        tier swallowed nothing, and the clients of each document agree
        but on intervals (the JAX package leaves an interval's end on its
        creator where the other replicas slide it)."""
        spec = CARD if size == "card" else SMALL
        g = golden.load_client()[size]
        per_kind = spec.docs // len(client_runs.KINDS)
        assert g["docs"] == spec.docs
        assert g["waves"] == 2 * spec.rounds + 5
        assert g["bulk_applies"]["1"] >= per_kind
        assert g["bulk_applies"]["4"] >= per_kind
        assert g["adopted"] == per_kind
        assert g["swallowed"] == 0
        assert set(g["diverged"]) <= {"intervals"}
        assert g["ops"] > 0 and g["chars"] > 0

    def test_jax_small_matches_golden(self):
        assert client_runs.run(jax_package(), SMALL) == \
            golden.load_client()["small"]

    def test_port_small_matches_golden(self):
        assert client_runs.run(client_runs.port_package("cpu"), SMALL) == \
            golden.load_client()["small"]

    def test_run_restores_what_it_pins(self):
        """The scenario's pins (client ids, clocks, interval ids, the
        random state, the forced bulk route, the counted apply_bulk) are
        the package's own again after a run."""
        import os
        import random

        pkg = client_runs.port_package("cpu")
        before = (pkg.local_server.uuid, pkg.storage.time,
                  pkg.delta_manager.time, pkg.sequence._interval_uid,
                  pkg.client.MergeTreeClient.apply_bulk,
                  os.environ.get("FLUID_TPU_FORCE_BULK"))
        state = random.getstate()
        client_runs.run(pkg, client_runs.Spec(docs=1, rounds=1, ops=4,
                                              lww=1))
        assert (pkg.local_server.uuid, pkg.storage.time,
                pkg.delta_manager.time, pkg.sequence._interval_uid,
                pkg.client.MergeTreeClient.apply_bulk,
                os.environ.get("FLUID_TPU_FORCE_BULK")) == before
        assert random.getstate() == state

    def test_committed_card_matches_jax(self):
        assert client_runs.run(jax_package(), CARD) == \
            golden.load_client()["card"]


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_client_golden.py --write")
    from fluidframework_tpu.core.platform import force_host_platform
    force_host_platform(1)
    golden.save_client(build_client_golden(jax_package()))
    print(f"wrote {golden.CLIENT_GOLDEN_PATH} "
          f"({golden.CLIENT_GOLDEN_PATH.stat().st_size} bytes)")
