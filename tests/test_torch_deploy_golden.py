"""The committed deployment golden (fluidframework_tpu_torch/testing/
golden/deploy_golden.json): the JAX package's deployment worker
(server/main.build_worker, tpu-deli over a gRPC broker, durable sqlite
deltas) fed testing/deploy_runs's fleet, as each document's persisted
deltas.

chip_smoke.py phase 21 (c) holds the port's worker on the card against
the card section (golden.DEPLOY_CARD). Here the small section is rebuilt
through the JAX package and run through the port on the CPU, each against
an in-process broker of its own package (payloads are pickled with the
package's classes, so each package's worker needs its own broker), and
every row the port's worker writes must serialize as JSON without
`default=str`. The card section is rebuilt only by the write below, from
the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tests/test_torch_deploy_golden.py --write
"""

from __future__ import annotations

import importlib
import json
import sys
import tempfile

import pytest
import torch

pytest.importorskip("grpc")

from fluidframework_tpu_torch.testing import deploy_runs, golden  # noqa: E402

torch.set_num_threads(1)

CARD = deploy_runs.Spec(**golden.DEPLOY_CARD)
SMALL = deploy_runs.Spec(**golden.DEPLOY_SMALL)


def jax_package() -> deploy_runs.DeployPackage:
    from fluidframework_tpu.protocol import messages
    from fluidframework_tpu.server import durable, log_service, main, routing
    from fluidframework_tpu.server.lambdas import scriptorium
    return deploy_runs.DeployPackage(main, log_service, durable, messages,
                                     routing, scriptorium)


PACKAGES = {"fluidframework_tpu": jax_package,
            "fluidframework_tpu_torch": deploy_runs.port_package}


def run_on_own_broker(name: str, spec: deploy_runs.Spec,
                      device=None) -> dict:
    """deploy_runs.run of the package `name` against an in-process broker
    (LogServiceServer over that package's MessageLog)."""
    pkg = PACKAGES[name]()
    log = importlib.import_module(f"{name}.server.log").MessageLog(
        default_partitions=spec.partitions)
    for topic in (pkg.main.RAW_TOPIC, pkg.main.DELTAS_TOPIC,
                  pkg.main.NACKS_TOPIC):
        log.topic(topic)
    server = pkg.log_service.LogServiceServer(log, port=0)
    server.start()
    try:
        with tempfile.TemporaryDirectory() as storage:
            result, _ = deploy_runs.run(pkg, spec, server.address, storage,
                                        device=device)
        return result
    finally:
        server.stop()


def build_deploy_golden() -> dict:
    return {size: run_on_own_broker("fluidframework_tpu", spec)
            for size, spec in (("card", CARD), ("small", SMALL))}


class TestDeployGolden:
    @pytest.mark.parametrize("size", ["card", "small"])
    def test_golden_holds_every_delta(self, size):
        spec = CARD if size == "card" else SMALL
        g = golden.load_deploy()[size]
        ops = spec.docs * spec.ops * (spec.warm + spec.measured)
        assert g["docs"] == spec.docs == len(g["deltas"])
        assert g["ops"] == ops
        assert g["rows"] == ops + spec.docs  # and one join a document

    def test_jax_small_matches_golden(self):
        assert run_on_own_broker("fluidframework_tpu", SMALL) == \
            golden.load_deploy()["small"]

    def test_port_small_matches_golden(self, monkeypatch):
        """The port's worker on the CPU equals the JAX golden, and every
        row it writes to the durable store is plain JSON: durable.py
        encodes with default=str, which would turn a tensor or a numpy
        scalar left in a row into text."""
        from fluidframework_tpu_torch.server import durable
        refused = []

        class StrictJson:
            loads = staticmethod(json.loads)

            @staticmethod
            def dumps(obj, **kwargs):
                plain = {k: v for k, v in kwargs.items() if k != "default"}
                try:
                    json.dumps(obj, **plain)
                except TypeError as exc:
                    refused.append(repr(exc))
                return json.dumps(obj, **kwargs)

        monkeypatch.setattr(durable, "json", StrictJson)
        got = run_on_own_broker("fluidframework_tpu_torch", SMALL,
                                device="cpu")
        assert refused == []
        assert got == golden.load_deploy()["small"]


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_deploy_golden.py --write")
    golden.save_deploy(build_deploy_golden())
    print(f"wrote {golden.DEPLOY_GOLDEN_PATH} "
          f"({golden.DEPLOY_GOLDEN_PATH.stat().st_size} bytes)")
