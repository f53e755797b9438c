"""The committed lambda golden (fluidframework_tpu_torch/testing/golden/
lambda_golden.json): the JAX package's TpuSequencerLambda through the
scenarios of testing/lambda_runs.py, as digests.

chip_smoke.py phase 16 holds the port's lambda on the card against it. Here
the port's lambda on the CPU is held against it at the sizes that fit the
tier-1 run (the storm fleet, the small serving fleet, the small mixed
stream); the full-width serving fleet and the 1,024-document mixed stream
run on the card (chip_smoke.py phase 16), and the rebuild of the whole
file from JAX takes minutes and is marked slow. Regenerate the file only
on a deliberate change of the scenarios:

    JAX_PLATFORMS=cpu python tests/test_torch_lambda_golden.py --write
"""

from __future__ import annotations

import sys

import pytest

from fluidframework_tpu_torch.testing import golden, lambda_runs


def jax_package():
    from fluidframework_tpu.server import tpu_sequencer, wire
    from fluidframework_tpu.server.database import Collection
    from fluidframework_tpu.server.lambdas.scriptorium import delta_key
    from fluidframework_tpu.server.log import QueuedMessage
    from fluidframework_tpu.telemetry import counters
    return lambda_runs.Package(tpu_sequencer.TpuSequencerLambda,
                               QueuedMessage, wire.boxcar_from_wire,
                               Collection, delta_key, counters, {})


def port_package():
    return lambda_runs.port_package("cpu")


def serving_section(pkg, size) -> dict:
    return {layout: lambda_runs.serving_run(pkg, *size,
                                            paged=layout == "paged")
            for layout in ("bucketed", "paged")}


def storm_section(pkg) -> dict:
    return {mode: lambda_runs.storm_run(pkg, mode)
            for mode in ("sync", "mega")}


def build_lambda_golden(pkg) -> dict:
    return {"serving": serving_section(pkg, golden.LAMBDA_SERVING),
            "serving_small": serving_section(pkg,
                                             golden.LAMBDA_SERVING_SMALL),
            "storm": storm_section(pkg),
            "mixed": lambda_runs.mixed_run(pkg, *golden.LAMBDA_MIXED),
            "mixed_small": lambda_runs.mixed_run(
                pkg, *golden.LAMBDA_MIXED_SMALL)}


class TestLambdaGolden:
    def test_golden_covers_the_hard_cases(self):
        g = golden.load_lambda()
        for layout in ("bucketed", "paged"):
            full = g["serving"][layout]
            assert (full["docs"], full["ops"]) == golden.LAMBDA_SERVING
            assert full["nacks"] == 0 and full["stream"]["admitted"] == \
                full["docs"] * (full["ops"] * full["waves"] + 1)
        assert g["storm"]["sync"]["stream"] == g["storm"]["mega"]["stream"]
        assert 0 < g["storm"]["mega"]["dispatches_per_window"] < 0.25
        assert g["mixed"]["docs"] >= 1000
        for mixed in (g["mixed"], g["mixed_small"]):
            assert mixed["nacks"] > 0
            assert mixed["promoted"] > 0 and mixed["restored_docs"] > 0
            assert mixed["poison"] > 0 and mixed["catchup_docs"] > 0

    def test_port_storm_matches_golden(self):
        """The sync run equals the golden's. The megakernel run equals the
        golden's stream, rings and served windows, and its texts equal
        the sync texts: the JAX megakernel, which made the golden, loses
        the storm document's text (its chunks dispatch back to back on
        stale page scalars); the port drains the ring between chunks."""
        got = storm_section(port_package())
        want = golden.load_lambda()["storm"]
        assert got["sync"] == want["sync"]
        for key in ("mode", "messages", "stream", "rings",
                    "served_windows"):
            assert got["mega"][key] == want["mega"][key], key
        assert got["mega"]["texts"] == want["sync"]["texts"]
        assert 0 < got["mega"]["dispatches_per_window"] < 0.25

    def test_port_small_serving_matches_golden(self):
        got = serving_section(port_package(), golden.LAMBDA_SERVING_SMALL)
        assert got == golden.load_lambda()["serving_small"]

    def test_port_mixed_matches_golden(self):
        got = lambda_runs.mixed_run(port_package(),
                                    *golden.LAMBDA_MIXED_SMALL)
        assert got == golden.load_lambda()["mixed_small"]

    @pytest.mark.slow
    def test_committed_file_matches_jax(self):
        assert build_lambda_golden(jax_package()) == golden.load_lambda()


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_lambda_golden.py --write")
    from fluidframework_tpu.core.platform import force_host_platform
    force_host_platform(1)
    golden.save_lambda(build_lambda_golden(jax_package()))
    print(f"wrote {golden.LAMBDA_GOLDEN_PATH} "
          f"({golden.LAMBDA_GOLDEN_PATH.stat().st_size} bytes)")
