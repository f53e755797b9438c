"""The port's operator tools on the CPU: the serving decay probe
(fluidframework_tpu_torch/server/decay_probe.py, a mirror of
tests/test_quality_gates.py::TestServingDecayProbe and the probe's lane
digest against the JAX probe and its golden), the micro-perf harness
(tools/microbench.py) and the on-card conformance tool
(tools/gpu_conformance.py, whose comparisons run here on the plain
versions).

The decay golden (fluidframework_tpu_torch/testing/golden/
decay_golden.json) is the JAX probe's lane digest at the tool's default
size and at the JAX test's; chip_smoke.py phase 18 holds the card's run
against its "card" section. Rebuilding the file from JAX takes about a
minute and is marked slow:

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_tools.py --write
"""

from __future__ import annotations

import functools
import sys

import pytest
import torch

from fluidframework_tpu_torch.server import decay_probe
from fluidframework_tpu_torch.testing import golden
from fluidframework_tpu_torch.tools import gpu_conformance, microbench


def jax_decay(docs: int, ops: int, waves: int) -> dict:
    """The JAX probe's own run (fluidframework_tpu/server/decay_probe.run),
    and the port's lane_digest of the lambda it drove."""
    from fluidframework_tpu.server import decay_probe as jax_probe
    from fluidframework_tpu.server import tpu_sequencer as jax_seq

    held = []
    base = jax_seq.TpuSequencerLambda

    class Held(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            held.append(self)

    jax_seq.TpuSequencerLambda = Held
    try:
        out = jax_probe.run(docs, ops, waves)
    finally:
        jax_seq.TpuSequencerLambda = base
    assert len(held) == 1 and out["folds"] == held[0].merge.folds
    return decay_section(docs, ops, waves, held[0])


def decay_section(docs: int, ops: int, waves: int, lam) -> dict:
    return {"docs": docs, "ops": ops, "waves": waves,
            "lanes": decay_probe.lane_digest(lam, docs)}


def build_decay_golden() -> dict:
    return {"card": jax_decay(*golden.DECAY_CARD),
            "small": jax_decay(*golden.DECAY_SMALL)}


class TestServingDecayProbe:
    def test_probe_runs_and_reports_no_decay(self):
        """server/decay_probe at tiny shapes: the probe must run the
        real fast path, classify waves, and (with the host zamboni pack
        in place) report decayed=False."""
        out = decay_probe.run(docs=32, ops=8, waves=16, device="cpu")
        if out["decayed"]:  # one retry: a noisy CI neighbor can skew
            out = decay_probe.run(docs=32, ops=8, waves=16,
                                  device="cpu")  # a wall-clock quartile
        assert out["waves"] == 16
        assert out["sustained_ops_per_sec"] > 0
        assert out["decayed"] is False, out
        assert out["backend"] == "cpu"

    def test_lanes_equal_jax_probe(self):
        """At the JAX test's shape (32 x 8 x 16) the port's probe leaves
        the same lane-health counters and lane texts as the JAX probe."""
        _, lam, _ = decay_probe.probe(*golden.DECAY_SMALL, device="cpu")
        got = decay_section(*golden.DECAY_SMALL, lam)
        assert got == jax_decay(*golden.DECAY_SMALL)

    def test_port_small_run_matches_golden(self):
        _, lam, _ = decay_probe.probe(*golden.DECAY_SMALL, device="cpu")
        assert decay_section(*golden.DECAY_SMALL, lam) == \
            golden.load_decay()["small"]

    def test_golden_covers_folds_without_drops(self):
        """The card section is the tool's default run: its lanes fold
        (the maintenance waves the verdict sorts out) and drop nothing."""
        g = golden.load_decay()
        card = g["card"]
        assert (card["docs"], card["ops"], card["waves"]) == \
            golden.DECAY_CARD
        assert card["lanes"]["folds"] > 0
        assert card["lanes"]["overflow_drops"] == 0
        small = g["small"]
        assert (small["docs"], small["ops"], small["waves"]) == \
            golden.DECAY_SMALL
        assert small["lanes"]["overflow_drops"] == 0
        for section in (card, small):
            assert section["lanes"]["chars"] > 0

    def test_wave_frames_equal_jax_probe(self):
        """The waves are the JAX probe's: the same wire bytes (the JAX
        tool builds them inside run(), so they are rebuilt here from its
        message classes)."""
        import json
        import random

        from fluidframework_tpu.mergetree.client import OP_INSERT
        from fluidframework_tpu.protocol.messages import (
            Boxcar, DocumentMessage, MessageType)
        from fluidframework_tpu.server.wire import boxcar_to_wire
        docs, ops = 6, 5
        for wave in (0, 3):
            rng = random.Random(17 + wave)
            want = []
            for d in range(docs):
                contents = []
                if wave == 0:
                    contents.append(DocumentMessage(
                        client_sequence_number=0,
                        reference_sequence_number=-1,
                        type=MessageType.CLIENT_JOIN,
                        data=json.dumps({"clientId": f"c{d}",
                                         "detail": {}})))
                for i in range(ops):
                    n = rng.randrange(1, 4)
                    contents.append(DocumentMessage(
                        client_sequence_number=wave * ops + i + 1,
                        reference_sequence_number=wave * ops,
                        type=MessageType.OPERATION,
                        contents={"address": "s", "contents": {
                            "address": "t", "contents": {
                                "type": OP_INSERT, "pos1": 0,
                                "seg": {"text": "x" * n}}}}))
                want.append((wave * docs + d, f"d{d}", boxcar_to_wire(
                    Boxcar(tenant_id="b", document_id=f"d{d}",
                           client_id=f"c{d}", contents=contents))))
            got = [(m.offset, m.key, m.value)
                   for m in decay_probe.build_wave(docs, ops, wave)]
            assert got == want

    def test_prebuilt_waves_drive_the_same_lanes(self):
        """Waves built before the probe (as chip_smoke.py builds the
        fleet's while its kernels compile) give the lanes the probe's own
        build gives; a wave count that disagrees is refused."""
        docs, ops, waves = golden.DECAY_SMALL
        waves_in = [decay_probe.build_wave(docs, ops, w)
                    for w in range(waves)]
        _, lam, _ = decay_probe.probe(docs, ops, waves, device="cpu",
                                      prebuilt=waves_in)
        _, own, _ = decay_probe.probe(docs, ops, waves, device="cpu")
        assert decay_probe.lane_digest(lam, docs) == \
            decay_probe.lane_digest(own, docs)
        with pytest.raises(ValueError):
            decay_probe.probe(docs, ops, waves, device="cpu",
                              prebuilt=waves_in[:-1])

    def test_main_exit_code_follows_the_verdict(self, monkeypatch,
                                                capsys):
        for decayed, code in ((False, 0), (True, 1)):
            monkeypatch.setattr(decay_probe, "run",
                                lambda *a, d=decayed, **k: {"decayed": d})
            assert decay_probe.main(["--waves", "4"]) == code
        assert '"decayed": true' in capsys.readouterr().out

    def test_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            decay_probe.run(4, 2, 4)

    @pytest.mark.slow
    def test_committed_file_matches_jax(self):
        assert build_decay_golden() == golden.load_decay()


class TestMicrobench:
    def test_rows_equal_jax(self, monkeypatch):
        """run_all(200, with_kernel=True): the same probes in the same
        order with the same op counts as the JAX harness; the kernel probe
        at 16 x 8 on both (the port's on the CPU, its plain scan apply)."""
        from fluidframework_tpu.tools import microbench as jax_bench
        for mod in (jax_bench, microbench):
            monkeypatch.setattr(mod, "probe_kernel_throughput",
                                functools.partial(
                                    mod.probe_kernel_throughput, 16, 8))
        want = jax_bench.run_all(200, with_kernel=True)
        got = microbench.run_all(200, with_kernel=True, device="cpu")
        assert [(r["probe"], r["ops"]) for r in got] == \
            [(r["probe"], r["ops"]) for r in want]
        assert got[-1] == {**got[-1], "probe": "kernel.apply_batched",
                           "ops": 128}
        assert all(r["total_ms"] >= 0 for r in got)

    def test_kernel_probe_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert [r["probe"] for r in microbench.run_all(
            50, with_kernel=False)][0] == "oracle.insert"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            microbench.probe_kernel_throughput(4, 4)


class TestGpuConformance:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_check_holds_fused_to_scan(self, seed, capsys):
        assert gpu_conformance.check(12, 16, 64, seed, device="cpu")
        assert gpu_conformance.check_runs(6, 24, 64, seed + 7,
                                          device="cpu")
        out = capsys.readouterr().out
        assert "OK" in out and "not measured" in out

    def test_check_reports_a_mismatch(self, monkeypatch, capsys):
        from fluidframework_tpu_torch.mergetree import pallas_apply

        real = pallas_apply.apply_ops_fused

        def off_by_one(state, ops, runs=None, extract=False):
            out = real(state, ops, runs=runs, extract=extract)
            return out._replace(count=out.count + 1)

        monkeypatch.setattr(pallas_apply, "apply_ops_fused", off_by_one)
        assert not gpu_conformance.check(4, 8, 64, 0, device="cpu")
        assert not gpu_conformance.check_runs(4, 16, 64, 7, device="cpu")
        out = capsys.readouterr().out
        assert "MISMATCH in count" in out and "FAIL" in out

    def test_main_without_a_card_returns_2(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert gpu_conformance.main(["--heavy"]) == 2

    def test_main_runs_the_jax_tools_shapes(self, monkeypatch, capsys):
        """The JAX tool's shapes (tools/tpu_conformance.py main), every
        one run even after a failure; exit 1 on any mismatch."""
        calls = []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0: "stub")
        monkeypatch.setattr(gpu_conformance, "check",
                            lambda *s: calls.append(("plain", s)) or
                            s[-1] != 1)
        monkeypatch.setattr(gpu_conformance, "check_runs",
                            lambda *s: calls.append(("runs", s)) or True)
        assert gpu_conformance.main(["--heavy"]) == 1
        assert calls == [
            ("plain", (512, 64, 256, 0)), ("plain", (2048, 100, 256, 1)),
            ("plain", (128, 48, 512, 2)), ("plain", (512, 128, 1024, 3)),
            ("runs", (256, 64, 256, 7)), ("runs", (512, 96, 512, 8))]
        calls.clear()
        monkeypatch.setattr(gpu_conformance, "check",
                            lambda *s: calls.append(("plain", s)) or True)
        assert gpu_conformance.main([]) == 0
        assert [c[1] for c in calls] == [
            (512, 64, 256, 0), (2048, 100, 256, 1), (128, 48, 512, 2),
            (256, 64, 256, 7)]
        assert "CONFORMANCE OK" in capsys.readouterr().out


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_tools.py --write")
    from fluidframework_tpu.core.platform import force_host_platform
    force_host_platform(1)
    golden.save_decay(build_decay_golden())
    print(f"wrote {golden.DECAY_GOLDEN_PATH} "
          f"({golden.DECAY_GOLDEN_PATH.stat().st_size} bytes)")
