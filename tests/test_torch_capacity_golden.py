"""The committed capacity golden (fluidframework_tpu_torch/testing/
golden/capacity_golden.json): the JAX package's chaos-on capacity grade
of a TpuLocalServer fleet (testing/capacity_runs.grade: the grader's
probes, then the capacity point twice), its keystroke load test and its
headless agents (testing/client_load_runs).

chip_smoke.py phase 22 holds the port on the card against the card
sections (capacity_runs.CAPACITY_CARD, client_load_runs.LOAD_CARD, the
agents). Here the small sections are rebuilt through the JAX package
(tests/test_torch_capacity.py and tests/test_torch_load_test.py run the
port against them on the CPU). Every section is rebuilt only by the
write below, from the JAX package on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_capacity_golden.py \
        --write [small|card|load|agents]
"""

from __future__ import annotations

import sys

import pytest

from fluidframework_tpu_torch.testing import (capacity_runs,
                                              client_load_runs, golden)


def jax_package() -> capacity_runs.CapacityPackage:
    from fluidframework_tpu import capacity
    from fluidframework_tpu.server import local_server
    from fluidframework_tpu.testing import faultinject
    return capacity_runs.CapacityPackage(capacity, faultinject, local_server,
                                         {})


def jax_client_package() -> client_load_runs.ClientPackage:
    from fluidframework_tpu import agents, dds
    from fluidframework_tpu.dds import (map, register_collection,  # noqa
                                        sequence)
    from fluidframework_tpu.framework import agent_scheduler
    from fluidframework_tpu.loader import container
    from fluidframework_tpu.loader.drivers import local
    from fluidframework_tpu.server import local_server
    from fluidframework_tpu.testing import load_test
    return client_load_runs.ClientPackage(
        local_server, container, local, load_test, agents, dds,
        agent_scheduler, {})


def load_record(pkg, profile: dict) -> dict:
    out = client_load_runs.keystroke_load(pkg, profile)
    out.pop("elapsed_s")
    return out


def build_load() -> dict:
    pkg = jax_client_package()
    return {size: dict(load_record(pkg, profile), profile=profile)
            for size, profile in (("small", client_load_runs.LOAD_SMALL),
                                  ("card", client_load_runs.LOAD_CARD))}


def build_section(size: str) -> dict:
    section = capacity_runs.SECTIONS[size]
    record = capacity_runs.grade(section, pkg=jax_package())
    return dict(capacity_runs.comparable(record),
                section=section._asdict())


class TestCapacityGolden:
    @pytest.mark.parametrize("size", ["card", "small"])
    def test_golden_section_is_the_scenario(self, size):
        """Each section was graded at the shape capacity_runs defines,
        with chaos inside the envelope and the capacity point
        reproduced."""
        g = golden.load_capacity()[size]
        section = capacity_runs.SECTIONS[size]
        assert g["section"] == capacity_runs.comparable(
            {"s": section._asdict()})["s"]
        assert g["fingerprints"][0] == g["fingerprints"][1]
        assert g["partition_restarts"] and g["avalanches"] >= 1
        assert len(g["final_seq"]) == section.workload["documents"]
        assert g["grade"]["capacity_mult"] > 0
        assert [p["ok"] for p in g["grade"]["probes"]][:1] == [True]

    def test_jax_small_matches_golden(self):
        assert build_section("small") == golden.load_capacity()["small"]

    def test_jax_load_and_agents_match_golden(self):
        g = golden.load_capacity()
        assert g["load"]["small"] == dict(
            load_record(jax_client_package(), client_load_runs.LOAD_SMALL),
            profile=client_load_runs.LOAD_SMALL)
        assert g["load"]["card"]["profile"] == client_load_runs.LOAD_CARD
        assert client_load_runs.agents_run(jax_client_package()) \
            == g["agents"]


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_capacity_golden.py "
                 "--write [small|card]")
    builders = {"small": lambda: build_section("small"),
                "card": lambda: build_section("card"), "load": build_load,
                "agents": lambda: client_load_runs.agents_run(
                    jax_client_package())}
    sizes = [s for s in builders if s in sys.argv] or list(builders)
    try:
        doc = golden.load_capacity()
    except FileNotFoundError:
        doc = {}
    for size in sizes:
        doc[size] = builders[size]()
        golden.save_capacity(doc)
        print(f"wrote {size} to {golden.CAPACITY_GOLDEN_PATH}")
