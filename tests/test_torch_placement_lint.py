"""The port's placement & sharding dataflow (analysis/placement_model.py,
placement_rules.py) over its single-controller mesh (parallel/mesh.py):
mesh handles (make_mesh, Mesh), the port's PartitionSpec, the placements
(place, shard_docs, replicate, place_with_rules, ensure_placement), the
dispatch boundaries (map_dp, the lane stores' _dispatch, the in-place
forms), and host reads of a Sharded other than through gather, take_rows
or row_of. Rules fire on definite (straight-line) placements only.
"""

import textwrap
from pathlib import Path

import pytest

from fluidframework_tpu_torch.analysis import analyze_paths, analyze_source
from fluidframework_tpu_torch.analysis import placement_model as pm

REPO = Path(__file__).resolve().parents[1]
PLACEMENT = ["MESH_DONATION_GATE", "UNSPECCED_POOL", "PSPEC_MISMATCH",
             "HOST_READ_OF_SHARDED", "SHARD_AXIS_DRIFT"]

PRELUDE = """
from fluidframework_tpu_torch.mergetree.partition_rules import (
    POOL_PARTITION_RULES, ensure_placement, place_with_rules)
from fluidframework_tpu_torch.mergetree.state import make_state
from fluidframework_tpu_torch.parallel.mesh import (
    P, PartitionSpec, gather, make_mesh, map_dp, place, replicate, row_of,
    shard_docs, take_rows)

IN_PLACE_ARGS = {"apply_ops_paged": (0,)}

def apply_ops_paged(pool, ops):
    return pool

def apply_ops_paged_keep(pool, ops):
    return pool
"""


def ids(body, rule):
    src = PRELUDE + textwrap.dedent(body)
    return [v.rule_id for v in analyze_source(src, only=[rule])]


class TestMeshDonationGate:
    def test_sharded_pool_to_in_place_form(self):
        assert ids("""
            def serve(pool, ops):
                mesh = make_mesh(dp=4)
                pool = ensure_placement(mesh, pool, POOL_PARTITION_RULES)
                apply_ops_paged(pool, ops)
        """, "MESH_DONATION_GATE") == ["MESH_DONATION_GATE"]

    def test_conditional_placement_is_a_may_and_quiet(self):
        assert ids("""
            def serve(pool, ops, mesh=None):
                if mesh is not None:
                    pool = place_with_rules(mesh, pool,
                                            POOL_PARTITION_RULES)
                apply_ops_paged(pool, ops)
        """, "MESH_DONATION_GATE") == []


class TestUnspeccedPool:
    def test_host_pool_through_lane_dispatch(self):
        assert ids("""
            def _dispatch(fn, state, *args):
                return fn(state, *args)

            def flush(step, ops):
                pool = make_state(64, 1, batch=256)
                return _dispatch(step, pool, ops)
        """, "UNSPECCED_POOL") == ["UNSPECCED_POOL"]

    def test_non_pool_names_are_quiet(self):
        assert ids("""
            def flush(step, ops):
                mesh = make_mesh(dp=4)
                lanes = make_state(64, 1, batch=256)
                return map_dp(step, mesh, lanes, ops)
        """, "UNSPECCED_POOL") == []


class TestPspecMismatch:
    @pytest.mark.parametrize("spec", ['P("tp")', 'PartitionSpec("x", None)',
                                      'P(("dp", "ep"))'])
    def test_unknown_axis(self, spec):
        assert ids(f"""
            def shard(x):
                mesh = make_mesh(dp=4)
                return place(x, mesh, {spec})
        """, "PSPEC_MISMATCH") == ["PSPEC_MISMATCH"]

    def test_spec_longer_than_rank(self):
        assert ids("""
            import torch

            def shard():
                mesh = make_mesh(dp=4)
                x = torch.zeros((8, 4))
                return place(x, mesh, P("dp", None, None))
        """, "PSPEC_MISMATCH") == ["PSPEC_MISMATCH"]

    def test_unrelated_local_P_is_invisible(self):
        assert analyze_source(textwrap.dedent("""
            def P(*axes):
                return axes

            def f():
                return P("tp")
        """), only=["PSPEC_MISMATCH"]) == []


class TestHostReadOfSharded:
    @pytest.mark.parametrize("read", ["state.item()", "state.cpu()",
                                      "int(state)", "np.asarray(state)"])
    def test_host_read_fires(self, read):
        assert ids(f"""
            import numpy as np

            def lengths(state):
                mesh = make_mesh(dp=4)
                state = shard_docs(mesh, state)
                return {read}
        """, "HOST_READ_OF_SHARDED") == ["HOST_READ_OF_SHARDED"]

    @pytest.mark.parametrize("read", ["gather(state).cpu()",
                                      "take_rows(state, [0, 1]).cpu()",
                                      "row_of(state, 0).cpu()"])
    def test_sanctioned_reads_are_quiet(self, read):
        assert ids(f"""
            def lengths(state):
                mesh = make_mesh(dp=4)
                state = shard_docs(mesh, state)
                return {read}
        """, "HOST_READ_OF_SHARDED") == []

    def test_gather_helper_is_sanctioned(self):
        assert ids("""
            def gather_lengths(state):
                mesh = make_mesh(dp=4)
                state = shard_docs(mesh, state)
                return state.cpu()
        """, "HOST_READ_OF_SHARDED") == []


class TestShardAxisDrift:
    def test_discarded_conflicting_placement(self):
        assert ids("""
            def tiles(x):
                mesh = make_mesh(dp=2, sp=4)
                x = place(x, mesh, P("dp"))
                place(x, mesh, P("dp", "sp"))
                return x
        """, "SHARD_AXIS_DRIFT") == ["SHARD_AXIS_DRIFT"]

    def test_replication_is_no_drift(self):
        assert ids("""
            def tiles(x):
                mesh = make_mesh(dp=2, sp=4)
                x = place(x, mesh, P("dp"))
                y = replicate(mesh, x)
                return x, y
        """, "SHARD_AXIS_DRIFT") == []


class TestModel:
    def test_ports_P_alias_is_a_spec(self):
        src = (REPO / "fluidframework_tpu_torch" / "parallel" /
               "mesh.py").read_text()
        assert "P = PartitionSpec" in src

    def test_rule_table_digest_reads_the_ports_table(self, tmp_path):
        assert pm.RULE_TABLE_REL == \
            "fluidframework_tpu_torch/mergetree/partition_rules.py"
        base = pm.rule_table_digest()
        assert base not in ("absent", "unparsable")

        class Ctx:
            path = "fluidframework_tpu_torch/mergetree/partition_rules.py"
            source = (REPO / path).read_text()

        edited = Ctx()
        edited.source = Ctx.source.replace('(r".*", P("dp"))',
                                           '(r".*", P("sp"))')
        assert pm.rule_table_digest([Ctx()]) == base
        assert pm.rule_table_digest([edited]) != base
        drift = Ctx()
        drift.source = "# a comment\n" + Ctx.source
        assert pm.rule_table_digest([drift]) == base

    def test_ports_mesh_tiers_are_clean(self):
        res = analyze_paths(
            [str(REPO / "fluidframework_tpu_torch" / d)
             for d in ("mergetree", "server", "parallel")], only=PLACEMENT)
        assert res.violations == [], "\n".join(v.render()
                                               for v in res.violations)
