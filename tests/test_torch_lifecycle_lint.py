"""The port's in-place lifecycle rules (analysis/dataflow.py,
lifecycle_rules.py): USE_AFTER_DONATE, DONATED_ESCAPE and the
PAGE_ID_DTYPE torch.int32 lattice over the in-place forms that
IN_PLACE_ARGS tables declare (the port's counterpart of JAX's
donate_argnums: mergetree/kernel.py's paged ops, mergetree/paging.py's
page writes, serve_step's paged burst and megakernel).

In torch an in-place write is no crash: a read of the old binding after
the call silently sees the new state. The fixtures below pin the shapes
the rules exist for and the idioms they stay quiet on.
"""

import textwrap
from pathlib import Path

import pytest

from fluidframework_tpu_torch.analysis import analyze_paths, analyze_source

REPO = Path(__file__).resolve().parents[1]

PRELUDE = """
IN_PLACE_ARGS = {"apply_ops_paged": (0,), "serve_megakernel": (1,)}

def apply_ops_paged(pool, page_ids, ops):
    return pool, page_ids

def apply_ops_paged_keep(pool, page_ids, ops):
    return pool, page_ids

serve_megakernel = make_serve_megakernel(keep=False)
"""


def lint(body, rule):
    src = PRELUDE + textwrap.dedent(body)
    return [v for v in analyze_source(src, only=[rule])]


def ids(body, rule):
    return [v.rule_id for v in lint(body, rule)]


class TestUseAfterDonate:
    def test_read_after_in_place_call(self):
        vs = lint("""
            def flush(pool, page_ids, ops):
                apply_ops_paged(pool, page_ids, ops)
                return pool.length
        """, "USE_AFTER_DONATE")
        assert [v.rule_id for v in vs] == ["USE_AFTER_DONATE"]
        assert "mutated in place" in vs[0].message

    def test_alias_read_after_call(self):
        assert ids("""
            def flush(pool, page_ids, ops):
                pre = pool
                apply_ops_paged(pool, page_ids, ops)
                return pre.count
        """, "USE_AFTER_DONATE") == ["USE_AFTER_DONATE"]

    def test_module_level_callable_from_the_table(self):
        assert ids("""
            def ring(tstate, pool, lww, ring_args):
                serve_megakernel(tstate, pool, lww, *ring_args)
                return pool.length
        """, "USE_AFTER_DONATE") == []  # starred args: unmappable, quiet

    def test_module_level_callable_positional(self):
        assert ids("""
            def ring(tstate, pool, lww, xs):
                serve_megakernel(tstate, pool, lww, xs)
                return pool.length
        """, "USE_AFTER_DONATE") == ["USE_AFTER_DONATE"]

    def test_except_handler_sees_the_mutation(self):
        assert ids("""
            def flush(pool, page_ids, ops):
                try:
                    pool, page_ids = apply_ops_paged(pool, page_ids, ops)
                except RuntimeError:
                    return pool.length
                return pool
        """, "USE_AFTER_DONATE") == ["USE_AFTER_DONATE"]

    def test_wrapper_propagates_the_in_place_position(self):
        assert ids("""
            def _flush_group(pool, page_ids, ops):
                apply_ops_paged(pool, page_ids, ops)

            def flush(pool, page_ids, ops):
                _flush_group(pool, page_ids, ops)
                return pool.count
        """, "USE_AFTER_DONATE") == ["USE_AFTER_DONATE"]

    def test_rebind_from_the_result_is_quiet(self):
        assert ids("""
            def flush(pool, page_ids, ops):
                pool, page_ids = apply_ops_paged(pool, page_ids, ops)
                return pool.length
        """, "USE_AFTER_DONATE") == []

    def test_keep_twin_is_quiet(self):
        assert ids("""
            def flush(pool, page_ids, ops):
                apply_ops_paged_keep(pool, page_ids, ops)
                return pool.length
        """, "USE_AFTER_DONATE") == []

    def test_metadata_probe_is_quiet(self):
        assert ids("""
            def flush(pool, page_ids, ops):
                apply_ops_paged(pool, page_ids, ops)
                return pool.length.shape, pool.length.device
        """, "USE_AFTER_DONATE") == []


class TestDonatedEscape:
    def test_store_then_mutate(self):
        assert ids("""
            class Store:
                def flush(self, pool, page_ids, ops):
                    self.pre = pool
                    apply_ops_paged(pool, page_ids, ops)
        """, "DONATED_ESCAPE") == ["DONATED_ESCAPE"]

    def test_mutate_then_store(self):
        assert ids("""
            class Store:
                def flush(self, pool, page_ids, ops):
                    apply_ops_paged(pool, page_ids, ops)
                    self.pool = pool
        """, "DONATED_ESCAPE") == ["DONATED_ESCAPE"]

    def test_store_of_the_result_is_quiet(self):
        assert ids("""
            class Store:
                def flush(self, page_ids, ops):
                    self.pool, _ = apply_ops_paged(self.pool, page_ids,
                                                   ops)
        """, "DONATED_ESCAPE") == []


class TestPageIdDtype:
    @pytest.mark.parametrize("expr", [
        "torch.as_tensor(tables, dtype=torch.int64)",
        "torch.as_tensor(tables, dtype=torch.long)",
        "torch.as_tensor(tables).long()",
        "torch.as_tensor(tables).to(torch.int16)",
        "np.asarray(tables, dtype=np.uint32)",
        "torch.tensor(tables, dtype=torch.uint8)",
    ])
    def test_non_int32_page_table_fires(self, expr):
        assert ids(f"""
            import numpy as np
            import torch

            def stage(tables):
                page_ids = {expr}
                return page_ids
        """, "PAGE_ID_DTYPE") == ["PAGE_ID_DTYPE"]

    def test_drift_through_an_intermediate_binding(self):
        assert ids("""
            import torch

            def stage(tables):
                raw = torch.as_tensor(tables, dtype=torch.int64)
                page_ids = raw + 0
                return page_ids
        """, "PAGE_ID_DTYPE") == ["PAGE_ID_DTYPE"]

    def test_cast_onto_page_ids_fires(self):
        assert ids("""
            import torch

            def gather(pool, page_ids):
                return pool[page_ids.to(torch.int64)]
        """, "PAGE_ID_DTYPE") == ["PAGE_ID_DTYPE"]

    @pytest.mark.parametrize("expr", [
        "torch.as_tensor(tables, dtype=torch.int32)",
        "torch.as_tensor(tables).int()",
        "np.asarray(tables, dtype=np.int32)",
    ])
    def test_int32_page_table_is_quiet(self, expr):
        assert ids(f"""
            import numpy as np
            import torch

            def stage(tables):
                page_ids = {expr}
                return page_ids
        """, "PAGE_ID_DTYPE") == []

    def test_unrelated_int64_index_is_quiet(self):
        assert ids("""
            import torch

            def order(lengths):
                idx = torch.argsort(lengths).to(torch.int64)
                return idx
        """, "PAGE_ID_DTYPE") == []

    def test_out_of_scope_module_is_quiet(self):
        src = textwrap.dedent("""
            import torch

            def stage(tables):
                page_ids = torch.as_tensor(tables, dtype=torch.int64)
                return page_ids
        """)
        assert analyze_source(src, path="fluidframework_tpu_torch/dds/x.py",
                              only=["PAGE_ID_DTYPE"]) == []


def test_ports_paged_tier_is_clean():
    """The port's mergetree/ and server/ tiers: no lifecycle finding left
    (the index casts of gather/scatter carry their suppressions)."""
    res = analyze_paths(
        [str(REPO / "fluidframework_tpu_torch" / d)
         for d in ("mergetree", "server")],
        only=["USE_AFTER_DONATE", "DONATED_ESCAPE", "PAGE_ID_DTYPE"])
    assert res.violations == [], "\n".join(v.render()
                                           for v in res.violations)
    assert res.suppressed >= 4
