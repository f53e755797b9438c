"""The port's telemetry folds and compile observatory against the JAX
package on the CPU: telemetry/device_stats.py (fold_serve, fold_paged,
fold_extract, begin_flush / flush_facts, snapshot, reconcile, the toggle)
fed the same hand-built vectors must leave the same counters;
telemetry/compile_ledger.py fed the same calls directly must give the
same snapshot and bench_stamp (tests/test_device_stats.py::
TestCompileLedger's cases); counters.JitRetraceProbe counts input
signatures as JAX's probe counts jit-cache growth; and the kernel build
records itself in the ledger (kernels/build.py _note_build).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from fluidframework_tpu.telemetry import compile_ledger as jledger
from fluidframework_tpu.telemetry import counters as jcounters
from fluidframework_tpu.telemetry import device_stats as jds

from fluidframework_tpu_torch.kernels import build
from fluidframework_tpu_torch.telemetry import compile_ledger as tledger
from fluidframework_tpu_torch.telemetry import counters as tcounters
from fluidframework_tpu_torch.telemetry import device_stats as tds

PAIRS = ((tds, tcounters), (jds, jcounters))


@pytest.fixture(autouse=True)
def _fresh_counters():
    # Both packages' ledgers are process-wide: a JAX test that ran earlier
    # on the same worker leaves its symbols in the JAX ledger.
    for _ds, c in PAIRS:
        c.reset()
    tledger.ledger.reset()
    jledger.ledger.reset()
    yield
    for ds, c in PAIRS:
        c.reset()
        ds.set_enabled(True)
    tledger.ledger.reset()
    jledger.ledger.reset()


def both(fn):
    """fn(device_stats, counters) on each package; returns the two
    counter snapshots and results."""
    out = []
    for ds, c in PAIRS:
        res = fn(ds, c)
        out.append((c.snapshot(), res))
    return out


def test_slot_layouts_match_jax():
    for name in ("SERVE_SLOTS", "PAGED_SLOTS", "EXTRACT_SLOTS", "N_SERVE",
                 "N_PAGED", "N_EXTRACT", "_SERVE_GAUGES", "_FLUSH_KEYS"):
        assert getattr(tds, name) == getattr(jds, name), name


SERVE_DEV = [5, 2, 1, 3, 0, 1, 7, 20, 2, 1, 0, 1, 4, 300, 12]


@pytest.mark.parametrize("host", ["none", "equal", "differs",
                                  "gauge_differs"])
def test_fold_serve_and_reconcile_match_jax(host):
    h = {"none": None, "equal": list(SERVE_DEV),
         "differs": SERVE_DEV[:3] + [4] + SERVE_DEV[4:],
         "gauge_differs": SERVE_DEV[:13] + [299, 11]}[host]

    def run(ds, c):
        ds.fold_serve(SERVE_DEV, h)
        ds.fold_serve([1] * ds.N_SERVE, None if h is None else [1] * 15)
        return ds.reconcile(), ds.snapshot()

    (t_snap, t_res), (j_snap, j_res) = both(run)
    assert t_snap == j_snap
    assert t_res == j_res
    mismatch = t_snap.get("device.serving.reconcile_mismatch", 0)
    assert mismatch == (1 if host == "differs" else 0)
    # no host mirror: every counted slot reads as a disagreement
    assert (t_res[0] is None) == (host in ("equal", "gauge_differs"))
    assert t_snap["device.serving.merge_rows_live"] == 1.0   # a gauge


@pytest.mark.parametrize("host", ["equal", "rows_live_only", "ops_differ"])
def test_fold_paged_matches_jax(host):
    dev = [4, 3, 2, 1, 0, 5, 1, 900]
    h = {"equal": list(dev), "rows_live_only": dev[:7] + [901],
         "ops_differ": [5] + dev[1:]}[host]
    (t_snap, _), (j_snap, _) = both(lambda ds, c: ds.fold_paged(dev, h))
    assert t_snap == j_snap
    assert t_snap.get("device.paged.reconcile_mismatch", 0) == \
        (1 if host == "ops_differ" else 0)
    assert t_snap["device.paged.rows_live"] == 900.0


def test_fold_extract_and_flush_facts_match_jax():
    def run(ds, c):
        token = ds.begin_flush()
        ds.fold_extract([100, 2_500, 37])
        ds.fold_extract([1, 0, 0])
        ds.fold_serve(SERVE_DEV, SERVE_DEV)
        c.increment("zamboni.rows_reclaimed", 5)
        return ds.flush_facts(token), ds.flush_facts(ds.begin_flush())

    (t_snap, t_res), (j_snap, j_res) = both(run)
    assert t_snap == j_snap and t_res == j_res
    facts, empty = t_res
    assert facts["dev_zamboni_rows"] == 42 and empty == {}
    assert t_snap["device.extract.docs"] == 101.0
    assert t_snap["device.extract.rows_live"] == 2_500.0


def test_toggle_matches_jax():
    for ds, _c in PAIRS:
        assert ds.enabled()
        ds.set_enabled(False)
        assert not ds.enabled()
        ds.set_enabled(1)
        assert ds.enabled() is True


# ---------------------------------------------------------------------------
# the compile ledger and the signature probe
# ---------------------------------------------------------------------------

def feed(led):
    """A direct feed of warm / cold calls: the attribution cases of
    tests/test_device_stats.py::TestCompileLedger."""
    led.note_call("k.attr", 5.0, grew=1)     # cold: first compile
    led.note_call("k.attr", 1.25, grew=0)    # warm
    led.note_call("k.attr", 4.5, grew=1)     # cold again: a retrace
    led.note_call("k.attr", 1.0)             # warm (no watched callable)
    led.watch("k.watched")
    led.note_call("k.multi", 7.0, grew=3)
    return led.snapshot(), led.bench_stamp()


def test_ledger_direct_feed_matches_jax():
    t_snap, t_stamp = feed(tledger.CompileLedger())
    j_snap, j_stamp = feed(jledger.CompileLedger())
    assert t_snap == j_snap and t_stamp == j_stamp
    sym = t_snap["symbols"]["k.attr"]
    assert (sym["compiles"], sym["retraces"], sym["coldCalls"],
            sym["warmCalls"]) == (2, 1, 2, 2)
    assert sym["compileMs"] == 9.5 and sym["warmMs"] == 2.25
    assert {"total_compiles", "total_compile_ms", "retraces",
            "symbols"} <= set(t_stamp)
    assert t_stamp["total_compiles"] == 5


def test_ledger_track_attributes_a_probed_first_call():
    """track() over a callable that reports its occupancy: the first
    call with a new signature is cold, the next warm."""
    led = tledger.CompileLedger()
    probe = tcounters.JitRetraceProbe(lambda x: x - 3, name="t.inner")
    for _ in range(2):
        with led.track("k.track", probe):
            probe(torch.ones(5))
    sym = led.snapshot()["symbols"]["k.track"]
    assert (sym["compiles"], sym["coldCalls"], sym["warmCalls"],
            sym["cacheSize"]) == (1, 1, 1, 1)


def test_probe_counts_signatures_as_jax_counts_compiles():
    name = "test.ledger_attr"
    t_probe = tcounters.JitRetraceProbe(lambda x: x * 2 + 1, name=name)
    j_probe = jcounters.JitRetraceProbe(jax.jit(lambda x: x * 2 + 1),
                                        name=name)
    for n in (4, 4, 8, 8):
        t_probe(torch.ones(n))
        j_probe(jnp.ones((n,)))
    t_sym = tledger.ledger.snapshot()["symbols"][name]
    j_sym = jledger.ledger.snapshot()["symbols"][name]
    keys = ("compiles", "retraces", "coldCalls", "warmCalls", "cacheSize")
    assert {k: t_sym[k] for k in keys} == {k: j_sym[k] for k in keys}
    assert (t_sym["compiles"], t_sym["retraces"], t_sym["cacheSize"]) == \
        (2, 1, 2)
    for suffix in (".compiles", ".retraces"):
        assert tcounters.get(name + suffix) == jcounters.get(name + suffix)
    assert tcounters.get("kernel.retrace_count") == 1


def test_probe_signature_is_shape_dtype_and_structure():
    probe = tcounters.JitRetraceProbe(lambda *a, **k: None, name="t.sig")
    calls = [
        ((torch.zeros(3, dtype=torch.int32),), {}),        # new
        ((torch.ones(3, dtype=torch.int32),), {}),         # same signature
        ((torch.zeros(3, dtype=torch.int16),), {}),        # dtype: new
        ((torch.zeros(3, 1, dtype=torch.int16),), {}),     # shape: new
        (((torch.zeros(2), 5),), {}),                      # structure: new
        (((torch.zeros(2), 9),), {}),                      # int value: same
        (([torch.zeros(2), 9],), {}),                      # list: new
        ((torch.zeros(2),), {"k": torch.zeros(1)}),        # kwargs: new
    ]
    for args, kwargs in calls:
        probe(*args, **kwargs)
    assert tcounters.get("t.sig.compiles") == 6
    assert tcounters.get("t.sig.retraces") == 5
    assert probe._cache_size() == 6
    sym = tledger.ledger.snapshot()["symbols"]["t.sig"]
    assert sym["coldCalls"] == 6 and sym["warmCalls"] == 2


def test_kernel_build_records_each_source():
    build._note_build(12.5)
    snap = tledger.ledger.snapshot()
    names = sorted(n for n in snap["symbols"] if n.startswith("kernels/"))
    assert names == [f"kernels/csrc/{p.name}"
                     for p in sorted(build.CSRC.glob("*.cu"))]
    for n in names:
        assert snap["symbols"][n]["compiles"] == 1
        assert snap["symbols"][n]["compileMs"] == 12.5
    assert snap["totals"]["backendCompileMs"] == 12.5
