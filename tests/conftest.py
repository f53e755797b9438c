"""Test configuration: force an 8-virtual-device CPU backend so multi-chip
sharding paths (mesh/pjit/shard_map) are exercised without TPU hardware.

The forcing recipe (env + jax.config override, already-initialized guard)
lives in fluidframework_tpu.core.platform.force_host_platform — the shared
implementation also used by __graft_entry__.dryrun_multichip.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The suite runs on the forced-CPU mesh, where the cost model would route
# every single-lane catch-up scalar (mergetree/costmodel.py: the B=1
# kernel never wins on CPU). Force the device path so the kernel
# machinery stays exercised; routing itself is tested explicitly with
# the override cleared (tests/test_bulk_catchup.py::TestCostModel).
os.environ.setdefault("FLUID_TPU_FORCE_BULK", "1")

try:
    from fluidframework_tpu.core.platform import force_host_platform

    force_host_platform(8)
except ImportError:  # pragma: no cover - jax-less env: pure-Python tests only
    pass

try:
    from fluidframework_tpu.core.platform import enable_compile_cache

    enable_compile_cache()
except ImportError:  # pragma: no cover
    pass

try:
    import pytest

    def pytest_configure(config):
        config.addinivalue_line(
            "markers", "slow: a test too long for the tier-1 run "
            "(deselected there with -m 'not slow')")
        config.addinivalue_line(
            "markers", "card: a test of a CUDA kernel that needs the card "
            "(skips without one)")

    @pytest.fixture(autouse=True)
    def _isolate_stage_latency_histograms():
        """The stage latency histograms (telemetry/counters.observe) are
        process-global and feed the SLO verdict on /health: without
        per-test isolation, one test's serving-flush tail would flip a
        LATER test's health check to 503 under randomized ordering.
        Named counters are deliberately left alone (pre-existing
        cross-test semantics)."""
        yield
        from fluidframework_tpu.telemetry import counters

        counters.reset_histograms()
except ImportError:  # pragma: no cover - conftest imported outside pytest
    pass
