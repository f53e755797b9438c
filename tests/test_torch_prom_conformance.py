"""The port's Prometheus/OpenMetrics exposition (fluidframework_tpu_torch/
server/monitor.py prometheus()): a mirror of tests/test_prom_conformance.py
through the same strict line-level parser (label-value escaping, HELP and
TYPE before every family, histogram cumulativity, exemplars, the single
EOF), over the port's monitor and observatory."""

import math
import re

import pytest

from fluidframework_tpu_torch.server.monitor import ServiceMonitor
from fluidframework_tpu_torch.telemetry import counters, tracing, watermarks

# One escaped label value: backslash-escape pairs only (\\ \" \n).
# (The parser is the JAX file's, copied so that this file stands on its
# own: its checks are the conformance rules.)
_LABEL_VALUE = r'"(?:[^"\\\n]|\\\\|\\"|\\n)*"'
_LABEL = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)=(' + _LABEL_VALUE + r')')
_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'           # metric name
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*=' + _LABEL_VALUE +
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*=' + _LABEL_VALUE + r')*\})?'
    r' (-?(?:[0-9.e+-]+|\+Inf|NaN))'          # value
    r'( # \{trace_id=' + _LABEL_VALUE + r'\} -?[0-9.e+-]+)?$')


def _unescape(quoted):
    body = quoted[1:-1]
    return (body.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def _parse(text):
    """Parse the exposition; raises AssertionError on any
    non-conformant line. Returns (samples, meta) where samples is
    [(metric, {label: value}, float)] and meta is
    {family: set(('HELP'|'TYPE'))} in ENCOUNTER ORDER vs samples
    (metadata seen after a family's first sample trips an assert)."""
    samples = []
    meta = {}
    seen_families = set()
    lines = text.splitlines()
    assert lines and lines[-1] == "# EOF", "must terminate with # EOF"
    assert text.endswith("\n"), "final newline required"
    for line in lines[:-1]:
        assert line, "blank line in exposition"
        assert line != "# EOF", "interior EOF"
        if line.startswith("#"):
            parts = line.split(None, 3)
            assert len(parts) >= 3 and parts[1] in ("HELP", "TYPE"), line
            family = parts[2]
            assert family not in seen_families, \
                f"metadata for {family} after its first sample"
            meta.setdefault(family, set()).add(parts[1])
            continue
        m = _SAMPLE.match(line)
        assert m is not None, f"unparseable sample line: {line!r}"
        metric, labels_s, value_s = m.group(1), m.group(2), m.group(3)
        labels = {}
        if labels_s:
            for name, quoted in _LABEL.findall(labels_s):
                labels[name] = _unescape(quoted)
        family = re.sub(r"_(bucket|sum|count)$", "", metric)
        seen_families.add(metric)
        seen_families.add(family)
        assert family in meta, f"sample {metric} before HELP/TYPE"
        assert meta[family] == {"HELP", "TYPE"}, \
            f"{family} missing HELP or TYPE: {meta[family]}"
        value = math.inf if value_s == "+Inf" else float(value_s)
        samples.append((metric, labels, value))
    return samples, meta


WEIRD_STAGE = 'serving."we\\ird"\nstage'


@pytest.fixture(autouse=True)
def _clean():
    counters.reset()
    tracing.reset()
    watermarks.reset()
    yield
    counters.reset()
    tracing.reset()
    watermarks.reset()


@pytest.fixture()
def exposition():
    counters.increment("ops.sequenced", 5)
    for ms in (0.4, 3.0, 30.0, 400.0):
        counters.observe("serving.flush", ms, trace_id='t"1\\x')
    # The adversarial stage: quote, backslash, and newline in the
    # label value, all of which must round-trip through the escapes.
    counters.observe(WEIRD_STAGE, 7.0)
    watermarks.advance(watermarks.RAW_END, 0, 9)
    watermarks.advance(watermarks.RAW_INGESTED, 0, 4)
    mon = ServiceMonitor(device="cpu")
    mon.metrics.increment("alfred.ops", 3)
    return mon.prometheus()


class TestConformance:
    def test_every_line_parses(self, exposition):
        samples, meta = _parse(exposition)
        assert samples

    def test_help_and_type_precede_every_family(self, exposition):
        # _parse itself asserts ordering; spot-check the families.
        _, meta = _parse(exposition)
        for family in ("fluid_ops_sequenced", "fluid_stage_latency_ms",
                       "fluid_slo_ok", "fluid_metric_alfred_ops",
                       "fluid_lag_ingest_total"):
            assert meta[family] == {"HELP", "TYPE"}, family

    def test_weird_label_value_round_trips(self, exposition):
        samples, _ = _parse(exposition)
        stages = {lab["stage"] for m, lab, _v in samples
                  if m.startswith("fluid_stage_latency_ms")
                  and "stage" in lab}
        assert WEIRD_STAGE in stages
        # And the raw text never leaks an unescaped newline mid-line.
        for line in exposition.splitlines():
            assert '\rweird' not in line

    def test_histogram_le_cumulative_to_inf_equals_count(self,
                                                         exposition):
        samples, _ = _parse(exposition)
        buckets = [(float("inf") if lab["le"] == "+Inf"
                    else float(lab["le"]), v)
                   for m, lab, v in samples
                   if m == "fluid_stage_latency_ms_bucket"
                   and lab["stage"] == "serving.flush"]
        assert buckets == sorted(buckets)  # le ascending
        counts = [c for _, c in buckets]
        assert counts == sorted(counts)    # cumulative
        assert buckets[-1][0] == float("inf")
        count = [v for m, lab, v in samples
                 if m == "fluid_stage_latency_ms_count"
                 and lab["stage"] == "serving.flush"]
        assert count == [buckets[-1][1]] == [4]

    def test_sum_present_and_consistent(self, exposition):
        samples, _ = _parse(exposition)
        total = [v for m, lab, v in samples
                 if m == "fluid_stage_latency_ms_sum"
                 and lab["stage"] == "serving.flush"]
        assert total and total[0] == pytest.approx(433.4)

    def test_exemplar_trace_id_escaped(self, exposition):
        # The exemplar's trace id itself contains a quote + backslash;
        # _SAMPLE only matches escaped exemplars, so parsing the bucket
        # lines is the assertion — plus the id must round-trip.
        assert '# {trace_id="t\\"1\\\\x"}' in exposition

    def test_lag_gauges_exported(self, exposition):
        samples, _ = _parse(exposition)
        by_name = {m: v for m, lab, v in samples if not lab}
        assert by_name["fluid_lag_ingest_p0"] == 5.0
        assert by_name["fluid_lag_ingest_total"] == 5.0

    def test_fleet_merge_stays_conformant(self, exposition):
        """The observatory's merged exposition must satisfy the same
        parser — instance label injection cannot break escaping."""
        from fluidframework_tpu_torch.server.observatory import FleetObservatory

        obs = FleetObservatory(
            [{"name": "w0", "url": "http://w0"}],
            fetch=lambda url, t: (
                exposition.encode() if url.endswith("metrics.prom")
                else b'{"ok": true}' if url.endswith("health")
                else b'{"traceEvents": []}'))
        obs.scrape_once()
        samples, _ = _parse(obs.fleet_prom())
        labelled = [lab for m, lab, _v in samples]
        assert all(lab.get("instance") == "w0" for lab in labelled)
        stages = {lab.get("stage") for lab in labelled}
        assert WEIRD_STAGE in stages


def test_watched_admission_stays_conformant():
    """A watched admission controller that has published its own
    admission.level gauge: the port's exposition carries one
    fluid_admission_level family (the labelled sample), where the JAX
    monitor's opens the family twice and fails this parser (a fault the
    JAX package keeps; ROADMAP Queue 3)."""
    from fluidframework_tpu.server.admission import \
        AdmissionController as JaxAdmission
    from fluidframework_tpu.server.monitor import \
        ServiceMonitor as JaxMonitor
    from fluidframework_tpu.telemetry import counters as jax_counters

    from fluidframework_tpu_torch.server.admission import (
        SHED, AdmissionController)
    ctl = AdmissionController(queue_limit=10)
    ctl.force_state(SHED)
    ctl.observe(force=True)
    assert counters.get("admission.level") == 2
    mon = ServiceMonitor(device="cpu")
    try:
        mon.watch_admission("admission", ctl)
        samples, meta = _parse(mon.prometheus())
    finally:
        mon._httpd.server_close()
    levels = [(lab, v) for m, lab, v in samples
              if m == "fluid_admission_level"]
    assert levels == [({"state": "shed"}, 2.0)]
    assert meta["fluid_admission_level"] == {"HELP", "TYPE"}

    jax_counters.reset()
    jctl = JaxAdmission(queue_limit=10)
    jctl.force_state(SHED)
    jctl.observe(force=True)
    jmon = JaxMonitor()
    try:
        jmon.watch_admission("admission", jctl)
        with pytest.raises(AssertionError, match="fluid_admission_level"):
            _parse(jmon.prometheus())
    finally:
        jmon._httpd.server_close()
        jax_counters.reset()
