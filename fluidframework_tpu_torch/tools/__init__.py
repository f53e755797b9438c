"""Operator tools (reference layer 8: packages/tools): the micro-perf
harness (microbench.py) and the on-card kernel conformance check
(gpu_conformance.py)."""
