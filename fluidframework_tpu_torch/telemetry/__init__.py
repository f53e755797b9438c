"""Telemetry: counters and latency histograms, op tracing, the device
stats planes and their fold, and the compile ledger."""
