"""Telemetry layouts shared by the port's device programs and their
readers."""
