"""Semver-range helpers shared by the code loader (client) and package
registry (server) — reference: both web-code-loader and auspkn resolve
npm-style version ranges. A port of fluidframework_tpu's core/semver.py."""

from __future__ import annotations

from typing import Tuple


def parse_version(version: str) -> Tuple[int, ...]:
    return tuple(int(p) for p in version.split("."))


def satisfies(version: str, spec: str) -> bool:
    """Minimal semver-range check: exact, "^x.y.z" (same major, >=),
    "~x.y.z" (same major.minor, >=), "*" / "latest" (any)."""
    if spec in ("*", "latest", "", None):
        return True
    v = parse_version(version)
    if spec.startswith("^"):
        base = parse_version(spec[1:])
        return v[0] == base[0] and v >= base
    if spec.startswith("~"):
        base = parse_version(spec[1:])
        return v[:2] == base[:2] and v >= base
    return v == parse_version(spec)
