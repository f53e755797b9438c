"""URL resolvers: application URL -> resolved document endpoint.

Capability parity with reference packages/drivers/*-urlResolver
(routerlicious-urlResolver/src, odsp-urlResolver): parse
fluid://host/tenant/document[/path] into {tenant_id, document_id, path},
which the loader hands to the matching document service factory. A
port of fluidframework_tpu's loader/drivers/url_resolver.py (host only)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional
from urllib.parse import urlparse


@dataclass
class ResolvedUrl:
    tenant_id: str
    document_id: str
    path: str
    endpoint: str  # ordering-service endpoint (host)
    url: str


class FluidUrlResolver:
    """fluid://<host>/<tenant>/<document>[/<path...>] (the routerlicious
    URL shape)."""

    SCHEMES = ("fluid", "http", "https")

    def __init__(self, default_tenant: str = "local"):
        self.default_tenant = default_tenant

    def resolve(self, url: str) -> ResolvedUrl:
        parsed = urlparse(url)
        if parsed.scheme not in self.SCHEMES:
            raise ValueError(f"unsupported scheme {parsed.scheme!r}")
        parts: List[str] = [p for p in parsed.path.split("/") if p]
        if not parts:
            raise ValueError(f"no document in url {url!r}")
        if len(parts) == 1:
            tenant, doc = self.default_tenant, parts[0]
            rest = []
        else:
            tenant, doc, *rest = parts
        return ResolvedUrl(tenant_id=tenant, document_id=doc,
                           path="/" + "/".join(rest),
                           endpoint=parsed.netloc, url=url)


class MultiUrlResolver:
    """First resolver that succeeds wins (reference MultiUrlResolver)."""

    def __init__(self, *resolvers):
        self.resolvers = list(resolvers)

    def resolve(self, url: str) -> ResolvedUrl:
        errors = []
        for resolver in self.resolvers:
            try:
                return resolver.resolve(url)
            except ValueError as err:
                errors.append(str(err))
        raise ValueError(f"no resolver handled {url!r}: {errors}")
