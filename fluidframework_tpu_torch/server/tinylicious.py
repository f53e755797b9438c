"""Tinylicious: the single-process dev ordering service.

Capability parity with reference server/tinylicious
(`src/{app,routes,services}`): everything a developer needs on one port —
alfred REST + websocket delta stream + historian storage routes + an open
default tenant — with zero external services. Auth is optional (the
reference tinylicious accepts any token); pass require_auth=True to get
production riddler behavior with the well-known dev key.

A port of fluidframework_tpu's server/tinylicious.py.
"""

from __future__ import annotations

from typing import Optional

from .alfred import AlfredService
from .auth import TenantManager, generate_token

DEFAULT_TENANT = "tinylicious"
DEFAULT_KEY = "12345"  # well-known dev key, like the reference's fixed key


class Tinylicious:
    """One-call dev server: `with Tinylicious() as t: ...` or
    start()/stop()."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 require_auth: bool = False, partitions: int = 1,
                 admin_key: Optional[str] = None, config=None):
        self.tenants = TenantManager()
        self.tenants.create_tenant(DEFAULT_TENANT, key=DEFAULT_KEY)
        self.service = AlfredService(self.tenants, host=host, port=port,
                                     require_auth=require_auth,
                                     partitions=partitions,
                                     admin_key=admin_key, config=config)

    @property
    def admin_key(self) -> str:
        return self.service.admin_key

    def attach_historian(self, historian_url: Optional[str]) -> None:
        """Wire a summary-cache tier (server/historian.py) in front of
        this server's git storage: latest-summary reads delegate to it
        and scribe-acked commits notify it."""
        self.service.attach_historian(historian_url)

    def start(self) -> "Tinylicious":
        self.service.start()
        return self

    def stop(self) -> None:
        self.service.stop()

    def __enter__(self) -> "Tinylicious":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def url(self) -> str:
        return self.service.url

    @property
    def port(self) -> int:
        return self.service.port

    def token_provider(self, tenant_id: Optional[str] = None):
        """A TokenProvider for the dev tenant (or any registered tenant)."""
        tid = tenant_id or DEFAULT_TENANT
        key = self.tenants.get_key(tid)

        def provider(tenant: str, document_id: str) -> str:
            return generate_token(key, tenant, document_id)

        return provider
