"""Tenant management + JWT auth (the "Riddler" role).

Capability parity with reference server/routerlicious Riddler
(`routerlicious-base/src/riddler/tenantManager.ts`, `api.ts`) and the token
helpers in services-utils (`generateToken`, jsrsasign HS256 JWTs): tenants
are registered with a per-tenant shared secret; clients present a signed
JWT whose claims scope them to (tenantId, documentId, scopes); the front
door (alfred) validates the token against the tenant key before admitting
the connection.

Implemented with stdlib hmac/hashlib (no external jose dependency) — the
wire format is a standard RFC 7519 HS256 JWT so any off-the-shelf client
library can mint compatible tokens.

A port of fluidframework_tpu's server/auth.py (standard library only):
a token signed by either package verifies in the other.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class AuthError(Exception):
    """Token/tenant validation failure (maps to HTTP 401/403)."""


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _b64url_decode(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def sign_token(key: str, claims: dict) -> str:
    """Mint an HS256 JWT over `claims` with the tenant secret `key`."""
    header = {"alg": "HS256", "typ": "JWT"}
    signing_input = (
        _b64url(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + _b64url(json.dumps(claims, separators=(",", ":")).encode())
    )
    sig = hmac.new(key.encode(), signing_input.encode(), hashlib.sha256).digest()
    return signing_input + "." + _b64url(sig)


def verify_token(key: str, token: str) -> dict:
    """Verify signature + expiry; returns the claims dict or raises AuthError."""
    try:
        signing_input, _, sig_part = token.rpartition(".")
        header_part, _, claims_part = signing_input.partition(".")
        header = json.loads(_b64url_decode(header_part))
        claims = json.loads(_b64url_decode(claims_part))
        sig = _b64url_decode(sig_part)
    except Exception as exc:  # malformed structure/base64/json
        raise AuthError(f"malformed token: {exc}") from exc
    if header.get("alg") != "HS256":
        raise AuthError(f"unsupported alg {header.get('alg')!r}")
    expected = hmac.new(key.encode(), signing_input.encode(),
                        hashlib.sha256).digest()
    if not hmac.compare_digest(sig, expected):
        raise AuthError("bad signature")
    exp = claims.get("exp")
    if exp is not None and time.time() > float(exp):
        raise AuthError("token expired")
    return claims


def generate_token(key: str, tenant_id: str, document_id: str,
                   scopes: Optional[List[str]] = None,
                   user: Optional[dict] = None,
                   lifetime_s: float = 3600.0) -> str:
    """The reference `generateToken` shape (services-utils): standard claims
    {tenantId, documentId, scopes, user, iat, exp, ver}."""
    now = time.time()
    claims = {
        "tenantId": tenant_id,
        "documentId": document_id,
        "scopes": scopes if scopes is not None
        else ["doc:read", "doc:write", "summary:write"],
        "user": user or {"id": "anonymous"},
        "iat": int(now),
        "exp": int(now + lifetime_s),
        "ver": "1.0",
    }
    return sign_token(key, claims)


@dataclass
class Tenant:
    id: str
    key: str
    storage_url: str = ""
    orderer_url: str = ""
    metadata: dict = field(default_factory=dict)


class TenantManager:
    """Tenant CRUD + token validation (Riddler). Thread-safe."""

    def __init__(self):
        self._tenants: Dict[str, Tenant] = {}
        self._lock = threading.Lock()

    def create_tenant(self, tenant_id: str,
                      key: Optional[str] = None) -> Tenant:
        with self._lock:
            if tenant_id in self._tenants:
                raise ValueError(f"tenant {tenant_id!r} exists")
            tenant = Tenant(id=tenant_id, key=key or secrets.token_hex(16))
            self._tenants[tenant_id] = tenant
            return tenant

    def get_tenant(self, tenant_id: str) -> Tenant:
        tenant = self._tenants.get(tenant_id)
        if tenant is None:
            raise AuthError(f"unknown tenant {tenant_id!r}")
        return tenant

    def get_key(self, tenant_id: str) -> str:
        return self.get_tenant(tenant_id).key

    def list_tenants(self) -> List[str]:
        return sorted(self._tenants)

    def validate_token(self, tenant_id: str, token: str,
                       document_id: Optional[str] = None,
                       scope: Optional[str] = None) -> dict:
        """Full admission check: signature, tenant match, doc match, scope."""
        claims = verify_token(self.get_key(tenant_id), token)
        if claims.get("tenantId") != tenant_id:
            raise AuthError("token tenant mismatch")
        if document_id is not None and claims.get("documentId") not in (
                document_id, "*"):
            raise AuthError("token document mismatch")
        if scope is not None and scope not in claims.get("scopes", []):
            raise AuthError(f"missing scope {scope!r}")
        return claims
