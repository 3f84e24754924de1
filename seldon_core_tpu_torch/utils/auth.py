"""Gateway OAuth client-credentials flow.

The port's counterpart of ``seldon_core_tpu/utils/auth.py``: the gateway
serves ``/oauth/token`` (HTTP Basic key/secret, the reference's
client-credentials grant, python/seldon_core/seldon_client.py:1186-1227)
and accepts ``Authorization: Bearer`` on every data call.  Tokens are
stateless HMAC-signed expiring claims, so replicas share nothing, and a
token issued by either package verifies in the other for the same
secret.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import secrets as _secrets
import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class OAuthConfig:
    """Client-credentials pair the gateway accepts (the reference's
    oauth_key/oauth_secret); ``ttl_s`` bounds token lifetime."""

    key: str
    secret: str
    ttl_s: float = 3600.0

    def __post_init__(self):
        if not self.key or not self.secret:
            raise ValueError("oauth key and secret must both be non-empty")


class TokenIssuer:
    """Stateless signed tokens: ``b64(json{sub, exp}) . b64(hmac)``."""

    def __init__(self, config: OAuthConfig):
        self.config = config
        # the signing key is derived from the secret, not the secret
        # itself, so a leaked token never exposes credential material
        self._sign_key = hashlib.sha256(
            b"seldon-tpu-token:" + config.secret.encode()
        ).digest()

    def check_credentials(self, key: str, secret: str) -> bool:
        # compare encoded bytes: compare_digest on str raises TypeError
        # for non-ASCII input, which would turn a bad Basic header into
        # a 500 instead of 401 invalid_client
        return hmac.compare_digest(
            key.encode(), self.config.key.encode()
        ) and hmac.compare_digest(secret.encode(), self.config.secret.encode())

    def issue(self, now: Optional[float] = None) -> dict:
        now = time.time() if now is None else now
        payload = json.dumps(
            {"sub": self.config.key, "exp": now + self.config.ttl_s,
             "jti": _secrets.token_hex(8)},
            separators=(",", ":"),
        ).encode()
        sig = hmac.new(self._sign_key, payload, hashlib.sha256).digest()
        token = (
            base64.urlsafe_b64encode(payload).decode().rstrip("=")
            + "."
            + base64.urlsafe_b64encode(sig).decode().rstrip("=")
        )
        return {
            "access_token": token,
            "token_type": "bearer",
            "expires_in": int(self.config.ttl_s),
        }

    def verify(self, token: str, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        try:
            payload_b64, sig_b64 = token.split(".", 1)
            pad = "=" * (-len(payload_b64) % 4)
            payload = base64.urlsafe_b64decode(payload_b64 + pad)
            pad = "=" * (-len(sig_b64) % 4)
            sig = base64.urlsafe_b64decode(sig_b64 + pad)
        except Exception:  # noqa: BLE001 — any malformed token is invalid
            return False
        want = hmac.new(self._sign_key, payload, hashlib.sha256).digest()
        if not hmac.compare_digest(sig, want):
            return False
        try:
            claims = json.loads(payload)
        except json.JSONDecodeError:
            return False
        return float(claims.get("exp", 0)) > now

    def verify_header(self, authorization: Optional[str]) -> bool:
        """Check an ``Authorization: Bearer <token>`` header value."""
        if not authorization or not authorization.lower().startswith("bearer "):
            return False
        return self.verify(authorization[7:].strip())

    def verify_grpc(self, context) -> bool:
        """Check a gRPC call's ``authorization`` metadata entry — the
        one parsing path both the sync and aio servers share."""
        md = dict(context.invocation_metadata() or ())
        return self.verify_header(md.get("authorization"))


# the one user-facing message for a rejected call, shared by every lane
UNAUTHENTICATED_MSG = "missing or invalid bearer token"


def parse_basic_auth(header: Optional[str]) -> Optional[tuple]:
    """``Authorization: Basic b64(key:secret)`` -> (key, secret)."""
    if not header or not header.lower().startswith("basic "):
        return None
    try:
        decoded = base64.b64decode(header[6:].strip()).decode()
        key, _, secret = decoded.partition(":")
        return key, secret
    except Exception:  # noqa: BLE001 — any malformed header is not-authenticated
        return None
