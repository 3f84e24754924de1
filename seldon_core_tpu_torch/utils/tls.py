"""TLS configuration for servers and clients.

The port's counterpart of ``seldon_core_tpu/utils/tls.py`` (reference:
python/seldon_core/seldon_client.py:34-67 SeldonChannelCredentials /
SeldonCallCredentials).  One ``TlsConfig`` describes a server or client
identity; helpers derive the gRPC credentials and the stdlib
``ssl.SSLContext`` of the aiohttp listeners, so REST and gRPC terminate
TLS from the same files.  Only ``ssl`` and ``grpc``: nothing mints
certificates here.

Env convention (the operator-injected equivalent):
``SELDON_TLS_CERT`` / ``SELDON_TLS_KEY`` / ``SELDON_TLS_CA`` (paths),
``SELDON_TLS_REQUIRE_CLIENT_AUTH`` ("1" enables mTLS verification).
"""

from __future__ import annotations

import os
import ssl
from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class TlsConfig:
    """A TLS identity: certificate + key, optional peer-verification CA."""

    cert_file: str = ""
    key_file: str = ""
    ca_file: str = ""  # peer verification (mTLS on servers, server auth on clients)
    require_client_auth: bool = False

    def __post_init__(self) -> None:
        if bool(self.cert_file) != bool(self.key_file):
            raise ValueError("TlsConfig needs cert_file and key_file together")
        for label, path in (("cert", self.cert_file), ("key", self.key_file), ("ca", self.ca_file)):
            if path and not os.path.exists(path):
                raise FileNotFoundError(f"TLS {label} file not found: {path}")
        if self.require_client_auth and not self.ca_file:
            # silently downgrading requested mTLS to no client verification
            # would defeat the operator's explicit intent
            raise ValueError("require_client_auth needs ca_file to verify clients against")

    @property
    def enabled(self) -> bool:
        return bool(self.cert_file)

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> Optional["TlsConfig"]:
        e = env if env is not None else os.environ
        cert = e.get("SELDON_TLS_CERT", "")
        if not cert:
            return None
        return cls(
            cert_file=cert,
            key_file=e.get("SELDON_TLS_KEY", ""),
            ca_file=e.get("SELDON_TLS_CA", ""),
            require_client_auth=e.get("SELDON_TLS_REQUIRE_CLIENT_AUTH", "0") == "1",
        )


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

def grpc_server_credentials(cfg: TlsConfig):
    """grpc.ssl_server_credentials from the config (mTLS when ca_file set)."""
    import grpc

    with open(cfg.cert_file, "rb") as f:
        cert = f.read()
    with open(cfg.key_file, "rb") as f:
        key = f.read()
    root = None
    if cfg.ca_file:
        with open(cfg.ca_file, "rb") as f:
            root = f.read()
    return grpc.ssl_server_credentials(
        [(key, cert)],
        root_certificates=root,
        require_client_auth=cfg.require_client_auth and root is not None,
    )


def server_ssl_context(cfg: TlsConfig) -> ssl.SSLContext:
    """SSLContext for the aiohttp REST listeners."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    if cfg.ca_file:
        ctx.load_verify_locations(cfg.ca_file)
        if cfg.require_client_auth:
            ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def add_grpc_port(server: Any, address: str, tls: Optional[TlsConfig]) -> int:
    """Bind a gRPC server port, secure when a TLS config is given."""
    if tls is not None and tls.enabled:
        return server.add_secure_port(address, grpc_server_credentials(tls))
    return server.add_insecure_port(address)


# ---------------------------------------------------------------------------
# client side (reference: SeldonChannelCredentials semantics)
# ---------------------------------------------------------------------------

@dataclass
class ChannelCredentials:
    """Client-side channel security (reference:
    seldon_client.py:34-56).

    ``verify=False`` applies to the REST lane only — same semantics as
    the reference, whose docstring says verify "is used to avoid SSL
    verification in REST however for GRPC it is recommended that you
    provide a path at least for the root_certificates_file".  gRPC
    always verifies; give it your CA via ``root_certificates_file``.
    """

    verify: bool = True
    root_certificates_file: str = ""
    private_key_file: str = ""  # with certificate_chain_file -> mTLS client cert
    certificate_chain_file: str = ""


@dataclass
class CallCredentials:
    """Per-call auth token, sent as the X-Auth-Token header (REST) /
    x-auth-token metadata (gRPC) (reference: seldon_client.py:58-67)."""

    token: str = ""


def grpc_channel_credentials(creds: ChannelCredentials):
    import grpc

    def read(path: str) -> Optional[bytes]:
        if not path:
            return None
        with open(path, "rb") as f:
            return f.read()

    return grpc.ssl_channel_credentials(
        root_certificates=read(creds.root_certificates_file),
        private_key=read(creds.private_key_file),
        certificate_chain=read(creds.certificate_chain_file),
    )


def requests_tls_kwargs(creds: ChannelCredentials) -> dict:
    """kwargs for requests/aiohttp: verify= and cert=."""
    kwargs: dict = {}
    if not creds.verify:
        kwargs["verify"] = False
    elif creds.root_certificates_file:
        kwargs["verify"] = creds.root_certificates_file
    if creds.certificate_chain_file and creds.private_key_file:
        kwargs["cert"] = (creds.certificate_chain_file, creds.private_key_file)
    return kwargs


def client_ssl_context(creds: ChannelCredentials) -> ssl.SSLContext:
    """The REST lane's client context: ``verify=False`` turns checks off,
    ``root_certificates_file`` is the CA, a chain and key give mTLS."""
    if not creds.verify:
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    else:
        ctx = ssl.create_default_context(cafile=creds.root_certificates_file or None)
    if creds.certificate_chain_file and creds.private_key_file:
        ctx.load_cert_chain(creds.certificate_chain_file, creds.private_key_file)
    return ctx

