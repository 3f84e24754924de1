"""The port's TLS and OAuth against the JAX package's.

* ``utils/auth.py``: a token issued by either package's ``TokenIssuer``
  verifies in the other for the same secret and ``now`` (and fails
  after expiry, tampered, or under another secret);
  ``parse_basic_auth``, ``verify_header`` and ``UNAUTHENTICATED_MSG``
  agree exactly.
* ``utils/tls.py``: ``TlsConfig`` refuses what JAX refuses (key without
  cert, a missing file, mTLS without a CA), ``from_env`` reads the same
  ``SELDON_TLS_*`` env, ``requests_tls_kwargs`` gives the same kwargs.
* The microservice CLI's servers with TLS, as ``tests/test_tls.py``
  drives the JAX ones: REST over HTTPS and gRPC over a secure channel
  with the committed test CA (``tests/data/torch_port_tls``), a
  plaintext client refused, mTLS without a client certificate refused
  and with one served; and a freshly minted certificate behind
  ``importorskip("cryptography")``.  Every socket has its own timeout.
"""

import asyncio
import datetime
import os
import pathlib
import socket
import ssl
import sys
import threading
import time

import numpy as np
import pytest

from seldon_core_tpu.utils import auth as jax_auth
from seldon_core_tpu.utils import tls as jax_tls
from seldon_core_tpu_torch.utils import auth, tls

CERTS = pathlib.Path(__file__).resolve().parent / "data" / "torch_port_tls"
SECRET = "s3cr3t-ü"


# ---------------------------------------------------------------- auth

@pytest.mark.parametrize("issuer_pkg", ["jax", "torch_port"])
def test_tokens_verify_across_the_packages(issuer_pkg):
    now = 1_800_000_000.0
    pkgs = {"jax": jax_auth, "torch_port": auth}
    issuers = {k: m.TokenIssuer(m.OAuthConfig(key="client", secret=SECRET, ttl_s=60.0)) for k, m in pkgs.items()}
    other = "torch_port" if issuer_pkg == "jax" else "jax"
    body = issuers[issuer_pkg].issue(now=now)
    assert body["token_type"] == "bearer" and body["expires_in"] == 60
    token = body["access_token"]
    for verifier in (issuers[issuer_pkg], issuers[other]):
        assert verifier.verify(token, now=now + 1.0)
        assert not verifier.verify(token, now=now + 61.0)  # expired
        assert not verifier.verify(token[:-2] + ("AA" if token[-2:] != "AA" else "BB"), now=now)  # tampered
        assert not verifier.verify("not-a-token", now=now) and not verifier.verify("", now=now)
    foreign = auth.TokenIssuer(auth.OAuthConfig(key="client", secret="another"))
    assert not foreign.verify(token, now=now + 1.0)
    assert issuers[other].verify_header(f"Bearer {issuers[issuer_pkg].issue()['access_token']}")
    for bad in (None, "", "Basic abc", "Bearer", "bearer x.y"):
        assert issuers["torch_port"].verify_header(bad) == issuers["jax"].verify_header(bad) is False


def test_credentials_check_and_config_equal_jax():
    for mod in (auth, jax_auth):
        issuer = mod.TokenIssuer(mod.OAuthConfig(key="k", secret=SECRET))
        assert issuer.check_credentials("k", SECRET)
        assert not issuer.check_credentials("k", "wrong") and not issuer.check_credentials("ké", SECRET)
        for key, secret in (("", "x"), ("x", "")):
            with pytest.raises(ValueError):
                mod.OAuthConfig(key=key, secret=secret)
    assert auth.UNAUTHENTICATED_MSG == jax_auth.UNAUTHENTICATED_MSG


@pytest.mark.parametrize("header", [
    None, "", "Basic", "Basic !!!", "basic a2V5OnNlY3JldA==", "Basic a2V5OnNlY3JldA==",
    "Basic a2V5", "Basic a2V5OnM6ZWM6cmV0", "Bearer a2V5OnNlY3JldA==", "Basic w6k6w6k=",
])
def test_parse_basic_auth_equals_jax(header):
    assert auth.parse_basic_auth(header) == jax_auth.parse_basic_auth(header)


# ---------------------------------------------------------------- TLS config

def _cfg(mod, **kw):
    try:
        return type(mod.TlsConfig(**kw)).__name__
    except Exception as e:  # noqa: BLE001 — the refusal is the result compared
        return type(e).__name__


@pytest.mark.parametrize("kw", [
    dict(cert_file=str(CERTS / "server.crt")),
    dict(key_file=str(CERTS / "server.key")),
    dict(cert_file=str(CERTS / "server.crt"), key_file=str(CERTS / "missing.key")),
    dict(cert_file=str(CERTS / "server.crt"), key_file=str(CERTS / "server.key"), require_client_auth=True),
    dict(cert_file=str(CERTS / "server.crt"), key_file=str(CERTS / "server.key"), ca_file=str(CERTS / "ca.crt"),
         require_client_auth=True),
    dict(),
])
def test_tls_config_refuses_what_jax_refuses(kw):
    assert _cfg(tls, **kw) == _cfg(jax_tls, **kw)


def test_from_env_and_client_kwargs_equal_jax():
    env = {"SELDON_TLS_CERT": str(CERTS / "server.crt"), "SELDON_TLS_KEY": str(CERTS / "server.key"),
           "SELDON_TLS_CA": str(CERTS / "ca.crt"), "SELDON_TLS_REQUIRE_CLIENT_AUTH": "1"}
    ours, theirs = tls.TlsConfig.from_env(env), jax_tls.TlsConfig.from_env(env)
    assert ours.__dict__ == theirs.__dict__ and ours.enabled and ours.require_client_auth
    assert tls.TlsConfig.from_env({}) is None and jax_tls.TlsConfig.from_env({}) is None
    for kw in (dict(), dict(verify=False), dict(root_certificates_file="ca.pem"),
               dict(certificate_chain_file="c.pem", private_key_file="k.pem")):
        assert tls.requests_tls_kwargs(tls.ChannelCredentials(**kw)) == \
            jax_tls.requests_tls_kwargs(jax_tls.ChannelCredentials(**kw))
    ctx = tls.server_ssl_context(ours)
    assert ctx.verify_mode == ssl.CERT_REQUIRED


# ---------------------------------------------------------------- serving

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Doubler:
    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2


def _serve(tls_cfg, api="BOTH"):
    """The port's run_servers with TLS on a loop thread; returns the ports
    and a shutdown callable."""
    from seldon_core_tpu_torch.runtime.microservice import run_servers

    http_port, grpc_port = _free_port(), _free_port()
    loop = asyncio.new_event_loop()
    box = {}
    ready = threading.Event()

    def runner():
        asyncio.set_event_loop(loop)

        async def main():
            box["stop"] = asyncio.Event()
            ready.set()
            await run_servers(Doubler(), api=api, host="127.0.0.1", http_port=http_port, grpc_port=grpc_port,
                              shutdown_event=box["stop"], tls=tls_cfg)

        loop.run_until_complete(main())

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    assert ready.wait(10)
    for _ in range(100):
        try:
            with socket.create_connection(("127.0.0.1", http_port if api != "GRPC" else grpc_port), timeout=0.5):
                break
        except OSError:
            time.sleep(0.1)

    def shutdown():
        loop.call_soon_threadsafe(box["stop"].set)
        t.join(timeout=10)
        assert not t.is_alive()

    return http_port, grpc_port, shutdown


def _client_ctx(certs, client_cert=False):
    ctx = ssl.create_default_context(cafile=str(certs / "ca.crt"))
    if client_cert:
        ctx.load_cert_chain(str(certs / "client.crt"), str(certs / "client.key"))
    return ctx


def _https_predict(port, ctx, host="localhost"):
    import json
    import urllib.request

    req = urllib.request.Request(f"https://{host}:{port}/predict", method="POST",
                                 data=json.dumps({"data": {"ndarray": [[1.0, 2.0]]}}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10, context=ctx) as r:
        return json.loads(r.read())


def _grpc_predict(port, certs, client_cert=False):
    import grpc

    from seldon_core_tpu_torch.proto import pb, services

    read = lambda name: (certs / name).read_bytes()  # noqa: E731
    creds = grpc.ssl_channel_credentials(
        root_certificates=read("ca.crt"),
        private_key=read("client.key") if client_cert else None,
        certificate_chain=read("client.crt") if client_cert else None)
    with grpc.secure_channel(f"localhost:{port}", creds) as channel:
        req = pb.SeldonMessage()
        req.data.tensor.shape.extend([1, 2])
        req.data.tensor.values.extend([1.0, 2.0])
        return services.unary_callable(channel, "Model", "Predict")(req, timeout=10)


def _server_tls(certs, **kw):
    return tls.TlsConfig(cert_file=str(certs / "server.crt"), key_file=str(certs / "server.key"), **kw)


def test_rest_and_grpc_over_tls():
    http_port, grpc_port, shutdown = _serve(_server_tls(CERTS))
    try:
        assert _https_predict(http_port, _client_ctx(CERTS))["data"]["ndarray"] == [[2.0, 4.0]]
        assert list(_grpc_predict(grpc_port, CERTS).data.tensor.values) == [2.0, 4.0]
    finally:
        shutdown()


def test_plaintext_client_rejected_by_tls_server():
    import urllib.error
    import urllib.request

    http_port, _, shutdown = _serve(_server_tls(CERTS), api="REST")
    try:
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
            urllib.request.urlopen(f"http://127.0.0.1:{http_port}/health/ping", timeout=5).read()
    finally:
        shutdown()


def test_mtls_requires_client_cert():
    import urllib.error

    cfg = _server_tls(CERTS, ca_file=str(CERTS / "ca.crt"), require_client_auth=True)
    http_port, grpc_port, shutdown = _serve(cfg)
    try:
        # TLS 1.3 reports the missing client certificate after the
        # handshake: an SSL error or an aborted connection
        with pytest.raises((ssl.SSLError, urllib.error.URLError, ConnectionError, OSError)):
            _https_predict(http_port, _client_ctx(CERTS))
        assert _https_predict(http_port, _client_ctx(CERTS, client_cert=True))["data"]["ndarray"] == [[2.0, 4.0]]
        assert list(_grpc_predict(grpc_port, CERTS, client_cert=True).data.tensor.values) == [2.0, 4.0]
    finally:
        shutdown()


def test_cli_refuses_a_key_without_a_cert():
    import subprocess

    out = subprocess.run(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice", "tests.test_torch_port_tls_auth.Doubler",
         "--ssl-key", str(CERTS / "server.key")],
        cwd=CERTS.parents[2], capture_output=True, text=True, timeout=120, env={**os.environ, "SELDON_TLS_CERT": ""})
    assert out.returncode != 0 and "cert_file and key_file together" in out.stderr


def test_freshly_minted_certificate_serves():
    """As tests/test_tls.py: a CA and a server certificate minted now."""
    pytest.importorskip("cryptography", reason="mints a certificate with the cryptography package")
    import ipaddress
    import tempfile

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    now = datetime.datetime.now(datetime.timezone.utc)
    ca_key, key = ec.generate_private_key(ec.SECP256R1()), ec.generate_private_key(ec.SECP256R1())
    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "minted-ca")])
    window = dict(not_valid_before=now - datetime.timedelta(minutes=1), not_valid_after=now + datetime.timedelta(days=1))
    ca = (x509.CertificateBuilder(subject_name=ca_name, issuer_name=ca_name, public_key=ca_key.public_key(),
                                  serial_number=x509.random_serial_number(), **window)
          .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True).sign(ca_key, hashes.SHA256()))
    cert = (x509.CertificateBuilder(subject_name=x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")]),
                                    issuer_name=ca_name, public_key=key.public_key(),
                                    serial_number=x509.random_serial_number(), **window)
            .add_extension(x509.SubjectAlternativeName([x509.DNSName("localhost"),
                                                        x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
                           critical=False).sign(ca_key, hashes.SHA256()))
    with tempfile.TemporaryDirectory() as d:
        d = pathlib.Path(d)
        (d / "ca.crt").write_bytes(ca.public_bytes(serialization.Encoding.PEM))
        (d / "server.crt").write_bytes(cert.public_bytes(serialization.Encoding.PEM))
        (d / "server.key").write_bytes(key.private_bytes(serialization.Encoding.PEM,
                                                         serialization.PrivateFormat.PKCS8,
                                                         serialization.NoEncryption()))
        http_port, grpc_port, shutdown = _serve(_server_tls(d))
        try:
            assert _https_predict(http_port, _client_ctx(d), host="127.0.0.1")["data"]["ndarray"] == [[2.0, 4.0]]
            assert list(_grpc_predict(grpc_port, d).data.tensor.values) == [2.0, 4.0]
        finally:
            shutdown()
