"""The port's ``utils/credentials.py`` and ``utils/storage.py`` against the JAX package's.

Every case of ``tests/test_storage.py`` runs on both modules with the
same mocked SDKs (fake ``boto3``, ``google.cloud.storage`` and
``azure.storage.blob`` put into ``sys.modules``: nothing leaves the
host), and the two must download the same files with the same calls.
Then the port's own lanes: ``http(s)://`` through ``urllib.request``
against a local ``http.server`` thread (the JAX package uses
``requests``), the sibling-prefix guard of ``_prefix_rel`` (an object
``models/m10/...`` listed under the prefix ``models/m1`` is skipped, so
nothing escapes ``out_dir``), the local schemes and the cache knob.
"""

import base64
import http.server
import os
import sys
import threading
import types

import pytest

from seldon_core_tpu.utils import credentials as jax_credentials
from seldon_core_tpu.utils import storage as jax_storage
from seldon_core_tpu_torch.utils import credentials, storage

IMPLS = {"jax": (jax_storage, jax_credentials), "port": (storage, credentials)}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


# ---------------------------------------------------------------------------
# credentials
# ---------------------------------------------------------------------------

S3_ENVS = [
    {"AWS_ACCESS_KEY_ID": "AK", "AWS_SECRET_ACCESS_KEY": "SK", "AWS_ENDPOINT_URL": "http://minio:9000",
     "AWS_REGION": "us-east-1", "USE_SSL": "0"},
    {},
    {"S3_ENDPOINT": "s3.example.com", "AWS_DEFAULT_REGION": "eu-west-1", "S3_USE_HTTPS": "false"},
]
SECRETS = [
    {"awsAccessKeyID": base64.b64encode(b"AK2").decode(), "awsSecretAccessKey": base64.b64encode(b"SK2").decode(),
     "s3Endpoint": "s3.example.com"},
    {"AWS_ACCESS_KEY_ID": "plain-key", "AWS_SECRET_ACCESS_KEY": "not base64!", "s3UseHttps": "0"},
    {"awsAccessKeyID": b"QUsz", "awsRegion": base64.b64encode(b"ap-south-1").decode()},
]


@pytest.mark.parametrize("env", S3_ENVS, ids=["reference_names", "empty", "aliases"])
def test_s3_credentials_from_env_as_jax(env):
    port, jax = credentials.S3Credentials.from_env(env), jax_credentials.S3Credentials.from_env(env)
    assert vars(port) == vars(jax)
    assert port.client_kwargs() == jax.client_kwargs()


def test_s3_client_kwargs_of_the_reference_names():
    kwargs = credentials.S3Credentials.from_env(S3_ENVS[0]).client_kwargs()
    assert kwargs == {"aws_access_key_id": "AK", "aws_secret_access_key": "SK",
                      "endpoint_url": "http://minio:9000", "region_name": "us-east-1", "use_ssl": False}
    assert credentials.S3Credentials.from_env({}).client_kwargs() == {"use_ssl": True}


@pytest.mark.parametrize("secret", SECRETS, ids=["base64", "plain", "bytes_and_region"])
def test_s3_credentials_from_secret_as_jax(secret):
    port, jax = credentials.S3Credentials.from_secret(secret), jax_credentials.S3Credentials.from_secret(secret)
    assert vars(port) == vars(jax)
    if secret is SECRETS[0]:
        assert (port.access_key, port.secret_key, port.endpoint) == ("AK2", "SK2", "s3.example.com")


def test_gcs_and_azure_credentials_from_env_as_jax():
    gcs_env = {"GOOGLE_APPLICATION_CREDENTIALS": "/sa.json", "GOOGLE_APPLICATION_CREDENTIALS_JSON": "{}"}
    az_env = {"AZURE_STORAGE_ACCOUNT": "acct", "AZURE_STORAGE_ACCESS_KEY": "key",
              "AZURE_STORAGE_CONNECTION_STRING": "cs"}
    assert vars(credentials.GcsCredentials.from_env(gcs_env)) == vars(jax_credentials.GcsCredentials.from_env(gcs_env))
    assert vars(credentials.AzureCredentials.from_env(az_env)) == vars(
        jax_credentials.AzureCredentials.from_env(az_env))
    assert credentials.GcsCredentials.from_env(gcs_env).service_account_file == "/sa.json"


# ---------------------------------------------------------------------------
# mocked cloud SDKs (tests/test_storage.py's fakes, with a sibling prefix)
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_s3(monkeypatch):
    calls = {}

    class FakeS3:
        def list_objects_v2(self, Bucket, Prefix):
            calls["list"] = (Bucket, Prefix)
            return {"Contents": [{"Key": f"{Prefix}/weights.msgpack"}, {"Key": f"{Prefix}/sub/meta.json"},
                                 {"Key": f"{Prefix}0/escape.bin"}]}

        def download_file(self, bucket, key, dest):
            calls.setdefault("downloads", []).append((bucket, key, os.path.basename(dest)))
            with open(dest, "wb") as f:
                f.write(b"data:" + key.encode())

    def client(service, **kwargs):
        calls["client"] = (service, kwargs)
        return FakeS3()

    fake = types.ModuleType("boto3")
    fake.client = client
    monkeypatch.setitem(sys.modules, "boto3", fake)
    return calls


def test_s3_download_lists_downloads_and_plumbs_credentials(impl, fake_s3, tmp_path, monkeypatch):
    mod, _ = impl
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AK")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "SK")
    monkeypatch.setenv("AWS_ENDPOINT_URL", "http://minio:9000")
    out = mod.download("s3://models/resnet/v1", out_dir=str(tmp_path))
    assert out == str(tmp_path)
    assert fake_s3["list"] == ("models", "resnet/v1")
    service, kwargs = fake_s3["client"]
    assert service == "s3" and kwargs["aws_access_key_id"] == "AK" and kwargs["endpoint_url"] == "http://minio:9000"
    assert (tmp_path / "weights.msgpack").read_bytes() == b"data:resnet/v1/weights.msgpack"
    assert (tmp_path / "sub" / "meta.json").exists()
    # the sibling prefix resnet/v10 is listed by the string prefix and skipped
    assert [d[1] for d in fake_s3["downloads"]] == ["resnet/v1/weights.msgpack", "resnet/v1/sub/meta.json"]
    assert not (tmp_path.parent / "escape.bin").exists()


def test_s3_empty_bucket_raises(impl, tmp_path, monkeypatch):
    mod, _ = impl
    fake = types.ModuleType("boto3")

    class Empty:
        def list_objects_v2(self, Bucket, Prefix):
            return {}

    fake.client = lambda *a, **k: Empty()
    monkeypatch.setitem(sys.modules, "boto3", fake)
    with pytest.raises(FileNotFoundError):
        mod.download("s3://models/none", out_dir=str(tmp_path))


@pytest.fixture
def fake_gcs(monkeypatch):
    calls = {}

    class Blob:
        def __init__(self, name):
            self.name = name

        def download_to_filename(self, dest):
            calls.setdefault("downloads", []).append(self.name)
            with open(dest, "wb") as f:
                f.write(b"gcs:" + self.name.encode())

    class FakeClient:
        def bucket(self, name):
            calls["bucket"] = name
            return name

        def list_blobs(self, bucket, prefix):
            calls["list"] = (bucket, prefix)
            return [Blob(f"{prefix}/model.msgpack"), Blob(f"{prefix}0/other.msgpack")]

    def from_json(cls, path):
        calls["sa_file"] = path
        return cls()

    gcloud = types.ModuleType("google.cloud")
    gcs_mod = types.ModuleType("google.cloud.storage")
    gcs_mod.Client = FakeClient
    FakeClient.from_service_account_json = classmethod(from_json)
    gcloud.storage = gcs_mod
    monkeypatch.setitem(sys.modules, "google.cloud", gcloud)
    monkeypatch.setitem(sys.modules, "google.cloud.storage", gcs_mod)
    return calls


def test_gcs_download_with_service_account(impl, fake_gcs, tmp_path, monkeypatch):
    mod, _ = impl
    monkeypatch.setenv("GOOGLE_APPLICATION_CREDENTIALS", "/sa.json")
    out = mod.download("gs://bucket/models/m1", out_dir=str(tmp_path))
    assert out == str(tmp_path)
    assert fake_gcs["sa_file"] == "/sa.json" and fake_gcs["list"] == ("bucket", "models/m1")
    assert (tmp_path / "model.msgpack").read_bytes() == b"gcs:models/m1/model.msgpack"
    assert fake_gcs["downloads"] == ["models/m1/model.msgpack"]  # models/m10 is a sibling, skipped


@pytest.fixture
def fake_azure(monkeypatch):
    calls = {}

    class Downloader:
        def __init__(self, name):
            self.name = name

        def readinto(self, f):
            f.write(b"az:" + self.name.encode())

    class Container:
        def list_blobs(self, name_starts_with):
            calls["list"] = name_starts_with
            return [types.SimpleNamespace(name=f"{name_starts_with}/weights.bin"), {"name": f"{name_starts_with}x/y"}]

        def download_blob(self, name):
            calls.setdefault("downloads", []).append(name)
            return Downloader(name)

    class FakeService:
        def get_container_client(self, container):
            calls["container"] = container
            return Container()

    def service_ctor(account_url=None, credential=None):
        calls["account_url"] = account_url
        calls["credential"] = credential
        return FakeService()

    def from_connection_string(cs):
        calls["cs"] = cs
        return FakeService()

    az = types.ModuleType("azure")
    az_storage = types.ModuleType("azure.storage")
    az_blob = types.ModuleType("azure.storage.blob")
    az_blob.BlobServiceClient = service_ctor
    az_blob.BlobServiceClient.from_connection_string = from_connection_string
    az_storage.blob = az_blob
    az.storage = az_storage
    monkeypatch.setitem(sys.modules, "azure", az)
    monkeypatch.setitem(sys.modules, "azure.storage", az_storage)
    monkeypatch.setitem(sys.modules, "azure.storage.blob", az_blob)
    return calls


def test_azure_scheme(impl, fake_azure, tmp_path, monkeypatch):
    mod, _ = impl
    monkeypatch.setenv("AZURE_STORAGE_ACCOUNT", "acct")
    monkeypatch.setenv("AZURE_STORAGE_ACCESS_KEY", "key")
    out = mod.download("azure://acct/container/models/m1", out_dir=str(tmp_path))
    assert out == str(tmp_path)
    assert fake_azure["account_url"] == "https://acct.blob.core.windows.net"
    assert fake_azure["credential"] == "key" and fake_azure["container"] == "container"
    assert fake_azure["list"] == "models/m1" and fake_azure["downloads"] == ["models/m1/weights.bin"]
    assert (tmp_path / "weights.bin").read_bytes() == b"az:models/m1/weights.bin"


def test_azure_native_https_form_and_connection_string(impl, fake_azure, tmp_path, monkeypatch):
    mod, _ = impl
    out = mod.download("https://acct.blob.core.windows.net/container/models/m2", out_dir=str(tmp_path / "a"))
    assert out == str(tmp_path / "a") and fake_azure["account_url"] == "https://acct.blob.core.windows.net"
    monkeypatch.setenv("AZURE_STORAGE_CONNECTION_STRING", "DefaultEndpointsProtocol=https")
    mod.download("azure://acct/container/models/m3", out_dir=str(tmp_path / "b"))
    assert fake_azure["cs"] == "DefaultEndpointsProtocol=https"


def test_azure_missing_container_rejected(impl, fake_azure, tmp_path):
    mod, _ = impl
    with pytest.raises(ValueError):
        mod.download("azure://acct", out_dir=str(tmp_path))


@pytest.mark.parametrize("uri", ["gs://b/p", "s3://b/p", "azure://a/c/p"])
def test_cloud_lanes_are_gated_on_their_sdk(impl, uri, monkeypatch, tmp_path):
    mod, _ = impl
    for name in ("boto3", "google.cloud", "google.cloud.storage", "azure", "azure.storage", "azure.storage.blob"):
        monkeypatch.setitem(sys.modules, name, None)  # import raises ImportError
    with pytest.raises(RuntimeError, match="installed"):
        mod.download(uri, out_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# the prefix guard, local schemes, the cache knob
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,prefix,want", [
    ("models/m1/w.bin", "models/m1", "w.bin"),
    ("models/m1/sub/w.bin", "models/m1/", "sub/w.bin"),
    ("models/m10/w.bin", "models/m1", None),
    ("models/m1", "models/m1", "m1"),
    ("a/b", "", "a/b"),
    ("models/m1-old/w.bin", "models/m1", None),
])
def test_prefix_rel_keeps_objects_on_a_segment_boundary(name, prefix, want):
    assert storage._prefix_rel(name, prefix) == jax_storage._prefix_rel(name, prefix) == want


def test_local_paths_are_used_in_place(impl, tmp_path):
    mod, _ = impl
    f = tmp_path / "w.msgpack"
    f.write_bytes(b"x")
    assert mod.download(f"file://{f}") == str(f)
    assert mod.download(str(tmp_path)) == str(tmp_path)
    with pytest.raises(FileNotFoundError, match="model uri not found"):
        mod.download(f"file://{tmp_path}/missing")
    with pytest.raises(ValueError, match="unsupported model uri scheme"):
        mod.download("ftp://host/x")


class _Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        if self.path == "/models/w.msgpack":
            body = b"weights" * 1000
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_error(404)

    def log_message(self, *args):
        pass


@pytest.fixture
def http_server():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def test_http_lane_fetches_once_into_the_cache(http_server, tmp_path, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_MODEL_CACHE", str(tmp_path / "cache"))
    path = storage.download(f"{http_server}/models/w.msgpack")
    assert path == str(tmp_path / "cache" / "w.msgpack")
    assert open(path, "rb").read() == b"weights" * 1000
    assert not os.path.exists(path + ".tmp")
    os.utime(path, (0, 0))
    assert storage.download(f"{http_server}/models/w.msgpack") == path  # cached: not fetched again
    assert os.stat(path).st_mtime == 0


def test_http_lane_errors_leave_no_file(http_server, tmp_path):
    import urllib.error

    with pytest.raises(urllib.error.HTTPError):
        storage.download(f"{http_server}/missing.bin", out_dir=str(tmp_path))
    assert not (tmp_path / "missing.bin").exists()


def test_cache_dir_follows_the_knob(monkeypatch, tmp_path):
    monkeypatch.setenv("SELDON_TPU_MODEL_CACHE", str(tmp_path / "c"))
    assert storage._cache_dir() == jax_storage._cache_dir() == str(tmp_path / "c")
    monkeypatch.delenv("SELDON_TPU_MODEL_CACHE")
    assert storage._cache_dir() == jax_storage._cache_dir()
