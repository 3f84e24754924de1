"""Model-artifact storage downloader.

The port's counterpart of ``seldon_core_tpu/utils/storage.py`` (the
reference's KFServing-derived ``Storage.download``,
python/seldon_core/storage.py:40-184): resolve a model URI to a local
directory or file before serving.  Supported schemes:

* ``file://`` and bare paths: used in place (no copy);
* ``http(s)://``: fetched into the cache directory with
  ``urllib.request`` (the JAX package uses ``requests``, which the port
  does not need);
* ``gs://``, ``s3://``, ``azure://`` (or
  ``https://*.blob.core.windows.net/...``): gated on
  google-cloud-storage, boto3 and azure-storage-blob being installed;
  credentials come from ``utils.credentials`` (env or secret dicts, the
  operator-injected contract).

Remote downloads land under ``SELDON_TPU_MODEL_CACHE`` (default:
``seldon-tpu-models`` under the temp directory) unless ``out_dir`` is
given.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import urllib.request
from typing import Optional
from urllib.parse import urlparse

from seldon_core_tpu_torch.runtime import knobs

logger = logging.getLogger(__name__)

_CACHE_ENV = "SELDON_TPU_MODEL_CACHE"


def _cache_dir() -> str:
    d = knobs.raw(_CACHE_ENV) or os.path.join(tempfile.gettempdir(), "seldon-tpu-models")
    os.makedirs(d, exist_ok=True)
    return d


def _prefix_rel(name: str, prefix: str) -> Optional[str]:
    """Path of object `name` relative to directory-like `prefix`.

    None when the listing's string-prefix match is not on a path-segment
    boundary — e.g. models/m10/w.bin under prefix models/m1 — which
    would otherwise escape out_dir through a '../' relpath.
    """
    if name == prefix:
        return os.path.basename(name)
    if not prefix:
        return name
    base = prefix.rstrip("/")
    if name.startswith(base + "/"):
        return name[len(base) + 1:]
    return None


def download(uri: str, out_dir: Optional[str] = None) -> str:
    """Resolve `uri` to a local path, downloading if remote."""
    parsed = urlparse(uri)
    scheme = parsed.scheme

    if scheme in ("", "file"):
        path = parsed.path if scheme == "file" else uri
        if not os.path.exists(path):
            raise FileNotFoundError(f"model uri not found: {uri}")
        return path

    if scheme == "azure" or (
        scheme in ("http", "https") and parsed.netloc.endswith(".blob.core.windows.net")
    ):
        return _download_azure(parsed, uri, out_dir)

    if scheme in ("http", "https"):
        out_dir = out_dir or _cache_dir()
        dest = os.path.join(out_dir, os.path.basename(parsed.path) or "model")
        if not os.path.exists(dest):
            logger.info("downloading %s -> %s", uri, dest)
            # urlopen raises HTTPError on a 4xx / 5xx status
            with urllib.request.urlopen(uri, timeout=60) as r, open(dest + ".tmp", "wb") as f:
                shutil.copyfileobj(r, f)
            os.replace(dest + ".tmp", dest)
        return dest

    if scheme == "gs":
        try:
            from google.cloud import storage as gcs  # noqa: F401
        except ImportError as e:
            raise RuntimeError("gs:// model uris need google-cloud-storage installed") from e
        from seldon_core_tpu_torch.utils.credentials import GcsCredentials

        out_dir = out_dir or os.path.join(_cache_dir(), parsed.netloc, parsed.path.lstrip("/"))
        os.makedirs(out_dir, exist_ok=True)
        client = GcsCredentials.from_env().client()
        bucket = client.bucket(parsed.netloc)
        prefix = parsed.path.lstrip("/")
        count = 0
        for blob in client.list_blobs(bucket, prefix=prefix):
            rel = _prefix_rel(blob.name, prefix)
            if rel is None:  # sibling prefix (models/m10 vs models/m1)
                continue
            dest = os.path.join(out_dir, rel)
            os.makedirs(os.path.dirname(dest) or out_dir, exist_ok=True)
            blob.download_to_filename(dest)
            count += 1
        if count == 0:
            raise FileNotFoundError(f"no objects under {uri}")
        return out_dir

    if scheme == "s3":
        try:
            import boto3  # type: ignore
        except ImportError as e:
            raise RuntimeError("s3:// model uris need boto3 installed") from e
        from seldon_core_tpu_torch.utils.credentials import S3Credentials

        out_dir = out_dir or os.path.join(_cache_dir(), parsed.netloc, parsed.path.lstrip("/"))
        os.makedirs(out_dir, exist_ok=True)
        s3 = boto3.client("s3", **S3Credentials.from_env().client_kwargs())
        prefix = parsed.path.lstrip("/")
        resp = s3.list_objects_v2(Bucket=parsed.netloc, Prefix=prefix)
        contents = resp.get("Contents", [])
        if not contents:
            raise FileNotFoundError(f"no objects under {uri}")
        count = 0
        for obj in contents:
            rel = _prefix_rel(obj["Key"], prefix)
            if rel is None:  # sibling prefix (models/m10 vs models/m1)
                continue
            dest = os.path.join(out_dir, rel)
            os.makedirs(os.path.dirname(dest) or out_dir, exist_ok=True)
            s3.download_file(parsed.netloc, obj["Key"], dest)
            count += 1
        if count == 0:
            raise FileNotFoundError(f"no objects under {uri}")
        return out_dir

    raise ValueError(f"unsupported model uri scheme: {uri!r}")


def _download_azure(parsed, uri: str, out_dir: Optional[str]) -> str:
    """Azure Blob download (reference: storage.py's azure lane).

    Accepts ``azure://account/container/prefix`` or the native
    ``https://account.blob.core.windows.net/container/prefix`` form.
    """
    try:
        import azure.storage.blob  # type: ignore  # noqa: F401
    except ImportError as e:
        raise RuntimeError("azure model uris need azure-storage-blob installed") from e
    from seldon_core_tpu_torch.utils.credentials import AzureCredentials

    if parsed.scheme == "azure":
        account = parsed.netloc
        container, _, prefix = parsed.path.lstrip("/").partition("/")
        account_url = f"https://{account}.blob.core.windows.net"
    else:
        account_url = f"https://{parsed.netloc}"
        container, _, prefix = parsed.path.lstrip("/").partition("/")
    if not container:
        raise ValueError(f"azure uri needs a container: {uri!r}")
    service = AzureCredentials.from_env().service_client(account_url)
    holder = service.get_container_client(container)
    out_dir = out_dir or os.path.join(_cache_dir(), parsed.netloc, container, prefix)
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for blob in holder.list_blobs(name_starts_with=prefix):
        name = blob.name if hasattr(blob, "name") else blob["name"]
        rel = _prefix_rel(name, prefix)
        if rel is None:  # sibling prefix (models/m10 vs models/m1)
            continue
        dest = os.path.join(out_dir, rel)
        os.makedirs(os.path.dirname(dest) or out_dir, exist_ok=True)
        with open(dest, "wb") as f:
            holder.download_blob(name).readinto(f)
        count += 1
    if count == 0:
        raise FileNotFoundError(f"no objects under {uri}")
    return out_dir
