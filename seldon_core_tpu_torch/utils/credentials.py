"""Cloud-storage credential builders.

The port's copy of ``seldon_core_tpu/utils/credentials.py`` (reference:
operator/controllers/resources/credentials/s3/s3_secret.go,
.../gcs/gcs_secret.go, python/seldon_core/storage.py:40-184): the
operator turns k8s Secrets and service accounts into the env the storage
initializer reads.  Without k8s, the same contract holds through the
process env or explicit secret dicts: ``*_from_secret`` maps the
reference's secret keys, so an artifact of either convention works
unchanged.  The cloud SDKs are imported only when a client is built.
"""

from __future__ import annotations

import base64
import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

logger = logging.getLogger(__name__)


def _decode(v: Any) -> str:
    """Secret values may arrive base64-encoded (k8s wire form)."""
    if isinstance(v, bytes):
        v = v.decode()
    try:
        decoded = base64.b64decode(v, validate=True).decode()
        # round-trips cleanly AND decodes to printable text -> was base64
        if decoded.isprintable() and base64.b64encode(decoded.encode()).decode() == v:
            return decoded
    except Exception:  # noqa: BLE001 — not base64: use the raw value
        pass
    return str(v)


@dataclass
class S3Credentials:
    """reference: s3_secret.go envs (AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY /
    AWS_ENDPOINT_URL / USE_SSL)."""

    access_key: str = ""
    secret_key: str = ""
    endpoint: str = ""
    region: str = ""
    use_ssl: bool = True

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "S3Credentials":
        e = env if env is not None else os.environ
        return cls(
            access_key=e.get("AWS_ACCESS_KEY_ID", ""),
            secret_key=e.get("AWS_SECRET_ACCESS_KEY", ""),
            endpoint=e.get("AWS_ENDPOINT_URL", e.get("S3_ENDPOINT", "")),
            region=e.get("AWS_REGION", e.get("AWS_DEFAULT_REGION", "")),
            use_ssl=e.get("S3_USE_HTTPS", e.get("USE_SSL", "1")) not in ("0", "false", "False"),
        )

    @classmethod
    def from_secret(cls, secret: Mapping[str, Any]) -> "S3Credentials":
        """k8s-style secret data dict (reference secret key names)."""
        return cls(
            access_key=_decode(secret.get("awsAccessKeyID", secret.get("AWS_ACCESS_KEY_ID", ""))),
            secret_key=_decode(
                secret.get("awsSecretAccessKey", secret.get("AWS_SECRET_ACCESS_KEY", ""))
            ),
            endpoint=_decode(secret.get("s3Endpoint", secret.get("AWS_ENDPOINT_URL", ""))),
            region=_decode(secret.get("awsRegion", secret.get("AWS_REGION", ""))),
            use_ssl=_decode(secret.get("s3UseHttps", secret.get("USE_SSL", "1")))
            not in ("0", "false", "False"),
        )

    def client_kwargs(self) -> Dict[str, Any]:
        """kwargs for boto3.client("s3", ...)."""
        kwargs: Dict[str, Any] = {}
        if self.access_key:
            kwargs["aws_access_key_id"] = self.access_key
        if self.secret_key:
            kwargs["aws_secret_access_key"] = self.secret_key
        if self.endpoint:
            kwargs["endpoint_url"] = self.endpoint
        if self.region:
            kwargs["region_name"] = self.region
        kwargs["use_ssl"] = self.use_ssl
        return kwargs


@dataclass
class GcsCredentials:
    """Service-account JSON, by path (GOOGLE_APPLICATION_CREDENTIALS) or
    inline (the reference's gcsCredentialFileName secret volume)."""

    service_account_file: str = ""
    service_account_json: str = ""

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "GcsCredentials":
        e = env if env is not None else os.environ
        return cls(
            service_account_file=e.get("GOOGLE_APPLICATION_CREDENTIALS", ""),
            service_account_json=e.get("GOOGLE_APPLICATION_CREDENTIALS_JSON", ""),
        )

    def client(self):
        from google.cloud import storage as gcs  # type: ignore

        if self.service_account_json:
            info = json.loads(self.service_account_json)
            return gcs.Client.from_service_account_info(info)
        if self.service_account_file:
            return gcs.Client.from_service_account_json(self.service_account_file)
        try:
            return gcs.Client()
        except Exception:  # noqa: BLE001 — anonymous fallback for public buckets
            return gcs.Client.create_anonymous_client()


@dataclass
class AzureCredentials:
    """Azure Blob account credentials (reference: storage.py's azure
    lane authenticates via connection string / account key)."""

    connection_string: str = ""
    account_name: str = ""
    account_key: str = ""

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "AzureCredentials":
        e = env if env is not None else os.environ
        return cls(
            connection_string=e.get("AZURE_STORAGE_CONNECTION_STRING", ""),
            account_name=e.get("AZURE_STORAGE_ACCOUNT", ""),
            account_key=e.get("AZURE_STORAGE_ACCESS_KEY", ""),
        )

    def service_client(self, account_url: str = ""):
        from azure.storage.blob import BlobServiceClient  # type: ignore

        if self.connection_string:
            return BlobServiceClient.from_connection_string(self.connection_string)
        url = account_url or f"https://{self.account_name}.blob.core.windows.net"
        return BlobServiceClient(account_url=url, credential=self.account_key or None)
