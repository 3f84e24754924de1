"""Microservice CLI — wrap one user component as a serving process.

The port's counterpart of ``seldon_core_tpu.runtime.microservice``
(reference: python/seldon_core/microservice.py:186-375):

    python -m seldon_core_tpu_torch.runtime.microservice \\
        seldon_core_tpu_torch.models.cudaserver.CudaServer --api REST \\
        --http-port 9000 --grpc-port 5000 \\
        --parameters '[{"name":"model","value":"resnet50","type":"STRING"}]'

``--api`` picks REST (the default), GRPC or BOTH; one process serves
both on one asyncio loop.  The device is the component's own ``device``
parameter (CudaServer serves on ``cuda`` unless told ``cpu``); there is
no ``--platform`` flag.  ``--ssl-cert`` / ``--ssl-key`` (with
``--ssl-ca`` and ``--ssl-require-client-auth`` for mTLS; or the
``SELDON_TLS_*`` env) put TLS on both listeners; ``--tracing`` (or
``TRACING=1``) installs the tracer, with a JSONL span sink at
``SELDON_TPU_TRACE_EXPORT`` and OTLP export at
``OTEL_EXPORTER_OTLP_ENDPOINT``.  ``--persistence`` restores the
component's ``checkpoint_state`` tree from ``--persistence-dir`` (or
``PERSISTENCE_DIR``) before load and snapshots it every
``--persistence-period-s`` and at exit (``utils/persistence.py``).  Not
ported: the component ``custom_service`` side loop.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import logging
import os
import signal
import sys
import tempfile
from typing import Any, List, Optional

from seldon_core_tpu_torch.runtime import knobs
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.params import (
    PARAMETERS_ENV_NAME,
    SERVICE_PORT_ENV_NAME,
    UNIT_ID_ENV_NAME,
    parse_parameters,
)

logger = logging.getLogger(__name__)


def import_component(dotted: str, **kwargs: Any) -> Any:
    """Instantiate ``pkg.module.Class`` (or bare ``MyModel`` from module
    ``MyModel``) with typed parameter kwargs."""
    module_name, _, class_name = dotted.rpartition(".")
    if not module_name:
        module_name = class_name = dotted
    sys.path.insert(0, os.getcwd())
    module = importlib.import_module(module_name)
    return getattr(module, class_name)(**kwargs)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="seldon-core-tpu microservice (PyTorch/CUDA port)")
    parser.add_argument("component", help="dotted path module.Class of the user component")
    parser.add_argument("--api", choices=("REST", "GRPC", "BOTH"), default="REST")
    parser.add_argument("--http-port", type=int, default=int(os.environ.get(SERVICE_PORT_ENV_NAME, 9000)))
    parser.add_argument("--grpc-port", type=int, default=5000)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument(
        "--parameters", default=os.environ.get(PARAMETERS_ENV_NAME, "[]"),
        help="typed parameter list JSON",
    )
    parser.add_argument("--unit-id", default=os.environ.get(UNIT_ID_ENV_NAME, ""))
    parser.add_argument("--persistence", action="store_true", help="periodically checkpoint component state")
    parser.add_argument("--persistence-dir", default=os.environ.get("PERSISTENCE_DIR", os.path.join(tempfile.gettempdir(), "seldon-tpu-state")))
    parser.add_argument("--persistence-period-s", type=float, default=60.0)
    parser.add_argument("--ssl-cert", default=os.environ.get("SELDON_TLS_CERT", ""),
                        help="PEM certificate; enables TLS on REST and gRPC")
    parser.add_argument("--ssl-key", default=os.environ.get("SELDON_TLS_KEY", ""))
    parser.add_argument("--ssl-ca", default=os.environ.get("SELDON_TLS_CA", ""),
                        help="peer-verification CA (with --ssl-require-client-auth: mTLS)")
    parser.add_argument("--ssl-require-client-auth", action="store_true",
                        default=os.environ.get("SELDON_TLS_REQUIRE_CLIENT_AUTH", "0") == "1")
    parser.add_argument("--tracing", action="store_true", default=bool(int(os.environ.get("TRACING", "0"))))
    parser.add_argument("--log-level", default=os.environ.get("SELDON_LOG_LEVEL", "INFO"))
    return parser.parse_args(argv)


async def run_servers(
    user_model: Any,
    api: str = "REST",
    host: str = "0.0.0.0",
    http_port: int = 9000,
    grpc_port: int = 5000,
    unit_id: str = "",
    shutdown_event: Optional[asyncio.Event] = None,
    tls=None,
) -> None:
    """Serve until `shutdown_event` (or SIGINT/SIGTERM); ``tls`` (a
    ``utils.tls.TlsConfig``) secures both listeners."""
    from seldon_core_tpu_torch.runtime import grpc_server, rest

    runner = None
    server = None
    secure = " (TLS)" if tls is not None and tls.enabled else ""
    if api in ("REST", "BOTH"):
        runner = await rest.serve(rest.build_app(user_model, unit_id=unit_id), host=host, port=http_port, tls=tls)
        logger.info("REST serving on %s:%d%s", host, http_port, secure)
    if api in ("GRPC", "BOTH"):
        server = await grpc_server.serve(user_model, port=grpc_port, host=host, unit_id=unit_id, tls=tls)
        logger.info("gRPC serving on %s:%d%s", host, grpc_port, secure)
    if shutdown_event is None:
        shutdown_event = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, shutdown_event.set)
    try:
        await shutdown_event.wait()
        # a component with drain() settles its in-flight work before the
        # servers stop (the JAX package's StreamingLM journals its streams)
        drain_fn = getattr(user_model, "drain", None)
        if callable(drain_fn):
            try:
                await asyncio.get_running_loop().run_in_executor(None, drain_fn)
            except MicroserviceError as e:  # a component that refuses drain (not ported for it)
                logger.info("component drain skipped: %s", e.message)
            except Exception:  # noqa: BLE001 — drain is best-effort; exit anyway
                logger.exception("component drain failed during shutdown")
    finally:
        if server is not None:
            await server.stop(grace=20.0)
        if runner is not None:
            await runner.cleanup()


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(), format="%(asctime)s %(name)s %(levelname)s %(message)s")
    tls = None
    if args.ssl_cert or args.ssl_key:
        # key-without-cert fails loudly (TlsConfig raises), never serves
        # the plaintext the operator thinks is TLS
        from seldon_core_tpu_torch.utils.tls import TlsConfig

        tls = TlsConfig(cert_file=args.ssl_cert, key_file=args.ssl_key, ca_file=args.ssl_ca,
                        require_client_auth=args.ssl_require_client_auth)
    kwargs = parse_parameters(json.loads(args.parameters))
    user_model = import_component(args.component, **kwargs)
    if args.tracing:
        from seldon_core_tpu_torch.utils.tracing import setup_tracing

        setup_tracing(service_name=args.unit_id or args.component,
                      export_path=knobs.raw("SELDON_TPU_TRACE_EXPORT") or None)
    persistence_thread = None
    if args.persistence:
        from seldon_core_tpu_torch.utils.persistence import PersistenceManager

        manager = PersistenceManager(args.persistence_dir, args.unit_id or args.component)
        manager.restore(user_model)
        persistence_thread = manager.start_background(user_model, period_s=args.persistence_period_s)
    if hasattr(user_model, "load"):
        user_model.load()
    try:
        asyncio.run(run_servers(user_model, api=args.api, host=args.host, http_port=args.http_port,
                                grpc_port=args.grpc_port, unit_id=args.unit_id, tls=tls))
    finally:
        if persistence_thread is not None:
            persistence_thread.stop()
        if hasattr(user_model, "unload"):
            user_model.unload()


if __name__ == "__main__":
    main()
