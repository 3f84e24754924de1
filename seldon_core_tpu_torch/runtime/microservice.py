"""Microservice CLI — wrap one user component as a serving process.

The port's counterpart of ``seldon_core_tpu.runtime.microservice``
(reference: python/seldon_core/microservice.py:186-375):

    python -m seldon_core_tpu_torch.runtime.microservice \\
        seldon_core_tpu_torch.models.cudaserver.CudaServer --api REST \\
        --http-port 9000 \\
        --parameters '[{"name":"model","value":"resnet50","type":"STRING"}]'

The device is the component's own ``device`` parameter (CudaServer
serves on ``cuda`` unless told ``cpu``); there is no ``--platform``
flag.  This slice serves REST only: ``--api GRPC`` and ``--api BOTH``
stop with an error, because the gRPC server comes with a later slice.
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
from typing import Any, List, Optional

from seldon_core_tpu_torch.runtime.params import (
    PARAMETERS_ENV_NAME,
    SERVICE_PORT_ENV_NAME,
    UNIT_ID_ENV_NAME,
    parse_parameters,
)

logger = logging.getLogger(__name__)

GRPC_LATER = (
    "--api {api}: the PyTorch port serves REST only in this slice; the gRPC "
    "server (proto/services.py) is the next slice of the port. Use --api REST."
)


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
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument(
        "--parameters", default=os.environ.get(PARAMETERS_ENV_NAME, "[]"),
        help="typed parameter list JSON",
    )
    parser.add_argument("--unit-id", default=os.environ.get(UNIT_ID_ENV_NAME, ""))
    parser.add_argument("--log-level", default=os.environ.get("SELDON_LOG_LEVEL", "INFO"))
    args = parser.parse_args(argv)
    if args.api != "REST":
        parser.error(GRPC_LATER.format(api=args.api))
    return args


async def run_servers(
    user_model: Any,
    host: str = "0.0.0.0",
    http_port: int = 9000,
    shutdown_event: Optional[asyncio.Event] = None,
) -> None:
    """Serve REST until `shutdown_event` (or SIGINT/SIGTERM)."""
    from seldon_core_tpu_torch.runtime import rest

    runner = await rest.serve(rest.build_app(user_model), host=host, port=http_port)
    logger.info("REST serving on %s:%d", host, http_port)
    if shutdown_event is None:
        shutdown_event = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, shutdown_event.set)
    try:
        await shutdown_event.wait()
    finally:
        await runner.cleanup()


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(), format="%(asctime)s %(name)s %(levelname)s %(message)s")
    kwargs = parse_parameters(json.loads(args.parameters))
    user_model = import_component(args.component, **kwargs)
    if hasattr(user_model, "load"):
        user_model.load()
    try:
        asyncio.run(run_servers(user_model, host=args.host, http_port=args.http_port))
    finally:
        if hasattr(user_model, "unload"):
            user_model.unload()


if __name__ == "__main__":
    main()
