"""User-repo -> runnable-artifact packaging.

Equivalent of the reference's s2i builder images
(reference: wrappers/s2i/python/s2i/bin/{assemble,run},
Dockerfile.tmpl): the user supplies a source directory containing a
component class file (``MyModel.py`` with ``class MyModel``), optional
``requirements.txt``, and an optional ``environment`` file with the
same keys the s2i contract uses (MODEL_NAME, API_TYPE, SERVICE_TYPE,
PERSISTENCE, PARAMETERS).  ``seldon-tpu-torch-package`` then

1. validates the component imports and exposes its declared service
   type's methods (the assemble-time check s2i leaves to runtime),
2. emits a self-contained artifact directory: ``Dockerfile`` (image
   lane) + ``run.sh`` (local lane, same exec line the reference's run
   script uses) + ``artifact.json`` metadata.

No docker daemon is needed to produce the artifact; ``docker build``
of the emitted Dockerfile is the image path, ``run.sh`` is the
local/laptop path.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import shutil
import sys
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

# keep aligned with runtime.microservice.SERVICE_TYPES (asserted in tests):
# every type the microservice serves must be packageable and vice versa
SERVICE_METHODS = {
    "MODEL": ("predict",),
    "ROUTER": ("route",),
    "TRANSFORMER": ("transform_input",),
    "OUTPUT_TRANSFORMER": ("transform_output",),
    "COMBINER": ("aggregate",),
    "OUTLIER_DETECTOR": ("transform_input",),  # dual-use detector as input transformer
}

DOCKERFILE_TEMPLATE = """\
# Generated by seldon-tpu-torch-package (reference analogue:
# wrappers/s2i/python/Dockerfile.tmpl — the s2i builder image contract
# as a plain Dockerfile).
FROM python:3.12-slim

RUN pip install --no-cache-dir seldon-core-tpu
{requirements_layer}
COPY . /microservice
WORKDIR /microservice

ENV MODEL_NAME={model_name} \\
    API_TYPE={api_type} \\
    SERVICE_TYPE={service_type} \\
    PERSISTENCE={persistence}

EXPOSE 9000 5000
CMD exec seldon-tpu-torch-microservice $MODEL_NAME --api $API_TYPE \\
    --service-type $SERVICE_TYPE {persistence_flag} {parameters_flag}
"""

RUN_SH_TEMPLATE = """\
#!/bin/bash -e
# Generated by seldon-tpu-torch-package — local-process lane of the artifact
# (reference analogue: wrappers/s2i/python/s2i/bin/run).
cd "$(dirname "$0")"
export PYTHONPATH="$(pwd):$PYTHONPATH"
# console script when the package is installed, module form otherwise
if command -v seldon-tpu-torch-microservice >/dev/null 2>&1; then
    LAUNCH=(seldon-tpu-torch-microservice)
else
    LAUNCH=("${{PYTHON:-python3}}" -m seldon_core_tpu_torch.runtime.microservice)
fi
exec "${{LAUNCH[@]}}" {model_name} --api {api_type} \\
    --service-type {service_type} {persistence_flag} {parameters_flag} "$@"
"""


def read_environment(src: str) -> Dict[str, str]:
    """Parse the s2i-style ``environment`` file (KEY=VALUE lines)."""
    env: Dict[str, str] = {}
    path = os.path.join(src, "environment")
    if not os.path.exists(path):
        return env
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#") and "=" in line:
                key, _, value = line.partition("=")
                env[key.strip()] = value.strip()
    return env


def validate_component(src: str, model_name: str, service_type: str) -> type:
    """Import ``<model_name>.py`` and check the service-type surface —
    the packaging-time failure s2i users otherwise hit at pod boot."""
    if service_type not in SERVICE_METHODS:
        raise ValueError(
            f"unknown SERVICE_TYPE {service_type!r}; one of {sorted(SERVICE_METHODS)}"
        )
    sys.path.insert(0, src)
    try:
        # evict any same-named module so repeated packaging runs (or a
        # module name shadowing an installed package) import THIS source
        sys.modules.pop(model_name, None)
        importlib.invalidate_caches()
        module = importlib.import_module(model_name)
        cls = getattr(module, model_name, None)
        if cls is None:
            raise ValueError(
                f"{model_name}.py must define a class named {model_name!r} "
                "(the reference s2i contract)"
            )
        methods = SERVICE_METHODS[service_type]
        missing = [
            m for m in methods
            if not callable(getattr(cls, m, None)) and not callable(getattr(cls, f"{m}_raw", None))
        ]
        if missing:
            raise ValueError(
                f"{model_name} lacks {missing} required by SERVICE_TYPE={service_type}"
            )
        return cls
    finally:
        sys.path.remove(src)


def package(
    src: str,
    out: str,
    model_name: Optional[str] = None,
    api_type: Optional[str] = None,
    service_type: Optional[str] = None,
    persistence: Optional[bool] = None,
    parameters_json: Optional[str] = None,
    validate: bool = True,
) -> Dict[str, str]:
    """Build the artifact directory; returns its metadata.

    Precedence is uniform: explicit arguments (CLI flags) win over the
    source dir's ``environment`` file, which wins over defaults.
    """
    src = os.path.abspath(src)
    env = read_environment(src)
    model_name = model_name or env.get("MODEL_NAME", "")
    api_type = (api_type or env.get("API_TYPE", "REST")).upper()
    service_type = (service_type or env.get("SERVICE_TYPE", "MODEL")).upper()
    if persistence is None:
        persistence = env.get("PERSISTENCE", "0").lower() in ("1", "true")
    parameters_json = (
        parameters_json if parameters_json is not None else env.get("PARAMETERS", "")
    )
    if not model_name:
        raise ValueError("MODEL_NAME missing (flag --model-name or environment file)")
    if api_type not in ("REST", "GRPC", "BOTH"):
        raise ValueError(f"API_TYPE must be REST|GRPC|BOTH, got {api_type!r}")
    if validate:
        validate_component(src, model_name, service_type)

    out_abs = os.path.abspath(out)
    if out_abs == src:
        raise ValueError("--out must differ from the source directory")
    os.makedirs(out, exist_ok=True)

    # artifact = user source + generated launchers; the ignore callback
    # excludes exactly the out directory at whatever depth it nests, so
    # sibling user code inside the same ancestor still ships
    def _skip_out(dirpath, names):
        return {
            name
            for name in names
            if os.path.abspath(os.path.join(dirpath, name)) == out_abs
        }

    shutil.copytree(src, out, dirs_exist_ok=True, ignore=_skip_out)

    has_requirements = os.path.exists(os.path.join(src, "requirements.txt"))
    requirements_layer = (
        "COPY requirements.txt /tmp/requirements.txt\n"
        "RUN pip install --no-cache-dir -r /tmp/requirements.txt\n"
        if has_requirements
        else ""
    )
    import shlex

    persistence_flag = "--persistence" if persistence else ""
    # shell-quoted: PARAMETERS is arbitrary JSON (may contain quotes);
    # both generated launchers are shell scripts/CMDs
    parameters_flag = f"--parameters {shlex.quote(parameters_json)}" if parameters_json else ""

    with open(os.path.join(out, "Dockerfile"), "w") as f:
        f.write(
            DOCKERFILE_TEMPLATE.format(
                model_name=model_name,
                api_type=api_type,
                service_type=service_type,
                persistence="1" if persistence else "0",
                requirements_layer=requirements_layer,
                persistence_flag=persistence_flag,
                parameters_flag=parameters_flag,
            )
        )
    run_sh = os.path.join(out, "run.sh")
    with open(run_sh, "w") as f:
        f.write(
            RUN_SH_TEMPLATE.format(
                model_name=model_name,
                api_type=api_type,
                service_type=service_type,
                persistence_flag=persistence_flag,
                parameters_flag=parameters_flag,
            )
        )
    os.chmod(run_sh, 0o755)

    meta = {
        "model_name": model_name,
        "api_type": api_type,
        "service_type": service_type,
        "persistence": str(persistence),
        "validated": str(validate),
    }
    with open(os.path.join(out, "artifact.json"), "w") as f:
        json.dump(meta, f, indent=2)
    logger.info("artifact written to %s (model=%s)", out, model_name)
    return meta


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="seldon-tpu-torch-package", description="seldon-core-tpu component packager (PyTorch port)")
    parser.add_argument("src", help="user component source directory")
    parser.add_argument("--out", required=True, help="artifact output directory")
    parser.add_argument("--model-name", default=None)
    # None defaults = "not given": the environment file fills these in
    parser.add_argument("--api", default=None, choices=("REST", "GRPC", "BOTH"))
    parser.add_argument("--service-type", default=None, choices=sorted(SERVICE_METHODS))
    parser.add_argument("--persistence", action="store_const", const=True, default=None)
    parser.add_argument("--parameters", default=None)
    parser.add_argument("--no-validate", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level="INFO")
    meta = package(
        args.src,
        args.out,
        model_name=args.model_name,
        api_type=args.api,
        service_type=args.service_type,
        persistence=args.persistence,
        parameters_json=args.parameters,
        validate=not args.no_validate,
    )
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
