"""The PyTorch port stands alone: no JAX, no flax, nothing of the JAX package.

An AST scan of every module of ``seldon_core_tpu_torch`` and of
``chip_smoke.py`` finds no import of ``jax``, ``flax``,
``seldon_core_tpu`` (the ``seldon_core_tpu_torch`` prefix is the port's
own), ``ml_dtypes`` or ``prometheus_client`` (the card's machine may have
neither: the port keeps its own metrics registry), ``msgpack``,
``orbax``, ``tensorstore`` or ``requests`` (the port reads checkpoints
with its own codec and readers and fetches over ``urllib``), and a fresh
interpreter that imports the server and the runtime has none of them in
``sys.modules``.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "seldon_core_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "seldon_core_tpu", "ml_dtypes", "prometheus_client", "msgpack", "orbax",
             "tensorstore", "requests")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN  # "seldon_core_tpu_torch" is its own top-level name


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module"):
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                yield node.lineno, node.args[0].value


SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [f"{path.relative_to(ROOT)}:{line}: {mod}" for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, bad


def test_scan_covers_the_port():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert "seldon_core_tpu_torch/models/cudaserver.py" in names
    assert "seldon_core_tpu_torch/ops/kernels.py" in names
    assert "seldon_core_tpu_torch/models/paged.py" in names
    assert "seldon_core_tpu_torch/models/transformer.py" in names
    assert "seldon_core_tpu_torch/utils/jitwatch.py" in names
    assert "seldon_core_tpu_torch/models/vit.py" in names
    assert "seldon_core_tpu_torch/ops/lora.py" in names
    assert "seldon_core_tpu_torch/models/registry.py" in names
    assert "seldon_core_tpu_torch/models/generate.py" in names
    assert "seldon_core_tpu_torch/models/mlp.py" in names
    assert "seldon_core_tpu_torch/models/detection.py" in names
    assert "seldon_core_tpu_torch/utils/deadlines.py" in names
    assert "seldon_core_tpu_torch/ops/surgery.py" in names
    assert "seldon_core_tpu_torch/ops/w8a8.py" in names
    for module in ("proto/services.py", "runtime/puid.py", "runtime/grpc_server.py", "runtime/openapi.py",
                   "engine/graph.py", "engine/units.py", "engine/transport.py", "engine/executor.py",
                   "engine/service.py", "engine/server.py", "engine/sync_server.py", "components/routers.py",
                   "components/__init__.py", "models/__init__.py", "codec/bufview.py", "codec/tftensor.py",
                   "native/__init__.py", "native/frontserver.py", "engine/native_ingress.py",
                   "utils/tracing.py", "utils/tls.py", "utils/auth.py", "utils/metrics.py",
                   "utils/credentials.py", "utils/storage.py", "utils/serialization.py", "utils/orbax.py",
                   "models/disagg.py", "components/outliers.py", "components/explainers.py",
                   "models/sklearnserver.py", "models/xgboostserver.py", "models/mlflowserver.py",
                   "models/proxyserver.py", "models/torchserver.py", "proto/tfserving_compat_pb2.py",
                   "utils/reqlogger.py", "utils/kafka.py", "utils/reqconsumer.py", "utils/persistence.py",
                   "controlplane/__init__.py", "controlplane/spec.py", "controlplane/defaulting.py",
                   "controlplane/placement.py", "controlplane/templates.py", "controlplane/supervisor.py",
                   "controlplane/autoscaler.py", "controlplane/deployer.py", "controlplane/fleetview.py",
                   "client/client.py", "testing/contract.py", "testing/loadgen.py", "runtime/packager.py",
                   "utils/graphviz.py", "tools/seldon_top.py", "parallel/__init__.py", "parallel/mesh.py",
                   "parallel/sharding.py", "parallel/ring_attention.py", "parallel/multihost.py",
                   "parallel/train.py", "parallel/tp.py", "utils/tf_convert.py"):
        assert f"seldon_core_tpu_torch/{module}" in names, module
    assert _forbidden("seldon_core_tpu.proto") and _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert _forbidden("seldon_core_tpu.native") and _forbidden("ml_dtypes") and _forbidden("prometheus_client")
    assert _forbidden("msgpack") and _forbidden("orbax.checkpoint") and _forbidden("tensorstore")
    assert _forbidden("requests")
    assert not _forbidden("seldon_core_tpu_torch.proto")


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import seldon_core_tpu_torch.models.cudaserver, seldon_core_tpu_torch.runtime.microservice\n"
        "import seldon_core_tpu_torch.runtime.rest, seldon_core_tpu_torch.models.convert\n"
        "import seldon_core_tpu_torch.models.paged, seldon_core_tpu_torch.models.generate\n"
        "import seldon_core_tpu_torch.models.vit, seldon_core_tpu_torch.ops.lora\n"
        "import seldon_core_tpu_torch.models.mlp, seldon_core_tpu_torch.models.detection\n"
        "import seldon_core_tpu_torch.models.registry, seldon_core_tpu_torch.utils.deadlines\n"
        "import seldon_core_tpu_torch.ops.surgery, seldon_core_tpu_torch.ops.w8a8\n"
        "import seldon_core_tpu_torch.engine.server, seldon_core_tpu_torch.engine.sync_server\n"
        "import seldon_core_tpu_torch.runtime.grpc_server, seldon_core_tpu_torch.components.routers\n"
        "import seldon_core_tpu_torch.runtime.openapi, seldon_core_tpu_torch.proto.services\n"
        "import seldon_core_tpu_torch.codec.bufview, seldon_core_tpu_torch.codec.tftensor\n"
        "import seldon_core_tpu_torch.native, seldon_core_tpu_torch.native.frontserver\n"
        "import seldon_core_tpu_torch.engine.native_ingress\n"
        "import seldon_core_tpu_torch.models.disagg, seldon_core_tpu_torch.components.outliers\n"
        "import seldon_core_tpu_torch.components.explainers, seldon_core_tpu_torch.models.proxyserver\n"
        "import seldon_core_tpu_torch.models.xgboostserver, seldon_core_tpu_torch.models.mlflowserver\n"
        "import seldon_core_tpu_torch.models.torchserver, seldon_core_tpu_torch.proto.tfserving_compat_pb2\n"
        "import seldon_core_tpu_torch.utils.reqlogger, seldon_core_tpu_torch.utils.kafka\n"
        "import seldon_core_tpu_torch.utils.reqconsumer, seldon_core_tpu_torch.utils.persistence\n"
        "import seldon_core_tpu_torch.utils.tracing, seldon_core_tpu_torch.utils.tls\n"
        "import seldon_core_tpu_torch.utils.auth, seldon_core_tpu_torch.utils.metrics\n"
        "import seldon_core_tpu_torch.utils.credentials, seldon_core_tpu_torch.utils.storage\n"
        "import seldon_core_tpu_torch.utils.serialization, seldon_core_tpu_torch.utils.orbax\n"
        "import seldon_core_tpu_torch.controlplane, seldon_core_tpu_torch.controlplane.templates\n"
        "import seldon_core_tpu_torch.controlplane.fleetview, seldon_core_tpu_torch.client.client\n"
        "import seldon_core_tpu_torch.testing.contract, seldon_core_tpu_torch.testing.loadgen\n"
        "import seldon_core_tpu_torch.runtime.packager, seldon_core_tpu_torch.utils.graphviz\n"
        "import seldon_core_tpu_torch.tools.seldon_top\n"
        "import seldon_core_tpu_torch.parallel, seldon_core_tpu_torch.parallel.multihost\n"
        "import seldon_core_tpu_torch.parallel.tp, seldon_core_tpu_torch.utils.tf_convert\n"
        "from seldon_core_tpu_torch.engine import units\n"
        "[units._lookup_builtin(name) for name in units.PREPACKAGED]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'seldon_core_tpu',\n"
        "                                                            'ml_dtypes', 'prometheus_client', 'msgpack',\n"
        "                                                            'orbax', 'tensorstore', 'requests'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr[-2000:]
