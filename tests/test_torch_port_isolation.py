"""The PyTorch port stands alone: no JAX, no flax, nothing of the JAX package.

An AST scan of every module of ``seldon_core_tpu_torch`` and of
``chip_smoke.py`` finds no import of ``jax``, ``flax`` or
``seldon_core_tpu`` (the ``seldon_core_tpu_torch`` prefix is the port's
own), and a fresh interpreter that imports the server and the runtime
has no ``jax`` in ``sys.modules``.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "seldon_core_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "seldon_core_tpu")


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
    assert "seldon_core_tpu_torch/models/vit.py" in names
    assert _forbidden("seldon_core_tpu.proto") and _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert not _forbidden("seldon_core_tpu_torch.proto")


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import seldon_core_tpu_torch.models.cudaserver, seldon_core_tpu_torch.runtime.microservice\n"
        "import seldon_core_tpu_torch.runtime.rest, seldon_core_tpu_torch.models.convert\n"
        "import seldon_core_tpu_torch.models.paged, seldon_core_tpu_torch.models.generate\n"
        "import seldon_core_tpu_torch.models.vit\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'seldon_core_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr[-2000:]
