"""``parallel/multihost.py`` over ``torch.distributed``: two gloo
processes of four positions each join one group from the JAX names the
deployments set, and a reduction over the global mesh reads 8.0 (the
JAX package's ``tests/test_dcn.py`` two-process psum)."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from seldon_core_tpu_torch.parallel import multihost

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    """
    import torch
    import torch.distributed as dist
    from seldon_core_tpu_torch.parallel import multihost

    is_multi = multihost.initialize(local_devices=["cpu"] * 4)
    assert is_multi and multihost.initialize(local_devices=["cpu"] * 4)  # idempotent
    info = multihost.host_info()
    assert info["process_count"] == 2 and info["local_devices"] == 4 and info["global_devices"] == 8, info
    mesh = multihost.global_mesh({"data": 8})
    mine = mesh.local_positions()
    assert len(mine) == 4 and all(mesh.process_ids[p] == info["process_index"] for p in mine)
    y = float(multihost.psum({p: torch.tensor(1.0) for p in mine}, mesh))
    assert y == 8.0, y
    print(f"MULTIHOST_OK process={info['process_index']} psum={y}", flush=True)
    dist.destroy_process_group()
    """
)


def test_single_process_joins_nothing(monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize(local_devices=["cpu"] * 2) is False
    info = multihost.host_info()
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 2, "global_devices": 2}
    mesh = multihost.global_mesh({"data": 2})
    assert float(multihost.psum({p: torch.tensor(3.0) for p in mesh.local_positions()}, mesh)) == 6.0


def test_two_process_psum_over_gloo(tmp_path):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({"JAX_COORDINATOR_ADDRESS": coord, "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(pid),
                    "PYTHONPATH": REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")})
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, cwd=REPO_ROOT))
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outputs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert "MULTIHOST_OK" in out and "psum=8.0" in out, out
    assert any("process=0" in o for o in outputs) and any("process=1" in o for o in outputs)


def test_incomplete_coordinates_raise(monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="process count and a process id"):
        multihost.initialize(local_devices=["cpu"])
