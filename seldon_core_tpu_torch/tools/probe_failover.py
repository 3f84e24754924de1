"""Where the time of one failover goes: a replica killed under a GrpcClient.

    python -m seldon_core_tpu_torch.tools.probe_failover [--cpu]

Serves ResNet-50 (``chip_smoke.py``'s 13a parameters; ``--cpu``:
ResNetTiny on the CPU) from the microservice CLI (``--api BOTH``) and
drives it from this process with the engine's ``GrpcClient`` (3
attempts, no breaker), the client a gateway node uses.  Then:

1. 4 callers in a loop; SIGKILL of the replica's process group half-way:
   the kill's return, ``waitpid``'s, the first refused TCP connect, and
   each caller's failed call with its per-attempt status and elapsed time
   (``MicroserviceError.attempts``);
2. one call after the replica is gone: its attempts;
3. the replica restarted on the same ports: its first request from a
   new synchronous channel of this process (the server's first-request
   cost), then the first call on the engine's client (a new ``grpc.aio``
   channel: its channel was dropped after UNAVAILABLE), a call on a new
   channel to the now warm server, and the steady state.

Prints one JSON object as its last line, with the card's name and power
limit from ``nvidia-smi`` (a CPU run names no device numbers).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np

from seldon_core_tpu_torch.engine.graph import Endpoint, UnitSpec
from seldon_core_tpu_torch.engine.transport import GrpcClient
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.message import InternalMessage

CUDA_PARAMS = [{"name": "model", "value": "resnet50", "type": "STRING"},
               {"name": "normalize", "value": "true", "type": "BOOL"},
               {"name": "dtype", "value": "bfloat16", "type": "STRING"},
               {"name": "max_batch_size", "value": "32", "type": "INT"},
               {"name": "max_wait_ms", "value": "1.0", "type": "FLOAT"}]
CPU_PARAMS = [{"name": "model", "value": "resnet_tiny", "type": "STRING"},
              {"name": "normalize", "value": "true", "type": "BOOL"},
              {"name": "dtype", "value": "float32", "type": "STRING"},
              {"name": "num_classes", "value": "10", "type": "INT"},
              {"name": "input_shape", "value": "[32, 32, 3]", "type": "JSON"},
              {"name": "max_wait_ms", "value": "1.0", "type": "FLOAT"},
              {"name": "device", "value": "cpu", "type": "STRING"}]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(params, http_port: int, grpc_port: int, log):
    return subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
         "seldon_core_tpu_torch.models.cudaserver.CudaServer", "--api", "BOTH", "--host", "127.0.0.1",
         "--http-port", str(http_port), "--grpc-port", str(grpc_port), "--parameters", json.dumps(params)],
        stdout=log, stderr=subprocess.STDOUT, start_new_session=True)


def wait_ready(proc, http_port: int, timeout_s: float = 600.0) -> float:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if proc.poll() is not None:
            raise RuntimeError(f"the replica exited with {proc.returncode}")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{http_port}/health/status", timeout=5) as r:
                if json.loads(r.read()).get("jsonData", {}).get("loaded"):
                    return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.2)
    raise RuntimeError("the replica never became ready")


def refused_at(port: int, t0: float, limit_s: float = 30.0) -> float:
    """Seconds from t0 until a TCP connect to the port is refused."""
    while time.perf_counter() - t0 < limit_s:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=0.05):
                pass
        except ConnectionRefusedError:
            return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.002)
    return float("nan")


async def call(client, image) -> dict:
    t = time.perf_counter()
    try:
        await client.transform_input(InternalMessage(payload=image, kind="rawTensor"))
        return {"ok": True, "ms": (time.perf_counter() - t) * 1e3}
    except MicroserviceError as e:
        return {"ok": False, "ms": (time.perf_counter() - t) * 1e3, "reason": e.reason,
                "attempts": getattr(e, "attempts", None), "error": e.message[:400]}


def sync_call(grpc_port: int, image) -> float:
    """ms of one Model/Predict on a new synchronous channel."""
    import grpc

    from seldon_core_tpu_torch.proto import pb, services
    from seldon_core_tpu_torch.runtime.grpc_server import message_size_options

    req = pb.SeldonMessage()
    req.data.rawTensor.dtype = "uint8"
    req.data.rawTensor.shape.extend(image.shape)
    req.data.rawTensor.data = image.tobytes()
    with grpc.insecure_channel(f"127.0.0.1:{grpc_port}", options=message_size_options()) as channel:
        predict = services.unary_callable(channel, "Model", "Predict")
        t = time.perf_counter()
        predict(req, timeout=60)
        return (time.perf_counter() - t) * 1e3


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except OSError:
        return "no nvidia-smi (CPU run: no device numbers)"


async def probe(params, shape, log) -> dict:
    http_port, grpc_port = free_port(), free_port()
    unit = UnitSpec(name="replica", type="MODEL", endpoint=Endpoint("127.0.0.1", grpc_port, "GRPC"))
    image = np.random.default_rng(0).integers(0, 256, (1, int(np.prod(shape)))).astype(np.uint8)
    proc = start(params, http_port, grpc_port, log)
    out = {"ready_s": wait_ready(proc, http_port)}
    client = GrpcClient(unit, deadline_s=5.0, retries=3, breaker=False)
    try:
        warm = [await call(client, image) for _ in range(30)]
        out["steady_p50_ms"] = statistics.median(r["ms"] for r in warm[10:])
        # (1) SIGKILL under 4 looping callers
        stop, results = asyncio.Event(), []

        async def caller():
            while not stop.is_set():
                r = await call(client, image)
                r["t"] = time.perf_counter()
                results.append(r)
                if not r["ok"]:
                    return

        tasks = [asyncio.ensure_future(caller()) for _ in range(4)]
        await asyncio.sleep(1.0)
        t_kill = time.perf_counter()
        os.killpg(proc.pid, signal.SIGKILL)
        out["kill_returned_s"] = time.perf_counter() - t_kill
        loop = asyncio.get_running_loop()
        waited = loop.run_in_executor(None, proc.wait)
        out["refused_after_kill_s"] = await loop.run_in_executor(None, refused_at, grpc_port, t_kill)
        await waited
        out["exited_after_kill_s"] = time.perf_counter() - t_kill  # upper bound: read after the refusal
        await asyncio.wait_for(asyncio.gather(*tasks), 60)
        stop.set()
        out["in_flight_at_kill"] = [r for r in results if not r["ok"]]
        # (2) one call with the replica gone
        out["after_exit"] = await call(client, image)
        # (3) restart on the same ports
        proc = start(params, http_port, grpc_port, log)
        out["restart_ready_s"] = wait_ready(proc, http_port)
        loop = asyncio.get_running_loop()
        out["first_direct_sync_ms"] = await loop.run_in_executor(None, sync_call, grpc_port, image)
        out["second_direct_sync_ms"] = await loop.run_in_executor(None, sync_call, grpc_port, image)
        out["first_on_engine_client"] = await call(client, image)
        await client.close()  # drops the endpoint's channel: the next call dials a new one
        out["first_on_new_channel_warm_server"] = await call(client, image)
        out["then_ms"] = [round((await call(client, image))["ms"], 3) for _ in range(5)]
    finally:
        await client.close()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGTERM)
            proc.wait(timeout=60)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="ResNetTiny on the CPU (a rehearsal)")
    args = parser.parse_args(argv)
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            print("probe_failover: no CUDA card (use --cpu to rehearse)", file=sys.stderr)
            return 1
    params, shape = (CPU_PARAMS, (32, 32, 3)) if args.cpu else (CUDA_PARAMS, (224, 224, 3))
    with open(os.devnull, "wb") as log:
        out = asyncio.run(probe(params, shape, log))
    out["card"] = card() if not args.cpu else "cpu rehearsal"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
