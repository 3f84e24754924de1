#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``seldon_core_tpu_torch``) only, and imports nothing of
JAX or of the JAX package.  Phases, each of which fails the run:

1. card report (``nvidia-smi`` name and power limit);
2. build every CUDA kernel of the main path from ``ops/csrc``;
3. each kernel against its plain PyTorch version on the card, bit for
   bit, at the main path's shapes and at ragged ones; kernel, plain and
   library-call times (CUDA events, median of 100, L2 flushed before
   each launch) beside the bound (bytes moved over the card's memory
   rate);
4. the main path: the microservice CLI serving ResNet-50 (224x224x3,
   1000 classes, bf16, normalize=true, max_batch_size=32, seeded random
   weights with live residual branches) over REST as a subprocess; uint8
   ``rawTensor`` requests (a batch of 8 and 8 concurrent single images)
   must give 1000 finite logits per row, and every row must agree with an
   in-process model of the same weights; ``/metrics`` must show batching;
   the server's kernel launch counts, taken just before and just after
   the traffic, must show every kernel launched;
5. whole-path numerics in-process: bf16 with the kernels against f32
   with the plain versions (TF32 off), relative L2 error <= 5e-2 and
   per-row cosine similarity >= 0.99;
6. numbers: p50/p99 latency of 1000 sequential single-image requests,
   img/s of batch-32 requests from 4 clients over a 10 s window, device
   forward time, and a profiler breakdown.

Output: the ``nvidia-smi`` line, then one ``{"kernels": [...]}`` line,
then the last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when CUDA is unavailable or the port is not beside
this script.
"""

from __future__ import annotations

import base64
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL_PARAMS = [
    {"name": "model", "value": "resnet50", "type": "STRING"},
    {"name": "normalize", "value": "true", "type": "BOOL"},
    {"name": "dtype", "value": "bfloat16", "type": "STRING"},
    {"name": "max_batch_size", "value": "32", "type": "INT"},
]
IMG = (224, 224, 3)
NUM_CLASSES = 1000
SEED = 0
LATENCY_REQUESTS = 1000         # p99 rests on the 10 slowest
THROUGHPUT_CLIENTS = 4
THROUGHPUT_SECONDS = 10.0
# tolerances, stated before any run
SERVED_VS_LOCAL_REL_L2 = 2e-2   # each bf16 served row vs in-process bf16, same weights
CROSS_ROW_MIN_REL_L2 = 2 * SERVED_VS_LOCAL_REL_L2  # two images' answers must differ by more
WHOLE_PATH_REL_L2 = 5e-2        # bf16 + kernel vs f32 + plain, same weights
WHOLE_PATH_MIN_COS = 0.99


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- phase 1

def card_report(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    # HBM is double data rate: bytes/s = 2 * clock * bus width / 8
    mem_bytes_per_s = 2.0 * props.memory_clock_rate * 1e3 * props.memory_bus_width / 8
    log(f"card: {smi_line} | torch: {name} | {props.multi_processor_count} SMs | "
        f"memory {mem_bytes_per_s / 1e12:.3f} TB/s (clock {props.memory_clock_rate} kHz, "
        f"bus {props.memory_bus_width} bit) | torch {torch.__version__} cuda {torch.version.cuda}")
    return smi_line, name, mem_bytes_per_s


# ---------------------------------------------------------------- timing

def time_cuda(torch, fn, reps: int = 100, warm: int = 5) -> float:
    """Median ms of one call, CUDA events around each, L2 flushed before
    each (a 256 MB write keeps the GPU busy while the host enqueues, so
    host overhead stays out of the measured span)."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


# ---------------------------------------------------------------- phase 3

def kernel_checks(torch, np, kernels, mem_bytes_per_s):
    shapes = [(32, *IMG), (1, *IMG), (3, 5, 7, 1), (2, 9, 11, 4)]
    dtypes = [torch.bfloat16, torch.float16, torch.float32]
    bits = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}
    rng = np.random.default_rng(SEED)
    max_err = 0.0
    inputs = {}
    for shape in shapes:
        c = shape[-1]
        if c == 3:
            scale, shift = kernels.imagenet_affine()
        else:
            scale = rng.uniform(0.001, 0.05, c).astype(np.float32)
            shift = rng.uniform(-2.0, 1.0, c).astype(np.float32)
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
        s, b = torch.from_numpy(scale).cuda(), torch.from_numpy(shift).cuda()
        inputs[shape] = (x, s, b)
        for dt in dtypes:
            got = kernels.fused_normalize(x, s, b, dt)
            ref = kernels.fused_normalize_reference(x, s, b, dt)
            torch.cuda.synchronize()
            check(got.shape == x.shape and got.dtype == dt and got.is_contiguous(),
                  f"fused_normalize {shape} {dt}: bad output {tuple(got.shape)} {got.dtype}")
            same = torch.equal(got.view(bits[dt]), ref.view(bits[dt]))
            err = (got.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            log(f"fused_normalize {shape} -> {str(dt)[6:]}: bit-identical={same} max_abs_err={err}")
            check(same, f"fused_normalize {shape} {dt} differs from its plain version (max {err})")

    timings = {}
    for batch in (32, 1):
        x, s, b = inputs[(batch, *IMG)]
        lib_out = torch.empty(x.shape, dtype=torch.bfloat16, device="cuda")

        def library():
            # one PyTorch call for the same function: shift + x * scale,
            # u8 promoted to f32, cast to bf16 on store
            torch.addcmul(b, x, s, out=lib_out)

        library()
        lib_err = (lib_out.float() - kernels.fused_normalize_reference(x, s, b, torch.bfloat16).float()
                   ).abs().max().item()
        ms = time_cuda(torch, lambda: kernels.fused_normalize(x, s, b, torch.bfloat16))
        plain_ms = time_cuda(torch, lambda: kernels.fused_normalize_reference(x, s, b, torch.bfloat16))
        library_ms = time_cuda(torch, library)
        n = x.numel()
        bound_bytes = n * (1 + 2) + 2 * s.numel() * 4  # u8 in, bf16 out, scale+shift
        # 2 f32 flops per element; 67 TFLOP/s f32 (non-tensor-core) peak
        bound_ms = max(bound_bytes / mem_bytes_per_s, 2 * n / 67e12) * 1e3
        timings[batch] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                          "bound_ms": bound_ms, "bytes": bound_bytes}
        log(f"fused_normalize ({batch},224,224,3) u8->bf16: kernel {ms * 1e3:.2f} us, "
            f"plain chain {plain_ms * 1e3:.2f} us, torch.addcmul(out=bf16) {library_ms * 1e3:.2f} us "
            f"(max abs diff from the plain version {lib_err}), bound {bound_ms * 1e3:.2f} us "
            f"({bound_bytes} bytes; {bound_ms / ms * 100:.1f}% of the memory roofline)")
    return max_err, timings


# ---------------------------------------------------------------- phase 4 + 6

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(url: str, body=None, timeout: float = 120.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
    return raw if url.endswith("/metrics") else json.loads(raw)


def raw_request(np, images):
    return {"data": {"rawTensor": {
        "shape": list(images.shape), "dtype": "uint8",
        "data": base64.b64encode(np.ascontiguousarray(images).tobytes()).decode("ascii"),
    }}}


def decode_logits(np, resp, rows: int):
    check("data" in resp and "rawTensor" in resp["data"], f"response carries no rawTensor: {str(resp)[:300]}")
    r = resp["data"]["rawTensor"]
    arr = np.frombuffer(base64.b64decode(r["data"]), dtype=np.dtype(r["dtype"])).reshape(r["shape"])
    check(arr.shape == (rows, NUM_CLASSES), f"expected ({rows}, {NUM_CLASSES}) logits, got {arr.shape}")
    check(bool(np.isfinite(arr).all()), "non-finite logits in a served answer")
    return arr


def metrics_values(text: bytes):
    out = {}
    for line in text.decode().splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            out[key] = float(val)
    return out


def start_server(port: int, logfile):
    cmd = [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
           "seldon_core_tpu_torch.models.cudaserver.CudaServer", "--api", "REST",
           "--host", "127.0.0.1", "--http-port", str(port), "--parameters", json.dumps(MODEL_PARAMS)]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=logfile, stderr=subprocess.STDOUT,
                            start_new_session=True)


def wait_ready(proc, base: str, logpath: str, timeout_s: float = 600.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if proc.poll() is not None:
            raise SmokeFailure(f"server exited with {proc.returncode}:\n{tail(logpath)}")
        try:
            status = http(base + "/health/status", timeout=5)
            if status.get("jsonData", {}).get("loaded"):
                return status["jsonData"], time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        time.sleep(1.0)
    raise SmokeFailure(f"server not ready after {timeout_s}s:\n{tail(logpath)}")


def tail(path: str, n: int = 40) -> str:
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-n:])


def stop_server(proc) -> None:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)


def pct(values, q: float) -> float:
    import math

    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def distinct_images(np, rng, n: int):
    """uint8 images that differ in per-channel level as well as in noise,
    so a random-weight model gives each a clearly different answer and a
    row served to the wrong request cannot pass the per-row check."""
    level = rng.integers(0, 160, (n, 1, 1, IMG[-1]))
    noise = rng.integers(0, 96, (n, *IMG))
    return (level + noise).astype(np.uint8)


def rel_l2(np, a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def concurrent(fn, n: int):
    """Run fn(i) for i < n on n threads at once; returns the results in
    order and re-raises the first failure."""
    results, errors = [None] * n, []

    def run(i):
        try:
            results[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — re-raised below, on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def served_rows_check(torch, np, kernels, resnet, base, rng):
    """A batch of 8 and 8 concurrent single images, every served row held
    against an in-process model with the server's weights."""
    eight = distinct_images(np, rng, 8)
    served_eight = decode_logits(np, http(base + "/predict", raw_request(np, eight)), 8)
    singles = distinct_images(np, rng, 8)
    answers = concurrent(lambda i: http(base + "/predict", raw_request(np, singles[i:i + 1])), 8)
    served_singles = np.concatenate([decode_logits(np, a, 1) for a in answers])

    # the server's weights in-process: the same seeded init, residual branches live
    local = resnet.ResNet50(num_classes=NUM_CLASSES, dtype=torch.bfloat16)
    local.reset_parameters(torch.Generator().manual_seed(SEED), zero_init_residual=False)
    local = local.cuda().eval().to(memory_format=torch.channels_last)
    scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())
    errs, cross = [], []
    for images, served in ((eight, served_eight), (singles, served_singles)):
        with torch.inference_mode():
            x = kernels.fused_normalize(torch.from_numpy(images).cuda(), scale, shift, torch.bfloat16)
            ref = local(x).double().cpu().numpy()
        errs += [rel_l2(np, served[i], ref[i]) for i in range(len(ref))]
        cross += [rel_l2(np, ref[i], ref[j]) for i in range(len(ref)) for j in range(len(ref)) if i != j]
    log(f"served vs in-process bf16, {len(errs)} rows (batch of 8 + 8 concurrent singles): max row rel L2 "
        f"{max(errs):.3e} (limit {SERVED_VS_LOCAL_REL_L2}); least rel L2 between two images' answers "
        f"{min(cross):.3e} (must exceed {CROSS_ROW_MIN_REL_L2})")
    check(min(cross) > CROSS_ROW_MIN_REL_L2,
          f"the test images' answers are too alike to tell a row mix-up apart: {min(cross)}")
    check(max(errs) <= SERVED_VS_LOCAL_REL_L2, f"served rows disagree with the in-process model: {errs}")
    return max(errs)


def latency_window(np, base, rng, n: int):
    """REST latency of n sequential single-image requests, in ms."""
    bodies = [raw_request(np, rng.integers(0, 256, (1, *IMG), dtype=np.uint8)) for _ in range(16)]
    for body in bodies:  # warm the client and server sides
        decode_logits(np, http(base + "/predict", body), 1)
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        decode_logits(np, http(base + "/predict", bodies[i % len(bodies)]), 1)
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def throughput_window(np, base, rng, clients: int, seconds: float):
    """img/s of batch-32 requests from `clients` closed-loop clients that
    send until `seconds` have passed; the in-flight requests finish and
    count, and the wall clock runs until the last one returns."""
    bodies = [raw_request(np, rng.integers(0, 256, (32, *IMG), dtype=np.uint8)) for _ in range(clients)]
    decode_logits(np, http(base + "/predict", bodies[0]), 32)  # warm the client side
    t0 = time.perf_counter()

    def client(k):
        n = 0
        while time.perf_counter() - t0 < seconds:
            decode_logits(np, http(base + "/predict", bodies[k]), 32)
            n += 1
        return n

    requests = sum(concurrent(client, clients))
    wall = time.perf_counter() - t0
    return requests * 32 / wall, requests, wall


def main_path(torch, np, kernels, resnet, card):
    rng = np.random.default_rng(SEED + 1)
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    fd, logpath = tempfile.mkstemp(prefix="chip_smoke_server_", suffix=".log")
    logfile = os.fdopen(fd, "w")
    proc = start_server(port, logfile)
    try:
        status, ready_s = wait_ready(proc, base, logpath)
        log(f"server ready in {ready_s:.1f}s (load {status['load_time_s']:.1f}s, buckets {status['buckets']}, "
            f"device {status['device_name']})")
        check(status["device"].startswith("cuda"), f"server is not on the card: {status['device']}")
        m0 = metrics_values(http(base + "/metrics"))
        before = status["kernel_launches"]

        served_err = served_rows_check(torch, np, kernels, resnet, base, rng)
        lat = latency_window(np, base, rng, LATENCY_REQUESTS)
        img_s, b32_requests, b32_wall = throughput_window(np, base, rng, THROUGHPUT_CLIENTS, THROUGHPUT_SECONDS)

        after = http(base + "/health/status")["jsonData"]["kernel_launches"]
        m1 = metrics_values(http(base + "/metrics"))
    finally:
        stop_server(proc)
        logfile.close()
    launches = {k: after[k] - before.get(k, 0) for k in after}
    batches = m1["cudaserver_batches_total"] - m0["cudaserver_batches_total"]
    log(f"main path: {int(batches)} batches, mean rows/batch {m1['cudaserver_mean_batch_rows']:.2f}, "
        f"kernel launches {launches}")
    check(batches > 0 and m1["cudaserver_mean_batch_rows"] > 1.0, f"/metrics shows no batching: {m1}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    numbers = {
        "batches": batches, "launches_per_batch": {k: n / batches for k, n in launches.items()},
        "served_max_row_rel_l2": served_err,
        "p50_ms": pct(lat, 0.50), "p99_ms": pct(lat, 0.99), "n_latency": len(lat),
        "batch32_img_s": img_s, "batch32_requests": b32_requests, "batch32_wall_s": b32_wall,
        "clients": THROUGHPUT_CLIENTS,
    }
    log(f"REST single-image latency over {len(lat)} sequential requests: p50 {numbers['p50_ms']:.2f} ms, "
        f"p99 {numbers['p99_ms']:.2f} ms; batch-32 throughput ({THROUGHPUT_CLIENTS} clients, "
        f"{b32_requests} requests in {b32_wall:.2f} s): {img_s:.1f} img/s [{card}]")
    return launches, numbers


# ---------------------------------------------------------------- phase 5 + 6

def whole_path(torch, np, kernels, resnet, card):
    rng = np.random.default_rng(SEED + 2)
    images = torch.from_numpy(rng.integers(0, 256, (8, *IMG), dtype=np.uint8)).cuda()
    scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())

    def build(dtype):
        m = resnet.ResNet50(num_classes=NUM_CLASSES, dtype=dtype)
        # every residual branch live (no zero-initialised BatchNorm scale)
        m.reset_parameters(torch.Generator().manual_seed(SEED + 3), zero_init_residual=False)
        return m.cuda().eval().to(memory_format=torch.channels_last)

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.inference_mode():
            ref = build(torch.float32)(
                kernels.fused_normalize_reference(images, scale, shift, torch.float32)).double().cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    model = build(torch.bfloat16)
    with torch.inference_mode():
        got = model(kernels.fused_normalize(images, scale, shift, torch.bfloat16)).double().cpu()
    check(bool(torch.isfinite(got).all()) and got.shape == (8, NUM_CLASSES), "bad bf16 whole-path logits")
    rel = float((got - ref).norm() / ref.norm())
    cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=-1).min())
    log(f"whole path bf16+kernel vs f32+plain (TF32 off), ResNet-50 batch 8: rel L2 {rel:.3e} "
        f"(limit {WHOLE_PATH_REL_L2}), min row cosine {cos:.6f} (limit {WHOLE_PATH_MIN_COS})")
    check(rel <= WHOLE_PATH_REL_L2 and cos >= WHOLE_PATH_MIN_COS, "whole-path numerics out of tolerance")

    # device time of the served program (normalize + ResNet-50), in-process
    fwd = {}
    for batch in (1, 32):
        x = torch.from_numpy(rng.integers(0, 256, (batch, *IMG), dtype=np.uint8)).cuda()

        def step():
            with torch.inference_mode():
                model(kernels.fused_normalize(x, scale, shift, torch.bfloat16))

        fwd[batch] = time_cuda(torch, step, reps=30, warm=5)
        log(f"device forward (normalize + ResNet-50 bf16) batch {batch}: {fwd[batch]:.3f} ms "
            f"= {batch / fwd[batch] * 1e3:.1f} img/s [{card}]")

    x = torch.from_numpy(rng.integers(0, 256, (32, *IMG), dtype=np.uint8)).cuda()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with torch.inference_mode():
                model(kernels.fused_normalize(x, scale, shift, torch.bfloat16))
        torch.cuda.synchronize()
    log("profile, 3 forwards at batch 32, top device time:")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12, max_name_column_width=60))
    return {"rel_l2": rel, "min_cos": cos, "forward_ms": fwd}


# ---------------------------------------------------------------- main

def run() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false; this smoke test needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import numpy as np

        from seldon_core_tpu_torch.models import resnet
        from seldon_core_tpu_torch.ops import _build, kernels
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port is not beside this script ({e})", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    try:
        smi_line, name, mem_bytes_per_s = card_report(torch)
        card = smi_line
        t0 = time.perf_counter()
        lib = _build.build("fused_normalize")
        _build.load("fused_normalize")
        log(f"built {lib.name} in {time.perf_counter() - t0:.1f}s")
        max_err, timings = kernel_checks(torch, np, kernels, mem_bytes_per_s)
        launches, numbers = main_path(torch, np, kernels, resnet, card)
        whole = whole_path(torch, np, kernels, resnet, card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    t32, t1 = timings[32], timings[1]
    result = {
        "numbers": numbers,
        "whole_path": {"rel_l2": whole["rel_l2"], "min_cos": whole["min_cos"],
                       "forward_ms_b1": whole["forward_ms"][1], "forward_ms_b32": whole["forward_ms"][32]},
        "seconds": time.perf_counter() - t_start,
    }
    log(json.dumps(result))
    kernel_line = {"kernels": [{
        "name": "fused_normalize",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/ops/csrc/fused_normalize.cu",
        "replaces": "seldon_core_tpu/ops/kernels.py:46",
        "launches": launches["fused_normalize"],
        "max_abs_err": max_err,
        "ms": t32["ms"], "plain_ms": t32["plain_ms"], "bound_ms": t32["bound_ms"],
        "bound_by": "bytes", "library_ms": t32["library_ms"], "library_call": "torch.addcmul(out=bf16)",
        "shape": [32, *IMG], "out_dtype": "bfloat16",
        "batch1": {"ms": t1["ms"], "plain_ms": t1["plain_ms"], "library_ms": t1["library_ms"],
                   "bound_ms": t1["bound_ms"]},
    }]}
    print(smi_line)
    print(json.dumps(kernel_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
