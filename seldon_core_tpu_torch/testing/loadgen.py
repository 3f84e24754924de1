"""Load generator — the locust-equivalent harness.

(reference: util/loadtester/scripts/predict_rest_locust.py,
predict_grpc_locust.py): closed-loop concurrent workers firing a
request callable for a fixed duration, reporting rate + latency
percentiles.  Used by bench.py and usable standalone against any
gateway.
"""

from __future__ import annotations

import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class LoadResult:
    duration_s: float
    requests: int
    errors: int
    latencies_ms: List[float] = field(repr=False, default_factory=list)

    @property
    def qps(self) -> float:
        return self.requests / self.duration_s if self.duration_s else 0.0

    def percentile(self, q: float) -> float:
        if not self.latencies_ms:
            return float("nan")
        idx = min(len(self.latencies_ms) - 1, int(len(self.latencies_ms) * q))
        return sorted(self.latencies_ms)[idx]

    def summary(self) -> Dict[str, Any]:
        lat = sorted(self.latencies_ms)
        return {
            "qps": round(self.qps, 1),
            "requests": self.requests,
            "errors": self.errors,
            "p50_ms": round(statistics.median(lat), 3) if lat else None,
            "p90_ms": round(self.percentile(0.90), 3) if lat else None,
            "p99_ms": round(self.percentile(0.99), 3) if lat else None,
            "mean_ms": round(statistics.fmean(lat), 3) if lat else None,
        }


def run_load(
    request_fn: Callable[[], bool],
    duration_s: float = 10.0,
    concurrency: int = 16,
    warmup_s: float = 0.0,
) -> LoadResult:
    """Closed-loop load: `concurrency` workers call `request_fn`
    (returns success) until the deadline."""
    if warmup_s > 0:
        stop_warm = time.perf_counter() + warmup_s
        while time.perf_counter() < stop_warm:
            request_fn()

    latencies: List[float] = []
    errors = [0]
    lock = threading.Lock()
    stop_at = time.perf_counter() + duration_s

    def worker():
        mine: List[float] = []
        my_errors = 0
        while time.perf_counter() < stop_at:
            t0 = time.perf_counter()
            try:
                ok = request_fn()
            except Exception:  # noqa: BLE001 — load generator counts any
                # request failure as an error sample
                ok = False
            if ok:
                mine.append((time.perf_counter() - t0) * 1000.0)
            else:
                my_errors += 1
        with lock:
            latencies.extend(mine)
            errors[0] += my_errors

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return LoadResult(duration_s=duration_s, requests=len(latencies), errors=errors[0], latencies_ms=latencies)


# ---------------------------------------------------------------------------
# standalone CLI (the reference's locust scripts as one command)
# ---------------------------------------------------------------------------


def build_http_blob(path: str, body: bytes, content_type: str, host: str = "load") -> bytes:
    """A complete HTTP/1.1 keep-alive request as one byte-blob (what the
    native epoll client replays)."""
    head = (
        f"POST {path} HTTP/1.1\r\nHost: {host}\r\n"
        f"Content-Type: {content_type}\r\n"
        f"Content-Length: {len(body)}\r\n\r\n"
    ).encode()
    return head + body


def native_http_load(
    port: int,
    path: str,
    body: bytes,
    content_type: str = "application/json",
    seconds: float = 10.0,
    connections: int = 8,
    depth: int = 16,
) -> Optional[Dict[str, Any]]:
    """Drive a loopback HTTP endpoint from the C++ epoll client
    (``native/loadgen.cc``) — maximum-throughput mode, where the client
    must not throttle the server.  Returns ``{qps, ok, non2xx, errors}``
    or None when the native library is unavailable."""
    from seldon_core_tpu_torch.native.frontserver import native_load

    return native_load(
        port, build_http_blob(path, body, content_type),
        seconds=seconds, connections=connections, depth=depth,
    )


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: seldon-tpu-torch-load HOST PORT [--shape 1,4 | --body-file f.json]

    Two lanes, mirroring how the reference splits Locust workers from
    the benched service:

    * default — Python closed-loop workers (latency percentiles, any
      host);
    * ``--native`` — the C++ epoll client (throughput-first, loopback
      only, needs the native library).
    """
    import argparse
    import json as _json

    import numpy as np

    parser = argparse.ArgumentParser(prog="seldon-tpu-torch-load", description="seldon-core-tpu load generator (PyTorch port)")
    parser.add_argument("host", nargs="?", default="127.0.0.1")
    parser.add_argument("port", type=int)
    parser.add_argument("--path", default="/api/v0.1/predictions")
    parser.add_argument("--shape", default="1,4",
                        help="random ndarray payload shape, e.g. 1,4 or 1,224,224,3")
    parser.add_argument("--body-file", default="",
                        help="send this file's bytes instead of a generated payload")
    parser.add_argument("--content-type", default="application/json")
    parser.add_argument("--duration", type=float, default=10.0)
    parser.add_argument("--concurrency", type=int, default=16)
    parser.add_argument("--native", action="store_true",
                        help="C++ epoll client (loopback only, max throughput)")
    parser.add_argument("--connections", type=int, default=8)
    parser.add_argument("--depth", type=int, default=16)
    args = parser.parse_args(argv)

    if args.body_file:
        with open(args.body_file, "rb") as f:
            body = f.read()
    else:
        shape = tuple(int(d) for d in args.shape.split(","))
        rng = np.random.default_rng(0)
        body = _json.dumps(
            {"data": {"ndarray": rng.random(shape).round(4).tolist()}}
        ).encode()

    if args.native:
        if args.host not in ("127.0.0.1", "localhost"):
            print(_json.dumps({"error": "--native drives loopback only"}))
            return 2
        out = native_http_load(
            args.port, args.path, body, content_type=args.content_type,
            seconds=args.duration, connections=args.connections, depth=args.depth,
        )
        if out is None:
            print(_json.dumps({"error": "native library unavailable"}))
            return 2
        print(_json.dumps(out))
        return 0 if out["errors"] == 0 and out["non2xx"] == 0 else 1

    import http.client

    # per-worker keep-alive connections: a fresh TCP handshake per request
    # would bill connect time to the server's latency numbers
    local = threading.local()

    def one() -> bool:
        conn = getattr(local, "conn", None)
        if conn is None:
            conn = local.conn = http.client.HTTPConnection(args.host, args.port, timeout=30)
        try:
            conn.request("POST", args.path, body=body, headers={"Content-Type": args.content_type})
            resp = conn.getresponse()
            resp.read()
        except Exception:
            conn.close()  # the next request dials afresh
            raise
        return 200 <= resp.status < 300

    result = run_load(one, duration_s=args.duration, concurrency=args.concurrency)
    print(_json.dumps(result.summary()))
    return 0 if result.errors == 0 else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
