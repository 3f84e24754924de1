"""Where the request contract's cost goes on the gateway's sync gRPC, on one CUDA card.

    python -m seldon_core_tpu_torch.tools.probe_a4 [--seconds 10] [--rounds 2]

Run from the repository root (it uses ``chip_smoke.py``'s gateway child
and clients).  It starts one gateway child for each variant, all up at
once, each serving ResNet-50 with phase 13's served parameters: none of
the contract (13a's gateway), TLS alone, OAuth alone, tracing (to the
ring) alone, the metrics observer alone, and all four (phase 15's A4
gateway).  Then, round after round with the order reversed every other
round, each variant gets one window of phase 15a: one client's
sequential batch-1 requests for 3 s, then 4 clients' for ``--seconds``.
Every request carries ``x-seldon-deadline-ms`` and a ``traceparent``, and
a bearer token where OAuth is on, so the clients' own work differs only
by TLS.  It prints the card's line first, one JSON line a window, then a
line with each variant's means and their differences from the plain
gateway's.  ``--cpu`` rehearses it on the CPU with ``resnet_tiny`` at
32x32x3.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys
import tempfile

VARIANTS = ((), ("tls",), ("auth",), ("tracing",), ("observer",), ("tls", "auth", "tracing", "observer"))
CPU_PARAMS = [{"name": "model", "value": "resnet_tiny", "type": "STRING"},
              {"name": "num_classes", "value": "10", "type": "INT"},
              {"name": "dtype", "value": "float32", "type": "STRING"},
              {"name": "normalize", "value": "true", "type": "BOOL"},
              {"name": "max_batch_size", "value": "32", "type": "INT"},
              {"name": "input_shape", "value": "[32, 32, 3]", "type": "JSON"},
              {"name": "warmup", "value": "false", "type": "BOOL"},
              {"name": "max_wait_ms", "value": "1.0", "type": "FLOAT"},
              {"name": "device", "value": "cpu", "type": "STRING"}]


def _name(variant) -> str:
    return "+".join(variant) or "plain"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=10.0, help="the 4-client window of each variant")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--cpu", action="store_true", help="rehearse on the CPU (resnet_tiny, 32x32x3)")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import grpc
    import numpy as np

    import chip_smoke as cs
    from seldon_core_tpu_torch.proto import pb, services
    from seldon_core_tpu_torch.runtime import grpc_server

    if args.cpu:
        cs.IMG, params, card = (32, 32, 3), CPU_PARAMS, "CPU rehearsal (not a card number)"
    else:
        import torch

        if not torch.cuda.is_available():
            print("probe_a4: no CUDA card (use --cpu to rehearse)", file=sys.stderr)
            return 1
        card = cs.card_report(torch, grpc)[0]
        params = cs.GRPC_PARAMS
    graph = {"name": "resnet50", "type": "MODEL", "implementation": "CUDA_SERVER", "parameters": params}
    images = cs.distinct_images(np, np.random.default_rng(cs.SEED), 8)
    bodies = [cs.grpc_request(pb, images[i:i + 1]) for i in range(8)]
    with open(os.path.join(cs.TLS_DIR, "ca.crt"), "rb") as f:
        creds = grpc.ssl_channel_credentials(root_certificates=f.read())
    trace_hex, spans = os.urandom(16).hex(), itertools.count(1)

    def lane_for(variant, port: int, token):
        def lane():
            if "tls" in variant:
                channel = grpc.secure_channel(f"localhost:{port}", creds, options=grpc_server.message_size_options())
            else:
                channel = grpc.insecure_channel(f"127.0.0.1:{port}", options=grpc_server.message_size_options())
            predict = services.unary_callable(channel, "Seldon", "Predict")

            def send(req):
                md = [("x-seldon-deadline-ms", cs.A4_DEADLINE_MS),
                      ("traceparent", f"00-{trace_hex}-{next(spans):016x}-01")]
                if token:
                    md.append(("authorization", f"Bearer {token}"))
                resp = predict(req, timeout=120, metadata=md)
                cs.check(resp.status.status == pb.Status.SUCCESS, f"{_name(variant)}: {resp.status}")
                return resp
            return send, channel.close
        return lane

    fd, logpath = tempfile.mkstemp(prefix="probe_a4_", suffix=".log")
    logfile = os.fdopen(fd, "w")
    started = {}
    try:
        for variant in VARIANTS:
            started[variant] = cs.start_gateway("resnet50", graph, logfile, a4=list(variant))
        procs = [proc for proc, _, _ in started.values()]
        lanes = {}
        for variant, (_, base, grpc_port) in started.items():
            cs.wait_gateway(procs, base, logpath)
            lanes[variant] = lane_for(variant, grpc_port, cs.oauth_token(base) if "auth" in variant else None)
        for lane in lanes.values():  # one warm request each before any window
            cs.load_window(lane, bodies, 1, 0.5)
        windows = {variant: [] for variant in VARIANTS}
        for r in range(args.rounds):
            for variant in (VARIANTS if r % 2 == 0 else VARIANTS[::-1]):
                seq, _, _ = cs.load_window(lanes[variant], bodies, 1, cs.GRPC_SEQUENTIAL_SECONDS)
                lat, _, _ = cs.load_window(lanes[variant], bodies, cs.GRPC_LAT_CLIENTS, args.seconds)
                w = {"variant": _name(variant), "round": r, "sequential_p50_ms": cs.pct(seq, 0.5),
                     **cs.window_numbers(np, lat, args.seconds, cs.GRPC_LAT_CLIENTS), "card": card}
                windows[variant].append(w)
                print(json.dumps(w), flush=True)
    finally:
        for proc, _, _ in started.values():
            cs.stop_server(proc)
        logfile.close()
    keys = ("p50_ms", "p99_ms", "qps", "sequential_p50_ms")
    means = {_name(v): {k: statistics.fmean(w[k] for w in ws) for k in keys} for v, ws in windows.items()}
    plain = means["plain"]
    print(json.dumps({"means": means, "minus_plain": {name: {k: m[k] - plain[k] for k in keys}
                                                      for name, m in means.items() if name != "plain"},
                      "rounds": args.rounds, "seconds": args.seconds, "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
