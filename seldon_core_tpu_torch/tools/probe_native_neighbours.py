"""Phase 14's native-ingress windows with and without phase 27's processes.

    python -m seldon_core_tpu_torch.tools.probe_native_neighbours [--parent DIR]

Run from the repository root on a CUDA card (it uses ``chip_smoke.py``'s
gateway child, load windows and phase 27's launchers).  Starts phase 14's
gateway child: ResNet-50 behind two C++ front servers, one with 4 batch
threads and one with 48.  With ``--parent DIR`` (a ``git archive`` of
another commit) a second gateway child serves from that tree the same way.
Then it reads windows in turns, each tree in the order p c c p where a
parent is given:

1. with phase 27's early processes absent;
2. with them alive and idle, as they are through phases 3-26 of the
   smoke: the deployer process of ``examples/native_frontend.yaml``
   behind its own C++ ingress (``launch_a13``) and the hpa deployment's
   first replica process, applied by this process's ``Deployer``
   (``launch_a13_hpa``);
3. with them stopped again.

A turn is 14a's method (a one-client window, then 4 Python gRPC clients
of batch-1 uint8 ``rawTensor`` rows on the 4-thread server) and 14c's
C++ h2c client at (8 connections, 8 in flight) of batch-32 requests on
the 48-thread server.  Prints one JSON line a turn, with the card's name
and power limit, and all turns as one JSON object on the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default="", help="a git archive of another commit to read in turns")
    parser.add_argument("--h2c-seconds", type=float, default=0.5, help="14c's (8, 8) window")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import grpc
    import numpy as np
    import torch

    import chip_smoke as cs
    from seldon_core_tpu_torch import native
    from seldon_core_tpu_torch.native import frontserver
    from seldon_core_tpu_torch.ops import _build
    from seldon_core_tpu_torch.proto import pb, services
    from seldon_core_tpu_torch.runtime import grpc_server

    if not torch.cuda.is_available():
        print("probe_native_neighbours: no CUDA card", file=sys.stderr)
        return 1
    card = cs.card_report(torch, grpc)[0]
    native.build()
    _build.build("fused_normalize")
    _build.load("fused_normalize")
    roots = {"change": os.getcwd()}
    if args.parent:
        roots = {"parent": os.path.abspath(args.parent), **roots}
    order = ["parent", "change", "change", "parent"] if args.parent else ["change", "change"]
    graph = {"name": "resnet50", "type": "MODEL", "implementation": "CUDA_SERVER", "parameters": cs.GRPC_PARAMS}
    procs, ports, logs = {}, {}, {}
    for name, root in roots.items():
        port, h2c_port = cs.free_port(), cs.free_port()
        spec = {"name": "resnet50", "graph": graph, "http_port": cs.free_port(), "grpc_port": cs.free_port(),
                "native": [[port, 4], [h2c_port, 48]], "a4": False, "annotations": {}, "replicas": []}
        fd, logpath = tempfile.mkstemp(prefix=f"probe_native_neighbours_{name}_", suffix=".log")
        logs[name] = (os.fdopen(fd, "w"), logpath)
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
             "chip_smoke.gateway_child(sys.argv[1])", json.dumps(spec)],
            cwd=root, stdout=logs[name][0], stderr=subprocess.STDOUT, start_new_session=True)
        ports[name] = (port, h2c_port)
    neighbours = {}
    turns = []
    try:
        for name in roots:
            for port in ports[name]:
                cs.wait_gateway([procs[name]], f"http://127.0.0.1:{port}", logs[name][1])
        images = cs.distinct_images(np, np.random.default_rng(cs.SEED + 14), 32)
        singles = [cs.grpc_request(pb, images[i:i + 1]) for i in range(8)]
        batch_blob = cs.grpc_request(pb, images).SerializeToString()

        def turn(stage: str, tree: str) -> None:
            port, h2c_port = ports[tree]
            lane = cs.grpc_lane(pb, services, grpc_server, port)
            seq, _, _ = cs.load_window(lane, singles, 1, cs.GRPC_SEQUENTIAL_SECONDS)
            lat, _, _ = cs.load_window(lane, singles, cs.GRPC_LAT_CLIENTS, cs.NATIVE_GRPC_SECONDS)
            cs.quiesce(f"http://127.0.0.1:{h2c_port}")
            h2c = frontserver.native_load_grpc(h2c_port, "/seldon.protos.Seldon/Predict", batch_blob,
                                               args.h2c_seconds, 8, 8)
            lat = sorted(lat)
            row = {"stage": stage, "tree": tree, "sequential_p50_ms": cs.pct(seq, 0.5),
                   "sequential_max_ms": max(seq), "n": len(lat), "p50_ms": cs.pct(lat, 0.5),
                   "p90_ms": cs.pct(lat, 0.9), "p99_ms": cs.pct(lat, 0.99), "max_ms": lat[-1],
                   "over_500ms": sum(1 for x in lat if x > 500), "qps": len(lat) / cs.NATIVE_GRPC_SECONDS,
                   "h2c_8x8_img_s": h2c["qps"] * 32, "h2c_ok": h2c["ok"], "h2c_errors": h2c["errors"],
                   "h2c_non2xx": h2c["non2xx"], "card": card}
            turns.append(row)
            print(json.dumps(row), flush=True)

        for tree in order:
            turn("absent", tree)
        neighbours["a13"] = cs.launch_a13()
        neighbours["a13_hpa"] = cs.launch_a13_hpa()
        for ctx in neighbours.values():
            ctx["ready"]()
        free, total = torch.cuda.mem_get_info()
        cs.log(f"phase 27's deployer process and hpa replica ready; card memory in use "
               f"{(total - free) / 2 ** 30:.2f} GiB [{card}]")
        for tree in order:
            turn("alive", tree)
        stop_neighbours(cs, neighbours)
        for tree in order:
            turn("stopped", tree)
    finally:
        stop_neighbours(cs, neighbours)
        for p in procs.values():
            cs.stop_server(p)
        for logfile, _ in logs.values():
            logfile.close()
    print(json.dumps({"turns": turns}))
    return 0


def stop_neighbours(cs, neighbours: dict) -> None:
    for ctx in neighbours.values():
        for proc in ctx["procs"]:
            cs.stop_server(proc)
        ctx["logfile"].close()
        ctx["cleanup"]()
    neighbours.clear()


if __name__ == "__main__":
    sys.exit(main())
