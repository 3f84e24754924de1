"""How far integrated gradients over ResNet-50 bf16 move with cuDNN's
algorithm choice.

    python -m seldon_core_tpu_torch.tools.probe_ig [--cpu]

Two ``CudaServer`` ResNet-50s of one seed (bf16, the served config),
one normalised 224x224x3 image, ``IntegratedGradientsExplainer`` with 16
steps.  The explainer pins cuDNN's deterministic algorithms for its call;
this probe also runs its rows with the autotuner's algorithms
(``_explain_row`` directly, ``cudnn.benchmark`` on).  Prints the relative
L2 between repeats of one server, between the two servers, and between
the autotuned and the pinned attributions, each lane's ms a call, and one
JSON object as its last line with the card's name and power limit
(``--cpu``: the same at 64x64 on the CPU, a rehearsal that names no
device numbers).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main(argv=None) -> int:
    from seldon_core_tpu_torch.components.explainers import IntegratedGradientsExplainer
    from seldon_core_tpu_torch.models.cudaserver import CudaServer

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="a rehearsal on the CPU at 64x64")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    shape = (64, 64, 3) if args.cpu else (224, 224, 3)
    image = np.random.default_rng(26).normal(size=(1, *shape)).astype(np.float32)
    servers = [CudaServer(model="resnet50", normalize=True, dtype="bfloat16", max_batch_size=32, warmup=False,
                          input_shape=shape, device=device) for _ in range(2)]
    for s in servers:
        s.load()
    ig = [IntegratedGradientsExplainer(model=s, steps=16) for s in servers]

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def autotuned(e):
        module = e.model.module
        x = torch.from_numpy(image).to(device)
        attr, _, _ = e._explain_row(module, x[0], torch.zeros_like(x[0]))
        return attr[None].double().cpu().numpy()

    def timed(fn):
        fn()  # first use: the autotuner's timings, a kernel's load
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    pinned = [timed(lambda e=e: np.asarray(e.explain(image)["attributions"])) for e in ig]
    tuned = [timed(lambda e=e: autotuned(e)) for e in ig]
    out = {
        "pinned_repeat": _rel(np.asarray(ig[0].explain(image)["attributions"]), pinned[0][0]),
        "pinned_across_servers": _rel(pinned[1][0], pinned[0][0]),
        "autotuned_repeat": _rel(autotuned(ig[0]), tuned[0][0]),
        "autotuned_across_servers": _rel(tuned[1][0], tuned[0][0]),
        "autotuned_vs_pinned": _rel(tuned[0][0], pinned[0][0]),
        "pinned_ms": pinned[0][1], "autotuned_ms": tuned[0][1],
    }
    if device == "cuda":
        out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    else:
        out = {k: v for k, v in out.items() if not k.endswith("_ms")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
