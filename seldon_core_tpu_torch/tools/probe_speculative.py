"""Where a speculative round's time goes, against plain decode.

    python -m seldon_core_tpu_torch.tools.probe_speculative [--cpu]

At ``chip_smoke.py`` phase 20c's shape (the generation config in bf16,
16 lanes, the JAX bench's echo prompts, 64 new tokens), one
``PagedEngine`` decoding plainly (8 steps a chunk) and one with ngram
drafts (``draft_k`` 4), each warmed by a run of every prompt, then:

1. a run of every prompt: its wall time, the wall of its device calls
   (``_chunk`` / ``_spec_chunk``, the device synchronised before each),
   and the host's ``ngram_draft`` seconds and calls;
2. a second run with the seventh device call profiled
   (``torch.profiler``): its wall, the device-busy time of its events and
   the largest device ops by name.

Prints one JSON object as its last line, with the card's name and power
limit from ``nvidia-smi`` (``--cpu``: a small config on the CPU, a
rehearsal that names no device numbers).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

GEN_CONFIG = dict(vocab_size=16384, d_model=512, num_layers=8, num_heads=8, max_len=1024)
GEN_ENGINE = dict(page_size=64, max_slots=16, steps_per_call=8)
CPU_CONFIG = dict(vocab_size=256, d_model=64, num_layers=2, num_heads=2, max_len=512)
CPU_ENGINE = dict(page_size=16, max_slots=4, steps_per_call=8)
NEW = 64
DRAFT_K = 4
ECHO = 160
PROFILED_CALL = 6  # the seventh device call of the second run


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def echo_prompts(eng, cfg, n: int):
    """The JAX bench's echo workload (``bench.py:2412-2430``): ramps of eight
    tokens, 32 + 8 i long, each followed by the engine's own greedy
    continuation, cut to the last ECHO tokens."""
    base = np.tile(np.arange(8, dtype=np.int32) + 3, 32)
    seeds = [base[: 32 + 8 * i] % cfg["vocab_size"] for i in range(n)]
    streams = [eng.submit(p, max_new_tokens=NEW) for p in seeds]
    eng.run()
    return [np.concatenate([p, s.result[s.result >= 0]])[-ECHO:].astype(np.int32) for p, s in zip(seeds, streams)]


def drive(eng, prompts) -> None:
    streams = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    eng.run()
    for s in streams:
        if s.error is not None or s.result is None:
            raise RuntimeError(f"a stream failed: {s.error}")


def device_ops(prof):
    """-> ({name: [device ms, count]}, device-busy ms) of a profiler run."""
    from torch.autograd import DeviceType

    ops = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = ops.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    return ops, sum(ms for ms, _ in ops.values())


def probe(device: str, cfg, engine_cfg):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seldon_core_tpu_torch.models import speculative
    from seldon_core_tpu_torch.models.generate import load_lm_params
    from seldon_core_tpu_torch.models.paged import PagedEngine

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    params = load_lm_params("", cfg, 0, torch.device(device))

    def make(**kw):
        return PagedEngine(params, dtype="bfloat16", device=device, prefix_cache=False, **cfg, **engine_cfg, **kw)

    plain = make()
    prompts = echo_prompts(plain, cfg, engine_cfg["max_slots"])
    lanes = {"plain": (plain, "_chunk"),
             "ngram": (make(speculative={"draft": "ngram", "draft_k": DRAFT_K}), "_spec_chunk")}
    host = [0.0, 0]
    lookup = speculative.ngram_draft

    def timed_lookup(*a, **k):
        t = time.perf_counter()
        try:
            return lookup(*a, **k)
        finally:
            host[0] += time.perf_counter() - t
            host[1] += 1

    out = {}
    speculative.ngram_draft = timed_lookup
    try:
        for name, (eng, attr) in lanes.items():
            drive(eng, prompts)  # warm
            call = getattr(eng, attr)
            calls = [0.0, 0]
            profiled = {}

            def timed_call(*a, _call=call, **k):
                sync()
                t = time.perf_counter()
                if "prof" in profiled or calls[1] != PROFILED_CALL or not profiled.get("armed"):
                    r = _call(*a, **k)
                else:
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        r = _call(*a, **k)
                        sync()
                    profiled.update(prof=prof, wall_ms=(time.perf_counter() - t) * 1e3)
                calls[0] += time.perf_counter() - t
                calls[1] += 1
                return r

            setattr(eng, attr, timed_call)
            host[:] = [0.0, 0]
            sync()
            t0 = time.perf_counter()
            drive(eng, prompts)
            sync()
            row = {"wall_s": time.perf_counter() - t0, "device_calls": calls[1], "device_call_wall_s": calls[0],
                   "ngram_host_s": host[0], "ngram_calls": host[1], "rounds_or_chunks": calls[1]}
            calls[:] = [0.0, 0]
            profiled["armed"] = True
            drive(eng, prompts)
            ops, busy = device_ops(profiled["prof"])
            top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:8]
            row.update(profiled_call_wall_ms=profiled["wall_ms"], profiled_call_device_busy_ms=busy,
                       profiled_call_top_ops=[[k[:70], round(ms, 3), n] for k, (ms, n) in top])
            out[name] = row
    finally:
        speculative.ngram_draft = lookup
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="a small config on the CPU (a rehearsal)")
    args = parser.parse_args(argv)
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            print("probe_speculative: no CUDA card (use --cpu to rehearse)", file=sys.stderr)
            return 1
    out = probe("cpu", CPU_CONFIG, CPU_ENGINE) if args.cpu else probe("cuda", GEN_CONFIG, GEN_ENGINE)
    out["card"] = "cpu rehearsal" if args.cpu else card()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
