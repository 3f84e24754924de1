"""Where the paged-decode kernel's time goes, on one CUDA card.

    python -m seldon_core_tpu_torch.tools.probe_paged_decode [--parent DIR]

Run from the repository root (it uses ``chip_smoke.py``'s timing and
inputs).  Three parts, each printed with the card's name and power limit:

1. ablations: text-edited copies of ``ops/csrc/paged_decode.cu`` (the
   launch alone, the prologue alone, no scores / softmax / weighted sums,
   no merge, no LoRA fold, 16 KB tiles, 1 KB head groups of 8 heads),
   each built with ``nvcc`` (all at once), swapped in for the wrapper's
   library, and timed in turns with the source as it is (first and last)
   at the serving shape: 16 lanes x 8 heads of 64, pages of 64, 16-page
   tables, bf16 q, uniform 512 and ragged 0..1024, for K4, K5, K4-int8,
   K4-LoRA and K4-int8+LoRA;
2. floors: an empty launch, and PyTorch's own one-call reads of the same
   16 MB (``x.sum()``, ``y.copy_(x)``), timed the same way (L2 flushed);
3. with ``--parent DIR`` (a checkout of another commit): in-process decode
   tokens/s and one decode chunk's profile (``chip_smoke.engine_numbers``,
   plain bf16 and int8 pool + two adapters), that checkout and this one in
   turns (parent, this, this, parent), each in its own process.

Every variant's output is held against the plain version (1e-4) before
it is timed; the ablations compute the wrong thing and are only timed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (name, [(text, replacement)], checked against the plain version, head group override)
_BODY_OFF = [("for (int pr = tid; pr < g.T * HG; pr += kThreads) {",
              "for (int pr = tid; false && pr < g.T * HG; pr += kThreads) {"),
             ("for (int head = warp; head < HG; head += kWarps) {",
              "for (int head = warp; false && head < HG; head += kWarps) {"),
             ("    if (vg < g.ng) {\n      const float alpha", "    if (false && vg < g.ng) {\n      const float alpha")]
_GROUP_1K = [("constexpr int kMaxGroupBytes = 512;", "constexpr int kMaxGroupBytes = 1024;"),
             ("constexpr int kMaxGroupElems = 256;", "constexpr int kMaxGroupElems = 512;")]
VARIANTS = {
    "as is": ([], True, None),
    "launch only": ([("  const int G = p.chunk_pages;\n", "  if (p.heads > 0) return;\n  const int G = p.chunk_pages;\n")],
                    False, None),
    "prologue only": ([("  const int64_t col0 =", "  if (p.heads > 0) return;\n  const int64_t col0 =")], False, None),
    "no compute": (_BODY_OFF, False, None),
    "no merge": ([("const bool direct = live == 1;", "const bool direct = true;")], False, None),
    "no fold": ([("    lora_fold(p, g, b, slot, hg, chunk == 0, sh);\n", "")], False, None),
    "16 KB tiles": ([("constexpr int kTileBytes = 32 * 1024;", "constexpr int kTileBytes = 16 * 1024;")], True, None),
    "8 heads, 1 KB groups": (_GROUP_1K, True, 8),
}
CASES = [("stream", False, False), ("grid", False, False), ("stream", True, False), ("stream", False, True),
         ("stream", True, True)]


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def build_variants(build_dir: str):
    """-> {name: ctypes library} of every variant, built in parallel."""
    from seldon_core_tpu_torch.ops import _build

    source = _build.source_path("paged_decode").read_text()

    def build(name):
        text = source
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        src = os.path.join(build_dir, f"v{list(VARIANTS).index(name)}.cu")
        with open(src, "w") as f:
            f.write(text)
        out = src[:-3] + ".so"
        proc = subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
                               src], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"variant {name!r} does not build:\n{proc.stdout}{proc.stderr}")
        return name, out, proc.stdout + proc.stderr

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = {name: (path, log) for name, path, log in pool.map(build, VARIANTS)}
    # the compiler's report of the source as it is: one line an instantiation
    lines = built["as is"][1].splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            stats = " | ".join(x.split("info    : ")[-1].strip() for x in lines[i + 1:i + 4]
                               if "Used" in x or "spill" in x)
            print(f"ptxas {line.split('paged_decode_kernel')[-1].split('EEEvNS_')[0]}: {stats}", flush=True)
    libs = {}
    for name, (path, _) in built.items():
        lib = ctypes.CDLL(path)
        lib.paged_decode.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
        lib.paged_decode.restype = ctypes.c_int
        libs[name] = lib
    return libs


def ablations(torch, np, cs, kernels, libs) -> None:
    from seldon_core_tpu_torch.ops import _build

    real_split = kernels.paged_split
    B, h, hd, ps, P, _ = cs.PAGED_CASES[0]
    order = list(VARIANTS) + ["as is"]
    for label, lengths in (("uniform512", [512] * B), ("ragged", cs.RAGGED_LENGTHS)):
        for quantized in (False, True):
            args, scales, lora = cs.variant_inputs(torch, np, B, h, hd, ps, P, lengths, torch.bfloat16, quantized,
                                                   seed=7)
            for impl, v_quant, fold in CASES:
                if v_quant != quantized:
                    continue
                kw = dict(page_size=ps, kv_scales=scales, lora=lora if fold else None)
                ref = kernels.paged_attention_decode_reference(*args, **kw)
                cells = []
                with cs.knob_env(SELDON_TPU_PAGED_KERNEL_IMPL=impl):
                    for name in order:
                        _, checked, group = VARIANTS[name]
                        _build._LIBS["paged_decode"] = libs[name]
                        kernels.paged_split = ((lambda *a, g=group: (real_split(*a)[0], g)) if group
                                               else real_split)
                        try:
                            if checked:
                                got = kernels.paged_attention_decode(*args, **kw)
                                torch.cuda.synchronize()
                                _, err = cs.compare_flash_state(torch, got[:3], ref[:3], name)
                                cs.check(err <= cs.PAGED_REL_TOL, f"{name}: {err}")
                            ms = cs.time_cuda(torch, lambda: kernels.paged_attention_decode(*args, **kw),
                                              flush_mb=1024)
                        finally:
                            kernels.paged_split = real_split
                        cells.append(f"{name} {ms * 1e3:.2f}")
                print(f"{kernels.paged_launch_name(impl, quantized, fold)} {label} (us): " + "; ".join(cells),
                      flush=True)
    _build._LIBS.pop("paged_decode", None)


def floors(torch, cs) -> None:
    x = torch.randn(8 * 1024 * 1024, device="cuda").to(torch.bfloat16)  # 16 MB, the serving call's K and V
    y = torch.empty_like(x)
    print(f"one call, 16 MB bf16, L2 flushed (us): torch.cuda._sleep(0) "
          f"{cs.time_cuda(torch, lambda: torch.cuda._sleep(0), flush_mb=1024) * 1e3:.2f}; x.sum() "
          f"{cs.time_cuda(torch, lambda: x.sum(), flush_mb=1024) * 1e3:.2f}; y.copy_(x) "
          f"{cs.time_cuda(torch, lambda: y.copy_(x), flush_mb=1024) * 1e3:.2f}", flush=True)


_DECODE = r"""
import json, sys
import numpy as np, torch
import chip_smoke as cs
from seldon_core_tpu_torch.models.generate import load_lm_params
from seldon_core_tpu_torch.models.paged import PagedEngine
from seldon_core_tpu_torch.models.registry import WeightRegistry
from seldon_core_tpu_torch.ops.lora import make_lora_params

def int8_adapter_engine(params):
    with cs.knob_env(SELDON_TPU_KV_DTYPE="int8"):
        return PagedEngine(params, dtype="bfloat16", device="cuda", max_adapters=2, lora_rank=cs.LORA_RANK,
                           weight_registry=cs.adapter_registry(WeightRegistry, make_lora_params),
                           **cs.LM_CONFIG, **cs.LM_ENGINE)

plain = cs.engine_numbers(torch, np, PagedEngine, load_lm_params, "card")
mixed = cs.engine_numbers(torch, np, PagedEngine, load_lm_params, "card", make_engine=int8_adapter_engine,
                          adapters=(None, "a1", "a2"), what="int8 + adapters")
print("RESULT " + json.dumps({"plain": plain, "int8_adapters": mixed}))
"""


def decode_compare(parent: str) -> None:
    keys = ("decode_tokens_per_s", "chunk_device_busy_ms", "chunk_idle_share", "k4_share_of_device_time")
    for tree in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, "-c", _DECODE], cwd=tree, capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=tree))
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")), None)
        if proc.returncode or line is None:
            raise SystemExit(f"decode run in {tree} failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        got = json.loads(line[len("RESULT "):])
        name = "parent" if tree == parent else "this tree"
        for lane, numbers in got.items():
            print(f"decode {name} {lane}: " + ", ".join(f"{k} {numbers[k]:.4f}" for k in keys), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of another commit, for the decode comparison")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_paged_decode: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import kernels

    print("card:", card_line(), flush=True)
    with tempfile.TemporaryDirectory() as build_dir:
        libs = build_variants(build_dir)
        ablations(torch, np, cs, kernels, libs)
    floors(torch, cs)
    if args.parent:
        decode_compare(os.path.abspath(args.parent))
    return 0


if __name__ == "__main__":
    sys.exit(main())
