"""Where K1's (``fused_normalize``) time goes, on one CUDA card.

    python -m seldon_core_tpu_torch.tools.probe_normalize [--parent DIR]

Run from the repository root (it uses ``chip_smoke.py``'s timing and
inputs).  It prints the card's name and power limit first, then
``nvcc -Xptxas -v``'s registers and shared memory of each kernel, then,
at (32, 224, 224, 3) and (1, 224, 224, 3) u8 -> bf16 with the ImageNet
affine, L2 flushed before each call, these in turns (the source as it is
first and last):

* the source as it is (``ops/csrc/fused_normalize.cu``);
* "launch only": a text-edited copy whose kernels return at once, on the
  same grid: the launch floor of K1's own geometry;
* "no arithmetic": loads and stores only, the same bytes (each result is
  the loaded word's bits, still packed to the output format);
* "ldg loads": the loads through ``__ldg`` (allocating in L1, no L2 hint);
* "one load at a time": a thread's second vector loaded after the first
  is stored, not before its arithmetic;
* "blocks of 256", "blocks of 128", "blocks of 64": the same threads in
  blocks of that size;
* "half the threads": half the blocks, each thread taking two vectors;
* "stores own vector": each lane stores its own vector's pieces (no
  trade between lane pairs), so a sector is written half by one store
  instruction and half by another; "stores plain": whole sectors without
  the L2 evict_last hint; "stores evict_normal": the hint with an
  evict_normal policy; "loads plain": the input read without the L2
  evict_first hint; "no L2 hints": neither hint; "input policy a load":
  the input's policy created before each load, not once a thread;
* "tma ring": ``tools/normalize_tma_ring.cu``, persistent blocks fed by
  bulk copies into a ring of shared memory, written back by bulk stores;
* with ``--parent DIR`` (a checkout of another commit), that checkout's
  ``fused_normalize.cu``, built beside this one;
* PyTorch's one-call floors for the same traffic: ``torch.cuda._sleep(0)``
  (an empty launch) and ``out_bf16.copy_(x_u8)`` (reads 1, writes 2 bytes
  an element).

Then K1 followed by ResNet-50's stem convolution (``conv_init``, 7x7 / 2,
64 filters, bf16, channels_last) at batch 32, this source against its
"stores own vector" copy and the parent's, in turns, beside the convolution alone
on a cold input: whether K1's output left in L2 helps the next kernel.

Every variant that computes the right thing is held bit for bit against
the plain version before it is timed.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TMA_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "normalize_tma_ring.cu")

_POLICY = "createpolicy.fractional.L2::evict_last.b64"
_PLAIN_STORES = ("""  asm volatile("st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;"
               ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy) : "memory");""",
                 """  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};"
               ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");""")
_OWN_VECTOR = ("""    if (e < vectors) store_hint(out + e * N + s + odd, odd ? recv : p[s], policy);
    if (e + 1 < vectors) store_hint(out + (e + 1) * N + s + odd, odd ? p[s + 1] : recv, policy);
""", """    if (v < vectors) {
      store_hint(out + v * N + s, p[s], policy);
      store_hint(out + v * N + s + 1, p[s + 1], policy);
    }
""")
_LOAD = """  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));"""
_LDG = ("  uint4 v;\n" + _LOAD + "\n  return v;\n", "  return __ldg(reinterpret_cast<const uint4*>(p));\n")
_LOADS_PLAIN = (_LOAD, """  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));""")
_POLICY_A_LOAD = ("  uint4 v;\n" + _LOAD, "  uint4 v;\n  asm volatile(\"createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\""
                  " : \"=l\"(policy));\n" + _LOAD)
_ONE_LOAD = [("w += 2 * threads) {", "w += threads) {"),
             ("    if (vb < vectors) b = load_stream(x + kVec * vb, in_policy);\n", ""),
             ("    if (w + threads < vectors) convert_store<KIND, C>(out, vb, b, s, h, vectors, policy);\n", "")]


def _up3(blocks: int) -> int:
    """Blocks that keep an RGB grid's threads a multiple of 3 (the kernel's channel rule)."""
    return -(-blocks // 3) * 3


def _threads(t):
    """The same threads in blocks of ``t``."""
    return lambda g: g._replace(threads=t, blocks=_up3(-(-g.blocks * g.threads // t)))


# name -> ([(text, replacement)] applied to the source, computes the right thing,
#          a change to the grid the wrapper computes or None)
VARIANTS = {
    "as is": ([], True, None),
    "launch only": ([("  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;\n",
                      "  if (n > 0) return;\n  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x"
                      " + threadIdx.x;\n")], False, None),
    "no arithmetic": ([("r[k] = affine(byte_as_float(words[k >> 2], k & 3), s[k % C], h[k % C]);",
                        "r[k] = __uint_as_float(words[k >> 2]);")], False, None),
    "ldg loads": ([_LDG], True, None),
    "one load at a time": (_ONE_LOAD, True, None),
    "blocks of 256": ([], True, _threads(256)),
    "blocks of 128": ([], True, _threads(128)),
    "blocks of 64": ([], True, _threads(64)),
    "half the threads": ([], True, lambda g: g._replace(blocks=_up3(g.blocks // 2))),
    "stores own vector": ([_OWN_VECTOR], True, None),
    "stores plain": ([_PLAIN_STORES], True, None),
    "stores evict_normal": ([(_POLICY, "createpolicy.fractional.L2::evict_normal.b64")], True, None),
    "loads plain": ([_LOADS_PLAIN], True, None),
    "input policy a load": ([_POLICY_A_LOAD], True, None),
    "no L2 hints": ([_LOADS_PLAIN, _PLAIN_STORES], True, None),
    "tma ring": (None, True, None),
}
BATCHES = (32, 1)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _variant_source(name: str) -> str:
    from seldon_core_tpu_torch.ops import _build

    text = _build.source_path("fused_normalize").read_text()
    for old, new in VARIANTS[name][0]:
        if old not in text:
            raise SystemExit(f"variant {name!r}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def build_variants(build_dir: str, names=tuple(VARIANTS), parent: str = None):
    """-> ({name: ctypes library}, {name: nvcc -Xptxas -v output}) of each
    named variant (and of ``parent``'s source, as "parent"), built in
    parallel with the port's nvcc flags."""
    from seldon_core_tpu_torch.ops import _build

    def build(name):
        out = os.path.join(build_dir, "k1_" + "".join(ch if ch.isalnum() else "_" for ch in name) + ".so")
        extra = []
        if name == "parent":
            src = os.path.join(parent, "seldon_core_tpu_torch", "ops", "csrc", "fused_normalize.cu")
        elif name == "tma ring":
            src, extra = TMA_SOURCE, ["-I", str(_build.CSRC_DIR)]
        else:
            src = out[:-3] + ".cu"
            with open(src, "w") as f:
                f.write(_variant_source(name))
        proc = subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, *extra, "-Xptxas", "-v",
                               "-o", out, src], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"K1 variant {name!r} does not build:\n{proc.stdout}{proc.stderr}")
        return name, out, proc.stdout + proc.stderr

    todo = [n for n in names if n == "as is" or VARIANTS[n][0] != []] + (["parent"] if parent else [])
    with ThreadPoolExecutor(len(todo)) as pool:
        built = list(pool.map(build, todo))
    libs, logs = {}, {}
    for name, path, log in built:
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_normalize_u8.restype = i
        if name == "parent":  # (..., n, channels, out_kind, sms, stream): the grid is its own
            lib.fused_normalize_u8.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, p]
        else:  # (..., n, channels, out_kind, blocks, threads, stream)
            lib.fused_normalize_u8.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, i, p]
            lib.fused_normalize_blocks_per_sm.argtypes = [i, i, i, ctypes.POINTER(i)]
            lib.fused_normalize_blocks_per_sm.restype = i
        libs[name], logs[name] = lib, log
    for name in names:  # a new grid on the source's build
        libs.setdefault(name, libs.get("as is"))
    return libs, logs


def ptxas_report(logs) -> None:
    """One line an instantiation: its registers, spills and shared memory
    (template arguments: output kind 0 f32, 1 bf16, 2 f16; then C)."""
    for name, log in logs.items():
        lines = log.splitlines()
        for k, line in enumerate(lines):
            m = re.search(r"\d((?:fused_)?normalize\w*?_kernel)(I((?:Li\d+E)+)E)?", line)
            if "Compiling entry function" in line and m:
                args = re.findall(r"Li(\d+)E", m.group(3) or "")
                kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
                stats = " | ".join(x.split("info    : ")[-1].strip() for x in lines[k + 1:k + 4]
                                   if "Used" in x or "spill" in x)
                print(f"ptxas {name}: {kernel}: {stats}", flush=True)


class Swapped:
    """Calls of ``kernels.fused_normalize`` with a variant's library in
    place of the built source (their C interface is the same), and the
    wrapper's grid changed by ``regrid`` if one is given.  The occupancy
    stays the source's: the wrapper's cache already holds it once the
    source has run at the same (C, dtype)."""

    def __init__(self, lib, regrid=None):
        self.lib, self.regrid = lib, regrid

    def __enter__(self):
        from seldon_core_tpu_torch.ops import _build, kernels

        self.saved = _build._LIBS.get("fused_normalize")
        _build._LIBS["fused_normalize"] = self.lib
        if self.regrid is not None:
            real = self.real = kernels.normalize_geometry
            kernels.normalize_geometry = lambda *a: self.regrid(real(*a))
        return self

    def __exit__(self, *exc):
        from seldon_core_tpu_torch.ops import _build, kernels

        if self.saved is None:
            _build._LIBS.pop("fused_normalize", None)
        else:
            _build._LIBS["fused_normalize"] = self.saved
        if self.regrid is not None:
            kernels.normalize_geometry = self.real


def parent_call(torch, lib, x, s, b):
    """One call of the parent's library as its wrapper made it: an output
    from the caching allocator, the grid capped at 8 blocks an SM."""
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    err = lib.fused_normalize_u8(x.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(), x.numel(), x.shape[-1],
                                 1, sms, torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"the parent's fused_normalize failed: cudaError {err}")
    return out


def callers(torch, kernels, libs, x, s, b):
    """name -> a call of that variant on (x, s, b) -> bf16."""
    def through(lib, regrid):
        def call():
            with Swapped(lib, regrid):
                return kernels.fused_normalize(x, s, b, torch.bfloat16)
        return call

    calls = {name: through(lib, VARIANTS[name][2]) for name, lib in libs.items() if name != "parent"}
    if "parent" in libs:
        calls["parent"] = lambda: parent_call(torch, libs["parent"], x, s, b)
    return calls


def inputs(torch, np, kernels, batch: int):
    rng = np.random.default_rng(batch)
    x = torch.from_numpy(rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8)).cuda()
    s, b = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())
    return x, s, b


def variant_times(torch, np, cs, kernels, libs) -> None:
    order = ["as is"] + [n for n in libs if n != "as is"] + ["as is"]
    for batch in BATCHES:
        x, s, b = inputs(torch, np, kernels, batch)
        ref = kernels.fused_normalize_reference(x, s, b, torch.bfloat16)
        calls = callers(torch, kernels, libs, x, s, b)
        for name in libs:
            if name == "parent" or VARIANTS[name][1]:
                got = calls[name]()
                torch.cuda.synchronize()
                cs.check(torch.equal(got.view(torch.int16), ref.view(torch.int16)),
                         f"K1 {name} at batch {batch} differs from the plain version")
        y = torch.empty(x.shape, dtype=torch.bfloat16, device="cuda")
        cells = [f"{name} {cs.time_cuda(torch, calls[name]) * 1e3:.2f}" for name in order]
        cells.append(f"torch.cuda._sleep(0) {cs.time_cuda(torch, lambda: torch.cuda._sleep(0)) * 1e3:.2f}")
        cells.append(f"out_bf16.copy_(x_u8) {cs.time_cuda(torch, lambda: y.copy_(x)) * 1e3:.2f}")
        print(f"K1 ({batch},224,224,3) u8->bf16, L2 flushed (us): " + "; ".join(cells), flush=True)


def stem_pair(torch, np, cs, kernels, libs) -> None:
    from seldon_core_tpu_torch.models.resnet import ConvSame

    torch.backends.cudnn.benchmark = True  # as CudaServer serves
    conv = ConvSame(3, 64, 7, 2, padding=3, dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.05, generator=torch.Generator("cuda").manual_seed(0))
    conv = conv.to(memory_format=torch.channels_last)
    x, s, b = inputs(torch, np, kernels, 32)
    calls = callers(torch, kernels, libs, x, s, b)
    cold = kernels.fused_normalize_reference(x, s, b, torch.bfloat16).permute(0, 3, 1, 2)
    names = [n for n in ("parent", "as is", "stores own vector") if n in libs]
    order = names + names[::-1]
    with torch.inference_mode():
        cells = [f"{name} {cs.time_cuda(torch, lambda n=name: conv(calls[n]().permute(0, 3, 1, 2))) * 1e3:.2f}"
                 for name in order]
        cells.append(f"conv_init alone, cold input {cs.time_cuda(torch, lambda: conv(cold)) * 1e3:.2f}")
    print("K1 -> conv_init at batch 32, L2 flushed before the pair (us): " + "; ".join(cells), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of another commit, whose fused_normalize.cu is timed beside")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_normalize: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import kernels

    print("card:", card_line(), flush=True)
    with tempfile.TemporaryDirectory() as build_dir:
        libs, logs = build_variants(build_dir, parent=os.path.abspath(args.parent) if args.parent else None)
        ptxas_report(logs)
        variant_times(torch, np, cs, kernels, libs)
        stem_pair(torch, np, cs, kernels, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
