"""The PyTorch port's kernel module against the JAX package's Pallas kernel.

On the CPU the port's wrapper takes the plain PyTorch version (its input
lies on the CPU); the JAX kernel runs in Pallas interpret mode, as
tests/test_ops.py runs it.  Inputs come from numpy with a seed.  The
CUDA kernel itself is held against the plain version bit for bit on the
card (tests/test_torch_port_cuda.py, and chip_smoke.py).
"""

import pathlib
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.ops import fused_normalize as jax_fused_normalize
from seldon_core_tpu.ops import imagenet_affine as jax_imagenet_affine
from seldon_core_tpu_torch.ops import _build, kernels

SHAPES = [(2, 8, 8, 3), (1, 5, 7, 1), (3, 4, 6, 4), (2, 9, 11, 3)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    c = shape[-1]
    if c == 3:
        scale, shift = kernels.imagenet_affine()
    else:
        scale = rng.uniform(0.001, 0.05, c).astype(np.float32)
        shift = rng.uniform(-2.0, 1.0, c).astype(np.float32)
    return x, scale, shift


class TestFusedNormalizeParity:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_f32_matches_jax_kernel(self, shape):
        # tolerance: rtol = atol = 1e-6 (both compute x*scale+shift in f32)
        x, scale, shift = _inputs(shape, seed=sum(shape))
        ref = np.asarray(jax_fused_normalize(jnp.asarray(x), scale, shift, out_dtype=jnp.float32))
        got = kernels.fused_normalize(torch.from_numpy(x), torch.from_numpy(scale),
                                      torch.from_numpy(shift), out_dtype=torch.float32)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("shape", SHAPES)
    def test_bf16_matches_jax_kernel(self, shape):
        # tolerance: one bf16 rounding step (rtol 2**-8) — both round the
        # same f32 value to bf16, so they agree unless the f32 values differ
        x, scale, shift = _inputs(shape, seed=100 + sum(shape))
        ref = np.asarray(jax_fused_normalize(jnp.asarray(x), scale, shift)).astype(np.float32)
        got = kernels.fused_normalize(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(shift))
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2**-8, atol=1e-6)

    def test_imagenet_affine_equals_jax(self):
        for a, b in zip(kernels.imagenet_affine(), jax_imagenet_affine()):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        custom = dict(mean=(0.5, 0.25), std=(0.2, 0.4))
        for a, b in zip(kernels.imagenet_affine(**custom), jax_imagenet_affine(**custom)):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
    def test_cpu_wrapper_is_the_plain_version_and_launches_nothing(self, dtype):
        x, scale, shift = _inputs((2, 3, 5, 3), seed=7)
        args = (torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(shift), dtype)
        before = kernels.launch_counts()["fused_normalize"]
        got = kernels.fused_normalize(*args)
        assert torch.equal(got, kernels.fused_normalize_reference(*args))
        assert got.is_contiguous() and got.dtype == dtype
        assert kernels.launch_counts()["fused_normalize"] == before

    def test_rejects_bad_arguments(self):
        x, scale, shift = _inputs((1, 2, 2, 3), seed=1)
        s, b = torch.from_numpy(scale), torch.from_numpy(shift)
        with pytest.raises(TypeError, match="uint8"):
            kernels.fused_normalize(torch.zeros(1, 2, 2, 3), s, b)
        with pytest.raises(ValueError, match=r"shape \(3,\)"):
            kernels.fused_normalize(torch.from_numpy(x), s[:2], b)
        with pytest.raises(TypeError, match="out_dtype"):
            kernels.fused_normalize(torch.from_numpy(x), s, b, out_dtype=torch.int32)

    def test_launch_counts_reset(self):
        kernels.reset_launch_counts()
        assert kernels.launch_counts() == {"fused_normalize": 0, "flash_attention": 0, "paged_decode_stream": 0,
                                          "paged_decode_grid": 0, "paged_decode_stream_int8": 0,
                                          "paged_decode_stream_lora": 0, "paged_decode_stream_int8_lora": 0,
                                          "paged_decode_grid_int8": 0, "int8_matmul": 0, "w8a8_int_mm": 0}

    def test_launch_count_loses_no_update_under_threads(self):
        # the batcher's collector and the warmup may count from different
        # threads; 16 threads x 2000 increments with a short switch interval
        kernels.reset_launch_counts()
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=lambda: [kernels._count("fused_normalize") for _ in range(2000)])
                       for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(interval)
        assert kernels.launch_counts()["fused_normalize"] == 16 * 2000
        kernels.reset_launch_counts()


class TestKernelBuild:
    def test_build_key_tracks_source_and_flags(self, monkeypatch):
        key = _build.build_key("fused_normalize")
        assert key == _build.build_key("fused_normalize") and len(key) == 16
        assert _build.library_path("fused_normalize").name == f"fused_normalize-{key}.so"
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-DX"])
        assert _build.build_key("fused_normalize") != key

    def test_nvcc_command_targets_sm90a_shared_library(self, monkeypatch):
        monkeypatch.setattr(_build, "nvcc_path", lambda: "/toolkit/bin/nvcc")
        cmd = _build.nvcc_command("fused_normalize", _build.library_path("fused_normalize"))
        assert cmd[0] == "/toolkit/bin/nvcc"
        assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd and "-fPIC" in cmd
        assert cmd[-1].endswith("ops/csrc/fused_normalize.cu")

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            _build.nvcc_path()

    def test_build_dir_is_listed_in_gitignore(self):
        root = pathlib.Path(__file__).resolve().parent.parent
        rel = _build.BUILD_DIR.relative_to(root).as_posix() + "/"
        assert rel in (root / ".gitignore").read_text().splitlines()

    def test_source_keeps_the_bit_identity_contract(self):
        # separate roundings (no FMA contraction) and round-to-nearest-even
        # casts are what make the kernel bit-identical to the plain chain
        src = _build.source_path("fused_normalize").read_text()
        for needle in ("__fmul_rn", "__fadd_rn", "__float2bfloat16_rn", "__float2half_rn", 'extern "C"'):
            assert needle in src
