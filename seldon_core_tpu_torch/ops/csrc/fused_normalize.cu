// fused_normalize: uint8 NHWC batch -> per-channel affine in float32 ->
// bf16 / f16 / f32, in one pass over device memory.
//
// Replaces the Pallas TPU kernel seldon_core_tpu/ops/kernels.py
// (_normalize_kernel / fused_normalize).  The TPU version walks a grid of
// one image per step; here the input is one flat array: each thread
// loads 16 bytes at a time (uint4) in a grid-stride loop, and a scalar
// tail covers the last n % 16 elements.  The channel of flat element i
// is i % C, so any C works (3 for RGB, 1 for grey).
//
// Bound: memory.  The kernel reads n bytes and writes n * sizeof(out)
// bytes and does 2 flops per element, far below the card's ratio of
// flops to bytes; the design therefore only keeps every load and store
// 16 bytes wide and the affine in registers.
//
// Numerics: __fmul_rn then __fadd_rn (two roundings, never contracted
// into an FMA) and a round-to-nearest-even cast, which is exactly what
// the plain PyTorch chain x.float() * scale + shift -> .to(dtype) does
// as separate kernels, so the two agree bit for bit.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch.
// The caller makes the tensors' device current and passes its SM count;
// the entry point touches no device state of its own.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;  // uint8 elements per 16-byte load

enum OutKind { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float affine(uint32_t byte, int c,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ shift) {
  return __fadd_rn(__fmul_rn(static_cast<float>(byte), __ldg(scale + c)),
                   __ldg(shift + c));
}

// 16 results of one vector, stored with 16-byte writes.
template <int KIND>
__device__ __forceinline__ void store16(void* out, int64_t i0, const float (&v)[kVec]) {
  if (KIND == kF32) {
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + i0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
    // each 32-bit word is one bf16x2 / half2 pair, low element first
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t lo, hi;
      if (KIND == kBF16) {
        lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j]));
        hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1]));
      } else {
        lo = __half_as_ushort(__float2half_rn(v[2 * j]));
        hi = __half_as_ushort(__float2half_rn(v[2 * j + 1]));
      }
      w[j] = lo | (hi << 16);
    }
    uint4* dst = reinterpret_cast<uint4*>(static_cast<uint16_t*>(out) + i0);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

template <int KIND>
__device__ __forceinline__ void store1(void* out, int64_t i, float v) {
  if (KIND == kF32) {
    static_cast<float*>(out)[i] = v;
  } else if (KIND == kBF16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<__half*>(out)[i] = __float2half_rn(v);
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
fused_normalize_kernel(const uint8_t* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift,
                       void* __restrict__ out, int64_t n, int channels) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nvec = n / kVec;
  const uint4* xv = reinterpret_cast<const uint4*>(x);

  for (int64_t v = tid; v < nvec; v += stride) {
    const uint4 raw = __ldg(xv + v);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    const int64_t i0 = v * kVec;
    int c = static_cast<int>(i0 % channels);
    float r[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const uint32_t byte = (words[k >> 2] >> (8 * (k & 3))) & 0xffu;
      r[k] = affine(byte, c, scale, shift);
      c = (c + 1 == channels) ? 0 : c + 1;
    }
    store16<KIND>(out, i0, r);
  }

  // scalar tail: the last n % 16 elements
  for (int64_t i = nvec * kVec + tid; i < n; i += stride) {
    store1<KIND>(out, i, affine(x[i], static_cast<int>(i % channels), scale, shift));
  }
}

}  // namespace

extern "C" int fused_normalize_u8(const void* x, const void* scale, const void* shift,
                                  void* out, long long n, int channels, int out_kind,
                                  int sms, void* stream) {
  if (n <= 0) return 0;
  if (sms <= 0 || channels <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // enough blocks to fill every SM several times; the grid-stride loop
  // covers the rest
  const long long nvec = n / kVec;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* hp = static_cast<const float*>(shift);
  switch (out_kind) {
    case kF32:
      fused_normalize_kernel<kF32><<<blocks, kThreads, 0, s>>>(xp, sp, hp, out, n, channels);
      break;
    case kBF16:
      fused_normalize_kernel<kBF16><<<blocks, kThreads, 0, s>>>(xp, sp, hp, out, n, channels);
      break;
    case kF16:
      fused_normalize_kernel<kF16><<<blocks, kThreads, 0, s>>>(xp, sp, hp, out, n, channels);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
