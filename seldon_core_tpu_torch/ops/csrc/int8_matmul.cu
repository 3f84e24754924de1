// int8_matmul (K2): y = (x @ w_int8) * scale[col], f32 accumulation,
// one rounding to the output dtype.
//
// Replaces the Pallas TPU kernel seldon_core_tpu/ops/kernels.py
// (_int8_matmul_kernel / int8_matmul), the dense layer of Int8Dense.
// The TPU version loads the whole K extent of a (bm, bn) block at once
// and pads M, N and K up to the (8, 128) tile in the wrapper.  Here each
// block owns one 64 x 64 output tile and streams K through shared memory
// in chunks of 32: the x chunk converted to f32 (stored k-major, so a
// thread reads its four rows as one float4) and the int8 w chunk
// converted to f32 once while staging.  256 threads each keep a 4 x 4
// f32 micro-tile in registers; the epilogue multiplies by scale[col]
// and rounds once.  Ragged M, N and K are bounds-checked, never padded.
//
// Loads: 16-byte vectors of x only when the host says the row stride and
// the base allow it (vec_x), 8-byte vectors of w likewise (vec_w), and
// only for a chunk that lies wholly inside the matrix; else scalar loads.
//
// Bound: at the shapes it serves (ViT-B/16 fc1 at batch 32: 6304 x 768
// @ 768 x 3072) operations, 29.75 Gflop against 50.8 MB; on the bf16
// tensor cores that is 30 us, on the f32 CUDA cores (where this simple
// kernel runs its FMAs) 444 us.  Tensor cores (wgmma on bf16 operands,
// where the int8 values are exact), TMA and a pipelined K loop are a
// later kernel's work.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch.
// The caller makes the tensors' device current; nothing is allocated.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;

enum Kind { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <int KIND>
__device__ __forceinline__ float to_f32(const void* p, int64_t i) {
  if (KIND == kF32) return static_cast<const float*>(p)[i];
  if (KIND == kBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

// 8 consecutive x values of one row, 16-byte loads (two for f32)
template <int KIND>
__device__ __forceinline__ void load8_vec(const void* p, int64_t i, float (&v)[8]) {
  if (KIND == kF32) {
    const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    const float4 a = src[0], b = src[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(p) + i);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint16_t lo = static_cast<uint16_t>(words[j] & 0xffffu);
      const uint16_t hi = static_cast<uint16_t>(words[j] >> 16);
      if (KIND == kBF16) {
        v[2 * j] = __bfloat162float(__ushort_as_bfloat16(lo));
        v[2 * j + 1] = __bfloat162float(__ushort_as_bfloat16(hi));
      } else {
        v[2 * j] = __half2float(__ushort_as_half(lo));
        v[2 * j + 1] = __half2float(__ushort_as_half(hi));
      }
    }
  }
}

template <int OKIND>
__device__ __forceinline__ void store1(void* out, int64_t i, float v) {
  if (OKIND == kF32) {
    static_cast<float*>(out)[i] = v;
  } else if (OKIND == kBF16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<__half*>(out)[i] = __float2half_rn(v);
  }
}

template <int XKIND, int OKIND>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, void* __restrict__ out,
                   int M, int N, int K, int64_t lda, int64_t ldw, int vec_x, int vec_w) {
  __shared__ __align__(16) float xs[kBK][kBM];  // k-major: xs[k][row]
  __shared__ __align__(16) float ws[kBK][kBN];  // ws[k][col]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  // compute mapping: rows ty*4..+3, cols tx*4..+3 of the tile
  const int tx = tid % 16;
  const int ty = tid / 16;
  // x staging: one row, 8 consecutive k of the chunk
  const int xr = tid % kBM;
  const int xk = (tid / kBM) * 8;
  // w staging: one k row of the chunk, 8 consecutive columns
  const int wk = tid / 8;
  const int wc = (tid % 8) * 8;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    {  // stage x[m0 + xr, k0 + xk .. +7]
      const int m = m0 + xr;
      const int k = k0 + xk;
      float v[8];
      if (m < M && vec_x && k + 8 <= K) {
        load8_vec<XKIND>(x, static_cast<int64_t>(m) * lda + k, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = (m < M && k + j < K) ? to_f32<XKIND>(x, static_cast<int64_t>(m) * lda + k + j) : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) xs[xk + j][xr] = v[j];
    }
    {  // stage w[k0 + wk, n0 + wc .. +7]
      const int k = k0 + wk;
      const int n = n0 + wc;
      float v[8];
      if (k < K && vec_w && n + 8 <= N) {
        const uint2 raw = *reinterpret_cast<const uint2*>(w + static_cast<int64_t>(k) * ldw + n);
        const uint32_t words[2] = {raw.x, raw.y};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = static_cast<float>(static_cast<int8_t>((words[j >> 2] >> (8 * (j & 3))) & 0xffu));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = (k < K && n + j < N) ? static_cast<float>(w[static_cast<int64_t>(k) * ldw + n + j]) : 0.0f;
        }
      }
      float4* dst = reinterpret_cast<float4*>(&ws[wk][wc]);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: one multiply by the column's scale, one rounding
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= N) continue;
    const float s = __ldg(scale + n);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m < M) store1<OKIND>(out, static_cast<int64_t>(m) * N + n, __fmul_rn(acc[i][j], s));
    }
  }
}

template <int XKIND>
cudaError_t launch(int out_kind, dim3 grid, cudaStream_t s, const void* x, const int8_t* w,
                   const float* scale, void* out, int M, int N, int K, long long lda, long long ldw,
                   int vec_x, int vec_w) {
  switch (out_kind) {
    case kF32:
      int8_matmul_kernel<XKIND, kF32><<<grid, kThreads, 0, s>>>(x, w, scale, out, M, N, K, lda, ldw, vec_x, vec_w);
      break;
    case kBF16:
      int8_matmul_kernel<XKIND, kBF16><<<grid, kThreads, 0, s>>>(x, w, scale, out, M, N, K, lda, ldw, vec_x, vec_w);
      break;
    case kF16:
      int8_matmul_kernel<XKIND, kF16><<<grid, kThreads, 0, s>>>(x, w, scale, out, M, N, K, lda, ldw, vec_x, vec_w);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) of x_kind with row stride lda (elements), unit column stride;
// w: (K, N) int8 with row stride ldw; scale: (N,) f32; out: (M, N)
// contiguous of out_kind.  vec_x: x's base and row stride are 16-byte
// aligned; vec_w: w's base and row stride are 8-byte aligned.
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, void* out, int M, int N, int K,
                           long long lda, long long ldw, int x_kind, int out_kind, int vec_x, int vec_w,
                           void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || lda < K || ldw < N) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  cudaError_t err;
  switch (x_kind) {
    case kF32:
      err = launch<kF32>(out_kind, grid, s, x, wp, sp, out, M, N, K, lda, ldw, vec_x, vec_w);
      break;
    case kBF16:
      err = launch<kBF16>(out_kind, grid, s, x, wp, sp, out, M, N, K, lda, ldw, vec_x, vec_w);
      break;
    case kF16:
      err = launch<kF16>(out_kind, grid, s, x, wp, sp, out, M, N, K, lda, ldw, vec_x, vec_w);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
