// fused_normalize (K1): uint8 (..., C) -> per-channel affine in float32 ->
// bf16 / f16 / f32, in one pass over device memory.
//
// Replaces the Pallas TPU kernel seldon_core_tpu/ops/kernels.py:38
// (_normalize_kernel, called by fused_normalize :46 at :63 on a grid of
// one image a step).  Here the batch is one flat array of n bytes.
//
// Bound: bytes.  At (32, 224, 224, 3) u8 -> bf16 the kernel reads
// 4,816,896 bytes and writes 9,633,792: 4.31 us at the H100's 3.35 TB/s,
// while its 2 flops an element would take 0.14 us at 67 TFLOP/s.  An
// empty launch of the same grid takes ~5 us in chip_smoke.py's timing
// (probe_normalize's "launch only"), so the launch is half the time at
// batch 32 and nearly all of it at batch 1 (0.13 us of bytes).  This
// design takes ~9.7 us at batch 32 (the first version 11.2) and ~5.9 at
// batch 1, and a copy with no arithmetic as long: bytes and launch.
//
// Design (every step measured by probe_normalize on an H100, PERF.md):
// * one 16-byte vector a thread, the grid striding over them, so a
//   warp's load reads 512 contiguous bytes.  The grid's threads are a
//   multiple of lcm(16, C) / 16 (3 for RGB), so every vector a thread
//   converts starts on the same channel, 16 t mod C.  The body is
//   templated on C in {1, 3, 4}: the channel of each element is a
//   constant offset from that phase, scale and shift sit in 2C registers
//   read once, and no modulo or per-element load of scale / shift is
//   left.  Any other C takes the generic body (a runtime channel counter
//   from the phase, scale and shift read per element).  A thread that
//   owns 48 contiguous bytes instead (16 whole pixels) put a warp's loads
//   48 bytes apart and was slower.
// * each store instruction of a warp writes whole 32-byte sectors: lane
//   pairs trade a 16-byte piece first (store_sectors).  A lane storing
//   its own 32 bytes leaves each sector to two instructions, and with the
//   two far apart (as the compiler placed them) the kernel took 12-13 us
//   at batch 32.
// * a thread's loads of two vectors are issued before any arithmetic,
//   past L1 (ld.global.nc.L1::no_allocate: no byte is read twice).  A
//   byte becomes a float by placing it under a magic exponent (one PRMT
//   and an exact FADD, not the quarter-rate I2F).
// * L2 policies: the input evict_first, the output evict_last (see
//   input_policy); ~0.2 us at both batch sizes.
// * one wave: the host (ops/kernels.py normalize_geometry) sizes the grid
//   from the occupancy this library reports
//   (fused_normalize_blocks_per_sm) and rounds it to the channel rule.
//   The threads stride over the vectors, so the result never depends on
//   the grid.
// * the last n % 16 bytes take a scalar path.
//
// Numerics: __fmul_rn then __fadd_rn (two roundings, never contracted
// into an FMA) and a round-to-nearest-even cast, which is exactly what
// the plain PyTorch chain x.float() * scale + shift -> .to(dtype) does
// as separate kernels, so the two agree bit for bit.
//
// C interface (bound with ctypes): the launch returns its cudaError_t.
// The caller makes the tensors' device current and passes the grid; the
// entry points touch no device state of their own.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxThreads = 256;  // the block size of a full grid
constexpr int kVec = 16;          // uint8 elements per 16-byte load

enum OutKind { kF32 = 0, kBF16 = 1, kF16 = 2 };

// the period of the channel pattern in bytes, lcm(16, C): 16 bytes times
// the vectors after which a vector starts on channel 0 again
__host__ __device__ constexpr int64_t unit_bytes(int c) {
  return (c % 16 == 0 ? 1 : c % 8 == 0 ? 2 : c % 4 == 0 ? 4 : c % 2 == 0 ? 8 : 16) * static_cast<int64_t>(c);
}

// 16 bytes past L1, with the L2 policy `policy`
__device__ __forceinline__ uint4 load_stream(const uint8_t* p, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

// byte k of w as a float, exactly: 0x4B0000bb is 2**23 + b
__device__ __forceinline__ float byte_as_float(uint32_t w, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | k)), 8388608.0f);
}

__device__ __forceinline__ float affine(float v, float s, float h) {
  return __fadd_rn(__fmul_rn(v, s), h);
}

// The L2 policies.  The input is read once: evict_first, so its lines,
// clean, are the first victims when the output needs room in an L2 full
// of the previous kernels' dirty lines.  The output is read next by the
// stem convolution: evict_last keeps it in L2 until then (a read with the
// default policy makes it an ordinary line again).
__device__ __forceinline__ uint64_t input_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t output_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// 16 bytes with an L2 cache-policy hint
__device__ __forceinline__ void store_hint(uint4* p, const uint4& v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;"
               ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy) : "memory");
}

// two results as one 32-bit bf16x2 / half2 word, low element first (RNE)
template <int KIND>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  uint32_t w;
  if (KIND == kBF16) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    memcpy(&w, &v, 4);
  } else {
    const __half2 v = __floats2half2_rn(a, b);
    memcpy(&w, &v, 4);
  }
  return w;
}

// 16-byte pieces of one vector's output: 2 for bf16 / f16, 4 for f32
template <int KIND>
constexpr int kPieces = KIND == kF32 ? 4 : 2;

template <int KIND>
__device__ __forceinline__ void pack_pieces(const float (&r)[kVec], uint4 (&p)[kPieces<KIND>]) {
  if constexpr (KIND == kF32) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      p[q] = make_uint4(__float_as_uint(r[4 * q]), __float_as_uint(r[4 * q + 1]), __float_as_uint(r[4 * q + 2]),
                        __float_as_uint(r[4 * q + 3]));
    }
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      p[q] = make_uint4(pack2<KIND>(r[8 * q], r[8 * q + 1]), pack2<KIND>(r[8 * q + 2], r[8 * q + 3]),
                        pack2<KIND>(r[8 * q + 4], r[8 * q + 5]), pack2<KIND>(r[8 * q + 6], r[8 * q + 7]));
    }
  }
}

// The output of this lane's vector v, N 16-byte pieces, stored so that each store instruction of the warp writes
// whole 32-byte sectors.  Lanes 2j and 2j + 1 hold vectors e = v - (lane & 1) and e + 1; for each sector they
// trade one piece (shfl.xor), then the even lane writes the first half of a sector and the odd lane the second:
// sector s of e in one instruction, of e + 1 in the next.  The whole warp calls this.
template <int N>
__device__ __forceinline__ void store_sectors(uint4* __restrict__ out, int64_t v, const uint4 (&p)[N],
                                              int64_t vectors, uint64_t policy) {
  const int odd = threadIdx.x & 1;
  const int64_t e = v - odd;
#pragma unroll
  for (int s = 0; s < N; s += 2) {
    const uint4 send = odd ? p[s] : p[s + 1];
    uint4 recv;
    recv.x = __shfl_xor_sync(0xffffffffu, send.x, 1);
    recv.y = __shfl_xor_sync(0xffffffffu, send.y, 1);
    recv.z = __shfl_xor_sync(0xffffffffu, send.z, 1);
    recv.w = __shfl_xor_sync(0xffffffffu, send.w, 1);
    if (e < vectors) store_hint(out + e * N + s + odd, odd ? recv : p[s], policy);
    if (e + 1 < vectors) store_hint(out + (e + 1) * N + s + odd, odd ? p[s + 1] : recv, policy);
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

// One vector's 16 results, element k on channel (phase + k) mod C: scale
// and shift come from the 2C registers the thread loaded for its phase.
template <int KIND, int C>
__device__ __forceinline__ void convert_store(void* __restrict__ out, int64_t v, const uint4& raw,
                                              const float (&s)[C], const float (&h)[C], int64_t vectors,
                                              uint64_t policy) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  float r[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) r[k] = affine(byte_as_float(words[k >> 2], k & 3), s[k % C], h[k % C]);
  uint4 p[kPieces<KIND>];
  pack_pieces<KIND>(r, p);
  store_sectors(static_cast<uint4*>(out), v, p, vectors, policy);
}

// Thread g of `threads` converts the 16-byte vectors v0 + g, v0 + g + threads, ... below `vectors`, the loads of
// two vectors in flight before their arithmetic; a warp's load reads 512 contiguous bytes.  16 v0 and 16 * threads
// are multiples of C, so every vector of a thread starts on the same channel, 16 g mod C.  The loop runs per warp
// (w, the warp's first vector), so the whole warp reaches each store; v0 and threads are multiples of 32.
template <int KIND, int C>
__device__ __forceinline__ void normalize_vectors(const uint8_t* __restrict__ x, const float* __restrict__ scale,
                                                  const float* __restrict__ shift, void* __restrict__ out,
                                                  int64_t v0, int64_t vectors, int64_t g, int64_t threads) {
  const int phase = static_cast<int>(kVec * g % C);
  float s[C], h[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    s[j] = __ldg(scale + (phase + j) % C);
    h[j] = __ldg(shift + (phase + j) % C);
  }
  const uint64_t in_policy = input_policy(), policy = output_policy();
  const int lane = threadIdx.x % 32;
  for (int64_t w = v0 + g - lane; w < vectors; w += 2 * threads) {
    const int64_t va = w + lane, vb = va + threads;
    uint4 a = make_uint4(0, 0, 0, 0), b = a;
    if (va < vectors) a = load_stream(x + kVec * va, in_policy);
    if (vb < vectors) b = load_stream(x + kVec * vb, in_policy);
    convert_store<KIND, C>(out, va, a, s, h, vectors, policy);
    if (w + threads < vectors) convert_store<KIND, C>(out, vb, b, s, h, vectors, policy);
  }
}

// the elements from i0 to n, one at a time, spread over the grid
template <int KIND>
__device__ __forceinline__ void normalize_tail(const uint8_t* __restrict__ x, const float* __restrict__ scale,
                                               const float* __restrict__ shift, void* __restrict__ out,
                                               int64_t i0, int64_t n, int channels, int64_t tid, int64_t stride) {
  for (int64_t i = i0 + tid; i < n; i += stride) {
    const int c = static_cast<int>(i % channels);
    store1<KIND>(out, i, affine(static_cast<float>(x[i]), __ldg(scale + c), __ldg(shift + c)));
  }
}

template <int KIND, int C>
__global__ void __launch_bounds__(kMaxThreads)
normalize_kernel(const uint8_t* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ shift,
                 void* __restrict__ out, int64_t n, int channels) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  normalize_vectors<KIND, C>(x, scale, shift, out, 0, n / kVec, tid, stride);
  normalize_tail<KIND>(x, scale, shift, out, n / kVec * kVec, n, C, tid, stride);
}

// Any other C: the same vectors, one at a time, with a runtime channel
// counter from the thread's phase and scale and shift read per element.
template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
normalize_generic_kernel(const uint8_t* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ shift, void* __restrict__ out, int64_t n, int channels) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int phase = static_cast<int>(kVec * tid % channels);
  const int64_t vectors = n / kVec;
  const uint64_t in_policy = input_policy(), policy = output_policy();
  for (int64_t v = tid; v - threadIdx.x % 32 < vectors; v += stride) {
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (v < vectors) raw = load_stream(x + kVec * v, in_policy);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    int c = phase;
    float r[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      r[k] = affine(byte_as_float(words[k >> 2], k & 3), __ldg(scale + c), __ldg(shift + c));
      c = (c + 1 == channels) ? 0 : c + 1;
    }
    uint4 p[kPieces<KIND>];
    pack_pieces<KIND>(r, p);
    store_sectors(static_cast<uint4*>(out), v, p, vectors, policy);
  }
  normalize_tail<KIND>(x, scale, shift, out, vectors * kVec, n, channels, tid, stride);
}

using KernelFn = void (*)(const uint8_t*, const float*, const float*, void*, int64_t, int);

template <int KIND>
KernelFn pick_channels(int channels) {
  switch (channels) {
    case 1: return normalize_kernel<KIND, 1>;
    case 3: return normalize_kernel<KIND, 3>;
    case 4: return normalize_kernel<KIND, 4>;
    default: return normalize_generic_kernel<KIND>;
  }
}

KernelFn pick(int channels, int out_kind) {
  if (channels <= 0) return nullptr;
  switch (out_kind) {
    case kF32: return pick_channels<kF32>(channels);
    case kBF16: return pick_channels<kBF16>(channels);
    case kF16: return pick_channels<kF16>(channels);
    default: return nullptr;
  }
}

}  // namespace

// Resident blocks of `threads` threads on one SM for the body that
// (channels, out_kind) selects, into *blocks.
extern "C" int fused_normalize_blocks_per_sm(int channels, int out_kind, int threads, int* blocks) {
  const KernelFn fn = pick(channels, out_kind);
  if (fn == nullptr || threads <= 0 || threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, reinterpret_cast<const void*>(fn), threads, 0));
}

extern "C" int fused_normalize_u8(const void* x, const void* scale, const void* shift, void* out, long long n,
                                  int channels, int out_kind, int blocks, int threads, void* stream) {
  if (n <= 0) return 0;
  const KernelFn fn = pick(channels, out_kind);
  // every vector of a thread must start on one channel: the grid's threads a multiple of lcm(16, C) / 16
  if (fn == nullptr || blocks <= 0 || threads % 32 ||
      static_cast<int64_t>(blocks) * threads % (unit_bytes(channels) / kVec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* hp = static_cast<const float*>(shift);
  int64_t count = n;
  void* args[] = {&xp, &sp, &hp, &out, &count, &channels};
  const cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(blocks), dim3(threads), args, 0,
                                           static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears the launch's error for the next caller
  return static_cast<int>(err != cudaSuccess ? err : last);
}
