// flash_attention: blockwise self- or cross-attention with an online softmax
// (K3), causal or not.
//
// Replaces the Pallas TPU kernel of seldon_core_tpu/ops/kernels.py
// flash_attention (:255; kernel body _flash_kernel :195, pallas_call :309).
//
// For every batch b, head h and query row i it computes
//   s_ij = (q[b,i,h,:] * scale) . k[b,j,h,:]        scale = 1/sqrt(head_dim)
//   o[b,i,h,:] = sum_j exp(s_ij - m_i) v[b,j,h,:] / sum_j exp(s_ij - m_i)
// with m_i = max_j s_ij, s_ij = -inf for keys j >= Lk and, when causal, for
// j > i; a row whose weights are all zero writes 0.  q is (B, Lq, H, D), k and
// v (B, Lk, H, D), o (B, Lq, H, D): any element strides on B, L and H, unit
// stride on D (the layout the transformer's qkv split gives, read where it
// lies).  f32, bf16 or f16 in; f32 inside; o in the input's dtype.
//
// Bound: memory.  At the ViT-B/16 serving shape (B=32, L=197, H=12, D=64,
// bf16) q, k, v and o are 38.7 MB, 11.6 us at 3.35 TB/s, against 3.8 GFLOP,
// 3.9 us on the bf16 tensor cores.  This first kernel reaches neither: it
// does both products as scalar f32 FMAs on the CUDA cores, fed from shared
// memory, so it is bound by shared-memory reads and the f32 issue rate.
// Moving the products onto the tensor cores (mma / wgmma, with TMA-staged,
// double-buffered K/V tiles) is the work of a later PR.
//
// Design.  The TPU kernel runs a (batch*head, q block, kv block) grid whose
// innermost kv axis is sequential, carrying the softmax state in VMEM across
// steps.  Here one block of 128 threads owns one (batch*head, tile of 64
// query rows) and walks the key tiles in a loop, the carry in registers:
//   * the Q tile is staged once as f32, already multiplied by the scale (the
//     TPU kernel's q.astype(f32) * scale);
//   * each K and V tile of 64 rows is staged as f32 in shared memory with
//     16-byte loads where the rows are aligned (element loads otherwise);
//     rows past Lk read as 0 and their scores are masked, so a 197-token
//     input is never padded or copied;
//   * thread t owns 8 query rows (row group t / 16) and, for the scores, 4
//     key columns (t % 16 + 16 j); a row's max and sum are reduced across
//     the 16 threads of its row group with shuffles;
//   * the online-softmax update keeps the TPU kernel's infinity guards:
//     safe_m = new_m if finite else 0, weight 0 for a non-finite score,
//     correction 0 while the running max is -inf, and l == 0 -> output 0,
//     so no input (L = 1, fully masked rows) produces a NaN;
//   * the weights go through shared memory, and each thread accumulates its
//     8 rows x head_dim/16 output columns (a compile-time count of 1, 2, 4
//     or 8, so no FMA is spent on columns past head_dim);
//   * causal tiles that lie wholly above the diagonal are skipped, as the
//     TPU kernel's `needed` predicate does.
// Q, K and V tiles of 64 x 128 f32 plus the weight tile are 115 KB at
// head_dim 128, above the 48 KB of static shared memory: the tiles are
// dynamic shared memory, sized by head_dim, with the kernel's limit raised
// by cudaFuncSetAttribute before the launch.
//
// C interface (bound with ctypes): flash_attention_fwd returns the
// cudaError_t of its launch.  The caller makes the tensors' device current
// and passes PyTorch's current stream; nothing here allocates.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;          // query rows per block, key rows per tile
constexpr int kMaxHeadDim = 128;
constexpr int kRows = 8;           // query rows per thread: 8 row groups x 8 rows
constexpr int kLanes = 16;         // threads sharing one row group
constexpr int kCols = kTile / kLanes;  // key columns per thread in a score tile
constexpr int kPLd = kTile + 2;    // weight-tile row stride: the two half-warps hit disjoint banks

enum Kind { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Strides {
  long long b, l, h;  // element strides of the batch, sequence and head axes
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int heads, lq, lk, hd;
  float scale;
  bool causal;
  bool vec_q, vec_k, vec_v;  // 16-byte row loads are aligned
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

// 16 loaded bytes -> float32: 4 floats, or 8 bf16 / f16 values (low half first).
__device__ __forceinline__ void unpack16(const uint4& r, float* out, float) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack16(const uint4& r, float* out, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j] = __uint_as_float(w[j] << 16);
    out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack16(const uint4& r, float* out, __half) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[j] & 0xffffu)));
    out[2 * j + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[j] >> 16)));
  }
}

// Stage rows [row0, row0 + 64) of one (batch, head) slice into dst as float32
// times `mul` (row stride ld); rows at or past n_rows become 0.  With `vec`
// every thread issues up to four independent 16-byte loads before converting
// them, so a tile costs about one memory latency.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ base, long long row_stride, int row0,
                                           int n_rows, int hd, bool vec, float mul,
                                           float* __restrict__ dst, int ld) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = hd / kVec;
    const int total = kTile * per_row;
    for (int first = tid; first < total; first += 4 * kThreads) {
      uint4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = first + u * kThreads;
        const int r = i / per_row;
        if (i < total && row0 + r < n_rows) {
          const int c = (i - r * per_row) * kVec;
          raw[u] = __ldg(reinterpret_cast<const uint4*>(base + (row0 + r) * row_stride + c));
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = first + u * kThreads;
        if (i >= total) break;
        const int r = i / per_row;
        const int c = (i - r * per_row) * kVec;
        float vals[kVec];
        if (row0 + r < n_rows) {
          unpack16(raw[u], vals, T());
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) vals[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < kVec; ++j) dst[r * ld + c + j] = vals[j] * mul;
      }
    }
  } else {
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int r = i / hd;
      const int c = i - r * hd;
      dst[r * ld + c] = row0 + r < n_rows ? to_f32(base[(row0 + r) * row_stride + c]) * mul : 0.f;
    }
  }
}

__device__ __forceinline__ float group_max(float v) {  // over the 16 lanes of a row group
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kSlots: output columns per thread, ceil(head_dim / 16).
template <typename T, int kSlots>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Params p) {
  extern __shared__ float smem[];
  const int hd = p.hd;
  const int ld = hd + 1;  // padded rows: the 16 key rows a half-warp reads lie in distinct banks
  float* qs = smem;                // [64][hd + 1], scaled
  float* ks = qs + kTile * ld;     // [64][hd + 1]
  float* vs = ks + kTile * ld;     // [64][hd]
  float* ps = vs + kTile * hd;     // [64][kPLd], the tile's weights

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.y * kTile;
  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  T* o = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int r0 = (tid / kLanes) * kRows;  // this thread's first query row in the tile

  stage_tile(q, p.sq.l, q0, p.lq, hd, p.vec_q, p.scale, qs, ld);

  float m[kRows], l[kRows], acc[kRows][kSlots];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) acc[i][t] = 0.f;
  }

  // causal: key tiles wholly above the diagonal contribute nothing
  const int kv_end = p.causal ? min(p.lk, q0 + kTile) : p.lk;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // Q is staged; the previous tile's K, V and weights are spent
    stage_tile(k, p.sk.l, k0, p.lk, hd, p.vec_k, 1.f, ks, ld);
    stage_tile(v, p.sv.l, k0, p.lk, hd, p.vec_v, 1.f, vs, hd);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float kd[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kd[j] = ks[(lane + kLanes * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qd = qs[(r0 + i) * ld + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qd, kd[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + r0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + lane + kLanes * j;
        if (kj >= p.lk || (p.causal && kj > qi)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float new_m = fmaxf(m[i], group_max(mx));
      const float safe_m = isfinite(new_m) ? new_m : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float w = isfinite(s[i][j]) ? expf(s[i][j] - safe_m) : 0.f;
        ps[(r0 + i) * kPLd + lane + kLanes * j] = w;
        sum += w;
      }
      const float correction = isfinite(m[i]) ? expf(m[i] - safe_m) : 0.f;
      l[i] = l[i] * correction + group_sum(sum);
      m[i] = new_m;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) acc[i][t] *= correction;
    }
    __syncthreads();  // the tile's weights are in shared memory

    for (int c = 0; c < kTile; ++c) {
      float vd[kSlots];
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int d = lane + kLanes * t;
        vd[t] = d < hd ? vs[c * hd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float w = ps[(r0 + i) * kPLd + c];
#pragma unroll
        for (int t = 0; t < kSlots; ++t) acc[i][t] = fmaf(w, vd[t], acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= p.lq) break;
    const float denom = l[i] > 0.f ? l[i] : 1.f;  // a row with no live key writes 0
    T* row = o + qi * p.so.l;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int d = lane + kLanes * t;
      if (d < hd) store(row + d, acc[i][t] / denom);
    }
  }
}

size_t smem_bytes(int hd) {
  return sizeof(float) * (2 * kTile * (hd + 1) + kTile * hd + kTile * kPLd);
}

template <typename T, int kSlots>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.hd);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, kSlots>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * p.heads, (p.lq + kTile - 1) / kTile);
  flash_attention_kernel<T, kSlots><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const Params& p, int batch, cudaStream_t stream) {
  const int slots = (p.hd + kLanes - 1) / kLanes;
  if (slots <= 1) return launch<T, 1>(p, batch, stream);
  if (slots <= 2) return launch<T, 2>(p, batch, stream);
  if (slots <= 4) return launch<T, 4>(p, batch, stream);
  return launch<T, 8>(p, batch, stream);
}

// Rows of a tensor can be read as aligned 16-byte vectors.
bool vector_rows(const void* ptr, const long long* strides, int hd, int elt_bytes) {
  const int vec = 16 / elt_bytes;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && hd % vec == 0 && strides[0] % vec == 0 &&
         strides[1] % vec == 0 && strides[2] % vec == 0;
}

}  // namespace

// strides: 12 element strides, (batch, sequence, head) of q, k, v and o in
// that order; the head_dim axis has unit stride in all four.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const long long* strides, int batch, int heads, int lq, int lk,
                                   int head_dim, int causal, float scale, int kind, void* stream) {
  if (batch < 0 || heads < 1 || lq < 0 || lk < 0 || head_dim < 8 || head_dim > kMaxHeadDim ||
      head_dim % 8 != 0 || static_cast<long long>(batch) * heads > 0x7fffffffLL ||
      (lq + kTile - 1) / kTile > 65535 || (causal && lq != lk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || lq == 0) return 0;
  const int elt = kind == kF32 ? 4 : 2;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.hd = head_dim;
  p.scale = scale;
  p.causal = causal != 0;
  p.vec_q = vector_rows(q, strides, head_dim, elt);
  p.vec_k = vector_rows(k, strides + 3, head_dim, elt);
  p.vec_v = vector_rows(v, strides + 6, head_dim, elt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case kF32:
      err = launch_typed<float>(p, batch, s);
      break;
    case kBF16:
      err = launch_typed<__nv_bfloat16>(p, batch, s);
      break;
    case kF16:
      err = launch_typed<__half>(p, batch, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
