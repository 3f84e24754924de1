// paged_decode: one decode step of attention over a paged K/V pool, as the
// unnormalised flash state (acc, m, l) of each lane and head.
//
// Replaces the Pallas TPU kernels of seldon_core_tpu/ops/kernels.py
// paged_attention_decode:
//   * K4, paged_decode_stream  <- _paged_decode_kernel_stream (grid = lanes,
//     page loop bounded by the lane's length);
//   * K5, paged_decode_grid    <- _paged_decode_kernel (grid = lanes x pages).
//
// Inputs (the JAX package's layout): q (B, h, hd) already scaled; the pool
// pk / pv (num_pages, ps, h, hd); block tables (B, P) int32 of page ids;
// lengths (B,) int32 of cached tokens.  A lane reads positions
// [0, min(len, P * ps)) through its table row, page id table[pos / ps], row
// pos % ps -- the same positions the TPU kernels read, whose loops are
// bounded by the table's P pages.  Outputs in float32: acc (B, h, hd) =
// sum_t exp(s_t - m) v_t, m (B, h) = max_t s_t, l (B, h) = sum_t exp(s_t - m)
// with s_t = q . k_t; a lane of length 0 gives m = -inf, l = 0, acc = 0.
//
// Bound: memory.  Each live K/V row is read once (2 * len * h * hd elements
// a lane) for 4 flops per element, far below the card's flops per byte.
//
// Design.  Where the TPU kernel is one sequential grid step per lane (or per
// lane and page) with its carry in VMEM, here a block of 128 threads owns one
// (lane, head) (K4) or one (lane, page) (K5) and walks the lane's positions a
// tile of 64 at a time.  For a tile it looks up each row's pool offset through
// the table once, stages the K rows as float32 in shared memory (16-byte loads,
// four in flight per thread, so a tile costs about one memory latency; rows
// padded by one word so that thread t reading row t hits its own bank),
// scores one row per thread, stages the V rows over the spent K rows, takes
// the tile's max and weights by the online-softmax rule, and sums the
// weighted V rows with each thread owning one (row group, dim) pair.  Rows are
// addressed one by one through the table, so any page size works.  K5 writes
// one partial state per (lane, page, head), -inf / 0 / 0 past the lane's
// length, and a second launch merges a lane's pages by the flash rule
// (split-K flash-decoding).  Scores, max, weights and sums are float32
// throughout; only positions below the length enter, so no NaN can arise.
//
// C interface (bound with ctypes): each entry point returns the cudaError_t of
// its launches.  The caller makes the tensors' device current, passes
// contiguous tensors and PyTorch's current stream; nothing here allocates.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;          // token rows staged in shared memory at once
constexpr int kMaxHeadDim = 128;

enum PoolKind { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Smem {
  float kv[kTile * (kMaxHeadDim + 1)];  // K tile, then V tile; one padding word per row
  int64_t off[kTile];                   // pool offset of each row of the tile
  float p[kTile];                       // the tile's scores, then its weights
  float q[kMaxHeadDim];
  float red[2];                         // tile max, tile sum (broadcast)
};

// Element offset of (pos, head, 0) in the pool, through the lane's table row.
__device__ __forceinline__ int64_t row_offset(const int* __restrict__ table, int pos, int ps,
                                              int heads, int hd, int head) {
  const int64_t page = table[pos / ps];
  return ((page * ps + pos % ps) * heads + head) * static_cast<int64_t>(hd);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 loaded bytes -> float32: 4 floats, or 8 bf16 (low half first).
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

// Copy n rows of hd elements, row t at pool + sm.off[t], into dst as float32
// (row stride hd + 1).  With `vec`, every thread first issues up to four
// independent 16-byte loads, then converts them, so a tile costs about one
// memory latency; otherwise element by element.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ pool, const Smem& sm, int n, int hd,
                                           bool vec, float* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  const int tid = threadIdx.x;
  if (vec) {
    const int per_row = hd / kVec;
    const int total = n * per_row;
    for (int base = tid; base < total; base += 4 * kThreads) {
      uint4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * kThreads;
        if (i < total) {
          const int t = i / per_row;
          raw[u] = __ldg(reinterpret_cast<const uint4*>(pool + sm.off[t]) + (i - t * per_row));
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * kThreads;
        if (i < total) {
          const int t = i / per_row;
          unpack16(raw[u], dst + t * (hd + 1) + (i - t * per_row) * kVec, T());
        }
      }
    }
  } else {
    for (int i = tid; i < n * hd; i += kThreads) {
      const int t = i / hd;
      const int c = i - t * hd;
      dst[t * (hd + 1) + c] = to_f32(pool[sm.off[t] + c]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_q(const T* __restrict__ q, int64_t base, int hd, Smem& sm) {
  if (threadIdx.x < hd) sm.q[threadIdx.x] = to_f32(q[base + threadIdx.x]);
  __syncthreads();
}

// Online-softmax update of (m, l, acc) over positions [lo, hi) of one lane
// and one head, a tile of up to 64 positions at a time.  m and l are the
// same in every thread; acc is this thread's (group g, dim d) partial,
// g = tid / hd.
template <typename T>
__device__ void attend_range(const T* __restrict__ pk, const T* __restrict__ pv,
                             const int* __restrict__ table, int ps, int heads, int hd,
                             int head, int lo, int hi, bool vec, Smem& sm,
                             float& m, float& l, float& acc) {
  const int tid = threadIdx.x;
  const int groups = kThreads / hd;
  const int g = tid / hd;
  const int d = tid - g * hd;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);  // <= kTile < kThreads: one thread per row below
    if (tid < n) sm.off[tid] = row_offset(table, t0 + tid, ps, heads, hd, head);
    __syncthreads();
    stage_rows(pk, sm, n, hd, vec, sm.kv);
    __syncthreads();
    if (tid < n) {
      const float* kr = sm.kv + tid * (hd + 1);
      float s = 0.f;
      for (int c = 0; c < hd; ++c) s = fmaf(sm.q[c], kr[c], s);
      sm.p[tid] = s;
    }
    __syncthreads();
    stage_rows(pv, sm, n, hd, vec, sm.kv);  // K is spent: V takes its place
    if (tid < 32) {
      float v = -INFINITY;
      for (int t = tid; t < n; t += 32) v = fmaxf(v, sm.p[t]);
      v = warp_max(v);
      if (tid == 0) sm.red[0] = v;
    }
    __syncthreads();
    const float m_new = fmaxf(m, sm.red[0]);  // finite: the tile holds >= 1 live token
    const float alpha = expf(m - m_new);      // 0 on the first tile (m = -inf)
    if (tid < n) sm.p[tid] = expf(sm.p[tid] - m_new);
    __syncthreads();
    if (tid < 32) {
      float v = 0.f;
      for (int t = tid; t < n; t += 32) v += sm.p[t];
      v = warp_sum(v);
      if (tid == 0) sm.red[1] = v;
    }
    if (g < groups) {
      float part = 0.f;
      for (int t = g; t < n; t += groups) part = fmaf(sm.p[t], sm.kv[t * (hd + 1) + d], part);
      acc = acc * alpha + part;
    }
    __syncthreads();  // sm.red[1] is ready; the next tile overwrites sm.kv, sm.p, sm.off
    l = l * alpha + sm.red[1];
    m = m_new;
  }
}

// Sum the groups' acc partials into out[0..hd); sm.kv is the scratch.
__device__ __forceinline__ void reduce_acc(float acc, int hd, Smem& sm, float* __restrict__ out) {
  const int tid = threadIdx.x;
  const int groups = kThreads / hd;
  const int g = tid / hd;
  if (g < groups) sm.kv[tid] = acc;  // == sm.kv[g * hd + d]
  __syncthreads();
  if (tid < hd) {
    float s = 0.f;
    for (int j = 0; j < groups; ++j) s += sm.kv[j * hd + tid];
    out[tid] = s;
  }
  __syncthreads();
}

// K4: one block per (head, lane); the page loop is bounded by the lane's length.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_stream_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                           const T* __restrict__ pv, const int* __restrict__ tables,
                           const int* __restrict__ lengths, float* __restrict__ acc_out,
                           float* __restrict__ m_out, float* __restrict__ l_out,
                           int heads, int hd, int table_pages, int ps, bool vec) {
  __shared__ Smem sm;
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t lane_head = static_cast<int64_t>(b) * heads + head;
  stage_q(q, lane_head * hd, hd, sm);
  const int64_t len = lengths[b] > 0 ? lengths[b] : 0;
  const int64_t cap = static_cast<int64_t>(table_pages) * ps;
  const int hi = static_cast<int>(len < cap ? len : cap);
  float m = -INFINITY, l = 0.f, acc = 0.f;
  attend_range(pk, pv, tables + static_cast<int64_t>(b) * table_pages, ps, heads, hd, head,
               0, hi, vec, sm, m, l, acc);
  reduce_acc(acc, hd, sm, acc_out + lane_head * hd);
  if (threadIdx.x == 0) {
    m_out[lane_head] = m;
    l_out[lane_head] = l;
  }
}

// K5, first launch: one block per (page, lane), every head; the partial
// state of positions [p * ps, (p + 1) * ps) below the lane's length.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_grid_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                         const T* __restrict__ pv, const int* __restrict__ tables,
                         const int* __restrict__ lengths, float* __restrict__ part_acc,
                         float* __restrict__ part_m, float* __restrict__ part_l,
                         int heads, int hd, int table_pages, int ps, bool vec) {
  __shared__ Smem sm;
  const int p = blockIdx.x;
  const int b = blockIdx.y;
  const int len = max(lengths[b], 0);
  const int lo = p * ps;
  const int hi = min(len, lo + ps);  // <= lo: the page is past the lane's length
  const int* table = tables + static_cast<int64_t>(b) * table_pages;
  for (int head = 0; head < heads; ++head) {
    stage_q(q, (static_cast<int64_t>(b) * heads + head) * hd, hd, sm);
    float m = -INFINITY, l = 0.f, acc = 0.f;
    attend_range(pk, pv, table, ps, heads, hd, head, lo, hi, vec, sm, m, l, acc);
    const int64_t slot = (static_cast<int64_t>(b) * table_pages + p) * heads + head;
    reduce_acc(acc, hd, sm, part_acc + slot * hd);
    if (threadIdx.x == 0) {
      part_m[slot] = m;
      part_l[slot] = l;
    }
  }
}

// K5, second launch: one block per (head, lane) merges the lane's page
// partials by the flash rule; a lane with no live page keeps -inf / 0 / 0.
__global__ void __launch_bounds__(kThreads)
paged_decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                          const float* __restrict__ part_l, float* __restrict__ acc_out,
                          float* __restrict__ m_out, float* __restrict__ l_out,
                          int heads, int hd, int table_pages) {
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int64_t lane_head = static_cast<int64_t>(b) * heads + head;
  const int64_t first = static_cast<int64_t>(b) * table_pages * heads + head;  // slot of page 0
  float mx = -INFINITY;
  for (int p = 0; p < table_pages; ++p) mx = fmaxf(mx, part_m[first + static_cast<int64_t>(p) * heads]);
  float l = 0.f, acc = 0.f;
  if (mx != -INFINITY) {
    for (int p = 0; p < table_pages; ++p) {
      const int64_t slot = first + static_cast<int64_t>(p) * heads;
      const float w = expf(part_m[slot] - mx);  // 0 for an empty page (-inf)
      l = fmaf(w, part_l[slot], l);
      if (d < hd) acc = fmaf(w, part_acc[slot * hd + d], acc);
    }
  }
  if (d < hd) acc_out[lane_head * hd + d] = acc;
  if (d == 0) {
    m_out[lane_head] = mx;
    l_out[lane_head] = l;
  }
}

// Rows can be read as 16-byte vectors: whole vectors per row, aligned pools.
bool vector_rows(const void* pk, const void* pv, int head_dim, int elt_bytes) {
  return head_dim % (16 / elt_bytes) == 0 && reinterpret_cast<uintptr_t>(pk) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(pv) % 16 == 0;
}

bool bad_shape(int batch, int heads, int head_dim, int table_pages, int page_size) {
  return batch < 0 || batch > 65535 || heads < 1 || head_dim < 1 || head_dim > kMaxHeadDim ||
         table_pages < 1 || page_size < 1;
}

}  // namespace

extern "C" int paged_decode_stream(const void* q, const void* pk, const void* pv,
                                   const void* tables, const void* lengths, void* acc,
                                   void* m, void* l, int batch, int heads, int head_dim,
                                   int table_pages, int page_size, int pool_kind,
                                   void* stream) {
  if (bad_shape(batch, heads, head_dim, table_pages, page_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const dim3 grid(heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* a = static_cast<float*>(acc);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  switch (pool_kind) {
    case kF32:
      paged_decode_stream_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(pk),
          static_cast<const float*>(pv), tb, ln, a, mo, lo, heads, head_dim, table_pages,
          page_size, vector_rows(pk, pv, head_dim, 4));
      break;
    case kBF16:
      paged_decode_stream_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pk),
          static_cast<const __nv_bfloat16*>(pv), tb, ln, a, mo, lo, heads, head_dim,
          table_pages, page_size, vector_rows(pk, pv, head_dim, 2));
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// part_acc (B, P, h, hd), part_m / part_l (B, P, h): float32 scratch.
extern "C" int paged_decode_grid(const void* q, const void* pk, const void* pv,
                                 const void* tables, const void* lengths, void* acc, void* m,
                                 void* l, void* part_acc, void* part_m, void* part_l,
                                 int batch, int heads, int head_dim, int table_pages,
                                 int page_size, int pool_kind, void* stream) {
  if (bad_shape(batch, heads, head_dim, table_pages, page_size) || table_pages > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  const dim3 pages(table_pages, batch);
  switch (pool_kind) {
    case kF32:
      paged_decode_grid_kernel<float><<<pages, kThreads, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(pk),
          static_cast<const float*>(pv), tb, ln, pa, pm, pl, heads, head_dim, table_pages,
          page_size, vector_rows(pk, pv, head_dim, 4));
      break;
    case kBF16:
      paged_decode_grid_kernel<__nv_bfloat16><<<pages, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pk),
          static_cast<const __nv_bfloat16*>(pv), tb, ln, pa, pm, pl, heads, head_dim,
          table_pages, page_size, vector_rows(pk, pv, head_dim, 2));
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_merge_kernel<<<dim3(heads, batch), kThreads, 0, s>>>(
      pa, pm, pl, static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
      heads, head_dim, table_pages);
  return static_cast<int>(cudaGetLastError());
}
