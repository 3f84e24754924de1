// paged_decode: one decode step of attention over a paged K/V pool, as the
// unnormalised flash state (acc, m, l) of each lane and head.
//
// Replaces the Pallas TPU kernels of seldon_core_tpu/ops/kernels.py
// paged_attention_decode:
//   * K4, paged_decode_stream  <- _paged_decode_kernel_stream (grid = lanes,
//     page loop bounded by the lane's length), with its two static flags:
//     `quantized` (int8 pages, K4-int8) and `fold_lora` (the in-launch qkv
//     LoRA delta, K4-LoRA), alone or together;
//   * K5, paged_decode_grid    <- _paged_decode_kernel (grid = lanes x pages),
//     with `quantized` (K5-int8).
//
// Inputs (the JAX package's layout): q (B, h, hd) already scaled, float32 or
// bfloat16; the pool pk / pv (num_pages, ps, h, hd) in q's dtype, or int8
// with one float32 scale per page for K and for V (sk / sv, (num_pages,));
// block tables (B, P) int32 of page ids; lengths (B,) int32 of cached tokens.
// A lane reads positions [0, min(len, P * ps)) through its table row, page id
// table[pos / ps], row pos % ps -- the same positions the TPU kernels read,
// whose loops are bounded by the table's P pages.  An int8 element enters as
// float(k) * sk[page], one float32 product, as the TPU kernel dequantises
// in-register.  Outputs in float32: acc (B, h, hd) = sum_t exp(s_t - m) v_t,
// m (B, h) = max_t s_t, l (B, h) = sum_t exp(s_t - m) with s_t = q . k_t; a
// lane of length 0 gives m = -inf, l = 0, acc = 0.
//
// The LoRA fold (stream kernel only): x (B, D) float32 block inputs, D = h *
// hd; the adapter pool's qkv factors A (slots, D, r) and B (slots, r, 3D)
// float32, read in that layout (no transposed copy); adapter slot ids (B,)
// int32.  Each block computes its lane's rank-r t = A[slot]^T x, then the
// delta = t B[slot] of its own head's hd columns in each third (q, k, v) of
// the (B, 3D) float32 delta output -- the whole delta comes out of this one
// launch -- and scores with q + q_scale * delta_q.  Slot 0 holds zero
// factors, so its lanes get a delta of exactly 0.
//
// Bound: memory.  Each live K/V row is read once (2 * len * h * hd elements
// a lane, one byte each for int8) for 4 flops per element, far below the
// card's flops per byte; the fold adds the distinct slots' qkv factors and
// the x rows (4 * r * D flops a block).
//
// Design.  Where the TPU kernel is one sequential grid step per lane (or per
// lane and page) with its carry in VMEM, here a block of 128 threads owns one
// (lane, head) (K4) or one (lane, page) (K5) and walks the lane's positions a
// tile of 64 at a time.  For a tile it looks up each row's page through the
// table once -- its pool offset and, for int8 pages, its two scales -- stages
// the K rows as float32 in shared memory (16-byte loads, four in flight per
// thread, so a tile costs about one memory latency; 16 bytes are 4 float32, 8
// bfloat16 or 16 int8 elements; rows padded by one word so that thread t
// reading row t hits its own bank), scores one row per thread, stages the V
// rows over the spent K rows, takes the tile's max and weights by the
// online-softmax rule, and sums the weighted V rows with each thread owning
// one (row group, dim) pair.  Rows are addressed one by one through the
// table, so any page size works.  K5 writes one partial state per (lane,
// page, head), -inf / 0 / 0 past the lane's length, and a second launch
// merges a lane's pages by the flash rule (split-K flash-decoding).  Scores,
// max, weights and sums are float32 throughout; only positions below the
// length enter, so no NaN can arise.  The fold's sums run in a fixed order
// (per-thread partials, warp shuffles, then the four warps in turn), so a
// lane's delta is the same bits in every block and every run.
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
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // token rows staged in shared memory at once
constexpr int kMaxHeadDim = 128;
constexpr int kMaxRank = 64;       // LoRA rank the fold takes
constexpr int kRankStep = 8;       // ranks reduced per pass of the fold

enum Kind { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

struct Smem {
  float kv[kTile * (kMaxHeadDim + 1)];  // K tile, then V tile; one padding word per row
  int64_t off[kTile];                   // pool offset of each row of the tile
  float sk[kTile];                      // int8 pages: the K and V scale of each row's page
  float sv[kTile];
  float p[kTile];                       // the tile's scores, then its weights
  float q[kMaxHeadDim];
  float red[2];                         // tile max, tile sum (broadcast)
  float t[kMaxRank];                    // LoRA fold: the lane's A^T x
  float lred[kWarps][kRankStep];        // LoRA fold: per-warp partial sums
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 loaded bytes -> float32: 4 floats, 8 bf16 (low half first) or 16 int8
// (lowest byte first).
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

__device__ __forceinline__ void unpack16(const uint4& r, float* out, int8_t) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      // the byte moved to the top, then an arithmetic shift: its signed value
      out[4 * j + b] = static_cast<float>(static_cast<int32_t>(w[j] << (24 - 8 * b)) >> 24);
    }
  }
}

// Copy n rows of hd elements, row t at pool + sm.off[t], into dst as float32
// (row stride hd + 1); with kQuant each element times its row's page scale
// scale[t].  With `vec`, every thread first issues up to four independent
// 16-byte loads, then converts them, so a tile costs about one memory
// latency; otherwise element by element.
template <typename T, bool kQuant>
__device__ __forceinline__ void stage_rows(const T* __restrict__ pool, const Smem& sm, int n, int hd,
                                           bool vec, const float* scale, float* __restrict__ dst) {
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
          float* out = dst + t * (hd + 1) + (i - t * per_row) * kVec;
          unpack16(raw[u], out, T());
          if (kQuant) {
            const float s = scale[t];
#pragma unroll
            for (int e = 0; e < kVec; ++e) out[e] *= s;
          }
        }
      }
    }
  } else {
    for (int i = tid; i < n * hd; i += kThreads) {
      const int t = i / hd;
      const int c = i - t * hd;
      const float v = to_f32(pool[sm.off[t] + c]);
      dst[t * (hd + 1) + c] = kQuant ? v * scale[t] : v;
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
// g = tid / hd.  sk / sv: the int8 pool's per-page scales (kQuant only).
template <typename T, bool kQuant>
__device__ void attend_range(const T* __restrict__ pk, const T* __restrict__ pv,
                             const float* __restrict__ sk, const float* __restrict__ sv,
                             const int* __restrict__ table, int ps, int heads, int hd,
                             int head, int lo, int hi, bool vec, Smem& sm,
                             float& m, float& l, float& acc) {
  const int tid = threadIdx.x;
  const int groups = kThreads / hd;
  const int g = tid / hd;
  const int d = tid - g * hd;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);  // <= kTile < kThreads: one thread per row below
    if (tid < n) {
      // the row's page, looked up once: its pool offset and its scales
      const int pos = t0 + tid;
      const int64_t page = table[pos / ps];
      sm.off[tid] = ((page * ps + pos % ps) * heads + head) * static_cast<int64_t>(hd);
      if (kQuant) {
        sm.sk[tid] = sk[page];
        sm.sv[tid] = sv[page];
      }
    }
    __syncthreads();
    stage_rows<T, kQuant>(pk, sm, n, hd, vec, sm.sk, sm.kv);
    __syncthreads();
    if (tid < n) {
      const float* kr = sm.kv + tid * (hd + 1);
      float s = 0.f;
      for (int c = 0; c < hd; ++c) s = fmaf(sm.q[c], kr[c], s);
      sm.p[tid] = s;
    }
    __syncthreads();
    stage_rows<T, kQuant>(pv, sm, n, hd, vec, sm.sv, sm.kv);  // K is spent: V takes its place
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

// The LoRA fold of one (lane, head) block: sm.t = A^T x over D, then this
// head's hd columns of each third of the delta written out, and the q third
// folded into sm.q as q + q_scale * delta_q.
struct LoraArgs {
  const float* x;        // (B, D)
  const float* a;        // (slots, D, rank)
  const float* b;        // (slots, rank, 3D)
  const int* idx;        // (B,)
  float* delta;          // (B, 3D)
  int rank;
  int slots;
  float q_scale;
};

__device__ void lora_fold(const LoraArgs& lo, int b, int head, int heads, int hd, Smem& sm) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int D = heads * hd;
  const int r = lo.rank;
  const int slot = min(max(lo.idx[b], 0), lo.slots - 1);  // an out-of-range id reads a real slot
  const float* x = lo.x + static_cast<int64_t>(b) * D;
  const float* A = lo.a + static_cast<int64_t>(slot) * D * r;
  const float* Bf = lo.b + static_cast<int64_t>(slot) * r * 3 * D;
  for (int r0 = 0; r0 < r; r0 += kRankStep) {
    float part[kRankStep];
#pragma unroll
    for (int u = 0; u < kRankStep; ++u) part[u] = 0.f;
    for (int d = tid; d < D; d += kThreads) {
      const float xd = x[d];
      const float* row = A + static_cast<int64_t>(d) * r + r0;
#pragma unroll
      for (int u = 0; u < kRankStep; ++u) {
        if (r0 + u < r) part[u] = fmaf(xd, row[u], part[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRankStep; ++u) {
      const float v = warp_sum(part[u]);
      if ((tid & 31) == 0) sm.lred[warp][u] = v;
    }
    __syncthreads();
    if (tid < kRankStep && r0 + tid < r) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += sm.lred[w][tid];
      sm.t[r0 + tid] = s;
    }
    __syncthreads();
  }
  float* delta = lo.delta + static_cast<int64_t>(b) * 3 * D;
  for (int i = tid; i < 3 * hd; i += kThreads) {
    const int third = i / hd;
    const int c = i - third * hd;
    const int64_t col = static_cast<int64_t>(third) * D + head * hd + c;
    float s = 0.f;
    for (int k = 0; k < r; ++k) s = fmaf(sm.t[k], Bf[static_cast<int64_t>(k) * 3 * D + col], s);
    delta[col] = s;
    if (third == 0) sm.q[c] = __fadd_rn(sm.q[c], __fmul_rn(lo.q_scale, s));
  }
  __syncthreads();
}

// K4: one block per (head, lane); the page loop is bounded by the lane's length.
template <typename TQ, typename TP, bool kQuant, bool kLora>
__global__ void __launch_bounds__(kThreads)
paged_decode_stream_kernel(const TQ* __restrict__ q, const TP* __restrict__ pk,
                           const TP* __restrict__ pv, const float* __restrict__ sk,
                           const float* __restrict__ sv, const int* __restrict__ tables,
                           const int* __restrict__ lengths, float* __restrict__ acc_out,
                           float* __restrict__ m_out, float* __restrict__ l_out, LoraArgs lora,
                           int heads, int hd, int table_pages, int ps, bool vec) {
  __shared__ Smem sm;
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t lane_head = static_cast<int64_t>(b) * heads + head;
  stage_q(q, lane_head * hd, hd, sm);
  if (kLora) lora_fold(lora, b, head, heads, hd, sm);
  const int64_t len = lengths[b] > 0 ? lengths[b] : 0;
  const int64_t cap = static_cast<int64_t>(table_pages) * ps;
  const int hi = static_cast<int>(len < cap ? len : cap);
  float m = -INFINITY, l = 0.f, acc = 0.f;
  attend_range<TP, kQuant>(pk, pv, sk, sv, tables + static_cast<int64_t>(b) * table_pages, ps, heads,
                           hd, head, 0, hi, vec, sm, m, l, acc);
  reduce_acc(acc, hd, sm, acc_out + lane_head * hd);
  if (threadIdx.x == 0) {
    m_out[lane_head] = m;
    l_out[lane_head] = l;
  }
}

// K5, first launch: one block per (page, lane), every head; the partial
// state of positions [p * ps, (p + 1) * ps) below the lane's length.
template <typename TQ, typename TP, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_decode_grid_kernel(const TQ* __restrict__ q, const TP* __restrict__ pk,
                         const TP* __restrict__ pv, const float* __restrict__ sk,
                         const float* __restrict__ sv, const int* __restrict__ tables,
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
    attend_range<TP, kQuant>(pk, pv, sk, sv, table, ps, heads, hd, head, lo, hi, vec, sm, m, l, acc);
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

// q in float32 or bfloat16; the pool in q's dtype, or int8 with scales.
bool bad_kinds(int q_kind, int pool_kind, const void* sk, const void* sv) {
  if (q_kind != kF32 && q_kind != kBF16) return true;
  if (pool_kind == kI8) return sk == nullptr || sv == nullptr;
  return pool_kind != q_kind;
}

struct Launch {
  const void *q, *pk, *pv;
  const float *sk, *sv;
  const int *tables, *lengths;
  float *acc, *m, *l;
  float *part_acc, *part_m, *part_l;  // K5 only
  LoraArgs lora;                      // K4 only; lora.x == nullptr: no fold
  int heads, hd, table_pages, ps;
  bool vec;
  dim3 grid;
  cudaStream_t s;
};

template <typename TQ, typename TP, bool kQuant>
void launch_stream(const Launch& a) {
  const TQ* q = static_cast<const TQ*>(a.q);
  const TP* pk = static_cast<const TP*>(a.pk);
  const TP* pv = static_cast<const TP*>(a.pv);
  if (a.lora.x != nullptr) {
    paged_decode_stream_kernel<TQ, TP, kQuant, true><<<a.grid, kThreads, 0, a.s>>>(
        q, pk, pv, a.sk, a.sv, a.tables, a.lengths, a.acc, a.m, a.l, a.lora, a.heads, a.hd,
        a.table_pages, a.ps, a.vec);
  } else {
    paged_decode_stream_kernel<TQ, TP, kQuant, false><<<a.grid, kThreads, 0, a.s>>>(
        q, pk, pv, a.sk, a.sv, a.tables, a.lengths, a.acc, a.m, a.l, a.lora, a.heads, a.hd,
        a.table_pages, a.ps, a.vec);
  }
}

template <typename TQ, typename TP, bool kQuant>
void launch_grid(const Launch& a) {
  paged_decode_grid_kernel<TQ, TP, kQuant><<<a.grid, kThreads, 0, a.s>>>(
      static_cast<const TQ*>(a.q), static_cast<const TP*>(a.pk), static_cast<const TP*>(a.pv), a.sk,
      a.sv, a.tables, a.lengths, a.part_acc, a.part_m, a.part_l, a.heads, a.hd, a.table_pages, a.ps,
      a.vec);
}

// Instantiate `fn` for the (q, pool) kinds: f32/f32, bf16/bf16, f32/int8, bf16/int8.
template <template <typename, typename, bool> class F>
void dispatch(int q_kind, int pool_kind, const Launch& a) {
  if (pool_kind == kI8) {
    if (q_kind == kF32) F<float, int8_t, true>::run(a);
    else F<__nv_bfloat16, int8_t, true>::run(a);
  } else if (q_kind == kF32) {
    F<float, float, false>::run(a);
  } else {
    F<__nv_bfloat16, __nv_bfloat16, false>::run(a);
  }
}

template <typename TQ, typename TP, bool kQuant>
struct StreamLaunch {
  static void run(const Launch& a) { launch_stream<TQ, TP, kQuant>(a); }
};

template <typename TQ, typename TP, bool kQuant>
struct GridLaunch {
  static void run(const Launch& a) { launch_grid<TQ, TP, kQuant>(a); }
};

int pool_elt_bytes(int pool_kind) { return pool_kind == kF32 ? 4 : pool_kind == kBF16 ? 2 : 1; }

}  // namespace

// sk / sv: (num_pages,) float32 scales when pool_kind is 2 (int8), else null.
// x / lora_a / lora_b / adapter_idx / delta: the LoRA fold's inputs and its
// (B, 3 * heads * head_dim) output, or all null for no fold.
extern "C" int paged_decode_stream(const void* q, const void* pk, const void* pv,
                                   const void* tables, const void* lengths, void* acc,
                                   void* m, void* l, const void* sk, const void* sv,
                                   const void* x, const void* lora_a, const void* lora_b,
                                   const void* adapter_idx, void* delta, int batch, int heads,
                                   int head_dim, int table_pages, int page_size, int q_kind,
                                   int pool_kind, int rank, int slots, float q_scale,
                                   void* stream) {
  const bool fold = x != nullptr;
  if (bad_shape(batch, heads, head_dim, table_pages, page_size) || bad_kinds(q_kind, pool_kind, sk, sv) ||
      (fold && (lora_a == nullptr || lora_b == nullptr || adapter_idx == nullptr || delta == nullptr ||
                rank < 1 || rank > kMaxRank || slots < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  Launch a{};
  a.q = q;
  a.pk = pk;
  a.pv = pv;
  a.sk = static_cast<const float*>(sk);
  a.sv = static_cast<const float*>(sv);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.acc = static_cast<float*>(acc);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.lora = LoraArgs{static_cast<const float*>(x), static_cast<const float*>(lora_a),
                    static_cast<const float*>(lora_b), static_cast<const int*>(adapter_idx),
                    static_cast<float*>(delta), rank, slots, q_scale};
  a.heads = heads;
  a.hd = head_dim;
  a.table_pages = table_pages;
  a.ps = page_size;
  a.vec = vector_rows(pk, pv, head_dim, pool_elt_bytes(pool_kind));
  a.grid = dim3(heads, batch);
  a.s = static_cast<cudaStream_t>(stream);
  dispatch<StreamLaunch>(q_kind, pool_kind, a);
  return static_cast<int>(cudaGetLastError());
}

// part_acc (B, P, h, hd), part_m / part_l (B, P, h): float32 scratch.
extern "C" int paged_decode_grid(const void* q, const void* pk, const void* pv,
                                 const void* tables, const void* lengths, void* acc, void* m,
                                 void* l, void* part_acc, void* part_m, void* part_l,
                                 const void* sk, const void* sv, int batch, int heads,
                                 int head_dim, int table_pages, int page_size, int q_kind,
                                 int pool_kind, void* stream) {
  if (bad_shape(batch, heads, head_dim, table_pages, page_size) || table_pages > 65535 ||
      bad_kinds(q_kind, pool_kind, sk, sv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  Launch a{};
  a.q = q;
  a.pk = pk;
  a.pv = pv;
  a.sk = static_cast<const float*>(sk);
  a.sv = static_cast<const float*>(sv);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.heads = heads;
  a.hd = head_dim;
  a.table_pages = table_pages;
  a.ps = page_size;
  a.vec = vector_rows(pk, pv, head_dim, pool_elt_bytes(pool_kind));
  a.grid = dim3(table_pages, batch);
  a.s = static_cast<cudaStream_t>(stream);
  dispatch<GridLaunch>(q_kind, pool_kind, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_merge_kernel<<<dim3(heads, batch), kThreads, 0, a.s>>>(
      a.part_acc, a.part_m, a.part_l, static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), heads, head_dim, table_pages);
  return static_cast<int>(cudaGetLastError());
}
