// paged_decode: one decode step of attention over a paged K/V pool, as the
// unnormalised flash state (acc, m, l) of each lane and head.
//
// Replaces the Pallas TPU kernels of seldon_core_tpu/ops/kernels.py
// paged_attention_decode:
//   * K4, the stream impl   <- _paged_decode_kernel_stream (grid = lanes,
//     page loop bounded by the lane's length), with its two static flags:
//     `quantized` (int8 pages, K4-int8) and `fold_lora` (the in-launch qkv
//     LoRA delta, K4-LoRA), alone or together;
//   * K5, the grid impl     <- _paged_decode_kernel (grid = lanes x pages),
//     with `quantized` (K5-int8).
// Both are one launch of the kernel below: K5 with chunks of one page, K4
// with chunks of `chunk_pages` pages (chosen by the host from the geometry).
//
// Inputs (the JAX package's layout): q (B, h, hd) already scaled, float32 or
// bfloat16; the pool pk / pv (num_pages, ps, h, hd) in q's dtype, or int8
// with one float32 scale per page for K and for V (sk / sv, (num_pages,));
// block tables (B, P) int32 of page ids; lengths (B,) int32 of cached tokens.
// A lane reads positions [0, min(len, P * ps)) through its table row, page id
// table[pos / ps], row pos % ps -- the same positions the TPU kernels read,
// whose loops are bounded by the table's P pages.  Outputs in float32: acc
// (B, h, hd) = sum_t exp(s_t - m) v_t, m (B, h) = max_t s_t, l (B, h) = sum_t
// exp(s_t - m) with s_t = q . k_t; a lane of length 0 gives m = -inf, l = 0,
// acc = 0.  int8 pages enter with their page's scale applied once: s_t =
// sk[page] * (q . k_int), and the weight of a V row is exp(s_t - m) * sv[page]
// (the plain version multiplies every element by its scale first; the two
// differ by float32 rounding only).
//
// The LoRA fold (K4 only): x (B, D) float32 block inputs, D = h * hd; the
// adapter pool's qkv factors A (slots, D, r) and B (slots, r, 3D) float32,
// read in that layout; adapter slot ids (B,) int32.  Every block of a lane
// computes the lane's rank-r t = A[slot]^T x in one fixed order (the first
// four warps: per-thread partials over D, warp shuffles, the four warps in
// turn), so t is the same bits in every block, then its heads' columns of
// delta_q = t B[slot] and scores with q + q_scale * delta_q.  The lane's
// first chunk writes the (B, 3D) float32 delta for its heads (all three
// thirds).  Slot 0 holds zero factors, so its lanes get a delta of exactly 0.
//
// Bound: memory.  Each live K/V row is read once (2 * len * h * hd elements
// a lane, one byte each for int8) for 4 flops per element, far below the
// card's flops per byte; the fold adds the distinct slots' qkv factors and
// the x rows.
//
// Design.  The TPU kernel takes one lane per program and double-buffers
// whole pages (all heads) by DMA.  Here a lane is split across blocks at a
// granularity fixed by the geometry alone: a block of 256 threads owns one
// (lane, chunk of G pages, group of HG heads), so a lane of 16 pages is 16
// chunks running side by side (G = 1) and no lane sets the pace.  HG is the
// most heads whose share of a pool row is at most 256 elements and 512
// bytes (4 heads of 64 in bf16 or int8), so at 16 lanes of 8 pages there
// are 256 blocks, and two fit an SM (64 KB of shared memory each at pages
// of 64).
//   * Copies.  A tile is T rows (positions) of the chunk; its K and V rows,
//     each the group's HG * hd contiguous elements of a pool row, are asked
//     for together, every thread copying 16-byte pieces by cp.async
//     (cache-global), into a ring of stages of K + V tiles (32 KB each): two
//     stages, the next tile's copies issued as soon as one is spent, or one
//     when a chunk is one tile, as at pages of 64, where the whole page of
//     the group is in flight from the start.
//     Each thread then arrives on the stage's mbarrier once its copies have
//     landed (cp.async.mbarrier.arrive), and the block waits on the
//     barrier's phase.  The chunk's page ids are read with the lane's
//     length (and for int8 their scales after), before the first copy.
//     Rows that are not 16-byte aligned (head_dim not a multiple of 16
//     bytes, or a misaligned pool) take element loads into the same
//     layout, head_dim padded with zeros to whole 16-byte pieces.  (The
//     TMA unit's cp.async.bulk, one copy a row, was no faster at pages of
//     64 and slower for int8 rows of 512 bytes.)
//   * Layout.  Shared memory keeps the pool's own format (float32, bf16 or
//     int8; no float32 restaging); a thread converts 16 bytes at a time in
//     registers (bf16: a shift or a mask; int8: a byte permute onto a magic
//     exponent and one float subtract, not the quarter-rate I2F).  The
//     16-byte piece c of tile row r is stored at piece c ^ (r & 7) of its
//     row (an XOR swizzle, when a row is whole 128-byte lines): eight
//     threads scoring the same head of eight consecutive rows, and eight
//     threads summing consecutive pieces of one row, each hit eight
//     distinct bank groups.
//   * Scores: one thread a (row, head), its dot product over head_dim from
//     the swizzled row and q (float32, in shared memory; a broadcast).  The
//     tile's max and sum by the online-softmax rule: one warp a head.
//     Weighted V sums: one thread a (16-byte piece of the row, row group),
//     its 4 / 8 / 16 accumulators in registers, rescaled once a tile; the
//     row groups are summed in order at the end of the chunk.
//   * Merge in the same launch.  A lane of one live chunk writes its state
//     directly.  Otherwise each block writes its chunk's partial (acc, m,
//     l) to a float32 scratch, fences, and counts its arrival on the lane's
//     counter (one int32 per lane and head group, zero between calls); the
//     last block of the lane to arrive resets the counter, reads every
//     chunk's (m, l) at once, and merges the lane's chunks in chunk order
//     by the flash rule, so the bits are the same whatever the arrival
//     order.  Blocks past a lane's length exit at once and do not arrive
//     (the count of live chunks follows from the length).  A lane's bits
//     depend on its own inputs and the geometry only, never on B or on the
//     other lanes.
// Scores, max, weights and sums are float32 throughout; only positions below
// the length enter, so no NaN can arise.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch.
// The caller makes the tensors' device current, passes contiguous tensors
// and PyTorch's current stream, and allocates the scratch and counters.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;                 // K + V tiles in flight, at most
constexpr int kTileBytes = 32 * 1024;      // a K (or V) tile
constexpr int kMaxTile = 64;               // rows a tile
constexpr int kMaxGroupBytes = 512;        // a head group's share of a pool row, in bytes
constexpr int kMaxGroupElems = 256;        // ... and in elements (head_dim padded)
constexpr int kMaxGroupHeads = 16;
constexpr int kMaxChunkRows = 64;          // rows of a chunk of more than one page
constexpr int kMaxHeadDim = 128;
constexpr int kMaxRank = 64;               // LoRA rank the fold takes
constexpr int kRankStep = 8;               // ranks reduced per pass of the fold
constexpr int kFoldThreads = 128;          // the threads that compute the fold's t
constexpr int kMergeAhead = 16;            // chunks whose partial acc the merge loads up front
constexpr int kDynBytes = kStages * 2 * kTileBytes;

enum Kind { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous, cached in L2 only
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// a stage's mbarrier: one arrival from every thread a phase
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(kThreads) : "memory");
}

// this thread's arrival, once its earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_after_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// 16 bytes of the pool's format -> float32: 4 floats, 8 bf16 (low half
// first) or 16 int8 (lowest byte first; each byte's value + 128 put under
// the exponent of 2^23 by a byte permute, then 2^23 + 128 subtracted: exact).
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
  const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      out[4 * j + b] = __uint_as_float(__byte_perm(w[j], 0x4B000000u, 0x7650u | b)) - 8388736.0f;
    }
  }
}

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

// The block geometry, derived on the host from the shapes (the same in every
// block and thread).
struct Geo {
  int hdp;        // head_dim padded to whole 16-byte pieces
  int hc;         // 16-byte pieces of a head
  int C;          // 16-byte pieces of the group's share of a row
  int rb;         // its bytes (C * 16)
  int T, tshift;  // rows a tile (a power of two, at most 64) and its log2
  int stages;     // stages of the ring: 1 when a chunk is one tile
  int swz;        // XOR mask of the swizzle (7, or 0 when a row is not whole 128-byte lines)
  int ng;         // row groups of the weighted sum: kThreads / C
};

Geo make_geo(int head_dim, int group_heads, int elt, int chunk_rows) {
  const int e = 16 / elt;
  Geo g;
  g.hc = (head_dim + e - 1) / e;
  g.hdp = g.hc * e;
  g.C = group_heads * g.hc;
  g.rb = g.C * 16;
  g.tshift = 0;
  while ((2 << g.tshift) <= kMaxTile && (2 << g.tshift) * g.rb <= kTileBytes) ++g.tshift;
  g.T = 1 << g.tshift;
  g.stages = chunk_rows <= g.T ? 1 : kStages;
  g.swz = g.C % 8 == 0 ? 7 : 0;
  g.ng = kThreads / g.C;
  return g;
}

struct Params {
  const void *q, *pk, *pv;
  const float *sk, *sv;               // int8 pages: (num_pages,) scales
  const int *tables, *lengths;
  float *acc, *m, *l;                 // outputs
  float *part_acc, *part_m, *part_l;  // (B, chunks, h, hd) / (B, chunks, h) scratch
  int* counters;                      // (B * head groups,), zero between calls
  LoraArgs lora;                      // lora.x == nullptr: no fold
  int heads, hd, table_pages, ps;
  int chunk_pages;                    // G: pages of a chunk
  int group_heads;                    // HG: heads of a block
  int chunks;                         // ceil(table_pages / G)
  bool vec;                           // rows as 16-byte copies
  Geo g;
};

struct __align__(16) Shared {
  float q[kMaxGroupElems];                   // the group's q rows, float32, head_dim padded
  float s[kMaxTile * kMaxGroupHeads];        // a tile's scores, then its weights: [head][row]
  int rows[kMaxChunkRows];                   // chunks of G > 1 pages: each row's pool row
  float rsk[kMaxChunkRows], rsv[kMaxChunkRows];  // ... and its page's scales (int8)
  long long row0;                            // G = 1: the page's first pool row
  float sk0, sv0;                            // G = 1: the page's scales (int8)
  float m[kMaxGroupHeads], l[kMaxGroupHeads], alpha[kMaxGroupHeads];
  float t[kMaxRank];                         // LoRA fold: the lane's A^T x
  float lred[kFoldThreads / 32][kRankStep];  // LoRA fold: per-warp partial sums
  unsigned long long bar[kStages];          // each stage's copies landed
  int last;                                  // this block merges its lane
};

__device__ __forceinline__ long long row_of(const Shared& sh, int G, int j) {
  return G == 1 ? sh.row0 + j : static_cast<long long>(sh.rows[j]);
}

// byte offset of 16-byte chunk c of tile row r
__device__ __forceinline__ int chunk_at(const Geo& g, int r, int c) { return (r * g.C + (c ^ (r & g.swz))) * 16; }

// Ask for rows [t0, t0 + n) of the chunk (K and V) into a stage: K rows at
// stage[0, T * rb), V rows after them; every thread then arrives on the
// stage's mbarrier.  16-byte rows: each thread copies one 16-byte chunk of
// rows r, r + 256 / C, ... by cp.async, and arrives when they have landed;
// otherwise element loads by every thread, then the arrival.
template <typename TP>
__device__ __forceinline__ void issue_tile(const Params& p, const Geo& g, const Shared& sh, int64_t col0,
                                           int t0, int n, unsigned char* stage, const unsigned long long* bar) {
  constexpr int E = 16 / static_cast<int>(sizeof(TP));
  const TP* pk = static_cast<const TP*>(p.pk);
  const TP* pv = static_cast<const TP*>(p.pv);
  const int64_t row_elems = static_cast<int64_t>(p.heads) * p.hd;
  const int tid = threadIdx.x;
  const int vbytes = g.T * g.rb;
  if (p.vec) {
    const int rpp = kThreads / g.C;  // rows a pass
    if (tid < rpp * g.C) {
      const int c = tid % g.C;
      for (int r = tid / g.C; r < n; r += rpp) {
        const int64_t off = row_of(sh, p.chunk_pages, t0 + r) * row_elems + col0 + c * E;
        const uint32_t dst = smem_addr(stage + chunk_at(g, r, c));
        cp_async16(dst, pk + off);
        cp_async16(dst + vbytes, pv + off);
      }
    }
    mbar_arrive_after_copies(smem_addr(bar));
  } else {
    const int width = p.group_heads * g.hdp;
    for (int i = tid; i < n * width; i += kThreads) {
      const int r = i / width;
      const int col = i - r * width;
      const int head = col / g.hdp;
      const int e = col - head * g.hdp;
      TP kx{}, vx{};
      if (e < p.hd) {
        const int64_t off = row_of(sh, p.chunk_pages, t0 + r) * row_elems + col0 + head * p.hd + e;
        kx = pk[off];
        vx = pv[off];
      }
      const int at = chunk_at(g, r, col / E) + (col % E) * static_cast<int>(sizeof(TP));
      *reinterpret_cast<TP*>(stage + at) = kx;
      *reinterpret_cast<TP*>(stage + vbytes + at) = vx;
    }
    mbar_arrive(smem_addr(bar));
  }
}

// The fold of one block: sh.t = A^T x over D (first kFoldThreads threads, a
// fixed order), then this group's columns of delta_q folded into sh.q and,
// in the lane's first chunk, the group's columns of all three thirds of the
// delta written out.
__device__ void lora_fold(const Params& p, const Geo& g, int b, int slot, int hg, bool write_delta, Shared& sh) {
  const LoraArgs& lo = p.lora;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int D = p.heads * p.hd;
  const int r = lo.rank;
  const float* x = lo.x + static_cast<int64_t>(b) * D;
  const float* A = lo.a + static_cast<int64_t>(slot) * D * r;
  const float* Bf = lo.b + static_cast<int64_t>(slot) * r * 3 * D;
  for (int r0 = 0; r0 < r; r0 += kRankStep) {
    if (tid < kFoldThreads) {
      float part[kRankStep];
#pragma unroll
      for (int u = 0; u < kRankStep; ++u) part[u] = 0.f;
#pragma unroll 4
      for (int d = tid; d < D; d += kFoldThreads) {
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
        if ((tid & 31) == 0) sh.lred[warp][u] = v;
      }
    }
    __syncthreads();
    if (tid < kRankStep && r0 + tid < r) {
      float s = 0.f;
      for (int w = 0; w < kFoldThreads / 32; ++w) s += sh.lred[w][tid];
      sh.t[r0 + tid] = s;
    }
    __syncthreads();
  }
  const int width = p.group_heads * p.hd;  // the group's columns of a third
  float* delta = lo.delta + static_cast<int64_t>(b) * 3 * D;
  for (int i = tid; i < (write_delta ? 3 : 1) * width; i += kThreads) {
    const int third = i / width;
    const int c = i - third * width;
    const int64_t col = static_cast<int64_t>(third) * D + static_cast<int64_t>(hg) * width + c;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < r; ++k) s = fmaf(sh.t[k], Bf[static_cast<int64_t>(k) * 3 * D + col], s);
    if (write_delta) delta[col] = s;
    if (third == 0) {
      const int head = c / p.hd;
      float& qv = sh.q[head * g.hdp + (c - head * p.hd)];
      qv = __fadd_rn(qv, __fmul_rn(lo.q_scale, s));
    }
  }
}

// One block: lane blockIdx.y, chunk blockIdx.x / head groups, head group
// blockIdx.x % head groups.
template <typename TQ, typename TP, bool kQuant, bool kLora>
__global__ void __launch_bounds__(kThreads, 1) paged_decode_kernel(const Params p) {
  constexpr int E = 16 / static_cast<int>(sizeof(TP));
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int groups = p.heads / p.group_heads;
  const int chunk = blockIdx.x / groups;
  const int hg = blockIdx.x - chunk * groups;
  const int b = blockIdx.y;
  const int G = p.chunk_pages;
  const int chunk_rows = G * p.ps;
  // the chunk's page ids and the lane's length, asked for together (a
  // page id of the table is valid memory whatever the length)
  const int* table = p.tables + static_cast<int64_t>(b) * p.table_pages + static_cast<int64_t>(chunk) * G;
  const int gp = G == 1 ? 0 : tid / p.ps;  // this thread's row (tid) lies on page gp of the chunk
  const bool reads_page = G == 1 ? tid == 0 : tid < chunk_rows && chunk * G + gp < p.table_pages;
  const int page = reads_page ? table[gp] : 0;
  // the LoRA slot too (an out-of-range id reads a real slot)
  const int slot = kLora ? min(max(p.lora.idx[b], 0), p.lora.slots - 1) : 0;
  const int64_t cap = static_cast<int64_t>(p.table_pages) * p.ps;
  const int64_t len = max(p.lengths[b], 0);
  const int hi = static_cast<int>(len < cap ? len : cap);
  const int live = max(1, (hi + chunk_rows - 1) / chunk_rows);  // chunk 0 always runs
  if (chunk >= live) return;
  const Geo g = p.g;
  const int HG = p.group_heads;
  const int lo = chunk * chunk_rows;
  const int rows = max(0, min(hi - lo, chunk_rows));

  // the chunk's pool rows (and int8 scales)
  if (reads_page && tid < max(rows, 1)) {
    if (G == 1) {
      sh.row0 = static_cast<long long>(page) * p.ps;
    } else {
      sh.rows[tid] = page * p.ps + (tid - gp * p.ps);
    }
    if (kQuant && rows > 0) {
      const float k_scale = p.sk[page], v_scale = p.sv[page];
      if (G == 1) {
        sh.sk0 = k_scale;
        sh.sv0 = v_scale;
      } else {
        sh.rsk[tid] = k_scale;
        sh.rsv[tid] = v_scale;
      }
    }
  }
  if (tid < HG) {
    sh.m[tid] = -INFINITY;
    sh.l[tid] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(&sh.bar[s]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t col0 = static_cast<int64_t>(hg) * HG * p.hd;  // the group's first element of a row
  const int tiles = (rows + g.T - 1) / g.T;
  const int stage_bytes = 2 * g.T * g.rb;
  for (int s = 0; s < g.stages && s < tiles; ++s) {
    issue_tile<TP>(p, g, sh, col0, s * g.T, min(g.T, rows - s * g.T), dyn + s * stage_bytes, &sh.bar[s]);
  }

  // q of the group's heads, float32, head_dim padded with zeros
  const TQ* q = static_cast<const TQ*>(p.q);
  const int64_t q0 = (static_cast<int64_t>(b) * p.heads + static_cast<int64_t>(hg) * HG) * p.hd;
  for (int i = tid; i < HG * g.hdp; i += kThreads) {
    const int head = i / g.hdp;
    const int e = i - head * g.hdp;
    sh.q[i] = e < p.hd ? to_f32(q[q0 + head * p.hd + e]) : 0.f;
  }
  if (kLora) {
    __syncthreads();
    lora_fold(p, g, b, slot, hg, chunk == 0, sh);
  }

  // the weighted V sums: this thread's 16-byte chunk vc of the row, row group vg
  const int vc = tid % g.C;
  const int vg = tid / g.C;
  const int vh = vc / g.hc;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int i = 0; i < tiles; ++i) {
    const int n = min(g.T, rows - i * g.T);
    const int stage = i % g.stages;
    const unsigned char* kt = dyn + stage * stage_bytes;
    const unsigned char* vt = kt + g.T * g.rb;
    const int t0 = i * g.T;
    mbar_wait(smem_addr(&sh.bar[stage]), (i / g.stages) & 1);
    __syncthreads();
    // scores: one thread a (row, head)
    for (int pr = tid; pr < g.T * HG; pr += kThreads) {
      const int head = pr >> g.tshift;
      const int r = pr & (g.T - 1);
      if (r >= n) continue;
      const float* qh = sh.q + head * g.hdp;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
      for (int k = 0; k < g.hc; ++k) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kt + chunk_at(g, r, head * g.hc + k));
        float v[E];
        unpack16(raw, v, TP());
        const float4* qk = reinterpret_cast<const float4*>(qh + k * E);
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 qv = qk[e / 4];
          s0 = fmaf(qv.x, v[e], s0);
          s1 = fmaf(qv.y, v[e + 1], s1);
          s0 = fmaf(qv.z, v[e + 2], s0);
          s1 = fmaf(qv.w, v[e + 3], s1);
        }
      }
      float s = s0 + s1;
      if (kQuant) s *= G == 1 ? sh.sk0 : sh.rsk[t0 + r];
      sh.s[head * g.T + r] = s;
    }
    __syncthreads();
    // the online-softmax step of each head: one warp a head
    for (int head = warp; head < HG; head += kWarps) {
      float* sp = sh.s + head * g.T;
      float mx = -INFINITY;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, sp[r]);
      mx = warp_max(mx);
      const float m_old = sh.m[head];
      const float m_new = fmaxf(m_old, mx);  // finite: the tile holds >= 1 live row
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float w = expf(sp[r] - m_new);
        sum += w;
        sp[r] = kQuant ? w * (G == 1 ? sh.sv0 : sh.rsv[t0 + r]) : w;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile (m = -inf)
        sh.alpha[head] = alpha;
        sh.m[head] = m_new;
        sh.l[head] = sh.l[head] * alpha + sum;
      }
    }
    __syncthreads();
    // weighted V sums
    if (vg < g.ng) {
      const float alpha = sh.alpha[vh];
      const float* wp = sh.s + vh * g.T;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
      for (int r = vg; r < n; r += g.ng) {
        const float w = wp[r];
        const uint4 raw = *reinterpret_cast<const uint4*>(vt + chunk_at(g, r, vc));
        float v[E];
        unpack16(raw, v, TP());
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(w, v[e], acc[e]);
      }
    }
    __syncthreads();  // the stage is spent
    if (i + g.stages < tiles) {
      issue_tile<TP>(p, g, sh, col0, (i + g.stages) * g.T, min(g.T, rows - (i + g.stages) * g.T),
                     dyn + stage * stage_bytes, &sh.bar[stage]);
    }
  }

  // the row groups' sums, in order: red[group][head * hdp + d]
  float* red = reinterpret_cast<float*>(dyn);
  const int width = HG * g.hdp;
  if (vg < g.ng) {
#pragma unroll
    for (int e = 0; e < E; ++e) red[vg * width + vc * E + e] = acc[e];
  }
  __syncthreads();
  const int64_t hg0 = static_cast<int64_t>(b) * p.heads + static_cast<int64_t>(hg) * HG;  // (lane, first head)
  const bool direct = live == 1;
  const int64_t slot0 = (static_cast<int64_t>(b) * p.chunks + chunk) * p.heads + static_cast<int64_t>(hg) * HG;
  float* out_acc = direct ? p.acc + hg0 * p.hd : p.part_acc + slot0 * p.hd;
  float* out_m = direct ? p.m + hg0 : p.part_m + slot0;
  float* out_l = direct ? p.l + hg0 : p.part_l + slot0;
  for (int i = tid; i < HG * p.hd; i += kThreads) {
    const int head = i / p.hd;
    const int col = head * g.hdp + (i - head * p.hd);
    float s = 0.f;
    for (int j = 0; j < g.ng; ++j) s += red[j * width + col];
    out_acc[i] = s;
  }
  if (tid < HG) {
    out_m[tid] = sh.m[tid];
    out_l[tid] = sh.l[tid];
  }
  if (direct) return;

  // the last block of the lane (and group) to arrive merges its chunks
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = p.counters + static_cast<int64_t>(b) * groups + hg;
    sh.last = atomicAdd(counter, 1) == live - 1;
    if (sh.last) *counter = 0;  // ready for the next call
  }
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  // one round of loads: every chunk's (m, l) into shared memory and, for
  // this thread's first output (head, d), the first chunks' partial acc
  // into registers; then each chunk's weight exp(m_c - max) and the lane's
  // l in chunk order, then acc by the same weights in the same order
  const int64_t first = static_cast<int64_t>(b) * p.chunks * p.heads + static_cast<int64_t>(hg) * HG;  // chunk 0
  const int64_t stride = static_cast<int64_t>(p.heads) * p.hd;  // partial acc: between chunks
  const bool has_out = tid < HG * p.hd;
  const int head = has_out ? tid / p.hd : 0;
  const float* part = p.part_acc + (first + head) * p.hd + (tid - head * p.hd);
  float ahead[kMergeAhead];
#pragma unroll
  for (int c = 0; c < kMergeAhead; ++c) ahead[c] = has_out && c < live ? __ldcg(part + c * stride) : 0.f;
  float* wm = reinterpret_cast<float*>(dyn);  // [chunk][head]: m, then the weight
  float* wl = wm + live * HG;                 // [chunk][head]: l
  for (int i = tid; i < live * HG; i += kThreads) {
    const int c = i / HG;
    const int64_t slot = first + static_cast<int64_t>(c) * p.heads + (i - c * HG);
    wm[i] = __ldcg(p.part_m + slot);
    wl[i] = __ldcg(p.part_l + slot);
  }
  __syncthreads();
  if (tid < HG) {
    float mx = -INFINITY;
    for (int c = 0; c < live; ++c) mx = fmaxf(mx, wm[c * HG + tid]);
    float l = 0.f;
    for (int c = 0; c < live; ++c) {
      const float w = mx == -INFINITY ? 0.f : expf(wm[c * HG + tid] - mx);  // 0 for an empty chunk (-inf)
      l = fmaf(w, wl[c * HG + tid], l);
      wm[c * HG + tid] = w;
    }
    p.m[hg0 + tid] = mx;
    p.l[hg0 + tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < HG * p.hd; i += kThreads) {
    const int oh = i / p.hd;
    const float* pi = p.part_acc + (first + oh) * p.hd + (i - oh * p.hd);
    float a = 0.f;
#pragma unroll
    for (int c = 0; c < kMergeAhead; ++c) {
      if (c < live) a = fmaf(wm[c * HG + oh], i == tid ? ahead[c] : __ldcg(pi + c * stride), a);
    }
    for (int c = kMergeAhead; c < live; ++c) a = fmaf(wm[c * HG + oh], __ldcg(pi + c * stride), a);
    p.acc[hg0 * p.hd + i] = a;
  }
}

template <typename TQ, typename TP, bool kQuant>
cudaError_t launch(const Params& p, int batch, cudaStream_t s) {
  const dim3 grid(p.chunks * (p.heads / p.group_heads), batch);
  // the ring, and room for the row groups' sums and the merge's (m, l) of every chunk
  const int sums = p.g.ng * p.g.C * (16 / static_cast<int>(sizeof(TP))) * 4;
  const int bytes = max(max(p.g.stages * 2 * p.g.T * p.g.rb, sums), p.chunks * p.group_heads * 2 * 4);
  auto kernel = p.lora.x != nullptr ? paged_decode_kernel<TQ, TP, kQuant, true> : paged_decode_kernel<TQ, TP, kQuant, false>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

int elt_bytes(int pool_kind) { return pool_kind == kF32 ? 4 : pool_kind == kBF16 ? 2 : 1; }

}  // namespace

// q_kind: 0 float32, 1 bfloat16; pool_kind: q_kind, or 2 (int8, with the
// (num_pages,) float32 scales sk / sv).  chunk_pages (G) and group_heads
// (HG) come from the host; a chunk of more than one page holds at most 64
// rows, HG divides heads and its share of a row is at most 1 KB.
// part_acc (B, chunks, h, hd) and part_m / part_l (B, chunks, h) float32
// scratch with chunks = ceil(table_pages / G), and counters (B * h / HG)
// int32 zero: needed when a lane can have more than one chunk.  x / lora_a /
// lora_b / adapter_idx / delta: the LoRA fold's inputs and its (B, 3 h hd)
// output, or all null for no fold.
extern "C" int paged_decode(const void* q, const void* pk, const void* pv, const void* tables,
                            const void* lengths, void* acc, void* m, void* l, const void* sk,
                            const void* sv, void* part_acc, void* part_m, void* part_l, void* counters,
                            const void* x, const void* lora_a, const void* lora_b, const void* adapter_idx,
                            void* delta, int batch, int heads, int head_dim, int table_pages,
                            int page_size, int chunk_pages, int group_heads, int q_kind, int pool_kind,
                            int rank, int slots, float q_scale, void* stream) {
  const bool fold = x != nullptr;
  const int elt = elt_bytes(pool_kind);
  const int chunk_elems = 16 / elt;
  const int hdp = (head_dim + chunk_elems - 1) / chunk_elems * chunk_elems;
  const int chunks = chunk_pages > 0 ? (table_pages + chunk_pages - 1) / chunk_pages : 0;
  const bool bad_shape = batch < 0 || batch > 65535 || heads < 1 || head_dim < 1 || head_dim > kMaxHeadDim ||
                         table_pages < 1 || page_size < 1 || chunk_pages < 1 || chunk_pages > table_pages ||
                         (chunk_pages > 1 && chunk_pages * page_size > kMaxChunkRows) || group_heads < 1 ||
                         group_heads > kMaxGroupHeads || heads % group_heads != 0 ||
                         group_heads * hdp * elt > kMaxGroupBytes || group_heads * hdp > kMaxGroupElems ||
                         static_cast<long long>(chunks) * (heads / group_heads) > 2147483647LL ||
                         static_cast<long long>(chunks) * group_heads * 2 * sizeof(float) > kDynBytes;
  const bool bad_kinds = (q_kind != kF32 && q_kind != kBF16) ||
                         (pool_kind == kI8 ? (sk == nullptr || sv == nullptr) : pool_kind != q_kind);
  const bool bad_scratch = chunks > 1 && (part_acc == nullptr || part_m == nullptr || part_l == nullptr ||
                                          counters == nullptr);
  const bool bad_fold = fold && (lora_a == nullptr || lora_b == nullptr || adapter_idx == nullptr ||
                                 delta == nullptr || rank < 1 || rank > kMaxRank || slots < 1);
  if (bad_shape || bad_kinds || bad_scratch || bad_fold) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Params p{};
  p.q = q;
  p.pk = pk;
  p.pv = pv;
  p.sk = static_cast<const float*>(sk);
  p.sv = static_cast<const float*>(sv);
  p.tables = static_cast<const int*>(tables);
  p.lengths = static_cast<const int*>(lengths);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.counters = static_cast<int*>(counters);
  p.lora = LoraArgs{static_cast<const float*>(x), static_cast<const float*>(lora_a),
                    static_cast<const float*>(lora_b), static_cast<const int*>(adapter_idx),
                    static_cast<float*>(delta), rank, slots, q_scale};
  p.heads = heads;
  p.hd = head_dim;
  p.table_pages = table_pages;
  p.ps = page_size;
  p.chunk_pages = chunk_pages;
  p.group_heads = group_heads;
  p.chunks = chunks;
  p.vec = head_dim % chunk_elems == 0 && reinterpret_cast<uintptr_t>(pk) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(pv) % 16 == 0;
  p.g = make_geo(head_dim, group_heads, elt, chunk_pages * page_size);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pool_kind == kI8) {
    err = q_kind == kF32 ? launch<float, int8_t, true>(p, batch, s) : launch<__nv_bfloat16, int8_t, true>(p, batch, s);
  } else if (q_kind == kF32) {
    err = launch<float, float, false>(p, batch, s);
  } else {
    err = launch<__nv_bfloat16, __nv_bfloat16, false>(p, batch, s);
  }
  return static_cast<int>(err);
}
