// flash_attention: blockwise self- or cross-attention with an online softmax
// (K3), causal or not.
//
// Replaces the Pallas TPU kernel of seldon_core_tpu/ops/kernels.py
// flash_attention (:255; kernel body _flash_kernel :195, pallas_call :309).
//
// For every batch b, head h and query row i it computes
//   s_ij = (q[b,i,h,:] . k[b,j,h,:]) * scale         scale = 1/sqrt(head_dim)
//   o[b,i,h,:] = sum_j exp(s_ij - m_i) v[b,j,h,:] / sum_j exp(s_ij - m_i)
// with m_i = max_j s_ij, s_ij = -inf for keys j >= Lk and, when causal, for
// j > i; a row whose weights are all zero writes 0.  q is (B, Lq, H, D), k and
// v (B, Lk, H, D), o (B, Lq, H, D): any element strides on B, L and H, unit
// stride on D (the layout the transformer's qkv split gives, read where it
// lies).  f32, bf16 or f16 in; f32 softmax state; o in the input's dtype.
//
// Bound: memory.  At the ViT-B/16 serving shape (B=32, L=197, H=12, D=64,
// bf16) q, k, v and o are 38.7 MB, 11.6 us at 3.35 TB/s, against 3.8 GFLOP,
// 3.9 us on the bf16 tensor cores.
//
// Two bodies, one per input format.
//
// bf16 / f16: flash_attention_mma_kernel, FlashAttention-2 shaped, both
// products on the tensor cores (mma.sync m16n8k16, f32 accumulators).  One
// block of 8 warps owns one (batch*head, 128-query tile); each warp owns 16
// query rows, and the block's K / V tiles serve all 128:
//   * the Q tile is loaded once; each warp keeps its m16n8k16 A fragments
//     (ldmatrix) in registers for the whole kernel;
//   * K and V tiles of 64 keys are held in their own dtype in shared memory,
//     in a 4-buffer ring filled by 16-byte cp.async, so tiles j+1 to j+3
//     are in flight while tile j computes, and one barrier a tile orders
//     the copies and the reads.  Key rows at or past Lk, and the columns of a
//     head_dim that is not a multiple of 16 (padded to one), are zero-filled
//     by cp.async's src-size (or by plain loads where a view is not 16-byte
//     aligned): nothing is padded or copied on the host;
//   * shared-memory rows are 8 elements longer than the padded head_dim, so
//     the 8 rows an ldmatrix phase reads start in 8 distinct 4-bank groups;
//   * S = Q K^T: K rows are the col-major B operand as they lie (ldmatrix);
//     the scale enters the f32 scores (not the rounded Q), folded with
//     log2(e) into one FMA a weight, w = 2**(s * scale * log2 e - m), on the
//     MUFU's ex2;
//   * the online softmax stays in registers: the m16n8 S accumulator is laid
//     out as the A operand of the next m16n8k16, a row's max and sum reduce
//     across the 4 threads of a quad with shuffles, and the infinity guards
//     of the f32 body hold (safe_m, weight 0 for a non-finite score,
//     correction 0 while the max is -inf, l == 0 -> output 0);
//   * O += P V: V goes through ldmatrix.trans.  P is split into two terms
//     of the input format, hi = round(p) and lo = round(p - hi), and both go
//     through the tensor cores: one rounded P (2**-9 relative in bf16) puts
//     errors of ~1e-4 on outputs near zero, above one step of the format;
//     hi + lo carries p to ~2**-17, and V is exact, so the f32 sums see the
//     weights the f32 body sees.  PV is then twice QK^T's mma count;
//   * work that only masks: key tiles wholly above the block's diagonal are
//     never loaded; in a tile, a warp runs the 16-key steps up to Lk and
//     (causal) up to its last row, and a warp of rows past Lq runs none;
//   * causal balance: the later half of the query tiles (the longest rows)
//     is scheduled first, descending, then the earlier half ascending, so
//     the two blocks an SM holds at once tend to pair long rows with short
//     ones.
//   Shared memory: a Q tile of 128 and four K and four V tiles of 64 rows
//   of D16 + 8 elements, D16 = head_dim rounded up to 16: 90 KB at head_dim
//   64, 170 KB at 128 (dynamic shared memory, the kernel's limit raised
//   before the launch).
//
// f32: flash_attention_kernel, the CUDA-core body.  The f32 bars (1e-5 of
// the largest output against the plain version; 1e-4 on transformer_lm's
// f32 logits) cannot be held on TF32's 10-bit mantissa, and an exact split
// of f32 into bf16 terms would cost 6 products per pair, so f32 keeps
// scalar FMAs: thread t owns 8 query rows and 4 key columns of a score
// tile, Q (pre-multiplied by the scale), K and V are staged as f32 with
// 16-byte loads where aligned, the weights go through shared memory.
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

constexpr int kThreads = 128;     // the f32 body's block
constexpr int kTile = 64;          // key rows per tile; the f32 body's query rows per block
constexpr int kMmaWarps = 8;       // the tensor-core body: 8 warps of 16 query rows
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kQTile = 16 * kMmaWarps;  // its query rows per block
constexpr int kStagesKV = 4;       // its K / V ring
constexpr int kMaxHeadDim = 128;
constexpr float kLog2e = 1.4426950408889634f;

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
  bool vec_o;                // 4-byte pair stores are aligned
};

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Per-format pieces of the tensor-core body: d += a (16x16, row) * b (16x8,
// col) with f32 accumulators, and two floats packed into the operand format
// (low half first) with the rounded values handed back.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y, float& rx, float& ry) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    rx = __low2float(h);
    ry = __high2float(h);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ void store2(void* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
  static __device__ __forceinline__ void store1(void* p, float x) {
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(x);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y, float& rx, float& ry) {
    const __half2 h = __floats2half2_rn(x, y);
    rx = __low2float(h);
    ry = __high2float(h);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ void store2(void* p, float x, float y) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  }
  static __device__ __forceinline__ void store1(void* p, float x) {
    *reinterpret_cast<__half*>(p) = __float2half_rn(x);
  }
};

// Rows [row0, row0 + kRowsT) of one (batch, head) slice -> a [kRowsT][kD + 8]
// shared tile of 16-bit elements; rows at or past n_rows and columns at or past hd
// are zero.  vec: 16-byte cp.async (asynchronous; the caller commits and
// waits), else element loads (done when this returns).
template <int kD, int kRowsT>
__device__ __forceinline__ void load_tile(uint16_t* __restrict__ dst, const uint16_t* __restrict__ base,
                                          long long row_stride, int row0, int n_rows, int hd, bool vec) {
  constexpr int kLds = kD + 8;
  constexpr int kChunks = kD / 8;  // 16-byte chunks a row
  constexpr int kTotal = kRowsT * kChunks;
  if (vec) {  // a compile-time count of copies a thread, the tile's row 0 computed once
    const uint16_t* tile = base + row0 * row_stride;
    const int rows = n_rows - row0;
#pragma unroll
    for (int u = 0; u < (kTotal + kMmaThreads - 1) / kMmaThreads; ++u) {
      const int i = threadIdx.x + u * kMmaThreads;
      if (kTotal % kMmaThreads != 0 && i >= kTotal) break;
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool live = r < rows && c < hd;
      cp_async16(smem_addr(dst + r * kLds + c), live ? tile + r * row_stride + c : base, live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRowsT * kD; i += kMmaThreads) {
      const int r = i / kD;
      const int c = i - r * kD;
      dst[r * kLds + c] = row0 + r < n_rows && c < hd ? base[(row0 + r) * row_stride + c] : uint16_t(0);
    }
  }
}

// 2**x on the MUFU unit (a relative error of ~2**-22; 2**-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {  // over the 4 threads holding one row
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// kD: head_dim rounded up to 16 (the contraction of Q K^T, zero-padded).
// At head_dim <= 64 the register bound keeps 2 blocks (16 warps) on an SM.
template <typename T, int kD>
__global__ void __launch_bounds__(kMmaThreads, kD <= 64 ? 2 : 1) flash_attention_mma_kernel(Params p) {
  constexpr int kLds = kD + 8;
  constexpr int kTileElems = kTile * kLds;
  constexpr int kSteps = kD / 16;   // k16 steps of Q K^T; pairs of 8-wide O column tiles
  extern __shared__ __align__(16) uint16_t tiles[];
  uint16_t* qs = tiles;                        // [128][kLds]
  uint16_t* ks = qs + kQTile * kLds;           // [3][64][kLds]
  uint16_t* vs = ks + kStagesKV * kTileElems;  // [3][64][kLds]

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  // query tiles: the later (longer causal) half first, descending, then the
  // earlier half ascending, so blocks an SM holds together pair long rows
  // with short ones
  const int half = (gridDim.y + 1) / 2;
  const int qt = blockIdx.y < half ? gridDim.y - 1 - blockIdx.y : blockIdx.y - half;
  const int q0 = qt * kQTile;
  const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.sq.b + h * p.sq.h;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + b * p.sk.b + h * p.sk.h;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + b * p.sv.b + h * p.sv.h;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;           // fragment row (and row + 8)
  const int tig = lane & 3;          // fragment column pair
  const int lm = lane >> 3;          // ldmatrix: which 8x8 matrix this lane addresses
  const int lr = lane & 7;           // ldmatrix: which row of it
  const int wrow0 = q0 + warp * 16;  // the warp's first query row
  const float scale_log2 = p.scale * kLog2e;

  // causal: key tiles wholly above the block's diagonal contribute nothing
  const int kv_end = p.causal ? min(p.lk, q0 + kQTile) : p.lk;
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  uint32_t qf[kSteps][4];
  float acc[2 * kSteps][4];
#pragma unroll
  for (int t = 0; t < 2 * kSteps; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};

  // the ring: tile j lands in buffer j % 4, three tiles ahead of the one
  // that computes (a 197-token input has every tile in flight after the
  // first wait), so one barrier a tile orders the copies and the reads
  if (n_tiles > 0) load_tile<kD, kQTile>(qs, q, p.sq.l, q0, p.lq, p.hd, p.vec_q);
#pragma unroll
  for (int t = 0; t < kStagesKV - 1; ++t) {
    if (t < n_tiles) {
      load_tile<kD, kTile>(ks + t * kTileElems, k, p.sk.l, t * kTile, p.lk, p.hd, p.vec_k);
      load_tile<kD, kTile>(vs + t * kTileElems, v, p.sv.l, t * kTile, p.lk, p.hd, p.vec_v);
      cp_async_commit();
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    const int ahead = n_tiles - 1 - j;  // tiles committed after tile j (at most kStagesKV - 2)
    if (ahead >= 2) {
      cp_async_wait<2>();  // tile j has landed; tiles j + 1, j + 2 may be in flight
    } else if (ahead == 1) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and at j == 0 the Q tile) is in shared memory for every thread,
                      // and every warp is done with tile j - 1, whose buffer tile j + 3 takes
    if (j + kStagesKV - 1 < n_tiles) {
      const int nb = (j + kStagesKV - 1) % kStagesKV;
      load_tile<kD, kTile>(ks + nb * kTileElems, k, p.sk.l, k0 + (kStagesKV - 1) * kTile, p.lk, p.hd, p.vec_k);
      load_tile<kD, kTile>(vs + nb * kTileElems, v, p.sv.l, k0 + (kStagesKV - 1) * kTile, p.lk, p.hd, p.vec_v);
      cp_async_commit();
    }

    if (j == 0) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        ldmatrix_x4(qf[s], smem_addr(qs + (warp * 16 + (lm & 1) * 8 + lr) * kLds + s * 16 + (lm >> 1) * 8));
    }
    const uint16_t* kb = ks + (j % kStagesKV) * kTileElems;
    const uint16_t* vb = vs + (j % kStagesKV) * kTileElems;

    // keys this warp needs in the tile, in steps of 16: none past Lk, none past
    // its last row when causal; a warp of padding rows needs none
    const int key_end = min(p.lk, p.causal ? wrow0 + 16 : p.lk) - k0;
    const int key_steps = wrow0 < p.lq ? min(max((key_end + 15) / 16, 0), 4) : 0;
    if (key_steps > 0) {
      float s[8][4];  // 8 tiles of 8 keys: rows g / g + 8, keys 8t + 2 tig (+1)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {  // keys 16 np .. 16 np + 15; the rest stay 0 and are masked below
          if (np >= key_steps) break;
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_addr(kb + (np * 16 + (lm >> 1) * 8 + lr) * kLds + st * 16 + (lm & 1) * 8));
          Mma<T>::run(s[2 * np], qf[st], bk[0], bk[1]);
          Mma<T>::run(s[2 * np + 1], qf[st], bk[2], bk[3]);
        }
      }

      const bool edge = k0 + kTile > p.lk || (p.causal && k0 + kTile - 1 > wrow0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = wrow0 + g + 8 * r;
        float mx = -INFINITY;  // over the unscaled scores: the scale is positive
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (edge) {
              const int kj = k0 + 8 * t + 2 * tig + c;
              if (kj >= p.lk || (p.causal && kj > qi)) s[t][2 * r + c] = -INFINITY;
            }
            mx = fmaxf(mx, s[t][2 * r + c]);
          }
        const float new_m = fmaxf(m[r], quad_max(mx) * scale_log2);
        const float safe_m = isfinite(new_m) ? new_m : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = s[t][2 * r + c];
            const float w = fabsf(x) < INFINITY ? ex2(fmaf(x, scale_log2, -safe_m)) : 0.f;
            s[t][2 * r + c] = w;
            sum += w;
          }
        const float correction = isfinite(m[r]) ? ex2(m[r] - safe_m) : 0.f;
        l[r] = l[r] * correction + quad_sum(sum);
        m[r] = new_m;
#pragma unroll
        for (int t = 0; t < 2 * kSteps; ++t) {
          acc[t][2 * r] *= correction;
          acc[t][2 * r + 1] *= correction;
        }
      }

#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk .. 16 kk + 15: the A operand from S tiles 2 kk, 2 kk + 1
        if (kk >= key_steps) break;   // weights 0 past the warp's keys
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float* w = &s[2 * kk + (a >> 1)][2 * (a & 1)];
          float rx, ry;
          hi[a] = Mma<T>::pack(w[0], w[1], rx, ry);
          lo[a] = Mma<T>::pack(w[0] - rx, w[1] - ry, rx, ry);
        }
#pragma unroll
        for (int dp = 0; dp < kSteps; ++dp) {  // output columns 16 dp .. 16 dp + 15
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(vb + (kk * 16 + (lm & 1) * 8 + lr) * kLds + dp * 16 + (lm >> 1) * 8));
          Mma<T>::run(acc[2 * dp], hi, bv[0], bv[1]);
          Mma<T>::run(acc[2 * dp], lo, bv[0], bv[1]);
          Mma<T>::run(acc[2 * dp + 1], hi, bv[2], bv[3]);
          Mma<T>::run(acc[2 * dp + 1], lo, bv[2], bv[3]);
        }
      }
    }
  }

  T* o = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wrow0 + g + 8 * r;
    if (qi >= p.lq) continue;
    const float denom = l[r] > 0.f ? l[r] : 1.f;  // a row with no live key writes 0
    T* row = o + qi * p.so.l;
#pragma unroll
    for (int t = 0; t < 2 * kSteps; ++t) {
      const int d = 8 * t + 2 * tig;
      if (d >= p.hd) continue;
      const float x = acc[t][2 * r] / denom;
      const float y = acc[t][2 * r + 1] / denom;
      if (p.vec_o) {
        Mma<T>::store2(row + d, x, y);
      } else {
        Mma<T>::store1(row + d, x);
        Mma<T>::store1(row + d + 1, y);
      }
    }
  }
}

template <typename T, int kD>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t stream) {
  const int bytes = static_cast<int>((kQTile + 2 * kStagesKV * kTile) * (kD + 8) * sizeof(uint16_t));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attention_mma_kernel<T, kD>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * p.heads, (p.lq + kQTile - 1) / kQTile);
  flash_attention_mma_kernel<T, kD><<<grid, kMmaThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma_typed(const Params& p, int batch, cudaStream_t stream) {
  switch ((p.hd + 15) / 16) {
    case 1: return launch_mma<T, 16>(p, batch, stream);
    case 2: return launch_mma<T, 32>(p, batch, stream);
    case 3: return launch_mma<T, 48>(p, batch, stream);
    case 4: return launch_mma<T, 64>(p, batch, stream);
    case 5: return launch_mma<T, 80>(p, batch, stream);
    case 6: return launch_mma<T, 96>(p, batch, stream);
    case 7: return launch_mma<T, 112>(p, batch, stream);
    default: return launch_mma<T, 128>(p, batch, stream);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRows = 8;           // query rows per thread: 8 row groups x 8 rows
constexpr int kLanes = 16;         // threads sharing one row group
constexpr int kCols = kTile / kLanes;  // key columns per thread in a score tile
constexpr int kPLd = kTile + 2;    // weight-tile row stride: the two half-warps hit disjoint banks

// Stage rows [row0, row0 + 64) of one (batch, head) slice into dst times
// `mul` (row stride ld); rows at or past n_rows become 0.  With `vec` every
// thread issues up to four independent 16-byte loads before storing them,
// so a tile costs about one memory latency.
__device__ __forceinline__ void stage_tile(const float* __restrict__ base, long long row_stride, int row0,
                                           int n_rows, int hd, bool vec, float mul,
                                           float* __restrict__ dst, int ld) {
  const int tid = threadIdx.x;
  if (vec) {
    const int per_row = hd / 4;
    const int total = kTile * per_row;
    for (int first = tid; first < total; first += 4 * kThreads) {
      float4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = first + u * kThreads;
        const int r = i / per_row;
        raw[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < total && row0 + r < n_rows) {
          const int c = (i - r * per_row) * 4;
          raw[u] = __ldg(reinterpret_cast<const float4*>(base + (row0 + r) * row_stride + c));
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = first + u * kThreads;
        if (i >= total) break;
        const int r = i / per_row;
        const int c = (i - r * per_row) * 4;
        float* d = dst + r * ld + c;
        d[0] = raw[u].x * mul;
        d[1] = raw[u].y * mul;
        d[2] = raw[u].z * mul;
        d[3] = raw[u].w * mul;
      }
    }
  } else {
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int r = i / hd;
      const int c = i - r * hd;
      dst[r * ld + c] = row0 + r < n_rows ? base[(row0 + r) * row_stride + c] * mul : 0.f;
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
template <int kSlots>
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
  const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  float* o = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h;

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
    float* row = o + qi * p.so.l;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int d = lane + kLanes * t;
      if (d < hd) row[d] = acc[i][t] / denom;
    }
  }
}

size_t f32_smem_bytes(int hd) {
  return sizeof(float) * (2 * kTile * (hd + 1) + kTile * hd + kTile * kPLd);
}

template <int kSlots>
cudaError_t launch_f32(const Params& p, int batch, cudaStream_t stream) {
  const size_t bytes = f32_smem_bytes(p.hd);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<kSlots>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * p.heads, (p.lq + kTile - 1) / kTile);
  flash_attention_kernel<kSlots><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_f32_typed(const Params& p, int batch, cudaStream_t stream) {
  const int slots = (p.hd + kLanes - 1) / kLanes;
  if (slots <= 1) return launch_f32<1>(p, batch, stream);
  if (slots <= 2) return launch_f32<2>(p, batch, stream);
  if (slots <= 4) return launch_f32<4>(p, batch, stream);
  return launch_f32<8>(p, batch, stream);
}

// Rows of a tensor start at `align`-byte boundaries, every `vec` elements.
bool aligned_rows(const void* ptr, const long long* strides, int vec, int align) {
  return reinterpret_cast<uintptr_t>(ptr) % align == 0 && strides[0] % vec == 0 && strides[1] % vec == 0 &&
         strides[2] % vec == 0;
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
  const int vec = 16 / elt;  // elements in a 16-byte load
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
  p.vec_q = aligned_rows(q, strides, vec, 16);
  p.vec_k = aligned_rows(k, strides + 3, vec, 16);
  p.vec_v = aligned_rows(v, strides + 6, vec, 16);
  p.vec_o = aligned_rows(o, strides + 9, 2, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kF32:
      return static_cast<int>(launch_f32_typed(p, batch, s));
    case kBF16:
      return static_cast<int>(launch_mma_typed<__nv_bfloat16>(p, batch, s));
    case kF16:
      return static_cast<int>(launch_mma_typed<__half>(p, batch, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
