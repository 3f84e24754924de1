// int8_matmul (K2): y = (x @ w_int8) * scale[col], f32 accumulation,
// one rounding to the output dtype.
//
// Replaces the Pallas TPU kernel seldon_core_tpu/ops/kernels.py
// (_int8_matmul_kernel / int8_matmul), the dense layer of Int8Dense.
// The TPU version loads the whole K extent of a (bm, bn) block at once
// and pads M, N and K up to the (8, 128) tile in the wrapper.
//
// Bound: at the shapes it serves (ViT-B/16 fc1 at batch 32: 6304 x 768
// @ 768 x 3072) operations, 29.75 Gflop against 50.8 MB: 30 us on the
// bf16 tensor cores.  At the ResNet-50 head (32 x 2048 @ 2048 x 1000) and
// the LM's qkv (16 x 512 @ 512 x 1536) bytes: the int8 weight is the
// traffic, and 8-12 output tiles cannot fill 132 SMs.
//
// Design: a tensor-core GEMM (mma.sync m16n8k16, f32 accumulators).
//   * One block of 8 warps owns a 128 x 128 output tile; each warp a 64 x
//     32 sub-tile, 4 x 4 m16n8 accumulators; two blocks an SM for 16-bit
//     x.  K streams through shared memory in a cp.async ring: 64 deep, 4
//     stages for 16-bit x; 32 deep, 5 stages for f32 x (its staging is
//     twice as wide).  16-byte copies of x rows and of int8 w rows (8-byte
//     copies of w where its row stride allows no wider; each thread's
//     copy offsets computed once, before the loop), so the next k-tiles
//     are in flight while one computes; one barrier a k-tile.
//   * w stays int8 in shared memory.  ldmatrix.trans reads its rows as
//     16-bit pairs of columns, so a thread gets w[k][n], w[k][n + 1],
//     w[k + 1][n], w[k + 1][n + 1] in one word and splits it into the B
//     words of two n8 tiles, one of even and one of odd columns; the
//     conversion is byte permutes onto a magic exponent and one float
//     subtract (f16: one half subtract), not I2F (a quarter-rate unit).
//     int8 is exact in bf16 and f16, so every product is exact in f32 and
//     only the order of the sum differs from the plain version.  An even
//     and an odd n8 tile give a thread 4 consecutive columns of a row.
//   * x reaches the mma through ldmatrix; rows are 8 elements (x) or 16
//     bytes (w) longer than the tile, so an ldmatrix phase reads 8
//     distinct 4-bank groups.
//   * f32 x is split at staging into three bf16 terms, hi = bf16(x), mid =
//     bf16(x - hi), lo = bf16(x - hi - mid), each multiplied by the same
//     bf16 w: the three products are exact and carry x to ~2**-24, so the
//     f32 bar holds without TF32.  Tile t + 1 is split during tile t's
//     MMAs, into the other of two buffers.
//   * Small M (the head, the qkv, batch 1) gives fewer output tiles than
//     SMs: the host splits K across blocks (grid.z) until about one wave
//     runs.  Each split writes its f32 partial tile to a scratch buffer;
//     the last block of a tile to finish (a per-tile counter, which it
//     resets to 0 for the next call) sums the partials in split order, so
//     every run gives the same bits, and writes the output.  One launch a
//     call; no atomic touches the data.  The partials go through shared
//     memory, so they leave and return as 16-byte pieces of whole rows.
//   * The epilogue is one multiply by scale[col] and one rounding; without
//     split K it goes straight from the accumulators, 4 consecutive
//     columns a store (8 bytes of bf16 / f16: 4 threads fill a 32-byte
//     sector).
//   * Ragged M, N and K are bounds-checked (zero-filled copies at the
//     edges), never padded on the host; a view whose rows are not aligned
//     for the copies is read with element loads.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch.
// The caller makes the tensors' device current; nothing is allocated.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kThreads = 256;
constexpr int kWRawLd = kBN + 16;   // int8 w staging row stride (bytes)
constexpr int kTLd = kBN + 4;       // the f32 tile's row stride (split K), over the ring at the end

enum Kind { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies of 16 or 8 bytes; bytes past src_bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
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

// The mma operand format: f16 for f16 x, bf16 otherwise.
template <int XKIND>
struct Op {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // one word of int8 w[k][n], w[k][n + 1], w[k + 1][n], w[k + 1][n + 1] (low
  // byte first) -> the B words {w[k][n], w[k + 1][n]} (even) and {w[k][n + 1],
  // w[k + 1][n + 1]} (odd) in bf16, exactly: byte b of u = w ^ 0x80808080 is
  // v + 128, the float with bits 0x4B0000bb is 2**23 + v + 128, and an
  // integer of 8 bits is its float's upper half
  static __device__ __forceinline__ void convert_pair(uint32_t w, uint32_t& even, uint32_t& odd) {
    const uint32_t u = w ^ 0x80808080u;
    uint32_t f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b)) - 8388736.f);
    even = __byte_perm(f[0], f[2], 0x7632);
    odd = __byte_perm(f[1], f[3], 0x7632);
  }
};

template <>
struct Op<kF16> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // as above in f16: the half with bits 0x64bb is 1024 + bb, so 0x64 above
  // v + 128, minus 1152, is v
  static __device__ __forceinline__ void convert_pair(uint32_t w, uint32_t& even, uint32_t& odd) {
    const uint32_t u = w ^ 0x80808080u;
    const uint32_t e = __byte_perm(u, 0x64646464u, 0x4240);  // bytes 0, 2
    const uint32_t o = __byte_perm(u, 0x64646464u, 0x4341);  // bytes 1, 3
    const __half2 bias = __floats2half2_rn(1152.f, 1152.f);
    const __half2 he = __hsub2(*reinterpret_cast<const __half2*>(&e), bias);
    const __half2 ho = __hsub2(*reinterpret_cast<const __half2*>(&o), bias);
    even = *reinterpret_cast<const uint32_t*>(&he);
    odd = *reinterpret_cast<const uint32_t*>(&ho);
  }
};

__device__ __forceinline__ void store1(void* out, int64_t i, float v, int out_kind) {
  if (out_kind == kF32) {
    static_cast<float*>(out)[i] = v;
  } else if (out_kind == kBF16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<__half*>(out)[i] = __float2half_rn(v);
  }
}

struct Args {
  const void* x;
  const int8_t* w;
  const float* scale;
  void* out;
  float* partials;   // (splits, tiles, 128 * 128) f32, when splits > 1
  int* counters;     // one per output tile, 0 between calls, when splits > 1
  int M, N, K;
  long long lda, ldw;
  int out_kind;
  int vec_x;         // x rows are 16-byte aligned
  int w_align;       // widest aligned copy of w rows: 16, 8 or 1 bytes
  int splits, tiles_per_split;
};

// The k-tile and the ring, by x's kind, and the shared memory they take.
template <int XKIND>
struct Layout {
  static constexpr int kBK = XKIND == kF32 ? 32 : 64;
  static constexpr int kStages = XKIND == kF32 ? 5 : 4;
  static constexpr int kXElt = XKIND == kF32 ? 4 : 2;
  static constexpr int kXLd = kBK + 8;                                             // bf16 / f16 x row stride (elements)
  static constexpr int kXRawLd = kBK + 4;                                          // f32 x staging row stride (floats)
  static constexpr int kXStage = XKIND == kF32 ? kBM * kXRawLd * 4 : kBM * kXLd * 2;  // bytes
  static constexpr int kWStage = kBK * kWRawLd;                                    // bytes
  static constexpr int kXSplit = XKIND == kF32 ? 3 * kBM * kXLd * 2 : 0;           // bytes
  // [x stages][w stages][2 x splits (f32)], and at the end the f32 tile of split K
  static constexpr int kRing = kStages * (kXStage + kWStage) + 2 * kXSplit;
  static constexpr int kBytes = kRing > kBM * kTLd * 4 ? kRing : kBM * kTLd * 4;
};

// Copies of one k-tile into a stage.  Each thread's rows and columns are
// fixed for the whole loop, so they are computed once.
template <int XKIND>
struct Loader {
  using L = Layout<XKIND>;
  static constexpr int kXPer = 16 / L::kXElt;                      // x elements a 16-byte copy
  static constexpr int kXCopies = kBM * L::kBK / kXPer / kThreads;  // 4 for either kind
  static constexpr int kXLdS = XKIND == kF32 ? L::kXRawLd : L::kXLd;
  const unsigned char* xrow[kXCopies];  // the row's first k-tile, nullptr for a row past M
  uint32_t xdst[kXCopies];              // byte offset in a stage
  int xk;                               // the copies' column in the k-tile
  const int8_t* wcol;                   // w at row 0 of the thread's first row, its column
  int wrow, wn, wcopies, wstep;         // first row, column in N, copies and row step a k-tile
  uint32_t wdst;

  __device__ __forceinline__ Loader(const Args& a, int m0, int n0) {
    const int tid = threadIdx.x;
    constexpr int kChunks = L::kBK / kXPer;
    xk = (tid % kChunks) * kXPer;
#pragma unroll
    for (int u = 0; u < kXCopies; ++u) {
      const int r = tid / kChunks + u * (kThreads / kChunks);
      const int m = m0 + r;
      xrow[u] = m < a.M ? static_cast<const unsigned char*>(a.x) + (static_cast<int64_t>(m) * a.lda + xk) * L::kXElt
                        : nullptr;
      xdst[u] = (r * kXLdS + xk) * L::kXElt;
    }
    const int wa = a.w_align > 1 ? a.w_align : 16;  // element loads keep the 16-byte mapping
    const int per_row = kBN / wa;
    wcopies = L::kBK * per_row / kThreads;
    wstep = kThreads / per_row;
    wrow = tid / per_row;
    wn = n0 + (tid % per_row) * wa;
    wcol = a.w + wn;
    wdst = wrow * kWRawLd + (tid % per_row) * wa;
  }

  __device__ __forceinline__ void load(const Args& a, int kt, unsigned char* xstage, int8_t* wstage) const {
    const int k0 = kt * L::kBK;
    const int kx = k0 + xk;
    if (a.vec_x) {
      const int valid = min(max(a.K - kx, 0), kXPer) * L::kXElt;
#pragma unroll
      for (int u = 0; u < kXCopies; ++u) {
        const bool live = xrow[u] != nullptr && valid > 0;
        cp_async16(smem_addr(xstage + xdst[u]), live ? xrow[u] + k0 * L::kXElt : a.x, live ? valid : 0);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kXCopies; ++u) {
#pragma unroll
        for (int e = 0; e < kXPer; ++e) {
          const bool live = xrow[u] != nullptr && kx + e < a.K;
          if (XKIND == kF32) {
            reinterpret_cast<float*>(xstage + xdst[u])[e] = live ? reinterpret_cast<const float*>(xrow[u] + k0 * 4)[e] : 0.f;
          } else {
            reinterpret_cast<uint16_t*>(xstage + xdst[u])[e] =
                live ? reinterpret_cast<const uint16_t*>(xrow[u] + k0 * 2)[e] : uint16_t(0);
          }
        }
      }
    }
    const int wa = a.w_align;
    const int wvalid = min(max(a.N - wn, 0), wa > 1 ? wa : 16);
    if (wa == 16) {  // kBK x kBN int8 over 256 threads: a 16-byte copy each, every 32 rows
#pragma unroll
      for (int u = 0; u < L::kBK / 32; ++u) {
        const int k = k0 + wrow + 32 * u;
        const int valid = k < a.K ? wvalid : 0;
        cp_async16(smem_addr(wstage + wdst + 32 * u * kWRawLd), valid ? wcol + static_cast<int64_t>(k) * a.ldw : a.w,
                   valid);
      }
      return;
    }
    for (int u = 0; u < wcopies; ++u) {
      const int r = wrow + u * wstep;
      const int k = k0 + r;
      const int valid = k < a.K ? wvalid : 0;
      const int8_t* src = valid ? wcol + static_cast<int64_t>(k) * a.ldw : a.w;
      const int dst = wdst + u * wstep * kWRawLd;
      if (wa == 8) {
        cp_async8(smem_addr(wstage + dst), src, valid);
      } else {
        for (int e = 0; e < 16; ++e) wstage[dst + e] = e < valid ? src[e] : int8_t(0);
      }
    }
  }
};

// f32 x stage -> three bf16 terms hi, mid, lo ([3][kBM][kXLd]), 16 values a thread.
__device__ __forceinline__ void split_x(const float* __restrict__ xstage, uint16_t* __restrict__ xsplit) {
  using L = Layout<kF32>;
  const int r = threadIdx.x / 2;
  const int c = (threadIdx.x % 2) * 16;
  const float* src = xstage + r * L::kXRawLd + c;
#pragma unroll
  for (int e = 0; e < 16; e += 2) {
    uint32_t words[3] = {0u, 0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x = src[e + h];
      const __nv_bfloat16 hi = __float2bfloat16_rn(x);
      const float r1 = x - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      const __nv_bfloat16 lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
      words[0] |= static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << (16 * h);
      words[1] |= static_cast<uint32_t>(__bfloat16_as_ushort(mid)) << (16 * h);
      words[2] |= static_cast<uint32_t>(__bfloat16_as_ushort(lo)) << (16 * h);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) *reinterpret_cast<uint32_t*>(xsplit + q * kBM * L::kXLd + r * L::kXLd + c + e) = words[q];
  }
}

// f32 x runs three products per pair and is used at small M: one block an SM
// with the registers it needs; 16-bit x, two blocks an SM.
template <int XKIND>
__global__ void __launch_bounds__(kThreads, XKIND == kF32 ? 1 : 2) int8_matmul_mma_kernel(Args a) {
  using L = Layout<XKIND>;
  constexpr int kBK = L::kBK;
  constexpr int kStages = L::kStages;
  constexpr int kXLd = L::kXLd;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;  // split-K: this block is the last of its tile
  unsigned char* xstages = smem;
  int8_t* wstages = reinterpret_cast<int8_t*>(smem + kStages * L::kXStage);
  uint16_t* xsplits = reinterpret_cast<uint16_t*>(smem + kStages * (L::kXStage + L::kWStage));
  constexpr int kTerms = XKIND == kF32 ? 3 : 1;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int lm = lane >> 3;
  const int lr = lane & 7;
  const int wm = warp >> 2;  // warp row: 64 rows
  const int wn = warp & 3;   // warp column: 32 columns
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int split = blockIdx.z;

  const int k_tiles = (a.K + kBK - 1) / kBK;
  const int kt0 = split * a.tiles_per_split;
  const int nk = max(min(kt0 + a.tiles_per_split, k_tiles) - kt0, 0);
  const Loader<XKIND> loader(a, m0, n0);

  // n8 tiles 2 p (even columns) and 2 p + 1 (odd columns) of the warp's
  // p-th 16 columns
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // m16 tiles of this warp that hold a row of x (warp-uniform; rows past M
  // are zero-filled, so a warp with any live row multiplies all four)
  const int live_m = min(max((a.M - m0 - wm * 64 + 15) / 16, 0), 4);

  // The ring: k-tile t's copies land in stage t % kStages, and one barrier
  // a k-tile orders them and the reads (f32 x: and the split of tile t + 1
  // into buffer (t + 1) % 2 during tile t's MMAs).
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) loader.load(a, kt0 + s, xstages + s * L::kXStage, wstages + s * L::kWStage);
    cp_async_commit();
  }
  if (XKIND == kF32 && nk > 0) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    split_x(reinterpret_cast<const float*>(xstages), xsplits);
  }

  for (int t = 0; t < nk; ++t) {
    // k-tile t (f32 x: t + 1, split during tile t's MMAs) has landed
    if (XKIND == kF32) {
      cp_async_wait<kStages - 3>();
    } else {
      cp_async_wait<kStages - 2>();
    }
    __syncthreads();  // ... for every thread; every warp is done with tile t - 1
    {
      const int nt = t + kStages - 1;
      const int s = nt % kStages;
      if (nt < nk) loader.load(a, kt0 + nt, xstages + s * L::kXStage, wstages + s * L::kWStage);
      cp_async_commit();
    }
    if (live_m > 0) {  // a warp of rows past M (small M) has nothing to multiply
      const uint16_t* xs = XKIND == kF32 ? xsplits + (t & 1) * 3 * kBM * kXLd
                                         : reinterpret_cast<const uint16_t*>(xstages + (t % kStages) * L::kXStage);
      const int8_t* ws = wstages + (t % kStages) * L::kWStage;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // one ldmatrix.x4.trans of int8 pairs: 16 k x the warp's 32 columns
        uint32_t raw[4];
        ldmatrix_x4_trans(raw, smem_addr(ws + (kk * 16 + (lm & 1) * 8 + lr) * kWRawLd + wn * 32 + (lm >> 1) * 16));
        uint32_t bw[4][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          Op<XKIND>::convert_pair(raw[h], bw[0][h], bw[1][h]);
          Op<XKIND>::convert_pair(raw[2 + h], bw[2][h], bw[3][h]);
        }
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t ax[4];
            ldmatrix_x4(ax, smem_addr(xs + term * kBM * kXLd + (wm * 64 + i * 16 + (lm & 1) * 8 + lr) * kXLd +
                                      kk * 16 + (lm >> 1) * 8));
#pragma unroll
            for (int j = 0; j < 4; ++j) Op<XKIND>::mma(acc[i][j], ax, bw[j][0], bw[j][1]);
          }
        }
      }
    }
    // f32 x: tile t + 1 is split while tile t's MMAs drain
    if (XKIND == kF32 && t + 1 < nk) {
      const int s = (t + 1) % kStages;
      split_x(reinterpret_cast<const float*>(xstages + s * L::kXStage), xsplits + ((t + 1) & 1) * 3 * kBM * kXLd);
    }
  }

  // A thread holds, for rows g and g + 8 of each m16 tile, the 4
  // consecutive columns 16 p + 4 tig .. + 3 of each p: acc[i][2 p][2 h],
  // acc[i][2 p + 1][2 h], acc[i][2 p][2 h + 1], acc[i][2 p + 1][2 h + 1].
  if (a.splits == 1) {  // the epilogue straight from the accumulators
    if (live_m > 0) {
      const bool vec_out = a.N % 4 == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int n = n0 + wn * 32 + 16 * p + 4 * tig;
        if (n >= a.N) continue;
        float sc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[e] = n + e < a.N ? __ldg(a.scale + n + e) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm * 64 + 16 * i + g + 8 * h;
            if (m >= a.M) continue;
            float v[4] = {acc[i][2 * p][2 * h], acc[i][2 * p + 1][2 * h], acc[i][2 * p][2 * h + 1],
                          acc[i][2 * p + 1][2 * h + 1]};
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = __fmul_rn(v[e], sc[e]);
            const int64_t at = static_cast<int64_t>(m) * a.N + n;
            if (vec_out && n + 4 <= a.N) {
              if (a.out_kind == kF32) {
                *reinterpret_cast<float4*>(static_cast<float*>(a.out) + at) = make_float4(v[0], v[1], v[2], v[3]);
              } else if (a.out_kind == kBF16) {
                const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
                *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + at) =
                    make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
              } else {
                const __half2 lo = __floats2half2_rn(v[0], v[1]), hi = __floats2half2_rn(v[2], v[3]);
                *reinterpret_cast<uint2*>(static_cast<__half*>(a.out) + at) =
                    make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
              }
            } else {
              for (int e = 0; e < 4 && n + e < a.N; ++e) store1(a.out, at + e, v[e], a.out_kind);
            }
          }
      }
    }
    return;
  }

  // Split K: the tile goes through shared memory as f32 ([kBM][kBN + 4]), so
  // the partials leave and return as 16-byte pieces of whole rows.
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: its memory holds the tile now
  float* tile = reinterpret_cast<float*>(smem);
  if (live_m > 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(tile + (wm * 64 + 16 * i + g + 8 * h) * kTLd + wn * 32 + 16 * p + 4 * tig) =
              make_float4(acc[i][2 * p][2 * h], acc[i][2 * p + 1][2 * h], acc[i][2 * p][2 * h + 1],
                          acc[i][2 * p + 1][2 * h + 1]);
  }
  const int rows = min(kBM, a.M - m0);  // rows of the tile inside the output
  const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
  __syncthreads();
  // this split's partial tile, rows [0, rows): the 128 columns as 32 float4
  float4* part = reinterpret_cast<float4*>(a.partials + (static_cast<int64_t>(split) * gridDim.x * gridDim.y + tile_id) * kBM * kBN);
  for (int i = tid; i < rows * (kBN / 4); i += kThreads) {
    const int r = i / (kBN / 4);
    const int c = (i % (kBN / 4)) * 4;
    part[i] = *reinterpret_cast<const float4*>(tile + r * kTLd + c);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = a.counters + tile_id;
    last = atomicAdd(counter, 1) == a.splits - 1;
    if (last) *counter = 0;  // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the partials in split order, the same bits whichever block ends last;
  // four splits' loads are in flight before their adds
  for (int i = tid; i < rows * (kBN / 4); i += kThreads) {
    const float4* base = reinterpret_cast<const float4*>(a.partials + static_cast<int64_t>(tile_id) * kBM * kBN) + i;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * gridDim.y * kBM * kBN / 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < a.splits; q += 4) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = q + u < a.splits ? __ldcg(base + (q + u) * stride) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q + u >= a.splits) break;
        sum.x += v[u].x;
        sum.y += v[u].y;
        sum.z += v[u].z;
        sum.w += v[u].w;
      }
    }
    const int r = i / (kBN / 4);
    const int c = (i % (kBN / 4)) * 4;
    *reinterpret_cast<float4*>(tile + r * kTLd + c) = sum;
  }
  __syncthreads();

  // epilogue: one multiply by the column's scale, one rounding; a thread
  // writes 8 consecutive columns of a row (16 bytes of bf16 / f16)
  const int out_elt = a.out_kind == kF32 ? 4 : 2;
  const bool vec_out = a.N % 8 == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  for (int i = tid; i < rows * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8);
    const int c = (i % (kBN / 8)) * 8;
    const int n = n0 + c;
    if (n >= a.N) continue;
    const float* src = tile + r * kTLd + c;
    const int64_t at = static_cast<int64_t>(m0 + r) * a.N + n;
    if (vec_out && n + 8 <= a.N) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(src[e], __ldg(a.scale + n + e));
      if (a.out_kind == kF32) {
        float4* d = reinterpret_cast<float4*>(static_cast<float*>(a.out) + at);
        d[0] = make_float4(v[0], v[1], v[2], v[3]);
        d[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        uint32_t words[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (a.out_kind == kBF16) {
            const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
            words[e] = *reinterpret_cast<const uint32_t*>(&b);
          } else {
            const __half2 b = __floats2half2_rn(v[2 * e], v[2 * e + 1]);
            words[e] = *reinterpret_cast<const uint32_t*>(&b);
          }
        }
        *reinterpret_cast<uint4*>(static_cast<unsigned char*>(a.out) + at * out_elt) =
            make_uint4(words[0], words[1], words[2], words[3]);
      }
    } else {
      for (int e = 0; e < 8 && n + e < a.N; ++e) store1(a.out, at + e, __fmul_rn(src[e], __ldg(a.scale + n + e)), a.out_kind);
    }
  }
}

template <int XKIND>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int bytes = Layout<XKIND>::kBytes;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM, a.splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(int8_matmul_mma_kernel<XKIND>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int8_matmul_mma_kernel<XKIND><<<grid, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) of x_kind with row stride lda (elements), unit column stride;
// w: (K, N) int8 with row stride ldw; scale: (N,) f32; out: (M, N)
// contiguous of out_kind.  vec_x: x's base and row stride are 16-byte
// aligned; w_align: the widest of 16 and 8 bytes that w's base and row
// stride are aligned to (else 1).  splits: the number of K slices (1 for
// none), each a whole number of k-tiles (64 deep for bf16 / f16 x, 32 for
// f32); with more, partials is a (splits, tiles, 128 * 128) f32 scratch
// buffer (tiles = the 128 x 128 output tiles) and counters holds one int
// per output tile, all 0 (the kernel leaves them 0).
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, void* out, int M, int N, int K,
                           long long lda, long long ldw, int x_kind, int out_kind, int vec_x, int w_align,
                           void* partials, void* counters, int splits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || lda < K || ldw < N || splits < 1 || out_kind < kF32 || out_kind > kF16 ||
      (w_align != 1 && w_align != 8 && w_align != 16) ||
      (splits > 1 && (partials == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = x;
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.partials = static_cast<float*>(partials);
  a.counters = static_cast<int*>(counters);
  a.M = M;
  a.N = N;
  a.K = K;
  a.lda = lda;
  a.ldw = ldw;
  a.out_kind = out_kind;
  a.vec_x = vec_x;
  a.w_align = w_align;
  a.splits = splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bk = x_kind == kF32 ? Layout<kF32>::kBK : Layout<kBF16>::kBK;
  a.tiles_per_split = ((K + bk - 1) / bk + splits - 1) / splits;
  switch (x_kind) {
    case kF32:
      return static_cast<int>(launch<kF32>(a, s));
    case kBF16:
      return static_cast<int>(launch<kBF16>(a, s));
    case kF16:
      return static_cast<int>(launch<kF16>(a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
