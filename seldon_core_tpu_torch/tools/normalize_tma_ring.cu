// The TMA-ring variant of K1 (fused_normalize), timed in turns with
// ops/csrc/fused_normalize.cu by probe_normalize.py; not on any served path.
//
// Persistent blocks, one an SM.  A block walks whole chunks of blockDim.x
// units of 48 bytes (16 RGB pixels a thread): one thread asks the TMA unit
// for each chunk (cp.async.bulk global -> shared, counted on the stage's
// mbarrier, kStages chunks in flight), every thread converts its 48 bytes
// from shared memory into a bf16 staging buffer (two, alternating), and one
// thread writes the chunk back with a bulk store, both with the direct
// design's L2 policies (input evict_first, output evict_last).  The bytes past the last
// whole chunk take the direct design's vectors and scalar tail.
//
// Only u8 -> bf16 with C = 3 takes the ring; every other call goes to the
// direct design.  Built with -I ops/csrc; same C interface.

#define fused_normalize_u8 fused_normalize_u8_direct
#include "fused_normalize.cu"
#undef fused_normalize_u8

namespace {

constexpr int kStages = 4;     // input chunks in flight a block
constexpr int kBarBytes = 128;  // the stages' mbarriers, before the buffers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// `bytes` of the input into stage buffer `dst`, counted on `bar`, with the
// direct design's L2 policy for the input
__device__ __forceinline__ void ring_load(uint8_t* dst, const uint8_t* src, uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
               " [%0], [%1], %2, [%3], %4;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar), "l"(policy) : "memory");
}

__global__ void __launch_bounds__(kMaxThreads)
normalize_ring_kernel(const uint8_t* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift, void* __restrict__ out, int64_t n, int64_t chunks) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const uint32_t in_bytes = 48u * T, out_bytes = 96u * T;
  uint8_t* in = smem + kBarBytes;
  uint8_t* staged = in + kStages * in_bytes;
  const uint32_t bar0 = smem_addr(smem);
  float s[3], h[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s[c] = __ldg(scale + c);
    h[c] = __ldg(shift + c);
  }
  const int64_t mine = chunks > blockIdx.x ? (chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const uint64_t in_policy = input_policy(), out_policy = output_policy();
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8 * st) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int64_t i = 0; i < kStages && i < mine; ++i) {
      ring_load(in + i * in_bytes, x + (blockIdx.x + i * gridDim.x) * in_bytes, in_bytes, bar0 + 8 * i, in_policy);
    }
  }
  __syncthreads();
  for (int64_t i = 0; i < mine; ++i) {
    const int st = static_cast<int>(i % kStages);
    const int64_t chunk = blockIdx.x + i * gridDim.x;
    mbar_wait(bar0 + 8 * st, static_cast<uint32_t>((i / kStages) & 1));
    const uint4* src = reinterpret_cast<const uint4*>(in + st * in_bytes + 48 * tid);
    const uint4 raw[3] = {src[0], src[1], src[2]};
    uint8_t* buf = staged + (i & 1) * out_bytes;
    // the bulk store of two chunks ago has read this staging buffer
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncthreads();  // every thread holds its input: the stage is free
    if (tid == 0 && i + kStages < mine) {
      ring_load(in + st * in_bytes, x + (chunk + kStages * gridDim.x) * in_bytes, in_bytes, bar0 + 8 * st,
                in_policy);
    }
    uint4* dst = reinterpret_cast<uint4*>(buf + 96 * tid);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const uint32_t words[4] = {raw[q].x, raw[q].y, raw[q].z, raw[q].w};
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k0 = 2 * j, k1 = 2 * j + 1, c0 = (16 * q + k0) % 3, c1 = (16 * q + k1) % 3;
        w[j] = pack2<kBF16>(affine(byte_as_float(words[k0 >> 2], k0 & 3), s[c0], h[c0]),
                            affine(byte_as_float(words[k1 >> 2], k1 & 3), s[c1], h[c1]));
      }
      dst[2 * q] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[2 * q + 1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n"
                   ::"l"(static_cast<uint8_t*>(out) + chunk * out_bytes), "r"(smem_addr(buf)), "r"(out_bytes),
                     "l"(out_policy) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  // past the last whole chunk: the direct design's vectors, then the scalar tail
  const int64_t g = static_cast<int64_t>(blockIdx.x) * T + tid, stride = static_cast<int64_t>(gridDim.x) * T;
  normalize_vectors<kBF16, 3>(x, scale, shift, out, chunks * 3 * T, n / kVec, g, stride);
  normalize_tail<kBF16>(x, scale, shift, out, n / kVec * kVec, n, 3, g, stride);
}

}  // namespace

extern "C" int fused_normalize_u8(const void* x, const void* scale, const void* shift, void* out, long long n,
                                  int channels, int out_kind, int blocks, int threads, void* stream) {
  if (out_kind != kBF16 || channels != 3) {
    return fused_normalize_u8_direct(x, scale, shift, out, n, channels, out_kind, blocks, threads, stream);
  }
  if (n <= 0) return 0;
  if (threads <= 0 || threads > kMaxThreads || threads % 32) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = kBarBytes + (kStages * 48 + 2 * 96) * threads;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(normalize_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chunks = n / (48LL * threads);
  // the remainder's rule (normalize_vectors): a grid of 3k blocks
  const long long grid = ((chunks < sms ? (chunks > 0 ? chunks : 1) : sms) + 2) / 3 * 3;
  normalize_ring_kernel<<<static_cast<unsigned>(grid), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(scale), static_cast<const float*>(shift), out, n,
      chunks);
  return static_cast<int>(cudaGetLastError());
}
