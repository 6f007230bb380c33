// B1-latent — LKA chunk bounds over MLA latent boxes (one kv head).
//
// Replaces, for DeepSeek-class MLA models, the reference engine's jnp call
// repro/serving/engine.py:_select_chunks_batched ->
// repro/core/bounds.py:chunk_bounds_gqa_matmul at Hkv = 1 (the absorbed
// query concat(q_lat, q_rope) against the store's latent min/max boxes),
// which equals repro/core/bounds.py:62 chunk_bounds_mla.  No Pallas kernel
// of the reference computes it; B1 (chunk_bounds.cu) is its GQA sibling.
//
//   ub[b, c] = sum_h (q_h+ . kmax[b, c] + q_h- . kmin[b, c])
//   lb[b, c] = sum_h (q_h+ . kmin[b, c] + q_h- . kmax[b, c])
//
// What bounds it on the H100: bytes, and at its size the latency of
// fetching them.  At deepseek-v2-lite's shape (16 heads, rows of 576, four
// sequences of up to 57 chunks) it reads ~1 MB of f32 boxes and 74 KB of
// q — 0.3 us at 3.35 TB/s — so what costs is the number of dependent
// round trips to memory a block makes, and how many SMs make them.
//
// Design: since every head meets the same box, the bound is linear in the
// heads' positive and negative parts:
//   ub = (sum_h q_h+) . kmax + (sum_h q_h-) . kmin,
// so a block folds q into the two D-vectors P = sum_h q_h+ and N = sum_h
// q_h- (the heads added in order) and then takes two dot products per
// chunk.  The grid is ceil(nc / 2) x B blocks of 256 threads — two chunks a
// block, 116 blocks at the serve shape (nc 57, B 4), so most of the 132 SMs
// fetch at once.  Everything a block reads is in flight at once, in one
// round trip: thread 0 issues Hopper's 1-D bulk copies (cp.async.bulk,
// completion counted in bytes on one mbarrier) of the block's q (H x D,
// contiguous: 18 KB in bf16) and of each chunk's kmax and kmin rows
// (2.3 KB each, contiguous or strided: one copy a row).  q is then folded
// from shared memory (thread d adds column d of the 16 heads), and 128
// threads a chunk take the dot products with 16-byte shared loads, a
// shuffle sum and a fixed-order sum of the chunk's four warps.  A q that
// is not a whole number of 16-byte pieces (H x D x its size) is copied
// into shared memory by plain loads instead; one too large for shared
// memory (more than 96 KB: many heads) is folded straight from global
// memory.  The sums are f32 in another order than the plain version's (per
// head, then over heads): the two agree to f32 rounding.
#include "common.cuh"

constexpr int kLatThreads = 256;
constexpr int kLatWarps = kLatThreads / 32;
constexpr int kLatChunks = 2;                       // chunks a block
constexpr int kLatThreadsPerChunk = kLatThreads / kLatChunks;
constexpr int kLatMaxD = 1024;
constexpr int kLatQCap = 96 * 1024;                 // q staged up to this

// Shared memory: the barrier, P and N, the block's boxes (chunk c's kmax
// at 2c, kmin at 2c + 1), the warps' sums, then q when staged.
__host__ __device__ constexpr size_t lat_bounds_fixed(int D) {
  return 128 + sizeof(float) * (2 * D + 2 * kLatChunks * D + 2 * kLatWarps);
}

// grid (ceil(nc / kLatChunks), B), kLatThreads threads
template <typename TQ>
__global__ void __launch_bounds__(kLatThreads)
    chunk_bounds_latent_kernel(const TQ* __restrict__ q,
                               const float* __restrict__ kmax,
                               const float* __restrict__ kmin,
                               float* __restrict__ ub, float* __restrict__ lb,
                               int H, int nc, int D, long long k_sb,
                               long long k_sc, int q_staged, int q_bulk,
                               int box_bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* qp = reinterpret_cast<float*>(smem + 128);
  float* qn = qp + D;
  float* box = qn + D;
  float* red = box + 2 * kLatChunks * D;
  TQ* qs = reinterpret_cast<TQ*>(smem + lat_bounds_fixed(D));
  const int b = blockIdx.y, c0 = blockIdx.x * kLatChunks;
  const int n = min(kLatChunks, nc - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const TQ* qb = q + (long long)b * H * D;
  const uint32_t q_bytes = (uint32_t)(H * D * sizeof(TQ));
  const uint32_t row_bytes = (uint32_t)(D * sizeof(float));
  const uint32_t bulk_bytes = (q_staged && q_bulk ? q_bytes : 0) +
                              (box_bulk ? 2 * n * row_bytes : 0);

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && bulk_bytes > 0) {
    mbar_arrive_expect_tx(bar, bulk_bytes);
    if (q_staged && q_bulk) bulk_copy(qs, qb, q_bytes, bar);
    if (box_bulk)
      for (int c = 0; c < n; ++c) {
        const long long o = b * k_sb + (c0 + c) * k_sc;
        bulk_copy(box + 2 * c * D, kmax + o, row_bytes, bar);
        bulk_copy(box + (2 * c + 1) * D, kmin + o, row_bytes, bar);
      }
  }
  // what the bulk copies cannot take, by plain loads beside them
  if (q_staged && !q_bulk)
    for (int i = tid; i < H * D; i += kLatThreads) qs[i] = qb[i];
  if (!box_bulk)
    for (int i = tid; i < n * D; i += kLatThreads) {
      const int c = i / D, d = i - c * D;
      const long long o = b * k_sb + (c0 + c) * k_sc + d;
      box[2 * c * D + d] = kmax[o];
      box[(2 * c + 1) * D + d] = kmin[o];
    }
  __syncthreads();
  if (bulk_bytes > 0) mbar_wait(bar, 0);

  const TQ* qsrc = q_staged ? qs : qb;
  for (int d = tid; d < D; d += kLatThreads) {
    float p = 0.f, m = 0.f;
#pragma unroll 8
    for (int h = 0; h < H; ++h) {
      const float v = to_f32(qsrc[(long long)h * D + d]);
      p += fmaxf(v, 0.f);
      m += fminf(v, 0.f);
    }
    qp[d] = p;
    qn[d] = m;
  }
  __syncthreads();

  const int c = tid / kLatThreadsPerChunk, e = tid % kLatThreadsPerChunk;
  float hi = 0.f, lo = 0.f;
  if (c < n) {
    const float4* p4 = reinterpret_cast<const float4*>(qp);
    const float4* n4 = reinterpret_cast<const float4*>(qn);
    const float4* a4 = reinterpret_cast<const float4*>(box + 2 * c * D);
    const float4* z4 = reinterpret_cast<const float4*>(box + (2 * c + 1) * D);
    for (int d4 = e; d4 < D / 4; d4 += kLatThreadsPerChunk) {
      const float4 a = a4[d4], z = z4[d4], p = p4[d4], m = n4[d4];
      hi += p.x * a.x + m.x * z.x + p.y * a.y + m.y * z.y + p.z * a.z +
            m.z * z.z + p.w * a.w + m.w * z.w;
      lo += p.x * z.x + m.x * a.x + p.y * z.y + m.y * a.y + p.z * z.z +
            m.z * a.z + p.w * z.w + m.w * a.w;
    }
  }
  hi = warp_sum(hi);
  lo = warp_sum(lo);
  if (lane == 0) {
    red[2 * warp] = hi;
    red[2 * warp + 1] = lo;
  }
  __syncthreads();
  if (tid < n) {
    constexpr int wpc = kLatWarps / kLatChunks;     // warps a chunk
    float u = 0.f, l = 0.f;
    for (int w = tid * wpc; w < (tid + 1) * wpc; ++w) {
      u += red[2 * w];
      l += red[2 * w + 1];
    }
    ub[(long long)b * nc + c0 + tid] = u;
    lb[(long long)b * nc + c0 + tid] = l;
  }
}

template <typename TQ>
static int bounds_latent(const void* q, const float* kmax, const float* kmin,
                         float* ub, float* lb, int B, int H, int nc, int D,
                         long long k_sb, long long k_sc, cudaStream_t st) {
  const size_t q_bytes = (size_t)H * D * sizeof(TQ);
  const int q_staged = q_bytes <= (size_t)kLatQCap;
  // bulk copies: 16-byte aligned addresses, sizes a multiple of 16
  const int q_bulk = q_bytes % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int box_bulk = reinterpret_cast<uintptr_t>(kmax) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(kmin) % 16 == 0;
  const size_t smem = lat_bounds_fixed(D) + (q_staged ? q_bytes : 0);
  const int e = smem_opt_in(chunk_bounds_latent_kernel<TQ>, smem);
  if (e != 0) return e;
  const dim3 grid((nc + kLatChunks - 1) / kLatChunks, B);
  chunk_bounds_latent_kernel<TQ><<<grid, kLatThreads, smem, st>>>(
      static_cast<const TQ*>(q), kmax, kmin, ub, lb, H, nc, D, k_sb, k_sc,
      q_staged, q_bulk, box_bulk);
  return (int)cudaGetLastError();
}

// q: (B, H, D) contiguous of dtype q_dtype (LeoamDType); kmax/kmin: f32
// rows of D contiguous values at element offset b*k_sb + c*k_sc (one kv
// head), 16-byte aligned with strides a multiple of 4; D a multiple of 4
// up to 1024; ub/lb: (B, 1, nc) f32.
extern "C" int leoam_chunk_bounds_latent(const void* q, const void* kmax,
                                         const void* kmin, void* ub, void* lb,
                                         int B, int H, int nc, int D,
                                         int q_dtype, long long k_sb,
                                         long long k_sc, void* stream) {
  if (D < 4 || D > kLatMaxD || D % 4 != 0 || H <= 0 || k_sb % 4 != 0 ||
      k_sc % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || nc == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(kmax);
  const float* kn = static_cast<const float*>(kmin);
  float* u = static_cast<float*>(ub);
  float* l = static_cast<float*>(lb);
  switch (q_dtype) {
    case LEOAM_F32:
      return bounds_latent<float>(q, km, kn, u, l, B, H, nc, D, k_sb, k_sc,
                                  st);
    case LEOAM_F16:
      return bounds_latent<__half>(q, km, kn, u, l, B, H, nc, D, k_sb, k_sc,
                                   st);
    case LEOAM_BF16:
      return bounds_latent<__nv_bfloat16>(q, km, kn, u, l, B, H, nc, D, k_sb,
                                          k_sc, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
