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
// What bounds it on the H100: at deepseek-v2-lite's shape (16 heads, rows
// of 576, four sequences of up to 57 chunks) the bytes are ~1 MB of f32
// boxes — 0.3 us at 3.35 TB/s — so its time is the ~5 us launch floor.
// What shapes the design is the query: B1 reads q for every (chunk, b)
// block, and with 16 heads on one box that q (18 KB in bf16) is four times
// the chunk's own 4.6 KB of abstracts.
//
// Design: since every head meets the same box, the bound is linear in the
// heads' positive and negative parts:
//   ub = (sum_h q_h+) . kmax + (sum_h q_h-) . kmin,
// so a block first folds q into the two D-vectors P = sum_h q_h+ and
// N = sum_h q_h- in shared memory (q read once per block, coalesced over
// d; the fold's loads unrolled, so their latencies overlap).  The grid is
// ceil(nc / 8) blocks of 8 warps per sequence, and each warp takes one
// chunk of a grid-stride loop: 16-byte __ldg loads of the chunk's kmax and
// kmin rows, the two products per lane, a shuffle reduction, one write of
// ub and lb.  So q is folded once per 8 chunks instead of once per chunk.  The sums are
// f32 in another order than the plain version's (per head, then over
// heads): the two agree to f32 rounding.
#include "common.cuh"

constexpr int kLatWarps = 8;
constexpr int kLatMaxD = 1024;

// grid (blocks per sequence, B), kLatWarps warps
template <typename TQ>
__global__ void __launch_bounds__(kLatWarps * 32)
    chunk_bounds_latent_kernel(const TQ* __restrict__ q,
                               const float* __restrict__ kmax,
                               const float* __restrict__ kmin,
                               float* __restrict__ ub, float* __restrict__ lb,
                               int H, int nc, int D, long long k_sb,
                               long long k_sc) {
  __shared__ __align__(16) float qp[kLatMaxD];
  __shared__ __align__(16) float qn[kLatMaxD];
  const int b = blockIdx.y;
  const TQ* qb = q + (long long)b * H * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float p = 0.f, n = 0.f;
#pragma unroll 8
    for (int h = 0; h < H; ++h) {
      const float v = to_f32(qb[(long long)h * D + d]);
      p += fmaxf(v, 0.f);
      n += fminf(v, 0.f);
    }
    qp[d] = p;
    qn[d] = n;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n4 = D >> 2;
  const float4* p4 = reinterpret_cast<const float4*>(qp);
  const float4* n4v = reinterpret_cast<const float4*>(qn);
  for (int c = blockIdx.x * kLatWarps + warp; c < nc;
       c += gridDim.x * kLatWarps) {
    const long long o = b * k_sb + c * k_sc;
    const float4* a4 = reinterpret_cast<const float4*>(kmax + o);
    const float4* z4 = reinterpret_cast<const float4*>(kmin + o);
    float hi = 0.f, lo = 0.f;
    for (int d4 = lane; d4 < n4; d4 += 32) {
      const float4 a = __ldg(a4 + d4), z = __ldg(z4 + d4);
      const float4 p = p4[d4], n = n4v[d4];
      hi += p.x * a.x + n.x * z.x + p.y * a.y + n.y * z.y + p.z * a.z +
            n.z * z.z + p.w * a.w + n.w * z.w;
      lo += p.x * z.x + n.x * a.x + p.y * z.y + n.y * a.y + p.z * z.z +
            n.z * a.z + p.w * z.w + n.w * a.w;
    }
    hi = warp_sum(hi);
    lo = warp_sum(lo);
    if (lane == 0) {
      ub[(long long)b * nc + c] = hi;
      lb[(long long)b * nc + c] = lo;
    }
  }
}

template <typename TQ>
static void bounds_latent(const void* q, const float* kmax, const float* kmin,
                          float* ub, float* lb, int B, int H, int nc, int D,
                          long long k_sb, long long k_sc, cudaStream_t st) {
  const dim3 grid((nc + kLatWarps - 1) / kLatWarps, B);
  chunk_bounds_latent_kernel<TQ><<<grid, kLatWarps * 32, 0, st>>>(
      static_cast<const TQ*>(q), kmax, kmin, ub, lb, H, nc, D, k_sb, k_sc);
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
      bounds_latent<float>(q, km, kn, u, l, B, H, nc, D, k_sb, k_sc, st);
      break;
    case LEOAM_F16:
      bounds_latent<__half>(q, km, kn, u, l, B, H, nc, D, k_sb, k_sc, st);
      break;
    case LEOAM_BF16:
      bounds_latent<__nv_bfloat16>(q, km, kn, u, l, B, H, nc, D, k_sb, k_sc,
                                   st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
