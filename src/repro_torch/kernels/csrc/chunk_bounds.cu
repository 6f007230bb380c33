// B1 — LKA chunk importance bounds from min/max key abstracts.
//
// Replaces the Pallas kernel repro/kernels/chunk_bounds/chunk_bounds.py
// (_bounds_kernel, chunk_bounds_pallas; the nc padding in ops.py): two MXU
// matmuls per bound over (TC, hd) abstract tiles,
//   ub = sum_g (q+ . kmax + q- . kmin),  lb = sum_g (q+ . kmin + q- . kmax).
//
// What bounds it on the H100: bytes.  Each output reads one kmax and one
// kmin row of hd f32 values (8 * hd bytes) for 4 * G * hd operations — far
// below the ~295 operations per byte the tensor cores need, so for the
// paper's MHA model (G = 1) it is one streaming read of the abstracts: 7.5
// MB at the main path's shape, about one wave of blocks.  Small per-thread
// loads or a warp per output row would keep too little in flight and pay
// each warp's fixed cost; a cast of q in its own launch would double the
// launch cost, which is as large as the read here.
//
// Design: one block per (chunk, b).  In the tier store's layout (B, nc,
// Hkv, hd) that is Hkv * hd contiguous f32 per plane (16 KB at longchat's
// width).  Each head's row is split over a power-of-two group of lanes
// (hd / 4 lanes up to a warp, two 16-byte vectors a lane past hd 128), and
// every thread issues all its 16-byte ld.global.nc loads of kmax, kmin and
// q (g = 0) for kBoundsUnroll heads before any arithmetic: 32 KB in flight
// per block.  Each head's lanes reduce by shuffles; the G query heads of a
// kv group are summed in the same pass.  q is read in its own dtype (f32,
// fp16 or bf16, a template), so a call is one launch.  Strides are
// arguments: the Pallas layout (B, Hkv, nc, hd) runs through the same code
// (each head's row is still contiguous).  hd is any multiple of 4 up to
// 256; ragged nc needs no padding.
#include "common.cuh"

constexpr int kBoundsWarps = 8;
constexpr int kBoundsUnroll = 4;          // heads a lane group loads at once

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void bound_terms(float4 q, float4 a, float4 z,
                                            float& hi, float& lo) {
  const float qv[4] = {q.x, q.y, q.z, q.w};
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float zv[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const float qp = fmaxf(qv[l], 0.f);
    const float qn = fminf(qv[l], 0.f);
    hi += qp * av[l] + qn * zv[l];
    lo += qp * zv[l] + qn * av[l];
  }
}

// grid (nc, B), kBoundsWarps warps.  A head takes lph = 2^lph_log2 lanes,
// each NV 16-byte vectors of its row; a warp takes 32 / lph heads a pass.
template <typename TQ, int NV>
__global__ void __launch_bounds__(kBoundsWarps * 32)
    chunk_bounds_kernel(const TQ* __restrict__ q,
                        const float* __restrict__ kmax,
                        const float* __restrict__ kmin,
                        float* __restrict__ ub, float* __restrict__ lb,
                        int Hkv, int G, int nc, int hd, int lph_log2,
                        long long k_sb, long long k_sh, long long k_sc) {
  const int c = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lph = 1 << lph_log2;
  const int hpw = 32 >> lph_log2;         // heads a warp takes per pass
  const int j = lane & (lph - 1);
  const int n4 = hd >> 2;
  const long long kb = b * k_sb + c * k_sc;
  // q: (B, Hkv, G, hd) contiguous — also the (B, H, hd) engine layout
  const TQ* qb = q + (long long)b * Hkv * G * hd;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int h0 = 0; h0 < Hkv; h0 += kBoundsUnroll * kBoundsWarps * hpw) {
    float4 a[kBoundsUnroll][NV], z[kBoundsUnroll][NV], q0[kBoundsUnroll][NV];
    int hs[kBoundsUnroll];
#pragma unroll
    for (int u = 0; u < kBoundsUnroll; ++u) {
      const int h = h0 + (u * kBoundsWarps + warp) * hpw + (lane >> lph_log2);
      hs[u] = h;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int d4 = j + v * lph;
        const bool ok = h < Hkv && d4 < n4;
        const long long o = kb + h * k_sh + 4 * d4;
        a[u][v] = ok ? load4(kmax + o) : zero;
        z[u][v] = ok ? load4(kmin + o) : zero;
        q0[u][v] = ok ? load4(qb + (long long)h * G * hd + 4 * d4) : zero;
      }
    }
#pragma unroll
    for (int u = 0; u < kBoundsUnroll; ++u) {
      const int h = hs[u];
      float hi = 0.f, lo = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        bound_terms(q0[u][v], a[u][v], z[u][v], hi, lo);
        const int d4 = j + v * lph;
        if (h < Hkv && d4 < n4) {
          for (int g = 1; g < G; ++g)
            bound_terms(load4(qb + ((long long)h * G + g) * hd + 4 * d4),
                        a[u][v], z[u][v], hi, lo);
        }
      }
      for (int o = lph >> 1; o > 0; o >>= 1) {
        hi += __shfl_xor_sync(0xffffffffu, hi, o);
        lo += __shfl_xor_sync(0xffffffffu, lo, o);
      }
      if (j == 0 && h < Hkv) {
        const long long o = ((long long)b * Hkv + h) * nc + c;
        ub[o] = hi;
        lb[o] = lo;
      }
    }
  }
}

template <typename TQ>
static void bounds(const void* q, const float* kmax, const float* kmin,
                   float* ub, float* lb, int B, int Hkv, int G, int nc, int hd,
                   long long k_sb, long long k_sh, long long k_sc,
                   cudaStream_t st) {
  const int n4 = hd / 4;
  int lph_log2 = 0;
  while ((1 << lph_log2) < n4 && lph_log2 < 5) ++lph_log2;
  const dim3 grid(nc, B);
  const TQ* qp = static_cast<const TQ*>(q);
  if (n4 <= (1 << lph_log2))
    chunk_bounds_kernel<TQ, 1><<<grid, kBoundsWarps * 32, 0, st>>>(
        qp, kmax, kmin, ub, lb, Hkv, G, nc, hd, lph_log2, k_sb, k_sh, k_sc);
  else
    chunk_bounds_kernel<TQ, 2><<<grid, kBoundsWarps * 32, 0, st>>>(
        qp, kmax, kmin, ub, lb, Hkv, G, nc, hd, lph_log2, k_sb, k_sh, k_sc);
}

// q: (B, Hkv, G, hd) contiguous, 16-byte aligned, of dtype q_dtype
// (LeoamDType); kmax/kmin: f32 rows of hd contiguous values at element
// offset b*k_sb + h*k_sh + c*k_sc, the strides multiples of 4 and the
// pointers 16-byte aligned; hd a multiple of 4 up to 256; ub/lb: (B, Hkv,
// nc) f32.
extern "C" int leoam_chunk_bounds(const void* q, const void* kmax,
                                  const void* kmin, void* ub, void* lb, int B,
                                  int Hkv, int G, int nc, int hd, int q_dtype,
                                  long long k_sb, long long k_sh,
                                  long long k_sc, void* stream) {
  if (hd < 4 || hd > 256 || hd % 4 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || nc == 0 || Hkv == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(kmax);
  const float* kn = static_cast<const float*>(kmin);
  float* u = static_cast<float*>(ub);
  float* l = static_cast<float*>(lb);
  switch (q_dtype) {
    case LEOAM_F32:
      bounds<float>(q, km, kn, u, l, B, Hkv, G, nc, hd, k_sb, k_sh, k_sc, st);
      break;
    case LEOAM_F16:
      bounds<__half>(q, km, kn, u, l, B, Hkv, G, nc, hd, k_sb, k_sh, k_sc, st);
      break;
    case LEOAM_BF16:
      bounds<__nv_bfloat16>(q, km, kn, u, l, B, Hkv, G, nc, hd, k_sb, k_sh,
                            k_sc, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
