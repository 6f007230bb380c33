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
// paper's MHA model (G = 1) it is a streaming read of the abstracts.
//
// Design: one warp per (b, kv head, chunk); lanes stride the head dim, so a
// warp reads each abstract row as one contiguous segment, and the q group
// (G * hd floats) stays in L1.  Strides are arguments, so the same kernel
// reads the Pallas layout (B, Hkv, nc, hd) and the tier store's layout
// (B, nc, Hkv, hd) directly, without a transpose.  Ragged nc needs no
// padding: warps past nc return.
#include "common.cuh"

__global__ void chunk_bounds_kernel(const float* __restrict__ q,
                                    const float* __restrict__ kmax,
                                    const float* __restrict__ kmin,
                                    float* __restrict__ ub,
                                    float* __restrict__ lb, int Hkv, int G,
                                    int nc, int hd, long long k_sb,
                                    long long k_sh, long long k_sc) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (c >= nc) return;
  const long long koff = b * k_sb + h * k_sh + c * k_sc;
  const float* km = kmax + koff;
  const float* kn = kmin + koff;
  // q: (B, Hkv, G, hd) contiguous — also the (B, H, hd) engine layout
  const float* qb = q + ((long long)b * Hkv + h) * G * hd;
  float hi = 0.f, lo = 0.f;
  for (int d = lane; d < hd; d += 32) {
    const float a = km[d];
    const float z = kn[d];
    for (int g = 0; g < G; ++g) {
      const float qv = qb[g * hd + d];
      const float qp = fmaxf(qv, 0.f);
      const float qn = fminf(qv, 0.f);
      hi += qp * a + qn * z;
      lo += qp * z + qn * a;
    }
  }
  hi = warp_sum(hi);
  lo = warp_sum(lo);
  if (lane == 0) {
    const long long o = ((long long)b * Hkv + h) * nc + c;
    ub[o] = hi;
    lb[o] = lo;
  }
}

// q: (B, Hkv, G, hd) f32 contiguous; kmax/kmin: f32 rows of hd contiguous
// values at element offset b*k_sb + h*k_sh + c*k_sc; ub/lb: (B, Hkv, nc).
extern "C" int leoam_chunk_bounds(const void* q, const void* kmax,
                                  const void* kmin, void* ub, void* lb, int B,
                                  int Hkv, int G, int nc, int hd,
                                  long long k_sb, long long k_sh,
                                  long long k_sc, void* stream) {
  if (B == 0 || nc == 0) return 0;
  const int warps = 8;
  dim3 grid((nc + warps - 1) / warps, Hkv, B);
  chunk_bounds_kernel<<<grid, warps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(kmax),
      static_cast<const float*>(kmin), static_cast<float*>(ub),
      static_cast<float*>(lb), Hkv, G, nc, hd, k_sb, k_sh, k_sc);
  return (int)cudaGetLastError();
}
