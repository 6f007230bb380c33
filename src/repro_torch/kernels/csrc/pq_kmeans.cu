// B4 and B5 — online product-quantization k-means (the PQ abstract plane).
//
// Per-subspace key vectors x: (m, N, dsub) f32 (head_dim split into m
// subvectors of dsub lanes) against a codebook cb: (m, K, dsub) f32.
//
// B4 pq_assign replaces repro/kernels/pq/pq_kmeans.py (_assign_kernel,
// pq_assign_pallas): one MXU product of a (TN, dsub) row tile against the
// subspace's (K, dsub) codebook per grid step, then argmin_k(|c_k|^2 -
// 2 x.c_k), the first minimal index.
//
// What bounds it on the H100: the codes must equal the plain version's
// bitwise (the tests compare them exactly, ties to the first index
// included), so the distance that decides a code is the plain version's
// f32 chain: every product and sum __fmul_rn / __fadd_rn in lane order,
// then cn - 2 dot, about 19 f32 instructions per (row, centroid) that
// nvcc never fuses.  At the main path's encode (m 16, N 131 072, K 256,
// dsub 8) that is ~10 G instructions, ~0.35 ms of f32 issue: no scalar
// rewrite gets far under it.  The work is 8.6 GFLOP on 75 MB: ~0.017 ms
// at the 495 TFLOP/s TF32 tensor-core rate against ~0.023 ms of bytes.
//
// Design: a tensor-core screen with an exact re-check.  A warp takes 32
// rows (two 16-row tiles sharing each B fragment) against the whole
// codebook with mma.sync m16n8k8 TF32 (k = 8 is dsub; other dsub pad or
// chain k-steps), forms d~_k = cn_k - 2 acc_k with the exact cn_k staged
// in shared memory, and keeps each row's d~_min.  A second pass recomputes
// d~ and lists every k with d~_k <= d~_min + 2 eps (eps below bounds
// |d~_k - d_k| for every k).  The listed candidates of the warp's 32 rows
// (staged exact in shared memory) go to one queue that all 32 lanes work
// through with the exact chain, and each row keeps the first index of the
// least exact value through a 64-bit atomicMin on (distance, index), whose
// result does not depend on the order of arrival.  The exact minimum is
// always a candidate, so the codes equal the plain version's; forced ties
// make every tied centroid a candidate (slower, still right).  A lane with
// more than kMaxListed candidates for a row, or a row whose eps is not
// finite or above kEpsFull (NaN, inf or huge inputs), checks every
// centroid of its columns, with torch.argmin's rule that a NaN wins.
//
// The bound (u = 2^-24, n = dsub <= 32 products in KS = ceil(n / 8)
// chained k-steps, S = sum_l |x_l c_l| <= ||x||_2 ||c||_2; the same
// computed f32 cn enters both paths).  The screen takes d~ = -2 acc with
// acc = the tensor core's sum of the TF32 products and the C input -cn/2
// (both scalings are exact), the exact chain d = fl(cn - 2 dot):
//   |d~ - d| <= 2|acc - (D - cn/2)| + 2|dot - D| + u|cn - 2 dot|,
//   D = x.c exactly.  TF32 inputs, by truncation or to nearest: x^ =
//   x(1+a), c^ = c(1+b), |a|, |b| < 2^-10, so |sum x^ c^ - D| <= (2^-9 +
//   2^-20) S; the products are exact in f32, and n + KS adds in any order,
//   each truncating, cost at most (n + KS) 2^-23 (1.002 S + |cn|/2).  The
//   exact chain: |dot - D| <= n u S (1 + O(nu)), |dot| <= 1.01 S.  So
//   |d~ - d| <= S (2^-8 + 2^-19 + (n + KS) 2^-22 1.002 + 2.002 n u + 2.02 u)
//              + |cn| ((n + KS) 2^-23 + u)
//            <= kEpsC1 ||x||_2 max_k ||c_k||_2 + kEpsC2 max_k |cn_k|,
//   with kEpsC1 = 4.0e-3 >= 3.921e-3 and kEpsC2 = 2^-17 >= 4.35e-6 at
//   n = 32; kEpsDelta covers products the tensor core flushes as
//   subnormals.  The norms, eps and the threshold are computed rounding up.
// Measured: the mean number of candidates per row (chip_smoke.py).
//
// Where it still falls short: each row runs the codebook through the
// tensor cores twice (the minimum, then the candidates), and the epilogue
// — an FMA and a compare per value — sets the pace, not the product.
//
// B5 pq_update replaces repro/kernels/pq/pq_kmeans.py (_update_kernel,
// pq_update_pallas): a one-hot product per row tile, accumulated across the
// TPU's sequential grid into one (K, dsub) output block.
//
// What bounds it on the H100: bytes (x and the codes are read once, 36
// bytes a row at dsub 8; the sums are K*dsub per subspace).  The work is
// one add per input float, O(N dsub): a thread per centroid scanning every
// code would do O(N K) compares and be bound by their latency instead.
//
// The order is the contract, and pq/ref.py:pq_update_ref repeats it, so
// the kernel equals its plain version bitwise and two launches are equal
// (no float atomics anywhere): the rows of a subspace fall into runs of
// kUpdateRunRows consecutive rows, each summed in row order from +0.0;
// a block's kUpdateWarps runs are folded left in order from +0.0; the
// blocks of a subspace are folded left in order from +0.0.  A code
// outside [0, K) (the padding sentinel K, a negative code) adds nothing.
// Counts are integers and add in any order.
//
// Design: route each row to its centroid.  A warp takes one run, 32 rows
// a step; each lane loads its own row (16-byte loads at dsub >= 4) and
// code into registers.  __match_any_sync groups the step's lanes by code
// (a tile's steps at once, off the adds' critical path): a lane alone
// on its code adds its row into the warp's (K, dsub) f32 accumulator in
// shared memory; a group of g lanes stages its rows in shared memory and
// splits the row's vectors among its lanes, each adding the group's rows
// in lane order (so g rows on one code cost max(g, dsub / 4) dependent
// adds, not g dsub).  Each centroid has one writer per step: no atomics
// but the integer counts.  A warp loads tiles of 8 row vectors a lane,
// double-buffered: the next tile is in flight while one is added.  The block
// folds its warps' accumulators into a partial in scratch.  A second,
// programmatic dependent launch (a thread per 4 sums or per count) folds
// the partials of a subspace in block order and writes every output
// element.
#include <float.h>

#include "common.cuh"

constexpr int kMaxCentroids = 256;

// B5's order (pq/ref.py UPDATE_RUN_ROWS, UPDATE_WARPS)
constexpr int kUpdateRunRows = 1024;      // rows a warp sums in row order
constexpr int kUpdateWarps = 4;           // runs (warps) a block folds

// B4's screen (see the header for the derivation of the bound)
constexpr float kEpsC1 = 4.0e-3f;         // x ||x||_2 max_k ||c_k||_2
constexpr float kEpsC2 = 7.62939453125e-6f;  // 2^-17, x max_k |cn_k|
constexpr float kEpsDelta = 1.0e-30f;
constexpr float kEpsFull = 1.0e30f;       // larger: every centroid checked
constexpr int kAssignWarps = 4;
constexpr int kRT = 2;                    // 16-row tiles a warp takes at once
constexpr int kR = 2 * kRT;               // rows a thread holds
constexpr int kAssignSteps = 8;           // steps of kRT tiles per warp
constexpr int kWarpRows = kRT * 16;       // rows a warp takes per step
constexpr int kAssignRows = kAssignWarps * kAssignSteps * kWarpRows;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += A (16 x 8, rows) . B (8 x 8, columns), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The plain version's distance: lane-order unfused products and sums.
template <int DSUB>
__device__ __forceinline__ float exact_dist(const float* __restrict__ xr,
                                            const float* c, float cn) {
  float dot = __fmul_rn(xr[0], c[0]);
#pragma unroll
  for (int l = 1; l < DSUB; ++l) dot = __fadd_rn(dot, __fmul_rn(xr[l], c[l]));
  return __fsub_rn(cn, __fmul_rn(2.0f, dot));
}

// (exact distance, index) as one key whose least value is the least
// distance with ties to the first index; a NaN sorts first, as
// torch.argmin takes it.
__device__ __forceinline__ unsigned long long dist_key(float d, int n) {
  uint32_t u = __float_as_uint(d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  if (d != d) u = 0;
  return ((unsigned long long)u << 32) | (uint32_t)n;
}

constexpr int kMaxListed = 4;             // candidates a lane lists per row
constexpr int kQueue = 32 * kR * kMaxListed;  // a warp's listed candidates

__device__ __forceinline__ float screen_eps(float xss, float cmax,
                                            float cnmax) {
  return __fadd_ru(__fmul_ru(kEpsC1, __fmul_ru(__fsqrt_ru(xss), cmax)),
                   __fadd_ru(__fmul_ru(kEpsC2, cnmax), kEpsDelta));
}

template <int DSUB>
__global__ void __launch_bounds__(kAssignWarps * 32)
    pq_assign_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                     int* __restrict__ codes,
                     unsigned long long* __restrict__ candidates, int N,
                     int K) {
  constexpr int KS = (DSUB + 7) / 8;       // k-steps of 8 lanes, zero-padded
  constexpr int NTH = kAssignWarps * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NT8 = (K + 7) / 8;             // centroid tiles of 8
  uint2* s_bf = reinterpret_cast<uint2*>(smem_raw);  // (NT8, KS, 32) B frags
  auto* s_best = reinterpret_cast<unsigned long long*>(s_bf + NT8 * KS * 32);
  float* s_cn = reinterpret_cast<float*>(s_best + kAssignWarps * kWarpRows);
  float* s_hn = s_cn + NT8 * 8;            // -cn / 2, the mma's C input
  float* s_cb = s_hn + NT8 * 8;            // (K, DSUB) exact
  float* s_x = s_cb + K * DSUB;            // a warp's rows, exact
  int* s_q = reinterpret_cast<int*>(s_x + kAssignWarps * kWarpRows * DSUB);
  float* s_red = reinterpret_cast<float*>(s_q + kAssignWarps * kQueue);
  const int i = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, tig = lane & 3;

  const float* cbi = cb + (long long)i * K * DSUB;
  for (int e = tid; e < K * DSUB; e += NTH) s_cb[e] = cbi[e];
  __syncthreads();
  float cmax = 0.f, cnmax = 0.f;
  for (int k = tid; k < NT8 * 8; k += NTH) {
    if (k < K) {
      const float* c = s_cb + k * DSUB;
      float cn = __fmul_rn(c[0], c[0]);
      float ss = __fmul_ru(c[0], c[0]);
#pragma unroll
      for (int l = 1; l < DSUB; ++l) {
        cn = __fadd_rn(cn, __fmul_rn(c[l], c[l]));
        ss = __fadd_ru(ss, __fmul_ru(c[l], c[l]));
      }
      s_cn[k] = cn;
      s_hn[k] = -0.5f * cn;
      // a NaN or inf centroid makes every row's eps infinite
      cmax = ss < INFINITY ? fmaxf(cmax, __fsqrt_ru(ss)) : INFINITY;
      cnmax = fmaxf(cnmax, fabsf(cn));
    } else {
      s_cn[k] = INFINITY;                  // padding: never a minimum
      s_hn[k] = -FLT_MAX;
    }
  }
  for (int e = tid; e < NT8 * KS * 32; e += NTH) {
    const int ln = e & 31, ks = (e >> 5) % KS, nt = (e >> 5) / KS;
    const int n = nt * 8 + (ln >> 2), l0 = ks * 8 + (ln & 3);
    const float v0 = n < K && l0 < DSUB ? s_cb[n * DSUB + l0] : 0.f;
    const float v1 = n < K && l0 + 4 < DSUB ? s_cb[n * DSUB + l0 + 4] : 0.f;
    s_bf[e] = make_uint2(to_tf32(v0), to_tf32(v1));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
    cnmax = fmaxf(cnmax, __shfl_xor_sync(0xffffffffu, cnmax, o));
  }
  if (lane == 0) {
    s_red[warp] = cmax;
    s_red[kAssignWarps + warp] = cnmax;
  }
  __syncthreads();
  cmax = cnmax = 0.f;
#pragma unroll
  for (int w = 0; w < kAssignWarps; ++w) {
    cmax = fmaxf(cmax, s_red[w]);
    cnmax = fmaxf(cnmax, s_red[kAssignWarps + w]);
  }

  const float* xi = x + (long long)i * N * DSUB;
  float* sx = s_x + warp * kWarpRows * DSUB;
  int* sq = s_q + warp * kQueue;
  unsigned long long* sb = s_best + warp * kWarpRows;
  unsigned int ncand = 0;
  for (int tt = 0; tt < kAssignSteps; ++tt) {
    const long long r0 = (long long)blockIdx.x * kAssignRows +
                         (long long)(tt * kAssignWarps + warp) * kWarpRows;
    if (r0 >= N) break;                    // uniform across the warp
    // the warp's rows, zeros past N; row lr = 16 rt + 8 h + g of the
    // thread's row slot r = 2 rt + h
    const long long lim = ((long long)N - r0) * DSUB;
    for (int e = lane; e < kWarpRows * DSUB; e += 32)
      sx[e] = e < lim ? xi[r0 * DSUB + e] : 0.f;
    for (int e = lane; e < kWarpRows; e += 32) sb[e] = ~0ull;
    __syncwarp();
    int lrow[kR];
    bool valid[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      lrow[r] = 16 * (r >> 1) + 8 * (r & 1) + g;
      valid[r] = r0 + lrow[r] < N;
    }
    // A fragments (lanes tig and tig + 4 of each k-step) and the thread's
    // share of |x|^2, rounding up
    uint32_t a[kRT][KS][4];
    float ss[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) ss[r] = 0.f;
#pragma unroll
    for (int rt = 0; rt < kRT; ++rt)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 2 * rt + (q & 1), l = ks * 8 + tig + 4 * (q >> 1);
          const float v = l < DSUB ? sx[lrow[r] * DSUB + l] : 0.f;
          a[rt][ks][q] = to_tf32(v);
          ss[r] = __fadd_ru(ss[r], __fmul_ru(v, v));
        }
    float thr[kR];
    bool full[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
        ss[r] = __fadd_ru(ss[r], __shfl_xor_sync(0xffffffffu, ss[r], o));
      thr[r] = screen_eps(ss[r], cmax, cnmax);
      full[r] = !(thr[r] <= kEpsFull);
    }

    // pass 1: each row's least screened distance d~ = -2 acc, where the
    // mma adds -cn / 2 into acc
    float mx[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) mx[r] = -INFINITY;
#pragma unroll 4
    for (int nt = 0; nt < NT8; ++nt) {
      uint2 bf[KS];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) bf[ks] = s_bf[(nt * KS + ks) * 32 + lane];
      const float2 hn = *reinterpret_cast<const float2*>(s_hn + nt * 8 + 2 * tig);
#pragma unroll
      for (int rt = 0; rt < kRT; ++rt) {
        float d[4] = {hn.x, hn.y, hn.x, hn.y};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) mma_tf32(d, a[rt][ks], bf[ks]);
        mx[2 * rt] = fmaxf(mx[2 * rt], fmaxf(d[0], d[1]));
        mx[2 * rt + 1] = fmaxf(mx[2 * rt + 1], fmaxf(d[2], d[3]));
      }
    }
    // candidates: d~ <= d~_min + 2 eps (rounded up), i.e. acc >= tl
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
      thr[r] = -0.5f * __fadd_ru(-2.f * mx[r], 2.f * thr[r]);
    }

    // pass 2: list the candidates, up to kMaxListed per row and lane
    // (packed as bytes)
    uint32_t list[kR];
    int nl[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) list[r] = nl[r] = 0;
#pragma unroll 4
    for (int nt = 0; nt < NT8; ++nt) {
      uint2 bf[KS];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) bf[ks] = s_bf[(nt * KS + ks) * 32 + lane];
      const float2 hn = *reinterpret_cast<const float2*>(s_hn + nt * 8 + 2 * tig);
      const int n = nt * 8 + 2 * tig;
#pragma unroll
      for (int rt = 0; rt < kRT; ++rt) {
        float d[4] = {hn.x, hn.y, hn.x, hn.y};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) mma_tf32(d, a[rt][ks], bf[ks]);
        const bool c0 = d[0] >= thr[2 * rt];
        const bool c1 = d[1] >= thr[2 * rt];
        const bool c2 = d[2] >= thr[2 * rt + 1];
        const bool c3 = d[3] >= thr[2 * rt + 1];
        if (c0 | c1 | c2 | c3) {
          uint32_t& la = list[2 * rt];
          uint32_t& lb = list[2 * rt + 1];
          int& na = nl[2 * rt];
          int& nb = nl[2 * rt + 1];
          if (c0) { la |= (uint32_t)n << (8 * (na & 3)); ++na; }
          if (c1) { la |= (uint32_t)(n + 1) << (8 * (na & 3)); ++na; }
          if (c2) { lb |= (uint32_t)n << (8 * (nb & 3)); ++nb; }
          if (c3) { lb |= (uint32_t)(n + 1) << (8 * (nb & 3)); ++nb; }
        }
      }
    }

    // the re-check: listed candidates go to the warp's queue (each lane
    // after the lanes below it) and every lane takes queue entries; a row
    // whose eps is not finite, or a lane with more than kMaxListed
    // candidates for a row, checks all the lane's columns itself.  Each
    // exact distance meets its row's best in a shared 64-bit atomicMin on
    // (distance, index), whose result no order of arrival can change.
    int mine = 0;
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (valid[r] && !full[r] && nl[r] <= kMaxListed) mine += nl[r];
    int off = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, off, o);
      if (lane >= o) off += v;
    }
    const int total = __shfl_sync(0xffffffffu, off, 31);
    off -= mine;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (!valid[r]) continue;
      if (full[r] || nl[r] > kMaxListed) {
        const float* xr = sx + lrow[r] * DSUB;
        for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            const int n = nt * 8 + 2 * tig + o;
            if (n < K) {
              atomicMin(sb + lrow[r],
                        dist_key(exact_dist<DSUB>(xr, s_cb + n * DSUB,
                                                  s_cn[n]), n));
              ++ncand;
            }
          }
      } else {
        for (int c = 0; c < nl[r]; ++c)
          sq[off++] = (lrow[r] << 8) | ((list[r] >> (8 * c)) & 0xff);
      }
    }
    __syncwarp();
    for (int e = lane; e < total; e += 32) {
      const int lr = sq[e] >> 8, n = sq[e] & 0xff;
      atomicMin(sb + lr, dist_key(exact_dist<DSUB>(sx + lr * DSUB,
                                                   s_cb + n * DSUB, s_cn[n]),
                                  n));
    }
    if (lane == 0) ncand += total;
    __syncwarp();
    for (int e = lane; e < kWarpRows && r0 + e < N; e += 32) {
      const unsigned long long kb = sb[e];
      codes[(long long)i * N + r0 + e] = kb == ~0ull ? 0 : (int)(uint32_t)kb;
    }
    __syncwarp();                          // sx, sq and sb are free again
  }
  if (candidates != nullptr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ncand += __shfl_xor_sync(0xffffffffu, ncand, o);
    if (lane == 0 && ncand > 0)
      atomicAdd(candidates, (unsigned long long)ncand);
  }
}

template <int V>
struct VecF;
template <>
struct VecF<1> { using T = float; };
template <>
struct VecF<2> { using T = float2; };
template <>
struct VecF<4> { using T = float4; };

__device__ __forceinline__ float vadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float2 vadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
template <typename VT>
__device__ __forceinline__ VT vzero() {
  VT v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int l = 0; l < (int)(sizeof(VT) / sizeof(float)); ++l) f[l] = 0.f;
  return v;
}

// Step s of a run of nrows rows, 32 rows a step: the lane's row and code
// (-1 and zeros past the run's end).
template <int Q, typename VT>
__device__ __forceinline__ void load_step(const VT* __restrict__ xv,
                                          const int* __restrict__ cv, int s,
                                          int nrows, int lane, VT (&xr)[Q],
                                          int& cr) {
  const int r = s * 32 + lane;
  const bool ok = r < nrows;
  cr = ok ? __ldcs(cv + r) : -1;             // read once: evict first
#pragma unroll
  for (int q = 0; q < Q; ++q)
    xr[q] = ok ? __ldcs(xv + (long long)r * Q + q) : vzero<VT>();
}

// One step's 32 rows (one a lane) into the accumulator acc (K rows of Q
// vectors), each centroid's members in lane order.  grp: the lanes on this
// lane's code (__match_any_sync); stage: the step's rows, staged for the
// lanes of a group of two or more.
template <int Q, typename VT>
__device__ __forceinline__ void add_step(const VT (&xr)[Q], int c,
                                         unsigned grp, VT* acc,
                                         const VT* stage, int* cnt, int K,
                                         int lane) {
  if ((unsigned)c < (unsigned)K) {
    VT* a = acc + c * Q;
    const int g = __popc(grp);
    const int rank = __popc(grp & ((1u << lane) - 1u));
    if (g == 1) {
#pragma unroll
      for (int q = 0; q < Q; ++q) a[q] = vadd(a[q], xr[q]);
    } else {
      for (int q = rank; q < Q; q += g) {
        VT s = a[q];
        for (unsigned mm = grp; mm != 0u; mm &= mm - 1u)
          s = vadd(s, stage[(__ffs(mm) - 1) * Q + q]);
        a[q] = s;
      }
    }
    if (rank == 0) atomicAdd(cnt + c, g);
  }
  __syncwarp();                            // acc: the next step's
}

// dst[e] = +0.0 + src[0][e] + ... + src[n-1][e], left to right, for e in
// [0, n_e) floats, sources spaced by stride floats (vectors of VT).
template <typename VT>
__device__ __forceinline__ void fold_smem(const float* src, int stride, int n,
                                          float* dst, int n_e) {
  constexpr int L = sizeof(VT) / sizeof(float);
  const VT* s4 = reinterpret_cast<const VT*>(src);
  VT* d4 = reinterpret_cast<VT*>(dst);
  for (int e = threadIdx.x; e < n_e / L; e += blockDim.x) {
    VT s = vzero<VT>();
    for (int b = 0; b < n; ++b) s = vadd(s, s4[b * (stride / L) + e]);
    d4[e] = s;
  }
}

// A row is loaded as DSUB / update_vec vectors; a warp stages a tile of
// 8 / (DSUB / update_vec) steps, 32 rows each.
template <int DSUB>
__host__ __device__ constexpr int update_vec() { return DSUB < 4 ? DSUB : 4; }
template <int DSUB>
__host__ __device__ constexpr int update_stage_floats() {
  return 32 * DSUB * (8 / (DSUB / update_vec<DSUB>()));
}

// Launch 1, grid (T blocks of kUpdateWarps runs, m subspaces); dynamic
// shared memory kUpdateWarps (K DSUB + update_stage_floats) floats and K
// ints.  Writes the block's partial sums and counts.
template <int DSUB>
__global__ void __launch_bounds__(kUpdateWarps * 32)
    pq_update_kernel(const float* __restrict__ x, const int* __restrict__ codes,
                     float* __restrict__ part_sums,
                     int* __restrict__ part_counts, int N, int K) {
  constexpr int V = update_vec<DSUB>();
  constexpr int Q = DSUB / V;               // vectors a row
  constexpr int P = 8 / Q;                  // steps a tile
  using VT = typename VecF<V>::T;
  // launch 2's blocks may take the SMs this grid leaves; they wait for
  // all of it to finish before they read the partials
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.x, T = gridDim.x, i = blockIdx.y;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KD = K * DSUB;
  VT* acc = reinterpret_cast<VT*>(smem + w * KD);
  constexpr int SF = update_stage_floats<DSUB>();
  VT* stage = reinterpret_cast<VT*>(smem + kUpdateWarps * KD + w * SF);
  int* cnt = reinterpret_cast<int*>(smem + kUpdateWarps * (KD + SF));
  const long long base = (long long)i * N;
  const long long r0 = ((long long)t * kUpdateWarps + w) * kUpdateRunRows;
  const int nrows =
      r0 >= N ? 0 : (int)(N - r0 < kUpdateRunRows ? N - r0 : kUpdateRunRows);
  const int nsteps = (nrows + 31) >> 5;
  const VT* xv = reinterpret_cast<const VT*>(x + (base + r0) * DSUB);
  const int* cv = codes + base + r0;
  // tiles of P steps, double-buffered: the next tile's loads are issued,
  // then the current tile is added
  VT xr[P][Q], xn[P][Q];
  int cr[P], cn[P];
#pragma unroll
  for (int p = 0; p < P; ++p) load_step<Q>(xv, cv, p, nrows, lane, xr[p], cr[p]);
  for (int k = lane; k < K * Q; k += 32) acc[k] = vzero<VT>();
  for (int k = threadIdx.x; k < K; k += blockDim.x) cnt[k] = 0;
  __syncthreads();
  for (int s0 = 0; s0 < nsteps; s0 += P) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      load_step<Q>(xv, cv, s0 + P + p, nrows, lane, xn[p], cn[p]);
    // the tile's lanes grouped by code at once (P independent matches),
    // and the rows of every group of two or more staged, behind one sync
    unsigned grp[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool ok = (unsigned)cr[p] < (unsigned)K;
      grp[p] = __match_any_sync(0xffffffffu, ok ? cr[p] : -1);
      if (ok && __popc(grp[p]) > 1) {
#pragma unroll
        for (int q = 0; q < Q; ++q) stage[(p * 32 + lane) * Q + q] = xr[p][q];
      }
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (s0 + p < nsteps)                   // warp-uniform
        add_step<Q>(xr[p], cr[p], grp[p], acc, stage + p * 32 * Q, cnt, K,
                    lane);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      cr[p] = cn[p];
#pragma unroll
      for (int q = 0; q < Q; ++q) xr[p][q] = xn[p][q];
    }
  }
  __syncthreads();

  // this block's partial: its runs folded in warp order
  const long long pb = (long long)i * T + t;
  if ((KD & 3) == 0)
    fold_smem<float4>(smem, KD, kUpdateWarps, part_sums + pb * KD, KD);
  else
    fold_smem<float>(smem, KD, kUpdateWarps, part_sums + pb * KD, KD);
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    part_counts[pb * K + k] = cnt[k];
}

// Launch 2, grid (ceil((KD / L + K) / kFoldThreads), m): a thread per
// vector column of the sums (L floats) or per count; the T partials of
// launch 1 are folded in block order, up to kFoldDepth loads in flight.
constexpr int kFoldThreads = 128;
constexpr int kFoldDepth = 32;

template <typename VT>
__global__ void __launch_bounds__(kFoldThreads)
    pq_update_fold_kernel(const float* __restrict__ part_sums,
                          const int* __restrict__ part_counts,
                          float* __restrict__ sums, float* __restrict__ counts,
                          int T, int K, int KD) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  constexpr int L = sizeof(VT) / sizeof(float);
  const int ncol = KD / L;
  const int j = blockIdx.x * kFoldThreads + threadIdx.x;
  const int i = blockIdx.y;
  if (j < ncol) {
    const VT* src = reinterpret_cast<const VT*>(part_sums) +
                    (long long)i * T * ncol + j;
    VT s = vzero<VT>();
    for (int b = 0; b < T; b += kFoldDepth) {
      VT v[kFoldDepth];
#pragma unroll
      for (int u = 0; u < kFoldDepth; ++u)
        v[u] = b + u < T ? src[(long long)(b + u) * ncol] : vzero<VT>();
#pragma unroll
      for (int u = 0; u < kFoldDepth; ++u)
        if (b + u < T) s = vadd(s, v[u]);
    }
    reinterpret_cast<VT*>(sums + (long long)i * KD)[j] = s;
  } else if (j < ncol + K) {
    const int k = j - ncol;
    const int* src = part_counts + (long long)i * T * K + k;
    int c = 0;
    for (int b = 0; b < T; ++b) c += src[(long long)b * K];
    counts[(long long)i * K + k] = (float)c;
  }
}

template <int DSUB>
static int assign(const float* x, const float* cb, int* codes,
                  unsigned long long* candidates, int m, int N, int K,
                  cudaStream_t st) {
  constexpr int KS = (DSUB + 7) / 8;
  const int nt8 = (K + 7) / 8;
  const size_t smem =
      (size_t)nt8 * KS * 32 * sizeof(uint2) +
      kAssignWarps * kWarpRows * sizeof(unsigned long long) +
      sizeof(float) * ((size_t)nt8 * 16 + (size_t)K * DSUB +
                       kAssignWarps * kWarpRows * DSUB + 2 * kAssignWarps) +
      sizeof(int) * kAssignWarps * kQueue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_assign_kernel<DSUB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + kAssignRows - 1) / kAssignRows, m);
  pq_assign_kernel<DSUB><<<grid, kAssignWarps * 32, smem, st>>>(
      x, cb, codes, candidates, N, K);
  return 0;
}

template <typename VT>
static int update_fold(const float* part_sums, const int* part_counts,
                       float* sums, float* counts, int m, int T, int K,
                       int KD, cudaStream_t st) {
  constexpr int L = sizeof(VT) / sizeof(float);
  // a programmatic dependent launch: its blocks are resident when launch 1
  // drains, and wait for it in griddepcontrol.wait
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((KD / L + K + kFoldThreads - 1) / kFoldThreads, m);
  cfg.blockDim = dim3(kFoldThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, pq_update_fold_kernel<VT>, part_sums,
                                 part_counts, sums, counts, T, K, KD);
}

template <int DSUB>
static int update(const float* x, const int* codes, float* part_sums,
                  int* part_counts, float* sums, float* counts, int m, int N,
                  int K, int T, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)kUpdateWarps *
                           ((size_t)K * DSUB + update_stage_floats<DSUB>()) +
                       (size_t)K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_update_kernel<DSUB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pq_update_kernel<DSUB><<<dim3(T, m), kUpdateWarps * 32, smem, st>>>(
      x, codes, part_sums, part_counts, N, K);
  const int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const int KD = K * DSUB;
  return KD % 4 == 0
             ? update_fold<float4>(part_sums, part_counts, sums, counts, m, T,
                                   K, KD, st)
             : update_fold<float>(part_sums, part_counts, sums, counts, m, T,
                                  K, KD, st);
}

#define PQ_DISPATCH(dsub, CALL)            \
  switch (dsub) {                          \
    case 1: { constexpr int D = 1; CALL; break; }   \
    case 2: { constexpr int D = 2; CALL; break; }   \
    case 4: { constexpr int D = 4; CALL; break; }   \
    case 8: { constexpr int D = 8; CALL; break; }   \
    case 16: { constexpr int D = 16; CALL; break; } \
    case 32: { constexpr int D = 32; CALL; break; } \
    default: return (int)cudaErrorInvalidValue;     \
  }

// x: (m, N, dsub) f32; cb: (m, K, dsub) f32; codes: (m, N) int32.
// dsub in {1, 2, 4, 8, 16, 32}; 1 <= K <= 256.  candidates (may be null):
// one u64, zeroed by the caller, to which the kernel adds the number of
// exactly checked (row, centroid) pairs.
extern "C" int leoam_pq_assign(const void* x, const void* cb, void* codes,
                               int m, int N, int K, int dsub,
                               void* candidates, void* stream) {
  if (K < 1 || K > kMaxCentroids) return (int)cudaErrorInvalidValue;
  if (m == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(cb);
  int* op = static_cast<int*>(codes);
  auto* cand = static_cast<unsigned long long*>(candidates);
  int rc = 0;
  PQ_DISPATCH(dsub, rc = assign<D>(xp, cp, op, cand, m, N, K, st));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// x: (m, N, dsub) f32, 16-byte aligned; codes: (m, N) int32; part_sums:
// (m, T, K, dsub) f32 and part_counts: (m, T, K) int32 scratch, T =
// ceil(N / (kUpdateRunRows kUpdateWarps)) -- the caller's T is checked
// against the kernel's, so a scratch sized for another run length is
// refused, never overrun; sums: (m, K, dsub) f32; counts: (m, K) f32.
// Two launches; every output element is written.
extern "C" int leoam_pq_update(const void* x, const void* codes,
                               void* part_sums, void* part_counts, void* sums,
                               void* counts, int m, int N, int K, int dsub,
                               int T, void* stream) {
  if (K < 1 || K > kMaxCentroids) return (int)cudaErrorInvalidValue;
  if (m == 0 || N == 0) return 0;
  if ((long long)T != (N + (long long)kUpdateRunRows * kUpdateWarps - 1) /
                          ((long long)kUpdateRunRows * kUpdateWarps))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int* cp = static_cast<const int*>(codes);
  float* ps = static_cast<float*>(part_sums);
  int* pc = static_cast<int*>(part_counts);
  float* sp = static_cast<float*>(sums);
  float* np_ = static_cast<float*>(counts);
  int rc = 0;
  PQ_DISPATCH(dsub, rc = update<D>(xp, cp, ps, pc, sp, np_, m, N, K, T, st));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
