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
// What bounds it on the H100: operations.  At the main path's encode (m 16,
// N 131 072, K 256, dsub 8) it does 2*m*N*K*dsub = 8.6 GFLOP on 75 MB:
// ~0.13 ms at the 67 TFLOP/s f32 rate against ~0.023 ms of bytes.  Codes
// must equal the plain version's bitwise (the tests compare them exactly),
// so every product and sum is __fmul_rn / __fadd_rn in the plain version's
// lane order; nvcc never contracts those into FMAs, which halves the issue
// rate (a multiply and an add are two instructions), and tensor cores
// (TF32, bf16) stay out because they would move near-ties.
//
// Design: grid (ceil(N/256), m), 256 threads, one row per thread.  The
// block stages its subspace's codebook and the K norms in shared memory
// (all threads read the same centroid at once: a broadcast); the thread
// keeps its row in registers, walks k in order and keeps the first minimal
// index with a strict <.
//
// B5 pq_update replaces repro/kernels/pq/pq_kmeans.py (_update_kernel,
// pq_update_pallas): a one-hot product per row tile, accumulated across the
// TPU's sequential grid into one (K, dsub) output block.
//
// What bounds it on the H100: bytes (x and the codes are read once; the
// sums are K*dsub per subspace).  Blocks run in no order on 132 SMs, so
// nothing can carry a sum from one tile to the next, and the plane
// promises byte-identical codebooks for the same ingest order: no float
// atomics anywhere.  Design: two passes.  Pass 1, grid (T row tiles, m):
// one thread per centroid scans the tile's codes (staged in shared
// memory, a broadcast read) in row order and adds the rows that match
// into registers, then writes the tile's partial sums and counts to a
// scratch buffer.  Pass 2, grid (m): each (k, lane) adds the T partials in
// tile order.  A code outside [0, K) (the padding sentinel K) matches no
// thread and adds nothing.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kMaxCentroids = 256;

template <int DSUB>
__global__ void __launch_bounds__(kThreads)
    pq_assign_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                     int* __restrict__ codes, int N, int K) {
  extern __shared__ float smem[];
  float* s_cb = smem;             // (K, DSUB)
  float* s_cn = smem + K * DSUB;  // (K,)
  const int i = blockIdx.y;
  const float* cbi = cb + (long long)i * K * DSUB;
  for (int e = threadIdx.x; e < K * DSUB; e += blockDim.x) s_cb[e] = cbi[e];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float* c = s_cb + k * DSUB;
    float cn = __fmul_rn(c[0], c[0]);
#pragma unroll
    for (int l = 1; l < DSUB; ++l) cn = __fadd_rn(cn, __fmul_rn(c[l], c[l]));
    s_cn[k] = cn;
  }
  __syncthreads();
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* xp = x + ((long long)i * N + n) * DSUB;
  float xr[DSUB];
#pragma unroll
  for (int l = 0; l < DSUB; ++l) xr[l] = xp[l];
  float best = 0.f;
  int arg = 0;
  for (int k = 0; k < K; ++k) {
    const float* c = s_cb + k * DSUB;
    float dot = __fmul_rn(xr[0], c[0]);
#pragma unroll
    for (int l = 1; l < DSUB; ++l) dot = __fadd_rn(dot, __fmul_rn(xr[l], c[l]));
    const float d = __fsub_rn(s_cn[k], __fmul_rn(2.0f, dot));
    if (k == 0 || d < best) {
      best = d;
      arg = k;
    }
  }
  codes[(long long)i * N + n] = arg;
}

template <int DSUB>
__global__ void __launch_bounds__(kThreads)
    pq_update_partial_kernel(const float* __restrict__ x,
                             const int* __restrict__ codes,
                             float* __restrict__ part_sums,
                             int* __restrict__ part_counts, int N, int K,
                             int rows_per_tile) {
  __shared__ int s_code[kThreads];
  __shared__ float s_x[kThreads * DSUB];
  const int t = blockIdx.x, T = gridDim.x, i = blockIdx.y;
  const int k = threadIdx.x;
  float acc[DSUB];
#pragma unroll
  for (int l = 0; l < DSUB; ++l) acc[l] = 0.f;
  int cnt = 0;
  const long long row0 = (long long)t * rows_per_tile;
  const long long row_end =
      row0 + rows_per_tile < N ? row0 + rows_per_tile : (long long)N;
  const long long base = (long long)i * N;
  for (long long r0 = row0; r0 < row_end; r0 += kThreads) {
    const int nr = (int)(row_end - r0 < kThreads ? row_end - r0 : kThreads);
    if (threadIdx.x < nr) s_code[threadIdx.x] = codes[base + r0 + threadIdx.x];
    const float* xs = x + (base + r0) * DSUB;
    for (int e = threadIdx.x; e < nr * DSUB; e += kThreads) s_x[e] = xs[e];
    __syncthreads();
    if (k < K) {
      for (int r = 0; r < nr; ++r) {
        if (s_code[r] == k) {
          ++cnt;
#pragma unroll
          for (int l = 0; l < DSUB; ++l)
            acc[l] = __fadd_rn(acc[l], s_x[r * DSUB + l]);
        }
      }
    }
    __syncthreads();
  }
  if (k < K) {
    const long long o = ((long long)i * T + t) * K + k;
#pragma unroll
    for (int l = 0; l < DSUB; ++l) part_sums[o * DSUB + l] = acc[l];
    part_counts[o] = cnt;
  }
}

__global__ void __launch_bounds__(kThreads)
    pq_update_reduce_kernel(const float* __restrict__ part_sums,
                            const int* __restrict__ part_counts,
                            float* __restrict__ sums,
                            float* __restrict__ counts, int T, int K,
                            int dsub) {
  const int i = blockIdx.x;
  const int kd = K * dsub;
  const float* ps = part_sums + (long long)i * T * kd;
  for (int e = threadIdx.x; e < kd; e += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s = __fadd_rn(s, ps[(long long)t * kd + e]);
    sums[(long long)i * kd + e] = s;
  }
  const int* pc = part_counts + (long long)i * T * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    int c = 0;
    for (int t = 0; t < T; ++t) c += pc[(long long)t * K + k];
    counts[(long long)i * K + k] = (float)c;
  }
}

template <int DSUB>
static void assign(const float* x, const float* cb, int* codes, int m, int N,
                   int K, cudaStream_t st) {
  const dim3 grid((N + kThreads - 1) / kThreads, m);
  const size_t smem = (size_t)K * (DSUB + 1) * sizeof(float);
  pq_assign_kernel<DSUB><<<grid, kThreads, smem, st>>>(x, cb, codes, N, K);
}

template <int DSUB>
static void update(const float* x, const int* codes, float* part_sums,
                   int* part_counts, float* sums, float* counts, int m, int N,
                   int K, int rows_per_tile, cudaStream_t st) {
  const int T = (N + rows_per_tile - 1) / rows_per_tile;
  pq_update_partial_kernel<DSUB><<<dim3(T, m), kThreads, 0, st>>>(
      x, codes, part_sums, part_counts, N, K, rows_per_tile);
  pq_update_reduce_kernel<<<m, kThreads, 0, st>>>(part_sums, part_counts,
                                                  sums, counts, T, K, DSUB);
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
// dsub in {1, 2, 4, 8, 16, 32}; 1 <= K <= 256.
extern "C" int leoam_pq_assign(const void* x, const void* cb, void* codes,
                               int m, int N, int K, int dsub, void* stream) {
  if (K < 1 || K > kMaxCentroids) return (int)cudaErrorInvalidValue;
  if (m == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(cb);
  int* op = static_cast<int*>(codes);
  PQ_DISPATCH(dsub, assign<D>(xp, cp, op, m, N, K, st));
  return (int)cudaGetLastError();
}

// x: (m, N, dsub) f32; codes: (m, N) int32; part_sums: (m, T, K, dsub) f32
// and part_counts: (m, T, K) int32 scratch, T = ceil(N / rows_per_tile);
// sums: (m, K, dsub) f32; counts: (m, K) f32.
extern "C" int leoam_pq_update(const void* x, const void* codes,
                               void* part_sums, void* part_counts, void* sums,
                               void* counts, int m, int N, int K, int dsub,
                               int rows_per_tile, void* stream) {
  if (K < 1 || K > kMaxCentroids || rows_per_tile < 1)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int* cp = static_cast<const int*>(codes);
  float* ps = static_cast<float*>(part_sums);
  int* pc = static_cast<int*>(part_counts);
  float* sp = static_cast<float*>(sums);
  float* np_ = static_cast<float*>(counts);
  PQ_DISPATCH(dsub, update<D>(xp, cp, ps, pc, sp, np_, m, N, K, rows_per_tile,
                              st));
  return (int)cudaGetLastError();
}
