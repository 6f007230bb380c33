// B2-latent — absorbed-MLA sparse decode attention over one latent plane.
//
// Replaces, for DeepSeek-class MLA models, the reference engine's jnp
// attention repro/serving/engine.py:341 _attend_core_mla, reached through
// :370 _attend_pooled_mla (rows gathered from the one-plane pool slab by
// slot) and :391 _attend_workingset_mla (the legacy path's working set
// uploaded whole), up to its _finish: the normalized out_lat (B, H, r) f32
// before W_UV.  No Pallas kernel of the reference computes it; B2
// (sparse_decode.cu) is its GQA sibling.  Each row of the slab is
// concat(ckv, krope), D = r + rope wide, in fp16; the H query heads are
// concat(q_lat, q_rope), pre-scaled, in the model dtype.
//
//   s[h, t]   = q[h] . row[t]                 (all D columns, f32)
//   p[h, t]   = exp(s[h, t] - max_t s[h, :])  over live rows
//   out[h, c] = sum_t fp16(p[h, t]) * row[t, c] / sum_t p[h, t],  c < r
//
// Live rows: chunk id >= 0 and pos < length (strict: the round's own row,
// lat_new rounded to fp16, rides in as the last row and is always live).
//
// What bounds it on the H100: bytes.  With 16 heads on one row, each row
// of 1152 bytes meets 16 x (576 + 512) x 2 operations, and the products
// are exact in the tensor cores' types: the scores' bf16 q and fp16 rows
// in TF32 (495 TFLOP/s), P.V's fp16 p and rows in fp16 with f32 sums
// (989 TFLOP/s).  At deepseek-v2-lite's main shape (4 sequences, 2304
// live rows) the 2.9 MB of rows, queries and output take 0.86 us at
// 3.35 TB/s against 0.12 us of operations.  This kernel does the products
// on the CUDA cores (67 TFLOP/s in f32, 1.2 us): sixteen heads are
// mma.sync's M = 16, so the tensor cores are the redesign that would move
// it; this is the simple kernel that is right.
//
// Design: three launches over tiles of each sequence's T = nsel * chunk +
// 1 score rows (the entries' rows, then the new token's), 256 threads a
// block, no float atomics, so two calls give bitwise-equal output:
//   1. scores, grid (T / 32, B): a block copies q into shared memory as f32
//      (16 x D, zero heads past H); each warp takes two rows at once, each
//      lane 2-column pieces of them (half2 loads, coalesced, all in
//      flight before the products; one shared load of q serves both rows),
//      and keeps 16 head sums a row in registers, which a butterfly
//      reduce-scatter folds in 16 shuffles (lanes 2h and 2h+1 end with
//      head h).  Scores go to an f32 scratch (B, H, T), each tile's
//      per-head maximum to smax.
//   2. P.V, grid (T / 32, B): a block takes the global maximum (the max of
//      the tile maxima), forms p = exp(s - m) for its 32 rows in shared
//      memory, sums the unrounded p into its denominator partial in row
//      order, and each thread accumulates two value columns x 16 heads of
//      round_fp16(p) * row[c] in f32 registers, reading the first r columns
//      of the same rows, 8 rows' loads at once (launch 1 has just brought
//      them into L2).
//   3. combine, grid (H, B): the num and den partials added in tile order,
//      out = num / den (den 0 -> 1).
// Tiles of rows, not of selection entries, give every launch ~2 blocks per
// SM at the main shape (an entry a block gave 48 blocks on 132 SMs and
// 0.116 ms a call; tiles 0.069 ms), and the butterfly's steps are
// template arguments: a runtime step count put the 32 sums in local
// memory (0.050 ms once they stayed in registers).  Dead rows (padding
// entries, rows at or past length) are never read.
// The probabilities round against the global max, as in the plain
// version's one softmax; sums run in another order than the plain
// version's einsums, so the two agree to f32 rounding plus an occasional
// fp16 rounding flip of one probability.
#include "common.cuh"

constexpr int LT = 256;                   // threads of every block
constexpr int LW = LT / 32;
constexpr int LAT_H = 16;                 // q heads (padded with zeros)
constexpr int LAT_MAX_D = 704;            // row width: q as f32 in smem
constexpr int LAT_SROWS = 32;             // rows a scores block takes
constexpr int LAT_PROWS = 32;             // rows a P.V block takes
constexpr int LAT_KMAX = LAT_MAX_D / 64;  // half2 pieces a lane takes of a row
constexpr int LAT_BATCH = 8;              // loads in flight before their use

struct LatArgs {
  const void* q;            // (B, H, D) model dtype
  const __half* slab;       // row t of slot s: slab + s * slot_stride + t * D
  long long slot_stride;
  const int* slots;         // (B, nsel)
  const int* cids;          // (B, nsel), -1 on padding
  int nsel;
  const int* lengths;       // (B,)
  const void* lat_new;      // (B, D) model dtype
  int B, H, D, R, chunk;
  int T, n_st, n_pt;        // score rows; scores and P.V tiles
  float* sc;                // (B, H, T) scores
  float* smax;              // (B, H, n_st) tile maxima
  float* num_part;          // (n_pt, B, H, R)
  float* den_part;          // (n_pt, B, H)
  float* out;               // (B, H, R)
};

__device__ __forceinline__ bool lat_finite(float x) {
  return fabsf(x) < INFINITY;
}

// Score row f of sequence b: its element offset in the slab, -1 for a dead
// row (a padding entry, at or past length, or past the T rows) and -2 for
// the new token's row (the last).  Blocks compute their rows' offsets
// first, into shared memory, beside their other loads.
__device__ __forceinline__ long long lat_row(const LatArgs& a, int b, int f,
                                             int len) {
  if (f >= a.T) return -1;
  if (f == a.T - 1) return -2;
  const int j = f / a.chunk, r = f - j * a.chunk;
  const int cid = a.cids[b * a.nsel + j];
  const long long slot = a.slots[b * a.nsel + j];  // beside cid: one latency
  if (cid < 0 || cid * a.chunk + r >= len) return -1;
  return slot * a.slot_stride + (long long)r * a.D;
}

// Columns 2k, 2k + 1 of a row as floats: the slab's fp16, the new token's
// row rounded to fp16, or zeros for a dead row.
template <typename TQ>
__device__ __forceinline__ float2 lat_pair(const LatArgs& a, const TQ* nb,
                                           long long off, int k) {
  if (off >= 0)
    return __half22float2(reinterpret_cast<const __half2*>(a.slab + off)[k]);
  if (off == -2)
    return make_float2(round_to<__half>(to_f32(nb[2 * k])),
                       round_to<__half>(to_f32(nb[2 * k + 1])));
  return make_float2(0.f, 0.f);
}

// One step of the butterfly below: a lane keeps the half of its sums that
// bit O of its lane names and adds its partner's copy of that half.  KEEP
// and O are template arguments so that every index is a constant and the
// sums stay in registers (a runtime step count put them in local memory).
template <int KEEP, int O>
__device__ __forceinline__ void lat_fold_step(float (&acc)[LAT_H], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < KEEP; ++i) {
    const float send = upper ? acc[i] : acc[i + KEEP];
    const float mine = upper ? acc[i + KEEP] : acc[i];
    acc[i] = mine + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Butterfly reduce-scatter of 16 per-lane sums over the warp: lanes 2h
// and 2h+1 end with head h's full sum.
__device__ __forceinline__ float lat_fold16(float (&acc)[LAT_H], int lane) {
  lat_fold_step<8, 16>(acc, lane);
  lat_fold_step<4, 8>(acc, lane);
  lat_fold_step<2, 4>(acc, lane);
  lat_fold_step<1, 2>(acc, lane);
  return acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
}

// Launch 1: scores and tile maxima, grid (n_st, B).
template <typename TQ>
__global__ void __launch_bounds__(LT) lat_scores_kernel(LatArgs a) {
  __shared__ __align__(16) float qs[LAT_H * LAT_MAX_D];
  __shared__ float wmax[LW][LAT_H];
  __shared__ long long roff[LAT_SROWS];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = a.D, H = a.H, T = a.T;
  const int f0 = tile * LAT_SROWS, f1 = min(T, f0 + LAT_SROWS);
  if (tid < LAT_SROWS) roff[tid] = lat_row(a, b, f0 + tid, a.lengths[b]);
  const TQ* qb = static_cast<const TQ*>(a.q) + (long long)b * H * D;
  // q's layout is (head, column), so the heads past H are the tail
  for (int i0 = 0; i0 < LAT_H * D; i0 += LAT_BATCH * LT) {
    float t[LAT_BATCH];
#pragma unroll
    for (int u = 0; u < LAT_BATCH; ++u) {
      const int i = i0 + u * LT + tid;
      t[u] = i < H * D ? to_f32(qb[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LAT_BATCH; ++u) {
      const int i = i0 + u * LT + tid;
      if (i < LAT_H * D) qs[i] = t[u];
    }
  }
  __syncthreads();
  float* scb = a.sc + (long long)b * H * T;
  const TQ* nb = static_cast<const TQ*>(a.lat_new) + (long long)b * D;
  const int n2 = D >> 1;                  // half2 pieces of a row
  const int h = lane >> 1;                // the head this lane ends with
  float mx = -INFINITY;
  for (int f = f0 + warp; f < f1; f += 2 * LW) {
    const int g = f + LW;                 // the pair's second row
    const long long off0 = roff[f - f0];
    const long long off1 = roff[g - f0];  // -1 past the tile's rows
    if (off0 == -1 && off1 == -1) continue;   // warp-uniform
    // both rows' pieces in registers first: every load in flight at once
    float2 v0[LAT_KMAX], v1[LAT_KMAX];
#pragma unroll
    for (int kk = 0; kk < LAT_KMAX; ++kk) {
      const int k = lane + 32 * kk;
      v0[kk] = k < n2 ? lat_pair(a, nb, off0, k) : make_float2(0.f, 0.f);
      v1[kk] = k < n2 ? lat_pair(a, nb, off1, k) : make_float2(0.f, 0.f);
    }
    float acc0[LAT_H], acc1[LAT_H];
#pragma unroll
    for (int i = 0; i < LAT_H; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < LAT_KMAX; ++kk) {
      const int k = lane + 32 * kk;
      if (k >= n2) break;
#pragma unroll
      for (int i = 0; i < LAT_H; ++i) {
        const float2 qv = reinterpret_cast<const float2*>(qs + i * D)[k];
        acc0[i] += qv.x * v0[kk].x + qv.y * v0[kk].y;
        acc1[i] += qv.x * v1[kk].x + qv.y * v1[kk].y;
      }
    }
    const float s0 = lat_fold16(acc0, lane);
    const float s1 = lat_fold16(acc1, lane);
    if (h < H) {
      if (off0 != -1) {
        if ((lane & 1) == 0) scb[(long long)h * T + f] = s0;
        mx = fmaxf(mx, s0);
      }
      if (off1 != -1) {
        if ((lane & 1) == 0) scb[(long long)h * T + g] = s1;
        mx = fmaxf(mx, s1);
      }
    }
  }
  if ((lane & 1) == 0) wmax[warp][h] = mx;
  __syncthreads();
  if (tid < H) {
    float m = -INFINITY;
    for (int w = 0; w < LW; ++w) m = fmaxf(m, wmax[w][tid]);
    a.smax[((long long)b * H + tid) * a.n_st + tile] = m;
  }
}

// Launch 2: each P.V tile's num and den partials, grid (n_pt, B).
template <typename TQ>
__global__ void __launch_bounds__(LT) lat_pv_kernel(LatArgs a) {
  __shared__ float red[LT];
  __shared__ float ms[LAT_H];
  __shared__ float ps[LAT_PROWS][LAT_H];             // p, unrounded
  __shared__ __align__(16) float pr[LAT_PROWS][LAT_H];  // p rounded to fp16
  __shared__ long long roff[LAT_PROWS];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int H = a.H, D = a.D, R = a.R, T = a.T;
  const int f0 = tile * LAT_PROWS, nt = min(LAT_PROWS, T - f0);
  if (tid < LAT_PROWS) roff[tid] = lat_row(a, b, f0 + tid, a.lengths[b]);
  // the global maximum of each head: 16 threads a head over the tiles
  {
    const int h = tid % LAT_H, part = tid / LAT_H;
    float m = -INFINITY;
    if (h < H)
      for (int i = part; i < a.n_st; i += LT / LAT_H)
        m = fmaxf(m, a.smax[((long long)b * H + h) * a.n_st + i]);
    red[tid] = m;
  }
  __syncthreads();
  if (tid < LAT_H) {
    float m = -INFINITY;
    for (int p = 0; p < LT / LAT_H; ++p) m = fmaxf(m, red[p * LAT_H + tid]);
    ms[tid] = lat_finite(m) ? m : 0.f;
  }
  __syncthreads();
  const float* scb = a.sc + (long long)b * H * T;
  const TQ* nb = static_cast<const TQ*>(a.lat_new) + (long long)b * D;
#pragma unroll 4
  for (int i = tid; i < nt * LAT_H; i += LT) {
    const int rr = i / LAT_H, h = i - rr * LAT_H;
    const long long off = roff[rr];
    const float p = (off != -1 && h < H)
                        ? expf(scb[(long long)h * T + f0 + rr] - ms[h])
                        : 0.f;
    ps[rr][h] = p;
    pr[rr][h] = round_to<__half>(p);
  }
  __syncthreads();
  const long long po = ((long long)tile * a.B + b) * H;
  if (tid < H) {
    float d = 0.f;
    for (int rr = 0; rr < nt; ++rr) d += ps[rr][tid];
    a.den_part[po + tid] = d;
  }
  const int c0 = 2 * tid;                 // this thread's value columns
  if (c0 >= R) return;
  float acc[LAT_H][2];
#pragma unroll
  for (int h = 0; h < LAT_H; ++h) acc[h][0] = acc[h][1] = 0.f;
  // LAT_BATCH rows' columns c0, c0 + 1 loaded before any product; a dead
  // row loads nothing and has p = 0, so its terms add exact zeros
  for (int r0 = 0; r0 < nt; r0 += LAT_BATCH) {
    float2 v[LAT_BATCH];
#pragma unroll
    for (int u = 0; u < LAT_BATCH; ++u)
      v[u] = r0 + u < nt ? lat_pair(a, nb, roff[r0 + u], tid)
                         : make_float2(0.f, 0.f);
#pragma unroll
    for (int u = 0; u < LAT_BATCH; ++u) {
      if (r0 + u >= nt) break;
      const float4* p4 = reinterpret_cast<const float4*>(pr[r0 + u]);
#pragma unroll
      for (int q4 = 0; q4 < LAT_H / 4; ++q4) {
        const float4 p = p4[q4];
        acc[4 * q4][0] += p.x * v[u].x;
        acc[4 * q4][1] += p.x * v[u].y;
        acc[4 * q4 + 1][0] += p.y * v[u].x;
        acc[4 * q4 + 1][1] += p.y * v[u].y;
        acc[4 * q4 + 2][0] += p.z * v[u].x;
        acc[4 * q4 + 2][1] += p.z * v[u].y;
        acc[4 * q4 + 3][0] += p.w * v[u].x;
        acc[4 * q4 + 3][1] += p.w * v[u].y;
      }
    }
  }
  for (int h = 0; h < H; ++h) {
    a.num_part[(po + h) * R + c0] = acc[h][0];
    a.num_part[(po + h) * R + c0 + 1] = acc[h][1];
  }
}

// Launch 3: the partials of (b, h) added in tile order, grid (H, B).
__global__ void __launch_bounds__(LT) lat_combine_kernel(LatArgs a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = a.H, R = a.R;
  const long long pstride = (long long)a.B * H;
  const long long hb = (long long)b * H + h;
  float den = 0.f;
#pragma unroll 4
  for (int t = 0; t < a.n_pt; ++t) den += a.den_part[t * pstride + hb];
  den = den == 0.f ? 1.f : den;
  for (int c = threadIdx.x; c < R; c += LT) {
    float num = 0.f;
#pragma unroll 4
    for (int t = 0; t < a.n_pt; ++t)
      num += a.num_part[(t * pstride + hb) * R + c];
    a.out[hb * R + c] = num / den;
  }
}

template <typename TQ>
static int lat_launch(const LatArgs& a, cudaStream_t st) {
  lat_scores_kernel<TQ><<<dim3(a.n_st, a.B), LT, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lat_pv_kernel<TQ><<<dim3(a.n_pt, a.B), LT, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lat_combine_kernel<<<dim3(a.H, a.B), LT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// q: (B, H, D) contiguous, model dtype q_dtype (LeoamDType), pre-scaled;
// slab: fp16 rows, row t of slot s at element s * slot_stride + t * D (D
// even, so every row is 4-byte aligned); slots / cids: (B, nsel) int32;
// lengths: (B,) int32; lat_new: (B, D) in q_dtype; H <= 16, D <= 704,
// R even <= 512 and <= D; scratch: leoam_sparse_decode_latent_scratch()
// f32; out: (B, H, R) f32.
extern "C" long long leoam_sparse_decode_latent_scratch(int B, int H, int R,
                                                        int nsel, int chunk) {
  const long long T = (long long)nsel * chunk + 1;
  const long long n_st = (T + LAT_SROWS - 1) / LAT_SROWS;
  const long long n_pt = (T + LAT_PROWS - 1) / LAT_PROWS;
  return (long long)B * H * (T + n_st + n_pt * (R + 1));
}

extern "C" int leoam_sparse_decode_latent(
    const void* q, const void* slab, long long slot_stride, const void* slots,
    const void* cids, int nsel, const void* lengths, const void* lat_new,
    int B, int H, int D, int R, int chunk, void* scratch, void* out,
    int q_dtype, void* stream) {
  if (H <= 0 || H > LAT_H || D <= 0 || D > LAT_MAX_D || D % 2 != 0 ||
      R <= 0 || R > D || R % 2 != 0 || R > 2 * LT || chunk <= 0 ||
      nsel < 0 || slot_stride % 2 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  LatArgs a;
  a.q = q;
  a.slab = static_cast<const __half*>(slab);
  a.slot_stride = slot_stride;
  a.slots = static_cast<const int*>(slots);
  a.cids = static_cast<const int*>(cids);
  a.nsel = nsel;
  a.lengths = static_cast<const int*>(lengths);
  a.lat_new = lat_new;
  a.B = B; a.H = H; a.D = D; a.R = R; a.chunk = chunk;
  a.T = nsel * chunk + 1;
  a.n_st = (a.T + LAT_SROWS - 1) / LAT_SROWS;
  a.n_pt = (a.T + LAT_PROWS - 1) / LAT_PROWS;
  float* f = static_cast<float*>(scratch);
  a.sc = f;
  a.smax = a.sc + (long long)B * H * a.T;
  a.num_part = a.smax + (long long)B * H * a.n_st;
  a.den_part = a.num_part + (long long)a.n_pt * B * H * R;
  a.out = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case LEOAM_F32: return lat_launch<float>(a, st);
    case LEOAM_F16: return lat_launch<__half>(a, st);
    case LEOAM_BF16: return lat_launch<__nv_bfloat16>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
