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
// 3.35 TB/s against 0.12 us of operations; what a call costs beyond that
// is the number of dependent round trips to memory on its critical path.
//
// The numerical contract shapes the design: every probability is rounded
// to fp16 against the GLOBAL max of its head over all live rows (the plain
// version's one softmax), so the max must be known before any p is formed;
// an online softmax that rounds against per-split maxima would round
// almost every p differently.  Hence two launches; no float atomics and
// every sum in a fixed order, so two calls give bitwise-equal output:
//
//   1. scores, grid (nblk1, B): a block takes one tile of one selection
//      entry's live rows — 64, 32 or 16 rows, the largest that still gives
//      the grid 96 blocks (32 rows at the serve: 96 blocks, which leaves
//      SMs free for launch 2's blocks to start beside them; 192 blocks of
//      16 rows held every SM, and 48 blocks of whole chunks left most SMs
//      idle while each brought in 74 KB from a cold L2).  It stages the tile
//      into shared memory with 16-byte cp.async copies onto an mbarrier,
//      rows padded to a stride of 16 words mod 32 so the fragment loads
//      below hit every bank once, rows past length zero-filled by the
//      copies.  The 16 heads are mma.sync's M = 16: s = q . row^T runs as
//      m16n8k8 TF32 products with f32 sums, 8 rows an n-tile.  The K
//      dimension (D, in 32-column groups) is split over the 8 warps, each
//      holding its groups of q as A fragments in registers (loaded once,
//      straight from global memory), so q is never restaged through shared
//      memory; a 16-byte shared load of one row is the B operand of four
//      k-steps (k is permuted so that each lane reads 8 adjacent columns).
//      The warps' partial sums meet in shared memory and are added in warp
//      order.  bf16 and fp16 q and the fp16 rows are exact in TF32; f32 q
//      is split as hi + lo (both cvt.rna TF32) and runs two products
//      against the same exact row, an error of ~2^-22 relative per term.
//      Scores go to an f32 scratch (B, H, T), each block's per-head maximum
//      to smax.  The last block also scores the new token's row, rounded
//      to fp16 and staged as a tile of one row, through the same products.
//   2. P.V, grid (ceil(r / 64) x nrs, B), a programmatic dependent launch
//      in thread-block clusters: a CTA owns 64 value columns of one
//      sequence and one of nrs runs of its live rows (the entries' live
//      rows in order, then the new row; ~192 selected rows a run, at most
//      8 runs, a cluster of them).  Before griddepcontrol.wait — they do
//      not depend on launch 1 — it lists its rows.  After it, the block
//      maxima and its rows' scores (16 loads a thread) in one round trip,
//      and its rows' 64 columns staged by cp.async from L2 (launch 1 has
//      just read them; staged before the wait, from HBM beside launch 1,
//      they filled each SM's miss queue and held up the score loads); the
//      global max; p = exp(s - max) in f32, summed unrounded into the
//      denominator in a fixed order and rounded to fp16 into shared memory
//      as the A operand; P.V as m16n8k16 fp16 products with f32 sums, A by
//      ldmatrix, the rows as B by ldmatrix.trans, warp w taking 8 of the
//      CTA's columns.  The CTA's partials (num 16 x 64, den 16) stay in its
//      shared memory; after a cluster barrier, rank 0 reads the others'
//      through distributed shared memory, adds them in rank order and
//      writes out = num / den (den 0 -> 1).  No partial leaves the
//      cluster, no ticket, no combine launch.
//      Measured on the way (chip_smoke.py --only latent, H100 80GB HBM3,
//      700 W, in ms a call at the serve): one num / den partial a split in
//      global memory, the last split to finish (an integer ticket) adding
//      them: 0.0293, the fence, the ticket and one block's reading back
//      6 x 32 KB of partials being dependent round trips after launch 1;
//      every P.V block taking all the sequence's rows: 0.0239, each block
//      then forming all 16 x ~640 p of its sequence (the expf's, 8 times
//      over); this design: 0.0202.
//
// Every shape the entry took before runs here: H <= 16 (heads past H are
// zero rows of A), even D <= 704, even r <= 512, chunk >= 1, nsel >= 0,
// q in f32, fp16 or bf16.  Rows whose 16-byte pieces are not aligned (D or
// the slot stride not a multiple of 8 halves) are staged with 4-byte
// cp.async copies into the same layouts instead.  A long selection runs
// each P.V run in batches of 256 rows.
// The probabilities round against the global max, as in the plain
// version's one softmax; sums run in another order than the plain
// version's einsums, so the two agree to f32 rounding plus an occasional
// fp16 rounding flip of one probability.
#include <algorithm>

#include "common.cuh"

constexpr int LT = 256;                   // threads of every block
constexpr int LW = LT / 32;               // warps
constexpr int LAT_H = 16;                 // q heads: mma's M (zeros past H)
constexpr int LAT_MAX_D = 704;            // row width
constexpr int LAT_MAX_R = 512;            // value width
constexpr int LAT_BLOCKS1 = 96;           // launch 1 aims at this many blocks
constexpr int LAT_TR = 64;                // scores: rows a tile holds at most
constexpr int LAT_NT = LAT_TR / 8;        // scores: n-tiles of 8 rows a tile
constexpr int LAT_KG = 3;                 // scores: 32-column groups a warp
                                          // holds (22 groups at D = 704)
constexpr int LAT_CW = 64;                // P.V: columns a block (8 a warp)
constexpr int LAT_SPLIT_ROWS = 192;       // P.V: selected rows a split takes
constexpr int LAT_MAX_SPLITS = 8;         // P.V: splits a cluster at most
constexpr int LAT_NB = 256;               // P.V: rows a batch stages
constexpr int LAT_KR = LAT_NB / 64;       // P.V: batch rows a thread's p
constexpr int LAT_PST = LAT_NB + 8;       // P.V: halves a row of pa

struct LatArgs {
  const void* q;            // (B, H, D) model dtype
  const __half* slab;       // row t of slot s: slab + s * slot_stride + t * D
  long long slot_stride;
  const int* slots;         // (B, nsel)
  const int* cids;          // (B, nsel), -1 on padding
  int nsel;
  const int* lengths;       // (B,)
  const void* lat_new;      // (B, D) model dtype
  int B, H, D, R, chunk, T; // T = nsel * chunk + 1 score rows
  int tr1, tpe, nblk1;      // launch 1: rows a block, tiles an entry,
                            //   blocks a sequence
  int nrs;                  // launch 2: row splits (a cluster's CTAs)
  int stride1;              // launch 1: bytes of a staged row
  int vec_rows;             // rows staged with 16-byte copies (else 4-byte)
  int vec_q;                // q read with 16-byte loads
  float* sc;                // (B, H, T) scores
  float* smax;              // (B, H, nblk1) block maxima
  float* out;               // (B, H, R)
};

__device__ __forceinline__ bool lat_finite(float x) {
  return fabsf(x) < INFINITY;
}

__device__ __forceinline__ int lat_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ uint32_t lat_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += A (16 x 8, heads x k) . B (8 x 8, k x rows), TF32 in, f32 sums
__device__ __forceinline__ void lat_mma_tf32(float4& d, const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d.x), "+f"(d.y), "+f"(d.z), "+f"(d.w)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A (16 x 16, heads x rows) . B (16 x 8, rows x columns), fp16 in,
// f32 sums
__device__ __forceinline__ void lat_mma_f16(float4& d, const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d.x), "+f"(d.y), "+f"(d.z), "+f"(d.w)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void lat_ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void lat_ldsm2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// Eight q values of one head from column d0, as floats: zeros for a head
// past H (ok false) and columns past D.
__device__ __forceinline__ void lat_unpack8(const uint4& u, float (&x)[8],
                                            __half) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __half22float2(h[i]);
    x[2 * i] = v.x;
    x[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void lat_unpack8(const uint4& u, float (&x)[8],
                                            __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    x[2 * i] = v.x;
    x[2 * i + 1] = v.y;
  }
}
template <typename TQ>
__device__ __forceinline__ void lat_load8(const TQ* row, int d0, int D,
                                          bool ok, bool vec, float (&x)[8]) {
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = 0.f;
  } else if (vec && d0 + 8 <= D) {
    if constexpr (sizeof(TQ) == 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(row + d0));
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + d0) + 1);
      x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
      x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
    } else {
      lat_unpack8(__ldg(reinterpret_cast<const uint4*>(row + d0)), x, TQ());
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = d0 + i < D ? to_f32(row[d0 + i]) : 0.f;
  }
}

// Live rows of selection entry j of sequence b: chunk id >= 0, pos <
// length.  Its slab slot in *slot.
__device__ __forceinline__ int lat_nval(const LatArgs& a, int b, int j,
                                        int len, int* slot) {
  const int cid = a.cids[b * a.nsel + j];
  *slot = a.slots[b * a.nsel + j];          // beside cid: one latency
  return cid < 0 ? 0 : min(a.chunk, max(0, len - cid * a.chunk));
}

// Piece k of a staged row: 16 bytes (vec_rows) or 4 bytes of the slab
// row at element offset `off` from column c0, into dst; columns at or
// past cmax, and every piece of a row with off < 0, are zero-filled.
__device__ __forceinline__ void lat_piece(const LatArgs& a, char* dst,
                                          long long off, int c0, int cmax,
                                          int k) {
  if (a.vec_rows) {
    const int c = c0 + 8 * k;
    const int n = off >= 0 ? min(16, max(0, 2 * (cmax - c))) : 0;
    cp_async16_zfill(dst + 16 * k, n > 0 ? a.slab + off + c : a.slab, n);
  } else {
    const int c = c0 + 2 * k;
    const int n = off >= 0 && c < cmax ? 4 : 0;
    cp_async4_zfill(dst + 4 * k, n > 0 ? a.slab + off + c : a.slab, n);
  }
}

// The scores of one staged tile (nr rows at `cb`, rows past nr zeros):
// every warp runs its column groups of q against all the tile's n-tiles
// (8 rows each) on the tensor cores, the warps' partial sums meet in
// `red`, and warp w adds n-tile w's in warp order and writes scores t0 +
// row of sequence b's scratch, folding them into the lane's head maxima.
template <bool SPLIT>
__device__ __forceinline__ void lat_score_tile(
    const LatArgs& a, const char* cb, int nr, long long t0,
    const uint32_t (&qa)[LAT_KG][4][4], const uint32_t (&ql)[LAT_KG][4][4],
    int ngrp, float4* red, float* scb, float& mx0, float& mx1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ntl = (nr + 7) >> 3;           // n-tiles of 8 rows
  float4 acc[LAT_NT];
#pragma unroll
  for (int nt = 0; nt < LAT_NT; ++nt) acc[nt] = make_float4(0.f, 0.f, 0.f, 0.f);
  // a group's 16-byte loads of all n-tiles first, then each k-step's
  // products over the n-tiles: consecutive mma's are independent
#pragma unroll
  for (int u = 0; u < LAT_KG; ++u) {
    const int gi = warp + LW * u;
    if (gi >= ngrp) break;
    uint4 w[LAT_NT];
#pragma unroll
    for (int nt = 0; nt < LAT_NT; ++nt)
      w[nt] = nt < ntl ? *reinterpret_cast<const uint4*>(
                             cb + (nt * 8 + g) * a.stride1 + gi * 64 + t4 * 16)
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int nt = 0; nt < LAT_NT; ++nt) {
        if (nt < ntl) {
          const float2 f = __half22float2(
              reinterpret_cast<const __half2*>(&w[nt])[j]);  // exact in TF32
          const uint32_t b0 = __float_as_uint(f.x), b1 = __float_as_uint(f.y);
          lat_mma_tf32(acc[nt], qa[u][j], b0, b1);
          if constexpr (SPLIT) lat_mma_tf32(acc[nt], ql[u][j], b0, b1);
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < LAT_NT; ++nt)
    if (nt < ntl) red[(warp * LAT_NT + nt) * 32 + lane] = acc[nt];
  __syncthreads();
  if (warp < ntl) {
    float4 s = red[warp * 32 + lane];
    for (int w = 1; w < LW; ++w) {
      const float4 v = red[(w * LAT_NT + warp) * 32 + lane];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    // C fragment: rows ra, ra + 1 of heads g (x, y) and g + 8 (z, w)
    const int ra = warp * 8 + 2 * t4;
    const long long T = a.T, t = t0 + ra;
    if (ra < nr) {
      if (g < a.H) {
        scb[g * T + t] = s.x;
        mx0 = fmaxf(mx0, s.x);
      }
      if (g + 8 < a.H) {
        scb[(g + 8) * T + t] = s.z;
        mx1 = fmaxf(mx1, s.z);
      }
    }
    if (ra + 1 < nr) {
      if (g < a.H) {
        scb[g * T + t + 1] = s.y;
        mx0 = fmaxf(mx0, s.y);
      }
      if (g + 8 < a.H) {
        scb[(g + 8) * T + t + 1] = s.w;
        mx1 = fmaxf(mx1, s.w);
      }
    }
  }
  __syncthreads();                         // the buffer and red are free
}

// Launch 1: the scores of one tile of one entry's live rows and their
// per-head maximum, grid (nblk1, B); the last block also scores the new
// token's row.
template <typename TQ>
__global__ void __launch_bounds__(LT, sizeof(TQ) == 4 ? 1 : 2)
    lat_scores_kernel(const LatArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool SPLIT = sizeof(TQ) == 4;   // f32 q: hi + lo TF32 terms
  constexpr int NEW_K = (LAT_MAX_D + LT - 1) / LT;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  char* buf = reinterpret_cast<char*>(smem) + 128;
  float4* red = reinterpret_cast<float4*>(buf + lat_up(a.tr1, 8) * a.stride1);
  float* wmax = reinterpret_cast<float*>(red + LW * LAT_NT * 32);
  const int blk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int H = a.H, D = a.D;
  const bool last = blk == a.nblk1 - 1;

  // launch 2 may start once every block of this grid has: its blocks
  // stage rows, which this launch does not write, then wait for it
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (tid == 0) {
    mbar_init(bar, LT);
    mbar_fence_init();
  }
  __syncthreads();
  // the tile: rows [r0, r0 + nr) of entry j
  const int j = blk / a.tpe, r0 = (blk - j * a.tpe) * a.tr1;
  int nr = 0, slot = 0;
  if (j < a.nsel)
    nr = min(a.tr1, max(0, lat_nval(a, b, j, a.lengths[b], &slot) - r0));
  const int ncols = lat_up(D, 32);
  if (nr > 0) {
    const long long off = (long long)slot * a.slot_stride +
                          (long long)r0 * D;
    const int ppr = a.vec_rows ? ncols / 8 : ncols / 2;   // pieces a row
    for (int e = tid; e < lat_up(nr, 8) * ppr; e += LT) {
      const int r = e / ppr;
      lat_piece(a, buf + r * a.stride1, r < nr ? off + (long long)r * D : -1,
                0, D, e - r * ppr);
    }
    cp_async_arrive(bar);
  }
  // the new token's row, loaded beside the copies
  const TQ* qb = static_cast<const TQ*>(a.q) + (long long)b * H * D;
  __half nv[NEW_K];
  if (last) {
    const TQ* nb = static_cast<const TQ*>(a.lat_new) + (long long)b * D;
#pragma unroll
    for (int k = 0; k < NEW_K; ++k) {
      const int d = tid + LT * k;
      nv[k] = __float2half_rn(d < D ? to_f32(nb[d]) : 0.f);
    }
  }

  // This warp's 32-column groups of q as A fragments, k permuted: in group
  // gi, k-step jj, lane (g, t4) holds columns d = 32 gi + 8 t4 + 2 jj (as
  // k = t4) and d + 1 (as k = t4 + 4) of heads g and g + 8, so that one
  // 16-byte load of a row (its columns 32 gi + 8 t4 .. + 7) is the B
  // operand of all four k-steps.
  const int ngrp = ncols / 32;
  uint32_t qa[LAT_KG][4][4], ql[LAT_KG][4][4];
  if (nr > 0 || last) {
#pragma unroll
    for (int u = 0; u < LAT_KG; ++u) {
      const int gi = warp + LW * u;
      float x[8], y[8];
      lat_load8(qb + (long long)g * D, 32 * gi + 8 * t4, D,
                gi < ngrp && g < H, a.vec_q, x);
      lat_load8(qb + (long long)(g + 8) * D, 32 * gi + 8 * t4, D,
                gi < ngrp && g + 8 < H, a.vec_q, y);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float v[4] = {x[2 * jj], y[2 * jj], x[2 * jj + 1],
                            y[2 * jj + 1]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (SPLIT) {
            const uint32_t hi = lat_tf32(v[i]);
            qa[u][jj][i] = hi;
            ql[u][jj][i] = lat_tf32(v[i] - __uint_as_float(hi));
          } else {
            qa[u][jj][i] = __float_as_uint(v[i]);   // exact in TF32
            ql[u][jj][i] = 0u;
          }
        }
      }
    }
  }

  float mx0 = -INFINITY, mx1 = -INFINITY;   // heads g and g + 8
  float* scb = a.sc + (long long)b * H * a.T;
  if (nr > 0) {
    mbar_wait(bar, 0);
    lat_score_tile<SPLIT>(a, buf, nr, (long long)j * a.chunk + r0, qa, ql,
                          ngrp, red, scb, mx0, mx1);
  }
  if (last) {
    // row 0 of the buffer (free now): the new row in fp16; rows 1-7 zeros
    __half* row = reinterpret_cast<__half*>(buf);
#pragma unroll
    for (int k = 0; k < NEW_K; ++k)
      if (tid + LT * k < ncols) row[tid + LT * k] = nv[k];
    for (int i = tid; i < 7 * ncols / 2; i += LT) {
      const int r = 1 + i / (ncols / 2), w = i - (r - 1) * (ncols / 2);
      reinterpret_cast<uint32_t*>(buf + r * a.stride1)[w] = 0u;
    }
    __syncthreads();
    lat_score_tile<SPLIT>(a, buf, 1, a.T - 1, qa, ql, ngrp, red, scb, mx0,
                          mx1);
  }

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  if (t4 == 0) {
    wmax[warp * LAT_H + g] = mx0;
    wmax[warp * LAT_H + g + 8] = mx1;
  }
  __syncthreads();
  if (tid < H) {
    float m = -INFINITY;
    for (int w = 0; w < LW; ++w) m = fmaxf(m, wmax[w * LAT_H + tid]);
    a.smax[((long long)b * H + tid) * a.nblk1 + blk] = m;
  }
}

// Launch 2's shared memory: the barrier, a batch's rows (LAT_NB x 144
// bytes), p as fp16 (16 x LAT_PST), each row's slab offset and score
// index, small reductions, then the CTA's partial sums that its cluster's
// rank 0 reads.
struct LatPvSmem {
  static constexpr int kStride = 2 * LAT_CW + 16;   // bytes of a staged row
  static constexpr size_t kRows = 128;
  static constexpr size_t kPa = kRows + (size_t)LAT_NB * kStride;
  static constexpr size_t kOff = kPa + sizeof(__half) * LAT_H * LAT_PST;
  static constexpr size_t kTrow = kOff + sizeof(long long) * LAT_NB;
  static constexpr size_t kPart = kTrow + sizeof(int) * LAT_NB;  // LT float4
  static constexpr size_t kDenb = kPart + sizeof(float4) * LT;   // 16 floats
  static constexpr size_t kRed = kDenb + sizeof(float) * LAT_H;  // LT floats
  static constexpr size_t kGm = kRed + sizeof(float) * LT;       // 16 floats
  static constexpr size_t kDen = kGm + sizeof(float) * LAT_H;    // 8 x 4
  static constexpr size_t kScan = kDen + sizeof(float) * LW * 4; // 9 ints
  static constexpr size_t kBytes = kScan + sizeof(int) * (LW + 1);
};

// Sequence b's live rows in order (entries' live rows, then the new
// token's row); with LIST, those in [kb, kb + LAT_NB) into roff (slab
// offset; -2 for the new row) and trow (score index).  Returns how many
// there are, the new one included.
template <bool LIST>
__device__ __forceinline__ int lat_rows(const LatArgs& a, int b, int len,
                                        int kb, long long* roff, int* trow,
                                        int* scan) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int base = 0;
  for (int J = 0; J < a.nsel; J += LT) {
    const int j = J + tid;
    int slot = 0;
    const int nv = j < a.nsel ? lat_nval(a, b, j, len, &slot) : 0;
    // block exclusive scan of nv
    int x = nv;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) scan[warp] = x;
    __syncthreads();
    if (tid == 0) {
      int t = 0;
      for (int w = 0; w < LW; ++w) {
        const int v = scan[w];
        scan[w] = t;
        t += v;
      }
      scan[LW] = t;
    }
    __syncthreads();
    if (LIST) {
      const int k0 = base + scan[warp] + x - nv - kb;   // entry j's first
      for (int r = max(0, -k0); r < nv && k0 + r < LAT_NB; ++r) {
        roff[k0 + r] = (long long)slot * a.slot_stride + (long long)r * a.D;
        trow[k0 + r] = j * a.chunk + r;
      }
    }
    base += scan[LW];
    __syncthreads();                        // scan is free
  }
  if (LIST && tid == 0 && base - kb >= 0 && base - kb < LAT_NB) {
    roff[base - kb] = -2;
    trow[base - kb] = a.T - 1;
  }
  return base + 1;
}

__device__ __forceinline__ void lat_cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared-memory address of `p` in the CTA of rank `rank` of the cluster
__device__ __forceinline__ uint32_t lat_dsmem(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// Launch 2: P.V of 64 value columns over one split of one sequence's live
// rows, grid (ceil(R / 64) x nrs, B), clusters of the nrs splits of one
// column slice: rank 0 adds the splits' partials in rank order.
template <typename TQ>
__global__ void __launch_bounds__(LT, 2) lat_pv_kernel(const LatArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S = LatPvSmem;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  char* rows = reinterpret_cast<char*>(smem) + S::kRows;
  __half* pa = reinterpret_cast<__half*>(smem + S::kPa);
  long long* roff = reinterpret_cast<long long*>(smem + S::kOff);
  int* trow = reinterpret_cast<int*>(smem + S::kTrow);
  float4* part = reinterpret_cast<float4*>(smem + S::kPart);
  float* denb = reinterpret_cast<float*>(smem + S::kDenb);
  float* red = reinterpret_cast<float*>(smem + S::kRed);
  float* gm = reinterpret_cast<float*>(smem + S::kGm);
  float* dred = reinterpret_cast<float*>(smem + S::kDen);
  int* scan = reinterpret_cast<int*>(smem + S::kScan);
  const int rs = blockIdx.x % a.nrs;        // the cluster rank: row split
  const int c0 = blockIdx.x / a.nrs * LAT_CW, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int H = a.H, R = a.R;
  const long long T = a.T;
  const int ppr = a.vec_rows ? LAT_CW / 8 : LAT_CW / 2;   // pieces a row
  const TQ* nb = static_cast<const TQ*>(a.lat_new) + (long long)b * a.D;
  // p layout: thread (hq, kk) forms p of batch rows kk + 64 m for heads
  // 4 hq .. 4 hq + 3
  const int hq = tid >> 6, kk = tid & 63;

  if (tid == 0) {
    mbar_init(bar, LT);
    mbar_fence_init();
  }
  __syncthreads();
  // this split's rows: [kb0, kb1) of the sequence's live rows, listed
  // before launch 1 is done (they do not depend on it)
  const int len = a.lengths[b];
  const int nrows = lat_rows<false>(a, b, len, 0, roff, trow, scan);
  const int per = lat_up((nrows + a.nrs - 1) / a.nrs, 16);
  const int kb0 = min(nrows, rs * per), kb1 = min(nrows, kb0 + per);
  if (kb0 < kb1) lat_rows<true>(a, b, len, kb0, roff, trow, scan);
  // the scores and block maxima of launch 1 from here on; its rows are
  // in L2 then, so the staging below reads them there
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  {
    // the block maxima, four a thread at once
    const int h = tid & (LAT_H - 1), part_ = tid / LAT_H;
    const float* sm = a.smax + ((long long)b * H + h) * a.nblk1;
    float m = -INFINITY;
    for (int i0 = part_; i0 < a.nblk1; i0 += 4 * (LT / LAT_H)) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * (LT / LAT_H);
        v[u] = h < H && i < a.nblk1 ? __ldcg(sm + i) : -INFINITY;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) m = fmaxf(m, v[u]);
    }
    red[tid] = m;
  }

  float den[4] = {0.f, 0.f, 0.f, 0.f};
  float4 acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool mine = c0 + 8 * warp < R;      // this warp's 8 columns
  for (int kb = kb0, it = 0; kb < kb1; kb += LAT_NB, ++it) {
    if (it > 0) {
      __syncthreads();                      // roff and trow are free
      lat_rows<true>(a, b, len, kb, roff, trow, scan);
    }
    __syncthreads();
    const int nr = min(LAT_NB, kb1 - kb);
    const int nrp = lat_up(nr, 16);
    float sv[LAT_KR][4];
#pragma unroll
    for (int m = 0; m < LAT_KR; ++m) {
      const int k = kk + 64 * m;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = 4 * hq + i;
        sv[m][i] = k < nr && h < H ? __ldcg(a.sc + ((long long)b * H + h) * T +
                                            trow[k])
                                   : -INFINITY;
      }
    }
    for (int e = tid; e < nrp * ppr; e += LT) {
      const int r = e / ppr, k = e - r * ppr;
      const long long off = r < nr ? roff[r] : -1;
      if (off != -2) {
        lat_piece(a, rows + r * S::kStride, off, c0, R, k);
      } else {                              // the new row, rounded to fp16
        const int n = a.vec_rows ? 8 : 2, cb = c0 + n * k;
        __half* dst = reinterpret_cast<__half*>(rows + r * S::kStride) + n * k;
        for (int i = 0; i < n; ++i)
          dst[i] = __float2half_rn(cb + i < R ? to_f32(nb[cb + i]) : 0.f);
      }
    }
    cp_async_arrive(bar);
    if (it == 0) {
      __syncthreads();
      if (tid < LAT_H) {
        float mm = -INFINITY;
        for (int p = 0; p < LT / LAT_H; ++p)
          mm = fmaxf(mm, red[p * LAT_H + tid]);
        gm[tid] = lat_finite(mm) ? mm : 0.f;
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < LAT_KR; ++m) {
      const int k = kk + 64 * m;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = 4 * hq + i;
        const float p = sv[m][i] == -INFINITY ? 0.f : expf(sv[m][i] - gm[h]);
        den[i] += p;
        pa[h * LAT_PST + k] = __float2half_rn(p);
      }
    }
    mbar_wait(bar, it & 1);
    __syncthreads();                        // rows and pa are complete
    if (mine) {
      // k-steps of 16 rows, k-step ks into sum ks mod 4 (added in order
      // at the end): four independent chains
      auto step = [&](int ks, float4& acc_) {
        uint32_t af[4], bf[2];
        lat_ldsm(af, pa + (((lane >> 3) & 1) * 8 + (lane & 7)) * LAT_PST +
                         16 * ks + (lane >> 4) * 8);
        lat_ldsm2_t(bf, rows + (16 * ks + (lane & 15)) * S::kStride +
                            16 * warp);
        lat_mma_f16(acc_, af, bf[0], bf[1]);
      };
      const int nks = nrp / 16;
      int ks = 0;
      for (; ks + 3 < nks; ks += 4) {
        step(ks, acc[0]);
        step(ks + 1, acc[1]);
        step(ks + 2, acc[2]);
        step(ks + 3, acc[3]);
      }
      if (ks < nks) step(ks, acc[0]);
      if (ks + 1 < nks) step(ks + 1, acc[1]);
      if (ks + 2 < nks) step(ks + 2, acc[2]);
    }
  }

  // this split's partials: each head's denominator (over kk in a fixed
  // butterfly, then the two warps of a head group in order) and each
  // thread's num fragment, in shared memory for rank 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float d = den[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (lane == 0) dred[warp * 4 + i] = d;
  }
  float4 sum = acc[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    sum.x += acc[i].x;
    sum.y += acc[i].y;
    sum.z += acc[i].z;
    sum.w += acc[i].w;
  }
  part[tid] = sum;
  __syncthreads();
  if (tid < LAT_H) {
    const int q4 = tid >> 2, i = tid & 3;   // head tid = 4 q4 + i
    denb[tid] = dred[(2 * q4) * 4 + i] + dred[(2 * q4 + 1) * 4 + i];
  }
  lat_cluster_sync();                       // every split's partials
  if (rs == 0) {
    if (tid < LAT_H) {
      float d = denb[tid];
      for (int q = 1; q < a.nrs; ++q) {
        float v;
        asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                     : "=f"(v)
                     : "r"(lat_dsmem(denb + tid, q))
                     : "memory");
        d += v;
      }
      gm[tid] = d == 0.f ? 1.f : d;
    }
    for (int q = 1; q < a.nrs; ++q) {
      float4 v;
      asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                   : "r"(lat_dsmem(part + tid, q))
                   : "memory");
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    __syncthreads();
    const int c = c0 + 8 * warp + 2 * t4;
    if (mine && c < R) {
      float* ob = a.out + (long long)b * H * R;
      if (g < H)
        *reinterpret_cast<float2*>(ob + (long long)g * R + c) =
            make_float2(sum.x / gm[g], sum.y / gm[g]);
      if (g + 8 < H)
        *reinterpret_cast<float2*>(ob + (long long)(g + 8) * R + c) =
            make_float2(sum.z / gm[g + 8], sum.w / gm[g + 8]);
    }
  }
  lat_cluster_sync();                       // rank 0 is done reading
}

// The launch plan (ops.latent_split_plan mirrors it) and the scratch
// layout, each region rounded up to 4 floats (16 bytes).
struct LatPlan {
  int T, tr1, tpe, nblk1, nrs;
  long long o_smax, total;
};

static LatPlan lat_plan(int B, int H, int nsel, int chunk) {
  LatPlan p;
  p.T = nsel * chunk + 1;
  // launch 1's tile: the largest of 64, 32, 16 rows that gives the grid
  // LAT_BLOCKS1 blocks, and no larger than the chunk (rounded up to 8
  // rows)
  int tr = LAT_TR;
  while (tr > 16 &&
         (long long)B * nsel * ((chunk + tr - 1) / tr) < LAT_BLOCKS1)
    tr /= 2;
  p.tr1 = std::min(tr, (chunk + 7) / 8 * 8);
  p.tpe = (chunk + p.tr1 - 1) / p.tr1;
  p.nblk1 = std::max(1, nsel * p.tpe);
  // launch 2's row splits: about LAT_SPLIT_ROWS selected rows each, at
  // most LAT_MAX_SPLITS (a portable cluster)
  p.nrs = (int)std::min<long long>(
      LAT_MAX_SPLITS, std::max<long long>(
                          1, ((long long)nsel * chunk + LAT_SPLIT_ROWS - 1) /
                                 LAT_SPLIT_ROWS));
  auto up4 = [](long long x) { return (x + 3) / 4 * 4; };
  p.o_smax = up4((long long)B * H * p.T);
  p.total = p.o_smax + (long long)B * H * p.nblk1;
  return p;
}

static size_t lat_smem1(const LatArgs& a) {
  return 128 + (size_t)((a.tr1 + 7) / 8 * 8) * a.stride1 +
         sizeof(float4) * LW * LAT_NT * 32 + sizeof(float) * LW * LAT_H;
}

template <typename TQ>
static int lat_launch(const LatArgs& a, cudaStream_t st) {
  const size_t s1 = lat_smem1(a), s2 = LatPvSmem::kBytes;
  int e = smem_opt_in(lat_scores_kernel<TQ>, s1);
  if (e == 0) e = smem_opt_in(lat_pv_kernel<TQ>, s2);
  if (e != 0) return e;
  lat_scores_kernel<TQ><<<dim3(a.nblk1, a.B), LT, s1, st>>>(a);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  // programmatic dependent launch: launch 2's blocks list their rows
  // while launch 1 runs; clusters of one column slice's row splits
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.R + LAT_CW - 1) / LAT_CW * a.nrs, a.B);
  cfg.blockDim = dim3(LT);
  cfg.dynamicSmemBytes = s2;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = a.nrs;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = (int)cudaLaunchKernelEx(&cfg, lat_pv_kernel<TQ>, a);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// q: (B, H, D) contiguous, model dtype q_dtype (LeoamDType), pre-scaled;
// slab: fp16 rows, 4-byte aligned, row t of slot s at element s *
// slot_stride + t * D (D even, so every row is 4-byte aligned); slots /
// cids: (B, nsel) int32; lengths: (B,) int32; lat_new: (B, D) in q_dtype;
// H <= 16, D <= 704, R even <= 512 and <= D; scratch:
// leoam_sparse_decode_latent_scratch() f32; out: (B, H, R) f32.  Two
// launches on `stream`.
extern "C" long long leoam_sparse_decode_latent_scratch(int B, int H, int R,
                                                        int nsel, int chunk) {
  (void)R;
  return lat_plan(B, H, nsel, chunk).total;
}

extern "C" int leoam_sparse_decode_latent(
    const void* q, const void* slab, long long slot_stride, const void* slots,
    const void* cids, int nsel, const void* lengths, const void* lat_new,
    int B, int H, int D, int R, int chunk, void* scratch, void* out,
    int q_dtype, void* stream) {
  if (H <= 0 || H > LAT_H || D <= 0 || D > LAT_MAX_D || D % 2 != 0 ||
      R <= 0 || R > D || R % 2 != 0 || R > LAT_MAX_R || chunk <= 0 ||
      nsel < 0 || slot_stride % 2 != 0 ||
      reinterpret_cast<uintptr_t>(slab) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const LatPlan p = lat_plan(B, H, nsel, chunk);
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
  a.T = p.T;
  a.tr1 = p.tr1;
  a.tpe = p.tpe;
  a.nblk1 = p.nblk1;
  a.nrs = p.nrs;
  // a staged row of launch 1: D rounded up to 32 columns, then 16 words
  // more where that is a multiple of 32 words, so its stride is 16 words
  // mod 32 and the 16-byte fragment loads of 8 rows x 4 lanes hit every
  // bank once a quarter-warp
  const int rb1 = (D + 31) / 32 * 64;
  a.stride1 = rb1 + ((rb1 / 4) % 32 == 0 ? 64 : 0);
  a.vec_rows = reinterpret_cast<uintptr_t>(slab) % 16 == 0 &&
               slot_stride % 8 == 0 && D % 8 == 0;
  const int qsize = q_dtype == LEOAM_F32 ? 4 : 2;
  a.vec_q = reinterpret_cast<uintptr_t>(q) % 16 == 0 && (D * qsize) % 16 == 0;
  float* f = static_cast<float*>(scratch);
  a.sc = f;
  a.smax = f + p.o_smax;
  a.out = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case LEOAM_F32: return lat_launch<float>(a, st);
    case LEOAM_F16: return lat_launch<__half>(a, st);
    case LEOAM_BF16: return lat_launch<__nv_bfloat16>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
