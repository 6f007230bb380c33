// B2 — sparse decode attention over selected KV chunks, split across blocks.
//
// Replaces the Pallas kernel repro/kernels/sparse_decode/sparse_decode.py
// (_decode_kernel, sparse_decode_pallas): a flash decode whose grid walks
// the selected chunk ids sequentially (scalar-prefetched into the DMA
// index map) with the (num, den, m) accumulators in VMEM scratch, masking
// positions >= length to -inf.  The JAX engine reaches the same work
// through engine._attend_pooled (gather by slot, strict pos < length mask,
// the new token's row appended); this kernel serves both contracts.
//
// What bounds it on the H100: bytes.  Every selected K and V row is read
// once (2 * chunk * hd * 2 bytes per chunk and kv head for fp16) for
// 4 * G * chunk * hd operations — with G = 1 about one operation per byte,
// so tensor cores cannot help; the card has to keep many rows in flight.
//
// Design: the rows of each (sequence, kv head) are split across blocks,
// grid (nsplit, Hkv, B); the split plan (ops.py:split_plan) gives every
// split whole selection entries and ~8 blocks per SM.  A block stages its
// rows into shared memory with 16-byte cp.async copies, each thread's
// completion counted on the tile's mbarrier, double-buffered: the next
// tile's copies are in flight while the current one is read.
// Scores use 16-byte shared-memory loads, a few lanes per row.  Two
// launches, no float atomics, so two calls give bitwise-equal output:
//   1. scores: each split writes its rows' scores to an f32 scratch
//      (B, H, nsel * chunk + 1) and its per-head maximum;
//   2. P.V: each split takes the global maximum (the max of the split
//      maxima), forms p = exp(s - m), rounds p to the model dtype where
//      the plain version does, and writes f32 num and den partials;
//      the last split of a (b, h) to finish (an integer count) then adds
//      the partials in split order.  Every split used the same m, so
//      nothing is rescaled, and the probabilities round against the global
//      max as in the plain version's one softmax (an online softmax rounds
//      against running maxima and drifts by an ulp).
// Blocks read their own indices: chunk rows come from the pool slot (or
// b * nc + chunk id for a (B, S, Hkv, hd) cache); a chunk id < 0
// (selection padding) and rows at pos >= length are never read, a split
// with no live row contributes nothing, and a head with no live row at all
// gets den 0.  The new token's row belongs to the last split.
//
// Launch 2 is a programmatic dependent launch: its blocks start when every
// block of launch 1 has, stage their first V tile, and wait for launch 1's
// results only then (griddepcontrol).
//
// Where it still falls short: at the main path's shape each launch runs
// 3-5x its share of the byte bound.  A block's fixed cost (launch, index
// and query loads, the reductions) is as large as its copy and its
// arithmetic together, and launch 2's arithmetic cannot start before every
// split's maximum is known, so the card drains once per call.  Tried
// and measured slower or no faster (PERF.md): TMA bulk copies of one row
// each, 8 KB or 4 KB tiles, 256 threads, and persistent blocks walking the
// splits.
//
// Cast points follow the plain version exactly (the JAX engine's
// _attend_core): K and V values are rounded to the model dtype TM before
// use, q is scaled in TM by a TM-rounded 1/sqrt(hd), scores accumulate in
// f32, and each probability is rounded to TM before the P.V product, which
// accumulates in f32; the denominator sums the unrounded f32 values.  The
// Pallas contract runs with TM = float, where every rounding is exact.
#include <algorithm>

#include "common.cuh"

constexpr int SD_NT = 128;                // threads of every block
constexpr int SD_NW = SD_NT / 32;
constexpr int SD_MAX_G = 16;              // q heads per kv head
constexpr int SD_MAX_HD = 2 * SD_NT;      // P.V: at most two columns a thread
constexpr int SD_TILE_BYTES = 16384;      // one staged buffer
constexpr int SD_MAX_TILE_ROWS = 128;

// isfinite() without relying on the math library's device overloads
__device__ __forceinline__ bool finite_f(float x) { return fabsf(x) < INFINITY; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// --- mbarrier and cp.async ------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes global -> shared through the LSU, bypassing L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread issued completes
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// 16 bytes of K or V -> floats
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8],
                                         __half) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __half22float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8],
                                         __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
template <typename TKV>
__device__ __forceinline__ void unpack(const uint4& u,
                                       float (&f)[16 / sizeof(TKV)]) {
  if constexpr (sizeof(TKV) == 4) unpack16(u, f);
  else unpack16(u, f, TKV());
}

// --- the work of one call --------------------------------------------------

struct SdArgs {
  const void* q;            // (B, Hkv, G, hd) model dtype
  const void* k;            // K rows: row r of slab row `row` at
  const void* v;            //   row * row_stride + (r * Hkv + h) * hd
  long long row_stride;
  const int* slot_idx;      // slab row of selection j: slot_idx[off + j]
  const int* cid_idx;       //   + b * row_b_offset; chunk id cid_idx[off+j]
  int idx_b_stride, idx_h_stride, nsel;
  long long row_b_offset;
  const int* lengths;       // lengths[b * len_b_stride]
  int len_b_stride;
  const void* k_new;        // (B, Hkv, hd) model dtype, or null
  const void* v_new;
  int B, Hkv, G, hd, chunk, nsplit, cps, tile_rows;
  float q_scale, softcap;
  float* sc;                // (B, Hkv, G, T) scores, T = nsel * chunk + 1
  float* smax;              // (B, Hkv, G, nsplit) split maxima
  float* num_part;          // (nsplit, B, Hkv, G, hd)
  float* den_part;          // (nsplit, B, Hkv, G)
  int* done;                // (B, Hkv) splits finished, zeroed by launch 1
  void* out;                // (B, Hkv, G, hd) model dtype, or null
  float* num_out;           // the f32 triple, or null
  float* den_out;
  float* m_out;
};

// A tile: rows [r0, r0 + nr) of selection entry j, in slab row slot.
struct SdTile {
  int j, r0, nr, slot;
};

// The first tile at or after row r of entry j among entries [j, j1) that
// holds live rows (chunk id >= 0, pos < length).
__device__ __forceinline__ SdTile sd_next(int j, int r, int j1,
                                          const int* cids, const int* slots,
                                          int len, int chunk, int tile_rows) {
  for (; j < j1; ++j, r = 0) {
    const int cid = cids[j];
    const int slot = slots[j];       // loaded beside cid: one latency, not two
    const int nval = cid < 0 ? 0 : min(chunk, max(0, len - cid * chunk));
    if (r < nval) return {j, r, min(tile_rows, nval - r), slot};
  }
  return {j1, 0, 0, 0};
}

// Every thread stages its share of a tile's 16-byte vectors and arrives
// on the tile's barrier (SD_NT arrivals) when they have landed.
template <typename TKV>
__device__ __forceinline__ void sd_issue(const SdArgs& a, const TKV* slab,
                                         long long b_row, int h,
                                         const SdTile& t, char* buf,
                                         uint64_t* bar, int tid) {
  const int vpr = a.hd * (int)sizeof(TKV) / 16;
  const long long tok = (long long)a.Hkv * a.hd;
  const TKV* src = slab + ((long long)t.slot + b_row) * a.row_stride +
                   (long long)t.r0 * tok + (long long)h * a.hd;
  for (int e = tid; e < t.nr * vpr; e += SD_NT) {
    const int r = e / vpr;
    cp_async16(buf + e * 16,
               reinterpret_cast<const char*>(src + r * tok) + (e - r * vpr) * 16);
  }
  cp_async_arrive(bar);
}

// Per-block setup shared by launches 1 and 2: block (s, h, b) takes
// split s of (sequence b, kv head h).
struct SdBlock {
  int s, h, b, tid, lane, warp;
  int len, j0, j1, T;
  long long b_row, hg0;     // hg0: (b * Hkv + h) * G
  const int* cids;
  const int* slots;
  __device__ __forceinline__ SdBlock(const SdArgs& a) {
    s = blockIdx.x;
    h = blockIdx.y;
    b = blockIdx.z;
    tid = threadIdx.x;
    lane = tid & 31;
    warp = tid >> 5;
    len = a.lengths[(long long)b * a.len_b_stride];
    const long long ioff =
        (long long)b * a.idx_b_stride + (long long)h * a.idx_h_stride;
    cids = a.cid_idx + ioff;
    slots = a.slot_idx + ioff;
    b_row = (long long)b * a.row_b_offset;
    j0 = s * a.cps;
    j1 = min(a.nsel, j0 + a.cps);
    T = a.nsel * a.chunk + 1;
    hg0 = ((long long)b * a.Hkv + h) * a.G;
  }
};

// Launch 1: scores of the split's live rows and the split maximum.
template <typename TKV, typename TM, int GMAX>
__global__ void __launch_bounds__(SD_NT) sd_scores_kernel(const SdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SdBlock k(a);
  const int G = a.G, hd = a.hd;
  constexpr int E = 16 / sizeof(TKV);
  const uint32_t rb = hd * sizeof(TKV);
  char* buf[2] = {reinterpret_cast<char*>(smem),
                  reinterpret_cast<char*>(smem) + a.tile_rows * rb};
  uint64_t* bar = reinterpret_cast<uint64_t*>(buf[1] + a.tile_rows * rb);
  float* qs = reinterpret_cast<float*>(bar + 2);   // G * hd scaled query
  float* red = qs + G * hd;                        // SD_NW * G

  // launch 2 may start once every block of this grid has started: its
  // blocks stage V, which this launch does not write, then wait for it
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (k.tid == 0) {
    mbar_init(bar, SD_NT);
    mbar_init(bar + 1, SD_NT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const TKV* slab = static_cast<const TKV*>(a.k);
  SdTile cur =
      sd_next(k.j0, 0, k.j1, k.cids, k.slots, k.len, a.chunk, a.tile_rows);
  if (cur.nr > 0)
    sd_issue(a, slab, k.b_row, k.h, cur, buf[0], bar, k.tid);
  const TM* q = static_cast<const TM*>(a.q);
  for (int i = k.tid; i < G * hd; i += SD_NT)
    qs[i] = round_to<TM>(to_f32(q[k.hg0 * hd + i]) * a.q_scale);
  __syncthreads();

  float* sc = a.sc + k.hg0 * k.T;
  float mx[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) mx[g] = -INFINITY;

  // the new token's row, in the last split, by the last warp
  if (k.s == a.nsplit - 1 && a.k_new != nullptr && k.warp == SD_NW - 1) {
    const TM* kn = static_cast<const TM*>(a.k_new) +
                   ((long long)k.b * a.Hkv + k.h) * hd;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        float p = 0.f;
        for (int d = k.lane; d < hd; d += 32)
          p += qs[g * hd + d] * round_to<TM>(to_f32(kn[d]));
        p = warp_sum(p);
        if (a.softcap > 0.f) p = a.softcap * tanhf(p / a.softcap);
        if (k.lane == 0) sc[g * k.T + k.T - 1] = p;
        mx[g] = fmaxf(mx[g], p);
      }
    }
  }

  // lanes per row: lpr lanes take a row's 16-byte vectors
  const int nv = hd / E;
  int lpr = 1;
  while (lpr * 2 <= nv && lpr < 32) lpr *= 2;
  const int rpw = 32 / lpr, li = k.lane & (lpr - 1), rw = k.lane / lpr;

  for (int it = 0; cur.nr > 0; ++it) {
    const SdTile nxt = sd_next(cur.j, cur.r0 + cur.nr, k.j1, k.cids,
                               k.slots, k.len, a.chunk, a.tile_rows);
    if (nxt.nr > 0)
      sd_issue(a, slab, k.b_row, k.h, nxt, buf[(it + 1) & 1],
               bar + ((it + 1) & 1), k.tid);
    mbar_wait(bar + (it & 1), (it >> 1) & 1);
    const char* cb = buf[it & 1];
    const int t0 = cur.j * a.chunk + cur.r0;
    for (int rr = k.warp * rpw; rr < cur.nr; rr += SD_NW * rpw) {
      const int r = rr + rw;
      const bool ok = r < cur.nr;
      float part[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) part[g] = 0.f;
      if (ok) {
        const uint4* row = reinterpret_cast<const uint4*>(cb + r * rb);
        for (int vi = li; vi < nv; vi += lpr) {
          float kv[E];
          unpack<TKV>(row[vi], kv);
#pragma unroll
          for (int e = 0; e < E; ++e) kv[e] = round_to<TM>(kv[e]);
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) {
              const float4* qg =
                  reinterpret_cast<const float4*>(qs + g * hd + vi * E);
#pragma unroll
              for (int e4 = 0; e4 < E / 4; ++e4) {
                const float4 qv = qg[e4];
                part[g] += qv.x * kv[4 * e4];
                part[g] += qv.y * kv[4 * e4 + 1];
                part[g] += qv.z * kv[4 * e4 + 2];
                part[g] += qv.w * kv[4 * e4 + 3];
              }
            }
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          float sg = part[g];
          for (int o = lpr >> 1; o > 0; o >>= 1)
            sg += __shfl_xor_sync(0xffffffffu, sg, o);
          if (ok && li == 0) {
            if (a.softcap > 0.f) sg = a.softcap * tanhf(sg / a.softcap);
            sc[g * k.T + t0 + r] = sg;
            mx[g] = fmaxf(mx[g], sg);
          }
        }
      }
    }
    __syncthreads();          // the buffer is free for the tile after next
    cur = nxt;
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      const float v = warp_max(mx[g]);
      if (k.lane == 0) red[k.warp * G + g] = v;
    }
  }
  __syncthreads();
  if (k.tid < G) {
    float v = -INFINITY;
    for (int w = 0; w < SD_NW; ++w) v = fmaxf(v, red[w * G + k.tid]);
    a.smax[(k.hg0 + k.tid) * a.nsplit + k.s] = v;
  }
  if (k.s == 0 && k.tid == 0) a.done[k.b * a.Hkv + k.h] = 0;
}

// The partials of (b, h) added in split order; the normalized output
// and/or the f32 triple with m the global max.  Reads bypass L1: other
// blocks wrote them.
template <typename TM>
__device__ __forceinline__ void sd_combine(const SdArgs& a, int b, int h) {
  const int G = a.G, hd = a.hd;
  const long long hg0 = ((long long)b * a.Hkv + h) * G;
  const long long pstride = (long long)a.B * a.Hkv * G;
  for (int e = threadIdx.x; e < G * hd; e += SD_NT) {
    const int g = e / hd, d = e - g * hd;
    const long long hg = hg0 + g;
    float num = 0.f, den = 0.f;
    for (int sp = 0; sp < a.nsplit; ++sp) {
      num += __ldcg(a.num_part + (sp * pstride + hg) * hd + d);
      den += __ldcg(a.den_part + sp * pstride + hg);
    }
    if (a.out != nullptr)
      static_cast<TM*>(a.out)[hg * hd + d] =
          from_f32<TM>(num / (den == 0.f ? 1.f : den));
    if (a.num_out != nullptr) a.num_out[hg * hd + d] = num;
    if (d == 0 && a.den_out != nullptr) {
      float m = -INFINITY;
      for (int sp = 0; sp < a.nsplit; ++sp)
        m = fmaxf(m, a.smax[hg * a.nsplit + sp]);
      a.den_out[hg] = den;
      a.m_out[hg] = m;
    }
  }
}


// Launch 2: p = exp(s - global max) over the split's live rows, the f32
// partials num = sum round_TM(p) * v and den = sum p; the last split of
// (b, h) to finish (an integer count, so which block that is never changes
// the sums) then adds the partials.
template <typename TKV, typename TM, int GMAX>
__global__ void __launch_bounds__(SD_NT) sd_pv_kernel(const SdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;
  const SdBlock k(a);
  const int G = a.G, hd = a.hd, TR = a.tile_rows;
  const uint32_t rb = hd * sizeof(TKV);
  char* buf[2] = {reinterpret_cast<char*>(smem),
                  reinterpret_cast<char*>(smem) + TR * rb};
  uint64_t* bar = reinterpret_cast<uint64_t*>(buf[1] + TR * rb);
  float* gm = reinterpret_cast<float*>(bar + 2);   // G: the safe global max
  float* pt = gm + G;                              // G * TR probabilities
  float* red = pt + G * TR;                        // SD_NW * G
  float* part = red + SD_NW * G;                   // row-group partials

  if (k.tid == 0) {
    mbar_init(bar, SD_NT);
    mbar_init(bar + 1, SD_NT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const TKV* slab = static_cast<const TKV*>(a.v);
  SdTile cur = sd_next(k.j0, 0, k.j1, k.cids, k.slots, k.len, a.chunk, TR);
  if (cur.nr > 0)
    sd_issue(a, slab, k.b_row, k.h, cur, buf[0], bar, k.tid);
  // the scores, split maxima and counters of launch 1 from here on
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  for (int g = k.warp; g < G; g += SD_NW) {
    float v = -INFINITY;
    const float* sm = a.smax + (k.hg0 + g) * a.nsplit;
    for (int sp = k.lane; sp < a.nsplit; sp += 32) v = fmaxf(v, sm[sp]);
    v = warp_max(v);
    if (k.lane == 0) gm[g] = finite_f(v) ? v : 0.f;
  }
  __syncthreads();

  // P.V layout: thread (grp, col) owns columns col (+ SD_NT) over the rows
  // r == grp mod RG; the row groups are added in order at the end
  const int RG = hd >= SD_NT ? 1 : SD_NT / hd;
  const int cw = RG > 1 ? hd : SD_NT;
  const int grp = k.tid / cw, col = k.tid - grp * cw;
  const float* sc = a.sc + k.hg0 * k.T;
  float acc[GMAX][2], den[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    acc[g][0] = acc[g][1] = 0.f;
    den[g] = 0.f;
  }

  for (int it = 0; cur.nr > 0; ++it) {
    const SdTile nxt = sd_next(cur.j, cur.r0 + cur.nr, k.j1, k.cids,
                               k.slots, k.len, a.chunk, TR);
    if (nxt.nr > 0)
      sd_issue(a, slab, k.b_row, k.h, nxt, buf[(it + 1) & 1],
               bar + ((it + 1) & 1), k.tid);
    const int t0 = cur.j * a.chunk + cur.r0;
    for (int r = k.tid; r < cur.nr; r += SD_NT) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) {
          const float p = expf(sc[g * k.T + t0 + r] - gm[g]);
          pt[g * TR + r] = p;
          den[g] += p;
        }
    }
    mbar_wait(bar + (it & 1), (it >> 1) & 1);
    __syncthreads();                              // pt is complete
    const TKV* vb = reinterpret_cast<const TKV*>(buf[it & 1]);
    if (grp < RG) {
      for (int r = grp; r < cur.nr; r += RG) {
        float vv[2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int d = col + kk * SD_NT;
          vv[kk] = d < hd ? round_to<TM>(to_f32(vb[r * hd + d])) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) {
            const float pm = round_to<TM>(pt[g * TR + r]);
            acc[g][0] += pm * vv[0];
            acc[g][1] += pm * vv[1];
          }
      }
    }
    __syncthreads();                              // buffer and pt are free
    cur = nxt;
  }

  if (k.s == a.nsplit - 1 && a.v_new != nullptr) {
    const TM* vn = static_cast<const TM*>(a.v_new) +
                   ((long long)k.b * a.Hkv + k.h) * hd;
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) {
        const float p = expf(sc[g * k.T + k.T - 1] - gm[g]);
        if (k.tid == 0) den[g] += p;
        if (grp == RG - 1) {
          const float pm = round_to<TM>(p);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int d = col + kk * SD_NT;
            if (d < hd) acc[g][kk] += pm * round_to<TM>(to_f32(vn[d]));
          }
        }
      }
  }

  // row groups (RG > 1 means one column a thread) and the den partial
  if (grp > 0 && grp < RG) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) part[((grp - 1) * G + g) * hd + col] = acc[g][0];
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G) {
      const float v = warp_sum(den[g]);
      if (k.lane == 0) red[k.warp * G + g] = v;
    }
  __syncthreads();
  const long long po = (long long)k.s * a.B * a.Hkv * G + k.hg0;
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) {
        for (int r = 1; r < RG; ++r)
          acc[g][0] += part[((r - 1) * G + g) * hd + col];
        float* np_ = a.num_part + (po + g) * hd;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int d = col + kk * SD_NT;
          if (d < hd) np_[d] = acc[g][kk];
        }
      }
  }
  if (k.tid < G) {
    float v = 0.f;
    for (int w = 0; w < SD_NW; ++w) v += red[w * G + k.tid];
    a.den_part[po + k.tid] = v;
  }

  __threadfence();
  __syncthreads();
  if (k.tid == 0)
    s_last = atomicAdd(a.done + k.b * a.Hkv + k.h, 1) == a.nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  sd_combine<TM>(a, k.b, k.h);
}

static size_t sd_scores_smem(const SdArgs& a, int rb) {
  return 2 * (size_t)a.tile_rows * rb + 2 * sizeof(uint64_t) +
         sizeof(float) * ((size_t)a.G * a.hd + SD_NW * a.G);
}

static size_t sd_pv_smem(const SdArgs& a, int rb) {
  return 2 * (size_t)a.tile_rows * rb + 2 * sizeof(uint64_t) +
         sizeof(float) * ((size_t)a.G * (1 + a.tile_rows + SD_NW + SD_NT));
}

// Shared memory over 48 KB must be opted into; and ask for the largest
// shared-memory carveout, so the SM holds as many blocks as smem allows.
template <typename K>
static int sd_smem_attr(K kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return (int)e;
}

// GMAX bounds the q heads a kernel unrolls for (G = 1 for MHA models).
template <typename TKV, typename TM, int GMAX>
static int sd_launch(const SdArgs& a, cudaStream_t st) {
  const int rb = a.hd * (int)sizeof(TKV);
  if (rb % 16 != 0) return (int)cudaErrorInvalidValue;   // 16-byte copies
  SdArgs w = a;
  w.tile_rows = std::min(a.chunk, std::min(SD_MAX_TILE_ROWS,
                                          std::max(1, SD_TILE_BYTES / rb)));
  const size_t s1 = sd_scores_smem(w, rb), s2 = sd_pv_smem(w, rb);
  int e = sd_smem_attr(sd_scores_kernel<TKV, TM, GMAX>, s1);
  if (e == 0) e = sd_smem_attr(sd_pv_kernel<TKV, TM, GMAX>, s2);
  if (e != 0) return e;
  const dim3 grid(a.nsplit, a.Hkv, a.B);
  sd_scores_kernel<TKV, TM, GMAX><<<grid, SD_NT, s1, st>>>(w);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  // programmatic dependent launch: launch 2's blocks stage their first V
  // tile while launch 1 finishes
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(SD_NT);
  cfg.dynamicSmemBytes = s2;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, sd_pv_kernel<TKV, TM, GMAX>, w);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

template <typename TKV, typename TM>
static int sd_launch_g(const SdArgs& a, cudaStream_t st) {
  if (a.G == 1) return sd_launch<TKV, TM, 1>(a, st);
  if (a.G <= 4) return sd_launch<TKV, TM, 4>(a, st);
  return sd_launch<TKV, TM, SD_MAX_G>(a, st);
}

// Chunk row r of the KV slab starts at element r * row_stride of k (and of
// v); token t of kv head h sits at + (t * Hkv + h) * hd.  The row of the
// j-th selection of (b, h) is slot_idx[off] + b * row_b_offset and its
// chunk id (for the pos < length mask) cid_idx[off], off = b*idx_b_stride
// + h*idx_h_stride + j.  q: (B, Hkv, G, hd) in the model dtype; out (may
// be null): normalized (B, Hkv, G, hd) in the model dtype; num/den/m (may
// be null): the f32 partial-softmax triple.  k_new/v_new (may be null):
// (B, Hkv, hd) rows in the model dtype, always attended.  Split s covers
// selection entries [s * chunks_per_split, (s + 1) * chunks_per_split);
// nsplit = max(1, ceil(nsel / chunks_per_split)).  scratch: 4-byte,
// B * Hkv * (G * (nsel * chunk + 1 + nsplit * (hd + 2)) + 1) elements.
// Two launches on `stream`.
extern "C" int leoam_sparse_decode(
    const void* q, const void* k, const void* v, long long row_stride,
    const void* slot_idx, const void* cid_idx, int idx_b_stride,
    int idx_h_stride, int nsel, long long row_b_offset, const void* lengths,
    int len_b_stride, const void* k_new, const void* v_new, int B, int Hkv,
    int G, int hd, int chunk, int nsplit, int chunks_per_split,
    float q_scale, float softcap, void* scratch, void* out, void* num_out,
    void* den_out, void* m_out, int kv_dtype, int model_dtype,
    void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  const int want = nsel > 0 ? (nsel + chunks_per_split - 1) / chunks_per_split
                            : 1;
  if (G < 1 || G > SD_MAX_G || hd < 1 || hd > SD_MAX_HD || chunk <= 0 ||
      nsel < 0 || chunks_per_split < 1 || nsplit != want ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  SdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.row_stride = row_stride;
  a.slot_idx = static_cast<const int*>(slot_idx);
  a.cid_idx = static_cast<const int*>(cid_idx);
  a.idx_b_stride = idx_b_stride;
  a.idx_h_stride = idx_h_stride;
  a.nsel = nsel;
  a.row_b_offset = row_b_offset;
  a.lengths = static_cast<const int*>(lengths);
  a.len_b_stride = len_b_stride;
  a.k_new = k_new;
  a.v_new = v_new;
  a.B = B;
  a.Hkv = Hkv;
  a.G = G;
  a.hd = hd;
  a.chunk = chunk;
  a.nsplit = nsplit;
  a.cps = chunks_per_split;
  a.tile_rows = 0;
  a.q_scale = q_scale;
  a.softcap = softcap;
  const long long hgs = (long long)B * Hkv * G;
  a.sc = static_cast<float*>(scratch);
  a.smax = a.sc + hgs * ((long long)nsel * chunk + 1);
  a.num_part = a.smax + hgs * nsplit;
  a.den_part = a.num_part + hgs * nsplit * hd;
  a.done = reinterpret_cast<int*>(a.den_part + hgs * nsplit);
  a.out = out;
  a.num_out = static_cast<float*>(num_out);
  a.den_out = static_cast<float*>(den_out);
  a.m_out = static_cast<float*>(m_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == LEOAM_F16 && model_dtype == LEOAM_BF16)
    return sd_launch_g<__half, __nv_bfloat16>(a, st);
  if (kv_dtype == LEOAM_F16 && model_dtype == LEOAM_F16)
    return sd_launch_g<__half, __half>(a, st);
  if (kv_dtype == LEOAM_F16 && model_dtype == LEOAM_F32)
    return sd_launch_g<__half, float>(a, st);
  if (kv_dtype == LEOAM_F32 && model_dtype == LEOAM_F32)
    return sd_launch_g<float, float>(a, st);
  if (kv_dtype == LEOAM_BF16 && model_dtype == LEOAM_F32)
    return sd_launch_g<__nv_bfloat16, float>(a, st);
  if (kv_dtype == LEOAM_BF16 && model_dtype == LEOAM_BF16)
    return sd_launch_g<__nv_bfloat16, __nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
