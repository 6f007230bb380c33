// B2 — sparse decode attention over selected KV chunks.
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
// 4 * G * chunk * hd operations — with G = 1 about one operation per byte.
//
// Design: one block per (sequence, kv head); the TPU's sequential grid
// dimension becomes loops inside the block.  Pass 1: warps take rows and
// lanes stride the head dim for the scores (one contiguous row read per
// warp), into shared memory (G * (nsel * chunk + 1) floats).  Pass 2: per
// q head, the max over every row, then exp(s - max) and its sum — one
// softmax, as the plain version takes it, so the kernel rounds the
// probabilities at the same values (an online softmax would round them
// against running maxima and drift by an ulp of the model dtype).
// Pass 3: P.V, each thread owning head-dim columns (contiguous across a
// row group) over every SD_RG-th row, the groups summed at the end.
// Blocks read their own indices: chunk rows come from the pool slot (or
// b * nc + chunk id for a (B, S, Hkv, hd) cache), and a chunk id < 0
// (selection padding) is skipped.  Split-KV across blocks is later work;
// so is staging rows with TMA.
//
// Cast points follow the plain version exactly (the JAX engine's
// _attend_core): K and V values are rounded to the model dtype TM before
// use, q is scaled in TM by a TM-rounded 1/sqrt(hd), scores accumulate in
// f32, and each probability is rounded to TM before the P.V product, which
// accumulates in f32; the denominator sums the unrounded f32 values.  The
// Pallas contract runs with TM = float, where every rounding is exact.
#include "common.cuh"

constexpr int SD_THREADS = 512;
constexpr int SD_CT = 128;        // column threads: pass 3 owns hd columns
constexpr int SD_RG = SD_THREADS / SD_CT;  // row groups of pass 3
constexpr int SD_MAX_G = 16;      // q heads per kv head
constexpr int SD_MAX_DPT = 2;     // head-dim columns per thread (hd <= 256)
constexpr int SD_MAX_SMEM = 232448;  // a block's shared memory on Hopper

// isfinite() without relying on the math library's device overloads
__device__ __forceinline__ bool finite_f(float x) { return fabsf(x) < INFINITY; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Scores of one row against the G scaled queries: lanes stride the head
// dim, the sum is a warp reduction; lane 0 writes sc[g * T + t].
template <typename TM, typename TSRC>
__device__ __forceinline__ void sd_score_row(const TSRC* __restrict__ row,
                                             const float* __restrict__ qs,
                                             float* sc, int T, int t, int G,
                                             int hd, float softcap,
                                             int lane) {
  float part[SD_MAX_G];
#pragma unroll
  for (int g = 0; g < SD_MAX_G; ++g) part[g] = 0.f;
  for (int d = lane; d < hd; d += 32) {
    const float kv = round_to<TM>(to_f32(row[d]));
#pragma unroll
    for (int g = 0; g < SD_MAX_G; ++g)
      if (g < G) part[g] += qs[g * hd + d] * kv;
  }
#pragma unroll
  for (int g = 0; g < SD_MAX_G; ++g) {
    if (g < G) {
      float s = warp_sum(part[g]);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      if (lane == 0) sc[g * T + t] = s;
    }
  }
}

// P.V over one row: acc[g][k] += round_TM(p[g]) * v[d], d = col + k*SD_CT.
template <typename TM, typename TSRC>
__device__ __forceinline__ void sd_pv_row(const TSRC* __restrict__ row,
                                          const float* sc, int T, int t,
                                          int G, int hd, int col,
                                          float (&acc)[SD_MAX_G][SD_MAX_DPT]) {
  float vv[SD_MAX_DPT];
#pragma unroll
  for (int k = 0; k < SD_MAX_DPT; ++k) {
    const int d = col + k * SD_CT;
    vv[k] = d < hd ? round_to<TM>(to_f32(row[d])) : 0.f;
  }
#pragma unroll
  for (int g = 0; g < SD_MAX_G; ++g) {
    if (g < G) {
      const float pm = round_to<TM>(sc[g * T + t]);
#pragma unroll
      for (int k = 0; k < SD_MAX_DPT; ++k) acc[g][k] += pm * vv[k];
    }
  }
}

template <typename TKV, typename TM>
__global__ void __launch_bounds__(SD_THREADS) sparse_decode_kernel(
    const TM* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, long long row_stride,
    const int* __restrict__ slot_idx, const int* __restrict__ cid_idx,
    int idx_b_stride, int idx_h_stride, int nsel, long long row_b_offset,
    const int* __restrict__ lengths, int len_b_stride,
    const TM* __restrict__ k_new, const TM* __restrict__ v_new, int Hkv,
    int G, int hd, int chunk, float q_scale, float softcap,
    TM* __restrict__ out, float* __restrict__ num_out,
    float* __restrict__ den_out, float* __restrict__ m_out) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int T = nsel * chunk + 1;   // selected rows, then the new token
  float* qs = smem;                 // G * hd scaled query
  float* sc = qs + G * hd;          // G * T scores, then probabilities
  float* red = sc + G * T;          // per g: max, then sum
  float* part = red + 2 * SD_MAX_G;  // (SD_RG - 1) * G * hd partial P.V

  const long long qoff = ((long long)b * Hkv + h) * G * hd;
  for (int i = tid; i < G * hd; i += blockDim.x)
    qs[i] = round_to<TM>(to_f32(q[qoff + i]) * q_scale);
  __syncthreads();

  const int len = lengths[(long long)b * len_b_stride];
  const long long tok_stride = (long long)Hkv * hd;
  const long long ioff = (long long)b * idx_b_stride
                         + (long long)h * idx_h_stride;
  const long long nb = ((long long)b * Hkv + h) * hd;

  // 1. scores of every selected row; padding (chunk id < 0) and rows at
  //    pos >= length score -inf, the new token is always attended
  for (int t = warp; t < T; t += nwarps) {
    const int j = t / chunk;
    const int r = t - j * chunk;
    if (j < nsel) {
      const int cid = cid_idx[ioff + j];
      if (cid < 0 || cid * chunk + r >= len) {
        if (lane == 0)
          for (int g = 0; g < G; ++g) sc[g * T + t] = -INFINITY;
        continue;
      }
      const long long row = (long long)slot_idx[ioff + j] + b * row_b_offset;
      sd_score_row<TM>(k + row * row_stride + r * tok_stride + h * hd, qs,
                       sc, T, t, G, hd, softcap, lane);
    } else if (k_new != nullptr) {
      sd_score_row<TM>(k_new + nb, qs, sc, T, t, G, hd, softcap, lane);
    } else if (lane == 0) {
      for (int g = 0; g < G; ++g) sc[g * T + t] = -INFINITY;
    }
  }
  __syncthreads();

  // 2. per q head: the max over all rows, then exp(s - max) in place and
  //    its sum — the plain version's single softmax, not an online one
  for (int g = warp; g < G; g += nwarps) {
    float mx = -INFINITY;
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, sc[g * T + t]);
    mx = warp_max(mx);
    const float ms = finite_f(mx) ? mx : 0.f;
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float s = sc[g * T + t];
      const float p = s == -INFINITY ? 0.f : expf(s - ms);
      sc[g * T + t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      red[2 * g] = mx;
      red[2 * g + 1] = sum;
    }
  }
  __syncthreads();

  // 3. P.V: thread (grp, col) owns head-dim columns col + k*SD_CT
  //    (contiguous across a row group) over the rows r == grp mod SD_RG;
  //    the row groups' partial sums are added in a fixed order below
  const int grp = tid / SD_CT;
  const int col = tid - grp * SD_CT;
  float acc[SD_MAX_G][SD_MAX_DPT];
#pragma unroll
  for (int g = 0; g < SD_MAX_G; ++g)
#pragma unroll
    for (int kk = 0; kk < SD_MAX_DPT; ++kk) acc[g][kk] = 0.f;
  for (int j = 0; j < nsel; ++j) {
    const int cid = cid_idx[ioff + j];
    if (cid < 0) continue;           // selection padding (uniform)
    const long long row = (long long)slot_idx[ioff + j] + b * row_b_offset;
    const TKV* vb = v + row * row_stride + h * hd;
    const int nvalid = min(chunk, max(0, len - cid * chunk));
#pragma unroll 4
    for (int r = grp; r < nvalid; r += SD_RG)
      sd_pv_row<TM>(vb + r * tok_stride, sc, T, j * chunk + r, G, hd, col,
                    acc);
  }
  if (v_new != nullptr && grp == SD_RG - 1)
    sd_pv_row<TM>(v_new + nb, sc, T, T - 1, G, hd, col, acc);
  if (grp > 0) {
#pragma unroll
    for (int g = 0; g < SD_MAX_G; ++g)
      if (g < G)
#pragma unroll
        for (int kk = 0; kk < SD_MAX_DPT; ++kk) {
          const int d = col + kk * SD_CT;
          if (d < hd) part[((grp - 1) * G + g) * hd + d] = acc[g][kk];
        }
  }
  __syncthreads();
  if (grp > 0) return;
#pragma unroll
  for (int g = 0; g < SD_MAX_G; ++g)
    if (g < G)
#pragma unroll
      for (int kk = 0; kk < SD_MAX_DPT; ++kk) {
        const int d = col + kk * SD_CT;
        if (d < hd)
          for (int r = 1; r < SD_RG; ++r)
            acc[g][kk] += part[((r - 1) * G + g) * hd + d];
      }

#pragma unroll
  for (int g = 0; g < SD_MAX_G; ++g) {
    if (g < G) {
      const float den = red[2 * g + 1];
      const float dd = den == 0.f ? 1.f : den;
      const long long o = qoff + (long long)g * hd;
#pragma unroll
      for (int kk = 0; kk < SD_MAX_DPT; ++kk) {
        const int d = col + kk * SD_CT;
        if (d < hd) {
          if (out != nullptr) out[o + d] = from_f32<TM>(acc[g][kk] / dd);
          if (num_out != nullptr) num_out[o + d] = acc[g][kk];
        }
      }
      if (tid == 0 && den_out != nullptr) {
        const long long so = ((long long)b * Hkv + h) * G + g;
        den_out[so] = den;
        m_out[so] = red[2 * g];
      }
    }
  }
}

// Shared scratch bytes for one block.
static size_t sd_smem(int G, int hd, int nsel, int chunk) {
  return sizeof(float) * ((size_t)G * hd * SD_RG
                          + (size_t)G * (nsel * (size_t)chunk + 1)
                          + 2 * SD_MAX_G);
}

template <typename TKV, typename TM>
static int sd_launch(const void* q, const void* k, const void* v,
                     long long row_stride, const int* slot_idx,
                     const int* cid_idx, int idx_b_stride, int idx_h_stride,
                     int nsel, long long row_b_offset, const int* lengths,
                     int len_b_stride, const void* k_new, const void* v_new,
                     int B, int Hkv, int G, int hd, int chunk, float q_scale,
                     float softcap, void* out, float* num_out,
                     float* den_out, float* m_out, cudaStream_t st) {
  const size_t smem = sd_smem(G, hd, nsel, chunk);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sparse_decode_kernel<TKV, TM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Hkv, B);
  sparse_decode_kernel<TKV, TM><<<grid, SD_THREADS, smem, st>>>(
      static_cast<const TM*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), row_stride, slot_idx, cid_idx, idx_b_stride,
      idx_h_stride, nsel, row_b_offset, lengths, len_b_stride,
      static_cast<const TM*>(k_new), static_cast<const TM*>(v_new), Hkv, G,
      hd, chunk, q_scale, softcap, static_cast<TM*>(out), num_out, den_out,
      m_out);
  return (int)cudaGetLastError();
}

// Chunk row r of the KV slab starts at element r * row_stride of k (and of
// v); token t of kv head h sits at + (t * Hkv + h) * hd.  The row of the
// j-th selection of (b, h) is slot_idx[off] + b * row_b_offset and its
// chunk id (for the pos < length mask) cid_idx[off], off = b*idx_b_stride
// + h*idx_h_stride + j.  q: (B, Hkv, G, hd) in the model dtype; out (may
// be null): normalized (B, Hkv, G, hd) in the model dtype; num/den/m (may
// be null): the f32 partial-softmax triple.  k_new/v_new (may be null):
// (B, Hkv, hd) rows in the model dtype, always attended.
extern "C" int leoam_sparse_decode(
    const void* q, const void* k, const void* v, long long row_stride,
    const void* slot_idx, const void* cid_idx, int idx_b_stride,
    int idx_h_stride, int nsel, long long row_b_offset, const void* lengths,
    int len_b_stride, const void* k_new, const void* v_new, int B, int Hkv,
    int G, int hd, int chunk, float q_scale, float softcap, void* out,
    void* num_out, void* den_out, void* m_out, int kv_dtype, int model_dtype,
    void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (G > SD_MAX_G || hd > SD_MAX_DPT * SD_CT || chunk <= 0 ||
      sd_smem(G, hd, nsel, chunk) > SD_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* si = static_cast<const int*>(slot_idx);
  const int* ci = static_cast<const int*>(cid_idx);
  const int* ln = static_cast<const int*>(lengths);
  float* nu = static_cast<float*>(num_out);
  float* de = static_cast<float*>(den_out);
  float* mo = static_cast<float*>(m_out);
#define SD_CALL(TKV, TM)                                                    \
  return sd_launch<TKV, TM>(q, k, v, row_stride, si, ci, idx_b_stride,      \
                            idx_h_stride, nsel, row_b_offset, ln,           \
                            len_b_stride, k_new, v_new, B, Hkv, G, hd, chunk, \
                            q_scale, softcap, out, nu, de, mo, st)
  if (kv_dtype == LEOAM_F16 && model_dtype == LEOAM_BF16)
    SD_CALL(__half, __nv_bfloat16);
  if (kv_dtype == LEOAM_F16 && model_dtype == LEOAM_F16) SD_CALL(__half, __half);
  if (kv_dtype == LEOAM_F16 && model_dtype == LEOAM_F32) SD_CALL(__half, float);
  if (kv_dtype == LEOAM_F32 && model_dtype == LEOAM_F32) SD_CALL(float, float);
  if (kv_dtype == LEOAM_BF16 && model_dtype == LEOAM_F32)
    SD_CALL(__nv_bfloat16, float);
  if (kv_dtype == LEOAM_BF16 && model_dtype == LEOAM_BF16)
    SD_CALL(__nv_bfloat16, __nv_bfloat16);
#undef SD_CALL
  return (int)cudaErrorInvalidValue;
}
