// B3 — transit-codec dequantization (int8, or int4 packed lo | hi << 4),
// fused with the scatter of the dequantized chunks into their pool slots.
//
// Replaces the Pallas kernel src/repro/kernels/kv_quant/kv_quant.py:21
// _dequant_int8_kernel, :27 _dequant_int4_kernel, :40 kv_dequant_pallas
// (one grid step per chunk on the TPU's vector unit, into a fresh (N, c, d)
// array).  Here one launch dequantizes the K and V planes of a layer's
// codec upload and writes them straight into the store's device slab
// (slot, plane, c, d): no intermediate tensor, no transpose, no second
// index-put pass over the output.
//
// What bounds it on the H100: bytes.  It reads 1 (int8) or 0.5 (int4)
// byte per output plus one f32 scale per channel per chunk, and writes
// 2 bytes per fp16/bf16 output; one multiply per output is no work worth
// counting.  So the design is about whole-sector accesses:
//
// * a thread owns one column unit of W payload bytes whose outputs make
//   ONE store of at most 16 bytes (int4 -> fp16: 4 payload bytes, 8
//   channels, a 16-byte store); neighbouring lanes own neighbouring
//   units, so every load and store instruction of a warp covers one
//   contiguous span (128 bytes of int4 payload, 512 bytes of fp16 output)
//   in whole 32-byte sectors.  (A thread owning a 16-byte payload group,
//   64 bytes of output in four 16-byte stores, writes half of every sector
//   a store instruction touches, and was more than twice as slow on the
//   H100 at the main shape.)
// * it loads its unit's scales once, into registers, then walks
//   kRowsPerThread rows of its chunk plane, issuing every row's payload
//   load (streaming, evict-first) before any arithmetic;
// * a block is one (chunk, plane, row tile, unit tile): blockIdx.x =
//   plane·n + chunk is the payload's row, so offsets come from blockIdx
//   and the strides passed in, never from an integer division per
//   element;
// * each output element is written by exactly one thread, no atomics, so
//   two launches are bitwise equal;
// * W is the widest of 8, 4 and 2 that the output store (<= 16 bytes),
//   the packed row width and every base pointer allow, else 1 (a payload
//   byte a thread, its outputs stored element by element, so a slab at
//   any element offset works); the wrapper picks it, in the same kernel.
//
// The product is __fmul_rn (never contracted) and the output cast is
// round-to-nearest-even, so the result is bitwise the plain version's
// (q.float() * scale).to(out dtype).
#include <string.h>

#include "common.cuh"

constexpr int kThreads = 256;      // threads per block
constexpr int kRowsPerThread = 4;  // rows a thread walks, loads in flight

template <int B>
struct Unit;  // a B-byte access
template <> struct Unit<16> { using T = uint4; };
template <> struct Unit<8> { using T = uint2; };
template <> struct Unit<4> { using T = unsigned int; };
template <> struct Unit<2> { using T = unsigned short; };

// W payload bytes as 32-bit words (W < 4: the bytes in the low bits)
template <int W>
struct Payload {
  uint32_t w[(W + 3) / 4];
};

template <int W>
__device__ __forceinline__ Payload<W> load_payload(const int8_t* p) {
  Payload<W> r;
  if constexpr (W == 8) {
    const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
    r.w[0] = t.x; r.w[1] = t.y;
  } else if constexpr (W == 4) {
    r.w[0] = __ldcs(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (W == 2) {
    r.w[0] = __ldcs(reinterpret_cast<const unsigned short*>(p));
  } else {
    r.w[0] = __ldcs(reinterpret_cast<const unsigned char*>(p));
  }
  return r;
}

// the k-th signed value of a payload: an int8 byte, or a 4-bit two's
// complement nibble (byte b holds channel 2b in its low nibble)
template <int BITS, int W>
__device__ __forceinline__ int value(const Payload<W>& q, int k) {
  if constexpr (BITS == 4) {
    const int sh = 4 * (k % 8);
    return (int)(q.w[k / 8] << (28 - sh)) >> 28;
  } else {
    const int sh = 8 * (k % 4);
    return (int)(q.w[k / 4] << (24 - sh)) >> 24;
  }
}

// blockDim = (unit lanes, row lanes); grid = (planes · n, row tiles,
// unit tiles).  out holds (slot, plane, c, d) rows; slots == nullptr is
// the identity (the Pallas contract's fresh (N, c, d) output).
template <typename TO, int BITS, int W>
__global__ void __launch_bounds__(kThreads)
kv_dequant_scatter_kernel(const int8_t* __restrict__ data,
                          const float* __restrict__ scale,
                          TO* __restrict__ out,
                          const long long* __restrict__ slots, int n, int c,
                          int d, long long slot_stride) {
  constexpr int E = BITS == 4 ? 2 : 1;  // channels per payload byte
  constexpr int OUT = W * E;            // channels of a column unit
  const int dp = d / E;
  const int g = blockIdx.z * blockDim.x + threadIdx.x;
  if (g * W >= dp) return;
  const int z = blockIdx.x;              // payload row: plane · n + chunk
  const int p = z / n;
  const int i = z - p * n;
  const long long slot = slots ? slots[i] : i;
  const int8_t* src = data + (long long)z * c * dp + g * W;
  const float* sc = scale + (long long)z * d + g * OUT;
  TO* dst = out + slot * slot_stride + (long long)p * c * d + g * OUT;
  const int r0 = blockIdx.y * blockDim.y * kRowsPerThread + threadIdx.y;

  Payload<W> q[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = r0 + k * blockDim.y;
    if (r < c) q[k] = load_payload<W>(src + (long long)r * dp);
  }
  float s[OUT];
  if constexpr (OUT % 4 == 0) {
#pragma unroll
    for (int j = 0; j < OUT; j += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(sc + j));
      s[j] = t.x; s[j + 1] = t.y; s[j + 2] = t.z; s[j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < OUT; ++j) s[j] = __ldg(sc + j);
  }

  // W > 1: the unit's outputs leave as one store of up to 16 bytes;
  // W = 1: element by element, so a slab at any element offset works
  constexpr int U = W == 1 ? (int)sizeof(TO) : OUT * (int)sizeof(TO);
  static_assert(U <= 16, "a column unit is one store of at most 16 bytes");
  using UT = typename Unit<U>::T;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = r0 + k * blockDim.y;
    if (r >= c) break;
    TO o[OUT];
#pragma unroll
    for (int j = 0; j < OUT; ++j)
      o[j] = from_f32<TO>(__fmul_rn((float)value<BITS, W>(q[k], j), s[j]));
    TO* row = dst + (long long)r * d;
#pragma unroll
    for (int j = 0; j < OUT; j += U / (int)sizeof(TO)) {
      UT u;
      memcpy(&u, &o[j], U);
      *reinterpret_cast<UT*>(row + j) = u;
    }
  }
}

// a width whose unit would need a store of more than 16 bytes is refused
template <typename TO, int BITS, int W>
static int launch(const int8_t* data, const float* scale, TO* out,
                  const long long* slots, int n, int planes, int c, int d,
                  long long slot_stride, cudaStream_t st) {
  constexpr int E = BITS == 4 ? 2 : 1;
  if constexpr (W > 1 && W * E * sizeof(TO) > 16) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int units = d / E / W;
    const int gx = units < kThreads ? units : kThreads;
    const int ry = kThreads / gx;
    const dim3 grid(planes * n,
                    (c + ry * kRowsPerThread - 1) / (ry * kRowsPerThread),
                    (units + gx - 1) / gx);
    kv_dequant_scatter_kernel<TO, BITS, W><<<grid, dim3(gx, ry), 0, st>>>(
        data, scale, out, slots, n, c, d, slot_stride);
    return 0;
  }
}

template <typename TO, int BITS>
static int launch_width(const int8_t* data, const float* scale, TO* out,
                        const long long* slots, int n, int planes, int c,
                        int d, long long slot_stride, int width,
                        cudaStream_t st) {
  switch (width) {
    case 8:
      return launch<TO, BITS, 8>(data, scale, out, slots, n, planes, c, d,
                                  slot_stride, st);
    case 4:
      return launch<TO, BITS, 4>(data, scale, out, slots, n, planes, c, d,
                                  slot_stride, st);
    case 2:
      return launch<TO, BITS, 2>(data, scale, out, slots, n, planes, c, d,
                                  slot_stride, st);
    case 1:
      return launch<TO, BITS, 1>(data, scale, out, slots, n, planes, c, d,
                                  slot_stride, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TO>
static int launch_bits(const int8_t* data, const float* scale, TO* out,
                       const long long* slots, int n, int planes, int c,
                       int d, int bits, long long slot_stride, int width,
                       cudaStream_t st) {
  if (bits == 4)
    return launch_width<TO, 4>(data, scale, out, slots, n, planes, c, d,
                               slot_stride, width, st);
  return launch_width<TO, 8>(data, scale, out, slots, n, planes, c, d,
                             slot_stride, width, st);
}

static bool misaligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

// data: (planes·n, c, dp) int8, plane-major (the K planes of the n chunks,
// then the V planes), dp = d (int8) or d/2 (packed int4); scale:
// (planes·n, d) f32; slots: (n,) int64 on the device, or nullptr for the
// identity.  Writes chunk i's plane p to
// out[slots[i]·slot_stride + p·c·d + (c, d)] in out_dtype (LEOAM_F16 |
// LEOAM_BF16 | LEOAM_F32).  width: payload bytes a thread loads at once
// (8, 4, 2 or 1); refused unless its unit is one store of at most 16
// bytes and dp and every pointer allow it.
extern "C" int leoam_kv_dequant_scatter(const void* data, const void* scale,
                                        void* out, const void* slots, int n,
                                        int planes, int c, int d, int bits,
                                        int out_dtype, long long slot_stride,
                                        int width, void* stream) {
  if (n == 0 || c == 0) return 0;
  const int e = bits == 4 ? 2 : 1;
  const int osize = out_dtype == LEOAM_F32 ? 4 : 2;
  const int ounit = width * e * osize;             // the unit's one store
  const int sunit = width * e % 4 == 0 ? 16 : 4;    // its scale loads
  if ((bits != 4 && bits != 8) || d % e != 0 || n < 0 || planes <= 0 ||
      width <= 0 || (d / e) % width != 0 || misaligned(data, width) ||
      (width > 1 && (misaligned(scale, sunit) || misaligned(out, ounit))) ||
      slot_stride % d != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* dp = static_cast<const int8_t*>(data);
  const float* sp = static_cast<const float*>(scale);
  const long long* sl = static_cast<const long long*>(slots);
  int rc;
  switch (out_dtype) {
    case LEOAM_F16:
      rc = launch_bits(dp, sp, static_cast<__half*>(out), sl, n, planes, c,
                       d, bits, slot_stride, width, st);
      break;
    case LEOAM_BF16:
      rc = launch_bits(dp, sp, static_cast<__nv_bfloat16*>(out), sl, n,
                       planes, c, d, bits, slot_stride, width, st);
      break;
    case LEOAM_F32:
      rc = launch_bits(dp, sp, static_cast<float*>(out), sl, n, planes, c,
                       d, bits, slot_stride, width, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return rc ? rc : (int)cudaGetLastError();
}
