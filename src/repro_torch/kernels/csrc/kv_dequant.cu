// B3 — transit-codec dequantization (int8, or int4 packed lo | hi << 4).
//
// Replaces the Pallas kernel repro/kernels/kv_quant/kv_quant.py
// (_dequant_int8_kernel, _dequant_int4_kernel, kv_dequant_pallas): one grid
// step per chunk on the TPU's vector unit.
//
// What bounds it on the H100: bytes.  It reads 1 (int8) or 0.5 (int4)
// byte per output plus one f32 scale per channel per chunk, and writes 2
// bytes per output — no arithmetic worth counting (one multiply).
//
// Design: a grid-stride loop, one thread per payload byte (an int4 byte
// expands into two neighbouring outputs), so neighbouring threads touch
// neighbouring addresses for the payload, the scales and the output.  The
// product is __fmul_rn (never contracted) and the output cast is
// round-to-nearest-even, so the result is bitwise the plain version's
// (data.float() * scale).to(out dtype).  One launch may cover both K and V
// planes: the caller stacks the planes along N.
#include "common.cuh"

template <typename TO>
__global__ void dequant_int8_kernel(const int8_t* __restrict__ data,
                                    const float* __restrict__ scale,
                                    TO* __restrict__ out, long long total,
                                    long long cd, int d) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long n = i / cd;
    const int j = (int)(i % d);
    out[i] = from_f32<TO>(__fmul_rn((float)data[i], scale[n * d + j]));
  }
}

template <typename TO>
__global__ void dequant_int4_kernel(const int8_t* __restrict__ data,
                                    const float* __restrict__ scale,
                                    TO* __restrict__ out, long long total,
                                    long long chalf, int d) {
  const int half = d / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long n = i / chalf;
    const int jp = (int)(i % half);
    const unsigned u = (unsigned)(uint8_t)data[i];
    int lo = (int)(u & 0xFu);
    int hi = (int)((u >> 4) & 0xFu);
    lo = lo > 7 ? lo - 16 : lo;  // 4-bit two's complement
    hi = hi > 7 ? hi - 16 : hi;
    const float* s = scale + n * d + 2 * jp;
    out[2 * i] = from_f32<TO>(__fmul_rn((float)lo, s[0]));
    out[2 * i + 1] = from_f32<TO>(__fmul_rn((float)hi, s[1]));
  }
}

template <typename TO>
static void launch(const int8_t* data, const float* scale, TO* out, int N,
                   int c, int d, int bits, cudaStream_t st) {
  const int threads = 256;
  const long long total =
      bits == 4 ? (long long)N * c * (d / 2) : (long long)N * c * d;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  if (bits == 4)
    dequant_int4_kernel<TO><<<(int)blocks, threads, 0, st>>>(
        data, scale, out, total, (long long)c * (d / 2), d);
  else
    dequant_int8_kernel<TO><<<(int)blocks, threads, 0, st>>>(
        data, scale, out, total, (long long)c * d, d);
}

// data: (N, c, d) int8, or (N, c, d/2) packed int4; scale: (N, d) f32;
// out: (N, c, d) in out_dtype (LEOAM_F16 | LEOAM_BF16 | LEOAM_F32).
extern "C" int leoam_kv_dequant(const void* data, const void* scale,
                                void* out, int N, int c, int d, int bits,
                                int out_dtype, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* dp = static_cast<const int8_t*>(data);
  const float* sp = static_cast<const float*>(scale);
  switch (out_dtype) {
    case LEOAM_F16:
      launch(dp, sp, static_cast<__half*>(out), N, c, d, bits, st);
      break;
    case LEOAM_BF16:
      launch(dp, sp, static_cast<__nv_bfloat16*>(out), N, c, d, bits, st);
      break;
    case LEOAM_F32:
      launch(dp, sp, static_cast<float*>(out), N, c, d, bits, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
