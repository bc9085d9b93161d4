// Minifloat (FP10 = s1/e5/m4 by default) quantize-dequantize, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/fp10/kernel.py (_quant_kernel /
// fp10_quantize_pallas). Each element is rounded to the nearest value of the
// s1/e<exp_bits>/m<man_bits> grid, round-half-even, with subnormals at the
// bottom and saturation at the largest finite value (no inf/nan codes).
//
// Rounding is exact on the grid, as the port's plain version
// (kernels/fp10/ops.py) rounds, so the two agree bit for bit:
//   - the exponent comes from frexpf (exact, subnormal inputs included);
//   - the step 2**(e - man_bits) is built with ldexpf, which is exact, never
//     with exp2f/log2f (the reference's jnp.exp2 is off the grid for some
//     negative exponents on XLA CPU, ROADMAP C1);
//   - rintf rounds half to even; mag / step and r * step are exact, since the
//     step is a power of two (built without --use_fast_math: IEEE division,
//     subnormals kept).
// NaN stays NaN: saturation is a comparison that is false for NaN, where
// fminf(NaN, max) would return max and turn a poisoned sample into a finite
// one. +-inf saturate to +-max; +-0 give +0, as sign(x) * q does.
//
// What bounds it on the card: one read and one write of 4 bytes per element
// and a few dozen instructions; at the path's sizes (8 x 257 x 2 per
// rounding) the launch is the bound. One thread per element with a grid
// stride over a contiguous flat buffer of any length.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks per SM of an H100 SXM

__global__ void fp10_quantize_kernel(const float* __restrict__ x, float* __restrict__ y,
                                     long long n, int min_exp, int max_exp, int man_bits,
                                     float max_val) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = x[i];
    const float mag = fabsf(v);
    int p = 0;
    frexpf(mag, &p);  // mag = m * 2**p, m in [0.5, 1): floor(log2(mag)) = p - 1
    const int e = min(max(p - 1, min_exp), max_exp);
    const float step = ldexpf(1.0f, e - man_bits);
    float q = rintf(mag / step) * step;
    if (q > max_val) q = max_val;  // false for NaN: NaN stays NaN
    if (mag == 0.0f) q = 0.0f;
    const float s = (float)((v > 0.0f) - (v < 0.0f));  // torch.sign, 0 for NaN
    y[i] = s * q;
  }
}

}  // namespace

extern "C" int fp10_quantize_launch(const float* x, float* y, long long n, int min_exp,
                                    int max_exp, int man_bits, float max_val, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  fp10_quantize_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, y, n, min_exp, max_exp, man_bits, max_val);
  return (int)cudaGetLastError();
}
