// State-carrying softmax-free attention hop (Eq. 1 of the paper), for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/linear_attention/kernel.py
// (_step_kernel / linear_attention_step_pallas). For each (b, h):
//
//   new_kv = kv + sum_l k[l]^T v[l]      (D x D, fp32)
//   out[l] = q[l] @ new_kv               (unnormalized; the caller divides)
//
// What bounds it on the card: at the main path's shapes (B=8, H=2, L=128,
// D=8) one call reads ~100 KB and does ~0.5 MFLOP, far under a microsecond
// of either; the launch is the bound. One block per (b, h) pair replaces the
// Pallas grid's sequential length axis: the (D, D) state never leaves the
// block. Keys and values are staged through shared memory in chunks of
// kChunk rows, and each of the D*D state entries is owned by one thread that
// sums over l in order, so there are no atomics and no cross-block
// reduction, the sum order is fixed, and results are deterministic. Any L is
// accepted: the Pallas wrapper's zero padding to a block multiple is not
// needed. D*D must not exceed the block's thread count.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;

__global__ void linear_attention_step_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ kv,
    float* __restrict__ out, float* __restrict__ kv_out, int L, int D) {
  extern __shared__ float smem[];
  float* state = smem;              // (D, D)
  float* kc = smem + D * D;         // (kChunk, D)
  float* vc = kc + kChunk * D;      // (kChunk, D)

  const size_t bh = blockIdx.x;
  const float* qb = q + bh * L * D;
  const float* kb = k + bh * L * D;
  const float* vb = v + bh * L * D;
  float* ob = out + bh * L * D;

  const int e = threadIdx.x;
  const bool owner = e < D * D;
  const int i = owner ? e / D : 0;
  const int j = owner ? e - i * D : 0;
  float acc = owner ? kv[bh * D * D + e] : 0.0f;

  for (int l0 = 0; l0 < L; l0 += kChunk) {
    const int rows = min(kChunk, L - l0);
    __syncthreads();  // the previous chunk has been consumed
    for (int t = threadIdx.x; t < rows * D; t += blockDim.x) {
      kc[t] = kb[(size_t)l0 * D + t];
      vc[t] = vb[(size_t)l0 * D + t];
    }
    __syncthreads();
    if (owner) {
      for (int l = 0; l < rows; ++l) acc = fmaf(kc[l * D + i], vc[l * D + j], acc);
    }
  }
  if (owner) {
    state[e] = acc;
    kv_out[bh * D * D + e] = acc;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < L * D; t += blockDim.x) {
    const int l = t / D;
    const int jj = t - l * D;
    const float* qr = qb + (size_t)l * D;
    float o = 0.0f;
    for (int ii = 0; ii < D; ++ii) o = fmaf(qr[ii], state[ii * D + jj], o);
    ob[t] = o;
  }
}

}  // namespace

extern "C" int linear_attention_step_max_dim() {
  int d = 1;
  while ((d + 1) * (d + 1) <= kThreads) ++d;
  return d;
}

extern "C" int linear_attention_step_launch(
    const float* q, const float* k, const float* v, const float* kv,
    float* out, float* kv_out, int BH, int L, int D, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)D * D + 2 * (size_t)kChunk * D);
  linear_attention_step_kernel<<<BH, kThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, kv, out, kv_out, L, D);
  return (int)cudaGetLastError();
}
