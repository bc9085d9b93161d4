// Softmax-free (linear) attention (Eq. 1 of the paper), for sm_90a: the
// state-carrying hop of the deployed graph and the non-causal form of the
// training graph's sub-band stage.
//
// Replaces two TPU kernels of src/repro/kernels/linear_attention/kernel.py:
//
//   _step_kernel / linear_attention_step_pallas, for each (b, h):
//     new_kv = kv + sum_l k[l]^T v[l]      (D x D, fp32)
//     out[l] = q[l] @ new_kv               (unnormalized; the caller divides)
//
//   _noncausal_kernel / linear_attention_pallas, for each (b, h):
//     out[l] = q[l] @ (sum_l k[l]^T v[l]) * (1 / L)
//
// What bounds them on the card: at the paths' shapes (BH = 16 or 16 x 62,
// L = 128, D = 8) one call reads ~100 KB to ~6 MB and does 4 L D^2 FLOPs per
// (b, h); the launch bounds the hop's calls, bytes the offline ones. One
// block per (b, h) pair replaces the Pallas grid's sequential length axis:
// the (D, D) state never leaves the block. Keys and values are staged
// through shared memory in chunks of kChunk rows, and each of the D*D state
// entries is owned by one thread that sums over l in order, so there are no
// atomics and no cross-block reduction, the sum order is fixed, and results
// are deterministic. Any L is accepted: the Pallas wrapper's zero padding to
// a block multiple and its renormalisation are not needed. D*D must not
// exceed the block's thread count.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;

// Phase 1: thread e = i*D + j < D*D returns acc + sum_l k[l][i] * v[l][j],
// summed in order of l. Every thread of the block must call it.
__device__ float accumulate_ktv(const float* __restrict__ kb, const float* __restrict__ vb,
                                float* kc, float* vc, int L, int D, float acc) {
  const int e = threadIdx.x;
  const bool owner = e < D * D;
  const int i = owner ? e / D : 0;
  const int j = owner ? e - i * D : 0;
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
  return acc;
}

// Phase 2: out[l][j] = scale * sum_i q[l][i] * state[i][j], after the block
// has written state to shared memory and synchronised.
__device__ void apply_state(const float* __restrict__ qb, const float* state,
                            float* __restrict__ ob, int L, int D, float scale) {
  for (int t = threadIdx.x; t < L * D; t += blockDim.x) {
    const int l = t / D;
    const int jj = t - l * D;
    const float* qr = qb + (size_t)l * D;
    float o = 0.0f;
    for (int ii = 0; ii < D; ++ii) o = fmaf(qr[ii], state[ii * D + jj], o);
    ob[t] = o * scale;
  }
}

__global__ void linear_attention_step_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ kv,
    float* __restrict__ out, float* __restrict__ kv_out, int L, int D) {
  extern __shared__ float smem[];
  float* state = smem;              // (D, D)
  float* kc = smem + D * D;         // (kChunk, D)
  float* vc = kc + kChunk * D;      // (kChunk, D)

  const size_t bh = blockIdx.x;
  const int e = threadIdx.x;
  const bool owner = e < D * D;
  float acc = owner ? kv[bh * D * D + e] : 0.0f;
  acc = accumulate_ktv(k + bh * L * D, v + bh * L * D, kc, vc, L, D, acc);
  if (owner) {
    state[e] = acc;
    kv_out[bh * D * D + e] = acc;
  }
  __syncthreads();
  apply_state(q + bh * L * D, state, out + bh * L * D, L, D, 1.0f);
}

__global__ void linear_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int L, int D, float inv_len) {
  extern __shared__ float smem[];
  float* state = smem;              // (D, D)
  float* kc = smem + D * D;         // (kChunk, D)
  float* vc = kc + kChunk * D;      // (kChunk, D)

  const size_t bh = blockIdx.x;
  const float acc = accumulate_ktv(k + bh * L * D, v + bh * L * D, kc, vc, L, D, 0.0f);
  if (threadIdx.x < D * D) state[threadIdx.x] = acc;
  __syncthreads();
  apply_state(q + bh * L * D, state, out + bh * L * D, L, D, inv_len);
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * D + 2 * (size_t)kChunk * D);
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
  linear_attention_step_kernel<<<BH, kThreads, smem_bytes(D), (cudaStream_t)stream>>>(
      q, k, v, kv, out, kv_out, L, D);
  return (int)cudaGetLastError();
}

extern "C" int linear_attention_launch(
    const float* q, const float* k, const float* v, float* out, int BH, int L, int D,
    void* stream) {
  linear_attention_kernel<<<BH, kThreads, smem_bytes(D), (cudaStream_t)stream>>>(
      q, k, v, out, L, D, 1.0f / (float)L);
  return (int)cudaGetLastError();
}
