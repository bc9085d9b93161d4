// Matmul over a pruned weight with run-time strip skipping, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/masked_mac/kernel.py
// (_kernel / masked_matmul_pallas):
//
//   out = x (M, K) @ w (K, N) + b (N,)   with fp32 accumulation,
//
// skipping every block_k-row input strip of w whose weights are all zero
// (the TPU kernel's lax.cond on jnp.any(wb != 0), lines 34-42).
//
// What bounds it on the card: at the main path's shapes (M = B*128 = 1024,
// K, N <= 32) one call moves ~0.3 MB and does ~2 MFLOP, under a microsecond
// of either; the launch is the bound. One block per kTileM rows of x: the
// whole w (<= 32 x 32 on this path) sits in shared memory beside one
// "strip is live" flag per block_k rows, computed once per block, and the
// x tile is staged with coalesced loads. One thread per output element runs
// the k loop over live strips only, in a fixed order with no atomics, so
// results are deterministic. Any M and K are accepted: ragged tiles are
// masked, so the Pallas wrapper's padding is not needed.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 64;

__global__ void masked_matmul_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ out,
    int M, int K, int N, int block_k) {
  extern __shared__ float smem[];
  const int n_strips = (K + block_k - 1) / block_k;
  float* ws = smem;                                     // (K, N)
  float* xs = ws + K * N;                               // (kTileM, K)
  int* live = reinterpret_cast<int*>(xs + kTileM * K);  // (n_strips,)

  const int m0 = blockIdx.x * kTileM;
  const int rows = min(kTileM, M - m0);
  for (int t = threadIdx.x; t < K * N; t += blockDim.x) ws[t] = w[t];
  for (int t = threadIdx.x; t < rows * K; t += blockDim.x) xs[t] = x[(size_t)m0 * K + t];
  __syncthreads();
  for (int s = threadIdx.x; s < n_strips; s += blockDim.x) {
    const int k1 = min(K, (s + 1) * block_k);
    int any = 0;
    for (int t = s * block_k * N; t < k1 * N; ++t) any |= (ws[t] != 0.0f);
    live[s] = any;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < rows * N; t += blockDim.x) {
    const int r = t / N;
    const int n = t - r * N;
    const float* xr = xs + r * K;
    float acc = 0.0f;
    for (int s = 0; s < n_strips; ++s) {
      if (!live[s]) continue;
      const int k1 = min(K, (s + 1) * block_k);
      for (int kk = s * block_k; kk < k1; ++kk) acc = fmaf(xr[kk], ws[kk * N + n], acc);
    }
    out[(size_t)(m0 + r) * N + n] = acc + b[n];
  }
}

}  // namespace

extern "C" int masked_matmul_smem_bytes(int K, int N, int block_k) {
  const int n_strips = (K + block_k - 1) / block_k;
  return (int)(sizeof(float) * (K * N + kTileM * K) + sizeof(int) * n_strips);
}

extern "C" int masked_matmul_launch(
    const float* x, const float* w, const float* b, float* out,
    int M, int K, int N, int block_k, void* stream) {
  const int grid = (M + kTileM - 1) / kTileM;
  const size_t smem = (size_t)masked_matmul_smem_bytes(K, N, block_k);
  masked_matmul_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w, b, out, M, K, N, block_k);
  return (int)cudaGetLastError();
}
