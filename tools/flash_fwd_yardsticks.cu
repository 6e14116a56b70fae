// A yardstick for the flash-attention kernels, timed by chip_smoke.py
// beside them; the port never launches it.
//
// - edsnet_tf32_mma_rate: mma.sync.m16n8k8 TF32 products on registers
//   only, eight independent accumulators a warp, to read the card's own
//   rate for the instruction the kernels are built on.
//
// Built like the port's sources (edsnet_torch/kernels/build.py, with
// edsnet_torch/csrc on the include path).
#include "tf32_mma.cuh"

namespace {

constexpr int RATE_CHAINS = 8;  // independent accumulators a warp

__global__ void __launch_bounds__(256)
tf32_mma_rate_kernel(float* __restrict__ out, int iters) {
  const uint32_t x = threadIdx.x;
  // TF32 values 1 + lane / 64 and 1 - lane / 64: finite sums for any count
  const uint32_t a[4] = {tf32::rna(1.f + x % 32 / 64.f),
                         tf32::rna(1.f - x % 32 / 64.f), tf32::rna(0.5f),
                         tf32::rna(0.25f)};
  const uint32_t b[2] = {tf32::rna(1e-6f), tf32::rna(-1e-6f)};
  float c[RATE_CHAINS][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int u = 0; u < RATE_CHAINS; ++u) tf32::mma(c[u], a, b);
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < RATE_CHAINS; ++u)
    sum += c[u][0] + c[u][1] + c[u][2] + c[u][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// `blocks` blocks of 256 threads, each warp issuing iters * 8 mma.sync
// m16n8k8 TF32 products (2048 operations each); out: blocks * 256 floats.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int edsnet_tf32_mma_rate(void* out, int blocks, int iters,
                                    void* stream) {
  if (blocks <= 0 || iters <= 0) return static_cast<int>(cudaErrorInvalidValue);
  tf32_mma_rate_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
