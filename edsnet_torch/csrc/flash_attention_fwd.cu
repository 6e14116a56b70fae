// Masked flash-attention forward for Hopper (sm_90a), f32 end to end.
//
// Replaces the Pallas TPU kernel `_flash_kernel` launched by `_flash_forward`
// in edsnet_tpu/kernels/flash_attention.py.  Same function: scores
// (q * D^-1/2) k^T, key mask with three levels (1 attend, 0 real-but-masked
// scored -1e30, -1 time-axis pad scored -2e30), online softmax over key
// tiles, outputs out = P v / l and the row statistics (m, l) as a pair, with
// l floored at 1e-30.  A fully-masked row therefore averages uniformly over
// its real keys only.
//
// Bound on this card: 4*N^2*D FLOPs per (batch*head) against 4*(4*N*D + 3*N)
// bytes, so at N = 2304, D = 128 the kernel is bound by operations (about
// 570 FLOPs per byte).  This first version runs them as f32 FMAs, not on the
// tensor cores, so its ceiling is the 67 TFLOP/s f32 rate.  The design keeps
// the [N, N] score matrix out of device memory and feeds the FMAs from
// shared memory with a 4x4 register tile per thread:
//   - one thread block per (bh, 64-row q tile); a loop over 64-key tiles
//     inside the block takes the place of the TPU's sequential k grid axis;
//   - q (pre-scaled), k, v and the probability tile live in dynamic shared
//     memory (113 KB at D = 128), q/k rows padded by one float so the
//     16 x 16 thread grid reads them without bank conflicts;
//   - the running max, denominator and the 64 x D accumulator stay in
//     registers; row reductions are half-warp shuffles.
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per inner tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr float NEG = -1e30f;
constexpr float NEG2 = -2e30f;

template <int D>
struct Layout {
  static constexpr int LDQ = D + 1;
  static constexpr int LDK = D + 1;
  static constexpr int LDV = D;
  static constexpr int LDP = BK + 1;
  static constexpr size_t kFloats =
      BQ * LDQ + BK * LDK + BK * LDV + BQ * LDP;
  static constexpr size_t kBytes = kFloats * sizeof(float) + BK * sizeof(int);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int n, float scale) {
  using L = Layout<D>;
  constexpr int DC = D / 16;  // accumulator columns per thread

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * L::LDQ;
  float* vs = ks + BK * L::LDK;
  float* ps = vs + BK * L::LDV;
  int* ms = reinterpret_cast<int*>(ps + BQ * L::LDP);

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key column / accumulator column group
  const int ty = tid / 16;  // query row group
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = static_cast<size_t>(bh) * n * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    qs[r * L::LDQ + c] = q[base + static_cast<size_t>(q0 + r) * D + c] * scale;
  }

  float acc[4][DC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_i[a] = NEG;
    l_i[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile's ks/vs/ps reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const size_t g = base + static_cast<size_t>(k0 + r) * D + c;
      ks[r * L::LDK + c] = k[g];
      vs[r * L::LDV + c] = v[g];
    }
    if (tid < BK) ms[tid] = mask[static_cast<size_t>(bh) * n + k0 + tid];
    __syncthreads();

    // s = (q * scale) k^T for rows ty + 16a, keys tx + 16b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * L::LDQ + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = ks[(tx + 16 * b) * L::LDK + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int km = ms[tx + 16 * b];
      if (km <= 0) {
        const float fill = km == 0 ? NEG : NEG2;
#pragma unroll
        for (int a = 0; a < 4; ++a) s[a][b] = fill;
      }
    }

    // online softmax; a row's 64 keys live in the 16 lanes sharing ty
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[a], mx);
      const float alpha = expf(m_i[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] - m_new);
        ps[(ty + 16 * a) * L::LDP + tx + 16 * b] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[a] = l_i[a] * alpha + rs;
      m_i[a] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

    // acc += P v for rows ty + 16a, columns tx + 16c
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ps[(ty + 16 * a) * L::LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = vs[j * L::LDV + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pa[a], vv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty + 16 * a;
    const float l = fmaxf(l_i[a], 1e-30f);
    float* o = out + base + static_cast<size_t>(r) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = acc[a][c] / l;
    if (tx == 0) {
      m_out[static_cast<size_t>(bh) * n + r] = m_i[a];
      l_out[static_cast<size_t>(bh) * n + r] = l;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* mask, float* out, float* m, float* l, int bh,
                   int n, float scale, cudaStream_t stream) {
  const size_t bytes = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(n / BQ, bh);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(q, k, v, mask, out, m,
                                                        l, n, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: [bh, n, d] f32 contiguous; mask: [bh, n] int32;
// m, l: [bh, n] f32.  n must be a multiple of 64 and d one of 32, 64, 128.
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int edsnet_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* mask,
                                          void* out, void* m, void* l, int bh,
                                          int n, int d, float scale,
                                          void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % BQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mi = static_cast<const int*>(mask);
  auto* of = static_cast<float*>(out);
  auto* mf = static_cast<float*>(m);
  auto* lf = static_cast<float*>(l);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(qf, kf, vf, mi, of, mf, lf, bh, n, scale, s);
    case 64:
      return launch<64>(qf, kf, vf, mi, of, mf, lf, bh, n, scale, s);
    case 128:
      return launch<128>(qf, kf, vf, mi, of, mf, lf, bh, n, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
