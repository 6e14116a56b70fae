// Masked flash-attention forward for Hopper (sm_90a) on the TF32 tensor
// cores, f32 in and out.
//
// Replaces the Pallas TPU kernel `_flash_kernel` launched by `_flash_forward`
// in edsnet_tpu/kernels/flash_attention.py.  Same function: scores
// (q * D^-1/2) k^T, key mask with three levels (1 attend, 0 real-but-masked
// scored -1e30, -1 time-axis pad scored -2e30), online softmax over key
// tiles, outputs out = P v / l and the row statistics (m, l) as a pair, with
// l floored at 1e-30.  A fully-masked row therefore averages uniformly over
// its real keys only.
//
// Bound on this card: 4*N^2*D operations per (batch*head) against
// 4*(4*N*D + 3*N) bytes.  At N = 2304, D = 128 that is about 570 operations
// a byte, so the tensor cores bound it: PASSES TF32 products of each of the
// two matrix products, at 495 TFLOP/s dense TF32, 0.527 ms at 3 passes
// (precision "highest") and 0.176 ms at 1 pass ("default") for
// (BH, N, D) = (32, 2304, 128).
//
// Design (csrc/tf32_mma.cuh holds the products and the copies):
//   - one block of 4 warps per (bh, 64-row q tile); each warp owns 16 query
//     rows.  S (16 x 32 keys) and the output O (16 x D) stay in mma.sync
//     accumulator registers, and a loop over 32-key tiles inside the block
//     takes the place of the TPU's sequential k grid axis;
//   - P = exp(S - m) goes from the S accumulator straight into the A
//     fragment of P V under a renamed k index, so no P tile touches shared
//     memory; row max and sum are two quad shuffles (xor 1, 2);
//   - the mask fill and the scale act on the S accumulator, element by
//     element, by each element's key column;
//   - K/V tiles and their mask stream into shared memory with 16-byte
//     cp.async.cg in two stages: tile j + 1 is in flight while tile j is
//     multiplied.  Rows are padded to D + 4 floats, so every fragment load
//     of a warp touches 32 distinct banks;
//   - shared memory at D = 128: q 33.8 KB plus two stages of k and v
//     (67.6 KB), about 102 KB, so two blocks (8 warps) run on each SM.
// Why mma.sync and not wgmma: wgmma's TF32 form reads both operands K-major
// from shared memory, and P V is not K-major in V; a transposed copy of V,
// and at 3 passes a residual copy of every operand, would not fit beside
// the tiles.  mma.sync takes its fragments from registers, so every tile is
// stored once as plain f32 and the TF32 split happens in registers.
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int BK = 32;          // keys per tile
constexpr int STAGES = 2;
constexpr float NEG = -1e30f;
constexpr float NEG2 = -2e30f;

template <int D>
struct Layout {
  static constexpr int LD = D + 4;        // padded row stride, floats
  static constexpr int kQ = BQ * LD;
  static constexpr int kKV = BK * LD;     // one k or v tile
  static constexpr size_t kBytes =
      (kQ + STAGES * 2 * kKV) * sizeof(float) + STAGES * BK * sizeof(int);
};

template <int D, int PASSES>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int n, float scale) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  constexpr int NT = BK / 8;  // 8-key column tiles of S
  constexpr int DT = D / 8;   // 8-wide column tiles of O, k steps of S

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* kvs = qs + L::kQ;  // stage s: k at kvs + 2 s kKV, v after it
  int* ms = reinterpret_cast<int*>(kvs + STAGES * 2 * L::kKV);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = static_cast<size_t>(bh) * n * D;
  const size_t row_base = static_cast<size_t>(bh) * n;

  auto load_kv = [&](int stage, int k0) {
    float* ks = kvs + stage * 2 * L::kKV;
    const size_t at = base + static_cast<size_t>(k0) * D;
    tf32::copy_rows<D, THREADS>(ks, LD, k + at, BK, tid);
    tf32::copy_rows<D, THREADS>(ks + L::kKV, LD, v + at, BK, tid);
    if (tid < BK / 4)
      tf32::cp_async16(ms + stage * BK + 4 * tid, mask + row_base + k0 + 4 * tid);
  };
  tf32::copy_rows<D, THREADS>(qs, LD, q + base + static_cast<size_t>(q0) * D,
                              BQ, tid);
  load_kv(0, 0);
  tf32::cp_async_commit();

  // rows g (h = 0) and g + 8 (h = 1) of the warp's 16
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  const float* qw = qs + warp * 16 * LD;

  const int n_tiles = n / BK;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv((j + 1) % STAGES, (j + 1) * BK);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();  // tile j (and q) have landed
    __syncthreads();
    const float* ks = kvs + (j % STAGES) * 2 * L::kKV;
    const float* vs = ks + L::kKV;
    const int* mk = ms + (j % STAGES) * BK;

    // S = q k^T for the warp's 16 rows and the tile's BK keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DT; ++kk) {
      const auto a = tf32::load_a<PASSES>(qw + 8 * kk, LD, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        tf32::mma<PASSES>(
            s[nt], a, tf32::load_bt<PASSES>(ks + 8 * nt * LD + 8 * kk, LD, g, t));
    }

    // scale and mask by key column (element e: key 8 nt + 2t + (e & 1)),
    // then the online softmax for rows g and g + 8
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int km = mk[8 * nt + 2 * t + (e & 1)];
        s[nt][e] = km > 0 ? s[nt][e] * scale : (km == 0 ? NEG : NEG2);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = s[0][2 * h];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[h], mx);
      const float alpha = expf(m_r[h] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[nt][e] = expf(s[nt][e] - m_new);
          rs += s[nt][e];
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_r[h] = l_r[h] * alpha + rs;
      m_r[h] = m_new;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * h] *= alpha;
        o[dt][2 * h + 1] *= alpha;
      }
    }

    // O += P v, P straight from the S accumulator
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const auto a = tf32::acc_as_a<PASSES>(s[kk]);
      const float* vk = vs + 8 * kk * LD;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        tf32::mma<PASSES>(o[dt], a,
                          tf32::load_b_renamed<PASSES>(vk + 8 * dt, LD, g, t));
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    const float l = l_r[h] < 1e-30f ? 1e-30f : l_r[h];  // NaN stays NaN
    float* orow = out + base + static_cast<size_t>(r) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(orow + 8 * dt + 2 * t) =
          make_float2(o[dt][2 * h] / l, o[dt][2 * h + 1] / l);
    if (t == 0) {
      m_out[row_base + r] = m_r[h];
      l_out[row_base + r] = l;
    }
  }
}

template <int D, int PASSES>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* mask, float* out, float* m, float* l, int bh,
                   int n, float scale, cudaStream_t stream) {
  const size_t bytes = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(n / BQ, bh);
  flash_fwd_kernel<D, PASSES><<<grid, THREADS, bytes, stream>>>(
      q, k, v, mask, out, m, l, n, scale);
  return cudaGetLastError();
}

template <int PASSES>
cudaError_t launch_d(int d, const float* q, const float* k, const float* v,
                     const int* mask, float* out, float* m, float* l, int bh,
                     int n, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32, PASSES>(q, k, v, mask, out, m, l, bh, n, scale, stream);
    case 64:
      return launch<64, PASSES>(q, k, v, mask, out, m, l, bh, n, scale, stream);
    case 128:
      return launch<128, PASSES>(q, k, v, mask, out, m, l, bh, n, scale,
                                 stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [bh, n, d] f32 contiguous, 16-byte aligned; mask: [bh, n]
// int32; m, l: [bh, n] f32.  n must be a multiple of 64, d one of 32, 64,
// 128 and passes 1 or 3.  Launches on `stream` and returns the launch's
// cudaError_t (0 = success).
extern "C" int edsnet_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* mask,
                                          void* out, void* m, void* l, int bh,
                                          int n, int d, int passes, float scale,
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
  switch (passes) {
    case 1:
      return launch_d<1>(d, qf, kf, vf, mi, of, mf, lf, bh, n, scale, s);
    case 3:
      return launch_d<3>(d, qf, kf, vf, mi, of, mf, lf, bh, n, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
