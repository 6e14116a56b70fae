// Yardsticks for the flash-attention forward, timed by chip_smoke.py beside
// the kernels of edsnet_torch/csrc/flash_attention_fwd.cu; the port never
// launches them.
//
// - edsnet_flash_attention_fwd_previous: the wide head dims as the port ran
//   them before flash_fwd_cluster_kernel took them.  Head dim 256 is
//   flash_fwd_kernel<256> (one block per q tile, 195 KB of shared memory,
//   one block per SM); head dim 512 is flash_fwd_split_kernel below (O's
//   columns split over blockIdx.z into two slices of 256, each block
//   recomputing S = q k^T over all 512 columns with the whole 64 x 512 q
//   tile resident, 166 KB, one block per SM: 1.5x the operations of the
//   bound).  Same arguments as edsnet_flash_attention_fwd.
// - edsnet_tf32_mma_rate: mma.sync.m16n8k8 TF32 products on registers
//   only, eight independent accumulators a warp, to read the card's own
//   rate for the instruction the kernels are built on.
//
// Built like the port's sources (edsnet_torch/kernels/build.py, with
// edsnet_torch/csrc on the include path).
#include "flash_attention_fwd.cu"

namespace {

template <int D, int DS>
struct SplitLayout {
  static constexpr int CH = 128;     // columns of a streamed chunk
  static constexpr int LDQ = D + 4;  // padded row strides, floats
  static constexpr int LDC = CH + 4;
  static constexpr int KC = D / CH;  // k chunks of a key tile, then
  static constexpr int VC = DS / CH; // the v chunks of the block's slice
  static constexpr int kQ = BQ * LDQ;
  static constexpr int kChunk = BK * LDC;
  static constexpr size_t kBytes =
      (kQ + STAGES * kChunk) * sizeof(float) + STAGES * BK * sizeof(int);
  static_assert(D % DS == 0 && DS % CH == 0, "slices of whole chunks");
  // chunk i of a key tile sits in ring slot i % STAGES whatever the tile
  static_assert((KC + VC) % STAGES == 0, "whole key tiles per ring turn");
};

template <int D, int DS, int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ mask, float* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       int n, float scale) {
  using L = SplitLayout<D, DS>;
  constexpr int NT = BK / 8;      // 8-key column tiles of S
  constexpr int CT = L::CH / 8;   // 8-wide steps of a chunk
  constexpr int DT = DS / 8;      // 8-wide column tiles of the O slice

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ring = qs + L::kQ;
  int* ms = reinterpret_cast<int*>(ring + STAGES * L::kChunk);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int col0 = blockIdx.z * DS;  // the block's slice of O's columns
  const size_t base = static_cast<size_t>(bh) * n * D;
  const size_t row_base = static_cast<size_t>(bh) * n;
  const int n_tiles = n / BK;

  // chunk i of key tile j into ring slot i % STAGES: k's columns
  // [i CH, (i + 1) CH) for i < KC, then v's columns of the slice; the
  // first chunk brings the tile's mask into mask slot j % STAGES
  auto load_chunk = [&](int j, int i) {
    const size_t at = base + static_cast<size_t>(j) * BK * D;
    const float* src = i < L::KC ? k + at + i * L::CH
                                 : v + at + col0 + (i - L::KC) * L::CH;
    tf32::copy_tile<L::CH, THREADS>(ring + (i % STAGES) * L::kChunk, L::LDC,
                                    src, D, BK, tid);
    if (i == 0 && tid < BK / 4)
      tf32::cp_async16(ms + (j % STAGES) * BK + 4 * tid,
                       mask + row_base + j * BK + 4 * tid);
  };
  // wait for chunk i of tile j with the next chunk in flight; the caller
  // ends its use of the chunk with __syncthreads()
  auto next_chunk = [&](int j, int i) -> const float* {
    if (i + 1 < L::KC + L::VC)
      load_chunk(j, i + 1);
    else if (j + 1 < n_tiles)
      load_chunk(j + 1, 0);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();
    __syncthreads();
    return ring + (i % STAGES) * L::kChunk;
  };

  tf32::copy_rows<D, THREADS>(qs, L::LDQ, q + base + static_cast<size_t>(q0) * D,
                              BQ, tid);
  load_chunk(0, 0);
  tf32::cp_async_commit();

  // rows g (h = 0) and g + 8 (h = 1) of the warp's 16
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  const float* qw = qs + warp * 16 * L::LDQ;

  for (int j = 0; j < n_tiles; ++j) {
    // S = q k^T over all D columns, one k chunk at a time
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int c = 0; c < L::KC; ++c) {
      const float* ks = next_chunk(j, c);
#pragma unroll 4
      for (int kk = 0; kk < CT; ++kk) {
        const auto a =
            tf32::load_a<PASSES>(qw + c * L::CH + 8 * kk, L::LDQ, g, t);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          tf32::mma<PASSES>(s[nt], a,
                            tf32::load_bt<PASSES>(ks + 8 * nt * L::LDC + 8 * kk,
                                                  L::LDC, g, t));
      }
      __syncthreads();  // a later chunk overwrites this slot
    }

    // scale, mask and online softmax, as flash_fwd_kernel
    const int* mk = ms + (j % STAGES) * BK;
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

    // O slice += P v slice, one v chunk at a time, P from the accumulator
#pragma unroll
    for (int c = 0; c < L::VC; ++c) {
      const float* vs = next_chunk(j, L::KC + c);
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const auto a = tf32::acc_as_a<PASSES>(s[kk]);
        const float* vk = vs + 8 * kk * L::LDC;
#pragma unroll
        for (int dt = 0; dt < CT; ++dt)
          tf32::mma<PASSES>(o[c * CT + dt], a,
                            tf32::load_b_renamed<PASSES>(vk + 8 * dt, L::LDC,
                                                         g, t));
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    const float l = l_r[h] < 1e-30f ? 1e-30f : l_r[h];  // NaN stays NaN
    float* orow = out + base + static_cast<size_t>(r) * D + col0;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(orow + 8 * dt + 2 * t) =
          make_float2(o[dt][2 * h] / l, o[dt][2 * h + 1] / l);
    if (blockIdx.z == 0 && t == 0) {
      m_out[row_base + r] = m_r[h];
      l_out[row_base + r] = l;
    }
  }
}

template <int D, int DS, int PASSES>
cudaError_t launch_split(const float* q, const float* k, const float* v,
                         const int* mask, float* out, float* m, float* l,
                         int bh, int n, float scale, cudaStream_t stream) {
  const size_t bytes = SplitLayout<D, DS>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_split_kernel<D, DS, PASSES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(n / BQ, bh, D / DS);
  flash_fwd_split_kernel<D, DS, PASSES><<<grid, THREADS, bytes, stream>>>(
      q, k, v, mask, out, m, l, n, scale);
  return cudaGetLastError();
}

template <int PASSES>
cudaError_t launch_previous(int d, const float* q, const float* k,
                            const float* v, const int* mask, float* out,
                            float* m, float* l, int bh, int n, float scale,
                            cudaStream_t stream) {
  switch (d) {
    case 256:
      return launch<256, PASSES>(q, k, v, mask, out, m, l, bh, n, scale,
                                 stream);
    case 512:
      return launch_split<512, 256, PASSES>(q, k, v, mask, out, m, l, bh, n,
                                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int PASSES>
cudaError_t occupancy_previous(int d, int* info) {
  switch (d) {
    case 256:
      return occupancy(flash_fwd_kernel<256, PASSES>, Layout<256>::kBytes,
                       false, info);
    case 512:
      return occupancy(flash_fwd_split_kernel<512, 256, PASSES>,
                       SplitLayout<512, 256>::kBytes, false, info);
    default:
      return cudaErrorInvalidValue;
  }
}

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

// The superseded wide-head kernels: d 256 or 512, passes 1 or 3, the
// arguments and checks of edsnet_flash_attention_fwd.
extern "C" int edsnet_flash_attention_fwd_previous(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    void* m, void* l, int bh, int n, int d, int passes, float scale,
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
      return launch_previous<1>(d, qf, kf, vf, mi, of, mf, lf, bh, n, scale, s);
    case 3:
      return launch_previous<3>(d, qf, kf, vf, mi, of, mf, lf, bh, n, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// info as edsnet_flash_attention_fwd_occupancy gives it, for the
// superseded kernel of head dim d.
extern "C" int edsnet_flash_attention_fwd_previous_occupancy(int d, int passes,
                                                             int* info) {
  switch (passes) {
    case 1:
      return occupancy_previous<1>(d, info);
    case 3:
      return occupancy_previous<3>(d, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
