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
// Head dim 256 (the deep anchor-free model's first attention at F 1024,
// 4 heads) is the same kernel: O takes 128 accumulator registers a thread,
// which still fits the 255 a thread may hold, and the tiles take 195 KB of
// the 227 KB a block may have, so one block (4 warps) runs on each SM.
// Bound at (BH, N, D) = (16, 2304, 256): 0.527 ms at 3 passes, 0.176 ms at
// 1, the same operations as (32, 2304, 128).
// Head dim 512 (the local attentions of the local-global heads at F 1024,
// 2 heads each) is a kernel of its own, flash_fwd_split_kernel: O's 512
// columns would take 256 accumulator registers a thread, and a 64 x 512 q
// tile alone is 128 KB.  So blockIdx.z picks a slice of DS = 256 of O's
// columns, and the two blocks of a q tile each:
//   - hold the whole q tile in shared memory (64 x 516 floats, 132 KB);
//   - recompute S = q k^T over all 512 columns, with k streamed through
//     shared memory in chunks of 32 keys x 128 columns;
//   - multiply P by their own 256 columns of v, streamed in chunks of the
//     same size.
// The chunks pass through a ring of two buffers (34 KB), one in flight
// while the other is multiplied; 166 KB in all, one block per SM.  S is
// computed twice per q tile, so the kernel does 1.5x the operations of the
// bound (4*N^2*D for each bh; 0.527 / 0.176 ms at (8, 2304, 512)).  Both
// slices compute the same m and l; only slice 0 writes them.
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

}  // namespace

// q, k, v, out: [bh, n, d] f32 contiguous, 16-byte aligned; mask: [bh, n]
// int32; m, l: [bh, n] f32.  n must be a multiple of 64, d one of 32, 64,
// 128, 256, 512 and passes 1 or 3.  Launches on `stream` and returns the launch's
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
