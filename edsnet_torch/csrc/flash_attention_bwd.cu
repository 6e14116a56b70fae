// Masked flash-attention backward for Hopper (sm_90a), f32 in and out: two
// kernels, one for dq and one for dk/dv, each output element with exactly
// one writer (no atomics) and a fixed loop order, so gradients are
// bit-identical from run to run.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` launched by
// `_flash_backward` in edsnet_tpu/kernels/flash_attention.py.  Same function:
// with s = (q * D^-1/2) k^T under the forward's three-level key mask (1
// attend, 0 real-but-masked scored -1e30, -1 time-axis pad scored -2e30),
//   P  = exp(s - m) / l        from the forward's stored (m, l) pair,
//   dP = g v^T,  dS = where(mask > 0, P * (dP - Dd), 0),  Dd = rowsum(g * o),
//   dq = dS k * scale,  dk = dS^T (q * scale),  dv = P^T g.
// dv keeps P on masked keys: a fully-masked row (m = -1e30) has P = 1/n over
// its real keys and 0 over pad keys, and feeds dv but not dk.
//
// Bound on this card: dq does 6*N^2*D operations per (batch*head) (q k^T,
// g v^T, dS k), dk/dv 8*N^2*D (k q^T, v g^T, P^T g, dS^T q), against
// 4*(5*N*D + 3*N) and 4*(7*N*D + 3*N) bytes; at N = 2304, D = 128 both are
// bound by operations.
//
// dq runs its products as f32 FMAs (ceiling 67 TFLOP/s): one block per
// (bh, 64-row q tile) loops over 64-key tiles, keeping the 64 x D
// accumulator in registers and feeding 4x4 register tiles from shared
// memory padded by one float (about 149 KB at D = 128).
//
// dk/dv runs all four products on the TF32 tensor cores (mma.sync
// m16n8k8, csrc/tf32_mma.cuh), at PASSES = 3 for precision "highest" and 1
// for "default": at (BH, N, D) = (32, 2304, 128) and 495 TFLOP/s dense
// TF32 that bounds it at 1.054 and 0.351 ms.  Design:
//   - one block of 4 warps per (bh, 64-key tile); each warp owns 16 keys and
//     keeps dk and dv (16 x D each) in accumulator registers while the block
//     loops over 16-row q tiles in a fixed order;
//   - per q tile each warp forms S^T = k q^T and dP^T = v g^T (16 keys x 16
//     rows), turns them into P^T and dS^T in registers from the rows' m, l
//     and Dd, and feeds both straight into dv += P^T g and dk += dS^T q as A
//     fragments under a renamed k index: no P or dS tile touches shared
//     memory;
//   - k and v stay in shared memory for the whole loop; q, g and the rows'
//     m, l, Dd stream in with 16-byte cp.async.cg in two stages, so tile
//     i + 1 is in flight while tile i is multiplied.  Rows are padded to
//     D + 4 floats, so every fragment load of a warp touches 32 distinct
//     banks;
//   - shared memory at D = 128: k and v 67.6 KB plus two stages of q, g
//     (33.8 KB) and the row statistics, about 102 KB, so two blocks (8
//     warps) run on each SM; the scale multiplies S^T and, at the end, dk.
// Why mma.sync and not wgmma: wgmma's TF32 form reads both operands K-major
// from shared memory; P^T g and dS^T q are not K-major in g and q, so they
// would need transposed copies, and 3 passes residual copies of every
// operand, beyond the shared memory a block can have.
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr float NEG = -1e30f;
constexpr float NEG2 = -2e30f;

__device__ __forceinline__ float masked_score(float s, int km) {
  return km > 0 ? s : (km == 0 ? NEG : NEG2);
}

template <int D>
struct DqLayout {
  static constexpr int LD = D + 1;   // q, g, k, v rows
  static constexpr int LDS = BK + 1; // dS tile rows
  static constexpr size_t kFloats = 4 * 64 * LD + BQ * LDS;
  static constexpr size_t kBytes = kFloats * sizeof(float) + BK * sizeof(int);
};

// dq for rows q0 .. q0+63 of one (batch*head).  Thread (ty, tx) owns rows
// ty + 16a and, in the score tile, keys tx + 16b; in the accumulator,
// columns tx + 16c.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ mask,
                const float* __restrict__ g, const float* __restrict__ m_in,
                const float* __restrict__ l_in, const float* __restrict__ dd_in,
                float* __restrict__ dq, int n, float scale) {
  using L = DqLayout<D>;
  constexpr int DC = D / 16;

  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = qs + BQ * L::LD;
  float* ks = gs + BQ * L::LD;
  float* vs = ks + BK * L::LD;
  float* dss = vs + BK * L::LD;
  int* ms = reinterpret_cast<int*>(dss + BQ * L::LDS);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = static_cast<size_t>(bh) * n * D;
  const size_t row_base = static_cast<size_t>(bh) * n;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const size_t gi = base + static_cast<size_t>(q0 + r) * D + c;
    qs[r * L::LD + c] = q[gi] * scale;
    gs[r * L::LD + c] = g[gi];
  }
  float m_r[4], l_r[4], dd_r[4], acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const size_t r = row_base + q0 + ty + 16 * a;
    m_r[a] = m_in[r];
    l_r[a] = l_in[r];
    dd_r[a] = dd_in[r];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile's ks/vs/dss reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const size_t gi = base + static_cast<size_t>(k0 + r) * D + c;
      ks[r * L::LD + c] = k[gi];
      vs[r * L::LD + c] = v[gi];
    }
    if (tid < BK) ms[tid] = mask[row_base + k0 + tid];
    __syncthreads();

    // s = (q * scale) k^T and dP = g v^T for rows ty + 16a, keys tx + 16b
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], ga[4], kb[4], vb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qa[a] = qs[(ty + 16 * a) * L::LD + d];
        ga[a] = gs[(ty + 16 * a) * L::LD + d];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        kb[b] = ks[(tx + 16 * b) * L::LD + d];
        vb[b] = vs[(tx + 16 * b) * L::LD + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
          dp[a][b] = fmaf(ga[a], vb[b], dp[a][b]);
        }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int km = ms[tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = expf(masked_score(s[a][b], km) - m_r[a]) / l_r[a];
        dss[(ty + 16 * a) * L::LDS + tx + 16 * b] =
            km > 0 ? p * (dp[a][b] - dd_r[a]) : 0.f;
      }
    }
    __syncthreads();

    // acc += dS k for rows ty + 16a, columns tx + 16c
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float da[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = dss[(ty + 16 * a) * L::LDS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kk = ks[j * L::LD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(da[a], kk, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float* o = dq + base + static_cast<size_t>(q0 + ty + 16 * a) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = acc[a][c] * scale;
  }
}

constexpr int DKV_WARPS = 4;
constexpr int DKV_THREADS = 32 * DKV_WARPS;
constexpr int DKV_BK = 16 * DKV_WARPS;  // keys per block, 16 per warp
constexpr int DKV_BQ = 16;              // q rows per tile
constexpr int DKV_STAGES = 2;

template <int D>
struct DkvLayout {
  static constexpr int LD = D + 4;          // padded row stride, floats
  static constexpr int kKV = DKV_BK * LD;   // the block's k or v rows
  static constexpr int kQG = DKV_BQ * LD;   // one q or g tile
  // one stage: q, g, then the rows' m, l and Dd
  static constexpr int kStage = 2 * kQG + 3 * DKV_BQ;
  static constexpr size_t kBytes =
      (2 * kKV + DKV_STAGES * kStage) * sizeof(float);
};

// dk, dv for keys k0 .. k0+63 of one (batch*head).  Warp w owns keys
// k0 + 16w + g and k0 + 16w + g + 8 (g = lane / 4); in its S^T and dP^T
// accumulators, element e of tile nt is q row 8 nt + 2t + (e & 1) of the
// current q tile (t = lane % 4).
template <int D, int PASSES>
__global__ void __launch_bounds__(DKV_THREADS, 2)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ mask,
                 const float* __restrict__ g, const float* __restrict__ m_in,
                 const float* __restrict__ l_in,
                 const float* __restrict__ dd_in, float* __restrict__ dk,
                 float* __restrict__ dv, int n, float scale) {
  using L = DkvLayout<D>;
  constexpr int LD = L::LD;
  constexpr int DT = D / 8;       // 8-wide column tiles of dk/dv
  constexpr int QT = DKV_BQ / 8;  // 8-row column tiles of S^T

  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + L::kKV;
  float* stages = vs + L::kKV;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * DKV_BK;
  const size_t base = static_cast<size_t>(bh) * n * D;
  const size_t row_base = static_cast<size_t>(bh) * n;

  auto load_q = [&](int stage, int i0) {
    float* qs = stages + stage * L::kStage;
    const size_t at = base + static_cast<size_t>(i0) * D;
    tf32::copy_rows<D, DKV_THREADS>(qs, LD, q + at, DKV_BQ, tid);
    tf32::copy_rows<D, DKV_THREADS>(qs + L::kQG, LD, g + at, DKV_BQ, tid);
    constexpr int kRowChunks = DKV_BQ / 4;  // 16-byte chunks per statistic
    if (tid < 3 * kRowChunks) {
      const int which = tid / kRowChunks, c = 4 * (tid % kRowChunks);
      const float* src = which == 0 ? m_in : (which == 1 ? l_in : dd_in);
      tf32::cp_async16(qs + 2 * L::kQG + which * DKV_BQ + c,
                       src + row_base + i0 + c);
    }
  };
  const size_t at = base + static_cast<size_t>(k0) * D;
  tf32::copy_rows<D, DKV_THREADS>(ks, LD, k + at, DKV_BK, tid);
  tf32::copy_rows<D, DKV_THREADS>(vs, LD, v + at, DKV_BK, tid);
  load_q(0, 0);
  tf32::cp_async_commit();

  const int key = k0 + warp * 16 + gq;
  const int km[2] = {mask[row_base + key], mask[row_base + key + 8]};
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  const float* kw = ks + warp * 16 * LD;
  const float* vw = vs + warp * 16 * LD;

  const int n_tiles = n / DKV_BQ;
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_q((i + 1) % DKV_STAGES, (i + 1) * DKV_BQ);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();  // tile i (and k, v) have landed
    __syncthreads();
    const float* qs = stages + (i % DKV_STAGES) * L::kStage;
    const float* gs = qs + L::kQG;
    const float* m_s = gs + L::kQG;
    const float* l_s = m_s + DKV_BQ;
    const float* dd_s = l_s + DKV_BQ;

    // S^T = k q^T and dP^T = v g^T for the warp's 16 keys, the tile's rows
    float st[QT][4], dpt[QT][4];
#pragma unroll
    for (int nt = 0; nt < QT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DT; ++kk) {
      const auto ak = tf32::load_a<PASSES>(kw + 8 * kk, LD, gq, t);
      const auto av = tf32::load_a<PASSES>(vw + 8 * kk, LD, gq, t);
#pragma unroll
      for (int nt = 0; nt < QT; ++nt) {
        const int off = 8 * nt * LD + 8 * kk;
        tf32::mma<PASSES>(st[nt], ak,
                          tf32::load_bt<PASSES>(qs + off, LD, gq, t));
        tf32::mma<PASSES>(dpt[nt], av,
                          tf32::load_bt<PASSES>(gs + off, LD, gq, t));
      }
    }

    // P^T and dS^T in place (element e: key row e >> 1, q row r)
#pragma unroll
    for (int nt = 0; nt < QT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * nt + 2 * t + (e & 1);
        const int kmask = km[e >> 1];
        const float s = kmask > 0 ? st[nt][e] * scale
                                  : (kmask == 0 ? NEG : NEG2);
        const float p = expf(s - m_s[r]) / l_s[r];
        st[nt][e] = p;
        dpt[nt][e] = kmask > 0 ? p * (dpt[nt][e] - dd_s[r]) : 0.f;
      }

    // dv += P^T g and dk += dS^T q, both A operands from the accumulators
#pragma unroll
    for (int kk = 0; kk < QT; ++kk) {
      const auto ap = tf32::acc_as_a<PASSES>(st[kk]);
      const auto ads = tf32::acc_as_a<PASSES>(dpt[kk]);
      const float* gk = gs + 8 * kk * LD;
      const float* qk = qs + 8 * kk * LD;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        tf32::mma<PASSES>(dv_acc[dt], ap, tf32::load_b_renamed<PASSES>(
                                              gk + 8 * dt, LD, gq, t));
        tf32::mma<PASSES>(dk_acc[dt], ads, tf32::load_b_renamed<PASSES>(
                                               qk + 8 * dt, LD, gq, t));
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t r = base + static_cast<size_t>(key + 8 * h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = 8 * dt + 2 * t;
      *reinterpret_cast<float2*>(dk + r + c) =
          make_float2(dk_acc[dt][2 * h] * scale, dk_acc[dt][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv + r + c) =
          make_float2(dv_acc[dt][2 * h], dv_acc[dt][2 * h + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const int* mask, const float* g, const float* m,
                      const float* l, const float* dd, float* dq, int bh,
                      int n, float scale, cudaStream_t stream) {
  const size_t bytes = DqLayout<D>::kBytes;
  cudaError_t err = allow_smem(flash_dq_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<D><<<dim3(n / BQ, bh), THREADS, bytes, stream>>>(
      q, k, v, mask, g, m, l, dd, dq, n, scale);
  return cudaGetLastError();
}

template <int D, int PASSES>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const int* mask, const float* g, const float* m,
                       const float* l, const float* dd, float* dk, float* dv,
                       int bh, int n, float scale, cudaStream_t stream) {
  const size_t bytes = DkvLayout<D>::kBytes;
  cudaError_t err = allow_smem(flash_dkv_kernel<D, PASSES>, bytes);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<D, PASSES>
      <<<dim3(n / DKV_BK, bh), DKV_THREADS, bytes, stream>>>(
          q, k, v, mask, g, m, l, dd, dk, dv, n, scale);
  return cudaGetLastError();
}

template <int PASSES>
cudaError_t launch_dkv_d(int d, const float* q, const float* k,
                         const float* v, const int* mask, const float* g,
                         const float* m, const float* l, const float* dd,
                         float* dk, float* dv, int bh, int n, float scale,
                         cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_dkv<32, PASSES>(q, k, v, mask, g, m, l, dd, dk, dv, bh, n,
                                    scale, stream);
    case 64:
      return launch_dkv<64, PASSES>(q, k, v, mask, g, m, l, dd, dk, dv, bh, n,
                                    scale, stream);
    case 128:
      return launch_dkv<128, PASSES>(q, k, v, mask, g, m, l, dd, dk, dv, bh,
                                     n, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_shape(int bh, int n) {
  return bh <= 0 || bh > 65535 || n <= 0 || n % BQ;
}

}  // namespace

// q, k, v, g, dq: [bh, n, d] f32 contiguous; mask: [bh, n] int32;
// m, l, dd: [bh, n] f32.  n must be a multiple of 64 and d one of 32, 64,
// 128.  Launches on `stream` and returns the launch's cudaError_t (0 =
// success).
extern "C" int edsnet_flash_attention_dq(const void* q, const void* k,
                                         const void* v, const void* mask,
                                         const void* g, const void* m,
                                         const void* l, const void* dd,
                                         void* dq, int bh, int n, int d,
                                         float scale, void* stream) {
  if (bad_shape(bh, n)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mi = static_cast<const int*>(mask);
  const auto* gf = static_cast<const float*>(g);
  const auto* mf = static_cast<const float*>(m);
  const auto* lf = static_cast<const float*>(l);
  const auto* df = static_cast<const float*>(dd);
  auto* out = static_cast<float*>(dq);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dq<32>(qf, kf, vf, mi, gf, mf, lf, df, out, bh, n, scale,
                           s);
    case 64:
      return launch_dq<64>(qf, kf, vf, mi, gf, mf, lf, df, out, bh, n, scale,
                           s);
    case 128:
      return launch_dq<128>(qf, kf, vf, mi, gf, mf, lf, df, out, bh, n, scale,
                            s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As above, with outputs dk, dv: [bh, n, d] f32, all [bh, n, d] and [bh, n]
// f32 tensors 16-byte aligned, and passes 1 or 3 (TF32 products per
// product).
extern "C" int edsnet_flash_attention_dkv(const void* q, const void* k,
                                          const void* v, const void* mask,
                                          const void* g, const void* m,
                                          const void* l, const void* dd,
                                          void* dk, void* dv, int bh, int n,
                                          int d, int passes, float scale,
                                          void* stream) {
  if (bad_shape(bh, n)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mi = static_cast<const int*>(mask);
  const auto* gf = static_cast<const float*>(g);
  const auto* mf = static_cast<const float*>(m);
  const auto* lf = static_cast<const float*>(l);
  const auto* df = static_cast<const float*>(dd);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto s = static_cast<cudaStream_t>(stream);
  switch (passes) {
    case 1:
      return launch_dkv_d<1>(d, qf, kf, vf, mi, gf, mf, lf, df, dkf, dvf, bh,
                             n, scale, s);
    case 3:
      return launch_dkv_d<3>(d, qf, kf, vf, mi, gf, mf, lf, df, dkf, dvf, bh,
                             n, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
