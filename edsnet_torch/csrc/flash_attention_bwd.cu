// Masked flash-attention backward for Hopper (sm_90a), f32 end to end: two
// kernels, one for dq and one for dk/dv, each output element with exactly
// one writer (no atomics), so gradients are bit-identical from run to run.
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
// Bound on this card: dq does 6*N^2*D FLOPs per (batch*head) (q k^T, g v^T,
// dS k), dk/dv 8*N^2*D (q k^T, g v^T, P^T g, dS^T q), against 4*(5*N*D + 3*N)
// and 4*(7*N*D + 3*N) bytes; at N = 2304, D = 128 both are bound by
// operations.  This first version runs them as f32 FMAs, so the ceiling is
// the 67 TFLOP/s f32 rate.  The design mirrors the forward kernel
// (csrc/flash_attention_fwd.cu): the [N, N] score matrix never leaves the
// block, and the FMAs are fed from shared memory with 4x4 register tiles:
//   - dq: one block per (bh, 64-row q tile) loops over 64-key tiles, keeping
//     the 64 x D accumulator in registers;
//   - dk/dv: one block per (bh, 64-key tile) loops over 64-row q tiles,
//     keeping two 64 x D accumulators in registers (64 floats per thread at
//     D = 128);
//   - every tile that a 16 x 16 thread grid reads across rows is padded by
//     one float against bank conflicts; at D = 128 the blocks use about 149
//     and 166 KB of dynamic shared memory, so each runs one block per SM.
#include <cuda_runtime.h>

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

template <int D>
struct DkvLayout {
  static constexpr int LD = D + 1;   // k, v, q, g rows
  static constexpr int LDP = BK + 1; // P and dS tiles, [q row][key]
  static constexpr size_t kFloats = 4 * 64 * LD + 2 * BQ * LDP + 3 * BQ;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// dk, dv for keys k0 .. k0+63 of one (batch*head).  Thread (ty, tx) owns
// keys ty + 16a; in the score tile, q rows tx + 16b; in the accumulators,
// columns tx + 16c.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ mask,
                 const float* __restrict__ g, const float* __restrict__ m_in,
                 const float* __restrict__ l_in,
                 const float* __restrict__ dd_in, float* __restrict__ dk,
                 float* __restrict__ dv, int n, float scale) {
  using L = DkvLayout<D>;
  constexpr int DC = D / 16;

  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * L::LD;
  float* qs = vs + BK * L::LD;
  float* gs = qs + BQ * L::LD;
  float* ps = gs + BQ * L::LD;
  float* dss = ps + BQ * L::LDP;
  float* m_s = dss + BQ * L::LDP;
  float* l_s = m_s + BQ;
  float* dd_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t base = static_cast<size_t>(bh) * n * D;
  const size_t row_base = static_cast<size_t>(bh) * n;

  for (int i = tid; i < BK * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const size_t gi = base + static_cast<size_t>(k0 + r) * D + c;
    ks[r * L::LD + c] = k[gi];
    vs[r * L::LD + c] = v[gi];
  }
  int km[4];
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    km[a] = mask[row_base + k0 + ty + 16 * a];
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;
  }

  for (int i0 = 0; i0 < n; i0 += BQ) {
    __syncthreads();  // the previous tile's qs/gs/ps/dss reads are done
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const size_t gi = base + static_cast<size_t>(i0 + r) * D + c;
      qs[r * L::LD + c] = q[gi] * scale;
      gs[r * L::LD + c] = g[gi];
    }
    if (tid < BQ) {
      m_s[tid] = m_in[row_base + i0 + tid];
      l_s[tid] = l_in[row_base + i0 + tid];
      dd_s[tid] = dd_in[row_base + i0 + tid];
    }
    __syncthreads();

    // s = (q * scale) k^T and dP = g v^T for keys ty + 16a, rows tx + 16b
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ka[4], va[4], qb[4], gb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ka[a] = ks[(ty + 16 * a) * L::LD + d];
        va[a] = vs[(ty + 16 * a) * L::LD + d];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        qb[b] = qs[(tx + 16 * b) * L::LD + d];
        gb[b] = gs[(tx + 16 * b) * L::LD + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(qb[b], ka[a], s[a][b]);
          dp[a][b] = fmaf(gb[b], va[a], dp[a][b]);
        }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = tx + 16 * b;
      const float m = m_s[r], l = l_s[r], dd = dd_s[r];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = expf(masked_score(s[a][b], km[a]) - m) / l;
        ps[r * L::LDP + ty + 16 * a] = p;
        dss[r * L::LDP + ty + 16 * a] =
            km[a] > 0 ? p * (dp[a][b] - dd) : 0.f;
      }
    }
    __syncthreads();

    // dv += P^T g and dk += dS^T (q * scale) for keys ty + 16a, columns
    // tx + 16c
#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      float pa[4], da[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pa[a] = ps[i * L::LDP + ty + 16 * a];
        da[a] = dss[i * L::LDP + ty + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float gg = gs[i * L::LD + tx + 16 * c];
        const float qq = qs[i * L::LD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          dv_acc[a][c] = fmaf(pa[a], gg, dv_acc[a][c]);
          dk_acc[a][c] = fmaf(da[a], qq, dk_acc[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const size_t r = base + static_cast<size_t>(k0 + ty + 16 * a) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[r + tx + 16 * c] = dk_acc[a][c];
      dv[r + tx + 16 * c] = dv_acc[a][c];
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

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const int* mask, const float* g, const float* m,
                       const float* l, const float* dd, float* dk, float* dv,
                       int bh, int n, float scale, cudaStream_t stream) {
  const size_t bytes = DkvLayout<D>::kBytes;
  cudaError_t err = allow_smem(flash_dkv_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<D><<<dim3(n / BK, bh), THREADS, bytes, stream>>>(
      q, k, v, mask, g, m, l, dd, dk, dv, n, scale);
  return cudaGetLastError();
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

// As above, with outputs dk, dv: [bh, n, d] f32.
extern "C" int edsnet_flash_attention_dkv(const void* q, const void* k,
                                          const void* v, const void* mask,
                                          const void* g, const void* m,
                                          const void* l, const void* dd,
                                          void* dk, void* dv, int bh, int n,
                                          int d, float scale, void* stream) {
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
  switch (d) {
    case 32:
      return launch_dkv<32>(qf, kf, vf, mi, gf, mf, lf, df, dkf, dvf, bh, n,
                            scale, s);
    case 64:
      return launch_dkv<64>(qf, kf, vf, mi, gf, mf, lf, df, dkf, dvf, bh, n,
                            scale, s);
    case 128:
      return launch_dkv<128>(qf, kf, vf, mi, gf, mf, lf, df, dkf, dvf, bh, n,
                             scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
