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
// 4*(4*N*D + 3*N) bytes.  At N = 2304 that is about 570 operations a byte
// (D = 128), so the tensor cores bound it: PASSES TF32 products of each of
// the two matrix products, at 495 TFLOP/s dense TF32, 0.527 ms at 3 passes
// (precision "highest") and 0.176 ms at 1 pass ("default") for
// (BH, N, D) = (32, 2304, 128), (16, 2304, 256) or (8, 2304, 512).  On the
// local-global heads' own shape, (8, 576, 512), the operations bound it at
// 3 passes (0.0329 ms) and the bytes at 1 (37.8 MB, 0.0113 ms).
//
// Two kernels, by head dim.  Both keep S and O in mma.sync accumulator
// registers, one warp per 16 query rows, 4 warps per 64-row q tile, and a
// loop over 32-key tiles inside the block takes the place of the TPU's
// sequential k grid axis (csrc/tf32_mma.cuh holds the products and the
// copies).
//
// flash_fwd_kernel, head dims 32 to 128: one block per (bh, q tile).
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
//
// flash_fwd_cluster_kernel, head dims 256 and 512: a thread-block cluster
// of two blocks per (bh, q tile).  Whole, a wide head does not fit one
// block: O's D columns would take D/2 accumulator registers a thread (255
// is the most), and q with two stages of k and v 195 KB at D 256, so one
// block of 4 warps per SM, and at D 512 more than a block may hold.  Split
// over two blocks that each compute S, it does S twice.  So block r of the
// pair (its rank in the cluster) owns head-dim half r, DH = D/2 columns:
//   - it keeps only its half of the q tile in shared memory and streams
//     only its halves of k's and v's columns, in chunks of 32 keys x 128
//     columns through a ring of two cp.async slots, each chunk's copy in
//     flight while the chunk before it is multiplied;
//   - per key tile it computes the partial S_r = q_r k_r^T over its DH
//     columns, stores it into the peer's exchange slot (64 x 32 floats,
//     laid out by thread: the same thread of either block holds the same S
//     elements) and adds the peer's partial to its own: S = S_0 + S_1 is
//     computed once, and the kernel does the bound's 4*N^2*D operations;
//   - then the mask, the scale and the online softmax, and O_r += P v_r on
//     its own DH columns, P from the accumulator as above.
// Invariant: both blocks hold bit-identical S, m, l and P, because float
// addition is commutative (rank 0 adds S_0 + S_1, rank 1 S_1 + S_0) and
// all that follows is the same arithmetic on the same values.  So rank 0
// alone writes m and l, and each block normalises its columns by its own l.
// The exchange: the partial goes over as st.async remote stores that count
// their bytes on the peer's `full` mbarrier; having read the peer's partial
// a thread sends a 4-byte token the same way to the peer's `empty` mbarrier,
// and the next partial goes over once our `empty` phase has completed.  No
// cluster barrier runs in the loop: its arrive has release semantics, and
// an exchange through it (arrive and wait twice a key tile) ran 3-12 %
// slower on an H100, awaiting the ring's copies before it or not
// (tools/fwd_variants.py, PERF.md); st.async signals after its own write,
// with release semantics at cluster scope, and holds up no thread.
// Shared memory a block: DH 256: q half 66.6 KB, ring 33.8 KB, exchange
// 8.2 KB, mask, tokens and barriers 0.8 KB, 109 KB, two blocks (8 warps)
// per SM; DH 128: 33.8 + 33.8 + 8.2 + 0.8 KB, 77 KB, three blocks (12
// warps) per SM, where the one-block designs ran one (two at DH 128 ran
// 5-11 % slower, tools/fwd_variants.py).  O takes 128 (DH 256) or 64
// (DH 128) accumulator registers a thread.
//
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

// The cluster: this block's rank, a cluster-wide barrier (once, at the
// start), and the mbarrier and st.async operations of the exchange.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// all threads of both blocks: earlier shared-memory writes (the barriers'
// initialisation) are visible to both blocks after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\t"
               "barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address in block `rank` of what `p` points to here.
__device__ __forceinline__ uint32_t peer_address(const void* p,
                                                 uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(shared_address(p)), "r"(rank));
  return r;
}

// An mbarrier whose phases complete on one arrival and `tx` bytes.
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               ::"r"(shared_address(bar))
               : "memory");
}

// the one arrival of the barrier's current phase, which then waits for
// `tx` bytes of st.async (they may land before it)
__device__ __forceinline__ void barrier_expect(uint64_t* bar, uint32_t tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(tx)
               : "memory");
}

// wait until the phase of parity `parity` has completed, then acquire
// (at cluster scope: the writes it counted came from the peer)
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = shared_address(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;"
        "\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes into the peer's shared memory at `addr`, counted by the peer's
// barrier at `bar` (both shared::cluster addresses)
__device__ __forceinline__ void store_async(uint32_t addr, const float (&x)[4],
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void store_async(uint32_t addr, uint32_t x,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(x), "r"(bar)
      : "memory");
}

template <int DH>
struct ClusterLayout {
  static constexpr int CH = 128;          // columns of a streamed chunk
  static constexpr int LDQ = DH + 4;      // padded row strides, floats
  static constexpr int LDC = CH + 4;
  static constexpr int KC = DH / CH;      // k chunks of a key tile, then as
  static constexpr int CPT = 2 * KC;      // many v chunks: chunks a tile
  static constexpr int SLOTS = 2;         // ring slots
  static constexpr int MSLOTS = 2;        // mask slots, one per key tile
  static constexpr int kQ = BQ * LDQ;
  static constexpr int kChunk = BK * LDC;
  static constexpr int kX = BQ * BK;      // the exchange slot: a partial S
  static constexpr uint32_t kXBytes = kX * sizeof(float);
  static constexpr uint32_t kTokenBytes = THREADS * sizeof(uint32_t);
  // floats, then the mask, the tokens and two mbarriers (8-byte aligned)
  static constexpr size_t kBytes = (kQ + SLOTS * kChunk + kX) * sizeof(float) +
                                   MSLOTS * BK * sizeof(int) + kTokenBytes +
                                   2 * sizeof(uint64_t);
  static_assert(DH % CH == 0 && SLOTS >= 2, "whole chunks, a copy in flight");
};

// three blocks per SM at DH 128 (77 KB, up to 170 registers), two at 256
template <int DH, int PASSES>
__global__ void __cluster_dims__(1, 1, 2)
    __launch_bounds__(THREADS, DH == 128 ? 3 : 2)
flash_fwd_cluster_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ mask, float* __restrict__ out,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         int n, float scale) {
  using L = ClusterLayout<DH>;
  constexpr int D = 2 * DH;
  constexpr int NT = BK / 8;     // 8-key column tiles of S
  constexpr int CT = L::CH / 8;  // 8-wide steps of a chunk
  constexpr int DT = DH / 8;     // 8-wide column tiles of the block's O half

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ring = qs + L::kQ;
  float* xs = ring + L::SLOTS * L::kChunk;  // the peer's partial S lands here
  int* ms = reinterpret_cast<int*>(xs + L::kX);
  uint32_t* tokens = reinterpret_cast<uint32_t*>(ms + L::MSLOTS * BK);
  // full: the peer's partial is in xs; empty: the peer has read ours
  uint64_t* full = reinterpret_cast<uint64_t*>(tokens + THREADS);
  uint64_t* empty = full + 1;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t rank = cluster_rank();
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int col0 = rank * DH;  // the block's half of the head dim
  const size_t base = static_cast<size_t>(bh) * n * D;
  const size_t row_base = static_cast<size_t>(bh) * n;
  const int n_tiles = n / BK;
  const int n_chunks = n_tiles * L::CPT;
  const uint32_t peer = rank ^ 1u;
  const uint32_t peer_xs = peer_address(xs, peer) + 16u * tid;
  const uint32_t peer_token = peer_address(tokens + tid, peer);
  const uint32_t peer_full = peer_address(full, peer);
  const uint32_t peer_empty = peer_address(empty, peer);

  // Phase j of `full` completes when the peer's partial of key tile j has
  // landed in xs; phase j of `empty` when the peer has read our partial of
  // tile j out of its xs (its tokens, one a thread).  Thread 0 arms phase
  // j + 1 of each after waiting for phase j, and before the block's own
  // signal that lets the peer go on to tile j + 1.  Both blocks must have
  // initialised their barriers before the first st.async.
  if (tid == 0) {
    barrier_init(full);
    barrier_init(empty);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    barrier_expect(full, L::kXBytes);
    barrier_expect(empty, L::kTokenBytes);
  }
  cluster_sync();

  // chunk c = key tile c / CPT, its k half's chunks then its v half's, into
  // ring slot c % SLOTS; a tile's first chunk brings its mask
  auto load_chunk = [&](int c) {
    const int j = c / L::CPT, i = c % L::CPT;
    const size_t at = base + static_cast<size_t>(j) * BK * D + col0;
    const float* src = i < L::KC ? k + at + i * L::CH
                                 : v + at + (i - L::KC) * L::CH;
    tf32::copy_tile<L::CH, THREADS>(ring + (c % L::SLOTS) * L::kChunk, L::LDC,
                                    src, D, BK, tid);
    if (i == 0 && tid < BK / 4)
      tf32::cp_async16(ms + (j % L::MSLOTS) * BK + 4 * tid,
                       mask + row_base + j * BK + 4 * tid);
  };
  // wait for chunk c; the barrier also ends every thread's use of chunk
  // c - 1, whose slot then takes chunk c + SLOTS - 1
  auto chunk = [&](int c) -> const float* {
    tf32::cp_async_wait<L::SLOTS - 2>();
    __syncthreads();
    if (c + L::SLOTS - 1 < n_chunks) load_chunk(c + L::SLOTS - 1);
    tf32::cp_async_commit();
    return ring + (c % L::SLOTS) * L::kChunk;
  };

  tf32::copy_tile<DH, THREADS>(qs, L::LDQ,
                               q + base + static_cast<size_t>(q0) * D + col0,
                               D, BQ, tid);
#pragma unroll
  for (int c = 0; c < L::SLOTS - 1; ++c) {
    load_chunk(c);  // n >= 64 gives at least 2 CPT chunks
    tf32::cp_async_commit();
  }

  // rows g (h = 0) and g + 8 (h = 1) of the warp's 16
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  const float* qw = qs + warp * 16 * L::LDQ;
  const float4* xs4 = reinterpret_cast<const float4*>(xs);

  for (int j = 0; j < n_tiles; ++j) {
    // the partial S_r = q_r k_r^T over the block's DH columns
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int c = 0; c < L::KC; ++c) {
      const float* ks = chunk(j * L::CPT + c);
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
    }

    // S = S_0 + S_1: ours into the peer's xs (element e of s[nt] at float4
    // nt * THREADS + tid), once the peer has read the one before; the
    // peer's out of ours, then a token that says so
    if (j > 0) {
      barrier_wait(empty, (j - 1) & 1);
      if (tid == 0) barrier_expect(empty, L::kTokenBytes);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      store_async(peer_xs + 16u * nt * THREADS, s[nt], peer_full);
    barrier_wait(full, j & 1);
    if (tid == 0) barrier_expect(full, L::kXBytes);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 x = xs4[nt * THREADS + tid];
      s[nt][0] += x.x;
      s[nt][1] += x.y;
      s[nt][2] += x.z;
      s[nt][3] += x.w;
    }
    // (the token carries a sum, so it leaves after the loads have returned)
    store_async(peer_token, __float_as_uint(s[0][0]), peer_empty);

    // scale, mask and online softmax, as flash_fwd_kernel
    const int* mk = ms + (j % L::MSLOTS) * BK;
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

    // O_r += P v_r, one v chunk at a time, P from the accumulator
#pragma unroll
    for (int c = 0; c < L::KC; ++c) {
      const float* vs = chunk(j * L::CPT + L::KC + c);
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
    }
  }
  // the peer's last st.async into this block, its token for our last
  // partial, has landed: the block may exit
  barrier_wait(empty, (n_tiles - 1) & 1);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    const float l = l_r[h] < 1e-30f ? 1e-30f : l_r[h];  // NaN stays NaN
    float* orow = out + base + static_cast<size_t>(r) * D + col0;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(orow + 8 * dt + 2 * t) =
          make_float2(o[dt][2 * h] / l, o[dt][2 * h + 1] / l);
    if (rank == 0 && t == 0) {  // the peer holds the same m and l
      m_out[row_base + r] = m_r[h];
      l_out[row_base + r] = l;
    }
  }
}

template <int DH, int PASSES>
cudaError_t launch_cluster(const float* q, const float* k, const float* v,
                           const int* mask, float* out, float* m, float* l,
                           int bh, int n, float scale, cudaStream_t stream) {
  const size_t bytes = ClusterLayout<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_cluster_kernel<DH, PASSES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(n / BQ, bh, 2);  // z: the pair of a cluster
  flash_fwd_cluster_kernel<DH, PASSES><<<grid, THREADS, bytes, stream>>>(
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
      return launch_cluster<128, PASSES>(q, k, v, mask, out, m, l, bh, n,
                                         scale, stream);
    case 512:
      return launch_cluster<256, PASSES>(q, k, v, mask, out, m, l, bh, n,
                                         scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// info = {registers a thread, shared bytes a block, blocks that fit one
// SM, clusters that fit the card}; the last is 0 for the one-block kernel.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, size_t bytes, bool cluster, int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.sharedSizeBytes + bytes);
  info[3] = 0;
  if (!cluster)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel,
                                                         THREADS, bytes);
  int device = 0, sms = 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2 * 132, 1, 2);  // the cluster size is the kernel's
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = bytes;
  err = cudaOccupancyMaxActiveClusters(&info[3], kernel, &config);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  info[2] = sms > 0 ? 2 * info[3] / sms : 0;
  return err;
}

template <int PASSES>
cudaError_t occupancy_d(int d, int* info) {
  switch (d) {
    case 32:
      return occupancy(flash_fwd_kernel<32, PASSES>, Layout<32>::kBytes,
                       false, info);
    case 64:
      return occupancy(flash_fwd_kernel<64, PASSES>, Layout<64>::kBytes,
                       false, info);
    case 128:
      return occupancy(flash_fwd_kernel<128, PASSES>, Layout<128>::kBytes,
                       false, info);
    case 256:
      return occupancy(flash_fwd_cluster_kernel<128, PASSES>,
                       ClusterLayout<128>::kBytes, true, info);
    case 512:
      return occupancy(flash_fwd_cluster_kernel<256, PASSES>,
                       ClusterLayout<256>::kBytes, true, info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [bh, n, d] f32 contiguous, 16-byte aligned; mask: [bh, n]
// int32; m, l: [bh, n] f32.  n must be a multiple of 64, d one of 32, 64,
// 128, 256, 512 and passes 1 or 3.  Launches on `stream` and returns the
// launch's cudaError_t (0 = success).
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

// The forward kernel that head dim d runs at `passes`: info[0] registers a
// thread, info[1] shared bytes a block, info[2] blocks resident on one SM,
// info[3] clusters resident on the card (0 when d takes one block per q
// tile).  Returns the cudaError_t of the queries.
extern "C" int edsnet_flash_attention_fwd_occupancy(int d, int passes,
                                                    int* info) {
  switch (passes) {
    case 1:
      return occupancy_d<1>(d, info);
    case 3:
      return occupancy_d<3>(d, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
