// Exact 0/1 knapsack of every batch row for Hopper (sm_90a): the whole DP
// and its backtrack in one launch, one thread block a row.
//
// Replaces no Pallas kernel.  The JAX package writes this DP as two
// lax.scans (edsnet_tpu/ops/knapsack.py:knapsack_jax), and their straight
// translation, the plain twin edsnet_torch/ops/knapsack.py:knapsack_plain,
// cost about 12 host launches an item in the DP and 5 in the backtrack.
// Same function as the twin, bit for bit: in int32 (wrapping),
// dp'[c] = max(dp[c], dp[c - w] + v) with the strict cand > dp tie rule,
// dp[c - w] read as -10^9 where c < w; an item takes a round only where it
// is usable, w <= capacity and v > 0; the backtrack walks the items in
// reverse from c = capacity and after each take moves to max(c - w, 0).
// Two exact shortcuts: dp'[c] reads only dp[c' <= c] and the backtrack
// never leaves [0, capacity], so the DP stops at the row's own capacity
// (not max_capacity); and an item that is not usable takes no round, since
// its take bits at c <= capacity are all 0 in the twin (-1 < dp[c] there).
//
// Bound on this card: a row reads its values and weights and writes its
// selection, 9 bytes an item (nanoseconds); its arithmetic is n x C
// compare-adds (0.14 M at n 77, C 1845: well under a microsecond).
// Neither bounds it: item i reads the row item i - 1 wrote, so the DP is
// a chain of n rounds on one SM, each a pass over C and a barrier, and
// the backtrack is a chain of n dependent reads.
//
// Design: one block of THREADS threads a row.  The row's values and
// weights are staged in shared memory once, and its DP vector lives there
// as two int32 buffers, ping-ponged so a round reads the old row while it
// writes the new one.  In a round each warp covers 32 consecutive
// capacities per pass and writes the pass's take bits as one word from
// __ballot_sync; one __syncthreads a round, where the host loop made ~12
// launches.  The take bits (n x ceil((max_capacity + 1) / 32) words) stay
// in shared memory when they fit beside the DP vector, or go to global
// scratch (a row of a long video: ~554 shots at C 8603 make 596 KB); a DP
// vector too large for shared memory goes to global scratch too (C above
// ~29,000).  The shapes choose the layout, so every size runs.  After the
// last round thread 0 walks the backtrack, a bit an item.
// THREADS: one shot row at (n, C) = (80, 1845) / (128, 1845) / (192,
// 3074) / (576, 8603) took 0.040 / 0.083 / 0.158 / 1.263 ms at 256
// threads, 0.035 / 0.066 / 0.119 / 0.826 at 512 and 0.039 / 0.065 /
// 0.106 / 0.705 at 1024 (H100, 700 W).  512 is kept: best at the eval
// cells' rows (~77 shot slots), within 12 % of 1024 at training's largest.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NEG_BIG = -1000000000;
constexpr unsigned FULL = 0xffffffffu;

// Where a row's arrays live, from the shapes and the shared-memory budget:
// its values and weights (2n ints) and the DP vector's two buffers (2C
// ints), then its take bits (n x ceil(C / 32) words), in shared memory
// while they fit there.
struct Layout {
  int words;            // take-bit words an item
  bool dp_shared;       // values, weights and the DP vector in shared memory
  bool bits_shared;     // the take bits in shared memory too
  size_t smem;          // dynamic shared bytes a block
  size_t scratch;       // global scratch words a row
};

Layout layout(int n, int max_capacity, size_t budget) {
  const size_t c = static_cast<size_t>(max_capacity) + 1;
  const size_t words = (c + 31) / 32;
  const size_t front = 2 * static_cast<size_t>(n) + 2 * c;
  const size_t bits = static_cast<size_t>(n) * words;
  const int w = static_cast<int>(words);
  if (4 * (front + bits) <= budget)
    return {w, true, true, 4 * (front + bits), 0};
  if (4 * front <= budget) return {w, true, false, 4 * front, bits};
  return {w, false, false, 0, bits + 2 * c};
}

template <bool DP_SHARED, bool BITS_SHARED>
__global__ void __launch_bounds__(THREADS)
knapsack_kernel(const int* __restrict__ values,
                const int* __restrict__ weights,
                const int* __restrict__ capacity,
                uint8_t* __restrict__ selected, uint32_t* scratch, int n,
                int max_capacity, int words, size_t scratch_row) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = blockIdx.x;
  const int c_len = max_capacity + 1;
  // 0 <= capacity <= max_capacity is a precondition; the clamp only keeps
  // a bad input inside the row's buffers
  const int cap = min(max(capacity[row], 0), max_capacity);
  const int* rv = values + row * n;
  const int* rw = weights + row * n;
  uint32_t* rs = scratch + row * scratch_row;
  const int* sv = rv;
  const int* sw = rw;
  int* dp;
  if (DP_SHARED) {
    for (int i = threadIdx.x; i < n; i += THREADS) {
      smem[i] = rv[i];
      smem[n + i] = rw[i];
    }
    sv = smem;
    sw = smem + n;
    dp = smem + 2 * n;
  } else {
    dp = reinterpret_cast<int*>(rs + static_cast<size_t>(n) * words);
  }
  uint32_t* bits = BITS_SHARED
      ? reinterpret_cast<uint32_t*>(smem + 2 * n + 2 * c_len) : rs;
  int* cur = dp;
  int* nxt = dp + c_len;
  for (int c = threadIdx.x; c <= cap; c += THREADS) cur[c] = 0;
  __syncthreads();

  const int row_words = cap / 32 + 1;         // the words of [0, cap]
  for (int j = 0; j < n; ++j) {
    const int v = sv[j], w = sw[j];
    if (!(w <= cap && v > 0)) continue;       // the same for every thread
    const int shift = max(w, 0);              // as the twin's clamped slice
    uint32_t* bj = bits + static_cast<size_t>(j) * words;
    for (int word = warp; word < row_words; word += WARPS) {
      const int c = word * 32 + lane;
      bool took = false;
      if (c <= cap) {
        const int old = cur[c];
        const int src = c >= shift ? cur[c - shift] : NEG_BIG;
        // int32 addition that wraps, as the twin's tensors do
        const int cand = static_cast<int>(static_cast<unsigned>(src)
                                          + static_cast<unsigned>(v));
        took = cand > old;
        nxt[c] = took ? cand : old;
      }
      const uint32_t mask = __ballot_sync(FULL, took);
      if (lane == 0) bj[word] = mask;
    }
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }

  if (threadIdx.x == 0) {
    uint8_t* out = selected + row * n;
    int c = cap;
    for (int j = n - 1; j >= 0; --j) {
      const int v = sv[j], w = sw[j];
      const bool take = w <= cap && v > 0 &&
          ((bits[static_cast<size_t>(j) * words + (c >> 5)] >> (c & 31)) & 1u);
      out[j] = static_cast<uint8_t>(take);
      if (take) c = min(max(c - w, 0), cap);
    }
  }
}

int shared_budget(size_t* budget) {
  int device = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *budget = static_cast<size_t>(bytes);
  return static_cast<int>(err);
}

template <bool DP_SHARED, bool BITS_SHARED>
int launch(const int* values, const int* weights, const int* capacity,
           uint8_t* selected, uint32_t* scratch, int b, int n,
           int max_capacity, const Layout& l, cudaStream_t stream) {
  auto kernel = knapsack_kernel<DP_SHARED, BITS_SHARED>;
  if (l.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(l.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<b, THREADS, l.smem, stream>>>(values, weights, capacity, selected,
                                          scratch, n, max_capacity, l.words,
                                          l.scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The global scratch a row needs on the current device, in uint32 words
// (0 when the row fits in shared memory); -1 on a CUDA error.
extern "C" long long edsnet_knapsack_scratch_words(int n, int max_capacity) {
  size_t budget = 0;
  if (shared_budget(&budget) != 0) return -1;
  return static_cast<long long>(layout(n, max_capacity, budget).scratch);
}

// selected[b, n] (bool bytes) of the exact 0/1 knapsack of every row over
// values and weights [b, n] int32 at capacity [b] int32 (<= max_capacity);
// scratch holds edsnet_knapsack_scratch_words(n, max_capacity) uint32
// words a row.  Launches on `stream` and returns the cudaError_t of the
// launch.
extern "C" int edsnet_knapsack(const void* values, const void* weights,
                               const void* capacity, void* selected,
                               void* scratch, int b, int n, int max_capacity,
                               void* stream) {
  if (b <= 0 || n <= 0 || max_capacity < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t budget = 0;
  const int err = shared_budget(&budget);
  if (err != 0) return err;
  const Layout l = layout(n, max_capacity, budget);
  const auto* v = static_cast<const int*>(values);
  const auto* w = static_cast<const int*>(weights);
  const auto* c = static_cast<const int*>(capacity);
  auto* out = static_cast<uint8_t*>(selected);
  auto* s = static_cast<uint32_t*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  if (l.bits_shared)
    return launch<true, true>(v, w, c, out, s, b, n, max_capacity, l, st);
  if (l.dp_shared)
    return launch<true, false>(v, w, c, out, s, b, n, max_capacity, l, st);
  return launch<false, false>(v, w, c, out, s, b, n, max_capacity, l, st);
}
