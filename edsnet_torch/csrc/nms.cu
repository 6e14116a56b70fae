// Greedy non-maximum suppression of 1-D boxes for Hopper (sm_90a): the
// whole sweep of every batch row in one launch, one thread block a row.
//
// Replaces no Pallas kernel.  The JAX package writes this NMS as a
// lax.scan (edsnet_tpu/ops/bbox.py:nms_masked), and its straight
// translation cost two host launches a box.  Same function as the plain
// twin edsnet_torch/ops/bbox.py:nms_masked_plain: walk the boxes in the
// order `order` gives (descending score, ties to the larger index); a box
// still alive is kept and kills every later box whose IoU with it is >=
// thresh.  IoU as iou_lr computes it, in float32: inter = max(min(r_a, r_b)
// - max(l_a, l_b), 0), union = max(r_a, r_b) - min(l_a, l_b), 1e-6 where
// union <= 0, and inter / union rounded to nearest (__fdiv_rn, whatever
// the compiler's flags).  IoU is symmetric to the bit, so a kept box never
// kills an earlier kept one, and only later boxes are tested.
//
// Bound on this card: a row reads its boxes, order and alive flags and
// writes keep, 18 bytes a box (74 KB at n = 4096, 0.022 us at 3.35 TB/s).
// Its arithmetic is the pair tests between each kept box and the later
// live boxes: about 0.8 M at n = 4096 on the eval cells' rows, well under
// a microsecond at the card's f32 rate.  Neither bounds it: a box's fate depends on every
// earlier kept box, so the sweep is a chain in n on one SM, whose issue
// rate and latency set the time (0.28 ms at n = 4096, PERF.md).
//
// Design: one block of WARPS warps per row.  The row's boxes are gathered
// by `order` into shared memory (sorted, as float2) in tiles of TILE, with
// one live bit a box.  Before the sweep, every chunk of 32 sorted boxes
// gets its pair tests at once, a ballot a box: the mask of the earlier
// boxes of its chunk that would kill it.  The sweep walks the chunks,
// pipelined over one __syncthreads a chunk:
//   - warp 0 settles chunk c + 1: it clears that chunk's bits by the kept
//     boxes of chunk c, then resolves the greedy inside the chunk from the
//     masks with one ballot per kept box, and lists the chunk's kept boxes
//     (a buffer by the parity of the chunk);
//   - meanwhile the other warps clear every later chunk (c + 2 on, a chunk
//     a warp in turn) by the kept boxes of chunk c, a lane a box, the
//     chunk's new bits one ballot;
//   - a dead box costs nothing beyond its bit; a pair is first tested for
//     overlap (5 instructions), and only overlapping pairs, a few in a
//     hundred, take the exact test with its division.
// 128 barriers at n = 4096 (TILE holds it whole), where the host loop made
// 4096 trips.  The clearing is spread over the warps: at n = 4096, 8 and
// 16 warps ran 3.0x and 1.6x the time of 32 without the overlap test, 16
// ran 1.2x with it.  A row longer than TILE
// (infer.py's long videos) is swept a tile at a time: the kept boxes of
// earlier tiles go to `kept_list` (global scratch of n boxes a row), and a
// tile's boxes are tested against them as they are gathered.  So every n
// runs, in ceil(n / TILE) passes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 32;
constexpr int THREADS = WARPS * 32;
constexpr int CLEARERS = WARPS - 1;   // warps 1.. clear; warp 0 settles
constexpr int TILE = 16384;           // sorted boxes a block holds
constexpr unsigned FULL = 0xffffffffu;

// iou_lr(a, b) >= thresh, bit for bit, for two live boxes (left < right):
// their union is > 0, so a pair that does not overlap (inter 0) reads IoU
// 0 without the division.
__device__ __forceinline__ bool suppresses(float2 a, float2 b, float thresh) {
  const float inter = fmaxf(fminf(a.y, b.y) - fmaxf(a.x, b.x), 0.0f);
  if (!(inter > 0.0f)) return 0.0f >= thresh;
  float uni = fmaxf(a.y, b.y) - fminf(a.x, b.x);
  if (uni <= 0.0f) uni = 1e-6f;
  return __fdiv_rn(inter, uni) >= thresh;
}

// Any of the boxes k[0, n) kills the live box b.  A first pass marks the
// boxes that overlap b, 5 instructions a pair; only those take the exact
// test.  With thresh <= 0 every pair kills (IoU >= 0).
__device__ __forceinline__ bool any_kills(const float2* k, int n, float2 b,
                                          float thresh) {
  uint32_t over = 0;
#pragma unroll 4
  for (int i = 0; i < n; ++i)
    over |= static_cast<uint32_t>(fminf(k[i].y, b.y) > fmaxf(k[i].x, b.x))
            << i;
  bool dead = n > 0 && thresh <= 0.0f;
  for (; over && !dead; over &= over - 1)
    dead = suppresses(k[__ffs(over) - 1], b, thresh);
  return dead;
}

__device__ __forceinline__ uint32_t below(int lane) {
  return (1u << lane) - 1u;
}

__global__ void __launch_bounds__(THREADS)
nms_sweep_kernel(const float2* __restrict__ boxes,
                 const uint8_t* __restrict__ alive,
                 const int64_t* __restrict__ order, uint8_t* __restrict__ keep,
                 float2* kept_list, int n, float thresh) {
  extern __shared__ float2 bx[];              // [words * 32] sorted boxes
  __shared__ int tile_kept;                   // kept boxes of the tile
  __shared__ float2 kb[2][32];                // kept boxes of chunk c, by c & 1
  const int words = (min(n, TILE) + 31) / 32;
  // [words * 32]: a box's mask of the earlier boxes of its chunk that would
  // kill it, whether alive or not
  uint32_t* sup = reinterpret_cast<uint32_t*>(bx + words * 32);
  uint32_t* live = sup + words * 32;          // [words] live bits a chunk
  uint32_t* kept_w = live + words;            // [words] kept bits a chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = blockIdx.x;
  const float2* rb = boxes + row * n;
  const uint8_t* ra = alive + row * n;
  const int64_t* ro = order + row * n;
  uint8_t* rk = keep + row * n;
  float2* rl = kept_list + row * n;
  int listed = 0;                             // kept boxes of earlier tiles

  for (int start = 0; start < n; start += TILE) {
    const int m = min(TILE, n - start);
    const int mw = (m + 31) / 32;
    const bool more = start + TILE < n;       // a later tile reads rl
    // Gather the tile in score order; a live box is tested against the
    // kept boxes of earlier tiles.
    for (int w = warp; w < mw; w += WARPS) {
      const int s = w * 32 + lane;
      float2 b = make_float2(0.0f, 0.0f);
      bool on = false;
      if (s < m) {
        const int64_t o = ro[start + s];
        b = rb[o];
        on = ra[o] != 0;
        for (int k = 0; on && k < listed; ++k)
          on = !suppresses(rl[k], b, thresh);
      }
      bx[s] = b;
      const uint32_t bits = __ballot_sync(FULL, on);
      if (lane == 0) live[w] = bits;
    }
    __syncthreads();
    // Every chunk's pairs at once, a ballot a box: lane i tests box i of
    // the chunk against box t.
    for (int t = warp; t < mw * 32; t += WARPS) {
      const int base = t & ~31;
      const bool kills = lane < (t & 31)
                         && suppresses(bx[base + lane], bx[t], thresh);
      const uint32_t mask = __ballot_sync(FULL, kills);
      if (lane == 0) sup[t] = mask;
    }
    __syncthreads();

    // Iteration c: warp 0 settles chunk c + 1, the others clear chunks
    // c + 2 on by chunk c's kept boxes (c = -1 settles chunk 0 alone).
    int count = 0;                            // warp 0: kept in this tile
    for (int c = -1; c + 1 < mw; ++c) {
      const int nk = c >= 0 ? __popc(kept_w[c]) : 0;
      const float2* kc = kb[c & 1];
      if (warp == 0) {
        const int q = c + 1;
        const float2 mine = bx[q * 32 + lane];
        uint32_t word = live[q];
        const bool dead = ((word >> lane) & 1u) &&
                          any_kills(kc, nk, mine, thresh);
        word &= ~__ballot_sync(FULL, dead);
        // the live lanes before this one that would kill it
        const uint32_t killers = sup[q * 32 + lane] & word;
        // the lowest unresolved live lane is kept and kills its victims
        uint32_t settled = 0;
        for (uint32_t rem = word; rem;) {
          const int i = __ffs(rem) - 1;
          settled |= 1u << i;
          rem &= ~(1u << i) & ~__ballot_sync(FULL, (killers >> i) & 1u);
        }
        if (lane == 0) kept_w[q] = settled;
        if ((settled >> lane) & 1u) {
          const int at = __popc(settled & below(lane));
          kb[q & 1][at] = mine;
          if (more) rl[listed + count + at] = mine;
        }
        count += __popc(settled);
      } else if (nk) {
        const int v = warp - 1, first = c + 2;
        for (int w = first + ((v - first) % CLEARERS + CLEARERS) % CLEARERS;
             w < mw; w += CLEARERS) {
          const uint32_t lw = live[w];
          if (lw == 0) continue;
          const bool dead = ((lw >> lane) & 1u) &&
                            any_kills(kc, nk, bx[w * 32 + lane], thresh);
          const uint32_t killed = __ballot_sync(FULL, dead);
          if (lane == 0 && killed) live[w] = lw & ~killed;
        }
      }
      __syncthreads();
    }
    if (warp == 0 && lane == 0) tile_kept = count;

    // keep in the original order, every slot of the tile
    for (int s = threadIdx.x; s < m; s += THREADS)
      rk[ro[start + s]] =
          static_cast<uint8_t>((kept_w[s >> 5] >> (s & 31)) & 1u);
    __syncthreads();
    listed += tile_kept;
    __syncthreads();                          // before the next gather
  }
}

}  // namespace

// keep[b, n] (bool bytes, original order) of the greedy sweep over boxes
// [b, n, 2] f32 (left, right), alive [b, n] bool bytes and order [b, n]
// int64 (the sorted slot's original index), suppressing at IoU >= thresh;
// kept_list is f32 scratch of [b, n, 2].  Launches on `stream` and returns
// the cudaError_t of the launch.
extern "C" int edsnet_nms_sweep(const void* boxes, const void* alive,
                                const void* order, void* keep, void* kept_list,
                                int b, int n, float thresh, void* stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int words = ((n < TILE ? n : TILE) + 31) / 32;
  const size_t smem = static_cast<size_t>(words) *
                      (32 * (sizeof(float2) + sizeof(uint32_t)) +
                       2 * sizeof(uint32_t));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_sweep_kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(boxes), static_cast<const uint8_t*>(alive),
      static_cast<const int64_t*>(order), static_cast<uint8_t*>(keep),
      static_cast<float2*>(kept_list), n, thresh);
  return static_cast<int>(cudaGetLastError());
}
