// TF32 tensor-core products and asynchronous copies for the flash-attention
// kernels (sm_90a), shared by csrc/flash_attention_fwd.cu and
// csrc/flash_attention_bwd.cu.
//
// Products run as `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`:
// a 16 x 8 A tile times an 8 x 8 B tile into a 16 x 8 f32 accumulator,
// all three held in registers of one warp.  With g = lane / 4 and
// t = lane % 4 (the lane's quad and its place in the quad):
//   A: a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]
//   B: b0 = B[t][g], b1 = B[t + 4][g]
//   C: c0 = C[g][2t], c1 = C[g][2t + 1], c2 = C[g + 8][2t], c3 = C[g + 8][2t + 1]
// An accumulator becomes the A operand of the next product without leaving
// registers by renaming the k index: A's column t stands for column 2t of
// the accumulator and column t + 4 for 2t + 1, so (c0, c2, c1, c3) is the
// A fragment, and B's rows t and t + 4 are read from rows 2t and 2t + 1.
//
// Precision.  Each f32 operand x is split in registers into
// big = rna(x) and small = rna(x - big), both TF32 values (10 mantissa
// bits, rounded to nearest with ties away from zero, as cvt.rna.tf32.f32
// rounds).  PASSES = 3 (precision "highest") sums
// a_small * b_big + a_big * b_small + a_big * b_big into one f32
// accumulator; PASSES = 1 (precision "default") runs a_big * b_big alone,
// one TF32 pass with unit roundoff 2^-11 on each operand.  The products of
// TF32 values are exact, but the tensor cores round the accumulator toward
// zero after each mma, a bias that grows with the number of mma steps: at
// 3 passes it, not the split, sets the error on long sums (2.5e-5 on dv
// over N = 2304 rows against 1.8e-6 with sums rounded to nearest, PERF.md).
#pragma once

#include <cstdint>

namespace tf32 {

// x rounded to TF32, to nearest with ties away from zero, as
// cvt.rna.tf32.f32 rounds it for every input but NaN: half an ulp of the
// 13 dropped bits added to the magnitude, then the 13 bits cleared, two
// integer operations at the full integer rate (the cvt instruction issues
// at the lower conversion rate, and with one for every operand element it
// made both kernels a fifth to a quarter slower at 3 passes, PERF.md).
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// rna(x) that stays NaN for a NaN x.  The addition carries a NaN whose
// mantissa is nearly all ones (0x7fffffff, the card's own) into the sign
// and out as a zero, which would hide it from the products; x * 0 + rna(x)
// is rna(x) for every finite x and NaN for a NaN (or infinite) x, one FMA.
__device__ __forceinline__ uint32_t rna_keep_nan(float x) {
  float r;
  asm("fma.rn.f32 %0, %1, 0f00000000, %2;"
      : "=f"(r)
      : "f"(x), "f"(__uint_as_float(rna(x))));
  return __float_as_uint(r);
}

// x rounded by cvt.rna.tf32.f32 itself: one instruction at the conversion
// rate, with NaN kept.
__device__ __forceinline__ uint32_t cvt_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// The big (and, at 3 passes, small) TF32 parts of N f32 values; a NaN
// keeps its big part NaN, so the big * big product carries it.  One pass
// rounds with the cvt instruction (one instruction an element beats three
// on the integer and FMA units); three passes round big with rna_keep_nan
// and small with rna (two cvt instructions an element would wait on the
// conversion rate).
template <int PASSES, int N>
struct Split {
  static_assert(PASSES == 1 || PASSES == 3, "1 or 3 TF32 passes");
  uint32_t big[N];
  uint32_t small[N];
};

template <int PASSES, int N>
__device__ __forceinline__ Split<PASSES, N> split(const float (&x)[N]) {
  Split<PASSES, N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (PASSES == 1) {
      s.big[i] = cvt_rna(x[i]);
    } else {
      s.big[i] = rna_keep_nan(x[i]);
      s.small[i] = rna(x[i] - __uint_as_float(s.big[i]));
    }
  }
  return s;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in PASSES TF32 products, the small terms first.
template <int PASSES>
__device__ __forceinline__ void mma(float (&c)[4], const Split<PASSES, 4>& a,
                                    const Split<PASSES, 2>& b) {
  if constexpr (PASSES == 3) {
    mma(c, a.small, b.big);
    mma(c, a.big, b.small);
  }
  mma(c, a.big, b.big);
}

// The A fragment of a 16 x 8 slice of a row-major f32 tile in shared memory
// (`p` at its top-left element, row stride `ld` floats).
template <int PASSES>
__device__ __forceinline__ Split<PASSES, 4> load_a(const float* p, int ld,
                                                   int g, int t) {
  const float x[4] = {p[g * ld + t], p[(g + 8) * ld + t], p[g * ld + t + 4],
                      p[(g + 8) * ld + t + 4]};
  return split<PASSES>(x);
}

// The B fragment of B = X^T for an 8 x 8 slice of a row-major tile X
// (`p` at its top-left element): b0 = X[g][t], b1 = X[g][t + 4].
template <int PASSES>
__device__ __forceinline__ Split<PASSES, 2> load_bt(const float* p, int ld,
                                                    int g, int t) {
  const float x[2] = {p[g * ld + t], p[g * ld + t + 4]};
  return split<PASSES>(x);
}

// The B fragment of B = X for 8 rows of a row-major tile X under the
// renamed k index (`p` at the slice's first row and column): b0 = X[2t][g],
// b1 = X[2t + 1][g].
template <int PASSES>
__device__ __forceinline__ Split<PASSES, 2> load_b_renamed(const float* p,
                                                           int ld, int g,
                                                           int t) {
  const float x[2] = {p[2 * t * ld + g], p[(2 * t + 1) * ld + g]};
  return split<PASSES>(x);
}

// An accumulator as the A fragment of the next product (renamed k index).
template <int PASSES>
__device__ __forceinline__ Split<PASSES, 4> acc_as_a(const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  return split<PASSES>(x);
}

// N registers that hold TF32 values already, as a one-pass operand.
template <int N>
__device__ __forceinline__ Split<1, N> as_rounded(const float (&x)[N]) {
  Split<1, N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) s.big[i] = __float_as_uint(x[i]);
  return s;
}

// Operands rounded once.  A tile that many products read can be rounded
// once in shared memory instead of at every fragment load: each f32 is
// replaced in place by its big part and, at 3 passes, its small part is
// stored `small` floats further on.  The loads below then read TF32 values
// with no conversion, in the fragment layouts of load_a, load_bt and
// load_b_renamed.
template <int PASSES, int N>
__device__ __forceinline__ Split<PASSES, N> gather(const float* p, int small,
                                                   const int (&off)[N]) {
  Split<PASSES, N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s.big[i] = __float_as_uint(p[off[i]]);
    if constexpr (PASSES == 3)
      s.small[i] = __float_as_uint(p[small + off[i]]);
  }
  return s;
}

template <int PASSES>
__device__ __forceinline__ Split<PASSES, 4> load_a_rounded(const float* p,
                                                           int small, int ld,
                                                           int g, int t) {
  return gather<PASSES>(p, small, {g * ld + t, (g + 8) * ld + t,
                                   g * ld + t + 4, (g + 8) * ld + t + 4});
}

template <int PASSES>
__device__ __forceinline__ Split<PASSES, 2> load_bt_rounded(const float* p,
                                                            int small, int ld,
                                                            int g, int t) {
  return gather<PASSES>(p, small, {g * ld + t, g * ld + t + 4});
}

template <int PASSES>
__device__ __forceinline__ Split<PASSES, 2> load_b_renamed_rounded(
    const float* p, int small, int ld, int g, int t) {
  return gather<PASSES>(p, small, {2 * t * ld + g, (2 * t + 1) * ld + g});
}

// 16-byte copy global -> shared that bypasses L1 (cp.async.cg).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy `rows` rows of `width` floats from global memory (row stride
// `src_ld`) into shared memory (row stride `ld`), 16 bytes a thread at a
// time over `threads` threads.
template <int width, int threads>
__device__ __forceinline__ void copy_tile(float* dst, int ld, const float* src,
                                          int src_ld, int rows, int tid) {
  constexpr int kChunks = width / 4;
  for (int c = tid; c < rows * kChunks; c += threads) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    cp_async16(dst + r * ld + col, src + static_cast<size_t>(r) * src_ld + col);
  }
}

// copy_tile of whole rows: the global row stride is `width`.
template <int width, int threads>
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* src,
                                          int rows, int tid) {
  copy_tile<width, threads>(dst, ld, src, width, rows, tid);
}

// Round in place the chunks that copy_rows<width, threads> gave this
// thread (big in place, small `small` floats further on at 3 passes).  A
// thread reads only what its own copies wrote, so it needs its
// cp_async_wait and no barrier before; one barrier after makes the rounded
// tile visible to the block.
template <int PASSES, int width, int threads>
__device__ __forceinline__ void round_rows(float* tile, int ld, int small,
                                           int rows, int tid) {
  constexpr int kChunks = width / 4;
  for (int c = tid; c < rows * kChunks; c += threads) {
    float* p = tile + (c / kChunks) * ld + (c % kChunks) * 4;
    const float4 x4 = *reinterpret_cast<const float4*>(p);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    const auto s = split<PASSES>(x);
    *reinterpret_cast<float4*>(p) =
        make_float4(__uint_as_float(s.big[0]), __uint_as_float(s.big[1]),
                    __uint_as_float(s.big[2]), __uint_as_float(s.big[3]));
    if constexpr (PASSES == 3)
      *reinterpret_cast<float4*>(p + small) = make_float4(
          __uint_as_float(s.small[0]), __uint_as_float(s.small[1]),
          __uint_as_float(s.small[2]), __uint_as_float(s.small[3]));
  }
}

}  // namespace tf32
