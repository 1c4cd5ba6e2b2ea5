// Fused SRCNN 9-1-5 forward on the bf16 tensor cores, for Hopper (sm_90a):
// the throughput tiers.
//
// Replaces libsrcnn_tpu/kernels/fused_conv.py::_kernel in its bf16 forms:
//   K2  split    precision=DEFAULT, pack=None: every activation split into
//                hi = bf16(x) and lo = bf16(x - hi), two bf16 passes summed
//                in f32 (`_dot`, :121-152, conv3 at :310-320);
//   K3  bf16x1   pack="pair": every operand rounded to bf16 once, one pass
//                (:213-242; the i32 pair words are a Mosaic store
//                workaround and are not carried over);
//   K3n narrow   K3 on a narrower output tile (the NARROW geometry,
//                :60-73); its output is bit-identical to K3's;
//   K3h hilo     pack="hilo": K2's math, with conv1 contracting hi and lo
//                of each tap interleaved along K (depth 162) against
//                row-duplicated bf16(w1) (:243-269, w1 at :730-733).
// All four are instances of one wgmma kernel,
// fused_srcnn_wgmma_bf16_kernel<MODE, TW, STAGE> (MODE SPLIT: two bf16
// passes per GEMM; BF16X1: one; HILO: conv1 in one pass over the
// interleaved hi / lo rows, conv2 and the tap GEMM in two, as SPLIT); K5
// (below) runs the same per-tile body in row bands.
// Per output pixel of an [h, w] plane: conv1 9x9 1->64 + b1, ReLU; conv2
// 1x1 64->32 + b2, ReLU; the reference's c2 border clamp gated by the edge
// flags; conv3 5x5 32->1 + b3, clamp to [0, 255].  Weights are rounded to
// bf16 (round to nearest even, __float2bfloat16_rn) on their way into
// shared memory; biases and every accumulation are f32.
// Input: n Y planes with a 6 px halo, [n, h+12, w+12] f32, contiguous; one
// launch covers the batch.
//
// What bounds them: operations.  8,032 MACs per output pixel, 33.7 G at
// 2048^2: 0.068 ms of the card's 989 TFLOP/s dense bf16 for one pass, 0.14
// ms for the two of the split forms, against 0.01 ms to move the ~34 MB of
// planes.  With one pass (K3) the fixed costs of a tile, the window's
// rounding, the tap-plane stores and the shift-add, weigh as much as the
// GEMMs.
//
// The wgmma kernel (the design of K1, fused_srcnn.cu, in bf16):
// * A persistent grid: min(tiles, SMs) blocks, each walking the TH x TW
//   output tiles of all n planes with a static stride; 64-bit tile walk and
//   offsets.  The next tile's window is copied with cp.async while this
//   tile computes, then rounded once to a bf16 plane (SPLIT: split into
//   bf16 hi and lo planes; HILO: one plane of 32-bit words hi | lo << 16,
//   the TPU kernel's bit layout).
// * The B operands go to shared memory once per block, rounded to bf16, as
//   wgmma's K-major operands without swizzle: w1 [96 x 64] (HILO: [176 x
//   64], each tap's row twice, rows 162..175 zero), w2 [64 x 32], w3 as the
//   tap GEMM [32 x 32] (column n = tap 5 dy + dx, 25..31 zero); 18,432
//   bytes (HILO 28,672).  The weights are not split; in SPLIT and HILO the
//   activations are.
// * M is ring positions: an m64 tile is one ring row of 64 columns (TW 60:
//   K2, K3) or two of 32 (TW 28: K3n), and warpgroup v of NWG takes m64
//   tiles v, v + NWG, ...  The rows g and g + 8 of a lane's fragment are
//   ring columns c and c + 8 of one ring row, so the index math differs
//   between the two widths only in that row and column.
//   wgmma.m64nNk16.f32.bf16.bf16 with A from registers.  SPLIT runs each
//   GEMM as two passes into one f32 accumulator over the whole of K,
//   lo*bf16(w) first, then hi*bf16(w), so the small products meet an empty
//   accumulator (as K1 orders its passes); BF16X1 runs the hi pass alone.
// * conv1's A operand, an im2col into registers.  Its K order pairs the
//   taps (dy, dx) and (dy, dx + 1) of one window row (9 rows x 5 pairs, the
//   pair at dx 8 with a zero row, 45 pairs padded to 48: K 96, the same six
//   k16 steps as 81 taps padded), so each A register, two adjacent k, is
//   one aligned 32-bit shared load: a ring column of odd parity reads a
//   copy of the plane that starts one element later.  HILO's K order is
//   the TPU kernel's: GEMM rows 2t and 2t + 1 are hi and lo of tap t (81
//   taps padded to 88: K 176, 11 k16 steps), so an A register is one word
//   of the hilo plane at any ring column, and no copy is needed.  SPLIT
//   loads the lo fragments first and the hi fragments while the tensor
//   cores run the lo pass; BF16X1 and HILO load the next m64 tile's
//   fragments while they run this one's.
// * conv2 and the tap GEMM take A straight from the previous accumulators:
//   the f32 m64 accumulator of a warp holds columns 2q, 2q + 1 of each
//   8-wide n-group, which is the bf16 A layout of k16 step j / 2 (a0 / a1
//   for even n-groups j, a2 / a3 for odd), so no B row is permuted.  h1 and
//   c2 are rounded (or split) in registers and never touch shared memory;
//   only conv3's 25 tap planes do.
// * The border clamp is K1's coordinate clamp, applied to the tap planes:
//   G at a ring position is a function of that position's c2 alone, so
//   copying G from the clamped position equals clamping c2.  Every mode
//   clamps only the strips that conv3 reads (clamp_strips), which it
//   copies as srcnn_common.cuh's whole-ring ring_clamp would, so the
//   output does not change.  conv3's output is a shift-add of the tap
//   planes, out(y, x) = b3 + sum over (dy, dx) of G[5 dy + dx](y + dy,
//   x + dx), in that fixed order.
// * Every pixel's sums run in one fixed order, whatever tile it sits in,
//   and wgmma rounds a row the same wherever it sits in M: that is what
//   makes K3n and K5 bit-identical to K3, and the chunked path and serving
//   bit-identical to a one-shot pass.
// * Geometry.  K3: 23 x 60 output tile, three warpgroups (384 threads),
//   27 x 64 c2 ring (1.25x recomputation), 35 x 72 window; tap planes
//   173,200 B, B operands 18,432 B, biases 512 B, the f32 window 10,080 B
//   and two bf16 planes of 5,040 B: 213,184 B.  K2: 24 x 60, two
//   warpgroups, 28 x 64 ring (1.24x), four bf16 planes: 230,272 B.  K3h:
//   K2's shape, its w1 22,528 B and one hilo plane of 10,368 B in place
//   of the four: 230,144 B.  K3n: 24 x 28, two warpgroups, 28 x 32 ring
//   (1.33x), 36 x 40 window: 120,576 B.  One block per SM each.  Of K3's
//   24 x 60 with two warpgroups, 16 x 60 with two, and 20 x 60 and 23 x 60
//   with three, 23 x 60 was the fastest (PERF.md).
// * Every parameter comes in through `params`; nothing outlives a launch.
//
// Built with -DSRCNN_PROFILING (a second library, the kernel-profiling
// path of kernels/ablation.py and fused_conv.forward_y_band), the file
// also holds:
// * K5, the row-band geometry (fused_srcnn_band_kernel), replacing
//   fused_conv.py::_kernel_band / _pair_tile (:491-597): K3's per-tile
//   body, one block per band of rows (see the kernel).
// * K6's cuts of K2 and K3: the STAGE template argument stops the kernel
//   after its window and weights are in shared memory (LOAD), after conv1,
//   conv2 or the tap GEMM (TAPS); srcnn_common.cuh says what a cut writes.
//   The TPU tool's roll and im2col stages have no counterpart: there is no
//   lane rotate, and conv1's im2col is done in registers.  The production
//   kernels are the FULL instances.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "srcnn_common.cuh"
#include "srcnn_wgmma.cuh"

namespace {

using namespace srcnn;

// The wgmma kernel's modes.  chip_smoke.py reads the values from the
// instances' names in the SASS.
enum Mode { SPLIT = 0, BF16X1 = 1, HILO = 2 };

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (x0, x1) -> one register of two bf16, x0 in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return bf16_bits(x0) | (bf16_bits(x1) << 16);
}

// ---- the wgmma kernel: K2, K3, K3h, K3n (see the file's notes) ------------

namespace wg {

constexpr int NPAIR = 45;                 // conv1's taps as pairs: 9 rows x 5
constexpr int KS2 = C1 / 16, KS3 = C2 / 16;  // conv2's, the tap GEMM's k16 steps
constexpr int NG = 32;                    // the tap GEMM's N, 25 taps padded

// An instance's geometry and shared memory (bytes).  A B operand of K rows
// and N columns takes (K / 8) * (N / 8) core matrices of 128 bytes.
template <int MODE, int TW>
struct Geo {
  static constexpr int mode = MODE;
  static constexpr bool K3 = MODE == BF16X1 && TW == 60;
  static constexpr int TH = K3 ? 23 : 24;           // output tile rows (K5: K3's)
  static constexpr int NWG = K3 ? 3 : 2;            // warpgroups per block
  static constexpr int NT = 128 * NWG;              // threads per block
  // bf16 passes per GEMM (HILO's conv1 takes one, over hi and lo rows)
  static constexpr int NP = MODE == BF16X1 ? 1 : 2;
  // conv1's K: the 45 tap pairs padded to 48, or HILO's 81 (hi, lo) row
  // pairs padded to 88; and its k16 steps (6 or 11)
  static constexpr int K1P = MODE == HILO ? 176 : 96;
  static constexpr int KS1 = K1P / 16;
  static constexpr int RH = TH + 4, RW = TW + 4;    // c2 ring tile
  static constexpr int WH = RH + 8, WW = RW + 8;    // input window
  static constexpr int RPM = 64 / RW;               // ring rows per m64 tile
  static constexpr int MT = RH / RPM;               // m64 tiles in the ring
  static constexpr int GS = RH * RW + 4;            // tap-plane stride: spreads banks
  static constexpr int B_G = 25 * GS * 4;
  static constexpr int B_W1 = K1P * C1 * 2;
  static constexpr int B_W2 = C1 * C2 * 2;
  static constexpr int B_W3 = C2 * NG * 2;
  static constexpr int B_BIAS = 512;                // b1 [64], b2 [32], b3
  static constexpr int B_RAW = WH * WW * 4;
  static constexpr int B_PLANE = WH * WW * 2;       // one bf16 window plane
  // the rounded window: planes hi, hi from +1 (SPLIT: then lo, lo from +1);
  // HILO's one plane of 32-bit words takes two planes' bytes
  static constexpr int B_WIN = (MODE == SPLIT ? 4 : 2) * B_PLANE;
  static constexpr int SM_W1 = (B_G + 1023) / 1024 * 1024;
  static constexpr int SM_W2 = SM_W1 + B_W1;
  static constexpr int SM_W3 = SM_W2 + B_W2;
  static constexpr int SM_BIAS = SM_W3 + B_W3;
  static constexpr int SM_RAW = SM_BIAS + B_BIAS;
  static constexpr int SM_WIN = SM_RAW + B_RAW;
  static constexpr size_t SMEM = SM_WIN + B_WIN;
  static_assert((RW == 64 || RW == 32) && RH % RPM == 0 && WW % 2 == 0,
                "m64 tiles of whole ring rows");
  // more than half of the 232,448 B an SM holds: one block per SM
  static_assert(SMEM <= 232448 && 2 * SMEM > 232448 && B_PLANE % 16 == 0,
                "shared memory");
};

// (x0, x1) -> hi = bf16(x) and lo = bf16(x - hi), two per register, x0 in
// the low halves; x - hi is exact in f32
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h2);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
}

// (x0, x1) -> bf16(x), two per register, x0 in the low half
__device__ __forceinline__ uint32_t round_pair(float x0, float x1) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h2);
}

// Word index of elements (k, k + 1), k even, of a K-major bf16 B operand
// with KC = K / 8 core matrices along K: core matrix (n / 8, k / 8), row
// n % 8, word (k % 8) / 2.
template <int KC>
__device__ __forceinline__ int b_word2(int k, int n) {
  return (((n >> 3) * KC + (k >> 3)) << 5) + ((n & 7) << 2) + ((k & 7) >> 1);
}

// The three GEMMs' B operands, rounded to bf16, and the biases.  conv1's
// GEMM row k is tap (dy, dx) = (p / 5, 2 (p % 5) + k % 2) of pair p = k / 2
// (zero past dx 8 and past pair 44); in HILO, tap k / 2 (rows 2t and
// 2t + 1 meet tap t's hi and lo; zero past tap 80).  Every row is written,
// the zero ones too.
template <class G>
__device__ void stage_params(const float* __restrict__ params,
                             unsigned char* smem, int t) {
  uint32_t* w1 = reinterpret_cast<uint32_t*>(smem + G::SM_W1);
  uint32_t* w2 = reinterpret_cast<uint32_t*>(smem + G::SM_W2);
  uint32_t* w3 = reinterpret_cast<uint32_t*>(smem + G::SM_W3);
  float* bias = reinterpret_cast<float*>(smem + G::SM_BIAS);
  constexpr int NT = G::NT;
  for (int i = t; i < G::K1P / 2 * C1; i += NT) {
    const int p = i / C1, n = i % C1;     // GEMM rows 2p, 2p + 1; column n
    float v0 = 0.f, v1 = 0.f;
    if constexpr (G::mode == HILO) {
      if (p < 81) v0 = v1 = params[OFF_W1 + p * C1 + n];
    } else if (p < NPAIR) {
      const int dx = 2 * (p % 5), tap = (p / 5) * 9 + dx;
      v0 = params[OFF_W1 + tap * C1 + n];
      if (dx + 1 < 9) v1 = params[OFF_W1 + (tap + 1) * C1 + n];
    }
    w1[b_word2<G::K1P / 8>(2 * p, n)] = pack_bf16(v0, v1);
  }
  for (int i = t; i < C1 / 2 * C2; i += NT) {       // row k = h1 channel k
    const int k = 2 * (i / C2), n = i % C2;
    w2[b_word2<C1 / 8>(k, n)] = pack_bf16(params[OFF_W2 + k * C2 + n],
                                          params[OFF_W2 + (k + 1) * C2 + n]);
  }
  for (int i = t; i < C2 / 2 * NG; i += NT) {       // row k = c2 channel k,
    const int k = 2 * (i / NG), n = i % NG;         // column n = tap 5 dy + dx
    const float* w3p = params + OFF_W3 + n * C2 + k;
    w3[b_word2<C2 / 8>(k, n)] = n < 25 ? pack_bf16(w3p[0], w3p[1]) : 0u;
  }
  for (int i = t; i < C1 + C2 + 1; i += NT)
    bias[i] = i < C1 ? params[OFF_B1 + i]
                     : i < C1 + C2 ? params[OFF_B2 + i - C1] : params[OFF_B3];
}

// The window, rounded once to bf16 (SPLIT: split into hi and lo planes):
// each plane, and again from element 1 on, so that a tap pair that starts
// at an odd element is an aligned word there.  HILO: one plane of words
// bf16(x) | bf16(x - bf16(x)) << 16, hi in the low half (x - hi is exact
// in f32).
template <class G>
__device__ __forceinline__ void round_window(const float* raw, unsigned char* win,
                                             int t) {
  constexpr int N = G::WH * G::WW;
  uint16_t* hi = reinterpret_cast<uint16_t*>(win);
  uint16_t* hi1 = reinterpret_cast<uint16_t*>(win + G::B_PLANE);
  uint16_t* lo = reinterpret_cast<uint16_t*>(win + 2 * G::B_PLANE);
  uint16_t* lo1 = reinterpret_cast<uint16_t*>(win + 3 * G::B_PLANE);
  for (int i = t; i < N; i += G::NT) {
    const float v = raw[i];
    const uint16_t hb = bf16_bits(v);
    if constexpr (G::mode == HILO) {
      reinterpret_cast<uint32_t*>(win)[i] = hb | (bf16_bits(v - bf16_round(v)) << 16);
    } else if constexpr (G::NP == 2) {
      const uint16_t lb = bf16_bits(v - bf16_round(v));
      hi[i] = hb;
      lo[i] = lb;
      if (i > 0) {
        hi1[i - 1] = hb;
        lo1[i - 1] = lb;
      } else {
        hi1[N - 1] = lo1[N - 1] = 0;
      }
    } else {
      hi[i] = hb;
      if (i > 0)
        hi1[i - 1] = hb;
      else
        hi1[N - 1] = 0;
    }
  }
}

// d += a * b over the KS k16 steps, committed as one group
template <int KS, int NREG>
__device__ __forceinline__ void bf16_pass(float (&d)[NREG], const uint32_t (&a)[KS][4],
                                          uint64_t b) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if constexpr (NREG == 32)
      wgmma_n64_bf16(d, a[s], at_step(b, s));
    else
      wgmma_n32_bf16(d, a[s], at_step(b, s));
  }
  wgmma_commit();
}

// One GEMM of a warpgroup's m64 tile, d = a * b.  NP 2 (split-bf16x2): lo*b
// over all of K, then + hi*b, in one f32 accumulator (the small products
// meet an empty one); `fill_hi` fills ah while the tensor cores run the lo
// pass.  NP 1 (bf16x1): hi*b alone; al is not read.
template <int NP, int KS, int NREG, typename FillHi>
__device__ __forceinline__ void gemm(float (&d)[NREG], uint32_t (&ah)[KS][4],
                                     uint32_t (&al)[KS][4], uint64_t b,
                                     FillHi fill_hi) {
#pragma unroll
  for (int i = 0; i < NREG; ++i) d[i] = 0.f;
  if constexpr (NP == 2) bf16_pass(d, al, b);
  fill_hi(ah);
  bf16_pass(d, ah, b);
  wgmma_wait<0>();
  fence_regs(d);
  fence_regs(ah);
  if constexpr (NP == 2) fence_regs(al);
}

// Accumulators -> the next GEMM's A fragments.  The f32 accumulator of an
// m64nN tile holds, in n-group j, rows (g, g + 8) x columns (8j + 2q, 8j +
// 2q + 1): the bf16 A layout of k16 step j / 2 (a0 / a1 for even j, a2 /
// a3 for odd j), so no B row is permuted.  relu(acc + bias), rounded (NP
// 1) or split (NP 2; al is written only then); a cut's per-row sums.
template <int NP, int NS>
__device__ __forceinline__ void epilogue(const float (&acc)[8 * NS], const float* bias,
                                         int q, uint32_t (&ah)[NS][4],
                                         uint32_t (&al)[NS][4], float& sum0,
                                         float& sum8) {
#pragma unroll
  for (int j = 0; j < 2 * NS; ++j) {
    const int c = 8 * j + 2 * q, s = j / 2, r = 2 * (j % 2);
    const float v0 = fmaxf(acc[4 * j + 0] + bias[c], 0.f);
    const float v1 = fmaxf(acc[4 * j + 1] + bias[c + 1], 0.f);
    const float v2 = fmaxf(acc[4 * j + 2] + bias[c], 0.f);
    const float v3 = fmaxf(acc[4 * j + 3] + bias[c + 1], 0.f);
    sum0 += v0 + v1;
    sum8 += v2 + v3;
    if constexpr (NP == 2) {
      split_pair(v0, v1, ah[s][r], al[s][r]);
      split_pair(v2, v3, ah[s][r + 1], al[s][r + 1]);
    } else {
      ah[s][r] = round_pair(v0, v1);
      ah[s][r + 1] = round_pair(v2, v3);
    }
  }
}

struct BDescs {
  uint64_t w1, w2, w3;
};

template <class G>
__device__ __forceinline__ BDescs b_descs(const unsigned char* smem) {
  return {b_desc(smem + G::SM_W1, (G::K1P / 8) * 128),
          b_desc(smem + G::SM_W2, (C1 / 8) * 128),
          b_desc(smem + G::SM_W3, (C2 / 8) * 128)};
}

// conv1, conv2 and the tap GEMM over the tile's c2 ring, from the rounded
// (or split) window: the 25 tap planes into gs.  Warpgroup wg takes m64
// tiles wg, wg + NWG, ... below `mtiles` (G::MT, all of the ring, but for
// a K5 tile cut at its band's end).  A cut (STAGE < FULL) writes its
// per-pixel value to `out` instead and leaves gs alone.
template <int MODE, int TW, int STAGE>
__device__ __forceinline__ void ring_gemms(const unsigned char* win,
                                           const float* b1s, const BDescs& bd,
                                           float* gs, float* __restrict__ out,
                                           int r0, int q0, int h, int w, int t,
                                           int mtiles) {
  using G = Geo<MODE, TW>;
  constexpr int NP = G::NP, KS1 = G::KS1, TH = G::TH, RW = G::RW, WW = G::WW;
  constexpr int GS = G::GS;
  constexpr bool HL = MODE == HILO;
  const float* b2s = b1s + C1;
  const int wg = t / 128, warp = (t % 128) / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;   // fragment row group, column pair
  // Rows g and g + 8 of this lane's fragments in m64 tile m are ring row
  // RPM m + arow, columns col and col + 8.
  const int arow = G::RPM == 1 ? 0 : warp / 2;
  const int col = (G::RPM == 1 ? 16 * warp : 16 * (warp % 2)) + g;
  // Ring column col's tap pairs start at elements of its parity; an odd
  // one reads the planes that start at element 1, where they are even.
  // HILO's plane holds one tap per word: any column is aligned.
  const int par = HL ? 0 : col & 1;
  const uint32_t* wh = reinterpret_cast<const uint32_t*>(win + par * G::B_PLANE);
  const uint32_t* wl = reinterpret_cast<const uint32_t*>(win + (2 + par) * G::B_PLANE);
  // words per window row, and from ring column col to col + 8
  constexpr int WPR = HL ? WW : WW / 2, C8 = HL ? 8 : 4;
  // the word of ring row a, column col (tap 0 of its window)
  const auto word_at = [&](int a) { return HL ? a * WW + col : (a * WW + col - par) / 2; };

  // word offsets of what this lane feeds to conv1's A fragments, columns
  // 2q, 2q + 1 and 2q + 8, 2q + 9 of k16 step s: pairs 8s + q and 8s + q +
  // 4 (pairs past 44 read pair 0: finite, and their weights are zero); in
  // HILO taps 8s + q and 8s + q + 4, hi and lo (taps past 80 read tap 80)
  int toff[KS1][2];
#pragma unroll
  for (int s = 0; s < KS1; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (HL) {
        const int tap = min(8 * s + q + 4 * i, 80);
        toff[s][i] = (tap / 9) * WW + tap % 9;
      } else {
        int p = 8 * s + q + 4 * i;
        p = p < NPAIR ? p : 0;
        toff[s][i] = ((p / 5) * WW + 2 * (p % 5)) / 2;
      }
    }

  // conv1's A fragments of one plane, from word `base` (ring row a, column
  // col): rows (g, g + 8) of k16 step s are ring columns (col, col + 8),
  // C8 words apart
  const auto im2col = [&](const uint32_t* plane, int base, uint32_t (&frag)[KS1][4]) {
#pragma unroll
    for (int s = 0; s < KS1; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        frag[s][2 * i] = plane[base + toff[s][i]];
        frag[s][2 * i + 1] = plane[base + toff[s][i] + C8];
      }
  };
  // BF16X1 and HILO: the A fragments of this warpgroup's m64 tile; the
  // next tile's are loaded while the tensor cores run this one's conv1
  uint32_t cur[KS1][4];
  if constexpr (MODE != SPLIT)
    if (wg < mtiles) im2col(wh, word_at(G::RPM * wg + arow), cur);

#pragma unroll 1
  for (int m = wg; m < mtiles; m += G::NWG) {
    const int a = G::RPM * m + arow;      // this lane's ring row
    float cut0 = 0.f, cut8 = 0.f;         // a cut's sums of rows g, g + 8
    // a cut's store: row g of this m64 tile is ring column col, row g + 8
    // eight columns to its right
    const auto store_cut = [&](float v0, float v8) {
      v0 = quad_sum(v0);
      v8 = quad_sum(v8);
      if (q == 0) {
        cut_store(out, a, col, r0, q0, TH, TW, h, w, v0);
        cut_store(out, a, col + 8, r0, q0, TH, TW, h, w, v8);
      }
    };
    const int base = word_at(a);

    // ---- conv1: [64 x 96] x [96 x 64] (HILO: [64 x 176] x [176 x 64]);
    // in SPLIT the hi fragments are loaded while the lo pass runs, in
    // BF16X1 and HILO the next tile's ----
    float acc1[32];
    if constexpr (MODE == SPLIT) {
      uint32_t ah[KS1][4], al[KS1][4];
      im2col(wl, base, al);
      gemm<NP>(acc1, ah, al, bd.w1,
               [&](uint32_t (&f)[KS1][4]) { im2col(wh, base, f); });
    } else {
      uint32_t nxt[KS1][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc1[i] = 0.f;
      bf16_pass(acc1, cur, bd.w1);
      if (m + G::NWG < mtiles) im2col(wh, base + G::RPM * G::NWG * WPR, nxt);
      wgmma_wait<0>();
      fence_regs(acc1);
      fence_regs(cur);
      fence_regs(nxt);
#pragma unroll
      for (int s = 0; s < KS1; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) cur[s][i] = nxt[s][i];
    }
    // ---- h1 = ReLU(conv1 + b1) -> conv2's A fragments ----
    uint32_t hh[KS2][4], hl[KS2][4];
    epilogue<NP, KS2>(acc1, b1s, q, hh, hl, cut0, cut8);
    if constexpr (STAGE == CONV1) {       // cut: sum of the 64 h1 channels
      store_cut(cut0, cut8);
      continue;
    }

    // ---- conv2: [64 x 64] x [64 x 32] ----
    float acc2[16];
    gemm<NP>(acc2, hh, hl, bd.w2, [](uint32_t (&)[KS2][4]) {});
    uint32_t ch[KS3][4], cl[KS3][4];
    cut0 = cut8 = 0.f;
    epilogue<NP, KS3>(acc2, b2s, q, ch, cl, cut0, cut8);
    if constexpr (STAGE == CONV2) {       // cut: sum of the 32 c2 channels
      store_cut(cut0, cut8);
      continue;
    }

    // ---- conv3's tap products: [64 x 32] x [32 x 25 (32)] ----
    float acc3[16];
    gemm<NP>(acc3, ch, cl, bd.w3, [](uint32_t (&)[KS3][4]) {});
    if constexpr (STAGE == TAPS) {        // cut: sum of the 25 taps
      cut0 = cut8 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 8 * j + 2 * q;
        if (k < 25) {
          cut0 += acc3[4 * j];
          cut8 += acc3[4 * j + 2];
        }
        if (k + 1 < 25) {
          cut0 += acc3[4 * j + 1];
          cut8 += acc3[4 * j + 3];
        }
      }
      store_cut(cut0, cut8);
      continue;
    }

    // ---- the 25 tap planes -> shared memory ----
    const int pos = a * RW + col;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 8 * j + 2 * q;
      if (k < 25) {
        gs[k * GS + pos] = acc3[4 * j];
        gs[k * GS + pos + 8] = acc3[4 * j + 2];
      }
      if (k + 1 < 25) {
        gs[(k + 1) * GS + pos] = acc3[4 * j + 1];
        gs[(k + 1) * GS + pos + 8] = acc3[4 * j + 3];
      }
    }
  }
}

// The reference's border clamp (srcnn_common.cuh's ring_clamp) on the tap
// planes of a tile, over what conv3_out reads alone: ring rows
// below nr = min(RH, h_end - r0 + 4) and columns below nc, and of those
// only the positions outside the clamp box, at most two rows or columns on
// each side.  A position there takes the values of the clamped position,
// which lies in the box and is never itself rewritten.  ring_clamp walks
// the whole ring at each edge tile; a K5 band on the plane's top or bottom
// edge meets one at every column tile.  Ends with __syncthreads() when it
// ran, so every thread of the block must call it.
template <class G>
__device__ __forceinline__ void clamp_strips(float* gs, int r0, int q0, int h_end,
                                             int h, int w, int f_top, int f_bottom,
                                             int f_left, int f_right, int t) {
  constexpr int RW = G::RW, GS = G::GS;
  // the box in ring coordinates: rows a0 .. a1, columns b0 .. b1
  const int a0 = (f_top ? 0 : -2) - r0 + 2, a1 = (f_bottom ? h - 1 : h + 1) - r0 + 2;
  const int b0 = (f_left ? 0 : -2) - q0 + 2, b1 = (f_right ? w - 1 : w + 1) - q0 + 2;
  const int nr = min(G::RH, h_end - r0 + 4), nc = min(RW, w - q0 + 4);
  // rows [0, top) and [bot, nr) lie outside; columns [0, left), [right, nc)
  const int top = max(0, min(a0, nr)), bot = max(top, min(a1 + 1, nr));
  const int left = max(0, min(b0, nc)), right = max(left, min(b1 + 1, nc));
  const int orows = top + nr - bot, ocols = left + nc - right;
  if (orows == 0 && ocols == 0) return;
  // the outside rows, every column
  for (int s = t; s < 25 * orows * nc; s += G::NT) {
    const int c = s / (orows * nc), i = s % (orows * nc) / nc, b = s % nc;
    const int a = i < top ? i : bot + i - top;
    const int sa = min(max(a, a0), a1), sb = min(max(b, b0), b1);
    gs[c * GS + a * RW + b] = gs[c * GS + sa * RW + sb];
  }
  // the outside columns of the rows in the box
  const int mid = bot - top;
  for (int s = t; s < 25 * mid * ocols; s += G::NT) {
    const int c = s / (mid * ocols), a = top + s % (mid * ocols) / ocols;
    const int j = s % ocols, b = j < left ? j : right + j - left;
    gs[c * GS + a * RW + b] = gs[c * GS + a * RW + min(max(b, b0), b1)];
  }
  __syncthreads();
}

// conv3: shift-add of the (clamped) tap planes, + b3, clamp to [0, 255];
// output rows r0 .. below `h_end` and columns below w.  K1's
// (fused_srcnn.cu), not inlined for the same reason.
template <class G>
__device__ __noinline__ void conv3_out(const float* gs, float b3,
                                       float* __restrict__ out, int r0, int q0,
                                       int h_end, int w, int t) {
  constexpr int TW = G::RW - 4, RW = G::RW, GS = G::GS;
  const int rows = min(G::TH, h_end - r0);  // K5: a tile cut at its band's end
  for (int s = t; s < rows * TW; s += G::NT) {
    const int ty = s / TW, tx = s % TW;
    const float* gp = gs + ty * RW + tx;
    float o = 0.f;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy)
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) o += gp[(dy * 5 + dx) * GS + dy * RW + dx];
    const int orow = r0 + ty, ocol = q0 + tx;
    if (orow < h_end && ocol < w)
      out[static_cast<long long>(orow) * w + ocol] = fminf(fmaxf(o + b3, 0.f), 255.f);
  }
}

template <int MODE, int TW, int STAGE = FULL>
__global__ void __launch_bounds__(Geo<MODE, TW>::NT, 1)
fused_srcnn_wgmma_bf16_kernel(const float* __restrict__ y,
                              const float* __restrict__ params,
                              float* __restrict__ out, int n, int h, int w,
                              int f_top, int f_bottom, int f_left, int f_right) {
  using G = Geo<MODE, TW>;
  constexpr int TH = G::TH, NT = G::NT;
  static_assert(MODE != HILO || STAGE == FULL, "K3h has no cuts");
  extern __shared__ __align__(1024) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);                 // [25][GS]
  const float* b1s = reinterpret_cast<const float*>(smem + G::SM_BIAS);
  float* raw = reinterpret_cast<float*>(smem + G::SM_RAW);    // [WH][WW]
  unsigned char* win = smem + G::SM_WIN;

  const int t = threadIdx.x;
  const int tr = (h + TH - 1) / TH, tc = (w + TW - 1) / TW;
  const long long tiles = static_cast<long long>(tr) * tc * n;

  long long tile = blockIdx.x;
  fetch_window<G::WH, G::WW, NT>(raw, y, tile_at<TH, TW>(tile, tr, tc), h, w, t);
  stage_params<G>(params, smem, t);
  // the B operands are read by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const BDescs bd = b_descs<G>(smem);

  for (; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_at<TH, TW>(tile, tr, tc);
    float* po = out + static_cast<long long>(tl.plane) * h * w;

    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    round_window<G>(raw, win, t);
    __syncthreads();
    if (tile + gridDim.x < tiles)         // the next tile's window, meanwhile
      fetch_window<G::WH, G::WW, NT>(raw, y, tile_at<TH, TW>(tile + gridDim.x, tr, tc),
                                     h, w, t);

    if constexpr (STAGE == LOAD) {        // cut: the centre tap as rounded (split)
      const uint16_t* hi = reinterpret_cast<const uint16_t*>(win);
      const uint16_t* lo = reinterpret_cast<const uint16_t*>(win + 2 * G::B_PLANE);
      for (int s = t; s < TH * TW; s += NT) {
        const int a = s / TW + 2, b = s % TW + 2;
        const int i = (a + 4) * G::WW + b + 4;
        float v = __bfloat162float(__ushort_as_bfloat16(hi[i]));
        if constexpr (G::NP == 2) v += __bfloat162float(__ushort_as_bfloat16(lo[i]));
        cut_store(po, a, b, tl.r0, tl.q0, TH, TW, h, w, v);
      }
    } else {
      ring_gemms<MODE, TW, STAGE>(win, b1s, bd, gs, po, tl.r0, tl.q0, h, w, t, G::MT);
    }
    __syncthreads();
    if constexpr (STAGE == FULL) {
      // border clamp on the ring's tap planes (global c2 rows r0-2 ..
      // r0+RH-3), then conv3
      clamp_strips<G>(gs, tl.r0, tl.q0, h, h, w, f_top, f_bottom, f_left, f_right, t);
      conv3_out<G>(gs, b1s[C1 + C2], po, tl.r0, tl.q0, h, w, t);
      __syncthreads();                    // G and the window are rewritten next
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int MODE, int TW, int STAGE>
cudaError_t launch(const float* y, float* out, const float* params, int n,
                   int h, int w, int f_top, int f_bottom, int f_left,
                   int f_right, cudaStream_t stream) {
  using G = Geo<MODE, TW>;
  const auto kernel = fused_srcnn_wgmma_bf16_kernel<MODE, TW, STAGE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (e != cudaSuccess) return e;
  int grid = 0;                           // one block per SM
  if ((e = persistent_grid<G::TH, TW>(n, h, w, &grid)) != cudaSuccess) return e;
  kernel<<<grid, G::NT, G::SMEM, stream>>>(y, params, out, n, h, w, f_top,
                                           f_bottom, f_left, f_right);
  return cudaGetLastError();
}

#ifdef SRCNN_PROFILING
// Issue the cp.async copies of columns c0 .. WW-1 of the window of the
// tile at output (r0, q0), padded rows r0 .. r0+WH-1 and cols q0 .. q0+WW-1
// of the plane at yp, into `raw`, as one group.  Reads past the plane are
// clamped in; they feed only masked outputs.
template <class G>
__device__ __forceinline__ void fetch_cols(float* raw, const float* __restrict__ yp,
                                           int r0, int q0, int c0, int ph, int pw,
                                           int t) {
  const int nc = G::WW - c0;
  for (int i = t; i < G::WH * nc; i += G::NT) {
    const int r = i / nc, c = c0 + i % nc;
    const int pr = min(r0 + r, ph - 1), pc = min(q0 + c, pw - 1);
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(raw + r * G::WW + c));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(yp + static_cast<long long>(pr) * pw + pc)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// K5, the row-band launch geometry of K3: one block per band of `tile_h`
// output rows and plane, which covers its band with K3's tiles (the last
// one cut at the band's end, computing only the ring rows it needs) and
// walks each tile row's column tiles left to right.  The B operands and
// biases are staged once per band.  The window is a rolling one: of a
// column tile's 72-column window, the 12 columns it shares with the tile
// before are moved along in shared memory and only the 60 new ones are
// read, with cp.async while the tile before computes.  Every pixel runs
// K3's body (ring_gemms, clamp_strips, conv3_out) in K3's order, so the
// output equals K3's bit for bit.
__global__ void __launch_bounds__(Geo<BF16X1, 60>::NT, 1)
fused_srcnn_band_kernel(const float* __restrict__ y,
                        const float* __restrict__ params,
                        float* __restrict__ out, int h, int w, int tile_h,
                        int f_top, int f_bottom, int f_left, int f_right) {
  constexpr int TW = 60;
  using G = Geo<BF16X1, TW>;
  constexpr int TH = G::TH, NT = G::NT, WW = G::WW, KEEP = WW - TW;
  extern __shared__ __align__(1024) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);
  const float* b1s = reinterpret_cast<const float*>(smem + G::SM_BIAS);
  float* raw = reinterpret_cast<float*>(smem + G::SM_RAW);
  unsigned char* win = smem + G::SM_WIN;

  const int t = threadIdx.x;
  const int band0 = blockIdx.x * tile_h;  // the band's output rows
  const int band1 = min(band0 + tile_h, h);
  const int ph = h + 2 * HALO, pw = w + 2 * HALO;
  const float* yp = y + static_cast<long long>(blockIdx.z) * ph * pw;
  float* po = out + static_cast<long long>(blockIdx.z) * h * w;

  fetch_cols<G>(raw, yp, band0, 0, 0, ph, pw, t);
  stage_params<G>(params, smem, t);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const BDescs bd = b_descs<G>(smem);

  for (int r0 = band0; r0 < band1; r0 += TH) {
    const int rows = min(TH, band1 - r0) + 4;       // ring rows: m64 tiles
    for (int q0 = 0; q0 < w; q0 += TW) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      round_window<G>(raw, win, t);
      __syncthreads();
      // the next tile's window, meanwhile
      if (q0 + TW < w) {
        for (int i = t; i < G::WH * KEEP; i += NT) {
          const int r = i / KEEP, c = i % KEEP;
          raw[r * WW + c] = raw[r * WW + TW + c];
        }
        __syncthreads();
        fetch_cols<G>(raw, yp, r0, q0 + TW, KEEP, ph, pw, t);
      } else if (r0 + TH < band1) {
        fetch_cols<G>(raw, yp, r0 + TH, 0, 0, ph, pw, t);
      }
      ring_gemms<BF16X1, TW, FULL>(win, b1s, bd, gs, po, r0, q0, h, w, t, rows);
      __syncthreads();
      clamp_strips<G>(gs, r0, q0, band1, h, w, f_top, f_bottom, f_left, f_right, t);
      conv3_out<G>(gs, b1s[C1 + C2], po, r0, q0, band1, w, t);
      __syncthreads();                    // G and the window are rewritten next
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
#endif  // SRCNN_PROFILING

}  // namespace wg
}  // namespace

extern "C" {

int srcnn_bf16_n_params() { return N_PARAMS; }

// The tile walk is 64-bit and the grid has one block per SM, so the limit
// is the int row arithmetic of a tile (r0 + WH, h + 2 HALO), at the file's
// tallest tile and window (K2's, K3h's and K3n's: 24 rows, 36).
int srcnn_bf16_max_rows() {
  using G = wg::Geo<SPLIT, 60>;
  static_assert(G::TH >= wg::Geo<BF16X1, 60>::TH && G::WH == wg::Geo<BF16X1, 28>::WH &&
                    G::WH == wg::Geo<HILO, 60>::WH,
                "K2's tile is the tallest");
  return INT_MAX - G::WH - 2 * HALO - G::TH;
}

// kernel: 0 = K2 (split), 1 = K3 (bf16x1), 2 = K3h (split, hi/lo-packed
// conv1), 3 = K3n (bf16x1, narrow tile).  y: [n, h+12, w+12] f32, out:
// [n, h, w] f32, both contiguous; params: N_PARAMS f32 in the packed
// layout; all on the current device.  Launches on `stream`; returns the
// cudaError_t of the set-up or the launch (0 on success).  n <= 65535.
int srcnn_bf16_forward(const float* y, float* out, const float* params,
                       int n, int h, int w, int f_top, int f_bottom,
                       int f_left, int f_right, int kernel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kernel) {
    case 0:
      return wg::launch<SPLIT, 60, FULL>(y, out, params, n, h, w, f_top,
                                         f_bottom, f_left, f_right, s);
    case 1:
      return wg::launch<BF16X1, 60, FULL>(y, out, params, n, h, w, f_top,
                                          f_bottom, f_left, f_right, s);
    case 2:
      return wg::launch<HILO, 60, FULL>(y, out, params, n, h, w, f_top,
                                        f_bottom, f_left, f_right, s);
    case 3:
      return wg::launch<BF16X1, 28, FULL>(y, out, params, n, h, w, f_top,
                                          f_bottom, f_left, f_right, s);
    default:
      return cudaErrorInvalidValue;
  }
}

#ifdef SRCNN_PROFILING
// The profiling cuts of K2 (kernel 0) and K3 (kernel 1): as
// srcnn_bf16_forward, stopped after `stage` (LOAD, CONV1, CONV2, TAPS or
// FULL).
int srcnn_bf16_cut_forward(const float* y, float* out, const float* params,
                           int n, int h, int w, int f_top, int f_bottom,
                           int f_left, int f_right, int kernel, int stage,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SRCNN_CUT(M, S)                                                   \
  case S:                                                                 \
    return wg::launch<M, 60, S>(y, out, params, n, h, w, f_top, f_bottom, \
                                f_left, f_right, s);
#define SRCNN_CUTS(M)                                                     \
  switch (stage) {                                                        \
    SRCNN_CUT(M, LOAD)                                                    \
    SRCNN_CUT(M, CONV1)                                                   \
    SRCNN_CUT(M, CONV2)                                                   \
    SRCNN_CUT(M, TAPS)                                                    \
    SRCNN_CUT(M, FULL)                                                    \
    default:                                                              \
      return cudaErrorInvalidValue;                                       \
  }
  if (kernel == 0) SRCNN_CUTS(SPLIT)
  if (kernel == 1) SRCNN_CUTS(BF16X1)
#undef SRCNN_CUTS
#undef SRCNN_CUT
  return cudaErrorInvalidValue;
}

// K5: y, out, params as srcnn_bf16_forward; tile_h >= 1 output rows per
// band, one block per band and plane.
int srcnn_bf16_band_forward(const float* y, float* out, const float* params,
                            int n, int h, int w, int f_top, int f_bottom,
                            int f_left, int f_right, int tile_h,
                            void* stream) {
  if (tile_h < 1) return cudaErrorInvalidValue;
  using G = wg::Geo<BF16X1, 60>;
  cudaError_t e = cudaFuncSetAttribute(
      wg::fused_srcnn_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((h + tile_h - 1) / tile_h, 1, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wg::fused_srcnn_band_kernel<<<grid, G::NT, G::SMEM, s>>>(
      y, params, out, h, w, tile_h, f_top, f_bottom, f_left, f_right);
  return cudaGetLastError();
}
#endif  // SRCNN_PROFILING

}  // extern "C"
