// Fused SRCNN 9-1-5 forward, exact tier, for Hopper (sm_90a): 3xTF32 on the
// tensor cores through wgmma.
//
// Replaces libsrcnn_tpu/kernels/fused_conv.py::_kernel at
// precision=HIGHEST (pack=None), the Pallas kernel of the exact tier, whose
// GEMMs are one dot_general each at Precision.HIGHEST: Mosaic's multi-pass
// exact-f32 algorithm on the MXU (`_dot`, :121-144, and conv3 at :303-309).
// One launch computes, per output pixel of an [h, w] plane:
//   conv1 9x9 1->64 + b1, ReLU;  conv2 1x1 64->32 + b2, ReLU;
//   the reference's conv2-output border clamp (libsrcnn.cpp:463-489);
//   conv3 5x5 32->1 + b3, clamp to [0, 255].
// Input: n Y planes with a 6 px halo, [n, h+12, w+12] f32, contiguous; one
// launch covers the batch.
//
// The arithmetic: 3xTF32.  Every GEMM operand x, activations and weights
// alike, is split into hi = tf32_rna(x) and lo = tf32_rna(x - hi)
// (cvt.rna.tf32.f32), and each GEMM is three tensor-core passes summed in
// f32: lo*hi, then hi*lo, then hi*hi, each pass over the whole of K, so that
// the big products meet an accumulator that holds the small ones already.
// lo*lo (~2^-22 relative) is dropped.  Biases, ReLU, the clamp and conv3's
// shift-add are f32 on the FMA units' adders; no product leaves the tensor
// cores.
//
// What bounds it: tensor-core operations.  8,032 useful MACs per output
// pixel, 33.7 G at 2048^2, three passes at the card's 495 TFLOP/s dense TF32
// is 0.409 ms, against 1.006 ms for the same MACs on the f32 FMA units and
// 0.010 ms to move the ~34 MB of planes.  A tile's c2 ring has 20 x 64
// positions for 16 x 60 outputs; the 4 rows below its outputs are the
// first 4 of the tile below, which takes them from it where the walk
// hands both tiles to one block (below), so a segment of L tiles computes
// 16 L + 4 ring rows, not 20 L (1.07x the output columns, 1.33x on a tile
// that carries nothing).  K of conv1 is padded from 81 to 88 and the tap
// GEMM's N from 25 to 32.  Measured on an H100 SXM at 700 W (PERF.md):
// 13.35 ms for a clip's 8 x 2160 x 3840 planes (seg 15), 48% of their
// 6.46 ms bound, and 0.992 ms per 2048^2 plane (seg 12), 41% of the bound,
// against 15.63 and 1.037 ms with every tile computing its whole ring.
// conv1 runs near the tensor cores' rate for the products it sends them,
// conv2 and the tap GEMM at about half of it; a tile's work outside its
// ring rows (window, clamp, shift-add, barriers) is some 6-10 us of its ~30.
//
// Design:
// * A persistent grid of blocks of 256 threads (two warpgroups), one per
//   SM, that walk strips.  A unit of work is a segment: up to L tiles
//   stacked down one 60-column strip of one plane, walked top to bottom;
//   the units are numbered by plane, segment row and strip, and block b
//   takes units b, b + gridDim.x, ...  Each tile after a segment's first
//   starts from the clamped tap-plane rows 16-19 of the tile above (a copy
//   in shared memory), computes ring rows 4-19 only, and fetches and splits
//   24 window rows, not 28.  L is a function of (n, h, w, SMs) alone
//   (segment_tiles): the longest that bounds a block's ring rows least, so
//   it shrinks to 1, the row-major tile walk, where longer segments would
//   leave SMs idle.  No counter or other state outlives a launch, so
//   launches with other parameters on other streams cannot interfere.
// * The weights are split into hi and lo once per block, not once per
//   tile, into wgmma B operands in shared memory: K-major, no swizzle
//   (8-row x 16-byte core matrices, 128 B apart along K, one block of
//   K/4 core matrices per 8 columns of N).  w1 is [88 x 64] (taps 81..87
//   zero), w2 [64 x 32], w3 as the tap GEMM [32 x 32] (column n = tap 5 dy
//   + dx, 25..31 zero).  69,632 bytes for the six.
// * An asynchronous window.  The next tile's 28 x 72 input window (rows
//   4-27 only, if it carries) is copied with 4-byte cp.async into a
//   staging buffer while this tile computes (the plane's pitch (w+12)*4
//   is rarely a multiple of 16 bytes, which TMA and 16-byte cp.async
//   need), then split once into a hi plane and a lo plane.
// * M is ring positions: one ring row of 64 columns is one m64 tile, and
//   warpgroup v takes ring rows v, v+2, ...  conv1 (K 88, N 64) takes its A
//   operand from registers, an im2col done with 32-bit shared loads from
//   the hi and lo windows (overlapping taps cannot be described by a wgmma
//   descriptor): the lo fragments first, then the hi fragments while the
//   tensor cores run the lo*hi pass.  conv2 (K 64, N 32) and the tap GEMM
//   (K 32, N 32) take A
//   straight from the previous GEMM's accumulators, re-split in registers:
//   accumulator columns (2t, 2t+1) of each 8-column group become A columns
//   (t, t+4), so the B rows of w2 and w3 are permuted to match (perm_k).
//   h1 and c2 never touch shared memory; only conv3's 25 tap planes G do.
// * The border clamp is a coordinate clamp on the tap planes: G at a ring
//   position is a function of that position's c2 alone, so copying G from
//   the clamped position equals clamping c2.  Where an edge's flag is 0
//   the ring keeps the values computed over the real halo (banded and
//   sharded callers).
// * conv3 is the shift-add out(y, x) = b3 + sum over (dy, dx) of
//   G[5 dy + dx](y + dy, x + dx), in that fixed order, in a function that
//   is not inlined (see conv3_out).
// * Every pixel's sums run in one fixed order whatever the tile it sits in
//   (the same passes and k-steps, the same shift-add order, no split of K
//   across warps): the chunked path and serving rely on that for their
//   bit-identity with upscale.  A carried ring row is the row the tile
//   below would compute, in the same warpgroup and m64 position, and
//   clamped by the same function of the global position: the walk changes
//   no bit.
// * Ragged tiles clamp their window reads into the plane and mask their
//   output stores; offsets into the planes and the strip walk are 64-bit.
//
// Geometry and shared memory: 16 x 60 output tile, 20 x 64 c2 ring (16 x 64
// computed on a tile that carries), 28 x 72 window.  G 128,400 B; B
// operands 69,632 B; biases 512 B; three window planes (staging, hi, lo)
// 24,192 B; 223,360 B in all, one block per SM.
//
// * srcnn_wgmma.cuh holds the wgmma wrappers, the window prefetch and the
//   SM count that K1 shares with K2-K5; the strip walk is K1's own.
// * Profiling cuts (K6 of kernels/ablation.py, built only with
//   -DSRCNN_PROFILING): the STAGE template argument stops the kernel after
//   its window is split and its weights are staged (LOAD), after conv1
//   (CONV1), conv2 (CONV2) or the tap GEMM (TAPS); srcnn_common.cuh says
//   what a cut writes; a cut stores each output row from the ring row that
//   computes it, carried or not.  The TPU tool's dma / roll / im2col stages
//   have no counterpart here: there is no lane rotate, and conv1's im2col
//   is done in registers.  The production kernel is the FULL instance.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "srcnn_common.cuh"
#include "srcnn_wgmma.cuh"

namespace {

using namespace srcnn;

constexpr int TH = 16, TW = 60;           // output tile
constexpr int NT = 256;                   // threads per block: two warpgroups
constexpr int NWG = NT / 128;
constexpr int RH = TH + 4, RW = TW + 4;   // c2 ring tile, 20 x 64
constexpr int M = RH * RW;                // ring positions
constexpr int WH = RH + 8, WW = RW + 8;   // input window, 28 x 72
constexpr int GS = M + 4;                 // tap-plane stride: spreads banks
constexpr int K1P = 88;                   // conv1's K, 81 taps padded
constexpr int KS1 = K1P / 8, KS2 = C1 / 8, KS3 = C2 / 8;  // k8 steps: 11, 8, 4
constexpr int NG = 32;                    // the tap GEMM's N, 25 taps padded
constexpr int CARRY = RH - TH;            // ring rows a tile shares with the one below
static_assert(RW == 64 && RH % NWG == 0, "one m64 tile per ring row");
static_assert(CARRY % NWG == 0, "a carried tile keeps each ring row's warpgroup");

// Shared memory, bytes.  A B operand of K rows and N columns takes
// (K / 4) * (N / 8) core matrices of 128 bytes.
constexpr int B_G = 25 * GS * 4;
constexpr int B_W1 = K1P * C1 * 4;
constexpr int B_W2 = C1 * C2 * 4;
constexpr int B_W3 = C2 * NG * 4;
constexpr int B_BIAS = 512;               // b1 [64], b2 [32], b3
constexpr int B_WIN = WH * WW * 4;
constexpr int OFF_W1H = (B_G + 1023) / 1024 * 1024;
constexpr int OFF_W1L = OFF_W1H + B_W1;
constexpr int OFF_W2H = OFF_W1L + B_W1;
constexpr int OFF_W2L = OFF_W2H + B_W2;
constexpr int OFF_W3H = OFF_W2L + B_W2;
constexpr int OFF_W3L = OFF_W3H + B_W3;
constexpr int OFF_BIAS = OFF_W3L + B_W3;
constexpr int OFF_RAW = OFF_BIAS + B_BIAS;
constexpr int OFF_WINH = OFF_RAW + B_WIN;
constexpr int OFF_WINL = OFF_WINH + B_WIN;
constexpr size_t SMEM_BYTES = OFF_WINL + B_WIN;             // 223,360
// more than half of the 232,448 B an SM holds: one block per SM
static_assert(SMEM_BYTES <= 232448 && 2 * SMEM_BYTES > 232448, "shared memory");

// ---- 3xTF32 --------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x -> hi = tf32_rna(x), lo = tf32_rna(x - hi); x - hi is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a (registers) * the k8 step s of b, for the accumulator's width
template <int NREG>
__device__ __forceinline__ void wgmma_step(float (&d)[NREG], const uint32_t (&a)[4],
                                           uint64_t b, int s) {
  if constexpr (NREG == 32)
    wgmma_n64_tf32(d, a, at_step(b, s));
  else
    wgmma_n32_tf32(d, a, at_step(b, s));
}

// One GEMM of a warpgroup's m64 tile in 3xTF32, in two calls: d = the sum
// over the KS k8 steps of lo*hi (gemm_lo_pass, which zeroes d), then of
// hi*lo and of hi*hi (gemm_hi_passes, which waits for all three).  Between
// the two, while the tensor cores run the first pass, the caller may fill
// `ah`.
template <int KS, int NREG>
__device__ __forceinline__ void gemm_lo_pass(float (&d)[NREG],
                                             const uint32_t (&al)[KS][4],
                                             uint64_t bh) {
#pragma unroll
  for (int i = 0; i < NREG; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) wgmma_step(d, al[s], bh, s);
  wgmma_commit();
}

template <int KS, int NREG>
__device__ __forceinline__ void gemm_hi_passes(float (&d)[NREG],
                                               uint32_t (&ah)[KS][4],
                                               uint32_t (&al)[KS][4],
                                               uint64_t bh, uint64_t bl) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) wgmma_step(d, ah[s], bl, s);
#pragma unroll
  for (int s = 0; s < KS; ++s) wgmma_step(d, ah[s], bh, s);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  fence_regs(ah);
  fence_regs(al);
}

// Accumulator columns -> the next GEMM's A: the f32 accumulator of an m64nN
// tile holds, in n-group j, rows (g, g+8) x columns (8j + 2t, 8j + 2t + 1)
// of lane (g = lane / 4, t = lane % 4); the tf32 A fragment of k8 step j
// holds rows (g, g+8) x columns (8j + t, 8j + t + 4).  So GEMM row 8j + i
// of the next B is channel perm_k(8j + i).
__device__ __forceinline__ int perm_k(int k) {
  const int i = k & 7;
  return (k & ~7) + (i < 4 ? 2 * i : 2 * i - 7);
}

// relu(acc + bias) of NS n-groups, split into A fragments (a0 = row g,
// a1 = row g+8 of column t; a2, a3 of column t+4); a cut's per-row sums
template <int NS>
__device__ __forceinline__ void epilogue(const float (&acc)[4 * NS],
                                         const float* bias, int t,
                                         uint32_t (&ah)[NS][4],
                                         uint32_t (&al)[NS][4],
                                         float& sum0, float& sum8) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int c = 8 * j + 2 * t;
    const float v0 = fmaxf(acc[4 * j + 0] + bias[c], 0.f);
    const float v1 = fmaxf(acc[4 * j + 1] + bias[c + 1], 0.f);
    const float v2 = fmaxf(acc[4 * j + 2] + bias[c], 0.f);
    const float v3 = fmaxf(acc[4 * j + 3] + bias[c + 1], 0.f);
    sum0 += v0 + v1;
    sum8 += v2 + v3;
    split_tf32(v0, ah[j][0], al[j][0]);
    split_tf32(v2, ah[j][1], al[j][1]);
    split_tf32(v1, ah[j][2], al[j][2]);
    split_tf32(v3, ah[j][3], al[j][3]);
  }
}

// ---- staging ---------------------------------------------------------------

// Word index of element (k, n) of a K-major B operand with KC = K / 4 core
// matrices along K: core matrix (n / 8, k / 4), row n % 8, word k % 4.
template <int KC>
__device__ __forceinline__ int b_word(int k, int n) {
  return (((n >> 3) * KC + (k >> 2)) << 5) + ((n & 7) << 2) + (k & 3);
}

// The three GEMMs' B operands, split into hi and lo, and the biases.
__device__ void stage_params(const float* __restrict__ params,
                             unsigned char* smem, int t) {
  uint32_t* w1h = reinterpret_cast<uint32_t*>(smem + OFF_W1H);
  uint32_t* w1l = reinterpret_cast<uint32_t*>(smem + OFF_W1L);
  uint32_t* w2h = reinterpret_cast<uint32_t*>(smem + OFF_W2H);
  uint32_t* w2l = reinterpret_cast<uint32_t*>(smem + OFF_W2L);
  uint32_t* w3h = reinterpret_cast<uint32_t*>(smem + OFF_W3H);
  uint32_t* w3l = reinterpret_cast<uint32_t*>(smem + OFF_W3L);
  float* bias = reinterpret_cast<float*>(smem + OFF_BIAS);
  for (int i = t; i < K1P * C1; i += NT) {          // row k = tap 9 dy + dx
    const int k = i / C1, n = i % C1;
    const float v = k < 81 ? params[OFF_W1 + k * C1 + n] : 0.f;
    const int o = b_word<K1P / 4>(k, n);
    split_tf32(v, w1h[o], w1l[o]);
  }
  for (int i = t; i < C1 * C2; i += NT) {           // row k = h1 channel perm_k(k)
    const int k = i / C2, n = i % C2;
    const int o = b_word<C1 / 4>(k, n);
    split_tf32(params[OFF_W2 + perm_k(k) * C2 + n], w2h[o], w2l[o]);
  }
  for (int i = t; i < C2 * NG; i += NT) {           // row k = c2 channel perm_k(k),
    const int k = i / NG, n = i % NG;               // column n = tap 5 dy + dx
    const float v = n < 25 ? params[OFF_W3 + n * C2 + perm_k(k)] : 0.f;
    const int o = b_word<C2 / 4>(k, n);
    split_tf32(v, w3h[o], w3l[o]);
  }
  for (int i = t; i < C1 + C2 + 1; i += NT)
    bias[i] = i < C1 ? params[OFF_B1 + i]
                     : i < C1 + C2 ? params[OFF_B2 + i - C1] : params[OFF_B3];
}

// ---- one tile ----------------------------------------------------------------

// The B operands' descriptors (hi, lo) of the three GEMMs.
struct BDescs {
  uint64_t w1h, w1l, w2h, w2l, w3h, w3l;
};

// conv1, conv2 and the tap GEMM over ring rows a0 .. RH-1 of the tile's c2
// ring, from the split window in shared memory: their 25 tap planes into
// gs.  Warpgroup wg takes ring rows a0 + wg, a0 + wg + NWG, ...; each is one
// m64 tile.  A cut (STAGE < FULL) writes its per-pixel value to `out`
// instead, for the ring rows that are output rows r0 .. r0+th-1, and leaves
// gs alone.
template <int STAGE>
__device__ __forceinline__ void ring_gemms(const uint32_t* winh,
                                           const uint32_t* winl,
                                           const float* b1s, const BDescs& bd,
                                           float* gs, float* __restrict__ out,
                                           int r0, int q0, int h, int w, int t,
                                           int a0, int th) {
  const float* b2s = b1s + C1;
  const int wg = t / 128, warp = (t % 128) / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;   // fragment row group, column
  const int mrow = 16 * warp + g;         // this lane's first row of an m64 tile

  // window offsets of the taps this lane feeds to conv1's A fragments:
  // columns 8s + q and 8s + q + 4 of k8 step s (columns past tap 80 read
  // tap 80: finite, and their weights are zero)
  int toff[KS1][2];
#pragma unroll
  for (int s = 0; s < KS1; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = min(8 * s + q + 4 * i, 80);
      toff[s][i] = (k / 9) * WW + k % 9;
    }

#pragma unroll 1
  for (int a = a0 + wg; a < RH; a += NWG) {
    float cut0 = 0.f, cut8 = 0.f;         // a cut's sums of rows g, g + 8
    // a cut's store: row g of this m64 tile is ring column mrow, row g + 8
    // eight columns to its right
    const auto store_cut = [&](float v0, float v8) {
      v0 = quad_sum(v0);
      v8 = quad_sum(v8);
      if (q == 0) {
        cut_store(out, a, mrow, r0, q0, th, TW, h, w, v0);
        cut_store(out, a, mrow + 8, r0, q0, th, TW, h, w, v8);
      }
    };
    // conv1's A fragments of one window plane: rows (g, g+8) of k8 step s
    // are ring columns (mrow, mrow + 8) at taps 8s + q and 8s + q + 4
    const auto im2col = [&](const uint32_t* win, uint32_t (&frag)[KS1][4]) {
      const int base = a * WW + mrow;
#pragma unroll
      for (int s = 0; s < KS1; ++s)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          frag[s][2 * i] = win[base + toff[s][i]];
          frag[s][2 * i + 1] = win[base + toff[s][i] + 8];
        }
    };

    // ---- conv1: [64 x 88] x [88 x 64]; the hi fragments are loaded while
    // the lo*hi pass runs ----
    float acc1[32];
    {
      uint32_t ah[KS1][4], al[KS1][4];
      im2col(winl, al);
      gemm_lo_pass<KS1>(acc1, al, bd.w1h);
      im2col(winh, ah);
      gemm_hi_passes<KS1>(acc1, ah, al, bd.w1h, bd.w1l);
    }
    // ---- h1 = ReLU(conv1 + b1) -> conv2's A fragments ----
    uint32_t hh[KS2][4], hl[KS2][4];
    epilogue<KS2>(acc1, b1s, q, hh, hl, cut0, cut8);
    if constexpr (STAGE == CONV1) {       // cut: sum of the 64 h1 channels
      store_cut(cut0, cut8);
      continue;
    }

    // ---- conv2: [64 x 64] x [64 x 32] ----
    float acc2[16];
    gemm_lo_pass<KS2>(acc2, hl, bd.w2h);
    gemm_hi_passes<KS2>(acc2, hh, hl, bd.w2h, bd.w2l);
    uint32_t ch[KS3][4], cl[KS3][4];
    cut0 = cut8 = 0.f;
    epilogue<KS3>(acc2, b2s, q, ch, cl, cut0, cut8);
    if constexpr (STAGE == CONV2) {       // cut: sum of the 32 c2 channels
      store_cut(cut0, cut8);
      continue;
    }

    // ---- conv3's tap products: [64 x 32] x [32 x 25 (32)] ----
    float acc3[16];
    gemm_lo_pass<KS3>(acc3, cl, bd.w3h);
    gemm_hi_passes<KS3>(acc3, ch, cl, bd.w3h, bd.w3l);
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
    const int pos = a * RW + mrow;
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

// conv3: shift-add of the (clamped) tap planes, + b3, clamp to [0, 255].
// Not inlined: inlined into the kernel, it changed how ptxas allocated
// registers for and scheduled the GEMM loop, and the kernel was slower
// (PERF.md, PR 5).
__device__ __noinline__ void conv3_out(const float* gs, float b3,
                                          float* __restrict__ out, int r0,
                                          int q0, int h, int w, int t) {
  for (int s = t; s < TH * TW; s += NT) {
    const int ty = s / TW, tx = s % TW;
    const float* gp = gs + ty * RW + tx;
    float o = 0.f;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy)
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) o += gp[(dy * 5 + dx) * GS + dy * RW + dx];
    const int orow = r0 + ty, ocol = q0 + tx;
    if (orow < h && ocol < w)
      out[static_cast<long long>(orow) * w + ocol] = fminf(fmaxf(o + b3, 0.f), 255.f);
  }
}

// Rows RH-CARRY .. RH-1 of the 25 tap planes, clamped, -> rows 0 .. CARRY-1:
// the tile below's ring starts CARRY rows above this ring's end.
__device__ __forceinline__ void carry_rows(float* gs, int t) {
  constexpr int P = CARRY * RW;
  for (int s = t; s < 25 * P; s += NT) {
    float* g = gs + (s / P) * GS + s % P;
    g[0] = g[(RH - CARRY) * RW];
  }
}

// ---- the strip walk ------------------------------------------------------------

// A unit of work is a segment: up to `seg` tiles stacked down one TW-column
// strip of one plane, walked top to bottom.  Units are numbered by plane,
// then segment row, then strip; block b takes units b, b + gridDim.x, ...
struct Segment {
  int plane, row, q0, len;                // row: its first tile row
};

__device__ __forceinline__ Segment segment_at(long long u, int tr, int tc, int seg) {
  const long long per_plane = static_cast<long long>((tr + seg - 1) / seg) * tc;
  const long long rem = u % per_plane;
  const int row = static_cast<int>(rem / tc) * seg;
  return {static_cast<int>(u / per_plane), row, static_cast<int>(rem % tc) * TW,
          min(seg, tr - row)};
}

// The segment length of a launch over n planes of [h, w] on `sms` SMs:
// the one that bounds a block's ring rows least, sum over its rounds of
// RH + TH * (seg - 1), the longest on a tie.  seg = 1 is the row-major tile
// walk, so no launch bounds worse than that.  kernels/fused_conv.py's
// k1_walk computes the same.
int segment_tiles(int n, int h, int w, int sms) {
  const int tr = (h + TH - 1) / TH, tc = (w + TW - 1) / TW;
  int best = 1;
  long long best_rows = -1;
  for (int seg = 1;;) {
    const int segs = (tr + seg - 1) / seg;
    const long long units = static_cast<long long>(n) * tc * segs;
    const long long grid = units < sms ? units : sms;
    const long long rows = (units + grid - 1) / grid * (RH + TH * (seg - 1LL));
    if (best_rows < 0 || rows <= best_rows) best = seg, best_rows = rows;
    if (segs == 1) return best;
    seg = (tr + segs - 2) / (segs - 1);   // the shortest seg with fewer segments
  }
}

// ---- the kernel --------------------------------------------------------------

template <int STAGE = FULL>
__global__ void __launch_bounds__(NT, 1)
fused_srcnn_kernel(const float* __restrict__ y,
                   const float* __restrict__ params,
                   float* __restrict__ out, int n, int h, int w, int f_top,
                   int f_bottom, int f_left, int f_right, int seg) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);                 // [25][GS]
  const float* b1s = reinterpret_cast<const float*>(smem + OFF_BIAS);
  float* raw = reinterpret_cast<float*>(smem + OFF_RAW);       // [WH][WW]
  uint32_t* winh = reinterpret_cast<uint32_t*>(smem + OFF_WINH);
  uint32_t* winl = reinterpret_cast<uint32_t*>(smem + OFF_WINL);

  const int t = threadIdx.x;
  const int tr = (h + TH - 1) / TH, tc = (w + TW - 1) / TW;
  const long long units = static_cast<long long>((tr + seg - 1) / seg) * tc * n;

  long long unit = blockIdx.x;
  Segment sg = segment_at(unit, tr, tc, seg);
  int ti = 0;                             // this tile's place in its segment
  fetch_window<WH, WW, NT>(raw, y, {sg.plane, sg.row * TH, sg.q0}, h, w, t);
  stage_params(params, smem, t);
  // the B operands are read by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const BDescs bd = {b_desc(smem + OFF_W1H, (K1P / 4) * 128),
                     b_desc(smem + OFF_W1L, (K1P / 4) * 128),
                     b_desc(smem + OFF_W2H, (C1 / 4) * 128),
                     b_desc(smem + OFF_W2L, (C1 / 4) * 128),
                     b_desc(smem + OFF_W3H, (C2 / 4) * 128),
                     b_desc(smem + OFF_W3L, (C2 / 4) * 128)};

  while (unit < units) {
    const Tile tl = {sg.plane, (sg.row + ti) * TH, sg.q0};
    float* po = out + static_cast<long long>(tl.plane) * h * w;
    // a tile below another of its segment takes ring rows 0 .. CARRY-1 from
    // it, and needs window rows from CARRY on only
    const int a0 = ti > 0 ? CARRY : 0;
    const bool carries = ti + 1 < sg.len;  // the tile below takes rows from this one
    long long next_unit = unit;           // this block's next tile
    Segment next = sg;
    int next_ti = ti + 1;
    if (!carries) {
      next_unit += gridDim.x;
      next_ti = 0;
      if (next_unit < units) next = segment_at(next_unit, tr, tc, seg);
    }

    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int k = a0 * WW + t; k < WH * WW; k += NT) split_tf32(raw[k], winh[k], winl[k]);
    __syncthreads();
    if (next_unit < units)                // the next tile's window, meanwhile
      fetch_window<WH, WW, NT>(raw, y, {next.plane, (next.row + next_ti) * TH, next.q0},
                               h, w, t, next_ti > 0 ? CARRY : 0);

    if constexpr (STAGE == LOAD) {        // cut: the centre tap as split
      for (int s = t; s < TH * TW; s += NT) {
        const int a = s / TW + 2, b = s % TW + 2;
        const int i = (a + 4) * WW + b + 4;
        cut_store(po, a, b, tl.r0, tl.q0, TH, TW, h, w,
                  __uint_as_float(winh[i]) + __uint_as_float(winl[i]));
      }
    } else {
      // a cut stores each output row from the ring row that computes it:
      // the tile above computes this tile's first CARRY - 2 rows
      ring_gemms<STAGE>(winh, winl, b1s, bd, gs, po, tl.r0, tl.q0, h, w, t, a0,
                        carries ? TH + CARRY - 2 : TH);
    }
    __syncthreads();
    if constexpr (STAGE == FULL) {
      // border clamp on the ring's tap planes (global c2 rows r0-2 ..
      // r0+RH-3), then conv3
      ring_clamp<RH, RW, NT, 25>(gs, GS, tl.r0, tl.q0, h, w, f_top, f_bottom,
                                 f_left, f_right);
      conv3_out(gs, b1s[C1 + C2], po, tl.r0, tl.q0, h, w, t);
      __syncthreads();                    // G and the window are rewritten next
      // ring rows RH-CARRY.. are the clamped rows the tile below starts
      // from (the clamp is a function of the global position); the next
      // tile's first barrier orders this copy before its GEMMs
      if (carries) carry_rows(gs, t);
    }
    unit = next_unit;
    sg = next;
    ti = next_ti;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int STAGE>
cudaError_t launch(const float* y, float* out, const float* params, int n,
                   int h, int w, int f_top, int f_bottom, int f_left,
                   int f_right, cudaStream_t stream) {
  const auto kernel = fused_srcnn_kernel<STAGE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  int sms = 0;                            // one block per SM
  if ((e = sm_count(&sms)) != cudaSuccess) return e;
  const int seg = segment_tiles(n, h, w, sms);
  const int tr = (h + TH - 1) / TH, tc = (w + TW - 1) / TW;
  const long long units = static_cast<long long>((tr + seg - 1) / seg) * tc * n;
  const int grid = static_cast<int>(units < sms ? units : sms);
  kernel<<<grid, NT, SMEM_BYTES, stream>>>(y, params, out, n, h, w, f_top,
                                           f_bottom, f_left, f_right, seg);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int srcnn_fused_n_params() { return N_PARAMS; }

// The strip walk is 64-bit and the grid has one block per SM slot, so the
// limit is the int row arithmetic of a tile (r0 + WH, h + 2 HALO).
int srcnn_fused_max_rows() { return INT_MAX - WH - 2 * HALO - TH; }

// The tiles per segment of K1's strip walk for n planes of [h, w] on `sms`
// SMs (kernels/fused_conv.py::k1_walk mirrors it).
int srcnn_fused_segment_tiles(int n, int h, int w, int sms) {
  return segment_tiles(n, h, w, sms);
}

// y: [n, h+12, w+12] f32, out: [n, h, w] f32, both contiguous; params:
// N_PARAMS f32 in the packed layout; all on the current device.  Launches
// on `stream`; returns the cudaError_t of the set-up or the launch (0 on
// success).
int srcnn_fused_forward(const float* y, float* out, const float* params,
                        int n, int h, int w, int f_top, int f_bottom,
                        int f_left, int f_right, void* stream) {
  return launch<FULL>(y, out, params, n, h, w, f_top, f_bottom, f_left,
                      f_right, static_cast<cudaStream_t>(stream));
}

#ifdef SRCNN_PROFILING
// The profiling cuts of K1 (kernels/ablation.py): as srcnn_fused_forward,
// stopped after `stage` (LOAD, CONV1, CONV2, TAPS or FULL).
int srcnn_fused_cut_forward(const float* y, float* out, const float* params,
                            int n, int h, int w, int f_top, int f_bottom,
                            int f_left, int f_right, int stage,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
#define SRCNN_CUT(S)                                                      \
  case S:                                                                 \
    return launch<S>(y, out, params, n, h, w, f_top, f_bottom, f_left,    \
                     f_right, s);
    SRCNN_CUT(LOAD)
    SRCNN_CUT(CONV1)
    SRCNN_CUT(CONV2)
    SRCNN_CUT(TAPS)
    SRCNN_CUT(FULL)
#undef SRCNN_CUT
    default:
      return cudaErrorInvalidValue;
  }
}
#endif  // SRCNN_PROFILING

}  // extern "C"
