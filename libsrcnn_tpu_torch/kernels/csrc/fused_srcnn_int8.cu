// Fused SRCNN 9-1-5 forward on the int8 tensor cores, for Hopper (sm_90a):
// the int8 tier, kernel K4, on wgmma.
//
// Replaces libsrcnn_tpu/kernels/fused_conv.py::_kernel_int8 (:325-384),
// reached through _fused_int8 / forward_y_int8.  Per output pixel of an
// [h, w] plane, with the quantized pack of models/srcnn_int8:
//   xq   = clip(rint(y * (127/255)), 0, 127)        the window, once
//   h1q  = clip(rint(conv1(xq) * s1 + t1), 0, 127)  9x9 1->64
//   acc2 = conv2(h1q)                               1x1 64->32
//   the reference's c2 border clamp, gated by the edge flags
//   c2q  = clip(rint(acc2 * s2 + t2), 0, 127)
//   out  = clip(conv3(c2q) * d3 + b3, 0, 255)       5x5 32->1
// Every conv is an int8 GEMM with int32 accumulation, exact in any order,
// so the output does not depend on where a pixel sits in its tile or on
// the GEMMs' K order.  Each epilogue is an f32 multiply, then an f32 add,
// then rintf, written with __fmul_rn / __fadd_rn so that nvcc cannot
// contract them into one FMA; 127/255 comes in with the parameters as the
// f32 value the plain version multiplies by.  So K4 equals the plain
// version (kernels/fused_conv.forward_y_int8_reference) bit for bit.
// Input: n Y planes with a 6 px halo, [n, h+12, w+12] f32, contiguous; one
// launch covers the batch.
//
// What bounds it: operations.  8,032 MACs per output pixel, 67.4 G int8
// operations at 2048^2: 0.034 ms at the card's 1,979 TOPS dense int8,
// against 0.010 ms to move the ~34 MB of planes.  The tensor cores are not
// what this kernel waits on: with the ring's 1.23x recomputation and
// conv1's K of 128 for 81 taps they issue under 0.1 ms of int8 wgmma per
// 2048^2 plane.  The f32 requant epilogues, 96 per ring position, are the
// larger work: with rintf and the int <-> float casts on the conversion
// units they set the kernel's pace, so they run on the FMA and ALU pipes
// instead (int_to_float, code_of).
//
// Design (K1's, fused_srcnn.cu, in s8):
// * A persistent grid: min(tiles, SMs) blocks of 384 threads (three
//   warpgroups), each walking the 26 x 60 output tiles of all n planes with
//   a static stride; 64-bit tile walk and offsets.  The next tile's 38 x 72
//   f32 window is copied with cp.async while this tile computes, then
//   quantized once into int8 codes.
// * The B operands go to shared memory once per block, as wgmma's K-major
//   operands without swizzle: w1q [128 x 64], w2q [64 x 32] and conv3's
//   weights as the tap GEMM [32 x 32] (column n = tap 5 dy + dx, 25..31
//   zero); 11,264 bytes.  The f32 scales this lane needs sit in registers.
// * M is ring positions: one ring row of 64 columns is one m64 tile, and
//   warpgroup v takes ring rows v, v + 3, ...  wgmma.m64nNk32.s32.s8.s8
//   with A from registers (IGMMA in SASS).
// * conv1's A operand, an im2col into registers.  Its K order is 9 window
//   rows x 12 columns (dx 0..11; 9..11 have zero weights), 108 rows padded
//   to 128: a k32 step's A register holds 4 consecutive k, which are then 4
//   adjacent bytes of one window row, so each register is two aligned
//   32-bit shared loads joined by one funnel shift (the shift is the ring
//   column's offset in its word, the same for every register of a lane).
//   That replaces four byte loads and three shifts per register; the cost
//   is a longer K (4 k32 steps instead of 3), which the tensor cores have
//   to spare.  The alternative, an im2col in shared memory read through an
//   A descriptor, would store every code ~81 times per tile and still
//   gather them.
// * conv2 and the tap GEMM take A from the previous GEMM's accumulators:
//   the s32 m64 accumulator of a warp is mma.sync's m16n8 layout (a lane
//   holds columns 2q, 2q + 1 of each 8-wide n-group) and an s8 A register
//   holds 4 consecutive k, so they contract over a permuted channel order,
//   logical k = 32s + 16h + 4q + 2u + v <-> channel 8(4s + 2h + u) + 2q + v
//   (perm_ch), and the B rows of w2q and of conv3's weights are staged in
//   that order.  h1q and c2q never leave the registers; only the 25 int32
//   tap planes go to shared memory.
// * The border clamp is K1's coordinate clamp, applied to the tap planes:
//   a tap product at a ring position is a function of that position's
//   acc2 alone, so copying it from the clamped position equals clamping
//   acc2 (srcnn::ring_clamp, on int32).
// * conv3's output is an int32 shift-add of the tap planes, then one f32
//   scale: out = clip(acc * d3 + b3, 0, 255).
// * Every parameter comes in through `params` (int8 weights and f32
//   scales in one byte buffer); nothing outlives a launch.
//
// Geometry and shared memory: 26 x 60 output tile, 30 x 64 c2 ring (1.23x
// recomputation), 38 x 72 window.  Tap planes 192,400 B; B operands 11,264
// B; scales 832 B; the f32 window 10,944 B and its codes 2,752 B; 219,328
// B, one block per SM.  Of 16 x 60 and 24 x 60 with two warpgroups and
// 20 x 60 and 26 x 60 with three, the last was the fastest (PERF.md): the
// requant epilogues of one warpgroup overlap the others' GEMMs.
//
// * Profiling cuts (K7 of kernels/ablation.py, built only with
//   -DSRCNN_PROFILING): the STAGE template argument stops the kernel after
//   its window is quantized and its weights are staged (LOAD; the TPU
//   tool's dma, roll, quant and im2col are this one phase here), after
//   conv1, conv2 or the tap GEMM (TAPS); srcnn_common.cuh says what a cut
//   writes.  Its values are integer sums, so the cuts equal their plain
//   versions bit for bit too.  The production kernel is the FULL instance.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "srcnn_common.cuh"
#include "srcnn_wgmma.cuh"

namespace {

using namespace srcnn;

constexpr int TH = 26, TW = 60;           // output tile
constexpr int NT = 384;                   // threads per block: three warpgroups
constexpr int NWG = NT / 128;
constexpr int RH = TH + 4, RW = TW + 4;   // c2 ring tile, 30 x 64
constexpr int WH = RH + 8, WW = RW + 8;   // input window, 38 x 72
constexpr int GS = RH * RW + 4;           // tap-plane stride: spreads banks
constexpr int NGRP = 27;                  // conv1's taps in groups of 4: 9 rows x 3
constexpr int K1P = 128;                  // conv1's K: the 27 groups padded to 32
constexpr int KS1 = K1P / 32, KS2 = C1 / 32, KS3 = C2 / 32;  // k32 steps: 4, 2, 1
constexpr int NG = 32;                    // the tap GEMM's N, 25 taps padded
static_assert(RW == 64 && RH % NWG == 0 && WW % 4 == 0, "one m64 tile per ring row");

// Packed parameters (kernels/fused_conv.py::pack_int8_params), in bytes:
// int8 w1q [81][64] (tap 9*dy + dx), w2q [64][32], w3 [25][32] (tap
// 5*dy + dx), then f32 s1 [64], t1 [64], s2 [32], t2 [32], d3, b3 and the
// input scale 127/255.
constexpr int Q_W1 = 0;
constexpr int Q_W2 = Q_W1 + 81 * C1;
constexpr int Q_W3 = Q_W2 + C1 * C2;
constexpr int Q_SC = Q_W3 + 25 * C2;      // 8,032
constexpr int SC_S1 = 0, SC_T1 = SC_S1 + C1, SC_S2 = SC_T1 + C1;
constexpr int SC_T2 = SC_S2 + C2, SC_D3 = SC_T2 + C2, SC_B3 = SC_D3 + 1;
constexpr int SC_XS = SC_B3 + 1;
constexpr int N_SC = SC_XS + 1;           // 195 floats
constexpr int N_BYTES = Q_SC + 4 * N_SC;  // 8,812
static_assert(Q_SC % 16 == 0, "the scales start 16-byte aligned");

// Shared memory, bytes.  A B operand of K rows and N columns takes
// (K / 16) * (N / 8) core matrices of 128 bytes.
constexpr int B_G = 25 * GS * 4;          // conv3's tap planes, int32
constexpr int B_W1 = K1P * C1;
constexpr int B_W2 = C1 * C2;
constexpr int B_W3 = C2 * NG;
constexpr int B_SC = (N_SC + 15) / 16 * 16 * 4;
constexpr int B_RAW = WH * WW * 4;
constexpr int B_WQ = WH * WW + 16;        // codes; conv1's loads read 4 past
constexpr int SM_W1 = (B_G + 1023) / 1024 * 1024;
constexpr int SM_W2 = SM_W1 + B_W1;
constexpr int SM_W3 = SM_W2 + B_W2;
constexpr int SM_SC = SM_W3 + B_W3;
constexpr int SM_RAW = SM_SC + B_SC;
constexpr int SM_WQ = SM_RAW + B_RAW;
constexpr size_t SMEM = SM_WQ + B_WQ;                      // 219,328
// more than half of the 232,448 B an SM holds: one block per SM
static_assert(SMEM <= 232448 && 2 * SMEM > 232448 && B_WQ % 16 == 0,
              "shared memory");

// 1.5 * 2^23: an f32 whose low mantissa bits hold an integer i, |i| <
// 2^22, as MAGIC_BITS + i.  Adding it to x in [0, 127] rounds x to an
// integer, half to even as rintf does, and leaves that integer in the low
// byte; subtracting it from MAGIC_BITS + i converts i exactly.  Both run on
// the FMA and ALU pipes; cvt (I2F, FRND, F2I) runs on the conversion units,
// which issue far fewer results per clock, and three of them per requant
// set the kernel's pace when it used them (PERF.md).
constexpr float MAGIC = 12582912.f;
constexpr uint32_t MAGIC_BITS = 0x4B400000u;

// float(acc), exact for |acc| < 2^22 (conv1's and conv2's accumulators are
// below 81 * 127 * 128 < 2^21)
__device__ __forceinline__ float int_to_float(int acc) {
  return __fsub_rn(__uint_as_float(MAGIC_BITS + static_cast<uint32_t>(acc)), MAGIC);
}

// clip(rint(x), 0, 127) in the low byte of the result (the rest is
// MAGIC's).  Equal to rint(clip(x, 0, 127)): rint is monotone and the
// bounds are integers.
__device__ __forceinline__ uint32_t code_of(float x) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(x, 0.f), 127.f), MAGIC));
}

// The folded requant, clip(rint(acc * s + t), 0, 127), as a code in the
// low byte: the multiply and the add rounded separately, as the plain
// version's two torch ops.
__device__ __forceinline__ uint32_t requant(int acc, float s, float t) {
  return code_of(__fadd_rn(__fmul_rn(int_to_float(acc), s), t));
}

// channel of logical GEMM row k of conv2 and of the tap GEMM (see Design)
__device__ __forceinline__ int perm_ch(int k) {
  const int s = k / 32, h = (k / 16) % 2, q = (k / 4) % 4, u = (k / 2) % 2;
  return 8 * (4 * s + 2 * h + u) + 2 * q + k % 2;
}

__device__ __forceinline__ uint32_t byte_of(const int8_t* p, int i) {
  return static_cast<uint32_t>(static_cast<uint8_t>(p[i]));
}

// Word index of bytes k .. k + 3 (k % 4 == 0) of column n of a K-major s8
// B operand with KC = K / 16 core matrices along K: core matrix (n / 8,
// k / 16), row n % 8, word (k % 16) / 4.
template <int KC>
__device__ __forceinline__ int b_word4(int k, int n) {
  return (((n >> 3) * KC + (k >> 4)) << 5) + ((n & 7) << 2) + ((k & 15) >> 2);
}

// conv1's GEMM row k: tap (dy, dx) = (m / 3, 4 (m % 3) + k % 4) of group
// m = k / 4; its weight, zero past dx 8 and past group 26
__device__ __forceinline__ uint32_t w1_byte(const int8_t* w1q, int k, int n) {
  const int m = k / 4, dx = 4 * (m % 3) + k % 4;
  return m < NGRP && dx < 9 ? byte_of(w1q, ((m / 3) * 9 + dx) * C1 + n) : 0u;
}

// The three GEMMs' B operands and the scales, into shared memory.
__device__ void stage_params(const unsigned char* __restrict__ params,
                             unsigned char* smem, int t) {
  const int8_t* w1q = reinterpret_cast<const int8_t*>(params + Q_W1);
  const int8_t* w2q = reinterpret_cast<const int8_t*>(params + Q_W2);
  const int8_t* w3q = reinterpret_cast<const int8_t*>(params + Q_W3);
  const float* sc = reinterpret_cast<const float*>(params + Q_SC);
  uint32_t* w1 = reinterpret_cast<uint32_t*>(smem + SM_W1);
  uint32_t* w2 = reinterpret_cast<uint32_t*>(smem + SM_W2);
  uint32_t* w3 = reinterpret_cast<uint32_t*>(smem + SM_W3);
  float* scs = reinterpret_cast<float*>(smem + SM_SC);
  for (int i = t; i < K1P / 4 * C1; i += NT) {
    const int k = 4 * (i / C1), n = i % C1;
    uint32_t v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) v |= w1_byte(w1q, k + e, n) << (8 * e);
    w1[b_word4<K1P / 16>(k, n)] = v;
  }
  for (int i = t; i < C1 / 4 * C2; i += NT) {       // row k = h1 channel perm_ch(k)
    const int k = 4 * (i / C2), n = i % C2;
    uint32_t v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) v |= byte_of(w2q, perm_ch(k + e) * C2 + n) << (8 * e);
    w2[b_word4<C1 / 16>(k, n)] = v;
  }
  for (int i = t; i < C2 / 4 * NG; i += NT) {       // row k = c2 channel perm_ch(k),
    const int k = 4 * (i / NG), n = i % NG;         // column n = tap 5 dy + dx
    uint32_t v = 0;
    if (n < 25) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v |= byte_of(w3q, n * C2 + perm_ch(k + e)) << (8 * e);
    }
    w3[b_word4<C2 / 16>(k, n)] = v;
  }
  for (int i = t; i < N_SC; i += NT) scs[i] = sc[i];
}

// d += a * b over the KS k32 steps, committed as one group, waited for
template <int KS, int NREG>
__device__ __forceinline__ void gemm_s8(int (&d)[NREG], uint32_t (&a)[KS][4],
                                        uint64_t b) {
#pragma unroll
  for (int i = 0; i < NREG; ++i) d[i] = 0;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if constexpr (NREG == 32)
      wgmma_n64_s8(d, a[s], at_step(b, s));
    else
      wgmma_n32_s8(d, a[s], at_step(b, s));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  fence_regs(a);
}

// Accumulators of NJ n-groups -> the next GEMM's A fragments: n-group j
// (channels 8j + 2q + {0, 1}) requantized is k-step j / 4, half (j / 2) %
// 2, byte pair j % 2 (perm_ch); a cut's sums of the codes of rows g, g + 8
template <int NJ>
__device__ __forceinline__ void requant_a(const int (&acc)[4 * NJ], const float (&s)[2 * NJ],
                                          const float (&tt)[2 * NJ],
                                          uint32_t (&a)[(NJ + 3) / 4][4], int& sum0,
                                          int& sum8) {
  uint32_t pair[NJ][2];                   // codes of rows g and g + 8, 2 bytes each
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const uint32_t c0 = requant(acc[4 * j + 0], s[2 * j], tt[2 * j]);
    const uint32_t c1 = requant(acc[4 * j + 1], s[2 * j + 1], tt[2 * j + 1]);
    const uint32_t c2 = requant(acc[4 * j + 2], s[2 * j], tt[2 * j]);
    const uint32_t c3 = requant(acc[4 * j + 3], s[2 * j + 1], tt[2 * j + 1]);
    sum0 += (c0 & 0xFF) + (c1 & 0xFF);
    sum8 += (c2 & 0xFF) + (c3 & 0xFF);
    pair[j][0] = __byte_perm(c0, c1, 0x0040);    // low bytes of c0, c1
    pair[j][1] = __byte_perm(c2, c3, 0x0040);
  }
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {       // n-groups j, j + 1: one register
    const int ks = j / 4, r = 2 * ((j / 2) % 2);
    a[ks][r] = __byte_perm(pair[j][0], pair[j + 1][0], 0x5410);
    a[ks][r + 1] = __byte_perm(pair[j][1], pair[j + 1][1], 0x5410);
  }
}

struct BDescs {
  uint64_t w1, w2, w3;
};

// conv1, conv2 and the tap GEMM over the tile's c2 ring, from the window's
// codes: the 25 int32 tap planes into gs.  Warpgroup wg takes ring rows wg,
// wg + NWG, ...; each is one m64 tile.  A cut (STAGE < FULL) writes its
// per-pixel value to `out` instead and leaves gs alone.
template <int STAGE>
__device__ __forceinline__ void ring_gemms(const uint32_t* wq, const float* scs,
                                           const BDescs& bd, int* gs,
                                           float* __restrict__ out, int r0, int q0,
                                           int h, int w, int t) {
  const int wg = t / 128, warp = (t % 128) / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;   // fragment row group, k quad
  const int mrow = 16 * warp + g;         // this lane's first row of an m64 tile
  const int sh = 8 * (mrow & 3);          // ring column mrow's byte in its word

  // the scales of the channels this lane's accumulators hold: 8j + 2q and
  // 8j + 2q + 1 of n-group j
  float s1[16], t1[16], s2[8], t2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int c = 8 * j + 2 * q + v;
      s1[2 * j + v] = scs[SC_S1 + c];
      t1[2 * j + v] = scs[SC_T1 + c];
      if (j < 4) {
        s2[2 * j + v] = scs[SC_S2 + c];
        t2[2 * j + v] = scs[SC_T2 + c];
      }
    }

  // word offsets of the tap groups this lane feeds to conv1's A fragments:
  // group 8s + q (k 4q .. 4q + 3 of k32 step s) and 8s + q + 4 (groups past
  // 26 read group 0: finite, and their weights are zero)
  int goff[KS1][2];
#pragma unroll
  for (int s = 0; s < KS1; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int m = 8 * s + q + 4 * i;
      m = m < NGRP ? m : 0;
      goff[s][i] = ((m / 3) * WW + 4 * (m % 3)) / 4;
    }

#pragma unroll 1
  for (int a = wg; a < RH; a += NWG) {
    int cut0 = 0, cut8 = 0;               // a cut's sums of rows g, g + 8
    // a cut's store: row g of this m64 tile is ring column mrow, row g + 8
    // eight columns to its right (integer sums below 2^24, exact in f32)
    const auto store_cut = [&](int v0, int v8) {
      v0 = quad_sum(v0);
      v8 = quad_sum(v8);
      if (q == 0) {
        cut_store(out, a, mrow, r0, q0, TH, TW, h, w, static_cast<float>(v0));
        cut_store(out, a, mrow + 8, r0, q0, TH, TW, h, w, static_cast<float>(v8));
      }
    };

    // ---- conv1: [64 x 128] x [128 x 64].  Rows (g, g + 8) of a register
    // are ring columns (mrow, mrow + 8): two words apart ----
    int acc1[32];
    {
      const int base = (a * WW + mrow) / 4;
      uint32_t ax[KS1][4];
#pragma unroll
      for (int s = 0; s < KS1; ++s)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t* p = wq + base + goff[s][i];
          ax[s][2 * i] = __funnelshift_r(p[0], p[1], sh);
          ax[s][2 * i + 1] = __funnelshift_r(p[2], p[3], sh);
        }
      gemm_s8(acc1, ax, bd.w1);
    }
    // ---- h1q -> conv2's A fragments ----
    uint32_t ah[KS2][4];
    requant_a<8>(acc1, s1, t1, ah, cut0, cut8);
    if constexpr (STAGE == CONV1) {       // cut: sum of the 64 h1q codes
      store_cut(cut0, cut8);
      continue;
    }

    // ---- conv2: [64 x 64] x [64 x 32] ----
    int acc2[16];
    gemm_s8(acc2, ah, bd.w2);
    // ---- c2q -> the tap GEMM's A fragment (the ring clamp acts on the
    // tap planes below) ----
    uint32_t ch[KS3][4];
    cut0 = cut8 = 0;
    requant_a<4>(acc2, s2, t2, ch, cut0, cut8);
    if constexpr (STAGE == CONV2) {       // cut: sum of the 32 c2q codes
      store_cut(cut0, cut8);
      continue;
    }

    // ---- conv3's tap products: [64 x 32] x [32 x 25 (32)] ----
    int acc3[16];
    gemm_s8(acc3, ch, bd.w3);
    if constexpr (STAGE == TAPS) {        // cut: sum of the 25 taps
      cut0 = cut8 = 0;
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

// conv3: int32 shift-add of the (clamped) tap planes, one f32 scale, clamp
// to [0, 255]; not inlined, as K1's
__device__ __noinline__ void conv3_out(const int* gs, float d3, float b3,
                                       float* __restrict__ out, int r0, int q0,
                                       int h, int w, int t) {
  for (int s = t; s < TH * TW; s += NT) {
    const int ty = s / TW, tx = s % TW;
    const int* gp = gs + ty * RW + tx;
    int acc = 0;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy)
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) acc += gp[(dy * 5 + dx) * GS + dy * RW + dx];
    const int orow = r0 + ty, ocol = q0 + tx;
    if (orow < h && ocol < w) {
      const float o = __fadd_rn(__fmul_rn(static_cast<float>(acc), d3), b3);
      out[static_cast<long long>(orow) * w + ocol] = fminf(fmaxf(o, 0.f), 255.f);
    }
  }
}

template <int STAGE = FULL>
__global__ void __launch_bounds__(NT, 1)
fused_srcnn_int8_kernel(const float* __restrict__ y,
                        const unsigned char* __restrict__ params,
                        float* __restrict__ out, int n, int h, int w, int f_top,
                        int f_bottom, int f_left, int f_right) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int* gs = reinterpret_cast<int*>(smem);                     // [25][GS]
  const float* scs = reinterpret_cast<const float*>(smem + SM_SC);
  float* raw = reinterpret_cast<float*>(smem + SM_RAW);       // [WH][WW]
  uint8_t* wq = smem + SM_WQ;                                 // [WH][WW] codes

  const int t = threadIdx.x;
  const int tr = (h + TH - 1) / TH, tc = (w + TW - 1) / TW;
  const long long tiles = static_cast<long long>(tr) * tc * n;

  long long tile = blockIdx.x;
  fetch_window<WH, WW, NT>(raw, y, tile_at<TH, TW>(tile, tr, tc), h, w, t);
  stage_params(params, smem, t);
  if (t < B_WQ - WH * WW) wq[WH * WW + t] = 0;   // read by conv1, zero weights
  // the B operands are read by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const BDescs bd = {b_desc(smem + SM_W1, (K1P / 16) * 128),
                     b_desc(smem + SM_W2, (C1 / 16) * 128),
                     b_desc(smem + SM_W3, (C2 / 16) * 128)};
  const float xs = reinterpret_cast<const float*>(params + Q_SC)[SC_XS];

  for (; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_at<TH, TW>(tile, tr, tc);
    float* po = out + static_cast<long long>(tl.plane) * h * w;

    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int i = t; i < WH * WW; i += NT)     // the window's codes, once
      wq[i] = static_cast<uint8_t>(code_of(__fmul_rn(raw[i], xs)));
    __syncthreads();
    if (tile + gridDim.x < tiles)         // the next tile's window, meanwhile
      fetch_window<WH, WW, NT>(raw, y, tile_at<TH, TW>(tile + gridDim.x, tr, tc),
                               h, w, t);

    if constexpr (STAGE == LOAD) {        // cut: the centre tap's code
      for (int s = t; s < TH * TW; s += NT) {
        const int a = s / TW + 2, b = s % TW + 2;
        cut_store(po, a, b, tl.r0, tl.q0, TH, TW, h, w,
                  static_cast<float>(wq[(a + 4) * WW + b + 4]));
      }
    } else {
      ring_gemms<STAGE>(reinterpret_cast<const uint32_t*>(wq), scs, bd, gs, po,
                        tl.r0, tl.q0, h, w, t);
    }
    __syncthreads();
    if constexpr (STAGE == FULL) {
      // border clamp on the ring's tap planes (global c2 rows r0-2 ..
      // r0+RH-3), then conv3
      ring_clamp<RH, RW, NT, 25>(gs, GS, tl.r0, tl.q0, h, w, f_top, f_bottom,
                                 f_left, f_right);
      conv3_out(gs, scs[SC_D3], scs[SC_B3], po, tl.r0, tl.q0, h, w, t);
      __syncthreads();                    // G and the window are rewritten next
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int STAGE>
cudaError_t launch(const float* y, float* out, const unsigned char* params,
                   int n, int h, int w, int f_top, int f_bottom, int f_left,
                   int f_right, cudaStream_t stream) {
  const auto kernel = fused_srcnn_int8_kernel<STAGE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return e;
  int grid = 0;                           // one block per SM
  if ((e = persistent_grid<TH, TW>(n, h, w, &grid)) != cudaSuccess) return e;
  kernel<<<grid, NT, SMEM, stream>>>(y, params, out, n, h, w, f_top, f_bottom,
                                     f_left, f_right);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int srcnn_int8_n_params() { return N_BYTES; }

// The tile walk is 64-bit and the grid has one block per SM slot, so the
// limit is the int row arithmetic of a tile (r0 + WH, h + 2 HALO).
int srcnn_int8_max_rows() { return INT_MAX - WH - 2 * HALO - TH; }

// y: [n, h+12, w+12] f32, out: [n, h, w] f32, both contiguous; params:
// N_BYTES bytes in the packed layout, 16-byte aligned; all on the current
// device.  Launches on `stream`; returns the cudaError_t of the set-up or
// the launch (0 on success).
int srcnn_int8_forward(const float* y, float* out,
                       const unsigned char* params, int n, int h, int w,
                       int f_top, int f_bottom, int f_left, int f_right,
                       void* stream) {
  return launch<FULL>(y, out, params, n, h, w, f_top, f_bottom, f_left,
                      f_right, static_cast<cudaStream_t>(stream));
}

#ifdef SRCNN_PROFILING
// The profiling cuts of K4 (K7 of kernels/ablation.py): as
// srcnn_int8_forward, stopped after `stage` (LOAD, CONV1, CONV2, TAPS or
// FULL).
int srcnn_int8_cut_forward(const float* y, float* out,
                           const unsigned char* params, int n, int h, int w,
                           int f_top, int f_bottom, int f_left, int f_right,
                           int stage, void* stream) {
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
