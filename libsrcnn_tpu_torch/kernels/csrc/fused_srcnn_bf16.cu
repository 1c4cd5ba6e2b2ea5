// Fused SRCNN 9-1-5 forward on the bf16 tensor cores, for Hopper (sm_90a):
// the throughput tiers.
//
// Replaces libsrcnn_tpu/kernels/fused_conv.py::_kernel in its three bf16
// forms, each a template instance here:
//   K2  split    precision=DEFAULT, pack=None: every GEMM operand split into
//                hi = bf16(x) and lo = bf16(x - hi), two bf16 passes summed
//                in f32 (`_dot`, conv3 at :310-320);
//   K3  bf16x1   pack="pair": every operand rounded to bf16 once, one pass
//                (:213-242; the i32 pair words are a Mosaic store
//                workaround and are not carried over);
//   K3h hilo     pack="hilo": K2's math, with conv1 contracting hi and lo
//                of each tap interleaved along K (depth 162) against
//                row-duplicated bf16(w1) (:243-269);
//   K3n narrow   K3 on a narrower output tile (the NARROW geometry,
//                :60-73); its output is bit-identical to K3's.
// Per output pixel of an [h, w] plane: conv1 9x9 1->64 + b1, ReLU; conv2
// 1x1 64->32 + b2, ReLU; the reference's c2 border clamp gated by the edge
// flags; conv3 5x5 32->1 + b3, clamp to [0, 255].  Every GEMM operand is
// bf16: K2 and K3h split each activation into hi and lo, K3 and K3n round
// it once (the TPU kernel's `_dot`, :121-152, and conv3 at :310-320).  Weights are rounded to
// bf16 (round to nearest even, __float2bfloat16_rn) on their way into
// shared memory; biases and every accumulation are f32.
// Input: n Y planes with a 6 px halo, [n, h+12, w+12] f32, contiguous; one
// launch covers the batch (blockIdx.z is the plane).
//
// What bounds it: operations.  8,032 MACs per output pixel, 33.7 G at
// 2048^2: 0.068 ms of the card's 989 TFLOP/s dense bf16 for one pass, 0.14
// ms for the two of the split forms, against 0.01 ms to move the ~34 MB of
// planes.  This version reaches the tensor cores through mma.sync.m16n8k16
// (not wgmma), builds conv1's A fragments with 16-bit shared-memory loads
// (an im2col done in registers), recomputes each tile's c2 ring (1.42x for
// 12 x 60 tiles) and runs one 256-thread block per SM, so it sits well
// above that bound (PERF.md).
//
// Design:
// * One block (256 threads, 8 warps) per 12 x TW output tile; the c2 ring is
//   16 x (TW+4).  The block stages its input window, rounded once to bf16
//   (hi, and lo where the mode splits; packed hi | lo << 16 for K3h), the
//   weights as mma B fragments, and the biases in shared memory.
// * conv1, conv2 and conv3's tap products are GEMMs with M = ring positions
//   (a warp takes two 16-position m-tiles at a time): conv1 K = 81 taps
//   (162 for K3h, padded with zero-weight rows to a multiple of 16), N = 64;
//   conv2 K = 64, N = 32; conv3 K = 32 channels, N = 25 taps (padded to
//   32), as the TPU kernel does it (fused_conv.py:296-321).  Each GEMM's
//   accumulators turn into the next one's A fragments in registers (the
//   m16n8 C layout is the m16k16 A layout), so h1 and c2 never leave the
//   registers; only the 25 tap planes G go to shared memory.
// * The border clamp is K1's coordinate clamp, applied to the tap planes:
//   G at a ring position is a function of that position's c2 alone, so
//   copying G from the clamped position equals clamping c2.
// * conv3's output is a shift-add of the tap planes, out(y, x) = b3 +
//   sum over (dy, dx) of G[5 dy + dx](y + dy, x + dx), in that fixed order.
// * Every pixel's sums run in one fixed order, independent of where the
//   pixel sits in its tile: that is what makes K3n bit-identical to K3.
// * Every parameter comes in through `params`; nothing outlives a launch.
//
// Built with -DSRCNN_PROFILING (a second library, the kernel-profiling
// path of kernels/ablation.py and fused_conv.forward_y_band), the file
// also holds:
// * K5, the row-band geometry (fused_srcnn_band_kernel), replacing
//   fused_conv.py::_kernel_band / _pair_tile (:491-597): K3's per-tile
//   work, one block per band of rows (see the kernel).
// * K6's cuts of K2 and K3: the STAGE template argument stops the kernel
//   after its window and B fragments are in shared memory (LOAD), after
//   conv1, conv2 or the tap GEMM (TAPS); srcnn_common.cuh says what a cut
//   writes.  The TPU tool's roll and im2col stages have no counterpart:
//   there is no lane rotate, and conv1's im2col is done in registers.
//   The production kernels are the FULL instances.
//
// Later work: wgmma with the window in shared memory as its B operand, TMA,
// two blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "srcnn_common.cuh"

namespace {

using namespace srcnn;

enum Mode { SPLIT = 0, BF16X1 = 1, HILO = 2 };

constexpr int TH = 12;                    // output tile rows
constexpr int NT = 256;                   // threads per block
constexpr int NWARP = NT / 32;
constexpr int MT = 2;                     // m-tiles per warp step

template <int MODE, int TW>
struct Geo {
  static constexpr int RH = TH + 4, RW = TW + 4;  // c2 ring tile
  static constexpr int M = RH * RW;               // ring positions
  static constexpr int WH = RH + 8, WW = RW + 8;  // input window
  static constexpr int GS = M + 4;                // tap-plane stride: spreads banks
  static constexpr int KS1 = ((MODE == HILO ? 162 : 81) + 15) / 16;  // 11 / 6
  // shared memory, bytes; every region starts 16-byte aligned
  static constexpr int B_G = 25 * GS * 4;         // conv3's tap planes
  static constexpr int B_W1F = KS1 * 8 * 32 * 8;  // conv1 B fragments
  static constexpr int B_W2F = 4 * 4 * 32 * 8;    // conv2 B fragments
  static constexpr int B_W3F = 2 * 4 * 32 * 8;    // conv3 B fragments
  static constexpr int B_BIAS = (C1 + C2 + 4) * 4;
  static constexpr int B_WIN = (MODE == BF16X1 ? 2 : 4) * WH * WW;
  static constexpr size_t SMEM =
      B_G + B_W1F + B_W2F + B_W3F + B_BIAS + (B_WIN + 15) / 16 * 16;
  static_assert(RW % 16 == 0 && (M / 16) % (NWARP * MT) == 0, "tiling");
};

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

// d += a * b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// conv1 weight of GEMM row k (a tap, or for K3h a tap's hi or lo row) and
// channel n; rows past the taps are zero
template <int MODE>
__device__ __forceinline__ float w1_at(const float* params, int k, int n) {
  const int tap = MODE == HILO ? k / 2 : k;
  return tap < 81 ? params[OFF_W1 + tap * C1 + n] : 0.f;
}

// window offset of conv1 tap k (rows past the taps read tap 80: finite,
// and their weights are zero)
template <int WW>
__device__ __forceinline__ int tap_offset(int tap) {
  tap = min(tap, 80);
  return (tap / 9) * WW + tap % 9;
}

// B fragments of the three GEMMs and the biases, into shared memory.
// Lane (g, q) of (k-step s, n-tile j) holds rows 16s + 2q + {0, 1} and
// 16s + 2q + {8, 9} of column 8j + g.
template <int MODE, int KS1>
__device__ __forceinline__ void stage_params(const float* __restrict__ params,
                                             uint2* w1f, uint2* w2f,
                                             uint2* w3f, float* b1s, int t) {
  float* b2s = b1s + C1;
  float* b3s = b2s + C2;
  for (int i = t; i < KS1 * 8 * 32; i += NT) {
    const int l = i % 32, j = (i / 32) % 8, s = i / 256;
    const int n = 8 * j + l / 4, k = 16 * s + 2 * (l % 4);
    w1f[i] = make_uint2(
        pack_bf16(w1_at<MODE>(params, k, n), w1_at<MODE>(params, k + 1, n)),
        pack_bf16(w1_at<MODE>(params, k + 8, n),
                  w1_at<MODE>(params, k + 9, n)));
  }
  for (int i = t; i < 4 * 4 * 32; i += NT) {
    const int l = i % 32, j = (i / 32) % 4, s = i / 128;
    const int n = 8 * j + l / 4, k = 16 * s + 2 * (l % 4);
    const float* w2 = params + OFF_W2;
    w2f[i] = make_uint2(pack_bf16(w2[k * C2 + n], w2[(k + 1) * C2 + n]),
                        pack_bf16(w2[(k + 8) * C2 + n], w2[(k + 9) * C2 + n]));
  }
  // conv3 as a GEMM: row k = channel, column n = tap 5 dy + dx (< 25)
  for (int i = t; i < 2 * 4 * 32; i += NT) {
    const int l = i % 32, j = (i / 32) % 4, s = i / 128;
    const int n = 8 * j + l / 4, k = 16 * s + 2 * (l % 4);
    const float* w3 = params + OFF_W3 + n * C2;
    w3f[i] = n < 25 ? make_uint2(pack_bf16(w3[k], w3[k + 1]),
                                 pack_bf16(w3[k + 8], w3[k + 9]))
                    : make_uint2(0u, 0u);
  }
  for (int i = t; i < C1 + C2; i += NT)
    b1s[i] = i < C1 ? params[OFF_B1 + i] : params[OFF_B2 + i - C1];
  if (t == 0) b3s[0] = params[OFF_B3];
}

// conv1, conv2 and the tap GEMM over the tile's c2 ring, from the window in
// shared memory: the 25 tap planes into gs.  A cut (STAGE < FULL) writes
// its per-pixel value to `out` instead and leaves gs alone.
template <int MODE, int TW, int STAGE>
__device__ __forceinline__ void ring_gemms(
    const uint16_t* winh, const uint16_t* winl, const uint32_t* winp,
    const uint2* w1f, const uint2* w2f, const uint2* w3f, const float* b1s,
    float* gs, float* __restrict__ out, int r0, int q0, int h, int w,
    int t) {
  using G = Geo<MODE, TW>;
  constexpr int RW = G::RW, WW = G::WW, GS = G::GS;
  constexpr int KS1 = G::KS1;
  const float* b2s = b1s + C1;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;   // mma fragment row group, column pair

  // window offsets of the taps this lane feeds to conv1's A fragments:
  // GEMM rows 16s + 2q + {0, 1, 8, 9} (K3h: rows 2 tap + {hi, lo}, so one
  // tap per register)
  int toff[KS1][4];
#pragma unroll
  for (int s = 0; s < KS1; ++s) {
    const int k = 16 * s + 2 * q;
    if (MODE == HILO) {
      toff[s][0] = toff[s][1] = tap_offset<WW>(k / 2);
      toff[s][2] = toff[s][3] = tap_offset<WW>(k / 2 + 4);
    } else {
      toff[s][0] = tap_offset<WW>(k);
      toff[s][1] = tap_offset<WW>(k + 1);
      toff[s][2] = tap_offset<WW>(k + 8);
      toff[s][3] = tap_offset<WW>(k + 9);
    }
  }

  constexpr int NMT = G::M / 16;          // m-tiles in the ring
  constexpr int SEG = RW / 16;            // m-tiles per ring row
#pragma unroll 1
  for (int mt0 = warp * MT; mt0 < NMT; mt0 += NWARP * MT) {
    int base[MT];                         // window offset of row g at tap 0
#pragma unroll
    for (int u = 0; u < MT; ++u) {
      const int mt = mt0 + u;
      base[u] = (mt / SEG) * WW + (mt % SEG) * 16 + g;
    }

    // ---- conv1: [16 x K] x [K x 64] per m-tile ----
    float acc[MT][8][4];
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;

    // K2 runs the hi pass, then the lo pass, into the same accumulators
#pragma unroll
    for (int pass = 0; pass < (MODE == SPLIT ? 2 : 1); ++pass) {
      const uint16_t* win = pass ? winl : winh;
#pragma unroll
      for (int s = 0; s < KS1; ++s) {
        uint32_t a[MT][4];
#pragma unroll
        for (int u = 0; u < MT; ++u) {
          const int b = base[u];
          if (MODE == HILO) {
            a[u][0] = winp[b + toff[s][0]];
            a[u][1] = winp[b + 8 + toff[s][0]];
            a[u][2] = winp[b + toff[s][2]];
            a[u][3] = winp[b + 8 + toff[s][2]];
          } else {
            a[u][0] = win[b + toff[s][0]] | (uint32_t(win[b + toff[s][1]]) << 16);
            a[u][1] = win[b + 8 + toff[s][0]] |
                      (uint32_t(win[b + 8 + toff[s][1]]) << 16);
            a[u][2] = win[b + toff[s][2]] | (uint32_t(win[b + toff[s][3]]) << 16);
            a[u][3] = win[b + 8 + toff[s][2]] |
                      (uint32_t(win[b + 8 + toff[s][3]]) << 16);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint2 bf = w1f[(s * 8 + j) * 32 + lane];
#pragma unroll
          for (int u = 0; u < MT; ++u) mma_bf16(acc[u][j], a[u], bf);
        }
      }
    }

#pragma unroll
    for (int u = 0; u < MT; ++u) {
      // ---- h1 = ReLU(conv1 + b1) -> conv2's A fragments, in registers:
      // n-tiles 2s and 2s+1 of conv1 are k-step s of conv2 ----
      uint32_t ah[4][4], al[4][4];
      float cut0 = 0.f, cut8 = 0.f;       // a cut's sums of rows g, g + 8
      // a cut's store: row g of this m-tile is at ring position pos, row
      // g + 8 eight columns to its right
      const auto store_cut = [&](float v0, float v8) {
        v0 = quad_sum(v0);
        v8 = quad_sum(v8);
        const int mt = mt0 + u;
        const int pos = (mt / SEG) * RW + (mt % SEG) * 16 + g;
        if (q == 0) {
          cut_store(out, pos / RW, pos % RW, r0, q0, TH, TW, h, w, v0);
          cut_store(out, pos / RW, pos % RW + 8, r0, q0, TH, TW, h, w, v8);
        }
      };
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * q;
        const float v0 = fmaxf(acc[u][j][0] + b1s[c], 0.f);
        const float v1 = fmaxf(acc[u][j][1] + b1s[c + 1], 0.f);
        const float v2 = fmaxf(acc[u][j][2] + b1s[c], 0.f);
        const float v3 = fmaxf(acc[u][j][3] + b1s[c + 1], 0.f);
        if constexpr (STAGE == CONV1) {
          cut0 += v0 + v1;
          cut8 += v2 + v3;
          continue;
        }
        const int s = j / 2, r = 2 * (j % 2);
        ah[s][r] = pack_bf16(v0, v1);
        ah[s][r + 1] = pack_bf16(v2, v3);
        if (MODE != BF16X1) {
          al[s][r] = pack_bf16(v0 - bf16_round(v0), v1 - bf16_round(v1));
          al[s][r + 1] = pack_bf16(v2 - bf16_round(v2), v3 - bf16_round(v3));
        }
      }
      if constexpr (STAGE == CONV1) {     // cut: sum of the 64 h1 channels
        store_cut(cut0, cut8);
        continue;
      }

      // ---- conv2: [16 x 64] x [64 x 32] ----
      float a2[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) a2[j][e] = 0.f;
#pragma unroll
      for (int pass = 0; pass < (MODE == BF16X1 ? 1 : 2); ++pass)
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint2 bf = w2f[(s * 4 + j) * 32 + lane];
            if (pass == 0)
              mma_bf16(a2[j], ah[s], bf);
            else
              mma_bf16(a2[j], al[s], bf);
          }

      // ---- c2 = ReLU(conv2 + b2) -> the tap GEMM's A fragments ----
      uint32_t ch[2][4], cl[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * j + 2 * q;
        const float v0 = fmaxf(a2[j][0] + b2s[c], 0.f);
        const float v1 = fmaxf(a2[j][1] + b2s[c + 1], 0.f);
        const float v2 = fmaxf(a2[j][2] + b2s[c], 0.f);
        const float v3 = fmaxf(a2[j][3] + b2s[c + 1], 0.f);
        if constexpr (STAGE == CONV2) {
          cut0 += v0 + v1;
          cut8 += v2 + v3;
          continue;
        }
        const int s = j / 2, r = 2 * (j % 2);
        ch[s][r] = pack_bf16(v0, v1);
        ch[s][r + 1] = pack_bf16(v2, v3);
        if (MODE != BF16X1) {
          cl[s][r] = pack_bf16(v0 - bf16_round(v0), v1 - bf16_round(v1));
          cl[s][r + 1] = pack_bf16(v2 - bf16_round(v2), v3 - bf16_round(v3));
        }
      }
      if constexpr (STAGE == CONV2) {     // cut: sum of the 32 c2 channels
        store_cut(cut0, cut8);
        continue;
      }

      // ---- conv3's tap products: [16 x 32] x [32 x 25 (32)] ----
      float g3[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) g3[j][e] = 0.f;
#pragma unroll
      for (int pass = 0; pass < (MODE == BF16X1 ? 1 : 2); ++pass)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint2 bf = w3f[(s * 4 + j) * 32 + lane];
            if (pass == 0)
              mma_bf16(g3[j], ch[s], bf);
            else
              mma_bf16(g3[j], cl[s], bf);
          }

      if constexpr (STAGE == TAPS) {      // cut: sum of the 25 taps
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 8 * j + 2 * q;
          if (k < 25) {
            cut0 += g3[j][0];
            cut8 += g3[j][2];
          }
          if (k + 1 < 25) {
            cut0 += g3[j][1];
            cut8 += g3[j][3];
          }
        }
        store_cut(cut0, cut8);
        continue;
      }

      // ---- the 25 tap planes -> shared memory ----
      const int mt = mt0 + u;
      const int pos = (mt / SEG) * RW + (mt % SEG) * 16 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 8 * j + 2 * q;
        if (k < 25) {
          gs[k * GS + pos] = g3[j][0];
          gs[k * GS + pos + 8] = g3[j][2];
        }
        if (k + 1 < 25) {
          gs[(k + 1) * GS + pos] = g3[j][1];
          gs[(k + 1) * GS + pos + 8] = g3[j][3];
        }
      }
    }
  }
}

// conv3: shift-add of the (clamped) tap planes, + b3, clamp; output rows
// r0 .. below `h_end` and columns below w
template <int TW>
__device__ __forceinline__ void conv3_out(const float* gs, const float* b3s,
                                          float* __restrict__ out, int r0,
                                          int q0, int h_end, int w, int t) {
  using G = Geo<BF16X1, TW>;              // the ring's shape is MODE's-free
  constexpr int RW = G::RW, GS = G::GS;
  for (int s = t; s < TH * TW; s += NT) {
    const int ty = s / TW, tx = s % TW;
    const float* gp = gs + ty * RW + tx;
    float o = 0.f;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy)
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) o += gp[(dy * 5 + dx) * GS + dy * RW + dx];
    const int orow = r0 + ty, ocol = q0 + tx;
    if (orow < h_end && ocol < w)
      out[(long long)orow * w + ocol] = fminf(fmaxf(o + b3s[0], 0.f), 255.f);
  }
}

template <int MODE, int TW, int STAGE = FULL>
__global__ void __launch_bounds__(NT, 1)
fused_srcnn_bf16_kernel(const float* __restrict__ y,
                        const float* __restrict__ params,
                        float* __restrict__ out, int h, int w, int f_top,
                        int f_bottom, int f_left, int f_right) {
  using G = Geo<MODE, TW>;
  constexpr int WW = G::WW, WH = G::WH, GS = G::GS;
  constexpr int KS1 = G::KS1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);                // [25][GS]
  uint2* w1f = reinterpret_cast<uint2*>(smem + G::B_G);      // [KS1][8][32]
  uint2* w2f = w1f + KS1 * 8 * 32;                           // [4][4][32]
  uint2* w3f = w2f + 4 * 4 * 32;                             // [2][4][32]
  float* b1s = reinterpret_cast<float*>(w3f + 2 * 4 * 32);
  float* b3s = b1s + C1 + C2;
  unsigned char* winb = reinterpret_cast<unsigned char*>(b1s) + G::B_BIAS;
  uint16_t* winh = reinterpret_cast<uint16_t*>(winb);       // bf16 hi
  uint16_t* winl = winh + WH * WW;                          // bf16 lo (K2)
  uint32_t* winp = reinterpret_cast<uint32_t*>(winb);       // hi | lo << 16 (K3h)

  const int t = threadIdx.x;
  const int r0 = blockIdx.y * TH;         // tile origin, output coordinates
  const int q0 = blockIdx.x * TW;
  const int ph = h + 2 * HALO, pw = w + 2 * HALO;
  y += (long long)blockIdx.z * ph * pw;   // this block's plane
  out += (long long)blockIdx.z * h * w;

  // Window = padded rows r0 .. r0+WH-1, cols q0 .. q0+WW-1, rounded once.
  // Reads past the plane (ragged tiles) are clamped in; they feed only
  // masked outputs.
  for (int i = t; i < WH * WW; i += NT) {
    const int pr = min(r0 + i / WW, ph - 1);
    const int pc = min(q0 + i % WW, pw - 1);
    const float v = y[(long long)pr * pw + pc];
    const float hi = bf16_round(v);
    if (MODE == BF16X1) {
      winh[i] = bf16_bits(v);
    } else if (MODE == SPLIT) {
      winh[i] = bf16_bits(v);
      winl[i] = bf16_bits(v - hi);
    } else {
      winp[i] = bf16_bits(v) | (bf16_bits(v - hi) << 16);
    }
  }
  stage_params<MODE, KS1>(params, w1f, w2f, w3f, b1s, t);
  __syncthreads();

  if constexpr (STAGE == LOAD) {          // cut: the centre tap as rounded
    static_assert(MODE != HILO, "K3h has no cuts");
    for (int s = t; s < TH * TW; s += NT) {
      const int a = s / TW + 2, b = s % TW + 2;
      const int i = (a + 4) * WW + b + 4;
      float v = __bfloat162float(__ushort_as_bfloat16(winh[i]));
      if (MODE == SPLIT) v += __bfloat162float(__ushort_as_bfloat16(winl[i]));
      cut_store(out, a, b, r0, q0, TH, TW, h, w, v);
    }
    return;
  }

  ring_gemms<MODE, TW, STAGE>(winh, winl, winp, w1f, w2f, w3f, b1s, gs, out,
                              r0, q0, h, w, t);
  if constexpr (STAGE != FULL) return;
  __syncthreads();

  // ---- border clamp on the ring's tap planes: global c2 rows r0-2 ..
  // r0+RH-3 ----
  ring_clamp<G::RH, G::RW, NT, 25>(gs, GS, r0, q0, h, w, f_top, f_bottom,
                                   f_left, f_right);

  conv3_out<TW>(gs, b3s, out, r0, q0, h, w, t);
}

#ifdef SRCNN_PROFILING
// K5, the row-band launch geometry of K3: one block per band of `tile_h`
// output rows, which it covers with 12-row tiles (the last one cut at the
// band's end) and walks each tile row's column tiles left to right.  The B
// fragments and biases are staged once per band.  The window is a rolling
// one: of a column tile's 24 x 72 window, the 12 columns it shares with
// the tile before are moved along in shared memory, and only the 60 new
// ones are read and rounded.  Every pixel runs K3's arithmetic in K3's
// order (ring_gemms, conv3_out), so the output equals K3's bit for bit.
__global__ void __launch_bounds__(NT, 1)
fused_srcnn_band_kernel(const float* __restrict__ y,
                        const float* __restrict__ params,
                        float* __restrict__ out, int h, int w, int tile_h,
                        int f_top, int f_bottom, int f_left, int f_right) {
  constexpr int TW = 60;
  using G = Geo<BF16X1, TW>;
  constexpr int WW = G::WW, WH = G::WH, GS = G::GS, KEEP = WW - TW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);
  uint2* w1f = reinterpret_cast<uint2*>(smem + G::B_G);
  uint2* w2f = w1f + G::KS1 * 8 * 32;
  uint2* w3f = w2f + 4 * 4 * 32;
  float* b1s = reinterpret_cast<float*>(w3f + 2 * 4 * 32);
  float* b3s = b1s + C1 + C2;
  uint16_t* winh = reinterpret_cast<uint16_t*>(
      reinterpret_cast<unsigned char*>(b1s) + G::B_BIAS);

  const int t = threadIdx.x;
  const int band0 = blockIdx.x * tile_h;  // the band's output rows
  const int band1 = min(band0 + tile_h, h);
  const int ph = h + 2 * HALO, pw = w + 2 * HALO;
  y += (long long)blockIdx.z * ph * pw;
  out += (long long)blockIdx.z * h * w;

  stage_params<BF16X1, G::KS1>(params, w1f, w2f, w3f, b1s, t);
  for (int r0 = band0; r0 < band1; r0 += TH) {
    for (int q0 = 0; q0 < w; q0 += TW) {
      // window columns c0 .. WW-1 are read; 0 .. c0-1 are kept
      const int c0 = q0 == 0 ? 0 : KEEP;
      if (c0) {
        for (int i = t; i < WH * KEEP; i += NT) {
          const int r = i / KEEP, c = i % KEEP;
          winh[r * WW + c] = winh[r * WW + TW + c];
        }
        __syncthreads();
      }
      const int nc = WW - c0;
      for (int i = t; i < WH * nc; i += NT) {
        const int r = i / nc, c = c0 + i % nc;
        const int pr = min(r0 + r, ph - 1), pc = min(q0 + c, pw - 1);
        winh[r * WW + c] = bf16_bits(y[(long long)pr * pw + pc]);
      }
      __syncthreads();

      ring_gemms<BF16X1, TW, FULL>(winh, nullptr, nullptr, w1f, w2f, w3f,
                                   b1s, gs, out, r0, q0, h, w, t);
      __syncthreads();
      ring_clamp<G::RH, G::RW, NT, 25>(gs, GS, r0, q0, h, w, f_top,
                                       f_bottom, f_left, f_right);
      conv3_out<TW>(gs, b3s, out, r0, q0, band1, w, t);
      __syncthreads();                    // gs and the window are rewritten
    }
  }
}
#endif  // SRCNN_PROFILING

template <int MODE, int TW, int STAGE = FULL>
cudaError_t launch(const float* y, float* out, const float* params, int n,
                   int h, int w, int f_top, int f_bottom, int f_left,
                   int f_right, cudaStream_t stream) {
  constexpr size_t smem = Geo<MODE, TW>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      fused_srcnn_bf16_kernel<MODE, TW, STAGE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  fused_srcnn_bf16_kernel<MODE, TW, STAGE><<<grid, NT, smem, stream>>>(
      y, params, out, h, w, f_top, f_bottom, f_left, f_right);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int srcnn_bf16_n_params() { return N_PARAMS; }

int srcnn_bf16_max_rows() { return 65535 * TH; }

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
      return launch<SPLIT, 60>(y, out, params, n, h, w, f_top, f_bottom,
                               f_left, f_right, s);
    case 1:
      return launch<BF16X1, 60>(y, out, params, n, h, w, f_top, f_bottom,
                                f_left, f_right, s);
    case 2:
      return launch<HILO, 60>(y, out, params, n, h, w, f_top, f_bottom,
                              f_left, f_right, s);
    case 3:
      return launch<BF16X1, 28>(y, out, params, n, h, w, f_top, f_bottom,
                                f_left, f_right, s);
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
    return launch<M, 60, S>(y, out, params, n, h, w, f_top, f_bottom,     \
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
  constexpr size_t smem = Geo<BF16X1, 60>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      fused_srcnn_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((h + tile_h - 1) / tile_h, 1, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_srcnn_band_kernel<<<grid, NT, smem, s>>>(
      y, params, out, h, w, tile_h, f_top, f_bottom, f_left, f_right);
  return cudaGetLastError();
}
#endif  // SRCNN_PROFILING

}  // extern "C"
