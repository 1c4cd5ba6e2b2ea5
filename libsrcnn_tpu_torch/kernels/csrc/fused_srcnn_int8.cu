// Fused SRCNN 9-1-5 forward on the int8 tensor cores, for Hopper (sm_90a):
// the int8 tier, kernel K4.
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
// so the output does not depend on where a pixel sits in its tile.  Each
// epilogue is an f32 multiply, then an f32 add, then rintf, written with
// __fmul_rn / __fadd_rn so that nvcc cannot contract them into one FMA;
// 127/255 comes in with the parameters as the f32 value the plain version
// multiplies by.  So K4 equals the plain version
// (kernels/fused_conv.forward_y_int8_reference) bit for bit.
// Input: n Y planes with a 6 px halo, [n, h+12, w+12] f32, contiguous; one
// launch covers the batch (blockIdx.z is the plane).
//
// What bounds it: operations.  8,032 MACs per output pixel, 67.4 G int8
// operations at 2048^2: 0.034 ms at the card's 1,979 TOPS dense int8,
// against 0.010 ms to move the ~34 MB of planes.  This version reaches the
// tensor cores through mma.sync.m16n8k32 (not wgmma), builds conv1's A
// fragments from byte loads of the window (an im2col done in registers),
// recomputes each tile's c2 ring (1.42x for 12 x 60 tiles) and runs one
// 256-thread block per SM, so it sits well above that bound (PERF.md).
//
// Design (that of the bf16 kernel, fused_srcnn_bf16.cu, in int8):
// * One block (256 threads, 8 warps) per 12 x 60 output tile; the c2 ring
//   is 16 x 64.  The block quantizes its 24 x 72 input window once into
//   int8 codes in shared memory, and stages the weights as mma B fragments
//   and the f32 scales.
// * conv1, conv2 and conv3's tap products are GEMMs with M = ring positions
//   (a warp takes two 16-position m-tiles at a time): conv1 K = 81 taps
//   padded to 96 with zero-weight rows (three k32 steps), N = 64; conv2
//   K = 64, N = 32; conv3 K = 32 channels, N = 25 taps padded to 32, as the
//   TPU kernel does it (fused_conv.py:375-382).
// * Fragments.  The s32 m16n8 accumulator layout is not the s8 m16k32 A
//   layout: a lane holds columns 2q and 2q+1 of each 8-wide n-tile, while
//   an A register holds 4 consecutive k.  So conv2 and the tap GEMM
//   contract over a permuted channel order, logical k = 32s + 16h + 4q +
//   2u + v <-> channel 8(4s + 2h + u) + 2q + v (perm_ch): a lane's
//   requantized values of n-tiles 4s+2h and 4s+2h+1 then pack straight
//   into one A register, and the B fragments of w2q and of conv3's weights
//   are built with the same permutation when they are staged.  (Of the two
//   ways, this is "permute the K rows of the weights", done while staging;
//   h1 and c2 never leave the registers.)  Only the 25 int32 tap planes go
//   to shared memory.
// * The border clamp is K1's coordinate clamp, applied to the tap planes:
//   a tap product at a ring position is a function of that position's
//   acc2 alone, so copying it from the clamped position equals clamping
//   acc2 (srcnn::ring_clamp, on int32).
// * conv3's output is an int32 shift-add of the tap planes, then one f32
//   scale: out = clip(acc * d3 + b3, 0, 255).
// * Every parameter comes in through `params` (int8 weights and f32
//   scales in one byte buffer); nothing outlives a launch.
//
// * Profiling cuts (K7 of kernels/ablation.py, built only with
//   -DSRCNN_PROFILING): the STAGE template argument stops the kernel after
//   the quantized window and the B fragments are in shared memory (LOAD;
//   the TPU tool's dma, roll, quant and im2col are this one phase here),
//   after conv1, conv2 or the tap GEMM (TAPS); srcnn_common.cuh says what
//   a cut writes.  Its values are integer sums, so the cuts equal their
//   plain versions bit for bit too.  The production kernel is the FULL
//   instance.
//
// Later work: wgmma, conv1's A operand from a shared-memory im2col instead
// of byte loads, B fragments packed once per parameter set, a persistent
// grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "srcnn_common.cuh"

namespace {

using namespace srcnn;

constexpr int TH = 12, TW = 60;           // output tile
constexpr int NT = 256;                   // threads per block
constexpr int NWARP = NT / 32;
constexpr int MT = 2;                     // m-tiles per warp step
constexpr int RH = TH + 4, RW = TW + 4;   // c2 ring tile, 16 x 64
constexpr int M = RH * RW;                // ring positions
constexpr int WH = RH + 8, WW = RW + 8;   // input window, 24 x 72
constexpr int GS = M + 4;                 // tap-plane stride: spreads banks
constexpr int KS1 = 3;                    // conv1 k32 steps: 81 taps -> 96

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

// Shared memory, in bytes; every region starts 16-byte aligned.
constexpr int B_G = 25 * GS * 4;          // conv3's tap planes, int32
constexpr int B_W1F = KS1 * 8 * 32 * 8;   // conv1 B fragments
constexpr int B_W2F = 2 * 4 * 32 * 8;     // conv2 B fragments
constexpr int B_W3F = 1 * 4 * 32 * 8;     // conv3 B fragments
constexpr int B_SC = (N_SC + 15) / 16 * 16 * 4;
constexpr int B_WIN = WH * WW;            // int8 codes
constexpr size_t SMEM = B_G + B_W1F + B_W2F + B_W3F + B_SC + B_WIN;
static_assert(RW % 16 == 0 && (M / 16) % (NWARP * MT) == 0, "tiling");

// d += a * b, m16n8k32, s8 operands, s32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The folded requant, clip(rint(acc * s + t), 0, 127), as a code in the
// low byte: the multiply and the add rounded separately, as the plain
// version's two torch ops.  acc is exact in f32 (|acc| < 2^24).
__device__ __forceinline__ uint32_t requant(int acc, float s, float t) {
  const float v = rintf(__fadd_rn(__fmul_rn(static_cast<float>(acc), s), t));
  return static_cast<uint32_t>(fminf(fmaxf(v, 0.f), 127.f));
}

// channel of logical GEMM row k of conv2 and of the tap GEMM (see Design)
__device__ __forceinline__ int perm_ch(int k) {
  const int s = k / 32, h = (k / 16) % 2, q = (k / 4) % 4, u = (k / 2) % 2;
  return 8 * (4 * s + 2 * h + u) + 2 * q + k % 2;
}

__device__ __forceinline__ uint32_t byte_of(const int8_t* p, int i) {
  return static_cast<uint32_t>(static_cast<uint8_t>(p[i]));
}

// window offset of conv1 tap k (rows past the taps read tap 80: finite,
// and their weights are zero)
__device__ __forceinline__ int tap_offset(int tap) {
  tap = min(tap, 80);
  return (tap / 9) * WW + tap % 9;
}

// four window codes, at offsets b + off[0..3], as one A register
__device__ __forceinline__ uint32_t gather4(const uint8_t* win, int b,
                                            const int* off) {
  return uint32_t(win[b + off[0]]) | (uint32_t(win[b + off[1]]) << 8) |
         (uint32_t(win[b + off[2]]) << 16) | (uint32_t(win[b + off[3]]) << 24);
}

template <int STAGE = FULL>
__global__ void __launch_bounds__(NT, 1)
fused_srcnn_int8_kernel(const float* __restrict__ y,
                        const unsigned char* __restrict__ params,
                        float* __restrict__ out, int h, int w, int f_top,
                        int f_bottom, int f_left, int f_right) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* gs = reinterpret_cast<int*>(smem);                    // [25][GS]
  uint2* w1f = reinterpret_cast<uint2*>(smem + B_G);         // [KS1][8][32]
  uint2* w2f = w1f + KS1 * 8 * 32;                           // [2][4][32]
  uint2* w3f = w2f + 2 * 4 * 32;                             // [4][32]
  float* scs = reinterpret_cast<float*>(w3f + 4 * 32);       // [N_SC]
  uint8_t* winq = reinterpret_cast<uint8_t*>(scs) + B_SC;    // [WH][WW]

  const int8_t* w1q = reinterpret_cast<const int8_t*>(params + Q_W1);
  const int8_t* w2q = reinterpret_cast<const int8_t*>(params + Q_W2);
  const int8_t* w3q = reinterpret_cast<const int8_t*>(params + Q_W3);
  const float* sc = reinterpret_cast<const float*>(params + Q_SC);

  const int t = threadIdx.x;
  const int r0 = blockIdx.y * TH;         // tile origin, output coordinates
  const int q0 = blockIdx.x * TW;
  const int ph = h + 2 * HALO, pw = w + 2 * HALO;
  y += (long long)blockIdx.z * ph * pw;   // this block's plane
  out += (long long)blockIdx.z * h * w;

  // Window = padded rows r0 .. r0+WH-1, cols q0 .. q0+WW-1, quantized
  // once.  Reads past the plane (ragged tiles) are clamped in; they feed
  // only masked outputs.
  const float xs = sc[SC_XS];
  for (int i = t; i < WH * WW; i += NT) {
    const int pr = min(r0 + i / WW, ph - 1);
    const int pc = min(q0 + i % WW, pw - 1);
    const float v = rintf(__fmul_rn(y[(long long)pr * pw + pc], xs));
    winq[i] = static_cast<uint8_t>(fminf(fmaxf(v, 0.f), 127.f));
  }
  // B fragments: lane (g, q) of (k-step s, n-tile j) holds rows
  // 32s + 4q + {0..3} and 32s + 16 + 4q + {0..3} of column 8j + g
  for (int i = t; i < KS1 * 8 * 32; i += NT) {
    const int l = i % 32, j = (i / 32) % 8, s = i / 256;
    const int n = 8 * j + l / 4, k = 32 * s + 4 * (l % 4);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k + e < 81) lo |= byte_of(w1q, (k + e) * C1 + n) << (8 * e);
      if (k + 16 + e < 81) hi |= byte_of(w1q, (k + 16 + e) * C1 + n) << (8 * e);
    }
    w1f[i] = make_uint2(lo, hi);
  }
  for (int i = t; i < 2 * 4 * 32; i += NT) {
    const int l = i % 32, j = (i / 32) % 4, s = i / 128;
    const int n = 8 * j + l / 4, k = 32 * s + 4 * (l % 4);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo |= byte_of(w2q, perm_ch(k + e) * C2 + n) << (8 * e);
      hi |= byte_of(w2q, perm_ch(k + 16 + e) * C2 + n) << (8 * e);
    }
    w2f[i] = make_uint2(lo, hi);
  }
  // conv3 as a GEMM: row k = channel perm_ch(k), column n = tap 5 dy + dx
  for (int i = t; i < 4 * 32; i += NT) {
    const int l = i % 32, j = i / 32;
    const int n = 8 * j + l / 4, k = 4 * (l % 4);
    uint32_t lo = 0, hi = 0;
    if (n < 25) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo |= byte_of(w3q, n * C2 + perm_ch(k + e)) << (8 * e);
        hi |= byte_of(w3q, n * C2 + perm_ch(k + 16 + e)) << (8 * e);
      }
    }
    w3f[i] = make_uint2(lo, hi);
  }
  for (int i = t; i < N_SC; i += NT) scs[i] = sc[i];
  __syncthreads();

  if constexpr (STAGE == LOAD) {          // cut: the centre tap's code
    for (int s = t; s < TH * TW; s += NT) {
      const int a = s / TW + 2, b = s % TW + 2;
      cut_store(out, a, b, r0, q0, TH, TW, h, w,
                static_cast<float>(winq[(a + 4) * WW + b + 4]));
    }
    return;
  }

  const float* s1s = scs + SC_S1;
  const float* t1s = scs + SC_T1;
  const float* s2s = scs + SC_S2;
  const float* t2s = scs + SC_T2;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;   // mma fragment row group, k quad

  // window offsets of the taps this lane feeds to conv1's A fragments:
  // GEMM rows 32s + 4q + {0..3} (registers 0, 1) and 32s + 16 + 4q +
  // {0..3} (registers 2, 3)
  int toff[KS1][8];
#pragma unroll
  for (int s = 0; s < KS1; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      toff[s][e] = tap_offset(32 * s + 4 * q + e);
      toff[s][4 + e] = tap_offset(32 * s + 16 + 4 * q + e);
    }

  constexpr int NMT = M / 16;             // m-tiles in the ring
  constexpr int SEG = RW / 16;            // m-tiles per ring row
#pragma unroll 1
  for (int mt0 = warp * MT; mt0 < NMT; mt0 += NWARP * MT) {
    int base[MT];                         // window offset of row g at tap 0
#pragma unroll
    for (int u = 0; u < MT; ++u) {
      const int mt = mt0 + u;
      base[u] = (mt / SEG) * WW + (mt % SEG) * 16 + g;
    }

    // ---- conv1: [16 x 96] x [96 x 64] per m-tile ----
    int acc[MT][8][4];
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][j][e] = 0;
#pragma unroll
    for (int s = 0; s < KS1; ++s) {
      uint32_t a[MT][4];
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        const int b = base[u];
        a[u][0] = gather4(winq, b, toff[s]);
        a[u][1] = gather4(winq, b + 8, toff[s]);
        a[u][2] = gather4(winq, b, toff[s] + 4);
        a[u][3] = gather4(winq, b + 8, toff[s] + 4);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint2 bf = w1f[(s * 8 + j) * 32 + lane];
#pragma unroll
        for (int u = 0; u < MT; ++u) mma_s8(acc[u][j], a[u], bf);
      }
    }

#pragma unroll
    for (int u = 0; u < MT; ++u) {
      // a cut's integer sums of fragment rows g and g + 8 (below 2^24, so
      // exact as f32), and its store: row g of this m-tile is at ring
      // position pos, row g + 8 eight columns to its right
      int cut0 = 0, cut8 = 0;
      const auto store_cut = [&](int v0, int v8) {
        v0 = quad_sum(v0);
        v8 = quad_sum(v8);
        const int mt = mt0 + u;
        const int pos = (mt / SEG) * RW + (mt % SEG) * 16 + g;
        if (q == 0) {
          cut_store(out, pos / RW, pos % RW, r0, q0, TH, TW, h, w,
                    static_cast<float>(v0));
          cut_store(out, pos / RW, pos % RW + 8, r0, q0, TH, TW, h, w,
                    static_cast<float>(v8));
        }
      };
      if constexpr (STAGE == CONV1) {     // cut: sum of the 64 h1q codes
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * q;
          cut0 += requant(acc[u][j][0], s1s[c], t1s[c]) +
                  requant(acc[u][j][1], s1s[c + 1], t1s[c + 1]);
          cut8 += requant(acc[u][j][2], s1s[c], t1s[c]) +
                  requant(acc[u][j][3], s1s[c + 1], t1s[c + 1]);
        }
        store_cut(cut0, cut8);
        continue;
      }

      // ---- h1q -> conv2's A fragments, in registers: n-tile j of conv1
      // (channels 8j + 2q + {0, 1}) is k-step j/4, half (j/2)%2, byte
      // pair j%2 ----
      uint32_t ah[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * q;
        const int s = j / 4, r = 2 * ((j / 2) % 2), sh = 16 * (j % 2);
        ah[s][r] |= (requant(acc[u][j][0], s1s[c], t1s[c]) |
                     requant(acc[u][j][1], s1s[c + 1], t1s[c + 1]) << 8) << sh;
        ah[s][r + 1] |= (requant(acc[u][j][2], s1s[c], t1s[c]) |
                         requant(acc[u][j][3], s1s[c + 1], t1s[c + 1]) << 8)
                        << sh;
      }

      // ---- conv2: [16 x 64] x [64 x 32] ----
      int a2[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) a2[j][e] = 0;
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(a2[j], ah[s], w2f[(s * 4 + j) * 32 + lane]);

      if constexpr (STAGE == CONV2) {     // cut: sum of the 32 c2q codes
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * j + 2 * q;
          cut0 += requant(a2[j][0], s2s[c], t2s[c]) +
                  requant(a2[j][1], s2s[c + 1], t2s[c + 1]);
          cut8 += requant(a2[j][2], s2s[c], t2s[c]) +
                  requant(a2[j][3], s2s[c + 1], t2s[c + 1]);
        }
        store_cut(cut0, cut8);
        continue;
      }

      // ---- c2q -> the tap GEMM's A fragment (the ring clamp acts on the
      // tap planes below) ----
      uint32_t ch[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * j + 2 * q;
        const int r = 2 * (j / 2), sh = 16 * (j % 2);
        ch[r] |= (requant(a2[j][0], s2s[c], t2s[c]) |
                  requant(a2[j][1], s2s[c + 1], t2s[c + 1]) << 8) << sh;
        ch[r + 1] |= (requant(a2[j][2], s2s[c], t2s[c]) |
                      requant(a2[j][3], s2s[c + 1], t2s[c + 1]) << 8) << sh;
      }

      // ---- conv3's tap products: [16 x 32] x [32 x 25 (32)] ----
      int g3[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) g3[j][e] = 0;
        mma_s8(g3[j], ch, w3f[j * 32 + lane]);
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
  if constexpr (STAGE != FULL) return;
  __syncthreads();

  // ---- border clamp on the ring's tap planes: global c2 rows r0-2 ..
  // r0+RH-3 ----
  ring_clamp<RH, RW, NT, 25>(gs, GS, r0, q0, h, w, f_top, f_bottom, f_left,
                             f_right);

  // ---- conv3: int32 shift-add of the tap planes, one f32 scale, clamp ----
  const float d3 = scs[SC_D3], b3 = scs[SC_B3];
  for (int s = t; s < TH * TW; s += NT) {
    const int ty = s / TW, tx = s % TW;
    const int* gp = gs + ty * RW + tx;
    int a = 0;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy)
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) a += gp[(dy * 5 + dx) * GS + dy * RW + dx];
    const int orow = r0 + ty, ocol = q0 + tx;
    if (orow < h && ocol < w) {
      const float o = __fadd_rn(__fmul_rn(static_cast<float>(a), d3), b3);
      out[(long long)orow * w + ocol] = fminf(fmaxf(o, 0.f), 255.f);
    }
  }
}

template <int STAGE>
cudaError_t launch(const float* y, float* out, const unsigned char* params,
                   int n, int h, int w, int f_top, int f_bottom, int f_left,
                   int f_right, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_srcnn_int8_kernel<STAGE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  fused_srcnn_int8_kernel<STAGE><<<grid, NT, SMEM, stream>>>(
      y, params, out, h, w, f_top, f_bottom, f_left, f_right);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int srcnn_int8_n_params() { return N_BYTES; }

int srcnn_int8_max_rows() { return 65535 * TH; }

// y: [n, h+12, w+12] f32, out: [n, h, w] f32, both contiguous; params:
// N_BYTES bytes in the packed layout, 16-byte aligned; all on the current
// device.  Launches on `stream`; returns the cudaError_t of the set-up or
// the launch (0 on success).  n <= 65535.
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
    case LOAD:
      return launch<LOAD>(y, out, params, n, h, w, f_top, f_bottom, f_left,
                          f_right, s);
    case CONV1:
      return launch<CONV1>(y, out, params, n, h, w, f_top, f_bottom, f_left,
                           f_right, s);
    case CONV2:
      return launch<CONV2>(y, out, params, n, h, w, f_top, f_bottom, f_left,
                           f_right, s);
    case TAPS:
      return launch<TAPS>(y, out, params, n, h, w, f_top, f_bottom, f_left,
                          f_right, s);
    case FULL:
      return launch<FULL>(y, out, params, n, h, w, f_top, f_bottom, f_left,
                          f_right, s);
    default:
      return cudaErrorInvalidValue;
  }
}
#endif  // SRCNN_PROFILING

}  // extern "C"
