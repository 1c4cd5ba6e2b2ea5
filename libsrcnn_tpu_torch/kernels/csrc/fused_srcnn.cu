// Fused SRCNN 9-1-5 forward, exact f32, for Hopper (sm_90a).
//
// Replaces libsrcnn_tpu/kernels/fused_conv.py::_kernel at
// precision=HIGHEST (pack=None), the Pallas kernel of the exact tier.  One
// launch computes, per output pixel of an [h, w] plane:
//   conv1 9x9 1->64 + b1, ReLU;  conv2 1x1 64->32 + b2, ReLU;
//   the reference's conv2-output border clamp (libsrcnn.cpp:463-489);
//   conv3 5x5 32->1 + b3, clamp to [0, 255].
// Input: n Y planes with a 6 px halo, [n, h+12, w+12] f32, contiguous; one
// launch covers the batch (blockIdx.z is the plane).
//
// What bounds it: f32 FMA throughput.  The exact tier forbids TF32 and
// bf16 tensor cores, so every MAC runs on the FMA units: 81*64 + 64*32 =
// 7,232 MACs per c2 position and 25*32 = 800 per output pixel, with the c2
// ring of each tile recomputed by its neighbours (16*64 / (12*60) = 1.42x),
// about 11k MACs per output pixel in all, 46 G FMA per 2048x2048 plane.
// Measured on an H100 SXM at 700 W: ~2.8 ms per 2048x2048 plane, ~16
// TFMA/s, about half the FMA units' peak (PERF.md).
//
// Design:
// * One block (256 threads) per 12 x 60 output tile.  The block copies its
//   24 x 72 input window and the conv1 / conv2 weights to shared memory.
// * conv1 and conv2 run as register-tiled GEMMs over the tile's 16 x 64 c2
//   ring, in chunks of 128 positions (two ring rows).  conv1: each thread
//   owns 4 adjacent positions x 8 channels, loads one 12-float input row
//   segment per tap row and two float4 of weights per tap, and so reuses
//   each loaded value 4-8 times from registers.  h1 goes to shared memory
//   once per chunk; conv2: each thread owns 4 positions x 4 channels.
//   c2 stays in shared memory for the whole ring.  The 64- and 32-channel
//   intermediates never touch device memory.
// * Thread t handles channels (t % 8) + 8 i, so the h1 / c2 stores and the
//   weight loads of a quarter-warp fall in distinct banks; the shared
//   weight copies are permuted to match.
// * The border clamp is a coordinate clamp, applied to shared c2 after the
//   ring is computed: where an edge's flag is set, a ring position outside
//   [0,h) x [0,w) takes the c2 of the clamped position, which lies in the
//   ring.  Where the flag is 0 the ring keeps the c2 of the real halo
//   pixels (banded / sharded callers).  Only blocks on such an edge run it.
// * conv3: each thread computes a 1 x 4 strip of outputs from shared c2,
//   the channel loop unrolled by 8 (fully unrolled, the compiler hoists
//   all 800 shared weights into registers and spills).
// * Every parameter comes in through the `params` pointer.  w1 and w2 are
//   staged in shared memory (permuted, above), the biases and conv3's
//   weights (897 floats) as they are.  No state outlives a launch, so
//   launches with other parameters on other streams cannot interfere.
// * Ragged tiles clamp their window reads into the plane and mask their
//   output stores; offsets into the planes are 64-bit.
//
// * Profiling cuts (K6 of kernels/ablation.py, built only with
//   -DSRCNN_PROFILING): the STAGE template argument stops the kernel after
//   its window and weights are in shared memory (LOAD), after conv1 (CONV1)
//   or after conv2 (CONV2); srcnn_common.cuh says what a cut writes.  The
//   TPU tool's dma / roll / im2col stages have no counterpart here: there
//   is no lane rotate, and conv1 reads its taps straight from the window.
//   The production kernel is the FULL instance.
//
// Later work: 3xTF32 split products on wgmma, TMA windows, a persistent
// grid.

#include <cuda_runtime.h>

#include "srcnn_common.cuh"

namespace {

using namespace srcnn;

constexpr int TH = 12, TW = 60;           // output tile
constexpr int NT = 256;                   // threads per block
constexpr int RH = TH + 4, RW = TW + 4;   // c2 ring tile, 16 x 64
constexpr int M = RH * RW;                // ring positions
constexpr int WH = RH + 8, WW = RW + 8;   // input window, 24 x 72
constexpr int CHUNK = 128;                // ring positions per conv1/conv2 chunk
constexpr int H1S = CHUNK + 4;            // h1 row stride: spreads banks
constexpr int C2S = M + 4;                // c2 row stride: spreads banks

// Shared memory, in floats; every region starts 16-byte aligned.
constexpr int SM_WIN = WH * WW;
constexpr int SM_W1 = 81 * C1;
constexpr int SM_W2 = C1 * C2;
constexpr int SM_H1 = C1 * H1S;
constexpr int SM_C2 = C2 * C2S;
constexpr int SM_REST = N_PARAMS - SM_W1 - SM_W2;  // b1 b2 w3 b3: 897
constexpr int SM_RESTP = (SM_REST + 3) / 4 * 4;
constexpr size_t SMEM_BYTES =
    (SM_WIN + SM_W1 + SM_W2 + SM_H1 + SM_C2 + SM_RESTP) *
    sizeof(float);                                            // 204,816

template <int STAGE = FULL>
__global__ void __launch_bounds__(NT, 1)
fused_srcnn_kernel(const float* __restrict__ y,
                   const float* __restrict__ params,
                   float* __restrict__ out, int h, int w,
                   int f_top, int f_bottom, int f_left, int f_right) {
  extern __shared__ __align__(16) float smem[];
  float* win = smem;                      // [WH][WW]
  float* w1s = win + SM_WIN;              // [81][64], permuted (below)
  float* w2s = w1s + SM_W1;               // [64][32], permuted (below)
  float* h1s = w2s + SM_W2;               // [64][H1S], one chunk
  float* c2s = h1s + SM_H1;               // [32][C2S], the whole ring
  float* rest = c2s + SM_C2;              // b1 [64], b2 [32], w3 [25][32], b3
  const float* b1s = rest;
  const float* b2s = b1s + C1;
  const float* w3s = b2s + C2;
  const float* b3s = w3s + 25 * C2;

  const int t = threadIdx.x;
  const int r0 = blockIdx.y * TH;         // tile origin, output coordinates
  const int q0 = blockIdx.x * TW;
  const int ph = h + 2 * HALO, pw = w + 2 * HALO;
  y += (long long)blockIdx.z * ph * pw;   // this block's plane
  out += (long long)blockIdx.z * h * w;

  // Window = padded rows r0 .. r0+WH-1, cols q0 .. q0+WW-1.  Reads past
  // the plane (ragged tiles) are clamped in; they feed only masked outputs.
  for (int i = t; i < SM_WIN; i += NT) {
    const int pr = min(r0 + i / WW, ph - 1);
    const int pc = min(q0 + i % WW, pw - 1);
    win[i] = y[(long long)pr * pw + pc];
  }
  // w1s[k][32*half + 4*g + q] = w1[k][g + 8*(4*half + q)]
  for (int s = t; s < SM_W1; s += NT) {
    const int k = s / 64, r = s % 64;
    const int half = r / 32, g = (r % 32) / 4, q = r % 4;
    w1s[s] = params[OFF_W1 + k * C1 + g + 8 * (4 * half + q)];
  }
  // w2s[i][4*g + q] = w2[i][g + 8*q]
  for (int s = t; s < SM_W2; s += NT) {
    const int i = s / 32, r = s % 32;
    w2s[s] = params[OFF_W2 + i * C2 + r / 4 + 8 * (r % 4)];
  }
  for (int s = t; s < SM_REST; s += NT) {
    const int src = s < C1 ? OFF_B1 + s : OFF_B2 + (s - C1);
    rest[s] = params[src];
  }
  __syncthreads();

  if constexpr (STAGE == LOAD) {          // cut: the centre tap
    for (int s = t; s < TH * TW; s += NT) {
      const int a = s / TW + 2, b = s % TW + 2;
      cut_store(out, a, b, r0, q0, TH, TW, h, w, win[(a + 4) * WW + b + 4]);
    }
    return;
  }

  const int g = t % 8;                    // channel group: channels g + 8 i
  const int pg = t / 8;                   // positions 4 pg .. 4 pg + 3 of a chunk
  for (int ch = 0; ch < M / CHUNK; ++ch) {
    // ---- conv1: 4 positions x 8 channels per thread ----
    const int a = ch * (CHUNK / RW) + pg / 16;     // ring row
    const int b0 = (pg % 16) * 4;                  // ring col of the first position
    float acc[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
#pragma unroll 1
    for (int dy = 0; dy < 9; ++dy) {
      // positions b0..b0+3 read window cols b0 .. b0+11 of row a+dy
      const float4* ip = reinterpret_cast<const float4*>(win + (a + dy) * WW + b0);
      const float4 i0 = ip[0], i1 = ip[1], i2 = ip[2];
      const float x[12] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y,
                           i1.z, i1.w, i2.x, i2.y, i2.z, i2.w};
#pragma unroll
      for (int dx = 0; dx < 9; ++dx) {
        const float* wk = w1s + (dy * 9 + dx) * C1 + 4 * g;
        const float4 wa = *reinterpret_cast<const float4*>(wk);
        const float4 wb = *reinterpret_cast<const float4*>(wk + 32);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[j][i] = fmaf(x[dx + j], wv[i], acc[j][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = g + 8 * i;
      const float b = b1s[c];
      const float4 v = make_float4(
          fmaxf(acc[0][i] + b, 0.f), fmaxf(acc[1][i] + b, 0.f),
          fmaxf(acc[2][i] + b, 0.f), fmaxf(acc[3][i] + b, 0.f));
      *reinterpret_cast<float4*>(h1s + c * H1S + 4 * pg) = v;
    }
    __syncthreads();

    if constexpr (STAGE == CONV1) {       // cut: sum of the 64 h1 channels
      for (int p = t; p < CHUNK; p += NT) {
        float v = 0.f;
        for (int c = 0; c < C1; ++c) v += h1s[c * H1S + p];
        const int pos = ch * CHUNK + p;
        cut_store(out, pos / RW, pos % RW, r0, q0, TH, TW, h, w, v);
      }
      __syncthreads();                    // h1s is rewritten by the next chunk
      continue;
    }

    // ---- conv2: 4 positions x 4 channels per thread ----
    float a2[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) a2[j][q] = 0.f;
#pragma unroll 8
    for (int i = 0; i < C1; ++i) {
      const float4 hv = *reinterpret_cast<const float4*>(h1s + i * H1S + 4 * pg);
      const float4 wv = *reinterpret_cast<const float4*>(w2s + i * C2 + 4 * g);
      const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
      const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) a2[j][q] = fmaf(hh[j], ww[q], a2[j][q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = g + 8 * q;
      const float b = b2s[c];
      const float4 v = make_float4(
          fmaxf(a2[0][q] + b, 0.f), fmaxf(a2[1][q] + b, 0.f),
          fmaxf(a2[2][q] + b, 0.f), fmaxf(a2[3][q] + b, 0.f));
      *reinterpret_cast<float4*>(c2s + c * C2S + ch * CHUNK + 4 * pg) = v;
    }
    __syncthreads();                      // h1s is rewritten by the next chunk
  }

  if constexpr (STAGE == CONV1) return;
  if constexpr (STAGE == CONV2) {         // cut: sum of the 32 c2 channels
    for (int s = t; s < TH * TW; s += NT) {
      const int a = s / TW + 2, b = s % TW + 2;
      float v = 0.f;
      for (int c = 0; c < C2; ++c) v += c2s[c * C2S + a * RW + b];
      cut_store(out, a, b, r0, q0, TH, TW, h, w, v);
    }
    return;
  }

  // ---- border clamp on the ring: global c2 rows r0-2 .. r0+RH-3 ----
  ring_clamp<RH, RW, NT>(c2s, C2S, r0, q0, h, w, f_top, f_bottom, f_left,
                         f_right);

  // ---- conv3: a 1 x 4 output strip per thread ----
  constexpr int NS = TW / 4;              // strips per tile row
  for (int s = t; s < TH * NS; s += NT) {
    const int ty = s / NS, tx0 = (s % NS) * 4;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int c = 0; c < C2; ++c) {
#pragma unroll
      for (int dy = 0; dy < 5; ++dy) {
        const float4* cp = reinterpret_cast<const float4*>(
            c2s + c * C2S + (ty + dy) * RW + tx0);
        const float4 u = cp[0], v = cp[1];
        const float x[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
        for (int dx = 0; dx < 5; ++dx) {
          const float wt = w3s[(dy * 5 + dx) * C2 + c];
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = fmaf(x[j + dx], wt, o[j]);
        }
      }
    }
    const int orow = r0 + ty;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ocol = q0 + tx0 + j;
      if (orow < h && ocol < w)
        out[(long long)orow * w + ocol] =
            fminf(fmaxf(o[j] + b3s[0], 0.f), 255.f);
    }
  }
}

template <int STAGE>
cudaError_t launch(const float* y, float* out, const float* params, int n,
                   int h, int w, int f_top, int f_bottom, int f_left,
                   int f_right, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_srcnn_kernel<STAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  fused_srcnn_kernel<STAGE><<<grid, NT, SMEM_BYTES, stream>>>(
      y, params, out, h, w, f_top, f_bottom, f_left, f_right);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int srcnn_fused_n_params() { return N_PARAMS; }

int srcnn_fused_max_rows() { return 65535 * TH; }

// y: [n, h+12, w+12] f32, out: [n, h, w] f32, both contiguous; params:
// N_PARAMS f32 in the packed layout; all on the current device.  Launches
// on `stream`; returns the cudaError_t of the set-up or the launch (0 on
// success).  n <= 65535.
int srcnn_fused_forward(const float* y, float* out, const float* params,
                        int n, int h, int w, int f_top, int f_bottom,
                        int f_left, int f_right, void* stream) {
  return launch<FULL>(y, out, params, n, h, w, f_top, f_bottom, f_left,
                      f_right, static_cast<cudaStream_t>(stream));
}

#ifdef SRCNN_PROFILING
// The profiling cuts of K1 (kernels/ablation.py): as srcnn_fused_forward,
// stopped after `stage` (LOAD, CONV1, CONV2 or FULL).
int srcnn_fused_cut_forward(const float* y, float* out, const float* params,
                            int n, int h, int w, int f_top, int f_bottom,
                            int f_left, int f_right, int stage,
                            void* stream) {
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
    case FULL:
      return launch<FULL>(y, out, params, n, h, w, f_top, f_bottom, f_left,
                          f_right, s);
    default:
      return cudaErrorInvalidValue;
  }
}
#endif  // SRCNN_PROFILING

}  // extern "C"
