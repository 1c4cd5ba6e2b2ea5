// What the fused SRCNN 9-1-5 kernels share: the packed parameter layout
// (kernels/fused_conv.py::pack_params writes it), the halo, and the
// reference's conv2-output border clamp on a tile's c2 ring.
#pragma once

namespace srcnn {

constexpr int HALO = 6;                   // 4 (conv1) + 2 (conv3)
constexpr int C1 = 64, C2 = 32;

// Packed parameters, f32.
constexpr int OFF_W1 = 0;                 // [81][64], tap k = 9*dy + dx
constexpr int OFF_B1 = OFF_W1 + 81 * C1;
constexpr int OFF_W2 = OFF_B1 + C1;       // [64][32]
constexpr int OFF_B2 = OFF_W2 + C1 * C2;
constexpr int OFF_W3 = OFF_B2 + C2;       // [25][32], tap k = 5*dy + dx
constexpr int OFF_B3 = OFF_W3 + 25 * C2;
constexpr int N_PARAMS = OFF_B3 + 1;      // 8,129

// The kernels' phases, for the profiling cuts (kernels/ablation.py): a
// kernel instantiated at STAGE < FULL stops after that phase and writes,
// per output pixel, one value that depends on all of that phase's work at
// the pixel's own c2 ring position (cut_store), so that nvcc keeps the
// whole phase.  Stages are cumulative; FULL is the production kernel.
// A template argument, so an `int`: the values are the tools' stage codes.
enum Stage : int { LOAD = 0, CONV1 = 1, CONV2 = 2, TAPS = 3, FULL = 4 };

// A cut's value at c2 ring position (a, b) of the tile whose ring has rows
// r0 - 2 .. and columns q0 - 2 ..: stored at output pixel (r0 + a - 2,
// q0 + b - 2) when (a, b) is one of the tile's th x tw output pixels and
// that pixel lies in the [h, w] plane; ring positions outside are dropped.
__device__ __forceinline__ void cut_store(float* out, int a, int b, int r0,
                                          int q0, int th, int tw, int h,
                                          int w, float v) {
  const int orow = r0 + a - 2, ocol = q0 + b - 2;
  if (a >= 2 && a < th + 2 && b >= 2 && b < tw + 2 && orow < h && ocol < w)
    out[(long long)orow * w + ocol] = v;
}

// Sum of v over the 4 lanes of an mma fragment's row group (lanes 4g ..
// 4g + 3 hold the columns of rows g and g + 8); every lane gets the sum.
// The whole warp must call it.
template <typename T>
__device__ __forceinline__ T quad_sum(T v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The reference's border semantics (libsrcnn.cpp:463-489): conv3 reads
// conv2's output clamped to the image.  c2s holds ROWS planes over a tile's
// ring, [ROWS][stride c2_stride], ring position (a, b) = global c2
// (r0 - 2 + a, q0 - 2 + b): the 32 c2 channels, or any per-position
// function of them, such as conv3's 25 tap products, of any element type
// (f32 in K1-K3, int32 in K4).  Where an edge's flag
// is set, a ring position outside [0,h) x [0,w) takes the values of the
// clamped position, which lies in the ring and is never itself rewritten;
// where it is 0 the ring keeps the values of the real halo.  Only blocks on
// such an edge do any work.  Ends with __syncthreads() when it ran, so
// every thread of the block must call it.
template <int RH, int RW, int NT, int ROWS = C2, typename T>
__device__ __forceinline__ void ring_clamp(T* c2s, int c2_stride, int r0,
                                           int q0, int h, int w, int f_top,
                                           int f_bottom, int f_left,
                                           int f_right) {
  constexpr int M = RH * RW;
  const int lo_r = f_top ? 0 : -2, hi_r = f_bottom ? h - 1 : h + 1;
  const int lo_c = f_left ? 0 : -2, hi_c = f_right ? w - 1 : w + 1;
  if (r0 - 2 < lo_r || r0 + RH - 3 > hi_r || q0 - 2 < lo_c ||
      q0 + RW - 3 > hi_c) {
    for (int s = threadIdx.x; s < ROWS * M; s += NT) {
      const int c = s / M, a = (s % M) / RW, b = s % RW;
      const int sa = min(max(r0 + a - 2, lo_r), hi_r) - r0 + 2;
      const int sb = min(max(q0 + b - 2, lo_c), hi_c) - q0 + 2;
      if (sa != a || sb != b)
        c2s[c * c2_stride + a * RW + b] = c2s[c * c2_stride + sa * RW + sb];
    }
    __syncthreads();
  }
}

}  // namespace srcnn
