// Color split and merge for Hopper (sm_90a): ops/color's two directions,
// each in one launch.
//
// Replaces no TPU kernel: the JAX package's color op is plain XLA
// (libsrcnn_tpu/ops/color.py).  It was added because the H100 trace of the
// 1080p -> 4K clips put the color ops at a third to a half of their card
// time: one torch kernel for every subtract, multiply, divide, add, clamp,
// floor, cast and stack, each reading or writing a full-size f32 plane
// (48 kernels a clip; PERF.md).
//
// color_split: interleaved u8 RGB(A) [n, D] -> planar f32 [D, n] YCbCr(+A),
//   y  = 0.299 r + 0.587 g + 0.114 b
//   cb = 128 - 0.1687 r - 0.3313 g + 0.5 b
//   cr = 128 + 0.5 r - 0.4187 g - 0.0813 b
// left to right, the alpha plane passed through as float.
// color_merge: planar f32 Y, Cb, Cr(, A) [n] -> interleaved u8 RGB(A)
// [n, D] and the conv map u8 [n], with cb = Cb - 128, cr = Cr - 128,
//   r = y + (45 cr) / 32,  g = y - (11 cb + 23 cr) / 32,  b = y + (113 cb) / 64
// each channel emitted as clamp(max 255), clamp(min 0), floor, cast; the
// conv map is floor(y), cast.
//
// Bit for bit the torch ops of ops/color (their CUDA kernels):
// * every product, sum and difference rounds on its own: __fmul_rn /
//   __fadd_rn / __fsub_rn, which nvcc never contracts into an FMA;
// * a coefficient is the f32 rounding of the Python float torch was given
//   (a double literal cast to float, not a float literal);
// * the divisions by 32 and 64 are products by 2^-5 and 2^-6, as torch's
//   CUDA division by a scalar is a product by its reciprocal: for a power
//   of two both are the same correctly rounded x / 32;
// * the clamps keep a NaN, as torch.clamp does (a comparison with NaN is
//   false), where fminf / fmaxf would give 255 or 0;
// * the cast goes through int64 as torch's float -> uint8 cast does
//   (c10/util/TypeCast.h), so NaN, +-inf and values outside [0, 255] give
//   torch's bytes; the conv map of an unclamped plane too.
//
// What bounds it: device memory.  One 8-frame 1080p -> 4K clip
// (n = 8 x 2160 x 3840 = 66.4 M pixels): the merge reads Y, Cb, Cr as f32
// and writes RGB and the conv map as u8, 16 B a pixel, 1.06 GB, 0.317 ms at
// 3.35 TB/s; the split of the 8 x 1080 x 1920 source reads 3 B and writes
// 12 B a pixel, 249 MB, 0.074 ms.
//
// Design: the op is per pixel, so the planes are indexed flat over n.  Each
// thread takes a run of kPix = 4 consecutive pixels: one 16-byte load or
// store for each f32 plane's run, and the interleaved u8 run (12 B of RGB,
// 16 B of RGBA) and the conv map's run (4 B) in 4-byte words, one 16-byte
// access for RGBA.  A run that is cut by the end of the planes, or any
// pointer that is not 16-byte aligned, takes the pixel-by-pixel path.
// Measured on an H100 SXM at 700 W, a clip's merge takes 0.351 ms (90% of
// its bound) and its split 0.096 ms (78%), against 6.37 and 1.63 ms for the
// torch ops; runs of 8, 16 and 32 pixels (48 B of RGB in three 16-byte
// stores at 16) and blocks of 256 and 512 threads lost in a sweep: 52-88%
// for the merge, 22-54% for the split (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 4;        // consecutive pixels per thread
constexpr int kThreads = 128;  // threads per block

// torch's f32 roundings of the Python scalars of ops/color
constexpr float kYr = static_cast<float>(0.299);
constexpr float kYg = static_cast<float>(0.587);
constexpr float kYb = static_cast<float>(0.114);
constexpr float kCbr = static_cast<float>(0.1687);
constexpr float kCbg = static_cast<float>(0.3313);
constexpr float kCrg = static_cast<float>(0.4187);
constexpr float kCrb = static_cast<float>(0.0813);

// floor and torch's float -> uint8 cast (through int64)
__device__ __forceinline__ uint32_t cast_u8(float v) {
  return static_cast<uint8_t>(static_cast<long long>(floorf(v)));
}

// ops/color.trunc_u8: clamp(max=255), clamp(min=0), floor, cast; a NaN
// passes both clamps, as in torch.clamp
__device__ __forceinline__ uint32_t trunc_u8(float v) {
  v = v > 255.0f ? 255.0f : v;
  v = v < 0.0f ? 0.0f : v;
  return cast_u8(v);
}

__device__ __forceinline__ void split_px(uint32_t r8, uint32_t g8, uint32_t b8,
                                         float& y, float& cb, float& cr) {
  const float r = static_cast<float>(r8), g = static_cast<float>(g8),
              b = static_cast<float>(b8);
  y = __fadd_rn(__fadd_rn(__fmul_rn(kYr, r), __fmul_rn(kYg, g)), __fmul_rn(kYb, b));
  cb = __fadd_rn(__fsub_rn(__fsub_rn(128.0f, __fmul_rn(kCbr, r)), __fmul_rn(kCbg, g)),
                 __fmul_rn(0.5f, b));
  cr = __fsub_rn(__fsub_rn(__fadd_rn(128.0f, __fmul_rn(0.5f, r)), __fmul_rn(kCrg, g)),
                 __fmul_rn(kCrb, b));
}

// one pixel's RGB bytes, each in the low byte of its word
__device__ __forceinline__ void merge_px(float y, float cb_in, float cr_in,
                                         uint32_t& r, uint32_t& g, uint32_t& b) {
  const float cb = __fsub_rn(cb_in, 128.0f);
  const float cr = __fsub_rn(cr_in, 128.0f);
  r = trunc_u8(__fadd_rn(y, __fmul_rn(__fmul_rn(45.0f, cr), 0.03125f)));
  g = trunc_u8(__fsub_rn(
      y, __fmul_rn(__fadd_rn(__fmul_rn(11.0f, cb), __fmul_rn(23.0f, cr)), 0.03125f)));
  b = trunc_u8(__fadd_rn(y, __fmul_rn(__fmul_rn(113.0f, cb), 0.015625f)));
}

template <int N>
__device__ __forceinline__ void load_f32(float (&v)[N], const float* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// 4 W bytes as W little-endian words, 16 bytes at a time where W allows
// (the caller's offset is a multiple of 4 W bytes)
template <int W>
__device__ __forceinline__ void load_words(uint32_t (&w)[W], const uint8_t* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i / 4);
      w[i] = q.x; w[i + 1] = q.y; w[i + 2] = q.z; w[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = __ldg(reinterpret_cast<const uint32_t*>(p) + i);
  }
}

template <int W>
__device__ __forceinline__ void store_words(uint8_t* p, const uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      reinterpret_cast<uint4*>(p)[i / 4] = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) reinterpret_cast<uint32_t*>(p)[i] = w[i];
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* w, int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 0xffu;
}

__device__ __forceinline__ void put_byte(uint32_t* w, int i, uint32_t v) {
  w[i >> 2] |= v << (8 * (i & 3));
}

// src [n, D] u8 -> dst [D, n] f32
template <int D>
__global__ void __launch_bounds__(kThreads)
color_split(const uint8_t* __restrict__ src, float* __restrict__ dst, int n,
            bool vec) {
  const long long p0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (p0 >= n) return;
  float* const y = dst;
  float* const cb = dst + n;
  float* const cr = dst + 2LL * n;
  if (vec && p0 + kPix <= n) {
    uint32_t w[kPix * D / 4];
    load_words(w, src + p0 * D);
    float vy[kPix], vcb[kPix], vcr[kPix], va[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      split_px(byte_of(w, i * D), byte_of(w, i * D + 1), byte_of(w, i * D + 2),
               vy[i], vcb[i], vcr[i]);
      if constexpr (D == 4) va[i] = static_cast<float>(byte_of(w, i * D + 3));
    }
    store_f32(y + p0, vy);
    store_f32(cb + p0, vcb);
    store_f32(cr + p0, vcr);
    if constexpr (D == 4) store_f32(dst + 3LL * n + p0, va);
    return;
  }
  const int end = (int)min((long long)n, p0 + kPix);
  for (int p = (int)p0; p < end; ++p) {
    const uint8_t* s = src + (long long)p * D;
    split_px(s[0], s[1], s[2], y[p], cb[p], cr[p]);
    if constexpr (D == 4) dst[3LL * n + p] = static_cast<float>(s[3]);
  }
}

// y, cb, cr(, a) [n] f32 -> out [n, D] u8, conv [n] u8
template <int D>
__global__ void __launch_bounds__(kThreads)
color_merge(const float* __restrict__ y, const float* __restrict__ cb,
            const float* __restrict__ cr, const float* __restrict__ a,
            uint8_t* __restrict__ out, uint8_t* __restrict__ conv, int n, bool vec) {
  const long long p0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (p0 >= n) return;
  if (vec && p0 + kPix <= n) {
    float vy[kPix], vcb[kPix], vcr[kPix], va[kPix];
    load_f32(vy, y + p0);
    load_f32(vcb, cb + p0);
    load_f32(vcr, cr + p0);
    if constexpr (D == 4) load_f32(va, a + p0);
    uint32_t w[kPix * D / 4] = {};
    uint32_t c[kPix / 4] = {};
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      uint32_t r, g, b;
      merge_px(vy[i], vcb[i], vcr[i], r, g, b);
      put_byte(w, i * D, r);
      put_byte(w, i * D + 1, g);
      put_byte(w, i * D + 2, b);
      if constexpr (D == 4) put_byte(w, i * D + 3, trunc_u8(va[i]));
      put_byte(c, i, cast_u8(vy[i]));
    }
    store_words(out + p0 * D, w);
    store_words(conv + p0, c);
    return;
  }
  const int end = (int)min((long long)n, p0 + kPix);
  for (int p = (int)p0; p < end; ++p) {
    uint32_t r, g, b;
    merge_px(y[p], cb[p], cr[p], r, g, b);
    uint8_t* o = out + (long long)p * D;
    o[0] = r; o[1] = g; o[2] = b;
    if constexpr (D == 4) o[3] = trunc_u8(a[p]);
    conv[p] = cast_u8(y[p]);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

unsigned blocks_of(int n) {
  const long long threads = ((long long)n + kPix - 1) / kPix;
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// src: [n, d] u8, dst: [d, n] f32, d 3 or 4; both contiguous on the current
// device.  Launches on `stream`; returns the cudaError_t of the launch (0
// on success).
int color_split_launch(const uint8_t* src, float* dst, int n, int d, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the f32 planes start at multiples of n floats
  const bool vec = aligned16(src) && aligned16(dst) && n % 4 == 0;
  if (d == 4) {
    color_split<4><<<blocks_of(n), kThreads, 0, st>>>(src, dst, n, vec);
  } else {
    color_split<3><<<blocks_of(n), kThreads, 0, st>>>(src, dst, n, vec);
  }
  return (int)cudaGetLastError();
}

// y, cb, cr: [n] f32, a: [n] f32 when d == 4 (else null); out: [n, d] u8,
// conv: [n] u8; all contiguous on the current device.  Launches on
// `stream`; returns the cudaError_t of the launch (0 on success).
int color_merge_launch(const float* y, const float* cb, const float* cr,
                       const float* a, uint8_t* out, uint8_t* conv, int n, int d,
                       void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(y) && aligned16(cb) && aligned16(cr) &&
                   (d == 3 || aligned16(a)) && aligned16(out) && aligned16(conv);
  if (d == 4) {
    color_merge<4><<<blocks_of(n), kThreads, 0, st>>>(y, cb, cr, a, out, conv, n, vec);
  } else {
    color_merge<3><<<blocks_of(n), kThreads, 0, st>>>(y, cb, cr, a, out, conv, n, vec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
