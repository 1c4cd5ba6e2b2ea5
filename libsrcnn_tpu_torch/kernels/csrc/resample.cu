// Band resample for Hopper (sm_90a): one axis of ops/resize's separable
// classical resize, every tap of it in one launch.
//
// Replaces no TPU kernel: the JAX package's resize is plain XLA
// (libsrcnn_tpu/ops/resize.py).  It was added because the H100 trace of the
// 1080p -> 4K clips put the resize at 30-45% of their card time: one
// index_select, one multiply and one add per tap over the whole clip, each
// writing a full-size f32 tensor (PERF.md).
//
// Per output entry o of the resized axis, with the per-tap tables of
// ops/resize (idx, w: [K, out], the all-zero tap columns already dropped,
// the replicate padding already in the table's first and last rows):
//   out[o] = sum over k = 0 .. K-1, in that order, of src[idx[k][o]] * w[k][o]
// The sum starts from the first term (not from 0), each product rounds to
// f32, and each add rounds on its own: __fmul_rn / __fadd_rn, which nvcc
// never contracts into an FMA.  That is the torch ops' arithmetic, so the
// result equals ops/resize's plain version bit for bit.  With no weights
// (w == nullptr, K == 1) it is the clamped identity gather of a same-size
// axis: a copy.
//
// What bounds it: device memory.  It reads each source value and writes
// each output value once from DRAM; the K reads per output hit L1 / L2.
// One 8-frame 1080p -> 4K clip (Y with the 6 px halo, 8 x 2172 x 3852;
// two chroma planes, 8 x 2160 x 3840), vertical pass then horizontal:
// Y 601 MB, each chroma plane 597 MB, 1.79 GB in all, 0.54 ms at
// 3.35 TB/s (0.0081 ms per output MP).  Measured on an H100 SXM at 700 W:
// 0.875 ms a clip (Y 0.334, each chroma plane 0.270), 2.05 TB/s, 61% of
// that bound, against 10.33 ms for the torch ops (PERF.md).
//
// Design:
// * band_resample_rows, the row axis (an output row is a weighted sum of
//   source rows): each thread keeps 4 output rows x 4 columns in
//   registers and reads each source row with coalesced 16-byte loads; the
//   table entries of a row are the same for the whole block (broadcast).
// * band_resample_cols, the column axis (a gather within each row): each
//   thread takes 4 output columns of 4 rows, reads the 4 columns' table
//   entries with one 16-byte load per tap and uses them for the 4 rows;
//   the source gathers of a warp fall on a few neighbouring cache lines
//   and come from L1.  Stores are 16 bytes.  The tap loop is unrolled by
//   two, so that two taps' gathers are in flight at once.
// * Blocks walk the rows in order (blockIdx.x along the columns), so the
//   source rows that neighbouring output rows share are still in L2.
// * Any K (bicubic at 1/4 keeps 17 taps, LANCZOS3 at 1/4 25), any size and
//   batch: the 16-byte paths need a width that is a multiple of 4 and
//   16-byte aligned pointers, else a thread takes one column.  Offsets are
//   64-bit; the row groups are walked with a grid stride past 65535.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 64;  // threads along the columns of a block
constexpr int kThreadsY = 4;   // row groups of a block
constexpr int kRows = 4;       // output rows per thread
constexpr int kMaxGridY = 65535;

// One tap of the sum: the first term starts it; later terms are added with
// their own rounding.
__device__ __forceinline__ float tap(float acc, float v, float wk, int k) {
  const float t = __fmul_rn(v, wk);
  return k == 0 ? t : __fadd_rn(acc, t);
}

template <int VEC>
__device__ __forceinline__ void load_vec(float (&v)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_idx(int (&v)[VEC], const int* p) {
  if constexpr (VEC == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// src [planes, src_h, width] -> dst [planes, out_h, width]; idx, w [taps, out_h].
template <int VEC>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
band_resample_rows(const float* __restrict__ src, float* __restrict__ dst,
                   const int* __restrict__ idx, const float* __restrict__ w,
                   int taps, int planes, int src_h, int out_h, int width) {
  const int col = (blockIdx.x * kThreadsX + threadIdx.x) * VEC;
  if (col >= width) return;
  const long long groups = (out_h + kRows - 1) / kRows;
  const long long total = groups * planes;
  for (long long g = (long long)blockIdx.y * kThreadsY + threadIdx.y; g < total;
       g += (long long)gridDim.y * kThreadsY) {
    const long long plane = g / groups;
    const int o0 = (int)(g - plane * groups) * kRows;
    const int rows = min(kRows, out_h - o0);
    const float* s = src + plane * src_h * width + col;
    float acc[kRows][VEC] = {};
    for (int k = 0; k < taps; ++k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const int t = k * out_h + o0 + r;
          float v[VEC];
          load_vec<VEC>(v, s + (long long)__ldg(idx + t) * width);
          if (w != nullptr) {
            const float wk = __ldg(w + t);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[r][e] = tap(acc[r][e], v[e], wk, k);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[r][e] = v[e];
          }
        }
      }
    }
    float* d = dst + (plane * out_h + o0) * width + col;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) store_vec<VEC>(d + (long long)r * width, acc[r]);
    }
  }
}

// src [rows, src_w] -> dst [rows, out_w]; idx, w [taps, out_w].
template <int VEC>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
band_resample_cols(const float* __restrict__ src, float* __restrict__ dst,
                   const int* __restrict__ idx, const float* __restrict__ w,
                   int taps, long long rows_total, int src_w, int out_w) {
  const int col = (blockIdx.x * kThreadsX + threadIdx.x) * VEC;
  if (col >= out_w) return;
  const long long groups = (rows_total + kRows - 1) / kRows;
  for (long long g = (long long)blockIdx.y * kThreadsY + threadIdx.y; g < groups;
       g += (long long)gridDim.y * kThreadsY) {
    const long long r0 = g * kRows;
    const int rows = (int)min((long long)kRows, rows_total - r0);
    const float* s = src + r0 * src_w;
    float acc[kRows][VEC] = {};
    // two taps' gathers in flight before their sums wait on them: 10%
    // off the column pass on the clip's planes, where 3 and 4 gave less
#pragma unroll 2
    for (int k = 0; k < taps; ++k) {
      int i[VEC];
      load_idx<VEC>(i, idx + (long long)k * out_w + col);
      float wk[VEC] = {};
      if (w != nullptr) load_vec<VEC>(wk, w + (long long)k * out_w + col);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const float* sr = s + (long long)r * src_w;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float v = __ldg(sr + i[e]);
            acc[r][e] = w != nullptr ? tap(acc[r][e], v, wk[e], k) : v;
          }
        }
      }
    }
    float* d = dst + r0 * out_w + col;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) store_vec<VEC>(d + (long long)r * out_w, acc[r]);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

dim3 grid_of(long long cols, long long groups) {
  const long long x = (cols + kThreadsX - 1) / kThreadsX;
  const long long y = (groups + kThreadsY - 1) / kThreadsY;
  return dim3((unsigned)x, (unsigned)(y < kMaxGridY ? y : kMaxGridY));
}

}  // namespace

extern "C" {

// src: [planes, src_h, width] f32, dst: [planes, out_h, width] f32, idx:
// [taps, out_h] int32 in [0, src_h), w: [taps, out_h] f32 or null (a copy,
// taps == 1); all contiguous on the current device.  Launches on `stream`;
// returns the cudaError_t of the launch (0 on success).
int resample_rows(const float* src, float* dst, const int* idx, const float* w,
                  int taps, int planes, int src_h, int out_h, int width,
                  void* stream) {
  if (planes <= 0 || out_h <= 0 || width <= 0) return 0;
  const dim3 block(kThreadsX, kThreadsY);
  const long long groups = (long long)planes * ((out_h + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width % 4 == 0 && aligned16(src) && aligned16(dst)) {
    band_resample_rows<4><<<grid_of(width / 4, groups), block, 0, st>>>(
        src, dst, idx, w, taps, planes, src_h, out_h, width);
  } else {
    band_resample_rows<1><<<grid_of(width, groups), block, 0, st>>>(
        src, dst, idx, w, taps, planes, src_h, out_h, width);
  }
  return (int)cudaGetLastError();
}

// src: [rows, src_w] f32, dst: [rows, out_w] f32, idx: [taps, out_w] int32
// in [0, src_w), w: [taps, out_w] f32 or null (a copy, taps == 1); all
// contiguous on the current device.  Launches on `stream`; returns the
// cudaError_t of the launch (0 on success).
int resample_cols(const float* src, float* dst, const int* idx, const float* w,
                  int taps, long long rows, int src_w, int out_w, void* stream) {
  if (rows <= 0 || out_w <= 0) return 0;
  const dim3 block(kThreadsX, kThreadsY);
  const long long groups = (rows + kRows - 1) / kRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_w % 4 == 0 && aligned16(dst) && aligned16(idx) &&
      (w == nullptr || aligned16(w))) {
    band_resample_cols<4><<<grid_of(out_w / 4, groups), block, 0, st>>>(
        src, dst, idx, w, taps, rows, src_w, out_w);
  } else {
    band_resample_cols<1><<<grid_of(out_w, groups), block, 0, st>>>(
        src, dst, idx, w, taps, rows, src_w, out_w);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
