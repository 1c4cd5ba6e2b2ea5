// What the Hopper kernels K1 (fused_srcnn.cu), K2, K3, K3h, K3n and K5
// (fused_srcnn_bf16.cu) and K4 (fused_srcnn_int8.cu) share: the wgmma
// plumbing (descriptors of B operands in shared memory, fences and waits,
// the instruction wrappers with A from registers) and the persistent
// grid's tile walk.
#pragma once

#include <atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "srcnn_common.cuh"

namespace srcnn {

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a K-major B operand without swizzle at `p` (shared memory).
// Its core matrices are 8 rows (N) x 16 bytes (K: 4 tf32, 8 bf16 or 16 s8);
// LBO = 128 B between the two core matrices of a k step along K, SBO =
// `sbo` bytes between groups of 8 columns along N.
__device__ __forceinline__ uint64_t b_desc(const void* p, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// the descriptor of k step s (32 bytes of K: k8 tf32, k16 bf16, k32 s8): 2
// core matrices (256 B) further along K
__device__ __forceinline__ uint64_t at_step(uint64_t desc, int s) {
  return desc + static_cast<uint64_t>(16 * s);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of r across this point
// (the wgmma instructions read and write registers asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int S>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[s][i])::"memory");
}

// The instructions, d[64 x N] += a[64 x k] (registers) * b[k x N] (shared
// memory, descriptor), one k step each.  A's register fragment of warp i
// of the warpgroup covers rows 16i .. 16i + 15 in mma.sync's m16 layout.
#define SRCNN_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define SRCNN_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SRCNN_OUT32(C)                                                     \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]),  \
      C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]),  \
      C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]),          \
      C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]),          \
      C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31])
#define SRCNN_OUT16(C)                                                     \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]),  \
      C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]),  \
      C(d[15])
#define SRCNN_F(x) "+f"(x)
#define SRCNN_R(x) "+r"(x)
#define SRCNN_IN(a, desc) \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)

// tf32 operands (k8), f32 accumulators
__device__ __forceinline__ void wgmma_n64_tf32(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SRCNN_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SRCNN_OUT32(SRCNN_F)
      : SRCNN_IN(a, desc));
}
__device__ __forceinline__ void wgmma_n32_tf32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " SRCNN_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : SRCNN_OUT16(SRCNN_F)
      : SRCNN_IN(a, desc));
}

// bf16 operands (k16), f32 accumulators; B K-major (no transpose)
__device__ __forceinline__ void wgmma_n64_bf16(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SRCNN_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : SRCNN_OUT32(SRCNN_F)
      : SRCNN_IN(a, desc));
}
__device__ __forceinline__ void wgmma_n32_bf16(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SRCNN_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : SRCNN_OUT16(SRCNN_F)
      : SRCNN_IN(a, desc));
}

// s8 operands (k32), s32 accumulators (exact)
__device__ __forceinline__ void wgmma_n64_s8(int (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " SRCNN_D32
      ", {%32, %33, %34, %35}, %36, p;\n}\n"
      : SRCNN_OUT32(SRCNN_R)
      : SRCNN_IN(a, desc));
}
__device__ __forceinline__ void wgmma_n32_s8(int (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " SRCNN_D16
      ", {%16, %17, %18, %19}, %20, p;\n}\n"
      : SRCNN_OUT16(SRCNN_R)
      : SRCNN_IN(a, desc));
}

#undef SRCNN_D32
#undef SRCNN_D16
#undef SRCNN_OUT32
#undef SRCNN_OUT16
#undef SRCNN_F
#undef SRCNN_R
#undef SRCNN_IN

// ---- the persistent grid -----------------------------------------------------

// A block walks the TH x TW output tiles of all n planes with a static
// stride (tile = blockIdx.x + i * gridDim.x); tiles and offsets are 64-bit.
struct Tile {
  int plane, r0, q0;                      // r0, q0: output coordinates
};

template <int TH, int TW>
__device__ __forceinline__ Tile tile_at(long long tile, int tr, int tc) {
  const long long per_plane = static_cast<long long>(tr) * tc;
  const long long rem = tile % per_plane;
  return {static_cast<int>(tile / per_plane), static_cast<int>(rem / tc) * TH,
          static_cast<int>(rem % tc) * TW};
}

// Issue the cp.async copies of a tile's WH x WW input window = padded rows
// r0 .. r0+WH-1, cols q0 .. q0+WW-1 of its plane, into `raw`, as one group
// (4-byte copies: the plane's pitch (w+12)*4 is rarely a multiple of 16
// bytes).  Reads past the plane (ragged tiles) are clamped in; they feed
// only masked outputs.
template <int WH, int WW, int NT>
__device__ __forceinline__ void fetch_window(float* raw, const float* __restrict__ y,
                                             Tile tl, int h, int w, int t) {
  const int ph = h + 2 * HALO, pw = w + 2 * HALO;
  const float* yp = y + static_cast<long long>(tl.plane) * ph * pw;
  for (int i = t; i < WH * WW; i += NT) {
    const int pr = min(tl.r0 + i / WW, ph - 1);
    const int pc = min(tl.q0 + i % WW, pw - 1);
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(raw + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(yp + static_cast<long long>(pr) * pw + pc)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The current device's SM count, read once per device.
inline cudaError_t sm_count(int* sms) {
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && (*sms = cached[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return e;
  if (dev < 64) cached[dev].store(*sms, std::memory_order_relaxed);
  return cudaSuccess;
}

// The persistent grid of a kernel that holds one block per SM: min(tiles,
// SMs) blocks for n planes of [h, w] in TH x TW tiles.
template <int TH, int TW>
inline cudaError_t persistent_grid(int n, int h, int w, int* grid) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long long tiles = static_cast<long long>((h + TH - 1) / TH) *
                          ((w + TW - 1) / TW) * n;
  *grid = static_cast<int>(tiles < sms ? tiles : sms);
  return cudaSuccess;
}

}  // namespace srcnn
