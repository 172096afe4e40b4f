// Helpers shared by the Gram kernels of this directory (patch_gram.cu,
// sym_gram.cu): the tile geometry, the element load that widens bf16 to
// f32, and the walk over the lower-triangular output tiles.
//
// Both kernels give each block one 64x64 tile (ti, tj), ti >= tj, of the
// lower triangle of an [F, F] Gram and one contiguous token range (one
// split of the token axis), and write the partial tile to a workspace, one
// TILE*TILE block per (split, tile); a second kernel sums the splits in
// split order: no atomics, so results repeat bit for bit from launch to
// launch. Each kernel keeps its own partial-tile body: one body shared
// through a loader template measured slower for the patch gather.
//
// Operands are f32 or bf16. bf16 is converted to f32 on load, so every
// product of two bf16 values is exact in f32 and the sums are f32: the
// TPU kernels' preferred_element_type=f32 contract, without TF32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gram {

constexpr int TILE = 64;     // output tile edge, in features
constexpr int BK = 32;       // tokens per shared-memory stage
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(const float* p) { return __ldg(p); }
// bf16 is the high half of an f32: widen the raw 16 bits (exact), through
// the plain read-only load (the __nv_bfloat16 overload of __ldg is inline
// assembly, which the compiler schedules less freely)
__device__ __forceinline__ float to_f32(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

// Linear lower-triangular tile index t -> (ti, tj), ti >= tj.
__device__ __forceinline__ void tri_tile(int t, int& ti, int& tj) {
  ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  tj = t - ti * (ti + 1) / 2;
}

}  // namespace gram
