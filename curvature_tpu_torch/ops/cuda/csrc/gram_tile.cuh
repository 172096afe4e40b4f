// Helpers shared by the Gram kernels of this directory (patch_gram.cu,
// sym_gram.cu): the geometry of the workspace tiles and of the FP32 FMA
// kernel, the element load, and the walk over the lower-triangular output
// tiles.
//
// Every partial kernel gives each block one tile (ti, tj), ti >= tj, of
// the lower triangle of an [F, F] Gram and one contiguous token range (one
// split of the token axis), and writes the partial tile to a workspace of
// TILE x TILE blocks, one set per split; a second kernel sums the splits in
// split order: no atomics, so results repeat bit for bit from launch to
// launch. The tensor-core kernels (wgmma_gram.cuh for bf16,
// tf32x3_gram.cuh for the f32 patch Gram) write their tiles as 64x64
// quarters into the same workspace, for the same reduce.
//
// FP32 FMA (the 64x64 tile of THREADS threads with 4x4 micro-tiles, BK
// tokens a stage) is sym_gram's f32 kernel only: strict f32, the TPU
// kernels' preferred_element_type=f32 contract without TF32.
#pragma once

#include <cuda_runtime.h>

namespace gram {

constexpr int TILE = 64;     // output tile edge, in features
constexpr int BK = 32;       // tokens per shared-memory stage
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(const float* p) { return __ldg(p); }

// Linear lower-triangular tile index t -> (ti, tj), ti >= tj.
__device__ __forceinline__ void tri_tile(int t, int& ti, int& tj) {
  ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  tj = t - ti * (ti + 1) / 2;
}

}  // namespace gram
