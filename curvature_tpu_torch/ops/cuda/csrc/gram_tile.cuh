// Helpers shared by the Gram kernels of this directory (patch_gram.cu,
// sym_gram.cu): the edge of the workspace tiles and the walk over the
// lower-triangular output tiles.
//
// Every tile kernel gives each block one tile (ti, tj), ti >= tj, of the
// lower triangle of an [F, F] Gram and one contiguous token range (one
// split of the token axis). All of them run on the tensor cores
// (wgmma_gram.cuh for bf16, tf32x3_gram.cuh for f32) with tiles of 64 or
// 128 features, and with more than one split they write their tiles as
// TILE x TILE quarters into a workspace, one set per split; a second
// kernel sums the splits in split order: no atomics, so results repeat bit
// for bit from launch to launch.
#pragma once

#include <cuda_runtime.h>

namespace gram {

constexpr int TILE = 64;     // workspace tile edge, in features

// Linear lower-triangular tile index t -> (ti, tj), ti >= tj.
__device__ __forceinline__ void tri_tile(int t, int& ti, int& tj) {
  ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  tj = t - ti * (ti + 1) / 2;
}

}  // namespace gram
