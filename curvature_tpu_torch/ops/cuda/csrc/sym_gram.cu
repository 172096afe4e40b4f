// Symmetric token Gram X^T X for Hopper (sm_90a): [N, F] f32 or bf16 in,
// [F, F] f32 out, computing only the lower triangle.
//
// Replaces the Pallas kernels of curvature_tpu/ops/pallas/sym_gram.py:
//   sym_gram variant='tri'   (_kernel :53; pallas_call :132)
//   sym_gram variant='rect'  (_kernel_rect :66; pallas_call :109)
// Both variants compute the same function; on the TPU they differ only in
// which grid its Mosaic compiler accepted (scalar-prefetched tile pairs
// against a predicated rectangle). Here there is one kernel.
//
// What bounds it: at the shapes that pass the JAX gate (F > 512), e.g.
// ResNet-50's layer4 3x3 patch matrix at B=16, [784, 4609], the lower
// triangle is N*F*(F+1) ~ 1.7e10 FLOP against 14 MB of input and 85 MB
// of output: bound by arithmetic. Strict FP32 FMA, as patch_gram.cu, and
// for the same reason (the JAX test's 2e-5 of max|G| bar).
//
// What the design does about it:
//  * Only the nt(nt+1)/2 lower-triangular 64x64 tiles are computed, one
//    per block, in patch_gram.cu's layout: 256 threads with 4x4 f32
//    accumulators each, FP32 FMAs out of shared memory, the next 32-token
//    chunk loaded into registers under the current chunk's FMAs (two
//    shared-memory stages). Here the loads are plain rows: 64 consecutive
//    features of a row per 64 threads, coalesced.
//  * The token axis is split across blocks when there are too few tiles
//    to fill the card, with the same deterministic two-pass reduction.
//  * The reduce kernel takes one tile per block: it sums the splits in
//    order, writes the tile, and writes its transpose into the upper
//    triangle from the same shared-memory values, so the result is
//    bitwise symmetric (the JAX version mirrors tril(low, -1).T).
#include "gram_tile.cuh"

namespace {

using gram::BK;
using gram::THREADS;
using gram::TILE;

template <typename T>
__device__ __forceinline__ float load(const T* __restrict__ x, int F, int n,
                                      int f, bool valid) {
  return valid ? gram::to_f32(x + n * F + f) : 0.0f;  // N*F < 2^31
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
sym_partial_kernel(const T* __restrict__ x, float* __restrict__ ws, int N,
                   int F, int num_tiles, int tokens_per_split) {
  const int t = blockIdx.x;
  int ti, tj;
  gram::tri_tile(t, ti, tj);
  const int split = blockIdx.y;
  const int n_begin = split * tokens_per_split;
  const int n_end = min(n_begin + tokens_per_split, N);

  // two stages: the next chunk is stored while this one is multiplied
  __shared__ __align__(16) float As[2][BK][TILE];
  __shared__ __align__(16) float Bs[2][BK][TILE];

  const int tid = threadIdx.x;
  const int r = tid % TILE;        // feature column this thread loads
  const int row0 = tid / TILE;     // token rows row0 + 4m, m < BK/4
  constexpr int M = BK / 4;
  const int fa = ti * TILE + r, fb = tj * TILE + r;
  const bool va = fa < F, vb = fb < F;

  float ra[M], rb[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int n = n_begin + row0 + 4 * m;
    ra[m] = load(x, F, n, fa, n < n_end && va);
    rb[m] = load(x, F, n, fb, n < n_end && vb);
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    As[0][row0 + 4 * m][r] = ra[m];
    Bs[0][row0 + 4 * m][r] = rb[m];
  }
  __syncthreads();

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  int buf = 0;
  for (int n0 = n_begin; n0 < n_end; n0 += BK) {
    const bool more = n0 + BK < n_end;
    if (more) {                    // start the next chunk's loads now
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int n = n0 + BK + row0 + 4 * m;
        ra[m] = load(x, F, n, fa, n < n_end && va);
        rb[m] = load(x, F, n, fb, n < n_end && vb);
      }
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (more) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        As[buf ^ 1][row0 + 4 * m][r] = ra[m];
        Bs[buf ^ 1][row0 + 4 * m][r] = rb[m];
      }
    }
    __syncthreads();
    buf ^= 1;
  }

  float* out = ws + (static_cast<size_t>(split) * num_tiles + t) * TILE * TILE;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&out[(ty * 4 + i) * TILE + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// One lower tile per block: the splits summed in order, then the tile at
// (ti, tj) and its transpose at (tj, ti), both from the same values.
__global__ void __launch_bounds__(THREADS)
sym_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                  int F, int num_tiles, int splits) {
  __shared__ float tile[TILE][TILE + 1];
  const int t = blockIdx.x;
  int ti, tj;
  gram::tri_tile(t, ti, tj);
  const size_t per_split = static_cast<size_t>(num_tiles) * TILE * TILE;
  const float* src = ws + static_cast<size_t>(t) * TILE * TILE;
  for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += src[s * per_split + e];
    tile[e / TILE][e % TILE] = v;
  }
  __syncthreads();
  const bool diag = ti == tj;
  for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE, c = e % TILE;
    // lower block; a diagonal tile's upper half mirrors its lower half
    int i = ti * TILE + r, j = tj * TILE + c;
    if (i < F && j < F)
      out[static_cast<size_t>(i) * F + j] =
          diag && c > r ? tile[c][r] : tile[r][c];
    if (diag) continue;
    i = tj * TILE + r;                    // the transposed upper block
    j = ti * TILE + c;
    if (i < F && j < F) out[static_cast<size_t>(i) * F + j] = tile[c][r];
  }
}

template <typename T>
int launch(const T* x, float* out, float* ws, int N, int F, int splits,
           int tokens_per_split, void* stream) {
  const int nt = (F + TILE - 1) / TILE;
  const int num_tiles = nt * (nt + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sym_partial_kernel<T><<<dim3(num_tiles, splits), THREADS, 0, s>>>(
      x, ws, N, F, num_tiles, tokens_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sym_reduce_kernel<<<num_tiles, THREADS, 0, s>>>(ws, out, F, num_tiles,
                                                  splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Entries of sym_gram (curvature_tpu_torch/ops/cuda/sym_gram.py).
int sym_gram_f32(const float* x, float* out, float* ws, int N, int F,
                 int splits, int tokens_per_split, void* stream) {
  return launch(x, out, ws, N, F, splits, tokens_per_split, stream);
}

int sym_gram_bf16(const __nv_bfloat16* x, float* out, float* ws, int N, int F,
                  int splits, int tokens_per_split, void* stream) {
  return launch(x, out, ws, N, F, splits, tokens_per_split, stream);
}

// Resident partial-kernel blocks per SM, for the wrapper's split count.
int sym_gram_blocks_per_sm(int bf16, int* blocks) {
  return static_cast<int>(
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 blocks, sym_partial_kernel<__nv_bfloat16>, THREADS, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 blocks, sym_partial_kernel<float>, THREADS, 0));
}

const char* sym_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
