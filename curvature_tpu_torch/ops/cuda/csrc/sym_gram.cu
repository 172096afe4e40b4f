// Symmetric token Gram X^T X for Hopper (sm_90a): [N, F] f32 or bf16 in,
// [F, F] f32 out, computing only the lower triangle.
//
// Replaces the Pallas kernels of curvature_tpu/ops/pallas/sym_gram.py:
//   sym_gram variant='tri'   (_kernel :53; pallas_call :132)
//   sym_gram variant='rect'  (_kernel_rect :66; pallas_call :109)
// Both variants compute the same function; on the TPU they differ only in
// which grid its Mosaic compiler accepted (scalar-prefetched tile pairs
// against a predicated rectangle). Here there is one kernel per element
// type: f32 sym_partial_kernel (strict FP32 FMA), bf16 sym_wgmma_kernel
// (bf16 x bf16 -> f32 on the tensor cores, wgmma_gram.cuh).
//
// What bounds it: at the shapes that pass the JAX gate (F > 512), e.g.
// ResNet-50's layer4 3x3 patch matrix at B=16, [784, 4609], the lower
// triangle is N*F*(F+1) ~ 1.7e10 FLOP against 7-14 MB of input and 85 MB
// of output. In f32 that is bound by arithmetic (strict FP32 FMA, as
// patch_gram.cu, for the JAX test's 2e-5 of max|G| bar); in bf16 on the
// tensor cores it is bound by the 85 MB written.
//
// What the design does about it:
//  * Only the nt(nt+1)/2 lower-triangular 64x64 tiles are computed, one
//    per block, in patch_gram.cu's layout. f32: 256 threads with 4x4 f32
//    accumulators each, FP32 FMAs out of shared memory, the next 32-token
//    chunk loaded into registers under the current chunk's FMAs (two
//    shared-memory stages); the loads are plain rows, 64 consecutive
//    features of a row per 64 threads, coalesced. bf16: one warpgroup,
//    wgmma on swizzled [64 tokens x 64 features] tiles filled by 16-byte
//    cp.async copies, which need rows of a multiple of 8 features: the
//    wrapper pads F up to one (the callers' ones column makes F odd).
//  * The token axis is split across blocks when there are too few tiles
//    to fill the card, with a deterministic two-pass reduction: the reduce
//    kernel takes one tile per block, sums the splits in order, and writes
//    the tile and its transpose. With one split (2,701 tiles at F = 4609
//    fill the card) the bf16 kernel does that itself, straight from its
//    accumulators: no workspace, no second launch.
//  * Every tile and its transpose are written from the same shared-memory
//    values, through a padded [64][65] tile so both writes are coalesced
//    rows, and a diagonal tile's upper half mirrors its lower half: the
//    result is bitwise symmetric (the JAX version mirrors tril(low, -1).T).
#include "gram_tile.cuh"
#include "wgmma_gram.cuh"

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

// Writes the lower tile (ti, tj) of edge T of `tile` ([T][T+1], row-major
// values of out[ti*T + r, tj*T + c]) and its transpose at (tj, ti); a
// diagonal tile's upper half mirrors its lower half.
template <int T>
__device__ __forceinline__ void write_tile_pair(const float (*tile)[T + 1],
                                                float* __restrict__ out,
                                                int F, int ti, int tj) {
  const bool diag = ti == tj;
  for (int e = threadIdx.x; e < T * T; e += blockDim.x) {
    const int r = e / T, c = e % T;
    int i = ti * T + r, j = tj * T + c;
    if (i < F && j < F)
      out[static_cast<size_t>(i) * F + j] =
          diag && c > r ? tile[c][r] : tile[r][c];
    if (diag) continue;
    i = tj * T + r;                       // the transposed upper block
    j = ti * T + c;
    if (i < F && j < F) out[static_cast<size_t>(i) * F + j] = tile[c][r];
  }
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
  write_tile_pair<TILE>(tile, out, F, ti, tj);
}

// Tile edge of the bf16 kernel: 64 * WGS features, WGS warpgroups a block.
// 64 here: at [784, 4609] a 128-feature tile (703 blocks of 13 chunks)
// measured 0.23 ms against 0.14 ms for 64 (2,701 blocks; PERF.md).
constexpr int WGS = 1;
using Wg = wg::Shape<WGS>;

// The bf16 kernel's gather of plain rows (row stride ld elements, a
// multiple of 8; which 16-byte chunk of which token rows a thread copies:
// wg::GatherSlot), for tile ti (A) and, off the diagonal, tile tj (B): one
// cp.async per chunk, features >= F and tokens past the split zero-filled.
struct RowGather {
  static constexpr int M = wg::BK / 16;
  const __nv_bfloat16* __restrict__ x;
  int F, ld, n_next, n_end, fa, fb;
  wg::GatherSlot at;

  __device__ RowGather(const __nv_bfloat16* x_, int F_, int ld_, int ti,
                       int tj, int n_begin, int n_end_)
      : x(x_), F(F_), ld(ld_), n_next(n_begin), n_end(n_end_) {
    fa = ti * Wg::TILE + at.feature;
    fb = tj * Wg::TILE + at.feature;
  }

  __device__ __forceinline__ void copy(uint32_t d, int n, int f0) const {
    const bool ok = n < n_end && f0 < F;
    wg::cp_async16(d, ok ? x + n * ld + f0 : x, ok);
  }

  __device__ __forceinline__ void load(uint32_t slot_a, uint32_t slot_b) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int n = n_next + at.r0 + 16 * m;
      const uint32_t d = at.dst + m * 16 * wg::ROW_BYTES;
      copy(slot_a + d, n, fa);
      if (slot_b != slot_a) copy(slot_b + d, n, fb);
    }
    n_next += wg::BK;
  }
};

// bf16 lower tile on the tensor cores: grid (lower tiles of edge Wg::TILE,
// splits), WGS warpgroups a block, Wg::SMEM bytes of dynamic shared
// memory. With more than one split it writes its partial tile to the
// 64x64-tile workspace (num_tiles 64-tiles a split) for sym_reduce_kernel;
// with one it writes the tile and its transpose to out.
__global__ void __launch_bounds__(Wg::THREADS)
sym_wgmma_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ ws,
                 float* __restrict__ out, int N, int F, int ld, int num_tiles,
                 int tokens_per_split) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int ti, tj;
  gram::tri_tile(blockIdx.x, ti, tj);
  const int split = blockIdx.y;
  const int n_begin = split * tokens_per_split;
  const int n_end = min(n_begin + tokens_per_split, N);
  const int nchunks =
      n_end > n_begin ? (n_end - n_begin + wg::BK - 1) / wg::BK : 0;

  RowGather gather(x, F, ld, ti, tj, n_begin, n_end);
  float acc[Wg::ACC];
  wg::gram_tile<WGS, false>(gather, wg::ring_base(smem), nchunks, ti == tj,
                            acc, nullptr);
  if (gridDim.y > 1) {
    wg::store_subtiles<WGS>(
        ws + static_cast<size_t>(split) * num_tiles * TILE * TILE, ti, tj,
        (F + TILE - 1) / TILE, acc);
    return;
  }
  // one split: stage the tile in the (now idle) ring, then write it and
  // its transpose as coalesced rows
  float(*tile)[Wg::TILE + 1] = reinterpret_cast<float(*)[Wg::TILE + 1]>(smem);
  __syncthreads();
  const int r0 = 64 * (threadIdx.x / 128);       // this warpgroup's rows
#pragma unroll
  for (int i = 0; i < Wg::ACC; ++i)
    tile[r0 + wg::acc_row(i)][wg::acc_col(i)] = acc[i];
  __syncthreads();
  write_tile_pair<Wg::TILE>(tile, out, F, ti, tj);
}

// The bf16 kernel takes more than 48 KB of dynamic shared memory: the
// attribute is set once, before its first launch or query.
cudaError_t allow_wgmma_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      sym_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Wg::SMEM);
  return err;
}

int launch(const float* x, float* out, float* ws, int N, int F, int splits,
           int tokens_per_split, void* stream) {
  const int nt = (F + TILE - 1) / TILE;
  const int num_tiles = nt * (nt + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sym_partial_kernel<float><<<dim3(num_tiles, splits), THREADS, 0, s>>>(
      x, ws, N, F, num_tiles, tokens_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sym_reduce_kernel<<<num_tiles, THREADS, 0, s>>>(ws, out, F, num_tiles,
                                                  splits);
  return static_cast<int>(cudaGetLastError());
}

int launch(const __nv_bfloat16* x, float* out, float* ws, int N, int F,
           int ld, int splits, int tokens_per_split, void* stream) {
  if (ld < F || ld % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_wgmma_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (F + TILE - 1) / TILE;
  const int num_tiles = nt * (nt + 1) / 2;
  const int bt = (F + Wg::TILE - 1) / Wg::TILE;   // block tiles per edge
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sym_wgmma_kernel<<<dim3(bt * (bt + 1) / 2, splits), Wg::THREADS, Wg::SMEM,
                     s>>>(x, ws, out, N, F, ld, num_tiles, tokens_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  sym_reduce_kernel<<<num_tiles, THREADS, 0, s>>>(ws, out, F, num_tiles,
                                                  splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Entries of sym_gram (curvature_tpu_torch/ops/cuda/sym_gram.py). bf16
// rows have a stride of ld >= F elements, a multiple of 8, and x is 16-byte
// aligned (the wrapper pads); with splits == 1 bf16 needs no workspace.
int sym_gram_f32(const float* x, float* out, float* ws, int N, int F,
                 int splits, int tokens_per_split, void* stream) {
  return launch(x, out, ws, N, F, splits, tokens_per_split, stream);
}

int sym_gram_bf16(const __nv_bfloat16* x, float* out, float* ws, int N, int F,
                  int ld, int splits, int tokens_per_split, void* stream) {
  return launch(x, out, ws, N, F, ld, splits, tokens_per_split, stream);
}

// Resident partial-kernel blocks per SM, for the wrapper's split count.
int sym_gram_blocks_per_sm(int bf16, int* blocks) {
  if (!bf16)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, sym_partial_kernel<float>, THREADS, 0));
  cudaError_t err = allow_wgmma_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sym_wgmma_kernel, Wg::THREADS, Wg::SMEM));
}

const char* sym_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
