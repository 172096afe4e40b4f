// Symmetric token Gram X^T X for Hopper (sm_90a): [N, F] f32 or bf16 in,
// [F, F] f32 out, computing only the lower triangle. In f32 one launch
// takes a batch of row segments of one row matrix (a depth-stacked [L, N,
// F] factor input, or an MoE layer's rows sorted by expert) and writes one
// [F, F] Gram a segment.
//
// Replaces the Pallas kernels of curvature_tpu/ops/pallas/sym_gram.py:
//   sym_gram variant='tri'   (_kernel :53; pallas_call :132)
//   sym_gram variant='rect'  (_kernel_rect :66; pallas_call :109)
// Both variants compute the same function; on the TPU they differ only in
// which grid its Mosaic compiler accepted (scalar-prefetched tile pairs
// against a predicated rectangle). Here both element types run on the
// tensor cores: f32 as 3xTF32 (sym_tf32x3_wgmma_kernel, tf32x3_gram.cuh:
// each value split into TF32 hi and lo halves, lo*hi + hi*lo + hi*hi
// summed in f32), bf16 as bf16 x bf16 -> f32 (sym_wgmma_kernel,
// wgmma_gram.cuh).
//
// What bounds it: at the shapes that pass the JAX gate (F > 512), e.g.
// ResNet-50's layer4 3x3 patch matrix at B=16, [784, 4609], the lower
// triangle is N*F*(F+1) ~ 1.7e10 FLOP against 7-14 MB of input and 85 MB
// of output: in f32, 3x that FLOP at the dense TF32 rate bounds it; in
// bf16 the 85 MB written does. Every tile re-reads its operands (from L2:
// the input fits in it), so what a tile does per operand value is what
// is left once the tensor cores make the arithmetic cheap.
//
// What the design does about it:
//  * f32: tf32 wgmma takes only K-major operands (the token axis
//    contiguous), and every value must be split. Both are done once, by
//    tf32_presplit_kernel, which writes the hi and lo halves of x as
//    ready-made swizzled [64 features x 32 tokens] slabs (tf32x3_gram.cuh,
//    "pre-split operands"), zero past N and F (14 us at [784, 4609]): the
//    tile loop then fills its ring with one bulk copy (cp.async.bulk on an
//    mbarrier) per operand half, no per-value work, no bounds checks, and
//    odd F needs no scalar path. 128x128 tiles of two warpgroups
//    (wgmma.m64n128k8; half the bytes per FLOP of 64x64), a 3-stage ring,
//    the accumulator flushed into an f32 total every tf::FLUSH chunks.
//    What is left is the tiles' schedule: 703 blocks at one an SM are 5.3
//    waves, and a block's epilogue (its tile and the transpose, 128 KB)
//    overlaps no other block's products (PERF.md).
//  * bf16: one warpgroup, wgmma on swizzled [64 tokens x 64 features]
//    tiles filled by 16-byte cp.async copies, which need rows of a
//    multiple of 8 features: the wrapper pads F up to one (the callers'
//    ones column makes F odd).
//  * Only the lower-triangular tiles are computed, one per block. The
//    token axis is split across blocks when there are too few tiles to fill
//    the card, or to bound a block's chain (MAX_CHAIN_TOKENS; a quarter of
//    it in bf16, whose accumulator is not flushed), with a
//    deterministic two-pass reduction: partial tiles go to a workspace of
//    64x64 tiles and the reduce kernel takes one tile per block, sums the
//    splits in order, and writes the tile and its transpose. With one split
//    the tile kernel does that itself, straight from its accumulators: no
//    workspace, no second launch.
//  * f32 batches: the segments' table (Segments: each segment's first
//    element, its rows, the row stride) is a kernel parameter, so a batch
//    costs no host-to-device copy. The pre-pass gives each segment whole
//    chunks, its last one zero-padded, so no chunk straddles two segments;
//    the tile kernel's grid runs over (lower tile, split, segment), tiles
//    fastest, so the blocks resident at once share one segment's slabs in
//    L2. A segment of no rows has no chunks and gets an exact-zero Gram.
//    The pre-pass can also append a ones column (a bias's) to every row.
//  * Every tile and its transpose are written from the same shared-memory
//    values, through a padded [T][T+1] tile so both writes are coalesced
//    rows, and a diagonal tile's upper half mirrors its lower half: the
//    result is bitwise symmetric (the JAX version mirrors tril(low, -1).T).
#include "gram_tile.cuh"
#include "tf32x3_gram.cuh"
#include "wgmma_gram.cuh"

namespace {

using gram::TILE;

constexpr int REDUCE_THREADS = 256;

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

// One lower tile of one Gram per block, grid (tiles, batch): the splits
// summed in order, then the tile at (ti, tj) and its transpose at (tj,
// ti), both from the same values. The workspace is [split][batch][tile].
__global__ void __launch_bounds__(REDUCE_THREADS)
sym_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                  int F, int num_tiles, int splits) {
  __shared__ float tile[TILE][TILE + 1];
  const int t = blockIdx.x, b = blockIdx.y;
  int ti, tj;
  gram::tri_tile(t, ti, tj);
  const size_t per_split =
      static_cast<size_t>(gridDim.y) * num_tiles * TILE * TILE;
  const float* src =
      ws + (static_cast<size_t>(b) * num_tiles + t) * TILE * TILE;
  for (int e = threadIdx.x; e < TILE * TILE; e += REDUCE_THREADS) {
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += src[s * per_split + e];
    tile[e / TILE][e % TILE] = v;
  }
  __syncthreads();
  write_tile_pair<TILE>(tile, out + static_cast<size_t>(b) * F * F, F, ti,
                        tj);
}

// The end of a tensor-core tile kernel of WGS warpgroups, `acc` its
// values of block tile (ti, tj) of the Gram at out: with more than one
// split (gridDim.y), the partial tile into its split's 64x64-tile
// workspace at ws for sym_reduce_kernel; with one, staged in the (now
// idle) ring at smem, the tile and its transpose into out as coalesced
// rows.
template <int WGS>
__device__ __forceinline__ void finish_tile(const float (&acc)[32 * WGS],
                                            unsigned char* smem,
                                            float* __restrict__ ws,
                                            float* __restrict__ out, int F,
                                            int ti, int tj) {
  constexpr int T = 64 * WGS;
  if (gridDim.y > 1) {
    wg::store_subtiles<WGS>(ws, ti, tj, (F + TILE - 1) / TILE, acc);
    return;
  }
  float(*tile)[T + 1] = reinterpret_cast<float(*)[T + 1]>(smem);
  __syncthreads();
  const int r0 = 64 * (threadIdx.x / 128);       // this warpgroup's rows
#pragma unroll
  for (int i = 0; i < 32 * WGS; ++i)
    tile[r0 + wg::acc_row(i)][wg::acc_col(i)] = acc[i];
  __syncthreads();
  write_tile_pair<T>(tile, out, F, ti, tj);
}

// ---- f32: pre-split operands, 3xTF32 ---------------------------------------

// Tile edge of the f32 kernel: 64 * TF_WGS features, TF_WGS warpgroups a
// block, and stages of its ring (3 x 64 KB: one block an SM). 128 here: at
// [784, 4609] it measured 0.219 ms against 0.271 for 64 (2,701 blocks, 2
// an SM; PERF.md).
constexpr int TF_WGS = 2;
constexpr int TF_STAGES = 3;
using Tf = tf::Ring<TF_WGS, TF_STAGES>;

// Feature blocks of 64 covering F in whole f32 tiles: the pre-split
// buffers hold every feature block of every block tile, zero past F.
__host__ __device__ constexpr int presplit_fblocks(int F) {
  return (F + Tf::TILE - 1) / Tf::TILE * TF_WGS;
}

// The most segments one f32 launch takes: their table is a kernel
// parameter (2 KB here); the wrapper launches a larger batch in slices.
constexpr int MAX_SEGMENTS = 128;

// Segment b of a batch: its row i, feature f at x[base[b] + i * ld + f]
// for i < len[b]; its rows are pre-split chunks chunk0[b] ..
// chunk0[b + 1] - 1, each of tf::BK rows, the last zero-padded.
struct Segments {
  long long base[MAX_SEGMENTS];
  int len[MAX_SEGMENTS];
  int chunk0[MAX_SEGMENTS + 1];
  int count;
};

// What the tile kernel reads of Segments.
struct ChunkStarts {
  int chunk0[MAX_SEGMENTS + 1];
};

// The segments of segs -> hi and lo, each
// [chunk0[count] chunks][presplit_fblocks(F) blocks] slabs of [64 features
// x 32 rows] (tf::SLAB bytes, swizzled as tf::desc reads them), zero past
// a segment's rows and past F; hi = cvt.rna.tf32(x) and lo =
// cvt.rna.tf32(x - hi), as tf::store_split. With `ones`, feature F - 1 of
// every row is 1 (x holds F - 1 features). Grid (chunks, fblocks), 256
// threads: each block finds its chunk's segment, reads its [32 rows x 64
// features] of x coalesced into a padded shared tile and writes its two
// slabs as coalesced 16-byte chunks.
__global__ void __launch_bounds__(256)
tf32_presplit_kernel(const float* __restrict__ x, uint4* __restrict__ hi,
                     uint4* __restrict__ lo,
                     const __grid_constant__ Segments segs, long long ld,
                     int F, int ones) {
  __shared__ float tile[tf::BK][64 + 1];         // [row][feature]
  const int c = blockIdx.x, fb = blockIdx.y;
  int b = 0;                                     // the last b: chunk0[b] <= c
  for (int step = MAX_SEGMENTS / 2; step > 0; step /= 2)
    if (b + step < segs.count && segs.chunk0[b + step] <= c) b += step;
  const int r0 = (c - segs.chunk0[b]) * tf::BK, len = segs.len[b];
  const float* src = x + segs.base[b];
  const int fx = F - ones;                       // features read from x
  const int col = threadIdx.x % 64, f = fb * 64 + col;
  for (int r = threadIdx.x / 64; r < tf::BK; r += 4) {
    const int n = r0 + r;
    float v = 0.0f;
    if (n < len) {
      if (f < fx)
        v = __ldg(src + n * ld + f);
      else if (f < F)
        v = 1.0f;                                // the ones column
    }
    tile[r][col] = v;
  }
  __syncthreads();
  const size_t slab = (static_cast<size_t>(c) * gridDim.y + fb) *
                      (tf::SLAB / sizeof(uint4));
  for (int q = threadIdx.x; q < tf::SLAB / 16; q += 256) {
    const int row = q / 8, j = (q % 8) ^ (row & 7);   // feature, token quad
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = tile[4 * j + e][row];
      h[e] = tf::tf32_rna(v);
      l[e] = tf::tf32_rna(v - __uint_as_float(h[e]));   // exact difference
    }
    hi[slab + q] = make_uint4(h[0], h[1], h[2], h[3]);
    lo[slab + q] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// f32 lower tiles on the tensor cores, 3xTF32 from the pre-split hi and
// lo slabs: grid (lower tiles of edge Tf::TILE, splits, segments), TF_WGS
// warpgroups a block, Tf::SMEM bytes of dynamic shared memory; split y of
// segment b sums its chunks [y * chunks_per_split, ...) into Gram b of
// out ([segments][F][F]), through the workspace ([split][segment][64-tile
// num_tiles]) where there is more than one split.
__global__ void __launch_bounds__(Tf::THREADS)
sym_tf32x3_wgmma_kernel(const float* __restrict__ hi,
                        const float* __restrict__ lo, float* __restrict__ ws,
                        float* __restrict__ out, int F,
                        const __grid_constant__ ChunkStarts segs,
                        int chunks_per_split, int num_tiles) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int ti, tj;
  gram::tri_tile(blockIdx.x, ti, tj);
  const int b = blockIdx.z;
  const int c0 = segs.chunk0[b] + blockIdx.y * chunks_per_split;
  const int nchunks =
      max(0, min(chunks_per_split, segs.chunk0[b + 1] - c0));
  const size_t chunk = static_cast<size_t>(presplit_fblocks(F)) * tf::SLAB;
  const tf::Presplit p{reinterpret_cast<const char*>(hi),
                       reinterpret_cast<const char*>(lo),
                       c0 * chunk + static_cast<size_t>(ti) * Tf::HALF,
                       c0 * chunk + static_cast<size_t>(tj) * Tf::HALF, chunk};
  float acc[Tf::ACC];
  tf::presplit_tile<TF_WGS, TF_STAGES>(p, wg::ring_base(smem), nchunks,
                                        ti == tj, acc);
  finish_tile<TF_WGS>(
      acc, smem,
      ws + (static_cast<size_t>(blockIdx.y) * gridDim.z + b) * num_tiles *
               TILE * TILE,
      out + static_cast<size_t>(b) * F * F, F, ti, tj);
}

// ---- bf16 -------------------------------------------------------------------

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
// memory.
__global__ void __launch_bounds__(Wg::THREADS)
sym_wgmma_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ ws,
                 float* __restrict__ out, int N, int F, int ld, int num_tiles,
                 int tokens_per_split) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int ti, tj;
  gram::tri_tile(blockIdx.x, ti, tj);
  const int n_begin = blockIdx.y * tokens_per_split;
  const int n_end = min(n_begin + tokens_per_split, N);
  const int nchunks =
      n_end > n_begin ? (n_end - n_begin + wg::BK - 1) / wg::BK : 0;

  RowGather gather(x, F, ld, ti, tj, n_begin, n_end);
  float acc[Wg::ACC];
  wg::gram_tile<WGS, false>(gather, wg::ring_base(smem), nchunks, ti == tj,
                            acc, nullptr);
  finish_tile<WGS>(
      acc, smem,
      ws + static_cast<size_t>(blockIdx.y) * num_tiles * TILE * TILE, out, F,
      ti, tj);
}

// ---- launch -----------------------------------------------------------------

// Both tile kernels take more than 48 KB of dynamic shared memory: the
// attribute is set once per kernel, before its first launch or query.
cudaError_t allow_tf32x3_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      sym_tf32x3_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tf::SMEM);
  return err;
}

cudaError_t allow_wgmma_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      sym_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Wg::SMEM);
  return err;
}

int num_lower_tiles(int F, int edge) {
  const int nt = (F + edge - 1) / edge;
  return nt * (nt + 1) / 2;
}

cudaError_t reduce(const float* ws, float* out, int F, int splits,
                   int batch, cudaStream_t s) {
  const int num_tiles = num_lower_tiles(F, TILE);
  sym_reduce_kernel<<<dim3(num_tiles, batch), REDUCE_THREADS, 0, s>>>(
      ws, out, F, num_tiles, splits);
  return cudaGetLastError();
}

// chunk0 of `count` segments of len rows each: prefix sums of whole
// chunks; false where a count or length is out of range.
bool chunk_starts(const int* len, int count, int* chunk0) {
  if (count < 1 || count > MAX_SEGMENTS) return false;
  long long c = 0;
  chunk0[0] = 0;
  for (int b = 0; b < count; ++b) {
    if (len[b] < 0) return false;
    c += (len[b] + tf::BK - 1) / tf::BK;
    if (c >= (1ll << 31)) return false;
    chunk0[b + 1] = static_cast<int>(c);
  }
  return true;
}

int presplit(const float* x, float* hi, float* lo, const long long* base,
             const int* len, int count, long long ld, int F, int ones,
             void* stream) {
  Segments segs;
  if (!chunk_starts(len, count, segs.chunk0) || F < 1 || ones < 0 ||
      ones > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int b = 0; b < count; ++b) {
    segs.base[b] = base[b];
    segs.len[b] = len[b];
  }
  segs.count = count;
  if (segs.chunk0[count] == 0) return 0;         // no rows: nothing to split
  const dim3 grid(segs.chunk0[count], presplit_fblocks(F));
  tf32_presplit_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<uint4*>(hi), reinterpret_cast<uint4*>(lo), segs,
      ld, F, ones);
  return static_cast<int>(cudaGetLastError());
}

int launch(const float* hi, const float* lo, float* out, float* ws,
           const int* len, int count, int F, int splits,
           int chunks_per_split, void* stream) {
  ChunkStarts segs;
  if (!chunk_starts(len, count, segs.chunk0) || splits < 1 ||
      chunks_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_tf32x3_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sym_tf32x3_wgmma_kernel<<<dim3(num_lower_tiles(F, Tf::TILE), splits,
                                 count),
                            Tf::THREADS, Tf::SMEM, s>>>(
      hi, lo, ws, out, F, segs, chunks_per_split, num_lower_tiles(F, TILE));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(reduce(ws, out, F, splits, count, s));
}

int launch(const __nv_bfloat16* x, float* out, float* ws, int N, int F,
           int ld, int splits, int tokens_per_split, void* stream) {
  if (ld < F || ld % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_wgmma_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sym_wgmma_kernel<<<dim3(num_lower_tiles(F, Wg::TILE), splits), Wg::THREADS,
                     Wg::SMEM, s>>>(x, ws, out, N, F, ld,
                                    num_lower_tiles(F, TILE),
                                    tokens_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(reduce(ws, out, F, splits, 1, s));
}

}  // namespace

extern "C" {

// Entries of sym_gram, sym_gram_batched and tf32_presplit
// (curvature_tpu_torch/ops/cuda/sym_gram.py). f32: tf32_presplit_f32
// writes hi and lo (each [chunks][2 * ceil(F/128)][64][32] f32, 16-byte
// aligned; chunks the sum of ceil(len[b]/32)) from `count` <= 128 row
// segments of x (segment b's row i at x + base[b] + i * ld; with ones,
// F - 1 features read and a ones column appended), then sym_gram_f32
// reads them for the same lengths and writes [count][F][F], its splits
// chunks_per_split chunks of 32 rows each. bf16 rows have a stride of
// ld >= F elements, a multiple of 8, and x is 16-byte aligned (the wrapper
// pads). With splits == 1 neither needs a workspace; with more, f32's is
// [splits][count][64-tiles of F][64][64].
int tf32_presplit_f32(const float* x, float* hi, float* lo,
                      const long long* base, const int* len, int count,
                      long long ld, int F, int ones, void* stream) {
  return presplit(x, hi, lo, base, len, count, ld, F, ones, stream);
}

int sym_gram_f32(const float* hi, const float* lo, float* out, float* ws,
                 const int* len, int count, int F, int splits,
                 int chunks_per_split, void* stream) {
  return launch(hi, lo, out, ws, len, count, F, splits, chunks_per_split,
                stream);
}

int sym_gram_bf16(const __nv_bfloat16* x, float* out, float* ws, int N, int F,
                  int ld, int splits, int tokens_per_split, void* stream) {
  return launch(x, out, ws, N, F, ld, splits, tokens_per_split, stream);
}

// Resident tile-kernel blocks per SM, for the wrapper's split count.
int sym_gram_blocks_per_sm(int bf16, int* blocks) {
  cudaError_t err = bf16 ? allow_wgmma_smem() : allow_tf32x3_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 blocks, sym_wgmma_kernel, Wg::THREADS, Wg::SMEM)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 blocks, sym_tf32x3_wgmma_kernel, Tf::THREADS, Tf::SMEM));
}

const char* sym_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
