// Implicit-im2col conv-patch Gram for Hopper (sm_90a): f32 or bf16 in,
// f32 out.
//
// Replaces the Pallas kernels of curvature_tpu/ops/pallas/patch_gram.py:
//   patch_gram_tiled  (_kernel_tiled, patch_gram.py:319; pallas_call :535)
//   patch_gram_v2     (_kernel_v2 :173 / _kernel_v2_strided :196; :270)
//   patch_gram        (_kernel :72, row strips with a manual halo DMA; :144)
// All three compute the same function: for NHWC input x, kernel (kh, kw),
// stride s in {1, 2} and explicit padding, the unnormalized Gram
// G = P^T P of the patch matrix P = [N, F+1] (N = B*Ho*Wo tokens,
// F = C*kh*kw features in canonical (c, dy, dx) order, ones column last).
// Every Pallas version is dtype-generic with f32 accumulation; so is this
// one: bf16 elements are widened to f32 as they are gathered.
//
// What bounds it: on ResNet-50's main-path shapes (F = 576 and 1152,
// N = 50,176 and 12,544) the lower triangle alone is N*F*(F+1) ~ 1.7e10
// FLOP against 13-26 MB of input: far above the card's ops-per-byte
// line, so it is bound by arithmetic. It stays in strict FP32 FMA (no TF32
// tensor-core mma) because the parity bar of the JAX tests, 1e-4 of
// max|G|, is out of TF32's reach. (For bf16 operands the tensor cores
// would give the same exact products; that is later work.)
//
// What the design does about it (and about what the TPU versions needed):
//  * No patch matrix and no padded copy ever reach device memory: each
//    block gathers its patch rows straight from x into shared memory
//    (token n -> (b, oy, ox), feature f -> (c, dy, dx)); padding is a
//    bounds check that reads zero. The TPU's VMEM-driven pieces (row
//    strips with a halo DMA, row bands, the parity stack, kb feature
//    tiles) have no counterpart: patch_gram's strips are just this
//    kernel's stride-1 instance.
//  * Each block owns one 64x64 tile of the lower triangle of the [F, F]
//    core (internal feature order (tap, c), so 64 consecutive features are
//    64 consecutive channels: coalesced loads). 256 threads hold 4x4 f32
//    accumulators each and run FP32 FMAs out of shared memory.
//  * The gather keeps its global loads in flight under the FMAs: the next
//    chunk of 32 tokens is loaded into registers before the current one is
//    multiplied, into a second shared-memory stage (one barrier a chunk),
//    and token positions advance by additions, not 64-bit divisions.
//  * The TPU's sequential-grid accumulation becomes a split over token
//    chunks: blockIdx.y picks a contiguous token range, and the wrapper
//    picks the split count that best fills whole waves of resident blocks,
//    so the 45 tiles of F = 576 still fill 132 SMs. Partial tiles go to a
//    workspace and a second kernel sums them in a fixed order: no atomics,
//    so results repeat bit for bit from run to run.
//  * Diagonal-tile blocks also sum their columns (the ones row/column),
//    and the reduce kernel writes the canonical (c, dy, dx) order directly,
//    with N in the corner, replacing the JAX perm gather.
#include "gram_tile.cuh"

namespace {

using gram::BK;
using gram::THREADS;
using gram::TILE;

struct Geom {
  int H, W, C, kw;
  int pt, pl, Ho, Wo;
  int F;                     // C * kh * kw
  int N;                     // B * Ho * Wo (the wrapper keeps it < 2^31)
};

__device__ __forceinline__ void decode_feature(const Geom& g, int f, int& c,
                                               int& dy, int& dx) {
  int k = f / g.C;           // internal order: f = (dy*kw + dx)*C + c
  c = f - k * g.C;
  dy = k / g.kw;
  dx = k - dy * g.kw;
}

// Position of one token row: image offset (elements) and output (oy, ox).
struct Row {
  int base, oy, ox;
};

__device__ __forceinline__ Row row_at(const Geom& g, int n) {
  const int howo = g.Ho * g.Wo;
  const int bi = n / howo;
  const int rem = n - bi * howo;
  Row r;
  r.base = bi * g.H * g.W * g.C;
  r.oy = rem / g.Wo;
  r.ox = rem - r.oy * g.Wo;
  return r;
}

// Moves a row BK tokens on without a division (all threads of a warp
// share the row, so the loops do not diverge).
__device__ __forceinline__ void advance(const Geom& g, Row& r) {
  r.ox += BK;
  while (r.ox >= g.Wo) { r.ox -= g.Wo; ++r.oy; }
  while (r.oy >= g.Ho) { r.oy -= g.Ho; r.base += g.H * g.W * g.C; }
}

template <typename T, int S>
__device__ __forceinline__ float gather(const T* __restrict__ x,
                                        const Geom& g, const Row& r,
                                        bool valid, int dy, int dx, int c) {
  const int iy = r.oy * S - g.pt + dy, ix = r.ox * S - g.pl + dx;
  if (!valid || iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) return 0.0f;
  return gram::to_f32(x + r.base + (iy * g.W + ix) * g.C + c);
}

template <typename T, int S>
__global__ void __launch_bounds__(THREADS, 2)
gram_partial_kernel(const T* __restrict__ x, float* __restrict__ ws,
                    float* __restrict__ colsum_ws, Geom g, int nt,
                    int num_tiles, int tokens_per_split) {
  const int t = blockIdx.x;
  int ti, tj;
  gram::tri_tile(t, ti, tj);
  const bool diag = ti == tj;
  const int split = blockIdx.y;
  const int n_begin = split * tokens_per_split;
  const int n_end = min(n_begin + tokens_per_split, g.N);

  // two stages: the next chunk is stored while this one is multiplied
  __shared__ __align__(16) float As[2][BK][TILE];
  __shared__ __align__(16) float Bs[2][BK][TILE];

  const int tid = threadIdx.x;
  const int r = tid % TILE;        // feature column this thread gathers
  const int row0 = tid / TILE;     // token rows row0 + 4m, m < BK/4
  constexpr int M = BK / 4;
  const int fa = ti * TILE + r, fb = tj * TILE + r;
  const bool va = fa < g.F, vb = fb < g.F;
  int ca = 0, dya = 0, dxa = 0, cb = 0, dyb = 0, dxb = 0;
  if (va) decode_feature(g, fa, ca, dya, dxa);
  if (vb) decode_feature(g, fb, cb, dyb, dxb);

  Row rows[M];
#pragma unroll
  for (int m = 0; m < M; ++m)
    rows[m] = row_at(g, min(n_begin + row0 + 4 * m, g.N - 1));
  float ra[M], rb[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const bool in = n_begin + row0 + 4 * m < n_end;
    ra[m] = gather<T, S>(x, g, rows[m], in && va, dya, dxa, ca);
    rb[m] = gather<T, S>(x, g, rows[m], in && vb, dyb, dxb, cb);
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
  float csum = 0.0f;

  int buf = 0;
  for (int n0 = n_begin; n0 < n_end; n0 += BK) {
    const bool more = n0 + BK < n_end;
    if (more) {                    // start the next chunk's loads now
#pragma unroll
      for (int m = 0; m < M; ++m) {
        advance(g, rows[m]);
        const bool in = n0 + BK + row0 + 4 * m < n_end;
        ra[m] = gather<T, S>(x, g, rows[m], in && va, dya, dxa, ca);
        rb[m] = gather<T, S>(x, g, rows[m], in && vb, dyb, dxb, cb);
      }
    }
    if (diag && tid < TILE) {
#pragma unroll
      for (int k = 0; k < BK; ++k) csum += As[buf][k][tid];
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
  if (diag && tid < TILE)
    colsum_ws[static_cast<size_t>(split) * nt * TILE + ti * TILE + tid] = csum;
}

// Sums the split partials in a fixed order and writes [F+1, F+1] in the
// canonical (c, dy, dx) order, ones row/column last, N in the corner.
__global__ void gram_reduce_kernel(const float* __restrict__ ws,
                                   const float* __restrict__ colsum_ws,
                                   float* __restrict__ out, int F, int C,
                                   int K, int nt, int num_tiles, int splits,
                                   float n_tokens) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  const int f1 = F + 1;
  if (j >= f1) return;
  float v = 0.0f;
  if (i == F && j == F) {
    v = n_tokens;
  } else if (i == F || j == F) {
    const int f = (i == F) ? j : i;
    const int fi = (f % K) * C + f / K;
    for (int s = 0; s < splits; ++s)
      v += colsum_ws[static_cast<size_t>(s) * nt * TILE + fi];
  } else {
    const int fi = (i % K) * C + i / K;
    const int fj = (j % K) * C + j / K;
    const int a = max(fi, fj), b = min(fi, fj);
    const int ta = a / TILE, tb = b / TILE;
    const size_t off =
        static_cast<size_t>(ta * (ta + 1) / 2 + tb) * TILE * TILE +
        (a % TILE) * TILE + (b % TILE);
    for (int s = 0; s < splits; ++s)
      v += ws[static_cast<size_t>(s) * num_tiles * TILE * TILE + off];
  }
  out[static_cast<size_t>(i) * f1 + j] = v;
}

template <typename T>
int launch(const T* x, float* out, float* ws, float* colsum_ws, int B, int H,
           int W, int C, int kh, int kw, int stride, int pt, int pl, int Ho,
           int Wo, int splits, int tokens_per_split, void* stream) {
  Geom g;
  g.H = H; g.W = W; g.C = C; g.kw = kw;
  g.pt = pt; g.pl = pl; g.Ho = Ho; g.Wo = Wo;
  g.F = C * kh * kw;
  g.N = B * Ho * Wo;
  const int nt = (g.F + TILE - 1) / TILE;
  const int num_tiles = nt * (nt + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(num_tiles, splits);
  if (stride == 1) {
    gram_partial_kernel<T, 1><<<grid, THREADS, 0, s>>>(
        x, ws, colsum_ws, g, nt, num_tiles, tokens_per_split);
  } else if (stride == 2) {
    gram_partial_kernel<T, 2><<<grid, THREADS, 0, s>>>(
        x, ws, colsum_ws, g, nt, num_tiles, tokens_per_split);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int f1 = g.F + 1;
  dim3 rgrid((f1 + 255) / 256, f1);
  gram_reduce_kernel<<<rgrid, 256, 0, s>>>(
      ws, colsum_ws, out, g.F, C, kh * kw, nt, num_tiles, splits,
      static_cast<float>(g.N));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
cudaError_t blocks_per_sm(int stride, int* blocks) {
  return stride == 1
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, gram_partial_kernel<T, 1>, THREADS, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, gram_partial_kernel<T, 2>, THREADS, 0);
}

}  // namespace

extern "C" {

// Entries of patch_gram_tiled, patch_gram_v2 and patch_gram
// (curvature_tpu_torch/ops/cuda/patch_gram.py), one per element type: the
// three share this kernel, and the stride is a template parameter of the
// gather, not a separate body.
int patch_gram_f32(const float* x, float* out, float* ws, float* colsum_ws,
                   int B, int H, int W, int C, int kh, int kw, int stride,
                   int pt, int pl, int Ho, int Wo, int splits,
                   int tokens_per_split, void* stream) {
  return launch(x, out, ws, colsum_ws, B, H, W, C, kh, kw, stride, pt, pl, Ho,
                Wo, splits, tokens_per_split, stream);
}

int patch_gram_bf16(const __nv_bfloat16* x, float* out, float* ws,
                    float* colsum_ws, int B, int H, int W, int C, int kh,
                    int kw, int stride, int pt, int pl, int Ho, int Wo,
                    int splits, int tokens_per_split, void* stream) {
  return launch(x, out, ws, colsum_ws, B, H, W, C, kh, kw, stride, pt, pl, Ho,
                Wo, splits, tokens_per_split, stream);
}

// Resident partial-kernel blocks per SM, for the wrapper's split count.
int patch_gram_blocks_per_sm(int stride, int bf16, int* blocks) {
  return static_cast<int>(bf16 ? blocks_per_sm<__nv_bfloat16>(stride, blocks)
                               : blocks_per_sm<float>(stride, blocks));
}

const char* patch_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
