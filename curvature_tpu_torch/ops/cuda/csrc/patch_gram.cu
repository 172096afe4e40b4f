// Implicit-im2col conv-patch Gram for Hopper (sm_90a): f32 or bf16 in,
// f32 out.
//
// Replaces the Pallas kernels of curvature_tpu/ops/pallas/patch_gram.py:
//   patch_gram_tiled  (_kernel_tiled, patch_gram.py:319; pallas_call :535)
//   patch_gram_v2     (_kernel_v2 :173 / _kernel_v2_strided :196; :270)
//   patch_gram        (_kernel :72, row strips with a manual halo DMA; :144)
// All three compute the same function: for NHWC input x, kernel (kh, kw),
// strides (sh, sw) and explicit padding, the unnormalized Gram
// G = P^T P of the patch matrix P = [N, F+1] (N = B*Ho*Wo tokens,
// F = C*kh*kw features in canonical (c, dy, dx) order, ones column last).
// Every Pallas version is dtype-generic with f32 accumulation; so is this
// file, with one kernel body per element type, both on the tensor cores:
//  * f32: gram_tf32x3_wgmma_kernel, 3xTF32 products (tf32x3_gram.cuh): each
//    value split into TF32 hi and lo halves, lo*hi + hi*lo + hi*hi summed
//    in f32, within ~2^-21 of the f32 products;
//  * bf16: gram_wgmma_kernel, bf16 x bf16 -> f32 (wgmma_gram.cuh). bf16
//    products are exact in f32, so it computes the same function as the
//    f32 path on the widened values.
//
// What bounds it: on ResNet-50's main-path shapes (F = 576 and 1152,
// N = 50,176 and 12,544-25,088) the lower triangle alone is N*F*(F+1)
// ~ 1.7e10-3.3e10 FLOP against 13-26 MB of input: far above the card's
// ops-per-byte line, so the FLOP bound is the one that counts. One TF32
// product misses the JAX tests' parity bar (1e-4 of max|G|), so f32 takes
// three: 3x the FLOP at the dense TF32 rate (495 TFLOP/s), 2.5x below
// strict FP32 FMA's bound (67 TFLOP/s). Once the tensor cores make the
// arithmetic cheap, what is left is the gather: every tile re-reads its
// token rows (from L2: the input fits in it), so both kernels take 128x128
// tiles (half the bytes per FLOP of 64x64; PERF.md) and keep their next
// loads in flight under the tensor cores' work. In f32 the gather also
// transposes and splits every value, and its instructions bound the
// kernel (PERF.md).
//
// What the design does about it (and about what the TPU versions needed):
//  * No patch matrix and no padded copy ever reach device memory: each
//    block gathers its patch rows straight from x into shared memory
//    (token n -> (b, oy, ox), feature f -> (c, dy, dx)); padding is a
//    bounds check that reads zero. The TPU's VMEM-driven pieces (row
//    strips with a halo DMA, row bands, the parity stack, kb feature
//    tiles) have no counterpart: patch_gram's strips are just this
//    kernel's stride-1 instance.
//  * The stride is a template parameter S of the gather: S = 1 and S = 2
//    (both dims; every main-path conv) fix it at compile time, and S = 0
//    reads (sh, sw) from the geometry at run time for any other pair, such
//    as (3, 3), (1, 2) or (2, 1), which patch_gram_v2 takes as the Pallas
//    parity stack does (patch_gram.py:251-268).
//  * Each block owns one 128x128 tile of the lower triangle of the [F, F]
//    core (internal feature order (tap, c), so consecutive features are
//    consecutive channels: coalesced loads), two warpgroups running
//    wgmma.m64n128k{8,16}. f32: tf32 wgmma takes only K-major operands
//    (the token axis contiguous), so each thread loads a 4-token x
//    4-channel block (one 16-byte load per token when C % 4 == 0), splits
//    it and writes it transposed into swizzled [features x 32 tokens] hi
//    and lo slabs; the next chunk's loads wait in registers under the
//    current chunk's products (two shared-memory stages). bf16: the
//    operands stay token-major ([64 tokens x 128 features], transpose bits
//    set), so each thread copies 8 channels of one tap (16 bytes) per token
//    row with cp.async into a 3-stage ring. Each decodes its (tap, c0) once
//    per block; for other C a scalar gather fills the same layout.
//  * Token positions advance by additions, not 64-bit divisions.
//  * The TPU's sequential-grid accumulation becomes a split over token
//    chunks: blockIdx.y picks a contiguous token range, and the wrapper
//    picks the split count that best fills whole waves of resident blocks
//    (so the 15 tiles of F = 576 still fill 132 SMs), with at most
//    MAX_CHAIN_TOKENS tokens in one tensor-core accumulator. Partial tiles
//    go to a workspace of 64x64 tiles and a second kernel sums them in a
//    fixed order: no atomics, so results repeat bit for bit from run to run.
//  * Diagonal-tile blocks also sum their columns (the ones row/column) in
//    f32 from the gathered values, and the reduce kernel writes the
//    canonical (c, dy, dx) order directly, with N in the corner, replacing
//    the JAX perm gather.
#include "gram_tile.cuh"
#include "tf32x3_gram.cuh"
#include "wgmma_gram.cuh"

namespace {

using gram::TILE;

struct Geom {
  int H, W, C, kw;
  int sh, sw;                // read by the run-time-stride instance (S = 0)
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

// Moves a row STEP tokens on without a division.
template <int STEP>
__device__ __forceinline__ void advance(const Geom& g, Row& r) {
  r.ox += STEP;
  while (r.ox >= g.Wo) { r.ox -= g.Wo; ++r.oy; }
  while (r.oy >= g.Ho) { r.oy -= g.Ho; r.base += g.H * g.W * g.C; }
}

// Element offset in x of tap (dy, dx), channel c of token row r, or -1 in
// the padding. S > 0 is the stride of both dims; S = 0 takes g.sh, g.sw.
template <int S>
__device__ __forceinline__ int tap_offset(const Geom& g, const Row& r, int dy,
                                          int dx, int c) {
  const int sh = S > 0 ? S : g.sh, sw = S > 0 ? S : g.sw;
  const int iy = r.oy * sh - g.pt + dy, ix = r.ox * sw - g.pl + dx;
  if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) return -1;
  return r.base + (iy * g.W + ix) * g.C + c;
}

// What the f32 gather loads for padding taps and tail tokens: every load
// is unconditional, and no branch surrounds it.
__device__ const float4 kZero4 = {0.0f, 0.0f, 0.0f, 0.0f};

// Tile edge of the f32 kernel: 64 * TF_WGS features, TF_WGS warpgroups a
// block. 128 here: at the main-path shapes it measured 0.50 ms (F = 576)
// and 0.46 ms (v2) against 0.61 and 0.60 ms for 64 (PERF.md).
constexpr int TF_WGS = 2;
using Tf = tf::Shape<TF_WGS>;

// The f32 kernel's gather, for tile ti (A) and, off the diagonal, tile tj
// (B). Per 32-token chunk, thread t holds a block of 4 tokens x 4 features
// of each operand: features 4q..4q+3 of the tile, q = 4 * warp + lane / 8,
// and tokens 4p..4p+3 of the chunk, p = lane % 8 (8 lanes on one feature
// quad: their transposed 16-byte stores hit 8 distinct chunks of a row).
// VEC (C % 4 == 0, x 16-byte aligned): the quad is 4 channels of one tap,
// one 16-byte ld.global.nc per token, its (tap, c0) decoded once per block.
// Otherwise: 4 scalar loads per token (each feature decoded once per block)
// into the same registers. Padding taps and tail tokens read zero.
template <int S, bool VEC>
struct Tf32Gather {
  struct Tap {
    int dy, dx, c;
  };
  const float* __restrict__ x;
  Geom g;
  int n_next, n_end;                  // first token of the next chunk
  int q, p;                           // feature quad, token quad
  int fa, fb;                         // first feature of the A / B quad
  bool diag;
  Tap ta[4], tb[4];                   // the quads' taps (VEC: [0] only)
  Row rows[4];                        // the thread's tokens in the next chunk
  float4 va[4], vb[4];                // va[j]: the A quad at token j
  float csum[4];                      // diagonal: column sums of the A quad

  __device__ Tf32Gather(const float* x_, const Geom& g_, int ti, int tj,
                        int n_begin, int n_end_)
      : x(x_), g(g_), n_next(n_begin), n_end(n_end_), diag(ti == tj) {
    const int lane = threadIdx.x % 32;
    q = 4 * (threadIdx.x / 32) + lane / 8;
    p = lane % 8;
    fa = ti * Tf::TILE + 4 * q;
    fb = tj * Tf::TILE + 4 * q;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ta[e] = tb[e] = Tap{0, 0, 0};
      if (VEC && e > 0) continue;
      if (fa + e < g.F) decode_feature(g, fa + e, ta[e].c, ta[e].dy, ta[e].dx);
      if (fb + e < g.F) decode_feature(g, fb + e, tb[e].c, tb[e].dy, tb[e].dx);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rows[j] = row_at(g, min(n_begin + 4 * p + j, g.N - 1));
      csum[j] = 0.0f;
    }
  }

  // the quad from f0 at one token row
  __device__ __forceinline__ float4 load(const Row& r, bool in, int f0,
                                         const Tap (&t)[4]) const {
    if (VEC) {
      const int off =
          in && f0 < g.F ? tap_offset<S>(g, r, t[0].dy, t[0].dx, t[0].c) : -1;
      return __ldg(off >= 0 ? reinterpret_cast<const float4*>(x + off)
                            : &kZero4);
    }
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = in && f0 + e < g.F
          ? tap_offset<S>(g, r, t[e].dy, t[e].dx, t[e].c) : -1;
      v[e] = __ldg(off >= 0 ? x + off : &kZero4.x);
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }

  // starts the next chunk's loads into va (and vb)
  __device__ __forceinline__ void fetch() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = n_next + 4 * p + j < n_end;
      va[j] = load(rows[j], in, fa, ta);
      if (!diag) vb[j] = load(rows[j], in, fb, tb);
      advance<tf::BK>(g, rows[j]);
    }
    n_next += tf::BK;
  }

  __device__ static __forceinline__ float at(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }

  // the fetched chunk, transposed: feature row 4q + e, tokens 4p..4p+3
  __device__ __forceinline__ void store(const tf::Slots& s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t d = tf::swizzled(4 * q + e, p);
      const float a[4] = {at(va[0], e), at(va[1], e), at(va[2], e),
                          at(va[3], e)};
      tf::store_split(s.a_hi + d, s.a_lo + d, a);
      if (diag) {               // ones row/column: exact f32 adds
#pragma unroll
        for (int j = 0; j < 4; ++j) csum[e] += a[j];
      } else {
        const float b[4] = {at(vb[0], e), at(vb[1], e), at(vb[2], e),
                            at(vb[3], e)};
        tf::store_split(s.b_hi + d, s.b_lo + d, b);
      }
    }
  }

  // diagonal tile: the column sums of the tile's features over the block's
  // tokens (the 8 token quads summed in a fixed order) into out[f] for the
  // tile's features f < limit
  __device__ __forceinline__ void write_colsum(float* __restrict__ out,
                                               int limit) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int m = 1; m < 8; m *= 2)
        csum[e] += __shfl_xor_sync(0xffffffffu, csum[e], m);
    if (p == 0)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < limit) out[4 * q + e] = csum[e];
  }
};

// f32 partial tile on the tensor cores, 3xTF32 (tf32x3_gram.cuh): grid
// (lower tiles of edge Tf::TILE, splits), TF_WGS warpgroups a block,
// Tf::SMEM bytes of dynamic shared memory. Writes the 64x64-tile workspace
// (nt, num_tiles: of 64-tiles) and, on diagonal tiles, the column sums,
// for gram_reduce_kernel.
template <int S, bool VEC>
__global__ void __launch_bounds__(Tf::THREADS)
gram_tf32x3_wgmma_kernel(const float* __restrict__ x, float* __restrict__ ws,
                         float* __restrict__ colsum_ws, Geom g, int nt,
                         int num_tiles, int tokens_per_split) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int ti, tj;
  gram::tri_tile(blockIdx.x, ti, tj);
  const int split = blockIdx.y;
  const int n_begin = split * tokens_per_split;
  const int n_end = min(n_begin + tokens_per_split, g.N);
  const int nchunks =
      n_end > n_begin ? (n_end - n_begin + tf::BK - 1) / tf::BK : 0;

  Tf32Gather<S, VEC> gather(x, g, ti, tj, n_begin, n_end);
  float acc[Tf::ACC];
  tf::gram_tile<TF_WGS>(gather, wg::ring_base(smem), nchunks, ti == tj, acc);
  if (ti == tj)
    gather.write_colsum(colsum_ws + static_cast<size_t>(split) * nt * TILE +
                            ti * Tf::TILE,
                        nt * TILE - ti * Tf::TILE);
  wg::store_subtiles<TF_WGS>(
      ws + static_cast<size_t>(split) * num_tiles * TILE * TILE, ti, tj, nt,
      acc);
}

// Tile edge of the bf16 kernel: 64 * WGS features, WGS warpgroups a block.
// 128 here: at the main-path shapes it measured 0.26 ms (v2, B=32) and
// 0.14 ms (F = 576) against 0.31 and 0.16 ms for 64 (PERF.md).
constexpr int WGS = 2;
using Wg = wg::Shape<WGS>;

// The bf16 kernel's gather (wg::GatherSlot says which 16-byte chunk of
// which token rows a thread copies), for tile ti (A) and, off the
// diagonal, tile tj (B). VEC (C % 8 == 0): the chunk's 8 features are 8
// channels of one tap, one cp.async each, with padding taps and tail
// tokens zero-filled (source size 0). Otherwise: 8 scalar loads (each
// feature decoded), one 16-byte store.
template <int S, bool VEC>
struct PatchGather {
  static constexpr int M = wg::BK / 16;      // token rows per thread
  const __nv_bfloat16* __restrict__ x;
  Geom g;
  int n_next, n_end;                         // first token of the next chunk
  wg::GatherSlot at;
  int fa, fb;                                // first feature of A / B
  int dya, dxa, ca, dyb, dxb, cb;            // VEC: the chunk's tap and c0
  Row rows[M];

  __device__ PatchGather(const __nv_bfloat16* x_, const Geom& g_, int ti,
                         int tj, int n_begin, int n_end_)
      : x(x_), g(g_), n_next(n_begin), n_end(n_end_) {
    fa = ti * Wg::TILE + at.feature;
    fb = tj * Wg::TILE + at.feature;
    dya = dxa = ca = dyb = dxb = cb = 0;
    if (VEC) {
      if (fa < g.F) decode_feature(g, fa, ca, dya, dxa);
      if (fb < g.F) decode_feature(g, fb, cb, dyb, dxb);
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
      rows[m] = row_at(g, min(n_begin + at.r0 + 16 * m, g.N - 1));
  }

  __device__ __forceinline__ void copy(uint32_t d, const Row& r, bool in,
                                       int f0, int dy, int dx, int c) const {
    if (VEC) {
      const int off = in && f0 < g.F ? tap_offset<S>(g, r, dy, dx, c) : -1;
      wg::cp_async16(d, off >= 0 ? x + off : x, off >= 0);
    } else {
      const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
      unsigned int w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (!in || f0 + e >= g.F) continue;
        int ce, dye, dxe;
        decode_feature(g, f0 + e, ce, dye, dxe);
        const int off = tap_offset<S>(g, r, dye, dxe, ce);
        if (off >= 0)
          w[e / 2] |= static_cast<unsigned int>(__ldg(xs + off))
                      << (16 * (e % 2));
      }
      wg::st_shared16(d, make_uint4(w[0], w[1], w[2], w[3]));
    }
  }

  // the next BK tokens into slot_a (and slot_b, unless it is slot_a)
  __device__ __forceinline__ void load(uint32_t slot_a, uint32_t slot_b) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const bool in = n_next + at.r0 + 16 * m < n_end;
      const uint32_t d = at.dst + m * 16 * wg::ROW_BYTES;
      copy(slot_a + d, rows[m], in, fa, dya, dxa, ca);
      if (slot_b != slot_a) copy(slot_b + d, rows[m], in, fb, dyb, dxb, cb);
      advance<wg::BK>(g, rows[m]);
    }
    n_next += wg::BK;
  }
};

// bf16 partial tile on the tensor cores: grid (lower tiles of edge
// Wg::TILE, splits), WGS warpgroups a block, Wg::SMEM bytes of dynamic
// shared memory. Writes the same 64x64-tile workspace as
// gram_tf32x3_wgmma_kernel (nt, num_tiles: of 64-tiles), for the same
// reduce.
template <int S, bool VEC>
__global__ void __launch_bounds__(Wg::THREADS)
gram_wgmma_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ ws,
                  float* __restrict__ colsum_ws, Geom g, int nt, int num_tiles,
                  int tokens_per_split) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int ti, tj;
  gram::tri_tile(blockIdx.x, ti, tj);
  const bool diag = ti == tj;
  const int split = blockIdx.y;
  const int n_begin = split * tokens_per_split;
  const int n_end = min(n_begin + tokens_per_split, g.N);
  const int nchunks =
      n_end > n_begin ? (n_end - n_begin + wg::BK - 1) / wg::BK : 0;

  PatchGather<S, VEC> gather(x, g, ti, tj, n_begin, n_end);
  float acc[Wg::ACC];
  const int f = ti * Wg::TILE + threadIdx.x;     // the column sum's feature
  float* csum = f < nt * TILE
      ? colsum_ws + static_cast<size_t>(split) * nt * TILE + f : nullptr;
  wg::gram_tile<WGS, true>(gather, wg::ring_base(smem), nchunks, diag, acc,
                           csum);
  wg::store_subtiles<WGS>(
      ws + static_cast<size_t>(split) * num_tiles * TILE * TILE, ti, tj, nt,
      acc);
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

// The partial kernel of an element type, stride and gather, with its block
// size, dynamic shared memory and output tile edge.
template <typename T>
struct Partial {
  void (*fn)(const T*, float*, float*, Geom, int, int, int);
  int threads, smem;
  cudaError_t err;   // of the one-time shared-memory attribute
  int tile;
};

// Both kernels take more than 48 KB of dynamic shared memory: the
// attribute is set once per instance, before its first launch or query.
template <int S, bool VEC>
Partial<float> tf32x3_partial() {
  static const cudaError_t err = cudaFuncSetAttribute(
      gram_tf32x3_wgmma_kernel<S, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tf::SMEM);
  return {gram_tf32x3_wgmma_kernel<S, VEC>, Tf::THREADS, Tf::SMEM, err,
          Tf::TILE};
}

template <int S>
Partial<float> partial(const float*, int vec) {
  return vec ? tf32x3_partial<S, true>() : tf32x3_partial<S, false>();
}

template <int S, bool VEC>
Partial<__nv_bfloat16> wgmma_partial() {
  static const cudaError_t err = cudaFuncSetAttribute(
      gram_wgmma_kernel<S, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Wg::SMEM);
  return {gram_wgmma_kernel<S, VEC>, Wg::THREADS, Wg::SMEM, err,
          Wg::TILE};
}

template <int S>
Partial<__nv_bfloat16> partial(const __nv_bfloat16*, int vec) {
  return vec ? wgmma_partial<S, true>() : wgmma_partial<S, false>();
}

// The instance for strides (sh, sw): the compile-time ones for (1, 1) and
// (2, 2), the run-time one (S = 0) for any other positive pair.
template <typename T>
bool pick(int sh, int sw, int vec, Partial<T>& k) {
  if (sh < 1 || sw < 1) return false;
  const T* t = nullptr;
  k = sh == 1 && sw == 1   ? partial<1>(t, vec)
      : sh == 2 && sw == 2 ? partial<2>(t, vec)
                           : partial<0>(t, vec);
  return true;
}

template <typename T>
int launch(const T* x, float* out, float* ws, float* colsum_ws, int B, int H,
           int W, int C, int kh, int kw, int sh, int sw, int pt, int pl,
           int Ho, int Wo, int splits, int tokens_per_split, int vec,
           void* stream) {
  Geom g;
  g.H = H; g.W = W; g.C = C; g.kw = kw;
  g.sh = sh; g.sw = sw;
  g.pt = pt; g.pl = pl; g.Ho = Ho; g.Wo = Wo;
  g.F = C * kh * kw;
  g.N = B * Ho * Wo;
  const int nt = (g.F + TILE - 1) / TILE;
  const int num_tiles = nt * (nt + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Partial<T> k;
  if (!pick(sh, sw, vec, k) || (vec && C * sizeof(T) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k.err != cudaSuccess) return static_cast<int>(k.err);
  const int bt = (g.F + k.tile - 1) / k.tile;     // block tiles per edge
  k.fn<<<dim3(bt * (bt + 1) / 2, splits), k.threads, k.smem, s>>>(
      x, ws, colsum_ws, g, nt, num_tiles, tokens_per_split);
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
cudaError_t blocks_per_sm(int sh, int sw, int vec, int* blocks) {
  Partial<T> k;
  if (!pick(sh, sw, vec, k)) return cudaErrorInvalidValue;
  if (k.err != cudaSuccess) return k.err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k.fn, k.threads,
                                                       k.smem);
}

}  // namespace

extern "C" {

// Entries of patch_gram_tiled, patch_gram_v2 and patch_gram
// (curvature_tpu_torch/ops/cuda/patch_gram.py), one per element type: the
// three share each type's kernel, and the stride is a template parameter of
// the gather, not a separate body (see pick). `vec`: 1 for the 16-byte
// gather (C channels a multiple of 16 bytes, x 16-byte aligned), 0 for the
// scalar one.
int patch_gram_f32(const float* x, float* out, float* ws, float* colsum_ws,
                   int B, int H, int W, int C, int kh, int kw, int sh, int sw,
                   int pt, int pl, int Ho, int Wo, int splits,
                   int tokens_per_split, int vec, void* stream) {
  return launch(x, out, ws, colsum_ws, B, H, W, C, kh, kw, sh, sw, pt, pl, Ho,
                Wo, splits, tokens_per_split, vec, stream);
}

int patch_gram_bf16(const __nv_bfloat16* x, float* out, float* ws,
                    float* colsum_ws, int B, int H, int W, int C, int kh,
                    int kw, int sh, int sw, int pt, int pl, int Ho, int Wo,
                    int splits, int tokens_per_split, int vec, void* stream) {
  return launch(x, out, ws, colsum_ws, B, H, W, C, kh, kw, sh, sw, pt, pl, Ho,
                Wo, splits, tokens_per_split, vec, stream);
}

// Resident partial-kernel blocks per SM of the instance for (sh, sw), for
// the wrapper's split count.
int patch_gram_blocks_per_sm(int sh, int sw, int bf16, int vec, int* blocks) {
  return static_cast<int>(
      bf16 ? blocks_per_sm<__nv_bfloat16>(sh, sw, vec, blocks)
           : blocks_per_sm<float>(sh, sw, vec, blocks));
}

const char* patch_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
