// Correlation patch Gram of a stride-1 convolution for Hopper (sm_90a):
// f32 or bf16 NHWC in, f32 out.
//
// Replaces no Pallas kernel. The JAX package computes the correlation Gram
// (curvature_tpu/ops/corr_gram.py, corr_patch_gram) as plain XLA ops; the
// port's torch composition of it (ops/corr_gram.py) ran some 2,000 small
// torch ops a call: 13 full-field products, hundreds of boundary products
// on slices, and the block assembly, each a launch from the host. This
// file computes the same function in two launches.
//
// The function: for NHWC x [B, H, W, C], kernel (kh, kw) and padding
// (pt, pl), the Gram of the stride-1 patch matrix, F = C*kh*kw features in
// canonical (c, dy, dx) order, the ones column last and N = B*Ho*Wo in the
// corner. Its block (t, t') for taps t <= t' is a sum of signed rectangle
// products R = sum over b and the positions q of a rectangle of the image
// of x[b, q] x[b, q + delta]^T, delta = t' - t (the plan in
// ops/cuda/corr_gram.py: each delta's full field less its boundary strips
// plus their corners). Every rectangle and its shift lie in the image, so
// the padding is never read. FLOPs: 2*N*C^2*(2k^2 - 2k + 1) and the strips
// (3-7% more at ResNet-50's shapes), against 2*N*C^2*k^4 for the patch
// Gram.
//
// What bounds it: at ResNet-50's shapes ([128,28,28,128] and
// [128,14,14,256], 3x3) a call is ~40 GFLOP over 51 or 26 MB of input,
// far above the card's ops-per-byte line, so the tensor cores' rate is the
// bound, and f32 accuracy takes three TF32 products a product
// (tf32x3_gram.cuh): 3x the work at 495 TFLOP/s. As in patch_gram.cu the
// f32 gather, which transposes and splits every value through registers,
// is what limits the loop in practice.
//
// What the design does about it:
//  * corr_tf32x3_wgmma_kernel: one block per (rectangle, 128x128 output
//    tile, token split), the plan's table giving each its rectangle, delta,
//    tile and tokens; the longest blocks first, so the short boundary ones
//    fill the last wave. Both operands are plain NHWC rows: token n of a
//    rectangle is pixel (b, y0 + yy, x0 + xx), A reads its channels of
//    tile ti and B the pixel delta further on, channels of tile tj, 16 bytes
//    (f32) or 8 bytes (bf16) at a time where C % 4 == 0. No patch matrix,
//    no padded copy. The tile is tf::gram_tile, the 3xTF32 wgmma loop of
//    the patch kernels, with its flush of the accumulator; splits hold at
//    most MAX_CHAIN_TOKENS tokens.
//  * bf16 input is widened exactly: its 8 significant bits fit a TF32
//    half, so the lo halves are zero and the products exact.
//  * delta = 0 rectangles are symmetric: the lower tiles only, and their
//    diagonal tiles sum their columns (the ones row) from the gathered
//    values, as the patch kernels do.
//  * corr_assemble_kernel: each output element sums, in a fixed order, its
//    terms' split partials (the transposed partner where t > t' or above a
//    symmetric diagonal), or the ones row's column sums: no atomics, so
//    results repeat bit for bit.
#include "tf32x3_gram.cuh"

namespace {

constexpr int WGS = 2;                   // warpgroups a block
using Tf = tf::Shape<WGS>;
constexpr int TILE = Tf::TILE;           // 128: TILE in ops/cuda/corr_gram.py

// Fields of an item (rectangle) row and a block row of the plan's table
// (ITEM_FIELDS and BLOCK_FIELDS in ops/cuda/corr_gram.py).
enum ItemField {
  I_DY, I_DX, I_Y0, I_X0, I_RH, I_RW, I_TOKENS, I_PER_SPLIT, I_SPLITS,
  I_BASE, I_SYM, I_NT, ITEM_INTS
};
enum BlockField { B_ITEM, B_TI, B_TJ, B_SPLIT, BLOCK_INTS };

// What the gather loads for tail tokens and channels past C: every load
// is unconditional, and no branch surrounds it.
__device__ const float4 kZero4 = {0.0f, 0.0f, 0.0f, 0.0f};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float load1(const float* p) {
    return __ldg(p);
  }
};

// bf16 widened exactly: its bits are the high half of the f32's
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(v.x << 16),
                       __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xffff0000u));
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __uint_as_float(
        static_cast<unsigned int>(
            __ldg(reinterpret_cast<const unsigned short*>(p)))
        << 16);
  }
};

// The gather of one block, for tf::gram_tile: per 32-token chunk, thread t
// holds 4 tokens x 4 channels of each operand, channels 4q..4q+3 of the
// tile (q = 4 * warp + lane / 8) and tokens 4p..4p+3 of the chunk
// (p = lane % 8), as patch_gram.cu's Tf32Gather. A token's B value is its
// A pixel moved by delta: one constant offset, `shift`.
template <typename T, bool VEC>
struct CorrGather {
  const T* __restrict__ x;
  int H, W, C;
  int y0, x0, rh, rw, shift;          // the rectangle; delta in elements
  int n_next, n_end;                  // first token of the next chunk
  int q, p, ca, cb;                   // channel quad, token quad; A / B c0
  bool diag;
  int bi[4], yy[4], xx[4];            // the thread's tokens in the next chunk
  float4 va[4], vb[4];                // va[j]: the A quad at token j
  float csum[4];                      // diagonal: column sums of the A quad

  __device__ CorrGather(const T* x_, int H_, int W_, int C_,
                        const int* item, int ti, int tj, int n_begin,
                        int n_end_, bool diag_)
      : x(x_), H(H_), W(W_), C(C_), n_next(n_begin), n_end(n_end_),
        diag(diag_) {
    y0 = item[I_Y0];
    x0 = item[I_X0];
    rh = item[I_RH];
    rw = item[I_RW];
    shift = (item[I_DY] * W + item[I_DX]) * C;
    const int lane = threadIdx.x % 32;
    q = 4 * (threadIdx.x / 32) + lane / 8;
    p = lane % 8;
    ca = ti * TILE + 4 * q;
    cb = tj * TILE + 4 * q;
    const int area = rh * rw, last = item[I_TOKENS] - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = min(n_begin + 4 * p + j, last);
      bi[j] = n / area;
      const int r = n - bi[j] * area;
      yy[j] = r / rw;
      xx[j] = r - yy[j] * rw;
      csum[j] = 0.0f;
    }
  }

  // moves token j one chunk on; divides only where it leaves a row
  __device__ __forceinline__ void advance(int j) {
    xx[j] += tf::BK;
    if (xx[j] >= rw) {
      const int k = xx[j] / rw;
      xx[j] -= k * rw;
      yy[j] += k;
      if (yy[j] >= rh) {
        const int k2 = yy[j] / rh;
        yy[j] -= k2 * rh;
        bi[j] += k2;
      }
    }
  }

  // the quad of channels c0.. at element offset off of a pixel
  __device__ __forceinline__ float4 load(int off, bool in, int c0) const {
    const T* zero = reinterpret_cast<const T*>(&kZero4);
    if constexpr (VEC) {
      return Elem<T>::load4(in && c0 < C ? x + off + c0 : zero);
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = Elem<T>::load1(in && c0 + e < C ? x + off + c0 + e : zero);
      return make_float4(v[0], v[1], v[2], v[3]);
    }
  }

  // starts the next chunk's loads into va (and vb)
  __device__ __forceinline__ void fetch() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = n_next + 4 * p + j < n_end;
      const int off = ((bi[j] * H + y0 + yy[j]) * W + x0 + xx[j]) * C;
      va[j] = load(off, in, ca);
      if (!diag) vb[j] = load(off + shift, in, cb);
      advance(j);
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

  // diagonal tile: the column sums of the tile's channels over the block's
  // tokens (the 8 token quads summed in a fixed order) into out[c] for the
  // tile's channels c < limit
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

// One block's partial tile (rectangle, tile, split) on the tensor cores,
// 3xTF32: grid = the plan's blocks, Tf::THREADS threads, Tf::SMEM bytes of
// dynamic shared memory. Writes the whole 128x128 tile to its workspace
// slot and, on a symmetric diagonal tile, its column sums.
template <typename T, bool VEC>
__global__ void __launch_bounds__(Tf::THREADS)
corr_tf32x3_wgmma_kernel(const T* __restrict__ x, float* __restrict__ ws,
                         float* __restrict__ colsum_ws,
                         const int* __restrict__ items,
                         const int* __restrict__ blocks, int H, int W,
                         int C) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int* blk = blocks + blockIdx.x * BLOCK_INTS;
  const int* item = items + blk[B_ITEM] * ITEM_INTS;
  const int ti = blk[B_TI], tj = blk[B_TJ], split = blk[B_SPLIT];
  const bool sym = item[I_SYM] != 0;
  const bool diag = sym && ti == tj;
  const int n_begin = split * item[I_PER_SPLIT];
  const int n_end = min(n_begin + item[I_PER_SPLIT], item[I_TOKENS]);
  const int nchunks =
      n_end > n_begin ? (n_end - n_begin + tf::BK - 1) / tf::BK : 0;

  CorrGather<T, VEC> gather(x, H, W, C, item, ti, tj, n_begin, n_end, diag);
  float acc[Tf::ACC];
  tf::gram_tile<WGS>(gather, wg::ring_base(smem), nchunks, diag, acc);

  const int tile = sym ? ti * (ti + 1) / 2 + tj : ti * item[I_NT] + tj;
  const size_t slot =
      static_cast<size_t>(item[I_BASE]) + tile * item[I_SPLITS] + split;
  if (diag) gather.write_colsum(colsum_ws + slot * TILE, C - ti * TILE);
  float* out = ws + slot * TILE * TILE;
  const int r0 = 64 * (threadIdx.x / 128);    // this warpgroup's rows
#pragma unroll
  for (int i = 0; i < Tf::ACC; i += 2)
    *reinterpret_cast<float2*>(
        &out[(r0 + wg::acc_row(i)) * TILE + wg::acc_col(i)]) =
        make_float2(acc[i], acc[i + 1]);
}

// Item `item`'s product at [c, d], its splits summed in order: a symmetric
// item keeps its lower tiles, so [c, d] above them reads [d, c].
__device__ __forceinline__ float item_value(const float* __restrict__ ws,
                                            const int* item, int c, int d) {
  int ti = c / TILE, tj = d / TILE;
  const bool sym = item[I_SYM] != 0;
  if (sym && ti < tj) {
    const int tc = c, tt = ti;
    c = d; d = tc; ti = tj; tj = tt;
  }
  const int tile = sym ? ti * (ti + 1) / 2 + tj : ti * item[I_NT] + tj;
  const size_t slot0 =
      static_cast<size_t>(item[I_BASE]) + tile * item[I_SPLITS];
  const size_t off = (c % TILE) * TILE + d % TILE;
  float v = 0.0f;
  for (int s = 0; s < item[I_SPLITS]; ++s)
    v += ws[(slot0 + s) * TILE * TILE + off];
  return v;
}

// Symmetric item `item`'s column sum of channel c, its splits in order.
__device__ __forceinline__ float item_colsum(const float* __restrict__ cs,
                                             const int* item, int c) {
  const int ti = c / TILE;
  const size_t slot0 = static_cast<size_t>(item[I_BASE]) +
                       (ti * (ti + 1) / 2 + ti) * item[I_SPLITS];
  float v = 0.0f;
  for (int s = 0; s < item[I_SPLITS]; ++s)
    v += cs[(slot0 + s) * TILE + c % TILE];
  return v;
}

// The [F1, F1] output (F1 = F + has_bias): block (blockIdx.x, y) takes 256
// columns j of row i, both in the internal order (tap, c) with the ones
// last, so neighbouring threads read neighbouring channels of a partial
// tile; each writes its element at its canonical (c, tap) place. `ranges`
// [K*K][2] holds (t, t')'s first and end term for t <= t'; `terms` (item,
// sign) pairs.
__global__ void corr_assemble_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ colsum_ws,
                                     const int* __restrict__ items,
                                     const int* __restrict__ ranges,
                                     const int* __restrict__ terms,
                                     float* __restrict__ out, int C, int K,
                                     int has_bias, float n_tokens) {
  const int F = C * K, f1 = F + has_bias;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= f1) return;
  float v = 0.0f;
  if (i == F && j == F) {
    v = n_tokens;
  } else if (i == F || j == F) {     // window sums: block (t, t)'s terms
    const int f = i == F ? j : i;
    const int t = f / C, c = f - t * C;
    const int* r = ranges + 2 * (t * K + t);
    for (int k = r[0]; k < r[1]; ++k) {
      const float s =
          item_colsum(colsum_ws, items + terms[2 * k] * ITEM_INTS, c);
      v += terms[2 * k + 1] > 0 ? s : -s;
    }
  } else {
    int t = i / C, c = i - t * C, t2 = j / C, d = j - t2 * C;
    if (t > t2) {                    // block (t, t') = block (t', t)^T
      const int tt = t, tc = c;
      t = t2; t2 = tt; c = d; d = tc;
    }
    const int* r = ranges + 2 * (t * K + t2);
    for (int k = r[0]; k < r[1]; ++k) {
      const float s = item_value(ws, items + terms[2 * k] * ITEM_INTS, c, d);
      v += terms[2 * k + 1] > 0 ? s : -s;
    }
  }
  const int ci = i == F ? F : (i % C) * K + i / C;
  const int cj = j == F ? F : (j % C) * K + j / C;
  out[static_cast<size_t>(ci) * f1 + cj] = v;
}

// The partial kernel of an element type and gather, with its one-time
// shared-memory attribute (it takes more than 48 KB).
template <typename T>
struct Partial {
  void (*fn)(const T*, float*, float*, const int*, const int*, int, int,
             int);
  cudaError_t err;
};

template <typename T, bool VEC>
Partial<T> instance() {
  static const cudaError_t err = cudaFuncSetAttribute(
      corr_tf32x3_wgmma_kernel<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tf::SMEM);
  return {corr_tf32x3_wgmma_kernel<T, VEC>, err};
}

template <typename T>
Partial<T> pick(int vec) {
  return vec ? instance<T, true>() : instance<T, false>();
}

template <typename T>
int launch(const T* x, float* out, float* ws, float* colsum_ws,
           const int* items, const int* blocks, const int* ranges,
           const int* terms, int n_blocks, int H, int W, int C, int K,
           int has_bias, int n_tokens, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Partial<T> k = pick<T>(vec);
  if (k.err != cudaSuccess) return static_cast<int>(k.err);
  k.fn<<<n_blocks, Tf::THREADS, Tf::SMEM, s>>>(x, ws, colsum_ws, items,
                                               blocks, H, W, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int f1 = C * K + has_bias;
  corr_assemble_kernel<<<dim3((f1 + 255) / 256, f1), 256, 0, s>>>(
      ws, colsum_ws, items, ranges, terms, out, C, K, has_bias,
      static_cast<float>(n_tokens));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
cudaError_t blocks_per_sm(int vec, int* blocks) {
  const Partial<T> k = pick<T>(vec);
  if (k.err != cudaSuccess) return k.err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k.fn,
                                                       Tf::THREADS, Tf::SMEM);
}

}  // namespace

extern "C" {

// Entries of corr_gram (curvature_tpu_torch/ops/cuda/corr_gram.py), one per
// element type. `items`, `blocks`, `ranges` and `terms` point into the
// plan's device table; `vec`: 1 for the 4-channel loads (C % 4 == 0, x
// aligned to them), 0 for the scalar ones.
int corr_gram_f32(const float* x, float* out, float* ws, float* colsum_ws,
                  const int* items, const int* blocks, const int* ranges,
                  const int* terms, int n_blocks, int H, int W, int C, int K,
                  int has_bias, int n_tokens, int vec, void* stream) {
  return launch(x, out, ws, colsum_ws, items, blocks, ranges, terms,
                n_blocks, H, W, C, K, has_bias, n_tokens, vec, stream);
}

int corr_gram_bf16(const __nv_bfloat16* x, float* out, float* ws,
                   float* colsum_ws, const int* items, const int* blocks,
                   const int* ranges, const int* terms, int n_blocks, int H,
                   int W, int C, int K, int has_bias, int n_tokens, int vec,
                   void* stream) {
  return launch(x, out, ws, colsum_ws, items, blocks, ranges, terms,
                n_blocks, H, W, C, K, has_bias, n_tokens, vec, stream);
}

// Resident partial-kernel blocks per SM, for the wrapper's plan.
int corr_gram_blocks_per_sm(int bf16, int vec, int* blocks) {
  return static_cast<int>(bf16 ? blocks_per_sm<__nv_bfloat16>(vec, blocks)
                               : blocks_per_sm<float>(vec, blocks));
}

const char* corr_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
