// The bf16 Gram tile on Hopper's tensor cores (wgmma), shared by the bf16
// kernels of patch_gram.cu and sym_gram.cu.
//
// A block of WGS warpgroups owns one TILE x TILE tile (ti, tj), ti >= tj,
// TILE = 64 * WGS, of the lower triangle of an [F, F] Gram and one
// contiguous token range, and computes
//   G[ti*TILE + m, tj*TILE + n] = sum_k P[k, ti*TILE + m] * P[k, tj*TILE + n]
// with wgmma.m64n{TILE}k16.f32.bf16.bf16, both operands in shared memory:
// warpgroup w takes rows 64w..64w+63. A[m, k] and B[k, n] are [BK tokens x
// TILE features] bf16 operands with the features contiguous (MN-major,
// transpose bits set), stored as WGS slabs of [BK][64] (one 128-byte row
// per token, 128-byte swizzle: 16-byte chunk j of row r at chunk
// j ^ (r % 8)). bf16 x bf16 products are exact in f32 and the sums are
// f32: the function of the f32 kernels and of the Pallas kernels'
// preferred_element_type=f32.
//
// The caller's Gather fills one stage of the ring (A and, off the
// diagonal, B) for the next BK tokens; a diagonal tile gathers once and
// passes the same descriptor as A and B. A ring of STAGES stages keeps
// STAGES - 1 chunks of loads in flight (cp.async, or plain stores for the
// scalar gathers) while the tensor cores work on the current one.
//
// Accumulation runs in the wgmma accumulator over the block's whole token
// range; the wrappers bound that range (MAX_CHAIN_TOKENS in the Python
// wrappers) and the splits are summed in f32 in a fixed order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int BK = 64;                    // tokens per stage
constexpr int ROW_BYTES = 128;            // one token row of 64 bf16
constexpr int SLAB = BK * ROW_BYTES;      // one [BK][64] bf16 slab

template <int WGS>
struct Shape {
  static constexpr int TILE = 64 * WGS;           // output tile edge
  static constexpr int THREADS = 128 * WGS;       // WGS warpgroups
  static constexpr int SLOT = WGS * SLAB;         // one operand of a stage
  static constexpr int STAGE = 2 * SLOT;          // A and B
  static constexpr int STAGES = WGS == 1 ? 4 : 3;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + 1024 alignment
  static constexpr int ACC = TILE / 2;            // f32 accumulators/thread
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; a false `valid` writes 16 zero bytes and reads
// nothing (source size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// makes this thread's shared-memory writes visible to the tensor cores'
// (async proxy) reads that follow the next barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma's fence, commit and wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of one [16 tokens x 64*m features]
// k-step: start address >> 4; leading byte offset (between 64-feature
// swizzle atoms along M/N: the next slab) and stride byte offset (between
// groups of 8 token rows: 8 * 128 bytes), both >> 4; layout 1 = 128-byte
// swizzle. Every slab is 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t lbo = SLAB >> 4, sbo = (8 * ROW_BYTES) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (lbo << 16) |
         (sbo << 32) | (1ull << 62);
}

// D (+)= A * B, bf16 in, f32 accumulate, A and B MN-major
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// ---- layout ---------------------------------------------------------------

// Byte offset of 16-byte chunk j (features 8j..8j+7) of token row r in a
// swizzled [BK][64] bf16 slab.
__device__ __forceinline__ uint32_t swizzled(int r, int j) {
  return r * ROW_BYTES + ((j ^ (r & 7)) << 4);
}

// Where this thread gathers: 16-byte chunk j = t % 8 of token rows
// r0 + 16m, r0 = (t % 128) / 8, of slab t / 128, i.e. features
// 64 * (t / 128) + 8j.. of the tile. A warp covers 4 token rows x 128
// contiguous bytes of each operand.
struct GatherSlot {
  int r0, feature;    // first token row, first feature within the tile
  uint32_t dst;       // byte offset of (r0, chunk) in an operand slot
  __device__ GatherSlot() {
    const int t = threadIdx.x, j = t % 8, slab = t / 128;
    r0 = (t % 128) / 8;
    feature = 64 * slab + 8 * j;
    dst = slab * SLAB + swizzled(r0, j);
  }
};

// Row (within the warpgroup's 64) and column of accumulator i of this
// thread (the wgmma m64nN f32 fragment: warp w of a warpgroup owns rows
// 16w..16w+15).
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x % 128;
  return (t / 32) * 16 + (t % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

// This thread's values of block tile (ti, tj) into the [64][64] lower
// tiles of the workspace of one split (tile (a, b), a >= b, at
// a(a+1)/2 + b, as the f32 kernels write them); 64-tiles above the
// diagonal or past nt64 are dropped.
template <int WGS>
__device__ __forceinline__ void store_subtiles(float* __restrict__ ws,
                                               int ti, int tj, int nt64,
                                               const float (&acc)[32 * WGS]) {
  const int a = ti * WGS + threadIdx.x / 128;
#pragma unroll
  for (int i = 0; i < 32 * WGS; i += 2) {
    const int b = tj * WGS + i / 32;           // acc_col(i) / 64
    if (a < nt64 && b <= a)
      *reinterpret_cast<float2*>(
          &ws[(static_cast<size_t>(a) * (a + 1) / 2 + b) * 4096 +
              acc_row(i) * 64 + acc_col(i) % 64]) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// 1024-byte aligned base of the dynamic shared memory ring
__device__ __forceinline__ uint32_t ring_base(const void* smem) {
  return (smem_addr(smem) + 1023u) & ~1023u;
}

// ---- the tile -------------------------------------------------------------

// Runs the whole token range of one tile: `nchunks` chunks of BK tokens,
// gathered by `gather.load(slot_a, slot_b)` (slot_b == slot_a on the
// diagonal: B is not gathered) in order. On return `acc` holds this
// thread's values of the tile, and, with COLSUM on a diagonal tile,
// threads 0..TILE-1 have written the f32 column sum of feature tid to
// `*csum_out` (where it is not null).
template <int WGS, bool COLSUM, class Gather>
__device__ __forceinline__ void gram_tile(Gather& gather, uint32_t ring,
                                          int nchunks, bool diag,
                                          float (&acc)[32 * WGS],
                                          float* csum_out) {
  using S = Shape<WGS>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < S::ACC; ++i) acc[i] = 0.0f;
  float csum = 0.0f;

  auto slot_a = [&](int c) { return ring + (c % S::STAGES) * S::STAGE; };
  auto slot_b = [&](int c) { return diag ? slot_a(c) : slot_a(c) + S::SLOT; };

#pragma unroll
  for (int c = 0; c < S::STAGES - 1; ++c) {
    if (c < nchunks) gather.load(slot_a(c), slot_b(c));
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<S::STAGES - 2>();  // this thread's copies of chunk c
    fence_proxy_async();
    wgmma_wait_all();                // chunk c-1's products (this warp)
    __syncthreads();                 // chunk c everywhere; slot c-1 free
    if (c + S::STAGES - 1 < nchunks)
      gather.load(slot_a(c + S::STAGES - 1), slot_b(c + S::STAGES - 1));
    cp_async_commit();
    if (COLSUM && diag) {            // ones row/column: f32 column sums
      const int f = tid % S::TILE, r0 = (tid / S::TILE) * (BK / 2);
      const uint32_t col =
          slot_a(c) + (f / 64) * SLAB + ((f % 64) & 7) * 2;
#pragma unroll 8
      for (int r = r0; r < r0 + BK / 2; ++r) {
        unsigned short bits;
        asm volatile("ld.shared.u16 %0, [%1];\n"
                     : "=h"(bits)
                     : "r"(col + swizzled(r, (f % 64) >> 3)));
        csum += __uint_as_float(static_cast<unsigned int>(bits) << 16);
      }
    }
    const uint32_t a = slot_a(c) + (tid / 128) * SLAB, b = slot_b(c);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)          // 16 token rows a k-step
      wgmma(acc, desc(a + k * 16 * ROW_BYTES), desc(b + k * 16 * ROW_BYTES),
            k > 0 || c > 0);
    wgmma_commit();
    fence_acc(acc);
  }
  cp_async_wait<0>();
  wgmma_wait_all();
  fence_acc(acc);
  if (COLSUM && diag) {              // the two token halves, in order
    __shared__ float upper[S::TILE];
    if (tid >= S::TILE) upper[tid - S::TILE] = csum;
    __syncthreads();
    if (tid < S::TILE && csum_out) *csum_out = csum + upper[tid];
  }
}

}  // namespace wg
