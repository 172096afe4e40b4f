// The f32 Gram tile on Hopper's tensor cores, as 3xTF32 products, with two
// ways to fill its operands: gram_tile (a transposing register gather; the
// f32 kernel of patch_gram.cu) and presplit_tile (bulk copies of operands
// a pre-pass split and laid out once; sym_gram.cu's f32 kernel).
//
// A block of WGS warpgroups owns one TILE x TILE tile (ti, tj), ti >= tj,
// TILE = 64 * WGS, of the lower triangle of an [F, F] Gram and one
// contiguous token range, and computes
//   G[ti*TILE + m, tj*TILE + n] = sum_k P[k, ti*TILE + m] * P[k, tj*TILE + n]
// for f32 P with wgmma.m64n{TILE}k8.f32.tf32.tf32: warpgroup w takes rows
// 64w..64w+63. One TF32 product keeps 11 significant bits of each operand,
// and the tensor cores truncate the low 13 bits of an f32 operand: an error
// of up to ~1e-3 relative, biased toward zero, out of reach of the JAX
// tests' bar of 1e-4 of max|G|. So every value x is split into hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest (ties away) by cvt.rna, and
// the three products lo*hi + hi*lo + hi*hi go into one f32 accumulator,
// the small ones first: hi + lo holds x to ~2^-22, and the dropped lo*lo
// is below 2^-22 of the product. That is three products a k-step, so the
// bound is 3x the work at the dense TF32 rate (495 TFLOP/s): still 2.5x
// below the strict FP32 FMA bound (67 TFLOP/s).
//
// tf32 wgmma takes no transpose bits: both operands are K-major, K being
// the token axis. Each operand half (hi or lo) is TILE rows of one feature
// x BK = 32 tokens, 128 bytes a row, 128-byte swizzled (16-byte chunk j of
// row r at chunk j ^ (r % 8)), in 1024-byte aligned slabs of 64 rows (one
// warpgroup's A). A k-step (8 tokens, 32 bytes of each row) advances the
// descriptor's start address by 32 bytes inside the swizzle atom; groups
// of 8 rows are 1,024 bytes apart (stride byte offset).
//
// gram_tile: the patch matrix exists only as the gather makes it, so the
// transpose and the split happen per tile, and a transposing gather cannot
// be a cp.async: operands pass through registers. The caller's Gather has
// fetch(), which starts the global loads of its next chunk into registers,
// and store(slots), which splits them and writes one stage's hi and lo
// slabs (A and, off the diagonal, B; a diagonal tile passes A's slabs as
// B). While the tensor cores work on chunk c, the threads store chunk
// c + 1 and start the loads of chunk c + 2. The proxy fence that hands the
// stores to the tensor cores waits for the thread's loads in flight, so it
// comes between the stores and the next loads. This gather (loads, split,
// transposed 16-byte stores), not the tensor cores, bounds that kernel.
// presplit_tile removes it where the operand is a plain matrix (below).
// PERF.md has the measurements of both.
//
// The tensor cores add each instruction's 8 products into the f32
// accumulator with truncation, not rounding to nearest: an error biased to
// one side that grows with the number of instructions summed into one
// accumulator (3 per 8 tokens here, against 1 per 16 in bf16). So the
// accumulator is flushed into an f32 register total every FLUSH chunks
// (the next chunk's first product overwrites it), and the total sums the
// flushes in order, rounding to nearest. The wrappers still bound a block's
// token range (MAX_CHAIN_TOKENS in the Python wrappers); the splits are
// summed in f32 in a fixed order.
#pragma once

#include "wgmma_gram.cuh"

namespace tf {

constexpr int BK = 32;                    // tokens per stage: one 128-byte row
constexpr int ROW_BYTES = 128;            // one feature row of 32 f32
constexpr int SLAB = 64 * ROW_BYTES;      // 64 feature rows
constexpr int FLUSH = 4;                  // chunks a flush: 48 instructions

template <int WGS>
struct Shape {
  static constexpr int TILE = 64 * WGS;           // output tile edge
  static constexpr int THREADS = 128 * WGS;       // WGS warpgroups
  static constexpr int HALF = WGS * SLAB;         // the hi or lo of an operand
  static constexpr int STAGE = 4 * HALF;          // A hi, A lo, B hi, B lo
  static constexpr int STAGES = 2;                // 3: no faster (PERF.md)
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + 1024 alignment
  static constexpr int ACC = TILE / 2;            // f32 accumulators/thread
};

// Shared-memory byte addresses of one stage's four operand halves.
struct Slots {
  uint32_t a_hi, a_lo, b_hi, b_lo;
};

// Byte offset of 16-byte chunk j (tokens 4j..4j+3) of feature row r.
__device__ __forceinline__ uint32_t swizzled(int r, int j) {
  return r * ROW_BYTES + ((j ^ (r & 7)) << 4);
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, with the low 13 bits cleared.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// Splits 4 values into their hi and lo halves and writes each as one
// 16-byte chunk.
__device__ __forceinline__ void store_split(uint32_t hi_dst, uint32_t lo_dst,
                                            const float (&v)[4]) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = tf32_rna(v[e]);
    lo[e] = tf32_rna(v[e] - __uint_as_float(hi[e]));   // exact difference
  }
  wg::st_shared16(hi_dst, make_uint4(hi[0], hi[1], hi[2], hi[3]));
  wg::st_shared16(lo_dst, make_uint4(lo[0], lo[1], lo[2], lo[3]));
}

// Shared-memory matrix descriptor of one K-major [8 tokens x 64*m features]
// k-step: start address >> 4; leading byte offset unused by a swizzled
// K-major operand (1); stride byte offset between groups of 8 feature rows
// (8 * 128 bytes) >> 4; layout 1 = 128-byte swizzle. Every slab is
// 1024-byte aligned and a k-step moves less than a row, so the base offset
// is 0.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t lbo = 1, sbo = (8 * ROW_BYTES) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (lbo << 16) |
         (sbo << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (+)= A * B, tf32 in, f32 accumulate, A and B K-major
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
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
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
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

// Runs the whole token range of one tile: `nchunks` chunks of BK tokens,
// gathered in order by `gather.fetch()` and `gather.store(slots)`. On
// return `acc` holds this thread's values of the tile (wg::acc_row and
// wg::acc_col say where; wg::store_subtiles writes them out).
template <int WGS, class Gather>
__device__ __forceinline__ void gram_tile(Gather& gather, uint32_t ring,
                                          int nchunks, bool diag,
                                          float (&acc)[32 * WGS]) {
  using S = Shape<WGS>;
  float part[S::ACC];                // the tensor cores' accumulator
#pragma unroll
  for (int i = 0; i < S::ACC; ++i) acc[i] = part[i] = 0.0f;

  auto slots = [&](int c) {
    const uint32_t a = ring + (c % S::STAGES) * S::STAGE;
    const uint32_t b = diag ? a : a + 2 * S::HALF;
    return Slots{a, a + S::HALF, b, b + S::HALF};
  };

  if (nchunks > 0) {
    gather.fetch();
    gather.store(slots(0));
    wg::fence_proxy_async();         // the stores, for the tensor cores
  }
  if (nchunks > 1) gather.fetch();
  for (int c = 0; c < nchunks; ++c) {
    const bool fresh = c % FLUSH == 0;
    if (fresh) {                     // all products so far, into the total
      wgmma_wait<0>();
      wg::fence_acc(part);
#pragma unroll
      for (int i = 0; i < S::ACC; ++i) acc[i] += part[i];
    } else {                         // chunk c+1-STAGES's (this warpgroup)
      wgmma_wait<S::STAGES - 2>();
    }
    __syncthreads();                 // chunk c everywhere; stage c+1 free
    const Slots s = slots(c);
    const uint32_t wa = (threadIdx.x / 128) * SLAB;   // this warpgroup's A
    const uint64_t a_hi = desc(s.a_hi + wa), a_lo = desc(s.a_lo + wa);
    const uint64_t b_hi = desc(s.b_hi), b_lo = desc(s.b_lo);
    wg::fence_acc(part);
    wg::wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 8; ++k) {  // 8 tokens (32 bytes) a k-step: the
      const uint64_t o = 2 * k;         // start address field counts 16 bytes
      wgmma(part, a_lo + o, b_hi + o, k > 0 || !fresh);
      wgmma(part, a_hi + o, b_lo + o, 1);
      wgmma(part, a_hi + o, b_hi + o, 1);
    }
    wg::wgmma_commit();
    wg::fence_acc(part);
    if (c + 1 < nchunks) {           // under this chunk's products
      gather.store(slots(c + 1));
      wg::fence_proxy_async();       // before new loads: it waits for them
      if (c + 2 < nchunks) gather.fetch();
    }
  }
  wgmma_wait<0>();
  wg::fence_acc(part);
#pragma unroll
  for (int i = 0; i < S::ACC; ++i) acc[i] += part[i];
}

// ---- pre-split operands ---------------------------------------------------
//
// Where the operand is a plain [N, F] matrix (sym_gram.cu), the transpose
// and the split are done once, by a pre-pass, and not once per tile: it
// writes the hi and lo halves as grids of ready-made slabs, [token chunk]
// [64-feature block], SLAB bytes each, already swizzled as desc() reads
// them (feature row r, tokens 4j..4j+3 at swizzled(r, j)) and zero past N
// and F. A stage is then WGS contiguous slabs per operand half, one bulk
// copy each (the swizzle carries through a straight copy), and the loop
// does no per-value work.

// The ring of the pre-split loop: STAGES stages of Shape<WGS>::STAGE.
template <int WGS, int STAGES_>
struct Ring : Shape<WGS> {
  static constexpr int STAGES = STAGES_;
  static constexpr int SMEM = STAGES * Shape<WGS>::STAGE + 1024;
};

// One tile's operands in the pre-split buffers: the byte offsets of A's
// and B's first slab in the block's first chunk, and the bytes from one
// chunk to the next.
struct Presplit {
  const char* hi;
  const char* lo;
  size_t a, b, chunk;
};

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// `bytes` global -> shared in one bulk copy (async proxy), completing on
// the mbarrier at bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Chunk c's operand halves (A and, off the diagonal, B) as bulk copies of
// HALF bytes each, issued by thread 0, completing on the stage's mbarrier.
template <int WGS>
__device__ __forceinline__ void bulk_stage(const Presplit& p, int c,
                                           const Slots& s, bool diag,
                                           uint32_t bar) {
  using S = Shape<WGS>;
  if (threadIdx.x != 0) return;
  const size_t a = p.a + c * p.chunk, b = p.b + c * p.chunk;
  mbar_expect_tx(bar, (diag ? 2 : 4) * S::HALF);
  bulk_copy(s.a_hi, p.hi + a, S::HALF, bar);
  bulk_copy(s.a_lo, p.lo + a, S::HALF, bar);
  if (diag) return;
  bulk_copy(s.b_hi, p.hi + b, S::HALF, bar);
  bulk_copy(s.b_lo, p.lo + b, S::HALF, bar);
}

// Runs the whole token range of one tile from pre-split operands:
// `nchunks` chunks of BK tokens from p. A ring of STAGES stages, each on
// its mbarrier, keeps STAGES - 1 chunks of bulk copies in flight while the
// tensor cores work on the current one (a stage is refilled once both
// warpgroups are done with its products: with one chunk of copies in
// flight, the copies' latency showed; PERF.md). The products, their order
// and the flush into the f32 total are gram_tile's. On return `acc` holds
// this thread's values of the tile (wg::acc_row, wg::acc_col).
template <int WGS, int STAGES>
__device__ __forceinline__ void presplit_tile(const Presplit& p, uint32_t ring,
                                              int nchunks, bool diag,
                                              float (&acc)[32 * WGS]) {
  using S = Shape<WGS>;
  __shared__ __align__(8) uint64_t bars[STAGES];
  const uint32_t bar0 = wg::smem_addr(bars);
  float part[S::ACC];                // the tensor cores' accumulator
#pragma unroll
  for (int i = 0; i < S::ACC; ++i) acc[i] = part[i] = 0.0f;

  auto fill = [&](int c) {
    const uint32_t a = ring + (c % STAGES) * S::STAGE;
    const uint32_t b = diag ? a : a + 2 * S::HALF;
    bulk_stage<WGS>(p, c, Slots{a, a + S::HALF, b, b + S::HALF}, diag,
                    bar0 + 8 * (c % STAGES));
  };

  if (threadIdx.x < STAGES) mbar_init(bar0 + 8 * threadIdx.x);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c)
    if (c < nchunks) fill(c);
  for (int c = 0; c < nchunks; ++c) {
    const bool fresh = c % FLUSH == 0;
    mbar_wait(bar0 + 8 * (c % STAGES), (c / STAGES) & 1);   // chunk c's copies
    wgmma_wait<0>();                 // chunk c-1's products (this warpgroup)
    wg::fence_acc(part);
    if (fresh) {                     // all products so far, into the total
#pragma unroll
      for (int i = 0; i < S::ACC; ++i) acc[i] += part[i];
    }
    __syncthreads();                 // stage c-1 free in both warpgroups
    const uint32_t a = ring + (c % STAGES) * S::STAGE;
    const uint32_t b = diag ? a : a + 2 * S::HALF;
    const uint32_t wa = (threadIdx.x / 128) * SLAB;   // this warpgroup's A
    const uint64_t a_hi = desc(a + wa), a_lo = desc(a + S::HALF + wa);
    const uint64_t b_hi = desc(b), b_lo = desc(b + S::HALF);
    wg::fence_acc(part);
    wg::wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 8; ++k) {
      const uint64_t o = 2 * k;
      wgmma(part, a_lo + o, b_hi + o, k > 0 || !fresh);
      wgmma(part, a_hi + o, b_lo + o, 1);
      wgmma(part, a_hi + o, b_hi + o, 1);
    }
    wg::wgmma_commit();
    wg::fence_acc(part);
    if (c + STAGES - 1 < nchunks)    // into stage c-1, under these products
      fill(c + STAGES - 1);
  }
  wgmma_wait<0>();
  wg::fence_acc(part);
#pragma unroll
  for (int i = 0; i < S::ACC; ++i) acc[i] += part[i];
}

}  // namespace tf
