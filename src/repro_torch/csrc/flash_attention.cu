// Causal (or full) softmax attention with grouped-query heads, forward pass,
// by an online softmax over key tiles:
//
//   o[b, i, :] = sum_j softmax_j(scale * q[b, i, :] . k[b / G, j, :])
//                      * v[b / G, j, :]
//
// over the keys j < Sk, and j <= i as well when causal (top-left aligned,
// both positions counted from 0). q is (BHq, Sq, Dh) and k, v are
// (BHkv, Sk, Dh), head-major and contiguous; G = BHq / BHkv, so query row b
// reads KV row b / G and K and V are never repeated in memory. Scores,
// running max, denominator and accumulator are f32 whatever the operand
// type; masked scores are -1e30 and the output is acc / max(l, 1e-30), cast
// to the operand type.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel (the TPU
// kernel behind flash_attention_flat).
//
// What bounds it on an H100: 4 * BHq * Dh * (query, key) pairs flops. At the
// qwen3-8b prefill (q (128, 2048, 128) bf16, causal) that is 1.4e11 flops
// against 168 MB of q, k, v and o, so the bound is set by operations: 0.14 ms
// at the bf16 tensor-core peak. bf16 operands therefore run on the tensor
// cores through wgmma (flash_wgmma_kernel: two consumer warpgroups and a TMA
// producer warp around a ring of K/V tiles; the split P makes its work 1.5x
// the bound's). Head dims: the multiples of 16 up to 128.
// f32 operands run on the CUDA cores (flash_fwd_kernel, the 67 TFLOP/s f32
// rate at 700 W), where they keep the f32 parity.
//
// Both kernels: one block per (query row b, query tile) — 64 rows on the
// CUDA cores, 128 on the tensor cores — the longest causal tiles launched
// first; for each key tile up to the diagonal (tiles wholly above it are
// never visited) the scores, then an online softmax with each row's max and
// sum taken by butterfly shuffles among the lanes that hold the row (the
// same value in every lane: no float atomics, a fixed order for every row),
// then the P V product. Keys past Sk and query rows past Sq are masked
// inside the kernel (V past Sk is staged as 0): no padded copy of q, k or v.
//
// flash_fwd_kernel: 256 threads, 64-key tiles; the Q tile staged once in
// shared memory, transposed; K^T staged per tile and every thread forms a
// 4 x 4 block of scores from 16-byte shared-memory reads; the 16 threads that
// share four query rows are one half-warp; the probabilities go through a
// per-warp slice of shared memory to the P V product, for which V replaces
// K^T in the same buffer. Each thread keeps its four rows' running max,
// denominator and Dh/16 output columns in registers.
#include <cstdint>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 256, PAD = 4;
constexpr float kNegInf = -1e30f;

template <int DH>
constexpr int smem_floats() {
  constexpr int kt = DH * (BK + PAD), vt = BK * (DH + PAD);
  return DH * (BQ + PAD) + (kt > vt ? kt : vt) + BK * (BQ + PAD);
}

// Reads W consecutive floats of shared memory, 16 or 8 bytes at a time
// where W allows it.
template <int W>
__device__ __forceinline__ void load_row(const float* src, float (&dst)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int w = 0; w < W; w += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + w);
      dst[w] = t.x; dst[w + 1] = t.y; dst[w + 2] = t.z; dst[w + 3] = t.w;
    }
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) dst[w] = src[w];
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Sk, int group, float scale, int causal) {
  constexpr int W = DH / 16;            // output columns per thread
  constexpr int LDQ = BQ + PAD, LDK = BK + PAD, LDV = DH + PAD,
                LDP = BQ + PAD;
  constexpr int KV = DH * LDK > BK * LDV ? DH * LDK : BK * LDV;
  extern __shared__ __align__(16) float smem[];
  float* QsT = smem;                    // [DH][LDQ]   Q^T of the tile
  float* KVs = QsT + DH * LDQ;          // [DH][LDK] K^T, then [BK][LDV] V
  float* PsT = KVs + KV;                // [BK][LDP]   P^T, 8 columns per warp

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // longest rows first
  const int bh = blockIdx.y;
  const float* qp = q + (size_t)bh * Sq * DH;
  const float* kp = k + (size_t)(bh / group) * Sk * DH;
  const float* vp = v + (size_t)(bh / group) * Sk * DH;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int l = tid; l < BQ * DH; l += kThreads) {
    const int r = l / DH, d = l % DH, row = q0 + r;
    QsT[d * LDQ + r] = row < Sq ? qp[(size_t)row * DH + d] : 0.f;
  }

  float m[4], lsum[4], acc[4][W];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    lsum[i] = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) acc[i][w] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, q_last / BK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();                    // the last tile's V reads are done
    for (int l = tid; l < BK * DH; l += kThreads) {
      const int c = l / DH, d = l % DH, key = k0 + c;
      KVs[d * LDK + c] = key < Sk ? kp[(size_t)key * DH + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a =
          *reinterpret_cast<const float4*>(&QsT[d * LDQ + ty * 4]);
      const float4 b =
          *reinterpret_cast<const float4*>(&KVs[d * LDK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        if (masked) {
          const int key = k0 + tx * 4 + j, row = q0 + ty * 4 + i;
          if (key >= Sk || (causal && key > row)) s[i][j] = kNegInf;
        }
      }

    // Online softmax of the four rows: the 16 lanes of a half-warp hold
    // one row's 64 scores, and the butterflies stay inside the half-warp.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      lsum[i] = lsum[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int w = 0; w < W; ++w) acc[i][w] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&PsT[(tx * 4 + j) * LDP + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    __syncthreads();                    // every read of K^T is done
    for (int l = tid; l < BK * DH; l += kThreads) {
      const int c = l / DH, d = l % DH, key = k0 + c;
      KVs[c * LDV + d] = key < Sk ? vp[(size_t)key * DH + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      const float4 p =
          *reinterpret_cast<const float4*>(&PsT[c * LDP + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      float vv[W];
      load_row<W>(&KVs[c * LDV + tx * W], vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[i][w] = fmaf(pv[i], vv[w], acc[i][w]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(lsum[i], 1e-30f);
    float* op = o + ((size_t)bh * Sq + row) * DH + tx * W;
#pragma unroll
    for (int w = 0; w < W; ++w) op[w] = acc[i][w] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 operands: the same function on Hopper's warpgroup tensor-core
// instructions (wgmma), flash_wgmma_kernel. One block of two warpgroups (256
// threads) per (query row b, 128-row query tile); warpgroup w owns the
// tile's query rows [64 w, 64 w + 64) and keeps their scores, running max,
// denominator and output accumulator in f32 registers. Per 128-key tile:
//   S = Q K^T   wgmma m64n128k16, Q and K both read from shared memory;
//   softmax     in base 2 (exp2f, scale * log2(e) folded into one multiply),
//               a row's max over the 4 lanes of a quad by two shuffles, its
//               sum kept per lane and added across the quad once at the end;
//   O += P V    wgmma m64nDk16 with P from registers (the S accumulator's
//               layout is the A operand's, so P never touches shared memory)
//               and V from shared memory as the MN-major B operand (the
//               transpose flag, so no transposed copy of V is made).
// P enters P V as a bf16 high part plus a bf16 low part (two wgmma each), so
// P keeps about 16 bits instead of bf16's 8 and the product stays near the
// f32 computation of the TPU kernel (1.5x the needed tensor-core work).
//
// Shared memory holds the Q tile and a ring of two K/V stages (164 KB at
// Dh 128: one block an SM), each tile in the 128-byte-swizzled layout that
// wgmma's descriptors read: 64-column slabs of 128-byte rows, 16-byte chunk
// j of row r stored at chunk j ^ (r % 8), so the tensor cores' reads are
// free of bank conflicts. A ninth warp is the producer: one of its threads
// fills the ring by TMA (cp.async.bulk.tensor), each stage's copies
// completing on that stage's "full" mbarrier, and refills a stage once all
// 256 consumer threads have arrived on its "empty" mbarrier. So tile t + 1
// is in flight while tile t is computed, and the two warpgroups are tied to
// each other only through the ring: one may run a tile ahead, its softmax
// overlapping the other's wgmma. (With the copies issued by the consumers
// themselves, a __syncthreads a tile held the warpgroups in step, both in
// softmax at once with the tensor cores idle: 1.3x this kernel's time at
// the qwen3-8b prefill shape; see PERF.md.) q, k and v
// are described as 3-D (heads, rows, Dh) tensor maps, so a box that runs
// past Sq or Sk reads zeros rather than the next head's rows, and the
// 64-column boxes zero-fill the columns past Dh: GQA and ragged lengths need
// no padded copy. A row is DP = Dh rounded up to 64 or 128 columns in shared
// memory (one or two slabs), so a head dim that is a multiple of 16 but not
// of 64 (16 to 48, 80 to 112) runs the DP kernel on zero columns: the work,
// the registers and the shared memory of Dh = DP, and exact, since the zero
// columns add nothing to Q K^T and produce output columns that are never
// stored. The kernel is compiled once a DP, Dh a run-time argument. The
// maps are built on the host for
// each call (cuTensorMapEncodeTiled) and passed as __grid_constant__
// parameters. No setmaxnreg: a thread may hold 168 registers (288 threads
// put three warps on one of the SM's four 16,384-register sub-partitions)
// and the kernel fits in them without spilling.
constexpr int kConsumers = 256, kWgThreads = kConsumers + 32;
constexpr int WBQ = 128, WBK = 128, kStages = 2;

// The row width in shared memory of head dim DH: 64 or 128 columns.
template <int DH>
constexpr int wg_width() {
  return DH <= 64 ? 64 : 128;
}

template <int DP>
struct WgTile {
  static_assert(DP == 64 || DP == 128, "one or two 64-column slabs");
  static constexpr int kQ = WBQ * DP * 2;           // bytes of the Q tile
  static constexpr int kKV = WBK * DP * 2;          // bytes of one K or V tile
  static constexpr int kBars = 8 * (1 + 2 * kStages);   // the mbarriers
  // + 1,024: the swizzle pattern repeats every 1,024 bytes, so the tiles
  // start 1,024-aligned inside the dynamic shared memory
  static constexpr int kBytes = kQ + kStages * 2 * kKV + kBars + 1024;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x0, x1) = hi + lo with hi and lo bf16 pairs: |x - hi - lo| <= 2^-18 |x|.
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// One arrival that also expects `bytes` of copies to land on the barrier.
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// A 64-column x 128-row x 1-head box of a 3-D tensor map into shared memory
// at dst (1,024-aligned; the map's 128-byte swizzle gives the layout wgmma
// reads), completing on barrier bar. Coordinates: column, row, head.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         unsigned bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(row), "r"(head)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address addr:
// 8-row groups 1,024 bytes apart (stride byte offset); lbo is the leading
// byte offset, the distance between 64-column slabs of an MN-major operand
// (unused by a K-major one, whose 16-deep slice lies inside one 128-byte row).
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr, unsigned lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of a wgmma accumulator
// across the asynchronous instructions that own it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(b)                                                           \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),              \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x 128, f32) (+)= A B^T over 16 of the K axis: A (64 x 16) and
// B (128 x 16) both K-major in shared memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x N, f32) += A B over 16 of the K axis: A (64 x 16 bf16) from
// registers in the accumulator's row layout, B (16 x N) MN-major in shared
// memory (transpose flag 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef WG_D8

template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ o, int Sq, int Sk, int dh,
                   int group, float scale_log2, int causal) {
  using L = WgTile<DP>;
  constexpr int NS = WBK / 8, NO = DP / 8, SLABS = DP / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const unsigned sKV = sQ + L::kQ;            // stage s: K, then V
  const unsigned full_q = sKV + kStages * 2 * L::kKV;
  const unsigned full0 = full_q + 8, empty0 = full0 + 8 * kStages;

  const int nq = (Sq + WBQ - 1) / WBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * WBQ;  // longest rows first
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int q_last = min(q0 + WBQ, Sq) - 1;
  int n_tiles = (Sk + WBK - 1) / WBK;
  if (causal) n_tiles = min(n_tiles, q_last / WBK + 1);

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer warp: one thread keeps the ring full with TMA copies.
    if (tid == kConsumers) {
      mbar_expect_tx(full_q, L::kQ);
      for (int sl = 0; sl < SLABS; ++sl)
        tma_load(sQ + sl * (WBQ * 128), &map_q, full_q, sl * 64, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty0 + 8 * s, (t / kStages - 1) & 1);
        const unsigned kb = sKV + s * 2 * L::kKV, bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * L::kKV);
        for (int sl = 0; sl < SLABS; ++sl) {
          tma_load(kb + sl * (WBK * 128), &map_k, bar, sl * 64, t * WBK,
                   bh / group);
          tma_load(kb + L::kKV + sl * (WBK * 128), &map_v, bar, sl * 64,
                   t * WBK, bh / group);
        }
      }
    }
    return;
  }

  // The two consumer warpgroups.
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int row0 = q0 + wg * 64 + warp * 16 + g;    // rows row0, row0 + 8

  float acc[DP / 2], m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const unsigned qa = sQ + wg * 64 * 128;           // this warpgroup's rows
  mbar_wait(full_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * WBK, stage = t % kStages;
    mbar_wait(full0 + 8 * stage, (t / kStages) & 1);  // tile t has landed
    const unsigned sK = sKV + stage * 2 * L::kKV, sV = sK + L::kKV;

    float s[WBK / 2];
#pragma unroll
    for (int i = 0; i < WBK / 2; ++i) s[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const unsigned slab = (kk >> 2), off = (kk & 3) * 32;
      wgmma_ss_n128(s, sw128_desc(qa + slab * (WBQ * 128) + off, 16),
                    sw128_desc(sK + slab * (WBK * 128) + off, 16), kk > 0);
    }
    wg_commit_wait();
    fence_regs(s);

    const bool masked = k0 + WBK > Sk || (causal && k0 + WBK - 1 > row0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= Sk || (causal && key > row)) x = kNegInf;
        }
        s[4 * j + e] = x;
      }

    // Online softmax of rows row0 (h = 0) and row0 + 8 (h = 1): each lane
    // of a quad holds 32 of a row's 128 scores.
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = exp2f(m[h] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[4 * j + 2 * h] = exp2f(s[4 * j + 2 * h] - m_new);
        s[4 * j + 2 * h + 1] = exp2f(s[4 * j + 2 * h + 1] - m_new);
        ps += s[4 * j + 2 * h] + s[4 * j + 2 * h + 1];
      }
      lsum[h] = lsum[h] * corr[h] + ps;
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }

    // acc += P V over the tile's keys, 16 at a time: the scores of two
    // adjacent 8-key chunks are the A fragment of 16 keys. Every fragment is
    // written before the fence that orders register writes before wgmma.
    unsigned ph[WBK / 16][4], pl[WBK / 16][4];
#pragma unroll
    for (int kc = 0; kc < WBK / 16; ++kc) {
      split_bf16(s[8 * kc], s[8 * kc + 1], ph[kc][0], pl[kc][0]);
      split_bf16(s[8 * kc + 2], s[8 * kc + 3], ph[kc][1], pl[kc][1]);
      split_bf16(s[8 * kc + 4], s[8 * kc + 5], ph[kc][2], pl[kc][2]);
      split_bf16(s[8 * kc + 6], s[8 * kc + 7], ph[kc][3], pl[kc][3]);
    }
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < WBK / 16; ++kc) {
      const uint64_t vb = sw128_desc(sV + kc * 16 * 128, WBK * 128);
      wgmma_rs(acc, ph[kc], vb);
      wgmma_rs(acc, pl[kc], vb);
    }
    wg_commit_wait();
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * stage);    // this thread is done with the stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = lsum[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + h * 8;
    if (row >= Sq) continue;
    const float denom = fmaxf(l, 1e-30f);
    __nv_bfloat16* op = o + ((size_t)bh * Sq + row) * dh + tq * 2;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      if (8 * j < dh)
        *reinterpret_cast<__nv_bfloat162*>(op + j * 8) = __floats2bfloat162_rn(
            acc[4 * j + 2 * h] / denom, acc[4 * j + 2 * h + 1] / denom);
  }
}

// Raises a kernel's dynamic shared memory limit to `bytes`, once.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static const cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return e;
}

// f32 operands: the CUDA-core kernel.
template <int DH>
int launch_dh(const float* q, const float* k, const float* v, float* o,
              int bh, int sq, int sk, int group, float scale, int causal,
              cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  const cudaError_t e = allow_smem<flash_fwd_kernel<DH>>(bytes);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_kernel<DH><<<dim3((sq + BQ - 1) / BQ, bh), kThreads, bytes,
                         stream>>>(q, k, v, o, sq, sk, group, scale, causal);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link to the driver library.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }();
  return fn;
}

// The (heads, rows, dh) bf16 tensor at base as a 3-D map of 64-column x
// 128-row x 1-head boxes with the 128-byte swizzle. Being 3-D, a box that
// runs past `rows` (or past dh, for dh < 64) reads zeros, not the next
// head's rows.
bool encode_map(CUtensorMap* map, const void* base, int dh, int rows,
                int heads) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)rows * dh * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)WBQ, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 operands: the wgmma kernel, its three tensor maps built here.
template <int DH>
int launch_dh(const __nv_bfloat16* q, const __nv_bfloat16* k,
              const __nv_bfloat16* v, __nv_bfloat16* o, int bh, int sq,
              int sk, int group, float scale, int causal,
              cudaStream_t stream) {
  constexpr int DP = wg_width<DH>(), bytes = WgTile<DP>::kBytes;
  const cudaError_t e = allow_smem<flash_wgmma_kernel<DP>>(bytes);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, DH, sq, bh) ||
      !encode_map(&mk, k, DH, sk, bh / group) ||
      !encode_map(&mv, v, DH, sk, bh / group))
    return (int)cudaErrorInvalidValue;
  flash_wgmma_kernel<DP><<<dim3((sq + WBQ - 1) / WBQ, bh), kWgThreads, bytes,
                           stream>>>(mq, mk, mv, o, sq, sk, DH, group,
                                     scale * 1.4426950408889634f,  // log2(e)
                                     causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int dh, int group, float scale, int causal,
           void* stream) {
#define FLASH_DH(D)                                                       \
  case D:                                                                 \
    return launch_dh<D>(static_cast<const T*>(q), static_cast<const T*>(k), \
                        static_cast<const T*>(v), static_cast<T*>(o), bh,   \
                        sq, sk, group, scale, causal,                       \
                        static_cast<cudaStream_t>(stream))
  switch (dh) {
    FLASH_DH(16);
    FLASH_DH(32);
    FLASH_DH(48);
    FLASH_DH(64);
    FLASH_DH(80);
    FLASH_DH(96);
    FLASH_DH(112);
    FLASH_DH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_DH
}

}  // namespace

// q (bh, sq, dh), k and v (bh / group, sk, dh), o (bh, sq, dh), all
// contiguous; dh a multiple of 16 up to 128. One kernel launch. Returns
// cudaGetLastError() (cudaErrorInvalidValue for another dh).
#define FLASH_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,  \
                      int bh, int sq, int sk, int dh, int group, float scale, \
                      int causal, void* stream) {                             \
    return launch<T>(q, k, v, o, bh, sq, sk, dh, group, scale, causal,       \
                     stream);                                                 \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)
