// Per-feature-block matrix-vector products of the feature-split sub-solver
// (the paper's Algorithm 2), with f32 accumulation, reading A in place:
//
//   block_matvec:  out[z, j, i, k] = sum_{c < w_j} A[z, i, j nb + c] X[z, j, c, k]
//   block_rmatvec: out[z, j, c, k] = sum_i A[z, i, j nb + c] Y[z, j, i, k]
//                  for c < w_j, and 0 for the padded rows c >= w_j
//
// A is the node data (N, m, n) row-major in f32, bf16 or fp16 (widened to f32
// exactly as it loads: csrc/elem.cuh), never copied or padded. Block j is
// the columns [j nb, j nb + w_j) with nb = ceil(n / M) and
// w_j = max(0, min(nb, n - j nb)). X is (N, M, nb, K), Y is (N, M, m, K),
// out is (N, M, m, K) or (N, M, nb, K), all f32 and contiguous, whatever A
// holds. Entries of X past w_j are the zero padding of the JAX layout and
// are not read.
//
// Replaces: src/repro/kernels/ops.py:115,126, the "block_matvec" /
// "block_rmatvec" rows (jax.vmap of src/repro/kernels/matvec.py's
// _mv_kernel :95 / _rmv_kernel :135 over the padded (M, m, nb) block copy
// that core/subsolver.py makes of A).
//
// What bounds it on an H100: each product reads A once and does 2 K flops
// per element, so at K = 1 and K = 3 it is bound by memory: N m n elements
// of 4 (or 2) bytes at 3.35 TB/s. At the paper's Fig. 3 point (N = 8,
// m = 25,000, n = 4,000) A is 3.2 GB in f32 (0.955 ms at the bound), 1.6 GB
// in bf16 (0.478 ms); a sharded rank's bf16 block (1, 25,000, 1,000) is
// 50 MB, 0.0150 ms (and the size of L2), sharded_fp16's (1, 25,000, 4,000)
// 200 MB, 0.0597 ms. A blocked copy would cost a second A of device memory
// and a pass over it, which is why the kernels index A's own layout.
//
// Two designs, chosen by kernels/block_matvec.py's block_plan:
//
// The stream route (bf16 / fp16 A with n % 8 == 0, nb % 8 == 0, A 16-byte
// aligned, so every 16-byte chunk of a row lies in exactly one block and
// its block, and the X / Y it pairs with, are fixed for the whole kernel):
// block_stream_mv_kernel and block_stream_rmv_kernel. They replace the
// earlier half-width kernels, which gave a warp one short row segment (3,125
// CTAs of 8 rows at (1, 25,000, 1,000), X re-read for every row, strided
// scalar X at K > 1) and a thread 8 columns of 196 row slices (half the
// threads idle at nb = 1,000) summed by a 4-CTA second kernel. Here:
// * A persistent grid: each node gets `ctas` CTAs (the SM count over N), CTA
//   c the node's R-row tiles c, c + ctas, c + 2 ctas, ..., so the CTAs
//   sweep the node's rows together (with a contiguous range a CTA, the
//   CTAs' loops ended up to 22 % apart at (1, 25,000, 4,000):
//   tools/block_matvec_probe.py --trace). A tile is R n contiguous elements
//   of A, fetched by ONE cp.async.bulk with the L2 policy evict_first (A is
//   read once a call and is the size of L2) into a stage of a
//   shared-memory ring; a tile starts at a multiple of R rows, so at the
//   path shapes on a 128-byte boundary (ranges split to the row, on 16-byte
//   boundaries, measured slower). A producer warp fills the stages; each
//   stage has a full mbarrier (the copy landed; block_rmatvec's stage also
//   holds the tile's Y values, R x M' x kc floats with M' the non-empty
//   blocks, copied by the producer's cp.asyncs arriving on it) and an empty
//   one (every consumer warp released it). No CTA-wide barrier runs per tile: a first
//   design with one, where thread 0 refilled the ring and one thread a row
//   added the warps' partials, spent each tile on that thread's serial work
//   (tools/block_matvec_probe.py --trace; PERF.md).
// * block_matvec: 16 consumer warps. A tile's R M items (row, block) go to
//   the warps round-robin; a warp forms an item's whole dot product, lane l
//   taking the block's chunks l, l + 32, ..., so the reduction is one
//   shuffle tree and lane 0 writes the output: no cross-warp combine. X is
//   read once a pass: in registers (a lane's chunks of its fixed block,
//   where M divides 16 and the chunks x kc fit kMaxChunkRhs) or staged in
//   shared memory. Every warp waits for and releases every tile, so with
//   fewer items a tile than warps the warps work on several tiles at once.
// * block_rmatvec: groups of warps, each lane owning VPT 16-byte chunks of a
//   block and their column partials (8 kc floats a chunk) in registers over
//   all its group's rows (a narrow row, n = 1,000's 125 chunks, still fills
//   the CTA: 4 groups of 4 warps). At the end the CTA adds its groups'
//   partials in group order and block_sum_kernel, launched as a
//   programmatic dependent so its launch overlaps the stream kernel's run,
//   adds the CTAs' partials. With one CTA a node the stream kernel writes
//   out itself.
// * More than kc right-hand sides: the stream kernel runs once a pass of kc.
//
// Summation order of the stream route (fixed by the shape and the plan; no
// float atomics, so two calls agree bit for bit):
// * block_matvec out[z, j, i, k]: each lane sums its chunks l, l + 32, ...
//   in order, each chunk's 8 products in column order, into one
//   accumulator from zero (fmaf); the warp adds its lanes with the
//   shuffle-down tree 16, 8, 4, 2, 1.
// * block_rmatvec out[z, j, c, k]: group g sums its rows (g, g + G, ... of
//   each tile, the CTA's tiles c, c + ctas, ... in order) in that order
//   from zero (fmaf(A, y, acc));
//   the CTA adds groups 0 .. G - 1 in order, from group 0's partial;
//   block_sum_kernel adds the CTAs' partials in kSumRuns runs of
//   ceil(ctas / kSumRuns) consecutive CTAs, each run in CTA order from
//   zero, then the runs in order from run 0's sum.
//
// The scalar route (everything else: f32 A, and bf16 / fp16 A with odd n, a
// ragged nb, A off a 16-byte boundary, more than kStreamWarps non-empty
// blocks for block_rmatvec or a row past the register and shared-memory
// budgets), the first kernels of this file:
// * block_matvec_kernel: one warp per (row, block) segment of a row, the
//   block and node indices in the grid (one launch for all N M products).
//   16-byte loads of A when the segment starts 16-byte aligned (of X too
//   when K == 1 and its block is aligned), with a scalar tail; scalar loads
//   otherwise. K is handled four right-hand sides per pass with the
//   accumulators in registers; X stays in L1/L2.
// * block_rmatvec_kernel: one thread per column of a block, so a warp reads
//   32 neighbouring words of a row (coalesced). Rows are split into slices
//   across blockIdx.y (the wrapper's rows_per_slice: about kTargetCtas
//   blocks in flight, each slice at least kRows rows long); a slice stages
//   kRows rows of its block's Y at a time in shared memory. Each slice
//   writes its own partial and sum_slices adds the partials in slice order:
//   deterministic, no float atomics. With one slice the first kernel writes
//   the output directly.
// The f32 instantiations are these kernels unchanged: the same sums in
// the same order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk.cuh"
#include "elem.cuh"

namespace {

constexpr int kWarps = 8;           // segments per block_matvec block
constexpr int kCols = 256;          // threads per block_rmatvec block
constexpr int kRows = 128;          // rows of Y staged in shared memory
constexpr int kKc = 4;              // right-hand sides per pass
constexpr int kTargetCtas = 2048;   // block_rmatvec blocks to aim for

// the stream route
constexpr int kStreamWarps = 16;    // consumer warps of a stream CTA (most)
constexpr int kMaxVpt = 4;          // rmatvec: 16-byte chunks a lane owns
constexpr int kMaxKc = 4;           // right-hand sides a pass
constexpr int kMaxChunkRhs = 4;     // rmatvec: most VPT x kc (registers)
constexpr int kMaxGroupRows = 4;    // rmatvec: rows a group takes in a tile
constexpr int kMaxXBytes = 65536;   // matvec: a pass's X in shared memory
constexpr int kMaxStages = 16;      // stages of the ring
constexpr int kRingBytes = 204800;  // shared memory of the ring (and X)
constexpr int kSumCols = 32;        // outputs a block_sum_kernel CTA adds
constexpr int kSumRuns = 8;         // runs of CTA partials it adds apart
constexpr int kSumThreads = kSumCols * kSumRuns;

// shared memory of a stream CTA: the stages' full and empty mbarriers,
// then (block_matvec) the pass's X and the ring, 16-byte aligned as
// cp.async.bulk needs; block_rmatvec reuses the ring for its groups'
// partials at the end
constexpr int kBarBytes = 2 * 8 * kMaxStages;
constexpr int kSmemBytes = kBarBytes + kRingBytes;
static_assert(kBarBytes % 16 == 0, "ring alignment");

__device__ __forceinline__ int block_width(int n, int nb, int j) {
  return max(0, min(nb, n - j * nb));
}

// A barrier of the stream kernel's consumer warps only (the producer warp
// runs on): named barrier 1 over `threads` threads.
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
block_matvec_kernel(const typename Elem<T>::S* __restrict__ A,
                    const float* __restrict__ X, float* __restrict__ out,
                    int M, int m, int n, int nb, int K) {
  using S = typename Elem<T>::S;
  using V = typename Elem<T>::V16;
  constexpr int E = Elem<T>::kPer16;   // elements of A a 16-byte load
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  const int j = blockIdx.y, z = blockIdx.z;
  if (row >= m) return;  // uniform across the warp
  const int w = block_width(n, nb, j);
  const S* a = A + ((size_t)z * m + row) * n + (size_t)j * nb;
  const float* x = X + ((size_t)z * M + j) * nb * K;
  float* o = out + (((size_t)z * M + j) * m + row) * K;
  const bool a_vec = (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool x_vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int wv = w / E;
  for (int k0 = 0; k0 < K; k0 += kKc) {
    const int kc = min(kKc, K - k0);
    float acc[kKc] = {0.f, 0.f, 0.f, 0.f};
    if (a_vec && x_vec && K == 1) {
      const V* av4 = reinterpret_cast<const V*>(a);
      const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
      for (int c = lane; c < wv; c += 32) {
        const V av = av4[c];
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 xv = x4[c * (E / 4) + e / 4];
          acc[0] = fmaf(elem<T>(av, e), xv.x, acc[0]);
          acc[1] = fmaf(elem<T>(av, e + 1), xv.y, acc[1]);
          acc[2] = fmaf(elem<T>(av, e + 2), xv.z, acc[2]);
          acc[3] = fmaf(elem<T>(av, e + 3), xv.w, acc[3]);
        }
      }
      for (int c = E * wv + lane; c < w; c += 32)
        acc[0] = fmaf(elem<T>(a[c], 0), x[c], acc[0]);
      acc[0] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      acc[1] = acc[2] = acc[3] = 0.f;
    } else if (a_vec) {  // K > 1: 16-byte loads of A, X from L1/L2
      const V* av4 = reinterpret_cast<const V*>(a);
#pragma unroll 2
      for (int cv = lane; cv < wv; cv += 32) {
        const V av = av4[cv];
        const float* xc = x + (size_t)(E * cv) * K + k0;
        for (int q = 0; q < kc; ++q) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[q] = fmaf(elem<T>(av, e), xc[e * K + q], acc[q]);
        }
      }
      for (int c = E * wv + lane; c < w; c += 32) {
        const float av = elem<T>(a[c], 0);
        const float* xc = x + (size_t)c * K + k0;
        for (int q = 0; q < kc; ++q) acc[q] = fmaf(av, xc[q], acc[q]);
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < w; c += 32) {
        const float av = elem<T>(a[c], 0);
        const float* xc = x + (size_t)c * K + k0;
        for (int q = 0; q < kc; ++q) acc[q] = fmaf(av, xc[q], acc[q]);
      }
    }
    for (int q = 0; q < kc; ++q) {
      float v = acc[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) o[k0 + q] = v;
    }
  }
}

// one column a thread, one scalar load of A a row
template <typename T>
__global__ void __launch_bounds__(kCols)
block_rmatvec_kernel(const typename Elem<T>::S* __restrict__ A,
                     const float* __restrict__ Y, float* __restrict__ part,
                     int M, int m, int n, int nb, int K, int ctiles,
                     int rows_per_slice) {
  using S = typename Elem<T>::S;
  __shared__ float ys[kRows * kKc];
  const int j = blockIdx.x / ctiles;
  const int c = (blockIdx.x % ctiles) * kCols + threadIdx.x;
  const int s = blockIdx.y, z = blockIdx.z, N = gridDim.z;
  const int w = block_width(n, nb, j);
  const int i0 = s * rows_per_slice, i1 = min(m, i0 + rows_per_slice);
  const S* a = A + (size_t)z * m * n + (size_t)j * nb + c;
  const float* y = Y + ((size_t)z * M + j) * m * K;
  float* p = part + (((size_t)s * N + z) * M + j) * nb * K;
  for (int k0 = 0; k0 < K; k0 += kKc) {
    const int kc = min(kKc, K - k0);
    float acc[kKc];
#pragma unroll
    for (int q = 0; q < kKc; ++q) acc[q] = 0.f;
    for (int r0 = i0; r0 < i1; r0 += kRows) {
      const int r1 = min(i1, r0 + kRows);
      __syncthreads();  // the previous chunk of ys is consumed
      for (int l = threadIdx.x; l < (r1 - r0) * kc; l += kCols)
        ys[l] = y[(size_t)(r0 + l / kc) * K + k0 + l % kc];
      __syncthreads();
      if (c < w) {
#pragma unroll 4
        for (int i = r0; i < r1; ++i) {
          const float* yi = ys + (i - r0) * kc;
          const float av = elem<T>(a[(size_t)i * n], 0);
          for (int q = 0; q < kc; ++q) acc[q] = fmaf(av, yi[q], acc[q]);
        }
      }
    }
    // the padded rows c >= w keep their zeros
    if (c < nb)
      for (int q = 0; q < kc; ++q) p[(size_t)c * K + k0 + q] = acc[q];
  }
}

__global__ void sum_slices(const float* __restrict__ part,
                           float* __restrict__ out, int slices,
                           size_t count) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  float acc = 0.f;
  for (int s = 0; s < slices; ++s) acc += part[(size_t)s * count + t];
  out[t] = acc;
}

template <typename T>
int matvec_entry(const void* A, const float* X, float* out, int N, int M,
                 int m, int n, int nb, int K, void* stream) {
  const dim3 grid((m + kWarps - 1) / kWarps, M, N);
  block_matvec_kernel<T><<<grid, kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Elem<T>::S*>(A), X, out, M, m, n, nb, K);
  return (int)cudaGetLastError();
}

template <typename T>
int rmatvec_entry(const void* A, const float* Y, float* part, float* out,
                  int N, int M, int m, int n, int nb, int K,
                  int rows_per_slice, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_per_slice < 1) return (int)cudaErrorInvalidValue;
  const int slices = (m + rows_per_slice - 1) / rows_per_slice;
  const int ctiles = (nb + kCols - 1) / kCols;
  float* first = slices == 1 ? out : part;
  const dim3 grid(ctiles * M, slices, N);
  block_rmatvec_kernel<T><<<grid, kCols, 0, st>>>(
      static_cast<const typename Elem<T>::S*>(A), Y, first, M, m, n, nb, K,
      ctiles, rows_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const size_t count = (size_t)N * M * nb * K;
  sum_slices<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(part, out,
                                                              slices, count);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- stream

// What a stream CTA is given (the plan's choices and the shapes).
struct Stream {
  const void* A;
  const float* V;      // X (N, M, nb, K) or Y (N, M, m, K)
  float* dst;          // out, or part (N, ctas, M, nb, K) (rmatvec, ctas > 1)
  int M, m, n, nb, K;
  int k0;              // this pass's first right-hand side
  int rows, stages;    // R rows a tile; the ring's stages
  int stage_bytes, a_bytes, x_bytes;  // a stage, A's part of it; X's bytes
  int wb, groups;      // rmatvec: warps a block, row groups
  int mb, cb, ctas;    // non-empty blocks, chunks a block; CTAs a node
};

// Phase stamps, in a measurement build only (-DBLOCK_STREAM_TRACE, built by
// tools/block_matvec_probe.py --trace): lane 0 of consumer warps 0 and 1 of
// CTA 0 records clock64() at each point of each tile it takes (kTracePoints
// a tile: before and after the wait for the stage, after the work, after
// the release), and block_stream_trace() copies the last call's stamps out.
// CSTAMP(i) records %globaltimer for every CTA at point i: 0 entry, 1 the
// producer's first copy issued, 2 consumer warp 0's first tile landed, 3
// its last tile done, 4 the producer's last copies landed, 5 the CTA's
// result written.
#ifdef BLOCK_STREAM_TRACE
constexpr int kTracePoints = 4, kTraceTiles = 1024;
constexpr int kCtaPoints = 6, kTraceCtas = 1024;
__device__ long long g_trace[2][kTraceTiles][kTracePoints];
__device__ unsigned long long g_cta[kTraceCtas][kCtaPoints];
__device__ int g_trace_tiles;
#define STAMP(t, i)                                                        \
  do {                                                                     \
    if (blockIdx.x == 0 && lane == 0 && warp < 2 && (t) < kTraceTiles)     \
      g_trace[warp][t][i] = clock64();                                     \
  } while (0)
#define CSTAMP(i)                                                          \
  do {                                                                     \
    unsigned long long now;                                                \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));                \
    if (blockIdx.x < kTraceCtas) g_cta[blockIdx.x][i] = now;               \
  } while (0)
#else
#define STAMP(t, i) do {} while (0)
#define CSTAMP(i) do {} while (0)
#endif

// CTA c of node z takes the node's tiles c, c + ctas, c + 2 ctas, ...:
// ntiles of them, its t-th starting at row (c + t ctas) R.
struct Range {
  int z, c, ntiles;
};
__device__ __forceinline__ Range cta_range(const Stream& p) {
  const int z = blockIdx.x / p.ctas, c = blockIdx.x - z * p.ctas;
  const int tiles = (p.m + p.rows - 1) / p.rows;
  return {z, c, (tiles - c + p.ctas - 1) / p.ctas};
}
__device__ __forceinline__ int tile_row0(const Stream& p, const Range& g,
                                         int t) {
  return (g.c + t * p.ctas) * p.rows;
}

// The producer warp: tile t into stage t % stages once the consumers are
// done with the tile before it there (empty[s]), lane 0 the bulk copy of A
// and, for block_rmatvec, every lane its share of the tile's Y values by
// cp.async and an arrival, all completing on full[s]. It leaves once its
// last copies have landed.
template <typename S, bool kAdj, int KC>
__device__ __forceinline__ void produce(const Stream& p, unsigned char* ring,
                                        unsigned full0, unsigned empty0,
                                        const Range& g, int lane) {
  const S* a_node = static_cast<const S*>(p.A) + (size_t)g.z * p.m * p.n;
  for (int t = 0; t < g.ntiles; ++t) {
    const int s = t % p.stages;
    if (t >= p.stages)
      mbar_wait(empty0 + 8 * s, (unsigned)(t / p.stages - 1) & 1u);
    const int row0 = tile_row0(p, g, t);
    const int rows = min(p.rows, p.m - row0);
    unsigned char* st = ring + (size_t)s * p.stage_bytes;
    const unsigned bar = full0 + 8 * s;
    if (lane == 0) {
      const unsigned bytes = (unsigned)(rows * p.n) * sizeof(S);
      mbar_expect_tx(bar, bytes);
      bulk_load_evict_first(smem_addr(st), a_node + (size_t)row0 * p.n,
                            bytes, bar);
      if (t == 0) CSTAMP(1);
    }
    if constexpr (kAdj) {
      float* ys = reinterpret_cast<float*>(st + p.a_bytes);
      const int per = rows * KC;                 // a block's values
      for (int e = lane; e < p.mb * per; e += 32) {
        const int jj = e / per, r = (e - jj * per) / KC, k = e % KC;
        cp_async4(smem_addr(ys + (r * p.mb + jj) * KC + k),
                  p.V + (((size_t)g.z * p.M + jj) * p.m + row0 + r) * p.K
                      + p.k0 + k);
      }
      cp_async_arrive(bar);
    }
  }
  for (int t = max(0, g.ntiles - p.stages); t < g.ntiles; ++t)
    mbar_wait(full0 + 8 * (t % p.stages), (unsigned)(t / p.stages) & 1u);
  if (lane == 0) CSTAMP(4);
}

// block_matvec on the stream route. kStreamWarps consumer warps and one
// producer warp (warp kStreamWarps). A tile's R M items (row r, block j)
// are numbered from the CTA's first tile on, and item i goes to consumer
// warp i % kStreamWarps, which forms the whole dot product of its row's
// block: lane l the block's chunks l, l + 32, ..., then the shuffle-down
// tree; lane 0 writes the output. X of the pass is read once: with XR > 0
// (M divides kStreamWarps, so a warp's items all lie in block
// warp % M, and XR kc <= kMaxChunkRhs) a lane keeps its XR chunks' X in
// registers; with XR == 0 the CTA stages the node's X in shared memory
// ([k][half of the chunk][chunk] as float4). Every consumer warp waits for
// every tile and releases it, items or none (so a warp never waits on a
// stage more than one phase from where the stage is): with fewer items a
// tile than warps, the warps work on several tiles at once.
template <typename T, int KC, int XR>
__global__ void __launch_bounds__(kStreamWarps * 32 + 32, 1)
block_stream_mv_kernel(const Stream p) {
  using S = typename Elem<T>::S;
  using V16 = typename Elem<T>::V16;
  constexpr int W = kStreamWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  float4* xs = reinterpret_cast<float4*>(smem + kBarBytes);
  unsigned char* ring = smem + kBarBytes + p.x_bytes;
  const unsigned full0 = smem_addr(smem), empty0 = full0 + 8 * kMaxStages;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) CSTAMP(0);
  const Range g = cta_range(p);
  const int nc = p.n / 8, R = p.rows;
  const long long per_tile = (long long)R * p.M;   // items of a full tile
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == W) {
    produce<S, false, KC>(p, ring, full0, empty0, g, lane);
    return;
  }
  // X of node z for this pass, while the first tiles are in flight
  float xr[XR > 0 ? XR : 1][8][KC];
  if constexpr (XR > 0) {
    const int jw = warp % p.M;
    const int cbj = jw < p.mb ? min(p.cb, nc - jw * p.cb) : 0;
#pragma unroll
    for (int u = 0; u < XR; ++u) {
      const int c = lane + 32 * u;
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int k = 0; k < KC; ++k)
          xr[u][e][k] = c < cbj
              ? p.V[(((size_t)g.z * p.M + jw) * p.nb + 8 * c + e) * p.K
                    + p.k0 + k]
              : 0.f;
    }
  } else {
    for (int i = tid; i < nc * 2 * KC; i += 32 * W) {
      const int ch = i % nc, kh = i / nc, k = kh / 2, h = kh - 2 * k;
      const int j = ch / p.cb, col = 8 * (ch - j * p.cb) + 4 * h;
      const float* x = p.V + (((size_t)g.z * p.M + j) * p.nb + col) * p.K
                       + p.k0 + k;
      xs[i] = make_float4(x[0], x[p.K], x[2 * p.K], x[3 * p.K]);
    }
    consumer_sync(32 * W);
  }
#ifdef BLOCK_STREAM_TRACE
  if (blockIdx.x == 0 && tid == 0) g_trace_tiles = g.ntiles;
#endif
  for (int t = 0; t < g.ntiles; ++t) {
    const int row0 = tile_row0(p, g, t);
    const int rows = min(R, p.m - row0);
    const long long b = t * per_tile, e = b + (long long)rows * p.M;
    const long long first = b + ((warp - b) % W + W) % W;
    const int s = t % p.stages;
    STAMP(t, 0);
    mbar_wait(full0 + 8 * s, (unsigned)(t / p.stages) & 1u);
    STAMP(t, 1);
    if (t == 0 && tid == 0) CSTAMP(2);
    const S* tile =
        reinterpret_cast<const S*>(ring + (size_t)s * p.stage_bytes);
    for (long long it = first; it < e; it += W) {
      const int local = (int)(it - b), r = local / p.M, j = local - r * p.M;
      float acc[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[k] = 0.f;
      if (j < p.mb) {                       // an empty block sums to 0
        const int cbj = min(p.cb, nc - j * p.cb);
        const S* arow = tile + (size_t)r * p.n + (size_t)j * p.cb * 8;
        if constexpr (XR > 0) {
#pragma unroll
          for (int u = 0; u < XR; ++u) {
            const int c = lane + 32 * u;
            if (c < cbj) {
              const V16 a = *reinterpret_cast<const V16*>(arow + 8 * c);
#pragma unroll
              for (int k = 0; k < KC; ++k) {
                float v = acc[k];
#pragma unroll
                for (int q = 0; q < 8; ++q)
                  v = fmaf(elem<T>(a, q), xr[u][q][k], v);
                acc[k] = v;
              }
            }
          }
        } else {
          const float4* xj = xs + j * p.cb;
          for (int c = lane; c < cbj; c += 32) {
            const V16 a = *reinterpret_cast<const V16*>(arow + 8 * c);
#pragma unroll
            for (int k = 0; k < KC; ++k) {
              const float4 x0 = xj[(2 * k) * nc + c];
              const float4 x1 = xj[(2 * k + 1) * nc + c];
              float v = acc[k];
              v = fmaf(elem<T>(a, 0), x0.x, v);
              v = fmaf(elem<T>(a, 1), x0.y, v);
              v = fmaf(elem<T>(a, 2), x0.z, v);
              v = fmaf(elem<T>(a, 3), x0.w, v);
              v = fmaf(elem<T>(a, 4), x1.x, v);
              v = fmaf(elem<T>(a, 5), x1.y, v);
              v = fmaf(elem<T>(a, 6), x1.z, v);
              acc[k] = fmaf(elem<T>(a, 7), x1.w, v);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float v = warp_sum(acc[k]);
        if (lane == 0)
          p.dst[(((size_t)g.z * p.M + j) * p.m + row0 + r) * p.K + p.k0 + k]
              = v;
      }
    }
    STAMP(t, 2);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    STAMP(t, 3);
  }
  if (tid == 0) CSTAMP(3);
}

// block_rmatvec on the stream route. W = groups mb wb consumer warps and
// one producer warp (warp W). Consumer thread (g, j, w, l): row group g,
// block j < mb, warp w < wb of the block, lane l; it owns the block's
// 16-byte chunks q, q + 32 wb, ... (VPT of them, q = 32 w + l) and their
// column partials (8 KC floats a chunk) in registers, and takes the tile's
// rows g, g + G, ...; every consumer warp reads every tile and releases it.
// At the end the CTA adds its groups' partials in group order (the ring
// reused) and writes its partial (or, with one CTA a node, the output).
template <typename T, int VPT, int KC>
__global__ void __launch_bounds__(kStreamWarps * 32 + 32, 1)
block_stream_rmv_kernel(const Stream p) {
  using S = typename Elem<T>::S;
  using V16 = typename Elem<T>::V16;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + kBarBytes;
  const unsigned full0 = smem_addr(smem), empty0 = full0 + 8 * kMaxStages;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) CSTAMP(0);
  // block_sum_kernel, launched next, may be scheduled from now on
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int W = p.groups * p.mb * p.wb;         // consumer warps
  const int tpg = 32 * p.mb * p.wb;             // threads a group
  const int grp = tid / tpg, ti = tid - grp * tpg;
  const int j = ti / (32 * p.wb), wbi = (ti / 32) % p.wb;
  const int q = 32 * wbi + lane;                // first chunk in the block
  const Range g = cta_range(p);
  const int R = p.rows, G = p.groups, rg = R / G;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);
      mbar_init(empty0 + 8 * s, W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == W) {
    produce<S, true, KC>(p, ring, full0, empty0, g, lane);
    return;
  }
  const int cbj = min(p.cb, p.n / 8 - j * p.cb);  // chunks of block j
  float part[VPT][8][KC];
#pragma unroll
  for (int u = 0; u < VPT; ++u)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int k = 0; k < KC; ++k) part[u][e][k] = 0.f;
#ifdef BLOCK_STREAM_TRACE
  if (blockIdx.x == 0 && tid == 0) g_trace_tiles = g.ntiles;
#endif
  for (int t = 0; t < g.ntiles; ++t) {
    const int s = t % p.stages;
    const int rows = min(R, p.m - tile_row0(p, g, t));
    STAMP(t, 0);
    mbar_wait(full0 + 8 * s, (unsigned)(t / p.stages) & 1u);
    STAMP(t, 1);
    if (t == 0 && tid == 0) CSTAMP(2);
    const unsigned char* st = ring + (size_t)s * p.stage_bytes;
    const S* tile = reinterpret_cast<const S*>(st) + (size_t)j * p.cb * 8;
    const float* ys = reinterpret_cast<const float*>(st + p.a_bytes);
#pragma unroll
    for (int rr = 0; rr < kMaxGroupRows; ++rr) {
      const int r = grp + G * rr;
      if (rr < rg && r < rows) {   // uniform across the warp
        float yv[KC];
#pragma unroll
        for (int k = 0; k < KC; ++k) yv[k] = ys[(r * p.mb + j) * KC + k];
#pragma unroll
        for (int u = 0; u < VPT; ++u) {
          const int cu = q + u * 32 * p.wb;
          if (cu < cbj) {
            const V16 a = *reinterpret_cast<const V16*>(
                tile + (size_t)r * p.n + 8 * cu);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float av = elem<T>(a, e);
#pragma unroll
              for (int k = 0; k < KC; ++k)
                part[u][e][k] = fmaf(av, yv[k], part[u][e][k]);
            }
          }
        }
      }
    }
    STAMP(t, 2);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    STAMP(t, 3);
  }
  if (tid == 0) CSTAMP(3);
  // every tile is consumed and every copy landed: the ring takes the
  // groups' partials, [group - 1][u][e][k][thread of the group]
  constexpr int NV = VPT * 8 * KC;
  float* comb = reinterpret_cast<float*>(ring);
  consumer_sync(32 * W);
  if (grp > 0) {
#pragma unroll
    for (int u = 0; u < VPT; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int k = 0; k < KC; ++k)
          comb[((size_t)(grp - 1) * NV + (u * 8 + e) * KC + k) * tpg + ti] =
              part[u][e][k];
  }
  consumer_sync(32 * W);
  if (grp == 0) {
    for (int h = 1; h < G; ++h)
#pragma unroll
      for (int u = 0; u < VPT; ++u)
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int k = 0; k < KC; ++k)
            part[u][e][k] +=
                comb[((size_t)(h - 1) * NV + (u * 8 + e) * KC + k) * tpg + ti];
    // ctas > 1: this CTA's partial; else the output
    float* d = p.dst + ((size_t)(p.ctas > 1 ? g.z * p.ctas + g.c : g.z)
                        * p.M + j) * p.nb * p.K;
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      const int cu = q + u * 32 * p.wb;
      if (cu < cbj)
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int k = 0; k < KC; ++k)
            d[(size_t)(8 * cu + e) * p.K + p.k0 + k] = part[u][e][k];
    }
    if (tid == 0) CSTAMP(5);
  }
  if (p.ctas == 1) {   // the padded rows c >= w_j of the output: 0
    for (int idx = tid; idx < p.M * p.nb; idx += 32 * W) {
      const int jj = idx / p.nb, col = idx - jj * p.nb;
      if (col >= block_width(p.n, p.nb, jj))
        for (int k = 0; k < KC; ++k)
          p.dst[(((size_t)g.z * p.M + jj) * p.nb + col) * p.K + p.k0 + k] =
              0.f;
    }
  }
}

// out[t] for t < N M nb K: 0 on a padded row (c >= w_j), else the node's
// CTAs' partials part[z][k][rest] added in kSumRuns runs of
// ceil(ctas / kSumRuns) consecutive CTAs, each run from zero in CTA order,
// then the runs' sums in run order, from run 0's. A CTA owns kSumCols
// neighbouring outputs; warp y adds run y (its loads all in flight).
__global__ void __launch_bounds__(kSumThreads)
block_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                 int N, int M, int n, int nb, int K, int ctas) {
  __shared__ float runs[kSumRuns][kSumCols];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int x = threadIdx.x % kSumCols, y = threadIdx.x / kSumCols;
  const long long per = (long long)M * nb * K;    // a node's outputs
  const long long t = (long long)blockIdx.x * kSumCols + x;
  const int z = (int)(t / per);
  const long long rest = t - z * per;
  const int jj = (int)(rest / ((long long)nb * K));
  const int col = (int)(rest / K % nb);
  const bool live = t < N * per && col < block_width(n, nb, jj);
  const int len = (ctas + kSumRuns - 1) / kSumRuns;
  const int k0 = y * len, k1 = min(ctas, k0 + len);
  float acc = 0.f;
  if (live) {
    const float* src = part + ((size_t)z * ctas + k0) * per + rest;
#pragma unroll 8
    for (int k = 0; k < k1 - k0; ++k) acc += src[(size_t)k * per];
  }
  runs[y][x] = acc;
  __syncthreads();
  if (y == 0 && t < N * per) {
    float v = runs[0][x];
#pragma unroll
    for (int r = 1; r < kSumRuns; ++r) v += runs[r][x];
    out[t] = v;
  }
}

// A launch as a programmatic dependent of the kernel before it on the
// stream: its CTAs may be scheduled once that kernel's CTAs have all
// started (block_stream_rmv_kernel signals it at once) or it has
// completed, and wait in griddepcontrol.wait for its completion before they
// touch global memory.
template <typename... Args>
cudaError_t launch_dependent(void (*kern)(Args...), unsigned ctas,
                             unsigned threads, size_t smem, cudaStream_t st,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <typename Kern>
cudaError_t launch(Kern kern, bool& configured, const Stream& p, int N,
                   int threads, size_t smem, cudaStream_t st) {
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kern<<<N * p.ctas, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int KC, int XR>
cudaError_t launch_mv(const Stream& p, int N, size_t smem, cudaStream_t st) {
  static bool configured = false;
  if constexpr (XR * KC <= kMaxChunkRhs)
    return launch(block_stream_mv_kernel<T, KC, XR>, configured, p, N,
                  32 * kStreamWarps + 32, smem, st);
  else
    return cudaErrorInvalidValue;   // the plan never asks for it
}

template <typename T, int VPT, int KC>
cudaError_t launch_rmv(const Stream& p, int N, int threads, size_t smem,
                       cudaStream_t st) {
  static bool configured = false;
  if constexpr (VPT * KC <= kMaxChunkRhs)
    return launch(block_stream_rmv_kernel<T, VPT, KC>, configured, p, N,
                  threads, smem, st);
  else
    return cudaErrorInvalidValue;   // the plan never asks for it
}

template <typename T, int VPT>
cudaError_t rmv_by_kc(int kc, const Stream& p, int N, int threads,
                      size_t smem, cudaStream_t st) {
  switch (kc) {
    case 1: return launch_rmv<T, VPT, 1>(p, N, threads, smem, st);
    case 2: return launch_rmv<T, VPT, 2>(p, N, threads, smem, st);
    case 3: return launch_rmv<T, VPT, 3>(p, N, threads, smem, st);
    case 4: return launch_rmv<T, VPT, 4>(p, N, threads, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int XR>
cudaError_t mv_by_kc(int kc, const Stream& p, int N, size_t smem,
                     cudaStream_t st) {
  switch (kc) {
    case 1: return launch_mv<T, 1, XR>(p, N, smem, st);
    case 2: return launch_mv<T, 2, XR>(p, N, smem, st);
    case 3: return launch_mv<T, 3, XR>(p, N, smem, st);
    case 4: return launch_mv<T, 4, XR>(p, N, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

int align16(long long b) { return (int)((b + 15) / 16 * 16); }

template <typename T>
int stream_entry(const void* A, const float* V, float* part, float* out,
                 int N, int M, int m, int n, int nb, int K, int adjoint,
                 int rows, int stages, int wb, int groups, int vpt, int kc,
                 int ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || M < 1 || m < 1 || K < 1 || n < 8 || n % 8 || nb % 8
      || nb != (n + M - 1) / M || reinterpret_cast<uintptr_t>(A) % 16
      || rows < 1 || stages < 2 || stages > kMaxStages || kc < 1
      || kc > kMaxKc || ctas < 1 || ctas > (m + rows - 1) / rows)
    return (int)cudaErrorInvalidValue;
  const int nc = n / 8, cb = nb / 8;
  const int mb = (nc + cb - 1) / cb;      // non-empty blocks
  Stream p{A, V, out, M, m, n, nb, K, 0, rows, stages, 0,
           align16((long long)rows * n * 2), 0, wb, groups, mb, cb, ctas};
  size_t smem;
  int threads = 32 * kStreamWarps + 32;
  if (!adjoint) {
    // vpt: X in registers, that many chunks a lane (M divides the consumer
    // warps, the block's chunks covered, vpt kc within kMaxChunkRhs); or 0:
    // X of a pass in shared memory beside the ring
    if (vpt < 0 || vpt > kMaxVpt || (vpt & (vpt - 1))
        || (vpt > 0 && (kStreamWarps % M || 32 * vpt < cb
                        || vpt * kc > kMaxChunkRhs)))
      return (int)cudaErrorInvalidValue;
    p.stage_bytes = p.a_bytes;
    p.x_bytes = vpt ? 0 : align16((long long)n * kc * 4);
    const long long ring = (long long)stages * p.stage_bytes;
    if (p.x_bytes > kMaxXBytes || p.x_bytes + ring > kRingBytes)
      return (int)cudaErrorInvalidValue;
    smem = kBarBytes + p.x_bytes + (size_t)ring;
  } else {
    if (wb < 1 || groups < 1 || (long long)groups * mb * wb > kStreamWarps
        || vpt < 1 || vpt > kMaxVpt || (vpt & (vpt - 1))
        || 32LL * wb * vpt < cb || vpt * kc > kMaxChunkRhs
        || rows % groups || rows / groups > kMaxGroupRows)
      return (int)cudaErrorInvalidValue;
    p.stage_bytes = p.a_bytes + align16((long long)rows * mb * kc * 4);
    threads = 32 * groups * mb * wb + 32;
    // the groups' partials reuse the ring
    const long long comb = 4LL * (groups - 1) * vpt * 8 * kc * 32 * mb * wb;
    const long long ring = (long long)stages * p.stage_bytes;
    if (ring > kRingBytes || comb > kRingBytes)
      return (int)cudaErrorInvalidValue;
    smem = kBarBytes + (size_t)(ring > comb ? ring : comb);
    if (ctas > 1) p.dst = part;
  }
  for (int k0 = 0; k0 < K; k0 += kc) {
    p.k0 = k0;
    const int kcp = K - k0 < kc ? K - k0 : kc;
    cudaError_t err;
    if (!adjoint)
      err = vpt == 0 ? mv_by_kc<T, 0>(kcp, p, N, smem, st)
          : vpt == 1 ? mv_by_kc<T, 1>(kcp, p, N, smem, st)
          : vpt == 2 ? mv_by_kc<T, 2>(kcp, p, N, smem, st)
                     : mv_by_kc<T, 4>(kcp, p, N, smem, st);
    else if (vpt == 1)
      err = rmv_by_kc<T, 1>(kcp, p, N, threads, smem, st);
    else if (vpt == 2)
      err = rmv_by_kc<T, 2>(kcp, p, N, threads, smem, st);
    else
      err = rmv_by_kc<T, 4>(kcp, p, N, threads, smem, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (!adjoint || ctas == 1) return 0;
  // the sum kernel as a programmatic dependent of the last stream kernel:
  // its CTAs may start while that one runs and wait in griddepcontrol.wait
  // until it has completed and its partials are visible
  const long long count = (long long)N * M * nb * K;
  return (int)launch_dependent(
      block_sum_kernel, (unsigned)((count + kSumCols - 1) / kSumCols),
      (unsigned)kSumThreads, 0, st, (const float*)part, out, N, M, n, nb, K,
      ctas);
}

}  // namespace

// The scalar route (any element type, shape and alignment):
//
// block_matvec_<type>: A (N, m, n) row-major of <type>; X (N, M, nb, K)
// f32; out (N, M, m, K) f32. One kernel launch.
//
// block_rmatvec_<type>: A (N, m, n) row-major of <type>; Y (N, M, m, K) f32;
// part (slices, N, M, nb, K) f32 scratch with slices =
// ceil(m / rows_per_slice), unused when slices == 1; out (N, M, nb, K) f32.
// Two kernel launches when slices > 1, else one.
//
// Each returns cudaGetLastError() (cudaErrorInvalidValue for
// rows_per_slice < 1).
#define BLOCK_ENTRIES(SUFFIX, T)                                              \
  extern "C" int block_matvec_##SUFFIX(const void* A, const float* X,        \
                                       float* out, int N, int M, int m,      \
                                       int n, int nb, int K, void* stream) { \
    return matvec_entry<T>(A, X, out, N, M, m, n, nb, K, stream);            \
  }                                                                           \
  extern "C" int block_rmatvec_##SUFFIX(const void* A, const float* Y,       \
                                        float* part, float* out, int N,      \
                                        int M, int m, int n, int nb, int K,  \
                                        int rows_per_slice, void* stream) {  \
    return rmatvec_entry<T>(A, Y, part, out, N, M, m, n, nb, K,              \
                            rows_per_slice, stream);                         \
  }

BLOCK_ENTRIES(f32, float)
BLOCK_ENTRIES(bf16, __nv_bfloat16)
BLOCK_ENTRIES(f16, __half)

// The stream route (bf16 / fp16 A, n % 8 == 0, nb = ceil(n / M) % 8 == 0,
// A 16-byte aligned, m >= 1):
//
// block_stream_<type>: A (N, m, n); V = X (N, M, nb, K) (adjoint 0:
// block_matvec, out (N, M, m, K)) or Y (N, M, m, K) (adjoint 1:
// block_rmatvec, out (N, M, nb, K)); part (N, ctas, M, nb, K) f32 scratch
// for adjoint with ctas > 1, else unused. The plan: `rows` rows a tile,
// `stages` of the ring (2 .. kMaxStages), `kc` right-hand sides a pass,
// `ctas` CTAs a node (at most its tiles). block_matvec: `vpt` 0 (X in
// shared memory, at most kMaxXBytes) or 1, 2, 4 chunks a lane whose X stays
// in registers (M divides kStreamWarps, 32 vpt >= nb / 8, vpt kc <=
// kMaxChunkRhs); X and the ring within kRingBytes; `wb` and `groups` unused.
// block_rmatvec: `groups` row groups of `wb` warps a non-empty block
// (groups x blocks x wb <= kStreamWarps), `rows` a multiple of `groups`
// with at most kMaxGroupRows a group, `vpt` (1, 2 or 4) chunks a lane with
// 32 wb vpt >= nb / 8 and vpt kc <= kMaxChunkRhs, the ring within
// kRingBytes. Launches: ceil(K / kc) stream kernels, then for adjoint with
// ctas > 1 block_sum_kernel. Returns the launches' error
// (cudaErrorInvalidValue for a plan the shape does not allow).
#define STREAM_ENTRY(SUFFIX, T)                                               \
  extern "C" int block_stream_##SUFFIX(                                       \
      const void* A, const float* V, float* part, float* out, int N, int M,  \
      int m, int n, int nb, int K, int adjoint, int rows, int stages, int wb,\
      int groups, int vpt, int kc, int ctas, void* stream) {                 \
    return stream_entry<T>(A, V, part, out, N, M, m, n, nb, K, adjoint,      \
                           rows, stages, wb, groups, vpt, kc, ctas, stream); \
  }

STREAM_ENTRY(bf16, __nv_bfloat16)
STREAM_ENTRY(f16, __half)

#ifdef BLOCK_STREAM_TRACE
// The last stream call's CTA stamps: times[kTraceCtas][kCtaPoints], ns of
// %globaltimer (0 where a CTA has no such point).
extern "C" int block_stream_trace_ctas(unsigned long long* times) {
  static unsigned long long zeros[kTraceCtas * kCtaPoints];
  if (cudaDeviceSynchronize() != cudaSuccess ||
      cudaMemcpyFromSymbol(times, g_cta, sizeof(g_cta)) != cudaSuccess ||
      cudaMemcpyToSymbol(g_cta, zeros, sizeof(g_cta)) != cudaSuccess)
    return -1;
  return 0;
}

// The last stream call's stamps: clocks[2][kTraceTiles][kTracePoints] (0
// where the warp took no item of the tile), then all set to 0 for the next
// call; returns the tiles of CTA 0, or -1 on a CUDA error.
extern "C" int block_stream_trace(long long* clocks) {
  static long long zeros[2 * kTraceTiles * kTracePoints];
  int n = 0;
  if (cudaDeviceSynchronize() != cudaSuccess ||
      cudaMemcpyFromSymbol(&n, g_trace_tiles, sizeof(int)) != cudaSuccess ||
      cudaMemcpyFromSymbol(clocks, g_trace, sizeof(g_trace)) != cudaSuccess ||
      cudaMemcpyToSymbol(g_trace, zeros, sizeof(g_trace)) != cudaSuccess)
    return -1;
  return n;
}
#endif
