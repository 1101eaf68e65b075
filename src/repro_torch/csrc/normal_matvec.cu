// The normal-equation product of the matrix-free x-update and polish, with
// f32 accumulation, reading A from HBM once:
//
//   out[z, :] = A[z]^T (A[z] p[z]) + shift (.) p[z]
//
// A is (N, m, n) row-major f32, never copied; p is (N, n), out (N, n), all
// contiguous. shift is a scalar (a value, or a 0-d device tensor read on the
// device) or an (n,) vector broadcast over the nodes.
//
// Replaces: src/repro/kernels/matvec.py, normal_matvec (:175) and
// normal_matvec_gpu (:284) -- two tiled passes over A (the _mv_kernel and
// _rmv_kernel TPU kernels) and the shifted axpy. w = A p is cast to
// a.dtype between the two products (:186): to_a_dtype below, the identity
// while only f32 operands are taken.
//
// What bounds it on an H100: every element of A is used twice (once in
// A p, once in A^T w) for 4 flops, so the product is bound by memory: 4 N m
// n bytes at 3.35 TB/s -- 0.955 ms for the Fig. 3 x-update's (8, 25,000,
// 4,000), 0.076 ms for the Woodbury polish's stacked (6,400, 10,000). The
// composition of the two GEMV kernels reads A twice and cannot pass half of
// that bound. Here a row's two uses happen while it sits in shared memory:
//
// * A CTA of kThreads threads owns a contiguous range of R-row tiles of one
//   node (R = 1, 2 or 4 rows, the plan's choice from n). A ring of S stages
//   in shared memory holds the next tiles: on the bulk path (n % 4 == 0, A
//   16-byte aligned) a tile is one contiguous run of R n floats, fetched by
//   ONE cp.async.bulk that completes on the stage's mbarrier; on the scalar
//   path every thread issues 4-byte cp.asyncs into rows padded to a
//   multiple of 4 floats and arrives on the mbarrier when they land. Thread
//   0 (all threads, scalar path) refills a stage one tile after it was
//   used, so S - 1 tiles stay in flight while one is consumed.
// * Thread t owns the float4 column chunks t, t + kThreads, ... (VPT of
//   them): p and the CTA's column partial g of those chunks live in its
//   registers for the whole kernel.
// * A tile: each thread forms its share of the R dot products A_r . p from
//   shared memory, the warps reduce them, and after ONE __syncthreads every
//   thread adds the kWarps warp partials (the same bits everywhere) into
//   w_r and accumulates g += A_r w_r over its chunks, re-reading the tile
//   from shared memory. The warp partials are double-buffered by tile
//   parity, so one barrier a tile suffices.
// * The CTAs' column partials are added by normal_sum_kernel (a second,
//   short launch), which also applies + shift (.) p and the cast. With one
//   CTA a node the stream kernel applies them itself: one launch.
//
// Summation order (fixed by the shapes; no float atomics, so two calls
// agree bit for bit):
// * w_r: thread t sums its chunks in order, each chunk's 4 products
//   x, y, z, w into one accumulator (fmaf); the warp adds its lanes with
//   the shuffle-down tree 16, 8, 4, 2, 1; every thread adds warps 0 ..
//   kWarps - 1 in order, starting from warp 0's partial.
// * A CTA's partial of column c: sum over its rows in row order, from zero,
//   of fmaf(A[i, c], w_i, .).
// * out[z, c]: the CTAs' partials of node z in CTA order, from zero, then
//   + (shift_c * p_c), the product rounded on its own (__fmul_rn,
//   __fadd_rn): the plain version's g + shift * p. With one CTA a node:
//   its partial + (shift_c * p_c).
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 512;           // threads of a stream CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVpt = 8;              // float4 column chunks a thread owns
constexpr int kMaxRows = 4;             // rows of a tile (1, 2 or 4)
constexpr int kMaxTileVecs = 8;         // most rows x vpt a kernel takes
constexpr int kMaxStages = 8;           // stages of the ring
constexpr int kRingBytes = 204800;      // shared memory of the ring
constexpr int kSumCols = 32;            // outputs a sum block adds
constexpr int kSumTile = 128;           // CTA partials a sum block stages
constexpr int kSumThreads = 256;

// shared memory: the stages' mbarriers, the warp partials [2][kWarps][R],
// then the ring (16-byte aligned, as cp.async.bulk needs)
constexpr int kBarBytes = 8 * kMaxStages;
constexpr int kRedBytes = 4 * 2 * kWarps * kMaxRows;
constexpr int kSmemBytes = kBarBytes + kRedBytes + kRingBytes;
static_assert((kBarBytes + kRedBytes) % 16 == 0, "ring alignment");

struct Shift {
  const float* ptr;   // kind 1: a 0-d device tensor; kind 2: (n,)
  float val;          // kind 0
  int kind;
};

__device__ __forceinline__ float shift_at(const Shift& s, int col) {
  return s.kind == 0 ? s.val : s.kind == 1 ? s.ptr[0] : s.ptr[col];
}

// g + shift * p as the plain version rounds it (no contraction into an FMA)
__device__ __forceinline__ float finish(float g, float s, float p) {
  return __fadd_rn(g, __fmul_rn(s, p));
}

// The cast of w to a.dtype between the two products (repro matvec.py:186);
// A is f32 here.
__device__ __forceinline__ float to_a_dtype(float w) { return w; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
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
// `bytes` contiguous bytes of global memory into shared memory, completing
// on barrier bar (both addresses 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}
// An arrival on bar once this thread's earlier cp.asyncs have landed (the
// barrier's count includes it: .noinc).
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// The shuffle-down tree: lane 0 ends with the warp's sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Grid: N * ctas CTAs, CTA b streams node b / ctas, tiles
// [T c / ctas, T (c + 1) / ctas) of its T = ceil(m / R) tiles, c = b % ctas.
// ctas > 1: writes its column partial to part[z][c][:]; ctas == 1: out.
template <bool kBulk, int VPT, int R>
__global__ void __launch_bounds__(kThreads, 1)
normal_stream_kernel(const float* __restrict__ A, const float* __restrict__ P,
                     Shift shift, float* __restrict__ part,
                     float* __restrict__ out, int m, int n, int ctas,
                     int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + kBarBytes);
  float* ring = reinterpret_cast<float*>(smem + kBarBytes + kRedBytes);
  const unsigned bar0 = smem_addr(smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int z = blockIdx.x / ctas, c = blockIdx.x - z * ctas;
  const int n4 = (n + 3) / 4, ld = 4 * n4;   // a stage row: ld floats
  const int tiles = (m + R - 1) / R;
  const int t0 = (int)((long long)tiles * c / ctas);
  const int ntiles = (int)((long long)tiles * (c + 1) / ctas) - t0;
  const float* a_node = A + (size_t)z * m * n;

  // tile t of this CTA into stage s
  auto fill = [&](int t, int s) {
    const int row0 = (t0 + t) * R;
    const int rows = min(R, m - row0);
    const float* src = a_node + (size_t)row0 * n;
    float* dst = ring + (size_t)s * R * ld;
    if constexpr (kBulk) {
      if (tid == 0) {
        const unsigned bytes = (unsigned)(rows * n) * 4u;
        mbar_expect_tx(bar0 + 8 * s, bytes);
        bulk_load(smem_addr(dst), src, bytes, bar0 + 8 * s);
      }
    } else {
      const int count = rows * n;
      for (int e = tid; e < count; e += kThreads) {
        const int r = e / n;
        cp_async4(smem_addr(dst + r * ld + (e - r * n)), src + e);
      }
      cp_async_arrive(bar0 + 8 * s);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s, kBulk ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!kBulk) {
    // the pad columns n .. ld - 1 of every stage row are never copied into:
    // zeros, so that the last chunk's products with p's zero pad are 0
    const int pad = ld - n;
    for (int e = tid; e < stages * R * pad; e += kThreads) {
      const int sr = e / pad;
      ring[sr * ld + n + (e - sr * pad)] = 0.f;
    }
  }
  __syncthreads();
  for (int t = 0; t < min(stages, ntiles); ++t) fill(t, t);

  const float* pz = P + (size_t)z * n;
  float4 p4[VPT], g4[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int col = 4 * (tid + v * kThreads);
    p4[v].x = col < n ? pz[col] : 0.f;
    p4[v].y = col + 1 < n ? pz[col + 1] : 0.f;
    p4[v].z = col + 2 < n ? pz[col + 2] : 0.f;
    p4[v].w = col + 3 < n ? pz[col + 3] : 0.f;
    g4[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % stages;
    const int rows = min(R, m - (t0 + t) * R);
    mbar_wait(bar0 + 8 * s, (unsigned)(t / stages) & 1u);
    const float4* a4 = reinterpret_cast<const float4*>(ring + (size_t)s * R * ld);
    float* rb = red + (t & 1) * kWarps * R;
    // this thread's share of each row's A_r . p, then the warp's
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc = 0.f;
      if (r < rows) {
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          const int j = tid + v * kThreads;
          if (j < n4) {
            const float4 a = a4[r * n4 + j];
            acc = fmaf(a.x, p4[v].x, acc);
            acc = fmaf(a.y, p4[v].y, acc);
            acc = fmaf(a.z, p4[v].z, acc);
            acc = fmaf(a.w, p4[v].w, acc);
          }
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) rb[warp * R + r] = acc;
    }
    __syncthreads();
    // every thread is past tile t - 1: its stage takes tile t - 1 + stages
    if (t >= 1 && t - 1 + stages < ntiles) fill(t - 1 + stages, (t - 1) % stages);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) break;
      float w = rb[r];
      for (int k = 1; k < kWarps; ++k) w += rb[k * R + r];
      w = to_a_dtype(w);
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const int j = tid + v * kThreads;
        if (j < n4) {
          const float4 a = a4[r * n4 + j];
          g4[v].x = fmaf(a.x, w, g4[v].x);
          g4[v].y = fmaf(a.y, w, g4[v].y);
          g4[v].z = fmaf(a.z, w, g4[v].z);
          g4[v].w = fmaf(a.w, w, g4[v].w);
        }
      }
    }
  }

  if (ctas == 1) {
    float* o = out + (size_t)z * n;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int col = 4 * (tid + v * kThreads);
      const float g[4] = {g4[v].x, g4[v].y, g4[v].z, g4[v].w};
      const float pv[4] = {p4[v].x, p4[v].y, p4[v].z, p4[v].w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < n) o[col + q] = finish(g[q], shift_at(shift, col + q), pv[q]);
    }
    return;
  }
  float* dst = part + ((size_t)z * ctas + c) * n;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int j = tid + v * kThreads;
    if (kBulk) {
      if (j < n4) reinterpret_cast<float4*>(dst)[j] = g4[v];
    } else {
      const float g[4] = {g4[v].x, g4[v].y, g4[v].z, g4[v].w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * j + q < n) dst[4 * j + q] = g[q];
    }
  }
}

// out[z, col] = (sum over CTAs k in order from zero of part[z][k][col]) +
// shift_col * p[z, col]. A block owns kSumCols neighbouring outputs: its
// threads stage kSumTile CTAs' partials of them at a time in shared memory
// (every load of a thread in flight together), then thread x of warp 0 adds
// output x's partials in CTA order. ctas == 0 (m == 0): shift (.) p.
__global__ void __launch_bounds__(kSumThreads)
normal_sum_kernel(const float* __restrict__ part, const float* __restrict__ P,
                  Shift shift, float* __restrict__ out, int N, int n,
                  int ctas) {
  constexpr int kStep = kSumThreads / kSumCols;   // partials a pass stages
  __shared__ float tile[kSumTile][kSumCols];
  const int x = threadIdx.x % kSumCols, y = threadIdx.x / kSumCols;
  const long long t = (long long)blockIdx.x * kSumCols + x;
  const bool live = t < (long long)N * n;
  const int z = live ? (int)(t / n) : 0;
  const int col = live ? (int)(t - (long long)z * n) : 0;
  const float* src = part + (size_t)z * ctas * n + col;
  float acc = 0.f;
  for (int k0 = 0; k0 < ctas; k0 += kSumTile) {
    const int nk = min(kSumTile, ctas - k0);
#pragma unroll
    for (int u = 0; u < kSumTile / kStep; ++u) {
      const int k = y + kStep * u;
      if (k < nk && live) tile[k][x] = src[(size_t)(k0 + k) * n];
    }
    __syncthreads();
    if (y == 0) {
      int k = 0;
      for (; k + 16 <= nk; k += 16) {   // 16 loads issued, then added
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) v[u] = tile[k + u][x];
#pragma unroll
        for (int u = 0; u < 16; ++u) acc += v[u];
      }
      for (; k < nk; ++k) acc += tile[k][x];
    }
    __syncthreads();
  }
  if (y == 0 && live) out[t] = finish(acc, shift_at(shift, col), P[t]);
}

struct Args {
  const float* A;
  const float* P;
  Shift shift;
  float* part;
  float* out;
  int N, m, n, stages, ctas;
  cudaStream_t st;
};

template <bool B, int V, int R>
cudaError_t launch_stream(const Args& a) {
  static bool configured = false;
  auto kern = normal_stream_kernel<B, V, R>;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int ld = 4 * ((a.n + 3) / 4);
  const size_t bytes = kBarBytes + kRedBytes + (size_t)a.stages * R * ld * 4;
  kern<<<a.N * a.ctas, kThreads, bytes, a.st>>>(a.A, a.P, a.shift, a.part,
                                                a.out, a.m, a.n, a.ctas,
                                                a.stages);
  return cudaGetLastError();
}

// Instantiated where a tile's R x VPT float4s a thread reads stay within
// kMaxTileVecs (no register spills; the plan never asks for more).
template <bool B, int V, int R>
cudaError_t if_fits(const Args& a) {
  if constexpr (V * R <= kMaxTileVecs) return launch_stream<B, V, R>(a);
  else return cudaErrorInvalidValue;
}

template <bool B, int V>
cudaError_t by_rows(int rows, const Args& a) {
  switch (rows) {
    case 1: return if_fits<B, V, 1>(a);
    case 2: return if_fits<B, V, 2>(a);
    case 4: return if_fits<B, V, 4>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool B, int V = 1>
cudaError_t by_vpt(int vpt, int rows, const Args& a) {
  if constexpr (V > kMaxVpt) {
    return cudaErrorInvalidValue;
  } else {
    if (vpt == V) return by_rows<B, V>(rows, a);
    return by_vpt<B, V + 1>(vpt, rows, a);
  }
}

}  // namespace

// A (N, m, n) row-major; p, out (N, n); shift: kind 0 = shift_val, 1 =
// *shift_ptr (0-d, on the device), 2 = shift_ptr[0 .. n) for every node.
// m == 0 (ctas 0): out = shift (.) p, one launch of the sum kernel, A
// unread. Otherwise the stream kernel on N * ctas CTAs of kThreads threads,
// tiles of `rows` rows in `stages` stages, each thread owning `vpt` float4
// column chunks (4 kThreads vpt >= n); bulk = 1: one cp.async.bulk a tile
// (n % 4 == 0, A 16-byte aligned); rows x vpt <= kMaxTileVecs. ctas == 1:
// one launch, the stream kernel
// writes out; ctas > 1: part (N, ctas, n) takes the CTAs' partials and the
// sum kernel adds them: two launches. Returns cudaGetLastError().
extern "C" int normal_matvec_f32(const float* A, const float* p,
                                 const float* shift_ptr, float shift_val,
                                 int shift_kind, float* part, float* out,
                                 int N, int m, int n, int bulk, int vpt,
                                 int rows, int stages, int ctas,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shift shift{shift_ptr, shift_val, shift_kind};
  if (N < 1 || n < 1 || m < 0 || shift_kind < 0 || shift_kind > 2)
    return (int)cudaErrorInvalidValue;
  if (m == 0) ctas = 0;
  if (m > 0) {
    const int n4 = (n + 3) / 4;
    if (ctas < 1 || vpt < 1 || vpt > kMaxVpt || n4 > kThreads * vpt ||
        rows < 1 || rows > kMaxRows || stages < 2 || stages > kMaxStages ||
        (long long)stages * rows * n4 * 16 > kRingBytes ||
        (bulk && (n % 4 != 0 || reinterpret_cast<uintptr_t>(A) % 16 != 0)))
      return (int)cudaErrorInvalidValue;
    const Args a{A, p, shift, part, out, N, m, n, stages, ctas, st};
    const cudaError_t err = bulk ? by_vpt<true>(vpt, rows, a)
                                 : by_vpt<false>(vpt, rows, a);
    if (err != cudaSuccess || ctas == 1) return (int)err;
  }
  const long long count = (long long)N * n;
  normal_sum_kernel<<<(unsigned)((count + kSumCols - 1) / kSumCols),
                      kSumThreads, 0, st>>>(part, p, shift, out, N, n, ctas);
  return (int)cudaGetLastError();
}
