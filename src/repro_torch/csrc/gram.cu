// Tiled Gram products, batched over up to two leading axes (nodes; the
// feature split's blocks), z running over both:
//
//   out[z, i, j] = sum_k X[z, k, i] * Y[z, k, j]      (X^T Y per entry z)
//
// X and Y are read through element strides, so A A^T comes from a transposed
// view of A (X = Y = A^T) with no copy of the data. The output is f32.
//
// Replaces: src/repro/kernels/gram.py, _gram_kernel (the TPU kernel) and
// _gram_kernel_gpu (its Pallas-Triton twin).
//
// What bounds it on an H100: the operations. Every caller on the solver's
// path asks for a symmetric product (X = Y), whose needed work is
// N * nx * (nx + 1) * m flops, half the full product's 2 * N * nx * ny * m:
// at the Woodbury set-up (N = 8 nodes, A A^T of 800 x 10,000 blocks) that is
// 5.1e10 flops against 256 MB (128 MB in bf16) read once. Two kernels:
//
// gram_xy_kernel -- f32 operands, f32 sums on the CUDA cores (67 TFLOP/s at
// 700 W). The port must hold f32 parity (rtol 1e-4 / atol 1e-5 x scale):
// TF32 tensor cores would break that bound.
// - 128 x 128 output tiles, 256 threads each owning an 8 x 8 register
//   micro-tile (rows 4ty..4ty+3 and 64+4ty..64+4ty+3, the same for columns),
//   so 64 FMAs are fed by four 16-byte shared-memory reads per k.
// - k-slices of 16 double-buffered in shared memory, one barrier a slice,
//   the next slice in flight while the current one is computed: by 16-byte
//   cp.async copies where the columns have unit stride and are 16-byte
//   aligned (the fig3 block views, the dense A^T A); otherwise (A A^T from
//   A^T, whose k axis has unit stride) loaded into registers by consecutive
//   threads along the unit-stride axis and stored after the current slice
//   is computed.
// - Every entry is one fmaf chain over k in ascending order, whatever the
//   tiling, batching or symmetry (fmaf(a, b, c) = fmaf(b, a, c), so a
//   mirrored entry is the full product's bit for bit).
//
// gram_dmma_kernel -- bf16 / fp16 operands (the reduced-precision presets'
// data) on the FP64 tensor cores (mma.sync f64, "DMMA"; wgmma has no
// f64 form): 67 TFLOP/s at 700 W. Each element is widened exactly to f64
// as its fragment is read, so every product of two elements is exact in f64
// and the DMMA sums them in f64; each entry is rounded to f32 once, at the
// store. That is the plain version's function (an f64 product rounded
// once), so the card's and the CPU's set-ups start from the same bits but
// for rare f32 ties. (With f32 sums the bf16 Woodbury card-vs-CPU parity
// fit read 125 iterations against the CPU's 121; PERF.md section 6.)
// - 64 x 64 output tiles, 4 warps of 32 x 32 (eight m16n8 tiles, 32 f64
//   accumulators a thread), k-slices of 32, m16n8k4 DMMAs.
// - The operands are staged in shared memory in their 2-byte form, each in
//   the layout of its unit-stride axis ([column][k] when k has unit stride,
//   as in A^T; else [k][column]), rows padded so a fragment read is free of
//   bank conflicts. Where that axis is 16-byte aligned and its extent a
//   multiple of 8, slices arrive by 16-byte cp.async copies in a ring of
//   4; otherwise (an odd width, a view 2 bytes past 16) through registers,
//   by consecutive threads along the unit-stride axis, double-buffered.
//   The wrapper picks the layouts and the path (kernels/gram.py,
//   half_path).
//
// Both kernels:
// - A symmetric product (the wrapper passes symmetric = 1 when X and Y are
//   the same operand) launches only the tiles on and above the diagonal
//   and writes each off-diagonal tile to both places.
// - The k reduction is not split across blocks: a split changes every
//   entry's rounding, and the solver's stopping iteration moves with it (a
//   split version moved the Woodbury card-vs-CPU parity fit of
//   chip_smoke.py from 121 to 123 iterations against the CPU's 120). The
//   card is filled instead by launching every node's (and, for the feature
//   split, every block's) tiles at once: two batch axes, blockIdx.z =
//   outer * n_inner + inner.
// - Ragged edges are masked with zeros on load and skipped on store.
#include <cstdint>

#include "elem.cuh"

namespace {

constexpr int TM = 128, BK = 16, kThreads = 256, LD = TM + 4;
constexpr int kPerThread = BK * TM / kThreads;      // slice elements a thread

// The (row, column) tile pair of tile index t: the upper triangle row by row
// when symmetric (tn x tn tiles), else row-major over tm x tn tiles.
__device__ __forceinline__ void tile_of(int t, int tn, int symmetric,
                                        int& bi, int& bj) {
  if (symmetric) {
    bi = 0;
    while (t >= tn - bi) {
      t -= tn - bi;
      ++bi;
    }
    bj = bi + t;
  } else {
    bi = t / tn;
    bj = t % tn;
  }
}

// Where thread tid's e-th element of a slice lies: (k, column) offsets
// (kk0 + e * dk, cc0 + e * dc) from the slice's corner, consecutive threads
// on the operand's unit-stride axis (k when sk == 1, else the column).
struct SliceWalk {
  int kk0, cc0, dk, dc;
  __device__ __forceinline__ explicit SliceWalk(bool k_fast)
      : kk0(k_fast ? threadIdx.x % BK : threadIdx.x / TM),
        cc0(k_fast ? threadIdx.x / BK : threadIdx.x % TM),
        dk(k_fast ? 0 : kThreads / TM),
        dc(k_fast ? kThreads / BK : 0) {}
};

// Slice [k0, k0 + BK) x columns [c0, c0 + TM) of one operand into registers,
// widened to f32, zero past m or nc: one base pointer and one step.
template <typename T>
__device__ __forceinline__ void load_regs(float (&r)[kPerThread],
                                          const T* src, const SliceWalk& w,
                                          int k0, int m, int c0, int nc,
                                          long long sk, long long sc) {
  const int k = k0 + w.kk0, c = c0 + w.cc0;
  const T* p = src + k * sk + c * sc;
  const long long step = w.dk * sk + w.dc * sc;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e)
    r[e] = (k + e * w.dk < m && c + e * w.dc < nc) ? widen(p[e * step])
                                                    : 0.f;
}

__device__ __forceinline__ void store_regs(float (*dst)[LD],
                                           const float (&r)[kPerThread],
                                           const SliceWalk& w) {
#pragma unroll
  for (int e = 0; e < kPerThread; ++e)
    dst[w.kk0 + e * w.dk][w.cc0 + e * w.dc] = r[e];
}

// The same slice of an f32 operand with unit column stride by 16-byte
// cp.async copies (nc % 4 == 0, so a 4-column chunk is wholly in or out;
// chunks out of range are zero-filled).
__device__ __forceinline__ void load_copy16(float (*dst)[LD], const float* src,
                                            int k0, int m, int c0, int nc,
                                            long long sk) {
#pragma unroll
  for (int e = 0; e < BK * TM / 4 / kThreads; ++e) {
    const int l = threadIdx.x + e * kThreads;
    const int kk = l / (TM / 4), c = c0 + (l % (TM / 4)) * 4, k = k0 + kk;
    const bool ok = k < m && c < nc;
    const float* g = ok ? src + k * sk + c : src;
    const unsigned s = static_cast<unsigned>(
        __cvta_generic_to_shared(&dst[kk][c - c0]));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(g), "r"(ok ? 16 : 0) : "memory");
  }
}

__device__ __forceinline__ void fma_slice(float (&acc)[8][8],
                                          const float (*Xs)[LD],
                                          const float (*Ys)[LD], int ty,
                                          int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&Xs[kk][4 * ty]);
    const float4 a1 = *reinterpret_cast<const float4*>(&Xs[kk][64 + 4 * ty]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Ys[kk][4 * tx]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Ys[kk][64 + 4 * tx]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// Local row (or column) of micro-tile entry r of thread coordinate t.
__device__ __forceinline__ int micro(int t, int r) {
  return (r < 4 ? 0 : 64) + 4 * t + (r & 3);
}

// f32 operands, two blocks an SM
template <typename T, bool COPY16>
__global__ void __launch_bounds__(kThreads, 2)
gram_xy_kernel(const T* __restrict__ X, const T* __restrict__ Y,
               float* __restrict__ out, int n_inner, int m, int nx, int ny,
               long long sxo, long long sxb, long long sxk, long long sxi,
               long long syo, long long syb, long long syk, long long syj,
               int symmetric) {
  __shared__ __align__(16) float Xs[2][BK][LD];
  __shared__ __align__(16) float Ys[2][BK][LD];
  const int z = blockIdx.z, zo = z / n_inner, zi = z % n_inner;
  int bi, bj;
  tile_of(blockIdx.x, (ny + TM - 1) / TM, symmetric, bi, bj);
  const int i0 = bi * TM, j0 = bj * TM;
  const int ns = (m + BK - 1) / BK;
  const T* Xb = X + zo * sxo + zi * sxb;
  const T* Yb = Y + zo * syo + zi * syb;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  if constexpr (COPY16) {
    // slice s into buffer b by cp.async, one commit group a slice
    const auto copy = [&](int b, int k0) {
      load_copy16(Xs[b], Xb, k0, m, i0, nx, sxk);
      load_copy16(Ys[b], Yb, k0, m, j0, ny, syk);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    if (ns > 0) copy(0, 0);
    for (int s = 0; s < ns; ++s) {
      // slice s has landed and every thread is past slice s - 1, whose
      // buffer the next copies overwrite
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (s + 1 < ns) copy((s + 1) & 1, (s + 1) * BK);
      fma_slice(acc, Xs[s & 1], Ys[s & 1], ty, tx);
    }
  } else {
    const SliceWalk wx(sxk == 1), wy(syk == 1);
    float rx[kPerThread], ry[kPerThread];
    if (ns > 0) {
      load_regs(rx, Xb, wx, 0, m, i0, nx, sxk, sxi);
      load_regs(ry, Yb, wy, 0, m, j0, ny, syk, syj);
      store_regs(Xs[0], rx, wx);
      store_regs(Ys[0], ry, wy);
    }
    for (int s = 0; s < ns; ++s) {
      __syncthreads();        // slice s is staged; slice s - 1 is read
      const bool more = s + 1 < ns;
      if (more) {
        load_regs(rx, Xb, wx, (s + 1) * BK, m, i0, nx, sxk, sxi);
        load_regs(ry, Yb, wy, (s + 1) * BK, m, j0, ny, syk, syj);
      }
      fma_slice(acc, Xs[s & 1], Ys[s & 1], ty, tx);
      if (more) {
        store_regs(Xs[(s + 1) & 1], rx, wx);
        store_regs(Ys[(s + 1) & 1], ry, wy);
      }
    }
  }

  float* o = out + (size_t)z * nx * ny;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + micro(ty, r);
    if (i >= nx) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + micro(tx, c);
      if (j < ny) o[(size_t)i * ny + j] = acc[r][c];
    }
  }
  if (symmetric && bi != bj) {          // the mirror tile (j, i)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + micro(tx, c);
      if (j >= nx) continue;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = i0 + micro(ty, r);
        if (i < nx) o[(size_t)j * nx + i] = acc[r][c];
      }
    }
  }
}

// ---- bf16 / fp16 operands on the FP64 tensor cores -----------------------

constexpr int HT = 64, HK = 32, kHalfThreads = 128, kStages = 4;
constexpr int LDK = HK + 8;     // [column][k] rows: 80 bytes, 16-byte aligned
constexpr int LDC = HT + 8;     // [k][column] rows: 144 bytes
constexpr int kHalfPerThread = HT * HK / kHalfThreads;   // slice elements
// path bits (kernels/gram.py, half_path): X's k axis has unit stride, Y's
// k axis has unit stride, both slices by 16-byte cp.async
constexpr int kXK = 1, kYK = 2, kVec = 4;

// One operand's staged slice: [column][k] when its k axis has unit stride
// (KF), else [k][column]; entry (k, c) of the slice.
template <bool KF>
__device__ __forceinline__ int at(int k, int c) {
  return KF ? c * LDK + k : k * LDC + c;
}
template <bool KF>
constexpr int kSliceElems = KF ? HT * LDK : HK * LDC;

// Slice [k0, k0 + HK) x columns [c0, c0 + HT) of one operand by 16-byte
// cp.async copies along its unit-stride axis (8 elements a copy, the
// extent a multiple of 8, so a copy is wholly in or out; out of range is
// zero-filled).
template <bool KF>
__device__ __forceinline__ void copy_slice(unsigned short* dst,
                                           const unsigned short* src, int k0,
                                           int m, int c0, int nc,
                                           long long sk, long long sc) {
#pragma unroll
  for (int e = 0; e < HT * HK / 8 / kHalfThreads; ++e) {
    const int l = threadIdx.x + e * kHalfThreads;
    // KF: 4 copies a column; else 8 copies a k row
    const int kk = KF ? (l % (HK / 8)) * 8 : l / (HT / 8);
    const int cc = KF ? l / (HK / 8) : (l % (HT / 8)) * 8;
    const int k = k0 + kk, c = c0 + cc;
    const bool ok = k < m && c < nc;
    const unsigned short* g = ok ? src + k * sk + c * sc : src;
    const unsigned s = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + at<KF>(kk, cc)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(g), "r"(ok ? 16 : 0) : "memory");
  }
}

// The same slice into registers (any strides), consecutive threads along
// the unit-stride axis, zero past m or nc; stored by store_slice.
template <bool KF>
struct HalfWalk {
  int kk0, cc0;
  static constexpr int dk = KF ? 0 : kHalfThreads / HT;
  static constexpr int dc = KF ? kHalfThreads / HK : 0;
  __device__ __forceinline__ HalfWalk()
      : kk0(KF ? threadIdx.x % HK : threadIdx.x / HT),
        cc0(KF ? threadIdx.x / HK : threadIdx.x % HT) {}
};

template <bool KF>
__device__ __forceinline__ void load_slice(
    unsigned short (&r)[kHalfPerThread], const unsigned short* src,
    const HalfWalk<KF>& w, int k0, int m, int c0, int nc, long long sk,
    long long sc) {
  const int k = k0 + w.kk0, c = c0 + w.cc0;
  const unsigned short* p = src + k * sk + c * sc;
  const long long step = HalfWalk<KF>::dk * sk + HalfWalk<KF>::dc * sc;
#pragma unroll
  for (int e = 0; e < kHalfPerThread; ++e)
    r[e] = (k + e * HalfWalk<KF>::dk < m && c + e * HalfWalk<KF>::dc < nc)
               ? p[e * step] : 0;
}

template <bool KF>
__device__ __forceinline__ void store_slice(
    unsigned short* dst, const unsigned short (&r)[kHalfPerThread],
    const HalfWalk<KF>& w) {
#pragma unroll
  for (int e = 0; e < kHalfPerThread; ++e)
    dst[at<KF>(w.kk0 + e * HalfWalk<KF>::dk, w.cc0 + e * HalfWalk<KF>::dc)] =
        r[e];
}

// Entry (k, c) of a staged slice, widened exactly to f64.
template <typename T, bool KF>
__device__ __forceinline__ double frag(const unsigned short* s, int k,
                                       int c) {
  return static_cast<double>(from_bits<T>(s[at<KF>(k, c)]));
}

// The DMMA shape: m16n8k4. Hopper's f64 mma.sync shapes are m8n8k4,
// m16n8k4, m16n8k8 and m16n8k16; tools/gram_ladder_probe.py times each:
// m8n8k4 ran at half the rate, m16n8k8 / k16 within a few per cent of
// m16n8k4 with more registers (spills at k8); PERF.md section 6.
// A thread's fragments, g = lane / 4 and q = lane % 4: A element i at row
// g + 8 (i % (M / 8)), k = q + 4 (i / (M / 8)); B element i at k = q + 4 i,
// column g; C element i at row g + 8 (i / 2), column 2 q + i % 2.
constexpr int kMmaM = 16, kMmaK = 4;
constexpr int kTilesM = 32 / kMmaM, kTilesN = 4;       // a warp's 32 x 32
constexpr int kAElems = kMmaM * kMmaK / 32, kBElems = kMmaK / 4;
constexpr int kCElems = kMmaM / 4;

template <int M, int K>
__device__ __forceinline__ void mma(double (&c)[M / 4],
                                    const double (&a)[M * K / 32],
                                    const double (&b)[K / 4]) {
  if constexpr (M == 8) {
    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
        : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
  } else if constexpr (K == 4) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else if constexpr (K == 8) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
          "d"(b[1]));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
          "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
          "d"(b[2]), "d"(b[3]));
  }
}

// One k-slice into the warp's 32 x 32 accumulators: per kMmaK-deep step,
// the A fragments of its row tiles and the B fragments of its column
// tiles, widened, then kTilesM x kTilesN DMMAs.
template <typename T, bool XK, bool YK>
__device__ __forceinline__ void dmma_slice(
    double (&acc)[kTilesM][kTilesN][kCElems], const unsigned short* Xs,
    const unsigned short* Ys, int wi, int wj) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < HK; kk += kMmaK) {
    double a[kTilesM][kAElems], b[kTilesN][kBElems];
#pragma unroll
    for (int t = 0; t < kTilesM; ++t)
#pragma unroll
      for (int i = 0; i < kAElems; ++i)
        a[t][i] = frag<T, XK>(Xs, kk + q + 4 * (i / (kMmaM / 8)),
                              wi + kMmaM * t + g + 8 * (i % (kMmaM / 8)));
#pragma unroll
    for (int t = 0; t < kTilesN; ++t)
#pragma unroll
      for (int i = 0; i < kBElems; ++i)
        b[t][i] = frag<T, YK>(Ys, kk + q + 4 * i, wj + 8 * t + g);
#pragma unroll
    for (int ti = 0; ti < kTilesM; ++ti)
#pragma unroll
      for (int tj = 0; tj < kTilesN; ++tj)
        mma<kMmaM, kMmaK>(acc[ti][tj], a[ti], b[tj]);
  }
}

template <typename T, bool XK, bool YK, bool VEC>
__global__ void __launch_bounds__(kHalfThreads, VEC ? 4 : 3)
gram_dmma_kernel(const unsigned short* __restrict__ X,
                 const unsigned short* __restrict__ Y,
                 float* __restrict__ out, int n_inner, int m, int nx, int ny,
                 long long sxo, long long sxb, long long sxk, long long sxi,
                 long long syo, long long syb, long long syk, long long syj,
                 int symmetric) {
  __shared__ __align__(16) unsigned short Xs[kStages][kSliceElems<XK>];
  __shared__ __align__(16) unsigned short Ys[kStages][kSliceElems<YK>];
  const int z = blockIdx.z, zo = z / n_inner, zi = z % n_inner;
  int bi, bj;
  tile_of(blockIdx.x, (ny + HT - 1) / HT, symmetric, bi, bj);
  const int i0 = bi * HT, j0 = bj * HT;
  const int ns = (m + HK - 1) / HK;
  const unsigned short* Xb = X + zo * sxo + zi * sxb;
  const unsigned short* Yb = Y + zo * syo + zi * syb;
  const int warp = threadIdx.x >> 5;
  const int wi = (warp >> 1) * 32, wj = (warp & 1) * 32;

  double acc[kTilesM][kTilesN][kCElems];
#pragma unroll
  for (int ti = 0; ti < kTilesM; ++ti)
#pragma unroll
    for (int tj = 0; tj < kTilesN; ++tj)
#pragma unroll
      for (int e = 0; e < kCElems; ++e) acc[ti][tj][e] = 0.0;

  if constexpr (VEC) {
    // slice s into stage s % kStages, one commit group a slice (empty
    // groups past the end keep the count uniform)
    const auto copy = [&](int s) {
      if (s < ns) {
        copy_slice<XK>(Xs[s % kStages], Xb, s * HK, m, i0, nx, sxk, sxi);
        copy_slice<YK>(Ys[s % kStages], Yb, s * HK, m, j0, ny, syk, syj);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) copy(s);
    for (int s = 0; s < ns; ++s) {
      // slice s has landed and every thread is past slice s - 1, whose
      // stage the next copy overwrites
      asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2)
                   : "memory");
      __syncthreads();
      copy(s + kStages - 1);
      dmma_slice<T, XK, YK>(acc, Xs[s % kStages], Ys[s % kStages], wi, wj);
    }
  } else {
    const HalfWalk<XK> wx;
    const HalfWalk<YK> wy;
    unsigned short rx[kHalfPerThread], ry[kHalfPerThread];
    if (ns > 0) {
      load_slice<XK>(rx, Xb, wx, 0, m, i0, nx, sxk, sxi);
      load_slice<YK>(ry, Yb, wy, 0, m, j0, ny, syk, syj);
      store_slice<XK>(Xs[0], rx, wx);
      store_slice<YK>(Ys[0], ry, wy);
    }
    for (int s = 0; s < ns; ++s) {
      __syncthreads();        // slice s is staged; slice s - 1 is read
      const bool more = s + 1 < ns;
      if (more) {
        load_slice<XK>(rx, Xb, wx, (s + 1) * HK, m, i0, nx, sxk, sxi);
        load_slice<YK>(ry, Yb, wy, (s + 1) * HK, m, j0, ny, syk, syj);
      }
      dmma_slice<T, XK, YK>(acc, Xs[s & 1], Ys[s & 1], wi, wj);
      if (more) {
        store_slice<XK>(Xs[(s + 1) & 1], rx, wx);
        store_slice<YK>(Ys[(s + 1) & 1], ry, wy);
      }
    }
  }

  // entry (ti, tj, e) of this thread: row wi + kMmaM ti + g + 8 (e / 2),
  // column wj + 8 tj + 2 q + e % 2 of the tile
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  float* o = out + (size_t)z * nx * ny;
#pragma unroll
  for (int ti = 0; ti < kTilesM; ++ti)
#pragma unroll
    for (int tj = 0; tj < kTilesN; ++tj)
#pragma unroll
      for (int e = 0; e < kCElems; ++e) {
        const int i = i0 + wi + kMmaM * ti + g + 8 * (e / 2);
        const int j = j0 + wj + 8 * tj + 2 * q + e % 2;
        if (i < nx && j < ny) {
          const float v = static_cast<float>(acc[ti][tj][e]);
          o[(size_t)i * ny + j] = v;
          if (symmetric && bi != bj) o[(size_t)j * nx + i] = v;   // mirror
        }
      }
}

template <typename T>
int launch_half(const void* x, const void* y, float* out, int n_outer,
                int n_inner, int m, int nx, int ny, long long sxo,
                long long sxb, long long sxk, long long sxi, long long syo,
                long long syb, long long syk, long long syj, int symmetric,
                int path, void* stream) {
  const int tm = (nx + HT - 1) / HT, tn = (ny + HT - 1) / HT;
  const dim3 grid(symmetric ? tn * (tn + 1) / 2 : tm * tn, 1,
                  n_outer * n_inner);
  // the instantiation of each path (bits kXK | kYK | kVec)
  const decltype(&gram_dmma_kernel<T, false, false, false>) kernel[8] = {
      gram_dmma_kernel<T, false, false, false>,
      gram_dmma_kernel<T, true, false, false>,
      gram_dmma_kernel<T, false, true, false>,
      gram_dmma_kernel<T, true, true, false>,
      gram_dmma_kernel<T, false, false, true>,
      gram_dmma_kernel<T, true, false, true>,
      gram_dmma_kernel<T, false, true, true>,
      gram_dmma_kernel<T, true, true, true>};
  kernel[path & (kXK | kYK | kVec)]<<<grid, kHalfThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(x),
      static_cast<const unsigned short*>(y), out, n_inner, m, nx, ny, sxo,
      sxb, sxk, sxi, syo, syb, syk, syj, symmetric);
  return (int)cudaGetLastError();
}

int launch_f32(const void* x, const void* y, float* out, int n_outer,
               int n_inner, int m, int nx, int ny, long long sxo,
               long long sxb, long long sxk, long long sxi, long long syo,
               long long syb, long long syk, long long syj, int symmetric,
               void* stream) {
  const int tm = (nx + TM - 1) / TM, tn = (ny + TM - 1) / TM;
  const dim3 grid(symmetric ? tn * (tn + 1) / 2 : tm * tn, 1,
                  n_outer * n_inner);
  const auto st = static_cast<cudaStream_t>(stream);
  const float* X = static_cast<const float*>(x);
  const float* Y = static_cast<const float*>(y);
  // 16-byte copies where the columns have unit stride and every group of 4
  // columns starts 16-byte aligned
  const auto a16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const bool copy16 = sxi == 1 && syj == 1 && nx % 4 == 0 && ny % 4 == 0 &&
                      sxk % 4 == 0 && syk % 4 == 0 && sxo % 4 == 0 &&
                      sxb % 4 == 0 && syo % 4 == 0 && syb % 4 == 0 &&
                      a16(x) && a16(y);
  if (copy16)
    gram_xy_kernel<float, true><<<grid, kThreads, 0, st>>>(
        X, Y, out, n_inner, m, nx, ny, sxo, sxb, sxk, sxi, syo, syb, syk, syj,
        symmetric);
  else
    gram_xy_kernel<float, false><<<grid, kThreads, 0, st>>>(
        X, Y, out, n_inner, m, nx, ny, sxo, sxb, sxk, sxi, syo, syb, syk, syj,
        symmetric);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n_outer, n_inner, m, nx) and y: (n_outer, n_inner, m, ny) given by
// element strides (outer, inner, k, col); out: (n_outer, n_inner, nx, ny)
// contiguous f32. symmetric = 1 only when x and y are the same operand
// (then nx == ny); path (bf16 / fp16 only): the bits kXK | kYK | kVec. One
// kernel launch. Returns cudaGetLastError().
extern "C" int gram_xy_f32(const void* x, const void* y, float* out,
                           int n_outer, int n_inner, int m, int nx, int ny,
                           long long sxo, long long sxb, long long sxk,
                           long long sxi, long long syo, long long syb,
                           long long syk, long long syj, int symmetric,
                           void* stream) {
  return launch_f32(x, y, out, n_outer, n_inner, m, nx, ny, sxo, sxb, sxk,
                    sxi, syo, syb, syk, syj, symmetric, stream);
}

#define GRAM_HALF_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* x, const void* y, float* out, int n_outer, \
                      int n_inner, int m, int nx, int ny, long long sxo,     \
                      long long sxb, long long sxk, long long sxi,           \
                      long long syo, long long syb, long long syk,           \
                      long long syj, int symmetric, int path, void* stream) {\
    return launch_half<T>(x, y, out, n_outer, n_inner, m, nx, ny, sxo, sxb,  \
                          sxk, sxi, syo, syb, syk, syj, symmetric, path,     \
                          stream);                                           \
  }

GRAM_HALF_ENTRY(gram_xy_bf16, __nv_bfloat16)
GRAM_HALF_ENTRY(gram_xy_f16, __half)
