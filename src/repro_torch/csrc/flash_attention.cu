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
// cores (flash_mma_kernel, mma.sync; wgmma and TMA are a later change).
// f32 operands run on the CUDA cores (flash_fwd_kernel, the 67 TFLOP/s f32
// rate at 700 W), where they keep the f32 parity.
//
// Both kernels: one block per (query row b, 64-row query tile), the longest
// causal tiles launched first; for each 64-key tile up to the diagonal (tiles
// wholly above it are never visited) the scores, then an online softmax with
// each row's max and sum taken by butterfly shuffles among the lanes that
// hold the row (the same value in every lane: no float atomics, a fixed order
// for every row), then the P V product. Keys past Sk and query rows past Sq
// are masked inside the kernel (V past Sk is staged as 0): no padded copy of
// q, k or v.
//
// flash_fwd_kernel: 256 threads; the Q tile staged once in shared memory,
// transposed; K^T staged per tile and every thread forms a
// 4 x 4 block of scores from 16-byte shared-memory reads; the 16 threads that
// share four query rows are one half-warp; the probabilities go through a
// per-warp slice of shared memory to the P V product, for which V replaces
// K^T in the same buffer. Each thread keeps its four rows' running max,
// denominator and Dh/16 output columns in registers.
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
// bf16 operands: the same function on the tensor cores (mma.sync m16n8k16).
// One block of 4 warps per (query row b, 64-row query tile), each warp
// owning 16 query rows; Q, K and V tiles are staged in shared memory as
// bf16 (rows padded by 16 bytes, so ldmatrix reads them without bank
// conflicts) and read into mma fragments by ldmatrix (V transposed). Scores
// come out of the tensor cores in f32 (bf16 products are exact in f32), the
// running max, denominator and accumulator stay in f32 registers, and a row's
// max and sum are butterfly shuffles over the 4 lanes that hold it. P enters
// the P V product as a bf16 high part plus a bf16 low part (two mma each),
// so P keeps about 16 bits instead of bf16's 8: the product stays near the
// f32 computation of the TPU kernel.
constexpr int kMmaThreads = 128;

template <int DH>
constexpr int mma_smem_bytes() { return 3 * BQ * (DH + 8) * 2; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(const __nv_bfloat16* p,
                                        unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(const __nv_bfloat16* p,
                                              unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row-major fragment) * b (16 x 8, column fragment b0 b1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Rows [r0, r0 + 64) of a (n, DH) bf16 matrix into shared memory with row
// stride DH + 8, 16 bytes a thread at a time; rows past n are zero.
template <int DH>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int n) {
  constexpr int CH = DH / 8;
  for (int c = threadIdx.x; c < BQ * CH; c += kMmaThreads) {
    const int r = c / CH, j = c % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * DH +
                                            j * 8);
    *reinterpret_cast<uint4*>(dst + r * (DH + 8) + j * 8) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int Sq, int Sk, int group,
                 float scale, int causal) {
  constexpr int LD = DH + 8, KC = DH / 16, NO = DH / 8, NS = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // longest rows first
  const int bh = blockIdx.y;
  const __nv_bfloat16* kp = k + (size_t)(bh / group) * Sk * DH;
  const __nv_bfloat16* vp = v + (size_t)(bh / group) * Sk * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;     // fragment row, lane in quad
  const int mi = lane >> 3, mr = lane & 7;    // ldmatrix matrix and row
  const int row0 = q0 + warp * 16 + g;        // rows row0 and row0 + 8

  stage_tile<DH>(Qs, q + (size_t)bh * Sq * DH, q0, Sq);
  __syncthreads();
  unsigned qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldsm_x4(Qs + (warp * 16 + mr + (mi & 1) * 8) * LD + kc * 16 +
                (mi >> 1) * 8, qf[kc]);

  float acc[NO][4], m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int q_last = min(q0 + BQ, Sq) - 1;
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, q_last / BK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();                    // the last tile's K and V are read
    stage_tile<DH>(Ks, kp, k0, Sk);
    stage_tile<DH>(Vs, vp, k0, Sk);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned b[4];
        ldsm_x4(Ks + (np * 16 + mr + (mi >> 1) * 8) * LD + kc * 16 +
                    (mi & 1) * 8, b);
        mma_bf16(s[2 * np], qf[kc], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kc], b[2], b[3]);
      }
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale;
        if (masked) {
          const int key = k0 + n * 8 + tq * 2 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= Sk || (causal && key > row)) s[n][e] = kNegInf;
        }
      }

    // Online softmax of rows row0 (h = 0) and row0 + 8 (h = 1): each lane
    // of a quad holds 16 of a row's 64 scores.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float corr = expf(m[h] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][2 * h] = expf(s[n][2 * h] - m_new);
        s[n][2 * h + 1] = expf(s[n][2 * h + 1] - m_new);
        ps += s[n][2 * h] + s[n][2 * h + 1];
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      lsum[h] = lsum[h] * corr + ps;
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][2 * h] *= corr;
        acc[j][2 * h + 1] *= corr;
      }
    }

    // acc += P V over the tile's keys, 16 at a time: the score fragments
    // of two adjacent 8-key tiles are the P fragment of 16 keys.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      unsigned ph[4], pl[4];
      split_bf16(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int jp = 0; jp < NO / 2; ++jp) {
        unsigned b[4];
        ldsm_x4_trans(Vs + (kc * 16 + mr + (mi & 1) * 8) * LD + jp * 16 +
                          (mi >> 1) * 8, b);
        mma_bf16(acc[2 * jp], ph, b[0], b[1]);
        mma_bf16(acc[2 * jp], pl, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], ph, b[2], b[3]);
        mma_bf16(acc[2 * jp + 1], pl, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row >= Sq) continue;
    const float denom = fmaxf(lsum[h], 1e-30f);
    __nv_bfloat16* op = o + ((size_t)bh * Sq + row) * DH + tq * 2;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * h] / denom, acc[j][2 * h + 1] / denom);
  }
}

// Which kernel takes an operand type: the CUDA-core kernel for f32, the
// tensor-core kernel for bf16.
template <typename T, int DH>
struct Route {
  static constexpr int kBytes = smem_floats<DH>() * (int)sizeof(float);
  static constexpr int kBlock = kThreads;
  static auto kernel() { return flash_fwd_kernel<DH>; }
};

template <int DH>
struct Route<__nv_bfloat16, DH> {
  static constexpr int kBytes = mma_smem_bytes<DH>();
  static constexpr int kBlock = kMmaThreads;
  static auto kernel() { return flash_mma_kernel<DH>; }
};

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, void* o, int bh,
              int sq, int sk, int group, float scale, int causal,
              void* stream) {
  using R = Route<T, DH>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        R::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  const auto kernel = R::kernel();
  kernel<<<grid, R::kBlock, R::kBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, group, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int dh, int group, float scale, int causal,
           void* stream) {
#define FLASH_DH(D)                                                     \
  case D:                                                               \
    return launch_dh<T, D>(q, k, v, o, bh, sq, sk, group, scale, causal, \
                           stream)
  switch (dh) {
    FLASH_DH(16);
    FLASH_DH(32);
    FLASH_DH(64);
    FLASH_DH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_DH
}

}  // namespace

// q (bh, sq, dh), k and v (bh / group, sk, dh), o (bh, sq, dh), all
// contiguous; dh in {16, 32, 64, 128}. One kernel launch. Returns
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
