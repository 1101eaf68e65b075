// Ladder statistics of the sort-free exact projections, for a whole ladder
// of B candidate thresholds in one pass over |z|:
//
//   out[0, b] = sum_i max(az_i - theta_b, 0)      (f32)
//   out[1, b] = #{i : az_i > theta_b}             (int32, written as f32;
//                                                  exact up to 2^24)
//
// Replaces: src/repro/kernels/bisect_proj.py, _ladder_kernel (the TPU
// kernel) and _ladder_kernel_gpu (its Pallas-Triton twin).
//
// What bounds it on an H100: the operations, a compare and an add or two
// for each (entry, rung) pair: at the composed path's n = 409,601 and
// B = 128 that is 5.2e7 pairs (3.1 us at the f32 rate) against 1.6 MB read
// (0.5 us). Past that, a launch and a cross-CTA reduction. The design:
//
// * One launch: a grid sized to the card (at most one CTA an SM, the
//   wrapper's plan; kernels/bisect_proj.py, stats_plan), CTA c owning the
//   contiguous slice [c * per_cta, (c + 1) * per_cta) of az.
// * Each CTA stages its slice in shared memory (in pieces of kPiece
//   entries, padded with -inf), and the ladder beside it. R = 1024 / B
//   threads take each rung (R = 1 past B = 512, a thread looping over its
//   rungs past B = 1024), each over every R-th float4 of the piece: the
//   threads of a warp read the same word (a broadcast) or neighbouring
//   ones. A pair costs a compare, a predicated add of az and a predicated
//   count: the sum is formed as sum_{az > th} az - th * count.
// * Sums: a thread adds its terms of a piece in four f32 accumulators, then
//   into f64; the R threads of a rung are added in thread order, the CTAs'
//   partials in CTA order by the last CTA to arrive (a ticket from a
//   counter it resets), all in f64, and each sum is rounded to f32 once.
//   Counts are int32 and exact. The order is fixed, so the output is the
//   same bits run to run, with no float atomics.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kPiece = 4096;     // az entries a CTA stages at a time
constexpr int kMaxRungs = 8192;  // B: the ladder sits in shared memory
constexpr int kLoads = 8;        // partials a thread of the last CTA loads
                                 // at once

__global__ void __launch_bounds__(kThreads, 1)
ladder_kernel(const float* __restrict__ az, const float* __restrict__ th,
              int n, int B, int per_cta, double* __restrict__ psum,
              int* __restrict__ pcnt, unsigned* __restrict__ ticket,
              float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_az = reinterpret_cast<float4*>(smem);               // kPiece
  double* s_sum = reinterpret_cast<double*>(s_az + kPiece / 4);  // kThreads
  int* s_cnt = reinterpret_cast<int*>(s_sum + kThreads);         // kThreads
  float* s_th = reinterpret_cast<float*>(s_cnt + kThreads);      // B
  __shared__ bool s_last;
  const int t = threadIdx.x;
  for (int b = t; b < B; b += kThreads) s_th[b] = th[b];

  const long long start = (long long)blockIdx.x * per_cta;
  const int len = (int)max(0LL, min((long long)per_cta, n - start));
  const int width = min(B, kThreads);          // rungs a pass
  const int R = kThreads / width;              // threads a rung
  const int q = t / width;                     // this thread's share
  const bool resident = len <= kPiece;
  // piece [p0, p0 + plen) of the slice into shared memory, -inf past it up
  // to the next float4
  const auto stage = [&](int p0, int plen) {
    float* s = reinterpret_cast<float*>(s_az);
    for (int i = t; i < (plen + 3) / 4 * 4; i += kThreads)
      s[i] = i < plen ? az[start + p0 + i] : -INFINITY;
  };
  if (resident) stage(0, len);
  // each rung's R partials (S, C), thread r * width + b holding share r,
  // added in share order into thread b
  const auto across = [&](double& S, int& C) {
    if (R == 1) return;
    __syncthreads();                  // s_sum and s_cnt are free
    s_sum[t] = S;
    s_cnt[t] = C;
    __syncthreads();
    if (t < width) {
      S = 0.0;
      C = 0;
      for (int r = 0; r < R; ++r) {
        S += s_sum[r * width + t];
        C += s_cnt[r * width + t];
      }
    }
  };

  for (int b0 = 0; b0 < B; b0 += kThreads) {   // one pass up to B = 1024
    const int b = b0 + t % width;
    const bool on = q < R && b < B;
    double S = 0.0;
    int C = 0;
    __syncthreads();                  // s_th, a resident slice staged
    const float tb = on ? s_th[b] : 0.f;
    for (int p0 = 0; p0 < len; p0 += kPiece) {
      const int plen = min(kPiece, len - p0);
      if (!resident) {
        __syncthreads();              // the previous piece is read
        stage(p0, plen);
        __syncthreads();
      }
      if (on) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
        for (int u = q; u < (plen + 3) / 4; u += R) {
          const float4 v = s_az[u];
          if (v.x > tb) { s0 += v.x; ++c0; }
          if (v.y > tb) { s1 += v.y; ++c1; }
          if (v.z > tb) { s2 += v.z; ++c2; }
          if (v.w > tb) { s3 += v.w; ++c3; }
        }
        S += ((double)s0 + (double)s1) + ((double)s2 + (double)s3);
        C += (c0 + c1) + (c2 + c3);
      }
    }
    across(S, C);
    if (t < width && b < B) {
      psum[(size_t)blockIdx.x * B + b] = S;
      pcnt[(size_t)blockIdx.x * B + b] = C;
    }
  }

  // the last CTA to arrive adds every CTA's partials in CTA order
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int G = gridDim.x;
  for (int b0 = 0; b0 < B; b0 += kThreads) {
    // R threads a rung, each over a contiguous run of CTAs
    const int b = b0 + t % width;
    const bool on = q < R && b < B;
    const int c_lo = (int)((long long)G * q / R);
    const int c_hi = (int)((long long)G * (q + 1) / R);
    double S = 0.0;
    int C = 0;
    if (on)
      for (int c0 = c_lo; c0 < c_hi; c0 += kLoads) {
        // kLoads partials' loads in flight, then added in CTA order
        double v[kLoads];
        int w[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const bool in = c0 + j < c_hi;
          v[j] = in ? __ldcg(&psum[(size_t)(c0 + j) * B + b]) : 0.0;
          w[j] = in ? __ldcg(&pcnt[(size_t)(c0 + j) * B + b]) : 0;
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          S += v[j];
          C += w[j];
        }
      }
    across(S, C);
    if (t < width && b < B) {
      out[b] = (float)(S - (double)s_th[b] * (double)C);
      out[B + b] = (float)C;
    }
  }
  if (t == 0) *ticket = 0u;           // every CTA has taken its ticket
}

}  // namespace

// az (n,) and th (B,) f32 on the device; ctas CTAs of per_cta entries each
// (ctas * per_cta >= n; kernels/bisect_proj.py, stats_plan); psum (ctas,
// B) f64 and pcnt (ctas, B) int32 scratch; ticket one unsigned, 0 before
// the call and after it; out (2, B) f32. One launch. Returns
// cudaGetLastError().
extern "C" int ladder_stats_f32(const float* az, const float* th, int n,
                                int B, int ctas, int per_cta, double* psum,
                                int* pcnt, unsigned* ticket, float* out,
                                void* stream) {
  const int smem = (int)(kPiece * sizeof(float)
                         + kThreads * (sizeof(double) + sizeof(int))
                         + B * sizeof(float));
  if (smem > 48 * 1024) {         // a ladder past 5,120 rungs
    const cudaError_t err = cudaFuncSetAttribute(
        ladder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  ladder_kernel<<<ctas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      az, th, n, B, per_cta, psum, pcnt, ticket, out);
  return (int)cudaGetLastError();
}
