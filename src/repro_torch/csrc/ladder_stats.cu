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
// What bounds it on an H100: on the solver's path n = 10,000 and B = 128,
// so one call reads 40 KB and does ~4 M flops; the card finishes that in
// well under a microsecond, and the two launches' latency is the bound.
// The design keeps each launch short and the reduction deterministic:
//
// * Pass 1 (ladder_partial): each block stages a chunk of az in shared
//   memory with coalesced loads, and the ladder theta beside it. Thread t
//   owns rungs t, t + blockDim, ... and accumulates an f32 sum and an int32
//   count over the chunk (every thread reads the same az word at once, a
//   shared-memory broadcast). Each block writes its own (B,) sums and
//   counts. The ragged last chunk is cut at n, which is what the TPU
//   kernel's -inf data padding amounts to.
// * Pass 2 (ladder_reduce): one block sums the partials over blocks in a
//   fixed order — no float atomics, so the result is the same run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;     // az elements per block of pass 1
constexpr int kThreads = 128;   // one thread per rung at B = 128

__global__ void __launch_bounds__(kThreads)
ladder_partial(const float* __restrict__ az, const float* __restrict__ th,
               float* __restrict__ psum, int* __restrict__ pcnt, int n,
               int B) {
  extern __shared__ float smem[];
  float* s_az = smem;             // kChunk
  float* s_th = smem + kChunk;    // B
  const int start = blockIdx.x * kChunk;
  const int len = min(kChunk, n - start);
  for (int i = threadIdx.x; i < len; i += blockDim.x) s_az[i] = az[start + i];
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_th[b] = th[b];
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const float t = s_th[b];
    // four independent accumulators so the adds do not wait on each other
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    int i = 0;
    for (; i + 3 < len; i += 4) {
      const float d0 = s_az[i] - t, d1 = s_az[i + 1] - t;
      const float d2 = s_az[i + 2] - t, d3 = s_az[i + 3] - t;
      s0 += fmaxf(d0, 0.f); c0 += d0 > 0.f;
      s1 += fmaxf(d1, 0.f); c1 += d1 > 0.f;
      s2 += fmaxf(d2, 0.f); c2 += d2 > 0.f;
      s3 += fmaxf(d3, 0.f); c3 += d3 > 0.f;
    }
    for (; i < len; ++i) {
      const float d = s_az[i] - t;
      s0 += fmaxf(d, 0.f); c0 += d > 0.f;
    }
    const size_t o = (size_t)blockIdx.x * B + b;
    psum[o] = (s0 + s1) + (s2 + s3);
    pcnt[o] = (c0 + c1) + (c2 + c3);
  }
}

__global__ void __launch_bounds__(kThreads)
ladder_reduce(const float* __restrict__ psum, const int* __restrict__ pcnt,
              float* __restrict__ out, int nblocks, int B) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    float s = 0.f;
    int c = 0;
    for (int k = 0; k < nblocks; ++k) {
      s += psum[(size_t)k * B + b];
      c += pcnt[(size_t)k * B + b];
    }
    out[b] = s;
    out[B + b] = (float)c;
  }
}

}  // namespace

extern "C" int ladder_chunk() { return kChunk; }

// az (n,) and th (B,) f32 on the device; psum/pcnt (nblocks, B) scratch with
// nblocks = ceil(n / kChunk); out (2, B) f32. Returns cudaGetLastError().
extern "C" int ladder_stats_f32(const float* az, const float* th, float* psum,
                                int* pcnt, float* out, int n, int B,
                                int nblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nblocks > 0) {
    const size_t smem = (size_t)(kChunk + B) * sizeof(float);
    ladder_partial<<<nblocks, kThreads, smem, s>>>(az, th, psum, pcnt, n, B);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ladder_reduce<<<1, kThreads, 0, s>>>(psum, pcnt, out, nblocks, B);
  return (int)cudaGetLastError();
}
