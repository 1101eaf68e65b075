// The two exact sort-free projections of the Bi-cADMM (z, t) and s steps,
// each in ONE launch with no host read:
//
//   l1_proj_kernel — (z, t) = projection of (z0, t0) onto {||z||_1 <= t}
//   skappa_kernel  — (u_max, s*) = max over S^kappa of z^T s, and an argmax
//
// Replaces: src/repro/core/bilinear.py, ladder_refine (:177) as
// project_l1_epigraph (:249) runs it, and support_skappa_ladder (:409): the
// bracketing rounds of the ladder_stats TPU kernel
// (src/repro/kernels/bisect_proj.py:42) and the polish / pivot search
// around them, which the host drove op by op (~200 device ops and a host
// read every few steps per projection).
//
// What bounds it on an H100: at the solver's n = 1,000 to 12,000 one call
// reads 4-48 KB and does (2 rounds x 128 rungs + a few polish steps) x n
// compare-adds, a few Mflop: the card could finish in well under a
// microsecond. What it costs is one launch, then a chain of dependent
// reductions (one per round and per polish or search step), and the rung
// passes: each (entry, rung) term of an l1 round is converted to f64 for
// its sum, and sm_90 converts 16 a clock per SM (clock64 stamps: the
// passes are ~40 % of a call at n = 10,000 on 8 CTAs, the chain of
// barriers most of one at n = 1,000; PERF.md section 6). The design keeps
// that chain on chip:
//
// * |z| is read once into shared memory and stays there; the state (lo,
//   hi, theta, the step counter, done) lives in registers, the same in
//   every thread.
// * A reduction is a warp-shuffle tree, then the 32 warps' partials in
//   warp order, then the CTAs' partials in rank order: with C > 1 CTAs in
//   one thread-block cluster, thread 0 of every CTA reads every CTA's
//   partial through distributed shared memory after one cluster barrier
//   and hands the total to its CTA through shared memory, so each CTA
//   holds the same bits and takes the same branches. No float atomics, no
//   launch or host read inside the loops.
// * A bracketing round: thread t owns rung t % 128 over one eighth of the
//   CTA's |z| (a shared-memory broadcast read); the eight groups' partials
//   are added in group order.
//
// Numbers. The rungs, hv, propose and the pivot clamp are the plain
// version's f32 operations in its order (compiled with -fmad=false, so no
// a*b+c is contracted into one rounding). Counts are int32, exact. Every
// sum -- sum |z0|, each rung's sum max(|z| - th_b, 0), the polish's sum
// max(|z| - theta, 0), the S^kappa band sum and u_max -- adds f32 terms
// in f64 and is rounded to f32 once, so it is independent of the order
// except in rare f32 ties (the f64 sum is exact only while the terms'
// exponent spread plus log2 n fits in f64's 29 spare bits; past that the
// f64 rounding can flip the f32 result when it straddles an f32 boundary).
// So the result is, but for such ties, the same at every cluster size, and
// the plain version (kernels/ref.py) sums the same way. (An f32 sum in a
// fixed tree moved with the cluster size, and with it the card-vs-CPU
// parity fits' stopping iteration; PERF.md section 6.) s* depends on
// counts alone and equals the plain version's bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRungs = 128;                  // B, one rung a thread
constexpr int kGroups = kThreads / kRungs;   // |z| split eight ways a round
constexpr int kMaxPerCta = 51200;            // |z| entries a CTA holds
constexpr int kMaxCtas = 8;                  // the portable cluster size

// Phase stamps, in a measurement build only (-DLADDER_PROJ_TRACE, built by
// tools/ladder_proj_probe.py --trace): thread 0 of CTA 0 records clock64()
// and a code at each point below, and ladder_proj_trace() copies the last
// call's stamps out. The codes' names are in the probe.
enum Stamp {
  kStart, kLoaded,
  kReduceEnter, kReduceCta, kReduceBarrier, kReduceRead,
  kRoundEnter, kRoundRungs, kRoundPass, kRoundGroups, kRoundBarrier,
  kRoundCross,
  kOutput, kEnd
};
#ifdef LADDER_PROJ_TRACE
constexpr int kTraceMax = 4096;
__device__ long long g_trace_clock[kTraceMax];
__device__ int g_trace_code[kTraceMax];
__device__ int g_trace_n;
__device__ __forceinline__ void stamp(Stamp code) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const int i = code == kStart ? 0 : g_trace_n;
  if (i < kTraceMax) {
    g_trace_clock[i] = clock64();
    g_trace_code[i] = (int)code;
  }
  g_trace_n = i + 1;
}
#else
__device__ __forceinline__ void stamp(Stamp) {}
#endif

// One CTA's (and then the cluster's) partial of a reduction.
struct Part {
  double sum;
  int cnt[3];
  float mx;
};

struct Shared {
  float th[kRungs];                 // the round's rungs
  double gsum[kGroups][kRungs];     // per group, per rung
  int gcnt[kGroups][kRungs];
  double rsum[2][kRungs];           // this CTA's per-rung partials
  int rcnt[2][kRungs];              //   (double-buffered across rounds)
  int cross[kRungs / 32];
  Part wpart[kWarps];
  Part slot[2];                     // this CTA's partial (double-buffered)
  Part total[2];                    // the cluster's total (double-buffered)
};

// torch.maximum / torch.max: a NaN wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
// torch.minimum
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
// torch.clamp_min(d, 0.0): a NaN stays
__device__ __forceinline__ float clamp0(float d) { return d < 0.f ? 0.f : d; }
// torch.sign: sign(0) = 0
__device__ __forceinline__ float sgn(float x) {
  return (float)((0.f < x) - (x < 0.f));
}

template <int C>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (C > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

template <int C, typename T>
__device__ __forceinline__ T* at_rank(T* p, int r) {
  if constexpr (C > 1) {
    return cg::this_cluster().map_shared_rank(p, r);
  } else {
    return p;
  }
}

__device__ __forceinline__ Part warp_reduce(Part p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p.sum += __shfl_down_sync(0xffffffffu, p.sum, o);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      p.cnt[j] += __shfl_down_sync(0xffffffffu, p.cnt[j], o);
    }
    p.mx = nan_max(p.mx, __shfl_down_sync(0xffffffffu, p.mx, o));
  }
  return p;
}

__device__ __forceinline__ void add(Part& a, const Part& b) {
  a.sum += b.sum;
  a.cnt[0] += b.cnt[0];
  a.cnt[1] += b.cnt[1];
  a.cnt[2] += b.cnt[2];
  a.mx = nan_max(a.mx, b.mx);
}

// Every thread's partial -> the cluster's total, the same in every thread
// of every CTA: lanes, then warps in order, then CTAs in rank order.
template <int C>
__device__ Part reduce(Part p, Shared& sh, int& buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stamp(kReduceEnter);
  p = warp_reduce(p);
  if (lane == 0) sh.wpart[warp] = p;
  __syncthreads();
  stamp(kReduceCta);
  if (warp == 0) {
    Part q = warp_reduce(sh.wpart[lane]);
    if (lane == 0) sh.slot[buf] = q;
  }
  cluster_sync<C>();
  stamp(kReduceBarrier);
  if constexpr (C > 1) {
    // one thread reads the C partials (1,024 readers of each made this the
    // larger part of a reduction at 8 CTAs; PERF.md section 6)
    if (threadIdx.x == 0) {
      Part tot = *at_rank<C>(&sh.slot[buf], 0);
#pragma unroll
      for (int r = 1; r < C; ++r) add(tot, *at_rank<C>(&sh.slot[buf], r));
      sh.total[buf] = tot;
    }
    __syncthreads();
  }
  const Part tot = C > 1 ? sh.total[buf] : sh.slot[buf];
  stamp(kReduceRead);
  buf ^= 1;      // the next reduction writes the other slot
  return tot;
}

// One bracketing round over the rungs th_b = lo + (hi - lo) * (b + 1) / B
// (bilinear._bracket_rounds). kL1: the crossing test is
// hv_b = (sum_b - t0) - th_b > 0 (ladder_refine); else count_b > kappa
// (support_skappa_ladder), where only the counts are needed. On return
// [lo, hi] is the narrowed bracket.
template <int C, bool kL1>
__device__ void ladder_round(const float* zs, int len, float target,
                             float& lo, float& hi, Shared& sh, int& rbuf) {
  const int tid = threadIdx.x, b = tid % kRungs, g = tid / kRungs;
  stamp(kRoundEnter);
  __syncthreads();                 // the last round's readers of th are done
  if (tid < kRungs) {
    sh.th[tid] = lo + (hi - lo) * (float)(tid + 1) / (float)kRungs;
  }
  __syncthreads();
  stamp(kRoundRungs);
  const int per = (((len + kGroups - 1) / kGroups) + 3) & ~3;
  const int i0 = min(len, g * per), i1 = min(len, i0 + per);
  const float th = sh.th[b];
  double s = 0.0;
  int c = 0;
  int i = i0;
  for (; i + 3 < i1; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(zs + i);
    const float d0 = fabsf(v.x) - th, d1 = fabsf(v.y) - th;
    const float d2 = fabsf(v.z) - th, d3 = fabsf(v.w) - th;
    if (kL1) {             // l1 needs the sums, S^kappa the counts
      s += (double)clamp0(d0);
      s += (double)clamp0(d1);
      s += (double)clamp0(d2);
      s += (double)clamp0(d3);
    } else {
      c += (d0 > 0.f) + (d1 > 0.f) + (d2 > 0.f) + (d3 > 0.f);
    }
  }
  for (; i < i1; ++i) {
    const float d = fabsf(zs[i]) - th;
    if (kL1) {
      s += (double)clamp0(d);
    } else {
      c += d > 0.f;
    }
  }
  stamp(kRoundPass);
  sh.gsum[g][b] = s;
  sh.gcnt[g][b] = c;
  __syncthreads();
  if (tid < kRungs) {
    double ss = 0.0;
    int cc = 0;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      ss += sh.gsum[j][tid];
      cc += sh.gcnt[j][tid];
    }
    sh.rsum[rbuf][tid] = ss;
    sh.rcnt[rbuf][tid] = cc;
  }
  stamp(kRoundGroups);
  cluster_sync<C>();
  stamp(kRoundBarrier);
  if (tid < kRungs) {
    double ss = 0.0;
    int cc = 0;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      ss += at_rank<C>(&sh.rsum[rbuf][0], r)[tid];
      cc += at_rank<C>(&sh.rcnt[rbuf][0], r)[tid];
    }
    const bool flag = kL1 ? (((float)ss - target) - sh.th[tid]) > 0.f
                          : (float)cc > target;
    const unsigned m = __ballot_sync(0xffffffffu, flag);
    if ((tid & 31) == 0) sh.cross[tid >> 5] = __popc(m);
  }
  __syncthreads();
  int idx = 0;
#pragma unroll
  for (int w = 0; w < kRungs / 32; ++w) idx += sh.cross[w];
  stamp(kRoundCross);
  const float lo_n = idx == 0 ? lo : sh.th[idx - 1];
  const float hi_n = idx == kRungs ? hi : sh.th[idx];
  lo = lo_n;
  hi = hi_n;
  rbuf ^= 1;
}

// This CTA's slice of z: [rank * chunk, rank * chunk + len), into shared
// memory as it is (the sign is needed for the output).
__device__ __forceinline__ int load_slice(const float* __restrict__ z,
                                          float* zs, int n, int chunk,
                                          int rank) {
  const int start = rank * chunk;
  const int len = max(0, min(chunk, n - start));
  for (int i = threadIdx.x; i < len; i += kThreads) zs[i] = z[start + i];
  return len;
}

template <int C>
__device__ __forceinline__ int cta_rank() {
  if constexpr (C > 1) {
    return (int)cg::this_cluster().block_rank();
  } else {
    return 0;
  }
}

// (sum max(|z| - theta, 0) in f64; count(|z| > theta)) over the cluster.
template <int C>
__device__ Part point_stats(const float* zs, int len, float theta,
                            Shared& sh, int& buf) {
  Part p = {0.0, {0, 0, 0}, 0.f};
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const float d = fabsf(zs[i]) - theta;
    p.sum += (double)clamp0(d);
    p.cnt[0] += d > 0.f;
  }
  return reduce<C>(p, sh, buf);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
l1_proj_kernel(const float* __restrict__ z0, const float* __restrict__ t0p,
               float* __restrict__ z, float* __restrict__ t,
               float* __restrict__ theta_out, int* __restrict__ steps, int n,
               int chunk, int rounds, int cap) {
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);
  __shared__ Shared sh;
  stamp(kStart);
  const int rank = cta_rank<C>();
  const int len = load_slice(z0, zs, n, chunk, rank);
  stamp(kLoaded);
  const float t0 = *t0p;
  int buf = 0, rbuf = 0;

  // sum |z0| (f64) and max |z0|: the inside and apex tests
  Part p = {0.0, {0, 0, 0}, 0.f};
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const float a = fabsf(zs[i]);
    p.sum += (double)a;
    p.mx = nan_max(p.mx, a);
  }
  const Part tot = reduce<C>(p, sh, buf);
  const float abs_sum = (float)tot.sum, hi0 = tot.mx;
  const bool inside = abs_sum <= t0;
  const bool apex = (-t0 - hi0) > 0.f;

  // theta only matters outside both cases (the plain version selects it
  // away there), so the rounds and the polish run only then
  float theta = 0.f;
  int k = 0;
  if (!inside && !apex) {
    float lo = 0.f, hi = hi0;
    for (int r = 0; r < rounds; ++r) {
      ladder_round<C, true>(zs, len, t0, lo, hi, sh, rbuf);
    }
    // the monotone closed-form polish to its fixpoint (ladder_refine:
    // k = 1, (theta, prev) = (propose(lo), lo); step while theta > prev)
    float prev = lo;
    float th = lo;
    do {
      prev = th;
      const Part q = point_stats<C>(zs, len, th, sh, buf);
      const float hv = ((float)q.sum - t0) - th;
      th = nan_max(th + hv / ((float)q.cnt[0] + 1.f), th);
      ++k;
    } while (th > prev && k < cap);
    theta = th;
  }

  const bool to_apex = apex && !inside;
  float* out = z + (size_t)rank * chunk;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const float v = zs[i];
    out[i] = to_apex ? 0.f : sgn(v) * clamp0(fabsf(v) - theta);
  }
  stamp(kOutput);
  if (rank == 0 && threadIdx.x == 0) {
    *t = to_apex ? clamp0(t0) : t0 + theta;
    if (theta_out != nullptr) *theta_out = theta;
    if (steps != nullptr) *steps = k;
  }
  if constexpr (C > 1) cg::this_cluster().sync();  // no CTA leaves early
  stamp(kEnd);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
skappa_kernel(const float* __restrict__ zin, float kap,
              float* __restrict__ s_star, float* __restrict__ u_max,
              int* __restrict__ steps, int n, int chunk, int rounds,
              int cap) {
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);
  __shared__ Shared sh;
  stamp(kStart);
  const int rank = cta_rank<C>();
  const int len = load_slice(zin, zs, n, chunk, rank);
  stamp(kLoaded);
  int buf = 0, rbuf = 0;

  // max |z| and c0 = count(|z| > 0)
  Part p = {0.0, {0, 0, 0}, 0.f};
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const float a = fabsf(zs[i]);
    p.mx = nan_max(p.mx, a);
    p.cnt[0] += a > 0.f;
  }
  const Part init = reduce<C>(p, sh, buf);
  const float c0 = (float)init.cnt[0];
  const bool all_in = c0 <= kap;     // fewer than kappa nonzeros: tau* = 0

  float tau = 0.f, c_tau = c0, ceq = 0.f;
  int k = 0;
  if (!all_in) {
    float lo = 0.f, hi = init.mx;
    for (int r = 0; r < rounds; ++r) {
      ladder_round<C, false>(zs, len, kap, lo, hi, sh, rbuf);
    }
    // the mean-pivot search (support_skappa_ladder's while_loop)
    tau = hi;
    c_tau = 0.f;
    bool done = false;
    while (!done && k < cap) {
      Part q = {0.0, {0, 0, 0}, 0.f};           // (sum, count) in (lo, hi]
      for (int i = threadIdx.x; i < len; i += kThreads) {
        const float a = fabsf(zs[i]);
        if (a > lo && a <= hi) {
          q.sum += (double)a;
          q.cnt[0] += 1;
        }
      }
      q = reduce<C>(q, sh, buf);
      float a = (float)q.sum / fmaxf((float)q.cnt[0], 1.f);
      a = nan_min(nan_max(a, nextafterf(lo, INFINITY)), hi);
      const float am = nextafterf(a, -INFINITY);
      const float ap = nextafterf(a, INFINITY);
      Part r = {0.0, {0, 0, 0}, 0.f};
      for (int i = threadIdx.x; i < len; i += kThreads) {
        const float x = fabsf(zs[i]);
        r.cnt[0] += x > am;
        r.cnt[1] += x > a;
        r.cnt[2] += x > ap;
      }
      r = reduce<C>(r, sh, buf);
      const float cm = (float)r.cnt[0], ca = (float)r.cnt[1];
      const float cp = (float)r.cnt[2];
      const bool done1 = (cm > kap) && (kap >= ca);  // crossing in (am, a]
      const bool done2 = (ca > kap) && (kap >= cp);  // crossing in (a, ap]
      done = done1 || done2;
      tau = done2 ? ap : a;
      c_tau = done2 ? cp : ca;
      ceq = done2 ? ca - cp : cm - ca;
      const bool go_lo = !done && ca > kap;
      if (go_lo) lo = a;
      if (!done && !go_lo) hi = am;
      ++k;
    }
  }

  const float leftover = nan_min(clamp0(kap - c_tau), clamp0(ceq));
  const float bnd_w = ceq > 0.f ? leftover / ceq : 0.f;
  Part u = {0.0, {0, 0, 0}, 0.f};
  float* out = s_star + (size_t)rank * chunk;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const float v = zs[i], x = fabsf(v);
    const float above = x > tau ? 1.f : 0.f;
    const float at_tau = (x == tau && tau > 0.f) ? 1.f : 0.f;
    const float w = above + bnd_w * at_tau;
    out[i] = sgn(v) * w;
    u.sum += (double)(x * w);
  }
  stamp(kOutput);
  u = reduce<C>(u, sh, buf);
  if (rank == 0 && threadIdx.x == 0) {
    *u_max = (float)u.sum;
    if (steps != nullptr) *steps = k;
  }
  if constexpr (C > 1) cg::this_cluster().sync();  // no CTA leaves early
  stamp(kEnd);
}

__global__ void empty_kernel() {}

template <typename... Params, typename... Args>
int launch(void (*kern)(Params...), bool& configured, int ctas, int chunk,
           cudaStream_t stream, Args... args) {
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxPerCta * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)chunk * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The cluster size as a template argument (ctas in {1, 2, 4, 8}).
template <typename... Args>
int launch_l1(int ctas, int chunk, cudaStream_t s, Args... args) {
  static bool cfg[4] = {false, false, false, false};
  switch (ctas) {
    case 1: return launch(l1_proj_kernel<1>, cfg[0], 1, chunk, s, args...);
    case 2: return launch(l1_proj_kernel<2>, cfg[1], 2, chunk, s, args...);
    case 4: return launch(l1_proj_kernel<4>, cfg[2], 4, chunk, s, args...);
    case 8: return launch(l1_proj_kernel<8>, cfg[3], 8, chunk, s, args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename... Args>
int launch_skappa(int ctas, int chunk, cudaStream_t s, Args... args) {
  static bool cfg[4] = {false, false, false, false};
  switch (ctas) {
    case 1: return launch(skappa_kernel<1>, cfg[0], 1, chunk, s, args...);
    case 2: return launch(skappa_kernel<2>, cfg[1], 2, chunk, s, args...);
    case 4: return launch(skappa_kernel<4>, cfg[2], 4, chunk, s, args...);
    case 8: return launch(skappa_kernel<8>, cfg[3], 8, chunk, s, args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool valid(int n, int ctas) {
  return n >= 1 && ctas >= 1 && ctas <= kMaxCtas &&
         (n + ctas - 1) / ctas <= kMaxPerCta;
}

}  // namespace

extern "C" int ladder_proj_threads() { return kThreads; }
extern "C" int ladder_proj_rungs() { return kRungs; }
extern "C" int ladder_proj_max_per_cta() { return kMaxPerCta; }
extern "C" int ladder_proj_max_ctas() { return kMaxCtas; }

// z0 (n,) and t0 () f32 on the device -> z (n,), t (); theta (float) and
// steps (int), each may be null, get the threshold (0 inside and at the
// apex) and the polish steps taken. ctas in {1, 2, 4, 8} with
// ceil(n / ctas) <= ladder_proj_max_per_cta(). Returns a CUDA error code.
extern "C" int l1_epigraph_proj_f32(const float* z0, const float* t0,
                                    float* z, float* t, float* theta,
                                    int* steps, int n, int ctas, int rounds,
                                    int cap, void* stream) {
  if (!valid(n, ctas)) return (int)cudaErrorInvalidValue;
  const int chunk = (n + ctas - 1) / ctas;
  return launch_l1(ctas, chunk, static_cast<cudaStream_t>(stream), z0, t0,
                   z, t, theta, steps, n, chunk, rounds, cap);
}

// z (n,) f32 on the device and kappa -> s_star (n,), u_max (); steps (may
// be null) gets the search steps taken. Same ctas rule.
extern "C" int skappa_support_f32(const float* z, float kappa, float* s_star,
                                  float* u_max, int* steps, int n, int ctas,
                                  int rounds, int cap, void* stream) {
  if (!valid(n, ctas)) return (int)cudaErrorInvalidValue;
  const int chunk = (n + ctas - 1) / ctas;
  return launch_skappa(ctas, chunk, static_cast<cudaStream_t>(stream), z,
                       kappa, s_star, u_max, steps, n, chunk, rounds, cap);
}

#ifdef LADDER_PROJ_TRACE
// The last call's stamps (at most max): clock64() values and Stamp codes.
// Returns their number, or -1 on a CUDA error.
extern "C" int ladder_proj_trace(long long* clocks, int* codes, int max) {
  int n = 0;
  if (cudaDeviceSynchronize() != cudaSuccess ||
      cudaMemcpyFromSymbol(&n, g_trace_n, sizeof(int)) != cudaSuccess) {
    return -1;
  }
  n = n < max ? n : max;
  n = n < kTraceMax ? n : kTraceMax;
  if (cudaMemcpyFromSymbol(clocks, g_trace_clock, n * sizeof(long long)) !=
          cudaSuccess ||
      cudaMemcpyFromSymbol(codes, g_trace_code, n * sizeof(int)) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}
#endif

// An empty kernel: the launch latency the projections sit on.
extern "C" int ladder_proj_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
