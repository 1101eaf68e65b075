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
//
// The lane kernels (l1_lanes_kernel, skappa_lanes_kernel) project B
// independent vectors of one width d in ONE launch: row b of a (B, d)
// operand with its own t0[b] or kappa[b], read from device memory. They
// run the same algorithm, with the same f32 operations, as the solo
// kernels (one body, templated on the cluster size C and the threads a CTA
// T), so a lane's output is the solo kernel's on that row, but for the f32
// ties above (the rung sums' f64 order follows the layout). The layout
// follows d (kernels/bisect_proj.py, lane_plan): where plan(d) takes a
// cluster (d >= 1,000) each lane is that cluster of 1,024-thread CTAs, the
// lanes on gridDim.y; below it one CTA a lane, of 32 threads up to d = 64,
// 128 up to 256 and 1,024 beyond, so that a thread's share of a rung pass
// stays at most 256 terms (128 rungs / 32 threads x 64 entries, one rung x
// 256 entries, one rung x d / 8 < 125 entries) and a narrow lane does not
// hold a 1,024-thread CTA of which 98 % idles (d = 16: a warp a lane,
// 32 CTAs an SM). A grid's y extent is capped at 65,535; a CTA then takes
// lanes y, y + gridDim.y, ...
//
// The f64 KKT polish (precision "fp64_polish"; bilinear.ladder_refine's
// polish_dtype, src/repro/core/bilinear.py:177-233): l1_proj_kernel and
// l1_lanes_kernel take a template flag kF64. Its f32 instantiations are the
// code above, unchanged; in the f64 ones the bracketing rounds stay in f32,
// then theta, prev and hv are doubles: each polish term is (double)|z| -
// theta, summed in f64, the step th + hv / (count + 1) in f64, run while
// theta grows to the f64 fixpoint (capped as before), and theta is rounded to
// f32 once, before the soft threshold.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kRungs = 128;                  // B, one rung a thread
constexpr int kMaxLaneGrid = 65535;          // gridDim.y's limit
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
  if (threadIdx.x != 0 || blockIdx.x != 0 || blockIdx.y != 0) return;
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

// A CTA of T threads: its warps, and the groups that split |z| in a
// bracketing round (T >= 128: thread t owns rung t % 128 over one group's
// share of |z|; T < 128: one group, thread t owns rungs t, t + T, ...).
template <int T>
struct Layout {
  static constexpr int kWarps = T / 32;
  static constexpr int kGroups = T >= kRungs ? T / kRungs : 1;
};

template <int T>
struct Shared {
  float th[kRungs];                 // the round's rungs
  double gsum[Layout<T>::kGroups][kRungs];  // per group, per rung
  int gcnt[Layout<T>::kGroups][kRungs];
  double rsum[2][kRungs];           // this CTA's per-rung partials
  int rcnt[2][kRungs];              //   (double-buffered across rounds)
  int cross[kRungs / 32];
  Part wpart[Layout<T>::kWarps];
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
template <int C, int T>
__device__ Part reduce(Part p, Shared<T>& sh, int& buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stamp(kReduceEnter);
  p = warp_reduce(p);
  if (lane == 0) sh.wpart[warp] = p;
  __syncthreads();
  stamp(kReduceCta);
  if (warp == 0) {
    const Part none = {0.0, {0, 0, 0}, 0.f};
    Part q = warp_reduce(lane < Layout<T>::kWarps ? sh.wpart[lane] : none);
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
// One rung's sum max(|z| - th, 0) (kL1) or count(|z| > th) over
// zs[i0, i1), i0 a multiple of 4.
template <bool kL1>
__device__ __forceinline__ void rung_pass(const float* zs, int i0, int i1,
                                          float th, double& s, int& c) {
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
}

template <int C, int T, bool kL1>
__device__ void ladder_round(const float* zs, int len, float target,
                             float& lo, float& hi, Shared<T>& sh,
                             int& rbuf) {
  constexpr int kGroups = Layout<T>::kGroups;
  const int tid = threadIdx.x;
  stamp(kRoundEnter);
  __syncthreads();                 // the last round's readers of th are done
  for (int b = tid; b < kRungs; b += T) {
    sh.th[b] = lo + (hi - lo) * (float)(b + 1) / (float)kRungs;
  }
  __syncthreads();
  stamp(kRoundRungs);
  if constexpr (T >= kRungs) {
    const int b = tid % kRungs, g = tid / kRungs;
    const int per = (((len + kGroups - 1) / kGroups) + 3) & ~3;
    const int i0 = min(len, g * per), i1 = min(len, i0 + per);
    double s = 0.0;
    int c = 0;
    rung_pass<kL1>(zs, i0, i1, sh.th[b], s, c);
    stamp(kRoundPass);
    sh.gsum[g][b] = s;
    sh.gcnt[g][b] = c;
  } else {
    for (int b = tid; b < kRungs; b += T) {
      double s = 0.0;
      int c = 0;
      rung_pass<kL1>(zs, 0, len, sh.th[b], s, c);
      sh.gsum[0][b] = s;
      sh.gcnt[0][b] = c;
    }
    stamp(kRoundPass);
  }
  __syncthreads();
  for (int b = tid; b < kRungs; b += T) {
    double ss = 0.0;
    int cc = 0;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      ss += sh.gsum[j][b];
      cc += sh.gcnt[j][b];
    }
    sh.rsum[rbuf][b] = ss;
    sh.rcnt[rbuf][b] = cc;
  }
  stamp(kRoundGroups);
  cluster_sync<C>();
  stamp(kRoundBarrier);
  for (int b = tid; b < kRungs; b += T) {   // whole warps (kRungs % 32 == 0)
    double ss = 0.0;
    int cc = 0;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      ss += at_rank<C>(&sh.rsum[rbuf][0], r)[b];
      cc += at_rank<C>(&sh.rcnt[rbuf][0], r)[b];
    }
    const bool flag = kL1 ? (((float)ss - target) - sh.th[b]) > 0.f
                          : (float)cc > target;
    const unsigned m = __ballot_sync(0xffffffffu, flag);
    if ((b & 31) == 0) sh.cross[b >> 5] = __popc(m);
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
template <int T>
__device__ __forceinline__ int load_slice(const float* __restrict__ z,
                                          float* zs, int n, int chunk,
                                          int rank) {
  const int start = rank * chunk;
  const int len = max(0, min(chunk, n - start));
  for (int i = threadIdx.x; i < len; i += T) zs[i] = z[start + i];
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
template <int C, int T>
__device__ Part point_stats(const float* zs, int len, float theta,
                            Shared<T>& sh, int& buf) {
  Part p = {0.0, {0, 0, 0}, 0.f};
  for (int i = threadIdx.x; i < len; i += T) {
    const float d = fabsf(zs[i]) - theta;
    p.sum += (double)clamp0(d);
    p.cnt[0] += d > 0.f;
  }
  return reduce<C, T>(p, sh, buf);
}

// The same in f64 at a double theta: sum max((double)|z| - theta, 0) and
// count((double)|z| - theta > 0), the JAX polish's point_fn on |z| cast once
// to f64.
template <int C, int T>
__device__ Part point_stats64(const float* zs, int len, double theta,
                              Shared<T>& sh, int& buf) {
  Part p = {0.0, {0, 0, 0}, 0.f};
  for (int i = threadIdx.x; i < len; i += T) {
    const double d = (double)fabsf(zs[i]) - theta;
    p.sum += d < 0.0 ? 0.0 : d;
    p.cnt[0] += d > 0.0;
  }
  return reduce<C, T>(p, sh, buf);
}

__device__ __forceinline__ double nan_max64(double a, double b) {
  return (a > b || a != a) ? a : b;
}

// The l1-epigraph projection of one vector z0 (n,) by one CTA (C = 1) or
// one cluster of C CTAs of T threads: z (n,), *t and, where not null,
// *theta_out and *steps. zs is the CTA's dynamic shared memory, chunk the
// entries a CTA holds. kF64: the polish in f64 (header).
template <int C, int T, bool kF64>
__device__ __forceinline__ void l1_body(
    const float* __restrict__ z0, float t0, float* __restrict__ z,
    float* __restrict__ t, float* __restrict__ theta_out,
    int* __restrict__ steps, int n, int chunk, int rounds, int cap,
    float* zs, Shared<T>& sh) {
  const int rank = cta_rank<C>();
  const int len = load_slice<T>(z0, zs, n, chunk, rank);
  stamp(kLoaded);
  int buf = 0, rbuf = 0;

  // sum |z0| (f64) and max |z0|: the inside and apex tests
  Part p = {0.0, {0, 0, 0}, 0.f};
  for (int i = threadIdx.x; i < len; i += T) {
    const float a = fabsf(zs[i]);
    p.sum += (double)a;
    p.mx = nan_max(p.mx, a);
  }
  const Part tot = reduce<C, T>(p, sh, buf);
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
      ladder_round<C, T, true>(zs, len, t0, lo, hi, sh, rbuf);
    }
    // the monotone closed-form polish to its fixpoint (ladder_refine:
    // k = 1, (theta, prev) = (propose(lo), lo); step while theta > prev)
    if constexpr (kF64) {
      const double t0d = (double)t0;
      double prev = (double)lo;
      double th = prev;
      do {
        prev = th;
        const Part q = point_stats64<C, T>(zs, len, th, sh, buf);
        const double hv = (q.sum - t0d) - th;
        th = nan_max64(th + hv / ((double)q.cnt[0] + 1.0), th);
        ++k;
      } while (th > prev && k < cap);
      theta = (float)th;
    } else {
      float prev = lo;
      float th = lo;
      do {
        prev = th;
        const Part q = point_stats<C, T>(zs, len, th, sh, buf);
        const float hv = ((float)q.sum - t0) - th;
        th = nan_max(th + hv / ((float)q.cnt[0] + 1.f), th);
        ++k;
      } while (th > prev && k < cap);
      theta = th;
    }
  }

  const bool to_apex = apex && !inside;
  float* out = z + (size_t)rank * chunk;
  for (int i = threadIdx.x; i < len; i += T) {
    const float v = zs[i];
    out[i] = to_apex ? 0.f : sgn(v) * clamp0(fabsf(v) - theta);
  }
  stamp(kOutput);
  if (rank == 0 && threadIdx.x == 0) {
    *t = to_apex ? clamp0(t0) : t0 + theta;
    if (theta_out != nullptr) *theta_out = theta;
    if (steps != nullptr) *steps = k;
  }
  cluster_sync<C>();   // no CTA leaves early; zs and sh are free again
}

// The S^kappa support of one vector z (n,): s_star (n,), *u_max and, where
// not null, *steps; the layout as in l1_body.
template <int C, int T>
__device__ __forceinline__ void skappa_body(
    const float* __restrict__ zin, float kap, float* __restrict__ s_star,
    float* __restrict__ u_max, int* __restrict__ steps, int n, int chunk,
    int rounds, int cap, float* zs, Shared<T>& sh) {
  const int rank = cta_rank<C>();
  const int len = load_slice<T>(zin, zs, n, chunk, rank);
  stamp(kLoaded);
  int buf = 0, rbuf = 0;

  // max |z| and c0 = count(|z| > 0)
  Part p = {0.0, {0, 0, 0}, 0.f};
  for (int i = threadIdx.x; i < len; i += T) {
    const float a = fabsf(zs[i]);
    p.mx = nan_max(p.mx, a);
    p.cnt[0] += a > 0.f;
  }
  const Part init = reduce<C, T>(p, sh, buf);
  const float c0 = (float)init.cnt[0];
  const bool all_in = c0 <= kap;     // fewer than kappa nonzeros: tau* = 0

  float tau = 0.f, c_tau = c0, ceq = 0.f;
  int k = 0;
  if (!all_in) {
    float lo = 0.f, hi = init.mx;
    for (int r = 0; r < rounds; ++r) {
      ladder_round<C, T, false>(zs, len, kap, lo, hi, sh, rbuf);
    }
    // the mean-pivot search (support_skappa_ladder's while_loop)
    tau = hi;
    c_tau = 0.f;
    bool done = false;
    while (!done && k < cap) {
      Part q = {0.0, {0, 0, 0}, 0.f};           // (sum, count) in (lo, hi]
      for (int i = threadIdx.x; i < len; i += T) {
        const float a = fabsf(zs[i]);
        if (a > lo && a <= hi) {
          q.sum += (double)a;
          q.cnt[0] += 1;
        }
      }
      q = reduce<C, T>(q, sh, buf);
      float a = (float)q.sum / fmaxf((float)q.cnt[0], 1.f);
      a = nan_min(nan_max(a, nextafterf(lo, INFINITY)), hi);
      const float am = nextafterf(a, -INFINITY);
      const float ap = nextafterf(a, INFINITY);
      Part r = {0.0, {0, 0, 0}, 0.f};
      for (int i = threadIdx.x; i < len; i += T) {
        const float x = fabsf(zs[i]);
        r.cnt[0] += x > am;
        r.cnt[1] += x > a;
        r.cnt[2] += x > ap;
      }
      r = reduce<C, T>(r, sh, buf);
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
  for (int i = threadIdx.x; i < len; i += T) {
    const float v = zs[i], x = fabsf(v);
    const float above = x > tau ? 1.f : 0.f;
    const float at_tau = (x == tau && tau > 0.f) ? 1.f : 0.f;
    const float w = above + bnd_w * at_tau;
    out[i] = sgn(v) * w;
    u.sum += (double)(x * w);
  }
  stamp(kOutput);
  u = reduce<C, T>(u, sh, buf);
  if (rank == 0 && threadIdx.x == 0) {
    *u_max = (float)u.sum;
    if (steps != nullptr) *steps = k;
  }
  cluster_sync<C>();   // no CTA leaves early; zs and sh are free again
}

template <int C, bool kF64>
__global__ void __launch_bounds__(kThreads, 1)
l1_proj_kernel(const float* __restrict__ z0, const float* __restrict__ t0p,
               float* __restrict__ z, float* __restrict__ t,
               float* __restrict__ theta_out, int* __restrict__ steps, int n,
               int chunk, int rounds, int cap) {
  extern __shared__ float4 smem4[];
  __shared__ Shared<kThreads> sh;
  stamp(kStart);
  l1_body<C, kThreads, kF64>(z0, *t0p, z, t, theta_out, steps, n, chunk,
                             rounds, cap, reinterpret_cast<float*>(smem4),
                             sh);
  stamp(kEnd);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
skappa_kernel(const float* __restrict__ zin, float kap,
              float* __restrict__ s_star, float* __restrict__ u_max,
              int* __restrict__ steps, int n, int chunk, int rounds,
              int cap) {
  extern __shared__ float4 smem4[];
  __shared__ Shared<kThreads> sh;
  stamp(kStart);
  skappa_body<C, kThreads>(zin, kap, s_star, u_max, steps, n, chunk, rounds,
                           cap, reinterpret_cast<float*>(smem4), sh);
  stamp(kEnd);
}

// Lane b = blockIdx.y, blockIdx.y + gridDim.y, ... of a (lanes, n) operand:
// row b with t0[b]; z row b, t[b] and, where not null, theta[b], steps[b].
template <int C, int T, bool kF64>
__global__ void __launch_bounds__(T)
l1_lanes_kernel(const float* __restrict__ z0, const float* __restrict__ t0,
                float* __restrict__ z, float* __restrict__ t,
                float* __restrict__ theta, int* __restrict__ steps,
                int lanes, int n, int chunk, int rounds, int cap) {
  extern __shared__ float4 smem4[];
  __shared__ Shared<T> sh;
  for (int b = blockIdx.y; b < lanes; b += gridDim.y) {
    const size_t row = (size_t)b * n;
    l1_body<C, T, kF64>(z0 + row, t0[b], z + row, t + b,
                  theta == nullptr ? nullptr : theta + b,
                  steps == nullptr ? nullptr : steps + b, n, chunk, rounds,
                  cap, reinterpret_cast<float*>(smem4), sh);
  }
}

// The S^kappa support of each lane: row b of z with kappa[b]; s_star row b,
// u_max[b] and, where not null, steps[b].
template <int C, int T>
__global__ void __launch_bounds__(T)
skappa_lanes_kernel(const float* __restrict__ zin,
                    const float* __restrict__ kappa,
                    float* __restrict__ s_star, float* __restrict__ u_max,
                    int* __restrict__ steps, int lanes, int n, int chunk,
                    int rounds, int cap) {
  extern __shared__ float4 smem4[];
  __shared__ Shared<T> sh;
  for (int b = blockIdx.y; b < lanes; b += gridDim.y) {
    const size_t row = (size_t)b * n;
    skappa_body<C, T>(zin + row, kappa[b], s_star + row, u_max + b,
                      steps == nullptr ? nullptr : steps + b, n, chunk,
                      rounds, cap, reinterpret_cast<float*>(smem4), sh);
  }
}

__global__ void empty_kernel() {}

// A launch of ``kern`` on a grid of (ctas, ys) CTAs of ``threads`` threads
// in clusters of ``ctas`` along x, with chunk floats of dynamic shared
// memory (the attribute raised to kMaxPerCta floats on first use).
template <typename... Params, typename... Args>
int launch_grid(void (*kern)(Params...), bool& configured, int ctas, int ys,
                int threads, int chunk, cudaStream_t stream, Args... args) {
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxPerCta * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, ys);
  cfg.blockDim = dim3(threads);
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

template <typename... Params, typename... Args>
int launch(void (*kern)(Params...), bool& configured, int ctas, int chunk,
           cudaStream_t stream, Args... args) {
  return launch_grid(kern, configured, ctas, 1, kThreads, chunk, stream,
                     args...);
}

// The cluster size as a template argument (ctas in {1, 2, 4, 8}).
template <bool kF64, typename... Args>
int launch_l1(int ctas, int chunk, cudaStream_t s, Args... args) {
  static bool cfg[4] = {false, false, false, false};
  switch (ctas) {
    case 1:
      return launch(l1_proj_kernel<1, kF64>, cfg[0], 1, chunk, s, args...);
    case 2:
      return launch(l1_proj_kernel<2, kF64>, cfg[1], 2, chunk, s, args...);
    case 4:
      return launch(l1_proj_kernel<4, kF64>, cfg[2], 4, chunk, s, args...);
    case 8:
      return launch(l1_proj_kernel<8, kF64>, cfg[3], 8, chunk, s, args...);
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

// The lane kernels' layouts (ctas, threads): (1, 32), (1, 128) and
// (1, 2, 4 or 8, 1,024), each instantiation configured once; kF64 (l1
// only): the f64 polish.
template <bool kL1, bool kF64 = false, typename... Args>
int launch_lanes(int ctas, int threads, int ys, int chunk, cudaStream_t s,
                 Args... args) {
  static bool cfg[6] = {false, false, false, false, false, false};
#define LANES(C, T, I)                                                    \
  if constexpr (kL1) {                                                    \
    return launch_grid(l1_lanes_kernel<C, T, kF64>, cfg[I], C, ys, T,     \
                       chunk, s, args...);                                \
  } else {                                                                \
    return launch_grid(skappa_lanes_kernel<C, T>, cfg[I], C, ys, T,       \
                       chunk, s, args...);                                \
  }
  if (threads == 32 && ctas == 1) {
    LANES(1, 32, 0)
  }
  if (threads == 128 && ctas == 1) {
    LANES(1, 128, 1)
  }
  if (threads == kThreads) {
    switch (ctas) {
      case 1: LANES(1, kThreads, 2)
      case 2: LANES(2, kThreads, 3)
      case 4: LANES(4, kThreads, 4)
      case 8: LANES(8, kThreads, 5)
      default: break;
    }
  }
#undef LANES
  return (int)cudaErrorInvalidValue;
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
  return launch_l1<false>(ctas, chunk, static_cast<cudaStream_t>(stream), z0,
                          t0, z, t, theta, steps, n, chunk, rounds, cap);
}

// The same with the polish in f64 (precision "fp64_polish"): theta is the
// f64 fixpoint rounded to f32 once.
extern "C" int l1_epigraph_proj_f32_polish64(const float* z0, const float* t0,
                                             float* z, float* t, float* theta,
                                             int* steps, int n, int ctas,
                                             int rounds, int cap,
                                             void* stream) {
  if (!valid(n, ctas)) return (int)cudaErrorInvalidValue;
  const int chunk = (n + ctas - 1) / ctas;
  return launch_l1<true>(ctas, chunk, static_cast<cudaStream_t>(stream), z0,
                         t0, z, t, theta, steps, n, chunk, rounds, cap);
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

// Whether (ctas, threads) is a lane layout for n entries, and the entries
// a CTA holds.
static bool valid_lanes(int lanes, int n, int ctas, int threads) {
  return lanes >= 1 && valid(n, ctas) &&
         ((threads == kThreads) || (ctas == 1 && (threads == 32 ||
                                                  threads == 128)));
}

// z0 (lanes, n) row-major and t0 (lanes,) f32 on the device -> z (lanes, n),
// t (lanes,); theta (lanes,) and steps (lanes,), each may be null, as in
// l1_epigraph_proj_f32 per lane. (ctas, threads): (1, 32), (1, 128) or
// (1, 2, 4, 8 with ceil(n / ctas) <= ladder_proj_max_per_cta(), 1024).
extern "C" int l1_epigraph_proj_lanes_f32(const float* z0, const float* t0,
                                          float* z, float* t, float* theta,
                                          int* steps, int lanes, int n,
                                          int ctas, int threads, int rounds,
                                          int cap, void* stream) {
  if (!valid_lanes(lanes, n, ctas, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunk = (n + ctas - 1) / ctas;
  const int ys = lanes < kMaxLaneGrid ? lanes : kMaxLaneGrid;
  return launch_lanes<true>(ctas, threads, ys, chunk,
                            static_cast<cudaStream_t>(stream), z0, t0, z, t,
                            theta, steps, lanes, n, chunk, rounds, cap);
}

// The same with the polish in f64 on every lane.
extern "C" int l1_epigraph_proj_lanes_f32_polish64(
    const float* z0, const float* t0, float* z, float* t, float* theta,
    int* steps, int lanes, int n, int ctas, int threads, int rounds, int cap,
    void* stream) {
  if (!valid_lanes(lanes, n, ctas, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunk = (n + ctas - 1) / ctas;
  const int ys = lanes < kMaxLaneGrid ? lanes : kMaxLaneGrid;
  return launch_lanes<true, true>(ctas, threads, ys, chunk,
                                  static_cast<cudaStream_t>(stream), z0, t0,
                                  z, t, theta, steps, lanes, n, chunk, rounds,
                                  cap);
}

// z (lanes, n) and kappa (lanes,) f32 on the device -> s_star (lanes, n),
// u_max (lanes,); steps (lanes,) may be null. Layouts as above.
extern "C" int skappa_support_lanes_f32(const float* z, const float* kappa,
                                        float* s_star, float* u_max,
                                        int* steps, int lanes, int n,
                                        int ctas, int threads, int rounds,
                                        int cap, void* stream) {
  if (!valid_lanes(lanes, n, ctas, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunk = (n + ctas - 1) / ctas;
  const int ys = lanes < kMaxLaneGrid ? lanes : kMaxLaneGrid;
  return launch_lanes<false>(ctas, threads, ys, chunk,
                             static_cast<cudaStream_t>(stream), z, kappa,
                             s_star, u_max, steps, lanes, n, chunk, rounds,
                             cap);
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
