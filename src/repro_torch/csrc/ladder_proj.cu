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
// The lane kernels project B independent vectors of one width d in ONE
// launch: row b of a (B, d) operand with its own t0[b] or kappa[b], read
// from device memory. They run the solo kernels' body (l1_proj,
// skappa_proj, templated on the team of threads that runs it: CtaTeam,
// LaneWarp), so a lane's output is the solo kernel's on that row, but for
// the f32 ties above (the rung sums' f64 order follows the layout). The
// layout follows d (kernels/bisect_proj.py, lane_plan):
//
// * where plan(d) takes a cluster (d >= 1,000), and for d > 256, each lane
//   is that cluster of 1,024-thread CTAs running the solo body
//   (l1_lanes_kernel, skappa_lanes_kernel), the lanes on gridDim.y (capped
//   at 65,535; a CTA then takes lanes y, y + gridDim.y, ...);
// * up to d = 256 (kLaneWarpMaxN) the narrow layout (l1_warp_lanes_kernel,
//   skappa_warp_lanes_kernel): a warp a lane (`threads` 32, the threads a
//   lane, as when a lane was a CTA of that size), kLaneCtaWarps lanes a
//   CTA. The grid is persistent, sized to the card's residency (the CTAs
//   an SM holds by the occupancy calculator, times the SMs); warp w of CTA
//   c takes lanes w * gridDim.x + c, then every gridDim.x * warps further
//   (warp-major, so a second pass spreads over every CTA). While a warp
//   works on one lane, cp.async copies its next lane's row into the other
//   half of the warp's double-buffered rows in shared memory, and its t0 or
//   kappa into a register. Inside a lane no __syncthreads and no
//   shared-memory staging (a one-warp CTA of the solo body made 4 barriers
//   a round and 2 a reduction, and took a dependent row load at each
//   lane's start): the lane that owns rung b forms th_b in registers, the
//   crossing index is __ballot_sync + __popc over the rung flags, and each
//   reduction shuffles only the words its step reads (a xor butterfly,
//   every lane ending with lane 0's tree). The sums' order is the solo
//   body's on one 32-thread CTA: lane t's partial over entries t, t + 32,
//   ..., the warp's tree; each rung's f64 sum over the entries in order
//   (rungs t, t + 32, t + 64, t + 96 of lane t, interleaved over one
//   float4 read of the row). So a lane equals that layout's bit for bit
//   (tools/ladder_proj_probe.py --against holds it to an earlier source's
//   one-CTA lanes). What bounds it: the f32 -> f64 conversion of each
//   (rung, entry) term, 16 a clock an SM (PERF.md section 6). Measured on an
//   H100 and left out: four warps a lane (slower than one at d = 100 and
//   200), skipping a warp's terms that are 0 for all its rungs behind a
//   uniform branch (the same bits; more issue than it saved).
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
constexpr int kLaneCtaWarps = 8;             // warps a narrow lane CTA
constexpr int kLaneWarpMaxN = 256;           // the narrow layout's widest row
// CTAs an SM the narrow lane kernels are compiled for (64 registers): 2-3 %
// faster on an H100 than ptxas' own 50 registers (5 CTAs) or 6 CTAs' 40
// with spills (PERF.md section 6)
constexpr int kLaneMinCtas = 4;

// Phase stamps, in a measurement build only (-DLADDER_PROJ_TRACE, built by
// tools/ladder_proj_probe.py --trace): thread 0 of CTA 0 records clock64()
// and a code at each point below, and ladder_proj_trace() copies the last
// call's stamps out. The codes' names are in the probe. The narrow lane
// kernels' (kLaneStart on) are stamped by lane 0 of the warp that takes
// lane 0.
enum Stamp {
  kStart, kLoaded,
  kReduceEnter, kReduceCta, kReduceBarrier, kReduceRead,
  kRoundEnter, kRoundRungs, kRoundPass, kRoundGroups, kRoundBarrier,
  kRoundCross,
  kOutput, kEnd,
  kLaneStart, kLaneRow, kLanePass, kLaneReduce, kLaneRungs, kLaneVote,
  kLaneOutput, kLaneEnd
};
#ifdef LADDER_PROJ_TRACE
constexpr int kTraceMax = 4096;
__device__ long long g_trace_clock[kTraceMax];
__device__ int g_trace_code[kTraceMax];
__device__ int g_trace_n;
__device__ __forceinline__ void record(Stamp code) {
  const int i = (code == kStart || code == kLaneStart) ? 0 : g_trace_n;
  if (i < kTraceMax) {
    g_trace_clock[i] = clock64();
    g_trace_code[i] = (int)code;
  }
  g_trace_n = i + 1;
}
__device__ __forceinline__ void stamp(Stamp code) {
  if (threadIdx.x != 0 || blockIdx.x != 0 || blockIdx.y != 0) return;
  record(code);
}
__device__ __forceinline__ void lane_stamp(bool on, Stamp code) {
  if (on) record(code);
}
#else
__device__ __forceinline__ void stamp(Stamp) {}
__device__ __forceinline__ void lane_stamp(bool, Stamp) {}
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

// The words of a Part that a reduction reads (the warp's team shuffles
// only those).
enum Word : int { kSum = 1, kCnt0 = 2, kCnt1 = 4, kCnt2 = 8, kMx = 16 };

// The threads that run one projection, as its body (l1_proj, skappa_proj)
// sees them: their copy of the vector (begin), each thread's entries
// first(), first() + kStride, ...; a reduction of every thread's partial
// to the total, in every thread; the point statistics of a polish step; a
// bracketing round; phase stamps; and the end (a cluster's barrier).
// CtaTeam: a CTA (C = 1) or a cluster of C CTAs of T threads, each holding
// its slice of the vector, the reductions and rounds through shared (and
// distributed shared) memory.
template <int C, int T>
struct CtaTeam {
  static constexpr int kStride = T;
  Shared<T>& sh;
  int rank, buf, rbuf;  // the CTA's rank; the next reduction's and round's
                        // halves of sh
  // This CTA's slice of z (n,), chunk entries a CTA, into zs: its length.
  __device__ __forceinline__ int begin(const float* __restrict__ z,
                                       float* zs, int n, int chunk) {
    rank = cta_rank<C>();
    const int len = load_slice<T>(z, zs, n, chunk, rank);
    stamp(kLoaded);
    buf = rbuf = 0;
    return len;
  }
  __device__ __forceinline__ void end() const {
    cluster_sync<C>();   // no CTA leaves early; zs and sh are free again
  }
  __device__ __forceinline__ int first() const { return threadIdx.x; }
  __device__ __forceinline__ void passed() const {}
  __device__ __forceinline__ void output() const { stamp(kOutput); }
  template <int kF>
  __device__ __forceinline__ Part total(Part p) {
    return reduce<C, T>(p, sh, buf);
  }
  __device__ __forceinline__ Part stats(const float* zs, int len,
                                        float theta) {
    return point_stats<C, T>(zs, len, theta, sh, buf);
  }
  __device__ __forceinline__ Part stats(const float* zs, int len,
                                        double theta) {
    return point_stats64<C, T>(zs, len, theta, sh, buf);
  }
  template <bool kL1>
  __device__ __forceinline__ void round(const float* zs, int len,
                                        float target, float& lo, float& hi) {
    ladder_round<C, T, kL1>(zs, len, target, lo, hi, sh, rbuf);
  }
};

// ladder_round's rung b of [lo, hi], the same f32 operations.
__device__ __forceinline__ float rung_at(float lo, float hi, int b) {
  return lo + (hi - lo) * (float)(b + 1) / (float)kRungs;
}

// LaneWarp: one warp holding a whole row (a narrow lane), everything in
// registers and shuffles (header).
struct LaneWarp {
  static constexpr int kStride = 32;
  static constexpr int rank = 0;
  int lane;           // lane in the warp
  bool traced;        // lane 0 of the warp on lane 0 (trace builds)
  // The row is in zs already (for_each_lane).
  __device__ __forceinline__ int begin(const float*, float*, int n, int) {
    return n;
  }
  __device__ __forceinline__ void end() const {}
  __device__ __forceinline__ int first() const { return lane; }
  __device__ __forceinline__ void passed() const {
    lane_stamp(traced, kLanePass);
  }
  __device__ __forceinline__ void output() const {
    lane_stamp(traced, kLaneOutput);
  }

  // A xor butterfly leaves lane 0's shfl_down tree (reduce's) in every
  // lane: the two lanes of a pair combine the same two values (an add is
  // the same either way round; the max takes the lower lane's first, as
  // nan_max picks between NaNs and zeros by order). reduce's second pass
  // adds zero partials to it, which leaves it as it is.
  template <int kF>
  __device__ __forceinline__ Part total(Part p) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (kF & kSum) p.sum += __shfl_xor_sync(0xffffffffu, p.sum, o);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (kF & (kCnt0 << j)) {
          p.cnt[j] += __shfl_xor_sync(0xffffffffu, p.cnt[j], o);
        }
      }
      if (kF & kMx) {
        const float x = __shfl_xor_sync(0xffffffffu, p.mx, o);
        p.mx = (lane & o) ? nan_max(x, p.mx) : nan_max(p.mx, x);
      }
    }
    lane_stamp(traced, kLaneReduce);
    return p;
  }
  __device__ __forceinline__ Part stats(const float* zs, int len,
                                        float theta) const {
    Part p = {0.0, {0, 0, 0}, 0.f};
    for (int i = lane; i < len; i += 32) {
      const float d = fabsf(zs[i]) - theta;
      p.sum += (double)clamp0(d);
      p.cnt[0] += d > 0.f;
    }
    passed();
    return total<kSum | kCnt0>(p);
  }
  __device__ __forceinline__ Part stats(const float* zs, int len,
                                        double theta) const {
    Part p = {0.0, {0, 0, 0}, 0.f};
    for (int i = lane; i < len; i += 32) {
      const double d = (double)fabsf(zs[i]) - theta;
      p.sum += d < 0.0 ? 0.0 : d;
      p.cnt[0] += d > 0.0;
    }
    passed();
    return total<kSum | kCnt0>(p);
  }

  // ladder_round: lane t owns rungs t, t + 32, t + 64, t + 96, each rung's
  // sum (kL1) or count over the row in order, the row read once as float4s
  // for all four; the crossing index is the count of set flags.
  template <bool kL1>
  __device__ __forceinline__ void round(const float* zs, int n,
                                        float target, float& lo,
                                        float& hi) const {
    constexpr int kPer = kRungs / 32;
    float th[kPer];
    double s[kPer];
    int c[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      th[j] = rung_at(lo, hi, lane + 32 * j);
      s[j] = 0.0;
      c[j] = 0;
    }
    int i = 0;
    for (; i + 3 < n; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(zs + i);
      const float a[4] = {fabsf(v.x), fabsf(v.y), fabsf(v.z), fabsf(v.w)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float d = a[e] - th[j];
          if (kL1) {
            s[j] += (double)clamp0(d);
          } else {
            c[j] += d > 0.f;
          }
        }
      }
    }
    for (; i < n; ++i) {
      const float a = fabsf(zs[i]);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float d = a - th[j];
        if (kL1) {
          s[j] += (double)clamp0(d);
        } else {
          c[j] += d > 0.f;
        }
      }
    }
    lane_stamp(traced, kLaneRungs);
    int idx = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool flag = kL1 ? (((float)s[j] - target) - th[j]) > 0.f
                            : (float)c[j] > target;
      idx += __popc(__ballot_sync(0xffffffffu, flag));
    }
    lane_stamp(traced, kLaneVote);
    const float lo_n = idx == 0 ? lo : rung_at(lo, hi, idx - 1);
    const float hi_n = idx == kRungs ? hi : rung_at(lo, hi, idx);
    lo = lo_n;
    hi = hi_n;
  }
};

// The l1-epigraph projection of one vector z0 (n,) by a team: z (n,), *t
// and, where not null, *theta_out and *steps. zs: the team's copy of z0 (a
// CTA's slice of chunk entries on a cluster). kF64: the polish in f64
// (header).
template <bool kF64, class Team>
__device__ __forceinline__ void l1_proj(
    Team& team, const float* __restrict__ z0, float t0,
    float* __restrict__ z, float* __restrict__ t,
    float* __restrict__ theta_out, int* __restrict__ steps, int n,
    int chunk, int rounds, int cap, float* zs) {
  const int len = team.begin(z0, zs, n, chunk);

  // sum |z0| (f64) and max |z0|: the inside and apex tests
  Part p = {0.0, {0, 0, 0}, 0.f};
  for (int i = team.first(); i < len; i += Team::kStride) {
    const float a = fabsf(zs[i]);
    p.sum += (double)a;
    p.mx = nan_max(p.mx, a);
  }
  team.passed();
  const Part tot = team.template total<kSum | kMx>(p);
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
      team.template round<true>(zs, len, t0, lo, hi);
    }
    // the monotone closed-form polish to its fixpoint (ladder_refine:
    // k = 1, (theta, prev) = (propose(lo), lo); step while theta > prev)
    if constexpr (kF64) {
      const double t0d = (double)t0;
      double prev = (double)lo;
      double th = prev;
      do {
        prev = th;
        const Part q = team.stats(zs, len, th);
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
        const Part q = team.stats(zs, len, th);
        const float hv = ((float)q.sum - t0) - th;
        th = nan_max(th + hv / ((float)q.cnt[0] + 1.f), th);
        ++k;
      } while (th > prev && k < cap);
      theta = th;
    }
  }

  const bool to_apex = apex && !inside;
  float* out = z + (size_t)team.rank * chunk;
  for (int i = team.first(); i < len; i += Team::kStride) {
    const float v = zs[i];
    out[i] = to_apex ? 0.f : sgn(v) * clamp0(fabsf(v) - theta);
  }
  team.output();
  if (team.rank == 0 && team.first() == 0) {
    *t = to_apex ? clamp0(t0) : t0 + theta;
    if (theta_out != nullptr) *theta_out = theta;
    if (steps != nullptr) *steps = k;
  }
  team.end();
}

// The S^kappa support of one vector z (n,) by a team as in l1_proj:
// s_star (n,), *u_max and, where not null, *steps.
template <class Team>
__device__ __forceinline__ void skappa_proj(
    Team& team, const float* __restrict__ zin, float kap,
    float* __restrict__ s_star, float* __restrict__ u_max,
    int* __restrict__ steps, int n, int chunk, int rounds, int cap,
    float* zs) {
  const int len = team.begin(zin, zs, n, chunk);

  // max |z| and c0 = count(|z| > 0)
  Part p = {0.0, {0, 0, 0}, 0.f};
  for (int i = team.first(); i < len; i += Team::kStride) {
    const float a = fabsf(zs[i]);
    p.mx = nan_max(p.mx, a);
    p.cnt[0] += a > 0.f;
  }
  team.passed();
  const Part init = team.template total<kCnt0 | kMx>(p);
  const float c0 = (float)init.cnt[0];
  const bool all_in = c0 <= kap;     // fewer than kappa nonzeros: tau* = 0

  float tau = 0.f, c_tau = c0, ceq = 0.f;
  int k = 0;
  if (!all_in) {
    float lo = 0.f, hi = init.mx;
    for (int r = 0; r < rounds; ++r) {
      team.template round<false>(zs, len, kap, lo, hi);
    }
    // the mean-pivot search (support_skappa_ladder's while_loop)
    tau = hi;
    c_tau = 0.f;
    bool done = false;
    while (!done && k < cap) {
      Part q = {0.0, {0, 0, 0}, 0.f};           // (sum, count) in (lo, hi]
      for (int i = team.first(); i < len; i += Team::kStride) {
        const float a = fabsf(zs[i]);
        if (a > lo && a <= hi) {
          q.sum += (double)a;
          q.cnt[0] += 1;
        }
      }
      team.passed();
      q = team.template total<kSum | kCnt0>(q);
      float a = (float)q.sum / fmaxf((float)q.cnt[0], 1.f);
      a = nan_min(nan_max(a, nextafterf(lo, INFINITY)), hi);
      const float am = nextafterf(a, -INFINITY);
      const float ap = nextafterf(a, INFINITY);
      Part r = {0.0, {0, 0, 0}, 0.f};
      for (int i = team.first(); i < len; i += Team::kStride) {
        const float x = fabsf(zs[i]);
        r.cnt[0] += x > am;
        r.cnt[1] += x > a;
        r.cnt[2] += x > ap;
      }
      team.passed();
      r = team.template total<kCnt0 | kCnt1 | kCnt2>(r);
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
  float* out = s_star + (size_t)team.rank * chunk;
  for (int i = team.first(); i < len; i += Team::kStride) {
    const float v = zs[i], x = fabsf(v);
    const float above = x > tau ? 1.f : 0.f;
    const float at_tau = (x == tau && tau > 0.f) ? 1.f : 0.f;
    const float w = above + bnd_w * at_tau;
    out[i] = sgn(v) * w;
    u.sum += (double)(x * w);
  }
  team.output();
  u = team.template total<kSum>(u);
  if (team.rank == 0 && team.first() == 0) {
    *u_max = (float)u.sum;
    if (steps != nullptr) *steps = k;
  }
  team.end();
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
  CtaTeam<C, T> team{sh};
  l1_proj<kF64>(team, z0, t0, z, t, theta_out, steps, n, chunk, rounds, cap,
                zs);
}

// The S^kappa support of one vector z (n,): s_star (n,), *u_max and, where
// not null, *steps; the layout as in l1_body.
template <int C, int T>
__device__ __forceinline__ void skappa_body(
    const float* __restrict__ zin, float kap, float* __restrict__ s_star,
    float* __restrict__ u_max, int* __restrict__ steps, int n, int chunk,
    int rounds, int cap, float* zs, Shared<T>& sh) {
  CtaTeam<C, T> team{sh};
  skappa_proj(team, zin, kap, s_star, u_max, steps, n, chunk, rounds, cap,
              zs);
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

// ---------------------------------------------------------------------------
// The narrow lane layout (header): a warp a lane, the LaneWarp team.

// cp.async of a row of n floats into shared memory, 4 bytes a copy, as
// one commit group.
__device__ __forceinline__ void copy_row(float* dst,
                                         const float* __restrict__ src,
                                         int n, int lane) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  for (int i = lane; i < n; i += 32) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     base + 4u * (unsigned)i),
                 "l"(src + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This warp's lanes: body(g, zs, b, per[b]) on each lane b, with zs its
// row in shared memory; the next lane's row is copied into the warp's other
// row buffer (of stride floats) while this one is worked on.
template <typename Body>
__device__ __forceinline__ void for_each_lane(const float* __restrict__ zin,
                                              const float* __restrict__ per,
                                              int lanes, int n, int stride,
                                              Body body) {
  extern __shared__ float4 smem4[];
  LaneWarp g;
  g.lane = threadIdx.x & 31;
  g.traced = false;
  const int warp = threadIdx.x >> 5;
  float* rows = reinterpret_cast<float*>(smem4) + (size_t)warp * 2 * stride;
  const int total = gridDim.x * (blockDim.x >> 5);
  int b = warp * gridDim.x + blockIdx.x;
  if (b >= lanes) return;
  copy_row(rows, zin + (size_t)b * n, n, g.lane);
  float v_next = per[b];
  for (int j = 0; b < lanes; b += total, ++j) {
#ifdef LADDER_PROJ_TRACE
    g.traced = b == 0 && g.lane == 0;
#endif
    lane_stamp(g.traced, kLaneStart);
    const int next = b + total;
    const float v = v_next;
    float* zs = rows + (j & 1) * stride;
    __syncwarp();             // the last lane's readers of the rows are done
    if (next < lanes) {
      copy_row(rows + ((j + 1) & 1) * stride, zin + (size_t)next * n, n,
               g.lane);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    copy_wait<1>();
    if (next < lanes) v_next = per[next];
    __syncwarp();             // every lane's copies are in
    lane_stamp(g.traced, kLaneRow);
    body(g, zs, b, v);
    lane_stamp(g.traced, kLaneEnd);
  }
}

// Lanes of a (lanes, n) operand on the narrow layout, a warp a lane: row b
// with t0[b]; z row b, t[b] and, where not null, theta[b], steps[b].
template <bool kF64>
__global__ void __launch_bounds__(kLaneCtaWarps * 32, kLaneMinCtas)
l1_warp_lanes_kernel(const float* __restrict__ z0,
                     const float* __restrict__ t0, float* __restrict__ z,
                     float* __restrict__ t, float* __restrict__ theta,
                     int* __restrict__ steps, int rounds, int cap, int lanes,
                     int n, int stride) {
  for_each_lane(z0, t0, lanes, n, stride,
                [&](LaneWarp& g, float* zs, int b, float tb) {
                  l1_proj<kF64>(g, nullptr, tb, z + (size_t)b * n, t + b,
                                theta == nullptr ? nullptr : theta + b,
                                steps == nullptr ? nullptr : steps + b, n,
                                n, rounds, cap, zs);
                });
}

// The S^kappa support of each lane on the narrow layout: row b of z with
// kappa[b]; s_star row b, u_max[b] and, where not null, steps[b].
__global__ void __launch_bounds__(kLaneCtaWarps * 32, kLaneMinCtas)
skappa_warp_lanes_kernel(const float* __restrict__ zin,
                         const float* __restrict__ kappa,
                         float* __restrict__ s_star,
                         float* __restrict__ u_max, int* __restrict__ steps,
                         int rounds, int cap, int lanes, int n,
                         int stride) {
  for_each_lane(zin, kappa, lanes, n, stride,
                [&](LaneWarp& g, float* zs, int b, float kb) {
                  skappa_proj(g, nullptr, kb, s_star + (size_t)b * n,
                              u_max + b,
                              steps == nullptr ? nullptr : steps + b, n, n,
                              rounds, cap, zs);
                });
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

// The wide lane layouts (ctas, 1,024): 1, 2, 4 or 8 CTAs a lane, each
// instantiation configured once; kF64 (l1 only): the f64 polish.
template <bool kL1, bool kF64 = false, typename... Args>
int launch_lanes(int ctas, int ys, int chunk, cudaStream_t s,
                 Args... args) {
  static bool cfg[4] = {false, false, false, false};
#define LANES(C, I)                                                         \
  if constexpr (kL1) {                                                      \
    return launch_grid(l1_lanes_kernel<C, kThreads, kF64>, cfg[I], C, ys,   \
                       kThreads, chunk, s, args...);                        \
  } else {                                                                  \
    return launch_grid(skappa_lanes_kernel<C, kThreads>, cfg[I], C, ys,     \
                       kThreads, chunk, s, args...);                        \
  }
  switch (ctas) {
    case 1: LANES(1, 0)
    case 2: LANES(2, 1)
    case 4: LANES(4, 2)
    case 8: LANES(8, 3)
    default: break;
  }
#undef LANES
  return (int)cudaErrorInvalidValue;
}

// A persistent launch of a narrow lane kernel (n <= kLaneWarpMaxN):
// kLaneCtaWarps lanes a CTA, each with two row buffers of `stride` floats
// (n rounded up to a float4; at most 16 KB a CTA), and as many CTAs as the
// card holds at once (the occupancy calculator's CTAs an SM, cached for
// the kernel, device and shared memory, times the SMs), no more than the
// lanes need.
template <typename... Params, typename... Args>
int launch_narrow(void (*kern)(Params...), int lanes, int n,
                  cudaStream_t stream, Args... args) {
  struct Seen {
    const void* kern;
    int device, smem, per_sm, sms;
  };
  static Seen seen[16] = {};
  static int next = 0;
  const int stride = (n + 3) & ~3;
  const int threads = kLaneCtaWarps * 32;
  const int smem = kLaneCtaWarps * 2 * stride * (int)sizeof(float);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const void* key = reinterpret_cast<const void*>(kern);
  int slot = -1;
  for (int i = 0; i < 16; ++i) {
    if (seen[i].kern == key && seen[i].device == device &&
        seen[i].smem == smem) {
      slot = i;
    }
  }
  if (slot < 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    slot = next;
    next = (next + 1) % 16;
    seen[slot] = {key, device, smem, per_sm, sms};
  }
  const int need = (lanes + kLaneCtaWarps - 1) / kLaneCtaWarps;
  const int full = seen[slot].per_sm * seen[slot].sms;
  kern<<<need < full ? need : full, threads, smem, stream>>>(
      args..., lanes, n, stride);
  return (int)cudaGetLastError();
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

// Whether (ctas, threads) is a lane layout for n entries.
static bool valid_lanes(int lanes, int n, int ctas, int threads) {
  return lanes >= 1 && valid(n, ctas) &&
         (threads == kThreads ||
          (ctas == 1 && threads == 32 && n <= kLaneWarpMaxN));
}

// z0 (lanes, n) row-major and t0 (lanes,) f32 on the device -> z (lanes, n),
// t (lanes,); theta (lanes,) and steps (lanes,), each may be null, as in
// l1_epigraph_proj_f32 per lane. (ctas, threads), threads a lane: (1, 32),
// the narrow layout of a warp a lane (n <= 256), or
// (1, 2, 4, 8 with ceil(n / ctas) <= ladder_proj_max_per_cta(), 1024), a
// cluster of 1,024-thread CTAs a lane.
template <bool kF64>
int l1_lanes(const float* z0, const float* t0, float* z, float* t,
             float* theta, int* steps, int lanes, int n, int ctas,
             int threads, int rounds, int cap, cudaStream_t s) {
  if (!valid_lanes(lanes, n, ctas, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  if (threads == 32) {
    return launch_narrow(l1_warp_lanes_kernel<kF64>, lanes, n, s, z0, t0, z,
                         t, theta, steps, rounds, cap);
  }
  const int chunk = (n + ctas - 1) / ctas;
  const int ys = lanes < kMaxLaneGrid ? lanes : kMaxLaneGrid;
  return launch_lanes<true, kF64>(ctas, ys, chunk, s, z0, t0, z, t, theta,
                                  steps, lanes, n, chunk, rounds, cap);
}

extern "C" int l1_epigraph_proj_lanes_f32(const float* z0, const float* t0,
                                          float* z, float* t, float* theta,
                                          int* steps, int lanes, int n,
                                          int ctas, int threads, int rounds,
                                          int cap, void* stream) {
  return l1_lanes<false>(z0, t0, z, t, theta, steps, lanes, n, ctas, threads,
                         rounds, cap, static_cast<cudaStream_t>(stream));
}

// The same with the polish in f64 on every lane.
extern "C" int l1_epigraph_proj_lanes_f32_polish64(
    const float* z0, const float* t0, float* z, float* t, float* theta,
    int* steps, int lanes, int n, int ctas, int threads, int rounds, int cap,
    void* stream) {
  return l1_lanes<true>(z0, t0, z, t, theta, steps, lanes, n, ctas, threads,
                        rounds, cap, static_cast<cudaStream_t>(stream));
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads == 32) {
    return launch_narrow(skappa_warp_lanes_kernel, lanes, n, s, z, kappa,
                         s_star, u_max, steps, rounds, cap);
  }
  const int chunk = (n + ctas - 1) / ctas;
  const int ys = lanes < kMaxLaneGrid ? lanes : kMaxLaneGrid;
  return launch_lanes<false>(ctas, ys, chunk, s, z, kappa, s_star, u_max,
                             steps, lanes, n, chunk, rounds, cap);
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
