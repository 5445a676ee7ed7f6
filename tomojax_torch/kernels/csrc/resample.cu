// Batched affine row resampling for Hopper (sm_90a): forward K7 and its
// exact transpose K8, behind a plain C interface (loaded with ctypes).
//
// K7 resample_fwd replaces tomojax/kernels/resample.py:38 _kernel (entry
// resample_rows_pallas; the non-differentiable entry
// _resample_rows_pallas_raw, resample.py:356, is served by the same kernel).
// K8 resample_transpose replaces resample.py:111 _kernel_transpose (entry
// resample_rows_transpose).
//
// The function, for view v, row a = (a1, a2) and output i = 0..M-1:
//   pos = off[v, a] + slope[v] * i
//   out[v, a, i] = (1 - t) * row[k] + t * row[k + 1],  k = floor(pos),
//                  t = pos - k, each tap zero outside [0, N).
// Rows are read with per-view and two per-row strides (K7: elements
// contiguous), so a volume shared by all views (stride 0) or a cotangent
// broadcast over one row index (stride 0) is never copied. Both kernels also take the
// strides of their offsets and of their output, so each writes its output
// in the row order that the next pass reads (the fast projector's i1, i2
// and its adjoint's a3, a2 need no transposed copy). K8 also reads rows
// whose elements are strided (a cotangent that arrives transposed), and an
// output view stride of 0 sums the call's views into one output (the fast
// adjoint's last pass adds its chunk straight into the volume).
//
// What bounds these kernels on an H100: K7 HBM bytes (each output costs one
// 4-byte store and ~7 flops, each row is read once, far below the card's
// flop-per-byte ridge); K8 the instructions of its candidate tests, then
// the bytes. The TPU design (per-row lane roll,
// window extraction and a one-hot selection matmul on the MXU, 128-lane
// chunks) exists because Mosaic cannot gather; a Hopper thread can.
//
// K7's design. A CTA takes a tile of up to 32 rows, consecutive along the
// inner row axis, and a run of views. It stages the tile's rows in shared
// memory with cp.async, 16 bytes per copy where a row is 16-byte aligned
// (4 bytes otherwise and for the tail of N % 4), every row in flight at
// once. When the rows are shared by all views (view stride 0: pass 1 reads
// the volume for every view) the CTA stages them once and loops over all
// the call's views, so the volume is read once per call, not per view;
// otherwise it loops over a few views and double-buffers, loading the next
// view's tile while it computes this one's. Neighbouring threads compute
// neighbouring outputs i of one row (for |slope| ~ 1 they read neighbouring
// shared-memory words, without bank conflicts) and store them: a warp
// writes 128 contiguous bytes. For an output whose unit stride is the
// inner row axis, a warp computes 8 neighbouring rows x 4 neighbouring i
// (rows an odd number of 16-byte words apart in shared memory, so the 8
// rows' reads fall on distinct banks) and stores 4 segments of 32 bytes;
// the four warps of a row block complete each 128-byte line together.
// This keeps a transposed output as fast as a row-major one
// (chip_smoke.py phase 7 times K7 in the path's layouts against the K9
// entry, row-major); a shared-memory transpose that stored whole lines
// per warp was slower, for its extra barriers and index arithmetic.
//
// K8 is K7's tiling run backwards: a CTA takes a tile of up to 32 rows,
// consecutive along the inner row axis, and a run of views, stages the
// tile's cotangent rows in shared memory with cp.async (16-byte copies for
// rows of contiguous elements; for rows whose elements are strided a warp
// copies 32 neighbouring rows of one element), double-buffered over the
// views, and computes its outputs as gathers with no atomics, so its sums
// come out the same on every run. A thread owns a run of 4 neighbouring
// outputs n of one row (a warp: 8 rows x 4 runs) and sweeps once, in
// increasing i, the few i whose taps can reach the run: the affine map
// inverted with one reciprocal of the slope per view, then multiplies,
// widened by the rounding of the position and of the inversion
// (tap_window). K7's own tap test (position, floor, compare) adds each
// candidate's two weighted taps to the run's sums in registers. The
// position is computed by the same __device__ function in both kernels,
// rounding each step (__fmul_rn/__fadd_rn) in the plain PyTorch version's
// order, so K7, K8 and the plain version choose the same taps to the last
// bit and K8 is K7's exact transpose in float32. A run is stored with one
// 16-byte access where the output's elements are contiguous; for an
// output whose unit stride is the inner row axis the 8 rows of a warp
// complete 32-byte segments. With an output view stride of 0 a CTA loops
// over all of the call's views and keeps its tile's outputs in shared
// memory (each run has one owner thread, the views summed in order), then
// writes or adds each output once. What bounds K8: the candidate tests
// (about 1.5 per output at |slope| ~ 1), then the bytes.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMax = 227 * 1024;     // a CTA's opt-in maximum on sm_90

// pos = off + slope * i, each step rounded as the plain version rounds it.
__device__ __forceinline__ float position(float off, float slope, int i) {
  return __fadd_rn(off, __fmul_rn(slope, static_cast<float>(i)));
}

// Integer range [lo, hi] (clamped to [0, m)) holding every i whose
// computed position a + b * i lies in [c0 - 1, c1 + 1), i.e. whose taps
// can reach an output in [c0, c1], from inv_b = 1/b: multiplies, no
// division. The exact tap test decides. Why the slack is enough (u =
// 2^-24, the unit roundoff; c = max(|c0|, |c1|)): the computed position
// differs from a + b*i by at most u (|a| + 2|b| m); the inversion rounds
// c0 - 1 - a once (c0 - 1 is exact), inv_b carries u of relative error,
// the product and the slack's subtraction u more each, so the bound is off
// by at most 4.1 u (c + 1 + |a|) |inv_b|. Together that is below
// 8 u (2|a| + |b| m + c + 2) |inv_b|, which the range is widened by
// (4.8e-7 > 8u: many indices for a tiny slope); then every integer i of
// the exact range lies in [ceil(tl), floor(th)]. A slope below 1e-20 or
// NaN takes [0, m).
__device__ __forceinline__ void tap_window(float a, float b, float inv_b,
                                           float c0, float c1, int m,
                                           int* lo, int* hi) {
  const float ab = fabsf(b);
  if (!(ab >= 1e-20f)) {
    *lo = 0;
    *hi = m - 1;
    return;
  }
  const float slack = (2.0f * fabsf(a) + ab * static_cast<float>(m) +
                       fmaxf(fabsf(c0), fabsf(c1)) + 2.0f) *
                      4.8e-7f * fabsf(inv_b);
  const float t0 = (c0 - 1.0f - a) * inv_b;
  const float t1 = (c1 + 1.0f - a) * inv_b;
  const float top = static_cast<float>(m) + 1.0f;
  const float tl = fminf(fmaxf(fminf(t0, t1) - slack, -2.0f), top);
  const float th = fmaxf(fminf(fmaxf(t0, t1) + slack, top), -2.0f);
  *lo = max(0, static_cast<int>(ceilf(tl)));
  *hi = min(m - 1, static_cast<int>(floorf(th)));
}

// The lerp of output i of a staged row: K7's arithmetic, shared by every
// output layout.
__device__ __forceinline__ float lerp_at(const float* src, float o, float s,
                                         int i, float last) {
  const float pos = position(o, s, i);
  const float kf = floorf(pos);
  const float t = __fsub_rn(pos, kf);
  // masks in float: NaN or huge positions never form an index
  const float v0 =
      (kf >= 0.0f && kf <= last) ? src[static_cast<int>(kf)] : 0.0f;
  const float v1 = (kf >= -1.0f && kf <= last - 1.0f)
                       ? src[static_cast<int>(kf) + 1]
                       : 0.0f;
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, t), v0), __fmul_rn(t, v1));
}

// K7's operands and tiling. Strides are in elements; row (a1, a2) of view
// v starts at v*sv + a1*s1 + a2*s2, its offset is at v*fv + a1*f1 + a2*f2
// and its output i at v*ov + a1*o1 + a2*o2 + i*oi. Either oi == 1 (row-major
// output) or o2 == 1 (transposed output).
struct FwdArgs {
  const float* arr;
  const float* off;
  const float* slope;
  float* out;
  int V, R1, R2, N, M;
  long long sv, s1, s2, fv, f1, f2, ov, o1, o2, oi;
  int rows;    // rows per tile, consecutive in a2
  int pitch;   // floats per staged row (N rounded up to 4)
  int nbuf;    // staged tiles: 2 double-buffers the views' rows
  int vpc;     // views per CTA
};

constexpr int kFwdRows = 32;               // four warps' 128-byte stores
constexpr int kFwdViews = 4;               // views per CTA, own rows
constexpr int kFwdBudget = 110 * 1024;     // two CTAs per SM at least

// Stage rows [0, nrows) of the tile starting at element `base` into dst.
__device__ __forceinline__ void stage_rows(float* dst, const FwdArgs& a,
                                           long long base, int nrows) {
  const int n4 = a.N >> 2, tail = a.N & 3;
  for (int e = threadIdx.x; e < nrows * n4; e += kThreads) {
    const int r = e / n4, c = 4 * (e - r * n4);
    const float* src = a.arr + base + r * a.s2 + c;
    float* d = dst + r * a.pitch + c;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(d, src);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) cp_async4(d + q, src + q);
    }
  }
  for (int e = threadIdx.x; e < nrows * tail; e += kThreads) {
    const int r = e / tail, c = 4 * n4 + (e - r * tail);
    cp_async4(dst + r * a.pitch + c, a.arr + base + r * a.s2 + c);
  }
}

// K7: grid (R1 x row tiles of a2, view runs). Shared memory: nbuf staged
// tiles and the tile's offsets.
template <bool kTransposed>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tiles2 = (a.R2 + a.rows - 1) / a.rows;
  const long long a1 = blockIdx.x / tiles2;
  const long long a2_0 = static_cast<long long>(blockIdx.x % tiles2) * a.rows;
  const int nrows = static_cast<int>(
      min(static_cast<long long>(a.rows), a.R2 - a2_0));
  const int v0 = blockIdx.y * a.vpc;
  const int v1 = min(a.V, v0 + a.vpc);
  const bool shared_rows = a.sv == 0;
  const int tile_floats = a.rows * a.pitch;
  float* const s_off = smem + a.nbuf * tile_floats;
  const long long rbase = a1 * a.s1 + a2_0 * a.s2;
  const float last = static_cast<float>(a.N - 1);

  stage_rows(smem, a, v0 * a.sv + rbase, nrows);
  cp_async_commit();
  int buf = 0;
  for (int view = v0; view < v1; ++view) {
    if (!shared_rows && a.nbuf == 2 && view + 1 < v1) {
      stage_rows(smem + (buf ^ 1) * tile_floats, a,
                 (view + 1) * a.sv + rbase, nrows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (threadIdx.x < nrows)
      s_off[threadIdx.x] = __ldg(a.off + view * a.fv + a1 * a.f1 +
                                 (a2_0 + threadIdx.x) * a.f2);
    __syncthreads();
    const float* tile = smem + buf * tile_floats;
    const float s = __ldg(a.slope + view);
    float* const outv = a.out + view * a.ov + a1 * a.o1 + a2_0 * a.o2;
    if (kTransposed) {
      // lanes: 8 rows x 4 outputs i; warps: 4 blocks of 8 rows x 2 of 4 i
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      const int r = (warp & 3) * 8 + (lane & 7);
      if (r < nrows) {
        const float* src = tile + r * a.pitch;
        const float o = s_off[r];
        float* dst = outv + r * a.o2;
        for (int i = (warp >> 2) * 4 + (lane >> 3); i < a.M; i += 8)
          dst[i * a.oi] = lerp_at(src, o, s, i, last);
      }
      __syncthreads();
    } else {
      for (int r = 0; r < nrows; ++r) {
        const float* src = tile + r * a.pitch;
        const float o = s_off[r];
        float* dst = outv + r * a.o2;
        for (int i = threadIdx.x; i < a.M; i += kThreads)
          dst[i] = lerp_at(src, o, s, i, last);
      }
      __syncthreads();
    }
    if (!shared_rows) {
      if (a.nbuf == 2) {
        buf ^= 1;
      } else if (view + 1 < v1) {
        stage_rows(smem, a, (view + 1) * a.sv + rbase, nrows);
        cp_async_commit();
      }
    }
  }
}

// K8's operands and tiling. Element i of cotangent row (a1, a2) of view v
// is at v*gv + a1*g1 + a2*g2 + i*gi, its offset at v*fv + a1*f1 + a2*f2
// and its output n at v*ov + a1*o1 + a2*o2 + n*on. Either on == 1
// (row-major output) or o2 == 1 (transposed output); ov == 0 sums the
// views and adds the sum into the output.
struct TrArgs {
  const float* g;
  const float* off;
  const float* slope;
  float* out;
  int V, R1, R2, N, M;
  long long gv, g1, g2, gi, fv, f1, f2, ov, o1, o2, on;
  int rows;    // rows per tile, consecutive in a2
  int pitch;   // floats per staged row
  int apitch;  // floats per row of the view sum (ov == 0)
  int nbuf;    // staged tiles: 2 double-buffers the views' rows
  int vpc;     // views per CTA
};

constexpr int kTrRows = 32;
constexpr int kTrViews = 8;
constexpr int kTrBudget = 110 * 1024;

// Stage rows [0, nrows) of the cotangent tile starting at element `base`
// into dst (row r at dst + r * pitch).
__device__ __forceinline__ void stage_cotangent(float* dst, const TrArgs& a,
                                                long long base, int nrows) {
  if (a.gi == 1) {
    const int m4 = a.M >> 2, tail = a.M & 3;
    for (int e = threadIdx.x; e < nrows * m4; e += kThreads) {
      const int r = e / m4, c = 4 * (e - r * m4);
      const float* src = a.g + base + r * a.g2 + c;
      float* d = dst + r * a.pitch + c;
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        cp_async16(d, src);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) cp_async4(d + q, src + q);
      }
    }
    for (int e = threadIdx.x; e < nrows * tail; e += kThreads) {
      const int r = e / tail, c = 4 * m4 + (e - r * tail);
      cp_async4(dst + r * a.pitch + c, a.g + base + r * a.g2 + c);
    }
  } else {
    // strided elements: neighbouring threads copy neighbouring rows of one
    // element (contiguous when the inner row axis is)
    for (int e = threadIdx.x; e < nrows * a.M; e += kThreads) {
      const int i = e / nrows, r = e - i * nrows;
      cp_async4(dst + r * a.pitch + i, a.g + base + r * a.g2 + i * a.gi);
    }
  }
}

constexpr int kRun = 4;   // K8: outputs per thread, consecutive n

// Outputs [na, na + kRun) of a staged cotangent row gr: one sweep over the
// i whose taps can reach them, in increasing i; K7's tap test adds each
// candidate's two weighted taps to the owned sums (in registers). Each
// output is the sum over the i whose taps reach it, in increasing i.
__device__ __forceinline__ void gather_run(const float* gr, float o, float s,
                                           float inv_s, int na, int m,
                                           float acc[kRun]) {
  const float fa = static_cast<float>(na);
  int lo, hi;
  tap_window(o, s, inv_s, fa, fa + (kRun - 1), m, &lo, &hi);
#pragma unroll
  for (int q = 0; q < kRun; ++q) acc[q] = 0.0f;
  for (int i = lo; i <= hi; ++i) {
    const float pos = position(o, s, i);
    const float kf = floorf(pos);
    const float t = __fsub_rn(pos, kf);
    const float gi = gr[i];
    const float w0 = __fmul_rn(__fsub_rn(1.0f, t), gi);   // tap kf
    const float w1 = __fmul_rn(t, gi);                    // tap kf + 1
    const float d = __fsub_rn(kf, fa);   // exact where it matters; NaN
                                         // matches no output
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      if (d == static_cast<float>(q))
        acc[q] += w0;
      else if (d == static_cast<float>(q - 1))
        acc[q] += w1;
    }
  }
}

// Store (or add) a run of cnt <= kRun values at dst, dst + stride, ...;
// one 16-byte access where the run is whole, contiguous and aligned.
__device__ __forceinline__ void put_run(float* dst, long long stride,
                                        const float v[kRun], int cnt,
                                        bool add) {
  if (cnt == kRun && stride == 1 &&
      (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    float4 x = make_float4(v[0], v[1], v[2], v[3]);
    if (add) {
      const float4 y = *d4;
      x = make_float4(y.x + x.x, y.y + x.y, y.z + x.z, y.w + x.w);
    }
    *d4 = x;
    return;
  }
#pragma unroll
  for (int q = 0; q < kRun; ++q)
    if (q < cnt) dst[q * stride] = add ? dst[q * stride] + v[q] : v[q];
}

// K8: grid (R1 x row tiles of a2, view runs). Shared memory: nbuf staged
// tiles, the tile's offsets and, when the views are summed, the tile's
// outputs. Every output slot is owned by one thread for the whole call.
__global__ void __launch_bounds__(kThreads) transpose_kernel(const TrArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tiles2 = (a.R2 + a.rows - 1) / a.rows;
  const long long a1 = blockIdx.x / tiles2;
  const long long a2_0 = static_cast<long long>(blockIdx.x % tiles2) * a.rows;
  const int nrows = static_cast<int>(
      min(static_cast<long long>(a.rows), a.R2 - a2_0));
  const int v0 = blockIdx.y * a.vpc;
  const int v1 = min(a.V, v0 + a.vpc);
  const bool sum_views = a.ov == 0;
  // rows broadcast along a2 (stride 0) are staged once
  const int srows = a.g2 == 0 ? 1 : nrows;
  const int tile_floats = (a.g2 == 0 ? 1 : a.rows) * a.pitch;
  float* const s_off = smem + a.nbuf * tile_floats;
  float* const s_sum = s_off + a.rows;
  const long long gbase = a1 * a.g1 + a2_0 * a.g2;
  float* const out0 = a.out + a1 * a.o1 + a2_0 * a.o2;
  // this thread's outputs: row r of its lane, runs of kRun outputs from
  // run q0 in steps of qstep runs (lanes: 8 rows x 4 runs; warps: the
  // tile's blocks of 8 rows x the rest in blocks of 4 runs); the same in
  // every view
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rblocks = max(1, min(kThreads / 64, a.rows / 8));
  const int r = (warp % rblocks) * 8 + (lane & 7);
  const int q0 = (warp / rblocks) * 4 + (lane >> 3);
  const int qstep = 4 * (kThreads / 32 / rblocks);
  const bool owns = r < nrows;
  const int nruns = (a.N + kRun - 1) / kRun;
  const float zeros[kRun] = {};

  if (sum_views && owns)
    for (int q = q0; q < nruns; q += qstep)
      put_run(s_sum + r * a.apitch + q * kRun, 1, zeros, kRun, false);
  stage_cotangent(smem, a, v0 * a.gv + gbase, srows);
  cp_async_commit();
  int buf = 0;
  for (int view = v0; view < v1; ++view) {
    if (a.nbuf == 2 && view + 1 < v1) {
      stage_cotangent(smem + (buf ^ 1) * tile_floats, a,
                      (view + 1) * a.gv + gbase, srows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (threadIdx.x < nrows)
      s_off[threadIdx.x] = __ldg(a.off + view * a.fv + a1 * a.f1 +
                                 (a2_0 + threadIdx.x) * a.f2);
    __syncthreads();
    const float* tile = smem + buf * tile_floats;
    const float s = __ldg(a.slope + view);
    const float inv_s = __fdiv_rn(1.0f, s);   // one division per view
    if (owns) {
      const float* gr = tile + (srows == 1 ? 0 : r * a.pitch);
      const float o = s_off[r];
      float* const outr = out0 + view * a.ov + r * a.o2;
      for (int q = q0; q < nruns; q += qstep) {
        const int na = q * kRun;
        float acc[kRun];
        gather_run(gr, o, s, inv_s, na, a.M, acc);
        if (sum_views)
          put_run(s_sum + r * a.apitch + na, 1, acc, kRun, true);
        else
          put_run(outr + na * a.on, a.on, acc, min(kRun, a.N - na), false);
      }
    }
    __syncthreads();
    if (a.nbuf == 2) {
      buf ^= 1;
    } else if (view + 1 < v1) {
      stage_cotangent(smem, a, (view + 1) * a.gv + gbase, srows);
      cp_async_commit();
    }
  }
  if (sum_views && owns) {
    for (int q = q0; q < nruns; q += qstep) {
      const int na = q * kRun;
      float acc[kRun];
#pragma unroll
      for (int k = 0; k < kRun; ++k) acc[k] = s_sum[r * a.apitch + na + k];
      put_run(out0 + r * a.o2 + na * a.on, a.on, acc, min(kRun, a.N - na),
              true);
    }
  }
}

// K8's shared memory for `rows` rows (one staged row per buffer when the
// rows are broadcast).
long long tr_smem(const TrArgs& a, int rows, int nbuf) {
  const long long sum = a.ov == 0 ? static_cast<long long>(rows) * a.apitch
                                  : 0;
  const long long staged = a.g2 == 0 ? 1 : rows;
  return 4LL * (static_cast<long long>(nbuf) * staged * a.pitch + rows + sum);
}

int launch_transpose(TrArgs a, void* stream) {
  if (a.V <= 0 || a.R1 <= 0 || a.R2 <= 0 || a.M <= 0 || a.N <= 0) return 0;
  if (a.V > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (a.on != 1 && a.o2 != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool sum_views = a.ov == 0;
  // lanes read 8 rows at once: rows an odd number of 16-byte words apart
  // (16-byte copies) or an odd number of words apart (4-byte copies of
  // neighbouring rows) fall on distinct banks
  if (a.gi == 1) {
    a.pitch = (a.M + 3) & ~3;
    if ((a.pitch / 4) % 2 == 0) a.pitch += 4;
  } else {
    a.pitch = a.M | 1;
  }
  // the view sum's rows: whole runs, rows an odd number of 16-byte words
  // apart (the 8 rows of a quarter-warp's 16-byte accesses on distinct
  // banks)
  a.apitch = (a.N + kRun - 1) / kRun * kRun;
  if ((a.apitch / 4) % 2 == 0) a.apitch += 4;
  a.nbuf = 2;
  a.vpc = sum_views ? a.V : kTrViews;
  int rows = kTrRows;
  while (rows > 1 && tr_smem(a, rows, a.nbuf) > kTrBudget) rows >>= 1;
  if (tr_smem(a, rows, a.nbuf) > kSmemMax) a.nbuf = 1;
  const long long smem = tr_smem(a, rows, a.nbuf);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  a.rows = rows;
  const long long tiles =
      static_cast<long long>(a.R1) * ((a.R2 + rows - 1) / rows);
  if (tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((a.V + a.vpc - 1) / a.vpc));
  const cudaError_t e = cudaFuncSetAttribute(
      transpose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  transpose_kernel<<<grid, kThreads, static_cast<int>(smem),
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K7's shared memory for `rows` rows: the staged tiles and the offsets.
long long fwd_smem(const FwdArgs& a, int rows, int nbuf) {
  return 4LL * (static_cast<long long>(nbuf) * rows * a.pitch + rows);
}

int launch_fwd(FwdArgs a, void* stream) {
  if (a.V <= 0 || a.R1 <= 0 || a.R2 <= 0 || a.M <= 0 || a.N <= 0) return 0;
  if (a.V > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool transposed = a.oi != 1;
  if (transposed && a.o2 != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool shared_rows = a.sv == 0;
  a.pitch = (a.N + 3) & ~3;
  // a transposed output's lanes read 8 rows at once: rows an odd number
  // of 16-byte words apart fall on distinct banks
  if (transposed && (a.pitch / 4) % 2 == 0) a.pitch += 4;
  a.nbuf = shared_rows ? 1 : 2;
  a.vpc = shared_rows ? a.V : kFwdViews;
  int rows = kFwdRows;
  while (rows > 1 && fwd_smem(a, rows, a.nbuf) > kFwdBudget) rows >>= 1;
  if (fwd_smem(a, rows, a.nbuf) > kSmemMax) a.nbuf = 1;
  const long long smem = fwd_smem(a, rows, a.nbuf);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  a.rows = rows;
  const long long tiles =
      static_cast<long long>(a.R1) * ((a.R2 + rows - 1) / rows);
  if (tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((a.V + a.vpc - 1) / a.vpc));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (transposed) {
    e = cudaFuncSetAttribute(fwd_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    fwd_kernel<true><<<grid, kThreads, static_cast<int>(smem), s>>>(a);
  } else {
    e = cudaFuncSetAttribute(fwd_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    fwd_kernel<false><<<grid, kThreads, static_cast<int>(smem), s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// arr: rows of N floats at view * sv + a1 * s1 + a2 * s2 (a1 < R1, a2 < R2);
// off: offsets at view * fv + a1 * f1 + a2 * f2; slope: (V,); out: output i
// of row (view, a1, a2) at view * ov + a1 * o1 + a2 * o2 + i * oi, with
// oi == 1 (row-major) or o2 == 1 (transposed).
int resample_fwd(const float* arr, const float* off, const float* slope,
                 float* out, int V, int R1, int R2, int N, int M, long long sv,
                 long long s1, long long s2, long long fv, long long f1,
                 long long f2, long long ov, long long o1, long long o2,
                 long long oi, void* stream) {
  FwdArgs a{arr, off, slope, out, V, R1, R2, N, M, sv, s1, s2,
            fv, f1, f2, ov, o1, o2, oi, 0, 0, 0, 0};
  return launch_fwd(a, stream);
}

// g: cotangent element i of row (view, a1, a2) at view * gv + a1 * g1 +
// a2 * g2 + i * gi; off, slope as K7; out: output n of row (view, a1, a2)
// at view * ov + a1 * o1 + a2 * o2 + n * on, with on == 1 (row-major) or
// o2 == 1 (transposed); ov == 0 sums the views and adds the sum into out.
int resample_transpose(const float* g, const float* off, const float* slope,
                       float* out, int V, int R1, int R2, int N, int M,
                       long long gv, long long g1, long long g2, long long gi,
                       long long fv, long long f1, long long f2, long long ov,
                       long long o1, long long o2, long long on,
                       void* stream) {
  TrArgs a{g,  off, slope, out, V,  R1, R2, N,  M,  gv, g1, g2, gi, fv,
           f1, f2, ov,    o1,  o2, on, 0, 0, 0, 0, 0};
  return launch_transpose(a, stream);
}

}  // extern "C"
