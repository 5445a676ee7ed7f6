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
// Rows are read with per-view and two per-row strides (elements contiguous),
// so a volume shared by all views (stride 0) or a cotangent broadcast over
// one row index (stride 0) is never copied. K7 also takes the strides of
// its offsets and of its output, so it writes the output in the row order
// that the next pass reads (the fast projector's i1 and i2 need no
// transposed copy); K8's offsets and output are contiguous.
//
// What bounds these kernels on an H100: HBM bytes. Each output costs one
// 4-byte store and ~7 flops, each row is read once, so both kernels sit far
// below the card's flop-per-byte ridge. The TPU design (per-row lane roll,
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
// K8 is a gather with no atomics, so its sums come out the same on every
// run: one thread per input element n of a row inverts the affine map to
// the few i whose taps reach n, widened by the position's rounding error
// (index_range) and by one, and lets K7's own tap test decide. The
// position is computed by the same __device__ function in both kernels,
// rounding each step (__fmul_rn/__fadd_rn) in the plain PyTorch version's
// order, so K7, K8 and the plain version choose the same taps to the last
// bit and K8 is K7's exact transpose in float32.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;             // K8: rows staged per CTA
constexpr int kSmemBudget = 48 * 1024;   // K8: staging per CTA, default
constexpr int kSmemMax = 227 * 1024;     // a CTA's opt-in maximum on sm_90

// pos = off + slope * i, each step rounded as the plain version rounds it.
__device__ __forceinline__ float position(float off, float slope, int i) {
  return __fadd_rn(off, __fmul_rn(slope, static_cast<float>(i)));
}

// Integer range [lo, hi] (clamped to [0, m)) holding every i whose
// computed position a + b * i lies in [c - 1, c + 1); the exact tap test
// decides. The computed position differs from the exact one by at most
// 2^-23 (|a| + |b| m), and the inversion rounds by about as much again, so
// the range is widened by that over |b| (many indices for a tiny slope),
// plus one index on each side. A slope below 1e-20 or NaN takes [0, m).
__device__ __forceinline__ void index_range(float a, float b, float c, int m,
                                            int* lo, int* hi) {
  const float ab = fabsf(b);
  if (!(ab >= 1e-20f)) {
    *lo = 0;
    *hi = m - 1;
    return;
  }
  const float slack =
      (2.0f * fabsf(a) + ab * static_cast<float>(m) + 2.0f) * 4.8e-7f / ab;
  const float t0 = (c - 1.0f - a) / b;
  const float t1 = (c + 1.0f - a) / b;
  const float top = static_cast<float>(m) + 1.0f;
  const float tl = fminf(fmaxf(fminf(t0, t1) - slack, -2.0f), top);
  const float th = fmaxf(fminf(fmaxf(t0, t1) + slack, top), -2.0f);
  *lo = max(0, static_cast<int>(floorf(tl)) - 1);
  *hi = min(m - 1, static_cast<int>(ceilf(th)) + 1);
}

// Address of the first element of row `row` of view `view`.
__device__ __forceinline__ long long row_base(long long view, long long row,
                                              int r2n, long long sv,
                                              long long s1, long long s2) {
  const long long a1 = row / r2n;
  const long long a2 = row - a1 * r2n;
  return view * sv + a1 * s1 + a2 * s2;
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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

// K8: grid (row tiles, views). Shared memory: rows x M floats of the
// cotangent; one thread per input element n of each row.
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const float* __restrict__ g, const float* __restrict__ off,
                 const float* __restrict__ slope, float* __restrict__ out,
                 int R1, int R2, int N, int M, long long gv, long long g1,
                 long long g2, int rows) {
  extern __shared__ float tile[];
  const long long view = blockIdx.y;
  const long long R = static_cast<long long>(R1) * R2;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int nrows = static_cast<int>(min(static_cast<long long>(rows),
                                         R - row0));
  for (int r = 0; r < nrows; ++r) {
    const float* src = g + row_base(view, row0 + r, R2, gv, g1, g2);
    for (int i = threadIdx.x; i < M; i += kThreads)
      tile[r * M + i] = __ldg(src + i);
  }
  __syncthreads();
  const float s = __ldg(slope + view);
  for (int r = 0; r < nrows; ++r) {
    const long long a = view * R + row0 + r;
    const float o = __ldg(off + a);
    const float* gr = tile + r * M;
    float* dst = out + a * N;
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const float fn = static_cast<float>(n);
      int lo, hi;
      index_range(o, s, fn, M, &lo, &hi);
      float acc = 0.0f;
      for (int i = lo; i <= hi; ++i) {
        const float pos = position(o, s, i);
        const float kf = floorf(pos);
        const float t = __fsub_rn(pos, kf);
        if (kf == fn)
          acc += __fmul_rn(__fsub_rn(1.0f, t), gr[i]);
        else if (kf + 1.0f == fn)
          acc += __fmul_rn(t, gr[i]);
      }
      dst[n] = acc;
    }
  }
}

// K8's rows per CTA so that the staged tile fits the default shared
// memory; returns the tile's bytes through `smem` (0 rows if one row is
// too long).
int tile_rows(int width, int* smem) {
  const long long row_bytes = 4LL * width;
  int rows = static_cast<int>(kSmemBudget / row_bytes);
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  if (row_bytes > kSmemMax) return 0;
  *smem = static_cast<int>(rows * row_bytes);
  return rows;
}

int launch_transpose(void* stream, const float* g, const float* off,
                     const float* slope, float* out, int V, int R1, int R2,
                     int N, int M, long long gv, long long g1, long long g2) {
  const long long R = static_cast<long long>(R1) * R2;
  if (V <= 0 || R <= 0 || M <= 0 || N <= 0) return 0;
  if (V > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  int smem = 0;
  const int rows = tile_rows(M, &smem);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemBudget) {
    const cudaError_t e = cudaFuncSetAttribute(
        transpose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long tiles = (R + rows - 1) / rows;
  if (tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(V));
  transpose_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      g, off, slope, out, R1, R2, N, M, gv, g1, g2, rows);
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

// g: cotangent rows of M floats at view * gv + a1 * g1 + a2 * g2;
// off, slope as K7; out: (V, R1, R2, N) contiguous.
int resample_transpose(const float* g, const float* off, const float* slope,
                       float* out, int V, int R1, int R2, int N, int M,
                       long long gv, long long g1, long long g2,
                       void* stream) {
  return launch_transpose(stream, g, off, slope, out, V, R1, R2, N, M, gv,
                          g1, g2);
}

}  // extern "C"
