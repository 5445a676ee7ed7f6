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
// one row index (stride 0) is never copied. Offsets are (V, R1, R2)
// contiguous, slopes (V,), outputs contiguous.
//
// What bounds these kernels on an H100: HBM bytes. Each output costs one
// 4-byte store and ~7 flops, each row is read once, so both kernels sit far
// below the card's flop-per-byte ridge. The TPU design (per-row lane roll,
// window extraction and a one-hot selection matmul on the MXU, 128-lane
// chunks) exists because Mosaic cannot gather; a Hopper thread can. The
// design here: a CTA stages a tile of rows in shared memory with coalesced
// loads, then neighbouring threads compute neighbouring outputs i (for
// |slope| ~ 1 they read neighbouring shared-memory words, without bank
// conflicts) and store them coalesced.
//
// K8 is a gather with no atomics, so its sums come out the same on every
// run: one thread per input element n of a row inverts the affine map to
// the few i whose taps reach n, widened by the position's rounding error
// (index_range) and by one, and lets K7's own tap test decide. The position is computed by the same __device__
// function in both kernels, rounding each step (__fmul_rn/__fadd_rn) in the
// plain PyTorch version's order, so K7, K8 and the plain version choose the
// same taps to the last bit and K8 is K7's exact transpose in float32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;             // rows staged per CTA
constexpr int kSmemBudget = 48 * 1024;   // bytes of staging per CTA, default
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

// K7: grid (row tiles, views). Shared memory: rows x N floats.
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ arr, const float* __restrict__ off,
           const float* __restrict__ slope, float* __restrict__ out, int R1,
           int R2, int N, int M, long long sv, long long s1, long long s2,
           int rows) {
  extern __shared__ float tile[];
  const long long view = blockIdx.y;
  const long long R = static_cast<long long>(R1) * R2;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int nrows = static_cast<int>(min(static_cast<long long>(rows),
                                         R - row0));
  for (int r = 0; r < nrows; ++r) {
    const float* src = arr + row_base(view, row0 + r, R2, sv, s1, s2);
    for (int n = threadIdx.x; n < N; n += kThreads)
      tile[r * N + n] = __ldg(src + n);
  }
  __syncthreads();
  const float s = __ldg(slope + view);
  const float last = static_cast<float>(N - 1);
  for (int r = 0; r < nrows; ++r) {
    const long long a = view * R + row0 + r;
    const float o = __ldg(off + a);
    const float* src = tile + r * N;
    float* dst = out + a * M;
    for (int i = threadIdx.x; i < M; i += kThreads) {
      const float pos = position(o, s, i);
      const float kf = floorf(pos);
      const float t = __fsub_rn(pos, kf);
      // masks in float: NaN or huge positions never form an index
      const float v0 =
          (kf >= 0.0f && kf <= last) ? src[static_cast<int>(kf)] : 0.0f;
      const float v1 = (kf >= -1.0f && kf <= last - 1.0f)
                           ? src[static_cast<int>(kf) + 1]
                           : 0.0f;
      dst[i] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, t), v0), __fmul_rn(t, v1));
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

// Rows per CTA so that the staged tile fits the default shared memory;
// returns the tile's bytes through `smem` (0 rows if one row is too long).
int tile_rows(int width, int* smem) {
  const long long row_bytes = 4LL * width;
  int rows = static_cast<int>(kSmemBudget / row_bytes);
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  if (row_bytes > kSmemMax) return 0;
  *smem = static_cast<int>(rows * row_bytes);
  return rows;
}

template <typename Kernel>
int launch(Kernel kernel, int width, int V, long long R, void* stream,
           const float* in, const float* off, const float* slope, float* out,
           int R1, int R2, int N, int M, long long sv, long long s1,
           long long s2) {
  if (V <= 0 || R <= 0 || M <= 0 || N <= 0) return 0;
  if (V > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  int smem = 0;
  const int rows = tile_rows(width, &smem);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemBudget) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long tiles = (R + rows - 1) / rows;
  if (tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(V));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, off, slope, out, R1, R2, N, M, sv, s1, s2, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// arr: rows of N floats at view * sv + a1 * s1 + a2 * s2 (a1 < R1, a2 < R2);
// off: (V, R1, R2); slope: (V,); out: (V, R1, R2, M), all contiguous.
int resample_fwd(const float* arr, const float* off, const float* slope,
                 float* out, int V, int R1, int R2, int N, int M, long long sv,
                 long long s1, long long s2, void* stream) {
  return launch(fwd_kernel, N, V, static_cast<long long>(R1) * R2, stream,
                arr, off, slope, out, R1, R2, N, M, sv, s1, s2);
}

// g: cotangent rows of M floats at view * gv + a1 * g1 + a2 * g2;
// off, slope as K7; out: (V, R1, R2, N) contiguous.
int resample_transpose(const float* g, const float* off, const float* slope,
                       float* out, int V, int R1, int R2, int N, int M,
                       long long gv, long long g1, long long g2,
                       void* stream) {
  return launch(transpose_kernel, M, V, static_cast<long long>(R1) * R2,
                stream, g, off, slope, out, R1, R2, N, M, gv, g1, g2);
}

}  // extern "C"
