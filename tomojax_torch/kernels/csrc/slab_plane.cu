// Plane-quadrature slab projector for Hopper (sm_90a): forward K1 and its
// exact transpose K2, behind a plain C interface (loaded with ctypes).
//
// K1 slab_plane_fwd replaces tomojax/kernels/slab.py:293 _fwd_kernel
// (quad="plane", entry slab_project_pallas). K2 slab_plane_adj replaces
// tomojax/kernels/slab.py:605 _adj_kernel (quad="plane", entry
// slab_backproject_pallas).
//
// The operator (tomojax.core.slab_projector._forward_oriented_xla, plane
// branch), for one view of an orientation group and slab r = 0..ny-1:
//   pass A  T_r[x, v] = lerp_z(vol[x, r, :], zeta_r(x, v)),
//           zeta_r(x, v) = cz_r + gzx * (x - cx_r) + zav * v  (x on the grid)
//   pass B  out[u, v] += lerp_x(T_r[:, v], X_r(u, v)),
//           X_r(u, v)    = cx_r + eux * u + evx * v
//   with cx_r = cxb + rx * r, cz_r = czb + rz * r, and out scaled by 1/edy.
// lerp: tap k = floor(p) has weight 1 - w, tap k + 1 weight w (w = p - k),
// taps outside the axis contribute zero.
//
// What bounds these kernels on an H100: gathers. Each sample reads about
// four volume values (2 x-taps x 2 z-taps) and does ~20 flops, so both
// kernels are bound by L1/L2 gather traffic, not by HBM bandwidth or
// arithmetic. The design keeps those reads coalesced: K1 puts v on the
// fastest thread index (zav ~ 1, so neighbouring threads read neighbouring
// z of one row of vol[x, r, :]); K2 puts z on the fastest index (neighbours
// read neighbouring v of the cotangent). Nothing of the TPU design is
// carried over (one-hot selection matmuls, bf16 hi/lo split, band budget,
// lane padding, view bucketing): a Hopper thread gathers directly.
//
// K2 is a gather with no atomics: one thread per oriented voxel inverts the
// affine maps (zeta is affine in v, X is affine in u with eux > 0) to find
// the few (u, v) whose taps reach it, and writes the voxel once. X and zeta
// come from the same __device__ functions in both kernels, with the same
// operation order and the same tap selection, so the two kernels hold the
// same matrix entries in float32 and stay an exact transpose pair (CGLS
// needs that).

#include <cuda_runtime.h>

namespace {

// Per-view scalar layout: tomojax_torch/core/slab_projector.py S_*.
constexpr int NS = 21;
constexpr int S_RX = 3, S_RZ = 4, S_EUX = 5, S_EVX = 6, S_CXB = 8,
              S_CZB = 9, S_GZX = 10, S_SCALE = 17, S_ZAV = 20;

struct Plane {
  float rx, rz, eux, evx, cxb, czb, gzx, zav, scale;
};

__device__ __forceinline__ Plane load_plane(const float* __restrict__ s) {
  Plane p;
  p.rx = __ldg(s + S_RX);
  p.rz = __ldg(s + S_RZ);
  p.eux = __ldg(s + S_EUX);
  p.evx = __ldg(s + S_EVX);
  p.cxb = __ldg(s + S_CXB);
  p.czb = __ldg(s + S_CZB);
  p.gzx = __ldg(s + S_GZX);
  p.zav = __ldg(s + S_ZAV);
  p.scale = __ldg(s + S_SCALE);
  return p;
}

// Pass-B position X_r(u, v). Explicit fmaf keeps one rounding sequence in
// both kernels whatever the compiler contracts.
__device__ __forceinline__ float plane_X(const Plane& p, float r, float u,
                                         float v) {
  const float cx = fmaf(p.rx, r, p.cxb);
  return fmaf(p.evx, v, fmaf(p.eux, u, cx));
}

// Pass-A position zeta_r(x, v) at grid column x.
__device__ __forceinline__ float plane_zeta(const Plane& p, float r, float x,
                                            float v) {
  const float cx = fmaf(p.rx, r, p.cxb);
  const float cz = fmaf(p.rz, r, p.czb);
  return fmaf(p.zav, v, fmaf(p.gzx, x - cx, cz));
}

// Lerp weight that position `pos` gives integer tap `k` (0 if none).
__device__ __forceinline__ float tap_weight(float pos, int k) {
  const float f = floorf(pos);
  const int k0 = static_cast<int>(f);
  const float w = pos - f;
  if (k == k0) return 1.0f - w;
  if (k == k0 + 1) return w;
  return 0.0f;
}

// Integer range [lo, hi] (clamped to [0, n)) holding every index i with
// a + b * i in (c - 1, c + 1), widened by one on each side against
// rounding; the tap test above decides exactly.
__device__ __forceinline__ void index_range(float a, float b, float c, int n,
                                            int* lo, int* hi) {
  if (fabsf(b) < 1e-6f) {
    *lo = 0;
    *hi = n - 1;
    return;
  }
  float t0 = (c - 1.0f - a) / b;
  float t1 = (c + 1.0f - a) / b;
  const float tl = fmaxf(fminf(t0, t1), -2.0f);
  const float th = fminf(fmaxf(t0, t1), static_cast<float>(n) + 1.0f);
  *lo = max(0, static_cast<int>(floorf(tl)) - 1);
  *hi = min(n - 1, static_cast<int>(ceilf(th)) + 1);
}

// K1: one thread per (view, u, v) of the group, v fastest; loops over the
// slabs. vol: (nx, ny, nz), scalars: (V, NS), out: (V, nu, nv).
__global__ void __launch_bounds__(256)
fwd_kernel(const float* __restrict__ vol, const float* __restrict__ scalars,
           float* __restrict__ out, int V, int nx, int ny, int nz, int nu,
           int nv) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= V * nu * nv) return;
  const int v = tid % nv;
  const int u = (tid / nv) % nu;
  const int view = tid / (nu * nv);
  const Plane p = load_plane(scalars + view * NS);
  const float fu = static_cast<float>(u), fv = static_cast<float>(v);
  float acc = 0.0f;
  for (int r = 0; r < ny; ++r) {
    const float fr = static_cast<float>(r);
    const float X = plane_X(p, fr, fu, fv);
    const float xf = floorf(X);
    const int x0 = static_cast<int>(xf);
    const float wx = X - xf;
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int xi = x0 + o;
      if (xi < 0 || xi >= nx) continue;
      const float zeta = plane_zeta(p, fr, static_cast<float>(xi), fv);
      const float zf = floorf(zeta);
      const int z0 = static_cast<int>(zf);
      const float wz = zeta - zf;
      const float* row = vol + (static_cast<size_t>(xi) * ny + r) * nz;
      float val = 0.0f;
      if (z0 >= 0 && z0 < nz) val += (1.0f - wz) * __ldg(row + z0);
      if (z0 + 1 >= 0 && z0 + 1 < nz) val += wz * __ldg(row + z0 + 1);
      acc += (o ? wx : 1.0f - wx) * val;
    }
  }
  out[tid] = acc * p.scale;
}

// K2: one thread per oriented voxel (x, r, z), z fastest; loops over the
// group's views and gathers the cotangent g: (V, nu, nv) -> vol (nx, ny, nz).
__global__ void __launch_bounds__(256)
adj_kernel(const float* __restrict__ g, const float* __restrict__ scalars,
           float* __restrict__ vol, int V, int nx, int ny, int nz, int nu,
           int nv) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= nx * ny * nz) return;
  const int z = tid % nz;
  const int r = (tid / nz) % ny;
  const int x = tid / (ny * nz);
  const float fx = static_cast<float>(x), fr = static_cast<float>(r),
              fz = static_cast<float>(z);
  float acc = 0.0f;
  for (int view = 0; view < V; ++view) {
    const Plane p = load_plane(scalars + view * NS);
    const float* gv = g + static_cast<size_t>(view) * nu * nv;
    int vlo, vhi;
    index_range(plane_zeta(p, fr, fx, 0.0f), p.zav, fz, nv, &vlo, &vhi);
    float sum_view = 0.0f;
    for (int v = vlo; v <= vhi; ++v) {
      const float fv = static_cast<float>(v);
      const float wz = tap_weight(plane_zeta(p, fr, fx, fv), z);
      if (wz == 0.0f) continue;
      int ulo, uhi;
      index_range(plane_X(p, fr, 0.0f, fv), p.eux, fx, nu, &ulo, &uhi);
      float sum_u = 0.0f;
      for (int u = ulo; u <= uhi; ++u) {
        const float wx =
            tap_weight(plane_X(p, fr, static_cast<float>(u), fv), x);
        if (wx != 0.0f) sum_u += wx * __ldg(gv + u * nv + v);
      }
      sum_view += wz * sum_u;
    }
    acc += sum_view * p.scale;
  }
  vol[tid] = acc;
}

constexpr int kThreads = 256;

int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int slab_plane_fwd(const float* vol, const float* scalars, float* out, int V,
                   int nx, int ny, int nz, int nu, int nv, void* stream) {
  const long long n = static_cast<long long>(V) * nu * nv;
  if (n > 0) {
    fwd_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(vol, scalars, out, V,
                                                      nx, ny, nz, nu, nv);
  }
  return static_cast<int>(cudaGetLastError());
}

int slab_plane_adj(const float* g, const float* scalars, float* vol, int V,
                   int nx, int ny, int nz, int nu, int nv, void* stream) {
  const long long n = static_cast<long long>(nx) * ny * nz;
  if (n > 0) {
    adj_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(g, scalars, vol, V, nx,
                                                      ny, nz, nu, nv);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
