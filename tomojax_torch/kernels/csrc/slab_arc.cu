// Arc-quadrature slab projector for Hopper (sm_90a): forward K3, its exact
// transpose K4, and the fused forward + Jacobian building blocks K5, behind
// a plain C interface (loaded with ctypes).
//
// K3 slab_arc_fwd replaces tomojax/kernels/slab.py:293 _fwd_kernel
// (quad="arc", entry slab_project_pallas). K4 slab_arc_adj replaces
// tomojax/kernels/slab.py:605 _adj_kernel (quad="arc", entry
// slab_backproject_pallas). K5 slab_arc_jac replaces
// tomojax/kernels/slab.py:446 _fwd_jac_kernel (entry
// slab_project_jac_pallas); it also serves the single-field entries that
// tomojax ran through _fwd_kernel with deriv/jweight/rweight (K6).
//
// The operator (tomojax.core.slab_projector._forward_oriented_xla, arc
// branch), for one view of an orientation group, source slab
// r = -1 .. ny-1 and branch b = 0 .. n_branch-1:
//   y0(u, v) = b1 + euy*u + evy*v,  jreal = (r - y0) / edy
//   j = ceil(jreal) + b, cfb = j - jreal (the ceil sawtooth), fy = edy*cfb
//   the sample counts iff 0 <= j < n_steps and fy < 1, and sits at
//   X = cx_r + eux*u + evx*v + edx*cfb           (pass B, x-lerp)
//   ζ(x, v) = cz_r + gzx*(x - cx_r - evx*v) + evz*v + edz*(cf(x, v) + b)
//     at each x-tap's GRID column x (pass A, z-lerp), where cf(x, v) is the
//     grid sawtooth of the affine inversion u_aff = (x - cx_r - evx*v)/eux:
//     jr = (r - (b1 + euy*u_aff + evy*v)) / edy, cf = ceil(jr) - jr
//   value = (1 - fy) * A_r(ζ) + fy * A_{r+1}(ζ), slab -1 and slab ny zero,
//   with cx_r = cxb + rx*r and cz_r = czb + rz*r.
// lerp: tap k = floor(p) has weight 1 - w, tap k + 1 weight w (w = p - k);
// taps outside the axis contribute zero.
//
// All three kernels compute the sample (j, cfb, fy, mask, X) and the grid
// sawtooth and ζ with the same __device__ functions, so they choose the
// same samples and taps and K4 holds exactly K3's matrix entries (CGLS
// needs the exact transpose). Those functions round every step explicitly
// (__fmul_rn/__fadd_rn/__fsub_rn, never contracted into an fma; IEEE
// division) in the order of the plain PyTorch version, which runs one
// elementwise op at a time: a ceil or floor that lands within a rounding
// of an integer then falls the same way in the kernels and in the plain
// version, so they also choose the same samples as each other.
//
// What bounds them on an H100: gathers and, for K4, candidate tests. A
// sample reads 2 x-taps x 2 slabs x 2 z-taps = 8 volume values; K3 puts v
// on the fastest thread index so a warp reads neighbouring z of one row.
// K4 is a gather with no atomics, one thread per oriented voxel (x, t, z),
// z fastest: for each view, source r = t (weight 1 - fy) and r = t - 1
// (weight fy), and branch b, it inverts ζ's affine part in v (widened by
// |edz| for the sawtooth) and X's affine part in u (widened by |edx|) and
// keeps the candidates that pass K3's exact tap and mask tests. K5 runs
// K3's march once with 12 accumulators. Nothing of the TPU design is
// carried over (selection/align matmuls, bf16 hi/lo split, band budget,
// lane padding, view bucketing): a Hopper thread gathers directly.

#include <cuda_runtime.h>

namespace {

// Per-view scalar layout: tomojax_torch/core/slab_projector.py S_*.
constexpr int NS = 21;
constexpr int S_EDY = 0, S_EDX = 1, S_EDZ = 2, S_RX = 3, S_RZ = 4,
              S_EUX = 5, S_EVX = 6, S_EVZ = 7, S_CXB = 8, S_CZB = 9,
              S_GZX = 10, S_B1 = 11, S_EUY = 12, S_EVY = 13;
// Jacobian building blocks, tomojax_torch/core/slab_projector.JAC_PASSES.
constexpr int NJP = 12;

struct Arc {
  float edy, edx, edz, rx, rz, eux, evx, evz, cxb, czb, gzx, b1, euy, evy,
      inv_eux;
};

__device__ __forceinline__ Arc load_arc(const float* __restrict__ s) {
  Arc p;
  p.edy = __ldg(s + S_EDY);
  p.edx = __ldg(s + S_EDX);
  p.edz = __ldg(s + S_EDZ);
  p.rx = __ldg(s + S_RX);
  p.rz = __ldg(s + S_RZ);
  p.eux = __ldg(s + S_EUX);
  p.evx = __ldg(s + S_EVX);
  p.evz = __ldg(s + S_EVZ);
  p.cxb = __ldg(s + S_CXB);
  p.czb = __ldg(s + S_CZB);
  p.gzx = __ldg(s + S_GZX);
  p.b1 = __ldg(s + S_B1);
  p.euy = __ldg(s + S_EUY);
  p.evy = __ldg(s + S_EVY);
  p.inv_eux = __fdiv_rn(1.0f, p.eux);
  return p;
}

// One rounding per operation, as the plain version's elementwise ops.
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// Slab offsets cx_r = cxb + rx*r and cz_r = czb + rz*r.
__device__ __forceinline__ float slab_cx(const Arc& p, float r) {
  return add(p.cxb, mul(p.rx, r));
}
__device__ __forceinline__ float slab_cz(const Arc& p, float r) {
  return add(p.czb, mul(p.rz, r));
}

// One arc sample of source slab r, branch b, at detector (u, v).
struct Sample {
  float j, cfb, fy, X;
  bool ok;
};

// March index (r - y0)/edy with y0 = (b1 + u*euy) + v*evy.
__device__ __forceinline__ float jreal_at(const Arc& p, float r, float u,
                                          float v) {
  const float y0 = add(add(p.b1, mul(u, p.euy)), mul(v, p.evy));
  return __fdiv_rn(sub(r, y0), p.edy);
}

__device__ __forceinline__ Sample sample_at(const Arc& p, float r, float cx,
                                            float u, float v, int b,
                                            int n_steps) {
  const float jreal = jreal_at(p, r, u, v);
  Sample s;
  s.j = ceilf(jreal) + static_cast<float>(b);
  s.cfb = sub(s.j, jreal);
  s.fy = mul(p.edy, s.cfb);
  s.ok = s.j >= 0.0f && s.j < static_cast<float>(n_steps) && s.fy < 1.0f;
  s.X = add(add(add(cx, mul(u, p.eux)), mul(v, p.evx)), mul(p.edx, s.cfb));
  return s;
}

// Pass A at grid column x: the grid sawtooth cf in [0, 1) and ζ's affine
// part zaff; ζ of branch b is zeta_at(p, cf + b, zaff).
__device__ __forceinline__ void grid_at(const Arc& p, float r, float cx,
                                        float cz, float x, float v, float* cf,
                                        float* zaff) {
  const float d = sub(sub(x, cx), mul(v, p.evx));
  const float jr = jreal_at(p, r, mul(d, p.inv_eux), v);
  *cf = sub(ceilf(jr), jr);
  *zaff = add(add(cz, mul(p.gzx, d)), mul(v, p.evz));
}

__device__ __forceinline__ float zeta_at(const Arc& p, float cfg,
                                         float zaff) {
  return add(zaff, mul(p.edz, cfg));
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

// The two taps of `pos` in a row of n values: lerp (h) and d/dpos (d).
__device__ __forceinline__ void row_taps(const float* __restrict__ row,
                                         float pos, int n, float* h,
                                         float* d) {
  const float f = floorf(pos);
  const int k = static_cast<int>(f);
  const float w = pos - f;
  const float a = (k >= 0 && k < n) ? __ldg(row + k) : 0.0f;
  const float c = (k + 1 >= 0 && k + 1 < n) ? __ldg(row + k + 1) : 0.0f;
  *h = (1.0f - w) * a + w * c;
  *d = c - a;
}

// Integer range [lo, hi] (clamped to [0, n)) holding every index i with
// lo_val < a + b * i < hi_val, widened by one on each side against
// rounding; the exact tap and mask tests decide.
__device__ __forceinline__ void index_range(float a, float b, float lo_val,
                                            float hi_val, int n, int* lo,
                                            int* hi) {
  if (fabsf(b) < 1e-6f) {
    *lo = 0;
    *hi = n - 1;
    return;
  }
  const float t0 = (lo_val - a) / b;
  const float t1 = (hi_val - a) / b;
  const float lim = static_cast<float>(n) + 1.0f;
  const float tl = fminf(fmaxf(fminf(t0, t1), -2.0f), lim);
  const float th = fminf(fmaxf(fmaxf(t0, t1), -2.0f), lim);
  *lo = max(0, static_cast<int>(floorf(tl)) - 1);
  *hi = min(n - 1, static_cast<int>(ceilf(th)) + 1);
}

// K3: one thread per (view, u, v) of the group, v fastest; marches the
// source slabs and branches. vol: (nx, ny, nz), scalars: (V, NS),
// out: (V, nu, nv).
__global__ void __launch_bounds__(256)
arc_fwd_kernel(const float* __restrict__ vol,
               const float* __restrict__ scalars, float* __restrict__ out,
               int V, int nx, int ny, int nz, int nu, int nv, int n_steps,
               int n_branch) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= V * nu * nv) return;
  const int v = tid % nv;
  const int u = (tid / nv) % nu;
  const int view = tid / (nu * nv);
  const Arc p = load_arc(scalars + view * NS);
  const float fu = static_cast<float>(u), fv = static_cast<float>(v);
  float acc = 0.0f;
  for (int ri = -1; ri < ny; ++ri) {
    const float r = static_cast<float>(ri);
    const float cx = slab_cx(p, r);
    const float cz = slab_cz(p, r);
    for (int b = 0; b < n_branch; ++b) {
      const Sample s = sample_at(p, r, cx, fu, fv, b, n_steps);
      if (!s.ok) continue;
      const float xf = floorf(s.X);
      const int x0 = static_cast<int>(xf);
      const float wx = s.X - xf;
      float sval = 0.0f;
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int xi = x0 + o;
        if (xi < 0 || xi >= nx) continue;
        float cf, zaff;
        grid_at(p, r, cx, cz, static_cast<float>(xi), fv, &cf, &zaff);
        const float zeta = zeta_at(p, add(cf, static_cast<float>(b)), zaff);
        float h0 = 0.0f, h1 = 0.0f, d;
        if (ri >= 0)
          row_taps(vol + (static_cast<size_t>(xi) * ny + ri) * nz, zeta, nz,
                   &h0, &d);
        if (ri + 1 < ny)
          row_taps(vol + (static_cast<size_t>(xi) * ny + ri + 1) * nz, zeta,
                   nz, &h1, &d);
        sval += (o ? wx : 1.0f - wx) * ((1.0f - s.fy) * h0 + s.fy * h1);
      }
      acc += sval;
    }
  }
  out[tid] = acc;
}

// K5: K3's march with the 12 building blocks accumulated at once.
// out: (V, NJP, nu, nv) in JAC_PASSES order
// (val, px, py, pz, jx, jy, jz, rx, ry, rz, zm, zc).
__global__ void __launch_bounds__(256)
arc_jac_kernel(const float* __restrict__ vol,
               const float* __restrict__ scalars, float* __restrict__ out,
               int V, int nx, int ny, int nz, int nu, int nv, int n_steps,
               int n_branch) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= V * nu * nv) return;
  const int v = tid % nv;
  const int u = (tid / nv) % nu;
  const int view = tid / (nu * nv);
  const Arc p = load_arc(scalars + view * NS);
  const float fu = static_cast<float>(u), fv = static_cast<float>(v);
  float acc[NJP];
#pragma unroll
  for (int f = 0; f < NJP; ++f) acc[f] = 0.0f;
  for (int ri = -1; ri < ny; ++ri) {
    const float r = static_cast<float>(ri);
    const float cx = slab_cx(p, r);
    const float cz = slab_cz(p, r);
    for (int b = 0; b < n_branch; ++b) {
      const Sample s = sample_at(p, r, cx, fu, fv, b, n_steps);
      if (!s.ok) continue;
      const float xf = floorf(s.X);
      const int x0 = static_cast<int>(xf);
      const float wx = s.X - xf;
      const float mom = wx * (1.0f - wx);
      float a_val = 0.0f, a_px = 0.0f, a_py = 0.0f, a_pz = 0.0f,
            a_zm = 0.0f, a_zc = 0.0f;
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int xi = x0 + o;
        if (xi < 0 || xi >= nx) continue;
        const float w_h = o ? wx : 1.0f - wx;   // hat
        const float w_d = o ? 1.0f : -1.0f;     // hat'
        const float w_m = o ? mom : -mom;       // (tap - X) moment
        float cf, zaff;
        grid_at(p, r, cx, cz, static_cast<float>(xi), fv, &cf, &zaff);
        const float cfg = add(cf, static_cast<float>(b));
        const float zeta = zeta_at(p, cfg, zaff);
        float h0 = 0.0f, d0 = 0.0f, h1 = 0.0f, d1 = 0.0f;
        if (ri >= 0)
          row_taps(vol + (static_cast<size_t>(xi) * ny + ri) * nz, zeta, nz,
                   &h0, &d0);
        if (ri + 1 < ny)
          row_taps(vol + (static_cast<size_t>(xi) * ny + ri + 1) * nz, zeta,
                   nz, &h1, &d1);
        const float lerp_h = (1.0f - s.fy) * h0 + s.fy * h1;
        const float lerp_d = (1.0f - s.fy) * d0 + s.fy * d1;
        a_val += w_h * lerp_h;
        a_px += w_d * lerp_h;
        a_py += w_h * (h1 - h0);
        a_pz += w_h * lerp_d;
        a_zm += w_m * lerp_d;
        a_zc += w_h * (lerp_d * cfg);
      }
      acc[0] += a_val;
      acc[1] += a_px;
      acc[2] += a_py;
      acc[3] += a_pz;
      acc[4] += s.j * a_px;
      acc[5] += s.j * a_py;
      acc[6] += s.j * a_pz;
      acc[7] += r * a_px;
      acc[8] += r * a_py;
      acc[9] += r * a_pz;
      acc[10] += a_zm;
      acc[11] += a_zc;
    }
  }
  const size_t plane = static_cast<size_t>(nu) * nv;
  float* o = out + static_cast<size_t>(view) * NJP * plane +
             static_cast<size_t>(u) * nv + v;
#pragma unroll
  for (int f = 0; f < NJP; ++f) o[f * plane] = acc[f];
}

// K4: one thread per oriented voxel (x, t, z), z fastest; loops over the
// group's views and gathers the cotangent g: (V, nu, nv) -> vol (nx, ny, nz).
__global__ void __launch_bounds__(256)
arc_adj_kernel(const float* __restrict__ g, const float* __restrict__ scalars,
               float* __restrict__ vol, int V, int nx, int ny, int nz, int nu,
               int nv, int n_steps, int n_branch) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= nx * ny * nz) return;
  const int z = tid % nz;
  const int t = (tid / nz) % ny;
  const int x = tid / (ny * nz);
  const float fx = static_cast<float>(x), fz = static_cast<float>(z);
  float acc = 0.0f;
  for (int view = 0; view < V; ++view) {
    const Arc p = load_arc(scalars + view * NS);
    const float* gv = g + static_cast<size_t>(view) * nu * nv;
    float sum_view = 0.0f;
    // side 0: this voxel is slab r = t of the pair (weight 1 - fy);
    // side 1: it is slab r + 1 of source r = t - 1 (weight fy)
    for (int side = 0; side < 2; ++side) {
      const float r = static_cast<float>(t - side);
      const float cx = slab_cx(p, r);
      const float cz = slab_cz(p, r);
      const float zav = p.evz - p.gzx * p.evx;
      const float za0 = fmaf(p.gzx, fx - cx, cz);
      const float xa0 = cx;
      for (int b = 0; b < n_branch; ++b) {
        const float fb = static_cast<float>(b);
        // ζ(v) = za0 + zav*v + edz*(cf + b), cf in [0, 1)
        const float ez0 = p.edz * fb, ez1 = p.edz * (fb + 1.0f);
        int vlo, vhi;
        index_range(za0, zav, fz - 1.0f - fmaxf(ez0, ez1),
                    fz + 1.0f - fminf(ez0, ez1), nv, &vlo, &vhi);
        // X(u) = cx + evx*v + eux*u + edx*cfb, cfb in [b, b + 1)
        const float ex0 = p.edx * fb, ex1 = p.edx * (fb + 1.0f);
        for (int v = vlo; v <= vhi; ++v) {
          const float fv = static_cast<float>(v);
          float cf, zaff;
          grid_at(p, r, cx, cz, fx, fv, &cf, &zaff);
          const float wz = tap_weight(zeta_at(p, add(cf, fb), zaff), z);
          if (wz == 0.0f) continue;
          int ulo, uhi;
          index_range(fmaf(p.evx, fv, xa0), p.eux,
                      fx - 1.0f - fmaxf(ex0, ex1),
                      fx + 1.0f - fminf(ex0, ex1), nu, &ulo, &uhi);
          float sum_u = 0.0f;
          for (int u = ulo; u <= uhi; ++u) {
            const Sample s =
                sample_at(p, r, cx, static_cast<float>(u), fv, b, n_steps);
            if (!s.ok) continue;
            const float wx = tap_weight(s.X, x);
            if (wx == 0.0f) continue;
            sum_u += wx * (side ? s.fy : 1.0f - s.fy) * __ldg(gv + u * nv + v);
          }
          sum_view += wz * sum_u;
        }
      }
    }
    acc += sum_view;
  }
  vol[tid] = acc;
}

constexpr int kThreads = 256;

int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int slab_arc_fwd(const float* vol, const float* scalars, float* out, int V,
                 int nx, int ny, int nz, int nu, int nv, int n_steps,
                 int n_branch, void* stream) {
  const long long n = static_cast<long long>(V) * nu * nv;
  if (n > 0) {
    arc_fwd_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        vol, scalars, out, V, nx, ny, nz, nu, nv, n_steps, n_branch);
  }
  return static_cast<int>(cudaGetLastError());
}

int slab_arc_adj(const float* g, const float* scalars, float* vol, int V,
                 int nx, int ny, int nz, int nu, int nv, int n_steps,
                 int n_branch, void* stream) {
  const long long n = static_cast<long long>(nx) * ny * nz;
  if (n > 0) {
    arc_adj_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        g, scalars, vol, V, nx, ny, nz, nu, nv, n_steps, n_branch);
  }
  return static_cast<int>(cudaGetLastError());
}

int slab_arc_jac(const float* vol, const float* scalars, float* out, int V,
                 int nx, int ny, int nz, int nu, int nv, int n_steps,
                 int n_branch, void* stream) {
  const long long n = static_cast<long long>(V) * nu * nv;
  if (n > 0) {
    arc_jac_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        vol, scalars, out, V, nx, ny, nz, nu, nv, n_steps, n_branch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
