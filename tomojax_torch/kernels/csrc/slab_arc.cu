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
// K5 runs K3's march once with 12 accumulators.
//
// K4 uses that the operator is separable: ζ depends on (x, v, r, b) and
// never on u, so the transpose factors into two 1-D gathers, source-major
// as tomojax's own adjoint (tomojax/kernels/slab.py:605-700). A CTA owns
// one source slab r and a tile of oriented (x, z); for each view and
// branch it
//   1. stages the samples (X, ok·g, ok·fy·g) of the (u, v) window whose
//      x-taps can reach the tile, each computed once, in shared memory;
//   2. pass-B transpose: T_all(x, v) = Σ_u w_x·ok·g and T_fy(x, v) =
//      Σ_u w_x·ok·fy·g over the staged u whose x-taps reach x, and ζ(x, v)
//      once per (x, v), into shared memory;
//   3. pass-A transpose: for each voxel (x, z), w_z·(T_all - T_fy) for
//      target slab r (side 0) and w_z·T_fy for target slab r + 1 (side 1)
//      over the v whose ζ-taps reach z, accumulated over the views in
//      shared memory.
// Windows come from the affine parts of X (in u) and ζ (in v), widened by
// the sawtooth (|edx|, |edz|) and by one index; K3's exact tap and mask
// tests decide, on the same samples, so K4 holds exactly K3's entries.
// Each transpose runs as sweeps by owners: a thread owns a few columns x
// of one row v (pass B) or a few voxels z of one column x (pass A), sweeps
// their joint window once and adds each candidate's two taps into its own
// slots, instead of scanning a window per point. What bounds it: the
// sample and ζ evaluations (an IEEE division each) and the shared-memory
// sweeps, not bytes. It uses no atomics:
// target slab t receives side 0 from the CTAs of source t and side 1 from
// those of source t - 1, written into two partial volumes that a second
// small kernel adds, so two applies give the same bits (CGLS repeats its
// digits). Nothing of the TPU design is carried over (selection/align
// matmuls, bf16 hi/lo split, band budget, lane padding, view bucketing).

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
// rounding (of the affine value and of the reciprocal inv_b = 1/b, both a
// few ulps); the exact tap and mask tests decide. The result is monotone
// in a, lo_val and hi_val, so the range of a tile's extreme corners holds
// the range of every point inside it.
__device__ __forceinline__ void index_range(float a, float b, float inv_b,
                                            float lo_val, float hi_val, int n,
                                            int* lo, int* hi) {
  if (fabsf(b) < 1e-6f) {
    *lo = 0;
    *hi = n - 1;
    return;
  }
  const float t0 = (lo_val - a) * inv_b;
  const float t1 = (hi_val - a) * inv_b;
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

// K4 tiling. A CTA owns source slab r and the oriented voxels (x, z) of a
// kTX x kTZ tile; it stages samples in chunks of kUC detector columns x kVC
// detector rows (one chunk each at config 4's 256^3: the u window of 32
// columns is ~40 wide, the v window of 64 z ~70). Each transpose is a
// sweep by owners: a pass-B thread owns kXR columns x of one row v and
// sweeps the u window of those columns once; a pass-A thread owns kZR
// voxels z of one column x and sweeps their v window once. An owner adds
// each candidate's two taps into its own shared-memory slots, so no slot
// has two writers and every sum runs in one fixed order.
constexpr int kAdjThreads = 256;
constexpr int kTX = 32, kTZ = 64;
constexpr int kUC = 44, kVC = 72;
constexpr int kXR = 8, kZR = 8;                // owned x (pass B), z (pass A)
constexpr int kVP = kVC + 1;                   // T, ζ pitch: pass A's lanes
constexpr int kAP = kTZ + 1;                   // acc pitch: run along x
constexpr int kAdjSmem =
    16 * kUC * kVC + 2 * 8 * kTX * kVP + 8 * kTX * kAP;

// Union of index_range over the two extreme values of a monotone affine
// argument: a superset of every point's range in between.
__device__ __forceinline__ void range_union(float a0, float a1, float b,
                                            float inv_b, float lo_val,
                                            float hi_val, int n, int* lo,
                                            int* hi) {
  int l0, h0, l1, h1;
  index_range(a0, b, inv_b, lo_val, hi_val, n, &l0, &h0);
  index_range(a1, b, inv_b, lo_val, hi_val, n, &l1, &h1);
  *lo = min(l0, l1);
  *hi = max(h0, h1);
}

// A position's lerp taps as (k = floor, w = fraction): tap k weighs 1 - w
// and tap k + 1 weighs w, as in row_taps. The floor is clamped to
// [lo - 2, hi + 2] (its taps then miss [lo, hi] exactly when the unclamped
// ones do) and carried as int bits, so an owner tests a candidate with an
// integer compare.
__device__ __forceinline__ float2 tap_code(float pos, float lo, float hi) {
  const float f = floorf(pos);
  const int k = static_cast<int>(fminf(fmaxf(f, lo - 2.0f), hi + 2.0f));
  return make_float2(__int_as_float(k), pos - f);
}

// K4: grid (z tiles, x tiles, source slabs r = -1 .. ny-1); gathers the
// cotangent g: (V, nu, nv) into side0 (slab r, from source r) and side1
// (slab r + 1, from source r), both (nx, ny, nz). Every voxel of both is
// written exactly once.
__global__ void __launch_bounds__(kAdjThreads, 2)
arc_adj_kernel(const float* __restrict__ g, const float* __restrict__ scalars,
               float* __restrict__ side0, float* __restrict__ side1, int V,
               int nx, int ny, int nz, int nu, int nv, int n_steps,
               int n_branch) {
  extern __shared__ __align__(16) float sm[];
  // [ul][vl] samples: (x-tap code, ok ? g : 0, ok ? fy*g : 0)
  float4* const sS = reinterpret_cast<float4*>(sm);
  float2* const sT = reinterpret_cast<float2*>(sS + kUC * kVC);  // [xl][vl]
  float2* const sZ = sT + kTX * kVP;     // [xl][vl] ζ's z-tap code
  float2* const sA = sZ + kTX * kVP;     // [xl][zl] (side 0, side 1)
  const int tid = threadIdx.x;
  const int z0 = blockIdx.x * kTZ, x0 = blockIdx.y * kTX;
  const int ri = static_cast<int>(blockIdx.z) - 1;
  const float r = static_cast<float>(ri);
  const int ntx = min(kTX, nx - x0), ntz = min(kTZ, nz - z0);
  const float fxa = static_cast<float>(x0);
  const float fxb = static_cast<float>(x0 + ntx - 1);
  const float fza = static_cast<float>(z0);
  const float fzb = static_cast<float>(z0 + ntz - 1);
  // this thread's pass-A voxels: column xa_l, z in [za_o, zb_o]
  const int xa_l = tid % kTX;
  const int za_o = z0 + (tid / kTX) * kZR;
  const int zb_o = min(za_o + kZR, z0 + ntz) - 1;
  const bool owns_a = xa_l < ntx && za_o <= zb_o;
  for (int z = za_o; z <= zb_o; ++z)
    sA[xa_l * kAP + (z - z0)] = make_float2(0.0f, 0.0f);

  for (int view = 0; view < V; ++view) {
    const Arc p = load_arc(scalars + view * NS);
    const float* gv = g + static_cast<size_t>(view) * nu * nv;
    const float cx = slab_cx(p, r);
    const float cz = slab_cz(p, r);
    // ζ's affine part in v: za(x) + zav*v, za(x) = cz + gzx*(x - cx)
    const float zav = p.evz - p.gzx * p.evx;
    const float inv_zav = 1.0f / zav;
    const float za_a = fmaf(p.gzx, fxa - cx, cz);
    const float za_b = fmaf(p.gzx, fxb - cx, cz);
    for (int b = 0; b < n_branch; ++b) {
      const float fb = static_cast<float>(b);
      // the sawtooth terms: edz*(cf + b) and edx*cfb, cf + b and cfb in
      // [b, b + 1]
      const float ez0 = p.edz * fb, ez1 = p.edz * (fb + 1.0f);
      const float ex0 = p.edx * fb, ex1 = p.edx * (fb + 1.0f);
      const float ezmax = fmaxf(ez0, ez1), ezmin = fminf(ez0, ez1);
      const float exmax = fmaxf(ex0, ex1), exmin = fminf(ex0, ex1);
      // the v whose ζ-taps can reach the tile's z
      int vlo, vhi;
      range_union(za_a, za_b, zav, inv_zav, fza - 1.0f - ezmax,
                  fzb + 1.0f - ezmin, nv, &vlo, &vhi);
      for (int vc0 = vlo; vc0 <= vhi; vc0 += kVC) {
        const int vc1 = min(vhi, vc0 + kVC - 1);
        const int nvw = vc1 - vc0 + 1;
        // the u whose x-taps can reach the tile's x, for these v
        int ulo, uhi;
        range_union(fmaf(p.evx, static_cast<float>(vc0), cx),
                    fmaf(p.evx, static_cast<float>(vc1), cx), p.eux,
                    p.inv_eux, fxa - 1.0f - exmax, fxb + 1.0f - exmin,
                    nu, &ulo, &uhi);
        bool any_ok = false;   // block-uniform
        for (int uc0 = ulo; uc0 <= uhi; uc0 += kUC) {
          const int uc1 = min(uhi, uc0 + kUC - 1);
          const int nuw = uc1 - uc0 + 1;
          // 1. samples, each once
          int ok_here = 0;
          for (int e = tid; e < nuw * kVC; e += kAdjThreads) {
            const int ul = e / kVC, vl = e - ul * kVC;
            if (vl >= nvw) continue;
            const int u = uc0 + ul, v = vc0 + vl;
            const Sample s = sample_at(p, r, cx, static_cast<float>(u),
                                       static_cast<float>(v), b, n_steps);
            float gw = 0.0f, gy = 0.0f;
            if (s.ok) {
              gw = __ldg(gv + static_cast<size_t>(u) * nv + v);
              gy = s.fy * gw;
              ok_here = 1;
            }
            const float2 c = tap_code(s.X, fxa, fxb);
            sS[e] = make_float4(c.x, c.y, gw, gy);
          }
          if (!__syncthreads_or(ok_here)) continue;
          const bool first = !any_ok;
          any_ok = true;
          // 2. pass-B transpose: owners of (kXR columns x, one row v)
          for (int e = tid; e < (kTX / kXR) * kVC; e += kAdjThreads) {
            const int xr = e / kVC, vl = e - xr * kVC;
            const int xa = x0 + xr * kXR;
            const int xb = min(xa + kXR, x0 + ntx) - 1;
            if (vl >= nvw || xa > xb) continue;
            const float fv = static_cast<float>(vc0 + vl);
            if (first) {
              for (int x = xa; x <= xb; ++x) {
                float cf, zaff;
                grid_at(p, r, cx, cz, static_cast<float>(x), fv, &cf, &zaff);
                sZ[(x - x0) * kVP + vl] =
                    tap_code(zeta_at(p, add(cf, fb), zaff), fza, fzb);
                sT[(x - x0) * kVP + vl] = make_float2(0.0f, 0.0f);
              }
            }
            int lo, hi;
            index_range(fmaf(p.evx, fv, cx), p.eux, p.inv_eux,
                        static_cast<float>(xa) - 1.0f - exmax,
                        static_cast<float>(xb) + 1.0f - exmin, nu, &lo, &hi);
            lo = max(lo, uc0);
            hi = min(hi, uc1);
            for (int u = lo; u <= hi; ++u) {
              const float4 smp = sS[(u - uc0) * kVC + vl];
              const int k = __float_as_int(smp.x);
#pragma unroll
              for (int o = 0; o < 2; ++o) {
                const int x = k + o;
                if (x < xa || x > xb) continue;
                const float wx = o ? smp.y : 1.0f - smp.y;
                float2* t = sT + (x - x0) * kVP + vl;
                *t = make_float2(t->x + wx * smp.z, t->y + wx * smp.w);
              }
            }
          }
          __syncthreads();
        }
        if (!any_ok || !owns_a) continue;
        // 3. pass-A transpose: this thread's voxels sweep their v window
        const float fx = static_cast<float>(x0 + xa_l);
        int lo, hi;
        index_range(fmaf(p.gzx, fx - cx, cz), zav, inv_zav,
                    static_cast<float>(za_o) - 1.0f - ezmax,
                    static_cast<float>(zb_o) + 1.0f - ezmin, nv, &lo, &hi);
        lo = max(lo, vc0);
        hi = min(hi, vc1);
        for (int v = lo; v <= hi; ++v) {
          const float2 zc = sZ[xa_l * kVP + (v - vc0)];
          const float2 t = sT[xa_l * kVP + (v - vc0)];
          const int k = __float_as_int(zc.x);
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            const int z = k + o;
            if (z < za_o || z > zb_o) continue;
            const float wz = o ? zc.y : 1.0f - zc.y;
            float2* a = sA + xa_l * kAP + (z - z0);
            *a = make_float2(a->x + wz * (t.x - t.y), a->y + wz * t.y);
          }
        }
        // no barrier here: the next chunk's staging barrier orders this
        // pass's reads before the next pass B's writes
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < ntx * kTZ; e += kAdjThreads) {
    const int xl = e / kTZ, zl = e - xl * kTZ;
    if (zl >= ntz) continue;
    const float2 a = sA[xl * kAP + zl];
    const size_t col = static_cast<size_t>(x0 + xl) * ny;
    if (ri >= 0) side0[(col + ri) * nz + z0 + zl] = a.x;
    if (ri + 1 < ny) side1[(col + ri + 1) * nz + z0 + zl] = a.y;
  }
}

// vol += side1, elementwise: the second half of K4.
__global__ void __launch_bounds__(256)
add_kernel(float* __restrict__ vol, const float* __restrict__ side1,
           long long n) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * 256)
    vol[i] = vol[i] + side1[i];
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

// vol receives side 0 and then side 1 added; side1 is scratch of vol's
// shape (nx, ny, nz).
int slab_arc_adj(const float* g, const float* scalars, float* vol,
                 float* side1, int V, int nx, int ny, int nz, int nu, int nv,
                 int n_steps, int n_branch, void* stream) {
  const long long n = static_cast<long long>(nx) * ny * nz;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      arc_adj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAdjSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((nz + kTZ - 1) / kTZ, (nx + kTX - 1) / kTX, ny + 1);
  arc_adj_kernel<<<grid, kAdjThreads, kAdjSmem, s>>>(
      g, scalars, vol, side1, V, nx, ny, nz, nu, nv, n_steps, n_branch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (n + 255) / 256;
  add_kernel<<<static_cast<int>(blocks < 8192 ? blocks : 8192), 256, 0, s>>>(
      vol, side1, n);
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
