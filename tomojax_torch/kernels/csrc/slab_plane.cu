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
// arithmetic. K1 keeps its reads coalesced by putting v on the fastest
// thread index (zav ~ 1, so neighbouring threads read neighbouring z of
// one row of vol[x, r, :]). Nothing of the TPU design is carried over
// (one-hot selection matmuls, bf16 hi/lo split, band budget, lane padding,
// view bucketing): a Hopper thread gathers directly.
//
// K2 uses that the operator is separable (zeta never depends on u), as the
// arc adjoint K4 does: per view and slab r the transpose is two 1-D
// transposes,
//   pass-B transpose  T[x, v] = sum_u w_x(X_r(u, v) -> x) g[u, v],
//   pass-A transpose  vol[x, r, z] += scale * sum_v w_z(zeta_r(x, v) -> z)
//                                     T[x, v].
// A CTA owns slab r and a tile of (x, z); per view it stages the (u, v)
// window of g whose x-taps reach the tile with cp.async, double-buffered
// across views, runs pass B into shared memory and pass A into registers
// that live across all the group's views, and writes each voxel once. No
// atomics, global or shared: every shared slot and register has one
// writer, and every sum runs in one fixed order, so two applies give the
// same bits. Windows come from one reciprocal per view of eux and zav
// (a multiply per point, no division), widened by the rounding; K1's
// exact tap tests on the same __device__ positions (plane_X,
// plane_zeta, with the same fmaf order) decide, so K2 holds exactly K1's
// matrix entries in float32 and the pair stays an exact transpose (CGLS
// needs that). What bounds K2: the candidate tests and shared-memory
// traffic of the two transposes, not bytes.

#include <cstdint>

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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Integer range [lo, hi] (clamped to [0, n)) holding every index i whose
// computed position can have a tap in [lo_val + 1, hi_val - 1], i.e. lies
// in [lo_val, hi_val), for a position that is a + b * i in exact
// arithmetic; inv_b = 1/b, so a call costs multiplies, no division. The
// exact tap tests decide. Slack (u = 2^-24): plane_zeta rounds a + zav*v
// once (its a is this a to the bit), plane_X three times, with terms of
// at most |a| + ext + |b| n (ext = |evx| nv bounds the v term that X
// folds into a), so a computed position is off by at most 3u (2|a| + ext
// + |b| n + |val|); the inversion rounds val - a once, inv_b carries u and
// the product and the slack's subtraction u more each: 4.1u (|val| +
// |a|) |inv_b| in index units. The range is widened by 1e-6 > 16u times
// (2|a| + ext + |b| n + |lo_val| + |hi_val| + 2) |inv_b|, which holds
// both, so every integer of the exact range lies in [ceil(tl), floor(th)].
// The result is monotone in a, lo_val and hi_val
// (the slack is convex in a), so the range of a tile's extreme corners
// holds the range of every point inside it. |b| < 1e-6 takes [0, n).
__device__ __forceinline__ void window(float a, float b, float inv_b,
                                       float lo_val, float hi_val, float ext,
                                       int n, int* lo, int* hi) {
  if (!(fabsf(b) >= 1e-6f)) {
    *lo = 0;
    *hi = n - 1;
    return;
  }
  const float slack = (2.0f * fabsf(a) + ext + fabsf(b) * n +
                       fabsf(lo_val) + fabsf(hi_val) + 2.0f) *
                      1e-6f * fabsf(inv_b);
  const float t0 = (lo_val - a) * inv_b;
  const float t1 = (hi_val - a) * inv_b;
  const float lim = static_cast<float>(n) + 1.0f;
  const float tl = fminf(fmaxf(fminf(t0, t1) - slack, -2.0f), lim);
  const float th = fmaxf(fminf(fmaxf(t0, t1) + slack, lim), -2.0f);
  *lo = max(0, static_cast<int>(ceilf(tl)));
  *hi = min(n - 1, static_cast<int>(floorf(th)));
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

// K2 tiling. A CTA owns slab r and the oriented voxels (x, z) of a kTX x
// kTZ tile. It stages the cotangent in chunks of kUC detector columns u x
// kVC detector rows v (one chunk per view at 256^3 with a unit pitch: the
// u window of 32 columns is ~35-50 wide, the v window of 64 z ~70),
// double-buffered with cp.async across chunks and views. A view's row
// chunks start at a multiple of kVA rows, so that rows of whole 16-byte
// words (nv a multiple of 4) are staged with 16-byte copies. kXR = 11 makes
// the pass-B owners (3 per row v) fit the CTA in one round. A pass-A
// thread owns kZR voxels z of one column x for the whole call and keeps
// their sums in registers.
constexpr int kAdjThreads = 256;
constexpr int kTX = 32, kTZ = 64;
constexpr int kUC = 64, kVC = 80, kVA = 4;
static_assert(kVC % kVA == 0, "row chunks keep their alignment");
constexpr int kXR = 11, kZR = 8;               // owned x (pass B), z (pass A)
constexpr int kXG = (kTX + kXR - 1) / kXR;     // pass-B owners per row v
constexpr int kVP = kVC + 1;                   // T pitch: pass A's lanes
constexpr int kStage = kUC * kVC;
constexpr int kAdjSmem = 4 * (2 * kStage + kTX * kVP);

// One view as a tile sees it: its plane, the slab's offsets, the two
// reciprocals and the v window of the tile.
struct ViewTile {
  Plane p;
  float cx, cz, inv_eux, inv_zav;
  int vlo, vhi;
};

// The staged chunk: view, v rows [vc0, vc1], u columns [uc0, uc0 + kUC)
// of the v chunk's u window [ulo, uhi].
struct Chunk {
  int view, vc0, vc1, uc0, ulo, uhi;
};

struct AdjTile {
  const float* scalars;
  int V, nu, nv;
  float r, fxa, fxb, fza, fzb;   // slab and the tile's corners
};

__device__ __forceinline__ void view_tile(const AdjTile& t, int view,
                                          ViewTile* w) {
  w->p = load_plane(t.scalars + view * NS);
  w->cx = fmaf(w->p.rx, t.r, w->p.cxb);
  w->cz = fmaf(w->p.rz, t.r, w->p.czb);
  w->inv_eux = __fdiv_rn(1.0f, w->p.eux);   // one reciprocal each per view
  w->inv_zav = __fdiv_rn(1.0f, w->p.zav);
  // the v whose zeta-taps can reach the tile's z: zeta = a(x) + zav*v with
  // a(x) = plane_zeta at v = 0, monotone in x
  int l0, h0, l1, h1;
  window(plane_zeta(w->p, t.r, t.fxa, 0.0f), w->p.zav, w->inv_zav,
         t.fza - 1.0f, t.fzb + 1.0f, 0.0f, t.nv, &l0, &h0);
  window(plane_zeta(w->p, t.r, t.fxb, 0.0f), w->p.zav, w->inv_zav,
         t.fza - 1.0f, t.fzb + 1.0f, 0.0f, t.nv, &l1, &h1);
  w->vlo = min(l0, l1);
  w->vhi = max(h0, h1);
}

// The pass-B window of u for positions X(u, v) = (cx + evx*v) + eux*u in
// [lo_val, hi_val).
__device__ __forceinline__ void u_window(const ViewTile& w, const AdjTile& t,
                                         float fv, float lo_val, float hi_val,
                                         int* lo, int* hi) {
  window(fmaf(w.p.evx, fv, w.cx), w.p.eux, w.inv_eux, lo_val, hi_val,
         fabsf(w.p.evx) * t.nv, t.nu, lo, hi);
}

// Advance c (and w, when the view changes) to the next chunk with work;
// false when the tile's views are done. Every thread runs the same steps.
__device__ bool next_chunk(const AdjTile& t, ViewTile* w, Chunk* c) {
  if (c->uc0 + kUC <= c->uhi) {
    c->uc0 += kUC;
    return true;
  }
  int vc0 = c->vc0 + kVC;
  for (;;) {
    while (vc0 > w->vhi) {
      if (++c->view >= t.V) return false;
      view_tile(t, c->view, w);
      vc0 = w->vlo / kVA * kVA;   // vlo >= 0
    }
    const int vc1 = min(w->vhi, vc0 + kVC - 1);
    int l0, h0, l1, h1;
    u_window(*w, t, static_cast<float>(vc0), t.fxa - 1.0f, t.fxb + 1.0f, &l0,
             &h0);
    u_window(*w, t, static_cast<float>(vc1), t.fxa - 1.0f, t.fxb + 1.0f, &l1,
             &h1);
    c->ulo = min(l0, l1);
    c->uhi = max(h0, h1);
    if (c->ulo <= c->uhi) {
      c->vc0 = vc0;
      c->vc1 = vc1;
      c->uc0 = c->ulo;
      return true;
    }
    vc0 += kVC;
  }
}

// Stage chunk c of the cotangent g: (V, nu, nv) into dst[ul][vl]. Where
// the chunk's rows start on 16-byte words in g and in dst (nv a multiple
// of 4), with 16-byte copies: the last word of a row may run past vc1,
// never past the row's end (vc0 is a multiple of 4, vc0 + 4q <= vc1 <
// nv), into slots that nothing reads.
__device__ __forceinline__ void stage_chunk(float* dst, const float* g,
                                            const AdjTile& t,
                                            const Chunk& c) {
  const int nuw = min(c.uhi - c.uc0 + 1, kUC);
  const int nvw = c.vc1 - c.vc0 + 1;
  const float* src = g + (static_cast<size_t>(c.view) * t.nu + c.uc0) * t.nv +
                     c.vc0;
  if (((reinterpret_cast<uintptr_t>(src) | (4u * t.nv)) & 15) == 0) {
    constexpr int kW = kVC / 4;   // 16-byte words per staged row
    const int nq = (nvw + 3) / 4;
    for (int e = threadIdx.x; e < nuw * kW; e += kAdjThreads) {
      const int ul = e / kW, q = e - ul * kW;
      if (q < nq)
        cp_async16(dst + 4 * e, src + static_cast<size_t>(ul) * t.nv + 4 * q);
    }
    return;
  }
  for (int e = threadIdx.x; e < nuw * kVC; e += kAdjThreads) {
    const int ul = e / kVC, vl = e - ul * kVC;
    if (vl < nvw) cp_async4(dst + e, src + static_cast<size_t>(ul) * t.nv + vl);
  }
}

// acc[j] += val for 0 <= j < kZR (a register picked without an index).
__device__ __forceinline__ void add_owned(float acc[kZR], int j, float val) {
#pragma unroll
  for (int q = 0; q < kZR; ++q)
    if (j == q) acc[q] += val;
}

// K2: grid (z tiles, x tiles, slabs r). For each staged chunk:
//   pass-B transpose T[x, v] = sum_u w_x(X_r(u, v) -> x) g[u, v] over the
//     chunk's u (added over the u chunks of one v chunk), into shared
//     memory, as owner sweeps: a thread owns kXR columns x of one row v
//     and sweeps their joint u window once with two running sums;
//   after a v chunk's last u chunk, pass-A transpose: each owned voxel
//     (x, z) adds scale * sum_v w_z(zeta_r(x, v) -> z) T[x, v] over the
//     chunk's v to its register, the owner of kZR voxels of a column
//     sweeping their joint v window once with two running sums.
// (Point scans, and sums in registers selected per candidate, were slower
// on the H100, as were 2 or 3 CTAs per SM: PERF.md section 6. Four CTAs
// per SM hold the registers to 64 without spills.)
__global__ void __launch_bounds__(kAdjThreads, 4)
adj_kernel(const float* __restrict__ g, const float* __restrict__ scalars,
           float* __restrict__ vol, int V, int nx, int ny, int nz, int nu,
           int nv) {
  extern __shared__ __align__(16) float sm[];
  float* const sT = sm + 2 * kStage;   // [xl][vl]
  const int tid = threadIdx.x;
  const int z0 = blockIdx.x * kTZ, x0 = blockIdx.y * kTX, ri = blockIdx.z;
  const int ntx = min(kTX, nx - x0), ntz = min(kTZ, nz - z0);
  const AdjTile t{scalars, V, nu, nv, static_cast<float>(ri),
                  static_cast<float>(x0), static_cast<float>(x0 + ntx - 1),
                  static_cast<float>(z0), static_cast<float>(z0 + ntz - 1)};
  // this thread's pass-A voxels: column xa_l, z in [za_o, zb_o]
  const int xa_l = tid % kTX;
  const int za_o = z0 + (tid / kTX) * kZR;
  const int zb_o = min(za_o + kZR, z0 + ntz) - 1;
  const bool owns_a = xa_l < ntx && za_o <= zb_o;
  const float fxo = static_cast<float>(x0 + xa_l);
  float acc[kZR];
#pragma unroll
  for (int s = 0; s < kZR; ++s) acc[s] = 0.0f;

  ViewTile w;
  w.vhi = -1;
  Chunk c{-1, -kVC, -1, 0, 0, -1};
  bool have = next_chunk(t, &w, &c);
  if (have) stage_chunk(sm, g, t, c);
  cp_async_commit();
  int buf = 0;
  while (have) {
    ViewTile wn = w;
    Chunk cn = c;
    const bool more = next_chunk(t, &wn, &cn);
    if (more) {
      stage_chunk(sm + (buf ^ 1) * kStage, g, t, cn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sG = sm + buf * kStage;
    const int uc1 = min(c.uhi, c.uc0 + kUC - 1);
    const int nvw = c.vc1 - c.vc0 + 1;
    const bool first_u = c.uc0 == c.ulo;
    // pass B: an owner of kXR columns x of one row v sweeps their joint u
    // window once in the direction in which X grows (eux > 0 after the
    // groups' u-flip), so each candidate's floor k never falls: it keeps
    // the running sums of columns k and k + 1 and stores a column's sum
    // (its u in sweep order) when the sweep has passed it
    for (int e = tid; e < kXG * nvw; e += kAdjThreads) {
      const int xr = e / nvw, vl = e - xr * nvw;
      const int xa = x0 + xr * kXR;
      const int xb = min(xa + kXR, x0 + ntx) - 1;
      if (xa > xb) continue;
      const float fv = static_cast<float>(c.vc0 + vl);
      int lo, hi;
      u_window(w, t, fv, static_cast<float>(xa) - 1.0f,
               static_cast<float>(xb) + 1.0f, &lo, &hi);
      lo = max(lo, c.uc0);
      hi = min(hi, uc1);
      float* const col = sT + (xa - x0) * kVP + vl;
      if (first_u)
        for (int x = xa; x <= xb; ++x) col[(x - xa) * kVP] = 0.0f;
      if (lo > hi) continue;
      const bool up = w.p.eux > 0.0f;
      const int du = up ? 1 : -1;
      float s0 = 0.0f, s1 = 0.0f;   // columns cur and cur + 1
      int cur = 0;
      for (int i = 0, u = up ? lo : hi; i <= hi - lo; ++i, u += du) {
        const float X = plane_X(w.p, t.r, static_cast<float>(u), fv);
        const float f = floorf(X);
        const int k = static_cast<int>(f);
        const float wx = X - f;
        const float gv = sG[(u - c.uc0) * kVC + vl];
        if (i == 0) cur = k;
        while (cur < k) {   // the sweep has passed column cur
          if (cur >= xa && cur <= xb) col[(cur - xa) * kVP] += s0;
          s0 = s1;
          s1 = 0.0f;
          ++cur;
        }
        s0 += (1.0f - wx) * gv;
        s1 += wx * gv;
      }
      if (cur >= xa && cur <= xb) col[(cur - xa) * kVP] += s0;
      if (cur + 1 >= xa && cur + 1 <= xb) col[(cur + 1 - xa) * kVP] += s1;
    }
    __syncthreads();
    // pass A, after the v chunk's last u chunk
    if (c.uc0 + kUC > c.uhi && owns_a) {
      const float* const trow = sT + xa_l * kVP - c.vc0;
      // the owner of kZR voxels z of column x sweeps their joint v window
      // once in the direction in which zeta grows, keeping the running
      // sums of voxels k and k + 1 (k the candidate's floor, which never
      // falls) and adding a voxel's sum to its register when the sweep
      // has passed it
      const float a = plane_zeta(w.p, t.r, fxo, 0.0f);
      int lo, hi;
      window(a, w.p.zav, w.inv_zav, static_cast<float>(za_o) - 1.0f,
             static_cast<float>(zb_o) + 1.0f, 0.0f, nv, &lo, &hi);
      lo = max(lo, c.vc0);
      hi = min(hi, c.vc1);
      if (lo <= hi) {
        const bool up = w.p.zav > 0.0f;
        const int dv = up ? 1 : -1;
        float s0 = 0.0f, s1 = 0.0f;   // voxels cur and cur + 1
        int cur = 0;
        for (int i = 0, v = up ? lo : hi; i <= hi - lo; ++i, v += dv) {
          const float zeta = plane_zeta(w.p, t.r, fxo, static_cast<float>(v));
          const float f = floorf(zeta);
          const int k = static_cast<int>(f);
          const float wz = zeta - f;
          const float tv = trow[v] * w.p.scale;
          if (i == 0) cur = k;
          while (cur < k) {   // the sweep has passed voxel cur
            add_owned(acc, cur - za_o, s0);
            s0 = s1;
            s1 = 0.0f;
            ++cur;
          }
          s0 += (1.0f - wz) * tv;
          s1 += wz * tv;
        }
        add_owned(acc, cur - za_o, s0);
        add_owned(acc, cur + 1 - za_o, s1);
      }
    }
    // no barrier here: the next chunk's barrier orders this pass A's reads
    // of T before the next pass B's writes, and this pass B's reads of the
    // staged buffer before the chunk after next is staged into it
    buf ^= 1;
    w = wn;
    c = cn;
    have = more;
  }
  // every voxel written once, through shared memory so that the stores run
  // along z
  __syncthreads();
  float* const sOut = sm;   // [xl][zl], kTX x (kTZ + 1)
  if (owns_a) {
#pragma unroll
    for (int s = 0; s < kZR; ++s)
      if (za_o + s <= zb_o) sOut[xa_l * (kTZ + 1) + za_o + s - z0] = acc[s];
  }
  __syncthreads();
  for (int e = tid; e < ntx * kTZ; e += kAdjThreads) {
    const int xl = e / kTZ, zl = e - xl * kTZ;
    if (zl < ntz)
      vol[(static_cast<size_t>(x0 + xl) * ny + ri) * nz + z0 + zl] =
          sOut[xl * (kTZ + 1) + zl];
  }
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
  if (static_cast<long long>(nx) * ny * nz <= 0) return 0;
  if (ny > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t e = cudaFuncSetAttribute(
      adj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAdjSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((nz + kTZ - 1) / kTZ, (nx + kTX - 1) / kTX, ny);
  adj_kernel<<<grid, kAdjThreads, kAdjSmem,
               static_cast<cudaStream_t>(stream)>>>(g, scalars, vol, V, nx,
                                                    ny, nz, nu, nv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
