// The exact ray family's forward R1 (ray_fwd), its exact transpose R2
// (ray_adj) and its fused forward and 6-DoF Jacobian R3 (ray_jac) for
// Hopper (sm_90a), behind a plain C interface (loaded with ctypes).
//
// They replace no TPU kernel: tomojax's ray family
// (tomojax/core/projector.py) marches its steps in a lax.scan, its
// Jacobian too, and has no Pallas kernel (ROADMAP P8). Here they replace
// the port's plain march (core/projector.py: _step_blocks,
// _corner_indices_weights, _corner_weight_gradients, torch.take,
// index_add_), which spent its time on int64 index arithmetic in about
// 200 small kernels for every block of steps.
//
// The function. For view v, ray k of the call's block of detector rays
// (detector ray r_off + k = u * nv + w), step j = 0 .. n_steps - 1:
//   c_j = fl(j * step),  p = fl(p0[v, a, k] + fl(c_j * d[v, a]))  per axis a
//   f = floor(p), t = p - f; corner o in {0, 1}^3 weighs
//   fl(fl(s_x * s_y) * s_z) with s_a = o_a ? t_a : fl(1 - t_a), and counts
//   where its own index f + o lies inside the volume;
//   A:  y[v, k] = sum over j and corners of w * vol[f + o]
//   AT: vol[q] += sum over (v, k, j) with f + o = q of w * y[v, k].
// p0 and d come from the port's _ray_setup, and every step above is
// rounded as the plain version rounds it (__fmul_rn/__fadd_rn/__fsub_rn,
// no contraction), so both kernels take the plain version's samples,
// corners and weights to the bit. Their sums are taken in another order,
// in double, and rounded to float once.
//
// What bounds them on an H100: the operations. benchmark/roofline_ray.py
// counts one multiply-add per corner of each of the n_views * n_det *
// n_steps samples: 11.268 us an apply at 64^3 x 90 views of 64^2 (128
// steps), against 0.3 us for the bytes of the 1 MB volume and the
// sinogram. What the design does about it:
//
// R1 gives a thread one (view, ray) and a warp 32 neighbouring rays along
// the detector's fast axis, so the warp's samples read neighbouring lines
// of the volume, which stays resident in L2. The thread marches only the
// steps that can touch a corner: the ray's entry into and exit from the
// box [-1, n) per axis, found in double and widened by a position margin
// far above float32's rounding and by one step on each side (about half
// of the 128 steps at 64^3 lie outside it). Per step it reads the 8
// corners at the plain version's clamped indices, weight 0 outside the
// volume, so the 8 loads issue together (on the H100 at 64^3 x 90, 10%
// faster than a branch per corner, the same bits); it sums them in
// float32 in the plain version's corner order, the steps in a register in
// double, and writes its detector value once.
//
// R3 is R1's march with the Jacobian's sums beside the value's. Per
// sample the plain version (core/projector.py: _march_jac) takes,
// in float32 and its corner order, the value sum w * vol and the masked
// weight gradient sum vol * mask * dw/dp (dw/dp_x = +-fl(w_y * w_z) and
// cyclically; a corner inside the volume with weight 0 still counts:
// the mask, not w, zeroes it). The point's derivative is g = der_ang +
// (c_j / ray_length) * der_dir per angle (rpa per shift), linear in g, so
// R3 keeps seven double sums a ray: the value, g_sum = sum_j grad_j and
// g_step = sum_j c_j * grad_j, and contracts them once, in double, with
// the setup's rpa (V, 3, 3), der_ang (V, 3, 3, R) and der_dir (V, 3, 3)
// in an epilogue that writes det (V, R) and jac (V, 6, R) once, in the
// order (tx, ty, tz, phi, alpha, beta). Its value is R1's to the bit (the
// same samples, corners, float32 sums and double accumulator): the LM
// compares the cost of R3's det with R1's to accept a step.
//
// What bounds R3 on an H100: the operations. benchmark/roofline_ray_jac.py
// counts four multiply-adds per corner of each sample (the value and the
// three gradient components): 45.07 us a 90-view apply at 64^3, against
// 3.4 us for the bytes (the volume, the 7 outputs a ray, the views'
// parameters). The plain version's cost was elsewhere: its temporaries,
// (8, 3, V, R, S) float32 per block of S steps, moved gigabytes an apply,
// and its hundreds of launches a block held the host. R3 keeps every
// temporary in registers, so an apply is one launch that reads the volume
// (resident in L2) and the setup and writes 7 floats a ray; it marches
// R1's clipped step range with R1's warp layout and 8 loads issued
// together, so its time over R1's is its added arithmetic: 0.244 ms a
// 90-view apply at 64^3 on the H100 (R1 0.190 ms, the plain march 86 ms).
//
// R2 is a gather over voxels with no atomics, so two applies give the same
// bits. A thread owns one voxel q (z fastest) and loops over the call's
// views with one double accumulator; it reads and adds its voxel of the
// output once. Per view a map (ray_map_kernel, launched first by the same
// entry; kernels/ray.py: gather_map is its plain version) gives the affine
// map from (u, w, j) to the sample position (p0 of the block's first ray,
// the two rotated detector steps and step * d) and its inverse. The
// samples that reach q as a corner lie in the box [q - 1, q + 1)^3. Its
// image under the inverse, widened by a position margin m, bounds the
// candidate rays (u, w): at most 4 x 4, about 2.5 x 2 on average, at a
// unit pixel. Per candidate the box, widened by m, bounds the steps along
// the approximate ray. m (kMargin times the problem's extent) is some 70
// times the distance float32 puts between the affine map and the rounded
// samples, so the step interval needs only kStepSlack for the rounding of
// its own ends (widening it by a whole step on each side took 28% more
// time on the H100 at 64^3 x 90). Each candidate step is recomputed
// exactly as R1 computes it, from p0[v, :, k] and c_j, and kept if and
// only if its floor is q or q - 1 on every axis; it then adds w * y[v, k]
// with R1's weight for that corner. So each (sample, corner) pair of R1 is
// counted once, and R2 is R1's exact transpose up to the order of its
// sums. tests/test_torch_ray_kernels.py emulates the candidate search on
// gather_map's rows and checks that it finds every pair exactly once.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kMapViews = 32;   // views whose maps a CTA stages at a time
// R2's position margin per unit of the problem's extent, and the
// allowance of its step intervals for their own rounding
constexpr double kMargin = 1e-5;
constexpr float kStepSlack = 0.01f;

// one view's row of the map, kernels/ray.py: gather_map's (NM floats)
constexpr int NM = 21;
constexpr int M_P = 0;     // p0 of the block's first ray (3)
constexpr int M_AU = 3;    // sample step per detector u (3)
constexpr int M_AW = 6;    // sample step per detector w (3)
constexpr int M_IU = 9;    // u row of the inverse map (3)
constexpr int M_IW = 12;   // w row of the inverse map (3)
constexpr int M_ISD = 15;  // 1 / (step * d) per axis, 0 where |step * d|
                           // is below 1e-30 (3)
constexpr int M_HU = 18;   // half-width of a corner box's u range
constexpr int M_HW = 19;   // half-width of its w range
constexpr int M_BOX = 20;  // half-side of the corner box: 1 + margin

__device__ __forceinline__ float march(int j, float step) {
  return __fmul_rn(static_cast<float>(j), step);
}

__device__ __forceinline__ float sample(float p0, float c, float d) {
  return __fadd_rn(p0, __fmul_rn(c, d));
}

// Narrow [lo, hi] to the steps whose sample, started at p with step sd,
// lies within [a, b] on this axis; false if none can.
__device__ __forceinline__ bool clip_axis(double p, double sd, double a,
                                          double b, double& lo, double& hi) {
  if (fabs(sd) < 1e-30) return p >= a && p <= b;
  double t0 = (a - p) / sd, t1 = (b - p) / sd;
  if (t0 > t1) {
    const double t = t0;
    t0 = t1;
    t1 = t;
  }
  lo = fmax(lo, t0);
  hi = fmin(hi, t1);
  return true;
}

// R1's steps [j0, j1) of one ray: those whose sample can lie in [-1, n) on
// every axis, widened by one step on each side. The position margin covers
// float32's rounding of the samples many times over.
__device__ __forceinline__ void step_range(float px, float py, float pz,
                                           float dx, float dy, float dz,
                                           float step, int n_steps, int nx,
                                           int ny, int nz, int& j0, int& j1) {
  const double m = 1e-4 * (1.0 + fabs(static_cast<double>(px)) +
                           fabs(static_cast<double>(py)) +
                           fabs(static_cast<double>(pz)) +
                           static_cast<double>(n_steps) * step);
  const double s = step;
  double lo = 0.0, hi = n_steps - 1;
  const bool hit = clip_axis(px, s * dx, -1.0 - m, nx + m, lo, hi) &&
                   clip_axis(py, s * dy, -1.0 - m, ny + m, lo, hi) &&
                   clip_axis(pz, s * dz, -1.0 - m, nz + m, lo, hi);
  if (!hit || !(lo <= hi)) {
    j0 = j1 = 0;
    return;
  }
  j0 = max(0, static_cast<int>(floor(lo)) - 1);
  j1 = min(n_steps, static_cast<int>(ceil(hi)) + 2);
}

// The plain version's corners of the sample (x, y, z) (the march's
// _corner_indices_weights): false where none lies inside the volume (the
// floor outside [-1, n - 1] on an axis); else the 8 values at the clamped
// indices (z fastest, x slowest), whether each corner lies inside, and the
// per-axis parts w*[o] (o = 0: 1 - t, o = 1: t). The 8 loads issue
// together.
struct Corners {
  float val[8];
  bool in[8];
  float wx[2], wy[2], wz[2];
};

__device__ __forceinline__ bool corners(const float* __restrict__ vol,
                                        float x, float y, float z, int nx,
                                        int ny, int nz, Corners& cn) {
  const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
  if (!(fx >= -1.f && fx < nx && fy >= -1.f && fy < ny && fz >= -1.f &&
        fz < nz))
    return false;
  const int ix = static_cast<int>(fx), iy = static_cast<int>(fy),
            iz = static_cast<int>(fz);
  const float tx = __fsub_rn(x, fx), ty = __fsub_rn(y, fy),
              tz = __fsub_rn(z, fz);
  cn.wx[0] = __fsub_rn(1.f, tx);
  cn.wx[1] = tx;
  cn.wy[0] = __fsub_rn(1.f, ty);
  cn.wy[1] = ty;
  cn.wz[0] = __fsub_rn(1.f, tz);
  cn.wz[1] = tz;
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8) {
    const int X = ix + (c8 >> 2), Y = iy + ((c8 >> 1) & 1), Z = iz + (c8 & 1);
    cn.in[c8] = X >= 0 && X < nx && Y >= 0 && Y < ny && Z >= 0 && Z < nz;
    const int Xc = min(max(X, 0), nx - 1), Yc = min(max(Y, 0), ny - 1),
              Zc = min(max(Z, 0), nz - 1);
    cn.val[c8] = __ldg(vol + (static_cast<long long>(Xc) * ny + Yc) * nz + Zc);
  }
  return true;
}

// The sample's value: w * vol summed over the corners in float32 in the
// plain version's order, w = fl(fl(w_x * w_y) * w_z), 0 outside the volume.
__device__ __forceinline__ float value_sum(const Corners& cn) {
  float s = 0.f;
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8) {
    const int ox = c8 >> 2, oy = (c8 >> 1) & 1, oz = c8 & 1;
    const float wc =
        cn.in[c8] ? __fmul_rn(__fmul_rn(cn.wx[ox], cn.wy[oy]), cn.wz[oz])
                  : 0.f;
    s = __fadd_rn(s, __fmul_rn(wc, cn.val[c8]));
  }
  return s;
}

// The sample's masked weight gradient: vol * mask * dw/dp summed over the
// corners in float32 in the plain version's order (its
// _corner_weight_gradients): dw/dp_x = -fl(w_y * w_z) for a floor corner,
// + for a ceil one, and cyclically. A corner inside the volume with
// weight 0 still adds its gradient: the mask, not w, zeroes a corner.
__device__ __forceinline__ void gradient_sum(const Corners& cn, float g[3]) {
  g[0] = g[1] = g[2] = 0.f;
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8) {
    const int ox = c8 >> 2, oy = (c8 >> 1) & 1, oz = c8 & 1;
    const float vm = cn.in[c8] ? cn.val[c8] : 0.f;
    const float gx = __fmul_rn(cn.wy[oy], cn.wz[oz]);
    const float gy = __fmul_rn(cn.wx[ox], cn.wz[oz]);
    const float gz = __fmul_rn(cn.wx[ox], cn.wy[oy]);
    g[0] = __fadd_rn(g[0], __fmul_rn(vm, ox ? gx : -gx));
    g[1] = __fadd_rn(g[1], __fmul_rn(vm, oy ? gy : -gy));
    g[2] = __fadd_rn(g[2], __fmul_rn(vm, oz ? gz : -gz));
  }
}

__global__ void __launch_bounds__(kThreads)
    ray_fwd_kernel(const float* __restrict__ vol, const float* __restrict__ p0,
                   const float* __restrict__ d_hat, float* __restrict__ out,
                   int V, int R, int nx, int ny, int nz, int n_steps,
                   float step) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= R) return;
  for (int v = blockIdx.y; v < V; v += gridDim.y) {
    const float* pk = p0 + static_cast<long long>(v) * 3 * R + k;
    const float px = pk[0], py = pk[R], pz = pk[2 * R];
    const float dx = d_hat[3 * v], dy = d_hat[3 * v + 1],
                dz = d_hat[3 * v + 2];
    int j0, j1;
    step_range(px, py, pz, dx, dy, dz, step, n_steps, nx, ny, nz, j0, j1);
    double acc = 0.0;
    for (int j = j0; j < j1; ++j) {
      const float c = march(j, step);
      Corners cn;
      if (!corners(vol, sample(px, c, dx), sample(py, c, dy),
                   sample(pz, c, dz), nx, ny, nz, cn))
        continue;
      acc += static_cast<double>(value_sum(cn));
    }
    out[static_cast<long long>(v) * R + k] = static_cast<float>(acc);
  }
}

// R3: R1's march of view v, ray k with the Jacobian's sums beside the
// value, then the epilogue that contracts them with the setup's parts.
// rpa[v, d, p] = dp_d / dt_p; der_ang[v, a, d, k] and der_dir[v, a, d] the
// static and direction parts of dp_d / d angle a (phi, alpha, beta).
__global__ void __launch_bounds__(kThreads)
    ray_jac_kernel(const float* __restrict__ vol, const float* __restrict__ p0,
                   const float* __restrict__ d_hat,
                   const float* __restrict__ rpa,
                   const float* __restrict__ der_ang,
                   const float* __restrict__ der_dir, float* __restrict__ det,
                   float* __restrict__ jac, int V, int R, int nx, int ny,
                   int nz, int n_steps, float step, double inv_rlen) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= R) return;
  for (int v = blockIdx.y; v < V; v += gridDim.y) {
    const float* pk = p0 + static_cast<long long>(v) * 3 * R + k;
    const float px = pk[0], py = pk[R], pz = pk[2 * R];
    const float dx = d_hat[3 * v], dy = d_hat[3 * v + 1],
                dz = d_hat[3 * v + 2];
    int j0, j1;
    step_range(px, py, pz, dx, dy, dz, step, n_steps, nx, ny, nz, j0, j1);
    double acc = 0.0;
    double g_sum[3] = {0.0, 0.0, 0.0}, g_step[3] = {0.0, 0.0, 0.0};
    for (int j = j0; j < j1; ++j) {
      const float c = march(j, step);
      Corners cn;
      if (!corners(vol, sample(px, c, dx), sample(py, c, dy),
                   sample(pz, c, dz), nx, ny, nz, cn))
        continue;
      acc += static_cast<double>(value_sum(cn));
      float g[3];
      gradient_sum(cn, g);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        g_sum[a] += static_cast<double>(g[a]);
        g_step[a] = fma(static_cast<double>(g[a]), static_cast<double>(c),
                        g_step[a]);
      }
    }
    det[static_cast<long long>(v) * R + k] = static_cast<float>(acc);
    const float* rp = rpa + 9LL * v;
    const float* dd = der_dir + 9LL * v;
    const float* da = der_ang + 9LL * v * R + k;
    float* jk = jac + 6LL * v * R + k;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      double jt = 0.0, ja = 0.0, js = 0.0;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        jt = fma(static_cast<double>(__ldg(rp + 3 * d + p)), g_sum[d], jt);
        ja = fma(static_cast<double>(__ldg(da + (3 * p + d) * R)), g_sum[d],
                 ja);
        js = fma(static_cast<double>(__ldg(dd + 3 * p + d)), g_step[d], js);
      }
      jk[p * R] = static_cast<float>(jt);
      jk[(3 + p) * R] = static_cast<float>(fma(js, inv_rlen, ja));
    }
  }
}

// R1's weight of the corner q on one axis of a sample at p, or false where
// q is not a corner of it: floor(p) is q (weight 1 - t) or q - 1 (weight t).
__device__ __forceinline__ bool corner_part(float p, float q, float& w) {
  const float f = floorf(p);
  const float t = __fsub_rn(p, f);
  if (f == q) {
    w = __fsub_rn(1.f, t);
    return true;
  }
  if (f == q - 1.f) {
    w = t;
    return true;
  }
  return false;
}

// Narrow [lo, hi] to the steps j whose approximate sample P + j * step * d
// lies within box of q on this axis (isd = 1 / (step * d), 0 where the
// axis does not move along the ray); false if none can.
__device__ __forceinline__ bool clip_box(float q, float P, float isd,
                                         float box, float& lo, float& hi) {
  if (isd == 0.f) return fabsf(q - P) <= box;
  const float t0 = (q - box - P) * isd, t1 = (q + box - P) * isd;
  lo = fmaxf(lo, fminf(t0, t1));
  hi = fminf(hi, fmaxf(t0, t1));
  return true;
}

// R2's map of each view (kernels/ray.py: gather_map is its plain version):
// R = R_z(phi) R_x(alpha) R_y(beta) turns the detector's u and w steps
// into e_x * du and e_z * dv; the inverse rows are cross products over the
// determinant.
__global__ void ray_map_kernel(const float* __restrict__ p0,
                               const float* __restrict__ d_hat,
                               const float* __restrict__ phi,
                               const float* __restrict__ alpha,
                               const float* __restrict__ beta,
                               float* __restrict__ map, int V, int R, int nu,
                               int nv, int n_steps, float step, double du,
                               double dv) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  double sp, cp, sa, ca, sb, cb;
  sincos(static_cast<double>(phi[v]), &sp, &cp);
  sincos(static_cast<double>(alpha[v]), &sa, &ca);
  sincos(static_cast<double>(beta[v]), &sb, &cb);
  const double au[3] = {(cp * cb - sp * sa * sb) * du,
                        (sp * cb + cp * sa * sb) * du, -ca * sb * du};
  const double aw[3] = {(cp * sb + sp * sa * cb) * dv,
                        (sp * sb - cp * sa * cb) * dv, ca * cb * dv};
  double s[3], o[3];
  double o_max = 0.0;
  for (int a = 0; a < 3; ++a) {
    s[a] = static_cast<double>(d_hat[3 * v + a]) * step;
    o[a] = p0[(static_cast<long long>(v) * 3 + a) * R];
    o_max = fmax(o_max, fabs(o[a]));
  }
  const double iu[3] = {aw[1] * s[2] - aw[2] * s[1],
                        aw[2] * s[0] - aw[0] * s[2],
                        aw[0] * s[1] - aw[1] * s[0]};
  const double iw[3] = {s[1] * au[2] - s[2] * au[1],
                        s[2] * au[0] - s[0] * au[2],
                        s[0] * au[1] - s[1] * au[0]};
  const double det = au[0] * iu[0] + au[1] * iu[1] + au[2] * iu[2];
  const double m = kMargin * (1.0 + o_max + nu * fabs(du) + nv * fabs(dv) +
                              n_steps * static_cast<double>(step));
  const double box = 1.0 + m;
  float* row = map + static_cast<long long>(v) * NM;
  double hu = 0.0, hw = 0.0;
  for (int a = 0; a < 3; ++a) {
    row[M_P + a] = static_cast<float>(o[a]);
    row[M_AU + a] = static_cast<float>(au[a]);
    row[M_AW + a] = static_cast<float>(aw[a]);
    row[M_IU + a] = static_cast<float>(iu[a] / det);
    row[M_IW + a] = static_cast<float>(iw[a] / det);
    row[M_ISD + a] = fabs(s[a]) >= 1e-30 ? static_cast<float>(1.0 / s[a]) : 0.f;
    hu += fabs(iu[a] / det);
    hw += fabs(iw[a] / det);
  }
  row[M_HU] = static_cast<float>(box * hu + m);
  row[M_HW] = static_cast<float>(box * hw + m);
  row[M_BOX] = static_cast<float>(box);
}

__global__ void __launch_bounds__(kThreads)
    ray_adj_kernel(const float* __restrict__ y, const float* __restrict__ p0,
                   const float* __restrict__ d_hat,
                   const float* __restrict__ map, float* __restrict__ out,
                   int V, int R, int nu, int nv, int r_off, int nx, int ny,
                   int nz, int n_steps, float step) {
  __shared__ float smap[kMapViews * NM];
  __shared__ float sdir[kMapViews * 3];
  const int n_vox = nx * ny * nz;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const bool live = idx < n_vox;
  const float qx = static_cast<float>(idx / (ny * nz));
  const float qy = static_cast<float>((idx / nz) % ny);
  const float qz = static_cast<float>(idx % nz);
  // the detector rays of the block: rows u_first .. u_last
  const int u_first = r_off / nv, w_first = r_off % nv;
  const int u_last = (r_off + R - 1) / nv;
  double acc = 0.0;
  for (int v0 = 0; v0 < V; v0 += kMapViews) {
    const int nw = min(kMapViews, V - v0);
    __syncthreads();
    for (int i = threadIdx.x; i < nw * NM; i += kThreads)
      smap[i] = map[static_cast<long long>(v0) * NM + i];
    for (int i = threadIdx.x; i < nw * 3; i += kThreads)
      sdir[i] = d_hat[3LL * v0 + i];
    __syncthreads();
    if (!live) continue;
    for (int vi = 0; vi < nw; ++vi) {
      const float* m = smap + vi * NM;
      const long long v = v0 + vi;
      const float rx = qx - m[M_P], ry = qy - m[M_P + 1],
                  rz = qz - m[M_P + 2];
      const float cu = u_first + (m[M_IU] * rx + m[M_IU + 1] * ry +
                                  m[M_IU + 2] * rz);
      const float cw = w_first + (m[M_IW] * rx + m[M_IW + 1] * ry +
                                  m[M_IW + 2] * rz);
      // clamped before the conversions, so they stay in range
      const int ua = max(u_first,
                         static_cast<int>(ceilf(fmaxf(cu - m[M_HU], -1.f))));
      const int ub =
          min(u_last, static_cast<int>(floorf(fminf(cu + m[M_HU], nu))));
      const int wa =
          max(0, static_cast<int>(ceilf(fmaxf(cw - m[M_HW], -1.f))));
      const int wb =
          min(nv - 1, static_cast<int>(floorf(fminf(cw + m[M_HW], nv))));
      const float box = m[M_BOX];
      const float dx = sdir[3 * vi], dy = sdir[3 * vi + 1],
                  dz = sdir[3 * vi + 2];
      for (int u = ua; u <= ub; ++u) {
        for (int w = wa; w <= wb; ++w) {
          const int k = u * nv + w - r_off;
          if (k < 0 || k >= R) continue;
          const float du = static_cast<float>(u - u_first),
                      dw = static_cast<float>(w - w_first);
          float lo = 0.f, hi = static_cast<float>(n_steps - 1);
          if (!clip_box(qx, m[M_P] + du * m[M_AU] + dw * m[M_AW],
                        m[M_ISD], box, lo, hi) ||
              !clip_box(qy, m[M_P + 1] + du * m[M_AU + 1] + dw * m[M_AW + 1],
                        m[M_ISD + 1], box, lo, hi) ||
              !clip_box(qz, m[M_P + 2] + du * m[M_AU + 2] + dw * m[M_AW + 2],
                        m[M_ISD + 2], box, lo, hi) ||
              !(lo <= hi))
            continue;
          const int j0 = max(0, static_cast<int>(ceilf(lo - kStepSlack)));
          const int j1 =
              min(n_steps - 1, static_cast<int>(floorf(hi + kStepSlack)));
          const float* pk = p0 + v * 3 * R + k;
          const float px = __ldg(pk), py = __ldg(pk + R),
                      pz = __ldg(pk + 2 * R);
          const double yk = __ldg(y + v * R + k);
          for (int j = j0; j <= j1; ++j) {
            const float c = march(j, step);
            float wx, wy, wz;
            if (!corner_part(sample(px, c, dx), qx, wx) ||
                !corner_part(sample(py, c, dy), qy, wy) ||
                !corner_part(sample(pz, c, dz), qz, wz))
              continue;
            acc = fma(static_cast<double>(__fmul_rn(__fmul_rn(wx, wy), wz)),
                      yk, acc);
          }
        }
      }
    }
  }
  if (live) out[idx] = __fadd_rn(out[idx], static_cast<float>(acc));
}

}  // namespace

extern "C" {

// vol: (nx, ny, nz); p0: (V, 3, R) sample origins of the block's R rays;
// d_hat: (V, 3); out: (V, R).
int ray_fwd(const float* vol, const float* p0, const float* d_hat, float* out,
            int V, int R, int nx, int ny, int nz, int n_steps, float step,
            void* stream) {
  if (V <= 0 || R <= 0) return 0;
  const dim3 grid((R + kThreads - 1) / kThreads, min(V, 65535));
  ray_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vol, p0, d_hat, out, V, R, nx, ny, nz, n_steps, step);
  return static_cast<int>(cudaGetLastError());
}

// vol, p0, d_hat as ray_fwd (R: every detector ray); rpa: (V, 3, 3);
// der_ang: (V, 3, 3, R); der_dir: (V, 3, 3); det: (V, R); jac: (V, 6, R);
// inv_rlen: 1 / the ray's length.
int ray_jac(const float* vol, const float* p0, const float* d_hat,
            const float* rpa, const float* der_ang, const float* der_dir,
            float* det, float* jac, int V, int R, int nx, int ny, int nz,
            int n_steps, float step, double inv_rlen, void* stream) {
  if (V <= 0 || R <= 0) return 0;
  const dim3 grid((R + kThreads - 1) / kThreads, min(V, 65535));
  ray_jac_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vol, p0, d_hat, rpa, der_ang, der_dir, det, jac, V, R, nx, ny, nz,
      n_steps, step, inv_rlen);
  return static_cast<int>(cudaGetLastError());
}

// y: (V, R) values of the block's rays (detector rays r_off .. r_off + R -
// 1 of an nu x nv detector of pitch du x dv); p0, d_hat as ray_fwd; phi,
// alpha, beta: (V,) the views' angles; map: (V, NM) scratch, written with
// each view's map before the gather reads it; out: (nx, ny, nz), added
// into.
int ray_adj(const float* y, const float* p0, const float* d_hat,
            const float* phi, const float* alpha, const float* beta,
            float* map, float* out, int V, int R, int nu, int nv, int r_off,
            int nx, int ny, int nz, int n_steps, float step, double du,
            double dv, void* stream) {
  const long long n_vox = static_cast<long long>(nx) * ny * nz;
  if (V <= 0 || R <= 0 || n_vox <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ray_map_kernel<<<(V + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      p0, d_hat, phi, alpha, beta, map, V, R, nu, nv, n_steps, step, du, dv);
  const unsigned blocks =
      static_cast<unsigned>((n_vox + kThreads - 1) / kThreads);
  ray_adj_kernel<<<blocks, kThreads, 0, s>>>(y, p0, d_hat, map, out, V, R, nu,
                                             nv, r_off, nx, ny, nz, n_steps,
                                             step);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
