// tomonative — native CPU runtime for tomojax.
//
// The role the reference delegates to compiled Fortran (src/ray_wt_grad.f90
// via f2py) is played on the TPU side by XLA/Pallas; this library is the
// native HOST runtime: a multithreaded, exact-semantics CPU implementation
// of the ray-driven projector used as (a) the high-speed validation oracle
// for sizes where a NumPy implementation is impractical (256^3+), (b) the
// explicit sparse-system factory for CPU workflows, and (c) the baseline
// measurement target. Math follows the documented reference semantics
// (floor / 1-frac trilinear weights, per-corner bounds guards, 6-DoF
// Jacobian decomposition der_static + step*der_direction) — written fresh
// in C++, not transcribed.
//
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp (see build.py).
// ABI: plain C functions over f64 buffers, bound with ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Forward-project one view.
//   p0        : (3, n_rays) transformed source points (origin-relative)
//   d_hat     : (3,) unit ray direction
//   vol       : (nx*ny*nz,) volume, x-major/z-minor
//   det_img   : (n_rays,) output
void ray_forward_f64(const double* p0, const double* d_hat,
                     const double* vol, int64_t nx, int64_t ny, int64_t nz,
                     int64_t n_rays, int64_t n_steps, double step_size,
                     double* det_img) {
  const double dx = d_hat[0], dy = d_hat[1], dz = d_hat[2];
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n_rays; ++r) {
    const double x0 = p0[0 * n_rays + r];
    const double y0 = p0[1 * n_rays + r];
    const double z0 = p0[2 * n_rays + r];
    double acc = 0.0;
    for (int64_t j = 0; j < n_steps; ++j) {
      const double c = j * step_size;
      const double px = x0 + c * dx, py = y0 + c * dy, pz = z0 + c * dz;
      const int64_t fx = (int64_t)std::floor(px);
      const int64_t fy = (int64_t)std::floor(py);
      const int64_t fz = (int64_t)std::floor(pz);
      const double wx1 = px - fx, wx0 = 1.0 - wx1;
      const double wy1 = py - fy, wy0 = 1.0 - wy1;
      const double wz1 = pz - fz, wz0 = 1.0 - wz1;
      for (int ox = 0; ox < 2; ++ox) {
        const int64_t ix = fx + ox;
        if (ix < 0 || ix >= nx) continue;
        const double wx = ox ? wx1 : wx0;
        for (int oy = 0; oy < 2; ++oy) {
          const int64_t iy = fy + oy;
          if (iy < 0 || iy >= ny) continue;
          const double wxy = wx * (oy ? wy1 : wy0);
          const int64_t base = (ix * ny + iy) * nz;
          for (int oz = 0; oz < 2; ++oz) {
            const int64_t iz = fz + oz;
            if (iz < 0 || iz >= nz) continue;
            acc += wxy * (oz ? wz1 : wz0) * vol[base + iz];
          }
        }
      }
    }
    det_img[r] = acc;
  }
}

// Adjoint (exact transpose): scatter y-weighted trilinear weights.
void ray_adjoint_f64(const double* p0, const double* d_hat, const double* y,
                     int64_t nx, int64_t ny, int64_t nz, int64_t n_rays,
                     int64_t n_steps, double step_size, double* vol_out) {
  const double dx = d_hat[0], dy = d_hat[1], dz = d_hat[2];
  const int64_t n_vox = nx * ny * nz;
#if defined(_OPENMP)
  // private accumulators avoid atomics on the hot path, but n_threads
  // full-volume copies can exceed host memory for large volumes on
  // many-core hosts (96 threads x 256^3 doubles ~ 12.9 GB); cap total
  // scratch at ~1 GB of doubles and bound the team size to match.
  const int64_t max_copies = (int64_t)((size_t)1 << 27) / (n_vox ? n_vox : 1);
  const int n_threads =
      (int)std::max<int64_t>(1, std::min<int64_t>(omp_get_max_threads(),
                                                  max_copies));
#else
  const int n_threads = 1;
#endif
  double* scratch = new double[(size_t)n_threads * n_vox]();
#pragma omp parallel for schedule(static) num_threads(n_threads)
  for (int64_t r = 0; r < n_rays; ++r) {
#if defined(_OPENMP)
    double* acc = scratch + (size_t)omp_get_thread_num() * n_vox;
#else
    double* acc = scratch;
#endif
    const double yr = y[r];
    const double x0 = p0[0 * n_rays + r];
    const double y0 = p0[1 * n_rays + r];
    const double z0 = p0[2 * n_rays + r];
    for (int64_t j = 0; j < n_steps; ++j) {
      const double c = j * step_size;
      const double px = x0 + c * dx, py = y0 + c * dy, pz = z0 + c * dz;
      const int64_t fx = (int64_t)std::floor(px);
      const int64_t fy = (int64_t)std::floor(py);
      const int64_t fz = (int64_t)std::floor(pz);
      const double wx1 = px - fx, wx0 = 1.0 - wx1;
      const double wy1 = py - fy, wy0 = 1.0 - wy1;
      const double wz1 = pz - fz, wz0 = 1.0 - wz1;
      for (int ox = 0; ox < 2; ++ox) {
        const int64_t ix = fx + ox;
        if (ix < 0 || ix >= nx) continue;
        const double wx = ox ? wx1 : wx0;
        for (int oy = 0; oy < 2; ++oy) {
          const int64_t iy = fy + oy;
          if (iy < 0 || iy >= ny) continue;
          const double wxy = wx * (oy ? wy1 : wy0);
          const int64_t base = (ix * ny + iy) * nz;
          for (int oz = 0; oz < 2; ++oz) {
            const int64_t iz = fz + oz;
            if (iz < 0 || iz >= nz) continue;
            acc[base + iz] += yr * wxy * (oz ? wz1 : wz0);
          }
        }
      }
    }
  }
  std::memset(vol_out, 0, sizeof(double) * n_vox);
  for (int t = 0; t < n_threads; ++t) {
    const double* acc = scratch + (size_t)t * n_vox;
    for (int64_t i = 0; i < n_vox; ++i) vol_out[i] += acc[i];
  }
  delete[] scratch;
}

// Fused projection + 6-DoF Jacobian for one view.
//   der_static : (6, 3, n_rays) d(sample point)/d(theta), static part
//   der_dir    : (3, 3) step-scaled ray-direction part (rows phi, alpha, beta)
//   grad_out   : (6, n_rays)
void ray_forward_grad_f64(const double* p0, const double* d_hat,
                          const double* vol, const double* der_static,
                          const double* der_dir, double inv_rlen,
                          int64_t nx, int64_t ny, int64_t nz, int64_t n_rays,
                          int64_t n_steps, double step_size,
                          double* det_img, double* grad_out) {
  const double dx = d_hat[0], dy = d_hat[1], dz = d_hat[2];
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n_rays; ++r) {
    const double x0 = p0[0 * n_rays + r];
    const double y0 = p0[1 * n_rays + r];
    const double z0 = p0[2 * n_rays + r];
    double acc = 0.0;
    double gacc[6] = {0, 0, 0, 0, 0, 0};
    double gs[6][3];
    for (int p = 0; p < 6; ++p)
      for (int d = 0; d < 3; ++d)
        gs[p][d] = der_static[(p * 3 + d) * n_rays + r];
    for (int64_t j = 0; j < n_steps; ++j) {
      const double c = j * step_size;
      const double step_frac = c * inv_rlen;
      const double px = x0 + c * dx, py = y0 + c * dy, pz = z0 + c * dz;
      const int64_t fx = (int64_t)std::floor(px);
      const int64_t fy = (int64_t)std::floor(py);
      const int64_t fz = (int64_t)std::floor(pz);
      const double wx1 = px - fx, wx0 = 1.0 - wx1;
      const double wy1 = py - fy, wy0 = 1.0 - wy1;
      const double wz1 = pz - fz, wz0 = 1.0 - wz1;
      // gval = sum_corners vol * grad(weight) (3-vector)
      double gv0 = 0.0, gv1 = 0.0, gv2 = 0.0;
      for (int ox = 0; ox < 2; ++ox) {
        const int64_t ix = fx + ox;
        if (ix < 0 || ix >= nx) continue;
        const double wx = ox ? wx1 : wx0;
        const double sx = ox ? 1.0 : -1.0;
        for (int oy = 0; oy < 2; ++oy) {
          const int64_t iy = fy + oy;
          if (iy < 0 || iy >= ny) continue;
          const double wy = oy ? wy1 : wy0;
          const double sy = oy ? 1.0 : -1.0;
          const int64_t base = (ix * ny + iy) * nz;
          for (int oz = 0; oz < 2; ++oz) {
            const int64_t iz = fz + oz;
            if (iz < 0 || iz >= nz) continue;
            const double wz = oz ? wz1 : wz0;
            const double sz = oz ? 1.0 : -1.0;
            const double v = vol[base + iz];
            acc += wx * wy * wz * v;
            gv0 += v * sx * wy * wz;
            gv1 += v * sy * wx * wz;
            gv2 += v * sz * wx * wy;
          }
        }
      }
      for (int p = 0; p < 6; ++p) {
        double gx = gs[p][0], gy = gs[p][1], gz = gs[p][2];
        if (p >= 3) {
          gx += step_frac * der_dir[(p - 3) * 3 + 0];
          gy += step_frac * der_dir[(p - 3) * 3 + 1];
          gz += step_frac * der_dir[(p - 3) * 3 + 2];
        }
        gacc[p] += gv0 * gx + gv1 * gy + gv2 * gz;
      }
    }
    det_img[r] = acc;
    for (int p = 0; p < 6; ++p) grad_out[p * n_rays + r] = gacc[p];
  }
}

// Emit COO sparse weights for one view (explicit system-matrix factory,
// the trilinear_ray_sparse role). Returns the number of entries written.
// Buffers must hold 8 * n_rays * n_steps entries.
int64_t ray_sparse_coo_f64(const double* p0, const double* d_hat,
                           int64_t nx, int64_t ny, int64_t nz,
                           int64_t n_rays, int64_t n_steps, double step_size,
                           int32_t* det_inds, int32_t* dat_inds,
                           double* wts) {
  const double dx = d_hat[0], dy = d_hat[1], dz = d_hat[2];
  int64_t n = 0;
  for (int64_t r = 0; r < n_rays; ++r) {
    const double x0 = p0[0 * n_rays + r];
    const double y0 = p0[1 * n_rays + r];
    const double z0 = p0[2 * n_rays + r];
    for (int64_t j = 0; j < n_steps; ++j) {
      const double c = j * step_size;
      const double px = x0 + c * dx, py = y0 + c * dy, pz = z0 + c * dz;
      const int64_t fx = (int64_t)std::floor(px);
      const int64_t fy = (int64_t)std::floor(py);
      const int64_t fz = (int64_t)std::floor(pz);
      const double wx1 = px - fx, wx0 = 1.0 - wx1;
      const double wy1 = py - fy, wy0 = 1.0 - wy1;
      const double wz1 = pz - fz, wz0 = 1.0 - wz1;
      for (int ox = 0; ox < 2; ++ox) {
        const int64_t ix = fx + ox;
        if (ix < 0 || ix >= nx) continue;
        const double wx = ox ? wx1 : wx0;
        for (int oy = 0; oy < 2; ++oy) {
          const int64_t iy = fy + oy;
          if (iy < 0 || iy >= ny) continue;
          const double wxy = wx * (oy ? wy1 : wy0);
          for (int oz = 0; oz < 2; ++oz) {
            const int64_t iz = fz + oz;
            if (iz < 0 || iz >= nz) continue;
            det_inds[n] = (int32_t)r;
            dat_inds[n] = (int32_t)((ix * ny + iy) * nz + iz);
            wts[n] = wxy * (oz ? wz1 : wz0);
            ++n;
          }
        }
      }
    }
  }
  return n;
}

}  // extern "C"
