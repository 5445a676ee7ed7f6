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
// K1 is the plane case of the arc forward's staged two-pass march
// (slab_arc.cu, arc_march_kernel), without branches, slab pairs or
// sawtooth. A CTA owns one view and a kFU x kFV tile of detector (u, v)
// (lane = v) and marches the slabs r = 0..ny-1, owner-computes: each
// output adds its terms in registers in the order of a one-thread-per-ray
// march (slab r, then tap 0, then tap 1) and is written once, with no
// atomics. Per slab, from the tile's corners (X and zeta are affine):
//   1. the window: T's columns x (every x-tap of the tile's pixels) and the
//      rows z that pass A's taps reach over those columns, widened by a
//      rounding slack; computed 128 steps ahead into shared slots that are
//      refilled 64 at a time;
//   2. staging: the slab's rows over the window into a ring of three slabs
//      (cp.async, 16-byte copies where nz is a multiple of 4, a fixed copy
//      map per thread), zeros outside the volume, two slabs ahead;
//   3. pass A, once per (x, v) of the window: T[x, v], the z-lerp of the
//      staged row at zeta_r(x, v), into one of two shared tables; the
//      staged zeros make a tap outside the volume contribute nothing;
//   4. pass B, per owned (u, v): X_r(u, v) and both taps from the table.
// Pass A of slab r + 1 and pass B of slab r run between the same pair of
// barriers (the tables alternate), so a slab costs one __syncthreads.
// A slab whose window exceeds the table or the ring (large |evx|, gzx or
// detector pitch) runs pass B the direct way for that tile: per sample on
// global memory, as a one-thread-per-ray march does.
//
// Both passes compute the positions with x_at and zeta_at, whose fmaf
// order K2 computes them in too, and the lerps in the order that nvcc's
// contraction gave the one-thread-per-ray K1 that this march replaced
// (lerp_pair, then fmaf into the sum), so K1 gives that kernel's bits and
// K2 holds exactly K1's matrix entries. The windows only decide what the
// tables hold; tests/test_torch_plane_forward_split.py emulates them and
// counts a tap outside them as a miss. In the table passes floor() is an
// add rounded down (floor_small): F2I and FRND issue at a quarter of the
// FMA rate and were four of a sample's conversions. What bounds K1: the
// issue rate of the two passes' position arithmetic and the per-slab
// skeleton (windows, copies, barrier), not bytes: it reads each staged row
// from L2 once per tile.
//
// K2 uses that the operator is separable (zeta never depends on u), as the
// arc adjoint K4 does: per view and slab r the transpose is two 1-D
// transposes,
//   pass-B transpose  T[x, v] = scale * sum_u w_x(X_r(u, v) -> x) g[u, v],
//   pass-A transpose  vol[x, r, z] += sum_v w_z(zeta_r(x, v) -> z) T[x, v].
// A CTA owns slab r and a tile of (x, z) and walks the group's views in
// chunks of g (K2b's schedule, adj_gather, in fp32): between two barriers
// the copies of chunk k + 1 are issued (cp.async), pass B of chunk k fills
// one of two tables T, and pass A of chunk k - 1 reads the other, so a
// chunk costs one __syncthreads; each view's windows and constants are
// computed once per CTA into a ring of records. Both transposes are
// gathers: a pass-B thread owns one row v and its entries T[x, v], each the
// sum over consecutive candidates u; a pass-A thread owns voxels z of one
// column x, each the sum over consecutive candidates v, kept in registers
// across the group's views, and each voxel is written once. A candidate's
// weight is K1's lerp weight for the tap, from K1's position (x_at,
// zeta_at, with the same fmaf order): 1 - w for floor(p) = the tap, w for
// floor(p) = the tap - 1, else 0, picked by selects; no thread branches on
// a tap and no running sums are kept. So K2 holds exactly K1's matrix
// entries in float32 and the pair stays an exact transpose (CGLS needs
// that). An entry's candidates start at the first integer of its window,
// less a slack above the rounding of K1's positions and of the window's
// own arithmetic, and number K + 1 with K = floor(2/|slope| + 2 slack),
// the most such a window holds: every tap K1 takes (where zav = 1 a
// pass-A thread's voxels share their candidates, 2 a voxel, or 3 where
// the thread's windows hold them). No
// atomics, global or shared: every shared slot and register has one
// writer, and every sum runs in one fixed order, so two applies give the
// same bits. What bounds K2: the issue rate of the two gathers' position,
// floor and select arithmetic (2-3 candidates an entry at a unit pitch),
// as it bounds K2b; three CTAs an SM (shared memory: fp32 chunks, tables
// and pass-B carries). Nothing of the TPU design is
// carried over (one-hot selection matmuls, bf16 hi/lo split, band budget,
// lane padding, view bucketing): a Hopper thread gathers directly.
//
// The bf16 tier (K1b slab_plane_fwd_bf16, K2b slab_plane_adj_bf16) replaces
// the bf16=True variants of the same two Pallas kernels (chosen at
// tomojax/kernels/slab.py:904 and :1015), which feed each pass of the
// two-pass transform to the MXU as one bf16 operand. Rounding (nearest
// even) happens at each pass's input, and both are kernels of their own:
//   K1b (fwd_bf16_kernel) stages the volume's rows in bf16 (the wrapper
//     casts the oriented volume once; 48-value rows, 16-byte copies of 8)
//     and rounds T once per (x, v); the sums, the positions and the 1/edy
//     scale stay fp32. Its tables hold pair words, word x = (T[x], T[x +
//     1]), so pass B reads both taps of a pixel in one 32-bit load and
//     widens them by a shift and a mask; pass A is K1's, warp-strided,
//     and stores each rounded T twice (the low half of word x, the high
//     half of word x - 1). Pass B's X is the plain version's (cx + v*evx)
//     + u*eux with u*eux kept per pixel, so a position costs one add, and
//     floor(X) folds into the table address. One slab a barrier, as K1
//     (two and four measured slower); launch bounds of three CTAs an SM
//     (the compiler takes 56 registers and four still fit; the bound of
//     four, 64 registers, gave a slower schedule). What bounds it: the
//     issue rate of the two passes, as K1, pass A the larger;
//   K2b (adj_bf16_kernel) stages the cotangent g in bf16 (the wrapper
//     casts it once) and rounds each view's pass-B transpose T[x, v] once,
//     where the plain version rounds the pass-B cotangent; the pass-A sums
//     and the volume stay fp32.
// tomojax rounds the products w*g and its aligned accumulator because
// those are its matmul operands; a gather has no such operand, so the
// rounding points are g and T. The difference lies within tomojax's
// contract for the tier (3e-3 relative per apply, 5e-3 A/A^T mismatch:
// scripts/tpu_kernel_check.py). kernels/slab.py's plain bf16 versions round
// at the same points.
//
// K2b owes K1b no bit-for-bit transpose (the tier's contract is 3e-3), so
// it runs K2's schedule with its own matrix: a fixed count of consecutive
// candidates, ceil(2/|slope|), from floor(q) + 1, each weighted by the hat
// max(0, 1 - |p - k|), which is the lerp's weight of tap k (1 - w for
// floor(p), w for the next) up to rounding and zero for every other
// candidate. The positions follow the plain version's operations, each
// rounded once, and T sums scale * g as the plain vjp does, so T is the
// plain version's pass-B cotangent to the rounding of its sum and its bf16
// rounding falls the same way almost everywhere (K1's positions, a few
// ulps from the plain ones, moved K2b 2e-4 from its plain version). What
// bounds K2b: the issue rate of the two gathers' arithmetic, as it bounds
// K1.
// 16-byte copies carry 8 bf16 values: they need nz (K1b) or nv (K2b) a
// multiple of 8; other sizes stage with plain loads.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

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

// Slab r's offsets cx_r, cz_r.
__device__ __forceinline__ float slab_cx(const Plane& p, float r) {
  return fmaf(p.rx, r, p.cxb);
}

__device__ __forceinline__ float slab_cz(const Plane& p, float r) {
  return fmaf(p.rz, r, p.czb);
}

// Pass-B position X_r(u, v) from cx_r. Explicit fmaf keeps one rounding
// sequence in both kernels whatever the compiler contracts.
__device__ __forceinline__ float x_at(const Plane& p, float cx, float u,
                                      float v) {
  return fmaf(p.evx, v, fmaf(p.eux, u, cx));
}

// Pass-A position zeta_r(x, v) at grid column x, from cx_r and cz_r.
__device__ __forceinline__ float zeta_at(const Plane& p, float cx, float cz,
                                         float x, float v) {
  return fmaf(p.zav, v, fmaf(p.gzx, x - cx, cz));
}

// Integer range [lo, hi] (clamped to [0, n)) holding every index i whose
// computed position can have a tap in [lo_val + 1, hi_val - 1], i.e. lies
// in [lo_val, hi_val), for a position that is a + b * i in exact
// arithmetic; inv_b = 1/b, so a call costs multiplies, no division. The
// exact tap weights decide. Slack (u = 2^-24): zeta_at rounds a + zav*v
// once (its a is this a to the bit), x_at from slab_cx three times, with
// terms of at most |a| + ext + |b| n (ext = |evx| nv bounds the v term
// that X folds into a), so a computed position is off by at most 3u (2|a|
// + ext + |b| n + |val|); the inversion rounds val - a once, inv_b carries
// u and the product and the slack's subtraction u more each: 4.1u (|val|
// + |a|) |inv_b| in index units. The range is widened by 1e-6 > 16u times
// (2|a| + ext + |b| n + |lo_val| + |hi_val| + 2) |inv_b|, which holds
// both, so every integer of the exact range lies in [ceil(tl), floor(th)].
// The result is monotone in a, lo_val and hi_val (the slack is convex in
// a), so the range of a tile's extreme corners holds the range of every
// point inside it. |b| < 1e-6 takes [0, n).
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

// Zero-filling copies: src_bytes (0 or the copy's size) are read, the rest
// of the copy is zero.
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// The lerp of taps a (weight 1 - w) and c (weight w), in the order nvcc's
// contraction gave the one-thread-per-ray K1: the first product rounded,
// the second fused into it. A tap outside the axis is passed as zero,
// which gives that kernel's value (it skipped the tap) up to the sign of a
// zero, and a zero's sign never reaches an output: the sums start at +0.
__device__ __forceinline__ float lerp_pair(float a, float c, float w) {
  return fmaf(w, c, __fmul_rn(1.0f - w, a));
}

// floor(q) as a float and an int, for |q| < 2^22: q + 1.5 * 2^23 rounded
// down is 1.5 * 2^23 + floor(q), exactly, with floor(q) in its low
// mantissa bits. Adds instead of FRND and F2I, which issue at a quarter of
// the FMA rate.
struct Floor {
  float f;
  int k;
};

__device__ __forceinline__ Floor floor_small(float q) {
  const float s = __fadd_rd(q, 12582912.0f);
  return {s - 12582912.0f, __float_as_int(s) - 0x4B400000};
}

// K1 tiling. A CTA owns one view and a kFU x kFV tile of detector (u, v):
// lane = v, and each thread owns kPix pixels u of its v (warp, warp + 8,
// ...). Shared memory: a ring of kRing staged slabs (kSX rows x of kSZ
// values z); two pass-A tables T[x][v] of kSX columns x by kFV rows v
// (pass A of slab r + 1 fills one while pass B of slab r reads the other);
// and the windows of kWin steps, refilled kWin / 2 at a time.
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFU = 32, kFV = 32;
constexpr int kPix = kFU / kFwdWarps;
constexpr int kSX = 56;
constexpr int kRowsA = kSX / kFwdWarps;   // pass-A columns per warp
constexpr int kTab = kSX * kFV;
constexpr int kRing = 3;
constexpr int kWin = 128;

// K1's staged slabs and tables (fp32). kSZ: the staged rows' z, a multiple
// of 4 (16-byte rows); K1b's rows (bf16) hold kHSZ, a multiple of 8.
constexpr int kSZ = 44;
constexpr int kSlab = kSX * kSZ;
constexpr int kFwdSmem = 4 * (kRing * kSlab + 2 * kTab) + kWin * 16;
static_assert(kSZ % 4 == 0, "staged rows of 16-byte copies");
constexpr int kHSZ = 48;
constexpr int kHSlab = kSX * kHSZ;
static_assert(kHSZ % 8 == 0, "staged rows of 16-byte copies");

// Staged rows of values T: kRowZ values z, kPer to a 16-byte copy. A
// thread's share of a slab's copies (kVec): chunk c = tid % kChunks of the
// ring rows g + k * kRows (g = tid / kChunks, k < kIters); fixed over the
// march.
template <typename T>
struct Rows {
  static constexpr int kRowZ = sizeof(T) == 4 ? kSZ : kHSZ;
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  static constexpr int kChunks = kRowZ / kPer;
  static constexpr int kRows = kFwdThreads / kChunks;
  static constexpr int kIters = (kSX + kRows - 1) / kRows;
};
static_assert(kFwdSmem <= 227 * 1024, "K1 fits an SM's shared memory");

// A step's window: int4 (x0, x1, z0, z1): T's columns x in [x0, x1] (the
// staged rows) and the staged rows' z in [z0, z1], unclamped: a column or z
// outside the volume holds zeros; z0 a multiple of kAlign (a 16-byte copy's
// values, for the 16-byte copies of kVec). z1 < 0 marks a step without
// windows: kEmpty (no tap of the tile reaches the volume) or kDirect (the
// windows exceed the capacities, or a position is out of floor_small's
// range).
constexpr int kEmpty = -1, kDirect = -2;
constexpr float kPosMax = 2097152.0f;   // 2^21: windows within floor_small's

// The tile's corners: u in [ua, ub], v in [va, vb].
struct Corners {
  float ua, ub, va, vb;
};

// The lowest tap floor(q) of any q >= lo and the highest tap floor(q) + 1
// of any q <= hi, widened by a slack far above the rounding of the
// kernel's positions and of the window's own arithmetic (each a few
// roundings of terms whose magnitudes sum to at most mag: below 6 u mag).
__device__ __forceinline__ float tap_lo(float lo, float mag) {
  return floorf(lo - (1e-3f + 4e-6f * mag));
}

__device__ __forceinline__ float tap_hi(float hi, float mag) {
  return floorf(hi + (1e-3f + 4e-6f * mag)) + 1.0f;
}

// Step r's window for staged rows of kRowZ values z. X - cx_r = eux*u +
// evx*v and zeta - cz_r = gzx*(x - cx_r) + zav*v are affine, so their
// extremes over the tile lie at its corners (and at T's extreme columns).
template <int kRowZ, int kAlign>
__device__ int4 step_window(const Plane& p, const Corners& c, int ri, int nx,
                            int ny, int nz) {
  if (ri >= ny) return make_int4(0, -1, 0, kEmpty);
  const float r = static_cast<float>(ri);
  const float cx = slab_cx(p, r), cz = slab_cz(p, r);
  const float xa = p.eux * c.ua, xb = p.eux * c.ub;
  const float ya = p.evx * c.va, yb = p.evx * c.vb;
  const float mx = fabsf(cx) + fmaxf(fabsf(xa), fabsf(xb)) +
                   fmaxf(fabsf(ya), fabsf(yb));
  const float xl = tap_lo(cx + fminf(xa, xb) + fminf(ya, yb), mx);
  const float xh = tap_hi(cx + fmaxf(xa, xb) + fmaxf(ya, yb), mx);
  const float ga = p.gzx * (xl - cx), gb = p.gzx * (xh - cx);
  const float za = p.zav * c.va, zb = p.zav * c.vb;
  const float mz = fabsf(cz) + fmaxf(fabsf(ga), fabsf(gb)) +
                   fmaxf(fabsf(za), fabsf(zb)) +
                   fabsf(p.gzx) * (fabsf(cx) + fmaxf(fabsf(xl), fabsf(xh)));
  const float zl = tap_lo(cz + fminf(ga, gb) + fminf(za, zb), mz);
  const float zh = tap_hi(cz + fmaxf(ga, gb) + fmaxf(za, zb), mz);
  if (!(fmaxf(fabsf(xl), fabsf(xh)) < kPosMax &&
        fmaxf(fabsf(zl), fabsf(zh)) < kPosMax))
    return make_int4(0, -1, 0, kDirect);   // NaN included
  if (xh < 0.0f || xl > static_cast<float>(nx - 1) || zh < 0.0f ||
      zl > static_cast<float>(nz - 1))
    return make_int4(0, -1, 0, kEmpty);
  const int x0 = static_cast<int>(xl), x1 = static_cast<int>(xh);
  const int z0 = static_cast<int>(zl) & ~(kAlign - 1);   // rounds down
  const int z1 = static_cast<int>(zh);
  if (x1 - x0 >= kSX || z1 - z0 >= kRowZ)
    return make_int4(0, -1, 0, kDirect);
  return make_int4(x0, x1, z0, z1);
}

// Issue the copies of slab s's rows x in [w.x, w.y], z in [w.z, w.w]
// (zeros outside the volume) into buf[x - w.x][z - w.z] as one cp.async
// commit group (empty for a step without windows): 16-byte copies (kVec:
// nz and w.z multiples of kPer, so a copy lies wholly in or out of the
// volume), else 4-byte copies (fp32) or plain loads and stores (bf16:
// cp.async has no 2-byte copy; the next barrier makes them visible as it
// does the copies). Offsets are 32-bit (the wrapper keeps the volume below
// 2^31 elements); a zero fill reads nothing and points at vol.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_slab(T* buf, const T* __restrict__ vol,
                                          int s, int4 w, int nx, int ny,
                                          int nz, int tid, int c, int g) {
  using R = Rows<T>;
  if (w.w >= 0) {
    const unsigned unx = static_cast<unsigned>(nx);
    const unsigned unz = static_cast<unsigned>(nz);
    if (kVec) {
      const int z = w.z + R::kPer * c;
      if (g < R::kRows && R::kPer * c <= w.w - w.z) {
        const bool z_in = static_cast<unsigned>(z) < unz;
        // rows R::kRows apart, modulo 2^32 (a row in the volume is exact)
        const unsigned step = static_cast<unsigned>(R::kRows) * ny * unz;
        unsigned off =
            (static_cast<unsigned>(w.x + g) * ny + s) * unz + z;
        int x = w.x + g;
        T* const dst = buf + g * R::kRowZ + R::kPer * c;
        if (w.x >= 0 && w.y < nx) {
          // every row in the volume: a copy needs only its address
          const T* src = vol + (z_in ? off : 0);
          const size_t stride =
              z_in ? static_cast<size_t>(R::kRows) * ny * nz : 0;
#pragma unroll
          for (int k = 0; k < R::kIters; ++k) {
            if (x + k * R::kRows <= w.y)
              cp_async16_zfill(dst + k * R::kRows * R::kRowZ, src,
                               z_in ? 16 : 0);
            src += stride;
          }
        } else {
#pragma unroll
          for (int k = 0; k < R::kIters; ++k) {
            if (x <= w.y) {
              const bool in = z_in && static_cast<unsigned>(x) < unx;
              cp_async16_zfill(dst + k * R::kRows * R::kRowZ,
                               vol + (in ? off : 0), in ? 16 : 0);
            }
            x += R::kRows;
            off += step;
          }
        }
      }
    } else {
      const int nq = w.y - w.x + 1, nzw = w.w - w.z + 1;
      for (int e = tid; e < nq * R::kRowZ; e += kFwdThreads) {
        const int xl = e / R::kRowZ, zl = e - xl * R::kRowZ;
        if (zl < nzw) {
          const int x = w.x + xl, z = w.z + zl;
          const bool in = static_cast<unsigned>(x) < unx &&
                          static_cast<unsigned>(z) < unz;
          const unsigned off = in ? (static_cast<unsigned>(x) * ny + s) * unz
                                        + z : 0;
          if constexpr (sizeof(T) == 4)
            cp_async4_zfill(buf + e, vol + off, in ? 4 : 0);
          else
            buf[e] = in ? vol[off] : __float2bfloat16_rn(0.0f);
        }
      }
    }
  }
  cp_async_commit();
}

// Pass A's rows i in [kI0, kI1) of a warp: the z-lerp at zeta_s(x, v),
// x = fx + i * kFwdWarps, of staged row q[i * kFwdWarps][.] into
// t[i * kFwdWarps][lane]; kGuard: only the rows below nq (counted from
// the warp's first).
template <int kI0, int kI1, bool kGuard>
__device__ __forceinline__ void pass_a_rows(float* __restrict__ t,
                                            const float* __restrict__ q,
                                            const Plane& p, float cx,
                                            float cz, float fx, float fv,
                                            int nq) {
#pragma unroll
  for (int i = kI0; i < kI1; ++i) {
    if (kGuard && i * kFwdWarps >= nq) continue;
    const float zeta =
        zeta_at(p, cx, cz, fx + static_cast<float>(i * kFwdWarps), fv);
    const Floor f = floor_small(zeta);
    const float* const row = q + i * kFwdWarps * kSZ + f.k;
    t[i * kFwdWarps * kFV] = lerp_pair(row[0], row[1], zeta - f.f);
  }
}

// Pass A of step s with window w (its slab staged in buf): the z-lerp at
// zeta_s(x, v) of T's columns x into tab[x - w.x][lane], warp-strided. A
// window of at least 4 * kFwdWarps columns (every one at 256^3 with a unit
// pitch) runs the first 4 rows of each warp without tests.
__device__ __forceinline__ void pass_a(float* __restrict__ tab,
                                       const float* __restrict__ buf,
                                       const Plane& p, int s, int4 w,
                                       int warp, int lane, float fv) {
  const float r = static_cast<float>(s);
  const float cx = slab_cx(p, r), cz = slab_cz(p, r);
  const int nq = w.y - w.x + 1 - warp;   // this warp's rows: i*kFwdWarps < nq
  const float fx = static_cast<float>(w.x + warp);
  const float* const q = buf + warp * kSZ - w.z;   // z at [z]
  float* const t = tab + warp * kFV + lane;
  if (nq > 3 * kFwdWarps) {
    pass_a_rows<0, 4, false>(t, q, p, cx, cz, fx, fv, nq);
    pass_a_rows<4, kRowsA, true>(t, q, p, cx, cz, fx, fv, nq);
  } else {
    pass_a_rows<0, kRowsA, true>(t, q, p, cx, cz, fx, fv, nq);
  }
}

// Pass B of a fast step: both taps of each owned pixel from the table tab
// (T's columns hold every tap of the tile), added into acc; kGuard: only
// the pixels inside the detector.
template <bool kGuard>
__device__ __forceinline__ void pass_b(float (&acc)[kPix],
                                       const bool (&pix)[kPix],
                                       const float (&fu)[kPix],
                                       const Plane& p, float cx, float fv,
                                       const float* __restrict__ tab) {
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (kGuard && !pix[k]) continue;
    const float X = x_at(p, cx, fu[k], fv);
    const Floor f = floor_small(X);
    const float wx = X - f.f;
    const float* const t = tab + f.k * kFV;
    acc[k] = fmaf(1.0f - wx, t[0], acc[k]);
    acc[k] = fmaf(wx, t[kFV], acc[k]);
  }
}

// K1: grid (v tiles, u tiles, views); vol (nx, ny, nz), scalars (V, NS),
// out (V, nu, nv); kVec: nz a multiple of 4 and vol 16-byte aligned. Every
// output is written exactly once.
//
// Iteration r: wait for slab r + 1; one barrier; stage slab r + 3 into the
// slot of slab r (pass A of r ran last iteration); pass A of slab r + 1
// into table (r + 1) & 1; pass B of slab r from table r & 1 for a fast
// step, per sample on global memory (the one-thread-per-ray code) for a
// direct one, nothing for an empty one (no tap of the tile reaches the
// volume).
template <bool kVec>
__global__ void __launch_bounds__(kFwdThreads, 4)
fwd_kernel(const float* __restrict__ vol, const float* __restrict__ scalars,
           float* __restrict__ out, int nx, int ny, int nz, int nu, int nv) {
  extern __shared__ __align__(16) float sm[];
  float* const ring = sm;
  float* const tabs = ring + kRing * kSlab;
  int4* const win = reinterpret_cast<int4*>(tabs + 2 * kTab);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int view = blockIdx.z;
  const int v0 = blockIdx.x * kFV, u0 = blockIdx.y * kFU;
  const Plane p = load_plane(scalars + static_cast<size_t>(view) * NS);
  const Corners corners{static_cast<float>(u0),
                        static_cast<float>(min(u0 + kFU, nu) - 1),
                        static_cast<float>(v0),
                        static_cast<float>(min(v0 + kFV, nv) - 1)};
  const int v = v0 + lane;
  const bool v_in = v < nv;
  const float fv = static_cast<float>(v);
  float fu[kPix], acc[kPix];
  bool pix[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int u = u0 + warp + kFwdWarps * k;
    fu[k] = static_cast<float>(u);
    pix[k] = v_in && u < nu;
    acc[k] = 0.0f;
  }
  const bool full = u0 + kFU <= nu && v0 + kFV <= nv;   // every pixel inside

  const int copy_c = tid % Rows<float>::kChunks;
  const int copy_g = tid / Rows<float>::kChunks;

  for (int s = tid; s < kWin; s += kFwdThreads)
    win[s] = step_window<kSZ, kVec ? 4 : 1>(p, corners, s, nx, ny, nz);
  __syncthreads();
  for (int s = 0; s < kRing; ++s)
    stage_slab<float, kVec>(ring + s * kSlab, vol, s, win[s], nx, ny, nz,
                            tid, copy_c, copy_g);
  int4 w_a = win[0];   // the window of the step whose pass A runs next
  cp_async_wait<kRing - 1>();   // slab 0
  __syncthreads();
  if (w_a.w >= 0 && v_in) pass_a(tabs, ring, p, 0, w_a, warp, lane, fv);

  int slot = 0;   // ring slot of slab r
  for (int ri = 0; ri < ny; ++ri) {
    const int slot1 = slot == kRing - 1 ? 0 : slot + 1;
    const int4 w_b = w_a;
    w_a = win[(ri + 1) % kWin];
    cp_async_wait<kRing - 2>();   // slab r + 1
    __syncthreads();   // ... visible; pass A of r, pass B of r - 1 done
    stage_slab<float, kVec>(ring + slot * kSlab, vol, ri + kRing,
                            win[(ri + kRing) % kWin], nx, ny, nz, tid,
                            copy_c, copy_g);
    if (w_a.w >= 0 && v_in)
      pass_a(tabs + ((ri + 1) & 1) * kTab, ring + slot1 * kSlab, p, ri + 1,
             w_a, warp, lane, fv);
    const float r = static_cast<float>(ri);
    const float cx = slab_cx(p, r);
    if (w_b.w >= 0) {
      const float* const tab = tabs + (ri & 1) * kTab + lane - w_b.x * kFV;
      if (full)
        pass_b<false>(acc, pix, fu, p, cx, fv, tab);
      else
        pass_b<true>(acc, pix, fu, p, cx, fv, tab);
    } else if (w_b.w == kDirect) {
      const float cz = slab_cz(p, r);
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (!pix[k]) continue;
        const float X = x_at(p, cx, fu[k], fv);
        const float xf = floorf(X);
        const int x0 = static_cast<int>(xf);
        const float wx = X - xf;
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int xi = x0 + o;
          if (xi < 0 || xi >= nx) continue;
          const float zeta = zeta_at(p, cx, cz, static_cast<float>(xi), fv);
          const float zf = floorf(zeta);
          const int z0 = static_cast<int>(zf);
          const float* row = vol + (static_cast<size_t>(xi) * ny + ri) * nz;
          const unsigned unz = static_cast<unsigned>(nz);
          const float a =
              static_cast<unsigned>(z0) < unz ? __ldg(row + z0) : 0.0f;
          const float c =
              static_cast<unsigned>(z0) + 1u < unz ? __ldg(row + z0 + 1)
                                                   : 0.0f;
          acc[k] = fmaf(o ? wx : 1.0f - wx, lerp_pair(a, c, zeta - zf),
                        acc[k]);
        }
      }
    }
    // windows of steps r + kWin/2 .. r + kWin - 1 into the slots of steps
    // r - kWin/2 .. r - 1 (read again after kWin/2 - kRing barriers)
    if (ri % (kWin / 2) == 0 && ri > 0 && tid < kWin / 2) {
      const int s = ri + kWin / 2 + tid;
      win[s % kWin] = step_window<kSZ, kVec ? 4 : 1>(p, corners, s, nx, ny,
                                                    nz);
    }
    slot = slot1;
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (pix[k])
      out[(static_cast<size_t>(view) * nu + u0 + warp + kFwdWarps * k) * nv +
          v] = acc[k] * p.scale;
  }
}

// K1b tiling: K1's CTA (one view, a kFU x kFV tile of (u, v), lane = v,
// kPix pixels u a thread), K1's windows and window slots, one slab a
// barrier: between two barriers the copies of slab r + 2 are issued, pass
// A runs for slab r + 1 and pass B for slab r. Shared memory: a ring of two
// staged slabs (kSX rows x of kHSZ bf16 values z), two pair tables (kSX
// words x by kFV rows v, word x = (T[x], T[x + 1]) in bf16), and the
// windows. Launch bounds of three CTAs an SM: the registers the compiler
// then takes (56) still let four run, and its schedule measured faster
// than under the cap of four (64 registers).
constexpr int kFwdHSmem = 2 * (2 * kHSlab + 4 * kTab) + kWin * 16;
static_assert(kWin / 2 >= 3,
              "a refill writes no window slot that its iteration reads");
static_assert(4 * (kFwdHSmem + 1024) <= 228 * 1024, "4 K1b CTAs an SM");

// One value's bf16 bits (nearest even).
__device__ __forceinline__ unsigned short bf16_rn_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// zeta_r(x, v) = gzx*x + zc with zc = (cz_r - gzx*cx_r) + zav*v, a lane's
// constant per slab.
__device__ __forceinline__ float zeta_const(const Plane& p, float cx,
                                            float cz, float zv) {
  return __fadd_rn(fmaf(-p.gzx, cx, cz), zv);
}

// K1b pass A's columns i in [kI0, kI1) of a warp, c = warp + i * kFwdWarps
// (K1's order; kGuard: only those below nq_w = nq - warp): T[c] = the
// z-lerp at zeta(x, v) of staged row c, rounded to bf16 once and stored
// twice, as the low half of pair word c and the high half of word c - 1
// (word nq - 1 is never read; word -1 does not exist: first marks warp 0).
template <int kI0, int kI1, bool kGuard>
__device__ __forceinline__ void pass_a_cols(
    unsigned short* __restrict__ t, const unsigned short* __restrict__ q,
    float gzx, float z0, int nq_w, bool first) {
#pragma unroll
  for (int i = kI0; i < kI1; ++i) {
    if (kGuard && i * kFwdWarps >= nq_w) continue;
    const float zeta = fmaf(gzx, static_cast<float>(i * kFwdWarps), z0);
    const float s = __fadd_rd(zeta, 12582912.0f);
    const float w = zeta - (s - 12582912.0f);
    const unsigned short* row = q + i * kFwdWarps * kHSZ +
                                (__float_as_int(s) -
                                 static_cast<int>(kFloorBias));
    const float lo = widen_lo(row[0]);
    const unsigned short b = bf16_rn_bits(fmaf(w, widen_lo(row[1]) - lo, lo));
    t[2 * (i * kFwdWarps * kFV)] = b;
    if (i > 0 || !first) t[2 * ((i * kFwdWarps - 1) * kFV) + 1] = b;
  }
}

// K1b pass A of a slab with window w, staged in buf (bf16 bits [x][z]),
// into its pair table tab (bf16 halves of [x][v] words); zeta(x, v) =
// gzx*x + zc. A window of more than 3 * kFwdWarps columns runs the first 4
// rows of each warp without tests, as K1.
__device__ __forceinline__ void pass_a_bf16(
    unsigned short* __restrict__ tab, const unsigned short* __restrict__ buf,
    float gzx, float zc, int4 w, int warp, int lane) {
  const int nq_w = w.y - w.x + 1 - warp;
  const float z0 = fmaf(gzx, static_cast<float>(w.x + warp), zc);
  const unsigned short* const q = buf + warp * kHSZ - w.z;
  unsigned short* const t = tab + 2 * (warp * kFV + lane);
  if (nq_w > 3 * kFwdWarps) {
    pass_a_cols<0, 4, false>(t, q, gzx, z0, nq_w, warp == 0);
    pass_a_cols<4, kRowsA, true>(t, q, gzx, z0, nq_w, warp == 0);
  } else {
    pass_a_cols<0, kRowsA, true>(t, q, gzx, z0, nq_w, warp == 0);
  }
}

// K1b pass B of a fast slab: both taps of each owned pixel as one pair word
// of the table; tb is the table's address of word floor(X) less its bias;
// X = xt + u*eux (xt = cx_r + v*evx), the plain version's order.
template <bool kGuard>
__device__ __forceinline__ void pass_b_bf16(float (&acc)[kPix],
                                            const bool (&pix)[kPix],
                                            const float (&ue)[kPix],
                                            float xt, unsigned tb) {
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (kGuard && !pix[k]) continue;
    const float X = __fadd_rn(xt, ue[k]);
    const float s = __fadd_rd(X, 12582912.0f);
    const float wx = X - (s - 12582912.0f);
    const unsigned word = lds_u32(tb + (__float_as_uint(s) << 7));
    acc[k] = fmaf(1.0f - wx, widen_lo(word), acc[k]);
    acc[k] = fmaf(wx, widen_hi(word), acc[k]);
  }
}

// K1b: grid (v tiles, u tiles, views); vol (nx, ny, nz) in bf16, scalars
// (V, NS), out (V, nu, nv) in fp32; kVec: nz a multiple of 8 and vol
// 16-byte aligned. Every output is written exactly once.
//
// Iteration r: wait for slab r + 1's copies; one barrier; issue slab r +
// 2's into ring slot r & 1 (pass A of r ran last iteration); pass A of slab
// r + 1 into table (r + 1) & 1; pass B of slab r from table r & 1 for a
// fast step, per sample on global memory for a direct one (the rows and T
// rounded to bf16 as the tables hold them), nothing for an empty one.
template <bool kVec>
__global__ void __launch_bounds__(kFwdThreads, 3)
fwd_bf16_kernel(const __nv_bfloat16* __restrict__ vol,
                const float* __restrict__ scalars, float* __restrict__ out,
                int nx, int ny, int nz, int nu, int nv) {
  extern __shared__ __align__(16) float sm[];
  __nv_bfloat16* const ring = reinterpret_cast<__nv_bfloat16*>(sm);
  unsigned* const tabs = reinterpret_cast<unsigned*>(ring + 2 * kHSlab);
  int4* const win = reinterpret_cast<int4*>(tabs + 2 * kTab);
  const unsigned tabs_s = smem_addr(tabs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int view = blockIdx.z;
  const int v0 = blockIdx.x * kFV, u0 = blockIdx.y * kFU;
  const Plane p = load_plane(scalars + static_cast<size_t>(view) * NS);
  const Corners corners{static_cast<float>(u0),
                        static_cast<float>(min(u0 + kFU, nu) - 1),
                        static_cast<float>(v0),
                        static_cast<float>(min(v0 + kFV, nv) - 1)};
  const int v = v0 + lane;
  const bool v_in = v < nv;
  const float fv = static_cast<float>(v);
  const float xv = __fmul_rn(p.evx, fv), zv = __fmul_rn(fv, p.zav);
  float ue[kPix], acc[kPix];
  bool pix[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int u = u0 + warp + kFwdWarps * k;
    ue[k] = __fmul_rn(p.eux, static_cast<float>(u));
    pix[k] = v_in && u < nu;
    acc[k] = 0.0f;
  }
  const bool full = u0 + kFU <= nu && v0 + kFV <= nv;   // every pixel inside
  const int copy_c = tid % Rows<__nv_bfloat16>::kChunks;
  const int copy_g = tid / Rows<__nv_bfloat16>::kChunks;
  auto stage_at = [&](int s) {
    stage_slab<__nv_bfloat16, kVec>(ring + (s & 1) * kHSlab, vol, s,
                                    win[s % kWin], nx, ny, nz, tid, copy_c,
                                    copy_g);
  };
  auto pass_a_at = [&](int s) {
    const int4 w = win[s % kWin];
    if (w.w < 0) return;
    const float r = static_cast<float>(s);
    const float cx = __fadd_rn(p.cxb, __fmul_rn(p.rx, r));
    const float cz = __fadd_rn(p.czb, __fmul_rn(p.rz, r));
    pass_a_bf16(reinterpret_cast<unsigned short*>(tabs + (s & 1) * kTab),
                reinterpret_cast<const unsigned short*>(ring) +
                    (s & 1) * kHSlab,
                p.gzx, zeta_const(p, cx, cz, zv), w, warp, lane);
  };

  for (int s = tid; s < kWin; s += kFwdThreads)
    win[s] = step_window<kHSZ, kVec ? 8 : 1>(p, corners, s, nx, ny, nz);
  __syncthreads();
  stage_at(0);
  stage_at(1);
  cp_async_wait<1>();   // slab 0
  __syncthreads();
  if (v_in) pass_a_at(0);

  for (int ri = 0; ri < ny; ++ri) {
    cp_async_wait<0>();   // slab r + 1
    __syncthreads();      // ... visible; pass A of r, pass B of r - 1 done
    // windows of steps r + kWin/2 .. r + kWin - 1 into the slots of steps
    // r - kWin/2 .. r - 1 (first read by the staging of a later slab)
    if (ri % (kWin / 2) == 0 && ri > 0 && tid < kWin / 2) {
      const int s = ri + kWin / 2 + tid;
      win[s % kWin] = step_window<kHSZ, kVec ? 8 : 1>(p, corners, s, nx, ny,
                                                     nz);
    }
    stage_at(ri + 2);
    if (v_in) pass_a_at(ri + 1);
    const int4 w = win[ri % kWin];
    const float r = static_cast<float>(ri);
    const float cx = __fadd_rn(p.cxb, __fmul_rn(p.rx, r));
    const float xt = __fadd_rn(cx, xv);
    if (w.w >= 0) {
      const unsigned tb = tabs_s + 4u * ((ri & 1) * kTab + lane) -
                          128u * static_cast<unsigned>(w.x) -
                          (kFloorBias << 7);
      if (full)
        pass_b_bf16<false>(acc, pix, ue, xt, tb);
      else
        pass_b_bf16<true>(acc, pix, ue, xt, tb);
    } else if (w.w == kDirect) {
      const float cz = __fadd_rn(p.czb, __fmul_rn(p.rz, r));
      const float zc = zeta_const(p, cx, cz, zv);
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (!pix[k]) continue;
        const float X = __fadd_rn(xt, ue[k]);
        const float xf = floorf(X);
        const int x0 = static_cast<int>(xf);
        const float wx = X - xf;
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int xi = x0 + o;
          if (xi < 0 || xi >= nx) continue;
          const float zeta = fmaf(p.gzx, static_cast<float>(xi), zc);
          const float zf = floorf(zeta);
          const int z0 = static_cast<int>(zf);
          const __nv_bfloat16* row =
              vol + (static_cast<size_t>(xi) * ny + ri) * nz;
          const unsigned unz = static_cast<unsigned>(nz);
          const float a = static_cast<unsigned>(z0) < unz
                              ? __bfloat162float(__ldg(row + z0)) : 0.0f;
          const float c = static_cast<unsigned>(z0) + 1u < unz
                              ? __bfloat162float(__ldg(row + z0 + 1))
                              : 0.0f;
          // T rounded to bf16, as the tables hold it
          const float t = __bfloat162float(
              __float2bfloat16_rn(fmaf(zeta - zf, c - a, a)));
          acc[k] = fmaf(o ? wx : 1.0f - wx, t, acc[k]);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (pix[k])
      out[(static_cast<size_t>(view) * nu + u0 + warp + kFwdWarps * k) * nv +
          v] = acc[k] * p.scale;
  }
}

// K2 and K2b: one gather schedule (adj_gather), two kernels. A CTA owns
// slab r and the oriented voxels (x, z) of a kTX x kTZ tile. It walks the
// group's views in chunks (view, v chunk of up to kVC rows from a multiple
// of a 16-byte copy's values, u chunk of up to kUC columns; one chunk per
// view at 256^3 and 512^3 with a unit pitch: the u window of 32 columns is
// 24-36 wide for |eux| in [1, sqrt 2], the v window of 64 z ~66-70). Phase
// k, between two barriers: the copies of chunk k + 1 are issued (cp.async
// into the other of two staged chunks), pass B of chunk k runs, and pass A
// of chunk k - 1 (the tables alternate), so a chunk costs one
// __syncthreads. For pass B,
// kBRows * kVC threads own one row v each and the columns x = xg, xg +
// kBRows, ... of it (kBEnt entries, their sums waiting in shared slots of
// the thread's own where a v chunk has several u chunks); for pass A a
// thread owns kZR voxels z of one column x (their sums stay in registers
// across the call). Each view's windows and constants are computed once
// per CTA, by one lane each, kBBatch views at a time, into a ring of three
// batches in shared memory. The kernels differ in the element type, the
// positions, the weights and the chunk sizes (a policy each: AdjF32 for
// K2, AdjBf16 for K2b).
constexpr int kAdjThreads = 256;
constexpr int kTX = 32, kTZ = 64;
constexpr int kZR = 8;                              // pass-A voxels z a thread
constexpr int kBRows = 3;                           // pass-B threads a row v
constexpr int kBEnt = (kTX + kBRows - 1) / kBRows;  // pass-B entries a thread
constexpr int kBBatch = 32;                         // view records per batch

struct AdjTile {
  int nu, nv;
  float r, fxa, fxb, fza, fzb;   // slab and the tile's corners
};

// A chunk: view, v chunk vci and u chunk uci packed as vu = vci * kPosU +
// uci (registers are the scarce resource); an empty view is one chunk.
constexpr int kPosShift = 12;
constexpr int kPosU = 1 << kPosShift;
struct Pos {
  int view, vu;
  __device__ int vci() const { return vu >> kPosShift; }
  __device__ int uci() const { return vu & (kPosU - 1); }
};

template <class R>
__device__ __forceinline__ const R& rec(const R* ring, int view) {
  return ring[(view / kBBatch) % 3 * kBBatch + view % kBBatch];
}

template <class R>
__device__ __forceinline__ void advance(Pos* s, const R* ring) {
  const R& w = rec(ring, s->view);
  if (s->uci() + 1 < w.nuc) {
    ++s->vu;
  } else if (s->vci() + 1 < max(w.nvc, 1)) {
    s->vu = (s->vci() + 1) * kPosU;
  } else {
    s->vu = 0;
    ++s->view;
  }
}

// A chunk's extent: v rows [vc0, vc0 + nvw), u columns [uc0, uc0 + nst)
// staged (nst >= cu: rows past the u window hold g or, past the detector,
// zeros, so that every pass-B candidate lies in the buffer).
struct Extent {
  int vc0, nvw, uc0, nst;
};

template <int kUC, int kVC, class R>
__device__ __forceinline__ Extent extent(const R& w, const Pos& s) {
  Extent e;
  e.vc0 = w.vs + s.vci() * kVC;
  e.nvw = min(w.vhi - e.vc0 + 1, kVC);
  e.uc0 = w.ulo + s.uci() * kUC;
  e.nst = min(max(min(w.uhi - e.uc0 + 1, kUC), w.cu), kUC);
  return e;
}

// K2b's chunks: rows of kBVC bf16 values v from a multiple of 8, u chunks
// of kBUC columns.
constexpr int kBUC = 64, kBVC = 80;
constexpr int kBStage = kBUC * kBVC;                // bf16 values of a chunk
constexpr int kBTP = kBVC + 2;                      // T pitch: 41 words, odd
static_assert(kBRows * kBVC <= kAdjThreads, "a pass-B thread per row part");
static_assert(kBVC % 8 == 0, "rows of 16-byte words");

// One view as a K2b tile sees it: the slab's offsets, the positions'
// scalars, the v window [vs, vhi] (vs aligned down to 8 rows for 16-byte
// copies) in nvc chunks and the u window [ulo, uhi] in nuc chunks (nvc = 0:
// no tap of the view reaches the tile), and the candidates a pass-B entry
// (cu) and a pass-A voxel (cv) take: the most integers that an open
// interval of width 2 / |eux| (2 / |zav|) can hold.
struct ViewRec {
  float cx, cz, eux, evx, zav, gzx, scale, inv_eux, inv_zav;
  int vs, vhi, nvc, ulo, uhi, nuc, cu, cv;
};
// two staged chunks and two tables T (bf16), the ring of view records, and
// the pass-B sums carried across u chunks (fp32, [entry][thread])
constexpr int kBSmem = 2 * (2 * kBStage) + 2 * (2 * kTX * kBTP) +
                       3 * kBBatch * static_cast<int>(sizeof(ViewRec)) +
                       4 * kBEnt * kAdjThreads;
static_assert(4 * kTX * (kTZ + 1) <= kBSmem, "the output staging fits");

// x rounded to bf16 (nearest even) as its 16 bits, for finite x: an
// integer add (the conversion instruction issues at a quarter of the FMA
// rate).
__device__ __forceinline__ unsigned short bf16_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return static_cast<unsigned short>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// The float of a bf16's 16 bits.
__device__ __forceinline__ float bf16_value(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// View `view`'s record for the tile t. The positions follow the plain
// version's operations (kernels/slab.py, core/slab_projector.py
// _forward_chunk), each rounded once: cx = cxb + rx*r, X = (cx + evx*v) +
// eux*u, zeta = (cz + gzx*(x - cx)) + v*zav. The windows are window()'s,
// over the tile's extreme columns and the view's extreme rows.
__device__ void view_rec(const float* __restrict__ scalars, int view,
                         const AdjTile& t, bool vec, ViewRec* out) {
  const Plane p = load_plane(scalars + static_cast<size_t>(view) * NS);
  ViewRec w;
  w.cx = __fadd_rn(p.cxb, __fmul_rn(p.rx, t.r));
  w.cz = __fadd_rn(p.czb, __fmul_rn(p.rz, t.r));
  w.eux = p.eux;
  w.evx = p.evx;
  w.zav = p.zav;
  w.gzx = p.gzx;
  w.scale = p.scale;
  w.inv_eux = __frcp_rn(p.eux);
  w.inv_zav = __frcp_rn(p.zav);
  int l0, h0, l1, h1;
  window(fmaf(p.gzx, t.fxa - w.cx, w.cz), p.zav, w.inv_zav, t.fza - 1.0f,
         t.fzb + 1.0f, 0.0f, t.nv, &l0, &h0);
  window(fmaf(p.gzx, t.fxb - w.cx, w.cz), p.zav, w.inv_zav, t.fza - 1.0f,
         t.fzb + 1.0f, 0.0f, t.nv, &l1, &h1);
  const int vlo = min(l0, l1);
  w.vhi = max(h0, h1);
  w.vs = vec ? vlo & ~7 : vlo;
  const float ext = fabsf(p.evx) * t.nv;
  window(fmaf(p.evx, static_cast<float>(w.vs), w.cx), p.eux, w.inv_eux,
         t.fxa - 1.0f, t.fxb + 1.0f, ext, t.nu, &l0, &h0);
  window(fmaf(p.evx, static_cast<float>(w.vhi), w.cx), p.eux, w.inv_eux,
         t.fxa - 1.0f, t.fxb + 1.0f, ext, t.nu, &l1, &h1);
  w.ulo = min(l0, l1);
  w.uhi = max(h0, h1);
  const bool empty = vlo > w.vhi || w.ulo > w.uhi;
  w.nvc = empty ? 0 : (w.vhi - w.vs) / kBVC + 1;
  w.nuc = empty ? 1 : (w.uhi - w.ulo) / kBUC + 1;
  w.cu = candidates(2.0f * fabsf(w.inv_eux), kBUC);
  w.cv = candidates(2.0f * fabsf(w.inv_zav), kBVC);
  *out = w;
}

// Issue the copies of chunk s of the cotangent g (V, nu, nv) in bf16 into
// dst[ul][vl] (one commit group): 16-byte copies where vec (nv a multiple
// of 8, g 16-byte aligned, vc0 a multiple of 8: the last word of a row
// may run past the chunk, never past the row's end), zeros for the rows
// past the detector; else plain loads and stores, which the phase's
// barrier makes visible as it does the copies.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* g,
                                           const ViewRec& w, const Pos& s,
                                           int nu, int nv, bool vec) {
  if (w.nvc > 0) {
    const Extent c = extent<kBUC, kBVC>(w, s);
    const __nv_bfloat16* src =
        g + (static_cast<size_t>(s.view) * nu + c.uc0) * nv + c.vc0;
    if (vec) {
      constexpr int kW = kBVC / 8;
      const int nq = (c.nvw + 7) / 8;
      for (int e = threadIdx.x; e < c.nst * kW; e += kAdjThreads) {
        const int ul = e / kW, q = e - ul * kW;
        if (q >= nq) continue;
        const bool in = c.uc0 + ul < nu;
        cp_async16_zfill(dst + 8 * e,
                         in ? src + static_cast<size_t>(ul) * nv + 8 * q : g,
                         in ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < c.nst * kBVC; e += kAdjThreads) {
        const int ul = e / kBVC, vl = e - ul * kBVC;
        if (vl < c.nvw)
          dst[e] = c.uc0 + ul < nu ? src[static_cast<size_t>(ul) * nv + vl]
                                   : __float2bfloat16_rn(0.0f);
      }
    }
  }
  cp_async_commit();
}

// The first of the candidates of a gather whose open window (in index
// units) starts at q: floor(q) + 1, clamped to [lo, hi], as an int and a
// float. A window start that rounding moves across an integer drops a tap
// whose weight is below that rounding; the clamp keeps every read in the
// staged rows, whose rows outside the chunk hold zeros or belong to no
// other chunk.
__device__ __forceinline__ int first_candidate(float q, int lo, int hi,
                                               float* f) {
  const int k = min(max(floor_small(q).k + 1, lo), hi);
  *f = int_to_float(k);
  return k;
}

// Pass B of one thread's entries (x = x0 + xg + kBRows*q, v) of a chunk:
// T[x, v] += hat(X(u, v) - x) * scale * g[u, v] over kC consecutive u (kC
// = 0: cu of them), X = (cx + evx*v) + eux*u, the sum starting from 0
// (first u chunk) or this thread's slot in sAcc, and going back there, or
// after the v chunk's last u chunk, rounded, to the table tb (zero for a
// row past the chunk, row_in false). scale * g is the plain vjp's
// cotangent, so T is its pass-B transpose to the rounding of the sum.
// kOne: the v chunk has one u chunk (first and last).
template <int kC, bool kOne>
__device__ __forceinline__ void pass_b_entries(
    unsigned short* __restrict__ tb, float* __restrict__ slots,
    const __nv_bfloat16* __restrict__ sG, const ViewRec& w, float base,
    float q0, float fx0, int nq, int uc0, int smax, int cu, bool row_in,
    bool first, bool last) {
  if (kOne) first = last = true;   // the v chunk's only u chunk
  const float step = static_cast<float>(kBRows) * w.inv_eux;
#pragma unroll
  for (int q = 0; q < kBEnt; ++q) {
    if (q >= nq) break;
    float t = first ? 0.0f : slots[q * kAdjThreads];
    if (row_in) {
      const float fx = fx0 + static_cast<float>(kBRows * q);
      float fu;
      const int u0 = first_candidate(fmaf(static_cast<float>(q), step, q0),
                                     uc0, smax, &fu);
      const __nv_bfloat16* gp = sG + (u0 - uc0) * kBVC;
      const int n = kC > 0 ? kC : cu;
#pragma unroll
      for (int i = 0; i < (kC > 0 ? kC : 4); ++i) {
        if (kC == 0 && i >= n) break;
        const float X =
            __fadd_rn(base, __fmul_rn(w.eux, fu + static_cast<float>(i)));
        t = fmaf(hat(X, fx), __fmul_rn(w.scale, __bfloat162float(gp[i * kBVC])),
                 t);
      }
      for (int i = kC > 0 ? kC : 4; i < n; ++i) {
        const float X =
            __fadd_rn(base, __fmul_rn(w.eux, fu + static_cast<float>(i)));
        t = fmaf(hat(X, fx), __fmul_rn(w.scale, __bfloat162float(gp[i * kBVC])),
                 t);
      }
    }
    if (last)
      tb[kBRows * q * kBTP] = bf16_bits(t);
    else
      slots[q * kAdjThreads] = t;
  }
}

// Pass A of one thread's voxels (column x, z = za + j) over a chunk's rows:
// acc[j] += hat(zeta(x, v) - z) * T[x, v] over kC consecutive v (kC = 0: cv
// of them), zeta = (cz + gzx*(x - cx)) + v*zav.
template <int kC>
__device__ __forceinline__ void pass_a_gather(
    float (&acc)[kZR], const unsigned short* __restrict__ trow,
    const ViewRec& w, float a, float q0, float fzo, int vc0, int smax,
    int cv) {
#pragma unroll
  for (int j = 0; j < kZR; ++j) {
    const float fz = fzo + static_cast<float>(j);
    float fv;
    const int v0 = first_candidate(
        fmaf(static_cast<float>(j), w.inv_zav, q0), vc0, smax, &fv);
    float t = acc[j];
    const int n = kC > 0 ? kC : cv;
#pragma unroll
    for (int i = 0; i < (kC > 0 ? kC : 4); ++i) {
      if (kC == 0 && i >= n) break;
      const float zeta =
          __fadd_rn(a, __fmul_rn(fv + static_cast<float>(i), w.zav));
      t = fmaf(hat(zeta, fz), bf16_value(trow[v0 + i]), t);
    }
    for (int i = kC > 0 ? kC : 4; i < n; ++i) {
      const float zeta =
          __fadd_rn(a, __fmul_rn(fv + static_cast<float>(i), w.zav));
      t = fmaf(hat(zeta, fz), bf16_value(trow[v0 + i]), t);
    }
    acc[j] = t;
  }
}

// K2b's policy: bf16 g and T, the plain version's positions, hat weights
// over a fixed count of candidates from floor(q) + 1.
struct AdjBf16 {
  using G = __nv_bfloat16;
  using T = unsigned short;
  using Rec = ViewRec;
  static constexpr int kUC = kBUC, kVC = kBVC, kTP = kBTP, kStage = kBStage;

  __device__ __forceinline__ static void record(
      const float* __restrict__ scalars, int view, const AdjTile& t,
      bool vec, Rec* out) {
    view_rec(scalars, view, t, vec, out);
  }

  __device__ __forceinline__ static void stage(G* dst, const G* g,
                                               const Rec& w, const Pos& s,
                                               int nu, int nv, bool vec) {
    stage_bf16(dst, g, w, s, nu, nv, vec);
  }

  // Pass B of chunk c for the thread of row vb and columns fxb + kBRows*q
  // (q < nqb): its T column tb, its slots, the staged rows sG at its row.
  __device__ __forceinline__ static void pass_b(T* tb, float* slots,
                                                const G* sG, const Rec& w,
                                                const Extent& c, int vb,
                                                float fxb, int nqb,
                                                bool first, bool last) {
    const int cu = min(w.cu, c.nst);
    const int smax = c.uc0 + c.nst - cu;
    const bool row_in = vb < c.nvw;
    const float fv = int_to_float(c.vc0 + vb);
    const float base = __fadd_rn(w.cx, __fmul_rn(w.evx, fv));
    const float lo = w.eux > 0.0f ? -1.0f : 1.0f;
    const float q0 =
        __fmul_rn(__fsub_rn(__fadd_rn(fxb, lo), base), w.inv_eux);
#define K2B_PASS_B(C, ONE)                                             \
  pass_b_entries<C, ONE>(tb, slots, sG, w, base, q0, fxb, nqb, c.uc0,  \
                         smax, cu, row_in, first, last)
    if (w.nuc == 1) {
      switch (cu) {
        case 1: K2B_PASS_B(1, true); break;
        case 2: K2B_PASS_B(2, true); break;
        case 3: K2B_PASS_B(3, true); break;
        default: K2B_PASS_B(0, true);
      }
    } else {
      K2B_PASS_B(0, false);
    }
#undef K2B_PASS_B
  }

  // Pass A of chunk c for the thread of column fxo and voxels z = fzo + j;
  // trow is its column of T, indexed by v.
  __device__ __forceinline__ static void pass_a(float (&acc)[kZR],
                                                const T* trow, const Rec& w,
                                                const Extent& c, float fxo,
                                                float fzo) {
    const int nvs = min(max(c.nvw, w.cv), kBVC);
    const int cv = min(w.cv, nvs);
    const int smax = c.vc0 + nvs - cv;
    const float a = __fadd_rn(w.cz, __fmul_rn(w.gzx, __fsub_rn(fxo, w.cx)));
    const float lo = w.zav > 0.0f ? -1.0f : 1.0f;
    const float q0 = __fmul_rn(__fsub_rn(__fadd_rn(fzo, lo), a), w.inv_zav);
#define K2B_PASS_A(C) \
  pass_a_gather<C>(acc, trow, w, a, q0, fzo, c.vc0, smax, cv)
    switch (cv) {
      case 1: K2B_PASS_A(1); break;
      case 2: K2B_PASS_A(2); break;
      case 3: K2B_PASS_A(3); break;
      default: K2B_PASS_A(0);
    }
#undef K2B_PASS_A
  }
};

// K2's chunks: rows of kFVC fp32 values v from a multiple of 4 (66-69 rows
// hold a 64-z tile's window at a unit pitch), u chunks of kFUC columns.
// With the pass-B slots they keep K2 at three CTAs an SM.
constexpr int kFUC = 64, kFVC = 72;
constexpr int kFStage = kFUC * kFVC;                // fp32 values of a chunk
constexpr int kFTP = kFVC + 1;                      // T pitch: odd
static_assert(kBRows * kFVC <= kAdjThreads, "a pass-B thread per row part");
static_assert(kFVC % 4 == 0, "rows of 16-byte words");

// One view as a K2 tile sees it: K1's slab offsets (slab_cx, slab_cz), the
// scalars, the v window [vs, vhi] (vs aligned down to 4 rows for 16-byte
// copies) in nvc chunks and the u window [ulo, uhi] in nuc chunks (nvc = 0:
// no tap of the view reaches the tile); per transpose the slack su (sv) of
// a window start in index units and the candidates cu (cv) an entry
// (voxel) takes (exact_candidates); wv = 2/|zav| + 2 sv, a window's width
// in v.
struct F32Rec {
  float cx, cz, eux, evx, zav, gzx, scale, inv_eux, inv_zav, su, sv, wv;
  int vs, vhi, nvc, ulo, uhi, nuc, cu, cv;
};
// two staged chunks and two tables T, the ring of view records and the
// pass-B sums carried across u chunks ([entry][thread]), all fp32
constexpr int kAdjSmem = 4 * (2 * kFStage + 2 * kTX * kFTP) +
                         3 * kBBatch * static_cast<int>(sizeof(F32Rec)) +
                         4 * kBEnt * kAdjThreads;
static_assert(4 * kTX * (kTZ + 1) <= kAdjSmem, "the output staging fits");
static_assert(3 * (kAdjSmem + 1024) <= 228 * 1024, "3 K2 CTAs an SM");

// K2's candidate count for windows [A, A + width] (index units) whose
// starts lie within `reach` of zero: each holds at most K + 1 integers (K =
// floor(width)), so an entry takes K + 1 consecutive candidates from
// floor(A) + 1. Past the cap, or beyond floor_small's range (NaN included):
// cap + 1, which makes every entry take its whole chunk. So no geometry
// exceeds what the gathers take: they stay exact for any scalars.
__device__ __forceinline__ int exact_candidates(float width, float reach,
                                                int cap) {
  if (!(reach < kPosMax)) return cap + 1;
  return min(static_cast<int>(width), cap) + 1;
}

// View `view`'s record for the tile t, on K1's positions: X = fmaf(evx, v,
// fmaf(eux, u, cx)) (x_at) and zeta = fmaf(zav, v, fmaf(gzx, x - cx, cz))
// (zeta_at) with cx, cz = slab_cx, slab_cz. The windows are window()'s
// (K2's slack), over the tile's extreme columns and the view's extreme
// rows.
//
// The slacks: a computed X is within 2u (|cx| + |eux| nu + |evx| nv) of
// the exact affine value (u = 2^-24; two roundings), a computed zeta within
// u (|a| + |zav| nv) (one rounding; a = zeta at v = 0 is computed as K1
// does), and an entry's window start A (a few roundings of terms below the
// same magnitudes plus the tile's |x| or |z|, and up to 10 steps of the
// reciprocal) within ~10u |1/eux| of that magnitude sum m. su = 2e-6 |1/eux|
// m > 33u |1/eux| m holds both, so every candidate with a nonzero weight
// lies in [floor(A) + 1, floor(A + 2/|eux| + 2 su)] with A the start less
// su.
__device__ void view_rec_f32(const float* __restrict__ scalars, int view,
                             const AdjTile& t, bool vec, F32Rec* out) {
  const Plane p = load_plane(scalars + static_cast<size_t>(view) * NS);
  F32Rec w;
  w.cx = slab_cx(p, t.r);
  w.cz = slab_cz(p, t.r);
  w.eux = p.eux;
  w.evx = p.evx;
  w.zav = p.zav;
  w.gzx = p.gzx;
  w.scale = p.scale;
  w.inv_eux = __frcp_rn(p.eux);
  w.inv_zav = __frcp_rn(p.zav);
  int l0, h0, l1, h1;
  const float a0 = fmaf(p.gzx, t.fxa - w.cx, w.cz);
  const float a1 = fmaf(p.gzx, t.fxb - w.cx, w.cz);
  window(a0, p.zav, w.inv_zav, t.fza - 1.0f, t.fzb + 1.0f, 0.0f, t.nv, &l0,
         &h0);
  window(a1, p.zav, w.inv_zav, t.fza - 1.0f, t.fzb + 1.0f, 0.0f, t.nv, &l1,
         &h1);
  const int vlo = min(l0, l1);
  w.vhi = max(h0, h1);
  w.vs = vec ? vlo & ~3 : vlo;
  const float ext = fabsf(p.evx) * t.nv;
  window(fmaf(p.evx, static_cast<float>(w.vs), w.cx), p.eux, w.inv_eux,
         t.fxa - 1.0f, t.fxb + 1.0f, ext, t.nu, &l0, &h0);
  window(fmaf(p.evx, static_cast<float>(w.vhi), w.cx), p.eux, w.inv_eux,
         t.fxa - 1.0f, t.fxb + 1.0f, ext, t.nu, &l1, &h1);
  w.ulo = min(l0, l1);
  w.uhi = max(h0, h1);
  const bool empty = vlo > w.vhi || w.ulo > w.uhi;
  w.nvc = empty ? 0 : (w.vhi - w.vs) / kFVC + 1;
  w.nuc = empty ? 1 : (w.uhi - w.ulo) / kFUC + 1;
  const float mu = fabsf(w.cx) + fabsf(p.eux) * t.nu + ext +
                   fmaxf(fabsf(t.fxa), fabsf(t.fxb)) + 4.0f;
  w.su = 2e-6f * fabsf(w.inv_eux) * mu;
  const float wu = 2.0f * fabsf(w.inv_eux) + 2.0f * w.su;
  w.cu = exact_candidates(wu, fabsf(w.inv_eux) * mu + wu, kFUC);
  const float mv = fmaxf(fabsf(a0), fabsf(a1)) + fabsf(p.zav) * t.nv +
                   fmaxf(fabsf(t.fza), fabsf(t.fzb)) + 12.0f;
  w.sv = 2e-6f * fabsf(w.inv_zav) * mv;
  w.wv = 2.0f * fabsf(w.inv_zav) + 2.0f * w.sv;
  w.cv = exact_candidates(w.wv, fabsf(w.inv_zav) * mv + w.wv, kFVC);
  *out = w;
}

// Issue the copies of chunk s of the cotangent g (V, nu, nv) into
// dst[ul][vl] (one commit group): 16-byte copies where vec (nv a multiple
// of 4, g 16-byte aligned, vc0 a multiple of 4: the last word of a row may
// run past the chunk, never past the row's end), else 4-byte copies; zeros
// for the rows past the detector.
__device__ __forceinline__ void stage_f32(float* dst, const float* g,
                                          const F32Rec& w, const Pos& s,
                                          int nu, int nv, bool vec) {
  if (w.nvc > 0) {
    const Extent c = extent<kFUC, kFVC>(w, s);
    const float* src =
        g + (static_cast<size_t>(s.view) * nu + c.uc0) * nv + c.vc0;
    if (vec) {
      constexpr int kW = kFVC / 4;
      const int nq = (c.nvw + 3) / 4;
      for (int e = threadIdx.x; e < c.nst * kW; e += kAdjThreads) {
        const int ul = e / kW, q = e - ul * kW;
        if (q >= nq) continue;
        const bool in = c.uc0 + ul < nu;
        cp_async16_zfill(dst + 4 * e,
                         in ? src + static_cast<size_t>(ul) * nv + 4 * q : g,
                         in ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < c.nst * kFVC; e += kAdjThreads) {
        const int ul = e / kFVC, vl = e - ul * kFVC;
        if (vl >= c.nvw) continue;
        const bool in = c.uc0 + ul < nu;
        cp_async4_zfill(dst + e,
                        in ? src + static_cast<size_t>(ul) * nv + vl : g,
                        in ? 4 : 0);
      }
    }
  }
  cp_async_commit();
}

// A position's lerp as K1 computes it: floor_small's sum s = 1.5 * 2^23 +
// floor(pos) and w = pos - floor(pos).
struct Lerp {
  float s, w;
};

__device__ __forceinline__ Lerp lerp_of(float pos) {
  const float s = __fadd_rd(pos, 12582912.0f);
  return {s, pos - (s - 12582912.0f)};
}

// K1's lerp weight that lerp l gives the tap whose floor_small sum is sx:
// 1 - w for floor(pos) = tap, w for floor(pos) = tap - 1, else 0; picked
// by selects, not branches.
__device__ __forceinline__ float tap_weight(const Lerp& l, float sx) {
  const float hi = l.s == sx ? 1.0f - l.w : 0.0f;
  return l.s == sx - 1.0f ? l.w : hi;
}

// K2's pass B of one thread's entries (x = x0 + xg + kBRows*q, v) of a
// chunk: T[x, v] = scale * sum_u w_x(X(u, v) -> x) * g[u, v] over kC
// consecutive u (kC = 0: n of them) from the entry's first candidate
// (start A less its slack, clamped to [uc0, smax]); X and the weight are
// K1's (x_at's order, tap_weight). The sum starts from 0 (first u chunk)
// or this thread's slot in sAcc and goes back there, or after the v
// chunk's last u chunk, times scale, to the table tb (zero for a row past
// the chunk, row_in false). kOne: the v chunk has one u chunk (first and
// last).
template <int kC, bool kOne>
__device__ __forceinline__ void pass_b_f32(
    float* __restrict__ tb, float* __restrict__ slots,
    const float* __restrict__ sG, const F32Rec& w, float fv, float a0,
    float sx0, int nq, int uc0, int smax, int n, bool row_in, bool first,
    bool last) {
  if (kOne) first = last = true;   // the v chunk's only u chunk
  const float step = static_cast<float>(kBRows) * w.inv_eux;
#pragma unroll
  for (int q = 0; q < kBEnt; ++q) {
    if (q >= nq) break;
    float t = first ? 0.0f : slots[q * kAdjThreads];
    if (row_in) {
      float fu;
      const int u0 = first_candidate(fmaf(static_cast<float>(q), step, a0),
                                     uc0, smax, &fu);
      const float sx = sx0 + static_cast<float>(kBRows * q);
      const float* gp = sG + (u0 - uc0) * kFVC;
      const int m = kC > 0 ? kC : n;
#pragma unroll
      for (int i = 0; i < (kC > 0 ? kC : 4); ++i) {
        if (kC == 0 && i >= m) break;
        const float X = fmaf(w.evx, fv, fmaf(w.eux, fu + static_cast<float>(i),
                                             w.cx));
        t = fmaf(tap_weight(lerp_of(X), sx), gp[i * kFVC], t);
      }
      for (int i = kC > 0 ? kC : 4; i < m; ++i) {
        const float X = fmaf(w.evx, fv, fmaf(w.eux, fu + static_cast<float>(i),
                                             w.cx));
        t = fmaf(tap_weight(lerp_of(X), sx), gp[i * kFVC], t);
      }
    }
    if (last)
      tb[kBRows * q * kFTP] = t * w.scale;
    else
      slots[q * kAdjThreads] = t;
  }
}

// K2's pass A of one thread's voxels (column x, z = za + j) over a chunk's
// rows: acc[j] += sum_v w_z(zeta(x, v) -> z) * T[x, v] over kC consecutive
// v (kC = 0: n of them) from each voxel's first candidate; zeta =
// fmaf(zav, v, a) with a = K1's zeta at v = 0, the weight K1's.
template <int kC>
__device__ __forceinline__ void pass_a_f32(
    float (&acc)[kZR], const float* __restrict__ trow, const F32Rec& w,
    float a, float a0, float sz0, int vc0, int smax, int n) {
#pragma unroll
  for (int j = 0; j < kZR; ++j) {
    float fv;
    const int v0 = first_candidate(fmaf(static_cast<float>(j), w.inv_zav, a0),
                                   vc0, smax, &fv);
    const float sz = sz0 + static_cast<float>(j);
    float t = acc[j];
    const int m = kC > 0 ? kC : n;
#pragma unroll
    for (int i = 0; i < (kC > 0 ? kC : 4); ++i) {
      if (kC == 0 && i >= m) break;
      const float zeta = fmaf(w.zav, fv + static_cast<float>(i), a);
      t = fmaf(tap_weight(lerp_of(zeta), sz), trow[v0 + i], t);
    }
    for (int i = kC > 0 ? kC : 4; i < m; ++i) {
      const float zeta = fmaf(w.zav, fv + static_cast<float>(i), a);
      t = fmaf(tap_weight(lerp_of(zeta), sz), trow[v0 + i], t);
    }
    acc[j] = t;
  }
}

// K2's pass A where zav = 1 (a v pitch of one voxel with no tilt, as in
// configs 2-5): voxel j's window starts exactly j rows after voxel 0's,
// so the thread's kZR voxels share their kN candidates a voxel: each of
// the kN + kZR - 1 rows s0 + m is positioned and floored once and weighted
// for each voxel whose candidates hold it, in the order of v as the
// per-voxel gather sums (the same bits: a candidate more adds zero). A row
// outside the chunk's table reads zero. kN = 2 or, where the thread's
// windows hold one more (one test for all its voxels), 3.
template <int kN>
__device__ __forceinline__ void pass_a_unit(float (&acc)[kZR],
                                            const float* __restrict__ trow,
                                            const F32Rec& w, float a, int s0,
                                            float sz0, int vc0) {
  const float fv0 = int_to_float(s0);
#pragma unroll
  for (int m = 0; m < kN + kZR - 1; ++m) {
    const Lerp l = lerp_of(fmaf(w.zav, fv0 + static_cast<float>(m), a));
    const bool in = static_cast<unsigned>(s0 + m - vc0) < kFVC;
    const float tv = in ? trow[s0 + m] : 0.0f;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int j = m - i;   // row m is voxel j's candidate i
      if (j < 0 || j >= kZR) continue;
      acc[j] = fmaf(tap_weight(l, sz0 + static_cast<float>(j)), tv, acc[j]);
    }
  }
}

// K2's policy: fp32 g and T, K1's positions and weights; an entry takes
// cu (cv) candidates from the start of its slack window (the whole chunk
// past the cap).
struct AdjF32 {
  using G = float;
  using T = float;
  using Rec = F32Rec;
  static constexpr int kUC = kFUC, kVC = kFVC, kTP = kFTP, kStage = kFStage;

  __device__ __forceinline__ static void record(
      const float* __restrict__ scalars, int view, const AdjTile& t,
      bool vec, Rec* out) {
    view_rec_f32(scalars, view, t, vec, out);
  }

  __device__ __forceinline__ static void stage(G* dst, const G* g,
                                               const Rec& w, const Pos& s,
                                               int nu, int nv, bool vec) {
    stage_f32(dst, g, w, s, nu, nv, vec);
  }

  __device__ __forceinline__ static void pass_b(T* tb, float* slots,
                                                const G* sG, const Rec& w,
                                                const Extent& c, int vb,
                                                float fxb, int nqb,
                                                bool first, bool last) {
    const int n = min(w.cu, c.nst);
    const int smax = c.uc0 + c.nst - n;
    const bool row_in = vb < c.nvw;
    const float fv = int_to_float(c.vc0 + vb);
    const float lo = w.eux > 0.0f ? -1.0f : 1.0f;
    // the window start of column fxb less its slack: (x - 1 - X(0, v)) /
    // eux (x + 1 where eux < 0)
    const float a0 =
        fmaf((fxb + lo) - fmaf(w.evx, fv, w.cx), w.inv_eux, -w.su);
    const float sx0 = fxb + 12582912.0f;
#define K2_PASS_B(C, ONE)                                                \
  pass_b_f32<C, ONE>(tb, slots, sG, w, fv, a0, sx0, nqb, c.uc0, smax, n, \
                     row_in, first, last)
    if (w.nuc == 1) {
      switch (n) {
        case 2: K2_PASS_B(2, true); break;
        case 3: K2_PASS_B(3, true); break;
        default: K2_PASS_B(0, true);
      }
    } else {
      K2_PASS_B(0, false);
    }
#undef K2_PASS_B
  }

  __device__ __forceinline__ static void pass_a(float (&acc)[kZR],
                                                const T* trow, const Rec& w,
                                                const Extent& c, float fxo,
                                                float fzo) {
    const float a = fmaf(w.gzx, fxo - w.cx, w.cz);
    const float lo = w.zav > 0.0f ? -1.0f : 1.0f;
    // the window start of voxel fzo less its slack
    const float a0 = fmaf((fzo + lo) - a, w.inv_zav, -w.sv);
    const float sz0 = fzo + 12582912.0f;
    if (w.zav == 1.0f && w.cv == 3) {
      const int k = floor_small(a0).k;
      if (floor_small(a0 + w.wv).k - k > 2)
        pass_a_unit<3>(acc, trow, w, a, k + 1, sz0, c.vc0);
      else
        pass_a_unit<2>(acc, trow, w, a, k + 1, sz0, c.vc0);
      return;
    }
    const int nvs = min(max(c.nvw, w.cv), kFVC);
    const int n = min(w.cv, nvs);
    const int smax = c.vc0 + nvs - n;
#define K2_PASS_A(C) \
  pass_a_f32<C>(acc, trow, w, a, a0, sz0, c.vc0, smax, n)
    switch (n) {
      case 2: K2_PASS_A(2); break;
      case 3: K2_PASS_A(3); break;
      default: K2_PASS_A(0);
    }
#undef K2_PASS_A
  }
};

// The gather schedule of K2 and K2b: grid (z tiles, x tiles, slabs r); g
// (V, nu, nv) in K's element type, scalars (V, NS), vol (nx, ny, nz); vec:
// g's rows in 16-byte words. Every voxel is written once, and every sum
// runs in one fixed order (no atomics, global or shared): each shared slot
// and register has one writer. Both transposes are gathers: an entry T[x,
// v] sums its weights times g over consecutive candidates u, a voxel its
// weights times T over consecutive candidates v; a candidate outside the
// window adds zero, and no thread branches on a tap.
template <class K>
__device__ __forceinline__ void adj_gather(float* sm,
                                           const typename K::G* __restrict__ g,
                                           const float* __restrict__ scalars,
                                           float* __restrict__ vol, int V,
                                           int nx, int ny, int nz, int nu,
                                           int nv, bool vec) {
  using Rec = typename K::Rec;
  typename K::G* const stage = reinterpret_cast<typename K::G*>(sm);
  // 2 x [xl][vl]: T
  typename K::T* const sT =
      reinterpret_cast<typename K::T*>(stage + 2 * K::kStage);
  Rec* const ring = reinterpret_cast<Rec*>(sT + 2 * kTX * K::kTP);
  float* const sAcc = reinterpret_cast<float*>(ring + 3 * kBBatch);
  const int tid = threadIdx.x, lane = tid & 31;
  const int z0 = blockIdx.x * kTZ, x0 = blockIdx.y * kTX, ri = blockIdx.z;
  const int ntx = min(kTX, nx - x0), ntz = min(kTZ, nz - z0);
  const AdjTile t{nu, nv, static_cast<float>(ri),
                  static_cast<float>(x0), static_cast<float>(x0 + ntx - 1),
                  static_cast<float>(z0), static_cast<float>(z0 + ntz - 1)};
  // this thread's pass-A voxels: column xa_l, z in [za_o, zb_o]
  const int xa_l = tid % kTX;
  const int za_o = z0 + (tid / kTX) * kZR;
  const int zb_o = min(za_o + kZR, z0 + ntz) - 1;
  const bool owns_a = xa_l < ntx && za_o <= zb_o;
  const float fxo = static_cast<float>(x0 + xa_l);
  const float fzo = static_cast<float>(za_o);
  // this thread's pass-B entries: row vb, columns xg + kBRows*q (q < nqb)
  const int vb = tid % K::kVC, xg = tid / K::kVC;
  const bool owns_b = tid < kBRows * K::kVC && xg < ntx;
  const int nqb = (ntx - xg + kBRows - 1) / kBRows;
  const float fxb = static_cast<float>(x0 + xg);
  float acc[kZR];
#pragma unroll
  for (int s = 0; s < kZR; ++s) acc[s] = 0.0f;

  // the records of batches 0 and 1
  if (tid < 2 * kBBatch && tid < V)
    K::record(scalars, tid, t, vec, ring + tid);
  __syncthreads();
  Pos pa{V, 0}, pb{0, 0}, ps{0, 0};   // pass A, pass B, staging
  if (V > 0) {
    K::stage(stage, g, rec(ring, 0), pb, nu, nv, vec);
    advance(&ps, ring);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int k = 0; pb.view < V || pa.view < V; ++k) {
    if (ps.view < V) {
      K::stage(stage + ((k + 1) & 1) * K::kStage, g, rec(ring, ps.view), ps,
               nu, nv, vec);
      // the staging enters batch b >= 1: warp 0 computes batch b + 1 into
      // the ring slot of batch b - 2, which no phase reads any more
      const int nb = ps.view + kBBatch + lane;
      if (ps.view % kBBatch == 0 && ps.view > 0 && ps.vu == 0 && tid < 32 &&
          nb < V)
        K::record(scalars, nb, t, vec,
                  ring + (nb / kBBatch) % 3 * kBBatch + nb % kBBatch);
    }
    if (pb.view < V) {
      const Rec& w = rec(ring, pb.view);
      if (w.nvc > 0) {
        // pass B of chunk k: T[x, v] for this thread's entries
        const Extent c = extent<K::kUC, K::kVC>(w, pb);
        if (owns_b)
          K::pass_b(sT + (k & 1) * (kTX * K::kTP) + xg * K::kTP + vb,
                    sAcc + tid, stage + (k & 1) * K::kStage + vb, w, c, vb,
                    fxb, nqb, pb.uci() == 0, pb.uci() == w.nuc - 1);
      }
    }
    if (pa.view < V && owns_a) {
      const Rec& w = rec(ring, pa.view);
      if (w.nvc > 0 && pa.uci() == w.nuc - 1) {
        // pass A of chunk k - 1: this thread's voxels gather rows of T
        const Extent c = extent<K::kUC, K::kVC>(w, pa);
        K::pass_a(acc,
                  sT + ((k - 1) & 1) * (kTX * K::kTP) + xa_l * K::kTP - c.vc0,
                  w, c, fxo, fzo);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    pa = pb;
    pb = ps;
    if (ps.view < V) advance(&ps, ring);
  }
  // every voxel written once, through shared memory so that the stores run
  // along z
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

// K2: g (V, nu, nv) fp32; vec: nv a multiple of 4 and g 16-byte aligned.
// Three CTAs an SM (kAdjSmem; 80 registers).
__global__ void __launch_bounds__(kAdjThreads, 3)
adj_kernel(const float* __restrict__ g, const float* __restrict__ scalars,
           float* __restrict__ vol, int V, int nx, int ny, int nz, int nu,
           int nv, bool vec) {
  extern __shared__ __align__(16) float sm[];
  adj_gather<AdjF32>(sm, g, scalars, vol, V, nx, ny, nz, nu, nv, vec);
}

// K2b: g (V, nu, nv) in bf16; vec: nv a multiple of 8 and g 16-byte
// aligned. An entry T[x, v] sums hat(X(u, v) - x) * scale * g[u, v] over
// cu consecutive u from its window's start and is rounded to bf16 once,
// where the plain version rounds the pass-B cotangent; a voxel sums
// hat(zeta(x, v) - z) * T[x, v] over cv consecutive v.
__global__ void __launch_bounds__(kAdjThreads, 4)
adj_bf16_kernel(const __nv_bfloat16* __restrict__ g,
                const float* __restrict__ scalars, float* __restrict__ vol,
                int V, int nx, int ny, int nz, int nu, int nv, bool vec) {
  extern __shared__ __align__(16) float sm[];
  adj_gather<AdjBf16>(sm, g, scalars, vol, V, nx, ny, nz, nu, nv, vec);
}

// Launch a forward kernel (K1 or K1b) over the views: grid (v tiles, u
// tiles, views), at most 65535 views a launch.
template <typename T>
int launch_views(void (*kernel)(const T*, const float*, float*, int, int,
                                int, int, int),
                 int smem, const T* vol, const float* scalars, float* out,
                 int V, int nx, int ny, int nz, int nu, int nv,
                 void* stream) {
  if (V <= 0 || nu <= 0 || nv <= 0) return 0;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tv = (nv + kFV - 1) / kFV, tu = (nu + kFU - 1) / kFU;
  for (int v0 = 0; v0 < V; v0 += 65535) {
    const dim3 grid(tv, tu, V - v0 < 65535 ? V - v0 : 65535);
    kernel<<<grid, kFwdThreads, smem, s>>>(
        vol, scalars + static_cast<size_t>(v0) * NS,
        out + static_cast<size_t>(v0) * nu * nv, nx, ny, nz, nu, nv);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// Launch K1: 16-byte staging where nz is a multiple of 4 and vol aligned.
int launch_fwd(const float* vol, const float* scalars, float* out, int V,
               int nx, int ny, int nz, int nu, int nv, void* stream) {
  const bool vec =
      nz % 4 == 0 && reinterpret_cast<std::uintptr_t>(vol) % 16 == 0;
  return launch_views(vec ? fwd_kernel<true> : fwd_kernel<false>, kFwdSmem,
                      vol, scalars, out, V, nx, ny, nz, nu, nv, stream);
}

// Launch K1b: 16-byte staging where nz is a multiple of 8 and vol aligned.
int launch_fwd_bf16(const __nv_bfloat16* vol, const float* scalars,
                    float* out, int V, int nx, int ny, int nz, int nu,
                    int nv, void* stream) {
  const bool vec =
      nz % 8 == 0 && reinterpret_cast<std::uintptr_t>(vol) % 16 == 0;
  return launch_views(vec ? fwd_bf16_kernel<true> : fwd_bf16_kernel<false>,
                      kFwdHSmem, vol, scalars, out, V, nx, ny, nz, nu, nv,
                      stream);
}

// Launch K2.
int launch_adj(const float* g, const float* scalars, float* vol, int V,
               int nx, int ny, int nz, int nu, int nv, void* stream) {
  if (static_cast<long long>(nx) * ny * nz <= 0) return 0;
  if (ny > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t e = cudaFuncSetAttribute(
      adj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAdjSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec =
      nv % 4 == 0 && reinterpret_cast<std::uintptr_t>(g) % 16 == 0;
  const dim3 grid((nz + kTZ - 1) / kTZ, (nx + kTX - 1) / kTX, ny);
  adj_kernel<<<grid, kAdjThreads, kAdjSmem,
               static_cast<cudaStream_t>(stream)>>>(g, scalars, vol, V, nx,
                                                    ny, nz, nu, nv, vec);
  return static_cast<int>(cudaGetLastError());
}

// Launch K2b.
int launch_adj_bf16(const __nv_bfloat16* g, const float* scalars, float* vol,
                    int V, int nx, int ny, int nz, int nu, int nv,
                    void* stream) {
  if (static_cast<long long>(nx) * ny * nz <= 0) return 0;
  if (ny > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t e = cudaFuncSetAttribute(
      adj_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec =
      nv % 8 == 0 && reinterpret_cast<std::uintptr_t>(g) % 16 == 0;
  const dim3 grid((nz + kTZ - 1) / kTZ, (nx + kTX - 1) / kTX, ny);
  adj_bf16_kernel<<<grid, kAdjThreads, kBSmem,
                    static_cast<cudaStream_t>(stream)>>>(
      g, scalars, vol, V, nx, ny, nz, nu, nv, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int slab_plane_fwd(const float* vol, const float* scalars, float* out, int V,
                   int nx, int ny, int nz, int nu, int nv, void* stream) {
  return launch_fwd(vol, scalars, out, V, nx, ny, nz, nu, nv, stream);
}

int slab_plane_adj(const float* g, const float* scalars, float* vol, int V,
                   int nx, int ny, int nz, int nu, int nv, void* stream) {
  return launch_adj(g, scalars, vol, V, nx, ny, nz, nu, nv, stream);
}

// K1b: vol is the oriented volume in bf16.
int slab_plane_fwd_bf16(const void* vol, const float* scalars, float* out,
                        int V, int nx, int ny, int nz, int nu, int nv,
                        void* stream) {
  return launch_fwd_bf16(static_cast<const __nv_bfloat16*>(vol), scalars,
                         out, V, nx, ny, nz, nu, nv, stream);
}

// K2b: g is the cotangent in bf16.
int slab_plane_adj_bf16(const void* g, const float* scalars, float* vol,
                        int V, int nx, int ny, int nz, int nu, int nv,
                        void* stream) {
  return launch_adj_bf16(static_cast<const __nv_bfloat16*>(g), scalars, vol,
                         V, nx, ny, nz, nu, nv, stream);
}

}  // extern "C"
