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
// K3 and K5 are one march, templated on the Jacobian
// (arc_march_kernel<kJac>), and use the same separability forward: ζ
// depends on (x, v, r, b) and never on u. A CTA owns one view and a
// kFU x kFV tile of detector (u, v) and marches the source slabs
// r = -1 .. ny-1, owner-computes: each output is accumulated in registers
// in the order of a one-thread-per-ray march (r, then b, then the two
// x-taps) and written once, with no atomics and no scratch. Per slab:
//   1. windows: from the tile's corners (X and ζ are affine plus a
//      sawtooth bounded by the branch count) the x and z windows that the
//      tile's taps can reach; and per branch b an interval test on the
//      corners' march indices, which skips b for the whole tile only where
//      no sample of it can pass the mask (j out of range or fy >= 1
//      everywhere). Computed by 128 threads for a chunk of 64 steps at a
//      time, into shared memory;
//   2. staging: rows r and r + 1 of the window in a ring of three slabs in
//      shared memory, filled by cp.async (16-byte copies where nz is a
//      multiple of 4) one slab ahead; slab r + 1 of one step is slab r of
//      the next (its window is the union of both steps'), so each row is
//      loaded once per CTA;
//   3. pass A, once per (x, v) of the window: grid_at (its one division),
//      then for branches 0 and 1 the z-lerps of both sides (and for K5
//      their derivatives) into shared tables; branch 1 reuses branch 0's
//      taps where its floor is the same (|edz| is small);
//   4. pass B, per owned (u, v): one march index for all branches, then
//      per live branch sample_from's mask and X, and both x-taps read from
//      the tables.
// A step whose window exceeds the tables or the ring, or a march with a
// third branch (steps below 1/sqrt(2)), runs pass B the direct way (grid_at
// and taps_of on global memory per sample). The windows decide which taps
// the tables hold, so they are wide enough for every tap in the volume,
// whatever the rounding (tests/test_torch_arc_forward_split.py emulates
// the windows, the skips and the tables); the mask, the taps and their
// values are those of sample_at, grid_at, zeta_at and taps_of, so K3
// holds exactly K4's matrix entries. The march's divisions by edy take
// the correctly rounded reciprocal and one fma correction (jreal_of<true>),
// which gives __fdiv_rn's bits. What bounds the march on an H100: issuing
// the position arithmetic of pass A and B (the exact-rounding sequence
// per point and pixel per slab), not bytes.
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
//
// The bf16 tier (K3b slab_arc_fwd_bf16, K4b slab_arc_adj_bf16) replaces the
// bf16=True variants of _fwd_kernel and _adj_kernel in arc quadrature
// (chosen at tomojax/kernels/slab.py:904 and :1015), with K3's and K4's
// samples to the bit and rounding (nearest even) at each pass's input:
//   K3b (arc_fwd_bf16_kernel, a design of its own) stages the volume's rows
//     in bf16 (the wrapper casts the oriented volume once) and keeps K3's
//     windows, step order (two barriers a step: pass A beside the previous
//     step's pass B measured slower), grid and pass-A taps; each branch's
//     z-lerps h0, h1 of both sides are rounded into one pair word before
//     the (1 - fy)/fy blend reads them (the direct path rounds the same
//     values). Its tables carry a zero column before T's window and two
//     after it, so pass B clamps X into the window and reads both taps
//     without a test (a tap outside the window lies outside the volume);
//     one march index per pixel (jreal_of<true>, its ceil by adds) serves
//     every branch, and floor(X) folds into the table address. What bounds
//     it: the issue rate of pass A's exact grid and z-lerps, and of pass
//     B's samples, as K3;
//   K4b (arc_adj_bf16_kernel, a design of its own) reads the cotangent g in
//     bf16 (the wrapper casts it once) and rounds the two planes of each
//     view's and branch's pass-B transpose once, one per target side:
//     T_all - T_fy (slab r) and T_fy (slab r + 1); the sums, the scratch
//     volume and the add stay fp32.
// tomojax rounds its matmul operands (the products w*g and the aligned
// accumulator); a gather has none, so the rounding points are g and the
// tables, within tomojax's contract for the tier (3e-3 relative per apply,
// 5e-3 A/A^T mismatch: scripts/tpu_kernel_check.py). K5 has no bf16 tier,
// as in tomojax. 16-byte copies carry 8 bf16 values (nz a multiple of 8);
// other sizes stage with plain loads. kernels/slab.py's plain bf16
// versions round at the same points.
//
// K4b stages no samples. Per source slab, tile and view it computes, per
// entry (x, v) of the tile's columns and the view's v window, the grid
// sawtooth and zeta's affine part once for all branches, and pass B as a
// gather: over a fixed count of consecutive u from the window of the
// union of the branches, one march index per (u, v) (jreal_of<true>:
// __fdiv_rn's bits without a division) gives every branch's sample with
// K3b's decisions, weighted by hat(X - x) = max(0, 1 - |X - x|), the lerp
// weight of tap x (zero outside the window: no thread branches on a tap).
// Pass A is the same gather over v per voxel, for both sides. What bounds
// it: the issue rate of the samples' exact-rounding arithmetic per
// candidate, as in K3.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// Values of a staged type per 16-byte copy.
template <typename TS>
__host__ __device__ constexpr int per16() {
  return 16 / static_cast<int>(sizeof(TS));
}

// Jacobian building blocks, tomojax_torch/core/slab_projector.JAC_PASSES.
constexpr int NJP = 12;

struct Arc {
  float edy, edx, edz, rx, rz, eux, evx, evz, cxb, czb, gzx, b1, euy, evy,
      inv_eux, inv_edy;
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
  p.inv_edy = __frcp_rn(p.edy);
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

// A detector row's products with the view's v-axis scalars: v*evx,
// v*evy and v*evz, shared by every position of the row.
struct VTerms {
  float x, y, z;
};

__device__ __forceinline__ VTerms v_terms(const Arc& p, float v) {
  return {mul(v, p.evx), mul(v, p.evy), mul(v, p.evz)};
}

// The ray's start y0 = (b1 + u*euy) + v*evy, and the march index
// (r - y0)/edy.
__device__ __forceinline__ float y0_at(const Arc& p, float u,
                                       const VTerms& vt) {
  return add(add(p.b1, mul(u, p.euy)), vt.y);
}

// kRcp (the march): the same correctly rounded quotient without a
// division: q = RN(a/edy) faithful from the correctly rounded reciprocal,
// the remainder a - q*edy exact by fma, and one correction by the
// reciprocal, which rounds to RN(a/edy) for quotients in the normal range
// (Markstein's theorem; tests/test_torch_cuda.py holds it to __fdiv_rn).
template <bool kRcp = false>
__device__ __forceinline__ float jreal_of(const Arc& p, float r, float y0) {
  const float a = sub(r, y0);
  if (!kRcp) return __fdiv_rn(a, p.edy);
  const float q = mul(a, p.inv_edy);
  return __fmaf_rn(__fmaf_rn(-q, p.edy, a), p.inv_edy, q);
}

// X's affine part (cx + u*eux) + v*evx (ue = u*eux), shared by a
// sample's branches.
__device__ __forceinline__ float x_affine(float cx, float ue,
                                          const VTerms& vt) {
  return add(add(cx, ue), vt.x);
}

// Branch b's sample from the march index and X's affine part.
__device__ __forceinline__ Sample sample_from(const Arc& p, float jreal,
                                              float xa, int b, int n_steps) {
  Sample s;
  s.j = ceilf(jreal) + static_cast<float>(b);
  s.cfb = sub(s.j, jreal);
  s.fy = mul(p.edy, s.cfb);
  s.ok = s.j >= 0.0f && s.j < static_cast<float>(n_steps) && s.fy < 1.0f;
  s.X = add(xa, mul(p.edx, s.cfb));
  return s;
}

__device__ __forceinline__ Sample sample_at(const Arc& p, float r, float cx,
                                            float u, float v, int b,
                                            int n_steps) {
  const VTerms vt = v_terms(p, v);
  return sample_from(p, jreal_of(p, r, y0_at(p, u, vt)),
                     x_affine(cx, mul(u, p.eux), vt), b, n_steps);
}

// Pass A at grid column x of row v: the grid sawtooth cf in [0, 1) and
// ζ's affine part zaff; ζ of branch b is zeta_at(p, cf + b, zaff).
template <bool kRcp = false>
__device__ __forceinline__ void grid_at(const Arc& p, float r, float cx,
                                        float cz, float x, const VTerms& vt,
                                        float* cf, float* zaff) {
  const float d = sub(sub(x, cx), vt.x);
  const float jr = jreal_of<kRcp>(p, r, y0_at(p, mul(d, p.inv_eux), vt));
  *cf = sub(ceilf(jr), jr);
  *zaff = add(add(cz, mul(p.gzx, d)), vt.z);
}

__device__ __forceinline__ float zeta_at(const Arc& p, float cfg,
                                         float zaff) {
  return add(zaff, mul(p.edz, cfg));
}

// The two taps of `pos` in a row of n values: lerp (h) and d/dpos (d).
// fetch(k) reads value k of the row (0 <= k < n).
template <typename Fetch>
__device__ __forceinline__ void taps_of(Fetch fetch, float pos, int n,
                                        float* h, float* d) {
  const float f = floorf(pos);
  const int k = static_cast<int>(f);
  const float w = pos - f;
  const float a = (k >= 0 && k < n) ? fetch(k) : 0.0f;
  const float c = (k + 1 >= 0 && k + 1 < n) ? fetch(k + 1) : 0.0f;
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

// K3/K5 tiling. A CTA owns one view and a kFU x kFV tile of detector (u, v):
// lane = v, and each thread owns kPix pixels u of its v (warp, warp + 8,
// ...). Shared memory: a ring of kRing staged slabs (kSX x kSZ values of
// rows x, z each); the pass-A tables of kQX columns x by kFV rows v: per
// branch b < 2 a vector of the z-lerps of sides r and r + 1 (h0, h1; for
// K5 (h0, h1, d0, d1) with their derivatives), and for K5 the grid
// sawtooth cf; and the windows of a chunk of kChunk steps.
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFU = 32, kFV = 32;
constexpr int kPix = kFU / kFwdWarps;
constexpr int kSX = 52;
constexpr int kQX = 52;
constexpr int kTab = kQX * kFV;        // entries of one table
constexpr int kRing = 3;
constexpr int kChunk = 64;             // steps per chunk of windows
constexpr int kTabBranches = 2;        // branches the tables serve

// floats per table vector, and per table entry (x, v): a vector per branch
// and K5's cf
template <bool kJac>
__host__ __device__ constexpr int tab_vec() {
  return kJac ? 4 : 2;
}

template <bool kJac>
__host__ __device__ constexpr int tab_width() {
  return tab_vec<kJac>() * kTabBranches + (kJac ? 1 : 0);
}

// The staged slabs of storage type TS: rows of kSZ values z, a multiple of
// per16<TS>() (16-byte rows); bf16's 48 keeps fp32's capacity once z0 is
// aligned down to a copy (44 - 3 = 48 - 7). A thread's share of a slab's
// copies: its copy i moves 16-byte chunk c of window row xl (e = tid +
// i*kFwdThreads over kSX rows of kRowChunks chunks), packed as xl << 8 |
// c; fixed over the march.
template <typename TS>
struct ArcStage {
  static constexpr int kSZ = sizeof(TS) == 4 ? 44 : 48;
  static constexpr int kRowChunks = kSZ / per16<TS>();
  static constexpr int kSlots =
      (kSX * kRowChunks + kFwdThreads - 1) / kFwdThreads;
  static_assert(kSZ % per16<TS>() == 0, "staged rows of 16-byte copies");
};

// K3/K5: the ring and the tables (fp32), then the windows.
template <bool kJac>
constexpr int fwd_smem() {
  return 4 * (kRing * kSX * ArcStage<float>::kSZ + tab_width<kJac>() * kTab) +
         kChunk * (2 * sizeof(short4) + sizeof(unsigned));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A window of oriented voxels: x in [x0, x1], z in [z0, z1]; empty when
// x0 > x1. Stored as a short4 (x0, x1, z0, z1): the wrapper keeps nx and
// nz below 2^15.
__device__ __forceinline__ short4 empty_win() {
  return make_short4(0, -1, 0, -1);
}

__device__ __forceinline__ bool holds(short4 outer, short4 w) {
  return outer.x <= w.x && w.y <= outer.y && outer.z <= w.z &&
         w.w <= outer.w;
}

// The tile's spread of the positions about their slab offsets, over its
// corners (every term is affine in u and v) and the sawtooth (cfb and
// cf + b in [0, n_branch]); y0's range gives the march index's.
struct FwdTile {
  float xlo, xhi;   // X - cx_r
  float zlo, zhi;   // ζ - (cz_r + gzx*(x - cx_r))
  float ylo, yhi;   // y0 = b1 + u*euy + v*evy
};

__device__ __forceinline__ void span(float a, float b, float* lo,
                                     float* hi) {
  *lo += fminf(a, b);
  *hi += fmaxf(a, b);
}

__device__ __forceinline__ FwdTile fwd_tile(const Arc& p, float ua, float ub,
                                            float va, float vb,
                                            int n_branch) {
  const float nb = static_cast<float>(n_branch);
  const float zav = p.evz - p.gzx * p.evx;
  FwdTile t{0.0f, 0.0f, 0.0f, 0.0f, p.b1, p.b1};
  span(ua * p.eux, ub * p.eux, &t.xlo, &t.xhi);
  span(va * p.evx, vb * p.evx, &t.xlo, &t.xhi);
  span(0.0f, p.edx * nb, &t.xlo, &t.xhi);
  span(va * zav, vb * zav, &t.zlo, &t.zhi);
  span(0.0f, p.edz * nb, &t.zlo, &t.zhi);
  span(ua * p.euy, ub * p.euy, &t.ylo, &t.yhi);
  span(va * p.evy, vb * p.evy, &t.ylo, &t.yhi);
  return t;
}

// The taps floor(q), floor(q) + 1 of every position q in [lo, hi], the
// bounds widened by a slack far above the positions' rounding (a few ulps
// of values below ~10^3, computed in another order than the kernels'
// positions).
__device__ __forceinline__ float tap_lo(float lo) {
  return floorf(lo - (1e-3f + 1e-5f * fabsf(lo)));
}

__device__ __forceinline__ float tap_hi(float hi) {
  return floorf(hi + (1e-3f + 1e-5f * fabsf(hi))) + 1.0f;
}

// Step r's window: the x-taps of the tile's samples and the z-taps of ζ
// over those columns, clamped to the volume; empty for a step outside
// [-1, ny).
__device__ __forceinline__ short4 step_window(const Arc& p, const FwdTile& t,
                                              int ri, int nx, int ny,
                                              int nz) {
  if (ri < -1 || ri >= ny) return empty_win();
  const float r = static_cast<float>(ri);
  const float cx = fmaf(p.rx, r, p.cxb), cz = fmaf(p.rz, r, p.czb);
  const float xl = tap_lo(cx + t.xlo), xh = tap_hi(cx + t.xhi);
  if (xh < 0.0f || xl > static_cast<float>(nx - 1)) return empty_win();
  const int x0 = max(0, static_cast<int>(xl));
  const int x1 = min(nx - 1, static_cast<int>(xh));
  const float ga = p.gzx * (static_cast<float>(x0) - cx);
  const float gb = p.gzx * (static_cast<float>(x1) - cx);
  const float zl = tap_lo(cz + fminf(ga, gb) + t.zlo);
  const float zh = tap_hi(cz + fmaxf(ga, gb) + t.zhi);
  if (zh < 0.0f || zl > static_cast<float>(nz - 1)) return empty_win();
  return make_short4(x0, x1, max(0, static_cast<int>(zl)),
                     min(nz - 1, static_cast<int>(zh)));
}

// The staged window of slab s: the union of the windows of steps s - 1 and
// s (the two that read it), z aligned down to a multiple of per16<TS>()
// for 16-byte copies, clamped to the ring's capacity; empty for a slab
// outside [0, ny).
template <typename TS>
__device__ __forceinline__ short4 stage_window(const Arc& p,
                                               const FwdTile& t, int s,
                                               int nx, int ny, int nz,
                                               bool vec) {
  if (s < 0 || s >= ny) return empty_win();
  const short4 a = step_window(p, t, s - 1, nx, ny, nz);
  const short4 b = step_window(p, t, s, nx, ny, nz);
  short4 w = a;
  if (a.x > a.y) {
    w = b;
  } else if (b.x <= b.y) {
    w = make_short4(min(a.x, b.x), max(a.y, b.y), min(a.z, b.z),
                    max(a.w, b.w));
  }
  if (w.x > w.y) return w;
  if (vec) w.z &= ~(per16<TS>() - 1);
  w.y = min(static_cast<int>(w.y), w.x + kSX - 1);
  w.w = min(static_cast<int>(w.w), w.z + ArcStage<TS>::kSZ - 1);
  return w;
}

template <typename TS>
__device__ __forceinline__ int copy_slot(int tid, int i) {
  constexpr int kRowChunks = ArcStage<TS>::kRowChunks;
  const int e = tid + i * kFwdThreads;
  return e < kSX * kRowChunks ? (e / kRowChunks) << 8 | e % kRowChunks
                              : 0xFFFF << 8;
}

// Issue the copies of slab s's window into buf (one commit group); bf16
// without vec stages with plain loads and stores (cp.async has no 2-byte
// copy), which the next barrier makes visible as it does the copies.
template <typename TS>
__device__ __forceinline__ void stage_slab(
    TS* buf, const TS* __restrict__ vol, int s, short4 w, int ny, int nz,
    bool vec, int tid, const int (&slot)[ArcStage<TS>::kSlots]) {
  constexpr int kSZ = ArcStage<TS>::kSZ, kPer = per16<TS>();
  if (w.x <= w.y) {
    const int nxw = w.y - w.x + 1;
    const TS* src = vol + (static_cast<size_t>(w.x) * ny + s) * nz + w.z;
    const size_t pitch = static_cast<size_t>(ny) * nz;
    if (vec) {
      const int nch = (w.w - w.z + kPer) / kPer;
#pragma unroll
      for (int i = 0; i < ArcStage<TS>::kSlots; ++i) {
        const int xl = slot[i] >> 8, c = slot[i] & 255;
        if (xl < nxw && c < nch)
          cp_async16(buf + xl * kSZ + kPer * c, src + xl * pitch + kPer * c);
      }
    } else {
      const int nzw = w.w - w.z + 1;
      for (int e = tid; e < nxw * kSZ; e += kFwdThreads) {
        const int xl = e / kSZ, zl = e - xl * kSZ;
        if (zl >= nzw) continue;
        if constexpr (sizeof(TS) == 4)
          cp_async4(buf + xl * kSZ + zl, src + xl * pitch + zl);
        else
          buf[xl * kSZ + zl] = src[xl * pitch + zl];
      }
    }
  }
  cp_async_commit();
}

// Branch b can hold a valid sample somewhere in a tile whose march indices
// lie in [jlo, jhi]: some j = ceil(jreal) + b in [0, n_steps), and fy =
// edy*(cf + b) < 1 for the least cf the interval allows (cf >= 0; where
// the interval holds no integer step, ceil is constant over it and cf >=
// ceil(jhi) - jhi). The margin 1e-4 on fy is far above its rounding.
__device__ __forceinline__ bool branch_live(float jlo, float jhi, int b,
                                            float edy, int n_steps) {
  const float clo = ceilf(jlo), chi = ceilf(jhi);
  const float fb = static_cast<float>(b);
  if (chi + fb < 0.0f || clo + fb >= static_cast<float>(n_steps))
    return false;
  const float cf_min = clo == chi ? chi - jhi : 0.0f;
  return edy * (fb + cf_min) < 1.0001f;
}

// Step r's live branches (bit b): none where its window is empty.
__device__ __forceinline__ unsigned live_branches(const Arc& p,
                                                  const FwdTile& t, int ri,
                                                  short4 w, int n_branch,
                                                  int n_steps) {
  if (w.x > w.y) return 0u;
  const float r = static_cast<float>(ri);
  const float jlo = __fdividef(r - t.yhi, p.edy);
  const float jhi = __fdividef(r - t.ylo, p.edy);
  const float m = 1e-3f + 1e-5f * fmaxf(fabsf(jlo), fabsf(jhi));
  unsigned live = 0;
  for (int b = 0; b < n_branch; ++b)
    if (branch_live(jlo - m, jhi + m, b, p.edy, n_steps)) live |= 1u << b;
  return live;
}

// The z-lerps h of sides r (0) and r + 1 (1) at (x, v) and their
// derivatives d; a side outside the volume (slab -1 or ny) is zero.
struct Lerps {
  float h0, h1, d0, d1;
};

// A sample's x-tap: its z-lerps, branch sawtooth cf + b, and whether it
// lies in the volume.
struct Tap {
  Lerps l;
  float cfg;
  bool in;
};

// Add sample s's two x-taps into a pixel's accumulators a, in K3's (and
// K5's) order.
template <bool kJac>
__device__ __forceinline__ void accumulate(float (&a)[kJac ? NJP : 1],
                                           const Sample& s, float r,
                                           float wx, const Tap (&t)[2]) {
  const float mom = wx * (1.0f - wx);
  float a_val = 0.0f, a_px = 0.0f, a_py = 0.0f, a_pz = 0.0f, a_zm = 0.0f,
        a_zc = 0.0f;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    if (!t[o].in) continue;
    const Lerps& l = t[o].l;
    const float w_h = o ? wx : 1.0f - wx;   // hat
    const float lerp_h = (1.0f - s.fy) * l.h0 + s.fy * l.h1;
    a_val += w_h * lerp_h;
    if (kJac) {
      const float w_d = o ? 1.0f : -1.0f;   // hat'
      const float w_m = o ? mom : -mom;     // (tap - X) moment
      const float lerp_d = (1.0f - s.fy) * l.d0 + s.fy * l.d1;
      a_px += w_d * lerp_h;
      a_py += w_h * (l.h1 - l.h0);
      a_pz += w_h * lerp_d;
      a_zm += w_m * lerp_d;
      a_zc += w_h * (lerp_d * t[o].cfg);
    }
  }
  a[0] += a_val;
  if (kJac) {
    constexpr int kF = kJac ? NJP : 1;
    a[1 % kF] += a_px;
    a[2 % kF] += a_py;
    a[3 % kF] += a_pz;
    a[4 % kF] += s.j * a_px;
    a[5 % kF] += s.j * a_py;
    a[6 % kF] += s.j * a_pz;
    a[7 % kF] += r * a_px;
    a[8 % kF] += r * a_py;
    a[9 % kF] += r * a_pz;
    a[10 % kF] += a_zm;
    a[11 % kF] += a_zc;
  }
}

// K3 (kJac false): out (V, nu, nv). K5 (kJac true): out (V, NJP, nu, nv),
// the 12 building blocks in JAC_PASSES order (val, px, py, pz, jx, jy, jz,
// rx, ry, rz, zm, zc). grid (v tiles, u tiles, views); vol (nx, ny, nz),
// scalars (V, NS). Every output is written exactly once.
//
// A step is fast when its tables cover its window, the staged windows hold
// it and the march has at most two branches: pass A fills the tables from
// the staged rows, and pass B reads every tap from the tables (a tap in the
// volume lies in the window: the emulation test checks the windows). Any
// other step (a window beyond the capacities, a march step below 1/sqrt(2))
// runs pass B the direct way, grid_at and taps_of on global memory per
// sample, as a one-thread-per-ray march does.
template <bool kJac>
__global__ void __launch_bounds__(kFwdThreads, kJac ? 2 : 4)
arc_march_kernel(const float* __restrict__ vol,
                 const float* __restrict__ scalars, float* __restrict__ out,
                 int nx, int ny, int nz, int nu, int nv, int n_steps,
                 int n_branch, bool vec) {
  constexpr int kF = kJac ? NJP : 1;
  constexpr int kVec = tab_vec<kJac>();
  constexpr int kSZ = ArcStage<float>::kSZ;
  constexpr int kSlots = ArcStage<float>::kSlots;
  extern __shared__ __align__(16) float sm[];
  float* const ring = sm;
  float* const tab = ring + kRing * kSX * kSZ;   // [branch][xl][v] vectors
  float* const tab_cf = tab + kVec * kTabBranches * kTab;   // K5: [xl][v]
  short4* const c_step =
      reinterpret_cast<short4*>(tab + tab_width<kJac>() * kTab);
  short4* const c_stage = c_step + kChunk;
  unsigned* const c_live = reinterpret_cast<unsigned*>(c_stage + kChunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int view = blockIdx.z;
  const int v0 = blockIdx.x * kFV, u0 = blockIdx.y * kFU;
  const Arc p = load_arc(scalars + static_cast<size_t>(view) * NS);
  const int v = v0 + lane;
  const bool v_in = v < nv;
  const VTerms vt = v_terms(p, static_cast<float>(v));
  const FwdTile tile = fwd_tile(
      p, static_cast<float>(u0), static_cast<float>(min(u0 + kFU, nu) - 1),
      static_cast<float>(v0), static_cast<float>(min(v0 + kFV, nv) - 1),
      n_branch);
  auto slab_at = [&](int s) { return ((s + 1) % kRing) * kSX * kSZ; };

  // the owned pixels' y0 and u*eux, fixed over the march
  float y0[kPix], ue[kPix];
  float acc[kPix][kF];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const float fu = static_cast<float>(u0 + warp + kFwdWarps * k);
    y0[k] = y0_at(p, fu, vt);
    ue[k] = mul(fu, p.eux);
#pragma unroll
    for (int f = 0; f < kF; ++f) acc[k][f] = 0.0f;
  }

  int slot[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) slot[i] = copy_slot<float>(tid, i);

  // staged windows of slabs r and r + 1 (slab 0 staged before step -1)
  short4 st_r = empty_win();
  short4 st_r1 = stage_window<float>(p, tile, 0, nx, ny, nz, vec);
  stage_slab(ring + slab_at(0), vol, 0, st_r1, ny, nz, vec, tid, slot);

  for (int ri = -1; ri < ny; ++ri) {
    cp_async_wait_all();   // slab r + 1
    __syncthreads();       // ... visible; step r - 1 done with the ring
    const int ci = (ri + 1) % kChunk;
    if (ci == 0) {
      // windows of steps r .. r + kChunk - 1, stages of slabs r + 2 ..
      if (tid < kChunk) {
        // the step's live branches, and bit 31: it is fast (its tables
        // cover its window, and the staged windows of both its slabs
        // hold it)
        const int rs = ri + tid;
        const short4 w = step_window(p, tile, rs, nx, ny, nz);
        const bool fast =
            w.y - w.x < kQX && n_branch <= kTabBranches &&
            (rs < 0 ||
             holds(stage_window<float>(p, tile, rs, nx, ny, nz, vec), w)) &&
            (rs + 1 >= ny ||
             holds(stage_window<float>(p, tile, rs + 1, nx, ny, nz, vec), w));
        const unsigned lb =
            live_branches(p, tile, rs, w, n_branch, n_steps);
        c_step[tid] = w;
        c_live[tid] = lb && fast ? lb | 1u << 31 : lb;
      } else if (tid < 2 * kChunk) {
        c_stage[tid - kChunk] =
            stage_window<float>(p, tile, ri + tid - kChunk + 2, nx, ny, nz,
                                vec);
      }
      __syncthreads();
    }
    const short4 st_r2 = c_stage[ci];
    stage_slab(ring + slab_at(ri + 2), vol, ri + 2, st_r2, ny, nz, vec, tid,
               slot);

    const short4 w_r = c_step[ci];
    const unsigned live = c_live[ci];
    if (live) {
      const float r = static_cast<float>(ri);
      const float cx = slab_cx(p, r), cz = slab_cz(p, r);
      const int qx0 = w_r.x, nq = w_r.y - w_r.x + 1;
      const bool side0 = ri >= 0, side1 = ri + 1 < ny;
      if (live >> 31) {
        // pass A, once per (x, v) of the window: staged row (x, z) of the
        // side slabs at ring[base + x*kSZ + z]
        const int base0 = slab_at(ri) - st_r.x * kSZ - st_r.z;
        const int base1 = slab_at(ri + 1) - st_r1.x * kSZ - st_r1.z;
        const unsigned unz = static_cast<unsigned>(nz);
        if (v_in) {
          for (int xl = warp; xl < nq; xl += kFwdWarps) {
            const int x = qx0 + xl, e = xl * kFV + lane;
            float cf, zaff;
            grid_at<true>(p, r, cx, cz, static_cast<float>(x), vt, &cf,
                          &zaff);
            if (kJac) tab_cf[e] = cf;
            const float* row0 = ring + base0 + x * kSZ;
            const float* row1 = ring + base1 + x * kSZ;
            float a0 = 0.0f, c0 = 0.0f, a1 = 0.0f, c1 = 0.0f;
            int k_prev = 0;
#pragma unroll
            for (int b = 0; b < kTabBranches; ++b) {
              if (!(live >> b & 1u)) continue;
              // branch 0's cf + 0 is cf (cf is never -0)
              const float zeta =
                  zeta_at(p, b ? add(cf, static_cast<float>(b)) : cf, zaff);
              const float f = floorf(zeta);
              const int k = static_cast<int>(f);
              const float w = zeta - f;
              // branch 1 reuses branch 0's taps where its floor is the
              // same (|edz| is small)
              if (b == 0 || !(live & 1u) || k != k_prev) {
                const bool ia = static_cast<unsigned>(k) < unz;
                const bool ic = static_cast<unsigned>(k) + 1u < unz;
                a0 = side0 && ia ? row0[k] : 0.0f;
                c0 = side0 && ic ? row0[k + 1] : 0.0f;
                a1 = side1 && ia ? row1[k] : 0.0f;
                c1 = side1 && ic ? row1[k + 1] : 0.0f;
                k_prev = k;
              }
              float* t = tab + (b * kTab + e) * kVec;
              const float h0 = (1.0f - w) * a0 + w * c0;
              const float h1 = (1.0f - w) * a1 + w * c1;
              if constexpr (kJac) {
                *reinterpret_cast<float4*>(t) =
                    make_float4(h0, h1, c0 - a0, c1 - a1);
              } else {
                *reinterpret_cast<float2*>(t) = make_float2(h0, h1);
              }
            }
          }
        }
        __syncthreads();
        // pass B, per owned (u, v): both taps from the tables (a tap
        // outside the table window lies outside the volume)
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const int u = u0 + warp + kFwdWarps * k;
          if (!v_in || u >= nu) continue;
          const float jreal = jreal_of<true>(p, r, y0[k]);
          const float xa = x_affine(cx, ue[k], vt);
#pragma unroll
          for (int b = 0; b < kTabBranches; ++b) {
            if (!(live >> b & 1u)) continue;
            const Sample s = sample_from(p, jreal, xa, b, n_steps);
            if (!s.ok) continue;
            const float xf = floorf(s.X);
            const int xl = static_cast<int>(xf) - qx0;
            Tap t[2];
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              t[o].in = static_cast<unsigned>(xl + o) <
                        static_cast<unsigned>(nq);
              const int e = t[o].in ? (xl + o) * kFV + lane : lane;
              const float* q = tab + (b * kTab + e) * kVec;
              if constexpr (kJac) {
                const float4 h = *reinterpret_cast<const float4*>(q);
                t[o].l = {h.x, h.y, h.z, h.w};
                // branch 0's cf + 0 is cf
                t[o].cfg = b ? add(tab_cf[e], static_cast<float>(b))
                             : tab_cf[e];
              } else {
                const float2 h = *reinterpret_cast<const float2*>(q);
                t[o].l = {h.x, h.y, 0.0f, 0.0f};
                t[o].cfg = 0.0f;
              }
            }
            accumulate<kJac>(acc[k], s, r, s.X - xf, t);
          }
        }
      } else {
        // the direct way, per sample
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const int u = u0 + warp + kFwdWarps * k;
          if (!v_in || u >= nu) continue;
          const float jreal = jreal_of<true>(p, r, y0[k]);
          const float xa = x_affine(cx, ue[k], vt);
          for (int b = 0; b < n_branch; ++b) {
            if (!(live >> b & 1u)) continue;
            const Sample s = sample_from(p, jreal, xa, b, n_steps);
            if (!s.ok) continue;
            const float xf = floorf(s.X);
            const int x0 = static_cast<int>(xf);
            Tap t[2];
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              const int xi = x0 + o;
              t[o].in = xi >= 0 && xi < nx;
              t[o].l = {0.0f, 0.0f, 0.0f, 0.0f};
              t[o].cfg = 0.0f;
              if (!t[o].in) continue;
              float cf, zaff;
              grid_at<true>(p, r, cx, cz, static_cast<float>(xi), vt, &cf,
                            &zaff);
              t[o].cfg = add(cf, static_cast<float>(b));
              const float zeta = zeta_at(p, t[o].cfg, zaff);
              const float* col = vol + static_cast<size_t>(xi) * ny * nz;
              if (side0)
                taps_of([&](int kz) { return __ldg(col + ri * nz + kz); },
                        zeta, nz, &t[o].l.h0, &t[o].l.d0);
              if (side1)
                taps_of([&](int kz) { return __ldg(col + (ri + 1) * nz + kz); },
                        zeta, nz, &t[o].l.h1, &t[o].l.d1);
            }
            accumulate<kJac>(acc[k], s, r, s.X - xf, t);
          }
        }
      }
    }
    st_r = st_r1;
    st_r1 = st_r2;
  }

  const size_t plane = static_cast<size_t>(nu) * nv;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int u = u0 + warp + kFwdWarps * k;
    if (!v_in || u >= nu) continue;
    float* o = out + static_cast<size_t>(view) * kF * plane +
               static_cast<size_t>(u) * nv + v;
#pragma unroll
    for (int f = 0; f < kF; ++f) o[f * plane] = acc[k][f];
  }
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
// and tap k + 1 weighs w, as in taps_of. The floor is clamped to
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
              const VTerms vt = v_terms(p, fv);
              for (int x = xa; x <= xb; ++x) {
                float cf, zaff;
                grid_at(p, r, cx, cz, static_cast<float>(x), vt, &cf, &zaff);
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
          const float t0 = t.x - t.y, t1 = t.y;
          const int k = __float_as_int(zc.x);
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            const int z = k + o;
            if (z < za_o || z > zb_o) continue;
            const float wz = o ? zc.y : 1.0f - zc.y;
            float2* a = sA + xa_l * kAP + (z - z0);
            *a = make_float2(a->x + wz * t0, a->y + wz * t1);
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

// K4b tiling: the same source slab r and kTX x kTZ tile of (x, z) as K4.
// A view's v window (the union over its branches) is cut into chunks of
// kBVC rows, its branches into rounds of kBMaxBranch; per chunk and round,
// between two barriers, kBRows * kBVC threads each own one row v and the
// columns x = xg, xg + kBRows, ... of it (kBEnt entries (x, v)), and compute
// per entry the grid sawtooth and zeta's affine part (first round) and
// pass B's sums of the round's branches; then, after the barrier, pass A
// runs for a thread's kZR voxels z of one column x, both sides and the
// round's branches, into registers that live across the views. Nothing per
// sample is staged: an entry computes its candidates' samples itself, one
// march index for all branches.
constexpr int kBVC = 80;                              // rows of a v chunk
constexpr int kBP = kBVC + 1;                         // pitch: 81 words, odd
constexpr int kBRows = 3;                             // pass-B threads a row
constexpr int kBEnt = (kTX + kBRows - 1) / kBRows;    // entries a thread
constexpr int kBMaxBranch = 3;                        // branches a round
static_assert(kBRows * kBVC <= kAdjThreads, "a pass-B thread per row part");
// the grid sawtooth and zeta's affine part (fp32), then the rounded planes
// (T_all - T_fy, T_fy) of each branch (bf16 pairs), all [xl][vl]
constexpr int kBSmem = 4 * 2 * kTX * kBP + 4 * kBMaxBranch * kTX * kBP;
static_assert(8 * kTX * kAP <= kBSmem, "the output staging fits");

// ceil(x) for |x| < 2^22: x + 1.5 * 2^23 rounded up, less 1.5 * 2^23 (two
// adds: FRND issues at a quarter of the FMA rate). It equals ceilf(x) but
// for the sign of a zero, which no use of the march index sees (it enters
// comparisons and cfb = j - jreal only).
__device__ __forceinline__ float ceil_small(float x) {
  return __fadd_ru(x, 12582912.0f) - 12582912.0f;
}

// sample_from with the march index's ceiling jb = ceil(jreal) given: the
// same sample, the ceiling shared by the branches.
__device__ __forceinline__ Sample sample_of(const Arc& p, float jb,
                                            float jreal, float xa, int b,
                                            int n_steps) {
  Sample s;
  s.j = jb + static_cast<float>(b);
  s.cfb = sub(s.j, jreal);
  s.fy = mul(p.edy, s.cfb);
  s.ok = s.j >= 0.0f && s.j < static_cast<float>(n_steps) && s.fy < 1.0f;
  s.X = add(xa, mul(p.edx, s.cfb));
  return s;
}

// floor(q) + 1 for |q| < 2^22 (an add rounded down: no FRND or F2I).
__device__ __forceinline__ int floor_plus_one(float q) {
  return __float_as_int(__fadd_rd(q, 12582912.0f)) - 0x4B400000 + 1;
}

// Pass B of one entry (x, v) for the branches b0 .. b0 + nbr - 1: over kC
// consecutive u from u0 (kC = 0: cu of them; a u off the detector adds
// zero), T_all[b] += hat(X_b - x) * ok_b * g and T_fy[b] += hat(X_b - x) *
// ok_b * fy_b * g, one march index for all branches. The loads of g come
// first, at a clamped u, so that they are in flight together.
template <int kC>
__device__ __forceinline__ void pass_b_entry(
    float (&t_all)[kBMaxBranch], float (&t_fy)[kBMaxBranch],
    const __nv_bfloat16* __restrict__ gcol, const Arc& p, float r, float cx,
    const VTerms& vt, float fx, int u0, int nu, int nv, int cu, int b0,
    int nbr, int n_steps) {
  const float fu0 = int_to_float(u0);
  const int n = kC > 0 ? kC : cu;
  constexpr int kU = kC > 0 ? kC : 1;
  float gval[kU];
#pragma unroll
  for (int i = 0; i < kU; ++i) {
    const int u = min(max(u0 + i, 0), nu - 1);
    const float gi = __bfloat162float(gcol[static_cast<size_t>(u) * nv]);
    gval[i] = static_cast<unsigned>(u0 + i) < static_cast<unsigned>(nu)
                  ? gi : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float gi;
    if (kC > 0) {
      gi = gval[kC > 0 ? i % kU : 0];
    } else {
      const int u = u0 + i;
      if (static_cast<unsigned>(u) >= static_cast<unsigned>(nu)) continue;
      gi = __bfloat162float(gcol[static_cast<size_t>(u) * nv]);
    }
    const float fu = fu0 + static_cast<float>(i);
    const float jreal = jreal_of<true>(p, r, y0_at(p, fu, vt));
    const float jb = ceil_small(jreal);
    const float xa = x_affine(cx, mul(fu, p.eux), vt);
#pragma unroll
    for (int b = 0; b < kBMaxBranch; ++b) {
      if (b >= nbr) break;
      const Sample s = sample_of(p, jb, jreal, xa, b0 + b, n_steps);
      const float gw = s.ok ? gi : 0.0f;
      const float w = hat(s.X, fx);
      t_all[b] = fmaf(w, gw, t_all[b]);
      t_fy[b] = fmaf(w, s.fy * gw, t_fy[b]);
    }
  }
}

// Pass A of one thread's voxels (column x, z = za + j) for the branches
// b0 .. b0 + nbr - 1 over a chunk's rows: kC consecutive v from the first
// past each voxel's window start (kC = 0: cv of them), acc0[j] += hat(zeta_b
// - z) * round(T_all - T_fy) and acc1[j] += hat(zeta_b - z) * round(T_fy),
// zeta_b = zeta_at(cf + b, zaff) from the grid; cf, za and pl point at the
// column's row vc0 of the grid and of the planes.
template <int kC>
__device__ __forceinline__ void pass_a_voxels(
    float (&acc0)[kZR], float (&acc1)[kZR], const float* __restrict__ cf_row,
    const float* __restrict__ za_row, const __nv_bfloat162* __restrict__ pl,
    const Arc& p, float q0, float inv_zav, float fzo, int vc0, int smax,
    int cv, int b0, int nbr) {
#pragma unroll
  for (int j = 0; j < kZR; ++j) {
    const float fz = fzo + static_cast<float>(j);
    const int v0 = min(max(floor_plus_one(fmaf(static_cast<float>(j),
                                               inv_zav, q0)), vc0), smax);
    float a0 = acc0[j], a1 = acc1[j];
    const int n = kC > 0 ? kC : cv;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const int k = v0 + i;
      const float cf = cf_row[k], zaff = za_row[k];
#pragma unroll
      for (int b = 0; b < kBMaxBranch; ++b) {
        if (b >= nbr) break;
        const int bb = b0 + b;
        // branch 0's cf + 0 is cf (cf is never -0)
        const float w = hat(
            zeta_at(p, bb ? add(cf, static_cast<float>(bb)) : cf, zaff), fz);
        const float2 t = __bfloat1622float2(pl[b * kTX * kBP + k]);
        a0 = fmaf(w, t.x, a0);
        a1 = fmaf(w, t.y, a1);
      }
    }
    acc0[j] = a0;
    acc1[j] = a1;
  }
}

// K4b: grid (z tiles, x tiles, source slabs r = -1 .. ny-1); g (V, nu, nv)
// in bf16 into side0 (slab r) and side1 (slab r + 1), as K4. Both
// transposes are gathers with the weight hat(position - tap), so a
// candidate outside a window adds zero and no thread branches on a tap:
//   pass B: T_all(x, v) and T_fy(x, v) of each branch b sum, over cu
//     consecutive u from the window of the union of the branches, the
//     sample's ok*g and ok*fy*g times hat(X_b(u, v) - x); the samples
//     (jreal_of<true>, then sample_of: sample_from's arithmetic, K3b's
//     decisions to the bit) take one march index for all branches;
//   pass A: each voxel sums, over cv consecutive v, hat(zeta_b(x, v) - z)
//     times the rounded planes T_all - T_fy (side 0) and T_fy (side 1),
//     zeta_b from grid_at<true> as K3b's tables.
// Every voxel of both sides is written once, every sum runs in one fixed
// order (no atomics).
__global__ void __launch_bounds__(kAdjThreads, 3)
arc_adj_bf16_kernel(const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ scalars,
                    float* __restrict__ side0, float* __restrict__ side1,
                    int V, int nx, int ny, int nz, int nu, int nv,
                    int n_steps, int n_branch) {
  extern __shared__ __align__(16) float sm[];
  float* const sCf = sm;                           // [xl][vl] grid sawtooth
  float* const sZa = sCf + kTX * kBP;              // [xl][vl] zeta's affine
  __nv_bfloat162* const sP =                       // [b][xl][vl]
      reinterpret_cast<__nv_bfloat162*>(sZa + kTX * kBP);
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
  const float fxo = static_cast<float>(x0 + xa_l);
  const float fzo = static_cast<float>(za_o);
  // this thread's pass-B entries: row vb, columns xg + kBRows*q (q < nqb)
  const int vb = tid % kBVC, xg = tid / kBVC;
  const bool owns_b = tid < kBRows * kBVC && xg < ntx;
  const int nqb = (ntx - xg + kBRows - 1) / kBRows;
  const float fxg = static_cast<float>(x0 + xg);
  float acc0[kZR], acc1[kZR];
#pragma unroll
  for (int s = 0; s < kZR; ++s) acc0[s] = acc1[s] = 0.0f;
  const float fnb = static_cast<float>(n_branch);

  for (int view = 0; view < V; ++view) {
    const Arc p = load_arc(scalars + view * NS);
    const __nv_bfloat16* gv = g + static_cast<size_t>(view) * nu * nv;
    const float cx = slab_cx(p, r);
    const float cz = slab_cz(p, r);
    // zeta's affine part in v: za(x) + zav*v; X's: (cx + evx*v) + eux*u;
    // the sawtooth terms over all branches: edz*(cf + b) and edx*cfb
    // in edz*[0, n_branch] and edx*[0, n_branch]
    const float zav = p.evz - p.gzx * p.evx;
    const float inv_zav = 1.0f / zav;
    const float ezmax = fmaxf(0.0f, p.edz * fnb);
    const float ezmin = fminf(0.0f, p.edz * fnb);
    const float exmax = fmaxf(0.0f, p.edx * fnb);
    const float exmin = fminf(0.0f, p.edx * fnb);
    int vlo, vhi;
    range_union(fmaf(p.gzx, fxa - cx, cz), fmaf(p.gzx, fxb - cx, cz), zav,
                inv_zav, fza - 1.0f - ezmax, fzb + 1.0f - ezmin, nv, &vlo,
                &vhi);
    const int cu = candidates((2.0f + exmax - exmin) * fabsf(p.inv_eux), 64);
    const int cv = candidates((2.0f + ezmax - ezmin) * fabsf(inv_zav), kBVC);
    // the windows' lower ends: x - 1 - exmax (eux > 0), z - 1 - ezmax
    const float lo_x = p.eux > 0.0f ? -1.0f - exmax : 1.0f - exmin;
    const float lo_z = zav > 0.0f ? -1.0f - ezmax : 1.0f - ezmin;
    for (int vc0 = vlo; vc0 <= vhi; vc0 += kBVC) {
      const int nvw = min(vhi - vc0 + 1, kBVC);
      // the branches in rounds of kBMaxBranch (one round below 3)
      for (int b0 = 0; b0 < n_branch; b0 += kBMaxBranch) {
        const int nbr = min(n_branch - b0, kBMaxBranch);
        // 1. per entry (x, v) of this thread's row: the grid (first
        // round), then pass B of the round's branches
        if (owns_b) {
          const bool row_in = vb < nvw;
          const int v = vc0 + vb;
          const float fv = int_to_float(v);
          const VTerms vt = v_terms(p, fv);
          const float q0 =
              (fxg + lo_x - fmaf(p.evx, fv, cx)) * p.inv_eux;
          const float step = static_cast<float>(kBRows) * p.inv_eux;
#pragma unroll 1
          for (int q = 0; q < nqb; ++q) {
            const int xl = xg + kBRows * q;
            float t_all[kBMaxBranch], t_fy[kBMaxBranch];
#pragma unroll
            for (int b = 0; b < kBMaxBranch; ++b) t_all[b] = t_fy[b] = 0.0f;
            if (row_in) {
              const float fx = fxg + static_cast<float>(kBRows * q);
              if (b0 == 0) {
                float cf, zaff;
                grid_at<true>(p, r, cx, cz, fx, vt, &cf, &zaff);
                sCf[xl * kBP + vb] = cf;
                sZa[xl * kBP + vb] = zaff;
              }
              const int u0 =
                  floor_plus_one(fmaf(static_cast<float>(q), step, q0));
              const __nv_bfloat16* const gcol = gv + v;
#define K4B_PASS_B(C)                                                     \
  pass_b_entry<C>(t_all, t_fy, gcol, p, r, cx, vt, fx, u0, nu, nv, cu, b0, \
                  nbr, n_steps)
              switch (cu) {
                case 1: K4B_PASS_B(1); break;
                case 2: K4B_PASS_B(2); break;
                case 3: K4B_PASS_B(3); break;
                case 4: K4B_PASS_B(4); break;
                default: K4B_PASS_B(0);
              }
#undef K4B_PASS_B
            }
            // the planes each side reads, rounded; rows past the chunk
            // zero
#pragma unroll
            for (int b = 0; b < kBMaxBranch; ++b) {
              if (b >= nbr) break;
              sP[(b * kTX + xl) * kBP + vb] =
                  __floats2bfloat162_rn(t_all[b] - t_fy[b], t_fy[b]);
            }
          }
        }
        __syncthreads();
        // 2. pass A: this thread's voxels gather cv rows each, for the
        // round's branches
        if (owns_a) {
          const int nvs = min(max(nvw, cv), kBVC);
          const int cvv = min(cv, nvs);
          const int smax = vc0 + nvs - cvv;
          const float q0 = (fzo + lo_z - fmaf(p.gzx, fxo - cx, cz)) * inv_zav;
          const int row = xa_l * kBP - vc0;
#define K4B_PASS_A(C)                                                      \
  pass_a_voxels<C>(acc0, acc1, sCf + row, sZa + row, sP + row, p, q0,     \
                   inv_zav, fzo, vc0, smax, cvv, b0, nbr)
          switch (cvv) {
            case 2: K4B_PASS_A(2); break;
            case 3: K4B_PASS_A(3); break;
            default: K4B_PASS_A(0);
          }
#undef K4B_PASS_A
        }
        __syncthreads();
      }
    }
  }
  // every voxel of both sides written once, through shared memory so that
  // the stores run along z
  float2* const sA = reinterpret_cast<float2*>(sm);   // [xl][zl]
  if (owns_a) {
#pragma unroll
    for (int s = 0; s < kZR; ++s)
      if (za_o + s <= zb_o)
        sA[xa_l * kAP + za_o + s - z0] = make_float2(acc0[s], acc1[s]);
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

// K3b tiling: K3's CTA (one view, a kFU x kFV tile of (u, v), lane = v,
// kPix pixels u a thread), ring of kRing staged bf16 slabs, windows and
// step order (stage slab r + 2, pass A of step r, a barrier, pass B of
// step r: pass A beside pass B of the step before measured slower, PERF.md
// section 6). Its tables (per branch b < 2) hold per (x, v) the pair word
// (h0, h1): the bf16 z-lerps of sides r and r + 1, in column x - x0 + 1 of
// kHQ; column 0 is T's column x0 - 1 and columns nq + 1, nq + 2 lie past
// its last: all three hold zeros (a tap outside the window lies outside the
// volume), so pass B reads both taps of a sample, clamped into [x0 - 1, x1
// + 1], without a test. The windows of a chunk of kChunk steps are
// computed at its start: entry e = step e - 1's window and live branches,
// and slab e's staged window.
constexpr int kHQ = kQX + 3;
constexpr int kHTab = kHQ * kFV;
constexpr int kArcHSmem =
    2 * kRing * kSX * ArcStage<__nv_bfloat16>::kSZ + 4 * kTabBranches * kHTab +
    kChunk * (2 * static_cast<int>(sizeof(short4)) +
              static_cast<int>(sizeof(unsigned)));
static_assert(4 * (kArcHSmem + 1024) <= 228 * 1024, "4 K3b CTAs an SM");

// A value the compiler must take as unknown (a constant folded into an
// address would be split again, the load offsets being 24-bit).
__device__ __forceinline__ unsigned opaque(unsigned x) {
  asm("" : "+r"(x));
  return x;
}

// (lo, hi) rounded to bf16 (nearest even) by one cvt.rn.bf16x2.f32.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// The lerp (1 - w) * a + w * c of the z-lerps that the bf16 tables round.
__device__ __forceinline__ float lerp_bf(float a, float c, float w) {
  return fmaf(w, c, (1.0f - w) * a);
}

// K3b's window entry e (step e - 1, slab e) into slot e % kChunk: the
// step's window and live branches with bit 31 set where it is fast (its
// window fits the tables, the march has at most two branches and the
// staged windows of both its slabs hold it).
__device__ __forceinline__ void arc_entry(const Arc& p, const FwdTile& t,
                                          int e, int nx, int ny, int nz,
                                          int n_branch, int n_steps,
                                          bool vec, short4* c_step,
                                          unsigned* c_live) {
  const int rs = e - 1;
  const short4 w = step_window(p, t, rs, nx, ny, nz);
  using B = __nv_bfloat16;
  const bool fast =
      w.y - w.x < kQX && n_branch <= kTabBranches &&
      (rs < 0 || holds(stage_window<B>(p, t, rs, nx, ny, nz, vec), w)) &&
      (rs + 1 >= ny ||
       holds(stage_window<B>(p, t, rs + 1, nx, ny, nz, vec), w));
  const unsigned lb = live_branches(p, t, rs, w, n_branch, n_steps);
  c_step[e % kChunk] = w;
  c_live[e % kChunk] = lb && fast ? lb | 1u << 31 : lb;
}

// K3b: grid (v tiles, u tiles, views); vol (nx, ny, nz) in bf16, scalars
// (V, NS), out (V, nu, nv) in fp32. Every output is written exactly once.
// The samples (one march index jreal_of<true> per pixel, sample_of for
// every branch) are K3's to the bit; pass A's grid, positions and taps are
// K3's, its z-lerps rounded to bf16 where the plain version rounds them.
//
// Step r (r = -1 .. ny-1): wait for slab r + 1; one barrier (and, at a
// chunk's start, the chunk's windows and a second); stage slab r + 2; for
// a fast step pass A into the tables, a barrier, pass B (one march index a
// pixel, each live branch's sample, both taps from its table); for any
// other live step the direct way per sample (a window beyond the
// capacities, or a third branch); nothing where no branch is live.
__global__ void __launch_bounds__(kFwdThreads, 4)
arc_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ vol,
                    const float* __restrict__ scalars,
                    float* __restrict__ out, int nx, int ny, int nz, int nu,
                    int nv, int n_steps, int n_branch, bool vec) {
  using B = __nv_bfloat16;
  constexpr int kSZ = ArcStage<B>::kSZ;
  constexpr int kSlots = ArcStage<B>::kSlots;
  extern __shared__ __align__(16) float sm[];
  B* const ring = reinterpret_cast<B*>(sm);
  unsigned* const tabs = reinterpret_cast<unsigned*>(ring + kRing * kSX *
                                                     kSZ);
  short4* const c_step =
      reinterpret_cast<short4*>(tabs + kTabBranches * kHTab);
  short4* const c_stage = c_step + kChunk;
  unsigned* const c_live = reinterpret_cast<unsigned*>(c_stage + kChunk);
  const unsigned tabs_s = smem_addr(tabs);
  const unsigned short* const ring16 =
      reinterpret_cast<const unsigned short*>(ring);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int view = blockIdx.z;
  const int v0 = blockIdx.x * kFV, u0 = blockIdx.y * kFU;
  const Arc p = load_arc(scalars + static_cast<size_t>(view) * NS);
  const int v = v0 + lane;
  const bool v_in = v < nv;
  const VTerms vt = v_terms(p, static_cast<float>(v));
  const FwdTile tile = fwd_tile(
      p, static_cast<float>(u0), static_cast<float>(min(u0 + kFU, nu) - 1),
      static_cast<float>(v0), static_cast<float>(min(v0 + kFV, nv) - 1),
      n_branch);
  auto slab_at = [](int s) { return ((s + 1) % kRing) * kSX * kSZ; };
  float y0[kPix], ue[kPix], acc[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const float fu = static_cast<float>(u0 + warp + kFwdWarps * k);
    y0[k] = y0_at(p, fu, vt);
    ue[k] = mul(fu, p.eux);
    acc[k] = 0.0f;
  }
  int slot[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) slot[i] = copy_slot<B>(tid, i);
  if (tid < kTabBranches * kFV) tabs[tid / kFV * kHTab + tid % kFV] = 0u;
  short4 st_r = empty_win();
  short4 st_r1 = stage_window<B>(p, tile, 0, nx, ny, nz, vec);
  stage_slab(ring + slab_at(0), vol, 0, st_r1, ny, nz, vec, tid, slot);
  for (int ri = -1; ri < ny; ++ri) {
    cp_async_wait_all();
    __syncthreads();
    const int ci = (ri + 1) % kChunk;
    if (ci == 0) {
      if (tid < kChunk) {
        arc_entry(p, tile, tid + ri + 1, nx, ny, nz, n_branch, n_steps, vec,
                  c_step, c_live);
      } else if (tid < 2 * kChunk) {
        c_stage[(ri + 2 + tid - kChunk) % kChunk] = stage_window<B>(
            p, tile, ri + tid - kChunk + 2, nx, ny, nz, vec);
      }
      __syncthreads();
    }
    const short4 st_r2 = c_stage[(ri + 2) % kChunk];
    stage_slab(ring + slab_at(ri + 2), vol, ri + 2, st_r2, ny, nz, vec, tid,
               slot);
    const short4 w_r = c_step[(ri + 1) % kChunk];
    const unsigned live = c_live[(ri + 1) % kChunk];
    if (live) {
      const float r = static_cast<float>(ri);
      const float cx = slab_cx(p, r), cz = slab_cz(p, r);
      const int qx0 = w_r.x, nq = w_r.y - w_r.x + 1;
      const bool side0 = ri >= 0, side1 = ri + 1 < ny;
      if (live >> 31) {
        const int base0 = slab_at(ri) - st_r.x * kSZ - st_r.z;
        const int base1 = slab_at(ri + 1) - st_r1.x * kSZ - st_r1.z;
        const unsigned unz = static_cast<unsigned>(nz);
        unsigned* const tw = tabs + kFV + lane;
        if (v_in) {
          for (int xl = warp; xl < nq; xl += kFwdWarps) {
            const int x = qx0 + xl;
            float cf, zaff;
            grid_at<true>(p, r, cx, cz, static_cast<float>(x), vt, &cf,
                          &zaff);
            const unsigned short* row0 = ring16 + base0 + x * kSZ;
            const unsigned short* row1 = ring16 + base1 + x * kSZ;
            float a0 = 0.0f, c0 = 0.0f, a1 = 0.0f, c1 = 0.0f;
            int k_prev = 0;
#pragma unroll
            for (int b = 0; b < kTabBranches; ++b) {
              if (!(live >> b & 1u)) continue;
              const float zeta =
                  zeta_at(p, b ? add(cf, static_cast<float>(b)) : cf, zaff);
              const float f = floorf(zeta);
              const int k = static_cast<int>(f);
              const float w = zeta - f;
              if (b == 0 || !(live & 1u) || k != k_prev) {
                const bool ia = static_cast<unsigned>(k) < unz;
                const bool ic = static_cast<unsigned>(k) + 1u < unz;
                a0 = side0 && ia ? widen_lo(row0[k]) : 0.0f;
                c0 = side0 && ic ? widen_lo(row0[k + 1]) : 0.0f;
                a1 = side1 && ia ? widen_lo(row1[k]) : 0.0f;
                c1 = side1 && ic ? widen_lo(row1[k + 1]) : 0.0f;
                k_prev = k;
              }
              tw[b * kHTab + xl * kFV] =
                  pack_bf16((1.0f - w) * a0 + w * c0, (1.0f - w) * a1 + w * c1);
            }
          }
          if (warp == 0) {
#pragma unroll
            for (int b = 0; b < kTabBranches; ++b) {
              tw[b * kHTab + nq * kFV] = 0u;
              tw[b * kHTab + (nq + 1) * kFV] = 0u;
            }
          }
        }
        __syncthreads();
        const float lo_x = static_cast<float>(w_r.x) - 1.0f;
        const float hi_x = static_cast<float>(w_r.y) + 1.0f;
        const unsigned tb = opaque(tabs_s + 4u * lane -
                                   128u * static_cast<unsigned>(w_r.x - 1) -
                                   (kFloorBias << 7));
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const int u = u0 + warp + kFwdWarps * k;
          if (!v_in || u >= nu) continue;
          const float jreal = jreal_of<true>(p, r, y0[k]);
          const float jb = ceil_small(jreal);
          const float xa = x_affine(cx, ue[k], vt);
          float a = acc[k];
#pragma unroll
          for (int b = 0; b < kTabBranches; ++b) {
            if (!(live >> b & 1u)) continue;
            const Sample s = sample_of(p, jb, jreal, xa, b, n_steps);
            if (!s.ok) continue;
            const float X = fminf(fmaxf(s.X, lo_x), hi_x);
            const float sx = __fadd_rd(X, 12582912.0f);
            const float wx = X - (sx - 12582912.0f);
            const unsigned q =
                tb + 4u * (b * kHTab) + (__float_as_uint(sx) << 7);
            const unsigned t0 = lds_u32(q), t1 = lds_u32(q + 4u * kFV);
            const float g = 1.0f - s.fy;
            const float l0 = fmaf(s.fy, widen_hi(t0), g * widen_lo(t0));
            const float l1 = fmaf(s.fy, widen_hi(t1), g * widen_lo(t1));
            a += fmaf(wx, l1, (1.0f - wx) * l0);
          }
          acc[k] = a;
        }
      } else {
        const bool s0 = side0, s1 = side1;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const int u = u0 + warp + kFwdWarps * k;
          if (!v_in || u >= nu) continue;
          const float jreal = jreal_of<true>(p, r, y0[k]);
          const float xa = x_affine(cx, ue[k], vt);
          for (int b = 0; b < n_branch; ++b) {
            if (!(live >> b & 1u)) continue;
            const Sample s = sample_from(p, jreal, xa, b, n_steps);
            if (!s.ok) continue;
            const float xf = floorf(s.X);
            const int x0 = static_cast<int>(xf);
            const float wx = s.X - xf;
            float val = 0.0f;
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              const int xi = x0 + o;
              if (xi < 0 || xi >= nx) continue;
              float cf, zaff;
              grid_at<true>(p, r, cx, cz, static_cast<float>(xi), vt, &cf,
                            &zaff);
              const float zeta =
                  zeta_at(p, add(cf, static_cast<float>(b)), zaff);
              const float zf = floorf(zeta);
              const int kz = static_cast<int>(zf);
              const float wz = zeta - zf;
              const B* col = vol + static_cast<size_t>(xi) * ny * nz;
              auto side = [&](int sl) {
                const B* row = col + static_cast<size_t>(sl) * nz;
                const float lo = kz >= 0 && kz < nz
                                     ? __bfloat162float(__ldg(row + kz)) : 0.0f;
                const float hi = kz + 1 >= 0 && kz + 1 < nz
                                     ? __bfloat162float(__ldg(row + kz + 1))
                                     : 0.0f;
                return __bfloat162float(__float2bfloat16_rn(lerp_bf(lo, hi,
                                                                    wz)));
              };
              const float h0 = s0 ? side(ri) : 0.0f;
              const float h1 = s1 ? side(ri + 1) : 0.0f;
              val += (o ? wx : 1.0f - wx) * ((1.0f - s.fy) * h0 + s.fy * h1);
            }
            acc[k] += val;
          }
        }
      }
    }
    st_r = st_r1;
    st_r1 = st_r2;
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int u = u0 + warp + kFwdWarps * k;
    if (!v_in || u >= nu) continue;
    out[(static_cast<size_t>(view) * nu + u) * nv + v] = acc[k];
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

// jreal_of<true>'s quotient a/edy and __fdiv_rn's, for a test to compare
// their bits.
__global__ void __launch_bounds__(256)
div_check_kernel(const float* __restrict__ a, float* __restrict__ q_rcp,
                 float* __restrict__ q_div, int n, float edy) {
  Arc p{};
  p.edy = edy;
  p.inv_edy = __frcp_rn(edy);
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n; i += gridDim.x * 256) {
    q_rcp[i] = jreal_of<true>(p, a[i], 0.0f);
    q_div[i] = __fdiv_rn(a[i], edy);
  }
}

// Launch the march: K3 (kJac false) or K5.
template <bool kJac>
int launch_march(const float* vol, const float* scalars, float* out, int V,
                 int nx, int ny, int nz, int nu, int nv, int n_steps,
                 int n_branch, void* stream) {
  if (V <= 0 || nu <= 0 || nv <= 0) return 0;
  // grid z holds the views; windows are kept as 16-bit indices
  if (V > 65535 || nx >= 32768 || nz >= 32768)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  constexpr int kSmem = fwd_smem<kJac>();
  cudaError_t e = cudaFuncSetAttribute(
      arc_march_kernel<kJac>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec =
      nz % 4 == 0 && reinterpret_cast<std::uintptr_t>(vol) % 16 == 0;
  const dim3 grid((nv + kFV - 1) / kFV, (nu + kFU - 1) / kFU, V);
  arc_march_kernel<kJac><<<grid, kFwdThreads, kSmem,
                           static_cast<cudaStream_t>(stream)>>>(
      vol, scalars, out, nx, ny, nz, nu, nv, n_steps, n_branch, vec);
  return static_cast<int>(cudaGetLastError());
}

// Launch K3b.
int launch_arc_fwd_bf16(const __nv_bfloat16* vol, const float* scalars,
                        float* out, int V, int nx, int ny, int nz, int nu,
                        int nv, int n_steps, int n_branch, void* stream) {
  if (V <= 0 || nu <= 0 || nv <= 0) return 0;
  // grid z holds the views; windows are kept as 16-bit indices
  if (V > 65535 || nx >= 32768 || nz >= 32768)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t e = cudaFuncSetAttribute(
      arc_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kArcHSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec =
      nz % 8 == 0 && reinterpret_cast<std::uintptr_t>(vol) % 16 == 0;
  const dim3 grid((nv + kFV - 1) / kFV, (nu + kFU - 1) / kFU, V);
  arc_fwd_bf16_kernel<<<grid, kFwdThreads, kArcHSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      vol, scalars, out, nx, ny, nz, nu, nv, n_steps, n_branch, vec);
  return static_cast<int>(cudaGetLastError());
}

// Launch K4 (fp32, arc_adj_kernel) or K4b (bf16, arc_adj_bf16_kernel),
// then the add: vol receives side 0 and then side 1 added; side1 is
// scratch of vol's shape (nx, ny, nz).
template <typename TS>
int launch_adj(const TS* g, const float* scalars, float* vol, float* side1,
               int V, int nx, int ny, int nz, int nu, int nv, int n_steps,
               int n_branch, void* stream) {
  const long long n = static_cast<long long>(nx) * ny * nz;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nz + kTZ - 1) / kTZ, (nx + kTX - 1) / kTX, ny + 1);
  cudaError_t e;
  if constexpr (sizeof(TS) == 4) {
    e = cudaFuncSetAttribute(arc_adj_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kAdjSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    arc_adj_kernel<<<grid, kAdjThreads, kAdjSmem, s>>>(
        g, scalars, vol, side1, V, nx, ny, nz, nu, nv, n_steps, n_branch);
  } else {
    e = cudaFuncSetAttribute(arc_adj_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    arc_adj_bf16_kernel<<<grid, kAdjThreads, kBSmem, s>>>(
        g, scalars, vol, side1, V, nx, ny, nz, nu, nv, n_steps, n_branch);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (n + 255) / 256;
  add_kernel<<<static_cast<int>(blocks < 8192 ? blocks : 8192), 256, 0, s>>>(
      vol, side1, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int slab_arc_fwd(const float* vol, const float* scalars, float* out, int V,
                 int nx, int ny, int nz, int nu, int nv, int n_steps,
                 int n_branch, void* stream) {
  return launch_march<false>(vol, scalars, out, V, nx, ny, nz, nu, nv,
                             n_steps, n_branch, stream);
}

int slab_arc_adj(const float* g, const float* scalars, float* vol,
                 float* side1, int V, int nx, int ny, int nz, int nu, int nv,
                 int n_steps, int n_branch, void* stream) {
  return launch_adj(g, scalars, vol, side1, V, nx, ny, nz, nu, nv, n_steps,
                    n_branch, stream);
}

// K3b: vol is the oriented volume in bf16.
int slab_arc_fwd_bf16(const void* vol, const float* scalars, float* out,
                      int V, int nx, int ny, int nz, int nu, int nv,
                      int n_steps, int n_branch, void* stream) {
  return launch_arc_fwd_bf16(static_cast<const __nv_bfloat16*>(vol), scalars,
                             out, V, nx, ny, nz, nu, nv, n_steps, n_branch,
                             stream);
}

// K4b: g is the cotangent in bf16.
int slab_arc_adj_bf16(const void* g, const float* scalars, float* vol,
                      float* side1, int V, int nx, int ny, int nz, int nu,
                      int nv, int n_steps, int n_branch, void* stream) {
  return launch_adj(static_cast<const __nv_bfloat16*>(g), scalars, vol,
                    side1, V, nx, ny, nz, nu, nv, n_steps, n_branch, stream);
}

int slab_arc_jac(const float* vol, const float* scalars, float* out, int V,
                 int nx, int ny, int nz, int nu, int nv, int n_steps,
                 int n_branch, void* stream) {
  return launch_march<true>(vol, scalars, out, V, nx, ny, nz, nu, nv,
                            n_steps, n_branch, stream);
}

int slab_arc_div_check(const float* a, float* q_rcp, float* q_div, int n,
                       float edy, void* stream) {
  if (n > 0) {
    div_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        a, q_rcp, q_div, n, edy);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
