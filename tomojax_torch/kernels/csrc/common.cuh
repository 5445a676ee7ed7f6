// What the CUDA kernels share by design, written once: the slab kernels'
// per-view scalar layout, the cp.async primitives, the shared-memory and
// bf16 bit primitives, and the candidate math of the gather schedule that
// K2, K2b and K4b share. Only a definition with one text in every source
// that uses it belongs here. Each kernel keeps its own tile and launch
// constants, even where they are equal today, and its own position helpers
// (slab_cx, zeta_at, step_window, stage_slab, ...), whose rounding differs
// between the sources on purpose.

#pragma once

#include <cuda_runtime.h>

namespace {

// Per-view scalar layout: tomojax_torch/core/slab_projector.py S_*.
constexpr int NS = 21;
constexpr int S_EDY = 0, S_EDX = 1, S_EDZ = 2, S_RX = 3, S_RZ = 4,
              S_EUX = 5, S_EVX = 6, S_EVZ = 7, S_CXB = 8, S_CZB = 9,
              S_GZX = 10, S_B1 = 11, S_EUY = 12, S_EVY = 13, S_SCALE = 17,
              S_ZAV = 20;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
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

// A table's word at a 32-bit shared address.
__device__ __forceinline__ unsigned lds_u32(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// bf16 bits b (in the low half) widened to fp32 by a shift, not a
// conversion; a pair word's halves by a shift and a mask.
__device__ __forceinline__ float widen_lo(unsigned b) {
  return __uint_as_float(b << 16);
}

__device__ __forceinline__ float widen_hi(unsigned b) {
  return __uint_as_float(b & 0xFFFF0000u);
}

// The bias that a floor's sum carries (q + 1.5 * 2^23 rounded down):
// element floor(q) of an array at byte a with byte stride t lies at
// a - kFloorBias * t + bits(q + 1.5 * 2^23 rounded down) * t, modulo 2^32.
constexpr unsigned kFloorBias = 0x4B400000u;

// i as a float, for |i| < 2^22: 1.5 * 2^23 + i in the mantissa, less
// 1.5 * 2^23 (an integer add and a float add: I2F issues at a quarter of
// the FMA rate).
__device__ __forceinline__ float int_to_float(int i) {
  return __int_as_float(0x4B400000 + i) - 12582912.0f;
}

// The most integers that an open interval of width w can hold, at least
// one and at most cap (NaN: cap).
__device__ __forceinline__ int candidates(float w, int cap) {
  const float c = fminf(ceilf(w), static_cast<float>(cap));
  return max(1, static_cast<int>(c));
}

// The lerp weight that position pos gives tap k: 1 - |pos - k| where
// positive (1 - w for k = floor(pos), w for k + 1: the plain version's
// weights), else 0.
__device__ __forceinline__ float hat(float pos, float k) {
  return fmaxf(0.0f, 1.0f - fabsf(pos - k));
}

}  // namespace
