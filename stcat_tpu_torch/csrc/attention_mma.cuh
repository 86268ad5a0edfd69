// Building blocks shared by the attention kernels (flash_attention.cu, K1,
// and flash_attention_bwd.cu, K2): 16-byte asynchronous copies into shared
// memory, ldmatrix, the bf16 tensor-core product mma.sync.m16n8k16 and its
// fragment addressing, and the staging of row-major [n, d] tiles.
//
// Fragment layouts of m16n8k16 (g = lane / 4, c = 2 * (lane % 4)):
//   A 16x16 row-major: a0 (g, c..c+1), a1 (g+8, c..), a2 (g, 8+c..), a3 (g+8, 8+c..)
//   B 16x8 (k x n):    b0 (k = c..c+1, n = g), b1 (k = 8+c.., n = g)
//   C 16x8 fp32:       c0,c1 (g, c..c+1), c2,c3 (g+8, c..c+1)
// Two neighbouring C tiles (16 columns) are exactly one A operand of the
// next product, so the softmax weights never leave the registers.
//
// Shared-memory tiles keep rows of D + 8 bf16 (D a multiple of 16): the 16
// extra bytes put the 8 row addresses of every ldmatrix phase on 8 distinct
// 16-byte bank groups, so ldmatrix and ldmatrix.trans are conflict-free.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

// A logit in base-2 units, rounded once: __fmul_rn keeps the compiler from
// contracting it into a later fma (x * LOG2E - m), so a pass that recomputes
// it gets the very value whose maximum an earlier pass stored; a fully masked
// row (every logit -1e30) then has x - m = 0 exactly, where an unrounded
// product would leave ~1e23 and overflow exp2f.
__device__ __forceinline__ float log2_logit(float s, float bias) {
  return __fmul_rn(s + bias, LOG2E);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; valid = false writes 16 zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16 bf16) * b (16x8 bf16), fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// this lane's ldmatrix address for an A operand: rows r0..r0+15, k-step 0
__device__ __forceinline__ const bf16* a_addr(const bf16* s, int sp, int r0, int lane) {
  return s + (r0 + (lane & 15)) * sp + (lane >> 4) * 8;
}
// B from a tile whose rows are n (ldmatrix): n0..n0+15 at k-step ks give
// b[0], b[1] for n0..n0+7 and b[2], b[3] for n0+8..n0+15
__device__ __forceinline__ const bf16* bn_addr(const bf16* s, int sp, int n0, int ks, int lane) {
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * sp + ks * 16 + ((lane >> 3) & 1) * 8;
}
// B from a tile whose rows are k (ldmatrix.trans): k0..k0+15 by columns
// n0..n0+15, the same register order
__device__ __forceinline__ const bf16* bk_addr(const bf16* s, int sp, int k0, int n0, int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * sp + n0 + (lane >> 4) * 8;
}

// The A operand of a 16-row strip over KS k-steps, in registers when small
// enough (REG) and otherwise read again from shared memory at each use.
template <int KS, bool REG>
struct AStrip {
  uint32_t r[REG ? KS : 1][4];
  const bf16* p;
  __device__ __forceinline__ void init(const bf16* addr) {
    p = addr;
    if constexpr (REG) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(r[ks], addr + ks * 16);
    }
  }
  __device__ __forceinline__ void get(int ks, uint32_t (&a)[4]) const {
    if constexpr (REG) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = r[ks][i];
    } else {
      ldsm_x4(a, p + ks * 16);
    }
  }
};

// Rows [r0, r0 + ROWS) of a row-major [n, d] array into shared-memory rows of
// sp elements: columns d.. and rows past n become zeros (exact in every
// product). vec: d is a multiple of 16 / sizeof(T) and src is 16-byte
// aligned, so each 16-byte chunk goes by cp.async; otherwise the chunk is
// gathered element by element (synchronously). dp: the padded width to fill.
template <typename T, int ROWS>
__device__ __forceinline__ void stage(T* dst, int sp, const T* src, int r0, int n, int d, int dp,
                                      bool vec) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = dp / E;
  for (int i = threadIdx.x; i < ROWS * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i - r * cpr) * E, row = r0 + r;
    T* s = dst + r * sp + c;
    if (vec) {
      const bool ok = row < n && c < d;
      cp_async16(s, ok ? src + (size_t)row * d + c : src, ok);
    } else {
      uint4 u = make_uint4(0, 0, 0, 0);
      T* e = reinterpret_cast<T*>(&u);
      if (row < n) {
#pragma unroll
        for (int j = 0; j < E; ++j)
          if (c + j < d) e[j] = src[(size_t)row * d + c + j];
      }
      *reinterpret_cast<uint4*>(s) = u;
    }
  }
}

// q * scale rounded to bf16, in place, over a staged [ROWS][sp] tile
template <int ROWS>
__device__ __forceinline__ void scale_rows(bf16* s, int sp, int dp, float scale) {
  const int cpr = dp / 8;
  for (int i = threadIdx.x; i < ROWS * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    uint4* p = reinterpret_cast<uint4*>(s + r * sp + c);
    uint4 u = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack2(w[j]);
      w[j] = pack2(f.x * scale, f.y * scale);
    }
    *p = u;
  }
}

// two neighbouring output elements (col, col + 1) of a row of width d
__device__ __forceinline__ void store2(bf16* row, int col, int d, float a, float b) {
  if (col + 1 < d && !(d & 1)) {
    *reinterpret_cast<uint32_t*>(row + col) = pack2(a, b);
  } else {
    if (col < d) row[col] = __float2bfloat16(a);
    if (col + 1 < d) row[col + 1] = __float2bfloat16(b);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the padded head width of the tensor-core kernels: both Dk and Dv are
// zero-padded to one of 32, 64, 128
__host__ __device__ constexpr int mma_width(int dk, int dv) {
  return (dk > dv ? dk : dv) <= 32 ? 32 : (dk > dv ? dk : dv) <= 64 ? 64 : 128;
}

}  // namespace attn
