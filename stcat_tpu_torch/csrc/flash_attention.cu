// Masked scaled-dot-product attention forward (flash style), hand-written
// for Hopper (sm_90a).
//
// Replaces: stcat_tpu/kernels/attention.py::_flash_fwd / _flash_fwd_kernel,
// the Pallas TPU kernel behind flash_attention. Same function:
//   out[b, i, :] = softmax_j(scale * q[b, i] . k[b, j] + bias[b, j]) v[b, j, :]
// q [BH, Sq, Dk], k [BH, Sk, Dk], v [BH, Sk, Dv] (Dv may differ from Dk),
// bias [BH, Sk] fp32 (0 = attend, -1e30 = masked), scale = 1/sqrt(Dk); fp32
// online softmax and accumulation; out [BH, Sq, Dv] in the input type.
//
// What bounds it on this card: at the main path's shapes (S ~ 293, d = 32)
// the work is ~2*S*(Dk+Dv) flops per query row against ~(2*Dk + 2*Dv) bytes
// per row of q/out plus one read of K/V per head -- about 100-300 flops per
// byte, under the ~295 the tensor cores need, so the floor is the bytes:
// read q, k, v and bias once and write out once. The [Sq, Sk] weight
// matrix never touches device memory.
//
// Design (a simple, correct first version; wgmma/TMA are later work):
//   * tiled kernel (Sq >= 8): one block of 8 warps per (head row, 32-query
//     tile). The block stages each 32-key tile of K and V in shared memory
//     (fp32) once and all 32 query rows reuse it; every warp owns 4 query
//     rows and keeps their running max, sum and Dv accumulator in registers.
//     Lane j scores key j of the tile; p_j reaches the other lanes through
//     warp shuffles for the P.V update, where lane c owns output column c.
//   * row kernel (Sq < 8, e.g. the decoders' Sq = 1 cross-attention): one
//     warp per (head row, query row), several head rows per block, K and V
//     read straight from global memory -- no 32-row tile is wasted on a
//     single query.
//   * keys past Sk (the ragged edge) are excluded, not biased: a query row
//     whose real keys are all masked (-1e30) gets the uniform average over
//     the real Sk keys, as the plain torch version and _xla_attention do.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int KT = 32;            // keys per tile: one per lane
constexpr int ROWS = 4;           // query rows per warp (tiled kernel)
constexpr int QT = WARPS * ROWS;  // query rows per block (tiled kernel)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// One online-softmax step for one query row: `logit` is this lane's key
// score (-inf when the lane has no key). Returns p for this lane and rescales
// l; the caller rescales its accumulator by the returned alpha.
__device__ __forceinline__ float softmax_step(float logit, float& m, float& l,
                                              float& alpha) {
  const float mn = fmaxf(m, warp_max(logit));
  const float ref = (mn == -INFINITY) ? 0.f : mn;
  const float p = expf(logit - ref);
  alpha = expf(m - ref);
  l = l * alpha + warp_sum(p);
  m = mn;
  return p;
}

template <typename T, int DVM>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_tiled(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                T* __restrict__ out, int sq, int sk, int dk, int dv, float scale) {
  constexpr int DVC = DVM / 32;
  extern __shared__ float smem[];
  const int kstride = dk + 1;     // odd stride: lane j's row starts on bank j
  float* qs = smem;               // [QT][dk], pre-scaled
  float* ks = qs + QT * dk;       // [KT][dk + 1]
  float* vs = ks + KT * kstride;  // [KT][DVM]
  float* bs = vs + KT * DVM;      // [KT]

  const int ntiles = (sq + QT - 1) / QT;
  const int bh = blockIdx.x / ntiles;
  const int q0 = (blockIdx.x - bh * ntiles) * QT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + (size_t)bh * sq * dk;
  const T* kb = k + (size_t)bh * sk * dk;
  const T* vb = v + (size_t)bh * sk * dv;
  const float* biasb = bias + (size_t)bh * sk;

  for (int i = tid; i < QT * dk; i += blockDim.x) {
    const int r = i / dk, d = i - r * dk, qi = q0 + r;
    qs[i] = qi < sq ? to_f(qb[(size_t)qi * dk + d]) * scale : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DVC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DVC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += KT) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < KT * dk; i += blockDim.x) {
      const int j = i / dk, d = i - j * dk, kj = k0 + j;
      ks[j * kstride + d] = kj < sk ? to_f(kb[(size_t)kj * dk + d]) : 0.f;
    }
    for (int i = tid; i < KT * DVM; i += blockDim.x) {
      const int j = i / DVM, c = i - j * DVM, kj = k0 + j;
      vs[i] = (kj < sk && c < dv) ? to_f(vb[(size_t)kj * dv + c]) : 0.f;
    }
    if (tid < KT) bs[tid] = (k0 + tid < sk) ? biasb[k0 + tid] : 0.f;
    __syncthreads();

    const bool present = k0 + lane < sk;
    const float* krow = ks + lane * kstride;
    const float* qrow = qs + warp * ROWS * dk;
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    for (int d = 0; d < dk; ++d) {
      const float kv = krow[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = fmaf(qrow[r * dk + d], kv, s[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float logit = present ? s[r] + bs[lane] : -INFINITY;
      float alpha;
      const float p = softmax_step(logit, m[r], l[r], alpha);
#pragma unroll
      for (int c = 0; c < DVC; ++c) acc[r][c] *= alpha;
      for (int j = 0; j < KT; ++j) {
        const float pj = __shfl_sync(FULL, p, j);
        const float* vrow = vs + j * DVM + lane;
#pragma unroll
        for (int c = 0; c < DVC; ++c) acc[r][c] = fmaf(pj, vrow[c * 32], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + warp * ROWS + r;
    if (qi >= sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = out + ((size_t)bh * sq + qi) * dv;
#pragma unroll
    for (int c = 0; c < DVC; ++c) {
      const int col = c * 32 + lane;
      if (col < dv) orow[col] = from_f<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int DVM>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_rows(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ bias,
               T* __restrict__ out, int rows, int sq, int sk, int dk, int dv,
               float scale) {
  constexpr int DVC = DVM / 32;
  __shared__ float qs_all[WARPS][128];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + warp;  // = bh * sq + query index
  if (row >= rows) return;                    // warp-uniform; no block barrier below
  const int bh = row / sq;
  const T* kb = k + (size_t)bh * sk * dk;
  const T* vb = v + (size_t)bh * sk * dv;
  const float* biasb = bias + (size_t)bh * sk;
  float* qs = qs_all[warp];
  for (int d = lane; d < dk; d += 32) qs[d] = to_f(q[(size_t)row * dk + d]) * scale;
  __syncwarp();

  float m = -INFINITY, l = 0.f, acc[DVC];
#pragma unroll
  for (int c = 0; c < DVC; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += KT) {
    const int kj = k0 + lane;
    float logit = -INFINITY;
    if (kj < sk) {
      const T* krow = kb + (size_t)kj * dk;
      float s = 0.f;
      for (int d = 0; d < dk; ++d) s = fmaf(qs[d], to_f(krow[d]), s);
      logit = s + biasb[kj];
    }
    float alpha;
    const float p = softmax_step(logit, m, l, alpha);
#pragma unroll
    for (int c = 0; c < DVC; ++c) acc[c] *= alpha;
    const int nk = min(KT, sk - k0);
    for (int j = 0; j < nk; ++j) {
      const float pj = __shfl_sync(FULL, p, j);
      const T* vrow = vb + (size_t)(k0 + j) * dv;
#pragma unroll
      for (int c = 0; c < DVC; ++c) {
        const int col = c * 32 + lane;
        if (col < dv) acc[c] = fmaf(pj, to_f(vrow[col]), acc[c]);
      }
    }
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = out + (size_t)row * dv;
#pragma unroll
  for (int c = 0; c < DVC; ++c) {
    const int col = c * 32 + lane;
    if (col < dv) orow[col] = from_f<T>(acc[c] * inv);
  }
}

template <typename T, int DVM>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   void* out, int bh, int sq, int sk, int dk, int dv,
                   cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)dk);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (sq < 8) {
    const int rows = bh * sq;
    dim3 grid((rows + WARPS - 1) / WARPS);
    flash_fwd_rows<T, DVM><<<grid, WARPS * 32, 0, stream>>>(
        qp, kp, vp, bias, op, rows, sq, sk, dk, dv, scale);
  } else {
    const size_t smem =
        sizeof(float) * ((size_t)QT * dk + (size_t)KT * (dk + 1) + (size_t)KT * DVM + KT);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tiled<T, DVM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(((sq + QT - 1) / QT) * bh);
    flash_fwd_tiled<T, DVM><<<grid, WARPS * 32, smem, stream>>>(
        qp, kp, vp, bias, op, sq, sk, dk, dv, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dv(const void* q, const void* k, const void* v, const float* bias,
                        void* out, int bh, int sq, int sk, int dk, int dv,
                        cudaStream_t s) {
  if (dv <= 32) return launch<T, 32>(q, k, v, bias, out, bh, sq, sk, dk, dv, s);
  if (dv <= 64) return launch<T, 64>(q, k, v, bias, out, bh, sq, sk, dk, dv, s);
  return launch<T, 128>(q, k, v, bias, out, bh, sq, sk, dk, dv, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int bh, int sq, int sk,
                                   int dk, int dv, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || dk <= 0 || dv <= 0 || dk > 128 || dv > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return (int)dispatch_dv<float>(q, k, v, b, out, bh, sq, sk, dk, dv, s);
  if (dtype == 1)
    return (int)dispatch_dv<__nv_bfloat16>(q, k, v, b, out, bh, sq, sk, dk, dv, s);
  return (int)cudaErrorInvalidValue;
}
