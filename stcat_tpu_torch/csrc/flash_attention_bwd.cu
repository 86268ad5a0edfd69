// Masked scaled-dot-product attention backward, hand-written for Hopper
// (sm_90a).
//
// Replaces: stcat_tpu/kernels/attention.py::_flash_bwd / _flash_bwd_kernel,
// the Pallas TPU kernel behind flash_attention's VJP. Same function: from
// q [BH, Sq, Dk], k [BH, Sk, Dk], v [BH, Sk, Dv], bias [BH, Sk] fp32 and the
// output gradient g [BH, Sq, Dv] it recomputes the softmax weights (no
// residual of the forward is kept) and returns
//   w      = softmax_j(qs_i . k_j + bias_j),  qs = q * scale rounded to T
//   delta_i = sum_j round(w_ij) (g_i . v_j)        (= rowsum(g * o))
//   ds_ij  = round(w_ij * (g_i . v_j - delta_i))
//   dq     = round(round(ds k) * scale),  dk = round(ds^T qs),
//   dv     = round(round(w)^T g),         dbias_j = round(sum_i ds_ij) (fp32)
// with the TPU kernel's rounding points (round = to the input type T, a no-op
// for fp32) and fp32 accumulation. scale = 1/sqrt(Dk).
//
// What bounds it on this card: at the training path's shapes (S ~ 293,
// d = 32) the work is 2*Sq*Sk*(3*Dk + 3*Dv) flops per head against one read
// of q, k, v, g, bias and one write of dq, dk, dv, dbias -- more flops per
// byte than the bf16 tensor cores need, so the floor is the operations.
// This first version runs on the CUDA cores in fp32 and is far from it.
//
// Design (simple and correct first; tensor cores are later work):
//   * the two reductions run along different axes (dq over keys; dk, dv,
//     dbias over queries), so the tiled path is two kernels with no atomics
//     and a deterministic order:
//     - query pass: one block of 8 warps per (head row, 32-query tile); each
//       warp owns 4 query rows. Three sweeps over 32-key tiles staged in
//       shared memory: (1) the softmax max m and sum l (online), (2) delta,
//       (3) ds and the dq accumulator, where lane c owns column c. It writes
//       dq and the row statistics (m, l, delta) to fp32 scratch [3, BH*Sq].
//     - key pass: one block per (head row, 32-key tile); each warp owns 4
//       keys and sweeps every 32-query tile (q, g and the statistics staged
//       in shared memory), re-forming w from m and l exactly as the query
//       pass does, and accumulates dk, dv and dbias for its keys.
//   * row kernel (Sq < 8, the decoders' Sq = 1 cross-attention): one warp
//     per head row does all of it -- its few query rows fit in registers,
//     so no 32-row tile is wasted and no second pass is needed.
//   * keys past Sk are excluded, not biased: a query row whose real keys are
//     all masked (-1e30) has uniform w over the real Sk keys, as the port's
//     forward and _xla_attention have, and the gradients of that function.
//   * no tile ceiling: Sq and Sk are looped over, so unlike _bwd there is no
//     _BWD_MAX_TILE fallback to an unfused recompute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;           // warps per block, tiled kernels
constexpr int ROWS = 4;            // rows (queries or keys) owned per warp
constexpr int BLK = WARPS * ROWS;  // rows owned per block
constexpr int TILE = 32;           // rows per staged tile: one per lane
constexpr int RW = 4;              // warps per block, row kernel
constexpr int MAXQ = 7;            // row kernel: Sq < 8
constexpr int MAXD = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

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

// Online softmax statistics: fold this lane's logit (-inf = no key) into the
// row's running max m and sum l.
__device__ __forceinline__ void stats_step(float logit, float& m, float& l) {
  const float mn = fmaxf(m, warp_max(logit));
  const float ref = (mn == -INFINITY) ? 0.f : mn;
  l = l * expf(m - ref) + warp_sum(expf(logit - ref));
  m = mn;
}

// w from the row statistics, as _flash_bwd_kernel forms it: p / max(l, 1e-30)
__device__ __forceinline__ float weight(float logit, float m, float l) {
  return expf(logit - m) / fmaxf(l, 1e-30f);
}

// ---------------------------------------------------------------------------
// tiled path, query pass: dq and the row statistics
// ---------------------------------------------------------------------------
template <typename T, int DKM>
__global__ void __launch_bounds__(WARPS * 32)
bwd_query_pass(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ bias, const T* __restrict__ g, T* __restrict__ dq,
               float* __restrict__ stats, int bh_count, int sq, int sk, int dk, int dv,
               float scale) {
  constexpr int DKC = DKM / 32;
  extern __shared__ float smem[];
  const int kst = dk + 1, vst = dv + 1;  // odd strides: lane j's row starts on bank j
  float* qs = smem;                // [BLK][dk], q * scale rounded to T
  float* gs = qs + BLK * dk;       // [BLK][dv]
  float* ks = gs + BLK * dv;       // [TILE][dk + 1]
  float* vs = ks + TILE * kst;     // [TILE][dv + 1]
  float* bs = vs + TILE * vst;     // [TILE]

  const int ntiles = (sq + BLK - 1) / BLK;
  const int bh = blockIdx.x / ntiles;
  const int q0 = (blockIdx.x - bh * ntiles) * BLK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* kb = k + (size_t)bh * sk * dk;
  const T* vb = v + (size_t)bh * sk * dv;
  const float* biasb = bias + (size_t)bh * sk;

  for (int i = tid; i < BLK * dk; i += blockDim.x) {
    const int r = i / dk, d = i - r * dk, qi = q0 + r;
    qs[i] = qi < sq ? rnd<T>(to_f(q[((size_t)bh * sq + qi) * dk + d]) * scale) : 0.f;
  }
  for (int i = tid; i < BLK * dv; i += blockDim.x) {
    const int r = i / dv, d = i - r * dv, qi = q0 + r;
    gs[i] = qi < sq ? to_f(g[((size_t)bh * sq + qi) * dv + d]) : 0.f;
  }
  const float* qrows = qs + warp * ROWS * dk;
  const float* grows = gs + warp * ROWS * dv;

  // stage key tile k0 (and v when with_v); the caller syncs before and after
  auto stage = [&](int k0, bool with_v) {
    for (int i = tid; i < TILE * dk; i += blockDim.x) {
      const int j = i / dk, d = i - j * dk, kj = k0 + j;
      ks[j * kst + d] = kj < sk ? to_f(kb[(size_t)kj * dk + d]) : 0.f;
    }
    if (with_v) {
      for (int i = tid; i < TILE * dv; i += blockDim.x) {
        const int j = i / dv, d = i - j * dv, kj = k0 + j;
        vs[j * vst + d] = kj < sk ? to_f(vb[(size_t)kj * dv + d]) : 0.f;
      }
    }
    if (tid < TILE) bs[tid] = (k0 + tid < sk) ? biasb[k0 + tid] : 0.f;
  };
  // this lane's key: logits for the warp's rows, and g . v when asked
  auto score = [&](float (&s)[ROWS], float (&dp)[ROWS], bool with_v) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = dp[r] = 0.f;
    const float* krow = ks + lane * kst;
    for (int d = 0; d < dk; ++d) {
      const float kv = krow[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = fmaf(qrows[r * dk + d], kv, s[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] += bs[lane];
    if (with_v) {
      const float* vrow = vs + lane * vst;
      for (int d = 0; d < dv; ++d) {
        const float vv = vrow[d];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) dp[r] = fmaf(grows[r * dv + d], vv, dp[r]);
      }
    }
  };

  float m[ROWS], l[ROWS], s[ROWS], dp[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  // sweep 1: softmax statistics
  for (int k0 = 0; k0 < sk; k0 += TILE) {
    __syncthreads();
    stage(k0, false);
    __syncthreads();
    score(s, dp, false);
    const bool present = k0 + lane < sk;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) stats_step(present ? s[r] : -INFINITY, m[r], l[r]);
  }
  // sweep 2: delta_i = sum_j round(w_ij) * (g_i . v_j)
  float delta[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) delta[r] = 0.f;
  for (int k0 = 0; k0 < sk; k0 += TILE) {
    __syncthreads();
    stage(k0, true);
    __syncthreads();
    score(s, dp, true);
    const bool present = k0 + lane < sk;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float w = present ? weight(s[r], m[r], l[r]) : 0.f;
      delta[r] = fmaf(rnd<T>(w), dp[r], delta[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) delta[r] = warp_sum(delta[r]);
  // sweep 3: ds and dq (lane c owns column c)
  float acc[ROWS][DKC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < DKC; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < sk; k0 += TILE) {
    __syncthreads();
    stage(k0, true);
    __syncthreads();
    score(s, dp, true);
    const bool present = k0 + lane < sk;
    float ds[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float w = present ? weight(s[r], m[r], l[r]) : 0.f;
      ds[r] = rnd<T>(w * (dp[r] - delta[r]));
    }
    for (int j = 0; j < TILE; ++j) {
      float dsj[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) dsj[r] = __shfl_sync(FULL, ds[r], j);
      const float* krow = ks + j * kst;
#pragma unroll
      for (int c = 0; c < DKC; ++c) {
        const int col = c * 32 + lane;
        if (col < dk) {
          const float kv = krow[col];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r][c] = fmaf(dsj[r], kv, acc[r][c]);
        }
      }
    }
  }

  const size_t rows_total = (size_t)bh_count * sq;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + warp * ROWS + r;
    if (qi >= sq) continue;
    const size_t row = (size_t)bh * sq + qi;
    T* dqrow = dq + row * dk;
#pragma unroll
    for (int c = 0; c < DKC; ++c) {
      const int col = c * 32 + lane;
      if (col < dk) dqrow[col] = from_f<T>(rnd<T>(acc[r][c]) * scale);
    }
    if (lane == 0) {
      stats[row] = m[r];
      stats[rows_total + row] = l[r];
      stats[2 * rows_total + row] = delta[r];
    }
  }
}

// ---------------------------------------------------------------------------
// tiled path, key pass: dk, dv and dbias
// ---------------------------------------------------------------------------
template <typename T, int DKM, int DVM>
__global__ void __launch_bounds__(WARPS * 32)
bwd_key_pass(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ bias, const T* __restrict__ g,
             const float* __restrict__ stats, T* __restrict__ dk_out, T* __restrict__ dv_out,
             float* __restrict__ dbias, int bh_count, int sq, int sk, int dk, int dv,
             float scale) {
  constexpr int DKC = DKM / 32, DVC = DVM / 32;
  extern __shared__ float smem[];
  const int qst = dk + 1, gst = dv + 1;  // odd strides: lane i's row starts on bank i
  float* ks = smem;                // [BLK][dk], this block's keys
  float* vs = ks + BLK * dk;       // [BLK][dv]
  float* bs = vs + BLK * dv;       // [BLK]
  float* qs = bs + BLK;            // [TILE][dk + 1], q * scale rounded to T
  float* gs = qs + TILE * qst;     // [TILE][dv + 1]
  float* sm = gs + TILE * gst;     // [TILE] m
  float* sl = sm + TILE;           // [TILE] l
  float* sd = sl + TILE;           // [TILE] delta

  const int ntiles = (sk + BLK - 1) / BLK;
  const int bh = blockIdx.x / ntiles;
  const int j0 = (blockIdx.x - bh * ntiles) * BLK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + (size_t)bh * sq * dk;
  const T* gb = g + (size_t)bh * sq * dv;
  const size_t rows_total = (size_t)bh_count * sq;
  const float* mb = stats + (size_t)bh * sq;
  const float* lb = mb + rows_total;
  const float* db = lb + rows_total;

  for (int i = tid; i < BLK * dk; i += blockDim.x) {
    const int j = i / dk, d = i - j * dk, kj = j0 + j;
    ks[i] = kj < sk ? to_f(k[((size_t)bh * sk + kj) * dk + d]) : 0.f;
  }
  for (int i = tid; i < BLK * dv; i += blockDim.x) {
    const int j = i / dv, d = i - j * dv, kj = j0 + j;
    vs[i] = kj < sk ? to_f(v[((size_t)bh * sk + kj) * dv + d]) : 0.f;
  }
  if (tid < BLK) bs[tid] = (j0 + tid < sk) ? bias[(size_t)bh * sk + j0 + tid] : 0.f;
  const float* krows = ks + warp * ROWS * dk;
  const float* vrows = vs + warp * ROWS * dv;
  const float* brows = bs + warp * ROWS;

  float acck[ROWS][DKC], accv[ROWS][DVC], dbp[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    dbp[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DKC; ++c) acck[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < DVC; ++c) accv[r][c] = 0.f;
  }

  for (int i0 = 0; i0 < sq; i0 += TILE) {
    __syncthreads();  // the previous query tile is consumed (and ks is written)
    for (int i = tid; i < TILE * dk; i += blockDim.x) {
      const int r = i / dk, d = i - r * dk, qi = i0 + r;
      qs[r * qst + d] = qi < sq ? rnd<T>(to_f(qb[(size_t)qi * dk + d]) * scale) : 0.f;
    }
    for (int i = tid; i < TILE * dv; i += blockDim.x) {
      const int r = i / dv, d = i - r * dv, qi = i0 + r;
      gs[r * gst + d] = qi < sq ? to_f(gb[(size_t)qi * dv + d]) : 0.f;
    }
    if (tid < TILE) {
      const bool in = i0 + tid < sq;
      sm[tid] = in ? mb[i0 + tid] : 0.f;
      sl[tid] = in ? lb[i0 + tid] : 1.f;
      sd[tid] = in ? db[i0 + tid] : 0.f;
    }
    __syncthreads();

    // lane i scores query i0 + i against the warp's keys
    float s[ROWS], dp[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = dp[r] = 0.f;
    const float* qrow = qs + lane * qst;
    for (int d = 0; d < dk; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = fmaf(qv, krows[r * dk + d], s[r]);
    }
    const float* grow = gs + lane * gst;
    for (int d = 0; d < dv; ++d) {
      const float gv = grow[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) dp[r] = fmaf(gv, vrows[r * dv + d], dp[r]);
    }
    const bool present = i0 + lane < sq;
    float ds[ROWS], wl[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float w = present ? weight(s[r] + brows[r], sm[lane], sl[lane]) : 0.f;
      wl[r] = rnd<T>(w);
      ds[r] = rnd<T>(w * (dp[r] - sd[lane]));
      dbp[r] += ds[r];
    }
    // dk_r += sum_i ds_ir qs_i, dv_r += sum_i wl_ir g_i (lane c owns column c)
    for (int i = 0; i < TILE; ++i) {
      float dsi[ROWS], wli[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        dsi[r] = __shfl_sync(FULL, ds[r], i);
        wli[r] = __shfl_sync(FULL, wl[r], i);
      }
      const float* qi_row = qs + i * qst;
      const float* gi_row = gs + i * gst;
#pragma unroll
      for (int c = 0; c < DKC; ++c) {
        const int col = c * 32 + lane;
        if (col < dk) {
          const float qv = qi_row[col];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acck[r][c] = fmaf(dsi[r], qv, acck[r][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < DVC; ++c) {
        const int col = c * 32 + lane;
        if (col < dv) {
          const float gv = gi_row[col];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) accv[r][c] = fmaf(wli[r], gv, accv[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float dbias_r = warp_sum(dbp[r]);
    const int kj = j0 + warp * ROWS + r;
    if (kj >= sk) continue;
    const size_t row = (size_t)bh * sk + kj;
#pragma unroll
    for (int c = 0; c < DKC; ++c) {
      const int col = c * 32 + lane;
      if (col < dk) dk_out[row * dk + col] = from_f<T>(acck[r][c]);
    }
#pragma unroll
    for (int c = 0; c < DVC; ++c) {
      const int col = c * 32 + lane;
      if (col < dv) dv_out[row * dv + col] = from_f<T>(accv[r][c]);
    }
    if (lane == 0) dbias[row] = rnd<T>(dbias_r);
  }
}

// ---------------------------------------------------------------------------
// row kernel (Sq < 8): one warp per head row computes everything
// ---------------------------------------------------------------------------
template <typename T, int DKM>
__global__ void __launch_bounds__(RW * 32)
bwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const float* __restrict__ bias, const T* __restrict__ g, T* __restrict__ dq,
         T* __restrict__ dk_out, T* __restrict__ dv_out, float* __restrict__ dbias,
         int bh_count, int sq, int sk, int dk, int dv, float scale) {
  constexpr int DKC = DKM / 32;
  __shared__ float qs_all[RW][MAXQ][MAXD];
  __shared__ float gs_all[RW][MAXQ][MAXD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x * RW + warp;
  if (bh >= bh_count) return;  // warp-uniform; no block barrier below
  const T* kb = k + (size_t)bh * sk * dk;
  const T* vb = v + (size_t)bh * sk * dv;
  const float* biasb = bias + (size_t)bh * sk;
  float (*qs)[MAXD] = qs_all[warp];
  float (*gs)[MAXD] = gs_all[warp];
  for (int i = 0; i < sq; ++i) {
    for (int d = lane; d < dk; d += 32)
      qs[i][d] = rnd<T>(to_f(q[((size_t)bh * sq + i) * dk + d]) * scale);
    for (int d = lane; d < dv; d += 32) gs[i][d] = to_f(g[((size_t)bh * sq + i) * dv + d]);
  }
  __syncwarp();

  // this lane's key kj: logits and g . v for every query row
  auto score = [&](int kj, float (&s)[MAXQ], float (&dp)[MAXQ], bool with_v) {
#pragma unroll
    for (int i = 0; i < MAXQ; ++i) s[i] = dp[i] = 0.f;
    if (kj >= sk) return;
    const T* krow = kb + (size_t)kj * dk;
    for (int d = 0; d < dk; ++d) {
      const float kv = to_f(krow[d]);
#pragma unroll
      for (int i = 0; i < MAXQ; ++i)
        if (i < sq) s[i] = fmaf(qs[i][d], kv, s[i]);
    }
    const float b = biasb[kj];
#pragma unroll
    for (int i = 0; i < MAXQ; ++i) s[i] += b;
    if (with_v) {
      const T* vrow = vb + (size_t)kj * dv;
      for (int d = 0; d < dv; ++d) {
        const float vv = to_f(vrow[d]);
#pragma unroll
        for (int i = 0; i < MAXQ; ++i)
          if (i < sq) dp[i] = fmaf(gs[i][d], vv, dp[i]);
      }
    }
  };

  float m[MAXQ], l[MAXQ], s[MAXQ], dp[MAXQ], delta[MAXQ];
#pragma unroll
  for (int i = 0; i < MAXQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    delta[i] = 0.f;
  }
  for (int k0 = 0; k0 < sk; k0 += 32) {
    const int kj = k0 + lane;
    score(kj, s, dp, false);
#pragma unroll
    for (int i = 0; i < MAXQ; ++i)
      if (i < sq) stats_step(kj < sk ? s[i] : -INFINITY, m[i], l[i]);
  }
  for (int k0 = 0; k0 < sk; k0 += 32) {
    const int kj = k0 + lane;
    score(kj, s, dp, true);
#pragma unroll
    for (int i = 0; i < MAXQ; ++i) {
      const float w = (i < sq && kj < sk) ? weight(s[i], m[i], l[i]) : 0.f;
      delta[i] = fmaf(rnd<T>(w), dp[i], delta[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < MAXQ; ++i) delta[i] = warp_sum(delta[i]);

  float acc[MAXQ][DKC];
#pragma unroll
  for (int i = 0; i < MAXQ; ++i)
#pragma unroll
    for (int c = 0; c < DKC; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < sk; k0 += 32) {
    const int kj = k0 + lane;
    score(kj, s, dp, true);
    float ds[MAXQ], wl[MAXQ], dsum = 0.f;
#pragma unroll
    for (int i = 0; i < MAXQ; ++i) {
      const float w = (i < sq && kj < sk) ? weight(s[i], m[i], l[i]) : 0.f;
      wl[i] = rnd<T>(w);
      ds[i] = rnd<T>(w * (dp[i] - delta[i]));
      dsum += ds[i];
    }
    if (kj < sk) dbias[(size_t)bh * sk + kj] = rnd<T>(dsum);
    const int nk = min(32, sk - k0);
    for (int j = 0; j < nk; ++j) {
      float dsj[MAXQ], wlj[MAXQ];
#pragma unroll
      for (int i = 0; i < MAXQ; ++i) {
        dsj[i] = __shfl_sync(FULL, ds[i], j);
        wlj[i] = __shfl_sync(FULL, wl[i], j);
      }
      const size_t krow_i = (size_t)(k0 + j);
      const T* krow = kb + krow_i * dk;
      T* dkrow = dk_out + ((size_t)bh * sk + krow_i) * dk;
      T* dvrow = dv_out + ((size_t)bh * sk + krow_i) * dv;
#pragma unroll
      for (int c = 0; c < DKC; ++c) {
        const int col = c * 32 + lane;
        if (col < dk) {
          const float kv = to_f(krow[col]);
          float dkv = 0.f;
#pragma unroll
          for (int i = 0; i < MAXQ; ++i) {
            acc[i][c] = fmaf(dsj[i], kv, acc[i][c]);
            if (i < sq) dkv = fmaf(dsj[i], qs[i][col], dkv);
          }
          dkrow[col] = from_f<T>(dkv);
        }
      }
      for (int col = lane; col < dv; col += 32) {
        float dvv = 0.f;
#pragma unroll
        for (int i = 0; i < MAXQ; ++i)
          if (i < sq) dvv = fmaf(wlj[i], gs[i][col], dvv);
        dvrow[col] = from_f<T>(dvv);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MAXQ; ++i) {
    if (i >= sq) break;
    T* dqrow = dq + ((size_t)bh * sq + i) * dk;
#pragma unroll
    for (int c = 0; c < DKC; ++c) {
      const int col = c * 32 + lane;
      if (col < dk) dqrow[col] = from_f<T>(rnd<T>(acc[i][c]) * scale);
    }
  }
}

template <typename T, int DKM, int DVM>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const void* g, void* dq, void* dk_out, void* dv_out, float* dbias,
                   float* stats, int bh, int sq, int sk, int dk, int dv, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)dk);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  T* dqp = static_cast<T*>(dq);
  T* dkp = static_cast<T*>(dk_out);
  T* dvp = static_cast<T*>(dv_out);
  if (sq <= MAXQ) {
    dim3 grid((bh + RW - 1) / RW);
    bwd_rows<T, DKM><<<grid, RW * 32, 0, stream>>>(qp, kp, vp, bias, gp, dqp, dkp, dvp, dbias,
                                                   bh, sq, sk, dk, dv, scale);
    return cudaGetLastError();
  }
  const size_t smem_q = sizeof(float) * ((size_t)BLK * (dk + dv) +
                                         (size_t)TILE * (dk + 1 + dv + 1) + TILE);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_query_pass<T, DKM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  dim3 grid_q(((sq + BLK - 1) / BLK) * bh);
  bwd_query_pass<T, DKM><<<grid_q, WARPS * 32, smem_q, stream>>>(
      qp, kp, vp, bias, gp, dqp, stats, bh, sq, sk, dk, dv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_k = sizeof(float) * ((size_t)BLK * (dk + dv + 1) +
                                         (size_t)TILE * (dk + 1 + dv + 1) + 3 * TILE);
  err = cudaFuncSetAttribute(bwd_key_pass<T, DKM, DVM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_k);
  if (err != cudaSuccess) return err;
  dim3 grid_k(((sk + BLK - 1) / BLK) * bh);
  bwd_key_pass<T, DKM, DVM><<<grid_k, WARPS * 32, smem_k, stream>>>(
      qp, kp, vp, bias, gp, stats, dkp, dvp, dbias, bh, sq, sk, dk, dv, scale);
  return cudaGetLastError();
}

template <typename T, int DKM>
cudaError_t dispatch_dv(const void* q, const void* k, const void* v, const float* bias,
                        const void* g, void* dq, void* dk_out, void* dv_out, float* dbias,
                        float* stats, int bh, int sq, int sk, int dk, int dv, cudaStream_t s) {
  if (dv <= 32)
    return launch<T, DKM, 32>(q, k, v, bias, g, dq, dk_out, dv_out, dbias, stats, bh, sq, sk,
                              dk, dv, s);
  if (dv <= 64)
    return launch<T, DKM, 64>(q, k, v, bias, g, dq, dk_out, dv_out, dbias, stats, bh, sq, sk,
                              dk, dv, s);
  return launch<T, DKM, 128>(q, k, v, bias, g, dq, dk_out, dv_out, dbias, stats, bh, sq, sk,
                             dk, dv, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* bias,
                     const void* g, void* dq, void* dk_out, void* dv_out, float* dbias,
                     float* stats, int bh, int sq, int sk, int dk, int dv, cudaStream_t s) {
  if (dk <= 32)
    return dispatch_dv<T, 32>(q, k, v, bias, g, dq, dk_out, dv_out, dbias, stats, bh, sq, sk,
                              dk, dv, s);
  if (dk <= 64)
    return dispatch_dv<T, 64>(q, k, v, bias, g, dq, dk_out, dv_out, dbias, stats, bh, sq, sk,
                              dk, dv, s);
  return dispatch_dv<T, 128>(q, k, v, bias, g, dq, dk_out, dv_out, dbias, stats, bh, sq, sk,
                             dk, dv, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. stats: fp32 scratch of 3 * BH * Sq floats
// (unused when Sq < 8). Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* g, void* dq, void* dk,
                                   void* dv, void* dbias, void* stats, int bh, int sq, int sk,
                                   int dkd, int dvd, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || dkd <= 0 || dvd <= 0 || dkd > MAXD || dvd > MAXD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* db = static_cast<float*>(dbias);
  float* st = static_cast<float*>(stats);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, b, g, dq, dk, dv, db, st, bh, sq, sk, dkd, dvd, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, b, g, dq, dk, dv, db, st, bh, sq, sk, dkd,
                                        dvd, s);
  return (int)cudaErrorInvalidValue;
}
