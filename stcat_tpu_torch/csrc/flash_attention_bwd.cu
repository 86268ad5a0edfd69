// Masked scaled-dot-product attention backward, hand-written for Hopper
// (sm_90a).
//
// Replaces: stcat_tpu/kernels/attention.py::_flash_bwd / _flash_bwd_kernel,
// the Pallas TPU kernel behind flash_attention's VJP. Same function: from
// q [BH, Sq, Dk], k [BH, Sk, Dk], v [BH, Sk, Dv], bias [BH, Sk] fp32 and the
// output gradient g [BH, Sq, Dv] it recomputes the softmax weights (no
// residual of the forward is kept) and returns
//   w      = softmax_j(qs_i . k_j + bias_j),  qs = q * scale rounded to T
//   o_i    = sum_j round(w_ij) v_j,  delta_i = g_i . o_i
//   ds_ij  = round(w_ij * (g_i . v_j - delta_i))
//   dq     = round(round(ds k) * scale),  dk = round(ds^T qs),
//   dv     = round(round(w)^T g),         dbias_j = round(sum_i ds_ij) (fp32)
// with the TPU kernel's rounding points (round = to the input type T, a no-op
// for fp32) and fp32 accumulation. scale = 1/sqrt(Dk).
//
// What bounds it on this card: at the training path's shapes (S ~ 293,
// d = 32) one read of q, k, v, g, bias and one write of dq, dk, dv, dbias
// (~0.02 ms per encoder call) against 2*Sq*Sk*(3*Dk + 3*Dv) flops (~0.01 ms
// on the bf16 tensor cores): the bytes, closely followed by the products and
// the exponentials, which the kernels below recompute three times in the
// query pass and once more in the key pass.
//
// Kernels, chosen by the host (flash_attention_bwd below); none uses
// atomics, so every result is bitwise reproducible:
//   * bf16, Sq >= 8: two tensor-core passes on mma.sync.m16n8k16 (bf16 in,
//     fp32 accumulate), the fragment scheme of flash_attention.cu's
//     flash_fwd_mma (see attention_mma.cuh), head widths zero-padded to 32,
//     64 or 128 (exact):
//     - bwd_query_mma: one block of 4 warps per (head row, 64-query tile);
//       each warp owns a 16-query strip, its Qs and G strips as A operands.
//       K/V stream in 64-key tiles (double-buffered 16-byte cp.async) through
//       three sweeps: (1) the softmax max m and sum l; (2) o = round(w) V on
//       the tensor cores, then delta = rowsum(g * o) in fp32, the form of
//       _flash_bwd_kernel and of the plain version; (3) dP = G V^T,
//       ds = round(w * (dP - delta)) repacked in registers as the A operand
//       of dq += ds K. It writes dq and the row statistics (m in base-2
//       units, 1/l, delta) to fp32 scratch [3, BH*Sq].
//     - bwd_key_mma: one block per (head row, 64-key tile); each warp owns a
//       16-key strip of K and V as A operands and streams 64-query tiles of
//       Qs, G and the statistics: S^T = K Qs^T, W^T from the statistics,
//       dV += round(W)^T G, dP^T = V G^T, dS^T, dK += dS^T Qs and the fp32
//       row sums of dS^T (dbias), all in registers.
//   * fp32, Sq >= 8: the CUDA-core passes of the first version (the tensor
//     cores would need TF32, which changes results): bwd_query_pass (one
//     block of 8 warps per 32-query tile, three sweeps over 32-key tiles
//     staged in fp32) and bwd_key_pass (per 32-key block).
//   * bwd_rows (both types, Sq < 8: the decoders' Sq = 1 cross-attention):
//     bytes-bound. One block per head row; 64-key tiles of K and V arrive by
//     16-byte cp.async (double-buffered) through three sweeps: statistics,
//     delta, then ds. Thread j of the first two warps scores key j for every
//     query row; the block merges the statistics in shared memory; then each
//     thread owns elements of the tile's dk and dv rows (coalesced stores)
//     and of dq, whose sums run over the keys in one fixed order.
//   * keys past Sk are excluded, not biased: a query row whose real keys are
//     all masked (-1e30) has uniform w over the real Sk keys, as the port's
//     forward and _xla_attention have, and the gradients of that function.
//   * no tile ceiling: Sq and Sk are looped over, so unlike _bwd there is no
//     _BWD_MAX_TILE fallback to an unfused recompute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using attn::bf16;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;           // warps per block, fp32 two-pass kernels
constexpr int ROWS = 4;            // rows (queries or keys) owned per warp
constexpr int BLK = WARPS * ROWS;  // rows owned per block
constexpr int TILE = 32;           // rows per staged tile: one per lane
constexpr int MW = 4;              // warps per block, tensor-core kernels
constexpr int MQ = 16 * MW;        // queries per block (query pass) or per tile (key pass)
constexpr int MK = 64;             // keys per tile (query pass) or per block (key pass)
constexpr int RT = 128;            // threads per block, row kernel
constexpr int NW = RT / 32;
constexpr int RK = 64;             // keys per tile, row kernel: one per thread of warps 0-1
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

// dynamic shared memory of each kernel (mirrored by the Python launch plan,
// kernels/attention.py::plan)
size_t query_mma_smem(int d) {
  const int sp = d + 8;
  return (size_t)2 * MQ * sp * 2 + 2 * ((size_t)2 * MK * sp * 2 + MK * 4);
}
size_t key_mma_smem(int d) {
  const int sp = d + 8;
  return (size_t)2 * MK * sp * 2 + 2 * ((size_t)2 * MQ * sp * 2 + 3 * MQ * 4);
}
size_t query_pass_smem(int dk, int dv) {
  return sizeof(float) * ((size_t)BLK * (dk + dv) + (size_t)TILE * (dk + 1 + dv + 1) + TILE);
}
size_t key_pass_smem(int dk, int dv) {
  return sizeof(float) * ((size_t)BLK * (dk + dv + 1) + (size_t)TILE * (dk + 1 + dv + 1) + 3 * TILE);
}
size_t rows_smem(int dk, int dv, int isz) {
  const int e = 16 / isz, dkp = (dk + e - 1) / e * e, dvp = (dv + e - 1) / e * e;
  const size_t stage = (size_t)RK * (dkp + e + dvp + e) * isz + RK * 4;
  return 2 * stage + 4 * ((size_t)2 * MAXQ * MAXD + 2 * MAXQ * RK + 3 * MAXQ * NW);
}

// ---------------------------------------------------------------------------
// tensor-core query pass (bf16, Sq >= 8): dq and the row statistics
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(MW * 32)
bwd_query_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const float* __restrict__ bias, const bf16* __restrict__ g, bf16* __restrict__ dq,
              float* __restrict__ stats, int bh_count, int sq, int sk, int dk, int dv,
              float scale, int vec) {
  constexpr int SP = D + 8, KS = D / 16, ND = D / 8;
  constexpr bool REG = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [MQ][SP], q * scale rounded
  bf16* gs = qs + MQ * SP;                        // [MQ][SP]
  constexpr size_t STAGE = (size_t)2 * MK * SP * 2 + MK * 4;
  auto kbuf = [&](int s) {
    return reinterpret_cast<bf16*>(smem_raw + 2 * MQ * SP * 2 + s * STAGE);
  };
  auto vbuf = [&](int s) { return kbuf(s) + MK * SP; };
  auto bbuf = [&](int s) { return reinterpret_cast<float*>(kbuf(s) + 2 * MK * SP); };

  const int ntq = (sq + MQ - 1) / MQ;
  const int bh = blockIdx.x / ntq;
  const int q0 = (blockIdx.x - bh * ntq) * MQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* kb = k + (size_t)bh * sk * dk;
  const bf16* vb = v + (size_t)bh * sk * dv;
  const float* biasb = bias + (size_t)bh * sk;
  const int nt = (sk + MK - 1) / MK, nit = 3 * nt;

  // iteration it = sweep * nt + tile; sweep 0 needs no V
  auto load = [&](int it) {
    const int s = it & 1, k0 = (it % nt) * MK;
    attn::stage<bf16, MK>(kbuf(s), SP, kb, k0, sk, dk, D, vec);
    if (it >= nt) attn::stage<bf16, MK>(vbuf(s), SP, vb, k0, sk, dv, D, vec);
    if (tid < MK) {
      if (k0 + tid < sk) attn::cp_async4(bbuf(s) + tid, biasb + k0 + tid);
      else bbuf(s)[tid] = -INFINITY;  // past Sk: excluded
    }
    attn::cp_commit();
  };

  attn::stage<bf16, MQ>(qs, SP, q + (size_t)bh * sq * dk, q0, sq, dk, D, vec);
  attn::stage<bf16, MQ>(gs, SP, g + (size_t)bh * sq * dv, q0, sq, dv, D, vec);
  load(0);
  attn::cp_wait<0>();
  __syncthreads();
  attn::scale_rows<MQ>(qs, SP, D, scale);
  __syncthreads();

  const bool active = q0 + warp * 16 < sq;  // warp-uniform: a strip past Sq idles
  attn::AStrip<KS, REG> qa, ga;
  qa.init(attn::a_addr(qs, SP, warp * 16, lane));
  ga.init(attn::a_addr(gs, SP, warp * 16, lane));
  // rows lane/4 and lane/4 + 8 of the strip
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, linv[2] = {0.f, 0.f};
  float delta[2] = {0.f, 0.f};
  float acc[ND][4];  // o in sweep 2, dq in sweep 3
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < nit; ++it) {
    attn::cp_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < nit) load(it + 1);
    if (!active) continue;
    const int sweep = it / nt, t = it - sweep * nt;
    const bf16* ks = kbuf(it & 1);
    const bf16* vs = vbuf(it & 1);
    const float* bs = bbuf(it & 1);

    // logits of 64 keys in base 2: 8 C tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks_ = 0; ks_ < KS; ++ks_) {
      uint32_t a[4];
      qa.get(ks_, a);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        attn::ldsm_x4(b, attn::bn_addr(ks, SP, jp * 16, ks_, lane));
        attn::mma(s[2 * jp], a, b[0], b[1]);
        attn::mma(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = attn::log2_logit(s[n][e], bs[n * 8 + (lane & 3) * 2 + (e & 1)]);

    if (sweep == 0) {  // (1) online max and sum
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = attn::quad_max(mx[r]);
        l[r] *= exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[n][e] - m[e >> 1]);
      if (t == nt - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) linv[r] = 1.f / fmaxf(attn::quad_sum(l[r]), 1e-30f);
      }
      continue;
    }
    // w = exp2(x - m) / l
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = exp2f(s[n][e] - m[e >> 1]) * linv[e >> 1];

    if (sweep == 1) {  // (2) o = round(w) V, then delta = rowsum(g * o)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t wa[4] = {attn::pack2(s[2 * kk][0], s[2 * kk][1]),
                                attn::pack2(s[2 * kk][2], s[2 * kk][3]),
                                attn::pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                attn::pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t b[4];
          attn::ldsm_x4_t(b, attn::bk_addr(vs, SP, kk * 16, np * 16, lane));
          attn::mma(acc[2 * np], wa, b[0], b[1]);
          attn::mma(acc[2 * np + 1], wa, b[2], b[3]);
        }
      }
      if (t == nt - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bf16* grow = gs + (warp * 16 + (lane >> 2) + 8 * r) * SP + (lane & 3) * 2;
          float d = 0.f;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            const float2 gg = attn::unpack2(*reinterpret_cast<const uint32_t*>(grow + n * 8));
            d = fmaf(gg.x, acc[n][2 * r], fmaf(gg.y, acc[n][2 * r + 1], d));
          }
          delta[r] = attn::quad_sum(d);
        }
#pragma unroll
        for (int n = 0; n < ND; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      }
      continue;
    }
    // (3) per 16 keys: dP = G V^T, ds = round(w * (dP - delta)), dq += ds K
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks_ = 0; ks_ < KS; ++ks_) {
        uint32_t a[4], b[4];
        ga.get(ks_, a);
        attn::ldsm_x4(b, attn::bn_addr(vs, SP, kk * 16, ks_, lane));
        attn::mma(dp[0], a, b[0], b[1]);
        attn::mma(dp[1], a, b[2], b[3]);
      }
      float ds[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[h][e] = s[2 * kk + h][e] * (dp[h][e] - delta[e >> 1]);
      const uint32_t da[4] = {attn::pack2(ds[0][0], ds[0][1]), attn::pack2(ds[0][2], ds[0][3]),
                              attn::pack2(ds[1][0], ds[1][1]), attn::pack2(ds[1][2], ds[1][3])};
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t b[4];
        attn::ldsm_x4_t(b, attn::bk_addr(ks, SP, kk * 16, np * 16, lane));
        attn::mma(acc[2 * np], da, b[0], b[1]);
        attn::mma(acc[2 * np + 1], da, b[2], b[3]);
      }
    }
  }

  if (!active) return;
  const size_t rows_total = (size_t)bh_count * sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + (lane >> 2) + 8 * r;
    if (qi >= sq) continue;
    const size_t row = (size_t)bh * sq + qi;
    bf16* dqrow = dq + row * dk;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      attn::store2(dqrow, n * 8 + (lane & 3) * 2, dk, rnd<bf16>(acc[n][2 * r]) * scale,
                   rnd<bf16>(acc[n][2 * r + 1]) * scale);
    if ((lane & 3) == 0) {
      stats[row] = m[r];
      stats[rows_total + row] = linv[r];
      stats[2 * rows_total + row] = delta[r];
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core key pass (bf16, Sq >= 8): dk, dv and dbias
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(MW * 32)
bwd_key_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const float* __restrict__ bias, const bf16* __restrict__ g,
            const float* __restrict__ stats, bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
            float* __restrict__ dbias, int bh_count, int sq, int sk, int dk, int dv, float scale,
            int vec) {
  constexpr int SP = D + 8, KS = D / 16, ND = D / 8;
  constexpr bool REG = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [MK][SP], this block's keys
  bf16* vs = ks + MK * SP;                        // [MK][SP]
  constexpr size_t STAGE = (size_t)2 * MQ * SP * 2 + 3 * MQ * 4;
  auto qbuf = [&](int s) {
    return reinterpret_cast<bf16*>(smem_raw + 2 * MK * SP * 2 + s * STAGE);
  };
  auto gbuf = [&](int s) { return qbuf(s) + MQ * SP; };
  auto stbuf = [&](int s) { return reinterpret_cast<float*>(qbuf(s) + 2 * MQ * SP); };

  const int ntk = (sk + MK - 1) / MK;
  const int bh = blockIdx.x / ntk;
  const int j0 = (blockIdx.x - bh * ntk) * MK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* qb = q + (size_t)bh * sq * dk;
  const bf16* gb = g + (size_t)bh * sq * dv;
  const size_t rows_total = (size_t)bh_count * sq;
  const float* mb = stats + (size_t)bh * sq;
  const float* lb = mb + rows_total;
  const float* db = lb + rows_total;
  const int nt = (sq + MQ - 1) / MQ;

  auto load = [&](int t) {  // query tile t: Qs, G and the statistics (m, 1/l, delta)
    const int s = t & 1, i0 = t * MQ;
    attn::stage<bf16, MQ>(qbuf(s), SP, qb, i0, sq, dk, D, vec);
    attn::stage<bf16, MQ>(gbuf(s), SP, gb, i0, sq, dv, D, vec);
    if (tid < MQ) {
      float* st = stbuf(s);
      if (i0 + tid < sq) {
        attn::cp_async4(st + tid, mb + i0 + tid);
        attn::cp_async4(st + MQ + tid, lb + i0 + tid);
        attn::cp_async4(st + 2 * MQ + tid, db + i0 + tid);
      } else {  // past Sq: w = exp2(x - inf) * 0 = 0
        st[tid] = INFINITY;
        st[MQ + tid] = 0.f;
        st[2 * MQ + tid] = 0.f;
      }
    }
    attn::cp_commit();
  };

  attn::stage<bf16, MK>(ks, SP, k + (size_t)bh * sk * dk, j0, sk, dk, D, vec);
  attn::stage<bf16, MK>(vs, SP, v + (size_t)bh * sk * dv, j0, sk, dv, D, vec);
  load(0);
  attn::cp_wait<0>();
  __syncthreads();

  const bool active = j0 + warp * 16 < sk;  // warp-uniform: a strip past Sk idles
  attn::AStrip<KS, REG> ka, va;
  ka.init(attn::a_addr(ks, SP, warp * 16, lane));
  va.init(attn::a_addr(vs, SP, warp * 16, lane));
  // this lane's key rows lane/4 and lane/4 + 8: bias (-inf past Sk)
  float bk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = j0 + warp * 16 + (lane >> 2) + 8 * r;
    bk[r] = kj < sk ? bias[(size_t)bh * sk + kj] : -INFINITY;
  }
  float dka[ND][4], dva[ND][4], dbs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    attn::cp_wait<0>();
    __syncthreads();  // tile t landed; everyone is done with tile t - 1
    if (t + 1 < nt) load(t + 1);
    bf16* qs = qbuf(t & 1);
    const bf16* gs = gbuf(t & 1);
    const float* st = stbuf(t & 1);
    attn::scale_rows<MQ>(qs, SP, D, scale);
    __syncthreads();
    if (!active) continue;

    // 16 queries at a time; at D = 128 one chunk at a time, or the two
    // 16 x 128 accumulators and an unrolled neighbour exceed 255 registers
#pragma unroll(D > 64 ? 1 : MQ / 16)
    for (int c = 0; c < MQ / 16; ++c) {
      float sT[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dpT[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks_ = 0; ks_ < KS; ++ks_) {
        uint32_t a[4], b[4];
        ka.get(ks_, a);
        attn::ldsm_x4(b, attn::bn_addr(qs, SP, c * 16, ks_, lane));
        attn::mma(sT[0], a, b[0], b[1]);
        attn::mma(sT[1], a, b[2], b[3]);
        va.get(ks_, a);
        attn::ldsm_x4(b, attn::bn_addr(gs, SP, c * 16, ks_, lane));
        attn::mma(dpT[0], a, b[0], b[1]);
        attn::mma(dpT[1], a, b[2], b[3]);
      }
      // element (h, e): key row lane/4 + 8 (e / 2), query c*16 + h*8 + 2 (lane % 4) + e % 2
      float w[2][4], ds[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c * 16 + h * 8 + (lane & 3) * 2 + (e & 1);
          const float x = attn::log2_logit(sT[h][e], bk[e >> 1]);
          w[h][e] = exp2f(x - st[qc]) * st[MQ + qc];
          ds[h][e] = rnd<bf16>(w[h][e] * (dpT[h][e] - st[2 * MQ + qc]));
          dbs[e >> 1] += ds[h][e];
        }
      const uint32_t wa[4] = {attn::pack2(w[0][0], w[0][1]), attn::pack2(w[0][2], w[0][3]),
                              attn::pack2(w[1][0], w[1][1]), attn::pack2(w[1][2], w[1][3])};
      const uint32_t da[4] = {attn::pack2(ds[0][0], ds[0][1]), attn::pack2(ds[0][2], ds[0][3]),
                              attn::pack2(ds[1][0], ds[1][1]), attn::pack2(ds[1][2], ds[1][3])};
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t b[4];
        attn::ldsm_x4_t(b, attn::bk_addr(gs, SP, c * 16, np * 16, lane));
        attn::mma(dva[2 * np], wa, b[0], b[1]);
        attn::mma(dva[2 * np + 1], wa, b[2], b[3]);
        attn::ldsm_x4_t(b, attn::bk_addr(qs, SP, c * 16, np * 16, lane));
        attn::mma(dka[2 * np], da, b[0], b[1]);
        attn::mma(dka[2 * np + 1], da, b[2], b[3]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = j0 + warp * 16 + (lane >> 2) + 8 * r;
    const float dsum = attn::quad_sum(dbs[r]);
    if (kj >= sk) continue;
    const size_t row = (size_t)bh * sk + kj;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      attn::store2(dk_out + row * dk, col, dk, dka[n][2 * r], dka[n][2 * r + 1]);
      attn::store2(dv_out + row * dv, col, dv, dva[n][2 * r], dva[n][2 * r + 1]);
    }
    if ((lane & 3) == 0) dbias[row] = rnd<bf16>(dsum);
  }
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
// CUDA-core query pass (fp32, Sq >= 8): dq and the row statistics
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
// CUDA-core key pass (fp32, Sq >= 8): dk, dv and dbias
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
// row kernel (both types, Sq < 8): one block per head row
// ---------------------------------------------------------------------------
// x[i] = rows_f[i] . row for the first sq rows (row: dp elements of T in
// shared memory, read 16 bytes at a time)
template <typename T, int NQ>
__device__ __forceinline__ void row_dots(float (&x)[NQ], const T* row, const float* rows_f,
                                         int dp, int sq) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < NQ; ++i) x[i] = 0.f;
  for (int c = 0; c < dp; c += E) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + c);
    const T* r = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float f = to_f(r[e]);
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        if (i < sq) x[i] = fmaf(rows_f[i * MAXD + c + e], f, x[i]);
    }
  }
}

template <typename T, int NQ>
__global__ void __launch_bounds__(RT)
bwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const float* __restrict__ bias, const T* __restrict__ g, T* __restrict__ dq,
         T* __restrict__ dk_out, T* __restrict__ dv_out, float* __restrict__ dbias, int sq,
         int sk, int dk, int dv, float scale, int vec) {
  constexpr int E = 16 / sizeof(T);
  const int dkp = (dk + E - 1) / E * E, dvp = (dv + E - 1) / E * E;
  const int skp = dkp + E, svp = dvp + E;  // 16 spare bytes per row: conflict-free row reads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t stage_bytes = (size_t)RK * (skp + svp) * sizeof(T) + RK * 4;
  auto kbuf = [&](int s) { return reinterpret_cast<T*>(smem_raw + s * stage_bytes); };
  auto vbuf = [&](int s) { return kbuf(s) + RK * skp; };
  auto bbuf = [&](int s) { return reinterpret_cast<float*>(vbuf(s) + RK * svp); };
  float* qf = reinterpret_cast<float*>(smem_raw + 2 * stage_bytes);  // [MAXQ][MAXD] q*scale
  float* gf = qf + MAXQ * MAXD;                                      // [MAXQ][MAXD] g
  float* wls = gf + MAXQ * MAXD;                                     // [MAXQ][RK] round(w)
  float* dss = wls + MAXQ * RK;                                      // [MAXQ][RK] ds
  float* red = dss + MAXQ * RK;                                      // [3][MAXQ][NW]

  const int bh = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* kb = k + (size_t)bh * sk * dk;
  const T* vb = v + (size_t)bh * sk * dv;
  const float* biasb = bias + (size_t)bh * sk;
  const int nt = (sk + RK - 1) / RK, nit = 3 * nt;
  // iteration it = sweep * nt + tile; sweep 0 needs no V
  auto load = [&](int it) {
    const int s = it & 1, k0 = (it % nt) * RK;
    attn::stage<T, RK>(kbuf(s), skp, kb, k0, sk, dk, dkp, vec);
    if (it >= nt) attn::stage<T, RK>(vbuf(s), svp, vb, k0, sk, dv, dvp, vec);
    if (tid < RK) {
      if (k0 + tid < sk) attn::cp_async4(bbuf(s) + tid, biasb + k0 + tid);
      else bbuf(s)[tid] = -INFINITY;
    }
    attn::cp_commit();
  };
  load(0);
  for (int i = tid; i < sq * dkp; i += RT) {
    const int r = i / dkp, d = i - r * dkp;
    qf[r * MAXD + d] = d < dk ? rnd<T>(to_f(q[((size_t)bh * sq + r) * dk + d]) * scale) : 0.f;
  }
  for (int i = tid; i < sq * dvp; i += RT) {
    const int r = i / dvp, d = i - r * dvp;
    gf[r * MAXD + d] = d < dv ? to_f(g[((size_t)bh * sq + r) * dv + d]) : 0.f;
  }

  // m (base 2), this key thread's share of l (then 1/l), of delta (then delta)
  float m[NQ], lp[NQ], dl[NQ], acc[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    m[i] = -INFINITY;
    lp[i] = dl[i] = acc[i] = 0.f;
  }
  for (int it = 0; it < nit; ++it) {
    attn::cp_wait<0>();
    __syncthreads();  // tile it landed; everyone is done with tile it - 1
    if (it + 1 < nit) load(it + 1);
    const int sweep = it / nt, t = it - sweep * nt, k0 = t * RK;
    const T* ks = kbuf(it & 1);
    const T* vs = vbuf(it & 1);
    float x[NQ], dp[NQ];
    if (tid < RK) {  // thread j: key k0 + j against every query row
      row_dots<T, NQ>(x, ks + tid * skp, qf, dkp, sq);
      const float b = bbuf(it & 1)[tid];
#pragma unroll
      for (int i = 0; i < NQ; ++i) x[i] = attn::log2_logit(x[i], b);
      if (sweep > 0) row_dots<T, NQ>(dp, vs + tid * svp, gf, dvp, sq);
    }
    if (sweep == 0) {  // statistics
      if (tid < RK) {
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          if (i >= sq) break;
          const float mx = warp_max(x[i]);
          if (lane == 0) red[i * NW + warp] = mx;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        if (i >= sq) break;
        float mx = red[i * NW];
#pragma unroll
        for (int w = 1; w < RK / 32; ++w) mx = fmaxf(mx, red[i * NW + w]);
        const float mn = fmaxf(m[i], mx);
        lp[i] *= exp2f(m[i] - mn);
        m[i] = mn;
        if (tid < RK) lp[i] += exp2f(x[i] - mn);
      }
      if (t == nt - 1) {
        if (tid < RK) {
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            if (i >= sq) break;
            const float s = warp_sum(lp[i]);
            if (lane == 0) red[(MAXQ + i) * NW + warp] = s;
          }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          if (i >= sq) break;
          float l = 0.f;
#pragma unroll
          for (int w = 0; w < RK / 32; ++w) l += red[(MAXQ + i) * NW + w];
          lp[i] = 1.f / fmaxf(l, 1e-30f);
        }
      }
    } else if (sweep == 1) {  // delta_i = sum_j round(w_ij) (g_i . v_j)
      if (tid < RK) {
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          if (i >= sq) break;
          dl[i] = fmaf(rnd<T>(exp2f(x[i] - m[i]) * lp[i]), dp[i], dl[i]);
        }
      }
      if (t == nt - 1) {
        if (tid < RK) {
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            if (i >= sq) break;
            const float s = warp_sum(dl[i]);
            if (lane == 0) red[(2 * MAXQ + i) * NW + warp] = s;
          }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          if (i >= sq) break;
          float d = 0.f;
#pragma unroll
          for (int w = 0; w < RK / 32; ++w) d += red[(2 * MAXQ + i) * NW + w];
          dl[i] = d;
        }
      }
    } else {  // ds, dbias; then the tile's dk and dv rows and dq
      if (tid < RK) {
        float dsum = 0.f;
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          if (i >= sq) break;
          const float w = exp2f(x[i] - m[i]) * lp[i];
          const float ds = rnd<T>(w * (dp[i] - dl[i]));
          wls[i * RK + tid] = rnd<T>(w);
          dss[i * RK + tid] = ds;
          dsum += ds;
        }
        if (k0 + tid < sk) dbias[(size_t)bh * sk + k0 + tid] = rnd<T>(dsum);
      }
      __syncthreads();
      const int nk = min(RK, sk - k0);
      T* dkt = dk_out + ((size_t)bh * sk + k0) * dk;  // the tile's rows are contiguous
      for (int idx = tid; idx < nk * dk; idx += RT) {
        const int j = idx / dk, c = idx - j * dk;
        float a = 0.f;
        for (int i = 0; i < sq; ++i) a = fmaf(dss[i * RK + j], qf[i * MAXD + c], a);
        dkt[idx] = from_f<T>(a);
      }
      T* dvt = dv_out + ((size_t)bh * sk + k0) * dv;
      for (int idx = tid; idx < nk * dv; idx += RT) {
        const int j = idx / dv, c = idx - j * dv;
        float a = 0.f;
        for (int i = 0; i < sq; ++i) a = fmaf(wls[i * RK + j], gf[i * MAXD + c], a);
        dvt[idx] = from_f<T>(a);
      }
#pragma unroll
      for (int sl = 0; sl < NQ; ++sl) {  // dq element (i, c) = tid + sl * RT
        const int idx = tid + sl * RT;
        if (idx >= sq * dk) break;
        const int i = idx / dk, c = idx - i * dk;
        float a = acc[sl];
        const float* dr = dss + i * RK;
        for (int j = 0; j < nk; ++j) a = fmaf(dr[j], to_f(ks[j * skp + c]), a);
        acc[sl] = a;
      }
    }
  }
#pragma unroll
  for (int sl = 0; sl < NQ; ++sl) {
    const int idx = tid + sl * RT;
    if (idx >= sq * dk) break;
    dq[(size_t)bh * sq * dk + idx] = from_f<T>(rnd<T>(acc[sl]) * scale);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// NQ: query rows held in registers; Sq = 1 (the decoders) gets its own
// instance, so its registers are not sized for seven rows
template <typename T, int NQ>
cudaError_t launch_rows(const void* q, const void* k, const void* v, const float* bias,
                        const void* g, void* dq, void* dk_out, void* dv_out, float* dbias, int bh,
                        int sq, int sk, int dk, int dv, float scale, int vec, cudaStream_t stream) {
  const size_t smem = rows_smem(dk, dv, sizeof(T));
  cudaError_t err = set_smem(bwd_rows<T, NQ>, smem);
  if (err != cudaSuccess) return err;
  bwd_rows<T, NQ><<<bh, RT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk_out),
      static_cast<T*>(dv_out), dbias, sq, sk, dk, dv, scale, vec);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       const void* g, void* dq, void* dk_out, void* dv_out, float* dbias,
                       float* stats, int bh, int sq, int sk, int dk, int dv, float scale, int vec,
                       cudaStream_t stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  const size_t smem_q = query_mma_smem(D), smem_k = key_mma_smem(D);
  cudaError_t err = set_smem(bwd_query_mma<D>, smem_q);
  if (err != cudaSuccess) return err;
  bwd_query_mma<D><<<((sq + MQ - 1) / MQ) * bh, MW * 32, smem_q, stream>>>(
      qp, kp, vp, bias, gp, static_cast<bf16*>(dq), stats, bh, sq, sk, dk, dv, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem(bwd_key_mma<D>, smem_k);
  if (err != cudaSuccess) return err;
  bwd_key_mma<D><<<((sk + MK - 1) / MK) * bh, MW * 32, smem_k, stream>>>(
      qp, kp, vp, bias, gp, stats, static_cast<bf16*>(dk_out), static_cast<bf16*>(dv_out), dbias,
      bh, sq, sk, dk, dv, scale, vec);
  return cudaGetLastError();
}

template <int DKM, int DVM>
cudaError_t launch_fp32(const float* q, const float* k, const float* v, const float* bias,
                        const float* g, float* dq, float* dk_out, float* dv_out, float* dbias,
                        float* stats, int bh, int sq, int sk, int dk, int dv, float scale,
                        cudaStream_t stream) {
  const size_t smem_q = query_pass_smem(dk, dv), smem_k = key_pass_smem(dk, dv);
  cudaError_t err = set_smem(bwd_query_pass<float, DKM>, smem_q);
  if (err != cudaSuccess) return err;
  bwd_query_pass<float, DKM><<<((sq + BLK - 1) / BLK) * bh, WARPS * 32, smem_q, stream>>>(
      q, k, v, bias, g, dq, stats, bh, sq, sk, dk, dv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem(bwd_key_pass<float, DKM, DVM>, smem_k);
  if (err != cudaSuccess) return err;
  bwd_key_pass<float, DKM, DVM><<<((sk + BLK - 1) / BLK) * bh, WARPS * 32, smem_k, stream>>>(
      q, k, v, bias, g, stats, dk_out, dv_out, dbias, bh, sq, sk, dk, dv, scale);
  return cudaGetLastError();
}

template <int DKM>
cudaError_t fp32_dv(const float* q, const float* k, const float* v, const float* bias,
                    const float* g, float* dq, float* dk_out, float* dv_out, float* dbias,
                    float* stats, int bh, int sq, int sk, int dk, int dv, float scale,
                    cudaStream_t s) {
  if (dv <= 32)
    return launch_fp32<DKM, 32>(q, k, v, bias, g, dq, dk_out, dv_out, dbias, stats, bh, sq, sk,
                                dk, dv, scale, s);
  if (dv <= 64)
    return launch_fp32<DKM, 64>(q, k, v, bias, g, dq, dk_out, dv_out, dbias, stats, bh, sq, sk,
                                dk, dv, scale, s);
  return launch_fp32<DKM, 128>(q, k, v, bias, g, dq, dk_out, dv_out, dbias, stats, bh, sq, sk,
                               dk, dv, scale, s);
}

bool bad_args(int bh, int sq, int sk, int dk, int dv, int dtype) {
  return bh <= 0 || sq <= 0 || sk <= 0 || dk <= 0 || dv <= 0 || dk > MAXD || dv > MAXD ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. stats: fp32 scratch of 3 * BH * Sq floats
// (unused when Sq < 8). vec as in flash_attention_fwd (q, k, v and g). Routes:
// Sq < 8 -> the row kernel; bf16 -> the tensor-core passes; fp32 -> the
// CUDA-core passes. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* g, void* dq, void* dk,
                                   void* dv, void* dbias, void* stats, int bh, int sq, int sk,
                                   int dkd, int dvd, int dtype, int vec, void* stream) {
  if (bad_args(bh, sq, sk, dkd, dvd, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* db = static_cast<float*>(dbias);
  float* st = static_cast<float*>(stats);
  const float scale = 1.f / sqrtf((float)dkd);
  if (sq <= MAXQ) {
    if (dtype == 1)
      return sq == 1 ? (int)launch_rows<bf16, 1>(q, k, v, b, g, dq, dk, dv, db, bh, sq, sk, dkd,
                                                 dvd, scale, vec, s)
                     : (int)launch_rows<bf16, MAXQ>(q, k, v, b, g, dq, dk, dv, db, bh, sq, sk,
                                                    dkd, dvd, scale, vec, s);
    return sq == 1 ? (int)launch_rows<float, 1>(q, k, v, b, g, dq, dk, dv, db, bh, sq, sk, dkd,
                                                dvd, scale, vec, s)
                   : (int)launch_rows<float, MAXQ>(q, k, v, b, g, dq, dk, dv, db, bh, sq, sk, dkd,
                                                   dvd, scale, vec, s);
  }
  if (dtype == 1) {
    switch (attn::mma_width(dkd, dvd)) {
      case 32: return (int)launch_mma<32>(q, k, v, b, g, dq, dk, dv, db, st, bh, sq, sk, dkd, dvd,
                                          scale, vec, s);
      case 64: return (int)launch_mma<64>(q, k, v, b, g, dq, dk, dv, db, st, bh, sq, sk, dkd, dvd,
                                          scale, vec, s);
      default: return (int)launch_mma<128>(q, k, v, b, g, dq, dk, dv, db, st, bh, sq, sk, dkd,
                                           dvd, scale, vec, s);
    }
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (dkd <= 32) return (int)fp32_dv<32>(qf, kf, vf, b, gf, dqf, dkf, dvf, db, st, bh, sq, sk, dkd, dvd, scale, s);
  if (dkd <= 64) return (int)fp32_dv<64>(qf, kf, vf, b, gf, dqf, dkf, dvf, db, st, bh, sq, sk, dkd, dvd, scale, s);
  return (int)fp32_dv<128>(qf, kf, vf, b, gf, dqf, dkf, dvf, db, st, bh, sq, sk, dkd, dvd, scale, s);
}
