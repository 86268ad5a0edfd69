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
// byte, under the ~295 the bf16 tensor cores need, so the floor is the
// bytes: read q, k, v and bias once and write out once. The exponentials
// (one per logit) cost about as much as the bytes on the special-function
// units, so the softmax runs in base 2 (exp2f) with log2(e) folded into each
// fp32 logit. The [Sq, Sk] weights never touch device memory.
//
// Three kernels, chosen by the host (flash_attention_fwd below):
//   * flash_fwd_mma (bf16, Sq >= 8): the tensor-core kernel. One block of 4
//     warps per (head row, 64-query tile); each warp owns a 16-row strip.
//     K/V come in 64-key tiles, double-buffered in shared memory by 16-byte
//     cp.async. S = Qs K^T and O += P V run on mma.sync.m16n8k16 (bf16 in,
//     fp32 accumulate): at d = 32 a 64-row wgmma tile would hold a whole
//     warpgroup on one strip of 64 queries and serialise the softmax behind
//     it, while four independent 16-row strips keep the exponentials and the
//     products of different warps overlapping, and the bound here is bytes
//     and exponentials, not the tensor-core rate. The online softmax works on
//     the C fragments (row max and sum within each quad of lanes), and P is
//     repacked to bf16 in registers as the A operand of P V. Rounding points
//     follow _flash_fwd_kernel: q * scale rounded to bf16 (_fold_bias),
//     logits and statistics fp32, p rounded to bf16 before P V, one rounding
//     of the output. Head widths are zero-padded to 32, 64 or 128 (exact).
//   * flash_fwd_tiled (fp32, Sq >= 8): the CUDA-core kernel of the first
//     version, kept for fp32: the tensor cores would need TF32, which
//     changes results. One block of 8 warps per (head row, 32-query tile),
//     K/V tiles staged in fp32, lane j scores key j, P V through shuffles.
//   * flash_fwd_rows (both types, Sq < 8: the decoders' Sq = 1
//     cross-attention): bytes-bound, so no tensor cores. One block per head
//     row for all its query rows; 64-key tiles of K and V arrive by 16-byte
//     cp.async (a warp's loads cover whole contiguous rows), double-buffered;
//     thread j of the first two warps scores key j for every query row, the
//     tile's max is merged through shared memory, and each thread then owns
//     output columns for P V.
//   * keys past Sk (the ragged edge) are excluded, not biased: a query row
//     whose real keys are all masked (-1e30) gets the uniform average over
//     the real Sk keys, as the plain torch version and _xla_attention do.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using attn::bf16;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int KT = 32;            // keys per tile: one per lane
constexpr int ROWS = 4;           // query rows per warp (tiled kernel)
constexpr int QT = WARPS * ROWS;  // query rows per block (tiled kernel)

constexpr int MW = 4;             // warps per block, tensor-core kernel
constexpr int MQ = 16 * MW;       // query rows per block: a 16-row strip per warp
constexpr int MK = 64;            // keys per tile

constexpr int RT = 128;           // threads per block, row kernel
constexpr int RK = 64;            // keys per tile, row kernel: one per thread of warps 0-1
constexpr int MAXQ = 7;           // row kernel: Sq < 8
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

// dynamic shared memory of each kernel (mirrored by the Python launch plan,
// kernels/attention.py::plan)
size_t mma_smem(int d) {
  const int sp = d + 8;
  return (size_t)MQ * sp * 2 + 2 * ((size_t)2 * MK * sp * 2 + MK * 4);
}
size_t tiled_smem(int dk, int dvm) {
  return sizeof(float) * ((size_t)QT * dk + (size_t)KT * (dk + 1) + (size_t)KT * dvm + KT);
}
size_t rows_smem(int dk, int dv, int isz) {
  const int e = 16 / isz, dkp = (dk + e - 1) / e * e, dvp = (dv + e - 1) / e * e;
  const size_t stage = (size_t)RK * (dkp + e + dvp + e) * isz + RK * 4;
  return 2 * stage + 4 * ((size_t)MAXQ * MAXD + MAXQ * RK + 2 * MAXQ * 4 + MAXQ);
}

// ---------------------------------------------------------------------------
// tensor-core kernel (bf16, Sq >= 8)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(MW * 32)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const float* __restrict__ bias, bf16* __restrict__ out, int sq, int sk, int dk,
              int dv, float scale, int vec) {
  constexpr int SP = D + 8, KS = D / 16, NV = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [MQ][SP], q * scale rounded
  constexpr size_t STAGE = (size_t)2 * MK * SP * 2 + MK * 4;
  auto kbuf = [&](int s) { return reinterpret_cast<bf16*>(smem_raw + MQ * SP * 2 + s * STAGE); };
  auto vbuf = [&](int s) { return kbuf(s) + MK * SP; };
  auto bbuf = [&](int s) { return reinterpret_cast<float*>(kbuf(s) + 2 * MK * SP); };

  const int ntq = (sq + MQ - 1) / MQ;
  const int bh = blockIdx.x / ntq;
  const int q0 = (blockIdx.x - bh * ntq) * MQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* kb = k + (size_t)bh * sk * dk;
  const bf16* vb = v + (size_t)bh * sk * dv;
  const float* biasb = bias + (size_t)bh * sk;

  auto load = [&](int t) {  // key tile t into stage t & 1
    const int s = t & 1, k0 = t * MK;
    attn::stage<bf16, MK>(kbuf(s), SP, kb, k0, sk, dk, D, vec);
    attn::stage<bf16, MK>(vbuf(s), SP, vb, k0, sk, dv, D, vec);
    if (tid < MK) {
      if (k0 + tid < sk) attn::cp_async4(bbuf(s) + tid, biasb + k0 + tid);
      else bbuf(s)[tid] = -INFINITY;  // past Sk: excluded
    }
    attn::cp_commit();
  };

  attn::stage<bf16, MQ>(qs, SP, q + (size_t)bh * sq * dk, q0, sq, dk, D, vec);
  load(0);
  attn::cp_wait<0>();
  __syncthreads();
  attn::scale_rows<MQ>(qs, SP, D, scale);
  __syncthreads();

  const bool active = q0 + warp * 16 < sq;  // warp-uniform: a strip past Sq idles
  attn::AStrip<KS, (D <= 64)> qa;
  qa.init(attn::a_addr(qs, SP, warp * 16, lane));
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows lane/4 and lane/4 + 8
  float o[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const int nt = (sk + MK - 1) / MK;
  for (int t = 0; t < nt; ++t) {
    attn::cp_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < nt) load(t + 1);
    if (!active) continue;
    const bf16* ks = kbuf(t & 1);
    const bf16* vs = vbuf(t & 1);
    const float* bs = bbuf(t & 1);

    // S = Qs K^T for 64 keys: 8 C tiles of 8 keys
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
    // logits in base 2, the tile's row max, online rescale
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = attn::log2_logit(s[n][e], bs[n * 8 + (lane & 3) * 2 + (e & 1)]);
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = attn::quad_max(mx[r]);
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += p;  // this lane's share; the quad's shares are summed at the end
        s[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += round(P) V: P's C tiles 2kk, 2kk+1 are the A operand of key step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {attn::pack2(s[2 * kk][0], s[2 * kk][1]),
                              attn::pack2(s[2 * kk][2], s[2 * kk][3]),
                              attn::pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              attn::pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NV / 2; ++np) {
        uint32_t b[4];
        attn::ldsm_x4_t(b, attn::bk_addr(vs, SP, kk * 16, np * 16, lane));
        attn::mma(o[2 * np], pa, b[0], b[1]);
        attn::mma(o[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + (lane >> 2) + 8 * r;
    const float inv = 1.f / fmaxf(attn::quad_sum(l[r]), 1e-30f);
    if (qi >= sq) continue;
    bf16* orow = out + ((size_t)bh * sq + qi) * dv;
#pragma unroll
    for (int n = 0; n < NV; ++n)
      attn::store2(orow, n * 8 + (lane & 3) * 2, dv, o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// CUDA-core kernel (fp32, Sq >= 8)
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// row kernel (both types, Sq < 8)
// ---------------------------------------------------------------------------
template <typename T, int NQ>
__global__ void __launch_bounds__(RT)
flash_fwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ bias, T* __restrict__ out, int sq, int sk, int dk,
               int dv, float scale, int vec) {
  constexpr int E = 16 / sizeof(T), NW = RT / 32;
  const int dkp = (dk + E - 1) / E * E, dvp = (dv + E - 1) / E * E;
  const int skp = dkp + E, svp = dvp + E;  // 16 spare bytes per row: conflict-free row reads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t stage_bytes = (size_t)RK * (skp + svp) * sizeof(T) + RK * 4;
  auto kbuf = [&](int s) { return reinterpret_cast<T*>(smem_raw + s * stage_bytes); };
  auto vbuf = [&](int s) { return kbuf(s) + RK * skp; };
  auto bbuf = [&](int s) { return reinterpret_cast<float*>(vbuf(s) + RK * svp); };
  float* qf = reinterpret_cast<float*>(smem_raw + 2 * stage_bytes);  // [MAXQ][MAXD]
  float* ps = qf + MAXQ * MAXD;                                      // [MAXQ][RK] round(p)
  float* red = ps + MAXQ * RK;                                       // [MAXQ][NW]
  float* redl = red + MAXQ * NW;                                     // [MAXQ][NW]
  float* al = redl + MAXQ * NW;                                      // [MAXQ] alpha

  const int bh = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* kb = k + (size_t)bh * sk * dk;
  const T* vb = v + (size_t)bh * sk * dv;
  const float* biasb = bias + (size_t)bh * sk;
  auto load = [&](int t) {
    const int s = t & 1, k0 = t * RK;
    attn::stage<T, RK>(kbuf(s), skp, kb, k0, sk, dk, dkp, vec);
    attn::stage<T, RK>(vbuf(s), svp, vb, k0, sk, dv, dvp, vec);
    if (tid < RK) {
      if (k0 + tid < sk) attn::cp_async4(bbuf(s) + tid, biasb + k0 + tid);
      else bbuf(s)[tid] = -INFINITY;
    }
    attn::cp_commit();
  };
  load(0);
  // q * scale rounded to T, zero-padded to dkp
  for (int i = tid; i < sq * dkp; i += RT) {
    const int r = i / dkp, d = i - r * dkp;
    qf[r * MAXD + d] = d < dk ? rnd<T>(to_f(q[((size_t)bh * sq + r) * dk + d]) * scale) : 0.f;
  }

  float m[NQ], lp[NQ], acc[NQ];  // lp: this key thread's share of l
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    m[i] = -INFINITY;
    lp[i] = 0.f;
    acc[i] = 0.f;
  }
  const int nt = (sk + RK - 1) / RK;
  for (int t = 0; t < nt; ++t) {
    attn::cp_wait<0>();
    __syncthreads();  // tile t landed; everyone is done with tile t - 1
    if (t + 1 < nt) load(t + 1);
    const T* ks = kbuf(t & 1);
    const T* vs = vbuf(t & 1);
    float x[NQ];
    if (tid < RK) {  // thread j scores key j for every query row
#pragma unroll
      for (int i = 0; i < NQ; ++i) x[i] = 0.f;
      const T* krow = ks + tid * skp;
      for (int c = 0; c < dkp; c += E) {
        const uint4 u = *reinterpret_cast<const uint4*>(krow + c);
        const T* kv = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float kf = to_f(kv[e]);
#pragma unroll
          for (int i = 0; i < NQ; ++i)
            if (i < sq) x[i] = fmaf(qf[i * MAXD + c + e], kf, x[i]);
        }
      }
      const float b = bbuf(t & 1)[tid];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        if (i >= sq) break;
        x[i] = attn::log2_logit(x[i], b);
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
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
      if (tid == 0) al[i] = alpha;
      if (tid < RK) {
        const float p = exp2f(x[i] - mn);
        lp[i] = lp[i] * alpha + p;
        ps[i * RK + tid] = rnd<T>(p);
      }
    }
    __syncthreads();
    // P V: thread owns output elements (i, c) = tid, tid + RT, ...
#pragma unroll
    for (int sl = 0; sl < NQ; ++sl) {
      const int idx = tid + sl * RT;
      if (idx >= sq * dv) break;
      const int i = idx / dv, c = idx - i * dv;
      float a = acc[sl] * al[i];
      const float* pr = ps + i * RK;
      for (int j = 0; j < RK; ++j) a = fmaf(pr[j], to_f(vs[j * svp + c]), a);
      acc[sl] = a;
    }
  }
  // l per row: the key threads' shares
  if (tid < RK) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i >= sq) break;
      const float s = warp_sum(lp[i]);
      if (lane == 0) redl[i * NW + warp] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int sl = 0; sl < NQ; ++sl) {
    const int idx = tid + sl * RT;
    if (idx >= sq * dv) break;
    const int i = idx / dv, c = idx - i * dv;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < RK / 32; ++w) l += redl[i * NW + w];
    out[((size_t)bh * sq + i) * dv + c] = from_f<T>(acc[sl] / fmaxf(l, 1e-30f));
  }
}

// NQ: query rows held in registers; Sq = 1 (the decoders) gets its own
// instance, so its registers are not sized for seven rows
template <typename T, int NQ>
cudaError_t launch_rows(const void* q, const void* k, const void* v, const float* bias, void* out,
                        int bh, int sq, int sk, int dk, int dv, float scale, int vec,
                        cudaStream_t stream) {
  const size_t smem = rows_smem(dk, dv, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_rows<T, NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_rows<T, NQ><<<bh, RT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), sq, sk, dk, dv, scale, vec);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias, void* out,
                       int bh, int sq, int sk, int dk, int dv, float scale, int vec,
                       cudaStream_t stream) {
  const size_t smem = mma_smem(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(((sq + MQ - 1) / MQ) * bh);
  flash_fwd_mma<D><<<grid, MW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bias,
      static_cast<bf16*>(out), sq, sk, dk, dv, scale, vec);
  return cudaGetLastError();
}

template <int DVM>
cudaError_t launch_tiled(const void* q, const void* k, const void* v, const float* bias,
                         void* out, int bh, int sq, int sk, int dk, int dv, float scale,
                         cudaStream_t stream) {
  const size_t smem = tiled_smem(dk, DVM);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tiled<float, DVM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(((sq + QT - 1) / QT) * bh);
  flash_fwd_tiled<float, DVM><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, static_cast<float*>(out), sq, sk, dk, dv, scale);
  return cudaGetLastError();
}

int dvm_of(int dv) { return dv <= 32 ? 32 : dv <= 64 ? 64 : 128; }

bool bad_args(int bh, int sq, int sk, int dk, int dv, int dtype) {
  return bh <= 0 || sq <= 0 || sk <= 0 || dk <= 0 || dv <= 0 || dk > MAXD || dv > MAXD ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec: every head width is a multiple of
// 16 bytes' worth of elements and q, k, v are 16-byte aligned (the wrapper
// checks), so tiles move by 16-byte cp.async. Routes: Sq < 8 -> the row
// kernel; bf16 -> the tensor-core kernel; fp32 -> the CUDA-core kernel.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int bh, int sq, int sk,
                                   int dk, int dv, int dtype, int vec, void* stream) {
  if (bad_args(bh, sq, sk, dk, dv, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float scale = 1.f / sqrtf((float)dk);
  if (sq == 1) {
    return dtype == 1 ? (int)launch_rows<bf16, 1>(q, k, v, b, out, bh, sq, sk, dk, dv, scale, vec, s)
                      : (int)launch_rows<float, 1>(q, k, v, b, out, bh, sq, sk, dk, dv, scale, vec, s);
  }
  if (sq <= MAXQ) {
    return dtype == 1
               ? (int)launch_rows<bf16, MAXQ>(q, k, v, b, out, bh, sq, sk, dk, dv, scale, vec, s)
               : (int)launch_rows<float, MAXQ>(q, k, v, b, out, bh, sq, sk, dk, dv, scale, vec, s);
  }
  if (dtype == 1) {
    switch (attn::mma_width(dk, dv)) {
      case 32: return (int)launch_mma<32>(q, k, v, b, out, bh, sq, sk, dk, dv, scale, vec, s);
      case 64: return (int)launch_mma<64>(q, k, v, b, out, bh, sq, sk, dk, dv, scale, vec, s);
      default: return (int)launch_mma<128>(q, k, v, b, out, bh, sq, sk, dk, dv, scale, vec, s);
    }
  }
  switch (dvm_of(dv)) {
    case 32: return (int)launch_tiled<32>(q, k, v, b, out, bh, sq, sk, dk, dv, scale, s);
    case 64: return (int)launch_tiled<64>(q, k, v, b, out, bh, sq, sk, dk, dv, scale, s);
    default: return (int)launch_tiled<128>(q, k, v, b, out, bh, sq, sk, dk, dv, scale, s);
  }
}
