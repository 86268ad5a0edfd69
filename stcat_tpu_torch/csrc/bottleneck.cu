// One whole stride-1 ResNet bottleneck block in a single launch, hand-written
// for Hopper (sm_90a).
//
// Replaces: stcat_tpu/kernels/conv.py::_fused_fwd / _kernel, the Pallas TPU
// kernel behind fused_bottleneck. Same function, NHWC, FrozenBN pre-folded
// into the weights by the caller:
//   x1  = relu(x . W1 + b1)                       1x1, Cin -> P
//   y2  = relu(dilated 3x3(x1) + b2)              zero padding in x1-space
//   out = relu(y2 . W3 + b3 + (x . Wd + bd or x)) 1x1, P -> Cout
// x [N, H, W, Cin] and the weights in the compute type (fp32 or bf16),
// biases fp32, fp32 accumulation, x1 and y2 rounded to the compute type
// exactly where the JAX kernel rounds them; out [N, H, W, Cout].
//
// What bounds it on this card: a block does 2*(Cin*P + 9*P*P + P*Cout
// [+ Cin*Cout]) flops per pixel against (Cin + Cout) * 2 bytes of device
// traffic when fused -- 1,000-10,000 flops per byte at the main path's
// stages, far above the ~295 the tensor cores need, so the floor is the
// operations. Unfused, x1 and y2 would each make a round trip through
// device memory; here they live in shared memory only.
//
// Design (a simple, correct first version on the CUDA cores; wgmma/TMA
// tiles are later work):
//   * one thread block per (frame, tile of CH x CW output pixels), all of
//     Cout. The host picks the tile: whole rows where they fit, narrower
//     column tiles where a row does not (wide frames, dilation 2, fp32).
//   * phase 1 computes x1 for the tile plus its d-wide halo on every side
//     into shared memory, in the compute type; halo positions outside the
//     image are exact zeros (conv2 pads its input, x1).
//   * phase 2 is the dilated 3x3 as one GEMM with K = 9*P whose A operand
//     reads the shifted x1 window straight from shared memory; y2 stays in
//     shared memory.
//   * phase 3 is y2 . W3 (+ the projection x . Wd as extra K rows) with the
//     residual and ReLU in the epilogue; the output is written once.
//   * each phase runs the same 64x64 register-tiled GEMM: A (pixels x K)
//     and B (K x channels) are staged 16 K-slices at a time in shared memory
//     as fp32, each of 256 threads owns a 4x4 output tile. Weights are read
//     from global memory / L2 chunk by chunk.
//   * the host sizes the tile so x1 and y2 fit the 227 KB of shared memory
//     a block may use, preferring the tile with the least halo recompute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TM = 64;        // pixels per GEMM tile
constexpr int TN = 64;        // channels per GEMM tile
constexpr int KC = 16;        // K slice staged per step
constexpr int AS = TM + 4;    // A stage row stride (floats): 2-way conflicts at most

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Shape {
  int n, h, w, cin, p, cout, d, ch, cw, has_ds;
};

// C[m, n] = sum_k A(m, k) * B(k, n) over an M x N output, handed to `ep`
// one element at a time. A and B are functors returning fp32.
template <class AF, class BF, class EP>
__device__ void gemm(int M, int N, int K, const AF& a, const BF& b, const EP& ep,
                     float* As, float* Bs) {
  const int tid = threadIdx.x;
  const int tm = tid >> 4, tn = tid & 15;
  for (int m0 = 0; m0 < M; m0 += TM) {
    for (int n0 = 0; n0 < N; n0 += TN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += KC) {
        __syncthreads();
        // A: consecutive threads walk K (contiguous in NHWC), then pixels
        for (int i = tid; i < TM * KC; i += THREADS) {
          const int kk = i % KC, mm = i / KC;
          const int m = m0 + mm, k = k0 + kk;
          As[kk * AS + mm] = (m < M && k < K) ? a(m, k) : 0.f;
        }
        // B: consecutive threads walk the output channels
        for (int i = tid; i < KC * TN; i += THREADS) {
          const int kk = i / TN, nn = i % TN;
          const int k = k0 + kk, n = n0 + nn;
          Bs[kk * TN + nn] = (k < K && n < N) ? b(k, n) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const float4 av = *reinterpret_cast<const float4*>(As + kk * AS + tm * 4);
          const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * TN + tn * 4);
          const float ar[4] = {av.x, av.y, av.z, av.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + tm * 4 + i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tn * 4 + j;
          if (n < N) ep(m, n, acc[i][j]);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bottleneck_fwd(const T* __restrict__ x, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, const T* __restrict__ w3,
               const float* __restrict__ b3, const T* __restrict__ wd,
               const float* __restrict__ bd, T* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = s.w, P = s.p, d = s.d;
  const int tiles_x = (W + s.cw - 1) / s.cw;
  const int row0 = (blockIdx.x / tiles_x) * s.ch;
  const int col0 = (blockIdx.x % tiles_x) * s.cw;
  const int rows = min(s.ch, s.h - row0);
  const int cols = min(s.cw, W - col0);
  const int R1 = s.ch + 2 * d;       // x1 tile rows incl. the halo
  const int WP = s.cw + 2 * d;       // x1 tile cols incl. the halo
  const int frame = blockIdx.y;

  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + KC * AS;
  T* x1s = reinterpret_cast<T*>(Bs + KC * TN);   // [R1][WP][P]
  T* y2s = x1s + (size_t)R1 * WP * P;             // [rows * cols][P]

  const T* xf = x + (size_t)frame * s.h * W * s.cin;
  T* of = out + (size_t)frame * s.h * W * s.cout;

  // phase 1: x1 = relu(x . W1 + b1) over the haloed tile; positions outside
  // the image are exact zeros (conv2's zero padding lives in x1-space)
  {
    auto inside = [&](int m, int& y, int& xc) -> bool {
      const int r = m / WP, c = m - r * WP;
      y = row0 - d + r;
      xc = col0 - d + c;
      return y >= 0 && y < s.h && xc >= 0 && xc < W;
    };
    auto a = [&](int m, int k) -> float {
      int y, xc;
      return inside(m, y, xc) ? to_f(xf[((size_t)y * W + xc) * s.cin + k]) : 0.f;
    };
    auto b = [&](int k, int n) -> float { return to_f(w1[(size_t)k * P + n]); };
    auto ep = [&](int m, int n, float v) {
      int y, xc;
      x1s[(size_t)m * P + n] = from_f<T>(inside(m, y, xc) ? fmaxf(v + b1[n], 0.f) : 0.f);
    };
    gemm(R1 * WP, P, s.cin, a, b, ep, As, Bs);
  }
  __syncthreads();

  // phase 2: y2 = relu(dilated 3x3(x1) + b2); K index = tap * P + ci
  {
    auto a = [&](int m, int k) -> float {
      const int tap = k / P, ci = k - tap * P;
      const int ky = tap / 3, kx = tap - ky * 3;
      const int r = m / cols, c = m - r * cols;
      return to_f(x1s[((size_t)(r + ky * d) * WP + c + kx * d) * P + ci]);
    };
    auto b = [&](int k, int n) -> float { return to_f(w2[(size_t)k * P + n]); };
    auto ep = [&](int m, int n, float v) {
      y2s[(size_t)m * P + n] = from_f<T>(fmaxf(v + b2[n], 0.f));
    };
    gemm(rows * cols, P, 9 * P, a, b, ep, As, Bs);
  }
  __syncthreads();

  // phase 3: out = relu(y2 . W3 + b3 + residual); the projection x . Wd
  // rides along as K rows [P, P + Cin)
  {
    auto pix = [&](int m) -> size_t {
      const int r = m / cols, c = m - r * cols;
      return (size_t)(row0 + r) * W + col0 + c;
    };
    const int K = P + (s.has_ds ? s.cin : 0);
    auto a = [&](int m, int k) -> float {
      return k < P ? to_f(y2s[(size_t)m * P + k]) : to_f(xf[pix(m) * s.cin + (k - P)]);
    };
    auto b = [&](int k, int n) -> float {
      return k < P ? to_f(w3[(size_t)k * s.cout + n]) : to_f(wd[(size_t)(k - P) * s.cout + n]);
    };
    auto ep = [&](int m, int n, float v) {
      const size_t q = pix(m);
      const float res = s.has_ds ? bd[n] : to_f(xf[q * s.cin + n]);
      of[q * s.cout + n] = from_f<T>(fmaxf(v + b3[n] + res, 0.f));
    };
    gemm(rows * cols, s.cout, K, a, b, ep, As, Bs);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* w3, const void* b3, const void* wd,
                   const void* bd, void* out, Shape s, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(((s.h + s.ch - 1) / s.ch) * ((s.w + s.cw - 1) / s.cw), s.n);
  bottleneck_fwd<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<const T*>(wd),
      static_cast<const float*>(bd), static_cast<T*>(out), s);
  return cudaGetLastError();
}

}  // namespace

// Shared memory a block needs for a tile of ch x cw output pixels.
extern "C" long long bottleneck_smem_bytes(int cw, int p, int d, int ch, int itemsize) {
  const long long stage = (long long)sizeof(float) * (KC * AS + KC * TN);
  const long long x1 = (long long)(ch + 2 * d) * (cw + 2 * d) * p * itemsize;
  const long long y2 = (long long)ch * cw * p * itemsize;
  return stage + x1 + y2;
}

// dtype: 0 = float32, 1 = bfloat16; wd/bd null when the block has no
// projection. Returns a cudaError_t (0 = launched).
extern "C" int bottleneck_fwd_launch(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, const void* w3,
                                     const void* b3, const void* wd, const void* bd,
                                     void* out, int n, int h, int w, int cin, int p,
                                     int cout, int d, int ch, int cw, int dtype,
                                     void* stream) {
  const int has_ds = wd != nullptr;
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || p <= 0 || cout <= 0 || d <= 0 ||
      ch <= 0 || cw <= 0 || (!has_ds && cin != cout) || n > 65535)
    return (int)cudaErrorInvalidValue;
  Shape s{n, h, w, cin, p, cout, d, ch, cw, has_ds};
  const size_t smem = (size_t)bottleneck_smem_bytes(cw, p, d, ch, dtype == 0 ? 4 : 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, s, smem, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, s, smem, st);
  return (int)cudaErrorInvalidValue;
}
