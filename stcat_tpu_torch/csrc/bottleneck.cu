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
// Two routes, chosen by the compute type:
//   bf16 -> bottleneck_tc, on the tensor cores (the main path);
//   fp32 -> bottleneck_fwd, fp32 FMAs on the CUDA cores (TF32 would break
//           the fp32 route's agreement with the plain version).
//
// What bounds it on this card: a block does 2*(Cin*P + 9*P*P + P*Cout
// [+ Cin*Cout]) flops per pixel against (Cin + Cout) * 2 bytes of device
// traffic when fused. At the main path's stages (256 frames, bf16) the
// floor is the bytes at layers 1-2 (0.83-1.33 ms per call: wide frames,
// P 64-128) and the operations at layers 3-4 (0.61 ms per call at 989
// TFLOP/s). Unfused, x1 and y2 would each make a round trip through device
// memory; here they live in shared memory only. What the kernel pays on
// top: every block streams all three weight matrices once per 64-128 rows
// of pixels, and a fixed cost per 32-deep K slice (a barrier, a bulk copy,
// the fragment loads); both shrink with taller tiles and deeper slices.
//
// Design of bottleneck_tc:
//   * one thread block (two warpgroups) per (frame, tile of CH x CW output
//     pixels), all of Cout. The activations stay resident in shared memory;
//     the weights are the streamed operand. The host picks the tile that
//     fits 227 KB with the least tensor-core work (halo recompute and rows
//     rounded up to 64 counted), and a ring of 3 or 4 slices.
//   * every phase is a GEMM on wgmma.m64n64k16 (bf16 in, fp32 accumulators
//     in registers): the two warpgroups split M when N <= 128 (a weight
//     slice serves 128 pixels) and N otherwise. B (the weights) is read by
//     the tensor cores from shared memory, K-major in 8 x 8 core matrices,
//     no swizzle; the host packs each (N chunk, K slice) tile contiguously,
//     so one cp.async.bulk per slice fills a ring stage and completes on
//     the stage's mbarrier while the tensor cores work on the slice before.
//     A comes from registers, loaded with ldmatrix: the 3x3 phase's A rows
//     are shifted windows of x1, a gather that ldmatrix's per-lane row
//     addresses express and a wgmma descriptor cannot.
//   * phase 1: x1 over the tile and its d-wide halo, A = x pixels streamed
//     into the ring slice with cp.async (zero rows outside the image); halo
//     positions outside the image are stored as exact zeros.
//   * phases 2 and 3 run per subtile of 64 or 128 output pixels: the 3x3 as
//     one GEMM with K = 9*P; the subtile's y2 (all P) goes to shared memory,
//     then the closing 1x1 (+ the projection, A = x streamed) runs over Cout
//     in chunks. The epilogue adds bias and residual (prefetched into
//     registers before the chunk's GEMM) and ReLU in fp32, rounds once,
//     stages the tile in the idle ring and writes 16-byte rows. y2 needs one
//     subtile's buffer, not the tile's.
//   * every pixel row of x1, y2 and streamed A in shared memory is padded
//     by 16 bytes, so the 8 rows an ldmatrix reads start in 8 different
//     bank groups.
//   * rows past the tile's pixels compute on clamped (x1, y2) or zero
//     (streamed) rows; their results are dropped.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// fp32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int TM = 64;        // pixels per GEMM tile
constexpr int TN = 64;        // channels per GEMM tile
constexpr int KC = 16;        // K slice staged per step
constexpr int AS = TM + 4;    // A stage row stride (floats): 2-way conflicts at most

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

__global__ void __launch_bounds__(THREADS)
bottleneck_fwd(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ w3,
               const float* __restrict__ b3, const float* __restrict__ wd,
               const float* __restrict__ bd, float* __restrict__ out, Shape s) {
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
  float* x1s = Bs + KC * TN;                      // [R1][WP][P]
  float* y2s = x1s + (size_t)R1 * WP * P;         // [rows * cols][P]

  const float* xf = x + (size_t)frame * s.h * W * s.cin;
  float* of = out + (size_t)frame * s.h * W * s.cout;

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
      return inside(m, y, xc) ? xf[((size_t)y * W + xc) * s.cin + k] : 0.f;
    };
    auto b = [&](int k, int n) -> float { return w1[(size_t)k * P + n]; };
    auto ep = [&](int m, int n, float v) {
      int y, xc;
      x1s[(size_t)m * P + n] = inside(m, y, xc) ? fmaxf(v + b1[n], 0.f) : 0.f;
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
      return x1s[((size_t)(r + ky * d) * WP + c + kx * d) * P + ci];
    };
    auto b = [&](int k, int n) -> float { return w2[(size_t)k * P + n]; };
    auto ep = [&](int m, int n, float v) { y2s[(size_t)m * P + n] = fmaxf(v + b2[n], 0.f); };
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
      return k < P ? y2s[(size_t)m * P + k] : xf[pix(m) * s.cin + (k - P)];
    };
    auto b = [&](int k, int n) -> float {
      return k < P ? w3[(size_t)k * s.cout + n] : wd[(size_t)(k - P) * s.cout + n];
    };
    auto ep = [&](int m, int n, float v) {
      const size_t q = pix(m);
      const float res = s.has_ds ? bd[n] : xf[q * s.cin + n];
      of[q * s.cout + n] = fmaxf(v + b3[n] + res, 0.f);
    };
    gemm(rows * cols, s.cout, K, a, b, ep, As, Bs);
  }
}

long long fp32_smem_bytes(int ch, int cw, int p, int d) {
  const long long stage = (long long)sizeof(float) * (KC * AS + KC * TN);
  const long long x1 = (long long)(ch + 2 * d) * (cw + 2 * d) * p * 4;
  const long long y2 = (long long)ch * cw * p * 4;
  return stage + x1 + y2;
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BK = 32;          // K rows per ring slice: two k16 steps
constexpr int MAX_STAGES = 4;   // ring depth: 3 or 4 slices, the host's choice per shape
constexpr int APAD = 8;         // elements (16 B) added to every A row in shared memory
constexpr int ZERO_BYTES = 128; // a zeroed chunk that A lanes past K read, and the mbarriers

// A phase's GEMM layout, by its N: the two warpgroups split M (64 rows
// each) when N <= 128 and N otherwise; each warpgroup issues NT m64n64k16
// per k16 step. BM = 64 * WGM, BN = 64 * NT * (2 / WGM).
__host__ __device__ constexpr int wg_rows(int n) { return n <= 128 ? 2 : 1; }
__host__ __device__ constexpr int n_tiles(int n) { return n <= 64 ? 1 : 2; }
__host__ __device__ constexpr int a_bytes(int wgm) { return 64 * wgm * (BK + APAD) * 2; }
__host__ __device__ constexpr int b_bytes(int wgm, int nt) { return BK * 64 * nt * (2 / wgm) * 2; }

__host__ __device__ inline int stage_bytes(int p, int cout, int has_ds) {
  const int wp = wg_rows(p), wc = wg_rows(cout);
  const int s1 = a_bytes(wp) + b_bytes(wp, n_tiles(p));                // phases 1, 2
  const int s3 = b_bytes(wc, n_tiles(cout)) + (has_ds ? a_bytes(wc) : 0);  // phase 3
  return s1 > s3 ? s1 : s3;
}

long long smem_bytes(int ch, int cw, int p, int d, int cout, int has_ds, int stages) {
  const long long row = (long long)(p + APAD) * 2;
  const long long x1 = (long long)(ch + 2 * d) * (cw + 2 * d) * row;
  const long long y2 = 64LL * wg_rows(p) * row;
  return ZERO_BYTES + (long long)stages * stage_bytes(p, cout, has_ds) + x1 + y2;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; when !valid nothing is read and the 16 bytes are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// orders this thread's shared-memory accesses before later bulk copies
// (the async proxy) into the same bytes
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across wgmma's
// asynchronous window
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// B in shared memory, K-major without swizzle: 8 x 8 core matrices of 128
// contiguous bytes, the next 8 K at +128 B (LBO), the next 8 N at +BK/8 *
// 128 B (SBO)
__device__ __forceinline__ uint64_t b_desc(const bf16* p) {
  const uint64_t lbo = 128, sbo = BK / 8 * 128;
  return ((uint64_t)(smem_u32(p) & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32);
}

// d[64 x 64] += a[64 x 16] (registers, this warp's 16 rows) . B[16 x 64]
__device__ __forceinline__ void wgmma64(float (&d)[32], const unsigned (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// B: weights packed by the host into tiles of BN columns x BK rows of K (K =
// taps * kin, each tap's kin zero-padded to whole slices), each tile
// contiguous in core-matrix order, tiles ordered by N chunk, then K slice
struct BSrc {
  const bf16* w;
  int kin, taps;
};

// A read from shared memory in place (x1 windows, y2 rows): this lane's row
// offset, plus a per-tap offset (the 3x3's shifted window)
struct ResidentA {
  const bf16* base;
  const bf16* zero;
  int off, tap_y, tap_x, kin;
  __device__ void load(bf16*, int, int) const {}
  __device__ const bf16* frag(const bf16*, int tap, int c0, int kk) const {
    const int ci = c0 + kk + (threadIdx.x & 16) / 2;
    if (ci >= kin) return zero;
    const int ky = tap / 3;
    return base + off + ky * tap_y + (tap - 3 * ky) * tap_x + ci;
  }
};

// A streamed from device memory through the ring: one row pointer per
// 16-byte chunk this thread copies (null = a zero row)
template <int WGM>
struct StreamA {
  const bf16* row[WGM];
  const bf16* any;   // a valid address for the copies that read nothing
  int kin;
  __device__ void load(bf16* as, int, int c0) const {
#pragma unroll
    for (int j = 0; j < WGM; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int kc = (i & 3) * 8;
      const bool ok = row[j] != nullptr && c0 + kc < kin;
      cp_async16(as + (i >> 2) * (BK + APAD) + kc, ok ? row[j] + c0 + kc : any, ok);
    }
  }
  __device__ const bf16* frag(const bf16* as, int, int, int kk) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = (WGM == 2 ? warp * 16 : (warp & 3) * 16) + (lane & 15);
    return as + row * (BK + APAD) + kk + (lane >> 4) * 8;
  }
};

// this thread's place in a phase's layout: its warpgroup's first row and
// column, and the row of its warp's 16
template <int WGM, int NT>
struct Place {
  int wg_row, wg_col, warp_row;
  __device__ Place() {
    const int warp = threadIdx.x >> 5, wg = warp >> 2;
    wg_row = WGM == 2 ? wg * 64 : 0;
    wg_col = WGM == 2 ? 0 : wg * 64 * NT;
    warp_row = wg_row + (warp & 3) * 16;
  }
};

template <int NT>
using Acc = float[NT][32];

// the ring: S slices, one mbarrier each for its B tile; `next` is the
// stage of the next slice to use and `parity` the phase its barrier is in
// (the same in every thread)
template <int S>
struct Ring {
  static constexpr int stages = S;
  unsigned char* base;
  unsigned bars;  // shared address of the stages' 8-byte mbarriers
  int sbytes, next, parity;
};

__device__ __forceinline__ void mbar_expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// one bulk copy of `bytes` contiguous bytes that completes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// acc += A . B[n0 : n0 + BN] over K = taps * kin. B arrives as whole packed
// tiles, one bulk copy per slice (the host lays each (N chunk, K slice)
// tile out contiguously in core-matrix order); A rows that stream from
// device memory come through the same slice with cp.async. Slice t + stages
// - 1 is loaded while slice t is in use, into the stage that slice t - 1
// left: its wgmmas were waited for before the barrier.
template <int WGM, int NT, class A, class R>
__device__ __forceinline__ void gemm(Acc<NT>& acc, const A& a, const BSrc& b, int n0, R& ring) {
  constexpr int BN = 64 * NT * (2 / WGM);
  constexpr unsigned TILE = BN * BK * 2;
  const Place<WGM, NT> pl;
  constexpr int ahead = R::stages - 1;
  const int cpt = (b.kin + BK - 1) / BK, nk = b.taps * cpt;
  const bf16* src = b.w + (size_t)(n0 / BN) * nk * (TILE / 2);
  // slices go in K order: tap by tap, BK rows of a tap's kin at a time
  auto advance = [&](int& tap, int& c0) {
    c0 += BK;
    if (c0 >= b.kin) {
      c0 = 0;
      ++tap;
    }
  };
  int ld = ring.next, ld_tap = 0, ld_c0 = 0;  // where the next slice to load goes, and its K
  auto load = [&](int t) {
    unsigned char* st = ring.base + ld * ring.sbytes;
    if (threadIdx.x == 0) {
      mbar_expect_bytes(ring.bars + 8 * ld, TILE);
      bulk_load(st, src + (size_t)t * (TILE / 2), TILE, ring.bars + 8 * ld);
    }
    a.load(reinterpret_cast<bf16*>(st + b_bytes(WGM, NT)), ld_tap, ld_c0);
    ld = ld + 1 == R::stages ? 0 : ld + 1;
    advance(ld_tap, ld_c0);
  };
#pragma unroll
  for (int s = 0; s < ahead; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_regs(acc[j]);
  int tap = 0, c0 = 0;
  for (int t = 0; t < nk; ++t) {
    const int stage = ring.next;
    cp_wait<ahead - 1>();  // A of slice t is in
    mbar_wait(ring.bars + 8 * stage, ring.parity);
    __syncthreads();
    if (t + ahead < nk) load(t + ahead);
    cp_commit();
    const unsigned char* st = ring.base + stage * ring.sbytes;
    const bf16* bs = reinterpret_cast<const bf16*>(st);
    const bf16* as = reinterpret_cast<const bf16*>(st + b_bytes(WGM, NT));
    unsigned af[2][4];
    ldsm_x4(af[0], a.frag(as, tap, c0, 0));
    ldsm_x4(af[1], a.frag(as, tap, c0, 16));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        wgmma64(acc[j], af[kk], b_desc(bs + ((pl.wg_col + 64 * j) / 8 * (BK / 8) + 2 * kk) * 64));
    wg_commit();
    wg_wait<0>();
    if (++ring.next == R::stages) {
      ring.next = 0;
      ring.parity ^= 1;
    }
    advance(tap, c0);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_regs(acc[j]);
  cp_wait<0>();
  __syncthreads();
}

// One BM x BN output tile: zero the accumulators, run `main(acc)`, then
// `done(acc)`.
template <int WGM, int NT, class Main, class Done>
__device__ __forceinline__ void tile(const Main& main, const Done& done) {
  Acc<NT> acc;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
  main(acc);
  done(acc);
}

// hands each real (row, column pair) of the tile to ep: ep.row(m) gives a
// row token, ep.put(token, n, v0, v1) stores columns n and n + 1
template <int WGM, int NT, class EP>
__device__ __forceinline__ void scatter(const Acc<NT>& acc, int mvalid, int n0, int n,
                                        const EP& ep) {
  const int lane = threadIdx.x & 31;
  const Place<WGM, NT> pl;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = pl.warp_row + (lane >> 2) + h * 8;
    if (m >= mvalid) continue;
    const int tok = ep.row(m);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = n0 + pl.wg_col + 64 * j + 8 * q + (lane & 3) * 2;
        if (c < n) ep.put(tok, c, acc[j][4 * q + 2 * h], acc[j][4 * q + 2 * h + 1]);
      }
  }
}

struct Args {
  const bf16 *x, *w1, *w2, *w3, *wd;  // weights packed as BSrc says
  const float *b1, *b2, *b3, *bd;
  bf16* out;
  int h, w, cin, p, cout, d, ch, cw, sbytes;
};

// the block's geometry and buffers, shared by the phases
template <int S>
struct Geo {
  const bf16* xf;    // this frame's x
  bf16* of;          // this frame's out
  bf16* x1s;         // [(rows + 2d) * (cols + 2d)][P + APAD]
  bf16* y2s;         // [subtile][P + APAD]
  const bf16* zero;
  Ring<S> ring;
  int row0, col0, rows, cols, wp;  // wp = cols + 2d: x1 row length in pixels
};

__device__ __forceinline__ __nv_bfloat162 pack(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}

template <class G>
struct EpX1 {  // phase 1: x1 = relu(v + b1), exact zero outside the image
  const Args& s;
  const G& g;
  int m0;
  __device__ int row(int m) const {
    const int mm = m0 + m, r = mm / g.wp, c = mm - r * g.wp;
    const int y = g.row0 - s.d + r, xc = g.col0 - s.d + c;
    return 2 * mm + (y >= 0 && y < s.h && xc >= 0 && xc < s.w);
  }
  __device__ void put(int tok, int n, float v0, float v1) const {
    const float2 b = *reinterpret_cast<const float2*>(s.b1 + n);
    const bool in = tok & 1;
    *reinterpret_cast<__nv_bfloat162*>(g.x1s + (tok >> 1) * (s.p + APAD) + n) =
        in ? pack(fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f)) : pack(0.f, 0.f);
  }
};

template <class G>
struct EpY2 {  // phase 2: y2 = relu(v + b2) into the subtile buffer
  const Args& s;
  const G& g;
  __device__ int row(int m) const { return m; }
  __device__ void put(int m, int n, float v0, float v1) const {
    const float2 b = *reinterpret_cast<const float2*>(s.b2 + n);
    *reinterpret_cast<__nv_bfloat162*>(g.y2s + m * (s.p + APAD) + n) =
        pack(fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
  }
};

// phase 3's residual at this thread's accumulator positions (bf16 pairs),
// loaded before the tile's GEMM so that the loads are done by its end
template <int NT>
using Res = unsigned[2][NT][8];

template <int WGM, int NT, class G, class Pix>
__device__ __forceinline__ void load_res(Res<NT>& res, const Args& s, const G& g, int mv, int n0,
                                         const Pix& pix) {
  const int lane = threadIdx.x & 31;
  const Place<WGM, NT> pl;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = min(pl.warp_row + (lane >> 2) + h * 8, mv - 1);
    const unsigned* row = reinterpret_cast<const unsigned*>(g.xf + pix(m) * s.cin);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = n0 + pl.wg_col + 64 * j + 8 * q + (lane & 3) * 2;
        res[h][j][q] = n < s.cout ? __ldg(row + n / 2) : 0u;
      }
  }
}

// phase 3's epilogue for the tile of subtile pixels [m0, m0 + mv) and
// channels [n0, n0 + BN): out = relu(v + b3 + residual), rounded once, is
// staged in the (idle) ring and leaves as 16-byte row stores.
template <int WGM, int NT, class G, class Pix>
__device__ __forceinline__ void store_out(const Acc<NT>& acc, const Res<NT>& res, const Args& s,
                                          const G& g, int mv, int n0, const Pix& pix) {
  constexpr int BM = 64 * WGM, BN = 64 * NT * (2 / WGM), SP = BN + 8, CPR = BN / 8;
  bf16* stg = reinterpret_cast<bf16*>(g.ring.base);
  const int tid = threadIdx.x, lane = tid & 31;
  const Place<WGM, NT> pl;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = pl.warp_row + (lane >> 2) + h * 8;
    if (m >= mv) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = pl.wg_col + 64 * j + 8 * q + (lane & 3) * 2, n = n0 + c;
        if (n >= s.cout) continue;
        const float2 b = *reinterpret_cast<const float2*>(s.b3 + n);
        float2 r;
        if (s.wd != nullptr) {
          r = *reinterpret_cast<const float2*>(s.bd + n);
        } else {
          const unsigned u = res[h][j][q];
          r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
        }
        *reinterpret_cast<__nv_bfloat162*>(stg + m * SP + c) =
            pack(fmaxf(acc[j][4 * q + 2 * h] + b.x + r.x, 0.f),
                 fmaxf(acc[j][4 * q + 2 * h + 1] + b.y + r.y, 0.f));
      }
  }
  __syncthreads();
  for (int i = tid; i < BM * CPR; i += THREADS) {
    const int m = i / CPR, c = (i % CPR) * 8;
    if (m < mv && n0 + c < s.cout)
      *reinterpret_cast<uint4*>(g.of + pix(m) * s.cout + n0 + c) =
          *reinterpret_cast<const uint4*>(stg + m * SP + c);
  }
  fence_async();  // the ring's next bulk copies land where these were
  __syncthreads();
}

// a resident operand whose row m (clamped to the real rows) starts at
// element offset(m)
template <int WGM, int NT, class F>
__device__ __forceinline__ ResidentA resident(const bf16* base, const bf16* zero, int mvalid,
                                              int kin, const F& offset) {
  const Place<WGM, NT> pl;
  ResidentA a;
  a.base = base;
  a.zero = zero;
  a.kin = kin;
  a.tap_y = a.tap_x = 0;
  a.off = offset(min(pl.warp_row + (threadIdx.x & 15), mvalid - 1));
  return a;
}

// phase 1: x1 over the haloed tile, in BM-row tiles and BN-column chunks
template <int WGM, int NT, class G>
__device__ __forceinline__ void phase1(const Args& s, G& g) {
  constexpr int BM = 64 * WGM, BN = 64 * NT * (2 / WGM);
  const int m1 = (g.rows + 2 * s.d) * g.wp;
  for (int m0 = 0; m0 < m1; m0 += BM) {
    StreamA<WGM> a;
    a.any = s.x;
    a.kin = s.cin;
#pragma unroll
    for (int j = 0; j < WGM; ++j) {
      const int mm = m0 + ((threadIdx.x + j * THREADS) >> 2);
      const int r = mm / g.wp, c = mm - r * g.wp;
      const int y = g.row0 - s.d + r, xc = g.col0 - s.d + c;
      const bool in = mm < m1 && y >= 0 && y < s.h && xc >= 0 && xc < s.w;
      a.row[j] = in ? g.xf + ((size_t)y * s.w + xc) * s.cin : nullptr;
    }
    const BSrc b{s.w1, s.cin, 1};
    const EpX1<G> ep{s, g, m0};
    const int mv = min(BM, m1 - m0);
    for (int n0 = 0; n0 < s.p; n0 += BN)
      tile<WGM, NT>(
          [&](Acc<NT>& acc) { gemm<WGM, NT>(acc, a, b, n0, g.ring); },
          [&](const Acc<NT>& acc) { scatter<WGM, NT>(acc, mv, n0, s.p, ep); });
  }
}

// phase 2 for the subtile of pixels [ms, ms + mv): y2 = relu(3x3(x1) + b2)
template <int WGM, int NT, class G>
__device__ __forceinline__ void phase2(const Args& s, G& g, int ms, int mv) {
  constexpr int BN = 64 * NT * (2 / WGM);
  const int rp = s.p + APAD;
  ResidentA a = resident<WGM, NT>(g.x1s, g.zero, mv, s.p, [&](int m) {
    const int mm = ms + m, r = mm / g.cols, c = mm - r * g.cols;
    return (r * g.wp + c) * rp;
  });
  a.tap_y = s.d * g.wp * rp;
  a.tap_x = s.d * rp;
  const BSrc b{s.w2, s.p, 9};
  const EpY2<G> ep{s, g};
  for (int n0 = 0; n0 < s.p; n0 += BN)
    tile<WGM, NT>(
        [&](Acc<NT>& acc) { gemm<WGM, NT>(acc, a, b, n0, g.ring); },
        [&](const Acc<NT>& acc) { scatter<WGM, NT>(acc, mv, n0, s.p, ep); });
}

// phase 3 for the subtile: out = relu(y2 . W3 + b3 + residual) over Cout
template <int WGM, int NT, class G>
__device__ __forceinline__ void phase3(const Args& s, G& g, int ms, int mv) {
  constexpr int BM = 64 * WGM, BN = 64 * NT * (2 / WGM);
  const int rp = s.p + APAD;
  for (int m3 = 0; m3 < mv; m3 += BM) {
    const int mv3 = min(BM, mv - m3);
    const ResidentA a = resident<WGM, NT>(g.y2s + m3 * rp, g.zero, mv3, s.p,
                                          [&](int m) { return m * rp; });
    StreamA<WGM> ax;  // the projection's A: x at the output pixels
    ax.any = s.x;
    ax.kin = s.cin;
#pragma unroll
    for (int j = 0; j < WGM; ++j) {
      const int m = (threadIdx.x + j * THREADS) >> 2;
      const int mm = ms + m3 + m, r = mm / g.cols, c = mm - r * g.cols;
      ax.row[j] = m < mv3 ? g.xf + ((size_t)(g.row0 + r) * s.w + g.col0 + c) * s.cin : nullptr;
    }
    const BSrc b3{s.w3, s.p, 1}, bd{s.wd, s.cin, 1};
    auto pix = [&](int m) {  // frame pixel of the tile's row m
      const int mm = ms + m3 + m, r = mm / g.cols;
      return (size_t)(g.row0 + r) * s.w + g.col0 + mm - r * g.cols;
    };
    for (int n0 = 0; n0 < s.cout; n0 += BN) {
      Res<NT> res;
      tile<WGM, NT>(
          [&](Acc<NT>& acc) {
            if (s.wd == nullptr) load_res<WGM, NT>(res, s, g, mv3, n0, pix);
            gemm<WGM, NT>(acc, a, b3, n0, g.ring);
            if (s.wd != nullptr) gemm<WGM, NT>(acc, ax, bd, n0, g.ring);
          },
          [&](const Acc<NT>& acc) { store_out<WGM, NT>(acc, res, s, g, mv3, n0, pix); });
    }
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1) bottleneck_tc(const __grid_constant__ Args s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles_x = (s.w + s.cw - 1) / s.cw;
  Geo<S> g;
  g.row0 = (blockIdx.x / tiles_x) * s.ch;
  g.col0 = (blockIdx.x % tiles_x) * s.cw;
  g.rows = min(s.ch, s.h - g.row0);
  g.cols = min(s.cw, s.w - g.col0);
  g.wp = g.cols + 2 * s.d;
  g.xf = s.x + (size_t)blockIdx.y * s.h * s.w * s.cin;
  g.of = s.out + (size_t)blockIdx.y * s.h * s.w * s.cout;
  // [0, 16): zeros for A lanes past K; [64, 96): the ring's mbarriers
  g.zero = reinterpret_cast<const bf16*>(smem);
  g.ring = Ring<S>{smem + ZERO_BYTES, smem_u32(smem + 64), s.sbytes, 0, 0};
  g.x1s = reinterpret_cast<bf16*>(g.ring.base + S * s.sbytes);
  g.y2s = g.x1s + (size_t)(s.ch + 2 * s.d) * (s.cw + 2 * s.d) * (s.p + APAD);
  if (threadIdx.x < 4) reinterpret_cast<unsigned*>(smem)[threadIdx.x] = 0u;
  if (threadIdx.x < S)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(g.ring.bars + 8 * threadIdx.x)
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // layouts: 0 = (WGM 2, NT 1), 1 = (2, 2), 2 = (1, 2)
  const int lp = s.p <= 64 ? 0 : s.p <= 128 ? 1 : 2;
  const int lc = s.cout <= 64 ? 0 : s.cout <= 128 ? 1 : 2;
  switch (lp) {
    case 0: phase1<2, 1>(s, g); break;
    case 1: phase1<2, 2>(s, g); break;
    default: phase1<1, 2>(s, g); break;
  }
  const int m2 = g.rows * g.cols, sub = 64 * wg_rows(s.p);
  for (int ms = 0; ms < m2; ms += sub) {
    const int mv = min(sub, m2 - ms);
    switch (lp) {
      case 0: phase2<2, 1>(s, g, ms, mv); break;
      case 1: phase2<2, 2>(s, g, ms, mv); break;
      default: phase2<1, 2>(s, g, ms, mv); break;
    }
    switch (lc) {
      case 0: phase3<2, 1>(s, g, ms, mv); break;
      case 1: phase3<2, 2>(s, g, ms, mv); break;
      default: phase3<1, 2>(s, g, ms, mv); break;
    }
  }
}

}  // namespace tc

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace


// Shared memory a block needs for a tile of ch x cw output pixels:
// itemsize 4 = the fp32 route, 2 = the bf16 tensor-core route with a ring
// of `stages` slices.
extern "C" long long bottleneck_smem_bytes(int ch, int cw, int p, int d, int itemsize, int cout,
                                           int has_ds, int stages) {
  return itemsize == 4 ? fp32_smem_bytes(ch, cw, p, d)
                       : tc::smem_bytes(ch, cw, p, d, cout, has_ds, stages);
}

// dtype: 0 = float32, 1 = bfloat16 (with a ring of `stages` slices, 3 or
// 4; the fp32 route ignores it); wd/bd null when the block has no
// projection. Returns a cudaError_t (0 = launched).
extern "C" int bottleneck_fwd_launch(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, const void* w3,
                                     const void* b3, const void* wd, const void* bd,
                                     void* out, int n, int h, int w, int cin, int p,
                                     int cout, int d, int ch, int cw, int stages,
                                     int dtype, void* stream) {
  const int has_ds = wd != nullptr;
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || p <= 0 || cout <= 0 || d <= 0 ||
      ch <= 0 || cw <= 0 || (!has_ds && cin != cout) || n > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(((h + ch - 1) / ch) * ((w + cw - 1) / cw), n);
  const size_t smem =
      (size_t)bottleneck_smem_bytes(ch, cw, p, d, dtype == 0 ? 4 : 2, cout, has_ds, stages);
  if (dtype == 0) {
    cudaError_t err = cudaFuncSetAttribute(bottleneck_fwd,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    Shape s{n, h, w, cin, p, cout, d, ch, cw, has_ds};
    bottleneck_fwd<<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<const float*>(w3),
        static_cast<const float*>(b3), static_cast<const float*>(wd),
        static_cast<const float*>(bd), static_cast<float*>(out), s);
    return (int)cudaGetLastError();
  }
  // the tensor-core route copies 16-byte chunks of channels
  const void* ptrs[] = {x, w1, w2, w3, out};
  for (const void* q : ptrs)
    if (!aligned16(q)) return (int)cudaErrorMisalignedAddress;
  if ((has_ds && !aligned16(wd)) || cin % 8 || p % 8 || cout % 8 || stages < 3 ||
      stages > tc::MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const tc::Args) = stages == 4 ? tc::bottleneck_tc<4> : tc::bottleneck_tc<3>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  using tc::bf16;
  const tc::Args s{static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                   static_cast<const bf16*>(w2), static_cast<const bf16*>(w3),
                   static_cast<const bf16*>(wd), static_cast<const float*>(b1),
                   static_cast<const float*>(b2), static_cast<const float*>(b3),
                   static_cast<const float*>(bd), static_cast<bf16*>(out),
                   h, w, cin, p, cout, d, ch, cw, tc::stage_bytes(p, cout, has_ds)};
  kernel<<<grid, THREADS, smem, st>>>(s);
  return (int)cudaGetLastError();
}
