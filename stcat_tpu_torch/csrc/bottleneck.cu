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
// top: every block streams the weight matrices from L2 once per BM rows of
// pixels (BM = 128 where P <= 256, 64 at P = 512, where the P = 512
// launches' 4-6 TB/s of weight traffic through L2 is the bound), and each
// 32-deep K slice's handoff from the producers to the tensor cores.
//
// Design of bottleneck_tc: warp-specialised, one block of 384 threads per
// (frame, tile of CH x CW output pixels), all of Cout. The activations stay
// resident in shared memory; the weights are the streamed operand. The host
// picks the tile that fits 227 KB with the least tensor-core work (halo
// recompute and rows rounded up to BM counted) and a ring of 3 to 6 slices.
//   * consumers: warps 0-7, two warpgroups, run every GEMM on wgmma m64n64k16
//     or m64n128k16 (bf16 in, fp32 accumulators in registers), both operands
//     read from shared memory through descriptors (K-major 8 x 8 core
//     matrices, no swizzle), and all the epilogues. In a block with P <= 256
//     the warpgroups split M, so that a weight slice serves 128 pixels; at
//     P = 512 they split N (a 128-row y2 would not fit beside x1). Per slice
//     they wait on the stage's full barrier, issue its two k16 wgmmas as one
//     group, wait for that group, and each warp arrives on the stage's empty
//     barrier at once, while the producers' copies of the next slices are
//     already in flight. No register is written by other instructions while
//     a group is in flight (ptxas would serialise every wgmma otherwise: A
//     from registers does that).
//   * producers: warps 8-11 give registers to the consumers (setmaxnreg).
//     Warp 8 first asks L2 for the block's x rows (cp.async.bulk.prefetch);
//     then its lane 0, the B thread, waits on each stage's empty barrier and
//     issues the slice's packed weight tile as one cp.async.bulk with its
//     byte count on the full barrier. Warps 9-11, the A warps, fill the same
//     stage's A tile: phase 1's and the projection's x rows by cp.async (the
//     barrier counts them), phase 2's shifted 3x3 windows of x1 by 16-byte
//     shared-memory copies followed by fence.proxy.async; then each A warp
//     arrives. A full barrier completes on four arrivals and the B bytes. The
//     B thread and the A warps walk the same slices, each at its own pace.
//   * barriers: full[s] and empty[s] per ring stage; x1_ready (the
//     consumers' phase 1 is stored; the A warps wait on it before their first
//     3x3 window; the B thread runs ahead); named barrier 1 among the
//     consumers only, twice per subtile, where y2 changes hands. There is no
//     block-wide barrier after the set-up.
//   * phase 1: x1 over the tile and its d-wide halo (zero rows outside the
//     image, stored as exact zeros); x1 rows are padded by 16 bytes, so the A
//     warps' 8-row copies read 8 bank groups.
//   * phases 2 and 3 run per subtile of BM output pixels: the 3x3 as one GEMM
//     with K = 9*P, the subtile's y2 stored in core-matrix order (K padded to
//     whole slices with zeros), fenced for the async proxy; then the closing
//     1x1 (+ the projection on the same accumulators) over Cout in chunks.
//   * epilogues add bias in fp32 (the biases loaded into registers before any
//     store), ReLU, round once. Phase 3's residual is loaded before the
//     chunk's GEMM; it and the output move as 16-byte groups, exchanged
//     within each quad of lanes, so that a warp's access covers 64
//     contiguous bytes of each of its rows.
//   * rows past the tile's pixels compute on repeated or zero rows; their
//     results are dropped.

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
constexpr int BK = 32;            // K rows per ring slice: two k16 steps
constexpr int MAX_STAGES = 6;     // ring depth: 3 to 6 slices, the host's choice per shape
constexpr int APAD = 8;           // elements (16 B) added to every x1 pixel row in shared memory
constexpr int HEAD_BYTES = 128;   // the block's mbarriers, before the ring
constexpr int BARS = 16;          // byte offset of the full barriers; the empty ones follow
constexpr int CONSUMERS = 256;    // warps 0-7, two warpgroups: wgmma and the epilogues
constexpr int PRODUCERS = 128;    // warps 8-11: fill the ring
constexpr int THREADS_TC = CONSUMERS + PRODUCERS;
constexpr int A_WARPS = 3;        // warps 9-11 put the A tiles; warp 8's lane 0 issues the B tiles
// registers per thread after the producers give theirs to the consumers
// (setmaxnreg) within the block's launch-time 384 x 168: 128 x 88 + 256 x 208 = 64512
constexpr int PRODUCER_REGS = 88, CONSUMER_REGS = 208;
static_assert(PRODUCERS * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <=
                  THREADS_TC * (65536 / THREADS_TC / 8 * 8),
              "setmaxnreg.inc would wait forever for registers the block does not hold");
static_assert(BARS + 16 * MAX_STAGES <= HEAD_BYTES, "the ring's barriers fit the head");

// A GEMM's layout: the two consumer warpgroups split M (64 rows each) in
// every phase of a block with P <= 256, so that each weight slice serves 128
// pixels, and N in a block with wider P, whose 128-row y2 would not fit
// beside x1; each warpgroup issues one m64nWk16 per k16 step, W = 64 * NT,
// NT by the GEMM's N. BM = 64 * WGM, BN = W * (2 / WGM).
__host__ __device__ constexpr int wg_rows(int p) { return p <= 256 ? 2 : 1; }
__host__ __device__ constexpr int n_tiles(int n) { return n <= 64 ? 1 : 2; }
__host__ __device__ constexpr int a_bytes(int wgm) { return 64 * wgm * BK * 2; }
__host__ __device__ constexpr int b_bytes(int wgm, int nt) { return BK * 64 * nt * (2 / wgm) * 2; }
// y2's K extent: P rounded up to whole slices, the rounding kept zero
__host__ __device__ constexpr int k_pad(int p) { return (p + BK - 1) / BK * BK; }

// a stage holds one slice's B tile and, for every phase but the projection-
// free phase 3, its A tile
__host__ __device__ inline int stage_bytes(int p, int cout, int has_ds) {
  const int wgm = wg_rows(p);
  const int s1 = a_bytes(wgm) + b_bytes(wgm, n_tiles(p));                  // phases 1, 2
  const int s3 = b_bytes(wgm, n_tiles(cout)) + (has_ds ? a_bytes(wgm) : 0);  // phase 3
  return s1 > s3 ? s1 : s3;
}

long long smem_bytes(int ch, int cw, int p, int d, int cout, int has_ds, int stages) {
  const long long x1 = (long long)(ch + 2 * d) * (cw + 2 * d) * (p + APAD) * 2;
  const long long y2 = 64LL * wg_rows(p) * k_pad(p) * 2;
  return HEAD_BYTES + (long long)stages * stage_bytes(p, cout, has_ds) + x1 + y2;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; when !valid nothing is read and the 16 bytes are zeroed
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// an arrival on `bar` once this thread's earlier cp.async copies have
// landed; the barrier's pending count rises by one now, so its phase cannot
// complete before they do
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// orders shared-memory writes of the generic proxy (st.shared, cp.async)
// before later reads of the async proxy (wgmma's operands)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// An operand in shared memory, K-major without swizzle: 8 x 8 core matrices
// of 128 contiguous bytes, the next 8 K at +128 B (LBO), the next 8 rows
// (of A's M or B's N) at +sbo B. B tiles and staged A tiles are BK deep (sbo
// 512); y2 is k_pad(P) deep.
__device__ __forceinline__ uint64_t desc(const void* p, unsigned sbo) {
  return ((uint64_t)(smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
constexpr unsigned SLICE_SBO = BK / 8 * 128;
// byte offset of 16-byte chunk (row r, K column k) in a BK-deep tile
__host__ __device__ constexpr int core_off(int r, int k) {
  return ((r >> 3) * (BK / 8) + (k >> 3)) * 128 + (r & 7) * 16;
}

template <int NT>
using Acc = float[NT][32];

// d[64 x 64 NT] += A[64 x 16] . B[16 x 64 NT], both read from shared memory
__device__ __forceinline__ void mma(Acc<1>& d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]), "+f"(d[0][5]),
        "+f"(d[0][6]), "+f"(d[0][7]), "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
        "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]), "+f"(d[0][16]),
        "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]), "+f"(d[0][20]), "+f"(d[0][21]),
        "+f"(d[0][22]), "+f"(d[0][23]), "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]),
        "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31])
      : "l"(a), "l"(b), "r"(1));
}
// the accumulators of m64n128 are those of two m64n64 side by side: d[0]
// holds columns 0-63, d[1] columns 64-127
__device__ __forceinline__ void mma(Acc<2>& d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]), "+f"(d[0][5]),
        "+f"(d[0][6]), "+f"(d[0][7]), "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
        "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]), "+f"(d[0][16]),
        "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]), "+f"(d[0][20]), "+f"(d[0][21]),
        "+f"(d[0][22]), "+f"(d[0][23]), "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]),
        "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]),
        "+f"(d[1][6]), "+f"(d[1][7]), "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]),
        "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]), "+f"(d[1][16]),
        "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]),
        "+f"(d[1][22]), "+f"(d[1][23]), "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]),
        "+f"(d[1][27]), "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
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
// waits until the barrier's phase of this parity has completed
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
// the consumer warps' own barrier (named barrier 1); the producers never join it
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}
// an arrival of this warp (lane 0, after the warp's lanes) on `bar`
__device__ __forceinline__ void warp_arrive(unsigned bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// The ring: `stages` slices, each with a full barrier (the B thread's
// arrival carrying the B tile's bytes and one arrival per A warp; streamed
// A copies hold the phase open until they land) and an empty barrier (one
// arrival per consumer warp done with it). The producers and the consumers
// walk the same sequence of slices, each with its own copy of this: `stage`
// is the next slice's and `phase` the phase its barriers are in.
struct Pipe {
  unsigned char* base;
  unsigned bars;  // shared address of the full barriers; the empty ones follow
  int sbytes, stages, stage, phase;
  __device__ unsigned char* data() const { return base + stage * sbytes; }
  __device__ unsigned full(int s) const { return bars + 8 * s; }
  __device__ unsigned empty(int s) const { return bars + 8 * (MAX_STAGES + s); }
  __device__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// B: weights packed by the host into tiles of BN columns x BK rows of K (K =
// taps * kin, each tap's kin zero-padded to whole slices), each tile
// contiguous in core-matrix order, tiles ordered by N chunk, then K slice
struct BSrc {
  const bf16* w;
  int kin, taps;
  __device__ int slices() const { return taps * ((kin + BK - 1) / BK); }
};

// an A warp's thread's share of a slice's A tile (BM rows x BK): rows
// lane % 8 + 8 (w + 3 j) for A warp w, 16-byte chunk lane / 8 of each, so
// that each quarter-warp moves 8 rows of one chunk (bank-conflict free at
// both ends); J(WGM) of them, the last where 8 (w + 3 j) < BM
template <int WGM>
__host__ __device__ constexpr int puts() { return (8 * WGM + A_WARPS - 1) / A_WARPS; }
__device__ __forceinline__ int a_warp() { return ((int)threadIdx.x - CONSUMERS - 32) >> 5; }
__device__ __forceinline__ int put_row(int j) {
  return (threadIdx.x & 7) + 8 * (a_warp() + A_WARPS * j);
}
template <int WGM>
__device__ __forceinline__ bool puts_row(int j) { return a_warp() + A_WARPS * j < 8 * WGM; }
__device__ __forceinline__ int put_col() { return ((threadIdx.x >> 3) & 3) * 8; }

// A streamed from device memory (phase 1's x pixels, the projection's x):
// the source row of each chunk this thread copies (null = a zero row); the
// copies count on the stage's full barrier
template <int WGM>
struct StreamA {
  const bf16* row[puts<WGM>()];
  const bf16* any;  // a valid address for the copies that read nothing
  int kin;
  __device__ void put(unsigned char* as, int, int c0, unsigned full) const {
    const int kc = put_col();
    const unsigned base = smem_u32(as);
#pragma unroll
    for (int j = 0; j < puts<WGM>(); ++j) {
      if (!puts_row<WGM>(j)) break;
      const bool ok = row[j] != nullptr && c0 + kc < kin;
      cp_async16(base + core_off(put_row(j), kc), ok ? row[j] + c0 + kc : any, ok);
    }
    cp_async_arrive(full);
  }
};
// phase 2's A, gathered from x1 in shared memory: each row is the x1 pixel
// under one output pixel of the subtile, shifted by the tap
template <int WGM>
struct WindowA {
  const bf16* x1;
  int row[puts<WGM>()];  // element offset of each of this thread's rows' pixel
  int tap_y, tap_x, kin;
  __device__ void put(unsigned char* as, int tap, int c0, unsigned) const {
    const int kc = put_col(), ky = tap / 3;
    const bf16* src = x1 + ky * tap_y + (tap - 3 * ky) * tap_x + c0 + kc;
    uint4 v[puts<WGM>()];  // every load before the first store, which may alias them
#pragma unroll
    for (int j = 0; j < puts<WGM>(); ++j)
      v[j] = puts_row<WGM>(j) && c0 + kc < kin ? *reinterpret_cast<const uint4*>(src + row[j])
                                               : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < puts<WGM>(); ++j)
      if (puts_row<WGM>(j)) *reinterpret_cast<uint4*>(as + core_off(put_row(j), kc)) = v[j];
    fence_async();
  }
};
struct NoA {  // a resident A (y2): nothing to copy
  __device__ void put(unsigned char*, int, int, unsigned) const {}
};

// a consumer thread's place in a phase's layout: its warpgroup's first row
// and column, and the row of its warp's 16
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

// The producers' side of acc += A . B[n0 : n0 + BN]: for each slice, once
// the consumers have released its stage, the B thread (warp 8's lane 0)
// issues the B tile as one bulk copy, and the A warps put their shares of
// the A tile (if any) and arrive. The two walk the slices independently.
template <int WGM, int NT, class A>
__device__ __forceinline__ void fill(const A& a, const BSrc& b, int n0, Pipe& pp) {
  constexpr int BN = 64 * NT * (2 / WGM);
  constexpr unsigned TILE = BN * BK * 2;
  const int nk = b.slices();
  const bool b_thread = threadIdx.x == CONSUMERS;
  const bf16* src = b.w + (size_t)(n0 / BN) * nk * (TILE / 2);
  int tap = 0, c0 = 0;
  for (int t = 0; t < nk; ++t) {
    mbar_wait(pp.empty(pp.stage), pp.phase ^ 1);
    unsigned char* st = pp.data();
    const unsigned full = pp.full(pp.stage);
    if (b_thread) {
      mbar_expect_bytes(full, TILE);
      bulk_load(st, src + (size_t)t * (TILE / 2), TILE, full);
    } else {
      a.put(st + b_bytes(WGM, NT), tap, c0, full);
      warp_arrive(full);
    }
    pp.advance();
    c0 += BK;
    if (c0 >= b.kin) {
      c0 = 0;
      ++tap;
    }
  }
}

// A as the consumers' wgmma reads it: a staged tile in the ring stage, or y2
template <int WGM, bool STREAMED>
struct StageA {
  static constexpr bool fenced = STREAMED;  // cp.async copies: the reader fences
  int wg_off;  // this warpgroup's first row in the tile, in bytes
  __device__ StageA() : wg_off(core_off(WGM == 2 ? (threadIdx.x >> 7) * 64 : 0, 0)) {}
  __device__ uint64_t at(const unsigned char* as, int, int kk) const {
    return desc(as + wg_off + 256 * kk, SLICE_SBO);
  }
};
struct Y2A {
  static constexpr bool fenced = false;
  const unsigned char* base;  // this warpgroup's first row of the GEMM tile
  unsigned sbo;
  __device__ uint64_t at(const unsigned char*, int c0, int kk) const {
    return desc(base + (c0 / 8 + 2 * kk) * 128, sbo);
  }
};

// this warp's arrival on a stage's empty barrier: its reads of the stage are done
__device__ __forceinline__ void release(const Pipe& pp, int stage) {
  warp_arrive(pp.empty(stage));
}

// The consumers' side: per slice, wait for its stage to fill, issue the
// slice's two wgmmas (both operands read from shared memory) as one group,
// wait for it, and hand the stage straight back to the producers, whose
// copies of the next slices are in flight meanwhile. Holding each stage
// until the next group is issued (wgmma.wait_group 1) keeps one stage fewer
// in flight: on the H100, 11-14% slower on the 3-stage rings and 1-3% slower
// on the deeper ones.
template <int WGM, int NT, class A>
__device__ __forceinline__ void consume(Acc<NT>& acc, const A& a, const BSrc& b, Pipe& pp) {
  const Place<WGM, NT> pl;
  const int nk = b.slices();
  const int bcol = core_off(pl.wg_col, 0);  // this warpgroup's first column in a B tile
  int c0 = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_regs(acc[j]);
  for (int t = 0; t < nk; ++t) {
    mbar_wait(pp.full(pp.stage), pp.phase);
    if (A::fenced) fence_async();
    const unsigned char* st = pp.data();
    const unsigned char* as = st + b_bytes(WGM, NT);
    wg_fence();
    mma(acc, a.at(as, c0, 0), desc(st + bcol, SLICE_SBO));
    mma(acc, a.at(as, c0, 1), desc(st + bcol + 256, SLICE_SBO));  // the next k16: two core matrices on
    wg_commit();
    wg_wait<0>();
    release(pp, pp.stage);
    pp.advance();
    c0 = c0 + BK < b.kin ? c0 + BK : 0;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_regs(acc[j]);
}

template <int NT>
__device__ __forceinline__ void zero(Acc<NT>& acc) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
}

// the bias pair of each column pair this thread holds, loaded before any of
// the epilogue's stores (which the compiler cannot tell apart from the
// bias, so a load after a store would wait for it)
template <int NT>
using Bias = float2[NT][8];

template <int WGM, int NT>
__device__ __forceinline__ void load_bias(Bias<NT>& bias, const float* b, int n0, int n) {
  const Place<WGM, NT> pl;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = min(n0 + pl.wg_col + 64 * j + 8 * q + (threadIdx.x & 3) * 2, n - 2);
      bias[j][q] = __ldg(reinterpret_cast<const float2*>(b + c));
    }
}

// hands each real (row, column pair) of the tile, its bias added, to ep:
// ep.row(m) gives a row token, ep.put(token, n, v0, v1) stores columns n
// and n + 1
template <int WGM, int NT, class EP>
__device__ __forceinline__ void scatter(const Acc<NT>& acc, int mvalid, int n0, int n,
                                        const float* b, const EP& ep) {
  const int lane = threadIdx.x & 31;
  const Place<WGM, NT> pl;
  Bias<NT> bias;
  load_bias<WGM, NT>(bias, b, n0, n);
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
        if (c < n)
          ep.put(tok, c, acc[j][4 * q + 2 * h] + bias[j][q].x,
                 acc[j][4 * q + 2 * h + 1] + bias[j][q].y);
      }
  }
}

struct Args {
  const bf16 *x, *w1, *w2, *w3, *wd;  // weights packed as BSrc says
  const float *b1, *b2, *b3, *bd;
  bf16* out;
  int h, w, cin, p, cout, d, ch, cw, sbytes, stages;
};

// the block's geometry and buffers, shared by the phases
struct Geo {
  const bf16* xf;    // this frame's x
  bf16* of;          // this frame's out
  bf16* x1s;         // [(rows + 2d) * (cols + 2d)][P + APAD]
  bf16* y2s;         // [subtile][k_pad(P)] in core-matrix order
  unsigned x1_ready; // mbarrier: the consumers' phase 1 is stored
  Pipe pipe;
  int row0, col0, rows, cols, wp;  // wp = cols + 2d: x1 row length in pixels
};

__device__ __forceinline__ __nv_bfloat162 pack(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}

struct EpX1 {  // phase 1: x1 = relu(v), v with b1, exact zero outside the image
  const Args& s;
  const Geo& g;
  int m0;
  __device__ int row(int m) const {
    const int mm = m0 + m, r = mm / g.wp, c = mm - r * g.wp;
    const int y = g.row0 - s.d + r, xc = g.col0 - s.d + c;
    return 2 * mm + (y >= 0 && y < s.h && xc >= 0 && xc < s.w);
  }
  __device__ void put(int tok, int n, float v0, float v1) const {
    const bool in = tok & 1;
    *reinterpret_cast<__nv_bfloat162*>(g.x1s + (tok >> 1) * (s.p + APAD) + n) =
        in ? pack(fmaxf(v0, 0.f), fmaxf(v1, 0.f)) : pack(0.f, 0.f);
  }
};

struct EpY2 {  // phase 2: y2 = relu(v), v with b2, into the subtile buffer in core-matrix order
  const Args& s;
  const Geo& g;
  __device__ int row(int m) const { return m; }
  __device__ void put(int m, int n, float v0, float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(
        g.y2s + ((m >> 3) * (k_pad(s.p) / 8) + (n >> 3)) * 64 + (m & 7) * 8 + (n & 7)) =
        pack(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
  }
};

// Phase 3's epilogue moves whole 16-byte groups of 8 channels. The
// accumulators give lane t (= lane % 4) of each quad the column pair
// 8 q + 2 t of every 8-column group q of a 64-column block; the group layout
// gives it groups t and 4 + t whole, so that a warp's access covers 64
// contiguous bytes of each of its 8 rows. to_groups moves one word per group
// (a bf16 pair) from the first layout to the second, from_groups back: two
// exchanges inside the quad each.
__device__ __forceinline__ void to_groups(const unsigned (&w)[8], uint4 (&y)[2]) {
  const bool odd = threadIdx.x & 1, high = threadIdx.x & 2;
  unsigned x[4][2];  // x[u]: 4 columns of groups 2u, 2u + 1
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const unsigned got = __shfl_xor_sync(0xffffffffu, odd ? w[2 * u] : w[2 * u + 1], 1);
    x[u][0] = odd ? got : w[2 * u];
    x[u][1] = odd ? w[2 * u + 1] : got;
  }
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const unsigned g0 = __shfl_xor_sync(0xffffffffu, high ? x[2 * v][0] : x[2 * v + 1][0], 2);
    const unsigned g1 = __shfl_xor_sync(0xffffffffu, high ? x[2 * v][1] : x[2 * v + 1][1], 2);
    y[v] = high ? make_uint4(g0, g1, x[2 * v + 1][0], x[2 * v + 1][1])
                : make_uint4(x[2 * v][0], x[2 * v][1], g0, g1);
  }
}
__device__ __forceinline__ void from_groups(const uint4 (&y)[2], unsigned (&w)[8]) {
  const bool odd = threadIdx.x & 1, high = threadIdx.x & 2;
  unsigned x[4][2];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const unsigned g0 = __shfl_xor_sync(0xffffffffu, high ? y[v].x : y[v].z, 2);
    const unsigned g1 = __shfl_xor_sync(0xffffffffu, high ? y[v].y : y[v].w, 2);
    x[2 * v][0] = high ? g0 : y[v].x;
    x[2 * v][1] = high ? g1 : y[v].y;
    x[2 * v + 1][0] = high ? y[v].z : g0;
    x[2 * v + 1][1] = high ? y[v].w : g1;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const unsigned got = __shfl_xor_sync(0xffffffffu, odd ? x[u][0] : x[u][1], 1);
    w[2 * u] = odd ? got : x[u][0];
    w[2 * u + 1] = odd ? x[u][1] : got;
  }
}

// phase 3's residual in the group layout: rows lane / 4 and 8 + lane / 4 of
// this warp's 16, groups lane % 4 and 4 + lane % 4 of each 64-column block.
// Loaded before the tile's GEMM (volatile asm, which the compiler keeps
// ahead of the wgmmas) so that the loads are done by its end.
template <int NT>
using Res = uint4[2][NT][2];

__device__ __forceinline__ uint4 ld_early(const bf16* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// the column of this lane's group v in 64-column block j
template <int WGM, int NT>
__device__ __forceinline__ int group_col(const Place<WGM, NT>& pl, int n0, int j, int v) {
  return n0 + pl.wg_col + 64 * j + 32 * v + 8 * (threadIdx.x & 3);
}

template <int WGM, int NT, class Pix>
__device__ __forceinline__ void load_res(Res<NT>& res, const Args& s, const Geo& g, int mv, int n0,
                                         const Pix& pix) {
  const Place<WGM, NT> pl;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = min(pl.warp_row + ((threadIdx.x & 31) >> 2) + h * 8, mv - 1);
    const bf16* row = g.xf + pix(m) * s.cin;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        res[h][j][v] = ld_early(row + min(group_col(pl, n0, j, v), s.cout - 8));
  }
}

__device__ __forceinline__ unsigned pack_u32(float a, float b) {
  const __nv_bfloat162 h = pack(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// phase 3's epilogue for the tile of subtile pixels [m0, m0 + mv) and
// channels [n0, n0 + BN): out = relu(v + b3 + residual), the projection's
// residual being its bias bd (added to b3 first), rounded once and stored
// as 16-byte groups. Each block's biases are loaded before its stores.
template <int WGM, int NT, class Pix>
__device__ __forceinline__ void store_out(const Acc<NT>& acc, const Res<NT>& res, const Args& s,
                                          const Geo& g, int mv, int n0, const Pix& pix) {
  const int lane = threadIdx.x & 31;
  const Place<WGM, NT> pl;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float2 bias[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = min(n0 + pl.wg_col + 64 * j + 8 * q + (lane & 3) * 2, s.cout - 2);
      bias[q] = __ldg(reinterpret_cast<const float2*>(s.b3 + c));
      if (s.bd != nullptr) {
        const float2 e = __ldg(reinterpret_cast<const float2*>(s.bd + c));
        bias[q].x += e.x;
        bias[q].y += e.y;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = pl.warp_row + (lane >> 2) + h * 8;
      unsigned r[8] = {};
      if (s.wd == nullptr) from_groups(res[h][j], r);
      unsigned w[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[q]));
        w[q] = pack_u32(fmaxf(acc[j][4 * q + 2 * h] + bias[q].x + rf.x, 0.f),
                        fmaxf(acc[j][4 * q + 2 * h + 1] + bias[q].y + rf.y, 0.f));
      }
      uint4 y[2];
      to_groups(w, y);
      if (m >= mv) continue;
      bf16* row = g.of + pix(m) * s.cout;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int n = group_col(pl, n0, j, v);
        if (n < s.cout) *reinterpret_cast<uint4*>(row + n) = y[v];
      }
    }
  }
}

// Each phase below runs on both sides of the ring: LOAD = the B thread and
// the A warps (fill), otherwise the consumer warpgroups (consume and the
// epilogue); all walk the same GEMMs in the same order.

// phase 1: x1 over the haloed tile, in BM-row tiles and BN-column chunks
template <bool LOAD, int WGM, int NT>
__device__ __forceinline__ void phase1(const Args& s, Geo& g) {
  constexpr int BM = 64 * WGM, BN = 64 * NT * (2 / WGM);
  const int m1 = (g.rows + 2 * s.d) * g.wp;
  const BSrc b{s.w1, s.cin, 1};
  for (int m0 = 0; m0 < m1; m0 += BM) {
    if constexpr (LOAD) {
      StreamA<WGM> a;
      a.any = s.x;
      a.kin = s.cin;
#pragma unroll
      for (int j = 0; j < puts<WGM>(); ++j) {
        const int mm = m0 + put_row(j);
        const int r = mm / g.wp, c = mm - r * g.wp;
        const int y = g.row0 - s.d + r, xc = g.col0 - s.d + c;
        const bool in = mm < m1 && y >= 0 && y < s.h && xc >= 0 && xc < s.w;
        a.row[j] = in ? g.xf + ((size_t)y * s.w + xc) * s.cin : nullptr;
      }
      for (int n0 = 0; n0 < s.p; n0 += BN) fill<WGM, NT>(a, b, n0, g.pipe);
    } else {
      const EpX1 ep{s, g, m0};
      const int mv = min(BM, m1 - m0);
      for (int n0 = 0; n0 < s.p; n0 += BN) {
        Acc<NT> acc;
        zero(acc);
        consume<WGM, NT>(acc, StageA<WGM, true>(), b, g.pipe);
        scatter<WGM, NT>(acc, mv, n0, s.p, s.b1, ep);
      }
    }
  }
}

// phase 2 for the subtile of pixels [ms, ms + mv): y2 = relu(3x3(x1) + b2)
template <bool LOAD, int WGM, int NT>
__device__ __forceinline__ void phase2(const Args& s, Geo& g, int ms, int mv) {
  constexpr int BN = 64 * NT * (2 / WGM);
  const BSrc b{s.w2, s.p, 9};
  if constexpr (LOAD) {
    const int rp = s.p + APAD;
    WindowA<WGM> a;
    a.x1 = g.x1s;
    a.kin = s.p;
    a.tap_y = s.d * g.wp * rp;
    a.tap_x = s.d * rp;
#pragma unroll
    for (int j = 0; j < puts<WGM>(); ++j) {  // rows past the subtile repeat its last pixel
      const int mm = ms + min(max(put_row(j), 0), mv - 1), r = mm / g.cols, c = mm - r * g.cols;
      a.row[j] = (r * g.wp + c) * rp;
    }
    for (int n0 = 0; n0 < s.p; n0 += BN) fill<WGM, NT>(a, b, n0, g.pipe);
  } else {
    const EpY2 ep{s, g};
    for (int n0 = 0; n0 < s.p; n0 += BN) {
      Acc<NT> acc;
      zero(acc);
      consume<WGM, NT>(acc, StageA<WGM, false>(), b, g.pipe);
      scatter<WGM, NT>(acc, mv, n0, s.p, s.b2, ep);
    }
  }
}

// phase 3 for the subtile: out = relu(y2 . W3 + b3 + residual) over Cout;
// the projection's GEMM (A = x at the output pixels) follows W3's on the
// same accumulators
template <bool LOAD, int WGM, int NT>
__device__ __forceinline__ void phase3(const Args& s, Geo& g, int ms, int mv) {
  constexpr int BM = 64 * WGM, BN = 64 * NT * (2 / WGM);
  const BSrc b3{s.w3, s.p, 1}, bd{s.wd, s.cin, 1};
  for (int m3 = 0; m3 < mv; m3 += BM) {
    const int mv3 = min(BM, mv - m3);
    auto pix = [&](int m) {  // frame pixel of the tile's row m
      const int mm = ms + m3 + m, r = mm / g.cols;
      return (size_t)(g.row0 + r) * s.w + g.col0 + mm - r * g.cols;
    };
    if constexpr (LOAD) {
      StreamA<WGM> ax;
      ax.any = s.x;
      ax.kin = s.cin;
#pragma unroll
      for (int j = 0; j < puts<WGM>(); ++j) {
        const int m = put_row(j);
        ax.row[j] = m >= 0 && m < mv3 ? g.xf + pix(m) * s.cin : nullptr;
      }
      for (int n0 = 0; n0 < s.cout; n0 += BN) {
        fill<WGM, NT>(NoA{}, b3, n0, g.pipe);
        if (s.wd != nullptr) fill<WGM, NT>(ax, bd, n0, g.pipe);
      }
    } else {
      const Place<WGM, NT> pl;
      const unsigned sbo = k_pad(s.p) / 8 * 128;  // bytes per 8 rows of y2
      const Y2A a{reinterpret_cast<const unsigned char*>(g.y2s) + (m3 + pl.wg_row) / 8 * sbo, sbo};
      for (int n0 = 0; n0 < s.cout; n0 += BN) {
        Res<NT> res;
        if (s.wd == nullptr) load_res<WGM, NT>(res, s, g, mv3, n0, pix);
        Acc<NT> acc;
        zero(acc);
        consume<WGM, NT>(acc, a, b3, g.pipe);
        if (s.wd != nullptr) consume<WGM, NT>(acc, StageA<WGM, true>(), bd, g.pipe);
        store_out<WGM, NT>(acc, res, s, g, mv3, n0, pix);
      }
    }
  }
}

// asks L2 for `bytes` bytes (a multiple of 16) at p, without waiting
__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// the block's phases in order, on one side of the ring. The producers
// read x1 once the consumers have stored all of it (the x1_ready barrier);
// the consumers meet at a barrier of their own where y2 changes hands.
template <bool LOAD>
__device__ __forceinline__ void run(const Args& s, Geo& g) {
  // layouts: 0 = (WGM 2, NT 1), 1 = (2, 2), 2 = (1, 1), 3 = (1, 2)
  const int split = wg_rows(s.p) == 2 ? 0 : 2;
  const int lp = split + (n_tiles(s.p) - 1), lc = split + (n_tiles(s.cout) - 1);
  switch (lp) {
    case 0: phase1<LOAD, 2, 1>(s, g); break;
    case 1: phase1<LOAD, 2, 2>(s, g); break;
    case 2: phase1<LOAD, 1, 1>(s, g); break;
    default: phase1<LOAD, 1, 2>(s, g); break;
  }
  if (!LOAD)
    warp_arrive(g.x1_ready);
  else if (threadIdx.x != CONSUMERS)  // the A warps read x1 from here on
    mbar_wait(g.x1_ready, 0);
  const int m2 = g.rows * g.cols, sub = 64 * wg_rows(s.p);
  for (int ms = 0; ms < m2; ms += sub) {
    const int mv = min(sub, m2 - ms);
    switch (lp) {
      case 0: phase2<LOAD, 2, 1>(s, g, ms, mv); break;
      case 1: phase2<LOAD, 2, 2>(s, g, ms, mv); break;
      case 2: phase2<LOAD, 1, 1>(s, g, ms, mv); break;
      default: phase2<LOAD, 1, 2>(s, g, ms, mv); break;
    }
    if (!LOAD) {  // the subtile's y2 stored and visible to wgmma before phase 3 reads it
      fence_async();
      consumers_sync();
    }
    switch (lc) {
      case 0: phase3<LOAD, 2, 1>(s, g, ms, mv); break;
      case 1: phase3<LOAD, 2, 2>(s, g, ms, mv); break;
      case 2: phase3<LOAD, 1, 1>(s, g, ms, mv); break;
      default: phase3<LOAD, 1, 2>(s, g, ms, mv); break;
    }
    if (!LOAD) consumers_sync();  // ... and read before the next subtile's replaces it
  }
}

__global__ void __launch_bounds__(THREADS_TC, 1) bottleneck_tc(const __grid_constant__ Args s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles_x = (s.w + s.cw - 1) / s.cw;
  Geo g;
  g.row0 = (blockIdx.x / tiles_x) * s.ch;
  g.col0 = (blockIdx.x % tiles_x) * s.cw;
  g.rows = min(s.ch, s.h - g.row0);
  g.cols = min(s.cw, s.w - g.col0);
  g.wp = g.cols + 2 * s.d;
  g.xf = s.x + (size_t)blockIdx.y * s.h * s.w * s.cin;
  g.of = s.out + (size_t)blockIdx.y * s.h * s.w * s.cout;
  // [0, 8): x1_ready; [BARS, BARS + 16 MAX_STAGES): the ring's mbarriers
  g.x1_ready = smem_u32(smem);
  g.pipe = Pipe{smem + HEAD_BYTES, smem_u32(smem + BARS), s.sbytes, s.stages, 0, 0};
  g.x1s = reinterpret_cast<bf16*>(g.pipe.base + s.stages * s.sbytes);
  g.y2s = g.x1s + (size_t)(s.ch + 2 * s.d) * (s.cw + 2 * s.d) * (s.p + APAD);
  if (threadIdx.x == 0) mbar_init(g.x1_ready, CONSUMERS / 32);
  if (threadIdx.x < s.stages) {
    mbar_init(g.pipe.full(threadIdx.x), 1 + A_WARPS);
    mbar_init(g.pipe.empty(threadIdx.x), CONSUMERS / 32);
  }
  if (s.p % BK) {  // y2's rounding of K to whole slices reads as zeros
    const int kp = k_pad(s.p), rows = 64 * wg_rows(s.p);
    for (int i = threadIdx.x; i < rows * (kp - s.p); i += THREADS_TC) {
      const int m = i / (kp - s.p), k = s.p + i % (kp - s.p);
      g.y2s[((m >> 3) * (kp / 8) + (k >> 3)) * 64 + (m & 7) * 8 + (k & 7)] = __float2bfloat16(0.f);
    }
    fence_async();
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < CONSUMERS + 32) {  // warp 8: the block's x into L2 (phase 1's A, the
      // residual, the projection's A), a row a lane; then its lane 0 is the B thread
      const int y0 = max(g.row0 - s.d, 0), y1 = min(g.row0 + g.rows + s.d, s.h);
      const int x0 = max(g.col0 - s.d, 0), x1 = min(g.col0 + g.cols + s.d, s.w);
      for (int y = y0 + (int)(threadIdx.x & 31); y < y1; y += 32)
        prefetch_l2(g.xf + ((size_t)y * s.w + x0) * s.cin, (unsigned)((x1 - x0) * s.cin * 2));
      if (threadIdx.x != CONSUMERS) return;
    }
    run<true>(s, g);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    run<false>(s, g);
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

// dtype: 0 = float32, 1 = bfloat16 (with a ring of `stages` slices, 3 to
// tc::MAX_STAGES; the fp32 route ignores it); wd/bd null when the block has
// no projection. Returns a cudaError_t (0 = launched).
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
  cudaError_t err = cudaFuncSetAttribute(tc::bottleneck_tc,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  using tc::bf16;
  const tc::Args s{static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                   static_cast<const bf16*>(w2), static_cast<const bf16*>(w3),
                   static_cast<const bf16*>(wd), static_cast<const float*>(b1),
                   static_cast<const float*>(b2), static_cast<const float*>(b3),
                   static_cast<const float*>(bd), static_cast<bf16*>(out),
                   h, w, cin, p, cout, d, ch, cw, tc::stage_bytes(p, cout, has_ds), stages};
  tc::bottleneck_tc<<<grid, tc::THREADS_TC, smem, st>>>(s);
  return (int)cudaGetLastError();
}
