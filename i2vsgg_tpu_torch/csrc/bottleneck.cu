// A chain of ResNet identity bottlenecks (FrozenBN folded into the weights),
// hand-written for Hopper (sm_90a) on the tensor cores.
//
// Replaces the Pallas TPU kernel
//   i2vsgg_tpu/ops/pallas/bottleneck_kernel.py::bottleneck_chain_pallas (B4)
// (the layer3 identity tail of the serving trunk under
// I2VSGG_PALLAS_BOTTLENECK=1).
//
// Contract (the plain PyTorch version is
// i2vsgg_tpu_torch/ops/bottleneck.py::bottleneck_chain_plain):
//   x     (B, H, W, C) bf16 NHWC, updated in place block after block;
//   w1    (n, C, M), w3 (n, 9, M, M) (tap dy * 3 + dx), w2 (n, M, C): the
//         folded kernels in bf16, each (K, N) row-major;
//   b1    (n, M), b3 (n, M), b2 (n, C) f32;
//   per block, with P = B * H * W pixels as GEMM rows:
//     a = bf16(relu(x @ W1 + b1))                      1x1 down, K = C
//     b = bf16(relu(conv3x3_zero_pad(a) @ W3 + b3))    3x3, K = 9 M
//     x = bf16(relu(x + (b @ W2 + b2)))                1x1 up, K = M
//   bf16 x bf16 products accumulate in f32 on the tensor cores; bias,
//   residual and ReLU are f32, rounded to bf16 (nearest even) once.
//
// What bounds it on an H100 (4 frames at 600x960: 38 x 60 x 1024, n = 22,
// M = 256): 2 * 9120 * (1024 * 256 + 9 * 256 * 256 + 256 * 1024) flops a
// block = 20.3 GFLOP, 447 GFLOP a chain: 0.452 ms at 989 TFLOP/s bf16,
// against 49 MB of folded weights and 2 x 18.7 MB of map (26 us at
// 3.35 TB/s). So operations: the work has to run on the tensor cores (the
// f32 FMA pipes would need 6.7 ms at their 67 TFLOP/s peak).
//
// What the TPU design does not carry over: it walks the blocks on a
// sequential grid and keeps one image's map in VMEM across the chain. Here
// blocks of threads run in no order, and 227 KB of shared memory cannot hold
// a 4.7 MB map. Every block of the chain needs the whole output of the one
// before, so this version runs each block as three implicit-GEMM launches
// on PyTorch's stream (3 n launches a chain: 66 a request at 600x960), and
// the map, the mid activations and a chain's weights stay in the 50 MB L2
// as far as they fit:
//   1. 1x1 down: A = x rows; the epilogue writes `a` into the interior of
//      a (B, H + 2, W + 2, M) buffer whose one-pixel halo the wrapper
//      zeroed once (the 3x3's zero padding; the TPU kernel masks its halo
//      for the same reason);
//   2. 3x3: A row p, column tap * M + ci reads the padded buffer at
//      (y + dy, x + dx): an implicit GEMM over shifted windows, K = 9 M;
//   3. 1x1 up: the epilogue adds the residual read from x and writes x in
//      place. That is safe: the GEMM reads b, never x, and each thread reads
//      the residual of exactly the elements it then writes (the TPU kernel's
//      band-local write-back, :22-25 there).
// Each GEMM is one tile of 128 pixels x 128 output channels per block of 256
// threads (8 warps, 64 x 32 each), K in steps of 32 through a 3-stage
// cp.async ring in shared memory, WMMA bf16 16x16x16 fragments (mma.sync)
// with f32 accumulators; the epilogue stages each 16x16 accumulator through
// shared memory and writes 16 bytes a thread. wgmma, TMA, warp
// specialisation and keeping `a` on-chip across the phases are later work.
//
// Accumulation: the tensor cores' own f32 accumulation does not round to
// nearest, and over K = 2304 its error reaches the bf16 roundings of `a`,
// `b` and x, each flip fanning out into the next GEMM: accumulating in the
// MMA, one block at (4, 38, 60, 1024) was bit-equal to the plain version in
// under 99 % of its outputs on an H100. So each 16-deep product goes into a
// fresh fragment (its 16 exact products summed once) and is added to the
// accumulator with round-to-nearest f32 adds, at some cost in time.
// chip_smoke.py (phase 3d) prints how often the kernel and the plain version
// each agree with an f64 reference that has the same rounding points.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBM = 128;                 // pixels per block tile
constexpr int kBN = 128;                 // output channels per block tile
constexpr int kBK = 32;                  // K per pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 256;            // 8 warps: 2 along M x 4 along N
constexpr int kWM = 64;                  // warp tile rows
constexpr int kWN = 32;                  // warp tile cols
constexpr int kALd = kBK + 8;            // A tile row stride (elements)
constexpr int kBLd = kBN + 8;            // B tile row stride (elements)
constexpr int kAStage = kBM * kALd;      // elements
constexpr int kBStage = kBK * kBLd;
constexpr int kSmemBytes = kStages * (kAStage + kBStage) * 2
                           + (kThreads / 32) * 16 * 16 * 4;

enum Phase { kDown = 0, kMid = 1, kUp = 2 };

struct Gemm {
  const bf16* a;       // kDown: x (P, C); kMid: padded a; kUp: b (P, M)
  const bf16* wt;      // (K, N) row-major
  const float* bias;   // (N)
  bf16* out;           // kDown: padded a; kMid: b; kUp: x (in place)
  int p, h, w, k, n, m;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int size = valid ? 16 : 0;              // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <int PHASE>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const Gemm g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);
  bf16* sb = sa + kStages * kAStage;
  float* sc = reinterpret_cast<float*>(sb + kStages * kBStage);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;               // 0..1
  const int wn = warp & 3;                // 0..3
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int hw = g.h * g.w;
  const int wp = g.w + 2;                 // padded row width

  // the two A chunks (16 bytes, 8 channels) and two B chunks this thread
  // copies each stage
  const bf16* arow[2];
  bool avalid[2];
  int acol[2], asmem[2];
  const bf16* brow[2];
  int bsmem[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int q = tid + t * kThreads;
    const int row = q >> 2;
    const int c8 = (q & 3) * 8;
    const int r = m0 + row;
    avalid[t] = r < g.p;
    const int rr = avalid[t] ? r : 0;
    if (PHASE == kMid) {
      const int bi = rr / hw;
      const int rem = rr - bi * hw;
      const int y = rem / g.w;
      const int xx = rem - y * g.w;
      // top-left tap of the 3x3 window in the padded buffer
      arow[t] = g.a + ((size_t)(bi * (g.h + 2) + y) * wp + xx) * g.m;
    } else {
      arow[t] = g.a + (size_t)rr * g.k;
    }
    acol[t] = c8;
    asmem[t] = row * kALd + c8;
    const int kr = q >> 4;
    const int c = (q & 15) * 8;
    brow[t] = g.wt + (size_t)kr * g.n + n0 + c;
    bsmem[t] = kr * kBLd + c;
  }

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    size_t aoff;
    if (PHASE == kMid) {
      const int tap = k0 / g.m;
      const int ci = k0 - tap * g.m;
      const int dy = tap / 3;
      const int dx = tap - dy * 3;
      aoff = (size_t)(dy * wp + dx) * g.m + ci;
    } else {
      aoff = k0;
    }
    bf16* a_dst = sa + stage * kAStage;
    bf16* b_dst = sb + stage * kBStage;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      cp_async16(a_dst + asmem[t], arow[t] + aoff + acol[t], avalid[t]);
      cp_async16(b_dst + bsmem[t], brow[t] + (size_t)k0 * g.n, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = g.k / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();               // stage kt landed; stage kt-1 is free
    const int nk = kt + kStages - 1;
    if (nk < ktiles) load_stage(nk % kStages, nk);
    cp_async_commit();

    const bf16* tile_a = sa + (kt % kStages) * kAStage;
    const bf16* tile_b = sb + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i],
                               tile_a + (wm * kWM + i * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], tile_b + kk * kBLd + wn * kWN + j * 16,
                               kBLd);
      // each 16-deep product into a fresh fragment, added in IEEE f32
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> part;
          wmma::fill_fragment(part, 0.0f);
          wmma::mma_sync(part, fa[i], fb[j], part);
#pragma unroll
          for (int t = 0; t < part.num_elements; ++t)
            acc[i][j].x[t] += part.x[t];
        }
    }
  }
  cp_async_wait<0>();

  // epilogue: each 16x16 accumulator through this warp's 1 KB of shared
  // memory; lane -> row lane / 2, 8 consecutive channels
  float* st = sc + warp * 256;
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = m0 + wm * kWM + i * 16 + er;
      const int n = n0 + wn * kWN + j * 16 + ec;
      if (r < g.p) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = st[er * 16 + ec + e] + g.bias[n + e];
        bf16* dst;
        if (PHASE == kDown) {
          const int bi = r / hw;
          const int rem = r - bi * hw;
          const int y = rem / g.w;
          const int xx = rem - y * g.w;
          dst = g.out + ((size_t)(bi * (g.h + 2) + y + 1) * wp + xx + 1) * g.m
                + n;
        } else {
          dst = g.out + (size_t)r * g.n + n;
        }
        alignas(16) bf16 o[8];
        if (PHASE == kUp) {
          alignas(16) bf16 res[8];
          *reinterpret_cast<uint4*>(res) =
              *reinterpret_cast<const uint4*>(dst);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = __float2bfloat16_rn(
                fmaxf(__bfloat162float(res[e]) + v[e], 0.0f));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = __float2bfloat16_rn(fmaxf(v[e], 0.0f));
        }
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
      }
      __syncwarp();
    }
  }
}

template <int PHASE>
cudaError_t launch(const Gemm& g, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<PHASE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(g.n / kBN, (g.p + kBM - 1) / kBM);
  gemm_kernel<PHASE><<<grid, kThreads, kSmemBytes, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

// Runs n blocks over x in place: 3 launches a block on `stream`, nothing
// synchronised. apad is (B, H + 2, W + 2, M) bf16 with a zero halo (the
// interior is overwritten), bmid (B * H * W, M) bf16 scratch. Returns the
// first launch error (cudaSuccess = 0).
extern "C" int i2vsgg_bottleneck_chain_forward(
    void* x, const void* w1, const void* b1, const void* w3, const void* b3,
    const void* w2, const void* b2, void* apad, void* bmid, int batch, int h,
    int w, int c, int m, int n_blocks, void* stream) {
  if (c % kBN || m % kBN || batch < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* xp = static_cast<bf16*>(x);
  bf16* ap = static_cast<bf16*>(apad);
  bf16* bp = static_cast<bf16*>(bmid);
  const int p = batch * h * w;
  for (int i = 0; i < n_blocks; ++i) {
    const bf16* w1i = static_cast<const bf16*>(w1) + (size_t)i * c * m;
    const bf16* w3i = static_cast<const bf16*>(w3) + (size_t)i * 9 * m * m;
    const bf16* w2i = static_cast<const bf16*>(w2) + (size_t)i * m * c;
    const float* b1i = static_cast<const float*>(b1) + (size_t)i * m;
    const float* b3i = static_cast<const float*>(b3) + (size_t)i * m;
    const float* b2i = static_cast<const float*>(b2) + (size_t)i * c;
    cudaError_t err;
    err = launch<kDown>(Gemm{xp, w1i, b1i, ap, p, h, w, c, m, m}, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch<kMid>(Gemm{ap, w3i, b3i, bp, p, h, w, 9 * m, m, m}, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch<kUp>(Gemm{bp, w2i, b2i, xp, p, h, w, m, c, m}, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
