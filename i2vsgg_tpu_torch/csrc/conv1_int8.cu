// ResNet conv1 (7x7, stride 2, pad 3) + FrozenBN affine + ReLU as an int8
// implicit GEMM on the tensor cores, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   i2vsgg_tpu/ops/pallas/conv1_int8_kernel.py (B6:
//   conv1_bn_relu_int8_pallas / _kernel).
//
// Contract (the plain PyTorch version in i2vsgg_tpu_torch/ops/conv1_int8.py;
// the wrapper computes w_q, s, b, shift and pad once for both):
//   input   NHWC mean-subtracted images (B, H, W, 3) f32, quantized on load:
//           q = clamp(rint(x + shift[c]), -128, 127) (x + shift rounded to
//           f32 first; rint is half to even, as torch.round and jnp.round),
//           with the halo (pad 3 on every side) filled with pad[c] =
//           round(mean_c) - 128. For integer pixels q = raw - 128 exactly.
//   weights w_q (64, 160) int8, per output channel, K = (dr * 7 + dc) * 3 + c
//           for K < 147 and zeros after.
//   math    y = sum_K w_q * q in int32 (exact, so in any order), then
//           out = max(y * s + b, 0) in f32 without FMA contraction
//           (__fmul_rn, then __fadd_rn, as the plain version's two torch ops
//           round), rounded to bf16 and written NHWC (B, Ho, Wo, 64),
//           Ho = (H - 1) / 2 + 1.
//   So the kernel is bit-equal to its plain version.
//
// What bounds it on an H100 (4 frames of 600x960): bytes. It must read
// 27.6 MB of f32 images and write 73.7 MB of bf16 output (30.3 us at
// 3.35 TB/s), against 2 * 4 * 300 * 480 * 64 * 147 = 10.8 G int8 ops
// (5.5 us at 1979 TOP/s; 16.5 G at the K = 224 the layout below runs).
//
// Design: an implicit GEMM with no im2col pass. M = output pixels, N = 64,
// K = dr * 32 + dc * 4 + ch (dr 0..6, dc 0..7, ch 0..3): seven k-steps of
// mma.sync.m16n8k32.s8, one per kernel row; the dc = 7 and ch = 3 slots
// carry zero weights. Persistent blocks (as many as fit an SM, one wave)
// walk tiles of kTileR x kTileC output pixels. For each tile a block copies
// the f32 rows of its (2 kTileR + 5) x (2 kTileC + 6) input window with
// 16-byte cp.async (one warp a row) while the tile before computes, then
// quantizes them into a window of one 32-bit word (q0, q1, q2, 0) per input
// pixel. The A register of output pixel x at k-step dr is then the single
// aligned word window[2 y + dr][2 x + t] (and 2 x + 4 + t), so a fragment
// is four shared loads; the words that the eight pixels of a row group read
// span 18 consecutive words, distinct banks. Each block copies the (64, 160)
// weights once and re-lays them into (64, 7 x 32) rows padded to 240 bytes,
// read with ldmatrix.x4 without bank conflicts. An m16 tile is 16
// consecutive pixels of one output row, so its output is 2 KB of contiguous
// bytes: the warp writes its bf16 fragments into shared memory with stmatrix
// and stores them as full 128-byte lines, 16 bytes a thread. Partial tiles
// at Ho and Wo are masked at the store; their window reads the pad.
//
// What bounds it now is less DRAM than the SM's shared-memory pipe: per m16
// tile the B fragments (28 ldmatrix.x4), the A words, the scale and bias and
// the staged output all pass through it. A warp therefore takes two m16
// tiles a pass, so that each B fragment serves both (the accumulators of a
// third would not fit the 128 registers that two blocks an SM leave). The
// epilogue runs without conversions: the accumulators start at the bits of
// 1.5 * 2^23 (float(y) is then one exact subtraction) and cvt.rn.relu packs
// the ReLU and the bf16 rounding into one instruction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileR = 16;                      // output rows a tile
constexpr int kTileC = 32;                      // output columns a tile
constexpr int kMTiles = kTileR * kTileC / 16;   // m16 tiles, along x
constexpr int kPass = 2;                        // m16 tiles a warp at once
static_assert(kTileC % 16 == 0 && kMTiles % (kWarps * kPass) == 0 &&
                  kWarps % (kTileC / 16) == 0,
              "the m16 tiles");
constexpr int kCout = 64;
constexpr int kKIn = 160;                       // the wrapper's K
constexpr int kKSteps = 7;                      // one k32 step a kernel row
constexpr int kWRow = kKSteps * 32 + 16;        // weight row stride, bytes
constexpr int kWinRows = 2 * kTileR + 5;        // input rows a tile reads
constexpr int kWinCols = 2 * kTileC + 6;        // input columns (dc 0..7)
constexpr int kWinLd = kWinCols + 2;            // window row stride, words
// 16-byte chunks of one raw window row: its floats and up to 3 more at
// each end to reach 16-byte boundaries
constexpr int kRawChunks = (kWinCols * 3 + 6 + 3) / 4;
constexpr int kRawLd = kRawChunks * 4;          // raw row stride, floats
constexpr int kOutLd = 144;                     // staged pixel stride, bytes
// The accumulators start at the bits of the float 1.5 * 2^23. An exact int32
// sum y, |y| <= 147 * 128 * 128 < 2^22, then leaves the bits of the float
// 1.5 * 2^23 + y, so float(y) is one exact f32 subtraction, not a conversion.
constexpr int kBiasBits = 0x4B400000;
constexpr float kBiasF = 12582912.0f;

constexpr int kWBytes = kCout * kWRow;
constexpr int kAffBytes = 2 * kCout * 4;
constexpr int kWinBytes = kWinRows * kWinLd * 4;
constexpr int kRawBytes = kWinRows * kRawLd * 4;
constexpr int kStageBytes = kWarps * 16 * kOutLd;
constexpr int kSmemBytes =
    kWBytes + kAffBytes + kWinBytes + kRawBytes + kStageBytes;
static_assert(kCout * kKIn <= kStageBytes, "the weights' copy");
static_assert(kWBytes % 16 == 0 && kWinBytes % 16 == 0 &&
                  kRawBytes % 16 == 0,
              "16-byte aligned regions");

struct Args {
  const float* img;
  const int8_t* w;
  const float* scale;
  const float* bias;
  __nv_bfloat16* out;
  int B, H, W, Ho, Wo, tiles_y, tiles_x;
  float sh0, sh1, sh2;
  uint32_t pad_word;            // the halo's (pad0, pad1, pad2, 0) bytes
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(smem)), "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(row)));
}

__device__ __forceinline__ void stmatrix_x4(void* row, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      :: "r"(smem_addr(row)), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// D += A B, m16n8k32, s8 x s8 -> s32 (exact)
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// max(lo, 0) and max(hi, 0) rounded to bf16 (nearest even), packed: one
// instruction (an exact -0.0 would stay -0.0; the epilogue's sums are never
// one, unless a bias is -0.0)
__device__ __forceinline__ uint32_t pack_bf16_relu(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ uint32_t quant(float x, float sh) {
  const int q = min(max(__float2int_rn(__fadd_rn(x, sh)), -128), 127);
  return static_cast<uint32_t>(q) & 0xffu;
}

// The row (b, Y) of the images from input column xs on, and the floats
// before it up to a 16-byte boundary (0..3): a raw window row starts there.
__device__ __forceinline__ const float* row_at(const Args& a, int b, int Y,
                                               int xs, int& lead) {
  const float* p = a.img + (static_cast<size_t>(b * a.H + Y) * a.W + xs) * 3;
  lead = static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
  return p;
}

// Issue the copies of a tile's raw window rows (f32, as in the image), one
// warp a row, a lane a 16-byte chunk. A row whose chunks reach past either
// end of the images (the first and the last row, at most) is copied float
// by float, so nothing outside the tensor is read.
__device__ __forceinline__ void stage_raw(const Args& a, float* raw, int b,
                                          int y0, int x0, int warp,
                                          int lane) {
  const int xs = max(2 * x0 - 3, 0);
  const int xe = min(2 * x0 - 3 + kWinCols, a.W);
  const float* hi = a.img + static_cast<size_t>(a.B) * a.H * a.W * 3;
  for (int r = warp; r < kWinRows; r += kWarps) {
    const int Y = 2 * y0 - 3 + r;
    if (Y < 0 || Y >= a.H) continue;
    int lead;
    const float* src = row_at(a, b, Y, xs, lead) - lead;
    const int chunks = (lead + (xe - xs) * 3 + 3) / 4;
    float* dst = raw + r * kRawLd;
    if (src >= a.img && src + 4 * chunks <= hi) {
      for (int k = lane; k < chunks; k += 32)
        cp_async16(dst + 4 * k, src + 4 * k);
    } else {
      for (int k = lane; k < 4 * chunks; k += 32) {
        const bool in = src + k >= a.img && src + k < hi;
        cp_async4(dst + k, in ? src + k : a.img, in);
      }
    }
  }
}

// Quantize the copied rows into the window, one word (q0, q1, q2, 0) an
// input pixel, one warp a row; the halo gets the pad word.
__device__ __forceinline__ void quantize(const Args& a, const float* raw,
                                         uint32_t* win, int b, int y0,
                                         int x0, int warp, int lane) {
  const int xs = max(2 * x0 - 3, 0);
  for (int r = warp; r < kWinRows; r += kWarps) {
    const int Y = 2 * y0 - 3 + r;
    uint32_t* row = win + r * kWinLd;
    if (Y < 0 || Y >= a.H) {
      for (int c = lane; c < kWinCols; c += 32) row[c] = a.pad_word;
      continue;
    }
    int lead;
    row_at(a, b, Y, xs, lead);
    const float* px = raw + r * kRawLd + lead - 3 * xs;   // + 3 X
    for (int c = lane; c < kWinCols; c += 32) {
      const int X = 2 * x0 - 3 + c;
      uint32_t word = a.pad_word;
      if (X >= 0 && X < a.W) {
        const float* p = px + 3 * X;
        word = quant(p[0], a.sh0) | (quant(p[1], a.sh1) << 8) |
               (quant(p[2], a.sh2) << 16);
      }
      row[c] = word;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
conv1_int8_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* w_s = smem;
  float* s_s = reinterpret_cast<float*>(smem + kWBytes);
  float* b_s = s_s + kCout;
  uint32_t* win = reinterpret_cast<uint32_t*>(smem + kWBytes + kAffBytes);
  float* raw =
      reinterpret_cast<float*>(smem + kWBytes + kAffBytes + kWinBytes);
  unsigned char* stage =
      smem + kWBytes + kAffBytes + kWinBytes + kRawBytes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int per_image = a.tiles_y * a.tiles_x;
  const int n_tiles = a.B * per_image;
  int tile = blockIdx.x;
  if (tile >= n_tiles) return;

  auto origin = [&](int tl, int& b, int& y0, int& x0) {
    b = tl / per_image;
    const int rem = tl - b * per_image;
    const int ty = rem / a.tiles_x;
    y0 = ty * kTileR;
    x0 = (rem - ty * a.tiles_x) * kTileC;
  };

  int b, y0, x0;
  origin(tile, b, y0, x0);
  stage_raw(a, raw, b, y0, x0, warp, lane);

  // the weights, once: 16-byte copies of the (64, 160) tensor into the
  // output staging area (free until the first epilogue), then re-laid so
  // that row n, k-step dr holds the words (w[n][dr][dc][0..2], 0) for dc
  // 0..6 and a zero word for dc 7
  for (int i = tid; i < kCout * kKIn / 16; i += kThreads)
    cp_async16(stage + 16 * i, a.w + 16 * i);
  if (tid < kCout) {
    s_s[tid] = a.scale[tid];
    b_s[tid] = a.bias[tid];
  }
  cp_async_wait_all();
  __syncthreads();
  for (int i = tid; i < kCout * kKSteps * 8; i += kThreads) {
    const int n = i / (kKSteps * 8), rem = i - n * (kKSteps * 8);
    const int dr = rem >> 3, dc = rem & 7;
    uint32_t word = 0;
    if (dc < 7) {
      const unsigned char* src = stage + n * kKIn + (dr * 7 + dc) * 3;
      word = src[0] | (src[1] << 8) | (src[2] << 16);
    }
    *reinterpret_cast<uint32_t*>(w_s + n * kWRow + dr * 32 + dc * 4) = word;
  }
  quantize(a, raw, win, b, y0, x0, warp, lane);
  __syncthreads();

  // ldmatrix.x4 rows of the B fragments: lane l addresses weight row
  // (l / 16) * 8 + l % 8 of an n16 pair, k half (l / 8) % 2
  const unsigned char* w_lane =
      w_s + ((lane >> 4) * 8 + (lane & 7)) * kWRow + ((lane >> 3) & 1) * 16;
  // stmatrix.x4 rows: lane l addresses pixel (l % 8) + 8 ((l / 8) % 2) of
  // the m16 tile, channel block of 8 (l / 16) of an n16 pair
  unsigned char* st_warp = stage + warp * 16 * kOutLd;
  unsigned char* st_lane =
      st_warp + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kOutLd +
      (lane >> 4) * 16;

  for (; tile < n_tiles; tile += gridDim.x) {
    origin(tile, b, y0, x0);
    const int next = tile + gridDim.x;
    int nb = 0, ny0 = 0, nx0 = 0;
    if (next < n_tiles) {          // lands while this tile computes
      origin(next, nb, ny0, nx0);
      stage_raw(a, raw, nb, ny0, nx0, warp, lane);
    }

    // kPass m16 tiles a pass share each B fragment: m = warp + (j kPass +
    // i) kWarps. They share their column (kWarps is a multiple of the
    // m16 tiles a row), so when the first lies past Ho or Wo, so does the
    // rest.
#pragma unroll 1
    for (int j = 0; j < kMTiles / (kWarps * kPass); ++j) {
      int ry[kPass], mx[kPass];
#pragma unroll
      for (int i = 0; i < kPass; ++i) {
        const int m = warp + (j * kPass + i) * kWarps;
        ry[i] = m / (kTileC / 16);
        mx[i] = (m % (kTileC / 16)) * 16;
      }
      if (y0 + ry[0] >= a.Ho || x0 + mx[0] >= a.Wo) continue;  // warp-uniform

      int acc[kPass][8][4];
#pragma unroll
      for (int i = 0; i < kPass; ++i)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nt][e] = kBiasBits;

#pragma unroll
      for (int dr = 0; dr < kKSteps; ++dr) {
        uint32_t bw[8][2];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          ldmatrix_x4(bw[2 * p][0], bw[2 * p][1], bw[2 * p + 1][0],
                      bw[2 * p + 1][1], w_lane + p * 16 * kWRow + dr * 32);
#pragma unroll
        for (int i = 0; i < kPass; ++i) {
          const uint32_t* ar =
              win + (2 * ry[i] + dr) * kWinLd + 2 * (mx[i] + g) + t;
          const uint32_t a0 = ar[0], a1 = ar[16], a2 = ar[4], a3 = ar[20];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            mma_s8(acc[i][nt], a0, a1, a2, a3, bw[nt][0], bw[nt][1]);
        }
      }

#pragma unroll
      for (int i = 0; i < kPass; ++i) {
        const int y = y0 + ry[i], xb = x0 + mx[i];
        // epilogue: acc[i][nt][2h + e] is pixel g + 8h, channel nt * 8 +
        // 2t + e, and float(y) the exact subtraction of 1.5 * 2^23 from its
        // bits; no FMA contraction: the plain version multiplies, then adds
        uint32_t pk[8][2];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 sv =
              *reinterpret_cast<const float2*>(s_s + nt * 8 + 2 * t);
          const float2 bv =
              *reinterpret_cast<const float2*>(b_s + nt * 8 + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float y0f =
                __fsub_rn(__int_as_float(acc[i][nt][2 * h]), kBiasF);
            const float y1f =
                __fsub_rn(__int_as_float(acc[i][nt][2 * h + 1]), kBiasF);
            pk[nt][h] =
                pack_bf16_relu(__fadd_rn(__fmul_rn(y0f, sv.x), bv.x),
                               __fadd_rn(__fmul_rn(y1f, sv.y), bv.y));
          }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
          stmatrix_x4(st_lane + p * 32, pk[2 * p][0], pk[2 * p][1],
                      pk[2 * p + 1][0], pk[2 * p + 1][1]);
        __syncwarp();
        // 16 pixels x 128 bytes, contiguous in the output: full lines
        uint4* dst = reinterpret_cast<uint4*>(
            a.out + ((static_cast<size_t>(b) * a.Ho + y) * a.Wo + xb) * kCout);
        const int valid = y < a.Ho ? min(16, a.Wo - xb) * 8 : 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int q = lane + 32 * k;
          if (q < valid)
            dst[q] = *reinterpret_cast<const uint4*>(
                st_warp + (q >> 3) * kOutLd + (q & 7) * 16);
        }
        __syncwarp();
      }
    }

    cp_async_wait_all();
    __syncthreads();               // the window is free, the raw rows landed
    if (next < n_tiles) quantize(a, raw, win, nb, ny0, nx0, warp, lane);
    __syncthreads();
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// img (B, H, W, 3) f32, w (64, 160) int8, scale/bias (64,) f32 ->
// out (B, (H - 1) / 2 + 1, (W - 1) / 2 + 1, 64) bf16. shift = mean - 128 and
// pad = round(mean) - 128, per channel (pad holds integers). One launch.
// Returns the cudaError_t of the launch (0 = cudaSuccess); the caller raises
// on anything else.
extern "C" int i2vsgg_conv1_int8_forward(const void* img, const void* w,
                                         const void* scale, const void* bias,
                                         int B, int H, int W, float sh0,
                                         float sh1, float sh2, float pd0,
                                         float pd1, float pd2, void* out,
                                         void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (!aligned16(w) || !aligned16(out) ||
      reinterpret_cast<uintptr_t>(img) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(img), static_cast<const int8_t*>(w),
         static_cast<const float*>(scale), static_cast<const float*>(bias),
         static_cast<__nv_bfloat16*>(out), B, H, W, 0, 0, 0, 0, sh0, sh1,
         sh2, 0};
  a.Ho = (H - 1) / 2 + 1;
  a.Wo = (W - 1) / 2 + 1;
  a.tiles_y = (a.Ho + kTileR - 1) / kTileR;
  a.tiles_x = (a.Wo + kTileC - 1) / kTileC;
  a.pad_word = (static_cast<uint32_t>(static_cast<int>(pd0)) & 0xffu) |
               ((static_cast<uint32_t>(static_cast<int>(pd1)) & 0xffu) << 8) |
               ((static_cast<uint32_t>(static_cast<int>(pd2)) & 0xffu) << 16);
  cudaError_t err = cudaFuncSetAttribute(
      conv1_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv1_int8_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = B * a.tiles_y * a.tiles_x;
  const int blocks = per_sm > 0 ? per_sm * sms : sms;
  conv1_int8_kernel<<<tiles < blocks ? tiles : blocks, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block of the kernel takes (bytes).
extern "C" int i2vsgg_conv1_int8_smem_bytes() { return kSmemBytes; }
