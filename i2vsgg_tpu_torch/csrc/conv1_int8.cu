// ResNet conv1 (7x7, stride 2, pad 3) + FrozenBN affine + ReLU as an int8
// im2col GEMM on the tensor cores, hand-written for Hopper (sm_90a).
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
//   math    y = sum_K w_q * q in int32 (exact), then out = max(y * s + b, 0)
//           in f32 without FMA contraction (__fmul_rn, then __fadd_rn, as
//           the plain version's two torch ops round), rounded to bf16 and
//           written NHWC (B, Ho, Wo, 64), Ho = (H - 1) / 2 + 1.
//   So the kernel is bit-equal to its plain version.
//
// What bounds it on an H100 (4 frames of 600x960): bytes. It must read
// 27.6 MB of f32 images and write 73.7 MB of bf16 output (30.3 us at
// 3.35 TB/s), against 2 * 4 * 300 * 480 * 64 * 147 = 10.8 G int8 ops
// (5.5 us at 1979 TOP/s).
//
// Design (right and simple first; wgmma and TMA are later work): one block
// of 256 threads per 128 consecutive output pixels of one output row. The
// block quantizes the 7 x 261 x 3 input patch its row reads into shared
// memory (coalesced f32 reads, no separate int8-plane pass), builds the
// int8 im2col tile A (128 x 160, rows padded to 176 bytes so that the
// fragment loads hit 32 distinct banks) and the weights W (64 x 160, the
// same padding), and each warp takes 16 pixels x 64 channels with
// mma.sync.m16n8k32.s8.s8.s32 (5 k-steps x 8 n-tiles). The epilogue stages
// the bf16 tile in shared memory (rows of 144 bytes) and the block writes
// its 128 x 128 contiguous output bytes with 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;                // output pixels per block
constexpr int kThreads = 256;             // 8 warps x 16 pixels
constexpr int kCout = 64;
constexpr int kTaps = 147;
constexpr int kK = 160;                   // K padded to five k32 steps
constexpr int kRowA = 176;                // bytes per A / W row in smem
constexpr int kWordsA = kRowA / 4;        // 44
constexpr int kPatchW = 2 * kTile + 5;    // input columns a tile reads
constexpr int kPatchRow = 784;            // >= kPatchW * 3, bytes
constexpr int kRowO = 144;                // bytes per staged output row

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
conv1_int8_kernel(const float* __restrict__ img,
                  const int8_t* __restrict__ wq,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int H, int W, int Ho,
                  int Wo, float sh0, float sh1, float sh2, int pd0, int pd1,
                  int pd2) {
  __shared__ __align__(16) int8_t a_s[kTile * kRowA];   // im2col, then out
  __shared__ __align__(16) int8_t w_s[kCout * kRowA];
  __shared__ __align__(16) int8_t patch[7 * kPatchRow];
  __shared__ float s_s[kCout], b_s[kCout];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTile;
  const int y = blockIdx.y;
  const int b = blockIdx.z;

  // weights: 64 rows of 10 x 16 bytes
  for (int i = tid; i < kCout * (kK / 16); i += kThreads) {
    const int n = i / (kK / 16), part = i - n * (kK / 16);
    *reinterpret_cast<uint4*>(w_s + n * kRowA + part * 16) =
        reinterpret_cast<const uint4*>(wq)[i];
  }
  if (tid < kCout) {
    s_s[tid] = scale[tid];
    b_s[tid] = bias[tid];
  }
  // the input patch, quantized on load: rows 2y - 3 .. 2y + 3, columns
  // 2 x0 - 3 .. 2 x0 + 257, three channels
  for (int i = tid; i < 7 * kPatchW * 3; i += kThreads) {
    const int r = i / (kPatchW * 3);
    const int rem = i - r * (kPatchW * 3);
    const int c = rem / 3, ch = rem - 3 * (rem / 3);
    const int Y = 2 * y - 3 + r;
    const int X = 2 * x0 - 3 + c;
    int q = ch == 0 ? pd0 : (ch == 1 ? pd1 : pd2);
    if (Y >= 0 && Y < H && X >= 0 && X < W) {
      const float v =
          img[((static_cast<size_t>(b) * H + Y) * W + X) * 3 + ch];
      const float sh = ch == 0 ? sh0 : (ch == 1 ? sh1 : sh2);
      q = min(max(__float2int_rn(__fadd_rn(v, sh)), -128), 127);
    }
    patch[r * kPatchRow + rem] = static_cast<int8_t>(q);
  }
  __syncthreads();

  // im2col: A[m][k] = patch[dr][2 m + dc][ch], k = (dr * 7 + dc) * 3 + ch,
  // built four k at a time into one 32-bit word
  for (int i = tid; i < kTile * (kK / 4); i += kThreads) {
    const int m = i / (kK / 4), kw = i - m * (kK / 4);
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = kw * 4 + e;
      if (k < kTaps) {
        const int tap = k / 3, ch = k - 3 * (k / 3);
        const int dr = tap / 7, dc = tap - 7 * (tap / 7);
        const uint32_t v = static_cast<uint8_t>(
            patch[dr * kPatchRow + (2 * m + dc) * 3 + ch]);
        word |= v << (8 * e);
      }
    }
    reinterpret_cast<uint32_t*>(a_s)[m * kWordsA + kw] = word;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a_s);
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(w_s);
  int acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0;

#pragma unroll
  for (int ks = 0; ks < kK / 32; ++ks) {
    const int kb = ks * 8;                  // in 32-bit words
    const uint32_t a0 = a32[(m0 + g) * kWordsA + kb + t];
    const uint32_t a1 = a32[(m0 + g + 8) * kWordsA + kb + t];
    const uint32_t a2 = a32[(m0 + g) * kWordsA + kb + 4 + t];
    const uint32_t a3 = a32[(m0 + g + 8) * kWordsA + kb + 4 + t];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = nt * 8 + g;
      mma_s8(acc[nt], a0, a1, a2, a3, w32[n * kWordsA + kb + t],
             w32[n * kWordsA + kb + 4 + t]);
    }
  }
  __syncthreads();                          // a_s is reused for the output

  // epilogue: c0, c1 at (row g, cols 2t, 2t + 1), c2, c3 at row g + 8
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float r[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + 2 * t + e;
        const float v = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[nt][2 * half + e]), s_s[n]), b_s[n]);
        r[e] = v > 0.0f ? v : 0.0f;
      }
      const __nv_bfloat162 pr = __floats2bfloat162_rn(r[0], r[1]);
      const int m = m0 + g + 8 * half;
      *reinterpret_cast<__nv_bfloat162*>(a_s + m * kRowO +
                                         (nt * 8 + 2 * t) * 2) = pr;
    }
  }
  __syncthreads();

  const int valid = min(kTile, Wo - x0);
  uint4* dst = reinterpret_cast<uint4*>(
      out + ((static_cast<size_t>(b) * Ho + y) * Wo + x0) * kCout);
  for (int i = tid; i < valid * 8; i += kThreads) {
    const int m = i / 8, part = i - 8 * (i / 8);
    dst[i] = *reinterpret_cast<const uint4*>(a_s + m * kRowO + part * 16);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// img (B, H, W, 3) f32, w (64, 160) int8, scale/bias (64,) f32 ->
// out (B, (H - 1) / 2 + 1, (W - 1) / 2 + 1, 64) bf16. shift = mean - 128 and
// pad = round(mean) - 128, per channel (pad holds integers). Returns the
// cudaError_t of the launch (0 = cudaSuccess); the caller raises on
// anything else.
extern "C" int i2vsgg_conv1_int8_forward(const void* img, const void* w,
                                         const void* scale, const void* bias,
                                         int B, int H, int W, float sh0,
                                         float sh1, float sh2, float pd0,
                                         float pd1, float pd2, void* out,
                                         void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (!aligned16(w) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / 2 + 1;
  const int Wo = (W - 1) / 2 + 1;
  const dim3 grid((Wo + kTile - 1) / kTile, Ho, B);
  conv1_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, W, Ho, Wo, sh0, sh1, sh2,
      static_cast<int>(pd0), static_cast<int>(pd1), static_cast<int>(pd2));
  return static_cast<int>(cudaGetLastError());
}
