// ResNet conv1 (7x7, stride 2, pad 3) + FrozenBN affine + ReLU, and the
// caffe ceil-mode 3x3/2 stem maxpool, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   i2vsgg_tpu/ops/pallas/conv1_kernel.py (B3: conv1_bn_relu_pallas,
//     conv1_bn_relu_pallas_planes, conv1_stem_pallas_planes,
//     conv1_stem_pallas; core _conv1_cm / _kernel) and
//   i2vsgg_tpu/ops/pallas/conv1_v2_kernel.py (B5: conv1_bn_relu_pallas_v2,
//     the BN scale folded into the bf16 weights) as a mode of the same
//     kernel.
//
// Contract (the plain PyTorch versions in i2vsgg_tpu_torch/ops/conv1.py):
//   input   either the parity planes (B, 2, 2, 3, Hq, Wq) bf16 of the host
//           contract (the pad-3 halo baked in), or NHWC images (B, H, W, 3)
//           f32, rounded here to bf16 (nearest even) and read with the
//           pad-3 halo. The tap (dr, dc) of output (y, x), channel c, is
//           plane[dr % 2][dc % 2][c][y + dr / 2][x + dc / 2], and
//           plane[py][px][c][yq][xq] = image[2 yq + py - 3][2 xq + px - 3][c]
//           (zero outside the image), so both forms stage the same bf16
//           values and give bit-identical outputs.
//   weights (7, 7, 3, 64) bf16 (K = (dr * 7 + dc) * 3 + c, 64 outputs minor).
//   math    bf16 x bf16 products (exact in f32) summed in f32; epilogue in
//           f32 without FMA contraction, as the plain version computes it:
//             mode 0 (B3): max(y * mul + add, 0)
//             mode 1 (B5): max(y + add, 0)       (weights = bf16(w * mul))
//           then rounded to bf16 and written NHWC (B, Ho, Wo, 64).
//   stem    a second pass takes the caffe ceil-mode 3x3/2 maxpool
//           (Hp = (Ho - 2) / 2 + 1). Post-ReLU values are >= 0, so a window
//           clipped at (Ho, Wo) equals the reference's -inf ceil padding and
//           the TPU kernel's zero padding: the pass is exact.
//
// What bounds it on an H100 (4 frames, 600x960, planes in, stem out):
// 2 * 4 * 300 * 480 * 64 * 147 = 10.84 GFLOP (11.0 us at 989 TFLOP/s bf16)
// against 34.2 MB of planes in and pooled output (10.2 us at 3.35 TB/s), so
// the tensor-core rate. This first version runs on the f32 FMA pipes (67
// TFLOP/s: ~160 us of pure FMA at full rate) and writes the unpooled map
// (73.7 MB) between its two passes; wgmma on im2col tiles staged by TMA,
// with the pool fused, is the later PR's work.
//
// Design: one block of 256 threads per 8 x 32 tile of output pixels of one
// image; each thread owns one output pixel and all 64 channels (64 f32
// accumulators). The block stages the 12 plane windows its tile reads
// (11 x 35 values each, converted to f32) and the 18.8 KB of bf16 weights
// in shared memory; the weight reads are warp-wide broadcasts and the
// plane reads are consecutive across the warp. The output row of one
// thread is 128 contiguous bytes, stored as eight 16-byte writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTY = 8;            // output rows per block
constexpr int kTX = 32;           // output cols per block (one warp)
constexpr int kThreads = kTY * kTX;
constexpr int kSY = kTY + 3;      // plane rows a tile reads (dr / 2 <= 3)
constexpr int kSX = kTX + 3;      // plane cols a tile reads
constexpr int kSXP = kSX + 1;
constexpr int kTaps = 147;        // 7 * 7 * 3
constexpr int kCout = 64;

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

template <int kSrc>  // 0 = parity planes (bf16), 1 = NHWC images (f32)
__global__ void __launch_bounds__(kThreads)
conv1_kernel(const void* __restrict__ src, const __nv_bfloat16* __restrict__ w,
             const float* __restrict__ mul, const float* __restrict__ add,
             __nv_bfloat16* __restrict__ out, int mode, int H, int W, int Hq,
             int Wq, int Ho, int Wo) {
  __shared__ float in_s[12][kSY][kSXP];
  __shared__ __align__(16) __nv_bfloat16 w_s[kTaps * kCout];
  __shared__ float mul_s[kCout], add_s[kCout];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTY;
  const int x0 = blockIdx.x * kTX;

  {
    const uint4* wg = reinterpret_cast<const uint4*>(w);
    uint4* ws = reinterpret_cast<uint4*>(w_s);
    for (int i = tid; i < kTaps * kCout / 8; i += kThreads) ws[i] = wg[i];
  }
  if (tid < kCout) {
    mul_s[tid] = mul[tid];
    add_s[tid] = add[tid];
  }
  for (int i = tid; i < 12 * kSY * kSX; i += kThreads) {
    const int pc = i / (kSY * kSX);          // (py * 2 + px) * 3 + c
    const int rem = i - pc * (kSY * kSX);
    const int yy = rem / kSX;
    const int xx = rem - yy * kSX;
    const int yq = y0 + yy;
    const int xq = x0 + xx;
    float v = 0.0f;
    if (kSrc == 0) {
      if (yq < Hq && xq < Wq) {
        const __nv_bfloat16* planes = static_cast<const __nv_bfloat16*>(src);
        v = __bfloat162float(
            planes[((static_cast<size_t>(b) * 12 + pc) * Hq + yq) * Wq + xq]);
      }
    } else {
      const int py = pc / 6, px = (pc / 3) & 1, c = pc % 3;
      const int Y = 2 * yq + py - 3;
      const int X = 2 * xq + px - 3;
      if (Y >= 0 && Y < H && X >= 0 && X < W) {
        const float* img = static_cast<const float*>(src);
        const float f = img[((static_cast<size_t>(b) * H + Y) * W + X) * 3 + c];
        v = __bfloat162float(__float2bfloat16_rn(f));
      }
    }
    in_s[pc][yy][xx] = v;
  }
  __syncthreads();

  const int ty = tid / kTX;
  const int tx = tid % kTX;
  float acc[kCout];
#pragma unroll
  for (int k = 0; k < kCout; ++k) acc[k] = 0.0f;

#pragma unroll 1
  for (int dr = 0; dr < 7; ++dr) {
#pragma unroll
    for (int dc = 0; dc < 7; ++dc) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v =
            in_s[((dr & 1) * 2 + (dc & 1)) * 3 + c][ty + (dr >> 1)][tx + (dc >> 1)];
        const uint4* wrow =
            reinterpret_cast<const uint4*>(w_s + ((dr * 7 + dc) * 3 + c) * kCout);
#pragma unroll
        for (int q = 0; q < kCout / 8; ++q) {
          const uint4 u = wrow[q];
          const uint32_t p[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[q * 8 + 2 * e] =
                fmaf(v, bf16_bits_to_f32(p[e] & 0xffffu), acc[q * 8 + 2 * e]);
            acc[q * 8 + 2 * e + 1] =
                fmaf(v, bf16_bits_to_f32(p[e] >> 16), acc[q * 8 + 2 * e + 1]);
          }
        }
      }
    }
  }

  const int y = y0 + ty;
  const int x = x0 + tx;
  if (y >= Ho || x >= Wo) return;
  uint4* dst = reinterpret_cast<uint4*>(
      out + ((static_cast<size_t>(b) * Ho + y) * Wo + x) * kCout);
#pragma unroll
  for (int q = 0; q < kCout / 8; ++q) {
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float r[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = q * 8 + 2 * e + h;
        // no FMA contraction: the plain version multiplies, then adds
        float t = mode == 0 ? __fadd_rn(__fmul_rn(acc[k], mul_s[k]), add_s[k])
                            : __fadd_rn(acc[k], add_s[k]);
        r[h] = t > 0.0f ? t : 0.0f;
      }
      const __nv_bfloat162 pr = __floats2bfloat162_rn(r[0], r[1]);
      packed[e] = *reinterpret_cast<const uint32_t*>(&pr);
    }
    dst[q] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// Caffe ceil-mode 3x3/2 maxpool over post-ReLU NHWC bf16; one thread per
// pooled pixel and 8 channels (16-byte loads and store).
__global__ void stem_pool_kernel(const __nv_bfloat16* __restrict__ in,
                                 __nv_bfloat16* __restrict__ out, int B,
                                 int Ho, int Wo, int C, int Hp, int Wp) {
  const int groups = C / 8;
  const long long total = static_cast<long long>(B) * Hp * Wp * groups;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int g = static_cast<int>(i % groups);
  long long t = i / groups;
  const int px = static_cast<int>(t % Wp);
  t /= Wp;
  const int py = static_cast<int>(t % Hp);
  const int b = static_cast<int>(t / Hp);
  const int r0 = 2 * py, r1 = min(2 * py + 3, Ho);
  const int c0 = 2 * px, c1 = min(2 * px + 3, Wo);
  float m[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) m[e] = -INFINITY;
  for (int r = r0; r < r1; ++r) {
    for (int c = c0; c < c1; ++c) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          in + ((static_cast<size_t>(b) * Ho + r) * Wo + c) * C + g * 8);
      const uint32_t p[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m[2 * e] = fmaxf(m[2 * e], bf16_bits_to_f32(p[e] & 0xffffu));
        m[2 * e + 1] = fmaxf(m[2 * e + 1], bf16_bits_to_f32(p[e] >> 16));
      }
    }
  }
  uint32_t packed[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // a max of bf16 values is one of them: the conversion back is exact
    const __nv_bfloat162 pr = __floats2bfloat162_rn(m[2 * e], m[2 * e + 1]);
    packed[e] = *reinterpret_cast<const uint32_t*>(&pr);
  }
  *reinterpret_cast<uint4*>(
      out + ((static_cast<size_t>(b) * Hp + py) * Wp + px) * C + g * 8) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// src_kind: 0 = parity planes (B, 2, 2, 3, Hq, Wq) bf16, 1 = images
// (B, H, W, 3) f32. mode: 0 = y * mul + add, 1 = y + add (mul unused).
// (H, W) is the source image size in both forms. Returns the cudaError_t of
// the launch (0 = cudaSuccess); the caller raises on anything else.
extern "C" int i2vsgg_conv1_forward(const void* src, const void* w,
                                    const void* mul, const void* add,
                                    void* out, int src_kind, int mode, int B,
                                    int H, int W, int Hq, int Wq,
                                    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if ((src_kind != 0 && src_kind != 1) || (mode != 0 && mode != 1) ||
      !aligned16(w) || !aligned16(out) ||
      (src_kind == 0 && (Hq <= 0 || Wq <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / 2 + 1;
  const int Wo = (W - 1) / 2 + 1;
  const dim3 grid((Wo + kTX - 1) / kTX, (Ho + kTY - 1) / kTY, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const float* m = static_cast<const float*>(mul);
  const float* a = static_cast<const float*>(add);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (src_kind == 0) {
    conv1_kernel<0><<<grid, kThreads, 0, s>>>(src, wb, m, a, o, mode, H, W,
                                              Hq, Wq, Ho, Wo);
  } else {
    conv1_kernel<1><<<grid, kThreads, 0, s>>>(src, wb, m, a, o, mode, H, W,
                                              Hq, Wq, Ho, Wo);
  }
  return static_cast<int>(cudaGetLastError());
}

// (B, Ho, Wo, C) bf16 -> (B, (Ho - 2) / 2 + 1, (Wo - 2) / 2 + 1, C) bf16.
extern "C" int i2vsgg_stem_pool_forward(const void* in, void* out, int B,
                                        int Ho, int Wo, int C, void* stream) {
  if (B <= 0 || Ho < 2 || Wo < 2 || C <= 0) return 0;
  if (C % 8 != 0 || !aligned16(in) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Hp = (Ho - 2) / 2 + 1;
  const int Wp = (Wo - 2) / 2 + 1;
  const long long total = static_cast<long long>(B) * Hp * Wp * (C / 8);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  stem_pool_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(in), static_cast<__nv_bfloat16*>(out),
      B, Ho, Wo, C, Hp, Wp);
  return static_cast<int>(cudaGetLastError());
}
