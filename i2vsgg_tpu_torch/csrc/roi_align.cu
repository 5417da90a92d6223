// RoIAlignAvg (the reference's single-tap RoIAlign on a (P+1)^2 grid,
// 2x2 stride-1 averaged to P x P) over NHWC feature maps, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// i2vsgg_tpu/ops/pallas/roi_align_kernel.py (roi_align_avg_pallas_core,
// pick_tiles, _kernel), which applied caller-built one-hot-shaped Ry/Rx
// matrices as two MXU contractions. The contract is that of the port's
// plain version, roi_align_avg_plain in i2vsgg_tpu_torch/ops/roi_align.py:
//
//   fmap (B, H, W, C) in f32, bf16 or f16; rois (R, 5) f32, grouped per
//   image (roi r belongs to image r / N, N = R / B); P <= 15 with an
//   optional subset `grid` of the P positions (the same on both axes);
//   output (R, G, G, C) in the fmap dtype.
//
// Weights. Along one axis, the single tap at coordinate c has
//   s = clamp(min(floor(c), E - 2), 0, E - 2), ratio = c - min(floor(c), E-2)
//   weight T(1 - ratio) at s and T(ratio) at s + 1, zero if c is outside
//   [0, E)  (T() = rounding to the fmap dtype, as the plain path builds its
//   interpolation matrices in that dtype), and the 2x2 average folds the
//   taps of grid points g and g + 1 into at most 4 weights
//   T(0.5 * a + 0.5 * b) (the plain path's fold is a matmul in the fmap
//   dtype with f32 accumulation). The kernel computes exactly these values
//   from the rois, with the plain path's f32 operations in its order (no
//   FMA contraction; the division by P is a multiplication by the f32
//   reciprocal, which is how PyTorch's CUDA division by a Python scalar
//   runs), so the weights are the plain path's bit for bit.
//
// Sum. Each output element is a <= 16-tap sum in f32, taken in the plain
// path's order: first along the longer spatial axis (its first einsum),
// then along the other, each an FMA chain in increasing index, then rounded
// to the fmap dtype. Where the plain path's GEMMs sum in another order the
// results differ in the last f32 bit, which can move a bf16 output by one
// ulp.
//
// What bounds it on an H100: bytes. It reads each covered fmap cell (from
// L2 after the first touch) and writes R * G * G * C outputs, with ~2 flops
// per tap and channel. At the serving shapes (fmap (4, 38, 60, 1024) bf16,
// R = 512, G = 4; (4, 38, 60, 512) bf16, R = 512, G = 7; (1, 38, 60, 1024)
// f32, R = 36, G = 7) the bounds are 2.5-10.6 us at 3.35 TB/s.
//
// Design: one block per (roi, output cell). Its threads compute the cell's
// taps from the roi (a few dozen scalar flops, done redundantly by every
// thread rather than staged through shared memory), then stride over C
// with 16-byte loads (8 bf16/f16 or 4 f32 a thread) where C and the
// pointers allow it, so a warp reads contiguous 512-byte runs of an NHWC
// pixel. No shared memory and no atomics: blocks are independent and the
// taps of neighbouring cells and rois of one image hit in the 50 MB L2.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// f32 rounded to T and back: the weight as the plain path stores it
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Up to 4 taps along one axis, in increasing index; a zero weight marks a
// tap to skip. Every slot is written at a fixed position so that the arrays
// stay in registers.
struct Taps {
  int idx[4];
  float w[4];
};

// The single tap at coordinate c along an axis of extent e.
template <typename T>
__device__ __forceinline__ void single_tap(float c, int e, int& s, float& w0,
                                           float& w1) {
  const bool inside = c >= 0.0f && c < static_cast<float>(e);
  const float top = static_cast<float>(e - 2);
  const float st = fminf(floorf(c), top);
  const float ratio = __fsub_rn(c, st);
  s = static_cast<int>(fmaxf(fminf(st, top), 0.0f));
  w0 = inside ? round_to<T>(__fsub_rn(1.0f, ratio)) : 0.0f;
  w1 = inside ? round_to<T>(ratio) : 0.0f;
}

// The folded taps of output position g (grid points g and g + 1).
template <typename T>
__device__ __forceinline__ void folded_taps(float lo, float bin, int g, int e,
                                            Taps& t) {
  const float ca = __fadd_rn(__fmul_rn(static_cast<float>(g), bin), lo);
  const float cb = __fadd_rn(__fmul_rn(static_cast<float>(g + 1), bin), lo);
  int sa, sb;
  float a0, a1, b0, b1;
  single_tap<T>(ca, e, sa, a0, a1);
  single_tap<T>(cb, e, sb, b0, b1);
  const int cols[4] = {sa, sa + 1, sb, sb + 1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int col = cols[k];
    const float wa = col == sa ? a0 : (col == sa + 1 ? a1 : 0.0f);
    const float wb = col == sb ? b0 : (col == sb + 1 ? b1 : 0.0f);
    const bool merged = k >= 2 && (col == sa || col == sa + 1);
    t.idx[k] = col;
    t.w[k] = merged ? 0.0f
                    : round_to<T>(__fadd_rn(__fmul_rn(0.5f, wa),
                                            __fmul_rn(0.5f, wb)));
  }
}

template <typename T, int VEC>
__global__ void roi_align_avg_kernel(const T* __restrict__ fmap,
                                     const float* __restrict__ rois,
                                     T* __restrict__ out, int H, int W, int C,
                                     int N, int P, int G, long long grid_code,
                                     float spatial_scale) {
  const int cell = blockIdx.x;            // (r * G + i) * G + j
  const int j = cell % G;
  const int i = (cell / G) % G;
  const int r = cell / (G * G);
  const int b = r / N;

  const float* roi = rois + 5 * static_cast<size_t>(r);
  const float x1 = __fmul_rn(roi[1], spatial_scale);
  const float y1 = __fmul_rn(roi[2], spatial_scale);
  const float x2 = __fmul_rn(roi[3], spatial_scale);
  const float y2 = __fmul_rn(roi[4], spatial_scale);
  const float inv_p = 1.0f / static_cast<float>(P);
  const float bin_w =
      __fmul_rn(fmaxf(__fadd_rn(__fsub_rn(x2, x1), 1.0f), 0.0f), inv_p);
  const float bin_h =
      __fmul_rn(fmaxf(__fadd_rn(__fsub_rn(y2, y1), 1.0f), 0.0f), inv_p);
  const int gi = static_cast<int>((grid_code >> (4 * i)) & 15);
  const int gj = static_cast<int>((grid_code >> (4 * j)) & 15);
  Taps ty, tx;
  folded_taps<T>(y1, bin_h, gi, H, ty);
  folded_taps<T>(x1, bin_w, gj, W, tx);
  // the plain path contracts the longer axis first
  const bool cols_first = W >= H;
  const Taps inner = cols_first ? tx : ty;
  const Taps outer = cols_first ? ty : tx;

  const T* img = fmap + static_cast<size_t>(b) * H * W * C;
  T* dst = out + static_cast<size_t>(cell) * C;
  using Pk = Pack<T, VEC>;
  for (int c0 = threadIdx.x * VEC; c0 < C; c0 += blockDim.x * VEC) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      if (outer.w[o] == 0.0f) continue;
      float t[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (inner.w[k] == 0.0f) continue;
        const int row = cols_first ? outer.idx[o] : inner.idx[k];
        const int col = cols_first ? inner.idx[k] : outer.idx[o];
        const Pk p = *reinterpret_cast<const Pk*>(
            img + (static_cast<size_t>(row) * W + col) * C + c0);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          t[e] = fmaf(inner.w[k], to_f32<T>(p.v[e]), t[e]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(outer.w[o], t[e], acc[e]);
    }
    Pk q;
#pragma unroll
    for (int e = 0; e < VEC; ++e) q.v[e] = from_f32<T>(acc[e]);
    *reinterpret_cast<Pk*>(dst + c0) = q;
  }
}

template <typename T>
cudaError_t launch(const void* fmap, const void* rois, void* out, int B, int H,
                   int W, int C, int R, int P, int G, long long grid_code,
                   float spatial_scale, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_ok = (C % kVec == 0) &&
                      (reinterpret_cast<uintptr_t>(fmap) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int vec = vec_ok ? kVec : 1;
  const int lanes = (C + vec - 1) / vec;
  const int threads = min(256, ((lanes + 31) / 32) * 32);
  const dim3 grid(static_cast<unsigned>(R) * G * G);
  const int N = R / B;
  const T* f = static_cast<const T*>(fmap);
  const float* ro = static_cast<const float*>(rois);
  T* o = static_cast<T*>(out);
  if (vec_ok) {
    roi_align_avg_kernel<T, kVec><<<grid, threads, 0, stream>>>(
        f, ro, o, H, W, C, N, P, G, grid_code, spatial_scale);
  } else {
    roi_align_avg_kernel<T, 1><<<grid, threads, 0, stream>>>(
        f, ro, o, H, W, C, N, P, G, grid_code, spatial_scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. grid_code holds the G
// selected positions, 4 bits each (position k in bits 4k..4k+3). Returns
// the cudaError_t of the launch (0 = cudaSuccess); the caller raises on
// anything else.
extern "C" int i2vsgg_roi_align_avg_forward(const void* fmap, const void* rois,
                                            void* out, int dtype, int B, int H,
                                            int W, int C, int R, int P, int G,
                                            long long grid_code,
                                            float spatial_scale, void* stream) {
  if (R <= 0 || C <= 0 || G <= 0) return 0;
  if (B <= 0 || R % B != 0 || H < 2 || W < 2 || P < 1 || P > 15 || G > P)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch<float>(fmap, rois, out, B, H, W, C, R, P, G, grid_code,
                          spatial_scale, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(fmap, rois, out, B, H, W, C, R, P, G,
                                  grid_code, spatial_scale, s);
      break;
    case 2:
      err = launch<__half>(fmap, rois, out, B, H, W, C, R, P, G, grid_code,
                           spatial_scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
