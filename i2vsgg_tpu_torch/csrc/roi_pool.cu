// Exact max-RoIPool over NHWC feature maps, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel at i2vsgg_tpu/ops/pallas/roi_pool_kernel.py:134
// (roi_pool_pallas / _bin_bounds / _kernel), which kept the image's map in
// VMEM and visited each feature-map row once per roi. Semantics are those
// of the jnp sweep in i2vsgg_tpu/ops/roi_pool.py (torchvision ROIPool
// math):
//
//   roi_start = round_half_even(coord * spatial_scale)
//   roi_size  = max(roi_end - roi_start + 1, 1)
//   bin(p)    = [floor(p * roi_size / P) + roi_start,
//                ceil((p + 1) * roi_size / P) + roi_start)  clamped to [0, dim]
//   out       = max over the bin (taken in f32), 0 if the bin is empty
//
// The result is bit-exact against the plain PyTorch version beside the
// wrapper (i2vsgg_tpu_torch/ops/roi_pool.py) in every supported dtype: a max
// of values of one type is one of those values, in any order, and the
// f32 -> storage-type conversion of such a value is exact.
//
// Traps, each one a mismatch against the reference if got wrong:
//  * jnp.round and torch.round round half to EVEN. C's roundf rounds half
//    away from zero, so a roi edge at x.5 after the 1/16 scale would move a
//    whole cell. __float2int_rn rounds to nearest even.
//  * The bin ends are a ceil-division. C's '/' truncates toward zero, which
//    is floor only for non-negative operands; p, roi_size and P are all
//    non-negative here, so ceil(a / P) is written (a + P - 1) / P.
//  * The batch index comes from rois[:, 0] (truncated like astype(int32)),
//    not from the roi's position, and is clamped into [0, B) so that a bad
//    index cannot read outside the feature map.
//
// What bounds it on an H100. The work is bytes: each covered fmap cell read
// once, P*P*C outputs a roi written once; at the serving shape (fmap
// (1, 38, 60, 1024) bf16, R = 36 rois: 8 objects and 28 unions, P = 7)
// about 8 MB a frame, 2.5 us at 3.35 TB/s. The first design (kept as mode
// 1), one block per (roi, bin) with each thread walking its bin in L2,
// reads every cell of every bin from L2: the sum of the rois' areas, up to
// ~140 MB a frame when the unions cover most of the map, which holds it at
// ~17 us a launch on an H100. Read from shared memory instead, the same
// sweep is bound by the rows' column-bin maxima: a bin is ~9 columns wide,
// and every roi pays for them again.
//
// Design (mode 0, "staged"): one block per (channel slice, image), 1024
// threads.
//   1. The block copies the image's map slice (H, W, CS) into shared memory
//      once (cp.async, 16 bytes a thread; rows at an odd pitch), and fills
//      the bin bounds of a chunk of rois into a shared table (one thread an
//      entry) while the copies are in flight.
//   2. One pass builds range maxima over 2, 4 and 8 columns from each pixel
//      (the levels that fit in shared memory), shared by all the rois of
//      the image: the column-bin maximum of a row is then two reads
//      whatever the bin's width up to 16, and steps of 8 beyond.
//   3. Item (roi, row bin, column bin, vector) sweeps the row bin's rows,
//      takes each row's column-bin maximum from the widest level that fits
//      the bin, and writes the max of those (0 for an empty bin). A roi of
//      another image is skipped.
// Maxima are taken on packed bf16/f16 pairs (__hmax2): a max of values of
// one type is one of them, exact in any order and grouping, so the result
// is the plain version's bit for bit. Every load after the staging comes
// from shared memory. The slice CS is the widest multiple of VEC (16 bytes
// of the fmap type) that gives B * ceil(C / CS) >= kMinBlocks blocks and
// fits: 8 bf16 channels at the serving shape, 128 blocks a frame, with all
// four levels (152 KB). Where no slice fits (maps above ~13,000 cells),
// mode 1 takes the call; the wrapper counts the modes apart. The caller
// may ask for a slice, or for mode 1.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 1024;
constexpr int kMinBlocks = 128;         // about one wave on 132 SMs
constexpr int kMaxLevels = 4;           // range maxima of 1, 2, 4, 8 columns
constexpr int kTableBytes = 16384;      // a chunk of rois' bin bounds

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
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

// VEC consecutive channels, loaded and stored as one access (16 bytes when
// VEC * sizeof(T) == 16).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// A roi's image (clamped) and its quantized extent on the feature map.
struct RoiBox {
  int b, start_w, start_h, roi_w, roi_h;
};

__device__ __forceinline__ RoiBox roi_box(const float* roi, int B,
                                          float spatial_scale) {
  RoiBox r;
  r.b = min(max(static_cast<int>(roi[0]), 0), B - 1);
  // round half to even, as jnp.round / torch.round (not roundf)
  r.start_w = __float2int_rn(roi[1] * spatial_scale);
  r.start_h = __float2int_rn(roi[2] * spatial_scale);
  const int end_w = __float2int_rn(roi[3] * spatial_scale);
  const int end_h = __float2int_rn(roi[4] * spatial_scale);
  r.roi_w = max(end_w - r.start_w + 1, 1);
  r.roi_h = max(end_h - r.start_h + 1, 1);
  return r;
}

// Bin p of P along an axis of extent e: [lo, hi). floor / ceil of
// non-negative quotients: '/' truncates, so ceil(a/P) is (a + P - 1) / P.
__device__ __forceinline__ int bin_lo(int p, int size, int P, int start,
                                      int e) {
  return min(max(p * size / P + start, 0), e);
}
__device__ __forceinline__ int bin_hi(int p, int size, int P, int start,
                                      int e) {
  return min(max(((p + 1) * size + P - 1) / P + start, 0), e);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The staged map's row pitch, in pixels of CS channels: odd, so that the
// same column of neighbouring rows falls in different shared-memory banks
// (an even W puts them in the same few).
__host__ __device__ __forceinline__ int odd_pitch(int W) { return W | 1; }

// m = max(m, p) elementwise, exact in any order (a max is one of its
// inputs): __hmax2 on bf16 or f16 pairs, no conversion to f32. p is taken
// by value, so that its load from shared memory is one 16-byte access.
template <typename T, int VEC>
__device__ __forceinline__ void max_into(Pack<T, VEC>& m, Pack<T, VEC> p) {
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) m.v[i] = fmaxf(m.v[i], p.v[i]);
  } else if constexpr (VEC % 2 == 0) {
    using T2 = std::conditional_t<std::is_same_v<T, __half>, __half2,
                                  __nv_bfloat162>;
    T2* a = reinterpret_cast<T2*>(m.v);
    const T2* b = reinterpret_cast<const T2*>(p.v);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) a[i] = __hmax2(a[i], b[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) m.v[i] = __hmax(m.v[i], p.v[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> filled(float v) {
  Pack<T, VEC> p;
#pragma unroll
  for (int i = 0; i < VEC; ++i) p.v[i] = from_f32<T>(v);
  return p;
}

// A chunk's table: per roi, `own` (1 if the roi is this block's image's),
// then the PH row bins' and the PW column bins' [lo, hi).
__host__ __device__ __forceinline__ int table_ints(int PH, int PW) {
  return 1 + 2 * PH + 2 * PW;
}

// Fills the table of rois r0 .. r0 + nk - 1, one thread an entry.
__device__ __forceinline__ void fill_table(int* tab, const float* rois,
                                          int r0, int nk, int b, int B,
                                          int H, int W, int PH, int PW,
                                          float spatial_scale) {
  const int ti = table_ints(PH, PW);
  for (int e = threadIdx.x; e < nk * ti; e += blockDim.x) {
    const int k = e / ti;
    const int j = e - k * ti;
    const RoiBox rb = roi_box(rois + 5 * static_cast<size_t>(r0 + k), B,
                              spatial_scale);
    int val;
    if (j == 0) {
      val = rb.b == b;
    } else if (j <= 2 * PH) {             // row bin (j - 1) / 2
      const int p = (j - 1) >> 1;
      val = (j & 1) ? bin_lo(p, rb.roi_h, PH, rb.start_h, H)
                    : bin_hi(p, rb.roi_h, PH, rb.start_h, H);
    } else {                              // column bin
      const int p = (j - 1 - 2 * PH) >> 1;
      val = (j & 1) ? bin_lo(p, rb.roi_w, PW, rb.start_w, W)
                    : bin_hi(p, rb.roi_w, PW, rb.start_w, W);
    }
    tab[e] = val;
  }
}

// Mode 0: one block per (channel slice, image). Shared memory: `levels`
// copies of the map slice (H, W, CS) at an odd row pitch, level l holding
// at (h, w) the max over columns [w, w + 2^l) of row h; then the table of
// a chunk of rois.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
roi_pool_staged_kernel(const T* __restrict__ fmap,
                       const float* __restrict__ rois, T* __restrict__ out,
                       int B, int H, int W, int C, int R, int PH, int PW,
                       float spatial_scale, int CS, int levels, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Pk = Pack<T, VEC>;
  const int pixels = H * W;
  const int pitch = odd_pitch(W);
  const size_t level_size = static_cast<size_t>(H) * pitch * CS;
  T* map = reinterpret_cast<T*>(smem);
  int* tab = reinterpret_cast<int*>(
      smem + ((levels * level_size * sizeof(T) + 15) & ~static_cast<size_t>(15)));
  const int ti = table_ints(PH, PW);
  const int b = blockIdx.y;
  const int c_lo = blockIdx.x * CS;
  const int cs = min(CS, C - c_lo);                          // a multiple of VEC
  const int nv = cs / VEC;

  const T* img = fmap + static_cast<size_t>(b) * pixels * C + c_lo;
  if constexpr (VEC * sizeof(T) == 16) {
    for (int e = threadIdx.x; e < pixels * nv; e += blockDim.x) {
      const int p = e / nv;
      const int v = e - p * nv;
      const int h = p / W;
      cp_async16(map + static_cast<size_t>(p + h * (pitch - W)) * CS + v * VEC,
                 img + static_cast<size_t>(p) * C + v * VEC);
    }
  } else {
    for (int e = threadIdx.x; e < pixels * cs; e += blockDim.x) {
      const int p = e / cs;
      const int c = e - p * cs;
      const int h = p / W;
      map[static_cast<size_t>(p + h * (pitch - W)) * CS + c] =
          img[static_cast<size_t>(p) * C + c];
    }
  }
  // the first chunk's table while the copies are in flight
  fill_table(tab, rois, 0, min(chunk, R), b, B, H, W, PH, PW, spatial_scale);
  cp_async_wait_all();
  __syncthreads();

  // the range maxima in one pass: a thread takes pixel (h, w) and keeps
  // the running max of columns w .. w + 2^l - 1 at each level l whose
  // range ends inside the row
  for (int e = threadIdx.x; e < pixels * nv; e += blockDim.x) {
    const int v = e % nv;
    const int p = e / nv;
    const int h = p / W;
    const int w = p - h * W;
    const size_t at = (static_cast<size_t>(h) * pitch + w) * CS + v * VEC;
    Pk m = *reinterpret_cast<const Pk*>(map + at);
    for (int l = 1, lo = 1; l < levels && w + 2 * lo <= W; ++l, lo *= 2) {
      for (int j = lo; j < 2 * lo; ++j)
        max_into(m, *reinterpret_cast<const Pk*>(
                        map + at + static_cast<size_t>(j) * CS));
      *reinterpret_cast<Pk*>(map + l * level_size + at) = m;
    }
  }
  __syncthreads();

  for (int r0 = 0; r0 < R; r0 += chunk) {
    const int nk = min(chunk, R - r0);
    if (r0 > 0) {
      __syncthreads();                   // the last chunk's items are done
      fill_table(tab, rois, r0, nk, b, B, H, W, PH, PW, spatial_scale);
      __syncthreads();
    }
    // item (k, ph, pw, v): over the rows of row bin ph, the max of each
    // row's column-bin maximum, read from the widest level whose range fits
    // in the column bin: two reads where the bin is at most twice as wide,
    // else steps of that range and one read that ends at the bin's end
    for (int e = threadIdx.x; e < nk * PH * PW * nv; e += blockDim.x) {
      const int v = e % nv;
      const int pw = (e / nv) % PW;
      const int ph = (e / (nv * PW)) % PH;
      const int k = e / (nv * PW * PH);
      const int* t = tab + k * ti;
      if (!t[0]) continue;
      const int hs = t[1 + 2 * ph], he = t[2 + 2 * ph];
      const int ws = t[1 + 2 * PH + 2 * pw], we = t[2 + 2 * PH + 2 * pw];
      Pk m = filled<T, VEC>(-INFINITY);
      if (we > ws) {
        const int l = min(levels - 1, 31 - __clz(we - ws));
        const int step = 1 << l;
        const T* lvl = map + l * level_size + v * VEC;
        for (int h = hs; h < he; ++h) {
          const T* row = lvl + static_cast<size_t>(h) * pitch * CS;
          for (int w = ws; w + step < we; w += step)
            max_into(m, *reinterpret_cast<const Pk*>(
                            row + static_cast<size_t>(w) * CS));
          max_into(m, *reinterpret_cast<const Pk*>(
                          row + static_cast<size_t>(we - step) * CS));
        }
      }
      *reinterpret_cast<Pk*>(
          out + ((static_cast<size_t>(r0 + k) * PH + ph) * PW + pw) * C +
          c_lo + v * VEC) = (he <= hs || we <= ws) ? filled<T, VEC>(0.0f) : m;
    }
  }
}

// Mode 1: one block per (roi, output bin), each thread walking the bin in
// global memory (L2). Taken where no map slice fits in shared memory.
template <typename T, int VEC>
__global__ void roi_pool_per_bin_kernel(const T* __restrict__ fmap,
                                        const float* __restrict__ rois,
                                        T* __restrict__ out, int B, int H,
                                        int W, int C, int PH, int PW,
                                        float spatial_scale) {
  const int bin = blockIdx.x;  // (r * PH + ph) * PW + pw
  const int pw = bin % PW;
  const int ph = (bin / PW) % PH;
  const int r = bin / (PW * PH);

  const RoiBox rb = roi_box(rois + 5 * static_cast<size_t>(r), B,
                            spatial_scale);
  const int hs = bin_lo(ph, rb.roi_h, PH, rb.start_h, H);
  const int he = bin_hi(ph, rb.roi_h, PH, rb.start_h, H);
  const int ws = bin_lo(pw, rb.roi_w, PW, rb.start_w, W);
  const int we = bin_hi(pw, rb.roi_w, PW, rb.start_w, W);
  const bool empty = (he <= hs) || (we <= ws);

  const T* img = fmap + static_cast<size_t>(rb.b) * H * W * C;
  T* dst = out + static_cast<size_t>(bin) * C;
  using P = Pack<T, VEC>;

  for (int c0 = threadIdx.x * VEC; c0 < C; c0 += blockDim.x * VEC) {
    float m[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) m[i] = -INFINITY;
    for (int h = hs; h < he; ++h) {
      const T* row = img + (static_cast<size_t>(h) * W) * C + c0;
      for (int w = ws; w < we; ++w) {
        const P p = *reinterpret_cast<const P*>(row + static_cast<size_t>(w) * C);
#pragma unroll
        for (int i = 0; i < VEC; ++i) m[i] = fmaxf(m[i], to_f32<T>(p.v[i]));
      }
    }
    P o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(empty ? 0.0f : m[i]);
    *reinterpret_cast<P*>(dst + c0) = o;
  }
}

// The launch plan: mode (0 staged, 1 per bin), the slice width CS in
// channels, the dynamic shared memory in bytes, the range-max levels, rois
// a chunk.
struct Plan {
  int mode, slice, smem, levels, chunk;
};

// want_slice: 0 lets the plan choose, > 0 asks for that slice (a multiple
// of vec), < 0 asks for mode 1. Returns false for a slice it cannot take.
bool make_plan(int B, int H, int W, int C, int R, int PH, int PW,
               size_t esize, int vec, int want_slice, int max_smem,
               Plan& plan) {
  plan = Plan{1, 0, 0, 0, 0};
  if (want_slice < 0) return true;
  const int chunk = max(1, min(R, kTableBytes / (4 * table_ints(PH, PW))));
  const auto bytes = [&](int cs, int levels) {
    const long long data = static_cast<long long>(levels) * H * odd_pitch(W) *
                           cs * static_cast<long long>(esize);
    return ((data + 15) & ~15LL) + 4LL * chunk * table_ints(PH, PW);
  };
  const auto fits = [&](int cs) { return bytes(cs, 1) <= max_smem; };
  int cs = 0;
  if (want_slice > 0) {
    if (want_slice % vec != 0 || !fits(want_slice)) return false;
    cs = want_slice;
  } else {
    const int c_up = (C + vec - 1) / vec * vec;
    for (int cand = 64; cand >= 1; cand /= 2) {
      if (cand % vec != 0 || cand > c_up || !fits(cand)) continue;
      cs = cand;                         // the narrowest that fits, so far
      if (static_cast<long long>(B) * ((C + cand - 1) / cand) >= kMinBlocks)
        break;                           // the widest with enough blocks
    }
    if (cs == 0) return true;            // nothing fits: mode 1
  }
  int levels = 1;
  while (levels < kMaxLevels && bytes(cs, levels + 1) <= max_smem) ++levels;
  plan = Plan{0, cs, static_cast<int>(bytes(cs, levels)), levels, chunk};
  return true;
}

template <typename T>
cudaError_t launch(const void* fmap, const void* rois, void* out, int B, int H,
                   int W, int C, int R, int PH, int PW, float spatial_scale,
                   int want_slice, int* plan_out, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_ok = (C % kVec == 0) &&
                      (reinterpret_cast<uintptr_t>(fmap) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int vec = vec_ok ? kVec : 1;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  Plan plan;
  if (!make_plan(B, H, W, C, R, PH, PW, sizeof(T), vec, want_slice, max_smem,
                 plan))
    return cudaErrorInvalidValue;
  plan_out[0] = plan.mode;
  plan_out[1] = plan.slice;
  plan_out[2] = plan.smem;
  const T* f = static_cast<const T*>(fmap);
  const float* ro = static_cast<const float*>(rois);
  T* o = static_cast<T*>(out);
  if (plan.mode == 0) {
    const dim3 grid((C + plan.slice - 1) / plan.slice, B);
    auto kern = vec_ok ? roi_pool_staged_kernel<T, kVec>
                       : roi_pool_staged_kernel<T, 1>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               plan.smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, plan.smem, stream>>>(f, ro, o, B, H, W, C, R, PH,
                                               PW, spatial_scale, plan.slice,
                                               plan.levels, plan.chunk);
  } else {
    const int lanes = (C + vec - 1) / vec;
    const int threads = min(256, ((lanes + 31) / 32) * 32);
    const dim3 grid(static_cast<unsigned>(R) * PH * PW);
    auto kern = vec_ok ? roi_pool_per_bin_kernel<T, kVec>
                       : roi_pool_per_bin_kernel<T, 1>;
    kern<<<grid, threads, 0, stream>>>(f, ro, o, B, H, W, C, PH, PW,
                                       spatial_scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. slice: 0 to let the kernel
// choose, > 0 for that channel slice (mode 0), < 0 for mode 1. plan_out
// receives the mode, the slice and the dynamic shared memory in bytes.
// Returns the cudaError_t of the launch (0 = cudaSuccess); the caller
// raises on anything else.
extern "C" int i2vsgg_roi_pool_forward(const void* fmap, const void* rois,
                                       void* out, int dtype, int B, int H,
                                       int W, int C, int R, int PH, int PW,
                                       float spatial_scale, int slice,
                                       int* plan_out, void* stream) {
  plan_out[0] = plan_out[1] = plan_out[2] = -1;
  if (R <= 0 || PH <= 0 || PW <= 0 || C <= 0) return 0;
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch<float>(fmap, rois, out, B, H, W, C, R, PH, PW,
                          spatial_scale, slice, plan_out, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(fmap, rois, out, B, H, W, C, R, PH, PW,
                                  spatial_scale, slice, plan_out, s);
      break;
    case 2:
      err = launch<__half>(fmap, rois, out, B, H, W, C, R, PH, PW,
                           spatial_scale, slice, plan_out, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
