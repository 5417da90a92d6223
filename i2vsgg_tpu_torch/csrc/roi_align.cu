// RoIAlignAvg (the reference's single-tap RoIAlign on a (P+1)^2 grid,
// 2x2 stride-1 averaged to P x P) over NHWC feature maps, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel at i2vsgg_tpu/ops/pallas/roi_align_kernel.py:119
// (roi_align_avg_pallas_core, pick_tiles, _kernel), which kept a
// (1, h, w, c_tile) block of the image's map in VMEM and applied
// caller-built one-hot-shaped Ry/Rx matrices as two MXU contractions. The
// contract is that of the port's plain version, roi_align_avg_plain in
// i2vsgg_tpu_torch/ops/roi_align.py:
//
//   fmap (B, H, W, C) in f32, bf16 or f16; rois (R, 5) f32, grouped per
//   image (roi r belongs to image r / N, N = R / B); P <= 15 with an
//   optional subset `grid` of the P positions (the same on both axes);
//   output (R, G, G, C) in the fmap dtype, or in f32 from a bf16/f16 map
//   (the widening mode: each value widened exactly, the weights built in
//   f32 -- the function of pooling fmap.float(), without the copy).
//
// Weights. Along one axis, the single tap at coordinate c has
//   s = clamp(min(floor(c), E - 2), 0, E - 2), ratio = c - min(floor(c), E-2)
//   weight T(1 - ratio) at s and T(ratio) at s + 1, zero if c is outside
//   [0, E)  (T() = rounding to the weight type, the output's: the plain
//   path builds its interpolation matrices in that type), and the 2x2
//   average folds the taps of grid points g and g + 1 into at most 4
//   weights T(0.5 * a + 0.5 * b) (the plain path's fold is a matmul in the
//   weight type with f32 accumulation). The kernel computes exactly these
//   values from the rois, with the plain path's f32 operations in its order
//   (no FMA contraction; the division by P is a multiplication by the f32
//   reciprocal, which is how PyTorch's CUDA division by a Python scalar
//   runs), so the weights are the plain path's bit for bit.
//
// Sum. Each output element is a <= 16-tap sum in f32, taken in the plain
// path's order: first along the longer spatial axis (its first einsum),
// then along the other, each an FMA chain in increasing index, then
// rounded to the output type. Where the plain path's
// GEMMs sum in another order the results differ in the last f32 bit, which
// can move a bf16 output by one ulp.
//
// What bounds it on an H100. The work's bytes (each covered fmap cell read
// once, R * G * G * C outputs written once) at the serving shapes (fmap
// (4, 38, 60, 1024) bf16, R = 512, G = 4; (4, 38, 60, 512) bf16, R = 512,
// G = 7; (1, 38, 60, 1024) bf16 to f32, R = 36, G = 7) take 2.3-8 us at
// 3.35 TB/s. The taps do not: every output element is up to 16 taps of a
// pixel vector, each a load, a widening and an FMA, and the rois overlap
// (512 proposals cover a 38x60 map about 14 times). The first design (kept
// as mode 1), one block per (roi, output cell) reading its taps from L2,
// reads up to 268 MB (det), 411 MB (ic) and 116 MB (SGG, then on an f32
// copy) from L2 for maps of 18.7, 9.3 and 9.3 MB. Read from shared memory,
// the same taps are bound by shared-memory bandwidth (128 B a clock an SM)
// and by the ~2 instructions a tap element costs, about equally: ~10 us at
// the det site before the staging.
//
// Design (mode 0, "staged"): one block per (channel slice, image), 512
// threads. The block copies the image's map slice (H, W, CS) into shared
// memory once (cp.async, 16 bytes a thread), then walks the image's rois
// in chunks: the chunk's folded taps on both axes (index and weight, a
// shared table of 32-byte entries) are computed once, one thread an entry,
// while the first copies are in flight, and every tap read after the
// staging comes from shared memory. A thread owns one (roi, cell along the
// longer axis, VEC-channel vector) and walks the cells along the other
// axis: the inner sum of a grid point's two rows (or columns) is the same
// for both cells that share the point, so on the full grid each cell after
// the first computes two inner sums, not four (the same values: the outputs
// are those of the per-cell order bit for bit). The slice CS is the widest
// multiple of VEC (16 bytes of the fmap type) that gives B * ceil(C / CS)
// >= kMinBlocks blocks and fits in shared memory, widened while a block
// still has at most one item a thread (few rois): 32 bf16 channels at the
// det site (128 blocks of 170 KB), 16 at the ic site (128 blocks) and at
// the SGG site (64 blocks). Where even the narrowest slice does not fit
// (maps above ~13,000 cells), mode 1 takes the call; the wrapper counts
// the two modes apart. The caller may ask for a slice, or for mode 1.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kTableBytes = 24576;      // a chunk's taps, 32 bytes an entry
constexpr int kMinBlocks = 128;         // about one wave on 132 SMs

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

// VEC f32 sums rounded to TO and stored at dst, 16 bytes a store where VEC
// fills whole 16-byte packs (dst is then 16-byte aligned), else one by one.
template <typename TO, int VEC>
__device__ __forceinline__ void store_out(TO* dst, const float (&acc)[VEC]) {
  constexpr int kPer = 16 / sizeof(TO);
  if constexpr (VEC % kPer == 0) {
#pragma unroll
    for (int q = 0; q < VEC / kPer; ++q) {
      Pack<TO, kPer> p;
#pragma unroll
      for (int e = 0; e < kPer; ++e) p.v[e] = from_f32<TO>(acc[q * kPer + e]);
      *reinterpret_cast<Pack<TO, kPer>*>(dst + q * kPer) = p;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = from_f32<TO>(acc[e]);
  }
}

// Up to 4 taps along one axis, in increasing index; a zero weight marks a
// tap that adds nothing (outside the map, or merged into an earlier slot).
// Every slot is written at a fixed position so that the arrays stay in
// registers.
struct Taps {
  int idx[4];
  float w[4];
};

// The single tap at coordinate c along an axis of extent e, its weights
// rounded to WT.
template <typename WT>
__device__ __forceinline__ void single_tap(float c, int e, int& s, float& w0,
                                           float& w1) {
  const bool inside = c >= 0.0f && c < static_cast<float>(e);
  const float top = static_cast<float>(e - 2);
  const float st = fminf(floorf(c), top);
  const float ratio = __fsub_rn(c, st);
  s = static_cast<int>(fmaxf(fminf(st, top), 0.0f));
  w0 = inside ? round_to<WT>(__fsub_rn(1.0f, ratio)) : 0.0f;
  w1 = inside ? round_to<WT>(ratio) : 0.0f;
}

// The folded taps of output position g (grid points g and g + 1). Their
// indices are {s_g, s_g + 1, s_(g+1), s_(g+1) + 1}, each in [0, e).
template <typename WT>
__device__ __forceinline__ void folded_taps(float lo, float bin, int g, int e,
                                            Taps& t) {
  const float ca = __fadd_rn(__fmul_rn(static_cast<float>(g), bin), lo);
  const float cb = __fadd_rn(__fmul_rn(static_cast<float>(g + 1), bin), lo);
  int sa, sb;
  float a0, a1, b0, b1;
  single_tap<WT>(ca, e, sa, a0, a1);
  single_tap<WT>(cb, e, sb, b0, b1);
  const int cols[4] = {sa, sa + 1, sb, sb + 1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int col = cols[k];
    const float wa = col == sa ? a0 : (col == sa + 1 ? a1 : 0.0f);
    const float wb = col == sb ? b0 : (col == sb + 1 ? b1 : 0.0f);
    const bool merged = k >= 2 && (col == sa || col == sa + 1);
    t.idx[k] = col;
    t.w[k] = merged ? 0.0f
                    : round_to<WT>(__fadd_rn(__fmul_rn(0.5f, wa),
                                             __fmul_rn(0.5f, wb)));
  }
}

// A roi's origin and bin sizes on the feature map, as the plain path
// computes them.
struct RoiGeom {
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ RoiGeom roi_geom(const float* roi, int P,
                                            float spatial_scale) {
  RoiGeom g;
  g.x1 = __fmul_rn(roi[1], spatial_scale);
  g.y1 = __fmul_rn(roi[2], spatial_scale);
  const float x2 = __fmul_rn(roi[3], spatial_scale);
  const float y2 = __fmul_rn(roi[4], spatial_scale);
  const float inv_p = 1.0f / static_cast<float>(P);
  g.bin_w = __fmul_rn(fmaxf(__fadd_rn(__fsub_rn(x2, g.x1), 1.0f), 0.0f), inv_p);
  g.bin_h = __fmul_rn(fmaxf(__fadd_rn(__fsub_rn(y2, g.y1), 1.0f), 0.0f), inv_p);
  return g;
}

__device__ __forceinline__ int grid_pos(long long grid_code, int cell) {
  return static_cast<int>((grid_code >> (4 * cell)) & 15);
}

// 16-byte asynchronous copy from global to shared memory, and the wait for
// all of a thread's copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The inner sum of one outer index q (a row when the columns are the
// inner axis): sum over the 4 inner taps of w * pix, an FMA chain in tap
// order. A zero weight adds 0 * pix = +-0 to a sum that starts at +0 and is
// never -0, so on a finite map the sums are those that skip it: mode 0
// adds it (no branch, the load is from shared memory), mode 1 skips it (no
// load from L2).
template <typename T, int VEC, bool kSkipZero>
__device__ __forceinline__ void inner_sum(const T* __restrict__ base, int q,
                                          const Taps& in, bool cols_first,
                                          int W, int CS, float (&t)[VEC]) {
  using Pk = Pack<T, VEC>;
#pragma unroll
  for (int e = 0; e < VEC; ++e) t[e] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (kSkipZero && in.w[k] == 0.0f) continue;
    const int pix = cols_first ? q * W + in.idx[k] : in.idx[k] * W + q;
    const Pk p = *reinterpret_cast<const Pk*>(base + static_cast<size_t>(pix) * CS);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      t[e] = fmaf(in.w[k], to_f32<T>(p.v[e]), t[e]);
  }
}

// Mode 0: one block per (channel slice, image); the map slice (H, W, CS)
// in shared memory after a table of kTableBytes.
template <typename T, typename TO, int VEC>
__global__ void __launch_bounds__(kThreads)
roi_align_staged_kernel(const T* __restrict__ fmap,
                        const float* __restrict__ rois, TO* __restrict__ out,
                        int H, int W, int C, int N, int P, int G,
                        long long grid_code, float spatial_scale, int CS,
                        int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  Taps* tab = reinterpret_cast<Taps*>(smem);          // (chunk, 2, G)
  T* map = reinterpret_cast<T*>(smem + kTableBytes);  // (H, W, CS)
  const int b = blockIdx.y;
  const int c_lo = blockIdx.x * CS;
  const int cs = min(CS, C - c_lo);                   // a multiple of VEC
  const int nv = cs / VEC;
  const int pixels = H * W;

  // stage the slice; the copies run while the first chunk's taps are built
  const T* img = fmap + static_cast<size_t>(b) * pixels * C + c_lo;
  if constexpr (VEC * sizeof(T) == 16) {
    for (int e = threadIdx.x; e < pixels * nv; e += blockDim.x) {
      const int p = e / nv;
      const int v = e - p * nv;
      cp_async16(map + static_cast<size_t>(p) * CS + v * VEC,
                 img + static_cast<size_t>(p) * C + v * VEC);
    }
  } else {
    for (int e = threadIdx.x; e < pixels * cs; e += blockDim.x) {
      const int p = e / cs;
      const int c = e - p * cs;
      map[static_cast<size_t>(p) * CS + c] = img[static_cast<size_t>(p) * C + c];
    }
  }

  // the plain path contracts the longer axis first
  const bool cols_first = W >= H;
  const float* img_rois = rois + 5 * static_cast<size_t>(b) * N;
  for (int k0 = 0; k0 < N; k0 += chunk) {
    const int nk = min(chunk, N - k0);
    // the chunk's taps: entry (k * 2 + axis) * G + cell, axis 0 the rows
    for (int e = threadIdx.x; e < nk * 2 * G; e += blockDim.x) {
      const int k = e / (2 * G);
      const int axis = (e / G) & 1;
      const int cell = e % G;
      const RoiGeom gm = roi_geom(img_rois + 5 * (k0 + k), P, spatial_scale);
      if (axis == 0)
        folded_taps<TO>(gm.y1, gm.bin_h, grid_pos(grid_code, cell), H, tab[e]);
      else
        folded_taps<TO>(gm.x1, gm.bin_w, grid_pos(grid_code, cell), W, tab[e]);
    }
    if (k0 == 0) cp_async_wait_all();
    __syncthreads();

    // item (k, u, v): roi k, cell u along the inner axis, vector v; the
    // thread walks the G cells along the outer axis
    for (int e = threadIdx.x; e < nk * G * nv; e += blockDim.x) {
      const int k = e / (G * nv);
      const int u = (e / nv) % G;
      const int v = e % nv;
      const Taps* tk = tab + k * 2 * G;
      const Taps in = tk[(cols_first ? G : 0) + u];
      const Taps* outer = tk + (cols_first ? 0 : G);
      const T* base = map + v * VEC;
      TO* dst_roi = out + static_cast<size_t>(b * N + k0 + k) * G * G * C +
                    c_lo + v * VEC;
      float ta[2][VEC], tb[2][VEC];
      int prev = -2;
      for (int o = 0; o < G; ++o) {
        const Taps ot = outer[o];
        const int g = grid_pos(grid_code, o);
        // grid point g is the previous cell's second point: same sums
        if (g == prev + 1) {
#pragma unroll
          for (int e2 = 0; e2 < VEC; ++e2) {
            ta[0][e2] = tb[0][e2];
            ta[1][e2] = tb[1][e2];
          }
        } else {
          inner_sum<T, VEC, false>(base, ot.idx[0], in, cols_first, W, CS, ta[0]);
          inner_sum<T, VEC, false>(base, ot.idx[1], in, cols_first, W, CS, ta[1]);
        }
        inner_sum<T, VEC, false>(base, ot.idx[2], in, cols_first, W, CS, tb[0]);
        inner_sum<T, VEC, false>(base, ot.idx[3], in, cols_first, W, CS, tb[1]);
        prev = g;
        float acc[VEC];
#pragma unroll
        for (int e2 = 0; e2 < VEC; ++e2) {
          float a = fmaf(ot.w[0], ta[0][e2], 0.0f);
          a = fmaf(ot.w[1], ta[1][e2], a);
          a = fmaf(ot.w[2], tb[0][e2], a);
          acc[e2] = fmaf(ot.w[3], tb[1][e2], a);
        }
        const int cell = cols_first ? o * G + u : u * G + o;
        store_out<TO, VEC>(dst_roi + static_cast<size_t>(cell) * C, acc);
      }
    }
    __syncthreads();   // the table is rewritten by the next chunk
  }
}

// Mode 1: one block per (roi, output cell), taps read from global memory
// (L2). Taken where no map slice fits in shared memory.
template <typename T, typename TO, int VEC>
__global__ void roi_align_per_cell_kernel(const T* __restrict__ fmap,
                                          const float* __restrict__ rois,
                                          TO* __restrict__ out, int H, int W,
                                          int C, int N, int P, int G,
                                          long long grid_code,
                                          float spatial_scale) {
  const int cell = blockIdx.x;            // (r * G + i) * G + j
  const int j = cell % G;
  const int i = (cell / G) % G;
  const int r = cell / (G * G);
  const int b = r / N;

  const RoiGeom gm = roi_geom(rois + 5 * static_cast<size_t>(r), P,
                              spatial_scale);
  Taps ty, tx;
  folded_taps<TO>(gm.y1, gm.bin_h, grid_pos(grid_code, i), H, ty);
  folded_taps<TO>(gm.x1, gm.bin_w, grid_pos(grid_code, j), W, tx);
  // the plain path contracts the longer axis first
  const bool cols_first = W >= H;
  const Taps inner = cols_first ? tx : ty;
  const Taps outer = cols_first ? ty : tx;

  const T* img = fmap + static_cast<size_t>(b) * H * W * C;
  TO* dst = out + static_cast<size_t>(cell) * C;
  for (int c0 = threadIdx.x * VEC; c0 < C; c0 += blockDim.x * VEC) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      if (outer.w[o] == 0.0f) continue;
      float t[VEC];
      inner_sum<T, VEC, true>(img + c0, outer.idx[o], inner, cols_first, W, C,
                              t);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(outer.w[o], t[e], acc[e]);
    }
    store_out<TO, VEC>(dst + c0, acc);
  }
}

// The launch plan: mode (0 staged, 1 per cell), the slice width CS in
// channels, the dynamic shared memory in bytes, rois per chunk.
struct Plan {
  int mode, slice, smem, chunk;
};

// want_slice: 0 lets the plan choose, > 0 asks for that slice (a multiple
// of vec), < 0 asks for mode 1. Returns false for a slice it cannot take.
bool make_plan(int B, int H, int W, int C, int N, int G, size_t esize,
               int vec, int want_slice, int max_smem, Plan& plan) {
  plan = Plan{1, 0, 0, 0};
  if (want_slice < 0) return true;
  const int chunk = kTableBytes / (2 * G * static_cast<int>(sizeof(Taps)));
  const auto bytes = [&](int cs) {
    return kTableBytes + static_cast<long long>(H) * W * cs *
                             static_cast<long long>(esize);
  };
  const auto fits = [&](int cs) { return bytes(cs) <= max_smem; };
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
    // few rois an image: widen the slice while a block still has at most
    // one item a thread (fewer blocks, each busier)
    const int items = min(N, chunk) * G;
    while (2 * cs <= c_up && fits(2 * cs) &&
           static_cast<long long>(items) * (2 * cs / vec) <= kThreads)
      cs *= 2;
  }
  plan.mode = 0;
  plan.slice = cs;
  plan.smem = static_cast<int>(bytes(cs));
  plan.chunk = chunk;
  return true;
}

template <typename T, typename TO>
cudaError_t launch(const void* fmap, const void* rois, void* out, int B, int H,
                   int W, int C, int R, int P, int G, long long grid_code,
                   float spatial_scale, int want_slice, int* plan_out,
                   cudaStream_t stream) {
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
  if (!make_plan(B, H, W, C, R / B, G, sizeof(T), vec, want_slice, max_smem,
                 plan))
    return cudaErrorInvalidValue;
  plan_out[0] = plan.mode;
  plan_out[1] = plan.slice;
  plan_out[2] = plan.smem;
  const int N = R / B;
  const T* f = static_cast<const T*>(fmap);
  const float* ro = static_cast<const float*>(rois);
  TO* o = static_cast<TO*>(out);
  if (plan.mode == 0) {
    const dim3 grid((C + plan.slice - 1) / plan.slice, B);
    auto kern = vec_ok ? roi_align_staged_kernel<T, TO, kVec>
                       : roi_align_staged_kernel<T, TO, 1>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               plan.smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, plan.smem, stream>>>(f, ro, o, H, W, C, N, P, G,
                                               grid_code, spatial_scale,
                                               plan.slice, plan.chunk);
  } else {
    const int lanes = (C + vec - 1) / vec;
    const int threads = min(256, ((lanes + 31) / 32) * 32);
    const dim3 grid(static_cast<unsigned>(R) * G * G);
    auto kern = vec_ok ? roi_align_per_cell_kernel<T, TO, kVec>
                       : roi_align_per_cell_kernel<T, TO, 1>;
    kern<<<grid, threads, 0, stream>>>(f, ro, o, H, W, C, N, P, G, grid_code,
                                       spatial_scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (the map's); out_f32: 1
// for an f32 output from a bf16/f16 map (the widening mode), else 0 (the
// map's dtype). grid_code holds the G selected positions, 4 bits each
// (position k in bits 4k..4k+3). slice: 0 to let the kernel choose, > 0
// for that channel slice (mode 0), < 0 for mode 1. plan_out receives the
// mode, the slice and the dynamic shared memory in bytes. Returns the
// cudaError_t of the launch (0 = cudaSuccess); the caller raises on
// anything else.
extern "C" int i2vsgg_roi_align_avg_forward(const void* fmap, const void* rois,
                                            void* out, int dtype, int out_f32,
                                            int B, int H, int W, int C, int R,
                                            int P, int G, long long grid_code,
                                            float spatial_scale, int slice,
                                            int* plan_out, void* stream) {
  plan_out[0] = plan_out[1] = plan_out[2] = -1;
  if (R <= 0 || C <= 0 || G <= 0) return 0;
  if (B <= 0 || R % B != 0 || H < 2 || W < 2 || P < 1 || P > 15 || G > P ||
      (out_f32 && dtype == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype * 2 + (out_f32 ? 1 : 0)) {
    case 0:
      err = launch<float, float>(fmap, rois, out, B, H, W, C, R, P, G,
                                 grid_code, spatial_scale, slice, plan_out, s);
      break;
    case 2:
      err = launch<__nv_bfloat16, __nv_bfloat16>(
          fmap, rois, out, B, H, W, C, R, P, G, grid_code, spatial_scale,
          slice, plan_out, s);
      break;
    case 3:
      err = launch<__nv_bfloat16, float>(fmap, rois, out, B, H, W, C, R, P, G,
                                         grid_code, spatial_scale, slice,
                                         plan_out, s);
      break;
    case 4:
      err = launch<__half, __half>(fmap, rois, out, B, H, W, C, R, P, G,
                                   grid_code, spatial_scale, slice, plan_out,
                                   s);
      break;
    case 5:
      err = launch<__half, float>(fmap, rois, out, B, H, W, C, R, P, G,
                                  grid_code, spatial_scale, slice, plan_out, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
