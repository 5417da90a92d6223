// ResNet conv1 (7x7, stride 2, pad 3) + FrozenBN affine + ReLU, with the
// caffe ceil-mode 3x3/2 stem maxpool fused, hand-written for Hopper
// (sm_90a) on the tensor cores.
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
//   weights (64, 208) bf16, K-major: K = tap * 4 + c with tap = dr * 7 + dc
//           (49 taps padded to 52) and c < 3 (the fourth channel and the
//           three padding taps are zero). ops/conv1.py::prepare_conv1 makes
//           it once per set of weights.
//   math    bf16 x bf16 products (exact in f32) summed in f32; epilogue in
//           f32 without FMA contraction, as the plain version computes it:
//             mode 0 (B3): max(y * mul + add, 0)
//             mode 1 (B5): max(y + add, 0)       (weights = bf16(w * mul))
//           then rounded to bf16; written NHWC (B, Ho, Wo, 64), or with
//   pool    the caffe ceil-mode 3x3/2 maxpool taken in shared memory,
//           (B, Hp, Wp, 64) with Hp = (Ho - 2) / 2 + 1. Post-ReLU values are
//           >= 0, so a window clipped at (Ho, Wo) equals the reference's
//           -inf ceil padding and the TPU kernel's zero padding: exact.
//
// What bounds it on an H100 (4 frames, 600x960, planes in, stem out):
// 2 * 4 * 300 * 480 * 64 * 147 = 10.84 GFLOP (11.0 us at 989 TFLOP/s bf16)
// against 34.2 MB of planes in and pooled output (10.2 us at 3.35 TB/s):
// as much bytes as operations, so the products run on the tensor cores
// (mma.sync m16n8k16; N = 64 is too narrow for wgmma to pay) and the
// unpooled 73.7 MB map never leaves the SM.
//
// Design: an implicit GEMM, M = output pixels, N = 64, K = 52 taps x 4
// channels = 13 chunks of 16. Persistent blocks of 12 warps, one per SM,
// walk tiles of 8 x 16 pooled outputs (the 17 x 33 conv outputs they read,
// a one-row and one-column halo recomputed: 561 GEMM rows padded to 576 =
// 12 warps x 3 m16 tiles) or, unpooled, 16 x 32 conv outputs. A block
// stages the 26.6 KB of weights once; per tile it stages the 20 x 40 plane
// window that the tile reads with cp.async (16-byte copies of the planes, or
// 4-byte copies of the f32 image pixels) while the tile before computes,
// then lays it out channel-interleaved, (c0, c1, c2, 0) bf16 per plane
// pixel, so that each A register (two consecutive K) is one aligned 4-byte
// shared load; the B registers come from ldmatrix.x4 of the K-major
// weights, whose rows are padded so that the eight rows a load reads hit 32
// banks. The epilogue writes the bf16 conv tile to shared memory, where the
// pool reads it; the output leaves as 16-byte stores. What bounds it now is
// less the MMA than the block's phases in turn (interleave, MMA, epilogue,
// pool), one block an SM.
//
// Accumulation: the products accumulate in the MMA. Over K = 147 the
// tensor cores' own f32 accumulation keeps the bf16 outputs within the
// contract (chip_smoke.py, phases 3b and 7, prints the bit-equal share);
// a fresh fragment per 16-deep product added with round-to-nearest adds
// (csrc/bottleneck.cu's rule) was no closer to the plain version, and
// slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;
constexpr int kMTiles = 3;                     // m16 tiles per warp
constexpr int kRows = kWarps * kMTiles * 16;   // 576 GEMM rows per tile
constexpr int kCout = 64;
constexpr int kNTiles = kCout / 8;
constexpr int kTaps = 52;                      // 49 taps padded to 13 x 4
constexpr int kK = kTaps * 4;                  // 208
constexpr int kChunks = kK / 16;               // 13
constexpr int kWLd = kK + 8;                   // weight row stride (bf16)
constexpr int kWinY = 20;                      // plane rows a tile reads
constexpr int kWinX = 40;                      // plane cols (5 x 8)
constexpr int kWinC8 = kWinX / 8;              // 16-byte chunks a row
constexpr int kPlaneWords = kWinY * kWinX * 2 + 16;  // = 16 mod 32 banks
static_assert(kWinY * kWinX * 2 % 32 == 0, "the plane padding");
constexpr int kOutLd = 72;                     // staged pixel stride (bf16)
constexpr int kPoolTY = 8, kPoolTX = 16;       // pooled outputs per tile
constexpr int kConvTY = 2 * kPoolTY;           // conv tile origin stride
constexpr int kConvTX = 2 * kPoolTX;
// a pooled tile's conv rows (a one-row, one-column halo) fit the GEMM rows
// and its plane window (taps reach 3 rows and columns on) the staged one;
// the window starts on 16-byte chunks
static_assert((2 * kPoolTY + 1) * (2 * kPoolTX + 1) <= kRows, "GEMM rows");
static_assert(2 * kPoolTY + 4 <= kWinY && 2 * kPoolTX + 4 <= kWinX,
              "the plane window");
static_assert(kConvTX % 8 == 0 && kWinX % 8 == 0, "16-byte chunks");

constexpr int kWBytes = kCout * kWLd * 2;
constexpr int kWinBytes = 4 * kPlaneWords * 4;
constexpr int kOutBytes = kRows * kOutLd * 2;
constexpr int kAffBytes = 2 * kCout * 4;
constexpr int kRawPlanes = 12 * kWinY * kWinX * 2;        // bf16 rows
constexpr int kRawImages = 2 * kWinY * 2 * kWinX * 3 * 4;  // f32 pixels
constexpr int smem_bytes(int src) {
  return kWBytes + kWinBytes + kOutBytes + kAffBytes +
         (src == 0 ? kRawPlanes : kRawImages);
}

struct Args {
  const void* src;
  const bf16* w;
  const float* mul;
  const float* add;
  bf16* out;
  int mode, B, H, W, Hq, Wq, Ho, Wo, Hp, Wp, tiles_y, tiles_x;
};

// word offset in the interleaved window of tap (dr, dc): its parity plane
// and its (dr / 2, dc / 2) shift. The padding taps read tap 0 (their
// weights are zero, and the window holds finite values only).
__device__ __forceinline__ constexpr int tap_words(int tap) {
  return tap >= 49 ? 0
                   : (((tap / 7) % 2) * 2 + (tap % 7) % 2) * kPlaneWords +
                         ((tap / 7 / 2) * kWinX + (tap % 7) / 2) * 2;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ uint32_t half_of(const uint4& u, int e) {
  const uint32_t w = e < 2 ? u.x : e < 4 ? u.y : e < 6 ? u.z : u.w;
  return (e & 1) ? (w >> 16) : (w & 0xffffu);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Issue the copies of one tile's window into the raw staging buffer.
template <int kSrc>
__device__ __forceinline__ void stage_window(const Args& a, unsigned char* raw,
                                             int b, int cy0, int cx0) {
  if (kSrc == 0) {
    const bf16* planes = static_cast<const bf16*>(a.src);
    bf16* dst = reinterpret_cast<bf16*>(raw);
    for (int i = threadIdx.x; i < 12 * kWinY * kWinC8; i += kThreads) {
      const int pc = i / (kWinY * kWinC8);
      const int r = (i / kWinC8) % kWinY;
      const int c8 = i % kWinC8;
      const int yq = cy0 + r, xq = cx0 + 8 * c8;
      const bool valid = yq < a.Hq && xq < a.Wq;
      const bf16* src =
          valid ? planes + ((static_cast<size_t>(b) * 12 + pc) * a.Hq + yq) *
                               a.Wq + xq
                : planes;
      cp_async16(dst + (pc * kWinY + r) * kWinX + 8 * c8, src, valid);
    }
  } else {
    const float* img = static_cast<const float*>(a.src);
    float* dst = reinterpret_cast<float*>(raw);
    const int y0 = 2 * cy0 - 3, x0 = 2 * cx0 - 3;
    for (int i = threadIdx.x; i < 2 * kWinY * 2 * kWinX * 3; i += kThreads) {
      const int r = i / (2 * kWinX * 3);
      const int q3 = i - r * (2 * kWinX * 3);
      const int y = y0 + r, x = x0 + q3 / 3;
      const bool valid = y >= 0 && y < a.H && x >= 0 && x < a.W;
      const float* src =
          valid ? img + (static_cast<size_t>(b * a.H + y) * a.W + x) * 3 +
                      q3 % 3
                : img;
      cp_async4(dst + i, src, valid);
    }
  }
}

// Lay the staged window out channel-interleaved: per plane pixel the words
// (c0 | c1 << 16, c2) of bf16 values.
template <int kSrc>
__device__ __forceinline__ void interleave_window(const unsigned char* raw,
                                                  uint32_t* win) {
  if (kSrc == 0) {
    const bf16* src = reinterpret_cast<const bf16*>(raw);
    for (int i = threadIdx.x; i < 4 * kWinY * kWinC8; i += kThreads) {
      const int pl = i / (kWinY * kWinC8);
      const int r = (i / kWinC8) % kWinY;
      const int c8 = i % kWinC8;
      uint4 ch[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        ch[c] = *reinterpret_cast<const uint4*>(
            src + ((pl * 3 + c) * kWinY + r) * kWinX + 8 * c8);
      uint2* dst = reinterpret_cast<uint2*>(
          win + pl * kPlaneWords + (r * kWinX + 8 * c8) * 2);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = make_uint2(half_of(ch[0], e) | (half_of(ch[1], e) << 16),
                            half_of(ch[2], e));
    }
  } else {
    const float* src = reinterpret_cast<const float*>(raw);
    for (int i = threadIdx.x; i < 2 * kWinY * 2 * kWinX; i += kThreads) {
      const int r = i / (2 * kWinX);
      const int q = i - r * (2 * kWinX);
      const float* px = src + i * 3;
      const int pl = (r & 1) * 2 + (q & 1);
      *reinterpret_cast<uint2*>(
          win + pl * kPlaneWords + ((r >> 1) * kWinX + (q >> 1)) * 2) =
          make_uint2(pack_bf16(px[0], px[1]), pack_bf16(px[2], 0.0f));
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(row))));
}

// D += A B on the tensor cores, m16n8k16, bf16 in, f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kSrc, bool kPool>
__global__ void __launch_bounds__(kThreads, 1) conv1_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  uint32_t* win = reinterpret_cast<uint32_t*>(smem + kWBytes);
  bf16* out_s = reinterpret_cast<bf16*>(smem + kWBytes + kWinBytes);
  float* aff = reinterpret_cast<float*>(smem + kWBytes + kWinBytes + kOutBytes);
  unsigned char* raw = smem + kWBytes + kWinBytes + kOutBytes + kAffBytes;

  constexpr int kCTY = kPool ? 2 * kPoolTY + 1 : kConvTY;  // conv tile rows
  constexpr int kCTX = kPool ? 2 * kPoolTX + 1 : kConvTX;  // conv tile cols
  constexpr int kValid = kCTY * kCTX;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int per_image = a.tiles_y * a.tiles_x;
  const int n_tiles = a.B * per_image;
  int tile = blockIdx.x;
  if (tile >= n_tiles) return;

  for (int i = tid; i < kCout * (kK / 8); i += kThreads) {
    const int n = i / (kK / 8), c = i - n * (kK / 8);
    *reinterpret_cast<uint4*>(w_s + n * kWLd + c * 8) =
        reinterpret_cast<const uint4*>(a.w)[i];
  }
  if (tid < kCout) {
    aff[tid] = a.mode == 0 ? a.mul[tid] : 1.0f;
    aff[kCout + tid] = a.add[tid];
  }

  // the window word of this thread's A rows (g and g + 8 of each m16
  // tile) at tap (0, 0), channel pair t & 1; rows past the tile read pixel 0
  int base[kMTiles][2];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int p = (warp * kMTiles + mt) * 16 + g + 8 * h;
      if (p >= kValid) p = 0;
      base[mt][h] = ((p / kCTX) * kWinX + p % kCTX) * 2 + (t & 1);
    }

  const bf16* w_row =
      w_s + ((lane / 16) * 8 + lane % 8) * kWLd + 8 * ((lane / 8) % 2);

  auto origin = [&](int tl, int& b, int& cy0, int& cx0) {
    b = tl / per_image;
    const int rem = tl - b * per_image;
    const int ty = rem / a.tiles_x;
    cy0 = ty * kConvTY;
    cx0 = (rem - ty * a.tiles_x) * kConvTX;
  };

  int b, cy0, cx0;
  origin(tile, b, cy0, cx0);
  stage_window<kSrc>(a, raw, b, cy0, cx0);
  cp_async_wait_all();
  __syncthreads();
  interleave_window<kSrc>(raw, win);
  __syncthreads();

  for (; tile < n_tiles; tile += gridDim.x) {
    origin(tile, b, cy0, cx0);
    const int next = tile + gridDim.x;
    if (next < n_tiles) {          // lands while this tile computes
      int nb, ny, nx;
      origin(next, nb, ny, nx);
      stage_window<kSrc>(a, raw, nb, ny, nx);
    }

    float acc[kMTiles][kNTiles][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

    // not unrolled: unrolling the 13 chunks lets the compiler hoist loads
    // until the 168 registers spill (~0.5 KB a thread, 1.1-1.6x slower)
#pragma unroll 1
    for (int ch = 0; ch < kChunks; ++ch) {
      // K 2t, 2t + 1 of the chunk: tap 4 ch + t / 2; K + 8: two taps on
      const int off_lo = (t >> 1) ? tap_words(4 * ch + 1) : tap_words(4 * ch);
      const int off_hi =
          (t >> 1) ? tap_words(4 * ch + 3) : tap_words(4 * ch + 2);
      // B: ldmatrix.x4 of the K-major rows, two n8 tiles (k 0-7, 8-15
      // each) a load; lane l addresses row (l / 16) * 8 + l % 8 of the
      // pair, k offset 8 ((l / 8) % 2)
      uint32_t bw[kNTiles][2];
#pragma unroll
      for (int nt = 0; nt < kNTiles; nt += 2)
        ldmatrix_x4(bw[nt][0], bw[nt][1], bw[nt + 1][0], bw[nt + 1][1],
                    w_row + nt * 8 * kWLd + ch * 16);
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        const uint32_t af[4] = {win[base[mt][0] + off_lo],
                                win[base[mt][1] + off_lo],
                                win[base[mt][0] + off_hi],
                                win[base[mt][1] + off_hi]};
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
          mma(acc[mt][nt], af, bw[nt][0], bw[nt][1]);
      }
    }

    // epilogue into the staged conv tile: rows g (e 0, 1) and g + 8
    // (e 2, 3), channels nt * 8 + 2t, + 1
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (warp * kMTiles + mt) * 16 + g + 8 * h;
        if (p >= kValid) continue;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int n = nt * 8 + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // no FMA contraction: the plain version multiplies, then adds
            const float y = acc[mt][nt][2 * h + e];
            const float z = a.mode == 0
                                ? __fadd_rn(__fmul_rn(y, aff[n + e]),
                                            aff[kCout + n + e])
                                : __fadd_rn(y, aff[kCout + n + e]);
            v[e] = z > 0.0f ? z : 0.0f;
          }
          *reinterpret_cast<uint32_t*>(out_s + p * kOutLd + n) =
              pack_bf16(v[0], v[1]);
        }
      }
    cp_async_wait_all();
    __syncthreads();

    if (kPool) {
      const int py0 = cy0 / 2, px0 = cx0 / 2;
      for (int i = tid; i < kPoolTY * kPoolTX * 8; i += kThreads) {
        const int q = i & 7;
        const int px = (i >> 3) % kPoolTX;
        const int py = (i >> 3) / kPoolTX;
        const int gy = py0 + py, gx = px0 + px;
        if (gy >= a.Hp || gx >= a.Wp) continue;
        const int rows = min(3, a.Ho - 2 * gy);
        const int cols = min(3, a.Wo - 2 * gx);
        const bf16* s = out_s + ((2 * py) * kCTX + 2 * px) * kOutLd + q * 8;
        uint4 m = *reinterpret_cast<const uint4*>(s);
        __nv_bfloat162* mv = reinterpret_cast<__nv_bfloat162*>(&m);
        for (int r = 0; r < rows; ++r)
          for (int c = 0; c < cols; ++c) {
            uint4 u = *reinterpret_cast<const uint4*>(
                s + (r * kCTX + c) * kOutLd);
            const __nv_bfloat162* uv =
                reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
            for (int e = 0; e < 4; ++e) mv[e] = __hmax2(mv[e], uv[e]);
          }
        *reinterpret_cast<uint4*>(
            a.out + ((static_cast<size_t>(b) * a.Hp + gy) * a.Wp + gx) *
                        kCout + q * 8) = m;
      }
    } else {
      for (int i = tid; i < kConvTY * kConvTX * 8; i += kThreads) {
        const int q = i & 7;
        const int x = (i >> 3) % kConvTX;
        const int y = (i >> 3) / kConvTX;
        if (cy0 + y >= a.Ho || cx0 + x >= a.Wo) continue;
        *reinterpret_cast<uint4*>(
            a.out +
            ((static_cast<size_t>(b) * a.Ho + cy0 + y) * a.Wo + cx0 + x) *
                kCout + q * 8) =
            *reinterpret_cast<const uint4*>(out_s + (y * kCTX + x) * kOutLd +
                                            q * 8);
      }
    }
    if (next < n_tiles) interleave_window<kSrc>(raw, win);
    __syncthreads();
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kSrc, bool kPool>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const int bytes = smem_bytes(kSrc);
  cudaError_t err = cudaFuncSetAttribute(
      conv1_kernel<kSrc, kPool>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = a.B * a.tiles_y * a.tiles_x;
  conv1_kernel<kSrc, kPool><<<tiles < sms ? tiles : sms, kThreads, bytes, s>>>(
      a);
  return cudaGetLastError();
}

}  // namespace

// src_kind: 0 = parity planes (B, 2, 2, 3, Hq, Wq) bf16, 1 = images
// (B, H, W, 3) f32. mode: 0 = y * mul + add, 1 = y + add (mul unused).
// pool: 0 = (B, Ho, Wo, 64) out, 1 = the stem's pooled (B, Hp, Wp, 64).
// (H, W) is the source image size in both forms; w the (64, 208) K-major
// weights. One launch. Returns the cudaError_t of the launch (0 =
// cudaSuccess); the caller raises on anything else.
extern "C" int i2vsgg_conv1_forward(const void* src, const void* w,
                                    const void* mul, const void* add,
                                    void* out, int src_kind, int mode,
                                    int pool, int B, int H, int W, int Hq,
                                    int Wq, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if ((src_kind != 0 && src_kind != 1) || (mode != 0 && mode != 1) ||
      (pool != 0 && pool != 1) || !aligned16(w) || !aligned16(out) ||
      (src_kind == 0 && (Hq <= 0 || Wq <= 0 || Wq % 8 || !aligned16(src))) ||
      (pool && (H < 3 || W < 3)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{src, static_cast<const bf16*>(w), static_cast<const float*>(mul),
         static_cast<const float*>(add), static_cast<bf16*>(out), mode, B,
         H, W, Hq, Wq, 0, 0, 0, 0, 0, 0};
  a.Ho = (H - 1) / 2 + 1;
  a.Wo = (W - 1) / 2 + 1;
  a.Hp = (a.Ho - 2) / 2 + 1;
  a.Wp = (a.Wo - 2) / 2 + 1;
  a.tiles_y = pool ? (a.Hp + kPoolTY - 1) / kPoolTY
                   : (a.Ho + kConvTY - 1) / kConvTY;
  a.tiles_x = pool ? (a.Wp + kPoolTX - 1) / kPoolTX
                   : (a.Wo + kConvTX - 1) / kConvTX;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (src_kind == 0)
    err = pool ? launch<0, true>(a, s) : launch<0, false>(a, s);
  else
    err = pool ? launch<1, true>(a, s) : launch<1, false>(a, s);
  return static_cast<int>(err);
}

// The dynamic shared memory the kernel takes for a source form (bytes).
extern "C" int i2vsgg_conv1_smem_bytes(int src_kind) {
  return smem_bytes(src_kind);
}
