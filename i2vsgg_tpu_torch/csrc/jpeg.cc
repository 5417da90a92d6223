// JPEG decoder of the port, bit-equal to libjpeg-turbo's default decode as
// cv2.imread(path, cv2.IMREAD_COLOR) runs it: Huffman entropy decoding
// (jdhuff.c, and jdphuff.c for progressive files), arithmetic decoding
// (jdarith.c), the integer "islow" IDCT (jidctint.c), "fancy" chroma
// upsampling (jdsample.c, with jdmainct.c's edge rows), the fixed-point
// YCbCr to BGR conversion (jdcolor.c), OpenCV's CMYK to BGR conversion, and
// lossless decoding (jdlhuff.c, jdlossls.c). Host-only C++17 with a plain C
// API, loaded with ctypes by i2vsgg_tpu_torch/data/jpeg.py:
//
//   int i2v_jpeg_info(data, n, &h, &w, &ncomp, err, errlen)
//   int i2v_jpeg_decode(data, n, out, capacity, err, errlen)
//
// Each returns 0, or an error code with a message in err: 1 a mode this
// decoder does not read (hierarchical, lossless arithmetic, 12-bit samples,
// lossless JPEG that cv2 refuses), 2 a corrupt or truncated file, 3 a bad
// argument. `out` receives BGR uint8 (h, w, 3). The decoder keeps no state
// between calls, never longjmps and bounds-checks every read of the input.
// Where libjpeg-turbo warns and fills a corrupt stream with grey, or warns
// of a bogus progression and decodes on, this decoder refuses the file.
//
// Read: DCT JPEG with 8-bit samples, Huffman-coded or arithmetic-coded,
// sequential (SOF0, SOF1, SOF9) or progressive (SOF2, SOF10); one component
// (grey, replicated to B, G and R), three (YCbCr, or RGB where an Adobe
// APP14 transform of 0 or the component ids 'R', 'G', 'B' say so, as
// jdapimin.c decides) or four (CMYK, or YCCK where an Adobe transform other
// than 0 says so, converted to CMYK by jdcolor.c's ycck_cmyk_convert, then
// to BGR as OpenCV's icvCvt_CMYK2BGR_8u_C4C3R does); any integral sampling
// (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...); DRI/RSTn restart intervals; 8-
// and 16-bit quantization tables; scans without DHT take the standard
// tables of Annex K (jstdhuff.c); DAC conditioning (L, U and Kx) for the
// arithmetic coder, statistics reset at each scan and restart. A sequential
// file whose one scan holds every component is decoded block by block into
// the planes. Every other file (progressive, or colour components in
// separate scans) goes through a whole-image buffer of coefficients, as
// jdcoefct.c keeps it, filled scan by scan to EOI and transformed once at
// the end; where a progressive scan script stops short, the coefficients it
// left unknown are estimated by libjpeg-turbo 3.1's block smoothing
// (jdcoefct.c's decompress_smooth_data). Lossless JPEG (SOF3) as cv2 reads
// it: 8-bit samples, three components of 1x1 sampling in one interleaved
// scan or in several, predictors 1-7, a point transform, restart intervals
// of whole rows; the samples come out as stored, the third component in B
// and the first in R, with no colour conversion.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

enum Code { kOk = 0, kUnsupported = 1, kCorrupt = 2, kArgument = 3 };

struct Failure {
  int code;
  std::string what;
};

[[noreturn]] void fail(int code, const std::string& what) {
  throw Failure{code, what};
}

[[noreturn]] void corrupt(const std::string& what) { fail(kCorrupt, what); }

// zigzag position -> natural (row-major) position
const int kNaturalOrder[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K's tables (jstdhuff.c): counts of codes of length 1-16, symbols
const uint8_t kBitsDcLum[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kBitsDcChr[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kValDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kBitsAcLum[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kValAcLum[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kBitsAcChr[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kValAcChr[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jaricom.c's jpeg_aritab, T.81's Table D.2: each state's Qe, its next
// state after an LPS and after an MPS, and whether an LPS switches the MPS;
// packed as jdarith.c reads them: (Qe << 16) | (next MPS << 8) | (switch
// << 7) | next LPS. The last state is the fixed probability 0.5 of sign and
// refinement bits.
constexpr int32_t V(int qe, int nl, int nm, int sw) {
  return (qe << 16) | (nm << 8) | (sw << 7) | nl;
}
const int32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1), V(0x2586, 14, 2, 0), V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0), V(0x03d8, 20, 5, 0), V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0), V(0x006f, 28, 8, 0), V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0), V(0x000d, 35, 11, 0), V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0), V(0x0001, 12, 13, 0), V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0), V(0x2cf2, 38, 17, 0), V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0), V(0x1182, 42, 20, 0), V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0), V(0x072f, 46, 23, 0), V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0), V(0x0303, 51, 26, 0), V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0), V(0x0144, 56, 29, 0), V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0), V(0x008a, 60, 32, 0), V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0), V(0x003b, 32, 35, 0), V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1), V(0x484c, 64, 38, 0), V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0), V(0x261f, 68, 41, 0), V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0), V(0x1518, 72, 44, 0), V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0), V(0x0bfb, 75, 47, 0), V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0), V(0x0706, 79, 50, 0), V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0), V(0x040f, 50, 53, 0), V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0), V(0x025c, 53, 56, 0), V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0), V(0x0160, 56, 59, 0), V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0), V(0x00cb, 59, 62, 0), V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0), V(0x5b12, 65, 65, 1), V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0), V(0x37d8, 82, 68, 0), V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0), V(0x2379, 86, 71, 0), V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0), V(0x174e, 72, 74, 0), V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0), V(0x0f6b, 74, 77, 0), V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0), V(0x0a40, 77, 48, 0), V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0), V(0x438e, 89, 83, 0), V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0), V(0x2eae, 92, 86, 0), V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0), V(0x5570, 88, 89, 1), V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0), V(0x3e22, 97, 92, 0), V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0), V(0x2e17, 93, 86, 0), V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0), V(0x47e5, 102, 98, 0), V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0), V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0),
};
constexpr int kFixedBin = 113;

constexpr int kMaxDimension = 65500;          // JPEG_MAX_DIMENSION
constexpr int kMaxBlocksInMcu = 10;           // D_MAX_BLOCKS_IN_MCU
constexpr int kLookBits = 9;                  // Huffman lookahead
constexpr int kMaxScans = 1000;               // scans of one image
constexpr int kArithTables = 16;              // NUM_ARITH_TBLS
constexpr int kMaxComponents = 4;

struct HuffTable {
  bool defined = false;
  uint8_t bits[16] = {};                      // codes of each length 1-16
  uint8_t vals[256] = {};
};

// jdhuff.c's derived table, plus a lookahead table for short codes
struct Decoder {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];              // (length << 8) | symbol, 0 if longer
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;                         // downsampled width, height
  int bw = 0, bh = 0;                         // blocks of a non-interleaved scan
  int stride = 0, rows = 0;                   // plane size, MCU-padded
  int16_t qt[64] = {};                        // natural order, as libjpeg's short
  bool latched = false;                       // qt taken at its first scan
  // jdphuff.c's coef_bits: for each coefficient, by zigzag index, the Al
  // of the last progressive scan that coded it, -1 before any
  int bits[64];
  std::vector<uint8_t> plane;
  // a multi-scan file's coefficients: (rows / 8) x (stride / 8) blocks of
  // 64 in natural order, the MCU-padded whole image (jdcoefct.c)
  std::vector<int16_t> coef;
  // a lossless file's samples as undifferenced, (dh, dw), modulo 2^16
  std::vector<uint16_t> samples;
  int16_t* block(int bx, int by) {
    return coef.data() + (static_cast<size_t>(by) * (stride / 8) + bx) * 64;
  }
  Component() { std::fill(bits, bits + 64, -1); }
};

struct Image {
  int width = 0, height = 0, precision = 0;
  int ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;                     // MCUs of an interleaved scan
  Component comp[kMaxComponents];
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  bool rgb = false;                           // three components, not YCbCr
  bool ycck = false;                          // four components, not CMYK
  bool progressive = false;                   // SOF2, SOF10
  bool arith = false;                         // SOF9, SOF10
  bool lossless = false;                      // SOF3
};

struct State {
  State(const uint8_t* data, size_t size) : d(data), n(size) {
    std::fill(dac_l, dac_l + kArithTables, 0);
    std::fill(dac_u, dac_u + kArithTables, 1);
    std::fill(dac_k, dac_k + kArithTables, 5);
  }
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  // DAC conditioning of each arithmetic table (jdapimin.c's defaults)
  uint8_t dac_l[kArithTables], dac_u[kArithTables], dac_k[kArithTables];
  int restart_interval = 0;
  Image im;
  bool frame = false;
};

int be16(const State& s, size_t at) {
  if (at + 2 > s.n) corrupt("truncated marker segment");
  return (s.d[at] << 8) | s.d[at + 1];
}

// ----------------------------------------------------------------------------
// markers

// the next marker at or after pos, as jdmarker.c's next_marker: garbage
// bytes and FF/00 pairs skipped, FF fill bytes swallowed; pos moves past
// it. Returns -1 at the end of the data.
int next_marker(const uint8_t* d, size_t n, size_t* pos) {
  size_t p = *pos;
  for (;;) {
    while (p < n && d[p] != 0xFF) p++;
    while (p < n && d[p] == 0xFF) p++;
    if (p >= n) {
      *pos = n;
      return -1;
    }
    int m = d[p++];
    if (m != 0) {
      *pos = p;
      return m;
    }
  }
}

int next_marker(State& s) { return next_marker(s.d, s.n, &s.pos); }

// a segment's payload [start, end); s.pos moves past it
void segment(State& s, size_t* start, size_t* end) {
  int len = be16(s, s.pos);
  if (len < 2) corrupt("marker segment shorter than its length field");
  if (s.pos + len > s.n) corrupt("truncated marker segment");
  *start = s.pos + 2;
  *end = s.pos + len;
  s.pos += len;
}

void read_dqt(State& s) {
  size_t p, end;
  segment(s, &p, &end);
  while (p < end) {
    int pq = s.d[p] >> 4, tq = s.d[p] & 15;
    p++;
    if (tq >= 4) corrupt("quantization table index " + std::to_string(tq));
    if (pq > 1) corrupt("quantization table precision " + std::to_string(pq));
    size_t need = pq ? 128 : 64;
    if (p + need > end) corrupt("truncated quantization table");
    for (int i = 0; i < 64; i++) {
      int v = pq ? (s.d[p + 2 * i] << 8) | s.d[p + 2 * i + 1] : s.d[p + i];
      s.qt[tq][kNaturalOrder[i]] = static_cast<uint16_t>(v);
    }
    s.qt_defined[tq] = true;
    p += need;
  }
}

void read_dht(State& s) {
  size_t p, end;
  segment(s, &p, &end);
  while (p < end) {
    if (p + 17 > end) corrupt("truncated Huffman table");
    int tc = s.d[p] >> 4, th = s.d[p] & 15;
    if (tc > 1 || th >= 4)
      corrupt("Huffman table class/index " + std::to_string(s.d[p]));
    HuffTable& t = tc ? s.ac[th] : s.dc[th];
    int count = 0;
    for (int i = 0; i < 16; i++) {
      t.bits[i] = s.d[p + 1 + i];
      count += t.bits[i];
    }
    p += 17;
    if (count > 256 || p + count > end) corrupt("bad Huffman table");
    std::memset(t.vals, 0, sizeof(t.vals));
    std::memcpy(t.vals, s.d + p, count);
    t.defined = true;
    p += count;
  }
}

// DAC, as jdmarker.c's get_dac reads it: (Tc << 4 | Tb, value) pairs
void read_dac(State& s) {
  size_t p, end;
  segment(s, &p, &end);
  if ((end - p) % 2) corrupt("DAC segment of an odd length");
  for (; p < end; p += 2) {
    int index = s.d[p], v = s.d[p + 1];
    if (index >= 2 * kArithTables)
      corrupt("arithmetic conditioning table index " + std::to_string(index));
    if (index >= kArithTables) {
      s.dac_k[index - kArithTables] = static_cast<uint8_t>(v);
    } else {
      s.dac_l[index] = static_cast<uint8_t>(v & 15);
      s.dac_u[index] = static_cast<uint8_t>(v >> 4);
      if (s.dac_l[index] > s.dac_u[index])
        corrupt("arithmetic DC conditioning with L above U");
    }
  }
}

void read_dri(State& s) {
  size_t p, end;
  segment(s, &p, &end);
  if (end - p != 2) corrupt("DRI segment of the wrong length");
  s.restart_interval = (s.d[p] << 8) | s.d[p + 1];
}

// APP0 (JFIF) and APP14 (Adobe), as jdmarker.c's examine_app0/app14 read
// them: the first 14 bytes at most
void read_app(State& s, int marker) {
  size_t p, end;
  segment(s, &p, &end);
  size_t len = end - p;
  const uint8_t* b = s.d + p;
  if (marker == 0xE0 && len >= 14 && b[0] == 'J' && b[1] == 'F' &&
      b[2] == 'I' && b[3] == 'F' && b[4] == 0)
    s.im.jfif = true;
  if (marker == 0xEE && len >= 12 && b[0] == 'A' && b[1] == 'd' &&
      b[2] == 'o' && b[3] == 'b' && b[4] == 'e') {
    s.im.adobe = true;
    s.im.adobe_transform = b[11];
  }
}

int div_up(long a, long b) { return static_cast<int>((a + b - 1) / b); }

void read_sof(State& s, int marker) {
  if (s.frame) corrupt("more than one start-of-frame marker");
  size_t p, end;
  segment(s, &p, &end);
  if (end - p < 6) corrupt("truncated start-of-frame segment");
  Image& im = s.im;
  im.precision = s.d[p];
  im.height = (s.d[p + 1] << 8) | s.d[p + 2];
  im.width = (s.d[p + 3] << 8) | s.d[p + 4];
  im.ncomp = s.d[p + 5];
  const std::string sof = "(SOF" + std::to_string(marker - 0xC0) + ")";
  if (marker == 0xC5 || marker == 0xC6 || marker == 0xC7 || marker >= 0xCD)
    fail(kUnsupported, "hierarchical (differential) JPEG " + sof +
                           "; libjpeg-turbo reads no hierarchical file");
  if (marker == 0xCB)
    fail(kUnsupported, "lossless arithmetic-coded JPEG " + sof +
                           "; libjpeg-turbo reads lossless JPEG with "
                           "Huffman coding only");
  im.progressive = marker == 0xC2 || marker == 0xCA;
  im.arith = marker >= 0xC8;
  im.lossless = marker == 0xC3;
  if (im.lossless) {
    // what cv2.imread(IMREAD_COLOR) reads of lossless JPEG
    if (im.precision != 8)
      fail(kUnsupported, std::to_string(im.precision) + "-bit lossless JPEG " +
                             sof + "; cv2 reads 8-bit lossless JPEG only");
    if (im.ncomp == 1)
      fail(kUnsupported, "one-component (grey) lossless JPEG " + sof +
                             "; cv2 refuses it under IMREAD_COLOR");
    if (im.ncomp != 3)
      fail(kUnsupported, std::to_string(im.ncomp) + "-component lossless "
                         "JPEG " + sof + "; the decoder reads three "
                         "components");
  } else {
    if (im.precision != 8)
      fail(kUnsupported, std::to_string(im.precision) +
                             "-bit samples; the decoder reads 8-bit JPEG "
                             "only");
    if (im.ncomp != 1 && im.ncomp != 3 && im.ncomp != 4)
      fail(kUnsupported, std::to_string(im.ncomp) + " components; the "
                         "decoder reads one, three or four");
  }
  if (end - p != static_cast<size_t>(6 + 3 * im.ncomp))
    corrupt("start-of-frame segment of the wrong length");
  if (im.width <= 0 || im.height <= 0)
    corrupt("empty image (height or width 0)");
  if (im.width > kMaxDimension || im.height > kMaxDimension)
    corrupt("image larger than 65500 pixels a side");
  for (int c = 0; c < im.ncomp; c++) {
    Component& k = im.comp[c];
    const uint8_t* b = s.d + p + 6 + 3 * c;
    k.id = b[0];
    k.h = b[1] >> 4;
    k.v = b[1] & 15;
    k.tq = b[2];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4)
      corrupt("sampling factors out of 1-4");
    if (k.tq >= 4) corrupt("quantization table index out of 0-3");
    for (int o = 0; o < c; o++)
      if (im.comp[o].id == k.id) corrupt("duplicate component id");
    if (k.h > im.hmax) im.hmax = k.h;
    if (k.v > im.vmax) im.vmax = k.v;
  }
  if (im.lossless && (im.hmax > 1 || im.vmax > 1))
    fail(kUnsupported, "subsampled lossless JPEG " + sof + "; the decoder "
                       "reads lossless components of 1x1 sampling only");
  im.mcux = div_up(im.width, 8L * im.hmax);
  im.mcuy = div_up(im.height, 8L * im.vmax);
  for (int c = 0; c < im.ncomp; c++) {
    Component& k = im.comp[c];
    k.dw = div_up(static_cast<long>(im.width) * k.h, im.hmax);
    k.dh = div_up(static_cast<long>(im.height) * k.v, im.vmax);
    k.bw = div_up(static_cast<long>(im.width) * k.h, 8L * im.hmax);
    k.bh = div_up(static_cast<long>(im.height) * k.v, 8L * im.vmax);
    k.stride = im.mcux * k.h * 8;
    k.rows = im.mcuy * k.v * 8;
    // upsampling needs integral ratios (jdsample.c's jinit_upsampler)
    if (im.hmax % k.h || im.vmax % k.v)
      fail(kUnsupported, "fractional sampling ratios (component " +
                             std::to_string(c) + ")");
  }
  s.frame = true;
}

// the colour space, as libjpeg-turbo 3.1's default_decompress_parms decides
// it from the markers before the first scan: three components are YCbCr
// after a JFIF marker, RGB after an Adobe transform of 0 and YCbCr after
// any other, and without either RGB where the ids are 'R', 'G', 'B' or the
// file is lossless; four are YCCK after an Adobe transform other than 0,
// else CMYK. cv2 reads no lossless file in YCbCr.
void colour_space(State& s) {
  Image& im = s.im;
  if (im.ncomp == 3) {
    if (im.jfif) {
      im.rgb = false;
    } else if (im.adobe) {
      im.rgb = im.adobe_transform == 0;
    } else {
      im.rgb = im.lossless || (im.comp[0].id == 'R' && im.comp[1].id == 'G' &&
                               im.comp[2].id == 'B');
    }
    if (im.lossless && !im.rgb)
      fail(kUnsupported, std::string("lossless JPEG in YCbCr (") +
                             (im.jfif ? "a JFIF marker" : "an Adobe transform "
                                        "other than 0") +
                             "); cv2 refuses it under IMREAD_COLOR");
  }
  if (im.ncomp == 4) im.ycck = im.adobe && im.adobe_transform != 0;
}

// ----------------------------------------------------------------------------
// entropy decoding

// max_dc: the largest DC symbol, 15 (a DCT coefficient's category) or 16
// (a lossless difference of 32768); -1 for an AC table, which takes any
void derive(const HuffTable& t, int max_dc, Decoder* out) {
  // jdhuff.c's jpeg_make_d_derived_tbl
  uint8_t size[257];
  uint32_t code_of[256];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = t.bits[l - 1];
    if (p + i > 256) corrupt("bad Huffman table");
    while (i--) size[p++] = static_cast<uint8_t>(l);
  }
  size[p] = 0;
  int nsym = p;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) {
      code_of[p++] = code;
      code++;
    }
    if (code >= (1u << si)) corrupt("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t.bits[l - 1]) {
      out->valoffset[l] = p - static_cast<int32_t>(code_of[p]);
      p += t.bits[l - 1];
      out->maxcode[l] = static_cast<int32_t>(code_of[p - 1]);
    } else {
      out->maxcode[l] = -1;
    }
  }
  out->valoffset[17] = 0;
  out->maxcode[17] = 0xFFFFF;
  std::memcpy(out->vals, t.vals, sizeof(out->vals));
  std::memset(out->look, 0, sizeof(out->look));
  p = 0;
  for (int l = 1; l <= kLookBits; l++) {
    for (int i = 0; i < t.bits[l - 1]; i++, p++) {
      uint32_t lo = code_of[p] << (kLookBits - l);
      for (uint32_t k = 0; k < (1u << (kLookBits - l)); k++)
        out->look[lo + k] = static_cast<uint16_t>((l << 8) | t.vals[p]);
    }
  }
  if (max_dc >= 0)
    for (int i = 0; i < nsym; i++)
      if (t.vals[i] > max_dc)
        corrupt("bad Huffman table (DC symbol above " +
                std::to_string(max_dc) + ")");
}

// Bits of the entropy-coded segment, byte stuffing removed. At a marker or
// the end of the data it feeds zero bits, as libjpeg does, but counts
// them: a read that reaches them is a truncated or corrupt stream.
struct Bits {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t acc = 0;                           // left-aligned
  int count = 0;                              // bits in acc
  int fake = 0;                               // zero bits fed past the data
  bool stopped = false;                       // at a marker or the end

  void fill() {
    while (count <= 56) {
      uint32_t byte = 0;
      if (stopped) {
        fake += 8;
      } else if (pos >= n) {
        stopped = true;
        fake += 8;
      } else if (d[pos] != 0xFF) {
        byte = d[pos++];
      } else {
        size_t q = pos + 1;
        while (q < n && d[q] == 0xFF) q++;    // FF FF ... 00 is one FF byte
        if (q < n && d[q] == 0) {
          byte = 0xFF;
          pos = q + 1;
        } else {
          stopped = true;                     // a marker: pos stays on it
          fake += 8;
        }
      }
      acc |= static_cast<uint64_t>(byte) << (56 - count);
      count += 8;
    }
  }
  void check() const {
    if (count < fake)
      corrupt("entropy-coded data ends before the image does (truncated "
              "or corrupt JPEG)");
  }
  uint32_t peek(int k) {
    if (count < k) fill();
    return static_cast<uint32_t>(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    count -= k;
    check();
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  // start over at a byte boundary at pos (after a restart marker)
  void reset(size_t at) {
    pos = at;
    acc = 0;
    count = fake = 0;
    stopped = false;
  }
};

int decode_symbol(Bits& b, const Decoder& t) {
  uint32_t look = t.look[b.peek(kLookBits)];
  if (look) {
    b.skip(look >> 8);
    return look & 0xFF;
  }
  // longer codes: jdhuff.c's jpeg_huff_decode from length kLookBits + 1
  uint32_t bits16 = b.peek(16);
  int l = kLookBits + 1;
  int32_t code = static_cast<int32_t>(bits16 >> (16 - l));
  while (code > t.maxcode[l]) {
    if (++l > 16) corrupt("bad Huffman code (corrupt JPEG data)");
    code = static_cast<int32_t>(bits16 >> (16 - l));
  }
  b.skip(l);
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

inline int extend(uint32_t r, int s) {
  // HUFF_EXTEND
  return r < (1u << (s - 1)) ? static_cast<int>(r) + ((-1) * (1 << s)) + 1
                             : static_cast<int>(r);
}

// jidctint.c's jpeg_idct_islow, with its range limit (and & RANGE_MASK)
inline uint8_t range_limit(int x) {
  int v = x & 1023;
  if (v < 128) return static_cast<uint8_t>(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return static_cast<uint8_t>(v - 896);
}

void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out,
                int stride) {
  constexpr int kConstBits = 13, kPass1Bits = 2;
  constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                    F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                    F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                    F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
  auto descale = [](int64_t x, int n) {
    return (x + (static_cast<int64_t>(1) << (n - 1))) >> n;
  };
  auto lshift = [](int64_t x, int n) {
    return static_cast<int64_t>(static_cast<uint64_t>(x) << n);
  };
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const int16_t* qp = q + c;
    auto deq = [&](int r) {
      return static_cast<int64_t>(static_cast<int>(in[8 * r]) *
                                  static_cast<int>(qp[8 * r]));
    };
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = static_cast<int>(lshift(deq(0), kPass1Bits));
      for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
      continue;
    }
    int64_t z2 = deq(2), z3 = deq(6);
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = deq(0);
    z3 = deq(4);
    int64_t tmp0 = lshift(z2 + z3, kConstBits);
    int64_t tmp1 = lshift(z2 - z3, kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = deq(7);
    tmp1 = deq(5);
    tmp2 = deq(3);
    tmp3 = deq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int sh = kConstBits - kPass1Bits;
    ws[8 * 0 + c] = static_cast<int>(descale(tmp10 + tmp3, sh));
    ws[8 * 7 + c] = static_cast<int>(descale(tmp10 - tmp3, sh));
    ws[8 * 1 + c] = static_cast<int>(descale(tmp11 + tmp2, sh));
    ws[8 * 6 + c] = static_cast<int>(descale(tmp11 - tmp2, sh));
    ws[8 * 2 + c] = static_cast<int>(descale(tmp12 + tmp1, sh));
    ws[8 * 5 + c] = static_cast<int>(descale(tmp12 - tmp1, sh));
    ws[8 * 3 + c] = static_cast<int>(descale(tmp13 + tmp0, sh));
    ws[8 * 4 + c] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t dc = range_limit(
          static_cast<int>(descale(static_cast<int64_t>(w[0]),
                                   kPass1Bits + 3)));
      for (int c = 0; c < 8; c++) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = lshift(static_cast<int64_t>(w[0]) + w[4], kConstBits);
    int64_t tmp1 = lshift(static_cast<int64_t>(w[0]) - w[4], kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int sh = kConstBits + kPass1Bits + 3;
    o[0] = range_limit(static_cast<int>(descale(tmp10 + tmp3, sh)));
    o[7] = range_limit(static_cast<int>(descale(tmp10 - tmp3, sh)));
    o[1] = range_limit(static_cast<int>(descale(tmp11 + tmp2, sh)));
    o[6] = range_limit(static_cast<int>(descale(tmp11 - tmp2, sh)));
    o[2] = range_limit(static_cast<int>(descale(tmp12 + tmp1, sh)));
    o[5] = range_limit(static_cast<int>(descale(tmp12 - tmp1, sh)));
    o[3] = range_limit(static_cast<int>(descale(tmp13 + tmp0, sh)));
    o[4] = range_limit(static_cast<int>(descale(tmp13 - tmp0, sh)));
  }
}

struct ScanComponent {
  Component* k;
  Decoder dc, ac;
  uint32_t pred = 0;                          // libjpeg's int last_dc_val
  // arithmetic coding: the component's tables, their DAC conditioning, and
  // jdarith.c's dc_context (the DC statistics bin the next block starts at)
  int dc_tbl = 0, ac_tbl = 0, dc_l = 0, dc_u = 1, ac_k = 5;
  int context = 0;
};

// a sequential block's coefficients into coef (natural order); as jdhuff.c,
// only the nonzero ones are written
void decode_sequential(Bits& b, ScanComponent& sc, int16_t* coef) {
  int s = decode_symbol(b, sc.dc);
  int diff = s ? extend(b.get(s), s) : 0;
  sc.pred += static_cast<uint32_t>(diff);
  coef[0] = static_cast<int16_t>(sc.pred);      // (JCOEF)s
  for (int k = 1; k < 64; k++) {
    int rs = decode_symbol(b, sc.ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      if (k > 63) corrupt("AC coefficients run past the block");
      coef[kNaturalOrder[k]] =
          static_cast<int16_t>(extend(b.get(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// one block of a single-scan file: its coefficients decoded, dequantized
// and inverse-transformed into the component's plane at block (bx, by)
void decode_block(Bits& b, ScanComponent& sc, int bx, int by) {
  int16_t coef[64] = {};
  decode_sequential(b, sc, coef);
  Component& c = *sc.k;
  idct_islow(coef, c.qt,
             c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8,
             c.stride);
}

struct Scan {
  int ns = 0;
  ScanComponent sc[kMaxComponents];
  size_t data = 0;                            // first byte of entropy data
  int ss = 0, se = 63, ah = 0, al = 0;        // spectral band, approximation
  uint32_t eobrun = 0;                        // progressive AC: blocks of EOB
  bool arith = false;
  bool need_dc = true, need_ac = true;        // the tables the scan reads
  // arithmetic coding: each table's statistics bins (jdarith.c's dc_stats
  // and ac_stats), zeroed at the scan's start and at each restart, and the
  // bin of fixed probability 0.5
  uint8_t dc_stats[kArithTables][64];
  uint8_t ac_stats[kArithTables][256];
  uint8_t fixed_bin = kFixedBin;
};

// the state a restart interval starts from: DC predictions and the EOB run
// reset (jdhuff.c's process_restart), and for arithmetic coding the
// statistics of the tables the scan reads and the DC contexts (jdarith.c's)
void reset_statistics(Scan& scan) {
  scan.eobrun = 0;
  for (int i = 0; i < scan.ns; i++) {
    ScanComponent& sc = scan.sc[i];
    sc.pred = 0;
    sc.context = 0;
    if (!scan.arith) continue;
    if (scan.need_dc) std::memset(scan.dc_stats[sc.dc_tbl], 0, 64);
    if (scan.need_ac) std::memset(scan.ac_stats[sc.ac_tbl], 0, 256);
  }
}

// ----------------------------------------------------------------------------
// arithmetic decoding (jdarith.c)

// the QM-coder over the entropy-coded segment: jdarith.c's C and A
// registers and bit counter, bytes read as arith_decode needs them, FF 00
// unstuffed. At a marker it reads zero bytes, as T.81 has the decoder do
// (the encoder drops the zero bytes that end its flush); where the data
// ends first, libjpeg warns of a premature end, and this decoder refuses.
struct Arith {
  const uint8_t* d;
  size_t n;
  size_t pos;
  int64_t c = 0;                              // base of the interval + bits
  int64_t a = 0;                              // size of the interval
  int ct = -16;                               // bits left in c; -16: start
  bool stopped = false;                       // at a marker: zeros from here

  int byte() {
    if (stopped) return 0;
    if (pos >= n)
      corrupt("arithmetic-coded data ends before the image does "
              "(truncated JPEG)");
    if (d[pos] != 0xFF) return d[pos++];
    size_t q = pos + 1;
    while (q < n && d[q] == 0xFF) q++;        // FF FF ... 00 is one FF byte
    if (q >= n)
      corrupt("arithmetic-coded data ends before the image does "
              "(truncated JPEG)");
    if (d[q] == 0) {
      pos = q + 1;
      return 0xFF;
    }
    stopped = true;                           // pos stays on the marker
    return 0;
  }

  // one binary decision with the statistics bin st: jdarith.c's
  // arith_decode (renormalization per T.81 D.2.6, then D.2.4 and D.2.5)
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;   // the 2 first bytes
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const uint8_t nl = qe & 0xFF;
    qe >>= 8;
    const uint8_t nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      // conditional LPS exchange
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      // conditional MPS exchange
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // start over at a byte boundary at `at` (after a restart marker)
  void reset(size_t at) {
    pos = at;
    c = a = 0;
    ct = -16;
    stopped = false;
  }
};

// a nonzero value (T.81 F.21-F.24) after its sign: its magnitude category
// m, doubled at each 1 decided from bin x on (F.23), then the bits below
// its top one, each decided in the bin 14 past the last category bin
// (F.24); jdarith.c's arithmetic, which refuses a category past 2^15
int arith_value(Arith& e, uint8_t* st, int m, uint8_t* x, int sign) {
  if (x) {
    st = x;
    while (e.decode(st)) {
      if ((m <<= 1) == 0x8000)
        corrupt("arithmetic-coded magnitude overflow (corrupt JPEG data)");
      st += 1;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (e.decode(st)) v |= m;
  v += 1;
  return sign ? -v : v;
}

// a DC difference (F.19), the component's context updated as the DAC's L
// and U condition it (F.1.4.4.1.2)
int arith_dc_diff(Arith& e, Scan& scan, ScanComponent& sc) {
  uint8_t* stats = scan.dc_stats[sc.dc_tbl];
  uint8_t* st = stats + sc.context;
  if (e.decode(st) == 0) {
    sc.context = 0;
    return 0;
  }
  const int sign = e.decode(st + 1);
  st += 2 + sign;
  int m = e.decode(st);
  uint8_t* x = stats + 20;                    // X1
  if (m) {
    while (e.decode(x)) {
      if ((m <<= 1) == 0x8000)
        corrupt("arithmetic-coded magnitude overflow (corrupt JPEG data)");
      x += 1;
    }
    st = x;
  }
  if (m < static_cast<int>((1L << sc.dc_l) >> 1))
    sc.context = 0;                           // zero difference category
  else if (m > static_cast<int>((1L << sc.dc_u) >> 1))
    sc.context = 12 + sign * 4;               // large
  else
    sc.context = 4 + sign * 4;                // small
  return arith_value(e, st, m, nullptr, sign);
}

// the AC coefficients ss..se of a block (F.20), each shifted up by al
void arith_ac_first(Arith& e, Scan& scan, ScanComponent& sc, int ss, int se,
                    int al, int16_t* coef) {
  uint8_t* stats = scan.ac_stats[sc.ac_tbl];
  for (int k = ss; k <= se; k++) {
    uint8_t* st = stats + 3 * (k - 1);
    if (e.decode(st)) break;                  // EOB
    while (e.decode(st + 1) == 0) {
      st += 3;
      if (++k > se)
        corrupt("arithmetic-coded AC coefficients run past the band "
                "(corrupt JPEG data)");
    }
    const int sign = e.decode(&scan.fixed_bin);
    st += 2;
    int m = e.decode(st);
    uint8_t* x = nullptr;
    if (m && e.decode(st)) {
      m <<= 1;
      x = stats + (k <= sc.ac_k ? 189 : 217);  // X2, by the DAC's Kx
    }
    const int v = arith_value(e, st, m, x, sign);
    coef[kNaturalOrder[k]] =
        static_cast<int16_t>(static_cast<uint32_t>(v) << al);
  }
}

// a refinement scan's band ss..se of a block (G.1.3.3): a correction bit
// for each coefficient already nonzero, the new ones +-2^al
void arith_ac_refine(Arith& e, Scan& scan, ScanComponent& sc, int16_t* coef) {
  uint8_t* stats = scan.ac_stats[sc.ac_tbl];
  const int p1 = 1 << scan.al, m1 = -p1;
  int kex = scan.se;                          // the last nonzero before
  for (; kex > 0; kex--)
    if (coef[kNaturalOrder[kex]]) break;
  for (int k = scan.ss; k <= scan.se; k++) {
    uint8_t* st = stats + 3 * (k - 1);
    if (k > kex && e.decode(st)) break;       // EOB
    for (;;) {
      int16_t* c = coef + kNaturalOrder[k];
      if (*c) {
        if (e.decode(st + 2))
          *c = static_cast<int16_t>(*c < 0 ? *c + m1 : *c + p1);
        break;
      }
      if (e.decode(st + 1)) {
        *c = static_cast<int16_t>(e.decode(&scan.fixed_bin) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > scan.se)
        corrupt("arithmetic-coded AC coefficients run past the band "
                "(corrupt JPEG data)");
    }
  }
}

// a sequential block (jdarith.c's decode_mcu): the DC value, the AC
// coefficients 1-63
void arith_sequential(Arith& e, Scan& scan, ScanComponent& sc,
                      int16_t* coef) {
  sc.pred += static_cast<uint32_t>(arith_dc_diff(e, scan, sc));
  coef[0] = static_cast<int16_t>(sc.pred);
  arith_ac_first(e, scan, sc, 1, 63, 0, coef);
}

void arith_dc_first(Arith& e, Scan& scan, ScanComponent& sc, int16_t* coef) {
  sc.pred += static_cast<uint32_t>(arith_dc_diff(e, scan, sc));
  coef[0] = static_cast<int16_t>(sc.pred << scan.al);
}

void arith_dc_refine(Arith& e, Scan& scan, int16_t* coef) {
  if (e.decode(&scan.fixed_bin))
    coef[0] = static_cast<int16_t>(coef[0] | (1 << scan.al));
}


// jdphuff.c's four progressive scans, on one block's coefficients

void decode_dc_first(Bits& b, ScanComponent& sc, int al, int16_t* coef) {
  int s = decode_symbol(b, sc.dc);
  int diff = s ? extend(b.get(s), s) : 0;
  int64_t v = static_cast<int64_t>(static_cast<int32_t>(sc.pred)) + diff;
  if (v > INT32_MAX || v < INT32_MIN)
    corrupt("DC coefficient out of range (corrupt JPEG data)");
  sc.pred = static_cast<uint32_t>(v);
  coef[0] = static_cast<int16_t>(sc.pred << al);  // (JCOEF)LEFT_SHIFT(s, Al)
}

void decode_dc_refine(Bits& b, int al, int16_t* coef) {
  if (b.get(1)) coef[0] = static_cast<int16_t>(coef[0] | (1 << al));
}

void decode_ac_first(Bits& b, Scan& scan, const Decoder& ac, int16_t* coef) {
  if (scan.eobrun > 0) {                      // a band of zeros
    scan.eobrun--;
    return;
  }
  for (int k = scan.ss; k <= scan.se; k++) {
    int rs = decode_symbol(b, ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      if (k > scan.se) corrupt("AC coefficients run past the spectral band");
      coef[kNaturalOrder[k]] = static_cast<int16_t>(
          static_cast<uint32_t>(extend(b.get(s), s)) << scan.al);
    } else if (r == 15) {                     // ZRL
      k += 15;
    } else {                                  // EOBr: 2^r + r appended bits
      scan.eobrun = (1u << r) + b.get(r) - 1;
      break;
    }
  }
}

// a correction bit for a coefficient already nonzero: 1 moves it away from
// 0 by the bit being coded
inline void correct(Bits& b, int16_t* c, int p1) {
  if (b.get(1) && (*c & p1) == 0)
    *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c - p1);
}

void decode_ac_refine(Bits& b, Scan& scan, const Decoder& ac, int16_t* coef) {
  const int p1 = 1 << scan.al;
  const int se = scan.se;
  int k = scan.ss;
  if (scan.eobrun == 0) {
    for (; k <= se; k++) {
      int rs = decode_symbol(b, ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        if (s != 1)
          corrupt("a refinement scan codes a coefficient of more than one "
                  "bit (corrupt JPEG data)");
        s = b.get(1) ? p1 : -p1;
      } else if (r != 15) {                   // EOBr
        scan.eobrun = (1u << r) + b.get(r);
        break;
      }
      // past the coefficients already nonzero (a correction bit each) and
      // r of those still zero, to the one the symbol makes nonzero
      do {
        int16_t* c = coef + kNaturalOrder[k];
        if (*c != 0) {
          correct(b, c, p1);
        } else if (--r < 0) {
          break;
        }
        k++;
      } while (k <= se);
      if (s) {
        if (k > se) corrupt("AC coefficients run past the spectral band");
        coef[kNaturalOrder[k]] = static_cast<int16_t>(s);
      }
    }
  }
  if (scan.eobrun > 0) {
    // the rest of the band after the end-of-band: correction bits only
    for (; k <= se; k++) {
      int16_t* c = coef + kNaturalOrder[k];
      if (*c != 0) correct(b, c, p1);
    }
    scan.eobrun--;
  }
}

// max_dc as derive takes it: -1 builds an AC table
void build_table(const HuffTable* tables, int index, int max_dc,
                 Decoder* out) {
  const bool dc = max_dc >= 0;
  if (index >= 4) corrupt("Huffman table index out of 0-3");
  const HuffTable* t = &tables[index];
  HuffTable std_table;
  if (!t->defined) {
    if (index > 1) corrupt("scan uses an undefined Huffman table");
    const uint8_t* bits =
        dc ? (index ? kBitsDcChr : kBitsDcLum) : (index ? kBitsAcChr
                                                        : kBitsAcLum);
    const uint8_t* vals = dc ? kValDc : (index ? kValAcChr : kValAcLum);
    int count = 0;
    for (int i = 0; i < 16; i++) {
      std_table.bits[i] = bits[i];
      count += bits[i];
    }
    std::memcpy(std_table.vals, vals, count);
    t = &std_table;
  }
  derive(*t, max_dc, out);
}

std::string progression(const Scan& scan) {
  return "Ss=" + std::to_string(scan.ss) + " Se=" + std::to_string(scan.se) +
         " Ah=" + std::to_string(scan.ah) + " Al=" + std::to_string(scan.al);
}

// jdphuff.c's start_pass_phuff_decoder: the scan's parameters, then the
// progression of each of its components, which libjpeg only warns of
// (JWRN_BOGUS_PROGRESSION) and this decoder refuses
void check_progression(Scan& scan) {
  const bool dc = scan.ss == 0;
  bool bad = dc ? scan.se != 0
                : scan.ss > scan.se || scan.se > 63 || scan.ns != 1;
  if (scan.ah != 0 && scan.al != scan.ah - 1) bad = true;
  if (scan.al > 13) bad = true;
  if (bad) corrupt("bad progressive scan parameters " + progression(scan));
  for (int i = 0; i < scan.ns; i++) {
    int* bits = scan.sc[i].k->bits;
    if (!dc && bits[0] < 0)
      corrupt("an AC scan before the component's DC scan (bogus "
              "progression, " + progression(scan) + ")");
    for (int k = scan.ss; k <= scan.se; k++) {
      if (scan.ah != (bits[k] < 0 ? 0 : bits[k]))
        corrupt("a scan out of the progression of its coefficients (bogus "
                "progression, " + progression(scan) + ")");
      bits[k] = scan.al;
    }
  }
}

// SOS header: the components of the scan, their tables; entropy data next
void read_sos(State& s, Scan* scan) {
  if (!s.frame) corrupt("scan before the start-of-frame marker");
  size_t p, end;
  segment(s, &p, &end);
  if (end - p < 1) corrupt("truncated scan header");
  int ns = s.d[p];
  if (ns < 1 || ns > 4 || end - p != static_cast<size_t>(4 + 2 * ns))
    corrupt("bad scan header");
  Image& im = s.im;
  scan->ns = ns;
  scan->arith = im.arith;
  const uint8_t* band = s.d + p + 1 + 2 * ns;
  scan->ss = band[0];
  scan->se = band[1];
  scan->ah = band[2] >> 4;
  scan->al = band[2] & 15;
  int blocks = 0;
  for (int i = 0; i < ns; i++) {
    int id = s.d[p + 1 + 2 * i];
    Component* k = nullptr;
    for (int c = 0; c < im.ncomp; c++)
      if (im.comp[c].id == id) k = &im.comp[c];
    if (!k) corrupt("scan names a component the frame does not have");
    for (int o = 0; o < i; o++)
      if (scan->sc[o].k == k) corrupt("scan names a component twice");
    // T.81 B.2.3, which libjpeg-turbo holds lossless scans to
    if (im.lossless && i > 0 && k < scan->sc[i - 1].k)
      corrupt("components of a lossless scan out of the frame's order");
    scan->sc[i].k = k;
    blocks += ns > 1 ? k->h * k->v : 1;
  }
  if (blocks > kMaxBlocksInMcu) corrupt("more than 10 blocks in an MCU");
  // a sequential scan decodes whatever Ss, Se, Ah/Al say, as libjpeg does
  // (with a warning); a progressive one is checked, and builds only the
  // tables it reads; a lossless one reads its predictor from Ss and its
  // point transform from Al (jdlossls.c's start_pass_lossless checks them)
  if (im.progressive) check_progression(*scan);
  if (im.lossless &&
      (scan->ss < 1 || scan->ss > 7 || scan->se != 0 || scan->ah != 0 ||
       scan->al >= im.precision))
    corrupt("bad lossless scan parameters (predictor " +
            std::to_string(scan->ss) + ", Se=" + std::to_string(scan->se) +
            " Ah=" + std::to_string(scan->ah) +
            " Al=" + std::to_string(scan->al) + ")");
  scan->need_dc = !im.progressive || (scan->ss == 0 && scan->ah == 0);
  scan->need_ac = !im.lossless && (!im.progressive || scan->ss > 0);
  for (int i = 0; i < ns; i++) {
    int tables = s.d[p + 2 + 2 * i];
    ScanComponent& sc = scan->sc[i];
    if (im.arith) {
      // jdarith.c's statistics tables 0-15, conditioned by the DAC
      sc.dc_tbl = tables >> 4;
      sc.ac_tbl = tables & 15;
      sc.dc_l = s.dac_l[sc.dc_tbl];
      sc.dc_u = s.dac_u[sc.dc_tbl];
      sc.ac_k = s.dac_k[sc.ac_tbl];
      continue;
    }
    if (scan->need_dc)
      build_table(s.dc, tables >> 4, im.lossless ? 16 : 15, &sc.dc);
    if (scan->need_ac) build_table(s.ac, tables & 15, -1, &sc.ac);
  }
  reset_statistics(*scan);
  scan->data = s.pos;
}

// the first byte after the entropy-coded data at `from`: the first marker
// that is not a restart marker, or the end of the data
size_t entropy_end(const State& s, size_t from) {
  const uint8_t* end = s.d + s.n;
  for (const uint8_t* p = s.d + from;
       (p = static_cast<const uint8_t*>(std::memchr(p, 0xFF, end - p))) &&
       p + 1 < end;
       p++) {
    uint8_t m = p[1];
    if (m != 0 && m != 0xFF && (m < 0xD0 || m > 0xD7))
      return static_cast<size_t>(p - s.d);
  }
  return s.n;
}

// bounds checked before the coefficient buffer, the planes and the output
// are allocated. A sequential block costs at least two bits (a DC code and
// an AC code), a progressive DC-first block one, so the first scan's
// entropy-coded data must hold that many bytes for its blocks; and the
// scans from the first on code every block of every component, so the data
// from there to its end must hold a bit for each, whichever components the
// first scan holds. (A file too short for a component it never codes is
// refused; libjpeg would leave that component grey.) A lossless sample
// costs at least a bit. Arithmetic-coded data has no such bound: the coder
// reads zeros at a marker, and a scan of zeros decodes to a picture.
void check_plausible(const State& s, const Scan& scan) {
  const Image& im = s.im;
  if (im.arith) return;
  uint64_t blocks = 0, all = 0;
  if (im.lossless) {
    const uint64_t pixels = static_cast<uint64_t>(im.width) * im.height;
    if (static_cast<uint64_t>(scan.ns) * pixels >
            8 * static_cast<uint64_t>(entropy_end(s, scan.data) - scan.data) ||
        im.ncomp * pixels > 8 * static_cast<uint64_t>(s.n - scan.data))
      corrupt("the entropy-coded data is too short for the image size "
              "(truncated JPEG)");
    return;
  }
  for (int i = 0; i < scan.ns; i++) {
    const Component& k = *scan.sc[i].k;
    blocks += scan.ns > 1 ? static_cast<uint64_t>(im.mcux) * im.mcuy * k.h * k.v
                          : static_cast<uint64_t>(k.bw) * k.bh;
  }
  for (int c = 0; c < im.ncomp; c++)
    all += static_cast<uint64_t>(im.comp[c].bw) * im.comp[c].bh;
  const uint64_t bytes = entropy_end(s, scan.data) - scan.data;
  if (blocks > (im.progressive ? 8 : 4) * bytes ||
      all > 8 * static_cast<uint64_t>(s.n - scan.data))
    corrupt("the entropy-coded data is too short for the image size "
            "(truncated JPEG)");
}

// the quantization tables of the scan's components, as jdinput.c's
// latch_quant_tables takes them: at each component's first scan
void latch_tables(State& s, const Scan& scan) {
  for (int i = 0; i < scan.ns; i++) {
    Component& k = *scan.sc[i].k;
    if (k.latched) continue;
    if (!s.qt_defined[k.tq]) corrupt("undefined quantization table");
    for (int j = 0; j < 64; j++)
      k.qt[j] = static_cast<int16_t>(s.qt[k.tq][j]);   // ISLOW_MULT_TYPE
    k.latched = true;
  }
}

// the scan's MCUs in order, restart intervals handled (jdhuff.c's and
// jdarith.c's process_restart: the buffered bits dropped, RSTn read, the DC
// predictions, the EOB run and the arithmetic statistics reset); b is the
// scan's Bits or Arith; block(sc, bx, by) decodes one block
template <typename R, typename F>
void for_each_block(State& s, Scan& scan, R& b, F&& block) {
  Image& im = s.im;
  long mcus_x, mcus_y;
  if (scan.ns > 1) {
    mcus_x = im.mcux;
    mcus_y = im.mcuy;
  } else {
    mcus_x = scan.sc[0].k->bw;
    mcus_y = scan.sc[0].k->bh;
  }
  long done = 0;
  int next_rst = 0;
  for (long my = 0; my < mcus_y; my++) {
    for (long mx = 0; mx < mcus_x; mx++, done++) {
      if (s.restart_interval && done > 0 && done % s.restart_interval == 0) {
        size_t at = b.pos;
        if (next_marker(s.d, s.n, &at) != 0xD0 + next_rst)
          corrupt("restart marker missing or out of order");
        next_rst = (next_rst + 1) & 7;
        b.reset(at);
        reset_statistics(scan);
      }
      if (scan.ns == 1) {
        block(scan.sc[0], static_cast<int>(mx), static_cast<int>(my));
        continue;
      }
      for (int i = 0; i < scan.ns; i++) {
        ScanComponent& sc = scan.sc[i];
        for (int y = 0; y < sc.k->v; y++)
          for (int x = 0; x < sc.k->h; x++)
            block(sc, static_cast<int>(mx) * sc.k->h + x,
                  static_cast<int>(my) * sc.k->v + y);
      }
    }
  }
  // bits buffered past the last block (padding) are dropped; bytes before
  // the next marker are skipped by next_marker
  s.pos = b.pos;
}

// a single-scan file's one scan, straight into the planes
void decode_scan(State& s, Scan& scan) {
  latch_tables(s, scan);
  for (int i = 0; i < scan.ns; i++) {
    Component& k = *scan.sc[i].k;
    k.plane.assign(static_cast<size_t>(k.stride) * k.rows, 0);
  }
  if (!s.im.arith) {
    Bits b{s.d, s.n, scan.data};
    for_each_block(s, scan, b, [&](ScanComponent& sc, int bx, int by) {
      decode_block(b, sc, bx, by);
    });
    return;
  }
  Arith e{s.d, s.n, scan.data};
  for_each_block(s, scan, e, [&](ScanComponent& sc, int bx, int by) {
    int16_t coef[64] = {};
    arith_sequential(e, scan, sc, coef);
    Component& c = *sc.k;
    idct_islow(coef, c.qt,
               c.plane.data() + static_cast<size_t>(by) * 8 * c.stride +
                   bx * 8,
               c.stride);
  });
}

// one arithmetic-coded scan of a multi-scan file into the coefficient
// buffer (jdarith.c's decode_mcu and its four progressive scans)
void decode_arith_coefficients(State& s, Scan& scan) {
  Arith e{s.d, s.n, scan.data};
  if (!s.im.progressive) {
    for_each_block(s, scan, e, [&](ScanComponent& sc, int bx, int by) {
      arith_sequential(e, scan, sc, sc.k->block(bx, by));
    });
  } else if (scan.ss == 0 && scan.ah == 0) {
    for_each_block(s, scan, e, [&](ScanComponent& sc, int bx, int by) {
      arith_dc_first(e, scan, sc, sc.k->block(bx, by));
    });
  } else if (scan.ss == 0) {
    for_each_block(s, scan, e, [&](ScanComponent& sc, int bx, int by) {
      arith_dc_refine(e, scan, sc.k->block(bx, by));
    });
  } else if (scan.ah == 0) {
    for_each_block(s, scan, e, [&](ScanComponent& sc, int bx, int by) {
      arith_ac_first(e, scan, sc, scan.ss, scan.se, scan.al,
                     sc.k->block(bx, by));
    });
  } else {
    for_each_block(s, scan, e, [&](ScanComponent& sc, int bx, int by) {
      arith_ac_refine(e, scan, sc, sc.k->block(bx, by));
    });
  }
}

// one scan of a multi-scan file into the coefficient buffer
void decode_scan_coefficients(State& s, Scan& scan) {
  latch_tables(s, scan);
  if (s.im.arith) {
    decode_arith_coefficients(s, scan);
    return;
  }
  Bits b{s.d, s.n, scan.data};
  if (!s.im.progressive) {
    for_each_block(s, scan, b, [&](ScanComponent& sc, int bx, int by) {
      decode_sequential(b, sc, sc.k->block(bx, by));
    });
  } else if (scan.ss == 0 && scan.ah == 0) {
    for_each_block(s, scan, b, [&](ScanComponent& sc, int bx, int by) {
      decode_dc_first(b, sc, scan.al, sc.k->block(bx, by));
    });
  } else if (scan.ss == 0) {
    for_each_block(s, scan, b, [&](ScanComponent& sc, int bx, int by) {
      decode_dc_refine(b, scan.al, sc.k->block(bx, by));
    });
  } else if (scan.ah == 0) {
    for_each_block(s, scan, b, [&](ScanComponent& sc, int bx, int by) {
      decode_ac_first(b, scan, sc.ac, sc.k->block(bx, by));
    });
  } else {
    for_each_block(s, scan, b, [&](ScanComponent& sc, int bx, int by) {
      decode_ac_refine(b, scan, sc.ac, sc.k->block(bx, by));
    });
  }
}

// ----------------------------------------------------------------------------
// lossless JPEG (jdlhuff.c, jdlossls.c, jddiffct.c of libjpeg-turbo 3.1)

// T.81 Table H.1's predictors of a sample from Ra (left), Rb (above) and Rc
// (above left), as jdlossls.c computes them
inline int predict(int psv, int ra, int rb, int rc) {
  switch (psv) {
    case 1: return ra;
    case 2: return rb;
    case 3: return rc;
    case 4: return ra + rb - rc;
    case 5: return ra + ((rb - rc) >> 1);
    case 6: return rb + ((ra - rc) >> 1);
    default: return (ra + rb) >> 1;
  }
}

// one lossless scan into its components' planes: each row's differences
// decoded MCU by MCU (a sample of each component of the scan; 32768 for
// the symbol 16), then undifferenced component by component, modulo 2^16
// (jdlossls.c): the first row of the scan and of each restart interval
// from 2^(P - Pt - 1) and then its left sample, every other row's first
// sample from the one above and the rest by the scan's predictor; each
// sample then shifted up by the point transform into 8 bits. A restart
// interval must hold whole rows, as jddiffct.c requires.
void decode_lossless_scan(State& s, Scan& scan) {
  Image& im = s.im;
  const int w = im.width, h = im.height, ns = scan.ns;
  long rows_per_restart = 0;
  if (s.restart_interval) {
    if (s.restart_interval % w)
      corrupt("restart interval of " + std::to_string(s.restart_interval) +
              " MCUs, not a whole number of rows of " + std::to_string(w) +
              " (lossless JPEG)");
    rows_per_restart = s.restart_interval / w;
  }
  std::vector<int> diff(static_cast<size_t>(ns) * w);
  std::vector<uint16_t> rows(2 * static_cast<size_t>(ns) * w);
  for (int i = 0; i < ns; i++) {
    Component& k = *scan.sc[i].k;
    if (k.plane.empty()) k.plane.assign(static_cast<size_t>(w) * h, 0);
  }
  const int psv = scan.ss, pt = scan.al;
  const int initial = 1 << (im.precision - pt - 1);
  Bits b{s.d, s.n, scan.data};
  int next_rst = 0;
  bool first = true;
  for (int y = 0; y < h; y++) {
    if (rows_per_restart && y > 0 && y % rows_per_restart == 0) {
      size_t at = b.pos;
      if (next_marker(s.d, s.n, &at) != 0xD0 + next_rst)
        corrupt("restart marker missing or out of order");
      next_rst = (next_rst + 1) & 7;
      b.reset(at);
      first = true;
    }
    for (int x = 0; x < w; x++)
      for (int i = 0; i < ns; i++) {
        int sym = decode_symbol(b, scan.sc[i].dc);
        diff[static_cast<size_t>(i) * w + x] =
            sym == 16 ? 32768 : (sym ? extend(b.get(sym), sym) : 0);
      }
    for (int i = 0; i < ns; i++) {
      const int* d = diff.data() + static_cast<size_t>(i) * w;
      uint16_t* cur = rows.data() + (2 * static_cast<size_t>(i) + (y & 1)) * w;
      const uint16_t* prev =
          rows.data() + (2 * static_cast<size_t>(i) + ((y + 1) & 1)) * w;
      int ra;
      if (first) {
        ra = (d[0] + initial) & 0xFFFF;
        cur[0] = static_cast<uint16_t>(ra);
        for (int x = 1; x < w; x++) {
          ra = (d[x] + ra) & 0xFFFF;
          cur[x] = static_cast<uint16_t>(ra);
        }
      } else {
        int rb = prev[0];
        ra = (d[0] + rb) & 0xFFFF;
        cur[0] = static_cast<uint16_t>(ra);
        for (int x = 1; x < w; x++) {
          int rc = rb;
          rb = prev[x];
          ra = (d[x] + predict(psv, ra, rb, rc)) & 0xFFFF;
          cur[x] = static_cast<uint16_t>(ra);
        }
      }
      uint8_t* out = scan.sc[i].k->plane.data() + static_cast<size_t>(y) * w;
      for (int x = 0; x < w; x++) out[x] = static_cast<uint8_t>(cur[x] << pt);
    }
    first = false;
  }
  s.pos = b.pos;
}

// ----------------------------------------------------------------------------
// block smoothing (jdcoefct.c of libjpeg-turbo 3.1): where a progressive
// scan script stops short, the first nine AC coefficients still unknown are
// estimated from the DC values of the block and its 24 neighbours, and with
// no AC coefficient known at all the DC value is interpolated too

// natural positions of zigzag coefficients 0-9
constexpr int kQ00 = 0, kQ01 = 1, kQ10 = 8, kQ20 = 16, kQ11 = 9, kQ02 = 2,
              kQ03 = 3, kQ12 = 10, kQ21 = 17, kQ30 = 24;

// jdcoefct.c's smoothing_ok: a progressive file in which every component
// has had its DC scan and has nonzero quantizers for its first ten
// coefficients, and some component's first nine AC coefficients are not
// known to full precision
bool smoothing_ok(const Image& im) {
  if (!im.progressive) return false;
  bool useful = false;
  for (int c = 0; c < im.ncomp; c++) {
    const Component& k = im.comp[c];
    if (!k.latched) return false;
    for (int pos : {kQ00, kQ01, kQ10, kQ20, kQ11, kQ02, kQ03, kQ12, kQ21,
                    kQ30})
      if (k.qt[pos] == 0) return false;
    if (k.bits[0] < 0) return false;
    for (int i = 1; i < 10; i++)
      if (k.bits[i] != 0) useful = true;
  }
  return useful;
}

// an estimate of a coefficient from num: (q << 7 + |num|) / (q << 8), kept
// below 2^Al where Al > 0 says how many low bits are unknown
inline int16_t estimate(int64_t num, int64_t q, int al) {
  int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return static_cast<int16_t>(num >= 0 ? pred : -pred);
}

// the block rows above and below block row `by` whose DC values smoothing
// reads, as decompress_smooth_data picks them: it counts rows as
// output_iMCU_row * block_rows + block_row out of block_rows *
// total_iMCU_rows, where block_rows is the component's v sampling factor
// except in the last iMCU row (the rows left there). So with v > 1 and a
// short last iMCU row, the rows read near the bottom of the image are not
// those of a plain clamp: the MCU padding's row below the image may be read
// from the iMCU row before the last, and the row two above from neither.
void smoothing_rows(const Image& im, const Component& k, int by,
                    int rows[5]) {
  const int total = im.mcuy, v = k.v, imcu = by / v;
  int block_rows = v;
  if (imcu == total - 1 && k.bh % v) block_rows = k.bh % v;
  const int r = imcu * block_rows + by % v, n = block_rows * total;
  rows[2] = by;
  rows[1] = r > 0 ? by - 1 : by;
  rows[0] = r > 1 ? by - 2 : rows[1];
  rows[3] = r < n - 1 ? by + 1 : by;
  rows[4] = r < n - 2 ? by + 2 : rows[3];
}

// the block at (bx, by) of component k with its estimates, into ws
void smooth_block(const Image& im, Component& k, int bx, int by,
                  bool change_dc, int16_t* ws) {
  // DC values of the 5 x 5 neighbourhood, the edges repeated: dc[r][c] is
  // libjpeg's DC(5 * r + c + 1)
  int dc[5][5], rows[5];
  smoothing_rows(im, k, by, rows);
  for (int r = 0; r < 5; r++) {
    int y = rows[r];
    for (int c = 0; c < 5; c++) {
      int x = std::min(std::max(bx + c - 2, 0), k.bw - 1);
      dc[r][c] = k.block(x, y)[0];
    }
  }
  const int DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2], DC04 = dc[0][3],
            DC05 = dc[0][4], DC06 = dc[1][0], DC07 = dc[1][1], DC08 = dc[1][2],
            DC09 = dc[1][3], DC10 = dc[1][4], DC11 = dc[2][0], DC12 = dc[2][1],
            DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4], DC16 = dc[3][0],
            DC17 = dc[3][1], DC18 = dc[3][2], DC19 = dc[3][3], DC20 = dc[3][4],
            DC21 = dc[4][0], DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3],
            DC25 = dc[4][4];
  std::memcpy(ws, k.block(bx, by), 64 * sizeof(int16_t));
  const int16_t* q = k.qt;
  const int64_t Q00 = q[kQ00];
  const int* bits = k.bits;
  int al;
  if ((al = bits[1]) != 0 && ws[kQ01] == 0)
    ws[kQ01] = estimate(
        Q00 * (change_dc
                   ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                      13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 -
                      38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                      13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                   : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)),
        q[kQ01], al);
  if ((al = bits[2]) != 0 && ws[kQ10] == 0)
    ws[kQ10] = estimate(
        Q00 * (change_dc
                   ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                      13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                      13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                      3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                   : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)),
        q[kQ10], al);
  if ((al = bits[3]) != 0 && ws[kQ20] == 0)
    ws[kQ20] = estimate(
        Q00 * (change_dc
                   ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                      14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 +
                      2 * DC19 + DC23)
                   : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)),
        q[kQ20], al);
  if ((al = bits[4]) != 0 && ws[kQ11] == 0)
    ws[kQ11] = estimate(
        Q00 * (change_dc
                   ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                      9 * DC19 + DC21 - DC25)
                   : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                      DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09)),
        q[kQ11], al);
  if ((al = bits[5]) != 0 && ws[kQ02] == 0)
    ws[kQ02] = estimate(
        Q00 * (change_dc
                   ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                      14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                      2 * DC19)
                   : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)),
        q[kQ02], al);
  if (!change_dc) return;
  if ((al = bits[6]) != 0 && ws[kQ03] == 0)
    ws[kQ03] = estimate(
        Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), q[kQ03], al);
  if ((al = bits[7]) != 0 && ws[kQ12] == 0)
    ws[kQ12] = estimate(
        Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), q[kQ12], al);
  if ((al = bits[8]) != 0 && ws[kQ21] == 0)
    ws[kQ21] = estimate(
        Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), q[kQ21], al);
  if ((al = bits[9]) != 0 && ws[kQ30] == 0)
    ws[kQ30] = estimate(
        Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), q[kQ30], al);
  // the DC value, a weighted mean of the 25 (the weights sum to 256)
  ws[0] = estimate(
      Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
             6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
             8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
             6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
             2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25),
      Q00, 0);
}

// the coefficient buffer after the last scan into the planes: each block
// of the image (not the MCU padding) inverse-transformed, smoothed first
// where smoothing_ok says so
void transform_buffer(Image& im) {
  const bool smooth = smoothing_ok(im);
  for (int c = 0; c < im.ncomp; c++) {
    Component& k = im.comp[c];
    k.plane.assign(static_cast<size_t>(k.stride) * k.rows, 0);
    // DC interpolation only where no AC coefficient is known at all
    bool change_dc = true;
    for (int i = 1; i < 10; i++)
      if (k.bits[i] != -1) change_dc = false;
    int16_t ws[64];
    for (int by = 0; by < k.bh; by++)
      for (int bx = 0; bx < k.bw; bx++) {
        const int16_t* coef = k.block(bx, by);
        if (smooth) {
          smooth_block(im, k, bx, by, change_dc, ws);
          coef = ws;
        }
        idct_islow(coef, k.qt,
                   k.plane.data() + static_cast<size_t>(by) * 8 * k.stride +
                       bx * 8,
                   k.stride);
      }
  }
}

// ----------------------------------------------------------------------------
// upsampling (jdsample.c) and colour conversion (jdcolor.c)

// one output row `y` of component k at full width into `row` (>= width + 1)
void upsample_row(const Image& im, const Component& k, int y, uint8_t* row) {
  const int w = im.width;
  const uint8_t* pl = k.plane.data();
  auto in_row = [&](int r) {
    if (r < 0) r = 0;
    if (r > k.dh - 1) r = k.dh - 1;           // jdmainct.c's edge rows
    return pl + static_cast<size_t>(r) * k.stride;
  };
  const int hx = im.hmax / k.h, vx = im.vmax / k.v;
  const int dw = k.dw;
  if (hx == 1 && vx == 1) {                   // fullsize_upsample
    std::memcpy(row, in_row(y), w);
    return;
  }
  if (hx == 2 && vx == 1) {
    const uint8_t* in = in_row(y);
    if (dw > 2) {                             // h2v1_fancy_upsample
      uint8_t* o = row;
      o[0] = in[0];
      o[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; i++) {
        int v = in[i] * 3;
        o[2 * i] = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
        o[2 * i + 1] = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
      }
      o[2 * (dw - 1)] =
          static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      o[2 * (dw - 1) + 1] = in[dw - 1];
    } else {                                  // h2v1_upsample
      for (int x = 0; x < w; x++) row[x] = in[x >> 1];
    }
    return;
  }
  if (hx == 1 && vx == 2) {                   // h1v2_fancy_upsample
    int r = y >> 1;
    const uint8_t* in0 = in_row(r);
    const uint8_t* in1 = in_row((y & 1) ? r + 1 : r - 1);
    int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < w; x++)
      row[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    return;
  }
  if (hx == 2 && vx == 2) {
    int r = y >> 1;
    if (dw > 2) {                             // h2v2_fancy_upsample
      const uint8_t* in0 = in_row(r);
      const uint8_t* in1 = in_row((y & 1) ? r + 1 : r - 1);
      uint8_t* o = row;
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      o[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
      o[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int i = 1; i < dw - 1; i++) {
        next_sum = in0[i + 1] * 3 + in1[i + 1];
        o[2 * i] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        o[2 * i + 1] =
            static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      o[2 * (dw - 1)] =
          static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      o[2 * (dw - 1) + 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
    } else {                                  // h2v2_upsample
      const uint8_t* in = in_row(r);
      for (int x = 0; x < w; x++) row[x] = in[x >> 1];
    }
    return;
  }
  // int_upsample: every sample replicated hx x vx
  const uint8_t* in = in_row(y / vx);
  for (int x = 0; x < w; x++) row[x] = in[x / hx];
}

// a lossless file's planes into BGR, as cv2 gives them: the components as
// stored, the first in R and the third in B (a plane exists once a scan
// has coded its component)
void convert_lossless(const Image& im, uint8_t* out) {
  const size_t n = static_cast<size_t>(im.width) * im.height;
  for (int c = 0; c < 3; c++) {
    if (im.comp[c].plane.empty())
      corrupt("lossless JPEG ends before a scan codes component " +
              std::to_string(c));
    const uint8_t* in = im.comp[c].plane.data();
    for (size_t i = 0; i < n; i++) out[3 * i + 2 - c] = in[i];
  }
}

void convert(const Image& im, uint8_t* out) {
  const int w = im.width;
  if (im.lossless) {
    convert_lossless(im, out);
    return;
  }
  if (im.ncomp == 1) {
    for (int y = 0; y < im.height; y++) {
      const uint8_t* in = im.comp[0].plane.data() +
                          static_cast<size_t>(y) * im.comp[0].stride;
      uint8_t* o = out + static_cast<size_t>(y) * w * 3;
      for (int x = 0; x < w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
    }
    return;
  }
  // jdcolor.c's build_ycc_rgb_table: SCALEBITS 16, ONE_HALF into Cr_r, Cb_b
  // and Cb_g
  constexpr int kScale = 16;
  constexpr int64_t kHalf = static_cast<int64_t>(1) << (kScale - 1);
  auto fix = [](double x) {
    return static_cast<int64_t>(x * (1L << kScale) + 0.5);
  };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; i++) {
    int64_t x = i - 128;
    cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
    cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + kHalf;
  }
  auto clamp = [](int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  };
  std::vector<uint8_t> rows(4 * (static_cast<size_t>(w) + 16));
  uint8_t* r0 = rows.data();
  uint8_t* r1 = r0 + w + 16;
  uint8_t* r2 = r1 + w + 16;
  uint8_t* r3 = r2 + w + 16;
  for (int y = 0; y < im.height; y++) {
    upsample_row(im, im.comp[0], y, r0);
    upsample_row(im, im.comp[1], y, r1);
    upsample_row(im, im.comp[2], y, r2);
    uint8_t* o = out + static_cast<size_t>(y) * w * 3;
    if (im.ncomp == 4) {
      upsample_row(im, im.comp[3], y, r3);
      for (int x = 0; x < w; x++) {
        int c = r0[x], m = r1[x], ye = r2[x];
        const int k = r3[x];
        if (im.ycck) {                        // jdcolor.c's ycck_cmyk_convert
          const int yy = c, cb = m, cr = ye;
          c = clamp(255 - (yy + cr_r[cr]));
          m = clamp(255 - (yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >>
                                                 kScale)));
          ye = clamp(255 - (yy + cb_b[cb]));
        }
        // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
        o[3 * x + 2] = static_cast<uint8_t>(k - ((255 - c) * k >> 8));
        o[3 * x + 1] = static_cast<uint8_t>(k - ((255 - m) * k >> 8));
        o[3 * x] = static_cast<uint8_t>(k - ((255 - ye) * k >> 8));
      }
      continue;
    }
    if (im.rgb) {
      for (int x = 0; x < w; x++) {
        o[3 * x] = r2[x];
        o[3 * x + 1] = r1[x];
        o[3 * x + 2] = r0[x];
      }
      continue;
    }
    for (int x = 0; x < w; x++) {
      int yy = r0[x], cb = r1[x], cr = r2[x];
      o[3 * x + 2] = clamp(yy + cr_r[cr]);
      o[3 * x + 1] =
          clamp(yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScale));
      o[3 * x] = clamp(yy + cb_b[cb]);
    }
  }
}

// ----------------------------------------------------------------------------

// the markers from s.pos on, tables and frame read, to the next SOS (0xDA)
// or EOI (0xD9), which it returns with s.pos past the marker; -1 at the end
// of the data
int read_markers(State& s) {
  for (;;) {
    int m = next_marker(s);
    if (m < 0 || m == 0xDA || m == 0xD9) return m;
    if (m == 0xC4) {
      read_dht(s);
    } else if (m == 0xCC) {
      read_dac(s);
    } else if (m == 0xC8 || m == 0xDE || m == 0xDF) {
      fail(kUnsupported, "hierarchical or extension JPEG (marker " +
                             std::to_string(m) + ")");
    } else if (m >= 0xC0 && m <= 0xCF) {
      read_sof(s, m);
    } else if (m == 0xDB) {
      read_dqt(s);
    } else if (m == 0xDD) {
      read_dri(s);
    } else if (m == 0xD8) {
      corrupt("second SOI marker");
    } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      // RSTn and TEM outside a scan carry no segment; libjpeg passes them
    } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
      if (m == 0xE0 || m == 0xEE) {
        read_app(s, m);
      } else {
        size_t a, b;
        segment(s, &a, &b);
      }
    } else {
      corrupt("unknown JPEG marker " + std::to_string(m));
    }
  }
}

// the markers up to the first scan's entropy data
void read_headers(State& s, Scan* scan) {
  if (s.n < 2 || s.d[0] != 0xFF || s.d[1] != 0xD8)
    corrupt("not a JPEG file (no SOI marker)");
  s.pos = 2;
  int m = read_markers(s);
  if (m < 0) corrupt("JPEG data ends before its first scan");
  if (m == 0xD9) corrupt("JPEG ends (EOI) before its first scan");
  if (!s.frame) corrupt("scan before the start-of-frame marker");
  colour_space(s);
  read_sos(s, scan);
  check_plausible(s, *scan);
}

// the image after read_headers. A sequential file whose first scan holds
// every component has that one scan, then the markers to EOI; every other
// file is read scan by scan into the coefficient buffer to EOI, or to the
// end of the data after a whole scan (libjpeg inserts a missing EOI). The
// one-scan files skip the buffer because it costs them time: through it,
// they decoded 0.96-1.37x as long (median 1.08x over 12 measures, 10 of
// them slower; the 8-core host of an NVIDIA H100 machine).
void decode(State& s, Scan& scan, uint8_t* out) {
  Image& im = s.im;
  if (im.lossless) {
    // the scans into the planes, to EOI or the end of the data
    for (int scans = 1;; scans++) {
      if (scans > kMaxScans)
        corrupt("more than " + std::to_string(kMaxScans) + " scans");
      decode_lossless_scan(s, scan);
      if (read_markers(s) != 0xDA) break;
      read_sos(s, &scan);
    }
    convert(im, out);
    return;
  }
  if (!im.progressive && scan.ns == im.ncomp) {
    decode_scan(s, scan);
    // another scan is an error as in libjpeg (JERR_EOI_EXPECTED)
    for (;;) {
      int m = next_marker(s);
      if (m < 0 || m == 0xD9) break;
      if (m == 0xDA) corrupt("a second scan in a single-scan JPEG");
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      size_t a, b;
      segment(s, &a, &b);
    }
    convert(im, out);
    return;
  }
  for (int c = 0; c < im.ncomp; c++) {
    Component& k = im.comp[c];
    k.coef.assign(static_cast<size_t>(k.stride / 8) * (k.rows / 8) * 64, 0);
  }
  for (int scans = 1;; scans++) {
    if (scans > kMaxScans)
      corrupt("more than " + std::to_string(kMaxScans) + " scans");
    decode_scan_coefficients(s, scan);
    if (read_markers(s) != 0xDA) break;
    read_sos(s, &scan);
  }
  transform_buffer(im);
  convert(im, out);
}

int report(const Failure& f, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", f.what.c_str());
  return f.code;
}

template <typename F>
int guarded(char* err, int errlen, F&& body) {
  try {
    body();
  } catch (const Failure& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return report({kCorrupt, "out of memory decoding the JPEG"}, err, errlen);
  }
  if (err && errlen > 0) err[0] = 0;
  return kOk;
}

}  // namespace

extern "C" {

int i2v_jpeg_info(const uint8_t* data, size_t n, int* height, int* width,
                  int* ncomp, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    if (!data || !height || !width || !ncomp) fail(kArgument, "null argument");
    State s(data, n);
    Scan scan;
    read_headers(s, &scan);
    *height = s.im.height;
    *width = s.im.width;
    *ncomp = s.im.ncomp;
  });
}

int i2v_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out,
                    size_t capacity, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    if (!data || !out) fail(kArgument, "null argument");
    State s(data, n);
    Scan scan;
    read_headers(s, &scan);
    if (capacity < static_cast<size_t>(s.im.width) * s.im.height * 3)
      fail(kArgument, "output buffer smaller than height x width x 3");
    decode(s, scan, out);
  });
}

}  // extern "C"
