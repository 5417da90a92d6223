// The port's native batch loader: threaded decode, mean subtraction,
// shortest-side resize and padding of a batch of image files, and the conv1
// parity-plane packer. Host-only C++17 with a plain C API, built with the
// host compiler together with jpeg.cc (utils/cuda_build.py::build_host) and
// loaded with ctypes by i2vsgg_tpu_torch/runtime/__init__.py, which
// releases the GIL for each call.
//
// The twin of the JAX package's runtime (i2vsgg_tpu/runtime/io_runtime.cc):
// its resize and packer arithmetic is copied operation for operation, so the
// batches are bit-equal to that runtime's. Its libjpeg and libpng are
// replaced by the port's own decoders, since the card's machine has neither
// library: JPEG by jpeg.cc (without the EXIF orientation, which libjpeg does
// not apply either), PNG by the inflate and row filters below.
//
//   int i2v_load_batch(paths, flips, n, means, target, pad_h, pad_w,
//                      out_images, out_scales, out_hw, n_threads,
//                      out_codes, errs, err_len)
//   int i2v_pack_planes(in, b, h, w, hq, wq, out, n_threads)
//   int i2v_decode(path, &out, out_hw, err, err_len), i2v_free(out)
//
// PNG is read at every colour type and bit depth the specification defines,
// non-interlaced or Adam7, as the JAX runtime's libpng transforms leave it
// (16 bits cut to the high byte, grey below 8 bits scaled to 0-255, alpha
// and tRNS dropped); JPEG as jpeg.cc reads it (sequential and progressive
// Huffman, 8-bit, grey or three components).
//
// Error codes (per image in out_codes, or returned): 1 the file does not
// exist, 2 an image this port has no decoder for (the JPEG modes jpeg.cc
// refuses: lossless, hierarchical, arithmetic coding, 12-bit samples, four
// components; formats other than PNG and JPEG), 3 a corrupt or truncated
// file, 4 a bad argument, 5 another error opening or reading the file. Each
// comes with a message. Corrupt data never decodes to an image: every
// chunk's CRC and the zlib stream's Adler-32 are checked.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <new>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int i2v_jpeg_info(const uint8_t* data, size_t n, int* height, int* width,
                  int* ncomp, char* err, int errlen);
int i2v_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out,
                    size_t capacity, char* err, int errlen);
}

namespace {

enum Code {
  kOk = 0,
  kNotFound = 1,
  kUnsupported = 2,
  kCorrupt = 3,
  kArgument = 4,
  kOsError = 5
};

struct Failure {
  int code;
  std::string what;
};

[[noreturn]] void fail(int code, const std::string& what) {
  throw Failure{code, what};
}

[[noreturn]] void corrupt(const std::string& what) { fail(kCorrupt, what); }

struct Image {
  int h = 0, w = 0;            // decoded size
  std::vector<uint8_t> bgr;    // h*w*3, BGR
};

// --------------------------------------------------------------- inflate ---
// RFC 1950 (zlib wrapper) and RFC 1951 (deflate): stored, fixed and dynamic
// Huffman blocks, decoded with two-level lookup tables: the first kLitBits
// (kDistBits) bits of the stream index a primary table whose entry is a
// symbol and its code length, or the offset and index width of a subtable
// for the longer codes under that prefix.

constexpr int kLitBits = 10;
constexpr int kDistBits = 8;
constexpr int kMaxBits = 15;

// a table entry: value << 16 | kind << 8 | bits
enum Kind : uint32_t { kInvalid = 0, kSymbol = 1, kLink = 2 };

inline uint32_t entry(uint32_t value, uint32_t kind, uint32_t bits) {
  return value << 16 | kind << 8 | bits;
}

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                               15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,
                                13,   17,   25,   33,   49,   65,    97,
                                129,  193,  257,  385,  513,  769,   1025,
                                1537, 2049, 3073, 4097, 6145, 8193,  12289,
                                16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
// the order in which the code length code's lengths are sent
const uint8_t kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                              11, 4,  12, 3, 13, 2, 14, 1, 15};

// Builds the decoding table of the canonical code with code lengths
// lens[0..n) (0: the symbol is unused). An over-subscribed code is corrupt;
// an incomplete one too, except (as zlib allows) a literal/length or
// distance code of a single code of length 1, or a distance code with no
// codes at all. Unfilled entries stay kInvalid, so a bit pattern no code
// owns fails where it is read.
void build_table(const uint8_t* lens, int n, int primary, bool lengths_code,
                 std::vector<uint32_t>* table, const char* what) {
  int count[kMaxBits + 1] = {0};
  for (int i = 0; i < n; ++i) count[lens[i]]++;
  count[0] = 0;
  int left = 1, max_len = 0;
  for (int len = 1; len <= kMaxBits; ++len) {
    left = (left << 1) - count[len];
    if (left < 0) corrupt(std::string("over-subscribed ") + what);
    if (count[len]) max_len = len;
  }
  if (left > 0 && (lengths_code || max_len > 1) && max_len != 0)
    corrupt(std::string("incomplete ") + what);
  int next[kMaxBits + 2] = {0};
  for (int len = 1, code = 0; len <= kMaxBits; ++len) {
    code = (code + count[len - 1]) << 1;
    next[len] = code;
  }
  // canonical codes, bit-reversed: deflate packs a code from its most
  // significant bit on, into a stream read from the least significant bit
  std::vector<uint32_t> rev(n, 0);
  for (int i = 0; i < n; ++i) {
    const int len = lens[i];
    if (!len) continue;
    uint32_t code = next[len]++, r = 0;
    for (int b = 0; b < len; ++b) r |= ((code >> b) & 1u) << (len - 1 - b);
    rev[i] = r;
  }
  const uint32_t pmask = (1u << primary) - 1;
  int sub_bits[1 << kLitBits] = {0};
  for (int i = 0; i < n; ++i)
    if (lens[i] > primary) {
      int& s = sub_bits[rev[i] & pmask];
      s = std::max(s, lens[i] - primary);
    }
  size_t size = size_t(1) << primary;
  std::vector<uint32_t> offset(size_t(1) << primary, 0);
  for (size_t p = 0; p < (size_t(1) << primary); ++p)
    if (sub_bits[p]) {
      offset[p] = uint32_t(size);
      size += size_t(1) << sub_bits[p];
    }
  table->assign(size, entry(0, kInvalid, 0));
  uint32_t* t = table->data();
  for (size_t p = 0; p < (size_t(1) << primary); ++p)
    if (sub_bits[p]) t[p] = entry(offset[p], kLink, sub_bits[p]);
  for (int i = 0; i < n; ++i) {
    const int len = lens[i];
    if (!len) continue;
    if (len <= primary) {
      for (uint32_t k = rev[i]; k <= pmask; k += 1u << len)
        t[k] = entry(i, kSymbol, len);
    } else {
      const uint32_t p = rev[i] & pmask, sb = sub_bits[p];
      const int rest = len - primary;
      for (uint32_t k = rev[i] >> primary; k < (1u << sb); k += 1u << rest)
        t[offset[p] + k] = entry(i, kSymbol, rest);
    }
  }
}

class Inflater {
 public:
  Inflater(const uint8_t* in, size_t n, uint8_t* out, size_t cap)
      : in_(in), n_(n), out_(out), cap_(cap) {}

  // Inflates the zlib stream into out[0, cap) and returns the bytes
  // written; bytes after the stream's Adler-32 are ignored, as
  // zlib.decompress ignores them.
  size_t run() {
    if (n_ < 2) corrupt("zlib stream shorter than its header");
    const int cmf = in_[0], flg = in_[1];
    if ((cmf & 15) != 8 || (cmf >> 4) > 7)
      corrupt("zlib header: not deflate with a window of at most 32 KiB");
    if ((cmf * 256 + flg) % 31) corrupt("zlib header check failed");
    if (flg & 32) corrupt("zlib stream needs a preset dictionary");
    pos_ = 2;
    for (bool last = false; !last;) {
      refill();
      last = take(1);
      const uint32_t type = take(2);
      if (type == 0) {
        stored();
      } else if (type == 3) {
        corrupt("deflate block type 3");
      } else {
        if (type == 1) fixed_tables(); else dynamic_tables();
        codes();
      }
      check_overrun();
    }
    align();
    if (pos_ + 4 > n_) corrupt("zlib stream truncated before its Adler-32");
    const uint32_t want = uint32_t(in_[pos_]) << 24 | in_[pos_ + 1] << 16 |
                          in_[pos_ + 2] << 8 | in_[pos_ + 3];
    if (adler32(out_, len_) != want) corrupt("zlib Adler-32 mismatch");
    return len_;
  }

 private:
  // keeps at least 57 bits in the buffer; past the end of the input it
  // shifts in zeros and counts them, and reading them fails
  inline void refill() {
    if (pos_ + 8 <= n_) {
      uint64_t word;
      std::memcpy(&word, in_ + pos_, 8);      // little-endian host
      bits_ |= word << nbits_;
      pos_ += (63 - nbits_) >> 3;
      nbits_ |= 56;
      return;
    }
    while (nbits_ <= 56) {
      const uint64_t b = pos_ < n_ ? in_[pos_] : 0;
      ++pos_;
      bits_ |= b << nbits_;
      nbits_ += 8;
    }
    check_overrun();
  }
  void check_overrun() const {
    if (pos_ * 8 - nbits_ > n_ * 8) corrupt("deflate stream truncated");
  }
  inline uint32_t take(int k) {
    const uint32_t v = uint32_t(bits_ & ((uint64_t(1) << k) - 1));
    bits_ >>= k;
    nbits_ -= k;
    return v;
  }
  // drops the bits up to a byte boundary and hands the whole bytes left in
  // the buffer back to the input
  void align() {
    take(nbits_ & 7);
    if (pos_ * 8 - nbits_ > n_ * 8) corrupt("deflate stream truncated");
    pos_ -= nbits_ >> 3;
    bits_ = 0;
    nbits_ = 0;
  }
  inline uint32_t decode(const std::vector<uint32_t>& table, int primary) {
    uint32_t e = table[bits_ & ((1u << primary) - 1)];
    if (((e >> 8) & 3) == kLink) {
      take(primary);
      e = table[(e >> 16) + (bits_ & ((1u << (e & 255)) - 1))];
    }
    if (((e >> 8) & 3) != kSymbol) corrupt("invalid Huffman code");
    take(e & 255);
    return e >> 16;
  }

  void stored() {
    align();
    if (pos_ + 4 > n_) corrupt("stored block truncated");
    const uint32_t len = in_[pos_] | in_[pos_ + 1] << 8;
    const uint32_t nlen = in_[pos_ + 2] | in_[pos_ + 3] << 8;
    if (len != (~nlen & 0xffffu)) corrupt("stored block length check failed");
    pos_ += 4;
    if (pos_ + len > n_) corrupt("stored block truncated");
    if (len > cap_ - len_) corrupt("deflate data longer than expected");
    std::memcpy(out_ + len_, in_ + pos_, len);
    len_ += len;
    pos_ += len;
  }

  void fixed_tables() {
    if (fixed_lit_.empty()) {
      uint8_t lens[288];
      std::fill(lens, lens + 144, 8);
      std::fill(lens + 144, lens + 256, 9);
      std::fill(lens + 256, lens + 280, 7);
      std::fill(lens + 280, lens + 288, 8);
      build_table(lens, 288, kLitBits, false, &fixed_lit_,
                  "literal/length code");
      uint8_t dl[32];                         // 30 and 31 decode, then fail
      std::fill(dl, dl + 32, 5);
      build_table(dl, 32, kDistBits, false, &fixed_dist_, "distance code");
    }
    lit_ = &fixed_lit_;
    dist_ = &fixed_dist_;
  }

  void dynamic_tables() {
    const int nlit = take(5) + 257, ndist = take(5) + 1, ncl = take(4) + 4;
    if (nlit > 286 || ndist > 30)
      corrupt("too many literal/length or distance codes");
    uint8_t cl[19] = {0};
    for (int i = 0; i < ncl; ++i) {
      if (i % 8 == 0) refill();
      cl[kClOrder[i]] = uint8_t(take(3));
    }
    build_table(cl, 19, 7, true, &cl_table_, "code length code");
    uint8_t lens[286 + 30] = {0};
    for (int i = 0; i < nlit + ndist;) {
      refill();
      const uint32_t sym = decode(cl_table_, 7);
      if (sym < 16) {
        lens[i++] = uint8_t(sym);
        continue;
      }
      int rep, value = 0;
      if (sym == 16) {
        if (i == 0) corrupt("repeat of a code length with none before it");
        value = lens[i - 1];
        rep = 3 + take(2);
      } else if (sym == 17) {
        rep = 3 + take(3);
      } else {
        rep = 11 + take(7);
      }
      if (i + rep > nlit + ndist) corrupt("code lengths overflow");
      std::fill(lens + i, lens + i + rep, uint8_t(value));
      i += rep;
    }
    if (!lens[256]) corrupt("no code for the end of a block");
    build_table(lens, nlit, kLitBits, false, &dyn_lit_,
                "literal/length code");
    build_table(lens + nlit, ndist, kDistBits, false, &dyn_dist_,
                "distance code");
    lit_ = &dyn_lit_;
    dist_ = &dyn_dist_;
  }

  void codes() {
    const std::vector<uint32_t>& lit = *lit_;
    const std::vector<uint32_t>& dist = *dist_;
    for (;;) {
      refill();
      const uint32_t sym = decode(lit, kLitBits);
      if (sym < 256) {
        if (len_ == cap_) corrupt("deflate data longer than expected");
        out_[len_++] = uint8_t(sym);
        continue;
      }
      if (sym == 256) return;
      if (sym > 285) corrupt("invalid literal/length symbol");
      // at most 15 + 5 + 15 + 13 bits since the refill: no refill needed
      const uint32_t length = kLenBase[sym - 257] + take(kLenExtra[sym - 257]);
      const uint32_t dsym = decode(dist, kDistBits);
      if (dsym > 29) corrupt("invalid distance symbol");
      const uint32_t d = kDistBase[dsym] + take(kDistExtra[dsym]);
      if (d > len_) corrupt("distance beyond the start of the data");
      if (length > cap_ - len_) corrupt("deflate data longer than expected");
      uint8_t* dst = out_ + len_;
      const uint8_t* src = dst - d;
      if (d >= 8 && cap_ - len_ >= length + 8) {
        // 8 bytes a step; each read lies at least 8 bytes behind the write,
        // so it reads bytes already written; the last step may write up to
        // 7 bytes past the match, which later data overwrites
        uint8_t* end = dst + length;
        do {
          std::memcpy(dst, src, 8);
          dst += 8;
          src += 8;
        } while (dst < end);
      } else if (d == 1) {
        std::memset(dst, *src, length);
      } else {
        for (uint32_t k = 0; k < length; ++k) dst[k] = src[k];
      }
      len_ += length;
    }
  }

  static uint32_t adler32(const uint8_t* p, size_t n) {
    uint32_t a = 1, b = 0;
    while (n) {
      size_t k = std::min<size_t>(n, 5552);   // no overflow before the mod
      n -= k;
      while (k--) {
        a += *p++;
        b += a;
      }
      a %= 65521;
      b %= 65521;
    }
    return b << 16 | a;
  }

  const uint8_t* in_;
  size_t n_, pos_ = 0;
  uint64_t bits_ = 0;
  int nbits_ = 0;
  uint8_t* out_;
  size_t cap_, len_ = 0;
  const std::vector<uint32_t>* lit_ = nullptr;
  const std::vector<uint32_t>* dist_ = nullptr;
  std::vector<uint32_t> fixed_lit_, fixed_dist_, dyn_lit_, dyn_dist_,
      cl_table_;
};

// ------------------------------------------------------------------- PNG ---

const uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

// CRC-32 of PNG chunks (ISO 3309), eight bytes a step ("slicing by 8")
uint32_t crc32(const uint8_t* p, size_t n) {
  static const std::vector<uint32_t> table = [] {
    std::vector<uint32_t> t(8 * 256);
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int k = 1; k < 8; ++k)
        t[k * 256 + i] = (t[(k - 1) * 256 + i] >> 8) ^ t[t[(k - 1) * 256 + i] & 255];
    return t;
  }();
  const uint32_t* t = table.data();
  uint32_t c = 0xffffffffu;
  for (; n >= 8; n -= 8, p += 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);                   // little-endian host
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = t[7 * 256 + (lo & 255)] ^ t[6 * 256 + ((lo >> 8) & 255)] ^
        t[5 * 256 + ((lo >> 16) & 255)] ^ t[4 * 256 + (lo >> 24)] ^
        t[3 * 256 + (hi & 255)] ^ t[2 * 256 + ((hi >> 8) & 255)] ^
        t[1 * 256 + ((hi >> 16) & 255)] ^ t[hi >> 24];
  }
  for (; n; --n) c = t[(c ^ *p++) & 255] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

inline uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | p[1] << 16 | p[2] << 8 | p[3];
}

// the Paeth predictor of a (left), b (above), c (upper left): the one
// nearest a + b - c, ties going to a, then b
inline int paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c);
  const int pc = std::abs(a + b - 2 * c);
  const int near = pb < pa ? b : a, dist = pb < pa ? pb : pa;
  return pc < dist ? c : near;
}

// a Paeth-filtered row of BPP-byte pixels after its first pixel: the left
// and upper-left samples stay in registers, so each sample's dependency on
// the one before it does not go through memory
template <int BPP>
void paeth_row(uint8_t* x, const uint8_t* prev, size_t row) {
  int a[BPP], c[BPP];
  for (int k = 0; k < BPP; ++k) {
    a[k] = x[k];
    c[k] = prev[k];
  }
  for (size_t i = BPP; i + BPP <= row; i += BPP)
    for (int k = 0; k < BPP; ++k) {
      const int b = prev[i + k];
      a[k] = uint8_t(x[i + k] + paeth(a[k], b, c[k]));
      x[i + k] = uint8_t(a[k]);
      c[k] = b;
    }
}

// Undoes the row filters in place: raw holds h rows of 1 + row bytes, each
// led by its filter type; the bytes of row r end up at raw + r * (1 + row)
// + 1. bpp is the filters' pixel: the bytes of a pixel (1, 2, 3, 4, 6 or
// 8), 1 below 8 bits a pixel. The row above the first is zeros.
void unfilter(uint8_t* raw, int h, size_t row, int bpp) {
  const std::vector<uint8_t> zeros(row, 0);
  const uint8_t* prev = zeros.data();
  const size_t a0 = std::min<size_t>(bpp, row);
  for (int r = 0; r < h; ++r) {
    uint8_t* line = raw + size_t(r) * (row + 1);
    uint8_t* x = line + 1;
    switch (line[0]) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < row; ++i) x[i] = uint8_t(x[i] + x[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < row; ++i) x[i] = uint8_t(x[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < a0; ++i) x[i] = uint8_t(x[i] + (prev[i] >> 1));
        for (size_t i = bpp; i < row; ++i)
          x[i] = uint8_t(x[i] + ((x[i - bpp] + prev[i]) >> 1));
        break;
      case 4:   // with no pixel to the left, Paeth predicts the one above
        for (size_t i = 0; i < a0; ++i) x[i] = uint8_t(x[i] + prev[i]);
        if (bpp == 1) paeth_row<1>(x, prev, row);
        else if (bpp == 2) paeth_row<2>(x, prev, row);
        else if (bpp == 3) paeth_row<3>(x, prev, row);
        else if (bpp == 4) paeth_row<4>(x, prev, row);
        else if (bpp == 6) paeth_row<6>(x, prev, row);
        else paeth_row<8>(x, prev, row);
        break;
      default:
        corrupt("PNG row filter " + std::to_string(line[0]) +
                " (0-4 defined)");
    }
    prev = x;
  }
}

// Adam7's seven passes: first column, first row, column step, row step
const uint32_t kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                               {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                               {0, 1, 1, 2}};

// a sub-image of the filtered data: the whole image, or an Adam7 pass
struct Pass {
  uint32_t x0, y0, dx, dy;                    // where its pixels go
  uint32_t w, h;
  uint64_t row;                               // bytes of a row, filter byte not
  uint64_t offset;                            // of its first row in the data
};

// whether the PNG specification defines `depth` for colour type `ctype`
bool legal_depth(int ctype, int depth) {
  if (depth == 8) return true;
  if (depth == 16) return ctype != 3;
  return (depth == 1 || depth == 2 || depth == 4) && (ctype == 0 || ctype == 3);
}

// the i-th sample of a row of DEPTH-bit samples, as libpng's transforms
// leave it: 16 bits cut to their high byte (png_set_strip_16); below 8
// bits the value itself (a palette index; grey is scaled by the caller)
template <int DEPTH>
inline int sample(const uint8_t* s, size_t i) {
  if constexpr (DEPTH == 16) {
    return s[2 * i];
  } else if constexpr (DEPTH == 8) {
    return s[i];
  } else {
    const size_t bit = i * DEPTH;
    return (s[bit >> 3] >> (8 - DEPTH - (bit & 7))) & ((1 << DEPTH) - 1);
  }
}

// one row of a pass, n pixels of `channels` samples, into BGR pixels `step`
// bytes apart: grey replicated (below 8 bits scaled to 0-255, as
// png_set_expand_gray_1_2_4_to_8), palettes looked up, alpha dropped
template <int DEPTH>
void emit_row(const uint8_t* s, uint32_t n, int ctype, int channels,
              const std::vector<uint8_t>& palette, uint8_t* o, size_t step) {
  const size_t npal = palette.size() / 3;
  for (uint32_t x = 0; x < n; ++x, o += step) {
    const size_t i = size_t(x) * channels;
    if (ctype == 3) {
      const int v = sample<DEPTH>(s, i);
      if (size_t(v) >= npal) corrupt("palette index beyond PLTE");
      const uint8_t* c = palette.data() + 3 * size_t(v);
      o[0] = c[2];
      o[1] = c[1];
      o[2] = c[0];
    } else if (ctype == 0 || ctype == 4) {
      int v = sample<DEPTH>(s, i);
      if constexpr (DEPTH < 8) v *= 255 / ((1 << DEPTH) - 1);
      o[0] = o[1] = o[2] = uint8_t(v);
    } else {
      o[0] = uint8_t(sample<DEPTH>(s, i + 2));
      o[1] = uint8_t(sample<DEPTH>(s, i + 1));
      o[2] = uint8_t(sample<DEPTH>(s, i));
    }
  }
}

// PNG bytes -> BGR, as i2vsgg_tpu_torch/data/image_io.py::decode_png reads
// them and as the JAX package's libpng transforms leave them: every colour
// type at every bit depth the specification defines (grey 1, 2, 4, 8, 16;
// palette 1, 2, 4, 8; RGB, grey + alpha and RGBA 8, 16), non-interlaced or
// Adam7; 16 bits cut to the high byte, grey below 8 bits scaled, grey
// replicated, palettes expanded, alpha and tRNS dropped.
Image decode_png(const uint8_t* d, size_t n) {
  static const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
  bool header = false, palette_seen = false, end = false;
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, comp = 0, filt = 0, interlace = 0;
  std::vector<uint8_t> palette, idat;
  size_t pos = 8;
  while (pos + 12 <= n) {
    const uint32_t length = be32(d + pos);
    const uint8_t* type = d + pos + 4;
    const std::string name(reinterpret_cast<const char*>(type), 4);
    if (length > n - pos - 12) corrupt("truncated PNG chunk " + name);
    const uint8_t* body = d + pos + 8;
    if (crc32(type, length + 4) != be32(body + length))
      corrupt("bad CRC in PNG chunk " + name);
    if (name == "IHDR") {
      if (length != 13) corrupt("PNG IHDR of " + std::to_string(length) +
                                " bytes (13 defined)");
      w = be32(body);
      h = be32(body + 4);
      depth = body[8];
      ctype = body[9];
      comp = body[10];
      filt = body[11];
      interlace = body[12];
      header = true;
    } else if (name == "PLTE") {
      if (length % 3) corrupt("PNG PLTE not a whole number of entries");
      palette.assign(body, body + length);
      palette_seen = true;
    } else if (name == "IDAT") {
      idat.insert(idat.end(), body, body + length);
    } else if (name == "IEND") {
      end = true;
      break;
    }
    pos += 12 + size_t(length);
  }
  if (!end) corrupt("PNG without IEND");
  if (!header) corrupt("PNG without IHDR");
  if (ctype > 6 || !kChannels[ctype])
    corrupt("PNG colour type " + std::to_string(ctype) + " is not defined");
  if (!legal_depth(ctype, depth))
    corrupt("PNG bit depth " + std::to_string(depth) +
            " is not defined for colour type " + std::to_string(ctype));
  if (interlace > 1)
    corrupt("PNG interlace method " + std::to_string(interlace) +
            " is not defined");
  if (comp || filt)
    corrupt("PNG compression " + std::to_string(comp) + " / filter method " +
            std::to_string(filt) + " is not defined");
  if (!w || !h || w > 0x7fffffffu || h > 0x7fffffffu)
    corrupt("PNG of " + std::to_string(h) + " x " + std::to_string(w) +
            " pixels");
  const int channels = kChannels[ctype];
  const int bits = channels * depth;          // of a pixel
  const int fbpp = bits < 8 ? 1 : bits / 8;   // the filters' pixel, bytes
  std::vector<Pass> passes;
  uint64_t raw_size = 0;
  for (int p = 0; p < (interlace ? 7 : 1); ++p) {
    Pass ps{0, 0, 1, 1, w, h, 0, raw_size};
    if (interlace) {
      ps.x0 = kAdam7[p][0];
      ps.y0 = kAdam7[p][1];
      ps.dx = kAdam7[p][2];
      ps.dy = kAdam7[p][3];
      ps.w = w > ps.x0 ? (w - ps.x0 + ps.dx - 1) / ps.dx : 0;
      ps.h = h > ps.y0 ? (h - ps.y0 + ps.dy - 1) / ps.dy : 0;
    }
    if (!ps.w || !ps.h) continue;             // an empty pass has no rows
    ps.row = (uint64_t(ps.w) * bits + 7) / 8;
    raw_size += uint64_t(ps.h) * (ps.row + 1);
    passes.push_back(ps);
  }
  if (raw_size > (uint64_t(1) << 34) || uint64_t(h) * w * 3 > (uint64_t(1) << 34))
    corrupt("PNG of " + std::to_string(h) + " x " + std::to_string(w) +
            " pixels is too large");
  // deflate expands its input at most 1032 times (a 258-byte match in two
  // bits), so a header the stream cannot fill is refused before the
  // buffers are allocated
  if (raw_size > uint64_t(idat.size()) * 1032 + 64)
    corrupt("PNG data of " + std::to_string(idat.size()) +
            " compressed bytes cannot hold the " + std::to_string(raw_size) +
            " expected");
  std::vector<uint8_t> raw(raw_size);
  const size_t got =
      Inflater(idat.data(), idat.size(), raw.data(), raw.size()).run();
  if (got != raw_size)
    corrupt("PNG data holds " + std::to_string(got) + " bytes, " +
            std::to_string(raw_size) + " expected");
  for (const Pass& ps : passes)
    unfilter(raw.data() + ps.offset, int(ps.h), size_t(ps.row), fbpp);
  Image im;
  im.h = int(h);
  im.w = int(w);
  im.bgr.resize(size_t(h) * w * 3);
  if (ctype == 3 && !palette_seen) corrupt("palette PNG without PLTE");
  // each pass's rows (where not interlaced, the image's) scattered to
  // their pixels
  for (const Pass& ps : passes)
    for (uint32_t r = 0; r < ps.h; ++r) {
      const uint8_t* s = raw.data() + ps.offset + r * (ps.row + 1) + 1;
      uint8_t* o = im.bgr.data() +
                   (size_t(ps.y0 + r * ps.dy) * w + ps.x0) * 3;
      const size_t step = size_t(ps.dx) * 3;
      switch (depth) {
        case 1: emit_row<1>(s, ps.w, ctype, channels, palette, o, step); break;
        case 2: emit_row<2>(s, ps.w, ctype, channels, palette, o, step); break;
        case 4: emit_row<4>(s, ps.w, ctype, channels, palette, o, step); break;
        case 8: emit_row<8>(s, ps.w, ctype, channels, palette, o, step); break;
        default: emit_row<16>(s, ps.w, ctype, channels, palette, o, step);
      }
    }
  return im;
}

// ----------------------------------------------------------------- files ---

std::vector<uint8_t> read_file(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    const int e = errno;
    fail(e == ENOENT ? kNotFound : kOsError, std::strerror(e));
  }
  std::vector<uint8_t> data;
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    data.insert(data.end(), chunk, chunk + got);
  const bool bad = std::ferror(f);
  const int e = errno;
  std::fclose(f);
  if (bad) fail(kOsError, std::string("read failed: ") + std::strerror(e));
  return data;
}

Image decode_jpeg(const std::vector<uint8_t>& data) {
  char err[256];
  int h = 0, w = 0, nc = 0;
  int rc = i2v_jpeg_info(data.data(), data.size(), &h, &w, &nc, err,
                         sizeof(err));
  Image im;
  if (!rc) {
    im.h = h;
    im.w = w;
    im.bgr.resize(size_t(h) * w * 3);
    rc = i2v_jpeg_decode(data.data(), data.size(), im.bgr.data(),
                         im.bgr.size(), err, sizeof(err));
  }
  if (rc) fail(rc == 1 ? kUnsupported : kCorrupt, err);   // jpeg.cc's codes
  return im;
}

// Decodes the file by its magic bytes: PNG, or JPEG without the EXIF
// orientation (as the JAX package's runtime decodes it with libjpeg).
Image decode_file(const char* path) {
  const std::vector<uint8_t> data = read_file(path);
  if (data.size() >= 8 && !std::memcmp(data.data(), kPngSignature, 8))
    return decode_png(data.data(), data.size());
  if (data.size() >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg(data);
  fail(kUnsupported,
       "not a PNG or JPEG file; the port decodes PNG and JPEG only");
}

void report(const Failure& f, char* err, int err_len) {
  if (err && err_len > 0) std::snprintf(err, err_len, "%s", f.what.c_str());
}

template <typename F>
int guarded(char* err, int err_len, F&& body) {
  try {
    body();
  } catch (const Failure& f) {
    report(f, err, err_len);
    return f.code;
  } catch (const std::bad_alloc&) {
    report({kCorrupt, "out of memory decoding the image"}, err, err_len);
    return kCorrupt;
  } catch (const std::exception& e) {
    report({kCorrupt, e.what()}, err, err_len);
    return kCorrupt;
  }
  if (err && err_len > 0) err[0] = 0;
  return kOk;
}

// ---------------------------------------------------------- resize + pad ---
// Copied from the JAX package's runtime operation for operation: the f32
// scale and rounded sizes, the resized size clamped to the pad (an image
// that does not fit is squashed, not cropped), the clamped half-pixel
// source map, the flip applied to the source columns, the u8 values
// interpolated and the means subtracted last.

void preprocess_one(const Image& im, bool flip, const float* means,
                    int target_size, int pad_h, int pad_w,
                    float* out /* pad_h*pad_w*3 */, float* out_scale,
                    int32_t* out_hw) {
  const int h = im.h, w = im.w;
  const float scale = float(target_size) / float(std::min(h, w));
  int rh = int(std::lround(h * scale));
  int rw = int(std::lround(w * scale));
  rh = std::min(rh, pad_h);
  rw = std::min(rw, pad_w);
  *out_scale = scale;
  out_hw[0] = rh;
  out_hw[1] = rw;

  const float sy = float(h) / float(rh);
  const float sx = float(w) / float(rw);
  std::vector<int> x0s(rw), x1s(rw);
  std::vector<float> fxs(rw);
  for (int x = 0; x < rw; ++x) {
    float src = (x + 0.5f) * sx - 0.5f;
    src = std::max(0.0f, std::min(src, float(w - 1)));
    int x0 = int(src);
    x0s[x] = std::min(x0, w - 1);
    x1s[x] = std::min(x0 + 1, w - 1);
    fxs[x] = src - float(x0);
  }
  for (int y = 0; y < rh; ++y) {
    float srcy = (y + 0.5f) * sy - 0.5f;
    srcy = std::max(0.0f, std::min(srcy, float(h - 1)));
    int y0 = std::min(int(srcy), h - 1);
    int y1 = std::min(y0 + 1, h - 1);
    float fy = srcy - float(y0);
    const uint8_t* r0 = im.bgr.data() + size_t(y0) * w * 3;
    const uint8_t* r1 = im.bgr.data() + size_t(y1) * w * 3;
    float* dst = out + (size_t(y) * pad_w) * 3;
    for (int x = 0; x < rw; ++x) {
      int sx0 = x0s[x], sx1 = x1s[x];
      if (flip) {                 // flip source column lookup
        sx0 = w - 1 - sx0;
        sx1 = w - 1 - sx1;
      }
      const float fx = fxs[x];
      for (int c = 0; c < 3; ++c) {
        const float v00 = r0[sx0 * 3 + c], v01 = r0[sx1 * 3 + c];
        const float v10 = r1[sx0 * 3 + c], v11 = r1[sx1 * 3 + c];
        const float top = v00 + (v01 - v00) * fx;
        const float bot = v10 + (v11 - v10) * fx;
        dst[x * 3 + c] = top + (bot - top) * fy - means[c];
      }
    }
  }
}

// Runs body(i) for i in [0, n) on min(n_threads, n) threads, the calling
// thread one of them.
template <typename F>
void parallel_for(int n, int n_threads, F&& body) {
  std::atomic<int> next(0);
  auto work = [&]() {
    for (int i; (i = next.fetch_add(1)) < n;) body(i);
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < std::max(1, std::min(n_threads, n)); ++t)
    pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// Decodes and preprocesses a batch of image files on n_threads threads.
// out_images must be zero-initialized by the caller (the padding stays 0).
// An image that fails gets its code in out_codes[i], its message in
// errs + i * err_len and a scale of 0. Returns the number that failed.
int i2v_load_batch(const char** paths, const uint8_t* flips, int n,
                   const float* pixel_means, int target_size, int pad_h,
                   int pad_w, float* out_images, float* out_scales,
                   int32_t* out_hw, int n_threads, int32_t* out_codes,
                   char* errs, int err_len) {
  std::atomic<int> failed(0);
  parallel_for(n, n_threads, [&](int i) {
    out_codes[i] = guarded(errs + size_t(i) * err_len, err_len, [&] {
      Image im = decode_file(paths[i]);
      if (im.h < 2 || im.w < 2)
        fail(kArgument, "an image of " + std::to_string(im.h) + " x " +
                            std::to_string(im.w) +
                            " pixels; the loader needs at least 2 x 2");
      preprocess_one(im, flips[i] != 0, pixel_means, target_size, pad_h,
                     pad_w, out_images + size_t(i) * pad_h * pad_w * 3,
                     out_scales + i, out_hw + i * 2);
    });
    if (out_codes[i]) {
      failed.fetch_add(1);
      out_scales[i] = 0.0f;
      out_hw[i * 2] = 0;
      out_hw[i * 2 + 1] = 0;
    }
  });
  return failed.load();
}

// Packs f32 NHWC images into conv1 parity planes (the host-planes serving
// input): out[b][py][px][c][i][j] = bf16(in[b][2i+py-3][2j+px-3][c]), with
// zeros outside the image (the implicit pad 3 of the 7x7 stride-2 conv),
// f32 -> bf16 rounded to nearest even, as the JAX package's runtime packs
// them. Every element of out ((b, 2, 2, 3, hq, wq) uint16) is written, the
// zeros too, so the caller need not clear it.
int i2v_pack_planes(const float* in, int b, int h, int w, int hq, int wq,
                    uint16_t* out, int n_threads) {
  // one task a band of kPackRows plane rows of one image: plane row i of
  // parity py is input row 2i+py-3, read once, rounded into a row-sized
  // buffer and scattered to its 6 plane rows (2 px x 3 c); no two tasks
  // write the same row
  constexpr int kPackRows = 8;
  const int bands = (hq + kPackRows - 1) / kPackRows;
  const size_t plane = size_t(hq) * wq;
  parallel_for(b * bands, n_threads, [&](int task) {
    const int bi = task / bands, i0 = (task % bands) * kPackRows;
    std::vector<uint16_t> tmp(size_t(w) * 3);
    const float* src = in + size_t(bi) * h * w * 3;
    uint16_t* obase = out + size_t(bi) * 12 * plane;
    for (int i = i0; i < std::min(hq, i0 + kPackRows); ++i) {
      for (int py = 0; py < 2; ++py) {
        const int r = 2 * i + py - 3;
        if (r < 0 || r >= h) {
          for (int k = 0; k < 6; ++k)
            std::memset(obase + (py * 6 + k) * plane + size_t(i) * wq, 0,
                        size_t(wq) * sizeof(uint16_t));
          continue;
        }
        const uint32_t* rowu =
            reinterpret_cast<const uint32_t*>(src + size_t(r) * w * 3);
        for (int k = 0; k < w * 3; ++k) {
          const uint32_t x = rowu[k];
          tmp[k] = (uint16_t)((x + 0x7fffu + ((x >> 16) & 1u)) >> 16);
        }
        for (int px = 0; px < 2; ++px) {
          // columns 2j+px-3 in [0, w) -> j in [(4-px)/2, (w+2-px)/2]
          const int j0 = (3 - px + 1) / 2;
          const int j1 = std::min((w - 1 + 3 - px) / 2, wq - 1);
          for (int c = 0; c < 3; ++c) {
            uint16_t* drow =
                obase + ((py * 2 + px) * 3 + c) * plane + size_t(i) * wq;
            const uint16_t* p = tmp.data() + (2 * j0 + px - 3) * 3 + c;
            int j = 0;
            for (; j < j0; ++j) drow[j] = 0;
            for (; j <= j1; ++j, p += 6) drow[j] = *p;
            for (; j < wq; ++j) drow[j] = 0;
          }
        }
      }
    }
  });
  return 0;
}

// Decodes one file. Writes (h, w) to out_hw and, in *out, the h * w * 3
// BGR bytes, allocated here and freed by i2v_free; returns 0, or an error
// code with its message in err (and *out left null).
int i2v_decode(const char* path, uint8_t** out, int32_t* out_hw, char* err,
               int err_len) {
  *out = nullptr;
  return guarded(err, err_len, [&] {
    Image im = decode_file(path);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(im.bgr.size()));
    if (!buf) throw std::bad_alloc();
    std::memcpy(buf, im.bgr.data(), im.bgr.size());
    out_hw[0] = im.h;
    out_hw[1] = im.w;
    *out = buf;
  });
}

void i2v_free(uint8_t* p) { std::free(p); }

}  // extern "C"
