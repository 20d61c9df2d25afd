// Host decoders for the raster formats the port opens besides TIFF and
// netCDF, where the JAX package opens them through Pillow 12.1: the JPEG
// decoder of libjpeg-turbo as Pillow drives it, the GIF LZW decoder and the
// BMP RLE decoder. Built at first use by sarpro_tpu_torch._native and bound
// with ctypes (a plain C interface, no Python or PyTorch headers).
//
// JPEG, to the bytes Pillow's decode gives (its defaults: JDCT_ISLOW, fancy
// upsampling, no merged upsampler, block smoothing while coefficient bits
// are missing):
//   * baseline and extended Huffman (SOF0 / SOF1), progressive Huffman
//     (SOF2), arithmetic sequential (SOF9) and progressive (SOF10) scans,
//     interleaved or not, with restart intervals, sampling factors 1..4, 1,
//     3 or 4 components at 8 bits, and DAC conditioning;
//   * jdhuff.c / jdphuff.c's decoding, including the bit buffer that stops
//     at a marker and pads with zero bits, the restart resync and the
//     "insufficient data" rule that leaves the rest of a segment at zero;
//   * jdarith.c's decoding (T.81 Annex D's coder with libjpeg's registers,
//     Annex F's statistics), zero data fed past a marker, and the "bad
//     arithmetic code" rule that leaves the rest of a restart interval at
//     zero;
//   * jdcoefct.c's block smoothing of libjpeg-turbo 2.1 and later (ten
//     saved coefficients, the DC-only branch over 5 x 5 block DCs);
//   * lossless frames (SOF3: jdlhuff.c, jddiffct.c, jdlossls.c): predictors
//     1-7, the point transform, restarts, replicated upsampling, and only
//     gray, RGB or CMYK samples (libjpeg converts no colour there);
//   * libjpeg-turbo's x86-64 SIMD islow IDCT (jidctint.c's arithmetic in
//     16-bit lanes, which parts from jidctint.c on corrupt data only);
//   * jdsample.c's upsamplers: h2v1 and h2v2 triangle filters (widths over
//     2), h1v2, and replication for the other integral factors;
//   * jdcolor.c's fixed-point YCbCr -> RGB and YCCK -> CMYK.
// Pillow hands libjpeg the file 64 KiB at a time, and jdarith.c cannot
// wait for more: arithmetic-coded data past the block Pillow has read is
// refused, as Pillow refuses it ("broken data stream"). Lossless arithmetic
// (SOF11) and hierarchical frames, and 12-bit samples, are refused (the
// caller raises RasterError with the message).
//
// GIF: the LZW stream of one frame (Pillow's GifDecode.c: clear and end
// codes, code size to 12 bits, interlaced rows in four passes).
// BMP: RLE8 / RLE4 as Pillow's BmpRleDecoder (PIL/BmpImagePlugin.py)
// expands them, quirks included.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct DecodeError {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw DecodeError{what}; }

void set_error(char* err, int64_t errcap, const std::string& what) {
  if (err == nullptr || errcap <= 0) return;
  const size_t n = std::min<size_t>(what.size(), static_cast<size_t>(errcap - 1));
  std::memcpy(err, what.data(), n);
  err[n] = 0;
}

// zigzag position k -> natural (row-major) index; the extra entries catch
// k past 63 in corrupt data (jutils.c's jpeg_natural_order)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jstdhuff.c: the tables libjpeg-turbo puts in slots 0 and 1 before any DHT
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50,
    129, 145, 161, 8, 35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98, 114,
    130, 9, 10, 22, 23, 24, 25, 26, 37, 38, 39, 40, 41, 42, 52, 53, 54, 55,
    56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86, 87, 88, 89,
    90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120,
    121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149,
    150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170,
    178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197, 198,
    199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 225,
    226, 227, 228, 229, 230, 231, 232, 233, 234, 241, 242, 243, 244, 245,
    246, 247, 248, 249, 250};
const uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
    0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50,
    129, 8, 20, 66, 145, 161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114,
    209, 10, 22, 36, 52, 225, 37, 241, 23, 24, 25, 26, 38, 39, 40, 41, 42,
    53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86,
    87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117,
    118, 119, 120, 121, 122, 130, 131, 132, 133, 134, 135, 136, 137, 138,
    146, 147, 148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166,
    167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194,
    195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215,
    216, 217, 218, 226, 227, 228, 229, 230, 231, 232, 233, 234, 242, 243,
    244, 245, 246, 247, 248, 249, 250};

// A Huffman table as defined (BITS, HUFFVAL), and jdhuff.c's derived form.
struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  // derived (jpeg_make_d_derived_tbl)
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  int look_nbits[256] = {};  // 0: the code is longer than 8 bits
  uint8_t look_sym[256] = {};
};

// `max_dc`: the largest DC symbol allowed (15, 16 in a lossless frame), or
// -1 for an AC table
void derive(HuffTable& t, int max_dc) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = t.bits[l];
    if (p + i > 256) fail("bad Huffman table");
    while (i--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  const int numsymbols = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if (code >= (1u << si)) fail("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t.bits[l]) {
      t.valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += t.bits[l];
      t.maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.look_nbits, 0, sizeof(t.look_nbits));
  p = 0;
  for (int l = 1; l <= 8; l++) {
    for (int i = 1; i <= t.bits[l]; i++, p++) {
      int lookbits = static_cast<int>(huffcode[p]) << (8 - l);
      for (int ctr = 1 << (8 - l); ctr > 0; ctr--) {
        t.look_nbits[lookbits] = l;
        t.look_sym[lookbits] = t.vals[p];
        lookbits++;
      }
    }
  }
  if (max_dc >= 0) {
    for (int i = 0; i < numsymbols; i++)
      if (t.vals[i] > max_dc) fail("bad Huffman table");
  }
}

void set_table(HuffTable& t, const uint8_t* bits, const uint8_t* vals) {
  std::memcpy(t.bits, bits, 17);
  int n = 0;
  for (int l = 1; l <= 16; l++) n += bits[l];
  std::memcpy(t.vals, vals, n);
  t.defined = true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, index = 0;
  int dw = 0, dh = 0;  // downsampled width / height (samples)
  int wb = 0, hb = 0;  // width / height in blocks (in samples, lossless)
  int bw = 0, bh = 0;  // blocks allocated (MCU-padded)
  std::vector<int16_t> coef;
  int16_t quant[64] = {};
  bool latched = false;
  int coef_bits[64];
  // jdphuff.c / jdarith.c: coef_bits[1..9] as they were before this
  // component's latest scan (cinfo->coef_bits[ci + num_components])
  int prev_coef_bits[10] = {};
  int dc_tbl = 0, ac_tbl = 0;
  int last_dc = 0, dc_context = 0;
  // lossless: the next row undifferenced is a first row (jdlossls.c)
  bool first_row = true;
  std::vector<int> undiff_prev;  // lossless: the row above, undifferenced
  std::vector<uint8_t> plane;    // the samples, `stride` bytes a row
  size_t stride = 0;
};

constexpr int kMinGetBits = 57;  // jdhuff.h on a 64-bit bit buffer

// jdhuff.c's bit reader over the whole file in memory. Running out of bytes
// where libjpeg would ask its source for more is a truncated file: Pillow
// then raises "image file is truncated".
struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t buf = 0;
  int bits = 0;
  int marker = 0;  // the marker that ended the data (libjpeg's unread_marker)
  bool* insufficient = nullptr;

  uint8_t byte() {
    if (pos >= n) fail("image file is truncated");
    return d[pos++];
  }

  void fill(int nbits) {
    if (marker == 0) {
      while (bits < kMinGetBits) {
        int c = byte();
        if (c == 0xFF) {
          do {
            c = byte();
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            marker = c;
            break;
          }
        }
        buf = (buf << 8) | static_cast<uint64_t>(c);
        bits += 8;
      }
      if (marker == 0) return;
    }
    if (nbits > bits) {
      *insufficient = true;
      buf <<= kMinGetBits - bits;
      bits = kMinGetBits;
    }
  }

  int get_bits(int nb) {
    if (nb == 0) return 0;
    if (bits < nb) fill(nb);
    bits -= nb;
    return static_cast<int>((buf >> bits) & ((1ull << nb) - 1));
  }

  int peek8() {
    // HUFF_DECODE: fill to the lookahead if possible, without padding
    if (bits < 8) fill(0);
    if (bits < 8) return -1;
    return static_cast<int>((buf >> (bits - 8)) & 0xFF);
  }

  int decode(const HuffTable& t) {
    int look = peek8();
    int l = 1;
    if (look >= 0) {
      int nb = t.look_nbits[look];
      if (nb) {
        bits -= nb;
        return t.look_sym[look];
      }
      l = 9;
    }
    // jpeg_huff_decode: the slow path from `l` bits
    int code = get_bits(l);
    while (l <= 16 && code > t.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      l++;
    }
    if (l > 16) return 0;  // JWRN_HUFF_BAD_CODE: a zero
    return t.vals[static_cast<uint8_t>(code + t.valoffset[l])];
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + static_cast<int>((~0u << s) + 1) : r;
}

// Pillow's ImageFile.load reads the file MAXBLOCK bytes at a time and hands
// libjpeg what it has read; libjpeg suspends for more, except in jdarith.c
// (JERR_CANT_SUSPEND, Pillow's "broken data stream").
constexpr size_t kPillowBlock = 65536;
const char* const kPastBlock = "broken data stream: arithmetic-coded data past the block Pillow has read";

// jaricom.c jpeg_aritab: T.81 Table D.2 as Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS, and libjpeg's entry 113, a fixed 0.5
constexpr int64_t aritab(int64_t qe, int nlps, int nmps, int sw) {
  return (qe << 16) | (nmps << 8) | (sw << 7) | nlps;
}
const int64_t kAritab[114] = {
    aritab(0x5a1d, 1, 1, 1),     aritab(0x2586, 14, 2, 0),    aritab(0x1114, 16, 3, 0),
    aritab(0x080b, 18, 4, 0),    aritab(0x03d8, 20, 5, 0),    aritab(0x01da, 23, 6, 0),
    aritab(0x00e5, 25, 7, 0),    aritab(0x006f, 28, 8, 0),    aritab(0x0036, 30, 9, 0),
    aritab(0x001a, 33, 10, 0),   aritab(0x000d, 35, 11, 0),   aritab(0x0006, 9, 12, 0),
    aritab(0x0003, 10, 13, 0),   aritab(0x0001, 12, 13, 0),   aritab(0x5a7f, 15, 15, 1),
    aritab(0x3f25, 36, 16, 0),   aritab(0x2cf2, 38, 17, 0),   aritab(0x207c, 39, 18, 0),
    aritab(0x17b9, 40, 19, 0),   aritab(0x1182, 42, 20, 0),   aritab(0x0cef, 43, 21, 0),
    aritab(0x09a1, 45, 22, 0),   aritab(0x072f, 46, 23, 0),   aritab(0x055c, 48, 24, 0),
    aritab(0x0406, 49, 25, 0),   aritab(0x0303, 51, 26, 0),   aritab(0x0240, 52, 27, 0),
    aritab(0x01b1, 54, 28, 0),   aritab(0x0144, 56, 29, 0),   aritab(0x00f5, 57, 30, 0),
    aritab(0x00b7, 59, 31, 0),   aritab(0x008a, 60, 32, 0),   aritab(0x0068, 62, 33, 0),
    aritab(0x004e, 63, 34, 0),   aritab(0x003b, 32, 35, 0),   aritab(0x002c, 33, 9, 0),
    aritab(0x5ae1, 37, 37, 1),   aritab(0x484c, 64, 38, 0),   aritab(0x3a0d, 65, 39, 0),
    aritab(0x2ef1, 67, 40, 0),   aritab(0x261f, 68, 41, 0),   aritab(0x1f33, 69, 42, 0),
    aritab(0x19a8, 70, 43, 0),   aritab(0x1518, 72, 44, 0),   aritab(0x1177, 73, 45, 0),
    aritab(0x0e74, 74, 46, 0),   aritab(0x0bfb, 75, 47, 0),   aritab(0x09f8, 77, 48, 0),
    aritab(0x0861, 78, 49, 0),   aritab(0x0706, 79, 50, 0),   aritab(0x05cd, 48, 51, 0),
    aritab(0x04de, 50, 52, 0),   aritab(0x040f, 50, 53, 0),   aritab(0x0363, 51, 54, 0),
    aritab(0x02d4, 52, 55, 0),   aritab(0x025c, 53, 56, 0),   aritab(0x01f8, 54, 57, 0),
    aritab(0x01a4, 55, 58, 0),   aritab(0x0160, 56, 59, 0),   aritab(0x0125, 57, 60, 0),
    aritab(0x00f6, 58, 61, 0),   aritab(0x00cb, 59, 62, 0),   aritab(0x00ab, 61, 63, 0),
    aritab(0x008f, 61, 32, 0),   aritab(0x5b12, 65, 65, 1),   aritab(0x4d04, 80, 66, 0),
    aritab(0x412c, 81, 67, 0),   aritab(0x37d8, 82, 68, 0),   aritab(0x2fe8, 83, 69, 0),
    aritab(0x293c, 84, 70, 0),   aritab(0x2379, 86, 71, 0),   aritab(0x1edf, 87, 72, 0),
    aritab(0x1aa9, 87, 73, 0),   aritab(0x174e, 72, 74, 0),   aritab(0x1424, 72, 75, 0),
    aritab(0x119c, 74, 76, 0),   aritab(0x0f6b, 74, 77, 0),   aritab(0x0d51, 75, 78, 0),
    aritab(0x0bb6, 77, 79, 0),   aritab(0x0a40, 77, 48, 0),   aritab(0x5832, 80, 81, 1),
    aritab(0x4d1c, 88, 82, 0),   aritab(0x438e, 89, 83, 0),   aritab(0x3bdd, 90, 84, 0),
    aritab(0x34ee, 91, 85, 0),   aritab(0x2eae, 92, 86, 0),   aritab(0x299a, 93, 87, 0),
    aritab(0x2516, 86, 71, 0),   aritab(0x5570, 88, 89, 1),   aritab(0x4ca9, 95, 90, 0),
    aritab(0x44d9, 96, 91, 0),   aritab(0x3e22, 97, 92, 0),   aritab(0x3824, 99, 93, 0),
    aritab(0x32b4, 99, 94, 0),   aritab(0x2e17, 93, 86, 0),   aritab(0x56a8, 95, 96, 1),
    aritab(0x4f46, 101, 97, 0),  aritab(0x47e5, 102, 98, 0),  aritab(0x41cf, 103, 99, 0),
    aritab(0x3c3d, 104, 100, 0), aritab(0x375e, 99, 93, 0),   aritab(0x5231, 105, 102, 0),
    aritab(0x4c0f, 106, 103, 0), aritab(0x4639, 107, 104, 0), aritab(0x415e, 103, 99, 0),
    aritab(0x5627, 105, 106, 1), aritab(0x50e7, 108, 107, 0), aritab(0x4b85, 109, 103, 0),
    aritab(0x5597, 110, 109, 0), aritab(0x504f, 111, 107, 0), aritab(0x5a10, 110, 111, 1),
    aritab(0x5522, 112, 109, 0), aritab(0x59eb, 112, 111, 1), aritab(0x5a1d, 113, 113, 0)};

// jdarith.c's coder: C holds the interval's base and the bits read ahead,
// CT counts those bits (-16 before the first two bytes, -1 after a bad
// code). Bytes come from the file up to `limit`, the end of what Pillow has
// handed over.
struct ArithDecoder {
  const uint8_t* d = nullptr;
  size_t pos = 0, limit = 0;
  int64_t c = 0, a = 0;
  int ct = -16;
  int marker = 0;  // the marker met in the data (libjpeg's unread_marker)

  int get_byte() {
    if (pos >= limit) fail(kPastBlock);
    return d[pos++];
  }

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {  // D.2.6: renormalization and data input
      if (--ct < 0) {
        int data = 0;
        if (marker == 0) {
          data = get_byte();
          if (data == 0xFF) {
            do {
              data = get_byte();
            } while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {  // a marker: zero data from here on
              marker = data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Jpeg {
  const uint8_t* d;
  size_t n;
  size_t pos = 2;
  // the file's bytes Pillow has handed libjpeg so far (whole blocks)
  size_t fed = kPillowBlock;
  bool strict = false;  // in an arithmetic-coded scan: libjpeg cannot wait
  int pending = 0;      // a marker read past, still to handle
  int width = 0, height = 0, precision = 8, sof = -1;
  bool progressive = false, arith = false, lossless = false, have_sof = false;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  uint16_t qt[4][64] = {};
  bool qt_def[4] = {};
  HuffTable dc[4], ac[4];
  // DAC conditioning (jdmarker.c get_soi's defaults)
  uint8_t arith_L[16], arith_U[16], arith_K[16];
  int restart_interval = 0;
  std::vector<Component> comps;
  int max_h = 1, max_v = 1;
  int imcu_rows = 0;  // total_iMCU_rows
  int scans = 0;
  bool multi_scan = false;
  bool insufficient = false;
  int last_good_row = 0;  // jdcoefct.c: last_good_iMCU_row

  Jpeg(const uint8_t* src, size_t len) : d(src), n(len) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    set_table(dc[0], kDcLumBits, kDcVals);
    set_table(dc[1], kDcChrBits, kDcVals);
    set_table(ac[0], kAcLumBits, kAcLumVals);
    set_table(ac[1], kAcChrBits, kAcChrVals);
    for (int t = 0; t < 16; t++) {
      arith_L[t] = 0;
      arith_U[t] = 1;
      arith_K[t] = 5;
    }
  }

  // libjpeg reading through its source manager: past what Pillow has
  // handed over it suspends, and Pillow reads another block (the file's
  // end: "image file is truncated"); inside arithmetic-coded data it cannot
  // suspend.
  void need(size_t last) {
    if (last >= n) fail("image file is truncated");
    if (last >= fed) {
      if (strict) fail(kPastBlock);
      fed = (last / kPillowBlock + 1) * kPillowBlock;
    }
  }
  uint8_t u8() {
    need(pos);
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }
  void skip(size_t k) {
    if (k == 0) return;
    need(pos + k - 1);
    pos += k;
  }

  // jdmarker.c next_marker: skip garbage, then FF fill bytes
  int next_marker() {
    if (pending) {
      int m = pending;
      pending = 0;
      return m;
    }
    for (;;) {
      int c = u8();
      while (c != 0xFF) c = u8();
      do {
        c = u8();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void skip_variable() {
    int len = u16();
    if (len < 2) fail("bad marker length");
    skip(static_cast<size_t>(len - 2));
  }

  void get_app(int m) {
    int len = u16();
    if (len < 2) fail("bad marker length");
    const size_t body = static_cast<size_t>(len - 2);
    if (pos + body > n) fail("image file is truncated");
    const uint8_t* p = d + pos;
    if (m == 0xE0 && body >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xEE && body >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    skip(body);
  }

  void get_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int n_ = u8();
      len--;
      int prec = n_ >> 4, t = n_ & 15;
      if (t >= 4) fail("bad quantization table");
      for (int i = 0; i < 64; i++) {
        int v = prec ? u16() : u8();
        qt[t][kNatural[i]] = static_cast<uint16_t>(v);
      }
      len -= prec ? 128 : 64;
      qt_def[t] = true;
    }
    if (len != 0) fail("bogus DQT marker length");
  }

  void get_dht() {
    int len = u16() - 2;
    while (len > 16) {
      int idx = u8();
      uint8_t bits[17] = {0};
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = u8();
        count += bits[i];
      }
      len -= 17;
      if (count > 256 || count > len) fail("bad Huffman table");
      uint8_t vals[256] = {0};
      for (int i = 0; i < count; i++) vals[i] = u8();
      len -= count;
      bool is_ac = idx & 0x10;
      idx &= 0x0F;
      if (idx >= 4) fail("bad Huffman table index");
      set_table(is_ac ? ac[idx] : dc[idx], bits, vals);
    }
    if (len != 0) fail("bogus DHT marker length");
  }

  // jdmarker.c get_dac: (Tc Tb, Cs) pairs; DC L / U in Cs's nibbles, AC Kx
  void get_dac() {
    int len = u16() - 2;
    while (len > 0) {
      const int index = u8(), val = u8();
      len -= 2;
      if (index >= 32) fail("bogus DAC index " + std::to_string(index));
      if (index >= 16) {
        arith_K[index - 16] = static_cast<uint8_t>(val);
      } else {
        arith_L[index] = static_cast<uint8_t>(val & 15);
        arith_U[index] = static_cast<uint8_t>(val >> 4);
        if (arith_L[index] > arith_U[index]) fail("bogus DAC value 0x" + std::to_string(val));
      }
    }
    if (len != 0) fail("bogus marker length");
  }

  void get_dri() {
    if (u16() != 4) fail("bogus DRI marker length");
    restart_interval = u16();
  }

  // jdmarker.c get_sof: the process (DCT or lossless, Huffman or
  // arithmetic, sequential or progressive) and the frame
  void get_sof(int m) {
    if (have_sof) fail("duplicate SOF marker");
    progressive = m == 0xC2 || m == 0xCA;
    arith = m >= 0xC9;
    lossless = m == 0xC3 || m == 0xCB;
    u16();
    precision = u8();
    height = u16();
    width = u16();
    int nc = u8();
    if (precision != 8) fail("cannot handle " + std::to_string(precision) + "-bit layers");
    if (nc != 1 && nc != 3 && nc != 4)
      fail("cannot handle " + std::to_string(nc) + "-layer images");
    if (width <= 0 || height <= 0) fail("empty JPEG image (DNL not supported)");
    comps.resize(nc);
    for (int i = 0; i < nc; i++) {
      Component& c = comps[i];
      c.index = i;
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bogus sampling factors");
      if (c.tq >= 4) fail("bogus quantization table index");
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    for (auto& c : comps) {
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    // a block is 8 x 8 samples, one sample in a lossless frame
    const int64_t unit = lossless ? 1 : 8;
    const int mcu_cols = static_cast<int>((width + unit * max_h - 1) / (unit * max_h));
    imcu_rows = static_cast<int>((height + unit * max_v - 1) / (unit * max_v));
    for (auto& c : comps) {
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + max_h - 1) / max_h);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + max_v - 1) / max_v);
      c.wb = static_cast<int>((static_cast<int64_t>(width) * c.h + unit * max_h - 1) / (unit * max_h));
      c.hb = static_cast<int>((static_cast<int64_t>(height) * c.v + unit * max_v - 1) / (unit * max_v));
      c.bw = std::max(mcu_cols * c.h, c.wb);
      c.bh = std::max(imcu_rows * c.v, c.hb);
    }
    sof = m;
    have_sof = true;
  }

  // Reads markers up to the frame header (header_only) or to the end of the
  // image data.
  void run(bool header_only) {
    for (;;) {
      int m = next_marker();
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3:
        case 0xC9: case 0xCA: case 0xCB:
          get_sof(m);
          if (header_only) return;
          break;
        case 0xC5: case 0xC6: case 0xC7: case 0xC8:
        case 0xCD: case 0xCE: case 0xCF:
          fail("hierarchical JPEG (SOF type 0x" + hex2(m) + ") is not supported");
        case 0xC4: get_dht(); break;
        case 0xCC: get_dac(); break;
        case 0xD8: fail("duplicate SOI marker");
        case 0xD9:
          if (!have_sof) fail("no SOF marker before EOI");
          if (scans == 0) fail("no image data in JPEG file");
          return;
        case 0xDA:
          if (!have_sof) fail("SOS marker before SOF");
          if (header_only) fail("SOS marker before SOF");
          // jdmaster.c: libjpeg-turbo has no lossless arithmetic decoder
          if (arith && lossless) fail("arithmetic-coded lossless JPEG is not implemented");
          decode_scan();
          if (!multi_scan) return;  // single scan: libjpeg reads no further
          break;
        case 0xDB: get_dqt(); break;
        case 0xDD: get_dri(); break;
        case 0xE0: case 0xEE: get_app(m); break;
        case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3:
        case 0xD4: case 0xD5: case 0xD6: case 0xD7:
          break;
        default:
          if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC || m == 0xDE || m == 0xDF) {
            skip_variable();
            break;
          }
          fail("unsupported marker type 0x" + hex2(m));
      }
    }
  }

  static std::string hex2(int m) {
    const char* hex = "0123456789abcdef";
    return std::string{hex[(m >> 4) & 15], hex[m & 15]};
  }

  // ----- scans
  std::vector<Component*> cur;
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  BitReader br;
  ArithDecoder ad;
  uint8_t dc_stats[16][64] = {}, ac_stats[16][256] = {};
  uint8_t fixed_bin = 113;
  int eobrun = 0;
  int next_rst = 0;

  void decode_scan() {
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("bogus SOS marker length");
    cur.clear();
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (auto& cc : comps)
        if (cc.id == id) c = &cc;
      if (c == nullptr) fail("invalid component ID in SOS");
      for (auto* o : cur)
        if (o == c) fail("invalid component ID in SOS");
      c->dc_tbl = t >> 4;
      c->ac_tbl = t & 15;
      cur.push_back(c);
    }
    Ss = u8();
    Se = u8();
    int a = u8();
    Ah = a >> 4;
    Al = a & 15;
    if (scans == 0) multi_scan = ns < static_cast<int>(comps.size()) || progressive;
    scans++;
    int mcus_per_row, mcu_rows, blocks = 0;
    if (ns == 1) {
      mcus_per_row = cur[0]->wb;
      mcu_rows = cur[0]->hb;
      blocks = 1;
    } else {
      mcus_per_row = cur[0]->bw / cur[0]->h;
      mcu_rows = imcu_rows;
      for (auto* c : cur) blocks += c->h * c->v;
      if (blocks > 10) fail("sampling factors too large for interleaved scan");
    }
    if (lossless) {
      lossless_scan(mcus_per_row);
      return;
    }
    for (auto* c : cur) {
      if (!c->latched) {
        if (!qt_def[c->tq]) fail("quantization table not defined");
        for (int k = 0; k < 64; k++) c->quant[k] = static_cast<int16_t>(qt[c->tq][k]);
        c->latched = true;
      }
      if (c->coef.empty()) c->coef.assign(static_cast<size_t>(c->bw) * c->bh * 64, 0);
    }
    // which decoder (jdhuff.c / jdphuff.c / jdarith.c start_pass)
    enum { SEQ, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE } kind = SEQ;
    if (progressive) {
      bool bad = false;
      const bool is_dc = Ss == 0;
      if (is_dc) {
        if (Se != 0) bad = true;
      } else {
        if (Ss > Se || Se > 63) bad = true;
        if (ns != 1) bad = true;
      }
      if (Ah != 0 && Al != Ah - 1) bad = true;
      if (Al > 13) bad = true;
      if (bad) fail("invalid progressive parameters");
      for (auto* c : cur) {
        for (int k = std::min(Ss, 1); k <= std::max(Se, 9); k++)
          if (k < 10) c->prev_coef_bits[k] = scans > 1 ? c->coef_bits[k] : 0;
        for (int k = Ss; k <= Se; k++) c->coef_bits[k] = Al;
      }
      kind = is_dc ? (Ah == 0 ? DC_FIRST : DC_REFINE) : (Ah == 0 ? AC_FIRST : AC_REFINE);
    }
    const bool dc_first = kind == SEQ || kind == DC_FIRST;
    const bool ac_stats_used = kind == SEQ || Ss != 0;
    for (auto* c : cur) {
      if (arith) {
        if (dc_first) {
          std::memset(dc_stats[c->dc_tbl], 0, sizeof(dc_stats[0]));
          c->dc_context = 0;
        }
        if (ac_stats_used) std::memset(ac_stats[c->ac_tbl], 0, sizeof(ac_stats[0]));
      } else {
        if (dc_first) {
          if (c->dc_tbl >= 4 || !dc[c->dc_tbl].defined) fail("Huffman table not defined");
          derive(dc[c->dc_tbl], 15);
        }
        if (kind == SEQ || kind == AC_FIRST || kind == AC_REFINE) {
          if (c->ac_tbl >= 4 || !ac[c->ac_tbl].defined) fail("Huffman table not defined");
          derive(ac[c->ac_tbl], -1);
        }
      }
      c->last_dc = 0;
    }
    start_entropy();
    eobrun = 0;
    next_rst = 0;
    int restarts_to_go = restart_interval;
    for (int my = 0; my < mcu_rows; my++) {
      const int imcu = ns == 1 ? my / cur[0]->v : my;
      for (int mx = 0; mx < mcus_per_row; mx++) {
        if (restart_interval) {
          if (restarts_to_go == 0) {
            if (arith)
              arith_restart(kind == SEQ || kind == DC_FIRST, ac_stats_used);
            else
              process_restart();
            restarts_to_go = restart_interval;
          }
        }
        // jdcoefct.c consume_data
        if (!insufficient) last_good_row = imcu;
        int16_t* blk[10];
        int owner[10];
        int nb = 0;
        if (ns == 1) {
          Component* c = cur[0];
          blk[nb] = &c->coef[(static_cast<size_t>(my) * c->bw + mx) * 64];
          owner[nb++] = 0;
        } else {
          for (int ci = 0; ci < ns; ci++) {
            Component* c = cur[ci];
            for (int y = 0; y < c->v; y++)
              for (int x = 0; x < c->h; x++) {
                size_t row = static_cast<size_t>(my) * c->v + y;
                size_t col = static_cast<size_t>(mx) * c->h + x;
                blk[nb] = &c->coef[(row * c->bw + col) * 64];
                owner[nb++] = ci;
              }
          }
        }
        if (arith) {
          if (kind == DC_REFINE) arith_dc_refine(blk, nb);
          else if (ad.ct == -1) {}  // after a bad code: nothing until the next restart
          else if (kind == SEQ) arith_sequential(blk, owner, nb);
          else if (kind == DC_FIRST) arith_dc_first(blk, owner, nb);
          else if (kind == AC_FIRST) arith_ac_first(blk[0], cur[0]);
          else arith_ac_refine(blk[0], cur[0]);
        } else {
          switch (kind) {
            case SEQ: mcu_sequential(blk, owner, nb); break;
            case DC_FIRST: mcu_dc_first(blk, owner, nb); break;
            case DC_REFINE: mcu_dc_refine(blk, nb); break;
            case AC_FIRST: mcu_ac_first(blk[0], cur[0]); break;
            case AC_REFINE: mcu_ac_refine(blk[0], cur[0]); break;
          }
        }
        if (restart_interval) restarts_to_go--;
      }
    }
    end_entropy();
  }

  void start_entropy() {
    insufficient = false;
    if (arith) {
      ad = ArithDecoder();
      ad.d = d;
      ad.pos = pos;
      ad.limit = std::min(n, fed);
      strict = true;
      return;
    }
    br = BitReader();
    br.d = d;
    br.n = n;
    br.pos = pos;
    br.insufficient = &insufficient;
  }

  // the bits left in the buffer are dropped; the next marker follows
  void end_entropy() {
    if (arith) {
      pos = ad.pos;
      pending = ad.marker;
      strict = false;
      return;
    }
    pos = br.pos;
    pending = br.marker;
  }

  // jdmarker.c read_restart_marker, over the marker the entropy decoder met
  // (`marker`) or the next one in the file
  void read_restart_marker(int& marker, size_t& at) {
    if (marker == 0) {
      pos = at;
      marker = next_marker();
      at = pos;
    }
    if (marker == 0xD0 + next_rst) {
      marker = 0;
    } else {
      resync(next_rst, marker, at);
    }
    next_rst = (next_rst + 1) & 7;
  }

  void process_restart() {
    br.bits = 0;
    br.buf = 0;
    read_restart_marker(br.marker, br.pos);
    for (auto* c : cur) c->last_dc = 0;
    eobrun = 0;
    if (br.marker == 0) insufficient = false;
  }

  // jdarith.c process_restart: statistics, predictions and the coder reset
  void arith_restart(bool dc_used, bool ac_used) {
    read_restart_marker(ad.marker, ad.pos);
    for (auto* c : cur) {
      if (dc_used) {
        std::memset(dc_stats[c->dc_tbl], 0, sizeof(dc_stats[0]));
        c->last_dc = 0;
        c->dc_context = 0;
      }
      if (ac_used) std::memset(ac_stats[c->ac_tbl], 0, sizeof(ac_stats[0]));
    }
    ad.reset();
  }

  // jdmarker.c jpeg_resync_to_restart
  void resync(int desired, int& marker, size_t& at) {
    for (;;) {
      int action;
      if (marker < 0xC0) {
        action = 2;
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;
      } else if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        marker = 0;
        return;
      }
      if (action == 3) return;
      pos = at;
      marker = next_marker();
      at = pos;
    }
  }

  void mcu_sequential(int16_t** blk, const int* owner, int nb) {
    if (insufficient) return;
    for (int b = 0; b < nb; b++) {
      Component* c = cur[owner[b]];
      int s = br.decode(dc[c->dc_tbl]);
      if (s) s = extend(br.get_bits(s), s);
      s = static_cast<int>(static_cast<unsigned>(s) + static_cast<unsigned>(c->last_dc));
      c->last_dc = s;
      int16_t* block = blk[b];
      block[0] = static_cast<int16_t>(s);
      const HuffTable& t = ac[c->ac_tbl];
      for (int k = 1; k < 64; k++) {
        s = br.decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          r = br.get_bits(s);
          s = extend(r, s);
          block[kNatural[k]] = static_cast<int16_t>(s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  void mcu_dc_first(int16_t** blk, const int* owner, int nb) {
    if (insufficient) return;
    for (int b = 0; b < nb; b++) {
      Component* c = cur[owner[b]];
      int s = br.decode(dc[c->dc_tbl]);
      if (s) s = extend(br.get_bits(s), s);
      if ((c->last_dc >= 0 && s > INT_MAX - c->last_dc) ||
          (c->last_dc < 0 && s < INT_MIN - c->last_dc))
        fail("corrupt JPEG data: bad DCT coefficient");
      s += c->last_dc;
      c->last_dc = s;
      blk[b][0] = static_cast<int16_t>(static_cast<unsigned>(s) << Al);
    }
  }

  void mcu_dc_refine(int16_t** blk, int nb) {
    const int p1 = 1 << Al;
    for (int b = 0; b < nb; b++)
      if (br.get_bits(1)) blk[b][0] = static_cast<int16_t>(blk[b][0] | p1);
  }

  void mcu_ac_first(int16_t* block, Component* c) {
    if (insufficient) return;
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const HuffTable& t = ac[c->ac_tbl];
    for (int k = Ss; k <= Se; k++) {
      int s = br.decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = br.get_bits(s);
        s = extend(r, s);
        block[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(s) << Al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get_bits(r);
          eobrun--;
          break;
        }
      }
    }
  }

  void mcu_ac_refine(int16_t* block, Component* c) {
    if (insufficient) return;
    const int p1 = 1 << Al;
    const int m1 = static_cast<int>(~0u << Al);
    int k = Ss;
    if (eobrun == 0) {
      const HuffTable& t = ac[c->ac_tbl];
      for (; k <= Se; k++) {
        int s = br.decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = br.get_bits(1) ? p1 : m1;
        } else {
          if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += br.get_bits(r);
            break;
          }
        }
        do {
          int16_t* coef = block + kNatural[k];
          if (*coef != 0) {
            if (br.get_bits(1)) {
              if ((*coef & p1) == 0) {
                if (*coef >= 0)
                  *coef = static_cast<int16_t>(*coef + p1);
                else
                  *coef = static_cast<int16_t>(*coef + m1);
              }
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= Se);
        if (s) block[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; k++) {
        int16_t* coef = block + kNatural[k];
        if (*coef != 0) {
          if (br.get_bits(1)) {
            if ((*coef & p1) == 0) {
              if (*coef >= 0)
                *coef = static_cast<int16_t>(*coef + p1);
              else
                *coef = static_cast<int16_t>(*coef + m1);
            }
          }
        }
      }
      eobrun--;
    }
  }

  // ----- jdarith.c
  // F.1.4.4.1 / Figures F.19-F.24: a DC difference in the statistics of
  // table `tbl` under conditioning `ctx`; false after a magnitude overflow
  bool arith_dc_diff(int tbl, int& ctx, int& diff) {
    uint8_t* st = dc_stats[tbl] + ctx;
    diff = 0;
    if (ad.decode(st) == 0) {
      ctx = 0;
      return true;
    }
    const int sign = ad.decode(st + 1);
    st += 2 + sign;
    int m = ad.decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;  // X1
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < ((1 << arith_L[tbl]) >> 1))
      ctx = 0;
    else if (m > ((1 << arith_U[tbl]) >> 1))
      ctx = 12 + sign * 4;
    else
      ctx = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    v += 1;
    diff = sign ? -v : v;
    return true;
  }

  // an AC value at spectral position k, its statistics at `st` (the SN /
  // SP / X1 bin); false after a magnitude overflow
  bool arith_ac_value(int tbl, int k, uint8_t* st, int& value) {
    const int sign = ad.decode(&fixed_bin);
    int m = ad.decode(st);
    if (m != 0 && ad.decode(st)) {
      m <<= 1;
      st = ac_stats[tbl] + (k <= arith_K[tbl] ? 189 : 217);
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    v += 1;
    value = sign ? -v : v;
    return true;
  }

  void arith_sequential(int16_t** blk, const int* owner, int nb) {
    for (int b = 0; b < nb; b++) {
      Component* c = cur[owner[b]];
      int diff;
      if (!arith_dc_diff(c->dc_tbl, c->dc_context, diff)) {
        ad.ct = -1;  // JWRN_ARITH_BAD_CODE
        return;
      }
      c->last_dc = (c->last_dc + diff) & 0xFFFF;
      int16_t* block = blk[b];
      block[0] = static_cast<int16_t>(c->last_dc);
      const int tbl = c->ac_tbl;
      int k = 0;
      do {
        uint8_t* st = ac_stats[tbl] + 3 * k;
        if (ad.decode(st)) break;  // EOB
        for (;;) {
          k++;
          if (ad.decode(st + 1)) break;
          st += 3;
          if (k >= 63) {
            ad.ct = -1;
            return;
          }
        }
        int v;
        if (!arith_ac_value(tbl, k, st + 2, v)) {
          ad.ct = -1;
          return;
        }
        block[kNatural[k]] = static_cast<int16_t>(v);
      } while (k < 63);
    }
  }

  void arith_dc_first(int16_t** blk, const int* owner, int nb) {
    for (int b = 0; b < nb; b++) {
      Component* c = cur[owner[b]];
      int diff;
      if (!arith_dc_diff(c->dc_tbl, c->dc_context, diff)) {
        ad.ct = -1;
        return;
      }
      c->last_dc = (c->last_dc + diff) & 0xFFFF;
      blk[b][0] = static_cast<int16_t>(static_cast<unsigned>(c->last_dc) << Al);
    }
  }

  void arith_dc_refine(int16_t** blk, int nb) {
    const int p1 = 1 << Al;
    for (int b = 0; b < nb; b++)
      if (ad.decode(&fixed_bin)) blk[b][0] = static_cast<int16_t>(blk[b][0] | p1);
  }

  void arith_ac_first(int16_t* block, Component* c) {
    const int tbl = c->ac_tbl;
    for (int k = Ss; k <= Se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ad.decode(st)) break;  // EOB
      while (ad.decode(st + 1) == 0) {
        st += 3;
        if (++k > Se) {
          ad.ct = -1;
          return;
        }
      }
      int v;
      if (!arith_ac_value(tbl, k, st + 2, v)) {
        ad.ct = -1;
        return;
      }
      block[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << Al);
    }
  }

  void arith_ac_refine(int16_t* block, Component* c) {
    const int tbl = c->ac_tbl;
    const int p1 = 1 << Al;
    const int m1 = static_cast<int>(~0u << Al);
    int kex = Se;  // the previous stage's end of block
    for (; kex > 0; kex--)
      if (block[kNatural[kex]]) break;
    for (int k = Ss; k <= Se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ad.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = block + kNatural[k];
        if (*coef) {  // a correction bit
          if (ad.decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ad.decode(st + 1)) {  // newly nonzero
          *coef = static_cast<int16_t>(ad.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > Se) {
          ad.ct = -1;
          return;
        }
      }
    }
  }

  // ----- lossless (jdlhuff.c, jddiffct.c, jdlossls.c)
  void lossless_scan(int mcus_per_row) {
    for (auto* c : cur) {
      if (c->dc_tbl >= 4 || !dc[c->dc_tbl].defined) fail("Huffman table not defined");
      derive(dc[c->dc_tbl], 16);
    }
    if (Ss < 1 || Ss > 7 || Se != 0 || Ah != 0 || Al >= precision)
      fail("invalid lossless parameters Ss=" + std::to_string(Ss) + " Se=" + std::to_string(Se) +
           " Ah=" + std::to_string(Ah) + " Al=" + std::to_string(Al));
    if (restart_interval % mcus_per_row != 0) fail("restart interval is not a whole number of MCU rows");
    const int ns = static_cast<int>(cur.size());
    for (auto& c : comps) c.first_row = true;
    // the differences of one iMCU row, MCU-padded
    std::vector<std::vector<int>> diff(ns);
    std::vector<int> dwidth(ns);
    for (int ci = 0; ci < ns; ci++) {
      Component* c = cur[ci];
      if (c->plane.empty()) {
        c->stride = static_cast<size_t>(c->dw);
        c->plane.assign(c->stride * c->dh, 0);
      }
      c->undiff_prev.assign(c->dw, 0);
      dwidth[ci] = ns == 1 ? c->dw : mcus_per_row * c->h;
      diff[ci].assign(static_cast<size_t>(dwidth[ci]) * c->v, 0);
    }
    start_entropy();
    next_rst = 0;
    const int restart_rows = restart_interval / mcus_per_row;
    int rows_to_go = restart_rows;
    for (int i = 0; i < imcu_rows; i++) {
      const bool last = i == imcu_rows - 1;
      // MCU rows in this iMCU row
      int mcu_rows = 1;
      if (ns == 1) {
        const Component* c = cur[0];
        mcu_rows = last ? (c->dh % c->v ? c->dh % c->v : c->v) : c->v;
        if (!last && i * c->v >= c->dh) mcu_rows = 0;
      }
      for (int y = 0; y < mcu_rows; y++) {
        if (restart_interval) {
          if (rows_to_go == 0) {
            process_restart();
            for (auto& c : comps) c.first_row = true;
            rows_to_go = restart_rows;
          }
        }
        lossless_mcu_row(diff, dwidth, y, mcus_per_row);
        if (restart_interval) rows_to_go--;
      }
      for (int ci = 0; ci < ns; ci++) {
        Component* c = cur[ci];
        int rows = c->v;
        if (last) rows = c->dh % c->v ? c->dh % c->v : c->v;
        for (int r = 0; r < rows; r++) {
          const int y = i * c->v + r;
          if (y >= c->dh) break;
          undifference(c, &diff[ci][static_cast<size_t>(r) * dwidth[ci]],
                       c->plane.data() + static_cast<size_t>(y) * c->stride);
        }
      }
    }
    end_entropy();
  }

  // jdlhuff.c decode_mcus over one MCU row (`y`: its row in the iMCU row
  // of a non-interleaved scan)
  void lossless_mcu_row(std::vector<std::vector<int>>& diff, const std::vector<int>& dwidth, int y,
                        int mcus_per_row) {
    const int ns = static_cast<int>(cur.size());
    if (insufficient) {  // zeros, and the undifferencer starts over
      for (int ci = 0; ci < ns; ci++) {
        const int rows = ns == 1 ? 1 : cur[ci]->v;
        int* p = &diff[ci][static_cast<size_t>(ns == 1 ? y : 0) * dwidth[ci]];
        std::fill(p, p + static_cast<size_t>(rows) * dwidth[ci], 0);
      }
      for (auto& c : comps) c.first_row = true;
      return;
    }
    for (int mx = 0; mx < mcus_per_row; mx++) {
      for (int ci = 0; ci < ns; ci++) {
        const Component* c = cur[ci];
        const int hh = ns == 1 ? 1 : c->h, vv = ns == 1 ? 1 : c->v;
        for (int yy = 0; yy < vv; yy++)
          for (int xx = 0; xx < hh; xx++) {
            int s = br.decode(dc[c->dc_tbl]);
            if (s == 16) {
              s = 32768;
            } else if (s) {
              s = extend(br.get_bits(s), s);
            }
            const size_t row = static_cast<size_t>(ns == 1 ? y : yy);
            diff[ci][row * dwidth[ci] + static_cast<size_t>(mx) * hh + xx] = s;
          }
      }
    }
  }

  // jdlossls.c: one row of `c` from its differences, scaled by Pt
  void undifference(Component* c, const int* df, uint8_t* out) {
    int* prev = c->undiff_prev.data();
    const int w = c->dw;
    int ra;
    if (c->first_row) {
      ra = (df[0] + (1 << (precision - Al - 1))) & 0xFFFF;
      prev[0] = ra;
      for (int x = 1; x < w; x++) prev[x] = ra = (df[x] + ra) & 0xFFFF;
      c->first_row = false;
    } else {
      int rb = prev[0], rc;
      ra = (df[0] + rb) & 0xFFFF;
      prev[0] = ra;
      for (int x = 1; x < w; x++) {
        rc = rb;
        rb = prev[x];
        int p;
        switch (Ss) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = ra + rb - rc; break;
          case 5: p = ra + ((rb - rc) >> 1); break;
          case 6: p = rb + ((ra - rc) >> 1); break;
          default: p = (ra + rb) >> 1; break;
        }
        prev[x] = ra = (df[x] + p) & 0xFFFF;
      }
    }
    for (int x = 0; x < w; x++) out[x] = static_cast<uint8_t>(prev[x] << Al);
  }
};

// ----- libjpeg-turbo's x86-64 islow IDCT (jidctint-sse2.asm and
// jidctint-avx2.asm, which Pillow's libjpeg runs on any x86-64 CPU):
// jidctint.c's arithmetic in 16-bit lanes. On the coefficients of a valid
// file it equals jidctint.c; on the garbage that corrupt data leaves, the
// lanes wrap and saturate where jidctint.c's ints do not:
//   * dequantisation and the sums in0 +- in4, in7 + in3 and in5 + in1 wrap
//     to 16 bits (pmullw, paddw), products and their sums to 32 (pmaddwd,
//     paddd);
//   * each pass's output saturates to 16 bits (packssdw), the last pass's
//     then to 8 around 0 before the +128 (packsswb, paddb): no range-limit
//     table;
//   * a block whose rows 1-7 are all zero takes pass 1's shortcut, its
//     dequantised row 0 << 2 wrapped to 16 bits for every row.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
                  F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
                  F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

inline int32_t wrap16(int64_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }

// The SIMD dodct macro on one lane: in[k * step] (16-bit values) to
// out[k * step], descaled by `n` in 32 bits and saturated to 16.
void idct_lane(const int32_t* in, int32_t* out, int step, int n) {
  const int64_t i0 = in[0], i1 = in[step], i2 = in[2 * step], i3 = in[3 * step];
  const int64_t i4 = in[4 * step], i5 = in[5 * step], i6 = in[6 * step], i7 = in[7 * step];
  // even part: tmp3 = z2 * (0.541 + 0.765) + z3 * 0.541, tmp2 = z2 * 0.541 +
  // z3 * (0.541 - 1.848), tmp0 / tmp1 = (in0 +- in4) << CONST_BITS
  const int64_t tmp3 = i2 * (F0_541196100 + F0_765366865) + i6 * F0_541196100;
  const int64_t tmp2 = i2 * F0_541196100 + i6 * (F0_541196100 - F1_847759065);
  const int64_t tmp0 = static_cast<int64_t>(wrap16(i0 + i4)) * (1 << kConstBits);
  const int64_t tmp1 = static_cast<int64_t>(wrap16(i0 - i4)) * (1 << kConstBits);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  // odd part, z5 folded into z3 and z4, z1 and z2 into the tmps
  const int64_t z3 = wrap16(i7 + i3), z4 = wrap16(i5 + i1);
  const int64_t zz3 = z3 * (F1_175875602 - F1_961570560) + z4 * F1_175875602;
  const int64_t zz4 = z3 * F1_175875602 + z4 * (F1_175875602 - F0_390180644);
  const int64_t o0 = i7 * (F0_298631336 - F0_899976223) - i1 * F0_899976223 + zz3;
  const int64_t o3 = -i7 * F0_899976223 + i1 * (F1_501321110 - F0_899976223) + zz4;
  const int64_t o1 = i5 * (F2_053119869 - F2_562915447) - i3 * F2_562915447 + zz4;
  const int64_t o2 = -i5 * F2_562915447 + i3 * (F3_072711026 - F2_562915447) + zz3;
  const int64_t round = int64_t{1} << (n - 1);
  auto put = [&](int k, int64_t x) {
    const int32_t v = static_cast<int32_t>(static_cast<uint32_t>(x + round)) >> n;
    out[k * step] = std::clamp(v, -32768, 32767);
  };
  put(0, tmp10 + o3);
  put(7, tmp10 - o3);
  put(1, tmp11 + o2);
  put(6, tmp11 - o2);
  put(2, tmp12 + o1);
  put(5, tmp12 - o1);
  put(3, tmp13 + o0);
  put(4, tmp13 - o0);
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride) {
  int32_t deq[64], ws[64];
  bool ac_rows = false;
  for (int k = 0; k < 64; k++) {
    deq[k] = wrap16(static_cast<int32_t>(in[k]) * q[k]);
    ac_rows |= k >= 8 && in[k] != 0;
  }
  for (int c = 0; c < 8; c++) {
    const int32_t* dp = deq + c;
    if (!ac_rows) {
      for (int r = 0; r < 8; r++) ws[8 * r + c] = wrap16(dp[0] * 4);
    } else if (in[c + 8] == 0 && in[c + 16] == 0 && in[c + 24] == 0 && in[c + 32] == 0 &&
               in[c + 40] == 0 && in[c + 48] == 0 && in[c + 56] == 0) {
      // idct_lane's value for a column of DC alone, saturated
      for (int r = 0; r < 8; r++) ws[8 * r + c] = std::clamp(dp[0] * 4, -32768, 32767);
    } else {
      idct_lane(dp, ws + c, 8, kConstBits - kPass1Bits);
    }
  }
  for (int r = 0; r < 8; r++) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    int32_t row[8];
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      // idct_lane's value for a row of DC alone
      std::fill(row, row + 8, (wp[0] + 16) >> 5);
    } else {
      idct_lane(wp, row, 1, kConstBits + kPass1Bits + 3);
    }
    for (int c = 0; c < 8; c++) op[c] = static_cast<uint8_t>(std::clamp(row[c], -128, 127) + 128);
  }
}

template <typename F>
void parallel_rows(int rows, int threads, F&& body) {
  threads = std::max(1, std::min(threads, rows));
  if (threads == 1) {
    body(0, rows);
    return;
  }
  std::vector<std::thread> pool;
  const int per = (rows + threads - 1) / threads;
  for (int t = 0; t < threads; t++) {
    const int r0 = t * per, r1 = std::min(rows, r0 + per);
    if (r0 >= r1) break;
    pool.emplace_back([&body, r0, r1] { body(r0, r1); });
  }
  for (auto& th : pool) th.join();
}

// jdsample.c: one output row of component `c`, upsampled to `width`
// samples into `out` (needs 2 * dw + 8 samples of room). `fancy`: the
// triangle filters where they apply (libjpeg asks for none in a lossless
// frame, whose DCT scaled size is 1).
void upsample_row(const Component& c, int max_h, int max_v, int y, bool fancy, uint8_t* out) {
  const size_t stride = c.stride;
  const int hx = max_h / c.h, vx = max_v / c.v;
  const int dw = c.dw, last = c.dh - 1;
  auto row = [&](int r) { return c.plane.data() + static_cast<size_t>(std::min(std::max(r, 0), last)) * stride; };
  if (hx == 1 && vx == 1) {
    std::memcpy(out, row(y), dw);
  } else if (!fancy) {  // h2v1 / h2v2 / int_upsample: replication
    const uint8_t* in = row(y / vx);
    for (int i = 0; i < dw; i++) std::memset(out + static_cast<size_t>(i) * hx, in[i], hx);
  } else if (hx == 1 && vx == 1) {
    std::memcpy(out, row(y), dw);
  } else if (hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
    const uint8_t* in = row(y);
    out[0] = in[0];
    out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
    for (int i = 1; i < dw - 1; i++) {
      const int v3 = in[i] * 3;
      out[2 * i] = static_cast<uint8_t>((v3 + in[i - 1] + 1) >> 2);
      out[2 * i + 1] = static_cast<uint8_t>((v3 + in[i + 1] + 2) >> 2);
    }
    out[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
    out[2 * dw - 1] = in[dw - 1];
  } else if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
    const int r = y >> 1, lower = y & 1;
    const uint8_t* near = row(r);
    const uint8_t* far = row(lower ? r + 1 : r - 1);
    const int bias = lower ? 2 : 1;
    for (int i = 0; i < dw; i++)
      out[i] = static_cast<uint8_t>((near[i] * 3 + far[i] + bias) >> 2);
  } else if (hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
    const int r = y >> 1, lower = y & 1;
    const uint8_t* near = row(r);
    const uint8_t* far = row(lower ? r + 1 : r - 1);
    int this_sum = near[0] * 3 + far[0];
    int next_sum = near[1] * 3 + far[1];
    out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
    out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    int last_sum = this_sum;
    this_sum = next_sum;
    for (int i = 1; i < dw - 1; i++) {
      next_sum = near[i + 1] * 3 + far[i + 1];
      out[2 * i] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      out[2 * i + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    out[2 * dw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
  } else {  // int_upsample (and h2v1 / h2v2 at widths of 2 or less)
    const uint8_t* in = row(y / vx);
    for (int i = 0; i < dw; i++) std::memset(out + static_cast<size_t>(i) * hx, in[i], hx);
  }
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ----- jdcoefct.c block smoothing (libjpeg-turbo 2.1 and later)

// Natural positions of zigzag coefficients 1..9: Q01 Q10 Q20 Q11 Q02 Q03
// Q12 Q21 Q30
const int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// smoothing_ok: every component's DC at least partly known, its ten
// quantizers nonzero, and some coefficient of 1..9 not fully refined
bool smoothing_ok(const Jpeg& j) {
  if (!j.progressive) return false;
  bool useful = false;
  for (const auto& c : j.comps) {
    if (!c.latched) return false;
    for (int k = 0; k < 10; k++)
      if (c.quant[kSmoothPos[k]] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; k++)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

inline int16_t smooth_pred(int64_t num, int64_t q, int al) {
  int p = static_cast<int>(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
  if (al > 0 && p >= (1 << al)) p = (1 << al) - 1;
  return static_cast<int16_t>(num >= 0 ? p : -p);
}

// decompress_smooth_data for block row R of `c`: each block's first nine AC
// coefficients (and, where no AC scan has come, its DC) estimated from the
// DC values of the 5 x 5 blocks around it, then the IDCT. `latch` and
// `prev_latch` are coef_bits[0..9] at the end and before the last scan;
// the latter serves iMCU rows past the last one decoded in full.
void idct_smoothed_row(const Jpeg& j, Component& c, int R, const int* latch, const int* prev_latch) {
  const int T = j.imcu_rows, v = c.v;
  const int i = R / v, b = R - i * v;
  int block_rows = v;
  if (i == T - 1) block_rows = c.hb % v ? c.hb % v : v;
  const int* bits = i > j.last_good_row ? prev_latch : latch;
  bool change_dc = true;
  for (int k = 1; k < 10; k++)
    if (bits[k] != -1) change_dc = false;
  int64_t Q[10];
  for (int k = 0; k < 10; k++) Q[k] = static_cast<uint16_t>(c.quant[kSmoothPos[k]]);
  // image_block_row as libjpeg counts it (in the last iMCU row, by that
  // row's block count)
  const int64_t ibr = static_cast<int64_t>(i) * block_rows + b;
  const int64_t ibrs = static_cast<int64_t>(block_rows) * T;
  auto row = [&](int r) { return &c.coef[static_cast<size_t>(r) * c.bw * 64]; };
  const int16_t* cur = row(R);
  const int16_t* prev = ibr > 0 ? row(R - 1) : cur;
  const int16_t* pprev = ibr > 1 ? row(R - 2) : prev;
  const int16_t* next = ibr < ibrs - 1 ? row(R + 1) : cur;
  const int16_t* nnext = ibr < ibrs - 2 ? row(R + 2) : next;
  const int16_t* rows[5] = {pprev, prev, cur, next, nnext};
  // DC[r][k]: the DC of row r (pprev..nnext) at column offset k - 2, the
  // first and last columns replicated
  int DC[5][5];
  const int last_col = c.wb - 1;
  uint8_t* out = c.plane.data() + static_cast<size_t>(R) * 8 * c.stride;
  int16_t ws[64];
  for (int bc = 0; bc <= last_col; bc++) {
    std::memcpy(ws, cur + static_cast<size_t>(bc) * 64, sizeof(ws));
    for (int k = 0; k < 5; k++) {
      const size_t col = static_cast<size_t>(std::min(std::max(bc + k - 2, 0), last_col)) * 64;
      for (int r = 0; r < 5; r++) DC[r][k] = rows[r][col];
    }
    const int DC01 = DC[0][0], DC02 = DC[0][1], DC03 = DC[0][2], DC04 = DC[0][3], DC05 = DC[0][4];
    const int DC06 = DC[1][0], DC07 = DC[1][1], DC08 = DC[1][2], DC09 = DC[1][3], DC10 = DC[1][4];
    const int DC11 = DC[2][0], DC12 = DC[2][1], DC13 = DC[2][2], DC14 = DC[2][3], DC15 = DC[2][4];
    const int DC16 = DC[3][0], DC17 = DC[3][1], DC18 = DC[3][2], DC19 = DC[3][3], DC20 = DC[3][4];
    const int DC21 = DC[4][0], DC22 = DC[4][1], DC23 = DC[4][2], DC24 = DC[4][3], DC25 = DC[4][4];
    int al;
    int64_t num;
    if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
      num = change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
                         3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                         13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                      : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15);
      ws[1] = smooth_pred(Q[0] * num, Q[1], al);
    }
    if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
      num = change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                         38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 +
                         DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                      : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23);
      ws[8] = smooth_pred(Q[0] * num, Q[2], al);
    }
    if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
      num = change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
                         2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                      : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23);
      ws[16] = smooth_pred(Q[0] * num, Q[3], al);
    }
    if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
      num = change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25)
                      : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
                         DC06 + 10 * DC07 - 10 * DC09);
      ws[9] = smooth_pred(Q[0] * num, Q[4], al);
    }
    if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
      num = change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
                         DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                      : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15);
      ws[2] = smooth_pred(Q[0] * num, Q[5], al);
    }
    if (change_dc) {
      if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
        ws[3] = smooth_pred(Q[0] * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q[6], al);
      if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
        ws[10] = smooth_pred(Q[0] * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q[7], al);
      if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
        ws[17] = smooth_pred(Q[0] * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q[8], al);
      if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
        ws[24] = smooth_pred(Q[0] * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q[9], al);
      num = -2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
            42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
            8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 -
            6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25;
      ws[0] = smooth_pred(Q[0] * num, Q[0], 0);
    }
    idct_islow(ws, c.quant, out + static_cast<size_t>(bc) * 8, c.stride);
  }
}

// The decoded image, (height, width, channels) u8, as Pillow hands it over:
// L, RGB, or CMYK inverted ("CMYK;I").
// cmyk: four components read as CMYK whatever an Adobe marker says (Pillow's
// jpegmode "CMYK", which BLP files ask for)
void render(Jpeg& j, uint8_t* out, int threads, bool cmyk) {
  const bool smooth = smoothing_ok(j);
  for (auto& c : j.comps) {
    if (j.lossless) {  // the samples are decoded already
      if (c.plane.empty()) {
        c.stride = static_cast<size_t>(c.dw);
        c.plane.assign(c.stride * c.dh, 0);
      }
      continue;
    }
    if (c.coef.empty()) c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    if (!c.latched) {  // a component no scan named: libjpeg's zero blocks
      if (!j.qt_def[c.tq]) fail("quantization table not defined");
      for (int k = 0; k < 64; k++) c.quant[k] = static_cast<int16_t>(j.qt[c.tq][k]);
    }
    c.stride = static_cast<size_t>(c.wb) * 8;
    c.plane.assign(c.stride * static_cast<size_t>(c.hb) * 8, 0);
    Component* cp = &c;
    if (smooth) {
      // smoothing_ok's latch: coef_bits now, and before the last scan
      int latch[10], prev_latch[10];
      for (int k = 0; k < 10; k++) {
        latch[k] = c.coef_bits[k];
        prev_latch[k] = j.scans > 1 ? c.prev_coef_bits[k] : -1;
      }
      parallel_rows(c.hb, threads, [&j, cp, &latch, &prev_latch](int r0, int r1) {
        for (int br = r0; br < r1; br++) idct_smoothed_row(j, *cp, br, latch, prev_latch);
      });
    } else {
      const size_t stride = c.stride;
      parallel_rows(c.hb, threads, [cp, stride](int r0, int r1) {
        for (int br = r0; br < r1; br++)
          for (int bc = 0; bc < cp->wb; bc++)
            idct_islow(&cp->coef[(static_cast<size_t>(br) * cp->bw + bc) * 64], cp->quant,
                       cp->plane.data() + static_cast<size_t>(br) * 8 * stride + static_cast<size_t>(bc) * 8,
                       stride);
      });
    }
    std::vector<int16_t>().swap(c.coef);
  }
  for (auto& c : j.comps) {
    if (j.max_h % c.h != 0 || j.max_v % c.v != 0)
      fail("fractional sampling not implemented yet");
  }
  const int nc = static_cast<int>(j.comps.size());
  const int w = j.width;
  int space;  // 0 gray, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK (jdapimin.c)
  if (nc == 1) {
    space = 0;
  } else if (nc == 3) {
    // jdapimin.c default_decompress_parms: with no marker to say, IDs
    // 1 2 3 or unknown ones mean YCbCr in a DCT frame, RGB in a lossless one
    if (j.jfif) space = 1;
    else if (j.adobe) space = j.adobe_transform == 0 ? 2 : 1;
    else if (j.comps[0].id == 82 && j.comps[1].id == 71 && j.comps[2].id == 66) space = 2;
    else space = j.lossless ? 2 : 1;
  } else {
    space = (j.adobe && j.adobe_transform != 0 && !cmyk) ? 4 : 3;
  }
  // jdcolor.c: a lossless frame's samples are not converted
  if (j.lossless && (space == 1 || space == 4)) fail("unsupported color conversion request");
  parallel_rows(j.height, threads, [&](int y0, int y1) {
    std::vector<std::vector<uint8_t>> rows(nc);
    for (int ci = 0; ci < nc; ci++)
      rows[ci].assign(static_cast<size_t>(j.comps[ci].dw) * (j.max_h / j.comps[ci].h) + 16, 0);
    for (int y = y0; y < y1; y++) {
      for (int ci = 0; ci < nc; ci++) upsample_row(j.comps[ci], j.max_h, j.max_v, y, !j.lossless, rows[ci].data());
      uint8_t* o = out + static_cast<size_t>(y) * w * nc;
      if (space == 0) {
        std::memcpy(o, rows[0].data(), w);
      } else if (space == 1) {
        const uint8_t *Y = rows[0].data(), *cb = rows[1].data(), *cr = rows[2].data();
        for (int x = 0; x < w; x++) {
          const int yy = Y[x];
          o[3 * x] = clamp255(yy + kYcc.cr_r[cr[x]]);
          o[3 * x + 1] = clamp255(yy + static_cast<int>((kYcc.cb_g[cb[x]] + kYcc.cr_g[cr[x]]) >> 16));
          o[3 * x + 2] = clamp255(yy + kYcc.cb_b[cb[x]]);
        }
      } else if (space == 2) {
        for (int x = 0; x < w; x++)
          for (int ci = 0; ci < 3; ci++) o[3 * x + ci] = rows[ci][x];
      } else if (space == 3) {
        for (int x = 0; x < w; x++)
          for (int ci = 0; ci < 4; ci++) o[4 * x + ci] = static_cast<uint8_t>(255 - rows[ci][x]);
      } else {
        const uint8_t *Y = rows[0].data(), *cb = rows[1].data(), *cr = rows[2].data(), *k = rows[3].data();
        for (int x = 0; x < w; x++) {
          const int yy = Y[x];
          o[4 * x] = static_cast<uint8_t>(255 - clamp255(255 - (yy + kYcc.cr_r[cr[x]])));
          o[4 * x + 1] = static_cast<uint8_t>(
              255 - clamp255(255 - (yy + static_cast<int>((kYcc.cb_g[cb[x]] + kYcc.cr_g[cr[x]]) >> 16))));
          o[4 * x + 2] = static_cast<uint8_t>(255 - clamp255(255 - (yy + kYcc.cb_b[cb[x]])));
          o[4 * x + 3] = static_cast<uint8_t>(255 - k[x]);
        }
      }
    }
  });
}

}  // namespace

extern "C" {

// The frame header of a JPEG: info[0] width, [1] height, [2] components.
// 0, or -1 with the reason in `err`.
int64_t jpeg_info(const uint8_t* src, int64_t n, int64_t* info, char* err, int64_t errcap) {
  try {
    Jpeg j(src, static_cast<size_t>(n));
    j.run(true);
    if (!j.have_sof) fail("no SOF marker");
    info[0] = j.width;
    info[1] = j.height;
    info[2] = static_cast<int64_t>(j.comps.size());
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errcap, e.what);
    return -1;
  } catch (const std::exception& e) {
    set_error(err, errcap, e.what());
    return -1;
  }
}

// Decodes a JPEG into `out`, (height, width, components) u8 (`cap` bytes),
// the file handed over as Pillow reads it (kPillowBlock bytes at a time).
// 0, or -1 with the reason in `err`.
int64_t jpeg_decode(const uint8_t* src, int64_t n, uint8_t* out, int64_t cap, int32_t threads,
                    int32_t cmyk, char* err, int64_t errcap) {
  try {
    Jpeg j(src, static_cast<size_t>(n));
    j.run(false);
    if (!j.have_sof || j.scans == 0) fail("no image data in JPEG file");
    const int64_t need = static_cast<int64_t>(j.width) * j.height * static_cast<int64_t>(j.comps.size());
    if (need > cap) fail("output buffer too small");
    render(j, out, threads, cmyk != 0);
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errcap, e.what);
    return -1;
  } catch (const std::exception& e) {
    set_error(err, errcap, e.what());
    return -1;
  }
}

// The LZW data of one GIF frame (sub-blocks from `src`, minimum code size
// `bits`) into the frame's `w` x `h` window of an image whose rows are
// `stride` bytes apart (`img` at the window's top-left pixel). Returns the
// bytes of `src` consumed once the window is full or the end code came, -1
// when the data ran out first (a truncated file), -2 on a code past the
// table (a broken stream).
int64_t gif_lzw_decode(const uint8_t* src, int64_t n, int32_t bits, int32_t interlace,
                       uint8_t* img, int64_t stride, int32_t w, int32_t h) {
  if (bits < 1 || bits > 12) return -2;
  if (w <= 0 || h <= 0) return 0;
  constexpr int kTable = 4096;
  std::vector<uint16_t> link(kTable);
  std::vector<uint8_t> first(kTable), value(kTable);
  std::vector<uint8_t> stack(kTable + 1);
  const int clear = 1 << bits, end = clear + 1;
  for (int i = 0; i < clear; i++) {
    value[i] = static_cast<uint8_t>(i);
    first[i] = static_cast<uint8_t>(i);
    link[i] = 0xFFFF;
  }
  int codesize = bits + 1, next = clear + 2, last = -1;
  int64_t pos = 0;
  int block = 0;
  uint32_t acc = 0;
  int nacc = 0;
  int x = 0, y = 0, pass = interlace ? 1 : 0, step = interlace ? 8 : 1;
  auto put = [&](uint8_t v) -> bool {  // false once the window is full
    img[static_cast<int64_t>(y) * stride + x] = v;
    if (++x < w) return true;
    x = 0;
    y += step;
    while (y >= h) {
      if (pass == 1) { y = 4; pass = 2; }
      else if (pass == 2) { y = 2; step = 4; pass = 3; }
      else if (pass == 3) { y = 1; step = 2; pass = 4; }
      else return false;
    }
    return true;
  };
  for (;;) {
    while (nacc < codesize) {
      if (block == 0) {
        if (pos >= n) return -1;
        block = src[pos++];
        if (block == 0) return -1;
      }
      if (pos >= n) return -1;
      acc |= static_cast<uint32_t>(src[pos++]) << nacc;
      nacc += 8;
      block--;
    }
    int c = static_cast<int>(acc & ((1u << codesize) - 1));
    acc >>= codesize;
    nacc -= codesize;
    if (c == clear) {
      codesize = bits + 1;
      next = clear + 2;
      last = -1;
      continue;
    }
    if (c == end) return pos;
    int sp = 0;
    if (last < 0) {
      if (c > clear) return -2;
      stack[sp++] = value[c];
    } else {
      if (c > next) return -2;
      int code = c;
      uint8_t head;
      if (c == next) {  // KwKwK: the last string and its first byte
        code = last;
        head = first[last];
        stack[sp++] = head;
      }
      while (code >= clear) {
        stack[sp++] = value[code];
        code = link[code];
      }
      stack[sp++] = value[code];
      head = value[code];
      if (next < kTable) {
        link[next] = static_cast<uint16_t>(last);
        value[next] = head;
        first[next] = first[last];
        if (next == (1 << codesize) - 1 && codesize < 12) codesize++;
        next++;
      }
    }
    last = c;
    while (sp > 0)
      if (!put(stack[--sp])) return pos;
  }
}

// Pillow's BmpRleDecoder over the file `src` from `offset`: the expanded
// bytes, `xsize` a row, into `out` (`dest_length` bytes; what Pillow would
// append past them is counted, not written). Returns the length Pillow's
// data reaches.
int64_t bmp_rle_decode(const uint8_t* src, int64_t n, int64_t offset, int32_t xsize,
                       int64_t dest_length, int32_t rle4, uint8_t* out) {
  int64_t len = 0, pos = offset;
  int64_t x = 0;
  auto put = [&](uint8_t v, int64_t count) {
    for (int64_t i = 0; i < count; i++, len++)
      if (len < dest_length) out[len] = v;
  };
  while (len < dest_length) {
    if (pos + 2 > n) break;
    const int pixels = src[pos], byte = src[pos + 1];
    pos += 2;
    if (pixels) {
      int64_t num = pixels;
      if (x + num > xsize) num = std::max<int64_t>(0, xsize - x);
      if (rle4) {
        for (int64_t i = 0; i < num; i++) put(static_cast<uint8_t>(i % 2 == 0 ? byte >> 4 : byte & 15), 1);
      } else {
        put(static_cast<uint8_t>(byte), num);
      }
      x += num;
    } else if (byte == 0) {
      while (len % xsize != 0) put(0, 1);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      if (pos + 2 > n) break;
      pos += 2;  // Pillow reads two bytes and then the next two
      int right = 0, up = 0;
      if (pos < n) right = src[pos];
      if (pos + 1 < n) up = src[pos + 1];
      if (pos + 2 > n) return -1;  // Pillow unpacks fewer than two bytes
      pos += 2;
      put(0, right + static_cast<int64_t>(up) * xsize);
      x = len % xsize;
    } else {
      int64_t count = rle4 ? byte / 2 : byte;
      const int64_t got = std::min<int64_t>(count, n - pos);
      for (int64_t i = 0; i < got; i++) {
        const uint8_t b = src[pos + i];
        if (rle4) {
          put(static_cast<uint8_t>(b >> 4), 1);
          put(static_cast<uint8_t>(b & 15), 1);
        } else {
          put(b, 1);
        }
      }
      pos += got;
      if (got < count) break;
      x += byte;
      if (pos % 2 != 0) pos++;
    }
  }
  return len;
}

}  // extern "C"
