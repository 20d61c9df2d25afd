// Host decoders for the raster formats the port opens besides TIFF and
// netCDF, where the JAX package opens them through Pillow 12.1: the JPEG
// decoder of libjpeg-turbo as Pillow drives it, the GIF LZW decoder and the
// BMP RLE decoder. Built at first use by sarpro_tpu_torch._native and bound
// with ctypes (a plain C interface, no Python or PyTorch headers).
//
// JPEG, to the bytes Pillow's decode gives (its defaults: JDCT_ISLOW, fancy
// upsampling, no merged upsampler, block smoothing only while coefficient
// bits are missing):
//   * baseline and extended Huffman (SOF0 / SOF1) and progressive (SOF2)
//     scans, interleaved or not, with restart intervals, sampling factors
//     1..4, 1, 3 or 4 components at 8 bits;
//   * jdhuff.c / jdphuff.c's decoding, including the bit buffer that stops
//     at a marker and pads with zero bits, the restart resync and the
//     "insufficient data" rule that leaves the rest of a segment at zero;
//   * jidctint.c's jpeg_idct_islow with jdmaster.c's range-limit table;
//   * jdsample.c's upsamplers: h2v1 and h2v2 triangle filters (widths over
//     2), h1v2, and replication for the other integral factors;
//   * jdcolor.c's fixed-point YCbCr -> RGB and YCCK -> CMYK.
// Arithmetic coding, lossless and hierarchical frames, and 12-bit samples
// are refused (the caller raises RasterError with the message).
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

void derive(HuffTable& t, bool is_dc) {
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
  if (is_dc) {
    for (int i = 0; i < numsymbols; i++)
      if (t.vals[i] > 15) fail("bad Huffman table");
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
  int wb = 0, hb = 0;  // width / height in blocks
  int bw = 0, bh = 0;  // blocks allocated (MCU-padded)
  std::vector<int16_t> coef;
  int16_t quant[64] = {};
  bool latched = false;
  int coef_bits[64];
  int dc_tbl = 0, ac_tbl = 0;
  int last_dc = 0;
  std::vector<uint8_t> plane;  // wb*8 x hb*8 samples after the IDCT
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

struct Jpeg {
  const uint8_t* d;
  size_t n;
  size_t pos = 2;
  int pending = 0;  // a marker read past, still to handle
  int width = 0, height = 0, precision = 8, sof = -1;
  bool progressive = false, have_sof = false;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  uint16_t qt[4][64] = {};
  bool qt_def[4] = {};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  std::vector<Component> comps;
  int max_h = 1, max_v = 1;
  int scans = 0;
  bool multi_scan = false;
  bool insufficient = false;

  Jpeg(const uint8_t* src, size_t len) : d(src), n(len) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    set_table(dc[0], kDcLumBits, kDcVals);
    set_table(dc[1], kDcChrBits, kDcVals);
    set_table(ac[0], kAcLumBits, kAcLumVals);
    set_table(ac[1], kAcChrBits, kAcChrVals);
  }

  uint8_t u8() {
    if (pos >= n) fail("image file is truncated");
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
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
    if (pos + (len - 2) > n) fail("image file is truncated");
    pos += len - 2;
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
    pos += body;
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

  void get_dri() {
    if (u16() != 4) fail("bogus DRI marker length");
    restart_interval = u16();
  }

  void get_sof(int m) {
    if (have_sof) fail("duplicate SOF marker");
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
    const int mcu_cols = (width + 8 * max_h - 1) / (8 * max_h);
    const int mcu_rows = (height + 8 * max_v - 1) / (8 * max_v);
    for (auto& c : comps) {
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + max_h - 1) / max_h);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + max_v - 1) / max_v);
      c.wb = static_cast<int>((static_cast<int64_t>(width) * c.h + 8 * max_h - 1) / (8 * max_h));
      c.hb = static_cast<int>((static_cast<int64_t>(height) * c.v + 8 * max_v - 1) / (8 * max_v));
      c.bw = std::max(mcu_cols * c.h, c.wb);
      c.bh = std::max(mcu_rows * c.v, c.hb);
    }
    progressive = m == 0xC2;
    sof = m;
    have_sof = true;
  }

  // Reads markers up to the frame header (header_only) or to the end of the
  // image data.
  void run(bool header_only) {
    for (;;) {
      int m = next_marker();
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          get_sof(m);
          if (header_only) return;
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xCB:
        case 0xCD: case 0xCE: case 0xCF:
          fail("lossless and hierarchical JPEG are not decoded");
        case 0xC9: case 0xCA:
          fail("arithmetic-coded JPEG is not decoded");
        case 0xC4: get_dht(); break;
        case 0xCC: skip_variable(); break;  // DAC: arithmetic coding only
        case 0xD8: fail("duplicate SOI marker");
        case 0xD9:
          if (!have_sof) fail("no SOF marker before EOI");
          if (scans == 0) fail("no image data in JPEG file");
          return;
        case 0xDA:
          if (!have_sof) fail("SOS marker before SOF");
          if (header_only) fail("SOS marker before SOF");
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
          fail("unsupported marker type 0x" + [m] {
            const char* hex = "0123456789abcdef";
            return std::string{hex[m >> 4], hex[m & 15]};
          }());
      }
    }
  }

  // ----- scans
  std::vector<Component*> cur;
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  BitReader br;
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
      if (c->dc_tbl >= 4 || c->ac_tbl >= 4) fail("bad Huffman table index");
      cur.push_back(c);
    }
    Ss = u8();
    Se = u8();
    int a = u8();
    Ah = a >> 4;
    Al = a & 15;
    if (scans == 0) multi_scan = ns < static_cast<int>(comps.size()) || progressive;
    scans++;
    for (auto* c : cur) {
      if (!c->latched) {
        if (!qt_def[c->tq]) fail("quantization table not defined");
        for (int k = 0; k < 64; k++) c->quant[k] = static_cast<int16_t>(qt[c->tq][k]);
        c->latched = true;
      }
      if (c->coef.empty()) c->coef.assign(static_cast<size_t>(c->bw) * c->bh * 64, 0);
    }
    int mcus_per_row, mcu_rows, blocks = 0;
    if (ns == 1) {
      mcus_per_row = cur[0]->wb;
      mcu_rows = cur[0]->hb;
      blocks = 1;
    } else {
      mcus_per_row = (width + 8 * max_h - 1) / (8 * max_h);
      mcu_rows = (height + 8 * max_v - 1) / (8 * max_v);
      for (auto* c : cur) blocks += c->h * c->v;
      if (blocks > 10) fail("sampling factors too large for interleaved scan");
    }
    // which decoder, and the tables it needs (jdhuff.c / jdphuff.c
    // start_pass)
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
      for (auto* c : cur)
        for (int k = Ss; k <= Se; k++) c->coef_bits[k] = Al;
      kind = is_dc ? (Ah == 0 ? DC_FIRST : DC_REFINE) : (Ah == 0 ? AC_FIRST : AC_REFINE);
    }
    for (auto* c : cur) {
      if (kind == SEQ || kind == DC_FIRST) {
        if (!dc[c->dc_tbl].defined) fail("Huffman table not defined");
        derive(dc[c->dc_tbl], true);
      }
      if (kind == SEQ || kind == AC_FIRST || kind == AC_REFINE) {
        if (!ac[c->ac_tbl].defined) fail("Huffman table not defined");
        derive(ac[c->ac_tbl], false);
      }
      c->last_dc = 0;
    }
    br = BitReader();
    br.d = d;
    br.n = n;
    br.pos = pos;
    br.insufficient = &insufficient;
    insufficient = false;
    eobrun = 0;
    next_rst = 0;
    int restarts_to_go = restart_interval;
    for (int my = 0; my < mcu_rows; my++) {
      for (int mx = 0; mx < mcus_per_row; mx++) {
        if (restart_interval) {
          if (restarts_to_go == 0) {
            process_restart();
            restarts_to_go = restart_interval;
          }
        }
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
        switch (kind) {
          case SEQ: mcu_sequential(blk, owner, nb); break;
          case DC_FIRST: mcu_dc_first(blk, owner, nb); break;
          case DC_REFINE: mcu_dc_refine(blk, nb); break;
          case AC_FIRST: mcu_ac_first(blk[0], cur[0]); break;
          case AC_REFINE: mcu_ac_refine(blk[0], cur[0]); break;
        }
        if (restart_interval) restarts_to_go--;
      }
    }
    // the bits left in the buffer are dropped; the next marker follows
    pos = br.pos;
    pending = br.marker;
  }

  void process_restart() {
    br.bits = 0;
    br.buf = 0;
    if (br.marker == 0) {
      pos = br.pos;
      br.marker = next_marker();
      br.pos = pos;
    }
    if (br.marker == 0xD0 + next_rst) {
      br.marker = 0;
    } else {
      resync(next_rst);
    }
    next_rst = (next_rst + 1) & 7;
    for (auto* c : cur) c->last_dc = 0;
    eobrun = 0;
    if (br.marker == 0) insufficient = false;
  }

  // jdmarker.c jpeg_resync_to_restart
  void resync(int desired) {
    for (;;) {
      int marker = br.marker;
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
        br.marker = 0;
        return;
      }
      if (action == 3) return;
      pos = br.pos;
      br.marker = next_marker();
      br.pos = pos;
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
};

// ----- jidctint.c jpeg_idct_islow
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
                  F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
                  F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

// jdmaster.c prepare_range_limit_table, seen from the IDCT: x & 1023, then
// 0..127 -> x + 128, 128..511 -> 255, 512..895 -> 0, 896..1023 -> x - 896
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int m = 0; m < 1024; m++) {
      if (m < 128) t[m] = static_cast<uint8_t>(m + 128);
      else if (m < 512) t[m] = 255;
      else if (m < 896) t[m] = 0;
      else t[m] = static_cast<uint8_t>(m - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16];
    int64_t z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t v = kRange.t[static_cast<int>(descale(wp[0], kPass1Bits + 3)) & 1023];
      for (int c = 0; c < 8; c++) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    op[0] = kRange.t[static_cast<int>(descale(tmp10 + tmp3, sh)) & 1023];
    op[7] = kRange.t[static_cast<int>(descale(tmp10 - tmp3, sh)) & 1023];
    op[1] = kRange.t[static_cast<int>(descale(tmp11 + tmp2, sh)) & 1023];
    op[6] = kRange.t[static_cast<int>(descale(tmp11 - tmp2, sh)) & 1023];
    op[2] = kRange.t[static_cast<int>(descale(tmp12 + tmp1, sh)) & 1023];
    op[5] = kRange.t[static_cast<int>(descale(tmp12 - tmp1, sh)) & 1023];
    op[3] = kRange.t[static_cast<int>(descale(tmp13 + tmp0, sh)) & 1023];
    op[4] = kRange.t[static_cast<int>(descale(tmp13 - tmp0, sh)) & 1023];
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
// samples into `out` (needs 2 * dw + 8 samples of room).
void upsample_row(const Component& c, int max_h, int max_v, int y, uint8_t* out) {
  const size_t stride = static_cast<size_t>(c.wb) * 8;
  const int hx = max_h / c.h, vx = max_v / c.v;
  const int dw = c.dw, last = c.dh - 1;
  auto row = [&](int r) { return c.plane.data() + static_cast<size_t>(std::min(std::max(r, 0), last)) * stride; };
  if (hx == 1 && vx == 1) {
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

// The decoded image, (height, width, channels) u8, as Pillow hands it over:
// L, RGB, or CMYK inverted ("CMYK;I").
void render(Jpeg& j, uint8_t* out, int threads) {
  for (auto& c : j.comps) {
    if (c.coef.empty()) c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    if (!c.latched) {  // a component no scan named: libjpeg's zero blocks
      if (!j.qt_def[c.tq]) fail("quantization table not defined");
      for (int k = 0; k < 64; k++) c.quant[k] = static_cast<int16_t>(j.qt[c.tq][k]);
    }
    if (j.progressive) {
      // jdcoefct.c smoothing_ok: block smoothing applies where DC is known
      // and an AC coefficient of the first nine is still unrefined
      if (c.coef_bits[0] >= 0)
        for (int k = 1; k <= 9; k++)
          if (c.coef_bits[k] != 0)
            fail("progressive JPEG with incomplete refinement (block smoothing) is not decoded");
    }
    const size_t stride = static_cast<size_t>(c.wb) * 8;
    c.plane.assign(stride * static_cast<size_t>(c.hb) * 8, 0);
    Component* cp = &c;
    parallel_rows(c.hb, threads, [cp, stride](int r0, int r1) {
      for (int br = r0; br < r1; br++)
        for (int bc = 0; bc < cp->wb; bc++)
          idct_islow(&cp->coef[(static_cast<size_t>(br) * cp->bw + bc) * 64], cp->quant,
                     cp->plane.data() + static_cast<size_t>(br) * 8 * stride + static_cast<size_t>(bc) * 8,
                     stride);
    });
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
    if (j.jfif) space = 1;
    else if (j.adobe) space = j.adobe_transform == 0 ? 2 : 1;
    else if (j.comps[0].id == 82 && j.comps[1].id == 71 && j.comps[2].id == 66) space = 2;
    else space = 1;
  } else {
    space = (j.adobe && j.adobe_transform != 0) ? 4 : 3;
  }
  parallel_rows(j.height, threads, [&](int y0, int y1) {
    std::vector<std::vector<uint8_t>> rows(nc);
    for (int ci = 0; ci < nc; ci++)
      rows[ci].assign(static_cast<size_t>(j.comps[ci].dw) * (j.max_h / j.comps[ci].h) + 16, 0);
    for (int y = y0; y < y1; y++) {
      for (int ci = 0; ci < nc; ci++) upsample_row(j.comps[ci], j.max_h, j.max_v, y, rows[ci].data());
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

// Decodes a JPEG into `out`, (height, width, components) u8 (`cap` bytes).
// 0, or -1 with the reason in `err`.
int64_t jpeg_decode(const uint8_t* src, int64_t n, uint8_t* out, int64_t cap, int32_t threads,
                    char* err, int64_t errcap) {
  try {
    Jpeg j(src, static_cast<size_t>(n));
    j.run(false);
    if (!j.have_sof || j.scans == 0) fail("no image data in JPEG file");
    const int64_t need = static_cast<int64_t>(j.width) * j.height * static_cast<int64_t>(j.comps.size());
    if (need > cap) fail("output buffer too small");
    render(j, out, threads);
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
