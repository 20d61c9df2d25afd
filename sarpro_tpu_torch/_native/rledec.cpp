// Run-length decoders: the scanlines Pillow 12.1's C decoders expand from
// SGI, TGA, PCX / DCX, Sun raster and PSD files, and the pixels of its QOI
// decoder. Built at first use with rasterdec.cpp, j2kdec.cpp and
// webpdec.cpp into one library (sarpro_tpu_torch._native) and bound with
// ctypes (a plain C interface, no Python or PyTorch headers). The header of
// each format, its modes and its unpacking of a scanline into pixels are
// read by the io/ module of the format; this file only replays the loops:
//
//   * rle_lines: libImaging's TgaRleDecode.c, PcxDecode.c, SunRleDecode.c
//     and PackDecode.c. Each fills a line buffer of `linebytes` bytes and
//     hands it over when it is full; a packet is taken only when all its
//     bytes are there, so a stream cut short leaves the image unfinished
//     (Pillow's "image file is truncated"), and data after the last line is
//     never read;
//   * sgi_rle_decode: SgiRleDecode.c, which reads the whole file after the
//     512-byte header, its start and length tables, and each row of each
//     channel by expandrow / expandrow2 (one line buffer kept across rows);
//   * bit_decode: BitDecode.c as ImImagePlugin sets it up for an "L*n"
//     image (fill 3, pad 8): n-bit samples packed LSB first into floats,
//     each line starting on a byte, with the bits left in the buffer at the
//     end of a line OR-ed into the next line's first byte, as Pillow does;
//   * qoi_decode: QoiImagePlugin.QoiDecoder's op loop;
//   * icns_rle: IcnsImagePlugin.read_32's run-length channels;
//   * msp_rle: MspImagePlugin.MspDecoder's rows (a row map, then runs and
//     literals per row, all rows into one byte stream);
//   * fli_decode: FliDecode.c, one call of Pillow's `fli` decoder on the
//     bytes ImageFile.load hands it (the frame chunk and its BLACK, BRUN,
//     COPY, LC, SS2, colour and PSTAMP subchunks);
//   * xbm_decode: XbmDecode.c's hex scanner (each byte the two characters
//     after an 'x', a character that is no hex digit read as 0).
//
// Where Pillow fails the decode (a run past the line for PCX and TGA runs,
// an SGI row outside the file), the call returns kOverrun.
#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kOverrun = -1;

enum Kind : int32_t { kTga = 0, kPcx = 1, kSun = 2, kPackbits = 3 };

// Line state shared by the four scanline decoders.
struct Lines {
  uint8_t* out;
  int64_t linebytes, rows, xsize;
  int64_t x = 0, y = 0;
  uint8_t* line() const { return out + y * linebytes; }
  // PcxDecode.c moves the planes of a padded multi-plane line to xsize
  // apart before it unpacks the line.
  void pcx_planes() {
    if (xsize > 0 && linebytes % xsize && linebytes > xsize) {
      const int64_t bands = linebytes / xsize, stride = linebytes / bands;
      for (int64_t i = 1; i < bands; i++)
        std::memmove(line() + i * xsize, line() + i * stride, xsize);
    }
  }
  // true when the last line is done
  bool next_line(Kind kind) {
    if (kind == kPcx) pcx_planes();
    x = 0;
    return ++y >= rows;
  }
};

int64_t tga_rle(Lines& s, const uint8_t* p, int64_t n, int depth) {
  int64_t i = 0;
  while (i < n) {
    int64_t count = depth * static_cast<int64_t>((p[i] & 0x7f) + 1);
    int64_t extra = 0;
    if (p[i] & 0x80) {
      if (n - i < 1 + depth) break;
      if (s.x + count > s.linebytes) return kOverrun;
      for (int64_t k = 0; k < count; k += depth)
        std::memcpy(s.line() + s.x + k, p + i + 1, depth);
      i += 1 + depth;
    } else {
      if (n - i < 1 + count) break;
      const uint8_t* lit = p + i + 1;
      if (s.x + count > s.linebytes) {
        extra = count - (s.linebytes - s.x);
        count = s.linebytes - s.x;
      }
      std::memcpy(s.line() + s.x, lit, count);
      i += 1 + count + extra;
      const uint8_t* rest = lit + count;
      for (;;) {  // a literal packet runs on across lines
        s.x += count;
        if (s.x >= s.linebytes && s.next_line(kTga)) return s.y;
        if (extra == 0) break;
        count = extra < s.linebytes ? extra : s.linebytes;
        std::memcpy(s.line(), rest, count);
        rest += count;
        extra -= count;
      }
      continue;
    }
    s.x += count;
    if (s.x >= s.linebytes && s.next_line(kTga)) return s.y;
  }
  return s.y;
}

int64_t pcx(Lines& s, const uint8_t* p, int64_t n) {
  int64_t i = 0;
  while (i < n) {
    if ((p[i] & 0xC0) == 0xC0) {
      if (n - i < 2) break;
      for (int c = p[i] & 0x3F; c > 0; c--) {
        if (s.x >= s.linebytes) return kOverrun;
        s.line()[s.x++] = p[i + 1];
      }
      i += 2;
    } else {
      s.line()[s.x++] = p[i++];
    }
    if (s.x >= s.linebytes && s.next_line(kPcx)) return s.y;
  }
  return s.y;
}

int64_t sun_rle(Lines& s, const uint8_t* p, int64_t n) {
  int64_t i = 0;
  while (i < n) {
    int64_t count = 1, extra = 0;
    uint8_t value;
    if (p[i] == 0x80) {
      if (n - i < 2) break;
      if (p[i + 1] == 0) {  // a literal 0x80
        value = 0x80;
        s.line()[s.x] = value;
        i += 2;
      } else {
        if (n - i < 3) break;
        count = p[i + 1] + 1;
        value = p[i + 2];
        if (s.x + count > s.linebytes) {
          extra = count - (s.linebytes - s.x);
          count = s.linebytes - s.x;
        }
        std::memset(s.line() + s.x, value, count);
        i += 3;
      }
    } else {
      value = p[i++];
      s.line()[s.x] = value;
    }
    for (;;) {  // a run goes on across lines
      s.x += count;
      if (s.x >= s.linebytes && s.next_line(kSun)) return s.y;
      if (extra == 0) break;
      count = extra < s.linebytes ? extra : s.linebytes;
      std::memset(s.line(), value, count);
      extra -= count;
    }
  }
  return s.y;
}

int64_t packbits(Lines& s, const uint8_t* p, int64_t n) {
  int64_t i = 0;
  while (i < n) {
    if (p[i] & 0x80) {
      if (p[i] == 0x80) {  // no-op
        i++;
        continue;
      }
      if (n - i < 2) break;
      // bytes past the line are dropped
      for (int c = 257 - p[i]; c > 0 && s.x < s.linebytes; c--)
        s.line()[s.x++] = p[i + 1];
      i += 2;
    } else {
      const int64_t count = p[i] + 2;
      if (n - i < count) break;
      for (int64_t k = 1; k < count && s.x < s.linebytes; k++)
        s.line()[s.x++] = p[i + k];
      i += count;
    }
    if (s.x >= s.linebytes && s.next_line(kPackbits)) return s.y;
  }
  return s.y;
}

// expandrow / expandrow2: 1 when the row's last chunk is not its end,
// kOverrun past the row or the data, else 0.
int expand_row(uint8_t* dest, const uint8_t* src, int64_t chunks, int z,
               int64_t xsize, const uint8_t* last, int bpc) {
  int64_t x = 0;
  for (; chunks > 0; chunks--) {
    if (src + (bpc - 1) > last) return kOverrun;
    uint8_t pixel = src[bpc - 1];
    src += bpc;
    if (chunks == 1 && pixel != 0) return 1;
    int count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return kOverrun;
    x += count;
    if (pixel & 0x80) {
      if (src + bpc * count > last) return kOverrun;
      while (count--) {
        std::memcpy(dest, src, bpc);
        src += bpc;
        dest += z * bpc;
      }
    } else {
      if (src + (bpc - 1) > last) return kOverrun;
      while (count--) {
        std::memcpy(dest, src, bpc);
        dest += z * bpc;
      }
      src += bpc;
    }
  }
  return 0;
}

inline int le16(const uint8_t* p) { return p[0] | (p[1] << 8); }

inline int le32(const uint8_t* p) {
  return static_cast<int>(uint32_t(p[0]) | (uint32_t(p[1]) << 8) |
                          (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24));
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | p[3];
}

}  // namespace

extern "C" {

// Scanlines of `kind` (0 TGA, 1 PCX, 2 Sun, 3 PackBits) from src[0:n]
// into out (rows x linebytes, zeroed by the caller): the number of whole
// lines the data holds (rows when complete), or kOverrun. `depth` is TGA's
// pixel size in bytes, `xsize` PCX's width in pixels where its byte planes
// move (0: they do not).
int64_t rle_lines(int32_t kind, const uint8_t* src, int64_t n,
                  int64_t linebytes, int64_t rows, int32_t depth,
                  int64_t xsize, uint8_t* out) {
  if (rows <= 0) return 0;
  if (linebytes <= 0) return kOverrun;
  Lines s{out, linebytes, rows, xsize};
  switch (kind) {
    case kTga:
      return tga_rle(s, src, n, depth);
    case kPcx:
      return pcx(s, src, n);
    case kSun:
      return sun_rle(s, src, n);
    case kPackbits:
      return packbits(s, src, n);
  }
  return kOverrun;
}

// SgiRleDecode over data = the file after its 512-byte header (bufsize
// bytes): out (rows x xsize*bands*bpc, zeroed by the caller) receives the
// line buffer after each row of the tables, in table order. 0 when done
// (rows after an unterminated last chunk stay zero, as in Pillow), or
// kOverrun.
int64_t sgi_rle_decode(const uint8_t* data, int64_t bufsize, int64_t xsize,
                       int64_t ysize, int32_t bands, int32_t bpc,
                       uint8_t* out) {
  const int64_t tablen = static_cast<int64_t>(bands) * ysize;
  if (bufsize < 8 * tablen) return kOverrun;
  const int64_t linebytes = xsize * bands * bpc;
  uint8_t* buffer = new uint8_t[linebytes > 0 ? linebytes : 1]();
  const uint8_t* last = data + bufsize - 1;
  int64_t status = 0;
  for (int64_t row = 0; row < ysize && status == 0; row++) {
    for (int32_t c = 0; c < bands; c++) {
      const int64_t t = row + c * ysize;
      int64_t offset = be32(data + 4 * t);
      // a length past INT_MAX is a negative count of chunks: no chunk
      const int32_t length =
          static_cast<int32_t>(be32(data + 4 * (tablen + t)));
      if (offset < 512) {
        status = kOverrun;
        break;
      }
      offset -= 512;
      const int r = expand_row(buffer + c * bpc, data + offset, length, bands,
                               xsize, last, bpc);
      if (r != 0) {
        status = r;
        break;
      }
    }
    if (status == 0) std::memcpy(out + row * linebytes, buffer, linebytes);
  }
  delete[] buffer;
  return status == kOverrun ? kOverrun : 0;
}

// BitDecode over src[0:n]: out (rows x xsize floats) in decode order; the
// number of lines the data completes.
int64_t bit_decode(const uint8_t* src, int64_t n, int32_t bits,
                   int64_t xsize, int64_t rows, float* out) {
  const uint64_t mask = (uint64_t(1) << bits) - 1;
  uint64_t buffer = 0;
  int64_t count = 0, x = 0, y = 0;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t byte = src[i];
    buffer |= uint64_t(byte) << count;
    count += 8;
    while (count >= bits) {
      const uint64_t v = buffer & mask;
      if (count > 32) {
        buffer = byte >> (8 - (count - bits));
      } else {
        buffer >>= bits;
      }
      count -= bits;
      out[y * xsize + x] = static_cast<float>(v);
      if (++x >= xsize) {
        if (++y >= rows) return y;
        x = 0;
        count = 0;  // the buffer keeps its bits
      }
    }
  }
  return y;
}

// QoiDecoder: `pixels` pixels of `bands` (3 or 4) bytes from src[0:n] into
// out; 0, or kOverrun where Pillow's decoder reads past the data.
int64_t qoi_decode(const uint8_t* src, int64_t n, int64_t pixels,
                   int32_t bands, uint8_t* out) {
  uint8_t seen[64][4];
  bool have[64] = {};
  uint8_t prev[4] = {0, 0, 0, 255};
  const int64_t total = pixels * bands;
  int64_t len = 0, i = 0;
  auto put = [&](const uint8_t* v) {
    for (int b = 0; b < bands; b++, len++)
      if (len < total) out[len] = v[b];
  };
  while (len < total) {
    if (i >= n) return kOverrun;
    const uint8_t byte = src[i++];
    uint8_t v[4];
    if (byte == 0xFE) {
      if (n - i < 3) return kOverrun;
      v[0] = src[i];
      v[1] = src[i + 1];
      v[2] = src[i + 2];
      v[3] = prev[3];
      i += 3;
    } else if (byte == 0xFF) {
      if (n - i < 4) return kOverrun;
      std::memcpy(v, src + i, 4);
      i += 4;
    } else {
      const int op = byte >> 6;
      if (op == 0) {
        const int k = byte & 0x3f;
        if (have[k]) {
          std::memcpy(v, seen[k], 4);
        } else {
          std::memset(v, 0, 4);
        }
      } else if (op == 1) {
        v[0] = static_cast<uint8_t>(prev[0] + ((byte >> 4) & 3) - 2);
        v[1] = static_cast<uint8_t>(prev[1] + ((byte >> 2) & 3) - 2);
        v[2] = static_cast<uint8_t>(prev[2] + (byte & 3) - 2);
        v[3] = prev[3];
      } else if (op == 2) {
        if (i >= n) return kOverrun;
        const uint8_t second = src[i++];
        const int dg = (byte & 0x3f) - 32;
        v[0] = static_cast<uint8_t>(prev[0] + dg + ((second >> 4) - 8));
        v[1] = static_cast<uint8_t>(prev[1] + dg);
        v[2] = static_cast<uint8_t>(prev[2] + dg + ((second & 15) - 8));
        v[3] = prev[3];
      } else {  // a run repeats the previous pixel and adds nothing
        for (int r = (byte & 0x3f) + 1; r > 0 && len < total; r--) put(prev);
        continue;
      }
    }
    std::memcpy(prev, v, 4);
    const int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    std::memcpy(seen[h], v, 4);
    have[h] = true;
    put(v);
  }
  return 0;
}

}  // extern "C"

extern "C" {

// read_32's loop for one channel of `count` bytes from src[0:n] into out:
// the bytes it took, or kOverrun where the channel does not come out at
// exactly `count` bytes (a run past it, or data that ends first).
int64_t icns_rle(const uint8_t* src, int64_t n, int64_t count, uint8_t* out) {
  int64_t i = 0, left = count;
  while (left > 0) {
    if (i >= n) return kOverrun;
    const int byte = src[i++];
    int64_t block;
    if (byte & 0x80) {
      block = byte - 125;
      if (i >= n || block > left) return kOverrun;
      std::memset(out + count - left, src[i++], block);
    } else {
      block = byte + 1;
      if (n - i < block || block > left) return kOverrun;
      std::memcpy(out + count - left, src + i, block);
      i += block;
    }
    left -= block;
  }
  return i;
}

// MspDecoder after its row map (rowlen, `rows` of them): the row bytes from
// src[0:n], each row's runs (0, count, value) and literals (count, bytes)
// or a blank row of `linebytes` 0xFF bytes for a length of 0, into one
// stream of which out keeps the first `cap` bytes. The stream's length,
// -1 for a row cut short, -2 for a run cut short.
int64_t msp_rle(const uint8_t* src, int64_t n, const uint16_t* rowlen,
                int64_t rows, int64_t linebytes, uint8_t* out, int64_t cap) {
  int64_t len = 0, pos = 0;
  auto put = [&](const uint8_t* p, int64_t k) {
    for (int64_t j = 0; j < k; j++, len++)
      if (len < cap) out[len] = p ? p[j] : 0xFF;
  };
  for (int64_t y = 0; y < rows; y++) {
    const int64_t rl = rowlen[y];
    if (rl == 0) {
      put(nullptr, linebytes);
      continue;
    }
    if (n - pos < rl) return -1;
    const uint8_t* row = src + pos;
    pos += rl;
    int64_t idx = 0;
    while (idx < rl) {
      const int type = row[idx++];
      if (type == 0) {
        if (rl - idx < 2) return -2;
        const int count = row[idx];
        const uint8_t v = row[idx + 1];
        for (int j = 0; j < count; j++, len++)
          if (len < cap) out[len] = v;
        idx += 2;
      } else {
        const int64_t k = idx + type <= rl ? type : rl - idx;
        put(row + idx, k);
        idx += type;
      }
    }
  }
  return len;
}

// One call of FliDecode.c on buf[0:bytes] with the "P" image im (ysize x
// xsize, kept across calls): the bytes consumed when it waits for more
// data, or -1 when the call ends, with *err 0 (the frame is done) or
// Pillow's error code (-1 overrun, -2 broken, -3 unknown).
int64_t fli_decode(const uint8_t* buf, int64_t bytes, uint8_t* im,
                   int64_t xsize, int64_t ysize, int32_t* err) {
  constexpr int kOver = -1, kBroken = -2, kUnknown = -3;
  *err = 0;
  if (bytes < 4) return 0;
  const uint8_t* ptr = buf;
  const int framesize = le32(ptr);
  if (bytes + (bytes % 2) < framesize) return 0;
  if (bytes < 8) return *err = kOver, -1;
  if (le16(ptr + 4) != 0xF1FA) return *err = kUnknown, -1;
  const int chunks = le16(ptr + 6);
  ptr += 16;
  bytes -= 16;
  auto line = [&](int64_t y) { return im + y * xsize; };
  for (int c = 0; c < chunks; c++) {
    if (bytes < 10) return *err = kOver, -1;
    const uint8_t* data = ptr + 6;
#define OOB(k)                           \
  if (data + (k) > ptr + bytes) {        \
    *err = kOver;                        \
    return -1;                           \
  }
    switch (le16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {  // SS2, word delta
        const int lines = le16(data);
        data += 2;
        int64_t l = 0, y = 0;
        for (; l < lines && y < ysize; l++, y++) {
          uint8_t* out = line(y);
          OOB(2)
          int packets = le16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= ysize) return *err = kOver, -1;
              out = line(y);
            } else {
              out[xsize - 1] = static_cast<uint8_t>(packets);
            }
            OOB(2)
            packets = le16(data);
            data += 2;
          }
          int p = 0;
          int64_t x = 0;
          for (; p < packets; p++) {
            OOB(2)
            x += data[0];
            if (data[1] >= 128) {
              OOB(4)
              const int i = 256 - data[1];
              if (x + i + i > xsize) break;
              for (int j = 0; j < i; j++) {
                out[x++] = data[2];
                out[x++] = data[3];
              }
              data += 4;
            } else {
              const int i = 2 * data[1];
              if (x + i > xsize) break;
              OOB(2 + i)
              std::memcpy(out + x, data + 2, i);
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) return *err = kOver, -1;
        break;
      }
      case 12: {  // LC, byte delta
        int64_t y = le16(data);
        const int64_t ymax = y + le16(data + 2);
        data += 4;
        for (; y < ymax && y < ysize; y++) {
          uint8_t* out = line(y);
          OOB(1)
          const int packets = *data++;
          int p = 0, i = 0;
          int64_t x = 0;
          for (; p < packets; p++, x += i) {
            OOB(2)
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > xsize) break;
              OOB(3)
              std::memset(out + x, data[2], i);
              data += 3;
            } else {
              i = data[1];
              if (x + i > xsize) break;
              OOB(2 + i)
              std::memcpy(out + x, data + 2, i);
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) return *err = kOver, -1;
        break;
      }
      case 13:  // BLACK
        std::memset(im, 0, xsize * ysize);
        break;
      case 15: {  // BRUN
        for (int64_t y = 0; y < ysize; y++) {
          uint8_t* out = line(y);
          data += 1;
          int64_t x = 0;
          int i = 0;
          for (; x < xsize; x += i) {
            OOB(2)
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > xsize) break;
              OOB(i + 1)
              std::memcpy(out + x, data + 1, i);
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > xsize) break;
              std::memset(out + x, data[1], i);
              data += 2;
            }
          }
          if (x != xsize) return *err = kOver, -1;
        }
        break;
      }
      case 16:  // COPY
        if (INT32_MAX / xsize < ysize) return *err = kOver, -1;
        if (data + xsize * ysize > ptr + bytes) return ptr - buf;
        std::memcpy(im, data, xsize * ysize);
        break;
      default:
        return *err = kUnknown, -1;
    }
#undef OOB
    const int advance = le32(ptr);
    if (advance == 0) return *err = kBroken, -1;
    if (advance < 0 || advance > bytes) return *err = kOver, -1;
    ptr += advance;
    bytes -= advance;
  }
  return -1;
}

// XbmDecode.c over src[0:n]: `rows` lines of `linebytes` bytes into out;
// the number of lines the data completes.
int64_t xbm_decode(const uint8_t* src, int64_t n, int64_t linebytes,
                   int64_t rows, uint8_t* out) {
  auto hex = [](int v) {
    return v >= '0' && v <= '9' ? v - '0'
           : v >= 'a' && v <= 'f' ? v - 'a' + 10
           : v >= 'A' && v <= 'F' ? v - 'A' + 10 : 0;
  };
  int64_t i = 0, k = 0, total = linebytes * rows;
  if (total <= 0) return rows;
  while (true) {
    while (i < n && src[i] != 'x') i++;
    if (n - i < 3) return k / linebytes;
    out[k++] = static_cast<uint8_t>((hex(src[i + 1]) << 4) + hex(src[i + 2]));
    if (k >= total) return rows;
    i += 3;
  }
}

}  // extern "C"
