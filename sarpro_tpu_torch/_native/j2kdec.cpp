// JPEG 2000 (ISO/IEC 15444-1) codestream decoder: the samples OpenJPEG 2.5.4
// gives Pillow 12.1 when Pillow opens a .jp2 / .j2k file, then Pillow's
// unpacking of them into the image's mode. Built at first use with
// rasterdec.cpp into one library (sarpro_tpu_torch._native) and bound with
// ctypes (a plain C interface, no Python or PyTorch headers). Compiled with
// -ffp-contract=off: the 9/7 wavelet and the ICT are float code whose
// rounding must not hang on the compiler.
//
//   * main and tile-part headers: SIZ, COD / COC, QCD / QCC, RGN, POC, PPM,
//     PPT, COM, TLM, PLM, PLT, CRG, tile-parts in any order and in several
//     parts (a tile's RGN / POC added to the main header's, as j2k.c does);
//   * tier-2: tag trees, pass counts, Lblock, SOP / EPH, the packet headers
//     in line or from PPM / PPT, the codeword segments of t2.c (BYPASS,
//     TERMALL, a second segment past 109 passes), the five progression
//     orders and POC's progressions over the precinct geometry of pi.c;
//   * tier-1 (EBCOT): the MQ and raw decoders, the significance, refinement
//     and cleanup passes under the six code-block styles (BYPASS, RESET,
//     TERMALL, VSC, PTERM, SEGSYM), OpenJPEG's reconstruction (a decoded
//     magnitude sits at the middle of its last bit-plane: t1.c's
//     "oneplushalf"), the RGN maxshift scaling;
//   * HTJ2K code-blocks (ISO/IEC 15444-15, code-block style 0x40): ht_dec.c's
//     cleanup pass (MagSgn, MEL and VLC streams, U-VLC, the EMB bits and
//     exponents; its tables in ht_tables.h, generated from Pillow's
//     libopenjp2 by ht_tables.py) and its SigProp and MagRef passes (VSC's
//     stripe-causal context), t2.c's HT segments (the cleanup pass one,
//     the refinement passes the next), and OpenJPEG's checks: a damaged
//     block refused or decoded to OpenJPEG's values, its warnings decoding
//     on with fewer passes;
//   * dequantisation and the inverse 5/3 (integer, its int32 sums wrapping
//     as dwt.c's do) and 9/7 (float, dwt.c's lifting constants, the 2/K
//     high-band scale and order of operations), up to the highest
//     resolution a component's packets reach;
//   * components sub-sampled by any (dx, dy): their tile-components,
//     resolutions and precincts on the sub-sampled grid (tcd.c, pi.c), the
//     RCT / ICT only over components of one size (opj_tcd_mct_decode);
//   * the DC level shift, lrintf and the clamp of tcd.c, precisions up to
//     OpenJPEG's 31 bits;
//   * Pillow's Jpeg2KDecode.c unpackers over the tile buffer OpenJPEG fills:
//     its per-component offsets and strides (W / dx, H / dy, whatever the
//     sizes OpenJPEG wrote), the shift to 8 (or 16) bits with its rounding
//     offset, the signed offset, the stores to u8 / u16 that wrap, and the
//     YCbCr to RGB of its sYCC unpackers (ConvertYCbCr.c's tables).
//
// Refused with a message that names the feature: mixed HT / Part-1
// code-blocks (style 0x80, as OpenJPEG refuses them), an ROI shift or more
// than 3 passes over HT code-blocks (ht_dec.c refuses both), Part-2
// wavelets, quantization, coding styles and multiple component transforms,
// precisions above 31 bits, and any codestream cut short or malformed
// where OpenJPEG in Pillow's strict mode refuses it too.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "ht_tables.h"

namespace {

struct J2kError {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw J2kError{what}; }

std::string hex4(int v) {
  char b[16];
  std::snprintf(b, sizeof b, "0x%04X", v & 0xFFFF);
  return b;
}

inline int64_t ceildivpow2(int64_t a, int e) { return (a + (int64_t{1} << e) - 1) >> e; }
inline int64_t floordivpow2(int64_t a, int e) { return a >> e; }
inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
// int32 sums that wrap, as OpenJPEG's integer code wraps on precisions
// near 31 bits
inline int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
inline int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// ---------------------------------------------------------------------------
// header structures
// ---------------------------------------------------------------------------
struct CompSiz {
  int prec = 8;
  bool sgnd = false;
  int dx = 1, dy = 1;
};

struct Coding {  // SPcod / SPcoc
  int levels = 5, cbw = 6, cbh = 6, style = 0, transform = 0;
  uint8_t prc[33];
  Coding() { std::memset(prc, 0xFF, sizeof prc); }
};

struct Quant {  // SPqcd / SPqcc
  int style = 0, guard = 2;
  uint16_t expn[97] = {}, mant[97] = {};
};

struct Poc {  // one progression of a POC segment (j2k.c, opj_poc_t)
  int resno0, compno0, layno1, resno1, compno1, prog;
};

struct Params {
  int prog = 0, layers = 1, mct = 0;
  bool sop = false, eph = false;
  std::vector<Coding> coding;
  std::vector<Quant> quant;
  std::vector<int> roishift;  // SPrgn of each component (RGN)
  std::vector<Poc> pocs;      // the progressions of POC segments, in order
};

struct Siz {
  int64_t X = 0, Y = 0, XO = 0, YO = 0, XT = 0, YT = 0, XTO = 0, YTO = 0;
  int nc = 0;
  std::vector<CompSiz> comps;
  int64_t ntx = 0, nty = 0;
};

struct Reader {
  const uint8_t* p;
  size_t n, pos = 0;
  Reader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  void need(size_t k) const {
    if (pos + k > n) fail("codestream cut short");
  }
  int u8() {
    need(1);
    return p[pos++];
  }
  int u16() {
    need(2);
    int v = (p[pos] << 8) | p[pos + 1];
    pos += 2;
    return v;
  }
  uint32_t u32() {
    need(4);
    uint32_t v = (uint32_t{p[pos]} << 24) | (uint32_t{p[pos + 1]} << 16) |
                 (uint32_t{p[pos + 2]} << 8) | p[pos + 3];
    pos += 4;
    return v;
  }
};

// code-block styles (Table A.19; HT and HT_MIXED of ISO/IEC 15444-15)
enum : int {
  BYPASS = 0x01, RESET = 0x02, TERMALL = 0x04, VSC = 0x08, SEGSYM = 0x20, HT = 0x40, HT_MIXED = 0x80
};

// SPcod / SPcoc: levels, code-block size and style, wavelet, precincts
void read_spcod(Reader& r, size_t end, bool custom_prec, Coding& c) {
  c.levels = r.u8();
  if (c.levels > 32) fail("more than 32 decomposition levels");
  c.cbw = r.u8() + 2;
  c.cbh = r.u8() + 2;
  if (c.cbw > 10 || c.cbh > 10 || c.cbw + c.cbh > 12)
    fail("invalid code-block size");
  c.style = r.u8();
  // j2k.c refuses a mixed style as it reads it ("Unsupported Mixed HT
  // code-block style")
  if (c.style & HT_MIXED)
    fail("code-block style not decoded by the port (nor by OpenJPEG): HTJ2K mixed (HT and Part-1) code-blocks");
  c.transform = r.u8();
  if (c.transform > 1) fail("Part-2 wavelet transform (" + std::to_string(c.transform) + ")");
  if (custom_prec) {
    for (int i = 0; i <= c.levels; ++i) {
      c.prc[i] = static_cast<uint8_t>(r.u8());
      if (i > 0 && ((c.prc[i] & 0xF) == 0 || (c.prc[i] >> 4) == 0))
        fail("invalid precinct size");
    }
  } else {
    std::memset(c.prc, 0xFF, sizeof c.prc);
  }
  if (r.pos != end) fail("COD/COC segment of the wrong length");
}

void read_sqcd(Reader& r, size_t end, Quant& q) {
  int s = r.u8();
  q.style = s & 0x1F;
  q.guard = s >> 5;
  if (q.style > 2) fail("Part-2 quantization style (" + std::to_string(q.style) + ")");
  std::fill(std::begin(q.expn), std::end(q.expn), 0);
  std::fill(std::begin(q.mant), std::end(q.mant), 0);
  // j2k.c reads every band the segment holds (keeping the first 97) and
  // refuses a segment with bytes left over
  const size_t left = end > r.pos ? end - r.pos : 0;
  if (q.style == 0) {
    for (size_t b = 0; b < left; ++b) {
      const int v = r.u8();
      if (b < 97) q.expn[b] = static_cast<uint16_t>(v >> 3);
    }
  } else {
    const size_t nb = q.style == 1 ? 1 : left / 2;
    if (nb < 1 || 2 * nb != left) fail("QCD/QCC segment of the wrong length");
    for (size_t b = 0; b < nb; ++b) {
      const int v = r.u16();
      if (b >= 97) continue;
      q.expn[b] = static_cast<uint16_t>(v >> 11);
      q.mant[b] = static_cast<uint16_t>(v & 0x7FF);
    }
    if (q.style == 1)  // scalar derived (j2k.c, opj_j2k_read_SQcd_SQcc)
      for (int b = 1; b < 97; ++b) {
        int e = q.expn[0] - (b - 1) / 3;
        q.expn[b] = static_cast<uint16_t>(e > 0 ? e : 0);
        q.mant[b] = q.mant[0];
      }
  }
  r.pos = end;
}

// a COD, COC, QCD or QCC segment [r.pos, end) into `p`; `coc_set` /
// `qcc_set` mark the components a COC / QCC of this header has set, so a
// COD / QCD read after it leaves them as they are
void read_coding_marker(int m, Reader& r, size_t end, const Siz& siz, Params& p,
                        std::vector<char>& coc_set, std::vector<char>& qcc_set) {
  if (m == 0xFF52) {  // COD
    int scod = r.u8();
    if (scod & ~0x07) fail("Part-2 coding style (Scod " + std::to_string(scod) + ")");
    p.prog = r.u8();
    if (p.prog > 4) fail("unknown progression order " + std::to_string(p.prog));
    p.layers = r.u16();
    if (p.layers == 0) fail("no quality layers");
    p.mct = r.u8();
    if (p.mct > 1) fail("Part-2 multiple component transform (" + std::to_string(p.mct) + ")");
    p.sop = scod & 2;
    p.eph = scod & 4;
    Coding c;
    read_spcod(r, end, scod & 1, c);
    for (int i = 0; i < siz.nc; ++i)
      if (!coc_set[i]) p.coding[i] = c;
  } else if (m == 0xFF53) {  // COC
    int comp = siz.nc < 257 ? r.u8() : r.u16();
    if (comp >= siz.nc) fail("COC for a component past Csiz");
    int scoc = r.u8();
    read_spcod(r, end, scoc & 1, p.coding[comp]);
    coc_set[comp] = 1;
  } else if (m == 0xFF5C) {  // QCD
    Quant q;
    read_sqcd(r, end, q);
    for (int i = 0; i < siz.nc; ++i)
      if (!qcc_set[i]) p.quant[i] = q;
  } else {  // QCC
    int comp = siz.nc < 257 ? r.u8() : r.u16();
    if (comp >= siz.nc) fail("QCC for a component past Csiz");
    read_sqcd(r, end, p.quant[comp]);
    qcc_set[comp] = 1;
  }
}

// RGN (j2k.c, opj_j2k_read_rgn): Crgn, Srgn (read, any value taken as
// the implicit style), SPrgn, the component's ROI shift
void read_rgn(Reader& r, size_t end, const Siz& siz, Params& p) {
  const size_t room = siz.nc <= 256 ? 1 : 2;
  if (end - r.pos != 2 + room) fail("RGN segment of the wrong length");
  const int comp = room == 1 ? r.u8() : r.u16();
  r.u8();
  if (comp >= siz.nc) fail("RGN for a component past Csiz");
  p.roishift[comp] = r.u8();
}

// POC (j2k.c, opj_j2k_read_poc): the segment's progressions appended to
// those the header already holds (a tile's start as a copy of the main
// header's); the last layer bounded by the layers COD has set so far, the
// last component by Csiz
void read_poc(Reader& r, size_t end, const Siz& siz, Params& p, int layers_now) {
  const size_t room = siz.nc <= 256 ? 1 : 2, chunk = 5 + 2 * room;
  const size_t n = end - r.pos;
  if (n == 0 || n % chunk) fail("POC segment of the wrong length");
  if (p.pocs.size() + n / chunk >= 32) fail("more than 31 progressions in POC segments");
  for (size_t k = 0; k < n / chunk; ++k) {
    Poc q;
    q.resno0 = r.u8();
    q.compno0 = room == 1 ? r.u8() : r.u16();
    q.layno1 = std::min(r.u16(), layers_now);
    q.resno1 = r.u8();
    q.compno1 = std::min(room == 1 ? r.u8() : r.u16(), siz.nc);
    q.prog = r.u8();
    p.pocs.push_back(q);
  }
}

// a PPM or PPT segment's data, by its Zppm / Zppt
struct Ppx {
  bool seen = false;
  size_t begin = 0, end = 0;
};

void read_ppx(Reader& r, size_t end, std::vector<Ppx>& z, const char* name) {
  if (end - r.pos < 2) fail(std::string(name) + " segment of the wrong length");
  Ppx& x = z[r.u8()];
  if (x.seen) fail(std::string("a second ") + name + " segment of the same index");
  x = {true, r.pos, end};
}

enum : int { IN_MAIN = 1, IN_TILE = 2, UNKNOWN = -1 };

// j2k.c's marker table: where each marker it knows may stand (SOT opens a
// tile-part from the main header or after one; SOP stands in no header)
int marker_places(int m) {
  switch (m) {
    case 0xFF90: return IN_MAIN;
    case 0xFF52: case 0xFF53: case 0xFF5E: case 0xFF5C: case 0xFF5D: case 0xFF5F:
    case 0xFF64: case 0xFF74: case 0xFF75: case 0xFF77: return IN_MAIN | IN_TILE;
    case 0xFF51: case 0xFF55: case 0xFF57: case 0xFF60: case 0xFF63: case 0xFF78:
    case 0xFF50: case 0xFF59: return IN_MAIN;
    case 0xFF58: case 0xFF61: return IN_TILE;
    case 0xFF91: return 0;
    default: return UNKNOWN;
  }
}

// the next marker a header reads at r.pos, as j2k.c reads it: past an
// unknown marker (opj_j2k_read_unk) the 2-byte words that follow it, with
// no regard to its length, up to a marker it knows; a known marker must
// stand where its table entry says
int next_marker(Reader& r, int place) {
  int m = r.u16();
  if (m < 0xFF00) fail("expected a marker in a header, found " + hex4(m));
  if (place == IN_TILE && m == 0xFF93) return m;  // SOD
  while (marker_places(m) == UNKNOWN) {
    do m = r.u16();
    while (m < 0xFF00 || marker_places(m) == UNKNOWN);
  }
  if (!(marker_places(m) & place)) fail("marker " + hex4(m) + " is not compliant with its position");
  return m;
}

[[noreturn]] void refuse_part2(int m) {
  fail("Part-2 multiple component transform markers (" + hex4(m) + ") are not decoded by the port");
}

bool part2_marker(int m) { return m == 0xFF74 || m == 0xFF75 || m == 0xFF77 || m == 0xFF78; }

struct TilePart {
  size_t begin, end;  // packet data
};

struct Tile {
  Params params;
  bool seen = false;
  int nparts = 0;       // TNsot, where a tile-part gave it
  int64_t done_at = -1;  // the tile-part (in codestream order) that completed it
  std::vector<char> coc_set, qcc_set;
  std::vector<TilePart> parts;
  std::vector<Ppx> ppt;  // its PPT segments by Zppt, where it has any
};

struct Codestream {
  Siz siz;
  Params main;
  std::vector<Tile> tiles;
  const uint8_t* data = nullptr;
  bool has_ppm = false;
  std::vector<uint8_t> ppm;  // every packet header of the codestream (PPM)
};

// j2k.c's opj_j2k_merge_ppm: the PPM segments in Zppm order, each tile-part's
// Nppm and its headers, one stream of headers (an Nppm group may run on
// into the next segment)
std::vector<uint8_t> merge_ppm(const uint8_t* src, const std::vector<Ppx>& z) {
  std::vector<uint8_t> out;
  uint64_t remaining = 0;
  for (const Ppx& x : z) {
    if (!x.seen) continue;
    const uint8_t* d = src + x.begin;
    size_t n = x.end - x.begin;
    const size_t take = static_cast<size_t>(std::min<uint64_t>(remaining, n));
    out.insert(out.end(), d, d + take);
    d += take;
    n -= take;
    remaining -= take;
    while (n > 0) {
      if (n < 4) fail("not enough bytes to read Nppm in a PPM segment");
      const uint64_t nppm = (uint64_t{d[0]} << 24) | (uint64_t{d[1]} << 16) | (uint64_t{d[2]} << 8) | d[3];
      d += 4;
      n -= 4;
      if (out.size() + nppm > UINT32_MAX) fail("too large a value for Nppm");
      const size_t k = static_cast<size_t>(std::min<uint64_t>(nppm, n));
      out.insert(out.end(), d, d + k);
      d += k;
      n -= k;
      remaining = nppm - k;
    }
  }
  if (remaining) fail("corrupted PPM segments (an Nppm runs past the last one)");
  return out;
}

Codestream parse(const uint8_t* src, size_t n) {
  Codestream cs;
  cs.data = src;
  Reader r(src, n);
  if (r.u16() != 0xFF4F) fail("no SOC marker");
  if (r.u16() != 0xFF51) fail("no SIZ marker after SOC");
  size_t lsiz = static_cast<size_t>(r.u16());
  size_t siz_end = r.pos - 2 + lsiz;
  Siz& s = cs.siz;
  r.u16();  // Rsiz: j2k.c decodes Part-1 code-blocks whatever its bits
  s.X = r.u32();
  s.Y = r.u32();
  s.XO = r.u32();
  s.YO = r.u32();
  s.XT = r.u32();
  s.YT = r.u32();
  s.XTO = r.u32();
  s.YTO = r.u32();
  s.nc = r.u16();
  if (s.nc < 1 || s.nc > 16384) fail("invalid component count");
  if (lsiz != 38 + 3 * static_cast<size_t>(s.nc)) fail("invalid SIZ length");
  if (s.X <= s.XO || s.Y <= s.YO || s.XT == 0 || s.YT == 0 || s.XTO > s.XO ||
      s.YTO > s.YO || s.XTO + s.XT <= s.XO || s.YTO + s.YT <= s.YO)
    fail("invalid image or tile geometry in SIZ");
  s.comps.resize(s.nc);
  for (auto& c : s.comps) {
    int ssiz = r.u8();
    c.prec = (ssiz & 0x7F) + 1;
    c.sgnd = ssiz & 0x80;
    c.dx = r.u8();
    c.dy = r.u8();
    if (c.dx == 0 || c.dy == 0) fail("invalid component sub-sampling");
    if (c.prec > 38) fail("invalid component precision");
    if (c.prec > 31) fail("component precision above 31 bits (OpenJPEG's limit)");
  }
  r.pos = siz_end;
  s.ntx = ceildiv(s.X - s.XTO, s.XT);
  s.nty = ceildiv(s.Y - s.YTO, s.YT);
  if (s.ntx * s.nty > 65535) fail("more than 65535 tiles");
  cs.main.coding.resize(s.nc);
  cs.main.quant.resize(s.nc);
  cs.main.roishift.assign(s.nc, 0);
  std::vector<char> coc(s.nc, 0), qcc(s.nc, 0);
  std::vector<Ppx> ppm(256);
  bool cod = false, qcd = false;
  // main header, up to the first SOT
  for (;;) {
    const int m = next_marker(r, IN_MAIN);
    if (m == 0xFF90) break;
    if (m == 0xFF51) fail("a second SIZ marker");
    size_t len = static_cast<size_t>(r.u16());
    if (len < 2) fail("invalid marker segment length");
    size_t end = r.pos - 2 + len;
    if (end > n) fail("codestream cut short");
    if (part2_marker(m)) refuse_part2(m);
    if (m == 0xFF52 || m == 0xFF53 || m == 0xFF5C || m == 0xFF5D) {
      read_coding_marker(m, r, end, s, cs.main, coc, qcc);
      cod |= m == 0xFF52;
      qcd |= m == 0xFF5C;
    } else if (m == 0xFF5E) {
      read_rgn(r, end, s, cs.main);
    } else if (m == 0xFF5F) {
      read_poc(r, end, s, cs.main, cod ? cs.main.layers : 0);
    } else if (m == 0xFF60) {
      read_ppx(r, end, ppm, "PPM");
      cs.has_ppm = true;
    }
    r.pos = end;  // TLM, PLM, CRG, COM, CAP and CPF segments are skipped
  }
  if (!cod) fail("no COD marker in the main header");
  if (!qcd) fail("no QCD marker in the main header");
  if (cs.has_ppm) cs.ppm = merge_ppm(src, ppm);
  cs.tiles.resize(static_cast<size_t>(s.ntx * s.nty));
  // tile-parts; r.pos is just past an SOT marker
  for (int64_t tp_index = 0;; ++tp_index) {
    size_t sot = r.pos - 2;
    if (r.u16() != 10) fail("invalid SOT length");
    int isot = r.u16();
    uint32_t psot = r.u32();
    const int tpsot = r.u8(), tnsot = r.u8();
    if (isot >= static_cast<int>(cs.tiles.size())) fail("tile index past the tile count");
    size_t end = psot ? sot + psot : n - 2;
    if (psot && psot < 14) fail("invalid Psot");
    if (end > n) fail("codestream cut short (a tile-part runs past the end)");
    Tile& t = cs.tiles[isot];
    // j2k.c's opj_j2k_read_sot: the parts of a tile come in order, and
    // below the count a TNsot gives
    if (tnsot != 0) {
      if ((t.nparts && tpsot >= t.nparts) || tpsot >= tnsot)
        fail("tile-part index past the tile's part count (TPsot / TNsot)");
      t.nparts = tnsot;
    }
    if (tpsot != static_cast<int>(t.parts.size()))
      fail("tile-part out of order (TPsot " + std::to_string(tpsot) + ")");
    if (t.nparts && tpsot + 1 == t.nparts) t.done_at = tp_index;
    if (!t.seen) {
      t.seen = true;
      t.params = cs.main;
      t.coc_set.assign(s.nc, 0);
      t.qcc_set.assign(s.nc, 0);
    }
    for (;;) {
      const int m = next_marker(r, IN_TILE);
      if (m == 0xFF93) break;
      size_t len = static_cast<size_t>(r.u16());
      if (len < 2) fail("invalid marker segment length");
      size_t mend = r.pos - 2 + len;
      if (mend > end) fail("tile-part header runs past its tile-part");
      if (part2_marker(m)) refuse_part2(m);
      if (m == 0xFF52 || m == 0xFF53 || m == 0xFF5C || m == 0xFF5D) {
        read_coding_marker(m, r, mend, s, t.params, t.coc_set, t.qcc_set);
      } else if (m == 0xFF5E) {
        read_rgn(r, mend, s, t.params);
      } else if (m == 0xFF5F) {
        read_poc(r, mend, s, t.params, t.params.layers);
      } else if (m == 0xFF61) {
        if (cs.has_ppm) fail("a PPT segment in a codestream with PPM segments");
        if (t.ppt.empty()) t.ppt.resize(256);
        read_ppx(r, mend, t.ppt, "PPT");
      }
      r.pos = mend;  // PLT and COM segments are skipped
    }
    if (r.pos > end) fail("tile-part header runs past its tile-part");
    t.parts.push_back({r.pos, end});
    r.pos = end;
    if (r.pos + 2 > n) fail("codestream cut short (no EOC marker)");
    int m = r.u16();
    if (m == 0xFFD9) break;
    if (m != 0xFF90) fail("expected SOT or EOC after a tile-part, found " + hex4(m));
  }
  return cs;
}

// ---------------------------------------------------------------------------
// tier-2
// ---------------------------------------------------------------------------
struct Bio {  // bio.c: packet header bits, a 0 bit stuffed after each 0xFF
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* p, size_t n) : start(p), bp(p), end(p + n) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
  size_t numbytes() const { return static_cast<size_t>(bp - start); }
};

struct TagTree {  // tgt.c
  std::vector<int> value, low, parent;
  void init(int w, int h) {
    value.clear();
    low.clear();
    parent.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> lw{w}, lh{h}, base{0};
    int total = w * h;
    while (lw.back() * lh.back() > 1) {
      base.push_back(total);
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
      total += lw.back() * lh.back();
    }
    parent.assign(total, -1);
    for (size_t l = 0; l + 1 < lw.size(); ++l)
      for (int y = 0; y < lh[l]; ++y)
        for (int x = 0; x < lw[l]; ++x)
          parent[base[l] + y * lw[l] + x] = base[l + 1] + (y / 2) * lw[l + 1] + x / 2;
    value.assign(total, 999);
    low.assign(total, 0);
  }
  bool decode(Bio& bio, int leaf, int threshold) {
    int stk[40];
    int sp = 0;
    int node = leaf;
    while (parent[node] >= 0) {
      stk[sp++] = node;
      node = parent[node];
    }
    int lo = 0;
    for (;;) {
      if (lo > low[node])
        low[node] = lo;
      else
        lo = low[node];
      while (lo < threshold && lo < value[node]) {
        if (bio.bit())
          value[node] = lo;
        else
          ++lo;
      }
      low[node] = lo;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return value[node] < threshold;
  }
};

// a codeword segment (t2.c / tcd.h's opj_tcd_seg_t): up to `maxpasses`
// passes, decoded by one MQ (or raw) decoder from its own bytes
struct Seg {
  int maxpasses = 0, numpasses = 0, newpasses = 0;
  uint32_t len = 0, newlen = 0;
};

struct Cblk {
  int64_t x0, y0, x1, y1;
  int numbps = 0, lenbits = 3, newpasses = 0;
  int numsegs = 0;  // the segments that hold data (the block is included once > 0)
  std::vector<Seg> segs;
  std::vector<std::pair<size_t, uint32_t>> chunks;  // in the tile's data, in order
};

struct Precinct {
  int cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int orient = 0;  // 0 LL, 1 HL, 2 LH, 3 HH (tcd.c's bandno)
  int64_t x0, y0, x1, y1;
  int Mb = 0;
  float step = 1.0f;
  int64_t xoff = 0, yoff = 0;  // its place in the tile-component's buffer
  std::vector<Precinct> precs;
};

struct Resolution {
  int64_t x0, y0, x1, y1;
  int pdx = 15, pdy = 15;
  int64_t pw = 0, ph = 0;
  std::vector<Band> bands;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  int levels = 0, transform = 0;
  std::vector<Resolution> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
  int64_t w() const { return x1 - x0; }
  int64_t h() const { return y1 - y0; }
};

void init_tilecomp(TileComp& tc, const CompSiz& cs, const Coding& cod, const Quant& q,
                   int64_t tx0, int64_t ty0, int64_t tx1, int64_t ty1) {
  tc.x0 = ceildiv(tx0, cs.dx);
  tc.y0 = ceildiv(ty0, cs.dy);
  tc.x1 = ceildiv(tx1, cs.dx);
  tc.y1 = ceildiv(ty1, cs.dy);
  tc.levels = cod.levels;
  tc.transform = cod.transform;
  tc.res.resize(cod.levels + 1);
  for (int r = 0; r <= cod.levels; ++r) {
    Resolution& res = tc.res[r];
    const int lev = cod.levels - r;
    res.x0 = ceildivpow2(tc.x0, lev);
    res.y0 = ceildivpow2(tc.y0, lev);
    res.x1 = ceildivpow2(tc.x1, lev);
    res.y1 = ceildivpow2(tc.y1, lev);
    res.pdx = cod.prc[r] & 0xF;
    res.pdy = cod.prc[r] >> 4;
    const int64_t prx0 = floordivpow2(res.x0, res.pdx) << res.pdx;
    const int64_t pry0 = floordivpow2(res.y0, res.pdy) << res.pdy;
    const int64_t prx1 = ceildivpow2(res.x1, res.pdx) << res.pdx;
    const int64_t pry1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
    res.pw = res.x0 == res.x1 ? 0 : (prx1 - prx0) >> res.pdx;
    res.ph = res.y0 == res.y1 ? 0 : (pry1 - pry0) >> res.pdy;
    int64_t cbgx0, cbgy0;
    int cbgw, cbgh;
    if (r == 0) {
      cbgx0 = prx0;
      cbgy0 = pry0;
      cbgw = res.pdx;
      cbgh = res.pdy;
    } else {
      cbgx0 = ceildivpow2(prx0, 1);
      cbgy0 = ceildivpow2(pry0, 1);
      cbgw = res.pdx - 1;
      cbgh = res.pdy - 1;
    }
    const int cbw = std::min(cod.cbw, cbgw), cbh = std::min(cod.cbh, cbgh);
    const int nbands = r == 0 ? 1 : 3;
    res.bands.resize(nbands);
    for (int b = 0; b < nbands; ++b) {
      Band& band = res.bands[b];
      band.orient = r == 0 ? 0 : b + 1;
      if (r == 0) {
        band.x0 = res.x0;
        band.y0 = res.y0;
        band.x1 = res.x1;
        band.y1 = res.y1;
      } else {
        const int64_t xob = band.orient & 1, yob = band.orient >> 1;
        band.x0 = ceildivpow2(tc.x0 - (xob << lev), lev + 1);
        band.y0 = ceildivpow2(tc.y0 - (yob << lev), lev + 1);
        band.x1 = ceildivpow2(tc.x1 - (xob << lev), lev + 1);
        band.y1 = ceildivpow2(tc.y1 - (yob << lev), lev + 1);
        const Resolution& prev = tc.res[r - 1];
        if (band.orient & 1) band.xoff = prev.x1 - prev.x0;
        if (band.orient & 2) band.yoff = prev.y1 - prev.y0;
      }
      const int idx = r == 0 ? 0 : 3 * (r - 1) + b + 1;
      const int expn = idx < 97 ? q.expn[idx] : 0;
      const int mant = idx < 97 ? q.mant[idx] : 0;
      // tcd.c: the 5/3 gains 0, 1, 1, 2 (opj_dwt_getgain); the 9/7 gain is 0
      // (opj_dwt_getgain_real), its high bands take 2/K in the lifting
      const int gain = cod.transform == 1 ? (band.orient == 0 ? 0 : band.orient == 3 ? 2 : 1) : 0;
      band.step = static_cast<float>((1.0 + mant / 2048.0) * std::pow(2.0, cs.prec + gain - expn));
      band.Mb = expn + q.guard - 1;
      band.precs.resize(static_cast<size_t>(res.pw * res.ph));
      for (int64_t p = 0; p < res.pw * res.ph; ++p) {
        Precinct& pr = band.precs[p];
        const int64_t gx0 = cbgx0 + (p % res.pw) * (int64_t{1} << cbgw);
        const int64_t gy0 = cbgy0 + (p / res.pw) * (int64_t{1} << cbgh);
        const int64_t px0 = std::max(gx0, band.x0), py0 = std::max(gy0, band.y0);
        const int64_t px1 = std::min(gx0 + (int64_t{1} << cbgw), band.x1);
        const int64_t py1 = std::min(gy0 + (int64_t{1} << cbgh), band.y1);
        if (px0 >= px1 || py0 >= py1) continue;
        const int64_t cbx0 = floordivpow2(px0, cbw) << cbw, cby0 = floordivpow2(py0, cbh) << cbh;
        pr.cw = static_cast<int>(((ceildivpow2(px1, cbw) << cbw) - cbx0) >> cbw);
        pr.ch = static_cast<int>(((ceildivpow2(py1, cbh) << cbh) - cby0) >> cbh);
        pr.cblks.resize(static_cast<size_t>(pr.cw) * pr.ch);
        for (int k = 0; k < pr.cw * pr.ch; ++k) {
          Cblk& cb = pr.cblks[k];
          const int64_t x = cbx0 + int64_t{k % pr.cw} * (int64_t{1} << cbw);
          const int64_t y = cby0 + int64_t{k / pr.cw} * (int64_t{1} << cbh);
          cb.x0 = std::max(x, px0);
          cb.y0 = std::max(y, py0);
          cb.x1 = std::min(x + (int64_t{1} << cbw), px1);
          cb.y1 = std::min(y + (int64_t{1} << cbh), py1);
        }
        pr.incl.init(pr.cw, pr.ch);
        pr.imsb.init(pr.cw, pr.ch);
      }
    }
  }
}

struct Packet {
  int layer, res, comp;
  int64_t prec;
};

// pi.c's order of the packets of a tile: one progression of the tile's own
// order and bounds, or the POC progressions in turn (opj_pi_update_decode_poc:
// each from layer 0 up to its last, a packet already emitted skipped as
// pi->include does it); an unknown order, or a first component past the
// last, emits nothing
std::vector<Packet> packet_order(const Params& p, const std::vector<TileComp>& tcs,
                                 const Siz& siz, int64_t tx0, int64_t ty0, int64_t tx1,
                                 int64_t ty1) {
  const int nc = static_cast<int>(tcs.size());
  int maxres = 0;
  int64_t maxprec = 0;
  for (const auto& tc : tcs) {
    maxres = std::max(maxres, tc.levels + 1);
    for (const auto& r : tc.res) maxprec = std::max(maxprec, r.pw * r.ph);
  }
  std::vector<Poc> progs = p.pocs;
  if (progs.empty()) progs.push_back({0, 0, p.layers, maxres, nc, p.prog});
  std::vector<Packet> out;
  std::vector<char> seen(static_cast<size_t>(p.layers) * maxres * nc * std::max<int64_t>(maxprec, 1), 0);
  auto take = [&](int l, int r, int c, int64_t k) {
    const size_t idx = ((static_cast<size_t>(l) * maxres + r) * nc + c) * maxprec + k;
    if (seen[idx]) return;
    seen[idx] = 1;
    out.push_back({l, r, c, k});
  };
  // the packets of component c, resolution r at the position (x, y) of a
  // position-driven order, layers [0, l1)
  auto emit = [&](int c, int r, int64_t x, int64_t y, int l1) {
    const TileComp& tc = tcs[c];
    if (r > tc.levels) return;
    const Resolution& res = tc.res[r];
    const int lev = tc.levels - r;
    const int64_t dx = siz.comps[c].dx, dy = siz.comps[c].dy;
    const int64_t trx0 = ceildiv(tx0, dx << lev), try0 = ceildiv(ty0, dy << lev);
    const int64_t trx1 = ceildiv(tx1, dx << lev), try1 = ceildiv(ty1, dy << lev);
    const int rpx = res.pdx + lev, rpy = res.pdy + lev;
    if (rpx >= 62 || rpy >= 62) return;
    if (!((y % (dy << rpy)) == 0 || (y == ty0 && ((try0 << lev) % (int64_t{1} << rpy)))))
      return;
    if (!((x % (dx << rpx)) == 0 || (x == tx0 && ((trx0 << lev) % (int64_t{1} << rpx)))))
      return;
    if (res.pw == 0 || res.ph == 0) return;
    if (trx0 == trx1 || try0 == try1) return;
    const int64_t prci = floordivpow2(ceildiv(x, dx << lev), res.pdx) - floordivpow2(trx0, res.pdx);
    const int64_t prcj = floordivpow2(ceildiv(y, dy << lev), res.pdy) - floordivpow2(try0, res.pdy);
    const int64_t k = prci + prcj * res.pw;
    if (k < 0 || k >= res.pw * res.ph) return;
    for (int l = 0; l < l1; ++l) take(l, r, c, k);
  };
  // the position steps of components [c0, c1): pi.c's dx / dy
  auto steps = [&](int c0, int c1, int64_t& sx, int64_t& sy) {
    sx = 0;
    sy = 0;
    for (int c = c0; c < c1; ++c)
      for (int r = 0; r <= tcs[c].levels; ++r) {
        const int lev = tcs[c].levels - r;
        const int ex = tcs[c].res[r].pdx + lev, ey = tcs[c].res[r].pdy + lev;
        if (ex < 31) {
          const int64_t d = int64_t{siz.comps[c].dx} << ex;
          sx = sx ? std::min(sx, d) : d;
        }
        if (ey < 31) {
          const int64_t d = int64_t{siz.comps[c].dy} << ey;
          sy = sy ? std::min(sy, d) : d;
        }
      }
    return sx && sy;
  };
  for (const Poc& q : progs) {
    const int r0 = q.resno0, r1 = q.resno1, c0 = q.compno0, c1 = q.compno1;
    const int l1 = std::min(q.layno1, p.layers);
    if (c0 >= nc) continue;
    int64_t sx, sy;
    if (q.prog == 0 || q.prog == 1) {  // LRCP, RLCP
      const bool lrcp = q.prog == 0;
      const int outer0 = lrcp ? 0 : r0, outer1 = lrcp ? l1 : r1;
      const int inner0 = lrcp ? r0 : 0, inner1 = lrcp ? r1 : l1;
      for (int a = outer0; a < outer1; ++a)
        for (int b = inner0; b < inner1; ++b) {
          const int l = lrcp ? a : b, r = lrcp ? b : a;
          for (int c = c0; c < c1; ++c) {
            if (r > tcs[c].levels) continue;
            const Resolution& res = tcs[c].res[r];
            for (int64_t k = 0; k < res.pw * res.ph; ++k) take(l, r, c, k);
          }
        }
    } else if (q.prog == 2) {  // RPCL
      if (!steps(0, nc, sx, sy)) continue;
      for (int r = r0; r < r1; ++r)
        for (int64_t y = ty0; y < ty1; y += sy - (y % sy))
          for (int64_t x = tx0; x < tx1; x += sx - (x % sx))
            for (int c = c0; c < c1; ++c) emit(c, r, x, y, l1);
    } else if (q.prog == 3) {  // PCRL
      if (!steps(0, nc, sx, sy)) continue;
      for (int64_t y = ty0; y < ty1; y += sy - (y % sy))
        for (int64_t x = tx0; x < tx1; x += sx - (x % sx))
          for (int c = c0; c < c1; ++c)
            for (int r = r0; r < std::min(r1, tcs[c].levels + 1); ++r) emit(c, r, x, y, l1);
    } else if (q.prog == 4) {  // CPRL
      for (int c = c0; c < c1; ++c) {
        if (!steps(c, c + 1, sx, sy)) break;
        for (int64_t y = ty0; y < ty1; y += sy - (y % sy))
          for (int64_t x = tx0; x < tx1; x += sx - (x % sx))
            for (int r = r0; r < std::min(r1, tcs[c].levels + 1); ++r) emit(c, r, x, y, l1);
      }
    }
  }
  return out;
}

uint32_t numpasses(Bio& bio) {  // t2.c, opj_t2_getnumpasses
  if (!bio.bit()) return 1;
  if (!bio.bit()) return 2;
  uint32_t n = bio.read(2);
  if (n != 3) return 3 + n;
  n = bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + bio.read(7);
}

int floorlog2(uint32_t v) {
  int l = 0;
  while (v >>= 1) ++l;
  return l;
}

// t2.c's opj_t2_init_seg: segment `index` of a code-block of style `style`
void init_seg(Cblk& cb, int index, int style, bool first) {
  if (static_cast<int>(cb.segs.size()) <= index) cb.segs.resize(index + 1);
  Seg& seg = cb.segs[index];
  seg = Seg();
  if (style & TERMALL) seg.maxpasses = 1;
  else if (style & BYPASS)
    seg.maxpasses = first ? 10 : (cb.segs[index - 1].maxpasses == 1 || cb.segs[index - 1].maxpasses == 10) ? 2 : 1;
  else seg.maxpasses = 109;
}

// a packet's headers: from the tile's data, or from the stream of its PPM /
// PPT segments, read on from `pos`
struct HeaderStream {
  const uint8_t* data;
  size_t len, pos = 0;
};

// t2.c: one packet's header (from the tile's data at pos, or from `hs`) and
// body (from data[pos, end)); returns the new pos
size_t read_packet(const uint8_t* data, size_t pos, size_t end, const Params& p,
                   TileComp& tc, const Packet& pk, int style, HeaderStream* hs) {
  Resolution& res = tc.res[pk.res];
  if (p.sop && end - pos >= 6 && data[pos] == 0xFF && data[pos + 1] == 0x91) pos += 6;
  const uint8_t* hp = hs ? hs->data + hs->pos : data + pos;
  const size_t hlen = hs ? hs->len - hs->pos : end - pos;
  Bio bio(hp, hlen);
  const bool present = bio.bit();
  if (present) {
    for (Band& band : res.bands) {
      if (band.x0 == band.x1 || band.y0 == band.y1) continue;
      Precinct& pr = band.precs[pk.prec];
      for (int k = 0; k < pr.cw * pr.ch; ++k) {
        Cblk& cb = pr.cblks[k];
        bool inc = cb.numsegs ? bio.bit() : pr.incl.decode(bio, k, pk.layer + 1);
        if (!inc) {
          cb.newpasses = 0;
          continue;
        }
        if (!cb.numsegs) {
          int i = 0;
          while (!pr.imsb.decode(bio, k, i)) {
            if (++i > 74) fail("corrupt zero bit-plane tag tree");
          }
          cb.numbps = band.Mb + 1 - i;
          cb.lenbits = 3;
        }
        cb.newpasses = static_cast<int>(numpasses(bio));
        while (bio.bit()) ++cb.lenbits;
        int segno = 0;
        if (!cb.numsegs) {
          init_seg(cb, 0, style, true);
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) init_seg(cb, ++segno, style, false);
        }
        for (int n = cb.newpasses;;) {
          Seg& seg = cb.segs[segno];
          // t2.c: an HT block's first segment takes one pass (the cleanup),
          // any later one all that are left
          if (style & HT) seg.newpasses = segno == 0 ? 1 : n;
          else seg.newpasses = std::min(seg.maxpasses - seg.numpasses, n);
          const int bits = cb.lenbits + floorlog2(static_cast<uint32_t>(seg.newpasses));
          if (bits > 32) fail("corrupt code-block length");
          seg.newlen = bio.read(bits);
          n -= seg.newpasses;
          if (n <= 0) break;
          init_seg(cb, ++segno, style, false);
        }
      }
    }
  }
  bio.inalign();
  size_t hdr = bio.numbytes();
  if (p.eph && hlen - hdr >= 2 && hp[hdr] == 0xFF && hp[hdr + 1] == 0x92) hdr += 2;
  if (hs) hs->pos += hdr;
  else pos += hdr;
  if (!present) return pos;
  for (Band& band : res.bands) {
    if (band.x0 == band.x1 || band.y0 == band.y1) continue;
    Precinct& pr = band.precs[pk.prec];
    for (Cblk& cb : pr.cblks) {
      if (cb.newpasses == 0) continue;
      int segno = 0;
      if (!cb.numsegs) {
        cb.numsegs = 1;
      } else {
        segno = cb.numsegs - 1;
        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) cb.numsegs = ++segno + 1;
      }
      for (;;) {
        Seg& seg = cb.segs[segno];
        if (seg.newlen > end - pos) fail("packet data runs past its tile-part (codestream cut short)");
        cb.chunks.push_back({pos, seg.newlen});
        pos += seg.newlen;
        seg.len += seg.newlen;
        seg.numpasses += seg.newpasses;
        cb.newpasses -= seg.newpasses;
        if (cb.newpasses <= 0) break;
        cb.numsegs = ++segno + 1;
      }
    }
  }
  return pos;
}

// ---------------------------------------------------------------------------
// tier-1
// ---------------------------------------------------------------------------
const uint16_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
    0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
    0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
    0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t kNmps[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                           17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                           33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                           15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                           30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

enum : int { CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18 };

// per-sample state: the significance of the 8 neighbours, the sign of the
// 4 direct ones, and the sample's own significance / visit / refinement
enum : uint16_t {
  NB_N = 1, NB_S = 2, NB_W = 4, NB_E = 8, NB_NW = 16, NB_NE = 32, NB_SW = 64, NB_SE = 128,
  NEG_N = 256, NEG_S = 512, NEG_W = 1024, NEG_E = 2048,
  F_SIG = 4096, F_PI = 8192, F_MU = 16384,
};

struct Luts {
  uint8_t zc[4][256];
  uint8_t sc[256], spb[256];
  Luts() {
    for (int o = 0; o < 4; ++o)
      for (int f = 0; f < 256; ++f) {
        int h = !!(f & NB_W) + !!(f & NB_E), v = !!(f & NB_N) + !!(f & NB_S);
        const int d = !!(f & NB_NW) + !!(f & NB_NE) + !!(f & NB_SW) + !!(f & NB_SE);
        int n;
        if (o == 3) {
          const int hv = h + v;
          if (d == 0) n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
          else if (d == 1) n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
          else if (d == 2) n = hv == 0 ? 6 : 7;
          else n = 8;
        } else {
          if (o == 1) std::swap(h, v);  // HL: Table D.1's vertical-first column
          if (h == 0) n = v == 0 ? (d == 0 ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
          else if (h == 1) n = v == 0 ? (d == 0 ? 5 : 6) : 7;
          else n = 8;
        }
        zc[o][f] = static_cast<uint8_t>(n);
      }
    for (int i = 0; i < 256; ++i) {  // i: N S W E significance, then their signs
      auto contrib = [&](int sig, int neg) { return (i & sig) ? ((i & neg) ? -1 : 1) : 0; };
      int h = contrib(4, 64) + contrib(8, 128), v = contrib(1, 16) + contrib(2, 32);
      h = std::max(-1, std::min(1, h));
      v = std::max(-1, std::min(1, v));
      int ctx, x = 0;
      if (h == 0 && v == 0) ctx = 0;
      else if (h == 0) { ctx = 1; x = v < 0; }
      else if (h > 0) ctx = v > 0 ? 4 : v == 0 ? 3 : 2;
      else { ctx = v < 0 ? 4 : v == 0 ? 3 : 2; x = 1; }
      sc[i] = static_cast<uint8_t>(CTX_SC + ctx);
      spb[i] = static_cast<uint8_t>(x);
    }
  }
};
const Luts kLuts;

// ---------------------------------------------------------------------------
// HTJ2K code-blocks (ITU-T T.814): the three streams of ht_dec.c's cleanup
// pass and the two of its refinement passes, read as OpenJPEG reads them
// (its overlapping stores of a stuffed bit included, so damaged data
// decodes to OpenJPEG's values too)
// ---------------------------------------------------------------------------
inline uint32_t le32(const uint8_t* p) {
  return p[0] | uint32_t{p[1]} << 8 | uint32_t{p[2]} << 16 | uint32_t{p[3]} << 24;
}

// MEL: read forward from Lcup - Scup, a stuffed bit after each 0xFF, its
// last byte's low nibble set, then 0xFF; runs of events decoded ahead
struct HtMel {
  const uint8_t* data;
  uint64_t tmp = 0, runs = 0;
  int bits = 0, size = 0, k = 0, num_runs = 0;
  bool unstuff = false;
  // mel_init: the first 1-4 bytes up to the next 4-byte boundary of the
  // address (`addr` is its low bits), where it refuses a byte above 0x8F
  // after a 0xFF
  bool init(const uint8_t* buf, int lcup, int scup, uint32_t addr) {
    data = buf + lcup - scup;
    size = scup - 1;
    const int num = 4 - static_cast<int>(addr & 3);
    for (int i = 0; i < num; ++i) {
      if (unstuff && data[0] > 0x8F) return false;
      uint64_t d = size > 0 ? *data : 0xFF;
      if (size == 1) d |= 0xF;
      data += size-- > 0;
      const int d_bits = 8 - unstuff;
      tmp = (tmp << d_bits) | d;
      bits += d_bits;
      unstuff = (d & 0xFF) == 0xFF;
    }
    tmp <<= 64 - bits;
    return true;
  }
  void read() {
    if (bits > 32) return;
    uint32_t val = 0xFFFFFFFFu;
    if (size > 4) {
      val = le32(data);
      data += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      while (size > 1) {
        const uint32_t v = *data++, m = ~(0xFFu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
      const uint32_t v = *data++ | 0xFu, m = ~(0xFFu << i);
      val = (val & m) | (v << i);
      --size;
    }
    int nbits = 32 - unstuff;
    uint32_t t = val & 0xFF;
    bool us = (val & 0xFF) == 0xFF;
    nbits -= us;
    t <<= 8 - us;
    t |= (val >> 8) & 0xFF;
    us = ((val >> 8) & 0xFF) == 0xFF;
    nbits -= us;
    t <<= 8 - us;
    t |= (val >> 16) & 0xFF;
    us = ((val >> 16) & 0xFF) == 0xFF;
    nbits -= us;
    t <<= 8 - us;
    t |= (val >> 24) & 0xFF;
    unstuff = ((val >> 24) & 0xFF) == 0xFF;
    tmp |= uint64_t{t} << (64 - nbits - bits);
    bits += nbits;
  }
  void decode() {
    if (bits < 6) read();
    while (bits >= 6 && num_runs < 8) {
      int eval = HT_MEL_EXP[k], run;
      if (tmp & (uint64_t{1} << 63)) {  // a 1: 2^eval events 0
        run = ((1 << eval) - 1) << 1;
        k = std::min(k + 1, 12);
        tmp <<= 1;
        bits -= 1;
      } else {  // a 0 and eval bits: that many events 0, then a 1
        run = (static_cast<int>(tmp >> (63 - eval)) & ((1 << eval) - 1)) * 2 + 1;
        k = std::max(k - 1, 0);
        tmp <<= eval + 1;
        bits -= eval + 1;
      }
      eval = num_runs * 7;
      runs &= ~(uint64_t{0x3F} << eval);
      runs |= uint64_t(run) << eval;
      ++num_runs;
    }
  }
  int get_run() {
    if (num_runs == 0) decode();
    const int t = static_cast<int>(runs & 0x7F);
    runs >>= 7;
    --num_runs;
    return t;
  }
};

// VLC (read backward from Lcup - 2, its first half byte the upper nibble
// there) and MagRef (backward from the end of the refinement segment): a
// byte after one above 0x8F loses its top bit where its low 7 are all 1
struct HtRev {
  const uint8_t* data;
  uint64_t tmp = 0;
  uint32_t bits = 0;
  int size = 0;
  bool unstuff = false;
  void read() {
    if (bits > 32) return;
    uint32_t val = 0;
    if (size > 3) {
      val = le32(data - 3);
      data -= 4;
      size -= 4;
    } else if (size > 0) {
      int i = 24;
      while (size > 0) {
        const uint32_t v = *data--;
        val |= v << i;
        --size;
        i -= 8;
      }
    }
    uint32_t t = val >> 24;
    uint32_t nb = 8u - ((unstuff && (((val >> 24) & 0x7F) == 0x7F)) ? 1u : 0u);
    bool us = (val >> 24) > 0x8F;
    t |= ((val >> 16) & 0xFF) << nb;
    nb += 8u - ((us && (((val >> 16) & 0x7F) == 0x7F)) ? 1u : 0u);
    us = ((val >> 16) & 0xFF) > 0x8F;
    t |= ((val >> 8) & 0xFF) << nb;
    nb += 8u - ((us && (((val >> 8) & 0x7F) == 0x7F)) ? 1u : 0u);
    us = ((val >> 8) & 0xFF) > 0x8F;
    t |= (val & 0xFF) << nb;
    nb += 8u - ((us && ((val & 0x7F) == 0x7F)) ? 1u : 0u);
    us = (val & 0xFF) > 0x8F;
    tmp |= uint64_t{t} << bits;
    bits += nb;
    unstuff = us;
  }
  // ht_dec.c's inits read single bytes up to a 4-byte boundary of the
  // address, then words: the same bits, so words here
  void init_vlc(const uint8_t* buf, int lcup, int scup) {
    data = buf + lcup - 2;
    size = scup - 2;
    const uint32_t d = *data--;
    tmp = d >> 4;
    bits = 4 - ((tmp & 7) == 7);
    unstuff = (d | 0xF) > 0x8F;
    read();
  }
  void init_mrp(const uint8_t* buf, int lcup, int len2) {
    data = buf + lcup + len2 - 1;
    size = len2;
    unstuff = true;
    read();
  }
  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return static_cast<uint32_t>(tmp);
  }
  uint32_t advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
    return static_cast<uint32_t>(tmp);
  }
};

// MagSgn (forward from the block's start, 0xFF past its end) and SigProp
// (forward from the refinement segment's start, 0 past it): a stuffed bit
// after each 0xFF
struct HtFwd {
  const uint8_t* data;
  uint64_t tmp = 0;
  uint32_t bits = 0, X = 0;
  int size = 0;
  bool unstuff = false;
  void read() {
    uint32_t val;
    if (size > 3) {
      val = le32(data);
      data += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      val = X ? 0xFFFFFFFFu : 0;
      while (size > 0) {
        const uint32_t v = *data++, m = ~(0xFFu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
    } else {
      val = X ? 0xFFFFFFFFu : 0;
    }
    uint32_t nb = 8u - (unstuff ? 1u : 0u);
    uint32_t t = val & 0xFF;
    bool us = (val & 0xFF) == 0xFF;
    t |= ((val >> 8) & 0xFF) << nb;
    nb += 8u - (us ? 1u : 0u);
    us = ((val >> 8) & 0xFF) == 0xFF;
    t |= ((val >> 16) & 0xFF) << nb;
    nb += 8u - (us ? 1u : 0u);
    us = ((val >> 16) & 0xFF) == 0xFF;
    t |= ((val >> 24) & 0xFF) << nb;
    nb += 8u - (us ? 1u : 0u);
    unstuff = ((val >> 24) & 0xFF) == 0xFF;
    tmp |= uint64_t{t} << bits;
    bits += nb;
  }
  void init(const uint8_t* p, int n, uint32_t x) {  // frwd_init, in words too
    data = p;
    size = n;
    X = x;
    read();
  }
  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return static_cast<uint32_t>(tmp);
  }
  void advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
  }
};

// ht_dec.c refuses every HT code-block of a component with an ROI shift
void t1_refuse_ht_roi(int roishift) {
  if (roishift != 0) fail("ROI (RGN) shift over HTJ2K code-blocks (OpenJPEG does not decode it either)");
}

// decode_init_uvlc / decode_noninit_uvlc's prefix table: index the next 3
// VLC bits; prefix length (bits 0-1), suffix length (2-4), u_pfx (5-7)
const uint8_t kUvlcDec[8] = {
    3 | (5 << 2) | (5 << 5), 1 | (0 << 2) | (1 << 5), 2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5),
    3 | (1 << 2) | (3 << 5), 1 | (0 << 2) | (1 << 5), 2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5)};

// u of the two quads of a pair (kappa 1 added) from the VLC bits `vlc`:
// `mode` holds their u_off (bit 0 the first quad's), 4 for both with a
// MEL event 1 in the first quad row; returns the bits used. The first
// row's mode 3 reads the second quad's u as one bit where the first
// quad's prefix is 3 bits long (T.814's u_q rule for the initial row).
uint32_t decode_uvlc(uint32_t vlc, uint32_t mode, uint32_t* u, bool initial) {
  uint32_t consumed = 0;
  auto suffix = [&](uint32_t d) {
    const uint32_t len = (d >> 2) & 7;
    consumed += len;
    const uint32_t v = (d >> 5) + (vlc & ((1u << len) - 1));
    vlc >>= len;
    return v;
  };
  auto prefix = [&]() {
    const uint32_t d = kUvlcDec[vlc & 7];
    vlc >>= d & 3;
    consumed += d & 3;
    return d;
  };
  if (mode == 0) {
    u[0] = u[1] = 1;
  } else if (mode <= 2) {
    const uint32_t d = suffix(prefix());
    u[0] = mode == 1 ? d + 1 : 1;
    u[1] = mode == 1 ? 1 : d + 1;
  } else if (mode == 3 && initial && (kUvlcDec[vlc & 7] & 3) > 2) {
    const uint32_t d1 = prefix();
    u[1] = (vlc & 1) + 2;
    ++consumed;
    vlc >>= 1;
    u[0] = suffix(d1) + 1;
  } else if (mode == 3 || mode == 4) {
    const uint32_t d1 = prefix(), d2 = prefix();
    const uint32_t add = mode == 4 ? 3 : 1;
    u[0] = suffix(d1) + add;
    u[1] = suffix(d2) + add;
  }
  return consumed;
}

struct T1 {
  std::vector<uint16_t> flags;
  std::vector<int32_t> data;
  std::vector<uint8_t> buf;
  // MQ decoder (mqc.c); c, ct and bp also hold the raw decoder's state
  const uint8_t* bp = nullptr;
  uint32_t c = 0, a = 0;
  int ct = 0;
  uint8_t st[19], mps[19];
  bool vsc = false;  // VSC: a stripe's first row leaves the row above as it is

  void bytein() {
    if (*bp == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += uint32_t{*bp} << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += uint32_t{*bp} << 8;
      ct = 8;
    }
  }
  void reset_states() {
    std::memset(st, 0, sizeof st);
    std::memset(mps, 0, sizeof mps);
    st[CTX_UNI] = 46;
    st[CTX_AGG] = 3;
    st[0] = 4;
  }
  void init_mq(const uint8_t* p) {  // opj_mqc_init_dec
    bp = p;
    c = uint32_t{*bp} << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void init_raw(const uint8_t* p) {  // opj_mqc_raw_init_dec
    bp = p;
    c = 0;
    ct = 0;
  }
  inline int raw() {  // opj_mqc_raw_decode: a bit, 0 stuffed after each 0xFF
    if (ct == 0) {
      if (c == 0xFF) {
        if (*bp > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
  inline int decode(int cx) {
    const int s = st[cx];
    const uint32_t q = kQe[s];
    int d;
    a -= q;
    if ((c >> 16) < q) {
      if (a < q) {
        d = mps[cx];
        st[cx] = kNmps[s];
      } else {
        d = 1 - mps[cx];
        if (kSwitch[s]) mps[cx] ^= 1;
        st[cx] = kNlps[s];
      }
      a = q;
    } else {
      c -= q << 16;
      if (a & 0x8000) return mps[cx];
      if (a < q) {
        d = 1 - mps[cx];
        if (kSwitch[s]) mps[cx] ^= 1;
        st[cx] = kNlps[s];
      } else {
        d = mps[cx];
        st[cx] = kNmps[s];
      }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (!(a & 0x8000));
    return d;
  }

  int w = 0, h = 0, stride = 0;

  // sample i turns significant; `north`: its row above learns of it (t1.c's
  // opj_t1_update_flags, which VSC skips for a stripe's first row)
  inline void make_significant(size_t i, int neg, bool north) {
    uint16_t* f = flags.data();
    const size_t s = static_cast<size_t>(stride);
    f[i] |= F_SIG;
    if (north) {
      f[i - s] |= neg ? (NB_S | NEG_S) : NB_S;
      f[i - s - 1] |= NB_SE;
      f[i - s + 1] |= NB_SW;
    }
    f[i + s] |= neg ? (NB_N | NEG_N) : NB_N;
    f[i - 1] |= neg ? (NB_E | NEG_E) : NB_E;
    f[i + 1] |= neg ? (NB_W | NEG_W) : NB_W;
    f[i + s - 1] |= NB_NE;
    f[i + s + 1] |= NB_NW;
  }
  inline void decode_sign(size_t i, int32_t oneplushalf, bool north) {
    const uint16_t f = flags[i];
    const int idx = (f & 0xF) | ((f >> 4) & 0xF0);
    const int neg = decode(kLuts.sc[idx]) ^ kLuts.spb[idx];
    data[i] = neg ? -oneplushalf : oneplushalf;
    make_significant(i, neg, north);
  }

  // significance propagation, MQ-coded or (BYPASS) raw
  template <bool RAW>
  void sigpass(int bp1, int orient) {
    const int32_t one = int32_t{1} << bp1, oneplushalf = one | (one >> 1);
    const uint8_t* zc = kLuts.zc[orient];
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
          const size_t i = static_cast<size_t>(y + 1) * stride + x + 1;
          const uint16_t f = flags[i];
          if ((f & F_SIG) || !(f & 0xFF)) continue;
          const bool north = !vsc || y != y0;
          if (RAW) {
            if (raw()) {
              const int neg = raw();
              data[i] = neg ? -oneplushalf : oneplushalf;
              make_significant(i, neg, north);
            }
          } else if (decode(zc[f & 0xFF])) {
            decode_sign(i, oneplushalf, north);
          }
          flags[i] |= F_PI;
        }
  }
  // magnitude refinement, MQ-coded or (BYPASS) raw
  template <bool RAW>
  void refpass(int bp1) {
    const int32_t half = (int32_t{1} << bp1) >> 1;
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
          const size_t i = static_cast<size_t>(y + 1) * stride + x + 1;
          const uint16_t f = flags[i];
          if ((f & (F_SIG | F_PI)) != F_SIG) continue;
          int v;
          if (RAW) {
            v = raw();
          } else {
            const int ctx = (f & F_MU) ? CTX_MAG + 2 : (f & 0xFF) ? CTX_MAG + 1 : CTX_MAG;
            v = decode(ctx);
          }
          data[i] += (v ^ (data[i] < 0)) ? half : -half;
          flags[i] |= F_MU;
        }
  }
  // cleanup, then SEGSYM's four symbols in the uniform context (read, not
  // checked: t1.c's check of them is commented out)
  void clnpass(int bp1, int orient, bool segsym) {
    const int32_t one = int32_t{1} << bp1, oneplushalf = one | (one >> 1);
    const uint8_t* zc = kLuts.zc[orient];
    const size_t s = static_cast<size_t>(stride);
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int y = y0;
        const int y1 = std::min(y0 + 4, h);
        size_t i = static_cast<size_t>(y0 + 1) * s + x + 1;
        if (y0 + 4 <= h) {
          const uint16_t m = F_SIG | F_PI | 0xFF;
          if (!((flags[i] | flags[i + s] | flags[i + 2 * s] | flags[i + 3 * s]) & m)) {
            if (!decode(CTX_AGG)) continue;
            int r = decode(CTX_UNI) << 1;
            r |= decode(CTX_UNI);
            y = y0 + r;
            i += r * s;
            decode_sign(i, oneplushalf, !vsc || r != 0);
            ++y;
            i += s;
          }
        }
        for (; y < y1; ++y, i += s) {
          const uint16_t f = flags[i];
          if (!(f & (F_SIG | F_PI))) {
            if (decode(zc[f & 0xFF])) decode_sign(i, oneplushalf, !vsc || y != y0);
          }
          flags[i] &= static_cast<uint16_t>(~F_PI);
        }
      }
    if (segsym)
      for (int k = 0; k < 4; ++k) decode(CTX_UNI);
  }

  // the code-block's samples (t1.c's 2x scale) into data[(y+1)*stride+x+1]:
  // opj_t1_decode_cblk, its codeword segments each on a decoder of its own
  // (raw for BYPASS's significance and refinement passes from the fifth
  // bit-plane down, counted without the ROI shift), the contexts reset after
  // each MQ pass under RESET; then opj_t1_clbl_decode_processor's ROI
  // scaling (a magnitude at or above 1 << roishift shifted down by it)
  void decode_cblk(const uint8_t* src, const Cblk& cb, int orient, int style, int roishift) {
    w = static_cast<int>(cb.x1 - cb.x0);
    h = static_cast<int>(cb.y1 - cb.y0);
    stride = w + 2;
    const size_t n = static_cast<size_t>(stride) * (h + 2);
    flags.assign(n, 0);
    data.assign(n, 0);
    const int32_t bpno = static_cast<int32_t>(static_cast<uint32_t>(roishift) + static_cast<uint32_t>(cb.numbps));
    if (bpno >= 31) fail("a code-block of more than 30 bit-planes (its ROI shift included)");
    if (cb.chunks.empty()) return;
    size_t len = 0;
    for (const auto& ch : cb.chunks) len += ch.second;
    buf.resize(len + 2);
    size_t off = 0;
    for (const auto& ch : cb.chunks) {
      std::memcpy(buf.data() + off, src + ch.first, ch.second);
      off += ch.second;
    }
    vsc = style & VSC;
    reset_states();
    int bp1 = bpno, type = 2;
    off = 0;
    for (int sg = 0; sg < cb.numsegs; ++sg) {
      const Seg& seg = cb.segs[sg];
      const bool raw = (style & BYPASS) && type < 2 && bp1 <= cb.numbps - 4;
      // mqc.c's artificial 0xFF 0xFF marker past the segment's data
      uint8_t* past = buf.data() + off + seg.len;
      const uint8_t keep0 = past[0], keep1 = past[1];
      past[0] = past[1] = 0xFF;
      if (raw) init_raw(buf.data() + off);
      else init_mq(buf.data() + off);
      for (int pass = 0; pass < seg.numpasses && bp1 >= 1; ++pass) {
        if (type == 0) raw ? sigpass<true>(bp1, orient) : sigpass<false>(bp1, orient);
        else if (type == 1) raw ? refpass<true>(bp1) : refpass<false>(bp1);
        else clnpass(bp1, orient, style & SEGSYM);
        if ((style & RESET) && !raw) reset_states();
        if (++type == 3) {
          type = 0;
          --bp1;
        }
      }
      past[0] = keep0;
      past[1] = keep1;
      off += seg.len;
    }
    if (roishift > 0) {
      for (int y = 0; y < h; ++y) {
        int32_t* row = data.data() + static_cast<size_t>(y + 1) * stride + 1;
        for (int x = 0; x < w; ++x) {
          if (roishift >= 31) {
            row[x] = 0;
            continue;
          }
          const int32_t v = row[x], mag = v < 0 ? -v : v;
          if (mag >= (int32_t{1} << roishift)) row[x] = v < 0 ? -(mag >> roishift) : mag >> roishift;
        }
      }
    }
  }
  // an HT code-block (ht_dec.c's opj_t1_ht_decode_cblk) into data[(y+1)*
  // stride+x+1], on t1.c's 2x scale: the cleanup pass, then where the block
  // has them the SigProp and MagRef passes of the next bit-plane. The
  // checks and warnings are OpenJPEG's: a warning decodes on with fewer
  // passes.
  std::vector<uint32_t> hdat, sig1, sig2, mbr1, mbr2;
  std::vector<uint8_t> line_state;
  void decode_ht(const uint8_t* src, const Cblk& cb, int Mb, int style, int roishift) {
    t1_refuse_ht_roi(roishift);
    w = static_cast<int>(cb.x1 - cb.x0);
    h = static_cast<int>(cb.y1 - cb.y0);
    stride = w + 2;
    data.assign(static_cast<size_t>(stride) * (h + 2), 0);
    if (cb.chunks.empty()) return;
    const uint32_t mb = static_cast<uint32_t>(Mb);
    const uint32_t numbps = static_cast<uint32_t>(cb.numbps);
    const uint32_t zero_bplanes = (mb + 1) - numbps;
    size_t cblk_len = 0;
    for (const auto& ch : cb.chunks) cblk_len += ch.second;
    buf.resize(cblk_len + 2);
    size_t off = 0;
    for (const auto& ch : cb.chunks) {
      std::memcpy(buf.data() + off, src + ch.first, ch.second);
      off += ch.second;
    }
    // the low bits of the address OpenJPEG reads the block from, which its
    // MEL reader's checks hang on: one chunk where it lies in the tile's
    // data (malloc'd, 16-byte aligned), several joined in a buffer of their
    // own (aligned too)
    const uint32_t addr = cb.chunks.size() == 1 ? static_cast<uint32_t>(cb.chunks[0].first & 3) : 0;
    const uint8_t* coded = buf.data();
    uint32_t num_passes = cb.numsegs > 0 ? cb.segs[0].numpasses : 0;
    num_passes += cb.numsegs > 1 ? cb.segs[1].numpasses : 0;
    const uint32_t lengths1 = num_passes > 0 ? cb.segs[0].len : 0;
    const uint32_t lengths2 = num_passes > 1 ? cb.segs[1].len : 0;
    // a 2nd (and 3rd) pass of no bytes: OpenJPEG warns and decodes the
    // cleanup pass alone
    if (num_passes > 1 && lengths2 == 0) num_passes = 1;
    if (num_passes > 3)
      fail("HTJ2K code-block of more than 3 coding passes (" + std::to_string(num_passes) +
           "; OpenJPEG does not decode it either)");
    if (mb > 30) fail("HTJ2K code-block of more than 30 bit-planes (" + std::to_string(mb) + ")");
    if (zero_bplanes > mb)
      fail("malformed HTJ2K code-block: " + std::to_string(zero_bplanes) + " zero bit-planes in " +
           std::to_string(mb) + " bit-planes");
    if (zero_bplanes == mb && num_passes > 1) num_passes = 1;  // OpenJPEG warns once
    const uint32_t p = numbps, zero_bplanes_p1 = zero_bplanes + 1;
    if (lengths1 < 2 || lengths1 > cblk_len || size_t{lengths1} + lengths2 > cblk_len)
      fail("malformed HTJ2K code-block: invalid code-block length values");
    const int lcup = static_cast<int>(lengths1);
    const int scup = (static_cast<int>(coded[lcup - 1]) << 4) + (coded[lcup - 2] & 0xF);
    if (scup < 2 || scup > lcup || scup > 4079)
      fail("malformed HTJ2K code-block: Scup outside 2 <= Scup <= min(Lcup, 4079)");
    HtMel mel;
    if (!mel.init(coded, lcup, scup, addr + static_cast<uint32_t>(lcup - scup)))
      fail("malformed HTJ2K code-block: incorrect MEL segment sequence");
    HtRev vlc, magref;
    vlc.init_vlc(coded, lcup, scup);
    HtFwd magsgn, sigprop;
    magsgn.init(coded, lcup - scup, 0xFF);
    if (num_passes > 1) sigprop.init(coded + lengths1, static_cast<int>(lengths2), 0);
    if (num_passes > 2) magref.init_mrp(coded, lcup, static_cast<int>(lengths2));

    const int width = w, height = h;
    // a word of sigma / mbr: 4 rows x 8 columns, a column's rows in a
    // nibble; one word past the last group is read and written
    const size_t words = static_cast<size_t>((width + 7) / 8) + 2;
    hdat.assign(static_cast<size_t>(width) * height, 0);
    sig1.assign(words, 0);
    sig2.assign(words, 0);
    mbr1.assign(words, 0);
    mbr2.assign(words, 0);
    line_state.assign(static_cast<size_t>(width) + 8, 0);
    uint32_t* const dec = hdat.data();
    uint32_t* const sigma1 = sig1.data();
    uint32_t* const sigma2 = sig2.data();
    uint32_t* const mbrs1 = mbr1.data();
    uint32_t* const mbrs2 = mbr2.data();
    const bool stripe_causal = style & VSC;

    // one significant sample n (0-3) of quad info qi: its MagSgn bits and
    // value; returns v_n for the exponent (E = its bit length)
    auto sample = [&](uint32_t qi, uint32_t uq, int n, uint32_t* dst) {
      const uint32_t ms_val = magsgn.fetch();
      const uint32_t m_n = uq - ((qi >> (12 + n)) & 1);
      magsgn.advance(m_n);
      const uint32_t val = ms_val << 31;
      uint32_t v_n = ms_val & ((1u << m_n) - 1);
      v_n |= ((qi >> (8 + n)) & 1) << m_n;
      v_n |= 1;
      *dst = val | ((v_n + 2) << (p - 1));
      return v_n;
    };
    auto bitlen = [](uint32_t v) { return static_cast<uint32_t>(32 - __builtin_clz(v)); };
    // the four samples of a quad at sp (columns sp, sp + 1; rows 0, 1),
    // lsp its line-state byte: the significant ones decoded, the others
    // inside the block zeroed
    auto quad = [&](uint32_t qi, uint32_t uq, uint32_t locs, int q, uint32_t*& sp, uint8_t*& lsp) {
      const int b = 4 * q;
      if (qi & 0x10) sample(qi, uq, 0, sp);
      else if (locs & (1u << b)) sp[0] = 0;
      if (qi & 0x20) {
        const uint32_t t = lsp[0] & 0x7F, e = bitlen(sample(qi, uq, 1, sp + width));
        lsp[0] = static_cast<uint8_t>(0x80 | (t > e ? t : e));
      } else if (locs & (2u << b)) {
        sp[width] = 0;
      }
      ++lsp;
      ++sp;
      if (qi & 0x40) sample(qi, uq, 2, sp);
      else if (locs & (4u << b)) sp[0] = 0;
      lsp[0] = 0;
      if (qi & 0x80) lsp[0] = static_cast<uint8_t>(0x80 | bitlen(sample(qi, uq, 3, sp + width)));
      else if (locs & (8u << b)) sp[width] = 0;
      ++sp;
    };
    auto mel_event = [&](int& run) {  // one MEL event: true for a 1
      run -= 2;
      const bool one = run == -1;
      if (run < 0) run = mel.get_run();
      return one;
    };

    // the first quad row
    uint8_t* lsp = line_state.data();
    lsp[0] = 0;
    int run = mel.get_run();
    uint32_t qinf[2] = {0, 0}, c_q = 0;
    uint32_t* sp = dec;
    uint32_t* sip = sigma1;
    uint32_t sip_shift = 0;
    for (int x = 0; x < width; x += 4) {
      uint32_t U_q[2];
      uint32_t vlc_val = vlc.fetch();
      qinf[0] = HT_VLC_TBL0[(c_q << 7) | (vlc_val & 0x7F)];
      if (c_q == 0 && !mel_event(run)) qinf[0] = 0;
      c_q = ((qinf[0] & 0x10) >> 4) | ((qinf[0] & 0xE0) >> 5);
      vlc_val = vlc.advance(qinf[0] & 0x7);
      *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2)) << sip_shift;
      qinf[1] = 0;
      if (x + 2 < width) {
        qinf[1] = HT_VLC_TBL0[(c_q << 7) | (vlc_val & 0x7F)];
        if (c_q == 0 && !mel_event(run)) qinf[1] = 0;
        c_q = ((qinf[1] & 0x10) >> 4) | ((qinf[1] & 0xE0) >> 5);
        vlc_val = vlc.advance(qinf[1] & 0x7);
      }
      *sip |= (((qinf[1] & 0x30) | ((qinf[1] & 0xC0) << 2))) << (4 + sip_shift);
      sip += x & 0x7 ? 1 : 0;
      sip_shift ^= 0x10;
      uint32_t uvlc_mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
      if (uvlc_mode == 3 && mel_event(run)) ++uvlc_mode;
      const uint32_t consumed = decode_uvlc(vlc_val, uvlc_mode, U_q, true);
      if (U_q[0] > zero_bplanes_p1 || U_q[1] > zero_bplanes_p1)
        fail("malformed HTJ2K code-block: U_q is larger than zero bit-planes + 1");
      vlc.advance(consumed);
      uint32_t locs = 0xFF;
      if (x + 4 > width) locs >>= (x + 4 - width) << 1;
      locs = height > 1 ? locs : (locs & 0x55);
      if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs)
        fail("malformed HTJ2K code-block: VLC code produces significant samples outside the code-block area");
      quad(qinf[0], U_q[0], locs, 0, sp, lsp);
      quad(qinf[1], U_q[1], locs, 1, sp, lsp);
    }

    // the next quad rows, and the refinement passes stripe by stripe
    // (MagRef as a stripe completes, SigProp one stripe later)
    auto stripe_mbr = [&](uint32_t* sig, uint32_t* mbr) {  // within the stripe
      uint32_t prev = 0;
      for (int i = 0; i < width; i += 8, ++mbr, ++sig) {
        mbr[0] = sig[0] | prev >> 28 | sig[0] << 4 | sig[0] >> 4 | sig[1] << 28;
        prev = sig[0];
        const uint32_t t = mbr[0];
        uint32_t z = t;
        z |= (t & 0x77777777u) << 1;
        z |= (t & 0xEEEEEEEEu) >> 1;
        mbr[0] = z & ~sig[0];
      }
    };
    auto magref_stripe = [&](uint32_t* cur_sig, uint32_t* dpp) {
      const uint32_t half = 1u << (p - 2);
      for (int i = 0; i < width; i += 8) {
        uint32_t cwd = magref.fetch();
        const uint32_t sig = *cur_sig++;
        uint32_t col_mask = 0xFu;
        uint32_t* dp = dpp + i;
        if (sig) {
          for (int j = 0; j < 8; ++j, ++dp, col_mask <<= 4) {
            if (!(sig & col_mask)) continue;
            uint32_t sample_mask = 0x11111111u & col_mask;
            for (int r = 0; r < 4; ++r, sample_mask += sample_mask) {
              if (sig & sample_mask) {
                const uint32_t sym = cwd & 1;
                dp[r * width] ^= (1 - sym) << (p - 1);
                dp[r * width] |= half;
                cwd >>= 1;
              }
            }
          }
        }
        magref.advance(static_cast<uint32_t>(__builtin_popcount(sig)));
      }
    };
    // membership from the next stripe's significance (none under VSC)
    auto add_next = [&](uint32_t* cur_sig, uint32_t* cur_mbr, uint32_t* nxt_sig) {
      uint32_t prev = 0;
      for (int i = 0; i < width; i += 8, ++cur_mbr, ++cur_sig, ++nxt_sig) {
        uint32_t t = nxt_sig[0];
        t |= prev >> 28;
        t |= nxt_sig[0] << 4;
        t |= nxt_sig[0] >> 4;
        t |= nxt_sig[1] << 28;
        prev = nxt_sig[0];
        if (!stripe_causal) cur_mbr[0] |= (t & 0x11111111u) << 3;
        cur_mbr[0] &= ~cur_sig[0];
      }
    };
    // SigProp over the stripe at row y0 (`pattern` its rows inside the
    // block), its new significance carried into the next stripe's mbr
    auto sigprop_stripe = [&](int y0, uint32_t* cur_sig, uint32_t* cur_mbr, uint32_t* nxt_sig,
                              uint32_t* nxt_mbr, uint32_t pattern) {
      const uint32_t val = 3u << (p - 2);
      for (int i = 0; i < width; i += 8, ++cur_sig, ++cur_mbr, ++nxt_sig, ++nxt_mbr) {
        uint32_t mbr = *cur_mbr & pattern;
        uint32_t new_sig = 0;
        if (mbr) {
          for (int n = 0; n < 8; n += 4) {
            uint32_t cwd = sigprop.fetch();
            uint32_t cnt = 0;
            uint32_t* dp = dec + static_cast<size_t>(y0) * width + i + n;
            uint32_t col_mask = 0xFu << (4 * n);
            const uint32_t inv_sig = ~cur_sig[0] & pattern;
            const int end = n + 4 + i < width ? n + 4 : width - i;
            static const uint32_t kSpread[4] = {0x32u, 0x74u, 0xE8u, 0xC0u};
            for (int j = n; j < end; ++j, ++dp, col_mask <<= 4) {
              if ((col_mask & mbr) == 0) continue;
              uint32_t sample_mask = 0x11111111u & col_mask;
              for (int r = 0; r < 4; ++r, sample_mask += sample_mask) {
                if (mbr & sample_mask) {
                  if (cwd & 1) {
                    new_sig |= sample_mask;
                    mbr |= (kSpread[r] << (j * 4)) & inv_sig;
                  }
                  cwd >>= 1;
                  ++cnt;
                }
              }
            }
            if (new_sig & (0xFFFFu << (4 * n))) {
              dp = dec + static_cast<size_t>(y0) * width + i + n;
              col_mask = 0xFu << (4 * n);
              for (int j = n; j < end; ++j, ++dp, col_mask <<= 4) {
                if ((col_mask & new_sig) == 0) continue;
                uint32_t sample_mask = 0x11111111u & col_mask;
                for (int r = 0; r < 4; ++r, sample_mask += sample_mask) {
                  if (new_sig & sample_mask) {
                    dp[r * width] |= ((cwd & 1) << 31) | val;
                    cwd >>= 1;
                    ++cnt;
                  }
                }
              }
            }
            sigprop.advance(cnt);
            if (n == 4) {
              uint32_t t = new_sig >> 28;
              t |= ((t & 0xE) >> 1) | ((t & 7) << 1);
              cur_mbr[1] |= t & ~cur_sig[1];
            }
          }
        }
        new_sig |= cur_sig[0];
        const uint32_t ux = (new_sig & 0x88888888u) >> 3;
        const uint32_t tx = ux | (ux << 4) | (ux >> 4);
        if (i > 0) nxt_mbr[-1] |= (ux << 28) & ~nxt_sig[-1];
        nxt_mbr[0] |= tx & ~nxt_sig[0];
        nxt_mbr[1] |= (ux >> 28) & ~nxt_sig[1];
      }
    };

    for (int y = 2; y < height;) {
      sip_shift ^= 0x2;
      sip_shift &= 0xFFFFFFEFu;
      sip = y & 0x4 ? sigma2 : sigma1;
      lsp = line_state.data();
      uint8_t ls0 = lsp[0];
      lsp[0] = 0;
      sp = dec + static_cast<size_t>(y) * width;
      c_q = 0;
      for (int x = 0; x < width; x += 4) {
        uint32_t U_q[2];
        c_q |= ls0 >> 7;
        c_q |= (lsp[1] >> 5) & 0x4;
        uint32_t vlc_val = vlc.fetch();
        qinf[0] = HT_VLC_TBL1[(c_q << 7) | (vlc_val & 0x7F)];
        if (c_q == 0 && !mel_event(run)) qinf[0] = 0;
        c_q = ((qinf[0] & 0x40) >> 5) | ((qinf[0] & 0x80) >> 6);
        vlc_val = vlc.advance(qinf[0] & 0x7);
        *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2)) << sip_shift;
        qinf[1] = 0;
        if (x + 2 < width) {
          c_q |= lsp[1] >> 7;
          c_q |= (lsp[2] >> 5) & 0x4;
          qinf[1] = HT_VLC_TBL1[(c_q << 7) | (vlc_val & 0x7F)];
          if (c_q == 0 && !mel_event(run)) qinf[1] = 0;
          c_q = ((qinf[1] & 0x40) >> 5) | ((qinf[1] & 0x80) >> 6);
          vlc_val = vlc.advance(qinf[1] & 0x7);
        }
        *sip |= (((qinf[1] & 0x30) | ((qinf[1] & 0xC0) << 2))) << (4 + sip_shift);
        sip += x & 0x7 ? 1 : 0;
        sip_shift ^= 0x10;
        const uint32_t uvlc_mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
        vlc.advance(decode_uvlc(vlc_val, uvlc_mode, U_q, false));
        // kappa: E^max of the quads above where the quad has more than one
        // significant sample (T.814 eqs. 5, 6)
        if ((qinf[0] & 0xF0) & ((qinf[0] & 0xF0) - 1)) {
          const uint32_t E = std::max<uint32_t>(ls0 & 0x7Fu, lsp[1] & 0x7Fu);
          U_q[0] += E > 2 ? E - 2 : 0;
        }
        if ((qinf[1] & 0xF0) & ((qinf[1] & 0xF0) - 1)) {
          const uint32_t E = std::max<uint32_t>(lsp[1] & 0x7Fu, lsp[2] & 0x7Fu);
          U_q[1] += E > 2 ? E - 2 : 0;
        }
        if (U_q[0] > zero_bplanes_p1 || U_q[1] > zero_bplanes_p1)
          fail("malformed HTJ2K code-block: U_q is larger than bit-planes + 1");
        ls0 = lsp[2];
        lsp[1] = lsp[2] = 0;
        uint32_t locs = 0xFF;
        if (x + 4 > width) locs >>= (x + 4 - width) << 1;
        locs = y + 2 <= height ? locs : (locs & 0x55);
        if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs)
          fail("malformed HTJ2K code-block: VLC code produces significant samples outside the code-block area");
        quad(qinf[0], U_q[0], locs, 0, sp, lsp);
        quad(qinf[1], U_q[1], locs, 1, sp, lsp);
      }
      y += 2;
      if (num_passes > 1 && (y & 3) == 0) {
        if (num_passes > 2)
          magref_stripe(y & 0x4 ? sigma1 : sigma2, dec + static_cast<size_t>(y - 4) * width);
        if (y >= 4) stripe_mbr(y & 0x4 ? sigma1 : sigma2, y & 0x4 ? mbrs1 : mbrs2);
        if (y >= 8) {
          uint32_t* cur_sig = y & 0x4 ? sigma2 : sigma1;
          uint32_t* cur_mbr = y & 0x4 ? mbrs2 : mbrs1;
          uint32_t* nxt_sig = y & 0x4 ? sigma1 : sigma2;
          uint32_t* nxt_mbr = y & 0x4 ? mbrs1 : mbrs2;
          add_next(cur_sig, cur_mbr, nxt_sig);
          sigprop_stripe(y - 8, cur_sig, cur_mbr, nxt_sig, nxt_mbr, 0xFFFFFFFFu);
          std::memset(cur_sig, 0, ((((static_cast<uint32_t>(width) + 7u) >> 3) + 1u) << 2));
        }
      }
    }

    // the stripes the loop left: MagRef and mbr of a last stripe of 1 or 2
    // rows, then SigProp of the last one or two stripes
    if (num_passes > 1) {
      if (num_passes > 2 && ((height & 3) == 1 || (height & 3) == 2))
        magref_stripe(height & 0x4 ? sigma2 : sigma1, dec + static_cast<size_t>(height & 0xFFFFFC) * width);
      if ((height & 3) == 1 || (height & 3) == 2)
        stripe_mbr(height & 0x4 ? sigma2 : sigma1, height & 0x4 ? mbrs2 : mbrs1);
      const int st = height - (height > 6 ? ((height + 1) & 3) + 3 : height);
      for (int y = st; y < height; y += 4) {
        const uint32_t pattern = height - y == 3 ? 0x77777777u : height - y == 2 ? 0x33333333u
                                 : height - y == 1 ? 0x11111111u : 0xFFFFFFFFu;
        uint32_t* cur_sig = y & 0x4 ? sigma2 : sigma1;
        uint32_t* cur_mbr = y & 0x4 ? mbrs2 : mbrs1;
        uint32_t* nxt_sig = y & 0x4 ? sigma1 : sigma2;
        uint32_t* nxt_mbr = y & 0x4 ? mbrs1 : mbrs2;
        if (height - y > 4) add_next(cur_sig, cur_mbr, nxt_sig);
        sigprop_stripe(y, cur_sig, cur_mbr, nxt_sig, nxt_mbr, pattern);
      }
    }

    // sign and magnitude to two's complement, into the Part-1 layout
    for (int y = 0; y < height; ++y) {
      const uint32_t* srow = dec + static_cast<size_t>(y) * width;
      int32_t* row = data.data() + static_cast<size_t>(y + 1) * stride + 1;
      for (int x = 0; x < width; ++x) {
        const int32_t v = static_cast<int32_t>(srow[x] & 0x7FFFFFFF);
        row[x] = (srow[x] & 0x80000000u) ? -v : v;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// inverse wavelets (dwt.c)
// ---------------------------------------------------------------------------
// the inverse 5/3 on one interleaved line of sn low and dn high samples,
// the low ones at parity `cas` (the line's first coordinate's); a sample
// at an end, with one neighbour, takes dwt.c's halved form of the mirrored
// sum, and the sums wrap as dwt.c's do
void idwt53_line(int32_t* x, int sn, int dn, int cas) {
  const int n = sn + dn;
  if (n == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  int i = cas;
  if (i == 0) {
    x[0] = wsub(x[0], wadd(x[1], 1) >> 1);
    i = 2;
  }
  for (; i + 1 < n; i += 2) x[i] = wsub(x[i], wadd(wadd(x[i - 1], x[i + 1]), 2) >> 2);
  if (i < n) x[i] = wsub(x[i], wadd(x[i - 1], 1) >> 1);
  i = 1 - cas;
  if (i == 0) {
    x[0] = wadd(x[0], x[1]);
    i = 2;
  }
  for (; i + 1 < n; i += 2) x[i] = wadd(x[i], wadd(x[i - 1], x[i + 1]) >> 1);
  if (i < n) x[i] = wadd(x[i], x[i - 1]);
}

const float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f,
            kDelta = 0.443506852f, kK = 1.230174105f, kTwoInvK = 1.625732422f;

// dwt.c's opj_v8dwt_decode on one interleaved line
void idwt97_line(float* x, int sn, int dn, int cas) {
  const int n = sn + dn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  for (int i = cas; i < n; i += 2) x[i] = x[i] * kK;
  for (int i = 1 - cas; i < n; i += 2) x[i] = x[i] * kTwoInvK;
  auto lift = [&](int first, float c) {
    const float c2 = c + c;
    for (int i = first; i < n; i += 2) {
      const bool hl = i - 1 >= 0, hr = i + 1 < n;
      if (hl && hr) x[i] = x[i] + ((x[i - 1] + x[i + 1]) * c);
      else if (hl) x[i] = x[i] + x[i - 1] * c2;
      else x[i] = x[i] + ((x[i + 1] + x[i + 1]) * c);
    }
  };
  lift(cas, -kDelta);
  lift(1 - cas, -kGamma);
  lift(cas, -kBeta);
  lift(1 - cas, -kAlpha);
}

template <class F>
void parallel_for(int64_t n, int threads, F&& f) {
  if (threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) f(i);
    return;
  }
  std::atomic<int64_t> next{0};
  std::atomic<bool> failed{false};
  std::string why;
  std::vector<std::thread> pool;
  const int nt = static_cast<int>(std::min<int64_t>(threads, n));
  for (int t = 0; t < nt; ++t)
    pool.emplace_back([&, t] {
      for (;;) {
        const int64_t i = next.fetch_add(1);
        if (i >= n || failed.load()) return;
        try {
          f(i);
        } catch (const J2kError& e) {
          if (!failed.exchange(true)) why = e.what;
          return;
        }
      }
    });
  for (auto& th : pool) th.join();
  if (failed.load()) fail(why);
}

template <class T, class Line>
void idwt_2d(TileComp& tc, T* buf, int top, int threads, Line line) {
  const int64_t W = tc.w();
  for (int r = 1; r <= top; ++r) {
    const Resolution& res = tc.res[r];
    const Resolution& prev = tc.res[r - 1];
    const int rw = static_cast<int>(res.x1 - res.x0), rh = static_cast<int>(res.y1 - res.y0);
    if (rw == 0 || rh == 0) continue;
    const int snh = static_cast<int>(prev.x1 - prev.x0), cash = static_cast<int>(res.x0 & 1);
    const int snv = static_cast<int>(prev.y1 - prev.y0), casv = static_cast<int>(res.y0 & 1);
    const int64_t rows_per = 16;
    parallel_for((rh + rows_per - 1) / rows_per, threads, [&](int64_t job) {
      std::vector<T> tmp(rw);
      for (int64_t y = job * rows_per; y < std::min<int64_t>(rh, (job + 1) * rows_per); ++y) {
        T* row = buf + y * W;
        for (int i = 0; i < snh; ++i) tmp[cash + 2 * i] = row[i];
        for (int i = 0; i < rw - snh; ++i) tmp[1 - cash + 2 * i] = row[snh + i];
        line(tmp.data(), snh, rw - snh, cash);
        std::memcpy(row, tmp.data(), sizeof(T) * rw);
      }
    });
    const int64_t cols_per = 16;
    parallel_for((rw + cols_per - 1) / cols_per, threads, [&](int64_t job) {
      std::vector<T> tmp(rh);
      for (int64_t x = job * cols_per; x < std::min<int64_t>(rw, (job + 1) * cols_per); ++x) {
        for (int i = 0; i < snv; ++i) tmp[casv + 2 * i] = buf[i * W + x];
        for (int i = 0; i < rh - snv; ++i) tmp[1 - casv + 2 * i] = buf[(snv + i) * W + x];
        line(tmp.data(), snv, rh - snv, casv);
        for (int i = 0; i < rh; ++i) buf[i * W + x] = tmp[i];
      }
    });
  }
}

// ---------------------------------------------------------------------------
// a tile, from its packets to Pillow's image
// ---------------------------------------------------------------------------
struct Output {
  int64_t width, height;
  int channels;
  const int32_t* chan_comp;  // source component of each channel; -1: 0xFF
  int bits;                  // 8 or 16: the samples Pillow's mode holds
  bool ycc;                  // channels 0-2 are YCbCr, converted to RGB
  void* out;
};

// Pillow's ImagingConvertYCbCr2RGB (ConvertYCbCr.c): 6-bit fixed-point
// tables, trunc(64 k (i - 128) + 0.5) for the constants of JFIF
struct YccTables {
  int16_t r_cr[256], g_cb[256], g_cr[256], b_cb[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      const double d = i - 128;
      r_cr[i] = static_cast<int16_t>(1.40200 * 64 * d + 0.5);
      g_cb[i] = static_cast<int16_t>(-0.34414 * 64 * d + 0.5);
      g_cr[i] = static_cast<int16_t>(-0.71414 * 64 * d + 0.5);
      b_cb[i] = static_cast<int16_t>(1.77200 * 64 * d + 0.5);
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp_u8(int v) { return static_cast<uint8_t>(v <= 0 ? 0 : v >= 255 ? 255 : v); }

// the YCbCr pixels of rows [y0, y0 + h) x cols [x0, x0 + w) of the u8
// image `o` to RGB in place (Pillow's j2ku_sycc_rgb / j2ku_sycca_rgba run
// it on each row they unpack; alpha stays)
void ycc_to_rgb(const Output& o, int64_t x0, int64_t y0, int64_t w, int64_t h) {
  for (int64_t y = y0; y < y0 + h; ++y) {
    uint8_t* p = static_cast<uint8_t*>(o.out) + (y * o.width + x0) * o.channels;
    for (int64_t x = 0; x < w; ++x, p += o.channels) {
      const int yy = p[0], cb = p[1], cr = p[2];
      p[0] = clamp_u8(yy + (kYcc.r_cr[cr] >> 6));
      p[1] = clamp_u8(yy + ((kYcc.g_cb[cb] + kYcc.g_cr[cr]) >> 6));
      p[2] = clamp_u8(yy + (kYcc.b_cb[cb] >> 6));
    }
  }
}

// the bytes of a sample of `prec` bits in OpenJPEG's tile buffer
inline int word_bytes(int prec) {
  const int n = (prec + 7) >> 3;
  return n == 3 ? 4 : n;
}

// the little-endian word of `csiz` bytes at b
inline uint32_t load_word(const uint8_t* b, int csiz) {
  switch (csiz) {
    case 1:
      return b[0];
    case 2:
      return b[0] | uint32_t{b[1]} << 8;
    default:
      return b[0] | uint32_t{b[1]} << 8 | uint32_t{b[2]} << 16 | uint32_t{b[3]} << 24;
  }
}

// the bytes of a tile's components in the buffer OpenJPEG's
// opj_decode_tile_data fills (opj_tcd_update_tile_data): each component's
// samples at its decoded resolution, rows packed, in words of 1, 2 or 4
// bytes (3 stored as 4), one component after the other; zero past them,
// up to `size` at least (Pillow zeroes its buffer)
std::vector<uint8_t> tile_buffer(const Siz& s, const std::vector<TileComp>& tcs,
                                 const std::vector<int>& top, int64_t size) {
  int64_t total = 0;
  for (int c = 0; c < s.nc; ++c) {
    const Resolution& r = tcs[c].res[top[c]];
    total += word_bytes(s.comps[c].prec) * (r.x1 - r.x0) * (r.y1 - r.y0);
  }
  std::vector<uint8_t> buf(static_cast<size_t>(std::max(total, size)), 0);
  size_t at = 0;
  for (int c = 0; c < s.nc; ++c) {
    const int csiz = word_bytes(s.comps[c].prec);
    const Resolution& r = tcs[c].res[top[c]];
    const int64_t rw = r.x1 - r.x0, rh = r.y1 - r.y0, W = tcs[c].w();
    for (int64_t y = 0; y < rh; ++y)
      for (int64_t x = 0; x < rw; ++x, at += csiz) {
        const uint32_t v = static_cast<uint32_t>(tcs[c].idata[y * W + x]);
        for (int k = 0; k < csiz; ++k) buf[at + k] = static_cast<uint8_t>(v >> (8 * k));
      }
  }
  return buf;
}

// `ppm`: the codestream's PPM header stream, read on from where the tile
// decoded before this one left it (null without PPM)
void decode_tile(const Codestream& cs, int tile, int threads, const Output& o, HeaderStream* ppm) {
  const Siz& s = cs.siz;
  const Tile& t = cs.tiles[tile];
  const int64_t p = tile % s.ntx, q = tile / s.ntx;
  const int64_t tx0 = std::max(s.XTO + p * s.XT, s.XO), ty0 = std::max(s.YTO + q * s.YT, s.YO);
  const int64_t tx1 = std::min(s.XTO + (p + 1) * s.XT, s.X);
  const int64_t ty1 = std::min(s.YTO + (q + 1) * s.YT, s.Y);
  // Pillow's bounds check on the tile's place in its image
  if (tx1 - s.XO > o.width || ty1 - s.YO > o.height)
    fail("a tile lies outside the image of the JP2 header");
  const Params& prm = t.params;
  std::vector<TileComp> tcs(s.nc);
  for (int c = 0; c < s.nc; ++c)
    init_tilecomp(tcs[c], s.comps[c], prm.coding[c], prm.quant[c], tx0, ty0, tx1, ty1);
  // tier-2 over the tile's data (its tile-parts joined)
  std::vector<uint8_t> joined;
  const uint8_t* data;
  size_t len;
  if (t.parts.size() == 1) {
    data = cs.data + t.parts[0].begin;
    len = t.parts[0].end - t.parts[0].begin;
  } else {
    for (const auto& tp : t.parts)
      joined.insert(joined.end(), cs.data + tp.begin, cs.data + tp.end);
    data = joined.data();
    len = joined.size();
  }
  // the packet headers: PPM's stream, the tile's PPT segments in Zppt
  // order (j2k.c's opj_j2k_merge_ppt), or in line with the bodies
  std::vector<uint8_t> ppt;
  HeaderStream ppt_stream{nullptr, 0};
  HeaderStream* hs = ppm;
  if (!hs && !t.ppt.empty()) {
    for (const Ppx& x : t.ppt)
      if (x.seen) ppt.insert(ppt.end(), cs.data + x.begin, cs.data + x.end);
    ppt_stream = {ppt.data(), ppt.size()};
    hs = &ppt_stream;
  }
  // top[c]: tcd.c's resno_decoded, the highest resolution of a packet of
  // component c; a POC may leave it below the component's last
  std::vector<int> top(s.nc, 0);
  size_t pos = 0;
  for (const Packet& pk : packet_order(prm, tcs, s, tx0, ty0, tx1, ty1)) {
    pos = read_packet(data, pos, len, prm, tcs[pk.comp], pk, prm.coding[pk.comp].style, hs);
    top[pk.comp] = std::max(top[pk.comp], pk.res);
  }
  // tier-1 and dequantisation, the code-blocks on `threads` threads
  struct Job {
    int comp;
    const Band* band;
    const Cblk* cb;
  };
  std::vector<Job> jobs;
  for (int c = 0; c < s.nc; ++c) {
    TileComp& tc = tcs[c];
    const size_t n = static_cast<size_t>(tc.w()) * tc.h();
    if (tc.transform == 1) tc.idata.assign(n, 0);
    else tc.fdata.assign(n, 0.0f);
    for (const Resolution& res : tc.res)
      for (const Band& band : res.bands)
        for (const Precinct& pr : band.precs)
          for (const Cblk& cb : pr.cblks) {
            // t1.c tries every code-block: one never included has 0 bit-planes
            // (an HT one decodes to zeros, where no ROI shift refuses it)
            if (!cb.chunks.empty()) jobs.push_back({c, &band, &cb});
            else if (prm.coding[c].style & HT) t1_refuse_ht_roi(prm.roishift[c]);
            else if (prm.roishift[c] >= 31) fail("a code-block of more than 30 bit-planes (its ROI shift included)");
          }
  }
  parallel_for(static_cast<int64_t>(jobs.size()), threads, [&](int64_t j) {
    thread_local T1 t1;
    const Job& job = jobs[j];
    TileComp& tc = tcs[job.comp];
    const Band& band = *job.band;
    const Cblk& cb = *job.cb;
    const int style = prm.coding[job.comp].style;
    if (style & HT) t1.decode_ht(data, cb, band.Mb, style, prm.roishift[job.comp]);
    else t1.decode_cblk(data, cb, band.orient, style, prm.roishift[job.comp]);
    const int64_t W = tc.w();
    const int64_t x = cb.x0 - band.x0 + band.xoff, y = cb.y0 - band.y0 + band.yoff;
    for (int yy = 0; yy < t1.h; ++yy) {
      const int32_t* src = t1.data.data() + static_cast<size_t>(yy + 1) * t1.stride + 1;
      if (tc.transform == 1) {
        int32_t* dst = tc.idata.data() + (y + yy) * W + x;
        for (int xx = 0; xx < t1.w; ++xx) dst[xx] = src[xx] / 2;
      } else {
        const float step = 0.5f * band.step;
        float* dst = tc.fdata.data() + (y + yy) * W + x;
        for (int xx = 0; xx < t1.w; ++xx) dst[xx] = static_cast<float>(src[xx]) * step;
      }
    }
  });
  // inverse wavelets, up to each component's decoded resolution
  for (int c = 0; c < s.nc; ++c) {
    TileComp& tc = tcs[c];
    if (tc.w() == 0 || tc.h() == 0) continue;
    if (tc.transform == 1) idwt_2d(tc, tc.idata.data(), top[c], threads, idwt53_line);
    else idwt_2d(tc, tc.fdata.data(), top[c], threads, idwt97_line);
  }
  const int64_t W = tx1 - tx0, H = ty1 - ty0;
  // multiple component transform (tcd.c's opj_tcd_mct_decode, mct.c): the
  // three components of one resolution count and one sample count
  if (prm.mct && s.nc >= 3) {
    if (tcs[1].levels != tcs[0].levels || tcs[2].levels != tcs[0].levels)
      fail("a component transform over components of different resolution counts");
    const size_t npx = tcs[0].idata.size() + tcs[0].fdata.size();
    if (top[0] != top[1] || top[0] != top[2] ||
        tcs[1].idata.size() + tcs[1].fdata.size() != npx ||
        tcs[2].idata.size() + tcs[2].fdata.size() != npx)
      fail("a component transform over components of different sizes or decoded resolutions");
    if (tcs[0].transform != tcs[1].transform || tcs[0].transform != tcs[2].transform)
      fail("a component transform over components of different wavelets");
    if (tcs[0].transform == 1) {
      int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(), *c2 = tcs[2].idata.data();
      for (size_t i = 0; i < npx; ++i) {
        const int32_t y = c0[i], u = c1[i], v = c2[i];
        const int32_t g = wsub(y, wadd(u, v) >> 2);
        c0[i] = wadd(v, g);
        c1[i] = g;
        c2[i] = wadd(u, g);
      }
    } else {
      float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(), *c2 = tcs[2].fdata.data();
      for (size_t i = 0; i < npx; ++i) {
        const float y = c0[i], u = c1[i], v = c2[i];
        const float r = y + (v * 1.402f);
        float g = y - (u * 0.34413f);
        g = g - (v * 0.71414f);
        const float b = y + (u * 1.772f);
        c0[i] = r;
        c1[i] = g;
        c2[i] = b;
      }
    }
  }
  // DC level shift and clamp (tcd.c), into int32 samples; the 5/3's sum
  // in int32 as tcd.c makes it
  for (int c = 0; c < s.nc; ++c) {
    TileComp& tc = tcs[c];
    const CompSiz& cz = s.comps[c];
    const int64_t lo = cz.sgnd ? -(int64_t{1} << (cz.prec - 1)) : 0;
    const int64_t hi = cz.sgnd ? (int64_t{1} << (cz.prec - 1)) - 1 : (int64_t{1} << cz.prec) - 1;
    const int32_t shift = cz.sgnd ? 0 : static_cast<int32_t>(uint32_t{1} << (cz.prec - 1));
    if (tc.transform == 1) {
      for (int32_t& v : tc.idata) v = static_cast<int32_t>(std::max<int64_t>(lo, std::min<int64_t>(hi, wadd(v, shift))));
    } else {
      tc.idata.resize(tc.fdata.size());
      for (size_t i = 0; i < tc.fdata.size(); ++i) {
        const float f = tc.fdata[i];
        int64_t v;
        if (f > static_cast<float>(INT32_MAX)) v = hi;
        else if (f < static_cast<float>(INT32_MIN)) v = lo;
        else v = std::max(lo, std::min(hi, static_cast<int64_t>(std::lrintf(f)) + shift));
        tc.idata[i] = static_cast<int32_t>(v);
      }
      std::vector<float>().swap(tc.fdata);
    }
  }
  // Pillow's unpackers (Jpeg2KDecode.c) over the tile buffer: component c
  // at the sum of the sizes before it, csiz * (W / dx) * (H / dy) each,
  // pixel (x, y) from its word (y / dy) * (W / dx) + x / dx, read as the
  // unsigned bytes OpenJPEG stores, offset and shifted. Where OpenJPEG's
  // sizes are not these (odd sizes or origins, a resolution short of the
  // last), a pixel takes the bytes Pillow's does, not its sample's.
  std::vector<int64_t> at(s.nc);
  int64_t pil = 0, words = 0;
  for (int c = 0; c < s.nc; ++c) {
    const CompSiz& cz = s.comps[c];
    const int csiz = word_bytes(cz.prec);
    at[c] = pil;
    pil += csiz * (W / cz.dx) * (H / cz.dy);
    words += csiz;
  }
  // Pillow's buffer holds W * H words of each component
  const std::vector<uint8_t> buf = tile_buffer(s, tcs, top, words * W * H);
  const int64_t ox = tx0 - s.XO, oy = ty0 - s.YO;
  for (int ch = 0; ch < o.channels; ++ch) {
    const int c = o.chan_comp[ch];
    uint32_t offset = 0;
    int shift = 0, csiz = 0;
    int64_t dx = 1, dy = 1, stride = 0;
    if (c >= 0) {
      const CompSiz& cz = s.comps[c];
      csiz = word_bytes(cz.prec);
      shift = o.bits - cz.prec;
      offset = cz.sgnd ? 1u << (cz.prec - 1) : 0u;
      if (shift < 0) offset += 1u << (-shift - 1);
      dx = cz.dx;
      dy = cz.dy;
      stride = W / dx;
    }
    for (int64_t y = 0; y < H; ++y) {
      const uint8_t* src = c >= 0 ? buf.data() + at[c] + csiz * (y / dy) * stride : nullptr;
      const int64_t base = ((oy + y) * o.width + ox) * o.channels + ch;
      // src advances a word every dx pixels
      for (int64_t x = 0, xr = 0; x < W; ++x) {
        uint32_t v = 0xFF;
        if (c >= 0) {
          const uint32_t word = offset + load_word(src, csiz);
          v = shift < 0 ? word >> -shift : word << shift;
          if (++xr == dx) {
            xr = 0;
            src += csiz;
          }
        }
        if (o.bits == 8) static_cast<uint8_t*>(o.out)[base + x * o.channels] = static_cast<uint8_t>(v);
        else static_cast<uint16_t*>(o.out)[base + x * o.channels] = static_cast<uint16_t>(v);
      }
    }
  }
  if (o.ycc) ycc_to_rgb(o, ox, oy, W, H);
}

void decode(const uint8_t* src, size_t n, const Output& o, int threads) {
  Codestream cs = parse(src, n);
  const Siz& s = cs.siz;
  for (int ch = 0; ch < o.channels; ++ch)
    if (o.chan_comp[ch] >= s.nc) fail("a channel past the component count");
  std::vector<int> tiles;
  for (size_t t = 0; t < cs.tiles.size(); ++t)
    if (cs.tiles[t].seen) tiles.push_back(static_cast<int>(t));
  if (cs.has_ppm) {
    // one header stream for all tiles, read in the order OpenJPEG decodes
    // them: as their last tile-part arrives, then (TNsot 0, or parts
    // missing) by index after EOC
    std::stable_sort(tiles.begin(), tiles.end(), [&](int a, int b) {
      const int64_t da = cs.tiles[a].done_at, db = cs.tiles[b].done_at;
      return (da >= 0 ? da : INT64_MAX) < (db >= 0 ? db : INT64_MAX);
    });
    HeaderStream ppm{cs.ppm.data(), cs.ppm.size()};
    for (int t : tiles) decode_tile(cs, t, threads, o, &ppm);
  } else if (static_cast<int>(tiles.size()) >= 2 * threads) {
    // many tiles: one thread a tile; few: the threads inside each tile
    parallel_for(static_cast<int64_t>(tiles.size()), threads,
                 [&](int64_t i) { decode_tile(cs, tiles[i], 1, o, nullptr); });
  } else {
    for (int t : tiles) decode_tile(cs, t, threads, o, nullptr);
  }
}

void set_error(char* err, int64_t errcap, const std::string& what) {
  if (err == nullptr || errcap <= 0) return;
  const size_t k = std::min<size_t>(what.size(), static_cast<size_t>(errcap - 1));
  std::memcpy(err, what.data(), k);
  err[k] = 0;
}

}  // namespace

extern "C" {

// Decode the codestream src[0, n) into `out`, a zeroed (height, width,
// channels) array of u8 (bits 8) or u16 (bits 16): Pillow's image of that
// size, channel k taken from component chan_comp[k] (-1: 0xFF), channels
// 0-2 converted from YCbCr to RGB where `ycc` is set. 0, or -1 with the
// reason in err.
int64_t j2k_decode(const uint8_t* src, int64_t n, int64_t width, int64_t height, int32_t channels,
                   const int32_t* chan_comp, int32_t bits, int32_t ycc, void* out, int32_t threads,
                   char* err, int64_t errcap) {
  try {
    Output o{width, height, channels, chan_comp, bits, ycc != 0, out};
    decode(src, static_cast<size_t>(n), o, std::max(1, static_cast<int>(threads)));
    return 0;
  } catch (const J2kError& e) {
    set_error(err, errcap, e.what);
  } catch (const std::bad_alloc&) {
    set_error(err, errcap, "out of memory");
  }
  return -1;
}

}  // extern "C"
