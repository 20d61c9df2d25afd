// AV1 still-image decoder of the port's AVIF reader (io/avif.py): the
// intra key frame of an AV1 OBU stream, 8-, 10- or 12-bit 4:2:0, 4:2:2,
// 4:4:4 or monochrome, as the AV1 bitstream specification (with errata, 2019)
// defines its syntax and reconstruction and dav1d 1.5.1 decodes it for
// libavif 1.3.0, film grain included (libavif leaves dav1d's apply_grain
// on), then libavif's scale of a frame to its item's size (avifImageScale
// through libyuv's ScalePlane) where it has another, and libavif's
// YUV-to-RGB conversion as it runs it for Pillow 12.1: libyuv's fixed-point
// matrices (row_common.c) with bilinear (4:2:0) or linear (4:2:2) chroma
// upsampling, and libavif's own float code for monochrome samples, the
// identity matrix and the matrices libyuv lacks; an alpha item's stream
// decodes beside it into a fourth channel, and a premultiplied (`prem`)
// colour is unpremultiplied as libyuv's ARGBUnattenuate (or libavif's float
// code) does it.
//
// Read: temporal delimiter, sequence header (reduced and full), frame
// header / frame OBUs and tile groups of one key frame; metadata, padding
// and tile-list OBUs are skipped. Palette blocks (luma and chroma),
// quantizer matrices (§7.12.3) and intra block copy (the DV stack of
// find_mv_stack, the MV CDFs, transform trees and inter transform types
// of an intrabc block, its bilinear prediction from the frame decoded so
// far) are read, and so are frames coded with superres (§5.9.8: the frame
// decodes at 8 / SuperresDenom of its width, never under 16 samples, as
// dav1d computes it). The in-loop filters run once the last tile is
// decoded: deblocking (§7.14), CDEF (§7.15), under superres the upscaling
// of whole rows to the frame's width (§7.16, dav1d's resize_c), and loop
// restoration (§7.17, Wiener and self-guided units) at that width; then
// film grain synthesis (§7.18.3). A 4:2:2 block that the spec gives no
// chroma size is refused by name. Each tile ends with the spec's trailing
// bits (exit process, §8.2.4); tile data that does not is refused by name,
// as non-conformant data that dav1d decodes to an output the spec does not
// define (aom 3.12.1 writes such a frame for 4:0:0 with a grain model it
// estimates: chroma grain fields a monochrome header does not have; and
// libaom writes allow_intrabc where superres leaves a frame as wide, which
// dav1d does not read).
//
// The tables (default CDFs, quantizer lookups and matrices, intra
// derivatives, smooth weights, filter-intra taps, edge kernels, cos / sin
// constants, the in-loop filters' CDFs, directions, taps and parameters,
// the film grain's Gaussian sequence, intrabc's MV and transform CDFs,
// superres's upscaling filter) are
// in av1_tables.h, generated by av1_tables.py from libavif's read-only data.
//
// An image is one tile (an item, or a track's first sample) or a grid
// item's tiles: each decodes on a thread of a pool, is checked against the
// image's first tile as libavif checks a grid (size, depth, layout, range,
// CICP; coverage of the output) and is copied into the image's planes,
// cropped at its right and bottom edges; then libavif's conversion runs
// once over the whole image. As libavif decodes the tiles one after another
// with one dav1d, a tile starts from the sequence header of the tiles
// before it; dav1d also parses what follows a frame in a tile's data.
//
// C interface (ctypes, _native/__init__.py):
//   av1_decode_grid(tiles, sizes, color, alpha, matrix, primaries,
//                   full_range, premultiplied, threads, out, stride, err,
//                   errlen) -> 0,
//              or -1 with the reason in err: the AV1 data of each tile
//              (pointers and sizes, the colour image's then the alpha
//              image's, in raster order) and each image's (grid, columns,
//              rows, tile width, tile height, width, height), each tile's
//              frame scaled to the tile size where it has another; RGB into
//              out (3 channels), or RGBA (4) where the alpha image has tiles
//              (0 columns: none), unpremultiplied where premultiplied is 1,
//              on up to `threads` threads; matrix, primaries and full_range
//              -1: the sequence header's.
//   av1_scale_plane, av1_convert_planes: the scaler and the conversion
//              alone, on planes the caller gives (the tests hold them to
//              Pillow's libavif).
//   av1_frame_info: what the parse makes of a frame (its size, superres,
//              tiles, restoration, grain), its tiles decoded and no
//              filter run.
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <exception>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "av1_tables.h"

namespace {

// an error of the stream: refused as dav1d refuses it
struct Invalid : std::runtime_error {
  explicit Invalid(const std::string& s) : std::runtime_error("AV1: " + s) {}
};
// a feature the port does not decode yet ("AV1 <what> is / are not read
// by the port yet")
struct NotYet : std::runtime_error {
  explicit NotYet(const std::string& s, bool plural = false)
      : std::runtime_error("AV1 " + s + (plural ? " are" : " is") +
                           " not read by the port yet") {}
};

// libavif's decoder limits (AVIF_DEFAULT_IMAGE_SIZE_LIMIT), which dav1d
// applies to a frame, and the largest side avifImageScale takes
constexpr int64_t kImageSizeLimit = 16384 * 16384;
constexpr int kScaleSideLimit = 16384;

inline int imin(int a, int b) { return a < b ? a : b; }
inline int imax(int a, int b) { return a > b ? a : b; }
inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline int round2(int x, int n) { return n == 0 ? x : (x + (1 << (n - 1))) >> n; }
inline int64_t round2l(int64_t x, int n) {
  return n == 0 ? x : (x + ((int64_t)1 << (n - 1))) >> n;
}
inline int round2signed(int x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }
inline int floorlog2(uint32_t x) { int s = 0; while (x > 1) { x >>= 1; s++; } return s; }

// ---------------------------------------------------------------------------
// bit reader of the headers (spec §4.10)
// ---------------------------------------------------------------------------
struct Bits {
  const uint8_t* p;
  size_t size;  // bytes
  size_t pos = 0;  // bits
  Bits(const uint8_t* d, size_t n) : p(d), size(n) {}
  uint32_t bit() {
    if (pos >= size * 8) throw Invalid("header runs past its OBU");
    uint32_t b = (p[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  uint32_t f(int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; i++) x = 2 * x + bit();
    return x;
  }
  int su(int n) {
    int v = (int)f(n);
    int sign = 1 << (n - 1);
    if (v & sign) v -= 2 * sign;
    return v;
  }
  uint32_t ns(uint32_t n) {
    int w = floorlog2(n) + 1;
    uint32_t m = (1u << w) - n;
    uint32_t v = f(w - 1);
    if (v < m) return v;
    return (v << 1) - m + bit();
  }
  uint32_t uvlc() {
    int lz = 0;
    while (!bit()) {
      lz++;
      if (lz >= 32) return 0xFFFFFFFFu;
    }
    return f(lz) + (uint32_t)((1ull << lz) - 1);
  }
  void byte_align() {
    while (pos & 7) bit();
  }
};

// ---------------------------------------------------------------------------
// enumerations and the spec's small lookup functions
// ---------------------------------------------------------------------------
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
       D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
       PAETH_PRED, UV_CFL_PRED };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
       FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
       V_ADST, H_ADST, V_FLIPADST, H_FLIPADST };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4,
       TX_8X16, TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16,
       TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16 };
enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8,
       BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64,
       BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128,
       BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64,
       BLOCK_64X16, BLOCK_INVALID };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
       PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A,
       PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4 };
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };

// log2 of the width / height of each block size, in samples
const int kBlockW2[22] = {2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7,
                          2, 4, 3, 5, 4, 6};
const int kBlockH2[22] = {2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 6, 5, 6, 7, 6, 7,
                          4, 2, 5, 3, 6, 4};
const int kTxW2[19] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6};
const int kTxH2[19] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4};
const int kModeToAngle[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67,
                              0, 0, 0, 0};
const int kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const int kModeToTxfm[14] = {DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST,
                             ADST_DCT, DCT_ADST, DCT_ADST, ADST_DCT,
                             ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST,
                             DCT_DCT};
const int kTxTypeIntraInvSet1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST,
                                    ADST_DCT, DCT_ADST};
const int kTxTypeIntraInvSet2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT,
                                    DCT_ADST};
const int kTxTypeInterInvSet1[16] = {IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST,
                                     H_FLIPADST, DCT_DCT, ADST_DCT, DCT_ADST,
                                     FLIPADST_DCT, DCT_FLIPADST, ADST_ADST,
                                     FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
const int kTxTypeInterInvSet2[12] = {IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST,
                                     FLIPADST_DCT, DCT_FLIPADST, ADST_ADST,
                                     FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
const int kTxTypeInterInvSet3[2] = {IDTX, DCT_DCT};
// the transform sets of get_tx_set: intra 1 and 2 as the port numbers them
// (0 DCT only), then the inter sets 3, 4 and 5 (the spec's TX_SET_INTER_1 - 3)
enum { TX_SET_INTER_1 = 3, TX_SET_INTER_2, TX_SET_INTER_3 };
const int kFilterIntraModeToIntraDir[5] = {DC_PRED, V_PRED, H_PRED,
                                           D157_PRED, DC_PRED};
// where each coded (at most 32 x 32) transform size's matrix starts in a
// level's Quantizer_Matrix (the 64-sample sizes use their coded size's)
const int kQmOffset[19] = {0, 16, 80, 336, 0, 1360, 1392, 1424, 1552, 1680,
                           2192, 0, 0, 2704, 2768, 2832, 3088, 0, 0};
const int kTransformRowShift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1,
                                    1, 1, 2, 2, 2, 2};
const int kSegFeatureBits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
const int kSegFeatureSigned[8] = {1, 1, 1, 1, 1, 0, 0, 0};
const int kSegFeatureMax[8] = {255, 63, 63, 63, 63, 7, 0, 0};
const int kSigRefDiffOffset[3][5][2] = {
    {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
    {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
    {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
const int kMagRefOffset[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}},
                                    {{0, 1}, {1, 0}, {0, 2}},
                                    {{0, 1}, {1, 0}, {2, 0}}};
// Coeff_Base_Ctx_Offset by shape: square, wider than tall, taller than wide
const int kCoeffBaseCtxOffset[3][5][5] = {
    {{0, 1, 6, 6, 21}, {1, 6, 6, 21, 21}, {6, 6, 21, 21, 21},
     {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}},
    {{0, 16, 6, 6, 21}, {16, 16, 6, 21, 21}, {16, 16, 21, 21, 21},
     {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21}},
    {{0, 11, 11, 11, 11}, {11, 11, 11, 11, 11}, {6, 6, 21, 21, 21},
     {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}}};
const int kCoeffBasePosCtxOffset[3] = {26, 31, 36};
// the loop filter's reference deltas after setup_past_independence
const int kDefaultLfRefDeltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };
const int kRemapLrType[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER,
                             RESTORE_SGRPROJ};
// the ranges of the coded restoration coefficients (the spec's constants:
// libavif keeps them as immediates, not as tables)
const int kWienerTapsMin[3] = {-5, -23, -17};
const int kWienerTapsMax[3] = {10, 8, 46};
const int kWienerTapsK[3] = {1, 2, 3};
const int kSgrprojXqdMin[2] = {-96, -32};
const int kSgrprojXqdMax[2] = {31, 95};
const int kSgrprojXqdMid[2] = {-32, 31};

int block_size(int w2, int h2) {
  for (int b = 0; b < 22; b++)
    if (kBlockW2[b] == w2 && kBlockH2[b] == h2) return b;
  return BLOCK_INVALID;
}
int tx_size(int w2, int h2) {
  for (int t = 0; t < 19; t++)
    if (kTxW2[t] == w2 && kTxH2[t] == h2) return t;
  return -1;
}
int partition_subsize(int p, int b) {
  int w2 = kBlockW2[b], h2 = kBlockH2[b];
  switch (p) {
    case PARTITION_NONE: return b;
    case PARTITION_HORZ: case PARTITION_HORZ_A: case PARTITION_HORZ_B:
      return block_size(w2, h2 - 1);
    case PARTITION_VERT: case PARTITION_VERT_A: case PARTITION_VERT_B:
      return block_size(w2 - 1, h2);
    case PARTITION_SPLIT: return block_size(w2 - 1, h2 - 1);
    case PARTITION_HORZ_4: return block_size(w2, h2 - 2);
    default: return block_size(w2 - 2, h2);
  }
}
int max_tx_size_rect(int b) {
  return tx_size(imin(kBlockW2[b], 6), imin(kBlockH2[b], 6));
}
int split_tx_size(int t) {
  int w2 = kTxW2[t], h2 = kTxH2[t];
  if (w2 == h2) return t == TX_4X4 ? TX_4X4 : tx_size(w2 - 1, h2 - 1);
  if (w2 > h2) return w2 - h2 == 2 ? tx_size(w2 - 1, h2) : tx_size(h2, h2);
  return h2 - w2 == 2 ? tx_size(w2, h2 - 1) : tx_size(w2, w2);
}
int tx_sqr(int t) { return tx_size(imin(kTxW2[t], kTxH2[t]), imin(kTxW2[t], kTxH2[t])); }
int tx_sqr_up(int t) { return tx_size(imax(kTxW2[t], kTxH2[t]), imax(kTxW2[t], kTxH2[t])); }
int adjusted_tx_size(int t) { return tx_size(imin(kTxW2[t], 5), imin(kTxH2[t], 5)); }
int tx_class(int type) {
  if (type == V_DCT || type == V_ADST || type == V_FLIPADST) return TX_CLASS_VERT;
  if (type == H_DCT || type == H_ADST || type == H_FLIPADST) return TX_CLASS_HORIZ;
  return TX_CLASS_2D;
}

// the spec's scans: default (zig-zag on squares, one diagonal direction on
// rectangles), mrow and mcol, for the coded (at most 32) size
struct Scans {
  std::vector<uint16_t> dflt[19], mrow[19], mcol[19];
  Scans() {
    for (int t = 0; t < 19; t++) {
      int w = 1 << imin(kTxW2[t], 5), h = 1 << imin(kTxH2[t], 5);
      std::vector<uint16_t>& d = dflt[t];
      for (int s = 0; s < w + h - 1; s++) {
        // positions (row, col) with row + col == s
        int rlo = imax(0, s - (w - 1)), rhi = imin(h - 1, s);
        bool down;  // row increasing along the diagonal
        if (w == h) down = (s & 1) != 0;
        else down = w < h;
        if (down) for (int r = rlo; r <= rhi; r++) d.push_back((uint16_t)(r * w + s - r));
        else for (int r = rhi; r >= rlo; r--) d.push_back((uint16_t)(r * w + s - r));
      }
      for (int i = 0; i < w * h; i++) mrow[t].push_back((uint16_t)i);
      for (int c = 0; c < w; c++)
        for (int r = 0; r < h; r++) mcol[t].push_back((uint16_t)(r * w + c));
    }
  }
};
const Scans& scans() {
  static const Scans s;
  return s;
}

// ---------------------------------------------------------------------------
// CDFs: the defaults of av1_tables.h, adapted as symbols are read
// ---------------------------------------------------------------------------
struct Cdfs {
  uint16_t kf_y[5][5][14];
  uint16_t uv[2][13][15];
  uint16_t angle[8][8];
  uint16_t partition[20][11];
  uint16_t skip[3][3];
  uint16_t seg[3][9];
  uint16_t delta_q[5];
  uint16_t delta_lf[5];
  uint16_t delta_lf_multi[4][5];
  uint16_t pal_y[7][3][3];
  uint16_t pal_uv[2][3];
  uint16_t pal_y_size[7][8];
  uint16_t pal_uv_size[7][8];
  uint16_t pal_y_color[7][5][9];
  uint16_t pal_uv_color[7][5][9];
  uint16_t intrabc[3];
  uint16_t filter_intra[22][3];
  uint16_t filter_intra_mode[6];
  uint16_t cfl_sign[9];
  uint16_t cfl_alpha[6][17];
  uint16_t tx_size[4][3][4];
  uint16_t tx_set1[2][13][8];
  uint16_t tx_set2[3][13][6];
  uint16_t txb_skip[5][13][3];
  uint16_t eob_extra[5][2][9][3];
  uint16_t dc_sign[2][3][3];
  uint16_t eob16[2][2][6];
  uint16_t eob32[2][2][7];
  uint16_t eob64[2][2][8];
  uint16_t eob128[2][2][9];
  uint16_t eob256[2][2][10];
  uint16_t eob512[2][2][11];
  uint16_t eob1024[2][2][12];
  uint16_t base_eob[5][2][4][4];
  uint16_t base[5][2][42][5];
  uint16_t br[5][2][21][5];
  uint16_t restoration_type[4];
  uint16_t use_wiener[3];
  uint16_t use_sgrproj[3];
  // intra block copy: transform splits, inter transform types, and the
  // DV's MV CDFs (MvCtx MV_INTRABC_CONTEXT) of the row and column
  uint16_t txfm_split[21][3];
  uint16_t inter_set1[2][17];
  uint16_t inter_set2[13];
  uint16_t inter_set3[4][3];
  uint16_t mv_joint[5];
  uint16_t mv_class[2][12];
  uint16_t mv_sign[2][3];
  uint16_t mv_class0[2][3];
  uint16_t mv_bits[2][10][3];

  void init(int base_q_idx) {
    memcpy(kf_y, AV1_KF_Y_MODE, sizeof kf_y);
    memcpy(uv, AV1_UV_MODE, sizeof uv);
    memcpy(angle, AV1_ANGLE_DELTA, sizeof angle);
    memcpy(partition, AV1_PARTITION, sizeof partition);
    memcpy(skip, AV1_SKIP, sizeof skip);
    memcpy(seg, AV1_SEGMENT_ID, sizeof seg);
    memcpy(delta_q, AV1_DELTA_LF_MULTI[0], sizeof delta_q);
    memcpy(delta_lf, AV1_DELTA_LF_MULTI[0], sizeof delta_lf);
    memcpy(delta_lf_multi, AV1_DELTA_LF_MULTI, sizeof delta_lf_multi);
    memcpy(pal_y, AV1_PALETTE_Y_MODE, sizeof pal_y);
    memcpy(pal_uv, AV1_PALETTE_UV_MODE_INTRABC, sizeof pal_uv);
    memcpy(pal_y_size, AV1_PALETTE_Y_SIZE, sizeof pal_y_size);
    memcpy(pal_uv_size, AV1_PALETTE_UV_SIZE, sizeof pal_uv_size);
    memcpy(pal_y_color, AV1_PALETTE_Y_COLOR, sizeof pal_y_color);
    memcpy(pal_uv_color, AV1_PALETTE_UV_COLOR, sizeof pal_uv_color);
    memcpy(intrabc, AV1_PALETTE_UV_MODE_INTRABC[2], sizeof intrabc);
    memcpy(filter_intra, AV1_FILTER_INTRA, sizeof filter_intra);
    memcpy(filter_intra_mode, AV1_FILTER_INTRA_MODE[0], sizeof filter_intra_mode);
    memcpy(cfl_sign, AV1_CFL_SIGN[0], sizeof cfl_sign);
    memcpy(cfl_alpha, AV1_CFL_ALPHA, sizeof cfl_alpha);
    memcpy(tx_size, AV1_TX_SIZE, sizeof tx_size);
    memcpy(tx_set1, AV1_INTRA_TX_SET1, sizeof tx_set1);
    memcpy(tx_set2, AV1_INTRA_TX_SET2, sizeof tx_set2);
    int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
    memcpy(txb_skip, AV1_TXB_SKIP[q], sizeof txb_skip);
    memcpy(eob_extra, AV1_EOB_EXTRA[q], sizeof eob_extra);
    memcpy(dc_sign, AV1_DC_SIGN[q], sizeof dc_sign);
    memcpy(eob16, AV1_EOB_PT_16[q], sizeof eob16);
    memcpy(eob32, AV1_EOB_PT_32[q], sizeof eob32);
    memcpy(eob64, AV1_EOB_PT_64[q], sizeof eob64);
    memcpy(eob128, AV1_EOB_PT_128[q], sizeof eob128);
    memcpy(eob256, AV1_EOB_PT_256[q], sizeof eob256);
    memcpy(eob512, AV1_EOB_PT_512[q], sizeof eob512);
    memcpy(eob1024, AV1_EOB_PT_1024[q], sizeof eob1024);
    memcpy(base_eob, AV1_COEFF_BASE_EOB[q], sizeof base_eob);
    memcpy(base, AV1_COEFF_BASE[q], sizeof base);
    memcpy(br, AV1_COEFF_BR[q], sizeof br);
    memcpy(restoration_type, AV1_RESTORATION_TYPE[0], sizeof restoration_type);
    memcpy(use_wiener, AV1_USE_WIENER[0], sizeof use_wiener);
    memcpy(use_sgrproj, AV1_USE_SGRPROJ[0], sizeof use_sgrproj);
    memcpy(txfm_split, AV1_TXFM_SPLIT, sizeof txfm_split);
    memcpy(inter_set1, AV1_INTER_TX_SET1, sizeof inter_set1);
    memcpy(inter_set2, AV1_INTER_TX_SET2[0], sizeof inter_set2);
    memcpy(inter_set3, AV1_INTER_TX_SET3, sizeof inter_set3);
    memcpy(mv_joint, AV1_MV_JOINT[0], sizeof mv_joint);
    for (int c = 0; c < 2; c++) {
      memcpy(mv_class[c], AV1_MV_CLASS[0], sizeof mv_class[c]);
      memcpy(mv_sign[c], AV1_MV_SIGN[0], sizeof mv_sign[c]);
      memcpy(mv_class0[c], AV1_MV_CLASS0[0], sizeof mv_class0[c]);
      memcpy(mv_bits[c], AV1_MV_BITS, sizeof mv_bits[c]);
    }
  }
};

// ---------------------------------------------------------------------------
// the symbol decoder (spec §8.2)
// ---------------------------------------------------------------------------
struct SymbolDecoder {
  const uint8_t* buf = nullptr;
  size_t size = 0;      // bytes of the tile
  size_t bitpos = 0;    // bits read
  uint32_t value = 0, range = 0;
  int max_bits = 0;
  bool adapt = true;

  uint32_t read_bits(int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; i++) {
      size_t byte = bitpos >> 3;
      uint32_t b = byte < size ? (buf[byte] >> (7 - (bitpos & 7))) & 1 : 0;
      x = 2 * x + b;
      bitpos++;
    }
    return x;
  }
  void init(const uint8_t* data, size_t sz, bool disable_update) {
    buf = data;
    size = sz;
    bitpos = 0;
    int num_bits = (int)std::min<size_t>(sz * 8, 15);
    uint32_t b = read_bits(num_bits);
    uint32_t padded = b << (15 - num_bits);
    value = ((1u << 15) - 1) ^ padded;
    range = 1u << 15;
    max_bits = (int)(8 * sz) - 15;
    adapt = !disable_update;
  }
  // icdf: n - 1 inverted values, 0, then the counter at icdf[n]
  int read(uint16_t* icdf, int n) {
    uint32_t cur = range, prev;
    int symbol = -1;
    do {
      symbol++;
      prev = cur;
      uint32_t f = icdf[symbol];
      cur = ((range >> 8) * (f >> 6) >> 1) + 4 * (uint32_t)(n - symbol - 1);
    } while (value < cur);
    range = prev - cur;
    value -= cur;
    int bits = 15 - floorlog2(range);
    range <<= bits;
    int num_bits = imin(bits, imax(0, max_bits));
    uint32_t nd = read_bits(num_bits);
    uint32_t padded = nd << (bits - num_bits);
    value = padded ^ (((value + 1) << bits) - 1);
    max_bits -= bits;
    if (adapt) {
      int rate = 3 + (icdf[n] > 15) + (icdf[n] > 31) + imin(floorlog2((uint32_t)n), 2);
      uint32_t tmp = 32768;
      for (int i = 0; i < n - 1; i++) {
        if (i == symbol) tmp = 0;
        if (tmp < icdf[i]) icdf[i] -= (uint16_t)((icdf[i] - tmp) >> rate);
        else icdf[i] += (uint16_t)((tmp - icdf[i]) >> rate);
      }
      icdf[n] += (icdf[n] < 32);
    }
    return symbol;
  }
  int read_bool() {
    uint16_t c[3] = {16384, 0, 0};
    bool a = adapt;
    adapt = false;
    int s = read(c, 2);
    adapt = a;
    return s;
  }
  int literal(int n) {
    int x = 0;
    for (int i = 0; i < n; i++) x = 2 * x + read_bool();
    return x;
  }
  // the exit process: the tile's padding must be its trailing bits
  void exit() {
    if (max_bits < -14) throw NotYet("tile data that ends before its symbols", true);
    int64_t trailing = (int64_t)8 * (int64_t)size - 15 - max_bits;
    if (trailing < 0 || trailing >= (int64_t)size * 8)
      throw NotYet("tile data that does not end in the spec's trailing bits", true);
    for (int64_t p = trailing; p < (int64_t)size * 8; p++) {
      int b = (buf[p >> 3] >> (7 - (p & 7))) & 1;
      if (b != (p == trailing ? 1 : 0))
        throw NotYet("tile data that does not end in the spec's trailing bits", true);
    }
  }
};

// ---------------------------------------------------------------------------
// the inverse transforms (spec §7.13.2)
// ---------------------------------------------------------------------------
int cos128(int angle) {
  int a = angle & 255;
  auto lut = [](int i) { return i == 64 ? 0 : AV1_COSPI[i]; };
  if (a <= 64) return lut(a);
  if (a <= 128) return -lut(128 - a);
  if (a <= 192) return -lut(a - 128);
  return lut(256 - a);
}
int sin128(int angle) { return cos128(angle - 64); }
int brev(int n, int x) {
  int r = 0;
  for (int i = 0; i < n; i++) if (x & (1 << i)) r |= 1 << (n - 1 - i);
  return r;
}

struct Tx1D {
  int32_t* T;
  // the range AV1 §7.13.3 requires of every value a pass stores in T (8 +
  // BitDepth signed bits in the row transforms, Max(BitDepth + 6, 16) in
  // the column ones) and of the ADST4's s and x arrays (8 + BitDepth + 12,
  // §7.13.2.6); `oob` gathers, without a branch, whether a store left it
  int64_t lo = INT32_MIN, hi = INT32_MAX, s_lo = INT64_MIN / 2, s_hi = INT64_MAX / 2;
  uint32_t oob = 0;
  void set_range(int bits, int bit_depth) {
    lo = -(int64_t{1} << (bits - 1));
    hi = (int64_t{1} << (bits - 1)) - 1;
    s_lo = -(int64_t{1} << (bit_depth + 19));
    s_hi = (int64_t{1} << (bit_depth + 19)) - 1;
  }
  int32_t put(int64_t v) {
    oob |= (uint64_t)(v - lo) > (uint64_t)(hi - lo);
    return (int32_t)v;
  }
  int64_t put_s(int64_t v) {
    oob |= (uint64_t)(v - s_lo) > (uint64_t)(s_hi - s_lo);
    return v;
  }
  void B(int a, int b, int angle, int flip) {
    int64_t x = (int64_t)T[a] * cos128(angle) - (int64_t)T[b] * sin128(angle);
    int64_t y = (int64_t)T[a] * sin128(angle) + (int64_t)T[b] * cos128(angle);
    T[a] = put(round2l(x, 12));
    T[b] = put(round2l(y, 12));
    if (flip) std::swap(T[a], T[b]);
  }
  void H(int a, int b, int flip) {
    if (flip) std::swap(a, b);
    int64_t x = T[a], y = T[b];
    T[a] = put(x + y);
    T[b] = put(x - y);
  }
  void dct_permute(int n) {
    int32_t c[64];
    int n0 = 1 << n;
    memcpy(c, T, sizeof(int32_t) * n0);
    for (int i = 0; i < n0; i++) T[i] = c[brev(n, i)];
  }
  // libaom's inverse DCT (av1_inv_txfm1d.c), stage for stage: the even
  // half is the DCT of half the size, the odd half a rotation stage, then
  // adds and rotations at doubling group sizes, then the merge
  int32_t half_btf(int w0, int32_t a, int w1, int32_t b) {
    return put(round2l((int64_t)w0 * a + (int64_t)w1 * b, 12));
  }
  static int cospi(int i) { return i == 64 ? 0 : AV1_COSPI[i]; }
  void dct_rec(int32_t* t, int N) {
    if (N == 2) {
      int32_t a = t[0], b = t[1];
      t[0] = half_btf(cospi(32), a, cospi(32), b);
      t[1] = half_btf(cospi(32), a, -cospi(32), b);
      return;
    }
    dct_rec(t, N / 2);
    dct_odd(t + N / 2, N / 2, N);
    for (int i = 0; i < N / 2; i++) {
      int64_t a = t[i], b = t[N - 1 - i];
      t[i] = put(a + b);
      t[N - 1 - i] = put(a - b);
    }
  }
  void dct_odd(int32_t* o, int M, int N) {
    int lm = floorlog2((uint32_t)M);
    for (int i = 0; i < M / 2; i++) {
      int th = 64 - 64 / N - (256 / N) * brev(lm - 1, i);
      int32_t p = o[i], q = o[M - 1 - i];
      o[i] = half_btf(cospi(th), p, -cospi(64 - th), q);
      o[M - 1 - i] = half_btf(cospi(64 - th), p, cospi(th), q);
    }
    for (int g = 2; g <= M / 2; g *= 2) {
      for (int b0 = 0; b0 < M; b0 += g) {
        bool odd = (b0 / g) & 1;
        for (int k = 0; k < g / 2; k++) {
          int64_t p = o[b0 + k], q = o[b0 + g - 1 - k];
          if (!odd) {
            o[b0 + k] = put(p + q);
            o[b0 + g - 1 - k] = put(p - q);
          } else {
            o[b0 + k] = put(q - p);
            o[b0 + g - 1 - k] = put(p + q);
          }
        }
      }
      auto rot_x = [&](int p, int th) {
        int32_t a = o[p], b = o[M - 1 - p];
        o[p] = half_btf(-cospi(64 - th), a, cospi(th), b);
        o[M - 1 - p] = half_btf(cospi(th), a, cospi(64 - th), b);
      };
      auto rot_y = [&](int p, int th) {
        int32_t a = o[p], b = o[M - 1 - p];
        o[p] = half_btf(-cospi(th), a, -cospi(64 - th), b);
        o[M - 1 - p] = half_btf(-cospi(64 - th), a, cospi(th), b);
      };
      if (g < M / 2) {
        int np = N / (2 * g);
        int lq = floorlog2((uint32_t)(np / 4));
        for (int j = 0; j < M / (4 * g); j++) {
          int th = 64 - 64 / np - (256 / np) * brev(lq, j);
          int b0 = 2 * g * j;
          for (int p = b0 + g / 2; p < b0 + g; p++) rot_x(p, th);
          for (int p = b0 + g; p < b0 + 3 * g / 2; p++) rot_y(p, th);
        }
      } else {
        for (int p = g / 2; p < g; p++) rot_x(p, 32);
      }
    }
  }
  void dct(int n) {
    dct_permute(n);
    dct_rec(T, 1 << n);
  }
  void adst_in_permute(int n) {
    int32_t c[16];
    int n0 = 1 << n;
    memcpy(c, T, sizeof(int32_t) * n0);
    for (int i = 0; i < n0; i++) T[i] = c[(i & 1) ? (i - 1) : (n0 - i - 1)];
  }
  void adst_out_permute(int n) {
    int32_t c[16];
    int n0 = 1 << n;
    memcpy(c, T, sizeof(int32_t) * n0);
    for (int i = 0; i < n0; i++) {
      int a = (i >> 3) & 1;
      int b = ((i >> 2) & 1) ^ ((i >> 3) & 1);
      int cc = ((i >> 1) & 1) ^ ((i >> 2) & 1);
      int d = (i & 1) ^ ((i >> 1) & 1);
      int idx = ((d << 3) | (cc << 2) | (b << 1) | a) >> (4 - n);
      T[i] = (i & 1) ? -c[idx] : c[idx];
    }
  }
  void adst4() {
    const int64_t s19 = AV1_SINPI[1], s29 = AV1_SINPI[2], s39 = AV1_SINPI[3], s49 = AV1_SINPI[4];
    int64_t x0 = T[0], x1 = T[1], x2 = T[2], x3 = T[3];
    int64_t s0 = put_s(s19 * x0), s1 = put_s(s29 * x0), s2 = put_s(s39 * x1), s3 = put_s(s49 * x2);
    int64_t s4 = put_s(s19 * x2), s5 = put_s(s29 * x3), s6 = put_s(s49 * x3);
    int64_t a7 = x0 - x2;
    int64_t b7 = a7 + x3;
    s0 = put_s(s0 + s3);
    s1 = put_s(s1 - s4);
    s3 = s2;
    s2 = put_s(s39 * b7);
    s0 = put_s(s0 + s5);
    s1 = put_s(s1 - s6);
    x0 = put_s(s0 + s3);
    x1 = put_s(s1 + s3);
    x2 = s2;
    x3 = put_s(s0 + s1);
    x3 = put_s(x3 - s3);
    T[0] = put(round2l(x0, 12));
    T[1] = put(round2l(x1, 12));
    T[2] = put(round2l(x2, 12));
    T[3] = put(round2l(x3, 12));
  }
  void adst8() {
    adst_in_permute(3);
    for (int i = 0; i < 4; i++) B(2 * i, 2 * i + 1, 60 - 16 * i, 1);
    for (int i = 0; i < 4; i++) H(i, 4 + i, 0);
    for (int i = 0; i < 2; i++) B(4 + 3 * i, 5 + i, 48 - 32 * i, 1);
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++) H(4 * j + i, 2 + 4 * j + i, 0);
    for (int i = 0; i < 2; i++) B(2 + 4 * i, 3 + 4 * i, 32, 1);
    adst_out_permute(3);
  }
  void adst16() {
    adst_in_permute(4);
    for (int i = 0; i < 8; i++) B(2 * i, 2 * i + 1, 62 - 8 * i, 1);
    for (int i = 0; i < 8; i++) H(i, 8 + i, 0);
    for (int i = 0; i < 2; i++) {
      B(8 + 2 * i, 9 + 2 * i, 56 - 32 * i, 1);
      B(13 + 2 * i, 12 + 2 * i, 8 + 32 * i, 1);
    }
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 2; j++) H(8 * j + i, 4 + 8 * j + i, 0);
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++) B(4 + 8 * j + 3 * i, 5 + 8 * j + i, 48 - 32 * i, 1);
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 4; j++) H(4 * j + i, 2 + 4 * j + i, 0);
    for (int i = 0; i < 4; i++) B(2 + 4 * i, 3 + 4 * i, 32, 1);
    adst_out_permute(4);
  }
  void identity(int n) {
    int n0 = 1 << n;
    for (int i = 0; i < n0; i++) {
      int64_t t = T[i];
      if (n == 2) T[i] = put(round2l(t * 5793, 12));
      else if (n == 3) T[i] = put(t * 2);
      else if (n == 4) T[i] = put(round2l(t * 11586, 12));
      else T[i] = put(t * 4);
    }
  }
  void wht(int shift) {
    int64_t a = T[0] >> shift, c = T[1] >> shift, d = T[2] >> shift, b = T[3] >> shift;
    a += c;
    d -= b;
    int64_t e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    T[0] = put(a);
    T[1] = put(b);
    T[2] = put(c);
    T[3] = put(d);
  }
  // 1-D inverse of kind 0 DCT, 1 ADST, 2 FLIPADST, 3 identity
  void run(int kind, int n) {
    if (kind == 0) dct(n);
    else if (kind == 3) identity(n);
    else {
      if (n == 2) adst4();
      else if (n == 3) adst8();
      else adst16();
      if (kind == 2) std::reverse(T, T + (1 << n));
    }
  }
};

// vertical (column) and horizontal (row) 1-D kinds of each tx type
const int kVertKind[16] = {0, 1, 0, 1, 2, 0, 2, 1, 2, 3, 0, 3, 1, 3, 2, 3};
const int kHorzKind[16] = {0, 0, 1, 1, 0, 2, 2, 2, 1, 3, 3, 0, 3, 1, 3, 2};

// f(r0, r1) over the rows [0, n), in bands of at least 64 rows on up to
// `threads` threads
template <typename F>
void in_bands(int n, int threads, F f) {
  const int k = std::max(1, std::min(threads, n / 64));
  std::vector<std::thread> pool;
  for (int i = 1; i < k; i++)
    pool.emplace_back(f, (int)((int64_t)n * i / k), (int)((int64_t)n * (i + 1) / k));
  f(0, n / k);
  for (std::thread& t : pool) t.join();
}

// ---------------------------------------------------------------------------
// the decoder
// ---------------------------------------------------------------------------
// a plane of samples of any depth (8, 10 or 12 bits), 16 bits each
typedef uint16_t pixel;
struct Plane {
  int w = 0, h = 0, stride = 0;
  std::vector<pixel> px;
  pixel* at(int y, int x) { return &px[(size_t)y * stride + x]; }
};

struct Decoder {
  // sequence header
  bool have_seq = false;
  int profile = 0, still = 0, reduced = 0;
  int frame_width_bits = 0, frame_height_bits = 0, max_w = 0, max_h = 0;
  int frame_id_numbers_present = 0, delta_frame_id_len = 0, frame_id_len = 0;
  int use_128 = 0, enable_filter_intra = 0, enable_intra_edge_filter = 0;
  int enable_order_hint = 0, order_hint_bits = 0;
  int seq_force_screen_content_tools = 2, seq_force_integer_mv = 2;
  int enable_superres = 0, enable_cdef = 0, enable_restoration = 0;
  int bit_depth = 8, mono = 0, color_range = 0, ssx = 1, ssy = 1;
  int matrix = 2, primaries = 2, transfer = 2, separate_uv_delta_q = 0;
  int film_grain_present = 0;
  int timing_info_present = 0, decoder_model_info_present = 0;
  int equal_picture_interval = 0, buffer_delay_len = 0, buffer_removal_time_len = 0;
  int frame_presentation_time_len = 0;
  int op_count = 1;
  int op_idc[32] = {0};
  int decoder_model_present_for_op[32] = {0};

  // frame header
  bool frame_done = false, have_frame_header = false;
  // frame_w: the coded width while the frame decodes, the upscaled width
  // once loop_filters() has upscaled it (superres: coded_w and
  // UpscaledWidth, and SuperresDenom over 8; 8 where superres is off)
  int frame_w = 0, frame_h = 0, mi_cols = 0, mi_rows = 0;
  int coded_w = 0, upscaled_w = 0, superres_denom = 8;
  int show_frame = 1, disable_cdf_update = 0, allow_screen_content_tools = 0;
  int allow_intrabc = 0;
  int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0;
  std::vector<int> mi_col_starts, mi_row_starts;
  int tile_size_bytes = 4;
  int base_q_idx = 0, dq_y_dc = 0, dq_u_dc = 0, dq_u_ac = 0, dq_v_dc = 0, dq_v_ac = 0;
  int qm_level[3] = {15, 15, 15};  // 15: no matrix
  int seg_enabled = 0;
  int feature_enabled[8][8] = {{0}}, feature_data[8][8] = {{0}};
  int seg_id_pre_skip = 0, last_active_seg_id = 0;
  int delta_q_present = 0, delta_q_res = 0, delta_lf_present = 0,
      delta_lf_res = 0, delta_lf_multi = 0;
  int coded_lossless = 0, lossless_array[8] = {0};
  int lf_level[4] = {0}, lf_sharpness = 0, lf_delta_enabled = 0;
  int lf_ref_deltas[8] = {0};
  int cdef_bits = 0, cdef_damping = 3;
  int cdef_strengths[8][2][2] = {{{0}}};  // [idx][luma, chroma][primary, secondary]
  int lr_type[3] = {0}, lr_size[3] = {0}, uses_lr = 0;
  int tx_mode_select = 0, only_4x4 = 0, reduced_tx_set = 0;
  // film grain: the scaling points, AR coefficients and mixing of planes
  // Y, Cb, Cr (spec's point_*_value / _scaling, ar_coeffs_*_plus_128 less
  // 128, *_mult and *_luma_mult less 128, *_offset less 256)
  struct FilmGrain {
    int apply = 0, seed = 0, cfl = 0, overlap = 0, clip = 0;
    int num[3] = {0}, points[3][14][2] = {{{0}}};
    int scaling_shift = 8, ar_lag = 0, ar_shift = 6, grain_scale_shift = 0;
    int ar[3][25] = {{0}}, mult[3] = {0}, luma_mult[3] = {0}, offset[3] = {0};
  } fg;
  int next_tile = 0;  // tiles decoded so far
  int threads = 1;  // for the upscaling, which runs row by row

  Cdfs frame_cdfs, cdf;
  SymbolDecoder sd;
  Plane planes[3];

  // per 4x4 (mi) state over the frame
  // tx_sizes: the spec's InterTxSizes (an intra block's TxSize over it)
  std::vector<uint8_t> y_modes, uv_modes, skips, tx_sizes, mi_sizes, seg_ids;
  // intra block copy: which mi are intrabc blocks, their DVs (row, column
  // in 1/8 samples), and which mi this frame has decoded
  std::vector<uint8_t> is_inters, decoded;
  std::vector<int16_t> mvs;
  std::vector<uint8_t> tx_types;
  std::vector<int8_t> delta_lfs;  // DeltaLF[0..3] of each mi
  std::vector<uint8_t> lf_tx_sizes[3];  // in 4x4 units of each plane
  int mi_stride = 0;
  // the restoration units of each plane and the references of their coding
  struct LrUnit {
    int type = RESTORE_NONE, sgr_set = 0;
    int wiener[2][3] = {{0}};  // [vertical, horizontal][tap]
    int xqd[2] = {0};
  };
  std::vector<LrUnit> lr_units[3];
  int lr_rows[3] = {0}, lr_cols[3] = {0};
  int ref_wiener[3][2][3], ref_xqd[3][2];
  std::vector<int8_t> cdef_idx;
  int cdef_stride = 0;
  // the palettes of the blocks above and left of each mi column / row
  // (spec's PaletteSizes and PaletteColors of planes Y and U): a size,
  // then 8 colours
  std::vector<pixel> pal_above[2], pal_left[2];
  // coefficient contexts, in 4x4 units of each plane
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];

  // tile
  int mi_row_start = 0, mi_row_end = 0, mi_col_start = 0, mi_col_end = 0;
  int current_q_index = 0;
  int delta_lf[4] = {0};
  bool read_deltas = false;
  uint8_t block_decoded[3][34][34];

  // block
  int mi_row = 0, mi_col = 0, mi_size = 0, has_chroma = 0;
  int avail_u = 0, avail_l = 0, avail_u_chroma = 0, avail_l_chroma = 0;
  int segment_id = 0, skip = 0, lossless = 0;
  int y_mode = 0, uv_mode = 0, angle_delta_y = 0, angle_delta_uv = 0;
  int cfl_alpha_u = 0, cfl_alpha_v = 0, use_filter_intra = 0, filter_intra_mode = 0;
  int use_intrabc = 0, dv[2] = {0, 0};
  int pal_size[2] = {0};      // PaletteSizeY, PaletteSizeUV
  pixel pal[3][8];            // palette_colors_y, _u, _v
  uint8_t color_map[2][64][64];  // ColorMapY, ColorMapUV
  int tx_sz = 0;
  int max_luma_w = 0, max_luma_h = 0;
  int plane_tx_type = 0;
  int32_t quant[1024];

  int idx(int r, int c) const { return r * mi_stride + c; }
  // the spec's Clip1 at BitDepth
  int pixel_max() const { return (1 << bit_depth) - 1; }
  pixel clip1(int v) const { return (pixel)clip3(0, pixel_max(), v); }
  int num_planes() const { return mono ? 1 : 3; }

  // ---------------------------------------------------------------- OBUs
  const uint8_t* data_start = nullptr;  // the data decode() was given
  int64_t clip_bit = -1;  // clip_to_restricted_range's bit in it (-1: none)
  int64_t q_bit = -1;     // base_q_idx's first bit in it
  void decode(const uint8_t* data, size_t size) {
    data_start = data;
    size_t pos = 0;
    while (pos < size) {
      Bits h(data + pos, size - pos);
      h.bit();  // obu_forbidden_bit: dav1d ignores it
      int type = (int)h.f(4);
      int ext = (int)h.bit();
      int has_size = (int)h.bit();
      h.bit();
      int temporal_id = 0, spatial_id = 0;
      if (ext) {
        temporal_id = (int)h.f(3);
        spatial_id = (int)h.f(2);
        h.f(3);
      }
      size_t hdr = 1 + ext;
      uint64_t obu_size;
      if (has_size) {
        obu_size = 0;
        int i = 0;
        for (;; i++) {
          if (i == 8) throw Invalid("OBU size overflows");
          if (hdr + i >= size - pos) throw Invalid("OBU header runs past the data");
          uint8_t b = data[pos + hdr + i];
          obu_size |= (uint64_t)(b & 0x7F) << (7 * i);
          if (!(b & 0x80)) break;
        }
        hdr += i + 1;
      } else {
        obu_size = size - pos - hdr;
      }
      if (obu_size > size - pos - hdr) throw Invalid("OBU runs past the data");
      const uint8_t* payload = data + pos + hdr;
      pos += hdr + obu_size;
      if (type != 1 && type != 2 && ext && have_seq && op_idc[0]) {
        int in_t = (op_idc[0] >> temporal_id) & 1;
        int in_s = (op_idc[0] >> (spatial_id + 8)) & 1;
        if (!in_t || !in_s) continue;
      }
      switch (type) {
        case 1:
          sequence_header(payload, obu_size);
          seq_obu = payload;
          seq_obu_size = obu_size;
          break;
        case 2: have_frame_header = false; break;
        case 3: case 7: {
          if (!have_seq) throw Invalid("frame header before the sequence header");
          if (have_frame_header) break;  // a redundant copy
          if (type == 7) throw Invalid("redundant frame header without a frame header");
          if (frame_done) throw NotYet("stream with more than one frame");
          Bits b(payload, obu_size);
          frame_header(b);
          break;
        }
        case 6: {
          if (!have_seq) throw Invalid("frame before the sequence header");
          if (frame_done || have_frame_header) throw NotYet("stream with more than one frame");
          Bits b(payload, obu_size);
          frame_header(b);
          b.byte_align();
          size_t off = b.pos / 8;
          tile_group(payload + off, obu_size - off);
          break;
        }
        case 4:
          if (!have_frame_header) throw Invalid("tile group without a frame header");
          tile_group(payload, obu_size);
          break;
        default: break;  // metadata, tile list, padding, reserved
      }
      if (frame_done) {
        if (pos < size) after_frame(data + pos, size - pos);
        return;
      }
    }
    if (!frame_done && !after) throw Invalid("no complete frame in the data");
  }

  // dav1d parses the OBUs after the frame in the same data too, and their
  // errors fail the decode, though the picture it gives is the first
  // frame's (a frame cut short after it fails; a whole one, or sequence
  // headers, temporal delimiters and padding, do not): they are decoded
  // as a stream of their own after the last sequence header, which may
  // hold no frame, and dropped
  const uint8_t* seq_obu = nullptr;
  size_t seq_obu_size = 0;
  bool after = false;  // decoding the OBUs after another decoder's frame
  void after_frame(const uint8_t* data, size_t size) {
    auto rest = std::make_unique<Decoder>();
    rest->after = true;
    rest->start_from(seq_obu, seq_obu_size);
    rest->decode(data, size);
  }
  // the state a sequence header OBU's payload leaves, as if decoded before
  void start_from(const uint8_t* sh, size_t n) {
    sequence_header(sh, n);
    seq_obu = sh;
    seq_obu_size = n;
  }

  // ------------------------------------------------------ sequence header
  void sequence_header(const uint8_t* p, size_t n) {
    Bits b(p, n);
    profile = (int)b.f(3);
    if (profile > 2) throw Invalid("sequence header profile above 2");
    still = (int)b.bit();
    reduced = (int)b.bit();
    if (reduced) {
      if (!still) throw Invalid("reduced sequence header of a moving picture");
      op_count = 1;
      op_idc[0] = 0;
      b.f(5);
      timing_info_present = decoder_model_info_present = 0;
    } else {
      timing_info_present = (int)b.bit();
      if (timing_info_present) {
        b.f(32);
        b.f(32);
        equal_picture_interval = (int)b.bit();
        if (equal_picture_interval && b.uvlc() == 0xFFFFFFFFu)
          throw Invalid("sequence header num_ticks_per_picture out of range");
        decoder_model_info_present = (int)b.bit();
        if (decoder_model_info_present) {
          buffer_delay_len = (int)b.f(5) + 1;
          b.f(32);
          buffer_removal_time_len = (int)b.f(5) + 1;
          frame_presentation_time_len = (int)b.f(5) + 1;
        }
      } else {
        decoder_model_info_present = 0;
      }
      int initial_display_delay_present = (int)b.bit();
      op_count = (int)b.f(5) + 1;
      for (int i = 0; i < op_count; i++) {
        op_idc[i] = (int)b.f(12);
        // dav1d refuses an operating point with no temporal or no spatial layer
        if (op_idc[i] && (!(op_idc[i] & 0xFF) || !(op_idc[i] & 0xF00)))
          throw Invalid("sequence header operating point without layers");
        int level = (int)b.f(5);
        if (level > 7) b.bit();
        decoder_model_present_for_op[i] = 0;
        if (decoder_model_info_present) {
          decoder_model_present_for_op[i] = (int)b.bit();
          if (decoder_model_present_for_op[i]) {
            b.f(buffer_delay_len);
            b.f(buffer_delay_len);
            b.bit();
          }
        }
        if (initial_display_delay_present) {
          if (b.bit()) b.f(4);
        }
      }
    }
    frame_width_bits = (int)b.f(4) + 1;
    frame_height_bits = (int)b.f(4) + 1;
    max_w = (int)b.f(frame_width_bits) + 1;
    max_h = (int)b.f(frame_height_bits) + 1;
    frame_id_numbers_present = reduced ? 0 : (int)b.bit();
    if (frame_id_numbers_present) {
      delta_frame_id_len = (int)b.f(4) + 2;
      frame_id_len = (int)b.f(3) + delta_frame_id_len + 1;
    }
    use_128 = (int)b.bit();
    enable_filter_intra = (int)b.bit();
    enable_intra_edge_filter = (int)b.bit();
    if (reduced) {
      enable_order_hint = 0;
      order_hint_bits = 0;
      seq_force_screen_content_tools = 2;
      seq_force_integer_mv = 2;
    } else {
      b.f(4);  // interintra, masked, warped, dual filter
      enable_order_hint = (int)b.bit();
      if (enable_order_hint) b.f(2);  // jnt comp, ref frame mvs
      int choose_sct = (int)b.bit();
      seq_force_screen_content_tools = choose_sct ? 2 : (int)b.bit();
      if (seq_force_screen_content_tools > 0) {
        int choose_imv = (int)b.bit();
        seq_force_integer_mv = choose_imv ? 2 : (int)b.bit();
      } else {
        seq_force_integer_mv = 2;
      }
      order_hint_bits = enable_order_hint ? (int)b.f(3) + 1 : 0;
    }
    enable_superres = (int)b.bit();
    enable_cdef = (int)b.bit();
    enable_restoration = (int)b.bit();
    // color_config
    int high_bitdepth = (int)b.bit();
    if (profile == 2 && high_bitdepth) bit_depth = b.bit() ? 12 : 10;
    else bit_depth = high_bitdepth ? 10 : 8;
    mono = profile == 1 ? 0 : (int)b.bit();
    if (b.bit()) {
      primaries = (int)b.f(8);
      transfer = (int)b.f(8);
      matrix = (int)b.f(8);
    } else {
      primaries = transfer = matrix = 2;
    }
    if (mono) {
      color_range = (int)b.bit();
      ssx = ssy = 1;
      separate_uv_delta_q = 0;
    } else {
      if (primaries == 1 && transfer == 13 && matrix == 0) {
        color_range = 1;
        ssx = ssy = 0;
      } else {
        color_range = (int)b.bit();
        if (profile == 0) ssx = ssy = 1;
        else if (profile == 1) ssx = ssy = 0;
        else if (bit_depth == 12) {
          ssx = (int)b.bit();
          ssy = ssx ? (int)b.bit() : 0;
        } else {
          ssx = 1;
          ssy = 0;
        }
        if (ssx && ssy) b.f(2);
      }
      separate_uv_delta_q = (int)b.bit();
    }
    film_grain_present = (int)b.bit();
    have_seq = true;
  }

  // --------------------------------------------------------- frame header
  int get_qidx(int ignore_delta_q, int seg) {
    if (seg_enabled && feature_enabled[seg][0]) {
      int q = base_q_idx + feature_data[seg][0];
      if (!ignore_delta_q && delta_q_present) q = current_q_index + feature_data[seg][0];
      return clip3(0, 255, q);
    }
    if (!ignore_delta_q && delta_q_present) return current_q_index;
    return base_q_idx;
  }

  static int tile_log2(int blk, int target) {
    int k = 0;
    while ((blk << k) < target) k++;
    return k;
  }

  int read_delta_q(Bits& b) { return b.bit() ? b.su(7) : 0; }

  void frame_header(Bits& b) {
    show_frame = 1;
    if (!reduced) {
      if (b.bit()) throw NotYet("show_existing_frame");
      int frame_type = (int)b.f(2);
      show_frame = (int)b.bit();
      if (frame_type != 0) throw NotYet("inter or intra-only frame");
      if (!show_frame) throw NotYet("key frame that is not shown");
      if (decoder_model_info_present && !equal_picture_interval)
        b.f(frame_presentation_time_len);
    }
    disable_cdf_update = (int)b.bit();
    allow_screen_content_tools = seq_force_screen_content_tools == 2
                                     ? (int)b.bit() : seq_force_screen_content_tools;
    if (allow_screen_content_tools && seq_force_integer_mv == 2) b.bit();
    if (frame_id_numbers_present) b.f(frame_id_len);
    int frame_size_override = reduced ? 0 : (int)b.bit();
    b.f(order_hint_bits);
    // primary_ref_frame = NONE on a key frame
    if (decoder_model_info_present) {
      if (b.bit()) {
        for (int op = 0; op < op_count; op++) {
          if (decoder_model_present_for_op[op]) {
            // the frame's layer ids are 0 (no extension on a still image)
            int idc = op_idc[op];
            if (idc == 0 || ((idc & 1) && ((idc >> 8) & 1))) b.f(buffer_removal_time_len);
          }
        }
      }
    }
    // refresh_frame_flags: all frames for a shown key frame
    // frame_size
    if (frame_size_override) {
      frame_w = (int)b.f(frame_width_bits) + 1;
      frame_h = (int)b.f(frame_height_bits) + 1;
    } else {
      frame_w = max_w;
      frame_h = max_h;
    }
    // dav1d's frame_size_limit, which libavif sets to its image size
    // limit, refuses a larger frame before any plane is allocated for it
    if ((int64_t)frame_w * frame_h > kImageSizeLimit) throw Invalid("frame past the size limit");
    // superres_params: the frame is coded at 8 / SuperresDenom of its
    // width, but (as dav1d computes it) never narrower than 16 or than
    // the frame
    upscaled_w = frame_w;
    superres_denom = 8;
    const int use_superres = enable_superres ? (int)b.bit() : 0;
    if (use_superres) {
      superres_denom = (int)b.f(3) + 9;
      frame_w = imax((upscaled_w * 8 + superres_denom / 2) / superres_denom, imin(16, upscaled_w));
    }
    coded_w = frame_w;
    mi_cols = 2 * ((frame_w + 7) >> 3);
    mi_rows = 2 * ((frame_h + 7) >> 3);
    if (b.bit()) b.f(32);  // render size
    // allow_intrabc where superres is off, as dav1d reads it (the spec,
    // and libaom, where superres leaves the width as it is: dav1d then
    // reads the rest from the wrong bit, and so does the port, whose tile
    // data no longer ends in its trailing bits)
    allow_intrabc = 0;
    if (allow_screen_content_tools && !use_superres) allow_intrabc = (int)b.bit();
    // disable_frame_end_update_cdf
    if (!reduced && !disable_cdf_update) b.bit();
    tile_info(b);
    // quantization_params
    q_bit = (int64_t)(b.p - data_start) * 8 + (int64_t)b.pos;
    base_q_idx = (int)b.f(8);
    dq_y_dc = read_delta_q(b);
    int diff_uv = 0;
    if (!mono) {
      if (separate_uv_delta_q) diff_uv = (int)b.bit();
      dq_u_dc = read_delta_q(b);
      dq_u_ac = read_delta_q(b);
      if (diff_uv) {
        dq_v_dc = read_delta_q(b);
        dq_v_ac = read_delta_q(b);
      } else {
        dq_v_dc = dq_u_dc;
        dq_v_ac = dq_u_ac;
      }
    }
    // using_qmatrix: the levels of the three planes (a lossless segment
    // takes the flat level 15, which its Walsh-Hadamard blocks skip anyway)
    qm_level[0] = qm_level[1] = qm_level[2] = 15;
    if (b.bit()) {
      qm_level[0] = (int)b.f(4);
      qm_level[1] = (int)b.f(4);
      qm_level[2] = separate_uv_delta_q ? (int)b.f(4) : qm_level[1];
    }
    // segmentation_params
    seg_enabled = (int)b.bit();
    memset(feature_enabled, 0, sizeof feature_enabled);
    memset(feature_data, 0, sizeof feature_data);
    if (seg_enabled) {
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
          int v = 0;
          feature_enabled[i][j] = (int)b.bit();
          if (feature_enabled[i][j]) {
            int bits = kSegFeatureBits[j], lim = kSegFeatureMax[j];
            if (kSegFeatureSigned[j]) v = clip3(-lim, lim, b.su(1 + bits));
            else v = clip3(0, lim, (int)b.f(bits));
          }
          feature_data[i][j] = v;
        }
    }
    seg_id_pre_skip = 0;
    last_active_seg_id = 0;
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++)
        if (feature_enabled[i][j]) {
          last_active_seg_id = i;
          if (j >= 5) seg_id_pre_skip = 1;
        }
    // delta_q_params / delta_lf_params
    delta_q_res = delta_q_present = 0;
    if (base_q_idx > 0) delta_q_present = (int)b.bit();
    if (delta_q_present) delta_q_res = (int)b.f(2);
    delta_lf_present = delta_lf_res = delta_lf_multi = 0;
    if (delta_q_present) {
      if (!allow_intrabc) delta_lf_present = (int)b.bit();
      if (delta_lf_present) {
        delta_lf_res = (int)b.f(2);
        delta_lf_multi = (int)b.bit();
      }
    }
    coded_lossless = 1;
    for (int s = 0; s < 8; s++) {
      int q = get_qidx(1, s);
      lossless_array[s] = q == 0 && dq_y_dc == 0 && dq_u_ac == 0 && dq_u_dc == 0 &&
                          dq_v_ac == 0 && dq_v_dc == 0;
      if (!lossless_array[s]) coded_lossless = 0;
    }
    // loop_filter_params, over the key frame's defaults
    memset(lf_level, 0, sizeof lf_level);
    lf_sharpness = lf_delta_enabled = 0;
    memcpy(lf_ref_deltas, kDefaultLfRefDeltas, sizeof lf_ref_deltas);
    if (!coded_lossless && !allow_intrabc) {
      lf_level[0] = (int)b.f(6);
      lf_level[1] = (int)b.f(6);
      if (!mono && (lf_level[0] || lf_level[1])) {
        lf_level[2] = (int)b.f(6);
        lf_level[3] = (int)b.f(6);
      }
      lf_sharpness = (int)b.f(3);
      lf_delta_enabled = (int)b.bit();
      if (lf_delta_enabled && b.bit()) {  // loop_filter_delta_update
        for (int i = 0; i < 8; i++) if (b.bit()) lf_ref_deltas[i] = b.su(7);
        for (int i = 0; i < 2; i++) if (b.bit()) b.su(7);  // mode deltas: inter only
      }
    }
    // cdef_params (a secondary strength of 3 means 4)
    cdef_bits = 0;
    cdef_damping = 3;
    memset(cdef_strengths, 0, sizeof cdef_strengths);
    if (!coded_lossless && !allow_intrabc && enable_cdef) {
      cdef_damping = (int)b.f(2) + 3;
      cdef_bits = (int)b.f(2);
      for (int i = 0; i < (1 << cdef_bits); i++)
        for (int p = 0; p < (mono ? 1 : 2); p++) {
          cdef_strengths[i][p][0] = (int)b.f(4);
          cdef_strengths[i][p][1] = (int)b.f(2);
          if (cdef_strengths[i][p][1] == 3) cdef_strengths[i][p][1] = 4;
        }
    }
    // lr_params (a lossless frame is restored where superres is on: the
    // spec's AllLossless, keyed as dav1d keys allow_intrabc)
    memset(lr_type, 0, sizeof lr_type);
    memset(lr_size, 0, sizeof lr_size);
    uses_lr = 0;
    if ((!coded_lossless || use_superres) && !allow_intrabc && enable_restoration) {
      int chroma_lr = 0;
      for (int i = 0; i < (mono ? 1 : 3); i++) {
        lr_type[i] = kRemapLrType[b.f(2)];
        if (lr_type[i] != RESTORE_NONE) {
          uses_lr = 1;
          if (i) chroma_lr = 1;
        }
      }
      if (uses_lr) {
        int shift = (int)b.bit();
        if (use_128) shift++;
        else if (shift) shift += (int)b.bit();
        lr_size[0] = 256 >> (2 - shift);
        int uv_shift = ssx && ssy && chroma_lr ? (int)b.bit() : 0;
        lr_size[1] = lr_size[2] = lr_size[0] >> uv_shift;
      }
    }
    // read_tx_mode
    only_4x4 = coded_lossless;
    tx_mode_select = coded_lossless ? 0 : (int)b.bit();
    // reference_select, skip_mode, warped motion: absent on an intra frame
    reduced_tx_set = (int)b.bit();
    fg = FilmGrain();
    if (film_grain_present && show_frame) film_grain_params(b);
    start_frame();
    have_frame_header = true;
  }

  // film_grain_params (update_grain is implied on a key frame), with
  // dav1d's checks of the points and of 4:2:0's chroma
  void film_grain_params(Bits& b) {
    fg.apply = (int)b.bit();
    if (!fg.apply) return;
    fg.seed = (int)b.f(16);
    auto points = [&](int n, int max, int (*pts)[2]) {
      if (n > max) throw Invalid("film grain with too many scaling points");
      for (int i = 0; i < n; i++) {
        pts[i][0] = (int)b.f(8);
        if (i && pts[i - 1][0] >= pts[i][0]) throw Invalid("film grain points out of order");
        pts[i][1] = (int)b.f(8);
      }
    };
    fg.num[0] = (int)b.f(4);
    points(fg.num[0], 14, fg.points[0]);
    fg.cfl = mono ? 0 : (int)b.bit();
    if (!(mono || fg.cfl || (ssx && ssy && !fg.num[0])))
      for (int p = 1; p < 3; p++) {
        fg.num[p] = (int)b.f(4);
        points(fg.num[p], 10, fg.points[p]);
      }
    if (ssx && ssy && !fg.num[1] != !fg.num[2])
      throw Invalid("film grain on one 4:2:0 chroma plane only");
    fg.scaling_shift = (int)b.f(2) + 8;
    fg.ar_lag = (int)b.f(2);
    int num_pos = 2 * fg.ar_lag * (fg.ar_lag + 1);
    if (fg.num[0])
      for (int i = 0; i < num_pos; i++) fg.ar[0][i] = (int)b.f(8) - 128;
    for (int p = 1; p < 3; p++)
      if (fg.num[p] || fg.cfl)
        for (int i = 0; i < num_pos + (fg.num[0] > 0); i++) fg.ar[p][i] = (int)b.f(8) - 128;
    fg.ar_shift = (int)b.f(2) + 6;
    fg.grain_scale_shift = (int)b.f(2);
    for (int p = 1; p < 3; p++)
      if (fg.num[p]) {
        fg.mult[p] = (int)b.f(8) - 128;
        fg.luma_mult[p] = (int)b.f(8) - 128;
        fg.offset[p] = (int)b.f(9) - 256;
      }
    fg.overlap = (int)b.bit();
    clip_bit = (int64_t)(b.p - data_start) * 8 + (int64_t)b.pos;
    fg.clip = (int)b.bit();
  }

  void tile_info(Bits& b) {
    int sb_cols = use_128 ? ((mi_cols + 31) >> 5) : ((mi_cols + 15) >> 4);
    int sb_rows = use_128 ? ((mi_rows + 31) >> 5) : ((mi_rows + 15) >> 4);
    int sb_shift = use_128 ? 5 : 4;
    int sb_size = sb_shift + 2;
    int max_tile_width_sb = 4096 >> sb_size;
    int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
    int min_log2_tile_cols = tile_log2(max_tile_width_sb, sb_cols);
    int max_log2_tile_cols = tile_log2(1, imin(sb_cols, 64));
    int max_log2_tile_rows = tile_log2(1, imin(sb_rows, 64));
    int min_log2_tiles = imax(min_log2_tile_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
    mi_col_starts.clear();
    mi_row_starts.clear();
    if (b.bit()) {  // uniform
      tile_cols_log2 = min_log2_tile_cols;
      while (tile_cols_log2 < max_log2_tile_cols && b.bit()) tile_cols_log2++;
      int tw = (sb_cols + (1 << tile_cols_log2) - 1) >> tile_cols_log2;
      for (int s = 0; s < sb_cols; s += tw) mi_col_starts.push_back(s << sb_shift);
      mi_col_starts.push_back(mi_cols);
      tile_cols = (int)mi_col_starts.size() - 1;
      int min_log2_tile_rows = imax(min_log2_tiles - tile_cols_log2, 0);
      tile_rows_log2 = min_log2_tile_rows;
      while (tile_rows_log2 < max_log2_tile_rows && b.bit()) tile_rows_log2++;
      int th = (sb_rows + (1 << tile_rows_log2) - 1) >> tile_rows_log2;
      for (int s = 0; s < sb_rows; s += th) mi_row_starts.push_back(s << sb_shift);
      mi_row_starts.push_back(mi_rows);
      tile_rows = (int)mi_row_starts.size() - 1;
    } else {
      int widest = 0, s = 0;
      while (s < sb_cols) {
        mi_col_starts.push_back(s << sb_shift);
        int maxw = imin(sb_cols - s, max_tile_width_sb);
        int size = (int)b.ns((uint32_t)maxw) + 1;
        widest = imax(size, widest);
        s += size;
      }
      mi_col_starts.push_back(mi_cols);
      tile_cols = (int)mi_col_starts.size() - 1;
      tile_cols_log2 = tile_log2(1, tile_cols);
      int area = min_log2_tiles > 0 ? (sb_rows * sb_cols) >> (min_log2_tiles + 1)
                                    : sb_rows * sb_cols;
      int max_tile_height_sb = imax(area / widest, 1);
      s = 0;
      while (s < sb_rows) {
        mi_row_starts.push_back(s << sb_shift);
        int maxh = imin(sb_rows - s, max_tile_height_sb);
        int size = (int)b.ns((uint32_t)maxh) + 1;
        s += size;
      }
      mi_row_starts.push_back(mi_rows);
      tile_rows = (int)mi_row_starts.size() - 1;
      tile_rows_log2 = tile_log2(1, tile_rows);
      if (tile_cols > 64 || tile_rows > 64) throw Invalid("too many tiles");
    }
    if (tile_cols_log2 > 0 || tile_rows_log2 > 0) {
      b.f(tile_rows_log2 + tile_cols_log2);  // context_update_tile_id
      tile_size_bytes = (int)b.f(2) + 1;
    } else {
      tile_size_bytes = 4;
    }
  }

  void start_frame() {
    frame_cdfs.init(base_q_idx);
    mi_stride = mi_cols + 32;
    size_t n = (size_t)mi_stride * (mi_rows + 32);
    y_modes.assign(n, 0);
    uv_modes.assign(n, 0);
    skips.assign(n, 0);
    tx_sizes.assign(n, 0);
    mi_sizes.assign(n, 0);
    seg_ids.assign(n, 0);
    tx_types.assign(n, 0);
    is_inters.assign(n, 0);
    decoded.assign(n, 0);
    mvs.assign(n * 2, 0);
    delta_lfs.assign(n * 4, 0);
    for (int p = 0; p < 2; p++) {
      pal_above[p].assign((size_t)(mi_cols + 32) * 9, 0);
      pal_left[p].assign((size_t)(mi_rows + 32) * 9, 0);
    }
    cdef_stride = (mi_cols >> 4) + 4;
    cdef_idx.assign((size_t)cdef_stride * ((mi_rows >> 4) + 4), -1);
    for (int p = 0; p < 3; p++) {
      int sx = p ? ssx : 0, sy = p ? ssy : 0;
      Plane& pl = planes[p];
      pl.w = (mi_cols * 4) >> sx;
      pl.h = (mi_rows * 4) >> sy;
      pl.stride = pl.w + 160;
      pl.px.assign((size_t)pl.stride * (pl.h + 160), 0);
      above_level[p].assign((mi_cols >> sx) + 64, 0);
      above_dc[p].assign((mi_cols >> sx) + 64, 0);
      left_level[p].assign((mi_rows >> sy) + 64, 0);
      left_dc[p].assign((mi_rows >> sy) + 64, 0);
      lf_tx_sizes[p].assign(n, 0);
      lr_rows[p] = lr_cols[p] = 0;
      lr_units[p].clear();
      if (lr_type[p] != RESTORE_NONE) {
        // count_units_in_frame over the plane's true (upscaled) size
        auto units = [&](int size) { return imax((size + (lr_size[p] >> 1)) / lr_size[p], 1); };
        lr_rows[p] = units((frame_h + sy) >> sy);
        lr_cols[p] = units((upscaled_w + sx) >> sx);
        lr_units[p].assign((size_t)lr_rows[p] * lr_cols[p], LrUnit());
      }
    }
    next_tile = 0;
  }

  // ------------------------------------------------------------ tile group
  void tile_group(const uint8_t* p, size_t sz) {
    Bits b(p, sz);
    int num_tiles = tile_cols * tile_rows;
    int start = 0, end = num_tiles - 1;
    if (num_tiles > 1 && b.bit()) {
      int bits = tile_cols_log2 + tile_rows_log2;
      start = (int)b.f(bits);
      end = (int)b.f(bits);
    }
    b.byte_align();
    if (start != next_tile || end < start || end >= num_tiles)
      throw Invalid("tile group out of order");
    size_t pos = b.pos / 8;
    for (int t = start; t <= end; t++) {
      size_t tsize;
      if (t == end) {
        tsize = sz - pos;
      } else {
        if (pos + tile_size_bytes > sz) throw Invalid("tile size runs past the data");
        tsize = 0;
        for (int i = 0; i < tile_size_bytes; i++) tsize |= (size_t)p[pos + i] << (8 * i);
        tsize += 1;
        pos += tile_size_bytes;
        if (tsize > sz - pos) throw Invalid("tile runs past the data");
      }
      int row = t / tile_cols, col = t % tile_cols;
      mi_row_start = mi_row_starts[row];
      mi_row_end = mi_row_starts[row + 1];
      mi_col_start = mi_col_starts[col];
      mi_col_end = mi_col_starts[col + 1];
      current_q_index = base_q_idx;
      cdf = frame_cdfs;
      sd.init(p + pos, tsize, disable_cdf_update != 0);
      decode_tile();
      sd.exit();
      pos += tsize;
    }
    next_tile = end + 1;
    if (end == num_tiles - 1) frame_done = true;
  }

  void decode_tile() {
    // clear_above_context
    for (int p = 0; p < 3; p++) {
      int sx = p ? ssx : 0;
      for (int i = mi_col_start >> sx; i < (mi_col_end >> sx) + 32 && i < (int)above_level[p].size(); i++)
        above_level[p][i] = above_dc[p][i] = 0;
    }
    for (int i = 0; i < 4; i++) delta_lf[i] = 0;
    for (int p = 0; p < 3; p++)
      for (int pass = 0; pass < 2; pass++) {
        ref_xqd[p][pass] = kSgrprojXqdMid[pass];
        for (int i = 0; i < 3; i++) ref_wiener[p][pass][i] = AV1_WIENER_TAPS_MID[i];
      }
    int sb4 = use_128 ? 32 : 16;
    int sb_size = use_128 ? BLOCK_128X128 : BLOCK_64X64;
    for (int r = mi_row_start; r < mi_row_end; r += sb4) {
      for (int p = 0; p < 3; p++) {  // clear_left_context
        int sy = p ? ssy : 0;
        for (int i = mi_row_start >> sy; i < (mi_row_end >> sy) + 32 && i < (int)left_level[p].size(); i++)
          left_level[p][i] = left_dc[p][i] = 0;
      }
      for (int c = mi_col_start; c < mi_col_end; c += sb4) {
        read_deltas = delta_q_present != 0;
        clear_cdef(r, c);
        clear_block_decoded_flags(r, c, sb4);
        read_lr(r, c, sb_size);
        decode_partition(r, c, sb_size);
      }
    }
  }

  int8_t& cdef_at(int r, int c) { return cdef_idx[(size_t)(r >> 4) * cdef_stride + (c >> 4)]; }
  void clear_cdef(int r, int c) {
    cdef_at(r, c) = -1;
    if (use_128) {
      cdef_at(r, c + 16) = -1;
      cdef_at(r + 16, c) = -1;
      cdef_at(r + 16, c + 16) = -1;
    }
  }
  void clear_block_decoded_flags(int r, int c, int sb4) {
    for (int p = 0; p < 3; p++) {
      int sx = p ? ssx : 0, sy = p ? ssy : 0;
      int sbw4 = (mi_col_end - c) >> sx, sbh4 = (mi_row_end - r) >> sy;
      for (int y = -1; y <= (sb4 >> sy); y++)
        for (int x = -1; x <= (sb4 >> sx); x++) {
          uint8_t v;
          if (y < 0 && x < sbw4) v = 1;
          else if (x < 0 && y < sbh4) v = 1;
          else v = 0;
          block_decoded[p][y + 1][x + 1] = v;
        }
      int last = sb4 >> sy;
      block_decoded[p][last + 1][0] = 0;
    }
  }

  bool is_inside(int r, int c) const {
    return c >= mi_col_start && c < mi_col_end && r >= mi_row_start && r < mi_row_end;
  }

  // ------------------------------------------------------------ partition
  void decode_partition(int r, int c, int bsize) {
    if (r >= mi_rows || c >= mi_cols) return;
    int au = is_inside(r - 1, c), al = is_inside(r, c - 1);
    int num4 = 1 << (kBlockW2[bsize] - 2);
    int half = num4 >> 1, quarter = half >> 1;
    bool has_rows = (r + half) < mi_rows, has_cols = (c + half) < mi_cols;
    int partition;
    if (bsize < BLOCK_8X8) {
      partition = PARTITION_NONE;
    } else {
      int bsl = kBlockW2[bsize] - 2;  // Mi_Width_Log2
      int above = au && (kBlockW2[mi_sizes[idx(r - 1, c)]] - 2) < bsl;
      int left = al && (kBlockH2[mi_sizes[idx(r, c - 1)]] - 2) < bsl;
      int ctx = left * 2 + above;
      uint16_t* pc = cdf.partition[(bsl - 1) * 4 + ctx];
      int n = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
      if (has_rows && has_cols) {
        partition = sd.read(pc, n);
      } else if (has_cols) {
        auto prob = [&](int e) -> int {
          if (e >= n) return 0;
          return (e > 0 ? pc[e - 1] : 32768) - pc[e];
        };
        // split_or_horz: "split" gathers the partitions that split the
        // top half vertically
        int psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) +
                   prob(PARTITION_VERT_A) + prob(PARTITION_VERT_B);
        if (bsize != BLOCK_128X128) psum += prob(PARTITION_VERT_4);
        uint16_t tmp[3] = {(uint16_t)psum, 0, 0};
        bool a = sd.adapt;
        sd.adapt = false;
        int s = sd.read(tmp, 2);
        sd.adapt = a;
        partition = s ? PARTITION_SPLIT : PARTITION_HORZ;
      } else if (has_rows) {
        auto prob = [&](int e) -> int {
          if (e >= n) return 0;
          return (e > 0 ? pc[e - 1] : 32768) - pc[e];
        };
        // split_or_vert: "split" gathers those that split the left half
        // horizontally
        int psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) +
                   prob(PARTITION_HORZ_B) + prob(PARTITION_VERT_A);
        if (bsize != BLOCK_128X128) psum += prob(PARTITION_HORZ_4);
        uint16_t tmp[3] = {(uint16_t)psum, 0, 0};
        bool a = sd.adapt;
        sd.adapt = false;
        int s = sd.read(tmp, 2);
        sd.adapt = a;
        partition = s ? PARTITION_SPLIT : PARTITION_VERT;
      } else {
        partition = PARTITION_SPLIT;
      }
    }
    int sub = partition_subsize(partition, bsize);
    int split = partition_subsize(PARTITION_SPLIT, bsize);
    switch (partition) {
      case PARTITION_NONE: decode_block(r, c, sub); break;
      case PARTITION_HORZ:
        decode_block(r, c, sub);
        if (has_rows) decode_block(r + half, c, sub);
        break;
      case PARTITION_VERT:
        decode_block(r, c, sub);
        if (has_cols) decode_block(r, c + half, sub);
        break;
      case PARTITION_SPLIT:
        decode_partition(r, c, sub);
        decode_partition(r, c + half, sub);
        decode_partition(r + half, c, sub);
        decode_partition(r + half, c + half, sub);
        break;
      case PARTITION_HORZ_A:
        decode_block(r, c, split);
        decode_block(r, c + half, split);
        decode_block(r + half, c, sub);
        break;
      case PARTITION_HORZ_B:
        decode_block(r, c, sub);
        decode_block(r + half, c, split);
        decode_block(r + half, c + half, split);
        break;
      case PARTITION_VERT_A:
        decode_block(r, c, split);
        decode_block(r + half, c, split);
        decode_block(r, c + half, sub);
        break;
      case PARTITION_VERT_B:
        decode_block(r, c, sub);
        decode_block(r, c + half, split);
        decode_block(r + half, c + half, split);
        break;
      case PARTITION_HORZ_4:
        for (int i = 0; i < 4; i++)
          if (i < 3 || r + quarter * 3 < mi_rows) decode_block(r + quarter * i, c, sub);
        break;
      default:
        for (int i = 0; i < 4; i++)
          if (i < 3 || c + quarter * 3 < mi_cols) decode_block(r, c + quarter * i, sub);
        break;
    }
  }

  // ---------------------------------------------------------------- block
  void decode_block(int r, int c, int bsize) {
    mi_row = r;
    mi_col = c;
    mi_size = bsize;
    int bw4 = 1 << (kBlockW2[bsize] - 2), bh4 = 1 << (kBlockH2[bsize] - 2);
    if (bh4 == 1 && ssy && (r & 1) == 0) has_chroma = 0;
    else if (bw4 == 1 && ssx && (c & 1) == 0) has_chroma = 0;
    else has_chroma = !mono;
    // a conformant stream has no block whose chroma has no size
    if (has_chroma && residual_size(bsize, 1) == BLOCK_INVALID)
      throw NotYet("4:2:2 block taller than wide");
    avail_u = is_inside(r - 1, c);
    avail_l = is_inside(r, c - 1);
    avail_u_chroma = avail_u;
    avail_l_chroma = avail_l;
    if (has_chroma) {
      if (ssy && bh4 == 1) avail_u_chroma = is_inside(r - 2, c);
      if (ssx && bw4 == 1) avail_l_chroma = is_inside(r, c - 2);
    } else {
      avail_u_chroma = avail_l_chroma = 0;
    }
    intra_frame_mode_info();
    palette_tokens();
    for (int p = 0; p < 2; p++) {
      for (int x = 0; x < bw4; x++) {
        pixel* a = &pal_above[p][(size_t)(c + x) * 9];
        a[0] = (pixel)pal_size[p];
        memcpy(a + 1, pal[p], sizeof pal[p]);
      }
      for (int y = 0; y < bh4; y++) {
        pixel* l = &pal_left[p][(size_t)(r + y) * 9];
        l[0] = (pixel)pal_size[p];
        memcpy(l + 1, pal[p], sizeof pal[p]);
      }
    }
    read_block_tx_size();
    if (skip) reset_block_context(bw4, bh4);
    int rows = imin(bh4, mi_rows - r), cols = imin(bw4, mi_cols - c);
    for (int y = 0; y < rows; y++)
      for (int x = 0; x < cols; x++) {
        int i = idx(r + y, c + x);
        y_modes[i] = (uint8_t)y_mode;
        uv_modes[i] = (uint8_t)uv_mode;
        skips[i] = (uint8_t)skip;
        mi_sizes[i] = (uint8_t)bsize;
        seg_ids[i] = (uint8_t)segment_id;
        is_inters[i] = (uint8_t)use_intrabc;
        decoded[i] = 1;
        mvs[2 * i] = (int16_t)dv[0];
        mvs[2 * i + 1] = (int16_t)dv[1];
        for (int k = 0; k < 4; k++) delta_lfs[4 * i + k] = (int8_t)delta_lf[k];
      }
    if (use_intrabc) predict_intrabc();
    residual();
  }

  void reset_block_context(int bw4, int bh4) {
    for (int p = 0; p < 1 + 2 * has_chroma; p++) {
      int sx = p ? ssx : 0, sy = p ? ssy : 0;
      for (int i = mi_col >> sx; i < ((mi_col + bw4 - 1) >> sx) + 1; i++)
        above_level[p][i] = above_dc[p][i] = 0;
      for (int i = mi_row >> sy; i < ((mi_row + bh4 - 1) >> sy) + 1; i++)
        left_level[p][i] = left_dc[p][i] = 0;
    }
  }

  void intra_frame_mode_info() {
    skip = 0;
    if (seg_id_pre_skip) intra_segment_id();
    read_skip();
    if (!seg_id_pre_skip) intra_segment_id();
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    read_deltas = false;
    use_intrabc = allow_intrabc ? sd.read(cdf.intrabc, 2) : 0;
    dv[0] = dv[1] = 0;
    if (use_intrabc) {
      y_mode = uv_mode = DC_PRED;
      angle_delta_y = angle_delta_uv = 0;
      cfl_alpha_u = cfl_alpha_v = 0;
      pal_size[0] = pal_size[1] = 0;
      use_filter_intra = 0;
      assign_dv();
      return;
    }
    int au = avail_u ? y_modes[idx(mi_row - 1, mi_col)] : (int)DC_PRED;
    int al = avail_l ? y_modes[idx(mi_row, mi_col - 1)] : (int)DC_PRED;
    y_mode = sd.read(cdf.kf_y[kIntraModeContext[au]][kIntraModeContext[al]], 13);
    angle_delta_y = 0;
    if (mi_size >= BLOCK_8X8 && y_mode >= V_PRED && y_mode <= D67_PRED)
      angle_delta_y = sd.read(cdf.angle[y_mode - V_PRED], 7) - 3;
    uv_mode = DC_PRED;
    angle_delta_uv = 0;
    cfl_alpha_u = cfl_alpha_v = 0;
    if (has_chroma) {
      int bw = 1 << kBlockW2[mi_size], bh = 1 << kBlockH2[mi_size];
      int cfl_allowed;
      if (lossless && residual_size(mi_size, 1) == BLOCK_4X4) cfl_allowed = 1;
      else if (!lossless && imax(bw, bh) <= 32) cfl_allowed = 1;
      else cfl_allowed = 0;
      uv_mode = sd.read(cdf.uv[cfl_allowed][y_mode], cfl_allowed ? 14 : 13);
      if (uv_mode == UV_CFL_PRED) read_cfl_alphas();
      if (mi_size >= BLOCK_8X8 && uv_mode >= V_PRED && uv_mode <= D67_PRED)
        angle_delta_uv = sd.read(cdf.angle[uv_mode - V_PRED], 7) - 3;
    }
    pal_size[0] = pal_size[1] = 0;
    if (mi_size >= BLOCK_8X8 && kBlockW2[mi_size] <= 6 && kBlockH2[mi_size] <= 6 &&
        allow_screen_content_tools)
      palette_mode_info();
    use_filter_intra = 0;
    if (enable_filter_intra && y_mode == DC_PRED && !pal_size[0] &&
        imax(kBlockW2[mi_size], kBlockH2[mi_size]) <= 5) {
      use_filter_intra = sd.read(cdf.filter_intra[mi_size], 2);
      if (use_filter_intra) filter_intra_mode = sd.read(cdf.filter_intra_mode, 5);
    }
  }

  // ---------------------------------------------------- intra block copy
  // the DV of an intrabc block: the reference stack of find_mv_stack on an
  // intra frame (the DVs of the intrabc blocks around it, weighted and
  // sorted, then clamped), its first nonzero entry or the default DV a
  // superblock up (or left, with INTRABC_DELAY_PIXELS, in a tile's first
  // superblock row), plus the coded difference
  int stack_mv[8][2], stack_weight[8], num_mv = 0;

  // (a DV is whole samples, so lower_mv_precision leaves it as it is)
  void add_candidate(int r, int c, int weight) {
    int i = idx(r, c);
    if (!is_inters[i]) return;
    int mv[2] = {mvs[2 * i], mvs[2 * i + 1]};
    for (int k = 0; k < num_mv; k++)
      if (stack_mv[k][0] == mv[0] && stack_mv[k][1] == mv[1]) {
        stack_weight[k] += weight;
        return;
      }
    if (num_mv < 8) {
      stack_mv[num_mv][0] = mv[0];
      stack_mv[num_mv][1] = mv[1];
      stack_weight[num_mv++] = weight;
    }
  }
  void scan_row(int dr) {
    int bw4 = 1 << (kBlockW2[mi_size] - 2);
    int end4 = imin(imin(bw4, mi_cols - mi_col), 16), dc = 0;
    if (std::abs(dr) > 1) {
      dr += mi_row & 1;
      dc = 1 - (mi_col & 1);
    }
    for (int i = 0; i < end4;) {
      int r = mi_row + dr, c = mi_col + dc + i;
      if (!is_inside(r, c)) break;
      int len = imin(bw4, 1 << (kBlockW2[mi_sizes[idx(r, c)]] - 2));
      if (std::abs(dr) > 1) len = imax(2, len);
      if (bw4 >= 16) len = imax(4, len);
      add_candidate(r, c, 2 * len);
      i += len;
    }
  }
  void scan_col(int dc) {
    int bh4 = 1 << (kBlockH2[mi_size] - 2);
    int end4 = imin(imin(bh4, mi_rows - mi_row), 16), dr = 0;
    if (std::abs(dc) > 1) {
      dr = 1 - (mi_row & 1);
      dc += mi_col & 1;
    }
    for (int i = 0; i < end4;) {
      int r = mi_row + dr + i, c = mi_col + dc;
      if (!is_inside(r, c)) break;
      int len = imin(bh4, 1 << (kBlockH2[mi_sizes[idx(r, c)]] - 2));
      if (std::abs(dc) > 1) len = imax(2, len);
      if (bh4 >= 16) len = imax(4, len);
      add_candidate(r, c, 2 * len);
      i += len;
    }
  }
  void scan_point(int dr, int dc) {
    int r = mi_row + dr, c = mi_col + dc;
    if (is_inside(r, c) && decoded[idx(r, c)]) add_candidate(r, c, 4);
  }
  void sort_stack(int start, int end) {
    while (end > start) {
      int new_end = start;
      for (int k = start + 1; k < end; k++)
        if (stack_weight[k - 1] < stack_weight[k]) {
          std::swap(stack_weight[k - 1], stack_weight[k]);
          std::swap(stack_mv[k - 1][0], stack_mv[k][0]);
          std::swap(stack_mv[k - 1][1], stack_mv[k][1]);
          new_end = k;
        }
      end = new_end;
    }
  }
  int read_mv_component(int comp) {
    int sign = sd.read(cdf.mv_sign[comp], 2);
    int cls = sd.read(cdf.mv_class[comp], 11);
    int mag;
    if (cls == 0) {
      mag = ((sd.read(cdf.mv_class0[comp], 2) << 3) | (3 << 1) | 1) + 1;
    } else {
      int d = 0;
      for (int i = 0; i < cls; i++) d |= sd.read(cdf.mv_bits[comp][i], 2) << i;
      mag = (2 << (cls + 2)) + ((d << 3) | (3 << 1) | 1) + 1;
    }
    return sign ? -mag : mag;
  }
  void assign_dv() {
    int bw4 = 1 << (kBlockW2[mi_size] - 2), bh4 = 1 << (kBlockH2[mi_size] - 2);
    num_mv = 0;
    scan_row(-1);
    scan_col(-1);
    if (imax(bw4, bh4) <= 16) scan_point(-1, bw4);
    int nearest = num_mv;
    for (int k = 0; k < nearest; k++) stack_weight[k] += 640;  // REF_CAT_LEVEL
    scan_point(-1, -1);
    scan_row(-3);
    scan_col(-3);
    if (bh4 > 1) scan_row(-5);
    if (bw4 > 1) scan_col(-5);
    sort_stack(0, nearest);
    sort_stack(nearest, num_mv);
    // extra_search adds no intrabc candidate; the stack's empty entries
    // hold the zero global MV
    for (int k = num_mv; k < 2; k++) stack_mv[k][0] = stack_mv[k][1] = 0;
    int top = -(mi_row * 32) - 128 - bh4 * 32, bottom = (mi_rows - bh4 - mi_row) * 32 + 128 + bh4 * 32;
    int left = -(mi_col * 32) - 128 - bw4 * 32, right = (mi_cols - bw4 - mi_col) * 32 + 128 + bw4 * 32;
    for (int k = 0; k < num_mv; k++) {
      stack_mv[k][0] = clip3(top, bottom, stack_mv[k][0]);
      stack_mv[k][1] = clip3(left, right, stack_mv[k][1]);
    }
    int pred[2] = {stack_mv[0][0], stack_mv[0][1]};
    if (!pred[0] && !pred[1]) {
      pred[0] = stack_mv[1][0];
      pred[1] = stack_mv[1][1];
    }
    if (!pred[0] && !pred[1]) {
      int sb4 = use_128 ? 32 : 16;
      if (mi_row - sb4 < mi_row_start) {
        pred[0] = 0;
        pred[1] = -(sb4 * 4 + 256) * 8;
      } else {
        pred[0] = -(sb4 * 4 * 8);
        pred[1] = 0;
      }
    }
    // read_mv with MvCtx MV_INTRABC_CONTEXT (integer: no fractional bits)
    int joint = sd.read(cdf.mv_joint, 4);
    int diff[2] = {0, 0};
    if (joint == 2 || joint == 3) diff[0] = read_mv_component(0);
    if (joint == 1 || joint == 3) diff[1] = read_mv_component(1);
    dv[0] = pred[0] + diff[0];
    dv[1] = pred[1] + diff[1];
  }

  // the block's prediction from the frame decoded so far (no in-loop
  // filter runs on an intrabc frame), each plane through the spec's
  // block_inter_prediction with BILINEAR taps: integer for luma, and a
  // half sample where a subsampled chroma plane halves an odd DV
  // (InterRound0 3 and InterRound1 11, 5 and 9 at 12 bits)
  void predict_intrabc() {
    for (int plane = 0; plane < 1 + 2 * has_chroma; plane++) {
      int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
      int psz = residual_size(mi_size, plane);
      int w = 1 << kBlockW2[psz], h = 1 << kBlockH2[psz];
      int x0 = (mi_col >> sx) * 4, y0 = (mi_row >> sy) * 4;
      int px = x0 * 16 + ((2 * dv[1]) >> sx), py = y0 * 16 + ((2 * dv[0]) >> sy);
      int ix = px >> 4, fx = px & 15, iy = py >> 4, fy = py & 15;
      int last_x = ((mi_cols * 4 + sx) >> sx) - 1, last_y = ((mi_rows * 4 + sy) >> sy) - 1;
      Plane& pl = planes[plane];
      static thread_local int32_t mid[129][128];
      static thread_local pixel out[128][128];
      int round0 = bit_depth == 12 ? 5 : 3, round1 = bit_depth == 12 ? 9 : 11;
      for (int r = 0; r <= h; r++) {
        const pixel* row = pl.at(clip3(0, last_y, iy + r), 0);
        for (int c = 0; c < w; c++) {
          int a = row[clip3(0, last_x, ix + c)], b = row[clip3(0, last_x, ix + c + 1)];
          mid[r][c] = round2((128 - 8 * fx) * a + 8 * fx * b, round0);
        }
      }
      for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++)
          out[r][c] = clip1(round2((128 - 8 * fy) * mid[r][c] + 8 * fy * mid[r + 1][c], round1));
      for (int r = 0; r < h; r++) memcpy(pl.at(y0 + r, x0), out[r], w * sizeof(pixel));
    }
  }

  // ------------------------------------------------------------- palette
  static int ceil_log2(int x) {
    if (x < 2) return 0;
    int i = 1, p = 2;
    while (p < x) {
      i++;
      p <<= 1;
    }
    return i;
  }

  // get_palette_cache: the sorted union of the above (not across a 64-row
  // boundary) and left blocks' colours of plane Y (0) or U (1)
  int palette_cache(int plane, pixel* cache) {
    const pixel* a = avail_u && (mi_row & 15) ? &pal_above[plane][(size_t)mi_col * 9] : nullptr;
    const pixel* l = avail_l ? &pal_left[plane][(size_t)mi_row * 9] : nullptr;
    int an = a ? a[0] : 0, ln = l ? l[0] : 0, ai = 0, li = 0, n = 0;
    while (ai < an && li < ln) {
      int ac = a[1 + ai], lc = l[1 + li];
      if (lc < ac) {
        if (n == 0 || lc != cache[n - 1]) cache[n++] = (pixel)lc;
        li++;
      } else {
        if (n == 0 || ac != cache[n - 1]) cache[n++] = (pixel)ac;
        ai++;
        if (lc == ac) li++;
      }
    }
    for (; ai < an; ai++)
      if (n == 0 || a[1 + ai] != cache[n - 1]) cache[n++] = a[1 + ai];
    for (; li < ln; li++)
      if (n == 0 || l[1 + li] != cache[n - 1]) cache[n++] = l[1 + li];
    return n;
  }

  // the colours of plane Y or U: reused from the cache, then the first
  // literally and the rest as ascending deltas (Y's at least 1), sorted;
  // BitDepth bits each
  void palette_colors(int plane, int n) {
    pixel cache[16];
    pixel* colors = pal[plane];
    int cache_n = palette_cache(plane, cache), idx = 0;
    for (int i = 0; i < cache_n && idx < n; i++)
      if (sd.literal(1)) colors[idx++] = cache[i];
    if (idx < n) colors[idx++] = (pixel)sd.literal(bit_depth);
    int bits = 0;
    if (idx < n) bits = bit_depth - 3 + sd.literal(2);
    while (idx < n) {
      int delta = sd.literal(bits) + (plane == 0);
      colors[idx] = clip1(colors[idx - 1] + delta);
      bits = imin(bits, ceil_log2((1 << bit_depth) - colors[idx] - (plane == 0)));
      idx++;
    }
    std::sort(colors, colors + n);
  }

  void palette_mode_info() {
    int bsize_ctx = kBlockW2[mi_size] + kBlockH2[mi_size] - 6;
    if (y_mode == DC_PRED) {
      int ctx = (avail_u && pal_above[0][(size_t)mi_col * 9] > 0) +
                (avail_l && pal_left[0][(size_t)mi_row * 9] > 0);
      if (sd.read(cdf.pal_y[bsize_ctx][ctx], 2)) {
        pal_size[0] = sd.read(cdf.pal_y_size[bsize_ctx], 7) + 2;
        palette_colors(0, pal_size[0]);
      }
    }
    if (has_chroma && uv_mode == DC_PRED && sd.read(cdf.pal_uv[pal_size[0] > 0], 2)) {
      int n = pal_size[1] = sd.read(cdf.pal_uv_size[bsize_ctx], 7) + 2;
      palette_colors(1, n);
      pixel* v = pal[2];
      if (sd.literal(1)) {  // delta_encode_palette_colors_v
        int bits = bit_depth - 4 + sd.literal(2), max_val = 1 << bit_depth;
        v[0] = (pixel)sd.literal(bit_depth);
        for (int i = 1; i < n; i++) {
          int delta = sd.literal(bits);
          if (delta && sd.literal(1)) delta = -delta;
          int val = v[i - 1] + delta;
          if (val < 0) val += max_val;
          if (val >= max_val) val -= max_val;
          v[i] = clip1(val);
        }
      } else {
        for (int i = 0; i < n; i++) v[i] = (pixel)sd.literal(bit_depth);
      }
    }
  }

  // palette_tokens: each colour map in wavefront order, every index coded
  // by its rank among the up, left and up-left neighbours' indices
  void palette_tokens() {
    int bh = 1 << kBlockH2[mi_size], bw = 1 << kBlockW2[mi_size];
    int on_h = imin(bh, (mi_rows - mi_row) * 4), on_w = imin(bw, (mi_cols - mi_col) * 4);
    for (int p = 0; p < 2; p++) {
      int n = pal_size[p];
      if (!n) continue;
      int h = bh, w = bw, oh = on_h, ow = on_w;
      if (p) {
        h >>= ssy;
        w >>= ssx;
        oh >>= ssy;
        ow >>= ssx;
        if (w < 4) {
          w += 2;
          ow += 2;
        }
        if (h < 4) {
          h += 2;
          oh += 2;
        }
      }
      uint8_t (*map)[64] = color_map[p];
      map[0][0] = (uint8_t)read_ns(n);
      for (int i = 1; i < oh + ow - 1; i++)
        for (int j = imin(i, ow - 1); j >= imax(0, i - oh + 1); j--) {
          int order[8], ctx = palette_color_context(map, i - j, j, n, order);
          uint16_t* c = p ? cdf.pal_uv_color[n - 2][ctx] : cdf.pal_y_color[n - 2][ctx];
          map[i - j][j] = (uint8_t)order[sd.read(c, n)];
        }
      for (int i = 0; i < oh; i++)
        for (int j = ow; j < w; j++) map[i][j] = map[i][ow - 1];
      for (int i = oh; i < h; i++) memcpy(map[i], map[oh - 1], w);
    }
  }

  // get_palette_color_context: the neighbours' indices ranked by score
  // (left and up 2, up-left 1) into `order`; the context of their hash
  static int palette_color_context(uint8_t (*map)[64], int r, int c, int n, int* order) {
    int scores[8] = {0};
    for (int i = 0; i < 8; i++) order[i] = i;
    if (c > 0) scores[map[r][c - 1]] += 2;
    if (r > 0 && c > 0) scores[map[r - 1][c - 1]] += 1;
    if (r > 0) scores[map[r - 1][c]] += 2;
    for (int i = 0; i < 3; i++) {
      int max_score = scores[i], max_idx = i;
      for (int j = i + 1; j < n; j++)
        if (scores[j] > max_score) {
          max_score = scores[j];
          max_idx = j;
        }
      if (max_idx != i) {
        int max_order = order[max_idx];
        for (int k = max_idx; k > i; k--) {
          scores[k] = scores[k - 1];
          order[k] = order[k - 1];
        }
        scores[i] = max_score;
        order[i] = max_order;
      }
    }
    static const int kContext[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
    return kContext[scores[0] + 2 * scores[1] + 2 * scores[2]];
  }

  // Subsampled_Size: BLOCK_INVALID where 4:2:2 would halve a block
  // taller than wide (or one 4:2:0 would leave narrower than 4 samples)
  int residual_size(int bsize, int plane) {
    if (plane == 0) return bsize;
    if (ssx && !ssy && kBlockH2[bsize] > kBlockW2[bsize]) return BLOCK_INVALID;
    return block_size(imax(2, kBlockW2[bsize] - ssx), imax(2, kBlockH2[bsize] - ssy));
  }

  void intra_segment_id() {
    if (seg_enabled) read_segment_id();
    else segment_id = 0;
    lossless = lossless_array[segment_id];
  }

  static int neg_deinterleave(int diff, int ref, int max) {
    if (!ref) return diff;
    if (ref >= max - 1) return max - diff - 1;
    if (2 * ref < max) {
      if (diff <= 2 * ref) {
        if (diff & 1) return ref + ((diff + 1) >> 1);
        return ref - (diff >> 1);
      }
      return diff;
    }
    if (diff <= 2 * (max - ref - 1)) {
      if (diff & 1) return ref + ((diff + 1) >> 1);
      return ref - (diff >> 1);
    }
    return max - (diff + 1);
  }

  void read_segment_id() {
    int prev_ul = -1, prev_u = -1, prev_l = -1;
    if (avail_u && avail_l) prev_ul = seg_ids[idx(mi_row - 1, mi_col - 1)];
    if (avail_u) prev_u = seg_ids[idx(mi_row - 1, mi_col)];
    if (avail_l) prev_l = seg_ids[idx(mi_row, mi_col - 1)];
    int pred;
    if (prev_u == -1) pred = prev_l == -1 ? 0 : prev_l;
    else if (prev_l == -1) pred = prev_u;
    else pred = prev_ul == prev_u ? prev_u : prev_l;
    if (skip) {
      segment_id = pred;
      return;
    }
    int ctx;
    if (prev_ul < 0) ctx = 0;
    else if (prev_ul == prev_u && prev_ul == prev_l) ctx = 2;
    else if (prev_ul == prev_u || prev_ul == prev_l || prev_u == prev_l) ctx = 1;
    else ctx = 0;
    int s = sd.read(cdf.seg[ctx], 8);
    segment_id = clip3(0, last_active_seg_id, neg_deinterleave(s, pred, last_active_seg_id + 1));
  }

  void read_skip() {
    if (seg_id_pre_skip && seg_enabled && feature_enabled[segment_id][6]) {
      skip = 1;
      return;
    }
    int ctx = (avail_u ? skips[idx(mi_row - 1, mi_col)] : 0) +
              (avail_l ? skips[idx(mi_row, mi_col - 1)] : 0);
    skip = sd.read(cdf.skip[ctx], 2);
  }

  void read_cdef() {
    if (skip || coded_lossless || !enable_cdef || allow_intrabc) return;
    int r = mi_row & ~15, c = mi_col & ~15;
    if (cdef_at(r, c) == -1) {
      int v = sd.literal(cdef_bits);
      int w4 = 1 << (kBlockW2[mi_size] - 2), h4 = 1 << (kBlockH2[mi_size] - 2);
      for (int y = r; y < r + h4; y += 16)
        for (int x = c; x < c + w4; x += 16) cdef_at(y, x) = (int8_t)v;
    }
  }

  // ------------------------------------------------- restoration units
  // decode_subexp_bool and its recentring, on the symbol decoder's literals
  int read_ns(int n) {
    int w = floorlog2((uint32_t)n) + 1, m = (1 << w) - n;
    int v = sd.literal(w - 1);
    return v < m ? v : (v << 1) - m + sd.literal(1);
  }
  int read_subexp(int num_syms, int k) {
    int i = 0, mk = 0;
    for (;;) {
      int b2 = i ? k + i - 1 : k, a = 1 << b2;
      if (num_syms <= mk + 3 * a) return read_ns(num_syms - mk) + mk;
      if (!sd.literal(1)) return sd.literal(b2) + mk;
      i++;
      mk += a;
    }
  }
  static int inverse_recenter(int r, int v) {
    if (v > 2 * r) return v;
    return (v & 1) ? r - ((v + 1) >> 1) : r + (v >> 1);
  }
  int read_signed_subexp(int low, int high, int k, int ref) {
    int mx = high - low, r = ref - low;
    int v = read_subexp(mx, k);
    v = (r << 1) <= mx ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v);
    return v + low;
  }

  void read_lr(int r, int c, int bsize) {
    int w4 = 1 << (kBlockW2[bsize] - 2), h4 = 1 << (kBlockH2[bsize] - 2);
    for (int p = 0; p < 3; p++) {
      if (lr_type[p] == RESTORE_NONE) continue;
      int sx = p ? ssx : 0, sy = p ? ssy : 0, unit = lr_size[p];
      int row0 = (r * (4 >> sy) + unit - 1) / unit;
      int row1 = imin(lr_rows[p], ((r + h4) * (4 >> sy) + unit - 1) / unit);
      // the units' columns are the upscaled frame's
      int num = (4 >> sx) * superres_denom, den = unit * 8;
      int col0 = (c * num + den - 1) / den;
      int col1 = imin(lr_cols[p], ((c + w4) * num + den - 1) / den);
      for (int ur = row0; ur < row1; ur++)
        for (int uc = col0; uc < col1; uc++) read_lr_unit(p, lr_units[p][(size_t)ur * lr_cols[p] + uc]);
    }
  }

  void read_lr_unit(int p, LrUnit& u) {
    if (lr_type[p] == RESTORE_WIENER) u.type = sd.read(cdf.use_wiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
    else if (lr_type[p] == RESTORE_SGRPROJ) u.type = sd.read(cdf.use_sgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
    else u.type = sd.read(cdf.restoration_type, 3);
    if (u.type == RESTORE_WIENER) {
      for (int pass = 0; pass < 2; pass++) {
        u.wiener[pass][0] = 0;  // chroma's outer tap
        for (int j = p ? 1 : 0; j < 3; j++) {
          int v = read_signed_subexp(kWienerTapsMin[j], kWienerTapsMax[j] + 1, kWienerTapsK[j],
                                     ref_wiener[p][pass][j]);
          u.wiener[pass][j] = ref_wiener[p][pass][j] = v;
        }
      }
    } else if (u.type == RESTORE_SGRPROJ) {
      u.sgr_set = sd.literal(4);
      for (int i = 0; i < 2; i++) {
        int v = 0;
        if (AV1_SGR_PARAMS[2 * u.sgr_set + i])
          v = read_signed_subexp(kSgrprojXqdMin[i], kSgrprojXqdMax[i] + 1, 4, ref_xqd[p][i]);
        else if (i == 1)
          v = clip3(kSgrprojXqdMin[1], kSgrprojXqdMax[1], (1 << 7) - ref_xqd[p][0]);
        u.xqd[i] = ref_xqd[p][i] = v;
      }
    }
  }

  void read_delta_qindex() {
    int sb_size = use_128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb_size && skip) return;
    if (read_deltas) {
      int a = sd.read(cdf.delta_q, 4);
      if (a == 3) {
        int rem = sd.literal(3) + 1;
        a = sd.literal(rem) + (1 << rem) + 1;
      }
      if (a) {
        int sign = sd.literal(1);
        int reduced_dq = sign ? -a : a;
        current_q_index = clip3(1, 255, current_q_index + reduced_dq * (1 << delta_q_res));
      }
    }
  }

  void read_delta_lf() {
    int sb_size = use_128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb_size && skip) return;
    if (read_deltas && delta_lf_present) {
      int count = delta_lf_multi ? (mono ? 2 : 4) : 1;
      for (int i = 0; i < count; i++) {
        uint16_t* c = delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf;
        int a = sd.read(c, 4);
        if (a == 3) {
          int n = sd.literal(3) + 1;
          a = sd.literal(n) + (1 << n) + 1;
        }
        if (a) {
          int sign = sd.literal(1);
          int red = sign ? -a : a;
          delta_lf[i] = clip3(-63, 63, delta_lf[i] + red * (1 << delta_lf_res));
        }
      }
    }
  }

  void read_cfl_alphas() {
    int signs = sd.read(cdf.cfl_sign, 8);
    int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
    if (sign_u) {
      int a = sd.read(cdf.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16);
      cfl_alpha_u = 1 + a;
      if (sign_u == 1) cfl_alpha_u = -cfl_alpha_u;
    } else {
      cfl_alpha_u = 0;
    }
    if (sign_v) {
      int a = sd.read(cdf.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16);
      cfl_alpha_v = 1 + a;
      if (sign_v == 1) cfl_alpha_v = -cfl_alpha_v;
    } else {
      cfl_alpha_v = 0;
    }
  }

  int above_tx_width(int r, int c) {
    int i = idx(r - 1, c);
    return 1 << kTxW2[tx_sizes[i]];
  }
  int left_tx_height(int r, int c) {
    int i = idx(r, c - 1);
    return 1 << kTxH2[tx_sizes[i]];
  }

  // read_block_tx_size: an intrabc block's transform tree (read_var_tx_size)
  // where it has coefficients, else one size over the block; the sizes go
  // into tx_sizes (InterTxSizes)
  void read_block_tx_size() {
    int bw4 = 1 << (kBlockW2[mi_size] - 2), bh4 = 1 << (kBlockH2[mi_size] - 2);
    int max_rect = max_tx_size_rect(mi_size);
    if (use_intrabc && tx_mode_select && mi_size > BLOCK_4X4 && !skip && !lossless) {
      int w4 = 1 << (kTxW2[max_rect] - 2), h4 = 1 << (kTxH2[max_rect] - 2);
      for (int r = mi_row; r < mi_row + bh4; r += h4)
        for (int c = mi_col; c < mi_col + bw4; c += w4) read_var_tx_size(r, c, max_rect, 0);
      return;
    }
    tx_sz = lossless ? TX_4X4 : max_rect;
    if (!lossless && mi_size > BLOCK_4X4 && tx_mode_select && !(skip && use_intrabc)) {
      int depth = 0;
      for (int t = max_rect; t != TX_4X4; t = split_tx_size(t)) depth++;
      int cat = depth - 1;
      int max_depth = imin(depth, 2);
      int max_w = 1 << kTxW2[max_rect], max_h = 1 << kTxH2[max_rect];
      // an intrabc neighbour counts with its block's size
      int above_w = !avail_u ? 0 : is_inters[idx(mi_row - 1, mi_col)]
                                       ? 1 << kBlockW2[mi_sizes[idx(mi_row - 1, mi_col)]]
                                       : above_tx_width(mi_row, mi_col);
      int left_h = !avail_l ? 0 : is_inters[idx(mi_row, mi_col - 1)]
                                      ? 1 << kBlockH2[mi_sizes[idx(mi_row, mi_col - 1)]]
                                      : left_tx_height(mi_row, mi_col);
      int ctx = (above_w >= max_w) + (left_h >= max_h);
      int d = sd.read(cdf.tx_size[cat][ctx], max_depth + 1);
      for (int i = 0; i < d; i++) tx_sz = split_tx_size(tx_sz);
    }
    for (int y = 0; y < imin(bh4, mi_rows - mi_row); y++)
      for (int x = 0; x < imin(bw4, mi_cols - mi_col); x++) tx_sizes[idx(mi_row + y, mi_col + x)] = (uint8_t)tx_sz;
  }

  void read_var_tx_size(int r, int c, int t, int depth) {
    if (r >= mi_rows || c >= mi_cols) return;
    int split = 0;
    if (t != TX_4X4 && depth < 2) {
      int above = tx_width_above(r, c) < (1 << kTxW2[t]);
      int left = tx_height_left(r, c) < (1 << kTxH2[t]);
      int size = imin(64, 1 << imax(kBlockW2[mi_size], kBlockH2[mi_size]));
      int max_sq = floorlog2((uint32_t)size) - 2;  // TX_4X4 .. TX_64X64
      int ctx = (tx_sqr_up(t) != max_sq) * 3 + (4 - max_sq) * 6 + above + left;
      split = sd.read(cdf.txfm_split[ctx], 2);
    }
    int w4 = 1 << (kTxW2[t] - 2), h4 = 1 << (kTxH2[t] - 2);
    if (split) {
      int sub = split_tx_size(t);
      int sw = 1 << (kTxW2[sub] - 2), sh = 1 << (kTxH2[sub] - 2);
      for (int i = 0; i < h4; i += sh)
        for (int j = 0; j < w4; j += sw) read_var_tx_size(r + i, c + j, sub, depth + 1);
      return;
    }
    for (int i = 0; i < h4 && r + i < mi_rows; i++)
      for (int j = 0; j < w4 && c + j < mi_cols; j++) tx_sizes[idx(r + i, c + j)] = (uint8_t)t;
    tx_sz = t;
  }

  // get_above_tx_width / get_left_tx_height: a skipped intrabc block above
  // or left of the block counts with its block's size
  int tx_width_above(int r, int c) {
    if (r == mi_row) {
      if (!avail_u) return 64;
      int i = idx(r - 1, c);
      if (skips[i] && is_inters[i]) return 1 << kBlockW2[mi_sizes[i]];
    }
    return above_tx_width(r, c);
  }
  int tx_height_left(int r, int c) {
    if (c == mi_col) {
      if (!avail_l) return 64;
      int i = idx(r, c - 1);
      if (skips[i] && is_inters[i]) return 1 << kBlockH2[mi_sizes[i]];
    }
    return left_tx_height(r, c);
  }

  // ------------------------------------------------------------- residual
  int get_tx_size(int plane, int t) {
    if (plane == 0) return t;
    int uv = max_tx_size_rect(residual_size(mi_size, plane));
    if (kTxW2[uv] == 6 || kTxH2[uv] == 6) {
      if (kTxW2[uv] == 4) return TX_16X32;
      if (kTxH2[uv] == 4) return TX_32X16;
      return TX_32X32;
    }
    return uv;
  }

  void residual() {
    int sb_mask = use_128 ? 31 : 15;
    int wchunks = imax(1, (1 << kBlockW2[mi_size]) >> 6);
    int hchunks = imax(1, (1 << kBlockH2[mi_size]) >> 6);
    for (int cy = 0; cy < hchunks; cy++)
      for (int cx = 0; cx < wchunks; cx++) {
        for (int plane = 0; plane < 1 + has_chroma * 2; plane++) {
          int t = lossless ? TX_4X4 : get_tx_size(plane, tx_sz);
          int step_x = 1 << (kTxW2[t] - 2), step_y = 1 << (kTxH2[t] - 2);
          int psz = residual_size(mi_size, plane);
          int n4w = 1 << (kBlockW2[psz] - 2), n4h = 1 << (kBlockH2[psz] - 2);
          int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
          if (use_intrabc && !lossless && !plane) {
            transform_tree((mi_col + (cx << 4)) * 4, (mi_row + (cy << 4)) * 4, imin(64, n4w * 4),
                           imin(64, n4h * 4), sb_mask);
            continue;
          }
          int base_x = (mi_col >> sx) * 4, base_y = (mi_row >> sy) * 4;
          for (int y = 0; y < imin(n4h, 16 >> sy); y += step_y)
            for (int x = 0; x < imin(n4w, 16 >> sx); x += step_x)
              transform_block(plane, base_x, base_y, t, x + ((cx << 4) >> sx),
                              y + ((cy << 4) >> sy), sb_mask);
        }
      }
  }

  // an intrabc block's luma transforms: the tree of its InterTxSizes
  void transform_tree(int x0, int y0, int w, int h, int sb_mask) {
    if (x0 >= mi_cols * 4 || y0 >= mi_rows * 4) return;
    int t = tx_sizes[idx(y0 >> 2, x0 >> 2)];
    if (w <= (1 << kTxW2[t]) && h <= (1 << kTxH2[t])) {
      transform_block(0, x0, y0, tx_size(floorlog2((uint32_t)w), floorlog2((uint32_t)h)), 0, 0, sb_mask);
    } else if (w > h) {
      transform_tree(x0, y0, w / 2, h, sb_mask);
      transform_tree(x0 + w / 2, y0, w / 2, h, sb_mask);
    } else if (w < h) {
      transform_tree(x0, y0, w, h / 2, sb_mask);
      transform_tree(x0, y0 + h / 2, w, h / 2, sb_mask);
    } else {
      transform_tree(x0, y0, w / 2, h / 2, sb_mask);
      transform_tree(x0 + w / 2, y0, w / 2, h / 2, sb_mask);
      transform_tree(x0, y0 + h / 2, w / 2, h / 2, sb_mask);
      transform_tree(x0 + w / 2, y0 + h / 2, w / 2, h / 2, sb_mask);
    }
  }

  void transform_block(int plane, int base_x, int base_y, int t, int x, int y, int sb_mask) {
    int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
    int sub_r = row & sb_mask, sub_c = col & sb_mask;
    int step_x = 1 << (kTxW2[t] - 2), step_y = 1 << (kTxH2[t] - 2);
    int max_x = mi_cols * 4 - 1, max_y = mi_rows * 4 - 1;
    if (start_x >= (max_x >> sx) || start_y >= (max_y >> sy)) return;
    bool is_cfl = plane > 0 && uv_mode == UV_CFL_PRED;
    int mode = plane == 0 ? y_mode : (is_cfl ? DC_PRED : uv_mode);
    int have_left = (plane == 0 ? avail_l : avail_l_chroma) || x > 0;
    int have_above = (plane == 0 ? avail_u : avail_u_chroma) || y > 0;
    int above_rt = block_decoded[plane][(sub_r >> sy) - 1 + 1][(sub_c >> sx) + step_x + 1];
    int below_lft = block_decoded[plane][(sub_r >> sy) + step_y + 1][(sub_c >> sx) - 1 + 1];
    if (use_intrabc) {
      // predicted over the whole block before its transforms
    } else if (pal_size[plane > 0]) {  // predict_palette
      const pixel* colors = pal[plane];
      int w = 1 << kTxW2[t], h = 1 << kTxH2[t];
      for (int i = 0; i < h; i++) {
        const uint8_t* m = &color_map[plane > 0][y * 4 + i][x * 4];
        pixel* px = planes[plane].at(start_y + i, start_x);
        for (int j = 0; j < w; j++) px[j] = colors[m[j]];
      }
    } else {
      predict_intra(plane, start_x, start_y, have_left, have_above, above_rt, below_lft, mode,
                    kTxW2[t], kTxH2[t]);
      if (is_cfl) predict_cfl(plane, start_x, start_y, t);
    }
    if (plane == 0) {
      max_luma_w = start_x + step_x * 4;
      max_luma_h = start_y + step_y * 4;
    }
    if (!skip) {
      int eob = coeffs(plane, start_x, start_y, t);
      if (eob > 0) reconstruct(plane, start_x, start_y, t);
    }
    for (int i = 0; i < step_y; i++)
      for (int j = 0; j < step_x; j++) {
        lf_tx_sizes[plane][idx((row >> sy) + i, (col >> sx) + j)] = (uint8_t)t;
        int yy = (sub_r >> sy) + i + 1, xx = (sub_c >> sx) + j + 1;
        if (yy < 34 && xx < 34) block_decoded[plane][yy][xx] = 1;
      }
  }

  // ------------------------------------------------------------ prediction
  int16_t above_buf[64 * 2 + 64 + 32], left_buf[64 * 2 + 64 + 32];

  int get_filter_type(int plane) {
    int above_smooth = 0, left_smooth = 0;
    auto smooth = [&](int r, int c) {
      int m = plane == 0 ? y_modes[idx(r, c)] : uv_modes[idx(r, c)];
      return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
    };
    if (plane == 0 ? avail_u : avail_u_chroma) {
      int r = mi_row - 1, c = mi_col;
      if (plane > 0) {
        if (ssx && !(mi_col & 1)) c++;
        if (ssy && (mi_row & 1)) r--;
      }
      above_smooth = smooth(r, c);
    }
    if (plane == 0 ? avail_l : avail_l_chroma) {
      int r = mi_row, c = mi_col - 1;
      if (plane > 0) {
        if (ssx && (mi_col & 1)) c--;
        if (ssy && !(mi_row & 1)) r++;
      }
      left_smooth = smooth(r, c);
    }
    return above_smooth || left_smooth;
  }

  static int edge_strength(int w, int h, int filter_type, int delta) {
    int d = std::abs(delta), wh = w + h, s = 0;
    if (filter_type == 0) {
      if (wh <= 8) { if (d >= 56) s = 1; }
      else if (wh <= 12) { if (d >= 40) s = 1; }
      else if (wh <= 16) { if (d >= 40) s = 1; }
      else if (wh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
      else if (wh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
      else { if (d >= 1) s = 3; }
    } else {
      if (wh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
      else if (wh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
      else if (wh <= 24) { if (d >= 4) s = 3; }
      else { if (d >= 1) s = 3; }
    }
    return s;
  }
  static void edge_filter(int16_t* buf, int sz, int strength) {
    // buf[-1 .. sz - 2] are the edge; filtered in place
    if (strength == 0) return;
    int16_t edge[300];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
      int s = 0;
      for (int j = 0; j < 5; j++) {
        int k = clip3(0, sz - 1, i - 2 + j);
        s += AV1_INTRA_EDGE_KERNEL[(strength - 1) * 5 + j] * edge[k];
      }
      buf[i - 1] = (int16_t)((s + 8) >> 4);
    }
  }
  static int use_upsample(int w, int h, int filter_type, int delta) {
    int d = std::abs(delta), wh = w + h;
    if (d <= 0 || d >= 40) return 0;
    return filter_type == 0 ? wh <= 16 : wh <= 8;
  }
  void edge_upsample(int16_t* buf, int num_px) const {
    int16_t dup[80];
    dup[0] = buf[-1];
    for (int i = -1; i < num_px; i++) dup[i + 2] = buf[i];
    dup[num_px + 2] = buf[num_px - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < num_px; i++) {
      int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s = clip1(round2(s, 4));
      buf[2 * i - 1] = (int16_t)s;
      buf[2 * i] = dup[i + 2];
    }
  }

  void predict_intra(int plane, int x, int y, int have_left, int have_above, int have_above_rt,
                     int have_below_lft, int mode, int log2w, int log2h) {
    Plane& pl = planes[plane];
    int w = 1 << log2w, h = 1 << log2h;
    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    int max_x = ((mi_cols * 4) >> sx) - 1, max_y = ((mi_rows * 4) >> sy) - 1;
    int16_t* above = above_buf + 16;  // index -16 .. allowed
    int16_t* left = left_buf + 16;
    int n = w + h, base = 1 << (bit_depth - 1);
    if (!have_above && have_left) {
      int v = *pl.at(y, x - 1);
      for (int i = 0; i < n; i++) above[i] = (int16_t)v;
    } else if (!have_above && !have_left) {
      for (int i = 0; i < n; i++) above[i] = (int16_t)(base - 1);
    } else {
      int lim = imin(max_x, x + (have_above_rt ? 2 * w : w) - 1);
      pixel* row = pl.at(y - 1, 0);
      for (int i = 0; i < n; i++) above[i] = row[imin(lim, x + i)];
    }
    if (!have_left && have_above) {
      int v = *pl.at(y - 1, x);
      for (int i = 0; i < n; i++) left[i] = (int16_t)v;
    } else if (!have_left && !have_above) {
      for (int i = 0; i < n; i++) left[i] = (int16_t)(base + 1);
    } else {
      int lim = imin(max_y, y + (have_below_lft ? 2 * h : h) - 1);
      for (int i = 0; i < n; i++) left[i] = *pl.at(imin(lim, y + i), x - 1);
    }
    int corner;
    if (have_above && have_left) corner = *pl.at(y - 1, x - 1);
    else if (have_above) corner = *pl.at(y - 1, x);
    else if (have_left) corner = *pl.at(y, x - 1);
    else corner = base;
    above[-1] = left[-1] = (int16_t)corner;

    pixel pred[64][64];
    if (plane == 0 && use_filter_intra) {
      int w4 = w >> 2, h2 = h >> 1;
      const int8_t* taps = AV1_FILTER_INTRA_TAPS + filter_intra_mode * 64;
      for (int i2 = 0; i2 < h2; i2++)
        for (int j4 = 0; j4 < w4; j4++) {
          int p[7];
          for (int i = 0; i < 7; i++) {
            if (i < 5) {
              if (i2 == 0) p[i] = above[(j4 << 2) + i - 1];
              else if (j4 == 0 && i == 0) p[i] = left[(i2 << 1) - 1];
              else p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
            } else {
              if (j4 == 0) p[i] = left[(i2 << 1) + i - 5];
              else p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
            }
          }
          for (int i = 0; i < 8; i++) {
            int pr = 0;
            for (int j = 0; j < 7; j++) pr += taps[i * 8 + j] * p[j];
            pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = clip1(round2signed(pr, 4));
          }
        }
    } else if (mode >= V_PRED && mode <= D67_PRED) {
      int angle_delta = plane == 0 ? angle_delta_y : angle_delta_uv;
      int p_angle = kModeToAngle[mode] + angle_delta * 3;
      int up_above = 0, up_left = 0;
      if (enable_intra_edge_filter) {
        if (p_angle != 90 && p_angle != 180) {
          if (p_angle > 90 && p_angle < 180 && (w + h) >= 24) {
            int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
            left[-1] = above[-1] = (int16_t)v;
          }
          int ft = get_filter_type(plane);
          if (have_above) {
            int st = edge_strength(w, h, ft, p_angle - 90);
            int num = imin(w, max_x - x + 1) + (p_angle < 90 ? h : 0) + 1;
            edge_filter(above, num, st);
          }
          if (have_left) {
            int st = edge_strength(w, h, ft, p_angle - 180);
            int num = imin(h, max_y - y + 1) + (p_angle > 180 ? w : 0) + 1;
            edge_filter(left, num, st);
          }
          up_above = use_upsample(w, h, ft, p_angle - 90);
          if (up_above) edge_upsample(above, w + (p_angle < 90 ? h : 0));
          up_left = use_upsample(w, h, ft, p_angle - 180);
          if (up_left) edge_upsample(left, h + (p_angle > 180 ? w : 0));
        }
      }
      int dx = 0, dy = 0;
      if (p_angle < 90) dx = AV1_DR_INTRA_DERIVATIVE[p_angle];
      else if (p_angle > 90 && p_angle < 180) dx = AV1_DR_INTRA_DERIVATIVE[180 - p_angle];
      if (p_angle > 90 && p_angle < 180) dy = AV1_DR_INTRA_DERIVATIVE[p_angle - 90];
      else if (p_angle > 180) dy = AV1_DR_INTRA_DERIVATIVE[270 - p_angle];
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (p_angle < 90) {
            int id = (i + 1) * dx;
            int base = (id >> (6 - up_above)) + (j << up_above);
            int shift = ((id << up_above) >> 1) & 0x1F;
            int max_base = (w + h - 1) << up_above;
            if (base < max_base)
              v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
            else
              v = above[max_base];
          } else if (p_angle > 90 && p_angle < 180) {
            int id = (j << 6) - (i + 1) * dx;
            int base = id >> (6 - up_above);
            if (base >= -(1 << up_above)) {
              int shift = ((id * (1 << up_above)) >> 1) & 0x1F;
              v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
            } else {
              id = (i << 6) - (j + 1) * dy;
              base = id >> (6 - up_left);
              int shift = ((id * (1 << up_left)) >> 1) & 0x1F;
              v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
            }
          } else if (p_angle > 180) {
            int id = (j + 1) * dy;
            int base = (id >> (6 - up_left)) + (i << up_left);
            int shift = ((id << up_left) >> 1) & 0x1F;
            v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
          } else if (p_angle == 90) {
            v = above[j];
          } else {
            v = left[i];
          }
          pred[i][j] = (pixel)v;
        }
    } else if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
      const uint8_t* wx = AV1_SM_WEIGHTS + (w - 4);
      const uint8_t* wy = AV1_SM_WEIGHTS + (h - 4);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (mode == SMOOTH_PRED) {
            int s = wy[i] * above[j] + (256 - wy[i]) * left[h - 1] + wx[j] * left[i] +
                    (256 - wx[j]) * above[w - 1];
            v = round2(s, 9);
          } else if (mode == SMOOTH_V_PRED) {
            v = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
          } else {
            v = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
          }
          pred[i][j] = (pixel)v;
        }
    } else if (mode == DC_PRED) {
      int avg;
      if (have_above && have_left) {
        int sum = 0;
        for (int k = 0; k < h; k++) sum += left[k];
        for (int k = 0; k < w; k++) sum += above[k];
        sum += (w + h) >> 1;
        avg = sum / (w + h);
      } else if (have_left) {
        int sum = 0;
        for (int k = 0; k < h; k++) sum += left[k];
        avg = (sum + (h >> 1)) >> log2h;
      } else if (have_above) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += above[k];
        avg = (sum + (w >> 1)) >> log2w;
      } else {
        avg = base;
      }
      for (int i = 0; i < h; i++) std::fill(pred[i], pred[i] + w, (pixel)avg);
    } else {  // PAETH
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int base = above[j] + left[i] - above[-1];
          int p_left = std::abs(base - left[i]), p_top = std::abs(base - above[j]),
              p_tl = std::abs(base - above[-1]);
          int v;
          if (p_left <= p_top && p_left <= p_tl) v = left[i];
          else if (p_top <= p_tl) v = above[j];
          else v = above[-1];
          pred[i][j] = (pixel)v;
        }
    }
    for (int i = 0; i < h; i++) memcpy(pl.at(y + i, x), pred[i], w * sizeof(pixel));
  }

  void predict_cfl(int plane, int sx0, int sy0, int t) {
    int w = 1 << kTxW2[t], h = 1 << kTxH2[t];
    int alpha = plane == 1 ? cfl_alpha_u : cfl_alpha_v;
    static thread_local int L[64][64];
    int64_t avg = 0;
    Plane& luma = planes[0];
    for (int i = 0; i < h; i++) {
      int ly = imin(sy0 + i, (max_luma_h >> ssy) - 1) << ssy;
      for (int j = 0; j < w; j++) {
        int lx = imin(sx0 + j, (max_luma_w >> ssx) - 1) << ssx;
        int tt = 0;
        for (int dy = 0; dy <= ssy; dy++)
          for (int dx = 0; dx <= ssx; dx++) tt += *luma.at(ly + dy, lx + dx);
        int v = tt << (3 - ssx - ssy);
        L[i][j] = v;
        avg += v;
      }
    }
    int lavg = (int)round2l(avg, kTxW2[t] + kTxH2[t]);
    Plane& pl = planes[plane];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        pixel* px = pl.at(sy0 + i, sx0 + j);
        int scaled = round2signed(alpha * (L[i][j] - lavg), 6);
        *px = clip1(*px + scaled);
      }
  }

  // ---------------------------------------------------------- coefficients
  int plane_tx_set(int t) {
    int sq = tx_sqr(t), up = tx_sqr_up(t);
    if (up > TX_32X32) return 0;
    if (use_intrabc) {
      if (reduced_tx_set || up == TX_32X32) return TX_SET_INTER_3;
      return sq == TX_16X16 ? TX_SET_INTER_2 : TX_SET_INTER_1;
    }
    if (up == TX_32X32) return 0;
    if (reduced_tx_set) return 2;
    if (sq == TX_16X16) return 2;
    return 1;
  }

  int compute_tx_type(int plane, int t, int bx4, int by4) {
    if (lossless || tx_sqr_up(t) > TX_32X32) return DCT_DCT;
    int set = plane_tx_set(t);
    if (plane == 0) return tx_types[idx(by4, bx4)];
    int type = kModeToTxfm[uv_mode];
    if (use_intrabc)  // the luma type at the chroma block's position
      type = tx_types[idx(imax(mi_row, by4 << ssy), imax(mi_col, bx4 << ssx))];
    bool in_set;
    if (set == TX_SET_INTER_1) in_set = true;
    else if (set == TX_SET_INTER_2) in_set = type != V_ADST && type != H_ADST &&
                                             type != V_FLIPADST && type != H_FLIPADST;
    else if (set == TX_SET_INTER_3) in_set = type == IDTX || type == DCT_DCT;
    else if (set == 0) in_set = type == DCT_DCT;
    else if (set == 1) in_set = type == DCT_DCT || type == ADST_DCT || type == DCT_ADST ||
                                type == ADST_ADST || type == IDTX || type == V_DCT || type == H_DCT;
    else in_set = type == DCT_DCT || type == ADST_DCT || type == DCT_ADST ||
                  type == ADST_ADST || type == IDTX;
    return in_set ? type : DCT_DCT;
  }

  void read_tx_type(int x4, int y4, int t) {
    int set = plane_tx_set(t);
    int type = DCT_DCT;
    int q = seg_enabled ? get_qidx(1, segment_id) : base_q_idx;
    if (set > 0 && q > 0) {
      int dir = use_filter_intra ? kFilterIntraModeToIntraDir[filter_intra_mode] : y_mode;
      int sq = tx_sqr(t);
      if (set == 1) type = kTxTypeIntraInvSet1[sd.read(cdf.tx_set1[sq][dir], 7)];
      else if (set == 2) type = kTxTypeIntraInvSet2[sd.read(cdf.tx_set2[sq][dir], 5)];
      else if (set == TX_SET_INTER_1) type = kTxTypeInterInvSet1[sd.read(cdf.inter_set1[sq], 16)];
      else if (set == TX_SET_INTER_2) type = kTxTypeInterInvSet2[sd.read(cdf.inter_set2, 12)];
      else type = kTxTypeInterInvSet3[sd.read(cdf.inter_set3[sq], 2)];
    }
    set_tx_types(x4, y4, t, type);
  }
  void set_tx_types(int x4, int y4, int t, int type) {
    int w4 = 1 << (kTxW2[t] - 2), h4 = 1 << (kTxH2[t] - 2);
    for (int j = 0; j < h4; j++)
      for (int i = 0; i < w4; i++)
        if (y4 + j < mi_rows + 16 && x4 + i < mi_cols + 16)
          tx_types[idx(y4 + j, x4 + i)] = (uint8_t)type;
  }

  const uint16_t* get_scan(int t) {
    const Scans& s = scans();
    if (t == TX_16X64) return s.dflt[TX_16X32].data();
    if (t == TX_64X16) return s.dflt[TX_32X16].data();
    if (tx_sqr_up(t) == TX_64X64) return s.dflt[TX_32X32].data();
    if (plane_tx_type == IDTX) return s.dflt[t].data();
    bool prefer_row = plane_tx_type == V_DCT || plane_tx_type == V_ADST || plane_tx_type == V_FLIPADST;
    bool prefer_col = plane_tx_type == H_DCT || plane_tx_type == H_ADST || plane_tx_type == H_FLIPADST;
    if (prefer_row) return s.mrow[t].data();
    if (prefer_col) return s.mcol[t].data();
    return s.dflt[t].data();
  }

  int coeff_base_ctx(int t, int pos, int bwl, int txh) {
    int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    int cls = tx_class(plane_tx_type);
    for (int k = 0; k < 5; k++) {
      int rr = row + kSigRefDiffOffset[cls][k][0], cc = col + kSigRefDiffOffset[cls][k][1];
      if (rr >= 0 && cc >= 0 && rr < txh && cc < (1 << bwl))
        mag += imin(std::abs(quant[(rr << bwl) + cc]), 3);
    }
    int ctx = imin((mag + 1) >> 1, 4);
    if (cls == TX_CLASS_2D) {
      if (row == 0 && col == 0) return 0;
      int shape = kTxW2[t] == kTxH2[t] ? 0 : kTxW2[t] > kTxH2[t] ? 1 : 2;
      return ctx + kCoeffBaseCtxOffset[shape][imin(row, 4)][imin(col, 4)];
    }
    int id = cls == TX_CLASS_VERT ? row : col;
    return ctx + kCoeffBasePosCtxOffset[imin(id, 2)];
  }

  int coeff_br_ctx(int pos, int bwl, int txh) {
    int row = pos >> bwl, col = pos - (row << bwl);
    int txw = 1 << bwl;
    int mag = 0;
    int cls = tx_class(plane_tx_type);
    for (int k = 0; k < 3; k++) {
      int rr = row + kMagRefOffset[cls][k][0], cc = col + kMagRefOffset[cls][k][1];
      if (rr >= 0 && cc >= 0 && rr < txh && cc < txw) mag += imin(quant[rr * txw + cc], 15);
    }
    mag = imin((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (cls == TX_CLASS_2D) return (row < 2 && col < 2) ? mag + 7 : mag + 14;
    if (cls == TX_CLASS_HORIZ) return col == 0 ? mag + 7 : mag + 14;
    return row == 0 ? mag + 7 : mag + 14;
  }

  int coeffs(int plane, int start_x, int start_y, int t) {
    int x4 = start_x >> 2, y4 = start_y >> 2;
    int w4 = 1 << (kTxW2[t] - 2), h4 = 1 << (kTxH2[t] - 2);
    int tx_sz_ctx = (tx_sqr(t) + tx_sqr_up(t) + 1) >> 1;
    int ptype = plane > 0;
    int seg_eob = (t == TX_16X64 || t == TX_64X16) ? 512
                  : imin(1024, (1 << kTxW2[t]) * (1 << kTxH2[t]));
    memset(quant, 0, sizeof(int32_t) * seg_eob);
    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    int max_x4 = mi_cols >> sx, max_y4 = mi_rows >> sy;
    // all_zero context
    int ctx;
    int psz = residual_size(mi_size, plane);
    int bw = 1 << kBlockW2[psz], bh = 1 << kBlockH2[psz];
    int w = 1 << kTxW2[t], h = 1 << kTxH2[t];
    if (plane == 0) {
      int top = 0, left = 0;
      for (int k = 0; k < w4; k++) if (x4 + k < max_x4) top = imax(top, above_level[plane][x4 + k]);
      for (int k = 0; k < h4; k++) if (y4 + k < max_y4) left = imax(left, left_level[plane][y4 + k]);
      top = imin(top, 255);
      left = imin(left, 255);
      if (bw == w && bh == h) ctx = 0;
      else if (top == 0 && left == 0) ctx = 1;
      else if (top == 0 || left == 0) ctx = 2 + (imax(top, left) > 3);
      else if (imax(top, left) <= 3) ctx = 4;
      else if (imin(top, left) <= 3) ctx = 5;
      else ctx = 6;
    } else {
      int above = 0, left = 0;
      for (int i = 0; i < w4; i++)
        if (x4 + i < max_x4) above |= above_level[plane][x4 + i] | above_dc[plane][x4 + i];
      for (int i = 0; i < h4; i++)
        if (y4 + i < max_y4) left |= left_level[plane][y4 + i] | left_dc[plane][y4 + i];
      ctx = (above != 0) + (left != 0) + 7;
      if (bw * bh > w * h) ctx += 3;
    }
    int eob = 0, cul_level = 0, dc_category = 0;
    int all_zero = sd.read(cdf.txb_skip[tx_sz_ctx][ctx], 2);
    if (all_zero) {
      if (plane == 0) set_tx_types(x4, y4, t, DCT_DCT);
    } else {
      if (plane == 0) read_tx_type(x4, y4, t);
      plane_tx_type = compute_tx_type(plane, t, x4, y4);
      const uint16_t* scan = get_scan(t);
      int eob_multi = imin(kTxW2[t], 5) + imin(kTxH2[t], 5) - 4;
      int cls_ctx = tx_class(plane_tx_type) == TX_CLASS_2D ? 0 : 1;
      int eob_pt;
      switch (eob_multi) {
        case 0: eob_pt = sd.read(cdf.eob16[ptype][cls_ctx], 5); break;
        case 1: eob_pt = sd.read(cdf.eob32[ptype][cls_ctx], 6); break;
        case 2: eob_pt = sd.read(cdf.eob64[ptype][cls_ctx], 7); break;
        case 3: eob_pt = sd.read(cdf.eob128[ptype][cls_ctx], 8); break;
        case 4: eob_pt = sd.read(cdf.eob256[ptype][cls_ctx], 9); break;
        case 5: eob_pt = sd.read(cdf.eob512[ptype][0], 10); break;
        default: eob_pt = sd.read(cdf.eob1024[ptype][0], 11); break;
      }
      eob_pt += 1;
      eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
      int eob_shift = eob_pt - 3;
      if (eob_shift >= 0) {
        if (sd.read(cdf.eob_extra[tx_sz_ctx][ptype][eob_pt - 3], 2)) eob += 1 << eob_shift;
        for (int i = 1; i < imax(0, eob_pt - 2); i++) {
          eob_shift = imax(0, eob_pt - 2) - 1 - i;
          if (sd.literal(1)) eob += 1 << eob_shift;
        }
      }
      int adj = adjusted_tx_size(t);
      int bwl = kTxW2[adj], txh = 1 << kTxH2[adj], txw = 1 << bwl;
      for (int c = eob - 1; c >= 0; c--) {
        int pos = scan[c];
        int level;
        if (c == eob - 1) {
          int cctx;
          if (c == 0) cctx = 0;
          else if (c <= (txh * txw) / 8) cctx = 1;
          else if (c <= (txh * txw) / 4) cctx = 2;
          else cctx = 3;
          level = sd.read(cdf.base_eob[tx_sz_ctx][ptype][cctx], 3) + 1;
        } else {
          level = sd.read(cdf.base[tx_sz_ctx][ptype][coeff_base_ctx(t, pos, bwl, txh)], 4);
        }
        if (level > 2) {
          int bctx = coeff_br_ctx(pos, bwl, txh);
          for (int k = 0; k < 4; k++) {
            int br = sd.read(cdf.br[imin(tx_sz_ctx, 3)][ptype][bctx], 4);
            level += br;
            if (br < 3) break;
          }
        }
        quant[pos] = level;
      }
      for (int c = 0; c < eob; c++) {
        int pos = scan[c];
        int sign = 0;
        if (quant[pos] != 0) {
          if (c == 0) {
            int dcs = 0;
            for (int k = 0; k < w4; k++)
              if (x4 + k < max_x4) {
                int s = above_dc[plane][x4 + k];
                if (s == 1) dcs--;
                else if (s == 2) dcs++;
              }
            for (int k = 0; k < h4; k++)
              if (y4 + k < max_y4) {
                int s = left_dc[plane][y4 + k];
                if (s == 1) dcs--;
                else if (s == 2) dcs++;
              }
            int dctx = dcs < 0 ? 1 : dcs > 0 ? 2 : 0;
            sign = sd.read(cdf.dc_sign[ptype][dctx], 2);
          } else {
            sign = sd.literal(1);
          }
        }
        if (quant[pos] > 14) {
          int length = 0, bit;
          do {
            length++;
            bit = sd.literal(1);
            if (length > 32) throw NotYet("coefficient Golomb code longer than 32 bits");
          } while (!bit);
          uint32_t x = 1;
          for (int i = length - 2; i >= 0; i--) x = (x << 1) | (uint32_t)sd.literal(1);
          quant[pos] = (int32_t)((x + 14) & 0xFFFFFFFFu);
        }
        if (pos == 0 && quant[pos] > 0) dc_category = sign ? 1 : 2;
        quant[pos] &= 0xFFFFF;
        cul_level += quant[pos];
        if (sign) quant[pos] = -quant[pos];
      }
      cul_level = imin(63, cul_level);
    }
    for (int i = 0; i < w4; i++) {
      above_level[plane][x4 + i] = (uint8_t)cul_level;
      above_dc[plane][x4 + i] = (uint8_t)dc_category;
    }
    for (int i = 0; i < h4; i++) {
      left_level[plane][y4 + i] = (uint8_t)cul_level;
      left_dc[plane][y4 + i] = (uint8_t)dc_category;
    }
    return eob;
  }

  // ----------------------------------------------------- reconstruction
  void reconstruct(int plane, int x, int y, int t) {
    int dq_shift = ((1 << kTxW2[t]) * (1 << kTxH2[t]) > 256) +
                   ((1 << kTxW2[t]) * (1 << kTxH2[t]) > 1024);
    int log2w = kTxW2[t], log2h = kTxH2[t];
    int w = 1 << log2w, h = 1 << log2h;
    int tw = imin(32, w), th = imin(32, h);
    int q = get_qidx(0, segment_id);
    int dc_delta = plane == 0 ? dq_y_dc : plane == 1 ? dq_u_dc : dq_v_dc;
    int ac_delta = plane == 0 ? 0 : plane == 1 ? dq_u_ac : dq_v_ac;
    const int16_t* dc_lookup = bit_depth == 12 ? AV1_DC_QLOOKUP_12
                               : bit_depth == 10 ? AV1_DC_QLOOKUP_10 : AV1_DC_QLOOKUP;
    const int16_t* ac_lookup = bit_depth == 12 ? AV1_AC_QLOOKUP_12
                               : bit_depth == 10 ? AV1_AC_QLOOKUP_10 : AV1_AC_QLOOKUP;
    int dc_q = dc_lookup[clip3(0, 255, q + dc_delta)];
    int ac_q = ac_lookup[clip3(0, 255, q + ac_delta)];
    // the quantizer matrix of a 2-D transform (not IDTX or the 1-D
    // identities, not a lossless block's WHT) at a level below 15: aom's
    // table holds the matrix of the coded size column by column
    const uint8_t* qm = nullptr;
    int level = qm_level[plane];
    if (!lossless && level < 15 && plane_tx_type < IDTX)
      qm = AV1_QUANTIZER_MATRIX + ((size_t)level * 2 + (plane > 0)) * 3344 +
           kQmOffset[adjusted_tx_size(t)];
    static thread_local int32_t R[64][64];
    // dequantised coefficients and the row transforms' inputs in BitDepth
    // + 8 bits, the column transforms' in Max(BitDepth + 6, 16)
    const int32_t lo = -(1 << (bit_depth + 7)), hi = (1 << (bit_depth + 7)) - 1;
    const int32_t clo = -(1 << imax(bit_depth + 5, 15)), chi = (1 << imax(bit_depth + 5, 15)) - 1;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) R[i][j] = 0;
    for (int i = 0; i < th; i++)
      for (int j = 0; j < tw; j++) {
        int32_t cq = quant[i * tw + j];
        if (!cq) continue;
        int qv = (i == 0 && j == 0) ? dc_q : ac_q;
        if (qm) qv = round2(qv * qm[j * th + i], 5);
        int64_t dq = ((int64_t)std::abs(cq) * qv) & 0xFFFFFF;
        dq >>= dq_shift;
        if (cq < 0) dq = -dq;
        R[i][j] = (int32_t)std::max<int64_t>(lo, std::min<int64_t>(hi, dq));
      }
    int type = plane_tx_type;
    int32_t T[64];
    Tx1D tx{T};
    const int row_bits = bit_depth + 8, col_bits = imax(bit_depth + 6, 16);
    if (lossless) {
      tx.set_range(row_bits, bit_depth);
      for (int i = 0; i < 4; i++) {
        for (int j = 0; j < 4; j++) T[j] = R[i][j];
        tx.wht(2);
        for (int j = 0; j < 4; j++) R[i][j] = T[j];
      }
      tx.set_range(col_bits, bit_depth);
      for (int j = 0; j < 4; j++) {
        for (int i = 0; i < 4; i++) T[i] = R[i][j];
        tx.wht(0);
        for (int i = 0; i < 4; i++) R[i][j] = T[i];
      }
    } else {
      tx.set_range(row_bits, bit_depth);
      int row_shift = kTransformRowShift[t];
      int hk = kHorzKind[type], vk = kVertKind[type];
      for (int i = 0; i < imin(32, h); i++) {
        for (int j = 0; j < w; j++) T[j] = (j < 32) ? R[i][j] : 0;
        if (std::abs(log2w - log2h) == 1)
          for (int j = 0; j < w; j++) T[j] = (int32_t)round2l((int64_t)T[j] * 2896, 12);
        for (int j = 0; j < w; j++) T[j] = std::max(lo, std::min(hi, T[j]));
        tx.run(hk, log2w);
        for (int j = 0; j < w; j++) R[i][j] = std::max(clo, std::min(chi, round2(T[j], row_shift)));
      }
      for (int i = 32; i < h; i++)
        for (int j = 0; j < w; j++) R[i][j] = 0;
      tx.set_range(col_bits, bit_depth);
      for (int j = 0; j < w; j++) {
        for (int i = 0; i < h; i++) T[i] = R[i][j];
        tx.run(vk, log2h);
        for (int i = 0; i < h; i++) R[i][j] = round2(T[i], 4);
      }
    }
    // data a conformant encoder never makes: dav1d's C and SIMD transforms
    // give it different pixels, so there is no one answer to match
    if (tx.oob) throw NotYet("coefficients past the spec's ranges (non-conformant data)", true);
    Plane& pl = planes[plane];
    for (int i = 0; i < h; i++) {
      pixel* row = pl.at(y + i, x);
      for (int j = 0; j < w; j++) row[j] = clip1(row[j] + R[i][j]);
    }
  }

  // ====================================================== in-loop filters
  // deblocking in place, then CDEF and loop restoration out of place
  // (spec §7.14, §7.15, §7.17); `pre` keeps the deblocked frame, which
  // CDEF reads and loop restoration takes its stripes' borders from
  Plane pre[3];

  void loop_filters() {
    if (lf_level[0] || lf_level[1]) deblock();
    bool cdef_on = enable_cdef && !coded_lossless && !allow_intrabc;
    if (cdef_on || uses_lr)
      for (int p = 0; p < num_planes(); p++) pre[p] = planes[p];
    if (cdef_on) cdef();
    if (upscaled_w != coded_w) upscale();
    if (uses_lr)
      for (int p = 0; p < 3; p++)
        if (lr_type[p] != RESTORE_NONE) restore_plane(p);
  }

  // ------------------------------------------------------------ superres
  // the upscaling process (spec §7.16, dav1d's resize_c) of whole rows:
  // each output column's 8 taps of Upscale_Filter (dav1d's resize filter,
  // negated) at its 1/64 position, over the decoded columns clamped to
  // [0, MiCols * 4 >> subX), rounded by 7 bits and clipped. The step and
  // the first position are in 1/16384 samples (SUPERRES_SCALE_BITS 14;
  // the filter's phase drops SUPERRES_EXTRA_BITS 8 of them)
  struct Upscale {
    std::vector<int> first;  // each output column's leftmost source column
    std::vector<const int8_t*> taps;
    int src_w = 0;
  };
  Upscale upscale_of(int p) const {
    const int sx = p ? ssx : 0;
    const int down = (coded_w + sx) >> sx, up = (upscaled_w + sx) >> sx;
    const int step = ((down << 14) + (up >> 1)) / up;
    const int err = up * step - (down << 14);
    int x0 = (-((up - down) << 13) + (up >> 1)) / up + 128 - err / 2;
    x0 &= 0x3FFF;
    Upscale u;
    u.src_w = (mi_cols * 4) >> sx;
    u.first.resize(up);
    u.taps.resize(up);
    for (int x = 0; x < up; x++) {
      int pos = -(1 << 14) + x0 + x * step;
      u.first[x] = (pos >> 14) - 3;
      u.taps[x] = AV1_RESIZE_FILTER + 8 * ((pos & 0x3FFF) >> 8);
    }
    return u;
  }
  void upscale_row(const Upscale& u, const pixel* src, pixel* dst) const {
    const int up = (int)u.first.size(), last = u.src_w - 1, mx = pixel_max();
    for (int x = 0; x < up; x++) {
      const int8_t* f = u.taps[x];
      const int s0 = u.first[x];
      int sum = 0;
      if (s0 >= 0 && s0 + 7 <= last) {
        const pixel* s = src + s0;
        for (int k = 0; k < 8; k++) sum -= f[k] * s[k];
      } else {
        for (int k = 0; k < 8; k++) sum -= f[k] * src[clip3(0, last, s0 + k)];
      }
      dst[x] = (pixel)clip3(0, mx, (sum + 64) >> 7);
    }
  }
  // the planes, the output of CDEF (or of deblocking), at the upscaled
  // width; loop restoration upscales the rows of `pre` it reads. (Its own
  // member: with this loop inside loop_filters(), g++ compiled deblocking
  // and CDEF 1.3 x slower for frames without superres, decode_ab.py)
  void upscale() {
    for (int p = 0; p < num_planes(); p++) upscale_plane(p);
    frame_w = upscaled_w;
  }
  void upscale_plane(int p) {
    const Upscale u = upscale_of(p);
    Plane& src = planes[p];
    Plane dst;
    dst.w = dst.stride = (int)u.first.size();
    dst.h = src.h;
    dst.px.assign((size_t)dst.stride * dst.h, 0);
    in_bands(src.h, threads, [&](int y0, int y1) {
      for (int y = y0; y < y1; y++) upscale_row(u, src.at(y, 0), dst.at(y, 0));
    });
    src = std::move(dst);
  }

  // ----------------------------------------------------------- film grain
  // the film grain synthesis process (spec §7.18.3), on the output planes
  // as dav1d applies it for libavif (whose settings keep dav1d's default
  // apply_grain): the grain templates from the 16-bit LFSR and the
  // Gaussian sequence with their auto-regressive filter, then stripe by
  // stripe of 32 luma rows the 32 x 32 blocks of noise at random offsets,
  // blended over their overlaps, scaled by the planes' lookups and added,
  // chroma first (it reads the luma without grain). At BitDepth the
  // Gaussian sequence is rounded by 12 - BitDepth + grain_scale_shift bits,
  // the grain's range and the clips widen by BitDepth - 8 bits, and the
  // scaling lookup is interpolated between its 256 points (dav1d's
  // generate_scaling, the spec's scale_lut)
  uint16_t fg_rnd = 0;
  int fg_random(int bits) {
    uint32_t r = fg_rnd;
    uint32_t bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    r = (r >> 1) | (bit << 15);
    fg_rnd = (uint16_t)r;
    return (int)((r >> (16 - bits)) & ((1u << bits) - 1));
  }

  void film_grain() {
    if (!fg.apply) return;
    const int W = frame_w, H = frame_h, np = num_planes(), bd8 = bit_depth - 8;
    const int gmin = -(128 << bd8), gmax = (128 << bd8) - 1;
    // the templates: luma 73 x 82, chroma (38 or 73) x (44 or 82)
    static thread_local int16_t grain[3][73][82];
    int shift = 4 - bd8 + fg.grain_scale_shift;
    int lag = fg.ar_lag;
    fg_rnd = (uint16_t)fg.seed;
    for (int y = 0; y < 73; y++)
      for (int x = 0; x < 82; x++)
        grain[0][y][x] = (int16_t)(fg.num[0] ? round2(AV1_GAUSSIAN_SEQUENCE[fg_random(11)], shift) : 0);
    for (int y = 3; y < 73; y++)
      for (int x = 3; x < 82 - 3; x++) {
        int sum = 0, pos = 0;
        for (int dr = -lag; dr <= 0; dr++)
          for (int dc = -lag; dc <= lag; dc++) {
            if (dr == 0 && dc == 0) break;
            sum += grain[0][y + dr][x + dc] * fg.ar[0][pos++];
          }
        grain[0][y][x] = (int16_t)clip3(gmin, gmax, grain[0][y][x] + round2(sum, fg.ar_shift));
      }
    int cw = ssx ? 44 : 82, ch = ssy ? 38 : 73;
    for (int p = 1; p < np; p++) {
      bool on = fg.num[p] || fg.cfl;
      fg_rnd = (uint16_t)(fg.seed ^ (p == 1 ? 0xb524 : 0x49d8));
      for (int y = 0; y < ch; y++)
        for (int x = 0; x < cw; x++)
          grain[p][y][x] = (int16_t)(on ? round2(AV1_GAUSSIAN_SEQUENCE[fg_random(11)], shift) : 0);
      if (!on) continue;
      for (int y = 3; y < ch; y++)
        for (int x = 3; x < cw - 3; x++) {
          int sum = 0, pos = 0;
          for (int dr = -lag; dr <= 0; dr++)
            for (int dc = -lag; dc <= lag; dc++) {
              int c = fg.ar[p][pos];
              if (dr == 0 && dc == 0) {
                if (fg.num[0]) {
                  int luma = 0, ly = ((y - 3) << ssy) + 3, lx = ((x - 3) << ssx) + 3;
                  for (int i = 0; i <= ssy; i++)
                    for (int j = 0; j <= ssx; j++) luma += grain[0][ly + i][lx + j];
                  sum += round2(luma, ssx + ssy) * c;
                }
                break;
              }
              sum += c * grain[p][y + dr][x + dc];
              pos++;
            }
          grain[p][y][x] = (int16_t)clip3(gmin, gmax, grain[p][y][x] + round2(sum, fg.ar_shift));
        }
    }
    // the scaling lookups (chroma from luma's points with chroma_scaling_from_luma)
    const int lut_size = 1 << bit_depth, pad = 1 << bd8;
    std::vector<uint8_t> lut_store(3 * (size_t)lut_size);
    uint8_t* lut[3] = {&lut_store[0], &lut_store[lut_size], &lut_store[2 * (size_t)lut_size]};
    for (int p = 0; p < np; p++) {
      int src = p == 0 || fg.cfl ? 0 : p, n = fg.num[src];
      const int (*pts)[2] = fg.points[src];
      if (!n) continue;
      uint8_t* l = lut[p];
      for (int x = 0; x < pts[0][0] << bd8; x++) l[x] = (uint8_t)pts[0][1];
      for (int i = 0; i < n - 1; i++) {
        int dy = pts[i + 1][1] - pts[i][1], dx = pts[i + 1][0] - pts[i][0];
        int delta = dy * ((65536 + (dx >> 1)) / dx);
        for (int x = 0; x < dx; x++) l[(pts[i][0] + x) << bd8] = (uint8_t)(pts[i][1] + ((x * delta + 32768) >> 16));
      }
      for (int x = pts[n - 1][0] << bd8; x < lut_size; x++) l[x] = (uint8_t)pts[n - 1][1];
      for (int i = 0; bd8 && i < n - 1; i++)
        for (int x = pts[i][0] << bd8; x < pts[i + 1][0] << bd8; x += pad) {
          int range = l[x + pad] - l[x];
          for (int k = 1, r = pad >> 1; k < pad; k++) {
            r += range;
            l[x + k] = (uint8_t)(l[x] + (r >> bd8));
          }
        }
    }
    int min_v = fg.clip ? 16 << bd8 : 0, max_luma = fg.clip ? 235 << bd8 : pixel_max();
    int max_chroma = fg.clip ? (matrix == 0 ? 235 : 240) << bd8 : pixel_max();
    // the noise stripes of this and the previous 32 luma rows: [plane][row][column]
    int half = (W + 1) / 2, sw = 2 * (half + 16) + 34;
    std::vector<int16_t> cur(3 * 34 * (size_t)sw), prev(cur.size());
    auto at = [&](std::vector<int16_t>& v, int p, int i, int x) -> int16_t& {
      return v[((size_t)p * 34 + i) * sw + x];
    };
    std::vector<int16_t> noise(sw);
    for (int y0 = 0, num = 0; y0 < half; y0 += 16, num++) {
      fg_rnd = (uint16_t)(fg.seed ^ (((num * 37 + 178) & 255) << 8) ^ ((num * 173 + 105) & 255));
      for (int x = 0; x < half; x += 16) {
        int r = fg_random(8), offx = r >> 4, offy = r & 15;
        for (int p = 0; p < np; p++) {
          int psx = p ? ssx : 0, psy = p ? ssy : 0;
          int ox = psx ? 6 + offx : 9 + offx * 2, oy = psy ? 6 + offy : 9 + offy * 2;
          for (int i = 0; i < (34 >> psy); i++)
            for (int j = 0; j < (34 >> psx); j++) {
              int g = grain[p][oy + i][ox + j];
              int col = psx ? x + j : x * 2 + j;
              if (fg.overlap && x > 0 && j < (psx ? 1 : 2)) {
                int old = at(cur, p, i, col);
                if (psx) g = old * 23 + g * 22;
                else g = j == 0 ? old * 27 + g * 17 : old * 17 + g * 27;
                g = clip3(gmin, gmax, round2(g, 5));
              }
              at(cur, p, i, col) = (int16_t)g;
            }
        }
      }
      // this stripe's rows: chroma first, over the luma without grain
      for (int p = np - 1; p >= 0; p--) {
        int psx = p ? ssx : 0, psy = p ? ssy : 0;
        if (p ? !(fg.num[p] || fg.cfl) : !fg.num[0]) continue;
        int rows = 32 >> psy, pw = (W + psx) >> psx, ph = (H + psy) >> psy;
        for (int i = 0; i < rows; i++) {
          int y = num * rows + i;
          if (y >= ph) break;
          for (int x = 0; x < pw; x++) {
            int g = at(cur, p, i, x);
            if (fg.overlap && num > 0 && i < (psy ? 1 : 2)) {
              int old = at(prev, p, i + rows, x);
              if (psy) g = old * 23 + g * 22;
              else g = i == 0 ? old * 27 + g * 17 : old * 17 + g * 27;
              g = clip3(gmin, gmax, round2(g, 5));
            }
            noise[x] = (int16_t)g;
          }
          pixel* row = planes[p].at(y, 0);
          if (p == 0) {
            for (int x = 0; x < pw; x++) {
              int orig = row[x];
              row[x] = (pixel)clip3(min_v, max_luma, orig + round2(lut[0][orig] * noise[x], fg.scaling_shift));
            }
            continue;
          }
          const pixel* luma = planes[0].at(y << psy, 0);
          for (int x = 0; x < pw; x++) {
            int lx = x << psx;
            int avg = psx ? round2(luma[lx] + luma[imin(lx + 1, W - 1)], 1) : luma[lx];
            int orig = row[x], merged = avg;
            if (!fg.cfl)
              merged = clip1(((avg * fg.luma_mult[p] + orig * fg.mult[p]) >> 6) + fg.offset[p] * (1 << bd8));
            row[x] = (pixel)clip3(min_v, max_chroma,
                                    orig + round2(lut[p][merged] * noise[x], fg.scaling_shift));
          }
        }
      }
      std::swap(cur, prev);
    }
  }

  // ----------------------------------------------------------- deblocking
  // the adaptive filter strength of the block at mi (r, c)
  int lf_level_of(int r, int c, int plane, int pass) {
    int i = plane == 0 ? pass : plane + 1;
    int m = idx(r, c);
    int lvl = clip3(0, 63, delta_lfs[4 * m + (delta_lf_multi ? i : 0)] + lf_level[i]);
    int seg = seg_ids[m];
    if (seg_enabled && feature_enabled[seg][1 + i]) lvl = clip3(0, 63, lvl + feature_data[seg][1 + i]);
    // an intra block adds the INTRA_FRAME reference delta
    if (lf_delta_enabled) lvl = clip3(0, 63, lvl + lf_ref_deltas[0] * (1 << (lvl >> 5)));
    return lvl;
  }

  void deblock() {
    for (int plane = 0; plane < 3; plane++) {
      if (plane && !lf_level[plane + 1]) continue;
      int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
      for (int pass = 0; pass < 2; pass++)  // vertical edges, then horizontal
        for (int r = 0; r < mi_rows; r += 1 << sy)
          for (int c = 0; c < mi_cols; c += 1 << sx) lf_edge(plane, pass, r, c);
    }
  }

  void lf_edge(int plane, int pass, int r, int c) {
    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    int x = c * 4, y = r * 4;
    if (x >= frame_w || y >= frame_h || (pass ? y : x) == 0) return;
    int row = r | sy, col = c | sx;
    int xp = x >> sx, yp = y >> sy;
    int prev_row = pass ? row - (1 << sy) : row, prev_col = pass ? col : col - (1 << sx);
    int ts = lf_tx_sizes[plane][idx(row >> sy, col >> sx)];
    int prev_ts = lf_tx_sizes[plane][idx(prev_row >> sy, prev_col >> sx)];
    // every transform edge of an intra frame is filtered
    int log2 = pass ? kTxH2[ts] : kTxW2[ts];
    if ((pass ? yp : xp) & ((1 << log2) - 1)) return;
    int size = imin(plane ? 8 : 16, 1 << imin(log2, pass ? kTxH2[prev_ts] : kTxW2[prev_ts]));
    int lvl = lf_level_of(row, col, plane, pass);
    if (!lvl) lvl = lf_level_of(prev_row, prev_col, plane, pass);
    if (!lvl) return;
    int shift = lf_sharpness > 4 ? 2 : lf_sharpness > 0 ? 1 : 0;
    int limit = lf_sharpness > 0 ? clip3(1, 9 - lf_sharpness, lvl >> shift) : imax(1, lvl >> shift);
    int blimit = 2 * (lvl + 2) + limit, thresh = lvl >> 4;
    Plane& pl = planes[plane];
    ptrdiff_t across = pass ? pl.stride : 1, along = pass ? 1 : pl.stride;
    pixel* q0 = pl.at(yp, xp);
    int bd8 = bit_depth - 8;
    for (int i = 0; i < 4; i++)
      lf_sample(q0 + i * along, across, plane, size, limit << bd8, blimit << bd8, thresh << bd8, bd8);
  }

  // the masks and filters of one sample position; s points at q0, p_k is
  // s[-(k + 1) * st], q_k s[k * st]; the limits come scaled to BitDepth,
  // and bd8 = BitDepth - 8 scales the flatness test and the narrow filter
  static void lf_sample(pixel* s, ptrdiff_t st, int plane, int size, int limit, int blimit,
                        int thresh, int bd8) {
    auto P = [&](int k) -> int { return s[-(k + 1) * st]; };
    auto Q = [&](int k) -> int { return s[k * st]; };
    int p0 = P(0), p1 = P(1), q0 = Q(0), q1 = Q(1);
    int len = size == 4 ? 4 : plane ? 6 : size == 8 ? 8 : 16;
    if (std::abs(p1 - p0) > limit || std::abs(q1 - q0) > limit ||
        std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > blimit)
      return;
    int p2 = 0, q2 = 0, p3 = 0, q3 = 0;
    if (len >= 6) {
      p2 = P(2);
      q2 = Q(2);
      if (std::abs(p2 - p1) > limit || std::abs(q2 - q1) > limit) return;
    }
    if (len >= 8) {
      p3 = P(3);
      q3 = Q(3);
      if (std::abs(p3 - p2) > limit || std::abs(q3 - q2) > limit) return;
    }
    bool hev = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
    bool flat = false, flat2 = false;
    const int one = 1 << bd8;
    if (size >= 8) {
      flat = std::abs(p1 - p0) <= one && std::abs(q1 - q0) <= one && std::abs(p2 - p0) <= one &&
             std::abs(q2 - q0) <= one;
      if (len >= 8) flat = flat && std::abs(p3 - p0) <= one && std::abs(q3 - q0) <= one;
    }
    if (size >= 16) {
      flat2 = true;
      for (int k = 4; k <= 6; k++)
        flat2 = flat2 && std::abs(P(k) - p0) <= one && std::abs(Q(k) - q0) <= one;
    }
    if (size == 4 || !flat) {  // the narrow filter
      const int half = 128 << bd8;
      auto c4 = [half](int v) { return clip3(-half, half - 1, v); };
      int ps1 = p1 - half, ps0 = p0 - half, qs0 = q0 - half, qs1 = q1 - half;
      int f = hev ? c4(ps1 - qs1) : 0;
      f = c4(f + 3 * (qs0 - ps0));
      int f1 = c4(f + 4) >> 3, f2 = c4(f + 3) >> 3;
      s[0] = (pixel)(c4(qs0 - f1) + half);
      s[-st] = (pixel)(c4(ps0 + f2) + half);
      if (!hev) {
        f = round2(f1, 1);
        s[st] = (pixel)(c4(qs1 - f) + half);
        s[-2 * st] = (pixel)(c4(ps1 + f) + half);
      }
      return;
    }
    // the wide filters: 8 (luma) or 6 (chroma) taps, or 13 taps
    int log2 = size == 8 || !flat2 ? 3 : 4;
    int n = log2 == 4 ? 6 : plane == 0 ? 3 : 2;
    int n2 = log2 == 3 && plane == 0 ? 0 : 1;
    int F[16], out[12];
    for (int k = -(n + 1); k <= n; k++) F[k + 8] = s[k * st];
    for (int i = -n; i < n; i++) {
      int t = 0;
      for (int j = -n; j <= n; j++) t += F[clip3(-(n + 1), n, i + j) + 8] * (std::abs(j) <= n2 ? 2 : 1);
      out[i + n] = round2(t, log2);
    }
    for (int i = -n; i < n; i++) s[i * st] = (pixel)out[i + n];
  }

  // ----------------------------------------------------------------- CDEF
  // Cdef_Directions from aom's padded offsets y * 144 + x (directions 6, 7,
  // 0 ... 7, 0, 1): [direction][tap][dy, dx]
  struct CdefDirs {
    int d[8][2][2];
    CdefDirs() {
      for (int dir = 0; dir < 8; dir++)
        for (int k = 0; k < 2; k++) {
          int off = AV1_CDEF_DIRECTIONS[(2 + dir) * 2 + k];
          int dy = (off + 72 + 144 * 4) / 144 - 4;
          d[dir][k][0] = dy;
          d[dir][k][1] = off - dy * 144;
        }
    }
  };
  static const CdefDirs& cdef_dirs() {
    static const CdefDirs dirs;
    return dirs;
  }

  void cdef() {
    for (int r = 0; r < mi_rows; r += 2)
      for (int c = 0; c < mi_cols; c += 2) {
        int id = cdef_at(r, c);
        if (id == -1) continue;
        if (skips[idx(r, c)] && skips[idx(r + 1, c)] && skips[idx(r, c + 1)] && skips[idx(r + 1, c + 1)])
          continue;
        // the strengths and damping scaled by BitDepth - 8 (coeffShift)
        int var = 0, ydir = cdef_direction(r, c, &var), bd8 = bit_depth - 8;
        int pri = cdef_strengths[id][0][0] << bd8, sec = cdef_strengths[id][0][1] << bd8;
        int dir = pri ? ydir : 0;
        int var_str = (var >> 6) ? imin(floorlog2((uint32_t)(var >> 6)), 12) : 0;
        pri = var ? (pri * (4 + var_str) + 8) >> 4 : 0;
        cdef_filter(0, r, c, pri, sec, cdef_damping + bd8, dir);
        pri = cdef_strengths[id][1][0] << bd8;
        sec = cdef_strengths[id][1][1] << bd8;
        // Cdef_Uv_Dir: the identity on 4:2:0 and 4:4:4
        dir = !pri ? 0 : ssx == ssy ? ydir : AV1_CDEF_UV_DIR[(ssx ? 8 : 0) + ydir];
        for (int p = 1; p < num_planes(); p++) cdef_filter(p, r, c, pri, sec, cdef_damping - 1 + bd8, dir);
      }
  }

  // the direction of the deblocked luma 8x8 at mi (r, c), and its variance
  int cdef_direction(int r, int c, int* var) {
    int64_t cost[8] = {0};
    int partial[8][15] = {{0}};
    const Plane& pl = pre[0];
    for (int i = 0; i < 8; i++) {
      const pixel* row = pl.px.data() + (size_t)(r * 4 + i) * pl.stride + c * 4;
      for (int j = 0; j < 8; j++) {
        int x = (row[j] >> (bit_depth - 8)) - 128;
        partial[0][i + j] += x;
        partial[1][i + j / 2] += x;
        partial[2][i] += x;
        partial[3][3 + i - j / 2] += x;
        partial[4][7 + i - j] += x;
        partial[5][3 - i / 2 + j] += x;
        partial[6][j] += x;
        partial[7][i / 2 + j] += x;
      }
    }
    const int32_t* div = AV1_CDEF_DIV_TABLE;
    auto sq = [](int v) { return (int64_t)v * v; };
    for (int i = 0; i < 8; i++) {
      cost[2] += sq(partial[2][i]);
      cost[6] += sq(partial[6][i]);
    }
    cost[2] *= div[8];
    cost[6] *= div[8];
    for (int i = 0; i < 7; i++) {
      cost[0] += (sq(partial[0][i]) + sq(partial[0][14 - i])) * div[i + 1];
      cost[4] += (sq(partial[4][i]) + sq(partial[4][14 - i])) * div[i + 1];
    }
    cost[0] += sq(partial[0][7]) * div[8];
    cost[4] += sq(partial[4][7]) * div[8];
    for (int i = 1; i < 8; i += 2) {
      for (int j = 0; j < 5; j++) cost[i] += sq(partial[i][3 + j]);
      cost[i] *= div[8];
      for (int j = 0; j < 3; j++)
        cost[i] += (sq(partial[i][j]) + sq(partial[i][10 - j])) * div[2 * j + 2];
    }
    int64_t best = 0;
    int dir = 0;
    for (int i = 0; i < 8; i++)
      if (cost[i] > best) {
        best = cost[i];
        dir = i;
      }
    *var = (int)((best - cost[(dir + 4) & 7]) >> 10);
    return dir;
  }

  // constrain() with the damping shift of its threshold worked out
  static int constrain(int diff, int threshold, int adj) {
    int v = imin(std::abs(diff), imax(0, threshold - (std::abs(diff) >> adj)));
    return diff < 0 ? -v : v;
  }

  // one 8x8 (luma) block of `plane` from the deblocked frame into planes.
  // Taps outside the frame's mi grid are not available: the block and a
  // border of 2 are copied into `px` with kCdefLarge there, which
  // constrain() maps to 0 and the clip's maximum skips (as libaom's
  // CDEF_VERY_LARGE). Zero strengths leave the block as it is.
  static constexpr int kCdefLarge = 30000;

  void cdef_filter(int plane, int r, int c, int pri, int sec, int damping, int dir) {
    if (!pri && !sec) return;
    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy, w = 8 >> sx, h = 8 >> sy;
    int pw = (mi_cols * 4) >> sx, ph = (mi_rows * 4) >> sy;
    const Plane& src = pre[plane];
    Plane& dst = planes[plane];
    const int S = 12;  // the stride of px
    int px[12 * 12];
    for (int i = 0; i < h + 4; i++)
      for (int j = 0; j < S; j++) {  // chroma reads whole rows too
        int y = y0 + i - 2, x = x0 + j - 2;
        px[i * S + j] = y < 0 || y >= ph || x < 0 || x >= pw
                            ? kCdefLarge : src.px[(size_t)y * src.stride + x];
      }
    const int32_t* pri_taps = AV1_CDEF_PRI_TAPS + 2 * ((pri >> (bit_depth - 8)) & 1);
    int pri_adj = pri ? imax(0, damping - floorlog2((uint32_t)pri)) : 0;
    int sec_adj = sec ? imax(0, damping - floorlog2((uint32_t)sec)) : 0;
    const CdefDirs& dirs = cdef_dirs();
    int off[3][2];  // the primary, then the two secondary directions
    const int ds[3] = {dir, (dir - 2) & 7, (dir + 2) & 7};
    for (int d = 0; d < 3; d++)
      for (int k = 0; k < 2; k++) off[d][k] = dirs.d[ds[d]][k][0] * S + dirs.d[ds[d]][k][1];
    // tap by tap over the block's pixels, 8 a row (chroma's last 4 unused)
    int v[64], sum[64], mx[64], mn[64];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < 8; j++) {
        int n = i * 8 + j;
        v[n] = mx[n] = mn[n] = px[(i + 2) * S + j + 2];
        sum[n] = 0;
      }
    for (int k = 0; k < 2; k++)
      for (int sign = -1; sign <= 1; sign += 2)
        for (int d = 0; d < 3; d++) {
          int o = sign * off[d][k];
          int strength = d ? sec : pri, adj = d ? sec_adj : pri_adj;
          int tap = strength ? (d ? AV1_CDEF_SEC_TAPS[k] : pri_taps[k]) : 0;
          for (int i = 0; i < h; i++)
            for (int j = 0; j < 8; j++) {
              int n = i * 8 + j;
              int p = px[(i + 2) * S + j + 2 + o];
              sum[n] += tap * constrain(p - v[n], strength, adj);
              mx[n] = imax(p == kCdefLarge ? mx[n] : p, mx[n]);
              mn[n] = imin(p, mn[n]);
            }
        }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int n = i * 8 + j;
        *dst.at(y0 + i, x0 + j) = (pixel)clip3(mn[n], mx[n], v[n] + ((8 + sum[n] - (sum[n] < 0)) >> 4));
      }
  }

  // ----------------------------------------------------- loop restoration
  // By stripes of 64 luma rows, offset 8 rows up: each stripe's rows of
  // CDEF's output, and two rows of the deblocked frame above and below it
  // (the rows the spec's get_source_sample reads, clamped to the plane's
  // true size), are copied into `buf` with 3 columns of extension, then
  // each restoration unit of the stripe filters its columns into planes.
  static constexpr int kLrMargin = 4;  // columns of `buf` left of x = 0

  void restore_plane(int p) {
    int sx = p ? ssx : 0, sy = p ? ssy : 0;
    int pw = (frame_w + sx) >> sx, ph = (frame_h + sy) >> sy;
    int unit = lr_size[p], bw = pw + 2 * kLrMargin;
    std::vector<pixel> buf((size_t)bw * ((64 >> sy) + 6));
    // under superres, the deblocked rows are upscaled as they are read
    const bool narrow = upscaled_w != coded_w;
    const Upscale u = narrow ? upscale_of(p) : Upscale();
    for (int k = 0; k * 64 - 8 < frame_h; k++) {
      int start = (k * 64 - 8) >> sy, end = start + (64 >> sy) - 1;  // StripeStartY / EndY
      int y0 = imax(0, start), y1 = imin(ph, end + 1);
      for (int yy = y0 - 3; yy < y1 + 3; yy++) {
        int y = clip3(0, ph - 1, yy);
        const Plane* src = &planes[p];
        if (y < start) {
          y = imax(start - 2, y);
          src = &pre[p];
        } else if (y > end) {
          y = imin(end + 2, y);
          src = &pre[p];
        }
        const pixel* s = src->px.data() + (size_t)y * src->stride;
        pixel* row = &buf[(size_t)(yy - y0 + 3) * bw + kLrMargin];
        if (narrow && src == &pre[p]) upscale_row(u, s, row);
        else memcpy(row, s, pw * sizeof(pixel));
        for (int x = 1; x <= kLrMargin; x++) {
          row[-x] = row[0];
          row[pw - 1 + x] = row[pw - 1];
        }
      }
      int unit_row = imin(lr_rows[p] - 1, ((imax(0, k * 64 - 8) + 8) >> sy) / unit);
      for (int uc = 0; uc < lr_cols[p]; uc++) {
        int x0 = uc * unit, x1 = uc == lr_cols[p] - 1 ? pw : (uc + 1) * unit;
        const LrUnit& u = lr_units[p][(size_t)unit_row * lr_cols[p] + uc];
        // buf's sample at (row y0 + i, column x0 + j)
        const pixel* at = &buf[(size_t)3 * bw + kLrMargin + x0];
        if (u.type == RESTORE_WIENER)
          lr_wiener(u, at, bw, x1 - x0, y1 - y0, planes[p].at(y0, x0), planes[p].stride);
        else if (u.type == RESTORE_SGRPROJ)
          lr_sgrproj(u, at, bw, x1 - x0, y1 - y0, y0, planes[p].at(y0, x0), planes[p].stride);
      }
    }
  }

  // the Wiener filter: 7 taps, the centre tap 128 less twice the others
  void lr_wiener(const LrUnit& u, const pixel* src, int bw, int w, int h, pixel* dst,
                 int stride) const {
    int f[2][7];
    for (int pass = 0; pass < 2; pass++) {
      f[pass][3] = 128;
      for (int i = 0; i < 3; i++) {
        f[pass][i] = f[pass][6 - i] = u.wiener[pass][i];
        f[pass][3] -= 2 * u.wiener[pass][i];
      }
    }
    // InterRound0 3 and InterRound1 11, 5 and 9 at 12 bits
    const int round0 = bit_depth == 12 ? 5 : 3, round1 = bit_depth == 12 ? 9 : 11;
    const int offset = 1 << (bit_depth + 6 - round0), limit = (1 << (bit_depth + 8 - round0)) - 1;
    std::vector<int> inter((size_t)(h + 6) * w);
    for (int r = 0; r < h + 6; r++) {
      const pixel* s = src + (ptrdiff_t)(r - 3) * bw - 3;
      for (int c = 0; c < w; c++) {
        int t = 0;
        for (int k = 0; k < 7; k++) t += f[1][k] * s[c + k];
        inter[(size_t)r * w + c] = clip3(-offset, limit - offset, round2(t, round0));
      }
    }
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        int t = 0;
        for (int k = 0; k < 7; k++) t += f[0][k] * inter[(size_t)(r + k) * w + c];
        dst[(size_t)r * stride + c] = clip1(round2(t, round1));
      }
  }

  // the self-guided filter: the r = 2 and r = 1 box passes of the unit's
  // set (a pass whose scale is 0 is not run), projected with w0, w1, w2
  void lr_sgrproj(const LrUnit& u, const pixel* src, int bw, int w, int h, int y0, pixel* dst,
                  int stride) const {
    int s0 = AV1_SGR_PARAMS[2 * u.sgr_set], s1 = AV1_SGR_PARAMS[2 * u.sgr_set + 1];
    std::vector<int> f0, f1;
    if (s0) box_filter(src, bw, w, h, y0, 2, s0, 0, f0);
    if (s1) box_filter(src, bw, w, h, y0, 1, s1, 1, f1);
    int w0 = u.xqd[0], w1 = u.xqd[1], w2 = (1 << 7) - w0 - w1;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int uu = src[(ptrdiff_t)i * bw + j] << 4;
        size_t k = (size_t)i * w + j;
        int v = w1 * uu + w0 * (s0 ? f0[k] : uu) + w2 * (s1 ? f1[k] : uu);
        dst[(size_t)i * stride + j] = clip1(round2(v, 11));
      }
  }

  // one box pass of radius r into F (h x w); the r = 2 pass keeps A and B
  // of the odd rows only (y0 is even); past 8 bits the variance is taken of
  // the sums rounded back to 8 bits
  void box_filter(const pixel* src, int bw, int w, int h, int y0, int r, int s, int pass,
                  std::vector<int>& F) const {
    int n = (2 * r + 1) * (2 * r + 1), one_over_n = ((1 << 12) + n / 2) / n;
    int aw = w + 2;
    std::vector<int> A((size_t)(h + 2) * aw), B((size_t)(h + 2) * aw);
    std::vector<int> cs(w + 2 + 2 * r), cq(w + 2 + 2 * r);
    for (int i = -1; i <= h; i++) {
      if (pass == 0 && !((y0 + i) & 1)) continue;
      // column sums over the 2r + 1 rows, then the window along the row
      for (int x = -1 - r; x <= w + r; x++) {
        int a = 0, b = 0;
        for (int dy = -r; dy <= r; dy++) {
          int c = src[(ptrdiff_t)(i + dy) * bw + x];
          a += c * c;
          b += c;
        }
        cs[x + 1 + r] = b;
        cq[x + 1 + r] = a;
      }
      for (int j = -1; j <= w; j++) {
        int a = 0, b = 0;
        for (int dx = -r; dx <= r; dx++) {
          a += cq[j + dx + 1 + r];
          b += cs[j + dx + 1 + r];
        }
        int bd8 = bit_depth - 8;
        int a8 = round2(a, 2 * bd8), d8 = round2(b, bd8);
        int p = imax(0, a8 * n - d8 * d8);
        int z = (int)round2l((int64_t)p * s, 20);
        int a2 = z >= 255 ? 256 : z == 0 ? 1 : ((z << 8) + z / 2) / (z + 1);
        int64_t b2 = (int64_t)((1 << 8) - a2) * b * one_over_n;
        A[(size_t)(i + 1) * aw + j + 1] = a2;
        B[(size_t)(i + 1) * aw + j + 1] = (int)round2l(b2, 12);
      }
    }
    F.assign((size_t)h * w, 0);
    for (int i = 0; i < h; i++) {
      int shift = pass == 0 && ((y0 + i) & 1) ? 4 : 5;
      for (int j = 0; j < w; j++) {
        int a = 0, b = 0;
        for (int dy = -1; dy <= 1; dy++)
          for (int dx = -1; dx <= 1; dx++) {
            int weight;
            if (pass == 0) weight = ((y0 + i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
            else weight = dx == 0 || dy == 0 ? 4 : 3;
            if (!weight) continue;
            size_t k = (size_t)(i + dy + 1) * aw + j + dx + 1;
            a += weight * A[k];
            b += weight * B[k];
          }
        int v = a * src[(ptrdiff_t)i * bw + j] + b;
        F[(size_t)i * w + j] = round2(v, 8 + shift - 4);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// YUV to RGB as libavif 1.3.0 converts samples for Pillow (8-bit RGB or
// RGBA out), read off Pillow's decodes of sample sweeps and off its
// avifImageYUVToRGB called on planes set by hand. 8-bit samples with the
// BT.601 / 709 / 2020 matrices (chroma-derived NCL over those primaries
// too) go through libyuv for 4:2:0 (bilinear chroma upsampling), 4:2:2
// (linear, along the rows) and 4:4:4 (libyuv's YuvConstants); libavif's own
// float code takes monochrome, the identity matrix and the matrices libyuv
// lacks (FCC, SMPTE 240M, YCgCo, YCgCo-Re, chroma-derived NCL over other
// primaries, a reserved 15: rgb_libavif). 10- and 12-bit samples
// (`convert`): the float code at their depth for monochrome RGB, the
// identity matrix and the matrices libyuv lacks; libyuv's 10-bit rows for
// 10-bit RGBA and its 12-bit 4:2:0 rows (nearest chroma) for 12-bit 4:2:0
// RGBA; the rest shifted down to 8 bits (libyuv's Convert16To8Plane) and
// converted as 8-bit samples
// ---------------------------------------------------------------------------
struct YuvConst {
  int ub, ug, vg, vr, yg, yb;
};

// libyuv's YuvConstants (row_common.c, MAKEYUVCONSTANTS) of a matrix and
// range: YG = round(y scale * 64 * 256 * 256 / 257), YB the bias and
// rounding, the U / V terms at 6 fractional bits
bool yuv_constants(int matrix, int full, YuvConst* k) {
  // the limited-range U-to-B terms saturate at 128 in libyuv's x86 build
  bool bt601 = matrix == 6 || matrix == 5 || matrix == 2;
  if (bt601 && full) *k = {113, 22, 46, 90, 16320, 32};                  // JPEG
  else if (bt601) *k = {128, 25, 52, 102, 18997, -1160};                // I601
  else if (matrix == 1 && full) *k = {119, 12, 30, 101, 16320, 32};     // F709
  else if (matrix == 1) *k = {128, 14, 34, 115, 18997, -1160};          // H709
  else if (matrix == 9 && full) *k = {120, 11, 37, 94, 16320, 32};      // V2020
  else if (matrix == 9) *k = {128, 12, 42, 107, 19003, -1160};          // 2020
  else return false;
  return true;
}

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// libyuv's YuvPixel: RGB of a luma widened to 16 bits by repeating its
// bits (y * 0x0101 at 8 bits, y << 6 | y >> 4 at 10) and 8-bit U, V
void yuv_pixel(const YuvConst& k, uint32_t y16, int u, int v, uint8_t* rgb) {
  int32_t y1 = (int32_t)((uint32_t)(y16 * k.yg) >> 16) + k.yb;
  int ui = u - 128, vi = v - 128;
  rgb[0] = clamp255((y1 + vi * k.vr) >> 6);
  rgb[1] = clamp255((y1 - (ui * k.ug + vi * k.vg)) >> 6);
  rgb[2] = clamp255((y1 + ui * k.ub) >> 6);
}

// libavif's float code: a sample at `depth` as unorm (v - bias) / range,
// clamped to [0, 1], then times 255 plus 0.5, truncated
float unorm(int v, int depth, int full) {
  float bias = full ? 0.0f : (float)(16 << (depth - 8));
  float range = full ? (float)((1 << depth) - 1) : (float)(219 << (depth - 8));
  float f = ((float)v - bias) / range;
  return f < 0.0f ? 0.0f : f > 1.0f ? 1.0f : f;
}
inline uint8_t unorm_to_u8(float f) { return (uint8_t)(0.5f + f * 255.0f); }
std::vector<uint8_t> float_lut(int depth, int full) {
  std::vector<uint8_t> lut((size_t)1 << depth);
  for (int v = 0; v < (1 << depth); v++) lut[v] = unorm_to_u8(unorm(v, depth, full));
  return lut;
}

// libavif's avifLimitedToFullY, which widens a limited-range alpha plane
// before the conversion
int limited_to_full(int depth, int v) {
  int lo = 16 << (depth - 8), hi = 235 << (depth - 8), max = (1 << depth) - 1;
  return clip3(0, max, ((v - lo) * max + (hi - lo) / 2) / (hi - lo));
}

// one row of chroma upsampled 2x: linear, libyuv's ScaleRowUp2_Linear_Any
// (and its 16-bit twin)
void up2_linear(const pixel* s, pixel* d, int dw) {
  d[0] = s[0];
  int work = (dw - 1) & ~1;
  for (int x = 0; x < work / 2; x++) {
    d[2 * x + 1] = (pixel)((s[x] * 3 + s[x + 1] + 2) >> 2);
    d[2 * x + 2] = (pixel)((s[x] + s[x + 1] * 3 + 2) >> 2);
  }
  d[dw - 1] = s[(dw - 1) / 2];
}
// two rows from chroma rows s, t: libyuv's ScaleRowUp2_Bilinear_Any
void up2_bilinear(const pixel* s, const pixel* t, pixel* d, pixel* e, int dw) {
  d[0] = (pixel)((s[0] * 3 + t[0] + 2) >> 2);
  e[0] = (pixel)((s[0] + t[0] * 3 + 2) >> 2);
  int work = (dw - 1) & ~1;
  for (int x = 0; x < work / 2; x++) {
    d[2 * x + 1] = (pixel)((s[x] * 9 + s[x + 1] * 3 + t[x] * 3 + t[x + 1] + 8) >> 4);
    d[2 * x + 2] = (pixel)((s[x] * 3 + s[x + 1] * 9 + t[x] + t[x + 1] * 3 + 8) >> 4);
    e[2 * x + 1] = (pixel)((s[x] * 3 + s[x + 1] + t[x] * 9 + t[x + 1] * 3 + 8) >> 4);
    e[2 * x + 2] = (pixel)((s[x] + s[x + 1] * 3 + t[x] * 3 + t[x + 1] * 9 + 8) >> 4);
  }
  int l = (dw - 1) / 2;
  d[dw - 1] = (pixel)((s[l] * 3 + t[l] + 2) >> 2);
  e[dw - 1] = (pixel)((s[l] + t[l] * 3 + 2) >> 2);
}
// a row of chroma repeated 2x (nearest)
void up2_nearest(const pixel* s, pixel* d, int dw) {
  for (int x = 0; x < dw; x++) d[x] = s[x >> 1];
}

// ---------------------------------------------------------------------------
// The scale of a frame to its item's `ispe` (or its track's `tkhd`): libavif
// 1.3.0's avifImageScale, which scales each plane with libyuv's ScalePlane
// (8-bit samples) or ScalePlane_12 (deeper ones) and kFilterBox. libyuv
// first reduces the filter (ScaleFilterReduce), then takes one of its
// branches by the sizes: copy, vertical only, 3/4, 1/2, 3/8 and 1/4 down,
// box, 2x up (linear or bilinear), bilinear up and down, and point
// sampling, each with its own 16.16 fixed-point stepping. Read off
// avifImageScale called by ctypes on random planes: 8-bit columns blend
// with the 7-bit fraction of libyuv's SSSE3 row, and the 3/4 and 3/8 rows
// average rows first (pavgb) where its SSSE3 rows run (24 and 6 pixels at a
// time, the rest of a row in C); deeper samples take libyuv's C rows
// ---------------------------------------------------------------------------
namespace scale {

enum Filter { kNone, kLinear, kBilinear, kBox };

// ScaleFilterReduce
Filter reduce(int sw, int sh, int dw, int dh, Filter f) {
  if (f == kBox && (dw * 2 >= sw || dh * 2 >= sh)) f = kBilinear;
  if (f == kBilinear) {
    if (sh == 1 || dh == sh || dh * 3 == sh) f = kLinear;
    if (sw == 1) f = kNone;
  }
  if (f == kLinear && (sw == 1 || dw == sw || dw * 3 == sw)) f = kNone;
  return f;
}
inline int fixed_div(int num, int div) { return (int)(((int64_t)num << 16) / div); }
inline int fixed_div1(int num, int div) {
  return (int)((((int64_t)num << 16) - 0x00010001) / (div - 1));
}

// ScaleSlope: the first source position and the step, 16.16
void slope(int sw, int sh, int dw, int dh, Filter f, int* x, int* y, int* dx, int* dy) {
  *x = *y = *dx = *dy = 0;
  if (f == kBox) {
    *dx = fixed_div(sw, dw);
    *dy = fixed_div(sh, dh);
    return;
  }
  if (f == kNone) {
    *dx = fixed_div(sw, dw);
    *dy = fixed_div(sh, dh);
    *x = *dx >> 1;
    *y = *dy >> 1;
    return;
  }
  if (dw <= sw) {
    *dx = fixed_div(sw, dw);
    *x = (*dx >> 1) - 32768;
  } else if (sw > 1 && dw > 1) {
    *dx = fixed_div1(sw, dw);
  }
  if (f == kLinear) {
    *dy = fixed_div(sh, dh);
    *y = *dy >> 1;
  } else if (dh <= sh) {
    *dy = fixed_div(sh, dh);
    *y = (*dy >> 1) - 32768;
  } else if (sh > 1 && dh > 1) {
    *dy = fixed_div1(sh, dh);
  }
}

struct View {
  pixel* p;
  int w, h, stride;
  pixel* row(int r) const { return p + (size_t)r * stride; }
};

// InterpolateRow: f / 256 of row t blended into row s
void interpolate(pixel* d, const pixel* s, const pixel* t, int w, int f) {
  if (f == 0) {
    std::memmove(d, s, sizeof(pixel) * w);
    return;
  }
  for (int x = 0; x < w; x++) d[x] = (pixel)((s[x] * (256 - f) + t[x] * f + 128) >> 8);
}
// ScaleFilterCols: the SSSE3 row's 7-bit fraction for 8-bit samples, the C
// row's 16-bit one for deeper samples (a position on the last sample
// takes it whole)
void filter_cols(pixel* d, const pixel* s, int sw, int dw, int x, int dx, bool deep) {
  for (int j = 0; j < dw; j++, x += dx) {
    const int xi = x >> 16, a = s[xi], b = xi + 1 < sw ? s[xi + 1] : a;
    if (deep) {
      d[j] = (pixel)(a + (int)(((int64_t)(x & 0xffff) * (b - a) + 0x8000) >> 16));
    } else {
      const int f = (x & 0xffff) >> 9;
      d[j] = (pixel)(((128 - f) * a + f * b + 64) >> 7);
    }
  }
}

// ScalePlaneVertical: rows blended, the width kept
void vertical(const View& s, const View& d, int y, int dy, Filter f) {
  const int max_y = s.h > 1 ? ((s.h - 1) << 16) - 1 : 0;
  for (int j = 0; j < d.h; j++, y += dy) {
    if (y > max_y) y = max_y;
    const int yi = y >> 16, yf = f ? (y >> 8) & 255 : 0;
    interpolate(d.row(j), s.row(yi), yf ? s.row(yi + 1) : nullptr, d.w, yf);
  }
}

// ScalePlaneUp2_Linear and ScalePlaneUp2_Bilinear, from the rows the
// chroma upsampling uses
void up2_linear_plane(const View& s, const View& d) {
  if (d.h == 1) {
    up2_linear(s.row((s.h - 1) / 2), d.row(0), d.w);
    return;
  }
  const int dy = fixed_div(s.h - 1, d.h - 1);
  for (int i = 0, y = (1 << 15) - 1; i < d.h; i++, y += dy)
    up2_linear(s.row(y >> 16), d.row(i), d.w);
}
void up2_bilinear_plane(const View& s, const View& d) {
  std::vector<pixel> spare(d.w);
  up2_linear(s.row(0), d.row(0), d.w);
  int r = 1;
  for (int y = 0; y < s.h - 1; y++, r += 2)
    up2_bilinear(s.row(y), s.row(y + 1), d.row(r), r + 1 < d.h ? d.row(r + 1) : spare.data(), d.w);
  if (!(d.h & 1)) up2_linear(s.row(s.h - 1), d.row(d.h - 1), d.w);
}

// ScalePlaneDown2 and ScalePlaneDown4 (box)
void down2(const View& s, const View& d) {
  for (int j = 0; j < d.h; j++) {
    const pixel *a = s.row(2 * j), *b = s.row(2 * j + 1);
    pixel* o = d.row(j);
    for (int x = 0; x < d.w; x++)
      o[x] = (pixel)((a[2 * x] + a[2 * x + 1] + b[2 * x] + b[2 * x + 1] + 2) >> 2);
  }
}
void down4(const View& s, const View& d) {
  for (int j = 0; j < d.h; j++) {
    pixel* o = d.row(j);
    for (int x = 0; x < d.w; x++) {
      int sum = 8;
      for (int k = 0; k < 4; k++)
        for (int i = 0; i < 4; i++) sum += s.row(4 * j + k)[4 * x + i];
      o[x] = (pixel)(sum >> 4);
    }
  }
}

// ScaleRowDown34_0_Box (`first`: 3:1 of rows s and t) and _1_Box (1:1),
// output pixels [from, to): the C row filters along the rows first, the
// SSSE3 row averages the rows first (pavgb, twice for 3:1)
void down34_row(const pixel* s, const pixel* t, pixel* d, int from, int to, bool first,
                bool ssse3) {
  for (int x = from; x < to; x += 3) {
    const pixel *p = s + x / 3 * 4, *q = t + x / 3 * 4;
    pixel* o = d + x;
    if (ssse3) {
      int r[4];
      for (int i = 0; i < 4; i++) {
        const int m = (p[i] + q[i] + 1) >> 1;
        r[i] = first ? (p[i] + m + 1) >> 1 : m;
      }
      o[0] = (pixel)((r[0] * 3 + r[1] + 2) >> 2);
      o[1] = (pixel)((r[1] + r[2] + 1) >> 1);
      o[2] = (pixel)((r[2] + r[3] * 3 + 2) >> 2);
      continue;
    }
    const int a[3] = {(p[0] * 3 + p[1] + 2) >> 2, (p[1] + p[2] + 1) >> 1,
                      (p[2] + p[3] * 3 + 2) >> 2};
    const int b[3] = {(q[0] * 3 + q[1] + 2) >> 2, (q[1] + q[2] + 1) >> 1,
                      (q[2] + q[3] * 3 + 2) >> 2};
    for (int i = 0; i < 3; i++)
      o[i] = (pixel)(first ? (a[i] * 3 + b[i] + 2) >> 2 : (a[i] + b[i] + 1) >> 1);
  }
}
// ScalePlaneDown34: three rows of every four, the last one or two rows
// from one source row
void down34(const View& s, const View& d, bool deep) {
  const int n = deep ? 0 : d.w - d.w % 24;
  auto row = [&](int sr, int tr, int dr, bool first) {
    down34_row(s.row(sr), s.row(tr), d.row(dr), 0, n, first, true);
    down34_row(s.row(sr), s.row(tr), d.row(dr), n, d.w, first, false);
  };
  int sy = 0, y = 0;
  for (; y < d.h - 2; y += 3, sy += 4) {
    row(sy, sy + 1, y, true);
    row(sy + 1, sy + 2, y + 1, false);
    row(sy + 3, sy + 2, y + 2, true);
  }
  if (d.h % 3 == 2) {
    row(sy, sy + 1, y, true);
    row(sy + 1, sy + 1, y + 1, false);
  } else if (d.h % 3 == 1) {
    row(sy, sy, y, true);
  }
}

// ScaleRowDown38_3_Box / _2_Box over `rows` source rows, output pixels
// [from, to): the sums times libyuv's reciprocals; the SSSE3 two-row box
// averages the rows first (pavgb)
void down38_row(const pixel* const* r, int rows, pixel* d, int from, int to, bool ssse3) {
  for (int x = from; x < to; x += 3) {
    const int o = x / 3 * 8;
    if (rows == 2 && ssse3) {
      int m[8];
      for (int i = 0; i < 8; i++) m[i] = (r[0][o + i] + r[1][o + i] + 1) >> 1;
      d[x] = (pixel)(((m[0] + m[1] + m[2]) * (65536 / 3)) >> 16);
      d[x + 1] = (pixel)(((m[3] + m[4] + m[5]) * (65536 / 3)) >> 16);
      d[x + 2] = (pixel)(((m[6] + m[7]) * (65536 / 2)) >> 16);
      continue;
    }
    uint32_t s0 = 0, s1 = 0, s2 = 0;
    for (int k = 0; k < rows; k++) {
      const pixel* p = r[k] + o;
      s0 += p[0] + p[1] + p[2];
      s1 += p[3] + p[4] + p[5];
      s2 += p[6] + p[7];
    }
    const uint32_t three = rows == 3 ? 65536 / 9 : 65536 / 6;
    const uint32_t two = rows == 3 ? 65536 / 6 : 65536 / 4;
    d[x] = (pixel)((s0 * three) >> 16);
    d[x + 1] = (pixel)((s1 * three) >> 16);
    d[x + 2] = (pixel)((s2 * two) >> 16);
  }
}
// ScalePlaneDown38: rows of 3, 3 and 2 source rows, the last one or two
// rows from 3 copies of one source row (stride 0)
void down38(const View& s, const View& d, bool deep) {
  const int n = deep ? 0 : d.w - d.w % 6;
  auto row = [&](int sr, int rows, int step, int dr) {
    const pixel* r[3];
    for (int k = 0; k < rows; k++) r[k] = s.row(sr + k * step);
    down38_row(r, rows, d.row(dr), 0, n, true);
    down38_row(r, rows, d.row(dr), n, d.w, false);
  };
  int sy = 0, y = 0;
  for (; y < d.h - 2; y += 3, sy += 8) {
    row(sy, 3, 1, y);
    row(sy + 3, 3, 1, y + 1);
    row(sy + 6, 2, 1, y + 2);
  }
  if (d.h % 3 == 2) {
    row(sy, 3, 1, y);
    row(sy + 3, 3, 0, y + 1);
  } else if (d.h % 3 == 1) {
    row(sy, 3, 0, y);
  }
}

// ScalePlaneBox: the mean of each box, truncated; 8-bit rows sum into 16
// bits (and wrap), deeper ones into 32
template <typename Sum>
void box(const View& s, const View& d) {
  int x, y, dx, dy;
  slope(s.w, s.h, d.w, d.h, kBox, &x, &y, &dx, &dy);
  const int max_y = s.h << 16, minw = dx >> 16;
  std::vector<Sum> row(s.w);
  for (int j = 0; j < d.h; j++) {
    const int iy = y >> 16;
    y = std::min(y + dy, max_y);
    const int bh = std::max(1, (y >> 16) - iy);
    std::fill(row.begin(), row.end(), (Sum)0);
    for (int k = 0; k < bh; k++) {
      const pixel* p = s.row(iy + k);
      for (int i = 0; i < s.w; i++) row[i] = (Sum)(row[i] + p[i]);
    }
    // ScaleAddCols2 (boxes of two widths) or ScaleAddCols1 (one)
    const uint32_t scale[2] = {(uint32_t)(65536 / (std::max(1, minw) * bh)),
                               (uint32_t)(65536 / (std::max(1, minw + 1) * bh))};
    pixel* o = d.row(j);
    for (int i = 0, xx = x; i < d.w; i++) {
      const int ix = xx >> 16;
      int bw;
      if (dx & 0xffff) {
        xx += dx;
        bw = std::max(1, (xx >> 16) - ix);
      } else {
        bw = std::max(1, minw);
        xx += bw << 16;
      }
      uint32_t sum = 0;
      for (int k = 0; k < bw; k++) sum += row[ix + k];
      o[i] = (pixel)((sum * scale[bw - minw]) >> 16);
    }
  }
}

// ScalePlaneBilinearDown: each output row from the two source rows about
// its position (one with the linear filter), then along the row
void bilinear_down(const View& s, const View& d, Filter f, bool deep) {
  int x, y, dx, dy;
  slope(s.w, s.h, d.w, d.h, f, &x, &y, &dx, &dy);
  const int max_y = (s.h - 1) << 16;
  std::vector<pixel> row(s.w);
  y = std::min(y, max_y);
  for (int j = 0; j < d.h; j++) {
    const int yi = y >> 16, yf = (y >> 8) & 255;
    if (f == kLinear) {
      filter_cols(d.row(j), s.row(yi), s.w, d.w, x, dx, deep);
    } else {
      interpolate(row.data(), s.row(yi), yf ? s.row(yi + 1) : nullptr, s.w, yf);
      filter_cols(d.row(j), row.data(), s.w, d.w, x, dx, deep);
    }
    y = std::min(y + dy, max_y);
  }
}

// ScalePlaneBilinearUp: source rows filtered along the row into two
// buffers as the position reaches them, then blended
void bilinear_up(const View& s, const View& d, Filter f, bool deep) {
  int x, y, dx, dy;
  slope(s.w, s.h, d.w, d.h, f, &x, &y, &dx, &dy);
  const int max_y = (s.h - 1) << 16;
  y = std::min(y, max_y);
  int yi = y >> 16, src = yi, lasty = yi;
  std::vector<pixel> rows(2 * (size_t)d.w);
  pixel* cur = rows.data();
  ptrdiff_t step = d.w;
  filter_cols(cur, s.row(src), s.w, d.w, x, dx, deep);
  if (s.h > 1) src++;
  filter_cols(cur + step, s.row(src), s.w, d.w, x, dx, deep);
  if (s.h > 2) src++;
  for (int j = 0; j < d.h; j++, y += dy) {
    yi = y >> 16;
    if (yi != lasty) {
      if (y > max_y) {
        y = max_y;
        yi = y >> 16;
        src = yi;
      }
      if (yi != lasty) {
        filter_cols(cur, s.row(src), s.w, d.w, x, dx, deep);
        cur += step;
        step = -step;
        lasty = yi;
        if (y + 65536 < max_y) src++;
      }
    }
    const int yf = f == kLinear ? 0 : (y >> 8) & 255;
    interpolate(d.row(j), cur, yf ? cur + step : nullptr, d.w, yf);
  }
}

// ScalePlaneSimple: point sampling
void simple(const View& s, const View& d) {
  int x, y, dx, dy;
  slope(s.w, s.h, d.w, d.h, kNone, &x, &y, &dx, &dy);
  for (int i = 0; i < d.h; i++, y += dy) {
    const pixel* r = s.row(y >> 16);
    pixel* o = d.row(i);
    for (int j = 0, xx = x; j < d.w; j++, xx += dx) o[j] = r[xx >> 16];
  }
}

// ScalePlane (8-bit samples) or ScalePlane_12 (`deep`) with kFilterBox
void plane(const View& s, const View& d, bool deep) {
  const Filter f = reduce(s.w, s.h, d.w, d.h, kBox);
  const bool up2w = (d.w + 1) / 2 == s.w, up2h = (d.h + 1) / 2 == s.h;
  // ScalePlane_12 takes the 2x ups before ScalePlane_16's branches
  if (deep && up2w && f == kLinear) return up2_linear_plane(s, d);
  if (deep && up2w && up2h && f >= kBilinear) return up2_bilinear_plane(s, d);
  if (d.w == s.w && d.h == s.h) {
    for (int r = 0; r < d.h; r++) std::memcpy(d.row(r), s.row(r), sizeof(pixel) * d.w);
    return;
  }
  if (d.w == s.w && f != kBox) {
    int y = 0, dy = 0;
    if (d.h <= s.h) {
      dy = fixed_div(s.h, d.h);
      y = (dy >> 1) - 32768;
    } else if (s.h > 1 && d.h > 1) {
      dy = fixed_div1(s.h, d.h);
    }
    return vertical(s, d, y, dy, f);
  }
  if (d.w <= s.w && d.h <= s.h) {
    if (4 * d.w == 3 * s.w && 4 * d.h == 3 * s.h) return down34(s, d, deep);
    if (2 * d.w == s.w && 2 * d.h == s.h) return down2(s, d);
    if (8 * d.w == 3 * s.w && 8 * d.h == 3 * s.h) return down38(s, d, deep);
    if (4 * d.w == s.w && 4 * d.h == s.h && (f == kBox || f == kNone)) return down4(s, d);
  }
  if (f == kBox && d.h * 2 < s.h) return deep ? box<uint32_t>(s, d) : box<uint16_t>(s, d);
  if (up2w && f == kLinear) return up2_linear_plane(s, d);
  if (up2h && up2w && f >= kBilinear) return up2_bilinear_plane(s, d);
  if (f && d.h > s.h) return bilinear_up(s, d, f, deep);
  if (f) return bilinear_down(s, d, f, deep);
  simple(s, d);
}

}  // namespace scale

// the samples shifted down to 8 bits (libyuv's Convert16To8Plane)
void downshift(Decoder& d) {
  int s = d.bit_depth - 8;
  for (int p = 0; p < d.num_planes() && s; p++)
    for (pixel& v : d.planes[p].px) v = (pixel)(v >> s);
  d.bit_depth = 8;
}

// libavif's float code at the samples' depth: gray, or GBR from the
// identity matrix; with `alpha` (full range, at the same depth) and
// `premultiplied`, the colour divided by alpha in float
void rgb_float(Decoder& d, int w, int h, int full, const pixel* alpha, bool premultiplied,
               uint8_t* out, int64_t stride, int channels) {
  int depth = d.bit_depth, amax = (1 << depth) - 1;
  std::vector<uint8_t> lut = float_lut(depth, full);
  Plane &Y = d.planes[0], &U = d.planes[1], &V = d.planes[2];
  for (int r = 0; r < h; r++) {
    uint8_t* o = out + r * stride;
    const pixel *yy = Y.at(r, 0), *uu = d.mono ? yy : U.at(r, 0), *vv = d.mono ? yy : V.at(r, 0);
    const pixel* aa = alpha ? alpha + (size_t)r * w : nullptr;
    for (int x = 0; x < w; x++, o += channels) {
      int a = premultiplied ? aa[x] : amax;
      if (a == amax) {
        o[0] = lut[vv[x]];
        o[1] = lut[yy[x]];
        o[2] = lut[uu[x]];
        continue;
      }
      float af = (float)a / (float)amax;
      const pixel* src[3] = {vv, yy, uu};
      for (int c = 0; c < 3; c++) {
        float f = a == 0 ? 0.0f : std::min(unorm(src[c][x], depth, full) / af, 1.0f);
        o[c] = unorm_to_u8(f);
      }
    }
  }
}

// 8-bit monochrome RGBA where libyuv has the matrix (`matrix` its own, or
// BT.601 for the identity): libyuv's I400ToARGBMatrix, whose limited-range
// luma scale BT.601 and 709 share and BT.2020's equals the float code's;
// libavif's float code in full range
void rgb_mono_rgba(Decoder& d, int w, int h, int matrix, int full, uint8_t* out,
                   int64_t stride) {
  std::vector<uint8_t> lut = float_lut(8, full);
  if (!full && matrix != 9) {
    YuvConst k;
    yuv_constants(6, 0, &k);
    uint8_t rgb[3];
    for (int v = 0; v < 256; v++) {
      yuv_pixel(k, (uint32_t)v * 0x0101, 128, 128, rgb);
      lut[v] = rgb[0];
    }
  }
  for (int r = 0; r < h; r++) {
    uint8_t* o = out + r * stride;
    const pixel* yy = d.planes[0].at(r, 0);
    for (int x = 0; x < w; x++, o += 4) o[0] = o[1] = o[2] = lut[yy[x]];
  }
}

// libyuv's matrix for a `colr` matrix (avifImageYUVToRGBLibYUV's table):
// BT.709, BT.601 (and BT.470 BG, unspecified), BT.2020, and chroma-derived
// NCL over the primaries of one of them; -1 where libyuv has none
int libyuv_matrix(int matrix, int primaries) {
  if (matrix == 12) {
    if (primaries == 1 || primaries == 2) return 1;
    if (primaries == 5 || primaries == 6) return 6;
    return primaries == 9 ? 9 : -1;
  }
  return matrix == 1 || matrix == 2 || matrix == 5 || matrix == 6 || matrix == 9 ? matrix : -1;
}

// libavif's (kr, kg, kb) of a matrix libyuv lacks (avifCalcYUVCoefficients):
// FCC's and SMPTE 240M's from its table, chroma-derived NCL's from the
// `colr` primaries (avifColorPrimariesComputeYCoeffs, in float; unknown
// primaries are BT.709's), else BT.601's
void own_coefficients(int matrix, int primaries, float k[3]) {
  float kr = 0.299f, kb = 0.114f;
  if (matrix == 4) {
    kr = 0.30f;
    kb = 0.11f;
  } else if (matrix == 7) {
    kr = 0.212f;
    kb = 0.087f;
  } else if (matrix == 12) {
    static const struct {
      int id;
      float xy[8];  // red, green, blue and white x, y
    } table[] = {
        {1, {0.64f, 0.33f, 0.3f, 0.6f, 0.15f, 0.06f, 0.3127f, 0.3290f}},
        {4, {0.67f, 0.33f, 0.21f, 0.71f, 0.14f, 0.08f, 0.310f, 0.316f}},
        {5, {0.64f, 0.33f, 0.29f, 0.60f, 0.15f, 0.06f, 0.3127f, 0.3290f}},
        {6, {0.630f, 0.340f, 0.310f, 0.595f, 0.155f, 0.070f, 0.3127f, 0.3290f}},
        {7, {0.630f, 0.340f, 0.310f, 0.595f, 0.155f, 0.070f, 0.3127f, 0.3290f}},
        {8, {0.681f, 0.319f, 0.243f, 0.692f, 0.145f, 0.049f, 0.310f, 0.316f}},
        {9, {0.708f, 0.292f, 0.170f, 0.797f, 0.131f, 0.046f, 0.3127f, 0.3290f}},
        {10, {1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.3333f, 0.3333f}},
        {11, {0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.314f, 0.351f}},
        {12, {0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.3127f, 0.3290f}},
        {22, {0.630f, 0.340f, 0.295f, 0.605f, 0.155f, 0.077f, 0.3127f, 0.3290f}},
    };
    const float* p = table[0].xy;
    for (const auto& t : table)
      if (t.id == primaries) p = t.xy;
    const float rX = p[0], rY = p[1], gX = p[2], gY = p[3], bX = p[4], bY = p[5], wX = p[6],
                wY = p[7];
    const float rZ = 1.0f - (rX + rY), gZ = 1.0f - (gX + gY), bZ = 1.0f - (bX + bY),
                wZ = 1.0f - (wX + wY);
    kr = (rY * (wX * (gY * bZ - bY * gZ) + wY * (bX * gZ - gX * bZ) + wZ * (gX * bY - bX * gY))) /
         (wY * (rX * (gY * bZ - bY * gZ) + gX * (bY * rZ - rY * bZ) + bX * (rY * gZ - gY * rZ)));
    kb = (bY * (wX * (rY * gZ - gY * rZ) + wY * (gX * rZ - rX * gZ) + wZ * (rX * gY - gX * rY))) /
         (wY * (rX * (gY * bZ - bY * gZ) + gX * (bY * rZ - rY * bZ) + bX * (rY * gZ - gY * rZ)));
  }
  k[0] = kr;
  k[1] = 1.0f - kr - kb;
  k[2] = kb;
}

inline float clamp01(float v) { return v < 0.0f ? 0.0f : 1.0f < v ? 1.0f : v; }

// libavif's own conversion (reformat.c), for the matrices libyuv lacks:
// YCgCo (8), YCgCo-Re (16), else the (kr, kb) of own_coefficients. The
// samples at their depth as unorm floats (luma less its bias over its
// range, chroma less half), then per pixel in float: 4:4:4 and monochrome
// samples with coefficients through its fast routines (avifImageYUV8To
// RGB8Color / Mono and their 16-bit twins), the rest through
// avifImageYUVAnyToRGBAnySlow, which upsamples 4:2:0 and 4:2:2 chroma
// bilinearly from the nearest sample and its neighbours (9, 3, 3 and 1
// sixteenths, in that order) and unpremultiplies in float; YCgCo-Re from
// integers (the luma sample and the rounded chroma differences). True
// where the colour is still to be unpremultiplied (the fast routines leave
// it to libyuv's ARGBUnattenuate)
bool rgb_libavif(Decoder& d, const pixel* alpha, int w, int h, int matrix, int primaries,
                 int full, bool premultiplied, uint8_t* out, int64_t stride, int channels,
                 int threads) {
  const int depth = d.bit_depth, maxc = (1 << depth) - 1;
  const bool ycgco = matrix == 8, ycgco_re = matrix == 16;
  float k[3] = {0.0f, 0.0f, 0.0f};
  if (!ycgco && !ycgco_re) own_coefficients(matrix, primaries, k);
  const float kr = k[0], kg = k[1], kb = k[2];
  const float bias_y = full ? 0.0f : (float)(16 << (depth - 8));
  const float bias_uv = (float)(1 << (depth - 1));
  const float range_y = (float)(full ? maxc : 219 << (depth - 8));
  const float range_uv = (float)(full ? maxc : 224 << (depth - 8));
  std::vector<float> ty(maxc + 1), tuv(maxc + 1);
  for (int v = 0; v <= maxc; v++) {
    ty[v] = ((float)v - bias_y) / range_y;
    tuv[v] = ((float)v - bias_uv) / range_uv;
  }
  const bool fast = !ycgco && !ycgco_re && (d.mono || !d.ssx);
  Plane &Y = d.planes[0], &U = d.planes[1], &V = d.planes[2];
  in_bands(h, threads, [&](int j0, int j1) {
    for (int j = j0; j < j1; j++) {
      uint8_t* o = out + j * stride;
      const pixel* yy = Y.at(j, 0);
      const int uvj = j >> d.ssy;
      // 4:2:0: the chroma row beside the nearest (none at the edges)
      const int adj_row = !d.ssy || j == 0 || (j == h - 1 && (j & 1)) ? 0 : (j & 1) ? 1 : -1;
      const pixel *u0 = d.mono ? yy : U.at(uvj, 0), *v0 = d.mono ? yy : V.at(uvj, 0);
      const pixel *u1 = d.mono ? yy : U.at(uvj + adj_row, 0);
      const pixel *v1 = d.mono ? yy : V.at(uvj + adj_row, 0);
      for (int i = 0; i < w; i++, o += channels) {
        const float yf = ty[yy[i]];
        float rgb[3];
        if (d.mono) {
          rgb[0] = rgb[1] = rgb[2] = yf;
        } else {
          float cb, cr;
          const int uvi = i >> d.ssx;
          if (!d.ssx) {
            cb = tuv[u0[uvi]];
            cr = tuv[v0[uvi]];
          } else {
            const int c = uvi + (i == 0 || (i == w - 1 && (i & 1)) ? 0 : (i & 1) ? 1 : -1);
            cb = (tuv[u0[uvi]] * (9.0f / 16.0f)) + (tuv[u0[c]] * (3.0f / 16.0f)) +
                 (tuv[u1[uvi]] * (3.0f / 16.0f)) + (tuv[u1[c]] * (1.0f / 16.0f));
            cr = (tuv[v0[uvi]] * (9.0f / 16.0f)) + (tuv[v0[c]] * (3.0f / 16.0f)) +
                 (tuv[v1[uvi]] * (3.0f / 16.0f)) + (tuv[v1[c]] * (1.0f / 16.0f));
          }
          if (ycgco) {
            const float t = yf - cb;
            rgb[1] = yf + cb;
            rgb[2] = t - cr;
            rgb[0] = t + cr;
          } else if (ycgco_re) {
            const int cg = (int)std::floor(cb * (float)maxc + 0.5f);
            const int co = (int)std::floor(cr * (float)maxc + 0.5f);
            const int t = yy[i] - (cg >> 1);
            const float g = (float)clip3(0, 255, t + cg), b = (float)clip3(0, 255, t - (co >> 1));
            const float r = std::min(std::max(b + (float)co, 0.0f), 255.0f);
            rgb[0] = r / 255.0f;
            rgb[1] = g / 255.0f;
            rgb[2] = b / 255.0f;
          } else {
            rgb[0] = yf + (2 * (1 - kr)) * cr;
            rgb[2] = yf + (2 * (1 - kb)) * cb;
            rgb[1] = yf - ((2 * ((kr * (1 - kr) * cr) + (kb * (1 - kb) * cb))) / kg);
          }
        }
        for (float& c : rgb) c = clamp01(c);
        if (!fast && premultiplied && alpha) {
          const float a = clamp01((float)alpha[(size_t)j * w + i] / (float)maxc);
          for (float& c : rgb) c = a == 0.0f ? 0.0f : a < 1.0f ? std::min(c / a, 1.0f) : c;
        }
        for (int c = 0; c < 3; c++) o[c] = (uint8_t)(0.5f + rgb[c] * 255.0f);
      }
    }
  });
  return fast;
}

// libyuv's rows at the samples' depth: the luma widened to 16 bits, the
// chroma upsampled at its depth (bilinear or nearest for 4:2:0, linear for
// 4:2:2), then shifted down to 8 bits and saturated
void rgb_yuv(Decoder& d, const YuvConst& k, int w, int h, bool nearest, uint8_t* out,
             int64_t stride, int channels) {
  Plane &Y = d.planes[0], &U = d.planes[1], &V = d.planes[2];
  const int depth = d.bit_depth, cs = depth - 8;
  std::vector<pixel> u1(w + 2), v1(w + 2), u2(w + 2), v2(w + 2);
  auto emit = [&](int row, const pixel* uu, const pixel* vv) {
    uint8_t* o = out + row * stride;
    const pixel* yy = Y.at(row, 0);
    for (int x = 0; x < w; x++) {
      uint32_t y16 = ((uint32_t)yy[x] << (16 - depth)) | ((uint32_t)yy[x] >> (2 * depth - 16));
      yuv_pixel(k, y16, imin(255, uu[x] >> cs), imin(255, vv[x] >> cs), o + channels * x);
    }
  };
  if (!d.ssx) {  // 4:4:4
    for (int r = 0; r < h; r++) emit(r, U.at(r, 0), V.at(r, 0));
    return;
  }
  if (!d.ssy) {  // 4:2:2
    for (int r = 0; r < h; r++) {
      up2_linear(U.at(r, 0), u1.data(), w);
      up2_linear(V.at(r, 0), v1.data(), w);
      emit(r, u1.data(), v1.data());
    }
    return;
  }
  if (nearest) {
    for (int r = 0; r < h; r++) {
      up2_nearest(U.at(r >> 1, 0), u1.data(), w);
      up2_nearest(V.at(r >> 1, 0), v1.data(), w);
      emit(r, u1.data(), v1.data());
    }
    return;
  }
  up2_linear(U.at(0, 0), u1.data(), w);
  up2_linear(V.at(0, 0), v1.data(), w);
  emit(0, u1.data(), v1.data());
  int row = 1, c = 0;
  for (int y = 0; y < h - 2; y += 2, c++) {
    up2_bilinear(U.at(c, 0), U.at(c + 1, 0), u1.data(), u2.data(), w);
    up2_bilinear(V.at(c, 0), V.at(c + 1, 0), v1.data(), v2.data(), w);
    emit(row++, u1.data(), v1.data());
    emit(row++, u2.data(), v2.data());
  }
  if (!(h & 1)) {
    up2_linear(U.at(c, 0), u1.data(), w);
    up2_linear(V.at(c, 0), v1.data(), w);
    emit(row, u1.data(), v1.data());
  }
}

// libavif's unpremultiply of 8-bit RGBA (an alpha the colour item is
// premultiplied by, `prem`): libyuv's ARGBUnattenuate as its AVX2 rows run
// it, read off Pillow's decodes of every (colour, alpha) pair: the colour
// widened to 16 bits (c * 257) times libyuv's 8.8 reciprocal of alpha
// (0x10000 / a; 0xffff at 1, 0x100 at 255, 0 at 0), the high half taken as
// a signed 16-bit word and saturated to a byte (so alpha 1 takes colours
// from 128 up to 0)
struct Unattenuate {
  uint8_t lut[256][256];  // [alpha][colour]
  Unattenuate() {
    for (int a = 0; a < 256; a++) {
      uint32_t ia = a == 0 ? 0 : a == 1 ? 0xffff : a == 255 ? 0x100 : 0x10000 / a;
      for (int c = 0; c < 256; c++)
        lut[a][c] = clamp255((int16_t)(uint16_t)(((uint32_t)c * 257 * ia) >> 16));
    }
  }
};

void unpremultiply(int w, int h, uint8_t* out, int64_t stride) {
  static const Unattenuate u;
  for (int r = 0; r < h; r++) {
    uint8_t* o = out + r * stride;
    for (int x = 0; x < w; x++, o += 4)
      for (int c = 0; c < 3; c++) o[c] = u.lut[o[3]][o[c]];
  }
}

// libavif's refusals of a matrix (avifPrepareReformatState): the reserved
// values (3, and past 17), BT.2020 and chroma-derived constant luminance,
// SMPTE ST 2085, ICtCp and YCgCo-Ro; YCgCo and YCgCo-Re in limited range;
// YCgCo-Re but from samples two bits deeper than the 8-bit RGB; the
// identity but on 4:4:4 and monochrome samples
bool reformat_refuses(int m, int full, int depth, bool mono, bool subsampled) {
  return m == 3 || m == 10 || m == 11 || m == 13 || m == 14 || m >= 17 ||
         ((m == 8 || m == 16) && !full) || (m == 16 && depth != 10) ||
         (m == 0 && subsampled && !mono);
}

// the decoded frame (and the alpha item's, `a`, in full range) into `out`
// as libavif converts it for Pillow: the alpha narrowed to 8 bits by the
// code that converts the colour (libyuv's shift, or libavif's float code)
void convert(Decoder& d, Decoder* a, int w, int h, int matrix, int primaries, int full,
             int premultiplied, uint8_t* out, int64_t stride, int threads) {
  const int channels = a ? 4 : 3, depth = d.bit_depth;
  std::vector<pixel> alpha;
  if (a) {
    if (a->bit_depth != depth)
      throw std::runtime_error("alpha item of " + std::to_string(a->bit_depth) +
                               "-bit samples beside " + std::to_string(depth) + "-bit colour");
    alpha.resize((size_t)w * h);
    for (int r = 0; r < h; r++)
      std::memcpy(&alpha[(size_t)r * w], a->planes[0].at(r, 0), sizeof(pixel) * w);
  }
  int alpha_shift = -1;  // >= 0: alpha >> alpha_shift; -1: libavif's float code
  bool unattenuate = true;
  const int lm = libyuv_matrix(matrix, primaries);
  if (matrix == 0 && !d.mono) {  // the identity matrix
    bool in_float = depth > 8 || !full;  // libavif's premultiplied path too
    rgb_float(d, w, h, full, a ? alpha.data() : nullptr, premultiplied && in_float, out, stride,
              channels);
    unattenuate = !in_float;
  } else if (d.mono && channels == 3) {
    rgb_float(d, w, h, full, nullptr, false, out, stride, channels);
  } else if (d.mono && (lm >= 0 || matrix == 0)) {
    downshift(d);
    rgb_mono_rgba(d, w, h, lm >= 0 ? lm : 6, full, out, stride);
  } else if (lm < 0) {
    unattenuate = rgb_libavif(d, a ? alpha.data() : nullptr, w, h, matrix, primaries, full,
                              premultiplied, out, stride, channels, threads);
  } else {
    YuvConst k;
    yuv_constants(lm, full, &k);
    bool nearest = false;
    if (depth == 10 && channels == 4) alpha_shift = 2;
    else if (depth == 12 && channels == 4 && d.ssx && d.ssy) nearest = true;
    else {
      alpha_shift = depth - 8;
      downshift(d);
    }
    rgb_yuv(d, k, w, h, nearest, out, stride, channels);
  }
  if (!a) return;
  const float amax = (float)((1 << depth) - 1);
  for (int r = 0; r < h; r++) {
    const pixel* s = &alpha[(size_t)r * w];
    uint8_t* o = out + r * stride + 3;
    for (int x = 0; x < w; x++)
      o[4 * x] = alpha_shift >= 0 ? clamp255(s[x] >> alpha_shift)
                                  : unorm_to_u8((float)s[x] / amax);
  }
  if (premultiplied && unattenuate) unpremultiply(w, h, out, stride);
}

// one coded image of libavif's: an item's single tile (`grid` 0), or a
// grid item's tiles (`cols` x `rows` of `tile_w` x `tile_h`, each its
// `ispe`, in raster order) cropped to `width` x `height` at the right and
// bottom edges
struct Coded {
  const uint8_t* const* data;
  const int64_t* sizes;
  int grid, cols, rows, tile_w, tile_h, width, height;
  int count() const { return cols * rows; }
};

// what libavif holds equal between a grid's tiles (avifDecoderDataCopyTile
// ToImage's "mismatched tiles"): the frame's size, depth, layout, range and
// the sequence header's CICP (an alpha tile's size and depth only)
struct Form {
  int w, h, depth, mono, ssx, ssy, range, primaries, transfer, matrix;
  explicit Form(const Decoder& d, bool alpha)
      : w(d.frame_w), h(d.frame_h), depth(d.bit_depth), mono(alpha ? 0 : d.mono),
        ssx(alpha ? 0 : d.ssx), ssy(alpha ? 0 : d.ssy), range(alpha ? 0 : d.color_range),
        primaries(alpha ? 0 : d.primaries), transfer(alpha ? 0 : d.transfer),
        matrix(alpha ? 0 : d.matrix) {}
  bool operator==(const Form& o) const {
    return w == o.w && h == o.h && depth == o.depth && mono == o.mono && ssx == o.ssx &&
           ssy == o.ssy && range == o.range && primaries == o.primaries &&
           transfer == o.transfer && matrix == o.matrix;
  }
};

// a decoded tile's planes into the image's at (x0, y0), cropped to its
// w x h (libavif's avifImageCopySamples over two views; an alpha tile's
// one plane)
void stitch(Decoder& t, Decoder& g, int x0, int y0, int w, int h, bool alpha) {
  for (int p = 0; p < (alpha ? 1 : t.num_planes()); p++) {
    int sx = p ? t.ssx : 0, sy = p ? t.ssy : 0;
    int pw = (w + sx) >> sx, ph = (h + sy) >> sy;
    for (int r = 0; r < ph; r++)
      std::memcpy(g.planes[p].at((y0 >> sy) + r, x0 >> sx), t.planes[p].at(r, 0),
                  sizeof(pixel) * (size_t)pw);
  }
}

// an alpha tile's plane widened to full range where its sequence header
// says limited, as libavif widens it before it scales or copies the tile
void widen_alpha(Decoder& t) {
  for (int r = 0; r < t.frame_h; r++) {
    pixel* s = t.planes[0].at(r, 0);
    for (int x = 0; x < t.frame_w; x++) s[x] = (pixel)limited_to_full(t.bit_depth, s[x]);
  }
  t.color_range = 1;
}

// the image's form from its first tile, and its planes at its size
void allocate(const Decoder& t, Decoder& g, int width, int height, bool alpha) {
  g.bit_depth = t.bit_depth;
  g.mono = alpha ? 1 : t.mono;
  g.ssx = t.ssx;
  g.ssy = t.ssy;
  g.color_range = t.color_range;
  g.matrix = t.matrix;
  g.primaries = t.primaries;
  for (int p = 0; p < g.num_planes(); p++) {
    Plane& pl = g.planes[p];
    pl.w = p ? (width + g.ssx) >> g.ssx : width;
    pl.h = p ? (height + g.ssy) >> g.ssy : height;
    pl.stride = pl.w;
    pl.px.assign((size_t)pl.stride * pl.h, 0);
  }
}

// libavif's grid checks on a grid's first tile (avifAreGridDimensionsValid
// and the coverage rules of avifDecoderDataAllocateGridImagePlanes): the
// tiles cover the output, its last row and column reach into it, tiles are
// at least 64 samples a side, and a colour grid's tile and output sizes are
// even where its chroma is subsampled
void check_grid(const Coded& c, const Decoder& t, bool alpha) {
  const int64_t tw = t.frame_w, th = t.frame_h;
  bool bad = tw * c.cols < c.width || th * c.rows < c.height || tw * (c.cols - 1) >= c.width ||
             th * (c.rows - 1) >= c.height || tw < 64 || th < 64;
  if (!alpha && !t.mono && t.ssx && ((tw | c.width) & 1)) bad = true;
  if (!alpha && !t.mono && t.ssy && ((th | c.height) & 1)) bad = true;
  if (bad) throw std::runtime_error("Failed to decode frame 0: Invalid image grid");
}

// libavif's scale of a decoded frame to its tile's size, the item's
// `ispe` or the track's `tkhd` (avifImageScaleWithLimit, after the filters
// and film grain): its limits, then each plane at its subsampled size (an
// alpha stream's luma only); the frame takes the new size
void scale_frame(Decoder& t, int tw, int th, bool alpha) {
  if (tw <= 0 || th <= 0 || tw > kImageSizeLimit / th || t.frame_w > kScaleSideLimit ||
      t.frame_h > kScaleSideLimit)
    throw std::runtime_error(std::string("Failed to decode frame 0: Decoding of ") +
                             (alpha ? "alpha plane" : "color planes") + " failed");
  for (int p = 0; p < (alpha ? 1 : t.num_planes()); p++) {
    const int sx = p ? t.ssx : 0, sy = p ? t.ssy : 0;
    Plane& src = t.planes[p];
    Plane dst;
    dst.w = dst.stride = (tw + sx) >> sx;
    dst.h = (th + sy) >> sy;
    dst.px.assign((size_t)dst.stride * dst.h, 0);
    scale::plane({src.px.data(), (t.frame_w + sx) >> sx, (t.frame_h + sy) >> sy, src.stride},
                 {dst.px.data(), dst.w, dst.h, dst.stride}, t.bit_depth > 8);
    src = std::move(dst);
  }
  t.frame_w = tw;
  t.frame_h = th;
}

// the last sequence header OBU's payload in `data`, walking its OBU
// headers as far as they parse (nullptr: none)
const uint8_t* last_sequence_header(const uint8_t* data, size_t size, size_t* n) {
  const uint8_t* found = nullptr;
  for (size_t pos = 0; pos < size;) {
    int type = (data[pos] >> 3) & 15, ext = (data[pos] >> 2) & 1, has_size = (data[pos] >> 1) & 1;
    size_t hdr = 1 + ext;
    uint64_t len = 0;
    if (has_size) {
      for (int i = 0;; i++) {
        if (i == 8 || hdr >= size - pos) return found;
        uint8_t b = data[pos + hdr++];
        len |= (uint64_t)(b & 0x7F) << (7 * i);
        if (!(b & 0x80)) break;
      }
    } else {
      len = size - pos - hdr;
    }
    if (hdr > size - pos || len > size - pos - hdr) return found;
    if (type == 1) {
      found = data + pos + hdr;
      *n = (size_t)len;
    }
    pos += hdr + (size_t)len;
  }
  return found;
}

// decodes the colour image and the alpha image (`a`, a count of 0: none),
// their tiles on up to `threads` threads, each stitched into its image as
// it is done, and converts them as libavif does for Pillow into `out`; the
// first tile's failure in libavif's order (the colour tiles, then the
// alpha's) is the one reported
void decode_images(const Coded& c, const Coded& a, int matrix, int primaries, int full_range,
                   int premultiplied, uint8_t* out, int64_t stride, int threads) {
  const int nc = c.count(), n = nc + a.count();
  // libavif decodes the tiles one after another with one dav1d instance
  // (the colour image's, then the alpha's; but a single colour tile and a
  // single alpha tile have one each), so a tile's data may lean on the
  // sequence header of the tiles before it: each starts from the last one
  std::vector<const uint8_t*> seed(n, nullptr);
  std::vector<size_t> seed_size(n, 0);
  const bool shared = !(nc == 1 && a.count() == 1);
  for (int i = 1; i < n; i++) {
    if (i == nc && !shared) continue;
    const Coded& k = i - 1 >= nc ? a : c;
    const int j = i - 1 >= nc ? i - 1 - nc : i - 1;
    size_t m = 0;
    const uint8_t* sh = last_sequence_header(k.data[j], (size_t)k.sizes[j], &m);
    seed[i] = sh ? sh : seed[i - 1];
    seed_size[i] = sh ? m : seed_size[i - 1];
  }
  Decoder g, ga;
  std::vector<std::exception_ptr> failed(n);
  std::vector<Form> first;  // each image's first tile, once decoded
  first.reserve(2);
  int first_of[2] = {-1, -1};  // its index in `first`; -2: it failed
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<int> next(0);
  auto work = [&] {
    for (int i; (i = next++) < n;) {
      const bool alpha = i >= nc;
      const Coded& k = alpha ? a : c;
      const int j = alpha ? i - nc : i;
      Decoder& image = alpha ? ga : g;
      try {
        Decoder t;
        t.threads = std::max(1, threads / std::min(threads, n));
        if (seed[i]) t.start_from(seed[i], seed_size[i]);
        t.decode(k.data[j], (size_t)k.sizes[j]);
        t.loop_filters();
        t.film_grain();
        if (alpha && !t.color_range) widen_alpha(t);
        if (t.frame_w != k.tile_w || t.frame_h != k.tile_h)
          scale_frame(t, k.tile_w, k.tile_h, alpha);
        if (j == 0) {
          if (k.grid) check_grid(k, t, alpha);
          if (!alpha && k.width == t.frame_w && k.height == t.frame_h) {
            // the only tile is the image: its planes are moved, not copied
            allocate(t, image, 0, 0, alpha);
            for (int p = 0; p < 3; p++) image.planes[p] = std::move(t.planes[p]);
          } else {
            allocate(t, image, k.width, k.height, alpha);
            stitch(t, image, 0, 0, std::min(t.frame_w, k.width), std::min(t.frame_h, k.height),
                   alpha);
          }
          std::lock_guard<std::mutex> lock(mu);
          first.emplace_back(t, alpha);
          first_of[alpha] = (int)first.size() - 1;
          cv.notify_all();
          continue;
        }
        int f;
        {
          std::unique_lock<std::mutex> lock(mu);
          cv.wait(lock, [&] { return first_of[alpha] != -1; });
          f = first_of[alpha];
        }
        if (f < 0) continue;  // the first tile's failure is reported
        if (!(Form(t, alpha) == first[f]))
          throw std::runtime_error("Failed to decode frame 0: Invalid image grid");
        const int x0 = t.frame_w * (j % k.cols), y0 = t.frame_h * (j / k.cols);
        stitch(t, image, x0, y0, std::min(t.frame_w, k.width - x0),
               std::min(t.frame_h, k.height - y0), alpha);
      } catch (...) {
        std::lock_guard<std::mutex> lock(mu);
        failed[i] = std::current_exception();
        if (j == 0) {
          first_of[alpha] = -2;
          cv.notify_all();
        }
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < std::min(threads, n); t++) pool.emplace_back(work);
  work();
  for (std::thread& t : pool) t.join();
  for (int i = 0; i < n; i++) {
    if (!failed[i]) continue;
    if (i < nc) std::rethrow_exception(failed[i]);
    try {
      std::rethrow_exception(failed[i]);
    } catch (const std::exception& e) {
      throw std::runtime_error(std::string("alpha item: ") + e.what());
    }
  }
  if (a.count()) {
    // libavif decodes the alpha only at the colour image's size and depth
    if (a.width != c.width || a.height != c.height)
      throw std::runtime_error("Failed to decode frame 0: Decoding of alpha plane failed");
  }
  const int m = matrix >= 0 ? matrix : g.matrix;
  const int full = full_range >= 0 ? full_range : g.color_range;
  if (reformat_refuses(m, full, g.bit_depth, g.mono, g.ssx))
    throw std::runtime_error("Conversion from YUV failed: Reformat failed");
  convert(g, a.count() ? &ga : nullptr, c.width, c.height, m,
          primaries >= 0 ? primaries : g.primaries, full, premultiplied, out, stride, threads);
}

}  // namespace

extern "C" int64_t av1_decode_grid(const uint8_t* const* tiles, const int64_t* sizes,
                                   const int32_t* color, const int32_t* alpha, int32_t matrix,
                                   int32_t primaries, int32_t full_range, int32_t premultiplied,
                                   int32_t threads, uint8_t* out, int64_t stride, char* err,
                                   int64_t errlen) {
  try {
    Coded c{tiles, sizes, color[0], color[1], color[2], color[3], color[4], color[5], color[6]};
    Coded a{tiles + c.count(), sizes + c.count(), alpha[0], alpha[1], alpha[2], alpha[3],
            alpha[4], alpha[5], alpha[6]};
    decode_images(c, a, matrix, primaries, full_range, premultiplied, out, stride, threads);
    return 0;
  } catch (const std::exception& e) {
    snprintf(err, (size_t)errlen, "%s", e.what());
    return -1;
  }
}

// what the decoder's own parse makes of a frame (its tiles decoded, no
// filter run), into out[22]: the upscaled and coded widths, the height,
// SuperresDenom (8: superres off), the tile columns and rows, each plane's
// FrameRestorationType (0 none, 1 Wiener, 2 self-guided, 3 switchable)
// and LoopRestorationSize, the restoration units of the three planes that
// take none, Wiener and self-guided, whether CDEF and deblocking run,
// apply_grain, the bit offset of clip_to_restricted_range in the data (-1:
// none), mono_chrome, use_128x128_superblock and the bit offset of
// base_q_idx
extern "C" int64_t av1_frame_info(const uint8_t* data, int64_t size, int32_t* out, char* err,
                                  int64_t errlen) {
  try {
    Decoder d;
    d.decode(data, (size_t)size);
    const int v[6] = {d.upscaled_w, d.coded_w, d.frame_h, d.superres_denom,
                       d.tile_cols, d.tile_rows};
    for (int i = 0; i < 6; i++) out[i] = v[i];
    for (int p = 0; p < 3; p++) {
      out[6 + p] = d.lr_type[p];
      out[9 + p] = d.lr_size[p];
    }
    for (int k = 0; k < 3; k++) out[12 + k] = 0;
    for (int p = 0; p < 3; p++)
      for (const Decoder::LrUnit& u : d.lr_units[p]) out[12 + u.type]++;
    out[15] = d.enable_cdef && !d.coded_lossless && !d.allow_intrabc;
    out[16] = d.lf_level[0] || d.lf_level[1];
    out[17] = d.fg.apply;
    out[18] = (int32_t)d.clip_bit;
    out[19] = d.mono;
    out[20] = d.use_128;
    out[21] = (int32_t)d.q_bit;
    return 0;
  } catch (const std::exception& e) {
    snprintf(err, (size_t)errlen, "%s", e.what());
    return -1;
  }
}

// the scaler alone: a w x h plane of samples at `depth` to dw x dh
extern "C" void av1_scale_plane(const uint16_t* src, int32_t w, int32_t h, uint16_t* dst,
                                int32_t dw, int32_t dh, int32_t depth) {
  scale::plane({const_cast<pixel*>(src), w, h, w}, {dst, dw, dh, dw}, depth > 8);
}

// the conversion alone: planes (Y, U, V; alpha or null, full range) of a
// w x h image at `depth`, monochrome or subsampled by (ssx, ssy), into 8-bit
// RGB (RGBA with alpha) as decode_images converts a decoded image
extern "C" int64_t av1_convert_planes(const uint16_t* const* planes, int32_t w, int32_t h,
                                      int32_t depth, int32_t mono, int32_t ssx, int32_t ssy,
                                      int32_t matrix, int32_t primaries, int32_t full,
                                      int32_t premultiplied, uint8_t* out, int64_t stride,
                                      char* err, int64_t errlen) {
  try {
    Decoder d, a;
    d.bit_depth = a.bit_depth = depth;
    d.mono = mono;
    d.ssx = ssx;
    d.ssy = ssy;
    for (int p = 0; p < (mono ? 1 : 3); p++) {
      Plane& pl = d.planes[p];
      pl.w = pl.stride = p ? (w + ssx) >> ssx : w;
      pl.h = p ? (h + ssy) >> ssy : h;
      pl.px.assign(planes[p], planes[p] + (size_t)pl.w * pl.h);
    }
    if (planes[3]) {
      a.planes[0].w = a.planes[0].stride = w;
      a.planes[0].h = h;
      a.planes[0].px.assign(planes[3], planes[3] + (size_t)w * h);
    }
    if (reformat_refuses(matrix, full, depth, mono, ssx))
      throw std::runtime_error("Conversion from YUV failed: Reformat failed");
    convert(d, planes[3] ? &a : nullptr, w, h, matrix, primaries, full, premultiplied, out, stride,
            1);
    return 0;
  } catch (const std::exception& e) {
    snprintf(err, (size_t)errlen, "%s", e.what());
    return -1;
  }
}
