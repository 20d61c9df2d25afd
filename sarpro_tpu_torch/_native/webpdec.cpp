// WebP bitstream decoder: the RGBA libwebp 1.6.0 gives Pillow 12.1 for one
// frame of a .webp file (WebPDecode into MODE_RGBA, as WebPAnimDecoder calls
// it: no dithering, fancy upsampling, straight alpha). Built at first use
// with rasterdec.cpp and j2kdec.cpp into one library
// (sarpro_tpu_torch._native) and bound with ctypes (a plain C interface, no
// Python or PyTorch headers). The container (RIFF, VP8X, ANIM / ANMF, which
// chunks make the frame) is read by io/webp.py; this file decodes the
// frame's VP8 or VP8L chunk and its ALPH chunk. Every step is integer
// arithmetic and follows libwebp's decoder, so the result is bit-equal:
//
//   * VP8L (src/dec/vp8l_dec.c, src/utils/huffman_utils.c,
//     src/dsp/lossless.c): the bit reader, simple and normal prefix codes
//     (the code-length-code order, repeat codes, the length limit; codes
//     that are incomplete or over-subscribed are refused as
//     BuildHuffmanTable refuses them), meta prefix codes, the colour cache,
//     LZ77 with the 120-entry distance map, and the inverse transforms:
//     the predictor's 14 modes with its first-row and first-column rules,
//     cross-colour, subtract-green, colour indexing with pixel bundling and
//     the delta-coded palette;
//   * VP8 key frames (src/dec/vp8_dec.c, tree_dec.c, quant_dec.c,
//     frame_dec.c, src/utils/bit_reader*): the boolean decoder, segments and
//     their map, the quantiser with libwebp's clamps (y2 AC at least 8, UV
//     DC index at most 117), coefficient probability updates, 1 to 8 token
//     partitions, the intra modes, the WHT and the IDCT, the simple and the
//     normal loop filter (sharpness, ref_lf_delta[0] / mode_lf_delta[0],
//     hev thresholds, inner edges kept for a macroblock with coefficients
//     or 4x4 modes);
//   * YUV -> RGB (src/dsp/upsampling.c, src/dsp/yuv.h): the fancy
//     upsampler with its first and last rows and odd sizes, and the 14-bit
//     fixed-point conversion;
//   * ALPH (src/dec/alpha_dec.c, src/dsp/filters.c): raw or VP8L-coded
//     alpha (the green channel of a header-less VP8L stream, with its 8-bit
//     path for a palette-only stream), and the none, horizontal, vertical
//     and gradient unfilters.
//
// Errors are where libwebp fails the decode: a bitstream read past its end,
// a bad code, a copy before the first pixel, a malformed header.
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct WebpError {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw WebpError{what}; }

// ---------------------------------------------------------------------------
// VP8 tables (RFC 6386: coefficient update probabilities, default
// coefficient probabilities, key-frame sub-block mode probabilities in
// libwebp's mode order)
// ---------------------------------------------------------------------------
const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

inline const uint8_t* coeff_update(int t, int b, int c) {
  return kCoeffsUpdateProba + ((t * 8 + b) * 3 + c) * 11;
}
inline const uint8_t* coeff_proba0(int t, int b, int c) {
  return kCoeffsProba0 + ((t * 8 + b) * 3 + c) * 11;
}
inline const uint8_t* bmodes_proba(int top, int left) {
  return kBModesProba + (top * 10 + left) * 9;
}

const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,  18,  19,  20,
    20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,
    35,  36,  37,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,  51,
    52,  53,  54,  55,  56,  57,  58,  59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,
    71,  72,  73,  74,  75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,
    89,  91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122, 124,
    126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};

const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,  20,  21,  22,
    23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
    42,  43,  44,  45,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,  62,
    64,  66,  68,  70,  72,  74,  76,  78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100,
    102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149,
    152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217,
    221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

const uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// ---------------------------------------------------------------------------
// the VP8 boolean decoder (bit_reader_utils / bit_reader_inl_utils with
// 56-bit loads, as libwebp builds it for x86-64: where it runs out of data
// is where libwebp's does)
// ---------------------------------------------------------------------------
struct BoolReader {
  uint64_t value = 0;
  uint32_t range = 255 - 1;
  int bits = -8;
  int eof = 0;
  const uint8_t* buf = nullptr;
  const uint8_t* buf_end = nullptr;
  const uint8_t* buf_max = nullptr;

  void init(const uint8_t* start, size_t size) {
    range = 255 - 1;
    value = 0;
    bits = -8;
    eof = 0;
    buf = start;
    buf_end = start + size;
    buf_max = size >= 8 ? start + size - 8 + 1 : start;
    load_new_bytes();
  }
  void load_final_bytes() {
    if (buf < buf_end) {
      bits += 8;
      value = uint64_t(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  inline void load_new_bytes() {
    if (buf < buf_max) {
      uint64_t in;
      std::memcpy(&in, buf, 8);
      buf += 7;
      value = (__builtin_bswap64(in) >> 8) | (value << 56);
      bits += 56;
    } else {
      load_final_bytes();
    }
  }
  inline int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load_new_bytes();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 ^ __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  inline int get_signed(int v) {
    if (bits < 0) load_new_bytes();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = uint32_t(value >> pos);
    const int32_t mask = int32_t(split - val) >> 31;
    bits -= 1;
    range += uint32_t(mask);
    range |= 1;
    value -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= uint32_t(get_bit(0x80)) << n;
    return v;
  }
  int32_t get_signed_value(int n) {
    const int v = int(get_value(n));
    return get_bit(0x80) ? -v : v;
  }
};

// ---------------------------------------------------------------------------
// VP8 key frame
// ---------------------------------------------------------------------------
constexpr int BPS = 32;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;

enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED,
  B_HD_PRED, B_HU_PRED, NUM_BMODES,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
  // the 16x16 and chroma DC predictors where an edge is missing
  DC_PRED_NOTOP = 4, DC_PRED_NOLEFT = 5, DC_PRED_NOTOPLEFT = 6
};

const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
inline int abs0(int v) { return v < 0 ? -v : v; }

// -- inverse transforms (dsp/dec.c) --
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    ++tmp;
    dst += BPS;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// libwebp picks the full, the "AC3" or the DC-only inverse transform from a
// block's non-zero code; on the coefficients each is picked for, the three
// give the full transform's pixels, so the full one serves every non-zero
// code
void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits >> 30) transform_one(src, dst);
}

void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits & 0xff) {
    transform_one(src + 0 * 16, dst);
    transform_one(src + 1 * 16, dst + 4);
    transform_one(src + 2 * 16, dst + 4 * BPS);
    transform_one(src + 3 * 16, dst + 4 * BPS + 4);
  }
}

// -- intra predictors (dsp/dec.c) --
inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }
#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

void pred_luma16(int mode, uint8_t* dst) {
  switch (mode) {
    case DC_PRED: {
      int DC = 16;
      for (int j = 0; j < 16; ++j) DC += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, DC >> 5, 16);
      break;
    }
    case TM_PRED: true_motion(dst, 16); break;
    case V_PRED:
      for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case H_PRED:
      for (int j = 0; j < 16; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case DC_PRED_NOTOP: {
      int DC = 8;
      for (int j = 0; j < 16; ++j) DC += dst[-1 + j * BPS];
      fill(dst, DC >> 4, 16);
      break;
    }
    case DC_PRED_NOLEFT: {
      int DC = 8;
      for (int i = 0; i < 16; ++i) DC += dst[i - BPS];
      fill(dst, DC >> 4, 16);
      break;
    }
    default: fill(dst, 0x80, 16); break;
  }
}

void pred_chroma8(int mode, uint8_t* dst) {
  switch (mode) {
    case DC_PRED: {
      int dc0 = 8;
      for (int i = 0; i < 8; ++i) dc0 += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc0 >> 4, 8);
      break;
    }
    case TM_PRED: true_motion(dst, 8); break;
    case V_PRED:
      for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case H_PRED:
      for (int j = 0; j < 8; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case DC_PRED_NOTOP: {
      int dc0 = 4;
      for (int i = 0; i < 8; ++i) dc0 += dst[-1 + i * BPS];
      fill(dst, dc0 >> 3, 8);
      break;
    }
    case DC_PRED_NOLEFT: {
      int dc0 = 4;
      for (int i = 0; i < 8; ++i) dc0 += dst[i - BPS];
      fill(dst, dc0 >> 3, 8);
      break;
    }
    default: fill(dst, 0x80, 8); break;
  }
}

void pred_luma4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, int(dc), 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]), avg3(top[0], top[1], top[2]),
                               avg3(top[1], top[2], top[3]), avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS],
                E = dst[-1 + 3 * BPS];
      std::memset(dst + 0 * BPS, avg3(A, B, C), 4);
      std::memset(dst + 1 * BPS, avg3(B, C, D), 4);
      std::memset(dst + 2 * BPS, avg3(C, D, E), 4);
      std::memset(dst + 3 * BPS, avg3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_VL_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
    default: {  // B_HU_PRED
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = uint8_t(L);
      break;
    }
  }
}
#undef DST

// -- loop filter (dsp/dec.c) --
inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline int hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (abs0(p1 - p0) > thresh) || (abs0(q1 - q0) > thresh);
}

inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * abs0(p0 - q0) + abs0(p1 - q1)) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * abs0(p0 - q0) + abs0(p1 - q1)) > t) return 0;
  return abs0(p3 - p2) <= it && abs0(p2 - p1) <= it && abs0(p1 - p0) <= it &&
         abs0(q3 - q2) <= it && abs0(q2 - q1) <= it && abs0(q1 - q0) <= it;
}

void simple_filter16(uint8_t* p, int step, int across, int thresh) {
  // 16 positions `across` apart, each filtered along `step`
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * across, step, thresh2)) do_filter2(p + i * across, step);
}

void filter_loop26(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter6(p, hstride);
      }
    }
    p += vstride;
  }
}

void filter_loop24(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

struct BandProbas {
  uint8_t probas[3][11];
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4;
  uint8_t imodes[16];
  uint8_t uvmode;
  uint8_t segment;
  uint8_t skip;
  uint32_t non_zero_y, non_zero_uv;
};

struct TopSamples {
  uint8_t y[16], u[8], v[8];
};

struct Vp8Decoder {
  // headers
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segments_proba[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  int num_parts_minus_one = 0;
  BoolReader br;
  BoolReader parts[8];
  QuantMatrix dqm[4];
  BandProbas bands[4][8];
  const BandProbas* bands_ptr[4][16 + 1];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];
  // per-row and per-frame state
  std::vector<uint8_t> intra_t;
  uint8_t intra_l[4];
  std::vector<uint8_t> nz, nz_dc;  // [mb_w + 1]: index 0 is the left macroblock
  std::vector<MBData> mb_data;     // one row
  std::vector<TopSamples> yuv_t;
  std::vector<FInfo> finfo;  // the frame's, for the loop filter
  uint8_t yuv_b[YUV_SIZE];
  // the reconstructed frame, in whole macroblocks
  std::vector<uint8_t> ybuf, ubuf, vbuf;
  int y_stride = 0, uv_stride = 0;

  void get_headers(const uint8_t* buf, size_t size);
  void parse_segment_header();
  void parse_filter_header();
  void parse_partitions(const uint8_t* buf, size_t size);
  void parse_quant();
  void parse_proba();
  void precompute_filter_strengths();
  void parse_intra_mode(int mb_x);
  bool decode_mb(int mb_x, BoolReader& token_br);
  bool parse_residuals(int mb_x, BoolReader& token_br);
  void reconstruct_row(int mb_y);
  void filter_frame();
  void decode(const uint8_t* buf, size_t size);
};

void Vp8Decoder::get_headers(const uint8_t* buf, size_t size) {
  if (size < 4) fail("VP8: Truncated header.");
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3) fail("VP8: Incorrect keyframe parameters.");
  if (!show) fail("VP8: Frame not displayable.");
  buf += 3;
  size -= 3;
  if (key_frame) {
    if (size < 7) fail("VP8: cannot parse picture header");
    if (!(buf[0] == 0x9d && buf[1] == 0x01 && buf[2] == 0x2a)) fail("VP8: Bad code word");
    width = ((buf[4] << 8) | buf[3]) & 0x3fff;
    height = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    size -= 7;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
  }
  if (partition_length > size) fail("VP8: bad partition length");
  br.init(buf, partition_length);
  buf += partition_length;
  size -= partition_length;
  if (key_frame) {
    br.get_value(1);  // colour space
    br.get_value(1);  // clamping type
  }
  parse_segment_header();
  if (br.eof) fail("VP8: cannot parse segment header");
  parse_filter_header();
  if (br.eof) fail("VP8: cannot parse filter header");
  parse_partitions(buf, size);
  parse_quant();
  if (!key_frame) fail("VP8: Not a key frame.");
  br.get_value(1);  // update_proba, ignored
  parse_proba();
}

void Vp8Decoder::parse_segment_header() {
  use_segment = br.get_value(1);
  if (use_segment) {
    update_map = br.get_value(1);
    if (br.get_value(1)) {  // update data
      absolute_delta = br.get_value(1);
      for (int s = 0; s < 4; ++s) quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s)
        filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) segments_proba[s] = br.get_value(1) ? br.get_value(8) : 255u;
  } else {
    update_map = 0;
  }
}

void Vp8Decoder::parse_filter_header() {
  simple = br.get_value(1);
  level = br.get_value(6);
  sharpness = br.get_value(3);
  use_lf_delta = br.get_value(1);
  if (use_lf_delta) {
    if (br.get_value(1)) {
      for (int i = 0; i < 4; ++i)
        if (br.get_value(1)) ref_lf_delta[i] = br.get_signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.get_value(1)) mode_lf_delta[i] = br.get_signed_value(6);
    }
  }
  filter_type = (level == 0) ? 0 : simple ? 1 : 2;
}

void Vp8Decoder::parse_partitions(const uint8_t* buf, size_t size) {
  const uint8_t* sz = buf;
  const uint8_t* buf_end = buf + size;
  size_t size_left = size;
  num_parts_minus_one = (1 << br.get_value(2)) - 1;
  const size_t last_part = size_t(num_parts_minus_one);
  if (size < 3 * last_part) fail("VP8: cannot parse partitions");
  const uint8_t* part_start = buf + last_part * 3;
  size_left -= last_part * 3;
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  parts[last_part].init(part_start, size_left);
  if (!(part_start < buf_end)) fail("VP8: cannot parse partitions");
}

void Vp8Decoder::parse_quant() {
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  const int base_q0 = br.get_value(7);
  const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = quantizer[i];
      if (!absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        dqm[i] = dqm[0];
        continue;
      }
      q = base_q0;
    }
    QuantMatrix& m = dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q + 0, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 for x in [0, 284], as (x * 101581) >> 16
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void Vp8Decoder::parse_proba() {
  for (int t = 0; t < 4; ++t) {
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int v = br.get_bit(coeff_update(t, b, c)[p]) ? int(br.get_value(8))
                                                              : coeff_proba0(t, b, c)[p];
          bands[t][b].probas[c][p] = uint8_t(v);
        }
    for (int b = 0; b < 16 + 1; ++b) bands_ptr[t][b] = &bands[t][kBands[b]];
  }
  use_skip_proba = br.get_value(1);
  if (use_skip_proba) skip_p = br.get_value(8);
}

void Vp8Decoder::precompute_filter_strengths() {
  if (filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment) {
      base_level = filter_strength[s];
      if (!absolute_delta) base_level += level;
    } else {
      base_level = level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = fstrengths[s][i4x4];
      int lvl = base_level;
      if (use_lf_delta) {
        lvl += ref_lf_delta[0];
        if (i4x4) lvl += mode_lf_delta[0];
      }
      lvl = (lvl < 0) ? 0 : (lvl > 63) ? 63 : lvl;
      if (lvl > 0) {
        int ilevel = lvl;
        if (sharpness > 0) {
          if (sharpness > 4) {
            ilevel >>= 2;
          } else {
            ilevel >>= 1;
          }
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * lvl + ilevel;
        info.hev_thresh = (lvl >= 40) ? 2 : (lvl >= 15) ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = i4x4;
    }
  }
}

void Vp8Decoder::parse_intra_mode(int mb_x) {
  uint8_t* const top = intra_t.data() + 4 * mb_x;
  uint8_t* const left = intra_l;
  MBData& block = mb_data[mb_x];
  if (update_map) {
    block.segment = !br.get_bit(segments_proba[0]) ? br.get_bit(segments_proba[1])
                                                   : br.get_bit(segments_proba[2]) + 2;
  } else {
    block.segment = 0;
  }
  block.skip = use_skip_proba ? br.get_bit(skip_p) : 0;
  block.is_i4x4 = !br.get_bit(145);
  if (!block.is_i4x4) {
    const int ymode = br.get_bit(156) ? (br.get_bit(128) ? TM_PRED : H_PRED)
                                      : (br.get_bit(163) ? V_PRED : DC_PRED);
    block.imodes[0] = uint8_t(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* const prob = bmodes_proba(top[x], ymode);
        ymode = !br.get_bit(prob[0])   ? B_DC_PRED
                : !br.get_bit(prob[1]) ? B_TM_PRED
                : !br.get_bit(prob[2]) ? B_VE_PRED
                : !br.get_bit(prob[3])
                    ? (!br.get_bit(prob[4]) ? B_HE_PRED
                                            : (!br.get_bit(prob[5]) ? B_RD_PRED : B_VR_PRED))
                    : (!br.get_bit(prob[6])
                           ? B_LD_PRED
                           : (!br.get_bit(prob[7])
                                  ? B_VL_PRED
                                  : (!br.get_bit(prob[8]) ? B_HD_PRED : B_HU_PRED)));
        top[x] = uint8_t(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = uint8_t(ymode);
    }
  }
  block.uvmode = !br.get_bit(142)   ? DC_PRED
                 : !br.get_bit(114) ? V_PRED
                 : br.get_bit(183)  ? TM_PRED
                                    : H_PRED;
}

int get_large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.get_bit(p[3])) {
    if (!br.get_bit(p[4])) {
      v = 2;
    } else {
      v = 3 + br.get_bit(p[5]);
    }
  } else {
    if (!br.get_bit(p[6])) {
      if (!br.get_bit(p[7])) {
        v = 5 + br.get_bit(159);
      } else {
        v = 7 + 2 * br.get_bit(165);
        v += br.get_bit(145);
      }
    } else {
      const int bit1 = br.get_bit(p[8]);
      const int bit0 = br.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

int get_coeffs(BoolReader& br, const BandProbas* const prob[], int ctx, const int dq[2], int n,
               int16_t* out) {
  const uint8_t* p = prob[n]->probas[ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;  // previous coefficient was the last non-zero one
    while (!br.get_bit(p[1])) {       // a run of zeros
      p = prob[++n]->probas[0];
      if (n == 16) return 16;
    }
    const BandProbas* const p_ctx = prob[n + 1];
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = p_ctx->probas[1];
    } else {
      v = get_large_value(br, p);
      p = p_ctx->probas[2];
    }
    out[kZigzag[n]] = int16_t(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : uint32_t(dc_nz);
  return nz_coeffs;
}

bool Vp8Decoder::parse_residuals(int mb_x, BoolReader& token_br) {
  const BandProbas* const* bp = nullptr;
  MBData& block = mb_data[mb_x];
  const QuantMatrix& q = dqm[block.segment];
  int16_t* dst = block.coeffs;
  uint8_t& mb_nz = nz[mb_x + 1];
  uint8_t& mb_nz_dc = nz_dc[mb_x + 1];
  uint8_t& left_nz = nz[0];
  uint8_t& left_nz_dc = nz_dc[0];
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first;
  std::memset(dst, 0, 384 * sizeof(*dst));
  if (!block.is_i4x4) {  // the DC of the 16 luma blocks, through the WHT
    int16_t dc[16] = {0};
    const int ctx = mb_nz_dc + left_nz_dc;
    const int n = get_coeffs(token_br, bands_ptr[1], ctx, q.y2, 0, dc);
    mb_nz_dc = left_nz_dc = (n > 0);
    transform_wht(dc, dst);  // libwebp's DC-only shortcut gives the same DCs
    first = 1;
    bp = bands_ptr[0];
  } else {
    first = 0;
    bp = bands_ptr[3];
  }
  uint8_t tnz = mb_nz & 0x0f;
  uint8_t lnz = left_nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int n = get_coeffs(token_br, bp, ctx, q.y1, first, dst);
      l = (n > first);
      tnz = uint8_t((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, n, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = uint8_t((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz;
  uint32_t out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = uint8_t(mb_nz >> (4 + ch));
    lnz = uint8_t(left_nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int n = get_coeffs(token_br, bands_ptr[2], ctx, q.uv, 0, dst);
        l = (n > 0);
        tnz = uint8_t((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, n, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = uint8_t((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= uint32_t(tnz << 4) << ch;
    out_l_nz |= uint32_t(lnz & 0xf0) << ch;
  }
  mb_nz = uint8_t(out_t_nz);
  left_nz = uint8_t(out_l_nz);
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

bool Vp8Decoder::decode_mb(int mb_x, BoolReader& token_br) {
  MBData& block = mb_data[mb_x];
  int skip = use_skip_proba ? block.skip : 0;
  if (!skip) {
    skip = parse_residuals(mb_x, token_br);
  } else {
    nz[0] = nz[mb_x + 1] = 0;
    if (!block.is_i4x4) nz_dc[0] = nz_dc[mb_x + 1] = 0;
    block.non_zero_y = 0;
    block.non_zero_uv = 0;
  }
  return skip;
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return (mb_y == 0) ? DC_PRED_NOTOPLEFT : DC_PRED_NOLEFT;
    return (mb_y == 0) ? DC_PRED_NOTOP : B_DC_PRED;
  }
  return mode;
}

void Vp8Decoder::reconstruct_row(int mb_y) {
  uint8_t* const y_dst = yuv_b + Y_OFF;
  uint8_t* const u_dst = yuv_b + U_OFF;
  uint8_t* const v_dst = yuv_b + V_OFF;
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * BPS - 1] = 129;
    v_dst[j * BPS - 1] = 129;
  }
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {
    std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    std::memset(u_dst - BPS - 1, 127, 8 + 1);
    std::memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
    const MBData& block = mb_data[mb_x];
    if (mb_x > 0) {  // rotate in the left samples of the previous block
      for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
      for (int j = -1; j < 8; ++j) {
        std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
        std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
      }
    }
    TopSamples* const top_yuv = yuv_t.data() + mb_x;
    const int16_t* const coeffs = block.coeffs;
    uint32_t bits = block.non_zero_y;
    if (mb_y > 0) {
      std::memcpy(y_dst - BPS, top_yuv[0].y, 16);
      std::memcpy(u_dst - BPS, top_yuv[0].u, 8);
      std::memcpy(v_dst - BPS, top_yuv[0].v, 8);
    }
    if (block.is_i4x4) {
      uint8_t* const top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w - 1) {
          std::memset(top_right, top_yuv[0].y[15], 4);
        } else {
          std::memcpy(top_right, top_yuv[1].y, 4);
        }
      }
      // the top-right samples stand in for those right of each 4x4 row
      for (int k = 1; k <= 3; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* const dst = y_dst + kScan[n];
        pred_luma4(block.imodes[n], dst);
        do_transform(bits, coeffs + n * 16, dst);
      }
    } else {
      pred_luma16(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
      for (int n = 0; n < 16; ++n, bits <<= 2)
        do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
    }
    {
      const uint32_t bits_uv = block.non_zero_uv;
      const int pred = check_mode(mb_x, mb_y, block.uvmode);
      pred_chroma8(pred, u_dst);
      pred_chroma8(pred, v_dst);
      do_uv_transform(bits_uv >> 0, coeffs + 16 * 16, u_dst);
      do_uv_transform(bits_uv >> 8, coeffs + 20 * 16, v_dst);
    }
    if (mb_y < mb_h - 1) {
      std::memcpy(top_yuv[0].y, y_dst + 15 * BPS, 16);
      std::memcpy(top_yuv[0].u, u_dst + 7 * BPS, 8);
      std::memcpy(top_yuv[0].v, v_dst + 7 * BPS, 8);
    }
    uint8_t* const y_out = ybuf.data() + size_t(mb_y) * 16 * y_stride + mb_x * 16;
    uint8_t* const u_out = ubuf.data() + size_t(mb_y) * 8 * uv_stride + mb_x * 8;
    uint8_t* const v_out = vbuf.data() + size_t(mb_y) * 8 * uv_stride + mb_x * 8;
    for (int j = 0; j < 16; ++j) std::memcpy(y_out + size_t(j) * y_stride, y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(u_out + size_t(j) * uv_stride, u_dst + j * BPS, 8);
      std::memcpy(v_out + size_t(j) * uv_stride, v_dst + j * BPS, 8);
    }
  }
}

// The in-loop filter over the reconstructed frame, macroblock by macroblock
// in raster order (libwebp filters each row once it is reconstructed, with
// prediction from unfiltered samples: the same order of operations).
void Vp8Decoder::filter_frame() {
  if (filter_type == 0) return;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const FInfo& f = finfo[size_t(mb_y) * mb_w + mb_x];
      const int limit = f.limit;
      if (limit == 0) continue;
      uint8_t* const y_dst = ybuf.data() + size_t(mb_y) * 16 * y_stride + mb_x * 16;
      const int ys = y_stride;
      if (filter_type == 1) {  // simple
        if (mb_x > 0) simple_filter16(y_dst, 1, ys, limit + 4);
        if (f.inner)
          for (int k = 1; k <= 3; ++k) simple_filter16(y_dst + 4 * k, 1, ys, limit);
        if (mb_y > 0) simple_filter16(y_dst, ys, 1, limit + 4);
        if (f.inner)
          for (int k = 1; k <= 3; ++k) simple_filter16(y_dst + 4 * k * ys, ys, 1, limit);
      } else {  // complex
        const int us = uv_stride;
        uint8_t* const u_dst = ubuf.data() + size_t(mb_y) * 8 * us + mb_x * 8;
        uint8_t* const v_dst = vbuf.data() + size_t(mb_y) * 8 * us + mb_x * 8;
        const int il = f.ilevel, hv = f.hev_thresh;
        if (mb_x > 0) {
          filter_loop26(y_dst, 1, ys, 16, limit + 4, il, hv);
          filter_loop26(u_dst, 1, us, 8, limit + 4, il, hv);
          filter_loop26(v_dst, 1, us, 8, limit + 4, il, hv);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k) filter_loop24(y_dst + 4 * k, 1, ys, 16, limit, il, hv);
          filter_loop24(u_dst + 4, 1, us, 8, limit, il, hv);
          filter_loop24(v_dst + 4, 1, us, 8, limit, il, hv);
        }
        if (mb_y > 0) {
          filter_loop26(y_dst, ys, 1, 16, limit + 4, il, hv);
          filter_loop26(u_dst, us, 1, 8, limit + 4, il, hv);
          filter_loop26(v_dst, us, 1, 8, limit + 4, il, hv);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k)
            filter_loop24(y_dst + 4 * k * ys, ys, 1, 16, limit, il, hv);
          filter_loop24(u_dst + 4 * us, us, 1, 8, limit, il, hv);
          filter_loop24(v_dst + 4 * us, us, 1, 8, limit, il, hv);
        }
      }
    }
  }
}

void Vp8Decoder::decode(const uint8_t* buf, size_t size) {
  get_headers(buf, size);
  precompute_filter_strengths();
  y_stride = mb_w * 16;
  uv_stride = mb_w * 8;
  ybuf.assign(size_t(y_stride) * mb_h * 16, 0);
  ubuf.assign(size_t(uv_stride) * mb_h * 8, 0);
  vbuf.assign(size_t(uv_stride) * mb_h * 8, 0);
  intra_t.assign(size_t(4) * mb_w, B_DC_PRED);
  nz.assign(size_t(mb_w) + 1, 0);
  nz_dc.assign(size_t(mb_w) + 1, 0);
  mb_data.resize(size_t(mb_w));
  yuv_t.resize(size_t(mb_w));
  finfo.assign(size_t(mb_w) * mb_h, FInfo());
  std::memset(yuv_b, 0, sizeof yuv_b);
  std::memset(intra_l, B_DC_PRED, sizeof intra_l);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolReader& token_br = parts[mb_y & num_parts_minus_one];
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(mb_x);
    if (br.eof) fail("VP8: Premature end-of-partition0 encountered.");
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const int skip = decode_mb(mb_x, token_br);
      if (filter_type > 0) {
        const MBData& block = mb_data[mb_x];
        FInfo& f = finfo[size_t(mb_y) * mb_w + mb_x];
        f = fstrengths[block.segment][block.is_i4x4];
        f.inner |= !skip;
      }
      if (token_br.eof) fail("VP8: Premature end-of-file encountered.");
    }
    // the next row starts with no left context
    nz[0] = 0;
    nz_dc[0] = 0;
    std::memset(intra_l, B_DC_PRED, sizeof intra_l);
    reconstruct_row(mb_y);
  }
  filter_frame();
}

// -- YUV -> RGB (dsp/yuv.h) and the fancy upsampler (dsp/upsampling.c) --
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) { return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = uint8_t(yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgb[1] = uint8_t(yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
  rgb[2] = uint8_t(yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len, int xstep) {
  auto load_uv = [](uint32_t u, uint32_t v) { return u | (v << 16); };
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = load_uv(top_u[0], top_v[0]);
  uint32_t l_uv = load_uv(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y != nullptr) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = load_uv(top_u[x], top_v[x]);
    const uint32_t uv = load_uv(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * xstep);
      yuv_to_rgb(top_y[2 * x - 0], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x - 0) * xstep);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * xstep);
      yuv_to_rgb(bottom_y[2 * x + 0], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x + 0) * xstep);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * xstep);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * xstep);
    }
  }
}

// ---------------------------------------------------------------------------
// VP8L (lossless) and the VP8L-coded alpha plane
// ---------------------------------------------------------------------------
// The bit reader of src/utils/bit_reader_utils.c (VP8LBitReader), with its
// end-of-stream rule: a read past the data's end (or past 64 bits for a
// stream shorter than 8 bytes) sets eos.
struct LBitReader {
  uint64_t val = 0;
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  int bit_pos = 0;
  int eos = 0;

  void init(const uint8_t* start, size_t length) {
    len = length;
    val = 0;
    bit_pos = 0;
    eos = 0;
    size_t n = length > 8 ? 8 : length;
    uint64_t value = 0;
    for (size_t i = 0; i < n; ++i) value |= uint64_t(start[i]) << (8 * i);
    val = value;
    pos = n;
    buf = start;
  }
  inline bool is_end() const { return eos || (pos == len && bit_pos > 64); }
  inline void set_end() {
    eos = 1;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= uint64_t(buf[pos]) << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (is_end()) set_end();
  }
  inline void fill() {
    if (bit_pos >= 32) {
      if (pos + 8 < len) {
        val >>= 32;
        bit_pos -= 32;
        uint32_t w;
        std::memcpy(&w, buf + pos, 4);
        val |= uint64_t(w) << 32;
        pos += 4;
        return;
      }
      shift_bytes();
    }
  }
  inline uint32_t prefetch() const { return uint32_t(val >> (bit_pos & 63)); }
  uint32_t read_bits(int n) {
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end();
    return 0;
  }
};

struct HuffmanCode {
  uint8_t bits;
  uint16_t value;
};

constexpr int HUFFMAN_TABLE_BITS = 8;
constexpr int HUFFMAN_TABLE_MASK = (1 << HUFFMAN_TABLE_BITS) - 1;
constexpr int LENGTHS_TABLE_BITS = 7;
constexpr int MAX_ALLOWED_CODE_LENGTH = 15;
constexpr int NUM_LITERAL_CODES = 256;
constexpr int NUM_LENGTH_CODES = 24;
constexpr int NUM_DISTANCE_CODES = 40;
constexpr int NUM_CODE_LENGTH_CODES = 19;
constexpr int MAX_CACHE_BITS = 11;
constexpr int GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4;
const int kAlphabetSize[5] = {NUM_LITERAL_CODES + NUM_LENGTH_CODES, NUM_LITERAL_CODES,
                              NUM_LITERAL_CODES, NUM_LITERAL_CODES, NUM_DISTANCE_CODES};
const uint8_t kCodeLengthCodeOrder[NUM_CODE_LENGTH_CODES] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                                             7,  8,  9, 10, 11, 12, 13, 14, 15};
// (dy << 4) | (8 - dx) of the 120 short distances (RFC 9649, 5.2.2)
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

inline uint32_t get_next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

inline void replicate_value(HuffmanCode* table, int step, int end, HuffmanCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

inline int next_table_bit_size(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < MAX_ALLOWED_CODE_LENGTH) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// huffman_utils.c's BuildHuffmanTable: the table's size, 0 for a code it
// refuses; fills root_table when given (sized by a first call without it).
int build_huffman_table(HuffmanCode* root_table, int root_bits, const int* code_lengths,
                        int code_lengths_size) {
  HuffmanCode* table = root_table;
  int total_size = 1 << root_bits;
  int count[MAX_ALLOWED_CODE_LENGTH + 1] = {0};
  int offset[MAX_ALLOWED_CODE_LENGTH + 1];
  std::vector<uint16_t> sorted;
  for (int symbol = 0; symbol < code_lengths_size; ++symbol) {
    if (code_lengths[symbol] > MAX_ALLOWED_CODE_LENGTH) return 0;
    ++count[code_lengths[symbol]];
  }
  if (count[0] == code_lengths_size) return 0;
  offset[1] = 0;
  for (int len = 1; len < MAX_ALLOWED_CODE_LENGTH; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  if (root_table != nullptr) sorted.resize(size_t(code_lengths_size));
  for (int symbol = 0; symbol < code_lengths_size; ++symbol) {
    const int l = code_lengths[symbol];
    if (l > 0) {
      if (root_table != nullptr) {
        sorted[size_t(offset[l]++)] = uint16_t(symbol);
      } else {
        offset[l]++;
      }
    }
  }
  if (offset[MAX_ALLOWED_CODE_LENGTH] == 1) {  // a code of one symbol: no bits
    if (root_table != nullptr) replicate_value(table, 1, total_size, HuffmanCode{0, sorted[0]});
    return total_size;
  }
  int step;
  uint32_t low = 0xffffffffu;
  const uint32_t mask = uint32_t(total_size - 1);
  uint32_t key = 0;
  int num_nodes = 1;
  int num_open = 1;
  int table_bits = root_bits;
  int table_size = 1 << table_bits;
  int symbol = 0;
  int len;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    if (root_table == nullptr) continue;
    for (; count[len] > 0; --count[len]) {
      replicate_value(&table[key], step, table_size,
                      HuffmanCode{uint8_t(len), sorted[size_t(symbol++)]});
      key = get_next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= MAX_ALLOWED_CODE_LENGTH; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        if (root_table != nullptr) table += table_size;
        table_bits = next_table_bit_size(count, len, root_bits);
        table_size = 1 << table_bits;
        total_size += table_size;
        low = key & mask;
        if (root_table != nullptr) {
          root_table[low].bits = uint8_t(table_bits + root_bits);
          root_table[low].value = uint16_t((table - root_table) - low);
        }
      }
      if (root_table != nullptr)
        replicate_value(&table[key >> root_bits], step, table_size,
                        HuffmanCode{uint8_t(len - root_bits), sorted[size_t(symbol++)]});
      key = get_next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[MAX_ALLOWED_CODE_LENGTH] - 1) return 0;  // not a full tree
  return total_size;
}

inline int read_symbol(const HuffmanCode* table, LBitReader& br) {
  uint32_t val = br.prefetch();
  table += val & HUFFMAN_TABLE_MASK;
  const int nbits = table->bits - HUFFMAN_TABLE_BITS;
  if (nbits > 0) {
    br.bit_pos += HUFFMAN_TABLE_BITS;
    val = br.prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.bit_pos += table->bits;
  return table->value;
}

struct HTreeGroup {
  size_t offsets[5] = {0, 0, 0, 0, 0};  // into Meta::tables
  const HuffmanCode* htrees[5] = {nullptr, nullptr, nullptr, nullptr, nullptr};
};

// The prefix codes, meta codes and colour cache of one image stream.
struct Meta {
  int color_cache_size = 0;
  int cache_shift = 32;
  std::vector<uint32_t> cache;
  std::vector<uint32_t> huffman_image;
  int huffman_subsample_bits = 0;
  int huffman_xsize = 0;
  int huffman_mask = ~0;
  std::vector<HuffmanCode> tables;
  std::vector<HTreeGroup> groups;

  inline const HTreeGroup* group_for(int x, int y) const {
    if (huffman_subsample_bits == 0) return &groups[0];
    const int idx = int(huffman_image[size_t(huffman_xsize) * size_t(y >> huffman_subsample_bits) +
                                      size_t(x >> huffman_subsample_bits)]);
    return &groups[size_t(idx)];
  }
  inline void cache_insert(uint32_t argb) {
    cache[(argb * 0x1e35a7bdu) >> cache_shift] = argb;
  }
};

enum { PREDICTOR_TRANSFORM = 0, CROSS_COLOR_TRANSFORM = 1, SUBTRACT_GREEN_TRANSFORM = 2,
       COLOR_INDEXING_TRANSFORM = 3 };

struct Transform {
  int type = 0;
  int bits = 0;
  int xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline int subsample_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline int get_copy_distance(int sym, LBitReader& br) {
  if (sym < 4) return sym + 1;
  const int extra_bits = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra_bits;
  return offset + int(br.read_bits(extra_bits)) + 1;
}

inline int plane_code_to_distance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return (dist >= 1) ? dist : 1;
}

struct Vp8lDecoder {
  LBitReader br;
  Transform transforms[4];
  int next_transform = 0;
  uint32_t transforms_seen = 0;
  int width = 0, height = 0;  // of the level-0 stream, after the transforms' subsampling
  Meta hdr;                   // level 0's codes

  bool read_transform(int* xsize, int ysize);
  bool read_huffman_code(int alphabet_size, std::vector<int>& code_lengths, Meta* m, size_t* at);
  bool read_code_lengths(const int* cl_code_lengths, int num_symbols, std::vector<int>& lengths);
  bool read_huffman_codes(Meta& m, int xsize, int ysize, int color_cache_bits,
                          bool allow_recursion);
  bool decode_image_stream(int xsize, int ysize, bool is_level0, std::vector<uint32_t>* out);
  bool decode_image_data(Meta& m, uint32_t* data, int w, int h);
  bool decode_alpha_data(uint8_t* data, int w, int h);
};

bool Vp8lDecoder::read_transform(int* xsize, int ysize) {
  const int type = int(br.read_bits(2));
  if (transforms_seen & (1u << type)) return false;  // each transform at most once
  transforms_seen |= (1u << type);
  Transform& t = transforms[next_transform++];
  t.type = type;
  t.xsize = *xsize;
  t.ysize = ysize;
  t.data.clear();
  switch (type) {
    case PREDICTOR_TRANSFORM:
    case CROSS_COLOR_TRANSFORM:
      t.bits = int(br.read_bits(3)) + 2;
      return decode_image_stream(subsample_size(t.xsize, t.bits), subsample_size(t.ysize, t.bits),
                                 false, &t.data);
    case COLOR_INDEXING_TRANSFORM: {
      const int num_colors = int(br.read_bits(8)) + 1;
      const int bits = (num_colors > 16) ? 0 : (num_colors > 4) ? 1 : (num_colors > 2) ? 2 : 3;
      *xsize = subsample_size(t.xsize, bits);
      t.bits = bits;
      if (!decode_image_stream(num_colors, 1, false, &t.data)) return false;
      // the palette is delta-coded; entries past it are transparent black
      const int final_num_colors = 1 << (8 >> bits);
      std::vector<uint32_t> map(size_t(final_num_colors), 0);
      uint8_t* const nd = reinterpret_cast<uint8_t*>(map.data());
      const uint8_t* const od = reinterpret_cast<const uint8_t*>(t.data.data());
      map[0] = t.data[0];
      int i;
      for (i = 4; i < 4 * num_colors; ++i) nd[i] = uint8_t((od[i] + nd[i - 4]) & 0xff);
      for (; i < 4 * final_num_colors; ++i) nd[i] = 0;
      t.data.swap(map);
      return true;
    }
    default:  // subtract green
      return true;
  }
}

bool Vp8lDecoder::read_code_lengths(const int* cl_code_lengths, int num_symbols,
                                    std::vector<int>& code_lengths) {
  const int size = build_huffman_table(nullptr, LENGTHS_TABLE_BITS, cl_code_lengths,
                                       NUM_CODE_LENGTH_CODES);
  if (size == 0) return false;
  std::vector<HuffmanCode> table(static_cast<size_t>(size));
  build_huffman_table(table.data(), LENGTHS_TABLE_BITS, cl_code_lengths, NUM_CODE_LENGTH_CODES);
  int max_symbol;
  if (br.read_bits(1)) {  // the count of code lengths is given
    const int length_nbits = 2 + 2 * int(br.read_bits(3));
    max_symbol = 2 + int(br.read_bits(length_nbits));
    if (max_symbol > num_symbols) return false;
  } else {
    max_symbol = num_symbols;
  }
  int symbol = 0;
  int prev_code_len = 8;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    br.fill();
    const HuffmanCode& p = table[br.prefetch() & ((1u << LENGTHS_TABLE_BITS) - 1)];
    br.bit_pos += p.bits;
    const int code_len = p.value;
    if (code_len < 16) {
      code_lengths[size_t(symbol++)] = code_len;
      if (code_len != 0) prev_code_len = code_len;
    } else {
      static const uint8_t kExtraBits[3] = {2, 3, 7};
      static const uint8_t kRepeatOffsets[3] = {3, 3, 11};
      const int use_prev = (code_len == 16);
      const int slot = code_len - 16;
      int repeat = int(br.read_bits(kExtraBits[slot])) + kRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) return false;
      const int length = use_prev ? prev_code_len : 0;
      while (repeat-- > 0) code_lengths[size_t(symbol++)] = length;
    }
  }
  return true;
}

// One prefix code; with `m`, its table appended to m->tables at *at.
bool Vp8lDecoder::read_huffman_code(int alphabet_size, std::vector<int>& code_lengths, Meta* m,
                                    size_t* at) {
  const int simple_code = int(br.read_bits(1));
  std::fill(code_lengths.begin(), code_lengths.begin() + alphabet_size, 0);
  bool ok;
  if (simple_code) {  // one or two symbols, coded directly
    const int num_symbols = int(br.read_bits(1)) + 1;
    const int first_symbol_len_code = int(br.read_bits(1));
    int symbol = int(br.read_bits(first_symbol_len_code == 0 ? 1 : 8));
    code_lengths[size_t(symbol)] = 1;
    if (num_symbols == 2) {
      symbol = int(br.read_bits(8));
      code_lengths[size_t(symbol)] = 1;
    }
    ok = true;
  } else {
    int cl_code_lengths[NUM_CODE_LENGTH_CODES] = {0};
    const int num_codes = int(br.read_bits(4)) + 4;
    for (int i = 0; i < num_codes; ++i)
      cl_code_lengths[kCodeLengthCodeOrder[i]] = int(br.read_bits(3));
    ok = read_code_lengths(cl_code_lengths, alphabet_size, code_lengths);
  }
  ok = ok && !br.eos;
  if (!ok) return false;
  const int size =
      build_huffman_table(nullptr, HUFFMAN_TABLE_BITS, code_lengths.data(), alphabet_size);
  if (size == 0) return false;
  if (m != nullptr) {
    *at = m->tables.size();
    m->tables.resize(*at + size_t(size));
    build_huffman_table(m->tables.data() + *at, HUFFMAN_TABLE_BITS, code_lengths.data(),
                        alphabet_size);
  }
  return true;
}

bool Vp8lDecoder::read_huffman_codes(Meta& m, int xsize, int ysize, int color_cache_bits,
                                     bool allow_recursion) {
  int num_htree_groups = 1;
  int num_htree_groups_max = 1;
  std::vector<int> mapping;
  if (allow_recursion && br.read_bits(1)) {  // meta prefix codes
    const int huffman_precision = 2 + int(br.read_bits(3));
    const int huffman_xsize = subsample_size(xsize, huffman_precision);
    const int huffman_ysize = subsample_size(ysize, huffman_precision);
    const size_t huffman_pixs = size_t(huffman_xsize) * size_t(huffman_ysize);
    std::vector<uint32_t> image;
    if (!decode_image_stream(huffman_xsize, huffman_ysize, false, &image)) return false;
    m.huffman_subsample_bits = huffman_precision;
    for (size_t i = 0; i < huffman_pixs; ++i) {
      const int group = int((image[i] >> 8) & 0xffff);
      image[i] = uint32_t(group);
      if (group >= num_htree_groups_max) num_htree_groups_max = group + 1;
    }
    if (num_htree_groups_max > 1000 || int64_t(num_htree_groups_max) > int64_t(xsize) * ysize) {
      // only the groups the image uses, renumbered in order of first use
      mapping.assign(size_t(num_htree_groups_max), -1);
      num_htree_groups = 0;
      for (size_t i = 0; i < huffman_pixs; ++i) {
        int& mapped = mapping[image[i]];
        if (mapped == -1) mapped = num_htree_groups++;
        image[i] = uint32_t(mapped);
      }
    } else {
      num_htree_groups = num_htree_groups_max;
    }
    m.huffman_image.swap(image);
  }
  if (br.eos) return false;
  const int max_alphabet_size =
      kAlphabetSize[0] + ((color_cache_bits > 0) ? 1 << color_cache_bits : 0);
  std::vector<int> code_lengths(size_t(max_alphabet_size) > 256 ? size_t(max_alphabet_size) : 256,
                                0);
  m.groups.assign(size_t(num_htree_groups), HTreeGroup());
  m.tables.clear();
  for (int i = 0; i < num_htree_groups_max; ++i) {
    if (!mapping.empty() && mapping[size_t(i)] == -1) {  // unused: read, check, drop
      for (int j = 0; j < 5; ++j) {
        int alphabet_size = kAlphabetSize[j];
        if (j == 0 && color_cache_bits > 0) alphabet_size += 1 << color_cache_bits;
        if (!read_huffman_code(alphabet_size, code_lengths, nullptr, nullptr)) return false;
      }
      continue;
    }
    HTreeGroup& g = m.groups[size_t(mapping.empty() ? i : mapping[size_t(i)])];
    for (int j = 0; j < 5; ++j) {
      int alphabet_size = kAlphabetSize[j];
      if (j == 0 && color_cache_bits > 0) alphabet_size += 1 << color_cache_bits;
      if (!read_huffman_code(alphabet_size, code_lengths, &m, &g.offsets[j])) return false;
    }
  }
  for (HTreeGroup& g : m.groups)
    for (int j = 0; j < 5; ++j) g.htrees[j] = m.tables.data() + g.offsets[j];
  return true;
}

bool Vp8lDecoder::decode_image_stream(int xsize, int ysize, bool is_level0,
                                      std::vector<uint32_t>* out) {
  int transform_xsize = xsize;
  const int transform_ysize = ysize;
  bool ok = true;
  if (is_level0)
    while (ok && br.read_bits(1)) ok = read_transform(&transform_xsize, transform_ysize);
  int color_cache_bits = 0;
  if (ok && br.read_bits(1)) {
    color_cache_bits = int(br.read_bits(4));
    ok = color_cache_bits >= 1 && color_cache_bits <= MAX_CACHE_BITS;
  }
  if (!ok) return false;
  Meta local;
  Meta& m = is_level0 ? hdr : local;
  m = Meta();
  if (!read_huffman_codes(m, transform_xsize, transform_ysize, color_cache_bits, is_level0))
    return false;
  if (color_cache_bits > 0) {
    m.color_cache_size = 1 << color_cache_bits;
    m.cache.assign(size_t(m.color_cache_size), 0);
    m.cache_shift = 32 - color_cache_bits;
  }
  m.huffman_xsize = subsample_size(transform_xsize, m.huffman_subsample_bits);
  m.huffman_mask = (m.huffman_subsample_bits == 0) ? ~0 : (1 << m.huffman_subsample_bits) - 1;
  if (is_level0) {
    width = transform_xsize;
    height = transform_ysize;
    return true;
  }
  out->assign(size_t(transform_xsize) * size_t(transform_ysize), 0);
  ok = decode_image_data(m, out->data(), transform_xsize, transform_ysize);
  return ok && !br.eos;
}

// vp8l_dec.c's DecodeImageData for the whole stream at once: literals,
// backward references and colour-cache codes; false where the data runs out
// or a copy reaches outside the image. (libwebp's shortcuts for codes of one
// symbol read no bits, as read_symbol does for them.)
bool Vp8lDecoder::decode_image_data(Meta& m, uint32_t* data, int w, int h) {
  int row = 0, col = 0;
  uint32_t* src = data;
  uint32_t* last_cached = src;
  uint32_t* const src_end = data + size_t(w) * size_t(h);
  const int len_code_limit = NUM_LITERAL_CODES + NUM_LENGTH_CODES;
  const int color_cache_limit = len_code_limit + m.color_cache_size;
  const bool has_cache = m.color_cache_size > 0;
  const int mask = m.huffman_mask;
  const HTreeGroup* g = (src < src_end) ? m.group_for(col, row) : nullptr;
  while (src < src_end) {
    if ((col & mask) == 0) g = m.group_for(col, row);
    br.fill();
    const int code = read_symbol(g->htrees[GREEN], br);
    if (br.is_end()) break;
    if (code >= NUM_LITERAL_CODES && code < len_code_limit) {  // backward reference
      const int length_sym = code - NUM_LITERAL_CODES;
      const int length = get_copy_distance(length_sym, br);
      const int dist_symbol = read_symbol(g->htrees[DIST], br);
      br.fill();
      const int dist_code = get_copy_distance(dist_symbol, br);
      const int dist = plane_code_to_distance(w, dist_code);
      if (br.is_end()) break;
      if (src - data < std::ptrdiff_t(dist) || src_end - src < std::ptrdiff_t(length)) return false;
      for (int i = 0; i < length; ++i) src[i] = src[i - dist];
      src += length;
      col += length;
      while (col >= w) {
        col -= w;
        ++row;
      }
      if (col & mask) g = m.group_for(col, row);
      if (has_cache)
        while (last_cached < src) m.cache_insert(*last_cached++);
      continue;
    }
    if (code < NUM_LITERAL_CODES) {
      const int red = read_symbol(g->htrees[RED], br);
      br.fill();
      const int blue = read_symbol(g->htrees[BLUE], br);
      const int alpha = read_symbol(g->htrees[ALPHA], br);
      if (br.is_end()) break;
      *src = (uint32_t(alpha) << 24) | (uint32_t(red) << 16) | (uint32_t(code) << 8) |
             uint32_t(blue);
    } else if (code < color_cache_limit) {  // colour cache
      while (last_cached < src) m.cache_insert(*last_cached++);
      *src = m.cache[size_t(code - len_code_limit)];
    } else {
      return false;
    }
    ++src;
    ++col;
    if (col >= w) {
      col = 0;
      ++row;
      if (has_cache)
        while (last_cached < src) m.cache_insert(*last_cached++);
    }
  }
  return !br.is_end();
}

// vp8l_dec.c's DecodeAlphaData: the 8-bit path of an alpha stream whose
// only transform is colour indexing and whose red, blue and alpha codes have
// one symbol each (no colour cache). It stops at the end of the data and
// fails only where pixels remain.
bool Vp8lDecoder::decode_alpha_data(uint8_t* data, int w, int h) {
  int row = 0, col = 0;
  int pos = 0;
  const int end = w * h;
  const int len_code_limit = NUM_LITERAL_CODES + NUM_LENGTH_CODES;
  const int mask = hdr.huffman_mask;
  const HTreeGroup* g = (pos < end) ? hdr.group_for(col, row) : nullptr;
  while (!br.eos && pos < end) {
    if ((col & mask) == 0) g = hdr.group_for(col, row);
    br.fill();
    const int code = read_symbol(g->htrees[GREEN], br);
    if (code < NUM_LITERAL_CODES) {
      data[pos] = uint8_t(code);
      ++pos;
      ++col;
      if (col >= w) {
        col = 0;
        ++row;
      }
    } else if (code < len_code_limit) {
      const int length_sym = code - NUM_LITERAL_CODES;
      const int length = get_copy_distance(length_sym, br);
      const int dist_symbol = read_symbol(g->htrees[DIST], br);
      br.fill();
      const int dist_code = get_copy_distance(dist_symbol, br);
      const int dist = plane_code_to_distance(w, dist_code);
      if (pos >= dist && end - pos >= length) {
        for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      } else {
        return false;
      }
      pos += length;
      col += length;
      while (col >= w) {
        col -= w;
        ++row;
      }
      if (pos < end && (col & mask)) g = hdr.group_for(col, row);
    } else {
      return false;
    }
    br.eos = br.is_end();
  }
  br.eos = br.is_end();
  return !(br.eos && pos < end);
}

// -- inverse transforms (dsp/lossless.c) --
inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a0, uint32_t a1) {
  return (((a0 ^ a1) & 0xfefefefeu) >> 1) + (a0 & a1);
}
inline uint32_t average3(uint32_t a0, uint32_t a1, uint32_t a2) {
  return average2(average2(a0, a2), a1);
}
inline uint32_t average4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3) {
  return average2(average2(a0, a1), average2(a2, a3));
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int add_sub_full(int a, int b, int c) { return int(clip255(uint32_t(a + b - c))); }
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  const int a = add_sub_full(c0 >> 24, c1 >> 24, c2 >> 24);
  const int r = add_sub_full((c0 >> 16) & 0xff, (c1 >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = add_sub_full((c0 >> 8) & 0xff, (c1 >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = add_sub_full(c0 & 0xff, c1 & 0xff, c2 & 0xff);
  return (uint32_t(a) << 24) | (uint32_t(r) << 16) | (uint32_t(g) << 8) | uint32_t(b);
}
inline int add_sub_half(int a, int b) { return int(clip255(uint32_t(a + (a - b) / 2))); }
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  const int a = add_sub_half(ave >> 24, c2 >> 24);
  const int r = add_sub_half((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = add_sub_half((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = add_sub_half(ave & 0xff, c2 & 0xff);
  return (uint32_t(a) << 24) | (uint32_t(r) << 16) | (uint32_t(g) << 8) | uint32_t(b);
}
inline int sub3(int a, int b, int c) {
  const int pb = b - c;
  const int pa = a - c;
  return (pb < 0 ? -pb : pb) - (pa < 0 ? -pa : pa);
}
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return (pa_minus_pb <= 0) ? a : b;
}

// the prediction of mode `mode` for the pixel with left neighbour `left`
// and the row above at `top` (top[-1], top[0], top[1])
inline uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average3(left, top[0], top[1]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average4(left, top[-1], top[0], top[1]);
    case 11: return select_pred(top[0], left, top[-1]);
    case 12: return clamped_add_subtract_full(left, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp maps them
  }
}

// One row of transform `t`'s inverse, `in` to `out`, for row y. The
// predictor keeps its previous output row in `above` (one slot each side:
// top[-1] of the first pixel, and top[1] of the last, which is this row's
// first pixel as in libwebp's contiguous rows).
void inverse_row(const Transform& t, const uint32_t* in, uint32_t* out,
                 std::vector<uint32_t>& above, int y) {
  const int tw = t.xsize;
  switch (t.type) {
    case SUBTRACT_GREEN_TRANSFORM:
      for (int x = 0; x < tw; ++x) {
        const uint32_t argb = in[x];
        const uint32_t green = (argb >> 8) & 0xff;
        uint32_t red_blue = argb & 0x00ff00ffu;
        red_blue += (green << 16) | green;
        red_blue &= 0x00ff00ffu;
        out[x] = (argb & 0xff00ff00u) | red_blue;
      }
      break;
    case CROSS_COLOR_TRANSFORM: {
      const int tiles_per_row = subsample_size(tw, t.bits);
      const uint32_t* codes = t.data.data() + size_t(y >> t.bits) * size_t(tiles_per_row);
      for (int x = 0; x < tw; ++x) {
        const uint32_t code = codes[x >> t.bits];
        const int8_t g2r = int8_t(code & 0xff);
        const int8_t g2b = int8_t((code >> 8) & 0xff);
        const int8_t r2b = int8_t((code >> 16) & 0xff);
        const uint32_t argb = in[x];
        const int8_t green = int8_t(argb >> 8);
        int new_red = int(argb >> 16) & 0xff;
        int new_blue = int(argb & 0xff);
        new_red += (int(g2r) * green) >> 5;
        new_red &= 0xff;
        new_blue += (int(g2b) * green) >> 5;
        new_blue += (int(r2b) * int8_t(new_red)) >> 5;
        new_blue &= 0xff;
        out[x] = (argb & 0xff00ff00u) | (uint32_t(new_red) << 16) | uint32_t(new_blue);
      }
      break;
    }
    case PREDICTOR_TRANSFORM: {
      uint32_t* const top = above.data() + 1;
      if (y == 0) {  // the first row: black, then left
        out[0] = add_pixels(in[0], 0xff000000u);
        for (int x = 1; x < tw; ++x) out[x] = add_pixels(in[x], out[x - 1]);
      } else {  // the first column: top
        out[0] = add_pixels(in[0], top[0]);
        top[tw] = out[0];
        const int tiles_per_row = subsample_size(tw, t.bits);
        const uint32_t* modes = t.data.data() + size_t(y >> t.bits) * size_t(tiles_per_row);
        for (int x = 1; x < tw; ++x) {
          const int mode = int((modes[x >> t.bits] >> 8) & 0xf);
          out[x] = add_pixels(in[x], predict(mode, out[x - 1], top + x));
        }
      }
      std::memcpy(top, out, size_t(tw) * sizeof(uint32_t));
      break;
    }
    default: {  // colour indexing, with 2, 4 or 8 pixels bundled where the palette is small
      const int bits_per_pixel = 8 >> t.bits;
      const int count_mask = (1 << t.bits) - 1;
      const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
      const uint32_t* color_map = t.data.data();
      if (bits_per_pixel < 8) {
        uint32_t packed = 0;
        const uint32_t* s = in;
        for (int x = 0; x < tw; ++x) {
          if ((x & count_mask) == 0) packed = (*s++ >> 8) & 0xff;
          out[x] = color_map[packed & bit_mask];
          packed >>= bits_per_pixel;
        }
      } else {
        for (int x = 0; x < tw; ++x) out[x] = color_map[(in[x] >> 8) & 0xff];
      }
      break;
    }
  }
}

// The level-0 stream through its inverse transforms (the last read first),
// row by row, to `emit(y, argb_row)`.
template <typename Emit>
void vp8l_rows(const Vp8lDecoder& dec, const std::vector<uint32_t>& pixels, int out_width,
               int out_height, Emit emit) {
  const int nt = dec.next_transform;
  std::vector<std::vector<uint32_t>> above(static_cast<size_t>(nt));
  for (auto& a : above) a.assign(size_t(out_width) + 2, 0);
  std::vector<uint32_t> buf[2] = {std::vector<uint32_t>(size_t(out_width)),
                                  std::vector<uint32_t>(size_t(out_width))};
  for (int y = 0; y < out_height; ++y) {
    const uint32_t* in = pixels.data() + size_t(y) * size_t(dec.width);
    int k = 0;
    for (int n = nt - 1; n >= 0; --n) {
      uint32_t* dst = buf[k].data();
      k ^= 1;
      inverse_row(dec.transforms[n], in, dst, above[size_t(n)], y);
      in = dst;
    }
    emit(y, in);
  }
}

// ---------------------------------------------------------------------------
// ALPH (alpha_dec.c, filters.c)
// ---------------------------------------------------------------------------
void unfilter_row(int filter, const uint8_t* prev, const uint8_t* in, uint8_t* out, int width) {
  if (filter == 0) {
    if (in != out) std::memmove(out, in, size_t(width));
    return;
  }
  if (filter == 1 || prev == nullptr) {  // horizontal, and the first row of any filter
    uint8_t pred = (prev == nullptr) ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      out[i] = uint8_t(pred + in[i]);
      pred = out[i];
    }
    return;
  }
  if (filter == 2) {  // vertical
    for (int i = 0; i < width; ++i) out[i] = uint8_t(prev[i] + in[i]);
    return;
  }
  uint8_t top = prev[0], top_left = top, left = top;  // gradient
  for (int i = 0; i < width; ++i) {
    top = prev[i];
    const int g = left + top - top_left;
    const int pred = ((g & ~0xff) == 0) ? g : (g < 0) ? 0 : 255;
    left = uint8_t(in[i] + pred);
    top_left = top;
    out[i] = left;
  }
}

// The (height, width) alpha plane of an ALPH chunk's payload.
std::vector<uint8_t> decode_alpha(const uint8_t* data, size_t size, int width, int height) {
  if (size <= 1) fail("ALPH: Could not decode alpha data.");
  const int method = data[0] & 0x03;
  const int filter = (data[0] >> 2) & 0x03;
  const int pre_processing = (data[0] >> 4) & 0x03;
  const int rsrv = (data[0] >> 6) & 0x03;
  if (method > 1 || pre_processing > 1 || rsrv != 0)
    fail("ALPH: Could not decode alpha data (header)");
  const size_t n = size_t(width) * size_t(height);
  std::vector<uint8_t> plane(n);
  const uint8_t* body = data + 1;
  const size_t body_size = size - 1;
  if (method == 0) {
    if (body_size < n) fail("ALPH: Could not decode alpha data (raw plane cut short)");
    const uint8_t* prev = nullptr;
    for (int y = 0; y < height; ++y) {
      uint8_t* row = plane.data() + size_t(y) * width;
      unfilter_row(filter, prev, body + size_t(y) * width, row, width);
      prev = row;
    }
    return plane;
  }
  Vp8lDecoder dec;
  dec.br.init(body, body_size);
  if (!dec.decode_image_stream(width, height, true, nullptr))
    fail("ALPH: Could not decode alpha data (VP8L header)");
  const Meta& m = dec.hdr;
  bool is8b = dec.next_transform == 1 && dec.transforms[0].type == COLOR_INDEXING_TRANSFORM &&
              m.color_cache_size == 0;
  if (is8b)
    for (const HTreeGroup& g : m.groups)
      if (g.htrees[RED][0].bits > 0 || g.htrees[BLUE][0].bits > 0 || g.htrees[ALPHA][0].bits > 0)
        is8b = false;
  if (is8b) {
    std::vector<uint8_t> idx(size_t(dec.width) * size_t(dec.height));
    if (!dec.decode_alpha_data(idx.data(), dec.width, dec.height))
      fail("ALPH: Could not decode alpha data (VP8L data)");
    const Transform& t = dec.transforms[0];
    const int bits_per_pixel = 8 >> t.bits;
    const int count_mask = (1 << t.bits) - 1;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    for (int y = 0; y < height; ++y) {
      const uint8_t* s = idx.data() + size_t(y) * size_t(dec.width);
      uint8_t* o = plane.data() + size_t(y) * width;
      uint32_t packed = 0;
      for (int x = 0; x < width; ++x) {
        if (bits_per_pixel < 8) {
          if ((x & count_mask) == 0) packed = *s++;
          o[x] = uint8_t((t.data[packed & bit_mask] >> 8) & 0xff);
          packed >>= bits_per_pixel;
        } else {
          o[x] = uint8_t((t.data[s[x]] >> 8) & 0xff);
        }
      }
    }
  } else {
    std::vector<uint32_t> pixels(size_t(dec.width) * size_t(dec.height));
    if (!dec.decode_image_data(dec.hdr, pixels.data(), dec.width, dec.height))
      fail("ALPH: Could not decode alpha data (VP8L data)");
    vp8l_rows(dec, pixels, width, height, [&](int y, const uint32_t* argb) {
      uint8_t* o = plane.data() + size_t(y) * width;
      for (int x = 0; x < width; ++x) o[x] = uint8_t((argb[x] >> 8) & 0xff);
    });
  }
  const uint8_t* prev = nullptr;
  if (filter != 0)
    for (int y = 0; y < height; ++y) {
      uint8_t* row = plane.data() + size_t(y) * width;
      unfilter_row(filter, prev, row, row, width);
      prev = row;
    }
  return plane;
}

// ---------------------------------------------------------------------------
// a frame into its window of the output
// ---------------------------------------------------------------------------
struct Window {
  uint8_t* out;
  int64_t stride;
  int channels;  // 3: RGB, 4: RGBA
  int width, height;
};

void decode_vp8l(const uint8_t* data, size_t size, const Window& win) {
  Vp8lDecoder dec;
  dec.br.init(data, size);
  if (dec.br.read_bits(8) != 0x2f) fail("VP8L: bad signature");
  const int w = int(dec.br.read_bits(14)) + 1;
  const int h = int(dec.br.read_bits(14)) + 1;
  dec.br.read_bits(1);  // alpha hint: the container's reading of it sets the mode
  if (dec.br.read_bits(3) != 0 || dec.br.eos) fail("VP8L: bad header");
  if (w != win.width || h != win.height) fail("VP8L: the frame size disagrees with its header");
  if (!dec.decode_image_stream(w, h, true, nullptr)) fail("VP8L: bitstream error (header)");
  std::vector<uint32_t> pixels(size_t(dec.width) * size_t(dec.height));
  if (!dec.decode_image_data(dec.hdr, pixels.data(), dec.width, dec.height))
    fail("VP8L: bitstream error (data)");
  vp8l_rows(dec, pixels, w, h, [&](int y, const uint32_t* argb) {
    uint8_t* o = win.out + y * win.stride;
    if (win.channels == 4) {
      for (int x = 0; x < w; ++x, o += 4) {
        const uint32_t p = argb[x];
        o[0] = uint8_t(p >> 16);
        o[1] = uint8_t(p >> 8);
        o[2] = uint8_t(p);
        o[3] = uint8_t(p >> 24);
      }
    } else {
      for (int x = 0; x < w; ++x, o += 3) {
        const uint32_t p = argb[x];
        o[0] = uint8_t(p >> 16);
        o[1] = uint8_t(p >> 8);
        o[2] = uint8_t(p);
      }
    }
  });
}

void decode_vp8(const uint8_t* data, size_t size, const uint8_t* alpha, int64_t alpha_size,
                const Window& win) {
  Vp8Decoder dec;
  dec.decode(data, size);
  if (dec.width != win.width || dec.height != win.height)
    fail("VP8: the frame size disagrees with its header");
  const int w = dec.width, h = dec.height;
  std::vector<uint8_t> plane;
  if (alpha != nullptr) plane = decode_alpha(alpha, size_t(alpha_size), w, h);
  const int ch = win.channels;
  const uint8_t* Y = dec.ybuf.data();
  const uint8_t* U = dec.ubuf.data();
  const uint8_t* V = dec.vbuf.data();
  const size_t ys = size_t(dec.y_stride), us = size_t(dec.uv_stride);
  auto row = [&](int y) { return win.out + y * win.stride; };
  // row 0 mirrors its chroma; then pairs (2k - 1, 2k) between chroma rows
  // k - 1 and k; an even height ends with one row on the last chroma row
  upsample_pair(Y, nullptr, U, V, U, V, row(0), nullptr, w, ch);
  int y = 1;
  for (; y + 1 < h; y += 2) {
    const size_t k = size_t(y + 1) / 2;
    upsample_pair(Y + size_t(y) * ys, Y + size_t(y + 1) * ys, U + (k - 1) * us, V + (k - 1) * us,
                  U + k * us, V + k * us, row(y), row(y + 1), w, ch);
  }
  if (!(h & 1)) {
    const size_t k = size_t(h) / 2 - 1;
    upsample_pair(Y + size_t(h - 1) * ys, nullptr, U + k * us, V + k * us, U + k * us, V + k * us,
                  row(h - 1), nullptr, w, ch);
  }
  if (ch == 4)
    for (int yy = 0; yy < h; ++yy) {
      uint8_t* o = row(yy) + 3;
      const uint8_t* a = plane.empty() ? nullptr : plane.data() + size_t(yy) * w;
      for (int x = 0; x < w; ++x, o += 4) *o = a ? a[x] : 0xff;
    }
}

void set_error(char* err, int64_t cap, const std::string& what) {
  if (err == nullptr || cap <= 0) return;
  const size_t n = std::min(what.size(), size_t(cap - 1));
  std::memcpy(err, what.data(), n);
  err[n] = 0;
}

}  // namespace

extern "C" {

// Decode one frame: `image` the VP8 or VP8L chunk's payload (to the end of
// the frame's data, padding included, as libwebp hands it over), `alpha`
// the ALPH chunk's payload (alpha_size < 0: none), into the (height, width)
// window at `out` with rows `stride` bytes apart and `channels` 3 (RGB) or
// 4 (RGBA) bytes a pixel. 0, or -1 with the reason in err.
int64_t webp_decode(const uint8_t* image, int64_t image_size, int32_t lossless,
                    const uint8_t* alpha, int64_t alpha_size, int64_t width, int64_t height,
                    uint8_t* out, int64_t stride, int32_t channels, char* err, int64_t errcap) {
  try {
    const Window win{out, stride, int(channels), int(width), int(height)};
    if (lossless) {
      decode_vp8l(image, size_t(image_size), win);
    } else {
      decode_vp8(image, size_t(image_size), alpha_size >= 0 ? alpha : nullptr, alpha_size, win);
    }
    return 0;
  } catch (const WebpError& e) {
    set_error(err, errcap, e.what);
  } catch (const std::bad_alloc&) {
    set_error(err, errcap, "out of memory");
  }
  return -1;
}

}  // extern "C"
