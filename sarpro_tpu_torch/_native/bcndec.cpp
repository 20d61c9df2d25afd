// Block-compressed textures as Pillow 12.1's `bcn` decoder reads them
// (BC1-BC7, the formats n = 1..7 of PIL/DdsImagePlugin.py and
// PIL/FtexImagePlugin.py), for sarpro_tpu_torch/io/bcn.py, whose numpy
// version (`decode_blocks`) the tests hold this file to block by block.
//
// bcn_decode: the (height, width, bands) u8 image of `width` x `height`
// pixels from the blocks at src, each block row (width + 3) / 4 blocks,
// the pixels past the image's right and bottom edges cropped; the block
// rows are split over `threads` threads. Returns the number of complete
// block rows the data holds (the image is only written where it is
// complete) or -1 for a format outside 1..7.
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Px {
    int r, g, b, a;
};

const uint16_t P2[64] = {
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
    0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
    0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
    0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
    0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A,
    0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
    0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
    0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22};
const uint32_t P3[64] = {
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000,
    0xA0A05050, 0x5555A0A0, 0x5A5A5050, 0xAA550000, 0xAA555500,
    0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4, 0xA9A59450,
    0x2A0A4250, 0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0,
    0xA8A85454, 0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4,
    0xAAA59090, 0x14696914, 0x69691400, 0xA08585A0, 0xAA821414,
    0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050,
    0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50,
    0x500AA550, 0xAAAA4444, 0x66660000, 0xA5A0A5A0, 0x50A050A0,
    0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444, 0x54A854A8,
    0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414,
    0x96960000, 0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000,
    0x40804080, 0xA9A8A9A8, 0xAAAAAA44, 0x2A4A5254};
const uint8_t A2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t A31[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t A32[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const int W2[4] = {0, 21, 43, 64};
const int W3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int W4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const int *weights(int bits) { return bits == 2 ? W2 : bits == 3 ? W3 : W4; }

// subsets, partition, rotation, index-selection, colour, alpha bits,
// end-point P-bits, shared P-bits, index bits, secondary index bits
const int BC7_MODES[8][10] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// subsets, transformed, partition bits, end-point bits, r / g / b deltas
const int BC6_MODES[14][7] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5},  {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},   {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// each mode's stored end-point bits: field (3 * point + channel, points
// w x y z) and bit, as io/bcn.py's BC6_LAYOUTS spells them
const char *BC6_LAYOUTS[14] = {
    "gy4 by4 bz4 rw0-9 gw0-9 bw0-9 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 bx0-4 "
    "bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    "gy5 gz4 gz5 rw0-6 bz0 bz1 by4 gw0-6 by5 bz2 gy4 bw0-6 bz3 bz5 bz4 "
    "rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5",
    "rw0-9 gw0-9 bw0-9 rx0-4 rw10 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-3 bw10 "
    "bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw10 gz4 gy0-3 gx0-4 gw10 gz0-3 bx0-3 bw10 "
    "bz1 by0-3 ry0-3 bz0 bz2 rz0-3 gy4 bz3",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw10 by4 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-4 "
    "bw10 by0-3 ry0-3 bz1 bz2 rz0-3 bz4 bz3",
    "rw0-8 by4 gw0-8 gy4 bw0-8 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 bx0-4 "
    "bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    "rw0-7 gz4 by4 gw0-7 bz2 gy4 bw0-7 bz3 bz4 rx0-5 gy0-3 gx0-4 bz0 "
    "gz0-3 bx0-4 bz1 by0-3 ry0-5 rz0-5",
    "rw0-7 bz0 by4 gw0-7 gy5 gy4 bw0-7 gz5 bz4 rx0-4 gz4 gy0-3 gx0-5 "
    "gz0-3 bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    "rw0-7 bz1 by4 gw0-7 by5 gy4 bw0-7 bz5 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0 "
    "gz0-3 bx0-5 by0-3 ry0-4 bz2 rz0-4 bz3",
    "rw0-5 gz4 bz0 bz1 by4 gw0-5 gy5 by5 bz2 gy4 bw0-5 gz5 bz3 bz5 bz4 "
    "rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5",
    "rw0-9 gw0-9 bw0-9 rx0-9 gx0-9 bx0-9",
    "rw0-9 gw0-9 bw0-9 rx0-8 rw10 gx0-8 gw10 bx0-8 bw10",
    "rw0-9 gw0-9 bw0-9 rx0-7 rw11-10 gx0-7 gw11-10 bx0-7 bw11-10",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw15-10 gx0-3 gw15-10 bx0-3 bw15-10",
};

// parsed BC6_LAYOUTS: field * 16 + bit of each stored bit
struct Bc6Bits {
    uint8_t bits[14][75];
    int count[14];
    Bc6Bits() {
        for (int m = 0; m < 14; m++) {
            int n = 0;
            const char *p = BC6_LAYOUTS[m];
            while (*p) {
                while (*p == ' ') p++;
                if (!*p) break;
                int ch = p[0] == 'r' ? 0 : p[0] == 'g' ? 1 : 2;
                int pt = p[1] == 'w' ? 0 : p[1] == 'x' ? 1 : p[1] == 'y' ? 2 : 3;
                p += 2;
                int a = 0, b;
                while (*p >= '0' && *p <= '9') a = 10 * a + (*p++ - '0');
                b = a;
                if (*p == '-') {
                    p++;
                    b = 0;
                    while (*p >= '0' && *p <= '9') b = 10 * b + (*p++ - '0');
                }
                int step = b >= a ? 1 : -1;
                for (int k = a;; k += step) {
                    bits[m][n++] = (uint8_t)((3 * pt + ch) * 16 + k);
                    if (k == b) break;
                }
            }
            count[m] = n;
        }
    }
};
const Bc6Bits &bc6_bits() {
    static const Bc6Bits t;
    return t;
}

inline int get_bits(const uint8_t *src, int bit, int count) {
    int v = 0;
    for (int k = 0; k < count; k++)
        v |= ((src[(bit + k) >> 3] >> ((bit + k) & 7)) & 1) << k;
    return v;
}

Px c565(int x) {
    int r = (x & 0xF800) >> 8, g = (x & 0x7E0) >> 3, b = (x & 0x1F) << 3;
    return {r | (r >> 5), g | (g >> 6), b | (b >> 5), 255};
}

void bc1(Px *out, const uint8_t *s, bool four) {
    int c0 = s[0] | (s[1] << 8), c1 = s[2] | (s[3] << 8);
    uint32_t lut = s[4] | (s[5] << 8) | (s[6] << 16) | ((uint32_t)s[7] << 24);
    Px p[4];
    p[0] = c565(c0);
    p[1] = c565(c1);
    if (c0 > c1 || four) {
        p[2] = {(2 * p[0].r + p[1].r) / 3, (2 * p[0].g + p[1].g) / 3,
                (2 * p[0].b + p[1].b) / 3, 255};
        p[3] = {(p[0].r + 2 * p[1].r) / 3, (p[0].g + 2 * p[1].g) / 3,
                (p[0].b + 2 * p[1].b) / 3, 255};
    } else {
        p[2] = {(p[0].r + p[1].r) / 2, (p[0].g + p[1].g) / 2,
                (p[0].b + p[1].b) / 2, 255};
        p[3] = {0, 0, 0, 0};
    }
    for (int i = 0; i < 16; i++) out[i] = p[(lut >> (2 * i)) & 3];
}

// BC4's ramp into channel `ch` of out (0 r, 1 g, 3 a)
void ramp(Px *out, const uint8_t *s, int ch, bool sign) {
    int a0 = sign ? (int8_t)s[0] + 128 : s[0];
    int a1 = sign ? (int8_t)s[1] + 128 : s[1];
    int a[8];
    a[0] = a0;
    a[1] = a1;
    if (a0 > a1) {
        for (int k = 1; k < 7; k++) a[1 + k] = ((7 - k) * a0 + k * a1) / 7;
    } else {
        for (int k = 1; k < 5; k++) a[1 + k] = ((5 - k) * a0 + k * a1) / 5;
        a[6] = 0;
        a[7] = 255;
    }
    uint64_t bits = 0;
    for (int k = 0; k < 6; k++) bits |= (uint64_t)s[2 + k] << (8 * k);
    for (int i = 0; i < 16; i++) {
        int v = a[(bits >> (3 * i)) & 7] & 255;
        if (ch == 0) out[i].r = v;
        else if (ch == 1) out[i].g = v;
        else out[i].a = v;
    }
}

int expand(int v, int bits) {
    v = (v << (8 - bits)) & 255;
    return v | (v >> bits);
}

void bc7(Px *out, const uint8_t *s) {
    if (!s[0]) {
        for (int i = 0; i < 16; i++) out[i] = {0, 0, 0, 255};
        return;
    }
    int mode = 0;
    while (!(s[0] & (1 << mode))) mode++;
    const int *m = BC7_MODES[mode];
    int ns = m[0], cb = m[4], ab = m[5], ib = m[8], ib2 = m[9];
    int bit = mode + 1;
    auto take = [&](int n) {
        int v = get_bits(s, bit, n);
        bit += n;
        return v;
    };
    int partition = take(m[1]), rotation = take(m[2]), index_sel = take(m[3]);
    int nep = 2 * ns;
    int e[6][4];
    for (int ch = 0; ch < 3; ch++)
        for (int i = 0; i < nep; i++) e[i][ch] = take(cb);
    for (int i = 0; i < nep; i++) e[i][3] = ab ? take(ab) : 255;
    int chans = ab ? 4 : 3;
    if (m[6]) {
        cb++;
        if (ab) ab++;
        for (int i = 0; i < nep; i++) {
            int p = take(1);
            for (int c = 0; c < chans; c++) e[i][c] = (e[i][c] << 1) | p;
        }
    }
    if (m[7]) {
        cb++;
        if (ab) ab++;
        for (int i = 0; i < nep; i += 2) {
            int p = take(1);
            for (int j = 0; j < 2; j++)
                for (int c = 0; c < chans; c++)
                    e[i + j][c] = (e[i + j][c] << 1) | p;
        }
    }
    for (int i = 0; i < nep; i++) {
        for (int c = 0; c < 3; c++) e[i][c] = expand(e[i][c], cb);
        if (ab) e[i][3] = expand(e[i][3], ab);
    }
    const int *cw = weights(ib);
    const int *aw = weights(ab && ib2 ? ib2 : ib);
    int cbit = bit, abit = bit + 16 * ib - ns;
    for (int i = 0; i < 16; i++) {
        int sub = ns == 2 ? (P2[partition] >> i) & 1
                  : ns == 3 ? (P3[partition] >> (2 * i)) & 3 : 0;
        int n = ib;
        if (i == 0 || (ns == 2 && i == A2[partition]) ||
            (ns == 3 && ((sub == 1 && i == A31[partition]) ||
                         (sub == 2 && i == A32[partition]))))
            n--;
        int i0 = get_bits(s, cbit, n);
        cbit += n;
        int sc, sa;
        if (ab && ib2) {
            int n2 = i == 0 ? ib2 - 1 : ib2;
            int i1 = get_bits(s, abit, n2);
            abit += n2;
            sc = index_sel ? aw[i1] : cw[i0];
            sa = index_sel ? cw[i0] : aw[i1];
        } else {
            sc = sa = cw[i0];
        }
        const int *e0 = e[2 * sub], *e1 = e[2 * sub + 1];
        int px[4];
        for (int c = 0; c < 3; c++)
            px[c] = (((64 - sc) * e0[c] + sc * e1[c] + 32) >> 6) & 255;
        px[3] = (((64 - sa) * e0[3] + sa * e1[3] + 32) >> 6) & 255;
        if (rotation) {
            int t = px[rotation - 1];
            px[rotation - 1] = px[3];
            px[3] = t;
        }
        out[i] = {px[0], px[1], px[2], px[3]};
    }
}

float half_to_float(uint16_t h) {
    union {
        uint32_t u;
        float f;
    } o, m;
    m.u = 0x77800000;  // 2^112
    o.u = (uint32_t)(h & 0x7FFF) << 13;
    o.f *= m.f;
    m.u = 0x47800000;  // 65536
    if (o.f >= m.f) o.u |= 255u << 23;
    o.u |= (uint32_t)(h & 0x8000) << 16;
    return o.f;
}

int bc6_out(int v, bool sign) {
    int h;
    if (sign)
        h = v < 0 ? 0x8000 | ((-v) * 31) / 32 : (v * 31) / 32;
    else
        h = (v * 31) / 64;
    float f = half_to_float((uint16_t)h);
    if (f < 0.0f) return 0;
    if (f > 1.0f) return 255;
    return (int)(uint8_t)(f * 255.0f);
}

int sext(int v, int bits) {
    v &= 0xFFFF;
    if (v & (1 << (bits - 1))) v |= (0xFFFF << bits) & 0xFFFF;
    return v;
}

int unquantize(int v, int bits, bool sign) {
    if (!sign) {
        if (bits >= 15 || v == 0) return v;
        if (v == (1 << bits) - 1) return 0xFFFF;
        return ((v << 15) + 0x4000) >> (bits - 1);
    }
    int x = (int16_t)v;
    if (bits >= 16) return x;
    bool neg = x < 0;
    if (neg) x = -x;
    if (x) x = x >= (1 << (bits - 1)) - 1 ? 0x7FFF
                                          : ((x << 15) + 0x4000) >> (bits - 1);
    return neg ? -x : x;
}

void bc6(Px *out, const uint8_t *s, bool sign) {
    int code = s[0] & 0x1F, bit = 5, epbits = 72, ib = 3, mode;
    if ((code & 3) < 2) {
        mode = code & 3;
        bit = 2;
        epbits = 75;
    } else if ((code & 3) == 2) {
        mode = 2 + (code >> 2);
    } else {
        mode = 10 + (code >> 2);
        epbits = 60;
        ib = 4;
    }
    if (mode >= 14) {
        for (int i = 0; i < 16; i++) out[i] = {0, 0, 0, 0};
        return;
    }
    const int *m = BC6_MODES[mode];
    int ns = m[0], tr = m[1], pb = m[2], epb = m[3];
    int e[12] = {0};
    const Bc6Bits &t = bc6_bits();
    for (int k = 0; k < epbits; k++) {
        int d = t.bits[mode][k];
        e[d >> 4] |= get_bits(s, bit + k, 1) << (d & 15);
    }
    bit += epbits;
    int partition = get_bits(s, bit, pb);
    bit += pb;
    int mask = (1 << epb) - 1, nep = ns == 2 ? 12 : 6;
    if (sign)
        for (int i = 0; i < 3; i++) e[i] = sext(e[i], epb);
    if (sign || tr)
        for (int i = 3; i < nep; i++) e[i] = sext(e[i], m[4 + i % 3]);
    if (tr)
        for (int i = 3; i < nep; i++) e[i] = (e[i] + e[i % 3]) & mask;
    int u[12];
    for (int i = 0; i < nep; i++) u[i] = unquantize(e[i], epb, sign);
    const int *w = weights(ib);
    for (int i = 0; i < 16; i++) {
        int sub = ns == 2 ? (P2[partition] >> i) & 1 : 0;
        int n = (i == 0 || (ns == 2 && i == A2[partition])) ? ib - 1 : ib;
        int wt = w[get_bits(s, bit, n)];
        bit += n;
        int px[3];
        for (int c = 0; c < 3; c++)
            px[c] = bc6_out((u[6 * sub + c] * (64 - wt) +
                             u[6 * sub + 3 + c] * wt) >> 6, sign);
        out[i] = {px[0], px[1], px[2], 0};
    }
}

void decode_block(Px *px, const uint8_t *s, int n, bool sign) {
    switch (n) {
    case 1: bc1(px, s, false); break;
    case 2:
        bc1(px, s + 8, true);
        for (int i = 0; i < 16; i++) {
            int v = (s[i >> 1] >> (4 * (i & 1))) & 15;
            px[i].a = v * 17;
        }
        break;
    case 3:
        bc1(px, s + 8, true);
        ramp(px, s, 3, false);
        break;
    case 4: ramp(px, s, 0, false); break;
    case 5:
        for (int i = 0; i < 16; i++) px[i] = {0, 0, sign ? 128 : 0, 0};
        ramp(px, s, 0, sign);
        ramp(px, s + 8, 1, sign);
        break;
    case 6: bc6(px, s, sign); break;
    default: bc7(px, s); break;
    }
}

}  // namespace

extern "C" int64_t bcn_decode(const uint8_t *src, int64_t len, int64_t width,
                              int64_t height, int32_t n, int32_t sign,
                              uint8_t *out, int32_t threads) {
    if (n < 1 || n > 7) return -1;
    const int size = (n == 1 || n == 4) ? 8 : 16;
    const int bands = n == 4 ? 1 : n == 5 || n == 6 ? 3 : 4;
    const int64_t bw = (width + 3) / 4, bh = (height + 3) / 4;
    int64_t rows = bh;
    if (bw && len / (size * bw) < bh) rows = len / (size * bw);
    if (threads < 1) threads = 1;
    if (rows < 64 * threads) threads = rows > 64 ? (int)(rows / 64) : 1;
    auto work = [&](int64_t r0, int64_t r1) {
        Px px[16];
        for (int64_t by = r0; by < r1; by++) {
            const uint8_t *s = src + by * bw * size;
            for (int64_t bx = 0; bx < bw; bx++, s += size) {
                decode_block(px, s, n, sign != 0);
                for (int i = 0; i < 16; i++) {
                    int64_t y = 4 * by + i / 4, x = 4 * bx + i % 4;
                    if (y >= height || x >= width) continue;
                    uint8_t *d = out + (y * width + x) * bands;
                    d[0] = (uint8_t)px[i].r;
                    if (bands > 1) {
                        d[1] = (uint8_t)px[i].g;
                        d[2] = (uint8_t)px[i].b;
                    }
                    if (bands == 4) d[3] = (uint8_t)px[i].a;
                }
            }
        }
    };
    std::vector<std::thread> pool;
    int64_t step = (rows + threads - 1) / threads;
    for (int t = 1; t < threads; t++) {
        int64_t a = t * step, b = a + step < rows ? a + step : rows;
        if (a < b) pool.emplace_back(work, a, b);
    }
    work(0, step < rows ? step : rows);
    for (auto &th : pool) th.join();
    return rows;
}
