// Host-side C++ of the port's JPEG reader (utils/jpeg.py): a baseline
// (SOF0) and extended sequential Huffman (SOF1) decoder of 8-bit files with
// one or three components, built with g++ by mulactseg_tpu_torch/native.py
// (CPU code, not a kernel of the card). It gives the pixels libjpeg(-turbo)
// gives with its default settings, as Pillow's Image.open(p).convert("RGB")
// decodes them:
//   - the integer "islow" IDCT of libjpeg's jidctint.c, with its post-IDCT
//     range limit (a 10-bit wrap, then a clamp);
//   - "fancy" (triangle) upsampling of jdsample.c for h2v1, h1v2 and h2v2
//     chroma (h2v1 and h2v2 only where the component is wider than 2
//     samples, as libjpeg chooses), plain replication for other integral
//     factors; rows past the component's last real row repeat it;
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c;
//   - restart intervals (DRI / RSTn).
// utils/jpeg.py reads the header and refuses every other mode (progressive,
// arithmetic, lossless, 12-bit, CMYK, RGB without colour transform) before
// calling here.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag position -> natural (row-major) position; 16 extra entries so
// that a corrupt run past 63 lands on a harmless slot (jutils.c)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Error {
    kOk = 0,
    kTruncated = 1,
    kBadMarker = 2,
    kBadTable = 3,
    kBadFrame = 4,
    kBadScan = 5,
    kBadHuffmanCode = 6,
    kBadRestart = 7,
    kNoFrame = 8,
};

struct Huffman {
    bool defined = false;
    int maxcode[18];    // largest code of each length, -1 if none
    int valoffset[18];  // index of a length's first value, less its code
    uint8_t vals[256];
    uint8_t look_len[512];  // 9-bit lookahead: code length, 0 if longer
    uint8_t look_sym[512];

    bool build(const uint8_t* counts, const uint8_t* values, int nvals) {
        int code = 0, k = 0;
        std::memset(look_len, 0, sizeof(look_len));
        for (int len = 1; len <= 16; len++) {
            // checked before any code is placed, as jdhuff.c does: the
            // codes of this length must fit in len bits and leave the
            // all-ones code unused; this also keeps the lookahead indices
            // below 512
            if (code + counts[len - 1] >= (1 << len) ||
                k + counts[len - 1] > nvals)
                return false;
            valoffset[len] = k - code;
            for (int i = 0; i < counts[len - 1]; i++, k++, code++) {
                if (len <= 9) {
                    int shift = 9 - len;
                    for (int j = 0; j < (1 << shift); j++) {
                        look_len[(code << shift) | j] = (uint8_t)len;
                        look_sym[(code << shift) | j] = values[k];
                    }
                }
            }
            maxcode[len] = counts[len - 1] ? code - 1 : -1;
            code <<= 1;
        }
        maxcode[17] = 0x7fffffff;
        std::memcpy(vals, values, (size_t)nvals);
        defined = true;
        return true;
    }
};

struct Component {
    int id, h, v, tq;
    int width, height;        // real samples (downsampled_width/height)
    int bw, bh;               // allocated blocks across and down
    std::vector<uint8_t> plane;  // (bh * 8) x (bw * 8) samples
    int dc_table = 0, ac_table = 0, pred = 0;
};

// Entropy-coded segment reader: bits MSB first, 0xFF00 unstuffed; at a
// marker it stops and feeds zeros, as libjpeg does.
struct BitReader {
    const uint8_t* d;
    int64_t n, pos;
    uint64_t buf = 0;
    int cnt = 0;
    bool at_marker = false;
    int64_t past_end = 0;  // zero bytes fed after the end of the data

    void fill() {
        while (cnt <= 56) {
            int b = 0;
            if (!at_marker && pos >= n) past_end++;
            if (!at_marker && pos < n) {
                b = d[pos];
                if (b == 0xFF) {
                    int b2 = pos + 1 < n ? d[pos + 1] : 0xD9;
                    if (b2 == 0) {
                        pos += 2;
                    } else {
                        at_marker = true;
                        b = 0;
                    }
                } else {
                    pos++;
                }
            }
            buf |= (uint64_t)b << (56 - cnt);
            cnt += 8;
        }
    }
    int bits(int k) {  // k in 1..16
        if (cnt < k) fill();
        int v = (int)(buf >> (64 - k));
        buf <<= k;
        cnt -= k;
        return v;
    }
    int decode(const Huffman& t) {
        if (cnt < 16) fill();
        int look = (int)(buf >> (64 - 9));
        int len = t.look_len[look];
        if (len) {
            buf <<= len;
            cnt -= len;
            return t.look_sym[look];
        }
        for (len = 10; len <= 16; len++) {
            int code = (int)(buf >> (64 - len));
            if (code <= t.maxcode[len]) {
                buf <<= len;
                cnt -= len;
                return t.vals[t.valoffset[len] + code];
            }
        }
        return -1;
    }
    int extend(int s) {  // the signed value of s magnitude bits
        if (s == 0) return 0;
        int v = bits(s);
        return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
    }
    // whether a bit fed after the end of the data was consumed (the
    // file is truncated); the buffer's last cnt bits are unconsumed
    bool truncated() const { return past_end * 8 > cnt; }
    void reset() {  // drop the padding bits before a marker
        buf = 0;
        cnt = 0;
    }
};

inline int descale(int64_t x, int n) {
    return (int)((x + ((int64_t)1 << (n - 1))) >> n);
}

// libjpeg's post-IDCT range limit for a centred sample: the value is taken
// modulo 1024 into [-512, 512), then shifted by 128 and clamped
inline uint8_t idct_limit(int x) {
    int s = ((x & 1023) ^ 512) - 512;
    s += 128;
    return (uint8_t)(s < 0 ? 0 : (s > 255 ? 255 : s));
}

// jidctint.c jpeg_idct_islow: coef in natural order, quant in natural order
void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
                int stride) {
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                  F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
    int ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t* in = coef + c;
        const uint16_t* q = quant + c;
        if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
            in[40] == 0 && in[48] == 0 && in[56] == 0) {
            int dc = (in[0] * (int)q[0]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
            continue;
        }
        int64_t z2 = in[16] * (int64_t)q[16], z3 = in[48] * (int64_t)q[48];
        int64_t z1 = (z2 + z3) * F0_541;
        int64_t tmp2 = z1 + z3 * -F1_847;
        int64_t tmp3 = z1 + z2 * F0_765;
        z2 = in[0] * (int64_t)q[0];
        z3 = in[32] * (int64_t)q[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = in[56] * (int64_t)q[56];
        tmp1 = in[40] * (int64_t)q[40];
        tmp2 = in[24] * (int64_t)q[24];
        tmp3 = in[8] * (int64_t)q[8];
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
        const int sh = CONST_BITS - PASS1_BITS;
        ws[0 * 8 + c] = descale(tmp10 + tmp3, sh);
        ws[7 * 8 + c] = descale(tmp10 - tmp3, sh);
        ws[1 * 8 + c] = descale(tmp11 + tmp2, sh);
        ws[6 * 8 + c] = descale(tmp11 - tmp2, sh);
        ws[2 * 8 + c] = descale(tmp12 + tmp1, sh);
        ws[5 * 8 + c] = descale(tmp12 - tmp1, sh);
        ws[3 * 8 + c] = descale(tmp13 + tmp0, sh);
        ws[4 * 8 + c] = descale(tmp13 - tmp0, sh);
    }
    for (int r = 0; r < 8; r++) {
        const int* w = ws + r * 8;
        uint8_t* o = out + (int64_t)r * stride;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
            w[6] == 0 && w[7] == 0) {
            uint8_t v = idct_limit(descale(w[0], PASS1_BITS + 3));
            for (int c = 0; c < 8; c++) o[c] = v;
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * F0_541;
        int64_t tmp2 = z1 + z3 * -F1_847;
        int64_t tmp3 = z1 + z2 * F0_765;
        int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
        int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
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
        const int sh = CONST_BITS + PASS1_BITS + 3;
        o[0] = idct_limit(descale(tmp10 + tmp3, sh));
        o[7] = idct_limit(descale(tmp10 - tmp3, sh));
        o[1] = idct_limit(descale(tmp11 + tmp2, sh));
        o[6] = idct_limit(descale(tmp11 - tmp2, sh));
        o[2] = idct_limit(descale(tmp12 + tmp1, sh));
        o[5] = idct_limit(descale(tmp12 - tmp1, sh));
        o[3] = idct_limit(descale(tmp13 + tmp0, sh));
        o[4] = idct_limit(descale(tmp13 - tmp0, sh));
    }
}

// One component's real samples upsampled by (fh, fv) to (H, W), as
// jdsample.c does it (see the file comment).
void upsample(const Component& c, int fh, int fv, int H, int W,
              uint8_t* out) {
    const int cw = c.width, ch = c.height, stride = c.bw * 8;
    auto row = [&](int y) {  // rows past the real ones repeat the last
        y = y < 0 ? 0 : (y >= ch ? ch - 1 : y);
        return c.plane.data() + (int64_t)y * stride;
    };
    std::vector<int> sums((size_t)cw);
    std::vector<uint8_t> wide((size_t)cw * 2);
    bool fancy_h = fh == 2 && cw > 2;
    for (int y = 0; y < H; y++) {
        uint8_t* o = out + (int64_t)y * W;
        if (fv == 2 && (fh == 1 || fancy_h)) {
            // vertical triangle: 3 * nearer row + farther row
            int iy = y >> 1;
            const uint8_t* r0 = row(iy);
            const uint8_t* r1 = row((y & 1) ? iy + 1 : iy - 1);
            for (int x = 0; x < cw; x++) sums[x] = r0[x] * 3 + r1[x];
            if (fh == 1) {  // h1v2: bias 1 above, 2 below
                int bias = (y & 1) ? 2 : 1;
                for (int x = 0; x < W; x++)
                    o[x] = (uint8_t)((sums[x] + bias) >> 2);
                continue;
            }
            // h2v2
            uint8_t* p = wide.data();
            int last, cur = sums[0], next;
            p[0] = (uint8_t)((cur * 4 + 8) >> 4);
            p[1] = (uint8_t)((cur * 3 + sums[1] + 7) >> 4);
            last = cur;
            cur = sums[1];
            for (int x = 1; x < cw - 1; x++) {
                next = sums[x + 1];
                p[2 * x] = (uint8_t)((cur * 3 + last + 8) >> 4);
                p[2 * x + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
                last = cur;
                cur = next;
            }
            p[2 * (cw - 1)] = (uint8_t)((cur * 3 + last + 8) >> 4);
            p[2 * (cw - 1) + 1] = (uint8_t)((cur * 4 + 7) >> 4);
            std::memcpy(o, p, (size_t)W);
            continue;
        }
        const uint8_t* r = row(y / fv);
        if (fh == 2 && fv == 1 && fancy_h) {  // h2v1
            uint8_t* p = wide.data();
            p[0] = r[0];
            p[1] = (uint8_t)((r[0] * 3 + r[1] + 2) >> 2);
            for (int x = 1; x < cw - 1; x++) {
                int v = r[x] * 3;
                p[2 * x] = (uint8_t)((v + r[x - 1] + 1) >> 2);
                p[2 * x + 1] = (uint8_t)((v + r[x + 1] + 2) >> 2);
            }
            p[2 * (cw - 1)] = (uint8_t)((r[cw - 1] * 3 + r[cw - 2] + 1) >> 2);
            p[2 * (cw - 1) + 1] = r[cw - 1];
            std::memcpy(o, p, (size_t)W);
            continue;
        }
        for (int x = 0; x < W; x++) o[x] = r[x / fh];  // replication
    }
}

struct Decoder {
    const uint8_t* d;
    int64_t n, pos = 0;
    uint16_t quant[4][64];
    bool quant_defined[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    std::vector<Component> comps;
    int H = 0, W = 0, hmax = 1, vmax = 1, restart = 0;

    int u16(int64_t at) { return (d[at] << 8) | d[at + 1]; }

    int dqt(int64_t p, int64_t end) {
        while (p < end) {
            int pq = d[p] >> 4, tq = d[p] & 15;
            p++;
            if (tq > 3 || p + 64 * (pq + 1) > end) return kBadTable;
            for (int k = 0; k < 64; k++) {
                quant[tq][kNatural[k]] =
                    (uint16_t)(pq ? u16(p + 2 * k) : d[p + k]);
            }
            p += 64 * (pq + 1);
            quant_defined[tq] = true;
        }
        return kOk;
    }

    int dht(int64_t p, int64_t end) {
        while (p < end) {
            if (p + 17 > end) return kBadTable;
            int tc = d[p] >> 4, th = d[p] & 15;
            const uint8_t* counts = d + p + 1;
            int total = 0;
            for (int i = 0; i < 16; i++) total += counts[i];
            if (tc > 1 || th > 3 || total > 256 || p + 17 + total > end)
                return kBadTable;
            Huffman& t = tc ? ac[th] : dc[th];
            if (!t.build(counts, d + p + 17, total)) return kBadTable;
            p += 17 + total;
        }
        return kOk;
    }

    int sof(int64_t p, int64_t end) {
        if (end - p < 6) return kBadFrame;
        H = u16(p + 1);
        W = u16(p + 3);
        int nc = d[p + 5];
        if (d[p] != 8 || H == 0 || W == 0 || (nc != 1 && nc != 3) ||
            end - p < 6 + 3 * nc)
            return kBadFrame;
        comps.resize((size_t)nc);
        for (int i = 0; i < nc; i++) {
            Component& c = comps[(size_t)i];
            c.id = d[p + 6 + 3 * i];
            c.h = d[p + 7 + 3 * i] >> 4;
            c.v = d[p + 7 + 3 * i] & 15;
            c.tq = d[p + 8 + 3 * i];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
                return kBadFrame;
            hmax = c.h > hmax ? c.h : hmax;
            vmax = c.v > vmax ? c.v : vmax;
        }
        int mcux = (W + 8 * hmax - 1) / (8 * hmax);
        int mcuy = (H + 8 * vmax - 1) / (8 * vmax);
        for (Component& c : comps) {
            if (hmax % c.h || vmax % c.v) return kBadFrame;  // fractional
            c.width = (int)(((int64_t)W * c.h + hmax - 1) / hmax);
            c.height = (int)(((int64_t)H * c.v + vmax - 1) / vmax);
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
        }
        return kOk;
    }

    int block(BitReader& br, Component& c, int by, int bx) {
        int16_t coef[64];
        std::memset(coef, 0, sizeof(coef));
        int s = br.decode(dc[c.dc_table]);
        if (s < 0 || s > 15) return kBadHuffmanCode;
        c.pred += br.extend(s);
        coef[0] = (int16_t)c.pred;
        for (int k = 1; k < 64;) {
            int rs = br.decode(ac[c.ac_table]);
            if (rs < 0) return kBadHuffmanCode;
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                coef[kNatural[k]] = (int16_t)br.extend(s);
                k++;
            } else {
                if (r != 15) break;  // end of block
                k += 16;
            }
        }
        int stride = c.bw * 8;
        idct_islow(coef, quant[c.tq],
                   c.plane.data() + (int64_t)by * 8 * stride + bx * 8,
                   stride);
        return kOk;
    }

    // expects the next marker at pos; returns it (0 if none left)
    int next_marker() {
        while (pos < n && d[pos] != 0xFF) pos++;  // junk before a marker
        while (pos < n && d[pos] == 0xFF) pos++;
        if (pos >= n) return 0;
        return d[pos++];
    }

    int scan(int64_t p, int64_t end) {
        int ns = d[p];
        if (ns < 1 || ns > 4 || end - p < 4 + 2 * ns) return kBadScan;
        std::vector<Component*> sc;
        for (int i = 0; i < ns; i++) {
            int id = d[p + 1 + 2 * i], tables = d[p + 2 + 2 * i];
            Component* c = nullptr;
            for (Component& x : comps)
                if (x.id == id) c = &x;
            if (!c) return kBadScan;
            c->dc_table = tables >> 4;
            c->ac_table = tables & 15;
            if (c->dc_table > 3 || c->ac_table > 3 ||
                !dc[c->dc_table].defined || !ac[c->ac_table].defined ||
                !quant_defined[c->tq])
                return kBadScan;
            sc.push_back(c);
        }
        int64_t q = p + 1 + 2 * ns;  // Ss, Se, Ah/Al: sequential values
        if (d[q] != 0 || d[q + 1] != 63 || d[q + 2] != 0) return kBadScan;
        pos = end;
        BitReader br{d, n, pos};
        for (Component* c : sc) c->pred = 0;
        int mx, my;
        if (ns == 1) {
            mx = (sc[0]->width + 7) / 8;
            my = (sc[0]->height + 7) / 8;
        } else {
            mx = (W + 8 * hmax - 1) / (8 * hmax);
            my = (H + 8 * vmax - 1) / (8 * vmax);
        }
        int64_t total = (int64_t)mx * my, left = restart;
        int expect_rst = 0;
        for (int64_t m = 0; m < total; m++) {
            if (restart && left == 0) {
                if (br.truncated()) return kTruncated;
                br.reset();
                br.at_marker = false;
                pos = br.pos;
                int mk = next_marker();
                if (mk != 0xD0 + expect_rst) return kBadRestart;
                expect_rst = (expect_rst + 1) & 7;
                br.pos = pos;
                for (Component* c : sc) c->pred = 0;
                left = restart;
            }
            int y = (int)(m / mx), x = (int)(m % mx);
            if (ns == 1) {
                int rc = block(br, *sc[0], y, x);
                if (rc) return rc;
            } else {
                for (Component* c : sc)
                    for (int v = 0; v < c->v; v++)
                        for (int h = 0; h < c->h; h++) {
                            int rc = block(br, *c, y * c->v + v,
                                           x * c->h + h);
                            if (rc) return rc;
                        }
            }
            left--;
        }
        pos = br.pos;
        return br.truncated() ? kTruncated : kOk;
    }

    int run() {
        if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kBadMarker;
        pos = 2;
        bool frame = false;
        for (;;) {
            int mk = next_marker();
            if (mk == 0 || mk == 0xD9) break;  // EOI (or the end of data)
            if (mk >= 0xD0 && mk <= 0xD7) continue;  // stray RSTn
            if (pos + 2 > n) return kTruncated;
            int len = u16(pos);
            int64_t p = pos + 2, end = pos + len;
            if (len < 2 || end > n) return kTruncated;
            int rc = kOk;
            if (mk == 0xDB) {
                rc = dqt(p, end);
            } else if (mk == 0xC4) {
                rc = dht(p, end);
            } else if (mk == 0xC0 || mk == 0xC1) {
                rc = sof(p, end);
                frame = true;
            } else if (mk == 0xDD) {
                if (len < 4) return kBadMarker;
                restart = u16(p);
            } else if (mk == 0xDA) {
                if (!frame) return kNoFrame;
                rc = scan(p, end);
                if (rc) return rc;
                continue;  // pos is past the entropy-coded data
            } else if ((mk & 0xF0) == 0xC0 && mk != 0xC8 && mk != 0xCC) {
                return kBadFrame;  // another SOFn: refused in utils/jpeg.py
            }
            if (rc) return rc;
            pos = end;
        }
        return frame ? kOk : kNoFrame;
    }
};

}  // namespace

extern "C" {

// data: the whole file; out: (H, W, 3) uint8 for the frame's H and W
// (utils/jpeg.py reads them from the header first). Returns 0, or one of
// the Error codes above.
int jpeg_decode(const uint8_t* data, int64_t n, int H, int W, uint8_t* out) {
    Decoder dec;
    dec.d = data;
    dec.n = n;
    int rc = dec.run();
    if (rc) return rc;
    if (dec.H != H || dec.W != W) return kBadFrame;
    std::vector<std::vector<uint8_t>> full(dec.comps.size());
    for (size_t i = 0; i < dec.comps.size(); i++) {
        const Component& c = dec.comps[i];
        full[i].resize((size_t)H * W);
        upsample(c, dec.hmax / c.h, dec.vmax / c.v, H, W, full[i].data());
    }
    const int64_t P = (int64_t)H * W;
    if (dec.comps.size() == 1) {
        const uint8_t* y = full[0].data();
        for (int64_t i = 0; i < P; i++)
            out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
        return kOk;
    }
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t ONE_HALF = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
        int64_t x = i - 128;
        cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> 16);
        cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> 16);
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(),
                  *Cr = full[2].data();
    for (int64_t i = 0; i < P; i++) {
        int y = Y[i], cb = Cb[i], cr = Cr[i];
        out[3 * i] = clamp(y + cr_r[cr]);
        out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
        out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
    return kOk;
}

}  // extern "C"
