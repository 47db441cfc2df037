// Host-side C++ of the port's data loader: a copy of
// mulactseg_tpu/native/resample.cpp, built with g++ by
// mulactseg_tpu_torch/native.py (CPU code, not a kernel of the card).
//
// resize_bilinear_u8 replicates Pillow's Resample.c uint8 bilinear path
// EXACTLY (fixed-point coefficients at PRECISION_BITS=22, per-pass uint8
// rounding, horizontal-then-vertical with the vertical-bounds row window,
// box= source-window sampling) so the output is byte-identical to
// PIL.Image.resize(..., BILINEAR, box=...) — pinned by
// tests/test_torch_port_transforms.py against Pillow and against the JAX
// package's build of the same source.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;  // Pillow Resample.c

inline double bilinear_filter(double x) {
    if (x < 0.0) x = -x;
    if (x < 1.0) return 1.0 - x;
    return 0.0;
}

// Pillow precompute_coeffs: double coefficients + per-output-pixel source
// bounds. in0/in1 are the box edges along this axis.
// in0/in1 are float, and the span is subtracted IN FLOAT before the
// double division — Pillow's precompute_coeffs takes the box as float
// and computes `(double)(in1 - in0) / outSize`; doing the subtraction in
// double instead shifts ~1e-4 of box-resample pixels by 1 LSB.
int precompute_coeffs(int inSize, float in0, float in1, int outSize,
                      std::vector<int>& bounds, std::vector<double>& kk) {
    double scale = (double)(in1 - in0) / outSize;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 1.0 * filterscale;  // bilinear support = 1.0
    int ksize = (int)ceil(support) * 2 + 1;
    kk.assign((size_t)outSize * ksize, 0.0);
    bounds.assign((size_t)outSize * 2, 0);
    for (int xx = 0; xx < outSize; xx++) {
        double center = in0 + (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        // Round the value (Pillow comment; truncation after +0.5)
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > inSize) xmax = inSize;
        xmax -= xmin;
        double* k = &kk[(size_t)xx * ksize];
        int x = 0;
        for (; x < xmax; x++) {
            double w = bilinear_filter((x + xmin - center + 0.5) * ss) * ss;
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++)
            if (ww != 0.0) k[x] /= ww;
        for (; x < ksize; x++) k[x] = 0;
        bounds[xx * 2 + 0] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    return ksize;
}

// Pillow normalize_coeffs_8bpc: double -> fixed point int32
void normalize_coeffs_8bpc(size_t n, const double* prekk, std::vector<int>& out) {
    out.resize(n);
    for (size_t i = 0; i < n; i++) {
        if (prekk[i] < 0)
            out[i] = (int)(-0.5 + prekk[i] * (1 << PRECISION_BITS));
        else
            out[i] = (int)(0.5 + prekk[i] * (1 << PRECISION_BITS));
    }
}

inline uint8_t clip8(int in) {
    if (in >= (1 << (PRECISION_BITS + 8))) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> PRECISION_BITS);
}

// Horizontal pass over rows [offset, offset + outH): src (srcH, srcW, C)
// -> dst (outH, outW, C). Channel count is a template constant so the
// per-pixel channel loop unrolls into independent accumulators.
template <int C>
void resample_horizontal_c(uint8_t* dst, const uint8_t* src, int srcW,
                           int offset, int outH, int outW, int ksize,
                           const std::vector<int>& bounds,
                           const std::vector<int>& kk) {
    for (int yy = 0; yy < outH; yy++) {
        const uint8_t* in = src + (size_t)(yy + offset) * srcW * C;
        uint8_t* out = dst + (size_t)yy * outW * C;
        for (int xx = 0; xx < outW; xx++) {
            int xmin = bounds[xx * 2 + 0];
            int xmax = bounds[xx * 2 + 1];
            const int* k = &kk[(size_t)xx * ksize];
            int ss[C];
            for (int c = 0; c < C; c++) ss[c] = 1 << (PRECISION_BITS - 1);
            const uint8_t* p = in + (size_t)xmin * C;
            for (int x = 0; x < xmax; x++, p += C)
                for (int c = 0; c < C; c++) ss[c] += p[c] * k[x];
            for (int c = 0; c < C; c++) out[(size_t)xx * C + c] = clip8(ss[c]);
        }
    }
}

void resample_horizontal(uint8_t* dst, const uint8_t* src, int srcW, int C,
                         int offset, int outH, int outW, int ksize,
                         const std::vector<int>& bounds,
                         const std::vector<int>& kk) {
    if (C == 3)
        resample_horizontal_c<3>(dst, src, srcW, offset, outH, outW, ksize,
                                 bounds, kk);
    else if (C == 1)
        resample_horizontal_c<1>(dst, src, srcW, offset, outH, outW, ksize,
                                 bounds, kk);
    else if (C == 4)
        resample_horizontal_c<4>(dst, src, srcW, offset, outH, outW, ksize,
                                 bounds, kk);
    else {  // generic (any C): per-channel scalar loop
        for (int yy = 0; yy < outH; yy++) {
            const uint8_t* in = src + (size_t)(yy + offset) * srcW * C;
            uint8_t* out = dst + (size_t)yy * outW * C;
            for (int xx = 0; xx < outW; xx++) {
                int xmin = bounds[xx * 2 + 0];
                int xmax = bounds[xx * 2 + 1];
                const int* k = &kk[(size_t)xx * ksize];
                for (int c = 0; c < C; c++) {
                    int ss = 1 << (PRECISION_BITS - 1);
                    for (int x = 0; x < xmax; x++)
                        ss += in[(size_t)(x + xmin) * C + c] * k[x];
                    out[(size_t)xx * C + c] = clip8(ss);
                }
            }
        }
    }
}

// Vertical pass: src (srcH, W, C) -> dst (outH, W, C). Taps on the
// OUTER loop, a contiguous int32 row accumulator inner — the inner loop
// is a pure elementwise multiply-add over W*C that the compiler
// auto-vectorizes (8-16 int32 MACs per instruction).
void resample_vertical(uint8_t* dst, const uint8_t* src, int W, int C,
                       int outH, int ksize, const std::vector<int>& bounds,
                       const std::vector<int>& kk) {
    const size_t rowN = (size_t)W * C;
    std::vector<int> acc(rowN);
    for (int yy = 0; yy < outH; yy++) {
        int ymin = bounds[yy * 2 + 0];
        int ymax = bounds[yy * 2 + 1];
        const int* k = &kk[(size_t)yy * ksize];
        int* a = acc.data();
        for (size_t i = 0; i < rowN; i++) a[i] = 1 << (PRECISION_BITS - 1);
        for (int y = 0; y < ymax; y++) {
            const uint8_t* row = src + (size_t)(y + ymin) * rowN;
            const int ky = k[y];
            for (size_t i = 0; i < rowN; i++) a[i] += row[i] * ky;
        }
        uint8_t* out = dst + (size_t)yy * rowN;
        for (size_t i = 0; i < rowN; i++) out[i] = clip8(a[i]);
    }
}

}  // namespace

extern "C" {

// Byte-exact twin of PIL Image.resize((outW,outH), BILINEAR,
// box=(bx0,by0,bx1,by1)) for uint8 HxWxC input. Returns 0 on success.
int resize_bilinear_u8(const uint8_t* src, int H, int W, int C, double bx0,
                       double by0, double bx1, double by1, uint8_t* dst,
                       int outH, int outW) {
    if (C < 1 || H < 1 || W < 1 || outH < 1 || outW < 1) return 1;
    // Pillow's ImagingResample takes the box as C float[4]: round the
    // edges through float32 before any arithmetic
    float fx0 = (float)bx0, fy0 = (float)by0;
    float fx1 = (float)bx1, fy1 = (float)by1;
    // Pillow ImagingResampleInner: box edges compared against the OUTPUT
    // size decide whether a pass runs at all
    bool need_h = outW != W || fx0 != 0.0f || fx1 != (float)outW;
    bool need_v = outH != H || fy0 != 0.0f || fy1 != (float)outH;

    std::vector<int> bounds_h, bounds_v;
    std::vector<double> prekk_h, prekk_v;
    int ksize_h = precompute_coeffs(W, fx0, fx1, outW, bounds_h, prekk_h);
    int ksize_v = precompute_coeffs(H, fy0, fy1, outH, bounds_v, prekk_v);

    // rows of the source the vertical pass will read
    int ybox_first = bounds_v[0];
    int ybox_last = bounds_v[(size_t)outH * 2 - 2] + bounds_v[(size_t)outH * 2 - 1];

    std::vector<uint8_t> temp;
    const uint8_t* cur = src;
    int curW = W;
    if (need_h) {
        for (int i = 0; i < outH; i++) bounds_v[(size_t)i * 2] -= ybox_first;
        std::vector<int> kk;
        normalize_coeffs_8bpc(prekk_h.size(), prekk_h.data(), kk);
        int tH = ybox_last - ybox_first;
        temp.resize((size_t)tH * outW * C);
        resample_horizontal(temp.data(), src, W, C, ybox_first, tH, outW,
                            ksize_h, bounds_h, kk);
        cur = temp.data();
        curW = outW;
    }
    if (need_v) {
        std::vector<int> kk;
        normalize_coeffs_8bpc(prekk_v.size(), prekk_v.data(), kk);
        resample_vertical(dst, cur, curW, C, outH, ksize_v, bounds_v, kk);
    } else if (need_h) {
        memcpy(dst, temp.data(), temp.size());
    } else {
        memcpy(dst, src, (size_t)H * W * C);
    }
    return 0;
}

// out[i, j] = src[yi[i], xi[j]] — the label nearest-grid gather of
// transforms._scaled_crop, one pass, any row stride.
void gather2d_i32(const int32_t* src, int64_t srcW, const int64_t* yi,
                  const int64_t* xi, int64_t outH, int64_t outW,
                  int32_t* dst) {
    for (int64_t i = 0; i < outH; i++) {
        const int32_t* row = src + yi[i] * srcW;
        int32_t* out = dst + i * outW;
        for (int64_t j = 0; j < outW; j++) out[j] = row[xi[j]];
    }
}

void gather2d_u8(const uint8_t* src, int64_t srcW, const int64_t* yi,
                 const int64_t* xi, int64_t outH, int64_t outW, int32_t* dst) {
    for (int64_t i = 0; i < outH; i++) {
        const uint8_t* row = src + yi[i] * srcW;
        int32_t* out = dst + i * outW;
        for (int64_t j = 0; j < outW; j++) out[j] = row[xi[j]];
    }
}

// Fused (optional hflip) + per-channel 256-entry LUT normalize.
// lut layout matches transforms._NORM_LUT: (256, C), f32 entries.
void lut_f32(const uint8_t* src, int64_t H, int64_t W, int64_t C,
             const float* lut, float* dst, int flip) {
    for (int64_t y = 0; y < H; y++) {
        const uint8_t* in = src + y * W * C;
        float* out = dst + y * W * C;
        for (int64_t x = 0; x < W; x++) {
            const uint8_t* p = in + (flip ? (W - 1 - x) : x) * C;
            for (int64_t c = 0; c < C; c++) out[x * C + c] = lut[p[c] * C + c];
        }
    }
}

// Same with 16-bit LUT entries (bfloat16 bit patterns from the host-side
// bf16 normalization table).
void lut_u16(const uint8_t* src, int64_t H, int64_t W, int64_t C,
             const uint16_t* lut, uint16_t* dst, int flip) {
    for (int64_t y = 0; y < H; y++) {
        const uint8_t* in = src + y * W * C;
        uint16_t* out = dst + y * W * C;
        for (int64_t x = 0; x < W; x++) {
            const uint8_t* p = in + (flip ? (W - 1 - x) : x) * C;
            for (int64_t c = 0; c < C; c++) out[x * C + c] = lut[p[c] * C + c];
        }
    }
}

// Optional-hflip contiguous copy for the ship_uint8 path.
void flip_copy_u8(const uint8_t* src, int64_t H, int64_t W, int64_t C,
                  uint8_t* dst, int flip) {
    if (!flip) {
        memcpy(dst, src, (size_t)(H * W * C));
        return;
    }
    for (int64_t y = 0; y < H; y++) {
        const uint8_t* in = src + y * W * C;
        uint8_t* out = dst + y * W * C;
        for (int64_t x = 0; x < W; x++)
            memcpy(out + x * C, in + (W - 1 - x) * C, (size_t)C);
    }
}

// pixel_target_bits tail (losses/fused.py:33-45): per-pixel bitmask
// lookup with the nseg-pad clip and the selected-superpixel gate.
void bits_lookup(const int32_t* spx, const uint8_t* mask,
                 const int64_t* seg_bits, int64_t n, int64_t S,
                 int32_t* dst) {
    for (int64_t i = 0; i < n; i++) {
        int64_t s = spx[i];
        if (s > S - 1) s = S - 1;
        dst[i] = mask[i] ? (int32_t)seg_bits[s] : 0;
    }
}

}  // extern "C"
