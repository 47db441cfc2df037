// Host-side C++ of the port's PNG readers (utils/png.py): undoes the five
// PNG row filters, built with g++ by mulactseg_tpu_torch/native.py (CPU
// code, not a kernel of the card). Average and Paeth make each byte wait
// for its left neighbour, a serial walk that numpy cannot vectorise well;
// here it is one pass over the rows.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// raw: H scanlines of 1 + n bytes, the filter type first; out: H x n
// bytes; bpp: bytes per pixel, the distance to the left neighbour.
// Returns 0, or 1 for an unknown filter type (out is then incomplete).
int png_unfilter(const uint8_t* raw, int64_t H, int64_t n, int64_t bpp,
                 uint8_t* out) {
    std::vector<uint8_t> zero((size_t)n, 0);
    const uint8_t* prev = zero.data();  // the row above the first: zeros
    for (int64_t y = 0; y < H; y++) {
        const uint8_t* f = raw + y * (n + 1) + 1;
        uint8_t* cur = out + y * n;
        switch (raw[y * (n + 1)]) {
            case 0:  // None
                memcpy(cur, f, (size_t)n);
                break;
            case 1:  // Sub
                for (int64_t x = 0; x < n; x++)
                    cur[x] = (uint8_t)(f[x] + (x >= bpp ? cur[x - bpp] : 0));
                break;
            case 2:  // Up
                for (int64_t x = 0; x < n; x++)
                    cur[x] = (uint8_t)(f[x] + prev[x]);
                break;
            case 3:  // Average
                for (int64_t x = 0; x < n; x++) {
                    int a = x >= bpp ? cur[x - bpp] : 0;
                    cur[x] = (uint8_t)(f[x] + ((a + prev[x]) >> 1));
                }
                break;
            case 4:  // Paeth: the one of a, b, c nearest to a + b - c
                for (int64_t x = 0; x < n; x++) {
                    int a = x >= bpp ? cur[x - bpp] : 0;
                    int b = prev[x];
                    int c = x >= bpp ? prev[x - bpp] : 0;
                    int pa = abs(b - c), pb = abs(a - c),
                        pc = abs(a + b - 2 * c);
                    int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    cur[x] = (uint8_t)(f[x] + pred);
                }
                break;
            default:
                return 1;
        }
        prev = cur;
    }
    return 0;
}

}  // extern "C"
