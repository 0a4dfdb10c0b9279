/* Host-side 8-bit BGR <-> Lab conversion, fixed-point integer pipeline.
 *
 * Same tables and arithmetic as nle_tpu/color/lab.py (bit-exact vs OpenCV's
 * 8U forward conversion); C because these conversions sit on the host
 * image-I/O path of every edit and the NumPy version costs ~50 ms/MP in
 * temporaries — this runs in a few ms. Tables are passed in from Python so
 * there is exactly one table-construction code path.
 *
 * Built as a plain shared library, loaded via ctypes (no pybind11 needed).
 */

#include <stdint.h>
#include <stddef.h>
#ifdef _OPENMP
#include <omp.h>
#endif

#define LAB_SHIFT 12
#define LAB_SHIFT2 15

static inline int32_t descale(int32_t x, int n) {
    return (x + (1 << (n - 1))) >> n;
}

static inline uint8_t clamp255(int32_t v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

/* bgr: N*3 interleaved uint8; lab out: N*3 interleaved uint8. */
void bgr2lab_u8(const uint8_t *bgr, uint8_t *lab, size_t n,
                const int32_t *gamma_tab,   /* 256 */
                const int32_t *cbrt_tab,    /* 3072 */
                const int32_t *coeffs,      /* 9, row-major XYZ */
                int32_t l_scale, int32_t l_shift) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (size_t i = 0; i < n; i++) {
        int32_t b = gamma_tab[bgr[3 * i + 0]];
        int32_t g = gamma_tab[bgr[3 * i + 1]];
        int32_t r = gamma_tab[bgr[3 * i + 2]];
        int32_t ix = descale(r * coeffs[0] + g * coeffs[1] + b * coeffs[2], LAB_SHIFT);
        int32_t iy = descale(r * coeffs[3] + g * coeffs[4] + b * coeffs[5], LAB_SHIFT);
        int32_t iz = descale(r * coeffs[6] + g * coeffs[7] + b * coeffs[8], LAB_SHIFT);
        int32_t fX = cbrt_tab[ix < 0 ? 0 : (ix > 3071 ? 3071 : ix)];
        int32_t fY = cbrt_tab[iy < 0 ? 0 : (iy > 3071 ? 3071 : iy)];
        int32_t fZ = cbrt_tab[iz < 0 ? 0 : (iz > 3071 ? 3071 : iz)];
        int32_t L = descale(l_scale * fY + l_shift, LAB_SHIFT2);
        int32_t A = descale(500 * (fX - fY) + (128 << LAB_SHIFT2), LAB_SHIFT2);
        int32_t B = descale(200 * (fY - fZ) + (128 << LAB_SHIFT2), LAB_SHIFT2);
        lab[3 * i + 0] = clamp255(L);
        lab[3 * i + 1] = clamp255(A);
        lab[3 * i + 2] = clamp255(B);
    }
}

#define IBASE (1 << 14)
#define IGAMMA_MAX 4095  /* inverse-gamma LUT has 4096 entries */

/* lab: N*3 interleaved uint8; bgr out. Bit-exact vs cv2's Lab2RGBinteger
 * (tables built in nle_tpu/color/lab.py; verified on the full 256^3 cube).
 * Worst-case |C @ (x,y,z)| ~= 1.41e9 ~= 2^30.4 < 2^31, so the accumulators
 * fit int32 with under one bit of headroom (do not widen IBASE/the shift
 * without re-deriving the bound); int64 coeffs are kept for pointer-compat
 * with the Python table dtypes. */
void lab2bgr_u8(const uint8_t *lab, uint8_t *bgr, size_t n,
                const int32_t *y_tab,     /* 256 */
                const int32_t *ify_tab,   /* 256 */
                const int32_t *ab_tab,    /* ab_size, index offset -min_ab */
                int32_t min_ab, int32_t ab_size,
                const int64_t *coeffs,    /* 9, row-major RGB rows */
                const uint8_t *gamma_tab, /* 4096 */
                const int32_t *adiv_tab,  /* 256 */
                const int32_t *bdiv_tab   /* 256 */) {
    int32_t C[9];
    for (int k = 0; k < 9; k++) C[k] = (int32_t)coeffs[k];
    /* Index ranges are in-bounds for uint8 input with the CURRENT tables —
     * but the minimum lands exactly on offset 0 (zero margin), so keep the
     * clamp: it is branch-predicted free and protects against any future
     * 1-LSB table-rounding change. */
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (size_t i = 0; i < n; i++) {
        int32_t L = lab[3 * i + 0];
        int32_t y = y_tab[L];
        int32_t ify = ify_tab[L];
        int32_t ix = ify + adiv_tab[lab[3 * i + 1]] - min_ab;
        int32_t iz = ify - bdiv_tab[lab[3 * i + 2]] - min_ab;
        ix = ix < 0 ? 0 : (ix >= ab_size ? ab_size - 1 : ix);
        iz = iz < 0 ? 0 : (iz >= ab_size ? ab_size - 1 : iz);
        int32_t x = ab_tab[ix];
        int32_t z = ab_tab[iz];
        int32_t ro = (C[0] * x + C[1] * y + C[2] * z + (1 << 13)) >> 14;
        int32_t go = (C[3] * x + C[4] * y + C[5] * z + (1 << 13)) >> 14;
        int32_t bo = (C[6] * x + C[7] * y + C[8] * z + (1 << 13)) >> 14;
        ro = ro < 0 ? 0 : (ro > IGAMMA_MAX ? IGAMMA_MAX : ro);
        go = go < 0 ? 0 : (go > IGAMMA_MAX ? IGAMMA_MAX : go);
        bo = bo < 0 ? 0 : (bo > IGAMMA_MAX ? IGAMMA_MAX : bo);
        bgr[3 * i + 0] = gamma_tab[bo];
        bgr[3 * i + 1] = gamma_tab[go];
        bgr[3 * i + 2] = gamma_tab[ro];
    }
}
