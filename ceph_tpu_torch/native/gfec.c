/* Native GF(2^8) region arithmetic for the host EC path.
 *
 * The role isa-l's assembly plays in the reference
 * (src/erasure-code/isa/ErasureCodeIsa.cc:129 ec_encode_data): the
 * per-coefficient region multiply runs as the PSHUFB nibble-table
 * technique over AVX2 lanes, with a portable scalar fallback.  The
 * Python host codecs call this through ctypes (ceph_tpu/native) and
 * fall back to numpy when the shared object is unavailable; outputs
 * are bit-identical either way (pinned by tests/test_native_gfec.py).
 *
 * Built with: gcc -O3 -mavx2 -shared -fPIC gfec.c -o libgfec.so
 */
#include <stdint.h>
#include <string.h>

#ifdef __AVX2__
#include <immintrin.h>
#endif

static uint8_t MUL[256][256];
static int tables_ready = 0;

static uint8_t gf_mul1(uint8_t a, uint8_t b) {
    uint16_t r = 0, aa = a;
    int i;
    for (i = 0; i < 8; i++)
        if (b & (1 << i)) r ^= aa << i;
    for (i = 15; i >= 8; i--)
        if (r & (1 << i)) r ^= 0x11d << (i - 8);
    return (uint8_t)r;
}

void gfec_init(void) {
    int a, b;
    if (tables_ready) return;
    for (a = 0; a < 256; a++)
        for (b = 0; b < 256; b++)
            MUL[a][b] = gf_mul1((uint8_t)a, (uint8_t)b);
    tables_ready = 1;
}

/* dst ^= c * src over n bytes */
void gfec_region_mad(uint8_t *dst, const uint8_t *src, uint8_t c,
                     size_t n) {
    size_t i = 0;
    if (!tables_ready) gfec_init();
    if (c == 0) return;
    if (c == 1) {
        for (; i < n; i++) dst[i] ^= src[i];
        return;
    }
#ifdef __AVX2__
    {
        uint8_t lo_t[16], hi_t[16];
        __m256i lo, hi, mask;
        int j;
        for (j = 0; j < 16; j++) {
            lo_t[j] = MUL[c][j];
            hi_t[j] = MUL[c][j << 4];
        }
        lo = _mm256_broadcastsi128_si256(
            _mm_loadu_si128((const __m128i *)lo_t));
        hi = _mm256_broadcastsi128_si256(
            _mm_loadu_si128((const __m128i *)hi_t));
        mask = _mm256_set1_epi8(0x0f);
        for (; i + 32 <= n; i += 32) {
            __m256i s = _mm256_loadu_si256((const __m256i *)(src + i));
            __m256i l = _mm256_and_si256(s, mask);
            __m256i h = _mm256_and_si256(_mm256_srli_epi64(s, 4), mask);
            __m256i r = _mm256_xor_si256(_mm256_shuffle_epi8(lo, l),
                                         _mm256_shuffle_epi8(hi, h));
            __m256i d = _mm256_loadu_si256((const __m256i *)(dst + i));
            _mm256_storeu_si256((__m256i *)(dst + i),
                                _mm256_xor_si256(d, r));
        }
    }
#endif
    for (; i < n; i++) dst[i] ^= MUL[c][src[i]];
}

/* parity[m][n] = matrix[m][k] (x) data[k][n]; rows are contiguous.
 * data/parity are flat row-major buffers. */
void gfec_matmul(const uint8_t *matrix, int k, int m,
                 const uint8_t *data, uint8_t *parity, size_t n) {
    int i, j;
    if (!tables_ready) gfec_init();
    memset(parity, 0, (size_t)m * n);
    for (i = 0; i < m; i++)
        for (j = 0; j < k; j++)
            gfec_region_mad(parity + (size_t)i * n,
                            data + (size_t)j * n,
                            matrix[i * k + j], n);
}
