/* Measured CPU erasure-code baseline: bit-plane XOR-schedule encode.
 *
 * This is the same algorithm class as the reference's jerasure bitmatrix
 * techniques (cauchy_good + jerasure_schedule_encode, vendored jerasure; see
 * src/erasure-code/jerasure/ErasureCodeJerasure.cc:305
 * prepare_schedule): the GF(2^8) coding matrix is expanded to an (8m x 8k)
 * {0,1} bit-matrix and each output bit-plane (a `packetsize`-byte packet) is
 * the XOR of the selected input planes, processed in 64-bit words. It is the
 * strongest simple single-thread CPU formulation (pure cache-resident XOR
 * streaming), standing in for the unbuilt ISA-L submodule.
 *
 * stdin protocol:
 *   k m packetsize iterations chunk_bytes
 *   8m*8k matrix entries (0/1, row-major)
 * Random data is generated internally. Output: elapsed seconds, one float.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

int main(void) {
    int k, m, psize, iters;
    long chunk;
    if (scanf("%d %d %d %d %ld", &k, &m, &psize, &iters, &chunk) != 5)
        return 1;
    int rows = 8 * m, cols = 8 * k;
    unsigned char *bits = malloc((size_t)rows * cols);
    for (int i = 0; i < rows * cols; i++) {
        int v;
        if (scanf("%d", &v) != 1) return 1;
        bits[i] = (unsigned char)v;
    }
    if (chunk % (8 * psize)) {
        fprintf(stderr, "chunk must be a multiple of 8*packetsize\n");
        return 1;
    }
    size_t words_per_packet = (size_t)psize / 8;
    size_t packets = (size_t)chunk / psize / 8; /* packet groups per chunk */
    uint64_t **data = malloc(k * sizeof(*data));
    uint64_t **parity = malloc(m * sizeof(*parity));
    srand(1234);
    for (int j = 0; j < k; j++) {
        data[j] = malloc(chunk);
        unsigned char *p = (unsigned char *)data[j];
        for (long i = 0; i < chunk; i++) p[i] = (unsigned char)rand();
    }
    for (int i = 0; i < m; i++) parity[i] = malloc(chunk);

    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (int it = 0; it < iters; it++) {
        /* layout: chunk j = 8 interleaved planes of `packets` packets:
         * plane b of packet g starts at word (g*8 + b) * words_per_packet */
        for (size_t g = 0; g < packets; g++) {
            for (int oi = 0; oi < rows; oi++) {
                uint64_t *dst =
                    parity[oi / 8] + (g * 8 + (size_t)(oi % 8)) * words_per_packet;
                int first = 1;
                const unsigned char *mrow = bits + (size_t)oi * cols;
                for (int ij = 0; ij < cols; ij++) {
                    if (!mrow[ij]) continue;
                    const uint64_t *src =
                        data[ij / 8] + (g * 8 + (size_t)(ij % 8)) * words_per_packet;
                    if (first) {
                        memcpy(dst, src, words_per_packet * 8);
                        first = 0;
                    } else {
                        for (size_t w = 0; w < words_per_packet; w++)
                            dst[w] ^= src[w];
                    }
                }
                if (first) memset(dst, 0, words_per_packet * 8);
            }
        }
    }
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double el = (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
    /* defeat dead-code elimination */
    uint64_t sink = 0;
    for (int i = 0; i < m; i++) sink ^= parity[i][0];
    fprintf(stderr, "sink %llu\n", (unsigned long long)sink);
    printf("%.6f\n", el);
    return 0;
}
