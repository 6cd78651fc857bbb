/* ceph_crc32c — CRC-32C (Castagnoli) with the reference's conventions:
 * reflected, NO final inversion, caller seeds (-1 for bufferhash).
 * Mirrors src/common/sctp_crc32.c semantics (the table
 * algorithm re-derived, nothing copied); slicing-by-8 so the messenger's
 * per-frame checksum and the scrubber's shard hashes run at C speed.
 *
 * Built by ceph_tpu/native/build.py into libcrc32c.so and loaded with
 * ctypes (ceph_tpu/common/crc.py); the numpy path is the fallback.
 */

#include <stddef.h>
#include <stdint.h>

static uint32_t table[8][256];
static int initialized = 0;

static void init_tables(void) {
    const uint32_t poly = 0x82F63B78u; /* reflected 0x1EDC6F41 */
    for (int n = 0; n < 256; n++) {
        uint32_t c = (uint32_t)n;
        for (int i = 0; i < 8; i++)
            c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
        table[0][n] = c;
    }
    for (int k = 1; k < 8; k++)
        for (int n = 0; n < 256; n++)
            table[k][n] = table[0][table[k - 1][n] & 0xFF]
                          ^ (table[k - 1][n] >> 8);
    initialized = 1;
}

uint32_t ceph_crc32c_native(uint32_t seed, const uint8_t *data,
                            size_t len) {
    if (!initialized)
        init_tables();
    uint32_t crc = seed;
    while (len >= 8) {
        crc = table[7][(crc ^ data[0]) & 0xFF]
            ^ table[6][((crc >> 8) ^ data[1]) & 0xFF]
            ^ table[5][((crc >> 16) ^ data[2]) & 0xFF]
            ^ table[4][((crc >> 24) ^ data[3]) & 0xFF]
            ^ table[3][data[4]] ^ table[2][data[5]]
            ^ table[1][data[6]] ^ table[0][data[7]];
        data += 8;
        len -= 8;
    }
    while (len--) {
        crc = table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
    }
    return crc;
}
