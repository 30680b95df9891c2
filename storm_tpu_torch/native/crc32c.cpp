// CRC32C (Castagnoli, reflected polynomial 0x82F63B78), copied from
// storm_tpu/native/crc32c.cpp: the checksum of Kafka's record-batch format
// v2 (KIP-98) and of the dist wire's frames. Table-driven, 4-way slicing.
// Exposed to Python via ctypes (storm_tpu_torch/native/__init__.py), whose
// pure-Python table version is the reference the tests hold it to.

#include <cstdint>
#include <cstddef>

namespace {

struct Tables {
  uint32_t t[4][256];
  Tables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++) {
      t[1][i] = (t[0][i] >> 8) ^ t[0][t[0][i] & 0xFF];
      t[2][i] = (t[1][i] >> 8) ^ t[0][t[1][i] & 0xFF];
      t[3][i] = (t[2][i] >> 8) ^ t[0][t[2][i] & 0xFF];
    }
  }
};

const Tables kTables;

}  // namespace

extern "C" {

// Incremental: pass the previous return value as `crc` to continue
// (initial call: crc = 0).
uint32_t stpu_crc32c(const uint8_t* buf, size_t len, uint32_t crc) {
  crc = ~crc;
  const uint32_t (*t)[256] = kTables.t;
  while (len >= 4) {
    crc ^= static_cast<uint32_t>(buf[0]) | (static_cast<uint32_t>(buf[1]) << 8) |
           (static_cast<uint32_t>(buf[2]) << 16) | (static_cast<uint32_t>(buf[3]) << 24);
    crc = t[3][crc & 0xFF] ^ t[2][(crc >> 8) & 0xFF] ^
          t[1][(crc >> 16) & 0xFF] ^ t[0][crc >> 24];
    buf += 4;
    len -= 4;
  }
  while (len--) crc = (crc >> 8) ^ t[0][(crc ^ *buf++) & 0xFF];
  return ~crc;
}

}  // extern "C"
