// avsr_tpu_torch native runtime components (C ABI, loaded via ctypes): a
// copy of avsr_tpu/native/avsr_native.cc, the port's own.
//
// The reference's performance-critical substrate is the TF1 C++ runtime
// (SURVEY.md §2.3); the compute path of this framework is XLA/Pallas, and
// the host-side runtime pieces that the TF C++ layer provided are supplied
// here natively:
//
//   * crc32c (Castagnoli) with the TFRecord masking scheme — record
//     integrity on the ingest path (tf.data's C++ TFRecord reader
//     equivalent);
//   * TFRecord stream framing: index/verify/extract record payloads from a
//     raw file buffer without Python-loop overhead;
//   * Levenshtein distance on id sequences — the eval-time scoring kernel
//     (the reference accumulated edit distance in Python; we keep the same
//     workflow with a native kernel, SURVEY §2.2 row 12).
//
// Build: avsr_tpu_torch/native/__init__.py compiles it at first use into the
// repository's build/ directory (libavsr_native_<hash>.so).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// crc32c (software, slice-by-1 table; fast enough for host-side IO checks)
// ---------------------------------------------------------------------------

static uint32_t g_crc_table[256];
static bool g_crc_init = false;

static void crc32c_init_table() {
  const uint32_t poly = 0x82f63b78u;  // reflected Castagnoli
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (poly ^ (c >> 1)) : (c >> 1);
    g_crc_table[i] = c;
  }
  g_crc_init = true;
}

uint32_t avsr_crc32c(const uint8_t* data, uint64_t n) {
  if (!g_crc_init) crc32c_init_table();
  uint32_t c = 0xffffffffu;
  for (uint64_t i = 0; i < n; ++i)
    c = g_crc_table[(c ^ data[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

// TFRecord "masked" crc: rot(crc, 15) + magic.
uint32_t avsr_masked_crc32c(const uint8_t* data, uint64_t n) {
  uint32_t crc = avsr_crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ---------------------------------------------------------------------------
// TFRecord framing
//
// Stream format (per record):
//   uint64 length | uint32 masked_crc32(length) | bytes data |
//   uint32 masked_crc32(data)
// ---------------------------------------------------------------------------

// Scan a file buffer; fill offsets[i]/lengths[i] with the DATA byte spans of
// up to max_records records.  Returns the number of records found, or a
// negative value on framing/crc error (-1 truncated, -2 length-crc mismatch,
// -3 data-crc mismatch when verify != 0).
int64_t avsr_tfrecord_index(const uint8_t* buf, uint64_t size,
                            uint64_t* offsets, uint64_t* lengths,
                            int64_t max_records, int verify) {
  uint64_t pos = 0;
  int64_t count = 0;
  while (pos < size && count < max_records) {
    if (pos + 12 > size) return -1;
    uint64_t len;
    std::memcpy(&len, buf + pos, 8);
    uint32_t len_crc;
    std::memcpy(&len_crc, buf + pos + 8, 4);
    if (avsr_masked_crc32c(buf + pos, 8) != len_crc) return -2;
    // Overflow-safe bounds check: a hostile/corrupt `len` near 2^64 would
    // wrap `pos + 12 + len + 4` past `size`, so compare against the
    // remaining bytes instead (pos + 16 <= size is guaranteed non-negative
    // only after its own check).
    if (pos + 16 > size || len > size - pos - 16) return -1;
    if (verify) {
      uint32_t data_crc;
      std::memcpy(&data_crc, buf + pos + 12 + len, 4);
      if (avsr_masked_crc32c(buf + pos + 12, len) != data_crc) return -3;
    }
    offsets[count] = pos + 12;
    lengths[count] = len;
    ++count;
    pos += 12 + len + 4;
  }
  // Capacity exhausted with bytes left: -4 tells the caller to retry with
  // a larger index (or, at the size/16 hard bound, that the tail is
  // trailing garbage — the pure-Python fallback raises for the same file,
  // and silent acceptance would differ by whether this library built).
  if (count == max_records && pos < size) return -4;
  return count;
}

// Write the framing for one record into out (caller sizes out as len+16).
// Returns total bytes written.
uint64_t avsr_tfrecord_frame(const uint8_t* data, uint64_t len, uint8_t* out) {
  std::memcpy(out, &len, 8);
  uint32_t len_crc = avsr_masked_crc32c(out, 8);
  std::memcpy(out + 8, &len_crc, 4);
  std::memcpy(out + 12, data, len);
  uint32_t data_crc = avsr_masked_crc32c(data, len);
  std::memcpy(out + 12 + len, &data_crc, 4);
  return 12 + len + 4;
}

// ---------------------------------------------------------------------------
// Levenshtein distance (two-row DP) on int32 id sequences
// ---------------------------------------------------------------------------

int64_t avsr_levenshtein(const int32_t* a, int64_t n,
                         const int32_t* b, int64_t m) {
  if (n == 0) return m;
  if (m == 0) return n;
  std::vector<int64_t> prev(n + 1), cur(n + 1);
  for (int64_t i = 0; i <= n; ++i) prev[i] = i;
  for (int64_t j = 1; j <= m; ++j) {
    cur[0] = j;
    for (int64_t i = 1; i <= n; ++i) {
      int64_t sub = prev[i - 1] + (a[i - 1] != b[j - 1]);
      cur[i] = std::min({prev[i] + 1, cur[i - 1] + 1, sub});
    }
    std::swap(prev, cur);
  }
  return prev[n];
}

}  // extern "C"
