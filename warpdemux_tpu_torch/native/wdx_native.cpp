// Native host codec of warpdemux_tpu_torch: the pod5 VBZ signal codec.
//
// The reference's ingest is native too: pod5's C++/Arrow reader decodes
// VBZ-compressed signal (zstd over streamvbyte-16 with zig-zag delta
// coding). The batch compute runs on the device; the ingest decode runs on
// the host: this is its C++ implementation, exposed through a minimal C ABI
// loaded with ctypes (warpdemux_tpu_torch/native/__init__.py, which builds
// this file with g++ -O3 -march=native -shared and links libzstd at first
// use).

#include <cstdint>
#include <cstring>

#include <zstd.h>

extern "C" {

// ---------------------------------------------------------------------------
// VBZ signal codec (pod5 signal compression): zstd( keys || data ) where
// keys hold 1 bit per value (LSB-first; 0 -> 1 byte, 1 -> 2 bytes LE) and
// values are zig-zag-coded deltas of the int16 ADC stream.
// ---------------------------------------------------------------------------

// Returns 0 on success, negative on error. `out` must hold n int16.
int vbz_decode(const uint8_t* payload, int64_t payload_len, int64_t n,
               int16_t* out, uint8_t* scratch, int64_t scratch_len) {
  if (n == 0) return 0;
  size_t raw_len =
      ZSTD_decompress(scratch, (size_t)scratch_len, payload, (size_t)payload_len);
  if (ZSTD_isError(raw_len)) return -1;
  const int64_t keylen = (n + 7) / 8;
  if ((int64_t)raw_len < keylen) return -2;
  const uint8_t* keys = scratch;
  const uint8_t* data = scratch + keylen;
  const uint8_t* data_end = scratch + raw_len;

  int32_t acc = 0;
  int64_t di = 0;
  const int64_t dlen = data_end - data;
  for (int64_t i = 0; i < n; ++i) {
    const int wide = (keys[i >> 3] >> (i & 7)) & 1;
    uint32_t v;
    if (wide) {
      if (di + 2 > dlen) return -3;
      v = (uint32_t)data[di] | ((uint32_t)data[di + 1] << 8);
      di += 2;
    } else {
      if (di + 1 > dlen) return -3;
      v = data[di];
      di += 1;
    }
    const int32_t delta = (int32_t)(v >> 1) ^ -(int32_t)(v & 1);
    acc += delta;
    out[i] = (int16_t)acc;
  }
  return 0;
}

// Encode n int16 samples; returns compressed size, or negative on error.
// `out` must hold at least vbz_encode_bound(n) bytes; `scratch` likewise.
int64_t vbz_encode_bound(int64_t n) {
  return (int64_t)ZSTD_compressBound((size_t)((n + 7) / 8 + 2 * n)) + 16;
}

int64_t vbz_encode(const int16_t* sig, int64_t n, uint8_t* out,
                   int64_t out_len, uint8_t* scratch, int64_t scratch_len) {
  const int64_t keylen = (n + 7) / 8;
  if (scratch_len < keylen + 2 * n) return -1;
  uint8_t* keys = scratch;
  uint8_t* data = scratch + keylen;
  memset(keys, 0, (size_t)keylen);
  int64_t di = 0;
  int32_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t delta = (int32_t)sig[i] - prev;
    prev = sig[i];
    const uint32_t zz = ((uint32_t)(delta << 1)) ^ (uint32_t)(delta >> 31);
    if (zz > 0xFFFFu) return -2;
    if (zz > 0xFFu) {
      keys[i >> 3] |= (uint8_t)(1u << (i & 7));
      data[di++] = (uint8_t)(zz & 0xFF);
      data[di++] = (uint8_t)(zz >> 8);
    } else {
      data[di++] = (uint8_t)zz;
    }
  }
  const size_t csize = ZSTD_compress(out, (size_t)out_len, scratch,
                                     (size_t)(keylen + di), 1);
  if (ZSTD_isError(csize)) return -3;
  return (int64_t)csize;
}

}  // extern "C"
