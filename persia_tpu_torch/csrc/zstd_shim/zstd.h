// The few ZSTD_* entries of native/src/net.h, for a host without zstd's
// headers (persia_tpu_torch/service/native_bin.py builds the service
// binaries against this directory there). Compression never applies:
// ZSTD_compress always answers an error, so send_msg sends the payload
// as it is. A compressed frame is refused: ZSTD_getFrameContentSize
// answers ZSTD_CONTENTSIZE_ERROR, so recv_msg throws "bad zstd payload"
// and the connection closes. Error codes follow zstd's convention: the
// last 120 values of size_t.
#pragma once

#include <stddef.h>

#define ZSTD_CONTENTSIZE_UNKNOWN (0ULL - 1)
#define ZSTD_CONTENTSIZE_ERROR (0ULL - 2)

static inline unsigned ZSTD_isError(size_t code) {
  return code > (size_t)-120;
}

static inline unsigned long long ZSTD_getFrameContentSize(const void*,
                                                          size_t) {
  return ZSTD_CONTENTSIZE_ERROR;
}

static inline size_t ZSTD_decompress(void*, size_t, const void*, size_t) {
  return (size_t)-1;
}

static inline size_t ZSTD_compressBound(size_t) { return 0; }

static inline size_t ZSTD_compress(void*, size_t, const void*, size_t, int) {
  return (size_t)-1;
}
