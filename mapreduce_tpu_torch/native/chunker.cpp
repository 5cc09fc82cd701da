// Native ingest chunker: boundary-aligned batch filling for the streaming
// executor.  The port's copy of the JAX package's host chunker, the batch
// fill of mapreduce_tpu_torch/data/reader.py.  The hot
// host work per step — finding separator-aligned cut points and packing
// rows into the pinned [n_shards, chunk_bytes] staging buffer — runs here
// as straight memcpy/scan loops the compiler vectorizes.  ctypes releases
// the GIL around the call, so the prefetch thread fills the next buffer
// while the main thread launches kernels.
//
// Contract (the JAX reader's numpy cuts exactly; tests assert parity):
//   * a row may only end at a separator byte, so no token spans rows;
//   * if no separator exists in the trailing max_token_bytes window, the row
//     is force-split at the ideal cut (overlong-run guard);
//   * only the true end of file may cut mid-token (at_eof).
//
// Built with g++ as a plain shared library and loaded via ctypes; all
// buffers are caller-allocated numpy arrays.

#include <cstdint>
#include <cstring>

extern "C" {

// Fill one streaming batch.  Returns bytes consumed from buf (== last cut).
//
//   buf/buf_len: the window of the corpus starting at the current offset.
//   at_eof:      nonzero when buf reaches the true end of the file.
//   sep_lut:     256-entry table, nonzero for separator bytes.
//   out_data:    [n_shards * chunk_bytes], fully overwritten (pad = 0).
//   out_bases:   [n_shards] row start offsets relative to buf.
//   out_lengths: [n_shards] valid bytes per row.
int64_t mr_fill_batch(const uint8_t* buf, int64_t buf_len, int at_eof,
                      int64_t n_shards, int64_t chunk_bytes,
                      int64_t max_token_bytes, const uint8_t* sep_lut,
                      uint8_t* out_data, int64_t* out_bases,
                      int64_t* out_lengths) {
  int64_t prev = 0;
  for (int64_t i = 0; i < n_shards; ++i) {
    int64_t cut;
    int64_t ideal = prev + chunk_bytes;
    if (ideal > buf_len) ideal = buf_len;
    if (ideal >= buf_len && at_eof) {
      cut = buf_len;
    } else {
      int64_t lo = ideal - max_token_bytes;
      if (lo < prev) lo = prev;
      cut = ideal;  // force-split when the window has no separator
      for (int64_t j = ideal - 1; j >= lo; --j) {
        if (sep_lut[buf[j]]) {
          cut = j + 1;
          break;
        }
      }
    }
    int64_t len = cut - prev;
    uint8_t* row = out_data + i * chunk_bytes;
    if (len > 0) std::memcpy(row, buf + prev, static_cast<size_t>(len));
    if (len < chunk_bytes)
      std::memset(row + len, 0, static_cast<size_t>(chunk_bytes - len));
    out_bases[i] = prev;
    out_lengths[i] = len;
    prev = cut;
  }
  return prev;
}

// Exact token count of a buffer (host-side oracle / metrics helper): the
// number of non-separator runs.  The buffer end counts as a separator.
int64_t mr_token_count(const uint8_t* buf, int64_t n, const uint8_t* sep_lut) {
  int64_t count = 0;
  int in_token = 0;
  for (int64_t i = 0; i < n; ++i) {
    int sep = sep_lut[buf[i]];
    count += in_token & sep;
    in_token = !sep;
  }
  return count + in_token;
}

}  // extern "C"
