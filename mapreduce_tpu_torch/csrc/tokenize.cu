// Tokenize + hash kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mapreduce_tpu/ops/pallas/tokenize.py:_tokenize_kernel
// in its compact lane-major mode (tokenize_split_compact), its pair mode
// (tokenize_split, the exact spill fallback), its fused mode (tokenize_fused:
// the same stream, so the same kernel) and its hot-key combiner mode
// (tokenize_fused with combiner_slots, tokenize.py:388-452).  What they
// compute is the TPU kernel's contract, not its layout: for every token end
// in a chunk, the W-byte lookback into two uint32 polynomial hashes, a
// length-mixed fmix32, a clamp off the sentinel keys, and one row (key_hi,
// key_lo, packed = start << 6 | len).  A run longer than W is counted once,
// at its end, as a poison row (sent, sent - 1, last_byte << 6).
//
// tokenize_windows.  One CTA per WINDOW contiguous bytes of the chunk.  The
// CTA owns `slots` output rows; its live rows (token ends and poisons) are
// written in ascending byte position, so flattening [cta][slot] gives a
// stream in global byte order (the precondition of the stable 2-key
// aggregation sort).  Rows beyond `slots` are counted into `spill` and not
// written: the caller then reruns the chunk in pair mode, slots = WINDOW / 2,
// which cannot spill (two adjacent bytes are never both token ends).  Unused
// slots hold (sent, sent, 0xFFFFFFFF).  There is no seam pass: the CTA reads
// a halo of W + 1 bytes before its window and one byte after it.
//
// tokenize_combiner.  The chunk splits into gridDim.x = 128 segments of
// seg_len bytes (the TPU kernel's lanes); a token belongs to the segment
// that holds its end byte.  One CTA per segment walks it window by window
// (the windows above, cut at the segment's end) and keeps a cache of the
// segment's first C distinct keys in shared memory: their every occurrence
// is counted there and left out of the stream, and the first occurrence's
// `packed` is kept.  Poison rows are never cached.  Rows left in each window
// are written as tokenize_windows writes them, laid out [segment][window]
// [slot] (global byte order), and the cache is flushed as four (C, 128)
// planes.  Exactness never depends on the cache: a spill sends the caller
// to the combiner-free pair mode.
//
// Each uint32 word is stored zero-extended into an int64 element, the form
// in which the PyTorch side carries uint32 (torch has no uint32 shifts or
// sorts), so no widening pass follows a kernel.
//
// Bound on this card: device-memory bytes.  A kernel reads the chunk's N
// bytes and writes 24 bytes per output row.  Each input byte is read from
// device memory once (plus the 65-byte halo per 3072-byte window) and every
// lookback is served from shared memory.  The combiner kernel runs only 128
// CTAs, one per segment, each walking its windows in turn: it is bounded by
// that serial walk, not by the card (ROADMAP.md names its parallel design).
//
// Bytes before 0 and at or after N are separators (PAD_BYTE 0x00 is one).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 3072;              // bytes per window
constexpr int kThreads = 256;
constexpr int kPer = kWindow / kThreads;   // contiguous bytes per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 63;                  // length is packed into 6 bits
constexpr int kHalo = kMaxW + 1;           // bytes kept before the window
constexpr int kBuf = kHalo + kWindow + 1;  // plus one byte after it
constexpr int kMaxRows = kWindow / 2;      // token ends in one window
constexpr int kRowsPer = kMaxRows / kThreads;  // rows per thread, by rank
constexpr int kMaxCache = 32;              // combiner slots per segment
constexpr int kSegments = 128;             // combiner segments per chunk
constexpr uint32_t kSent = 0xFFFFFFFFu;
constexpr uint32_t kBase1 = 16777619u;     // constants.HASH_BASE_1
constexpr uint32_t kBase2 = 2654435761u;   // constants.HASH_BASE_2

static_assert(kWindow % kThreads == 0, "window must split evenly");
static_assert(kPer <= 32, "live flags of a thread fit one word");
static_assert(kMaxRows % kThreads == 0, "rows must split evenly");

// Row states in the combiner's window.
constexpr uint8_t kPoison = 0;
constexpr uint8_t kEmit = 1;
constexpr uint8_t kCached = 2;

// constants.SEPARATOR_BYTES: NUL, TAB, LF, VT, FF, CR, space.
__device__ __forceinline__ bool is_sep(uint8_t b) {
  return b == 0x00 || b == 0x20 || (b >= 0x09 && b <= 0x0D);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Sum of `v` over the CTA; every thread gets the result.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int s = 0;
  for (int i = 0; i < kWarps; ++i) s += scratch[i];
  return s;
}

// Minimum of `v` over the CTA; every thread gets the result.
__device__ __forceinline__ int block_min(int v, int* scratch) {
  for (int d = 16; d > 0; d >>= 1)
    v = min(v, __shfl_down_sync(0xffffffffu, v, d));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int m = INT_MAX;
  for (int i = 0; i < kWarps; ++i) m = min(m, scratch[i]);
  return m;
}

// buf[i] = byte at base - kHalo + i, separators outside [0, n).
__device__ __forceinline__ void load_window(uint8_t* buf, const uint8_t* data,
                                            long long base, long long n) {
  for (int i = threadIdx.x; i < kBuf; i += kThreads) {
    const long long g = base - kHalo + i;
    buf[i] = (g >= 0 && g < n) ? data[g] : 0;
  }
}

// Which of this thread's kPer positions below `end` (absolute) are live
// rows: a token end (emission or poison) is a non-separator byte followed
// by a separator.  Returns the flags; `live` gets their count.
__device__ __forceinline__ uint32_t live_flags(const uint8_t* buf,
                                               long long base, long long end,
                                               int* live) {
  const int first = threadIdx.x * kPer;
  uint32_t bits = 0;
  int count = 0;
  for (int j = 0; j < kPer; ++j) {
    const int i = kHalo + first + j;
    if (base + first + j < end && !is_sep(buf[i]) && is_sep(buf[i + 1])) {
      bits |= 1u << j;
      ++count;
    }
  }
  *live = count;
  return bits;
}

// Exclusive scan of `v` over the CTA: returns the thread's offset and
// stores the CTA's total in *total.  The caller separates two calls, and a
// call from the readers of the previous one, by a __syncthreads.
__device__ __forceinline__ int block_scan(int v, int* warp_off, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int x = lane < kWarps ? warp_off[lane] : 0;
    int s = x;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += u;
    }
    if (lane < kWarps) warp_off[lane] = s - x;
    if (lane == kWarps - 1) *total = s;
  }
  __syncthreads();
  return warp_off[warp] + incl - v;
}

// The row of the token end at buf[i] (absolute position p): returns true
// for a poison row (the run is longer than W).
__device__ __forceinline__ bool hash_row(const uint8_t* buf, int i,
                                         long long p, int w, uint32_t* hi,
                                         uint32_t* lo, uint32_t* pk) {
  int len = 0;
  while (len < w && !is_sep(buf[i - len])) ++len;
  // The run is longer than W when the byte W back is still inside it.
  if (len == w && !is_sep(buf[i - w])) {
    *hi = kSent;
    *lo = kSent - 1u;
    *pk = static_cast<uint32_t>(p) << 6;
    return true;
  }
  uint32_t h1 = 0, h2 = 0;
  for (int k = i - len + 1; k <= i; ++k) {
    const uint32_t c = static_cast<uint32_t>(buf[k]) + 1u;
    h1 = h1 * kBase1 + c;
    h2 = h2 * kBase2 + c;
  }
  const uint32_t ln = static_cast<uint32_t>(len);
  *hi = fmix32(h1 ^ ln);
  *lo = fmix32(h2 + 0x9E3779B9u * ln);
  if (*hi == kSent && *lo >= kSent - 1u) *lo = kSent - 2u;
  *pk = (static_cast<uint32_t>(p + 1 - len) << 6) | ln;
  return false;
}

__device__ __forceinline__ void put_row(int64_t* khi, int64_t* klo,
                                        int64_t* packed, long long at,
                                        uint32_t hi, uint32_t lo,
                                        uint32_t pk) {
  khi[at] = hi;
  klo[at] = lo;
  packed[at] = pk;
}

// Dead filler in slots [from, slots) of the window whose first row is out0.
__device__ __forceinline__ void fill_dead(int64_t* khi, int64_t* klo,
                                          int64_t* packed, long long out0,
                                          int from, int slots) {
  for (int s = from + threadIdx.x; s < slots; s += kThreads)
    put_row(khi, klo, packed, out0 + s, kSent, kSent, 0xFFFFFFFFu);
}

__global__ void __launch_bounds__(kThreads)
tokenize_windows(const uint8_t* __restrict__ data, long long n, int w,
                 int slots, int64_t* __restrict__ khi,
                 int64_t* __restrict__ klo, int64_t* __restrict__ packed,
                 unsigned long long* __restrict__ counters) {
  __shared__ uint8_t buf[kBuf];  // buf[i] = byte at base - kHalo + i
  __shared__ int warp_off[kWarps];
  __shared__ int live_total;
  __shared__ int scratch[kWarps];

  const long long base = static_cast<long long>(blockIdx.x) * kWindow;
  load_window(buf, data, base, n);
  __syncthreads();

  int live;
  const uint32_t live_bits = live_flags(buf, base, n, &live);
  int slot = block_scan(live, warp_off, &live_total);
  const int total = live_total;

  // Hash each live row from shared memory and write it.
  const int first = threadIdx.x * kPer;
  const long long out0 = static_cast<long long>(blockIdx.x) * slots;
  int n_over = 0, n_emit = 0;
  for (int j = 0; j < kPer; ++j) {
    if (!((live_bits >> j) & 1u)) continue;
    uint32_t hi, lo, pk;
    if (hash_row(buf, kHalo + first + j, base + first + j, w, &hi, &lo, &pk))
      ++n_over;
    else
      ++n_emit;
    if (slot < slots) put_row(khi, klo, packed, out0 + slot, hi, lo, pk);
    ++slot;
  }
  fill_dead(khi, klo, packed, out0, min(total, slots), slots);

  const int over_sum = block_sum(n_over, scratch);
  const int emit_sum = block_sum(n_emit, scratch);
  if (threadIdx.x == 0) {
    if (over_sum)
      atomicAdd(&counters[0], static_cast<unsigned long long>(over_sum));
    if (emit_sum)
      atomicAdd(&counters[1], static_cast<unsigned long long>(emit_sum));
    if (total > slots)
      atomicAdd(&counters[2], static_cast<unsigned long long>(total - slots));
  }
}

__global__ void __launch_bounds__(kThreads)
tokenize_combiner(const uint8_t* __restrict__ data, long long n,
                  long long seg_len, int w, int slots, int cslots,
                  int64_t* __restrict__ khi, int64_t* __restrict__ klo,
                  int64_t* __restrict__ packed, int64_t* __restrict__ c_khi,
                  int64_t* __restrict__ c_klo, int64_t* __restrict__ c_cnt,
                  int64_t* __restrict__ c_pk,
                  unsigned long long* __restrict__ counters) {
  __shared__ uint8_t buf[kBuf];
  __shared__ int warp_off[kWarps];
  __shared__ int row_total;
  __shared__ int scratch[kWarps];
  // The window's live rows by rank (ascending position).
  __shared__ uint32_t row_hi[kMaxRows], row_lo[kMaxRows], row_pk[kMaxRows];
  __shared__ uint8_t row_state[kMaxRows];
  // The segment's cache: slot c holds its (c + 1)-th distinct key.
  __shared__ uint32_t cache_hi[kMaxCache], cache_lo[kMaxCache],
      cache_pk[kMaxCache];
  __shared__ int cache_cnt[kMaxCache];

  const int seg = blockIdx.x;
  const long long seg0 = static_cast<long long>(seg) * seg_len;
  const long long seg_end = seg0 + seg_len;
  const int windows = static_cast<int>((seg_len + kWindow - 1) / kWindow);
  const int r0 = threadIdx.x * kRowsPer;  // this thread's ranks
  int filled = 0;                          // the same in every thread
  int n_over = 0, n_emit = 0, n_spill = 0;

  for (int win = 0; win < windows; ++win) {
    const long long base = seg0 + static_cast<long long>(win) * kWindow;
    __syncthreads();  // the previous window's readers are done
    load_window(buf, data, base, n);
    __syncthreads();
    int live;
    const uint32_t live_bits = live_flags(buf, base, seg_end, &live);
    int rank = block_scan(live, warp_off, &row_total);
    const int total = row_total;
    const int first = threadIdx.x * kPer;
    for (int j = 0; j < kPer; ++j) {
      if (!((live_bits >> j) & 1u)) continue;
      uint32_t hi, lo, pk;
      const bool over = hash_row(buf, kHalo + first + j, base + first + j, w,
                                 &hi, &lo, &pk);
      row_hi[rank] = hi;
      row_lo[rank] = lo;
      row_pk[rank] = pk;
      row_state[rank] = over ? kPoison : kEmit;
      ++rank;
    }
    __syncthreads();
    const int r1 = min(r0 + kRowsPer, total);

    // Hit pass: resident keys absorb their occurrences.
    for (int r = r0; r < r1; ++r) {
      if (row_state[r] != kEmit) continue;
      for (int c = 0; c < filled; ++c) {
        if (row_hi[r] == cache_hi[c] && row_lo[r] == cache_lo[c]) {
          atomicAdd(&cache_cnt[c], 1);
          row_state[r] = kCached;
          break;
        }
      }
    }
    // Fill pass: an empty slot adopts the first remaining emission's key,
    // a key new to the segment, with every occurrence of it here.
    while (filled < cslots) {
      int head = INT_MAX;
      for (int r = r0; r < r1; ++r) {
        if (row_state[r] == kEmit) {
          head = r;
          break;
        }
      }
      head = block_min(head, scratch);
      if (head == INT_MAX) break;
      const uint32_t hi = row_hi[head], lo = row_lo[head];
      int hits = 0;
      for (int r = r0; r < r1; ++r) {
        if (row_state[r] == kEmit && row_hi[r] == hi && row_lo[r] == lo) {
          row_state[r] = kCached;
          ++hits;
        }
      }
      hits = block_sum(hits, scratch);
      if (threadIdx.x == 0) {
        cache_hi[filled] = hi;
        cache_lo[filled] = lo;
        cache_pk[filled] = row_pk[head];
        cache_cnt[filled] = hits;
      }
      ++filled;
    }
    __syncthreads();

    // Compact the rows left into the window's slots, in rank order.
    int keep = 0;
    for (int r = r0; r < r1; ++r) {
      const uint8_t s = row_state[r];
      keep += s != kCached;
      n_emit += s == kEmit;
      n_over += s == kPoison;
    }
    int slot = block_scan(keep, warp_off, &row_total);
    const int kept = row_total;
    const long long out0 =
        (static_cast<long long>(seg) * windows + win) * slots;
    for (int r = r0; r < r1; ++r) {
      if (row_state[r] == kCached) continue;
      if (slot < slots)
        put_row(khi, klo, packed, out0 + slot, row_hi[r], row_lo[r],
                row_pk[r]);
      ++slot;
    }
    fill_dead(khi, klo, packed, out0, min(kept, slots), slots);
    if (kept > slots) n_spill += kept - slots;  // the same in every thread
  }

  // Flush: one plane row per slot, planes (cslots, 128).
  __syncthreads();
  for (int c = threadIdx.x; c < cslots; c += kThreads) {
    const long long at = static_cast<long long>(c) * gridDim.x + seg;
    const bool full = c < filled;
    c_khi[at] = full ? cache_hi[c] : kSent;
    c_klo[at] = full ? cache_lo[c] : kSent;
    c_cnt[at] = full ? cache_cnt[c] : 0;
    c_pk[at] = full ? cache_pk[c] : 0xFFFFFFFFu;
  }
  const int over_sum = block_sum(n_over, scratch);
  const int emit_sum = block_sum(n_emit, scratch);
  if (threadIdx.x == 0) {
    if (over_sum)
      atomicAdd(&counters[0], static_cast<unsigned long long>(over_sum));
    if (emit_sum)
      atomicAdd(&counters[1], static_cast<unsigned long long>(emit_sum));
    if (n_spill)
      atomicAdd(&counters[2], static_cast<unsigned long long>(n_spill));
  }
}

}  // namespace

// Launch over a chunk of n bytes on `stream`.  Outputs are int64 planes of
// ceil(n / 3072) * slots rows each, holding uint32 words; the int64
// counters (overlong, tokens, spill) must be zeroed by the caller.  Returns
// cudaGetLastError() after the launch.
extern "C" int mr_tokenize_windows(const void* data, long long n, int w,
                                   int slots, void* khi, void* klo,
                                   void* packed, void* counters,
                                   void* stream) {
  if (n <= 0 || w < 1 || w > kMaxW || slots < 1 || slots > kWindow)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (n + kWindow - 1) / kWindow;
  tokenize_windows<<<static_cast<unsigned>(grid), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, w, slots,
      static_cast<int64_t*>(khi), static_cast<int64_t*>(klo),
      static_cast<int64_t*>(packed),
      static_cast<unsigned long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}

// Launch the combiner over a chunk of n = 128 * seg_len bytes.  Stream
// planes hold 128 * ceil(seg_len / 3072) * slots rows, cache planes
// cslots * 128; counters as above, zeroed by the caller.
extern "C" int mr_tokenize_combiner(const void* data, long long n, int w,
                                    int slots, int cslots, void* khi,
                                    void* klo, void* packed, void* c_khi,
                                    void* c_klo, void* c_cnt, void* c_pk,
                                    void* counters, void* stream) {
  if (n <= 0 || n % kSegments || w < 1 || w > kMaxW || slots < 1 ||
      slots > kWindow || cslots < 1 || cslots > kMaxCache)
    return static_cast<int>(cudaErrorInvalidValue);
  tokenize_combiner<<<kSegments, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, n / kSegments, w, slots, cslots,
      static_cast<int64_t*>(khi), static_cast<int64_t*>(klo),
      static_cast<int64_t*>(packed), static_cast<int64_t*>(c_khi),
      static_cast<int64_t*>(c_klo), static_cast<int64_t*>(c_cnt),
      static_cast<int64_t*>(c_pk),
      static_cast<unsigned long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}

// Bytes per CTA window, so the Python side can check its copy.
extern "C" int mr_tokenize_window_bytes() { return kWindow; }
