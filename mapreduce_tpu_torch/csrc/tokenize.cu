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
// tokenize_stream (compact, pair and fused mode: one dense stream).  Every
// live row of the chunk (token ends and poisons), in ascending byte
// position, then ONE dead row (sent, sent, 0xFFFFFFFF) at index `live`;
// nothing after it is written.  Global byte order is the precondition of
// the stable 2-key aggregation sort, and the stream cannot overflow: two
// adjacent bytes are never both token ends, so ceil(n / 2) + 1 rows hold
// it.  The TPU kernel's slots per window, dead filler and spill are gone.
//
//   - A CTA takes its tile of kTile = 8 KB from an atomic ticket, so every
//     tile its look-back waits for has started.  At most 32 registers a
//     thread let 8 CTAs share an SM: a tile's loads, hashing and stores
//     run one after another, so the card needs many tiles in flight.
//   - It loads the tile, a halo of kTileHalo = W_max + 1 bytes before it
//     and 16 bytes after it into shared memory, 16 bytes a thread per load
//     (tiles sit on 16-byte boundaries of the buffer's address; only the
//     chunk's two ragged ends are read byte by byte).
//   - Each thread marks the token ends among its 32 bytes (a separator
//     bitmask shifted against itself); ONE block-wide scan ranks them.
//   - A decoupled look-back over the tiles' live counts (one warp, 32
//     predecessors a step) gives the tile its first output row.
//   - The threads then take the tile's rows in rank order, each row hashed
//     from shared memory in one backward pass over at most W bytes, and
//     write them to the int64 planes at offset + rank: neighbouring threads
//     on neighbouring addresses, so the stores are coalesced.
//   - One atomicAdd per CTA for the overlong and the token totals; the
//     last tile writes the dead row and the live count.
//
// The hot-key combiner keeps windows of kWindow bytes, one CTA each, and
// its own helpers; it shares is_sep, fmix32 and the look-back with
// tokenize_stream.  The chunk splits into 128 segments of seg_len bytes
// (the TPU kernel's lanes); a token belongs to the segment that holds its
// end byte, and each segment is cut into windows, the last one short.  The
// cache of a segment is its first C distinct keys: their every occurrence
// is counted there and left out of the stream, and the first occurrence's
// `packed` is kept.  Poison rows are never cached.  The rows left form ONE
// dense stream in global byte order, tokenize_stream's layout: every kept
// row, then one dead row at index `live`, nothing written after it.  A
// window that keeps more than `slots` rows counts the excess as spill (the
// TPU kernel's window budget, so the caller's combiner-free rerun fires on
// the same chunks); the cache is flushed as four (C, 128) planes.
// Exactness never depends on the cache: a spill sends the caller to the
// combiner-free dense stream.  One launch, combiner_stream, one CTA a
// window, the windows taken from an atomic ticket in global byte order:
//
//   - load the window and hash its live rows into shared memory, in rank
//     (position) order;
//   - warp 0 takes the keys its segment cached before this window (none in
//     the segment's first window; all C once a window set the segment's
//     full flag; else the count the previous window published, waited for
//     with a bounded poll), extends the list with the window's first new
//     emission keys in rank order, writes them into the cache planes and
//     publishes the count;
//   - every row whose key is on the list leaves the stream and counts in
//     its slot (warp-aggregated hits, one atomic per slot per CTA into the
//     count plane, which the launcher zeroes); the rest are written at the
//     offset a decoupled look-back over the windows' kept counts gives;
//   - the segment's last window fills the slots no key took; the chunk's
//     last window writes the dead row and the live count.
//
// A window needs only the keys cached up to itself: a key the segment
// caches later first appears later.  Every window it waits for, for the
// list or the look-back, took an earlier ticket, so it has started.
//
// The flushed cache then folds into the chunk's table (built from the
// thinned stream) in two more launches, the JAX package's merge of the
// table with the cache's own table:
//
//   combiner_fold_keys   one CTA: the cache's live entries sorted by key in
//                        shared memory and coalesced (counts add, the
//                        smallest packed leads), each key's lower bound in
//                        the table and whether the table holds it, and a
//                        scan of the keys it does not; written once to a
//                        scratch of 24 B an entry;
//   combiner_fold_merge  one thread a table row or cache key: each lands at
//                        its rank in the union (a key in both adds the
//                        cache's count and keeps the earlier occurrence),
//                        rows past the capacity are dropped and counted,
//                        the rest of the table is holes; the last CTA
//                        writes the dropped totals.
//
// Each uint32 word is stored zero-extended into an int64 element, the form
// in which the PyTorch side carries uint32 (torch has no uint32 shifts or
// sorts), so no widening pass follows a kernel.
//
// Bound on this card: device-memory bytes.  A kernel reads the chunk's N
// bytes and writes 24 bytes per output row: tokenize_stream live + 1 rows.
// Each input byte is read from device memory once (plus an 80-byte halo
// per 8192-byte tile) and every lookback is served from shared memory.
// The combiner reads each byte once too (a 65-byte halo per 3072-byte
// window), writes only the rows it leaves, densely, and its cache planes;
// a window after its segment's first reads the segment's list back.
//
// Bytes before 0 and at or after N are separators (PAD_BYTE 0x00 is one).

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
constexpr int kRowsPer = kMaxRows / kThreads;  // ranks per thread
constexpr int kMaxCache = 32;              // combiner slots per segment
constexpr int kSegments = 128;             // combiner segments per chunk
constexpr uint32_t kSent = 0xFFFFFFFFu;
constexpr uint32_t kBase1 = 16777619u;     // constants.HASH_BASE_1
constexpr uint32_t kBase2 = 2654435761u;   // constants.HASH_BASE_2

static_assert(kWindow % kThreads == 0, "window must split evenly");
static_assert(kPer <= 32, "live flags of a thread fit one word");
static_assert(kMaxCache <= 32, "a warp holds one cache slot per lane");
static_assert(kMaxRows % kThreads == 0, "ranks split evenly");

// tokenize_stream's geometry and look-back.
constexpr int kTile = 8192;                          // bytes per tile
constexpr int kTilePer = kTile / kThreads;           // bytes per thread
constexpr int kTileBlocks = 8;  // CTAs an SM holds: at most 32 registers
constexpr int kTileHalo = kMaxW + 1;                 // bytes before a tile
constexpr int kTileGroups = (kTileHalo + kTile + 16) / 16;  // 16-byte loads
constexpr int kTileRows = kTile / 2;                 // token ends in a tile
// Look-back status word of a tile: flag (aggregate or inclusive prefix) in
// the top 2 bits, a live count (<= 2**25 in a chunk) below.
constexpr uint32_t kFlagAgg = 1u << 30;
constexpr uint32_t kFlagPrefix = 2u << 30;
constexpr uint32_t kCountMask = kFlagAgg - 1u;
// Polls of a look-back before the kernel traps: a fault ends the launch
// with an error instead of spinning forever.
constexpr unsigned kMaxPolls = 1u << 26;

static_assert(kTilePer % 16 == 0 && kTilePer <= 32,
              "a thread owns one or two 16-byte groups of a tile");
static_assert(kTileHalo % 16 == 0, "the halo is whole 16-byte groups");

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

// buf[i] = byte at base - kHalo + i, separators outside [0, lim).  A
// window reads no byte past its segment's end and the one after it.
__device__ __forceinline__ void load_window(uint8_t* buf, const uint8_t* data,
                                            long long base, long long lim) {
  for (int i = threadIdx.x; i < kBuf; i += kThreads) {
    const long long g = base - kHalo + i;
    buf[i] = (g >= 0 && g < lim) ? data[g] : 0;
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

// This tile's first output row: the live rows of every earlier tile.  A
// decoupled look-back by one warp over 32 predecessors a step; publishes
// the tile's aggregate first and its inclusive prefix last.  Warp-uniform
// call; the result is in every lane.
__device__ __forceinline__ uint32_t look_back(uint32_t* status, int tile,
                                              uint32_t total) {
  volatile uint32_t* st = status;
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) st[0] = kFlagPrefix | total;
    return 0;
  }
  if (lane == 0) st[tile] = kFlagAgg | total;
  uint32_t excl = 0;
  unsigned polls = 0;
  for (int last = tile - 1;; last -= 32) {
    // Lane k reads tile last - k; "before tile 0" reads as a prefix of 0.
    const int k = last - lane;
    uint32_t v = kFlagPrefix;
    if (k >= 0) v = st[k];
    while (__any_sync(0xffffffffu, (v >> 30) == 0)) {
      if (++polls > kMaxPolls) __trap();
      if ((v >> 30) == 0) v = st[k];
    }
    // Sum down to the nearest inclusive prefix (the lowest such lane).
    const unsigned pre = __ballot_sync(0xffffffffu, (v & kFlagPrefix) != 0);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    excl += __reduce_add_sync(0xffffffffu, lane <= stop ? v & kCountMask : 0u);
    if (pre) break;
  }
  if (lane == 0) st[tile] = kFlagPrefix | (excl + total);
  return excl;
}

// The dense stream.  `base` is the chunk's address rounded down to 16
// bytes and `mis` the chunk's offset from it: byte p of the chunk is at
// base + mis + p ("q-space" q = mis + p), and tile t covers q in
// [t * kTile, (t + 1) * kTile).  ticket and status are zeroed per launch.
__global__ void __launch_bounds__(kThreads, kTileBlocks)
tokenize_stream(const uint8_t* __restrict__ base, int mis, long long n, int w,
                int tiles, int64_t* __restrict__ khi,
                int64_t* __restrict__ klo, int64_t* __restrict__ packed,
                unsigned long long* __restrict__ counters,
                unsigned* __restrict__ ticket, uint32_t* __restrict__ status) {
  __shared__ uint4 buf4[kTileGroups];  // byte i: q = tile * kTile - halo + i
  __shared__ uint16_t pos[kTileRows];  // the tile's live rows by rank
  __shared__ int warp_tot[kWarps];
  __shared__ int sh_tile, sh_poison;
  __shared__ uint32_t sh_off;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    sh_tile = static_cast<int>(atomicAdd(ticket, 1u));
    sh_poison = 0;
  }
  __syncthreads();
  const int tile = sh_tile;

  // Load the tile and its halo, separators outside the chunk.
  const long long q_end = n + mis;
  const long long q0 = static_cast<long long>(tile) * kTile - kTileHalo;
  for (int g = threadIdx.x; g < kTileGroups; g += kThreads) {
    const long long q = q0 + 16LL * g;
    if (q >= mis && q + 16 <= q_end) {
      buf4[g] = *reinterpret_cast<const uint4*>(base + q);
    } else {
      uint32_t word[4] = {0u, 0u, 0u, 0u};
      for (int j = 0; j < 16; ++j)
        if (q + j >= mis && q + j < q_end)
          word[j >> 2] |= static_cast<uint32_t>(base[q + j]) << (8 * (j & 3));
      buf4[g] = make_uint4(word[0], word[1], word[2], word[3]);
    }
  }
  __syncthreads();

  // This thread's bytes: a token end is a non-separator followed by a
  // separator (bit kTilePer is the next thread's first byte).
  const uint8_t* buf = reinterpret_cast<const uint8_t*>(buf4);
  uint64_t sep = is_sep(buf[kTileHalo + kTilePer * (threadIdx.x + 1)])
                     ? 1ull << kTilePer : 0ull;
#pragma unroll
  for (int g = 0; g < kTilePer / 16; ++g) {
    const uint4 v = buf4[kTileHalo / 16 + kTilePer / 16 * threadIdx.x + g];
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (is_sep(static_cast<uint8_t>(words[j >> 2] >> (8 * (j & 3)))))
        sep |= 1ull << (16 * g + j);
  }
  const uint64_t live_bits = ~sep & (sep >> 1) & ((1ull << kTilePer) - 1ull);
  const int live = __popcll(live_bits);

  // The one block-wide pass: each thread's first rank and the tile total.
  int incl = live;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int rank = incl - live, total = 0;
  for (int k = 0; k < kWarps; ++k) {
    const int t = warp_tot[k];
    if (k < warp) rank += t;
    total += t;
  }

  for (uint64_t b = live_bits; b; b &= b - 1ull)
    pos[rank++] =
        static_cast<uint16_t>(kTilePer * threadIdx.x + __ffsll(b) - 1);
  if (warp == 0) {
    const uint32_t off = look_back(status, tile, static_cast<uint32_t>(total));
    if (lane == 0) sh_off = off;
  }
  __syncthreads();

  // Hash the rows in rank order and write each at offset + rank.
  const long long off = sh_off;
  const long long p0 = static_cast<long long>(tile) * kTile - mis;
  int n_poison = 0;
  for (int r = threadIdx.x; r < total; r += kThreads) {
    const int i = pos[r];
    const uint8_t* end = buf + kTileHalo + i;  // the row's last byte
    uint32_t h1 = 0, h2 = 0, pw1 = 1, pw2 = 1;
    int len = 0;
    // h = sum of (byte + 1) * base**k, k counted back from the end: the
    // forward polynomial hash in one backward pass.
    while (len < w && !is_sep(end[-len])) {
      const uint32_t c = static_cast<uint32_t>(end[-len]) + 1u;
      h1 += c * pw1;
      h2 += c * pw2;
      pw1 *= kBase1;
      pw2 *= kBase2;
      ++len;
    }
    const long long p = p0 + i;
    uint32_t hi, lo, pk;
    if (len == w && !is_sep(end[-w])) {  // the run is longer than W
      hi = kSent;
      lo = kSent - 1u;
      pk = static_cast<uint32_t>(p) << 6;
      ++n_poison;
    } else {
      const uint32_t ln = static_cast<uint32_t>(len);
      hi = fmix32(h1 ^ ln);
      lo = fmix32(h2 + 0x9E3779B9u * ln);
      if (hi == kSent && lo >= kSent - 1u) lo = kSent - 2u;
      pk = (static_cast<uint32_t>(p + 1 - len) << 6) | ln;
    }
    khi[off + r] = hi;
    klo[off + r] = lo;
    packed[off + r] = pk;
  }
  n_poison = __reduce_add_sync(0xffffffffu, n_poison);
  if (lane == 0 && n_poison) atomicAdd(&sh_poison, n_poison);
  __syncthreads();

  if (threadIdx.x == 0) {
    const int emit = total - sh_poison;
    if (sh_poison)
      atomicAdd(&counters[0], static_cast<unsigned long long>(sh_poison));
    if (emit) atomicAdd(&counters[1], static_cast<unsigned long long>(emit));
    if (tile == tiles - 1) {  // the tile that ends the chunk
      const long long live_rows = off + total;
      khi[live_rows] = kSent;
      klo[live_rows] = kSent;
      packed[live_rows] = 0xFFFFFFFFu;
      counters[3] = static_cast<unsigned long long>(live_rows);
    }
  }
}

__device__ __forceinline__ bool is_poison(uint32_t hi, uint32_t lo) {
  return hi == kSent && lo == kSent - 1u;  // emissions are clamped below it
}

// A window's head-list word: 0 until it publishes, then kHeadDone | the
// keys its segment cached up to it (fewer than C: a window that fills the
// list sets its segment's full flag instead).
constexpr uint32_t kHeadDone = 1u << 31;

// The combiner's one launch.  Windows are segment-major, so ticket order is
// global byte order.  The work words (ticket, status, heads, full) and the
// count plane c_cnt are zeroed per launch.
__global__ void __launch_bounds__(kThreads)
combiner_stream(const uint8_t* __restrict__ data, long long n,
                long long seg_len, int windows, int w, int slots, int cslots,
                int64_t* __restrict__ c_khi, int64_t* __restrict__ c_klo,
                int64_t* __restrict__ c_cnt, int64_t* __restrict__ c_pk,
                int64_t* __restrict__ khi, int64_t* __restrict__ klo,
                int64_t* __restrict__ packed,
                unsigned long long* __restrict__ counters,
                unsigned* __restrict__ ticket, uint32_t* __restrict__ status,
                uint32_t* __restrict__ heads, uint32_t* __restrict__ full) {
  __shared__ uint8_t buf[kBuf];
  __shared__ int warp_off[kWarps];
  __shared__ int row_total;
  __shared__ int scratch[kWarps];
  // The window's live rows by rank (ascending position).
  __shared__ uint32_t row_hi[kMaxRows], row_lo[kMaxRows], row_pk[kMaxRows];
  // The keys the segment cached up to this window, and their hits here.
  __shared__ uint32_t cache_hi[kMaxCache], cache_lo[kMaxCache];
  __shared__ int hits[kMaxCache];
  __shared__ int sh_win, sh_found;
  __shared__ uint32_t sh_off;

  if (threadIdx.x == 0) sh_win = static_cast<int>(atomicAdd(ticket, 1u));
  if (threadIdx.x < kMaxCache) hits[threadIdx.x] = 0;
  __syncthreads();
  const int wg = sh_win;
  const int seg = wg / windows, win = wg % windows;
  const long long seg0 = static_cast<long long>(seg) * seg_len;
  const long long base = seg0 + static_cast<long long>(win) * kWindow;
  load_window(buf, data, base, min(n, seg0 + seg_len + 1));
  __syncthreads();
  int live;
  const uint32_t live_bits = live_flags(buf, base, seg0 + seg_len, &live);
  int rank = block_scan(live, warp_off, &row_total);
  const int total = row_total;
  const int first = threadIdx.x * kPer;
  for (int j = 0; j < kPer; ++j) {
    if (!((live_bits >> j) & 1u)) continue;
    hash_row(buf, kHalo + first + j, base + first + j, w, &row_hi[rank],
             &row_lo[rank], &row_pk[rank]);
    ++rank;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    // The keys cached before this window.
    int found = 0;
    if (win > 0) {
      uint32_t v = 0;
      if (lane == 0) {
        volatile uint32_t* fl = full;
        volatile uint32_t* hs = heads;
        unsigned polls = 0;
        while (true) {
          if (fl[seg]) {
            v = kHeadDone | static_cast<uint32_t>(cslots);
            break;
          }
          v = hs[wg - 1];
          if (v) break;
          if (++polls > kMaxPolls) __trap();
        }
        __threadfence();
      }
      found = static_cast<int>(__shfl_sync(0xffffffffu, v, 0) & ~kHeadDone);
      if (lane < found) {  // from L2: the list was written by other CTAs
        const long long at = static_cast<long long>(lane) * kSegments + seg;
        cache_hi[lane] = static_cast<uint32_t>(__ldcg(c_khi + at));
        cache_lo[lane] = static_cast<uint32_t>(__ldcg(c_klo + at));
      }
      __syncwarp();
    }
    const int before = found;
    // This window's new emission keys, in rank order, 32 rows a step.
    for (int r0 = 0; r0 < total && found < cslots; r0 += 32) {
      const int r = r0 + lane;
      uint32_t hi = kSent, lo = kSent, pk = 0;
      bool fresh = false;
      if (r < total) {
        hi = row_hi[r];
        lo = row_lo[r];
        pk = row_pk[r];
        fresh = !is_poison(hi, lo);
      }
      for (int c = 0; c < found; ++c)
        if (cache_hi[c] == hi && cache_lo[c] == lo) fresh = false;
      // Only the lowest lane of a key new to the list adopts it.
      const unsigned long long key =
          fresh ? (static_cast<unsigned long long>(hi) << 32 | lo) : ~0ull;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      fresh = fresh && lane == __ffs(peers) - 1;
      const unsigned adopt = __ballot_sync(0xffffffffu, fresh);
      const int at = found + __popc(adopt & ((1u << lane) - 1u));
      __syncwarp();
      if (fresh && at < cslots) {
        cache_hi[at] = hi;
        cache_lo[at] = lo;
        const long long g = static_cast<long long>(at) * kSegments + seg;
        c_khi[g] = hi;
        c_klo[g] = lo;
        c_pk[g] = pk;
      }
      __syncwarp();
      found = min(cslots, found + __popc(adopt));
    }
    if (win == windows - 1) {  // the segment's last window: empty slots
      for (int c = found + lane; c < cslots; c += 32) {
        const long long g = static_cast<long long>(c) * kSegments + seg;
        c_khi[g] = kSent;
        c_klo[g] = kSent;
        c_pk[g] = 0xFFFFFFFFu;
      }
    } else if (before < cslots) {  // publish the list for the next window
      __threadfence();
      __syncwarp();
      if (lane == 0) {
        if (found == cslots) {
          volatile uint32_t* fl = full;
          fl[seg] = 1u;
        } else {
          volatile uint32_t* hs = heads;
          hs[wg] = kHeadDone | static_cast<uint32_t>(found);
        }
      }
    }
    if (lane == 0) sh_found = found;
  }
  __syncthreads();

  // Which of this thread's ranks stay: poison rows and emissions of
  // uncached keys.  Hits count once per (warp, slot) in each step.
  const int found = sh_found;
  const int r0 = threadIdx.x * kRowsPer;
  uint32_t keep_bits = 0;
  int keep = 0, n_over = 0, n_emit = 0;
  for (int j = 0; j < kRowsPer; ++j) {
    const bool in = r0 + j < total;
    uint32_t hi = 0, lo = 0;
    int slot = -1;
    if (in) {
      hi = row_hi[r0 + j];
      lo = row_lo[r0 + j];
      if (!is_poison(hi, lo))
        for (int c = 0; c < found; ++c)
          if (cache_hi[c] == hi && cache_lo[c] == lo) {
            slot = c;
            break;
          }
    }
    if (__ballot_sync(0xffffffffu, slot >= 0)) {
      const unsigned peers = __match_any_sync(0xffffffffu, slot);
      if (slot >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hits[slot], __popc(peers));
    }
    if (in && slot < 0) {
      keep_bits |= 1u << j;
      ++keep;
      if (is_poison(hi, lo)) ++n_over; else ++n_emit;
    }
  }

  // The window's kept rows, in rank order, at the look-back's offset.
  int at = block_scan(keep, warp_off, &row_total);
  const int kept = row_total;
  if (warp == 0) {
    const uint32_t off = look_back(status, wg, static_cast<uint32_t>(kept));
    if (lane == 0) sh_off = off;
  }
  __syncthreads();
  const long long out0 = sh_off;
  for (int j = 0; j < kRowsPer; ++j) {
    if (!((keep_bits >> j) & 1u)) continue;
    put_row(khi, klo, packed, out0 + at, row_hi[r0 + j], row_lo[r0 + j],
            row_pk[r0 + j]);
    ++at;
  }

  const int over_sum = block_sum(n_over, scratch);  // also orders the hits
  const int emit_sum = block_sum(n_emit, scratch);
  for (int c = threadIdx.x; c < found; c += kThreads)
    if (hits[c])
      atomicAdd(reinterpret_cast<unsigned long long*>(
                    &c_cnt[static_cast<long long>(c) * kSegments + seg]),
                static_cast<unsigned long long>(hits[c]));
  if (threadIdx.x == 0) {
    if (over_sum)
      atomicAdd(&counters[0], static_cast<unsigned long long>(over_sum));
    if (emit_sum)
      atomicAdd(&counters[1], static_cast<unsigned long long>(emit_sum));
    if (kept > slots)
      atomicAdd(&counters[2], static_cast<unsigned long long>(kept - slots));
    if (wg == static_cast<int>(gridDim.x) - 1) {  // the chunk's last window
      const long long live_rows = out0 + kept;
      put_row(khi, klo, packed, live_rows, kSent, kSent, 0xFFFFFFFFu);
      counters[3] = static_cast<unsigned long long>(live_rows);
    }
  }
}

// -- the fold of the flushed cache into the chunk's table ---------------
//
// The table: int64 planes of `cap` rows holding uint32 words, its live
// rows first in ascending (key_hi, key_lo), then holes (key (sent, sent),
// count 0), as every table build leaves it.  The cache: its four planes of
// `entries` = C * 128 rows.  Scratch: int64 words: the fold counters
// (zeroed by the launcher), then for each unique cache key (entries + 1
// of each) its key, its first packed << 32 | its count, and two int32
// words: its table lower bound and the new keys before it.

constexpr int kFoldCounters = 8;  // unique, new, live, dropped count, done
constexpr int kFoldEntries = kMaxCache * kSegments;  // the largest cache
constexpr unsigned long long kKeySent = ~0ull;  // (sent, sent)

__device__ __forceinline__ unsigned long long key_of(const int64_t* hi,
                                                     const int64_t* lo,
                                                     long long i) {
  return static_cast<unsigned long long>(hi[i]) << 32 |
         static_cast<unsigned long long>(lo[i]);
}

// First index in [0, n) whose key is >= k (keys ascending).
__device__ __forceinline__ long long lower_bound_key(const int64_t* hi,
                                                     const int64_t* lo,
                                                     long long n,
                                                     unsigned long long k) {
  long long a = 0, b = n;
  while (a < b) {
    const long long m = (a + b) >> 1;
    if (key_of(hi, lo, m) < k) a = m + 1; else b = m;
  }
  return a;
}

__device__ __forceinline__ long long lower_bound_u64(
    const unsigned long long* keys, long long n, unsigned long long k) {
  long long a = 0, b = n;
  while (a < b) {
    const long long m = (a + b) >> 1;
    if (keys[m] < k) a = m + 1; else b = m;
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
combiner_fold_keys(const int64_t* __restrict__ c_khi,
                   const int64_t* __restrict__ c_klo,
                   const int64_t* __restrict__ c_cnt,
                   const int64_t* __restrict__ c_pk, int entries, int sort_n,
                   const int64_t* __restrict__ t_khi,
                   const int64_t* __restrict__ t_klo, long long cap,
                   long long* __restrict__ fold) {
  // The cache's keys and their entry indices, sorted here (sort_n, a
  // power of two >= entries, of each).
  __shared__ unsigned long long s_key[kFoldEntries];
  __shared__ uint16_t s_idx[kFoldEntries];
  __shared__ int warp_off[kWarps];
  __shared__ int total;
  __shared__ long long sh_live;
  long long* counters = fold;
  auto* ukey = reinterpret_cast<unsigned long long*>(fold + kFoldCounters);
  unsigned long long* uval = ukey + entries + 1;
  auto* ulb = reinterpret_cast<int*>(uval + entries + 1);
  int* unew = ulb + entries + 1;

  for (int i = threadIdx.x; i < sort_n; i += kThreads) {
    const bool live = i < entries && c_cnt[i] > 0;
    s_key[i] = live ? key_of(c_khi, c_klo, i) : kKeySent;
    s_idx[i] = static_cast<uint16_t>(i < entries ? i : 0);
  }
  if (threadIdx.x == 0) sh_live = lower_bound_key(t_khi, t_klo, cap, kKeySent);
  __syncthreads();
  // Bitonic sort by key (ties in any order: a run is coalesced whole).
  for (int k = 2; k <= sort_n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < sort_n; i += kThreads) {
        const int l = i ^ j;
        if (l <= i) continue;
        if ((s_key[i] > s_key[l]) == ((i & k) == 0)) {
          const unsigned long long tk = s_key[i];
          const uint16_t ti = s_idx[i];
          s_key[i] = s_key[l];
          s_idx[i] = s_idx[l];
          s_key[l] = tk;
          s_idx[l] = ti;
        }
      }
      __syncthreads();
    }
  }
  // Coalesce: the first entry of each key leads its run; counts add and
  // the smallest packed (the first occurrence) wins.  Each thread owns a
  // contiguous slice of sort_n / kThreads entries.
  const int per = (sort_n + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per, hi = min(sort_n, lo + per);
  int heads = 0;
  for (int i = lo; i < hi; ++i)
    heads += s_key[i] != kKeySent && (i == 0 || s_key[i - 1] != s_key[i]);
  int u = block_scan(heads, warp_off, &total);
  const long long live = sh_live;
  for (int i = lo; i < hi; ++i) {
    const unsigned long long k = s_key[i];
    if (k == kKeySent || (i > 0 && s_key[i - 1] == k)) continue;
    unsigned long long sum = 0, pk = ~0ull;
    for (int j = i; j < sort_n && s_key[j] == k; ++j) {
      sum += static_cast<unsigned long long>(c_cnt[s_idx[j]]);
      pk = min(pk, static_cast<unsigned long long>(c_pk[s_idx[j]]));
    }
    const long long lb = lower_bound_key(t_khi, t_klo, live, k);
    ukey[u] = k;
    uval[u] = pk << 32 | sum;
    // The table's lower bound, negative (-1 - lb) when the table holds the
    // key.
    ulb[u] = static_cast<int>(
        lb < live && key_of(t_khi, t_klo, lb) == k ? -1 - lb : lb);
    ++u;
  }
  __syncthreads();
  const int n_unique = total;
  // Prefix of the keys the table does not hold.
  int fresh = 0;
  const int uper = (n_unique + kThreads - 1) / kThreads;
  const int ulo = threadIdx.x * uper, uhi = min(n_unique, ulo + uper);
  for (int i = ulo; i < uhi; ++i) fresh += ulb[i] >= 0;
  int before = block_scan(fresh, warp_off, &total);
  for (int i = ulo; i < uhi; ++i) {
    unew[i] = before;
    before += ulb[i] >= 0;
  }
  if (threadIdx.x == 0) {
    unew[n_unique] = total;
    counters[0] = n_unique;
    counters[1] = total;
    counters[2] = live;
  }
}

__device__ __forceinline__ void put_table_row(
    int64_t* const* out, long long at, unsigned long long key, long long cnt,
    long long pos_hi, long long pos_lo, long long len) {
  out[0][at] = static_cast<long long>(key >> 32);
  out[1][at] = static_cast<long long>(key & 0xFFFFFFFFull);
  out[2][at] = cnt & 0xFFFFFFFFll;
  out[3][at] = cnt >> 32;
  out[4][at] = pos_hi;
  out[5][at] = pos_lo;
  out[6][at] = len;
}

struct TablePlanes {
  int64_t* p[7];  // key_hi, key_lo, count, count_hi, pos_hi, pos_lo, length
};

__global__ void __launch_bounds__(kThreads)
combiner_fold_merge(const TablePlanes t_in, const int64_t* __restrict__ t_drop,
                    long long cap, int entries,
                    const int64_t* __restrict__ chunk_id, long long chunk_val,
                    long long* __restrict__ fold, TablePlanes t_out,
                    int64_t* __restrict__ out_drop) {
  __shared__ long long sh_dropped;
  __shared__ bool sh_last;
  long long* counters = fold;
  const auto* ukey =
      reinterpret_cast<const unsigned long long*>(fold + kFoldCounters);
  const unsigned long long* uval = ukey + entries + 1;
  const auto* ulb = reinterpret_cast<const int*>(uval + entries + 1);
  const int* unew = ulb + entries + 1;
  const long long n_unique = counters[0], n_new = counters[1],
                  live = counters[2];
  const long long pos_hi = chunk_id ? *chunk_id : chunk_val;
  if (threadIdx.x == 0) sh_dropped = 0;
  __syncthreads();

  const long long g = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  long long dropped = 0;
  if (g < cap) {
    if (g < live) {  // a table row, moved up by the new keys before it
      const unsigned long long k = key_of(t_in.p[0], t_in.p[1], g);
      const long long m = lower_bound_u64(ukey, n_unique, k);
      const long long at = g + unew[m];
      long long cnt = t_in.p[2][g] + (t_in.p[3][g] << 32);
      long long ph = t_in.p[4][g], pl = t_in.p[5][g], len = t_in.p[6][g];
      if (m < n_unique && ukey[m] == k) {
        cnt += static_cast<long long>(uval[m] & 0xFFFFFFFFull);
        const unsigned long long cp = uval[m] >> 32;
        const long long cpl = static_cast<long long>(cp >> 6);
        if (pos_hi < ph || (pos_hi == ph && cpl < pl)) {
          ph = pos_hi;
          pl = cpl;
          len = static_cast<long long>(cp & 63);
        }
      }
      if (at < cap) put_table_row(t_out.p, at, k, cnt, ph, pl, len);
      else dropped += cnt;
    }
    if (g >= live + n_new)  // holes after the union
      put_table_row(t_out.p, g, kKeySent, 0, 0xFFFFFFFFll, 0xFFFFFFFFll, 0);
  } else if (g < cap + n_unique) {  // a key the table does not hold
    const long long u = g - cap;
    if (ulb[u] >= 0) {
      const long long at = static_cast<long long>(ulb[u]) + unew[u];
      const unsigned long long cp = uval[u] >> 32;
      const long long cnt = static_cast<long long>(uval[u] & 0xFFFFFFFFull);
      if (at < cap)
        put_table_row(t_out.p, at, ukey[u], cnt, pos_hi,
                      static_cast<long long>(cp >> 6),
                      static_cast<long long>(cp & 63));
      else
        dropped += cnt;
    }
  }
  if (dropped) atomicAdd(reinterpret_cast<unsigned long long*>(&sh_dropped),
                         static_cast<unsigned long long>(dropped));
  __syncthreads();
  if (threadIdx.x == 0) {
    if (sh_dropped)
      atomicAdd(reinterpret_cast<unsigned long long*>(&counters[3]),
                static_cast<unsigned long long>(sh_dropped));
    __threadfence();
    const unsigned done = atomicAdd(
        reinterpret_cast<unsigned*>(&counters[4]), 1u);
    sh_last = done == gridDim.x - 1;
  }
  __syncthreads();
  if (sh_last && threadIdx.x == 0) {  // the last CTA: the dropped totals
    __threadfence();
    const long long spilled = live + n_new - cap;
    const long long du = t_drop[0] + (t_drop[2] << 32) +
                         (spilled > 0 ? spilled : 0);
    const long long dc = t_drop[1] + (t_drop[3] << 32) +
                         atomicAdd(reinterpret_cast<unsigned long long*>(
                                       &counters[3]), 0ull);
    out_drop[0] = du & 0xFFFFFFFFll;
    out_drop[1] = dc & 0xFFFFFFFFll;
    out_drop[2] = du >> 32;
    out_drop[3] = dc >> 32;
  }
}

bool bad_combiner(long long n, int w, int cslots) {
  return n <= 0 || n % kSegments || w < 1 || w > kMaxW || cslots < 1 ||
         cslots > kMaxCache;
}

int combiner_windows(long long n) {
  return static_cast<int>((n / kSegments + kWindow - 1) / kWindow);
}

}  // namespace

// The dense stream of a chunk of n bytes on `stream`.  Outputs: int64
// planes of at least ceil(n / 2) + 1 rows, holding uint32 words; rows up to
// the live count and the dead row after it are written, nothing else.
// Tiles: ceil((n + data % 16) / kTile).  work: int64 [4 + (tiles + 2) / 2],
// zeroed here once a call: the counters (overlong, tokens, spill = 0,
// live), then the uint32 ticket and the tiles' look-back status.  Returns
// cudaGetLastError() after the launch.
extern "C" int mr_tokenize_stream(const void* data, long long n, int w,
                                  void* khi, void* klo, void* packed,
                                  void* work, long long work_words,
                                  void* stream) {
  if (n <= 0 || n > (1LL << 26) || w < 1 || w > kMaxW)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(data) & 15u);
  const long long tiles = (n + mis + kTile - 1) / kTile;
  if (work_words < 4 + (tiles + 2) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* counters = static_cast<unsigned long long*>(work);
  auto* ticket = reinterpret_cast<unsigned*>(counters + 4);
  cudaError_t e = cudaMemsetAsync(work, 0, 8 * work_words,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  tokenize_stream<<<static_cast<unsigned>(tiles), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data) - mis, mis, n, w,
      static_cast<int>(tiles), static_cast<int64_t*>(khi),
      static_cast<int64_t*>(klo), static_cast<int64_t*>(packed), counters,
      ticket, ticket + 1);
  return static_cast<int>(cudaGetLastError());
}

// The combiner over a chunk of n = 128 * seg_len bytes in one launch on
// `stream`.  Windows: 128 * mr_combiner_windows(n), segment-major.  Cache
// planes: int64 (cslots, 128); the count plane is zeroed here.  Stream
// planes: int64 of at least ceil(n / 2) + 1 rows, the dense stream
// (tokenize_stream's layout).  work: int64 [mr_combiner_work_words(n)],
// zeroed here once a call: the counters (overlong, tokens, spill, live),
// then uint32 words: the ticket, the windows' look-back status, their
// head-list words and each segment's full flag.  Returns
// cudaGetLastError() after the launch.
extern "C" int mr_combiner_windows(long long n) { return combiner_windows(n); }

extern "C" long long mr_combiner_work_words(long long n) {
  const long long windows = static_cast<long long>(kSegments) *
                            combiner_windows(n);
  return 4 + (1 + 2 * windows + kSegments + 1) / 2;
}

extern "C" int mr_combiner_stream(const void* data, long long n, int w,
                                  int slots, int cslots, void* c_khi,
                                  void* c_klo, void* c_cnt, void* c_pk,
                                  void* khi, void* klo, void* packed,
                                  void* work, long long work_words,
                                  void* stream) {
  if (bad_combiner(n, w, cslots) || n > (1LL << 26) || slots < 1 ||
      slots > kWindow || work_words < mr_combiner_work_words(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const int windows = combiner_windows(n);
  const long long blocks = static_cast<long long>(kSegments) * windows;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(work, 0, 8 * work_words, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(c_cnt, 0, 8LL * cslots * kSegments, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* counters = static_cast<unsigned long long*>(work);
  auto* ticket = reinterpret_cast<unsigned*>(counters + 4);
  uint32_t* status = ticket + 1;
  combiner_stream<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(data), n, n / kSegments, windows, w, slots,
      cslots, static_cast<int64_t*>(c_khi), static_cast<int64_t*>(c_klo),
      static_cast<int64_t*>(c_cnt), static_cast<int64_t*>(c_pk),
      static_cast<int64_t*>(khi), static_cast<int64_t*>(klo),
      static_cast<int64_t*>(packed), counters, ticket, status,
      status + blocks, status + 2 * blocks);
  return static_cast<int>(cudaGetLastError());
}

// The fold of a flushed cache of `entries` rows into a table of `cap`
// rows, in two launches on `stream`.  t_in/t_out: the seven planes each
// (key_hi, key_lo, count, count_hi, pos_hi, pos_lo, length); t_drop /
// out_drop: int64 [4] (dropped_uniques, dropped_count, their high words).
// chunk_id: a device int64 chunk id, or null for chunk_val.  fold: int64
// scratch of mr_combiner_fold_words(entries) words; its counters (which
// hold the merge's done ticket) are zeroed here once a call.
extern "C" long long mr_combiner_fold_words(int entries) {
  return kFoldCounters + 3LL * (entries + 1);
}

extern "C" int mr_combiner_fold(const void* c_khi, const void* c_klo,
                                const void* c_cnt, const void* c_pk,
                                int entries, void* const* t_in,
                                const void* t_drop, long long cap,
                                const void* chunk_id, long long chunk_val,
                                void* fold, long long fold_words,
                                void* const* t_out, void* out_drop,
                                void* stream) {
  if (entries < 1 || entries > kFoldEntries || cap < 1 ||
      fold_words < mr_combiner_fold_words(entries))
    return static_cast<int>(cudaErrorInvalidValue);
  int sort_n = 1;
  while (sort_n < entries) sort_n <<= 1;
  TablePlanes in, out;
  for (int i = 0; i < 7; ++i) {
    in.p[i] = static_cast<int64_t*>(t_in[i]);
    out.p[i] = static_cast<int64_t*>(t_out[i]);
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(fold, 0, 8 * kFoldCounters, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  combiner_fold_keys<<<1, kThreads, 0, s>>>(
      static_cast<const int64_t*>(c_khi), static_cast<const int64_t*>(c_klo),
      static_cast<const int64_t*>(c_cnt), static_cast<const int64_t*>(c_pk),
      entries, sort_n, in.p[0], in.p[1], cap, static_cast<long long*>(fold));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long grid = (cap + entries + kThreads - 1) / kThreads;
  combiner_fold_merge<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      in, static_cast<const int64_t*>(t_drop), cap, entries,
      static_cast<const int64_t*>(chunk_id), chunk_val,
      static_cast<long long*>(fold), out, static_cast<int64_t*>(out_drop));
  return static_cast<int>(cudaGetLastError());
}

// Bytes per combiner window and per stream tile, so the Python side can
// check its copies.
extern "C" int mr_tokenize_window_bytes() { return kWindow; }

extern "C" int mr_tokenize_tile_bytes() { return kTile; }

// What the static analysis asks the card of each kernel (analysis/
// kernel_info.py): its name, and for kernel i, out[0..5] = static shared
// bytes, registers, local bytes, max threads per block, constant bytes,
// and active blocks an SM at its launch block size.  Returns a CUDA error.
namespace {
struct KernelEntry {
  const char* name;
  const void* fn;
  int threads;
};
const KernelEntry kKernels[] = {
    {"tokenize_stream", reinterpret_cast<const void*>(&tokenize_stream),
     kThreads},
    {"combiner_stream", reinterpret_cast<const void*>(&combiner_stream),
     kThreads},
    {"combiner_fold_keys", reinterpret_cast<const void*>(&combiner_fold_keys),
     kThreads},
    {"combiner_fold_merge",
     reinterpret_cast<const void*>(&combiner_fold_merge), kThreads},
};
constexpr int kKernelCount = sizeof(kKernels) / sizeof(kKernels[0]);
}  // namespace

extern "C" int mr_tokenize_kernel_count() { return kKernelCount; }

extern "C" const char* mr_tokenize_kernel_name(int i) {
  return i >= 0 && i < kKernelCount ? kKernels[i].name : nullptr;
}

extern "C" int mr_tokenize_kernel_attrs(int i, long long* out) {
  if (i < 0 || i >= kKernelCount || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kKernels[i].fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kKernels[i].fn,
                                                    kKernels[i].threads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = static_cast<long long>(a.sharedSizeBytes);
  out[1] = a.numRegs;
  out[2] = static_cast<long long>(a.localSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  out[4] = static_cast<long long>(a.constSizeBytes);
  out[5] = blocks;
  return 0;
}
