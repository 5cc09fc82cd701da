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
// its own helpers; it shares only is_sep and fmix32 with tokenize_stream.
// The chunk splits into 128 segments of seg_len bytes (the TPU kernel's
// lanes); a token belongs to the segment that holds its end byte, and each
// segment is cut into windows, the last one short.  The cache of a segment
// is its first C distinct keys: their every occurrence is counted there and
// left out of the stream, and the first occurrence's `packed` is kept.
// Poison rows are never cached.  Rows left in each window are compacted,
// in ascending position, into its `slots` rows, laid out
// [segment][window][slot] (global byte order), with dead filler after them
// and the rows past `slots` counted as spill; the cache is flushed as four
// (C, 128) planes.  Exactness never depends on the cache: a spill sends the
// caller to the combiner-free dense stream.  Three launches, two of them
// one CTA per window:
//
//   combiner_heads  hashes its window, keeps its ranked rows in a scratch
//                   (12 B a row) and writes the window's first C distinct
//                   emission keys in rank order, each with its first
//                   `packed` (one warp walks the ranked rows);
//   combiner_merge  one warp per segment walks its windows' short lists in
//                   window order and keeps the first C distinct keys: the
//                   cache's key and `packed` planes, counts zeroed;
//   combiner_thin   reads its window's rows back from the scratch, drops
//                   every emission whose key is cached (warp-aggregated hit
//                   counts, then one atomic per slot per CTA into the count
//                   plane) and compacts the rest.
//
// Exact because a key among a segment's first C distinct keys is among the
// first C distinct keys of the window where it first appears: fewer than C
// distinct keys of that window precede it there, each an earlier key of
// the segment.
//
// Each uint32 word is stored zero-extended into an int64 element, the form
// in which the PyTorch side carries uint32 (torch has no uint32 shifts or
// sorts), so no widening pass follows a kernel.
//
// Bound on this card: device-memory bytes.  A kernel reads the chunk's N
// bytes and writes 24 bytes per output row: tokenize_stream live + 1 rows.
// Each input byte is read from device memory once (plus an 80-byte halo
// per 8192-byte tile) and every lookback is served from shared memory.
// The combiner hashes each byte once, writes and reads back 12 B a live
// row in its scratch, and writes only the rows it leaves.
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
constexpr int kRowsPer = kMaxRows / kThreads;  // scratch rows per thread
constexpr int kMaxCache = 32;              // combiner slots per segment
constexpr int kSegments = 128;             // combiner segments per chunk
constexpr int kMergeWarps = 4;             // segments per merge CTA
constexpr uint32_t kSent = 0xFFFFFFFFu;
constexpr uint32_t kBase1 = 16777619u;     // constants.HASH_BASE_1
constexpr uint32_t kBase2 = 2654435761u;   // constants.HASH_BASE_2

static_assert(kWindow % kThreads == 0, "window must split evenly");
static_assert(kPer <= 32, "live flags of a thread fit one word");
static_assert(kMaxCache <= 32, "a warp holds one cache slot per lane");
static_assert(kSegments % kMergeWarps == 0, "merge CTAs split evenly");
static_assert(kMaxRows % kThreads == 0, "scratch rows split evenly");

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

__global__ void __launch_bounds__(kThreads)
combiner_heads(const uint8_t* __restrict__ data, long long n,
               long long seg_len, int windows, int w, int cslots,
               int64_t* __restrict__ h_hi, int64_t* __restrict__ h_lo,
               int64_t* __restrict__ h_pk, int* __restrict__ h_n,
               uint32_t* __restrict__ rows, int* __restrict__ rows_n) {
  __shared__ uint8_t buf[kBuf];
  __shared__ int warp_off[kWarps];
  __shared__ int row_total;
  // The window's live rows by rank (ascending position).
  __shared__ uint32_t row_hi[kMaxRows], row_lo[kMaxRows], row_pk[kMaxRows];
  // Its first distinct emission keys, in rank order.
  __shared__ uint32_t head_hi[kMaxCache], head_lo[kMaxCache],
      head_pk[kMaxCache];

  // CTA blockIdx.x is window `win` of segment `seg`; windows are cut at
  // segment ends.
  const int seg = blockIdx.x / windows, win = blockIdx.x % windows;
  const long long seg0 = static_cast<long long>(seg) * seg_len;
  const long long base = seg0 + static_cast<long long>(win) * kWindow;
  const long long seg_end = seg0 + seg_len;
  load_window(buf, data, base, n);
  __syncthreads();
  int live;
  const uint32_t live_bits = live_flags(buf, base, seg_end, &live);
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
  // The ranked rows for combiner_thin, [window][plane][rank].
  uint32_t* out = rows + static_cast<long long>(blockIdx.x) * 3 * kMaxRows;
  for (int r = threadIdx.x; r < total; r += kThreads) {
    out[r] = row_hi[r];
    out[kMaxRows + r] = row_lo[r];
    out[2 * kMaxRows + r] = row_pk[r];
  }
  if (threadIdx.x == 0) rows_n[blockIdx.x] = total;
  if (threadIdx.x >= 32) return;  // warp 0 walks the rows, 32 at a time

  const int lane = threadIdx.x;
  int found = 0;  // the same in every lane
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
      if (head_hi[c] == hi && head_lo[c] == lo) fresh = false;
    // Only the lowest lane of a key new to the window adopts it.
    const unsigned long long key =
        fresh ? (static_cast<unsigned long long>(hi) << 32 | lo) : ~0ull;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    fresh = fresh && lane == __ffs(peers) - 1;
    const unsigned adopt = __ballot_sync(0xffffffffu, fresh);
    const int at = found + __popc(adopt & ((1u << lane) - 1u));
    __syncwarp();
    if (fresh && at < cslots) {
      head_hi[at] = hi;
      head_lo[at] = lo;
      head_pk[at] = pk;
    }
    __syncwarp();
    found = min(cslots, found + __popc(adopt));
  }
  const long long out0 = static_cast<long long>(blockIdx.x) * cslots;
  if (lane < cslots) {
    const bool full = lane < found;
    h_hi[out0 + lane] = full ? head_hi[lane] : kSent;
    h_lo[out0 + lane] = full ? head_lo[lane] : kSent;
    h_pk[out0 + lane] = full ? head_pk[lane] : 0xFFFFFFFFu;
  }
  if (lane == 0) h_n[blockIdx.x] = found;
}

__global__ void __launch_bounds__(kMergeWarps * 32)
combiner_merge(const int64_t* __restrict__ h_hi,
               const int64_t* __restrict__ h_lo,
               const int64_t* __restrict__ h_pk, const int* __restrict__ h_n,
               int windows, int cslots, int64_t* __restrict__ c_khi,
               int64_t* __restrict__ c_klo, int64_t* __restrict__ c_cnt,
               int64_t* __restrict__ c_pk) {
  __shared__ uint32_t s_hi[kMergeWarps][kMaxCache],
      s_lo[kMergeWarps][kMaxCache], s_pk[kMergeWarps][kMaxCache];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kMergeWarps + warp;
  int found = 0;  // the same in every lane of the warp
  for (int win = 0; win < windows && found < cslots; ++win) {
    const long long wi = static_cast<long long>(seg) * windows + win;
    const int m = h_n[wi];
    uint32_t hi = 0, lo = 0, pk = 0;
    bool fresh = lane < m;
    if (fresh) {
      hi = static_cast<uint32_t>(h_hi[wi * cslots + lane]);
      lo = static_cast<uint32_t>(h_lo[wi * cslots + lane]);
      pk = static_cast<uint32_t>(h_pk[wi * cslots + lane]);
      for (int c = 0; c < found; ++c)
        if (s_hi[warp][c] == hi && s_lo[warp][c] == lo) fresh = false;
    }
    // A window's list holds distinct keys: its new ones append in order.
    const unsigned adopt = __ballot_sync(0xffffffffu, fresh);
    const int at = found + __popc(adopt & ((1u << lane) - 1u));
    __syncwarp();
    if (fresh && at < cslots) {
      s_hi[warp][at] = hi;
      s_lo[warp][at] = lo;
      s_pk[warp][at] = pk;
    }
    __syncwarp();
    found = min(cslots, found + __popc(adopt));
  }
  for (int c = lane; c < cslots; c += 32) {
    const long long at = static_cast<long long>(c) * kSegments + seg;
    const bool full = c < found;
    c_khi[at] = full ? s_hi[warp][c] : kSent;
    c_klo[at] = full ? s_lo[warp][c] : kSent;
    c_cnt[at] = 0;
    c_pk[at] = full ? s_pk[warp][c] : 0xFFFFFFFFu;
  }
}

__global__ void __launch_bounds__(kThreads)
combiner_thin(const uint32_t* __restrict__ rows,
              const int* __restrict__ rows_n, int slots, int cslots,
              const int64_t* __restrict__ c_khi,
              const int64_t* __restrict__ c_klo, int64_t* __restrict__ c_cnt,
              int64_t* __restrict__ khi, int64_t* __restrict__ klo,
              int64_t* __restrict__ packed,
              unsigned long long* __restrict__ counters) {
  __shared__ int warp_off[kWarps];
  __shared__ int row_total;
  __shared__ int scratch[kWarps];
  __shared__ uint32_t cache_hi[kMaxCache], cache_lo[kMaxCache];
  __shared__ int hits[kMaxCache];

  const int seg = blockIdx.x / (gridDim.x / kSegments);
  for (int c = threadIdx.x; c < cslots; c += kThreads) {
    const long long at = static_cast<long long>(c) * kSegments + seg;
    cache_hi[c] = static_cast<uint32_t>(c_khi[at]);
    cache_lo[c] = static_cast<uint32_t>(c_klo[at]);
    hits[c] = 0;
  }
  __syncthreads();

  // Which of this thread's ranks stay: poison rows and emissions of
  // uncached keys.  Hits count once per (warp, slot) in each step.
  const uint32_t* in = rows + static_cast<long long>(blockIdx.x) * 3 * kMaxRows;
  const int total = rows_n[blockIdx.x];
  const int r0 = threadIdx.x * kRowsPer;
  const int lane = threadIdx.x & 31;
  uint32_t keep_bits = 0;
  int keep = 0, n_over = 0, n_emit = 0;
  for (int j = 0; j < kRowsPer; ++j) {
    const bool live = r0 + j < total;
    uint32_t hi = 0, lo = 0;
    int slot = -1;
    if (live) {
      hi = in[r0 + j];
      lo = in[kMaxRows + r0 + j];
      if (!is_poison(hi, lo))
        for (int c = 0; c < cslots; ++c)
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
    if (live && slot < 0) {
      keep_bits |= 1u << j;
      ++keep;
      if (is_poison(hi, lo)) ++n_over; else ++n_emit;
    }
  }

  // Compact the rows left into the window's slots, in rank order.
  int at = block_scan(keep, warp_off, &row_total);
  const int kept = row_total;
  const long long out0 = static_cast<long long>(blockIdx.x) * slots;
  for (int j = 0; j < kRowsPer; ++j) {
    if (!((keep_bits >> j) & 1u)) continue;
    if (at < slots)
      put_row(khi, klo, packed, out0 + at, in[r0 + j], in[kMaxRows + r0 + j],
              in[2 * kMaxRows + r0 + j]);
    ++at;
  }
  fill_dead(khi, klo, packed, out0, min(kept, slots), slots);

  const int over_sum = block_sum(n_over, scratch);  // also orders the hits
  const int emit_sum = block_sum(n_emit, scratch);
  for (int c = threadIdx.x; c < cslots; c += kThreads)
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
// zeroed by the caller: the counters (overlong, tokens, spill = 0, live),
// then the uint32 ticket and the tiles' look-back status.  Returns
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
  tokenize_stream<<<static_cast<unsigned>(tiles), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data) - mis, mis, n, w,
      static_cast<int>(tiles), static_cast<int64_t*>(khi),
      static_cast<int64_t*>(klo), static_cast<int64_t*>(packed), counters,
      ticket, ticket + 1);
  return static_cast<int>(cudaGetLastError());
}

// The combiner over a chunk of n = 128 * seg_len bytes, in three launches
// on `stream`, each returning cudaGetLastError().  Windows: 128 *
// mr_combiner_windows(n), segment-major.  Heads: int64 planes of windows *
// cslots rows and an int32 count per window.  Row scratch: uint32
// [windows][3][mr_combiner_window_rows()] and an int32 count per window.
extern "C" int mr_combiner_windows(long long n) { return combiner_windows(n); }

extern "C" int mr_combiner_window_rows() { return kMaxRows; }

extern "C" int mr_combiner_heads(const void* data, long long n, int w,
                                 int cslots, void* h_hi, void* h_lo,
                                 void* h_pk, void* h_n, void* rows,
                                 void* rows_n, void* stream) {
  if (bad_combiner(n, w, cslots) || !rows || !rows_n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int windows = combiner_windows(n);
  combiner_heads<<<kSegments * windows, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, n / kSegments, windows, w, cslots,
      static_cast<int64_t*>(h_hi), static_cast<int64_t*>(h_lo),
      static_cast<int64_t*>(h_pk), static_cast<int*>(h_n),
      static_cast<uint32_t*>(rows), static_cast<int*>(rows_n));
  return static_cast<int>(cudaGetLastError());
}

// Cache planes: int64 (cslots, 128); counts zeroed here.
extern "C" int mr_combiner_merge(long long n, int cslots, const void* h_hi,
                                 const void* h_lo, const void* h_pk,
                                 const void* h_n, void* c_khi, void* c_klo,
                                 void* c_cnt, void* c_pk, void* stream) {
  if (bad_combiner(n, 1, cslots))
    return static_cast<int>(cudaErrorInvalidValue);
  combiner_merge<<<kSegments / kMergeWarps, kMergeWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(h_hi), static_cast<const int64_t*>(h_lo),
      static_cast<const int64_t*>(h_pk), static_cast<const int*>(h_n),
      combiner_windows(n), cslots, static_cast<int64_t*>(c_khi),
      static_cast<int64_t*>(c_klo), static_cast<int64_t*>(c_cnt),
      static_cast<int64_t*>(c_pk));
  return static_cast<int>(cudaGetLastError());
}

// Stream planes hold windows * slots rows; counters: int64 (overlong,
// tokens, spill), zeroed by the caller; rows/rows_n: the scratch
// mr_combiner_heads filled.
extern "C" int mr_combiner_thin(long long n, int slots, int cslots,
                                const void* rows, const void* rows_n,
                                const void* c_khi, const void* c_klo,
                                void* c_cnt, void* khi, void* klo,
                                void* packed, void* counters, void* stream) {
  if (bad_combiner(n, 1, cslots) || slots < 1 || slots > kWindow)
    return static_cast<int>(cudaErrorInvalidValue);
  combiner_thin<<<kSegments * combiner_windows(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int*>(rows_n),
      slots, cslots, static_cast<const int64_t*>(c_khi),
      static_cast<const int64_t*>(c_klo), static_cast<int64_t*>(c_cnt),
      static_cast<int64_t*>(khi), static_cast<int64_t*>(klo),
      static_cast<int64_t*>(packed),
      static_cast<unsigned long long*>(counters));
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
    {"combiner_heads", reinterpret_cast<const void*>(&combiner_heads),
     kThreads},
    {"combiner_merge", reinterpret_cast<const void*>(&combiner_merge),
     kMergeWarps * 32},
    {"combiner_thin", reinterpret_cast<const void*>(&combiner_thin),
     kThreads},
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
