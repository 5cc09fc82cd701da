// Radix sort kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mapreduce_tpu/ops/pallas/radix.py:_partition_kernel
// (launched by _partition_level inside radix_sort3) and the finishing sort
// of each bucket that radix_sort3 runs after it.  The TPU has no scatter, so
// its kernel compacts each block's rows per bucket into static slabs with a
// slack factor and spills when a slab overflows.  Hopper scatters, so here
// every step is one STABLE counting pass over segmented rows:
//
//   sort_tiles    the tile table of a segmentation: each segment (a bucket
//                 of the previous step, from its end row) is cut into tiles
//                 of kTile rows, so a tile never straddles a segment;
//   sort_hist     per segment, the count of every digit value for every
//                 pass in ONE read of the rows (as in onesweep);
//   sort_scan     per (segment, pass), the first output row of each digit;
//                 for a partition level also the new bucket ends;
//   sort_scatter  one pass: each CTA ranks its tile's rows by digit at warp
//                 level (__match_any_sync + __popc, one shared-memory update
//                 per distinct digit per warp and no atomics), takes its
//                 tile's offset within the segment from a decoupled
//                 look-back over the segment's earlier tiles, reorders the
//                 tile in shared memory and writes each digit's rows as one
//                 contiguous, coalesced run.
//
// A partition level is one pass whose digit is `bits` of key_hi and whose
// segments are the previous level's buckets (one segment at the first
// level), dead (sent, sent) rows dropped; so a row's bucket is the group
// where the previous level wrote it, and a misplaced row stays misplaced.
// The segmented LSD sort that finishes radix_sort3 runs 8-bit passes over
// the key bits below the digits the levels decided (and over `packed` first
// when ties need it) inside the final buckets, which stay implicit in the
// tile table.  Every pass is stable, so the result is the 3-key sort, ties
// by input order.  No count comes back to the host: the live count stays on
// the device, grids are sized from n, tiles past the live rows exit, and the
// last pass writes the dead fill at [live, n).
//
// Rows travel as uint32 words: int64 planes (uint32 zero-extended, the
// PyTorch side's form) at the ends, 12-byte rows in the caller's scratch in
// between.  Words are compared unsigned throughout.
//
// Bound on this card: device-memory bytes.  A pass reads and writes 12 bytes
// a live row (24 when it reads or writes int64 planes); the histogram reads
// each row once for all passes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;                 // rows per tile
constexpr int kWarpRows = kTile / kWarps;   // contiguous rows per warp
constexpr int kIters = kWarpRows / 32;      // rows per thread
constexpr int kRadix = 256;                 // digit values of an 8-bit pass
constexpr int kMaxPasses = 12;
constexpr int kMaxSegments = 1024;
constexpr uint32_t kSent = 0xFFFFFFFFu;
constexpr uint32_t kSkip = 0xFFFFFFFFu;     // digit of a row not moved
// Look-back status word of a (tile, digit): flag (2 bits: aggregate or
// inclusive prefix), the pass's epoch (4 bits, so one zeroed buffer serves
// every pass of a call), the count (26 bits).
constexpr uint32_t kFlagAgg = 1u << 30;
constexpr uint32_t kFlagPrefix = 2u << 30;
constexpr int kCountBits = 26;
constexpr uint32_t kCountMask = (1u << kCountBits) - 1u;
constexpr long long kMaxRows = (1LL << kCountBits) - 1;
// Polls of a look-back before the kernel traps: a fault ends the launch
// with an error instead of spinning forever.
constexpr unsigned kMaxPolls = 1u << 26;

static_assert(kThreads == kRadix, "one thread per digit value");
static_assert(kWarpRows % 32 == 0, "warp rows split into lanes");

// A pass's digit: (word >> shift) & (2**width - 1), word 0 key_hi, 1
// key_lo, 2 packed; encoded word << 16 | shift << 8 | width.
struct Passes {
  int n;
  int spec[kMaxPasses];
};

__device__ __forceinline__ uint32_t digit_of(uint32_t hi, uint32_t lo,
                                             uint32_t pk, int spec) {
  const int word = spec >> 16, shift = (spec >> 8) & 0xFF, width = spec & 0xFF;
  const uint32_t v = word == 0 ? hi : (word == 1 ? lo : pk);
  return (v >> shift) & ((1u << width) - 1u);
}

// Segment s is rows [seg_begin, seg_end); no ends means one segment [0, n).
__device__ __forceinline__ long long seg_end(const long long* ends, int s,
                                             long long n) {
  return ends ? ends[s] : n;
}

__device__ __forceinline__ long long seg_begin(const long long* ends, int s,
                                               long long n) {
  return s ? seg_end(ends, s - 1, n) : 0;
}

// The segment of a tile: the last one whose first tile is <= tile (empty
// segments share their first tile with the next one).
__device__ __forceinline__ int find_seg(const int* tile_start, int segs,
                                        int tile) {
  int lo = 0, hi = segs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile_start[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Exclusive scan of v over a CTA of kBlock threads; *total gets the sum.
// Callers separate two calls by a __syncthreads.
template <int kBlock>
__device__ __forceinline__ int block_scan(int v, int* warp_tmp, int* total) {
  constexpr int kW = kBlock / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_tmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int x = lane < kW ? warp_tmp[lane] : 0;
    int s = x;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += u;
    }
    if (lane < kW) warp_tmp[lane] = s - x;
    if (lane == kW - 1) *total = s;
  }
  __syncthreads();
  return warp_tmp[warp] + incl - v;
}

__global__ void __launch_bounds__(kMaxSegments)
sort_tiles(const long long* __restrict__ ends, int segs, long long n,
           int* __restrict__ tile_start) {
  __shared__ int warp_tmp[32];
  __shared__ int total;
  const int s = threadIdx.x;
  int tiles = 0;
  if (s < segs) {
    const long long len = seg_end(ends, s, n) - seg_begin(ends, s, n);
    tiles = static_cast<int>((len + kTile - 1) / kTile);
  }
  const int first = block_scan<kMaxSegments>(tiles, warp_tmp, &total);
  if (s < segs) tile_start[s] = first;
  if (s == 0) tile_start[segs] = total;
}

// The rows of tile `tile`: [*r0, *r1) in segment *seg.
__device__ __forceinline__ void tile_rows(const long long* ends, int segs,
                                          long long n, const int* tile_start,
                                          int tile, int* seg, int* j,
                                          long long* r0, long long* r1) {
  const int s = find_seg(tile_start, segs, tile);
  *seg = s;
  *j = tile - tile_start[s];
  *r0 = seg_begin(ends, s, n) + static_cast<long long>(*j) * kTile;
  *r1 = min(*r0 + kTile, seg_end(ends, s, n));
}

// Counts are shared-memory atomics, one per row and pass, except where a
// warp's 32 rows share the digit (a hot key): then one.
template <typename In, bool kDropDead>
__global__ void __launch_bounds__(kThreads)
sort_hist(const In* __restrict__ hi, const In* __restrict__ lo,
          const In* __restrict__ pk, const long long* __restrict__ ends,
          int segs, long long n, const int* __restrict__ tile_start,
          Passes passes, int* __restrict__ hist) {
  __shared__ int count[kMaxPasses * kRadix];
  __shared__ uint32_t p_word[kMaxPasses], p_shift[kMaxPasses],
      p_mask[kMaxPasses];
  const int tile = blockIdx.x;
  if (tile >= tile_start[segs]) return;  // the whole CTA: past the live rows
  int s, j;
  long long r0, r1;
  tile_rows(ends, segs, n, tile_start, tile, &s, &j, &r0, &r1);
  const int np = passes.n, bins = np * kRadix;
  for (int i = threadIdx.x; i < bins; i += kThreads) count[i] = 0;
  if (threadIdx.x < np) {
    const int spec = passes.spec[threadIdx.x];
    p_word[threadIdx.x] = spec >> 16;
    p_shift[threadIdx.x] = (spec >> 8) & 0xFF;
    p_mask[threadIdx.x] = (1u << (spec & 0xFF)) - 1u;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int it = 0; it < kIters; ++it) {
    const long long r = r0 + warp * kWarpRows + it * 32 + lane;
    bool live = r < r1;
    uint32_t w3[3] = {0, 0, 0};
    if (live) {
      w3[0] = static_cast<uint32_t>(hi[r]);
      w3[1] = static_cast<uint32_t>(lo[r]);
      w3[2] = static_cast<uint32_t>(pk[r]);
      if (kDropDead && w3[0] == kSent && w3[1] == kSent) live = false;
    }
    const bool all_live = __all_sync(0xffffffffu, live);
    for (int q = 0; q < np; ++q) {
      const uint32_t wd = p_word[q];
      const uint32_t v = wd == 0 ? w3[0] : (wd == 1 ? w3[1] : w3[2]);
      const uint32_t d = (v >> p_shift[q]) & p_mask[q];
      if (all_live && __all_sync(0xffffffffu,
                                 d == __shfl_sync(0xffffffffu, d, 0))) {
        if (lane == 0) atomicAdd(&count[q * kRadix + d], 32);
      } else if (live) {
        atomicAdd(&count[q * kRadix + d], 1);
      }
    }
  }
  __syncthreads();
  int* out = hist + static_cast<long long>(s) * bins;
  for (int i = threadIdx.x; i < bins; i += kThreads)
    if (count[i]) atomicAdd(&out[i], count[i]);
}

// grid (segs, passes.n): the first output row of each digit of each pass in
// each segment; with bucket_ends, the first pass's digits split each
// segment into 2**width buckets and their end rows are written.
__global__ void __launch_bounds__(kRadix)
sort_scan(const int* __restrict__ hist, const long long* __restrict__ ends,
          long long n, Passes passes, int* __restrict__ digit_start,
          long long* __restrict__ bucket_ends) {
  __shared__ int warp_tmp[32];
  __shared__ int total;
  const int s = blockIdx.x, q = blockIdx.y, d = threadIdx.x;
  const long long at = (static_cast<long long>(s) * passes.n + q) * kRadix + d;
  const int c = hist[at];
  const int excl = block_scan<kRadix>(c, warp_tmp, &total);
  const long long b0 = seg_begin(ends, s, n);
  digit_start[at] = static_cast<int>(b0 + excl);
  const int width = passes.spec[0] & 0xFF;
  if (bucket_ends && q == 0 && d < (1 << width))
    bucket_ends[(static_cast<long long>(s) << width) + d] = b0 + excl + c;
}

template <typename Out>
__device__ __forceinline__ void put(Out* hi, Out* lo, Out* pk, long long at,
                                    uint32_t h, uint32_t l, uint32_t p) {
  hi[at] = static_cast<Out>(h);
  lo[at] = static_cast<Out>(l);
  pk[at] = static_cast<Out>(p);
}

template <typename In, typename Out, bool kDropDead>
__global__ void __launch_bounds__(kThreads)
sort_scatter(const In* __restrict__ hi, const In* __restrict__ lo,
             const In* __restrict__ pk, const long long* __restrict__ ends,
             int segs, long long n, const int* __restrict__ tile_start,
             int spec, const int* __restrict__ digit_start, int dstride,
             uint32_t* __restrict__ status, uint32_t epoch,
             int* __restrict__ next_tile, Out* __restrict__ ohi,
             Out* __restrict__ olo, Out* __restrict__ opk,
             const long long* __restrict__ fill_from) {
  __shared__ uint16_t wcount[kWarps][kRadix];  // per warp, then its prefix
  __shared__ int tfirst[kRadix];   // the tile's first local slot of a digit
  __shared__ int gfirst[kRadix];   // its first output row
  __shared__ uint32_t s_hi[kTile], s_lo[kTile], s_pk[kTile];
  __shared__ uint8_t s_dig[kTile];
  __shared__ int warp_tmp[32];
  __shared__ int sh_tile, sh_kept;

  // Tiles are taken in launch order, so every tile the look-back waits for
  // has already started.
  if (threadIdx.x == 0) sh_tile = atomicAdd(next_tile, 1);
  __syncthreads();
  const int tile = sh_tile;
  if (tile < tile_start[segs]) {  // the whole CTA: a live tile
    int s, j;
    long long r0, r1;
    tile_rows(ends, segs, n, tile_start, tile, &s, &j, &r0, &r1);
    for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
      (&wcount[0][0])[i] = 0;
    __syncthreads();

    // Rank each row among its warp's rows of the same digit, in row order.
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t rh[kIters], rl[kIters], rp[kIters], rd[kIters];
    int rr[kIters];
    for (int it = 0; it < kIters; ++it) {
      const long long r = r0 + warp * kWarpRows + it * 32 + lane;
      uint32_t d = kSkip;
      rh[it] = rl[it] = rp[it] = 0;
      if (r < r1) {
        rh[it] = static_cast<uint32_t>(hi[r]);
        rl[it] = static_cast<uint32_t>(lo[r]);
        rp[it] = static_cast<uint32_t>(pk[r]);
        if (!(kDropDead && rh[it] == kSent && rl[it] == kSent))
          d = digit_of(rh[it], rl[it], rp[it], spec);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (lane == leader && d != kSkip) base = wcount[warp][d];
      base = __shfl_sync(0xffffffffu, base, leader);
      if (lane == leader && d != kSkip)
        wcount[warp][d] = static_cast<uint16_t>(base + __popc(peers));
      __syncwarp();
      rd[it] = d;
      rr[it] = base + __popc(peers & ((1u << lane) - 1u));
    }
    __syncthreads();

    // Digit d (thread d): each warp's first rank, the tile's count, the
    // tile's first slot.
    const int d = threadIdx.x;
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcount[w][d];
      wcount[w][d] = static_cast<uint16_t>(run);
      run += c;
    }
    tfirst[d] = block_scan<kThreads>(run, warp_tmp, &sh_kept);

    // Decoupled look-back: the digit's rows in the segment's earlier tiles.
    const int width = spec & 0xFF;
    if (d < (1 << width)) {
      volatile uint32_t* st = status;
      const long long me = static_cast<long long>(tile) * kRadix + d;
      const uint32_t ep = epoch << kCountBits;
      uint32_t excl = 0;
      if (j == 0) {
        st[me] = kFlagPrefix | ep | static_cast<uint32_t>(run);
      } else {
        st[me] = kFlagAgg | ep | static_cast<uint32_t>(run);
        long long k = me - kRadix;
        unsigned polls = 0;
        while (true) {
          const uint32_t v = st[k];
          if ((v >> 30) == 0 || ((v >> kCountBits) & 15u) != epoch) {
            if (++polls > kMaxPolls) __trap();
            continue;
          }
          excl += v & kCountMask;
          if (v & kFlagPrefix) break;
          k -= kRadix;
        }
        st[me] = kFlagPrefix | ep | (excl + static_cast<uint32_t>(run));
      }
      gfirst[d] = digit_start[static_cast<long long>(s) * dstride + d] +
                  static_cast<int>(excl);
    }
    __syncthreads();

    // Reorder the tile by digit in shared memory, then write each digit's
    // rows as one contiguous run.
    for (int it = 0; it < kIters; ++it) {
      const uint32_t dd = rd[it];
      if (dd == kSkip) continue;
      const int slot = tfirst[dd] + wcount[warp][dd] + rr[it];
      s_hi[slot] = rh[it];
      s_lo[slot] = rl[it];
      s_pk[slot] = rp[it];
      s_dig[slot] = static_cast<uint8_t>(dd);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < sh_kept; k += kThreads) {
      const int dd = s_dig[k];
      put(ohi, olo, opk, static_cast<long long>(gfirst[dd]) + (k - tfirst[dd]),
          s_hi[k], s_lo[k], s_pk[k]);
    }
  }
  // Dead fill of [live, n) where asked, over this CTA's static row range.
  if (fill_from) {
    const long long f0 = max(*fill_from, static_cast<long long>(blockIdx.x) * kTile);
    const long long f1 = min(n, static_cast<long long>(blockIdx.x + 1) * kTile);
    for (long long r = f0 + threadIdx.x; r < f1; r += kThreads)
      put(ohi, olo, opk, r, kSent, kSent, kSent);
  }
}

bool bad_specs(const int* specs, int npass) {
  if (npass < 1 || npass > kMaxPasses) return true;
  for (int q = 0; q < npass; ++q) {
    const int word = specs[q] >> 16, shift = (specs[q] >> 8) & 0xFF,
              width = specs[q] & 0xFF;
    if (word < 0 || word > 2 || width < 1 || width > 8 || shift + width > 32)
      return true;
  }
  return false;
}

bool bad_rows(long long n, int segs) {
  return n <= 0 || n > kMaxRows || segs < 1 || segs > kMaxSegments;
}

Passes to_passes(const int* specs, int npass) {
  Passes p{};
  p.n = npass;
  for (int q = 0; q < npass; ++q) p.spec[q] = specs[q];
  return p;
}

template <typename In>
void launch_hist(const void* hi, const void* lo, const void* pk, bool drop,
                 const long long* ends, int segs, long long n,
                 const int* tile_start, const Passes& p, int* hist,
                 cudaStream_t stream, unsigned grid) {
  const In* h = static_cast<const In*>(hi);
  const In* l = static_cast<const In*>(lo);
  const In* k = static_cast<const In*>(pk);
  if (drop)
    sort_hist<In, true><<<grid, kThreads, 0, stream>>>(h, l, k, ends, segs, n,
                                                       tile_start, p, hist);
  else
    sort_hist<In, false><<<grid, kThreads, 0, stream>>>(h, l, k, ends, segs, n,
                                                        tile_start, p, hist);
}

template <typename In, typename Out>
void launch_scatter(const void* hi, const void* lo, const void* pk, bool drop,
                    const long long* ends, int segs, long long n,
                    const int* tile_start, int spec, const int* digit_start,
                    int dstride, uint32_t* status, uint32_t epoch,
                    int* next_tile, void* ohi, void* olo, void* opk,
                    const long long* fill_from, cudaStream_t stream,
                    unsigned grid) {
  const In* h = static_cast<const In*>(hi);
  const In* l = static_cast<const In*>(lo);
  const In* k = static_cast<const In*>(pk);
  Out* oh = static_cast<Out*>(ohi);
  Out* ol = static_cast<Out*>(olo);
  Out* ok = static_cast<Out*>(opk);
  if (drop)
    sort_scatter<In, Out, true><<<grid, kThreads, 0, stream>>>(
        h, l, k, ends, segs, n, tile_start, spec, digit_start, dstride, status,
        epoch, next_tile, oh, ol, ok, fill_from);
  else
    sort_scatter<In, Out, false><<<grid, kThreads, 0, stream>>>(
        h, l, k, ends, segs, n, tile_start, spec, digit_start, dstride, status,
        epoch, next_tile, oh, ol, ok, fill_from);
}

}  // namespace

// CTAs of a histogram or scatter launch over n rows in segs segments: an
// upper bound on the tiles, known without reading the segment ends.
extern "C" long long mr_sort_grid(long long n, int segs) {
  return (n + kTile - 1) / kTile + segs;
}

extern "C" int mr_sort_tile_rows() { return kTile; }

// tile_start: int32 [segs + 1].  ends: int64 [segs] end rows, or null for
// one segment [0, n).  Returns cudaGetLastError().
extern "C" int mr_sort_tiles(const void* ends, int segs, long long n,
                             void* tile_start, void* stream) {
  if (bad_rows(n, segs) || (!ends && segs != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  sort_tiles<<<1, kMaxSegments, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ends), segs, n,
      static_cast<int*>(tile_start));
  return static_cast<int>(cudaGetLastError());
}

// hist: a zeroed int32 [segs][npass][256].  Rows are int64 planes (in64) or
// uint32 planes.  Returns cudaGetLastError().
extern "C" int mr_sort_hist(const void* hi, const void* lo, const void* pk,
                            int in64, int drop_dead, const void* ends,
                            int segs, long long n, const void* tile_start,
                            const int* specs, int npass, void* hist,
                            void* stream) {
  if (bad_rows(n, segs) || bad_specs(specs, npass) || (!ends && segs != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Passes p = to_passes(specs, npass);
  const unsigned grid = static_cast<unsigned>(mr_sort_grid(n, segs));
  auto* e = static_cast<const long long*>(ends);
  auto* ts = static_cast<const int*>(tile_start);
  auto* h = static_cast<int*>(hist);
  auto s = static_cast<cudaStream_t>(stream);
  if (in64)
    launch_hist<int64_t>(hi, lo, pk, drop_dead, e, segs, n, ts, p, h, s, grid);
  else
    launch_hist<uint32_t>(hi, lo, pk, drop_dead, e, segs, n, ts, p, h, s, grid);
  return static_cast<int>(cudaGetLastError());
}

// digit_start: int32 [segs][npass][256]; bucket_ends: int64 [segs << width
// of the first pass], or null.  Returns cudaGetLastError().
extern "C" int mr_sort_scan(const void* hist, const void* ends, int segs,
                            long long n, const int* specs, int npass,
                            void* digit_start, void* bucket_ends,
                            void* stream) {
  if (bad_rows(n, segs) || bad_specs(specs, npass) || (!ends && segs != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  sort_scan<<<dim3(segs, npass), kRadix, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(hist), static_cast<const long long*>(ends), n,
      to_passes(specs, npass), static_cast<int*>(digit_start),
      static_cast<long long*>(bucket_ends));
  return static_cast<int>(cudaGetLastError());
}

// One stable pass.  digit_start points at this pass's first digit of
// segment 0 (dstride ints between segments); status: uint32 [grid][256],
// zeroed once per call, epoch 1..15 distinct per pass of the call;
// next_tile: a zeroed int32 of this pass.  fill_from: null, or the device
// address of the live count (outputs then hold dead rows at [live, n)).
// Returns cudaGetLastError().
extern "C" int mr_sort_scatter(const void* hi, const void* lo, const void* pk,
                               int in64, int drop_dead, const void* ends,
                               int segs, long long n, const void* tile_start,
                               int spec, const void* digit_start, int dstride,
                               void* status, int epoch, void* next_tile,
                               void* ohi, void* olo, void* opk, int out64,
                               const void* fill_from, void* stream) {
  if (bad_rows(n, segs) || bad_specs(&spec, 1) || (!ends && segs != 1) ||
      epoch < 1 || epoch > 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(mr_sort_grid(n, segs));
  auto* e = static_cast<const long long*>(ends);
  auto* ts = static_cast<const int*>(tile_start);
  auto* ds = static_cast<const int*>(digit_start);
  auto* st = static_cast<uint32_t*>(status);
  auto* nt = static_cast<int*>(next_tile);
  auto* ff = static_cast<const long long*>(fill_from);
  auto s = static_cast<cudaStream_t>(stream);
  const uint32_t ep = static_cast<uint32_t>(epoch);
  if (in64 && out64)
    launch_scatter<int64_t, int64_t>(hi, lo, pk, drop_dead, e, segs, n, ts,
                                     spec, ds, dstride, st, ep, nt, ohi, olo,
                                     opk, ff, s, grid);
  else if (in64)
    launch_scatter<int64_t, uint32_t>(hi, lo, pk, drop_dead, e, segs, n, ts,
                                      spec, ds, dstride, st, ep, nt, ohi, olo,
                                      opk, ff, s, grid);
  else if (out64)
    launch_scatter<uint32_t, int64_t>(hi, lo, pk, drop_dead, e, segs, n, ts,
                                      spec, ds, dstride, st, ep, nt, ohi, olo,
                                      opk, ff, s, grid);
  else
    launch_scatter<uint32_t, uint32_t>(hi, lo, pk, drop_dead, e, segs, n, ts,
                                       spec, ds, dstride, st, ep, nt, ohi, olo,
                                       opk, ff, s, grid);
  return static_cast<int>(cudaGetLastError());
}

// What the static analysis asks the card of each kernel (analysis/
// kernel_info.py): its name (a template instance by its arguments), and
// for kernel i, out[0..5] = static shared bytes, registers, local bytes,
// max threads per block, constant bytes, and active blocks an SM at its
// launch block size.  Returns a CUDA error.
namespace {
struct KernelEntry {
  const char* name;
  const void* fn;
  int threads;
};
template <typename F>
const void* fn_ptr(F* f) {
  return reinterpret_cast<const void*>(f);
}
const KernelEntry kKernels[] = {
    {"sort_tiles", fn_ptr(&sort_tiles), kMaxSegments},
    {"sort_hist<int64,drop>", fn_ptr(&sort_hist<int64_t, true>), kThreads},
    {"sort_hist<int64,keep>", fn_ptr(&sort_hist<int64_t, false>), kThreads},
    {"sort_hist<uint32,drop>", fn_ptr(&sort_hist<uint32_t, true>), kThreads},
    {"sort_hist<uint32,keep>", fn_ptr(&sort_hist<uint32_t, false>), kThreads},
    {"sort_scan", fn_ptr(&sort_scan), kRadix},
    {"sort_scatter<int64,int64,drop>",
     fn_ptr(&sort_scatter<int64_t, int64_t, true>), kThreads},
    {"sort_scatter<int64,int64,keep>",
     fn_ptr(&sort_scatter<int64_t, int64_t, false>), kThreads},
    {"sort_scatter<int64,uint32,drop>",
     fn_ptr(&sort_scatter<int64_t, uint32_t, true>), kThreads},
    {"sort_scatter<int64,uint32,keep>",
     fn_ptr(&sort_scatter<int64_t, uint32_t, false>), kThreads},
    {"sort_scatter<uint32,int64,drop>",
     fn_ptr(&sort_scatter<uint32_t, int64_t, true>), kThreads},
    {"sort_scatter<uint32,int64,keep>",
     fn_ptr(&sort_scatter<uint32_t, int64_t, false>), kThreads},
    {"sort_scatter<uint32,uint32,drop>",
     fn_ptr(&sort_scatter<uint32_t, uint32_t, true>), kThreads},
    {"sort_scatter<uint32,uint32,keep>",
     fn_ptr(&sort_scatter<uint32_t, uint32_t, false>), kThreads},
};
constexpr int kKernelCount = sizeof(kKernels) / sizeof(kKernels[0]);
}  // namespace

extern "C" int mr_radix_kernel_count() { return kKernelCount; }

extern "C" const char* mr_radix_kernel_name(int i) {
  return i >= 0 && i < kKernelCount ? kKernels[i].name : nullptr;
}

extern "C" int mr_radix_kernel_attrs(int i, long long* out) {
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
