// Tokenize + hash kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mapreduce_tpu/ops/pallas/tokenize.py:_tokenize_kernel
// in its compact lane-major mode (tokenize_split_compact) and its pair mode
// (tokenize_split, the exact spill fallback).  What it computes is the TPU
// kernel's contract, not its layout: for every token end in a chunk, the
// W-byte lookback into two uint32 polynomial hashes, a length-mixed fmix32,
// a clamp off the sentinel keys, and one row (key_hi, key_lo,
// packed = start << 6 | len).  A run longer than W is counted once, at its
// end, as a poison row (sent, sent - 1, last_byte << 6).
//
// Layout.  One CTA per WINDOW contiguous bytes of the chunk.  The CTA owns
// `slots` output rows; its live rows (token ends and poisons) are written in
// ascending byte position, so flattening [cta][slot] gives a stream in global
// byte order (the precondition of the stable 2-key aggregation sort).  Rows
// beyond `slots` are counted into `spill` and not written: the caller then
// reruns the chunk in pair mode, slots = WINDOW / 2, which cannot spill
// (two adjacent bytes are never both token ends).  Unused slots hold
// (sent, sent, 0xFFFFFFFF).  There is no seam pass: the CTA reads a halo of
// W + 1 bytes before its window and one byte after it.  Each uint32 word is
// stored zero-extended into an int64 element, the form in which the PyTorch
// side carries uint32 (torch has no uint32 shifts or sorts), so no widening
// pass follows the kernel.
//
// Bound on this card: device-memory bytes.  It reads the chunk's N bytes
// and writes 24 * (N * slots / WINDOW) bytes of rows.  The design reads
// each input byte from device memory once (plus the 65-byte halo per
// 3072-byte window) and serves every lookback from shared memory.
//
// Bytes before 0 and at or after N are separators (PAD_BYTE 0x00 is one).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 3072;              // bytes per CTA
constexpr int kThreads = 256;
constexpr int kPer = kWindow / kThreads;   // contiguous bytes per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 63;                  // length is packed into 6 bits
constexpr int kHalo = kMaxW + 1;           // bytes kept before the window
constexpr int kBuf = kHalo + kWindow + 1;  // plus one byte after it
constexpr uint32_t kSent = 0xFFFFFFFFu;
constexpr uint32_t kBase1 = 16777619u;     // constants.HASH_BASE_1
constexpr uint32_t kBase2 = 2654435761u;   // constants.HASH_BASE_2

static_assert(kWindow % kThreads == 0, "window must split evenly");
static_assert(kPer <= 32, "live flags of a thread fit one word");

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
  for (int i = threadIdx.x; i < kBuf; i += kThreads) {
    const long long g = base - kHalo + i;
    buf[i] = (g >= 0 && g < n) ? data[g] : 0;
  }
  __syncthreads();

  // Pass 1: which of this thread's kPer positions are live rows.  A
  // position is a token end (emission or poison) when its byte is not a
  // separator and the next byte is one.
  const int first = threadIdx.x * kPer;
  uint32_t live_bits = 0;
  int live = 0;
  for (int j = 0; j < kPer; ++j) {
    const int i = kHalo + first + j;
    if (base + first + j < n && !is_sep(buf[i]) && is_sep(buf[i + 1])) {
      live_bits |= 1u << j;
      ++live;
    }
  }

  // Exclusive scan of `live` over the CTA: the thread's first slot.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = live;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? warp_off[lane] : 0;
    int s = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += u;
    }
    if (lane < kWarps) warp_off[lane] = s - v;
    if (lane == kWarps - 1) live_total = s;
  }
  __syncthreads();
  int slot = warp_off[warp] + incl - live;
  const int total = live_total;

  // Pass 2: hash each live row from shared memory and write it.
  const long long out0 = static_cast<long long>(blockIdx.x) * slots;
  int n_over = 0, n_emit = 0;
  for (int j = 0; j < kPer; ++j) {
    if (!((live_bits >> j) & 1u)) continue;
    const int i = kHalo + first + j;
    const long long p = base + first + j;
    int len = 0;
    while (len < w && !is_sep(buf[i - len])) ++len;
    // The run is longer than W when the byte W back is still inside it.
    const bool over = len == w && !is_sep(buf[i - w]);
    uint32_t hi, lo, pk;
    if (over) {
      ++n_over;
      hi = kSent;
      lo = kSent - 1u;
      pk = static_cast<uint32_t>(p) << 6;
    } else {
      ++n_emit;
      uint32_t h1 = 0, h2 = 0;
      for (int k = i - len + 1; k <= i; ++k) {
        const uint32_t c = static_cast<uint32_t>(buf[k]) + 1u;
        h1 = h1 * kBase1 + c;
        h2 = h2 * kBase2 + c;
      }
      const uint32_t ln = static_cast<uint32_t>(len);
      hi = fmix32(h1 ^ ln);
      lo = fmix32(h2 + 0x9E3779B9u * ln);
      if (hi == kSent && lo >= kSent - 1u) lo = kSent - 2u;
      pk = (static_cast<uint32_t>(p + 1 - len) << 6) | ln;
    }
    if (slot < slots) {
      khi[out0 + slot] = hi;
      klo[out0 + slot] = lo;
      packed[out0 + slot] = pk;
    }
    ++slot;
  }

  // Dead filler in the slots no live row took.
  for (int s = min(total, slots) + threadIdx.x; s < slots; s += kThreads) {
    khi[out0 + s] = kSent;
    klo[out0 + s] = kSent;
    packed[out0 + s] = 0xFFFFFFFFu;
  }

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

}  // namespace

// Launch over a chunk of n bytes on `stream`.  Outputs are int64 planes of
// ceil(n / 3072) * slots rows each, holding uint32 words; the int64
// counters (overlong, tokens, spill) must be zeroed by the caller.  Returns cudaGetLastError() after the launch.
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

// Bytes per CTA window, so the Python side can check its copy.
extern "C" int mr_tokenize_window_bytes() { return kWindow; }
