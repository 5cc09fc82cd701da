// Radix partition kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mapreduce_tpu/ops/pallas/radix.py:_partition_kernel
// (launched by _partition_level inside radix_sort3): one MSD digit level of
// the packed aggregation stream (key_hi, key_lo, packed), dropping the dead
// (sent, sent) rows.  The TPU has no scatter, so its kernel compacts each
// block's rows per bucket into static slabs with a slack factor and spills
// when a slab overflows.  Hopper scatters, so this is the textbook level:
//
//   radix_histogram  per CTA, the count of live rows in each bucket, stored
//                    bucket-major: hist[bucket * grid + cta];
//   (an exclusive scan of hist, by the caller: each (bucket, cta) pair's
//    first output row, so buckets come out in ascending order)
//   radix_scatter    each live row to its bucket's next row.
//
// A row's bucket is g * 2**bits + digit, with digit = (key_hi >> shift) &
// (2**bits - 1) and g the group that holds the row's input position: the
// previous level's bucket (group_ends holds each group's end row; the
// first level has one group).  So a second level refines the buckets the
// first one wrote, as the TPU version's per-group levels do, and a row the
// first level misplaced stays misplaced.
//
// There is no slab budget, so nothing spills.  Within a bucket the rows land
// in no set order (shared-memory atomics); the caller's finishing sort of
// each bucket fixes it, and ties resolve by `packed` as in the TPU version.
// key_hi is read as an unsigned 32-bit word (the int64 plane holds
// [0, 2**32)).
//
// Bound on this card: device-memory bytes.  The histogram reads key_hi and
// key_lo once (16 bytes a row); the scatter reads them and `packed` again and
// writes the live rows (24 + 24 bytes a live row).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // rows per CTA
constexpr int kMaxBits = 5;
constexpr int kMaxGroups = 1 << kMaxBits;     // one earlier level
constexpr int kMaxBuckets = kMaxGroups << kMaxBits;
constexpr uint32_t kSent = 0xFFFFFFFFu;

__device__ __forceinline__ bool live_row(const int64_t* khi,
                                         const int64_t* klo, long long r,
                                         uint32_t* hi) {
  *hi = static_cast<uint32_t>(khi[r]);
  return !(*hi == kSent && static_cast<uint32_t>(klo[r]) == kSent);
}

// Loads the group ends into shared memory (none for one group: bucket_of
// reads no end then).
__device__ __forceinline__ void load_ends(const long long* group_ends,
                                          int groups, long long* ends) {
  if (groups == 1) return;
  for (int g = threadIdx.x; g < groups; g += kThreads) ends[g] = group_ends[g];
}

// The bucket of input row r: its group (the number of group ends <= r,
// clamped to the last group) then its digit.
__device__ __forceinline__ int bucket_of(uint32_t hi, long long r, int shift,
                                         int bits, int groups,
                                         const long long* ends) {
  int lo = 0, top = groups - 1;
  while (lo < top) {
    const int mid = (lo + top) >> 1;
    if (ends[mid] <= r) lo = mid + 1; else top = mid;
  }
  return (lo << bits) | static_cast<int>((hi >> shift) & ((1u << bits) - 1));
}

__global__ void __launch_bounds__(kThreads)
radix_histogram(const int64_t* __restrict__ khi,
                const int64_t* __restrict__ klo, long long n, int shift,
                int bits, int groups, const long long* __restrict__ group_ends,
                int* __restrict__ hist) {
  __shared__ int count[kMaxBuckets];
  __shared__ long long ends[kMaxGroups];
  const int buckets = groups << bits;
  for (int b = threadIdx.x; b < buckets; b += kThreads) count[b] = 0;
  load_ends(group_ends, groups, ends);
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int j = 0; j < kPerThread; ++j) {
    const long long r = base + j * kThreads + threadIdx.x;
    uint32_t hi;
    if (r < n && live_row(khi, klo, r, &hi))
      atomicAdd(&count[bucket_of(hi, r, shift, bits, groups, ends)], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < buckets; b += kThreads)
    hist[static_cast<long long>(b) * gridDim.x + blockIdx.x] = count[b];
}

__global__ void __launch_bounds__(kThreads)
radix_scatter(const int64_t* __restrict__ khi, const int64_t* __restrict__ klo,
              const int64_t* __restrict__ packed, long long n, int shift,
              int bits, int groups, const long long* __restrict__ group_ends,
              const long long* __restrict__ offsets,
              int64_t* __restrict__ out_hi, int64_t* __restrict__ out_lo,
              int64_t* __restrict__ out_pk) {
  __shared__ long long first[kMaxBuckets];
  __shared__ int taken[kMaxBuckets];
  __shared__ long long ends[kMaxGroups];
  const int buckets = groups << bits;
  for (int b = threadIdx.x; b < buckets; b += kThreads) {
    first[b] = offsets[static_cast<long long>(b) * gridDim.x + blockIdx.x];
    taken[b] = 0;
  }
  load_ends(group_ends, groups, ends);
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int j = 0; j < kPerThread; ++j) {
    const long long r = base + j * kThreads + threadIdx.x;
    uint32_t hi;
    if (r < n && live_row(khi, klo, r, &hi)) {
      const int b = bucket_of(hi, r, shift, bits, groups, ends);
      const long long at = first[b] + atomicAdd(&taken[b], 1);
      out_hi[at] = khi[r];
      out_lo[at] = klo[r];
      out_pk[at] = packed[r];
    }
  }
}

bool bad_args(long long n, int shift, int bits, int groups,
              const void* group_ends) {
  return n <= 0 || bits < 1 || bits > kMaxBits || shift < 0 ||
         shift + bits > 32 || groups < 1 || groups > kMaxGroups ||
         (groups > 1 && group_ends == nullptr);
}

}  // namespace

// CTAs a launch over n rows uses (the histogram's second dimension).
extern "C" long long mr_radix_grid(long long n) {
  return (n + kTile - 1) / kTile;
}

// hist: an int32 [groups << bits][mr_radix_grid(n)] array.  group_ends:
// `groups` int64 end rows, or null for one group.  Returns
// cudaGetLastError().
extern "C" int mr_radix_histogram(const void* khi, const void* klo,
                                  long long n, int shift, int bits,
                                  int groups, const void* group_ends,
                                  void* hist, void* stream) {
  if (bad_args(n, shift, bits, groups, group_ends))
    return static_cast<int>(cudaErrorInvalidValue);
  radix_histogram<<<static_cast<unsigned>(mr_radix_grid(n)), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(khi), static_cast<const int64_t*>(klo), n,
      shift, bits, groups, static_cast<const long long*>(group_ends),
      static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// offsets: the int64 exclusive scan of hist (same layout); the outputs hold
// every live row.  Returns cudaGetLastError().
extern "C" int mr_radix_scatter(const void* khi, const void* klo,
                                const void* packed, long long n, int shift,
                                int bits, int groups, const void* group_ends,
                                const void* offsets, void* out_hi,
                                void* out_lo, void* out_pk, void* stream) {
  if (bad_args(n, shift, bits, groups, group_ends))
    return static_cast<int>(cudaErrorInvalidValue);
  radix_scatter<<<static_cast<unsigned>(mr_radix_grid(n)), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(khi), static_cast<const int64_t*>(klo),
      static_cast<const int64_t*>(packed), n, shift, bits, groups,
      static_cast<const long long*>(group_ends),
      static_cast<const long long*>(offsets), static_cast<int64_t*>(out_hi),
      static_cast<int64_t*>(out_lo), static_cast<int64_t*>(out_pk));
  return static_cast<int>(cudaGetLastError());
}
