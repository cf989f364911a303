// Staging of contiguous float ranges between device memory and shared
// memory, for the scan kernels K1 and K2 (kalman_scan.cu) and K4b
// (suffix_scan.cu), the adjoint's kernels K5a/K5b (adjoint.cu) and the
// smoothing elements K7 (smoothing.cu).
//
// A range [first, first + count) of a float array is staged into a slot of
// shared memory from the 16-byte boundary at or below `first`: the range
// starts lead(first) floats into its slot, so that global and shared
// addresses agree modulo 16 bytes and every whole 16-byte unit moves as one
// cp.async (in) or one float4 store (out).  Going in, a unit may carry up
// to three floats on either side of the range (harmless: they lie inside
// the array and are never read back); going out, only the range's own
// floats are written, the ragged units one float at a time.  The array's
// base pointer must be 16-byte aligned (the launchers check it).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <initializer_list>

namespace gpar {

// Floats between the 16-byte boundary at or below `first` and `first`.
__device__ __forceinline__ int lead(long long first) { return static_cast<int>(first & 3); }

// Floats of a slot that holds a range of at most `count` floats at any lead:
// whole 16-byte units.
__host__ __device__ constexpr int slot_floats(int count) { return (count + 3 + 3) / 4 * 4; }

// Unit u (16 bytes) of the range [first, first + count) of src (`total`
// floats) into its slot `dst`, asynchronously; units past the range copy
// nothing.
__device__ __forceinline__ void unit_in(float* dst, const float* __restrict__ src,
                                        long long first, int count, long long total, int u) {
  const long long g = (first & ~3LL) + 4LL * u;
  if (g >= first + count) return;
  if (g + 4 <= total) {
    __pipeline_memcpy_async(dst + 4 * u, src + g, 16);
  } else {  // the array's last, partial unit
    for (int e = 0; g + e < total; ++e) __pipeline_memcpy_async(dst + 4 * u + e, src + g + e, 4);
  }
}

// Unit u of the range [first, first + count) from its slot `src` out to dst.
__device__ __forceinline__ void unit_out(float* __restrict__ dst, const float* src,
                                         long long first, int count, int u) {
  const long long g = (first & ~3LL) + 4LL * u, end = first + count;
  if (g >= end) return;
  if (g >= first && g + 4 <= end) {
    *reinterpret_cast<float4*>(dst + g) = *reinterpret_cast<const float4*>(src + 4 * u);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (g + e >= first && g + e < end) dst[g + e] = src[4 * u + e];
  }
}

// Chunks of a time block of len steps from step `start`: chunk c is the
// part of the window [o + c CH, o + (c + 1) CH) of the block's rows that
// lies in [0, len), where the origin o in (-CH, 0] is
//   - where `aligned`, minus start modulo CH: aligning the windows to the
//     series, not to the block, starts every chunk after a block's first on
//     a step that is a multiple of CH -- for CH = 8, a 32-byte boundary of
//     every per-step array of 1, d or d^2 floats (and of d C floats) -- so
//     that chunks meet inside a time block on whole sectors, at the price
//     of one more chunk in most blocks;
//   - else len less whole chunks, so that only the block's first chunk is
//     short.
// window_origin() gives o, windows() the block's chunk count, window()
// chunk c's rows (none if <= 0, as for c < 0 or past the block) and its
// first row lo.  The arithmetic is 32-bit: the copy loops run it per unit.
template <int CH>
__device__ __forceinline__ int window_origin(long long start, int len, bool aligned) {
  return aligned ? -static_cast<int>(start % CH) : len - CH * ((len + CH - 1) / CH);
}

template <int CH>
__device__ __forceinline__ int windows(int origin, int len) {
  return len > 0 ? (len - origin + CH - 1) / CH : 0;
}

template <int CH>
__device__ __forceinline__ int window(int origin, int len, int c, int& lo) {
  lo = max(0, origin + c * CH);
  return min(len, origin + (c + 1) * CH) - lo;
}

// One array's ranges of a chunk over the nbk time blocks of a CUDA block,
// W floats per step: chunk(j, k0) returns time block j's rows in the chunk
// (none if <= 0) and sets its first step k0; block j's slot is SLOT floats
// at slots + j SLOT.  Threads tid, tid + nthr, ... take the units in turn,
// so neighbouring threads copy neighbouring units of a range.
template <int W, int SLOT, class Chunk>
__device__ __forceinline__ void ranges_in(float* slots, const float* __restrict__ src,
                                          long long n, int nbk, Chunk chunk, int tid, int nthr) {
  constexpr int U = SLOT / 4;
  for (int r = tid; r < nbk * U; r += nthr) {
    const int j = r / U, u = r - j * U;
    long long k0;
    const int rows = chunk(j, k0);
    if (rows > 0) unit_in(slots + j * SLOT, src, k0 * W, rows * W, n * W, u);
  }
}

template <int W, int SLOT, class Chunk>
__device__ __forceinline__ void ranges_out(float* __restrict__ dst, const float* slots, int nbk,
                                           Chunk chunk, int tid, int nthr) {
  constexpr int U = SLOT / 4;
  for (int r = tid; r < nbk * U; r += nthr) {
    const int j = r / U, u = r - j * U;
    long long k0;
    const int rows = chunk(j, k0);
    if (rows > 0) unit_out(dst, slots + j * SLOT, k0 * W, rows * W, u);
  }
}

// Stage the range [first, first + count) of src (total floats) into its
// slot dst (above): all threads, 16-byte cp.async units.
__device__ __forceinline__ void stage_range(float* dst, const float* __restrict__ src,
                                            long long first, int count, long long total,
                                            int tid, int nthr) {
  if (count <= 0) return;
  const int units = (lead(first) + count + 3) / 4;
  for (int u = tid; u < units; u += nthr) unit_in(dst, src, first, count, total, u);
}

// Store the range [first, first + count) of dst from its slot src.
__device__ __forceinline__ void store_range(float* __restrict__ dst, const float* src,
                                            long long first, int count, int tid, int nthr) {
  if (count <= 0) return;
  const int units = (lead(first) + count + 3) / 4;
  for (int u = tid; u < units; u += nthr) unit_out(dst, src, first, count, u);
}

// True when every non-NULL pointer is 16-byte aligned.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<unsigned long long>(p) % 16 != 0) return false;
  return true;
}

}  // namespace gpar
