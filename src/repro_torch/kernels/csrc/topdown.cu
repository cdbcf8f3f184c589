// Top-down (push) visited-gather, batched over query lanes.
//
// Replaces: src/repro/kernels/topdown.py, topdown_batch_pallas (its
// _topdown_batch_kernel), and topdown_pallas as a launch with one lane.
// For every lane, ELL row and slot:
//   fresh[lane, row, col] = col < deg[lane, row] && visited[lane, clip(nbr)] == 0
// with the tile shared across lanes and the lane's cohort membership folded
// into its degrees (a lane outside the top-down cohort has all-zero degrees).
// topdown_pallas also returns dst[row, col] = clip(nbr, 0, V-1) for every
// slot, live or not; given a dst pointer (null in the batch launch), lane 0
// writes it.
//
// Bound on the H100: bytes, and above all the output. The [B, C, W] fresh
// array is written in full at every top-down level, even when the frontier
// is a few rows; the reads (the degrees, the tile rows of frontier vertices
// and one visited byte per live slot) are a fraction of that.
//
// Design: one thread per (lane, row, 16 consecutive slots). A row whose
// degree is 0 in this lane (not in the frontier, or out of the cohort)
// writes zeros without touching the tile or the visited bytes, as
// the TPU kernel's pl.when skip did for an all-zero block. A live thread
// reads its 16 neighbour ids (neighbouring threads on neighbouring 64-byte
// pieces of the row), gathers one visited byte per live slot, and writes the
// 16 fresh bytes with one 16-byte store when the width allows it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 16;

__global__ void topdown_batch_kernel(
    const int32_t* __restrict__ deg, const int32_t* __restrict__ nbrs,
    const uint8_t* __restrict__ visited, uint8_t* __restrict__ fresh,
    int32_t* __restrict__ dst_ids, int64_t c, int64_t w, int64_t v,
    int64_t chunks, int vec) {
  const int64_t lane = blockIdx.y;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= c * chunks) return;
  const int64_t row = t / chunks;
  const int64_t col0 = (t - row * chunks) * kSlots;
  const int32_t d = deg[lane * c + row];
  const int32_t* nrow = nbrs + row * w;
  if (dst_ids != nullptr && lane == 0) {
    int32_t* drow = dst_ids + row * w;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int64_t col = col0 + k;
      if (col < w) {
        const int64_t n = nrow[col];
        drow[col] = static_cast<int32_t>(n < 0 ? 0 : (n >= v ? v - 1 : n));
      }
    }
  }
  uint8_t out[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) out[k] = 0;
  if (d > 0) {
    const uint8_t* vis = visited + lane * v;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int64_t col = col0 + k;
      if (col < d && col < w) {
        int64_t n = nrow[col];
        n = n < 0 ? 0 : (n >= v ? v - 1 : n);
        out[k] = vis[n] == 0 ? 1 : 0;
      }
    }
  }
  uint8_t* dst = fresh + (lane * c + row) * w + col0;
  if (vec) {
    uint4 packed;
    uint32_t* words = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      words[q] = static_cast<uint32_t>(out[4 * q]) |
                 (static_cast<uint32_t>(out[4 * q + 1]) << 8) |
                 (static_cast<uint32_t>(out[4 * q + 2]) << 16) |
                 (static_cast<uint32_t>(out[4 * q + 3]) << 24);
    }
    *reinterpret_cast<uint4*>(dst) = packed;
  } else {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (col0 + k < w) dst[k] = out[k];
    }
  }
}

}  // namespace

// deg int32[b, c], nbrs int32[c, w], visited uint8[b, v], fresh
// uint8[b, c, w], and dst int32[c, w] or null, all on `device`. `vec` = 1
// takes 16-byte stores: w a multiple of 16 and `fresh` 16-byte aligned. The
// calling thread's current device is left as it was. Returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_topdown_batch(const void* deg, const void* nbrs,
                                   const void* visited, void* fresh,
                                   void* dst, int64_t b, int64_t c, int64_t w,
                                   int64_t v, int vec, int device,
                                   void* stream) {
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const int64_t chunks = (w + kSlots - 1) / kSlots;
  const int64_t threads = c * chunks;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b));
  topdown_batch_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(nbrs),
      static_cast<const uint8_t*>(visited), static_cast<uint8_t*>(fresh),
      static_cast<int32_t*>(dst), c, w, v, chunks, vec);
  const cudaError_t err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
