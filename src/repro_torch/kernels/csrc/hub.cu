// Hub-side bottom-up (pull) first-hit scan, batched over query lanes.
//
// Replaces: src/repro/kernels/hub.py, hub_bottomup_batch_pallas (its
// _hub_bottomup_batch_kernel), and hub_bottomup_pallas as a launch with one
// lane. Same function as bottomup.cu: for every lane and hub ELL row, found
// = 1 iff some slot < deg[lane, row] is a frontier vertex of that lane, and
// the parent is the clipped neighbour id at the LOWEST such slot (INT_MAX
// when there is none). The TPU kernel scans the whole row at once and takes
// an argmax; that is the same lowest hitting slot.
//
// Bound on the H100: bytes, and latency of the dependent gathers. Hub rows
// are few but wide (up to 262,144 slots at RMAT scale 22, and about 10^5
// rows above the default hub floor), so a warp walking one row in order,
// as bottomup.cu does, would wait on one 32-slot gather after another.
//
// Design: one block of 8 warps per (lane, row); the grid's x axis is rows
// and its y axis is lanes. A row of degree 0 in this lane (settled, or the
// lane is outside the cohort) returns at once. Otherwise warp k takes the
// 32-slot chunks k, k + 8, k + 16, ... in slot order; on each it gathers
// frontier[lane, clip(nbr, 0, V-1)] and takes __ballot_sync over
// `slot < deg && byte != 0`. A warp with a hit puts its lowest slot into
// the block's shared minimum with atomicMin and stops; a warp whose next
// chunk starts past that minimum stops too, since every slot it would read
// is higher. The block's minimum is then the lowest hitting slot of the
// whole row: the warp that owns it can only stop at or after its chunk.
// Thread 0 writes found and the parent read at that slot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int32_t kIntMax = 2147483647;

__device__ __forceinline__ int32_t clip(int64_t c, int64_t v) {
  return static_cast<int32_t>(c < 0 ? 0 : (c >= v ? v - 1 : c));
}

__global__ void hub_bottomup_batch_kernel(
    const int32_t* __restrict__ deg, const int32_t* __restrict__ nbrs,
    const uint8_t* __restrict__ frontier, uint8_t* __restrict__ found,
    int32_t* __restrict__ parent, int64_t r, int64_t w, int64_t v) {
  const int64_t row = blockIdx.x;
  const int64_t lane = blockIdx.y;
  const int64_t out = lane * r + row;
  int64_t d = deg[out];
  if (d > w) d = w;
  if (d <= 0) {  // block-uniform
    if (threadIdx.x == 0) {
      found[out] = 0;
      parent[out] = kIntMax;
    }
    return;
  }
  __shared__ int32_t best;  // lowest hitting slot found so far
  if (threadIdx.x == 0) best = kIntMax;
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int slot_in_warp = threadIdx.x & 31;
  const int32_t* nrow = nbrs + row * w;
  const uint8_t* fr = frontier + lane * v;
  for (int64_t base = warp * 32; base < d; base += kThreads) {
    // Lane 0's read, broadcast, keeps the exit warp-uniform.
    const int32_t seen = __shfl_sync(
        0xFFFFFFFFu, *static_cast<volatile int32_t*>(&best), 0);
    if (base > seen) break;
    const int64_t slot = base + slot_in_warp;
    bool hit = false;
    if (slot < d) hit = fr[clip(nrow[slot], v)] != 0;
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, hit);
    if (mask) {
      if (slot_in_warp == 0) {
        atomicMin(&best, static_cast<int32_t>(base + __ffs(mask) - 1));
      }
      break;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int32_t b = best;
    found[out] = b != kIntMax;
    parent[out] = b != kIntMax ? clip(nrow[b], v) : kIntMax;
  }
}

}  // namespace

// deg int32[b, r], nbrs int32[r, w], frontier uint8[b, v], found
// uint8[b, r], parent int32[b, r], all on `device`. The calling thread's
// current device is left as it was. Returns the launch's cudaError_t (0 on
// success).
extern "C" int repro_hub_bottomup_batch(const void* deg, const void* nbrs,
                                        const void* frontier, void* found,
                                        void* parent, int64_t b, int64_t r,
                                        int64_t w, int64_t v, int device,
                                        void* stream) {
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const dim3 grid(static_cast<unsigned>(r), static_cast<unsigned>(b));
  hub_bottomup_batch_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(nbrs),
      static_cast<const uint8_t*>(frontier), static_cast<uint8_t*>(found),
      static_cast<int32_t*>(parent), r, w, v);
  const cudaError_t err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
