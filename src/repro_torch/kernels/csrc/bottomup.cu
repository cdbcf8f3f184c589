// Bottom-up (pull) first-hit scan, batched over query lanes.
//
// Replaces: src/repro/kernels/bottomup.py, bottomup_batch_pallas (its
// _bottomup_batch_kernel). For every lane and ELL row: is some slot
// < deg[lane, row] a frontier vertex of that lane? If so, found = 1 and the
// parent is the clipped neighbour id at the LOWEST such slot (the first
// hit); otherwise found = 0 and parent = INT_MAX. The tile is shared across
// lanes; a lane outside the bottom-up cohort, and a settled row, carry
// degree 0 and cost nothing.
//
// Bound on the H100: bytes, and latency of the dependent gathers. Each step
// reads 32 neighbour ids of a row and then one frontier byte per id at a
// random address. The frontier bytes of 8 lanes at scale 22 are 32 MiB,
// which fits the 50 MB L2, so the gathers mostly hit L2.
//
// Design: one warp per (lane, row); the grid's x axis is row groups of 8
// warps and its y axis is lanes. Each step the warp reads 32 consecutive
// ids of the row (one coalesced 128-byte load), gathers
// frontier[lane, clip(nbr, 0, V-1)], and takes __ballot_sync over
// `slot < deg && byte != 0`. On the first nonzero ballot the parent is the
// id at slot 32*step + __ffs(mask) - 1 and the row is done. This is the
// TPU kernel's per-block early exit at the grain of one row: the reference's
// slab loop plus argmax also returns the lowest hitting slot, so found and
// parent match it bit for bit whatever its slab width.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int32_t kIntMax = 2147483647;

__global__ void bottomup_batch_kernel(
    const int32_t* __restrict__ deg, const int32_t* __restrict__ nbrs,
    const uint8_t* __restrict__ frontier, uint8_t* __restrict__ found,
    int32_t* __restrict__ parent, int64_t r, int64_t w, int64_t v) {
  const int64_t lane = blockIdx.y;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int slot_in_warp = threadIdx.x & 31;
  if (row >= r) return;  // warp-uniform
  int64_t d = deg[lane * r + row];
  if (d > w) d = w;
  const int32_t* nrow = nbrs + row * w;
  const uint8_t* fr = frontier + lane * v;
  uint8_t hit_any = 0;
  int32_t par = kIntMax;
  for (int64_t base = 0; base < d; base += 32) {  // trip count warp-uniform
    const int64_t slot = base + slot_in_warp;
    int32_t n = 0;
    bool hit = false;
    if (slot < d) {
      int64_t c = nrow[slot];
      c = c < 0 ? 0 : (c >= v ? v - 1 : c);
      n = static_cast<int32_t>(c);
      hit = fr[c] != 0;
    }
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, hit);
    if (mask) {
      const int first = __ffs(mask) - 1;
      par = __shfl_sync(0xFFFFFFFFu, n, first);
      hit_any = 1;
      break;
    }
  }
  if (slot_in_warp == 0) {
    found[lane * r + row] = hit_any;
    parent[lane * r + row] = par;
  }
}

}  // namespace

// deg int32[b, r], nbrs int32[r, w], frontier uint8[b, v], found
// uint8[b, r], parent int32[b, r], all on `device`. The calling thread's
// current device is left as it was. Returns the launch's cudaError_t (0 on
// success).
extern "C" int repro_bottomup_batch(const void* deg, const void* nbrs,
                                    const void* frontier, void* found,
                                    void* parent, int64_t b, int64_t r,
                                    int64_t w, int64_t v, int device,
                                    void* stream) {
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const dim3 grid(static_cast<unsigned>((r + kWarps - 1) / kWarps),
                  static_cast<unsigned>(b));
  bottomup_batch_kernel<<<grid, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(nbrs),
      static_cast<const uint8_t*>(frontier), static_cast<uint8_t*>(found),
      static_cast<int32_t*>(parent), r, w, v);
  const cudaError_t err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
