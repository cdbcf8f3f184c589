// Fused frontier pack + statistics, batched over query lanes.
//
// Replaces: src/repro/kernels/frontier_fused.py, frontier_fused_batch_pallas
// (its _fused_batch_kernel), the TPU kernel that packs each lane's next
// frontier into a uint32 bitmap and sums nf (set flags) and mf (degree mass
// of the set flags) in one pass.
//
// Bound on the H100: bytes. Each lane's V flag bytes are read once, the
// shared degree array is read only for 32-flag words with a set bit, and
// the V/8 bitmap bytes are written once. There is no arithmetic to speak of.
//
// Design: one thread packs 32 consecutive flags (two 16-byte loads) into
// one word, so a warp reads 1 KiB of contiguous flags per step. The TPU
// kernel carried nf/mf across its sequential grid and re-zeroed them at each
// lane's first block; Hopper runs blocks in no order, so each block reduces
// its counts in registers and shared memory and adds them with one integer
// atomicAdd each into nf[lane] and mf[lane], which the caller zeroes first.
// Integer addition modulo 2^32 gives the same sum in any order, so the
// result is the reference's bit for bit, int32 wraparound included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t pack4(uint32_t x, int base) {
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if ((x >> (8 * k)) & 0xFFu) bits |= 1u << (base + k);
  }
  return bits;
}

__global__ void frontier_fused_batch_kernel(
    const uint8_t* __restrict__ flags, const int32_t* __restrict__ deg,
    uint32_t* __restrict__ packed, unsigned int* __restrict__ nf,
    unsigned int* __restrict__ mf, int64_t v, int64_t nwords) {
  const int64_t lane = blockIdx.y;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t cnt = 0, mass = 0;
  if (w < nwords) {
    const uint4* src = reinterpret_cast<const uint4*>(flags + lane * v + w * 32);
    const uint4 lo = src[0];
    const uint4 hi = src[1];
    const uint32_t part[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t word = 0;
#pragma unroll
    for (int p = 0; p < 8; ++p) word |= pack4(part[p], 4 * p);
    packed[lane * nwords + w] = word;
    cnt = __popc(word);
    if (word) {
      const int4* d4 = reinterpret_cast<const int4*>(deg + w * 32);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int4 d = d4[q];
        const uint32_t nib = word >> (4 * q);
        if (nib & 1u) mass += static_cast<uint32_t>(d.x);
        if (nib & 2u) mass += static_cast<uint32_t>(d.y);
        if (nib & 4u) mass += static_cast<uint32_t>(d.z);
        if (nib & 8u) mass += static_cast<uint32_t>(d.w);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
    mass += __shfl_down_sync(0xFFFFFFFFu, mass, off);
  }
  __shared__ uint32_t s_cnt[kThreads / 32];
  __shared__ uint32_t s_mass[kThreads / 32];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    s_cnt[warp] = cnt;
    s_mass[warp] = mass;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t c = 0, m = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      c += s_cnt[i];
      m += s_mass[i];
    }
    if (c) atomicAdd(nf + lane, c);
    if (m) atomicAdd(mf + lane, m);
  }
}

}  // namespace

// flags uint8[b, v] (v a multiple of 32, rows 16-byte aligned), deg int32[v],
// packed uint32[b, v/32], nf/mf int32[b] zeroed by the caller, all on
// `device`. The calling thread's current device is left as it was.
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_frontier_fused_batch(const void* flags, const void* deg,
                                          void* packed, void* nf, void* mf,
                                          int64_t b, int64_t v, int device,
                                          void* stream) {
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const int64_t nwords = v / 32;
  const dim3 grid(static_cast<unsigned>((nwords + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b));
  frontier_fused_batch_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flags), static_cast<const int32_t*>(deg),
      static_cast<uint32_t*>(packed), static_cast<unsigned int*>(nf),
      static_cast<unsigned int*>(mf), v, nwords);
  const cudaError_t err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
