// Top-down (push), batched over query lanes: two entry points of one source.
//
// Replaces: src/repro/kernels/topdown.py, topdown_batch_pallas (its
// _topdown_batch_kernel), and topdown_pallas as a launch with one lane,
// together with the scatter-min that their callers run after them
// (src/repro/core/bfs.py, _top_down_step_kernels_batch and
// _top_down_step_kernels).
//
// 1. The fresh entry (repro_topdown_batch) is the TPU kernel's function:
//      fresh[lane, row, col] = col < deg[lane, row] &&
//                              visited[lane, clip(nbr)] == 0
//    with the tile shared across lanes and the lane's cohort membership
//    folded into its degrees (a lane outside the top-down cohort has
//    all-zero degrees). topdown_pallas also returns dst[row, col] =
//    clip(nbr, 0, V-1) for every slot, live or not; given a dst pointer
//    (null in the batch launch), lane 0 writes it. One thread per (lane,
//    row, 16 slots); a dead row writes zeros without reading the tile.
//    Bound by its output: the [B, C, W] array is written in full. No path
//    launches it; it is held against its plain version.
//
// 2. The push entry (repro_topdown_push) is what the BFS steps launch. It
//    does the visited-gather and the parent scatter-min in one pass:
//      for every lane, row and col < deg[lane, row], n = clip(nbr, 0, V-1):
//        if visited[lane, n] == 0 and (no keep or keep[n] != 0):
//          pcand[lane, n] = min(pcand[lane, n], rows[row])
//    which is the reference's `pcand.at[:, dst].min(where(fresh, rows,
//    INT_MAX))` over this tile. A min does not depend on order, so the
//    result is the same bits whatever order the atomics land in. The TPU
//    has no atomics, so the reference writes the whole [B, C, W] fresh
//    array and scatters every slot of every row; on this card atomicMin in
//    L2 is native, and only live (frontier) rows do work.
//
//    Bound on the H100: bytes, and of those mostly the degrees. A top-down
//    level's frontier is a small share of the rows, so what a call must
//    move is the [B, R] degrees, the ids of the live rows up to their
//    largest live degree, one visited byte per live (lane, slot), and a
//    read and a write of pcand per fresh target. The gathers are random
//    (32-byte sectors for a byte) and the atomics land on the vertices
//    that frontier rows share.
//
//    Design: persistent blocks of 256 threads (as many as the SMs hold,
//    from the occupancy calculator) stride over warp tiles. A work item is
//    a (row, 32-slot chunk), so that a hub row of 262,144 slots spreads
//    over 8,192 items and many warps. Each warp takes 32 items:
//    - the degree pass, one item a thread: the row's degrees for the
//      block's lanes (coalesced: neighbouring threads, neighbouring rows),
//      kept in shared memory, and the mask of lanes live in this chunk. A
//      dead item stops there: no id, visited or pcand byte is read.
//    - the live slots of the warp's items are laid end to end (a warp
//      prefix sum of each item's slots up to its largest live degree) and
//      dealt out 32 at a time, so a warp of degree-2 rows keeps its threads
//      busy; a thread finds its item by a binary search over the prefix
//      sums (shuffles). Padding past a row's largest live degree is never
//      read.
//    - a slot: its id, read once for all lanes; keep[n]; then the visited
//      byte of each live lane (all in flight together); then, for each
//      lane where n is fresh, a plain load of pcand skips the atomic where
//      it already holds a smaller id (pcand only falls, so a stale read is
//      never below the truth), else atomicMin.
//    A block takes up to 16 lanes (instances of 1, 8 and 16, as the pull
//    kernel's); more lanes go to further blocks along grid y. A 32-lane
//    instance took 128 registers and spilled.

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

namespace push {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;            // slots a work item
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t* deg;       // [b, r]
  const int32_t* nbrs;      // [r, w]
  const int32_t* rows;      // [r]
  const uint8_t* visited;   // [b, v]
  int32_t* pcand;           // [b, v], in place
  const uint8_t* keep;      // [v] or null
  int64_t b, r, w, v;
  int64_t chunks;           // work items a row: ceil(w / kChunk)
  int64_t tiles;            // warp tiles: ceil(r * chunks / 32)
};

template <int kLanes>
__global__ void __launch_bounds__(kThreads) push_kernel(const Args a) {
  __shared__ int32_t sdeg[kWarps][kLanes][32];   // a warp's items' degrees
  const int64_t lane0 = static_cast<int64_t>(blockIdx.y) * kLanes;
  const int64_t left = a.b - lane0;
  const int lanes = left < kLanes ? static_cast<int>(left) : kLanes;
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int64_t items = a.r * a.chunks;
  const int wmax = a.w < (1 << 30) ? static_cast<int>(a.w) : (1 << 30);
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       tile < a.tiles; tile += static_cast<int64_t>(gridDim.x) * kWarps) {
    // Degree pass: one item a thread.
    const int64_t item = tile * 32 + t;
    int64_t row = 0;
    int col0 = 0, cnt = 0;
    unsigned mask = 0;
    int32_t src = 0;
    if (item < items) {
      row = a.chunks == 1 ? item : item / a.chunks;
      col0 = static_cast<int>(item - row * a.chunks) * kChunk;
      int dmax = 0;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        int d = 0;
        if (l < lanes) {
          d = __ldg(a.deg + (lane0 + l) * a.r + row);
          d = d < wmax ? d : wmax;
        }
        sdeg[warp][l][t] = d;
        if (d > col0) {
          mask |= 1u << l;
          dmax = d > dmax ? d : dmax;
        }
      }
      if (mask != 0) {
        cnt = dmax - col0 < kChunk ? dmax - col0 : kChunk;
        src = __ldg(a.rows + row);
      }
    }
    __syncwarp();
    // The items' live slots end to end: inclusive prefix sum over the warp.
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (t >= o) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    for (int k = 0; k < total; k += 32) {
      const int j = k + t;
      // The item holding slot j: the number of items whose prefix sum is
      // <= j (below 32, as j < total).
      int i = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(kFull, incl, i + step - 1) <= j) i += step;
      }
      const int first = __shfl_sync(kFull, incl - cnt, i);
      const unsigned m = __shfl_sync(kFull, mask, i);
      const int64_t irow = __shfl_sync(kFull, row, i);
      const int c0 = __shfl_sync(kFull, col0, i);
      const int32_t isrc = __shfl_sync(kFull, src, i);
      if (j >= total) continue;
      const int col = c0 + (j - first);
      int64_t n = __ldg(a.nbrs + irow * a.w + col);
      n = n < 0 ? 0 : (n >= a.v ? a.v - 1 : n);
      if (a.keep != nullptr && __ldg(a.keep + n) == 0) continue;
      unsigned fresh = 0;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        if (((m >> l) & 1u) && col < sdeg[warp][l][i] &&
            __ldg(a.visited + (lane0 + l) * a.v + n) == 0) {
          fresh |= 1u << l;
        }
      }
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        if ((fresh >> l) & 1u) {
          int32_t* p = a.pcand + (lane0 + l) * a.v + n;
          if (*p > isrc) atomicMin(p, isrc);
        }
      }
    }
    __syncwarp();   // the items' degrees stay until every slot is done
  }
}

template <int kLanes>
cudaError_t launch(const Args& a, int device, cudaStream_t stream) {
  // Blocks the SMs hold at once, asked once per (device, instance).
  static int resident[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (resident[device] <= 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, push_kernel<kLanes>, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t groups = (a.b + kLanes - 1) / kLanes;
  const int64_t want = (resident[device] + groups - 1) / groups;
  const int64_t need = (a.tiles + kWarps - 1) / kWarps;
  const int64_t blocks = need < want ? need : want;
  const dim3 grid(static_cast<unsigned>(blocks > 0 ? blocks : 1),
                  static_cast<unsigned>(groups));
  push_kernel<kLanes><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace push

// The push: deg int32[b, r] (lane-masked), nbrs int32[r, w], rows int32[r],
// visited uint8[b, v], pcand int32[b, v] (updated in place) and keep
// uint8[v] or null, all on `device`; b up to 65,535 x 16. The calling
// thread's current device is left as it was. Returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_topdown_push(const void* deg, const void* nbrs,
                                  const void* rows, const void* visited,
                                  void* pcand, const void* keep, int64_t b,
                                  int64_t r, int64_t w, int64_t v, int device,
                                  void* stream) {
  if (b < 1 || r < 1 || w < 1 || v < 1 || (b + 15) / 16 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const int64_t chunks = (w + push::kChunk - 1) / push::kChunk;
  const push::Args a{
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(nbrs),
      static_cast<const int32_t*>(rows), static_cast<const uint8_t*>(visited),
      static_cast<int32_t*>(pcand), static_cast<const uint8_t*>(keep),
      b, r, w, v, chunks, (r * chunks + 31) / 32};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      b == 1 ? push::launch<1>(a, device, s)
             : (b <= 8 ? push::launch<8>(a, device, s)
                       : push::launch<16>(a, device, s));
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
