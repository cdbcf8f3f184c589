// Bottom-up (pull) first-hit scan, batched over query lanes: the kernel
// of both pull wrappers.
//
// Replaces: src/repro/kernels/bottomup.py, bottomup_batch_pallas (its
// _bottomup_batch_kernel) and bottomup_pallas (a launch with one lane), and
// src/repro/kernels/hub.py, hub_bottomup_batch_pallas (its
// _hub_bottomup_batch_kernel) and hub_bottomup_pallas. The TPU needed two
// kernels (a slab loop with a per-block early exit for the narrow buckets,
// a dense scan and argmax for the few wide hub rows); here one kernel and
// one plan (`kernels/bottomup.py` `pull_plan`) take every width. Function:
// for every lane and ELL row, found = 1 iff some slot < deg[lane, row]
// holds a frontier vertex of that lane, and the parent is the clipped
// neighbour id at the LOWEST such slot (INT_MAX when there is none); the
// references' slab loop and argmax return that slot too, so found and
// parent match them bit for bit.
//
// Bound on the H100: latency, not bytes. What a call must move is small
// (the [B, R] degrees in, found and parent out, the ids of the live rows up
// to their first hit, one frontier byte per id read; 171 MB at the base
// bucket of RMAT scale 22 with 8 lanes, 0.051 ms at 3.35 TB/s), but each
// pair is a chain of dependent loads: its degree, then its ids, then the
// frontier bytes they name (random), and a row without a hit runs the
// chain to its last slot. One warp per (lane, row), as in the first port,
// ran some 1,900 rounds of that chain at the base bucket; one block per
// (lane, row) for the hub spent its time launching blocks that read one
// degree and exit.
//
// What the data looks like at a bottom-up level of RMAT (rows sorted by
// neighbour degree, so hubs come first): at scale 22, 8 lanes, the base
// bucket (1,977,973 rows of 32 slots), 74% of the (lane, row) pairs are
// live and 95% of their hits are at slot 0; the rest of the live pairs
// mostly have no hit and must scan their whole degree. Hub rows hit at slot
// 0 almost always. So a pair needs one slot, or all of its slots.
//
// Design (the launch shape from `kernels/bottomup.py` `pull_plan`):
// - Persistent blocks of 256 threads, as many as the SMs hold (occupancy
//   calculator, `repro_bottomup_resident`), stride over tiles of `rows`
//   rows x `lanes` lanes; the plan shrinks a tile below 256 x kLanes only
//   when the tiles would not fill the card, so a few wide rows still
//   spread over the SMs.
// - Lane words: with 8 or 16 lanes and rows enough to pay for it (R >=
//   V / 16), a first kernel packs the [B, V] frontier bytes into one word a
//   vertex, bit j for lane j, so that one gather tells which of a row's
//   lanes hold a vertex; otherwise each wanted lane's byte is gathered.
// - Tier 1, one thread a row: the row's degrees for the tile's lanes
//   (coalesced: neighbouring threads, neighbouring rows), then, if any is
//   live, its first 4 ids, read once for all lanes (one 16-byte load where
//   rows are 16-byte aligned), then one gather a slot (lane words) or a
//   slot and live lane, all in flight together. Taking the slots in order,
//   a lane's first hit is the first slot whose mask holds its bit.
// - Tier 2, the same thread: the row's lanes still open, slots 4 ..
//   `thread_slots` (a base-bucket row whole), 16 a step (8 with one lane,
//   for registers), the step's ids and gathers in flight together.
// - Tier 3, one warp a (lane, row) still open: 128 slots a step up to
//   `warp_slots`; a ballot of "my 4 slots hold a hit", the lowest such
//   thread holding the first hit.
// - Tier 4, the whole block on a pair still open: warp k takes the 128-slot
//   chunks k, k + 8, ... in slot order; a warp with a hit puts its lowest
//   slot into the block's shared minimum with atomicMin and stops, and a
//   warp whose next chunk starts past that minimum stops too; the minimum
//   is then the lowest hitting slot (the warp owning it cannot stop before
//   its chunk).
// - Results go to shared memory and leave, each lane's rows in one
//   coalesced run, when the tile is done (one lane's are written directly:
//   neighbouring threads already hold neighbouring rows).
// Each (lane, row) is written exactly once. A dead pair costs a predicate
// on its coalesced degree load. Registers bound the blocks an SM holds
// (3 of 256 threads with lane words, 4 with one lane; more spill).

#include <cuda_runtime.h>
#include <stdint.h>

namespace pull {

constexpr int kThreads = 256;          // a tile's rows at most, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kFirst = 4;              // tier 1's slots: one 16-byte load
// Tier 2's slots a step: 16 with several lanes, 8 for one lane (fewer
// registers, so more blocks resident). thread_slots - kFirst must be a
// multiple of it.
template <int kLanes>
constexpr int kDeep = kLanes == 1 ? 8 : 16;
constexpr int kChunk = 128;            // tiers 3 and 4: slots a warp step
constexpr int32_t kIntMax = 2147483647;
constexpr unsigned kAll = 0xFFFFFFFFu;

struct Args {
  const int32_t* deg;       // [b, r]
  const int32_t* nbrs;      // [r, w]
  const uint8_t* frontier;  // [b, v]
  const void* packed;       // [ceil(b / kLanes), v] lane bits, or null
  uint8_t* found;           // [b, r]
  int32_t* parent;          // [b, r]
  int64_t b, r, w, v;
  int64_t thread_slots;     // tier 2 ends here
  int64_t warp_slots;       // tier 3 ends here
  int rows, lanes;          // a tile: rows <= kThreads, lanes <= kLanes
  bool vec;                 // rows 16-byte aligned: int4 id loads
};

// The packed frontier's word: one bit a lane of a lane block.
template <int kLanes> struct Word { using T = uint8_t; };
template <> struct Word<16> { using T = uint16_t; };

__device__ __forceinline__ int32_t clip(int32_t c, int64_t v) {
  return c < 0 ? 0 : (c >= v ? static_cast<int32_t>(v - 1) : c);
}

// ids at slots s0 .. s0 + 3 of a row (s0 a multiple of 4, s0 < w)
__device__ __forceinline__ void load4(const Args& a, const int32_t* nrow,
                                      int64_t s0, int32_t* ids) {
  if (a.vec) {
    const int4 q = *reinterpret_cast<const int4*>(nrow + s0);
    ids[0] = q.x, ids[1] = q.y, ids[2] = q.z, ids[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) ids[k] = s0 + k < a.w ? nrow[s0 + k] : 0;
  }
}

__device__ __forceinline__ int32_t degree(const Args& a, int64_t lane,
                                          int64_t row) {
  const int64_t x = a.deg[lane * a.r + row];
  return static_cast<int32_t>(x < 0 ? 0 : (x > a.w ? a.w : x));
}

// Where a tile's result for lane l0 + j of row row0 + i goes: with more
// than one lane, to shared memory (entry j * kThreads + i), written out
// when the tile is done, each lane's rows in one coalesced run; with one
// lane, where neighbouring threads' rows already lie side by side, to the
// output itself.
struct Out {
  uint8_t* found;
  int32_t* parent;
  bool staged;
  int64_t l0, row0, r;
  __device__ __forceinline__ void put(int j, int i, int32_t par) const {
    const int64_t at = staged ? j * kThreads + i : (l0 + j) * r + row0 + i;
    found[at] = par != kIntMax;
    parent[at] = par;
  }
};

// The lanes among `want` (bit j: lane l0 + j) whose frontier holds vertex
// c: one gather of the packed word, or one byte a wanted lane.
template <int kLanes>
__device__ __forceinline__ unsigned lanes_at(const Args& a, int64_t l0,
                                             int32_t c, unsigned want) {
  if (want == 0) return 0;
  if (kLanes > 1 && a.packed != nullptr) {
    using T = typename Word<kLanes>::T;
    return want & static_cast<const T*>(a.packed)[l0 / kLanes * a.v + c];
  }
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    if ((want >> j) & 1u) {
      m |= static_cast<unsigned>(a.frontier[(l0 + j) * a.v + c] != 0) << j;
    }
  }
  return m;
}

// The lanes whose degree d[j] is above s.
template <int kLanes>
__device__ __forceinline__ unsigned above(const int32_t* d, int64_t s) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) m |= static_cast<unsigned>(d[j] > s) << j;
  return m;
}

// Slots of row i in order: a lane of *open whose bit is in hits[k] takes
// ids[k] as its parent (its first hit) and leaves *open.
template <int kN>
__device__ __forceinline__ void resolve(const Args& a, const Out& out, int i,
                                        const int32_t* ids,
                                        const unsigned* hits,
                                        unsigned* open) {
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    unsigned now = hits[k] & *open;
    *open &= ~now;
    for (; now != 0; now &= now - 1) {
      out.put(__ffs(now) - 1, i, clip(ids[k], a.v));
    }
  }
}

// The lanes of `miss` of row i find nothing.
__device__ __forceinline__ void misses(const Out& out, int i,
                                       unsigned miss) {
  for (; miss != 0; miss &= miss - 1) out.put(__ffs(miss) - 1, i, kIntMax);
}

// Bit k set iff slot s0 + k < d of the row holds a frontier vertex of lane
// l0 + j.
template <int kLanes>
__device__ __forceinline__ unsigned hits4(const Args& a, int64_t l0, int j,
                                          const int32_t* ids, int64_t s0,
                                          int64_t d) {
  unsigned h = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (s0 + k < d && lanes_at<kLanes>(a, l0, clip(ids[k], a.v), 1u << j)) {
      h |= 1u << k;
    }
  }
  return h;
}

// Tier 2 for row `row` (i in the tile), lane degrees d: its lanes `left`,
// slots kFirst .. thread_slots, kDeep a step with the step's ids and
// gathers in flight together. Returns the lanes whose degree goes past
// thread_slots with no hit before it.
template <int kLanes>
__device__ __forceinline__ unsigned thread_scan(const Args& a, const Out& out,
                                                int64_t l0, int64_t row,
                                                int i, unsigned left,
                                                const int32_t* d) {
  const int32_t* nrow = a.nbrs + row * a.w;
  int32_t dmax = 0;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    dmax = (left >> j) & 1u && d[j] > dmax ? d[j] : dmax;
  }
  const int64_t end = dmax < a.thread_slots ? dmax : a.thread_slots;
  constexpr int kN = kDeep<kLanes>;
  for (int64_t s0 = kFirst; s0 < end && left != 0; s0 += kN) {
    int32_t ids[kN];
#pragma unroll
    for (int k = 0; k < kN; k += 4) {
      if (s0 + k < end) {
        load4(a, nrow, s0 + k, ids + k);
      } else {
        ids[k] = ids[k + 1] = ids[k + 2] = ids[k + 3] = 0;
      }
    }
    unsigned h[kN];
    if (kLanes > 1 && a.packed != nullptr) {
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        h[k] = s0 + k < end ? lanes_at<kLanes>(a, l0, clip(ids[k], a.v),
                                               left & above<kLanes>(d, s0 + k))
                            : 0u;
      }
    } else {  // one lane at a time, its kN gathers together
#pragma unroll
      for (int k = 0; k < kN; ++k) h[k] = 0;
      for (unsigned x = left; x != 0; x &= x - 1) {
        const int j = __ffs(x) - 1;
        const int64_t dj = degree(a, l0 + j, row);
        const uint8_t* fr = a.frontier + (l0 + j) * a.v;
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          if (s0 + k < dj && s0 + k < end && fr[clip(ids[k], a.v)] != 0) {
            h[k] |= 1u << j;
          }
        }
      }
    }
    resolve<kN>(a, out, i, ids, h, &left);
    misses(out, i, left & ~above<kLanes>(d, s0 + kN));
    left &= above<kLanes>(d, s0 + kN);
  }
  return left;
}

// Tier 3: slots from .. min(d, to) of lane l0 + j of a row, by one warp
// (every thread of it calls this with the same pair). Returns the parent to
// all threads, or kIntMax with *open set when those slots hold no hit and
// the degree goes past `to`.
template <int kLanes>
__device__ __forceinline__ int32_t warp_scan(const Args& a, int64_t l0,
                                             int j, int64_t row, int64_t d,
                                             int64_t from, int64_t to,
                                             bool* open) {
  const int t = threadIdx.x & 31;
  const int32_t* nrow = a.nbrs + row * a.w;
  const int64_t end = d < to ? d : to;
  for (int64_t base = from; base < end; base += kChunk) {
    const int64_t s0 = base + t * 4;
    int32_t ids[4] = {0, 0, 0, 0};
    if (s0 < end) load4(a, nrow, s0, ids);
    const unsigned h = hits4<kLanes>(a, l0, j, ids, s0, end);
    const unsigned m = __ballot_sync(kAll, h != 0);
    if (m != 0) {
      const int k = h != 0 ? __ffs(h) - 1 : 0;
      const int32_t mine = clip(k == 0   ? ids[0]
                                : k == 1 ? ids[1]
                                : k == 2 ? ids[2]
                                         : ids[3],
                                a.v);
      return __shfl_sync(kAll, mine, __ffs(m) - 1);
    }
  }
  *open = d > to;
  return kIntMax;
}

// Tier 4: slots from .. d of lane l0 + j of row row0 + i, by the whole
// block.
template <int kLanes>
__device__ __forceinline__ void block_scan(const Args& a, const Out& out,
                                           int64_t l0, int j, int64_t row0,
                                           int i, int64_t from,
                                           int32_t* best) {
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x & 31;
  const int64_t row = row0 + i;
  const int64_t d = degree(a, l0 + j, row);
  const int32_t* nrow = a.nbrs + row * a.w;
  if (threadIdx.x == 0) *best = kIntMax;
  __syncthreads();
  for (int64_t base = from + warp * kChunk; base < d;
       base += kWarps * kChunk) {
    // Lane 0's read, broadcast, keeps the exit warp-uniform.
    const int32_t seen =
        __shfl_sync(kAll, *static_cast<volatile int32_t*>(best), 0);
    if (base > seen) break;
    const int64_t s0 = base + t * 4;
    int32_t ids[4] = {0, 0, 0, 0};
    if (s0 < d) load4(a, nrow, s0, ids);
    const unsigned h = hits4<kLanes>(a, l0, j, ids, s0, d);
    const unsigned m = __ballot_sync(kAll, h != 0);
    if (m != 0) {
      if (t == __ffs(m) - 1) {
        atomicMin(best, static_cast<int32_t>(s0 + __ffs(h) - 1));
      }
      break;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int32_t s = *best;
    out.put(j, i, s != kIntMax ? clip(nrow[s], a.v) : kIntMax);
  }
  __syncthreads();  // before the next scan resets *best
}

template <int kLanes>
__global__ void __launch_bounds__(kThreads, kLanes == 1 ? 4 : 3)
    pull_kernel(Args a) {
  constexpr bool kStaged = kLanes > 1;
  __shared__ uint8_t found[kStaged ? kLanes * kThreads : 1];
  __shared__ int32_t parent[kStaged ? kLanes * kThreads : 1];
  // Tier 3's pairs, then tier 4's: the lane (high byte) and row in the tile.
  __shared__ uint16_t queue3[kThreads * kLanes];
  __shared__ uint16_t queue4[kThreads * kLanes];
  __shared__ int n3, n4;
  __shared__ int32_t best;
  const int tid = threadIdx.x;
  const int t = tid & 31;
  const int warp = tid / 32;
  const int64_t lane_tiles = (a.b + a.lanes - 1) / a.lanes;
  const int64_t tiles = (a.r + a.rows - 1) / a.rows * lane_tiles;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile / lane_tiles * a.rows;
    const int64_t l0 = tile % lane_tiles * a.lanes;
    const int64_t row = row0 + tid;
    const bool in = tid < a.rows && row < a.r;
    const Out out{kStaged ? found : a.found, kStaged ? parent : a.parent,
                  kStaged, l0, row0, a.r};
    if (tid == 0) n3 = n4 = 0;
    __syncthreads();
    // Tier 1: one thread a row.
    int32_t d[kLanes];
    unsigned lanes = 0;                    // the tile's lanes, if in
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const bool ok = in && j < a.lanes && l0 + j < a.b;
      lanes |= static_cast<unsigned>(ok) << j;
      d[j] = ok ? degree(a, l0 + j, row) : 0;
    }
    unsigned open = above<kLanes>(d, 0);
    const int32_t* nrow = a.nbrs + (in ? row : 0) * a.w;
    int32_t ids[kFirst] = {0, 0, 0, 0};
    if (open != 0) load4(a, nrow, 0, ids);
    unsigned hits[kFirst];
#pragma unroll
    for (int k = 0; k < kFirst; ++k) {
      hits[k] = lanes_at<kLanes>(a, l0, clip(ids[k], a.v),
                                 above<kLanes>(d, k));
    }
    resolve<kFirst>(a, out, tid, ids, hits, &open);
    misses(out, tid, lanes & ~above<kLanes>(d, 0));
    misses(out, tid, open & ~above<kLanes>(d, kFirst));
    open &= above<kLanes>(d, kFirst);
    // Tier 2: the same thread, the row's open lanes together.
    if (open != 0) {
      for (unsigned left = thread_scan<kLanes>(a, out, l0, row, tid, open, d);
           left != 0; left &= left - 1) {      // past thread_slots
        queue3[atomicAdd(&n3, 1)] =
            static_cast<uint16_t>((__ffs(left) - 1) << 8 | tid);
      }
    }
    __syncthreads();
    // Tier 3: one warp a pair.
    for (int q = warp; q < n3; q += kWarps) {
      const int j = queue3[q] >> 8, i = queue3[q] & 0xFF;
      bool past = false;
      const int32_t par = warp_scan<kLanes>(
          a, l0, j, row0 + i, degree(a, l0 + j, row0 + i), a.thread_slots,
          a.warp_slots, &past);
      if (t == 0) {
        if (past) {
          queue4[atomicAdd(&n4, 1)] = queue3[q];
        } else {
          out.put(j, i, par);
        }
      }
    }
    __syncthreads();
    // Tier 4: the block on a pair.
    const int n = n4;
    for (int q = 0; q < n; ++q) {
      block_scan<kLanes>(a, out, l0, queue4[q] >> 8, row0, queue4[q] & 0xFF,
                         a.warp_slots, &best);
    }
    __syncthreads();
    if (kStaged) {  // the tile's results, each lane's rows in one run
      for (int j = 0; j < a.lanes && l0 + j < a.b; ++j) {
        if (in) {
          a.found[(l0 + j) * a.r + row] = found[j * kThreads + tid];
          a.parent[(l0 + j) * a.r + row] = parent[j * kThreads + tid];
        }
      }
      __syncthreads();  // before the next tile's results
    }
  }
}

// The frontier's lane bits: word [g, c] holds bit j iff frontier[g * kLanes
// + j, c] != 0. Every byte read once, coalesced; with `vec` (v a multiple
// of 16, both arrays 16-byte aligned) 16 vertices a thread, one 16-byte
// load a lane.
template <int kLanes>
__global__ void pack_kernel(const uint8_t* __restrict__ frontier,
                            typename Word<kLanes>::T* __restrict__ packed,
                            int64_t b, int64_t v, bool vec) {
  using T = typename Word<kLanes>::T;
  const int64_t groups = (b + kLanes - 1) / kLanes;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                        threadIdx.x;
  if (vec) {
    const int64_t n16 = v / 16;
    for (int64_t x = first; x < groups * n16; x += step) {
      const int64_t g = x / n16, c = x % n16 * 16;
      union {
        uint4 q[sizeof(T)];
        T w[16];
      } out;
#pragma unroll
      for (int e = 0; e < 16; ++e) out.w[e] = 0;
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const int64_t l = g * kLanes + j;
        if (l < b) {
          union {
            uint4 q;
            uint8_t c[16];
          } in;
          in.q = *reinterpret_cast<const uint4*>(frontier + l * v + c);
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            out.w[e] |= static_cast<T>(static_cast<unsigned>(in.c[e] != 0)
                                       << j);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < static_cast<int>(sizeof(T)); ++k) {
        reinterpret_cast<uint4*>(packed + g * v + c)[k] = out.q[k];
      }
    }
    return;
  }
  for (int64_t x = first; x < groups * v; x += step) {
    const int64_t g = x / v, c = x % v;
    unsigned word = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int64_t l = g * kLanes + j;
      if (l < b && frontier[l * v + c] != 0) word |= 1u << j;
    }
    packed[x] = static_cast<T>(word);
  }
}

// Launch the `kLanes` instance (1, 8 or 16 lanes a row at once) on a's
// shapes with `blocks` blocks, after packing the frontier if a.packed is
// set; or, with `resident`, launch nothing and set *resident to the blocks
// of that instance one SM holds at once (the occupancy calculator).
template <int kLanes>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream,
                   int* resident) {
  if (resident) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, pull_kernel<kLanes>, kThreads, 0);
  }
  if (a.thread_slots < kFirst ||
      (a.thread_slots - kFirst) % kDeep<kLanes> != 0) {
    return cudaErrorInvalidValue;  // tier 2 ends on a step's edge
  }
  if (kLanes > 1 && a.packed != nullptr) {
    using T = typename Word<kLanes>::T;
    const bool vec = a.v % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a.frontier) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a.packed) % 16 == 0;
    const int64_t work = (a.b + kLanes - 1) / kLanes * (vec ? a.v / 16 : a.v);
    const int64_t grid = (work + kThreads - 1) / kThreads;
    const int pack_blocks = static_cast<int>(grid < 65536 ? grid : 65536);
    pack_kernel<kLanes><<<pack_blocks, kThreads, 0, stream>>>(
        a.frontier, static_cast<T*>(const_cast<void*>(a.packed)), a.b, a.v,
        vec);
  }
  pull_kernel<kLanes><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

inline cudaError_t dispatch(const Args& a, int lanes_block, int blocks,
                            cudaStream_t stream, int* resident) {
  switch (lanes_block) {
    case 1: return launch<1>(a, blocks, stream, resident);
    case 8: return launch<8>(a, blocks, stream, resident);
    case 16: return launch<16>(a, blocks, stream, resident);
    default: return cudaErrorInvalidValue;
  }
}

struct DeviceScope {  // the calling thread's device is left as it was
  int prev;
  explicit DeviceScope(int device) : prev(device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device);
  }
  ~DeviceScope() {
    int cur = prev;
    cudaGetDevice(&cur);
    if (cur != prev) cudaSetDevice(prev);
  }
};

}  // namespace pull

// deg int32[b, r], nbrs int32[r, w], frontier uint8[b, v], found
// uint8[b, r], parent int32[b, r], all on `device`; `packed`, if not null,
// scratch of ceil(b / lanes_block) x v words of lanes_block bits (then
// lanes == lanes_block), which the call fills from the frontier first. The
// launch shape from `pull_plan`: tiles of `rows` rows x `lanes` lanes, the
// `lanes_block` instance (1, 8 or 16), tier 2 ending at `thread_slots`
// (kFirst + whole tier-2 steps) and tier 3 at `warp_slots` (whole steps of
// 128 more),
// `blocks` blocks of 256 threads. The calling thread's current device is
// left as it was. Returns the launches' cudaError_t (0 on success).
extern "C" int repro_bottomup_batch(const void* deg, const void* nbrs,
                                    const void* frontier, void* packed,
                                    void* found, void* parent, int64_t b,
                                    int64_t r, int64_t w, int64_t v,
                                    int rows, int lanes, int lanes_block,
                                    int64_t thread_slots, int64_t warp_slots,
                                    int blocks, int device, void* stream) {
  if (rows < 1 || rows > pull::kThreads || lanes < 1 ||
      lanes > lanes_block || blocks < 1 || warp_slots < thread_slots ||
      (warp_slots - thread_slots) % pull::kChunk != 0 ||
      (packed != nullptr && lanes != lanes_block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const pull::Args a{
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(nbrs),
      static_cast<const uint8_t*>(frontier), packed,
      static_cast<uint8_t*>(found), static_cast<int32_t*>(parent), b, r, w,
      v, thread_slots, warp_slots, rows, lanes,
      w % 4 == 0 && reinterpret_cast<uintptr_t>(nbrs) % 16 == 0};
  pull::DeviceScope scope(device);
  return static_cast<int>(pull::dispatch(
      a, lanes_block, blocks, static_cast<cudaStream_t>(stream), nullptr));
}

// Sets *resident to the blocks of the `lanes_block` instance one SM of
// `device` holds at once (the occupancy calculator). Launches nothing.
extern "C" int repro_bottomup_resident(int lanes_block, int* resident,
                                       int device) {
  pull::DeviceScope scope(device);
  return static_cast<int>(
      pull::dispatch(pull::Args{}, lanes_block, 0, nullptr, resident));
}
