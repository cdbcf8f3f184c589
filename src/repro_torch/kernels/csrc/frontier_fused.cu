// Fused frontier pack + statistics, batched over query lanes.
//
// Replaces: src/repro/kernels/frontier_fused.py, frontier_fused_batch_pallas
// (its _fused_batch_kernel), and frontier_fused_pallas as a launch with one
// lane: per lane, the flags packed into little-bit-endian uint32 words, nf
// (the set flags) and mf (the int32 sum of the degrees of the set flags).
//
// Bound on the H100: bytes. Each lane's V flag bytes are read once; of the
// shared degree array, only the pieces that hold the degree of a flag set in
// some lane; the bitmap (V/8 bytes a lane) is written once, and only when the
// caller asks for it (the BFS paths do not). There is no arithmetic to speak
// of.
//
// Design:
// - One launch, no zero fill before it. Each block reduces its lanes' counts
//   and adds each into a 64-bit accumulator as (1 << 44) + count: the high
//   bits count the blocks that have added, so the atomic's return value
//   tells the last block of the group that it is last, and with its own
//   count the total. That block writes nf or mf and zeroes the accumulator,
//   so the launcher zeroes it once, when it makes it; no fence and no second
//   read. Integer sums modulo 2^32 give the reference's bits, its int32
//   wraparound included, in any order.
// - Tiles of 256 words: 8 warps, 32 words a warp, each warp on one lane, so
//   a block takes 1, 2, 4 or 8 lanes (B = 1, 2, <= 4, more; more than 8
//   lanes go to further blocks along grid y). Blocks stride over the tiles,
//   as many as the SMs hold (the occupancy calculator) or as there are
//   tiles (at most 4,096 a group), whichever is fewer. A thread packs one
//   word from two 16-byte loads, and loads its word of the block's next
//   tile before it packs this one.
// - The degrees: each thread takes 16-byte pieces of them (neighbouring
//   threads, neighbouring pieces) and reads a piece once for all the
//   block's lanes, and only if one of them has a flag set in it. With one
//   lane a warp's own 32 words name its pieces (shuffles, no barrier);
//   with more, the words go through shared memory (two tiles in turn, one
//   barrier a tile, which also tells the block when no flag of the tile is
//   set, so that it skips the pass).
// - Any V, any row start: a row is read in 16-byte pieces aligned in memory,
//   and only in pieces that hold a byte of the row (so no load leaves the
//   row's 16-byte chunks). A word whose first flag lies inside a piece takes
//   its upper bits from the next word's first piece, which the neighbouring
//   thread loaded (a shuffle; the warp's last thread loads that piece
//   itself). Bits of bytes outside the row are masked off. The degrees are
//   read in 16-byte pieces when the array is 16-byte aligned, else one a set
//   flag.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// A block adds its count into an accumulator as (1 << kArrive) + count:
// the bits from kArrive up count the blocks that have added, and the sum
// of up to kMaxBlocks counts below 2^32 stays below 2^kArrive.
constexpr int kArrive = 44;
constexpr int64_t kMaxBlocks = int64_t{1} << (kArrive - 32);

struct Args {
  const uint8_t* flags;   // lane l's row of v bytes at flags + l * ld
  const int32_t* deg;     // [v]
  uint32_t* packed;       // [b, nwords], or null
  int32_t* nf;            // [b]
  int32_t* mf;            // [b]
  unsigned long long* acc;  // [gridDim.y, 2 * kLanes], zero between launches
  int64_t b, v, ld, nwords;
  int64_t tiles;          // tiles of a lane group
  int deg_vec;            // deg is 16-byte aligned
};

// The nonzero bytes of x as 4 bits (byte k to bit k): each 0/1 byte lands
// on bit 28 + k of the product, and no other term reaches bits 28-31.
__device__ __forceinline__ uint32_t bits4(uint32_t x) {
  const uint32_t m = __vcmpne4(x, 0u) & 0x01010101u;
  return (m * 0x10204080u) >> 28;
}

__device__ __forceinline__ uint32_t bits16(uint4 x) {
  return bits4(x.x) | (bits4(x.y) << 4) | (bits4(x.z) << 8) |
         (bits4(x.w) << 12);
}

// Adds the degrees of one 16-byte piece of `deg` (4 flags, at d) into each
// lane's sum where its nibble has the flag set; reads the piece only if
// some lane has one (`any`), in one load if deg is 16-byte aligned.
template <int kLanes>
__device__ __forceinline__ void add_piece(const Args& a, const int32_t* d,
                                          const uint32_t (&nib)[kLanes],
                                          uint32_t any,
                                          uint32_t (&mass)[kLanes]) {
  if (any == 0) return;
  int4 q;
  if (a.deg_vec) {
    q = __ldg(reinterpret_cast<const int4*>(d));
  } else {
    q.x = (any & 1u) ? __ldg(d) : 0;
    q.y = (any & 2u) ? __ldg(d + 1) : 0;
    q.z = (any & 4u) ? __ldg(d + 2) : 0;
    q.w = (any & 8u) ? __ldg(d + 3) : 0;
  }
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    mass[l] += ((nib[l] & 1u) ? static_cast<uint32_t>(q.x) : 0u) +
               ((nib[l] & 2u) ? static_cast<uint32_t>(q.y) : 0u) +
               ((nib[l] & 4u) ? static_cast<uint32_t>(q.z) : 0u) +
               ((nib[l] & 8u) ? static_cast<uint32_t>(q.w) : 0u);
  }
}

// A tile is kWords words of kLanes lanes (8 warps: warp w packs 32 words
// of lane w % kLanes); a block strides over its group's tiles.
template <int kLanes, bool kPacked>
__global__ void __launch_bounds__(kThreads) fused_kernel(const Args a) {
  constexpr int kWords = 32 * kWarps / kLanes;
  constexpr int kCols = 2 * kLanes;              // (nf, mf) of each lane
  constexpr int kItems = kWords * 8 / kThreads;  // nibbles a thread a tile
  __shared__ uint32_t words[2][kLanes][kWords];  // two tiles in turn
  __shared__ uint32_t red[kWarps * kCols];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int mine = warp % kLanes;                // this warp's lane
  const int chunk = warp / kLanes;               // and its 32 words
  const int64_t lane0 = static_cast<int64_t>(blockIdx.y) * kLanes;
  const int64_t left = a.b - lane0;
  const int lanes = left < kLanes ? static_cast<int>(left) : kLanes;
  const bool on = mine < lanes;
  // The row in 16-byte pieces aligned in memory: its first byte lies `mis`
  // bytes into piece 0 and its bytes end at byte `end` (0: no row).
  const uint8_t* row = a.flags + (lane0 + (on ? mine : 0)) * a.ld;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  const uint4* base = reinterpret_cast<const uint4*>(row - mis);
  const int64_t end = on ? mis + a.v : 0;
  uint32_t cnt = 0;                // set flags of this warp's lane
  uint32_t mass[kLanes];           // degrees of the set flags, by lane
#pragma unroll
  for (int l = 0; l < kLanes; ++l) mass[l] = 0;
  // A thread's word of tile `tile`: its two pieces, loaded a tile ahead.
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWords;
  int64_t w = static_cast<int64_t>(blockIdx.x) * kWords + chunk * 32 + t;
  uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
  if (32 * w < end) lo = __ldg(base + 2 * w);
  if (32 * w + 16 < end) hi = __ldg(base + 2 * w + 1);
  int buf = 0;
  for (int64_t tile = blockIdx.x; tile < a.tiles;
       tile += gridDim.x, buf ^= 1, w += step) {
    const int64_t w0 = tile * kWords;
    // Pack: one word a thread, neighbouring threads on neighbouring words.
    const uint32_t low = bits16(lo), high = bits16(hi);
    lo = hi = make_uint4(0u, 0u, 0u, 0u);
    if (32 * (w + step) < end) lo = __ldg(base + 2 * (w + step));
    if (32 * (w + step) + 16 < end) hi = __ldg(base + 2 * (w + step) + 1);
    uint32_t next = __shfl_down_sync(kFull, low, 1);
    if (t == 31) {   // the next word's first piece lies in the next warp's
      next = mis != 0 && 32 * w + 32 < end
                 ? bits16(__ldg(base + 2 * w + 2))
                 : 0u;
    }
    const uint64_t bits = (static_cast<uint64_t>(next) << 32) |
                          (high << 16) | low;
    uint32_t word = static_cast<uint32_t>(bits >> mis);
    const int64_t rest = a.v - 32 * w;             // flags from word w on
    if (rest < 32) word = rest > 0 ? word & ((1u << rest) - 1u) : 0u;
    cnt += __popc(word);
    if (kPacked && on && w < a.nwords) {
      a.packed[(lane0 + mine) * a.nwords + w] = word;
    }
    if constexpr (kLanes == 1) {
      // One lane: the warp's 32 words hold every flag this warp needs
      // degrees for. Items (word j, nibble n) of the warp, neighbouring
      // threads on neighbouring 16-byte pieces, the words by shuffle.
      if (__any_sync(kFull, word != 0)) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = (k * 32 + t) >> 3, n = t & 7;
          const uint32_t nib[1] = {
              (__shfl_sync(kFull, word, j) >> (4 * n)) & 0xFu};
          add_piece<1>(a, a.deg + 32 * (w - t + j) + 4 * n, nib, nib[0],
                       mass);
        }
      }
    } else {
      // Lanes in several warps: the words go through shared memory. Items
      // (word j, nibble n) of the tile, neighbouring threads on
      // neighbouring 16-byte pieces; none if no flag of the tile is set.
      words[buf][mine][chunk * 32 + t] = word;
      if (__syncthreads_or(word != 0)) {
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          const int item = threadIdx.x + k * kThreads;
          const int j = item >> 3, n = item & 7;
          uint32_t nib[kLanes], any = 0;
#pragma unroll
          for (int l = 0; l < kLanes; ++l) {
            nib[l] = (words[buf][l][j] >> (4 * n)) & 0xFu;
            any |= nib[l];
          }
          add_piece<kLanes>(a, a.deg + 32 * (w0 + j) + 4 * n, nib, any,
                            mass);
        }
      }
      // The other buffer is written next; the one read here, two tiles
      // on, after the next tile's barrier.
    }
  }

  // The block's counts: warps, then the block; then one atomic add a
  // count, whose return value tells the group's last block the total.
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    uint32_t c = l == mine ? cnt : 0u, m = mass[l];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_down_sync(kFull, c, off);
      m += __shfl_down_sync(kFull, m, off);
    }
    if (t == 0) {
      red[warp * kCols + 2 * l] = c;
      red[warp * kCols + 2 * l + 1] = m;
    }
  }
  __syncthreads();
  if (threadIdx.x < kCols) {
    uint32_t s = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += red[i * kCols + threadIdx.x];
    unsigned long long* acc =
        a.acc + static_cast<int64_t>(blockIdx.y) * kCols + threadIdx.x;
    const unsigned long long mine_add = (1ull << kArrive) + s;
    const unsigned long long old = atomicAdd(acc, mine_add);
    const int l = threadIdx.x >> 1;
    if ((old >> kArrive) == gridDim.x - 1) {      // the last to add
      *acc = 0ull;
      if (l < lanes) {
        ((threadIdx.x & 1) ? a.mf : a.nf)[lane0 + l] =
            static_cast<int32_t>(static_cast<uint32_t>(old + mine_add));
      }
    }
  }
}

template <int kLanes>
cudaError_t launch(const Args& a, int64_t blocks, int64_t groups,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(groups));
  if (a.packed != nullptr) {
    fused_kernel<kLanes, true><<<grid, kThreads, 0, stream>>>(a);
  } else {
    fused_kernel<kLanes, false><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int kLanes>
cudaError_t resident(int packed, int* out) {
  return packed ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      out, fused_kernel<kLanes, true>, kThreads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      out, fused_kernel<kLanes, false>, kThreads, 0);
}

}  // namespace

// flags: lane l's v bytes at flags + l * ld (any start, any v >= 1);
// deg int32[v]; packed uint32[b, ceil(v / 32)] or null (no bitmap); nf, mf
// int32[b], written whole; acc uint64[groups * 2 * lanes_block], zero (the
// kernel leaves it zero); all on `device`. lanes_block is 1, 2, 4 or 8,
// groups = ceil(b / lanes_block) <= 65,535, blocks (the grid's x) at most
// 4,096. The calling thread's current device is left as it was. Returns
// the launch's cudaError_t (0 on success).
extern "C" int repro_frontier_fused_batch(const void* flags, const void* deg,
                                          void* packed, void* nf, void* mf,
                                          void* acc, int64_t b, int64_t v,
                                          int64_t ld, int lanes_block,
                                          int64_t blocks, int device,
                                          void* stream) {
  const bool ok_lanes = lanes_block == 1 || lanes_block == 2 ||
                        lanes_block == 4 || lanes_block == 8;
  const int64_t groups = ok_lanes ? (b + lanes_block - 1) / lanes_block : 0;
  if (b < 1 || v < 1 || blocks < 1 || blocks > kMaxBlocks || groups < 1 ||
      groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const int64_t nwords = (v + 31) / 32;
  const int64_t tile_words = 32 * kWarps / lanes_block;
  const Args a{static_cast<const uint8_t*>(flags),
               static_cast<const int32_t*>(deg),
               static_cast<uint32_t*>(packed),
               static_cast<int32_t*>(nf),
               static_cast<int32_t*>(mf),
               static_cast<unsigned long long*>(acc),
               b,
               v,
               ld,
               nwords,
               (nwords + tile_words - 1) / tile_words,
               (reinterpret_cast<uintptr_t>(deg) & 15) == 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (lanes_block) {
    case 1: err = launch<1>(a, blocks, groups, s); break;
    case 2: err = launch<2>(a, blocks, groups, s); break;
    case 4: err = launch<4>(a, blocks, groups, s); break;
    default: err = launch<8>(a, blocks, groups, s); break;
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// *out = blocks of the (lanes_block, packed) instance one SM of `device`
// holds at once (the occupancy calculator). Returns the cudaError_t.
extern "C" int repro_frontier_fused_resident(int lanes_block, int packed,
                                             int* out, int device) {
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  cudaError_t err = cudaErrorInvalidValue;
  switch (lanes_block) {
    case 1: err = resident<1>(packed, out); break;
    case 2: err = resident<2>(packed, out); break;
    case 4: err = resident<4>(packed, out); break;
    case 8: err = resident<8>(packed, out); break;
    default: break;
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
