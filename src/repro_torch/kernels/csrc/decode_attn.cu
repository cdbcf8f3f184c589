// Flash-decode attention: one query token per head against a KV cache.
//
// Replaces: src/repro/kernels/decode_attn.py, decode_attention_pallas (its
// _decode_kernel). For batch row b, kv head k and query head j of its group
// of g: scores s = (q[b,k,j] . K[b,p,k]) * h^-0.5 in fp32 for the cache
// positions p < cache_len[b] (and < S), optionally soft-capped as
// cap * tanh(s / cap); out[b,k,j] = sum_p softmax(s)_p V[b,p,k], in fp32,
// rounded once to q's type. Positions past cache_len take no part; with none
// left the output is exactly 0 (l = 0, and 0 / 1e-30 = 0), as in the TPU
// kernel.
//
// Bound on the H100: bytes. The call must read the K and V rows up to
// cache_len once (2 * sum_b cache_len[b] * K * h elements: 138.7 MB for
// gemma2-9b's decode at batch 4, context 4,232, K 8, h 256, bf16), q once
// and write the output once; over 3.35 TB/s that is 0.0414 ms. The
// arithmetic is ~4 operations per cache element (a multiply-add for q.k and
// one for p.v per query head), far below the card's ~20 per byte.
//
// Design (flash-decoding, one launch), point by point against what held
// the first version (one block per (kv head, batch row)) back:
// - Too few blocks (32 on 132 SMs): the grid is (split, kv head, batch
//   row). The launcher cuts S into `nsplit` contiguous ranges of
//   `split_len` positions (a whole number of 32-position tiles), from B,
//   K, S, the SM count and the blocks one SM holds at once (asked of the
//   runtime's occupancy calculator, repro_decode_attention_resident), so
//   that the launch shape does not depend on cache_len, with as many
//   blocks as the SMs hold at once: at gemma2-9b's serve shape 2 per SM,
//   8 splits of 544 positions, 256 blocks. (Twice as many splits leaves a
//   second round of blocks, and was slower on the H100.) A block whose
//   range lies past cache_len[b] has no work.
// - No load in flight while computing: K and V tiles of 32 positions go
//   through a ring of shared-memory stages (3 for bf16, 2 for fp32) filled
//   with 16-byte cp.async.cg copies; tile t + stages - 1 is issued as soon
//   as tile t has landed, so two tiles (64 KB at h 256 bf16) are on their
//   way while the block computes on one. Rows that are not 16-byte aligned
//   (h * size % 16 != 0, or an unaligned pointer) are copied by plain loads
//   into the same layout, zero-padded, without the overlap. (TMA bulk
//   copies, one per row, completing on an mbarrier, were slower here.)
// - Each score computed by all 32 lanes: now once. The 8 warps each take
//   an eighth of the h dimension with one lane per position (a tile row is
//   padded to an odd number of 16-byte words, so the lanes' rows fall into
//   different banks); the 8 partial dots are summed in a fixed order, and
//   one warp per query head scales, soft-caps (tanhf), masks and
//   exponentiates (expf) the tile's 32 scores, one per lane, with the
//   online-softmax max and sum as two warp reductions per tile. p.V runs
//   on all threads, each owning a 16-byte column word and a subset of the
//   tile's positions, acc in fp32 registers; at the end of the split the
//   subsets go to their own slices of the (then free) ring and are summed
//   in a fixed order in one pass (a barrier a subset was slower).
// - A group wider than 4 heads read the cache again: now all g <= 16
//   query heads of a kv head share the block, so each K and V byte is read
//   once per call (gemma2-9b g 2, yi-9b g 8, stablelm-3b g 1).
// - Each split writes its (m, l, acc[g][h]) in fp32 to scratch. The last
//   block of a (b, kv head) to finish (a counter after __threadfence(),
//   which it resets to 0 for the next call) combines the splits in split
//   order, so the output is the same bit for bit from run to run, and
//   writes acc / max(l, 1e-30), rounded with __float2bfloat16_rn. One
//   launch, not a second combine kernel: the decode step is bound by the
//   host's launches. With cache_len 0 no split has work and the output is
//   exact zeros.
// - The log-sum-exp of the scores (m + log l over all splits, fp32), the
//   TPU kernel's running max and sum folded into one number, is written
//   by the same last block when the caller passes an lse array, and only
//   then: a cache cut into sequence shards attends on each shard with its
//   own cache_len and combines the shards' outputs by their lse
//   (`models/layers.py` combine_partials). With cache_len 0 it is -inf.
//   The output is then fp32, not rounded to q's type: a shard's output is
//   a partial, rounded once only after the shards are combined (bf16
//   partials put up to half a step of each shard's larger values into the
//   combined one).
// - CUDA cores, not tensor cores: the arithmetic is not the limit, and a
//   bf16 mma for p.V would round p to bf16. expf/tanhf, not the fast
//   intrinsics, so that fp32 agrees to ~1e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;        // positions per tile: one per lane
constexpr int kMaxGroup = 16;    // query heads per kv head
constexpr int kMaxSplits = 64;
constexpr int kMaxRowGroups = 16;  // position subsets of the p.V phase
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of shared memory as CE = 16 / sizeof(T) floats.
template <typename T>
__device__ __forceinline__ void load16(const unsigned char* p,
                                       float (&x)[16 / sizeof(T)]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e) {
    x[e] = to_float(t[e]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
  }
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* cache_len;
  void* out;
  float* lse;       // [B, K, g] m + log(l), or null: not written
                    // (given: out is float32)
  float* scratch;   // acc [B, K, nsplit, g, h], then m and l [B, K, nsplit, g]
  int32_t* counters;  // [B, K], zero between calls
  int64_t b, s, kk;
  int g, h, nsplit, split_len;
  float scale, cap;
  cudaStream_t stream;
};

// The shared-memory layout of one block (bytes, each part 16-aligned).
struct Layout {
  int ch;        // 16-byte words per row (the last zero-padded)
  int rb;        // bytes per tile row: ch rounded up to odd, times 16
  int npg;       // position subsets of the p.V phase (and of the copies)
  size_t ring, q, part, p, stats, total;

  __host__ __device__ Layout(int h, int g, int esize, int stages,
                             int nsplit) {
    const int ce = 16 / esize;
    ch = (h + ce - 1) / ce;
    rb = (ch | 1) * 16;
    npg = kThreads / ch < kMaxRowGroups ? kThreads / ch : kMaxRowGroups;
    // The ring also holds the fold of the p.V subsets and the combine.
    const size_t fold = static_cast<size_t>(npg) * g * ch * ce * 4;
    const size_t combine = (2 * static_cast<size_t>(nsplit) + 1) * g * 4;
    ring = 2 * static_cast<size_t>(stages) * kTile * rb;
    ring = ring > fold ? ring : fold;
    ring = ring > combine ? ring : (combine + 15) / 16 * 16;
    q = static_cast<size_t>(g) * ch * ce * 4;
    part = static_cast<size_t>(kWarps) * g * kTile * 4;
    p = static_cast<size_t>(g) * kTile * 4;
    stats = ((3 * g * 4 + 15) / 16) * 16;              // m, l, corr
    total = ring + q + part + p + stats;
  }
};

template <typename T>
__host__ __device__ constexpr int stages_of() {
  return sizeof(T) == 2 ? 3 : 2;
}

// Grid: x = split, y = kv head, z = batch row. GM >= g bounds the register
// arrays of the query heads.
template <typename T, int GM>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(Args a,
                                                               bool vec) {
  constexpr int CE = 16 / sizeof(T);
  constexpr int NS = stages_of<T>();
  const int g = a.g, h = a.h;
  const int sp = blockIdx.x, kv = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t bk = b * a.kk + kv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const Layout L(h, g, sizeof(T), NS, a.nsplit);
  const int ch = L.ch, rb = L.rb, npg = L.npg, che = ch * CE;
  const int c = tid % ch, pg = tid / ch;   // p.V: column word, subset

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + L.ring);       // [g][che]
  float* part = reinterpret_cast<float*>(smem + L.ring + L.q);  // [w][g][T]
  float* p_s = part + kWarps * g * kTile;                       // [g][T]
  float* m_s = p_s + g * kTile;
  float* l_s = m_s + g;
  float* corr_s = l_s + g;
  __shared__ int last;

  int64_t n = a.cache_len[b];
  n = n < 0 ? 0 : (n > a.s ? a.s : n);
  const int64_t start = static_cast<int64_t>(sp) * a.split_len;
  const int64_t end = start + a.split_len < n ? start + a.split_len : n;
  const int64_t row = a.kk * h;                 // elements between positions
  float* acc_part = a.scratch;
  float* m_part = a.scratch + a.b * a.kk * a.nsplit * g * h;
  float* l_part = m_part + a.b * a.kk * a.nsplit * g;

  if (start < end) {
    const T* kb = static_cast<const T*>(a.k) + (b * a.s * a.kk + kv) * h;
    const T* vb = static_cast<const T*>(a.v) + (b * a.s * a.kk + kv) * h;
    const int ntiles = static_cast<int>((end - start + kTile - 1) / kTile);

    // Tile t into ring stage `slot`: thread (c, pg) copies word c of rows
    // pg, pg + npg, ... of K and of V.
    auto issue = [&](int t) {
      if (t >= ntiles || pg >= npg) return;
      const int slot = t % NS;
      const int64_t p0 = start + static_cast<int64_t>(t) * kTile;
      const int nv = end - p0 < kTile ? static_cast<int>(end - p0) : kTile;
      unsigned char* ks = ring + static_cast<size_t>(slot) * kTile * rb;
      unsigned char* vs = ring + static_cast<size_t>(NS + slot) * kTile * rb;
      for (int r = pg; r < nv; r += npg) {
        const int64_t off = (p0 + r) * row + c * CE;
        unsigned char* kd = ks + r * rb + c * 16;
        unsigned char* vd = vs + r * rb + c * 16;
        if (vec) {
          cp_async16(kd, kb + off);
          cp_async16(vd, vb + off);
        } else {
          T* kt = reinterpret_cast<T*>(kd);
          T* vt = reinterpret_cast<T*>(vd);
#pragma unroll
          for (int e = 0; e < CE; ++e) {
            const bool in = c * CE + e < h;
            store(kt + e, in ? to_float(kb[off + e]) : 0.f);
            store(vt + e, in ? to_float(vb[off + e]) : 0.f);
          }
        }
      }
    };

#pragma unroll
    for (int t = 0; t < NS - 1; ++t) {
      issue(t);
      cp_async_commit();
    }
    // q and the running (m, l) while the first tiles are on their way.
    const T* qb = static_cast<const T*>(a.q) + bk * g * h;
    for (int i = tid; i < g * che; i += kThreads) {
      const int j = i / che, d = i - j * che;
      q_s[i] = d < h ? to_float(qb[j * h + d]) : 0.f;
    }
    if (tid < g) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    float acc[GM][CE];
#pragma unroll
    for (int j = 0; j < GM; ++j) {
#pragma unroll
      for (int e = 0; e < CE; ++e) acc[j][e] = 0.f;
    }
    const int cpw = (ch + kWarps - 1) / kWarps;   // words per warp
    const int c0 = warp * cpw;
    const int c1 = c0 + cpw < ch ? c0 + cpw : ch;

    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<NS - 2>();    // tile t has landed (this thread's part)
      __syncthreads();            // ... everyone's (and q); stage t - 1
                                  // is free
      issue(t + NS - 1);
      cp_async_commit();
      const int slot = t % NS;
      const unsigned char* ks = ring + static_cast<size_t>(slot) * kTile * rb;
      const unsigned char* vs =
          ring + static_cast<size_t>(NS + slot) * kTile * rb;
      const int64_t p0 = start + static_cast<int64_t>(t) * kTile;
      const int nv = end - p0 < kTile ? static_cast<int>(end - p0) : kTile;

      // Partial dots: warp w over words [c0, c1), lane = position.
      float dot[GM];
#pragma unroll
      for (int j = 0; j < GM; ++j) dot[j] = 0.f;
      if (lane < nv) {
        for (int cw = c0; cw < c1; ++cw) {
          float kf[CE];
          load16<T>(ks + lane * rb + cw * 16, kf);
#pragma unroll
          for (int j = 0; j < GM; ++j) {
            if (j < g) {
              const float4* qq =
                  reinterpret_cast<const float4*>(q_s + j * che + cw * CE);
#pragma unroll
              for (int e = 0; e < CE / 4; ++e) {
                const float4 q4 = qq[e];
                dot[j] += q4.x * kf[4 * e] + q4.y * kf[4 * e + 1] +
                          q4.z * kf[4 * e + 2] + q4.w * kf[4 * e + 3];
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < GM; ++j) {
        if (j < g) part[(warp * g + j) * kTile + lane] = dot[j];
      }
      __syncthreads();

      // Scores, once each: warp per query head, lane per position.
      for (int j = warp; j < g; j += kWarps) {
        float x = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) x += part[(w * g + j) * kTile + lane];
        x *= a.scale;
        if (a.cap != 0.f) x = a.cap * tanhf(x / a.cap);
        const bool valid = lane < nv;
        x = valid ? x : kNegInf;
        const float m_old = m_s[j];
        const float m_new = fmaxf(m_old, warp_max(x));
        const float pr = valid ? expf(x - m_new) : 0.f;
        const float sum = warp_sum(pr);
        p_s[j * kTile + lane] = pr;
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          corr_s[j] = corr;
          l_s[j] = l_s[j] * corr + sum;
          m_s[j] = m_new;
        }
      }
      __syncthreads();

      // p.V: thread (c, pg) over rows pg, pg + npg, ... of the tile.
      if (pg < npg) {
#pragma unroll
        for (int j = 0; j < GM; ++j) {
          if (j < g) {
            const float corr = corr_s[j];
#pragma unroll
            for (int e = 0; e < CE; ++e) acc[j][e] *= corr;
          }
        }
        for (int r = pg; r < nv; r += npg) {
          float vf[CE];
          load16<T>(vs + r * rb + c * 16, vf);
#pragma unroll
          for (int j = 0; j < GM; ++j) {
            if (j < g) {
              const float pj = p_s[j * kTile + r];
#pragma unroll
              for (int e = 0; e < CE; ++e) acc[j][e] += pj * vf[e];
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();              // the ring is free

    // The subsets' acc: each to its own slice of the ring, then summed in
    // subset order into the split's acc in scratch.
    float* fold = reinterpret_cast<float*>(ring);   // [npg][g][che]
    if (pg < npg) {
#pragma unroll
      for (int j = 0; j < GM; ++j) {
        if (j < g) {
          float4* f = reinterpret_cast<float4*>(fold + (pg * g + j) * che +
                                                c * CE);
#pragma unroll
          for (int e = 0; e < CE / 4; ++e) {
            f[e] = make_float4(acc[j][4 * e], acc[j][4 * e + 1],
                               acc[j][4 * e + 2], acc[j][4 * e + 3]);
          }
        }
      }
    }
    __syncthreads();
    float* ab = acc_part + (bk * a.nsplit + sp) * g * h;
    for (int i = tid; i < g * che; i += kThreads) {
      const int j = i / che, d = i - j * che;
      if (d < h) {
        float x = 0.f;
        for (int r = 0; r < npg; ++r) x += fold[r * g * che + i];
        ab[j * h + d] = x;
      }
    }
    if (tid < g) {
      m_part[(bk * a.nsplit + sp) * g + tid] = m_s[tid];
      l_part[(bk * a.nsplit + sp) * g + tid] = l_s[tid];
    }
  }

  // The last block of (b, kv head) to get here combines the splits. The
  // barrier orders the block's scratch writes before thread 0's fence,
  // which makes them visible to the block that counts last.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(a.counters + bk, 1) == a.nsplit - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int nsv = static_cast<int>((n + a.split_len - 1) / a.split_len);
  float* cm = reinterpret_cast<float*>(smem);   // [nsv][g] m, then weights
  float* cl = cm + a.nsplit * g;                // [nsv][g] l
  float* lsum = cl + a.nsplit * g;              // [g]
  for (int i = tid; i < nsv * g; i += kThreads) {
    cm[i] = __ldcg(m_part + bk * a.nsplit * g + i);
    cl[i] = __ldcg(l_part + bk * a.nsplit * g + i);
  }
  __syncthreads();
  if (tid < g) {
    float mx = kNegInf;
    for (int s = 0; s < nsv; ++s) mx = fmaxf(mx, cm[s * g + tid]);
    float l = 0.f;
    for (int s = 0; s < nsv; ++s) {
      const float w = expf(cm[s * g + tid] - mx);
      cm[s * g + tid] = w;
      l += cl[s * g + tid] * w;
    }
    lsum[tid] = l;
    if (a.lse != nullptr) a.lse[bk * g + tid] = mx + logf(l);
  }
  __syncthreads();
  // Thread tid takes outputs tid + u * kThreads (at most GM of them, as
  // g * h <= GM * 256), all their loads of one split in flight at once.
  const float* ab = acc_part + bk * a.nsplit * g * h;
  T* ob = static_cast<T*>(a.out) + bk * g * h;
  float* of = static_cast<float*>(a.out) + bk * g * h;   // with an lse
  float x[GM];
  int jo[GM];
#pragma unroll
  for (int u = 0; u < GM; ++u) {
    x[u] = 0.f;
    jo[u] = (tid + u * kThreads) / h;
  }
  for (int s = 0; s < nsv; ++s) {
    const float* as = ab + static_cast<int64_t>(s) * g * h;
#pragma unroll
    for (int u = 0; u < GM; ++u) {
      const int i = tid + u * kThreads;
      if (i < g * h) x[u] += cm[s * g + jo[u]] * __ldcg(as + i);
    }
  }
#pragma unroll
  for (int u = 0; u < GM; ++u) {
    const int i = tid + u * kThreads;
    if (i < g * h) {
      const float y = x[u] / fmaxf(lsum[jo[u]], 1e-30f);
      if (a.lse != nullptr) {
        of[i] = y;
      } else {
        store(ob + i, y);
      }
    }
  }
  if (tid == 0) a.counters[bk] = 0;
}

// Launch the kernel on a's shapes; or, with `resident`, launch nothing and
// set *resident to the blocks of that instance one SM holds at once (at the
// shared memory of kMaxSplits splits, at least that of any launch).
template <typename T, int GM>
cudaError_t launch(const Args& a, int* resident) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = (a.h * sizeof(T)) % 16 == 0 && aligned(a.k) &&
                   aligned(a.v);
  const Layout L(a.h, a.g, sizeof(T), stages_of<T>(),
                 resident ? kMaxSplits : a.nsplit);
  auto kernel = decode_attn_kernel<T, GM>;
  if (L.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.total));
    if (err != cudaSuccess) return err;
  }
  if (resident) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel,
                                                         kThreads, L.total);
  }
  const dim3 grid(static_cast<unsigned>(a.nsplit),
                  static_cast<unsigned>(a.kk), static_cast<unsigned>(a.b));
  kernel<<<grid, kThreads, L.total, a.stream>>>(a, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int* resident) {
  if (a.g <= 1) return launch<T, 1>(a, resident);
  if (a.g <= 2) return launch<T, 2>(a, resident);
  if (a.g <= 4) return launch<T, 4>(a, resident);
  if (a.g <= 8) return launch<T, 8>(a, resident);
  return launch<T, 16>(a, resident);
}

}  // namespace

// q [b, kk, g, h], k/v [b, s, kk, h] of one type (dtype 0: float32,
// 1: bfloat16), cache_len int32[b], out [b, kk, g, h] of q's type (float32
// when lse is given), lse float32 [b, kk, g] or null (written only when
// given), all on `device`;
// 1 <= h <= 256, 1 <= g <= 16, scale = h^-0.5, cap = 0 for no soft cap.
// S is cut into nsplit ranges of split_len positions (a multiple of 32,
// nsplit * split_len >= s, nsplit <= 64). scratch: float32
// [b * kk * nsplit * g * (h + 2)]; counters: int32 [b * kk], all zero (the
// kernel leaves them zero). The calling thread's current device is left as
// it was. Returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue for arguments it does not take).
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* out, void* lse, void* scratch, void* counters, int64_t b,
    int64_t s, int64_t kk, int64_t g, int64_t h, int64_t nsplit,
    int64_t split_len, float scale, float cap, int dtype, int device,
    void* stream) {
  if (h < 1 || h > 256 || g < 1 || g > kMaxGroup || nsplit < 1 ||
      nsplit > kMaxSplits || split_len < 1 || split_len % kTile != 0 ||
      nsplit * split_len < s || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const Args a{q,
               k,
               v,
               static_cast<const int32_t*>(cache_len),
               out,
               static_cast<float*>(lse),
               static_cast<float*>(scratch),
               static_cast<int32_t*>(counters),
               b,
               s,
               kk,
               static_cast<int>(g),
               static_cast<int>(h),
               static_cast<int>(nsplit),
               static_cast<int>(split_len),
               scale,
               cap,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err = dtype == 0 ? dispatch<float>(a, nullptr)
                                     : dispatch<__nv_bfloat16>(a, nullptr);
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// *resident = the blocks one SM of `device` holds at once for (g, h, dtype),
// from the kernel's registers and shared memory; the launcher's split plan
// aims at that many per SM. Returns a cudaError_t as above.
extern "C" int repro_decode_attention_resident(int64_t g, int64_t h,
                                               int dtype, int* resident,
                                               int device) {
  if (h < 1 || h > 256 || g < 1 || g > kMaxGroup ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  Args a{};
  a.g = static_cast<int>(g);
  a.h = static_cast<int>(h);
  const cudaError_t err = dtype == 0 ? dispatch<float>(a, resident)
                                     : dispatch<__nv_bfloat16>(a, resident);
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

namespace {

template <typename T>
cudaError_t attributes_of(int g, cudaFuncAttributes* fa) {
  if (g <= 1) return cudaFuncGetAttributes(fa, decode_attn_kernel<T, 1>);
  if (g <= 2) return cudaFuncGetAttributes(fa, decode_attn_kernel<T, 2>);
  if (g <= 4) return cudaFuncGetAttributes(fa, decode_attn_kernel<T, 4>);
  if (g <= 8) return cudaFuncGetAttributes(fa, decode_attn_kernel<T, 8>);
  return cudaFuncGetAttributes(fa, decode_attn_kernel<T, 16>);
}

}  // namespace

// What the compiler made of the instance a launch at (g, h, dtype) runs,
// for the kernel contracts (`kernels/contracts.py`): out[0..5] =
// sharedSizeBytes, numRegs, localSizeBytes, maxThreadsPerBlock and
// maxDynamicSharedSizeBytes of cudaFuncGetAttributes (the last as the
// launches so far have set it), then the dynamic shared bytes a launch of
// `nsplit` splits asks for (the Layout's total). Launches nothing.
extern "C" int repro_decode_attention_attributes(int64_t g, int64_t h,
                                                 int dtype, int64_t nsplit,
                                                 int* out, int device) {
  if (h < 1 || h > 256 || g < 1 || g > kMaxGroup || nsplit < 1 ||
      nsplit > kMaxSplits || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  cudaFuncAttributes fa;
  const cudaError_t err = dtype == 0
                              ? attributes_of<float>(static_cast<int>(g), &fa)
                              : attributes_of<__nv_bfloat16>(
                                    static_cast<int>(g), &fa);
  if (prev != device) cudaSetDevice(prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int esize = dtype == 0 ? 4 : 2;
  const Layout L(static_cast<int>(h), static_cast<int>(g), esize,
                 dtype == 0 ? stages_of<float>() : stages_of<__nv_bfloat16>(),
                 static_cast<int>(nsplit));
  out[0] = static_cast<int>(fa.sharedSizeBytes);
  out[1] = fa.numRegs;
  out[2] = static_cast<int>(fa.localSizeBytes);
  out[3] = fa.maxThreadsPerBlock;
  out[4] = fa.maxDynamicSharedSizeBytes;
  out[5] = static_cast<int>(L.total);
  return 0;
}
