// Flash-decode attention: one query token per head against a KV cache.
//
// Replaces: src/repro/kernels/decode_attn.py, decode_attention_pallas (its
// _decode_kernel). For batch row b, kv head k and query head j of its group
// of g: scores s = (q[b,k,j] . K[b,p,k]) * h^-0.5 in fp32 for the cache
// positions p < cache_len[b] (and < S), optionally soft-capped as
// cap * tanh(s / cap); out[b,k,j] = sum_p softmax(s)_p V[b,p,k], in fp32,
// rounded to q's type. Positions past cache_len take no part; with none
// left the output is 0 (l = 0, and 0 / 1e-30 = 0), as in the TPU kernel.
//
// Bound on the H100: bytes. Every score and every output reads one K row
// and one V row of h elements once; the arithmetic is ~4 operations per
// element read. The least time is the bytes of K and V up to cache_len
// over 3.35 TB/s.
//
// Design (simple, right first): one block of 8 warps per (kv head, batch
// row), carrying G query heads of the group (G = g for g <= 2, else 4; a g
// above 4 takes more blocks on the grid's x axis, each re-reading the
// cache). Each lane keeps its contiguous slice of the h dimensions of
// those query rows in registers, in fp32. Warp w takes the positions
// 4w .. 4w+3, then those 32 further on, and so on, in order: it loads the
// 4 K rows and 4 V rows at once (16-byte loads where the rows allow),
// reduces each of the dot products over its lanes with shuffles, and folds
// the 4 positions into its running (m, l, acc) per query head in fp32
// (online softmax). At the end the 8 warps' partials are combined through
// shared memory and normalized as acc / max(l, 1e-30), then rounded with
// __float2bfloat16_rn (what `astype` does). expf/tanhf, not the fast
// intrinsics, so that fp32 agrees to ~1e-5. Not done yet: splitting S
// across blocks (at B * K = 32 blocks the card's 132 SMs are mostly idle,
// and each warp's per-position softmax work is replicated on its 32
// lanes) and cp.async/TMA pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // cache positions a warp takes per step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Elements [d0, d0 + PER) of row `p` as floats, zeros past h. With `vec`
// (h a multiple of PER and every row 16-byte aligned) a lane's slice is
// whole and is read with 16-byte loads when it spans a multiple of 16 bytes.
template <typename T, int PER>
__device__ __forceinline__ void load_slice(const T* __restrict__ p, int d0,
                                           int h, bool vec,
                                           float (&x)[PER]) {
  if constexpr ((PER * sizeof(T)) % 16 == 0) {
    if (vec) {
      if (d0 >= h) {
#pragma unroll
        for (int i = 0; i < PER; ++i) x[i] = 0.f;
        return;
      }
      constexpr int kPerVec = 16 / sizeof(T);
#pragma unroll
      for (int i = 0; i < PER / kPerVec; ++i) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p + d0) + i);
        const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < kPerVec; ++e) x[i * kPerVec + e] = to_float(t[e]);
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) x[i] = d0 + i < h ? to_float(p[d0 + i]) : 0.f;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  return x;
}

// Grid: x = kv head * groups + group of G query heads, y = batch row.
template <typename T, int PER, int G>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const int32_t* __restrict__ cache_len,
    T* __restrict__ out, int64_t s, int kk, int g, int h, float scale,
    float cap, bool vec) {
  const int groups = (g + G - 1) / G;
  const int kv = blockIdx.x / groups;
  const int j0 = (blockIdx.x % groups) * G;
  const int nh = min(G, g - j0);
  const int64_t b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * PER;

  int64_t n = cache_len[b];
  n = n < 0 ? 0 : (n > s ? s : n);

  const T* qb = q + ((b * kk + kv) * g + j0) * h;
  float qr[G][PER];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < nh) {
      load_slice<T, PER>(qb + j * h, d0, h, vec, qr[j]);
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) qr[j][i] = 0.f;
    }
  }
  float m[G], l[G], acc[G][PER];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[j][i] = 0.f;
  }

  const int64_t row = static_cast<int64_t>(kk) * h;  // between positions
  const T* kb = kc + (b * s * kk + kv) * h;
  const T* vb = vc + (b * s * kk + kv) * h;
  for (int64_t base = static_cast<int64_t>(warp) * kUnroll; base < n;
       base += kWarps * kUnroll) {  // warp-uniform
    float kr[kUnroll][PER], vr[kUnroll][PER];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u < n) {
        load_slice<T, PER>(kb + (base + u) * row, d0, h, vec, kr[u]);
        load_slice<T, PER>(vb + (base + u) * row, d0, h, vec, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < PER; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
    float sc[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) dot += qr[j][i] * kr[u][i];
        float x = warp_sum(dot) * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);
        sc[u][j] = base + u < n ? x : kNegInf;
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float mx = m[j];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, sc[u][j]);
      const float corr = expf(m[j] - mx);
      l[j] *= corr;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[j][i] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = base + u < n ? expf(sc[u][j] - mx) : 0.f;
        l[j] += p;
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[j][i] += p * vr[u][i];
      }
      m[j] = mx;
    }
  }

  // Combine the warps' (m, l, acc): [kWarps][G] m and l, then
  // [kWarps][G][h] acc.
  extern __shared__ float smem[];
  float* sm = smem;
  float* sl = sm + kWarps * G;
  float* sacc = sl + kWarps * G;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      sm[warp * G + j] = m[j];
      sl[warp * G + j] = l[j];
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (d0 + i < h) sacc[(warp * G + j) * h + d0 + i] = acc[j][i];
    }
  }
  __syncthreads();
  T* ob = out + ((b * kk + kv) * g + j0) * h;
  for (int idx = threadIdx.x; idx < nh * h; idx += kThreads) {
    const int j = idx / h;
    const int d = idx - j * h;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w * G + j]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm[w * G + j] - mx);
      lsum += sl[w * G + j] * c;
      a += sacc[(w * G + j) * h + d] * c;
    }
    store(ob + idx, a / fmaxf(lsum, 1e-30f));
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* cache_len;
  void* out;
  int64_t b, s, kk, g, h;
  float scale, cap;
  cudaStream_t stream;
};

template <typename T, int PER, int G>
cudaError_t launch(const Args& a) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = a.h % PER == 0 && aligned(a.q) && aligned(a.k) &&
                   aligned(a.v) && (a.h * sizeof(T)) % 16 == 0;
  const size_t smem = (2 * kWarps * G + kWarps * G * a.h) * sizeof(float);
  const dim3 grid(static_cast<unsigned>(a.kk * ((a.g + G - 1) / G)),
                  static_cast<unsigned>(a.b));
  decode_attn_kernel<T, PER, G><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int32_t*>(a.cache_len),
      static_cast<T*>(a.out), a.s, static_cast<int>(a.kk),
      static_cast<int>(a.g), static_cast<int>(a.h), a.scale, a.cap, vec);
  return cudaGetLastError();
}

// G = g for g <= 2, else 4; PER = the elements of h a lane holds.
template <typename T, int PER>
cudaError_t by_heads(const Args& a) {
  if (a.g == 1) return launch<T, PER, 1>(a);
  if (a.g == 2) return launch<T, PER, 2>(a);
  return launch<T, PER, 4>(a);
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  if (a.h <= 32) return by_heads<T, 1>(a);
  if (a.h <= 64) return by_heads<T, 2>(a);
  if (a.h <= 128) return by_heads<T, 4>(a);
  return by_heads<T, 8>(a);
}

}  // namespace

// q [b, kk, g, h], k/v [b, s, kk, h] of one type (dtype 0: float32,
// 1: bfloat16), cache_len int32[b], out [b, kk, g, h] of q's type, all on
// `device`; 1 <= h <= 256, scale = h^-0.5, cap = 0 for no soft cap. The
// calling thread's current device is left as it was. Returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for a dtype code or h
// it does not take).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* cache_len,
                                      void* out, int64_t b, int64_t s,
                                      int64_t kk, int64_t g, int64_t h,
                                      float scale, float cap, int dtype,
                                      int device, void* stream) {
  if (h < 1 || h > 256 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const Args a{q, k, v, cache_len, out, b, s, kk, g, h, scale, cap,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(a) : dispatch<__nv_bfloat16>(a);
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
