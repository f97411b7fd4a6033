// GQA flash-decode on Hopper (sm_90a): one query token against a KV cache.
//
// Replaces src/repro/kernels/decode_attn.py::decode_attention, the Pallas
// TPU kernel that computes, for every batch row b and query head
// h = kvh * G + g (G = H / Hk query heads share kv head kvh),
//
//     out[b, h] = softmax_s(q[b, h] . k[b, kvh, s] * dh^-0.5) @ v[b, kvh, s]
//
// over the positions s <= pos, with an online softmax over 512-position
// chunks walked in order by its sequential grid.  Blocks of this card run
// in parallel and in no order, so the port computes the function, not the
// TPU grid:
//
// * Split-KV.  A block takes one (batch row, kv head, tile of up to 8 of
//   its G query rows) and one contiguous split of the positions.  With one
//   block per (b, kv head) the serving shape (B = 8, Hk = 2) would occupy
//   16 of the 132 SMs; the wrapper picks the number of splits so that
//   several blocks run per SM.  A block writes its split's running (max,
//   denominator, accumulator); a second kernel combines the splits with a
//   log-sum-exp.  With one split the first kernel writes the output and
//   the second does not run.
// * Tiles of 32 positions through shared memory.  The 128 threads copy a
//   tile's k and v rows with 16-byte loads, 16 in flight a thread, through
//   the rows' strides: the caller passes the cache's (B, S, Hk, dh) layout
//   permuted to (B, Hk, S, dh) and the kernel reads it in place, never a
//   copy.  Then a lane takes a position and a warp a query row for the
//   scores (no cross-lane sums), the warp does the row's online softmax
//   over the tile, and a thread takes a head-dimension column for
//   p @ v.  A first design read k and v a row per warp straight into
//   registers and summed each score across the warp with shuffles; it ran
//   6x its bound at the serving shape and 17x at decode_32k (PERF.md).
// * Positions above pos are not read.  The reference masks them with a
//   score of -1e30, whose weight exp(-1e30 - max) is exactly 0 in f32
//   because position 0 is always unmasked; so reading only
//   n_valid = min(pos, S - 1) + 1 positions gives the same function.
// * q is scaled by dh^-0.5 once, as the Pallas kernel does; scores are
//   kept in base 2 (q also carries log2(e)) so that every exponential is
//   one exp2f.  q, k and v are f32, bf16 or f16 (one type for all three),
//   widened with the intrinsics; all arithmetic and the output are f32.
//   The head dimension is a multiple of 4, at most 256.
//
// What bounds it: bytes.  It must read 2 * B * Hk * n_valid * dh elements
// of cache once (plus q, and write B * H * dh f32), against
// 4 * B * H * n_valid * dh flops: under one flop per byte in f32, far
// below the card's ratio.  At the serving shape (B = 8, H = 12, Hk = 2,
// dh = 128, S = 1024, f32) that is 16.8 MB, 5 us at 3.35 TB/s.  The
// partials add 2 * B * H * splits * (dh + 2) * 4 bytes.  Faster designs
// are later work: TMA staging with a ring of tiles, and a bf16 cache.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kTile = 32;          // positions per tile: one per lane
constexpr int kMaxG = 8;           // query rows per block; G > 8 tiles
constexpr int kMaxDh = 256;
constexpr int kBatch = 8;          // 16-byte loads a thread has in flight
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* out;
  float* part_acc;
  float* part_ml;
  int H, Hk, G, dh, n_valid, chunk, splits, g_tiles;
  int64_t sq_b, sq_h;
  int64_t sk_b, sk_h, sk_s;
  int64_t sv_b, sv_h, sv_s;
  float q_scale;
};

// VEC elements of T per load: 16 bytes when the rows allow it, else 1.
template <typename T, int VEC>
struct Loader {
  using V = uint4;
  __device__ static V load(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void store(float* dst, const V& x) {
    const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = to_f32(e[i]);
  }
};
template <typename T>
struct Loader<T, 1> {
  using V = float;
  __device__ static V load(const T* p) { return to_f32(*p); }
  __device__ static void store(float* dst, V x) { *dst = x; }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
split_kernel(const Args a) {
  using L = Loader<T, VEC>;
  extern __shared__ float smem[];
  const int dh = a.dh;
  const int kstride = dh + 4;                 // pad: conflict-free rows
  float* Ks = smem;                           // [kTile][dh + 4]
  float* Vs = Ks + kTile * kstride;           // [kTile][dh]
  float* qs = Vs + kTile * dh;                // [kMaxG][dh + 4]
  float* P = qs + kMaxG * kstride;            // [kMaxG][kTile] weights
  float* m_s = P + kMaxG * kTile;             // [kMaxG]
  float* l_s = m_s + kMaxG;
  float* alpha_s = l_s + kMaxG;

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / a.g_tiles;
  const int g0 = (blockIdx.y % a.g_tiles) * kMaxG;
  const int b = blockIdx.z;
  const int gn = min(kMaxG, a.G - g0);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  const T* q = static_cast<const T*>(a.q) + b * a.sq_b;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk_b + kvh * a.sk_h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv_b + kvh * a.sv_h;

  for (int e = t; e < gn * dh; e += kThreads) {
    const int g = e / dh, d = e % dh;
    qs[g * kstride + d] =
        to_f32(q[(kvh * a.G + g0 + g) * a.sq_h + d]) * a.q_scale;
  }
  if (t < kMaxG) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.f;
  }
  float acc[kMaxG][2];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g][0] = acc[g][1] = 0.f;

  const int s_begin = split * a.chunk;
  const int s_end = min(a.n_valid, s_begin + a.chunk);
  const int row_vecs = dh / VEC;
  const int tile_vecs = kTile * row_vecs;
  for (int s0 = s_begin; s0 < s_end; s0 += kTile) {
    const int valid = min(kTile, s_end - s0);
    // 1. k and v tiles into shared memory, 2 * kBatch loads in flight
    for (int base = 0; base < tile_vecs; base += kThreads * kBatch) {
      typename L::V kx[kBatch], vx[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e = base + i * kThreads + t;
        const int r = e / row_vecs, c = (e % row_vecs) * VEC;
        if (e < tile_vecs && r < valid) {
          kx[i] = L::load(kb + (s0 + r) * a.sk_s + c);
          vx[i] = L::load(vb + (s0 + r) * a.sv_s + c);
        } else {
          kx[i] = typename L::V{};
          vx[i] = typename L::V{};
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e = base + i * kThreads + t;
        if (e < tile_vecs) {
          const int r = e / row_vecs, c = (e % row_vecs) * VEC;
          L::store(Ks + r * kstride + c, kx[i]);
          L::store(Vs + r * dh + c, vx[i]);
        }
      }
    }
    __syncthreads();
    // 2. scores: lane = position, warp = query rows warp, warp + 4
    for (int g = warp; g < gn; g += kThreads / 32) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + lane * kstride);
      const float4* qr = reinterpret_cast<const float4*>(qs + g * kstride);
      float s = 0.f;
      for (int d4 = 0; d4 < dh / 4; ++d4) {
        const float4 kk = kr[d4], qq = qr[d4];
        s = fmaf(kk.x, qq.x, s);
        s = fmaf(kk.y, qq.y, s);
        s = fmaf(kk.z, qq.z, s);
        s = fmaf(kk.w, qq.w, s);
      }
      if (lane >= valid) s = -INFINITY;
      // 3. online softmax of row g over the tile (warp-wide)
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = exp2f(s - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      P[g * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + ps;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 4. acc[g][d] = alpha * acc + sum_j p[g][j] * v[j][d], d = t, t + 128
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int d = t + c * kThreads;
      if (d >= dh) break;
      float vv[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) vv[j] = Vs[j * dh + d];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= gn) break;
        const float* pg = P + g * kTile;
        float o = acc[g][c] * alpha_s[g];
#pragma unroll
        for (int j = 0; j < kTile; ++j) o = fmaf(pg[j], vv[j], o);
        acc[g][c] = o;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d = t + c * kThreads;
    if (d >= dh) break;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= gn) break;
      const int64_t row = static_cast<int64_t>(b) * a.H + kvh * a.G + g0 + g;
      if (a.splits == 1) {
        a.out[row * dh + d] = acc[g][c] / l_s[g];
      } else {
        const int64_t prow = row * a.splits + split;
        a.part_acc[prow * dh + d] = acc[g][c];
        if (d == 0) {
          a.part_ml[prow * 2] = m_s[g];
          a.part_ml[prow * 2 + 1] = l_s[g];
        }
      }
    }
  }
}

__global__ void combine_kernel(const Args a) {
  const int64_t row = blockIdx.x;
  const int d = threadIdx.x;
  if (d >= a.dh) return;
  const float* ml = a.part_ml + row * a.splits * 2;
  float mm = -INFINITY;
  for (int s = 0; s < a.splits; ++s) mm = fmaxf(mm, ml[2 * s]);
  float ll = 0.f;
  float aa = 0.f;
  const float* acc = a.part_acc + row * a.splits * a.dh + d;
  for (int s = 0; s < a.splits; ++s) {
    const float c = exp2f(ml[2 * s] - mm);
    ll = fmaf(c, ml[2 * s + 1], ll);
    aa = fmaf(c, acc[static_cast<int64_t>(s) * a.dh], aa);
  }
  a.out[row * a.dh + d] = aa / ll;
}

template <typename T, int VEC>
cudaError_t launch_split(const Args& a, int B, size_t smem,
                         cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.splits, a.Hk * a.g_tiles, B);
  split_kernel<T, VEC><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const Args& a, int B, bool vec,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kTile) * (a.dh + 4) + kTile * a.dh +
       kMaxG * (a.dh + 4) + kMaxG * kTile + 3 * kMaxG);
  cudaError_t err = vec ? launch_split<T, 16 / sizeof(T)>(a, B, smem, stream)
                        : launch_split<T, 1>(a, B, smem, stream);
  if (err != cudaSuccess || a.splits == 1) return err;
  const int threads = ((a.dh + 31) / 32) * 32;
  combine_kernel<<<B * a.H, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k and v alike).
// Shapes: q (B, H, dh), k and v (B, Hk, S, dh) through the given element
// strides (the head dimension contiguous), out (B, H, dh) f32 contiguous.
// n_valid positions [0, n_valid) are attended, in `splits` splits of
// `chunk` positions (the last may be shorter, none empty); part_acc and
// part_ml hold B * H * splits * dh and B * H * splits * 2 floats when
// splits > 1.  device: the CUDA ordinal of the tensors and the stream; it
// is made current for the launch and the caller's device restored after.
// k and v are read with 16-byte loads where dh, the strides and the
// pointers allow it, else one element at a time.  Returns the cudaError_t
// of the launches (0 = success); dh must be a multiple of 4, at most 256.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, int dtype, void* out,
    void* part_acc, void* part_ml, int B, int H, int Hk, int dh,
    int n_valid, int chunk, int splits, long long sq_b, long long sq_h,
    long long sk_b, long long sk_h, long long sk_s, long long sv_b,
    long long sv_h, long long sv_s, int device, void* stream) {
  if (dtype < 0 || dtype > 2 || B <= 0 || Hk <= 0 || H % Hk != 0 ||
      dh <= 0 || dh > kMaxDh || dh % 4 != 0 || n_valid <= 0 || chunk <= 0 ||
      splits <= 0 ||
      static_cast<long long>(chunk) * (splits - 1) >= n_valid ||
      static_cast<long long>(chunk) * splits < n_valid || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.out = static_cast<float*>(out);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.H = H; a.Hk = Hk; a.G = H / Hk; a.dh = dh;
  a.n_valid = n_valid; a.chunk = chunk; a.splits = splits;
  a.g_tiles = (a.G + kMaxG - 1) / kMaxG;
  a.sq_b = sq_b; a.sq_h = sq_h;
  a.sk_b = sk_b; a.sk_h = sk_h; a.sk_s = sk_s;
  a.sv_b = sv_b; a.sv_h = sv_h; a.sv_s = sv_s;
  a.q_scale = kLog2e / sqrtf(static_cast<float>(dh));
  const int isz = dtype == 0 ? 4 : 2;
  const int vec = 16 / isz;
  const bool vec_ok =
      dh % vec == 0 && sk_s % vec == 0 && sv_s % vec == 0 &&
      sk_b % vec == 0 && sk_h % vec == 0 && sv_b % vec == 0 &&
      sv_h % vec == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(v) % 16 == 0;

  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_typed<float>(a, B, vec_ok, s); break;
    case 1: err = launch_typed<__nv_bfloat16>(a, B, vec_ok, s); break;
    default: err = launch_typed<__half>(a, B, vec_ok, s); break;
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
