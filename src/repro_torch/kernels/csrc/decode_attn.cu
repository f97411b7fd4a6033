// GQA flash-decode on Hopper (sm_90a): one query token against a KV cache.
//
// Replaces src/repro/kernels/decode_attn.py::decode_attention (body
// `_kernel`), the Pallas TPU kernel that computes, for every batch row b
// and query head h = kvh * G + g (G = H / Hk query heads share kv head kvh),
//
//     out[b, h] = softmax_s(q[b, h] . k[b, kvh, s] * dh^-0.5) @ v[b, kvh, s]
//
// over the positions s <= pos, with an online softmax over 512-position
// chunks walked in order by its sequential grid.  Blocks of this card run
// in parallel and in no order, so the port computes the function, not the
// TPU grid.
//
// What bounds it: bytes.  Each of the n_valid = min(pos, S - 1) + 1 cached
// rows of k and v is read once, against 4 * G flops per cached element: 6
// flops a byte in bf16 at G = 6, 1.5 in f32, far below the card's ratio.
// At decode_32k (B 128, H 12, Hk 2, S 32 768, dh 128, bf16) that is
// 4.30 GB, 1.28 ms at 3.35 TB/s; at the serving shape (B 8, H 12, Hk 2,
// S 1024, dh 128, f32) 16.9 MB, 5 us.  So the design is about keeping
// enough bytes in flight and the SM's other work out of their way:
//
// * A ring of k/v tiles in shared memory, in the cache's own type, filled
//   by TMA.  One producer warp (one elected lane) issues
//   cp.async.bulk.tensor loads through one 4-D tensor map per cache
//   (dh, Hk, S, B, its dimensions ordered by that cache's strides), which
//   describes the model's (B, S, Hk, dh) cache read through its permuted
//   view in place;
//   the wrapper's library caches the maps by pointer, shape, strides and
//   type, so serving's 56 caches are encoded once.  Each stage has a full
//   mbarrier (expected bytes) and an empty mbarrier (one arrival per
//   consumer warp).  Four consumer warps compute while the next stages
//   load: 64 positions a stage (32 in f32 above dh 128), two to eight
//   stages (stages_of: the library alone picks them; 96 KB a block up to
//   dh 128 in bf16/f16, two blocks an SM: 192
//   KB queued per SM against the ~25 KB that Little's law asks at 3.35
//   TB/s and 1 us).  No copy goes through registers and nothing is
//   widened on its way in.  Rows are stored with TMA's 128-byte swizzle
//   (64- or 32-byte where a row is that short) in 128-byte column slabs,
//   so eight consecutive rows of one 16-byte chunk fall in eight banks:
//   ldmatrix and the f32 loads are conflict-free.  TMA zero-fills past S
//   only; positions at or past the end of a block's split are masked here
//   (scores -inf; v rows zeroed before a tensor-core product, skipped in
//   f32).
// * Tensor cores for bf16 and f16, with the positions as the mma's M:
//   S^T = K q^T and O^T += V^T P^T on mma.sync m16n8k16 with f32
//   accumulators, 16 positions a warp and the block's 8 query rows as N,
//   so no mma row is padding at G <= 8; q enters unscaled in its own type
//   and dh^-0.5 * log2(e) scales the f32 scores, so the products are
//   exact.  P^T reaches the B fragments through movmatrix, split into
//   parts in the cache's type (bf16: three parts, 24 bits; f16: two parts
//   of p * 2^15, so small weights do not underflow), one mma a part: the
//   sum keeps f32's precision.  Each warp keeps its own online softmax:
//   no barrier between warps inside the loop, and no branch around its
//   shuffles.  A stage's ldmatrix loads are all issued before its mmas,
//   and no integer division is left in the addressing, so the compute
//   of a stage takes less time than its loads (PERF.md).
// * f32 on CUDA cores in IEEE f32 (never TF32).  A lane takes two
//   positions (one above dh 128) and a quarter of the head dimension for
//   all 8 query rows, so each k element read from shared memory serves
//   every row and each q element two positions; for p @ v a lane takes
//   16-byte columns of v for all 8 rows.
// * Split-KV sized to the card.  A block takes (batch row, kv head, group
//   of 8 query rows, split of the positions); the wrapper picks the splits,
//   whole stages each but the last, by the stages the busiest SM runs (its
//   blocks an SM from the occupancy query), so the grid fills the 132 SMs
//   in whole waves.  The warps merge their states in shared memory; with one
//   split the block writes the output, else its (max, sum, accumulator)
//   go to a workspace the wrapper keeps per stream, and the last block of
//   the row group to arrive (one acq_rel atomic a block on a counter per
//   group, reset by that block) combines the splits, a warp a row: one
//   launch a call.
//
// The design before this one: tiles of 32 positions copied through
// registers and widened to f32 in shared memory, three barriers a tile
// and no load in flight while a block computed, scores on CUDA cores,
// and a second combine launch: 0.01922 ms of device time at the serving
// shape (3.8x its bound) and 4.080 ms at decode_32k (3.2x its bound, 3.05x
// SDPA's time) on an H100 80GB HBM3 at 700 W (PERF.md).  The first read
// k and v a row per warp straight into registers: 6x its bound at the
// serving shape, 17x at decode_32k.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <type_traits>

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kThreads = (kConsumerWarps + 1) * 32;   // + the producer warp
constexpr int kConsumerThreads = kConsumerWarps * 32;
constexpr int kMaxDh = 256;
constexpr int kMaxStages = 8;
constexpr int kSmemPerBlock = 232448;  // 227 KB
constexpr float kLog2e = 1.4426950408889634f;

// positions a stage: 64 (16 a warp); f32 above dh 128: 32 (8 a warp)
// (kernels/decode_attn.py::kernel_config mirrors tile_of and stages_of
// for the CPU; on a card the wrapper reads decode_attention_config)
__host__ __device__ constexpr int tile_of(bool f32, int dh) {
  return f32 && dh > 128 ? 32 : 64;
}

// stages of the ring: as many as fill 96 KB a block up to dh 128 (two
// blocks an SM, __launch_bounds__) and 192 KB above (one), 2 at least
constexpr int stages_of(bool f32, int dh) {
  const int stage = 2 * tile_of(f32, dh) * dh * (f32 ? 4 : 2);
  const int ring = (dh <= 128 ? 96 : 192) * 1024;
  return std::max(2, std::min(kMaxStages, ring / stage));
}
constexpr int kRows = 8;               // query rows a block (one mma N)

struct Args {
  const void* q;
  float* out;
  float* ws;          // (B * H * splits) rows of dh floats: accumulators
  float2* ws_ml;      // (B * H * splits) of (max, sum)
  int* counters;      // one a (b, kvh, row group), zero between calls
  int H, Hk, G, dh, n_valid, chunk, splits, g_tiles, stages;
  int slab;           // bytes of a row in one column slab: 128, or the row
  int slab_log2;      // log2(slab); 31 where one slab holds the row
  int slabs;          // slabs a row: dh * sizeof(T) / slab
  int swz;            // swizzle mask: 7 (128 B), 3 (64 B), 1 (32 B), 0
  int kdim_h, kdim_s;  // the places (1..3) of kv head and position in k's
                       // tensor map; the batch row takes the third
  int vdims;           // v's: vdim_h | vdim_s << 2 (three ints here, as
                       // ptxas then fits the 16-bit kernels in 168
                       // registers without spilling)
  int64_t sq_b, sq_h;
  float scale;        // dh^-0.5 * log2(e), applied to the f32 scores
};

// -- shared memory, barriers, TMA -------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// coordinate `i` (1..3) of a tensor map whose kv head and position dims
// sit at dim_h and dim_s (the batch row at the third)
__device__ __forceinline__ int map_coord(int dim_h, int dim_s, int i,
                                         int kvh, int s0, int b) {
  return dim_h == i ? kvh : dim_s == i ? s0 : b;
}

// Byte address of (row, byte `col` of the row) in a stage's k or v tile:
// the row's bytes lie in `slabs` column slabs of tile x slab bytes each,
// and inside a slab TMA's swizzle XORs the 16-byte chunk index with the
// 128-byte line index (address bits 4-6 with bits 7-9, masked by swz).
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int tile,
                                              const Args& a, int row,
                                              int col) {
  const int s = col >> a.slab_log2;     // no division on the hot path
  const uint32_t o = row * a.slab + (col - s * a.slab);
  return base + s * tile * a.slab + (o ^ (((o >> 7) & a.swz) << 4));
}

// -- tensor cores -------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

template <typename T> struct Half16;
template <> struct Half16<__nv_bfloat16> {
  static constexpr int kParts = 3;        // 3 x 8 bits of p
  static constexpr float kPScale = 1.f;
  __device__ static uint16_t bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  __device__ static float back(uint16_t b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  __device__ static void mma(float c[4], const uint32_t a[4], uint32_t b0,
                             uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <> struct Half16<__half> {
  static constexpr int kParts = 2;        // 2 x 11 bits of p * 2^15
  static constexpr float kPScale = 32768.f;
  __device__ static uint16_t bits(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
  __device__ static float back(uint16_t b) {
    return __half2float(__ushort_as_half(b));
  }
  __device__ static void mma(float c[4], const uint32_t a[4], uint32_t b0,
                             uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// the transpose of the 8x8 16-bit matrix the warp holds as mma fragments
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// barrier among the consumer warps alone (the producer may have exited)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumerThreads) : "memory");
}

// the new running max, and the one the exponentials subtract (0 while
// every score so far is -inf, so that exp2(-inf - 0) = 0, never NaN)
__device__ __forceinline__ float2 next_max(float m_old, float tile_max) {
  const float m = fmaxf(m_old, tile_max);
  return make_float2(m, m == -INFINITY ? 0.f : m);
}

// Byte offsets in a block's shared memory, from its 1024-aligned base.
struct Layout {
  int stage;     // one stage: the k tile, then the v tile
  int full, empty, mw, lw, flag, q, p;
  int total;     // bytes to request, with the slack for the alignment
};

__host__ __device__ inline Layout make_layout(bool f32, int dh, int stages) {
  const int es = f32 ? 4 : 2, tile = tile_of(f32, dh), rows = kRows;
  Layout L;
  L.stage = 2 * tile * dh * es;
  int o = stages * L.stage;      // the ring; the warps' merge reuses it
  L.full = o;  o += 8 * stages;
  L.empty = o; o += 8 * stages;
  L.mw = o;    o += 4 * kConsumerWarps * rows;
  L.lw = o;    o += 4 * kConsumerWarps * rows;
  L.flag = o;  o += 16;
  L.q = o;     if (f32) o += 4 * rows * dh;                 // q, f32 rows
  L.p = o;     if (f32) o += 4 * tile * rows;                // p, f32
  L.total = o + 1024;
  return L;
}

template <typename T, int DHMAX>
__global__ void __launch_bounds__(kThreads, DHMAX <= 128 ? 2 : 1)
attn_kernel(const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const Args a) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kTile = tile_of(kF32, DHMAX);
  constexpr int kWP = kTile / kConsumerWarps;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int dh = a.dh;
  const Layout L = make_layout(kF32, dh, a.stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(sm + L.empty);
  float* mw = reinterpret_cast<float*>(sm + L.mw);
  float* lw = reinterpret_cast<float*>(sm + L.lw);
  int* flag = reinterpret_cast<int*>(sm + L.flag);
  float* scr = reinterpret_cast<float*>(sm);   // [warp][row][dh], after

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / a.g_tiles, gt = blockIdx.y % a.g_tiles;
  const int b = blockIdx.z;
  const int g0 = gt * kRows;
  const int gn = min(kRows, a.G - g0);
  const int s_begin = split * a.chunk;
  const int s_end = min(a.n_valid, s_begin + a.chunk);
  const int n_tiles = (s_end - s_begin + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = L.stage / 2;
  const int64_t q_row0 = b * a.sq_b + (kvh * a.G + g0) * a.sq_h;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const uint32_t ring = smem_u32(sm);
  if (warp == kConsumerWarps) {
    // -- producer: one lane keeps the ring full --------------------------
    if (lane == 0) {
      const int ebox = a.slab / static_cast<int>(sizeof(T));
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % a.stages, n = t / a.stages;
        if (n > 0) mbar_wait(&empty[st], (n - 1) & 1);
        mbar_expect_tx(&full[st], L.stage);
        const int s0 = s_begin + t * kTile;
        const int vh = a.vdims & 3, vs = a.vdims >> 2;
        const int k1 = map_coord(a.kdim_h, a.kdim_s, 1, kvh, s0, b);
        const int k2 = map_coord(a.kdim_h, a.kdim_s, 2, kvh, s0, b);
        const int k3 = map_coord(a.kdim_h, a.kdim_s, 3, kvh, s0, b);
        const int v1 = map_coord(vh, vs, 1, kvh, s0, b);
        const int v2 = map_coord(vh, vs, 2, kvh, s0, b);
        const int v3 = map_coord(vh, vs, 3, kvh, s0, b);
        unsigned char* dst = sm + st * L.stage;
        for (int sl = 0; sl < a.slabs; ++sl) {
          tma_load_4d(dst + sl * kTile * a.slab, &kmap, &full[st],
                      sl * ebox, k1, k2, k3);
          tma_load_4d(dst + half + sl * kTile * a.slab, &vmap, &full[st],
                      sl * ebox, v1, v2, v3);
        }
      }
    }
    return;
  }

  // -- consumers: warp `warp` takes kWP positions of every stage ----------
  const int wrow = warp * kWP;
  if constexpr (!kF32) {
    // positions are the mma's M (16 a warp), query rows its N (8):
    // S^T = K q^T, then O^T += V^T P^T, P^T moved into B fragments by
    // movmatrix.  Lane (r8, c4) = (lane / 4, lane % 4).
    using H16 = Half16<T>;
    constexpr int kKS = DHMAX / 16;
    const int r8 = lane >> 2, c4 = lane & 3;
    const int nks = (dh + 15) / 16;          // dh % 8 == 0
    const bool tail = dh % 16 != 0;          // the last step's upper half
    // q^T as B fragments, unscaled in its own type; rows past G are 0
    uint32_t qb[kKS][2];
    const uint16_t* qbits = static_cast<const uint16_t*>(a.q);
    auto qv = [&](int d) -> uint16_t {
      return (r8 < gn && d < dh) ? qbits[q_row0 + r8 * a.sq_h + d] : 0;
    };
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int d = ks * 16 + 2 * c4;
      qb[ks][0] = pack2(qv(d), qv(d + 1));
      qb[ks][1] = pack2(qv(d + 8), qv(d + 9));
    }
    float acc[kKS][4];   // O^T: d = 16 i + r8 (+ 8), query 2 c4 + (0, 1)
#pragma unroll
    for (int i = 0; i < kKS; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    // this lane's ldmatrix row: matrix lane / 8, its row lane % 8
    const int mi = lane >> 3;
    const int krow = wrow + (mi & 1) * 8 + (lane & 7), kcol = (mi >> 1) * 8;
    const int vrow = wrow + (mi >> 1) * 8 + (lane & 7), vcol = (mi & 1) * 8;

    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % a.stages;
      mbar_wait(&full[st], (t / a.stages) & 1);
      const uint32_t kb = ring + st * L.stage, vb = kb + half;
      const int nvw = min(kWP, max(0, s_end - (s_begin + t * kTile + wrow)));
      {  // every warp computes, its masked positions too: no branch
         // around the shuffles
        // 1. S^T (16 positions x 8 rows): the A fragments first, then
        //    the mmas on two accumulators
        uint32_t ka[kKS][4];
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          if (ks < nks) {
            const bool up = ks == nks - 1 && tail;
            ldsm_x4(tile_addr(kb, kTile, a, krow,
                              (ks * 16 + (up ? 0 : kcol)) * 2), ka[ks]);
            const uint32_t keep = up ? 0u : ~0u;
            ka[ks][2] &= keep;
            ka[ks][3] &= keep;
          }
        }
        float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < kKS; ks += 2) {
          if (ks < nks) H16::mma(sa, ka[ks], qb[ks][0], qb[ks][1]);
          if (ks + 1 < nks)
            H16::mma(sb, ka[ks + 1], qb[ks + 1][0], qb[ks + 1][1]);
        }
        // 2. online softmax per query row (column of S^T): the 8 lanes
        //    of one c4 hold its 16 positions
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = r8 + (e >> 1) * 8 < nvw ? (sa[e] + sb[e]) * a.scale
                                         : -INFINITY;
        float p[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float mx = fmaxf(x[j], x[j + 2]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float2 n = next_max(m[j], mx);
          const float al = exp2f(m[j] - n.y);
          m[j] = n.x;
          p[j] = exp2f(x[j] - n.y);
          p[j + 2] = exp2f(x[j + 2] - n.y);
          l[j] = l[j] * al + (p[j] + p[j + 2]);
#pragma unroll
          for (int i = 0; i < kKS; ++i) {
            acc[i][j] *= al;
            acc[i][j + 2] *= al;
          }
        }
        // 3. v rows past the split's end to 0: p = 0 there, but 0 * NaN
        //    from an unwritten cache row would not be
        if (nvw < kWP) {
          const int cpr = dh * 2 / 16;
          for (int c = lane; c < (kWP - nvw) * cpr; c += 32) {
            const int row = wrow + nvw + c / cpr, col = (c % cpr) * 16;
            asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};"
                         :: "r"(tile_addr(vb, kTile, a, row, col)), "r"(0)
                         : "memory");
          }
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncwarp();
        }
        // 4. P^T as B fragments, p split into parts in T; V^T as A
        //    fragments (ldmatrix.trans), then O^T += V^T P^T
        uint32_t pb[H16::kParts][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float u = p[2 * h] * H16::kPScale, w = p[2 * h + 1] * H16::kPScale;
#pragma unroll
          for (int k = 0; k < H16::kParts; ++k) {
            const uint16_t bu = H16::bits(u), bw = H16::bits(w);
            pb[k][h] = movmatrix_t(pack2(bu, bw));
            u -= H16::back(bu);
            w -= H16::back(bw);
          }
        }
#pragma unroll
        for (int i = 0; i < kKS; ++i) {
          if (i < nks) {
            const bool up = i == nks - 1 && tail;
            ldsm_x4_t(tile_addr(vb, kTile, a, vrow,
                                (i * 16 + (up ? 0 : vcol)) * 2), ka[i]);
          }
        }
#pragma unroll
        for (int k = 0; k < H16::kParts; ++k)
#pragma unroll
          for (int i = 0; i < kKS; ++i)
            if (i < nks) H16::mma(acc[i], ka[i], pb[k][0], pb[k][1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    // the warp's state to shared memory (the ring is free once all are)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[j] += __shfl_xor_sync(0xffffffffu, l[j], off);
    consumers_sync();
    if (r8 == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mw[warp * kRows + 2 * c4 + j] = m[j];
        lw[warp * kRows + 2 * c4 + j] = l[j];
      }
    }
    constexpr float kInv = 1.f / H16::kPScale;
#pragma unroll
    for (int i = 0; i < kKS; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = i * 16 + r8 + (e >> 1) * 8;
        if (i < nks && d < dh)
          scr[(warp * kRows + 2 * c4 + (e & 1)) * dh + d] = acc[i][e] * kInv;
      }
    }
  } else {
    // lane (p, qd): positions p + 8 u (u < kNP) of the warp's, quarter
    // qd of the 16-byte columns for the scores, so each q load serves
    // kNP positions and each k load 8 rows; 16-byte columns lane,
    // lane + 32 of v for p @ v
    constexpr int kNP = kWP / 8;
    constexpr int kJ = DHMAX / 128;
    constexpr int kC = DHMAX / 16;         // columns of a quarter, at most
    float* qs = reinterpret_cast<float*>(sm + L.q);
    float* ps = reinterpret_cast<float*>(sm + L.p) + warp * kWP * kRows;
    const int p = lane & 7, qd = lane >> 3, nch = dh / 4;
    auto ld4 = [&](uint32_t addr) {
      return *reinterpret_cast<const float4*>(sm + (addr - ring));
    };
    float m[kRows], l[kRows], acc[kRows][kJ][4];
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        acc[g][j][0] = acc[g][j][1] = acc[g][j][2] = acc[g][j][3] = 0.f;
    }
    // q to shared memory while the first stages load
    for (int e = tid; e < kRows * dh; e += kConsumerThreads) {
      const int g = e / dh, d = e - g * dh;
      qs[e] = g < gn ? static_cast<const float*>(a.q)[q_row0 + g * a.sq_h + d]
                     : 0.f;
    }
    consumers_sync();
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % a.stages;
      mbar_wait(&full[st], (t / a.stages) & 1);
      const uint32_t kb = ring + st * L.stage, vb = kb + half;
      const int nvw = min(kWP, max(0, s_end - (s_begin + t * kTile + wrow)));
      {  // every warp computes, its masked positions too: no branch
         // around the shuffles
        // 1. scores
        float s[kNP][kRows];
#pragma unroll
        for (int u = 0; u < kNP; ++u)
#pragma unroll
          for (int g = 0; g < kRows; ++g) s[u][g] = 0.f;
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          const int c = qd + 4 * i;
          if (c < nch) {
            float4 kv[kNP];
#pragma unroll
            for (int u = 0; u < kNP; ++u)
              kv[u] = ld4(tile_addr(kb, kTile, a, wrow + p + 8 * u, c * 16));
#pragma unroll
            for (int g = 0; g < kRows; ++g) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qs + g * dh + c * 4);
#pragma unroll
              for (int u = 0; u < kNP; ++u) {
                s[u][g] = fmaf(kv[u].x, qv.x, s[u][g]);
                s[u][g] = fmaf(kv[u].y, qv.y, s[u][g]);
                s[u][g] = fmaf(kv[u].z, qv.z, s[u][g]);
                s[u][g] = fmaf(kv[u].w, qv.w, s[u][g]);
              }
            }
          }
        }
        // 2. online softmax per row over the warp's positions
        float pv[kNP][kRows];
#pragma unroll
        for (int g = 0; g < kRows; ++g) {
          float x[kNP], mx = -INFINITY;
#pragma unroll
          for (int u = 0; u < kNP; ++u) {
            s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], 8);
            s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], 16);
            x[u] = p + 8 * u < nvw ? s[u][g] * a.scale : -INFINITY;
            mx = fmaxf(mx, x[u]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          const float2 n = next_max(m[g], mx);
          const float al = exp2f(m[g] - n.y);
          m[g] = n.x;
          float sum = 0.f;
#pragma unroll
          for (int u = 0; u < kNP; ++u) {
            pv[u][g] = exp2f(x[u] - n.y);
            sum += pv[u][g];
          }
          l[g] = l[g] * al + (qd == 0 ? sum : 0.f);
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            acc[g][j][0] *= al; acc[g][j][1] *= al;
            acc[g][j][2] *= al; acc[g][j][3] *= al;
          }
        }
        if (qd == 0) {
#pragma unroll
          for (int u = 0; u < kNP; ++u) {
            float4* dst = reinterpret_cast<float4*>(ps + (p + 8 * u) * kRows);
            dst[0] = make_float4(pv[u][0], pv[u][1], pv[u][2], pv[u][3]);
            dst[1] = make_float4(pv[u][4], pv[u][5], pv[u][6], pv[u][7]);
          }
        }
        __syncwarp();
        // 3. acc += p @ v over the valid positions only
#pragma unroll
        for (int pp = 0; pp < kWP; ++pp) {
          if (pp < nvw) {
            const float4 pa =
                *reinterpret_cast<const float4*>(ps + pp * kRows);
            const float4 pb =
                *reinterpret_cast<const float4*>(ps + pp * kRows + 4);
            const float pw[kRows] = {pa.x, pa.y, pa.z, pa.w,
                                     pb.x, pb.y, pb.z, pb.w};
#pragma unroll
            for (int j = 0; j < kJ; ++j) {
              const int c = lane + 32 * j;
              if (c < nch) {
                const float4 vv =
                    ld4(tile_addr(vb, kTile, a, wrow + pp, c * 16));
#pragma unroll
                for (int g = 0; g < kRows; ++g) {
                  acc[g][j][0] = fmaf(pw[g], vv.x, acc[g][j][0]);
                  acc[g][j][1] = fmaf(pw[g], vv.y, acc[g][j][1]);
                  acc[g][j][2] = fmaf(pw[g], vv.z, acc[g][j][2]);
                  acc[g][j][3] = fmaf(pw[g], vv.w, acc[g][j][3]);
                }
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int g = 0; g < kRows; ++g)
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
    consumers_sync();
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < kRows; ++g) {
        mw[warp * kRows + g] = m[g];
        lw[warp * kRows + g] = l[g];
      }
    }
#pragma unroll
    for (int g = 0; g < kRows; ++g)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c = lane + 32 * j;
        if (c < nch)
          *reinterpret_cast<float4*>(scr + (warp * kRows + g) * dh + c * 4) =
              make_float4(acc[g][j][0], acc[g][j][1], acc[g][j][2],
                          acc[g][j][3]);
      }
  }
  consumers_sync();

  // -- merge the warps; one split writes out, else the last block combines
  const int64_t row0 = static_cast<int64_t>(b) * a.H + kvh * a.G + g0;
  float* wt = reinterpret_cast<float*>(sm + L.mw);   // weights, in place
  if (tid < kRows) {
    float mm = -INFINITY, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w)
      mm = fmaxf(mm, mw[w * kRows + tid]);
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w)
      ll = fmaf(lw[w * kRows + tid], exp2f(mw[w * kRows + tid] - mm), ll);
    const float scale = a.splits == 1 ? 1.f / ll : 1.f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w)
      wt[w * kRows + tid] = exp2f(mw[w * kRows + tid] - mm) * scale;
    if (a.splits > 1 && tid < gn)
      a.ws_ml[(row0 + tid) * a.splits + split] = make_float2(mm, ll);
  }
  consumers_sync();
  for (int e = tid; e < gn * dh; e += kConsumerThreads) {
    const int r = e / dh, d = e - r * dh;
    float aa = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w)
      aa = fmaf(scr[(w * kRows + r) * dh + d], wt[w * kRows + r], aa);
    if (a.splits == 1)
      a.out[(row0 + r) * dh + d] = aa;
    else
      a.ws[((row0 + r) * a.splits + split) * dh + d] = aa;
  }
  if (a.splits == 1) return;
  // the block's partials, ordered by the barrier, are released to the
  // GPU by one acq_rel arrival; the last block's acquire orders its reads
  consumers_sync();
  if (tid == 0) {
    int* cnt = a.counters + (b * a.Hk + kvh) * a.g_tiles + gt;
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(old) : "l"(cnt) : "memory");
    const bool last = old == a.splits - 1;
    if (last) *cnt = 0;       // ready for the next call
    *flag = last;
  }
  consumers_sync();
  if (!*flag) return;
  // a warp a row: the splits' weights exp2(m - max) / sum into shared
  // memory (the ring is free), then 16-byte columns of the accumulators,
  // every split's load independent of the others
  float* cw = scr + warp * a.splits;
  for (int r = warp; r < gn; r += kConsumerWarps) {
    const float2* ml = a.ws_ml + (row0 + r) * a.splits;
    const float* acc = a.ws + (row0 + r) * a.splits * dh;
    float mm = -INFINITY;
    for (int s = lane; s < a.splits; s += 32) mm = fmaxf(mm, __ldcg(ml + s).x);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    float ll = 0.f;
    for (int s = lane; s < a.splits; s += 32) {
      const float2 x = __ldcg(ml + s);
      cw[s] = exp2f(x.x - mm);
      ll = fmaf(x.y, cw[s], ll);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ll += __shfl_xor_sync(0xffffffffu, ll, off);
    __syncwarp();
    const float inv = 1.f / ll;
    for (int c = lane; c < dh / 4; c += 32) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int s = 0; s < a.splits; ++s) {
        const float w = cw[s];
        const float4 x =
            __ldcg(reinterpret_cast<const float4*>(acc + s * dh) + c);
        o.x = fmaf(w, x.x, o.x);
        o.y = fmaf(w, x.y, o.y);
        o.z = fmaf(w, x.z, o.z);
        o.w = fmaf(w, x.w, o.w);
      }
      reinterpret_cast<float4*>(a.out + (row0 + r) * dh)[c] =
          make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
    }
    __syncwarp();
  }
}

// -- tensor maps ------------------------------------------------------------
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver symbol: fetched through the runtime,
// so the library needs no -lcuda
EncodeTiled encode_fn(cudaError_t* err) {
  static EncodeTiled fn = nullptr;
  static cudaError_t status = cudaSuccess;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    status = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    status = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                     cudaEnableDefault, &found);
#endif
    if (status == cudaSuccess && found != cudaDriverEntryPointSuccess)
      status = cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
  });
  *err = status;
  return fn;
}

struct MapKey {                 // all a map depends on
  const void* ptr;
  long long dims[4], strides[3];
  int dtype, box0, box_s, dim_s, swizzle;
};

struct MapEntry {
  MapKey key;
  CUtensorMap map;
};

// Maps by key, so that a cache read every decode step is described once:
// the serving path reads 28 layers' k and v a step.  Direct-mapped by a
// hash of the key; a collision only costs an encode.
constexpr int kMapSlots = 1024;
std::mutex g_map_mu;
MapEntry g_maps[kMapSlots];
bool g_used[kMapSlots];
long long g_encoded = 0;

uint32_t key_slot(const MapKey& key) {
  const unsigned char* p = reinterpret_cast<const unsigned char*>(&key);
  uint32_t h = 2166136261u;                    // FNV-1a
  for (size_t i = 0; i < sizeof key; ++i) h = (h ^ p[i]) * 16777619u;
  return h % kMapSlots;
}

// dims and strides (elements) of the logical (d, h, s, b) view
int get_map(const void* ptr, int dtype, const long long dims[4],
            const long long strides[4], int box0, int box_s, int dim_h,
            int dim_s, int dim_b, int swz, CUtensorMap* out) {
  const int es = dtype == 0 ? 4 : 2;
  MapKey key;
  std::memset(&key, 0, sizeof key);       // padding bytes compare equal
  key.ptr = ptr;
  key.dtype = dtype;
  key.box0 = box0;
  key.box_s = box_s;
  key.dim_s = dim_s;
  key.swizzle = swz;
  // map dimension i (1..3) holds the logical dimension placed there
  const int place[3] = {dim_h, dim_s, dim_b};
  long long mdims[4] = {dims[0], 0, 0, 0}, mstr[4] = {1, 0, 0, 0};
  for (int l = 0; l < 3; ++l) {
    mdims[place[l]] = dims[l + 1];
    mstr[place[l]] = strides[l + 1];
  }
  for (int i = 0; i < 4; ++i) key.dims[i] = mdims[i];
  for (int i = 0; i < 3; ++i) key.strides[i] = mstr[i + 1] * es;
  const uint32_t slot = key_slot(key);
  std::lock_guard<std::mutex> lock(g_map_mu);
  if (g_used[slot] && std::memcmp(&g_maps[slot].key, &key, sizeof key) == 0) {
    *out = g_maps[slot].map;
    return 0;
  }
  cudaError_t err;
  const EncodeTiled encode = encode_fn(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(box0), 1, 1, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) gdim[i] = static_cast<cuuint64_t>(mdims[i]);
  for (int i = 0; i < 3; ++i) gstride[i] = static_cast<cuuint64_t>(key.strides[i]);
  box[dim_s] = static_cast<cuuint32_t>(box_s);
  const CUtensorMapSwizzle sw =
      swz == 7 ? CU_TENSOR_MAP_SWIZZLE_128B
      : swz == 3 ? CU_TENSOR_MAP_SWIZZLE_64B
      : swz == 1 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUtensorMapDataType dt =
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap map;
  const CUresult res = encode(
      &map, dt, 4, const_cast<void*>(ptr), gdim, gstride, box, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  ++g_encoded;
  g_maps[slot].key = key;
  g_maps[slot].map = map;
  g_used[slot] = true;
  *out = map;
  return 0;
}

// -- launch -------------------------------------------------------------------
// Lets attn_kernel<T, DHMAX> take `smem` bytes of dynamic shared memory on
// the current device `device`, with the whole carveout as shared memory:
// the limit is only ever raised (one dh's launch or occupancy query must
// not lower what another dh of the same instantiation needs).
template <typename T, int DHMAX>
cudaError_t allow_smem(int smem, int device) {
  static std::mutex mu;
  static int set_bytes[64] = {0};         // per device ordinal
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (smem <= set_bytes[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T, DHMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_kernel<T, DHMAX>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err == cudaSuccess) set_bytes[device] = smem;
  return err;
}

template <typename T>
cudaError_t allow_smem_typed(int dh, int smem, int device) {
  return dh <= 128 ? allow_smem<T, 128>(smem, device)
                   : allow_smem<T, 256>(smem, device);
}

cudaError_t allow_smem_for(int dtype, int dh, int smem, int device) {
  switch (dtype) {
    case 0: return allow_smem_typed<float>(dh, smem, device);
    case 1: return allow_smem_typed<__nv_bfloat16>(dh, smem, device);
    default: return allow_smem_typed<__half>(dh, smem, device);
  }
}

template <typename T, int DHMAX>
cudaError_t launch_kernel(const CUtensorMap& km, const CUtensorMap& vm,
                          const Args& a, int B, int smem, int device,
                          cudaStream_t stream) {
  const cudaError_t err = allow_smem<T, DHMAX>(smem, device);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.splits, a.Hk * a.g_tiles, B);
  attn_kernel<T, DHMAX><<<grid, kThreads, smem, stream>>>(km, vm, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const CUtensorMap& km, const CUtensorMap& vm,
                         const Args& a, int B, int smem, int device,
                         cudaStream_t stream) {
  return a.dh <= 128 ? launch_kernel<T, 128>(km, vm, a, B, smem, device, stream)
                     : launch_kernel<T, 256>(km, vm, a, B, smem, device, stream);
}

template <typename T>
const void* kernel_fn(int dh) {
  return dh <= 128 ? reinterpret_cast<const void*>(attn_kernel<T, 128>)
                   : reinterpret_cast<const void*>(attn_kernel<T, 256>);
}

const void* kernel_for(int dtype, int dh) {
  switch (dtype) {
    case 0: return kernel_fn<float>(dh);
    case 1: return kernel_fn<__nv_bfloat16>(dh);
    default: return kernel_fn<__half>(dh);
  }
}

// the slab a row is cut into, and its swizzle (see tile_addr)
void slab_of(int row_bytes, int* slab, int* swz) {
  if (row_bytes % 128 == 0) { *slab = 128; *swz = 7; }
  else if (row_bytes == 64) { *slab = 64; *swz = 3; }
  else if (row_bytes == 32) { *slab = 32; *swz = 1; }
  else { *slab = row_bytes; *swz = 0; }
}

bool shape_ok(int dtype, int dh) {
  const int es = dtype == 0 ? 4 : 2;
  return dtype >= 0 && dtype <= 2 && dh > 0 && dh <= kMaxDh && dh % 4 == 0 &&
         (dh * es) % 16 == 0 &&
         make_layout(dtype == 0, dh, stages_of(dtype == 0, dh)).total <=
             kSmemPerBlock;
}

// the tensor-map place (1..3) of each of the view's dimensions 1..3 (kv
// head, position, batch row), by ascending stride; a dimension of length 1
// goes last
void order_dims(const long long dims[4], const long long st[4],
                int place[4]) {
  place[0] = 0;
  for (int l = 1; l < 4; ++l) {
    int rank = 1;
    for (int o = 1; o < 4; ++o) {
      if (o == l) continue;
      const bool before = dims[o] > 1 && dims[l] > 1
                              ? (st[o] < st[l] || (st[o] == st[l] && o < l))
                              : dims[o] > 1 || (dims[l] == 1 && o < l);
      rank += before;
    }
    place[l] = rank;
  }
}

}  // namespace

// The block the kernel runs for (dtype, dh): positions a stage, stages of
// the ring and the shared memory it asks for (bytes).  Returns 0, or -1
// where the kernel does not take (dtype, dh).  dtype: 0 = float32, 1 =
// bfloat16, 2 = float16.
extern "C" int decode_attention_config(int dtype, int dh, int* tile,
                                       int* stages, int* smem_bytes) {
  if (!shape_ok(dtype, dh)) return -1;
  *tile = tile_of(dtype == 0, dh);
  *stages = stages_of(dtype == 0, dh);
  *smem_bytes = make_layout(dtype == 0, dh, *stages).total;
  return 0;
}

// Blocks of the kernel for (dtype, dh) an SM holds at once, from the
// runtime's occupancy query, and the kernel's registers a thread and
// local (spill) bytes a thread.  Returns the cudaError_t.
extern "C" int decode_attention_occupancy(int dtype, int dh, int device,
                                          int* blocks, int* regs,
                                          int* local_bytes) {
  if (!shape_ok(dtype, dh)) return cudaErrorInvalidValue;
  const int stages = stages_of(dtype == 0, dh);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* fn = kernel_for(dtype, dh);
  const int smem = make_layout(dtype == 0, dh, stages).total;
  err = allow_smem_for(dtype, dh, smem, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads,
                                                        smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) {
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// Tensor maps encoded since the library was loaded (the rest came from
// its cache).
extern "C" long long decode_attention_maps_encoded() {
  std::lock_guard<std::mutex> lock(g_map_mu);
  return g_encoded;
}

namespace {

int launch(const void* q, const void* k, const void* v, int dtype, void* out,
           void* ws, void* counters, int B, int H, int Hk, int S, int dh,
           int n_valid, int chunk, int splits, long long sq_b,
           long long sq_h, long long sk_b, long long sk_h, long long sk_s,
           long long sv_b, long long sv_h, long long sv_s, int device,
           void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if (!shape_ok(dtype, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const int stages = stages_of(dtype == 0, dh);
  if (B <= 0 || B > 65535 || Hk <= 0 ||
      H % Hk != 0 || S <= 0 || n_valid <= 0 || n_valid > S || chunk <= 0 ||
      splits <= 0 || static_cast<long long>(chunk) * (splits - 1) >= n_valid ||
      static_cast<long long>(chunk) * splits < n_valid ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16 ||
      // the last block's weights (4 warps x splits floats) fit the ring
      16LL * splits > static_cast<long long>(stages) *
                          make_layout(dtype == 0, dh, stages).stage ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long dims[4] = {dh, Hk, S, B};
  const long long ks[4] = {1, sk_h, sk_s, sk_b}, vs[4] = {1, sv_h, sv_s, sv_b};
  // each map's dimensions 1..3 by ascending stride of its own cache; a
  // dimension of length 1 goes last, its stride replaced by a multiple of
  // the view's extent (never read: its only coordinate is 0)
  long long kst[4], vst[4];
  long long extent_k = 16, extent_v = 16;
  for (int l = 1; l < 4; ++l) {
    if (dims[l] > 1) {
      if (ks[l] <= 0 || vs[l] <= 0 || (ks[l] * es) % 16 || (vs[l] * es) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
      extent_k = std::max(extent_k, ks[l] * dims[l] * es);
      extent_v = std::max(extent_v, vs[l] * dims[l] * es);
    }
  }
  for (int l = 0; l < 4; ++l) {
    kst[l] = dims[l] > 1 || l == 0 ? ks[l] : (extent_k + 15) / 16 * 16 / es * l;
    vst[l] = dims[l] > 1 || l == 0 ? vs[l] : (extent_v + 15) / 16 * 16 / es * l;
  }
  int kp[4], vp[4];                     // place[l]: map dimension of l
  order_dims(dims, kst, kp);
  order_dims(dims, vst, vp);
  Args a;
  a.q = q;
  a.out = static_cast<float*>(out);
  a.ws = static_cast<float*>(ws);
  a.ws_ml = reinterpret_cast<float2*>(
      a.ws + static_cast<int64_t>(B) * H * splits * dh);
  a.counters = static_cast<int*>(counters);
  a.H = H; a.Hk = Hk; a.G = H / Hk; a.dh = dh;
  a.n_valid = n_valid; a.chunk = chunk; a.splits = splits;
  a.g_tiles = (a.G + kRows - 1) / kRows;
  a.stages = stages;
  slab_of(dh * es, &a.slab, &a.swz);
  a.slabs = dh * es / a.slab;
  a.slab_log2 = a.swz ? (a.slab == 128 ? 7 : a.slab == 64 ? 6 : 5) : 31;
  a.kdim_h = kp[1]; a.kdim_s = kp[2];
  a.vdims = vp[1] | vp[2] << 2;
  a.sq_b = sq_b; a.sq_h = sq_h;
  a.scale = kLog2e / sqrtf(static_cast<float>(dh));
  const int tile = tile_of(dtype == 0, dh);
  const int smem = make_layout(dtype == 0, dh, stages).total;

  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  CUtensorMap km, vm;
  int code = get_map(k, dtype, dims, kst, a.slab / es, tile, kp[1], kp[2],
                     kp[3], a.swz, &km);
  if (code == 0)
    code = get_map(v, dtype, dims, vst, a.slab / es, tile, vp[1], vp[2],
                   vp[3], a.swz, &vm);
  if (code == 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
      case 0: err = launch_typed<float>(km, vm, a, B, smem, device, s); break;
      case 1: err = launch_typed<__nv_bfloat16>(km, vm, a, B, smem, device, s);
              break;
      default: err = launch_typed<__half>(km, vm, a, B, smem, device, s);
               break;
    }
    code = static_cast<int>(err);
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (code == 0) code = static_cast<int>(back);
  }
  return code;
}

}  // namespace

// p holds, as 64-bit integers, in this order: q, k, v, dtype, out, ws,
// counters, B, H, Hk, S, dh, n_valid, chunk, splits, sq_b, sq_h, sk_b,
// sk_h, sk_s, sv_b, sv_h, sv_s, device, stream (one array: a call through
// ctypes then converts one argument, not 25).  q (B, H, dh) through
// strides sq_b, sq_h; k and v (B, Hk, S, dh) through the given element
// strides (each its own), the head dimension contiguous; out (B, H, dh)
// f32 contiguous.  Positions [0, n_valid) are attended, in `splits` splits
// of `chunk` positions (the last may be shorter, none empty), through a
// ring of stages_of(dtype, dh) stages.  With splits > 1, ws holds B * H *
// splits * (dh + 2) floats and counters B * Hk * ceil(G / rows) ints, all
// 0 (the kernel leaves them 0).  TMA's rules: k and v 16-byte aligned, dh *
// sizeof(T) and every stride of a dimension longer than 1 multiples of 16
// bytes.  device: the CUDA ordinal of the tensors and the stream; it is
// made current for the launch and the caller's device restored after.
// Returns 0, a cudaError_t, or minus the CUresult of a failed tensor map.
extern "C" int decode_attention_launch(const long long* p) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(p[i]); };
  auto i32 = [&](int i) { return static_cast<int>(p[i]); };
  return launch(ptr(0), ptr(1), ptr(2), i32(3), ptr(4), ptr(5), ptr(6),
                i32(7), i32(8), i32(9), i32(10), i32(11), i32(12), i32(13),
                i32(14), p[15], p[16], p[17], p[18], p[19], p[20], p[21],
                p[22], i32(23), ptr(24));
}

extern "C" const char* decode_attention_error_string(int code) {
  if (code < 0) return "cuTensorMapEncodeTiled refused the cache's view";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
