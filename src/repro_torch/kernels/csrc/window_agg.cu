// Keyed pane aggregation on Hopper (sm_90a): Jet stages 1 and 2 of the
// device tier's window.
//
// Three kernels, one library:
//
// * window_agg_kernel replaces src/repro/kernels/window_agg.py::window_agg,
//   the Pallas TPU kernel that computes
//
//       out[k, r] = sum_n valid_n * [key_n == k] * [slot_n == r] * value_n
//
//   as two one-hot matrices contracted on the MXU.  A TPU has no fast
//   scatter; this card does, so the op is a scatter-add: a thread per event
//   row (grid-stride), one float atomicAdd per row that contributes
//   (valid && 0 <= key < K && 0 <= slot < R: the one-hot column an
//   out-of-range key or slot never matches), into the (K, R) output.
//
// * accumulate_kernel is the device tier's whole stage-1 step in ONE
//   launch: the reference's accumulate (src/repro/streaming/window.py:116-
//   162), which the port ran as about 35 PyTorch launches around the op's
//   kernel.  Per row: frame = floor(ts / slide), slot = floor-mod(frame,
//   R); min_frame from next_emit (read from device memory: no host sync);
//   late, the slot's old occupant, conflict and live; the flat pane index
//   slot * K + key in int32, an index in [-R*K, 0) wrapped once by R*K and
//   anything still outside [0, R*K) dropped, as jnp's scatter with
//   mode="drop" does (so a key outside [0, K) lands in a neighbouring
//   slot, as in the reference); the pane add in f32.  Per block: the late
//   and conflict counts (one atomicAdd each into the state's counters),
//   the largest live frame of each slot it touched, the largest valid ts.
//
// * emit_kernel is the device tier's whole stage-2 step in ONE launch: the
//   reference's emit (src/repro/streaming/window.py:165-255), a jitted
//   lax.while_loop of (E, R) @ (R, K) rounds, which replaces no TPU kernel
//   (XLA fused it there).  The port ran it as about 30 PyTorch ops a round
//   driven from the host, with a blocking read before the first round and
//   after each.  See "emit" below.
//
// The ordering hazard.  The reference reads every row's occupant from the
// INCOMING slot_frame (window.py:138-141) and only then scatter-maxes
// (:147-148): two frames sharing a slot in one batch both see it empty and
// both go live.  So no block may write slot_frame while another may still
// read it.  The per-slot maxima and the ts maximum go to a workspace
// instead (per device and stream, owned by the wrapper: [0] a ticket, [1]
// the ts maximum, [2, 2 + R) the slot maxima).  Each block releases its
// updates with __threadfence() and takes a ticket; the last block to
// arrive merges the maxima into slot_frame, sets the watermark (max(wm,
// frontier - wm_lag) when the frontier comes from the data, then the
// hint, read from device memory when it is a tensor), and resets the
// workspace for the next call (so nothing fills it before a launch).
//
// Contention.  A Q5 step's rows all fall in one slot (one 10 ms frame a
// step): the scatter-max that the port ran as a torch scatter_reduce_ put
// all 65 536 rows on one word (0.0585 ms, the step's largest kernel).
// Here a warp's live rows that share a slot reduce with __match_any_sync
// and __reduce_max_sync, and a block keeps the maximum of its dominant
// slot (its first row's) in shared memory: one global atomicMax a block.
// Panes: NEXMark's hot auctions repeat keys, so the adds are
// warp-aggregated: rows of a warp with one flat index sum into their
// lowest lane, which adds once.  (A privatised row of the dominant slot's
// K floats in shared memory, flushed once per non-zero bin, measured 3-5 %
// slower at a Q5 step on an H100; see PERF.md.)
//
// Values are f32, bf16 or f16, widened with the intrinsics; accumulation is
// f32.  Counts are exact up to 2^24.  f32 sums differ from run to run in
// the last bits: atomics complete in no fixed order.
//
// What bounds them: bytes.  The op reads 13 B a row and does one 4-byte
// atomic read-modify-write per contributing row.  accumulate reads ts,
// key, value and valid (13 B a row with f32 values) and slot_frame once,
// and reads and writes each pane cell it touches once: at a Q5 step (N =
// 65 536, 9 974 cells) about 0.93 MB, 0.28 us at 3.35 TB/s.  Both are far
// below a launch, so the design is about launches: one a step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {  // b > 0
  const int r = a % b;
  return r < 0 ? r + b : r;
}

template <typename T>
__global__ void window_agg_kernel(const int32_t* __restrict__ keys,
                                  const int32_t* __restrict__ slots,
                                  const T* __restrict__ values,
                                  const uint8_t* __restrict__ valid,
                                  float* __restrict__ out, int64_t n,
                                  int32_t n_keys, int32_t ring_len) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    if (!valid[i]) continue;
    const int32_t k = keys[i];
    const int32_t s = slots[i];
    if (k < 0 || k >= n_keys || s < 0 || s >= ring_len) continue;
    atomicAdd(out + static_cast<int64_t>(k) * ring_len + s,
              to_f32(values[i]));
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 4096;  // grid-stride beyond 132 SMs x 31 blocks

// -- accumulate ----------------------------------------------------------------

constexpr int kAccThreads = 512;
constexpr int64_t kAccMaxBlocks = 1024;

struct AccArgs {
  const int32_t* ts;
  const int32_t* keys;
  const void* values;
  const uint8_t* valid;
  float* panes;               // (R, K), added in place
  int32_t* slot_frame;        // (R,)
  int32_t* watermark;
  const int32_t* next_emit;
  int32_t* dropped_late;
  int32_t* dropped_conflict;
  int32_t* ws;                // [0] ticket, [1] ts max, [2, 2 + R) slot maxima
  const int32_t* hint;        // the hint's tensor, or null
  int64_t n;
  int64_t rows_per_block;
  int hint_value, has_hint;
  int n_keys, ring_len, frames, slide, wm_lag, frontier_from_data;
};

template <typename T>
__global__ void __launch_bounds__(kAccThreads)
accumulate_kernel(const AccArgs a) {
  __shared__ int s_late, s_conflict, s_ts_max, s_dom_max, s_dom, s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int K = a.n_keys, R = a.ring_len;
  const int RK = R * K;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * a.rows_per_block;
  const int64_t end = begin + a.rows_per_block < a.n
                          ? begin + a.rows_per_block : a.n;
  const T* values = static_cast<const T*>(a.values);
  int32_t* slot_max = a.ws + 2;
  if (tid == 0) {
    s_late = s_conflict = 0;
    s_ts_max = INT_MIN;
    s_dom_max = -1;
    // the block's dominant slot: its first row's (rows arrive in event
    // time, so a block's rows mostly share it)
    s_dom = floor_mod(floor_div(a.ts[begin], a.slide), R);
  }
  // window.py:131-133: frames below min_frame had their last window emitted
  const int ne = *a.next_emit;
  const int min_frame = ne < 0 ? -(1 << 30) : floor_div(ne, a.slide) -
                                                  a.frames;
  __syncthreads();
  const int dom = s_dom;
  int late = 0, conflict = 0, ts_max = INT_MIN;
  for (int64_t base = begin; base < end; base += kAccThreads) {
    const int64_t i = base + tid;
    const bool in = i < end;
    // every load of the row at once; slot_frame's waits on ts
    const bool ok = in && a.valid[i];
    const int t = in ? a.ts[i] : 0;
    const int key = in ? a.keys[i] : 0;
    const float value = in ? to_f32(values[i]) : 0.f;
    const int frame = floor_div(t, a.slide);
    const int slot = floor_mod(frame, R);
    bool live = ok && frame >= min_frame;
    late += ok && !live;
    // the frontier's max(where(valid, ts, -1)), over the rows in range
    ts_max = max(ts_max, in ? (ok ? t : -1) : INT_MIN);
    if (live) {                              // the INCOMING occupant
      const int occupant = a.slot_frame[slot];
      if (occupant >= 0 && occupant != frame) {
        ++conflict;
        live = false;
      }
    }
    // the largest live frame a slot: a warp's rows of one slot reduce in
    // their lowest lane, which updates the block's dominant slot in shared
    // memory or any other slot in the workspace
    const unsigned live_lanes = __ballot_sync(kFull, live);
    if (live) {
      const unsigned group = __match_any_sync(live_lanes, slot);
      const int most = __reduce_max_sync(group, frame);
      if (lane == __ffs(group) - 1) {
        if (slot == dom) {
          atomicMax(&s_dom_max, most);
        } else {
          atomicMax(slot_max + slot, most);
        }
      }
    }
    // window.py:140-143: int32 slot * K + key (wrapping as int32 does), a
    // negative index wrapped once by R * K, the rest outside dropped
    int flat = static_cast<int>(static_cast<uint32_t>(slot) *
                                    static_cast<uint32_t>(K) +
                                static_cast<uint32_t>(key));
    if (flat < 0) flat += RK;
    const bool adds = live && flat >= 0 && flat < RK;
    const float v = adds ? value : 0.f;
    const unsigned add_lanes = __ballot_sync(kFull, adds);
    if (adds) {
      const unsigned group = __match_any_sync(add_lanes, flat);
      float sum = v;
      if (group != (1u << lane)) {           // sum the group in lane order
        sum = 0.f;
        for (unsigned m = group; m != 0; m &= m - 1) {
          sum += __shfl_sync(group, v, __ffs(m) - 1);
        }
      }
      if (lane == __ffs(group) - 1) atomicAdd(a.panes + flat, sum);
    }
  }
  late = __reduce_add_sync(kFull, late);
  conflict = __reduce_add_sync(kFull, conflict);
  ts_max = __reduce_max_sync(kFull, ts_max);
  if (lane == 0) {
    if (late) atomicAdd(&s_late, late);
    if (conflict) atomicAdd(&s_conflict, conflict);
    atomicMax(&s_ts_max, ts_max);
  }
  __syncthreads();
  if (tid == 0) {
    if (s_late) atomicAdd(a.dropped_late, s_late);
    if (s_conflict) atomicAdd(a.dropped_conflict, s_conflict);
    if (s_dom_max >= 0) atomicMax(slot_max + dom, s_dom_max);
    atomicMax(a.ws + 1, s_ts_max);
  }
  // release this block's workspace updates, then take a ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(a.ws, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: every other block has read slot_frame; merge
  for (int r = tid; r < R; r += kAccThreads) {
    const int most = atomicExch(slot_max + r, -1);
    if (most > a.slot_frame[r]) a.slot_frame[r] = most;
  }
  if (tid == 0) {
    const int all_ts_max = atomicExch(a.ws + 1, INT_MIN);
    atomicExch(a.ws, 0);
    int wm = *a.watermark;
    if (a.frontier_from_data) {
      // int32 max(ts) - wm_lag, wrapping as int32 does
      const int frontier = static_cast<int>(
          static_cast<uint32_t>(all_ts_max) -
          static_cast<uint32_t>(a.wm_lag));
      wm = max(wm, frontier);
    }
    if (a.has_hint) wm = max(wm, a.hint != nullptr ? *a.hint : a.hint_value);
    *a.watermark = wm;
  }
}

template <typename T>
cudaError_t launch_accumulate(AccArgs a, cudaStream_t s) {
  // a few rows a thread at most, contiguous runs a block (a block's rows
  // then share a slot), at most kAccMaxBlocks blocks
  int64_t blocks = (a.n + kAccThreads - 1) / kAccThreads;
  if (blocks > kAccMaxBlocks) blocks = kAccMaxBlocks;
  const int64_t per = (a.n + blocks - 1) / blocks;
  a.rows_per_block = (per + kAccThreads - 1) / kAccThreads * kAccThreads;
  blocks = (a.n + a.rows_per_block - 1) / a.rows_per_block;
  accumulate_kernel<T><<<static_cast<unsigned>(blocks), kAccThreads, 0, s>>>(
      a);
  return cudaGetLastError();
}

// -- emit --------------------------------------------------------------------
//
// The reference's round: E candidate window ends w_i = ne + i * slide; the
// ready ones (w_i <= wm) are a prefix; window i sums the panes of every
// slot whose frame f >= 0 has L_i - F < f <= L_i (L_i = floor(w_i / slide)
// - 1) in one (E, R) @ (R, K) matmul; each ready window evicts the slot of
// frame L_i - F + 1 (slot_frame -1, its pane row zeroed); the front moves
// past the emitted windows and fast-forwards to the next window a live
// frame is in.  Rounds run until the front passes the watermark or the
// next round would not fit the EB output rows.
//
// Two facts make one launch enough.  (1) The plan (each round's front, the
// rows emitted, the evictions) needs slot_frame, the watermark and
// next_emit, 4 KB at Q5's R = 1 008, never the panes: every block derives
// it in shared memory, the rounds in order, by the reference's arithmetic
// (int32, wrapping as torch's int32 tensors do).  (2) An eviction never
// changes a later window's sum: window ends rise by at least one slide
// from window to window, so a frame L - F + 1 retired by window L is below
// every later window.  So each window's slots can be read from slot_frame
// as it came, and the sums need no ordering between rounds.
//
// The sums.  Each block owns a strip of 32 columns (a lane each), so no
// other block reads what it zeroes: it sums its strip of the panes over
// up to kEmitChunk windows a pass, reading each pane row the pass needs
// once and adding it into the register sum of each window that holds the
// slot (the slot's window mask, a bit a window).  The pass's slots, in
// ascending order, are split among the warps; the warps' partial sums add
// in warp order through shared memory.  Every order is fixed, so a run
// repeats bit for bit.  The adds are IEEE float32 (no TF32, no lower
// type), compensated (Kahan): a window of Q5's 1 000 frames of float sums
// is within a few ulps of its exact sum, where any plain float32 order
// (cuBLAS's in the plain version included) strays by up to about 1e-4 at
// values of unit scale.  Counts below 2^24 are exact in any order.  Then
// the block writes zeros in its strip of the rows past the emitted ones
// and zeroes its strip of the evicted pane rows (after reading them).
// Block 0 writes window_ends and valid.  The last block to take a ticket
// (every other block has read slot_frame and next_emit by then) writes
// slot_frame, next_emit and the status [rows, rounds], and resets the
// ticket.
//
// What bounds it: bytes.  At a catch-up Q5 step (one round of 8 windows
// over 1 007 of the 1 008 pane rows) it reads the 66 MB of panes once and
// writes the 66 MB (EB, K) result buffer once: 0.04 ms at 3.35 TB/s.  The
// plan is a few block-wide reductions a round, repeated in every block.

constexpr int kEmitThreads = 256;
constexpr int kEmitWarps = kEmitThreads / 32;
constexpr int kEmitChunk = 8;      // windows summed in one pass over the panes
constexpr int kEmitUnroll = 8;     // pane loads a lane keeps in flight
constexpr int kFar = 1 << 30;      // "no frame / no front", as the reference
constexpr long long kSharedMax = 232448;  // shared memory a block, opted in

struct EmitArgs {
  float* panes;               // (R, K): read, evicted rows zeroed
  int32_t* slot_frame;        // (R,)
  const int32_t* watermark;
  int32_t* next_emit;
  float* results;             // (EB, K)
  int32_t* window_ends;       // (EB,)
  uint8_t* valid;             // (EB,)
  int32_t* ws;                // [0] ticket, [1] rows, [2] rounds
  int n_keys, ring_len, frames, slide, per_round, rows_max;
};

// int32 arithmetic that wraps, as torch's int32 tensors do
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// The block's minimum of v (every thread gets it).  scratch: kEmitWarps ints.
__device__ __forceinline__ int block_min(int v, int* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = __reduce_min_sync(kFull, v);
  __syncthreads();                         // scratch's last readers are done
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return __reduce_min_sync(kFull, lane < kEmitWarps ? scratch[lane] : INT_MAX);
}

// The reference's fast_forward (window.py:191-202) over the slot frames sf.
__device__ int fast_forward(int ne, const int* sf, int R, int F, int slide,
                            int wm, int caught, int* scratch) {
  int nxt = INT_MAX;
  for (int r = threadIdx.x; r < R; r += kEmitThreads) {
    const int f = sf[r];
    const bool in = f >= 0 && wmul(wadd(f, F), slide) >= ne;
    nxt = min(nxt, in ? max(ne, wmul(wadd(f, 1), slide)) : kFar);
  }
  nxt = block_min(nxt, scratch);
  if (ne >= kFar) return ne;
  return nxt <= wm ? nxt : max(ne, caught);
}

// s += v, compensated (Kahan): lost keeps what the float32 add rounded
// away, so s - lost stays within a few ulps of the exact sum however many
// terms it has.  Integer values below 2^24 add exactly and lose nothing.
__device__ __forceinline__ void kahan_add(float& s, float& lost, float v) {
  const float y = v - lost;
  const float t = s + y;
  lost = (t - s) - y;
  s = t;
}

// floor(w / slide) - 1: the last frame of the window ending at w
__device__ __forceinline__ int last_frame(int w, int slide) {
  return wadd(floor_div(w, slide), -1);
}

__global__ void __launch_bounds__(kEmitThreads)
emit_kernel(const EmitArgs a) {
  extern __shared__ int smem[];
  __shared__ int s_scratch[kEmitWarps];
  __shared__ int s_last;
  const int R = a.ring_len, K = a.n_keys, F = a.frames, slide = a.slide;
  const int E = a.per_round, EB = a.rows_max;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* s_sf0 = smem;                        // (R,) slot_frame as it came
  int* s_sf = s_sf0 + R;                    // (R,) with the evictions
  int* s_slot = s_sf + R;                   // (R,) a pass's slots
  int* s_mask = s_slot + R;                 // (R,) their window masks
  int* s_front = s_mask + R;                // (EB / E,) each round's front
  float* s_part = reinterpret_cast<float*>(s_front + EB / E);
  // (kEmitWarps, kEmitChunk, 32) partial sums

  // -- the plan ---------------------------------------------------------
  const int wm = *a.watermark;
  const int ne_in = *a.next_emit;
  int first = INT_MAX;
  for (int r = tid; r < R; r += kEmitThreads) {
    const int f = a.slot_frame[r];
    s_sf0[r] = s_sf[r] = f;
    first = min(first, f >= 0 ? f : kFar);
  }
  first = block_min(first, s_scratch);      // also publishes s_sf
  // the first window end strictly beyond the watermark
  const int caught = wmul(wadd(floor_div(wm, slide), 1), slide);
  int ne = ne_in < 0 ? (first < kFar ? wmul(wadd(first, 1), slide) : kFar)
                     : ne_in;
  ne = fast_forward(ne, s_sf, R, F, slide, wm, caught, s_scratch);
  int rows = 0, rounds = 0;
  bool go = ne <= wm && ne < kFar;
  while (go) {                              // uniform across the block
    if (tid == 0) s_front[rounds] = ne;
    int emitted = 0;                        // the ready prefix
    for (int i = 0; i < E; ++i) emitted += wadd(ne, wmul(i, slide)) <= wm;
    // evict the frame each ready window retires (each slot reads and
    // writes only its own entry)
    for (int r = tid; r < R; r += kEmitThreads) {
      const int f = s_sf[r];
      if (f < 0) continue;
      for (int i = 0; i < emitted; ++i) {
        const int L = last_frame(wadd(ne, wmul(i, slide)), slide);
        if (f == wadd(L, 1 - F)) {
          s_sf[r] = -1;
          break;
        }
      }
    }
    __syncthreads();
    ne = fast_forward(wadd(ne, wmul(emitted, slide)), s_sf, R, F, slide, wm,
                      caught, s_scratch);
    rows += emitted;
    ++rounds;
    // every round but the last emits E windows, so rounds < EB / E holds
    // whenever rows + E <= EB does; the bound keeps s_front in range anyway
    go = ne <= wm && ne < kFar && rows + E <= EB && rounds < EB / E;
  }
  __syncthreads();                          // s_front is complete

  // -- the sums ---------------------------------------------------------
  const int col = blockIdx.x * 32 + lane;
  const bool in_col = col < K;
  const float* pane_col = a.panes + (in_col ? col : 0);
  for (int j0 = 0; j0 < rows; j0 += kEmitChunk) {
    const int nj = min(kEmitChunk, rows - j0);
    int lo[kEmitChunk], hi[kEmitChunk];     // window i holds frames (lo, hi]
#pragma unroll
    for (int i = 0; i < kEmitChunk; ++i) {
      const int j = j0 + i;
      const int L = j < rows ? last_frame(
          wadd(s_front[j / E], wmul(j % E, slide)), slide) : 0;
      hi[i] = L;
      lo[i] = wadd(L, -F);
    }
    // the pass's slots in ascending order, with their window masks
    int n = 0;
    for (int base = 0; base < R; base += kEmitThreads) {
      const int r = base + tid;
      int m = 0;
      if (r < R) {
        const int f = s_sf0[r];
#pragma unroll
        for (int i = 0; i < kEmitChunk; ++i) {
          if (i < nj && f >= 0 && f > lo[i] && f <= hi[i]) m |= 1 << i;
        }
      }
      const unsigned hit = __ballot_sync(kFull, m != 0);
      __syncthreads();                      // s_scratch's readers are done
      if (lane == 0) s_scratch[warp] = __popc(hit);
      __syncthreads();
      int at = n;
      for (int w = 0; w < warp; ++w) at += s_scratch[w];
      if (m != 0) {
        at += __popc(hit & ((1u << lane) - 1));
        s_slot[at] = r;
        s_mask[at] = m;
      }
      for (int w = 0; w < kEmitWarps; ++w) n += s_scratch[w];
    }
    __syncthreads();                        // the list is complete
    // this warp's share of the list, in order
    const int begin = static_cast<int>(static_cast<int64_t>(n) * warp /
                                       kEmitWarps);
    const int end = static_cast<int>(static_cast<int64_t>(n) * (warp + 1) /
                                     kEmitWarps);
    float acc[kEmitChunk], lost[kEmitChunk];
#pragma unroll
    for (int i = 0; i < kEmitChunk; ++i) acc[i] = lost[i] = 0.f;
    for (int e = begin; e < end; e += kEmitUnroll) {
      float v[kEmitUnroll];
      int m[kEmitUnroll];
#pragma unroll
      for (int u = 0; u < kEmitUnroll; ++u) {
        const bool ok = e + u < end;
        m[u] = ok ? s_mask[e + u] : 0;
        v[u] = ok ? pane_col[static_cast<int64_t>(s_slot[e + u]) * K] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kEmitUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < kEmitChunk; ++i) {
          if ((m[u] >> i) & 1) kahan_add(acc[i], lost[i], v[u]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kEmitChunk; ++i) {
      s_part[(warp * kEmitChunk + i) * 32 + lane] = acc[i] - lost[i];
    }
    __syncthreads();
    for (int t = tid; t < nj * 32; t += kEmitThreads) {
      const int i = t >> 5, l = t & 31;
      const int c = blockIdx.x * 32 + l;
      float sum = 0.f, sum_lost = 0.f;
      for (int w = 0; w < kEmitWarps; ++w) {
        kahan_add(sum, sum_lost, s_part[(w * kEmitChunk + i) * 32 + l]);
      }
      if (c < K) {
        a.results[static_cast<int64_t>(j0 + i) * K + c] = sum - sum_lost;
      }
    }
    __syncthreads();                        // s_part and the list are free
  }
  // the rows past the emitted ones: zeros
  for (int t = tid; t < (EB - rows) * 32; t += kEmitThreads) {
    const int c = blockIdx.x * 32 + (t & 31);
    if (c < K) a.results[static_cast<int64_t>(rows + (t >> 5)) * K + c] = 0.f;
  }
  // this strip of the evicted pane rows (every warp's reads are done)
  for (int r = warp; r < R; r += kEmitWarps) {
    if (s_sf0[r] >= 0 && s_sf[r] < 0 && in_col) {
      a.panes[static_cast<int64_t>(r) * K + col] = 0.f;
    }
  }
  if (blockIdx.x == 0) {
    // as the reference writes them: each round's E candidate ends (the
    // last round's not-ready tail included), valid on the emitted prefix
    for (int j = tid; j < EB; j += kEmitThreads) {
      const bool run = j < rounds * E;
      a.window_ends[j] = run ? wadd(s_front[j / E], wmul(j % E, slide)) : 0;
      a.valid[j] = j < rows;
    }
  }

  // -- the last block: the state and the status --------------------------
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(a.ws, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int r = tid; r < R; r += kEmitThreads) {
    if (s_sf[r] != s_sf0[r]) a.slot_frame[r] = s_sf[r];
  }
  if (tid == 0) {
    *a.next_emit = ne < kFar ? ne : ne_in;
    a.ws[1] = rows;
    a.ws[2] = rounds;
    atomicExch(a.ws, 0);
  }
}

// Runs ``body`` with ``device`` current and restores the caller's device,
// so the thread's device is the same before and after the call as PyTorch
// expects.
template <typename F>
int on_device(int device, F body) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = body();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // namespace

// The op into its (K, R) output ``out``, zeroed by the caller.
// value_dtype: 0 = float32, 1 = bfloat16, 2 = float16.  device: the CUDA
// ordinal the tensors and the stream belong to.  Returns the cudaError_t
// of the launch (0 = success); n <= 0 launches nothing.
extern "C" int window_agg_launch(const void* keys, const void* slots,
                                 const void* values, int value_dtype,
                                 const void* valid, void* out, long long n,
                                 int n_keys, int ring_len, int device,
                                 void* stream) {
  if (n <= 0) return 0;
  if (value_dtype < 0 || value_dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return on_device(device, [&]() {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    const unsigned grid = static_cast<unsigned>(blocks);
    const int32_t* k = static_cast<const int32_t*>(keys);
    const int32_t* sl = static_cast<const int32_t*>(slots);
    const uint8_t* v = static_cast<const uint8_t*>(valid);
    float* o = static_cast<float*>(out);
    switch (value_dtype) {
      case 0:
        window_agg_kernel<float><<<grid, kThreads, 0, s>>>(
            k, sl, static_cast<const float*>(values), v, o, n, n_keys,
            ring_len);
        break;
      case 1:
        window_agg_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
            k, sl, static_cast<const __nv_bfloat16*>(values), v, o, n,
            n_keys, ring_len);
        break;
      default:
        window_agg_kernel<__half><<<grid, kThreads, 0, s>>>(
            k, sl, static_cast<const __half*>(values), v, o, n, n_keys,
            ring_len);
        break;
    }
    return cudaGetLastError();
  });
}

// accumulate, one launch.  ``args`` packs 24 integers (pointers as
// addresses): ts, keys, values, value_dtype, valid, n, panes, slot_frame,
// watermark, next_emit, dropped_late, dropped_conflict, ws, hint (0 =
// none), hint_value, has_hint, n_keys, ring_len, frames, slide, wm_lag,
// frontier_from_data, device, stream.  n >= 1; ws holds
// 2 + ring_len int32, initialised [0, INT_MIN, -1, ...] and left so.
extern "C" int accumulate_launch(const long long* args) {
  AccArgs a;
  a.ts = reinterpret_cast<const int32_t*>(args[0]);
  a.keys = reinterpret_cast<const int32_t*>(args[1]);
  a.values = reinterpret_cast<const void*>(args[2]);
  const int value_dtype = static_cast<int>(args[3]);
  a.valid = reinterpret_cast<const uint8_t*>(args[4]);
  a.n = args[5];
  a.panes = reinterpret_cast<float*>(args[6]);
  a.slot_frame = reinterpret_cast<int32_t*>(args[7]);
  a.watermark = reinterpret_cast<int32_t*>(args[8]);
  a.next_emit = reinterpret_cast<const int32_t*>(args[9]);
  a.dropped_late = reinterpret_cast<int32_t*>(args[10]);
  a.dropped_conflict = reinterpret_cast<int32_t*>(args[11]);
  a.ws = reinterpret_cast<int32_t*>(args[12]);
  a.hint = reinterpret_cast<const int32_t*>(args[13]);
  a.hint_value = static_cast<int>(args[14]);
  a.has_hint = static_cast<int>(args[15]);
  a.n_keys = static_cast<int>(args[16]);
  a.ring_len = static_cast<int>(args[17]);
  a.frames = static_cast<int>(args[18]);
  a.slide = static_cast<int>(args[19]);
  a.wm_lag = static_cast<int>(args[20]);
  a.frontier_from_data = static_cast<int>(args[21]);
  const int device = static_cast<int>(args[22]);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(args[23]);
  a.rows_per_block = 0;
  if (a.n <= 0 || value_dtype < 0 || value_dtype > 2 || a.slide <= 0 ||
      a.ring_len <= 0 || a.n_keys <= 0 ||
      static_cast<long long>(a.ring_len) * a.n_keys > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return on_device(device, [&]() {
    switch (value_dtype) {
      case 0: return launch_accumulate<float>(a, s);
      case 1: return launch_accumulate<__nv_bfloat16>(a, s);
      default: return launch_accumulate<__half>(a, s);
    }
  });
}

// Dynamic shared memory of one emit block: the slot frames as they came
// and as evicted, a pass's slots and their window masks, each round's
// front, and the warps' partial sums.
extern "C" long long emit_shared_bytes(int ring_len, int rows_max,
                                       int per_round) {
  return 4 * (4LL * ring_len + rows_max / per_round) +
         4LL * kEmitWarps * kEmitChunk * 32;
}

// emit, one launch.  ``args`` packs 16 integers (pointers as addresses):
// panes, slot_frame, watermark, next_emit, results, window_ends, valid, ws,
// n_keys, ring_len, frames, slide, per_round (E), rows_max (EB), device,
// stream.  ws holds 4 int32, initialised [0, ...]: the kernel leaves
// [0, rows, rounds, ...].  Every output row is written, so the outputs need
// no fill.
extern "C" int emit_launch(const long long* args) {
  EmitArgs a;
  a.panes = reinterpret_cast<float*>(args[0]);
  a.slot_frame = reinterpret_cast<int32_t*>(args[1]);
  a.watermark = reinterpret_cast<const int32_t*>(args[2]);
  a.next_emit = reinterpret_cast<int32_t*>(args[3]);
  a.results = reinterpret_cast<float*>(args[4]);
  a.window_ends = reinterpret_cast<int32_t*>(args[5]);
  a.valid = reinterpret_cast<uint8_t*>(args[6]);
  a.ws = reinterpret_cast<int32_t*>(args[7]);
  a.n_keys = static_cast<int>(args[8]);
  a.ring_len = static_cast<int>(args[9]);
  a.frames = static_cast<int>(args[10]);
  a.slide = static_cast<int>(args[11]);
  a.per_round = static_cast<int>(args[12]);
  a.rows_max = static_cast<int>(args[13]);
  const int device = static_cast<int>(args[14]);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(args[15]);
  if (a.n_keys <= 0 || a.ring_len <= 0 || a.frames <= 0 || a.slide <= 0 ||
      a.per_round <= 0 || a.rows_max < a.per_round ||
      static_cast<long long>(a.rows_max) * a.n_keys > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem_bytes =
      emit_shared_bytes(a.ring_len, a.rows_max, a.per_round);
  if (smem_bytes > kSharedMax) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_bytes);
  return on_device(device, [&]() {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    const unsigned grid = static_cast<unsigned>((a.n_keys + 31) / 32);
    emit_kernel<<<grid, kEmitThreads, smem, s>>>(a);
    return cudaGetLastError();
  });
}

extern "C" const char* window_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
