// Keyed pane aggregation on Hopper (sm_90a): Jet stage-1 accumulate.
//
// Two kernels, one library:
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

extern "C" const char* window_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
