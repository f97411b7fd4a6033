// Partition routing on Hopper (sm_90a): the keyed exchange's counting sort.
//
// Replaces src/repro/kernels/route.py::route_counts (and route_offsets), the
// Pallas TPU kernel that computes
//
//     counts[p] = sum_n valid_n * [pid_n == p]
//
// as a one-hot matrix summed on the MXU, plus an exclusive prefix of the
// counts (the all-to-all send layout).  This card has fast atomics and warp
// votes, so the port histograms instead:
//
// * P <= 32 (the route plan's P is the rank count): a block of 1024 threads
//   takes a tile of 1024 rows, one a thread; each warp counts a partition
//   with one __ballot_sync and __popc, so no shared atomic is contended;
//   the warps' counts are summed in shared memory and the block adds each
//   non-zero bin to the output with one global atomicAdd, or writes its
//   tile's histogram for the counting sort below;
// * P <= 12 288 (48 KB of int32 bins): a histogram in shared memory per
//   block, flushed with one global atomicAdd per non-zero bin;
// * beyond that: one global atomicAdd per counted row.
//
// A row counts only if it is valid and its partition lies in [0, P), as in
// the TPU kernel, where any other id matches no one-hot column.
//
// route_offsets' scan is exclusive_scan_kernel: one block of 1024 threads
// walks the vector in chunks of 1024, a warp-shuffle scan inside each chunk
// and a carry between chunks.
//
// The route plan's per-event positions (the reference computes them with a
// one-hot cumsum, streaming/executor.py:189-197) are a counting sort in
// three kernels and a write:
//   1. route_hist_ballot_kernel in tile mode: each tile's histogram of
//      destinations dest = key // k_loc, laid out (P, tiles);
//   2. exclusive_scan_kernel over that (P * tiles) vector: entry (c, t) is
//      then the number of rows whose destination is below c, plus those
//      with destination c in tiles before t;
//   3. route_rank_kernel: a row's position among the rows with its
//      destination is its tile's offset, the warps before it in the tile
//      and its rank in its warp (ballots and __popc of the lanes below it);
//      it applies the capacity (keep = valid & pos < C), counts overflow,
//      and claims its (destination, position) cell with atomicMax of its
//      row index;
//   4. route_write_kernel: the row that holds a cell's claim writes its ts,
//      key, value bits and ok = 1 into the (P, 4, C) int32 send buffer.
// The reference scatters with jnp's ``.at[d, p].set``, whose duplicate
// indices resolve to the last row in order (on the CPU backend that the
// tests compare against); rows that do not keep an event write the fill
// value (zeros) there, so the claim is taken by every row that targets a
// cell and only a kept row's claim writes.  A negative index wraps once by
// the axis length, as in jnp's indexing; anything still outside is dropped,
// and a column lookup that stays outside reads jnp's int32 fill, INT_MIN.
//
// What bounds it: bytes.  Counts read 5 B a row (pid, valid) and write 4 B
// a partition; at the route plan's N = 16 384 rows that is 82 KB, about
// 0.025 us at 3.35 TB/s, so every call here is launch-bound.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTile = 1024;                 // rows per block in tile kernels
constexpr int kWarps = kTile / 32;
constexpr int kBallotMaxP = 32;
constexpr int kSharedMaxP = 12288;          // 48 KB of int32 bins
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// A row's partition: its pid floor-divided by ``divisor`` (1 for
// route_counts, k_loc for the route plan), or -1 (counts nowhere) if the
// row is not valid or lies past the end.
__device__ __forceinline__ int partition_of(const int32_t* pids,
                                            const uint8_t* valid, int64_t i,
                                            int64_t n, int divisor) {
  return (i < n && valid[i]) ? floor_div(pids[i], divisor) : -1;
}

// Tile histograms by warp votes (P <= 32).  tile_hist null: add each bin
// into counts; else write the tile's bins at tile_hist[c * n_tiles + tile].
__global__ void __launch_bounds__(kTile)
route_hist_ballot_kernel(const int32_t* __restrict__ pids,
                         const uint8_t* __restrict__ valid, int64_t n,
                         int n_parts, int divisor,
                         int32_t* __restrict__ counts,
                         int32_t* __restrict__ tile_hist, int64_t n_tiles) {
  __shared__ int32_t warp_counts[kWarps][kBallotMaxP];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const int p = partition_of(pids, valid, i, n, divisor);
  int mine = 0;
  for (int c = 0; c < n_parts; ++c) {
    const unsigned b = __ballot_sync(kFull, p == c);
    if (lane == c) mine = __popc(b);
  }
  if (lane < n_parts) warp_counts[warp][lane] = mine;
  __syncthreads();
  if (threadIdx.x < n_parts) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w][threadIdx.x];
    if (tile_hist != nullptr) {
      tile_hist[threadIdx.x * n_tiles + blockIdx.x] = total;
    } else if (total != 0) {
      atomicAdd(counts + threadIdx.x, total);
    }
  }
}

__global__ void route_hist_shared_kernel(const int32_t* __restrict__ pids,
                                         const uint8_t* __restrict__ valid,
                                         int64_t n, int n_parts,
                                         int32_t* __restrict__ counts) {
  extern __shared__ int32_t bins[];
  for (int c = threadIdx.x; c < n_parts; c += blockDim.x) bins[c] = 0;
  __syncthreads();
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    const int p = partition_of(pids, valid, i, n, 1);
    if (p >= 0 && p < n_parts) atomicAdd(bins + p, 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n_parts; c += blockDim.x) {
    if (bins[c] != 0) atomicAdd(counts + c, bins[c]);
  }
}

__global__ void route_hist_global_kernel(const int32_t* __restrict__ pids,
                                         const uint8_t* __restrict__ valid,
                                         int64_t n, int n_parts,
                                         int32_t* __restrict__ counts) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    const int p = partition_of(pids, valid, i, n, 1);
    if (p >= 0 && p < n_parts) atomicAdd(counts + p, 1);
  }
}

// out[i] = sum of in[0..i); in and out may be the same buffer.  One block.
__global__ void __launch_bounds__(kTile)
exclusive_scan_kernel(const int32_t* in, int32_t* out, int64_t len) {
  __shared__ int32_t warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int64_t base = 0; base < len; base += kTile) {
    const int64_t i = base + threadIdx.x;
    const int v = i < len ? in[i] : 0;
    int x = v;                                  // inclusive scan in the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    const int before = warp > 0 ? warp_sums[warp - 1] : 0;
    if (i < len) out[i] = carry + before + x - v;
    carry += warp_sums[kWarps - 1];
    __syncthreads();                            // before warp_sums is reused
  }
}

// Per row: its position among earlier rows with its destination, keep,
// overflow, and its claim on a send cell (see the file's comment).
__global__ void __launch_bounds__(kTile)
route_rank_kernel(const int32_t* __restrict__ keys,
                  const uint8_t* __restrict__ valid, int64_t n, int n_dest,
                  int k_loc, int cap, const int32_t* __restrict__ scan,
                  int64_t n_tiles, int32_t* __restrict__ pos_out,
                  int32_t* __restrict__ cell_out,
                  int32_t* __restrict__ winner,
                  int32_t* __restrict__ n_overflow) {
  __shared__ int32_t warp_before[kWarps][kBallotMaxP];
  __shared__ int32_t overflow;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const bool in = i < n;
  const bool ok = in && valid[i];
  // executor.py:187: dest = where(valid, key // K_loc, n)
  const int dest = ok ? floor_div(keys[i], k_loc) : n_dest;
  // :190-191: the one-hot column read is min(dest, n - 1), a negative one
  // wrapped once by n (jnp.take_along_axis)
  int col = dest < n_dest - 1 ? dest : n_dest - 1;
  if (col < 0) col += n_dest;
  const unsigned below = lanemask_lt();
  int mine = 0, rank = 0;
  for (int c = 0; c < n_dest; ++c) {
    const unsigned b = __ballot_sync(kFull, in && dest == c);
    if (lane == c) mine = __popc(b);
    if (col == c) rank = __popc(b & below);
  }
  if (lane < n_dest) warp_before[warp][lane] = mine;
  if (threadIdx.x == 0) overflow = 0;
  __syncthreads();
  if (threadIdx.x < n_dest) {                   // exclusive over the warps
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_before[w][threadIdx.x];
      warp_before[w][threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();
  if (in) {
    int pos = INT_MIN;                          // jnp's int32 fill
    if (col >= 0) {
      const int32_t* s = scan + static_cast<int64_t>(col) * n_tiles;
      pos = s[blockIdx.x] - s[0] + warp_before[warp][col] + rank;
    }
    const bool keep = ok && pos < cap;
    if (ok && !keep) atomicAdd(&overflow, 1);
    // :199-200: d = where(keep, dest, n - 1), p = min(pos, C - 1); then
    // .at[d, p] wraps a negative index once and drops what stays outside
    int d = keep ? dest : n_dest - 1;
    int p = pos < cap - 1 ? pos : cap - 1;
    if (d < 0) d += n_dest;
    if (p < 0) p += cap;
    const int cell = (d >= 0 && d < n_dest && p >= 0 && p < cap)
                         ? d * cap + p : -1;
    if (cell >= 0) atomicMax(winner + cell, static_cast<int>(i));
    pos_out[i] = pos;
    cell_out[i] = keep ? cell : -1;
  }
  __syncthreads();
  if (threadIdx.x == 0 && overflow != 0) atomicAdd(n_overflow, overflow);
}

__global__ void route_write_kernel(const int32_t* __restrict__ ts,
                                   const int32_t* __restrict__ keys,
                                   const int32_t* __restrict__ value_bits,
                                   const int32_t* __restrict__ cell_in,
                                   const int32_t* __restrict__ winner,
                                   int64_t n, int cap,
                                   int32_t* __restrict__ send) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    const int cell = cell_in[i];
    if (cell < 0 || winner[cell] != static_cast<int>(i)) continue;
    int32_t* out = send + static_cast<int64_t>(cell / cap) * 4 * cap + cell % cap;
    out[0] = ts[i];
    out[cap] = keys[i];
    out[2 * cap] = value_bits[i];
    out[3 * cap] = 1;
  }
}

int64_t grid_for(int64_t n, int64_t per_block, int64_t cap) {
  int64_t g = (n + per_block - 1) / per_block;
  if (g < 1) g = 1;
  return g < cap ? g : cap;
}

unsigned blocks(int64_t n, int64_t per_block, int64_t cap) {
  return static_cast<unsigned>(grid_for(n, per_block, cap));
}

// Runs ``body`` with ``device`` current and restores the caller's device.
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

// counts (P,) int32 must be zeroed by the caller; n may be 0.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int route_counts_launch(const void* pids, const void* valid,
                                   long long n, int n_parts, void* counts,
                                   int device, void* stream) {
  if (n_parts <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&]() {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* p = static_cast<const int32_t*>(pids);
    const uint8_t* v = static_cast<const uint8_t*>(valid);
    int32_t* c = static_cast<int32_t*>(counts);
    if (n_parts <= kBallotMaxP) {
      route_hist_ballot_kernel<<<blocks(n, kTile, INT_MAX), kTile, 0, s>>>(
          p, v, n, n_parts, 1, c, nullptr, 0);
    } else if (n_parts <= kSharedMaxP) {
      route_hist_shared_kernel<<<blocks(n, kThreads * 8, 264), kThreads,
                                 n_parts * sizeof(int32_t), s>>>(
          p, v, n, n_parts, c);
    } else {
      route_hist_global_kernel<<<blocks(n, kThreads, 1024), kThreads, 0,
                                 s>>>(p, v, n, n_parts, c);
    }
    return cudaGetLastError();
  });
}

// Exclusive scan of ``len`` int32 values (in and out may alias).
extern "C" int route_scan_launch(const void* in, void* out, long long len,
                                 int device, void* stream) {
  if (len <= 0) return 0;
  return on_device(device, [&]() {
    exclusive_scan_kernel<<<1, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(in), static_cast<int32_t*>(out), len);
    return cudaGetLastError();
  });
}

// The route plan's counting sort, steps 1 and 2: tile_hist is (n_dest,
// n_tiles) int32 with n_tiles = ceil(n / 1024); it is written, then
// scanned in place.  n_dest <= 32.
extern "C" int route_tile_hist_launch(const void* keys, const void* valid,
                                      long long n, int n_dest, int k_loc,
                                      void* tile_hist, int device,
                                      void* stream) {
  if (n_dest <= 0 || n_dest > kBallotMaxP || k_loc <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  return on_device(device, [&]() {
    const int64_t tiles = grid_for(n, kTile, INT_MAX);
    route_hist_ballot_kernel<<<static_cast<unsigned>(tiles), kTile, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(keys), static_cast<const uint8_t*>(valid),
        n, n_dest, k_loc, nullptr, static_cast<int32_t*>(tile_hist), tiles);
    return cudaGetLastError();
  });
}

// Steps 3 and 4, after the scan: scan is the scanned tile_hist; winner
// (n_dest * cap) int32 filled with -1, send (n_dest, 4, cap) int32 and
// n_overflow (1,) int32 zeroed by the caller; pos and cell are (n,) int32
// outputs (cell is scratch).
extern "C" int route_pack_launch(const void* ts, const void* keys,
                                 const void* value_bits, const void* valid,
                                 long long n, int n_dest, int k_loc, int cap,
                                 const void* scan, void* pos, void* cell,
                                 void* winner, void* send, void* n_overflow,
                                 int device, void* stream) {
  if (n_dest <= 0 || n_dest > kBallotMaxP || k_loc <= 0 || cap <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  return on_device(device, [&]() {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t tiles = grid_for(n, kTile, INT_MAX);
    route_rank_kernel<<<static_cast<unsigned>(tiles), kTile, 0, s>>>(
        static_cast<const int32_t*>(keys), static_cast<const uint8_t*>(valid),
        n, n_dest, k_loc, cap, static_cast<const int32_t*>(scan), tiles,
        static_cast<int32_t*>(pos), static_cast<int32_t*>(cell),
        static_cast<int32_t*>(winner), static_cast<int32_t*>(n_overflow));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    route_write_kernel<<<blocks(n, kThreads, 1024), kThreads, 0, s>>>(
        static_cast<const int32_t*>(ts), static_cast<const int32_t*>(keys),
        static_cast<const int32_t*>(value_bits),
        static_cast<const int32_t*>(cell), static_cast<const int32_t*>(winner),
        n, cap, static_cast<int32_t*>(send));
    return cudaGetLastError();
  });
}

extern "C" const char* route_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
