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
//   with one __ballot_sync and __popc (warp_votes), so no shared atomic
//   is contended; warp c sums partition c's counts over the warps with
//   shuffles (block_scan_votes) and adds it to the output with one
//   global atomicAdd if it is not zero;
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
// route_pack: the route plan's send layout in ONE launch.  The reference
// computes it in jnp (streaming/executor.py:187-207): dest = valid ?
// key // K_loc : n, each event's position among the earlier events bound
// for its destination (a one-hot cumsum), keep = valid & (pos < C), the
// overflow count, and a scatter of the kept events' fields into an
// (n, C) layout.  Here it is a counting sort held in the shared memory of
// one thread-block cluster (route_pack_kernel):
//
//   * layout: a cluster of kCluster = 8 blocks (the portable maximum) of
//     1024 threads, launched with cudaLaunchKernelEx and a cluster
//     dimension; block b takes rows [b * rows_per_block, ...) (whole
//     1024-row tiles), and each of its 32 warps a contiguous run of
//     rows_per_block / 32 of them, 32 at a time, so any N is correct
//     (longer runs beyond the path's shape: 16 384 rows are 64 a warp);
//   * histograms: each warp's votes along its run (warp_votes, as
//     route_counts' kernel runs them) summed in registers, then scanned
//     over the warps with shuffles (block_scan_votes, route_counts'
//     too): each warp's offset inside the block, and the block's totals
//     a destination in its own shared memory;
//   * offsets: after cluster.sync() every block reads the totals of the
//     blocks before it through distributed shared memory
//     (cluster.map_shared_rank): its base offset a destination, the
//     exclusive prefix that a global scan gave before, with no second
//     launch;
//   * ranks: each warp walks its run again with no block barrier: a row's
//     rank among its 32 from ballots and %lanemask_lt, plus the count of
//     its column's rows before them, which lane c carries for
//     destination c and the row reads with one shuffle; then capacity
//     (keep = valid & pos < C) and overflow, reduced a warp and added
//     into block 0's shared memory, which stores n_overflow (no zero
//     fill).  Rows keep their order: blocks, warps and lanes ascend with
//     the row index;
//   * claims: the reference's .at[d, p].set resolves duplicate cells to the
//     last row in order (on the CPU backend the tests compare against), and
//     a row that keeps nothing writes the fill (zeros) there, so every row
//     that targets a cell claims it, with atomicMax of (row << 1 | keep) on
//     an n_dest x C array of claims spread over the cluster's shared memory
//     (cells_per_block = ceil(n_dest * C / 8) a block);
//   * output: after a second cluster.sync() each block writes its share of
//     cells: the winning row's ts, key, value (f32, bf16 or f16, widened
//     to f32 bits) and ok = 1 where that row keeps its event, else zeros,
//     four cells a thread with their gathers in flight together.  Every
//     cell of send is written, so the wrapper allocates send, pos and
//     n_overflow with torch.empty (one allocation).  pos is stored only
//     when the caller asks for it: the route plan reads send and
//     n_overflow alone, so it passes null.
//
// A negative index wraps once by the axis length, as in jnp's indexing;
// anything still outside is dropped, and a column lookup that stays
// outside reads jnp's int32 fill, INT_MIN.
//
// Limits: n_dest <= 32 (a ballot a destination); n_dest * C <= 8 * 49 152
// claim cells (192 KB of shared memory a block: kMaxCellsPerBlock); N <
// 2^30 (a claim holds row << 1).  The executor's capacity rule, C =
// max(8, B / n / n * factor), stays far inside at the paper's shapes
// (4 x 8 192 cells, 16 KB a block).
//
// What bounds it: bytes.  Counts read 5 B a row (pid, valid) and write 4 B
// a partition; at the route plan's N = 16 384 rows that is 82 KB, about
// 0.025 us at 3.35 TB/s.  The pack reads 13 B a row and writes the (n, 4,
// C) int32 send buffer (and 4 B of position a row when asked): 0.73 MB,
// 0.22 us (0.80 MB, 0.24 us with positions).  Every
// call here is launch-bound; the pack's design is about launches (one,
// with no fill before it), not bytes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 1024;                 // rows per block in tile kernels
constexpr int kWarps = kTile / 32;
constexpr int kBallotMaxP = 32;
constexpr int kSharedMaxP = 12288;          // 48 KB of int32 bins
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCluster = 8;                 // route_pack's blocks (portable)
constexpr int kMaxCellsPerBlock = 49152;    // 192 KB of claims a block
constexpr int kGather = 4;                  // route_pack's cells in flight

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A row's partition: its pid floor-divided by ``divisor`` (1 for
// route_counts, k_loc for the route plan), or -1 (counts nowhere) if the
// row is not valid or lies past the end.
__device__ __forceinline__ int partition_of(const int32_t* pids,
                                            const uint8_t* valid, int64_t i,
                                            int64_t n, int divisor) {
  if (i >= n) return -1;
  const int pid = pids[i];         // both loads in flight at once
  return valid[i] ? floor_div(pid, divisor) : -1;
}

// Warp votes (n_parts <= 32): lane c < n_parts gets the number of the
// warp's lanes whose partition p is c (p = -1: none), from one
// __ballot_sync and __popc a partition.  Every lane of the warp calls it.
__device__ __forceinline__ int warp_votes(int p, int n_parts) {
  const int lane = threadIdx.x & 31;
  int mine = 0;
  for (int c = 0; c < n_parts; ++c) {
    const unsigned b = __ballot_sync(kFull, p == c);
    if (lane == c) mine = __popc(b);
  }
  return mine;
}

// The block's counts from its 32 warps' votes (``mine``, lane c holding
// partition c's): warp c < n_parts scans partition c's counts over the
// warps with shuffles, leaves in warp_counts[w][c] the count in warps
// before w, and returns the block's total of partition c in every lane of
// warp c (0 in the other warps).  Every thread of the block calls it.
__device__ __forceinline__ int block_scan_votes(
    int mine, int n_parts, int32_t (*warp_counts)[kBallotMaxP + 1]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane < n_parts) warp_counts[warp][lane] = mine;
  __syncthreads();
  int total = 0;
  if (warp < n_parts) {
    const int x = warp_counts[lane][warp];     // warp `lane`'s count
    int incl = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    warp_counts[lane][warp] = incl - x;
    total = __shfl_sync(kFull, incl, 31);
  }
  __syncthreads();
  return total;
}

// route_counts for P <= 32: a tile of kTile rows a block, each bin added
// once.
__global__ void __launch_bounds__(kTile)
route_hist_ballot_kernel(const int32_t* __restrict__ pids,
                         const uint8_t* __restrict__ valid, int64_t n,
                         int n_parts, int32_t* __restrict__ counts) {
  __shared__ int32_t warp_counts[kWarps][kBallotMaxP + 1];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const int total = block_scan_votes(
      warp_votes(partition_of(pids, valid, i, n, 1), n_parts), n_parts,
      warp_counts);
  if ((threadIdx.x & 31) == 0 && total != 0) {
    atomicAdd(counts + (threadIdx.x >> 5), total);
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

struct PackArgs {
  const int32_t* ts;
  const int32_t* keys;
  const void* values;
  const uint8_t* valid;
  int32_t* pos;
  int32_t* send;          // (n_dest, 4, cap): ts, key, value bits, ok
  int32_t* n_overflow;
  int64_t n;
  int64_t rows_per_block;  // a multiple of kTile
  int n_dest, k_loc, cap, cells_per_block;
};

template <typename T>
__device__ __forceinline__ int32_t value_bits(const void* values, int64_t i) {
  return __float_as_int(to_f32(static_cast<const T*>(values)[i]));
}

template <>
__device__ __forceinline__ int32_t value_bits<float>(const void* values,
                                                     int64_t i) {
  return static_cast<const int32_t*>(values)[i];   // the bits, NaNs intact
}

// The route plan's counting sort in one cluster (see the file's comment).
template <typename T>
__global__ void __launch_bounds__(kTile)
route_pack_kernel(const PackArgs a) {
  extern __shared__ int32_t claims[];          // this block's share of cells
  __shared__ int32_t warp_counts[kWarps][kBallotMaxP + 1];
  __shared__ int32_t totals[kBallotMaxP];
  __shared__ int32_t block_base[kBallotMaxP];
  __shared__ int32_t overflow;                 // block 0's: the cluster sum
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t begin = rank * a.rows_per_block;
  const int64_t end = begin + a.rows_per_block < a.n
                          ? begin + a.rows_per_block : a.n;
  // warp w takes the contiguous run of `chunk` rows from wbegin, 32 at a
  // time (lane l the l-th of each 32)
  const int chunk = static_cast<int>(a.rows_per_block / kWarps);
  const int64_t wbegin = begin + static_cast<int64_t>(warp) * chunk;
  const int cells = a.n_dest * a.cap;
  const int cell0 = static_cast<int>(rank) * a.cells_per_block;
  int my_cells = cells - cell0;
  if (my_cells > a.cells_per_block) my_cells = a.cells_per_block;
  for (int j = tid; j < my_cells; j += kTile) claims[j] = -1;
  if (tid == 0) overflow = 0;

  // 1. the votes of each warp's run a destination (dest = key // k_loc),
  // summed in registers, then scanned over the warps: warp_counts[w][c]
  // is then the block's count of destination c before warp w's run
  int mine = 0;
  int part = partition_of(a.keys, a.valid, wbegin + lane, end, a.k_loc);
  for (int k = 0; k < chunk; k += 32) {
    const int p = part;                        // the next 32 load meanwhile
    part = partition_of(a.keys, a.valid, wbegin + k + 32 + lane, end,
                        a.k_loc);
    mine += warp_votes(p, a.n_dest);
  }
  const int total = block_scan_votes(mine, a.n_dest, warp_counts);
  if (lane == 0 && warp < a.n_dest) totals[warp] = total;
  cluster.sync();

  // 2. the base offset a destination: the totals of the blocks before
  if (tid < a.n_dest) {
    int run = 0;
    for (unsigned b = 0; b < rank; ++b) {
      run += *cluster.map_shared_rank(&totals[tid], b);
    }
    block_base[tid] = run;
  }
  __syncthreads();

  // 3. positions, capacity, overflow and claims, each warp along its run
  // with no block barrier: lane c carries destination c's count of the
  // rows before the next 32, and a row reads its column's from that lane
  const unsigned below = lanemask_lt();
  int run = lane < a.n_dest ? block_base[lane] + warp_counts[warp][lane] : 0;
  int ovf = 0;
  int64_t i = wbegin + lane;
  bool ok = false;
  int key = 0;
  if (i < end) {
    key = a.keys[i];
    ok = a.valid[i];
  }
  for (int k = 0; k < chunk; k += 32, i += 32) {
    const bool in = i < end;
    // executor.py:187: dest = where(valid, key // K_loc, n)
    const int dest = ok ? floor_div(key, a.k_loc) : a.n_dest;
    const bool row_ok = ok;
    ok = false;                                // the next 32 load meanwhile
    if (i + 32 < end) {
      key = a.keys[i + 32];
      ok = a.valid[i + 32];
    }
    // :190-191: the one-hot column read is min(dest, n - 1), a negative one
    // wrapped once by n (jnp.take_along_axis)
    int col = dest < a.n_dest - 1 ? dest : a.n_dest - 1;
    if (col < 0) col += a.n_dest;
    int count = 0, r = 0;
    for (int c = 0; c < a.n_dest; ++c) {
      const unsigned b = __ballot_sync(kFull, in && dest == c);
      if (lane == c) count = __popc(b);
      if (col == c) r = __popc(b & below);
    }
    const int at = __shfl_sync(kFull, run, col >= 0 ? col : 0);
    run += count;
    if (in) {
      const int pos = col >= 0 ? at + r : INT_MIN;
      const bool keep = row_ok && pos < a.cap;
      ovf += row_ok && !keep;
      // :199-200: d = where(keep, dest, n - 1), p = min(pos, C - 1); then
      // .at[d, p] wraps a negative index once and drops what stays outside
      int d = keep ? dest : a.n_dest - 1;
      int p = pos < a.cap - 1 ? pos : a.cap - 1;
      if (d < 0) d += a.n_dest;
      if (p < 0) p += a.cap;
      if (d >= 0 && d < a.n_dest && p >= 0 && p < a.cap) {
        const int cell = d * a.cap + p;
        const unsigned owner = cell / a.cells_per_block;
        atomicMax(cluster.map_shared_rank(claims, owner) +
                      (cell - static_cast<int>(owner) * a.cells_per_block),
                  static_cast<int>(i << 1) | (keep ? 1 : 0));
      }
      if (a.pos != nullptr) a.pos[i] = pos;
    }
  }
  ovf = __reduce_add_sync(kFull, ovf);
  if (lane == 0 && ovf != 0) {
    atomicAdd(cluster.map_shared_rank(&overflow, 0), ovf);
  }
  cluster.sync();        // every claim and the overflow are in

  // 4. every cell of this block's share: the winner's fields, or zeros;
  // kGather cells a thread at a time, their gathers all in flight before
  // any store
  if (rank == 0 && tid == 0) *a.n_overflow = overflow;
  for (int j0 = tid; j0 < my_cells; j0 += kGather * kTile) {
    int32_t f_ts[kGather], f_key[kGather], f_val[kGather], f_ok[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int j = j0 + u * kTile;
      const int c = j < my_cells ? claims[j] : -1;
      f_ts[u] = f_key[u] = f_val[u] = 0;
      f_ok[u] = c >= 0 && (c & 1);
      if (f_ok[u]) {
        const int w = c >> 1;
        f_ts[u] = __ldg(a.ts + w);
        f_key[u] = __ldg(a.keys + w);
        f_val[u] = value_bits<T>(a.values, w);
      }
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int j = j0 + u * kTile;
      if (j >= my_cells) break;
      const int cell = cell0 + j;
      const int d = cell / a.cap;
      int32_t* out = a.send + static_cast<int64_t>(d) * 4 * a.cap +
                     (cell - d * a.cap);
      out[0] = f_ts[u];
      out[a.cap] = f_key[u];
      out[2 * a.cap] = f_val[u];
      out[3 * a.cap] = f_ok[u];
    }
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

// Raise-only: the dynamic shared memory an instantiation may take (the
// attribute is per function, set on the current device).
template <typename T>
cudaError_t allow_smem(int bytes) {
  static int allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      route_pack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <typename T>
cudaError_t launch_pack(const PackArgs& a, cudaStream_t stream) {
  const int smem = a.cells_per_block * static_cast<int>(sizeof(int32_t));
  cudaError_t err = allow_smem<T>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kTile);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, route_pack_kernel<T>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
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
          p, v, n, n_parts, c);
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

// The route plan's send layout, one cluster launch.  value_dtype: 0 =
// float32, 1 = bfloat16, 2 = float16.  rows_per_block (a multiple of
// 1024) and cells_per_block come from the wrapper's plan (route.py's
// pack_plan): 8 blocks of rows_per_block rows cover n, 8 of
// cells_per_block claims cover n_dest * cap.  pos (n,) or null (no
// positions stored), send (n_dest, 4, cap) and n_overflow (1,) int32 are
// written whole; nothing needs zeroing.
extern "C" int route_pack_launch(const void* ts, const void* keys,
                                 const void* values, int value_dtype,
                                 const void* valid, long long n, int n_dest,
                                 int k_loc, int cap, long long rows_per_block,
                                 int cells_per_block, void* pos, void* send,
                                 void* n_overflow, int device, void* stream) {
  if (n_dest <= 0 || n_dest > kBallotMaxP || k_loc <= 0 || cap <= 0 ||
      n <= 0 || n >= (1LL << 30) || rows_per_block % kTile != 0 ||
      rows_per_block * kCluster < n || cells_per_block <= 0 ||
      cells_per_block > kMaxCellsPerBlock ||
      static_cast<long long>(cells_per_block) * kCluster <
          static_cast<long long>(n_dest) * cap ||
      value_dtype < 0 || value_dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PackArgs a;
  a.ts = static_cast<const int32_t*>(ts);
  a.keys = static_cast<const int32_t*>(keys);
  a.values = values;
  a.valid = static_cast<const uint8_t*>(valid);
  a.pos = static_cast<int32_t*>(pos);
  a.send = static_cast<int32_t*>(send);
  a.n_overflow = static_cast<int32_t*>(n_overflow);
  a.n = n;
  a.rows_per_block = rows_per_block;
  a.n_dest = n_dest;
  a.k_loc = k_loc;
  a.cap = cap;
  a.cells_per_block = cells_per_block;
  return on_device(device, [&]() {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (value_dtype) {
      case 0: return launch_pack<float>(a, s);
      case 1: return launch_pack<__nv_bfloat16>(a, s);
      default: return launch_pack<__half>(a, s);
    }
  });
}

// The cluster route_pack launches: its blocks, their threads, and the
// most clusters of it the card can hold at once for ``cells_per_block``
// claims a block (cudaOccupancyMaxActiveClusters; 0 means it cannot run).
extern "C" int route_pack_cluster(int cells_per_block, int* blocks_out,
                                  int* threads_out, int* max_clusters,
                                  int device) {
  *blocks_out = kCluster;
  *threads_out = kTile;
  return on_device(device, [&]() {
    const int smem = cells_per_block * static_cast<int>(sizeof(int32_t));
    cudaError_t err = allow_smem<float>(smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kTile);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaOccupancyMaxActiveClusters(max_clusters,
                                          route_pack_kernel<float>, &cfg);
  });
}

extern "C" const char* route_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
