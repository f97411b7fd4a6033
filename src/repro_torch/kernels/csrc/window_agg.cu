// Keyed pane aggregation on Hopper (sm_90a): Jet stage-1 accumulate.
//
// Replaces src/repro/kernels/window_agg.py::window_agg, the Pallas TPU
// kernel that computes
//
//     out[k, r] = sum_n valid_n * [key_n == k] * [slot_n == r] * value_n
//
// as two one-hot matrices contracted on the MXU.  A TPU has no fast scatter;
// this card does, so the port computes the same function as a scatter-add:
// one thread per event row (grid-stride loop), one float atomicAdd per row
// that contributes.  Nothing of the TPU tiling carries over.
//
// A row contributes only if valid && 0 <= key < n_keys && 0 <= slot <
// ring_len.  That bounds check is the counterpart of the one-hot column an
// out-of-range key or slot never matches in the TPU kernel, and of
// ``mode="drop"`` in the reference scatter (streaming/window.py:142-143,
// which the route exchange feeds negative keys, executor.py:215-216): the
// kernel never writes out of bounds.
//
// Strides let one kernel fill both layouts: the op's (K, R) output
// (stride_slot = 1, stride_key = R), zeroed by the wrapper, and the
// executor's (R, K) pane matrix (stride_slot = K, stride_key = 1), added in
// place, so the main path allocates and adds no K x R delta buffer per step.
//
// Values are f32, bf16 or f16, widened with the intrinsics; accumulation is
// f32.  Counts are exact up to 2^24.  f32 sums differ from run to run in
// the last bits: atomics complete in no fixed order.
//
// What bounds it: about N * 13 bytes read (key, slot, value, valid) plus
// one 4-byte atomic read-modify-write per contributing row.  At the main
// path's N = 65536 that is under a microsecond of memory traffic, so the
// kernel is launch-bound.  A faster design is later work: fuse the late and
// conflict masks and the slot_frame scatter-max (streaming/window.py:126-148)
// into this kernel, which removes a dozen small launches around it, or
// privatise partial sums in shared memory where keys repeat within a block.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void window_agg_kernel(const int32_t* __restrict__ keys,
                                  const int32_t* __restrict__ slots,
                                  const T* __restrict__ values,
                                  const uint8_t* __restrict__ valid,
                                  float* __restrict__ out, int64_t n,
                                  int32_t n_keys, int32_t ring_len,
                                  int64_t stride_slot, int64_t stride_key) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    if (!valid[i]) continue;
    const int32_t k = keys[i];
    const int32_t s = slots[i];
    if (k < 0 || k >= n_keys || s < 0 || s >= ring_len) continue;
    atomicAdd(out + s * stride_slot + k * stride_key, to_f32(values[i]));
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 4096;  // grid-stride beyond 132 SMs x 31 blocks

template <typename T>
cudaError_t launch(const void* keys, const void* slots, const void* values,
                   const void* valid, void* out, int64_t n, int32_t n_keys,
                   int32_t ring_len, int64_t stride_slot, int64_t stride_key,
                   cudaStream_t stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  window_agg_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(slots),
      static_cast<const T*>(values), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), n, n_keys, ring_len, stride_slot, stride_key);
  return cudaGetLastError();
}

}  // namespace

// value_dtype: 0 = float32, 1 = bfloat16, 2 = float16.  device: the CUDA
// ordinal the tensors and the stream belong to; the launch makes it current
// and restores the caller's current device after, so the thread's device is
// the same before and after the call as PyTorch expects.  Returns the
// cudaError_t of the launch (0 = success); n <= 0 launches nothing.
extern "C" int window_agg_launch(const void* keys, const void* slots,
                                 const void* values, int value_dtype,
                                 const void* valid, void* out, long long n,
                                 int n_keys, int ring_len,
                                 long long stride_slot, long long stride_key,
                                 int device, void* stream) {
  if (n <= 0) return 0;
  if (value_dtype < 0 || value_dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (value_dtype) {
    case 0:
      err = launch<float>(keys, slots, values, valid, out, n, n_keys,
                          ring_len, stride_slot, stride_key, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(keys, slots, values, valid, out, n, n_keys,
                                  ring_len, stride_slot, stride_key, s);
      break;
    default:
      err = launch<__half>(keys, slots, values, valid, out, n, n_keys,
                           ring_len, stride_slot, stride_key, s);
      break;
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* window_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
