// Exact k=1 nearest-neighbour search over masked, padded point clouds.
//
// Replaces the Pallas TPU kernel glim_tpu/ops/pallas_knn.py::_nn_kernel
// (launched by nn_search_pallas). It computes what that kernel computes, not
// how: for every query q the index of the nearest valid target and its
// squared distance, with
//
//   d2 = (|q|^2 + |t|^2) - 2 q.t          (FP32; FMA allowed, no TF32)
//
// a running (min d2, argmin) under a strict '<' in target order, so ties keep
// the lowest index; d2 clamped >= 0 at the end; an invalid target carries
// |t|^2 = +inf (packed by the wrapper into the .w lane of its float4); an
// invalid query writes (0, +inf). Any Q and N are accepted: the ragged query
// and target edges are masked here, none of the TPU tile multiples apply.
//
// Layout: one thread per query; the block stages tiles of float4 targets in
// shared memory and walks all N in a loop inside the block (the TPU grid's
// sequential target axis). Every thread of a warp reads the same target, so
// the shared-memory loads are broadcasts.
//
// What bounds it on an H100: FP32 FMA issue. A pair costs ~8 flops (3 for the
// dot product, the |q|^2 + |t|^2 sum, the -2 scale, compare and select); the
// main path's five lookups per scan (2 x 16384 + 3 x 4096 queries against
// 131072 targets, ~5.9e9 pairs) are ~47 GFLOP a scan against the card's
// 67 TFLOP/s of FP32 outside the tensor cores. With one thread per query,
// Q = 16384 at 256 threads a block is only 64 blocks for 132 SMs; this kernel
// uses 128-thread blocks (128 blocks), which still leaves the card thinly
// occupied (about 4 warps per SM). Splitting N across blocks with a second
// reduction pass, or mma-based distance tiles, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // queries per block
constexpr int kTile = 1024;     // float4 targets staged per step (16 KB)

__global__ void __launch_bounds__(kThreads)
nn_search_kernel(const float* __restrict__ queries,
                 const uint8_t* __restrict__ qmask,
                 const float4* __restrict__ targets,
                 int Q, int N,
                 int32_t* __restrict__ out_idx,
                 float* __restrict__ out_d2) {
  __shared__ float4 tile[kTile];

  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool live = qi < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = queries[3 * qi + 0];
    qy = queries[3 * qi + 1];
    qz = queries[3 * qi + 2];
  }
  const float q_sq = fmaf(qz, qz, fmaf(qy, qy, qx * qx));

  float best = __int_as_float(0x7f800000);   // +inf
  int best_idx = 0;

  for (int base = 0; base < N; base += kTile) {
    const int n = min(kTile, N - base);
    __syncthreads();   // previous tile fully consumed
    for (int i = threadIdx.x; i < n; i += kThreads) tile[i] = targets[base + i];
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float4 t = tile[j];
        const float dot = fmaf(qz, t.z, fmaf(qy, t.y, qx * t.x));
        const float d2 = fmaf(-2.0f, dot, q_sq + t.w);
        if (d2 < best) {
          best = d2;
          best_idx = base + j;
        }
      }
    }
  }

  if (live) {
    if (qmask[qi]) {
      out_idx[qi] = best_idx;
      out_d2[qi] = fmaxf(best, 0.0f);
    } else {
      out_idx[qi] = 0;
      out_d2[qi] = __int_as_float(0x7f800000);
    }
  }
}

}  // namespace

extern "C" {

// queries (Q, 3) f32, qmask (Q,) bytes (0 = invalid), targets_xyzw (N, 4) f32
// [x, y, z, |t|^2 or +inf]; writes out_idx (Q,) int32 and out_d2 (Q,) f32 on
// `stream`. Returns cudaGetLastError() after the launch (0 on success).
int glim_nn_search(const float* queries, const uint8_t* qmask,
                   const float4* targets_xyzw, int Q, int N,
                   int32_t* out_idx, float* out_d2, cudaStream_t stream) {
  if (Q <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (Q + kThreads - 1) / kThreads;
  nn_search_kernel<<<blocks, kThreads, 0, stream>>>(
      queries, qmask, targets_xyzw, Q, N, out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}

const char* glim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
