// Exact k=1 nearest-neighbour search over masked, padded point clouds.
//
// Replaces the Pallas TPU kernel glim_tpu/ops/pallas_knn.py::_nn_kernel
// (launched by nn_search_pallas). It computes what that kernel computes, not
// how: for every query q the index of the nearest valid target and its
// squared distance, with
//
//   d2 = (|q|^2 + |t|^2) - 2 q.t          (FP32; FMA allowed, no TF32)
//
// ties to the lowest index, d2 clamped >= 0, an invalid target carrying
// |t|^2 = +inf, an invalid query (or one with no valid target) giving
// (0, +inf). Any Q and N are accepted.
//
// What bounds it on an H100: the FP32 instruction rate. The work is Q x N
// pairs (8 flops a pair in the reference's expansion); the inputs are a few
// MiB and stay in the 50 MB L2, so bytes never bound it. At Q = 16384, N = 131072 that is
// 17.2 GFLOP against 67 TFLOP/s of FP32 outside the tensor cores: 0.256 ms.
// This design spends about 4.4 instructions a pair (3 FFMA, 7/8 FMNMX, the
// chunk update, 1/8 LDS), against the bound's 4 FMA slots.
//
// Design (three launches on the caller's stream, one call of the wrapper):
//  1. pack: per tile of kTile targets, the valid ones compacted in index
//     order to the front as float4 [x, y, z, |t|^2], the rest of the tile
//     padded with |t|^2 = +inf, with each packed entry's target index and
//     the tile's count of valid targets. Masked targets cost no pairs.
//  2. search: a grid of (query blocks x S target splits), S chosen on the
//     host (ops/nn_search.py::launch_geometry) so that both main-path shapes
//     put several blocks on every SM; a split is a whole number of tiles.
//     - Register tiling: each thread keeps kRows queries, pre-scaled to
//       -2q, with their running (best, chunk); one shared-memory target
//       serves kRows pairs, and the kRows chains are independent.
//     - Per pair three FMAs and one min: d' = fma(-2qx, tx, fma(-2qy, ty,
//       fma(-2qz, tz, |t|^2))) = d2 - |q|^2 has the same argmin; the min of
//       d' over a chunk of kChunk targets is compared with the running best
//       once a chunk (strict '<', so the earliest chunk keeps a tie), and
//       only the chunk is recorded. After the split, the winning chunk is
//       re-evaluated (bitwise the same FMAs) and its first target equal to
//       the best is the split's argmin: the lowest index on ties.
//     - Packed tiles are double-buffered in shared memory with cp.async:
//       the next tile loads while the current one is scanned, up to its
//       count of valid targets. Packed order is index order, so the lowest
//       packed position is the lowest index.
//     - A warp whose 32 x kRows queries are all invalid skips the scan.
//     Each split writes a partial (best d', packed position) per query.
//  3. merge: per query, the S partials in split order with strict '<'
//     (lowest index on ties across splits; kMergeLanes threads a query,
//     reduced lexicographically), the winner's target index, and
//     its d2 recomputed the reference's way, (|q|^2 + |t|^2) - 2 q.t,
//     clamped.
// d' and d2 order two targets differently only on near-ties that no
// decisive comparison can see (both round at the magnitude of |t|^2).
//
// Tensor cores are not used: the dot product has depth 3 (4 with |t|^2
// folded in) against an mma k-step of 8 in TF32, and TF32's 10-bit mantissa
// breaks the decisive-index rule unless it runs as 3xTF32, which gives about
// 495 x 4/8 / 3 = 80 TFLOP/s on the dot while the min and the index stay on
// the CUDA cores. That design is the kernel's later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                     // threads a search block
constexpr int kRows = 8;                          // queries a thread
constexpr int kQueriesPerBlock = kThreads * kRows;
constexpr int kTile = 512;                        // float4 targets a stage (8 KB)
constexpr int kChunk = 8;                         // targets a best-update
constexpr int kMergeThreads = 128;
constexpr int kMergeLanes = 4;                    // threads a query in the merge

static_assert(kTile % kThreads == 0 && kTile % kChunk == 0, "tile shape");
static_assert(32 % kMergeLanes == 0 && kMergeThreads % 32 == 0, "merge lanes");

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// |v|^2 as the reference sums it: rounded squares added in order (no FMA).
__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float reduced_d2(float nqx, float nqy, float nqz, float4 t) {
  return fmaf(nqx, t.x, fmaf(nqy, t.y, fmaf(nqz, t.z, t.w)));
}

__device__ __forceinline__ void cp_async16(float4* smem, const float4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One block a tile: the tile's valid targets, compacted in index order
// (warp ballots, then the warps' counts in order), then +inf padding.
__global__ void __launch_bounds__(kTile)
pack_targets_kernel(const float* __restrict__ targets, const uint8_t* __restrict__ tmask,
                    int N, float4* __restrict__ xyzw, int32_t* __restrict__ tidx,
                    int32_t* __restrict__ tcount) {
  __shared__ int warp_valid[kTile / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kTile + threadIdx.x;
  const bool valid = j < N && tmask[j];
  const unsigned ballot = __ballot_sync(0xffffffffu, valid);
  if (lane == 0) warp_valid[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kTile / 32; ++w) {
    before += w < warp ? warp_valid[w] : 0;
    total += warp_valid[w];
  }
  float4* out = xyzw + static_cast<int64_t>(blockIdx.x) * kTile;
  if (valid) {
    const int pos = before + __popc(ballot & ((1u << lane) - 1u));
    const float x = targets[3 * j + 0], y = targets[3 * j + 1], z = targets[3 * j + 2];
    out[pos] = make_float4(x, y, z, sq_norm(x, y, z));
    tidx[static_cast<int64_t>(blockIdx.x) * kTile + pos] = j;
  }
  if (threadIdx.x >= total) out[threadIdx.x] = make_float4(0.f, 0.f, 0.f, inf());
  if (threadIdx.x == 0) tcount[blockIdx.x] = total;
}

// Packed tile `tile` into smem.
__device__ __forceinline__ void load_tile(float4* smem, const float4* __restrict__ xyzw,
                                          int tile) {
  const float4* src = xyzw + static_cast<int64_t>(tile) * kTile;
#pragma unroll
  for (int k = 0; k < kTile / kThreads; ++k) {
    const int i = k * kThreads + threadIdx.x;
    cp_async16(smem + i, src + i);
  }
}

__global__ void __launch_bounds__(kThreads, 4)
search_split_kernel(const float* __restrict__ queries, const uint8_t* __restrict__ qmask,
                    const float4* __restrict__ xyzw, const int32_t* __restrict__ tcount,
                    int Q, int n_tiles, int tiles_per_split,
                    float* __restrict__ part_d, int32_t* __restrict__ part_i) {
  __shared__ __align__(16) float4 tile[2][kTile];

  const int split = blockIdx.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int q0 = blockIdx.x * kQueriesPerBlock + threadIdx.x;

  float nqx[kRows], nqy[kRows], nqz[kRows], best[kRows];
  int chunk[kRows];
  bool live = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r * kThreads;
    const bool valid = qi < Q && qmask[qi];
    nqx[r] = valid ? -2.0f * queries[3 * qi + 0] : 0.f;
    nqy[r] = valid ? -2.0f * queries[3 * qi + 1] : 0.f;
    nqz[r] = valid ? -2.0f * queries[3 * qi + 2] : 0.f;
    best[r] = inf();
    chunk[r] = 0;
    live |= valid;
  }
  const bool warp_live = __any_sync(0xffffffffu, live);

  if (t_begin < t_end) load_tile(tile[0], xyzw, t_begin);
  cp_async_commit();
  for (int k = t_begin; k < t_end; ++k) {
    const int count = __ldg(tcount + k);
    if (k + 1 < t_end) load_tile(tile[(k + 1 - t_begin) & 1], xyzw, k + 1);
    cp_async_commit();          // an empty group on the last tile keeps the count
    cp_async_wait_one();        // tile k has landed (this thread's copies)
    __syncthreads();            // ... and everyone's
    if (warp_live) {
      const float4* t = tile[(k - t_begin) & 1];
      const int base = k * kTile;
#pragma unroll 2
      for (int c = 0; c < count; c += kChunk) {
        float m[kRows];
        const float4 t0 = t[c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) m[r] = reduced_d2(nqx[r], nqy[r], nqz[r], t0);
#pragma unroll
        for (int u = 1; u < kChunk; ++u) {
          const float4 tu = t[c + u];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            m[r] = fminf(m[r], reduced_d2(nqx[r], nqy[r], nqz[r], tu));
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (m[r] < best[r]) {
            best[r] = m[r];
            chunk[r] = base + c;
          }
        }
      }
    }
    __syncthreads();            // tile k consumed before it is refilled
  }

  // The first entry of the winning chunk that reproduces the best value
  // (a chunk never crosses its tile, whose padding is +inf).
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r * kThreads;
    if (qi >= Q) continue;
    int idx = 0;
    if (best[r] < inf()) {
      for (int u = kChunk - 1; u >= 0; --u) {
        const int j = chunk[r] + u;
        if (reduced_d2(nqx[r], nqy[r], nqz[r], __ldg(xyzw + j)) == best[r]) idx = j;
      }
    }
    part_d[static_cast<int64_t>(split) * Q + qi] = best[r];
    part_i[static_cast<int64_t>(split) * Q + qi] = idx;
  }
}

// kMergeLanes threads a query: lane l takes splits l, l + kMergeLanes, ...
// in order (strict '<'), then the lanes' (d', split) pairs reduce
// lexicographically, so the first split holding the minimum wins.
__global__ void __launch_bounds__(kMergeThreads)
merge_splits_kernel(const float* __restrict__ queries, const uint8_t* __restrict__ qmask,
                    const float4* __restrict__ xyzw, const int32_t* __restrict__ tidx,
                    int Q, int splits,
                    const float* __restrict__ part_d, const int32_t* __restrict__ part_i,
                    int32_t* __restrict__ out_idx, float* __restrict__ out_d2) {
  const int gt = blockIdx.x * kMergeThreads + threadIdx.x;
  const int qi = gt / kMergeLanes, lane = gt % kMergeLanes;
  float best = inf();
  int split = 0;
  if (qi < Q && qmask[qi]) {
#pragma unroll 8
    for (int s = lane; s < splits; s += kMergeLanes) {
      const float d = part_d[static_cast<int64_t>(s) * Q + qi];
      if (d < best) {
        best = d;
        split = s;
      }
    }
  }
#pragma unroll
  for (int off = 1; off < kMergeLanes; off <<= 1) {
    const float d = __shfl_xor_sync(0xffffffffu, best, off);
    const int s = __shfl_xor_sync(0xffffffffu, split, off);
    if (d < best || (d == best && s < split)) {
      best = d;
      split = s;
    }
  }
  if (qi >= Q || lane != 0) return;
  if (!(best < inf())) {          // invalid query, or no valid target
    out_idx[qi] = 0;
    out_d2[qi] = inf();
    return;
  }
  const int pos = part_i[static_cast<int64_t>(split) * Q + qi];
  const float qx = queries[3 * qi + 0], qy = queries[3 * qi + 1], qz = queries[3 * qi + 2];
  const float4 t = xyzw[pos];
  const float q_sq = sq_norm(qx, qy, qz);
  const float dot = fmaf(qz, t.z, fmaf(qy, t.y, qx * t.x));
  out_idx[qi] = tidx[pos];
  out_d2[qi] = fmaxf(fmaf(-2.0f, dot, q_sq + t.w), 0.0f);
}

// The scratch layout: packed tiles (float4), their target indices, the
// tiles' valid counts, the splits' partial (d', position).
struct Scratch {
  float4* xyzw;
  int32_t* tidx;
  int32_t* tcount;
  float* part_d;
  int32_t* part_i;
  int64_t bytes;
};

Scratch carve(void* base, int Q, int N, int splits) {
  const int64_t n_tiles = (N + kTile - 1) / kTile, packed = n_tiles * kTile;
  const int64_t partials = static_cast<int64_t>(splits) * Q;
  char* p = static_cast<char*>(base);
  Scratch s;
  s.xyzw = reinterpret_cast<float4*>(p);
  s.tidx = reinterpret_cast<int32_t*>(p + 16 * packed);
  s.tcount = s.tidx + packed;
  s.part_d = reinterpret_cast<float*>(s.tcount + n_tiles);
  s.part_i = reinterpret_cast<int32_t*>(s.part_d + partials);
  s.bytes = 20 * packed + 4 * n_tiles + 8 * partials;
  return s;
}

}  // namespace

extern "C" {

// The tiling the host's launch geometry must follow.
void glim_nn_search_tiling(int* queries_per_block, int* target_tile) {
  *queries_per_block = kQueriesPerBlock;
  *target_tile = kTile;
}

int64_t glim_nn_search_scratch_bytes(int Q, int N, int splits) {
  return carve(nullptr, Q, N, splits).bytes;
}

// queries (Q, 3) f32, qmask (Q,) bytes (0 = invalid), targets (N, 3) f32,
// tmask (N,) bytes; `splits` target ranges of `split_len` (a multiple of the
// tile) cover N; `scratch` holds glim_nn_search_scratch_bytes(Q, N, splits)
// bytes, 16-byte aligned. Writes out_idx (Q,) int32 and out_d2 (Q,) f32 on
// `stream`. Returns the first non-zero cudaGetLastError() of the launches.
int glim_nn_search(const float* queries, const uint8_t* qmask,
                   const float* targets, const uint8_t* tmask, int Q, int N,
                   int splits, int split_len, void* scratch, int32_t* out_idx,
                   float* out_d2, cudaStream_t stream) {
  if (Q <= 0) return static_cast<int>(cudaSuccess);
  if (N < 0 || splits < 1 || splits > 65535 || split_len <= 0 || split_len % kTile != 0 ||
      static_cast<int64_t>(splits) * split_len < N ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = carve(scratch, Q, N, splits);
  const int n_tiles = (N + kTile - 1) / kTile;
  int rc;
  if (n_tiles > 0) {
    pack_targets_kernel<<<n_tiles, kTile, 0, stream>>>(targets, tmask, N, s.xyzw, s.tidx,
                                                       s.tcount);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  }
  const dim3 grid((Q + kQueriesPerBlock - 1) / kQueriesPerBlock, splits);
  search_split_kernel<<<grid, kThreads, 0, stream>>>(queries, qmask, s.xyzw, s.tcount, Q,
                                                     n_tiles, split_len / kTile, s.part_d,
                                                     s.part_i);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  const int64_t merge_threads = static_cast<int64_t>(Q) * kMergeLanes;
  merge_splits_kernel<<<(merge_threads + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
                        stream>>>(
      queries, qmask, s.xyzw, s.tidx, Q, splits, s.part_d, s.part_i, out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}

const char* glim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
