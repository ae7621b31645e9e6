// Pieces shared by the scan kernels (topk_seg.cu, qtopk_seg.cu, pairwise.cu).
//
// The top-k kernels fold candidates into a running per-row top-k of 64-bit keys
//     key = (order-preserving uint32 of the fp32 distance) << 32 | column
// so "equal distance -> lower column wins" (the tie rule of lax.top_k in the
// reference) is plain integer order, keys are unique within a row, and the
// result does not depend on how the N axis is split or in which order the
// blocks run.  Masked (row, column) pairs get KEY_MASKED and are never kept.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;    // threads per scan block, a 16x16 grid
constexpr int TILE = 16;   // rows (or columns) per side of that grid
constexpr int CW = 32;     // 32-bit words in one operand d-chunk
constexpr int MERGE_WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long KEY_MASKED = ~0ULL;
constexpr unsigned int kPosInfBits = 0x7f800000u;

// Dynamic shared memory of one scan block; mirrors tuning.smem_bytes.
// kp = 0: the pairwise kernel, which keeps no top-k lists.
inline size_t scan_smem_bytes(int bq, int bn, int kp) {
  return size_t(bq) * kp * 8 + size_t(CW) * (bq + 1 + bn + 1) * 4 +
         size_t(bq) * (bn + 1) * 4 + size_t(bq + bn) * 16;
}

// Each side of a block tile is 1..4 rows (or columns) of the 16x16 grid.
inline bool tiles_ok(int bq, int bn) {
  return bq >= TILE && bq <= 4 * TILE && bq % TILE == 0 && bn >= TILE &&
         bn <= 4 * TILE && bn % TILE == 0;
}

inline bool scan_shape_ok(int Q, int N, int kp, int bq, int bn, int S) {
  return Q > 0 && N > 0 && kp >= 1 && kp <= 128 && tiles_ok(bq, bn) &&
         S >= 1;
}

// An fp32 operand as the kernels multiply it: itself, or rounded to bf16
// (accum "bf16"; products and sums stay fp32).
template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ unsigned long long make_key(float v, int col) {
  unsigned int b = __float_as_uint(v);
  if ((b << 1) == 0u) b = 0u;  // -0.0 -> +0.0
  const unsigned int u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned int>(col);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  const unsigned int u = static_cast<unsigned int>(key >> 32);
  const unsigned int b = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(b);
}

// Insert `key` into the ascending list L[0, kp) in shared memory; one warp,
// kp <= 128 (four slots per lane).  The caller guarantees key < L[kp - 1], so
// the insert position (the count of smaller keys) is below kp.
__device__ __forceinline__ void warp_insert(unsigned long long* L, int kp,
                                            unsigned long long key, int lane) {
  unsigned long long old[4];
  int pos = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = lane + 32 * j;
    old[j] = (i < kp) ? L[i] : KEY_MASKED;
    pos += __popc(__ballot_sync(FULL, i < kp && old[j] < key));
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = lane + 32 * j;
    if (i >= pos && i < kp - 1) L[i + 1] = old[j];
  }
  if (lane == 0) L[pos] = key;
  __syncwarp();
}

// Fold one candidate key per lane into the running list L (one warp).
__device__ __forceinline__ void warp_fold(unsigned long long* L, int kp,
                                          unsigned long long mine, int lane) {
  unsigned long long kth = L[kp - 1];
  unsigned ball = __ballot_sync(FULL, mine < kth);
  while (ball) {
    const int src = __ffs(ball) - 1;
    const unsigned long long key = __shfl_sync(FULL, mine, src);
    warp_insert(L, kp, key, lane);
    kth = L[kp - 1];
    ball &= ball - 1;
    ball &= __ballot_sync(FULL, mine < kth);
  }
}

// Second pass: merge the S sorted partial lists of each row, (Q, S, kp) keys,
// into the row's final ascending top-kp.  One warp per row.  An empty slot,
// or a distance of +inf, is emitted as (+inf, -1).
__global__ void __launch_bounds__(MERGE_WARPS * 32)
merge_partials(const unsigned long long* __restrict__ partial, int Q, int S,
               int kp, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned long long mlists[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * MERGE_WARPS + warp;
  if (row >= Q) return;  // whole warp
  unsigned long long* L = mlists + warp * kp;
  for (int i = lane; i < kp; i += 32) L[i] = KEY_MASKED;
  __syncwarp();
  const unsigned long long* src = partial + size_t(row) * S * kp;
  const int total = S * kp;
  for (int base = 0; base < total; base += 32) {
    const int i = base + lane;
    warp_fold(L, kp, i < total ? src[i] : KEY_MASKED, lane);
  }
  for (int i = lane; i < kp; i += 32) {
    const unsigned long long key = L[i];
    const float v = key_value(key);
    const bool empty =
        key == KEY_MASKED || __float_as_uint(v) == kPosInfBits;
    out_v[size_t(row) * kp + i] = empty ? __uint_as_float(kPosInfBits) : v;
    out_i[size_t(row) * kp + i] =
        empty ? -1 : static_cast<int>(key & 0xffffffffULL);
  }
}

inline cudaError_t launch_merge(const unsigned long long* partial, int Q,
                                int S, int kp, float* out_v, int* out_i,
                                cudaStream_t stream) {
  const int grid = (Q + MERGE_WARPS - 1) / MERGE_WARPS;
  merge_partials<<<grid, MERGE_WARPS * 32,
                   size_t(MERGE_WARPS) * kp * sizeof(unsigned long long),
                   stream>>>(partial, Q, S, kp, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace
