// Pieces shared by the scan kernels (topk_seg.cu, qtopk_seg.cu, pairwise.cu).
//
// Two product loops live here.  Kernel B (qtopk_seg.cu) uses the first: a
// 16x16 thread grid with 4x4 register tiles (NT, TILE, CW, scan_smem_bytes).
// The fp32 kernels (topk_seg.cu, pairwise.cu) use the second, at the end of
// this file: 8-row by 8- or 4-column register tiles fed by float4 shared
// loads from a double-buffered, swizzled stage (F32_KC, f32_tile_product).
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


// --------------------------------------------------------------------- //
// The fp32 product loop (kernel A, topk_f32, pairwise_f32)
// --------------------------------------------------------------------- //
//
// A block of NT = 256 threads computes a BQ x BN tile of x·yᵀ; each thread
// owns TM x TN outputs, TM and TN each one or two groups of 4, so that each
// operand fragment is one float4 shared load: an 8x8 tile takes 64 FMAs per
// 16 shared words (4 loads).  Threads form a TY x TX grid (TY = BQ / TM, TX =
// BN / TN); thread (ty, tx) owns rows (i / 4)·4TY + 4ty + i % 4 and columns
// (j / 4)·4TX + 4tx + j % 4, so a warp reads contiguous float4 runs of one
// operand and a broadcast of the other.
//
// d is walked in chunks of F32_KC words.  Operands arrive by 16-byte global
// loads (VEC; the caller guarantees d % 4 == 0 and 16-byte aligned bases) or
// by scalar loads (!VEC, any d and alignment), one float4 of 4 consecutive k
// per load, 4 loads of one row adjacent in a warp.  While a chunk is
// multiplied, the loads of the next one are issued at spread k-steps and
// each is stored k-major into the other of two stages when the next load
// is issued, so one float4 is held in registers (a wide tile has 64
// accumulators), and one barrier per chunk separates the reads of a stage
// from its next write.  The k-major store is a transpose: element (k,
// r) lives at k·B + (r ^ swz(k)), swz(k) = 8·(k / 4) for F32_KC = 16, which
// spreads the 8 rows x 4 k-groups a warp stores over all 32 banks and keeps
// every aligned group of 4 rows contiguous for the float4 reads.  B (BQ or
// BN) must be a multiple of 32.
//
// Shared memory: the two stages, 2·F32_KC·(BQ + BN) floats; the callers
// mirror tuning.f32_smem_bytes.

constexpr int F32_KC = 16;          // 32-bit words of one d-chunk
constexpr int F32_K4 = F32_KC / 4;  // float4 loads per row and chunk

// Block tiles the fp32 kernels are instantiated for (tuning.F32_TILES):
// wide 128 x 128 with 8x8 per thread, narrow 32 x 256 with 8x4 per thread.
constexpr int F32_WIDE_BQ = 128, F32_WIDE_BN = 128;
constexpr int F32_NARROW_BQ = 32, F32_NARROW_BN = 256;

__device__ __forceinline__ int f32_swz(int k) { return (k >> 2) << 3; }

inline size_t f32_stage_floats(int bq, int bn) {
  return size_t(2) * F32_KC * (bq + bn);
}

template <bool BF16>
__device__ __forceinline__ float4 operand4(float4 v) {
  return make_float4(operand<BF16>(v.x), operand<BF16>(v.y),
                     operand<BF16>(v.z), operand<BF16>(v.w));
}

// Four consecutive words [k, k + 4) of one operand row (nullptr: a masked
// row), zero past D.
template <bool VEC, bool BF16>
__device__ __forceinline__ float4 load_row4(const float* row, int k, int D) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row != nullptr) {
    if (VEC) {
      if (k < D) v = __ldg(reinterpret_cast<const float4*>(row + k));
    } else {
      if (k < D) v.x = __ldg(row + k);
      if (k + 1 < D) v.y = __ldg(row + k + 1);
      if (k + 2 < D) v.z = __ldg(row + k + 2);
      if (k + 3 < D) v.w = __ldg(row + k + 3);
    }
  }
  return operand4<BF16>(v);
}

template <int BQ, int BN, int TM, int TN>
struct F32Tile {
  static constexpr int TY = BQ / TM, TX = BN / TN;
  static_assert(TM % 4 == 0 && TM <= 8 && TN % 4 == 0 && TN <= 8, "tile");
  static_assert(TY * TX == NT, "a TY x TX grid of NT threads");
  static_assert(BQ % 32 == 0 && BN % 32 == 0, "swizzle stays in 32 words");
  // float4 loads per thread and chunk (the last may be idle)
  static constexpr int XL = BQ * F32_K4, YL = BN * F32_K4;
  static constexpr int LOADS = (XL + YL + NT - 1) / NT;
  // norm slots per thread (x rows after y columns when XNORM)
  static constexpr int NSLOT = (BQ + BN + NT - 1) / NT;

  __device__ static int row_of(int i, int ty) {
    return (i >> 2) * (TY * 4) + ty * 4 + (i & 3);
  }
  __device__ static int col_of(int j, int tx) {
    return (j >> 2) * (TX * 4) + tx * 4 + (j & 3);
  }

  // The k-step of a chunk at which load l of the next chunk is issued:
  // spread over the chunk; load l - 1 is stored to the stage just before.
  __device__ static constexpr int fetch_at(int l) {
    return l * F32_KC / LOADS;
  }

  // Global -> register: load l of this thread for the chunk at d0.
  template <bool VEC, bool BF16>
  __device__ __forceinline__ static float4 fetch(
      const float* __restrict__ x, const int* xrow,
      const float* __restrict__ y, int col0, int N, int D, int d0, int l) {
    const int e = threadIdx.x + l * NT;
    const float* row = nullptr;
    int k4;
    if (e < XL) {
      const int g = xrow[e / F32_K4];
      k4 = e % F32_K4;
      if (g >= 0) row = x + size_t(g) * D;
    } else {
      const int c = (e - XL) / F32_K4, col = col0 + c;
      k4 = (e - XL) % F32_K4;
      if (e - XL < YL && col < N) row = y + size_t(col) * D;
    }
    return load_row4<VEC, BF16>(row, d0 + 4 * k4, D);
  }

  // Register -> stage `st`: load l, k-major and swizzled (x part, then y
  // part).
  __device__ __forceinline__ static void store(float* st, int l, float4 v) {
    const int e = threadIdx.x + l * NT;
    if (e >= XL + YL) return;
    const bool isx = e < XL;
    const int r = (isx ? e : e - XL) / F32_K4;
    const int k4 = (isx ? e : e - XL) % F32_K4;
    const int B = isx ? BQ : BN;
    float* base = (isx ? st : st + F32_KC * BQ) + (4 * k4) * B +
                  (r ^ f32_swz(4 * k4));
    base[0] = v.x;
    base[B] = v.y;
    base[2 * B] = v.z;
    base[3 * B] = v.w;
  }
};

// acc = x_tile · y_tileᵀ over all of d, for the rows xrow[0, BQ) of x (-1: a
// masked row; xrow lies in shared memory) and the columns [col0, col0 + BN)
// of y (>= N masked).  With NORMS, ynorm[c] (and, with XNORM, xnorm[r]) gets
// the squared norm of each staged operand row, summed from the stages.
// `stage` holds the two stages.  Starts and ends with a __syncthreads(), so
// the caller may reuse `stage` right after it returns; the norms are written
// after that barrier, so the caller syncs once more before reading them.
template <int BQ, int BN, int TM, int TN, bool VEC, bool BF16, bool NORMS,
          bool XNORM>
__device__ __forceinline__ void f32_tile_product(
    const float* __restrict__ x, const int* xrow, const float* __restrict__ y,
    int col0, int N, int D, float* stage, float (&acc)[TM][TN], float* ynorm,
    float* xnorm) {
  using T = F32Tile<BQ, BN, TM, TN>;
  const int tid = threadIdx.x, tx = tid % T::TX, ty = tid / T::TX;
  constexpr int SF = F32_KC * (BQ + BN);  // floats of one stage
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float nrm[T::NSLOT];
#pragma unroll
  for (int s = 0; s < T::NSLOT; ++s) nrm[s] = 0.f;
  static_assert(T::LOADS >= 1 && T::LOADS <= F32_KC, "staging schedule");

  __syncthreads();  // the caller's last use of `stage` is done
#pragma unroll
  for (int l = 0; l < T::LOADS; ++l)
    T::store(stage, l,
             T::template fetch<VEC, BF16>(x, xrow, y, col0, N, D, 0, l));
  __syncthreads();
  const int chunks = (D + F32_KC - 1) / F32_KC;
  for (int ch = 0; ch < chunks; ++ch) {
    const float* xs = stage + (ch & 1) * SF;
    const float* ys = xs + F32_KC * BQ;
    float* next = stage + ((ch + 1) & 1) * SF;
    const bool more = ch + 1 < chunks;
    const int d1 = (ch + 1) * F32_KC;
    float4 slot;
#pragma unroll
    for (int k = 0; k < F32_KC; ++k) {
#pragma unroll
      for (int l = 0; l < T::LOADS; ++l) {
        if (k == T::fetch_at(l) && more) {
          if (l >= 1) T::store(next, l - 1, slot);
          slot = T::template fetch<VEC, BF16>(x, xrow, y, col0, N, D, d1, l);
        }
      }
      const int sw = f32_swz(k);
      float a[TM], b[TN];
#pragma unroll
      for (int i4 = 0; i4 < TM / 4; ++i4) {
        const float4 v = *reinterpret_cast<const float4*>(
            xs + k * BQ + ((i4 * T::TY * 4 + ty * 4) ^ sw));
        a[4 * i4] = v.x; a[4 * i4 + 1] = v.y;
        a[4 * i4 + 2] = v.z; a[4 * i4 + 3] = v.w;
      }
#pragma unroll
      for (int j4 = 0; j4 < TN / 4; ++j4) {
        const float4 v = *reinterpret_cast<const float4*>(
            ys + k * BN + ((j4 * T::TX * 4 + tx * 4) ^ sw));
        b[4 * j4] = v.x; b[4 * j4 + 1] = v.y;
        b[4 * j4 + 2] = v.z; b[4 * j4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) T::store(next, T::LOADS - 1, slot);
    if (NORMS) {
#pragma unroll
      for (int s = 0; s < T::NSLOT; ++s) {
        const int e = tid + s * NT;
        const bool isy = e < BN;
        if (!isy && !(XNORM && e < BN + BQ)) continue;
        const float* src = isy ? ys : xs;
        const int B = isy ? BN : BQ, r = isy ? e : e - BN;
#pragma unroll
        for (int k = 0; k < F32_KC; ++k) {
          const float v = src[k * B + (r ^ f32_swz(k))];
          nrm[s] = fmaf(v, v, nrm[s]);
        }
      }
    }
    __syncthreads();
  }
  if (NORMS) {
#pragma unroll
    for (int s = 0; s < T::NSLOT; ++s) {
      const int e = tid + s * NT;
      if (e < BN) ynorm[e] = nrm[s];
      else if (XNORM && e < BN + BQ) xnorm[e - BN] = nrm[s];
    }
  }
}

}  // namespace
