// Pieces shared by the scan kernels (topk_seg.cu, qtopk_seg.cu, pairwise.cu).
//
// The top-k kernels fold candidates into a running per-row top-k of 64-bit keys
//     key = (order-preserving uint32 of the fp32 distance) << 32 | column
// so "equal distance -> lower column wins" (the tie rule of lax.top_k in the
// reference) is plain integer order, keys are unique within a row, and the
// result does not depend on how the N axis is split or in which order the
// blocks run.  Masked (row, column) pairs get KEY_MASKED and are never kept.
//
// Both top-k passes (kernel A and kernel B, and their unsegmented
// instantiations) share, from this file:
//   - the owner skip: `tile_owner_ranges` (the range pre-pass) and
//     `ranges_meet` (the per-tile test), launched by `launch_owner_ranges`;
//   - the fold: each pass lists, per row and tile, the columns at or below
//     the row's current k-th distance, and `fold_rows` folds them into the
//     row's list held in registers (`RegList`);
//   - the merge of the flagged partial lists (`merge_flagged_partials`).
// The fp32 product loop (F32_KC, f32_tile_product) follows them; the int8
// tensor-core loop lives in qtopk_seg.cu, its only user.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads per scan block
constexpr int MERGE_WARPS = 8;   // warps per row of the merge
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long KEY_MASKED = ~0ULL;
constexpr unsigned int kPosInfBits = 0x7f800000u;

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

// --------------------------------------------------------------------- //
// The owner skip
// --------------------------------------------------------------------- //
//
// The wrapper passes `perm`, a stable argsort of qseg, and a segmented pass
// works on rows in that order: row tile t holds rows perm[t·bq .. t·bq + bq).
// The flat candidate layout is grouped by owner (descriptors, resident
// tail, shipped tail, each ascending), so a row tile covers a few owners
// whose columns sit in a few contiguous stretches of N.  The pre-pass writes
// for each column tile, and for each row tile of the sorted rows, two
// ranges: [min, max] over owners >= 0 and over owners < 0.  Equal owners
// have the same sign, so a (row tile, column tile) pair can hold a match
// only if a range of one meets the range of the same sign of the other;
// otherwise the pass skips the tile without reading its operands.
// Tombstones (-3) never widen a live range, pad rows (-1) meet only
// negative columns, and the rule holds for any qseg, sorted or not.  The
// exact per-pair mask stays in the fold.

__device__ __forceinline__ bool ranges_meet(int4 a, int4 b) {
  return max(a.x, b.x) <= min(a.y, b.y) || max(a.z, b.z) <= min(a.w, b.w);
}

// Per tile of `block` entries of seg (taken in the order perm, when
// given): (min, max) over owners >= 0, then over owners < 0; an empty range
// is (INT_MAX, INT_MIN).  One warp per tile.
__global__ void __launch_bounds__(NT)
tile_owner_ranges(const int* __restrict__ seg, const int* __restrict__ perm,
                  int n, int block, int n_tiles, int4* __restrict__ ranges) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (t >= n_tiles) return;  // whole warp
  int pmin = INT_MAX, pmax = INT_MIN, nmin = INT_MAX, nmax = INT_MIN;
  const int end = min(n, (t + 1) * block);
  for (int c = t * block + lane; c < end; c += 32) {
    const int o = seg[perm != nullptr ? perm[c] : c];
    if (o >= 0) {
      pmin = min(pmin, o);
      pmax = max(pmax, o);
    } else {
      nmin = min(nmin, o);
      nmax = max(nmax, o);
    }
  }
  pmin = __reduce_min_sync(FULL, pmin);
  pmax = __reduce_max_sync(FULL, pmax);
  nmin = __reduce_min_sync(FULL, nmin);
  nmax = __reduce_max_sync(FULL, nmax);
  if (lane == 0) ranges[t] = make_int4(pmin, pmax, nmin, nmax);
}

// The pre-pass of a segmented launch: ranges of the ceil(N / bn) column
// tiles of cseg into `ranges`, then of the ceil(Q / bq) row tiles of qseg
// taken in the order perm into `ranges + ceil(N / bn)`.
inline cudaError_t launch_owner_ranges(const int* cseg, const int* qseg,
                                       const int* perm, int Q, int N, int bq,
                                       int bn, int4* ranges,
                                       cudaStream_t st) {
  constexpr int W = NT / 32;
  const int n_tiles = (N + bn - 1) / bn, q_tiles = (Q + bq - 1) / bq;
  tile_owner_ranges<<<(n_tiles + W - 1) / W, NT, 0, st>>>(
      cseg, nullptr, N, bn, n_tiles, ranges);
  tile_owner_ranges<<<(q_tiles + W - 1) / W, NT, 0, st>>>(
      qseg, perm, Q, bq, q_tiles, ranges + n_tiles);
  return cudaGetLastError();
}

// Whether the split [t_begin, t_end) of column tiles holds a tile that meets
// the row tile's ranges.  Every thread reaches the same verdict, so a block
// that meets nothing exits with no barrier and no shared memory touched.
__device__ __forceinline__ bool split_meets(int4 rr, const int4* ranges,
                                            int t_begin, int t_end) {
  for (int t = t_begin; t < t_end; ++t)
    if (ranges_meet(rr, ranges[t])) return true;
  return false;
}

// --------------------------------------------------------------------- //
// The fold
// --------------------------------------------------------------------- //

// A row's running top-kp (ascending keys) held in registers while a warp
// folds into it: lane l holds element l + 32j in R[j], j < NS = ceil(kp /
// 32) (NS = 1, 2 or 4).  An insert is two ballots and a
// shuffle of each R[j] one place up, with no shared memory round trip.
template <int NS>
struct RegList {
  unsigned long long R[NS];
  unsigned long long kth;  // element kp - 1 (KEY_MASKED while not full)

  __device__ __forceinline__ void refresh_kth(int kp) {
    const int jk = (kp - 1) >> 5;
    unsigned long long v = R[0];
#pragma unroll
    for (int j = 1; j < NS; ++j)
      if (j == jk) v = R[j];
    kth = __shfl_sync(FULL, v, (kp - 1) & 31);
  }
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < NS; ++j) R[j] = KEY_MASKED;
    kth = KEY_MASKED;
  }
  __device__ __forceinline__ void load(const unsigned long long* L, int kp,
                                       int lane) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int i = lane + 32 * j;
      R[j] = i < kp ? L[i] : KEY_MASKED;
    }
    refresh_kth(kp);
  }
  __device__ __forceinline__ void store(unsigned long long* L, int kp,
                                        int lane) const {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int i = lane + 32 * j;
      if (i < kp) L[i] = R[j];
    }
  }
  // Insert `key` (< kth, so its place is below kp).
  __device__ __forceinline__ void insert(unsigned long long key, int kp,
                                         int lane) {
    int pos = 0;
#pragma unroll
    for (int j = 0; j < NS; ++j)
      pos += __popc(__ballot_sync(FULL, lane + 32 * j < kp && R[j] < key));
    unsigned long long prev[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const unsigned long long up = __shfl_up_sync(FULL, R[j], 1);
      const unsigned long long carry =
          j > 0 ? __shfl_sync(FULL, R[j > 0 ? j - 1 : 0], 31) : 0ULL;
      prev[j] = lane == 0 ? carry : up;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int i = lane + 32 * j;
      if (i > pos) R[j] = prev[j];
      else if (i == pos) R[j] = key;
    }
    refresh_kth(kp);
  }
  // Fold one candidate key per lane.
  __device__ __forceinline__ void fold(unsigned long long mine, int kp,
                                       int lane) {
    unsigned ball = __ballot_sync(FULL, mine < kth);
    while (ball) {
      const int src = __ffs(ball) - 1;
      insert(__shfl_sync(FULL, mine, src), kp, lane);
      ball &= ball - 1;
      ball &= __ballot_sync(FULL, mine < kth);
    }
  }
};

// Candidate slots per row and tile: the columns at or below the row's k-th
// distance, listed in the epilogue; a row with more is folded by a full scan.
constexpr int CAND = 32;

// The fold of one distance tile (dist: row stride DS; cs: the tile's column
// owners, INT_MIN past N; cnt, cand: the listed candidates; kthv: each row's
// current k-th distance): warp w takes rows w, w + 8, ...; a row with listed
// candidates folds just those, a row with more than CAND scans its whole
// tile row; then the row's k-th distance is republished.
template <int NS, bool SEG, int BN, int DS>
__device__ __forceinline__ void fold_rows(
    unsigned long long* lists, int kp, const float* dist, const int* cnt,
    const unsigned char* cand, const int* cs, const int* qs, float* kthv,
    int col0, int warp, int lane, int bq) {
  for (int r = warp; r < bq; r += NT / 32) {
    const int n = cnt[r];  // warp-uniform
    if (n == 0) continue;
    unsigned long long* L = lists + r * kp;
    RegList<NS> rl;
    rl.load(L, kp, lane);
    if (n <= CAND) {  // fold only the candidates (order does not matter)
      unsigned long long key = KEY_MASKED;
      if (lane < n) {
        const int c = cand[r * CAND + lane];
        key = make_key(dist[r * DS + c], col0 + c);
      }
      rl.fold(key, kp, lane);
    } else {  // many candidates: scan the whole row
      const int q = qs[r];
      const float kv = kthv[r];
      for (int c0 = 0; c0 < BN; c0 += 32) {
        const int c = c0 + lane, o = cs[c];
        const float v = dist[r * DS + c];
        unsigned long long key = KEY_MASKED;
        if (o != INT_MIN && (!SEG || o == q) && !(v > kv))
          key = make_key(v, col0 + c);
        rl.fold(key, kp, lane);
      }
    }
    rl.store(L, kp, lane);
    if (lane == 0)
      kthv[r] = rl.kth == KEY_MASKED ? __uint_as_float(kPosInfBits)
                                     : key_value(rl.kth);
  }
}

// List, for row r of a tile, the outputs j (bit j of `pass`) at or below
// the row's k-th distance: reserve slots with one shared atomic, then write
// the columns col_of(j) of the first CAND.
template <int NJ, typename ColOf>
__device__ __forceinline__ void list_candidates(int* cnt, unsigned char* cand,
                                                int r, unsigned pass,
                                                ColOf col_of) {
  if (pass == 0) return;
  int pos = atomicAdd(cnt + r, __popc(pass));
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if ((pass >> j) & 1u) {
      if (pos < CAND)
        cand[r * CAND + pos] = static_cast<unsigned char>(col_of(j));
      ++pos;
    }
}

// --------------------------------------------------------------------- //
// The merge
// --------------------------------------------------------------------- //

// Merge the flagged partial lists of each (sorted) row into its top-kp and
// write it to output row perm[r] (or r).  One block of MERGE_WARPS warps
// per row: warp w folds splits w, w + W, ... into its own list, then warp 0
// folds the other lists into its own.  An empty slot, or a distance of +inf,
// is emitted as (+inf, -1).
template <int NS>
__device__ __forceinline__ void merge_row(
    const unsigned long long* __restrict__ partial, const int* f, int S,
    int kp, int r, const int* __restrict__ perm, float* __restrict__ out_v,
    int* __restrict__ out_i, unsigned long long* mlists) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  RegList<NS> rl;
  rl.clear();
  const unsigned long long* src = partial + size_t(r) * S * kp;
  for (int s0 = warp * 32; s0 < S; s0 += MERGE_WARPS * 32) {
    const int s = s0 + lane;
    unsigned ball = __ballot_sync(FULL, s < S && f[s] != 0);
    while (ball) {
      const int ss = s0 + __ffs(ball) - 1;
      ball &= ball - 1;
      for (int i0 = 0; i0 < kp; i0 += 32) {
        const int i = i0 + lane;
        rl.fold(i < kp ? src[size_t(ss) * kp + i] : KEY_MASKED, kp, lane);
      }
    }
  }
  rl.store(mlists + warp * kp, kp, lane);
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < MERGE_WARPS; ++w)
    for (int i0 = 0; i0 < kp; i0 += 32) {
      const int i = i0 + lane;
      rl.fold(i < kp ? mlists[w * kp + i] : KEY_MASKED, kp, lane);
    }
  rl.store(mlists, kp, lane);
  __syncwarp();
  const int g = perm != nullptr ? perm[r] : r;
  for (int i = lane; i < kp; i += 32) {
    const unsigned long long key = mlists[i];
    const float v = key_value(key);
    const bool empty =
        key == KEY_MASKED || __float_as_uint(v) == kPosInfBits;
    out_v[size_t(g) * kp + i] = empty ? __uint_as_float(kPosInfBits) : v;
    out_i[size_t(g) * kp + i] =
        empty ? -1 : static_cast<int>(key & 0xffffffffULL);
  }
}

// partial: (Q, S, kp) keys, row = sorted position; flags: (row tiles of bq,
// S), 1 where a pass block wrote its lists.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
merge_flagged_partials(const unsigned long long* __restrict__ partial,
                       const int* __restrict__ flags,
                       const int* __restrict__ perm, int Q, int S, int kp,
                       int bq, float* __restrict__ out_v,
                       int* __restrict__ out_i) {
  extern __shared__ unsigned long long mlists[];
  const int r = blockIdx.x;
  const int* f = flags + (r / bq) * S;
  if (kp <= 32)
    merge_row<1>(partial, f, S, kp, r, perm, out_v, out_i, mlists);
  else if (kp <= 64)
    merge_row<2>(partial, f, S, kp, r, perm, out_v, out_i, mlists);
  else
    merge_row<4>(partial, f, S, kp, r, perm, out_v, out_i, mlists);
}

inline cudaError_t launch_merge(const unsigned long long* partial,
                                const int* flags, const int* perm, int Q,
                                int S, int kp, int bq, float* out_v,
                                int* out_i, cudaStream_t st) {
  merge_flagged_partials<<<Q, MERGE_WARPS * 32,
                           size_t(MERGE_WARPS) * kp * 8, st>>>(
      partial, flags, perm, Q, S, kp, bq, out_v, out_i);
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
