// Kernel A: segmented exact fp32 top-k (`topk_seg_f32`).
//
// `topk_seg_f32` replaces the TPU kernel `_topk_seg_kernel` (src/repro/
// kernels/distance_topk.py:97, launched by `_seg_pallas_call`).  Query row r
// may take flat candidate column c only when qseg[r] == cseg[c]; the distance
// is the GEMM form max(|x|^2 + |y|^2 - 2 x.y, 0) for "l2" and -x.y for "ip",
// with true fp32 FMAs (accum "f32") or operands rounded to bf16 and fp32
// accumulation (accum "bf16").  Output: (Q, kp) ascending distances and flat
// column indices, (+inf, -1) where fewer than kp columns match.
//
// What bounds it: at the segmented main-path shape (Qp = 128, N = 2,097,152,
// d = 128) all pairs would be 2·Qp·N·d = 69 GFLOP of fp32 FMA, but only 3.5 %
// of the pairs have matching owners (PERF.md §4), so the work the data needs
// (query rows, live candidate rows, products of matched pairs) is bound by
// bytes at 0.186 ms.  (The unsegmented top-k, where every pair is live and
// operations bound it, is `topk_f32` in topk_dense.cu.)
//
// Design.  A split-N pass, then a merge: Hopper runs blocks in no order, so
// the running top-k the TPU kernel carries across its sequential N axis
// becomes S sorted partial lists per row, folded by `merge_flagged_partials`.
// Grid (row tiles, S); each block walks its split of column tiles, computes
// each bq x bn distance tile with the fp32 product loop of topk_common.cuh
// (8x8 or 8x4 outputs per thread from float4 shared loads, double-buffered
// 16-word d-chunks) and writes it to shared memory over the stages.  In the
// epilogue each thread compares its distances with its rows' current k-th
// distance, kept in shared memory, and lists per row the columns at or below
// it (up to CAND).  One warp per row then folds the listed columns (a row
// with more than CAND scans its whole tile row) into a sorted list of 64-bit
// (distance, column) keys held in registers while the warp inserts (RegList),
// so the lower column wins ties and the result does not depend on the split.
// Once a row's list is full, few columns of a tile make the cut, so most rows
// cost one fold or nothing.
//
// The owner skip, the fold (RegList, fold_rows) and the merge are
// shared with kernel B and described in topk_common.cuh: rows are taken in
// the order of a stable argsort of qseg, and a (row tile, column tile) pair
// is computed only if their two-sign owner ranges meet; the block then
// skips the tile without reading y.  The exact per-pair mask stays in the
// fold.
//
// Load balance: the work of a row tile sits in a few stretches of N, so the
// segmented policy (tuning.select_f32_splits) uses a small row tile (32 rows)
// and many short splits (about 4 column tiles each: on the main path 4 beat 8
// and 2, chip_smoke.py's `ms_by_tiles_per_split`).  A block whose split meets
// nothing exits after reading its ranges, with no barrier and no shared
// memory touched, so the scheduler backfills the SMs with blocks that have
// work.  Each block writes a flag saying whether it wrote partial lists; the
// merge folds flagged lists only.  `counter` (optional) adds the number of
// tiles computed, one atomic per block, so a run can show how many pairs of
// tiles the rule skipped.
#include "topk_common.cuh"

namespace {

struct PassArgs {
  const float* x;
  const float* y;
  const int* qseg;
  const int* cseg;
  const int* perm;         // row order: the stable argsort of qseg
  const int4* ranges;      // per column tile
  const int4* row_ranges;  // per row tile of the sorted rows
  int Q, N, D, kp, tiles_per_split, S;
  unsigned long long* partial;  // (Q, S, kp) keys, row = sorted position
  int* flags;                   // (row tiles, S): 1 where the lists exist
  unsigned long long* counter;  // tiles computed, or nullptr
};

// Dynamic shared memory of one pass block; mirrors tuning.f32_smem_bytes.
inline size_t f32_topk_smem_bytes(int bq, int bn, int kp) {
  const size_t stages = f32_stage_floats(bq, bn);
  const size_t dist = size_t(bq) * (bn + 4);
  return (stages > dist ? stages : dist) * 4 + size_t(5 * bq + 2 * bn) * 4 +
         size_t(bq) * CAND + size_t(bq) * kp * 8;
}

template <bool L2, bool BF16, bool VEC, int BQ, int BN, int TM, int TN>
__global__ void __launch_bounds__(NT, 2) topk_seg_f32_pass(PassArgs a) {
  using T = F32Tile<BQ, BN, TM, TN>;
  constexpr int DS = BN + 4;  // row stride of the distance tile
  constexpr size_t STAGE = size_t(2) * F32_KC * (BQ + BN);
  constexpr size_t BUF = STAGE > size_t(BQ) * DS ? STAGE : size_t(BQ) * DS;
  // Every array but the lists has a compile-time offset (the lists, sized
  // by the runtime kp, come last), so their addresses take no registers.
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);  // stages | distance tile
  float* x2s = buf + BUF;   // [BQ]
  float* kthv = x2s + BQ;   // [BQ] value of each row's current k-th key
  float* y2s = kthv + BQ;   // [BN]
  int* xrow = reinterpret_cast<int*>(y2s + BN);  // [BQ] global row or -1
  int* qs = xrow + BQ;      // [BQ]
  int* cnt = qs + BQ;       // [BQ] candidates of the tile per row
  int* cs = cnt + BQ;       // [BN]
  unsigned char* cand = reinterpret_cast<unsigned char*>(cs + BN);
                            // [BQ][CAND] their columns in the tile
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(cand + BQ * CAND);  // [BQ][kp]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % T::TX, ty = tid / T::TX;
  const int row0 = blockIdx.x * BQ;
  const int n_tiles = (a.N + BN - 1) / BN;
  const int t_begin = blockIdx.y * a.tiles_per_split;
  const int t_end = min(n_tiles, t_begin + a.tiles_per_split);

  // every thread reaches the same verdict: no barrier needed
  const int4 rr = a.row_ranges[blockIdx.x];
  if (!split_meets(rr, a.ranges, t_begin, t_end)) {  // nothing can match
    if (tid == 0) a.flags[blockIdx.x * a.S + blockIdx.y] = 0;
    return;
  }
  for (int r = tid; r < BQ; r += NT) {
    const int p = row0 + r;
    const int g = p < a.Q ? a.perm[p] : -1;
    xrow[r] = g;
    qs[r] = g >= 0 ? a.qseg[g] : 0;
  }
  __syncthreads();
  for (int i = tid; i < BQ * a.kp; i += NT) lists[i] = KEY_MASKED;
  for (int r = tid; r < BQ; r += NT) kthv[r] = __uint_as_float(kPosInfBits);
  if (L2) {  // row norms, once per block: one warp per row
    for (int r = warp; r < BQ; r += NT / 32) {
      const int g = xrow[r];
      float s = 0.f;
      if (g >= 0)
        for (int d = lane; d < a.D; d += 32) {
          const float v = operand<BF16>(__ldg(a.x + size_t(g) * a.D + d));
          s = fmaf(v, v, s);
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0) x2s[r] = s;
    }
  }

  for (int t = t_begin; t < t_end; ++t) {
    if (!ranges_meet(rr, a.ranges[t])) continue;  // block-uniform
    const int col0 = t * BN;
    float acc[TM][TN];
    f32_tile_product<BQ, BN, TM, TN, VEC, BF16, L2, false>(
        a.x, xrow, a.y, col0, a.N, a.D, buf, acc, y2s, nullptr);
    // The previous tile's fold read cs and cnt before the product's first
    // barrier, so they are free now.
    for (int c = tid; c < BN; c += NT) {
      const int col = col0 + c;
      cs[c] = col < a.N ? a.cseg[col] : INT_MIN;
    }
    for (int r = tid; r < BQ; r += NT) cnt[r] = 0;
    __syncthreads();  // y2s, cs, cnt
    // Epilogue: distances into the tile (over the stages), and per row the
    // columns at or below its current k-th distance: each thread reserves
    // slots for its own with one shared atomic per row.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = T::row_of(i, ty);
      const float kv = kthv[r], xr = L2 ? x2s[r] : 0.f;
      const int q = qs[r];
      unsigned pass = 0;  // bit j: output j is a candidate
#pragma unroll
      for (int j4 = 0; j4 < TN / 4; ++j4) {
        const int c = T::col_of(4 * j4, tx);
        float v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float p = acc[i][4 * j4 + jj];
          v[jj] = L2 ? fmaxf(xr + y2s[c + jj] - 2.f * p, 0.f) : -p;
          const int o = cs[c + jj];
          const bool ok = o != INT_MIN && o == q;
          if (ok && !(v[jj] > kv)) pass |= 1u << (4 * j4 + jj);
        }
        *reinterpret_cast<float4*>(buf + r * DS + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      if (xrow[r] >= 0)
        list_candidates<TN>(cnt, cand, r, pass,
                            [tx](int j) { return T::col_of(j, tx); });
    }
    __syncthreads();
    if (a.kp <= 32)
      fold_rows<1, true, BN, DS>(lists, a.kp, buf, cnt, cand, cs, qs, kthv,
                                 col0, warp, lane, BQ);
    else
      fold_rows<4, true, BN, DS>(lists, a.kp, buf, cnt, cand, cs, qs, kthv,
                                 col0, warp, lane, BQ);
    // the next tile's f32_tile_product starts with a barrier
  }
  __syncthreads();
  for (int e = tid; e < BQ * a.kp; e += NT) {
    const int r = e / a.kp, i = e % a.kp, p = row0 + r;
    if (p < a.Q) a.partial[(size_t(p) * a.S + blockIdx.y) * a.kp + i] =
        lists[e];
  }
  if (tid == 0) {
    a.flags[blockIdx.x * a.S + blockIdx.y] = 1;
    if (a.counter != nullptr) {  // the tiles computed above, counted again
      int computed = 0;          // here so no counter lives across the loop
      for (int t = t_begin; t < t_end; ++t)
        computed += ranges_meet(rr, a.ranges[t]);
      atomicAdd(a.counter, static_cast<unsigned long long>(computed));
    }
  }
}

template <bool L2, bool BF16, bool VEC, int BQ, int BN, int TM, int TN>
cudaError_t launch_pass(const PassArgs& a, cudaStream_t stream) {
  const size_t smem = f32_topk_smem_bytes(BQ, BN, a.kp);
  auto kernel = topk_seg_f32_pass<L2, BF16, VEC, BQ, BN, TM, TN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Q + BQ - 1) / BQ, a.S);
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BQ, int BN, int TM, int TN>
cudaError_t dispatch_pass(bool l2, bool bf16, bool vec, const PassArgs& a,
                          cudaStream_t st) {
  if (l2) {
    if (bf16)
      return vec ? launch_pass<true, true, true, BQ, BN, TM, TN>(a, st)
                 : launch_pass<true, true, false, BQ, BN, TM, TN>(a, st);
    return vec ? launch_pass<true, false, true, BQ, BN, TM, TN>(a, st)
               : launch_pass<true, false, false, BQ, BN, TM, TN>(a, st);
  }
  if (bf16)
    return vec ? launch_pass<false, true, true, BQ, BN, TM, TN>(a, st)
               : launch_pass<false, true, false, BQ, BN, TM, TN>(a, st);
  return vec ? launch_pass<false, false, true, BQ, BN, TM, TN>(a, st)
             : launch_pass<false, false, false, BQ, BN, TM, TN>(a, st);
}

// The range pre-pass, the split-N pass for one (metric, operand type, load
// width) on the narrow tile (a small row tile for the skip), then the merge.
int run_topk(PassArgs a, int metric_ip, int bf16, int vec, int bq, int bn,
             float* out_v, int* out_i, cudaStream_t st) {
  if (a.Q <= 0 || a.N <= 0 || a.D <= 0 || a.kp < 1 || a.kp > 128 ||
      a.S < 1 || a.S > 65535 || bq != F32_NARROW_BQ || bn != F32_NARROW_BN ||
      f32_topk_smem_bytes(bq, bn, a.kp) > 232448 || a.perm == nullptr ||
      a.ranges == nullptr || a.row_ranges == nullptr)
    return int(cudaErrorInvalidValue);
  const int n_tiles = (a.N + bn - 1) / bn;
  a.tiles_per_split = (n_tiles + a.S - 1) / a.S;
  cudaError_t err = launch_owner_ranges(a.cseg, a.qseg, a.perm, a.Q, a.N, bq,
                                        bn, const_cast<int4*>(a.ranges), st);
  if (err != cudaSuccess) return int(err);
  err = dispatch_pass<F32_NARROW_BQ, F32_NARROW_BN, 8, 4>(!metric_ip, bf16,
                                                          vec, a, st);
  if (err != cudaSuccess) return int(err);
  return int(launch_merge(a.partial, a.flags, a.perm, a.Q, a.S, a.kp, bq,
                          out_v, out_i, st));
}

}  // namespace

// x (Q, D) fp32, y (N, D) fp32, qseg (Q,) and cseg (N,) int32, perm (Q,)
// int32 (a permutation of the rows, in practice the stable argsort of
// qseg), all contiguous on the device; ranges: ceil(N / bn) + ceil(Q / bq)
// int4 scratch (column tiles, then row tiles); flags: ceil(Q / bq) * S int32
// scratch; counter: one uint64 that the pass
// adds its computed tiles to (or null); vec: D % 4 == 0 and x, y 16-byte
// aligned; (bq, bn) = (32, 256); partial: Q * S * kp 64-bit scratch; out_v
// (Q, kp) fp32, out_i (Q, kp) int32.  Returns cudaGetLastError() after the
// launches.
extern "C" int topk_seg_f32(const void* x, const void* y, const void* qseg,
                            const void* cseg, const void* perm, void* ranges,
                            void* flags, void* counter, int Q, int N, int D,
                            int kp, int metric_ip, int bf16, int vec, int bq,
                            int bn, int S, void* partial, void* out_v,
                            void* out_i, void* stream) {
  const int4* col_ranges = static_cast<const int4*>(ranges);
  PassArgs a{static_cast<const float*>(x), static_cast<const float*>(y),
             static_cast<const int*>(qseg), static_cast<const int*>(cseg),
             static_cast<const int*>(perm), col_ranges,
             bn > 0 ? col_ranges + (N + bn - 1) / bn : nullptr,
             Q, N, D, kp, 0, S,
             static_cast<unsigned long long*>(partial),
             static_cast<int*>(flags),
             static_cast<unsigned long long*>(counter)};
  return run_topk(a, metric_ip, bf16, vec, bq, bn, static_cast<float*>(out_v),
                  static_cast<int*>(out_i), static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
