// Kernel B: segmented SQ8 (int8) scan to the top-kq quantized distances
// (`qtopk_seg_sq8`), and its unsegmented instantiation (`qtopk_sq8`).
//
// What it replaces.  `qtopk_seg_sq8` replaces the TPU kernel
// `_qtopk_seg_kernel` (src/repro/kernels/quant.py:162, launched by
// `_quantized_topk_segmented` at quant.py:220).  `qtopk_sq8` replaces
// `_qtopk_kernel` (quant.py:86, launched by `quantized_topk` at quant.py:135,
// reached from `topk_sq8_rerank`): the same pass with SEG = false, which
// reads no owners and folds every column below N.
//
// What it computes.  Query row r may take flat candidate column c only when
// qseg[r] == cseg[c] (SEG); the quantized distance is
//     dot   = sum_i xq[r, i] * yq[c, i]          (exact int32)
//     cross = (float(dot) * sx[r]) * sy[c]
//     dist  = max((x2[r] + y2[c]) - 2 * cross, 0)
// rounded in exactly this association (__fmul_rn / __fadd_rn / __fsub_rn, so
// no contraction changes a rounding).  Output: (Q, kp) ascending distances
// and flat columns as 64-bit (distance, column) keys, so the lower column
// wins ties; (+inf, -1) where fewer than kp columns match.  Given the same
// inputs the result is bit-identical, values and indices, to the plain
// PyTorch versions `sq8_dense_segmented` / `sq8_dense`.  The wrapper pads
// code rows to a multiple of 16 bytes (Dp); d up to 4096.
//
// What bounds it on the H100.  Kernel B at the main-path shape (Qp = 128, N
// = 2,097,152, d = 128, kqp = 40): the data it needs are the live candidate
// rows' codes and scalars, about 0.17 GB, 0.05 ms at 3.35 TB/s; the int8
// products of the matched pairs are a few G operations, microseconds at
// 1,979 TOP/s.  `qtopk_sq8` at the unfiltered shape (Q = 128, N = 1,048,576,
// d = 128): 143 MB of codes and scalars, 0.043 ms, against 34 G int8
// operations, 0.017 ms.  So both are bound by bytes.  The work the bound
// does not count sets the time in practice: the top-k fold over the
// distances (134 M of them unfiltered), and the split-N lists and merge.
//
// Design.
//  - Products on the int8 tensor cores: mma.sync m16n8k32 s8 x s8 -> s32 fed
//    by ldmatrix.x4 from shared memory.  Integer products are exact (|dot|
//    <= 4096 * 127^2 < 2^31), so bit-equality survives.  The (N, Dp) code
//    table is already B's "col" layout; nothing is transposed.  A block of
//    8 warps computes a BQ x BN tile, each warp 32 x 32 (2 x 4 MMA tiles,
//    32 int32 accumulators per thread).
//  - Asynchronous, double-buffered operand loads: d is walked in chunks of
//    Q8_KC = 128 bytes per row (four 32-byte k-steps), copied by 16-byte
//    cp.async.cg into one of two stages, swizzled (16-byte unit u of row r
//    at u ^ (r & 7)) so that ldmatrix and the copies are free of bank
//    conflicts.  The stream of (tile, chunk) steps of a block is pipelined:
//    step i + 1 is in flight while step i multiplies, across tile
//    boundaries too, so at d <= 128 the next tile's codes arrive while
//    this tile's distances are folded.  The distance tile lives in the
//    stage the tile's last chunk used.  A ragged last chunk (Dp % 128 !=
//    0), rows past Q and columns past N are zero-filled by the copy
//    (source size 0), so the table is never padded beyond 16 bytes.
//  - Kernel A's owner skip (SEG; topk_common.cuh): rows sorted by owner,
//    the range pre-pass, a (row tile, column tile) pair computed only where
//    the ranges of one sign meet, short splits, blocks that meet nothing
//    exit with no barrier, a per-block flag so the merge folds only the
//    lists that exist, and a counter of the tiles computed.
//  - Kernel A's fold: the epilogue turns the accumulator fragments into
//    distances in registers, compares each with its row's current k-th
//    distance and lists the columns at or below it; a warp per row folds
//    them into the row's list held in registers (RegList, fold_rows).
//  - The splits share each row's k-th distance: `bound` holds, per row, the
//    least k-th distance any block's full list has reached (atomicMin on
//    the bits of a non-negative float), and a block lists only columns at
//    or below the lesser of its own k-th and the bound.  Any full list's
//    k-th is at or above the row's final k-th, so no column of the final
//    top-kp is dropped, and the result does not depend on timing.
//  - One block tile, 32 x 256 (tuning.SQ8_TILE), for both: segmented, a
//    small row tile lets the skip bite; unsegmented, it beat on the H100 a
//    128 x 64 tile that holds all Q = 128 rows and reads each code row
//    once (PERF.md): the fold pays each row's overhead per tile, and the
//    wide tile pays it for 64 columns instead of 256.
#include "topk_common.cuh"

namespace {

constexpr int Q8_KC = 128;              // bytes of a row in one d-chunk
constexpr int Q8_UNITS = Q8_KC / 16;    // 16-byte units of a row per chunk
constexpr int Q8_BQ = 32, Q8_BN = 256;  // the block tile (tuning.SQ8_TILE)

// Dynamic shared memory of one pass block; mirrors tuning.sq8_smem_bytes.
inline size_t q8_smem_bytes(int bq, int bn, int kp) {
  return size_t(2) * Q8_KC * (bq + bn)   // two operand stages (one of them
                                         // holds the distance tile)
         + size_t(6 * bq + 3 * bn) * 4   // per-row / per-column scalars
         + size_t(bq) * CAND + size_t(bq) * kp * 8;
}

// Byte offset of 16-byte unit u of stage row r (swizzled).
__device__ __forceinline__ int q8_off(int r, int u) {
  return r * Q8_KC + ((u ^ (r & 7)) << 4);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-filled unless `valid`.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16 x 32, s8, row) * b (32 x 8, s8, col), exact int32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One staged chunk into a warp's 32 x 32 accumulators.  Stage rows [0, BQ)
// are the block's query rows, [BQ, BQ + BN) its columns; `kbytes` bytes of
// the chunk hold codes (k-steps past them are skipped).  A fragments: rows
// (lane & 7) + 8·((lane >> 3) & 1), unit (lane >> 4) of the k-step; B
// fragments (two n8 tiles per ldmatrix.x4): columns (lane & 7) + 8·(lane >>
// 4), unit (lane >> 3) & 1.
template <int BQ>
__device__ __forceinline__ void q8_chunk_product(unsigned stage,
                                                 int (&acc)[2][4][4], int wm,
                                                 int wn, int lane,
                                                 int kbytes) {
#pragma unroll
  for (int ks = 0; ks < Q8_KC / 32; ++ks) {
    if (ks * 32 >= kbytes) break;
    unsigned af[2][4], bf[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = wm * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(af[mt], stage + q8_off(r, 2 * ks + (lane >> 4)));
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int c = BQ + wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8;
      ldmatrix_x4(bf[np], stage + q8_off(c, 2 * ks + ((lane >> 3) & 1)));
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_s8(acc[mt][nt], af[mt], bf[nt >> 1][2 * (nt & 1)],
               bf[nt >> 1][2 * (nt & 1) + 1]);
  }
}

struct Q8Args {
  const signed char* xq;
  const signed char* yq;
  const float* sx;
  const float* x2;
  const float* sy;
  const float* y2;
  const int* qseg;
  const int* cseg;
  const int* perm;         // row order (SEG), or nullptr: rows in order
  const int4* ranges;      // per column tile (SEG)
  const int4* row_ranges;  // per row tile of the sorted rows (SEG)
  int Q, N, Dp, kp, tiles_per_split, S;
  unsigned long long* partial;  // (Q, S, kp) keys, row = sorted position
  int* flags;                   // (row tiles, S): 1 where the lists exist
  unsigned long long* counter;  // tiles computed, or nullptr
  unsigned* bound;  // (Q,) fp32 bits: the least k-th distance any block's
                    // full list has reached (+inf at launch)
};

template <bool SEG, int BQ, int BN>
__global__ void __launch_bounds__(NT, 2) qtopk_seg_pass(Q8Args a) {
  constexpr int WN = BN / 32;             // warp grid (BQ / 32) x WN
  static_assert((BQ / 32) * WN == NT / 32, "eight 32 x 32 warp tiles");
  constexpr int DS = BN + 8;              // row stride of the distance tile
  constexpr int STAGE = Q8_KC * (BQ + BN);
  static_assert(BQ * DS * 4 <= STAGE, "the distance tile fits a stage");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stages = smem;                                // [2][STAGE]
  // the distance tile [BQ][DS] of a tile lives in the stage of the tile's
  // last chunk, free once its products are done
  float* sxs = reinterpret_cast<float*>(smem + 2 * STAGE);  // [BQ]
  float* x2s = sxs + BQ;         // [BQ]
  float* kthv = x2s + BQ;        // [BQ] value of each row's current k-th key
  float* sys = kthv + BQ;        // [BN]
  float* y2s = sys + BN;         // [BN]
  int* xrow = reinterpret_cast<int*>(y2s + BN);  // [BQ] global row or -1
  int* qs = xrow + BQ;           // [BQ]
  int* cnt = qs + BQ;            // [BQ] candidates of the tile per row
  int* cs = cnt + BQ;            // [BN] column owners, INT_MIN past N
  unsigned char* cand = reinterpret_cast<unsigned char*>(cs + BN);
                                 // [BQ][CAND] their columns in the tile
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(cand + BQ * CAND);  // [BQ][kp]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int row0 = blockIdx.x * BQ;
  const int n_tiles = (a.N + BN - 1) / BN;
  const int t_begin = blockIdx.y * a.tiles_per_split;
  const int t_end = min(n_tiles, t_begin + a.tiles_per_split);

  int4 rr = make_int4(0, 0, 0, 0);
  if (SEG) {
    rr = a.row_ranges[blockIdx.x];
    if (!split_meets(rr, a.ranges, t_begin, t_end)) {  // nothing can match
      if (tid == 0) a.flags[blockIdx.x * a.S + blockIdx.y] = 0;
      return;
    }
  }
  for (int r = tid; r < BQ; r += NT) {
    const int p = row0 + r;
    const int g = p < a.Q ? (a.perm != nullptr ? a.perm[p] : p) : -1;
    xrow[r] = g;
    qs[r] = (SEG && g >= 0) ? a.qseg[g] : 0;
    sxs[r] = g >= 0 ? a.sx[g] : 0.f;
    x2s[r] = g >= 0 ? a.x2[g] : 0.f;
    kthv[r] = __uint_as_float(kPosInfBits);
  }
  for (int i = tid; i < BQ * a.kp; i += NT) lists[i] = KEY_MASKED;
  __syncthreads();  // xrow

  // The first computed tile after t (t_end if none).
  auto next_tile = [&](int t) {
    for (++t; t < t_end; ++t)
      if (!SEG || ranges_meet(rr, a.ranges[t])) break;
    return t;
  };
  const int units = a.Dp >> 4;  // 16-byte units of a code row
  const int chunks = (a.Dp + Q8_KC - 1) / Q8_KC;
  // Start the copies of chunk ch of tile t into stage st.
  auto load = [&](int st, int t, int ch) {
    unsigned char* s = stages + st * STAGE;
    const int col0 = t * BN;
    for (int e = tid; e < (BQ + BN) * Q8_UNITS; e += NT) {
      const int r = e / Q8_UNITS, u = e % Q8_UNITS;
      const int gu = ch * Q8_UNITS + u;
      const signed char* src = a.yq;
      bool ok = gu < units;
      if (r < BQ) {
        const int g = xrow[r];
        ok = ok && g >= 0;
        if (ok) src = a.xq + size_t(g) * a.Dp + gu * 16;
      } else {
        const int c = col0 + r - BQ;
        ok = ok && c < a.N;
        if (ok) src = a.yq + size_t(c) * a.Dp + gu * 16;
      }
      cp_async16(smem_u32(s + q8_off(r, u)), src, ok);
    }
  };

  int t = next_tile(t_begin - 1);
  if (t < t_end) load(0, t, 0);
  cp_async_commit();
  int step = 0;
  while (t < t_end) {
    const int col0 = t * BN;
    // this tile's column scalars: loaded now, stored after the products
    float my_sy = 0.f, my_y2 = 0.f;
    int my_cs = INT_MIN;
    if (tid < BN && col0 + tid < a.N) {
      my_sy = a.sy[col0 + tid];
      my_y2 = a.y2[col0 + tid];
      my_cs = SEG ? a.cseg[col0 + tid] : 0;
    }
    int acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    int t_next = t;
    for (int ch = 0; ch < chunks; ++ch, ++step) {
      cp_async_wait_all();
      // step's stage has landed, and every warp is done with the other
      // stage (and with the previous tile's fold)
      __syncthreads();
      int pt = t, pch = ch + 1;
      if (pch == chunks) {
        pt = t_next = next_tile(t);
        pch = 0;
      }
      if (pt < t_end) load((step + 1) & 1, pt, pch);
      cp_async_commit();
      q8_chunk_product<BQ>(smem_u32(stages + (step & 1) * STAGE), acc, wm,
                           wn, lane, a.Dp - ch * Q8_KC);
    }
    if (tid < BN) {
      sys[tid] = my_sy;
      y2s[tid] = my_y2;
      cs[tid] = my_cs;
    }
    float* dist = reinterpret_cast<float*>(stages + ((step - 1) & 1) * STAGE);
    for (int r = tid; r < BQ; r += NT) {
      cnt[r] = 0;
      const int g = xrow[r];
      if (g >= 0) {  // share the k-th across splits
        const unsigned mine = __float_as_uint(kthv[r]);
        const unsigned all = __ldcg(a.bound + g);
        if (mine < all) atomicMin(a.bound + g, mine);
        kthv[r] = __uint_as_float(min(mine, all));
      }
    }
    __syncthreads();  // sys, y2s, cs, cnt, kthv; every warp's products
    // Epilogue: thread (lane) holds rows g, g + 8 of each m16 tile and
    // columns 2·(lane & 3) + {0, 1} of each n8 tile (g = lane >> 2).
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mt * 16 + h * 8 + (lane >> 2);
        const float kv = kthv[r], sxr = sxs[r], x2r = x2s[r];
        const int q = qs[r];
        unsigned pass = 0;  // bit 2·nt + e: column c(nt) + e below
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = wn * 32 + nt * 8 + 2 * (lane & 3);
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float cross = __fmul_rn(
                __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + e]), sxr),
                sys[c + e]);
            v[e] = fmaxf(__fsub_rn(__fadd_rn(x2r, y2s[c + e]),
                                   __fmul_rn(2.f, cross)),
                         0.f);
            const int o = cs[c + e];
            if (o != INT_MIN && (!SEG || o == q) && !(v[e] > kv))
              pass |= 1u << (2 * nt + e);
          }
          *reinterpret_cast<float2*>(dist + r * DS + c) =
              make_float2(v[0], v[1]);
        }
        if (xrow[r] >= 0)
          list_candidates<8>(cnt, cand, r, pass, [&](int j) {
            return wn * 32 + (j >> 1) * 8 + 2 * (lane & 3) + (j & 1);
          });
      }
    }
    __syncthreads();
    if (a.kp <= 32)
      fold_rows<1, SEG, BN, DS>(lists, a.kp, dist, cnt, cand, cs, qs, kthv,
                                col0, warp, lane, BQ);
    else if (a.kp <= 64)
      fold_rows<2, SEG, BN, DS>(lists, a.kp, dist, cnt, cand, cs, qs, kthv,
                                col0, warp, lane, BQ);
    else
      fold_rows<4, SEG, BN, DS>(lists, a.kp, dist, cnt, cand, cs, qs, kthv,
                                col0, warp, lane, BQ);
    t = t_next;  // the next step's barrier orders the fold before the
                 // stage that holds `dist` is loaded again
  }
  cp_async_wait_all();
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
      for (int tt = t_begin; tt < t_end; ++tt)
        computed += !SEG || ranges_meet(rr, a.ranges[tt]);
      atomicAdd(a.counter, static_cast<unsigned long long>(computed));
    }
  }
}

template <bool SEG, int BQ, int BN>
cudaError_t launch_q8_pass(const Q8Args& a, cudaStream_t st) {
  const size_t smem = q8_smem_bytes(BQ, BN, a.kp);
  auto kernel = qtopk_seg_pass<SEG, BQ, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Q + BQ - 1) / BQ, a.S);
  kernel<<<grid, NT, smem, st>>>(a);
  return cudaGetLastError();
}

// The range pre-pass (SEG), the split-N pass, then the merge.
template <bool SEG>
int run_qtopk(Q8Args a, int bq, int bn, float* out_v, int* out_i,
              cudaStream_t st) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a.xq) | reinterpret_cast<uintptr_t>(a.yq))
       & 15) == 0;
  if (a.Q <= 0 || a.N <= 0 || a.Dp <= 0 || a.Dp % 16 != 0 || a.kp < 1 ||
      a.kp > 128 || a.S < 1 || a.S > 65535 || !aligned || bq != Q8_BQ ||
      a.bound == nullptr ||
      bn != Q8_BN || q8_smem_bytes(bq, bn, a.kp) > 232448 ||
      (SEG && (a.perm == nullptr || a.ranges == nullptr ||
               a.row_ranges == nullptr)))
    return int(cudaErrorInvalidValue);
  const int n_tiles = (a.N + bn - 1) / bn;
  a.tiles_per_split = (n_tiles + a.S - 1) / a.S;
  cudaError_t err;
  if (SEG) {
    err = launch_owner_ranges(a.cseg, a.qseg, a.perm, a.Q, a.N, bq, bn,
                              const_cast<int4*>(a.ranges), st);
    if (err != cudaSuccess) return int(err);
  }
  err = launch_q8_pass<SEG, Q8_BQ, Q8_BN>(a, st);
  if (err != cudaSuccess) return int(err);
  return int(launch_merge(a.partial, a.flags, a.perm, a.Q, a.S, a.kp, bq,
                          out_v, out_i, st));
}

}  // namespace

// xq (Q, Dp) and yq (N, Dp) int8 with Dp a multiple of 16 and both bases
// 16-byte aligned; sx, x2 (Q,) and sy, y2 (N,) fp32; qseg (Q,), cseg (N,)
// and perm (Q,) int32 (perm a permutation of the rows, in practice the
// stable argsort of qseg), all contiguous on the device; ranges: ceil(N /
// bn) + ceil(Q / bq) int4 scratch; flags: ceil(Q / bq) * S int32 scratch;
// counter: one uint64 that the pass adds its computed tiles to (or null);
// bound: Q uint32 scratch holding the bits of +inf; (bq, bn) = (32, 256);
// partial: Q * S * kp 64-bit scratch; out_v (Q, kp) fp32, out_i (Q, kp)
// int32.  Returns cudaGetLastError() after the launches.
extern "C" int qtopk_seg_sq8(const void* xq, const void* yq, const void* sx,
                             const void* x2, const void* sy, const void* y2,
                             const void* qseg, const void* cseg,
                             const void* perm, void* ranges, void* flags,
                             void* counter, void* bound, int Q, int N,
                             int Dp, int kp, int bq, int bn, int S,
                             void* partial, void* out_v, void* out_i,
                             void* stream) {
  const int4* col_ranges = static_cast<const int4*>(ranges);
  Q8Args a{static_cast<const signed char*>(xq),
           static_cast<const signed char*>(yq),
           static_cast<const float*>(sx), static_cast<const float*>(x2),
           static_cast<const float*>(sy), static_cast<const float*>(y2),
           static_cast<const int*>(qseg), static_cast<const int*>(cseg),
           static_cast<const int*>(perm), col_ranges,
           bn > 0 ? col_ranges + (N + bn - 1) / bn : nullptr,
           Q, N, Dp, kp, 0, S,
           static_cast<unsigned long long*>(partial),
           static_cast<int*>(flags),
           static_cast<unsigned long long*>(counter),
           static_cast<unsigned*>(bound)};
  return run_qtopk<true>(a, bq, bn, static_cast<float*>(out_v),
                         static_cast<int*>(out_i),
                         static_cast<cudaStream_t>(stream));
}

// The same without owners: every column of yq is a candidate of every row,
// rows in order; (bq, bn) = (32, 256).
extern "C" int qtopk_sq8(const void* xq, const void* yq, const void* sx,
                         const void* x2, const void* sy, const void* y2,
                         void* flags, void* bound, int Q, int N, int Dp,
                         int kp, int bq, int bn, int S, void* partial,
                         void* out_v, void* out_i, void* stream) {
  Q8Args a{static_cast<const signed char*>(xq),
           static_cast<const signed char*>(yq),
           static_cast<const float*>(sx), static_cast<const float*>(x2),
           static_cast<const float*>(sy), static_cast<const float*>(y2),
           nullptr, nullptr, nullptr, nullptr, nullptr, Q, N, Dp, kp, 0, S,
           static_cast<unsigned long long*>(partial),
           static_cast<int*>(flags), nullptr,
           static_cast<unsigned*>(bound)};
  return run_qtopk<false>(a, bq, bn, static_cast<float*>(out_v),
                          static_cast<int*>(out_i),
                          static_cast<cudaStream_t>(stream));
}
