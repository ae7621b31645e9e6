// `topk_f32`: unsegmented exact fp32 top-k of every query row against every
// row of a base.
//
// What it replaces.  The TPU kernel `_topk_kernel` (src/repro/kernels/
// distance_topk.py:62, launched by `distance_topk`, reached from `ops.topk`).
// The distance is the GEMM form max(|x|^2 + |y|^2 - 2 x.y, 0) for "l2" and
// -x.y for "ip", with true fp32 FMAs (accum "f32") or operands rounded to
// bf16 and fp32 sums (accum "bf16").  Output: (Q, kp) ascending distances
// and columns, ranked by 64-bit (distance, column) keys (topk_common.cuh) so
// the lower column wins ties whatever the split; (+inf, -1) where N < kp.
// Ragged Q and N are masked here, d and the operands' alignment are free,
// and nothing is padded or copied.
//
// What bounds it.  At Q = 128, N = 1,048,576, d = 128 the products are
// 2·Q·N·d = 34.4 GFLOP, 0.51 ms at the H100's 67 TFLOP/s fp32 peak, against
// 0.54 GB of rows, 0.16 ms at 3.35 TB/s: operations.  Tensor cores would
// change the products (TF32 keeps 10 mantissa bits), so accum "f32" stays on
// the CUDA cores, and the levers are the copies, shared memory and the
// epilogue: every cycle not spent on an FMA is lost.
//
// Design.  A split-N pass, then the merge of topk_common.cuh.  Grid (row
// tiles, S), one block an SM (its shared memory is more than half of one),
// each block walking its split of column tiles as a stream of (tile,
// d-chunk) steps.
//  - Asynchronous copies.  Each step's chunk of y (and of x where x
//    streams) arrives by 16-byte cp.async.cg (4-byte cp.async.ca where d %
//    4 != 0 or a base is not 16-byte aligned) into a ring of STAGES stages
//    that runs across tile boundaries, so the next tile's chunks are in
//    flight while this tile's epilogue runs; no operand passes through
//    registers on its way in.  Rows past N or Q and words past d are
//    zero-filled by the copy.  A staged row is the chunk and one pad unit
//    of 16 bytes, so the float4 reads of 8 consecutive rows at one k fall
//    in 8 distinct bank groups and every read of the product loop is a base
//    plus an immediate.  One barrier a step orders the ring.
//  - The query tile stays resident.  Where a block's row tile x d fits
//    beside the ring (128 x 128 x 4 = 64 KB at the unfiltered shape), x is
//    copied once a block, in 64-word chunks, and the ring holds y only;
//    past that (d = 768) x chunks stream through the ring with y's.  x's
//    norms are summed once a block; y's from the stages, one step ahead so
//    a tile's are in shared memory before the barrier of its last step.
//  - The product loop: 8 x 8 outputs a thread (8 x 4 in the narrow 32 x
//    256 tile for Q <= 32 or large k), rows ty + TY·i and columns tx + TX·j;
//    a k-quad is 16 float4 shared reads and 256 FMAs, in k order.
//  - The epilogue works in registers.  Each accumulator becomes its
//    distance and is compared with its row's threshold word; only passing
//    outputs are listed, as 64-bit (distance, column) keys, into CAND slots
//    a row, at the start of the next step.  The fold is deferred: the vote
//    rides on that step's barrier (__syncthreads_or) and calls a fold only
//    when a row's slots pass TD_TRIGGER or a row overflowed (its unlisted
//    keys stay pending in registers for another round).  Most tiles cost no
//    barrier of their own and no fold.  A warp folds a row's keys into the
//    row's list (RegList, topk_common.cuh): by insertion for a few, by a
//    bitonic sort of the 32 slots and a merge with the list for more (kp
//    <= 32).  The full distance tile is never stored.
//  - Row bounds shared by the splits.  `bound` holds, per query row, the
//    least order-preserving word (make_key's high 32 bits, so negative ip
//    distances keep their order) of a k-th key any block has reached:
//    atomicMin after a fold that lowers a full list's k-th, read at each
//    tile's start into the row's threshold word.  After its tile
//    TD_PUBLISH_AT each block publishes its lists once to `pub`; after the
//    tiles td_union_at picks it folds, for its share of rows, every list
//    published so far and lowers the bound to the k-th key of that union
//    (kp <= 32).  A tile lists only distances at or below the lesser of
//    the row's own k-th and the bound.  Exactness: a full list, and the union of lists
//    from disjoint splits, hold kp distinct columns at or below their k-th,
//    so the row's final k-th key is at or below every such k-th; a column
//    of the final top-kp is at or below it, and the filter keeps equality,
//    so no such column is dropped, whatever the timing.  `pub` is written
//    once, so no reader sees a list half old, half new.
//  - Registers and code: 256 threads, one block an SM, so ptxas may give a
//    thread up to 255 registers (64 accumulators, 32 + 4 operand words
//    live); every piece of the epilogue is compiled once, so the product
//    loop and the epilogue stay in the instruction cache.  chip_smoke.py
//    prints each instantiation's registers and spills (0 expected).
//  - Shared memory: the candidate slots, per-row and per-column scalars,
//    the union's scratch, the ring, the lists and the resident x; mirrored
//    by tuning.dense_smem_bytes.
#include "topk_common.cuh"

namespace {

constexpr int TD_TRIGGER = CAND - 8;  // listed keys of a row that call a fold
constexpr int TD_SORT_MIN = 4;         // more keys than this: sort and merge
constexpr int TD_PUBLISH_AT = 1;       // local tile after which lists publish
// Local tiles after which a block lowers its rows' bounds to the k-th of
// the union of the lists published so far.
__device__ __forceinline__ bool td_union_at(int tl) { return tl == 3; }
constexpr unsigned TD_NO_BOUND = 0xffffffffu;  // above every distance's word

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copies global -> shared, zero-filled unless `valid`.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The distance of an accumulated product (the expression of kernel A).
__device__ __forceinline__ float dense_dist(float p, float xr, float yc,
                                            bool l2) {
  return l2 ? fmaxf(xr + yc - 2.f * p, 0.f) : -p;
}

// The fp32 value whose order-preserving word (make_key's high 32 bits) is u;
// TD_NO_BOUND gives a NaN, which no comparison `v > t` passes.
__device__ __forceinline__ float word_value(unsigned u) {
  return key_value(static_cast<unsigned long long>(u) << 32);
}

// Sort one key a lane ascending across the warp (bitonic).
__device__ __forceinline__ unsigned long long warp_sort32(
    unsigned long long v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL, v, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
    }
  return v;
}

// Fold up to 32 keys (one a lane, KEY_MASKED where none) into a row's list
// and return its new k-th key.  kp <= 32 and many keys: the 32 smallest of
// the list and the sorted keys are the element-wise minima of the list and
// the keys reversed (a bitonic sequence), merged in five steps.  Keys of a
// row are unique, so the result is the exact top-kp of the union.
template <int NS>
__device__ __forceinline__ unsigned long long fold_keys(
    unsigned long long* L, unsigned long long key, int m, int kp, int lane) {
  RegList<NS> rl;
  rl.load(L, kp, lane);
  if constexpr (NS == 1) {
    if (m > TD_SORT_MIN) {
      const unsigned long long c = warp_sort32(key, lane);
      const unsigned long long r = __shfl_sync(FULL, c, 31 - lane);
      unsigned long long v = r < rl.R[0] ? r : rl.R[0];
#pragma unroll
      for (int j = 16; j > 0; j >>= 1) {
        const unsigned long long o = __shfl_xor_sync(FULL, v, j);
        v = (lane & j) == 0 ? (o < v ? o : v) : (o > v ? o : v);
      }
      rl.R[0] = lane < kp ? v : KEY_MASKED;
      rl.refresh_kth(kp);
      rl.store(L, kp, lane);
      return rl.kth;
    }
  }
  rl.fold(key, kp, lane);
  rl.store(L, kp, lane);
  return rl.kth;
}


struct DenseArgs {
  const float* x;
  const float* y;
  int Q, N, D, kp, tiles_per_split, S;
  int l2, bf16, vec;
  unsigned* bound;              // (Q,) words (header); all ones at launch
  unsigned long long* partial;  // (Q, S, kp) keys
  int* flags;                   // (row tiles, S): 1 where the lists exist
  unsigned long long* pub;      // (Q, S, kp) keys: lists published once
  int* pubflags;                // (row tiles, S): 1 once published, else 0
};

// One instantiation: a BQ x BN tile, TM x TN outputs a thread, KC-word
// d-chunks through a ring of STAGES stages, x resident (RES) or streamed.
// A TY x TX thread grid; a warp covers WTY x WTX threads, so each quarter
// of it reads one row of x and 8 consecutive columns of y.
template <int BQ_, int BN_, int TM_, int TN_, int KC_, int STAGES_, bool RES_>
struct DenseCfg {
  static constexpr int BQ = BQ_, BN = BN_, TM = TM_, TN = TN_, KC = KC_;
  static constexpr int STAGES = STAGES_;
  static constexpr bool RES = RES_;
  static constexpr int TY = BQ / TM, TX = BN / TN;
  static constexpr int WTX = TX == 16 ? 8 : 16, WTY = 32 / WTX;
  static constexpr int WX = TX / WTX;
  static_assert(TY * TX == NT && (TY / WTY) * WX == NT / 32, "layout");
  static_assert(TN <= 32, "one 32-bit mask of outputs a row");
  static constexpr int UNITS = KC / 4;     // 16-byte units of a row chunk
  static constexpr int RS = UNITS + 1;     // a staged row: one pad unit
  static constexpr int TPC = NT / BN;      // threads a column's norm
  static constexpr int UPT = UNITS / TPC;  // units each of them sums
  static_assert(TPC * BN == NT && TPC <= 2, "norm layout");
  static constexpr int RSTEP = NT / UNITS;  // rows a pass of the copies
  static_assert(BN % RSTEP == 0 && BQ % RSTEP == 0, "copy layout");
  static constexpr int STAGE = (RES ? BN : BN + BQ) * RS;  // float4 units
  // Shared memory, compile-time offsets first (bytes).
  static constexpr int OFF_X2 = BQ * CAND * 8;        // after the slots
  static constexpr int OFF_Y2 = OFF_X2 + BQ * 4;      // [2][BN]
  static constexpr int OFF_LORD = OFF_Y2 + 2 * BN * 4;
  static constexpr int OFF_CNT = OFF_LORD + BQ * 4;
  static constexpr int OFF_USCR = OFF_CNT + BQ * 4;   // [NT / 32][32] keys
  static constexpr int OFF_RING = OFF_USCR + (NT / 32) * 32 * 8;
  static constexpr int OFF_LISTS = OFF_RING + STAGES * STAGE * 16;
  static_assert(OFF_USCR % 8 == 0 && OFF_RING % 16 == 0, "alignment");
  // ... then the lists [BQ][kp] and, resident, x [chunks][BQ][RS].
  static size_t smem_bytes(int kp, int D) {
    const size_t chunks = (D + KC - 1) / KC;
    return OFF_LISTS + size_t(BQ) * kp * 8 +
           (RES ? chunks * BQ * RS * 16 : 0);
  }
};

// A (local tile, chunk, stage) position in a block's stream of steps.
struct Cursor {
  int tl, ch, st;
  template <int STAGES>
  __device__ __forceinline__ void advance(int chunks) {
    if (++ch == chunks) {
      ch = 0;
      ++tl;
    }
    if (++st == STAGES) st = 0;
  }
};

template <class C>
__global__ void __launch_bounds__(NT, 1) topk_dense_pass(DenseArgs a) {
  constexpr int BQ = C::BQ, BN = C::BN, TM = C::TM, TN = C::TN;
  constexpr int RS = C::RS, UNITS = C::UNITS, STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(smem);  // [BQ][CAND]
  float* x2s = reinterpret_cast<float*>(smem + C::OFF_X2);
  float* y2s = reinterpret_cast<float*>(smem + C::OFF_Y2);
  unsigned* lord = reinterpret_cast<unsigned*>(smem + C::OFF_LORD);
  int* cnt = reinterpret_cast<int*>(smem + C::OFF_CNT);
  unsigned long long* uscr =
      reinterpret_cast<unsigned long long*>(smem + C::OFF_USCR);
  float4* ring = reinterpret_cast<float4*>(smem + C::OFF_RING);
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(smem + C::OFF_LISTS);
  float4* xres = reinterpret_cast<float4*>(lists + BQ * a.kp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = (warp % C::WX) * C::WTX + lane % C::WTX;
  const int ty = (warp / C::WX) * C::WTY + lane / C::WTX;
  const int row0 = blockIdx.x * BQ;
  const int n_tiles = (a.N + BN - 1) / BN;
  const int t_begin = blockIdx.y * a.tiles_per_split;
  const int t_end = min(n_tiles, t_begin + a.tiles_per_split);
  int* flag = a.flags + blockIdx.x * a.S + blockIdx.y;
  if (t_begin >= t_end) {  // an empty split (block-uniform)
    if (tid == 0) *flag = 0;
    return;
  }
  const int chunks = (a.D + C::KC - 1) / C::KC;
  const int total = (t_end - t_begin) * chunks;  // (tile, chunk) steps
  const int rows_here = min(BQ, a.Q - row0);     // rows of this row tile
  const bool l2 = a.l2 != 0, bf16 = a.bf16 != 0;

  // Copies: thread tid moves unit cu of rows cr, cr + RSTEP, ... of each
  // operand chunk; its source rows advance by RSTEP·D words.
  const int cu = tid % UNITS, cr = tid / UNITS;
  const size_t cstep = size_t(C::RSTEP) * a.D;
  auto copy_rows = [&](unsigned dst, const float* src, int rows_left,
                       int k0, int nrows) {  // src: row cr, word cu·4
    const int k = k0 + cu * 4;
    for (int m = 0; m < nrows / C::RSTEP; ++m) {
      const unsigned d = dst + ((cr + m * C::RSTEP) * RS + cu) * 16;
      const float* s = src + m * cstep + k0;
      const bool row_ok = cr + m * C::RSTEP < rows_left;
      if (a.vec) {
        const bool ok = row_ok && k < a.D;
        cp_async16(d, ok ? s : a.y, ok);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const bool ok = row_ok && k + w < a.D;
          cp_async4(d + 4 * w, ok ? s + w : a.y, ok);
        }
      }
    }
  };
  auto round_rows = [&](float4* dst, int nrows) {  // accum "bf16"
    for (int m = 0; m < nrows / C::RSTEP; ++m) {
      float4* p = dst + (cr + m * C::RSTEP) * RS + cu;
      *p = operand4<true>(*p);
    }
  };
  const float* xsrc = a.x + size_t(row0 + cr) * a.D + cu * 4;
  const float* ysrc = nullptr;  // row cr of the load cursor's tile
  int ycols = 0;                // its columns left from row 0 of the tile
  auto load_step = [&](const Cursor& c) {
    if (c.ch == 0) {
      const int col0 = (t_begin + c.tl) * BN;
      ysrc = a.y + size_t(col0 + cr) * a.D + cu * 4;
      ycols = a.N - col0;
    }
    const unsigned st = smem_u32(ring + c.st * C::STAGE);
    copy_rows(st, ysrc, ycols, c.ch * C::KC, BN);
    if (!C::RES)
      copy_rows(st + BN * RS * 16, xsrc, rows_here, c.ch * C::KC, BQ);
  };
  auto round_step = [&](const Cursor& c) {
    float4* st = ring + c.st * C::STAGE;
    round_rows(st, BN);
    if (!C::RES) round_rows(st + BN * RS, BQ);
  };
  // Column norms: add this thread's part of a step's stage; at the last
  // chunk of a tile, publish the tile's norms under its parity.
  float ynrm = 0.f;
  auto norm_step = [&](const Cursor& c, int chunks_) {
    const float4* src = ring + c.st * C::STAGE + (tid / C::TPC) * RS +
                        (tid % C::TPC) * C::UPT;
#pragma unroll
    for (int u = 0; u < C::UPT; ++u) {
      const float4 v = src[u];
      ynrm = fmaf(v.x, v.x, ynrm);
      ynrm = fmaf(v.y, v.y, ynrm);
      ynrm = fmaf(v.z, v.z, ynrm);
      ynrm = fmaf(v.w, v.w, ynrm);
    }
    if (c.ch == chunks_ - 1) {  // block-uniform
      if (C::TPC == 2) ynrm += __shfl_xor_sync(FULL, ynrm, 1);
      if (tid % C::TPC == 0) y2s[(c.tl & 1) * BN + tid / C::TPC] = ynrm;
      ynrm = 0.f;
    }
  };

  // Prologue: the resident x (group 0), the ring's first STAGES - 1 steps
  // (one group each), the lists, the row scalars and x's norms.
  if (C::RES)
    for (int ch = 0; ch < chunks; ++ch)
      copy_rows(smem_u32(xres + ch * BQ * RS), xsrc, rows_here, ch * C::KC,
                BQ);
  cp_async_commit();
  Cursor cl{0, 0, 0};  // the next step to load
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < total) load_step(cl);
    cl.advance<STAGES>(chunks);
    cp_async_commit();
  }
  for (int i = tid; i < BQ * a.kp; i += NT) lists[i] = KEY_MASKED;
  for (int r = tid; r < BQ; r += NT) {
    lord[r] = TD_NO_BOUND;
    cnt[r] = 0;
  }
  if (l2)  // x's norms, once a block: a warp a row
    for (int r = warp; r < BQ; r += NT / 32) {
      float s = 0.f;
      if (r < rows_here)
        for (int d = lane; d < a.D; d += 32) {
          float v = __ldg(a.x + size_t(row0 + r) * a.D + d);
          if (bf16) v = operand<true>(v);
          s = fmaf(v, v, s);
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0) x2s[r] = s;
    }
  cp_async_wait<STAGES - 2>();  // the resident x and step 0 (own copies)
  Cursor cs{0, 0, 0};           // the step computed
  if (bf16) {
    if (C::RES)
      for (int ch = 0; ch < chunks; ++ch) round_rows(xres + ch * BQ * RS, BQ);
    round_step(cs);
  }
  __syncthreads();
  if (l2) norm_step(cs, chunks);

  float acc[TM][TN];
  unsigned pend[TM];  // bit j: output (i, j) of the last tile to list
#pragma unroll
  for (int i = 0; i < TM; ++i) pend[i] = 0;
  unsigned gbound = TD_NO_BOUND;  // row tid's shared bound, this tile
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  int ptl = 0;                    // the local tile `pend` refers to
  bool need = false;              // a fold is due at the next barrier

  // Key of output (i, j) of local tile tl.
  auto key_of = [&](int i, int j, int tl) {
    const int r = ty + C::TY * i, c = tx + C::TX * j;
    const float v = dense_dist(acc[i][j], l2 ? x2s[r] : 0.f,
                               l2 ? y2s[(tl & 1) * BN + c] : 0.f, l2);
    return make_key(v, (t_begin + tl) * BN + c);
  };
  // List the pending keys into their rows' slots (the first CAND of a row;
  // the rest stay pending).  Returns whether a fold is due: a row's slots
  // passed TD_TRIGGER or a key was left over; `listed`: any key listed.
  auto list_pending = [&](bool& listed) {
    bool due = false;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (pend[i] == 0) continue;
      const int r = ty + C::TY * i;
      const int n = __popc(pend[i]);
      int pos = atomicAdd(cnt + r, n);
      listed = true;
      due |= pos + n > TD_TRIGGER;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if ((pend[i] >> j) & 1u) {
          if (pos < CAND) {
            cand[r * CAND + pos] = key_of(i, j, ptl);
            pend[i] &= ~(1u << j);
          }
          ++pos;
        }
      due |= pend[i] != 0;
    }
    return due;
  };
  // Lane 0 of a row's warp: the row's new k-th key, into its threshold
  // word and the shared bound when it lowers them.
  auto kth_done = [&](int r, unsigned long long kth) {
    cnt[r] = 0;
    const unsigned w =
        kth == KEY_MASKED ? TD_NO_BOUND : static_cast<unsigned>(kth >> 32);
    if (w < lord[r]) {
      lord[r] = w;
      atomicMin(a.bound + row0 + r, w);
    }
  };
  // Fold every row's listed keys (a warp a row), then drop pending keys
  // above the lowered thresholds.
  auto fold_all = [&]() {
    for (int r = warp; r < BQ; r += NT / 32) {
      const int n = cnt[r];  // warp-uniform
      if (n == 0) continue;
      const int m = min(n, CAND);
      const unsigned long long key =
          lane < m ? cand[r * CAND + lane] : KEY_MASKED;
      unsigned long long* L = lists + r * a.kp;
      const unsigned long long kth =
          a.kp <= 32 ? fold_keys<1>(L, key, m, a.kp, lane)
                     : fold_keys<4>(L, key, m, a.kp, lane);
      if (lane == 0) kth_done(r, kth);
    }
    __syncthreads();  // lists, lord and cnt
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (pend[i] == 0) continue;
      const float th = word_value(lord[ty + C::TY * i]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (((pend[i] >> j) & 1u) &&
            key_value(key_of(i, j, ptl)) > th)
          pend[i] &= ~(1u << j);
    }
  };

  // Step s first services the tile that ended at step s - 1 (its keys
  // listed, a fold if one is due, its publication or union), then computes.
  // Step `total` only services: it folds whatever is left.
  bool tile_done = false;  // pend holds the passing outputs of tile ptl
  for (int s = 0;; ++s) {
    const bool end = s == total;
    bool listed = false;
    if (tile_done) need = list_pending(listed);
    Cursor cn = cs;  // step s + 1
    cn.advance<STAGES>(chunks);
    // Steps s and s + 1 have landed (own copies), then for every thread;
    // the barrier also takes the vote on a fold.
    if (s + 1 < total) {
      cp_async_wait<STAGES - 3>();
      if (bf16) round_step(cn);
    } else {
      cp_async_wait<0>();
    }
    if (__syncthreads_or(need || end)) {
      do {
        fold_all();
        listed = false;
        need = list_pending(listed);
      } while (__syncthreads_or(end ? listed : need));
    }
    if (end) break;
    // No key is pending now (a thread with one voted for another round).
    need = false;
#pragma unroll
    for (int i = 0; i < TM; ++i) pend[i] = 0;
    if (tile_done && a.kp <= 32 && ptl == TD_PUBLISH_AT) {
      // Publish this block's lists once (stable since the last fold).
      for (int e = tid; e < rows_here * a.kp; e += NT)
        a.pub[(size_t(row0 + e / a.kp) * a.S + blockIdx.y) * a.kp +
              e % a.kp] = lists[e];
      __threadfence();
      __syncthreads();
      if (tid == 0) atomicExch(a.pubflags + blockIdx.x * a.S + blockIdx.y, 1);
    }
    if (tile_done && a.kp <= 32 && td_union_at(ptl)) {
      // The k-th key of the union of the lists published so far bounds the
      // row's final k-th: they hold distinct columns.  Rows blockIdx.y,
      // blockIdx.y + S, ...; warp w folds splits w, w + 8, ...
      for (int r = blockIdx.y; r < rows_here; r += a.S) {
        RegList<1> rl;
        rl.clear();
        const unsigned long long* src =
            a.pub + size_t(row0 + r) * a.S * a.kp + lane;
        for (int base = warp; base < a.S; base += NT) {
          const int s2 = base + (NT / 32) * lane;
          const int f = s2 < a.S ? *reinterpret_cast<volatile int*>(
                                       a.pubflags + blockIdx.x * a.S + s2)
                                 : 0;
          unsigned ball = __ballot_sync(FULL, f != 0);
          __threadfence();  // the lists behind the flags read above
          while (ball) {
            unsigned long long k4[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              k4[q] = KEY_MASKED;
              if (ball) {
                const int sq = base + (NT / 32) * (__ffs(ball) - 1);
                ball &= ball - 1;
                if (lane < a.kp) k4[q] = __ldcg(src + size_t(sq) * a.kp);
              }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) rl.fold(k4[q], a.kp, lane);
          }
        }
        rl.store(uscr + warp * 32, a.kp, lane);
        __syncthreads();
        if (warp == 0) {
          for (int w = 1; w < NT / 32; ++w)
            rl.fold(lane < a.kp ? uscr[w * 32 + lane] : KEY_MASKED, a.kp,
                    lane);
          if (lane == 0 && rl.kth != KEY_MASKED) {
            const unsigned wd = static_cast<unsigned>(rl.kth >> 32);
            atomicMin(a.bound + row0 + r, wd);
            atomicMin(lord + r, wd);
          }
        }
        __syncthreads();
      }
    }
    tile_done = false;
    if (cs.ch == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      if (tid < rows_here) gbound = __ldcg(a.bound + row0 + tid);
    }
    // Stage cl.st was read at step s - 1: every thread is past it.
    if (s + STAGES - 1 < total) load_step(cl);
    cl.advance<STAGES>(chunks);
    cp_async_commit();
    // Norms run one step ahead, so a tile's are published before the
    // barrier of its last step.
    if (l2 && s + 1 < total) norm_step(cn, chunks);
    const float4* st = ring + cs.st * C::STAGE;
    const float4* A =
        (C::RES ? xres + cs.ch * BQ * RS : st + BN * RS) + ty * RS;
    const float4* B = st + tx * RS;
#pragma unroll 2
    for (int u = 0; u < UNITS; ++u) {
      float4 bv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = B[j * C::TX * RS + u];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 av = A[i * C::TY * RS + u];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float c = acc[i][j];
          c = fmaf(av.x, bv[j].x, c);
          c = fmaf(av.y, bv[j].y, c);
          c = fmaf(av.z, bv[j].z, c);
          acc[i][j] = fmaf(av.w, bv[j].w, c);
        }
      }
    }
    if (cs.ch == chunks - 1) {
      // ---- Epilogue of local tile cs.tl: the outputs at or below their
      // rows' thresholds.  The shared bound joins the row's threshold word;
      // a reader may see the word before or after: both are valid bounds.
      const int tl = cs.tl;
      if (tid < rows_here) atomicMin(lord + tid, gbound);
      const float* y2t = y2s + (tl & 1) * BN;
      const int cols_here = a.N - (t_begin + tl) * BN;  // >= BN: all live
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty + C::TY * i;
        const float th = word_value(lord[r]);
        const float xr = l2 ? x2s[r] : 0.f;
        pend[i] = 0;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = tx + C::TX * j;
          const float v = dense_dist(acc[i][j], xr, l2 ? y2t[c] : 0.f, l2);
          if (!(v > th) && c < cols_here) pend[i] |= 1u << j;
        }
        if (r >= rows_here) pend[i] = 0;
      }
      ptl = tl;
      tile_done = true;
    }
    cs = cn;
  }
  for (int e = tid; e < rows_here * a.kp; e += NT)
    a.partial[(size_t(row0 + e / a.kp) * a.S + blockIdx.y) * a.kp +
              e % a.kp] = lists[e];
  if (tid == 0) *flag = 1;
}

// The four instantiations (tuning.DENSE_TILES and the policy that picks
// them): wide 128 x 128 with 8 x 8 outputs a thread, x resident in 64-word
// chunks through 3 stages, or streamed in 32-word chunks through 4; narrow
// 32 x 256 with 8 x 4, 32-word chunks through 4 stages.
using WideRes = DenseCfg<128, 128, 8, 8, 64, 3, true>;
using WideStream = DenseCfg<128, 128, 8, 8, 32, 4, false>;
using NarrowRes = DenseCfg<32, 256, 8, 4, 32, 4, true>;
using NarrowStream = DenseCfg<32, 256, 8, 4, 32, 4, false>;

template <class C>
cudaError_t launch_dense(const DenseArgs& a, cudaStream_t st) {
  const size_t smem = C::smem_bytes(a.kp, a.D);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = topk_dense_pass<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Q + C::BQ - 1) / C::BQ, a.S);
  kernel<<<grid, NT, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x (Q, D) and y (N, D) fp32, contiguous on the device, any alignment;
// vec: D % 4 == 0 and x, y 16-byte aligned (16-byte copies, else 4-byte);
// flags: ceil(Q / bq) * S int32 scratch; bound: Q + ceil(Q / bq) * S int32
// scratch (the rows' shared bounds and the publication flags, both set
// here); pub, partial: Q * S * kp 64-bit scratch; (bq, bn) = (128, 128) or
// (32, 256), resident: x kept in shared memory (tuning.select_dense_tile);
// out_v (Q, kp) fp32, out_i (Q, kp) int32.  Returns cudaGetLastError()
// after the launches.
extern "C" int topk_f32(const void* x, const void* y, void* flags,
                        void* bound, void* pub, int Q, int N, int D, int kp,
                        int metric_ip, int bf16, int vec, int bq, int bn,
                        int resident, int S, void* partial, void* out_v,
                        void* out_i, void* stream) {
  const bool wide = bq == 128 && bn == 128, narrow = bq == 32 && bn == 256;
  const bool aligned =
      D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  if (Q <= 0 || N <= 0 || D <= 0 || kp < 1 || kp > 128 || S < 1 ||
      S > 65535 || !(wide || narrow) || (vec && !aligned))
    return int(cudaErrorInvalidValue);
  const int n_tiles = (N + bn - 1) / bn;
  DenseArgs a{static_cast<const float*>(x), static_cast<const float*>(y),
              Q, N, D, kp, (n_tiles + S - 1) / S, S,
              !metric_ip, bf16 != 0, vec != 0,
              static_cast<unsigned*>(bound),
              static_cast<unsigned long long*>(partial),
              static_cast<int*>(flags),
              static_cast<unsigned long long*>(pub),
              static_cast<int*>(bound) + Q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bound, 0xff, size_t(Q) * 4, st);
  if (err != cudaSuccess) return int(err);
  err = cudaMemsetAsync(a.pubflags, 0, size_t((Q + bq - 1) / bq) * S * 4, st);
  if (err != cudaSuccess) return int(err);
  err = wide ? (resident ? launch_dense<WideRes>(a, st)
                         : launch_dense<WideStream>(a, st))
             : (resident ? launch_dense<NarrowRes>(a, st)
                         : launch_dense<NarrowStream>(a, st));
  if (err != cudaSuccess) return int(err);
  return int(launch_merge(static_cast<unsigned long long*>(partial),
                          static_cast<int*>(flags), nullptr, Q, S, kp, bq,
                          static_cast<float*>(out_v),
                          static_cast<int*>(out_i), st));
}

