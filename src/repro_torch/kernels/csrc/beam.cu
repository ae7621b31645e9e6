// The fused level-0 HNSW beam search (`beam_f32`).
//
// Replaces no Pallas kernel: the reference writes the beam as XLA code, a
// vmapped `lax.while_loop` (src/repro/core/hnsw_jax.py:26-104 `hnsw_search`,
// :107-196 `hnsw_search_filtered`, vmapped over (graph, query) pairs by
// `hnsw_search_fused` / `hnsw_search_fused_filtered`, :233-270), which runs
// as one device program a size bucket.  This kernel is that program: one
// launch answers every pair of a bucket, with no host round trip.  Its plain
// version is `_beam` in src/repro_torch/core/hnsw_torch.py.
//
// Contract, the reference's to the bit on exactly representable data.  Per
// pair p: graph g = gidx[p], ids (G, N) local slot -> global id, nbr (G, N,
// M2) neighbours as (slot, global id) pairs ((-1, -1) pads; built from
// level0 and ids once at upload, `neighbour_table`), entry (G,).  The
// ef-list starts as [(d(entry), entry)]; each step
//   1. picks the first unexpanded slot of the list (the list is always
//      sorted, so that is `jnp.argmin`'s first minimum), marks it expanded;
//   2. loads its M2 neighbours nb; valid = nb >= 0 & !visited[clip(nb)],
//      with `visited` as it stood before the step;
//   3. computes the distances of the valid ones: sum (v - q)^2 for l2,
//      -(v . q) for ip;
//   4. sets visited[clip(nb)] = seen | (nb >= 0), the last write winning on
//      repeated indices: only clip index 0 can be written both ways (a -1 pad
//      clips to it), so bit 0 is set iff the last neighbour clipping to 0 is
//      a real one;
//   5. folds [list, neighbours] back to ef entries, ascending, the lower
//      position first on equal distance (`lax.top_k(-d)`), entries moving
//      with their slots and expanded flags;
//   6. (filtered) folds the valid neighbours that masks[midx[p]] allows into
//      a k-slot result list by the same rule;
// and the loop stops when the best unexpanded entry is infinite or worse
// than the list's worst valid entry, or after max_iter steps.  Output (P, k)
// distances and global ids, (+inf, -1) in empty slots: the result list, or
// the first min(k, ef) entries of the ef-list.  Graph, mask-row, slot and
// global-id indices are clamped into their tensors, so malformed input reads
// nothing outside them (the plain version raises on it instead).  Any ef >= 1
// (k <= ef when filtered), any M2 >= 1 and any D are taken.
//
// What bounds it: latency, far above bytes.  A pair reads the vectors (and
// mask bytes) of the nodes it visits and the neighbour rows of the nodes it
// expands, most of them shared by the pairs of one graph, so the whole
// bucket moves under a microsecond of device memory rate.  But each step
// depends on the last, some tens to hundreds of steps a pair, so the time is
// the longest pair's steps times one step's latency: its dependent device
// loads (each some hundreds of cycles) and the dependent instructions
// between them (a warp alone issues one about every 4-15 cycles).  One
// block of 128 threads a pair, three block barriers a step:
//   1. the row warp (warp 3) loads the step node's row as (slot, global id)
//      pairs, so the vector loads depend on the row alone (row -> vectors,
//      not row -> ids -> vectors: one dependent device load less a step),
//      tests it against the visited bitmap and compacts the valid
//      neighbours in row order with ballots;
//   2. the valid neighbours' distances only (most of a row is visited
//      already), spread over the block: a group of gs lanes (a power of
//      two, 8 at d = 128) a neighbour, each lane up to 4 float4 (float when
//      d % 4 != 0 or a base is misaligned) against the query slice it keeps
//      in registers, each group up to 2 neighbours at once, so at d = 128
//      the distances of up to 32 valid neighbours load together, in one
//      device latency, the mask bytes beside;
//   3. the fold by rank into the other half of the double-buffered ef-list
//      (and k-slot result list), a thread an entry: a list entry moves by
//      the count of new distances below it, a neighbour to
//      upper_bound(list, d) + its rank among the step's new keys (distance,
//      position), counted over those few keys; ties go to the lower
//      position exactly as in `lax.top_k`, and neighbours repeated in one
//      row both enter.  The least unexpanded and the last valid position
//      come out of warp reductions and two shared atomics.  Meanwhile the
//      row warp, which has no entry to fold at ef + nv <= 96, sets the
//      step's visited bits from the row still in its registers, off the
//      chain of phase 1.
// What was tried and dropped, measured (PERF.md, section 6): a warp that
// predicts the next pick during the fold and fetches its row, with the
// fold's ranks from sorted per-warp segments (binary searches), candidate
// rows and the next vectors copied into shared memory ahead, and one warp a
// pair: each added more dependent instructions to a step than it took
// device latency away.
// The query, the ef-list (distance, slot << 1 | expanded) and the result
// list live in shared memory, or the lists in a per-pair scratch of the
// wrapper's when they do not fit (read through L1), and the query too when
// even it does not.  The visited bitmap (ceil(N / 32) words) is in shared
// memory when it fits the wrapper's budget, else in a global scratch of the
// wrapper's, which each block clears for its own pair and reads through L2
// (ld.global.cg: the atomics that set it live there).  Rows wider than 128
// are taken in chunks of 128, each tested, compacted and folded in turn (a
// fold of a union in pieces is the fold of the union, since every piece is
// tested against the bitmap as it stood before the step and the step's bits
// are set after its last piece's test); the last writer of clip index 0 is
// found over the whole row.
// `steps`, `expanded`, `prof` and `bits_out` (optional, together) receive
// each pair's step count, the slot it expanded at each step (-1 after the
// last), the block's first thread's clock64() cycles by phase, and its
// visited bitmap (copied out of shared memory; the global scratch is the
// bitmap itself).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int NT = 128;         // threads a block: one block a pair
constexpr int RW = NT / 32 - 1; // the warp of the rows
constexpr int CH = 128;         // neighbour positions a chunk
constexpr int NB = 2;           // neighbours a group holds at once
constexpr int CPL = 4;          // loads a lane issues for each of them
constexpr int SMEM_MAX = 232448;
constexpr unsigned FULL = 0xffffffffu;
// shared scalars: the chunk's valid neighbours, and the least unexpanded
// and the last valid position of each list buffer
enum { S_NV = 0, S_PICK = 1, S_LAST = 3, S_N = 16 };
// prof columns: clock64() cycles of the first thread of the row warp: the
// step's start and its row (load, test, compaction), distances, fold (with
// the visited bits), and waits at the block barriers
constexpr int PROF = 4;

// One list entry.  The ef-list: s = slot << 1 | expanded; the result list:
// s = slot; a key: s = 1 if the mask keeps it.
struct Entry {
  float d;
  int s;
};

__host__ __device__ inline size_t round16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Byte offsets of the shared-memory sections; mirrors hnsw_torch's
// `_beam_smem_bytes`.
struct Layout {
  size_t prof, q, lst, res, vl, keys, bits, total;
  __host__ __device__ Layout(int D, int EF, int KR, int M2, int W, bool sbm,
                             bool ls, bool qs) {
    const size_t chw = M2 < CH ? M2 : CH;
    prof = S_N * 4;
    q = prof + PROF * 8;
    size_t o = q + (qs ? round16(size_t(D) * 4) : 0);
    lst = o;
    o += ls ? size_t(2) * EF * 8 : 0;
    res = o;
    o += ls ? size_t(2) * KR * 8 : 0;
    vl = o;                     // the chunk's valid neighbours (slot, id)
    o += chw * 8;
    keys = o;                   // their keys (distance, kept)
    o += chw * 8;
    bits = round16(o);
    total = bits + (sbm ? size_t(W) * 4 : 0);
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The highest power of two <= n (n >= 1).
__device__ __forceinline__ int floor_pow2(int n) {
  return 1 << (31 - __clz(n));
}

__device__ __forceinline__ bool key_lt(float d1, int j1, float d2, int j2) {
  return d1 < d2 || (d1 == d2 && j1 < j2);
}

// Distance of one row to the query, by the warp; every lane returns it.
template <bool IP, bool VEC>
__device__ __forceinline__ float warp_dist(const float* __restrict__ v,
                                           const float* q, int D, int lane) {
  float acc = 0.f;
  if (VEC) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const float4* q4 = reinterpret_cast<const float4*>(q);
#pragma unroll 4
    for (int c = lane; c < D / 4; c += 32) {
      const float4 a = __ldg(v4 + c);
      const float4 b = q4[c];
      if (IP) {
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      } else {
        const float dx = a.x - b.x, dy = a.y - b.y;
        const float dz = a.z - b.z, dw = a.w - b.w;
        acc = fmaf(dx, dx, acc);
        acc = fmaf(dy, dy, acc);
        acc = fmaf(dz, dz, acc);
        acc = fmaf(dw, dw, acc);
      }
    }
  } else {
#pragma unroll 4
    for (int c = lane; c < D; c += 32) {
      const float a = __ldg(v + c);
      if (IP) {
        acc = fmaf(a, q[c], acc);
      } else {
        const float dx = a - q[c];
        acc = fmaf(dx, dx, acc);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  return IP ? -acc : acc;
}

// One lane's share of a group's distance: float4 or float pieces.
template <bool IP, bool VEC>
struct Piece {
  using T = typename std::conditional<VEC, float4, float>::type;
  static __device__ __forceinline__ T load(const float* v, int c) {
    if constexpr (VEC) return __ldg(reinterpret_cast<const float4*>(v) + c);
    else return __ldg(v + c);
  }
  static __device__ __forceinline__ T query(const float* q, int c) {
    if constexpr (VEC) return reinterpret_cast<const float4*>(q)[c];
    else return q[c];
  }
  static __device__ __forceinline__ float add(float acc, const T& a,
                                              const T& b) {
    if constexpr (VEC) {
      if (IP) {
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        return fmaf(a.w, b.w, acc);
      }
      const float dx = a.x - b.x, dy = a.y - b.y;
      const float dz = a.z - b.z, dw = a.w - b.w;
      acc = fmaf(dx, dx, acc);
      acc = fmaf(dy, dy, acc);
      acc = fmaf(dz, dz, acc);
      return fmaf(dw, dw, acc);
    } else {
      if (IP) return fmaf(a, b, acc);
      const float dx = a - b;
      return fmaf(dx, dx, acc);
    }
  }
};

// The distances of NBX neighbours a group at once: vp their rows (null: no
// neighbour), sub the lane in the group of gs; the query slice of the lane
// in qr when one round of CPL pieces covers the row, else read from q.
// Returns each sum in every lane of the group.
template <bool IP, bool VEC, int NBX>
__device__ __forceinline__ void group_dists(
    float (&acc)[NB], const float* const (&vp)[NB],
    const typename Piece<IP, VEC>::T (&qr)[CPL], const float* q, int C,
    int gs, int sub, bool one_round) {
  using PC = Piece<IP, VEC>;
  using T = typename PC::T;
#pragma unroll
  for (int b = 0; b < NBX; ++b) acc[b] = 0.f;
  if (one_round) {
    T v[NBX][CPL];
#pragma unroll
    for (int b = 0; b < NBX; ++b)
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = sub + u * gs;
        v[b][u] = vp[b] != nullptr && c < C ? PC::load(vp[b], c) : T{};
      }
#pragma unroll
    for (int u = 0; u < CPL; ++u)
#pragma unroll
      for (int b = 0; b < NBX; ++b) acc[b] = PC::add(acc[b], v[b][u], qr[u]);
  } else {
    for (int c0 = sub; c0 < C; c0 += gs * CPL) {
      T v[NBX][CPL];
#pragma unroll
      for (int b = 0; b < NBX; ++b)
#pragma unroll
        for (int u = 0; u < CPL; ++u) {
          const int c = c0 + u * gs;
          v[b][u] = vp[b] != nullptr && c < C ? PC::load(vp[b], c) : T{};
        }
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = c0 + u * gs;
        const T qv = c < C ? PC::query(q, c) : T{};
#pragma unroll
        for (int b = 0; b < NBX; ++b) acc[b] = PC::add(acc[b], v[b][u], qv);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < gs)
#pragma unroll
      for (int b = 0; b < NBX; ++b) acc[b] += __shfl_xor_sync(FULL, acc[b], o);
}

// # of the n entries of a (sorted by d, n >= 1) with d <= x, by binary
// lifting from top = floor_pow2(n).
__device__ __forceinline__ int count_le(const Entry* a, int n, int top,
                                        float x) {
  int pos = 0;
  for (int b = top; b > 0; b >>= 1) {
    const int c = pos + b;
    if (c <= n && a[c - 1].d <= x) pos = c;
  }
  return pos;
}

__device__ __forceinline__ void set_bit(unsigned* bits, int c) {
  atomicOr(bits + (c >> 5), 1u << (c & 31));
}

template <bool SBM>
__device__ __forceinline__ bool test_bit(const unsigned* bits, int c) {
  const unsigned w = SBM ? bits[c >> 5] : __ldcg(bits + (c >> 5));
  return (w >> (c & 31)) & 1u;
}

// The mc <= CH neighbours of a row chunk into the lanes' registers, lane l
// holding positions l, l + 32, ...; (-1, -1) past mc.
__device__ __forceinline__ void load_chunk(int2 (&e)[CH / 32],
                                           const int2* __restrict__ src,
                                           int mc, int lane) {
#pragma unroll
  for (int r = 0; r < CH / 32; ++r) {
    const int j = lane + 32 * r;
    e[r] = j < mc ? __ldg(src + j) : make_int2(-1, -1);
  }
}

struct Args {
  const float* vectors;
  const int* ids;
  const int2* nbr;
  const int* entry;
  const int* gidx;
  const float* queries;
  const unsigned char* masks;
  const int* midx;
  int P, D, N, M2, V, G, Mn, Vm, K, EF, max_iter, lgs;
  bool qshared;
  unsigned* scratch;
  Entry* lscratch;
  float* out_d;
  int* out_i;
  int* steps;
  int* expanded;
  unsigned* bits_out;
  long long* prof;
};

// Four blocks an SM keep a 512-pair bucket resident at 128 registers a
// thread; the ef-list in device memory needs more, and runs at two.
template <bool IP, bool FILT, bool SBM, bool VEC, bool LG>
__global__ void __launch_bounds__(NT, LG ? 2 : 4)
beam_f32_kernel(Args a) {
  using PC = Piece<IP, VEC>;
  using T = typename PC::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, N = a.N, M2 = a.M2, EF = a.EF;
  const int KR = FILT ? a.K : 0;
  const int W = (N + 31) >> 5;
  const bool qs = !LG || a.qshared;
  const Layout L(D, EF, KR, M2, W, SBM, !LG, qs);
  int* sc = reinterpret_cast<int*>(smem);
  long long* pf = reinterpret_cast<long long*>(smem + L.prof);
  float* qsm = reinterpret_cast<float*>(smem + L.q);
  int2* vl = reinterpret_cast<int2*>(smem + L.vl);
  Entry* keys = reinterpret_cast<Entry*>(smem + L.keys);

  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const bool prof = a.prof != nullptr;
  Entry* lst = LG ? a.lscratch + size_t(p) * 2 * (EF + KR)
                  : reinterpret_cast<Entry*>(smem + L.lst);
  Entry* res = LG ? lst + 2 * EF : reinterpret_cast<Entry*>(smem + L.res);
  unsigned* bits = SBM ? reinterpret_cast<unsigned*>(smem + L.bits)
                       : a.scratch + size_t(p) * W;
  const int g = clampi(a.gidx[p], 0, a.G - 1);
  const int* gids = a.ids + size_t(g) * N;
  const int2* rows = a.nbr + size_t(g) * N * M2;
  const unsigned char* mrow =
      FILT ? a.masks + size_t(clampi(a.midx[p], 0, a.Mn - 1)) * a.Vm : nullptr;
  const float* qrow = a.queries + size_t(p) * D;
  const float* q = qs ? qsm : qrow;
  const float INF = __int_as_float(0x7f800000);
  const int nch = (M2 + CH - 1) / CH;
  const int top_ef = floor_pow2(EF);
  // gs lanes a neighbour: ngroups groups of the block
  const int lgs = a.lgs, gs = 1 << lgs, lng = 7 - lgs;
  const int sub = tid & (gs - 1), grp = tid >> lgs;
  const int C = VEC ? D >> 2 : D;
  const bool one_round = C <= gs * CPL;

  if (qs)
    for (int c = tid; c < D; c += NT) qsm[c] = qrow[c];
  for (int w = tid; w < W; w += NT) {
    if (SBM) bits[w] = 0u; else __stcg(bits + w, 0u);
  }
  for (int i = tid; i < 2 * EF; i += NT) lst[i] = Entry{INF, -2};
  for (int i = tid; i < 2 * KR; i += NT) res[i] = Entry{INF, -1};
  if (tid < PROF) pf[tid] = 0;
  __syncthreads();

  const int ent = a.entry[g];
  if (warp == 0) {
    const int gid = clampi(gids[clampi(ent, 0, N - 1)], 0, a.V - 1);
    const float d0 =
        warp_dist<IP, VEC>(a.vectors + size_t(gid) * D, q, D, lane);
    if (lane == 0) {
      lst[0] = Entry{d0, ent * 2};
      set_bit(bits, clampi(ent, 0, N - 1));
      if (FILT) {
        const bool ok = mrow[gid] != 0;
        res[0] = Entry{ok ? d0 : INF, ok ? ent : -1};
      }
      sc[S_PICK] = ent >= 0 ? 0 : EF;
      sc[S_LAST] = ent >= 0 ? 0 : -1;
    }
  }
  // the query slice each lane keeps
  T qr[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    const int c = sub + u * gs;
    qr[u] = one_round && c < C ? PC::query(q, c) : T{};
  }
  __syncthreads();

  int cur = 0, steps = 0;
  for (;;) {
    long long t0 = prof ? clock64() : 0;
    const int pick = sc[S_PICK + cur], last = sc[S_LAST + cur];
    const float best = pick < EF ? lst[cur * EF + pick].d : INF;
    const float worst = last >= 0 ? lst[cur * EF + last].d : -INF;
    if (steps >= a.max_iter || !(fabsf(best) < INF && best <= worst)) break;
    const int node = lst[cur * EF + pick].s >> 1;
    const int2* grow = rows + size_t(clampi(node, 0, N - 1)) * M2;

    for (int c = 0; c < nch; ++c) {
      const int base = c * CH;
      const int mc = min(CH, M2 - base);
      const bool last_chunk = c == nch - 1;
      const int xp = c == 0 ? pick : -1;      // the entry to mark expanded
      const int nxt = cur ^ 1;
      // 1. the row warp: the chunk's (slot, id) pairs, and its valid
      // neighbours (real, not visited as the bitmap stood before the step)
      // compacted in row order
      int2 e[CH / 32];
      if (warp == RW) {
        if (c == 0 && lane == 0 && a.expanded != nullptr)
          a.expanded[size_t(p) * a.max_iter + steps] = node;
        load_chunk(e, grow + base, mc, lane);
        int nv = 0;
#pragma unroll
        for (int r = 0; r < CH / 32; ++r) {
          if (32 * r >= mc) break;
          const bool valid =
              e[r].x >= 0 && !test_bit<SBM>(bits, clampi(e[r].x, 0, N - 1));
          const unsigned b = __ballot_sync(FULL, valid);
          if (valid)
            vl[nv + __popc(b & below)] =
                make_int2(e[r].x, clampi(e[r].y, 0, a.V - 1));
          nv += __popc(b);
        }
        if (lane == 0) {
          sc[S_NV] = nv;
          sc[S_PICK + nxt] = EF;
          sc[S_LAST + nxt] = -1;
        }
      }
      long long t1 = prof ? clock64() : 0;
      __syncthreads();
      long long t2 = prof ? clock64() : 0;

      // 2. the valid neighbours' distances: group grp takes neighbours grp,
      // grp + ngroups, ..., NB of them at once
      const int nv = sc[S_NV];
      const int npos = (nv + (1 << lng) - 1) >> lng;
      for (int i0 = 0; i0 < npos; i0 += NB) {
        const float* vp[NB];
        bool in[NB];
        unsigned char mb[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int t = grp + ((i0 + b) << lng);
          in[b] = i0 + b < npos && t < nv;
          const int gid = in[b] ? vl[t].y : 0;
          vp[b] = in[b] ? a.vectors + size_t(gid) * D : nullptr;
          mb[b] = FILT && in[b] && sub == 0 ? __ldg(mrow + gid) : 0;
        }
        float acc[NB];
        if (npos - i0 >= 2)
          group_dists<IP, VEC, 2>(acc, vp, qr, q, C, gs, sub, one_round);
        else
          group_dists<IP, VEC, 1>(acc, vp, qr, q, C, gs, sub, one_round);
        if (sub == 0) {
#pragma unroll
          for (int b = 0; b < NB; ++b)
            if (in[b])
              keys[grp + ((i0 + b) << lng)] =
                  Entry{IP ? -acc[b] : acc[b], int(FILT && mb[b] != 0)};
        }
      }
      long long t3 = prof ? clock64() : 0;
      __syncthreads();
      long long t4 = prof ? clock64() : 0;

      // 3. after the last chunk's test, the row warp sets the step's visited
      // bits: every real neighbour clipping above 0 sets its bit; bit 0 takes
      // the value of the last neighbour (real or pad) clipping to 0
      if (warp == RW && last_chunk) {
        int last0 = -1;
        if (nch == 1) {
#pragma unroll
          for (int r = 0; r < CH / 32; ++r) {
            const int j = lane + 32 * r;
            if (32 * r >= mc) break;
            const int cl = clampi(e[r].x, 0, N - 1);
            if (j < mc && cl == 0) last0 = j;
            else if (e[r].x >= 0) set_bit(bits, cl);
          }
        } else {
          for (int j = lane; j < M2; j += 32) {
            const int s = __ldg(&grow[j].x);
            const int cl = clampi(s, 0, N - 1);
            if (cl == 0) last0 = j;
            else if (s >= 0) set_bit(bits, cl);
          }
        }
        last0 = __reduce_max_sync(FULL, last0);
        if (last0 >= 0) {
          int s = 0;
          if (nch == 1) {
#pragma unroll
            for (int r = 0; r < CH / 32; ++r)
              if (r == last0 >> 5) s = __shfl_sync(FULL, e[r].x, last0 & 31);
          } else {
            s = __ldg(&grow[last0].x);
          }
          if (lane == 0 && s >= 0) set_bit(bits, 0);
        }
      }
      // and the block folds by rank into the other buffers: a list entry
      // moves by the new distances below it, a neighbour to
      // upper_bound(list, d) + its rank among the new keys (distance,
      // position)
      const Entry* lc = lst + cur * EF;
      Entry* ln = lst + nxt * EF;
      const Entry* rc = res + cur * KR;
      Entry* rn = res + nxt * KR;
      const int nlist = EF + nv, nall = nlist + (FILT ? KR + nv : 0);
      int pk = EF, ls = -1;
      for (int u = tid; u < nall; u += NT) {
        if (u < EF) {
          Entry x = lc[u];
          if (u == xp) x.s |= 1;
          int pos = u;
#pragma unroll 4
          for (int t = 0; t < nv; ++t) pos += keys[t].d < x.d;
          if (pos < EF) {
            ln[pos] = x;
            if (x.s >= 0) {
              ls = max(ls, pos);
              if (!(x.s & 1)) pk = min(pk, pos);
            }
          }
        } else if (u < nlist) {
          const int t = u - EF;
          const float d = keys[t].d;
          int pos = count_le(lc, EF, top_ef, d);
#pragma unroll 4
          for (int f = 0; f < nv; ++f) pos += key_lt(keys[f].d, f, d, t);
          if (pos < EF) {
            ln[pos] = Entry{d, vl[t].x * 2};
            ls = max(ls, pos);
            pk = min(pk, pos);
          }
        } else if (FILT) {
          const int v = u - nlist;
          if (v < KR) {
            const Entry x = rc[v];
            int pos = v;
#pragma unroll 4
            for (int t = 0; t < nv; ++t) {
              const Entry k = keys[t];
              pos += k.s && k.d < x.d;
            }
            if (pos < KR) rn[pos] = x;
          } else {
            const int t = v - KR;
            const Entry k = keys[t];
            if (k.s) {
              int pos = count_le(rc, KR, floor_pow2(KR), k.d);
#pragma unroll 4
              for (int f = 0; f < nv; ++f) {
                const Entry o = keys[f];
                pos += o.s && key_lt(o.d, f, k.d, t);
              }
              if (pos < KR) rn[pos] = Entry{k.d, vl[t].x};
            }
          }
        }
      }
      pk = __reduce_min_sync(FULL, pk);
      ls = __reduce_max_sync(FULL, ls);
      if (lane == 0) {
        if (pk < EF) atomicMin(sc + S_PICK + nxt, pk);
        if (ls >= 0) atomicMax(sc + S_LAST + nxt, ls);
      }
      long long t5 = prof ? clock64() : 0;
      __syncthreads();
      if (prof && tid == RW * 32) {
        const long long t6 = clock64();
        pf[0] += t1 - t0;
        pf[1] += t3 - t2;
        pf[2] += t5 - t4;
        pf[3] += (t2 - t1) + (t4 - t3) + (t6 - t5);
        t0 = t6;
      }
      cur = nxt;
    }
    ++steps;
  }

  // the result: the k-slot list, or the first min(k, ef) of the ef-list
  const int K = a.K, kk = K < EF ? K : EF;
  for (int j = tid; j < K; j += NT) {
    float dist = INF;
    int slot = -1;
    if (FILT) {
      dist = res[cur * KR + j].d;
      slot = res[cur * KR + j].s;
    } else if (j < kk) {
      dist = lst[cur * EF + j].d;
      slot = lst[cur * EF + j].s >> 1;
    }
    a.out_i[size_t(p) * K + j] = slot >= 0 ? gids[clampi(slot, 0, N - 1)] : -1;
    a.out_d[size_t(p) * K + j] = slot >= 0 ? dist : INF;
  }
  if (a.steps != nullptr) {
    if (tid == 0) a.steps[p] = steps;
    if (tid < PROF) a.prof[size_t(p) * PROF + tid] = pf[tid];
    int* ex = a.expanded + size_t(p) * a.max_iter;
    for (int j = steps + tid; j < a.max_iter; j += NT) ex[j] = -1;
    if (SBM)
      for (int w = tid; w < W; w += NT)
        a.bits_out[size_t(p) * W + w] = bits[w];
  }
}

template <bool IP, bool FILT, bool SBM, bool VEC, bool LG>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = beam_f32_kernel<IP, FILT, SBM, VEC, LG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<a.P, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool IP, bool FILT, bool SBM>
cudaError_t dispatch_list(bool vec, bool lg, const Args& a, size_t smem,
                          cudaStream_t st) {
  if (lg) return vec ? launch<IP, FILT, SBM, true, true>(a, smem, st)
                     : launch<IP, FILT, SBM, false, true>(a, smem, st);
  return vec ? launch<IP, FILT, SBM, true, false>(a, smem, st)
             : launch<IP, FILT, SBM, false, false>(a, smem, st);
}

template <bool IP, bool FILT>
cudaError_t dispatch_placement(bool sbm, bool vec, bool lg, const Args& a,
                               size_t smem, cudaStream_t st) {
  return sbm ? dispatch_list<IP, FILT, true>(vec, lg, a, smem, st)
             : dispatch_list<IP, FILT, false>(vec, lg, a, smem, st);
}

}  // namespace

// vectors (V, D) fp32; ids (G, N) int32; nbr (G, N, M2, 2) int32 (slot,
// global id) pairs; entry (G,) int32; gidx (P,) int32; queries (P, D) fp32;
// masks (Mn, Vm >= V) bool and midx (P,) int32, both null for the
// unfiltered beam; all contiguous on the device.  vec: D % 4 == 0 and
// vectors, queries 16-byte aligned.  smem_bitmap: the visited bitmap in shared memory, else in
// scratch (P x ceil(N / 32) uint32, cleared here); list_shared: the ef-list
// and result list in shared memory, else in lscratch (P x 2 (EF + K) x 8
// bytes; K only when filtered), and query_shared the query (list_shared
// implies it).  out_d (P, K) fp32, out_i (P, K) int32; steps (P,) int32,
// expanded (P, max_iter) int32, prof (P, 4) int64 and, with smem_bitmap,
// bits_out (P x ceil(N / 32) uint32): all or none.  1 <= K, K <= EF when
// filtered, M2 >= 1.  Returns cudaGetLastError() after the launch.
extern "C" int beam_f32(const void* vectors, const void* ids,
                        const void* nbr, const void* entry, const void* gidx,
                        const void* queries, const void* masks,
                        const void* midx, int P, int D, int N, int M2, int V,
                        int G, int Mn, int Vm, int K, int EF, int max_iter,
                        int metric_ip, int vec, int smem_bitmap,
                        int list_shared, int query_shared, void* scratch,
                        void* lscratch, void* out_d, void* out_i, void* steps,
                        void* expanded, void* prof, void* bits_out,
                        void* stream) {
  const bool filt = masks != nullptr;
  if (P <= 0 || D <= 0 || N <= 0 || V <= 0 || G <= 0 || K <= 0 || EF <= 0 ||
      M2 <= 0 ||
      (filt && (K > EF || Mn <= 0 || Vm < V || midx == nullptr)) ||
      (!smem_bitmap && scratch == nullptr) ||
      (!list_shared && lscratch == nullptr) ||
      (list_shared && !query_shared) ||
      (steps != nullptr && (expanded == nullptr || prof == nullptr ||
                            max_iter < 0 ||
                            (smem_bitmap && bits_out == nullptr))))
    return int(cudaErrorInvalidValue);
  const Layout L(D, EF, filt ? K : 0, M2, (N + 31) / 32, smem_bitmap != 0,
                 list_shared != 0, query_shared != 0);
  if (L.total > size_t(SMEM_MAX)) return int(cudaErrorInvalidValue);
  // the lanes a neighbour: the fewest (a power of two, at most 32) that
  // load its row in CPL pieces a lane
  const int pieces = ((vec ? D / 4 : D) + CPL - 1) / CPL;
  int lgs = 0;
  while (lgs < 5 && (1 << lgs) < pieces) ++lgs;
  Args a{static_cast<const float*>(vectors), static_cast<const int*>(ids),
         static_cast<const int2*>(nbr), static_cast<const int*>(entry),
         static_cast<const int*>(gidx), static_cast<const float*>(queries),
         static_cast<const unsigned char*>(masks),
         static_cast<const int*>(midx), P, D, N, M2, V, G, Mn, Vm, K, EF,
         max_iter, lgs, query_shared != 0, static_cast<unsigned*>(scratch),
         static_cast<Entry*>(lscratch), static_cast<float*>(out_d),
         static_cast<int*>(out_i), static_cast<int*>(steps),
         static_cast<int*>(expanded), static_cast<unsigned*>(bits_out),
         static_cast<long long*>(prof)};
  auto st = static_cast<cudaStream_t>(stream);
  const bool sbm = smem_bitmap != 0, v = vec != 0, lg = list_shared == 0;
  const size_t smem = L.total;
  if (metric_ip)
    return int(filt ? dispatch_placement<true, true>(sbm, v, lg, a, smem, st)
                    : dispatch_placement<true, false>(sbm, v, lg, a, smem, st));
  return int(filt ? dispatch_placement<false, true>(sbm, v, lg, a, smem, st)
                  : dispatch_placement<false, false>(sbm, v, lg, a, smem, st));
}
