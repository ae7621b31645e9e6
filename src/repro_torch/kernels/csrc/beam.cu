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
// pair p: graph g = gidx[p], ids (G, N) local slot -> global id, level0
// (G, N, M2) neighbour slots (-1 padded), entry (G,).  The ef-list starts as
// [(d(entry), entry)]; each step
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
// nothing outside them (the plain version raises on it instead).
//
// What bounds it: latency, far above bytes.  A pair reads the vectors, ids
// (and mask bytes) of the nodes it visits and the level0 rows of the nodes it
// expands: at the chip_smoke.py `beam` phase's shape a few hundred rows of
// 512 bytes a pair, most of them shared by the pairs of one graph, so under
// a microsecond of device memory rate for the whole bucket.  But each step
// depends on the last: level0 row -> visited test and ids -> vectors -> fold
// -> next pick, three dependent loads from device memory and three block
// barriers a step, some tens to hundreds of steps a pair.  So the time is
// the longest pair's steps times one step's latency, and the design keeps
// each step short and many pairs in flight:
//   - one block of 128 threads a pair; the query, the ef-list (distance,
//     slot, expanded flag; double-buffered), the k-slot result list and the
//     step's neighbours live in shared memory;
//   - the visited bitmap (ceil(N / 32) words) is in shared memory when it
//     fits the budget that the wrapper computes (two blocks an SM), else in a
//     global scratch of the wrapper's, which each block clears for its own
//     pair and reads through L2 (ld.global.cg: the atomics that set it live
//     there);
//   - warp 0 loads the expanded node's neighbour row, tests and sets the
//     bitmap and compacts the valid neighbours in order (ballots); the four
//     warps then take one valid neighbour at a time, lanes striding over d in
//     float4 (scalar loads when d % 4 != 0 or a base is misaligned), and
//     reduce with shuffles;
//   - the fold is by rank, with no sort network: the list is sorted, so a
//     list entry i moves to i + #{neighbours with d < d_i}, and neighbour t
//     to #{list entries with d <= d_t} (a binary search) + #{valid
//     neighbours before it in (d, position) order}.  Ties go to the lower
//     position exactly as in `lax.top_k`, and neighbours repeated in one row
//     both enter.  The writes of the fold also leave the next step's pick
//     (first unexpanded position) and the list's last valid position in two
//     shared atomics, so the stop test costs no reduction.
// `steps`, `expanded` and `bits_out` (optional, together) receive each
// pair's step count, the slot it expanded at each step (-1 after the last)
// and its visited bitmap (copied out of shared memory; the global scratch is
// the bitmap itself), for the bound.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NT = 128;         // threads a block
constexpr int NW = NT / 32;     // warps a block
constexpr int EF_MAX = 1024;
constexpr int M2_MAX = 128;     // 4 neighbours a lane of warp 0
constexpr int SMEM_MAX = 232448;

__host__ __device__ inline size_t round16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Byte offsets of the shared-memory sections; mirrors hnsw_torch's
// `_beam_smem_bytes`.
struct Layout {
  size_t q, cd, cs, rd, rs, vnd, vnb, vgid, ex, vkeep, bits, total;
  __host__ __device__ Layout(int D, int EF, int KR, int M2, int W, bool sbm) {
    q = 16;                                        // 4 int scalars first
    cd = round16(q + size_t(D) * 4);
    cs = cd + size_t(2) * EF * 4;
    rd = cs + size_t(2) * EF * 4;
    rs = rd + size_t(2) * KR * 4;
    vnd = round16(rs + size_t(2) * KR * 4);
    vnb = vnd + size_t(M2) * 4;
    vgid = vnb + size_t(M2) * 4;
    ex = vgid + size_t(M2) * 4;
    vkeep = ex + size_t(2) * EF;
    bits = round16(vkeep + size_t(M2));
    total = bits + (sbm ? size_t(W) * 4 : 0);
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Distance of one row to the staged query, by one warp; every lane returns it.
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
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return IP ? -acc : acc;
}

template <bool SBM>
__device__ __forceinline__ bool test_bit(const unsigned* bits, int c) {
  const unsigned w = SBM ? bits[c >> 5] : __ldcg(bits + (c >> 5));
  return (w >> (c & 31)) & 1u;
}

// Number of the n sorted values of a that are <= x.
__device__ __forceinline__ int upper_bound(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct Args {
  const float* vectors;
  const int* ids;
  const int* level0;
  const int* entry;
  const int* gidx;
  const float* queries;
  const unsigned char* masks;
  const int* midx;
  int P, D, N, M2, V, G, Mn, Vm, K, EF, max_iter;
  unsigned* scratch;
  float* out_d;
  int* out_i;
  int* steps;
  int* expanded;
  unsigned* bits_out;
};

template <bool IP, bool FILT, bool SBM, bool VEC>
__global__ void __launch_bounds__(NT)
beam_f32_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, N = a.N, M2 = a.M2, EF = a.EF;
  const int KR = FILT ? a.K : 0;
  const int W = (N + 31) >> 5;
  const Layout L(D, EF, KR, M2, W, SBM);
  // nv, first unexpanded slot, last valid slot
  int* sc = reinterpret_cast<int*>(smem);
  float* q = reinterpret_cast<float*>(smem + L.q);
  float* cd = reinterpret_cast<float*>(smem + L.cd);
  int* cs = reinterpret_cast<int*>(smem + L.cs);
  float* rd = reinterpret_cast<float*>(smem + L.rd);
  int* rs = reinterpret_cast<int*>(smem + L.rs);
  float* vnd = reinterpret_cast<float*>(smem + L.vnd);
  int* vnb = reinterpret_cast<int*>(smem + L.vnb);
  int* vgid = reinterpret_cast<int*>(smem + L.vgid);
  unsigned char* ex = smem + L.ex;
  unsigned char* vkeep = smem + L.vkeep;

  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* bits = SBM ? reinterpret_cast<unsigned*>(smem + L.bits)
                       : a.scratch + size_t(p) * W;
  const int g = clampi(a.gidx[p], 0, a.G - 1);
  const int* gids = a.ids + size_t(g) * N;
  const int* lvl = a.level0 + size_t(g) * N * M2;
  const unsigned char* mrow =
      FILT ? a.masks + size_t(clampi(a.midx[p], 0, a.Mn - 1)) * a.Vm : nullptr;
  const float* qrow = a.queries + size_t(p) * D;
  const float INF = __int_as_float(0x7f800000);

  for (int c = tid; c < D; c += NT) q[c] = qrow[c];
  for (int w = tid; w < W; w += NT) {
    if (SBM) bits[w] = 0u; else __stcg(bits + w, 0u);
  }
  for (int i = tid; i < 2 * EF; i += NT) {
    cd[i] = INF;
    cs[i] = -1;
    ex[i] = 0;
  }
  for (int i = tid; i < 2 * KR; i += NT) { rd[i] = INF; rs[i] = -1; }
  __syncthreads();

  const int ent = a.entry[g];
  if (warp == 0) {
    const int gid = clampi(gids[clampi(ent, 0, N - 1)], 0, a.V - 1);
    const float d0 =
        warp_dist<IP, VEC>(a.vectors + size_t(gid) * D, q, D, lane);
    if (lane == 0) {
      cd[0] = d0;
      cs[0] = ent;
      const int c = clampi(ent, 0, N - 1);
      atomicOr(bits + (c >> 5), 1u << (c & 31));
      if (FILT) {
        const bool ok = mrow[gid] != 0;
        rd[0] = ok ? d0 : INF;
        rs[0] = ok ? ent : -1;
      }
      sc[1] = ent >= 0 ? 0 : EF;
      sc[2] = ent >= 0 ? 0 : -1;
    }
  }
  __syncthreads();

  int cur = 0, steps = 0;
  for (;;) {
    const int pick = sc[1], last = sc[2];
    const float* cdc = cd + cur * EF;
    const float best = pick < EF ? cdc[pick] : INF;
    const float worst = last >= 0 ? cdc[last] : -INF;
    if (steps >= a.max_iter || !(fabsf(best) < INF && best <= worst)) break;
    const int nxt = cur ^ 1;

    // 1. warp 0: the neighbour row, the visited bitmap, the valid list
    if (warp == 0) {
      const int node = cs[cur * EF + pick];
      if (lane == 0) {
        ex[cur * EF + pick] = 1;
        if (a.expanded != nullptr)
          a.expanded[size_t(p) * a.max_iter + steps] = node;
      }
      const int* row = lvl + size_t(clampi(node, 0, N - 1)) * M2;
      int nb[4], cl[4], gid[4];
      bool seen[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = lane + 32 * r;
        nb[r] = j < M2 ? __ldg(row + j) : -1;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = lane + 32 * r;
        cl[r] = clampi(nb[r], 0, N - 1);
        const bool real = j < M2 && nb[r] >= 0;
        seen[r] = real && test_bit<SBM>(bits, cl[r]);
        gid[r] = real ? __ldg(gids + cl[r]) : 0;
      }
      __syncwarp();
      // visited: every real neighbour clipping above 0 sets its bit; bit 0
      // takes the value of the last neighbour (real or pad) clipping to 0
      int last0 = -1;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = lane + 32 * r;
        const unsigned b = __ballot_sync(0xffffffffu, j < M2 && cl[r] == 0);
        if (b) last0 = 32 * r + 31 - __clz(b);
        if (j < M2 && nb[r] >= 0 && cl[r] != 0) {
          atomicOr(bits + (cl[r] >> 5), 1u << (cl[r] & 31));
        }
      }
      if (last0 >= 0 && lane == (last0 & 31)) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r == (last0 >> 5) && nb[r] >= 0) atomicOr(bits, 1u);
      }
      // the valid neighbours, compacted in row order
      int nv = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = lane + 32 * r;
        const bool valid = j < M2 && nb[r] >= 0 && !seen[r];
        const unsigned b = __ballot_sync(0xffffffffu, valid);
        if (valid) {
          const int t = nv + __popc(b & ((1u << lane) - 1u));
          vnb[t] = nb[r];
          vgid[t] = clampi(gid[r], 0, a.V - 1);
        }
        nv += __popc(b);
      }
      if (lane == 0) sc[0] = nv;
    }
    __syncthreads();

    // 2. the valid neighbours' distances (and mask bits), a warp each
    const int nv = sc[0];
    if (tid == 0) { sc[1] = EF; sc[2] = -1; }
    for (int t = warp; t < nv; t += NW) {
      const int gid = vgid[t];
      const float dist =
          warp_dist<IP, VEC>(a.vectors + size_t(gid) * D, q, D, lane);
      if (lane == 0) {
        vnd[t] = dist;
        if (FILT) vkeep[t] = mrow[gid] != 0;
      }
    }
    __syncthreads();

    // 3. fold by rank into the other buffer
    const int* csc = cs + cur * EF;
    const unsigned char* exc = ex + cur * EF;
    float* cdn = cd + nxt * EF;
    int* csn = cs + nxt * EF;
    unsigned char* exn = ex + nxt * EF;
    for (int u = tid; u < EF + nv; u += NT) {
      float dist;
      int slot, pos;
      bool done;
      if (u < EF) {
        dist = cdc[u];
        slot = csc[u];
        done = exc[u] != 0;
        int c = 0;
        for (int t = 0; t < nv; ++t) c += vnd[t] < dist;
        pos = u + c;
      } else {
        const int t = u - EF;
        dist = vnd[t];
        slot = vnb[t];
        done = false;
        int r = 0;
        for (int s = 0; s < nv; ++s) {
          const float o = vnd[s];
          r += o < dist || (o == dist && s < t);
        }
        pos = upper_bound(cdc, EF, dist) + r;
      }
      if (pos < EF) {
        cdn[pos] = dist;
        csn[pos] = slot;
        exn[pos] = done;
        if (slot >= 0) {
          atomicMax(sc + 2, pos);
          if (!done) atomicMin(sc + 1, pos);
        }
      }
    }
    if (FILT) {
      const float* rdc = rd + cur * KR;
      const int* rsc = rs + cur * KR;
      float* rdn = rd + nxt * KR;
      int* rsn = rs + nxt * KR;
      for (int u = tid; u < KR + nv; u += NT) {
        float dist;
        int slot, pos;
        if (u < KR) {
          dist = rdc[u];
          slot = rsc[u];
          int c = 0;
          for (int t = 0; t < nv; ++t) c += vkeep[t] && vnd[t] < dist;
          pos = u + c;
        } else {
          const int t = u - KR;
          if (!vkeep[t]) continue;
          dist = vnd[t];
          slot = vnb[t];
          int r = 0;
          for (int s = 0; s < nv; ++s) {
            const float o = vnd[s];
            r += vkeep[s] && (o < dist || (o == dist && s < t));
          }
          pos = upper_bound(rdc, KR, dist) + r;
        }
        if (pos < KR) {
          rdn[pos] = dist;
          rsn[pos] = slot;
        }
      }
    }
    __syncthreads();
    cur = nxt;
    ++steps;
  }

  // the result: the k-slot list, or the first min(k, ef) of the ef-list
  const int K = a.K, kk = K < EF ? K : EF;
  for (int j = tid; j < K; j += NT) {
    float dist = INF;
    int slot = -1;
    if (FILT) {
      dist = rd[cur * KR + j];
      slot = rs[cur * KR + j];
    } else if (j < kk) {
      dist = cd[cur * EF + j];
      slot = cs[cur * EF + j];
    }
    a.out_i[size_t(p) * K + j] = slot >= 0 ? gids[clampi(slot, 0, N - 1)] : -1;
    a.out_d[size_t(p) * K + j] = slot >= 0 ? dist : INF;
  }
  if (a.steps != nullptr) {
    if (tid == 0) a.steps[p] = steps;
    int* e = a.expanded + size_t(p) * a.max_iter;
    for (int j = steps + tid; j < a.max_iter; j += NT) e[j] = -1;
    if (SBM)
      for (int w = tid; w < W; w += NT)
        a.bits_out[size_t(p) * W + w] = bits[w];
  }
}

template <bool IP, bool FILT, bool SBM, bool VEC>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = beam_f32_kernel<IP, FILT, SBM, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<a.P, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool IP, bool FILT>
cudaError_t dispatch_placement(bool sbm, bool vec, const Args& a, size_t smem,
                               cudaStream_t st) {
  if (sbm) return vec ? launch<IP, FILT, true, true>(a, smem, st)
                      : launch<IP, FILT, true, false>(a, smem, st);
  return vec ? launch<IP, FILT, false, true>(a, smem, st)
             : launch<IP, FILT, false, false>(a, smem, st);
}

}  // namespace

// vectors (V, D) fp32; ids (G, N) int32; level0 (G, N, M2) int32; entry (G,)
// int32; gidx (P,) int32; queries (P, D) fp32; masks (Mn, Vm >= V) bool and
// midx (P,) int32, both null for the unfiltered beam; all contiguous on the
// device.  vec: D % 4 == 0 and vectors, queries 16-byte aligned.
// smem_bitmap: the visited bitmap in shared memory, else in scratch (P x
// ceil(N / 32) uint32, cleared here).  out_d (P, K) fp32, out_i (P, K) int32;
// steps (P,) int32, expanded (P, max_iter) int32 and, with smem_bitmap,
// bits_out (P x ceil(N / 32) uint32): all three or none.  1 <= K, K <= EF
// when filtered, EF <= 1024, 1 <= M2 <= 128.  Returns cudaGetLastError()
// after the launch.
extern "C" int beam_f32(const void* vectors, const void* ids,
                        const void* level0, const void* entry,
                        const void* gidx, const void* queries,
                        const void* masks, const void* midx, int P, int D,
                        int N, int M2, int V, int G, int Mn, int Vm, int K,
                        int EF, int max_iter, int metric_ip, int vec,
                        int smem_bitmap, void* scratch, void* out_d,
                        void* out_i, void* steps, void* expanded,
                        void* bits_out, void* stream) {
  const bool filt = masks != nullptr;
  if (P <= 0 || D <= 0 || N <= 0 || V <= 0 || G <= 0 || K <= 0 || EF <= 0 ||
      EF > EF_MAX || M2 <= 0 || M2 > M2_MAX || (filt && (K > EF || Mn <= 0 ||
      Vm < V || midx == nullptr)) || (!smem_bitmap && scratch == nullptr) ||
      (steps != nullptr && (expanded == nullptr || max_iter < 0 ||
                            (smem_bitmap && bits_out == nullptr))))
    return int(cudaErrorInvalidValue);
  const Layout L(D, EF, filt ? K : 0, M2, (N + 31) / 32, smem_bitmap != 0);
  if (L.total > size_t(SMEM_MAX)) return int(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(vectors), static_cast<const int*>(ids),
         static_cast<const int*>(level0), static_cast<const int*>(entry),
         static_cast<const int*>(gidx), static_cast<const float*>(queries),
         static_cast<const unsigned char*>(masks),
         static_cast<const int*>(midx), P, D, N, M2, V, G, Mn, Vm, K, EF,
         max_iter, static_cast<unsigned*>(scratch),
         static_cast<float*>(out_d), static_cast<int*>(out_i),
         static_cast<int*>(steps), static_cast<int*>(expanded),
         static_cast<unsigned*>(bits_out)};
  auto st = static_cast<cudaStream_t>(stream);
  const bool sbm = smem_bitmap != 0, v = vec != 0;
  if (metric_ip)
    return int(filt ? dispatch_placement<true, true>(sbm, v, a, L.total, st)
                    : dispatch_placement<true, false>(sbm, v, a, L.total, st));
  return int(filt ? dispatch_placement<false, true>(sbm, v, a, L.total, st)
                  : dispatch_placement<false, false>(sbm, v, a, L.total, st));
}
