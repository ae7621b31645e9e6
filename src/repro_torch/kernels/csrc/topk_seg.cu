// Kernel A: segmented exact fp32 top-k (`topk_seg_f32`), and its
// unsegmented instantiation (`topk_f32`).
//
// `topk_seg_f32` replaces the TPU kernel `_topk_seg_kernel` (src/repro/
// kernels/distance_topk.py:97, launched by `_seg_pallas_call`).  Query row r
// may take flat candidate column c only when qseg[r] == cseg[c]; the distance
// is the GEMM form max(|x|^2 + |y|^2 - 2 x.y, 0) for "l2" and -x.y for "ip",
// with true fp32 FMAs (accum "f32") or operands rounded to bf16 and fp32
// accumulation (accum "bf16").  Output: (Q, kp) ascending distances and flat
// column indices, (+inf, -1) where fewer than kp columns match.
//
// `topk_f32` replaces `_topk_kernel` (distance_topk.py:62, launched by
// `distance_topk`, reached from `ops.topk`): the same pass with SEG = false,
// which reads no owners and folds every column below N.  Columns >= N never
// enter the fold, so the caller pads nothing.
//
// What bounds it: at the segmented main-path shape (Qp = 128, N = 2,097,152,
// d = 128) the all-pairs products are 2·Qp·N·d = 69 GFLOP of fp32 FMA on CUDA
// cores (67 TFLOP/s peak), about 1 ms.  Only 3.5 % of the pairs have matching
// owners (PERF.md §4), so the work the data needs (query rows, live candidate
// rows, products of matched pairs) is bound by bytes at 0.186 ms (PERF.md
// §6); this kernel still computes every pair.  Unsegmented, every pair is
// live: at Q = 128, N = 1,048,576, d = 128 the 34.4 GFLOP take 0.51 ms at the
// fp32 peak against 0.16 ms for the 0.54 GB of rows, so `topk_f32` is bound
// by operations.  Skipping tiles whose owner ranges do not meet, and
// tensor-core products, are left for a later change.
//
// Design: the TPU kernel carries a running top-k across the sequential N grid
// axis.  Hopper runs blocks in no order, so this is a split-N pass.  Grid
// (ceil(Q / bq), S): each block loads one bq-row query tile and walks its
// N-split in bn-column tiles; for each tile it computes the bq x bn distances
// in 32-word d-chunks staged through shared memory (each of the 256 threads
// owns a (bq/16) x (bn/16) register tile, strided by 16 so shared loads are
// conflict-free), then each warp folds its rows' distances into per-row
// sorted lists of 64-bit (distance, column) keys in shared memory
// (topk_common.cuh).  The block writes its sorted partial lists to scratch;
// `merge_partials` folds the S lists of each row.
#include "topk_common.cuh"

namespace {

template <bool SEG, bool L2, bool BF16>
__global__ void __launch_bounds__(NT)
topk_seg_pass(const float* __restrict__ x, const float* __restrict__ y,
              const int* __restrict__ qseg, const int* __restrict__ cseg,
              int Q, int N, int D, int kp, int bq, int bn, int tiles_per_split,
              int S, unsigned long long* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(smem);
  float* xs = reinterpret_cast<float*>(lists + bq * kp);  // [CW][bq + 1]
  float* ys = xs + CW * (bq + 1);                          // [CW][bn + 1]
  float* dist = ys + CW * (bn + 1);                        // [bq][bn + 1]
  float* x2s = dist + bq * (bn + 1);                       // [bq]
  float* y2s = x2s + bq;                                   // [bn]
  int* qs = reinterpret_cast<int*>(y2s + bn);              // [bq]
  int* cs = qs + bq;                                       // [bn]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % TILE, ty = tid / TILE;
  const int mq = bq / TILE, mn = bn / TILE;
  const int row0 = blockIdx.x * bq;
  const int n_tiles = (N + bn - 1) / bn;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int rows_per_warp = bq / 8;

  for (int i = tid; i < bq * kp; i += NT) lists[i] = KEY_MASKED;
  for (int r = tid; r < bq; r += NT) {
    const int g = row0 + r;
    float s = 0.f;
    if (L2 && g < Q) {
      for (int d = 0; d < D; ++d) {
        const float v = operand<BF16>(x[size_t(g) * D + d]);
        s = fmaf(v, v, s);
      }
    }
    x2s[r] = s;
    qs[r] = (SEG && g < Q) ? qseg[g] : 0;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * bn;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float y2 = 0.f;
    for (int d0 = 0; d0 < D; d0 += CW) {
      __syncthreads();  // the previous chunk (or tile fold) is done
      for (int e = tid; e < CW * bq; e += NT) {
        const int r = e / CW, w = e % CW, g = row0 + r, d = d0 + w;
        xs[w * (bq + 1) + r] =
            (g < Q && d < D) ? operand<BF16>(x[size_t(g) * D + d]) : 0.f;
      }
      for (int e = tid; e < CW * bn; e += NT) {
        const int c = e / CW, w = e % CW, g = col0 + c, d = d0 + w;
        ys[w * (bn + 1) + c] =
            (g < N && d < D) ? operand<BF16>(y[size_t(g) * D + d]) : 0.f;
      }
      __syncthreads();
      if (L2 && tid < bn) {
        for (int w = 0; w < CW; ++w) {
          const float v = ys[w * (bn + 1) + tid];
          y2 = fmaf(v, v, y2);
        }
      }
      for (int w = 0; w < CW; ++w) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = i < mq ? xs[w * (bq + 1) + ty + TILE * i] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = j < mn ? ys[w * (bn + 1) + tx + TILE * j] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (tid < bn) {
      y2s[tid] = y2;
      if (SEG) cs[tid] = col0 + tid < N ? cseg[col0 + tid] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i < mq && j < mn) {
          const int r = ty + TILE * i, c = tx + TILE * j;
          dist[r * (bn + 1) + c] =
              L2 ? fmaxf(x2s[r] + y2s[c] - 2.f * acc[i][j], 0.f) : -acc[i][j];
        }
      }
    }
    __syncthreads();
    for (int rr = 0; rr < rows_per_warp; ++rr) {
      const int r = warp * rows_per_warp + rr;
      if (row0 + r >= Q) break;  // warp-uniform
      const int q = qs[r];
      unsigned long long* L = lists + r * kp;
      for (int c0 = 0; c0 < bn; c0 += 32) {
        const int c = c0 + lane, col = col0 + c;
        unsigned long long key = KEY_MASKED;
        if (c < bn && col < N && (!SEG || cs[c] == q))
          key = make_key(dist[r * (bn + 1) + c], col);
        warp_fold(L, kp, key, lane);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < bq * kp; e += NT) {
    const int r = e / kp, i = e % kp, g = row0 + r;
    if (g < Q) partial[(size_t(g) * S + blockIdx.y) * kp + i] = lists[e];
  }
}

template <bool SEG, bool L2, bool BF16>
cudaError_t launch_pass(const float* x, const float* y, const int* qseg,
                        const int* cseg, int Q, int N, int D, int kp, int bq,
                        int bn, int S, unsigned long long* partial,
                        cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(bq, bn, kp);
  cudaError_t err = cudaFuncSetAttribute(
      topk_seg_pass<SEG, L2, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + bn - 1) / bn;
  const int tiles_per_split = (n_tiles + S - 1) / S;
  const dim3 grid((Q + bq - 1) / bq, S);
  topk_seg_pass<SEG, L2, BF16><<<grid, NT, smem, stream>>>(
      x, y, qseg, cseg, Q, N, D, kp, bq, bn, tiles_per_split, S, partial);
  return cudaGetLastError();
}

// The split-N pass for one (metric, operand type), then the merge.
template <bool SEG>
int run_topk(const void* x, const void* y, const void* qseg, const void* cseg,
             int Q, int N, int D, int kp, int metric_ip, int bf16, int bq,
             int bn, int S, void* partial, void* out_v, void* out_i,
             void* stream) {
  if (!scan_shape_ok(Q, N, kp, bq, bn, S) || D <= 0 || S > 65535)
    return int(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  const auto* qs = static_cast<const int*>(qseg);
  const auto* cs = static_cast<const int*>(cseg);
  auto* part = static_cast<unsigned long long*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (metric_ip)
    err = bf16 ? launch_pass<SEG, false, true>(xf, yf, qs, cs, Q, N, D, kp,
                                               bq, bn, S, part, st)
               : launch_pass<SEG, false, false>(xf, yf, qs, cs, Q, N, D, kp,
                                                bq, bn, S, part, st);
  else
    err = bf16 ? launch_pass<SEG, true, true>(xf, yf, qs, cs, Q, N, D, kp,
                                              bq, bn, S, part, st)
               : launch_pass<SEG, true, false>(xf, yf, qs, cs, Q, N, D, kp,
                                               bq, bn, S, part, st);
  if (err != cudaSuccess) return int(err);
  return int(launch_merge(part, Q, S, kp, static_cast<float*>(out_v),
                          static_cast<int*>(out_i), st));
}

}  // namespace

// x (Q, D) fp32, y (N, D) fp32, qseg (Q,) and cseg (N,) int32, all
// contiguous on the device; partial: Q * S * kp 64-bit scratch; out_v (Q, kp)
// fp32, out_i (Q, kp) int32.  Returns cudaGetLastError() after the launches.
extern "C" int topk_seg_f32(const void* x, const void* y, const void* qseg,
                            const void* cseg, int Q, int N, int D, int kp,
                            int metric_ip, int bf16, int bq, int bn, int S,
                            void* partial, void* out_v, void* out_i,
                            void* stream) {
  return run_topk<true>(x, y, qseg, cseg, Q, N, D, kp, metric_ip, bf16, bq,
                        bn, S, partial, out_v, out_i, stream);
}

// The same without owners: every column of y is a candidate of every row.
extern "C" int topk_f32(const void* x, const void* y, int Q, int N, int D,
                        int kp, int metric_ip, int bf16, int bq, int bn, int S,
                        void* partial, void* out_v, void* out_i,
                        void* stream) {
  return run_topk<false>(x, y, nullptr, nullptr, Q, N, D, kp, metric_ip, bf16,
                         bq, bn, S, partial, out_v, out_i, stream);
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
