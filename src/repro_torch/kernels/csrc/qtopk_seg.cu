// Kernel B: segmented SQ8 (int8) scan to the top-kq quantized distances
// (`qtopk_seg_sq8`), and its unsegmented instantiation (`qtopk_sq8`).
//
// `qtopk_seg_sq8` replaces the TPU kernel `_qtopk_seg_kernel` (src/repro/
// kernels/quant.py:162, launched by `_quantized_topk_segmented`).  Query row
// r may take flat candidate column c only when qseg[r] == cseg[c]; the
// quantized distance is
//     dot   = sum_i xq[r, i] * yq[c, i]          (exact int32)
//     cross = (float(dot) * sx[r]) * sy[c]
//     dist  = max((x2[r] + y2[c]) - 2 * cross, 0)
// rounded in exactly this association (__fmul_rn / __fadd_rn / __fsub_rn, so
// no contraction changes a rounding): given the same x2/y2/sx/sy the result
// is bit-identical to the plain PyTorch version in values and indices.
// Codes are zero-padded by the wrapper to a multiple of 16 bytes per row.
//
// `qtopk_sq8` replaces `_qtopk_kernel` (quant.py:86, launched by
// `quantized_topk`, reached from `topk_sq8_rerank`): the same pass with SEG =
// false, which reads no owners and folds every column below N, bit-equal to
// its plain version `sq8_dense` in the same way.
//
// What bounds it: at the segmented main-path shape (Qp = 128, N = 2,097,152,
// d = 128) the int8 codes are 0.27 GB plus 8 bytes of (sy, y2) and 4 of cseg
// per row, about 0.08 ms at 3.35 TB/s; unsegmented at N = 1,048,576 the 143 MB
// of codes and scalars take 0.043 ms.  The all-pairs int8 products are
// 2·Q·N·d = 34-69 G integer operations, which __dp4a on CUDA cores issues at a
// small fraction of the tensor cores' int8 rate.  So the bound is bytes, but
// this simple kernel is held back by its operations; int8 tensor-core
// products (mma / wgmma) and skipping tiles whose owner ranges do not meet
// are left for a later change.
//
// Design: the same split-N pass as kernel A (topk_seg.cu) with the d-chunks
// staged as packed 4-byte words and reduced with __dp4a, then the same merge.
#include "topk_common.cuh"

namespace {

template <bool SEG>
__global__ void __launch_bounds__(NT)
qtopk_seg_pass(const int* __restrict__ xw, const int* __restrict__ yw,
               const float* __restrict__ sx, const float* __restrict__ x2,
               const float* __restrict__ sy, const float* __restrict__ y2,
               const int* __restrict__ qseg, const int* __restrict__ cseg,
               int Q, int N, int W, int kp, int bq, int bn,
               int tiles_per_split, int S,
               unsigned long long* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(smem);
  int* xs = reinterpret_cast<int*>(lists + bq * kp);  // [CW][bq + 1]
  int* ys = xs + CW * (bq + 1);                        // [CW][bn + 1]
  float* dist = reinterpret_cast<float*>(ys + CW * (bn + 1));  // [bq][bn+1]
  float* sxs = dist + bq * (bn + 1);                   // [bq]
  float* x2s = sxs + bq;                               // [bq]
  float* sys = x2s + bq;                               // [bn]
  float* y2s = sys + bn;                               // [bn]
  int* qs = reinterpret_cast<int*>(y2s + bn);          // [bq]
  int* cs = qs + bq;                                   // [bn]

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
    sxs[r] = g < Q ? sx[g] : 0.f;
    x2s[r] = g < Q ? x2[g] : 0.f;
    qs[r] = (SEG && g < Q) ? qseg[g] : 0;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * bn;
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int w0 = 0; w0 < W; w0 += CW) {
      __syncthreads();  // the previous chunk (or tile fold) is done
      for (int e = tid; e < CW * bq; e += NT) {
        const int r = e / CW, w = e % CW, g = row0 + r, d = w0 + w;
        xs[w * (bq + 1) + r] = (g < Q && d < W) ? xw[size_t(g) * W + d] : 0;
      }
      for (int e = tid; e < CW * bn; e += NT) {
        const int c = e / CW, w = e % CW, g = col0 + c, d = w0 + w;
        ys[w * (bn + 1) + c] = (g < N && d < W) ? yw[size_t(g) * W + d] : 0;
      }
      __syncthreads();
      for (int w = 0; w < CW; ++w) {
        int a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = i < mq ? xs[w * (bq + 1) + ty + TILE * i] : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = j < mn ? ys[w * (bn + 1) + tx + TILE * j] : 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
    }
    if (tid < bn) {
      const int g = col0 + tid;
      sys[tid] = g < N ? sy[g] : 0.f;
      y2s[tid] = g < N ? y2[g] : 0.f;
      if (SEG) cs[tid] = g < N ? cseg[g] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i < mq && j < mn) {
          const int r = ty + TILE * i, c = tx + TILE * j;
          const float cross = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[i][j]), sxs[r]), sys[c]);
          const float d = __fsub_rn(__fadd_rn(x2s[r], y2s[c]),
                                    __fmul_rn(2.f, cross));
          dist[r * (bn + 1) + c] = fmaxf(d, 0.f);
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

// The split-N pass, then the merge.
template <bool SEG>
int run_qtopk(const void* xq, const void* yq, const void* sx, const void* x2,
              const void* sy, const void* y2, const void* qseg,
              const void* cseg, int Q, int N, int Dp, int kp, int bq, int bn,
              int S, void* partial, void* out_v, void* out_i, void* stream) {
  if (!scan_shape_ok(Q, N, kp, bq, bn, S) || Dp <= 0 || Dp % 16 != 0 ||
      S > 65535)
    return int(cudaErrorInvalidValue);
  auto* part = static_cast<unsigned long long*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = scan_smem_bytes(bq, bn, kp);
  cudaError_t err = cudaFuncSetAttribute(
      qtopk_seg_pass<SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const int n_tiles = (N + bn - 1) / bn;
  const int tiles_per_split = (n_tiles + S - 1) / S;
  const dim3 grid((Q + bq - 1) / bq, S);
  qtopk_seg_pass<SEG><<<grid, NT, smem, st>>>(
      static_cast<const int*>(xq), static_cast<const int*>(yq),
      static_cast<const float*>(sx), static_cast<const float*>(x2),
      static_cast<const float*>(sy), static_cast<const float*>(y2),
      static_cast<const int*>(qseg), static_cast<const int*>(cseg), Q, N,
      Dp / 4, kp, bq, bn, tiles_per_split, S, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return int(launch_merge(part, Q, S, kp, static_cast<float*>(out_v),
                          static_cast<int*>(out_i), st));
}

}  // namespace

// xq (Q, Dp) and yq (N, Dp) int8 with Dp a multiple of 16; sx, x2 (Q,) and
// sy, y2 (N,) fp32; qseg (Q,) and cseg (N,) int32, all contiguous on the
// device; partial: Q * S * kp 64-bit scratch; out_v (Q, kp) fp32, out_i
// (Q, kp) int32.  Returns cudaGetLastError() after the launches.
extern "C" int qtopk_seg_sq8(const void* xq, const void* yq, const void* sx,
                             const void* x2, const void* sy, const void* y2,
                             const void* qseg, const void* cseg, int Q, int N,
                             int Dp, int kp, int bq, int bn, int S,
                             void* partial, void* out_v, void* out_i,
                             void* stream) {
  return run_qtopk<true>(xq, yq, sx, x2, sy, y2, qseg, cseg, Q, N, Dp, kp, bq,
                         bn, S, partial, out_v, out_i, stream);
}

// The same without owners: every column of yq is a candidate of every row.
extern "C" int qtopk_sq8(const void* xq, const void* yq, const void* sx,
                         const void* x2, const void* sy, const void* y2, int Q,
                         int N, int Dp, int kp, int bq, int bn, int S,
                         void* partial, void* out_v, void* out_i,
                         void* stream) {
  return run_qtopk<false>(xq, yq, sx, x2, sy, y2, nullptr, nullptr, Q, N, Dp,
                          kp, bq, bn, S, partial, out_v, out_i, stream);
}
