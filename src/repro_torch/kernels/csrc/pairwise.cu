// Kernel C: dense pairwise distance matrix (`pairwise_f32`).
//
// Replaces the TPU kernel `_pairwise_kernel` (src/repro/kernels/pairwise.py:
// 28, launched by `pairwise_distance`, reached from `ops.pairwise_sqdist`).
// out[r, c] is the GEMM-form distance of `_dist_tile`: max(|x_r|^2 + |y_c|^2
// - 2 x_r.y_c, 0) for "l2" and -x_r.y_c for "ip", with true fp32 FMAs (accum
// "f32") or operands rounded to bf16 and fp32 accumulation (accum "bf16"; the
// norms then come from the rounded operands, as `_dist_tile` computes them).
// Ragged Q and N are masked here, so the caller pads nothing.
//
// What bounds it: at Q = 128, N = 1,048,576, d = 128 the products are
// 2·Q·N·d = 34.4 GFLOP of fp32 FMA, 0.51 ms at the 67 TFLOP/s CUDA-core peak;
// the bytes are the 0.54 GB of y, the queries and the 0.54 GB (Q·N·4) of
// output, 1.07 GB or 0.32 ms at 3.35 TB/s.  So it is bound by operations,
// and the output is the larger half of its bytes: every tile is staged in
// shared memory and written row by row, so that a warp stores 32 contiguous
// columns of one row (128 bytes) instead of the 16-strided columns of the
// register tile.  Tensor-core products are left for a later change.
//
// Design: grid (ceil(N / bn), ceil(Q / bq)), one bq x bn output tile per
// block; the same 256-thread 16x16 register tiling and 32-word d-chunks
// staged through shared memory as kernels A and B (topk_seg.cu).  Threads
// 0..bq-1 and 128..128+bn-1 accumulate the row and column norms from the
// staged chunks, so each operand is read from device memory once per block.
#include "topk_common.cuh"

namespace {

constexpr int NORM_Y0 = NT / 2;  // first thread that sums a column norm

template <bool L2, bool BF16>
__global__ void __launch_bounds__(NT)
pairwise_pass(const float* __restrict__ x, const float* __restrict__ y,
              int Q, int N, int D, int bq, int bn, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [CW][bq + 1]
  float* ys = xs + CW * (bq + 1);             // [CW][bn + 1]
  float* dist = ys + CW * (bn + 1);           // [bq][bn + 1]
  float* x2s = dist + bq * (bn + 1);          // [bq]
  float* y2s = x2s + bq;                      // [bn]

  const int tid = threadIdx.x;
  const int tx = tid % TILE, ty = tid / TILE;
  const int mq = bq / TILE, mn = bn / TILE;
  const int col0 = blockIdx.x * bn;
  const int row0 = blockIdx.y * bq;
  const bool x_norm = L2 && tid < bq;
  const bool y_norm = L2 && tid >= NORM_Y0 && tid < NORM_Y0 + bn;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float norm = 0.f;
  for (int d0 = 0; d0 < D; d0 += CW) {
    __syncthreads();  // the previous chunk is done
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
    if (x_norm) {
      for (int w = 0; w < CW; ++w) {
        const float v = xs[w * (bq + 1) + tid];
        norm = fmaf(v, v, norm);
      }
    } else if (y_norm) {
      for (int w = 0; w < CW; ++w) {
        const float v = ys[w * (bn + 1) + tid - NORM_Y0];
        norm = fmaf(v, v, norm);
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
  if (x_norm) x2s[tid] = norm;
  if (y_norm) y2s[tid - NORM_Y0] = norm;
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
  for (int e = tid; e < bq * bn; e += NT) {
    const int r = e / bn, c = e % bn, g = row0 + r, col = col0 + c;
    if (g < Q && col < N) out[size_t(g) * N + col] = dist[r * (bn + 1) + c];
  }
}

template <bool L2, bool BF16>
cudaError_t launch_pairwise(const float* x, const float* y, int Q, int N,
                            int D, int bq, int bn, float* out,
                            cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(bq, bn, 0);
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_pass<L2, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + bn - 1) / bn, (Q + bq - 1) / bq);
  pairwise_pass<L2, BF16><<<grid, NT, smem, stream>>>(x, y, Q, N, D, bq, bn,
                                                     out);
  return cudaGetLastError();
}

}  // namespace

// x (Q, D) and y (N, D) fp32, contiguous on the device; out (Q, N) fp32.
// Returns cudaGetLastError() after the launch.
extern "C" int pairwise_f32(const void* x, const void* y, int Q, int N, int D,
                            int metric_ip, int bf16, int bq, int bn,
                            void* out, void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || !tiles_ok(bq, bn) ||
      (Q + bq - 1) / bq > 65535)
    return int(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (metric_ip)
    err = bf16 ? launch_pairwise<false, true>(xf, yf, Q, N, D, bq, bn, o, st)
               : launch_pairwise<false, false>(xf, yf, Q, N, D, bq, bn, o, st);
  else
    err = bf16 ? launch_pairwise<true, true>(xf, yf, Q, N, D, bq, bn, o, st)
               : launch_pairwise<true, false>(xf, yf, Q, N, D, bq, bn, o, st);
  return int(err);
}
