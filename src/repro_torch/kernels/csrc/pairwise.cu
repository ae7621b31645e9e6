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
// output, 1.07 GB or 0.32 ms at 3.35 TB/s.  So it is bound by operations.
// Tensor-core products would change the numbers (TF32 keeps 10 mantissa
// bits), so accum "f32" stays on CUDA cores.
//
// Design: grid (ceil(N / bn), ceil(Q / bq)), one bq x bn output tile per
// block, computed by the fp32 product loop of topk_common.cuh: the wide tile
// (128 x 128, 8x8 outputs per thread) when Q > 32, else the narrow one (32 x
// 256, 8x4), so a small Q does not multiply 96 empty rows.  Both norms are
// summed from the staged chunks (XNORM), so each operand is read from device
// memory once per block.  The epilogue stores straight from registers: each
// thread holds groups of 4 adjacent columns of a row, written as one float4
// (a warp covers 256 or 512 contiguous bytes of a row), with scalar stores
// at the ragged column edge or when N % 4 != 0.  Stores are streaming
// (st.global.cs): the output is not read again by this kernel.
#include "topk_common.cuh"

namespace {

// Dynamic shared memory of one block; mirrors tuning.f32_smem_bytes(k = 0).
inline size_t f32_pairwise_smem_bytes(int bq, int bn) {
  return f32_stage_floats(bq, bn) * 4 + size_t(2 * bq + bn) * 4;
}

template <bool L2, bool BF16, bool VEC, int BQ, int BN, int TM, int TN>
__global__ void __launch_bounds__(NT, 2)
pairwise_f32_pass(const float* __restrict__ x, const float* __restrict__ y,
                  int Q, int N, int D, float* __restrict__ out) {
  using T = F32Tile<BQ, BN, TM, TN>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  float* x2s = stage + 2 * F32_KC * (BQ + BN);  // [BQ]
  float* y2s = x2s + BQ;                        // [BN]
  int* xrow = reinterpret_cast<int*>(y2s + BN);  // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % T::TX, ty = tid / T::TX;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BQ;
  for (int r = tid; r < BQ; r += NT) xrow[r] = row0 + r < Q ? row0 + r : -1;
  // f32_tile_product starts with a barrier
  float acc[TM][TN];
  f32_tile_product<BQ, BN, TM, TN, VEC, BF16, L2, true>(
      x, xrow, y, col0, N, D, stage, acc, y2s, x2s);
  if (L2) __syncthreads();  // the norms
  const bool vec_out = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = T::row_of(i, ty), g = row0 + r;
    if (g >= Q) continue;
    const float xr = L2 ? x2s[r] : 0.f;
    float* orow = out + size_t(g) * N;
#pragma unroll
    for (int j4 = 0; j4 < TN / 4; ++j4) {
      const int c = T::col_of(4 * j4, tx), col = col0 + c;
      float v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = acc[i][4 * j4 + jj];
        v[jj] = L2 ? fmaxf(xr + y2s[c + jj] - 2.f * p, 0.f) : -p;
      }
      if (vec_out && col + 3 < N) {
        __stcs(reinterpret_cast<float4*>(orow + col),
               make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (col + jj < N) __stcs(orow + col + jj, v[jj]);
      }
    }
  }
}

template <bool L2, bool BF16, bool VEC, int BQ, int BN, int TM, int TN>
cudaError_t launch_pairwise(const float* x, const float* y, int Q, int N,
                            int D, float* out, cudaStream_t stream) {
  const size_t smem = f32_pairwise_smem_bytes(BQ, BN);
  auto kernel = pairwise_f32_pass<L2, BF16, VEC, BQ, BN, TM, TN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (Q + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(x, y, Q, N, D, out);
  return cudaGetLastError();
}

template <int BQ, int BN, int TM, int TN>
cudaError_t dispatch_pairwise(bool l2, bool bf16, bool vec, const float* x,
                              const float* y, int Q, int N, int D, float* o,
                              cudaStream_t st) {
  if (l2) {
    if (bf16)
      return vec ? launch_pairwise<true, true, true, BQ, BN, TM, TN>(
                       x, y, Q, N, D, o, st)
                 : launch_pairwise<true, true, false, BQ, BN, TM, TN>(
                       x, y, Q, N, D, o, st);
    return vec ? launch_pairwise<true, false, true, BQ, BN, TM, TN>(
                     x, y, Q, N, D, o, st)
               : launch_pairwise<true, false, false, BQ, BN, TM, TN>(
                     x, y, Q, N, D, o, st);
  }
  if (bf16)
    return vec ? launch_pairwise<false, true, true, BQ, BN, TM, TN>(
                     x, y, Q, N, D, o, st)
               : launch_pairwise<false, true, false, BQ, BN, TM, TN>(
                     x, y, Q, N, D, o, st);
  return vec ? launch_pairwise<false, false, true, BQ, BN, TM, TN>(
                   x, y, Q, N, D, o, st)
             : launch_pairwise<false, false, false, BQ, BN, TM, TN>(
                   x, y, Q, N, D, o, st);
}

}  // namespace

// x (Q, D) and y (N, D) fp32, contiguous on the device; out (Q, N) fp32;
// vec: D % 4 == 0 and x, y 16-byte aligned; (bq, bn) = (128, 128) or (32,
// 256).  Returns cudaGetLastError() after the launch.
extern "C" int pairwise_f32(const void* x, const void* y, int Q, int N, int D,
                            int metric_ip, int bf16, int vec, int bq, int bn,
                            void* out, void* stream) {
  const bool wide = bq == F32_WIDE_BQ && bn == F32_WIDE_BN;
  const bool narrow = bq == F32_NARROW_BQ && bn == F32_NARROW_BN;
  if (Q <= 0 || N <= 0 || D <= 0 || !(wide || narrow) ||
      (Q + bq - 1) / bq > 65535)
    return int(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool l2 = !metric_ip;
  return int(wide ? dispatch_pairwise<F32_WIDE_BQ, F32_WIDE_BN, 8, 8>(
                        l2, bf16, vec, xf, yf, Q, N, D, o, st)
                  : dispatch_pairwise<F32_NARROW_BQ, F32_NARROW_BN, 8, 4>(
                        l2, bf16, vec, xf, yf, Q, N, D, o, st));
}
