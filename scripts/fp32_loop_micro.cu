// What fp32 product loop the H100 can run: (1) FMAs on registers alone; (2)
// the product loop of csrc/topk_dense.cu (8 x 8 outputs a thread, float4
// shared reads of padded 9-unit rows, 8 warps a block, one block an SM) on a
// static shared tile, with no copies, barriers or epilogue; (3) the same
// loop at 16 x 8, 8 x 16 and 8 x 4 outputs a thread.  Built and run by
// scripts/fp32_loop_micro.py; prints one line a loop: ms and TFLOP/s.
#include <cstdio>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256, 1) fma_peak(float* out, int iters) {
  float a[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) a[i] = threadIdx.x * 1e-7f + i;
  const float b = 1.0000001f, c = 1e-7f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 64; ++i) a[i] = fmaf(a[i], b, c);
  }
  float s = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += a[i];
  if (s == 1.2345f) out[0] = s;
}

template <int TM, int TN, int BQ, int BN, int WTX>
__global__ void __launch_bounds__(256, 1) lds_loop(float* out, int iters) {
  constexpr int TY = BQ / TM, TX = BN / TN, RS = 9, WX = TX / WTX,
                WTY = 32 / WTX;
  extern __shared__ float4 sm[];
  float4* A = sm;            // BQ rows
  float4* B = sm + BQ * RS;  // BN columns
  for (int i = threadIdx.x; i < (BQ + BN) * RS; i += 256)
    sm[i] = make_float4(i * 1e-6f, 1, 2, 3);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = (warp % WX) * WTX + lane % WTX;
  const int ty = (warp / WX) * WTY + lane / WTX;
  float acc[TM][TN] = {};
  const float4* Ap = A + ty * RS;
  const float4* Bp = B + tx * RS;
  for (int it = 0; it < iters; ++it) {
#pragma unroll 2
    for (int u = 0; u < 8; ++u) {
      float4 bv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bp[j * TX * RS + u];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 av = Ap[i * TY * RS + u];
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
  }
  float s = 0;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s += acc[i][j];
  if (s == 1.2345f) out[0] = s;
}

template <class K>
void timeit(const char* name, K kernel, int smem, int iters,
            double flop_per_thread_iter) {
  float* out;
  cudaMalloc(&out, 4);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kernel<<<132, 256, smem>>>(out, iters);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int r = 0; r < 5; ++r) kernel<<<132, 256, smem>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  ms /= 5;
  const double tf =
      132.0 * 256 * iters * flop_per_thread_iter / (ms * 1e-3) / 1e12;
  printf("{\"loop\": \"%s\", \"ms\": %.4f, \"tflops\": %.2f, \"error\": \"%s\"}\n",
         name, ms, tf, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  timeit("fma_registers", fma_peak, 0, 20000, 64 * 2.0);
  timeit("lds_8x8_128x128", lds_loop<8, 8, 128, 128, 8>, 256 * 9 * 16, 2000,
         8 * 256 * 2.0);
  timeit("lds_16x8_128x256", lds_loop<16, 8, 128, 256, 16>, 384 * 9 * 16,
         1000, 8 * 512 * 2.0);
  timeit("lds_8x16_256x128", lds_loop<8, 16, 256, 128, 8>, 384 * 9 * 16,
         1000, 8 * 512 * 2.0);
  timeit("lds_8x4_32x256", lds_loop<8, 4, 32, 256, 16>, 288 * 9 * 16, 4000,
         8 * 128 * 2.0);
  return 0;
}
