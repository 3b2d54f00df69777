// Q8_0 block-dequant matrix product for the prefill path, written for Hopper
// (sm_90a).
//
//   out[m, n] = sum_k x[m, k] * (qs[n, k] * scales[n, k / 32])
//
// Replaces the Pallas TPU kernel repro/kernels/q8_matmul.py (q8_matmul, body
// _q8_matmul_kernel). At prefill M = 1500 frames and x is bf16. A bf16 x int8
// product is exact in f32, so per-32-block bf16 tensor-core MMAs with f32
// accumulation, scaled per block afterwards, compute the same function up to
// summation order at 989 TFLOP/s; at that rate the bytes bound the product.
// This first kernel runs outside the tensor cores (67 TFLOP/s in f32), so it
// is bound by its own arithmetic. It is a tiled f32 SIMT product:
//   * each block owns a 64 x 64 output tile and loops over K inside the
//     block in steps of 32 (one Q8_0 block), where the TPU kernel carried
//     its accumulator across a sequential grid dimension;
//   * per step the x tile (converted inline from bf16 or f32) and the W tile
//     (dequantized inline: q * scale in f32) are staged in shared memory, so
//     device memory carries int8 weights, never dequantized ones;
//   * each of the 256 threads accumulates a 4 x 4 sub-tile in f32 registers;
//   * ragged M (1500 is not a multiple of 64) and ragged N are masked in the
//     kernel: no padding of the operands.
// Tensor cores (wgmma on bf16 x and int8-valued bf16 W, TMA staging) are
// later work. f32 x would need tf32, which does change the f32 semantics.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing, runs on
// the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;  // block tile; kBK = one Q8_0 block
constexpr int kTM = 4, kTN = 4;              // per-thread sub-tile
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);
constexpr int kPad = 4;                      // keeps float4 rows 16-byte aligned

__device__ __forceinline__ float load_x(const void* x, int x_bf16, long long i) {
  return x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i])
                : static_cast<const float*>(x)[i];
}

__global__ void __launch_bounds__(kThreads)
q8_matmul_kernel(const void* __restrict__ x, int x_bf16, long long ldx,
                 const int8_t* __restrict__ qs, long long ldq,
                 const float* __restrict__ scales, long long lds,
                 float* __restrict__ out, long long ldo,
                 int m, int n, int k) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];  // x tile, K-major
  __shared__ __align__(16) float ws[kBK][kBN + kPad];  // dequantized W tile
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;
  // loader mapping: thread -> one tile row, 8 consecutive K values
  const int lr = tid >> 2, lc = (tid & 3) * 8;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    const int xr = bm + lr;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      xs[lc + j][lr] = xr < m ? load_x(x, x_bf16, xr * ldx + k0 + lc + j) : 0.f;

    const int wr = bn + lr;
    if (wr < n) {
      const int2 packed =
          *reinterpret_cast<const int2*>(qs + wr * ldq + k0 + lc);
      const float s = scales[wr * lds + k0 / 32];
      const int8_t* q = reinterpret_cast<const int8_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) ws[lc + j][lr] = static_cast<float>(q[j]) * s;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) ws[lc + j][lr] = 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * kTM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * kTN]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = bm + ty * kTM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = bn + tx * kTN + j;
      if (col < n) out[row * ldo + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int q8_matmul(const void* x, int x_bf16, long long ldx,
                         const void* qs, long long ldq, const void* scales,
                         long long lds, void* out, long long ldo, int m, int n,
                         int k, void* stream) {
  if (m < 1 || n < 1 || k < 32 || k % 32 != 0 || (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  q8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, ldx, static_cast<const int8_t*>(qs), ldq,
      static_cast<const float*>(scales), lds, static_cast<float*>(out), ldo, m,
      n, k);
  return static_cast<int>(cudaGetLastError());
}
