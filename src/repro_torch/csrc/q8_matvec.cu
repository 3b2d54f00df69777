// Q8_0 matrix-vector product for the decode path, written for Hopper (sm_90a).
//
//   out[m, n] = sum_k x[m, k] * (qs[n, k] * scales[n, k / 32])     m <= 16
//
// Replaces the Pallas TPU kernel repro/kernels/q8_matvec.py (q8_matvec,
// body _q8_matvec_kernel). At decode M is 1, so every weight byte is used
// for M multiply-adds: the kernel is bound by the bytes it streams from
// device memory, not by arithmetic. The design therefore
//   * streams the int8 payload and the f32 scales exactly once: each warp
//     owns ROWS output rows and walks them along K, each lane loading 4
//     consecutive int8 values a step, so a warp reads 128 contiguous bytes
//     of a row per load instruction;
//   * dequantizes in registers (q * scale in f32, the reference's inline
//     conversion) and accumulates in f32;
//   * keeps the <= 16 activation rows in shared memory as f32 (converted
//     inline from bf16 or f32), staged once per block and K chunk;
//   * reduces each row across the warp with shuffles, and masks the ragged
//     N edge (51,872 = 2^5 * 1621 rows for the vocabulary readout).
// Operands are read through row strides, so a K-slice of a wider matrix (the
// burst-aligned main segment of the mixed split) needs no copy.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing, runs on
// the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                    // warps per block
constexpr int kRows = 2;                     // output rows per warp
constexpr int kRowsPerBlock = kWarps * kRows;
constexpr int kSmemBytes = 48 * 1024;        // activation chunk, no opt-in needed

__device__ __forceinline__ float load_x(const void* x, int x_bf16, long long i) {
  return x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i])
                : static_cast<const float*>(x)[i];
}

template <int MT>
__global__ void __launch_bounds__(kWarps * 32)
q8_matvec_kernel(const void* __restrict__ x, int x_bf16, long long ldx,
                 const int8_t* __restrict__ qs, long long ldq,
                 const float* __restrict__ scales, long long lds,
                 float* __restrict__ out, long long ldo,
                 int m, int n, int k, int kc) {
  extern __shared__ __align__(16) float xs[];  // [MT][kc] activation chunk
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRows;

  float acc[kRows][MT];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[r][i] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kc) {
    const int len = min(kc, k - k0);         // a multiple of 32
    __syncthreads();                         // previous chunk fully consumed
    for (int i = threadIdx.x; i < MT * len; i += blockDim.x) {
      const int r = i / len, c = i - r * len;
      xs[r * kc + c] = r < m ? load_x(x, x_bf16, r * ldx + k0 + c) : 0.f;
    }
    __syncthreads();

    for (int c = lane * 4; c < len; c += 128) {
      float4 xv[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        xv[i] = *reinterpret_cast<const float4*>(&xs[i * kc + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = row0 + r;
        if (row < n) {
          const char4 q = *reinterpret_cast<const char4*>(
              qs + row * ldq + k0 + c);
          const float s = scales[row * lds + (k0 + c) / 32];
          const float w0 = static_cast<float>(q.x) * s;
          const float w1 = static_cast<float>(q.y) * s;
          const float w2 = static_cast<float>(q.z) * s;
          const float w3 = static_cast<float>(q.w) * s;
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            float a = acc[r][i];
            a = fmaf(xv[i].x, w0, a);
            a = fmaf(xv[i].y, w1, a);
            a = fmaf(xv[i].z, w2, a);
            a = fmaf(xv[i].w, w3, a);
            acc[r][i] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float v = acc[r][i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && row < n && i < m) out[i * ldo + row] = v;
    }
  }
}

template <int MT>
cudaError_t launch(const void* x, int x_bf16, long long ldx, const int8_t* qs,
                   long long ldq, const float* scales, long long lds,
                   float* out, long long ldo, int m, int n, int k,
                   cudaStream_t stream) {
  // K chunk staged in shared memory: as much of K as fits, whole Q8_0 blocks
  int kc = (kSmemBytes / (4 * MT)) / 32 * 32;
  if (kc > k) kc = k;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock);
  q8_matvec_kernel<MT><<<grid, kWarps * 32, MT * kc * sizeof(float), stream>>>(
      x, x_bf16, ldx, qs, ldq, scales, lds, out, ldo, m, n, k, kc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int q8_matvec(const void* x, int x_bf16, long long ldx,
                         const void* qs, long long ldq, const void* scales,
                         long long lds, void* out, long long ldo, int m, int n,
                         int k, void* stream) {
  if (m < 1 || m > 16 || n < 1 || k < 32 || k % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const int8_t*>(qs);
  const auto* s = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (m == 1)
    err = launch<1>(x, x_bf16, ldx, q, ldq, s, lds, o, ldo, m, n, k, st);
  else if (m <= 2)
    err = launch<2>(x, x_bf16, ldx, q, ldq, s, lds, o, ldo, m, n, k, st);
  else if (m <= 4)
    err = launch<4>(x, x_bf16, ldx, q, ldq, s, lds, o, ldo, m, n, k, st);
  else if (m <= 8)
    err = launch<8>(x, x_bf16, ldx, q, ldq, s, lds, o, ldo, m, n, k, st);
  else
    err = launch<16>(x, x_bf16, ldx, q, ldq, s, lds, o, ldo, m, n, k, st);
  return static_cast<int>(err);
}
