// Shared-memory tiles of the flash-attention kernels, forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu). The SIMT
// kernels stage 64-row tiles of a (rows, D) operand as f32, d-major or
// row-major, zero past the operand's last row, by 256 threads laid out
// 16 x 16. The tensor-core kernels copy bf16 rows raw into swizzled tiles
// with cp.async (tc_ld, swz, copy_rows), which ldmatrix reads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64, kBK = 64;            // query rows, keys per block step
constexpr int kThreads = 256;                // 16 x 16, 4 x 4 scores each
constexpr int kLdP = kBK + 4;                // probability row, float4-aligned
constexpr float kNegInf = -1e30f;

// p cast to the operands' type and back
__device__ __forceinline__ float as_type(float p, const float*) { return p; }
__device__ __forceinline__ float as_type(float p, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// 8 consecutive values of a row, as f32: 16-byte loads where `vec` allows
__device__ __forceinline__ void load8(const float* p, bool vec, float v[8]) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = p[j];
  }
}

__device__ __forceinline__ void load8(const bf16* p, bool vec, float v[8]) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(p[j]);
  }
}

// 64 rows r0.. of a (rows, D) operand with row stride ld into shared memory
// as f32, zero past `rows`: d-major (dst[d * 64 + r]; neighbouring threads
// take neighbouring rows, so the scattered stores hit distinct banks) or
// row-major (dst[r * D + d]; neighbouring threads along d). Each thread
// moves 8 consecutive values of one row.
template <int D, bool kDMajor, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ld,
                                      int r0, int rows) {
  constexpr int G = D / 8;
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   (ld * static_cast<long long>(sizeof(T))) % 16 == 0;
  for (int i = threadIdx.x; i < 64 * G; i += kThreads) {
    const int r = kDMajor ? i % 64 : i / G;
    const int d0 = (kDMajor ? i / 64 : i % G) * 8;
    float v[8];
    if (r0 + r < rows) {
      load8(src + (r0 + r) * ld + d0, vec, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    if (kDMajor) {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(d0 + j) * 64 + r] = v[j];
    } else {
      *reinterpret_cast<float4*>(&dst[r * D + d0]) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&dst[r * D + d0 + 4]) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// elements a row of a tensor-core tile spans: D, or 128 at D = 96, whose
// 12 chunks of 8 values the swizzle below cannot permute within the row
template <int D>
__host__ __device__ constexpr int tc_ld() {
  return D == 96 ? 128 : D;
}

// element offset of chunk c (8 values, 16 bytes) of row r in a tile of rows
// of tc_ld<D>() values, swizzled so that the 8 rows an ldmatrix reads (and
// the rows a warp's copies write) fall on distinct banks: chunk c ^ (a
// function of r). A row of C = D/8 chunks: at C = 2, 4 or 8 the row spans
// 8 / C of the 8 chunk slots of 128 bytes, and the XOR reads the row index
// above them; at D = 128 (C = 16) and D = 96 (12 chunks in a padded row
// of 16) the XOR permutes the low 3 bits of c, within each group of 8.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int C = D / 8;
  if constexpr (C <= 8)
    return r * D + ((c ^ ((r / (8 / C)) & (C - 1))) << 3);
  else
    return r * tc_ld<D>() + (((c & ~7) | ((c ^ r) & 7)) << 3);
}

// R rows r0.. of a (rows, D) bf16 operand with row stride ld into a
// swizzled tile, raw, with 16-byte cp.async by the block's NT threads;
// zero past `rows`. Copy i of thread t is chunk (t + i NT) % C of row
// (t + i NT) / C.
template <int R, int D, int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          long long ld, int r0, int rows) {
  constexpr int C = D / 8;
  static_assert(R * C % NT == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < R * C / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / C, c = idx % C;
    const bool ok = r0 + r < rows;
    hopper::cp_async16(dst + swz<D>(r, c),
                       ok ? src + (r0 + r) * ld + c * 8 : src, ok);
  }
}

// rows of a (BH, S, D) bf16 operand with these strides (in elements) can
// be copied 16 bytes at a time
inline bool rows16(const void* p, long long sbh, long long ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (sbh * static_cast<long long>(sizeof(bf16))) % 16 == 0 &&
         (ss * static_cast<long long>(sizeof(bf16))) % 16 == 0;
}

// allow a kernel more than 48 KB of dynamic shared memory (once a kernel)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

}  // namespace flash
