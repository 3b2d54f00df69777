// Tensor-core and asynchronous-copy helpers shared by the port's kernels,
// built for sm_90a: 16- and 4-byte cp.async with zero fill, the exact
// widening of int8 to f32, operand chunks loaded into registers and
// rounded to bf16 (the converting launches), ldmatrix of four 8 x 8
// bf16 matrices (plain and transposed), the warp-wide mma.sync.m16n8k16 bf16
// product with f32 accumulators, Hopper's warpgroup products
// wgmma.m64n64k16 and m64n32k16 on bf16 tiles in shared memory.
//
// Fragment layouts of m16n8k16 (lane = threadIdx.x % 32, g = lane / 4,
// t = lane % 4), which the kernels rely on:
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
//                           a2 = A[g][8+2t..],  a3 = A[g+8][8+2t..]
//   B (16 x 8, "col"):      b0 = B[2t..2t+1][g], b1 = B[8+2t..][g]
//   C (16 x 8, f32):        c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..]
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// `valid` is false (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes likewise (through L1: cp.async.cg takes only 16)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, which lands in r[i]
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// int8 value j (0..3) of the packed word w as an exact f32, without the
// quarter-rate integer conversion: the byte, offset by 128 to 0..255, is
// placed in the mantissa of 2^23 (0x4B000000), and 2^23 + 128 taken away
__device__ __forceinline__ float i8_to_f32(uint32_t w, int j) {
  const uint32_t u = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 | j);
  return __uint_as_float(u) - 8388736.f;
}

// two f32 rounded to bf16 (as PyTorch's cast) in one register, lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ------------------------------------------- operands through registers
// 8 consecutive values of a row as they were loaded, before they are
// rounded to bf16: an f32 row's as 8 floats, a bf16 row's as its 16 bytes.
// The converting launches issue these loads for the next K step before
// the current step's products and convert them after, so that the loads
// run under the products.
template <typename T>
struct Raw8;
template <>
struct Raw8<float> {
  float4 a, b;
};
template <>
struct Raw8<__nv_bfloat16> {
  uint4 a;
};

// the loads of 8 values from p, zero beyond `valid` (at most 8; none read
// at valid <= 0): vector loads where `vec` (p and its row 16-byte
// aligned) and all 8 are valid, else one value at a time
__device__ __forceinline__ void fetch8(Raw8<float>& r, const float* p,
                                       bool vec, int valid) {
  if (vec && valid == 8) {
    r.a = __ldg(reinterpret_cast<const float4*>(p));
    r.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    return;
  }
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = j < valid ? __ldg(p + j) : 0.f;
  r.a = make_float4(v[0], v[1], v[2], v[3]);
  r.b = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void fetch8(Raw8<__nv_bfloat16>& r,
                                       const __nv_bfloat16* p, bool vec,
                                       int valid) {
  if (vec && valid == 8) {
    r.a = __ldg(reinterpret_cast<const uint4*>(p));
    return;
  }
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t u[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) u[j] = j < valid ? __ldg(h + j) : 0u;
  r.a = make_uint4(u[0] | u[1] << 16, u[2] | u[3] << 16, u[4] | u[5] << 16,
                   u[6] | u[7] << 16);
}

// the 8 values rounded to bf16 (RN, as PyTorch's cast), packed in order;
// bf16 values as they are
__device__ __forceinline__ uint4 round8(const Raw8<float>& r) {
  return make_uint4(pack_bf16(r.a.x, r.a.y), pack_bf16(r.a.z, r.a.w),
                    pack_bf16(r.b.x, r.b.y), pack_bf16(r.b.z, r.b.w));
}

__device__ __forceinline__ uint4 round8(const Raw8<__nv_bfloat16>& r) {
  return r.a;
}

// ----------------------------------------------------------------- wgmma
// Shared-memory descriptor of a K-major bf16 tile whose rows are 64 values
// (128 bytes) in the 128-byte swizzle (16-byte chunk c of row r stored at
// chunk c ^ (r % 8)), based at a 1024-byte boundary: start address, the
// leading offset (unused for this layout), 1024 bytes between 8-row groups,
// swizzle mode 1. Adding 2 moves the start 32 bytes along K (16 values).
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* tile) {
  return ((static_cast<uint64_t>(smem_addr(tile)) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d += A (64 x 16) * B (16 x 64) for the warpgroup: A and B K-major tiles
// in shared memory, f32 accumulators; warp w of the warpgroup holds rows
// 16 w.. in the C layout above, one n8 tile per 4 registers:
// d[4 j .. 4 j + 3] = C[g][8 j + 2t..], C[g + 8][8 j + 2t..]
// With accumulate = 0 (scale-d = 0) the product overwrites d instead.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b,
                                                int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));   // scale-d
}

// the same for a 64 x 32 tile (B 16 x 32): d[4 j .. 4 j + 3] as above,
// j < 4
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a,
                                                uint64_t b,
                                                int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// the product of a 64-row tile whose width the accumulators give
__device__ __forceinline__ void wgmma_m64k16(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate = 1) {
  wgmma_m64n64k16(d, a, b, accumulate);
}

__device__ __forceinline__ void wgmma_m64k16(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate = 1) {
  wgmma_m64n32k16(d, a, b, accumulate);
}

// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// this thread's generic-proxy writes to shared memory (cp.async included)
// become visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace hopper
