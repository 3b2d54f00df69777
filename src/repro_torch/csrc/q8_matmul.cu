// Q8_0 block-dequant matrix product for the prefill path, written for Hopper
// (sm_90a).
//
//   out[m, n] = sum_k x[m, k] * (qs[n, k] * scales[n, k / 32])
//
// Replaces the Pallas TPU kernel repro/kernels/q8_matmul.py (q8_matmul, body
// _q8_matmul_kernel). At prefill M = 1500 frames and x is bf16: each weight
// byte feeds 1500 multiply-adds, so the tensor cores, not the f32 units
// (67 TFLOP/s), must do them, and then the bytes (int8 W, bf16 x, the f32
// output) bound the launch. Two launches in one source:
//
//   * bf16 x whose rows cp.async can copy (16-byte aligned bases and row
//     strides; every Q8_0 prefill linear of the serving path): the
//     tensor-core route. A bf16 x times an int8 value held as bf16 is exact
//     in f32, so each 32-value Q8_0 block's partial product, summed in f32
//     on the tensor cores and then multiplied by its scale, computes the
//     reference's x @ (q * s).T up to the order of summation. One
//     warpgroup owns a 64 x BN output tile (by default 64 x 32: at N = 384
//     that is 288 tiles, two or three on each SM, whose steps interleave;
//     64 x 64 leaves most SMs one tile and was 11% slower a prefill). K
//     steps of 64 (two Q8_0 blocks) go through a ring of S cp.async slots
//     (by default 3) that holds, per step, the bf16 x tile in the 128-byte
//     swizzle, the raw int8 qs tile (BN rows x 64 bytes) and the step's
//     BN x 2 f32 scales, zero-filled past ragged M, N and K (K = 32 mod 64
//     leaves the last step's second block zeros, which add 0); copies run
//     S - 1 steps ahead,
//     behind one barrier a step. Each thread widens the qs bytes it copied
//     itself (visible to it after its own cp.async wait, so no barrier)
//     into a swizzled bf16 W tile, exactly, once per stage, and does so for
//     step t + 1 while step t's products run on the tensor cores;
//     fence.proxy.async and the next step's barrier come before wgmma
//     reads it. Each Q8_0 block is two wgmma.m64nNk16 into a partial
//     accumulator, the first with scale-d = 0, then d += s[n, b] * p in
//     f32 registers. The step's two blocks go into two partial
//     accumulators, each block its own commit group, so that the first
//     block's scale-and-add runs under the second block's product
//     (wgmma_wait<1>). No product is in flight across the step's end (a
//     first design that kept one in flight into the next step, with the
//     accumulators fenced before its wait, had ptxas serialize every wgmma,
//     warning C7514). The copy and widen loops have trip
//     counts the compiler knows (a loop bounded by threadIdx.x compiled to
//     a generic divergent loop, several times the instructions between the
//     barrier and the products, and the launch 30% slower). The f32
//     outputs are stored as float2 straight from the accumulators, masked
//     at ragged M and N.
//     Widening into shared memory, not the "swap A/B" form (out^T = W x^T
//     with W widened in registers as wgmma's register A operand): the
//     widened tile costs BN x 128 bytes of shared-memory stores a step,
//     but it keeps bf16_matmul's tile, descriptors and row-major float2
//     epilogue, and each thread widens whole 16-byte chunks; the swapped
//     form gathers each thread's A fragment from the raw tile in 2-byte
//     pieces of two rows (several narrow shared loads and byte permutes a
//     block) and stores a transposed tile (4-byte writes along M).
//   * everything else (f32 x of the test configs, where rounding x to bf16
//     would change the function; unaligned rows): a tiled f32 SIMT product.
//     Each block owns a 64 x 64 output tile and loops over K in steps of 32
//     (one Q8_0 block); per step the x tile (converted inline from bf16 or
//     f32) and the W tile (dequantized inline: q * scale in f32) are staged
//     in shared memory; each of the 256 threads accumulates a 4 x 4
//     sub-tile in f32 registers.
//
// Both read every operand through its row stride (the burst-aligned main
// segment is never copied) and mask ragged M (1500 is not a multiple of 64)
// and N in the kernel: no padding.
//
// A caller (the autotuner) may choose the tensor-core launch's tile N (32
// or 64) and ring depth (2 to 4): six instantiations of q8_wgmma_kernel.
// A tile changes the launch, not the function.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing, runs on
// the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------- f32 SIMT launch

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

// ------------------------------------- bf16 x, tensor cores (wgmma)
// The launch is templated on its tile N (BN, 32 or 64) and its ring depth
// (S, 2 to 4); kQBN x kQStages is the launch taken with no tile given.
constexpr int kQBM = 64;                     // tile rows: wgmma m64
constexpr int kQBN = 32;                     // default tile columns: n32
constexpr int kQBK = 64;                     // K step: two Q8_0 blocks
constexpr int kQStages = 3;                  // default cp.async ring slots
constexpr int kQMinBlocks = 1;               // blocks an SM must hold (regs)
constexpr int kQThreads = 128;               // one warpgroup
constexpr int kQXBytes = kQBM * kQBK * 2;    // bf16 x tile of one step

// shared memory of a launch: the ring (x, raw qs and scales a slot), two
// widened W tiles and room to align; 40,704 B at 32 x 3
constexpr int q_smem_bytes(int bn, int stages) {
  return stages * (kQXBytes + bn * kQBK + bn * 2 * 4) + 2 * bn * kQBK * 2 +
         1024;
}

// element offset of chunk c (8 values) of row r of a K step in the 128-byte
// swizzle that wgmma reads (chunk c ^ (r % 8))
__device__ __forceinline__ int swz(int r, int c) {
  return r * kQBK + ((c ^ (r & 7)) << 3);
}

// K step kt of the tile's operands into a ring slot: x rows bm.. (bf16,
// swizzled), qs rows bn.. (raw, 64 bytes a row), and scales[bn.., 2 kt..]
// stored block-major ([2][BN]); zero past m, n and k
template <int BN>
__device__ __forceinline__ void copy_step(
    bf16* xs, int8_t* qsr, float* sc, const bf16* x, long long ldx,
    const int8_t* qs, long long ldq, const float* scales, long long lds,
    int bm, int bn, int m, int n, int k, int kt, int tid) {
  using hopper::cp_async16;
  {  // x: 8 chunks of 16 bytes a row
    constexpr int C = kQBK / 8, STEP = kQThreads / C;
    const int c = tid % C, kc = kt * kQBK + c * 8;
#pragma unroll
    for (int j = 0; j < kQBM / STEP; ++j) {  // a trip count the compiler
      const int r = tid / C + j * STEP;      // knows: no loop in the code
      const bool ok = bm + r < m && kc < k;
      cp_async16(xs + swz(r, c), ok ? x + (bm + r) * ldx + kc : x, ok);
    }
  }
  {  // qs: 4 chunks of 16 bytes a row, stored as they are
    constexpr int C = kQBK / 16, STEP = kQThreads / C;
    const int c = tid % C, kc = kt * kQBK + c * 16;
#pragma unroll
    for (int j = 0; j < BN / STEP; ++j) {
      const int r = tid / C + j * STEP;
      const bool ok = bn + r < n && kc < k;
      cp_async16(qsr + r * kQBK + c * 16, ok ? qs + (bn + r) * ldq + kc : qs,
                 ok);
    }
  }
  if (tid < 2 * BN) {  // scales: 4 bytes each
    const int r = tid >> 1, h = tid & 1, b = 2 * kt + h;
    const bool ok = bn + r < n && b * 32 < k;
    hopper::cp_async4(sc + h * BN + r,
                      ok ? scales + (bn + r) * lds + b : scales, ok);
  }
}

// the qs chunks this thread copied for a step (copy_step's mapping),
// widened exactly to bf16 into the swizzled W tile
template <int BN>
__device__ __forceinline__ void widen(bf16* wt, const int8_t* qsr, int tid) {
  constexpr int C = kQBK / 16, STEP = kQThreads / C;
  const int c = tid % C;
#pragma unroll
  for (int j = 0; j < BN / STEP; ++j) {
    const int r = tid / C + j * STEP;
    const uint4 q = *reinterpret_cast<const uint4*>(qsr + r * kQBK + c * 16);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    uint32_t h[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[2 * i] = hopper::pack_bf16(hopper::i8_to_f32(w[i], 0),
                                   hopper::i8_to_f32(w[i], 1));
      h[2 * i + 1] = hopper::pack_bf16(hopper::i8_to_f32(w[i], 2),
                                       hopper::i8_to_f32(w[i], 3));
    }
    *reinterpret_cast<uint4*>(wt + swz(r, 2 * c)) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(wt + swz(r, 2 * c + 1)) =
        make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// one Q8_0 block (k16 slices 2 h and 2 h + 1 of the step) into p, a
// thread's share of a 64 x BN tile (BN / 2 accumulators)
template <int N>
__device__ __forceinline__ void block_product(float (&p)[N], uint64_t da,
                                              uint64_t db, int h) {
  using namespace hopper;
  fence_operands(p);
  wgmma_fence();
  wgmma_m64k16(p, da + 4 * h, db + 4 * h, 0);  // overwrite
  wgmma_m64k16(p, da + 4 * h + 2, db + 4 * h + 2);
  wgmma_commit();
}

// d += s[n] * p for the columns this thread holds (sc: one block's scales
// of the tile's columns), once p's product has been waited for
template <int N>
__device__ __forceinline__ void scale_add(float (&d)[N], float (&p)[N],
                                          const float* sc, int tid) {
  hopper::fence_operands(p);
  const int t4 = tid & 3;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 s = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * t4);
    d[4 * j] = fmaf(s.x, p[4 * j], d[4 * j]);
    d[4 * j + 1] = fmaf(s.y, p[4 * j + 1], d[4 * j + 1]);
    d[4 * j + 2] = fmaf(s.x, p[4 * j + 2], d[4 * j + 2]);
    d[4 * j + 3] = fmaf(s.y, p[4 * j + 3], d[4 * j + 3]);
  }
}

template <int BN, int S>
__global__ void __launch_bounds__(kQThreads, kQMinBlocks)
q8_wgmma_kernel(const bf16* __restrict__ x, long long ldx,
                const int8_t* __restrict__ qs, long long ldq,
                const float* __restrict__ scales, long long lds,
                float* __restrict__ out, long long ldo, bool vec_out, int m,
                int n, int k) {
  using namespace hopper;
  static_assert(BN == 32 || BN == 64, "wgmma n32 or n64");
  static_assert(S >= 2, "copies run S - 1 steps ahead");
  static_assert(BN % (kQThreads / 4) == 0, "whole passes of the qs copy");
  constexpr int kQsBytes = BN * kQBK;        // raw int8 qs tile of a step
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle repeats every 8 rows of 128 bytes: tiles start at 1024 bytes
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  bf16* xs = reinterpret_cast<bf16*>(base);              // [slot][64][64]
  bf16* wt = xs + S * kQBM * kQBK;                       // [2][BN][64]
  int8_t* qsr = reinterpret_cast<int8_t*>(wt + 2 * BN * kQBK);
  float* sc = reinterpret_cast<float*>(qsr + S * kQsBytes);
  const int lane = tid & 31, warp = tid >> 5;
  const int bm = blockIdx.y * kQBM, bn = blockIdx.x * BN;
  const int steps = (k / 32 + 1) / 2;        // K steps; the last may be ragged
  constexpr int kAhead = S - 1;              // steps in flight ahead

  auto slot_x = [&](int i) { return xs + (i % S) * kQBM * kQBK; };
  auto slot_q = [&](int i) { return qsr + (i % S) * kQsBytes; };
  auto slot_s = [&](int i) { return sc + (i % S) * 2 * BN; };
  auto slot_w = [&](int i) { return wt + (i & 1) * BN * kQBK; };
  auto copy = [&](int i) {
    copy_step<BN>(slot_x(i), slot_q(i), slot_s(i), x, ldx, qs, ldq, scales,
                  lds, bm, bn, m, n, k, i, tid);
  };

#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (i < steps) copy(i);
    cp_async_commit();                       // one group per K step
  }
  cp_async_wait<kAhead - 1>();               // this thread's copies of step 0
  widen<BN>(slot_w(0), slot_q(0), tid);

  float d[BN / 2], p0[BN / 2], p1[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = p0[i] = p1[i] = 0.f;

  for (int i = 0; i < steps; ++i) {
    fence_proxy_async();                     // x and W of step i visible to
    __syncthreads();                         // wgmma, in every thread; step
                                             // i - 1's products all done
    if (i + kAhead < steps) copy(i + kAhead);  // the slot of step i - 1
    cp_async_commit();

    // the step's two Q8_0 blocks; a ragged last step's second block is
    // zeros (x, qs and its scale zero-filled) and adds 0
    const uint64_t da = wgmma_desc_sw128(slot_x(i));
    const uint64_t db = wgmma_desc_sw128(slot_w(i));
    block_product(p0, da, db, 0);
    block_product(p1, da, db, 1);

    if (i + 1 < steps) {                     // under the products: step
      cp_async_wait<kAhead - 1>();           // i + 1's W, into the buffer
      widen<BN>(slot_w(i + 1), slot_q(i + 1), tid);  // step i - 1 read
    }
    wgmma_wait<1>();                         // the first block's scale-and-
    scale_add(d, p0, slot_s(i), tid);        // add under the second's product
    wgmma_wait<0>();
    scale_add(d, p1, slot_s(i) + BN, tid);
  }

  // straight from the accumulators: warp w holds rows 16 w + g and + 8
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = bm + warp * 16 + g + 8 * h;
    if (row >= m) continue;
    float* orow = out + row * ldo;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = bn + 8 * j + 2 * t4;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (vec_out && col + 1 < n) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      } else {
        if (col < n) orow[col] = v0;
        if (col + 1 < n) orow[col + 1] = v1;
      }
    }
  }
}

template <int BN, int S>
cudaError_t launch_wgmma(const void* x, long long ldx, const int8_t* qs,
                         long long ldq, const float* scales, long long lds,
                         float* out, long long ldo, int m, int n, int k,
                         cudaStream_t st) {
  constexpr int smem = q_smem_bytes(BN, S);
  static bool opted_in = false;              // above 48 KB only after opt-in
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        q8_wgmma_kernel<BN, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const bool vec_out = reinterpret_cast<uintptr_t>(out) % 8 == 0 && ldo % 2 == 0;
  const dim3 grid((n + BN - 1) / BN, (m + kQBM - 1) / kQBM);
  q8_wgmma_kernel<BN, S><<<grid, kQThreads, smem, st>>>(
      static_cast<const bf16*>(x), ldx, qs, ldq, scales, lds, out, ldo,
      vec_out, m, n, k);
  return cudaGetLastError();
}

// the tile's launch: tile N 32 or 64, 2 to 4 ring slots
cudaError_t launch_tile(int bn, int stages, const void* x, long long ldx,
                        const int8_t* qs, long long ldq, const float* scales,
                        long long lds, float* out, long long ldo, int m,
                        int n, int k, cudaStream_t st) {
#define Q8_TILE(BN, S)                                                    \
  if (bn == BN && stages == S)                                            \
    return launch_wgmma<BN, S>(x, ldx, qs, ldq, scales, lds, out, ldo, m, \
                               n, k, st);
  Q8_TILE(32, 2) Q8_TILE(32, 3) Q8_TILE(32, 4)
  Q8_TILE(64, 2) Q8_TILE(64, 3) Q8_TILE(64, 4)
#undef Q8_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

// block_n and stages choose the tensor-core launch's tile N (32 or 64) and
// ring depth (2 to 4); both 0 take kQBN x kQStages. The SIMT launch (f32 x,
// unaligned rows) has one tile and takes them as they come.
extern "C" int q8_matmul(const void* x, int x_bf16, long long ldx,
                         const void* qs, long long ldq, const void* scales,
                         long long lds, void* out, long long ldo, int m, int n,
                         int k, int block_n, int stages, void* stream) {
  if (m < 1 || n < 1 || k < 32 || k % 32 != 0 || (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((block_n == 0) != (stages == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const int8_t*>(qs);
  const auto* s = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // cp.async rows: 16-byte aligned bases and row strides
  const bool rows16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      ldx % 8 == 0 && reinterpret_cast<uintptr_t>(qs) % 16 == 0 &&
                      ldq % 16 == 0;
  if (x_bf16 && rows16)
    return static_cast<int>(launch_tile(
        block_n ? block_n : kQBN, stages ? stages : kQStages, x, ldx, q, ldq,
        s, lds, o, ldo, m, n, k, st));
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  q8_matmul_kernel<<<grid, kThreads, 0, st>>>(x, x_bf16, ldx, q, ldq, s, lds,
                                              o, ldo, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
