// Q8_0 block-dequant matrix product for the prefill path, written for Hopper
// (sm_90a).
//
//   out[m, n] = sum_k x[m, k] * (qs[n, k] * scales[n, k / 32])
//
// Replaces the Pallas TPU kernel repro/kernels/q8_matmul.py (q8_matmul, body
// _q8_matmul_kernel). At prefill M = 1500 frames and x is bf16: each weight
// byte feeds 1500 multiply-adds, so the tensor cores, not the f32 units
// (67 TFLOP/s), must do them, and then the bytes (int8 W, bf16 x, the f32
// output) bound the launch. Two launches in one source, both on the
// tensor cores:
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
//   * f32 x (the Q8_0 decoder's verify window above 16 rows, M = 28 at
//     batch 4, k = 6; llava's f32 patches into its projector, M = 1152),
//     or bf16 x rows off 16 bytes: q8_split_tc_kernel, the same tile,
//     widened W, per-block partial products, scale-and-add and epilogue,
//     with a converting x stage. Rounding an f32 x to bf16 (or to TF32)
//     would change the function, so each x value is split exactly into
//     three bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi
//     - mid) (both differences exact in f32, lo exact in bf16: hi + mid +
//     lo == x while the parts stay normal), each of whose products with an
//     int8 value is exact in f32. A Q8_0 block's partial sum is the three
//     parts' products, p = sum lo q + sum mid q + sum hi q, summed on the
//     tensor cores, the smallest part first (six wgmma a block where bf16
//     x takes two), then d += s * p as above: the same function up to the
//     order of the f32 sums. x comes in through registers, not cp.async:
//     each thread loads 4 chunks of 8 values a 64-wide K step (float4
//     pairs where the row's base and stride are 16-byte aligned, masked
//     scalar loads otherwise and at ragged M and K), issued before the
//     step's products and split and stored swizzled after them into the
//     other of two buffers, so that the loads run under the products; the
//     int8 payload keeps its cp.async copy and widening, both one step
//     ahead (62 KB of shared memory at BN = 32, 74 at 64). A bf16 x on
//     rows off 16 bytes takes the same launch with one part, x itself.
//     The verify window's grids are small (N = 512 at M = 28 is 16 tiles
//     of 64 x 32 on 132 SMs, each walking K alone), so where the 64 x 64
//     grid has fewer tiles than SMs the tile is 64 x 32 and its K steps
//     are shared in order by 2, 4 or 8 CTAs of a thread-block cluster
//     (blockIdx.z), chosen from (M, N, K) alone (split_launch); rank 0
//     adds the others' partial tiles to its own in rank order through
//     distributed shared memory and stores. No float atomics and no
//     workspace: bit for bit the same from one launch to the next.
//
// Both read every operand through its row stride (the burst-aligned main
// segment is never copied) and mask ragged M (1500 is not a multiple of 64)
// and N in the kernel: no padding.
//
// A caller (the autotuner) may choose the tensor-core launch's tile N (32
// or 64) and ring depth (2 to 4): six instantiations of q8_wgmma_kernel.
// A tile changes the launch, not the function. The converting launch
// chooses its own (two tile widths for each x type).
//
// Plain C interface, loaded with ctypes. The launch allocates nothing, runs on
// the caller's stream and returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// K step kt of the weight into a ring slot: qs rows bn.. (raw, 64 bytes a
// row) and scales[bn.., 2 kt..] stored block-major ([2][BN]); zero past n
// and k
template <int BN>
__device__ __forceinline__ void copy_qs_step(
    int8_t* qsr, float* sc, const int8_t* qs, long long ldq,
    const float* scales, long long lds, int bn, int n, int k, int kt,
    int tid) {
  {  // qs: 4 chunks of 16 bytes a row, stored as they are
    constexpr int C = kQBK / 16, STEP = kQThreads / C;
    const int c = tid % C, kc = kt * kQBK + c * 16;
#pragma unroll
    for (int j = 0; j < BN / STEP; ++j) {
      const int r = tid / C + j * STEP;
      const bool ok = bn + r < n && kc < k;
      hopper::cp_async16(qsr + r * kQBK + c * 16,
                         ok ? qs + (bn + r) * ldq + kc : qs, ok);
    }
  }
  if (tid < 2 * BN) {  // scales: 4 bytes each
    const int r = tid >> 1, h = tid & 1, b = 2 * kt + h;
    const bool ok = bn + r < n && b * 32 < k;
    hopper::cp_async4(sc + h * BN + r,
                      ok ? scales + (bn + r) * lds + b : scales, ok);
  }
}

// K step kt of the tile's operands into a ring slot: x rows bm.. (bf16,
// swizzled) and the weight's (copy_qs_step); zero past m, n and k
template <int BN>
__device__ __forceinline__ void copy_step(
    bf16* xs, int8_t* qsr, float* sc, const bf16* x, long long ldx,
    const int8_t* qs, long long ldq, const float* scales, long long lds,
    int bm, int bn, int m, int n, int k, int kt, int tid) {
  {  // x: 8 chunks of 16 bytes a row
    constexpr int C = kQBK / 8, STEP = kQThreads / C;
    const int c = tid % C, kc = kt * kQBK + c * 8;
#pragma unroll
    for (int j = 0; j < kQBM / STEP; ++j) {  // a trip count the compiler
      const int r = tid / C + j * STEP;      // knows: no loop in the code
      const bool ok = bm + r < m && kc < k;
      hopper::cp_async16(xs + swz(r, c), ok ? x + (bm + r) * ldx + kc : x,
                         ok);
    }
  }
  copy_qs_step<BN>(qsr, sc, qs, ldq, scales, lds, bn, n, k, kt, tid);
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
// thread's share of a 64 x BN tile (BN / 2 accumulators), as the sum of
// the products of the P parts of x (da[0] hi, da[1] mid, da[2] lo) with
// the widened block, the smallest part first; the first product
// overwrites p
template <int P, int N>
__device__ __forceinline__ void block_product(float (&p)[N],
                                              const uint64_t (&da)[P],
                                              uint64_t db, int h) {
  using namespace hopper;
  fence_operands(p);
  wgmma_fence();
#pragma unroll
  for (int q = P - 1; q >= 0; --q) {
    wgmma_m64k16(p, da[q] + 4 * h, db + 4 * h, q == P - 1 ? 0 : 1);
    wgmma_m64k16(p, da[q] + 4 * h + 2, db + 4 * h + 2);
  }
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
    const uint64_t da[1] = {wgmma_desc_sw128(slot_x(i))};
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

// -------------------- f32 x, or bf16 rows off 16 bytes: converting, wgmma
// q8_wgmma_kernel's tile, widened W, per-block partial products and
// epilogue, with x through registers: thread t loads chunk t % 8 (8
// values) of rows t / 8 + 16 i of each 64 x 64 step tile, and stores it
// split into P bf16 tiles (f32 x: hi, mid and lo; bf16 x: the value)
template <typename T>
struct Parts {
  static constexpr int n = 3;
};
template <>
struct Parts<bf16> {
  static constexpr int n = 1;
};

constexpr int kSChunks = kQBM * (kQBK / 8) / kQThreads;   // 4 a step
constexpr int kSMaxSplit = 8;          // CTAs of a cluster sharing K, at most
constexpr int kSMinTiles = 132;        // an H100's SMs: fewer tiles split K

// shared memory of the converting launch: two buffers of P x tiles, the
// widened W tile, the raw qs and the scales, and room to align; 62,976 B
// for f32 x at BN = 32, 75,776 at 64
constexpr int split_smem_bytes(int parts, int bn) {
  return 2 * (parts * kQXBytes + bn * kQBK * 2 + bn * kQBK + bn * 2 * 4) +
         1024;
}

// two f32 values split exactly into bf16 parts, packed a pair a part:
// hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid). Both
// differences are exact in f32 and lo is exact in bf16, so hi + mid + lo
// == v wherever the parts stay normal; each part times an int8 value is
// exact in f32
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = hopper::pack_bf16(v0, v1);
  const float r0 = v0 - __uint_as_float(hi << 16);
  const float r1 = v1 - __uint_as_float(hi & 0xffff0000u);
  mid = hopper::pack_bf16(r0, r1);
  lo = hopper::pack_bf16(r0 - __uint_as_float(mid << 16),
                         r1 - __uint_as_float(mid & 0xffff0000u));
}

// chunk r of x at element offset `off` of each part tile of a buffer
__device__ __forceinline__ void put_x(bf16* xb, int off,
                                      const hopper::Raw8<float>& r) {
  constexpr int kX = kQBM * kQBK;
  uint4 hi, mid, lo;
  split2(r.a.x, r.a.y, hi.x, mid.x, lo.x);
  split2(r.a.z, r.a.w, hi.y, mid.y, lo.y);
  split2(r.b.x, r.b.y, hi.z, mid.z, lo.z);
  split2(r.b.z, r.b.w, hi.w, mid.w, lo.w);
  *reinterpret_cast<uint4*>(xb + off) = hi;
  *reinterpret_cast<uint4*>(xb + kX + off) = mid;
  *reinterpret_cast<uint4*>(xb + 2 * kX + off) = lo;
}

__device__ __forceinline__ void put_x(bf16* xb, int off,
                                      const hopper::Raw8<bf16>& r) {
  *reinterpret_cast<uint4*>(xb + off) = r.a;
}

// One 64 x BN output tile; with gridDim.z > 1, its K steps shared in order
// by the gridDim.z CTAs of a cluster (blockIdx.z takes the z-th share),
// whose partial tiles rank 0 sums in rank order through distributed
// shared memory and stores
template <typename TX, int BN>
__global__ void __launch_bounds__(kQThreads, 1)
q8_split_tc_kernel(const TX* __restrict__ x, long long ldx, bool vx,
                   const int8_t* __restrict__ qs, long long ldq,
                   const float* __restrict__ scales, long long lds,
                   float* __restrict__ out, long long ldo, bool vec_out,
                   int m, int n, int k) {
  using namespace hopper;
  constexpr int P = Parts<TX>::n;
  constexpr int kX = kQBM * kQBK;            // values of a part's step tile
  constexpr int kQsBytes = BN * kQBK;        // raw int8 qs tile of a step
  static_assert(BN == 32 || BN == 64, "wgmma n32 or n64");
  static_assert(kQThreads * BN / 2 * 4 <= 2 * P * kX * 2,
                "a partial tile fits in the x buffers");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  bf16* xs = reinterpret_cast<bf16*>(base);              // [2][P][64][64]
  bf16* wt = xs + 2 * P * kX;                            // [2][BN][64]
  int8_t* qsr = reinterpret_cast<int8_t*>(wt + 2 * BN * kQBK);
  float* sc = reinterpret_cast<float*>(qsr + 2 * kQsBytes);  // [2][2][BN]
  const int lane = tid & 31, warp = tid >> 5;
  const int bm = blockIdx.y * kQBM, bn = blockIdx.x * BN;
  const int steps = (k / 32 + 1) / 2;        // K steps; the last may be ragged
  const int per = (steps + gridDim.z - 1) / gridDim.z;
  const int s0 = min(steps, static_cast<int>(blockIdx.z) * per);
  const int ns = min(steps, s0 + per) - s0;  // this CTA's steps
  const int c = tid % 8, r0 = tid / 8;

  Raw8<TX> xr[kSChunks];
  auto fetch = [&](int kt) {                 // loads only: no use yet
    const int kc = kt * kQBK + 8 * c, valid = min(8, k - kc);
#pragma unroll
    for (int i = 0; i < kSChunks; ++i) {
      const int r = r0 + 16 * i;
      fetch8(xr[i], x + (bm + r) * ldx + kc, vx, bm + r < m ? valid : 0);
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kSChunks; ++i)
      put_x(xs + buf * P * kX, swz(r0 + 16 * i, c), xr[i]);
  };
  auto copy = [&](int kt, int buf) {
    copy_qs_step<BN>(qsr + buf * kQsBytes, sc + buf * 2 * BN, qs, ldq,
                     scales, lds, bn, n, k, kt, tid);
  };

  if (ns > 0) {
    copy(s0, 0);
    cp_async_commit();
    fetch(s0);
    cp_async_wait<0>();                      // this thread's qs of step s0
    widen<BN>(wt, qsr, tid);
    put(0);
  }
  float d[BN / 2], p0[BN / 2], p1[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = p0[i] = p1[i] = 0.f;

  for (int i = 0; i < ns; ++i) {
    const int b = i & 1;
    fence_proxy_async();                     // x and W of the step visible
    __syncthreads();                         // to wgmma, in every thread;
                                             // the last step's products done
    const bool next = i + 1 < ns;
    if (next) {                              // in flight under the products
      copy(s0 + i + 1, b ^ 1);
      fetch(s0 + i + 1);
    }
    cp_async_commit();
    uint64_t da[P];
#pragma unroll
    for (int q = 0; q < P; ++q)
      da[q] = wgmma_desc_sw128(xs + (b * P + q) * kX);
    const uint64_t db = wgmma_desc_sw128(wt + b * BN * kQBK);
    block_product(p0, da, db, 0);
    block_product(p1, da, db, 1);
    if (next) {                              // into the buffers the last
      cp_async_wait<0>();                    // step's products read
      widen<BN>(wt + (b ^ 1) * BN * kQBK, qsr + (b ^ 1) * kQsBytes, tid);
      put(b ^ 1);
    }
    wgmma_wait<1>();                         // the first block's scale-and-
    scale_add(d, p0, sc + b * 2 * BN, tid);  // add under the second's product
    wgmma_wait<0>();
    scale_add(d, p1, sc + b * 2 * BN + BN, tid);
  }

  if (gridDim.z > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    float* part = reinterpret_cast<float*>(base);  // the x buffers, now free
    __syncthreads();
    if (rank > 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) part[i * kQThreads + tid] = d[i];
    }
    cluster.sync();                          // every partial tile written
    if (rank == 0) {
      for (unsigned r = 1; r < cluster.num_blocks(); ++r) {  // rank order
        const float* other = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) d[i] += other[i * kQThreads + tid];
      }
    }
    cluster.sync();                          // ... and read before any exits
    if (rank > 0) return;
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

// The converting launch's tile N and K split, from (M, N, K) alone: 64
// columns where that grid already gives every SM a tile, else 32, with
// the K steps shared by 2, 4 or 8 CTAs of a cluster while the grid stays
// within one wave and every CTA has a step
struct SplitLaunch {
  int bn, split;
};

SplitLaunch split_launch(int m, int n, int k) {
  const int rows = (m + kQBM - 1) / kQBM, steps = (k / 32 + 1) / 2;
  if ((n + 63) / 64 * rows >= kSMinTiles) return {64, 1};
  const int tiles = (n + 31) / 32 * rows;
  int split = 1;
  while (split < kSMaxSplit && 2 * split <= steps &&
         2 * split * tiles <= kSMinTiles)
    split *= 2;
  return {32, split};
}

template <typename TX, int BN>
cudaError_t launch_split(const TX* x, long long ldx, bool vx,
                         const int8_t* qs, long long ldq, const float* scales,
                         long long lds, float* out, long long ldo, int m,
                         int n, int k, int split, cudaStream_t st) {
  constexpr int smem = split_smem_bytes(Parts<TX>::n, BN);
  static bool opted_in = false;              // above 48 KB only after opt-in
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        q8_split_tc_kernel<TX, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + BN - 1) / BN, (m + kQBM - 1) / kQBM, split);
  cfg.blockDim = dim3(kQThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = split;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const bool vec_out = reinterpret_cast<uintptr_t>(out) % 8 == 0 && ldo % 2 == 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, q8_split_tc_kernel<TX, BN>, x, ldx, vx, qs, ldq, scales, lds, out,
      ldo, vec_out, m, n, k);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TX>
cudaError_t run_split(const void* xv, long long ldx, bool vx,
                      const int8_t* qs, long long ldq, const float* scales,
                      long long lds, float* out, long long ldo, int m, int n,
                      int k, cudaStream_t st) {
  const auto* x = static_cast<const TX*>(xv);
  const SplitLaunch sl = split_launch(m, n, k);
  if (sl.bn == 64)
    return launch_split<TX, 64>(x, ldx, vx, qs, ldq, scales, lds, out, ldo, m,
                                n, k, sl.split, st);
  return launch_split<TX, 32>(x, ldx, vx, qs, ldq, scales, lds, out, ldo, m,
                              n, k, sl.split, st);
}

}  // namespace

// block_n and stages choose the tensor-core launch's tile N (32 or 64) and
// ring depth (2 to 4); both 0 take kQBN x kQStages. The converting launch
// (f32 x, or bf16 rows off 16 bytes) chooses its own tile and split from
// (M, N, K) and takes a caller's tile as it comes. Every launch copies the
// qs rows 16 bytes at a time: they must be 16-byte aligned.
extern "C" int q8_matmul(const void* x, int x_bf16, long long ldx,
                         const void* qs, long long ldq, const void* scales,
                         long long lds, void* out, long long ldo, int m, int n,
                         int k, int block_n, int stages, void* stream) {
  if (m < 1 || n < 1 || k < 32 || k % 32 != 0 ||
      (m + kQBM - 1) / kQBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((block_n == 0) != (stages == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(qs) % 16 != 0 || ldq % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const int8_t*>(qs);
  const auto* s = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // x rows 16 bytes at a time: 16-byte aligned base and row stride
  const bool vx = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  (ldx * (x_bf16 ? 2 : 4)) % 16 == 0;
  if (x_bf16 && vx)                          // cp.async rows
    return static_cast<int>(launch_tile(
        block_n ? block_n : kQBN, stages ? stages : kQStages, x, ldx, q, ldq,
        s, lds, o, ldo, m, n, k, st));
  return static_cast<int>(
      x_bf16 ? run_split<bf16>(x, ldx, vx, q, ldq, s, lds, o, ldo, m, n, k, st)
             : run_split<float>(x, ldx, vx, q, ldq, s, lds, o, ldo, m, n, k,
                                st));
}
