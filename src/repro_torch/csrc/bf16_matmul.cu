// 16-bit matrix product for the dense (FP16-path) serving path, written for
// Hopper (sm_90a).
//
//   out[m, n] = sum_k bf16(x[m, k]) * bf16(w[n, k])      (f32 accumulation)
//
// Replaces the Pallas TPU kernel repro/kernels/bf16_matmul.py (bf16_matmul,
// body _bf16_matmul_kernel): both operands are rounded to bf16 inside the
// kernel (x is f32 or bf16, W bf16 or f32), products are exact in f32 and
// summed in f32. Three launch configurations in one source:
//
//   * M <= 16 (decode, M = 1; gemv_bf16_kernel): each weight byte feeds
//     at most 8 multiply-adds, so the product is bound by the bytes of W
//     streamed from device memory, and it reaches that bound only with
//     enough bytes in flight on every SM. Most decode shapes are small
//     (196 KB of W at 1 x 384 x 256): the time is a launch and a few device
//     round trips, and what counts is that no round trip waits on another.
//     This is q8_matvec's design on a bf16 payload. It replaces a kernel
//     of 8-row blocks (48 blocks at N = 384 on 132 SMs) that staged x in
//     shared memory behind two barriers and used each lane's loads as they
//     arrived (six dependent round trips at K = 1536):
//       - a warp per row (kMvLanes = 32): each lane loads 8 bf16 values
//         (16 bytes) of a row, so at K = 256 one load instruction of the
//         warp covers the whole 512-byte row; where N is large (the
//         51,872-row vocabulary readout) a warp walks kMvRows rows;
//       - a lane issues its weight loads for all its rows, and kMvUnroll
//         of them along K for each row, before it uses the first; at K =
//         256 a lane has one load a row, at K = 1536 (split 4) at most two.
//         kMvUnroll = 1: two sweeps on the H100 measured 2 loads along K
//         slower at every decode shape (the readout's 4 rows then hold 8
//         loads of registers, and fewer warps fit an SM);
//       - x is read straight from device memory through L1 (16-byte loads
//         for bf16, float4 for f32), each lane only the values of its own
//         chunks: no staging in shared memory and no barrier before the
//         first weight load, and every M <= 16 fits, since a lane holds 8
//         values of one x row at a time;
//       - at long K the warps of a block share each row's K (up to
//         kMvMaxSplit of them, each walking 256-value steps in turn) and
//         add their partial sums through shared memory at the end, in one
//         fixed order; at small N a block holds fewer warps (down to one),
//         so that the grid gives each of the kMvMinBlocks = 132 SMs at
//         least one block;
//       - bf16 widens to f32 exactly with a 16-bit shift (or a mask, for
//         the upper value of a pair); an f32 operand is rounded to bf16 as
//         it is loaded, so one product serves all four type combinations;
//         products are exact in f32 and summed in f32; each row is reduced
//         across its warp with shuffles;
//       - the ragged N edge (51,872 = 2^5 * 1621) is masked, and so are a
//         K that is not a whole number of 8 (the last chunk) and rows whose
//         base or stride is not 16-byte aligned (value by value): every
//         operand at M <= 16 takes this kernel.
//   * M > 16 with bf16 x and W whose rows cp.async can copy (16-byte
//     aligned bases and row strides, K a whole number of 8; every dense
//     prefill linear of the serving path): bound by bytes at these shapes
//     (K = 256 or 1536, an f32 output of M x N that is most of them), but
//     only if the card keeps enough loads in flight. One warpgroup owns a
//     64 x 64 output tile: x and W tiles are copied raw with 16-byte
//     cp.async into a ring of S steps of kTcBK = 64 (kTcStages = 5 unless
//     a caller chooses 3 or 4), in the 128-byte swizzle, so S - 1 steps
//     load while one computes, behind one barrier a step (81 KB of shared
//     memory at 5, two blocks an SM); each
//     step is four wgmma.m64n64k16 (bf16 in, f32 accumulators) that read
//     both tiles straight from shared memory through descriptors, once for
//     the warpgroup; the f32 outputs are stored straight from the
//     accumulators as float2, masked at ragged M and N. The sum over K
//     runs in one fixed order, with no split of K.
//     At N = 384 the 144 tiles re-read x 6 and W 24 times from L2, and at
//     K = 1536 that traffic (55 MB) is what bounds the launch: the next
//     step is sharing x between the blocks of a row (TMA multicast in a
//     cluster). sweep_kernels.py times the ring depths.
//   * M > 16 otherwise (bf16_cvt_tc_kernel): an f32 operand (the whisper
//     frontend's mel at K = 80, llava's f32 patches into its projector at
//     M = 1152, K = 1024, the f32 test configs), bf16 rows off a 16-byte
//     boundary, K not a whole number of 8. The function rounds both
//     operands to bf16, so rounding an f32 operand on its way into shared
//     memory is the function itself. wgmma_kernel's 64 x 64 tile, 128-byte
//     swizzle, four wgmma.m64n64k16 a 64-wide K step and float2 epilogue,
//     with a load stage through registers in place of cp.async: each
//     thread loads 4 chunks of 8 values of each operand (two float4 or one
//     16-byte load where the row's base and stride are 16-byte aligned,
//     masked scalar loads otherwise and at ragged M, N and K), rounds them
//     to bf16 (RN, PyTorch's cast) and stores them swizzled. The loads of
//     step t + 1 are issued before the products of step t and stored into
//     the other of two shared buffers after them, so they run under the
//     products; one barrier a step (33 KB of shared memory). The sum over
//     K runs in one fixed order, with no split.
//
// All read x and W through their row strides (the burst-aligned main
// segment is the first 256 of 384 columns and is never copied), and mask
// ragged M, N and K in the kernel (M = 1500, N = 51,872 = 2^5 * 1621): no
// padding.
//
// A caller (the autotuner) may choose the M <= 16 launch's rows a lane
// group (1 or kMvRows), warps a block and K split, and the M > 16
// tensor-core launch's ring depth (3 to 5: three instantiations of
// wgmma_kernel); the converting launch takes no tile. A tile changes the
// launch, not the function.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing, runs on
// the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// 8 consecutive values of a row from p, as f32, zero beyond `valid`
__device__ __forceinline__ void load8(const float* p, bool vec, int valid,
                                      float v[8]) {
  if (vec && valid == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < valid ? p[j] : 0.f;
  }
}

__device__ __forceinline__ void load8(const bf16* p, bool vec, int valid,
                                      float v[8]) {
  if (vec && valid == 8) {
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
    for (int j = 0; j < 8; ++j) v[j] = j < valid ? __bfloat162float(p[j]) : 0.f;
  }
}

// ---------------------------------------------------------------- M <= 16
constexpr int kMvLanes = 32;                 // lanes on one row, 16 bytes each
constexpr int kMvMaxWarps = 4;               // warps a block, at most
constexpr int kMvRows = 4;                   // rows of a lane group at large N
constexpr int kMvMaxSplit = 4;               // warps sharing one row's K
constexpr int kMvUnroll = 1;                 // loads along K issued up front
constexpr int kMvMinBlocks = 132;            // one block for each SM of an H100
constexpr int kMvGroups = 32 / kMvLanes;     // lane groups (rows) side by side
static_assert(32 % kMvLanes == 0, "lane groups tile a warp");
static_assert(kMvMaxSplit <= kMvMaxWarps, "a split spans warps of one block");

// 8 f32 rounded to bf16 (as PyTorch's cast), packed in order
__device__ __forceinline__ uint4 pack8(const float v[8]) {
  using hopper::pack_bf16;
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// 8 consecutive values of a row from p as packed bf16, zero beyond `valid`:
// one 16-byte load where `vec` and all 8 are valid; an f32 row is rounded
__device__ __forceinline__ uint4 load8_bf16(const bf16* p, bool vec,
                                            int valid) {
  if (vec && valid == 8) return __ldg(reinterpret_cast<const uint4*>(p));
  float v[8];
  load8(p, false, valid, v);
  return pack8(v);                           // exact: the values are bf16
}

__device__ __forceinline__ uint4 load8_bf16(const float* p, bool vec,
                                            int valid) {
  float v[8];
  load8(p, vec, valid, v);
  return pack8(v);
}

// the two bf16 of a packed word as exact f32: the low one shifted into the
// upper half, the high one with the low half cleared
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// a block: `split` warps share the K of each row; blockDim.x / 32 / split
// warps of kMvGroups lane groups, R rows each
template <typename TX, typename TW, int MT, int R>
__global__ void __launch_bounds__(32 * kMvMaxWarps)
gemv_bf16_kernel(const TX* __restrict__ x, long long ldx, bool vx,
                 const TW* __restrict__ w, long long ldw, bool vw,
                 float* __restrict__ out, long long ldo, int m, int n, int k,
                 int split) {
  __shared__ float red[kMvMaxWarps * kMvGroups * R * MT];  // partial sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sp = warp % split;               // this warp's share of K
  const int group = (warp / split) * kMvGroups + lane / kMvLanes;
  const int rows_per_block = blockDim.x / 32 / split * kMvGroups * R;
  const int row0 = blockIdx.x * rows_per_block + group * R;
  const int nc = (k + 7) / 8;                // chunks of 8, the last ragged
  const int stride = split * kMvLanes;       // chunks between a lane's loads
  const int li = sp * kMvLanes + lane % kMvLanes;

  const TW* wrow[R];
#pragma unroll
  for (int r = 0; r < R; ++r)                // rows past n read row n - 1
    wrow[r] = w + min(row0 + r, n - 1) * ldw;

  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[r][i] = 0.f;

  for (int c0 = li; c0 < nc; c0 += kMvUnroll * stride) {
    uint4 q[kMvUnroll][R];
#pragma unroll
    for (int u = 0; u < kMvUnroll; ++u) {    // every load before any use
      const int c = c0 + u * stride;
#pragma unroll
      for (int r = 0; r < R; ++r)
        q[u][r] = c < nc ? load8_bf16(wrow[r] + 8 * c, vw, min(8, k - 8 * c))
                         : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kMvUnroll; ++u) {
      const int c = c0 + u * stride;
      if (c >= nc) break;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= m) break;
        const uint4 xq = load8_bf16(x + i * ldx + 8 * c, vx, min(8, k - 8 * c));
        const uint32_t xw[4] = {xq.x, xq.y, xq.z, xq.w};
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint32_t ww[4] = {q[u][r].x, q[u][r].y, q[u][r].z, q[u][r].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[r][i] = fmaf(bf16_lo(xw[j]), bf16_lo(ww[j]), acc[r][i]);
            acc[r][i] = fmaf(bf16_hi(xw[j]), bf16_hi(ww[j]), acc[r][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int off = kMvLanes / 2; off > 0; off >>= 1)   // within the group
        acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], off);

  if (split == 1) {
    if (lane % kMvLanes == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (row0 + r < n && i < m) out[i * ldo + row0 + r] = acc[r][i];
    }
    return;
  }
  if (lane % kMvLanes == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        red[((group * R + r) * MT + i) * split + sp] = acc[r][i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows_per_block * MT; e += blockDim.x) {
    const int rb = e / MT, i = e % MT;
    const int row = blockIdx.x * rows_per_block + rb;
    float v = 0.f;
    for (int j = 0; j < split; ++j) v += red[e * split + j];  // fixed order
    if (row < n && i < m) out[i * ldo + row] = v;
  }
}

// The launch's rows a lane group (R: 1 or kMvRows), warps a block and K
// split, from the caller when `rows` is not 0 (each checked by the entry),
// else by the heuristic: split K across warps while each lane keeps whole
// 256-value steps; then the most rows a block (kMvRows rows a lane group,
// else 1; then fewer warps) that still gives every SM a block.
template <typename TX, typename TW, int MT>
cudaError_t launch_gemv(const TX* x, long long ldx, bool vx, const TW* w,
                        long long ldw, bool vw, float* out, long long ldo,
                        int m, int n, int k, int rows, int warps, int split,
                        cudaStream_t st) {
  const int nc = (k + 7) / 8;
  auto blocks = [&](int r, int wp) {
    const int rows_per_block = wp / split * kMvGroups * r;
    return (n + rows_per_block - 1) / rows_per_block;
  };
  int r = rows;
  if (r == 0) {
    split = 1;
    while (split < kMvMaxSplit && 2 * split * kMvLanes <= nc) split *= 2;
    warps = kMvMaxWarps;
    r = blocks(kMvRows, warps) >= kMvMinBlocks ? kMvRows : 1;
    while (warps > split && blocks(r, warps) < kMvMinBlocks) warps /= 2;
  }
  const dim3 grid(blocks(r, warps));
  if (r == kMvRows)
    gemv_bf16_kernel<TX, TW, MT, kMvRows><<<grid, 32 * warps, 0, st>>>(
        x, ldx, vx, w, ldw, vw, out, ldo, m, n, k, split);
  else
    gemv_bf16_kernel<TX, TW, MT, 1><<<grid, 32 * warps, 0, st>>>(
        x, ldx, vx, w, ldw, vw, out, ldo, m, n, k, split);
  return cudaGetLastError();
}

// a caller's M <= 16 tile: R rows a lane group, `warps` warps a block of
// which `split` share each row's K; with a split, every lane has a chunk
bool gemv_tile_ok(int rows, int warps, int split, int k) {
  const bool pow2 = warps == 1 || warps == 2 || warps == 4;
  return (rows == 1 || rows == kMvRows) && pow2 && warps <= kMvMaxWarps &&
         (split == 1 || split == 2 || split == 4) && split <= kMvMaxSplit &&
         warps % split == 0 &&
         (split == 1 || split * kMvLanes <= (k + 7) / 8);
}

// -------------------------------------------- M > 16, bf16 x bf16, wgmma
constexpr int kTcBM = 64, kTcBN = 64;        // output tile: one m64n64 wgmma
constexpr int kTcBK = 64;                    // K step: rows of 128 bytes
constexpr int kTcStages = 5;                 // default cp.async ring depth
constexpr int kTcThreads = 128;              // one warpgroup

// shared memory of an S-slot ring, and room to align it: 82,944 B at 5
constexpr int tc_smem_bytes(int stages) {
  return stages * (kTcBM + kTcBN) * kTcBK * static_cast<int>(sizeof(bf16)) +
         1024;
}

// element offset of chunk c (8 values) of row r of a K step in the 128-byte
// swizzle that wgmma reads (chunk c ^ (r % 8))
__device__ __forceinline__ int swz(int r, int c) {
  return r * kTcBK + ((c ^ (r & 7)) << 3);
}

// R rows r0.. of K step kt of a (rows, k) bf16 operand into shared memory,
// raw, 16 bytes a copy; zero past `rows` and `k` (k is a whole number of 8)
template <int R>
__device__ __forceinline__ void copy_step(bf16* dst, const bf16* src,
                                          long long ld, int r0, int rows,
                                          int kt, int k) {
  constexpr int C = kTcBK / 8, STEP = kTcThreads / C;
  static_assert(R % STEP == 0, "whole passes");
  const int c = threadIdx.x % C;
  const int kc = kt * kTcBK + c * 8;
  int r = threadIdx.x / C;
  const bf16* g = src + (r0 + r) * ld + kc;
#pragma unroll
  for (int i = 0; i < R / STEP; ++i, r += STEP, g += STEP * ld) {
    const bool ok = r0 + r < rows && kc < k;
    hopper::cp_async16(dst + swz(r, c), ok ? g : src, ok);
  }
}

template <int S>
__global__ void __launch_bounds__(kTcThreads)
wgmma_kernel(const bf16* __restrict__ x, long long ldx,
             const bf16* __restrict__ w, long long ldw,
             float* __restrict__ out, long long ldo, bool vec_out, int m,
             int n, int k) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle repeats every 8 rows of 128 bytes: tiles start at 1024 bytes
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* xs = reinterpret_cast<bf16*>(base);       // [stage][kTcBM][kTcBK]
  bf16* ws = xs + S * kTcBM * kTcBK;              // [stage][kTcBN][kTcBK]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bm = blockIdx.y * kTcBM, bn = blockIdx.x * kTcBN;
  const int nk = (k + kTcBK - 1) / kTcBK;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) {
      copy_step<kTcBM>(xs + s * kTcBM * kTcBK, x, ldx, bm, m, s, k);
      copy_step<kTcBN>(ws + s * kTcBN * kTcBK, w, ldw, bn, n, s, k);
    }
    cp_async_commit();                       // one group per K step
  }

  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<S - 2>();                  // step t has landed
    fence_proxy_async();                     // ... for wgmma's reads too
    __syncthreads();                         // ... for all; step t - 1 consumed
    const int tn = t + S - 1;
    if (tn < nk) {
      const int st = tn % S;
      copy_step<kTcBM>(xs + st * kTcBM * kTcBK, x, ldx, bm, m, tn, k);
      copy_step<kTcBN>(ws + st * kTcBN * kTcBK, w, ldw, bn, n, tn, k);
    }
    cp_async_commit();

    // W[n][k] rows are K-major B, as x's rows are K-major A
    const uint64_t da = wgmma_desc_sw128(xs + (t % S) * kTcBM * kTcBK);
    const uint64_t db = wgmma_desc_sw128(ws + (t % S) * kTcBN * kTcBK);
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
      wgmma_m64n64k16(d, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<0>();                         // before the stage is refilled
    fence_operands(d);
  }

  // straight from the accumulators: warp w holds rows 16 w + g and + 8
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = bm + warp * 16 + g + 8 * h;
    if (row >= m) continue;
    float* orow = out + row * ldo;
#pragma unroll
    for (int j = 0; j < kTcBN / 8; ++j) {
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

template <int S>
cudaError_t launch_wgmma(const void* x, long long ldx, const void* w,
                         long long ldw, float* out, long long ldo, int m,
                         int n, int k, cudaStream_t st) {
  constexpr int smem = tc_smem_bytes(S);
  static bool opted_in = false;              // above 48 KB only after opt-in
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const bool vec_out = reinterpret_cast<uintptr_t>(out) % 8 == 0 && ldo % 2 == 0;
  const dim3 grid((n + kTcBN - 1) / kTcBN, (m + kTcBM - 1) / kTcBM);
  wgmma_kernel<S><<<grid, kTcThreads, smem, st>>>(
      static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(w), ldw, out,
      ldo, vec_out, m, n, k);
  return cudaGetLastError();
}

// the ring depths a caller may choose: 3 to 5 slots
cudaError_t launch_wgmma_stages(int stages, const void* x, long long ldx,
                                const void* w, long long ldw, float* out,
                                long long ldo, int m, int n, int k,
                                cudaStream_t st) {
  switch (stages) {
    case 3: return launch_wgmma<3>(x, ldx, w, ldw, out, ldo, m, n, k, st);
    case 4: return launch_wgmma<4>(x, ldx, w, ldw, out, ldo, m, n, k, st);
    case 5: return launch_wgmma<5>(x, ldx, w, ldw, out, ldo, m, n, k, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------- M > 16, converting, on the tensor cores
// wgmma_kernel's tile, descriptors and epilogue, with operands that come
// in through registers: thread t loads chunk t % 8 (8 values) of rows
// t / 8 + 16 i of each 64 x 64 step tile
constexpr int kCvChunks = kTcBM * (kTcBK / 8) / kTcThreads;   // 4 an operand
static_assert(kTcBM == kTcBN, "one chunk mapping serves x and W");
// two buffers of the x and W step tiles, and room to align: 33,792 B
constexpr int kCvSmemBytes =
    2 * (kTcBM + kTcBN) * kTcBK * static_cast<int>(sizeof(bf16)) + 1024;

template <typename TX, typename TW>
__global__ void __launch_bounds__(kTcThreads)
bf16_cvt_tc_kernel(const TX* __restrict__ x, long long ldx, bool vx,
                   const TW* __restrict__ w, long long ldw, bool vw,
                   float* __restrict__ out, long long ldo, bool vec_out,
                   int m, int n, int k) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* xs = reinterpret_cast<bf16*>(base);       // [buffer][kTcBM][kTcBK]
  bf16* ws = xs + 2 * kTcBM * kTcBK;              // [buffer][kTcBN][kTcBK]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bm = blockIdx.y * kTcBM, bn = blockIdx.x * kTcBN;
  const int nk = (k + kTcBK - 1) / kTcBK;
  const int c = tid % 8, r0 = tid / 8;

  Raw8<TX> xr[kCvChunks];
  Raw8<TW> wr[kCvChunks];
  auto fetch = [&](int kt) {                 // loads only: no use yet
    const int kc = kt * kTcBK + 8 * c, valid = min(8, k - kc);
#pragma unroll
    for (int i = 0; i < kCvChunks; ++i) {
      const int r = r0 + 16 * i;
      fetch8(xr[i], x + (bm + r) * ldx + kc, vx, bm + r < m ? valid : 0);
      fetch8(wr[i], w + (bn + r) * ldw + kc, vw, bn + r < n ? valid : 0);
    }
  };
  auto store = [&](int buf) {                // rounded, swizzled
    bf16* xb = xs + buf * kTcBM * kTcBK;
    bf16* wb = ws + buf * kTcBN * kTcBK;
#pragma unroll
    for (int i = 0; i < kCvChunks; ++i) {
      const int r = r0 + 16 * i;
      *reinterpret_cast<uint4*>(xb + swz(r, c)) = round8(xr[i]);
      *reinterpret_cast<uint4*>(wb + swz(r, c)) = round8(wr[i]);
    }
  };

  fetch(0);
  store(0);
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;

  for (int t = 0; t < nk; ++t) {
    fence_proxy_async();                     // this thread's tiles of step t
    __syncthreads();                         // ... in every thread, for
                                             // wgmma; step t - 1 consumed
    const bool next = t + 1 < nk;
    if (next) fetch(t + 1);                  // in flight under the products
    const uint64_t da = wgmma_desc_sw128(xs + (t & 1) * kTcBM * kTcBK);
    const uint64_t db = wgmma_desc_sw128(ws + (t & 1) * kTcBN * kTcBK);
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
      wgmma_m64n64k16(d, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    if (next) store((t + 1) & 1);            // the buffer step t - 1 read
    wgmma_wait<0>();
    fence_operands(d);
  }

  // straight from the accumulators, as wgmma_kernel's
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = bm + warp * 16 + g + 8 * h;
    if (row >= m) continue;
    float* orow = out + row * ldo;
#pragma unroll
    for (int j = 0; j < kTcBN / 8; ++j) {
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

template <typename TX, typename TW>
cudaError_t run(const void* xv, long long ldx, bool vx, const void* wv,
                long long ldw, bool vw, float* out, long long ldo, int m, int n,
                int k, int r, int wp, int sp, cudaStream_t st) {
  const auto* x = static_cast<const TX*>(xv);
  const auto* w = static_cast<const TW*>(wv);
  if (m == 1) return launch_gemv<TX, TW, 1>(x, ldx, vx, w, ldw, vw, out, ldo, m, n, k, r, wp, sp, st);
  if (m <= 2) return launch_gemv<TX, TW, 2>(x, ldx, vx, w, ldw, vw, out, ldo, m, n, k, r, wp, sp, st);
  if (m <= 4) return launch_gemv<TX, TW, 4>(x, ldx, vx, w, ldw, vw, out, ldo, m, n, k, r, wp, sp, st);
  if (m <= 8) return launch_gemv<TX, TW, 8>(x, ldx, vx, w, ldw, vw, out, ldo, m, n, k, r, wp, sp, st);
  if (m <= 16) return launch_gemv<TX, TW, 16>(x, ldx, vx, w, ldw, vw, out, ldo, m, n, k, r, wp, sp, st);
  const bool vec_out = reinterpret_cast<uintptr_t>(out) % 8 == 0 && ldo % 2 == 0;
  const dim3 grid((n + kTcBN - 1) / kTcBN, (m + kTcBM - 1) / kTcBM);
  bf16_cvt_tc_kernel<TX, TW><<<grid, kTcThreads, kCvSmemBytes, st>>>(
      x, ldx, vx, w, ldw, vw, out, ldo, vec_out, m, n, k);
  return cudaGetLastError();
}

// rows of 8 values can be read 16 bytes at a time (bf16) or 2 x 16 (f32)
bool rows_aligned(const void* p, long long ld, int elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ld * elem) % 16 == 0;
}

}  // namespace

// A caller's tile: at M <= 16, rows, warps and split of the gemv launch
// (gemv_tile_ok; all 0 take the heuristic's); at M > 16, the tensor-core
// launch's ring depth `stages` (3 to 5; 0 takes kTcStages). The
// converting launch (M > 16 with an f32 operand or rows cp.async cannot
// copy) has one tile: a nonzero `stages` there is refused.
extern "C" int bf16_matmul(const void* x, int x_bf16, long long ldx,
                           const void* w, int w_bf16, long long ldw, void* out,
                           long long ldo, int m, int n, int k, int rows,
                           int warps, int split, int stages, void* stream) {
  if (m < 1 || n < 1 || k < 1 || (m > 16 && (m + kTcBM - 1) / kTcBM > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool gemv_tile = rows || warps || split;
  if (m > 16 ? gemv_tile || (stages && (stages < 3 || stages > 5))
             : stages || (gemv_tile && !gemv_tile_ok(rows, warps, split, k)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vx = rows_aligned(x, ldx, x_bf16 ? 2 : 4);
  const bool vw = rows_aligned(w, ldw, w_bf16 ? 2 : 4);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // M <= 16: gemv_bf16_kernel for every operand (run); M > 16: wgmma_kernel
  // for bf16 x and W whose rows cp.async can copy, bf16_cvt_tc_kernel (run)
  // otherwise
  const bool tensor_core = m > 16 && x_bf16 && w_bf16 && vx && vw &&
                           k % 8 == 0;               // cp.async rows
  if (m > 16 && stages && !tensor_core)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (tensor_core)
    err = launch_wgmma_stages(stages ? stages : kTcStages, x, ldx, w, ldw, o,
                              ldo, m, n, k, st);
  else if (x_bf16 && w_bf16)
    err = run<bf16, bf16>(x, ldx, vx, w, ldw, vw, o, ldo, m, n, k, rows, warps, split, st);
  else if (x_bf16)
    err = run<bf16, float>(x, ldx, vx, w, ldw, vw, o, ldo, m, n, k, rows, warps, split, st);
  else if (w_bf16)
    err = run<float, bf16>(x, ldx, vx, w, ldw, vw, o, ldo, m, n, k, rows, warps, split, st);
  else
    err = run<float, float>(x, ldx, vx, w, ldw, vw, o, ldo, m, n, k, rows, warps, split, st);
  return static_cast<int>(err);
}
