// Q8_0 matrix-vector product for the decode path, written for Hopper (sm_90a).
//
//   out[m, n] = sum_k x[m, k] * (qs[n, k] * scales[n, k / 32])     m <= 16
//
// Replaces the Pallas TPU kernel repro/kernels/q8_matvec.py (q8_matvec,
// body _q8_matvec_kernel). At decode M is 1, so every weight byte is used
// for M multiply-adds: the kernel is bound by the bytes it streams from
// device memory, and it reaches that bound only with enough bytes in
// flight on every SM. Most decode shapes are small (98 KB of int8 W at
// 1 x 384 x 256), so the time is a launch and a few device round trips, and
// what counts is that no round trip waits on another. The design:
//   * each lane loads 16 int8 values of a row (16 bytes: half a Q8_0 block,
//     so one scale per load), and the kLanes = 16 lanes of a half-warp
//     cover 256 values of one row per load instruction: a warp reads two
//     rows at a time (and walks kRowsPerSlot rows in each half-warp where
//     N is large, as in the vocabulary readout);
//   * the K loop is unrolled so that a lane issues kUnroll independent
//     weight loads, and their scales, before it uses the first;
//   * x is read straight from device memory through L1 (float4, or 16-byte
//     bf16 loads), each lane only the values of its own chunks, beside the
//     weight loads: no staging in shared memory and no barrier before the
//     first weight load, and every M <= 16 fits, since a lane holds at most
//     16 values of one x row at a time;
//   * at long K the warps of a block share each row's K (up to kMaxSplit
//     of them, each walking 256-value steps in turn) and add their partial
//     sums through shared memory at the end, in one fixed order; at small
//     N a block holds fewer rows (down to one warp of two rows), so that
//     the grid gives each of the kMinBlocks = 132 SMs at least one block;
//   * int8 is widened to f32 exactly with a byte permute and one add (no
//     quarter-rate integer conversion), dequantized in registers (q * scale
//     in f32, the reference's inline conversion) and accumulated in f32;
//     each row is reduced across its half-warp with shuffles, and the
//     ragged N edge (51,872 = 2^5 * 1621 rows for the vocabulary readout)
//     is masked.
// Operands are read through row strides, so a K-slice of a wider matrix (the
// burst-aligned main segment of the mixed split) needs no copy.
//
// A caller (the autotuner) may choose the rows a half-warp walks (1 or
// kRowsPerSlot), the warps a block and the K split in place of the
// heuristic's; a tile changes the launch, not the function.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing, runs on
// the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLanes = 16;                   // lanes on one row, 16 bytes each
constexpr int kMaxWarps = 4;                 // warps a block, at most
constexpr int kRowsPerSlot = 4;              // rows of a half-warp at large N
constexpr int kMaxSplit = 4;                 // warps sharing one row's K
constexpr int kUnroll = 2;                   // loads a lane issues up front
constexpr int kMinBlocks = 132;              // one block for each SM of an H100
static_assert(kMaxSplit <= kMaxWarps, "a split spans warps of one block");

// 16 consecutive values of x from p as f32; 16-byte loads where `vec`
__device__ __forceinline__ void load16(const float* p, bool vec, float v[16]) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + j);
      v[4 * j] = a.x; v[4 * j + 1] = a.y; v[4 * j + 2] = a.z; v[4 * j + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = __ldg(p + j);
  }
}

__device__ __forceinline__ void load16(const bf16* p, bool vec, float v[16]) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + j);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[8 * j + 2 * i] = f.x;
        v[8 * j + 2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = __bfloat162float(p[j]);
  }
}

// a block: `split` warps share the K of each row; blockDim.x / 32 / split
// warps of 2 * R rows each
template <typename TX, int MT, int R>
__global__ void __launch_bounds__(32 * kMaxWarps)
q8_matvec_kernel(const TX* __restrict__ x, long long ldx, bool vx,
                 const int8_t* __restrict__ qs, long long ldq,
                 const float* __restrict__ scales, long long lds,
                 float* __restrict__ out, long long ldo, int m, int n, int k,
                 int split) {
  __shared__ float red[kMaxWarps * 2 * R * MT];  // the split's partial sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sp = warp % split;               // this warp's share of K
  const int slot = (warp / split) * 2 + lane / kLanes;  // half-warp's rows
  const int rows_per_block = blockDim.x / 32 / split * 2 * R;
  const int row0 = blockIdx.x * rows_per_block + slot * R;
  const int nc = k / 16;                     // 16-byte chunks of a row
  const int stride = split * kLanes;         // chunks between a lane's loads
  const int li = sp * kLanes + lane % kLanes;

  const int8_t* qrow[R];
  const float* srow[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {              // rows past n read row n - 1
    const int row = min(row0 + r, n - 1);
    qrow[r] = qs + row * ldq;
    srow[r] = scales + row * lds;
  }

  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[r][i] = 0.f;

  for (int c0 = li; c0 < nc; c0 += kUnroll * stride) {
    uint4 q[kUnroll][R];
    float s[kUnroll][R];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {      // every load before any use
      const int c = c0 + u * stride;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (c < nc) {
          q[u][r] = __ldg(reinterpret_cast<const uint4*>(qrow[r] + c * 16));
          s[u][r] = __ldg(srow[r] + c / 2);
        } else {
          q[u][r] = make_uint4(0, 0, 0, 0);
          s[u][r] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * stride;
      if (c >= nc) break;
      float w[R][16];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t word[4] = {q[u][r].x, q[u][r].y, q[u][r].z, q[u][r].w};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          w[r][j] = hopper::i8_to_f32(word[j / 4], j % 4) * s[u][r];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= m) break;
        float xv[16];
        load16(x + i * ldx + c * 16, vx, xv);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[r][i] = fmaf(xv[j], w[r][j], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)   // within the half-warp
        acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], off);

  if (split == 1) {
    if (lane % kLanes == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (row0 + r < n && i < m) out[i * ldo + row0 + r] = acc[r][i];
    }
    return;
  }
  if (lane % kLanes == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        red[((slot * R + r) * MT + i) * split + sp] = acc[r][i];
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

// The launch's rows a half-warp (R: 1 or kRowsPerSlot), warps a block and K
// split, from the caller when `rows` is not 0 (each checked by the entry),
// else by the heuristic: split K across warps while each lane keeps whole
// 256-value steps; then the most rows a block (kRowsPerSlot rows a
// half-warp, else 1; then fewer warps) that still gives every SM a block.
template <typename TX, int MT>
cudaError_t launch(const TX* x, long long ldx, bool vx, const int8_t* qs,
                   long long ldq, const float* scales, long long lds,
                   float* out, long long ldo, int m, int n, int k, int rows,
                   int warps, int split, cudaStream_t st) {
  const int nc = k / 16;
  auto blocks = [&](int r, int w) {
    const int rows_per_block = w / split * 2 * r;
    return (n + rows_per_block - 1) / rows_per_block;
  };
  int r = rows;
  if (r == 0) {
    split = 1;
    while (split < kMaxSplit && 2 * split * kLanes <= nc) split *= 2;
    warps = kMaxWarps;
    r = blocks(kRowsPerSlot, warps) >= kMinBlocks ? kRowsPerSlot : 1;
    while (warps > split && blocks(r, warps) < kMinBlocks) warps /= 2;
  }
  const dim3 grid(blocks(r, warps));
  if (r == kRowsPerSlot)
    q8_matvec_kernel<TX, MT, kRowsPerSlot><<<grid, 32 * warps, 0, st>>>(
        x, ldx, vx, qs, ldq, scales, lds, out, ldo, m, n, k, split);
  else
    q8_matvec_kernel<TX, MT, 1><<<grid, 32 * warps, 0, st>>>(
        x, ldx, vx, qs, ldq, scales, lds, out, ldo, m, n, k, split);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t run(const void* xv, long long ldx, const int8_t* q, long long ldq,
                const float* s, long long lds, float* o, long long ldo, int m,
                int n, int k, int r, int w, int sp, cudaStream_t st) {
  const auto* x = static_cast<const TX*>(xv);
  // x rows can be read 16 bytes at a time
  const bool vx = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  (ldx * sizeof(TX)) % 16 == 0;
  if (m == 1) return launch<TX, 1>(x, ldx, vx, q, ldq, s, lds, o, ldo, m, n, k, r, w, sp, st);
  if (m <= 2) return launch<TX, 2>(x, ldx, vx, q, ldq, s, lds, o, ldo, m, n, k, r, w, sp, st);
  if (m <= 4) return launch<TX, 4>(x, ldx, vx, q, ldq, s, lds, o, ldo, m, n, k, r, w, sp, st);
  if (m <= 8) return launch<TX, 8>(x, ldx, vx, q, ldq, s, lds, o, ldo, m, n, k, r, w, sp, st);
  return launch<TX, 16>(x, ldx, vx, q, ldq, s, lds, o, ldo, m, n, k, r, w, sp, st);
}

// a caller's tile: R rows a half-warp, `warps` warps a block of which
// `split` share each row's K; with a split, every lane has a chunk to read
bool tile_ok(int rows, int warps, int split, int k) {
  const bool pow2 = warps == 1 || warps == 2 || warps == 4;
  return (rows == 1 || rows == kRowsPerSlot) && pow2 && warps <= kMaxWarps &&
         (split == 1 || split == 2 || split == 4) && split <= kMaxSplit &&
         warps % split == 0 && (split == 1 || split * kLanes <= k / 16);
}

}  // namespace

// rows, warps and split choose the launch (tile_ok); all 0 take the
// heuristic's
extern "C" int q8_matvec(const void* x, int x_bf16, long long ldx,
                         const void* qs, long long ldq, const void* scales,
                         long long lds, void* out, long long ldo, int m, int n,
                         int k, int rows, int warps, int split, void* stream) {
  if (m < 1 || m > 16 || n < 1 || k < 32 || k % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((rows || warps || split) && !tile_ok(rows, warps, split, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const int8_t*>(qs);
  const auto* s = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? run<bf16>(x, ldx, q, ldq, s, lds, o, ldo, m, n, k, rows, warps,
                         split, st)
             : run<float>(x, ldx, q, ldq, s, lds, o, ldo, m, n, k, rows, warps,
                          split, st);
  return static_cast<int>(err);
}
