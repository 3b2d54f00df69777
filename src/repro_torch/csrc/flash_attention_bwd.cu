// Flash-2 attention backward, written for Hopper (sm_90a).
//
// Given q, k, v (BH, S, D), the forward's output o (in q's type), its
// cotangent dO and the forward's logsumexp lse (BH, Sq) f32, computes
//
//   p  = exp(q k^T D^-0.5 - lse)            (masked: 0; causal: key > query)
//   dV = (p in dO's type)^T dO     dP = dO v^T     delta = rowsum(dO o)
//   dS = p (dP - delta) D^-0.5     dQ = dS k       dK = dS^T q
//
// in the inputs' types (f32 or bf16), all sums in f32. No TPU kernel backs
// this: it replaces the reference's custom VJP of its flash attention
// (repro/models/attention.py, _flash_bwd), which recomputes p a key block
// at a time from (q, k, lse) instead of storing the probabilities, and
// keeps its arithmetic: the scale applied after the contraction, masked
// scores contributing exactly zero, p rounded to dO's type before the dV
// product. Ragged Sq and Sk are masked in the kernels, as the forward does.
//
// The work is the flash-2 split into three launches, with no float atomics,
// so that every output element is summed in one fixed order by one thread
// and a step's gradients do not depend on scheduling:
//   (a) delta = rowsum(dO o), one warp a row;
//   (b) dK and dV: one block per (key block of 64, bh), holding its k and v
//       tiles and the 64 x D dK and dV sums in registers while it walks the
//       query blocks in order (causal: from the diagonal block on, since
//       earlier queries see none of its keys), recomputing s and dP;
//   (c) dQ: one block per (query block of 64, bh), walking the key blocks in
//       order (causal: up to the diagonal), recomputing s and dP again.
// Operands are staged in shared memory as f32 (flash_tiles.cuh), each in the
// layout its products read: d-major for the two score-like contractions
// (s = q k^T, dP = dO v^T), row-major where a row is the summed index (dV,
// dK over query rows; dQ over keys). Each thread holds a 4 x 4 tile of
// scores and a 4 x D/16 tile of the output sums; p and dS pass between the
// two layouts through one 64 x 68 shared tile. At D = 128 the dK/dV kernel
// holds six 64 x 128 f32 tiles, 210 KB: one block an SM, after the opt-in
// above 48 KB.
//
// What bounds it: five contractions of 2 Sq Sk D operations each (seven
// with the recomputations), halved when causal, here on f32 FMAs outside
// the tensor cores (67 TFLOP/s on an H100 SXM); at phi3-mini's training
// shape (BH = 64, S = 4096, D = 96, causal) the five are 5.2e11 operations
// a layer, 7.7 ms at that rate, against some 12 MB of bf16 operands. A
// wgmma version (P and dS from registers) is later work.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing (the
// caller passes delta's (BH, Sq) f32 scratch), runs on the caller's stream
// and returns cudaGetLastError(). Operands are contiguous (BH, S, D).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// (a) delta[r] = sum_d dO[r, d] o[r, d] over rows = BH Sq, 8 warps a block
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int d) {
  const long long row = blockIdx.x * 8LL + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * d;
  const T* g = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f(g[c]), to_f(o[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// s = qt kt^T and dp = gt vt^T over the 64 x 64 tile: this thread's rows
// ty*4 + i, columns tx*4 + j, from d-major (D x 64) tiles
template <int D>
__device__ __forceinline__ void scores(const float* qt, const float* kt,
                                       const float* gt, const float* vt,
                                       int tx, int ty, float (&s)[4][4],
                                       float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&qt[d * 64 + ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&kt[d * 64 + tx * 4]);
    const float4 ga = *reinterpret_cast<const float4*>(&gt[d * 64 + ty * 4]);
    const float4 vb = *reinterpret_cast<const float4*>(&vt[d * 64 + tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
    const float gv[4] = {ga.x, ga.y, ga.z, ga.w};
    const float wv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], wv[j], dp[i][j]);
      }
  }
}

// p (in place of s, rounded to T for the dV product) and dS (in place of dp)
// of the tile at query rows i0.., keys k0..; ls and dl: the rows' lse and
// delta
template <typename T>
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* ls, const float* dl,
                                      int i0, int k0, int tx, int ty, int sq,
                                      int sk, float scale, int causal) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    const float lrow = ls[ty * 4 + i], drow = dl[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx * 4 + j;
      const bool live = row < sq && key < sk && !(causal && key > row);
      const float p = live ? expf(s[i][j] * scale - lrow) : 0.f;
      dp[i][j] = p * (dp[i][j] - drow) * scale;
      s[i][j] = as_type(p, static_cast<const T*>(nullptr));
    }
  }
}

// a 4 x 4 tile into the shared (64, kLdP) tile at rows ty*4.., columns tx*4..
__device__ __forceinline__ void put_tile(float* ps, const float (&t)[4][4],
                                         int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&ps[(ty * 4 + i) * kLdP + tx * 4]) =
        make_float4(t[i][0], t[i][1], t[i][2], t[i][3]);
}

// acc[j][c] += sum_r ps[r][ty*4 + j] x[r][tx*TD + c]: the transposed tile
// times the row-major (64 x D) x, rows summed in order
template <int D>
__device__ __forceinline__ void acc_t(float (&acc)[4][D / 16],
                                      const float* ps, const float* x, int tx,
                                      int ty) {
  constexpr int TD = D / 16;
#pragma unroll 4
  for (int r = 0; r < kBQ; ++r) {
    const float4 pr = *reinterpret_cast<const float4*>(&ps[r * kLdP + ty * 4]);
    const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
    float xv[TD];
#pragma unroll
    for (int c = 0; c < TD; ++c) xv[c] = x[r * D + tx * TD + c];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[j][c] = fmaf(pv[j], xv[c], acc[j][c]);
  }
}

template <int D>
constexpr int dkdv_smem_floats() {           // k, v, q, dO d-major; q, dO
  return 6 * 64 * D + kBQ * kLdP + 2 * kBQ;  // row-major; p / dS; lse, delta
}

template <int D>
constexpr int dq_smem_floats() {             // q, dO, k, v d-major; k
  return 5 * 64 * D + kBQ * kLdP + 2 * kBQ;  // row-major; dS; lse, delta
}

// the rows' lse and delta into shared memory (0 past Sq)
__device__ __forceinline__ void stage_rows(float* ls, float* dl,
                                           const float* lse,
                                           const float* delta, int i0,
                                           int sq) {
  if (threadIdx.x < kBQ) {
    const int r = i0 + threadIdx.x;
    ls[threadIdx.x] = r < sq ? lse[r] : 0.f;
    dl[threadIdx.x] = r < sq ? delta[r] : 0.f;
  }
}

// (b) dK and dV of key block blockIdx.x of head blockIdx.y
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, float scale,
                      int causal) {
  constexpr int TD = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* kd = smem;                          // [D][64] k, d-major
  float* vd = kd + D * kBK;                  // [D][64] v, d-major
  float* qd = vd + D * kBK;                  // [D][64] q, d-major
  float* gd = qd + D * kBQ;                  // [D][64] dO, d-major
  float* qr = gd + D * kBQ;                  // [64][D] q, row-major
  float* gr = qr + kBQ * D;                  // [64][D] dO, row-major
  float* ps = gr + kBQ * D;                  // [64][kLdP] p, then dS
  float* ls = ps + kBQ * kLdP;               // [64] lse
  float* dl = ls + kBQ;                      // [64] delta

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, k0 = blockIdx.x * kBK;
  const long long rq = static_cast<long long>(bh) * sq;
  const long long rk = static_cast<long long>(bh) * sk;
  q += rq * D;
  dout += rq * D;
  lse += rq;
  delta += rq;
  k += rk * D;
  v += rk * D;

  stage<D, true>(kd, k, D, k0, sk);
  stage<D, true>(vd, v, D, k0, sk);

  float dka[4][TD], dva[4][TD];              // keys ty*4 + j, cols tx*TD + c
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < TD; ++c) dka[j][c] = dva[j][c] = 0.f;

  // causal: queries before k0 see none of this block's keys
  for (int i0 = causal ? k0 : 0; i0 < sq; i0 += kBQ) {
    __syncthreads();                         // the previous tiles consumed
    stage<D, true>(qd, q, D, i0, sq);
    stage<D, true>(gd, dout, D, i0, sq);
    stage<D, false>(qr, q, D, i0, sq);
    stage<D, false>(gr, dout, D, i0, sq);
    stage_rows(ls, dl, lse, delta, i0, sq);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(qd, kd, gd, vd, tx, ty, s, dp);
    probs<T>(s, dp, ls, dl, i0, k0, tx, ty, sq, sk, scale, causal);
    put_tile(ps, s, tx, ty);                 // p
    __syncthreads();
    acc_t<D>(dva, ps, gr, tx, ty);           // dV += p^T dO
    __syncthreads();
    put_tile(ps, dp, tx, ty);                // dS
    __syncthreads();
    acc_t<D>(dka, ps, qr, tx, ty);           // dK += dS^T q
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + ty * 4 + j;
    if (key >= sk) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const long long at = (rk + key) * D + tx * TD + c;
      put(dk + at, dka[j][c]);
      put(dv + at, dva[j][c]);
    }
  }
}

// (c) dQ of query block blockIdx.x of head blockIdx.y
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, float scale, int causal) {
  constexpr int TD = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qd = smem;                          // [D][64] q, d-major
  float* gd = qd + D * kBQ;                  // [D][64] dO, d-major
  float* kd = gd + D * kBQ;                  // [D][64] k, d-major
  float* vd = kd + D * kBK;                  // [D][64] v, d-major
  float* kr = vd + D * kBK;                  // [64][D] k, row-major
  float* ps = kr + kBK * D;                  // [64][kLdP] dS
  float* ls = ps + kBQ * kLdP;               // [64] lse
  float* dl = ls + kBQ;                      // [64] delta

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, i0 = blockIdx.x * kBQ;
  const long long rq = static_cast<long long>(bh) * sq;
  const long long rk = static_cast<long long>(bh) * sk;
  q += rq * D;
  dout += rq * D;
  lse += rq;
  delta += rq;
  k += rk * D;
  v += rk * D;

  stage<D, true>(qd, q, D, i0, sq);
  stage<D, true>(gd, dout, D, i0, sq);
  stage_rows(ls, dl, lse, delta, i0, sq);

  float dqa[4][TD];                          // rows ty*4 + i, cols tx*TD + c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TD; ++c) dqa[i][c] = 0.f;

  const int q_last = min(i0 + kBQ, sq) - 1;
  for (int k0 = 0; k0 < sk; k0 += kBK) {
    if (causal && k0 > q_last) break;        // wholly masked for every row
    __syncthreads();                         // the previous tiles consumed
    stage<D, true>(kd, k, D, k0, sk);
    stage<D, true>(vd, v, D, k0, sk);
    stage<D, false>(kr, k, D, k0, sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(qd, kd, gd, vd, tx, ty, s, dp);
    probs<T>(s, dp, ls, dl, i0, k0, tx, ty, sq, sk, scale, causal);
    put_tile(ps, dp, tx, ty);                // dS
    __syncthreads();
    // dQ += dS k: this thread's rows, keys summed in order
#pragma unroll 4
    for (int j0 = 0; j0 < kBK; j0 += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(
            &ps[(ty * 4 + i) * kLdP + j0]);
        pr[i][0] = t.x; pr[i][1] = t.y; pr[i][2] = t.z; pr[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kv[TD];
#pragma unroll
        for (int c = 0; c < TD; ++c) kv[c] = kr[(j0 + jj) * D + tx * TD + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < TD; ++c)
            dqa[i][c] = fmaf(pr[i][jj], kv[c], dqa[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c)
      put(dq + (rq + row) * D + tx * TD + c, dqa[i][c]);
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int bh,
                       int sq, int sk, int causal, cudaStream_t st) {
  constexpr int kv_bytes = dkdv_smem_floats<D>() * sizeof(float);
  constexpr int q_bytes = dq_smem_floats<D>() * sizeof(float);
  static bool kv_opted = false, q_opted = false;
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T, D>, kv_bytes, kv_opted);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq_kernel<T, D>, q_bytes, q_opted);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(bh) * sq;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), kThreads,
                              0, st>>>(static_cast<const T*>(out), tg, delta,
                                       rows, D);
  flash_bwd_dkdv_kernel<T, D><<<dim3((sk + kBK - 1) / kBK, bh), kThreads,
                                kv_bytes, st>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, scale, causal);
  flash_bwd_dq_kernel<T, D><<<dim3((sq + kBQ - 1) / kBQ, bh), kThreads,
                              q_bytes, st>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), sq, sk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(int d, const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const float* lse,
                         float* delta, void* dq, void* dk, void* dv, int bh,
                         int sq, int sk, int causal, cudaStream_t st) {
  switch (d) {
    case 16:
      return launch_bwd<T, 16>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh,
                               sq, sk, causal, st);
    case 32:
      return launch_bwd<T, 32>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh,
                               sq, sk, causal, st);
    case 64:
      return launch_bwd<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh,
                               sq, sk, causal, st);
    case 96:
      return launch_bwd<T, 96>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh,
                               sq, sk, causal, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                bh, sq, sk, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int bf16_inputs, int bh,
                                   int sq, int sk, int d, int causal,
                                   void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16_inputs ? dispatch_bwd<bf16>(d, q, k, v, out, dout, l, dl, dq, dk,
                                       dv, bh, sq, sk, causal, st)
                  : dispatch_bwd<float>(d, q, k, v, out, dout, l, dl, dq, dk,
                                        dv, bh, sq, sk, causal, st);
  return static_cast<int>(err);
}
