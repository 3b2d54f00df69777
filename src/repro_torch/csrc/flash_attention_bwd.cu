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
// product, dS in f32. Ragged Sq and Sk are masked in the kernels, as the
// forward does. q, k, v, o and dO take free (BH, S) strides; dq, dk and dv
// are written contiguous.
//
// The work is the flash-2 split into three launches, with no float atomics,
// so that every output element is summed in one fixed order by one thread
// and two launches give the same bits:
//   (a) delta = rowsum(dO o), one warp a row;
//   (b) dK and dV: one block per (key block of 64, bh), holding the dK and
//       dV sums while it walks the query blocks in order (causal: from the
//       diagonal block on, since earlier queries see none of its keys),
//       recomputing s and dP;
//   (c) dQ: one block per (query block of 64, bh), walking the key blocks in
//       order (causal: up to the diagonal), recomputing s and dP again.
//
// Two routes, by the operands' type; neither stands in for the other:
//
//   * bf16: (b) and (c) on the tensor cores, mma.sync.m16n8k16 (bf16 in, f32
//     accumulators), 4 warps a block. In (b) each warp owns 16 keys and
//     computes, for each query block, S^T = K_j Q_i^T and dP^T = V_j dO_i^T
//     (its K_j and V_j rows read with ldmatrix as A fragments, Q_i and dO_i as
//     B), then P^T and dS^T in f32 in the accumulator registers, then dV +=
//     bf16(P^T) dO_i and dK += dS^T Q_i with the score tiles repacked in
//     registers as A fragments (ldmatrix.trans reads Q_i and dO_i as B). In
//     (c) each warp owns 16 query rows: S = Q_i K_j^T, dP = dO_i V_j^T, dQ +=
//     dS K_j. The walked tiles (Q_i, dO_i, lse_i, delta_i in (b); K_j, V_j in
//     (c)) come through a 2-stage cp.async ring of raw bf16 rows in the
//     forward's swizzle, so the next tile loads while this one computes; past
//     Sq and Sk the copies zero-fill, and P is forced to exactly 0 there and
//     above the causal diagonal, in the tiles that reach an edge. dS is f32 in
//     the reference, and bf16 would round it (2^-9): it enters the dK and dQ
//     products as two bf16 terms, hi = bf16(dS) and lo = bf16(dS - hi), two
//     mma each, which leaves below 2^-17 of |dS| unsaid. q, k, v and dO are
//     bf16 and so exact, and P is rounded to bf16 for dV as the reference
//     does. The exponentials are exp2f with log2 e folded into the scale.
//     Blocks are walked heaviest first (causal: key block 0 in (b), the last
//     query block in (c)) for every head before the next lighter one, so that
//     the last wave is short. The rows of q, k, v, o and dO must start on
//     16-byte boundaries for cp.async: the caller copies any that do not, and
//     a launch on such rows returns cudaErrorInvalidValue.
//   * f32 (whisper's f32 training and the test configs; bf16 would change the
//     function): the SIMT kernels of f32 FMAs. Operands are staged in shared
//     memory as f32 (flash_tiles.cuh), d-major for the two score-like
//     contractions (s = q k^T, dP = dO v^T), row-major where a row is the
//     summed index; each thread holds a 4 x 4 score tile and a 4 x D/16 tile
//     of the sums; p and dS pass between the layouts through one 64 x 68
//     shared tile. At D = 128 the dK/dV kernel holds six 64 x 128 f32 tiles,
//     210 KB: one block an SM.
//
// What bounds it: five contractions of 2 Sq Sk D operations (halved when
// causal) are the function's; the tensor-core route does nine products a
// (query block, key block) pair: s and dP in both (b) and (c), dV, and dK
// and dQ twice each for the dS split. At phi3-mini's training shape (BH =
// 64, S = 4096, D = 96, causal) the five are 5.2e11 operations, 0.52 ms
// at 989 TFLOP/s, and the nine 0.94 ms, against some 12 MB of bf16
// operands (0.004 ms at 3.35 TB/s): bound by operations. The measured
// times (chip_smoke.py phase 19a, a launch, and 19b, a training step) are
// in PERF.md §6. What holds it above the bound: mma.sync runs below the
// card's wgmma rate; each warp reads every Q_i and dO_i row twice through
// ldmatrix (plain and transposed) for 16 keys' worth of products, so
// shared memory is about as busy as the tensor cores; and registers cap a
// SM at two 4-warp blocks. Shared memory holds six 64-row bf16 tiles (96
// KB at D = 96 and 128, rows padded to 128 values at D = 96). The dK and
// dV sums take D f32 registers a thread, the score tiles 64; K_j and V_j
// (and Q_i and dO_i in (c)) are read through ldmatrix at each use instead
// of being held, which keeps D = 96 without a spill (phase 19a prints each
// instantiation's registers and spills). A wgmma version with 64-key
// warpgroup tiles (fewer reads of Q_i and dO_i a product) is later work.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing (the
// caller passes delta's (BH, Sq) f32 scratch), runs on the caller's stream
// and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "flash_tiles.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace flash;

// the operands, their (BH, S) strides in elements and the shapes; dq, dk,
// dv and delta are contiguous
struct Operands {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  long long q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss, o_sbh, o_ss, g_sbh, g_ss;
  long long l_sbh;
  int bh, sq, sk, causal;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// (a) delta[r] = sum_d dO[r, d] o[r, d] over rows r = b Sq + i, 8 warps a
// block
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const Operands a, int d) {
  const long long row = blockIdx.x * 8LL + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(a.bh) * a.sq) return;
  const long long b = row / a.sq, i = row % a.sq;
  const T* o = static_cast<const T*>(a.out) + b * a.o_sbh + i * a.o_ss;
  const T* g = static_cast<const T*>(a.dout) + b * a.g_sbh + i * a.g_ss;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f(g[c]), to_f(o[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// ------------------------------------------------------- SIMT, f32 FMAs
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

// p (in place of s) and dS (in place of dp)
// of the tile at query rows i0.., keys k0..; ls and dl: the rows' lse and
// delta
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
      s[i][j] = p;
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
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const Operands a, float scale) {
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
  const int sq = a.sq, sk = a.sk, causal = a.causal;
  const long long rk = static_cast<long long>(bh) * sk;
  const float* q = static_cast<const float*>(a.q) + bh * a.q_sbh;
  const float* dout = static_cast<const float*>(a.dout) + bh * a.g_sbh;
  const float* k = static_cast<const float*>(a.k) + bh * a.k_sbh;
  const float* v = static_cast<const float*>(a.v) + bh * a.v_sbh;
  const float* lse = a.lse + bh * a.l_sbh;
  const float* delta = a.delta + static_cast<long long>(bh) * sq;

  stage<D, true>(kd, k, a.k_ss, k0, sk);
  stage<D, true>(vd, v, a.v_ss, k0, sk);

  float dka[4][TD], dva[4][TD];              // keys ty*4 + j, cols tx*TD + c
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < TD; ++c) dka[j][c] = dva[j][c] = 0.f;

  // causal: queries before k0 see none of this block's keys
  for (int i0 = causal ? k0 : 0; i0 < sq; i0 += kBQ) {
    __syncthreads();                         // the previous tiles consumed
    stage<D, true>(qd, q, a.q_ss, i0, sq);
    stage<D, true>(gd, dout, a.g_ss, i0, sq);
    stage<D, false>(qr, q, a.q_ss, i0, sq);
    stage<D, false>(gr, dout, a.g_ss, i0, sq);
    stage_rows(ls, dl, lse, delta, i0, sq);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(qd, kd, gd, vd, tx, ty, s, dp);
    probs(s, dp, ls, dl, i0, k0, tx, ty, sq, sk, scale, causal);
    put_tile(ps, s, tx, ty);                 // p
    __syncthreads();
    acc_t<D>(dva, ps, gr, tx, ty);           // dV += p^T dO
    __syncthreads();
    put_tile(ps, dp, tx, ty);                // dS
    __syncthreads();
    acc_t<D>(dka, ps, qr, tx, ty);           // dK += dS^T q
  }

  float* dk = static_cast<float*>(a.dk);
  float* dv = static_cast<float*>(a.dv);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + ty * 4 + j;
    if (key >= sk) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const long long at = (rk + key) * D + tx * TD + c;
      dk[at] = dka[j][c];
      dv[at] = dva[j][c];
    }
  }
}

// (c) dQ of query block blockIdx.x of head blockIdx.y
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Operands a, float scale) {
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
  const int sq = a.sq, sk = a.sk, causal = a.causal;
  const long long rq = static_cast<long long>(bh) * sq;
  const float* q = static_cast<const float*>(a.q) + bh * a.q_sbh;
  const float* dout = static_cast<const float*>(a.dout) + bh * a.g_sbh;
  const float* k = static_cast<const float*>(a.k) + bh * a.k_sbh;
  const float* v = static_cast<const float*>(a.v) + bh * a.v_sbh;

  stage<D, true>(qd, q, a.q_ss, i0, sq);
  stage<D, true>(gd, dout, a.g_ss, i0, sq);
  stage_rows(ls, dl, a.lse + bh * a.l_sbh, a.delta + rq, i0, sq);

  float dqa[4][TD];                          // rows ty*4 + i, cols tx*TD + c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TD; ++c) dqa[i][c] = 0.f;

  const int q_last = min(i0 + kBQ, sq) - 1;
  for (int k0 = 0; k0 < sk; k0 += kBK) {
    if (causal && k0 > q_last) break;        // wholly masked for every row
    __syncthreads();                         // the previous tiles consumed
    stage<D, true>(kd, k, a.k_ss, k0, sk);
    stage<D, true>(vd, v, a.v_ss, k0, sk);
    stage<D, false>(kr, k, a.k_ss, k0, sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(qd, kd, gd, vd, tx, ty, s, dp);
    probs(s, dp, ls, dl, i0, k0, tx, ty, sq, sk, scale, causal);
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

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c)
      dq[(rq + row) * D + tx * TD + c] = dqa[i][c];
  }
}

template <int D>
cudaError_t launch_simt(const Operands& a, cudaStream_t st) {
  constexpr int kv_bytes = dkdv_smem_floats<D>() * sizeof(float);
  constexpr int q_bytes = dq_smem_floats<D>() * sizeof(float);
  static bool kv_opted = false, q_opted = false;
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D>, kv_bytes, kv_opted);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq_kernel<D>, q_bytes, q_opted);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const long long rows = static_cast<long long>(a.bh) * a.sq;
  flash_bwd_delta_kernel<float><<<static_cast<unsigned>((rows + 7) / 8),
                                  kThreads, 0, st>>>(a, D);
  flash_bwd_dkdv_kernel<D><<<dim3((a.sk + kBK - 1) / kBK, a.bh), kThreads,
                             kv_bytes, st>>>(a, scale);
  flash_bwd_dq_kernel<D><<<dim3((a.sq + kBQ - 1) / kBQ, a.bh), kThreads,
                           q_bytes, st>>>(a, scale);
  return cudaGetLastError();
}

// ------------------------------------------- bf16 on the tensor cores
constexpr int kMmaWarps = 4, kMmaThreads = 32 * kMmaWarps, kMmaStages = 2;
static_assert(kMmaWarps * 16 == kBK && kBK == kBQ,
              "a warp owns 16 of a block's 64 keys or query rows");
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int mma_tile_elems() {  // a 64-row bf16 tile
  return kBK * tc_ld<D>();
}

// (b) holds k and v and a ring of (q, dO, lse and delta); (c) q and dO and
// a ring of (k, v)
template <int D>
constexpr int dkdv_mma_smem_bytes() {
  return (2 + 2 * kMmaStages) * mma_tile_elems<D>() *
             static_cast<int>(sizeof(bf16)) +
         kMmaStages * 2 * kBQ * static_cast<int>(sizeof(float));
}

template <int D>
constexpr int dq_mma_smem_bytes() {
  return (2 + 2 * kMmaStages) * mma_tile_elems<D>() *
         static_cast<int>(sizeof(bf16));
}

// the A fragments of k-step kq (16 columns) of a 16 x 64 accumulator tile
// t[8][4] in the C layout, as N bf16 terms: N = 1 rounds each value; N = 2
// also keeps what rounding lost, hi = bf16(x) and lo = bf16(x - hi)
template <int N>
__device__ __forceinline__ void c_to_a(const float (&t)[8][4], int kq,
                                       uint32_t (&a)[N][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {              // a0..a3: rows g, g + 8 of
    const int nt = 2 * kq + (r >> 1), c = (r & 1) * 2;  // the two n-tiles
    const float x0 = t[nt][c], x1 = t[nt][c + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    a[0][r] = *reinterpret_cast<const uint32_t*>(&h);
    if constexpr (N == 2) {
      const float2 hf = __bfloat1622float2(h);
      a[1][r] = hopper::pack_bf16(x0 - hf.x, x1 - hf.y);
    }
  }
}

// s = A B^T and dp = A2 B2^T for one warp, 16 x 64 each: the A operands
// are rows a_row.. of the tiles a and a2, the B operands the 64 rows of the
// tiles b and b2 (all (rows, D) row-major, swizzled)
template <int D>
__device__ __forceinline__ void score_pair(const bf16* a, const bf16* a2,
                                           const bf16* b, const bf16* b2,
                                           int a_row, float (&s)[8][4],
                                           float (&dp)[8][4]) {
  using namespace hopper;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4], fa2[4];
    ldmatrix_x4(fa, a + swz<D>(a_row + (lane & 15), kk * 2 + (lane >> 4)));
    ldmatrix_x4(fa2, a2 + swz<D>(a_row + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < 4; ++np) {         // 16 columns: two n-tiles
      const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int c = kk * 2 + ((lane >> 3) & 1);
      uint32_t fb[4], fb2[4];
      ldmatrix_x4(fb, b + swz<D>(r, c));
      ldmatrix_x4(fb2, b2 + swz<D>(r, c));
      mma_bf16(s[2 * np], fa, fb[0], fb[1]);
      mma_bf16(s[2 * np + 1], fa, fb[2], fb[3]);
      mma_bf16(dp[2 * np], fa2, fb2[0], fb2[1]);
      mma_bf16(dp[2 * np + 1], fa2, fb2[2], fb2[3]);
    }
  }
}

// acc (16 x D) += A (16 x 64: k-step kq's fragments, the sum of N bf16
// terms) x rows kq*16.. of the 64-row tile x (row-major, read transposed
// as the B operand)
template <int D, int N>
__device__ __forceinline__ void acc_rows(float (&acc)[D / 8][4],
                                         const uint32_t (&fa)[N][4],
                                         const bf16* x, int kq) {
  using namespace hopper;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {      // 16 output columns
    uint32_t b[4];
    ldmatrix_x4_trans(b, x + swz<D>(kq * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8,
                                    dp * 2 + (lane >> 4)));
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < N; ++n)
        mma_bf16(acc[2 * dp + h], fa[n], b[2 * h], b[2 * h + 1]);
  }
}

// lse and delta of 64 query rows i0.. into st[0..63] and st[64..127], one
// value a thread, zero past Sq
__device__ __forceinline__ void copy_stats(float* st, const float* lse,
                                           const float* delta, int i0,
                                           int sq) {
  static_assert(kMmaThreads == 2 * kBQ, "one value a thread");
  const int t = threadIdx.x, r = i0 + (t & (kBQ - 1));
  const float* src = t < kBQ ? lse : delta;
  const bool ok = r < sq;
  hopper::cp_async4(st + t, ok ? src + r : src, ok);
}

// one query block of (b) for one warp: its 16 keys key0.. (rows g and
// g + 8 of the accumulator tiles: key0 + lane / 4 and + 8) against the 64
// queries i0.. of the ring stage (qs, gs, st). kEdge: the tile reaches
// past Sq or (causal) above the diagonal, and P is masked per element.
template <int D, bool kEdge>
__device__ __forceinline__ void dkdv_tile(const bf16* ks, const bf16* vs,
                                          const bf16* qs, const bf16* gs,
                                          const float* st,
                                          float (&dka)[D / 8][4],
                                          float (&dva)[D / 8][4], int i0,
                                          int key0, int sq, int causal,
                                          float scale, float scale_log2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t4 = lane & 3, kr = key0 + (lane >> 2);
  float s[8][4], dp[8][4];                   // S^T and dP^T: keys x queries
  score_pair<D>(ks, vs, qs, gs, warp * 16, s, dp);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * t4;
    const float2 l = *reinterpret_cast<const float2*>(st + col);
    const float2 dl = *reinterpret_cast<const float2*>(st + kBQ + col);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = i0 + col + (c & 1), key = kr + (c >> 1) * 8;
      float p = exp2f(fmaf(s[nt][c], scale_log2,
                           -((c & 1) ? l.y : l.x) * kLog2e));
      if (kEdge && (qi >= sq || (causal && key > qi))) p = 0.f;
      s[nt][c] = p;
      dp[nt][c] = p * (dp[nt][c] - ((c & 1) ? dl.y : dl.x)) * scale;
    }
  }
#pragma unroll
  for (int kq = 0; kq < kBQ / 16; ++kq) {    // dV += bf16(P^T) dO
    uint32_t pa[1][4];
    c_to_a(s, kq, pa);
    acc_rows<D, 1>(dva, pa, gs, kq);
  }
#pragma unroll
  for (int kq = 0; kq < kBQ / 16; ++kq) {    // dK += dS^T q, dS as hi + lo
    uint32_t ds[2][4];
    c_to_a(dp, kq, ds);
    acc_rows<D, 2>(dka, ds, qs, kq);
  }
}

// (b) on the tensor cores: dK and dV of key block blockIdx.y of head
// blockIdx.x
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const Operands a, float scale, float scale_log2) {
  using namespace hopper;
  constexpr int T = mma_tile_elems<D>(), DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* vs = ks + T;                             // [64][LD]
  bf16* qs = vs + T;                             // [stages][64][LD]
  bf16* gs = qs + kMmaStages * T;                // [stages][64][LD]
  float* st = reinterpret_cast<float*>(gs + kMmaStages * T);  // [stages][128]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x, k0 = blockIdx.y * kBK;
  const int sq = a.sq, sk = a.sk, causal = a.causal;
  const bf16* q = static_cast<const bf16*>(a.q) + bh * a.q_sbh;
  const bf16* dout = static_cast<const bf16*>(a.dout) + bh * a.g_sbh;
  const bf16* k = static_cast<const bf16*>(a.k) + bh * a.k_sbh;
  const bf16* v = static_cast<const bf16*>(a.v) + bh * a.v_sbh;
  const float* lse = a.lse + bh * a.l_sbh;
  const float* delta = a.delta + static_cast<long long>(bh) * sq;

  // causal: queries before k0 see none of this block's keys
  const int i_first = causal ? k0 : 0;
  const int n = i_first < sq ? (sq - i_first + kBQ - 1) / kBQ : 0;

  copy_rows<kBK, D, kMmaThreads>(ks, k, a.k_ss, k0, sk);
  copy_rows<kBK, D, kMmaThreads>(vs, v, a.v_ss, k0, sk);
  cp_async_commit();
  if (n > 0) {
    copy_rows<kBQ, D, kMmaThreads>(qs, q, a.q_ss, i_first, sq);
    copy_rows<kBQ, D, kMmaThreads>(gs, dout, a.g_ss, i_first, sq);
    copy_stats(st, lse, delta, i_first, sq);
  }
  cp_async_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[dt][c] = dva[dt][c] = 0.f;
  const int key0 = k0 + warp * 16;           // this warp's keys
  for (int j = 0; j < n; ++j) {
    cp_async_wait<kMmaStages - 2>();         // stage j has landed
    __syncthreads();                         // ... for every thread, and
                                             // stage j - 1 is consumed
    if (j + 1 < n) {
      const int sl = (j + 1) % kMmaStages, i0 = i_first + (j + 1) * kBQ;
      copy_rows<kBQ, D, kMmaThreads>(qs + sl * T, q, a.q_ss, i0, sq);
      copy_rows<kBQ, D, kMmaThreads>(gs + sl * T, dout, a.g_ss, i0, sq);
      copy_stats(st + sl * 2 * kBQ, lse, delta, i0, sq);
    }
    cp_async_commit();
    if (key0 >= sk) continue;                // warp-uniform: keys all past Sk
    const int sl = j % kMmaStages, i0 = i_first + j * kBQ;
    const bool edge = i0 + kBQ > sq || (causal && i0 < key0 + 15);
    if (edge)
      dkdv_tile<D, true>(ks, vs, qs + sl * T, gs + sl * T,
                         st + sl * 2 * kBQ, dka, dva, i0, key0, sq, causal,
                         scale, scale_log2);
    else
      dkdv_tile<D, false>(ks, vs, qs + sl * T, gs + sl * T,
                          st + sl * 2 * kBQ, dka, dva, i0, key0, sq, causal,
                          scale, scale_log2);
  }
  cp_async_wait<0>();                        // none in flight at exit (n = 0)

  const long long rk = static_cast<long long>(bh) * sk;
  uint32_t* dk = static_cast<uint32_t*>(a.dk);   // bf16 pairs
  uint32_t* dv = static_cast<uint32_t*>(a.dv);
  const int kr = key0 + (lane >> 2), t4 = lane & 3;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = kr + h * 8;
      if (key >= sk) continue;
      const long long at = ((rk + key) * D + dt * 8 + 2 * t4) / 2;
      dk[at] = pack_bf16(dka[dt][2 * h], dka[dt][2 * h + 1]);
      dv[at] = pack_bf16(dva[dt][2 * h], dva[dt][2 * h + 1]);
    }
}

// one key block of (c) for one warp: its 16 query rows (row0 = its first
// + lane / 4, and row0 + 8, whose lse (log2 domain) and delta are l and dl)
// against the 64 keys k0.. of the ring stage (ks, vs). kEdge: the block
// reaches past Sk or (causal) above the diagonal.
template <int D, bool kEdge>
__device__ __forceinline__ void dq_tile(const bf16* qs, const bf16* gs,
                                        const bf16* ks, const bf16* vs,
                                        float (&dqa)[D / 8][4], int k0,
                                        int row0, const float (&l)[2],
                                        const float (&dl)[2], int sk,
                                        int causal, float scale,
                                        float scale_log2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  float s[8][4], dp[8][4];                   // S and dP: queries x keys
  score_pair<D>(qs, gs, ks, vs, warp * 16, s, dp);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int h = c >> 1, key = k0 + nt * 8 + 2 * t4 + (c & 1);
      float p = exp2f(fmaf(s[nt][c], scale_log2, -l[h]));
      if (kEdge && (key >= sk || (causal && key > row0 + h * 8))) p = 0.f;
      dp[nt][c] = p * (dp[nt][c] - dl[h]) * scale;
    }
#pragma unroll
  for (int kq = 0; kq < kBK / 16; ++kq) {    // dQ += dS k, dS as hi + lo
    uint32_t ds[2][4];
    c_to_a(dp, kq, ds);
    acc_rows<D, 2>(dqa, ds, ks, kq);
  }
}

// (c) on the tensor cores: dQ of query block (last first) of head
// blockIdx.x
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const Operands a, float scale, float scale_log2) {
  using namespace hopper;
  constexpr int T = mma_tile_elems<D>(), DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* gs = qs + T;                             // [64][LD]
  bf16* ks = gs + T;                             // [stages][64][LD]
  bf16* vs = ks + kMmaStages * T;                // [stages][64][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int sq = a.sq, sk = a.sk, causal = a.causal;
  const bf16* q = static_cast<const bf16*>(a.q) + bh * a.q_sbh;
  const bf16* dout = static_cast<const bf16*>(a.dout) + bh * a.g_sbh;
  const bf16* k = static_cast<const bf16*>(a.k) + bh * a.k_sbh;
  const bf16* v = static_cast<const bf16*>(a.v) + bh * a.v_sbh;
  const long long rq = static_cast<long long>(bh) * sq;

  const int q_last = min(i0 + kBQ, sq) - 1;  // last stored row of the block
  int nkb = (sk + kBK - 1) / kBK;
  if (causal) nkb = min(nkb, q_last / kBK + 1);

  copy_rows<kBQ, D, kMmaThreads>(qs, q, a.q_ss, i0, sq);
  copy_rows<kBQ, D, kMmaThreads>(gs, dout, a.g_ss, i0, sq);
  cp_async_commit();
  copy_rows<kBK, D, kMmaThreads>(ks, k, a.k_ss, 0, sk);
  copy_rows<kBK, D, kMmaThreads>(vs, v, a.v_ss, 0, sk);
  cp_async_commit();

  // this warp's rows w0..w_last (none when the warp is all padding); this
  // thread's two accumulator rows row0 and row0 + 8, their lse in the log2
  // domain and delta
  const int w0 = i0 + warp * 16, w_last = min(w0 + 15, sq - 1);
  const int row0 = w0 + (lane >> 2);
  float l[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + h * 8;
    l[h] = r < sq ? a.lse[bh * a.l_sbh + r] * kLog2e : 0.f;
    dl[h] = r < sq ? a.delta[rq + r] : 0.f;
  }

  float dqa[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dqa[dt][c] = 0.f;
  for (int j = 0; j < nkb; ++j) {
    cp_async_wait<kMmaStages - 2>();         // stage j has landed
    __syncthreads();
    if (j + 1 < nkb) {
      const int sl = (j + 1) % kMmaStages;
      copy_rows<kBK, D, kMmaThreads>(ks + sl * T, k, a.k_ss, (j + 1) * kBK,
                                     sk);
      copy_rows<kBK, D, kMmaThreads>(vs + sl * T, v, a.v_ss, (j + 1) * kBK,
                                     sk);
    }
    cp_async_commit();
    const int k0 = j * kBK;
    // warp-uniform: no rows, or (causal) every key above every row
    if (w0 > w_last || (causal && k0 > w_last)) continue;
    const int sl = j % kMmaStages;
    const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > w0);
    if (edge)
      dq_tile<D, true>(qs, gs, ks + sl * T, vs + sl * T, dqa, k0, row0, l, dl,
                       sk, causal, scale, scale_log2);
    else
      dq_tile<D, false>(qs, gs, ks + sl * T, vs + sl * T, dqa, k0, row0, l,
                        dl, sk, causal, scale, scale_log2);
  }

  uint32_t* dq = static_cast<uint32_t*>(a.dq);   // bf16 pairs
  const int t4 = lane & 3;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + h * 8;
      if (row >= sq) continue;
      dq[((rq + row) * D + dt * 8 + 2 * t4) / 2] =
          pack_bf16(dqa[dt][2 * h], dqa[dt][2 * h + 1]);
    }
}

template <int D>
cudaError_t launch_mma(const Operands& a, cudaStream_t st) {
  constexpr int kv_bytes = dkdv_mma_smem_bytes<D>();
  constexpr int q_bytes = dq_mma_smem_bytes<D>();
  static bool kv_opted = false, q_opted = false;
  cudaError_t err =
      allow_smem(flash_bwd_dkdv_mma_kernel<D>, kv_bytes, kv_opted);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq_mma_kernel<D>, q_bytes, q_opted);
  if (err != cudaSuccess) return err;
  const double r = 1.0 / sqrt(static_cast<double>(D));
  const float scale = static_cast<float>(r);
  const float scale_log2 = static_cast<float>(r * 1.4426950408889634);
  const long long rows = static_cast<long long>(a.bh) * a.sq;
  flash_bwd_delta_kernel<bf16><<<static_cast<unsigned>((rows + 7) / 8),
                                 kThreads, 0, st>>>(a, D);
  // heads fastest: each key block (query block) of every head before the
  // next, heaviest first
  flash_bwd_dkdv_mma_kernel<D><<<dim3(a.bh, (a.sk + kBK - 1) / kBK),
                                 kMmaThreads, kv_bytes, st>>>(a, scale,
                                                              scale_log2);
  flash_bwd_dq_mma_kernel<D><<<dim3(a.bh, (a.sq + kBQ - 1) / kBQ),
                               kMmaThreads, q_bytes, st>>>(a, scale,
                                                           scale_log2);
  return cudaGetLastError();
}

// bf16 on the tensor cores, f32 on the SIMT kernels
template <int D>
cudaError_t launch(bool bf16_inputs, const Operands& a, cudaStream_t st) {
  return bf16_inputs ? launch_mma<D>(a, st) : launch_simt<D>(a, st);
}

}  // namespace

extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int bf16_inputs, long long q_sbh, long long q_ss,
    long long k_sbh, long long k_ss, long long v_sbh, long long v_ss,
    long long o_sbh, long long o_ss, long long g_sbh, long long g_ss,
    long long l_sbh, int bh, int sq, int sk, int d, int causal,
    void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the tensor-core kernels take bf16 rows that cp.async can copy: the
  // caller copies any others, and nothing falls back here
  using flash::rows16;
  if (bf16_inputs && !(rows16(q, q_sbh, q_ss) && rows16(k, k_sbh, k_ss) &&
                       rows16(v, v_sbh, v_ss) && rows16(out, o_sbh, o_ss) &&
                       rows16(dout, g_sbh, g_ss)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Operands a{q, k, v, out, dout, static_cast<const float*>(lse),
                   static_cast<float*>(delta), dq, dk, dv,
                   q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss, o_sbh, o_ss,
                   g_sbh, g_ss, l_sbh, bh, sq, sk, causal};
  auto st = static_cast<cudaStream_t>(stream);
  const bool b = bf16_inputs != 0;
  switch (d) {
    case 16: return static_cast<int>(launch<16>(b, a, st));
    case 32: return static_cast<int>(launch<32>(b, a, st));
    case 64: return static_cast<int>(launch<64>(b, a, st));
    case 96: return static_cast<int>(launch<96>(b, a, st));
    case 128: return static_cast<int>(launch<128>(b, a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
