// Flash-2 attention forward, written for Hopper (sm_90a).
//
//   out[b, i, :] = sum_j softmax_j(q[b, i, :] . k[b, j, :] * D^-0.5) v[b, j, :]
//
// over (BH, S, D) operands, all f32 or all bf16, with an optional causal
// mask (key j > query i masked with NEG_INF = -1e30, as in the reference).
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd, body _flash_fwd_kernel) and keeps its arithmetic:
// scores are f32 sums of products of the inputs (exact for bf16), scaled
// after the contraction; an online softmax over key blocks of kBK = 64
// carries the running max, denominator (of the f32 probabilities) and
// accumulator; the probabilities are rounded to v's type before the PV
// product, against the running max of their block; the denominator is
// floored at 1e-30. Ragged Sq and Sk are masked in the kernel (1500 is no
// multiple of 64): keys past Sk score NEG_INF, query rows past Sq are not
// stored. Key blocks wholly above the causal diagonal are skipped: every
// row has seen key 0 by then, so they would add exactly zero. The keys are
// never split across blocks: a split would round later blocks'
// probabilities against another running max, another function.
//
// On the whisper encoder (BH = 6, Sq = Sk = 1500, D = 64) one call is 3.5 GFLOP
// (QK and PV) over 3.5 MB of bf16 inputs and a 2.3 MB f32 output: bound by
// the tensor cores' operations (3.5 us at 989 TFLOP/s). Two kernels:
//
//   * bf16 q, k, v whose rows are 16-byte aligned (the encoder's case,
//     strided folded views included): FA2 on mma.sync.m16n8k16 (bf16 in,
//     f32 accumulators). Each warp owns 16 query rows; its q tile is held
//     in registers (A fragments, ldmatrix) for the whole key sweep. K comes
//     through ldmatrix as the B operand of S = QK^T, V through
//     ldmatrix.trans as the B operand of PV. The row max and sum are
//     reduced inside the quad that holds a row in the accumulator layout;
//     the rounded probabilities are repacked in registers as the A operand
//     of PV, so neither the score nor the probability tile touches shared
//     memory. k and v tiles are copied raw as bf16 with 16-byte cp.async
//     into a ring of 2 stages of 2 key blocks (128 keys), rows swizzled so
//     that ldmatrix reads distinct banks: the next stage loads while this
//     one computes, behind one barrier per 2 key blocks.
//     What bounds it here is not the tensor cores' rate but each warp's
//     chain of dependent steps (QK, row max, exp, PV, per key block): a
//     launch has only 564 sixteen-row warp tiles (94 per head; the keys
//     may not be split), about one per SM sub-partition, so little else
//     hides a warp's latency. The design gives each warp independent work
//     instead: the two score tiles of a stage are computed before their
//     softmax steps, and the stages that need no mask (all but the last
//     and, causal, those that reach a row's diagonal) run without a
//     branch, so one block's softmax overlaps the other's products. The
//     exponentials are exp2f with log2 e folded into the scale. Blocks of
//     4 warps (64 rows, 144 blocks of 72 KB) with 2 key blocks a stage:
//     among the configurations sweep_kernels.py builds, 8-warp blocks and
//     a 3-stage ring came within noise of it, and 2-warp blocks or 1 key
//     block a stage were slower. mma.sync, not wgmma: a 64-row warpgroup
//     tile would cut the warp tiles to 141 for 132 SMs and lengthen each
//     chain.
//   * f32 operands (test configs; rounding them to bf16 would change the
//     function) and bf16 rows that are not 16-byte aligned: the SIMT kernel
//     of f32 FMAs (256 threads as 16 x 16, a 4 x 4 score tile each, 64 query
//     rows a block, the probabilities through shared memory).
// Built for head sizes D = 64 (the Whisper ladder), 128 (llava and the
// other attention LMs), 96 (phi3-mini), 32 and 16 (the smoke and test
// configs; D = 16 is one k-step of the m16n8k16). At D = 128 the tensor-core
// kernel's shared memory is 144 KB (one block an SM) and a thread holds 64
// f32 accumulators and 32 q fragment registers; D = 96 pads each tile row
// to 128 values so that the swizzle stays a permutation within the row.
//
// Both kernels take a nullable lse (BH, Sq) f32: where it is given, each
// stored row also writes its logsumexp m + log(max(l, 1e-30)) (natural log,
// from the running max and denominator), which the backward
// (flash_attention_bwd.cu) recomputes the probabilities from. Serving passes
// null and its launches do the same work as before.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing, runs on
// the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "flash_tiles.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace flash;

template <int D>
constexpr int smem_floats() {
  return D * kBQ                                          // q, d-major
         + (D * kBK > kBQ * kLdP ? D * kBK : kBQ * kLdP)  // k (d-major) / p
         + kBK * D;                                       // v, key-major
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, long long q_sbh, long long q_ss,
                 long long k_sbh, long long k_ss, long long v_sbh,
                 long long v_ss, float* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, float scale,
                 int causal) {
  constexpr int TD = D / 16;                 // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [D][kBQ]
  float* kp = qs + D * kBQ;                  // k: [D][kBK]; p: [kBQ][kLdP]
  float* vs = kp + (D * kBK > kBQ * kLdP ? D * kBK : kBQ * kLdP);  // [kBK][D]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  q += bh * q_sbh;
  k += bh * k_sbh;
  v += bh * v_sbh;

  stage<D, true>(qs, q, q_ss, q0, sq);

  float m_run[4], l_run[4], acc[4][TD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, sq) - 1;  // last stored query row
  for (int k0 = 0; k0 < sk; k0 += kBK) {
    if (causal && k0 > q_last) break;        // wholly masked for every row
    __syncthreads();                         // previous k/p and v consumed
    stage<D, true>(kp, k, k_ss, k0, sk);
    stage<D, false>(vs, v, v_ss, k0, sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[d * kBQ + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&kp[d * kBK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    float p[4][4], corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        s[i][j] = (key >= sk || (causal && key > row)) ? kNegInf
                                                       : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)   // the 16 threads of this row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[i] = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr[i] + sum;
      m_run[i] = m_new;
    }
    __syncthreads();                         // every thread done reading k
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 pv = make_float4(as_type(p[i][0], k), as_type(p[i][1], k),
                                    as_type(p[i][2], k), as_type(p[i][3], k));
      *reinterpret_cast<float4*>(&kp[(ty * 4 + i) * kLdP + tx * 4]) = pv;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] *= corr[i];
    }
    __syncthreads();

#pragma unroll 4
    for (int j0 = 0; j0 < kBK; j0 += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(
            &kp[(ty * 4 + i) * kLdP + j0]);
        pr[i][0] = t.x; pr[i][1] = t.y; pr[i][2] = t.z; pr[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[TD];
        const float* vrow = &vs[(j0 + jj) * D + tx * TD];
        if constexpr (TD % 4 == 0) {
#pragma unroll
          for (int c = 0; c < TD; c += 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + c);
            vv[c] = t.x; vv[c + 1] = t.y; vv[c + 2] = t.z; vv[c + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < TD; ++c) vv[c] = vrow[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < TD; ++c) acc[i][c] = fmaf(pr[i][jj], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float inv = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < TD; ++c)
      out[((long long)bh * sq + row) * D + tx * TD + c] = acc[i][c] / inv;
    if (lse != nullptr && tx == 0)           // the backward's logsumexp
      lse[(long long)bh * sq + row] = m_run[i] + logf(inv);
  }
}

// ------------------------------------------- bf16 on the tensor cores
// A block of kTcWarps warps owns 16 kTcWarps query rows; a ring stage
// holds kTcSub key blocks of kBK keys, so one barrier and one batch of
// copies serve kTcSub online-softmax steps, and the score tiles of a stage
// are computed before their (sequential) softmax steps, which gives each
// warp independent tensor-core work to overlap with the softmax.
constexpr int kTcWarps = 4, kTcSub = 2, kTcStages = 2;
constexpr int kTcRows = 16 * kTcWarps;       // query rows per block
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcKeys = kBK * kTcSub;        // keys per ring stage

template <int D>
constexpr int tc_smem_bytes() {              // q tile + k and v rings
  return (kTcRows + 2 * kTcStages * kTcKeys) * tc_ld<D>() *
         static_cast<int>(sizeof(bf16));
}

// One ring stage (kTcSub key blocks from key block kb0) for one warp's 16
// rows: the kTcSub score tiles first, then the online-softmax steps and PV
// products in key order. kEdge = false is the stage where every key block
// is needed by every row of the warp and nothing is masked: no branch
// splits it, so the compiler can overlap one block's softmax with the
// other's tensor-core products. kEdge = true checks each block: blocks
// past nkb, and (causal) blocks wholly above the warp's rows, add exactly
// zero and are skipped; keys past Sk and (causal) above a row's diagonal
// score NEG_INF.
template <int D, bool kEdge>
__device__ __forceinline__ void flash_stage(
    const bf16* kst, const bf16* vst, const uint32_t (&qf)[D / 16][4],
    float (&o)[D / 8][4], float& m0, float& m1, float& l0, float& l1,
    int kb0, int nkb, int sk, int causal, int w0, int w_last, int row0,
    float scale_log2) {
  using namespace hopper;
  constexpr int SUB = kTcSub;
  constexpr int KT = D / 16;                 // k-steps of QK^T
  constexpr int DT = D / 8;                  // output n-tiles
  constexpr int NT = kBK / 8;                // score n-tiles of a key block
  const int lane = threadIdx.x & 31, t4 = lane & 3;

  bool live[SUB];
#pragma unroll
  for (int u = 0; u < SUB; ++u)
    live[u] = !kEdge || (kb0 + u < nkb && !(causal && (kb0 + u) * kBK > w_last));

  float s[SUB][NT][4];                       // raw scores, f32 sums
#pragma unroll
  for (int u = 0; u < SUB; ++u) {
    if (!live[u]) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[u][nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {  // 16 keys: two n-tiles
        uint32_t b[4];
        ldmatrix_x4(b, kst + swz<D>(u * kBK + np * 16 + (lane & 7) +
                                        ((lane >> 4) << 3),
                                    kk * 2 + ((lane >> 3) & 1)));
        mma_bf16(s[u][2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[u][2 * np + 1], qf[kk], b[2], b[3]);
      }
  }

#pragma unroll
  for (int u = 0; u < SUB; ++u) {
    if (!live[u]) continue;
    if (kEdge) {
      const int k0 = (kb0 + u) * kBK;
      // keys past lim0 (lim1) are masked for row0 (row0 + 8)
      const int lim0 = causal ? min(sk, row0 + 1) : sk;
      const int lim1 = causal ? min(sk, row0 + 9) : sk;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + nt * 8 + 2 * t4 + c;
          if (key >= lim0) s[u][nt][c] = kNegInf;
          if (key >= lim1) s[u][nt][2 + c] = kNegInf;
        }
    }
    // the block's row max; scaling by the positive D^-0.5 log2 e after the
    // contraction keeps it the max of the scaled scores
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[u][nt][0], s[u][nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[u][nt][2], s[u][nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the quad holding the row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0 * scale_log2);
    const float n1 = fmaxf(m1, mx1 * scale_log2);
    const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;

    // probabilities exp2(s D^-0.5 log2 e - max): f32 into the denominator,
    // rounded to bf16 (against this block's running max) as the A operand
    // of PV
    uint32_t pa[kBK / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p00 = exp2f(fmaf(s[u][nt][0], scale_log2, -n0));
      const float p01 = exp2f(fmaf(s[u][nt][1], scale_log2, -n0));
      const float p10 = exp2f(fmaf(s[u][nt][2], scale_log2, -n1));
      const float p11 = exp2f(fmaf(s[u][nt][3], scale_log2, -n1));
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(p00, p01);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= c0;
      o[dt][1] *= c0;
      o[dt][2] *= c1;
      o[dt][3] *= c1;
    }
#pragma unroll
    for (int kq = 0; kq < kBK / 16; ++kq)
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {  // 16 output columns
        uint32_t b[4];
        ldmatrix_x4_trans(b, vst + swz<D>(u * kBK + kq * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8,
                                          dp * 2 + (lane >> 4)));
        mma_bf16(o[2 * dp], pa[kq], b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa[kq], b[2], b[3]);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, long long q_sbh,
                     long long q_ss, long long k_sbh, long long k_ss,
                     long long v_sbh, long long v_ss, float* __restrict__ out,
                     float* __restrict__ lse, int sq, int sk,
                     float scale_log2, int causal) {
  using namespace hopper;
  constexpr int BQ = kTcRows, KS = kTcKeys, SUB = kTcSub;
  constexpr int STAGES = kTcStages;
  constexpr int KT = D / 16, DT = D / 8, LD = tc_ld<D>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* ks = qs + BQ * LD;                       // [STAGES][KS][LD]
  bf16* vs = ks + STAGES * KS * LD;              // [STAGES][KS][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  q += bh * q_sbh;
  k += bh * k_sbh;
  v += bh * v_sbh;

  const int q_last = min(q0 + BQ, sq) - 1;   // last stored row of the block
  int nkb = (sk + kBK - 1) / kBK;            // key blocks of kBK
  if (causal) nkb = min(nkb, q_last / kBK + 1);
  const int nst = (nkb + SUB - 1) / SUB;     // ring stages

  copy_rows<BQ, D, kTcThreads>(qs, q, q_ss, q0, sq);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nst) {
      copy_rows<KS, D, kTcThreads>(ks + st * KS * LD, k, k_ss, st * KS,
                                   sk);
      copy_rows<KS, D, kTcThreads>(vs + st * KS * LD, v, v_ss, st * KS,
                                   sk);
    }
    cp_async_commit();                       // one group per stage
  }

  // this warp's rows: w0..w_last (none when the warp is all padding); this
  // thread's two accumulator rows: row0 and row0 + 8
  const int w0 = q0 + warp * 16;
  const int w_last = min(w0 + 15, sq - 1);
  const int row0 = w0 + (lane >> 2), row1 = row0 + 8;
  // stages before this one need no check: all their keys are below Sk and,
  // causal, at or below the warp's first row
  const int plain_stages = min(sk, causal ? w0 + 1 : sk) / KS;

  cp_async_wait<STAGES - 1>();               // the q group has landed
  __syncthreads();
  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    ldmatrix_x4(qf[kk], qs + swz<D>(warp * 16 + (lane & 15),
                                    kk * 2 + (lane >> 4)));

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dt][c] = 0.f;
  // running max (scaled, log2 domain) and this thread's share of the
  // denominator, for row0 and row1; the quad's shares are summed at the end
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < nst; ++j) {
    cp_async_wait<STAGES - 2>();             // stage j has landed
    __syncthreads();                         // ... for every thread, and
                                             // stage j - 1 is consumed
    const int jn = j + STAGES - 1;
    if (jn < nst) {
      const int st = jn % STAGES;
      copy_rows<KS, D, kTcThreads>(ks + st * KS * LD, k, k_ss, jn * KS,
                                   sk);
      copy_rows<KS, D, kTcThreads>(vs + st * KS * LD, v, v_ss, jn * KS,
                                   sk);
    }
    cp_async_commit();
    if (w0 > w_last) continue;               // warp-uniform from here on
    const bf16* kst = ks + (j % STAGES) * KS * LD;
    const bf16* vst = vs + (j % STAGES) * KS * LD;
    if (j < plain_stages)
      flash_stage<D, false>(kst, vst, qf, o, m0, m1, l0, l1, j * SUB, nkb,
                            sk, causal, w0, w_last, row0, scale_log2);
    else
      flash_stage<D, true>(kst, vst, qf, o, m0, m1, l0, l1, j * SUB, nkb, sk,
                           causal, w0, w_last, row0, scale_log2);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  float* ob = out + static_cast<long long>(bh) * sq * D;
  const int t4 = lane & 3;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * t4;
    if (row0 < sq)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(row0) * D + col) =
          make_float2(o[dt][0] / d0, o[dt][1] / d0);
    if (row1 < sq)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(row1) * D + col) =
          make_float2(o[dt][2] / d1, o[dt][3] / d1);
  }
  // the backward's logsumexp, natural log: the running max is in the log2
  // domain of the scaled scores
  if (lse != nullptr && t4 == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    float* lb = lse + static_cast<long long>(bh) * sq;
    if (row0 < sq) lb[row0] = m0 * kLn2 + logf(d0);
    if (row1 < sq) lb[row1] = m1 * kLn2 + logf(d1);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, long long q_sbh,
                   long long q_ss, long long k_sbh, long long k_ss,
                   long long v_sbh, long long v_ss, float* out, float* lse,
                   int bh, int sq, int sk, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * sizeof(float);
  static bool opted_in = false;
  const cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, bytes, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss, out, lse,
      sq, sk, static_cast<float>(1.0 / sqrt(static_cast<double>(D))), causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       long long q_sbh, long long q_ss, long long k_sbh,
                       long long k_ss, long long v_sbh, long long v_ss,
                       float* out, float* lse, int bh, int sq, int sk,
                       int causal, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<D>();
  static bool opted_in = false;
  const cudaError_t err = allow_smem(flash_fwd_mma_kernel<D>, bytes, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kTcRows - 1) / kTcRows, bh);
  const double scale_log2 = 1.4426950408889634 / sqrt(static_cast<double>(D));
  flash_fwd_mma_kernel<D><<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss, out,
      lse, sq, sk, static_cast<float>(scale_log2), causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(bool mma, const void* q, const void* k, const void* v,
                     long long q_sbh, long long q_ss, long long k_sbh,
                     long long k_ss, long long v_sbh, long long v_ss,
                     float* out, float* lse, int bh, int sq, int sk,
                     int causal, cudaStream_t st) {
  return mma ? launch_mma<D>(q, k, v, q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss,
                             out, lse, bh, sq, sk, causal, st)
             : launch<T, D>(q, k, v, q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss,
                            out, lse, bh, sq, sk, causal, st);
}

template <typename T>
cudaError_t dispatch(int d, bool mma, const void* q, const void* k,
                     const void* v, long long q_sbh, long long q_ss,
                     long long k_sbh, long long k_ss, long long v_sbh,
                     long long v_ss, float* out, float* lse, int bh, int sq,
                     int sk, int causal, cudaStream_t st) {
  switch (d) {
    case 16:
      return launch_d<T, 16>(mma, q, k, v, q_sbh, q_ss, k_sbh, k_ss, v_sbh,
                             v_ss, out, lse, bh, sq, sk, causal, st);
    case 32:
      return launch_d<T, 32>(mma, q, k, v, q_sbh, q_ss, k_sbh, k_ss, v_sbh,
                             v_ss, out, lse, bh, sq, sk, causal, st);
    case 64:
      return launch_d<T, 64>(mma, q, k, v, q_sbh, q_ss, k_sbh, k_ss, v_sbh,
                             v_ss, out, lse, bh, sq, sk, causal, st);
    case 96:
      return launch_d<T, 96>(mma, q, k, v, q_sbh, q_ss, k_sbh, k_ss, v_sbh,
                             v_ss, out, lse, bh, sq, sk, causal, st);
    case 128:
      return launch_d<T, 128>(mma, q, k, v, q_sbh, q_ss, k_sbh, k_ss, v_sbh,
                              v_ss, out, lse, bh, sq, sk, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   int bf16_inputs, long long q_sbh,
                                   long long q_ss, long long k_sbh,
                                   long long k_ss, long long v_sbh,
                                   long long v_ss, void* out, void* lse,
                                   int bh, int sq, int sk, int d, int causal,
                                   void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* o = static_cast<float*>(out);
  auto* l = static_cast<float*>(lse);        // null: no logsumexp
  auto st = static_cast<cudaStream_t>(stream);
  // the tensor-core kernel takes bf16 whose rows cp.async can copy
  using flash::rows16;
  const bool mma = bf16_inputs && rows16(q, q_sbh, q_ss) &&
                   rows16(k, k_sbh, k_ss) && rows16(v, v_sbh, v_ss);
  const cudaError_t err =
      bf16_inputs
          ? dispatch<bf16>(d, mma, q, k, v, q_sbh, q_ss, k_sbh, k_ss, v_sbh,
                           v_ss, o, l, bh, sq, sk, causal, st)
          : dispatch<float>(d, false, q, k, v, q_sbh, q_ss, k_sbh, k_ss,
                            v_sbh, v_ss, o, l, bh, sq, sk, causal, st);
  return static_cast<int>(err);
}
