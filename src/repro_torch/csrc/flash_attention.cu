// Flash-2 attention forward, written for Hopper (sm_90a).
//
//   out[b, i, :] = sum_j softmax_j(q[b, i, :] . k[b, j, :] * D^-0.5) v[b, j, :]
//
// over (BH, S, D) operands, all f32 or all bf16, with an optional causal
// mask (key j > query i masked with NEG_INF = -1e30, as in the reference).
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd, body _flash_fwd_kernel) and keeps its arithmetic:
// scores are f32 sums of products of the inputs (exact for bf16), scaled
// after the contraction; an online softmax over key blocks of kBK carries the
// running max, denominator (of the f32 probabilities) and accumulator; the
// probabilities are rounded to v's type before the PV product, against the
// running max of their block; the denominator is floored at 1e-30.
//
// On the whisper encoder (BH = 6, Sq = Sk = 1500, D = 64) one call is 3.5 GFLOP
// (QK and PV) over 3.5 MB of bf16 inputs and a 2.3 MB f32 output: bound by
// operations. This first kernel runs them outside the tensor cores, as f32
// FMAs, so that bf16 and f32 inputs share one code path:
//   * a block owns kBQ = 64 query rows of one (batch, head) and loops over
//     the key blocks inside the block (the TPU kernel's sequential grid axis
//     becomes a loop): the q tile stays in shared memory, each k and v tile
//     is staged once per block;
//   * 256 threads as 16 x 16: a thread computes a 4 x 4 score tile (4 rows,
//     4 keys) and owns the same 4 rows' D/16 output columns, so the row
//     statistics a thread needs for the rescale are the ones it reduced,
//     across the 16 threads of its half-warp with shuffles;
//   * the rounded probabilities go through shared memory, row-major, for the
//     PV product; the score tile never touches device memory;
//   * ragged Sq and Sk are masked in the kernel (1500 is no multiple of 64):
//     keys past Sk score NEG_INF, query rows past Sq are not stored. Key
//     blocks wholly above the causal diagonal are skipped: every row has
//     seen key 0 by then, so they would add exactly zero.
// Built for head sizes D = 64 (the Whisper ladder) and 16 (the smoke
// configs); tensor cores (mma.sync / wgmma on bf16 q, k, v) are later work.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing, runs on
// the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64, kBK = 64;            // query rows, keys per block step
constexpr int kThreads = 256;                // 16 x 16, 4 x 4 scores each
constexpr int kLdP = kBK + 4;                // probability row, float4-aligned
constexpr float kNegInf = -1e30f;

// p cast to v's type and back
__device__ __forceinline__ float as_type(float p, const float*) { return p; }
__device__ __forceinline__ float as_type(float p, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <int D>
constexpr int smem_floats() {
  return D * kBQ                                          // q, d-major
         + (D * kBK > kBQ * kLdP ? D * kBK : kBQ * kLdP)  // k (d-major) / p
         + kBK * D;                                       // v, key-major
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, long long q_sbh, long long q_ss,
                 long long k_sbh, long long k_ss, long long v_sbh,
                 long long v_ss, float* __restrict__ out, int sq, int sk,
                 float scale, int causal) {
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
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, long long q_sbh,
                   long long q_ss, long long k_sbh, long long k_ss,
                   long long v_sbh, long long v_ss, float* out, int bh, int sq,
                   int sk, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * sizeof(float);
  static bool opted_in = false;              // above 48 KB only after opt-in
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss, out, sq,
      sk, static_cast<float>(1.0 / sqrt(static_cast<double>(D))), causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     long long q_sbh, long long q_ss, long long k_sbh,
                     long long k_ss, long long v_sbh, long long v_ss,
                     float* out, int bh, int sq, int sk, int causal,
                     cudaStream_t st) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss,
                           out, bh, sq, sk, causal, st);
    case 64:
      return launch<T, 64>(q, k, v, q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss,
                           out, bh, sq, sk, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   int bf16_inputs, long long q_sbh,
                                   long long q_ss, long long k_sbh,
                                   long long k_ss, long long v_sbh,
                                   long long v_ss, void* out, int bh, int sq,
                                   int sk, int d, int causal, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16_inputs
          ? dispatch<bf16>(d, q, k, v, q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss,
                           o, bh, sq, sk, causal, st)
          : dispatch<float>(d, q, k, v, q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss,
                            o, bh, sq, sk, causal, st);
  return static_cast<int>(err);
}
