// K4: the frequency-domain adjoint beamformer, float32 accumulation, with the
// dot operands in float32 or rounded to bfloat16.
//
// Replaces the TPU kernel qups_tpu/ops/fdbf_pallas.py::_kernel (launched by
// _adj_call, public entry bf_adjoint_tiled) for sub-slice K4(a): the three
// keep modes ('' summed, 'rx', 'tx'), precision 'f32' and 'bf16', up to 256
// synthesized pulses (and, with keep 'rx', 256 receivers). For every selected bin k (frequency
// fk) and pixel i it computes what
// qups_tpu_torch/ops/fdbf.py::bf_adjoint computes:
//
//   A(i, v)  = sum_m Wtx(i, m) S_k[m, v],    Wtx = e^{-2 pi i frac(fk taut[i, m])}
//   Ahat     = A / ||A(i, :)||               (1 where the norm is 0)
//   y(i, v)  = sum_n Wrx(i, n) X_k[n, v],    Wrx = e^{+2 pi i frac(fk taur[i, n])}
//   b(i)    += sum_v y(i, v) conj(Ahat(i, v))            keep ''
//   b(i, v) += y(i, v) conj(Ahat(i, v))                  keep 'tx'
//   b(i, n) += Wrx(i, n) sum_v conj(Ahat(i, v)) X_k[n, v]   keep 'rx'
//
// The phasors are evaluated directly, sincos of 2 pi frac(fk tau), as K3
// does: no recurrence, so no drift along the band (the TPU kernel's phasor
// recurrence for evenly spaced bins is a later speed item). With 'bf16' the
// operands of the three dots (the phasors Wtx and Wrx, Ahat in keep 'rx',
// and S_k, X_k, which the wrapper passes already rounded) are rounded to
// bfloat16 with round-to-nearest-even, and the products are summed in
// float32, as the TPU kernel's bf16 dots and the plain version do.
//
// What bounds it on the card: the complex multiply-adds, K I (M + N) V of
// them for the two products (4 float32 FMAs each, on the CUDA cores), plus
// K I (M + N) sincos. At 1024^2 pixels x 256 x 256 x 64 bins that is 8.8e12
// complex MACs, about 1 s at the card's float32 FMA peak (computed, not
// measured). The plain version runs the same products as cuBLAS SGEMMs.
//
// The design: one block of 256 threads (8 warps) owns BI = 32 pixels and
// loops over the bins. Lane l of every warp is pixel i0 + l; warp w owns the
// R contiguous columns w R .. w R + R - 1 of the block's (BI x V) products
// (R = 1, 4, 16 or 32, at least V / 8), so each thread accumulates R
// complex values in registers. Each product runs over chunks of LC = 16
// rows: the block evaluates the chunk's phasors of its pixels (each phasor
// once per bin) and copies the chunk of S_k or X_k rows, with coalesced
// loads, into shared memory; then every thread runs its columns over the
// chunk, reading two complex values of the right operand per 16-byte
// shared load (a broadcast within the warp) for 8 FMAs. The row norm
// couples all v of a pixel: each thread sums |A|^2 over its columns, the 8
// warps' partial sums meet in shared memory, and every thread then holds
// the norm of its pixel. In keep '' and 'tx' the rx product y has the same
// thread layout as A, so y conj(Ahat) is formed in registers; keep 'tx'
// adds it to the output (each (i, v) belongs to one thread: no atomics),
// keep '' sums it per thread across bins and the warps' sums meet once at
// the end. In keep 'rx' the block stores Ahat (V x BI) in shared memory,
// and the third product z = conj(Ahat) X_k^T runs the same way with warp w
// on receivers w R .. w R + R - 1. The (I, M) and (I, N) delay tables come
// transposed, (M, I) and (N, I), so that a chunk's 32 pixels are one
// 128-byte row. Nothing is atomic; the result is deterministic.
// Tensor-core products for 'bf16', more pixels per thread and the phasor
// recurrence are later work.
//
// Numerics: built with -fmad=false so that the phase arithmetic rounds as
// the plain version's; the multiply-adds of the products use explicit
// fmaf, which that flag does not split.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BI = 32;       // pixels per block: one per lane
constexpr int NW = 8;        // warps per block; warp w owns columns w R .. w R + R - 1
constexpr int LC = 16;       // rows of the products' operands per shared-memory chunk
constexpr float TWO_PI = 6.283185307179586f;

enum Keep { SUM = 0, KEEP_RX = 1, KEEP_TX = 2 };

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// e^{sign 2 pi i frac(fk tau)}, as fdbf.py::phasor builds it
template <bool BF16>
__device__ __forceinline__ float2 phasor(float fk, float tau, float sign) {
  const float u = fk * tau;
  const float th = (u - floorf(u)) * TWO_PI;
  float sn, cs;
  sincosf(th, &sn, &cs);
  float2 p = make_float2(cs, sign * sn);
  if (BF16) p = make_float2(bf16r(p.x), bf16r(p.y));
  return p;
}

// acc += p * q (complex), with explicit FMAs
__device__ __forceinline__ void cmac(float2& acc, float2 p, float2 q) {
  acc.x = fmaf(p.x, q.x, acc.x);
  acc.x = fmaf(-p.y, q.y, acc.x);
  acc.y = fmaf(p.x, q.y, acc.y);
  acc.y = fmaf(p.y, q.x, acc.y);
}

// acc[r] += sum_l P(i0 + lane, l) Q[l, w R + r] over l < L, Q (L, J)
// row-major: the block stages a chunk of LC rows of P (BI x LC, from
// fillp(l, ii)) and of Q (LC x 8R, zero past column J) in shared memory,
// with coalesced loads, then each warp runs its R contiguous columns over
// the chunk, two complex values of Q per 16-byte shared load.
template <int R, class FillP>
__device__ __forceinline__ void block_gemm(float2 (&acc)[R], float2 (*P)[BI],
                                           float2* Qs, const float2* __restrict__ Q,
                                           int L, int J, FillP fillp) {
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  constexpr int JP = NW * R;
  for (int l0 = 0; l0 < L; l0 += LC) {
    const int lc = L - l0 < LC ? L - l0 : LC;
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < LC * BI; e += NW * 32) {
      const int l = e / BI, ii = e % BI;
      P[l][ii] = l < lc ? fillp(l0 + l, ii) : make_float2(0.f, 0.f);
    }
    for (int e = tid; e < LC * JP; e += NW * 32) {
      const int l = e / JP, j = e % JP;
      Qs[e] = (l < lc && j < J) ? Q[(int64_t)(l0 + l) * J + j] : make_float2(0.f, 0.f);
    }
    __syncthreads();
    for (int l = 0; l < lc; ++l) {
      const float2 p = P[l][lane];
      const float2* q = Qs + l * JP + w * R;
      if constexpr (R == 1) {
        cmac(acc[0], p, q[0]);
      } else {
#pragma unroll
        for (int r = 0; r < R; r += 2) {
          const float4 q2 = *reinterpret_cast<const float4*>(q + r);
          cmac(acc[r], p, make_float2(q2.x, q2.y));
          cmac(acc[r + 1], p, make_float2(q2.z, q2.w));
        }
      }
    }
  }
}

template <int KEEP, int R, bool BF16>
__global__ void __launch_bounds__(NW * 32)
adjoint_k4_kernel(const float* __restrict__ fvals,  // (K,) bin frequencies [Hz]
                  const float* __restrict__ taur,   // (N, I) [s]
                  const float* __restrict__ taut,   // (M, I) [s]
                  const float2* __restrict__ S,     // (K, M, V)
                  const float2* __restrict__ X,     // (K, N, V); (K, V, N) for KEEP_RX
                  float2* __restrict__ out,         // (I,) | (I, N) | (I, V)
                  int64_t I, int N, int M, int V, int K) {
  extern __shared__ float4 smem[];  // Q chunk (LC, 8R); then Ahat (V, BI) for KEEP_RX
  float2* Qs = reinterpret_cast<float2*>(smem);
  float2* Ash = Qs + LC * NW * R;
  __shared__ float2 P[LC][BI];
  __shared__ float red[NW][BI];
  __shared__ float2 fin[NW][BI];
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int64_t i0 = (int64_t)blockIdx.x * BI, i = i0 + lane;
  float2 bsum = make_float2(0.f, 0.f);

  for (int k = 0; k < K; ++k) {
    const float fk = fvals[k];
    const float2* __restrict__ Sk = S + (int64_t)k * M * V;
    const float2* __restrict__ Xk = X + (int64_t)k * N * V;

    // tx steering A = Wtx S_k, and its row norm
    float2 a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = make_float2(0.f, 0.f);
    block_gemm<R>(a, P, Qs, Sk, M, V, [&](int m, int ii) {
      return i0 + ii < I ? phasor<BF16>(fk, taut[(int64_t)m * I + i0 + ii], -1.f)
                         : make_float2(0.f, 0.f);
    });
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) part = part + (a[r].x * a[r].x + a[r].y * a[r].y);
    red[w][lane] = part;
    __syncthreads();
    float nrm2 = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) nrm2 = nrm2 + red[ww][lane];
    const float nrm = sqrtf(nrm2);
    const float inv = 1.f / (nrm == 0.f ? 1.f : nrm);
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = make_float2(a[r].x * inv, a[r].y * inv);

    if (KEEP != KEEP_RX) {
      // rx adjoint y = Wrx X_k in the layout of A; y conj(Ahat) in registers
      float2 y[R];
#pragma unroll
      for (int r = 0; r < R; ++r) y[r] = make_float2(0.f, 0.f);
      block_gemm<R>(y, P, Qs, Xk, N, V, [&](int n, int ii) {
        return i0 + ii < I ? phasor<BF16>(fk, taur[(int64_t)n * I + i0 + ii], 1.f)
                           : make_float2(0.f, 0.f);
      });
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int v = w * R + r;
        if (v >= V) continue;
        const float2 b = make_float2(y[r].x * a[r].x + y[r].y * a[r].y,
                                     y[r].y * a[r].x - y[r].x * a[r].y);
        if (KEEP == SUM) {
          bsum = make_float2(bsum.x + b.x, bsum.y + b.y);
        } else if (i < I) {
          float2* o = out + i * V + v;
          *o = make_float2(o->x + b.x, o->y + b.y);
        }
      }
    } else {
      // z = conj(Ahat) X_k^T with warp w on receivers n = w R + r
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int v = w * R + r;
        if (v < V) Ash[v * BI + lane] = BF16 ? make_float2(bf16r(a[r].x), bf16r(a[r].y)) : a[r];
      }
      float2 z[R];
#pragma unroll
      for (int r = 0; r < R; ++r) z[r] = make_float2(0.f, 0.f);
      block_gemm<R>(z, P, Qs, Xk, V, N, [&](int v, int ii) {
        const float2 ah = Ash[v * BI + ii];
        return make_float2(ah.x, -ah.y);
      });
      if (i < I) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int n = w * R + r;
          if (n >= N) continue;
          const float2 p = phasor<false>(fk, taur[(int64_t)n * I + i], 1.f);
          float2* o = out + i * N + n;
          *o = make_float2(o->x + (p.x * z[r].x - p.y * z[r].y),
                           o->y + (p.x * z[r].y + p.y * z[r].x));
        }
      }
    }
    __syncthreads();  // red, P and Ash are reused by the next bin
  }

  if (KEEP == SUM) {
    fin[w][lane] = bsum;
    __syncthreads();
    if (w == 0 && i < I) {
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) s = make_float2(s.x + fin[ww][lane].x, s.y + fin[ww][lane].y);
      out[i] = s;
    }
  }
}

struct Args {
  const float *fvals, *taur, *taut;
  const float2 *S, *X;
  float2* out;
  int64_t I;
  int N, M, V, K;
};

template <int KEEP, int R, bool BF16>
cudaError_t launch(const Args& a, cudaStream_t s) {
  auto kern = adjoint_k4_kernel<KEEP, R, BF16>;
  const size_t smem = ((size_t)LC * NW * R + (KEEP == KEEP_RX ? (size_t)a.V * BI : 0))
                      * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.I + BI - 1) / BI)), block(NW * 32);
  kern<<<grid, block, smem, s>>>(a.fvals, a.taur, a.taut, a.S, a.X, a.out,
                                  a.I, a.N, a.M, a.V, a.K);
  return cudaGetLastError();
}

template <int KEEP, bool BF16>
cudaError_t launch_r(int R, const Args& a, cudaStream_t s) {
  switch (R) {
    case 1: return launch<KEEP, 1, BF16>(a, s);
    case 4: return launch<KEEP, 4, BF16>(a, s);
    case 16: return launch<KEEP, 16, BF16>(a, s);
    case 32: return launch<KEEP, 32, BF16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int KEEP>
cudaError_t launch_p(int bf16, int R, const Args& a, cudaStream_t s) {
  return bf16 ? launch_r<KEEP, true>(R, a, s) : launch_r<KEEP, false>(R, a, s);
}

}  // namespace

// Launch K4 on `stream` of device `device`. fvals (K,); taur (N, I) and taut
// (M, I) the transposed delay tables [s]; S (K, M, V) and X (K, N, V), or
// (K, V, N) for keep 1 ('rx'), interleaved complex64; out complex64 (I,)
// for keep 0 (''), (I, N) for 'rx' and (I, V) for keep 2 ('tx'), zeroed by
// the caller for 'rx' and 'tx'. R is the columns per thread, one of 1, 4,
// 16, 32, at least ceil(V / 8) (and ceil(N / 8) for 'rx'). Returns the
// cudaError_t of the launch; 0 is success.
extern "C" int adjoint_k4(const float* fvals, const float* taur,
                          const float* taut, const void* S, const void* X,
                          void* out, long long I, int N, int M, int V, int K,
                          int keep, int bf16, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (I <= 0) return (int)cudaSuccess;
  if (N <= 0 || M <= 0 || V <= 0 || K <= 0 || V > NW * R
      || (keep == KEEP_RX && N > NW * R))
    return (int)cudaErrorInvalidValue;
  const Args a{fvals, taur, taut, (const float2*)S, (const float2*)X,
               (float2*)out, (int64_t)I, N, M, V, K};
  cudaStream_t s = (cudaStream_t)stream;
  switch (keep) {
    case SUM: err = launch_p<SUM>(bf16, R, a, s); break;
    case KEEP_RX: err = launch_p<KEEP_RX>(bf16, R, a, s); break;
    case KEEP_TX: err = launch_p<KEEP_TX>(bf16, R, a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
