// K3: the frequency-domain Green's-function GEMM, float32, complex output.
//
// Replaces the TPU kernel qups_tpu/ops/greens_freq_pallas.py::_kernel
// (launched by _gf_call, public entries freq_gemm_pallas, which
// qups_tpu/ops/greens_freq.py::greens_freq calls, and simus_spectrum_pallas,
// which qups_tpu/ops/simus.py::simus_fsa calls). For every DFT bin k of the
// synthesis band k0 .. k0+F-1 it computes
//
//   G[k, n, m] = sum_s A_k[s, n] B_k[s, m]
//   A_k[s, n]  = D1 * sum_e w1[s, n, e] exp(-att k q1[s, n, e]) e^{-i 2 pi frac(k q1[s, n, e])}
//   B_k[s, m]  = D2 * sum_e w2[s, m, e] exp(-att k q2[s, m, e]) e^{-i 2 pi frac(k q2[s, m, e])}
//
// with q = cinv fs r / L the phase slope of a path of length r per bin
// (q < 1 for the wrap-free FFT length L), w the 1/r losses with the
// scatterer amplitudes folded into w2, and e the sub-elements. The angle is
// built as 2 pi frac(k q), as the TPU kernel builds it, so that it stays
// accurate at high bins. It computes exactly what
// qups_tpu_torch/ops/greens_freq_cuda.py::freq_gemm_plain computes.
//
// Two compile-time options, as the TPU kernel has them:
// * DIR (K3(c), `has_dir`, the simus directivity): D1 = sinc(s1[s, n] k),
//   D2 = sinc(s2[s, m] k), with the TPU kernel's sinc (|pi x| < 1e-6 -> 1),
//   applied to the element's summed phasor; otherwise D = 1 (K3(a)).
// * BF16 (K3(b), `precision='bf16'`): each staged operand, after the
//   sub-element sum and the directivity weight, is rounded to bfloat16
//   (round to nearest even) and back; the products and sums stay float32 on
//   the CUDA cores. The tensor cores are later speed work.
//
// What bounds it on the card: the complex multiply-adds, F * S * N * M of
// them (4 float32 FMAs each, on the CUDA cores: the GEMM runs in float32,
// not on the tensor cores), plus one sincos per phasor (and one sinf per
// operand with DIR). At the sim->image size of chip_smoke.py (5
// scatterers, 128 x 128 elements, a few hundred bins) the kernel is tiny
// and the launch and the FFT synthesis dominate; at speckle sizes (1e4-1e5
// scatterers) the multiply-adds do.
//
// What this simple design does about that: one thread block owns a 64 x 64
// (n, m) tile of one bin. It walks the scatterers in chunks of 16: its 256
// threads first evaluate the chunk's phasors of this bin directly (sincos,
// no recurrence, so there is no drift along the band) into shared memory,
// then each thread accumulates a 4 x 4 micro-tile of complex outputs in
// registers over the chunk. Each output is written once: no atomics, so the
// result is deterministic. Several bins per block with the phasor
// recurrence (fewer sincos), wider tiles and tensor-core (TF32 / bf16)
// variants are later work.
//
// Numerics: built with -fmad=false, as the plain version rounds; sincosf and
// sinf are the accurate routines without fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;   // n and m extent of a block's output tile
constexpr int SC = 16;     // scatterers per shared-memory chunk
constexpr int TPB = 16;    // threads per block edge: 16 x 16 = 256
constexpr int MT = TILE / TPB;  // micro-tile edge per thread (4)
constexpr float TWO_PI = 6.283185307179586f;
constexpr float PI_F = 3.14159265358979323846f;

// the TPU kernel's sinc: sin(pi x) / (pi x), 1 where |pi x| < 1e-6
__device__ __forceinline__ float sinc(float x) {
  const float px = PI_F * x;
  return fabsf(px) < 1e-6f ? 1.f : sinf(px) / px;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the staged operand: the summed phasor, times the directivity sinc(s k)
// with DIR, rounded to bfloat16 with BF16
template <bool DIR, bool BF16>
__device__ __forceinline__ float2 operand(float2 v, const float* __restrict__ sl,
                                          float kf) {
  if (DIR) {
    const float g = sinc(__ldg(sl) * kf);
    v.x = v.x * g;
    v.y = v.y * g;
  }
  if (BF16) {
    v.x = bf16_round(v.x);
    v.y = bf16_round(v.y);
  }
  return v;
}

// sum_e w exp(-att k q) e^{-i 2 pi frac(k q)} for one (s, element)
__device__ __forceinline__ float2 phasor(const float* __restrict__ q,
                                         const float* __restrict__ w, int E,
                                         float kf, float att_k) {
  float re = 0.f, im = 0.f;
  for (int e = 0; e < E; ++e) {
    const float qe = __ldg(q + e);
    const float u = kf * qe;
    const float th = (u - floorf(u)) * TWO_PI;
    float sn, cs;
    sincosf(th, &sn, &cs);
    float mag = __ldg(w + e);
    if (att_k != 0.f) mag = mag * expf(att_k * qe);
    re = re + mag * cs;
    im = im - mag * sn;
  }
  return make_float2(re, im);
}

template <bool DIR, bool BF16>
__global__ void __launch_bounds__(TPB * TPB)
freq_gemm_kernel(const float* __restrict__ q1, const float* __restrict__ w1,  // (S, N, E1)
                 const float* __restrict__ q2, const float* __restrict__ w2,  // (S, M, E2)
                 const float* __restrict__ s1, const float* __restrict__ s2,  // (S, N), (S, M)
                 float2* __restrict__ out,                                   // (F, N, M)
                 int S, int N, int M, int E1, int E2, int k0, float att) {
  __shared__ float2 A[SC][TILE];
  __shared__ float2 B[SC][TILE];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TPB + tx;
  const int m0 = blockIdx.x * TILE, n0 = blockIdx.y * TILE;
  const int f = blockIdx.z;
  const float kf = (float)(k0 + f);
  const float att_k = -att * kf;

  float2 acc[MT][MT];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < MT; ++b) acc[a][b] = make_float2(0.f, 0.f);

  for (int s0 = 0; s0 < S; s0 += SC) {
    for (int idx = tid; idx < SC * TILE; idx += TPB * TPB) {
      const int ss = idx / TILE, j = idx % TILE;
      const int s = s0 + ss;
      const int n = n0 + j, m = m0 + j;
      float2 va = make_float2(0.f, 0.f), vb = make_float2(0.f, 0.f);
      if (s < S && n < N) {
        const int64_t o = ((int64_t)s * N + n) * E1;
        va = operand<DIR, BF16>(phasor(q1 + o, w1 + o, E1, kf, att_k),
                                s1 + ((int64_t)s * N + n), kf);
      }
      if (s < S && m < M) {
        const int64_t o = ((int64_t)s * M + m) * E2;
        vb = operand<DIR, BF16>(phasor(q2 + o, w2 + o, E2, kf, att_k),
                                s2 + ((int64_t)s * M + m), kf);
      }
      A[ss][j] = va;
      B[ss][j] = vb;
    }
    __syncthreads();
#pragma unroll 4
    for (int ss = 0; ss < SC; ++ss) {
      float2 av[MT], bv[MT];
#pragma unroll
      for (int a = 0; a < MT; ++a) av[a] = A[ss][ty + TPB * a];
#pragma unroll
      for (int b = 0; b < MT; ++b) bv[b] = B[ss][tx + TPB * b];
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < MT; ++b) {
          acc[a][b].x = acc[a][b].x + (av[a].x * bv[b].x - av[a].y * bv[b].y);
          acc[a][b].y = acc[a][b].y + (av[a].x * bv[b].y + av[a].y * bv[b].x);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < MT; ++a) {
    const int n = n0 + ty + TPB * a;
    if (n >= N) continue;
#pragma unroll
    for (int b = 0; b < MT; ++b) {
      const int m = m0 + tx + TPB * b;
      if (m < M) out[((int64_t)f * N + n) * M + m] = acc[a][b];
    }
  }
}

}  // namespace

// Launch K3 on `stream` (a cudaStream_t) of device `device`: G (F, N, M)
// interleaved complex64 for bins k0 .. k0+F-1. `s1` and `s2` are both null
// (no directivity) or both set; `bf16` != 0 rounds the operands. Returns the
// cudaError_t of the launch (cudaGetLastError right after each grid); 0 is
// success.
extern "C" int freq_gemm_k3(const float* q1, const float* w1, const float* q2,
                            const float* w2, const float* s1, const float* s2,
                            void* out, int S, int N, int M, int E1, int E2,
                            int k0, int F, float att, int bf16, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (F <= 0 || N <= 0 || M <= 0) return (int)cudaSuccess;
  if (S < 0 || E1 <= 0 || E2 <= 0 || (s1 == nullptr) != (s2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool dir = s1 != nullptr;
  auto kern = dir ? (bf16 ? freq_gemm_kernel<true, true> : freq_gemm_kernel<true, false>)
                  : (bf16 ? freq_gemm_kernel<false, true> : freq_gemm_kernel<false, false>);
  const dim3 block(TPB, TPB);
  // one bin per grid z-index; gridDim.z is at most 65535
  for (int f0 = 0; f0 < F; f0 += 65535) {
    const int nf = F - f0 < 65535 ? F - f0 : 65535;
    const dim3 grid((unsigned)((M + TILE - 1) / TILE),
                    (unsigned)((N + TILE - 1) / TILE), (unsigned)nf);
    kern<<<grid, block, 0, (cudaStream_t)stream>>>(
        q1, w1, q2, w2, s1, s2, (float2*)out + (int64_t)f0 * N * M, S, N, M,
        E1, E2, k0 + f0, att);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
