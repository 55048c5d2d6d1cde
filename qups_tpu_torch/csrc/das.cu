// K1: geometry-mode delay-and-sum, summed output, float32 traces, real or
// complex (interleaved complex64, such as the analytic traces greens returns).
//
// Replaces the TPU kernel qups_tpu/ops/das_pallas.py::_kernel in geometry
// mode (launched by _das_call, public entry das_tiled). It computes exactly
// what qups_tpu_torch/ops/das.py::das computes for that case:
//
//   dv  = rv.nv (plane) | |rv| (diverging) | copysign(|rv|, rv.nv) (virtual),
//         rv = p_i - pv_m
//   dr  = |p_i - pr_n|
//   tau = cinv * (dv + dr) - t0_m,   ti = tau * fs
//   out_i = sum_{m,n} sample(x[m, n, :], ti)   for 0 <= ti <= T-1, else 0
//
// with the samplers of ops/interp.py: nearest (round half to even), linear,
// cubic (Catmull-Rom) and lanczos3, taps clamped to [0, T-1]. Complex traces
// (no remodulation, fmod = 0) take the same delays and tap weights; the real
// and imaginary parts are summed in two float32 accumulators.
//
// What bounds it on the card: the trace-sample reads. At the headline size
// (1024^2 pixels x 256 tx x 256 rx) there are about 6.9e10 pixel*tx*rx terms,
// each with 4 data-dependent reads for cubic (2 for linear), about 30
// float32 instructions of delay and weight arithmetic, and one sqrt. The
// trace set (T x N x M floats, 1 GiB at T = 4096) is far larger than L2, so
// the reads must come from L1/L2 for the kernel to approach the arithmetic
// bound.
//
// What this simple design does about that: one thread owns one pixel and
// neighbouring threads take neighbouring pixels, so the 32 threads of a warp
// read nearby samples of the same trace at the same (m, n) step: their
// reads fall into a few cache lines. The transmit loop is outer, so dv is
// computed once per (pixel, m), and the 4 MiB of traces of one transmit
// (T x N floats) are what all resident warps read at about the same time,
// which L2 holds. Each thread sums in registers and writes its pixel once:
// no atomics, so the result is deterministic. Trace windows in shared
// memory, TMA and several pixels per thread are later work.
//
// Numerics: the delay arithmetic must round exactly as the plain PyTorch
// version does, or the nearest sampler and the validity edges take another
// sample. The build passes -fmad=false so that nvcc does not contract
// a*b+c into an FMA (eager PyTorch never does), and the sums are written in
// the plain version's order. sqrtf is IEEE-rounded without fast math.

// K2: LUT-mode delay-and-sum (das_lut_k2 below), the same sampled sum with
// the delays read from tables instead of computed from geometry:
//
//   ti = ((tau_tx[m, i] + tau_rx[n, i]) - t0_m) * fs
//
// in exactly this order, as qups_tpu_torch/ops/das.py::das_lut computes it
// (the K2(a) sub-slice: summed output, float32 or complex64 traces, no
// remodulation, scalar or per-transmit t0, the four samplers). It replaces
// the TPU kernel qups_tpu/ops/das_pallas.py::_kernel with lut=True
// (launched by _das_lut_call, public entry das_lut_tiled), and shares K1's
// samplers (sample, tap) so that both take a sample the same way.
//
// What bounds K2 beyond K1's trace reads: the table reads. The wrapper
// stores the tables transposed, tau_rx as (N, I) and tau_tx as (M, I), so
// that the 32 threads of a warp (32 neighbouring pixels) read 128
// contiguous bytes at one (m, n). A loop that read tau_rx[n, i] once per
// (pixel, m, n) would stream the whole (N, I) table M times: 256 GiB at
// 1024^2 pixels x 256 x 256, ~80 ms of HBM time alone (computed from
// 3.35 TB/s). So a thread holds a chunk of K2_MC transmits' tau_tx in
// registers and loops receivers outside the chunk: each tau_rx value is
// read once per chunk, M / K2_MC times in all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum TxModel { PLANE = 0, DIVERGING = 1, VIRTUAL = 2 };
enum Method { NEAREST = 0, LINEAR = 1, CUBIC = 2, LANCZOS3 = 3 };

// The trace value type: float (real) or float2 (complex, re/im interleaved).
__device__ __forceinline__ float scale(float v, float w) { return v * w; }
__device__ __forceinline__ float2 scale(float2 v, float w) {
  return make_float2(v.x * w, v.y * w);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }

template <typename V>
__device__ __forceinline__ V tap(const V* __restrict__ xn, int k, int T) {
  k = k < 0 ? 0 : (k > T - 1 ? T - 1 : k);
  return __ldg(xn + k);
}

// ops/interp.py::_lanczos_w: 2 sin(pi u) sin(pi u / 2) / (pi u)^2, 1 at u = 0
__device__ __forceinline__ float lanczos_w(float u) {
  if (u == 0.f) return 1.f;
  const float pu = 3.14159265358979323846f * u;
  return 2.f * sinf(pu) * sinf(pu / 2.f) / (pu * pu);
}

// Sample trace xn (T values) at fractional index ti, 0 <= ti <= T-1.
template <int METHOD, typename V>
__device__ __forceinline__ V sample(const V* __restrict__ xn, float ti, int T) {
  if constexpr (METHOD == NEAREST) {
    return tap(xn, (int)rintf(ti), T);
  }
  const float i0f = floorf(ti);
  const float u = ti - i0f;
  const int i0 = (int)i0f;
  if constexpr (METHOD == LINEAR) {
    return add(scale(tap(xn, i0, T), 1.f - u), scale(tap(xn, i0 + 1, T), u));
  }
  float w0, w1, w2, w3;
  if constexpr (METHOD == CUBIC) {
    w0 = 0.5f * (u * (-1.f + u * (2.f - u)));
    w1 = 0.5f * (2.f + u * u * (-5.f + 3.f * u));
    w2 = 0.5f * (u * (1.f + u * (4.f - 3.f * u)));
    w3 = 0.5f * (u * u * (u - 1.f));
  } else {
    w0 = lanczos_w(u + 1.f);
    w1 = lanczos_w(u);
    w2 = lanczos_w(u - 1.f);
    w3 = lanczos_w(u - 2.f);
  }
  const int b = i0 - 1;
  return add(add(add(scale(tap(xn, b, T), w0), scale(tap(xn, b + 1, T), w1)),
                 scale(tap(xn, b + 2, T), w2)),
             scale(tap(xn, b + 3, T), w3));
}

template <int TX, int METHOD, typename V>
__global__ void __launch_bounds__(256)
das_k1_kernel(const V* __restrict__ x,        // (M, N, T)
              const float* __restrict__ pix,  // (I, 3)
              const float* __restrict__ pr,   // (N, 3)
              const float* __restrict__ pv,   // (M, 3)
              const float* __restrict__ nv,   // (M, 3)
              const float* __restrict__ t0,   // (M,)
              V* __restrict__ out,            // (I,)
              int64_t I, int N, int M, int T, float cinv, float fs) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= I) return;
  const float px = pix[3 * i], py = pix[3 * i + 1], pz = pix[3 * i + 2];
  const float tmax = (float)(T - 1);
  V acc = zero<V>();
  for (int m = 0; m < M; ++m) {
    const float rx = px - __ldg(pv + 3 * m);
    const float ry = py - __ldg(pv + 3 * m + 1);
    const float rz = pz - __ldg(pv + 3 * m + 2);
    float dv;
    if constexpr (TX == PLANE) {
      dv = rx * __ldg(nv + 3 * m) + ry * __ldg(nv + 3 * m + 1) + rz * __ldg(nv + 3 * m + 2);
    } else {
      const float r = sqrtf(rx * rx + ry * ry + rz * rz);
      if constexpr (TX == DIVERGING) {
        dv = r;
      } else {
        const float rn = rx * __ldg(nv + 3 * m) + ry * __ldg(nv + 3 * m + 1)
                         + rz * __ldg(nv + 3 * m + 2);
        dv = copysignf(r, rn);
      }
    }
    const float t0m = __ldg(t0 + m);
    const V* __restrict__ xm = x + (int64_t)m * N * T;
    for (int n = 0; n < N; ++n) {
      const float dx = px - __ldg(pr + 3 * n);
      const float dy = py - __ldg(pr + 3 * n + 1);
      const float dz = pz - __ldg(pr + 3 * n + 2);
      const float dr = sqrtf(dx * dx + dy * dy + dz * dz);
      const float ti = (cinv * (dv + dr) - t0m) * fs;
      if (!(ti >= 0.f && ti <= tmax)) continue;  // also drops NaN
      acc = add(acc, sample<METHOD>(xm + (int64_t)n * T, ti, T));
    }
  }
  out[i] = acc;
}

struct Args {
  const float *pix, *pr, *pv, *nv, *t0;
  int64_t I;
  int N, M, T;
  float cinv, fs;
};

template <int TX, int METHOD, typename V>
void launch(const void* x, void* out, const Args& a, dim3 grid, dim3 block,
            cudaStream_t s) {
  das_k1_kernel<TX, METHOD, V><<<grid, block, 0, s>>>(
      (const V*)x, a.pix, a.pr, a.pv, a.nv, a.t0, (V*)out, a.I, a.N, a.M, a.T,
      a.cinv, a.fs);
}

template <int TX, typename V>
cudaError_t launch_method(int method, const void* x, void* out, const Args& a,
                          dim3 grid, dim3 block, cudaStream_t s) {
  switch (method) {
    case NEAREST: launch<TX, NEAREST, V>(x, out, a, grid, block, s); break;
    case LINEAR: launch<TX, LINEAR, V>(x, out, a, grid, block, s); break;
    case CUBIC: launch<TX, CUBIC, V>(x, out, a, grid, block, s); break;
    case LANCZOS3: launch<TX, LANCZOS3, V>(x, out, a, grid, block, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_tx(int tx_model, int method, const void* x, void* out,
                      const Args& a, dim3 grid, dim3 block, cudaStream_t s) {
  switch (tx_model) {
    case PLANE: return launch_method<PLANE, V>(method, x, out, a, grid, block, s);
    case DIVERGING: return launch_method<DIVERGING, V>(method, x, out, a, grid, block, s);
    case VIRTUAL: return launch_method<VIRTUAL, V>(method, x, out, a, grid, block, s);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int K2_MC = 16;  // transmits per register chunk of tau_tx

template <int METHOD, typename V>
__global__ void __launch_bounds__(256)
das_k2_kernel(const V* __restrict__ x,         // (M, N, T)
              const float* __restrict__ taur,  // (N, I)
              const float* __restrict__ taut,  // (M, I)
              const float* __restrict__ t0,    // (M,)
              V* __restrict__ out,             // (I,)
              int64_t I, int N, int M, int T, float fs) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= I) return;
  const float tmax = (float)(T - 1);
  V acc = zero<V>();
  for (int m0 = 0; m0 < M; m0 += K2_MC) {
    const int mc = M - m0 < K2_MC ? M - m0 : K2_MC;
    float tt[K2_MC], t0c[K2_MC];
#pragma unroll
    for (int j = 0; j < K2_MC; ++j) {
      tt[j] = j < mc ? taut[(int64_t)(m0 + j) * I + i] : 0.f;
      t0c[j] = j < mc ? __ldg(t0 + m0 + j) : 0.f;
    }
    for (int n = 0; n < N; ++n) {
      const float r = taur[(int64_t)n * I + i];
      const V* __restrict__ xn = x + ((int64_t)m0 * N + n) * T;
#pragma unroll
      for (int j = 0; j < K2_MC; ++j) {
        if (j >= mc) break;
        const float ti = ((tt[j] + r) - t0c[j]) * fs;
        if (!(ti >= 0.f && ti <= tmax)) continue;  // also drops NaN
        acc = add(acc, sample<METHOD>(xn + (int64_t)j * N * T, ti, T));
      }
    }
  }
  out[i] = acc;
}

template <typename V>
cudaError_t launch_k2(int method, const void* x, const float* taur,
                      const float* taut, const float* t0, void* out, int64_t I,
                      int N, int M, int T, float fs, cudaStream_t s) {
  const dim3 block(256);
  const dim3 grid((unsigned)((I + 255) / 256));
  const V* xv = (const V*)x;
  V* ov = (V*)out;
  switch (method) {
    case NEAREST: das_k2_kernel<NEAREST, V><<<grid, block, 0, s>>>(xv, taur, taut, t0, ov, I, N, M, T, fs); break;
    case LINEAR: das_k2_kernel<LINEAR, V><<<grid, block, 0, s>>>(xv, taur, taut, t0, ov, I, N, M, T, fs); break;
    case CUBIC: das_k2_kernel<CUBIC, V><<<grid, block, 0, s>>>(xv, taur, taut, t0, ov, I, N, M, T, fs); break;
    case LANCZOS3: das_k2_kernel<LANCZOS3, V><<<grid, block, 0, s>>>(xv, taur, taut, t0, ov, I, N, M, T, fs); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Launch K1 on `stream` (a cudaStream_t) of device `device`. x is (M, N, T)
// float32, or interleaved complex64 when `cplx` is 1, and out (I,) of the
// same type. Returns the cudaError_t of the launch (cudaGetLastError right
// after it); 0 is success.
extern "C" int das_k1(const void* x, const float* pix, const float* pr,
                      const float* pv, const float* nv, const float* t0,
                      void* out, long long I, int N, int M, int T, float cinv,
                      float fs, int tx_model, int method, int cplx, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (I <= 0) return (int)cudaSuccess;
  if (N <= 0 || M <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(256);
  const dim3 grid((unsigned)((I + 255) / 256));
  const Args a{pix, pr, pv, nv, t0, (int64_t)I, N, M, T, cinv, fs};
  cudaStream_t s = (cudaStream_t)stream;
  err = cplx ? launch_tx<float2>(tx_model, method, x, out, a, grid, block, s)
             : launch_tx<float>(tx_model, method, x, out, a, grid, block, s);
  return (int)err;
}

// Launch K2 on `stream` of device `device`. x is (M, N, T) float32, or
// interleaved complex64 when `cplx` is 1; taur (N, I) and taut (M, I) the
// transposed delay tables [s]; t0 (M,); out (I,) of the trace type.
// Returns the cudaError_t of the launch; 0 is success.
extern "C" int das_lut_k2(const void* x, const float* taur, const float* taut,
                          const float* t0, void* out, long long I, int N, int M,
                          int T, float fs, int method, int cplx, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (I <= 0) return (int)cudaSuccess;
  if (N <= 0 || M <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  err = cplx ? launch_k2<float2>(method, x, taur, taut, t0, out, I, N, M, T, fs, s)
             : launch_k2<float>(method, x, taur, taut, t0, out, I, N, M, T, fs, s);
  return (int)err;
}
