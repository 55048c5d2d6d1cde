// The finish of the time-domain splat simulator, float32: the pulse
// convolution along the deposit axis and the per-receiver row shift in one
// pass,
//
//   x[t, n, m] = sum_k kern[k] grid[m, t + sh[n] - k, n],  sh[n] = P0 - ofs[n],
//
// grid rows outside [0, Gtime) being zero, straight into the traces x
// (T, N, M), float32 for a real kernel and complex64 (both parts from one
// read of the grid) for a complex one. It is not a TPU kernel: the TPU path
// runs it in XLA, a depthwise lax.conv and one static slice per receiver
// (qups_tpu/ops/greens_pallas.py::greens_tiled's finish); the port's plain
// version is ops/greens_cuda.py::finish_plain (convd's direct multiply-add,
// one pass of the whole grid per tap, then a gather). This kernel sums the
// taps in the plain version's order, k = 0, 1, ..., each product rounded
// before its add (built with -fmad=false), so for kernels of up to 64 taps
// (convd's direct method) it gives the plain version's bits.
//
// What bounds it on the card: bytes, one read of the grid's N columns and
// one write of the traces (2 K flops per output and part are far below).
// What the design does about that: a block owns FT rows x 32 receivers x 8
// transmits of the output; a thread (one receiver, one transmit) keeps its
// FT outputs in registers and walks the taps KC at a time, holding the
// FT + KC - 1 grid rows they need in registers (loads along the receivers,
// coalesced); the block then writes its tile through shared memory with the
// transmits innermost, as x is laid out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FT = 16;     // output rows per thread
constexpr int KC = 16;     // taps per step
constexpr int LN = 32;     // receivers per block, one per lane
constexpr int WM = 8;      // transmits per block, one per warp
constexpr int OS = WM + 1;  // padded transmit stride of the output stage

template <bool CPLX>
struct Out {
  using V = float;
  static __device__ V make(float re, float) { return re; }
};
template <>
struct Out<true> {
  using V = float2;
  static __device__ V make(float re, float im) { return make_float2(re, im); }
};

template <bool CPLX>
__global__ void __launch_bounds__(LN * WM)
finish_kernel(const float* __restrict__ grid,  // (M, Gtime, Npad)
              const float* __restrict__ kr,    // (K,) kernel, real part
              const float* __restrict__ ki,    // (K,) imaginary part (CPLX)
              const int* __restrict__ sh,      // (N,) P0 - ofs[n]
              void* __restrict__ out,          // (T, N, M) float or float2
              int T, int N, int M, int Gtime, int Npad, int K, int ntt) {
  using V = typename Out<CPLX>::V;
  __shared__ V stage[FT * LN * OS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int tt = blockIdx.x % ntt;
  const int t0 = tt * FT, m0 = (blockIdx.x / ntt) * WM, n0 = blockIdx.y * LN;
  const int n = n0 + lane, m = m0 + w;
  float ar[FT], ai[FT];
#pragma unroll
  for (int t = 0; t < FT; ++t) ar[t] = ai[t] = 0.f;
  if (n < N && m < M) {
    const float* col = grid + (int64_t)m * Gtime * Npad + n;
    const int shn = sh[n];
    for (int k0 = 0; k0 < K; k0 += KC) {
      // the rows taps k0 .. k0 + KC - 1 read: win[q] = row base + q
      const int base = t0 + shn - k0 - (KC - 1);
      float win[FT + KC - 1];
#pragma unroll
      for (int q = 0; q < FT + KC - 1; ++q) {
        const int row = base + q;
        win[q] = row >= 0 && row < Gtime ? __ldg(col + (int64_t)row * Npad) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k0 + k < K) {
          const float cr = __ldg(kr + k0 + k);
          const float ci = CPLX ? __ldg(ki + k0 + k) : 0.f;
#pragma unroll
          for (int t = 0; t < FT; ++t) {
            const float g = win[t - k + KC - 1];  // row t0 + t + shn - (k0 + k)
            ar[t] = ar[t] + g * cr;
            if (CPLX) ai[t] = ai[t] + g * ci;
          }
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < FT; ++t) stage[(t * LN + lane) * OS + w] = Out<CPLX>::make(ar[t], ai[t]);
  __syncthreads();
  V* x = static_cast<V*>(out);
  for (int e = threadIdx.x; e < FT * LN * WM; e += LN * WM) {
    const int mm = e % WM, nn = (e / WM) % LN, t = e / (WM * LN);
    if (t0 + t < T && n0 + nn < N && m0 + mm < M)
      x[((int64_t)(t0 + t) * N + n0 + nn) * M + m0 + mm] = stage[(t * LN + nn) * OS + mm];
  }
}

}  // namespace

// Launch the finish kernel on `stream` (a cudaStream_t) of device `device`:
// x (T, N, M), float32, or complex64 when `cplx` is 1 (then ki holds the
// kernel's imaginary part), from grid (M, Gtime, Npad) float32, kr (K,) and
// sh (N,) int32. Returns the cudaError_t of the launch (cudaGetLastError
// right after it); 0 is success.
extern "C" int greens_finish(const float* grid, const float* kr, const float* ki,
                             const int* sh, void* x, int T, int N, int M, int Gtime,
                             int Npad, int K, int cplx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T <= 0 || N <= 0 || M <= 0) return (int)cudaSuccess;
  const int ntt = (T + FT - 1) / FT, nmt = (M + WM - 1) / WM, nnt = (N + LN - 1) / LN;
  if (K <= 0 || N > Npad || nnt > 65535 || (int64_t)ntt * nmt >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 grid_((unsigned)(ntt * nmt), (unsigned)nnt);
  cudaStream_t s = (cudaStream_t)stream;
  if (cplx)
    finish_kernel<true><<<grid_, LN * WM, 0, s>>>(grid, kr, ki, sh, x, T, N, M, Gtime, Npad,
                                                  K, ntt);
  else
    finish_kernel<false><<<grid_, LN * WM, 0, s>>>(grid, kr, ki, sh, x, T, N, M, Gtime, Npad,
                                                   K, ntt);
  return (int)cudaGetLastError();
}
