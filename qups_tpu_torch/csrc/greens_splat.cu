// K5: the time-domain Green's-function splat, float32.
//
// Replaces the TPU kernel qups_tpu/ops/greens_pallas.py::_splat_kernel
// (launched by _splat_tiled, public entry greens_tiled, which
// UltrasoundSystem.greens(impl='pallas') calls). It fills the deposit grid
// out (M, Gtime, Npad): row j = 8 t + r (tile t) gets, from every
// range-sorted scatterer s = (x, y, z, a), receiver n and transmit m,
//
//   w B(d),  d = (p - 8 t) - r,  p = (cinv_fs (r1 + r2) + pconst) - ofs[n],
//   r1 = |s - pn[n]|, r2 = |s - pv[m]|, w = a / (max(r1, R0) max(r2, R0))
//   (w = a when R0 <= 0),
//
// B the linear tent max(0, 1 - |d|) or the Catmull-Rom splat basis, in the
// TPU kernel's order of operations. It computes what
// qups_tpu_torch/ops/greens_cuda.py::splat_plain computes, term for term;
// only the order of the sums differs.
//
// What bounds it on the card: not bytes (the grid is written once) nor the
// flops of the deposits (S N M of them, 42 flops each cubic; the radii are
// only S (N + M)), but the
// (scatterer, m, n) visits: each costs r1 (3 products and a square root),
// the row p and a range test whether or not it deposits. The TPU kernel's
// windows are per 8-row tile over all receivers at once; on the card they
// made ~75 visits per deposit (PERF.md §6).
//
// What the design does about that:
// * one warp owns one transmit m, one band of R = 128 rows and one group
//   of 32 consecutive receivers, one per lane; the band of the grid lives
//   in the warp's shared memory,
//   [row][lane] (16 KB), so a row's 32 lanes fall in 32 banks whatever rows
//   the taps hit. 128 rows measured fastest of 64, 128 and 256: narrower
//   bands make more visits, wider ones fewer warps per SM (PERF.md);
// * the plan gives each (m, band, group) its own window [lo, hi) of the
//   range-sorted scatterers: those whose rows, over the group's receivers,
//   can reach the band (ops/greens_cuda.py::band_windows). A narrow band
//   and a narrow group keep the window close to the scatterers that
//   deposit;
// * the warp walks its window 32 scatterers at a time: each lane stages one
//   (a coalesced float4 load) with its r2, which only depends on m; then
//   every lane takes r1, p and the 2 (linear) or 4 (cubic) taps of each
//   staged scatterer for its own receiver, and adds those that fall in the
//   band into its own column, in window order: no atomics, no races, so
//   runs repeat bit for bit;
// * a tap takes the tile base of its own row, d = (p - 8 t) - r, as the
//   plain version does, not the band's base;
// * the band is written out once, row by row, 32 lanes at a time.
// A scatterer outside a window deposits exactly zero there: the windows
// bound the work and never change the result.
//
// Numerics: built with -fmad=false, as the plain version rounds; sqrtf and
// the division are correctly rounded without fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;  // receivers per warp: one window group
constexpr int R = 128;     // rows per band: ops/greens_cuda.py::BAND

template <bool CUBIC>
__device__ __forceinline__ float basis(float d) {
  const float ad = fabsf(d);
  if (!CUBIC) return fmaxf(0.f, 1.f - ad);
  const float inner = ((1.5f * ad - 2.5f) * ad) * ad + 1.f;
  const float outer = ((-0.5f * ad + 2.5f) * ad - 4.f) * ad + 2.f;
  return ad <= 1.f ? inner : (ad < 2.f ? outer : 0.f);
}

template <bool CUBIC>
__global__ void __launch_bounds__(LANES)
splat_kernel(const float4* __restrict__ scat,  // (S) x, y, z, a; sorted
             const float* __restrict__ pn,     // (3, Npad) receivers
             const float* __restrict__ ofs,    // (Npad) row offsets
             const float* __restrict__ pv,     // (3, M) transmitters
             const int* __restrict__ lo,       // (M, nbands, G) window starts
             const int* __restrict__ hi,       // (M, nbands, G) window ends
             float* __restrict__ out,          // (M, Gtime, Npad)
             int Npad, int M, int Gtime, int nbands, float cinv_fs, float pconst,
             float R0) {
  extern __shared__ float4 stage[];                          // LANES scatterers
  float* r2s = reinterpret_cast<float*>(stage + LANES);      // their r2
  float* acc = r2s + LANES;                                  // acc[row][lane]
  constexpr int SUP = CUBIC ? 2 : 1;  // support half-width of the basis
  const int lane = threadIdx.x;
  const int m = blockIdx.x / nbands, b0 = (blockIdx.x - m * nbands) * R;
  const int n = blockIdx.y * LANES + lane;
  const int rows = min(R, Gtime - b0);
  const int64_t wi = (int64_t)blockIdx.x * gridDim.y + blockIdx.y;
  const int s_lo = lo[wi], s_hi = hi[wi];

  for (int r = 0; r < R; ++r) acc[r * LANES + lane] = 0.f;
  const float pnx = pn[n], pny = pn[Npad + n], pnz = pn[2 * Npad + n];
  const float on = ofs[n];
  const float pvx = pv[m], pvy = pv[M + m], pvz = pv[2 * M + m];
  // p must lie within SUP of a row of the band for a tap to be nonzero there
  const float p_lo = (float)(b0 - SUP), p_hi = (float)(b0 + rows - 1 + SUP);

  for (int s0 = s_lo; s0 < s_hi; s0 += LANES) {
    __syncwarp();  // the last group's reads of the stage are done
    if (s0 + lane < s_hi) {
      const float4 v = scat[s0 + lane];
      stage[lane] = v;
      const float ex = v.x - pvx, ey = v.y - pvy, ez = v.z - pvz;
      r2s[lane] = sqrtf(ex * ex + ey * ey + ez * ez);
    }
    __syncwarp();
    const int cnt = min(LANES, s_hi - s0);
    for (int j = 0; j < cnt; ++j) {
      const float4 v = stage[j];
      const float r2 = r2s[j];
      const float dx = v.x - pnx, dy = v.y - pny, dz = v.z - pnz;
      const float r1 = sqrtf(dx * dx + dy * dy + dz * dz);
      const float p = (cinv_fs * (r1 + r2) + pconst) - on;
      if (!(p > p_lo && p < p_hi)) continue;  // no tap of it is in the band
      const float w = R0 > 0.f ? v.w / (fmaxf(r1, R0) * fmaxf(r2, R0)) : v.w;
      const int j0 = (int)floorf(p);
#pragma unroll
      for (int o = CUBIC ? -1 : 0; o <= (CUBIC ? 2 : 1); ++o) {
        const int row = j0 + o, r = row - b0;
        if (r < 0 || r >= rows) continue;
        const int tb = row & ~7;  // the tap's own tile base (row >= 0)
        const float d = (p - (float)tb) - (float)(row - tb);
        acc[r * LANES + lane] += w * basis<CUBIC>(d);
      }
    }
  }
  float* o = out + ((int64_t)m * Gtime + b0) * Npad + n;
  for (int r = 0; r < rows; ++r) o[(int64_t)r * Npad] = acc[r * LANES + lane];
}

template <bool CUBIC>
cudaError_t run(const float* scat, const float* pn, const float* ofs, const float* pv,
                const int* lo, const int* hi, float* out, int Npad, int M, int Gtime,
                int nbands, float cinv_fs, float pconst, float R0, cudaStream_t s) {
  const dim3 grid((unsigned)((int64_t)M * nbands), (unsigned)(Npad / LANES));
  const size_t smem = LANES * (sizeof(float4) + sizeof(float)) + (size_t)R * LANES * sizeof(float);
  splat_kernel<CUBIC><<<grid, LANES, smem, s>>>((const float4*)scat, pn, ofs, pv, lo, hi, out,
                                                 Npad, M, Gtime, nbands, cinv_fs, pconst, R0);
  return cudaGetLastError();
}

}  // namespace

// Launch K5 on `stream` (a cudaStream_t) of device `device`: fill out
// (M, Gtime, Npad) float32 from the windows lo, hi (M, nbands, Npad / 32)
// of bands of R = 128 rows, nbands = ceil(Gtime / 128); Npad a multiple of
// 32. Returns the cudaError_t of the launch (cudaGetLastError right after
// it); 0 is success.
extern "C" int greens_splat_k5(const float* scat, const float* pn, const float* ofs,
                               const float* pv, const int* lo, const int* hi,
                               float* out, int Npad, int M, int Gtime, int nbands,
                               float cinv_fs, float pconst, float R0, int cubic,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || Gtime <= 0 || Npad <= 0) return (int)cudaSuccess;
  if (nbands != (Gtime + R - 1) / R || Npad % LANES || Npad / LANES > 65535 ||
      (int64_t)M * nbands >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return cubic ? (int)run<true>(scat, pn, ofs, pv, lo, hi, out, Npad, M, Gtime, nbands,
                                cinv_fs, pconst, R0, s)
               : (int)run<false>(scat, pn, ofs, pv, lo, hi, out, Npad, M, Gtime, nbands,
                                 cinv_fs, pconst, R0, s);
}
