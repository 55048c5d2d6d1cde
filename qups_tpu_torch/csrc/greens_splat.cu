// K5: the time-domain Green's-function splat, float32.
//
// Replaces the TPU kernel qups_tpu/ops/greens_pallas.py::_splat_kernel
// (launched by _splat_tiled, public entry greens_tiled, which
// UltrasoundSystem.greens(impl='pallas') calls). It fills the deposit grid
// out (M, Gtime, Npad), Gtime = 8 ntiles: row j = 8 t + r of tile t gets,
// from every range-sorted scatterer s = (x, y, z, a), receiver n and
// transmit m,
//
//   w B(d),  d = p - r,  p = ((cinv_fs (r1 + r2) + pconst) - ofs[n]) - 8 t,
//   r1 = |s - pn[n]|, r2 = |s - pv[m]|, w = a / (max(r1, R0) max(r2, R0))
//   (w = a when R0 <= 0),
//
// B the linear tent max(0, 1 - |d|) or the Catmull-Rom splat basis, in the
// TPU kernel's order of operations. The host plan
// (qups_tpu_torch/ops/greens_cuda.py::greens_tiled) gives every (m, tile) a
// window of CS-scatterer chunks [lo, lo + nc) of the sorted cloud outside
// which a scatterer deposits exactly zero into that tile: the windows bound
// the work and never change the result. It computes what
// qups_tpu_torch/ops/greens_cuda.py::splat_plain computes, term for term;
// only the order of the sums differs.
//
// What bounds it on the card: per (scatterer in window, m, n) one distance
// r1 (3 products, a square root), the row p and a range test; for the few
// terms that land in the tile, the weight (a division) and 8 basis
// evaluations. Float32 work on the CUDA cores; the grid is written once
// (M * Gtime * Npad * 4 bytes) and the scatterers are read once per block.
//
// What the design does about that. The TPU kernel's DMA double-buffering and
// in-register transposes are TPU machinery and are not carried over; this is
// a deterministic gather:
// * one block owns one transmit m, TT consecutive 8-row tiles and 128
//   receiver lanes; each thread owns one receiver n and the 8 rows of one
//   tile, in 8 register accumulators;
// * the block walks the union of its tiles' chunk windows, staging each
//   chunk in shared memory as float4 (x, y, z, a) with coalesced loads, and
//   computes r2 (the same for the whole block's m) once per scatterer while
//   staging;
// * a thread skips chunks outside its own tile's window and scatterers whose
//   row p leaves its tile's support: both contribute exactly zero;
// * each output element is written once, with no atomics, so runs repeat
//   bit for bit.
// Sharing r1 across the transmits of a block, and balancing the ragged
// windows, are later speed work.
//
// Numerics: built with -fmad=false, as the plain version rounds; sqrtf is
// correctly rounded without fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;  // receivers per block (one per thread)
constexpr int TT = 4;       // 8-row tiles per block (one per thread row)

template <bool CUBIC>
__device__ __forceinline__ float basis(float d) {
  const float ad = fabsf(d);
  if (!CUBIC) return fmaxf(0.f, 1.f - ad);
  const float inner = ((1.5f * ad - 2.5f) * ad) * ad + 1.f;
  const float outer = ((-0.5f * ad + 2.5f) * ad - 4.f) * ad + 2.f;
  return ad <= 1.f ? inner : (ad < 2.f ? outer : 0.f);
}

template <bool CUBIC>
__global__ void __launch_bounds__(LANES * TT)
splat_kernel(const float4* __restrict__ scat,  // (Spad) x, y, z, a; sorted
             const float* __restrict__ pn,     // (3, Npad) receivers
             const float* __restrict__ ofs,    // (Npad) row offsets
             const float* __restrict__ pv,     // (3, M) transmitters
             const int* __restrict__ lo,       // (M, ntiles) first chunk
             const int* __restrict__ nc,       // (M, ntiles) chunk count
             float* __restrict__ out,          // (M, 8 ntiles, Npad)
             int Npad, int M, int ntiles, int CS, float cinv_fs,
             float pconst, float R0) {
  extern __shared__ float4 sh[];                         // CS scatterers
  float* shr2 = reinterpret_cast<float*>(sh + CS);       // CS radii r2
  const float SUP = CUBIC ? 2.f : 1.f;  // support half-width of the basis
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * LANES + lane;
  const int m = blockIdx.y;
  const int n = blockIdx.z * LANES + lane;
  const int t = blockIdx.x * TT + ty;
  const bool tile_ok = t < ntiles;

  // the union of the block's tile windows, and this thread's own window
  int c_lo = 0x7fffffff, c_hi = 0, my_lo = 0, my_hi = 0;
  for (int k = 0; k < TT; ++k) {
    const int tk = blockIdx.x * TT + k;
    if (tk >= ntiles) break;
    const int l = lo[(int64_t)m * ntiles + tk], c = nc[(int64_t)m * ntiles + tk];
    if (c > 0) {
      c_lo = min(c_lo, l);
      c_hi = max(c_hi, l + c);
    }
    if (k == ty) {
      my_lo = l;
      my_hi = c > 0 ? l + c : l;
    }
  }

  const float pnx = pn[n], pny = pn[Npad + n], pnz = pn[2 * Npad + n];
  const float on = ofs[n];
  const float pvx = pv[m], pvy = pv[M + m], pvz = pv[2 * M + m];
  const float row0 = (float)(t * 8);

  float acc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0.f;

  for (int c = c_lo; c < c_hi; ++c) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < CS; i += LANES * TT) {
      const float4 v = scat[(int64_t)c * CS + i];
      sh[i] = v;
      const float ex = v.x - pvx, ey = v.y - pvy, ez = v.z - pvz;
      shr2[i] = sqrtf(ex * ex + ey * ey + ez * ez);
    }
    __syncthreads();
    if (!tile_ok || c < my_lo || c >= my_hi) continue;
    for (int i = 0; i < CS; ++i) {
      const float4 v = sh[i];
      const float r2 = shr2[i];
      const float dx = v.x - pnx, dy = v.y - pny, dz = v.z - pnz;
      const float r1 = sqrtf(dx * dx + dy * dy + dz * dz);
      const float p = ((cinv_fs * (r1 + r2) + pconst) - on) - row0;
      if (!(p > -SUP && p < 7.f + SUP)) continue;  // all 8 rows are 0
      const float w = R0 > 0.f ? v.w / (fmaxf(r1, R0) * fmaxf(r2, R0)) : v.w;
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = acc[r] + w * basis<CUBIC>(p - (float)r);
    }
  }
  if (!tile_ok) return;
  float* o = out + ((int64_t)m * ntiles * 8 + (int64_t)t * 8) * Npad + n;
#pragma unroll
  for (int r = 0; r < 8; ++r) o[(int64_t)r * Npad] = acc[r];
}

}  // namespace

// Launch K5 on `stream` (a cudaStream_t) of device `device`: fill out
// (M, 8 ntiles, Npad) float32; Npad a multiple of 128, Spad of CS. Returns
// the cudaError_t of the launch (cudaGetLastError right after it); 0 is
// success.
extern "C" int greens_splat_k5(const float* scat, const float* pn, const float* ofs,
                               const float* pv, const int* lo, const int* nc,
                               float* out, int Spad, int Npad, int M, int ntiles,
                               int CS, float cinv_fs, float pconst, float R0,
                               int cubic, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || ntiles <= 0 || Npad <= 0) return (int)cudaSuccess;
  if (Npad % LANES || CS <= 0 || CS > 2048 || Spad % CS || M > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 block(LANES, TT);
  const dim3 grid((unsigned)((ntiles + TT - 1) / TT), (unsigned)M,
                  (unsigned)(Npad / LANES));
  const size_t smem = (size_t)CS * (sizeof(float4) + sizeof(float));
  if (cubic)
    splat_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
        (const float4*)scat, pn, ofs, pv, lo, nc, out, Npad, M, ntiles, CS,
        cinv_fs, pconst, R0);
  else
    splat_kernel<false><<<grid, block, smem, (cudaStream_t)stream>>>(
        (const float4*)scat, pn, ofs, pv, lo, nc, out, Npad, M, ntiles, CS,
        cinv_fs, pconst, R0);
  return (int)cudaGetLastError();
}
