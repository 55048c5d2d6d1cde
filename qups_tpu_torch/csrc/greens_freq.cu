// K3: the frequency-domain Green's-function GEMM, complex64 output, with its
// operands in float32 (on the CUDA cores) or rounded to bfloat16 (on the
// tensor cores).
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
// accurate at high bins, and its sin and cos are the accurate sincosf's, as
// the plain version computes them: the bf16 operands are then the plain
// version's bit for bit (the special function unit's __sincosf, 7e-7 off,
// flips enough bf16 roundings to move G by ~1e-4 of its peak). It computes
// what qups_tpu_torch/ops/greens_freq_cuda.py::freq_gemm_plain computes.
//
// Two compile-time options, as the TPU kernel has them:
// * DIR (K3(c), `has_dir`, the simus directivity): D1 = sinc(s1[s, n] k),
//   D2 = sinc(s2[s, m] k), with the TPU kernel's sinc (|pi x| < 1e-6 -> 1),
//   applied to the element's summed phasor; otherwise D = 1 (K3(a)).
// * BF16 (K3(b), `precision='bf16'`): each operand, after the sub-element
//   sum and the directivity weight, is rounded to bfloat16 (round to nearest
//   even), and the product runs on the tensor cores with float32 sums.
//
// What bounds it on the card: the complex multiply-adds, F S N M of them
// (1.7e12 at 1e5 scatterers x 128 x 128 x 1025 bins: 13.6 ms at the bf16
// tensor-core peak, 200 ms at the float32 CUDA-core peak), and the F S (N +
// M) operand phasors (2.6e10 there), each a sincosf (and a sinf with DIR).
// At the sim->image size of chip_smoke.py (5 scatterers) the launch and the
// FFT synthesis dominate.
//
// The design: one block owns a 128 x 128 (n, m) tile of one bin (256
// threads for float32, 512 for bf16), the whole of it for arrays of up to
// 128 elements, so each operand
// phasor is built once per bin. It walks the scatterers in chunks of SC =
// 16. The raw q, w (and s) rows of chunk c + 1 arrive in shared memory by
// cp.async (16-byte copies where the rows allow, 4-byte ones otherwise)
// while the block builds chunk c's phasors and multiplies them; when the
// staging buffers do not fit (many sub-elements) the phasors read global
// memory directly. Each output is written once: no atomics, so the result
// is deterministic.
// * float32 (K3(a), K3(c)): the phasors go into shared memory as complex
//   float32; each thread accumulates an 8 x 8 micro-tile of complex outputs
//   with explicit FMAs, 16 shared loads for 256 FMAs per scatterer.
// * bf16 (K3(b), K3(b)+(c)): per bin the complex product is one real GEMM,
//   [[Ar^T, -Ai^T], [Ai^T, Ar^T]] (2N x 2S) . [Br; Bi] (2S x M) -> [Gr; Gi],
//   with mma.sync m16n8k16 (bf16 in, float32 sums). The left operand's rows
//   of each 16-row tile are Gr of 8 receivers, then Gi of the same 8, so a
//   thread's accumulator holds (Gr, Gi) of one output; (Re, Im) pairs are
//   interleaved along the scatterer dimension. Warp w of 16 owns 64 rows (4
//   m16 tiles) x 32 columns (4 n8 tiles). The tensor cores add each product
//   into the accumulator without the float32 rounding of an FMA (over 1e5
//   scatterers that drifted by 2.2e-4), so every FLUSH = 32 chunks (512
//   scatterers) the accumulators are added into G with float32 adds.
//
// Numerics: built with -fmad=false so that the phase arithmetic rounds as
// the plain version's; the float32 products use explicit fmaf, which that
// flag does not split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int TN = 128;     // receivers of a block's tile
constexpr int TM = 128;     // transmitters of a block's tile
constexpr int SC = 16;      // scatterers per chunk
constexpr int MT = 8;       // f32: micro-tile edge per thread (16 x 16 threads)
constexpr int FLUSH = 32;   // bf16: chunks the tensor cores sum before a float32 add
constexpr int TLD = 2 * SC + 8;  // bf16 tile row stride (elements): 16 bytes of padding
constexpr float PI_F = 3.14159265358979323846f;

extern __shared__ __align__(16) unsigned char k3_smem[];

struct Args {
  const float *q1, *w1, *q2, *w2;  // (S, N, E1), (S, M, E2)
  const float *s1, *s2;            // (S, N), (S, M) with DIR
  float2* out;                     // (F, N, M)
  int S, N, M, E1, E2, k0;
  float att;
  int staged, vec;                 // cp.async staging; 16-byte copies
};

// the TPU kernel's sinc: sin(pi x) / (pi x), 1 where |pi x| < 1e-6
__device__ __forceinline__ float sinc(float x) {
  const float px = PI_F * x;
  return fabsf(px) < 1e-6f ? 1.f : sinf(px) / px;
}

// sum_e w exp(-att k q) e^{-i 2 pi frac(k q)} for one (s, element); q and w
// in shared or global memory
__device__ __forceinline__ float2 phasor(const float* q, const float* w, int E, float kf,
                                         float att_k) {
  float re = 0.f, im = 0.f;
#pragma unroll 1
  for (int e = 0; e < E; ++e) {
    const float qe = q[e];
    const float u = kf * qe;
    float sn, cs;
    hmma::sincos_turns(u, &sn, &cs);
    float mag = w[e];
    if (att_k != 0.f) mag = mag * expf(att_k * qe);
    re = re + mag * cs;
    im = im - mag * sn;
  }
  return make_float2(re, im);
}

// floats of one stage: q, w (and s) rows of SC scatterers for both sides
template <bool DIR>
__host__ __device__ __forceinline__ int stage_floats(int E1, int E2) {
  return SC * (TN * (2 * E1 + (DIR ? 1 : 0)) + TM * (2 * E2 + (DIR ? 1 : 0)));
}

// copy rows s0 .. s0 + SC of src (S, ld) from column c0 (rowlen floats, of
// which `valid` exist) into dst (SC, rowlen); zeros past S and past valid
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int ld,
                                           int c0, int rowlen, int valid, int s0, int S,
                                           bool vec) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int ss = w; ss < SC; ss += blockDim.x >> 5) {
    const bool live = s0 + ss < S;
    const float* row = live ? src + (int64_t)(s0 + ss) * ld + c0 : src;
    float* d = dst + ss * rowlen;
    if (vec) {
      for (int r = lane; r < rowlen / 4; r += 32) {
        int b = live ? valid - 4 * r : 0;
        b = b < 0 ? 0 : (b > 4 ? 4 : b);
        hmma::cp_async16(d + 4 * r, b ? row + 4 * r : src, 4 * b);
      }
    } else {
      for (int r = lane; r < rowlen; r += 32) {
        const bool ok = live && r < valid;
        hmma::cp_async4(d + r, ok ? row + r : src, ok ? 4 : 0);
      }
    }
  }
}

template <bool DIR>
__device__ __forceinline__ void stage_chunk(const Args& a, float* st, int s0, int n0, int m0) {
  const int vn = (a.N - n0 < TN ? a.N - n0 : TN), vm = (a.M - m0 < TM ? a.M - m0 : TM);
  const bool vec = a.vec != 0;
  float* p = st;
  stage_rows(p, a.q1, a.N * a.E1, n0 * a.E1, TN * a.E1, vn * a.E1, s0, a.S, vec);
  p += SC * TN * a.E1;
  stage_rows(p, a.w1, a.N * a.E1, n0 * a.E1, TN * a.E1, vn * a.E1, s0, a.S, vec);
  p += SC * TN * a.E1;
  stage_rows(p, a.q2, a.M * a.E2, m0 * a.E2, TM * a.E2, vm * a.E2, s0, a.S, vec);
  p += SC * TM * a.E2;
  stage_rows(p, a.w2, a.M * a.E2, m0 * a.E2, TM * a.E2, vm * a.E2, s0, a.S, vec);
  p += SC * TM * a.E2;
  if (DIR) {
    stage_rows(p, a.s1, a.N, n0, TN, vn, s0, a.S, vec);
    p += SC * TN;
    stage_rows(p, a.s2, a.M, m0, TM, vm, s0, a.S, vec);
  }
}

// Where one thread's element reads its q, w (and s) rows: element j of
// side 0 (receivers) or 1 (transmitters) of the tile, in the stage `st`
// (SC, T, E) when STAGED or in global memory (S, L, E) from scatterer s0;
// `live` false past the array. STAGED is a template switch so that the
// loads know their address space.
struct Rows {
  const float *q, *w, *s;
  int qstride, sstride, E;
  bool live;
};

template <bool STAGED>
__device__ __forceinline__ Rows element_rows(const Args& a, const float* st, int side, int j,
                                             int s0, int n0, int m0) {
  Rows r;
  r.E = side ? a.E2 : a.E1;
  const int L = side ? a.M : a.N, e0 = side ? m0 : n0, T = side ? TM : TN;
  r.live = e0 + j < L;
  if (STAGED) {
    const int o1 = SC * TN * a.E1, o2 = SC * TM * a.E2;
    r.q = (side ? st + 2 * o1 : st) + j * r.E;
    r.w = r.q + SC * T * r.E;
    r.s = st + 2 * o1 + 2 * o2 + (side ? SC * TN : 0) + j;
    r.qstride = T * r.E;
    r.sstride = T;
  } else {
    const int64_t o = (int64_t)s0 * L + e0 + j;
    r.q = (side ? a.q2 : a.q1) + o * r.E;
    r.w = (side ? a.w2 : a.w1) + o * r.E;
    r.s = (side ? a.s2 : a.s1) + o;
    r.qstride = L * r.E;
    r.sstride = L;
  }
  return r;
}

// the operand of scatterer row ss: the summed phasor times the directivity
template <bool DIR>
__device__ __forceinline__ float2 operand(const Rows& r, int ss, float kf, float att_k) {
  const float* q = r.q + ss * r.qstride;
  const float* w = r.w + ss * r.qstride;
  float2 v = phasor(q, w, r.E, kf, att_k);
  if (DIR) {
    const float g = sinc(r.s[ss * r.sstride] * kf);
    v.x = v.x * g;
    v.y = v.y * g;
  }
  return v;
}

// bytes of one chunk's operand tile: bf16 real-block rows (2 TN + TM) x
// TLD, or complex float32 (SC, TN + TM)
template <bool BF16>
__host__ __device__ constexpr int tile_bytes() {
  return BF16 ? (2 * TN + TM) * TLD * 2 : 2 * SC * (TN + TM) * 4;
}

// threads per block: 16 warps for the tensor cores, 8 for the CUDA cores
template <bool BF16>
constexpr int kThreads = BF16 ? 512 : 256;

template <bool DIR, bool BF16>
__global__ void __launch_bounds__(kThreads<BF16>, 1) k3_kernel(const __grid_constant__ Args a) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int f = blockIdx.z;
  const float kf = (float)(a.k0 + f);
  const float att_k = -a.att * kf;
  const int SZ = stage_floats<DIR>(a.E1, a.E2);
  // two operand tiles, then (staged) two stages
  constexpr int TILE_BYTES = tile_bytes<BF16>();
  unsigned char* tiles = k3_smem;
  float* stage = reinterpret_cast<float*>(k3_smem + 2 * TILE_BYTES);
  const int nchunks = (a.S + SC - 1) / SC;

  // f32: thread (ty, tx) owns rows ty + 16 r and columns tx + 16 c;
  // bf16: warp (wr, wc) = (w % 4, w / 4) owns m16 tiles 4 wr .. 4 wr + 3 and
  // n8 tiles 4 wc .. 4 wc + 3
  constexpr int NA = BF16 ? 4 : MT, NB = BF16 ? 4 : MT;
  float acc[NA][NB][BF16 ? 4 : 2];
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int q = 0; q < (BF16 ? 4 : 2); ++q) acc[i][j][q] = 0.f;

  // builds chunk c's operands, from its stage or from global memory, into
  // `tile`: each thread one element's phasors for SC / (threads / 256) of the
  // scatterers, threads 256 h .. 256 h + 127 the receivers, the next 128 the
  // transmitters
  auto gen = [&](int c, unsigned char* tile) {
    constexpr int REP = kThreads<BF16> / 256;  // threads per element
    const int s0 = c * SC;
    const int side = (tid & 255) >= TN, j = tid & 127;
    auto build = [&](const Rows& r) {
#pragma unroll 4
      for (int i = 0; i < SC / REP; ++i) {
        const int ss = (tid >> 8) + REP * i;
        const float2 v = r.live && s0 + ss < a.S ? operand<DIR>(r, ss, kf, att_k)
                                                 : make_float2(0.f, 0.f);
        if (BF16) {
          uint32_t* t32 = reinterpret_cast<uint32_t*>(tile);
          if (side == 0) {  // rows (Re, -Im) and (Im, Re) of receiver j
            const int row = 16 * (j >> 3) + (j & 7);
            t32[row * (TLD / 2) + ss] = hmma::pack_bf16(v.x, -v.y);
            t32[(row + 8) * (TLD / 2) + ss] = hmma::pack_bf16(v.y, v.x);
          } else {  // (Re, Im) of transmitter j, k-contiguous
            t32[(2 * TN + j) * (TLD / 2) + ss] = hmma::pack_bf16(v.x, v.y);
          }
        } else {
          float2* t2 = reinterpret_cast<float2*>(tile);
          t2[side * SC * TN + ss * (side ? TM : TN) + j] = v;
        }
      }
    };
    if (a.staged) build(element_rows<true>(a, stage + (c & 1) * SZ, side, j, s0, n0, m0));
    else build(element_rows<false>(a, nullptr, side, j, s0, n0, m0));
  };

  // The pipeline, one barrier per chunk: while the block multiplies chunk c
  // (the tensor cores run beside the ALUs), it builds chunk c + 1's
  // operands into the other tile, and the copies of chunk c + 2's rows are
  // in flight into the stage that chunk c's build has released.
  if (a.staged) {
    stage_chunk<DIR>(a, stage, 0, n0, m0);
    hmma::cp_async_commit();
    if (nchunks > 1) stage_chunk<DIR>(a, stage + SZ, SC, n0, m0);
    hmma::cp_async_commit();
    hmma::cp_async_wait<1>();
    __syncthreads();
  }
  if (nchunks > 0) gen(0, tiles);
  if (a.staged) hmma::cp_async_wait<0>();
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    if (a.staged) {
      if (c + 2 < nchunks) stage_chunk<DIR>(a, stage + (c & 1) * SZ, (c + 2) * SC, n0, m0);
      hmma::cp_async_commit();
    }
    const unsigned char* cur = tiles + (c & 1) * TILE_BYTES;
    if constexpr (BF16) {
      const __nv_bfloat16* At = reinterpret_cast<const __nv_bfloat16*>(cur);
      const __nv_bfloat16* Bt = At + 2 * TN * TLD;
      const int wr = w & 3, wc = w >> 2;
#pragma unroll
      for (int ks = 0; ks < SC / 8; ++ks) {
        uint32_t af[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          hmma::ldsm_x4(af[i], At + (16 * (4 * wr + i) + (lane & 15)) * TLD + 16 * ks
                                   + (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          hmma::ldsm_x4(b, Bt + (32 * wc + 16 * jp + (lane & 7) + ((lane >> 4) << 3)) * TLD
                               + 16 * ks + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            hmma::mma_bf16(acc[i][2 * jp], af[i], b[0], b[1]);
            hmma::mma_bf16(acc[i][2 * jp + 1], af[i], b[2], b[3]);
          }
        }
      }
      // The tensor cores add each product into the accumulator without the
      // float32 rounding of an FMA, so the error grows with the chunks it
      // sums: every FLUSH chunks the block adds its accumulators into G with
      // float32 adds (each output is one thread's) and starts again.
      if ((c + 1) % FLUSH == 0 || c + 1 == nchunks) {
        float2* out = a.out + (int64_t)f * a.N * a.M;
        const int g = lane >> 2, t = lane & 3;
        const bool first = c < FLUSH;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + 8 * (4 * wr + i) + g;
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) {
            const int m = m0 + 32 * wc + 8 * jn + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (n < a.N && m + h < a.M) {
                float2* o = out + (int64_t)n * a.M + m + h;
                const float2 v = make_float2(acc[i][jn][h], acc[i][jn][2 + h]);
                *o = first ? v : make_float2(o->x + v.x, o->y + v.y);
              }
              acc[i][jn][h] = acc[i][jn][2 + h] = 0.f;
            }
          }
        }
      }
    } else {
      const float2* A = reinterpret_cast<const float2*>(cur);
      const float2* B = A + SC * TN;
      const int tx = tid & 15, ty = tid >> 4;
#pragma unroll 2
      for (int ss = 0; ss < SC; ++ss) {
        float2 av[MT], bv[MT];
#pragma unroll
        for (int r = 0; r < MT; ++r) av[r] = A[ss * TN + ty + 16 * r];
#pragma unroll
        for (int c2 = 0; c2 < MT; ++c2) bv[c2] = B[ss * TM + tx + 16 * c2];
#pragma unroll
        for (int r = 0; r < MT; ++r)
#pragma unroll
          for (int c2 = 0; c2 < MT; ++c2) {
            float* o = acc[r][c2];
            o[0] = fmaf(av[r].x, bv[c2].x, o[0]);
            o[0] = fmaf(-av[r].y, bv[c2].y, o[0]);
            o[1] = fmaf(av[r].x, bv[c2].y, o[1]);
            o[1] = fmaf(av[r].y, bv[c2].x, o[1]);
          }
      }
    }
    if (c + 1 < nchunks) gen(c + 1, tiles + ((c + 1) & 1) * TILE_BYTES);
    if (a.staged) hmma::cp_async_wait<0>();
    __syncthreads();  // chunk c + 1's tile and chunk c + 2's stage are ready
  }

  float2* out = a.out + (int64_t)f * a.N * a.M;
  if constexpr (!BF16) {
    const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const int n = n0 + ty + 16 * r;
      if (n >= a.N) continue;
#pragma unroll
      for (int c2 = 0; c2 < MT; ++c2) {
        const int m = m0 + tx + 16 * c2;
        if (m < a.M) out[(int64_t)n * a.M + m] = make_float2(acc[r][c2][0], acc[r][c2][1]);
      }
    }
  }
}

template <bool DIR, bool BF16>
size_t smem_bytes(int E1, int E2, bool staged) {
  return 2 * (size_t)tile_bytes<BF16>() + (staged ? (size_t)2 * stage_floats<DIR>(E1, E2) * 4 : 0);
}

// the shared memory a Hopper block may opt into, less room for the rest
constexpr size_t SMEM_LIMIT = 232448 - 4096;

template <bool DIR, bool BF16>
cudaError_t launch(Args a, int F, cudaStream_t s) {
  constexpr int NTHR = kThreads<BF16>;
  auto kern = k3_kernel<DIR, BF16>;
  a.staged = smem_bytes<DIR, BF16>(a.E1, a.E2, true) <= SMEM_LIMIT;
  const size_t smem = smem_bytes<DIR, BF16>(a.E1, a.E2, a.staged);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  // one bin per grid z-index; gridDim.z is at most 65535
  for (int f0 = 0; f0 < F; f0 += 65535) {
    const int nf = F - f0 < 65535 ? F - f0 : 65535;
    const dim3 grid((unsigned)((a.M + TM - 1) / TM), (unsigned)((a.N + TN - 1) / TN),
                    (unsigned)nf);
    Args b = a;
    b.out = a.out + (int64_t)f0 * a.N * a.M;
    b.k0 = a.k0 + f0;
    kern<<<grid, NTHR, smem, s>>>(b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// Launch K3 on `stream` (a cudaStream_t) of device `device`: G (F, N, M)
// interleaved complex64 for bins k0 .. k0+F-1. `s1` and `s2` are both null
// (no directivity) or both set; `bf16` != 0 rounds the operands and runs the
// product on the tensor cores. Returns the cudaError_t of the launch
// (cudaGetLastError right after each grid); 0 is success.
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
  Args a{q1, w1, q2, w2, s1, s2, (float2*)out, S, N, M, E1, E2, k0, att, 0, 0};
  // 16-byte copies need every staged row to start on 16 bytes
  a.vec = aligned16(q1) && aligned16(w1) && aligned16(q2) && aligned16(w2)
          && (N * E1) % 4 == 0 && (M * E2) % 4 == 0
          && (!dir || (aligned16(s1) && aligned16(s2) && N % 4 == 0 && M % 4 == 0));
  if (S == 0) {  // an empty sum: zeros
    return (int)cudaMemsetAsync(out, 0, (size_t)F * N * M * sizeof(float2),
                                (cudaStream_t)stream);
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dir) err = bf16 ? launch<true, true>(a, F, s) : launch<true, false>(a, F, s);
  else err = bf16 ? launch<false, true>(a, F, s) : launch<false, false>(a, F, s);
  return (int)err;
}
