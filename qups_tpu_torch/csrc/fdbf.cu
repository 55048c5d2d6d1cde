// K4: the frequency-domain adjoint beamformer, float32 accumulation, with the
// dot operands in float32 (on the CUDA cores) or rounded to bfloat16 (on the
// tensor cores).
//
// Replaces the TPU kernel qups_tpu/ops/fdbf_pallas.py::_kernel (launched by
// _adj_call, public entry bf_adjoint_tiled): the three keep modes (''
// summed, 'rx', 'tx'), precision 'f32' and 'bf16', any number of
// synthesized pulses V, receivers N and elements M (sub-slices K4(a) and,
// past 256 pulses or keep 'rx' receivers, K4(b)). For every selected bin k
// (frequency fk) and pixel i it computes what
// qups_tpu_torch/ops/fdbf.py::bf_adjoint computes:
//
//   A(i, v)  = sum_m Wtx(i, m) S_k[m, v],    Wtx = e^{-2 pi i frac(fk taut[i, m])}
//   Ahat     = A / ||A(i, :)||               (1 where the norm is 0)
//   y(i, v)  = sum_n Wrx(i, n) X_k[n, v],    Wrx = e^{+2 pi i frac(fk taur[i, n])}
//   b(i)    += sum_v y(i, v) conj(Ahat(i, v))            keep ''
//   b(i, v) += y(i, v) conj(Ahat(i, v))                  keep 'tx'
//   b(i, n) += Wrx(i, n) sum_v conj(Ahat(i, v)) X_k[n, v]   keep 'rx'
//
// The phasors are evaluated directly from the angle 2 pi frac(fk tau), in
// the float32 order of the plain version: no recurrence, so no drift along
// the band. Their sin and cos come from the special function unit,
// __sincosf on the angle shifted to [-pi, pi) (hopper_mma.cuh::
// sincos_turns_sfu): about 2^-21.4 absolute against the accurate sincosf of
// the plain version (chip_smoke.py phase 6 measures it), the size of the
// float32 rounding of the angle itself. The Wrx of the keep 'rx' epilogue
// stays accurate.
//
// What bounds it on the card: the complex multiply-adds, K I (M + N) V of
// them (8.8e12 at 1024^2 pixels x 256 x 256 x 64 bins: 71 ms at the bf16
// tensor-core peak, 1.05 s at the float32 CUDA-core peak), the K I (M + N)
// phasors (3.4e10 there), and, for the tensor-core path, the traffic of the
// per-bin operands S_k and X_k from L2 into every block.
//
// The design. A block of 256 threads (8 warps) owns BI = 64 pixels and loops
// over the bins; the 2V columns of the products run in tiles of 2 VT
// columns (VT = 8, 16, 32 or 64, the least that holds V), so registers never
// hold all of A and y. In the summed mode the norm factors out of the sum,
// b(i) += (sum_v y conj(A)) / ||A_i||, so per tile a thread only adds up
// |A|^2 and y conj(A) for its rows; the row sums meet once per bin in shared
// memory. Keep 'tx' and 'rx' need Ahat before their epilogue: a first pass
// over the tiles sums |A|^2, a second one recomputes A (bit for bit) and
// writes b (keep 'tx'), or stores conj(Ahat) in shared memory as the left
// operand of z = conj(Ahat) X_k^T (keep 'rx'), whose tiles run over the
// receivers. Each output belongs to one thread: nothing is atomic and two
// launches on one input are bit-identical.
//
// Keep 'rx' with many pulses: conj(Ahat) of all V columns takes
// BI x (2 Vp + 8) bf16 (f32: V x BI x 8 bytes) of shared memory, more than a
// block may hold past V ~ 704 (f32 ~ 414). There the wrapper sets Vh, a
// multiple of the tile width (fdbf_cuda.py::rx_chunk: the widest with which
// two blocks share an SM), and the second pass walks the columns in
// chunks of Vh: a chunk's conj(Ahat) tiles go to shared memory, then
// z = conj(Ahat) X_k^T over that chunk's rows of X_k^T, and Wrx z is added
// into the output. Of the two designs (spill conj(Ahat) to a global scratch
// and stream it through the ring, or chunk V so that it fits), this is the
// chunked one: it needs no scratch buffer and no second streamed operand,
// the products and the ring stay as they are, and its cost is the accurate
// Wrx phasor and the output's read and write once per chunk (four chunks
// at V = 1024 in bf16, eight in f32) where one would do. Each chunk's sum is
// added separately, so the float32 order differs from one pass by the
// rounding of those adds; where H fits (Vh = 0) the code is the one pass.
//
// * 'bf16', tensor cores (TcEngine): each complex product of a bin is one
//   real bf16 GEMM with float32 accumulation, mma.sync m16n8k16, in the
//   real-block form [Wr | Wi] (BI x 2M) . [[Sr, Si], [-Si, Sr]] (2M x 2V),
//   with the real and imaginary parts interleaved along both dimensions so
//   that a thread's accumulator pair is (Re, Im) of one A(i, v). The
//   wrapper builds the block operands of S_k and X_k (and of X_k^T for keep
//   'rx') per bin, rounded to bf16; rounding and negation commute, so these
//   are the plain version's four real products on the same operands. Per
//   bin the block writes its phasor tiles Wtx and Wrx as bf16 (Re, Im) pairs
//   into shared memory once, where they serve every column tile (the
//   resident route). The chunks of the block operands arrive by cp.async
//   through a 3-stage ring, so the copies overlap the MMAs. Warp w owns the
//   16 rows 16 (w % 4) .. and half w / 4 of the tile's columns; at the
//   demo's V = 5 the 10 columns pad to 16 and both halves hold data.
// * 'bf16' where the phasor tiles do not fit in shared memory (M + N above
//   ~780; K4(b), the wide route, below): a phasor table in device memory,
//   built once per (bin, pixel, element), and 128-pixel blocks that stream
//   it with the block operands on wgmma.
// * 'f32', CUDA cores (F32Engine): the same loops with register tiling. A
//   thread holds TM x TN complex outputs of each product (4 x 4 at the
//   headline), so each 8-byte shared load feeds 2 TN (or 2 TM) explicit
//   FMAs, and the phasors of a 16-row chunk are built into shared memory
//   for each column tile.
//
// Numerics: built with -fmad=false so that the phase arithmetic rounds as
// the plain version's; the multiply-adds of the f32 products use explicit
// fmaf, which that flag does not split.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_mma.cuh"

namespace {

constexpr int BI = 64;      // pixels per block
constexpr int NTHR = 256;   // threads per block (8 warps)
constexpr int KC = 32;      // block-operand rows per ring stage (16 complex rows)
constexpr int KC2 = KC / 2;  // complex rows per ring stage
constexpr int STAGES = 3;   // cp.async ring depth
constexpr int LC = 16;      // f32: complex rows per shared chunk

enum Keep { SUM = 0, KEEP_RX = 1, KEEP_TX = 2 };

extern __shared__ __align__(16) unsigned char k4_smem[];

// e^{sign 2 pi i frac(fk tau)}, as fdbf.py::phasor builds it; SFU: sin and
// cos on the special function unit
template <bool SFU>
__device__ __forceinline__ float2 phasor(float fk, float tau, float sign) {
  const float u = fk * tau;
  float sn, cs;
  if (SFU) hmma::sincos_turns_sfu(u, &sn, &cs);
  else hmma::sincos_turns(u, &sn, &cs);
  return make_float2(cs, sign * sn);
}

// acc += p * q (complex), with explicit FMAs
__device__ __forceinline__ void cmac(float2& acc, float2 p, float2 q) {
  acc.x = fmaf(p.x, q.x, acc.x);
  acc.x = fmaf(-p.y, q.y, acc.x);
  acc.y = fmaf(p.x, q.y, acc.y);
  acc.y = fmaf(p.y, q.x, acc.y);
}

struct Args {
  const float* fvals;        // (K,) bin frequencies [Hz]
  const float *taur, *taut;  // bf16: (I, N), (I, M); f32: (N, I), (M, I) [s]
  const void *S, *X;         // bf16: block operands (K, 2Mp, 2Vp), (K, 2Np, 2Vp)
                             // or (K, 2Vp, 2Np) for 'rx'; f32: (K, M, V),
                             // (K, N, V) or (K, V, N) complex64
  float2* out;               // (I,) | (I, N) | (I, V)
  int64_t I;
  int N, M, V, K;
  int Mp, Np, Vp, Vz;        // bf16 paddings: multiples of KC2 (Np, Vp of the tile too)
  int Vh;                    // keep 'rx': columns of conj(Ahat) a chunk holds; 0: all V
};

// ---------------------------------------------------------------- bf16 path

// acc (this warp's 16 rows x NT n8 tiles of the block's BI x 2 VT tile) +=
// W (BI x KR) . B[:, col0 .. col0 + 2 VT), B (KR x ldb) bf16 in global
// memory, streamed through the ring by cp.async. W is resident in shared
// memory (row stride ldw).
template <int NT>
__device__ __forceinline__ void tc_product(float (&acc)[NT][4], const __nv_bfloat16* W, int ldw,
                                           const __nv_bfloat16* __restrict__ B, int ldb, int KR,
                                           int col0, __nv_bfloat16* ring) {
  constexpr int VT2 = 16 * NT;  // real columns of the tile
  constexpr int LDR = VT2 + 8;  // ring row stride: 16 bytes of padding against conflicts
  constexpr int SEG = VT2 / 8;  // 16-byte segments per ring row
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int mt = w & 3, ch = w >> 2;
  const int nc = KR / KC;
  auto load = [&](int c) {
    __nv_bfloat16* dst = ring + (c % STAGES) * KC * LDR;
    const __nv_bfloat16* src = B + (int64_t)c * KC * ldb + col0;
    for (int e = tid; e < KC * SEG; e += NTHR) {
      const int r = e / SEG, s = e % SEG;
      hmma::cp_async16(dst + r * LDR + s * 8, src + (int64_t)r * ldb + s * 8, 16);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nc) load(s);
    hmma::cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    hmma::cp_async_wait<STAGES - 2>();
    const __nv_bfloat16* Ab = W + c * KC;
    __syncthreads();  // chunk c visible; slot (c - 1) % STAGES free
    if (c + STAGES - 1 < nc) load(c + STAGES - 1);
    hmma::cp_async_commit();
    const __nv_bfloat16* Bs = ring + (c % STAGES) * KC * LDR;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[4];
      hmma::ldsm_x4(a, Ab + (16 * mt + (lane & 15)) * ldw + 16 * ks + (lane >> 4) * 8);
      const __nv_bfloat16* bp = Bs + (16 * ks + (lane & 15)) * LDR + ch * (8 * NT);
      if constexpr (NT == 1) {
        uint32_t b[2];
        hmma::ldsm_x2_t(b, bp);
        hmma::mma_bf16(acc[0], a, b[0], b[1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          hmma::ldsm_x4_t(b, bp + 8 * j + (lane >> 4) * 8);
          hmma::mma_bf16(acc[j], a, b[0], b[1]);
          hmma::mma_bf16(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
  }
  hmma::cp_async_wait<0>();
  __syncthreads();  // the ring is free again
}

// W[ii][2m, 2m + 1] = bf16 (Re, Im) of e^{sign 2 pi i frac(fk tau[i0 + ii, m])},
// zero for m >= L or a pixel past I; one warp per row, lanes along m
__device__ __forceinline__ void fill_phasors(__nv_bfloat16* W, int ldw,
                                             const float* __restrict__ tau, int L, int Lp,
                                             int64_t i0, int64_t I, float fk, float sign) {
  uint32_t* W32 = reinterpret_cast<uint32_t*>(W);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int ii = w; ii < BI; ii += NTHR / 32) {
    const bool live = i0 + ii < I;
    for (int m = lane; m < Lp; m += 32) {
      uint32_t v = 0u;
      if (live && m < L) {
        const float2 p = phasor<true>(fk, tau[(i0 + ii) * L + m], sign);
        v = hmma::pack_bf16(p.x, p.y);
      }
      W32[ii * (ldw / 2) + m] = v;
    }
  }
}

template <int KEEP, int NT>
struct TcEngine {
  static constexpr int VT = 8 * NT;  // complex columns of a tile
  static constexpr int R = 2;        // rows per thread
  static constexpr int C = NT;       // complex columns per thread
  static constexpr int HALVES = 2;   // column halves whose row sums meet in shared memory
  static constexpr bool CH = false;  // keep 'rx' with conj(Ahat) in chunks (TcChunked)
  struct Acc { float d[NT][4]; };

  const Args& a;
  __nv_bfloat16 *Wt, *Wr, *H, *ring;
  int ldt, ldr, ldh;
  const __nv_bfloat16 *S, *X, *Sk, *Xk;
  int64_t i0;
  float fk;
  int mt, ch, g, t;

  __device__ explicit TcEngine(const Args& args) : a(args) {
    ldt = 2 * a.Mp + 8;
    ldr = 2 * a.Np + 8;
    ldh = 2 * a.Vp + 8;
    __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(k4_smem);
    Wt = p;
    p += BI * ldt;
    Wr = p;
    if (KEEP != KEEP_RX) p += BI * ldr;
    H = p;
    if (KEEP == KEEP_RX) p += BI * ldh;
    ring = p;
    S = static_cast<const __nv_bfloat16*>(a.S);
    X = static_cast<const __nv_bfloat16*>(a.X);
    i0 = (int64_t)blockIdx.x * BI;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    mt = w & 3;
    ch = w >> 2;
    g = lane >> 2;
    t = lane & 3;
  }

  static size_t smem_bytes(const Args& a) {
    size_t e = BI * (2 * a.Mp + 8) + (KEEP != KEEP_RX ? BI * (2 * a.Np + 8) : 0);
    if (KEEP == KEEP_RX) e += BI * (2 * a.Vp + 8);
    e += (size_t)STAGES * KC * (16 * NT + 8);
    return e * sizeof(__nv_bfloat16);
  }

  __device__ void bin(int k) {
    fk = a.fvals[k];
    Sk = S + (int64_t)k * (2 * a.Mp) * (2 * a.Vp);
    Xk = X + (int64_t)k * (2 * a.Np) * (2 * a.Vp);
    __syncthreads();  // the previous bin is done with the tiles
    fill_phasors(Wt, ldt, a.taut, a.M, a.Mp, i0, a.I, fk, -1.f);
    if (KEEP != KEEP_RX) fill_phasors(Wr, ldr, a.taur, a.N, a.Np, i0, a.I, fk, 1.f);
    __syncthreads();
  }

  __device__ static void zero(Acc& x) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) x.d[j][q] = 0.f;
  }

  __device__ void prodA(Acc& x, int vt) {
    tc_product<NT>(x.d, Wt, ldt, Sk, 2 * a.Vp, 2 * a.Mp, vt * 2 * VT, ring);
  }
  __device__ void prodY(Acc& x, int vt) {
    tc_product<NT>(x.d, Wr, ldr, Xk, 2 * a.Vp, 2 * a.Np, vt * 2 * VT, ring);
  }
  // z = conj(Ahat) X_k^T over the receivers of tile nt; H is resident
  __device__ void prodZ(Acc& x, int nt) {
    tc_product<NT>(x.d, H, ldh, Xk, 2 * a.Np, 2 * a.Vz, nt * 2 * VT, ring);
  }

  // f(r, row, complex column in the tile, x value, y value)
  template <class F>
  __device__ void each(const Acc& x, const Acc& y, F f) const {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(h, 16 * mt + g + 8 * h, ch * 4 * NT + 4 * j + t,
          make_float2(x.d[j][2 * h], x.d[j][2 * h + 1]),
          make_float2(y.d[j][2 * h], y.d[j][2 * h + 1]));
  }

  // the four threads of a quad share their rows; half ch writes red[ch]
  __device__ void reduce_rows(float (&part)[R][3], float (*red)[3][BI]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float v = part[h][q];
        v = v + __shfl_xor_sync(0xffffffffu, v, 1);
        v = v + __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) red[ch][q][16 * mt + g + 8 * h] = v;
      }
  }

  __device__ void setH(int row, int v, float2 val) {
    reinterpret_cast<uint32_t*>(H)[row * (ldh / 2) + v] = hmma::pack_bf16(val.x, val.y);
  }
  // zero the columns [v0, Vz) of H that no tile wrote
  __device__ void zeroH(int v0) {
    for (int e = threadIdx.x; e < BI * (a.Vz - v0); e += NTHR) {
      const int row = e / (a.Vz - v0), v = v0 + e % (a.Vz - v0);
      reinterpret_cast<uint32_t*>(H)[row * (ldh / 2) + v] = 0u;
    }
  }
  __device__ float tau_rx(int64_t i, int n) const { return a.taur[i * a.N + n]; }
};

// ----------------------------------------------------------------- f32 path

template <int KEEP, int TM, int TN>
struct F32Engine {
  static constexpr int VT = 4 * TM * TN;  // complex columns of a tile
  static constexpr int CT = VT / TN;      // threads along the columns (<= 32)
  static constexpr int RT = BI / TM;      // threads along the rows
  static constexpr int R = TM;
  static constexpr int C = TN;
  static constexpr int HALVES = 1;
  static constexpr bool CH = false;  // keep 'rx' with conj(Ahat) in chunks (F32Chunked)
  static_assert(CT * RT == NTHR && CT <= 32, "thread layout");
  struct Acc { float2 v[TM][TN]; };

  const Args& a;
  float2 (*P)[BI];  // (LC, BI) the chunk of the left operand
  float2* Q;        // (LC, VT) the chunk of the right operand
  float2* H;        // 'rx': (V, BI) conj(Ahat)
  const float2 *S, *X, *Sk, *Xk;
  int64_t i0;
  float fk;
  int tr, tc;

  __device__ explicit F32Engine(const Args& args) : a(args) {
    float2* p = reinterpret_cast<float2*>(k4_smem);
    P = reinterpret_cast<float2(*)[BI]>(p);
    Q = p + LC * BI;
    H = Q + LC * VT;
    S = static_cast<const float2*>(a.S);
    X = static_cast<const float2*>(a.X);
    i0 = (int64_t)blockIdx.x * BI;
    tr = threadIdx.x / CT;
    tc = threadIdx.x % CT;
  }

  static size_t smem_bytes(const Args& a) {
    return ((size_t)LC * BI + (size_t)LC * VT + (KEEP == KEEP_RX ? (size_t)a.V * BI : 0))
           * sizeof(float2);
  }

  __device__ void bin(int k) {
    fk = a.fvals[k];
    Sk = S + (int64_t)k * a.M * a.V;
    Xk = X + (int64_t)k * a.N * a.V;
  }

  __device__ static void zero(Acc& x) {
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) x.v[r][c] = make_float2(0.f, 0.f);
  }

  // acc[r][c] += sum_l P(row r, l) Qg[l, col0 + col c] over l < L, Qg (L, J)
  // row-major; P's chunks from fillp(l, ii)
  template <class FillP>
  __device__ void gemm(Acc& x, FillP fillp, const float2* __restrict__ Qg, int L, int J,
                       int col0) {
    const int tid = threadIdx.x;
    for (int l0 = 0; l0 < L; l0 += LC) {
      const int lc = L - l0 < LC ? L - l0 : LC;
      __syncthreads();  // the previous chunk is consumed
      for (int e = tid; e < LC * BI; e += NTHR) {
        const int l = e / BI, ii = e % BI;
        P[l][ii] = l < lc ? fillp(l0 + l, ii) : make_float2(0.f, 0.f);
      }
      for (int e = tid; e < LC * VT; e += NTHR) {
        const int l = e / VT, j = e % VT;
        Q[e] = (l < lc && col0 + j < J) ? Qg[(int64_t)(l0 + l) * J + col0 + j]
                                        : make_float2(0.f, 0.f);
      }
      __syncthreads();
      for (int l = 0; l < lc; ++l) {
        float2 p[TM], q[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) p[r] = P[l][tr + RT * r];
#pragma unroll
        for (int c = 0; c < TN; ++c) q[c] = Q[l * VT + tc + CT * c];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c) cmac(x.v[r][c], p[r], q[c]);
      }
    }
  }

  __device__ void prodA(Acc& x, int vt) {
    gemm(x, [&](int m, int ii) {
      return i0 + ii < a.I ? phasor<true>(fk, a.taut[(int64_t)m * a.I + i0 + ii], -1.f)
                           : make_float2(0.f, 0.f);
    }, Sk, a.M, a.V, vt * VT);
  }
  __device__ void prodY(Acc& x, int vt) {
    gemm(x, [&](int n, int ii) {
      return i0 + ii < a.I ? phasor<true>(fk, a.taur[(int64_t)n * a.I + i0 + ii], 1.f)
                           : make_float2(0.f, 0.f);
    }, Xk, a.N, a.V, vt * VT);
  }
  __device__ void prodZ(Acc& x, int nt) {
    gemm(x, [&](int v, int ii) { return H[v * BI + ii]; }, Xk, a.V, a.N, nt * VT);
  }

  template <class F>
  __device__ void each(const Acc& x, const Acc& y, F f) const {
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) f(r, tr + RT * r, tc + CT * c, x.v[r][c], y.v[r][c]);
  }

  // the CT consecutive lanes of one tr share their rows
  __device__ void reduce_rows(float (&part)[R][3], float (*red)[3][BI]) const {
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float v = part[r][q];
#pragma unroll
        for (int o = CT / 2; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
        if (tc == 0) red[0][q][tr + RT * r] = v;
      }
  }

  __device__ void setH(int row, int v, float2 val) {
    if (v < a.V) H[v * BI + row] = val;
  }
  __device__ void zeroH(int) {}
  __device__ float tau_rx(int64_t i, int n) const { return a.taur[(int64_t)n * a.I + i]; }
};

// ------------------------------------- keep 'rx' with conj(Ahat) in chunks

// The tensor-core engine with H holding Vh columns of conj(Ahat) (K4(b)):
// the ring follows the smaller H, and z reads the chunk's rows of X_k^T.
template <int NT>
struct TcChunked : TcEngine<KEEP_RX, NT> {
  using Base = TcEngine<KEEP_RX, NT>;
  using typename Base::Acc;
  static constexpr bool CH = true;

  __device__ explicit TcChunked(const Args& args) : Base(args) {
    this->ldh = 2 * args.Vh + 8;
    this->ring = this->H + BI * this->ldh;
  }

  static size_t smem_bytes(const Args& a) {
    const size_t e = BI * (2 * a.Mp + 8) + BI * (2 * a.Vh + 8)
                     + (size_t)STAGES * KC * (16 * NT + 8);
    return e * sizeof(__nv_bfloat16);
  }

  // z = conj(Ahat) X_k^T over the receivers of tile nt, from the chunk's
  // rows v0 .. v0 + min(Vh, Vz - v0) of X_k^T
  __device__ void prodZc(Acc& x, int nt, int v0) {
    const int vz = min(this->a.Vh, this->a.Vz - v0);
    tc_product<NT>(x.d, this->H, this->ldh,
                   this->Xk + (int64_t)(2 * v0) * (2 * this->a.Np), 2 * this->a.Np, 2 * vz,
                   nt * 2 * Base::VT, this->ring);
  }
  __device__ void setHc(int row, int vl, int, float2 val) { this->setH(row, vl, val); }
  // zero the chunk's columns [vw, min(Vh, Vz - v0)) that no tile wrote
  __device__ void zeroHc(int v0, int vw) {
    const int w = min(this->a.Vh, this->a.Vz - v0) - vw;
    for (int e = threadIdx.x; e < BI * w; e += NTHR)
      reinterpret_cast<uint32_t*>(this->H)[(e / w) * (this->ldh / 2) + vw + e % w] = 0u;
  }
};

// The f32 engine with H (Vh, BI): z reads the chunk's rows of X_k^T.
template <int TM, int TN>
struct F32Chunked : F32Engine<KEEP_RX, TM, TN> {
  using Base = F32Engine<KEEP_RX, TM, TN>;
  using typename Base::Acc;
  static constexpr bool CH = true;

  __device__ explicit F32Chunked(const Args& args) : Base(args) {}

  static size_t smem_bytes(const Args& a) {
    return ((size_t)LC * BI + (size_t)LC * Base::VT + (size_t)a.Vh * BI) * sizeof(float2);
  }

  __device__ void prodZc(Acc& x, int nt, int v0) {
    this->gemm(x, [&](int v, int ii) { return this->H[v * BI + ii]; },
               this->Xk + (int64_t)v0 * this->a.N, min(this->a.Vh, this->a.V - v0), this->a.N,
               nt * Base::VT);
  }
  __device__ void setHc(int row, int vl, int v, float2 val) {
    if (v < this->a.V) this->H[vl * BI + row] = val;
  }
  __device__ void zeroHc(int, int) {}
};

// ------------------------------------------------------------ the keep modes

// out(i, n) += Wrx(i, n) z(i, n) over the receivers of tile nt
template <class E>
__device__ __forceinline__ void rx_epilogue(const E& e, const typename E::Acc& Z, int nt,
                                            const Args& a, int64_t i0) {
  e.each(Z, Z, [&](int, int row, int c, float2 z, float2) {
    const int n = nt * E::VT + c;
    const int64_t i = i0 + row;
    if (n >= a.N || i >= a.I) return;
    const float2 p = phasor<false>(e.fk, e.tau_rx(i, n), 1.f);
    float2* o = a.out + i * a.N + n;
    *o = make_float2(o->x + (p.x * z.x - p.y * z.y), o->y + (p.x * z.y + p.y * z.x));
  });
}

template <int HALVES>
__device__ __forceinline__ float row_total(float (*red)[3][BI], int q, int row) {
  return HALVES == 2 ? red[0][q][row] + red[1][q][row] : red[0][q][row];
}

template <int HALVES>
__device__ __forceinline__ float inv_norm(float (*red)[3][BI], int row) {
  const float nrm = sqrtf(row_total<HALVES>(red, 0, row));
  return 1.f / (nrm == 0.f ? 1.f : nrm);
}

template <int KEEP, class E>
__global__ void __launch_bounds__(NTHR) adjoint_k4_kernel(const __grid_constant__ Args a) {
  __shared__ float red[2][3][BI];  // per column half: |A|^2, Re and Im of y conj(A)
  E e(a);
  const int tid = threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.x * BI;
  const int nvt = (a.V + E::VT - 1) / E::VT;
  float2 bsum = make_float2(0.f, 0.f);  // keep '': pixel i0 + tid, tid < BI

  for (int k = 0; k < a.K; ++k) {
    e.bin(k);
    float part[E::R][3];
#pragma unroll
    for (int r = 0; r < E::R; ++r) part[r][0] = part[r][1] = part[r][2] = 0.f;
    for (int vt = 0; vt < nvt; ++vt) {
      typename E::Acc A, Y;
      E::zero(A);
      E::zero(Y);
      e.prodA(A, vt);
      if (KEEP == SUM) e.prodY(Y, vt);
      e.each(A, Y, [&](int r, int, int, float2 av, float2 yv) {
        part[r][0] = part[r][0] + (av.x * av.x + av.y * av.y);
        if (KEEP == SUM) {
          part[r][1] = part[r][1] + (yv.x * av.x + yv.y * av.y);
          part[r][2] = part[r][2] + (yv.y * av.x - yv.x * av.y);
        }
      });
    }
    e.reduce_rows(part, red);
    __syncthreads();

    if (KEEP == SUM) {
      if (tid < BI) {
        const float inv = inv_norm<E::HALVES>(red, tid);
        bsum.x = bsum.x + row_total<E::HALVES>(red, 1, tid) * inv;
        bsum.y = bsum.y + row_total<E::HALVES>(red, 2, tid) * inv;
      }
    } else if (KEEP == KEEP_TX) {
      for (int vt = 0; vt < nvt; ++vt) {
        typename E::Acc A, Y;
        E::zero(A);
        E::zero(Y);
        e.prodA(A, vt);
        e.prodY(Y, vt);
        e.each(A, Y, [&](int, int row, int c, float2 av, float2 yv) {
          const int v = vt * E::VT + c;
          const int64_t i = i0 + row;
          if (v >= a.V || i >= a.I) return;
          const float inv = inv_norm<E::HALVES>(red, row);
          const float ar = av.x * inv, ai = av.y * inv;
          float2* o = a.out + i * a.V + v;
          *o = make_float2(o->x + (yv.x * ar + yv.y * ai), o->y + (yv.y * ar - yv.x * ai));
        });
      }
    } else if constexpr (E::CH) {
      // K4(b): conj(Ahat) by chunks of Vh columns, each chunk's Wrx z
      // added into the output
      const int tpc = a.Vh / E::VT, nnt = (a.N + E::VT - 1) / E::VT;
      for (int c0 = 0; c0 < nvt; c0 += tpc) {
        const int c1 = min(nvt, c0 + tpc);
        for (int vt = c0; vt < c1; ++vt) {
          typename E::Acc A;
          E::zero(A);
          e.prodA(A, vt);
          e.each(A, A, [&](int, int row, int c, float2 av, float2) {
            const float inv = inv_norm<E::HALVES>(red, row);
            e.setHc(row, (vt - c0) * E::VT + c, vt * E::VT + c,
                    make_float2(av.x * inv, -(av.y * inv)));
          });
        }
        e.zeroHc(c0 * E::VT, (c1 - c0) * E::VT);
        __syncthreads();  // the chunk of conj(Ahat) is complete
        for (int nt = 0; nt < nnt; ++nt) {
          typename E::Acc Z;
          E::zero(Z);
          e.prodZc(Z, nt, c0 * E::VT);
          rx_epilogue(e, Z, nt, a, i0);
        }
      }
    } else {
      for (int vt = 0; vt < nvt; ++vt) {
        typename E::Acc A;
        E::zero(A);
        e.prodA(A, vt);
        e.each(A, A, [&](int, int row, int c, float2 av, float2) {
          const float inv = inv_norm<E::HALVES>(red, row);
          e.setH(row, vt * E::VT + c, make_float2(av.x * inv, -(av.y * inv)));
        });
      }
      e.zeroH(nvt * E::VT);
      __syncthreads();  // conj(Ahat) is complete
      const int nnt = (a.N + E::VT - 1) / E::VT;
      for (int nt = 0; nt < nnt; ++nt) {
        typename E::Acc Z;
        E::zero(Z);
        e.prodZ(Z, nt);
        rx_epilogue(e, Z, nt, a, i0);
      }
    }
  }
  if (KEEP == SUM && tid < BI && i0 + tid < a.I) a.out[i0 + tid] = bsum;
}

template <int KEEP, class E>
cudaError_t launch(const Args& a, cudaStream_t s) {
  auto kern = adjoint_k4_kernel<KEEP, E>;
  const size_t smem = E::smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.I + BI - 1) / BI)), block(NTHR);
  kern<<<grid, block, smem, s>>>(a);
  return cudaGetLastError();
}

// the shared memory a Hopper block may opt into (232448 bytes), less room
// for the kernel's static arrays
constexpr size_t SMEM_LIMIT = 232448 - 4096;

// bf16 tiles of VT = 8 NT complex columns, the phasor tiles of a bin
// resident in shared memory. Where they do not fit, the wrapper takes the
// wide route (adjoint_k4_wide) instead, and this refuses the launch.
template <int KEEP, int NT>
cudaError_t launch_nt(const Args& a, cudaStream_t s) {
  if constexpr (KEEP == KEEP_RX && NT == 8) {
    if (a.Vh > 0) {  // conj(Ahat) by chunks
      if (TcChunked<NT>::smem_bytes(a) > SMEM_LIMIT) return cudaErrorInvalidValue;
      return launch<KEEP, TcChunked<NT>>(a, s);
    }
  }
  if (TcEngine<KEEP, NT>::smem_bytes(a) > SMEM_LIMIT) return cudaErrorInvalidValue;
  return launch<KEEP, TcEngine<KEEP, NT>>(a, s);
}

template <int KEEP>
cudaError_t launch_tc(int nt, const Args& a, cudaStream_t s) {
  switch (nt) {
    case 1: return launch_nt<KEEP, 1>(a, s);
    case 2: return launch_nt<KEEP, 2>(a, s);
    case 4: return launch_nt<KEEP, 4>(a, s);
    case 8: return launch_nt<KEEP, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// f32 tiles by VT: 8 (2 x 1 per thread), 16 (2 x 2), 32 (4 x 2), 64 (4 x 4)
template <int KEEP>
cudaError_t launch_f32(int vt, const Args& a, cudaStream_t s) {
  if constexpr (KEEP == KEEP_RX) {
    if (a.Vh > 0) return launch<KEEP, F32Chunked<4, 4>>(a, s);  // K4(b), vt 64
  }
  switch (vt) {
    case 8: return launch<KEEP, F32Engine<KEEP, 2, 1>>(a, s);
    case 16: return launch<KEEP, F32Engine<KEEP, 2, 2>>(a, s);
    case 32: return launch<KEEP, F32Engine<KEEP, 4, 2>>(a, s);
    case 64: return launch<KEEP, F32Engine<KEEP, 4, 4>>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int KEEP>
cudaError_t launch_p(int bf16, int vt, const Args& a, cudaStream_t s) {
  return bf16 ? launch_tc<KEEP>(vt / 8, a, s) : launch_f32<KEEP>(vt, a, s);
}

// ------------------------------------------------- bf16, the wide route
//
// Where a 64-pixel block's phasor tiles do not fit in shared memory (M + N
// past ~780, the 32 x 32 matrix array's 1024 elements), the bin's phasors
// are built once into a table in device memory (phasor_table_kernel:
// Wtx (G, I, 2 Mp), Wrx (G, I, 2 Np), bf16 (Re, Im) pairs, for a group of
// G bins), and the products stream the table as their left operand, as
// they stream S_k and X_k as their right one. A block owns WM = 128 pixels
// and one tile of WVT = 64 complex columns (blockIdx.x: the column tile
// fastest, so the tiles of one pixel block run together and share its table
// rows in L2): two warpgroups of 64 rows x 128 real columns, wgmma
// m64n128k16 from shared memory in the 128-byte swizzle, fed by a cp.async
// ring of both operands in stages of WKC = 64 rows. Each streamed byte
// feeds 128 flop. On an H100 80GB HBM3 at 700 W (tools/k4b_torch.py, the
// volume's keep ''): mma.sync with ldmatrix on the same tiles took 1.21 s
// against wgmma's 0.84-0.85 s, and wgmma from unswizzled tiles 1.85-2.06 s.
//
// The norm factors out of every pixel's row, so A is computed once a bin:
//   keep '':  per tile, the row sums |A|^2 and y conj(A) -> part; the finish
//             adds (sum y conj(A)) / ||A_i|| into b(i) bin by bin;
//   keep tx:  part gets |A|^2, the scratch Q = y conj(A) (G, I, V); the finish
//             adds Q / ||A_i|| into b(i, v);
//   keep rx:  part gets |A|^2, the scratch A (G, I, Vp) complex64; then
//             H = conj(A) / ||A_i|| rounded to bf16 (wide_round: the plain
//             version's operand, bit for bit; scaling z after the product
//             instead rounds conj(A) and differed from the plain version
//             by 2.2-2.4e-3 of the image's peak on random data), z = H X_k^T
//             (wide_rx_kernel) and b(i, n) += Wrx(i, n) z, Wrx accurate,
//             built once per (bin, pixel, receiver).
// Each output belongs to one thread, and every sum runs in a fixed order.

constexpr int WM = 128;            // pixels per block
constexpr int WN = 128;            // real columns of a tile
constexpr int WVT = WN / 2;        // complex columns of a tile
constexpr int WKC = 64;            // real rows of both operands a ring stage
constexpr int WSTAGE = WM * WKC + WKC * WN;  // bf16 elements of a ring stage
static_assert(WKC == 64 && WN == 128, "the 128-byte swizzle takes rows of 64 bf16");
// ring depths: 4 stages for the two-product kernels (one block an SM: 2 x 64
// accumulators a thread), 3 for the one-product kernels (W_AH,
// wide_rx_kernel), so that two of their blocks share an SM
constexpr int WST2 = 4, WST1 = 3;
// dynamic shared memory of a ring of ST stages, with room to align it to 1 KB
constexpr int wide_smem(int ST) { return ST * WSTAGE * 2 + 1024; }
static_assert(2 * (wide_smem(WST1) + 1024) <= 233472, "two one-product blocks an SM");

enum WideMode { W_SUM = 0, W_TX = 1, W_AH = 2 };

struct WideArgs {
  const float* fvals;            // (G,) the group's bin frequencies [Hz]
  const float* taur;             // (I, N) [s], keep 'rx'
  const __nv_bfloat16 *Wt, *Wr;  // phasor tables (G, I, 2 Mp), (G, I, 2 Np)
  const __nv_bfloat16 *S, *X;    // block operands of the group's bins (G, 2Mp, 2Vp),
                                 // (G, 2Np, 2Vp), or (G, 2Vp, 2Np) for 'rx'
  float4* part;                  // (G, Vp / WVT, I) per-tile row sums
  float* inv;                    // (G, I) 1 / ||A_i|| (1 where the norm is 0)
  void* scr;                     // 'tx': Q (G, I, V) float2; 'rx': A (G, I, Vp) float2
  uint32_t* H;                   // 'rx': conj(A) / ||A_i|| (G, I, Vp) bf16 pairs
  float2* out;                   // (I,) | (I, N) | (I, V)
  int64_t I;
  int N, M, V, G, Mp, Np, Vp, Vz;
};

// W[g][i][2m, 2m + 1] = bf16 (Re, Im) of e^{sign 2 pi i frac(fk[g] tau[i, m])},
// zero for L <= m < Lp: the phasors of G bins from one read of tau. A
// thread takes 4 neighbouring m (Lp is a multiple of 4): 16-byte stores,
// and with VEC (L a multiple of 4) 16-byte loads, so that enough bytes are
// in flight for the memory rate
template <bool VEC>
__global__ void phasor_table_kernel(const float* __restrict__ fvals,
                                    const float* __restrict__ tau, uint4* __restrict__ W,
                                    int64_t I, int L, int Lp, int G, float sign) {
  const int64_t n4 = I * Lp / 4;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n4;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = 4 * e / Lp;
    const int m = (int)(4 * e - i * Lp);
    float t[4];
    if (VEC && m < L) {
      const float4 v = *reinterpret_cast<const float4*>(tau + i * L + m);
      t[0] = v.x, t[1] = v.y, t[2] = v.z, t[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) t[q] = m + q < L ? tau[i * L + m + q] : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = 0u;
        if (m + q < L) {
          const float2 p = phasor<true>(fvals[g], t[q], sign);
          v[q] = hmma::pack_bf16(p.x, p.y);
        }
      }
      W[g * n4 + e] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// acc (this warpgroup's 64 rows of the block's WM x WN tile) += L[0 .. WM)
// . B[:, col0 .. col0 + WN) over KR rows: L (rows x KR, row stride ldl;
// rows past `rows` read as zero) and B (KR x ldb) bf16 in device memory,
// both streamed through the ring by cp.async in the 128-byte swizzle of
// wgmma (a row of 128 bytes holds 8 chunks of 16; in each 1 KB atom of 8
// rows, chunk j of row q lies at j ^ q): A (K-major, WKC = 64 bf16 a row)
// in atoms of 8 pixel rows, B (N-major) in atoms of 8 rows of K by 64
// columns, two along N, then wgmma
template <int WST>
__device__ __forceinline__ void wide_product(float (&acc)[64],
                                             const __nv_bfloat16* __restrict__ L, int64_t ldl,
                                             int64_t rows, const __nv_bfloat16* __restrict__ B,
                                             int64_t ldb, int KR, int col0,
                                             __nv_bfloat16* ring) {
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nc = KR / WKC;
  auto load = [&](int c) {
    __nv_bfloat16* As = ring + (c % WST) * WSTAGE;
    __nv_bfloat16* Bs = As + WM * WKC;
    for (int e = tid; e < WM * 8; e += NTHR) {  // row r, chunk j
      const int r = e >> 3, j = e & 7;
      const bool ok = r < rows;
      hmma::cp_async16(As + r * 64 + ((j ^ (r & 7)) << 3),
                       L + (ok ? r : 0) * ldl + c * WKC + j * 8, ok ? 16 : 0);
    }
    for (int e = tid; e < WKC * (WN / 8); e += NTHR) {  // row k, chunk n8 of 16
      const int k = e / (WN / 8), n8 = e % (WN / 8), q = k & 7;
      hmma::cp_async16(Bs + ((k >> 3) * 2 + (n8 >> 3)) * 512 + q * 64 + (((n8 & 7) ^ q) << 3),
                       B + (int64_t)(c * WKC + k) * ldb + col0 + n8 * 8, 16);
    }
  };
  // stages in flight: WST - 2 loading ahead, one being multiplied, and the
  // one before it, whose products may still be running
#pragma unroll
  for (int s = 0; s < WST - 2; ++s) {
    if (s < nc) load(s);
    hmma::cp_async_commit();
  }
  hmma::wgmma_hold(acc);
  for (int c = 0; c < nc; ++c) {
    hmma::cp_async_wait<WST - 3>();
    hmma::fence_proxy_async();
    __syncthreads();  // stage c visible to wgmma; the products of c - 2 done
    if (c + WST - 2 < nc) load(c + WST - 2);  // into slot (c - 2) % WST
    hmma::cp_async_commit();
    const __nv_bfloat16* As = ring + (c % WST) * WSTAGE;
    const __nv_bfloat16* Bs = As + WM * WKC;
    hmma::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < WKC / 16; ++ks)
      hmma::wgmma_m64n128k16(acc, hmma::wgmma_desc_sw128(As + wg * 64 * 64 + ks * 16, 16, 1024),
                             hmma::wgmma_desc_sw128(Bs + ks * 2 * 1024, 1024, 2048));
    hmma::wgmma_commit();
    hmma::wgmma_wait<1>();  // the products of stage c - 1 done
  }
  hmma::wgmma_wait<0>();
  hmma::wgmma_hold(acc);
  hmma::cp_async_wait<0>();
  __syncthreads();  // the ring is free again
}

// the ring, at the first 1 KB boundary of the dynamic shared memory (the
// swizzle's atoms are 1 KB aligned)
__device__ __forceinline__ __nv_bfloat16* wide_ring() {
  const uint32_t off = (1024u - (hmma::smem_addr(k4_smem) & 1023u)) & 1023u;
  return reinterpret_cast<__nv_bfloat16*>(k4_smem + off);
}

__device__ __forceinline__ void wide_zero(float (&x)[64]) {
#pragma unroll
  for (int q = 0; q < 64; ++q) x[q] = 0.f;
}

// f(h, row in the block, complex column in the tile, A value, Y value) for
// each of this thread's accumulator pairs: row 64 (warpgroup) + 16 (warp in
// it) + lane / 4 + 8 h, column 4 j + lane % 4
template <class F>
__device__ __forceinline__ void wide_each(const float (&A)[64], const float (&Y)[64], F f) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f(h, row0 + 8 * h, 4 * j + t, make_float2(A[4 * j + 2 * h], A[4 * j + 2 * h + 1]),
        make_float2(Y[4 * j + 2 * h], Y[4 * j + 2 * h + 1]));
}

// A = Wtx S_k (and, but for W_AH, Y = Wrx X_k) on the tile (blockIdx.x %
// nct, pixel block blockIdx.x / nct) of bin g = blockIdx.y; the row sums of
// the tile into part, and Q or A into the scratch
template <int MODE>
__global__ void __launch_bounds__(NTHR, MODE == W_AH ? 2 : 1)
    wide_kernel(const __grid_constant__ WideArgs a) {
  constexpr int ST = MODE == W_AH ? WST1 : WST2;
  __nv_bfloat16* ring = wide_ring();
  const int nct = a.Vp / WVT, ct = blockIdx.x % nct, g = blockIdx.y;
  const int64_t i0 = (int64_t)(blockIdx.x / nct) * WM, rows = a.I - i0;
  float A[64], Y[64];
  wide_zero(A);
  wide_zero(Y);
  wide_product<ST>(A, a.Wt + ((int64_t)g * a.I + i0) * (2 * a.Mp), 2 * a.Mp, rows,
                   a.S + (int64_t)g * (2 * a.Mp) * (2 * a.Vp), 2 * a.Vp, 2 * a.Mp, ct * WN,
                   ring);
  if (MODE != W_AH)
    wide_product<ST>(Y, a.Wr + ((int64_t)g * a.I + i0) * (2 * a.Np), 2 * a.Np, rows,
                 a.X + (int64_t)g * (2 * a.Np) * (2 * a.Vp), 2 * a.Vp, 2 * a.Np, ct * WN, ring);
  float part[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h) part[h][0] = part[h][1] = part[h][2] = 0.f;
  wide_each(A, Y, [&](int h, int row, int c, float2 av, float2 yv) {
    part[h][0] = part[h][0] + (av.x * av.x + av.y * av.y);
    const int v = ct * WVT + c;
    if (MODE == W_AH) {
      if (row < rows) static_cast<float2*>(a.scr)[((int64_t)g * a.I + i0 + row) * a.Vp + v] = av;
    } else {
      const float qr = yv.x * av.x + yv.y * av.y, qi = yv.y * av.x - yv.x * av.y;
      if (MODE == W_SUM) {
        part[h][1] = part[h][1] + qr;
        part[h][2] = part[h][2] + qi;
      } else if (row < rows && v < a.V) {
        static_cast<float2*>(a.scr)[((int64_t)g * a.I + i0 + row) * a.V + v] =
            make_float2(qr, qi);
      }
    }
  });
  // the four threads of a quad hold a row's 64 columns between them
  const int lane = threadIdx.x & 31;
  const int row0 = 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      part[h][q] = part[h][q] + __shfl_xor_sync(0xffffffffu, part[h][q], 1);
      part[h][q] = part[h][q] + __shfl_xor_sync(0xffffffffu, part[h][q], 2);
    }
    if ((lane & 3) == 0 && row0 + 8 * h < rows)
      a.part[((int64_t)g * nct + ct) * a.I + i0 + row0 + 8 * h] =
          make_float4(part[h][0], part[h][1], part[h][2], 0.f);
  }
}

// the sum over the column tiles of bin g's row sums of pixel i
__device__ __forceinline__ float4 wide_rowsum(const WideArgs& a, int g, int64_t i) {
  const int nct = a.Vp / WVT;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int ct = 0; ct < nct; ++ct) {
    const float4 p = a.part[((int64_t)g * nct + ct) * a.I + i];
    s.x = s.x + p.x;
    s.y = s.y + p.y;
    s.z = s.z + p.z;
  }
  return s;
}

__device__ __forceinline__ float wide_inv(float s) {
  const float nrm = sqrtf(s);
  return 1.f / (nrm == 0.f ? 1.f : nrm);
}

// keep '': b(i) += sum_v y conj(A) / ||A_i||, bin by bin
__global__ void wide_sum_finish(const __grid_constant__ WideArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.I) return;
  float2 o = a.out[i];
  for (int g = 0; g < a.G; ++g) {
    const float4 s = wide_rowsum(a, g, i);
    const float inv = wide_inv(s.x);
    o.x = o.x + s.y * inv;
    o.y = o.y + s.z * inv;
  }
  a.out[i] = o;
}

__global__ void wide_norm(const __grid_constant__ WideArgs a) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.G * a.I) return;
  a.inv[e] = wide_inv(wide_rowsum(a, (int)(e / a.I), e % a.I).x);
}

// keep 'tx': b(i, v) += Q(g, i, v) / ||A_i||, bin by bin
__global__ void wide_tx_finish(const __grid_constant__ WideArgs a) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x, n = a.I * a.V;
  if (e >= n) return;
  const int64_t i = e / a.V;
  const float2* Q = static_cast<const float2*>(a.scr);
  float2 o = a.out[e];
  for (int g = 0; g < a.G; ++g) {
    const float2 q = Q[g * n + e];
    const float inv = a.inv[g * a.I + i];
    o.x = o.x + q.x * inv;
    o.y = o.y + q.y * inv;
  }
  a.out[e] = o;
}

// keep 'rx': H = conj(A / ||A_i||) rounded to bf16, as the plain version's
// operand
__global__ void wide_round(const __grid_constant__ WideArgs a) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.G * a.I * a.Vp) return;
  const float2 v = static_cast<const float2*>(a.scr)[e];
  const float inv = a.inv[e / a.Vp];
  a.H[e] = hmma::pack_bf16(v.x * inv, -(v.y * inv));
}

// keep 'rx': z = H X_k^T over the receivers of tile blockIdx.x % nnt, bin
// by bin; b(i, n) += Wrx(i, n) z(i, n)
__global__ void __launch_bounds__(NTHR, 2) wide_rx_kernel(const __grid_constant__ WideArgs a) {
  __nv_bfloat16* ring = wide_ring();
  const int nnt = a.Np / WVT, nt = blockIdx.x % nnt;
  const int64_t i0 = (int64_t)(blockIdx.x / nnt) * WM, rows = a.I - i0;
  const __nv_bfloat16* H = reinterpret_cast<const __nv_bfloat16*>(a.H);
  float Z[64];
  for (int g = 0; g < a.G; ++g) {
    wide_zero(Z);
    wide_product<WST1>(Z, H + ((int64_t)g * a.I + i0) * (2 * a.Vp), 2 * a.Vp, rows,
                 a.X + (int64_t)g * (2 * a.Vp) * (2 * a.Np), 2 * a.Np, 2 * a.Vz, nt * WN, ring);
    const float fk = a.fvals[g];
    wide_each(Z, Z, [&](int, int row, int c, float2 z, float2) {
      const int n = nt * WVT + c;
      if (row >= rows || n >= a.N) return;
      const int64_t i = i0 + row;
      const float2 p = phasor<false>(fk, a.taur[i * a.N + n], 1.f);
      float2* o = a.out + i * a.N + n;
      *o = make_float2(o->x + (p.x * z.x - p.y * z.y), o->y + (p.x * z.y + p.y * z.x));
    });
  }
}

template <class Kern>
cudaError_t wide_launch(Kern kern, int smem, dim3 grid, const WideArgs& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, NTHR, smem, s>>>(a);
  return cudaGetLastError();
}

unsigned blocks_of(int64_t n, int per) { return (unsigned)((n + per - 1) / per); }

cudaError_t wide_run(const WideArgs& a, int keep, cudaStream_t s) {
  const unsigned pb = blocks_of(a.I, WM);
  const dim3 grid(pb * (a.Vp / WVT), a.G);
  cudaError_t err;
  if (keep == SUM) {
    if ((err = wide_launch(wide_kernel<W_SUM>, wide_smem(WST2), grid, a, s)) != cudaSuccess)
      return err;
    wide_sum_finish<<<blocks_of(a.I, 256), 256, 0, s>>>(a);
    return cudaGetLastError();
  }
  const int mode = keep == KEEP_TX ? W_TX : W_AH;
  err = mode == W_TX ? wide_launch(wide_kernel<W_TX>, wide_smem(WST2), grid, a, s)
                     : wide_launch(wide_kernel<W_AH>, wide_smem(WST1), grid, a, s);
  if (err != cudaSuccess) return err;
  wide_norm<<<blocks_of(a.G * a.I, 256), 256, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (keep == KEEP_TX) {
    wide_tx_finish<<<blocks_of(a.I * a.V, 256), 256, 0, s>>>(a);
    return cudaGetLastError();
  }
  wide_round<<<blocks_of(a.G * a.I * a.Vp, 256), 256, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return wide_launch(wide_rx_kernel, wide_smem(WST1), dim3(pb * (a.Np / WVT)), a, s);
}

}  // namespace

// For each u[j]: (sin, cos) of 2 pi frac(u) by the accurate routine (the
// plain version's) and by the special function unit (the products'
// phasors), as out[j] = (sin, cos, sin_sfu, cos_sfu); a measurement of the
// phase error.
__global__ void turns_probe_kernel(const float* __restrict__ u, float4* __restrict__ out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s, c, s2, c2;
  hmma::sincos_turns(u[j], &s, &c);
  hmma::sincos_turns_sfu(u[j], &s2, &c2);
  out[j] = make_float4(s, c, s2, c2);
}

extern "C" int turns_sincos_probe(const float* u, void* out, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || n <= 0) return (int)err;
  turns_probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(u, (float4*)out, n);
  return (int)cudaGetLastError();
}

// Launch K4 on `stream` of device `device`. fvals (K,). bf16 != 0: taur
// (I, N) and taut (I, M) [s]; S (K, 2Mp, 2Vp) and X (K, 2Np, 2Vp), or
// (K, 2Vp, 2Np) for keep 1 ('rx'), the bf16 real-block operands. bf16 == 0: taur (N, I), taut (M, I); S (K, M, V)
// and X (K, N, V), or (K, V, N) for 'rx', interleaved complex64. out
// complex64 (I,) for keep 0 (''), (I, N) for 'rx' and (I, V) for keep 2
// ('tx'), zeroed by the caller for 'rx' and 'tx'. vt is the complex columns
// of a tile, 8, 16, 32 or 64. Mp, Np, Vp and Vz (bf16 only) are M, N, V
// padded: Mp and Vz to multiples of 16 (the complex rows of a ring stage),
// Np and Vp to multiples of 16 and of vt. Vh (keep 'rx', vt 64 only): 0, or
// the columns of conj(Ahat) per chunk, a multiple of 64 (K4(b)). Returns the
// cudaError_t of the launch; 0 is success.
extern "C" int adjoint_k4(const float* fvals, const float* taur, const float* taut,
                          const void* S, const void* X, void* out, long long I, int N, int M,
                          int V, int K, int Mp, int Np, int Vp, int Vz, int keep, int bf16,
                          int vt, int Vh, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (I <= 0) return (int)cudaSuccess;
  if (N <= 0 || M <= 0 || V <= 0 || K <= 0 || (vt != 8 && vt != 16 && vt != 32 && vt != 64))
    return (int)cudaErrorInvalidValue;
  if (bf16 && (Mp < M || Mp % KC2 || Np < N || Np % KC2 || Np % vt || Vp < V || Vp % KC2
               || Vp % vt || Vz < V || Vz % KC2 || Vz > Vp))
    return (int)cudaErrorInvalidValue;
  // chunks of conj(Ahat): keep 'rx' with 64-column tiles, a whole number of tiles
  if (Vh < 0 || (Vh > 0 && (keep != KEEP_RX || vt != 64 || Vh % vt)))
    return (int)cudaErrorInvalidValue;
  const Args a{fvals, taur, taut, S, X, (float2*)out, (int64_t)I, N, M, V, K, Mp, Np, Vp, Vz,
               Vh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (keep) {
    case SUM: err = launch_p<SUM>(bf16, vt, a, s); break;
    case KEEP_RX: err = launch_p<KEEP_RX>(bf16, vt, a, s); break;
    case KEEP_TX: err = launch_p<KEEP_TX>(bf16, vt, a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The bf16 phasor table of the wide route: W (G, I, 2 Lp) bf16, row (g, i)
// the (Re, Im) pairs of e^{sign 2 pi i frac(fvals[g] tau[i, m])} for m < L,
// zero up to Lp (a multiple of 4); tau (I, L) [s]; W and tau 16-byte
// aligned. Returns the cudaError_t of the launch.
extern "C" int phasor_table(const float* fvals, const float* tau, void* W, long long I, int L,
                            int Lp, int G, float sign, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (I <= 0 || G <= 0) return (int)cudaSuccess;
  if (L <= 0 || Lp < L || Lp % 4) return (int)cudaErrorInvalidValue;
  const int64_t n4 = (int64_t)I * Lp / 4;
  const unsigned blocks = (unsigned)std::min<int64_t>((n4 + 255) / 256, 132 * 8);
  if (L % 4 == 0)
    phasor_table_kernel<true><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        fvals, tau, (uint4*)W, (int64_t)I, L, Lp, G, sign);
  else
    phasor_table_kernel<false><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        fvals, tau, (uint4*)W, (int64_t)I, L, Lp, G, sign);
  return (int)cudaGetLastError();
}

// The wide route of K4 in bf16 for one group of G bins and I pixels, on
// `stream` of device `device`: fvals (G,) the group's frequencies; taur
// (I, N) [s] (keep 1); Wt (G, I, 2 Mp), Wr (G, I, 2 Np) the phasor tables
// of phasor_table (Wr unused for keep 1); S (G, 2Mp, 2Vp) and X (G, 2Np,
// 2Vp), or (G, 2Vp, 2Np) for keep 1 ('rx'), the block operands of the
// group's bins; scratch part (G, Vp / 64, I) float4, inv (G, I) float, scr
// (keep 2: (G, I, V) complex64; keep 1: (G, I, Vp) complex64) and H (keep 1:
// (G, I, 2 Vp) bf16); out as adjoint_k4's, added into. Mp, Vz multiples of
// WKC / 2, Vp of 64, Np of WKC / 2 (keep 1: of 64), V <= Vz <= Vp. Returns
// the cudaError_t of the launches.
extern "C" int adjoint_k4_wide(const float* fvals, const float* taur, const void* Wt,
                               const void* Wr, const void* S, const void* X, void* part,
                               void* inv, void* scr, void* H, void* out, long long I, int N,
                               int M, int V,
                               int G, int Mp, int Np, int Vp, int Vz, int keep, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (I <= 0 || G <= 0) return (int)cudaSuccess;
  if (N <= 0 || M <= 0 || V <= 0 || keep < 0 || keep > 2 || Mp < M || Mp % (WKC / 2)
      || Np < N || Np % (keep == KEEP_RX ? WVT : WKC / 2) || Vp % WVT || Vz % (WKC / 2)
      || Vz < V || Vz > Vp)
    return (int)cudaErrorInvalidValue;
  const WideArgs a{fvals, taur, (const __nv_bfloat16*)Wt, (const __nv_bfloat16*)Wr,
                   (const __nv_bfloat16*)S, (const __nv_bfloat16*)X, (float4*)part,
                   (float*)inv, scr, (uint32_t*)H, (float2*)out, (int64_t)I, N, M, V, G, Mp,
                   Np, Vp, Vz};
  return (int)wide_run(a, keep, (cudaStream_t)stream);
}
