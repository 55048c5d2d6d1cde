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
// Keep 'rx' with many pulses (K4(b)): conj(Ahat) of all V columns takes
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
//   into shared memory once, where they serve every column tile; when they
//   do not fit (M + N above ~780) it builds the phasors of each 16-row chunk
//   as it goes instead (GEN). The chunks of the block operands arrive by
//   cp.async through a 3-stage ring, so the copies overlap the MMAs. Warp w
//   owns the 16 rows 16 (w % 4) .. and half w / 4 of the tile's columns;
//   at the demo's V = 5 the 10 columns pad to 16 and both halves hold data.
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

#include "hopper_mma.cuh"

namespace {

constexpr int BI = 64;      // pixels per block
constexpr int NTHR = 256;   // threads per block (8 warps)
constexpr int KC = 32;      // block-operand rows per ring stage (16 complex rows)
constexpr int KC2 = KC / 2;  // complex rows per ring stage
constexpr int STAGES = 3;   // cp.async ring depth
constexpr int GLD = KC + 8; // row stride of a generated phasor chunk (bf16)
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
// memory (row stride ldw), or with GEN built per chunk into `gen_buf` from
// tau (I, L): the phasors e^{sign ...} of complex rows c KC2 .. c KC2 + KC2 - 1.
template <int NT, bool GEN>
__device__ __forceinline__ void tc_product(float (&acc)[NT][4], const __nv_bfloat16* W, int ldw,
                                           const __nv_bfloat16* __restrict__ B, int ldb, int KR,
                                           int col0, __nv_bfloat16* ring,
                                           const float* __restrict__ tau, int L, float sign,
                                           float fk, int64_t i0, int64_t I) {
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
    int lda = ldw;
    if constexpr (GEN) {
      uint32_t* g32 = reinterpret_cast<uint32_t*>(const_cast<__nv_bfloat16*>(W))
                      + (c & 1) * BI * (GLD / 2);
      const int mm = tid % KC2, m = c * KC2 + mm;
#pragma unroll
      for (int r = 0; r < BI * KC2 / NTHR; ++r) {
        const int ii = tid / KC2 + (NTHR / KC2) * r;
        uint32_t v = 0u;
        if (m < L && i0 + ii < I) {
          const float2 p = phasor<true>(fk, tau[(i0 + ii) * L + m], sign);
          v = hmma::pack_bf16(p.x, p.y);
        }
        g32[ii * (GLD / 2) + mm] = v;
      }
      Ab = W + (c & 1) * BI * GLD;
      lda = GLD;
    }
    __syncthreads();  // chunk c (and its phasors) visible; slot (c - 1) % STAGES free
    if (c + STAGES - 1 < nc) load(c + STAGES - 1);
    hmma::cp_async_commit();
    const __nv_bfloat16* Bs = ring + (c % STAGES) * KC * LDR;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[4];
      hmma::ldsm_x4(a, Ab + (16 * mt + (lane & 15)) * lda + 16 * ks + (lane >> 4) * 8);
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
  __syncthreads();  // the ring (and the generated chunks) are free again
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

template <int KEEP, int NT, bool GEN>
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
    if (GEN) {
      Wt = Wr = p;  // the generated chunks, 2 x BI x GLD
      p += 2 * BI * GLD;
    } else {
      Wt = p;
      p += BI * ldt;
      Wr = p;
      if (KEEP != KEEP_RX) p += BI * ldr;
    }
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
    size_t e = GEN ? 2 * BI * GLD : BI * (2 * a.Mp + 8) + (KEEP != KEEP_RX ? BI * (2 * a.Np + 8) : 0);
    if (KEEP == KEEP_RX) e += BI * (2 * a.Vp + 8);
    e += (size_t)STAGES * KC * (16 * NT + 8);
    return e * sizeof(__nv_bfloat16);
  }

  __device__ void bin(int k) {
    fk = a.fvals[k];
    Sk = S + (int64_t)k * (2 * a.Mp) * (2 * a.Vp);
    Xk = X + (int64_t)k * (2 * a.Np) * (2 * a.Vp);
    if (!GEN) {
      __syncthreads();  // the previous bin is done with the tiles
      fill_phasors(Wt, ldt, a.taut, a.M, a.Mp, i0, a.I, fk, -1.f);
      if (KEEP != KEEP_RX) fill_phasors(Wr, ldr, a.taur, a.N, a.Np, i0, a.I, fk, 1.f);
      __syncthreads();
    }
  }

  __device__ static void zero(Acc& x) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) x.d[j][q] = 0.f;
  }

  __device__ void prodA(Acc& x, int vt) {
    tc_product<NT, GEN>(x.d, Wt, ldt, Sk, 2 * a.Vp, 2 * a.Mp, vt * 2 * VT, ring, a.taut, a.M,
                        -1.f, fk, i0, a.I);
  }
  __device__ void prodY(Acc& x, int vt) {
    tc_product<NT, GEN>(x.d, Wr, ldr, Xk, 2 * a.Vp, 2 * a.Np, vt * 2 * VT, ring, a.taur, a.N,
                        1.f, fk, i0, a.I);
  }
  // z = conj(Ahat) X_k^T over the receivers of tile nt; H is resident
  __device__ void prodZ(Acc& x, int nt) {
    tc_product<NT, false>(x.d, H, ldh, Xk, 2 * a.Np, 2 * a.Vz, nt * 2 * VT, ring, a.taur, a.N,
                          1.f, fk, i0, a.I);
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
template <int NT, bool GEN>
struct TcChunked : TcEngine<KEEP_RX, NT, GEN> {
  using Base = TcEngine<KEEP_RX, NT, GEN>;
  using typename Base::Acc;
  static constexpr bool CH = true;

  __device__ explicit TcChunked(const Args& args) : Base(args) {
    this->ldh = 2 * args.Vh + 8;
    this->ring = this->H + BI * this->ldh;
  }

  static size_t smem_bytes(const Args& a) {
    const size_t e = (GEN ? 2 * BI * GLD : BI * (2 * a.Mp + 8)) + BI * (2 * a.Vh + 8)
                     + (size_t)STAGES * KC * (16 * NT + 8);
    return e * sizeof(__nv_bfloat16);
  }

  // z = conj(Ahat) X_k^T over the receivers of tile nt, from the chunk's
  // rows v0 .. v0 + min(Vh, Vz - v0) of X_k^T
  __device__ void prodZc(Acc& x, int nt, int v0) {
    const int vz = min(this->a.Vh, this->a.Vz - v0);
    tc_product<NT, false>(x.d, this->H, this->ldh,
                          this->Xk + (int64_t)(2 * v0) * (2 * this->a.Np), 2 * this->a.Np,
                          2 * vz, nt * 2 * Base::VT, this->ring, this->a.taur, this->a.N, 1.f,
                          this->fk, this->i0, this->a.I);
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

// bf16 tiles of VT = 8 NT complex columns. The phasor tiles of a bin stay
// resident in shared memory where they fit; otherwise each chunk's phasors
// are built as the product reaches it (GEN).
template <int KEEP, int NT>
cudaError_t launch_nt(const Args& a, cudaStream_t s) {
  if constexpr (KEEP == KEEP_RX && NT == 8) {
    if (a.Vh > 0) {  // K4(b): conj(Ahat) by chunks
      if (TcChunked<NT, false>::smem_bytes(a) <= SMEM_LIMIT)
        return launch<KEEP, TcChunked<NT, false>>(a, s);
      return launch<KEEP, TcChunked<NT, true>>(a, s);
    }
  }
  if (TcEngine<KEEP, NT, false>::smem_bytes(a) <= SMEM_LIMIT)
    return launch<KEEP, TcEngine<KEEP, NT, false>>(a, s);
  return launch<KEEP, TcEngine<KEEP, NT, true>>(a, s);
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
