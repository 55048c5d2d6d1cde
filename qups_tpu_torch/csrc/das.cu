// K1 and K2: delay-and-sum, float32 traces, real or complex (interleaved
// complex64, such as the analytic traces greens returns), with frames and
// IQ remodulation (sub-slices K1(b), K2(b)), keep modes and apodization
// weights (K1(c), K1(d), K2(c)). Three kernel bodies serve both:
// das_kernel (summed, one frame, no remodulation), das_frames_kernel and
// das_keep_kernel below; a compile-time switch (SRC) says where a term's
// transmit and receive parts come from.
//
// K1 (SRC = PLANE, DIVERGING or VIRTUAL) replaces the TPU kernel
// qups_tpu/ops/das_pallas.py::_kernel in geometry mode (launched by
// _das_call, public entry das_tiled) and computes what
// qups_tpu_torch/ops/das.py::das computes for that case:
//
//   dv  = rv.nv (plane) | |rv| (diverging) | copysign(|rv|, rv.nv) (virtual),
//         rv = p_i - pv_m
//   dr  = |p_i - pr_n|
//   tau = cinv * (dv + dr) - t0_m,   ti = tau * fs
//
// K2 (SRC = LUT) replaces the same TPU kernel with lut=True (launched by
// _das_lut_call, public entry das_lut_tiled) and computes what
// ops/das.py::das_lut computes: tau = (tau_tx[i, m] + tau_rx[i, n]) - t0_m,
// ti = tau * fs.
// Both then sum
//
//   out_if = sum_{m,n} exp(2 pi i fmod tau) sample(x[m, n, :, f], ti)
//            for 0 <= ti <= T-1, else 0
//
// with the samplers of ops/interp.py: nearest (round half to even), linear,
// cubic (Catmull-Rom) and lanczos3, taps clamp-replicated to [0, T-1].
// Complex traces take the same delays and weights; the real and imaginary
// parts are summed in two float32 accumulators. With frames (any trailing
// dims of the traces, folded to one axis F) each frame f has its own sum
// out_if over the same terms. With remodulation (fmod != 0, IQ data) each
// sample is first rotated by exp(2 pi i fmod tau), tau = ti / fs the delay
// in seconds; real traces then give a complex sum.
//
// What bounds them on the card, as far as the measurements show: the
// instructions issued per term (the time followed them through the
// design's steps, PERF.md §5-6). At the headline size (1024^2 pixels x 256
// tx x 256 rx) there are 6.9e10 pixel*tx*rx terms; each takes its delay
// (3-4 flops), a validity test, the tap base and fraction, the address of
// its entry, one data-dependent read and, for cubic, 3 FMAs; the order of
// the pixels, and with it the span of trace a block reads, does not move
// the time (tools/sweep_das_torch.py tiles).
//
// What the design does about that:
// - A receive table in shared memory, R[p][n] for the block's P pixels (one
//   per thread) and a chunk of NC receivers: K1 computes dr there once per
//   (pixel, receiver) rather than once per term; K2 copies its tau_rx tile
//   there with coalesced reads of the (I, N) table. A thread reads four
//   receivers' entries with one 16-byte load. Then the transmits run
//   outermost and the chunk's receivers innermost, so the traces in use
//   across the card are one transmit's NC traces at a time.
// - The transmit terms of MC transmits are formed at once (K2: its tau_tx
//   loads in flight together) into each thread's column of shared memory.
// - Edge-replicated trace layouts, written by the layout kernel below: a
//   tap base in [0, T-1] needs no clamp and one load. Nearest reads the
//   traces transposed to (M, N, T), its base being a sample. The others read
//   one stencil entry per tap base k, 8 or 16 bytes (twice that for
//   complex: the real part's entry, then the imaginary part's): linear
//   (x[k], x[k+1] - x[k]), one FMA from the sample; cubic the coefficients
//   of the Catmull-Rom cubic in the fraction u, three FMAs (the float32
//   analogue of the TPU kernel's packed 4-tap words, _pack_quads, with the
//   taps already combined); lanczos3 the four taps x[k-1..k+2], whose
//   weights come from two short polynomials and one reciprocal
//   (lanczos_w). Rows padded with the replicated edges, one load per tap,
//   were slower for every sampler (PERF.md).
// - The layout of a stencil holds 2 to 4 times the traces' bytes (4 GiB
//   for the headline's cubic), so the wrapper lays out and sums the
//   transmits by chunks whose layout fits a fixed budget
//   (ops/das_cuda.py::LAYOUT_BYTES); a launch after the first adds its sum
//   to what out holds. One chunk covers the main paths' sizes.
// - Frames and remodulation (K1(b), K2(b)) run in das_frames_kernel, the
//   same loops with FB frames' sums per thread in registers (one launch per
//   block of FB frames; one frame with fmod a variant of its own): a term's
//   delay, validity, tap base, fraction and rotation are formed once for
//   all its frames. The layout keeps a term's frames innermost, (M, N, T,
//   F, entry), so a term's FB entries share cache lines at constant
//   offsets. One frame without fmod runs das_kernel, unchanged, with the
//   arguments it always took: with the frames' fields among them, its
//   variants gained registers (K2's real linear sampler 62 -> 72, 3 blocks
//   per SM) and ran up to 1.24x slower (PERF.md §6).
// - Remodulation is one sincosf per term, then a complex product per frame.
//   Its instantiations live in a second translation unit, das_iq.cu (this
//   file built with DAS_IQ defined), so the two build in parallel; without
//   fmod the kernels hold no rotation at all.
// - Few instructions per term: the tap base and fraction come from one add
//   of 2^23 rounded down (nearest: to nearest), with no conversion, and the
//   entry's address from one shift-add on a 32-bit offset in the chunk and
//   one wide multiply-add; the entry is read at base 0 for an invalid term,
//   whose value a predicated add then drops, so the loads of several
//   unrolled terms are in flight together.
//
// Numerics: the delays must round exactly as the plain PyTorch version
// does, or the nearest sampler and the validity edges take another sample.
// So every operation of the delay path (dv, dr, ti) is written with the
// round-to-nearest intrinsics __fadd_rn / __fsub_rn / __fmul_rn, which nvcc
// never contracts into an FMA (eager PyTorch never contracts), in the plain
// version's order; the square roots are taken in double precision and
// rounded to float, which gives the correctly rounded float square root
// (53 >= 2 * 24 + 2) without the FFMA steps of the float sqrt sequence.
// The file is built without -fmad=false: the interpolation contracts to
// FMAs and differs from the plain version by float32 roundings. The nearest
// variants contain no FFMA at all (chip_smoke.py checks the SASS). The
// phase of the rotation rounds as the plain version's does too: w =
// float32(2 pi fmod) from the host, __fmul_rn(w, tau) with the kernel's own
// float32 tau, then sincosf (the accurate one: at IQ sizes the phase
// reaches thousands of radians, where __sincosf's error grows, and another
// rounding of the phase moves a term by ~1e-4 rad). Each thread sums in
// registers and writes its pixel once: no atomics, so two launches give
// the same bits.
//
// PERF.md §5 compares the tile sizes below and the launch bound with the
// alternatives measured.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Src { PLANE = 0, DIVERGING = 1, VIRTUAL = 2, LUT = 3 };
enum Method { NEAREST = 0, LINEAR = 1, CUBIC = 2, LANCZOS3 = 3 };

constexpr int P = 256;        // pixels per block, one per thread
constexpr int NC = 32;        // receivers per chunk of the receive table
constexpr int MC = 8;         // transmits per chunk of transmit terms
constexpr int UNROLL = 2;     // groups of 4 receivers per unrolled step
constexpr int RS = NC + 4;    // row stride of R: 16-byte rows, conflict-free 16-byte reads
constexpr int TMAX = 1 << 22;  // longest trace: the index arithmetic of sample()
constexpr int FB = 4;         // frames per launch, their sums in registers
static_assert(NC % 4 == 0, "R is read four receivers at a time");
static_assert((int64_t)NC * 8 * TMAX < (int64_t)1 << 31, "a chunk's offsets fit an int");

struct Args {
  const float* x;                 // traces in the layout, (M, N, row floats)
  const float *pix, *pr, *pv, *nv;  // K1: (I, 3), (N, 3), (M, 3), (M, 3)
  const float *taur, *taut;       // K2: (I, N), (I, ldt) [s]
  const float* t0;                // (M,)
  void* out;                      // (I,) float or complex64
  int64_t I, row, ldt;            // pixels; floats per trace in the layout; taut's row
  int N, M, T;
  float cinv, fs;
  int add;                        // 1: add the sum to what out holds
};

// das_frames_kernel's arguments: Args (x and out at the launch's first
// frame, out (I, ldo)) and the frames and remodulation. das_kernel takes
// Args alone: a larger argument block cost its variants registers (K2's
// real linear sampler 62 -> 72, PERF.md §6).
struct FrameArgs {
  Args a;
  int64_t ldo;                    // sums per pixel in out: F
  int S, fb;                      // floats per tap base (F entries); frames here
  float w;                        // 2 pi fmod, rounded to float32
};

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// Correctly rounded float sqrt through double (see Numerics above).
__device__ __forceinline__ float sqrt_rn(float s) {
  return __double2float_rn(__dsqrt_rn((double)s));
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
}

__device__ __forceinline__ float dot3(float x, float y, float z, const float* __restrict__ b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, __ldg(b)), __fmul_rn(y, __ldg(b + 1))),
                   __fmul_rn(z, __ldg(b + 2)));
}

// p, with its value hidden from the compiler: the address of a term's
// entry is then one wide multiply-add on p, where nvcc otherwise folds p's
// own 64-bit arithmetic into every term's address.
__device__ __forceinline__ const float* opaque(const float* p) {
  asm("" : "+l"(p));
  return p;
}

// The cubic c0 + u (c1 + u (c2 + u c3)) of a stencil entry q = (c0..c3).
__device__ __forceinline__ float poly3(float u, float4 q) {
  return fmaf(u, fmaf(u, fmaf(u, q.w, q.z), q.y), q.x);
}

// sin(pi v / 2) for v in [0, 1], to ~1e-7 relative (Taylor to degree 11).
__device__ __forceinline__ float sin_half_pi(float v) {
  const float t = 1.5707963267948966f * v, t2 = t * t;
  return t * (1.f + t2 * (-1.f / 6 + t2 * (1.f / 120 + t2 * (-1.f / 5040
         + t2 * (1.f / 362880 + t2 * (-1.f / 39916800))))));
}

// ops/interp.py::_lanczos_w at u + 1, u, u - 1, u - 2, 0 <= u < 1, where
// w(v) = 2 sin(pi v) sin(pi v / 2) / (pi v)^2 and w(0) = 1. With
// sh = sin(pi u / 2), ch = cos(pi u / 2) = sin(pi (1 - u) / 2) (each
// accurate where it is small) and sin(pi u) = 2 sh ch, the four are
// -a ch / (u+1)^2, a sh / u^2, a ch / (u-1)^2, -a sh / (u-2)^2 with
// a = 2 sin(pi u) / pi^2; one reciprocal of the product of the four
// squares gives all four divisions. Below u = 2^-20 the weights are
// (0, 1, 0, 0), each within 1e-6 of the exact ones.
__device__ __forceinline__ float4 lanczos_w(float u) {
  if (u < 0x1p-20f) return make_float4(0.f, 1.f, 0.f, 0.f);
  const float sh = sin_half_pi(u), ch = sin_half_pi(1.f - u);
  const float a = 0.40528473456935109f * sh * ch;  // 4 / pi^2 sh ch
  const float q0 = (u + 1.f) * (u + 1.f), q1 = u * u, q2 = (u - 1.f) * (u - 1.f),
              q3 = (u - 2.f) * (u - 2.f);
  const float p01 = q0 * q1, p23 = q2 * q3, r = __fdividef(1.f, p01 * p23);
  return make_float4(-a * ch * (r * q1 * p23), a * sh * (r * q0 * p23),
                     a * ch * (r * p01 * q3), -a * sh * (r * p01 * q2));
}

__device__ __forceinline__ float dot4(float4 w, float4 v) {
  return w.x * v.x + w.y * v.y + w.z * v.z + w.w * v.w;
}

// Where a sampler finds tap base k in its trace's row: at float k S, S the
// floats of a term's entries (F of them with F frames; nearest: one sample
// each, the others one stencil entry each); E the floats of one entry.
template <int METHOD, typename V>
struct Entry {
  static constexpr int C = sizeof(V) / sizeof(float);  // 1 real, 2 complex
  static constexpr int E = (METHOD == NEAREST ? 1 : METHOD == LINEAR ? 2 : 4) * C;
};

// Floats of one entry of one frame, E.
int entry_floats(int method, int cplx) {
  return (cplx ? 2 : 1) * (method == NEAREST ? 1 : method == LINEAR ? 2 : 4);
}

// The offset o that sample() takes for the trace at float `start` of xm:
// start - (bits of 2^23) S, wrapping.
template <int METHOD, typename V>
__device__ __forceinline__ unsigned row_origin(unsigned start,
                                               unsigned S = Entry<METHOD, V>::E) {
  return start - 0x4B000000u * S;
}

// The sample at ti, 0 <= ti <= T-1 (any ti in that range: the caller
// passes 0 for an invalid term and drops its value), of the trace whose
// row starts at float o of xm, its tap bases S floats apart. 2^23 + ti,
// rounded, holds the tap base in
// its low mantissa bits: rounded to nearest (half to even, as torch.round)
// for nearest, down (floor) for the others; subtracting 2^23 again is
// exact, and so is the fraction u. The bits of 2^23 are subtracted from
// the entry's offset in unsigned (wrapping) arithmetic as part of o (see
// row_origin), so the offset costs one shift-add.
template <int METHOD, typename V>
__device__ __forceinline__ V sample(const float* __restrict__ xm, unsigned o, float ti,
                                    unsigned S = Entry<METHOD, V>::E) {
  using L = Entry<METHOD, V>;
  constexpr bool CPLX = L::C == 2;
  const float r = METHOD == NEAREST ? __fadd_rn(ti, 0x1p23f) : __fadd_rd(ti, 0x1p23f);
  const float* __restrict__ e = xm + (o + (unsigned)__float_as_int(r) * S);
  if constexpr (METHOD == NEAREST) {
    return __ldg(reinterpret_cast<const V*>(e));
  } else {
    const float u = __fsub_rn(ti, __fsub_rn(r, 0x1p23f));
    float c0, c1;
    if constexpr (METHOD == LINEAR) {
      // (x[k], x[k+1] - x[k]), complex: then the same of the imaginary part
      if constexpr (CPLX) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(e));
        c0 = fmaf(u, q.y, q.x);
        c1 = fmaf(u, q.w, q.z);
      } else {
        const float2 q = __ldg(reinterpret_cast<const float2*>(e));
        c0 = fmaf(u, q.y, q.x);
      }
    } else if constexpr (METHOD == CUBIC) {
      // the Catmull-Rom cubic's coefficients; complex: real, then imaginary
      c0 = poly3(u, __ldg(reinterpret_cast<const float4*>(e)));
      if constexpr (CPLX) c1 = poly3(u, __ldg(reinterpret_cast<const float4*>(e) + 1));
    } else {
      // the four taps x[k-1..k+2]; complex: real taps, then imaginary
      const float4 w = lanczos_w(u);
      c0 = dot4(w, __ldg(reinterpret_cast<const float4*>(e)));
      if constexpr (CPLX) c1 = dot4(w, __ldg(reinterpret_cast<const float4*>(e) + 1));
    }
    if constexpr (CPLX) {
      return make_float2(c0, c1);
    } else {
      return c0;
    }
  }
}

// A sample rotated by (c, s) = (cos, sin) of its phase, as the plain
// version's complex product (v + 0i or v) * (c + is); unrotated without ROT.
template <bool ROT, typename V>
__device__ __forceinline__ auto rotate(V v, float c, float s) {
  if constexpr (!ROT) {
    return v;
  } else if constexpr (sizeof(V) == sizeof(float)) {
    return make_float2(v * c, v * s);
  } else {
    return make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
  }
}

// The transmit term of transmit m for pixel i (at px, py, pz): K1 its
// distance dv as ops/das.py::tx_distance rounds it, K2 tau_tx[i, m].
template <int SRC>
__device__ __forceinline__ float tx_term(const Args& a, int m, int64_t i, float px,
                                         float py, float pz) {
  if constexpr (SRC == LUT) {
    return __ldg(a.taut + i * a.ldt + m);
  } else {
    const float* pvm = a.pv + 3 * m;
    const float rx = __fsub_rn(px, __ldg(pvm)), ry = __fsub_rn(py, __ldg(pvm + 1)),
                rz = __fsub_rn(pz, __ldg(pvm + 2));
    if constexpr (SRC == PLANE) return dot3(rx, ry, rz, a.nv + 3 * m);
    if constexpr (SRC == DIVERGING) return norm3(rx, ry, rz);
    return copysignf(norm3(rx, ry, rz), dot3(rx, ry, rz, a.nv + 3 * m));
  }
}

// __launch_bounds__(P, 1): with no minimum of blocks per SM given, ptxas
// held the variants to 48 registers (5 blocks per SM) and spilled, and K2
// linear took 124 ms at the headline against 67 ms with the registers it
// needs (PERF.md §5). This kernel: one frame, no remodulation (K1(a),
// K2(a)).
template <int SRC, int METHOD, typename V>
__global__ void __launch_bounds__(P, 1) das_kernel(const Args a) {
  __shared__ __align__(16) float R[P * RS];  // R[p][n]
  __shared__ float TX[MC * P];  // TX[j][p], each thread's own column: no barrier
  const float* __restrict__ x = a.x;
  const int p = threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.x * P;
  const int64_t i = i0 + p;
  const bool live = i < a.I;
  float px = 0.f, py = 0.f, pz = 0.f;
  if constexpr (SRC != LUT) {
    const int64_t ic = live ? i : a.I - 1;  // the last pixel stands in for a dead thread
    px = a.pix[3 * ic];
    py = a.pix[3 * ic + 1];
    pz = a.pix[3 * ic + 2];
  }
  const float tmax = (float)(a.T - 1);
  const unsigned row = (unsigned)a.row;  // a chunk's NC traces span < 2^31 floats (TMAX)
  const float4* __restrict__ r4 = reinterpret_cast<const float4*>(R + p * RS);
  V acc{};
  if (a.add && live) acc = static_cast<const V*>(a.out)[i];
  for (int n0 = 0; n0 < a.N; n0 += NC) {
    const int nc = min(NC, a.N - n0);
    __syncthreads();  // the previous chunk's reads of R are done
    if constexpr (SRC == LUT) {
      // warp w copies rows w, w + 8, ... of the (P, nc) tile of tau_rx, one
      // receiver per lane: coalesced reads, conflict-free writes
      const int lane = p & 31, rows = a.I - i0 < P ? (int)(a.I - i0) : P;
      for (int q = p >> 5; q < rows; q += P / 32)
        for (int n = lane; n < nc; n += 32)
          R[q * RS + n] = __ldg(a.taur + (i0 + q) * a.N + n0 + n);
    } else {
      // dr as ops/das.py::rx_distance rounds it: pixel minus receiver
      for (int n = 0; n < nc; ++n) {
        const float* prn = a.pr + 3 * (n0 + n);
        R[p * RS + n] = norm3(__fsub_rn(px, __ldg(prn)), __fsub_rn(py, __ldg(prn + 1)),
                              __fsub_rn(pz, __ldg(prn + 2)));
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int m0 = 0; m0 < a.M; m0 += MC) {
      // the terms of MC transmits at once: K2's loads are then in flight
      // together, not one per transmit ahead of its receivers
      const int mc = min(MC, a.M - m0);
#pragma unroll
      for (int j = 0; j < MC; ++j)
        if (j < mc) TX[j * P + p] = tx_term<SRC>(a, m0 + j, i, px, py, pz);
      for (int j = 0; j < mc; ++j) {
        const float tx = TX[j * P + p], t0m = __ldg(a.t0 + m0 + j);
        const float* __restrict__ xm = opaque(x + ((int64_t)(m0 + j) * a.N + n0) * a.row);
        // one term: the receiver whose trace starts at float o of xm (as
        // row_origin gives it), r its entry of R
        auto term = [&](float r, unsigned o) {
          const float ti = SRC == LUT
              ? __fmul_rn(__fsub_rn(__fadd_rn(tx, r), t0m), a.fs)
              : __fmul_rn(__fsub_rn(__fmul_rn(a.cinv, __fadd_rn(tx, r)), t0m), a.fs);
          const bool ok = ti >= 0.f && ti <= tmax;  // false for NaN
          const V v = sample<METHOD, V>(xm, o, ok ? ti : 0.f);
          if (ok) acc = acc + v;
        };
        unsigned o = row_origin<METHOD, V>(0u);
        int n = 0;
#pragma unroll UNROLL
        for (; n + 4 <= nc; n += 4, o += 4 * row) {
          const float4 r = r4[n >> 2];
          term(r.x, o);
          term(r.y, o + row);
          term(r.z, o + 2 * row);
          term(r.w, o + 3 * row);
        }
        for (; n < nc; ++n, o += row) term(R[p * RS + n], o);
      }
    }
  }
  if (live) static_cast<V*>(a.out)[i] = acc;
}

// K1(b), K2(b): das_kernel's loops with NF frames' sums per thread (1 with
// fmod and one frame, else FB), each term's samples rotated by exp(2 pi i
// fmod tau) when ROT. A (float2 with ROT or complex traces, else float) is
// the sums' type.
template <int SRC, int METHOD, typename V, bool ROT, int NF>
__global__ void __launch_bounds__(P, 1) das_frames_kernel(const FrameArgs fa) {
  using A = decltype(rotate<ROT, V>(V{}, 1.f, 0.f));
  const Args& a = fa.a;
  constexpr int E = Entry<METHOD, V>::E;
  __shared__ __align__(16) float R[P * RS];  // R[p][n]
  __shared__ float TX[MC * P];  // TX[j][p], each thread's own column: no barrier
  const float* __restrict__ x = a.x;
  const int p = threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.x * P;
  const int64_t i = i0 + p;
  const bool live = i < a.I;
  float px = 0.f, py = 0.f, pz = 0.f;
  if constexpr (SRC != LUT) {
    const int64_t ic = live ? i : a.I - 1;  // the last pixel stands in for a dead thread
    px = a.pix[3 * ic];
    py = a.pix[3 * ic + 1];
    pz = a.pix[3 * ic + 2];
  }
  const float tmax = (float)(a.T - 1);
  const unsigned row = (unsigned)a.row;  // a chunk's NC traces span < 2^31 floats
  // floats between tap bases: one entry, or a term's F entries
  const unsigned S = NF == 1 ? (unsigned)E : (unsigned)fa.S;
  const int fb = NF == 1 ? 1 : fa.fb;
  const float4* __restrict__ r4 = reinterpret_cast<const float4*>(R + p * RS);
  const int64_t io = i * fa.ldo;  // pixel i's first sum in out
  A acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j] = A{};
  if (a.add && live) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
      if (j < fb) acc[j] = static_cast<const A*>(a.out)[io + j];
  }
  for (int n0 = 0; n0 < a.N; n0 += NC) {
    const int nc = min(NC, a.N - n0);
    __syncthreads();  // the previous chunk's reads of R are done
    if constexpr (SRC == LUT) {
      // warp w copies rows w, w + 8, ... of the (P, nc) tile of tau_rx, one
      // receiver per lane: coalesced reads, conflict-free writes
      const int lane = p & 31, rows = a.I - i0 < P ? (int)(a.I - i0) : P;
      for (int q = p >> 5; q < rows; q += P / 32)
        for (int n = lane; n < nc; n += 32)
          R[q * RS + n] = __ldg(a.taur + (i0 + q) * a.N + n0 + n);
    } else {
      // dr as ops/das.py::rx_distance rounds it: pixel minus receiver
      for (int n = 0; n < nc; ++n) {
        const float* prn = a.pr + 3 * (n0 + n);
        R[p * RS + n] = norm3(__fsub_rn(px, __ldg(prn)), __fsub_rn(py, __ldg(prn + 1)),
                              __fsub_rn(pz, __ldg(prn + 2)));
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int m0 = 0; m0 < a.M; m0 += MC) {
      // the terms of MC transmits at once: K2's loads are then in flight
      // together, not one per transmit ahead of its receivers
      const int mc = min(MC, a.M - m0);
#pragma unroll
      for (int j = 0; j < MC; ++j)
        if (j < mc) TX[j * P + p] = tx_term<SRC>(a, m0 + j, i, px, py, pz);
      for (int j = 0; j < mc; ++j) {
        const float tx = TX[j * P + p], t0m = __ldg(a.t0 + m0 + j);
        const float* __restrict__ xm = opaque(x + ((int64_t)(m0 + j) * a.N + n0) * a.row);
        // one term: the receiver whose trace starts at float o of xm (as
        // row_origin gives it), r its entry of R
        auto term = [&](float r, unsigned o) {
          const float tau = SRC == LUT
              ? __fsub_rn(__fadd_rn(tx, r), t0m)
              : __fsub_rn(__fmul_rn(a.cinv, __fadd_rn(tx, r)), t0m);
          const float ti = __fmul_rn(tau, a.fs);
          const bool ok = ti >= 0.f && ti <= tmax;  // false for NaN
          float sn = 0.f, cs = 1.f;
          if constexpr (ROT) sincosf(ok ? __fmul_rn(fa.w, tau) : 0.f, &sn, &cs);
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            // frame f's entries lie f E floats on. Frame 0 always runs (fb
            // >= 1), so the later frames' tap base, fraction, weights and
            // address come from its sample as common subexpressions.
            if (f == 0 || f < fb) {
              const A v = rotate<ROT>(sample<METHOD, V>(xm + f * E, o, ok ? ti : 0.f, S),
                                      cs, sn);
              if (ok) acc[f] = acc[f] + v;
            }
          }
        };
        unsigned o = row_origin<METHOD, V>(0u, S);
        int n = 0;
#pragma unroll UNROLL
        for (; n + 4 <= nc; n += 4, o += 4 * row) {
          const float4 r = r4[n >> 2];
          term(r.x, o);
          term(r.y, o + row);
          term(r.z, o + 2 * row);
          term(r.w, o + 3 * row);
        }
        for (; n < nc; ++n, o += row) term(R[p * RS + n], o);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
      if (j < fb) static_cast<A*>(a.out)[io + j] = acc[j];
  }
}

#ifdef DAS_KEEP
// K1(c), K1(d), K2(c): das_frames_kernel's loops with a keep mode and
// apodization weights, both runtime flags uniform across a launch, so that
// they add no variants (this file built with DAS_KEEP defined: das_keep.cu
// and, with rotation, das_keep_iq.cu, 64 variants each, source x sampler x
// trace type x 1 or FB frames' sums).
//
// Keep modes (the TPU kernel's, das_pallas.py:940-1060): summed (I, 1, 1,
// F); KEEP_RX (I, N, 1, F): a (pixel, receiver) sum is complete once a
// receiver chunk's transmits are done, so it lives in shared memory beside
// R (NC sums a pixel and frame, one column per thread: no barrier, no
// conflicts) and is written once per (pixel, receiver, frame) and launch;
// KEEP_TX (I, 1, M, F): a (pixel, transmit) sum is complete at the end of
// each receiver chunk, added to out once per chunk by the one thread that
// owns it (no atomics: two launches give the same bits); KEEP_BOTH (I, N,
// M, F): one store per term. out is (N', M', F, I), pixels innermost, so a
// warp's stores are coalesced; the wrapper permutes the view.
//
// Weights (das_pallas.py:102-155, on unscaled geometry; the TPU kernel
// folds cinv into its positions and scales Dmax, xlo, xhi and lat_tx with
// it): a receive factor, evaluated once per (pixel, receiver) beside R into
// WR, and a transmit factor, once per (pixel, transmit) beside TX into WT,
// each the product of the fused kinds the launch names and a dense weight
// that varies over (pixel, receiver) or (pixel, transmit) only; a dense
// weight that varies over both is read per term with its strides (0 on a
// broadcast axis). A term whose weight is 0 reads no sample.
enum Keep { SUM = 0, KEEP_RX = 1, KEEP_TX = 2, KEEP_BOTH = 3 };
enum RxKind { AP_GROWTH = 1, AP_DMAX = 2, ACCEPT = 4 };
enum TxKind { TX_SCANLINE = 1, TX_MULTILINE = 2, TX_PARALLELOGRAM = 4 };
constexpr int KR_BYTES = 64 << 10;  // the keep_rx sums' shared memory, at most

// A dense weight broadcastable to (I1, I2, I3, N, M): its element strides,
// 0 on a broadcast axis; p null when the launch has none.
struct Dense {
  const float* p;
  int64_t s1, s2, s3, sn, sm;
};

struct KeepArgs {
  FrameArgs fa;        // a.out at the launch's first frame and transmit
  int keep;            // Keep
  int64_t on, om, of;  // out's strides of n, m and f (i's is 1), in sums
  int I2, I3;          // the image's trailing dims: a pixel's (i1, i2, i3)
  Dense wr, wt, wd;    // dense weights over (i, n), (i, m), (i, n, m)
  int rx_kinds, tx_kinds;  // RxKind, TxKind bits: the fused kinds
  const float* ori;    // (N, 2): sin, cos of each receiver's azimuth
  const float* lat;    // (I,): each pixel's lateral coordinate
  const float* lat_tx; // (M,): each transmit's
  float f2, dmax, cth, tol, dlat, xlo, xhi;  // 2 f, Dmax, cos(theta), ...
};

// The fused receive factor of receiver n for a pixel at (dx, dz) from it,
// dr = |pixel - receiver|, in the order and roundings of
// ops/das_cuda.py::fused_weights.
__device__ __forceinline__ float rx_weight(const KeepArgs& k, int n, float dx, float dz,
                                           float dr) {
  const float sa = __ldg(k.ori + 2 * n), ca = __ldg(k.ori + 2 * n + 1);
  float w = 1.f;
  if (k.rx_kinds & AP_GROWTH) {
    const float d = __fsub_rn(__fmul_rn(dx, ca), __fmul_rn(dz, sa));
    const float z = __fadd_rn(__fmul_rn(dz, ca), __fmul_rn(dx, sa));
    if (!(fabsf(z) > __fmul_rn(k.f2, fabsf(d)))) w = 0.f;
    if ((k.rx_kinds & AP_DMAX) && !(__fmul_rn(2.f, fabsf(d)) < k.dmax)) w = 0.f;
  }
  if ((k.rx_kinds & ACCEPT)
      && !(__fadd_rn(__fmul_rn(dx, sa), __fmul_rn(dz, ca)) >= __fmul_rn(k.cth, dr)))
    w = 0.f;
  return w;
}

// The fused transmit factor of transmit m (of the launch) for a pixel at
// (px, pz) with lateral coordinate lat.
__device__ __forceinline__ float tx_weight(const KeepArgs& k, int m, float px, float pz,
                                           float lat) {
  float w = 1.f;
  if (k.tx_kinds & (TX_SCANLINE | TX_MULTILINE)) {
    const float dl = fabsf(__fsub_rn(lat, __ldg(k.lat_tx + m)));
    if ((k.tx_kinds & TX_SCANLINE) && !(dl < k.tol)) w = 0.f;
    if (k.tx_kinds & TX_MULTILINE)
      w = __fmul_rn(w, fmaxf(0.f, __fsub_rn(1.f, __fdiv_rn(dl, k.dlat))));
  }
  if (k.tx_kinds & TX_PARALLELOGRAM) {
    const float* nvm = k.fa.a.nv + 3 * m;
    const float x0 = __fsub_rn(px, __fmul_rn(__ldg(nvm), __fdiv_rn(pz, __ldg(nvm + 2))));
    if (!(x0 > k.xlo && x0 <= k.xhi)) w = 0.f;
  }
  return w;
}

template <typename A>
__device__ __forceinline__ A scaled(A v, float w) {
  if constexpr (sizeof(A) == sizeof(float)) {
    return v * w;
  } else {
    return make_float2(v.x * w, v.y * w);
  }
}

// Shared memory: R and TX as das_frames_kernel's, WR (P x RS) and WT (MC x
// P) when the launch has receive or transmit factors, KR (NC x fb x P sums)
// for KEEP_RX; sized by the launcher (keep_smem). NF frames' sums a thread:
// 1 (a launch of one frame) or FB.
//
// The receivers of a chunk run 4 at a time, in three steps: the 4 terms'
// delays, weights and phases; their samples, whose loads are then in
// flight together (no branch between them when NF is 1); then their sums
// by the keep mode, one uniform branch for the 4. With the keep mode's
// branch after each term instead, a term's load waited for the last
// term's sum, and the kernel took 6-8x das_kernel's time (PERF.md §6).
template <int SRC, int METHOD, typename V, bool ROT, int NF>
__global__ void __launch_bounds__(P, 1) das_keep_kernel(const KeepArgs k) {
  using A = decltype(rotate<ROT, V>(V{}, 1.f, 0.f));
  const FrameArgs& fa = k.fa;
  const Args& a = fa.a;
  constexpr int E = Entry<METHOD, V>::E;
  extern __shared__ __align__(16) float smem[];
  const bool has_wr = k.rx_kinds || k.wr.p, has_wt = k.tx_kinds || k.wt.p;
  const bool weighted = has_wr || has_wt || k.wd.p;
  float* R = smem;                                   // R[p][n]
  float* TX = R + P * RS;                            // TX[j][p]
  float* WR = TX + MC * P;                           // WR[p][n]
  float* WT = WR + (has_wr ? P * RS : 0);            // WT[j][p]
  A* KR = reinterpret_cast<A*>(WT + (has_wt ? MC * P : 0));  // KR[f][n][p]
  const float* __restrict__ x = a.x;
  A* __restrict__ out = static_cast<A*>(a.out);
  const int p = threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.x * P;
  const int64_t i = i0 + p;
  const bool live = i < a.I;
  const int64_t ic = live ? i : a.I - 1;  // the last pixel stands in for a dead thread
  float px = 0.f, py = 0.f, pz = 0.f;
  if constexpr (SRC != LUT) {
    px = a.pix[3 * ic];
    py = a.pix[3 * ic + 1];
    pz = a.pix[3 * ic + 2];
  }
  // the pixel's (i1, i2, i3) and its offset in each dense weight
  const int64_t i3 = ic % k.I3, i2 = (ic / k.I3) % k.I2, i1 = ic / ((int64_t)k.I3 * k.I2);
  const int64_t owr = i1 * k.wr.s1 + i2 * k.wr.s2 + i3 * k.wr.s3;
  const int64_t owt = i1 * k.wt.s1 + i2 * k.wt.s2 + i3 * k.wt.s3;
  const int64_t owd = i1 * k.wd.s1 + i2 * k.wd.s2 + i3 * k.wd.s3;
  const float lat = (k.tx_kinds & (TX_SCANLINE | TX_MULTILINE)) ? __ldg(k.lat + ic) : 0.f;
  const float tmax = (float)(a.T - 1);
  const unsigned row = (unsigned)a.row;
  const unsigned S = (unsigned)fa.S;
  const int fb = NF == 1 ? 1 : fa.fb, keep = k.keep;
  const float4* __restrict__ r4 = reinterpret_cast<const float4*>(R + p * RS);
  const float4* __restrict__ w4 = reinterpret_cast<const float4*>(WR + p * RS);
  A acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j] = A{};
  if (keep == SUM && a.add && live) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
      if (j < fb) acc[j] = out[i + j * k.of];
  }
  for (int n0 = 0; n0 < a.N; n0 += NC) {
    const int nc = min(NC, a.N - n0);
    __syncthreads();  // the previous chunk's reads of R are done
    if constexpr (SRC == LUT) {
      const int lane = p & 31, rows = a.I - i0 < P ? (int)(a.I - i0) : P;
      for (int q = p >> 5; q < rows; q += P / 32)
        for (int n = lane; n < nc; n += 32)
          R[q * RS + n] = __ldg(a.taur + (i0 + q) * a.N + n0 + n);
    } else {
      for (int n = 0; n < nc; ++n) {
        const float* prn = a.pr + 3 * (n0 + n);
        R[p * RS + n] = norm3(__fsub_rn(px, __ldg(prn)), __fsub_rn(py, __ldg(prn + 1)),
                              __fsub_rn(pz, __ldg(prn + 2)));
      }
    }
    if (has_wr) {  // the receive factors of this thread's pixel: its own row
      for (int n = 0; n < nc; ++n) {
        float w = 1.f;
        if constexpr (SRC != LUT) {
          if (k.rx_kinds) {
            const float* prn = a.pr + 3 * (n0 + n);
            w = rx_weight(k, n0 + n, __fsub_rn(px, __ldg(prn)), __fsub_rn(pz, __ldg(prn + 2)),
                          R[p * RS + n]);
          }
        }
        if (k.wr.p) w *= __ldg(k.wr.p + owr + (int64_t)(n0 + n) * k.wr.sn);
        WR[p * RS + n] = w;
      }
    }
    __syncthreads();
    if (!live) continue;
    if (keep == KEEP_RX) {  // this chunk's (pixel, receiver) sums
      for (int f = 0; f < fb; ++f)
        for (int n = 0; n < nc; ++n)
          KR[(f * NC + n) * P + p] = a.add ? out[i + (n0 + n) * k.on + f * k.of] : A{};
    }
    for (int m0 = 0; m0 < a.M; m0 += MC) {
      const int mc = min(MC, a.M - m0);
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        if (j < mc) {
          TX[j * P + p] = tx_term<SRC>(a, m0 + j, i, px, py, pz);
          if (has_wt) {
            float w = 1.f;
            if constexpr (SRC != LUT) {
              if (k.tx_kinds) w = tx_weight(k, m0 + j, px, pz, lat);
            }
            if (k.wt.p) w *= __ldg(k.wt.p + owt + (int64_t)(m0 + j) * k.wt.sm);
            WT[j * P + p] = w;
          }
        }
      }
      for (int j = 0; j < mc; ++j) {
        const int m = m0 + j;
        const float tx = TX[j * P + p], t0m = __ldg(a.t0 + m);
        const float wtj = has_wt ? WT[j * P + p] : 1.f;
        const float* __restrict__ xm = opaque(x + ((int64_t)m * a.N + n0) * a.row);
        const float* __restrict__ wdm =
            k.wd.p ? k.wd.p + owd + (int64_t)m * k.wd.sm + (int64_t)n0 * k.wd.sn : nullptr;
        if (keep == KEEP_TX) {
#pragma unroll
          for (int f = 0; f < NF; ++f) acc[f] = A{};
        }
        // a term's delay ti, weight w (1 without weights, exact), validity
        // and phase (c, s), from r its entry of R and its receive and dense
        // factors wrn, wdn
        auto prep = [&](float r, float wrn, float wdn, float& ti, float& w, bool& ok,
                        float& c, float& s) {
          const float tau = SRC == LUT
              ? __fsub_rn(__fadd_rn(tx, r), t0m)
              : __fsub_rn(__fmul_rn(a.cinv, __fadd_rn(tx, r)), t0m);
          ti = __fmul_rn(tau, a.fs);
          w = wrn * wtj * wdn;
          ok = ti >= 0.f && ti <= tmax && w != 0.f;  // false for NaN
          s = 0.f;
          c = 1.f;
          if constexpr (ROT) sincosf(ok ? __fmul_rn(fa.w, tau) : 0.f, &s, &c);
        };
        // its samples, frame f's entries f E floats on, at float o of xm
        auto fetch = [&](float ti, float w, bool ok, float c, float s, unsigned o, A (&v)[NF]) {
#pragma unroll
          for (int f = 0; f < NF; ++f)
            if (f == 0 || f < fb)
              v[f] = scaled(rotate<ROT>(sample<METHOD, V>(xm + f * E, o, ok ? ti : 0.f, S), c, s),
                            w);
        };
        // its sums, receiver n0 + n, by the keep mode
        auto put = [&](const A (&v)[NF], bool ok, int n) {
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            if (f == 0 || f < fb) {
              if (keep == KEEP_BOTH) {
                out[i + (n0 + n) * k.on + m * k.om + f * k.of] = ok ? v[f] : A{};
              } else if (keep == KEEP_RX) {
                if (ok) KR[(f * NC + n) * P + p] = KR[(f * NC + n) * P + p] + v[f];
              } else if (ok) {
                acc[f] = acc[f] + v[f];
              }
            }
          }
        };
        unsigned o = row_origin<METHOD, V>(0u, S);
        int n = 0;
        for (; n + 4 <= nc; n += 4, o += 4 * row) {
          const float4 r = r4[n >> 2];
          float4 wr = make_float4(1.f, 1.f, 1.f, 1.f), wd = wr;
          if (has_wr) wr = w4[n >> 2];
          if (wdm) wd = make_float4(__ldg(wdm + n * k.wd.sn), __ldg(wdm + (n + 1) * k.wd.sn),
                                    __ldg(wdm + (n + 2) * k.wd.sn), __ldg(wdm + (n + 3) * k.wd.sn));
          float ti0, ti1, ti2, ti3, w0, w1, w2, w3, c0, c1, c2, c3, s0, s1, s2, s3;
          bool k0, k1, k2, k3;
          prep(r.x, wr.x, wd.x, ti0, w0, k0, c0, s0);
          prep(r.y, wr.y, wd.y, ti1, w1, k1, c1, s1);
          prep(r.z, wr.z, wd.z, ti2, w2, k2, c2, s2);
          prep(r.w, wr.w, wd.w, ti3, w3, k3, c3, s3);
          A v0[NF], v1[NF], v2[NF], v3[NF];
          fetch(ti0, w0, k0, c0, s0, o, v0);
          fetch(ti1, w1, k1, c1, s1, o + row, v1);
          fetch(ti2, w2, k2, c2, s2, o + 2 * row, v2);
          fetch(ti3, w3, k3, c3, s3, o + 3 * row, v3);
          put(v0, k0, n);
          put(v1, k1, n + 1);
          put(v2, k2, n + 2);
          put(v3, k3, n + 3);
        }
        for (; n < nc; ++n, o += row) {
          float ti, w, c, s;
          bool ok;
          prep(R[p * RS + n], has_wr ? WR[p * RS + n] : 1.f,
               wdm ? __ldg(wdm + n * k.wd.sn) : 1.f, ti, w, ok, c, s);
          A v[NF];
          fetch(ti, w, ok, c, s, o, v);
          put(v, ok, n);
        }
        if (keep == KEEP_TX) {  // this chunk's part of the (pixel, transmit) sums
#pragma unroll
          for (int f = 0; f < NF; ++f) {  // constant indices: acc stays in registers
            if (f < fb) {
              A* q = out + i + m * k.om + f * k.of;
              *q = n0 == 0 ? acc[f] : *q + acc[f];
            }
          }
        }
      }
    }
    if (keep == KEEP_RX) {
      for (int f = 0; f < fb; ++f)
        for (int n = 0; n < nc; ++n)
          out[i + (n0 + n) * k.on + f * k.of] = KR[(f * NC + n) * P + p];
    }
  }
  if (keep == SUM && live) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
      if (j < fb) out[i + j * k.of] = acc[j];
  }
}

// Bytes of das_keep_kernel's shared memory for a launch.
size_t keep_smem(const KeepArgs& k, size_t sum_bytes) {
  const bool has_wr = k.rx_kinds || k.wr.p, has_wt = k.tx_kinds || k.wt.p;
  size_t floats = (size_t)P * RS + MC * P + (has_wr ? P * RS : 0) + (has_wt ? MC * P : 0);
  return floats * 4 + (k.keep == KEEP_RX ? (size_t)NC * k.fa.fb * P * sum_bytes : 0);
}

template <int SRC, int METHOD, typename V, bool ROT>
cudaError_t run_keep(const KeepArgs& k, size_t smem, cudaStream_t s) {
  const unsigned blocks = (unsigned)((k.fa.a.I + P - 1) / P);
  auto kernel = k.fa.fb == 1 ? das_keep_kernel<SRC, METHOD, V, ROT, 1>
                             : das_keep_kernel<SRC, METHOD, V, ROT, FB>;
  if (smem > (48 << 10)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, P, smem, s>>>(k);
  return cudaGetLastError();
}

template <int SRC, typename V, bool ROT>
cudaError_t keep_by_method(int method, const KeepArgs& k, size_t smem, cudaStream_t s) {
  switch (method) {
    case NEAREST: return run_keep<SRC, NEAREST, V, ROT>(k, smem, s);
    case LINEAR: return run_keep<SRC, LINEAR, V, ROT>(k, smem, s);
    case CUBIC: return run_keep<SRC, CUBIC, V, ROT>(k, smem, s);
    case LANCZOS3: return run_keep<SRC, LANCZOS3, V, ROT>(k, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename V, bool ROT>
cudaError_t keep_by_src(int src, int method, const KeepArgs& k, size_t smem, cudaStream_t s) {
  switch (src) {
    case PLANE: return keep_by_method<PLANE, V, ROT>(method, k, smem, s);
    case DIVERGING: return keep_by_method<DIVERGING, V, ROT>(method, k, smem, s);
    case VIRTUAL: return keep_by_method<VIRTUAL, V, ROT>(method, k, smem, s);
    case LUT: return keep_by_method<LUT, V, ROT>(method, k, smem, s);
    default: return cudaErrorInvalidValue;
  }
}
#endif  // DAS_KEEP

// One frame in all (ldo 1): das_kernel, or with ROT the frames kernel's
// one-frame variant; else the frames kernel, FB frames at a time.
template <int SRC, int METHOD, typename V, bool ROT>
cudaError_t run(const FrameArgs& fa, cudaStream_t s) {
  const unsigned blocks = (unsigned)((fa.a.I + P - 1) / P);
  if (fa.ldo != 1)
    das_frames_kernel<SRC, METHOD, V, ROT, FB><<<blocks, P, 0, s>>>(fa);
  else if constexpr (ROT)
    das_frames_kernel<SRC, METHOD, V, ROT, 1><<<blocks, P, 0, s>>>(fa);
  else
    das_kernel<SRC, METHOD, V><<<blocks, P, 0, s>>>(fa.a);
  return cudaGetLastError();
}

template <int SRC, typename V, bool ROT>
cudaError_t by_method(int method, const FrameArgs& a, cudaStream_t s) {
  switch (method) {
    case NEAREST: return run<SRC, NEAREST, V, ROT>(a, s);
    case LINEAR: return run<SRC, LINEAR, V, ROT>(a, s);
    case CUBIC: return run<SRC, CUBIC, V, ROT>(a, s);
    case LANCZOS3: return run<SRC, LANCZOS3, V, ROT>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename V, bool ROT>
cudaError_t by_src(int src, int method, const FrameArgs& a, cudaStream_t s) {
  switch (src) {
    case PLANE: return by_method<PLANE, V, ROT>(method, a, s);
    case DIVERGING: return by_method<DIVERGING, V, ROT>(method, a, s);
    case VIRTUAL: return by_method<VIRTUAL, V, ROT>(method, a, s);
    case LUT: return by_method<LUT, V, ROT>(method, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// Frames f0 .. f0 + fb - 1 of F: x and out move to frame f0; with F = 1 the
// one-frame variants run. ROT selects the rotating variants, whose sums are
// complex.
template <bool ROT>
int launch(int src, int method, int cplx, Args a, int F, int f0, int fb, float w, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.I <= 0) return (int)cudaSuccess;
  if (a.N <= 0 || a.M <= 0 || a.T <= 0 || a.T > TMAX || method < NEAREST || method > LANCZOS3
      || F < 1 || f0 < 0 || fb < 1 || fb > FB || f0 + fb > F)
    return (int)cudaErrorInvalidValue;
  const int E = entry_floats(method, cplx);
  a.row = (int64_t)a.T * F * E;
  if ((int64_t)NC * a.row >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  a.x += (int64_t)f0 * E;
  a.out = static_cast<char*>(a.out) + (int64_t)f0 * ((cplx || ROT) ? 8 : 4);
  const FrameArgs fa{a, F, F * E, fb, w};
  cudaStream_t s = (cudaStream_t)stream;
  err = cplx ? by_src<float2, ROT>(src, method, fa, s) : by_src<float, ROT>(src, method, fa, s);
  return (int)err;
}

// The layout kernel: traces x (T, N, ldm) of C floats (1 real, 2
// complex64), of which entries 0..M-1 of the last axis are laid out as the
// sampler METHOD reads them, out (M, N, T, C, E) floats, E the floats of
// one entry of one component. With frames (FR), an entry q of the last
// axis is frame f of transmit m, q = m F + f, and out is (M / F, N, T, F,
// C, E): a term's frames next to each other. A block transposes tiles of
// LM entries q x LT entries k of one receiver through shared memory:
// coalesced reads along q, 4- to 16-byte writes along k. The grid's y and
// z (q tiles, receivers) hold at most 65535 blocks each, so a block walks
// them with the grid's stride: any number of receivers, transmits and
// frames. It replaces what the TPU path does in XLA before its kernel (the
// transpose and _pack_quads of qups_tpu/ops/das_pallas.py:2015-2023) and
// computes exactly what ops/das_cuda.py::trace_layout_plain computes: the
// stencil entries with the round-to-nearest intrinsics, in stencil_entry's
// order.
constexpr int LT = 64;       // entries per layout block
constexpr int LM = 32;       // transmits (frames) per layout block
constexpr int LS = LT + 3;   // tile rows x[k0-1 .. k0+LT+1]; odd, so conflict-free

template <int METHOD>
__device__ __forceinline__ void put_entry(const float* q, float* __restrict__ dst) {
  // q[0..3] = x[k-1], x[k], x[k+1], x[k+2] (clamped)
  if constexpr (METHOD == NEAREST) {
    dst[0] = q[1];
  } else if constexpr (METHOD == LINEAR) {
    *reinterpret_cast<float2*>(dst) = make_float2(q[1], __fsub_rn(q[2], q[1]));
  } else if constexpr (METHOD == CUBIC) {
    *reinterpret_cast<float4*>(dst) = make_float4(
        q[1], __fmul_rn(0.5f, __fsub_rn(q[2], q[0])),
        __fadd_rn(__fsub_rn(q[0], __fmul_rn(2.5f, q[1])),
                  __fsub_rn(__fmul_rn(2.f, q[2]), __fmul_rn(0.5f, q[3]))),
        __fadd_rn(__fmul_rn(1.5f, __fsub_rn(q[1], q[2])), __fmul_rn(0.5f, __fsub_rn(q[3], q[0]))));
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(q[0], q[1], q[2], q[3]);
  }
}

template <int METHOD, int C, bool FR>
__global__ void __launch_bounds__(256) layout_kernel(const float* __restrict__ x,
                                                     float* __restrict__ out, int T, int N,
                                                     int M, int64_t ldm, int F) {
  constexpr int E = Entry<METHOD, float>::E;
  __shared__ float tile[C][LM][LS];
  const int k0 = blockIdx.x * LT;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int n = blockIdx.z; n < N; n += gridDim.z) {
    for (int m0 = blockIdx.y * LM; m0 < M; m0 += gridDim.y * LM) {
      __syncthreads();  // the last tile's reads are done
      if (m0 + lane < M) {
        for (int r = w; r < LS; r += 8) {
          const int t = min(max(k0 - 1 + r, 0), T - 1);
          const int64_t at = ((int64_t)t * N + n) * ldm + m0 + lane;
          if constexpr (C == 2) {
            const float2 v = __ldg(reinterpret_cast<const float2*>(x) + at);
            tile[0][lane][r] = v.x;
            tile[1][lane][r] = v.y;
          } else {
            tile[0][lane][r] = __ldg(x + at);
          }
        }
      }
      __syncthreads();
      for (int mm = w; mm < LM && m0 + mm < M; mm += 8) {
        if constexpr (FR) {
          const int m = (m0 + mm) / F, f = m0 + mm - m * F;
          for (int kk = lane; kk < LT && k0 + kk < T; kk += 32) {
            float* dst = out + ((((int64_t)m * N + n) * T + k0 + kk) * F + f) * (C * E);
#pragma unroll
            for (int c = 0; c < C; ++c) put_entry<METHOD>(&tile[c][mm][kk], dst + c * E);
          }
        } else {
          for (int kk = lane; kk < LT && k0 + kk < T; kk += 32) {
            float* dst = out + (((int64_t)(m0 + mm) * N + n) * T + k0 + kk) * (C * E);
#pragma unroll
            for (int c = 0; c < C; ++c) put_entry<METHOD>(&tile[c][mm][kk], dst + c * E);
          }
        }
      }
    }
  }
}

// F frames a transmit: the last axis holds M F entries, ldm F a row.
template <int METHOD, bool FR>
cudaError_t run_layout(const float* x, float* out, int T, int N, int M, int64_t ldm, int F,
                       int cplx, cudaStream_t s) {
  const int mt = (M + LM - 1) / LM;
  const dim3 grid((T + LT - 1) / LT, mt < 65535 ? mt : 65535, N < 65535 ? N : 65535);
  if (cplx)
    layout_kernel<METHOD, 2, FR><<<grid, 256, 0, s>>>(x, out, T, N, M, ldm, F);
  else
    layout_kernel<METHOD, 1, FR><<<grid, 256, 0, s>>>(x, out, T, N, M, ldm, F);
  return cudaGetLastError();
}

template <int METHOD>
cudaError_t layout_frames(const float* x, float* out, int T, int N, int M, int64_t ldm,
                          int F, int cplx, cudaStream_t s) {
  return F == 1 ? run_layout<METHOD, false>(x, out, T, N, M, ldm, 1, cplx, s)
                : run_layout<METHOD, true>(x, out, T, N, M * F, ldm * F, F, cplx, s);
}

}  // namespace

// The entry points. This file builds four times: as das.cu, K1 and K2
// without remodulation and the layout kernel; with DAS_IQ defined
// (das_iq.cu), K1 and K2 with remodulation, das_k1_iq and das_lut_k2_iq,
// which take the same arguments; with DAS_KEEP defined (das_keep.cu), the
// keep modes and weights of K1 and K2 without remodulation, das_keep, and
// with both defined (das_keep_iq.cu) with it, das_keep_iq. ROT_ is the
// variants' rotation, SUFFIX_ their names'.
#ifdef DAS_IQ
#define ROT_ true
#define SUFFIX_(name) name##_iq
#else
#define ROT_ false
#define SUFFIX_(name) name
#endif

#ifdef DAS_KEEP
// Launch das_keep_kernel on `stream` of device `device` for M transmits
// and frames f0 .. f0 + fb - 1 of F: K1 (src 0 plane, 1 diverging, 2
// virtual; pix, pr, pv, nv, cinv) or K2 (src 3; taur (I, N), taut (I, ldt),
// whose first M columns are these transmits'). x, t0, fs, w, method, cplx
// as for das_k1; rot 1 for the remodulating variants (das_keep_iq, which
// refuses rot 0, as das_keep refuses 1); out at frame 0 and
// the launch's first transmit, (N', M', F, I) with the strides on, om, of
// (in sums: complex64 when cplx or rot, else float32), to which the sums
// are added when add is 1 (summed and keep_rx only); keep 0 summed, 1 rx,
// 2 tx, 3 both; I2, I3 the image's trailing dims. wr, wt, wd the dense
// weights over (i, n), (i, m), (i, n, m) or null, strides (host, 15
// int64: s1 s2 s3 sn sm of each, wt and wd at the launch's first
// transmit); rx_kinds, tx_kinds the fused kinds (K1 only), ori (N, 2), lat
// (I,), lat_tx (M,) and prm (host, 7 floats: 2 f, Dmax, cos theta, tol,
// dlat, xlo, xhi) their operands. Returns the cudaError_t of the launch; 0
// is success.
extern "C" int SUFFIX_(das_keep)(const float* x, const float* pix, const float* pr, const float* pv,
                        const float* nv, const float* taur, const float* taut, long long ldt,
                        const float* t0, void* out, long long I, int N, int M, int T, int F,
                        int f0, int fb, float cinv, float fs, float w, int src, int method,
                        int cplx, int rot, int add, int keep, long long on, long long om,
                        long long of, int I2, int I3, const float* wr, const float* wt,
                        const float* wd, const long long* strides, int rx_kinds, int tx_kinds,
                        const float* ori, const float* lat, const float* lat_tx,
                        const float* prm, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (I <= 0) return (int)cudaSuccess;
  if (N <= 0 || M <= 0 || T <= 0 || T > TMAX || method < NEAREST || method > LANCZOS3
      || src < PLANE || src > LUT || keep < SUM || keep > KEEP_BOTH || F < 1 || f0 < 0
      || fb < 1 || fb > FB || f0 + fb > F || I2 < 1 || I3 < 1 || (src == LUT && ldt < M)
      || (src == LUT && (rx_kinds || tx_kinds)) || (rot != 0) != ROT_)
    return (int)cudaErrorInvalidValue;
  const int E = entry_floats(method, cplx);
  const size_t sum_bytes = (cplx || rot) ? 8 : 4;
  Args a{x + (int64_t)f0 * E, pix, pr, pv, nv, taur, taut, t0,
         static_cast<char*>(out) + (int64_t)f0 * of * (int64_t)sum_bytes, (int64_t)I,
         (int64_t)T * F * E, (int64_t)ldt, N, M, T, cinv, fs, add};
  if ((int64_t)NC * a.row >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  KeepArgs k{FrameArgs{a, F, F * E, fb, w}, keep, on, om, of, I2, I3,
             Dense{wr, s[0], s[1], s[2], s[3], s[4]}, Dense{wt, s[5], s[6], s[7], s[8], s[9]},
             Dense{wd, s[10], s[11], s[12], s[13], s[14]}, rx_kinds, tx_kinds, ori, lat, lat_tx,
             prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], prm[6]};
  const size_t smem = keep_smem(k, sum_bytes);
  if (keep == KEEP_RX && (size_t)NC * fb * P * sum_bytes > (size_t)KR_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  err = cplx ? keep_by_src<float2, ROT_>(src, method, k, smem, st)
             : keep_by_src<float, ROT_>(src, method, k, smem, st);
  return (int)err;
}
#else

// Launch K1 on `stream` (a cudaStream_t) of device `device` for M
// transmits and frames f0 .. f0 + fb - 1 (fb <= 4) of F. x holds their
// traces in the layout of `method` (das_layout's output: (M, N, T, F,
// entry)), float32, or complex64 when `cplx` is 1; pv, nv (M, 3) and t0
// (M,) theirs; out (I, F) of the sums' type (complex64 when `cplx` is 1 or
// for the remodulating entry, else float32), to which the sums are added
// when `add` is 1; w = 2 pi fmod (the remodulating entry; the other ignores
// it). Returns the cudaError_t of the launch (cudaGetLastError right after
// it); 0 is success.
extern "C" int SUFFIX_(das_k1)(const float* x, const float* pix, const float* pr,
                               const float* pv, const float* nv, const float* t0, void* out,
                               long long I, int N, int M, int T, int F, int f0, int fb,
                               float cinv, float fs, float w, int tx_model, int method,
                               int cplx, int add, int device, void* stream) {
  if (tx_model < PLANE || tx_model > VIRTUAL) return (int)cudaErrorInvalidValue;
  const Args a{x, pix, pr, pv, nv, nullptr, nullptr, t0, out, (int64_t)I, 0, 0, N, M, T,
               cinv, fs, add};
  return launch<ROT_>(tx_model, method, cplx, a, F, f0, fb, w, device, stream);
}

// Launch K2 on `stream` of device `device` for M transmits and frames f0 ..
// f0 + fb - 1 of F. x, out, w and add as for das_k1; taur (I, N) and taut
// (I, ldt), of which the first M columns are these transmits', the delay
// tables [s]; t0 (M,). Returns the cudaError_t of the launch; 0 is success.
extern "C" int SUFFIX_(das_lut_k2)(const float* x, const float* taur, const float* taut,
                                   const float* t0, void* out, long long I, int N, int M,
                                   long long ldt, int T, int F, int f0, int fb, float fs,
                                   float w, int method, int cplx, int add, int device,
                                   void* stream) {
  if (ldt < M) return (int)cudaErrorInvalidValue;
  const Args a{x, nullptr, nullptr, nullptr, nullptr, taur, taut, t0, out, (int64_t)I, 0,
               (int64_t)ldt, N, M, T, 0.f, fs, add};
  return launch<ROT_>(LUT, method, cplx, a, F, f0, fb, w, device, stream);
}

#ifndef DAS_IQ
// Launch the layout kernel on `stream` of device `device`: x (T, N, ldm, F)
// float32, or complex64 when `cplx` is 1, contiguous, of which transmits
// 0 .. M-1 of the third axis are laid out; out the layout of `method` (0
// nearest: the traces; 1 linear, 2 cubic, 3 lanczos3: stencils), (M, N, T,
// F, [2,] E) floats. Returns the cudaError_t of the launch; 0 is success.
extern "C" int das_layout(const float* x, float* out, int T, int N, int M, long long ldm,
                          int F, int method, int cplx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T <= 0 || N <= 0 || M <= 0 || F <= 0 || ldm < M || T > TMAX
      || (int64_t)M * F >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case NEAREST: return (int)layout_frames<NEAREST>(x, out, T, N, M, ldm, F, cplx, s);
    case LINEAR: return (int)layout_frames<LINEAR>(x, out, T, N, M, ldm, F, cplx, s);
    case CUBIC: return (int)layout_frames<CUBIC>(x, out, T, N, M, ldm, F, cplx, s);
    case LANCZOS3: return (int)layout_frames<LANCZOS3>(x, out, T, N, M, ldm, F, cplx, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif
#endif  // DAS_KEEP
