// K1 and K2: delay-and-sum, summed output, float32 traces, real or complex
// (interleaved complex64, such as the analytic traces greens returns). One
// kernel body, das_kernel below, serves both; a compile-time switch (SRC)
// says where a term's transmit and receive parts come from.
//
// K1 (SRC = PLANE, DIVERGING or VIRTUAL) replaces the TPU kernel
// qups_tpu/ops/das_pallas.py::_kernel in geometry mode (launched by
// _das_call, public entry das_tiled) and computes what
// qups_tpu_torch/ops/das.py::das computes for that case:
//
//   dv  = rv.nv (plane) | |rv| (diverging) | copysign(|rv|, rv.nv) (virtual),
//         rv = p_i - pv_m
//   dr  = |p_i - pr_n|
//   ti  = (cinv * (dv + dr) - t0_m) * fs
//
// K2 (SRC = LUT) replaces the same TPU kernel with lut=True (launched by
// _das_lut_call, public entry das_lut_tiled) and computes what
// ops/das.py::das_lut computes: ti = ((tau_tx[i, m] + tau_rx[i, n]) - t0_m) * fs.
// Both then sum
//
//   out_i = sum_{m,n} sample(x[m, n, :], ti)   for 0 <= ti <= T-1, else 0
//
// with the samplers of ops/interp.py: nearest (round half to even), linear,
// cubic (Catmull-Rom) and lanczos3, taps clamp-replicated to [0, T-1].
// Complex traces take the same delays and weights; the real and imaginary
// parts are summed in two float32 accumulators.
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
// variants contain no FFMA at all (chip_smoke.py checks the SASS). Each
// thread sums in registers and writes its pixel once: no atomics, so two
// launches give the same bits.
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

// Where a sampler finds tap base k in its trace's row: at float k E, E the
// floats of one entry (nearest: one sample; the others: one stencil entry).
template <int METHOD, typename V>
struct Entry {
  static constexpr int C = sizeof(V) / sizeof(float);  // 1 real, 2 complex
  static constexpr int E = (METHOD == NEAREST ? 1 : METHOD == LINEAR ? 2 : 4) * C;
};

// Floats per trace: T entries.
int64_t row_floats(int method, int T, int cplx) {
  return (int64_t)T * (cplx ? 2 : 1) * (method == NEAREST ? 1 : method == LINEAR ? 2 : 4);
}

// The offset o that sample() takes for the trace at float `start` of xm:
// start - (bits of 2^23) E, wrapping.
template <int METHOD, typename V>
__device__ __forceinline__ unsigned row_origin(unsigned start) {
  return start - 0x4B000000u * (unsigned)Entry<METHOD, V>::E;
}

// The sample at ti, 0 <= ti <= T-1 (any ti in that range: the caller
// passes 0 for an invalid term and drops its value), of the trace whose
// row starts at float o of xm. 2^23 + ti, rounded, holds the tap base in
// its low mantissa bits: rounded to nearest (half to even, as torch.round)
// for nearest, down (floor) for the others; subtracting 2^23 again is
// exact, and so is the fraction u. The bits of 2^23 are subtracted from
// the entry's offset in unsigned (wrapping) arithmetic as part of o (see
// row_origin), so the offset costs one shift-add.
template <int METHOD, typename V>
__device__ __forceinline__ V sample(const float* __restrict__ xm, unsigned o, float ti) {
  using L = Entry<METHOD, V>;
  constexpr bool CPLX = L::C == 2;
  const float r = METHOD == NEAREST ? __fadd_rn(ti, 0x1p23f) : __fadd_rd(ti, 0x1p23f);
  const float* __restrict__ e = xm + (o + (unsigned)__float_as_int(r) * L::E);
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
// needs (PERF.md §5).
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

template <int SRC, int METHOD, typename V>
cudaError_t run(const Args& a, cudaStream_t s) {
  das_kernel<SRC, METHOD, V><<<(unsigned)((a.I + P - 1) / P), P, 0, s>>>(a);
  return cudaGetLastError();
}

template <int SRC, typename V>
cudaError_t by_method(int method, const Args& a, cudaStream_t s) {
  switch (method) {
    case NEAREST: return run<SRC, NEAREST, V>(a, s);
    case LINEAR: return run<SRC, LINEAR, V>(a, s);
    case CUBIC: return run<SRC, CUBIC, V>(a, s);
    case LANCZOS3: return run<SRC, LANCZOS3, V>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename V>
cudaError_t by_src(int src, int method, const Args& a, cudaStream_t s) {
  switch (src) {
    case PLANE: return by_method<PLANE, V>(method, a, s);
    case DIVERGING: return by_method<DIVERGING, V>(method, a, s);
    case VIRTUAL: return by_method<VIRTUAL, V>(method, a, s);
    case LUT: return by_method<LUT, V>(method, a, s);
    default: return cudaErrorInvalidValue;
  }
}

int launch(int src, int method, int cplx, Args a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.I <= 0) return (int)cudaSuccess;
  if (a.N <= 0 || a.M <= 0 || a.T <= 0 || a.T > TMAX || method < NEAREST || method > LANCZOS3)
    return (int)cudaErrorInvalidValue;
  a.row = row_floats(method, a.T, cplx);
  cudaStream_t s = (cudaStream_t)stream;
  err = cplx ? by_src<float2>(src, method, a, s) : by_src<float>(src, method, a, s);
  return (int)err;
}

// The layout kernel: traces x (T, N, ldm) of C floats (1 real, 2 complex64),
// transmits 0..M-1 of them, into the layout the sampler METHOD reads, out
// (M, N, T, C, E) floats, E the floats of one entry of one component. A
// block transposes tiles of LM transmits x LT entries of one receiver
// through shared memory: coalesced reads along m, coalesced 4- to 16-byte
// writes along k. The grid's y and z (transmit tiles, receivers) hold at
// most 65535 blocks each, so a block walks them with the grid's stride: any
// number of receivers and transmits. It replaces what the TPU path
// does in XLA before its kernel (the transpose and _pack_quads of
// qups_tpu/ops/das_pallas.py:2015-2023) and computes exactly what
// ops/das_cuda.py::trace_layout_plain computes: the stencil entries with
// the round-to-nearest intrinsics, in stencil_entry's order.
constexpr int LT = 64;       // entries per layout block
constexpr int LM = 32;       // transmits per layout block
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

template <int METHOD, int C>
__global__ void __launch_bounds__(256) layout_kernel(const float* __restrict__ x,
                                                     float* __restrict__ out, int T, int N,
                                                     int M, int64_t ldm) {
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
        for (int kk = lane; kk < LT && k0 + kk < T; kk += 32) {
          float* dst = out + (((int64_t)(m0 + mm) * N + n) * T + k0 + kk) * (C * E);
#pragma unroll
          for (int c = 0; c < C; ++c) put_entry<METHOD>(&tile[c][mm][kk], dst + c * E);
        }
      }
    }
  }
}

template <int METHOD>
cudaError_t run_layout(const float* x, float* out, int T, int N, int M, int64_t ldm,
                       int cplx, cudaStream_t s) {
  const int mt = (M + LM - 1) / LM;
  const dim3 grid((T + LT - 1) / LT, mt < 65535 ? mt : 65535, N < 65535 ? N : 65535);
  if (cplx)
    layout_kernel<METHOD, 2><<<grid, 256, 0, s>>>(x, out, T, N, M, ldm);
  else
    layout_kernel<METHOD, 1><<<grid, 256, 0, s>>>(x, out, T, N, M, ldm);
  return cudaGetLastError();
}

}  // namespace

// Launch K1 on `stream` (a cudaStream_t) of device `device` for M
// transmits. x holds their traces in the layout of `method` (das_layout's
// output), float32, or complex64 when `cplx` is 1; pv, nv (M, 3) and t0
// (M,) theirs; out (I,) of the trace type, to which the sum is added when
// `add` is 1. Returns the cudaError_t of the launch (cudaGetLastError right
// after it); 0 is success.
extern "C" int das_k1(const float* x, const float* pix, const float* pr,
                      const float* pv, const float* nv, const float* t0,
                      void* out, long long I, int N, int M, int T, float cinv,
                      float fs, int tx_model, int method, int cplx, int add, int device,
                      void* stream) {
  if (tx_model < PLANE || tx_model > VIRTUAL) return (int)cudaErrorInvalidValue;
  const Args a{x, pix, pr, pv, nv, nullptr, nullptr, t0, out, (int64_t)I, 0, 0, N, M, T,
               cinv, fs, add};
  return launch(tx_model, method, cplx, a, device, stream);
}

// Launch K2 on `stream` of device `device` for M transmits. x, out and add
// as for das_k1; taur (I, N) and taut (I, ldt), of which the first M columns
// are these transmits', the delay tables [s]; t0 (M,). Returns the
// cudaError_t of the launch; 0 is success.
extern "C" int das_lut_k2(const float* x, const float* taur, const float* taut,
                          const float* t0, void* out, long long I, int N, int M,
                          long long ldt, int T, float fs, int method, int cplx, int add,
                          int device, void* stream) {
  if (ldt < M) return (int)cudaErrorInvalidValue;
  const Args a{x, nullptr, nullptr, nullptr, nullptr, taur, taut, t0, out, (int64_t)I, 0,
               (int64_t)ldt, N, M, T, 0.f, fs, add};
  return launch(LUT, method, cplx, a, device, stream);
}

// Launch the layout kernel on `stream` of device `device`: x (T, N, ldm)
// float32, or complex64 when `cplx` is 1, contiguous, of which the first M
// of the last axis are laid out; out the layout of `method` (0 nearest: the
// traces; 1 linear, 2 cubic, 3 lanczos3: stencils), (M, N, T, [2,] E)
// floats. Returns the cudaError_t of the launch; 0 is success.
extern "C" int das_layout(const float* x, float* out, int T, int N, int M, long long ldm,
                          int method, int cplx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T <= 0 || N <= 0 || M <= 0 || ldm < M || T > TMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case NEAREST: return (int)run_layout<NEAREST>(x, out, T, N, M, ldm, cplx, s);
    case LINEAR: return (int)run_layout<LINEAR>(x, out, T, N, M, ldm, cplx, s);
    case CUBIC: return (int)run_layout<CUBIC>(x, out, T, N, M, ldm, cplx, s);
    case LANCZOS3: return (int)run_layout<LANCZOS3>(x, out, T, N, M, ldm, cplx, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
