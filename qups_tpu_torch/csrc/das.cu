// K1 and K2: delay-and-sum, float32 traces, real or complex (interleaved
// complex64, such as the analytic traces greens returns), with frames and
// IQ remodulation (sub-slices K1(b), K2(b)), keep modes and apodization
// weights (K1(c), K1(d), K2(c)) and reduced-precision traces (K1(e),
// K2(e); see "Reduced-precision traces" below). Three kernel bodies serve both:
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
//   same loops with a block of frames' sums per thread in registers (one
//   launch per block of frames; one frame with fmod a variant of its own):
//   a term's delay, validity, tap base, fraction, weights and rotation are
//   formed once for all its frames.
// - Frames: the layout holds a call's frames in blocks of the frames a
//   launch sums, (M, N, T, fb, entry) block after block (the last block
//   short), so a launch reads its fb entries of a tap base side by side,
//   fb E units apart (S) from the next tap base's. A warp's lanes are
//   neighbouring pixels, whose tap bases lie up to sigma = 2 dx fs / c
//   apart (dx the step between pixels): lanes' loads fall sigma fb E bytes
//   apart, and past a sector or two each lane's load takes a cache line of
//   its own. So K1 takes the largest block of 4, 2, 1 within the cap
//   (frames_a_launch: FRAMES_A_LAUNCH, but 1 for complex cubic float32
//   traces) whose span sigma fb E stays within FRAME_SPAN bytes
//   (ops/das_cuda.py::frames_per_launch, from the first 32 pixels; K2 has
//   no pixels and takes the cap). At PICMUS's pitch (sigma 1.91, 16 real
//   cubic frames) 4 frames a launch on a layout of all 16 frames (a 256-byte
//   tap stride) took 130.2 ms, on blocks of 4 61.4, of 2 54.8, one-frame
//   calls on planes 47.9; at sigma 0.95 blocks of 4 won (42.4 against
//   44.6 and 46.3). FRAME_SPAN lies between 30.5 bytes, where the larger
//   block won or tied in every case swept but nearest real traces' 2-frame
//   launch, and 61, where it won in 5 cases and lost in 3; over the sweep
//   its picks took 1850 ms against 1792 for each case's best block and 2628
//   on the layout of all frames (PERF.md §6, PR 23). Complex cubic
//   float32 traces (32-byte entries) take one frame: blocks of 4 or 2 lost
//   to one-frame calls at the IQ headline without fmod (473 and 437 against
//   385 ms) and, with fmod, at PICMUS's pitch (45 against 27 ms; PR 17).
//   Where the plan takes one frame a launch the wrapper runs one-frame calls
//   on each frame's plane (das_kernel without fmod). A layout with the frames
//   outside the time axis ran 1.4-5x slower with 2 or 4 frames a launch.
//   The rotating variants keep FRAMES_MIN_BLOCKS
//   blocks an SM (64 registers, no spills; at 72-73 registers, 3 blocks, the
//   rotating complex cubic block ran 1.27x slower) and unroll FRAMES_UNROLL
//   groups (1: 2 ran up to 1.22x slower with fmod); the unrotated ones keep
//   das_kernel's unroll, UNROLL, and ptxas's registers (capped, PICMUS's
//   real cubic frames ran 1.45x slower; unrolled 1, K2's nearest frames
//   1.12x). The sweeps are in PERF.md §6, PR 17. One frame without fmod runs
//   das_kernel, unchanged, with the arguments it always took: with the
//   frames' fields among them, its variants gained registers (K2's real
//   linear sampler 62 -> 72, 3 blocks per SM) and ran up to 1.24x slower
//   (PERF.md §6).
// - Remodulation is one short rotation per term (sincos_reduced: the phase
//   reduced to [-pi/4, pi/4] in two FMAs, the special function unit's sin
//   and cos of the reduced angle, the quadrant's swap and signs), then a
//   complex product per frame; sincosf took twice the time and, unrolled, a
//   stack frame. A phase past PHASE_MAX, which no acquisition reaches (2^20
//   rad: 166886 cycles of fmod within a trace), takes variants with the
//   accurate sincosf instead, chosen by the wrapper from w (T - 1) / fs; a
//   reduction in one double-precision FMA, within 2^-21 to 2^30 rad, ran
//   1.6-20 % slower with fmod (PERF.md §6, PR 17). The rotating
//   instantiations live in a second translation unit, das_iq.cu (this file
//   built with DAS_IQ defined), so the two build in parallel; without fmod
//   the kernels hold no rotation at all.
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
// float32 tau (another rounding of the phase moves a term by ~1e-4 rad at
// IQ sizes, where the phase reaches thousands of radians), then
// sincos_reduced, within 2^-21 of the float64 sin and cos of that phase
// (__sincosf alone: its error grows with the phase). Each thread sums in
// registers and writes its pixel once: no atomics, so two launches give
// the same bits.
//
// PERF.md §5 compares the tile sizes below and the launch bound with the
// alternatives measured.
//
// Reduced-precision traces (K1(e), K2(e); the TPU kernel's precision modes,
// das_pallas.py:1323-1354 and :2441-2479): the layout kernel rounds each tap
// as the precision says, 'bf16pair' to bfloat16 half away from zero (the
// TPU kernel's _pack_pairs), 'bf16' half to even, 'i8x4' to the int8 q =
// clip(rint(x 127 / s), -127, 127) with s one scale per transmit (K1) or per
// call (K2, the same s for every transmit; _pack_quads), and writes the
// rounded taps in one of the entry forms below; the weights, the rotation
// and the sums stay float32. Which form a call's layout takes is
// ops/das_cuda.py::entry_form's plan (reads() below says which variants
// the units build for it). The time follows the instructions a term
// issues, so a sampler's work that depends on the taps alone is done once
// per tap base, in the layout, wherever the form can hold its result:
// - Real cubic 'bf16pair' and 'bf16' traces, and real cubic 'i8x4' ones
//   in the keep kernel: the float32 Catmull-Rom coefficients of the
//   rounded taps (the int8 taps' times s / 127), the float32 layout's
//   entry, read by the float32 instantiations unchanged: a term costs what
//   a float32 term costs, and the keep kernel runs the float32 units'
//   unweighted variants. (Coefficients are not rounded: the coefficients
//   of rounded taps differ from rounded coefficients.)
// - Cubic 'i8x4' traces otherwise (H16): the four coefficients of each
//   part's int8 taps in IEEE half precision, 8 bytes a part, which beat
//   16-byte float32 ones though a term widens them (PERF.md §6). They are
//   multiples of 1/2 with |c0|, |c1| <= 127, |c2| <= 762, |c3| <= 508, so
//   half precision (11 significant bits) holds them exactly; a term widens
//   them and takes poly3.
// - The rest keep the rounded taps (BF16: bfloat16 bits, 2 bytes each;
//   I8: int8, 1 byte each): nearest one sample, linear (x[k], x[k+1]) in
//   one 4-byte load, cubic (complex bf16 traces) and lanczos3 the four taps
//   x[k-1..k+2] in one 8-byte (int8: 4-byte) load, from which sample()
//   forms the sampler's weights of the fraction per term (a frame's terms
//   share them); complex bf16 cubic traces with frames share the weights
//   over 2 F tap sets, where 32-byte float32 entries lost (PERF.md §6).
// H16 and I8 take s / 127 once per (pixel, transmit, chunk of NC
// receivers) in the summed kernels, on the transmit's sum over the chunk,
// and per term in the keep kernel, folded into its transmit factor. F32X is
// the float32 layout with the reduced-precision units' arguments: the keep
// kernel's kept sums stored as bfloat16 (QUPS_DAS_ACC16, half the bytes of
// its output), which the other entry types take too. These instantiations
// build in translation units of their own, one per rounding and rotation
// (DAS_Q: das_bf16.cu, das_i8.cu (I8 and H16), das_keep_bf16.cu,
// das_keep_i8.cu, das_keep_acc16.cu and their _iq twins), so the float32
// units' variants stay as they were and the builds run in parallel.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Src { PLANE = 0, DIVERGING = 1, VIRTUAL = 2, LUT = 3 };
enum Method { NEAREST = 0, LINEAR = 1, CUBIC = 2, LANCZOS3 = 3 };
// The entry types (ops/das_cuda.py FORMS): see the head of this file.
enum Prec { F32 = 0, BF16 = 1, I8 = 2, F32X = 3, H16 = 4 };

constexpr int P = 256;        // pixels per block, one per thread
constexpr int NC = 32;        // receivers per chunk of the receive table
constexpr int MC = 8;         // transmits per chunk of transmit terms
constexpr int UNROLL = 2;     // groups of 4 receivers per unrolled step
constexpr int RS = NC + 4;    // row stride of R: 16-byte rows, conflict-free 16-byte reads
constexpr int TMAX = 1 << 22;  // longest trace: the index arithmetic of sample()
static_assert(NC % 4 == 0, "R is read four receivers at a time");

// das_frames_kernel's plan, chosen by the sweeps of PERF.md §6, PR 17:
// the frames a launch (FRAMES_A_LAUNCH, but one for complex cubic float32
// traces; ops/das_cuda.py::frames_per_launch mirrors it) and, for the
// rotating variants, the unroll of the receiver loop (groups of 4
// receivers) and the least blocks an SM (__launch_bounds__). Within that
// cap K1 takes the largest of 4, 2, 1 frames whose entries at a tap base
// span at most FRAME_SPAN bytes times the tap bases between neighbouring
// pixels (see "Frames" above; frames_per_launch applies it, as only the
// wrapper sees the pixels; PERF.md §6, PR 23).
constexpr int FRAMES_A_LAUNCH = 4;
constexpr int FRAME_SPAN = 48;
constexpr int FRAMES_UNROLL = 1;
constexpr int FRAMES_MIN_BLOCKS = 4;
// The largest |phase| the short rotation takes, in radians.
constexpr float PHASE_MAX = 0x1p20f;
// The rotations: none; sincos_reduced; the accurate sincosf (phases past
// PHASE_MAX).
enum Rot { NO_ROT = 0, ROT_REDUCED = 1, ROT_SINCOSF = 2 };

constexpr int frames_a_launch(int method, int q, int cplx) {
  return method == CUBIC && q == F32 && cplx ? 1 : FRAMES_A_LAUNCH;
}
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

// The unit of a layout of entry type Q: a float, a bfloat16's bits, an int8,
// a half's bits.
template <int Q> struct UnitOf { using type = float; };
template <> struct UnitOf<BF16> { using type = uint16_t; };
template <> struct UnitOf<I8> { using type = uint8_t; };
template <> struct UnitOf<H16> { using type = uint16_t; };
template <int Q> using Unit = typename UnitOf<Q>::type;

// The entry types whose sums take each transmit's s_m / 127 (int8 taps).
__host__ __device__ constexpr bool per_tx_scale(int q) { return q == I8 || q == H16; }

// Whether the kernels of entry type q read a layout of the sampler `method`
// on complex (cplx) or real traces, in the keep kernel (keep) or the summed
// ones: the forms of ops/das_cuda.py::entry_form (real cubic traces take
// float32 coefficients, but the summed kernels' int8 ones H16; complex
// cubic int8 ones H16), so the units build no variant that no plan
// launches.
__host__ __device__ constexpr bool reads(int q, int method, bool cplx, bool keep) {
  return q == I8    ? method == LANCZOS3
         : q == H16 ? method == CUBIC && (cplx || !keep)
         : q == BF16 ? method != CUBIC || cplx
                     : true;
}

// The reduced-precision units' arguments beside a kernel's own: qs the
// dequantization scale s / 127 of each of the launch's transmits (I8), and
// acc16, 1 when the keep kernel stores its kept sums as bfloat16.
struct Lp {
  const float* qs;
  int acc16;
};
template <class B> struct WithLp : B {
  Lp lp;
};
// A kernel's argument block: B for F32, B and Lp for the other entry types.
template <int Q, class B> using QArgs = std::conditional_t<Q == F32, B, WithLp<B>>;

template <int Q, class B> QArgs<Q, B> with_lp(const B& b, Lp lp) {
  if constexpr (Q == F32) {
    return b;
  } else {
    return WithLp<B>{b, lp};
  }
}

// das_frames_kernel's arguments: Args (x and out at the launch's first
// frame, out (I, ldo)) and the frames and remodulation. das_kernel takes
// Args alone: a larger argument block cost its variants registers (K2's
// real linear sampler 62 -> 72, PERF.md §6).
struct FrameArgs {
  Args a;
  int64_t ldo;                    // sums per pixel in out: F
  int S, fb;                      // units per tap base (the layout's fl entries); frames here
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
template <typename T>
__device__ __forceinline__ const T* opaque(const T* p) {
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

// ops/interp.py's Catmull-Rom weights of the fraction u, in its order.
__device__ __forceinline__ float4 cubic_w(float u) {
  const float u2 = u * u;
  return make_float4(0.5f * (u * (-1.f + u * (2.f - u))), 0.5f * (2.f + u2 * (-5.f + 3.f * u)),
                     0.5f * (u * (1.f + u * (4.f - 3.f * u))), 0.5f * (u2 * (u - 1.f)));
}

// A bfloat16 tap widened to float: the low or the high half of a word.
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xFFFF0000u); }

// Four bfloat16 taps x[k-1..k+2] of an 8-byte entry; four int8 taps of a
// 4-byte entry, lowest byte first.
__device__ __forceinline__ float4 bf_taps(unsigned a, unsigned b) {
  return make_float4(bf_lo(a), bf_hi(a), bf_lo(b), bf_hi(b));
}
//
// An int8 tap b is widened without a conversion: b + 128 (the byte's top
// bit flipped) placed by __byte_perm in the mantissa of 2^23 is the float
// 2^23 + 128 + b, from which one subtraction gives b exactly (a sign
// extension and an I2F, the quarter-rate conversion, ran 0.6-2.2 % slower
// at lanczos3, PERF.md §6).
__device__ __forceinline__ float4 i8_taps(unsigned w) {
  const unsigned v = w ^ 0x80808080u;
  constexpr float K = 8388736.f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650)) - K,
                     __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7651)) - K,
                     __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7652)) - K,
                     __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7653)) - K);
}

// The four half-precision cubic coefficients c0..c3 of an 8-byte H16 entry
// (words a = c0 | c1 << 16, b = c2 | c3 << 16), widened to float.
__device__ __forceinline__ float4 h16_coeffs(unsigned a, unsigned b) {
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&a));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&b));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// v rounded to bfloat16, half to even, as torch's conversion rounds (a NaN
// becomes the canonical one).
__device__ __forceinline__ float round_bf16(float v) {
  unsigned u = __float_as_uint(v);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return __uint_as_float(0x7FC00000u);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}
__device__ __forceinline__ float2 round_bf16(float2 v) {
  return make_float2(round_bf16(v.x), round_bf16(v.y));
}

template <typename A>
__device__ __forceinline__ A scaled(A v, float w) {
  if constexpr (sizeof(A) == sizeof(float)) {
    return v * w;
  } else {
    return make_float2(v.x * w, v.y * w);
  }
}

// Where a sampler finds tap base k in its trace's row: at unit k S, S the
// units of a term's entries (F of them with F frames; nearest: one sample
// each, the others one stencil entry each); E the units of one entry, the
// same for every entry type (a unit is a float, or a tap of Q's).
template <int METHOD, typename V>
struct Entry {
  static constexpr int C = sizeof(V) / sizeof(float);  // 1 real, 2 complex
  static constexpr int E = (METHOD == NEAREST ? 1 : METHOD == LINEAR ? 2 : 4) * C;
};

// Units of one entry of one frame, E.
int entry_floats(int method, int cplx) {
  return (cplx ? 2 : 1) * (method == NEAREST ? 1 : method == LINEAR ? 2 : 4);
}

// The offset o that sample() takes for the trace at unit `start` of xm:
// start - (bits of 2^23) S, wrapping.
template <int METHOD, typename V>
__device__ __forceinline__ unsigned row_origin(unsigned start,
                                               unsigned S = Entry<METHOD, V>::E) {
  return start - 0x4B000000u * S;
}

// The sample at ti, 0 <= ti <= T-1 (any ti in that range: the caller
// passes 0 for an invalid term and drops its value), of the trace whose
// row starts at unit o of xm, its tap bases S units apart. 2^23 + ti,
// rounded, holds the tap base in
// its low mantissa bits: rounded to nearest (half to even, as torch.round)
// for nearest, down (floor) for the others; subtracting 2^23 again is
// exact, and so is the fraction u. The bits of 2^23 are subtracted from
// the entry's offset in unsigned (wrapping) arithmetic as part of o (see
// row_origin), so the offset costs one shift-add. BF16, I8 and H16
// entries: see lp_sample.
template <int METHOD, typename V, int Q = F32>
__device__ __forceinline__ V sample(const Unit<Q>* __restrict__ xm, unsigned o, float ti,
                                    unsigned S = Entry<METHOD, V>::E);

template <int METHOD, typename V, int Q>
__device__ __forceinline__ V lp_sample(const Unit<Q>* __restrict__ e, float ti, float r) {
  constexpr bool CPLX = Entry<METHOD, V>::C == 2;
  static_assert(Q == BF16 || (Q == I8 && (METHOD == CUBIC || METHOD == LANCZOS3))
                    || (Q == H16 && METHOD == CUBIC),
                "int8 entries hold four taps, H16 entries a cubic's coefficients");
  if constexpr (METHOD == NEAREST) {
    if constexpr (CPLX) {
      const unsigned w = __ldg(reinterpret_cast<const unsigned*>(e));
      return make_float2(bf_lo(w), bf_hi(w));
    } else {
      return bf_lo(__ldg(reinterpret_cast<const unsigned short*>(e)));
    }
  } else {
    const float u = __fsub_rn(ti, __fsub_rn(r, 0x1p23f));
    float c0, c1;
    if constexpr (METHOD == LINEAR) {
      // (x[k], x[k+1]): x[k] + u (x[k+1] - x[k])
      if constexpr (CPLX) {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(e));
        c0 = fmaf(u, bf_hi(q.x) - bf_lo(q.x), bf_lo(q.x));
        c1 = fmaf(u, bf_hi(q.y) - bf_lo(q.y), bf_lo(q.y));
      } else {
        const unsigned q = __ldg(reinterpret_cast<const unsigned*>(e));
        c0 = fmaf(u, bf_hi(q) - bf_lo(q), bf_lo(q));
      }
    } else if constexpr (Q == H16) {
      // the cubic's coefficients; complex: real, then imaginary
      if constexpr (CPLX) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(e));
        c0 = poly3(u, h16_coeffs(q.x, q.y));
        c1 = poly3(u, h16_coeffs(q.z, q.w));
      } else {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(e));
        c0 = poly3(u, h16_coeffs(q.x, q.y));
      }
    } else {
      // the four taps x[k-1..k+2] and the sampler's weights; complex: real
      // taps, then imaginary
      const float4 w = METHOD == CUBIC ? cubic_w(u) : lanczos_w(u);
      if constexpr (Q == BF16) {
        if constexpr (CPLX) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(e));
          c0 = dot4(w, bf_taps(q.x, q.y));
          c1 = dot4(w, bf_taps(q.z, q.w));
        } else {
          const uint2 q = __ldg(reinterpret_cast<const uint2*>(e));
          c0 = dot4(w, bf_taps(q.x, q.y));
        }
      } else {
        if constexpr (CPLX) {
          const uint2 q = __ldg(reinterpret_cast<const uint2*>(e));
          c0 = dot4(w, i8_taps(q.x));
          c1 = dot4(w, i8_taps(q.y));
        } else {
          c0 = dot4(w, i8_taps(__ldg(reinterpret_cast<const unsigned*>(e))));
        }
      }
    }
    if constexpr (CPLX) {
      return make_float2(c0, c1);
    } else {
      return c0;
    }
  }
}

template <int METHOD, typename V, int Q>
__device__ __forceinline__ V sample(const Unit<Q>* __restrict__ xm, unsigned o, float ti,
                                    unsigned S) {
  using L = Entry<METHOD, V>;
  constexpr bool CPLX = L::C == 2;
  const float r = METHOD == NEAREST ? __fadd_rn(ti, 0x1p23f) : __fadd_rd(ti, 0x1p23f);
  const Unit<Q>* __restrict__ e = xm + (o + (unsigned)__float_as_int(r) * S);
  if constexpr (Q == BF16 || Q == I8 || Q == H16) {
    return lp_sample<METHOD, V, Q>(e, ti, r);
  } else if constexpr (METHOD == NEAREST) {
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

// sin and cos of a phase x, |x| <= PHASE_MAX, with no branch and no stack
// frame: k = rint(x 2 / pi) by the add of 1.5 2^23, whose low bits give
// the quadrant k mod 4 (|k| < 2^22); r = x - k pi / 2 in two FMAs, a
// Cody-Waite split of pi / 2 (the first product and difference exact, the
// second's rounding 2^-25 at most); then sin and cos of r in [-pi/4, pi/4]
// and the quadrant's swap and signs: the special function unit's
// (__sincosf: 2^-21.41 at most on [-pi, pi]); the card measured 3.68e-7
// (2^-21.37) against float64 over 2^22 phases in |x| <= 2^20
// (tools/k1b_torch.py). das_sincos_probe runs it for
// tests/test_torch_cuda.py and chip_smoke.py, which hold it within 2^-21.
__device__ __forceinline__ void sincos_reduced(float x, float* sn, float* cs) {
  const float t = fmaf(x, 0.636619772367581343f, 12582912.f);
  const float k = __fsub_rn(t, 12582912.f);
  const unsigned q = __float_as_uint(t);
  float r = fmaf(-k, 1.57079637050628662109375f, x);
  r = fmaf(-k, -4.37113882867379300296306610107421875e-8f, r);
  float s, c;
  __sincosf(r, &s, &c);
  const float a = (q & 1u) ? c : s, b = (q & 1u) ? s : c;
  *sn = __uint_as_float(__float_as_uint(a) ^ ((q & 2u) << 30));
  *cs = __uint_as_float(__float_as_uint(b) ^ (((q + 1u) & 2u) << 30));
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

// The dequantization scale of transmit m of the launch: s_m / 127 for I8
// and H16 entries, else 1 (unused).
template <int Q, class A>
__device__ __forceinline__ float qscale(const A& a, int m) {
  if constexpr (per_tx_scale(Q)) {
    return __ldg(a.lp.qs + m);
  } else {
    return 1.f;
  }
}

// A transmit's factor w of the keep kernel, I8 and H16: times s_m / 127.
template <int Q, class A>
__device__ __forceinline__ float tx_factor(const A& a, float w, int m) {
  if constexpr (per_tx_scale(Q)) {
    return w * qscale<Q>(a, m);
  } else {
    return w;
  }
}

// __launch_bounds__(P, 1): with no minimum of blocks per SM given, ptxas
// held the variants to 48 registers (5 blocks per SM) and spilled, and K2
// linear took 124 ms at the headline against 67 ms with the registers it
// needs (PERF.md §5). This kernel: one frame, no remodulation (K1(a),
// K2(a)).
template <int SRC, int METHOD, typename V, int Q = F32>
__global__ void __launch_bounds__(P, 1) das_kernel(const QArgs<Q, Args> a) {
  __shared__ __align__(16) float R[P * RS];  // R[p][n]
  __shared__ float TX[MC * P];  // TX[j][p], each thread's own column: no barrier
  const Unit<Q>* __restrict__ x = reinterpret_cast<const Unit<Q>*>(a.x);
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
        [[maybe_unused]] const float sc = qscale<Q>(a, m0 + j);  // I8, H16: s_m / 127
        [[maybe_unused]] V part{};  // I8, H16: this transmit's sum over the chunk's receivers
        const Unit<Q>* __restrict__ xm = opaque(x + ((int64_t)(m0 + j) * a.N + n0) * a.row);
        // one term: the receiver whose trace starts at unit o of xm (as
        // row_origin gives it), r its entry of R
        auto term = [&](float r, unsigned o) {
          const float ti = SRC == LUT
              ? __fmul_rn(__fsub_rn(__fadd_rn(tx, r), t0m), a.fs)
              : __fmul_rn(__fsub_rn(__fmul_rn(a.cinv, __fadd_rn(tx, r)), t0m), a.fs);
          const bool ok = ti >= 0.f && ti <= tmax;  // false for NaN
          const V v = sample<METHOD, V, Q>(xm, o, ok ? ti : 0.f);
          if constexpr (per_tx_scale(Q)) {  // discarded for F32: its lambda captures no part
            if (ok) part = part + v;
          } else {
            if (ok) acc = acc + v;
          }
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
        if constexpr (per_tx_scale(Q)) acc = acc + scaled(part, sc);  // s_m / 127 once a chunk
      }
    }
  }
  if (live) static_cast<V*>(a.out)[i] = acc;
}

// K1(b), K2(b): das_kernel's loops with NF frames' sums per thread (1 with
// fmod and one frame, else the launch's block, FRAMES_A_LAUNCH), each
// term's samples rotated by exp(2 pi i fmod tau) when ROT (Rot: by
// sincos_reduced or sincosf). A (float2 with ROT or complex traces, else
// float) is the sums' type.
template <int SRC, int METHOD, typename V, int ROT, int NF, int Q = F32>
__global__ void __launch_bounds__(P, ROT == NO_ROT ? 1 : FRAMES_MIN_BLOCKS)
    das_frames_kernel(const QArgs<Q, FrameArgs> fa) {
  using A = decltype(rotate<ROT != NO_ROT, V>(V{}, 1.f, 0.f));
  const Args& a = fa.a;
  constexpr int E = Entry<METHOD, V>::E;
  __shared__ __align__(16) float R[P * RS];  // R[p][n]
  __shared__ float TX[MC * P];  // TX[j][p], each thread's own column: no barrier
  const Unit<Q>* __restrict__ x = reinterpret_cast<const Unit<Q>*>(a.x);
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
  // units between tap bases: a term's F entries (E with one frame)
  const unsigned S = (unsigned)fa.S;
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
        [[maybe_unused]] const float sc = qscale<Q>(fa, m0 + j);  // I8, H16: s_m / 127
        [[maybe_unused]] A part[NF] = {};  // I8, H16: the transmit's sums over the chunk
        const Unit<Q>* __restrict__ xm = opaque(x + ((int64_t)(m0 + j) * a.N + n0) * a.row);
        // one term: the receiver whose trace starts at unit o of xm (as
        // row_origin gives it), r its entry of R
        auto term = [&](float r, unsigned o) {
          const float tau = SRC == LUT
              ? __fsub_rn(__fadd_rn(tx, r), t0m)
              : __fsub_rn(__fmul_rn(a.cinv, __fadd_rn(tx, r)), t0m);
          const float ti = __fmul_rn(tau, a.fs);
          const bool ok = ti >= 0.f && ti <= tmax;  // false for NaN
          float sn = 0.f, cs = 1.f;
          if constexpr (ROT == ROT_REDUCED)
            sincos_reduced(ok ? __fmul_rn(fa.w, tau) : 0.f, &sn, &cs);
          if constexpr (ROT == ROT_SINCOSF) sincosf(ok ? __fmul_rn(fa.w, tau) : 0.f, &sn, &cs);
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            // frame f's entries lie f E units on. Frame 0 always runs (fb
            // >= 1), so the later frames' tap base, fraction, weights and
            // address come from its sample as common subexpressions.
            if (f == 0 || f < fb) {
              const A v = rotate<ROT != NO_ROT>(
                  sample<METHOD, V, Q>(xm + f * E, o, ok ? ti : 0.f, S), cs, sn);
              if constexpr (per_tx_scale(Q)) {
                if (ok) part[f] = part[f] + v;
              } else {
                if (ok) acc[f] = acc[f] + v;
              }
            }
          }
        };
        unsigned o = row_origin<METHOD, V>(0u, S);
        int n = 0;
        constexpr int U = ROT == NO_ROT ? UNROLL : FRAMES_UNROLL;
#pragma unroll U
        for (; n + 4 <= nc; n += 4, o += 4 * row) {
          const float4 r = r4[n >> 2];
          term(r.x, o);
          term(r.y, o + row);
          term(r.z, o + 2 * row);
          term(r.w, o + 3 * row);
        }
        for (; n < nc; ++n, o += row) term(R[p * RS + n], o);
        if constexpr (per_tx_scale(Q)) {  // s_m / 127 once a chunk
#pragma unroll
          for (int f = 0; f < NF; ++f) acc[f] = acc[f] + scaled(part[f], sc);
        }
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
// apodization weights (this file built with DAS_KEEP defined: das_keep.cu,
// with the short rotation das_keep_iq.cu and with sincosf
// das_keep_iq_wide.cu, and the reduced-precision units).
//
// Keep modes (the TPU kernel's, das_pallas.py:940-1060): summed (I, 1, 1,
// F); KEEP_RX (I, N, 1, F): a (pixel, receiver) sum is complete once its
// transmits are done; KEEP_TX (I, 1, M, F): a (pixel, transmit) sum is
// complete at the end of each receiver chunk, added to out once per chunk
// by the one thread that owns it (no atomics: two launches give the same
// bits); KEEP_BOTH (I, N, M, F): one store per term. out is (N', M', F,
// I), pixels innermost, so a warp's stores are coalesced; the wrapper
// permutes the view. A launch takes one frame (KEEP_FRAMES).
//
// Weights (das_pallas.py:102-155, on unscaled geometry; the TPU kernel
// folds cinv into its positions and scales Dmax, xlo, xhi and lat_tx with
// it). The fused kinds but tx_multiline are masks, 0 or 1: a receiver
// whose receive mask is 0 gets NaN for its entry of R, a transmit whose
// transmit mask is 0 NaN for its entry of TX, so that its terms fail the
// validity test as a term off the trace does (the plain version's product
// with 0). Real-valued factors, dense weights and tx_multiline, take a
// receive factor evaluated once per (pixel, receiver) beside R into WR
// and a transmit factor once per (pixel, transmit) beside TX into WT; a
// dense weight that varies over both is read per term with its strides (0
// on a broadcast axis). A term whose weight is 0 reads no sample.
//
// What bounds it, and what the design does (PERF.md §6): an earlier
// design took the keep mode and the weights as runtime flags, so every
// term formed a weight, tested it, scaled its sample and branched on the
// mode, and kept keep_rx's sums in shared memory (a load, an add and a
// store a term, 64 KiB a block); with one group of 4 terms in flight a
// thread, latency set its time, 1.7-2.7x the summed kernel's. Here the keep
// mode (KEEP) and whether the launch has real-valued weights (W) are
// template parameters: an unweighted term (masks only) is das_kernel's
// term, a weighted one adds only its product with w. keep_rx runs its
// receivers in sub-chunks of keep_nck, fully unrolled, so their sums stay
// in registers under constant indices; each is read (add) and stored once
// per sub-chunk and launch, and keeps the order of its additions over the
// transmits (an unrotated float32 keep_rx gives the earlier design's
// bits).
// keep_tx issues its read of out before the transmit's terms, so the load
// is in flight with them (20 % at the headline). Remodulation takes
// das_frames_kernel's short rotation (sincos_reduced), and sincosf past
// PHASE_MAX. The variants: KEEP_ANY reads the mode from the launch
// (summed, keep_tx, keep_both), weights as runtime flags, for the modes
// without a variant of their own; keep_rx with and without weights in
// every unit (sincosf: with); and, in the float32 units without sincosf,
// the unweighted summed and keep_tx calls.
enum Keep { SUM = 0, KEEP_RX = 1, KEEP_TX = 2, KEEP_BOTH = 3, KEEP_ANY = 4 };
enum RxKind { AP_GROWTH = 1, AP_DMAX = 2, ACCEPT = 4 };
enum TxKind { TX_SCANLINE = 1, TX_MULTILINE = 2, TX_PARALLELOGRAM = 4 };
// The plan, from the sweeps of PERF.md §6: the frames a launch (4
// in one launch ran 1.15x slower than 4 one-frame launches for keep_tx, 2
// a launch 1.5x); unweighted keep_rx's sub-chunk and least blocks an SM
// (__launch_bounds__), KEEP_NCK and KEEP_RX_MIN_BLOCKS for real sums (in
// registers), KEEP_NCK_WIDE and KEEP_RX_MIN_BLOCKS_WIDE for complex ones
// (complex traces or a rotation; in shared memory: 176 against 223 ms in
// registers at one IQ frame, both at 2 blocks an SM, and 137 against 108
// for real sums); KEEP_MIN_BLOCKS and KEEP_MIN_BLOCKS_WIDE for the unweighted
// summed and keep_tx variants of real and complex sums; ptxas's registers
// for the weighted ones (capped, they spilled), whose keep_rx takes
// KEEP_NCK_WIDE receivers in registers, and for lanczos3 on complex sums
// (its weights spilled at 3 blocks); and the unroll of the receiver
// loop outside keep_rx (groups of 4 receivers), KEEP_UNROLL for real sums
// and KEEP_UNROLL_WIDE for complex ones.
constexpr int KEEP_FRAMES = 1;
constexpr int KEEP_NCK = 16;
constexpr int KEEP_RX_MIN_BLOCKS = 1;
constexpr int KEEP_NCK_WIDE = 8;
constexpr int KEEP_RX_MIN_BLOCKS_WIDE = 3;
constexpr int KEEP_MIN_BLOCKS = 4;
constexpr int KEEP_MIN_BLOCKS_WIDE = 3;
constexpr int KEEP_UNROLL = 2;
constexpr int KEEP_UNROLL_WIDE = 1;
static_assert(NC % KEEP_NCK == 0 && NC % KEEP_NCK_WIDE == 0 && KEEP_NCK % 4 == 0
              && KEEP_NCK_WIDE % 4 == 0, "a chunk holds whole sub-chunks of whole groups of 4");

__host__ __device__ constexpr int keep_nck(bool wide, bool w) {
  return wide || w ? KEEP_NCK_WIDE : KEEP_NCK;
}
__host__ __device__ constexpr int keep_min_blocks(int keep, bool wide, bool w, bool lanczos) {
  return w || keep == KEEP_ANY || (wide && lanczos) ? 1
         : keep != KEEP_RX     ? (wide ? KEEP_MIN_BLOCKS_WIDE : KEEP_MIN_BLOCKS)
         : wide                ? KEEP_RX_MIN_BLOCKS_WIDE
                               : KEEP_RX_MIN_BLOCKS;
}

// A dense weight broadcastable to (I1, I2, I3, N, M): its element strides,
// 0 on a broadcast axis; p null when the launch has none.
struct Dense {
  const float* p;
  int64_t s1, s2, s3, sn, sm;
};

struct KeepArgs {
  FrameArgs fa;        // a.out at the launch's frame and first transmit
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

// The launch has real-valued weights: a factor per term beyond the masks.
bool has_weights(const KeepArgs& k) {
  return k.wr.p || k.wt.p || k.wd.p || (k.tx_kinds & TX_MULTILINE);
}

// The fused receive factor of receiver n for a pixel at (dx, dz) from it,
// dr = |pixel - receiver|, in the order and roundings of
// ops/das_cuda.py::fused_weights: 0 or 1 (aperture growth, Dmax, the
// acceptance angle are masks).
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

// The fused transmit mask of transmit m (of the launch) for a pixel at
// (px, pz) with lateral coordinate lat: tx_scanline and tx_parallelogram,
// 0 or 1.
__device__ __forceinline__ bool tx_mask(const KeepArgs& k, int m, float px, float pz,
                                        float lat) {
  if ((k.tx_kinds & TX_SCANLINE) && !(fabsf(__fsub_rn(lat, __ldg(k.lat_tx + m))) < k.tol))
    return false;
  if (k.tx_kinds & TX_PARALLELOGRAM) {
    const float* nvm = k.fa.a.nv + 3 * m;
    const float x0 = __fsub_rn(px, __fmul_rn(__ldg(nvm), __fdiv_rn(pz, __ldg(nvm + 2))));
    if (!(x0 > k.xlo && x0 <= k.xhi)) return false;
  }
  return true;
}

// The tx_multiline factor of transmit m, max(0, 1 - |lat - lat_tx| / dlat).
__device__ __forceinline__ float tx_multiline(const KeepArgs& k, int m, float lat) {
  const float dl = fabsf(__fsub_rn(lat, __ldg(k.lat_tx + m)));
  return fmaxf(0.f, __fsub_rn(1.f, __fdiv_rn(dl, k.dlat)));
}

// Entry types other than F32 (its reduced-precision units): I8 and H16 fold each
// transmit's s_m / 127 into its transmit factor; with lp.acc16 out holds
// the kept sums as bfloat16 (a pair for a complex sum), half the bytes of
// float32, as the TPU kernel's QUPS_DAS_ACC16 keeps its kept-axis
// accumulator in bfloat16: every store of a kept sum (keep_rx at the end of
// a sub-chunk's transmits, keep_tx at the end of each receiver chunk, both
// per term) rounds it half to even, and a sum read back (keep_rx after the
// launch's first chunk of transmits, keep_tx after its first receiver
// chunk) is widened. acc16 is a launch constant, tested at the loads and
// stores of out only.
template <int Q, class K, typename A>
__device__ __forceinline__ A kept_load(const K& k, const A* out, int64_t e) {
  if constexpr (Q != F32) {
    if (k.lp.acc16) {
      if constexpr (sizeof(A) == sizeof(float)) {
        return bf_lo(reinterpret_cast<const uint16_t*>(out)[e]);
      } else {
        const unsigned w = reinterpret_cast<const unsigned*>(out)[e];
        return make_float2(bf_lo(w), bf_hi(w));
      }
    }
  }
  return out[e];
}

template <int Q, class K, typename A>
__device__ __forceinline__ void kept_store(const K& k, A* out, int64_t e, A v) {
  if constexpr (Q != F32) {
    if (k.lp.acc16) {
      if constexpr (sizeof(A) == sizeof(float)) {
        reinterpret_cast<uint16_t*>(out)[e] = (uint16_t)(__float_as_uint(round_bf16(v)) >> 16);
      } else {
        const float2 r = round_bf16(v);
        reinterpret_cast<unsigned*>(out)[e] =
            __float_as_uint(r.x) >> 16 | (__float_as_uint(r.y) & 0xFFFF0000u);
      }
      return;
    }
  }
  out[e] = v;
}

// Shared memory: R and TX as das_frames_kernel's, WR (P x RS) and WT (MC x
// P) when the launch has real-valued receive or transmit factors; sized by
// the launcher (keep_smem). KEEP: the mode, or KEEP_ANY (the launch's:
// summed, keep_tx, keep_both); W: the launch may have real-valued weights
// (runtime flags), else it has masks at most.
//
// Outside keep_rx the receivers of a chunk run 4 at a time, in three
// steps: the 4 terms' delays, weights and phases; their samples, whose
// loads are then in flight together; then their sums by the keep mode.
// With the mode's branch after each term instead, a term's load waited for
// the last term's sum (PERF.md §6).
template <int SRC, int METHOD, typename V, int ROT, int KEEP, bool W, int Q = F32>
__global__ void __launch_bounds__(
    P, keep_min_blocks(KEEP, sizeof(V) != sizeof(float) || ROT != NO_ROT, W, METHOD == LANCZOS3))
    das_keep_kernel(const QArgs<Q, KeepArgs> k) {
  using A = decltype(rotate<ROT != NO_ROT, V>(V{}, 1.f, 0.f));
  constexpr bool SCALED = W || per_tx_scale(Q);  // a term's sample times its factor w
  const Args& a = k.fa.a;
  extern __shared__ __align__(16) float smem[];
  const bool has_wr = W && k.wr.p, has_wt = W && (k.wt.p || (k.tx_kinds & TX_MULTILINE));
  float* R = smem;                                   // R[p][n]
  float* TX = R + P * RS;                            // TX[j][p]
  float* WR = TX + MC * P;                           // WR[p][n]
  float* WT = WR + (has_wr ? P * RS : 0);            // WT[j][p]
  const Unit<Q>* __restrict__ x = reinterpret_cast<const Unit<Q>*>(a.x);
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
  // the pixel's (i1, i2, i3), its offset in each dense weight, its lateral
  const int64_t i3 = ic % k.I3, i2 = (ic / k.I3) % k.I2, i1 = ic / ((int64_t)k.I3 * k.I2);
  const int64_t owr = i1 * k.wr.s1 + i2 * k.wr.s2 + i3 * k.wr.s3;
  const int64_t owt = i1 * k.wt.s1 + i2 * k.wt.s2 + i3 * k.wt.s3;
  const int64_t owd = i1 * k.wd.s1 + i2 * k.wd.s2 + i3 * k.wd.s3;
  const float lat = (k.tx_kinds & (TX_SCANLINE | TX_MULTILINE)) ? __ldg(k.lat + ic) : 0.f;
  const float tmax = (float)(a.T - 1);
  const unsigned row = (unsigned)a.row;
  const unsigned S = (unsigned)k.fa.S;
  const int keep = KEEP == KEEP_ANY ? k.keep : KEEP;
  const float4* __restrict__ r4 = reinterpret_cast<const float4*>(R + p * RS);
  const float4* __restrict__ w4 = reinterpret_cast<const float4*>(WR + p * RS);
  A acc{};  // summed: the pixel's sum; keep_tx: a transmit's over a receiver chunk
  if (keep == SUM && a.add && live) acc = out[i];
  for (int n0 = 0; n0 < a.N; n0 += NC) {
    const int nc = min(NC, a.N - n0);
    __syncthreads();  // the previous chunk's reads of R are done
    if constexpr (SRC == LUT) {
      const int lane = p & 31, rows = a.I - i0 < P ? (int)(a.I - i0) : P;
      for (int q = p >> 5; q < rows; q += P / 32)
        for (int n = lane; n < nc; n += 32)
          R[q * RS + n] = __ldg(a.taur + (i0 + q) * a.N + n0 + n);
    } else {
      // dr, or NaN where the receive mask (the fused kinds) is 0
      for (int n = 0; n < nc; ++n) {
        const float* prn = a.pr + 3 * (n0 + n);
        const float dx = __fsub_rn(px, __ldg(prn)), dz = __fsub_rn(pz, __ldg(prn + 2));
        const float dr = norm3(dx, __fsub_rn(py, __ldg(prn + 1)), dz);
        R[p * RS + n] = k.rx_kinds && rx_weight(k, n0 + n, dx, dz, dr) == 0.f ? __int_as_float(
            0x7FC00000) : dr;
      }
    }
    if (has_wr) {  // the dense receive factors of this thread's pixel: its own row
      for (int n = 0; n < nc; ++n)
        WR[p * RS + n] = __ldg(k.wr.p + owr + (int64_t)(n0 + n) * k.wr.sn);
    }
    __syncthreads();
    if (!live) continue;
    // Each transmit m of the launch, in chunks of MC whose terms are formed
    // at once (K2's loads in flight together): body(m, tx, t0m, wtj, xm,
    // wdm), with tx its transmit term (NaN where its mask is 0), wtj its
    // factor (the weight, I8 and H16 times s_m / 127), xm its traces at receiver n0
    // and wdm the dense (i, n, m) weight at (i, n0, m), or null.
    auto transmits = [&](auto&& body) {
      for (int m0 = 0; m0 < a.M; m0 += MC) {
        const int mc = min(MC, a.M - m0);
#pragma unroll
        for (int j = 0; j < MC; ++j) {
          if (j < mc) {
            float tx = tx_term<SRC>(a, m0 + j, i, px, py, pz);
            if constexpr (SRC != LUT) {
              if ((k.tx_kinds & (TX_SCANLINE | TX_PARALLELOGRAM))
                  && !tx_mask(k, m0 + j, px, pz, lat))
                tx = __int_as_float(0x7FC00000);
            }
            TX[j * P + p] = tx;
            if (has_wt) {
              float w = (k.tx_kinds & TX_MULTILINE) ? tx_multiline(k, m0 + j, lat) : 1.f;
              if (k.wt.p) w *= __ldg(k.wt.p + owt + (int64_t)(m0 + j) * k.wt.sm);
              WT[j * P + p] = w;
            }
          }
        }
        for (int j = 0; j < mc; ++j) {
          const int m = m0 + j;
          const float wtj = tx_factor<Q>(k, has_wt ? WT[j * P + p] : 1.f, m);
          const float* wdm = W && k.wd.p
              ? k.wd.p + owd + (int64_t)m * k.wd.sm + (int64_t)n0 * k.wd.sn : nullptr;
          body(m, TX[j * P + p], __ldg(a.t0 + m), wtj,
               opaque(x + ((int64_t)m * a.N + n0) * a.row), wdm);
        }
      }
    };
    // a term's delay ti, factor w (wtj times its receive and dense factors;
    // wtj alone without weights), validity and phase (c, s), from r its
    // entry of R
    auto prep = [&](float tx, float t0m, float wtj, float r, float wrn, float wdn, float& ti,
                    float& w, bool& ok, float& c, float& s) {
      const float tau = SRC == LUT
          ? __fsub_rn(__fadd_rn(tx, r), t0m)
          : __fsub_rn(__fmul_rn(a.cinv, __fadd_rn(tx, r)), t0m);
      ti = __fmul_rn(tau, a.fs);
      ok = ti >= 0.f && ti <= tmax;  // false for NaN
      w = wtj;
      if constexpr (W) {
        w = wrn * wtj * wdn;
        ok = ok && w != 0.f;
      }
      s = 0.f;
      c = 1.f;
      if constexpr (ROT == ROT_REDUCED)
        sincos_reduced(ok ? __fmul_rn(k.fa.w, tau) : 0.f, &s, &c);
      if constexpr (ROT == ROT_SINCOSF) sincosf(ok ? __fmul_rn(k.fa.w, tau) : 0.f, &s, &c);
    };
    // its sample at unit o of xm, rotated and weighted
    auto fetch = [&](const Unit<Q>* xm, float ti, float w, bool ok, float c, float s,
                     unsigned o) {
      const A v = rotate<ROT != NO_ROT>(sample<METHOD, V, Q>(xm, o, ok ? ti : 0.f, S), c, s);
      if constexpr (SCALED) {
        return scaled(v, w);
      } else {
        return v;
      }
    };
    if constexpr (KEEP == KEEP_RX) {
      // keep_rx: sub-chunks of NCK receivers, each over every transmit with
      // its sums kr(q) in registers (kreg) or, unweighted complex ones, in
      // shared memory after the tables, a column a thread (ksh); a receiver
      // past the chunk (q >= rem) reads receiver nb's traces at base 0 and
      // drops the value
      constexpr bool WIDE = sizeof(A) != sizeof(float), SHARED = WIDE && !W;
      constexpr int NCK = keep_nck(WIDE, W);
      A kreg[SHARED ? 1 : NCK];
      A* const ksh = reinterpret_cast<A*>(WT + (has_wt ? MC * P : 0)) + p;
      auto kr = [&](int q) -> A& {
        if constexpr (SHARED) {
          return ksh[q * P];
        } else {
          return kreg[q];
        }
      };
      for (int nb = 0; nb < nc; nb += NCK) {
        const int rem = nc - nb;
        const int64_t on0 = i + (int64_t)(n0 + nb) * k.on;  // receiver n0 + nb's sum in out
#pragma unroll
        for (int q = 0; q < NCK; ++q)
          kr(q) = a.add && q < rem ? kept_load<Q>(k, out, on0 + q * k.on) : A{};
        transmits([&](int, float tx, float t0m, float wtj, const Unit<Q>* xm, const float* wdm) {
          const unsigned ob = row_origin<METHOD, V>(0u, S) + (unsigned)nb * row;
#pragma unroll
          for (int g = 0; g < NCK / 4; ++g) {
            const float4 r = r4[(nb >> 2) + g];
            float4 wr = make_float4(1.f, 1.f, 1.f, 1.f);
            if constexpr (W) {
              if (has_wr) wr = w4[(nb >> 2) + g];
            }
            const float rq[4] = {r.x, r.y, r.z, r.w}, wrq[4] = {wr.x, wr.y, wr.z, wr.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = 4 * g + e;
              const float wdn = wdm ? __ldg(wdm + (int64_t)(nb + (q < rem ? q : 0)) * k.wd.sn)
                                    : 1.f;
              float ti, w, c, s;
              bool ok;
              prep(tx, t0m, wtj, rq[e], wrq[e], wdn, ti, w, ok, c, s);
              ok = ok && q < rem;
              const A v = fetch(xm, ti, w, ok, c, s, q < rem ? ob + (unsigned)q * row : ob);
              if (ok) kr(q) = kr(q) + v;
            }
          }
        });
#pragma unroll
        for (int q = 0; q < NCK; ++q)
          if (q < rem) kept_store<Q>(k, out, on0 + q * k.on, kr(q));
      }
    } else {
      transmits([&](int m, float tx, float t0m, float wtj, const Unit<Q>* xm, const float* wdm) {
        // keep_tx: the stored part of the (pixel, transmit) sum, read
        // before the terms so that the load is in flight with them
        A prev{};
        if (keep == KEEP_TX) {
          acc = A{};
          if (n0 > 0) prev = kept_load<Q>(k, out, i + m * k.om);
        }
        // its sum, receiver n0 + n, by the keep mode
        auto put = [&](A v, bool ok, int n) {
          if (keep == KEEP_BOTH) {
            kept_store<Q>(k, out, i + (n0 + n) * k.on + m * k.om, ok ? v : A{});
          } else if (ok) {
            acc = acc + v;
          }
        };
        unsigned o = row_origin<METHOD, V>(0u, S);
        int n = 0;
        constexpr int U = sizeof(A) != sizeof(float) ? KEEP_UNROLL_WIDE : KEEP_UNROLL;
#pragma unroll U
        for (; n + 4 <= nc; n += 4, o += 4 * row) {
          const float4 r = r4[n >> 2];
          float4 wr = make_float4(1.f, 1.f, 1.f, 1.f), wd = wr;
          if constexpr (W) {
            if (has_wr) wr = w4[n >> 2];
            if (wdm)
              wd = make_float4(__ldg(wdm + n * k.wd.sn), __ldg(wdm + (n + 1) * k.wd.sn),
                               __ldg(wdm + (n + 2) * k.wd.sn), __ldg(wdm + (n + 3) * k.wd.sn));
          }
          float ti0, ti1, ti2, ti3, w0, w1, w2, w3, c0, c1, c2, c3, s0, s1, s2, s3;
          bool k0, k1, k2, k3;
          prep(tx, t0m, wtj, r.x, wr.x, wd.x, ti0, w0, k0, c0, s0);
          prep(tx, t0m, wtj, r.y, wr.y, wd.y, ti1, w1, k1, c1, s1);
          prep(tx, t0m, wtj, r.z, wr.z, wd.z, ti2, w2, k2, c2, s2);
          prep(tx, t0m, wtj, r.w, wr.w, wd.w, ti3, w3, k3, c3, s3);
          const A v0 = fetch(xm, ti0, w0, k0, c0, s0, o);
          const A v1 = fetch(xm, ti1, w1, k1, c1, s1, o + row);
          const A v2 = fetch(xm, ti2, w2, k2, c2, s2, o + 2 * row);
          const A v3 = fetch(xm, ti3, w3, k3, c3, s3, o + 3 * row);
          put(v0, k0, n);
          put(v1, k1, n + 1);
          put(v2, k2, n + 2);
          put(v3, k3, n + 3);
        }
        for (; n < nc; ++n, o += row) {
          float ti, w, c, s;
          bool ok;
          prep(tx, t0m, wtj, R[p * RS + n], has_wr ? WR[p * RS + n] : 1.f,
               wdm ? __ldg(wdm + n * k.wd.sn) : 1.f, ti, w, ok, c, s);
          put(fetch(xm, ti, w, ok, c, s, o), ok, n);
        }
        if (keep == KEEP_TX)  // this chunk's part of the (pixel, transmit) sum
          kept_store<Q>(k, out, i + m * k.om, n0 == 0 ? acc : prev + acc);
      });
    }
  }
  if (keep == SUM && live) out[i] = acc;
}

// Bytes of das_keep_kernel's shared memory for a launch, its sums complex
// (wide) or real.
size_t keep_smem(const KeepArgs& k, bool wide) {
  const bool has_wr = k.wr.p, has_wt = k.wt.p || (k.tx_kinds & TX_MULTILINE);
  const bool sums = k.keep == KEEP_RX && wide && !has_weights(k);  // keep_rx's, shared
  return ((size_t)P * RS + MC * P + (has_wr ? P * RS : 0) + (has_wt ? MC * P : 0)) * 4
         + (sums ? (size_t)keep_nck(wide, false) * P * (wide ? 8 : 4) : 0);
}

// The launch's variant (see the head of this block): keep_rx its own, with
// or without weights (sincosf: with); the unweighted summed and keep_tx
// calls their own in the float32 units without sincosf; KEEP_ANY, the
// mode from the arguments, for the rest.
template <int SRC, int METHOD, typename V, int ROT, int Q>
cudaError_t run_keep(const QArgs<Q, KeepArgs>& k, size_t smem, cudaStream_t s) {
  using Kernel = void (*)(const QArgs<Q, KeepArgs>);
  const bool weighted = has_weights(k);
  Kernel kernel = das_keep_kernel<SRC, METHOD, V, ROT, KEEP_ANY, true, Q>;
  if (k.keep == KEEP_RX) {
    kernel = das_keep_kernel<SRC, METHOD, V, ROT, KEEP_RX, true, Q>;
    if constexpr (ROT != ROT_SINCOSF) {
      if (!weighted) kernel = das_keep_kernel<SRC, METHOD, V, ROT, KEEP_RX, false, Q>;
    }
  } else if constexpr (Q == F32 && ROT != ROT_SINCOSF) {
    if (!weighted && k.keep == KEEP_TX)
      kernel = das_keep_kernel<SRC, METHOD, V, ROT, KEEP_TX, false, Q>;
    else if (!weighted && k.keep == SUM)
      kernel = das_keep_kernel<SRC, METHOD, V, ROT, SUM, false, Q>;
  }
  const unsigned blocks = (unsigned)((k.fa.a.I + P - 1) / P);
  if (smem > (48 << 10)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, P, smem, s>>>(k);
  return cudaGetLastError();
}

template <int SRC, typename V, int ROT, int Q>
cudaError_t keep_by_method(int method, const QArgs<Q, KeepArgs>& k, size_t smem,
                           cudaStream_t s) {
  constexpr bool CPLX = sizeof(V) != sizeof(float);
  switch (method) {
    case NEAREST:
      if constexpr (reads(Q, NEAREST, CPLX, true))
        return run_keep<SRC, NEAREST, V, ROT, Q>(k, smem, s);
      break;
    case LINEAR:
      if constexpr (reads(Q, LINEAR, CPLX, true))
        return run_keep<SRC, LINEAR, V, ROT, Q>(k, smem, s);
      break;
    case CUBIC:
      if constexpr (reads(Q, CUBIC, CPLX, true))
        return run_keep<SRC, CUBIC, V, ROT, Q>(k, smem, s);
      break;
    case LANCZOS3:
      if constexpr (reads(Q, LANCZOS3, CPLX, true))
        return run_keep<SRC, LANCZOS3, V, ROT, Q>(k, smem, s);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename V, int ROT, int Q>
cudaError_t keep_by_src(int src, int method, const QArgs<Q, KeepArgs>& k, size_t smem,
                        cudaStream_t s) {
  switch (src) {
    case PLANE: return keep_by_method<PLANE, V, ROT, Q>(method, k, smem, s);
    case DIVERGING: return keep_by_method<DIVERGING, V, ROT, Q>(method, k, smem, s);
    case VIRTUAL: return keep_by_method<VIRTUAL, V, ROT, Q>(method, k, smem, s);
    case LUT: return keep_by_method<LUT, V, ROT, Q>(method, k, smem, s);
    default: return cudaErrorInvalidValue;
  }
}
#endif  // DAS_KEEP

// One frame in all (ldo 1) without a rotation, on a layout of one frame
// (S = E): das_kernel; with the short rotation the frames kernel's
// one-frame variant. Else the frames kernel's variant of NB frames a launch
// (ROT_SINCOSF, for phases past PHASE_MAX, has that variant alone, for
// every call).
template <int SRC, int METHOD, typename V, int ROT, int Q>
cudaError_t run(const QArgs<Q, FrameArgs>& fa, cudaStream_t s) {
  constexpr int NB = frames_a_launch(METHOD, Q, sizeof(V) != sizeof(float));
  const unsigned blocks = (unsigned)((fa.a.I + P - 1) / P);
  if constexpr (ROT == NO_ROT) {
    if (fa.ldo == 1 && fa.S == Entry<METHOD, V>::E) {
      if constexpr (Q == F32) {
        das_kernel<SRC, METHOD, V><<<blocks, P, 0, s>>>(fa.a);
      } else {
        das_kernel<SRC, METHOD, V, Q><<<blocks, P, 0, s>>>(WithLp<Args>{fa.a, fa.lp});
      }
      return cudaGetLastError();
    }
  } else if constexpr (ROT == ROT_REDUCED) {
    if (fa.ldo == 1) {
      das_frames_kernel<SRC, METHOD, V, ROT, 1, Q><<<blocks, P, 0, s>>>(fa);
      return cudaGetLastError();
    }
  }
  das_frames_kernel<SRC, METHOD, V, ROT, NB, Q><<<blocks, P, 0, s>>>(fa);
  return cudaGetLastError();
}

template <int SRC, typename V, int ROT, int Q>
cudaError_t by_method(int method, const QArgs<Q, FrameArgs>& a, cudaStream_t s) {
  constexpr bool CPLX = sizeof(V) != sizeof(float);
  switch (method) {
    case NEAREST:
      if constexpr (reads(Q, NEAREST, CPLX, false)) return run<SRC, NEAREST, V, ROT, Q>(a, s);
      break;
    case LINEAR:
      if constexpr (reads(Q, LINEAR, CPLX, false)) return run<SRC, LINEAR, V, ROT, Q>(a, s);
      break;
    case CUBIC:
      if constexpr (reads(Q, CUBIC, CPLX, false)) return run<SRC, CUBIC, V, ROT, Q>(a, s);
      break;
    case LANCZOS3:
      if constexpr (reads(Q, LANCZOS3, CPLX, false))
        return run<SRC, LANCZOS3, V, ROT, Q>(a, s);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename V, int ROT, int Q>
cudaError_t by_src(int src, int method, const QArgs<Q, FrameArgs>& a, cudaStream_t s) {
  switch (src) {
    case PLANE: return by_method<PLANE, V, ROT, Q>(method, a, s);
    case DIVERGING: return by_method<DIVERGING, V, ROT, Q>(method, a, s);
    case VIRTUAL: return by_method<VIRTUAL, V, ROT, Q>(method, a, s);
    case LUT: return by_method<LUT, V, ROT, Q>(method, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// True when every phase of a launch, |w tau| for 0 <= tau fs <= T - 1,
// lies within PHASE_MAX, with a margin for the roundings of tau and the
// phase; ops/das_cuda.py::reduced_rotation computes the same in float64.
bool reduced_range(float w, float fs, int T) {
  return fabs((double)w) * (double)(T - 1) / fabs((double)fs) * (1.0 + 0x1p-20)
         <= (double)PHASE_MAX;
}

// Frames f0 .. f0 + fb - 1 of out's F (fb at most the sampler's
// frames_a_launch), read from a layout that holds fl >= fb frames a tap
// base, x at the first of them (see "Frames" at the head of this file): out
// moves to frame f0; with F = 1 the one-frame variants run. ROT selects the
// rotation (Rot): the rotating variants' sums are complex, and ROT_REDUCED
// refuses a launch whose phases may pass PHASE_MAX. Q is the entry type of
// the layout at x, lp its arguments.
template <int ROT, int Q>
int launch(int src, int method, int cplx, Args a, int F, int f0, int fb, int fl, float w,
           Lp lp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.I <= 0) return (int)cudaSuccess;
  if (a.N <= 0 || a.M <= 0 || a.T <= 0 || a.T > TMAX || method < NEAREST || method > LANCZOS3
      || F < 1 || f0 < 0 || fb < 1 || fb > frames_a_launch(method, Q, cplx) || f0 + fb > F
      || fb > fl || (ROT == ROT_REDUCED && !reduced_range(w, a.fs, a.T)))
    return (int)cudaErrorInvalidValue;
  const int E = entry_floats(method, cplx);
  a.row = (int64_t)a.T * fl * E;
  if ((int64_t)NC * a.row >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  a.out = static_cast<char*>(a.out) + (int64_t)f0 * ((cplx || ROT) ? 8 : 4);
  const QArgs<Q, FrameArgs> fa = with_lp<Q>(FrameArgs{a, F, fl * E, fb, w}, lp);
  cudaStream_t s = (cudaStream_t)stream;
  err = cplx ? by_src<float2, ROT, Q>(src, method, fa, s)
             : by_src<float, ROT, Q>(src, method, fa, s);
  return (int)err;
}

// The layout kernel: traces x (T, N, ldm) of C floats (1 real, 2
// complex64), of which entries 0..M-1 of the last axis are laid out as the
// sampler METHOD reads them, out (M, N, T, C, E) units of entry type Q, E
// the units of one entry of one component. With frames (FR), x is (T, N,
// ldm / F, F) and entry q = m Fg + j is frame j of the Fg frames at x of
// transmit m, written in blocks of fb frames (the last block short where
// fb does not divide Fg): out is, block after block, (M / Fg, N, T, fbb,
// C, E) with fbb the block's frames, a term's frames of one block next to
// each other (see "Frames" at the head of this file). A block transposes
// tiles of LM entries q x LT entries k of one receiver through shared
// memory: coalesced reads along q, 2- to 16-byte writes along k. The grid's
// y and z (q tiles, receivers) hold at most 65535 blocks each, so a block
// walks them with the grid's stride: any number of receivers, transmits and
// frames. It replaces what the TPU path does in XLA before its kernel (the
// transpose and the packers _pack_pairs, _pack_quads of
// qups_tpu/ops/das_pallas.py:2015-2023 and :2628-2642) and computes exactly
// what ops/das_cuda.py::trace_layout_plain computes. The tile holds the
// traces; put_entry rounds an entry's taps as R says (round_tap: F32 as
// they are; BF16 to bfloat16 half away from zero, (bits + 0x8000) >> 16 as
// _pack_pairs, or with rne half to even; I8 rint(x * (127 / s)) clipped to
// +-127, 127 / s rounded to float32 as _pack_quads, s = qs[m]; rounding the
// tile's rows as they were loaded cost the bf16 taps' layout 1.2x, its
// loads no longer in flight together) and writes them as Q's entries: F32 the
// float32 stencil entries with the round-to-nearest intrinsics, in
// stencil_entry's order (of int8 taps: each coefficient times s / 127),
// BF16 and I8 the rounded taps' bits, H16 the cubic's coefficients of the
// int8 taps in half precision (exact).
constexpr int LT = 64;       // entries per layout block
constexpr int LM = 32;       // transmits (frames) per layout block
constexpr int LS = LT + 3;   // tile rows x[k0-1 .. k0+LT+1]; odd, so conflict-free

template <int R>
__device__ __forceinline__ float round_tap(float v, float inv, int rne) {
  if constexpr (R == BF16) {
    return rne ? round_bf16(v) : __uint_as_float((__float_as_uint(v) + 0x8000u) & 0xFFFF0000u);
  } else if constexpr (R == I8) {
    return fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  } else {
    return v;
  }
}

// The Catmull-Rom cubic's coefficients c0..c3 of the taps q[0..3], as
// stencil_entry forms them (exact for int8 taps: multiples of 1/2 below
// 2^10).
__device__ __forceinline__ float4 cubic_coeffs(const float* q) {
  return make_float4(
      q[1], __fmul_rn(0.5f, __fsub_rn(q[2], q[0])),
      __fadd_rn(__fsub_rn(q[0], __fmul_rn(2.5f, q[1])),
                __fsub_rn(__fmul_rn(2.f, q[2]), __fmul_rn(0.5f, q[3]))),
      __fadd_rn(__fmul_rn(1.5f, __fsub_rn(q[1], q[2])), __fmul_rn(0.5f, __fsub_rn(q[3], q[0]))));
}

template <int METHOD, int Q, int R>
__device__ __forceinline__ void put_entry(const float* x, Unit<Q>* __restrict__ dst, float inv,
                                          int rne, float dq) {
  // q[0..3] = x[k-1], x[k], x[k+1], x[k+2] (clamped), rounded as R says
  // (the samplers that read fewer taps round only those)
  float q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = round_tap<R>(x[j], inv, rne);
  if constexpr (Q == BF16) {
    auto h = [](float v) -> unsigned { return __float_as_uint(v) >> 16; };  // exact
    if constexpr (METHOD == NEAREST) {
      *dst = (uint16_t)h(q[1]);
    } else if constexpr (METHOD == LINEAR) {
      *reinterpret_cast<unsigned*>(dst) = h(q[1]) | h(q[2]) << 16;
    } else {
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(h(q[0]) | h(q[1]) << 16, h(q[2]) | h(q[3]) << 16);
    }
  } else if constexpr (Q == I8) {
    static_assert(METHOD == CUBIC || METHOD == LANCZOS3, "int8 entries hold four taps");
    auto b = [](float v) -> unsigned { return (unsigned)(int)v & 0xFFu; };
    *reinterpret_cast<unsigned*>(dst) = b(q[0]) | b(q[1]) << 8 | b(q[2]) << 16 | b(q[3]) << 24;
  } else if constexpr (Q == H16) {
    static_assert(METHOD == CUBIC && R == I8, "H16 entries hold the cubic of int8 taps");
    const float4 c = cubic_coeffs(q);
    auto h = [](float lo, float hi) -> unsigned {
      return (unsigned)__half_as_ushort(__float2half_rn(lo))
             | (unsigned)__half_as_ushort(__float2half_rn(hi)) << 16;
    };
    *reinterpret_cast<uint2*>(dst) = make_uint2(h(c.x, c.y), h(c.z, c.w));
  } else if constexpr (METHOD == NEAREST) {
    dst[0] = q[1];
  } else if constexpr (METHOD == LINEAR) {
    *reinterpret_cast<float2*>(dst) = make_float2(q[1], __fsub_rn(q[2], q[1]));
  } else if constexpr (METHOD == CUBIC) {
    float4 c = cubic_coeffs(q);
    if constexpr (R == I8)
      c = make_float4(__fmul_rn(c.x, dq), __fmul_rn(c.y, dq), __fmul_rn(c.z, dq),
                      __fmul_rn(c.w, dq));
    *reinterpret_cast<float4*>(dst) = c;
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(q[0], q[1], q[2], q[3]);
  }
}

// qs (I8: each transmit's scale s) and rne (BF16: round half to even) are
// unused by the other roundings.
template <int METHOD, int C, bool FR, int Q, int R>
__global__ void __launch_bounds__(256) layout_kernel(const float* __restrict__ x,
                                                     Unit<Q>* __restrict__ out, int T, int N,
                                                     int M, int64_t ldm, int F, int Fg, int fb,
                                                     const float* __restrict__ qs, int rne) {
  constexpr int E = Entry<METHOD, float>::E;
  __shared__ float tile[C][LM][LS];
  const int k0 = blockIdx.x * LT;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t plane = (int64_t)(M / Fg) * N * T;  // entries of one frame of all transmits
  for (int n = blockIdx.z; n < N; n += gridDim.z) {
    for (int m0 = blockIdx.y * LM; m0 < M; m0 += gridDim.y * LM) {
      __syncthreads();  // the last tile's reads are done
      if (m0 + lane < M) {
        // entry q's column of x: frame j of transmit m
        const int q = m0 + lane;
        const int64_t col = FR ? (int64_t)(q / Fg) * F + q % Fg : q;
        for (int r = w; r < LS; r += 8) {
          const int t = min(max(k0 - 1 + r, 0), T - 1);
          const int64_t at = ((int64_t)t * N + n) * ldm + col;
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
        // entry q: frame j of transmit m, frame jb of block b of fbb frames;
        // the transmit's scale's 127 / s and s / 127 (I8)
        const int q = m0 + mm, m = FR ? q / Fg : q, j = FR ? q - m * Fg : 0;
        const int b = FR ? j / fb : 0, jb = j - b * fb, fbb = FR ? min(fb, Fg - b * fb) : 1;
        const float inv = R == I8 ? __fdiv_rn(127.f, __ldg(qs + m)) : 0.f;
        const float dq = R == I8 && Q == F32 ? __fdiv_rn(__ldg(qs + m), 127.f) : 1.f;
        for (int kk = lane; kk < LT && k0 + kk < T; kk += 32) {
          Unit<Q>* dst = out + (FR ? (int64_t)b * fb * plane
                                         + (((int64_t)m * N + n) * T + k0 + kk) * fbb + jb
                                   : ((int64_t)q * N + n) * T + k0 + kk) * (C * E);
#pragma unroll
          for (int c = 0; c < C; ++c)
            put_entry<METHOD, Q, R>(&tile[c][mm][kk], dst + c * E, inv, rne, dq);
        }
      }
    }
  }
}

// With frames, the last axis holds M Fg entries of the Fg frames at x of
// each transmit's F, ldm F a row.
template <int METHOD, bool FR, int Q, int R>
cudaError_t run_layout(const float* x, Unit<Q>* out, int T, int N, int M, int64_t ldm, int F,
                       int Fg, int fb, int cplx, const float* qs, int rne, cudaStream_t s) {
  const int mt = (M + LM - 1) / LM;
  const dim3 grid((T + LT - 1) / LT, mt < 65535 ? mt : 65535, N < 65535 ? N : 65535);
  if (cplx)
    layout_kernel<METHOD, 2, FR, Q, R>
        <<<grid, 256, 0, s>>>(x, out, T, N, M, ldm, F, Fg, fb, qs, rne);
  else
    layout_kernel<METHOD, 1, FR, Q, R>
        <<<grid, 256, 0, s>>>(x, out, T, N, M, ldm, F, Fg, fb, qs, rne);
  return cudaGetLastError();
}

// Entries of type Q of the taps rounded as R says (F32: as they are), of
// frames 0 .. Fg - 1 at x of F, in blocks of fb.
template <int METHOD, int Q = F32, int R = F32>
cudaError_t layout_frames(const float* x, void* out, int T, int N, int M, int64_t ldm, int F,
                          int Fg, int fb, int cplx, cudaStream_t s, const float* qs = nullptr,
                          int rne = 0) {
  Unit<Q>* o = static_cast<Unit<Q>*>(out);
  return F == 1 ? run_layout<METHOD, false, Q, R>(x, o, T, N, M, ldm, 1, 1, 1, cplx, qs, rne, s)
                : run_layout<METHOD, true, Q, R>(x, o, T, N, M * Fg, ldm * F, F, Fg, fb, cplx,
                                                 qs, rne, s);
}

int layout_check(int T, int N, int M, long long ldm, int F, int Fg, int fb, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T <= 0 || N <= 0 || M <= 0 || F <= 0 || ldm < M || T > TMAX || Fg < 1 || Fg > F
      || fb < 1 || fb > Fg || (int64_t)M * Fg >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

#ifdef DAS_KEEP
// das_keep's body for entry type Q and rotation ROT (see das_keep below).
template <int Q, int ROT>
int keep_launch(const float* x, const float* pix, const float* pr, const float* pv,
                const float* nv, const float* taur, const float* taut, long long ldt,
                const float* t0, void* out, long long I, int N, int M, int T, int F, int f0,
                int fb, int fl, float cinv, float fs, float w, int src, int method, int cplx,
                int rot, int add, int keep, long long on, long long om, long long of, int I2,
                int I3, const float* wr, const float* wt, const float* wd,
                const long long* strides, int rx_kinds, int tx_kinds, const float* ori,
                const float* lat, const float* lat_tx, const float* prm, Lp lp, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (I <= 0) return (int)cudaSuccess;
  if (N <= 0 || M <= 0 || T <= 0 || T > TMAX || method < NEAREST || method > LANCZOS3
      || src < PLANE || src > LUT || keep < SUM || keep > KEEP_BOTH || F < 1 || f0 < 0
      || fb != KEEP_FRAMES || f0 + fb > F || fb > fl || I2 < 1 || I3 < 1
      || (src == LUT && ldt < M) || (src == LUT && (rx_kinds || tx_kinds))
      || (rot != 0) != (ROT != NO_ROT) || (ROT == ROT_REDUCED && !reduced_range(w, fs, T)))
    return (int)cudaErrorInvalidValue;
  if (lp.acc16 && keep == SUM) return (int)cudaErrorInvalidValue;  // a kept sum only
  const int E = entry_floats(method, cplx);
  // a kept sum's bytes in out: float32 or complex64, half that as bfloat16
  const int64_t out_bytes = ((cplx || rot) ? 8 : 4) / (lp.acc16 ? 2 : 1);
  Args a{x, pix, pr, pv, nv, taur, taut, t0,
         static_cast<char*>(out) + (int64_t)f0 * of * out_bytes, (int64_t)I,
         (int64_t)T * fl * E, (int64_t)ldt, N, M, T, cinv, fs, add};
  if ((int64_t)NC * a.row >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  KeepArgs k{FrameArgs{a, F, fl * E, fb, w}, keep, on, om, of, I2, I3,
             Dense{wr, s[0], s[1], s[2], s[3], s[4]}, Dense{wt, s[5], s[6], s[7], s[8], s[9]},
             Dense{wd, s[10], s[11], s[12], s[13], s[14]}, rx_kinds, tx_kinds, ori, lat, lat_tx,
             prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], prm[6]};
  cudaStream_t st = (cudaStream_t)stream;
  const QArgs<Q, KeepArgs> kq = with_lp<Q>(k, lp);
  const size_t smem = keep_smem(k, cplx || rot);
  err = cplx ? keep_by_src<float2, ROT, Q>(src, method, kq, smem, st)
             : keep_by_src<float, ROT, Q>(src, method, kq, smem, st);
  return (int)err;
}
#endif  // DAS_KEEP

}  // namespace

#ifdef DAS_Q
// Call f with a launch's entry type prec as a compile-time constant: this
// unit's DAS_Q or, in the I8 unit, H16 (both need qs); refuse any other.
template <class Fn>
int with_prec(int prec, const float* qs, Fn&& f) {
  if (per_tx_scale(prec) && !qs) return (int)cudaErrorInvalidValue;
  if (prec == DAS_Q) return f(std::integral_constant<int, DAS_Q>{});
  if constexpr (DAS_Q == I8) {
    if (prec == H16) return f(std::integral_constant<int, H16>{});
  }
  return (int)cudaErrorInvalidValue;
}
#endif

// The entry points. This file builds as several translation units, so
// that their variants compile in parallel: as das.cu, K1 and K2 without
// remodulation and the layout kernel; with DAS_IQ defined (das_iq.cu), K1
// and K2 with remodulation, das_k1_iq and das_lut_k2_iq (sincos_reduced) and
// das_k1_iq_wide and das_lut_k2_iq_wide (sincosf), which take the same
// arguments, and das_sincos_probe; with DAS_KEEP defined (das_keep.cu), the
// keep modes and weights of K1 and K2 without remodulation, das_keep, and
// with both defined with it, das_keep_iq (das_keep_iq.cu) or, with
// DAS_WIDE, das_keep_iq_wide (das_keep_iq_wide.cu). With DAS_Q defined to
// an entry type the same build that type alone: BF16 (das_bf16.cu:
// das_k1_q, das_lut_k2_q and the layout kernel's das_layout_q;
// das_bf16_iq.cu; das_keep_bf16.cu: das_keep_q; das_keep_bf16_iq.cu;
// das_keep_bf16_iq_wide.cu), I8 with H16 (das_i8*.cu, das_keep_i8*.cu)
// and F32X (das_keep_acc16*.cu). The layouts of float32 coefficients of
// rounded taps come from the narrow units' das_layout_q, and the float32
// units' kernels read them.
//
// Each unit defines its entries once per rotation: without DAS_IQ
// unrotated (das_k1, ...); with it the rotation by sincos_reduced (das_k1_iq,
// ...), whose phases must lie within PHASE_MAX, and by sincosf (das_k1_iq_wide,
// ...), for any phase. The keep units build the two rotations apart:
// DAS_WIDE defined (das_keep_iq_wide.cu, ...) the sincosf entries, else the
// short rotation's.
#if defined(DAS_IQ) && defined(DAS_KEEP)
#ifdef DAS_WIDE
#define ROTATIONS_(X) X(ROT_SINCOSF, _iq_wide)
#else
#define ROTATIONS_(X) X(ROT_REDUCED, _iq)
#endif
#elif defined(DAS_IQ)
#define ROTATIONS_(X) X(ROT_REDUCED, _iq) X(ROT_SINCOSF, _iq_wide)
#else
#define ROTATIONS_(X) X(NO_ROT, )
#endif

#ifdef DAS_KEEP
#define KEEP_ARGS                                                                         \
  const float *x, const float *pix, const float *pr, const float *pv, const float *nv,    \
      const float *taur, const float *taut, long long ldt, const float *t0, void *out,    \
      long long I, int N, int M, int T, int F, int f0, int fb, int fl, float cinv,        \
      float fs, float w, int src, int method, int cplx, int rot, int add, int keep,       \
      long long on, long long om, long long of, int I2, int I3, const float *wr,          \
      const float *wt, const float *wd, const long long *strides, int rx_kinds,           \
      int tx_kinds, const float *ori, const float *lat, const float *lat_tx,              \
      const float *prm
#define KEEP_PASS                                                                         \
  x, pix, pr, pv, nv, taur, taut, ldt, t0, out, I, N, M, T, F, f0, fb, fl, cinv, fs, w,   \
      src, method, cplx, rot, add, keep, on, om, of, I2, I3, wr, wt, wd, strides,         \
      rx_kinds, tx_kinds, ori, lat, lat_tx, prm
#ifdef DAS_Q
// das_keep on a layout of this unit's entry type DAS_Q (the I8 unit: or
// H16): das_keep's arguments, then prec (the entry type: 1 BF16, 2 I8, 3
// F32X, 4 H16), qs (I8, H16: s_m / 127 of each of the launch's transmits,
// else null) and acc16 (1: out holds the kept sums as bfloat16, a pair for
// a complex sum, its strides in sums; keep_rx, keep_tx or both only).
#define KEEP_ENTRIES_(R, sfx)                                                             \
  extern "C" int das_keep_q##sfx(KEEP_ARGS, int prec, const float* qs, int acc16,         \
                                 int device, void* stream) {                              \
    return with_prec(prec, qs, [&](auto q) {                                              \
      return keep_launch<decltype(q)::value, R>(KEEP_PASS, Lp{qs, acc16}, device, stream); \
    });                                                                                   \
  }
#else
// Launch das_keep_kernel on `stream` of device `device` for M transmits
// and frame f0 of F (fb, the frames a launch, KEEP_FRAMES; x at its
// entries in a layout of fl frames a tap base, as for das_k1): K1 (src 0
// plane, 1 diverging, 2 virtual; pix, pr, pv, nv, cinv) or K2 (src 3; taur
// (I, N), taut (I, ldt), whose first M columns are these transmits'). x,
// t0, fs, w, method, cplx as for das_k1; rot 1 for the remodulating
// entries (das_keep_iq, whose phases must lie within PHASE_MAX, and
// das_keep_iq_wide, which refuse rot 0, as das_keep refuses 1); out at
// frame 0 and
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
#define KEEP_ENTRIES_(R, sfx)                                                             \
  extern "C" int das_keep##sfx(KEEP_ARGS, int device, void* stream) {                     \
    return keep_launch<F32, R>(KEEP_PASS, Lp{}, device, stream);                          \
  }
#endif
ROTATIONS_(KEEP_ENTRIES_)
#else
// K1's and K2's arguments (das_k1 / das_lut_k2 below), and for the
// reduced-precision units those and prec, qs (das_k1_q / das_lut_k2_q).
#define K1_ARGS                                                                           \
  const float *x, const float *pix, const float *pr, const float *pv, const float *nv,    \
      const float *t0, void *out, long long I, int N, int M, int T, int F, int f0, int fb, \
      int fl, float cinv, float fs, float w, int tx_model, int method, int cplx, int add
#define K1_PASS x, pix, pr, pv, nv, t0, out, I, N, M, T, F, f0, fb, fl, cinv, fs, w,       \
      tx_model, method, cplx, add
#define K2_ARGS                                                                           \
  const float *x, const float *taur, const float *taut, const float *t0, void *out,       \
      long long I, int N, int M, long long ldt, int T, int F, int f0, int fb, int fl,     \
      float fs, float w, int method, int cplx, int add
#define K2_PASS x, taur, taut, t0, out, I, N, M, ldt, T, F, f0, fb, fl, fs, w, method, cplx, \
      add

template <int ROT, int Q>
int k1_entry(K1_ARGS, Lp lp, int device, void* stream) {
  if (tx_model < PLANE || tx_model > VIRTUAL) return (int)cudaErrorInvalidValue;
  const Args a{x, pix, pr, pv, nv, nullptr, nullptr, t0, out, (int64_t)I, 0, 0, N, M, T,
               cinv, fs, add};
  return launch<ROT, Q>(tx_model, method, cplx, a, F, f0, fb, fl, w, lp, device, stream);
}

template <int ROT, int Q>
int k2_entry(K2_ARGS, Lp lp, int device, void* stream) {
  if (ldt < M) return (int)cudaErrorInvalidValue;
  const Args a{x, nullptr, nullptr, nullptr, nullptr, taur, taut, t0, out, (int64_t)I, 0,
               (int64_t)ldt, N, M, T, 0.f, fs, add};
  return launch<ROT, Q>(LUT, method, cplx, a, F, f0, fb, fl, w, lp, device, stream);
}

#ifdef DAS_Q
// K1 and K2 on a layout of this unit's entry type DAS_Q (BF16, I8; the I8
// unit: or H16): das_k1's and das_lut_k2's arguments, then prec (the entry
// type) and qs (I8, H16: s_m / 127 of each of the launch's transmits, else
// null).
#define Q_ENTRIES_(R, sfx)                                                                \
  extern "C" int das_k1_q##sfx(K1_ARGS, int prec, const float* qs, int device,            \
                               void* stream) {                                            \
    return with_prec(prec, qs, [&](auto q) {                                              \
      return k1_entry<R, decltype(q)::value>(K1_PASS, Lp{qs, 0}, device, stream);         \
    });                                                                                   \
  }                                                                                       \
  extern "C" int das_lut_k2_q##sfx(K2_ARGS, int prec, const float* qs, int device,        \
                                   void* stream) {                                        \
    return with_prec(prec, qs, [&](auto q) {                                              \
      return k2_entry<R, decltype(q)::value>(K2_PASS, Lp{qs, 0}, device, stream);         \
    });                                                                                   \
  }
ROTATIONS_(Q_ENTRIES_)

#ifndef DAS_IQ
// The layout kernel for this unit's rounding: das_layout's arguments, then
// prec (the unit's entry type, DAS_Q: its rounding; I8: cubic and lanczos3
// only), qs (I8: the scale s of each of transmits 0 .. M-1, (M,) float32),
// rne (BF16: 1 rounds half to even, 0 half away from zero) and form, the
// entry type written: DAS_Q (the rounded taps), F32 (cubic: the float32
// coefficients of the rounded taps, of int8 taps times s / 127) or, in the
// I8 unit, H16 (cubic: the coefficients of the int8 taps in half
// precision); out das_layout's blocks of units of 2 (BF16, H16), 1 (I8) or
// 4 (F32) bytes.
extern "C" int das_layout_q(const float* x, void* out, int T, int N, int M, long long ldm,
                            int F, int Fg, int fb, int method, int cplx, int prec,
                            const float* qs, int rne, int form, int device, void* stream) {
  const int err = layout_check(T, N, M, ldm, F, Fg, fb, device);
  if (err != (int)cudaSuccess) return err;
  if (prec != DAS_Q || (prec == I8 && !qs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (method == CUBIC && form == F32)
    return (int)layout_frames<CUBIC, F32, DAS_Q>(x, out, T, N, M, ldm, F, Fg, fb, cplx, s, qs,
                                                  rne);
  if constexpr (DAS_Q == I8) {
    if (method == CUBIC && form == H16)
      return (int)layout_frames<CUBIC, H16, I8>(x, out, T, N, M, ldm, F, Fg, fb, cplx, s, qs,
                                                rne);
  }
  if (form != DAS_Q) return (int)cudaErrorInvalidValue;
  switch (method) {
    case NEAREST:
      if constexpr (DAS_Q != I8)
        return (int)layout_frames<NEAREST, DAS_Q, DAS_Q>(x, out, T, N, M, ldm, F, Fg, fb, cplx,
                                                         s, qs, rne);
      break;
    case LINEAR:
      if constexpr (DAS_Q != I8)
        return (int)layout_frames<LINEAR, DAS_Q, DAS_Q>(x, out, T, N, M, ldm, F, Fg, fb, cplx,
                                                        s, qs, rne);
      break;
    case CUBIC:
      return (int)layout_frames<CUBIC, DAS_Q, DAS_Q>(x, out, T, N, M, ldm, F, Fg, fb, cplx, s,
                                                     qs, rne);
    case LANCZOS3:
      return (int)layout_frames<LANCZOS3, DAS_Q, DAS_Q>(x, out, T, N, M, ldm, F, Fg, fb, cplx,
                                                        s, qs, rne);
  }
  return (int)cudaErrorInvalidValue;
}
#endif
#else

// Launch K1 on `stream` (a cudaStream_t) of device `device` for M
// transmits and frames f0 .. f0 + fb - 1 (fb at most the sampler's frames a
// launch, das_frames_kernel's plan) of F. x points at frame f0's entries in
// the layout of `method` (das_layout's output) of these traces, float32, or
// complex64 when `cplx` is 1, which holds fl >= fb frames a tap base (a
// block of das_layout's; one frame: fl 1); pv, nv (M, 3) and t0 (M,)
// theirs; out (I, F) of the sums' type (complex64 when `cplx` is 1 or for
// the remodulating entries, else float32), to which the sums are added
// when `add` is 1; w = 2 pi fmod (the remodulating entries; the other
// ignores it; das_k1_iq refuses w (T - 1) / fs past PHASE_MAX, which
// das_k1_iq_wide takes). Returns the cudaError_t of the launch
// (cudaGetLastError right after it); 0 is success.
#define ENTRIES_(R, sfx)                                                                  \
  extern "C" int das_k1##sfx(K1_ARGS, int device, void* stream) {                         \
    return k1_entry<R, F32>(K1_PASS, Lp{}, device, stream);                               \
  }                                                                                       \
  extern "C" int das_lut_k2##sfx(K2_ARGS, int device, void* stream) {                     \
    return k2_entry<R, F32>(K2_PASS, Lp{}, device, stream);                               \
  }
// And K2 (das_lut_k2): x, out, w and add as for das_k1; taur (I, N) and
// taut (I, ldt), of which the first M columns are these transmits', the
// delay tables [s]; t0 (M,).
ROTATIONS_(ENTRIES_)

#ifdef DAS_IQ
namespace {
__global__ void sincos_probe_kernel(const float* __restrict__ x, float2* __restrict__ out,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float s, c;
    sincos_reduced(x[i], &s, &c);
    out[i] = make_float2(s, c);
  }
}
}  // namespace

// The rotation of das_k1_iq and das_lut_k2_iq (sincos_reduced) of n phases
// x (float32) into out (n, 2): (sin, cos) pairs, for the tests to hold
// against float64.
extern "C" int das_sincos_probe(const float* x, void* out, int n, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  sincos_probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, (float2*)out, n);
  return (int)cudaGetLastError();
}
#else
// Launch the layout kernel on `stream` of device `device`: x (T, N, ldm, F)
// float32, or complex64 when `cplx` is 1, contiguous, from the first
// transmit and frame to lay out, of which frames 0 .. Fg - 1 of transmits
// 0 .. M - 1 are laid out in blocks of fb frames (the last short where fb
// does not divide Fg; one block, fb = Fg = F, is all the frames); out the
// layout of `method` (0 nearest: the traces; 1 linear, 2 cubic, 3
// lanczos3: stencils), block after block (M, N, T, fbb, [2,] E) floats, fbb
// the block's frames. Returns the cudaError_t of the launch; 0 is success.
extern "C" int das_layout(const float* x, float* out, int T, int N, int M, long long ldm,
                          int F, int Fg, int fb, int method, int cplx, int device,
                          void* stream) {
  const int err = layout_check(T, N, M, ldm, F, Fg, fb, device);
  if (err != (int)cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case NEAREST: return (int)layout_frames<NEAREST>(x, out, T, N, M, ldm, F, Fg, fb, cplx, s);
    case LINEAR: return (int)layout_frames<LINEAR>(x, out, T, N, M, ldm, F, Fg, fb, cplx, s);
    case CUBIC: return (int)layout_frames<CUBIC>(x, out, T, N, M, ldm, F, Fg, fb, cplx, s);
    case LANCZOS3:
      return (int)layout_frames<LANCZOS3>(x, out, T, N, M, ldm, F, Fg, fb, cplx, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif
#endif  // DAS_Q
#endif  // DAS_KEEP
