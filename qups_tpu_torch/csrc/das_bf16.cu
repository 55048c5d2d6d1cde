// K1(e) and K2(e) on bf16 trace layouts ('bf16pair', 'bf16': the taps as
// bfloat16 bits), without remodulation, and the layout kernel that writes
// them and, for real cubic traces, the float32 coefficients of the rounded
// taps, which the float32 units' kernels read: das.cu's body built for the
// BF16 rounding alone (das_k1_q, das_lut_k2_q, das_layout_q), in a
// translation unit of its own.
#define DAS_Q BF16
#include "das.cu"
