// K1(e) and K2(e) on 'i8x4' trace layouts (int8 taps, one scale per
// transmit or call): four int8 taps an entry (lanczos3) and, for cubic
// traces, H16 entries (the cubic's coefficients of the int8 taps in half
// precision), without remodulation, and the layout kernel that writes
// them and, for the keep kernel's real cubic traces, the float32
// coefficients of the int8 taps times s / 127, which the float32 units'
// kernels read: das.cu's body built for the I8 rounding alone.
#define DAS_Q I8
#include "das.cu"
