// K1(e) and K2(e) on int8 trace layouts ('i8x4': four int8 taps an entry,
// cubic and lanczos3), without remodulation, and the layout kernel that
// writes them: das.cu's body built for the I8 entry type alone.
#define DAS_Q I8
#include "das.cu"
