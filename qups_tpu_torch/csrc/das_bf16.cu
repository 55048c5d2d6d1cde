// K1(e) and K2(e) on bf16 trace layouts ('bf16pair', 'bf16': the taps as
// bfloat16 bits), without remodulation, and the layout kernel that writes
// them: das.cu's body built for the BF16 entry type alone (das_k1_q,
// das_lut_k2_q, das_layout_q), in a translation unit of its own.
#define DAS_Q BF16
#include "das.cu"
