// K1(b) and K2(b): the remodulating variants of K1 and K2 (IQ data,
// fmod != 0). The kernel body is das.cu's; built from this file, das.cu
// defines das_k1_iq and das_lut_k2_iq, so the rotating instantiations
// compile in a second translation unit, in parallel with the first.
#define DAS_IQ
#include "das.cu"
