// K1(c), K1(d) and K2(c) with IQ remodulation: das_keep.cu's variants that
// rotate each sample by exp(2 pi i fmod tau), das_keep_iq, in a fourth
// translation unit, so that they build in parallel with the others.
#define DAS_KEEP
#define DAS_IQ
#include "das.cu"
