// das_keep_i8.cu's variants with IQ remodulation by the short rotation, das_keep_q_iq.
#define DAS_KEEP
#define DAS_Q I8
#define DAS_IQ
#include "das.cu"
