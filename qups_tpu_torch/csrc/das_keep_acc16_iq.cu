// das_keep_acc16.cu's variants with IQ remodulation by the short rotation, das_keep_q_iq.
#define DAS_KEEP
#define DAS_Q F32X
#define DAS_IQ
#include "das.cu"
