// das_keep_bf16.cu's variants with IQ remodulation by the short rotation, das_keep_q_iq.
#define DAS_KEEP
#define DAS_Q BF16
#define DAS_IQ
#include "das.cu"
