// das_bf16.cu's variants with IQ remodulation (das_k1_q_iq, das_lut_k2_q_iq).
#define DAS_Q BF16
#define DAS_IQ
#include "das.cu"
