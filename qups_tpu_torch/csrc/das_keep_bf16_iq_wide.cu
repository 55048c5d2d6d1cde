// das_keep_bf16_iq.cu's variants rotating by sincosf, das_keep_q_iq_wide.
#define DAS_KEEP
#define DAS_Q BF16
#define DAS_IQ
#define DAS_WIDE
#include "das.cu"
