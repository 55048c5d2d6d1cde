// das_keep_i8_iq.cu's variants rotating by sincosf, das_keep_q_iq_wide.
#define DAS_KEEP
#define DAS_Q I8
#define DAS_IQ
#define DAS_WIDE
#include "das.cu"
