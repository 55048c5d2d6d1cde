// das_keep_i8.cu's variants with IQ remodulation.
#define DAS_KEEP
#define DAS_Q I8
#define DAS_IQ
#include "das.cu"
