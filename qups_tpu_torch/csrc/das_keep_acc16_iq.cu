// das_keep_acc16.cu's variants with IQ remodulation.
#define DAS_KEEP
#define DAS_Q F32X
#define DAS_IQ
#include "das.cu"
