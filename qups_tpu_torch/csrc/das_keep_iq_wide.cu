// das_keep_iq.cu's variants rotating by sincosf instead, for phases past
// PHASE_MAX: das_keep_iq_wide, a unit of its own so that it builds in
// parallel with the short rotation's.
#define DAS_KEEP
#define DAS_IQ
#define DAS_WIDE
#include "das.cu"
