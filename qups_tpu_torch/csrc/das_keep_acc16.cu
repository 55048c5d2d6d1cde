// K1(e)'s bfloat16 kept sums on float32 traces (QUPS_DAS_ACC16 with
// precision 'f32'): das_keep_kernel on the float32 layout with the
// reduced-precision units' arguments (the F32X entry type), das_keep_q, so
// that das_keep.cu's variants keep their arguments.
#define DAS_KEEP
#define DAS_Q F32X
#include "das.cu"
