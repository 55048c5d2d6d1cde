// K1(e) and K2(e) in the keep kernel on bf16 layouts: das_keep_kernel's keep
// modes and apodization weights, its kept sums stored as bfloat16 on
// request (QUPS_DAS_ACC16), das_keep_q.
#define DAS_KEEP
#define DAS_Q BF16
#include "das.cu"
