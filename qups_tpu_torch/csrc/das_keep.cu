// K1(c), K1(d) and K2(c): the keep modes (keep_rx, keep_tx, both) and the
// apodization weights (fused kinds evaluated in the kernel, dense arrays)
// of K1 and K2. The kernel body is das.cu's das_keep_kernel; built from
// this file, das.cu defines das_keep alone, so its variants compile in a
// third translation unit, in parallel with the others.
#define DAS_KEEP
#include "das.cu"
