// K1(e) and K2(e) in the keep kernel on int8 layouts (cubic, lanczos3).
#define DAS_KEEP
#define DAS_Q I8
#include "das.cu"
