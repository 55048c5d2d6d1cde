// K1(e) and K2(e) in the keep kernel on int8 layouts (lanczos3; complex cubic: H16).
#define DAS_KEEP
#define DAS_Q I8
#include "das.cu"
