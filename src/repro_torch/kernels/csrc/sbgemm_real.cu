// The real SBGEMM entries (sbgemm_n_real, sbgemm_th_real and their tiled
// builds): the kernels of sbgemm.cu with REAL = true, compiled as a library
// of their own so that they build beside the complex ones, not after them.
#define SBGEMM_REAL_ENTRIES
#include "sbgemm.cu"
