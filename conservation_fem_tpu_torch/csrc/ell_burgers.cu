// The Burgers instances of the ELL kernels C and D (ell.cu): f'(u) = (u,
// u), f''(u) = (1, 1), RV speed sqrt(2) max|u| over the patch
// (fused_step.cuh Burgers). A translation unit of its own, so that it
// compiles beside the KPP instances; A and B are flux-free and built once,
// in ell.cu.

#define CFT_FLUX Burgers
#define CFT_ENTRY(name, dt) cft_##name##_burgers_##dt
#define CFT_ELL_FLUX_ONLY
// D's Burgers instances: at least 4 resident CTAs an SM (ell.cu, D's
// launch bound)
#define CFT_RV_MIN_BLOCKS 4
#include "ell.cu"
