// The Burgers instance of the single step kernel (fused_step.cu):
// f'(u) = (u, u), f''(u) = (1, 1), RV speed sqrt(2) max|u| over the patch
// (fused_step.cuh Burgers). A translation unit of its own, so that it
// compiles beside the KPP instance.

#define CFT_FLUX Burgers
#define CFT_ENTRY(name, dt) cft_##name##_burgers_##dt
#include "fused_step.cu"
