// The Burgers instance of the tiled step kernel (tiled_step.cu), whole
// grid and block mode: f'(u) = (u, u), f''(u) = (1, 1), RV speed sqrt(2)
// max|u| over the patch (fused_step.cuh Burgers). A translation unit of its
// own, so that it compiles beside the KPP instance.

#define CFT_FLUX Burgers
#define CFT_ENTRY(name, dt) cft_##name##_burgers_##dt
#include "tiled_step.cu"
