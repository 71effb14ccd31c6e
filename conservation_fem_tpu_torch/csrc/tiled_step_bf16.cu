// The bf16-plane instance of the tiled step kernel (tiled_step.cu), KPP,
// f32, whole grid and block mode: the solver sweeps stream bf16 mass and
// Jacobian planes (pallas_tiled.tiled_rv_step with bf16_planes). A
// translation unit of its own, so that it compiles beside the f32 and f64
// instances.

#define CFT_TILED_BF16
#include "tiled_step.cu"
