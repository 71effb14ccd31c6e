// The ablation instances of the single step kernel (fused_step.cu): KPP,
// f32, each without one element of the band design (band_sweep.cuh
// BandDesign), and one without all three, behind one entry point,
// cft_fused_rv_step_ablate_f32(design, ...). Built, with
// block_step_ablate.cu, into a library of its own on first use
// (ops/_build.ablate_lib); chip_smoke.py --ablate times them against the
// full kernel.

#define CFT_BAND_ABLATE
#include "fused_step.cu"
