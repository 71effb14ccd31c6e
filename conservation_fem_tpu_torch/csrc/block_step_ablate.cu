// The ablation instances of the block step kernel (block_step.cu): KPP,
// f32, each without one element of the band design that it uses
// (band_sweep.cuh BandDesign: staged planes, quadrature per triangle), and
// one without both, behind one entry point,
// cft_fused_rv_block_step_ablate_f32(design, ...). Built, with
// fused_step_ablate.cu, into a library of its own on first use
// (ops/_build.ablate_lib); chip_smoke.py --ablate times them against the
// full kernel.

#define CFT_BAND_ABLATE
#include "block_step.cu"
