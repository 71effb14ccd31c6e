"""Parameter sweeps, ported from conservation_fem_tpu/utils/sweeps.py.

Parity with the reference's sweep scripts:
  * smoothing-strength sweeps over l (ref Code/Burgers_equation/
    smooth_plots_{GFEM,RV,SI}.py — loop over l, apply smooth_vector each
    step, write per-l series);
  * degree x mesh sweeps live in models/advection_ho.py;
  * mesh-refinement convergence in utils/convergence.py.
"""

from __future__ import annotations

from typing import Sequence


def burgers_smoothing_sweep(
    ls: Sequence[float] = (2.0, 4.0, 8.0),
    mesh_size: int = 50,
    stabilization: str = "si",
    out_dir: str | None = None,
    device=None,
):
    """Run Burgers with post-solve smoothing strengths l (ref
    smooth_plots_RV.py:227, smooth_vector applied per step) on ``device``
    (None: the card) and return {l: L2 error}; optionally write each final
    field as XDMF (needs h5py)."""
    from conservation_fem_tpu_torch.models import burgers

    results = {}
    for l in ls:
        p = burgers.build(
            burgers.BurgersConfig(
                mesh_size=mesh_size, stabilization=stabilization,
                smooth_l=float(l),
            ),
            device=device,
        )
        res = p.solve()
        err = float(burgers.l2_error_vs_exact(p, res.u, 0.5))
        results[float(l)] = err
        if out_dir is not None:
            from conservation_fem_tpu_torch.utils.io import XDMFWriter

            with XDMFWriter(f"{out_dir}/sol_l{l:g}.xdmf", p.host_mesh) as w:
                w.write_function(res.u, 0.5)
    return results
