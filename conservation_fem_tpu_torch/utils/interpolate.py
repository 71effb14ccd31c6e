"""Cross-mesh P1 interpolation: evaluate a P1 field at arbitrary points,
ported from conservation_fem_tpu/utils/interpolate.py.

Enables the fine-vs-coarse comparison the reference's KPP convergence stub
never finished (ref Code/KPP/KPP_conv.py:30-33: reads the hmax=1/64 field
back but stops there): interpolate the fine-mesh reference field onto the
coarse mesh's nodes (or vice versa) and take the L2 difference.

Point location is host-side (scipy cKDTree over cell centroids + exact
barycentric containment over candidate cells); evaluation is exact P1, on
the host. ``cross_mesh_l2`` takes the norm on the coarse mesh's ELL mass
in f64 on a device.
"""

from __future__ import annotations

import numpy as np
import torch

from conservation_fem_tpu_torch import get_device
from conservation_fem_tpu_torch.ops import assembly
from conservation_fem_tpu_torch.ops.mesh import Mesh
from conservation_fem_tpu_torch.ops.spmv import ell_matvec
from conservation_fem_tpu_torch.utils.checkpoint import host_array


def locate_cells(mesh: Mesh, points, n_candidates: int = 12, tol: float = 1e-10):
    """For each query point, the containing cell and barycentric coords.

    Returns (cell_idx (P,), bary (P,3)); points outside the mesh get the
    nearest candidate cell with clipped coordinates.
    """
    from scipy.spatial import cKDTree

    pts = np.asarray(points, dtype=float)[:, :2]
    centroids = mesh.points[mesh.cells].mean(axis=1)
    tree = cKDTree(centroids)
    k = min(n_candidates, mesh.n_cells)
    _, cand = tree.query(pts, k=k)
    cand = np.atleast_2d(cand)
    if cand.shape[0] != pts.shape[0]:
        cand = cand.reshape(pts.shape[0], -1)

    p0 = mesh.points[mesh.cells[:, 0]]
    e1 = mesh.points[mesh.cells[:, 1]] - p0
    e2 = mesh.points[mesh.cells[:, 2]] - p0
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]

    cells_out = np.empty(len(pts), dtype=np.int64)
    bary_out = np.empty((len(pts), 3))
    best_neg = np.full(len(pts), -np.inf)
    found = np.zeros(len(pts), dtype=bool)
    for j in range(cand.shape[1]):
        c = cand[:, j]
        d = pts - p0[c]
        l1 = (d[:, 0] * e2[c, 1] - d[:, 1] * e2[c, 0]) / det[c]
        l2 = (e1[c, 0] * d[:, 1] - e1[c, 1] * d[:, 0]) / det[c]
        l0 = 1.0 - l1 - l2
        neg = np.minimum(np.minimum(l0, l1), l2)
        inside = neg >= -tol
        take_inside = inside & ~found
        better = (neg > best_neg) & ~found
        for sel, mark_found in ((take_inside, True), (better, False)):
            if sel.any():
                cells_out[sel] = c[sel]
                bary_out[sel] = np.stack([l0, l1, l2], axis=1)[sel]
                if mark_found:
                    found[sel] = True
                else:
                    best_neg[sel] = neg[sel]
    bary_out = np.clip(bary_out, 0.0, None)
    bary_out /= bary_out.sum(axis=1, keepdims=True)
    return cells_out, bary_out


def interpolate_p1(mesh: Mesh, u, points):
    """Evaluate the P1 field u (nodal values on mesh; an array or a tensor
    on any device) at query points, on the host."""
    cells, bary = locate_cells(mesh, points)
    u = host_array(u)
    return (u[mesh.cells[cells]] * bary).sum(axis=1)


def cross_mesh_l2(mesh_fine: Mesh, u_fine, mesh_coarse: Mesh, u_coarse,
                  device=None):
    """L2 norm (on the coarse mesh) of u_coarse - I(u_fine): the
    fine-reference comparison of KPP_conv, completed. The interpolation
    runs on the host; the norm on the coarse mesh's mass in f64 on
    ``device`` (None: u_coarse's device if it is a tensor, else the
    card)."""
    if device is None and isinstance(u_coarse, torch.Tensor):
        device = u_coarse.device
    device = get_device(device)
    u_ref = interpolate_p1(mesh_fine, u_fine, mesh_coarse.points)
    m = mesh_coarse.device_arrays(torch.float64, device)
    M = assembly.assemble_mass(m)
    d = torch.as_tensor(host_array(u_coarse) - u_ref, dtype=torch.float64,
                        device=device)
    return float(torch.sqrt(d @ ell_matvec(m, M, d)))
