"""Incompressible Navier-Stokes by Chorin/IPCS splitting, P2-P1
Taylor-Hood, pressure-driven Poiseuille channel flow; ported from
conservation_fem_tpu/models/stokes.py.

  * the unit square, nx x nx cells; dt = T / num_steps (0.02 by default);
  * vector P2 velocity, P1 pressure; no-slip walls at y = 0, 1; pressure
    p_in at the inflow x = 0 and p_out at the outflow x = 1;
  * step 1, tentative velocity: rho (u - u_n)/k . v + rho (u_n . grad u_n)
    . v + sigma((u + u_n)/2, p_n) : eps(v) + the boundary terms
    int p_n n . v ds - int mu grad(U) n . v ds (BiCGStab);
  * step 2, pressure Poisson: grad p . grad q = grad p_n . grad q
    - (rho/k) div(u*) q with the pressure bcs (CG);
  * step 3, velocity correction: rho u . v = rho u* . v - k grad(p* - p_n)
    . v (the mass CG);
  * oracle: the exact Poiseuille u = (4 y (1 - y), 0), the L2 error at the
    end (``StokesResult.error_l2``).

Backends: ``"ell"`` solves on dof vectors with the gather SpMV;
``"lattice"`` solves on the P2 and P1 lattices with the lattice-stencil
operators of ops/lattice.py (gather-free products; the right-hand sides
stay gathers), optionally preconditioned by the V(2,2) Galerkin multigrid
of ops/multigrid.py (``multigrid=True``). ``"grid"`` runs the row-sharded
step of parallel/stokes_sharded.py on one block: the right-hand sides too
are lattice planes and strided slices.

The solves are adaptive to ``krylov_rtol`` (one scalar read on the host
per Krylov iteration) or, with ``krylov_iters``, fixed: momentum
BiCGStab ki, pressure CG ``auto_kip``, mass CG min(8, ki). The operators
are built once per problem (``step_buffers``) and reused by every step.
No hand-written kernel lies on this path (the JAX package runs it as
XLA); ``einsum_exact`` is plain torch.einsum, TF32 being off.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from conservation_fem_tpu_torch import get_device
from conservation_fem_tpu_torch.ops import assembly
from conservation_fem_tpu_torch.ops import assembly_pk as apk
from conservation_fem_tpu_torch.ops import lattice as lat
from conservation_fem_tpu_torch.ops import multigrid as mgrid
from conservation_fem_tpu_torch.ops.facets import (_GAUSS_X, _LOCAL_EDGES,
                                                   _REF_VERTS,
                                                   boundary_facet_data)
from conservation_fem_tpu_torch.ops.krylov import (bicgstab, bicgstab_fixed,
                                                   cg, cg_fixed,
                                                   jacobi_preconditioner)
from conservation_fem_tpu_torch.ops.mesh import Mesh, rectangle_mesh
from conservation_fem_tpu_torch.ops.spaces import build_space
from conservation_fem_tpu_torch.ops.spmv import ell_diag, ell_matvec


@dataclasses.dataclass(frozen=True)
class StokesConfig:
    nx: int = 10
    T: float = 10.0
    num_steps: int = 500
    mu: float = 1.0
    rho: float = 1.0
    p_in: float = 8.0
    p_out: float = 0.0
    krylov_rtol: float = 1e-11
    dtype: str = "float64"
    backend: str = "ell"          # ell | lattice | grid
    # fixed iteration counts: momentum BiCGStab (and the mass CG, min(8,
    # krylov_iters)); None = adaptive to krylov_rtol
    krylov_iters: int | None = None
    # pressure CG count; None = auto_kip whenever krylov_iters is set
    krylov_iters_pressure: int | None = None
    # V(2,2) Galerkin multigrid preconditioners (lattice backend)
    multigrid: bool = False


def auto_kip(cfg: "StokesConfig") -> int | None:
    """The fixed pressure-CG count: the override, or with krylov_iters set
    max(ki, 3 nx) (the Jacobi-CG iterations grow with nx), or max(ki, 6)
    with multigrid (the MG-CG count does not grow); None when adaptive."""
    if cfg.krylov_iters_pressure is not None:
        return cfg.krylov_iters_pressure
    if cfg.krylov_iters is None:
        return None
    if cfg.multigrid:
        return max(cfg.krylov_iters, 6)
    return max(cfg.krylov_iters, 3 * cfg.nx)


class StokesProblem(NamedTuple):
    cfg: object
    host_mesh: object
    vspace: object                # host P2 FunctionSpace
    sp: object                    # P2 SpaceArrays (velocity components)
    mp: object                    # P1 MeshArrays (pressure)
    dt: float
    M2: object                    # P2 mass ELL
    visc: object                  # (2,2,N,K) viscous blocks (mu included)
    edge: object                  # (2,2,N,K) edge-gradient blocks (no mu)
    K1: object                    # P1 stiffness ELL
    wall_mask: object             # (N2,) velocity Dirichlet mask
    p_bc_mask: object             # (N1,)
    p_bc_val: object              # (N1,)
    u0: object                    # (2,N2)
    p0: object                    # (N1,)


def _phys_grads(sp):
    """Affine physical gradients of the basis at the quadrature points:
    (M,Q,nloc,2)."""
    return torch.einsum("mde,qne->mqnd", sp.jinv_t, sp.dphi)


def _assemble_visc_blocks(sp, mu):
    """V[m][l]_ab = mu (delta_ml grad phi_a . grad phi_b + d_l phi_a d_m
    phi_b), the volume part of 2 mu eps(u) : eps(v)."""
    g = _phys_grads(sp)                                   # (M,Q,n,2)
    lap = torch.einsum("q,mqad,mqbd->mab", sp.quad_w, g, g)
    blocks = []
    for m in range(2):
        row = []
        for l in range(2):
            cross = torch.einsum("q,mqa,mqb->mab", sp.quad_w,
                                 g[..., l], g[..., m])
            loc = mu * ((lap if m == l else 0.0) + cross)
            vals = 2.0 * sp.area[:, None, None] * loc
            row.append(apk.scatter_matrix(sp, vals))
        blocks.append(torch.stack(row))
    return torch.stack(blocks)                            # (2,2,N,K)


def _assemble_edge_blocks(space, sp, fd):
    """E[m][l]_ab = int_bnd phi_a d_m phi_b n_l ds (no mu factor), on the
    host as in the JAX package."""
    n2, K = sp.patch_cols.shape
    cs = np.asarray(space.cell_slots)
    cd = np.asarray(space.cell_dofs)
    jinv_t = sp.jinv_t.cpu().numpy()
    out = np.zeros((2, 2, n2 * K))
    for e in range(len(fd.edge_cell)):
        c = fd.edge_cell[e]
        le = fd.local_edge[e]
        phi = fd.phi_edge[le]                             # (Q,nloc)
        dphi = fd.dphi_edge[le]                           # (Q,nloc,2)
        gphys = np.einsum("de,qne->qnd", jinv_t[c], dphi)  # (Q,nloc,2)
        # loc[m]_ab = len * sum_q w phi_a(q) d_m phi_b(q)
        loc = fd.length[e] * np.einsum("q,qa,qbm->mab", fd.w1d, phi, gphys)
        tgt = (cd[c][:, None] * K + cs[c]).reshape(-1)    # (nloc*nloc,)
        for m in range(2):
            for l in range(2):
                np.add.at(out[m, l], tgt,
                          (loc[m] * fd.normal[e, l]).reshape(-1))
    return torch.as_tensor(out.reshape(2, 2, n2, K), dtype=sp.area.dtype,
                           device=sp.area.device)


def build(cfg: StokesConfig | None = None, host_mesh: Mesh | None = None,
          device=None, **kw):
    """(StokesProblem, FacetData) on ``device`` (None: the card; raises
    without one. device="cpu" for the CPU)."""
    if cfg is None:
        cfg = StokesConfig(**kw)
    if cfg.backend not in ("ell", "lattice", "grid"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    device = get_device(device)
    if host_mesh is None:
        host_mesh = rectangle_mesh((0, 0), (1, 1), nx=cfg.nx)
    dtype = getattr(torch, cfg.dtype)
    vspace = build_space(host_mesh, 2)
    sp = vspace.device_arrays(dtype, device)
    mp = host_mesh.device_arrays(dtype, device)
    dt = cfg.T / cfg.num_steps
    M2 = apk.assemble_mass(sp)
    visc = _assemble_visc_blocks(sp, cfg.mu)
    fd = boundary_facet_data(vspace)
    edge = _assemble_edge_blocks(vspace, sp, fd)
    K1 = assembly.assemble_stiffness(mp)

    xy = np.asarray(vspace.dof_coords)
    wall = np.isclose(xy[:, 1], 0.0) | np.isclose(xy[:, 1], 1.0)
    pxy = host_mesh.points
    inflow = np.isclose(pxy[:, 0], 0.0)
    outflow = np.isclose(pxy[:, 0], 1.0)
    p_bc_mask = inflow | outflow
    p_bc_val = np.where(inflow, cfg.p_in, np.where(outflow, cfg.p_out, 0.0))

    t = lambda a, dt_=None: torch.as_tensor(a, dtype=dt_, device=device)
    prob = StokesProblem(
        cfg, host_mesh, vspace, sp, mp, dt, M2, visc, edge, K1,
        t(wall), t(p_bc_mask), t(p_bc_val, dtype),
        torch.zeros((2, vspace.ndof), dtype=dtype, device=device),
        torch.zeros(host_mesh.n_nodes, dtype=dtype, device=device))
    return prob, fd


def _edge_lambdas():
    """(3,Q,3): the P1 basis at the Gauss points of each local edge."""
    out = []
    for (a, b) in _LOCAL_EDGES:
        pts = (_REF_VERTS[a][None] * (1 - _GAUSS_X[:, None])
               + _REF_VERTS[b][None] * _GAUSS_X[:, None])
        out.append(np.stack([1 - pts[:, 0] - pts[:, 1], pts[:, 0],
                             pts[:, 1]], axis=1))
    return np.stack(out)


def host_coupling_coo(p: StokesProblem, fd):
    """The step's linear coupling terms as host COO matrices, per
    component s (rows, cols, vals):
      DE[s]: (N2, N1) pressure_div - pressure_edge  (the step-1 term)
      B[s]:  (N1, N2) div_u                          (the step-2 term)
      G[s]:  (N2, N1) grad_p                         (the step-3 term)
    (the grid-space and sharded steps apply them as lattice planes)."""
    sp = p.sp
    h = lambda a: a.cpu().numpy()
    cd = np.asarray(p.vspace.cell_dofs)                 # (M, nloc)
    cells = np.asarray(p.host_mesh.cells)               # (M, 3)
    area = h(sp.area)
    g = h(_phys_grads(sp))                              # (M,Q,n,2)
    qw = h(sp.quad_w)
    phi = h(sp.phi)                                     # (Q,n)
    qp = h(sp.quad_pts)
    lam = np.stack([1 - qp[:, 0] - qp[:, 1], qp[:, 0], qp[:, 1]], 1)
    M, nloc = cd.shape

    rows_v = np.repeat(cd[:, :, None], 3, axis=2).ravel()
    cols_p = np.repeat(cells[:, None, :], nloc, axis=1).ravel()
    # D_s[dof_a, vert_c] = 2 area_m sum_q qw lam[q,c] g[m,q,a,s]
    Dv = 2.0 * area[:, None, None, None] * np.einsum(
        "q,qc,mqas->macs", qw, lam, g)                  # (M,nloc,3,2)
    # E_s[dof_a, vert_c] = len_e sum_q w1d lam_e[q,c] phi_e[q,a] n_s
    ec = np.asarray(fd.edge_cell)
    le = np.asarray(fd.local_edge)
    lam_e = _edge_lambdas()[le]                         # (nb,Q,3)
    phi_e = np.asarray(fd.phi_edge)[le]                 # (nb,Q,nloc)
    Ev = np.asarray(fd.length)[:, None, None, None] * np.einsum(
        "q,bqc,bqa,bs->bacs", np.asarray(fd.w1d), lam_e, phi_e,
        np.asarray(fd.normal))                          # (nb,nloc,3,2)
    rows_e = np.repeat(cd[ec][:, :, None], 3, axis=2).ravel()
    cols_e = np.repeat(cells[ec][:, None, :], nloc, axis=1).ravel()
    # B_s[vert_c, dof_a] = D_s transposed entrywise;
    # G_s[dof_a, vert_c] = (2 area_m sum_q qw phi[q,a]) grads1[m,c,s]
    grads1 = np.asarray(p.host_mesh.grads)              # (M,3,2)
    phi_int = 2.0 * area[:, None] * np.einsum("q,qa->a", qw, phi)[None]
    Gv = phi_int[:, :, None, None] * grads1[:, None, :, :]
    out = {}
    for s in range(2):
        out.setdefault("DE", []).append((
            np.concatenate([rows_v, rows_e]),
            np.concatenate([cols_p, cols_e]),
            np.concatenate([Dv[..., s].ravel(), -Ev[..., s].ravel()])))
        out.setdefault("B", []).append((cols_p, rows_v, Dv[..., s].ravel()))
        out.setdefault("G", []).append((rows_v, cols_p, Gv[..., s].ravel()))
    return out


def _block_matvec(sp, blocks, x):
    """blocks (2,2,N,K), x (2,N) -> (2,N)."""
    return torch.stack([ell_matvec(sp, blocks[s, 0], x[0])
                        + ell_matvec(sp, blocks[s, 1], x[1])
                        for s in range(2)])


def step_buffers(p: StokesProblem, fd):
    """(aux, bufs): the operators a step reads, built once per problem.
    bufs: the ELL blocks and mass, the physical gradients, the momentum
    operator A_blocks = (rho/dt) diag(M2, M2) + visc/2 - mu edge/2 and, on
    the lattice backend, the lattice planes and the multigrid
    hierarchies; aux: the lattice plans and the hierarchies' metadata."""
    cfg = p.cfg
    sp = p.sp
    dt, mu, rho = p.dt, cfg.mu, cfg.rho
    zero = torch.zeros_like(p.M2)
    A_blocks = ((rho / dt) * torch.stack([torch.stack([p.M2, zero]),
                                          torch.stack([zero, p.M2])])
                + 0.5 * p.visc - 0.5 * mu * p.edge)
    bufs = {"M2": p.M2, "K1": p.K1, "visc": p.visc, "edge": p.edge,
            "g": _phys_grads(sp), "A": A_blocks}
    aux = {}
    if cfg.backend == "lattice":
        plan2 = lat.build_plan(p.vspace.dof_coords)
        plan1 = lat.build_plan(p.host_mesh.points)
        assert plan2.full and plan1.full   # P2/P1 on a rectangle mesh
        bufs["lop"] = [[lat.lattice_op(plan2, sp, A_blocks[s, d])
                        for d in range(2)] for s in range(2)]
        bufs["lK1"] = lat.lattice_op(plan1, p.mp, p.K1)
        bufs["lM2"] = lat.lattice_op(plan2, sp, p.M2)
        aux["plan2"], aux["plan1"] = plan2, plan1
        if cfg.multigrid:
            kw = dict(dtype=p.M2.dtype, device=p.M2.device)
            aux["mg1_static"], bufs["mg1"] = mgrid.build_mg(
                plan2, sp.patch_cols, sp.patch_mask,
                [[A_blocks[s, d] for d in range(2)] for s in range(2)],
                p.wall_mask, **kw)
            aux["mg2_static"], bufs["mg2"] = mgrid.build_mg(
                plan1, p.mp.patch_cols, p.mp.patch_mask, [[p.K1]],
                p.p_bc_mask, **kw)
    elif cfg.multigrid:
        raise NotImplementedError(
            "multigrid=True needs backend='lattice' or 'grid' (the V-cycle "
            "transfers are lattice-stencil ops; the gather-ELL backend keeps "
            "Jacobi-preconditioned Krylov)")
    return aux, bufs


def make_step(p: StokesProblem, fd, aux=None, bufs=None):
    """One IPCS step, ``(u_n, p_n) -> (u_new, p_new)``, over the operators
    of ``step_buffers`` (built here when not given)."""
    if bufs is None:
        aux, bufs = step_buffers(p, fd)
    cfg = p.cfg
    sp, mp = p.sp, p.mp
    dt, mu, rho = p.dt, cfg.mu, cfg.rho
    dtype, device = sp.area.dtype, sp.area.device
    wall = p.wall_mask
    g = bufs["g"]
    M2, K1, A_blocks = bufs["M2"], bufs["K1"], bufs["A"]
    phi = sp.phi
    qw = sp.quad_w
    # the P1 basis at the P2 quadrature points (barycentric coordinates)
    lam = torch.stack([1 - sp.quad_pts[:, 0] - sp.quad_pts[:, 1],
                       sp.quad_pts[:, 0], sp.quad_pts[:, 1]], dim=1)
    # the pressure boundary term's edge data
    t = lambda a, dt_=dtype: torch.as_tensor(np.asarray(a), dtype=dt_,
                                             device=device)
    e_cells = t(fd.edge_cell, torch.int64)
    e_len = t(fd.length)
    e_norm = t(fd.normal)
    e_loc = t(fd.local_edge, torch.int64)
    e_phi = t(fd.phi_edge)[e_loc]                         # (nb,Q,nloc)
    e_lam = t(_edge_lambdas())[e_loc]                     # (nb,Q,3)
    w1d = t(fd.w1d)
    e_pvert = mp.cells[e_cells]                           # (nb,3)
    e_dofs = sp.cell_dofs[e_cells].reshape(-1)            # (nb*nloc,)

    diag1 = torch.where(
        wall, 1.0,
        (rho / dt) * ell_diag(sp, M2)
        + 0.5 * ell_diag(sp, bufs["visc"][0, 0])
        - 0.5 * mu * ell_diag(sp, bufs["edge"][0, 0]))
    pre1 = jacobi_preconditioner(torch.stack([diag1, diag1]).reshape(-1))

    def A1_op(xflat):
        x = xflat.reshape(2, -1)
        x_in = torch.where(wall[None, :], 0.0, x)
        y = _block_matvec(sp, A_blocks, x_in)
        return torch.where(wall[None, :], x, y).reshape(-1)

    K1_diag = torch.where(p.p_bc_mask, 1.0, ell_diag(mp, K1))
    pre2 = jacobi_preconditioner(K1_diag)

    def A2_op(x):
        x_in = torch.where(p.p_bc_mask, 0.0, x)
        y = ell_matvec(mp, K1, x_in)
        return torch.where(p.p_bc_mask, x, y)

    M2_diag = ell_diag(sp, M2)

    def M_op(xflat):
        x = xflat.reshape(2, -1)
        return rho * torch.stack([
            ell_matvec(sp, M2, x[0]), ell_matvec(sp, M2, x[1])]).reshape(-1)

    preM = jacobi_preconditioner(
        rho * torch.stack([M2_diag, M2_diag]).reshape(-1))

    ki = cfg.krylov_iters

    def _bicg(op, b, x0, precond):
        if ki is not None:
            return bicgstab_fixed(op, b, x0=x0, precond=precond, iters=ki)
        return bicgstab(op, b, x0=x0, precond=precond, rtol=cfg.krylov_rtol)

    def _cg(op, b, x0, precond, mass=False, iters=None):
        it = iters if iters is not None else ki
        if it is not None:
            return cg_fixed(op, b, x0=x0, precond=precond,
                            iters=min(8, it) if mass else it)
        return cg(op, b, x0=x0, precond=precond, rtol=cfg.krylov_rtol)

    kip = auto_kip(cfg)

    # -- the backend's solves (dof-space vectors in and out) ----------------
    if cfg.backend == "lattice":
        plan2, plan1 = aux["plan2"], aux["plan1"]
        lop, lK1, lM2 = bufs["lop"], bufs["lK1"], bufs["lM2"]
        wg = lat.to_grid(plan2, wall)
        pbg = lat.to_grid(plan1, p.p_bc_mask)
        sh2 = (2, plan2.nI, plan2.nJ)
        pre1g = jacobi_preconditioner(torch.stack(
            [lat.to_grid(plan2, diag1, fill=1.0)] * 2).reshape(-1))
        pre2g = jacobi_preconditioner(
            lat.to_grid(plan1, K1_diag, fill=1.0).reshape(-1))
        mdg = lat.to_grid(plan2, M2_diag, fill=1.0)
        preMg = jacobi_preconditioner(
            (rho * torch.stack([mdg, mdg])).reshape(-1))
        if cfg.multigrid:
            pre1g = mgrid.preconditioner(aux["mg1_static"], bufs["mg1"])
            pre2g = mgrid.preconditioner(aux["mg2_static"], bufs["mg2"])

        def _g2(x):
            return torch.stack([lat.to_grid(plan2, x[0]),
                                lat.to_grid(plan2, x[1])])

        def _v2(y):
            return torch.stack([lat.from_grid(plan2, y[0]),
                                lat.from_grid(plan2, y[1])])

        def A1g(xflat):
            x = xflat.reshape(sh2)
            x_in = torch.where(wg[None], 0.0, x)
            y = torch.stack([lop[0][0](x_in[0]) + lop[0][1](x_in[1]),
                             lop[1][0](x_in[0]) + lop[1][1](x_in[1])])
            return torch.where(wg[None], x, y).reshape(-1)

        def A2g(xflat):
            x = xflat.reshape(plan1.nI, plan1.nJ)
            x_in = torch.where(pbg, 0.0, x)
            return torch.where(pbg, x, lK1(x_in)).reshape(-1)

        def Mg(xflat):
            x = xflat.reshape(sh2)
            return (rho * torch.stack([lM2(x[0]), lM2(x[1])])).reshape(-1)

        def solve_momentum(rhs, x0):
            sol = _bicg(A1g, _g2(rhs).reshape(-1), _g2(x0).reshape(-1),
                        pre1g)
            return _v2(sol.x.reshape(sh2))

        def solve_pressure(b2, x0):
            sol = _cg(A2g, lat.to_grid(plan1, b2).reshape(-1),
                      lat.to_grid(plan1, x0).reshape(-1), pre2g, iters=kip)
            return lat.from_grid(plan1, sol.x.reshape(plan1.nI, plan1.nJ))

        def solve_mass(b3, x0):
            sol = _cg(Mg, _g2(b3).reshape(-1), _g2(x0).reshape(-1), preMg,
                      mass=True)
            return _v2(sol.x.reshape(sh2))
    else:
        def solve_momentum(rhs, x0):
            return _bicg(A1_op, rhs.reshape(-1), x0.reshape(-1),
                         pre1).x.reshape(2, -1)

        def solve_pressure(b2, x0):
            return _cg(A2_op, b2, x0, pre2, iters=kip).x

        def solve_mass(b3, x0):
            return _cg(M_op, b3.reshape(-1), x0.reshape(-1), preM,
                       mass=True).x.reshape(2, -1)

    def conv_rhs(u):
        """rho (u . grad u) . v componentwise: (2,N)."""
        u_cell = u[:, sp.cell_dofs]                       # (2,M,n)
        u_q = torch.einsum("qc,smc->smq", phi, u_cell)    # (2,M,Q)
        gu = torch.einsum("smc,mqcd->smqd", u_cell, g)    # (2,M,Q,2)
        conv = torch.einsum("dmq,smqd->smq", u_q, gu)
        vals = 2.0 * sp.area[None, :, None] * torch.einsum(
            "q,smq,qa->sma", qw, conv, phi)
        return rho * torch.stack([apk.scatter_vector(sp, vals[0]),
                                  apk.scatter_vector(sp, vals[1])])

    def pressure_div_rhs(pn):
        """(D_m pn)_a = int pn d_m phi_a dx: (2,N)."""
        p_q = torch.einsum("qc,mc->mq", lam, pn[mp.cells])   # (M,Q)
        v = [2.0 * sp.area[:, None] * torch.einsum(
            "q,mq,mqa->ma", qw, p_q, g[..., d]) for d in range(2)]
        return torch.stack([apk.scatter_vector(sp, v[0]),
                            apk.scatter_vector(sp, v[1])])

    def pressure_edge_rhs(pn):
        """int pn n . v ds: (2,N), a scatter over the boundary edges."""
        p_q = torch.einsum("bqc,bc->bq", e_lam, pn[e_pvert])  # (nb,Q)
        base = e_len[:, None] * torch.einsum("q,bq,bqa->ba", w1d, p_q,
                                             e_phi)
        n2 = p.u0.shape[1]
        return torch.stack([
            torch.zeros(n2, dtype=dtype, device=device).index_add_(
                0, e_dofs, (base * e_norm[:, d:d + 1]).reshape(-1))
            for d in range(2)])

    def div_u_rhs(u):
        """int q div(u) dx for the P1 test q: (N1,)."""
        u_cell = u[:, sp.cell_dofs]
        div_q = (torch.einsum("mc,mqc->mq", u_cell[0], g[..., 0])
                 + torch.einsum("mc,mqc->mq", u_cell[1], g[..., 1]))
        vals = 2.0 * mp.area[:, None] * torch.einsum("q,mq,qc->mc", qw,
                                                     div_q, lam)
        return assembly.scatter_vector(mp, vals)

    def grad_p_rhs(dp):
        """int phi_a d_m dp dx, dp P1 (a constant gradient a cell)."""
        gp = torch.einsum("mc,mcd->md", dp[mp.cells], mp.grads)  # (M,2)
        phi_int = 2.0 * sp.area[:, None] * torch.einsum("q,qa->a", qw,
                                                        phi)[None]
        return torch.stack([apk.scatter_vector(sp, phi_int * gp[:, d:d + 1])
                            for d in range(2)])

    def M2_pair(u):
        return torch.stack([ell_matvec(sp, M2, u[0]),
                            ell_matvec(sp, M2, u[1])])

    def step(carry):
        u_n, p_n = carry
        # step 1: tentative velocity
        rhs = ((rho / dt) * M2_pair(u_n)
               - conv_rhs(u_n)
               - 0.5 * _block_matvec(sp, bufs["visc"], u_n)
               + 0.5 * mu * _block_matvec(sp, bufs["edge"], u_n)
               + pressure_div_rhs(p_n)
               - pressure_edge_rhs(p_n))
        rhs = torch.where(wall[None, :], 0.0, rhs)
        u_star = solve_momentum(rhs, u_n)
        # step 2: pressure Poisson
        b2 = ell_matvec(mp, K1, p_n) - (rho / dt) * div_u_rhs(u_star)
        g_ext = torch.where(p.p_bc_mask, p.p_bc_val, 0.0)
        b2 = b2 - ell_matvec(mp, K1, g_ext)
        b2 = torch.where(p.p_bc_mask, p.p_bc_val, b2)
        p_new = solve_pressure(b2, p_n)
        # step 3: velocity correction
        b3 = rho * M2_pair(u_star) - dt * grad_p_rhs(p_new - p_n)
        u_new = solve_mass(b3, u_star)
        return u_new, p_new

    return step


class StokesResult(NamedTuple):
    u: object      # (2,N2)
    p: object      # (N1,)
    error_l2: float
    dt: float
    num_steps: int


def exact_velocity(sp):
    """Poiseuille u = (4 y (1 - y), 0)."""
    y = sp.dof_coords[:, 1]
    return torch.stack([4.0 * y * (1.0 - y), torch.zeros_like(y)])


def solve(prob_fd=None, cfg: StokesConfig | None = None, device=None,
          **kw) -> StokesResult:
    """Build (when not given) and march cfg.num_steps steps from rest."""
    if prob_fd is None:
        prob_fd = build(cfg, device=device, **kw)
    p, fd = prob_fd
    if p.cfg.backend == "grid":
        return _solve_grid(p, fd)
    step = make_step(p, fd)
    carry = (p.u0, p.p0)
    for _ in range(p.cfg.num_steps):
        carry = step(carry)
    return _result(p, *carry)


def _result(p, u, pr):
    d = u - exact_velocity(p.sp)
    err = torch.sqrt(d[0] @ ell_matvec(p.sp, p.M2, d[0])
                     + d[1] @ ell_matvec(p.sp, p.M2, d[1]))
    return StokesResult(u, pr, float(err), p.dt, p.cfg.num_steps)


def _solve_grid(p, fd) -> StokesResult:
    """backend="grid": the fully gather-free step, the row-sharded step of
    parallel/stokes_sharded.py on one block: every right-hand-side term
    rides lattice planes and strided slices instead of ELL gathers and
    scatters."""
    from conservation_fem_tpu_torch.parallel.comm import LocalBlocks
    from conservation_fem_tpu_torch.parallel.stokes_sharded import \
        ShardedStokes

    u, pr = ShardedStokes(p, fd, LocalBlocks(1, p.u0.device)).solve()
    return _result(p, u, pr)
