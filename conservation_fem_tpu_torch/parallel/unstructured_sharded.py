"""Distributed ELL operators and solvers over a node partition with a halo
exchange, ported from conservation_fem_tpu/parallel/unstructured_sharded.py:
the unstructured-mesh scaling path (disk, irregular and imported meshes),
beside the structured-row decomposition of parallel/structured_sharded.py.

The partition is parallel/partition.py's: ``n_dev`` blocks of n_own
consecutive nodes, each with its ELL rows renumbered into its extended rows
[0, n_own + H) and the cells whose first node it owns. Where the JAX
classes run inside ``shard_map``, these take the blocks' owner
(parallel/comm.py): every tensor has a leading axis over the blocks held
here (all of them for ``LocalBlocks``, one for ``ProcessGroupBlocks``).
The ghost primitives (DOLFINx's, ref linear_advection.py:165,170):

  * the halo (scatter_forward): each block publishes its compact shared
    rows, ``blocks.gather`` gives every owner all published blocks, and a
    precomputed flat index picks each block's halo values: one all-gather
    per product;
  * the reverse add and max (ghostUpdate ADD / REVERSE): a block's sums
    into its halo rows go back the same way, one all-gather per assembly,
    and each owner adds (or takes the maximum of) what the other blocks
    accumulated at its shared rows, in block order;
  * every inner product is a per-block dot added in block order
    (``blocks.sum``), read on the host once per Krylov iteration by the
    adaptive solvers; the RV mean takes ``blocks.sum``, max|u - mean u|
    and the rv_cell normalisation ``blocks.max``.

The cell scatters are deterministic: a block's contributions are gathered
in an order sorted by target row (stable: cell order within a row, the
JAX package's scatter order on the CPU) and each row summed by
torch.segment_reduce, sequentially, as ops/assembly.py does. On the card
an ``index_add_`` would add a row's contributions atomically in no fixed
order, so two runs, and LocalBlocks against ranks of a process group,
would not agree bit for bit.

Pad rows (the last block's rows past the mesh) are pinned Dirichlet rows
with valid = False; every step starts by zeroing them in the carry, and
the Dirichlet data are formed on the real boundary rows only, so nothing
a pad row holds reaches an owned row. Where the JAX classes differentiate
the flux with ``jax.jvp``, these take ``Flux.fprime2_xy``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from conservation_fem_tpu_torch import get_device
from conservation_fem_tpu_torch.ops import assembly
from conservation_fem_tpu_torch.ops.helpers import get_nodal_h_ell
from conservation_fem_tpu_torch.ops.krylov import (bicgstab, cg,
                                                   jacobi_preconditioner)
from conservation_fem_tpu_torch.ops.newton import newton_solve
from conservation_fem_tpu_torch.ops.spmv import ell_diag, ell_matvec
from conservation_fem_tpu_torch.ops.stabilization import sigmoid_activation
from conservation_fem_tpu_torch.ops.structured import tiny_of
from conservation_fem_tpu_torch.parallel.partition import (
    Partition, build_cell_partition, build_partition)


def _ordered_sum(x):
    """x[..., 0] + x[..., 1] + ... in that order."""
    acc = x[..., 0]
    for r in range(1, x.shape[-1]):
        acc = acc + x[..., r]
    return acc


def segment_order(targets, n_segments, valid=None):
    """(order, lengths) of a deterministic scatter: the flat positions of
    the (valid) entries of ``targets`` sorted by target (stable: their own
    order within a target), and each of the n_segments targets' count."""
    t = targets.reshape(-1)
    pos = (np.arange(t.size) if valid is None
           else np.nonzero(valid.reshape(-1))[0])
    order = pos[np.argsort(t[pos], kind="stable")]
    return order, np.bincount(t[pos], minlength=n_segments)


class DistributedELL:
    """A row-partitioned ELL operator with its halo exchange, on the
    blocks of ``blocks`` (device: the blocks', for ProcessGroupBlocks the
    one given, None the card). ELL values and vectors are in the blocks'
    layout, (blocks held, n_own, K) and (blocks held, n_own):
    ``pad_ell`` / ``pad_vec`` make it from global rows, ``unpad_rows``
    gives the global rows back."""

    def __init__(self, part: Partition, blocks, dtype=torch.float64,
                 device=None):
        held_dev = getattr(blocks, "device", None)
        self.device = get_device(device if device is not None else held_dev)
        if held_dev is not None and held_dev.type != self.device.type:
            raise ValueError(f"blocks on {held_dev}, problem on "
                             f"{self.device}")
        self.part, self.blocks, self.dtype = part, blocks, dtype
        self.n_dev, self.n_own = part.n_dev, part.n_own
        self.H, self.S, self.K = (part.halo_size, part.shared_size,
                                  part.mesh.max_patch)
        self.n = part.mesh.n_nodes
        if blocks.n_dev != part.n_dev:
            raise ValueError(f"a partition of {part.n_dev} blocks on "
                             f"{blocks.n_dev}")
        self._held = list(blocks.ranks)
        self.local_cols = self._put(part.local_cols)
        self.local_mask = self._put(part.local_mask)
        self.shared_idx = self._put(part.shared_idx)
        self.halo_src = self._put(part.halo_src)
        self.row_valid = self._put(part.global_rows >= 0)
        # the ELL slot of each own row's diagonal (the global row's)
        self._diag_slot = self._put(self._pad_host(part.mesh.diag_slot, 0))

    # -- layout ---------------------------------------------------------------

    def _put(self, a, dtype=None):
        """The held blocks' part of a per-block host array, on the device."""
        return torch.as_tensor(np.ascontiguousarray(a[self._held]),
                               dtype=dtype, device=self.device)

    def _pad_host(self, a, fill):
        """(n, ...) host rows -> (n_dev, n_own, ...), pads ``fill``."""
        a = np.asarray(a)
        pad = np.full((self.part.n_total - self.n,) + a.shape[1:], fill,
                      dtype=a.dtype)
        return np.concatenate([a, pad]).reshape(
            (self.n_dev, self.n_own) + a.shape[1:])

    def _rows(self, x, fill=0.0):
        """(n, ...) global rows (a tensor) -> the held blocks' (blocks,
        n_own, ...), the pad rows ``fill`` (a tensor: its rows)."""
        x = torch.as_tensor(x, device=self.device)
        pad_n = self.part.n_total - self.n
        if isinstance(fill, torch.Tensor):
            pad = fill.to(x.dtype).expand((pad_n,) + tuple(x.shape[1:]))
        else:
            pad = x.new_full((pad_n,) + tuple(x.shape[1:]), fill)
        full = torch.cat([x, pad]).reshape(
            (self.n_dev, self.n_own) + tuple(x.shape[1:]))
        return full[self._held].contiguous()

    def pad_ell(self, A_ell):
        """(n, K) ELL values -> (blocks held, n_own, K), zero pad rows."""
        return self._rows(A_ell.to(self.dtype))

    def pad_vec(self, v, fill=0.0):
        """(n,) global vector -> (blocks held, n_own)."""
        v = torch.as_tensor(v, device=self.device)
        return self._rows(v if v.dtype == torch.bool else v.to(self.dtype),
                          fill)

    pad_rows = pad_vec

    def unpad_rows(self, x_rows):
        """The blocks' layout (all blocks, gathered) -> the (n,) global
        rows."""
        return self.blocks.gather(x_rows).reshape(-1)[:self.n]

    # -- halo and products ----------------------------------------------------

    def _halo(self, x):
        """x (blocks, n_own) -> (blocks, n_own + H): each block's own rows
        and then its halo rows (one all-gather of the published rows)."""
        published = x.gather(1, self.shared_idx)
        table = self.blocks.gather(published).reshape(-1)
        return torch.cat([x, table[self.halo_src]], dim=1)

    def _patch(self, xe):
        """The (blocks, n_own, K) patch values of the extended rows xe."""
        nb = xe.shape[0]
        return xe.gather(1, self.local_cols.reshape(nb, -1)).reshape(
            self.local_cols.shape)

    def _spmv(self, A, x, xe=None):
        """A (blocks, n_own, K) times x (blocks, n_own), xe: x's halo'd
        rows when the caller has them."""
        return (A * self._patch(self._halo(x) if xe is None else xe)).sum(-1)

    def _diag(self, A):
        return A.gather(2, self._diag_slot[..., None])[..., 0]

    def _pdot(self, a, b):
        """The inner product over all blocks: per-block sums added in block
        order."""
        return self.blocks.sum((a * b).sum(dim=1)).reshape(())

    def _constrained(self, A, pin):
        """x -> A x with the pinned rows and columns the identity."""
        def mv(x):
            return torch.where(pin, x, self._spmv(A, torch.where(pin, 0.0, x)))
        return mv

    # -- public: sharded SpMV and CG ------------------------------------------

    def sharded_spmv(self, A_rows, x_rows):
        """A_rows (blocks held, n_own, K) times x_rows (blocks held,
        n_own)."""
        return self._spmv(A_rows, x_rows)

    def solve_cg(self, A_rows, b_rows, bc_rows, diag_rows, rtol=1e-12,
                 maxiter=1000):
        """Distributed constrained CG: rows and columns pinned at bc (and
        at the pad rows), block-ordered dots."""
        pin = bc_rows | ~self.row_valid
        pre = jacobi_preconditioner(torch.where(pin, 1.0, diag_rows))
        return cg(self._constrained(A_rows, pin),
                  torch.where(pin & ~bc_rows, 0.0, b_rows), precond=pre,
                  rtol=rtol, maxiter=maxiter, dot=self._pdot).x


def distributed_poisson_demo(mesh, blocks, rtol=1e-12, device=None):
    """The constrained Poisson problem of the single-device tests (data
    x^2 - y^2 on the boundary) solved on a node partition of the
    RCM-ordered mesh: (that mesh, the solution, the data), both (n,)
    tensors."""
    part = build_partition(mesh, blocks.n_dev)
    dist = DistributedELL(part, blocks, device=device)
    m = part.mesh.device_arrays(torch.float64, dist.device)
    K = assembly.assemble_stiffness(m)
    bc = m.boundary_mask
    g = m.points[:, 0] ** 2 - m.points[:, 1] ** 2
    b = torch.where(bc, g, -ell_matvec(m, K, torch.where(bc, g, 0.0)))
    x = dist.solve_cg(dist.pad_ell(K), dist.pad_vec(b),
                      dist.pad_vec(bc, False), dist.pad_vec(ell_diag(m, K)),
                      rtol=rtol)
    return part.mesh, dist.unpad_rows(x), g


class DistributedUnstructured(DistributedELL):
    """The shared infrastructure of the fully distributed unstructured
    solvers: node-partitioned rows, cell-partitioned assembly with its
    deterministic orderings, the halo and reverse exchanges, and the
    static fields in the blocks' layout (mass rows, nodal h, the boundary
    mask, the points). Subclasses add their operators and the step.

    The mesh is partitioned without reordering: the problem was built on
    it. ``partition_seconds``: the host time of the two partition builds.
    arrays, mass, h: the mesh's tensors, its ELL mass and nodal h on the
    device, when the caller has them (else built here)."""

    def __init__(self, host_mesh, blocks, dtype=torch.float64, device=None,
                 *, arrays=None, mass=None, h=None):
        t0 = time.perf_counter()
        part = build_partition(host_mesh, blocks.n_dev, reorder=False)
        t1 = time.perf_counter()
        cpart = build_cell_partition(part)
        t2 = time.perf_counter()
        super().__init__(part, blocks, dtype, device)
        self.cpart = cpart
        self.partition_seconds = dict(build_partition=t1 - t0,
                                      build_cell_partition=t2 - t1)
        n_own, H, K = self.n_own, self.H, self.K
        self.E = E = n_own + H
        self.cells_ext = self._put(cpart.cells_ext)
        self.cell_valid = self._put(cpart.cell_valid)
        self.careas = self._put(cpart.area, dtype)
        self.cgrads = self._put(cpart.grads, dtype)
        self.ch = self._put(cpart.h, dtype)
        self.rev_src = self._put(cpart.rev_src)
        self.rev_mask = self._put(cpart.rev_mask)
        # where an owner adds what comes back for each published slot: its
        # row, or (a pad slot, which nothing comes back to) the row n_own,
        # the first halo row, which the reverse exchange drops
        self._rev_tgt = torch.where(self.rev_mask.any(-1), self.shared_idx,
                                    n_own)
        # the deterministic scatter orderings of the held blocks' cells
        held = self._held
        nb = len(held)
        ce = cpart.cells_ext[held]
        base = (np.arange(nb) * E)[:, None, None]
        valid = np.broadcast_to(cpart.cell_valid[held][..., None], ce.shape)
        order, lens = segment_order(base + ce, nb * E, valid)
        self._vec_order = torch.as_tensor(order, device=self.device)
        self._vec_lens = torch.as_tensor(lens, device=self.device)
        mat_t = ((base[..., None] + ce[..., None]) * K
                 + cpart.cell_slots[held])
        valid = np.broadcast_to(cpart.cell_valid[held][..., None, None],
                                mat_t.shape)
        order, lens = segment_order(mat_t, nb * E * K, valid)
        self._mat_order = torch.as_tensor(order, device=self.device)
        self._mat_lens = torch.as_tensor(lens, device=self.device)
        # the static fields
        m = arrays if arrays is not None else host_mesh.device_arrays(
            dtype, self.device)
        M = mass if mass is not None else assembly.assemble_mass(m)
        self.M_rows = self.pad_ell(M)
        if h is None:
            h = get_nodal_h_ell(m, mass_ell=M)
        self.h_rows = self.pad_vec(h)
        self.bc_rows = self.pad_vec(m.boundary_mask, True)
        # pad rows repeat node 0's point (pinned rows that read nothing)
        self.pts_rows = self._rows(m.points.to(dtype), m.points[0].to(dtype))
        self._frame = torch.nonzero(
            (self.bc_rows & self.row_valid).reshape(-1))[:, 0]
        self._g = torch.zeros(self.bc_rows.shape, dtype=dtype,
                              device=self.device)

    # -- cells ----------------------------------------------------------------

    def _cell_values(self, xe):
        """(blocks, C, 3): the extended rows xe at each cell's nodes."""
        nb = xe.shape[0]
        return xe.gather(1, self.cells_ext.reshape(nb, -1)).reshape(
            self.cells_ext.shape)

    def _flat_cells(self, *xs):
        """Cell arrays (blocks, C, ...) as (blocks * C, ...)."""
        return [x.reshape((-1,) + tuple(x.shape[2:])) for x in xs]

    # -- reverse exchange -----------------------------------------------------

    def _incoming(self, ext, fill):
        """(blocks, S, R[, K]): what the other blocks accumulated at each
        of this block's published rows (``fill`` where none)."""
        halo = ext[:, self.n_own:]
        table = self.blocks.gather(halo).reshape((-1,) + tuple(ext.shape[2:]))
        picked = table[self.rev_src]
        mask = self.rev_mask.reshape(self.rev_mask.shape
                                     + (1,) * (ext.dim() - 2))
        return torch.where(mask, picked, fill)

    def _rev_index(self, ext):
        return self._rev_tgt.reshape(self._rev_tgt.shape
                                     + (1,) * (ext.dim() - 2)).expand(
            (-1, -1) + tuple(ext.shape[2:]))

    def _reverse_add_vec(self, ext):
        """(blocks, n_own + H) sums -> (blocks, n_own): the halo rows'
        sums added into their owners' rows (ghostUpdate ADD/REVERSE), the
        contributions of the other blocks in block order."""
        incoming = _ordered_sum(self._incoming(ext, 0.0))
        return ext.scatter_add(1, self._rev_tgt, incoming)[:, :self.n_own]

    def _reverse_max_vec(self, ext):
        """The maximum counterpart of _reverse_add_vec (rv_cell's
        order-independent scatter)."""
        incoming = self._incoming(ext, -np.inf).amax(-1)
        return ext.scatter_reduce(1, self._rev_tgt, incoming,
                                  "amax")[:, :self.n_own]

    def _reverse_add_mat(self, ext):
        """(blocks, n_own + H, K) ELL rows -> (blocks, n_own, K)."""
        incoming = _ordered_sum(self._incoming(ext, 0.0).transpose(-1, -2))
        return ext.scatter_add(1, self._rev_index(ext),
                               incoming)[:, :self.n_own]

    def _assemble_vec(self, cell_vals):
        """(blocks, C, 3) cell vectors -> (blocks, n_own) assembled rows."""
        flat = cell_vals.reshape(-1)[self._vec_order]
        ext = torch.segment_reduce(flat, "sum", lengths=self._vec_lens,
                                   unsafe=True).reshape(-1, self.E)
        return self._reverse_add_vec(ext)

    def _assemble_mat(self, cell_vals):
        """(blocks, C, 3, 3) cell matrices -> (blocks, n_own, K) ELL rows."""
        flat = cell_vals.reshape(-1)[self._mat_order]
        ext = torch.segment_reduce(flat, "sum", lengths=self._mat_lens,
                                   unsafe=True).reshape(-1, self.E, self.K)
        return self._reverse_add_mat(ext)

    def _keps(self, eps, ee=None):
        """The eps-weighted stiffness rows (eps: valid rows only)."""
        ee = self._halo(eps) if ee is None else ee
        area, grads, e = self._flat_cells(self.careas, self.cgrads,
                                          self._cell_values(ee))
        return self._assemble_mat(assembly.local_eps_stiffness(
            area, grads, e).reshape(self.cgrads.shape[:2] + (3, 3)))

    def _patch_reduce(self, x, reducer, pad_val):
        """Reduce x over each own row's patch (halo'd; pad rows and masked
        slots take pad_val)."""
        xe = self._halo(torch.where(self.row_valid, x, pad_val))
        g = torch.where(self.local_mask, self._patch(xe), pad_val)
        return reducer(g, dim=-1)

    def _mean_dev(self, u, fill):
        """(u - mean u) on the valid rows, ``fill`` elsewhere; the mean by
        blocks.sum of the per-block sums."""
        s = self.blocks.sum(torch.where(self.row_valid, u, 0.0).sum(dim=1))
        return torch.where(self.row_valid, u - s / self.n, fill)

    def _rv_eps(self, u, Rh, beta):
        """RV epsilon min(Cvel h beta, CRV h^2 |Rh_i / n_i|): beta the
        wavespeed at the row (nonlinear: its patch maximum, given)."""
        cfg, h = self.p.cfg, self.h_rows
        abs_term = self.blocks.max(self._mean_dev(u, 0.0).abs().amax(dim=1))
        u_max = self._patch_reduce(u, torch.amax, -np.inf)
        u_min = self._patch_reduce(u, torch.amin, np.inf)
        n_i = ((u_max - u_min) - abs_term).abs()
        Rh_i = self._patch_reduce(Rh.abs(), torch.amax, -np.inf)
        return torch.minimum(
            cfg.Cvel * h * beta,
            cfg.CRV * h ** 2 * (Rh_i / n_i.clamp_min(tiny_of(u.dtype))).abs())

    def _si_eps(self, u, Kbc, beta):
        """SI epsilon psi(alpha) Cm h beta over the halo'd patch."""
        cfg = self.p.cfg
        dup = self._patch(self._halo(u)) - u[..., None]
        mask = self.local_mask
        num = torch.where(mask, Kbc * dup, 0.0).sum(-1).abs()
        den = torch.where(mask, Kbc.abs() * dup.abs(), 0.0).sum(-1)
        alpha = num / den.clamp_min(cfg.si_eps)
        return sigmoid_activation(alpha) * cfg.Cm * self.h_rows * beta

    def _mass_solve(self, rhs, pin):
        """M x = rhs with the pinned rows 0, adaptive CG to krylov_rtol."""
        M = self.M_rows
        pre = jacobi_preconditioner(torch.where(pin, 1.0, self._diag(M)))
        return cg(self._constrained(M, pin), torch.where(pin, 0.0, rhs),
                  precond=pre, rtol=self.p.cfg.krylov_rtol,
                  dot=self._pdot).x

    def _dirichlet_frames(self, times):
        """(len(times), boundary rows held): the Dirichlet data at each
        time, on the real boundary rows only, from one bc_value call."""
        t = torch.tensor(times, dtype=self.dtype, device=self.device)
        pts = self.pts_rows.reshape(-1, 2)[self._frame]
        g = self.p.bc_value(pts, t[:, None])
        return torch.broadcast_to(g, (len(times), self._frame.numel()))

    def _dirichlet(self, frame_values):
        """One step's Dirichlet data in the blocks' layout, zero off the
        boundary rows (the pad rows too)."""
        self._g.view(-1).index_copy_(0, self._frame, frame_values)
        return self._g


class DistributedHyperbolic(DistributedUnstructured):
    """The fully distributed unstructured scalar conservation law (KPP,
    Burgers, any HyperbolicProblem on the ELL gather backend): node rows,
    cell-partitioned assembly with the reverse halo exchange,
    block-ordered Krylov dots, the JAX class's step:

      * stabilization rv | si | gfem (SI reads the halo'd bc-applied
        stiffness rows, ref SI.py:50-61);
      * residual scheme bdf2 | bdf1 (rv only: si and gfem read no
        residual);
      * Dirichlet data bc_value(points, t) on each block's own boundary
        rows at t = (k + 1) dt (Burgers' exact solution);
      * post-solve patch smoothing (smooth_l > 0).

    It reads the config's stabilization, residual_scheme, krylov_rtol,
    newton_rtol, newton_atol, newton_max_it, newton_linear_rtol,
    modified_newton, Cvel, CRV, Cm, si_eps and smooth_l, and, like the JAX
    class, ignores cg_iters, newton_iters, newton_linear_iters,
    inner_solver, the Chebyshev bounds, newton_final_residual,
    precise_reductions, use_kernels, fused_substeps and record_metrics:
    its solvers are the adaptive ones. ``solve()`` returns the flat global
    solution (a tensor on the problem's device).

    blocks: LocalBlocks or ProcessGroupBlocks on the problem's device.
    """

    def __init__(self, problem, blocks):
        p = problem
        if (getattr(p, "sd", None) is not None
                or p.cfg.ell_matvec_backend in ("blocked", "blocked2d")):
            raise ValueError("the distributed solver needs a problem on the "
                             "ELL backend (gather, lattice or banded)")
        super().__init__(p.host_mesh, blocks, dtype=p.dtype, device=p.device,
                         arrays=p.mesh, mass=p.M,
                         h=p.h_cg if p.cfg.stabilization in ("rv", "si")
                         else None)
        self.p = p
        self.u0_rows = self.pad_vec(p.u0)
        self.Kbc_rows = (self.pad_ell(p.K_bc) if p.cfg.stabilization == "si"
                         else None)

    def _nl_rhs(self, xe):
        """N(x) = int (f'(x) . grad x) phi_a from x's halo'd rows xe."""
        area, grads, xc = self._flat_cells(self.careas, self.cgrads,
                                           self._cell_values(xe))
        r = assembly.local_convection_rhs(area, grads, xc, self.p.flux)
        return self._assemble_vec(r.reshape(self.cells_ext.shape))

    def _flux_jac(self, x):
        area, grads, xc = self._flat_cells(
            self.careas, self.cgrads, self._cell_values(self._halo(x)))
        J = assembly.local_flux_jacobian(area, grads, xc, self.p.flux)
        return self._assemble_mat(J.reshape(self.cgrads.shape[:2] + (3, 3)))

    def make_step(self):
        """step(u, uo, uoo, g) -> (u_new, u, uo) on the blocks held here,
        each (blocks, n_own); g: the step's Dirichlet data (zero off the
        boundary rows)."""
        p = self.p
        cfg, dt, flux = p.cfg, p.dt, p.flux
        M, valid, bc = self.M_rows, self.row_valid, self.bc_rows
        pin = bc | ~valid
        spmv = self._spmv

        def step(u, uo, uoo, g):
            u, uo, uoo = (torch.where(valid, x, 0.0) for x in (u, uo, uoo))
            ue = self._halo(u)
            N_un = self._nl_rhs(ue)
            if cfg.stabilization == "rv":
                if cfg.residual_scheme == "bdf1":
                    du = (u - uo) / dt
                else:
                    du = (3.0 * u - 4.0 * uo + uoo) / (2.0 * dt)
                RH = self._mass_solve(spmv(M, du) + N_un, pin)
                beta = self._patch_reduce(flux.fprime_norm(u), torch.amax,
                                          -np.inf)
                eps = self._rv_eps(u, RH, beta)
            elif cfg.stabilization == "si":
                eps = self._si_eps(u, self.Kbc_rows, flux.fprime_norm(u))
            else:
                eps = torch.zeros_like(u)
            eps = torch.where(valid, eps, 0.0)
            Kc = self._keps(eps)
            Kc_un = spmv(Kc, u, ue)
            base = M + 0.5 * dt * Kc

            def residual(v):
                ve = self._halo(v)
                F = (spmv(M, v - u)
                     + 0.5 * dt * (self._nl_rhs(ve) + N_un)
                     + 0.5 * dt * (spmv(Kc, v, ve) + Kc_un))
                return torch.where(pin, v - g, F)

            def jacobian(v):
                J = base + 0.5 * dt * self._flux_jac(v)
                pre = jacobi_preconditioner(torch.where(pin, 1.0,
                                                        self._diag(J)))
                return self._constrained(J, pin), pre

            uh = newton_solve(
                residual, torch.where(pin, g, u), rtol=cfg.newton_rtol,
                atol=cfg.newton_atol, max_it=cfg.newton_max_it,
                linear_rtol=cfg.newton_linear_rtol or cfg.krylov_rtol,
                jacobian_fn=jacobian, freeze_jacobian=cfg.modified_newton,
                dot=self._pdot).u
            if cfg.smooth_l > 0:
                # Jacobi patch smoothing over the halo'd patch
                # (ref Exact_Burger_SI.py:193)
                mask = self.local_mask
                total = torch.where(mask, self._patch(self._halo(uh)),
                                    0.0).sum(-1)
                d = (mask.sum(-1).to(uh.dtype) - 1.0).clamp_min(1.0)
                lv = cfg.smooth_l
                uh = (total - uh + (lv - 1.0) * d * uh) / (lv * d)
                uh = torch.where(valid, uh, 0.0)
            return uh, u, uo

        return step

    def solve(self, num_steps=None):
        """Run the time loop from u0 (its first num_steps steps; None: all
        of them); the flat global solution."""
        step = self.make_step()
        times = self.p.step_times(0)[:num_steps]
        frames = self._dirichlet_frames(times)
        carry = (self.u0_rows,) * 3
        for k in range(len(times)):
            carry = step(*carry, self._dirichlet(frames[k]))
        return self.unpad_rows(carry[0])


# the JAX package's name for the class (its first form was KPP's)
DistributedKPP = DistributedHyperbolic


class DistributedAdvection(DistributedUnstructured):
    """Fully distributed linear advection (models/linear_advection.py):
    Crank-Nicolson with gfem | rv_node | si | rv_cell stabilization, or
    explicit rk4, homogeneous Dirichlet data. rv_node and rv_cell start
    with one plain GFEM step, as the single-device solve does (ref
    RV_cell.py:142-160); rv_cell scatters its cell viscosity by the
    order-independent maximum, the single-device rv_cell_scatter="max".
    It reads stabilization, krylov_rtol, Cvel, CRV, Cm and si_eps; its
    solvers are adaptive (cg_iters, krylov_iters, inner_solver and the
    Chebyshev bounds are ignored, as in the JAX class). ``solve()``
    returns the flat global solution."""

    STABILIZATIONS = ("gfem", "rv_node", "si", "rv_cell", "rk4")

    def __init__(self, problem, blocks):
        p = problem
        if p.cfg.stabilization not in self.STABILIZATIONS:
            raise NotImplementedError(
                f"distributed advection: {p.cfg.stabilization!r}")
        if p.plan is not None or p.cfg.ell_matvec_backend != "gather":
            raise ValueError("the distributed solver needs a problem on the "
                             "ELL gather backend")
        super().__init__(p.host_mesh, blocks, dtype=p.u0.dtype,
                         device=p.u0.device, arrays=p.mesh, mass=p.M,
                         h=p.h_cg)
        self.p = p
        self.u0_rows = self.pad_vec(p.u0)
        self.C_rows = self.pad_ell(p.C)
        self.beta_rows = self.pad_vec(torch.linalg.norm(p.w, dim=1))
        self.Kbc_rows = (self.pad_ell(p.K_bc)
                         if p.cfg.stabilization == "si" else None)

    def _bdf1_residual(self, u, uo, pin):
        """M Rh = M (u - uo)/dt + C u, Rh|pin = 0 (ref RV_cell.py:169-174)."""
        rhs = (self._spmv(self.M_rows, (u - uo) / self.p.dt)
               + self._spmv(self.C_rows, u))
        return self._mass_solve(rhs, pin)

    def _rv_cell_eps(self, u, Rh):
        """Cell RV (ref RV_cell.py:169-195): the plain maximum of u - mean
        u normalises, eps_k per cell, scattered to the nodes by the
        maximum (order-independent: the cells of a node may lie in several
        blocks)."""
        cfg, valid = self.p.cfg, self.row_valid
        norm = self.blocks.max(self._mean_dev(u, -np.inf).amax(dim=1))
        Rc = self._cell_values(self._halo(
            torch.where(valid, (Rh / norm).abs(), 0.0))).amax(-1)
        bc_ = self._cell_values(self._halo(
            torch.where(valid, self.beta_rows, 0.0))).amax(-1)
        hc = self.ch
        eps_k = torch.minimum(cfg.Cvel * hc * bc_, cfg.CRV * hc ** 2 * Rc)
        eps_k = torch.where(self.cell_valid, eps_k, -np.inf)
        nb = u.shape[0]
        ext = torch.full((nb, self.E), -np.inf, dtype=u.dtype,
                         device=u.device).scatter_reduce(
            1, self.cells_ext.reshape(nb, -1),
            eps_k[..., None].expand(-1, -1, 3).reshape(nb, -1), "amax")
        eps = self._reverse_max_vec(ext)
        return torch.where(torch.isfinite(eps), eps, 0.0)

    def make_step(self, stabilization: str):
        """step(u, uo) -> (u_new, u) on the blocks held here."""
        cfg, dt = self.p.cfg, self.p.dt
        M, C = self.M_rows, self.C_rows
        valid, bc = self.row_valid, self.bc_rows
        pin = bc | ~valid
        spmv = self._spmv

        def step(u, uo):
            u, uo = torch.where(valid, u, 0.0), torch.where(valid, uo, 0.0)
            if stabilization == "rk4":
                # M k = -C u_stage with k|bc = 0 per stage (ref
                # GFEM_RK4.py:134-218)
                def stage(v):
                    return self._mass_solve(-spmv(C, v), pin)

                k1 = stage(u)
                k2 = stage(u + 0.5 * dt * k1)
                k3 = stage(u + 0.5 * dt * k2)
                k4 = stage(u + dt * k3)
                uh = u + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
                return torch.where(bc, 0.0, uh), u
            if stabilization == "rv_node":
                Rh = self._bdf1_residual(u, uo, pin)
                eps = self._rv_eps(u, Rh, self.beta_rows)
            elif stabilization == "si":
                eps = self._si_eps(u, self.Kbc_rows, self.beta_rows)
            elif stabilization == "rv_cell":
                eps = self._rv_cell_eps(u, self._bdf1_residual(u, uo, pin))
            else:
                eps = None
            CK = C if eps is None else C + self._keps(
                torch.where(valid, eps, 0.0))
            A = M + 0.5 * dt * CK
            B = M - 0.5 * dt * CK
            b = torch.where(pin, 0.0, spmv(B, u))
            pre = jacobi_preconditioner(torch.where(pin, 1.0, self._diag(A)))
            # x0 = u, as the single-device CN solve starts
            uh = bicgstab(self._constrained(A, pin), b, x0=u, precond=pre,
                          rtol=cfg.krylov_rtol, dot=self._pdot).x
            return uh, u

        return step

    def solve(self, num_steps=None):
        """The problem's num_steps steps from u0 (or the first num_steps
        of them), the GFEM bootstrap first for rv_node and rv_cell; the
        flat global solution."""
        stab = self.p.cfg.stabilization
        step = self.make_step(stab)
        n = self.p.num_steps if num_steps is None else num_steps
        carry = (self.u0_rows, self.u0_rows)
        if stab in ("rv_node", "rv_cell") and n > 0:
            carry, n = self.make_step("gfem")(*carry), n - 1
        for _ in range(n):
            carry = step(*carry)
        return self.unpad_rows(carry[0])
