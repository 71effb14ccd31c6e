"""Stabilised time step swept in tiles: the Hopper kernel
(csrc/tiled_step.cu) and its plain PyTorch version.

Port of conservation_fem_tpu/ops/pallas_tiled.py. ``tiled_rv_step`` runs
one step of the same algorithm as ops/fused_step.fused_rv_step in one
cooperative launch whose sweeps stage the fields read at neighbours, tile
by tile, in shared memory; it returns u_{n+1}. The plain version is the
fused step's plain version (``fused_step._step_body_plain``): the tiling
changes where the work runs, not what it computes.

Block mode (``row0_base`` given): the fields are a deep-halo row block of
a taller (n_rows, n1y) grid that starts at global row ``row0_base``, the
per-block kernel of parallel/structured_fused_sharded.py for blocks of
any size. ``abs_term`` = max|u - mean u| over the whole grid comes from
the caller, the inner solver is Chebyshev, and the whole block comes
back (zero on rows outside the grid; only the owned rows equal the
whole-grid step's). Its plain version is ``fused_step.block_step_plain``,
that of fused_rv_block_step.

Tile geometry is chosen here, where the CPU tests reach it: a tile is
``tile_rows`` rows (the JAX meaning) by at most MAX_TILE_COLS columns,
fewer when the staged fields would not fit STAGE_BYTES of shared memory.
The TPU kernel's Mosaic geometry (8-row halo alignment, 128-lane padding,
HBM pad rows, the 24 MB VMEM budget of its default_tile_rows, the
CFT_TILE_ROWS override) has no counterpart and is not ported. Not ported:
``bf16_planes``.
"""

from __future__ import annotations

import torch

from conservation_fem_tpu_torch.ops import _build
from conservation_fem_tpu_torch.ops import fused_step as fs

STAGED = 3            # csrc/tiled_step.cu kStaged
STAGE_BYTES = 160 * 1024
MAX_TILE_COLS = 64


def tile_geometry(n1x, n1y, itemsize, tile_rows):
    """(rows, cols) of a tile: ``tile_rows`` rows by columns that split
    the row into equal tiles of at most MAX_TILE_COLS, fewer if the staged
    fields with their one-node halo would exceed STAGE_BYTES."""
    rows = int(tile_rows)
    if rows < 1:
        raise ValueError(f"tile_rows must be positive, not {tile_rows}")
    cols = -(-n1y // -(-n1y // MAX_TILE_COLS))
    fit = STAGE_BYTES // (STAGED * (rows + 2) * itemsize) - 2
    if fit < 1:
        raise ValueError(f"tile_rows {rows}: the staged tile does not fit "
                         f"{STAGE_BYTES} bytes of shared memory")
    return rows, min(cols, fit)


def default_tile_rows(n1x, n1y, itemsize, n_sm):
    """Rows per tile on a card of n_sm streaming multiprocessors: of 64,
    32, 16 and 8, the one with the least rounds x staged tile area, where a
    round is one tile for each of the n_sm resident blocks (one per SM) and
    the area counts the halo — a sweep lasts as long as its busiest block,
    and a smaller tile trades fewer idle blocks in the last round for more
    halo. Ties go to the larger tile."""
    def cost(rows):
        r, c = tile_geometry(n1x, n1y, itemsize, rows)
        tiles = -(-n1x // r) * -(-n1y // c)
        return -(-tiles // n_sm) * (r + 2) * (c + 2)

    return min((64, 32, 16, 8), key=cost)


def _check_tiled_options(inner_solver, bf16_planes):
    if inner_solver not in ("cheby", "bicgstab"):
        raise NotImplementedError(
            "tiled_rv_step inner_solver must be 'cheby' or 'bicgstab'")
    if bf16_planes:
        raise NotImplementedError(
            "tiled_rv_step bf16_planes is not ported (ROADMAP queue 2 item "
            "5, only if the H100 measures a reason)")


def _args(u2, step, inner_solver, row0_base, n_rows, abs_term):
    """The step arguments of a call, checked; block mode when row0_base is
    given (n_rows None: the block's own row count)."""
    if row0_base is None:
        if n_rows is not None or abs_term is not None:
            raise ValueError("tiled_rv_step: n_rows and abs_term belong to "
                             "block mode, which row0_base selects")
        return fs.step_args("tiled_rv_step", step,
                            inner_solver=inner_solver), None
    s = fs.block_step_args("tiled_rv_step", u2, u2.shape[1], step,
                           inner_solver=inner_solver)
    fs.check_block_options("tiled_rv_step", s, abs_term)
    return s, int(u2.shape[0] if n_rows is None else n_rows)


def tiled_rv_step_plain(u2, uo2, uoo2, g2, Mc2, *, tile_rows=None,
                        inner_solver="cheby", row0_base=None, n_rows=None,
                        abs_term=None, **step):
    """One stabilised step in plain PyTorch (tile_rows is ignored);
    returns u_{n+1}, in block mode the whole block."""
    s, n_rows = _args(u2, step, inner_solver, row0_base, n_rows, abs_term)
    if row0_base is not None:
        return fs.block_step_plain(u2, uo2, uoo2, g2, Mc2, row0_base,
                                   abs_term, n_rows, s)
    return fs._step_body_plain(fs._plain_data(u2, Mc2, s), u2, uo2, uoo2,
                               g2, **fs._body_kw(s))


def tiled_rv_step(u2, uo2, uoo2, g2, Mc2, *, tile_rows=None,
                  inner_solver="cheby", row0_base=None, n_rows=None,
                  abs_term=None, bf16_planes=False, **step):
    """One stabilised step, one launch; replaces pallas_tiled.tiled_rv_step.

    Arguments as ops/fused_step.fused_rv_step (``step``), plus tile_rows
    (None: default_tile_rows). Returns u_{n+1} (n1x, n1y). Block mode:
    row0_base (an int, the global row of block row 0), n_rows (rows of the
    whole grid) and abs_term (a one-element tensor, read on the device, or
    a float; not needed for gfem) as ops/fused_step.fused_rv_block_step;
    nx, ny in ``step`` are the block's, (B - 1, n1y - 1)."""
    _check_tiled_options(inner_solver, bf16_planes)
    s, n_rows = _args(u2, step, inner_solver, row0_base, n_rows, abs_term)
    block = row0_base is not None
    if _build.on_cpu("tiled_rv_step", u2, uo2, uoo2, g2, Mc2):
        return tiled_rv_step_plain(u2, uo2, uoo2, g2, Mc2, row0_base=row0_base,
                                   n_rows=n_rows, abs_term=abs_term, **s)
    n1x, n1y = s["nx"] + 1, s["ny"] + 1
    dtype, consts = fs._launch_prep("tiled_rv_step", s,
                                    [u2, uo2, uoo2, g2, Mc2],
                                    [(n1x, n1y)] * 4 + [(7, n1x, n1y)])
    itemsize, dev = u2.element_size(), u2.device
    if block:
        lo, hi = fs.block_rows(n1x, int(row0_base), n_rows)
    else:
        lo, hi = 0, n1x
    if tile_rows is None:
        tile_rows = default_tile_rows(
            hi - lo, n1y, itemsize,
            torch.cuda.get_device_properties(dev).multi_processor_count)
    rows, cols = tile_geometry(hi - lo, n1y, itemsize, tile_rows)
    out = torch.empty((n1x, n1y), dtype=dtype, device=dev)
    work, part = fs.new_scratch(dtype, dev, n1x, n1y)
    keep, abs_ptr = (fs.abs_term_ptr(abs_term, s, dtype, dev) if block
                     else (None, 0))
    bdf2, rv, freeze, cheby = fs._flags(s)
    with torch.cuda.device(dev):
        code = _build.entry("cft_tiled_rv_step", dtype)(
            u2.data_ptr(), uo2.data_ptr(), uoo2.data_ptr(), g2.data_ptr(),
            Mc2.data_ptr(), out.data_ptr(), work.data_ptr(), part.data_ptr(),
            abs_ptr, consts.data_ptr(), n1x, n1y,
            int(row0_base) if block else 0, n_rows if block else n1x,
            int(block), rows, cols, int(s["cg_iters"]),
            int(s["newton_iters"]), int(s["lin_iters"]), bdf2, rv, freeze,
            cheby, _build.stream_ptr(u2))
    _build.launches["tiled_rv_step_block" if block else "tiled_rv_step"] += 1
    _build.check(code, "tiled_rv_step")
    return out
