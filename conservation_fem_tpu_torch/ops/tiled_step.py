"""Stabilised time step swept in tiles: the Hopper kernel
(csrc/tiled_step.cu) and its plain PyTorch version.

Port of conservation_fem_tpu/ops/pallas_tiled.py. ``tiled_rv_step`` runs
one step of the same algorithm as ops/fused_step.fused_rv_step in one
cooperative launch whose sweeps copy what they read, tile by tile, into
two shared-memory stages (the next tile in flight while this one
computes); it returns u_{n+1}. The plain version is the
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

The tile plan is chosen here, where the CPU tests reach it, for this
kernel and for the split step's kernels (ops/fused_step.split_setup,
split_newton), which run the same tile pipeline (csrc/tile_sweep.cuh);
``card_plan`` takes the occupancy of the kernel it is asked for. A tile is
``tile_rows`` rows (the JAX meaning) by at most MAX_TILE_COLS columns. The
kernel copies each sweep's raw fields and operator planes into two
shared-memory stages (the next tile while this one computes), so the
columns shrink until two stages of the largest sweep fit the shared memory
a block may use (``smem_budget``); ``default_tile_rows`` weighs the rounds
of tiles over the blocks that can be resident with that shared memory. The
TPU kernel's Mosaic geometry (8-row halo alignment, 128-lane padding, HBM
pad rows, the 24 MB VMEM budget of its default_tile_rows, the
CFT_TILE_ROWS override) has no counterpart and is not ported. Not ported:
``bf16_planes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from conservation_fem_tpu_torch.ops import _build
from conservation_fem_tpu_torch.ops import fused_step as fs

# A stage (csrc/tile_sweep.cuh kStageHalo, kStageNode): STAGE_HALO fields
# over the tile and its one-node halo, and STAGE_NODE values per node over
# the tile — the most any sweep reads: 4 fields at neighbours (the
# BiCGStab direction), 3 node fields and 2 operators of 7 planes (the
# update and its residual).
STAGE_HALO = 4
STAGE_NODE = 17
STAGES = 2
# Shared memory a block of the H100 may take (227 KB; cudaDevAttr
# MaxSharedMemoryPerBlockOptin), less the kernel's static shared memory:
# STATIC_VALUES values (the reduction scratch, 4 x 256, and the step's 81
# constants) and up to STATIC_PAD bytes of alignment (ptxas reports 4432 B
# in f32, 8848 in f64). chip_smoke.py holds this to what the card reports.
SMEM_OPTIN = 232448
STATIC_VALUES = 4 * 256 + 81
STATIC_PAD = 16
MAX_TILE_COLS = 64
SECTOR = 32   # bytes of a device-memory sector
# What a tile costs beyond its copies (two barriers, the wait for the
# first copies), in sectors: fitted to the tile-size sweep of
# `chip_smoke.py --ablate` on the H100 at mesh 256 and 512, where 16-row
# tiles beat 8-row ones by 3% and 8%.
TILE_SECTORS = 224
TILE_ROWS = (64, 32, 16, 8)   # default_tile_rows' candidates, largest first
# the kernels that run the tile pipeline: name -> C occupancy entry
OCCUPANCY_ENTRIES = {"tiled": "cft_tiled_occupancy",
                     "split_setup": "cft_split_setup_occupancy",
                     "split_newton": "cft_split_newton_occupancy"}


def smem_budget(itemsize):
    """Bytes of dynamic shared memory a block of the tiled kernel may take."""
    return SMEM_OPTIN - STATIC_VALUES * itemsize - STATIC_PAD


def stage_values(rows, cols):
    """Values one stage of a (rows, cols) tile holds."""
    return (STAGE_HALO * (rows + 2) * (cols + 2)
            + STAGE_NODE * rows * cols)


def row_sectors(width, itemsize):
    """Sectors a row segment of width values touches at most: a grid row
    of n1y = mesh + 1 values starts anywhere in a sector."""
    return -(-width * itemsize // SECTOR) + 1


def stage_sectors(rows, cols, itemsize):
    """Sectors of device memory the copies of one stage touch at most."""
    return (STAGE_HALO * (rows + 2) * row_sectors(cols + 2, itemsize)
            + STAGE_NODE * rows * row_sectors(cols, itemsize))


def smem_bytes(rows, cols, itemsize):
    """Dynamic shared memory of a launch with (rows, cols) tiles."""
    return STAGES * stage_values(rows, cols) * itemsize


def tile_geometry(n1x, n1y, itemsize, tile_rows):
    """(rows, cols) of a tile: ``tile_rows`` rows by columns that split
    the row into equal tiles of at most MAX_TILE_COLS, fewer where two
    stages would not fit ``smem_budget``."""
    rows = int(tile_rows)
    if rows < 1:
        raise ValueError(f"tile_rows must be positive, not {tile_rows}")
    per_col = STAGE_HALO * (rows + 2) + STAGE_NODE * rows
    fit = ((smem_budget(itemsize) // (STAGES * itemsize)
            - 2 * STAGE_HALO * (rows + 2)) // per_col)
    if fit < 1:
        raise ValueError(f"tile_rows {rows}: two stages of one column do "
                         f"not fit {smem_budget(itemsize)} bytes of shared "
                         "memory")
    width = min(MAX_TILE_COLS, fit)
    return rows, -(-n1y // -(-n1y // width))


def tile_origins(lo, hi, n1y, rows, cols):
    """[(row, column)] of the first node of each tile over rows [lo, hi),
    in the kernel's tile order (csrc/tile_sweep.cuh TileGrid): block b
    sweeps tiles b, b + blocks, ..."""
    tiles_y = -(-n1y // cols)
    count = -(-(hi - lo) // rows) * tiles_y
    return [(lo + (t // tiles_y) * rows, (t % tiles_y) * cols)
            for t in range(count)]


def tile_plan(n1x, n1y, itemsize, tile_rows, n_sm, blocks_per_sm):
    """The plan of a sweep over n1x rows: rows, cols, tiles, smem (bytes
    per block), resident (blocks on the card at once, blocks_per_sm(smem)
    on each of n_sm SMs), blocks (those launched: no more than tiles),
    rounds (tiles per block, at most) and staged (the busiest block's cost
    per sweep of the largest stage: the sectors it copies and TILE_SECTORS
    per tile)."""
    rows, cols = tile_geometry(n1x, n1y, itemsize, tile_rows)
    tiles = -(-n1x // rows) * -(-n1y // cols)
    smem = smem_bytes(rows, cols, itemsize)
    resident = n_sm * int(blocks_per_sm(smem))
    if resident < 1:
        raise ValueError(f"no block of the tiled kernel fits an SM with "
                         f"{smem} bytes of shared memory")
    blocks = min(resident, tiles)
    rounds = -(-tiles // blocks)
    return dict(rows=rows, cols=cols, tiles=tiles, smem=smem,
                resident=resident, blocks=blocks, rounds=rounds,
                staged=rounds * (stage_sectors(rows, cols, itemsize)
                                 + TILE_SECTORS))


def default_tile_rows(n1x, n1y, itemsize, n_sm, blocks_per_sm):
    """Rows per tile over n1x rows on a card of n_sm SMs, where
    blocks_per_sm(smem) blocks fit an SM with smem bytes of dynamic shared
    memory: of TILE_ROWS, the one whose busiest block stages least —
    rounds of tiles over the resident blocks times the device-memory
    sectors a stage's row segments touch, plus a tile's fixed cost (a
    sweep lasts as long as its busiest block; a smaller tile trades idle
    blocks in the last round for more halo and more tiles, a narrower one
    for more partial sectors per value). Ties go to the larger tile."""
    return min(TILE_ROWS, key=lambda rows: tile_plan(
        n1x, n1y, itemsize, rows, n_sm, blocks_per_sm)["staged"])


@functools.lru_cache(maxsize=None)
def occupancy(dtype, smem, device_index=0, kernel="tiled"):
    """What the card gives ``kernel`` (a key of OCCUPANCY_ENTRIES) with
    smem bytes of dynamic shared memory: blocks_per_sm (from the CUDA
    occupancy calculator), registers and local_bytes (spills) per thread,
    static_smem and max_dynamic_smem per block."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device_index):
        code = _build.entry(OCCUPANCY_ENTRIES[kernel], dtype)(int(smem), out)
    _build.check(code, f"{kernel} occupancy")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "static_smem", "max_dynamic_smem"), out))


@functools.lru_cache(maxsize=None)
def _card_plan(n1x, n1y, dtype, tile_rows, device_index, kernel):
    itemsize = torch.empty((), dtype=dtype).element_size()
    n_sm = torch.cuda.get_device_properties(
        device_index).multi_processor_count

    def per_sm(smem):
        return occupancy(dtype, smem, device_index, kernel)["blocks_per_sm"]

    if tile_rows is None:
        tile_rows = default_tile_rows(n1x, n1y, itemsize, n_sm, per_sm)
    return tile_plan(n1x, n1y, itemsize, tile_rows, n_sm, per_sm)


def card_plan(n1x, n1y, dtype, tile_rows=None, device_index=0,
              kernel="tiled"):
    """``tile_plan`` on the card for ``kernel`` (a key of
    OCCUPANCY_ENTRIES: its blocks per SM; tile_rows None:
    ``default_tile_rows``). Plans are computed once per argument set."""
    return dict(_card_plan(int(n1x), int(n1y), dtype,
                           None if tile_rows is None else int(tile_rows),
                           int(device_index), kernel))


def device_index(t):
    """The CUDA device index of tensor t (the current device for "cuda")."""
    return torch.cuda.current_device() if t.device.index is None \
        else t.device.index


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
    dev = u2.device
    if block:
        lo, hi = fs.block_rows(n1x, int(row0_base), n_rows)
    else:
        lo, hi = 0, n1x
    plan = card_plan(hi - lo, n1y, dtype, tile_rows, device_index(u2))
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
            int(block), plan["rows"], plan["cols"], int(s["cg_iters"]),
            int(s["newton_iters"]), int(s["lin_iters"]), bdf2, rv, freeze,
            cheby, _build.stream_ptr(u2))
    _build.launches["tiled_rv_step_block" if block else "tiled_rv_step"] += 1
    _build.check(code, "tiled_rv_step")
    return out
