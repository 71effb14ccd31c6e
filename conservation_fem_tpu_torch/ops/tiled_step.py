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
CFT_TILE_ROWS override) has no counterpart and is not ported.

``bf16_planes`` (f32 only; at f64 the same launch, bit for bit): the
kernel's bf16 instance (csrc/tiled_step_bf16.cu, KPP) streams the planes
of its solver sweeps as bfloat16 — the mass solve reads a copy of Mc
(``bf16_planes_of``; the model and ShardedFusedStructured make it once
per solve), the linearisation writes the Jacobian only as bf16
(no f32 Jacobian planes exist), the Newton inner solves read it back — and
takes both Jacobi diagonals from the rounded planes; every product runs in
f32, and the rhs, the eps-stiffness and the residuals read f32 planes
(pallas_tiled.tiled_rv_step's variant; its plain version is
fused_step._step_body_plain with bf16_planes). The bf16 planes are stored
with an even row pitch (``plane_pitch``) and the tiles start at even
columns, so cp.async copies them in 4-byte pairs. The stages stay the
size of the f32 instance's: the largest is the update sweep's, whose mass
and eps-stiffness planes stay f32.
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
                     "tiled_bf16": "cft_tiled_occupancy_bf16",
                     "split_setup": "cft_split_setup_occupancy",
                     "split_newton": "cft_split_newton_occupancy"}
# the kernels whose solver sweeps read 2-byte planes
PLANE_ITEMSIZE = {"tiled_bf16": 2}
# work fields of the bf16 instance: csrc/fused_step.cuh's without the 7
# f32 Jacobian planes (Field::JC), which live in a bf16 region of their own
BF16_WORK_FIELDS = fs.N_WORK_FIELDS - 7


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


def plane_pitch(n1y, plane_itemsize):
    """Values a row of the solver planes takes in device memory: n1y,
    rounded up to even for 2-byte planes (csrc/tile_sweep.cuh
    plane_pitch), so that each pair of columns starting at an even one is
    one aligned 4-byte copy."""
    return n1y + (n1y & 1) if plane_itemsize == 2 else n1y


def tile_geometry(n1x, n1y, itemsize, tile_rows, plane_itemsize=None):
    """(rows, cols) of a tile: ``tile_rows`` rows by columns that split
    the row into equal tiles of at most MAX_TILE_COLS, fewer where two
    stages would not fit ``smem_budget``; an even number of columns where
    the solver planes take ``plane_itemsize`` = 2 bytes (None: itemsize),
    so that every tile starts at an even column."""
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
    cols = -(-n1y // -(-n1y // width))
    if plane_itemsize == 2 and cols % 2:
        if width < 2:
            raise ValueError(f"tile_rows {rows}: two stages of two columns "
                             "do not fit the shared memory")
        cols = cols + 1 if cols < width else cols - 1
    return rows, cols


def tile_origins(lo, hi, n1y, rows, cols):
    """[(row, column)] of the first node of each tile over rows [lo, hi),
    in the kernel's tile order (csrc/tile_sweep.cuh TileGrid): block b
    sweeps tiles b, b + blocks, ..."""
    tiles_y = -(-n1y // cols)
    count = -(-(hi - lo) // rows) * tiles_y
    return [(lo + (t // tiles_y) * rows, (t % tiles_y) * cols)
            for t in range(count)]


def tile_plan(n1x, n1y, itemsize, tile_rows, n_sm, blocks_per_sm,
              plane_itemsize=None):
    """The plan of a sweep over n1x rows: rows, cols, tiles, smem (bytes
    per block), resident (blocks on the card at once, blocks_per_sm(smem)
    on each of n_sm SMs), blocks (those launched: no more than tiles),
    rounds (tiles per block, at most) and staged (the busiest block's cost
    per sweep of the largest stage: the sectors it copies and TILE_SECTORS
    per tile). plane_itemsize: as tile_geometry."""
    rows, cols = tile_geometry(n1x, n1y, itemsize, tile_rows,
                               plane_itemsize)
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


def default_tile_rows(n1x, n1y, itemsize, n_sm, blocks_per_sm,
                      plane_itemsize=None):
    """Rows per tile over n1x rows on a card of n_sm SMs, where
    blocks_per_sm(smem) blocks fit an SM with smem bytes of dynamic shared
    memory: of TILE_ROWS, the one whose busiest block stages least —
    rounds of tiles over the resident blocks times the device-memory
    sectors a stage's row segments touch, plus a tile's fixed cost (a
    sweep lasts as long as its busiest block; a smaller tile trades idle
    blocks in the last round for more halo and more tiles, a narrower one
    for more partial sectors per value). Ties go to the larger tile.
    plane_itemsize: as tile_geometry."""
    return min(TILE_ROWS, key=lambda rows: tile_plan(
        n1x, n1y, itemsize, rows, n_sm, blocks_per_sm,
        plane_itemsize)["staged"])


@functools.lru_cache(maxsize=None)
def occupancy(dtype, smem, device_index=0, kernel="tiled"):
    """What the card gives ``kernel`` with smem bytes of dynamic shared
    memory: blocks_per_sm (from the CUDA occupancy calculator), registers
    and local_bytes (spills) per thread, static_smem and max_dynamic_smem
    per block. ``kernel`` is a key of OCCUPANCY_ENTRIES (the KPP instance)
    or ``_build.launch_key(key, flux)`` (``"tiled/burgers"``: the instance
    for that flux)."""
    name, _, flux = kernel.partition("/")
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device_index):
        code = _build.entry(OCCUPANCY_ENTRIES[name], dtype, flux or "kpp")(
            int(smem), out)
    _build.check(code, f"{kernel} occupancy")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "static_smem", "max_dynamic_smem"), out))


@functools.lru_cache(maxsize=None)
def _card_plan(n1x, n1y, dtype, tile_rows, device_index, kernel, flux):
    itemsize = torch.empty((), dtype=dtype).element_size()
    n_sm = torch.cuda.get_device_properties(
        device_index).multi_processor_count

    def per_sm(smem):
        return occupancy(dtype, smem, device_index,
                         _build.launch_key(kernel, flux))["blocks_per_sm"]

    planes = PLANE_ITEMSIZE.get(kernel)
    if tile_rows is None:
        tile_rows = default_tile_rows(n1x, n1y, itemsize, n_sm, per_sm,
                                      planes)
    return tile_plan(n1x, n1y, itemsize, tile_rows, n_sm, per_sm, planes)


def card_plan(n1x, n1y, dtype, tile_rows=None, device_index=0,
              kernel="tiled", flux="kpp"):
    """``tile_plan`` on the card for ``kernel`` (a key of
    OCCUPANCY_ENTRIES), its instance for ``flux`` (its blocks per SM;
    tile_rows None: ``default_tile_rows``). Plans are computed once per
    argument set."""
    return dict(_card_plan(int(n1x), int(n1y), dtype,
                           None if tile_rows is None else int(tile_rows),
                           int(device_index), kernel, flux))


def device_index(t):
    """The CUDA device index of tensor t (the current device for "cuda")."""
    return torch.cuda.current_device() if t.device.index is None \
        else t.device.index


def _check_tiled_options(inner_solver):
    if inner_solver not in ("cheby", "bicgstab"):
        raise NotImplementedError(
            "tiled_rv_step inner_solver must be 'cheby' or 'bicgstab'")


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
                        abs_term=None, bf16_planes=False, **step):
    """One stabilised step in plain PyTorch (tile_rows is ignored);
    returns u_{n+1}, in block mode the whole block. bf16_planes: the bf16
    solver planes (fused_step._step_body_plain), f32 only."""
    s, n_rows = _args(u2, step, inner_solver, row0_base, n_rows, abs_term)
    if row0_base is not None:
        return fs.block_step_plain(u2, uo2, uoo2, g2, Mc2, row0_base,
                                   abs_term, n_rows, s,
                                   bf16_planes=bf16_planes)
    return fs._step_body_plain(fs._plain_data(u2, Mc2, s), u2, uo2, uoo2,
                               g2, bf16_planes=bf16_planes, **fs._body_kw(s))


def bf16_planes_of(Mc2):
    """The bf16 copy of the mass planes the bf16 instance's mass solve
    reads: (7, n1x, plane_pitch(n1y, 2)), rounded to nearest even, zero
    past column n1y."""
    out = Mc2.to(torch.bfloat16)
    n1y = Mc2.shape[-1]
    pitch = plane_pitch(n1y, 2)
    if pitch == n1y:
        return out
    return torch.nn.functional.pad(out, (0, pitch - n1y))


def tiled_rv_step(u2, uo2, uoo2, g2, Mc2, *, tile_rows=None,
                  inner_solver="cheby", row0_base=None, n_rows=None,
                  abs_term=None, bf16_planes=False, mc16=None, **step):
    """One stabilised step, one launch; replaces pallas_tiled.tiled_rv_step.

    Arguments as ops/fused_step.fused_rv_step (``step``), plus tile_rows
    (None: default_tile_rows). Returns u_{n+1} (n1x, n1y). Block mode:
    row0_base (an int, the global row of block row 0), n_rows (rows of the
    whole grid) and abs_term (a one-element tensor, read on the device, or
    a float; not needed for gfem) as ops/fused_step.fused_rv_block_step;
    nx, ny in ``step`` are the block's, (B - 1, n1y - 1). bf16_planes: at
    f32 the kernel's bf16 instance (KPP only; its launches count as
    ``tiled_rv_step_bf16`` and ``tiled_rv_step_block_bf16``); at f64 the
    flag changes nothing. mc16: the bf16 mass planes that instance reads,
    ``bf16_planes_of(Mc2)``, which a caller stepping with one Mc2 makes
    once (None: made here at each call, as JAX casts once per step; the
    plain version and f64 ignore it)."""
    _check_tiled_options(inner_solver)
    s, n_rows = _args(u2, step, inner_solver, row0_base, n_rows, abs_term)
    block = row0_base is not None
    if _build.on_cpu("tiled_rv_step", u2, uo2, uoo2, g2, Mc2):
        return tiled_rv_step_plain(u2, uo2, uoo2, g2, Mc2, row0_base=row0_base,
                                   n_rows=n_rows, abs_term=abs_term,
                                   bf16_planes=bf16_planes, **s)
    n1x, n1y = s["nx"] + 1, s["ny"] + 1
    dtype, consts = fs._launch_prep("tiled_rv_step", s,
                                    [u2, uo2, uoo2, g2, Mc2],
                                    [(n1x, n1y)] * 4 + [(7, n1x, n1y)])
    dev = u2.device
    if block:
        lo, hi = fs.block_rows(n1x, int(row0_base), n_rows)
    else:
        lo, hi = 0, n1x
    flux = s["flux"].name
    bf16 = bool(bf16_planes) and dtype == torch.float32
    if bf16 and flux != "kpp":
        raise NotImplementedError(
            f"tiled_rv_step: the bf16-plane instance is compiled for the KPP "
            f"flux only (the JAX package's {flux!r} config has no "
            "bf16_planes option)")
    kernel = "tiled_bf16" if bf16 else "tiled"
    plan = card_plan(hi - lo, n1y, dtype, tile_rows, device_index(u2),
                     kernel=kernel, flux=flux)
    out = torch.empty((n1x, n1y), dtype=dtype, device=dev)
    keep, abs_ptr = (fs.abs_term_ptr(abs_term, s, dtype, dev) if block
                     else (None, 0))
    bdf2, rv, freeze, cheby = fs._flags(s)
    head = (u2.data_ptr(), uo2.data_ptr(), uoo2.data_ptr(), g2.data_ptr(),
            Mc2.data_ptr())
    tail = (abs_ptr, consts.data_ptr(), n1x, n1y,
            int(row0_base) if block else 0, n_rows if block else n1x,
            int(block), plan["rows"], plan["cols"], int(s["cg_iters"]),
            int(s["newton_iters"]), int(s["lin_iters"]), bdf2, rv, freeze,
            cheby, _build.stream_ptr(u2))
    name = "tiled_rv_step_block" if block else "tiled_rv_step"
    with torch.cuda.device(dev):
        if bf16:
            pitch = plane_pitch(n1y, 2)
            if mc16 is None:
                mc16 = bf16_planes_of(Mc2)
            elif (mc16.dtype != torch.bfloat16 or mc16.device != dev
                  or tuple(mc16.shape) != (7, n1x, pitch)
                  or not mc16.is_contiguous()):
                raise ValueError(
                    f"tiled_rv_step: mc16 must be bf16_planes_of(Mc2), a "
                    f"contiguous (7, {n1x}, {pitch}) bfloat16 tensor on "
                    f"{dev}")
            jc16 = torch.empty((7, n1x, pitch), dtype=torch.bfloat16,
                               device=dev)
            work = torch.empty((BF16_WORK_FIELDS, n1x, n1y), dtype=dtype,
                               device=dev)
            part = torch.empty(_build.PART_SIZE, dtype=dtype, device=dev)
            code = _build.entry("cft_tiled_rv_step_bf16", dtype)(
                *head, mc16.data_ptr(), out.data_ptr(), work.data_ptr(),
                jc16.data_ptr(), part.data_ptr(), *tail)
            name += "_bf16"
        else:
            work, part = fs.new_scratch(dtype, dev, n1x, n1y)
            code = _build.entry("cft_tiled_rv_step", dtype, flux)(
                *head, out.data_ptr(), work.data_ptr(), part.data_ptr(),
                *tail)
    _build.launches[_build.launch_key(name, flux)] += 1
    _build.check(code, name)
    return out
