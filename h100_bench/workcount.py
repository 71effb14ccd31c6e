"""The benchmark's frozen arithmetic: the work of a step, the card's peaks
and the reading of a torch.profiler trace.

Each piece is a copy of ``chip_smoke.py`` as it stood when the benchmark
was defined (the line numbers below), kept here so that a later change to
the program or to ``chip_smoke.py`` cannot move the yardstick. Changes
from the original are named where they are made.
"""

from __future__ import annotations

# -- peaks (chip_smoke.py:686-692) --------------------------------------------
# The least time of a kernel's work: max(bytes / HBM rate, operations /
# peak rate), H100 SXM data sheet (700 W): 3.35 TB/s; 67 TFLOP/s f32 and
# 34 TFLOP/s f64 outside the tensor cores (the kernels use none).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"f32": 67e12, "f64": 34e12}

# -- operations per node (chip_smoke.py:693-730) ------------------------------
# Operations per node of the step's parts, counted from csrc/fused_step.cuh
# (an add, multiply, divide, min, max or abs is one operation; a sin or a
# cos is one), as often as the algorithm needs them (the JAX _make_lib):
# what depends on a triangle alone once per triangle, 2 per node, and what
# depends on one of its corners once per corner, 6 per node. The kernels
# recompute a triangle's part at each of its 3 corners; that is their cost,
# not the work's. The flux's own operations per quadrature point: KPP a sin
# and a cos; Burgers none (f' = (u, u), f'' = (1, 1) are free).
FLUX_POINT_OPS = {"kpp": 2, "burgers": 0}
OPS_STENCIL = 13                        # stencil_apply: 7 mul + 6 add
OPS_CG_ITER = OPS_STENCIL + 13          # M p, 2 dots, x, r, z, p
OPS_CHEBY_ITER = OPS_STENCIL + 6        # A d, x, r, d
OPS_PLANES = 2 * 3 + 6 * 3 * 2 + OPS_STENCIL   # cell-mean eps per triangle,
#   7 planes per corner, K u
OPS_BICG_ITER = 2 * OPS_STENCIL + 22    # J phat, J shat, 4 dots, s, shat,
#   x, r, p, phat


def flux_ops(flux):
    """{part: operations per node} of the parts that depend on the flux
    (a key of FLUX_POINT_OPS)."""
    c = FLUX_POINT_OPS[flux]
    # nl_rhs_node: per triangle the gradient (10) and per quadrature point
    # its value (5), the flux's own operations and f'(u_q) . grad u (3);
    # per corner 6 weighted sums (2 each) + 2
    nl = 2 * (10 + 6 * (8 + c)) + 6 * (6 * 2 + 2)
    # conv_planes_node: per triangle and quadrature point as nl plus the 3
    # terms fg phi_b + fx G_b0 + fy G_b1 (5 each); per corner 3 weighted sums
    conv = 2 * (10 + 6 * (8 + c + 3 * 5)) + 6 * 3 * (6 * 2 + 2)
    return dict(
        proj_rhs=5 + OPS_STENCIL + nl + 6,   # du, M du, N(u), rhs, z, dots
        # max|u - mean|, patch max/min/|RH|, eps; Burgers' patch max |u|
        # (7 abs, 6 max) and its speed sqrt(2) max|u| Cvel h (2)
        rv=3 + 6 * 5 + 8 + (15 if flux == "burgers" else 0),
        f=7 + 2 * OPS_STENCIL + nl + 5,      # F(uk): M (uk - u), N(uk), K uk
        lin=conv + 22)                       # J = M + dt/2 (K + C), 1 / J_00


def step_ops(s):
    """Operations per node of one whole step; s: the step's arguments
    (``step_args``). chip_smoke.py:848-864 with its part "step" alone, and
    the flux given by name (``s["flux"]``, a key of FLUX_POINT_OPS) where
    the original reads the name off the program's Flux object."""
    fo = flux_ops(s["flux"])
    cheby = s["inner_solver"] == "cheby"
    head = (fo["proj_rhs"]
            + s["cg_iters"] * (OPS_CHEBY_ITER if cheby else OPS_CG_ITER)
            + (fo["rv"] if s["stabilization"] == "rv" else 0) + OPS_PLANES)
    newton = s["lin_iters"] * (OPS_CHEBY_ITER if cheby else OPS_BICG_ITER) + 1
    n_lin = 1 if s["freeze_jacobian"] else s["newton_iters"]
    return head + s["newton_iters"] * (fo["f"] + newton) + n_lin * fo["lin"]


def bound(n_bytes, ops, dn):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of the dtype (chip_smoke.py:1045-1052)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dn] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


# -- the step of a configuration ----------------------------------------------

# Values per node a step must move, whatever computes it: the three fields
# of the history, the Dirichlet data and the 7 mass planes read once, the
# new field written once.
STEP_VALUES_READ = 3 + 1 + 7
STEP_VALUES_WRITTEN = 1
ITEMSIZE = {"float32": 4, "float64": 8}
DTYPE_NAME = {"float32": "f32", "float64": "f64"}


def step_args(config):
    """The arguments step_ops reads, from a configuration file's dict."""
    s = config["solver"]
    return dict(flux=config["flux"], inner_solver=s["inner_solver"],
                cg_iters=s["cg_iters"], stabilization=s["stabilization"],
                lin_iters=s["newton_linear_iters"],
                newton_iters=s["newton_iters"],
                freeze_jacobian=s["modified_newton"])


def step_bound(config, n_nodes):
    """(least ms of one step on n_nodes nodes, what bounds it)."""
    dtype = config["solver"]["dtype"]
    n_bytes = (STEP_VALUES_READ + STEP_VALUES_WRITTEN) * n_nodes * ITEMSIZE[
        dtype]
    return bound(n_bytes, n_nodes * step_ops(step_args(config)),
                 DTYPE_NAME[dtype])


# -- reading a trace (chip_smoke.py:3928-3952) --------------------------------


def device_events(prof, skip_prefix="bench."):
    """[(start µs, end µs, name)] of each device activity (kernels, copies,
    sets) that the finished torch.profiler ``prof`` recorded, read from its
    kineto events as prof.events() reads them (hidden and memory records
    left out), on the profiler's clock. The original returns spans from
    the first one; this keeps the clock, so that the spans line up with
    ``host_events``, keeps each name, and leaves out the device side of the
    harness's own annotations (names that start with ``skip_prefix``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.name().startswith("[")
            and not e.name().startswith(skip_prefix)
            and not getattr(e, "is_hidden_event", lambda: False)()]


def host_events(prof, prefix="bench."):
    """[(start µs, end µs, name)] of the host annotations whose names start
    with ``prefix``, on the profiler's clock."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    return [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cpu and e.name().startswith(prefix)]


def busy_us(spans):
    """Microseconds covered by the union of the (start, end, ...) spans."""
    busy, end = 0.0, float("-inf")
    for s, e, *_ in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def idle_gaps(spans, lo, hi):
    """[(start, end)] of the stretches of [lo, hi] that no span covers."""
    gaps, end = [], lo
    for s, e, *_ in sorted(spans):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]
