"""Count the machine instructions (SASS) of the built kernels.

    python3 scripts/torch_sass_count.py [PATTERN ...]

Builds the port's kernel library if it is not built yet
(conservation_fem_tpu_torch/ops/_build.py), disassembles it with the CUDA
toolkit's cuobjdump and prints, for every kernel whose demangled-free
symbol contains one of the PATTERNs (default: p1_newton_locals), one JSON
line: the static count of its instructions, of its floating-point
instructions by class (f32: FFMA, FMUL, FADD; f64: DFMA, DMUL, DADD;
MUFU, the special-function unit), and its arithmetic operations with a
fused multiply-add counted as two. A kernel whose code is straight-line
per thread (the ELL locals kernel C: its loops over the quadrature
points and nodes unrolled) executes these once per cell, apart from the
branches of the libdevice sincos (the slow path of its argument
reduction, taken for |u| beyond ~1e5, not on the driven paths). Needs
nvcc (to build) and cuobjdump, on the machine with the card.
"""

import collections
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP_CLASSES = {"f32": ("FFMA", "FMUL", "FADD"),
              "f64": ("DFMA", "DMUL", "DADD")}
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)(?:\.[A-Z0-9_.]+)?\s")


def _cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    raise SystemExit("cuobjdump not found")


def counts(lib_path, patterns):
    """{kernel symbol: Counter of opcodes} of the kernels matching
    ``patterns``."""
    out = subprocess.run([_cuobjdump(), "-sass", lib_path],
                         capture_output=True, text=True, check=True).stdout
    got = {}
    for chunk in out.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        if not any(p in name for p in patterns):
            continue
        got[name] = collections.Counter(INSTR.findall(chunk))
    return got


def main(argv):
    sys.path.insert(0, REPO)
    from conservation_fem_tpu_torch.ops import _build

    patterns = argv[1:] or ["p1_newton_locals"]
    for name, c in counts(_build.build(), patterns).items():
        row = dict(kernel=name, instructions=sum(c.values()),
                   MUFU=c.get("MUFU", 0))
        for dn, ops in FP_CLASSES.items():
            fma, mul, add = (c.get(op, 0) for op in ops)
            row.update({op: c.get(op, 0) for op in ops})
            row[f"{dn}_operations"] = 2 * fma + mul + add
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
