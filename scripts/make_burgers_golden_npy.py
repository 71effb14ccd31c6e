"""Write the last frame of golden/burgers_rv50.h5 as
golden/burgers_rv50_final.npy, for machines without h5py.

    python3 scripts/make_burgers_golden_npy.py

The h5 file holds the reference's Burgers RV run at mesh 50 (Function/uh,
one dataset per output time, named by the time with "_" for "."); the
frame of the largest time, a (2601,) f64 vector in the mesh's node order,
is what tests/test_golden_parity.py holds the JAX package to (1e-9) and
what chip_smoke.py holds the port to on the card. Needs h5py and numpy.
"""

import os

import h5py
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "golden", "burgers_rv50.h5")
DST = os.path.join(REPO, "golden", "burgers_rv50_final.npy")


def last_frame(path=SRC):
    """(time, values) of the latest frame of Function/uh in ``path``."""
    with h5py.File(path, "r") as f:
        grp = f["Function/uh"]
        key = max(grp.keys(), key=lambda k: float(k.replace("_", ".")))
        return float(key.replace("_", ".")), np.asarray(grp[key])[:, 0]


def main():
    t, u = last_frame()
    np.save(DST, u)
    print(f"t = {t}: {u.shape[0]} values -> {DST}")


if __name__ == "__main__":
    main()
