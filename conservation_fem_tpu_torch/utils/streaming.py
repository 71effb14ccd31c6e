"""Per-step streaming output of a solve, ported from
conservation_fem_tpu/utils/streaming.py.

The JAX package posts every step's (u, t) to the host through an ordered
io_callback from inside its scan. The port's time loop is Python, so
``HyperbolicProblem.solve(stream=...)`` calls ``emit(u, t)`` after each
step, in step order, and the sink copies to the host only the steps it
keeps: frame k (counted from 0) is kept when k % every == 0, the JAX
package's thinning, and its output is the same.

Usage:
    stream = StreamingXDMF(path, host_mesh)        # or StreamingSink(fn)
    problem.solve(stream=stream)
    stream.close()                                  # finalize XDMF index

Cost: each kept step's copy is synchronous (``Tensor.to("cpu")``): it
waits for the step and drains the device's queue. An asynchronous copy
would hand the sink a buffer that the next steps may still be writing.
"""

from __future__ import annotations

from conservation_fem_tpu_torch.utils.checkpoint import host_array


class StreamingSink:
    """Hand (u, t) of every ``every``-th step to a host function
    fn(u numpy array at u's dtype, t float). close() resets the thinning
    counter, so one sink can be reused across solve() calls."""

    def __init__(self, fn, every: int = 1):
        self._fn = fn
        self._every = max(int(every), 1)
        self._count = 0

    def emit(self, u, t):
        if self._count % self._every == 0:
            self._fn(host_array(u), float(t))
        self._count += 1
        return u

    def close(self):
        self._count = 0


class StreamingXDMF(StreamingSink):
    """Append each kept step to an XDMF/HDF5 series (utils/io.XDMFWriter,
    which needs h5py)."""

    def __init__(self, path: str, host_mesh, name: str = "uh",
                 every: int = 1):
        from conservation_fem_tpu_torch.utils.io import XDMFWriter

        self._writer = XDMFWriter(path, host_mesh)
        self._name = name
        super().__init__(
            lambda u, t: self._writer.write_function(u, t, name=self._name),
            every=every,
        )

    def close(self):
        self._writer.close()
        super().close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
