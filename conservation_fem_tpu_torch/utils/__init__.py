"""Host-side utilities of the port: checkpoint, streaming, io, guards,
metrics, interpolate, sweeps, plotting, baseline_proxy, convergence and
riemann_exact, each a module of its own. Nothing is imported here, so the
package imports without h5py, matplotlib or PIL (the modules that need one
import it where they use it)."""
