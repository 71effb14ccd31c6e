"""Operators of the port: mesh, quadrature, stencil backend, solvers and the
hand-written Hopper kernels (``stencil_kernels``, ``fused_step``)."""
