"""Workload models of the port: KPP, Burgers (P1-P3), linear advection
(P1-P3), compressible Euler and Stokes/IPCS."""
