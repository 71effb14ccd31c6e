"""Workload models of the port (KPP on the structured stencil backend)."""
