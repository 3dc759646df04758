"""Launchers: production mesh, serve, train, and the one-rank dry run with
its roofline report."""
from .mesh import make_production_mesh  # noqa: F401
