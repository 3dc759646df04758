"""Launchers: production mesh, serve and train (the dry run comes later)."""
from .mesh import make_production_mesh  # noqa: F401
