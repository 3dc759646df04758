"""Launchers: serve (the production mesh, dry run and train come later)."""
