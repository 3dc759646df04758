"""Launchers: serve and train (the production mesh and the dry run come later)."""
