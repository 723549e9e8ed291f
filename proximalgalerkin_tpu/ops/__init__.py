"""Lattice multigrid operators (ops/mg.py) for the P1 obstacle fast path."""
