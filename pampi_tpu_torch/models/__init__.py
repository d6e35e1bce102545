"""Solvers: Poisson and NS-2D."""
