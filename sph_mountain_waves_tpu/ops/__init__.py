"""Operator/runtime layer (L3): the JAX replacement for the
reference's threaded cell-list + pairwise loops (src/core.jl)."""

from .neighbors import NeighborEngine, Neighbors
from .apply import apply_unary, apply_binary, pair_sum, point_sum, dist
from .solvers import assemble_matvec, assemble_vector, cg_solve, assemble_matrix
