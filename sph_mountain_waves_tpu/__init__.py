"""sph_mountain_waves_tpu — an SPH framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
moschehaus/sph-mountain-waves (a fork of SmoothedParticles.jl): weakly
compressible / pressure-entropy / entropy-based SPH with a shape-CSG geometry
DSL, particle lattices, Paraview PVD/VTP I/O, packing utilities, and the
2-D stratified mountain-wave (Witch of Agnesi) application suite.

Reference public API surface: /root/reference/src/SmoothedParticles.jl:14-79.

Design (accelerator-first, not a line-by-line translation):
  * particle state is a struct-of-arrays pytree with a fixed capacity and an
    ``active`` mask (dynamic particle counts without recompiles),
  * the threaded cell-list + pairwise loops of the reference
    (core.jl:51-90,94-112) become a cell-sorted, fixed-capacity-bucket
    neighbor engine with vectorized stencil gathers and masked reductions,
  * physics closures are pure functions applied through ``apply_unary`` /
    ``apply_binary`` (mirroring reference ``apply!``, core.jl:151-161),
  * whole frame intervals run inside one ``lax.scan`` under ``jit``,
  * multi-device scaling = domain decomposition over a ``jax.sharding.Mesh``
    with ``lax.ppermute`` halo exchange (parallel/).
"""

from .algebra import (
    VECX, VECY, VECZ, VEC0, MAT0, MAT1, FMAT0, FMAT1,
    RealVector, RealMatrix, FlatMatrix,
    dot, norm, trace, dev, det, trans, cof, inv, outer,
)
from .kernels import (
    wendland1, Dwendland1, rDwendland1,
    wendland2, Dwendland2, rDwendland2,
    wendland3, Dwendland3, rDwendland3, DDwendland3,
    spline23, Dspline23, rDspline23,
    spline24, Dspline24, rDspline24,
)
from .geometry import (
    Shape, Box, Rectangle, Circle, Ellipse, Ball, Ellipsoid, Cone,
    BooleanUnion, BooleanIntersection, BooleanDifference,
    Specification, BoundaryLayer, Transform, Polygon, ClosedSpline,
    RevolutionBody, Witch, is_inside, boundarybox,
)
from .grids import (
    Grid, Squaregrid, Hexagrid, VogelGrid, ExpGrid, Expgrid, CubicGrid,
    FacecenteredGrid, BodycenteredGrid, DiamondGrid, dimension, covering,
)
from .structs import (
    ParticleSystem, ParticleState, ParticleField, DataField, generate_particles,
)
from .ops.neighbors import NeighborEngine, Neighbors
from .ops.apply import apply_unary, apply_binary, pair_sum, point_sum, dist
from .ops.solvers import assemble_matvec, assemble_vector, cg_solve, assemble_matrix
from .io import (
    DataStorage, new_pvd_file, save_pvd_file, save_frame, import_particles,
    read_vtp,
)

__version__ = "0.1.0"
