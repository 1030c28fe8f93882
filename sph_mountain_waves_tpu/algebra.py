"""Math substrate (L1).

JAX replacement for the reference's hand-unrolled StaticArrays algebra
(reference: src/algebra.jl). Here vectors/matrices are ordinary ``jnp``
arrays — XLA already emits optimal elementwise code, so the value of this
module is API parity (``RealVector``, ``VECX``, ``dot``, ``norm``,
``trace/dev/det/trans/cof/inv`` …) and batched semantics: every helper accepts
arrays with arbitrary leading batch dimensions, because the SoA engine applies
them to ``[N, …]`` fields.

Reference citations: RealVector src/algebra.jl:14, axis constants :21-42,
dot/norm :49-60, RealMatrix :70, trace/dev/det/trans/cof/inv :94-158,
FlatMatrix (2x2) :196-293.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "RealVector", "RealMatrix", "FlatMatrix",
    "VECX", "VECY", "VECZ", "VEC0", "MAT0", "MAT1", "FMAT0", "FMAT1",
    "dot", "norm", "trace", "dev", "det", "trans", "cof", "inv", "outer",
]


def RealVector(*xs):
    """3-vector constructor (reference src/algebra.jl:14-19).

    ``RealVector(x, y)`` pads the third component with zero, matching the 2-D
    usage throughout the reference scripts.
    """
    if len(xs) == 1:
        return jnp.asarray(xs[0])
    if len(xs) == 2:
        xs = (*xs, 0.0)
    return jnp.stack([jnp.asarray(v, dtype=jnp.result_type(float)) for v in xs], axis=-1)


def RealMatrix(*entries):
    """3x3 matrix from 9 entries, column-major like the reference StaticArrays
    constructor (src/algebra.jl:70-92): ``RealMatrix(a11,a21,a31,a12,...)``.
    """
    if len(entries) == 1:
        return jnp.asarray(entries[0])
    assert len(entries) == 9
    cols = jnp.stack([jnp.asarray(e, dtype=jnp.result_type(float)) for e in entries], axis=-1)
    return cols.reshape(cols.shape[:-1] + (3, 3)).swapaxes(-1, -2)


def FlatMatrix(*entries):
    """2x2 matrix from 4 entries, column-major (src/algebra.jl:196-220)."""
    if len(entries) == 1:
        return jnp.asarray(entries[0])
    assert len(entries) == 4
    cols = jnp.stack([jnp.asarray(e, dtype=jnp.result_type(float)) for e in entries], axis=-1)
    return cols.reshape(cols.shape[:-1] + (2, 2)).swapaxes(-1, -2)


# axis constants (src/algebra.jl:21-42) — NumPy so they adopt state dtype on use
VECX = np.array([1.0, 0.0, 0.0])
VECY = np.array([0.0, 1.0, 0.0])
VECZ = np.array([0.0, 0.0, 1.0])
VEC0 = np.array([0.0, 0.0, 0.0])
MAT0 = np.zeros((3, 3))
MAT1 = np.eye(3)
FMAT0 = np.zeros((2, 2))
FMAT1 = np.eye(2)


def dot(a, b):
    """Vector·vector or matrix:matrix contraction over trailing axes
    (src/algebra.jl:49-54, :165-172). Batched over leading axes."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    if a.ndim >= 2 and b.ndim >= 2 and a.shape[-2:] == b.shape[-2:] and a.shape[-2] == a.shape[-1]:
        # Frobenius inner product for square trailing matrices
        return jnp.sum(a * b, axis=(-2, -1))
    return jnp.sum(a * b, axis=-1)


def norm(a):
    """Euclidean / Frobenius norm over trailing vector axis (src/algebra.jl:56-60)."""
    a = jnp.asarray(a)
    if a.ndim >= 2 and a.shape[-2] == a.shape[-1] and a.shape[-1] in (2, 3):
        return jnp.sqrt(jnp.sum(a * a, axis=(-2, -1)))
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def outer(a, b):
    """Outer product a ⊗ b over trailing axes."""
    return jnp.asarray(a)[..., :, None] * jnp.asarray(b)[..., None, :]


def trace(m):
    """tr(M) (src/algebra.jl:94-98)."""
    return jnp.trace(jnp.asarray(m), axis1=-2, axis2=-1)


def dev(m):
    """Deviatoric part M - tr(M)/d I (src/algebra.jl:100-106)."""
    m = jnp.asarray(m)
    d = m.shape[-1]
    return m - (trace(m) / d)[..., None, None] * jnp.eye(d, dtype=m.dtype)


def det(m):
    """Determinant (src/algebra.jl:108-118)."""
    return jnp.linalg.det(jnp.asarray(m))


def trans(m):
    """Transpose over trailing axes (src/algebra.jl:120-126)."""
    return jnp.swapaxes(jnp.asarray(m), -1, -2)


def cof(m):
    """Cofactor matrix: cof(M) = det(M) * inv(M)^T (src/algebra.jl:128-146)."""
    m = jnp.asarray(m)
    return det(m)[..., None, None] * trans(jnp.linalg.inv(m))


def inv(m):
    """Matrix inverse (src/algebra.jl:148-158)."""
    return jnp.linalg.inv(jnp.asarray(m))
