"""Sparse-operator layer: matrix-free SPH stencil operators + CG.

The reference assembles an explicit sparse matrix over the neighbor structure
for the ISPH pressure-Poisson solve (assemble_matrix, src/core.jl:196-225;
used by sph_jl/examples/collapse_dry_implicit.jl:222-231 with an
IterativeSolvers CG). Here the matrix is never needed explicitly — the
operator *is* one neighbor sweep, so we expose:

  * ``assemble_matvec(engine, state, nbrs, coeff)`` → a linear operator
    ``v ↦ A·v`` with ``A_ij = coeff(p_i, q_j, r_ij)`` for ``r_ij ≤ h`` —
    including the diagonal ``i=j`` term, matching the reference's assembly
    (which has no p==q skip, src/core.jl:207-220),
  * ``cg_solve`` — jit-compiled (preconditioned) conjugate gradients,
  * ``assemble_vector`` (src/core.jl:175-182) — a pointwise evaluation,
  * ``assemble_matrix`` — dense parity shim for small systems/tests (the
    kernel Gram-matrix determinant check, src/legacy/adiabatic_mass.jl:481-491).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..structs import ParticleState
from .apply import FieldsView, dist
from .neighbors import NeighborEngine, Neighbors

__all__ = ["assemble_matvec", "assemble_vector", "cg_solve", "pcg",
           "assemble_matrix", "assemble_matrix_bcoo"]


def assemble_vector(state: ParticleState, func, **params) -> jnp.ndarray:
    """v_i = func(p_i) over the state (reference src/core.jl:175-182).
    Inactive rows are zeroed."""
    view = FieldsView(state.fields)
    v = func(view, **params)
    return jnp.where(state.active, v, 0.0)


def _stencil_terms(engine: NeighborEngine, state: ParticleState, nbrs: Neighbors,
                   include_self: bool):
    """Yield (cand, mask, r_safe) for every stencil offset; pair mask keeps
    r ≤ h and, unlike apply_binary, keeps i == j when include_self."""
    x = state.fields["x"]
    N = x.shape[0]
    h = jnp.asarray(engine.h, dtype=x.dtype)
    i_idx = jnp.arange(N, dtype=jnp.int32)
    for offset in engine.stencil:
        cand, valid = engine.stencil_candidates(nbrs, offset)
        r = dist(x[:, None, :], x[cand])
        mask = valid & (r <= h) & state.active[:, None]
        if not include_self:
            mask = mask & (cand != i_idx[:, None])
        yield cand, mask, jnp.where(mask, r, 2.0 * h)


def assemble_matvec(engine: NeighborEngine, state: ParticleState, nbrs: Neighbors,
                    coeff, include_self: bool = True, **params):
    """Return ``matvec(v) = A·v`` with ``A_ij = coeff(p_i, q_j, r_ij)``
    (zero beyond r > h, reference semantics src/core.jl:196-225).

    ``coeff(p, q, r)`` follows the binary-action shape convention and returns
    [N, K]. Inactive rows/columns are zero.
    """
    pview = FieldsView(state.fields, expand=True)
    terms = []
    for cand, mask, r_safe in _stencil_terms(engine, state, nbrs, include_self):
        qview = FieldsView(state.fields, idx=cand)
        a = jnp.where(mask, coeff(pview, qview, r_safe, **params), 0.0)
        terms.append((cand, a))

    def matvec(v):
        out = jnp.zeros_like(v)
        for cand, a in terms:
            out = out + jnp.sum(a * v[cand], axis=1)
        return jnp.where(state.active, out, 0.0)

    return matvec


def cg_solve(matvec, b, x0=None, M=None, tol: float = 1e-6, maxiter: int = 500):
    """Jit-friendly (preconditioned) conjugate gradients.

    ``M`` is an optional preconditioner apply (e.g. Jacobi: v/diag). Thin
    wrapper over ``jax.scipy.sparse.linalg.cg`` so models can swap solvers.
    """
    # atol>0: with b exactly 0 the default atol=0 criterion can never fire
    # and CG iterates on a zero residual (0/0 step sizes) returning junk
    # instead of x=x0; any physical RHS is far above this floor
    x, _ = jax.scipy.sparse.linalg.cg(matvec, b, x0=x0, M=M, tol=tol,
                                      atol=1e-18, maxiter=maxiter)
    return x


def pcg(matvec, b, x0=None, M=None, tol: float = 1e-6, atol: float = 1e-18,
        maxiter: int = 500, axis: str | None = None,
        return_info: bool = False):
    """Preconditioned CG as an explicit ``lax.while_loop`` with optional
    cross-device reductions: with ``axis`` set, every dot product psums
    over that mesh axis, so the solve is correct INSIDE ``shard_map`` where
    ``jax.scipy.sparse.linalg.cg``'s node-local dots would silently solve a
    block-diagonal approximation. The caller owns the vector-space
    discipline: vectors must be zero outside the owned set (so psummed dots
    count each entry once) and ``matvec`` must refresh any halo copies it
    reads (e.g. ``BucketShardEngine.refresh_ghost_vector``).

    Same algorithm and stopping rule as ``cg_solve`` (||r||₂ ≤
    max(tol·||b||₂, atol), the atol floor guarding the zero-RHS case).

    With ``return_info=True`` returns ``(x, iters, rel_res)`` — the
    iteration count and final relative residual ||r||/||b|| (solver
    observability: the reference's IterativeSolvers CG is ``verbose``,
    sph_jl/examples/collapse_dry_implicit.jl:222-231). Both are traced
    scalars, cheap to carry through a scanned step."""
    x0 = jnp.zeros_like(b) if x0 is None else x0
    Mfn = M if M is not None else (lambda v: v)
    red = (lambda s: jax.lax.psum(s, axis)) if axis else (lambda s: s)

    def dot(a, c):
        return red(jnp.sum(a * c))

    r0 = b - matvec(x0)
    z0 = Mfn(r0)
    gamma0 = dot(r0, z0)
    bb = dot(b, b)
    thresh = jnp.maximum(tol * tol * bb, atol * atol)

    def cond(carry):
        _, r, _, _, k = carry
        return jnp.logical_and(dot(r, r) > thresh, k < maxiter)

    def body(carry):
        x, r, p, gamma, k = carry
        Ap = matvec(p)
        alpha = gamma / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Mfn(r)
        gamma2 = dot(r, z)
        p = z + (gamma2 / gamma) * p
        return (x, r, p, gamma2, k + 1)

    x, r, _, _, k = jax.lax.while_loop(cond, body, (x0, r0, z0, gamma0, 0))
    if not return_info:
        return x
    rel = jnp.sqrt(dot(r, r) / jnp.maximum(bb, 1e-300 if bb.dtype ==
                                           jnp.float64 else 1e-30))
    return x, k, rel


def assemble_matrix(engine: NeighborEngine, state: ParticleState, nbrs: Neighbors,
                    coeff, **params) -> jnp.ndarray:
    """Dense [N_cap, N_cap] matrix with A_ij = coeff(p_i, q_j, r_ij) for
    r ≤ h (parity shim for the reference assemble_matrix, src/core.jl:196-225;
    intended for small systems — production solves are matrix-free)."""
    N = state.capacity
    A = jnp.zeros((N, N), dtype=state.fields["x"].dtype)
    pview = FieldsView(state.fields, expand=True)
    i_idx = jnp.arange(N, dtype=jnp.int32)[:, None]
    for cand, mask, r_safe in _stencil_terms(engine, state, nbrs, include_self=True):
        qview = FieldsView(state.fields, idx=cand)
        vals = jnp.where(mask, coeff(pview, qview, r_safe, **params), 0.0)
        rows = jnp.broadcast_to(i_idx, cand.shape)
        A = A.at[rows.ravel(), cand.ravel()].add(jnp.where(mask, vals, 0.0).ravel())
    return A


def assemble_matrix_bcoo(engine: NeighborEngine, state: ParticleState,
                         nbrs: Neighbors, coeff, include_self: bool = True,
                         **params):
    """Explicit sparse assembly as a ``jax.experimental.sparse.BCOO``
    matrix — completes the reference ``assemble_matrix`` contract
    (SparseArrays COO, src/core.jl:196-225) for callers that want the
    matrix itself rather than the matrix-free operator.

    The neighbor structure bounds the pattern statically: nse =
    N·cap·|stencil| entries (masked entries carry value 0 at index (i, i)),
    so the result is jit-compatible with a fixed sparsity budget.
    Production solves should still prefer ``assemble_matvec`` — one sweep
    per apply, no materialization."""
    from jax.experimental import sparse as jsparse

    N = state.capacity
    pview = FieldsView(state.fields, expand=True)
    i_idx = jnp.arange(N, dtype=jnp.int32)[:, None]
    datas, rows_l, cols_l = [], [], []
    for cand, mask, r_safe in _stencil_terms(engine, state, nbrs,
                                             include_self):
        qview = FieldsView(state.fields, idx=cand)
        vals = jnp.where(mask, coeff(pview, qview, r_safe, **params), 0.0)
        rows = jnp.broadcast_to(i_idx, cand.shape)
        datas.append(vals.ravel())
        rows_l.append(jnp.where(mask, rows, i_idx).ravel())
        cols_l.append(jnp.where(mask, cand, i_idx).ravel())
    data = jnp.concatenate(datas)
    indices = jnp.stack([jnp.concatenate(rows_l), jnp.concatenate(cols_l)],
                        axis=-1)
    return jsparse.BCOO((data, indices), shape=(N, N))
