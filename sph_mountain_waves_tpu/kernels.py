"""SPH smoothing kernels (L2).

Same five kernel families, normalization constants and call convention as the
reference (src/kernels.jl): every kernel is normalized so its *support radius*
is ``h`` (not the smoothing length), and each family exposes the value ``f``,
radial derivative ``Df = dw/dr`` and reduced derivative ``rDf = (dw/dr)/r``
(finite at r=0).

Differences from the reference's scalar ``@fastmath`` Julia:
  * every function is **branchless and elementwise** — compact support is
    enforced with clamps/``where`` so the same code vectorizes over ``[N, K]``
    pair blocks and is jit/vmap/grad-safe,
  * ``h`` may itself be an array (per-pair smoothing lengths — needed by the
    Hopkins adaptive-h schemes, reference src/current/hopkins_total_witch.jl:233-247).

Reference citations: spline23 src/kernels.jl:14-60, spline24 :69-99,
wendland2 :108-147, wendland3 :156-204 (incl. DDwendland3 :197-204),
wendland1 :206-228.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "wendland1", "Dwendland1", "rDwendland1",
    "wendland2", "Dwendland2", "rDwendland2",
    "wendland3", "Dwendland3", "rDwendland3", "DDwendland3",
    "spline23", "Dspline23", "rDspline23",
    "spline24", "Dspline24", "rDspline24",
]

# normalization constants, identical to src/kernels.jl
_C_SPLINE23 = 1.8189136353359467       # 40/(7π)
_C_DSPLINE23 = 10.91348181201568       # 240/(7π)
_C_SPLINE24 = 6.222175110452539
_C_DSPLINE24 = 24.888700441810155
_C_W2 = 2.228169203286535              # 7/π
_C_DW2 = 44.563384065730695            # 140/π
_C_W3 = 3.3422538049298023             # 21/(2π)
_C_DW3 = 66.84507609859604             # 210/π


def _pos(x):
    """max(x, 0) — reference ``pos`` clamp (src/kernels.jl:3-5)."""
    return jnp.maximum(x, 0.0)


# --------------------------------------------------------------------------
# Wendland C2 quintic family (1-D, 2-D, 3-D)
# --------------------------------------------------------------------------

def wendland1(h, r):
    """1-D quintic Wendland kernel value (src/kernels.jl:206-212)."""
    x = r / h
    t = _pos(1.0 - x)
    return 1.5 * t**4 * (1.0 + 4.0 * x) / h


def Dwendland1(h, r):
    """dw/dr of wendland1 (src/kernels.jl:214-220)."""
    x = r / h
    t = _pos(1.0 - x)
    return -30.0 * x * t**3 / h**2


def rDwendland1(h, r):
    """(dw/dr)/r of wendland1, finite at r=0 (src/kernels.jl:222-228)."""
    x = r / h
    t = _pos(1.0 - x)
    return -30.0 * t**3 / h**3


def wendland2(h, r):
    """2-D quintic Wendland kernel value (src/kernels.jl:108-115)."""
    x = r / h
    t = _pos(1.0 - x)
    return _C_W2 * t**4 * (1.0 + 4.0 * x) / h**2


def Dwendland2(h, r):
    """dw/dr of wendland2 (src/kernels.jl:124-131)."""
    x = r / h
    t = _pos(1.0 - x)
    return -_C_DW2 * x * t**3 / h**3


def rDwendland2(h, r):
    """(dw/dr)/r of wendland2, finite at r=0 (src/kernels.jl:140-147)."""
    x = r / h
    t = _pos(1.0 - x)
    return -_C_DW2 * t**3 / h**4


def wendland3(h, r):
    """3-D quintic Wendland kernel value (src/kernels.jl:156-163)."""
    x = r / h
    t = _pos(1.0 - x)
    return _C_W3 * t**4 * (1.0 + 4.0 * x) / h**3


def Dwendland3(h, r):
    """dw/dr of wendland3 (src/kernels.jl:172-179)."""
    x = r / h
    t = _pos(1.0 - x)
    return -_C_DW3 * x * t**3 / h**4


def rDwendland3(h, r):
    """(dw/dr)/r of wendland3, finite at r=0 (src/kernels.jl:188-195)."""
    x = r / h
    t = _pos(1.0 - x)
    return -_C_DW3 * t**3 / h**5


def DDwendland3(h, r):
    """Second radial derivative of wendland3 (src/kernels.jl:197-204),
    used by the surface-tension example (sph_jl/examples/drop.jl:101-112)."""
    x = r / h
    t = _pos(1.0 - x)
    return -_C_DW3 * (1.0 - 4.0 * x) * t**2 / h**5


# --------------------------------------------------------------------------
# 2-D cubic spline (spline23)
# --------------------------------------------------------------------------

def spline23(h, r):
    """2-D cubic spline value (src/kernels.jl:14-24)."""
    x = r / h
    inner = _C_SPLINE23 * (1.0 - 6.0 * x**2 + 6.0 * x**3)
    outer_ = 2.0 * _C_SPLINE23 * _pos(1.0 - x) ** 3
    return jnp.where(x < 0.5, inner, outer_) / h**2


def Dspline23(h, r):
    """dw/dr of spline23 (src/kernels.jl:33-42)."""
    x = r / h
    inner = -_C_DSPLINE23 * (2.0 * x - 3.0 * x**2)
    outer_ = -_C_DSPLINE23 * _pos(1.0 - x) ** 2
    return jnp.where(x < 0.5, inner, outer_) / h**3


def rDspline23(h, r):
    """(dw/dr)/r of spline23, finite at r=0 (src/kernels.jl:51-60)."""
    x = r / h
    inner = -_C_DSPLINE23 * (2.0 - 3.0 * x)
    # guard the 1/x in the outer branch; where() selects the inner branch at
    # small x so the guarded value is never used
    x_safe = jnp.maximum(x, 0.5)
    outer_ = -_C_DSPLINE23 * _pos(1.0 - x) ** 2 / x_safe
    return jnp.where(x < 0.5, inner, outer_) / h**4


# --------------------------------------------------------------------------
# 2-D quartic spline (spline24)
# --------------------------------------------------------------------------

def spline24(h, r):
    """2-D quartic spline value (src/kernels.jl:69-72)."""
    x = r / h
    return _C_SPLINE24 * (
        _pos(1.0 - x) ** 4 - 5.0 * _pos(0.6 - x) ** 4 + 10.0 * _pos(0.2 - x) ** 4
    ) / h**2


def Dspline24(h, r):
    """dw/dr of spline24 (src/kernels.jl:81-84)."""
    x = r / h
    return -_C_DSPLINE24 * (
        _pos(1.0 - x) ** 3 - 5.0 * _pos(0.6 - x) ** 3 + 10.0 * _pos(0.2 - x) ** 3
    ) / h**3


def rDspline24(h, r):
    """(dw/dr)/r of spline24, finite at r=0 (src/kernels.jl:93-99)."""
    x = r / h
    x_safe = jnp.maximum(x, 0.2)
    outer_ = -_C_DSPLINE24 * (_pos(1.0 - x) ** 3 - 5.0 * _pos(0.6 - x) ** 3) / x_safe
    inner = -_C_DSPLINE24 * (1.2 - 6.0 * x**2)
    return jnp.where(x > 0.2, outer_, inner) / h**4
