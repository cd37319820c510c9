"""Trip-count-aware FLOP/byte accounting from jaxprs.

XLA's own ``compiled.cost_analysis()`` counts loop bodies ONCE (verified:
a 10-trip ``fori_loop`` over a 64³ matmul reports one body's flops), which
under-counts the ant engine by the product of its nested loops
(frame_skip × rk4 stages × Newton iters × line-search iters).  This walker
multiplies ``scan`` bodies by their static ``length`` — and since
``fori_loop`` with static bounds lowers to ``scan``, every loop in the
physics engine is counted exactly.  Genuine ``while_loop``s (data-dependent
trips, e.g. spawn rejection-resampling) take a caller-supplied expected
trip count.

Conventions (stated so MFU numbers are reproducible):

* one FLOP per scalar float op (add/mul/sub/div/min/max/…); transcendental
  and rsqrt/sqrt ops also count 1 (they cost more microscopically, but the
  vector units pipeline them — treating them as 1 under-states achieved FLOP/s,
  i.e. is conservative for MFU claims);
* ``dot_general`` counts 2·M·N·K·batch (multiply-add = 2);
* integer arithmetic, comparisons, selects, and data movement
  (broadcast/slice/gather/reshape/transpose/convert) count 0;
* ``cond`` branches count the maximum branch (the device executes one,
  but vmapped conds lower to selects of both — also conservative).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import numpy as np

__all__ = ["count_flops", "flops_of"]

# float ops counted as size-of-output FLOPs
_ELEMENTWISE = {
    "add", "sub", "mul", "div", "rem", "pow", "max", "min", "neg", "abs",
    "exp", "log", "log1p", "expm1", "tanh", "sin", "cos", "logistic",
    "sqrt", "rsqrt", "cbrt", "erf", "erf_inv", "atan2", "sign",
    "floor", "ceil", "round", "nextafter", "clamp", "square",
    "integer_pow", "cumsum", "cumprod", "cummax", "cummin",
}
_REDUCTIONS = {"reduce_sum", "reduce_prod", "reduce_max", "reduce_min",
               "reduce_and", "reduce_or", "argmax", "argmin",
               "reduce_precision"}
_RECURSE_KEYS = ("jaxpr", "call_jaxpr")


def _is_float(var) -> bool:
    try:
        return np.issubdtype(var.aval.dtype, np.floating)
    except Exception:
        return False


def _size(var) -> int:
    return int(np.prod(var.aval.shape)) if var.aval.shape else 1


def _dot_flops(eqn) -> float:
    a, b = eqn.invars[0].aval, eqn.invars[1].aval
    dnums = eqn.params["dimension_numbers"]
    (lc, rc), (lb, rb) = dnums
    batch = int(np.prod([a.shape[i] for i in lb])) if lb else 1
    k = int(np.prod([a.shape[i] for i in lc])) if lc else 1
    m = int(np.prod([a.shape[i] for i in range(a.ndim)
                     if i not in tuple(lc) + tuple(lb)]))
    n = int(np.prod([b.shape[i] for i in range(b.ndim)
                     if i not in tuple(rc) + tuple(rb)]))
    return 2.0 * batch * m * n * k


def count_flops(
    closed_jaxpr,
    while_trips: Optional[Callable[[object], float]] = None,
) -> float:
    """Total FLOPs of a ClosedJaxpr, loops multiplied by their trip counts.

    ``while_trips(eqn) -> float`` supplies expected trip counts for genuine
    ``while`` primitives (default 1 — a warning-free conservative floor).
    """
    total = 0.0
    for eqn in closed_jaxpr.jaxpr.eqns:
        name = eqn.primitive.name
        if name == "scan":
            body = count_flops(eqn.params["jaxpr"], while_trips)
            total += eqn.params["length"] * body
        elif name == "while":
            trips = while_trips(eqn) if while_trips else 1.0
            total += trips * (
                count_flops(eqn.params["body_jaxpr"], while_trips)
                + count_flops(eqn.params["cond_jaxpr"], while_trips)
            )
        elif name == "cond":
            total += max(
                count_flops(b, while_trips) for b in eqn.params["branches"]
            )
        elif name == "dot_general":
            total += _dot_flops(eqn)
        elif name in ("conv_general_dilated",):
            # not used by this repo's compute paths; treat via output size
            total += 2.0 * _size(eqn.outvars[0])
        elif name in _ELEMENTWISE:
            if _is_float(eqn.outvars[0]):
                total += _size(eqn.outvars[0])
        elif name in _REDUCTIONS:
            if _is_float(eqn.invars[0]):
                total += _size(eqn.invars[0])
        elif name == "custom_jvp_call" or name == "custom_vjp_call":
            total += count_flops(eqn.params["call_jaxpr"], while_trips)
        else:
            for k in _RECURSE_KEYS:
                sub = eqn.params.get(k) if hasattr(eqn, "params") else None
                if sub is not None and hasattr(sub, "jaxpr"):
                    total += count_flops(sub, while_trips)
                    break
    return total


def flops_of(fn, *args,
             while_trips: Optional[Callable[[object], float]] = None,
             **kwargs) -> float:
    """FLOPs of ``fn(*args, **kwargs)`` (traced, not executed)."""
    return count_flops(jax.make_jaxpr(fn, **kwargs)(*args),
                       while_trips=while_trips)
