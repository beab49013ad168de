"""Krylov solvers over tensors and (u, p) block vectors.

Semantics mirror the deal.II solvers the reference dispatches to
(NSSolver.cpp:601-672) and the JAX package's ``krylov/solvers.py``:

  * absolute tolerance on the residual norm (``SolverControl(maxit, tol)``);
  * an initial check at step 0 -- a converged initial guess reports 0
    iterations, which the reference's Newton loop uses as a stagnation
    signal (NSSolver.cpp:721-722);
  * GMRES is left-preconditioned, FGMRES right-preconditioned, both
    restarted (basis 30 by default), CG monitors the true residual.

The JAX package runs each solve as one ``lax.while_loop`` program; here the
loops are Python loops.  The vector work (matvecs, preconditioners, CGS2
orthogonalization) stays on the tensors' device, and each iteration reads
back to the host exactly once: the new Hessenberg column (GMRES), the
residual norm and curvature (CG), or the residual norm and the three
breakdown denominators (BiCGStab).  The (basis+1) x basis Hessenberg
system, its Givens rotations and the final triangular solve are tiny and
run on the host in NumPy, in the cycle's working precision.

Operators and preconditioners are callables ``x -> y`` over a tensor or a
tuple of tensors (``Blocks``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

__all__ = ["SolveInfo", "LowCycle", "gmres", "fgmres", "bicgstab", "cg", "tvdot", "tnorm"]

Op = Callable

_EPS_BREAKDOWN = 1e-300


class LowCycle(NamedTuple):
    """Low-precision restart-cycle configuration for GMRES-IR.

    Restarted GMRES recomputes the true residual at every restart; running
    the Arnoldi cycles in reduced precision while keeping that restart
    residual (and the solution accumulation) in the operator precision is
    GMRES-based iterative refinement (Carson & Higham, SIAM J. Sci.
    Comput. 40(2), 2018).

    ``matvec``/``M`` operate in ``dtype`` (default float32).  ``eta``
    floors the in-cycle residual reduction: the cycle stops at
    ``eta * beta`` and returns to the full-precision restart.  ``stall``:
    if a full cycle fails to reduce the true residual below ``stall *`` its
    previous value, the solve stops reporting non-convergence (callers
    fall back to full-precision cycles).
    """

    matvec: Op
    M: Op | None = None
    dtype: Any = None
    eta: float = 1e-6
    stall: float = 0.99


class SolveInfo(NamedTuple):
    iters: int  # deal.II solver_control.last_step()
    converged: bool  # res <= tol AND finite (never true on breakdown)
    resnorm: float  # final (estimated) residual norm
    # the iteration broke down (non-finite residual / vanishing pivot)
    # before reaching the tolerance -- deal.II's SolverControl would throw
    # ``NoConvergence`` here; callers must not use the iterate as converged.
    failed: bool = False


# ---------------------------------------------------------------------------
# vector helpers over a tensor or a tuple of tensors
# ---------------------------------------------------------------------------


def _leaves(x) -> tuple:
    return tuple(x) if isinstance(x, tuple) else (x,)


def _pack(like, leaves):
    return type(like)(*leaves) if isinstance(like, tuple) else leaves[0]


def _map(fn, *xs):
    return _pack(xs[0], [fn(*ls) for ls in zip(*map(_leaves, xs))])


def _sum(terms):
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def tvdot(x, y) -> torch.Tensor:
    return _sum(
        [torch.dot(a.reshape(-1), b.reshape(-1)) for a, b in zip(_leaves(x), _leaves(y))]
    )


def tnorm(x) -> torch.Tensor:
    return torch.sqrt(tvdot(x, x))


def _identity(x):
    return x


def _cast(x, dtype):
    return _map(lambda a: a.to(dtype), x)


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


# ---------------------------------------------------------------------------
# (F)GMRES
# ---------------------------------------------------------------------------


def _givens_column(col, cs, sn, j, eps):
    """Apply the stored rotations to Hessenberg column ``j`` and build the
    rotation that annihilates ``col[j+1]`` (all in col's NumPy dtype)."""
    for i in range(j):
        a, b = col[i], col[i + 1]
        col[i] = cs[i] * a + sn[i] * b
        col[i + 1] = -sn[i] * a + cs[i] * b
    a, b = col[j], col[j + 1]
    denom = np.sqrt(a * a + b * b)
    one, zero = col.dtype.type(1), col.dtype.type(0)
    c_new = a / np.maximum(denom, eps) if denom > 0 else one
    s_new = b / np.maximum(denom, eps) if denom > 0 else zero
    col[j] = c_new * a + s_new * b
    col[j + 1] = zero
    return c_new, s_new


def _back_substitute(R, g, j):
    """Solve R[:j, :j] y = g[:j] (upper triangular); non-finite -> 0."""
    y = np.zeros(j, R.dtype)
    with np.errstate(all="ignore"):
        for i in range(j - 1, -1, -1):
            y[i] = (g[i] - np.dot(R[i, i + 1 : j], y[i + 1 : j])) / R[i, i]
    return np.where(np.isfinite(y), y, R.dtype.type(0))


def _arnoldi_cycle(
    r, beta, beta_w, tol_w, iters, maxiter, basis, flexible, matvec, M, init_done
):
    """One restart cycle in the working precision of ``r``.

    ``beta`` is ``||r||`` as a 0-dim tensor, ``beta_w`` the same value on
    the host in the working NumPy dtype.  Returns ``(corr, iters, res,
    done)``: the correction to add to the iterate (None when no iteration
    ran), the updated count, the in-cycle (Givens) residual estimate and
    the in-cycle stop flag.
    """
    rl = _leaves(r)
    wd = _NP_DTYPES[rl[0].dtype]
    eps = wd(_EPS_BREAKDOWN)
    V = [l.new_zeros((basis + 1,) + l.shape) for l in rl]
    Z = [l.new_zeros((basis,) + l.shape) for l in rl] if flexible else None
    inv = 1.0 / torch.clamp_min(beta, _EPS_BREAKDOWN)
    for Vl, l in zip(V, rl):
        Vl[0] = inv * l
    Vf = [Vl.reshape(basis + 1, -1) for Vl in V]
    R = np.zeros((basis + 1, basis), wd)
    cs = np.zeros(basis, wd)
    sn = np.zeros(basis, wd)
    g = np.zeros(basis + 1, wd)
    g[0] = beta_w
    j, res, done = 0, beta_w, init_done

    while not done and j < basis and iters < maxiter:
        vj = _pack(r, [Vl[j] for Vl in V])
        if flexible:
            zj = M(vj)
            for Zl, l in zip(Z, _leaves(zj)):
                Zl[j] = l
            w = matvec(zj)
        else:
            w = M(matvec(vj))
        wl = [l.reshape(-1) for l in _leaves(w)]
        # Batched CGS2: all <v_i, w> in one contraction over the stacked
        # basis (rows beyond j are zero), one stacked update, repeated once
        # (classical Gram-Schmidt with reorthogonalization).
        col_d = None
        for _ in range(2):
            h = _sum([Vfl @ l for Vfl, l in zip(Vf, wl)])
            wl = [l - h @ Vfl for Vfl, l in zip(Vf, wl)]
            col_d = h if col_d is None else col_d + h
        hj1 = torch.sqrt(_sum([torch.dot(l, l) for l in wl]))
        inv = 1.0 / torch.clamp_min(hj1, _EPS_BREAKDOWN)
        for Vl, l in zip(V, wl):
            Vl[j + 1] = (inv * l).reshape(Vl.shape[1:])
        # the one host readback of this iteration
        col = np.zeros(basis + 1, wd)
        col[: j + 2] = torch.cat([col_d[: j + 1], hj1.reshape(1)]).cpu().numpy()
        c_new, s_new = _givens_column(col, cs, sn, j, eps)
        gj = g[j]
        g[j] = c_new * gj
        g[j + 1] = -s_new * gj
        res = np.abs(g[j + 1])
        R[:, j] = col
        cs[j], sn[j] = c_new, s_new
        j += 1
        iters += 1
        done = bool(res <= tol_w) or not np.isfinite(res)

    if j == 0:
        return None, iters, res, done
    y = torch.as_tensor(_back_substitute(R, g, j), device=rl[0].device)
    src = Z if flexible else V
    corr = _pack(r, [(y @ S[:j].reshape(j, -1)).reshape(S.shape[1:]) for S in src])
    return corr, iters, res, done


def _gmres_core(
    matvec: Op,
    b,
    x0,
    *,
    tol,
    maxiter: int,
    M: Op | None,
    basis: int,
    flexible: bool,
    lo: LowCycle | None = None,
):
    """Shared GMRES/FGMRES implementation with restarts and Givens updates.

    ``lo``: run the Arnoldi restart cycles in reduced precision (GMRES-IR;
    see ``LowCycle``).  The restart residual ``b - A x`` and the solution
    accumulation stay in the operator precision.
    """
    M = M or _identity
    tol = float(tol)
    hi = _leaves(b)[0].dtype
    if lo is not None:
        wd = lo.dtype or torch.float32
        w_mv, w_M = lo.matvec, lo.M or _identity
    else:
        wd, w_mv, w_M = hi, matvec, M
    wd_np = _NP_DTYPES[wd]

    def initial_residual(x):
        r = _map(torch.sub, b, matvec(x))
        if not flexible:
            r = _cast(w_M(_cast(r, wd)), hi) if lo is not None else M(r)
        return r

    def add_corr(x, corr):
        return x if corr is None else _map(lambda a, c: a + c.to(a.dtype), x, corr)

    def cycle(r, beta, beta_h, tol_w, iters, init_done):
        return _arnoldi_cycle(
            r, beta, wd_np(beta_h), tol_w, iters, maxiter, basis, flexible,
            w_mv, w_M, init_done,
        )

    x = x0
    iters = 0
    if lo is None:
        # ---- full-precision restarted GMRES (reference semantics) ----
        tol_w = wd_np(tol)
        r = initial_residual(x0)
        beta = tnorm(r)
        beta_h = float(beta)
        res, done = beta_h, beta_h <= tol  # deal.II SolverControl step 0
        while not done and iters < maxiter:
            corr, iters, res, done = cycle(r, beta, beta_h, tol_w, iters, beta_h <= tol)
            x = add_corr(x, corr)
            if not done and iters < maxiter:  # restart from the true residual
                r = initial_residual(x)
                beta = tnorm(r)
                beta_h = float(beta)
        res = float(res)
        finite = math.isfinite(res)
        # ``done`` also fires on a non-finite residual: report that as a
        # breakdown, not as convergence (deal.II check_failure analog)
        return x, SolveInfo(iters, done and finite, res, not finite)

    # ---- GMRES-IR: low-precision cycles, full-precision restarts ----
    res = stall_ref = math.inf
    done = False
    while not done and iters < maxiter:
        r_hi = initial_residual(x)
        beta_hi = tnorm(r_hi)
        bh = float(beta_hi)
        finite = math.isfinite(bh)
        # stop before the cycle when converged, broken down, or when the
        # previous full cycle failed to reduce the true residual
        stop = bh <= tol or not finite or bh > lo.stall * stall_ref
        # one low-precision cycle cannot reduce the residual below
        # ~eps(lo) relative to the restart residual: stop it at eta * beta
        tol_w = wd_np(max(tol, lo.eta * bh))
        corr, iters, _, _ = cycle(
            _cast(r_hi, wd), beta_hi.to(wd), bh, tol_w, iters, stop
        )
        if not stop:
            x = add_corr(x, corr)
        res = stall_ref = bh
        done = stop
    # exits: converged, non-finite (breakdown), stall (callers fall back to
    # lo=None) or maxiter; ``res`` is always the true recomputed residual.
    finite = math.isfinite(res)
    return x, SolveInfo(iters, done and finite and res <= tol, res, not finite)


def gmres(matvec, b, x0, *, tol, maxiter=1000, M=None, basis=30, lo=None):
    """Left-preconditioned restarted GMRES (deal.II ``SolverGMRES``)."""
    return _gmres_core(
        matvec, b, x0, tol=tol, maxiter=maxiter, M=M, basis=basis,
        flexible=False, lo=lo,
    )


def fgmres(matvec, b, x0, *, tol, maxiter=1000, M=None, basis=30, lo=None):
    """Flexible (right-preconditioned) GMRES (deal.II ``SolverFGMRES``)."""
    return _gmres_core(
        matvec, b, x0, tol=tol, maxiter=maxiter, M=M, basis=basis,
        flexible=True, lo=lo,
    )


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------


def bicgstab(matvec, b, x0, *, tol, maxiter=1000, M=None):
    """Preconditioned BiCGStab (deal.II ``SolverBicgstab``), in the JAX
    package's order of operations.

    Breakdown guard: a vanishing ``rho = <rbar, r>``, ``<rbar, v>`` or
    ``<t, t>`` (below ``_EPS_BREAKDOWN``) or a non-finite residual freezes
    the iterate at the previous step and stops with ``failed`` -- deal.II's
    SolverControl would throw ``NoConvergence`` there.  The failed step
    still counts as an iteration, as in the JAX loop.
    """
    M = M or _identity
    tol = float(tol)
    scale = lambda a, x: _map(lambda xi: a * xi, x)
    r = _map(torch.sub, b, matvec(x0))
    rbar = r
    res = float(tnorm(r))
    x = x0
    p = v = _map(torch.zeros_like, r)
    one = torch.ones((), dtype=_leaves(r)[0].dtype, device=_leaves(r)[0].device)
    rho = alpha = omega = one
    it, done, failed = 0, res <= tol, False
    while not done and not failed and it < maxiter:
        rho_new = tvdot(rbar, r)
        beta = (rho_new / rho) * (alpha / omega)
        p_new = _map(lambda pi, vi, ri: beta * (pi - omega * vi) + ri, p, v, r)
        y = M(p_new)
        v_new = matvec(y)
        denom = tvdot(rbar, v_new)
        alpha_new = rho_new / denom
        s = _map(lambda ri, vi: ri - alpha_new * vi, r, v_new)
        z = M(s)
        t = matvec(z)
        tt = tvdot(t, t)
        omega_new = tvdot(t, s) / tt
        x_new = _map(torch.add, x, _map(torch.add, scale(alpha_new, y), scale(omega_new, z)))
        r_new = _map(lambda si, ti: si - omega_new * ti, s, t)
        # the one host readback of this iteration
        rho_h, denom_h, tt_h, res_new = torch.stack(
            [rho_new, denom, tt, tnorm(r_new)]
        ).tolist()
        it += 1
        failed = (
            abs(rho_h) < _EPS_BREAKDOWN
            or abs(denom_h) < _EPS_BREAKDOWN
            or abs(tt_h) < _EPS_BREAKDOWN
            or not math.isfinite(res_new)
        )
        if failed:
            break
        x, r, p, v, res = x_new, r_new, p_new, v_new, res_new
        rho, alpha, omega = rho_new, alpha_new, omega_new
        done = res <= tol
    return x, SolveInfo(it, done, res, failed)


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------


def cg(matvec, b, x0, *, tol, maxiter=1000, M=None):
    """Preconditioned CG (deal.II ``SolverCG``), true-residual check."""
    M = M or _identity
    tol = float(tol)
    axpy = lambda a, x, y: _map(lambda xi, yi: a * xi + yi, x, y)
    r = _map(torch.sub, b, matvec(x0))
    res = float(tnorm(r))
    z = M(r)
    rz = tvdot(r, z)
    x, d = x0, z
    it, done, failed = 0, res <= tol, False
    while not done and not failed and it < maxiter:
        q = matvec(d)
        dq = tvdot(d, q)
        alpha = rz / dq
        x_new = axpy(alpha, d, x)
        r_new = axpy(-alpha, q, r)
        res_new, dq_h = torch.stack([tnorm(r_new), dq]).tolist()
        it += 1
        # breakdown guard: on a vanishing curvature or non-finite update,
        # keep the previous iterate (best achievable) and stop
        if not (math.isfinite(res_new) and abs(dq_h) > _EPS_BREAKDOWN):
            failed = True
            break
        x, r, res = x_new, r_new, res_new
        done = res <= tol
        if done:
            break
        z = M(r)
        rz_new = tvdot(r, z)
        d = axpy(rz_new / rz, d, z)
        rz = rz_new
    return x, SolveInfo(it, done, res, failed)
