"""Batched Krylov solvers: B independent systems advanced together.

An ensemble (``ensemble/``) solves one system per member, every vector
carrying a leading member axis.  The JAX package runs it as ``vmap`` over
its solvers' ``lax.while_loop``s: a batched loop runs while any member's
condition holds, and a member whose condition is false keeps its carry.
Here each member has its own Arnoldi coefficients, Givens rotations,
residual estimate, iteration count and stop (GMRES/FGMRES), or its own
step lengths and stop (CG), so each member's counts are those of its
standalone solve, and its iterate differs from that solve's by the
rounding of the batched products only.

Frozen members.  A member that has stopped is selected out with
``torch.where``: its iterate, basis rows and search directions no longer
change.  Its input to the operator and preconditioner is zeroed, so the
nested solves of the preconditioner stop at once for it; no product mixes
members, and every loop decision is the running members' own, so nothing
of a frozen member -- a 0/0 of a converged normalisation included, which
the clamps below also guard -- reaches an active one.

Each iteration reads back one [B] row to the host: the Hessenberg
columns (GMRES), the residual norms and curvatures (CG), the residual
norms and the three breakdown denominators (BiCGStab).  The (basis+1) x
basis Hessenberg systems and their rotations are run on the host in
NumPy, vectorized over the members, in the cycle's working precision --
the arithmetic of ``solvers._givens_column``, element for element; the
back substitution is ``solvers._back_substitute`` itself, member by
member.  ``SolveInfo``'s fields are [B] NumPy arrays.

GMRES-IR cycles (``LowCycle``, ``solvers._gmres_core``'s ``lo``) run per
member: each member's restart residual and iterate stay in the operator
dtype, its cycle tolerance is ``max(tol, lo.eta * beta)`` and its stall
reference its own previous restart residual; a member that stops
(converged, non-finite, or stalled) keeps its iterate and its count while
the others cycle on.  One [B] row is read back per restart.
"""

from __future__ import annotations

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.krylov.solvers import (
    _EPS_BREAKDOWN,
    _NP_DTYPES,
    SolveInfo,
    LowCycle,
    _back_substitute,
    _cast,
    _identity,
    _leaves,
    _map,
    _pack,
)

__all__ = ["bvdot", "bnorm", "gmres_batched", "fgmres_batched", "bicgstab_batched", "cg_batched"]


def bvdot(x, y) -> torch.Tensor:
    """Per-member inner products [B] of two batched tensors or tuples of
    them (summed over the tuple)."""
    out = None
    for a, b in zip(_leaves(x), _leaves(y)):
        d = torch.linalg.vecdot(a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1))
        out = d if out is None else out + d
    return out


def bnorm(x) -> torch.Tensor:
    """Per-member l2 norms [B]."""
    return torch.sqrt(bvdot(x, x))


def _col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[B] -> broadcastable against ``like`` [B, ...]."""
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def _select(mask: torch.Tensor, a, b):
    """Per member: ``a`` where ``mask`` [B] holds, else ``b`` (tensors or
    tuples of them)."""
    return _map(lambda x, y: torch.where(_col(mask, x), x, y), a, b)


def _host_tol(tol, batch: int) -> np.ndarray:
    """A number, a [B] tensor (one readback) or array -> [B] float64."""
    if isinstance(tol, torch.Tensor):
        tol = tol.detach().cpu().numpy()
    return np.broadcast_to(np.asarray(tol, dtype=np.float64), (batch,)).copy()


def _mask_on(mask: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(mask, device=device)


# ---------------------------------------------------------------------------
# (F)GMRES
# ---------------------------------------------------------------------------


def _givens_columns(col, cs, sn, j, eps):
    """``solvers._givens_column`` for every member at once: ``col`` [B, *]
    (rotated in place), ``cs``, ``sn`` [B, basis]; returns the new rotation
    ``(c, s)``, each [B]."""
    for i in range(j):
        a, b = col[:, i].copy(), col[:, i + 1].copy()
        col[:, i] = cs[:, i] * a + sn[:, i] * b
        col[:, i + 1] = -sn[:, i] * a + cs[:, i] * b
    a, b = col[:, j].copy(), col[:, j + 1].copy()
    denom = np.sqrt(a * a + b * b)
    one, zero = col.dtype.type(1), col.dtype.type(0)
    d = np.maximum(denom, eps)
    c_new = np.where(denom > 0, a / d, one)
    s_new = np.where(denom > 0, b / d, zero)
    col[:, j] = c_new * a + s_new * b
    col[:, j + 1] = zero
    return c_new, s_new


def _arnoldi_cycle(r, beta, beta_w, tol_w, iters, maxiter, basis, flexible, matvec, M, run0):
    """One restart cycle of the members in ``run0`` ([B] bool), in the
    working precision of ``r``.  ``beta`` [B] on the device, ``beta_w`` the
    same on the host in the working dtype.  Returns ``(corr, iters, res,
    done, steps)``: the corrections [B, ...] (None when no member ran), the
    updated counts, the Givens residual estimates, the in-cycle stop flags
    and each member's iterations in this cycle.  Members outside ``run0``
    keep their entries."""
    rl = _leaves(r)
    B, dev = rl[0].shape[0], rl[0].device
    wd = _NP_DTYPES[rl[0].dtype]
    eps = wd(_EPS_BREAKDOWN)
    flat = [l.reshape(B, -1) for l in rl]
    V = [l.new_zeros((B, basis + 1, l.shape[1])) for l in flat]
    Z = [l.new_zeros((B, basis, l.shape[1])) for l in flat] if flexible else None
    run_t = _mask_on(run0, dev)
    inv = 1.0 / torch.clamp_min(beta, _EPS_BREAKDOWN)
    for Vl, l in zip(V, flat):
        Vl[:, 0] = torch.where(run_t[:, None], inv[:, None] * l, 0.0)
    R = np.zeros((B, basis + 1, basis), wd)
    cs = np.zeros((B, basis), wd)
    sn = np.zeros((B, basis), wd)
    g = np.zeros((B, basis + 1), wd)
    g[:, 0] = beta_w
    res = beta_w.copy()
    done = ~run0
    steps = np.zeros(B, np.int64)
    iters = iters.copy()
    shapes = [l.shape for l in rl]
    unflat = lambda ls: _pack(r, [l.reshape(s) for l, s in zip(ls, shapes)])
    j = 0
    while j < basis:
        run = ~done & (iters < maxiter)
        if not run.any():
            break
        run_t = _mask_on(run, dev)
        # a stopped member's input is zero: the nested solves stop at once
        vj = unflat([torch.where(run_t[:, None], Vl[:, j], 0.0) for Vl in V])
        if flexible:
            zj = M(vj)
            zl = [l.reshape(B, -1) for l in _leaves(zj)]
            for Zl, l in zip(Z, zl):
                Zl[:, j] = torch.where(run_t[:, None], l, 0.0)
            w = matvec(zj)
        else:
            w = M(matvec(vj))
        wl = [l.reshape(B, -1) for l in _leaves(w)]
        # batched CGS2 (see solvers._arnoldi_cycle): rows beyond j are zero
        col_d = None
        for _ in range(2):
            h = sum(torch.bmm(Vl, l[:, :, None])[:, :, 0] for Vl, l in zip(V, wl))
            wl = [l - torch.bmm(h[:, None, :], Vl)[:, 0] for Vl, l in zip(V, wl)]
            col_d = h if col_d is None else col_d + h
        hj1 = torch.sqrt(sum(torch.linalg.vecdot(l, l) for l in wl))
        inv = 1.0 / torch.clamp_min(hj1, _EPS_BREAKDOWN)
        for Vl, l in zip(V, wl):
            Vl[:, j + 1] = torch.where(run_t[:, None], inv[:, None] * l, 0.0)
        # the one host readback of this iteration: [B, j + 2]
        col = np.zeros((B, basis + 1), wd)
        col[:, : j + 2] = torch.cat([col_d[:, : j + 1], hj1[:, None]], dim=1).cpu().numpy()
        with np.errstate(all="ignore"):  # stopped members' lanes may hold anything
            c_new, s_new = _givens_columns(col, cs, sn, j, eps)
            gj = g[:, j].copy()
            g[run, j] = (c_new * gj)[run]
            g[run, j + 1] = (-s_new * gj)[run]
            res[run] = np.abs(g[run, j + 1])
        R[run, :, j] = col[run]
        cs[run, j], sn[run, j] = c_new[run], s_new[run]
        iters[run] += 1
        steps[run] += 1
        with np.errstate(invalid="ignore"):
            done = done | (run & ((res <= tol_w) | ~np.isfinite(res)))
        j += 1
    if j == 0:
        return None, iters, res, done, steps
    y = np.zeros((B, j), wd)
    for m in np.flatnonzero(steps):
        y[m, : steps[m]] = _back_substitute(R[m], g[m], int(steps[m]))
    y_t = torch.as_tensor(y, device=dev)[:, None, :]
    src = Z if flexible else V
    corr = unflat([torch.bmm(y_t, S[:, :j])[:, 0] for S in src])
    return corr, iters, res, done, steps


def _gmres_core(matvec, b, x0, *, tol, maxiter: int, M, basis: int, flexible: bool, active=None,
                lo: LowCycle | None = None):
    """``solvers._gmres_core`` for B members.

    ``tol``: a number or per-member [B] tolerances (absolute).  ``active``:
    optional [B] bool (host) -- members outside it do not iterate and keep
    ``x0``.  ``lo``: GMRES-IR restart cycles (``_gmres_ir``).
    """
    M = M or _identity
    bl = _leaves(b)
    B, dev = bl[0].shape[0], bl[0].device
    tol_h = _host_tol(tol, B)
    act = np.ones(B, bool) if active is None else np.asarray(active, bool).copy()
    if lo is not None:
        return _gmres_ir(matvec, b, x0, tol_h, maxiter, basis, flexible, act, lo)
    wd_np = _NP_DTYPES[bl[0].dtype]
    tol_w = tol_h.astype(wd_np)

    def initial_residual(x):
        r = _map(torch.sub, b, matvec(x))
        return r if flexible else M(r)

    x = x0
    iters = np.zeros(B, np.int64)
    r = initial_residual(x0)
    beta = bnorm(r)
    beta_h = beta.cpu().numpy().astype(np.float64)
    res = beta_h.copy()
    with np.errstate(invalid="ignore"):
        done = ~act | (beta_h <= tol_h)  # deal.II SolverControl step 0
    while True:
        run = ~done & (iters < maxiter)
        if not run.any():
            break
        corr, iters, res_c, done_c, steps = _arnoldi_cycle(
            r, beta, beta_h.astype(wd_np), tol_w, iters, maxiter, basis, flexible, matvec, M, run
        )
        if corr is not None:
            x = _select(_mask_on(steps > 0, dev), _map(lambda a, c: a + c.to(a.dtype), x, corr), x)
        res = np.where(run, res_c.astype(np.float64), res)
        done = np.where(run, done_c, done)
        again = ~done & (iters < maxiter)
        if again.any():  # restart from the true residual
            r = initial_residual(x)
            beta = bnorm(r)
            beta_h = beta.cpu().numpy().astype(np.float64)
            with np.errstate(invalid="ignore"):
                stop = again & (beta_h <= tol_h)
            res = np.where(stop, beta_h.astype(wd_np).astype(np.float64), res)
            done = done | stop
    finite = np.isfinite(res)
    # a non-finite residual is a breakdown, not convergence (deal.II check_failure)
    return x, SolveInfo(iters, done & finite & act, res, ~finite)


def _gmres_ir(matvec, b, x0, tol_h, maxiter, basis, flexible, act, lo: LowCycle):
    """GMRES-IR for B members (``solvers._gmres_core`` with ``lo``): the
    Arnoldi cycles in ``lo.dtype`` through ``lo.matvec`` and ``lo.M``, the
    restart residual ``b - A x`` and the iterate in the operator dtype.
    Per member, at every restart: stop before the cycle when the true
    residual is at or below ``tol``, not finite, or above ``lo.stall``
    times the previous restart's (the previous cycle failed to reduce it);
    otherwise one cycle to ``max(tol, lo.eta * beta)`` in the working
    dtype (the full-precision preconditioner is not used: the
    left-preconditioned restart residual takes ``lo.M``, as in
    ``solvers._gmres_core``).  A stopped member keeps its iterate and its
    count -- the JAX
    package's ``vmap`` of the loop, where a member whose condition is false
    keeps its carry -- and ``resnorm`` is its last true residual."""
    hi = _leaves(b)[0].dtype
    wd = lo.dtype or torch.float32
    wd_np = _NP_DTYPES[wd]
    w_mv, w_M = lo.matvec, lo.M or _identity
    B, dev = tol_h.shape[0], _leaves(b)[0].device

    def initial_residual(x, run):
        r = _map(torch.sub, b, matvec(x))
        if flexible:
            return r
        # a stopped member's input is zero: the nested solves stop at once
        r = _select(_mask_on(run, dev), r, _map(torch.zeros_like, r))
        return _cast(w_M(_cast(r, wd)), hi)

    x = x0
    iters = np.zeros(B, np.int64)
    res = np.full(B, np.inf)
    stall_ref = np.full(B, np.inf)
    done = ~act
    while True:
        run = ~done & (iters < maxiter)
        if not run.any():
            break
        r_hi = initial_residual(x, run)
        beta_hi = bnorm(r_hi)
        bh = beta_hi.cpu().numpy().astype(np.float64)  # the one readback of this restart
        with np.errstate(invalid="ignore"):
            stop = run & ((bh <= tol_h) | ~np.isfinite(bh) | (bh > lo.stall * stall_ref))
            # one low-precision cycle cannot reduce the residual below
            # ~eps(lo) relative to the restart residual: stop it at eta * beta
            tol_w = np.maximum(tol_h, lo.eta * bh).astype(wd_np)
        cyc = run & ~stop
        if cyc.any():
            corr, iters, _, _, steps = _arnoldi_cycle(
                _cast(r_hi, wd), beta_hi.to(wd), bh.astype(wd_np), tol_w, iters, maxiter, basis,
                flexible, w_mv, w_M, cyc,
            )
            if corr is not None:
                x = _select(_mask_on(steps > 0, dev), _map(lambda a, c: a + c.to(a.dtype), x, corr), x)
        res = np.where(run, bh, res)
        stall_ref = np.where(run, bh, stall_ref)
        done = done | stop
    # exits: converged, non-finite (breakdown), stall or maxiter; ``res`` is
    # each member's last true residual
    finite = np.isfinite(res)
    with np.errstate(invalid="ignore"):
        converged = done & finite & act & (res <= tol_h)
    return x, SolveInfo(iters, converged, res, act & ~finite)


def gmres_batched(matvec, b, x0, *, tol, maxiter=1000, M=None, basis=30, active=None, lo=None):
    """Left-preconditioned restarted GMRES of each member (``solvers.gmres``)."""
    return _gmres_core(matvec, b, x0, tol=tol, maxiter=maxiter, M=M, basis=basis,
                       flexible=False, active=active, lo=lo)


def fgmres_batched(matvec, b, x0, *, tol, maxiter=1000, M=None, basis=30, active=None, lo=None):
    """Flexible GMRES of each member (``solvers.fgmres``)."""
    return _gmres_core(matvec, b, x0, tol=tol, maxiter=maxiter, M=M, basis=basis,
                       flexible=True, active=active, lo=lo)


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------


def bicgstab_batched(matvec, b, x0, *, tol, maxiter=1000, M=None, active=None):
    """Preconditioned BiCGStab of each member (``solvers.bicgstab``).

    Per member: the breakdown guard -- a vanishing ``rho = <rbar, r>``,
    ``<rbar, v>`` or ``<t, t>`` (below ``_EPS_BREAKDOWN``) or a non-finite
    residual keeps the previous iterate and stops the member, ``failed``;
    the failed step counts as an iteration (the JAX package's batched
    loop) -- while the other members go on.  ``tol``: a number or [B]
    absolute tolerances; ``active``: optional [B] bool (host), members
    outside it keep ``x0``.
    """
    M = M or _identity
    bl = _leaves(b)
    B, dev = bl[0].shape[0], bl[0].device
    tol_h = _host_tol(tol, B)
    act = np.ones(B, bool) if active is None else np.asarray(active, bool).copy()
    r = _map(torch.sub, b, matvec(x0))
    rbar = r
    res = bnorm(r).cpu().numpy().astype(np.float64)
    x = x0
    p = v = _map(torch.zeros_like, r)
    one = torch.ones(B, dtype=bl[0].dtype, device=dev)
    rho = alpha = omega = one
    it = np.zeros(B, np.int64)
    failed = np.zeros(B, bool)
    with np.errstate(invalid="ignore"):
        done = ~act | (res <= tol_h)
    while True:
        run = ~done & ~failed & (it < maxiter)
        if not run.any():
            break
        run_t = _mask_on(run, dev)
        # a stopped member's input is zero: the nested solves stop at once
        hold = lambda y: _map(lambda a: torch.where(_col(run_t, a), a, 0.0), y)
        rho_new = bvdot(rbar, r)
        beta = (rho_new / rho) * (alpha / omega)
        p_new = hold(_map(lambda pi, vi, ri: _col(beta, pi) * (pi - _col(omega, vi) * vi) + ri, p, v, r))
        y = M(p_new)
        v_new = matvec(y)
        denom = bvdot(rbar, v_new)
        alpha_new = rho_new / denom
        s = hold(_map(lambda ri, vi: ri - _col(alpha_new, vi) * vi, r, v_new))
        z = M(s)
        t = matvec(z)
        tt = bvdot(t, t)
        omega_new = bvdot(t, s) / tt
        x_new = _map(lambda xi, yi, zi: xi + (_col(alpha_new, yi) * yi + _col(omega_new, zi) * zi), x, y, z)
        r_new = _map(lambda si, ti: si - _col(omega_new, ti) * ti, s, t)
        # the one host readback of this iteration: [4, B]
        rho_h, denom_h, tt_h, res_new = (
            torch.stack([rho_new, denom, tt, bnorm(r_new)]).cpu().numpy().astype(np.float64)
        )
        it[run] += 1
        with np.errstate(invalid="ignore"):
            bad = run & ~(
                (np.abs(rho_h) >= _EPS_BREAKDOWN)
                & (np.abs(denom_h) >= _EPS_BREAKDOWN)
                & (np.abs(tt_h) >= _EPS_BREAKDOWN)
                & np.isfinite(res_new)
            )
        failed |= bad
        ok = run & ~bad
        ok_t = _mask_on(ok, dev)
        x, r, p, v = (_select(ok_t, a, c) for a, c in ((x_new, x), (r_new, r), (p_new, p), (v_new, v)))
        rho, alpha, omega = (torch.where(ok_t, a, c) for a, c in
                             ((rho_new, rho), (alpha_new, alpha), (omega_new, omega)))
        res = np.where(ok, res_new, res)
        with np.errstate(invalid="ignore"):
            done = done | (ok & (res <= tol_h))
    with np.errstate(invalid="ignore"):
        converged = done & act & (res <= tol_h)
    return x, SolveInfo(it, converged, res, failed)


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------


def cg_batched(matvec, b, x0, *, tol, maxiter=1000, M=None):
    """Preconditioned CG of each member (``solvers.cg``): the true-residual
    check, the breakdown guard (a member with a vanishing curvature or a
    non-finite update keeps its previous iterate and stops, ``failed``)."""
    M = M or _identity
    B, dev = b.shape[0], b.device
    tol_h = _host_tol(tol, B)
    r = b - matvec(x0)
    res = bnorm(r).cpu().numpy().astype(np.float64)
    z = M(r)
    rz = bvdot(r, z)
    x, d = x0, z
    it = np.zeros(B, np.int64)
    failed = np.zeros(B, bool)
    with np.errstate(invalid="ignore"):
        done = res <= tol_h
    while True:
        run = ~done & ~failed & (it < maxiter)
        if not run.any():
            break
        q = matvec(d)
        dq = bvdot(d, q)
        alpha = _col(rz / dq, d)
        x_new = x + alpha * d
        r_new = r - alpha * q
        # the one host readback of this iteration
        res_new, dq_h = torch.stack([bnorm(r_new), dq]).cpu().numpy().astype(np.float64)
        it[run] += 1
        with np.errstate(invalid="ignore"):
            bad = run & ~(np.isfinite(res_new) & (np.abs(dq_h) > _EPS_BREAKDOWN))
        failed |= bad
        ok = run & ~bad
        ok_t = _mask_on(ok, dev)
        x = _select(ok_t, x_new, x)
        r = _select(ok_t, r_new, r)
        res = np.where(ok, res_new, res)
        with np.errstate(invalid="ignore"):
            done = done | (ok & (res <= tol_h))
        go = ok & ~done
        if not go.any():
            continue
        go_t = _mask_on(go, dev)
        z = M(r)
        rz_new = bvdot(r, z)
        d = _select(go_t, _col(rz_new / rz, d) * d + z, d)
        rz = torch.where(go_t, rz_new, rz)
    return x, SolveInfo(it, done, res, failed)
