"""NS-2D staggered-grid ops in plain PyTorch (counterpart of
pampi_tpu/ops/ns2d.py): momentum predictor, boundary conditions, CFL
timestep, projection.

Arrays are (jmax+2, imax+2), layout [j, i]; u lives on east faces, v on
north faces, p at centres. Every formula keeps the JAX package's
association term for term. Scalars follow JAX's weak-type rule: a Python
float meets a tensor in the tensor's dtype. A Python float is never the
dividend of a tensor here, because PyTorch computes `s / x` as
`reciprocal(x) * s`, which rounds differently; `_const` makes such a
scalar a tensor first.

The functions return new tensors and leave their inputs alone, like the
JAX ones; the kernels' wrappers (ops/ns2d_fused.py) work in place.
"""

from __future__ import annotations

import torch

NOSLIP, SLIP, OUTFLOW, PERIODIC = 1, 2, 3, 4


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """x as a 0-dim tensor of like's dtype and device: a fill on the
    device, so a step never waits on a host-to-device copy."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _interior_mask(shape, device) -> torch.Tensor:
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[1:-1, 1:-1] = True
    return m


def fg_predictor_terms(u, v, dt, re, gx, gy, gamma, dx, dy):
    """Full-array F/G predictor arithmetic, no masking (JAX
    fg_predictor_terms): every neighbour is a roll of the whole array, so
    the wrapped edge values are garbage that callers mask out."""
    idx, idy = 1.0 / dx, 1.0 / dy
    inv_re = 1.0 / re
    roll = torch.roll

    uc = u
    ue = roll(u, -1, 1)
    uw = roll(u, 1, 1)
    un = roll(u, -1, 0)
    us = roll(u, 1, 0)
    unw = roll(roll(u, -1, 0), 1, 1)
    vc = v
    ve = roll(v, -1, 1)
    vw = roll(v, 1, 1)
    vn = roll(v, -1, 0)
    vs = roll(v, 1, 0)
    vse = roll(roll(v, 1, 0), -1, 1)

    du2dx = idx * 0.25 * (
        (uc + ue) * (uc + ue) - (uc + uw) * (uc + uw)
    ) + gamma * idx * 0.25 * (
        torch.abs(uc + ue) * (uc - ue) + torch.abs(uc + uw) * (uc - uw)
    )
    duvdy = idy * 0.25 * (
        (vc + ve) * (uc + un) - (vs + vse) * (uc + us)
    ) + gamma * idy * 0.25 * (
        torch.abs(vc + ve) * (uc - un) + torch.abs(vs + vse) * (uc - us)
    )
    lap_u = idx * idx * (ue - 2.0 * uc + uw) + idy * idy * (un - 2.0 * uc + us)
    f_int = uc + dt * (inv_re * lap_u - du2dx - duvdy + gx)

    duvdx = idx * 0.25 * (
        (uc + un) * (vc + ve) - (uw + unw) * (vc + vw)
    ) + gamma * idx * 0.25 * (
        torch.abs(uc + un) * (vc - ve) + torch.abs(uw + unw) * (vc - vw)
    )
    dv2dy = idy * 0.25 * (
        (vc + vn) * (vc + vn) - (vc + vs) * (vc + vs)
    ) + gamma * idy * 0.25 * (
        torch.abs(vc + vn) * (vc - vn) + torch.abs(vc + vs) * (vc - vs)
    )
    lap_v = idx * idx * (ve - 2.0 * vc + vw) + idy * idy * (vn - 2.0 * vc + vs)
    g_int = vc + dt * (inv_re * lap_v - duvdx - dv2dy + gy)
    return f_int, g_int


def apply_fg_wall_fixups(f, g, u, v):
    """F carries U on vertical walls, G carries V on horizontal walls."""
    f = f.clone()
    g = g.clone()
    f[1:-1, 0] = u[1:-1, 0]
    f[1:-1, -2] = u[1:-1, -2]
    g[0, 1:-1] = v[0, 1:-1]
    g[-2, 1:-1] = v[-2, 1:-1]
    return f, g


def compute_fg(u, v, dt, re, gx, gy, gamma, dx, dy):
    """Momentum predictor F, G on the interior (zero elsewhere) plus the
    wall fixups (computeFG)."""
    f_int, g_int = fg_predictor_terms(u, v, dt, re, gx, gy, gamma, dx, dy)
    m = _interior_mask(u.shape, u.device)
    zero = _const(0.0, u)
    f = torch.where(m, f_int, zero)
    g = torch.where(m, g_int, zero)
    return apply_fg_wall_fixups(f, g, u, v)


def rhs_terms(f, g, dt, dx, dy):
    """Full-array RHS = div(F, G)/dt arithmetic."""
    return torch.reciprocal(dt) * (
        (f - torch.roll(f, 1, 1)) / _const(dx, f)
        + (g - torch.roll(g, 1, 0)) / _const(dy, g)
    )


def compute_rhs(f, g, dt, dx, dy):
    """Pressure-Poisson RHS on the interior, zero elsewhere (computeRHS)."""
    m = _interior_mask(f.shape, f.device)
    return torch.where(m, rhs_terms(f, g, dt, dx, dy), _const(0.0, f))


def adapt_terms(f, g, p, dt, dx, dy):
    """Full-array projection arithmetic."""
    fx = dt / _const(dx, dt)
    fy = dt / _const(dy, dt)
    u_new = f - (torch.roll(p, -1, 1) - p) * fx
    v_new = g - (torch.roll(p, -1, 0) - p) * fy
    return u_new, v_new


def adapt_uv(u, v, f, g, p, dt, dx, dy):
    """Projection (adaptUV): interior cells get the corrected velocity,
    edge cells keep u and v."""
    m = _interior_mask(u.shape, u.device)
    u_new, v_new = adapt_terms(f, g, p, dt, dx, dy)
    return torch.where(m, u_new, u), torch.where(m, v_new, v)


def set_boundary_conditions(u, v, bc_left, bc_right, bc_bottom, bc_top):
    """Wall BCs on the ghost/wall strips (setBoundaryConditions), in the
    reference's wall order: later walls read earlier walls' writes.
    PERIODIC is a no-op, as in the reference."""
    u = u.clone()
    v = v.clone()
    # left wall: U(0, j) on the wall, V(0, j) a ghost
    if bc_left == NOSLIP:
        u[1:-1, 0] = 0.0
        v[1:-1, 0] = -v[1:-1, 1]
    elif bc_left == SLIP:
        u[1:-1, 0] = 0.0
        v[1:-1, 0] = v[1:-1, 1]
    elif bc_left == OUTFLOW:
        u[1:-1, 0] = u[1:-1, 1]
        v[1:-1, 0] = v[1:-1, 1]
    # right wall: U(imax, j) on the wall (an interior column), V ghost
    if bc_right == NOSLIP:
        u[1:-1, -2] = 0.0
        v[1:-1, -1] = -v[1:-1, -2]
    elif bc_right == SLIP:
        u[1:-1, -2] = 0.0
        v[1:-1, -1] = v[1:-1, -2]
    elif bc_right == OUTFLOW:
        u[1:-1, -2] = u[1:-1, -3]
        v[1:-1, -1] = v[1:-1, -2]
    # bottom wall: V(i, 0) on the wall, U(i, 0) a ghost
    if bc_bottom == NOSLIP:
        v[0, 1:-1] = 0.0
        u[0, 1:-1] = -u[1, 1:-1]
    elif bc_bottom == SLIP:
        v[0, 1:-1] = 0.0
        u[0, 1:-1] = u[1, 1:-1]
    elif bc_bottom == OUTFLOW:
        u[0, 1:-1] = u[1, 1:-1]
        v[0, 1:-1] = v[1, 1:-1]
    # top wall: V(i, jmax) on the wall, U(i, jmax+1) a ghost
    if bc_top == NOSLIP:
        v[-2, 1:-1] = 0.0
        u[-1, 1:-1] = -u[-2, 1:-1]
    elif bc_top == SLIP:
        v[-2, 1:-1] = 0.0
        u[-1, 1:-1] = u[-2, 1:-1]
    elif bc_top == OUTFLOW:
        u[-1, 1:-1] = u[-2, 1:-1]
        v[-2, 1:-1] = v[-3, 1:-1]
    return u, v


def set_special_bc_dcavity(u):
    """Lid U(i, jmax+1) = 2 - U(i, jmax) for i in 1..imax-1 (the reference
    skips the last interior i; replicated)."""
    u = u.clone()
    u[-1, 1:-2] = 2.0 - u[-2, 1:-2]
    return u


def set_special_bc_canal(u, dy, ylength):
    """Parabolic inflow U(0, j) = y(ylength - y)·4/ylength²."""
    u = u.clone()
    jmax = u.shape[0] - 2
    y = (torch.arange(1, jmax + 1, dtype=u.dtype, device=u.device) - 0.5) * dy
    u[1:-1, 0] = y * (ylength - y) * 4.0 / _const(ylength * ylength, u)
    return u


def set_special_bc(u, problem, dy, ylength):
    """The special BC of `problem` (dcavity lid or canal inflow)."""
    if problem == "dcavity":
        return set_special_bc_dcavity(u)
    if problem == "canal":
        return set_special_bc_canal(u, dy, ylength)
    return u


def max_element(m):
    """max |m| over the FULL array, ghosts included (the reference's
    maxElement quirk, replicated)."""
    return torch.max(torch.abs(m))


def cfl_dt(umax, vmax, dt_bound, dx, dy, tau):
    """CFL timestep from the velocity maxima (0-dim tensors)."""
    inf = _const(float("inf"), umax)
    dt = torch.minimum(
        _const(dt_bound, umax),
        torch.minimum(
            torch.where(umax > 0, _const(dx, umax) / umax, inf),
            torch.where(vmax > 0, _const(dy, vmax) / vmax, inf),
        ),
    )
    return dt * tau


def compute_timestep(u, v, dt_bound, dx, dy, tau):
    """Adaptive CFL timestep (computeTimestep)."""
    return cfl_dt(max_element(u), max_element(v), dt_bound, dx, dy, tau)


def normalize_pressure(p):
    """Subtract the mean over the FULL array (normalizePressure)."""
    return p - torch.mean(p)
