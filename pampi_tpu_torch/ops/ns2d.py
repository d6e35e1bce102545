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

import numpy as np
import torch

NOSLIP, SLIP, OUTFLOW, PERIODIC = 1, 2, 3, 4


def _const(x, like: torch.Tensor) -> torch.Tensor:
    """x as a 0-dim tensor of like's dtype and device: a fill on the
    device, so a step never waits on a host-to-device copy. A tensor x
    (a lane-stacked (N, 1, 1) scalar of the fleet's class lanes) is taken
    as it is, in like's dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(like.dtype)
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _weak(x, like: torch.Tensor):
    """A Python float constant as the JAX package's weak typing makes it:
    at bfloat16 a 0-dim bf16 tensor (the constant rounded to bf16, as JAX
    rounds it; PyTorch would keep a Python scalar in float32 beside a bf16
    tensor), else x unchanged (float32 and float64 round a scalar to the
    tensor's dtype already)."""
    if like.dtype == torch.bfloat16 and not isinstance(x, torch.Tensor):
        return _const(x, like)
    return x


def _interior_mask(shape, device) -> torch.Tensor:
    """The interior of the last two axes (a leading lane axis, if any,
    is broadcast over)."""
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[..., 1:-1, 1:-1] = True
    return m


def fg_predictor_terms(u, v, dt, re, gx, gy, gamma, dx, dy):
    """Full-array F/G predictor arithmetic, no masking (JAX
    fg_predictor_terms): every neighbour is a roll of the whole array, so
    the wrapped edge values are garbage that callers mask out. The rolls
    take the last two axes, so lane-stacked (N, J, I) fields with (N, 1,
    1) dt, dx, dy work as well."""
    idx, idy = 1.0 / dx, 1.0 / dy
    # the coefficients as the JAX package forms them (Python floats, in
    # the fields' dtype: rounded to bf16 at bfloat16)
    idx4, gidx4 = _weak(idx * 0.25, u), _weak(gamma * idx * 0.25, u)
    idy4, gidy4 = _weak(idy * 0.25, u), _weak(gamma * idy * 0.25, u)
    idxx, idyy = _weak(idx * idx, u), _weak(idy * idy, u)
    inv_re = _weak(1.0 / re, u)
    gx, gy = _weak(gx, u), _weak(gy, u)
    roll = torch.roll

    uc = u
    ue = roll(u, -1, -1)
    uw = roll(u, 1, -1)
    un = roll(u, -1, -2)
    us = roll(u, 1, -2)
    unw = roll(roll(u, -1, -2), 1, -1)
    vc = v
    ve = roll(v, -1, -1)
    vw = roll(v, 1, -1)
    vn = roll(v, -1, -2)
    vs = roll(v, 1, -2)
    vse = roll(roll(v, 1, -2), -1, -1)

    du2dx = idx4 * (
        (uc + ue) * (uc + ue) - (uc + uw) * (uc + uw)
    ) + gidx4 * (
        torch.abs(uc + ue) * (uc - ue) + torch.abs(uc + uw) * (uc - uw)
    )
    duvdy = idy4 * (
        (vc + ve) * (uc + un) - (vs + vse) * (uc + us)
    ) + gidy4 * (
        torch.abs(vc + ve) * (uc - un) + torch.abs(vs + vse) * (uc - us)
    )
    lap_u = idxx * (ue - 2.0 * uc + uw) + idyy * (un - 2.0 * uc + us)
    f_int = uc + dt * (inv_re * lap_u - du2dx - duvdy + gx)

    duvdx = idx4 * (
        (uc + un) * (vc + ve) - (uw + unw) * (vc + vw)
    ) + gidx4 * (
        torch.abs(uc + un) * (vc - ve) + torch.abs(uw + unw) * (vc - vw)
    )
    dv2dy = idy4 * (
        (vc + vn) * (vc + vn) - (vc + vs) * (vc + vs)
    ) + gidy4 * (
        torch.abs(vc + vn) * (vc - vn) + torch.abs(vc + vs) * (vc - vs)
    )
    lap_v = idxx * (ve - 2.0 * vc + vw) + idyy * (vn - 2.0 * vc + vs)
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
        (f - torch.roll(f, 1, -1)) / _const(dx, f)
        + (g - torch.roll(g, 1, -2)) / _const(dy, g)
    )


def compute_rhs(f, g, dt, dx, dy):
    """Pressure-Poisson RHS on the interior, zero elsewhere (computeRHS)."""
    m = _interior_mask(f.shape, f.device)
    return torch.where(m, rhs_terms(f, g, dt, dx, dy), _const(0.0, f))


def adapt_terms(f, g, p, dt, dx, dy):
    """Full-array projection arithmetic."""
    fx = dt / _const(dx, dt)
    fy = dt / _const(dy, dt)
    u_new = f - (torch.roll(p, -1, -1) - p) * fx
    v_new = g - (torch.roll(p, -1, -2) - p) * fy
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
    # the row index cast to the field's dtype, as the JAX package casts it:
    # bf16 rounds integers above 256 (to nearest even; an arange made in
    # bf16 drifts from that above 256)
    j = torch.arange(1, jmax + 1, device=u.device).to(u.dtype)
    y = (j - 0.5) * _weak(dy, u)
    u[1:-1, 0] = (y * (_weak(ylength, u) - y) * 4.0
                  / _const(ylength * ylength, u))
    return u


def set_special_bc(u, problem, dy, ylength):
    """The special BC of `problem` (dcavity lid, or the canal inflow of
    canal and canal_obstacle)."""
    if problem == "dcavity":
        return set_special_bc_dcavity(u)
    if problem in ("canal", "canal_obstacle"):
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
    return dt * _weak(tau, dt)


def compute_timestep(u, v, dt_bound, dx, dy, tau):
    """Adaptive CFL timestep (computeTimestep)."""
    return cfl_dt(max_element(u), max_element(v), dt_bound, dx, dy, tau)


def normalize_pressure(p):
    """Subtract the mean over the FULL array (normalizePressure)."""
    return p - torch.mean(p)


# ----------------------------------------------------------------------
# Global-index gated forms: the phases on a shard's block of a 2-D mesh,
# divisible or ragged (the plain versions of K3/K4 in their distributed
# mode; the JAX package's apply_wall_bcs_2d / apply_special_bc_2d of
# ops/ns2d_fused.py, which parallel/ragged2d.py shares)
# ----------------------------------------------------------------------


def index_grids_2d(shape, ext_pad: int, offs, device="cpu"):
    """(gj column, gi row): the global extended index of every cell of a
    block whose local index a along an axis is global a - ext_pad +
    offset."""
    (nj, ni), (joff, ioff) = shape, offs
    gj = torch.arange(nj, device=device)[:, None] - ext_pad + int(joff)
    gi = torch.arange(ni, device=device)[None, :] - ext_pad + int(ioff)
    return gj, gi


def shift_zero(x, shift: int, dim: int):
    """torch.roll with the wrapped-in cells read as 0: x shifted by
    `shift` along `dim`, the value past the block's edge 0."""
    out = torch.roll(x, shift, dim)
    edge = [slice(None)] * x.dim()
    edge[dim] = slice(0, shift) if shift > 0 else slice(shift, None)
    out[tuple(edge)] = 0.0
    return out


def apply_wall_bcs_gated(u, v, gj, gi, bc, gext, roll=torch.roll):
    """set_boundary_conditions as sequential where-updates gated by the
    global index, in the reference's wall order (left, right, bottom,
    top), so later walls read earlier walls' writes as on one device. The
    inward read is `roll` of the block: a wrapping roll on the halo-1
    blocks of the phase chain (as the JAX package's ragged2d), shift_zero
    on the deep blocks of PRE (as its kernel, whose window reads 0 past
    the block); the two differ only on the block's outermost layer."""
    bc_left, bc_right, bc_bottom, bc_top = bc
    jmax, imax = gext
    rows = (gj >= 1) & (gj <= jmax)
    cols = (gi >= 1) & (gi <= imax)
    zu, zv = torch.zeros_like(u), torch.zeros_like(v)
    where = torch.where

    m = (gi == 0) & rows  # left: U on the wall, V ghost
    if bc_left == NOSLIP:
        u, v = where(m, zu, u), where(m, -roll(v, -1, -1), v)
    elif bc_left == SLIP:
        u, v = where(m, zu, u), where(m, roll(v, -1, -1), v)
    elif bc_left == OUTFLOW:
        u, v = where(m, roll(u, -1, -1), u), where(m, roll(v, -1, -1), v)
    mw = (gi == imax) & rows  # right: U(imax) on the wall
    mg = (gi == imax + 1) & rows  # the ghost column
    if bc_right == NOSLIP:
        u, v = where(mw, zu, u), where(mg, -roll(v, 1, -1), v)
    elif bc_right == SLIP:
        u, v = where(mw, zu, u), where(mg, roll(v, 1, -1), v)
    elif bc_right == OUTFLOW:
        u, v = where(mw, roll(u, 1, -1), u), where(mg, roll(v, 1, -1), v)
    m = (gj == 0) & cols  # bottom: V on the wall, U ghost
    if bc_bottom == NOSLIP:
        v, u = where(m, zv, v), where(m, -roll(u, -1, -2), u)
    elif bc_bottom == SLIP:
        v, u = where(m, zv, v), where(m, roll(u, -1, -2), u)
    elif bc_bottom == OUTFLOW:
        u, v = where(m, roll(u, -1, -2), u), where(m, roll(v, -1, -2), v)
    mw = (gj == jmax) & cols  # top: V(jmax) on the wall
    mg = (gj == jmax + 1) & cols  # the ghost row
    if bc_top == NOSLIP:
        v, u = where(mw, zv, v), where(mg, -roll(u, 1, -2), u)
    elif bc_top == SLIP:
        v, u = where(mw, zv, v), where(mg, roll(u, 1, -2), u)
    elif bc_top == OUTFLOW:
        u, v = where(mg, roll(u, 1, -2), u), where(mw, roll(v, 1, -2), v)
    return u, v


def inflow_profile(gj, dy, ylength, dtype):
    """The canal's parabolic inflow U(0, j) at the global rows gj (a
    numpy integer array): y from the row index in float64, cast to the
    field dtype, then y(ylength - y)·4/ylength² in that dtype (the JAX
    package's distributed profile). Computed with numpy on the host."""
    real = np.float32 if dtype == torch.float32 else np.float64
    y = ((np.asarray(gj, np.float64) - 0.5) * dy).astype(real)
    return torch.from_numpy(np.asarray(
        y * (real(ylength) - y) * real(4.0) / real(ylength * ylength),
        dtype=real))


def apply_special_bc_gated(u, gj, gi, problem, gext, dy, ylength,
                           roll=torch.roll):
    """The dcavity lid (skipping the last interior i, the reference's
    loop-bound quirk) or the canal inflow, gated by the global index
    (`roll` as in apply_wall_bcs_gated)."""
    jmax, imax = gext
    if problem == "dcavity":
        m = (gj == jmax + 1) & (gi >= 1) & (gi <= imax - 1)
        return torch.where(m, 2.0 - roll(u, 1, -2), u)
    if problem in ("canal", "canal_obstacle"):
        prof = inflow_profile(gj[:, 0].cpu().numpy(), dy, ylength, u.dtype)
        m = (gi == 0) & (gj >= 1) & (gj <= jmax)
        return torch.where(m, prof.to(u.device)[:, None].expand_as(u), u)
    return u


def fg_fixups_gated(f, g, u, v, gj, gi, gext):
    """apply_fg_wall_fixups gated by the global index: F = U on the
    vertical walls, G = V on the horizontal ones, tangentially on the
    global interior."""
    jmax, imax = gext
    rows = (gj >= 1) & (gj <= jmax)
    cols = (gi >= 1) & (gi <= imax)
    return (torch.where(((gi == 0) | (gi == imax)) & rows, u, f),
            torch.where(((gj == 0) | (gj == jmax)) & cols, v, g))


def _global_interior(gj, gi, gext):
    jmax, imax = gext
    return (gj >= 1) & (gj <= jmax) & (gi >= 1) & (gi <= imax)


def compute_fg_interior(u, v, dt, re, gx, gy, gamma, dx, dy):
    """The momentum predictor F, G on the block's interior, zero
    elsewhere, without the wall fixups (the distributed step gates those
    by the global index, fg_fixups_gated)."""
    f_int, g_int = fg_predictor_terms(u, v, dt, re, gx, gy, gamma, dx, dy)
    m = _interior_mask(u.shape, u.device)
    zero = _const(0.0, u)
    return torch.where(m, f_int, zero), torch.where(m, g_int, zero)


def pre_gated(ud, vd, dt, bc, problem, re, gx, gy, gamma, dx, dy, ylength,
              offs, gext, ext_pad: int, flags=None):
    """PRE on a shard's deep block (the plain version of K3's distributed
    mode): ud, vd are (l+2+2e)-extended blocks (e = ext_pad >= 1) whose
    local index a is global a - e + offset. Returns u', v' on the deep
    block after the wall and special BCs, and F, G, rhs on the shard's
    halo-1 block: F/G the predictor on the global interior plus the wall
    fixups, zero elsewhere; rhs on the owned cells of the global interior.
    With the deep block's uint8 `flags` (obstacle flag fields) the
    obstacle velocity BC follows the special BC and F/G carry U/V on
    non-fluid faces (ops/obstacle.py, with the block's own faces). Inputs
    untouched."""
    if ext_pad < 1:
        raise ValueError("the gated PRE needs a deep block (ext_pad >= 1)")
    e = ext_pad
    gj, gi = index_grids_2d(ud.shape, e, offs, ud.device)
    u, v = apply_wall_bcs_gated(ud, vd, gj, gi, bc, gext, shift_zero)
    u = apply_special_bc_gated(u, gj, gi, problem, gext, dy, ylength,
                               shift_zero)
    faces = None
    if flags is not None:
        from . import obstacle as obst

        faces = obst.block_faces(flags, gj, gi, gext, ud.dtype)
        u, v = obst.apply_obstacle_velocity_bc(u, v, faces)
    f_full, g_full = fg_predictor_terms(u, v, dt, re, gx, gy, gamma, dx, dy)
    strip = tuple(slice(e, n - e) for n in ud.shape)
    uo, vo = u[strip], v[strip]
    gj, gi = index_grids_2d(uo.shape, 0, offs, ud.device)
    interior = _global_interior(gj, gi, gext)
    zero = _const(0.0, u)
    f, g = fg_fixups_gated(torch.where(interior, f_full[strip], zero),
                           torch.where(interior, g_full[strip], zero),
                           uo, vo, gj, gi, gext)
    if faces is not None:
        f, g = obst.mask_fg(f, g, uo, vo, obst.Faces(
            faces.fluid[strip], faces.u_face[strip], faces.v_face[strip]))
    owned = _interior_mask(f.shape, f.device) & interior
    rhs = torch.where(owned, rhs_terms(f, g, dt, dx, dy), zero)
    return u, v, f, g, rhs


def post_gated(u, v, f, g, p, dt, dx, dy, offs, gext, ragged: bool,
               flags=None):
    """POST on a shard's halo-1 block (the plain version of K4's
    distributed mode): the projection on the cells of the global interior,
    ring cells included where they are interface ghosts, with p read as 0
    beyond the block's high edge; other cells keep u, v. On a ragged mesh
    the dead cells are then zeroed (the live-mask multiply). With the
    block's uint8 `flags` the projection is multiplied by the face masks,
    a face fluid-fluid where the cell and its + neighbour are fluid (the
    flags, like p, read as 0 beyond the block's high edge). Returns (u'',
    v'', max|u''|, max|v''|), the maxima over the block's cells of the
    global extended array. Inputs untouched."""
    gj, gi = index_grids_2d(u.shape, 0, offs, u.device)
    jmax, imax = gext
    interior = _global_interior(gj, gi, gext)
    pp = torch.nn.functional.pad(p, (0, 1, 0, 1))
    fx = dt / _const(dx, dt)
    fy = dt / _const(dy, dt)
    ua = f - (pp[:-1, 1:] - p) * fx
    va = g - (pp[1:, :-1] - p) * fy
    if flags is not None:
        fl = flags.to(u.dtype)
        fp = torch.nn.functional.pad(fl, (0, 1, 0, 1))
        ua = ua * (fl * fp[:-1, 1:])
        va = va * (fl * fp[1:, :-1])
    un = torch.where(interior, ua, u)
    vn = torch.where(interior, va, v)
    if ragged:
        live = ((gj <= jmax + 1) & (gi <= imax + 1)).to(u.dtype)
        un, vn = un * live, vn * live
    valid = (gj >= 0) & (gj <= jmax + 1) & (gi >= 0) & (gi <= imax + 1)
    zero = _const(0.0, u)
    return (un, vn, torch.max(torch.where(valid, un.abs(), zero)),
            torch.max(torch.where(valid, vn.abs(), zero)))
