"""NS-3D staggered-grid ops in plain PyTorch (counterpart of
pampi_tpu/ops/ns3d.py, the reference's assignment-6 solver.c): the F/G/H
momentum predictor, the 6-face boundary conditions, the special BCs, the
CFL timestep, the RHS and the projection.

Arrays are (kmax+2, jmax+2, imax+2), layout [k, j, i]; u lives on east
faces, v on north faces, w on back faces, p at centres. Every formula keeps
the JAX package's association term for term, and the reference quirks it
replicates stay: dvwdz in G reads V(i,j,k+1) in both halves, the dcavity
lid skips the last interior i AND k, and the canal inflow is a uniform
U = 2. Scalars follow ops/ns2d.py: a Python float meets a tensor in the
tensor's dtype, and a divisor is made a 0-dim tensor first (`_const`).

The functions return new tensors and leave their inputs alone, like the
JAX ones; the kernels' wrappers (ops/ns3d_fused.py) work in place.
"""

from __future__ import annotations

import torch

from .ns2d import _const, max_element

NOSLIP, SLIP, OUTFLOW, PERIODIC = 1, 2, 3, 4


def V3(a, dk=0, dj=0, di=0):
    """Interior view shifted by (dk, dj, di): the (i±1, j±1, k±1) stencil
    accessor over the whole interior of the last three axes at once (a
    leading lane axis, if any, is carried along)."""
    K, J, I = a.shape[-3:]
    return a[..., 1 + dk:K - 1 + dk, 1 + dj:J - 1 + dj, 1 + di:I - 1 + di]


def fgh_predictor_terms(u, v, w, dt, re, gx, gy, gz, gamma, dx, dy, dz):
    """The 3-D momentum-predictor arithmetic on the interior (JAX
    fgh_predictor_terms)."""
    idx, idy, idz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    inv_re = 1.0 / re

    uc = V3(u)
    vc = V3(v)
    wc = V3(w)
    u_ip, u_im = V3(u, di=1), V3(u, di=-1)
    u_jp, u_jm = V3(u, dj=1), V3(u, dj=-1)
    u_kp, u_km = V3(u, dk=1), V3(u, dk=-1)
    v_ip, v_im = V3(v, di=1), V3(v, di=-1)
    v_jp, v_jm = V3(v, dj=1), V3(v, dj=-1)
    v_kp, v_km = V3(v, dk=1), V3(v, dk=-1)
    w_ip, w_im = V3(w, di=1), V3(w, di=-1)
    w_jp, w_jm = V3(w, dj=1), V3(w, dj=-1)
    w_kp, w_km = V3(w, dk=1), V3(w, dk=-1)
    u_im_jp = V3(u, dj=1, di=-1)
    u_im_kp = V3(u, dk=1, di=-1)
    v_jm_ip = V3(v, dj=-1, di=1)
    v_jm_kp = V3(v, dk=1, dj=-1)
    w_km_ip = V3(w, dk=-1, di=1)
    w_km_jp = V3(w, dk=-1, dj=1)

    ab = torch.abs

    # ---- F ----
    du2dx = idx * 0.25 * (
        (uc + u_ip) * (uc + u_ip) - (uc + u_im) * (uc + u_im)
    ) + gamma * idx * 0.25 * (
        ab(uc + u_ip) * (uc - u_ip) + ab(uc + u_im) * (uc - u_im)
    )
    duvdy = idy * 0.25 * (
        (vc + v_ip) * (uc + u_jp) - (v_jm + v_jm_ip) * (uc + u_jm)
    ) + gamma * idy * 0.25 * (
        ab(vc + v_ip) * (uc - u_jp) + ab(v_jm + v_jm_ip) * (uc - u_jm)
    )
    duwdz = idz * 0.25 * (
        (wc + w_ip) * (uc + u_kp) - (w_km + w_km_ip) * (uc + u_km)
    ) + gamma * idz * 0.25 * (
        ab(wc + w_ip) * (uc - u_kp) + ab(w_km + w_km_ip) * (uc - u_km)
    )
    lap_u = (
        idx * idx * (u_ip - 2.0 * uc + u_im)
        + idy * idy * (u_jp - 2.0 * uc + u_jm)
        + idz * idz * (u_kp - 2.0 * uc + u_km)
    )
    f_int = uc + dt * (inv_re * lap_u - du2dx - duvdy - duwdz + gx)

    # ---- G ----
    duvdx = idx * 0.25 * (
        (uc + u_jp) * (vc + v_ip) - (u_im + u_im_jp) * (vc + v_im)
    ) + gamma * idx * 0.25 * (
        ab(uc + u_jp) * (vc - v_ip) + ab(u_im + u_im_jp) * (vc - v_im)
    )
    dv2dy = idy * 0.25 * (
        (vc + v_jp) * (vc + v_jp) - (vc + v_jm) * (vc + v_jm)
    ) + gamma * idy * 0.25 * (
        ab(vc + v_jp) * (vc - v_jp) + ab(vc + v_jm) * (vc - v_jm)
    )
    # reference quirk: v_kp in BOTH halves and both γ-terms
    dvwdz = idz * 0.25 * (
        (wc + w_jp) * (vc + v_kp) - (w_km + w_km_jp) * (vc + v_kp)
    ) + gamma * idz * 0.25 * (
        ab(wc + w_jp) * (vc - v_kp) + ab(w_km + w_km_jp) * (vc - v_kp)
    )
    lap_v = (
        idx * idx * (v_ip - 2.0 * vc + v_im)
        + idy * idy * (v_jp - 2.0 * vc + v_jm)
        + idz * idz * (v_kp - 2.0 * vc + v_km)
    )
    g_int = vc + dt * (inv_re * lap_v - duvdx - dv2dy - dvwdz + gy)

    # ---- H ----
    duwdx = idx * 0.25 * (
        (uc + u_kp) * (wc + w_ip) - (u_im + u_im_kp) * (wc + w_im)
    ) + gamma * idx * 0.25 * (
        ab(uc + u_kp) * (wc - w_ip) + ab(u_im + u_im_kp) * (wc - w_im)
    )
    dvwdy = idy * 0.25 * (
        (vc + v_kp) * (wc + w_jp) - (v_jm_kp + v_jm) * (wc + w_jm)
    ) + gamma * idy * 0.25 * (
        ab(vc + v_kp) * (wc - w_jp) + ab(v_jm_kp + v_jm) * (wc - w_jm)
    )
    dw2dz = idz * 0.25 * (
        (wc + w_kp) * (wc + w_kp) - (wc + w_km) * (wc + w_km)
    ) + gamma * idz * 0.25 * (
        ab(wc + w_kp) * (wc - w_kp) + ab(wc + w_km) * (wc - w_km)
    )
    lap_w = (
        idx * idx * (w_ip - 2.0 * wc + w_im)
        + idy * idy * (w_jp - 2.0 * wc + w_jm)
        + idz * idz * (w_kp - 2.0 * wc + w_km)
    )
    h_int = wc + dt * (inv_re * lap_w - duwdx - dvwdy - dw2dz + gz)
    return f_int, g_int, h_int


def _with_interior(like, interior):
    out = torch.zeros_like(like)
    out[..., 1:-1, 1:-1, 1:-1] = interior
    return out


def apply_fgh_wall_fixups(f, g, h, u, v, w):
    """F = U on the left/right walls, G = V on bottom/top, H = W on
    front/back (tangentially the interior)."""
    f, g, h = f.clone(), g.clone(), h.clone()
    f[1:-1, 1:-1, 0] = u[1:-1, 1:-1, 0]
    f[1:-1, 1:-1, -2] = u[1:-1, 1:-1, -2]
    g[1:-1, 0, 1:-1] = v[1:-1, 0, 1:-1]
    g[1:-1, -2, 1:-1] = v[1:-1, -2, 1:-1]
    h[0, 1:-1, 1:-1] = w[0, 1:-1, 1:-1]
    h[-2, 1:-1, 1:-1] = w[-2, 1:-1, 1:-1]
    return f, g, h


def compute_fgh(u, v, w, dt, re, gx, gy, gz, gamma, dx, dy, dz):
    """Momentum predictor F, G, H on the interior (zero elsewhere) plus the
    wall fixups (computeFG)."""
    terms = fgh_predictor_terms(u, v, w, dt, re, gx, gy, gz, gamma, dx, dy,
                                dz)
    f, g, h = (_with_interior(a, t) for a, t in zip((u, v, w), terms))
    return apply_fgh_wall_fixups(f, g, h, u, v, w)


def rhs_terms_3d(f, g, h, dt, dx, dy, dz):
    """RHS = div(F, G, H)/dt arithmetic on the interior."""
    return (
        (V3(f) - V3(f, di=-1)) / _const(dx, f)
        + (V3(g) - V3(g, dj=-1)) / _const(dy, g)
        + (V3(h) - V3(h, dk=-1)) / _const(dz, h)
    ) * torch.reciprocal(dt)


def compute_rhs(f, g, h, dt, dx, dy, dz):
    """Pressure-Poisson RHS on the interior, zero elsewhere (computeRHS)."""
    return _with_interior(f, rhs_terms_3d(f, g, h, dt, dx, dy, dz))


def adapt_terms_3d(f, g, h, p, dt, dx, dy, dz):
    """Projection arithmetic on the interior."""
    u_new = V3(f) - (V3(p, di=1) - V3(p)) * (dt / _const(dx, dt))
    v_new = V3(g) - (V3(p, dj=1) - V3(p)) * (dt / _const(dy, dt))
    w_new = V3(h) - (V3(p, dk=1) - V3(p)) * (dt / _const(dz, dt))
    return u_new, v_new, w_new


def adapt_uvw(u, v, w, f, g, h, p, dt, dx, dy, dz):
    """Projection (adaptUV): interior cells get the corrected velocity,
    ghost cells keep u, v, w."""
    out = []
    for a, new in zip((u, v, w), adapt_terms_3d(f, g, h, p, dt, dx, dy, dz)):
        a = a.clone()
        a[1:-1, 1:-1, 1:-1] = new
        out.append(a)
    return tuple(out)


# face -> (axis, side); axis 0 = k, 1 = j, 2 = i. The reference applies the
# faces in this order: top, bottom, left, right, front, back.
FACES = {
    "top": (1, "hi"),
    "bottom": (1, "lo"),
    "left": (2, "lo"),
    "right": (2, "hi"),
    "front": (0, "lo"),
    "back": (0, "hi"),
}


def _plane(axis, pos):
    """Index tuple of the `pos` plane along axis, tangentially [1:-1]."""
    idx = [slice(1, -1)] * 3
    idx[axis] = pos
    return tuple(idx)


def set_boundary_conditions_3d(u, v, w, bcs):
    """The six faces' BCs (setBoundaryConditions). bcs maps face name ->
    kind, applied in its insertion order (the reference's: top, bottom,
    left, right, front, back); later faces read earlier faces' writes. On a
    LO face the normal component and the tangential ghosts live at index 0;
    on a HI face the normal lives at -2 (on the wall) and the tangential
    ghosts at -1. NOSLIP mirrors the tangential ghosts negatively, SLIP
    positively, OUTFLOW copies everything from the next plane inward;
    PERIODIC is a no-op, as in the reference. Every write set is
    tangentially [1:-1]."""
    fields = {0: w.clone(), 1: v.clone(), 2: u.clone()}  # normal per axis
    for face, kind in bcs.items():
        if kind not in (NOSLIP, SLIP, OUTFLOW):
            continue
        axis, side = FACES[face]
        if side == "lo":
            ghost_pos, wall_pos, step = 0, 0, 1
        else:
            ghost_pos, wall_pos, step = -1, -2, -1
        ghost = _plane(axis, ghost_pos)
        ghost_in = _plane(axis, ghost_pos + step)
        wall = _plane(axis, wall_pos)
        normal = fields[axis]
        if kind == OUTFLOW:
            normal[wall] = normal[_plane(axis, wall_pos + step)]
        else:  # NOSLIP, SLIP
            normal[wall] = 0.0
        for a in (0, 1, 2):
            if a != axis:
                src = fields[a][ghost_in]
                fields[a][ghost] = -src if kind == NOSLIP else src
    return fields[2], fields[1], fields[0]


def set_special_bc_dcavity_3d(u):
    """Lid U(i, jmax+1, k) = 2 - U(i, jmax, k), skipping the LAST interior
    i and k (the reference's loop bounds, replicated)."""
    u = u.clone()
    u[1:-2, -1, 1:-2] = 2.0 - u[1:-2, -2, 1:-2]
    return u


def set_special_bc_canal_3d(u):
    """Uniform inflow U(0, j, k) = 2.0."""
    u = u.clone()
    u[1:-1, 1:-1, 0] = 2.0
    return u


def set_special_bc_3d(u, problem):
    """The special BC of `problem` ("dcavity" lid or "canal" inflow)."""
    if problem == "dcavity":
        return set_special_bc_dcavity_3d(u)
    if problem == "canal":
        return set_special_bc_canal_3d(u)
    return u


def cfl_dt_3d(umax, vmax, wmax, dt_bound, dx, dy, dz, tau):
    """3-D CFL timestep from the velocity maxima (0-dim tensors)."""
    inf = _const(float("inf"), umax)
    dt = torch.minimum(
        _const(dt_bound, umax),
        torch.minimum(
            torch.where(umax > 0, _const(dx, umax) / umax, inf),
            torch.minimum(
                torch.where(vmax > 0, _const(dy, vmax) / vmax, inf),
                torch.where(wmax > 0, _const(dz, wmax) / wmax, inf),
            ),
        ),
    )
    return dt * tau


def compute_timestep_3d(u, v, w, dt_bound, dx, dy, dz, tau):
    """Adaptive 3-D CFL timestep (computeTimestep)."""
    return cfl_dt_3d(max_element(u), max_element(v), max_element(w),
                     dt_bound, dx, dy, dz, tau)


def normalize_pressure_3d(p, imax, jmax, kmax):
    """Interior-only mean subtract, normalised by imax·jmax·kmax (ghosts
    excluded). Kept for API parity: the reference's 3-D main loop never
    calls it, and neither does the port's."""
    avg = torch.sum(p[1:-1, 1:-1, 1:-1]) / _const(float(imax * jmax * kmax), p)
    p = p.clone()
    p[1:-1, 1:-1, 1:-1] -= avg
    return p


# ----------------------------------------------------------------------
# Global-index gated forms: the phases on a shard's block of a mesh (the
# plain versions of K7/K8 in their distributed mode; the JAX package's
# apply_wall_bcs_3d / apply_special_bc_3d of ops/ns3d_fused.py)
# ----------------------------------------------------------------------


def index_grids(shape, ext_pad: int, offs, device):
    """(gk, gj, gi): the global extended index of every cell of a block
    whose local index a along an axis is global a - ext_pad + offset,
    shaped to broadcast over the block."""
    return tuple(
        (torch.arange(n, device=device) - ext_pad + int(o)).reshape(
            [-1 if d == a else 1 for d in range(3)])
        for a, (n, o) in enumerate(zip(shape, offs)))


def _interior(gk, gj, gi, gext):
    K, J, I = gext
    return ((gk >= 1) & (gk <= K), (gj >= 1) & (gj <= J),
            (gi >= 1) & (gi <= I))


def apply_wall_bcs_3d_gated(u, v, w, gk, gj, gi, bcs, gext):
    """set_boundary_conditions_3d as sequential where-updates gated by the
    global index: the same face order, the same written values, so later
    faces read earlier faces' writes as on one device. The inward read is
    a roll; it wraps only where no face writes. The rolls take the last
    three axes, so lane-stacked (N, K, J, I) class blocks with (N, 1, 1, 1)
    extents in `gext` work as well."""
    fields = {0: w, 1: v, 2: u}  # normal component per axis
    coords = (gk, gj, gi)
    tans = _interior(gk, gj, gi, gext)
    for face, kind in bcs.items():
        if kind not in (NOSLIP, SLIP, OUTFLOW):
            continue
        axis, side = FACES[face]
        g = coords[axis]
        t_axes = [a for a in (0, 1, 2) if a != axis]
        tan = tans[t_axes[0]] & tans[t_axes[1]]
        if side == "lo":
            ghost = wall = (g == 0) & tan
            shift = -1  # inward: the next plane up
        else:
            ghost = (g == gext[axis] + 1) & tan
            wall = (g == gext[axis]) & tan
            shift = 1
        normal = fields[axis]
        if kind == OUTFLOW:
            fields[axis] = torch.where(
                wall, torch.roll(normal, shift, axis - 3), normal)
        else:  # NOSLIP, SLIP
            fields[axis] = torch.where(wall, torch.zeros_like(normal), normal)
        for a in t_axes:
            inward = torch.roll(fields[a], shift, axis - 3)
            fields[a] = torch.where(ghost,
                                    -inward if kind == NOSLIP else inward,
                                    fields[a])
    return fields[2], fields[1], fields[0]


def apply_special_bc_3d_gated(u, gk, gj, gi, problem, gext):
    """The dcavity lid (skipping the last interior i and k) or the canal
    inflow, gated by the global index."""
    K, J, I = gext
    if problem == "dcavity":
        m = ((gj == J + 1) & (gk >= 1) & (gk <= K - 1)
             & (gi >= 1) & (gi <= I - 1))
        return torch.where(m, 2.0 - torch.roll(u, 1, -2), u)
    if problem == "canal":
        m = (gi == 0) & (gk >= 1) & (gk <= K) & (gj >= 1) & (gj <= J)
        return torch.where(m, torch.full_like(u, 2.0), u)
    return u


def fgh_fixups_gated(f, g, h, u, v, w, gk, gj, gi, gext):
    """apply_fgh_wall_fixups gated by the global index: F = U on the
    left/right walls, G = V on bottom/top, H = W on front/back, each
    tangentially on the global interior. Returns new tensors."""
    K, J, I = gext
    in_k, in_j, in_i = _interior(gk, gj, gi, gext)
    return (torch.where(((gi == 0) | (gi == I)) & in_k & in_j, u, f),
            torch.where(((gj == 0) | (gj == J)) & in_k & in_i, v, g),
            torch.where(((gk == 0) | (gk == K)) & in_j & in_i, w, h))


def pre_gated(ud, vd, wd, dt, bcs, problem, re, gx, gy, gz, gamma, dx, dy,
              dz, offs, gext, ext_pad: int, flags=None):
    """PRE on a shard's deep block (the plain version of K7's distributed
    mode): ud, vd, wd are (l+2+2e)-extended blocks (e = ext_pad >= 1) whose
    local index a is global a - e + offset. Returns (u', v', w') on the deep
    block after the wall and special BCs, and F, G, H, rhs on the shard's
    halo-1 block (l+2 per axis). F/G/H hold the predictor on the global
    interior and the wall fixups, zero elsewhere; rhs is set on the owned
    global-interior cells. With the deep block's uint8 `flags` (obstacle
    flag fields) the obstacle velocity BC follows the special BC and F/G/H
    carry U/V/W on non-fluid faces (ops/obstacle3d.py, with the block's
    own faces). Inputs untouched."""
    if ext_pad < 1:
        raise ValueError("the gated PRE needs a deep block (ext_pad >= 1)")
    e = ext_pad
    gk, gj, gi = index_grids(ud.shape, e, offs, ud.device)
    u, v, w = apply_wall_bcs_3d_gated(ud, vd, wd, gk, gj, gi, bcs, gext)
    u = apply_special_bc_3d_gated(u, gk, gj, gi, problem, gext)
    faces = None
    if flags is not None:
        from . import obstacle3d as obst3

        faces = obst3.block_faces_3d(flags, gk, gj, gi, gext, ud.dtype)
        u, v, w = obst3.apply_obstacle_velocity_bc_3d(u, v, w, faces)
    terms = fgh_predictor_terms(u, v, w, dt, re, gx, gy, gz, gamma, dx, dy,
                                dz)
    # the halo-1 block: deep cells [e, L - e), interior terms [e-1, L-e-1)
    out = tuple(slice(e - 1, n - e - 1) for n in ud.shape)
    strip = tuple(slice(e, n - e) for n in ud.shape)
    uo, vo, wo = u[strip], v[strip], w[strip]
    gk, gj, gi = index_grids(uo.shape, 0, offs, ud.device)
    in_k, in_j, in_i = _interior(gk, gj, gi, gext)
    interior = in_k & in_j & in_i
    f, g, h = fgh_fixups_gated(
        *(torch.where(interior, t[out], torch.zeros_like(a))
          for t, a in zip(terms, (uo, vo, wo))), uo, vo, wo, gk, gj, gi,
        gext)
    if faces is not None:
        f, g, h = obst3.mask_fgh(f, g, h, uo, vo, wo, obst3.Faces3D(
            *(a[strip] for a in (faces.fluid, faces.u_face, faces.v_face,
                                 faces.w_face))))
    rhs = torch.zeros_like(f)
    rhs[1:-1, 1:-1, 1:-1] = torch.where(
        interior[1:-1, 1:-1, 1:-1], rhs_terms_3d(f, g, h, dt, dx, dy, dz),
        torch.zeros_like(f[1:-1, 1:-1, 1:-1]))
    return u, v, w, f, g, h, rhs


def _high_neighbours(x):
    """x's + neighbours along i, j, k, read as 0 beyond the block's high
    edge."""
    xp = torch.nn.functional.pad(x, (0, 1, 0, 1, 0, 1))
    return (xp[:-1, :-1, 1:], xp[:-1, 1:, :-1], xp[1:, :-1, :-1])


def post_gated(u, v, w, f, g, h, p, dt, dx, dy, dz, offs, gext, flags=None,
               ragged: bool = False):
    """POST on a shard's halo-1 block (the plain version of K8's
    distributed mode): the projection on the cells of the global interior,
    ghost-ring cells included where they are interface ghosts, with p read
    as 0 beyond the block's high edge; other cells keep u, v, w. With the
    block's uint8 `flags` the projection is multiplied by the face masks,
    a face fluid-fluid where the cell and its + neighbour are fluid (the
    flags, like p, read as 0 beyond the high edge). `ragged` (a mesh that
    does not divide the grid) then multiplies u, v, w by the live mask
    (1 up to the global ghost ring, 0 on the dead cells past it; the JAX
    package's `_post3_kernel(ragged=True)`), so that the dead cells hold 0
    (-0 where the value was negative) and never reach the maxima. Returns
    (u'', v'', w'', max|u''|, max|v''|, max|w''|), the maxima over the
    block. Inputs untouched."""
    gk, gj, gi = index_grids(u.shape, 0, offs, u.device)
    in_k, in_j, in_i = _interior(gk, gj, gi, gext)
    interior = in_k & in_j & in_i
    K, J, I = gext
    live = ((gk <= K + 1) & (gj <= J + 1) & (gi <= I + 1)).to(u.dtype)
    faces = (None,) * 3
    if flags is not None:
        fl = flags.to(u.dtype)
        faces = tuple(fl * nb for nb in _high_neighbours(fl))
    out = []
    for a, fa, pn, d, face in zip((u, v, w), (f, g, h), _high_neighbours(p),
                                  (dx, dy, dz), faces):
        new = fa - (pn - p) * (dt / _const(d, dt))
        if face is not None:
            new = new * face
        new = torch.where(interior, new, a)
        out.append(new * live if ragged else new)
    return (*out, *(max_element(a) for a in out))


def compute_fgh_interior(u, v, w, dt, re, gx, gy, gz, gamma, dx, dy, dz):
    """The momentum predictor F, G, H on the block's interior, zero
    elsewhere, without the wall fixups (the distributed step gates those
    by the global index, fgh_fixups_gated)."""
    terms = fgh_predictor_terms(u, v, w, dt, re, gx, gy, gz, gamma, dx, dy,
                                dz)
    return tuple(_with_interior(a, t) for a, t in zip((u, v, w), terms))
