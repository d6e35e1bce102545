#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (pampi_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order (any failed phase makes the script exit non-zero before
the last line):

1. build every kernel in pampi_tpu_torch/csrc/ with nvcc (one process per
   source, all started together) and print the build seconds;
2. hold each kernel K1-K4 against its plain PyTorch version on the same
   CUDA inputs, float32 and float64, on an even grid (1024²) and an odd one
   (1023x1021) where the kernel takes odd grids, each with its stated
   tolerance; solve the same Poisson problem 50 times per SOR layout and
   require identical iteration counts and bitwise identical fields;
3. hold each kernel against its plain version once more at the main
   path's shapes (4096² float32), with phase 2's tolerances, then time
   both and compute the least time the card could take;
4. the main path, with every launch count set to 0 just before it:
   Poisson 4096² float32 with tpu_sor_inner 4 for a fixed 400 iterations in
   both SOR layouts (K1, K2), then NS-2D dcavity 4096² float32 (re 1000,
   itermax 100) for 16 steps through NS2DSolver, split into PRE / solve /
   POST with CUDA events and once more with the flat solve to price the
   solve loop's host syncs; every kernel must have been launched;
5. configs/dcavity.par (100², float64) with te 0.5, once on the card and
   once on the CPU: the written .dat fields must agree to 1e-9.

It then prints the kernels line (JSON), the card's name and power limit
from nvidia-smi, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
MAIN = (4096, 4096)         # the main path's grid (jmax, imax)
# --checks-only: the first call after a kernel edit; builds with the
# compiler's register/shared-memory report and stops after phase 2
CHECKS_ONLY = "--checks-only" in sys.argv
FAILED = []


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name):
    """Run fn as a named phase; a failure is recorded, not raised."""
    def wrap(fn):
        def run(*a, **kw):
            log(f"== {name}")
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            except Exception:  # every phase failure is reported, then fails the run
                traceback.print_exc()
                FAILED.append(name)
                log(f"-- {name}: FAILED")
                return None
            log(f"-- {name}: ok ({time.perf_counter() - t0:.1f} s)")
            return out
        return run
    return wrap


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn over reps back-to-back calls (after one
    warm-up call), from CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def rng_fields(torch, np, shape, dtype, n, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape)).to("cuda", dtype)
            for _ in range(n)]


def tol(torch, dtype) -> float:
    # kernel and plain version keep the same association, so fields agree
    # bitwise; the sum of r² is reduced in another order, which moves it by
    # at most ~log2(n)·ulp (~1e-6 f32, ~2e-15 f64 at 4096²). The limit holds
    # fields relative to their scale and the residual relative to itself.
    return 1e-12 if dtype == torch.float64 else 1e-5


def rel_err(a, b) -> float:
    scale = max(1.0, float(b.abs().max()))
    return float((a - b).abs().max()) / scale


@phase("build")
def build_kernels():
    from pampi_tpu_torch.kernels import build as kb

    t0 = time.perf_counter()
    secs = kb.build(verbose=CHECKS_ONLY)
    log(f"build seconds: {json.dumps({k: round(v, 2) for k, v in secs.items()})}"
        f" (wall {time.perf_counter() - t0:.2f} s)")


@phase("kernels vs plain versions")
def check_kernels(torch, np):
    from pampi_tpu_torch.ops import ns2d_fused as nf
    from pampi_tpu_torch.ops import sor_kernels as sk
    from pampi_tpu_torch.ops.sor_quarters import stack_quarters
    from pampi_tpu_torch.utils.params import Parameter

    bad = []
    for dtype in (torch.float32, torch.float64):
        t = tol(torch, dtype)
        for J, I in ((1024, 1024), (1023, 1021)):
            shape = (J + 2, I + 2)
            fac, idx2, idy2 = sk.sor_coefficients(1.0 / I, 1.0 / J, 1.9)
            p, rhs = rng_fields(torch, np, shape, dtype, 2, 11)
            layouts = [("rb_sor_checkerboard", sk.rb_sor_checkerboard,
                        sk.rb_sor_checkerboard_plain, p, rhs)]
            if J % 2 == 0 and I % 2 == 0:
                layouts.append(("rb_sor_quarters", sk.rb_sor_quarters,
                                sk.rb_sor_quarters_plain,
                                stack_quarters(p), stack_quarters(rhs)))
            for name, kern, plain, x, f in layouts:
                xk, xp = x.clone(), x.clone()
                for _ in range(3):  # ghosts carried across calls
                    rk = kern(xk, f, 4, fac, idx2, idy2)
                    rp = plain(xp, f, 4, fac, idx2, idy2)
                e = rel_err(xk, xp)
                er = abs(float(rk) - float(rp)) / abs(float(rp))
                ok = e <= t and er <= t
                log(f"{name} {dtype} {J}x{I}: field max_rel_err {e:.3e}, "
                    f"residual rel_err {er:.3e} (tol {t:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append(name)
            for problem, bc in (("dcavity", (1, 1, 1, 1)),
                                ("canal", (3, 3, 1, 1))):
                param = Parameter(name=problem, imax=I, jmax=J, re=100.0,
                                  bcLeft=bc[0], bcRight=bc[1],
                                  bcBottom=bc[2], bcTop=bc[3])
                cfg = nf.StepConfig.from_param(param)
                u, v, pp = rng_fields(torch, np, shape, dtype, 3, 5)
                dt = torch.tensor(0.013, dtype=dtype, device="cuda")
                uk, vk = u.clone(), v.clone()
                fk, gk, rk = nf.ns2d_pre(uk, vk, dt, cfg)
                u1, v1, f1, g1, r1 = nf.ns2d_pre_plain(u, v, dt, cfg)
                copies = torch.equal(uk, u1) and torch.equal(vk, v1)
                e = max(rel_err(fk, f1), rel_err(gk, g1), rel_err(rk, r1))
                ok = copies and e <= t
                log(f"ns2d_pre {problem} {dtype} {J}x{I}: u', v' bitwise "
                    f"{copies}, F/G/rhs max_rel_err {e:.3e} (tol {t:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append("ns2d_pre")
                umax, vmax = nf.ns2d_post(uk, vk, fk, gk, pp, dt, cfg.dx,
                                          cfg.dy)
                u2, v2, um2, vm2 = nf.ns2d_post_plain(
                    u1, v1, f1, g1, pp, dt, cfg.dx, cfg.dy)
                e = max(rel_err(uk, u2), rel_err(vk, v2))
                own = (torch.equal(umax, uk.abs().max())
                       and torch.equal(vmax, vk.abs().max()))
                em = max(abs(float(umax - um2)), abs(float(vmax - vm2)))
                ok = e <= t and own and em <= t * max(1.0, float(um2))
                log(f"ns2d_post {problem} {dtype} {J}x{I}: u'', v'' "
                    f"max_rel_err {e:.3e}, maxima bitwise vs own fields "
                    f"{own}, vs plain {em:.3e} (tol {t:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append("ns2d_post")
    if bad:
        raise AssertionError(f"kernels disagree with plain versions: {bad}")


@phase("iteration counts over 50 solves")
def check_repeat_solves(torch):
    from pampi_tpu_torch.models.poisson import init_fields, make_solver_fn
    from pampi_tpu_torch.utils.params import Parameter

    for layout, dtype, (J, I), eps in (
            ("quarters", torch.float32, (128, 128), 1e-2),
            ("checkerboard", torch.float64, (127, 125), 1e-5)):
        param = Parameter(imax=I, jmax=J)
        p0, rhs = init_fields(param, 2, dtype, "cuda")
        solve = make_solver_fn(I, J, 1.0 / I, 1.0 / J, 1.9, eps, 20000,
                               dtype, n_inner=4, layout=layout)
        first = None
        for _ in range(50):
            p, res, it = solve(p0.clone(), rhs)
            if first is None:
                first = (p, res, it)
            elif it != first[2] or res != first[1] or not torch.equal(p, first[0]):
                raise AssertionError(
                    f"{layout}: solve not reproducible ({it} vs {first[2]})")
        log(f"{layout} {dtype} {J}x{I}: 50 solves, {first[2]} iterations "
            f"each (cap 20000), residual {first[1]:.6e} (eps² {eps * eps:g}),"
            f" fields bitwise identical")


@phase("kernels vs plain versions and their times at 4096² float32")
def time_kernels(torch, np):
    from pampi_tpu_torch.ops import ns2d_fused as nf
    from pampi_tpu_torch.ops import sor_kernels as sk
    from pampi_tpu_torch.ops.sor_quarters import stack_quarters
    from pampi_tpu_torch.utils.params import Parameter

    J, I = MAIN
    dtype = torch.float32
    t = tol(torch, dtype)
    size = 4
    cells = (J + 2) * (I + 2)
    ring = 2 * (I + 2) + 2 * J  # the ghost cells of one field
    interior = J * I
    fac, idx2, idy2 = sk.sor_coefficients(1.0 / I, 1.0 / J, 1.8)
    p, rhs, u, v, pp = rng_fields(torch, np, (J + 2, I + 2), dtype, 5, 3)
    q, f = stack_quarters(p), stack_quarters(rhs)
    param = Parameter(name="dcavity", imax=I, jmax=J, re=1000.0)
    cfg = nf.StepConfig.from_param(param)
    dt = torch.tensor(1e-4, dtype=dtype, device="cuda")
    n_inner = 4
    rows, bad = {}, []

    def bound(nbytes, flops):
        b, o = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        return (b, "bytes") if b >= o else (o, "operations")

    def verdict(name, ok, detail):
        log(f"{name} 4096² f32 vs plain: {detail} {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(name)

    # SOR: p and rhs read once, p written once; ~12 flops per update
    sor_bound = bound(3 * cells * size, 12 * n_inner * interior)
    for name, kern, plain, x, r in (
            ("rb_sor_quarters", sk.rb_sor_quarters, sk.rb_sor_quarters_plain,
             q, f),
            ("rb_sor_checkerboard", sk.rb_sor_checkerboard,
             sk.rb_sor_checkerboard_plain, p, rhs)):
        xk, xp = x.clone(), x.clone()
        rk = kern(xk, r, n_inner, fac, idx2, idy2)
        rp = plain(xp, r, n_inner, fac, idx2, idy2)
        err = float((xk - xp).abs().max())
        e, er = rel_err(xk, xp), abs(float(rk) - float(rp)) / abs(float(rp))
        verdict(name, e <= t and er <= t,
                f"field max_rel_err {e:.3e}, residual rel_err {er:.3e} "
                f"(tol {t:g})")
        ms = cuda_ms(torch, lambda: kern(xk, r, n_inner, fac, idx2, idy2), 20)
        pms = cuda_ms(torch, lambda: plain(xp, r, n_inner, fac, idx2, idy2), 5)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                          bound_ms=sor_bound[0], bound_by=sor_bound[1])
    # PRE, in place: reads u and v; writes F, G, rhs and the ghost ring of u
    # and v (the TPU kernel writes whole new u and v arrays); ~80 flops/cell
    uk, vk = u.clone(), v.clone()
    fk, gk, rk = nf.ns2d_pre(uk, vk, dt, cfg)
    plain_out = nf.ns2d_pre_plain(u, v, dt, cfg)
    err = max(float((a - b).abs().max())
              for a, b in zip((uk, vk, fk, gk, rk), plain_out))
    copies = torch.equal(uk, plain_out[0]) and torch.equal(vk, plain_out[1])
    e = max(rel_err(a, b) for a, b in zip((fk, gk, rk), plain_out[2:]))
    verdict("ns2d_pre", copies and e <= t,
            f"u', v' bitwise {copies}, F/G/rhs max_rel_err {e:.3e} (tol {t:g})")
    u1, v1 = plain_out[0], plain_out[1]
    u2, v2 = uk.clone(), vk.clone()  # POST's inputs, before PRE is re-timed
    ms = cuda_ms(torch, lambda: nf.ns2d_pre(uk, vk, dt, cfg), 20)
    pms = cuda_ms(torch, lambda: nf.ns2d_pre_plain(u, v, dt, cfg), 5)
    b = bound((5 * cells + 2 * ring) * size, 80 * interior)
    rows["ns2d_pre"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                            bound_ms=b[0], bound_by=b[1])
    # POST, in place: reads F, G, p and the ghost ring of u and v (for the
    # maxima); writes the interior of u and v (the TPU kernel reads and
    # writes whole u and v arrays); ~10 flops per cell
    umax, vmax = nf.ns2d_post(u2, v2, fk, gk, pp, dt, cfg.dx, cfg.dy)
    up, vp, ump, vmp = nf.ns2d_post_plain(u1, v1, fk, gk, pp, dt, cfg.dx,
                                          cfg.dy)
    err = max(float((u2 - up).abs().max()), float((v2 - vp).abs().max()))
    e = max(rel_err(u2, up), rel_err(v2, vp))
    own = (torch.equal(umax, u2.abs().max())
           and torch.equal(vmax, v2.abs().max()))
    em = max(abs(float(umax - ump)), abs(float(vmax - vmp)))
    verdict("ns2d_post", e <= t and own and em <= t * max(1.0, float(ump)),
            f"u'', v'' max_rel_err {e:.3e}, maxima bitwise vs own fields "
            f"{own}, vs plain {em:.3e} (tol {t:g})")
    ms = cuda_ms(torch, lambda: nf.ns2d_post(u2, v2, fk, gk, pp, dt, cfg.dx,
                                             cfg.dy), 20)
    pms = cuda_ms(torch, lambda: nf.ns2d_post_plain(u1, v1, fk, gk, pp, dt,
                                                    cfg.dx, cfg.dy), 5)
    b = bound((5 * cells + 2 * ring) * size, 10 * interior)
    rows["ns2d_post"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                             bound_ms=b[0], bound_by=b[1])
    for name, r in rows.items():
        log(f"{name} 4096² f32: {r['ms']:.4f} ms/call (plain {r['plain_ms']:.4f},"
            f" bound {r['bound_ms']:.4f} by {r['bound_by']}), "
            f"max_abs_err vs plain {r['max_abs_err']:.3e}")
    if bad:
        raise AssertionError(f"kernels disagree with plain versions at "
                             f"4096²: {bad}")
    return rows


@phase("main path: Poisson 4096² and NS-2D dcavity 4096²")
def main_path(torch):
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns2d import NS2DSolver
    from pampi_tpu_torch.models.poisson import PoissonSolver
    from pampi_tpu_torch.utils.params import Parameter

    J, I = MAIN
    kb.reset_launches()
    out = {}
    for layout in ("auto", "checkerboard"):
        param = Parameter(name="poisson", imax=I, jmax=J, itermax=400,
                          eps=0.0, omg=1.9, tpu_dtype="float32",
                          tpu_sor_inner=4, tpu_sor_layout=layout)
        s = PoissonSolver(param, device="cuda")
        s.solve()  # warm-up: loads the kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it, res = s.solve()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if it != 400 or not res == res or not bool(torch.isfinite(s.p).all()):
            raise AssertionError(f"Poisson {layout}: it={it} res={res}")
        log(f"Poisson 4096² f32 layout {layout}: {it} iterations, "
            f"{sec / it * 1e3:.4f} ms/iteration, "
            f"{J * I * it / sec:.4e} site-updates/s, residual {res:.4e}")
        out[f"poisson_{layout}_ms_per_iter"] = sec / it * 1e3

    for flat in (0, 1):
        # eps 0: every solve runs its itermax (a 4096² cavity never
        # converges within 100 iterations), so flat and checked solves do
        # the same work and differ only by the checks' host syncs
        param = Parameter(name="dcavity", imax=I, jmax=J, re=1000.0,
                          itermax=100, eps=0.0, te=1e9, tpu_dtype="float32",
                          tpu_sor_inner=4, tpu_flat_solve=flat)
        s = NS2DSolver(param, device="cuda")
        s.run_steps(1)  # warm-up
        marks = []

        def hook(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        s.phase_hook = hook
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run_steps(16)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 16 * 1e3
        split = {"pre": 0.0, "solve": 0.0, "post": 0.0}
        for (name, a), (_, b) in zip(marks, marks[1:]):
            if name in split:
                split[name] += a.elapsed_time(b) / 16
        finite = all(bool(torch.isfinite(x).all()) for x in (s.u, s.v, s.p))
        if not finite or s.nt != 17:
            raise AssertionError(f"NS-2D: finite={finite} nt={s.nt}")
        log(f"NS-2D dcavity 4096² f32 (flat solve {flat}): {wall:.3f} ms/step"
            f" (host clock); PRE {split['pre']:.3f} / solve "
            f"{split['solve']:.3f} / POST {split['post']:.3f} ms (CUDA "
            f"events), t={s.t:.6e}")
        out[f"ns2d_flat{flat}"] = dict(ms_per_step=wall, **split)
    synced = out["ns2d_flat0"]["solve"]
    flat_solve = out["ns2d_flat1"]["solve"]
    log(f"host-sync share of the NS solve loop: "
        f"{(synced - flat_solve) / synced:.3f} ({synced:.3f} vs flat "
        f"{flat_solve:.3f} ms/step)")
    counts = {k: v.launches for k, v in kb.KERNELS.items()}
    log(f"main-path launches: {json.dumps(counts)}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return counts


@phase("configs/dcavity.par te 0.5: card vs CPU")
def dcavity_card_vs_cpu(np):
    from pampi_tpu_torch.models.ns2d import NS2DSolver
    from pampi_tpu_torch.utils.datio import read_pressure, read_velocity
    from pampi_tpu_torch.utils.params import read_parameter

    param = read_parameter(os.path.join(ROOT, "configs", "dcavity.par"))
    param = param.replace(te=0.5)
    with tempfile.TemporaryDirectory() as tmp:
        fields = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            s = NS2DSolver(param, device=device)
            s.run(progress=False)
            pp = os.path.join(tmp, f"pressure_{device}.dat")
            vp = os.path.join(tmp, f"velocity_{device}.dat")
            s.write_result(pp, vp)
            fields[device] = (read_pressure(pp), *read_velocity(vp))
            log(f"{device}: {s.nt} steps to t={s.t:.6f} in "
                f"{time.perf_counter() - t0:.1f} s")
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(fields["cuda"], fields["cpu"]))
    log(f"dcavity.par te 0.5 f64: max |card - cpu| over the .dat fields "
        f"{diff:.3e} (tol 1e-9)")
    if not diff <= 1e-9:
        raise AssertionError(f".dat fields differ by {diff}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import pampi_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    build_kernels()
    rows = counts = None
    if not FAILED:
        check_kernels(torch, np)
        check_repeat_solves(torch)
    if CHECKS_ONLY:
        log(f"checks only; failed: {FAILED}")
        return 1 if FAILED else 0
    if not FAILED:
        rows = time_kernels(torch, np)
        counts = main_path(torch)
        dcavity_card_vs_cpu(np)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        log(f"nvidia-smi: {exc}")
        FAILED.append("nvidia-smi")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if FAILED or rows is None or counts is None:
        log(f"chip_smoke FAILED: {FAILED}")
        return 1
    from pampi_tpu_torch.kernels import build as kb

    kernels = []
    for name, k in kb.KERNELS.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=k.source, replaces=k.replaces,
            launches=counts[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
