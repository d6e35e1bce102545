"""K1's CTA shapes on the card: each shape held bitwise against the plain
version (1022x1020 and 100², n = 1, 4 and 9), then timed (CUDA events,
torch.profiler's busy time and launches a call) at 4096² and 100², n = 1
and 4, float32 and float64; and, for reference, K13's one-pass template
run as K1 (ring 0, float32 boxes) and K1 bf16 at 4096² n = 4.

    python3 scripts/port_k1_shapes.py [QS,QK ...]

Each shape (64 columns, QS row segments of QK rows) must have its
`Q_SHAPE` line in csrc/sor_rb.cu run_q_tiled: the ones shipped are 4,8
(float32) and 4,4 (float64); the others measured in PERF.md (8,8; 8,4;
16,4) were added there for the measurement."""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as c  # noqa: E402
from pampi_tpu_torch.kernels import build as kb  # noqa: E402
from pampi_tpu_torch.ops import sor_kernels as sk  # noqa: E402
from pampi_tpu_torch.ops import sor_qdist as sq  # noqa: E402
from pampi_tpu_torch.ops.sor_quarters import stack_quarters  # noqa: E402

kb.build(["sor_rb", "sor_qdist"], verbose=True)
shapes = [tuple(int(x) for x in a.split(",")) for a in sys.argv[1:]]
out, bad = {}, []


def use(itemsize, qs, qk):
    sk.K1_CTA[itemsize] = (64, qs, qk)
    sk.quarters_passes.cache_clear()
    sk.quarters_launch_plan.cache_clear()


for dtype in (torch.float32, torch.float64):
    isz = dtype.itemsize
    for qs, qk in shapes or [sk.K1_CTA[isz][1:]]:
        use(isz, qs, qk)
        for J, I in ((1022, 1020), (100, 100)):
            coef = sk.sor_coefficients(1.0 / I, 1.0 / J, 1.9)
            q, f = (stack_quarters(a) for a in c.rng_fields(
                torch, np, (J + 2, I + 2), dtype, 2, 11))
            for n in (1, 4, 9):
                qp, o = q.clone(), torch.empty_like(q)
                rk = sk.rb_sor_quarters(q, f, n, *coef, out=o)
                rp = sk.rb_sor_quarters_plain(qp, f, n, *coef)
                if not (torch.equal(o, qp) and torch.equal(rk, rp)):
                    bad.append((str(dtype), qs, qk, J, n))
        for J, n, reps in ((4096, 4, 50), (4096, 1, 50), (100, 1, 1000),
                           (100, 4, 1000)):
            coef = sk.sor_coefficients(1.0 / J, 1.0 / J, 1.9)
            q, f = (stack_quarters(a) for a in c.rng_fields(
                torch, np, (J + 2, J + 2), dtype, 2, 3))
            o = torch.empty_like(q)

            def call():
                return sk.rb_sor_quarters(q, f, n, *coef, out=o)

            ms = c.cuda_ms(torch, call, reps)
            n_dev, busy = c.device_trace(torch, call)
            key = f"{dtype}_64x{qs}x{qk}_{J}_n{n}"
            out[key] = dict(ms=ms, busy=busy, launches=n_dev)
            print(key, out[key], flush=True)
use(4, 4, 8)
use(8, 4, 4)
J = 4096
coef = sk.sor_coefficients(1.0 / J, 1.0 / J, 1.9)
q, f = (stack_quarters(a) for a in c.rng_fields(
    torch, np, (J + 2, J + 2), torch.float32, 2, 3))
o = torch.empty_like(q)
g = sq.quarters_geom(q.shape[1], q.shape[2])
pl = sq.qdist_pass_plan(g, 4, 4)
launches = ((-(-g.jq // pl.th) * -(-g.iq // pl.tw),
             sq._geometry(g, pl, 0, 0, ring=0)),)
lib = kb.load("sor_qdist", sq._SIGNATURES)


def template():
    def launch(src, dst, geo, partial, ticket, res, stream):
        kb.check(lib, lib.rb_sor_qdist_f32(
            q.device.index, src.data_ptr(), f.data_ptr(), dst.data_ptr(),
            geo, *coef, partial.data_ptr(), ticket.data_ptr(),
            res.data_ptr(), stream), "rb_sor_qdist_f32")
    return sk.run_passes(q, launches, o, launch)


out["k13_template_ring0_4096_f32_n4"] = dict(ms=c.cuda_ms(torch, template,
                                                          50))
qb, fb = q.to(torch.bfloat16), f.to(torch.bfloat16)
ob = torch.empty_like(qb)
out["k1bf16_4096_n4"] = dict(ms=c.cuda_ms(
    torch, lambda: sk.rb_sor_quarters(qb, fb, 4, *coef, out=ob), 50))
print("BAD", bad)
print(json.dumps(out))
sys.exit(1 if bad else 0)
