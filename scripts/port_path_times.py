"""One checkout's 2-D SOR paths on the card, for comparing two checkouts
of the PyTorch/CUDA port in one card session.

    python3 scripts/port_path_times.py TREE LABEL [PART ...]

TREE is the root of a checkout (this one, or an older one unpacked with
`git archive <commit> | tar -x -C _archive/parent`); its own
chip_smoke.py runs the PARTs (default: all): `main` (main_path: Poisson
4096² f32 400 SOR iterations in both layouts; the NS-2D dcavity 4096² f32
sor step split PRE / solve / POST, with and without the flat solve),
`fleet_sor` (main_path_fleet_sor: the fleet's sor class lane, buckets A
and B, scenarios/s), `fleet_mg` (main_path_fleet: the fleet's mg class
lane, buckets A and B, scenarios/s and K18's ms a call) and `dcavity`
(configs/dcavity.par at te 0.02 through that checkout's CLI on one card,
wall seconds). Run the checkouts in the order old, new, new, old in one
call."""
import os
import subprocess
import sys
import tempfile
import time

tree, label = os.path.abspath(sys.argv[1]), sys.argv[2]
parts = sys.argv[3:] or ["main", "fleet_sor", "fleet_mg", "dcavity"]
os.chdir(tree)
sys.path.insert(0, tree)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

print(f"== {label} {tree}", flush=True)
c.build_kernels()
out, rc = {}, 0
if "main" in parts:
    c.main_path(torch, out)
if "fleet_sor" in parts:
    c.main_path_fleet_sor(torch)
if "fleet_mg" in parts:
    c.main_path_fleet(torch)
if "dcavity" in parts:
    tmp = tempfile.mkdtemp(prefix=f"dcav_{label}_")
    par = c.dcavity_par(tmp, 0.02)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pampi_tpu_torch", par],
                          cwd=tmp, env=dict(os.environ, PYTHONPATH=tree),
                          capture_output=True, text=True)
    secs = time.perf_counter() - t0
    tail = [ln for ln in proc.stdout.splitlines() if ln.strip()][-3:]
    print(f"{label} dcavity.par te 0.02 one card CLI: rc {proc.returncode}, "
          f"{secs:.2f} s wall, tail {tail}", flush=True)
    rc = proc.returncode
print(f"{label} out {out}", flush=True)
print(f"{label} FAILED {c.FAILED}", flush=True)
sys.exit(1 if c.FAILED or rc else 0)
