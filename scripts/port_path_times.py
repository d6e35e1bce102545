"""One checkout's 2-D SOR paths on the card, for comparing two checkouts
of the PyTorch/CUDA port in one card session.

    python3 scripts/port_path_times.py TREE LABEL

TREE is the root of a checkout (this one, or an older one unpacked with
`git archive <commit> | tar -x -C _archive/parent`); its own
chip_smoke.py runs: `main_path` (Poisson 4096² f32 400 SOR iterations in
both layouts; the NS-2D dcavity 4096² f32 sor step split PRE / solve /
POST, with and without the flat solve), `main_path_fleet_sor` (the fleet's
sor class lane, buckets A and B, scenarios/s) and configs/dcavity.par at
te 0.02 through that checkout's CLI on one card (wall seconds). Run the
checkouts in the order old, new, new, old in one call."""
import os
import subprocess
import sys
import tempfile
import time

tree, label = os.path.abspath(sys.argv[1]), sys.argv[2]
os.chdir(tree)
sys.path.insert(0, tree)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

print(f"== {label} {tree}", flush=True)
c.build_kernels()
out = {}
c.main_path(torch, out)
c.main_path_fleet_sor(torch)
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
print(f"{label} out {out}", flush=True)
print(f"{label} FAILED {c.FAILED}", flush=True)
sys.exit(1 if c.FAILED or proc.returncode else 0)
