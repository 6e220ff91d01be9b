"""The benchmark's main-path configuration (``voce_fcc_ea_32``: voxel
brick, f32 EA blocks, GMG-preconditioned mixed-precision PCG) on the CPU
at 10^3, the smallest brick on which GMG builds two levels.

One episode of the cell's traffic through ``benchmark.core.run``, in a
process of its own (the harness refuses to run beside JAX, which this
suite's conftest loads): the program's episode is correct against the
plain reference in ``benchmark/reference/``, the float32 reference in the
program's place is not, and the system took the GMG preconditioner.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CELL = "voce_fcc_ea_32.ramp"

_CODE = f"""
import json
from benchmark import core
seen = {{}}

def fault(cell):
    sysm = cell.sim.system
    seen.update(precond=sysm.precond_kind,
                levels=len(sysm.gmg_meta.grids) if sysm.gmg_meta else 0)

r = core.run({CELL!r}, 2**33 + 17, 0.01, False, device="cpu",
             overrides=dict(ncuts=[10, 10, 10], ngrains=8), fault=fault,
             control="reference32", log=lambda *a: None)
print(json.dumps(dict(correct=r["correct"], checks=r["checks"],
                      control=r["control"],
                      control_correct=r["control_correct"],
                      forbidden=core.forbidden_modules(), **seen)))
"""


def test_main_path_cell_correct_on_gmg(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("EXACONSTIT")}
    env["TMPDIR"] = str(tmp_path)
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run([sys.executable, "-c", _CODE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["precond"] == "gmg" and r["levels"] == 2, r
    assert r["correct"], r["checks"]
    limits = {k: v["limit"] for k, v in r["checks"].items()}
    assert any(r["control"][k] > limits[k] for k in limits), r["control"]
    assert r["control_correct"] is False
    assert r["forbidden"] == []
