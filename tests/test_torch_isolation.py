"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor any module of the reference package ``repro``.

Checked in a fresh interpreter, so the modules this test process already
imported (the other test files load both packages) do not hide a leak.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for expected in ("repro_torch.models.moe", "repro_torch.checkpoint.manager", "repro_torch.serving.chaos",
                 "repro_torch.launch.serve", "repro_torch.launch.train", "repro_torch.models.convnets",
                 "repro_torch.data.synthetic", "repro_torch.core.nas.supernet",
                 "repro_torch.core.customize.allocate", "repro_torch.core.packing.bitpack",
                 "repro_torch.launch.mesh", "repro_torch.parallel.sharding"):
    assert expected in names, (expected, names)
for name in names:
    importlib.import_module(name)
leaks = sorted(m for m in sys.modules
               if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names))
print(" ".join(leaks))
"""


def test_port_imports_nothing_of_jax_or_the_reference():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True, env=env,
                         timeout=120, check=True).stdout.splitlines()
    n_modules, leaks = int(out[0]), out[1] if len(out) > 1 else ""
    assert n_modules >= 30, n_modules  # every module was found and imported
    assert leaks == "", f"repro_torch loaded: {leaks}"
