"""Test bootstrap: provide a `hypothesis` fallback when it isn't installed,
and bound in-process XLA executable accumulation across the suite.

The seed image lacks `hypothesis`; rather than skip the property tests we
register tests/_hypothesis_fallback.py as the `hypothesis` module (a
deterministic, seeded sampler covering the small API surface the suite
uses).  When the real package is available it wins.
"""
from __future__ import annotations

import importlib.util
import pathlib
import sys

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture(scope="module", autouse=True)
def _bound_xla_jit_memory():
    """Drop jit/pjit caches after every test module.

    The suite compiles hundreds of distinct XLA programs (one fused
    engine step per arch x slot-geometry, plus every kernel variant);
    on the CPU backend the LLVM JIT keeps them all resident, and late
    modules have been observed to segfault inside backend_compile once
    enough executables pile up in one process.  Per-module clearing
    costs some recompilation but keeps the live-executable count
    bounded by the largest single module.
    """
    yield
    import jax

    jax.clear_caches()

if importlib.util.find_spec("hypothesis") is None:
    _path = pathlib.Path(__file__).with_name("_hypothesis_fallback.py")
    _spec = importlib.util.spec_from_file_location("hypothesis", _path)
    _mod = importlib.util.module_from_spec(_spec)
    sys.modules["hypothesis"] = _mod
    _spec.loader.exec_module(_mod)
    sys.modules["hypothesis.strategies"] = _mod.strategies
else:
    # Real hypothesis: register an "extended" profile for the deep CI
    # sweep — derandomized (pinned seed) so a red run reproduces exactly.
    # hypothesis has no built-in env-var selection, so the profile is
    # loaded here from HYPOTHESIS_PROFILE; suites that read
    # DIFFCHECK_MAX_EXAMPLES (tests/test_kernels.py) scale their
    # max_examples independently, since per-test @settings would
    # otherwise override the profile value.
    import os

    import hypothesis

    hypothesis.settings.register_profile(
        "extended", deadline=None, derandomize=True, max_examples=100
    )
    hypothesis.settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "default"))
