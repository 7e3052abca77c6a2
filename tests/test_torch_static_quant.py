"""The port's fixed-batch decode against the reference's on quantized
weights, on the CPU, at the smoke sizes: w4a4 packed projections with the
packed (4, 4) LM head, int8 levels (the attn archs on int8 KV caches too)
and mixed per-layer deployment plans, for every family.  The float cases,
the layers and the tolerances are ``tests/test_torch_static.py``'s, whose
helpers these tests call: the reference's packed words, int8 levels and
plan-applied trees cross over through :mod:`repro_torch.bridge`.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
from test_torch_static import _one_torch_thread  # noqa: F401 (the module fixture: one torch thread)
from test_torch_static import DECODE_ARCHS, _check_decode, _check_encode, _model, _np, _weights

from repro_torch.bridge import packed_from_jax
from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
from repro_torch.serving.api import quantize_params_packed

QUANT_CASES = [(a, w) for a in DECODE_ARCHS for w in ("packed", "int8")] + [
    ("llama3.2-3b", "plan"), ("mamba2-130m", "plan")]


@pytest.mark.parametrize("arch,weights", QUANT_CASES, ids=[f"{a}-{w}" for a, w in QUANT_CASES])
def test_forward_decode_matches_reference(arch, weights):
    """Six steps of ``forward_decode``: packed (K1's plain version at every
    projection and the head), int8 levels (the attn archs on int8 KV caches:
    levels equal, scales to ATOL), and a mixed plan (attn: w4a4 / w2a2 with
    layer 1 at block_k 16, K2's plain version; ssm: w2a2 / w5a3) served as
    the per-layer list with the plan's (8, 8) head."""
    _check_decode(arch, weights)


def test_encode_for_decode_packed_matches_reference():
    """whisper-tiny's encoder and cross K/V on w4a4 words: every encoder
    projection and cross K/V through K1's plain version at ``B x Se`` rows."""
    _check_encode("packed")


@pytest.mark.parametrize("arch", ["whisper-tiny", "zamba2-1.2b"])
def test_packed_words_of_encdec_and_hybrid_trees(arch):
    """The port's ``quantize_params_packed`` packs the encoder's, the
    cross-attention's and the shared block's projections (``PROJ_WEIGHT_RE``)
    into the reference's words, with its scales and placements."""
    _, cfg, _, tp = _model(arch)
    rpk = _np(_weights(arch, "packed")[2])
    tpk = quantize_params_packed(tp, w_bits=4, a_bits=4, device="cpu")
    leaves = lambda t: jax.tree_util.tree_flatten_with_path(  # noqa: E731
        t, is_leaf=lambda a: isinstance(a, PackedDenseParams) or hasattr(a, "w_packed"))[0]
    packed = [(jax.tree_util.keystr(k), a, b) for (k, a), (_, b) in zip(leaves(tpk), leaves(rpk))
              if isinstance(a, PackedDenseParams)]
    groups = ("shared_attn",) if arch == "zamba2-1.2b" else ("enc_layers", "xattn_layers")
    assert all(any(g in k for k, _, _ in packed) for g in groups)
    for k, a, b in packed:
        np.testing.assert_array_equal(a.w_packed.numpy(), np.asarray(b.w_packed), err_msg=k)
        assert (a.w_scale, a.n_out, a.cfg) == (b.w_scale, b.n_out, packed_from_jax(b).cfg), k
