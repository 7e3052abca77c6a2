"""The training half of the mesh in the port against the JAX reference, on
the CPU, at the smoke sizes.

The port's mesh is one process driving ``dp x mp`` ranks in lockstep
(:mod:`repro_torch.launch.mesh`), here every rank on the CPU
(``["cpu"] * 4``).  The reference needs a device a rank, so one
module-scoped subprocess runs it on four forced host devices (a ``(2, 2)``
``(data, model)`` mesh) and writes what the tests compare to: its jitted
sharded train steps, their gradients, its ``_moe_block`` under the rules
(the ``all_to_all`` path) with gradients, and a checkpoint saved from its
mesh.  The rules' specs, the bf16 tensor-parallel decode rows and the
refusals need no mesh and run in this process.

Tolerances.  At float32: losses ``LOSS_RTOL`` relative, each gradient
leaf ``GRAD_REL_L2`` relative L2 over every rank's copy, the clip's
global norm ``LOSS_RTOL``, params after each step within ``2.5 lr``
(the reference's ``check_train_parity`` bound: Adam's first steps are
about ``sign(g) lr``, so a gradient element at rounding scale may flip
its step).  yi-6b at bfloat16 under ``check_train_parity``'s own
tolerances (``BF16_LOSS_RTOL``, ``BF16_PARAM_RTOL`` and ``2.5 lr``).  The
MoE block within ``MOE_TOL``.  Compression and checkpoint restores are
bit-exact.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.quant import weight_tanh_max as ref_weight_tanh_max
from repro.launch import steps as RSTEPS
from repro.models import transformer as RT
from repro.models.layers import prepack_lm_head as ref_prepack_lm_head
from repro.parallel import sharding as RS
from repro.serving import api as RA
from repro_torch.bridge import sharded_from_jax, shards_from_jax
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import mesh as LM
from repro_torch.launch import steps as S
from repro_torch.models import layers as L
from repro_torch.models import moe as X
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWState, global_norm
from repro_torch.optim.adamw import tree_leaves
from repro_torch.optim.compression import compress_tree
from repro_torch.parallel import sharding as PS
from repro_torch.runtime import FaultTolerantRunner, RunnerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
LR = 3e-4
PARAM_ATOL = 2.5 * LR
BF16_LOSS_RTOL, BF16_PARAM_RTOL = 2e-3, 2e-2
MOE_TOL = 1e-5
# the bf16 tensor-parallel decode rows against the reference's, both
# summing the ranks' shares in the same order: a row's relative L2 (w4a4
# packed, float weights)
BF16_TP_ROW_REL = {True: 0.05, False: 0.02}
SEQ, BATCH, N_MICRO = 16, 4, 2

# case: (arch, float32, fsdp, zero3_regather, steps)
TRAIN_CASES = {
    "llama_none": ("llama3.2-3b", True, None, False, 3),
    "llama_zero3": ("llama3.2-3b", True, "data", True, 3),
    "mamba_fsdp": ("mamba2-130m", True, "data", False, 3),
    "yi_bf16": ("yi-6b", False, None, False, 1),
}
MOE_CAPACITIES = (8.0, 1.25)

REF_SCRIPT = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import CheckpointManager
from repro.configs import get_config
from repro.data.tokens import TokenStream
from repro.launch import steps as S
from repro.launch.mesh import as_shardings, make_host_mesh, mesh_context
from repro.models import transformer as T
from repro.models.moe import MoESpec, moe_init, moe_reference
from repro.optim import global_norm
from repro.parallel.sharding import ShardingRules, use_rules

CASES, CAPS, SEQ, BATCH, N_MICRO = eval(sys.argv[2])
out = {}


def put_flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = prefix + "/" + "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        out[key] = np.asarray(leaf.astype(jnp.float32) if leaf.dtype == jnp.bfloat16 else leaf)


mesh = make_host_mesh((2, 2), ("data", "model"))
for name, (arch, f32, fsdp, z3, steps) in CASES.items():
    cfg = dataclasses.replace(get_config(arch, smoke=True), zero3_regather=z3)
    if f32:
        cfg = dataclasses.replace(cfg, dtype=jnp.float32)
    params = T.init_params(jax.random.PRNGKey(0), cfg)
    ts = TokenStream(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=1)
    rules = ShardingRules(mesh=mesh, batch="data", fsdp=fsdp)
    with mesh_context(mesh):
        p_specs = S.param_shardings(jax.eval_shape(lambda: params), rules)
        o_specs = S.param_shardings_opt(None, p_specs)
        b_specs = S.batch_shardings(cfg, rules)
        step = S.make_train_step(cfg, rules, S.TrainStepConfig(n_micro=N_MICRO))
        fn = jax.jit(step, in_shardings=as_shardings(mesh, (p_specs, o_specs, b_specs)),
                     out_shardings=as_shardings(mesh, (P(), p_specs, o_specs)))
        put = lambda tree, specs: jax.tree.map(lambda a, sp: jax.device_put(a, NamedSharding(mesh, sp)), tree, specs)

        def loss_grads(p, batch):  # the step's micro-batched gradients, before the update
            with use_rules(rules):
                micro = jax.tree.map(lambda a: a.reshape((N_MICRO, a.shape[0] // N_MICRO) + a.shape[1:]), batch)
                vg = [jax.value_and_grad(lambda q, m: T.forward_train(q, cfg, m))(
                    p, jax.tree.map(lambda a: a[i], micro)) for i in range(N_MICRO)]
                grads = jax.tree.map(lambda *g: sum(g) / N_MICRO, *[g for _, g in vg])
                return sum(l for l, _ in vg) / N_MICRO, grads

        lg = jax.jit(loss_grads, in_shardings=as_shardings(mesh, (p_specs, b_specs)),
                     out_shardings=as_shardings(mesh, (P(), p_specs)))
        p, o = put(params, p_specs), put(step.optimizer.init(params), o_specs)
        _, g0 = lg(p, put(jax.tree.map(jnp.asarray, ts.batch(0)), b_specs))
        put_flat(f"{name}/grads", g0)
        out[f"{name}/gnorm"] = np.asarray(global_norm(g0))
        put_flat(f"{name}/params0", params)
        losses = []
        for i in range(steps):
            loss, p, o = fn(p, o, put(jax.tree.map(jnp.asarray, ts.batch(i)), b_specs))
            losses.append(float(loss))
            put_flat(f"{name}/params{i + 1}", p)
            if i == 0:
                put_flat(f"{name}/opt1", o)
        out[f"{name}/losses"] = np.asarray(losses)

# the all_to_all MoE block (tests/multidevice_checks.py's check_moe_all_to_all) with gradients
for cf in CAPS:
    spec = MoESpec(d_model=16, d_ff=32, n_experts=8, top_k=2, capacity_factor=cf)
    mparams = moe_init(jax.random.PRNGKey(0), spec)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 8, 16)) * 0.5
    ct = jax.random.normal(jax.random.PRNGKey(2), (2, 8, 16))
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", smoke=True), d_model=16, n_experts=8, top_k=2,
                              expert_d_ff=32, capacity_factor=cf, mlp_kind="swiglu")
    with mesh_context(mesh), use_rules(ShardingRules(mesh=mesh, batch="data", fsdp=None)):
        f = lambda p, v: T._moe_block(p, cfg, v)
        y = jax.jit(f)(mparams, x)
        gp, gx = jax.jit(jax.grad(lambda p, v: jnp.sum(f(p, v) * ct), argnums=(0, 1)))(mparams, x)
    put_flat(f"moe{cf}/params", mparams)
    put_flat(f"moe{cf}/gparams", gp)
    for k, v in (("x", x), ("ct", ct), ("y", y), ("gx", gx), ("dense", moe_reference(mparams, spec, x))):
        out[f"moe{cf}/{k}"] = np.asarray(v)

# a checkpoint saved from the (2, 2) mesh (check_checkpoint_reshard's)
cfg = get_config("llama3.2-3b", smoke=True)
params = T.init_params(jax.random.PRNGKey(0), cfg)
rules = ShardingRules(mesh=mesh, batch="data")
with mesh_context(mesh):
    specs = S.param_shardings(jax.eval_shape(lambda: params), rules)
    sharded = jax.tree.map(lambda a, sp: jax.device_put(a, NamedSharding(mesh, sp)), params, specs)
CheckpointManager(sys.argv[1] + "_ckpt", keep=2).save(7, sharded)
put_flat("ckpt/params", params)
np.savez(sys.argv[1] + ".npz", **out)
"""


class Ref(dict):
    """The reference's results by key; :meth:`tree` rebuilds a params tree
    (the port's tensors) from a prefix."""

    def tree(self, prefix: str, numpy: bool = False) -> dict:
        out: dict = {}
        for key, arr in self.items():
            if not key.startswith(prefix + "/"):
                continue
            node, parts = out, key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.array(arr) if numpy else torch.from_numpy(np.array(arr))
        return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory) -> Ref:
    """The reference's mesh runs on four forced host devices, once."""
    out = tmp_path_factory.mktemp("ref_mesh_train") / "ref"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    args = repr((TRAIN_CASES, MOE_CAPACITIES, SEQ, BATCH, N_MICRO))
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out), args], env=env, timeout=240,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = Ref(np.load(str(out) + ".npz"))
    r.ckpt_dir = pathlib.Path(str(out) + "_ckpt")
    return r


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (at the smoke size thread hand-offs cost more
    than the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(dp: int = 2, mp: int = 2) -> LM.Mesh:
    return LM.make_mesh(dp, mp, ["cpu"] * (dp * mp))


def _cfg(arch: str, float32: bool = True, **kw):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    return dataclasses.replace(cfg, dtype=torch.float32) if float32 else cfg


def _batch(cfg, step: int) -> dict:
    ts = TokenStream(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=1)
    return {k: torch.from_numpy(v) for k, v in ts.batch(step).items()}


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix.rstrip("/"): tree}


def _blocks(x: LM.Sharded, full: torch.Tensor):
    """Every part of ``x`` beside its block of the whole array ``full``."""
    for i, r in itertools.product(range(x.mesh.dp), range(x.mesh.mp)):
        yield x.part(i, r).detach(), full[LM._block_slices(x.shape, x.spec, x.mesh, i, r)]


def check_grads(grads: dict, want: dict, tol: float = GRAD_REL_L2) -> None:
    """Each gradient leaf within ``tol`` relative L2 of the reference's,
    over every rank's copy (a replica's own copy is checked, not just the
    gathered array)."""
    want = _flat(want)
    for key, g in _flat(grads).items():
        num = den = 0.0
        for part, blk in _blocks(g, want[key]):
            num += float(torch.sum((part.double() - blk.double()) ** 2))
            den += float(torch.sum(blk.double() ** 2))
        assert num ** 0.5 <= tol * den ** 0.5 + 1e-30, f"{key}: relative L2 {(num / max(den, 1e-300)) ** 0.5:.3g}"


def check_params(params: dict, want: dict, rtol: float = 0.0, atol: float = PARAM_ATOL) -> None:
    want = _flat(want)
    for key, p in _flat(params).items():
        for part, blk in _blocks(p, want[key]):
            np.testing.assert_allclose(part.float().numpy(), blk.float().numpy(), rtol=rtol, atol=atol, err_msg=key)


def _sharded_params(ref: Ref, case: str, mesh: LM.Mesh, rules, which: str = "params0") -> dict:
    """The reference's params of a case as the port's shards on ``mesh``
    (``bridge.sharded_from_jax``)."""
    params = ref.tree(f"{case}/{which}", numpy=True)
    return sharded_from_jax(params, PS.param_shardings(params, rules), mesh)


def _case(case: str):
    arch, f32, fsdp, z3, steps = TRAIN_CASES[case]
    mesh = _mesh()
    cfg = _cfg(arch, f32, zero3_regather=z3)
    return cfg, mesh, PS.ShardingRules(mesh=mesh, batch="data", fsdp=fsdp), steps


def _clear(params) -> None:
    for x in tree_leaves(params):
        for q in x.parts:
            q.grad = None


# -- the rules and the specs ---------------------------------------------------------


@pytest.mark.parametrize("fsdp", [None, "data"], ids=["default", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch, fsdp):
    """``param_shardings`` (hence ``spec_for_param_path``) gives every leaf
    of every arch the reference's spec, the stacked ``L`` axis padded."""
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    theirs = RS.param_shardings(jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), rcfg)),
                                RS.ShardingRules(fsdp=fsdp))
    ours = PS.param_shardings(T.init_params(cfg, seed=0, device="cpu"), PS.ShardingRules(fsdp=fsdp))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                theirs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    assert {k: tuple(v) for k, v in _flat(ours).items()} == flat
    assert all(isinstance(v, PS.P) for v in _flat(ours).values())
    assert S.param_shardings_opt(None, ours).mu is ours


def test_use_rules_nests_and_disabled_rules_are_no_ops():
    """``use_rules`` restores the outer rules on exit (also after a raise);
    ``spec`` resolves logical axes under active rules and gives ``P()``
    without rules or with disabled ones; ``shard`` returns its argument; a
    disabled or mesh-less rules object runs the one-device path."""
    outer, inner = PS.ShardingRules(batch="data"), PS.ShardingRules(enabled=False)
    rinner = RS.ShardingRules(enabled=False)
    assert PS.current_rules() is None and PS.spec("batch", None) == PS.P()
    with PS.use_rules(outer), RS.use_rules(RS.ShardingRules(batch="data")):
        assert PS.current_rules() is outer
        assert tuple(PS.spec("batch", "heads", None)) == tuple(RS.spec("batch", "heads", None)) == ("data", "model",
                                                                                                    None)
        with PS.use_rules(inner), RS.use_rules(rinner):
            assert PS.current_rules() is inner and tuple(PS.spec("batch")) == tuple(RS.spec("batch")) == ()
        with pytest.raises(RuntimeError), PS.use_rules(None):
            raise RuntimeError
        assert PS.current_rules() is outer
    assert PS.current_rules() is None
    x = torch.ones(2)
    assert PS.shard(x, "batch") is x
    cfg = _cfg("llama3.2-3b")
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg, 0)
    want = float(T.forward_train(params, cfg, batch))
    for rules in (None, PS.ShardingRules(enabled=False), PS.ShardingRules(fsdp="data")):
        assert float(S.make_prefill_step(cfg, rules)(params, batch)) == want
    with pytest.raises(TypeError, match="ShardingRules"):
        S.make_train_step(cfg, object())


def test_shard_and_gather_round_trip_and_count_each_element_once():
    """``shard_tree`` places each rank's block (replicated leaves copied
    to every rank, each copy its own storage), ``gather_tree`` inverts it,
    and ``unique_parts`` holds each element once."""
    mesh = _mesh()
    a = torch.arange(48.0).reshape(4, 12)
    for spec, n_unique in ((PS.P(), 1), (PS.P("data"), 2), (PS.P(None, "model"), 2), (PS.P("model", "data"), 4)):
        x = LM.shard_array(a, LM.NamedSharding(mesh, spec))
        assert torch.equal(LM.gather_array(x), a)
        assert sum(p.numel() for p in x.unique_parts()) == a.numel() and len(x.unique_parts()) == n_unique
        assert len({p.data_ptr() for p in x.parts}) == 4
    with pytest.raises(ValueError, match="does not split"):
        LM.shard_array(torch.zeros(3, 4), LM.NamedSharding(mesh, PS.P("data")))


# -- the train step against the reference's jitted sharded step ------------------------


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_make_train_step_on_the_mesh_matches_reference(ref, case):
    """``make_train_step(cfg, ShardingRules(mesh=2x2, ...), n_micro=2)``
    from the reference's params: the first batch's gradients (every rank's
    copy) and the clip's global norm, then each step's loss and params
    (every part) against the reference's jitted sharded step."""
    cfg, mesh, rules, steps = _case(case)
    f32 = cfg.dtype == torch.float32
    params = _sharded_params(ref, case, mesh, rules)
    step = S.make_train_step(cfg, rules, S.TrainStepConfig(n_micro=N_MICRO, lr=LR))
    if f32:
        _, grads = step.loss_and_grads(params, _batch(cfg, 0))
        check_grads(grads, ref.tree(f"{case}/grads"))
        np.testing.assert_allclose(float(global_norm(grads)), float(ref[f"{case}/gnorm"]), rtol=LOSS_RTOL)
        _clear(params)
    opt = step.optimizer.init(params)
    for i in range(steps):
        loss, params, opt = step(params, opt, _batch(cfg, i))
        want = float(ref[f"{case}/losses"][i])
        np.testing.assert_allclose(float(loss), want, rtol=LOSS_RTOL if f32 else BF16_LOSS_RTOL)
        check_params(params, ref.tree(f"{case}/params{i + 1}"), rtol=0.0 if f32 else BF16_PARAM_RTOL)
    assert int(opt.step) == steps and isinstance(opt.mu["embed"], LM.Sharded)


def test_reference_adamw_state_carries_into_shards(ref):
    """The reference's params and AdamW state after its first sharded step
    (moments sharded as the params, ZeRO over the data axis), carried into
    the port's shards by ``bridge.sharded_from_jax``: the port's second
    step from them matches the reference's second step (loss and every
    part of the params)."""
    case = "llama_zero3"
    cfg, mesh, rules, _ = _case(case)
    params = _sharded_params(ref, case, mesh, rules, "params1")
    o = ref.tree(f"{case}/opt1", numpy=True)
    specs = PS.param_shardings(o["mu"], rules)
    opt = sharded_from_jax(AdamWState(step=o["step"], mu=o["mu"], nu=o["nu"]), S.param_shardings_opt(None, specs),
                           mesh)
    assert int(opt.step) == 1 and isinstance(opt.nu["embed"], LM.Sharded) and "data" in opt.nu["embed"].axes()
    step = S.make_train_step(cfg, rules, S.TrainStepConfig(n_micro=N_MICRO, lr=LR))
    loss, params, opt = step(params, opt, _batch(cfg, 1))
    np.testing.assert_allclose(float(loss), float(ref[f"{case}/losses"][1]), rtol=LOSS_RTOL)
    check_params(params, ref.tree(f"{case}/params2"))
    assert int(opt.step) == 2


def test_zero3_regather_is_bit_identical_and_gathers_layer_by_layer(ref, monkeypatch):
    """With ``fsdp="data"``, ``zero3_regather`` on and off give the same
    losses and params bit for bit; the recorded forward gathers each
    layer's weights just before its attention when on, every layer's
    before the first when off."""
    cfg, mesh, rules, _ = _case("llama_zero3")
    runs = {}
    for z3 in (True, False):
        c = dataclasses.replace(cfg, zero3_regather=z3)
        params = _sharded_params(ref, "llama_zero3", mesh, rules)
        step = S.make_train_step(c, rules, S.TrainStepConfig(n_micro=N_MICRO, lr=LR))
        opt = step.optimizer.init(params)
        losses = [float(step(params, opt, _batch(c, i))[0]) for i in range(2)]
        runs[z3] = (losses, LM.gather_tree(params))
    assert runs[True][0] == runs[False][0]
    for a, b in zip(tree_leaves(runs[True][1]), tree_leaves(runs[False][1])):
        assert torch.equal(a, b)

    events = []
    gather, attention = LM.gather_axis, L.attention_train
    monkeypatch.setattr(LM, "gather_axis", lambda x, axis: events.append("gather") or gather(x, axis))
    monkeypatch.setattr(L, "attention_train", lambda *a, **k: events.append("attn") or attention(*a, **k))
    order = {}
    for z3 in (True, False):
        events.clear()
        c = dataclasses.replace(cfg, zero3_regather=z3)
        S.make_prefill_step(c, rules)(_sharded_params(ref, "llama_zero3", mesh, rules), _batch(c, 0))
        order[z3] = [k for k, _ in itertools.groupby(events)]
    assert order[True] == ["gather", "attn"] * cfg.n_layers
    assert order[False] == ["gather", "attn"]


def test_prefill_step_on_the_mesh_matches_reference(ref):
    """``make_prefill_step(rules=)`` on sharded params: the reference's
    prefill loss of the same params and batch."""
    cfg, mesh, rules, _ = _case("mamba_fsdp")
    arch = TRAIN_CASES["mamba_fsdp"][0]
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True), dtype=jnp.float32)
    batch = _batch(cfg, 1)
    want = jax.jit(RSTEPS.make_prefill_step(rcfg, RS.ShardingRules(enabled=False)))(
        _ref_tree(ref, "mamba_fsdp/params0"), {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    got = S.make_prefill_step(cfg, rules)(_sharded_params(ref, "mamba_fsdp", mesh, rules), batch)
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def _ref_tree(ref: Ref, prefix: str) -> dict:
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), ref.tree(prefix))


def test_compression_under_sharding_equals_the_unsharded(ref):
    """int8 and top-k compression of a sharded gradient tree, gathered,
    equal the same compression of the gathered tree bit for bit (scale and
    threshold over each whole leaf, each element once)."""
    cfg, mesh, rules, _ = _case("llama_zero3")
    _, grads = S.make_train_step(cfg, rules, S.TrainStepConfig(n_micro=N_MICRO)).loss_and_grads(
        _sharded_params(ref, "llama_zero3", mesh, rules), _batch(cfg, 0))
    whole = LM.gather_tree(grads)
    for method in ("int8", "topk"):
        got = LM.gather_tree(compress_tree(grads, method=method))
        want = compress_tree(whole, method=method)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b), method


# -- the all_to_all MoE ---------------------------------------------------------------


MOE_SPECS = {"router": {"w": PS.P()}, "ln": {"g": PS.P()}, "w_up": PS.P("model"), "w_down": PS.P("model"),
             "w_gate": PS.P("model")}


def _moe_run(ref: Ref, cf: float):
    """The port's ``_moe_block`` on a 2 x 2 mesh (each replica a batch row,
    its two ranks a half of the sequence each) from the reference's
    params and input; returns the output, the gathered parameter
    gradients and the input's gradient for the reference's cotangent."""
    cfg = _cfg("qwen3-moe-30b-a3b", d_model=16, n_experts=8, top_k=2, expert_d_ff=32, capacity_factor=cf,
               mlp_kind="swiglu")
    mesh = _mesh()
    params = LM.shard_tree(ref.tree(f"moe{cf}/params"), MOE_SPECS, mesh)
    for x in tree_leaves(params):
        for q in x.parts:
            q.requires_grad_(True)
    x = torch.from_numpy(ref[f"moe{cf}/x"]).requires_grad_(True)
    ys = []
    for i in range(mesh.dp):
        xi = x[i:i + 1]
        ys.append(T._moe_block_tp(PS.rank_trees(params, i, mesh.mp), cfg, [xi] * mesh.mp)[0])
    y = torch.cat(ys)
    torch.sum(y * torch.from_numpy(ref[f"moe{cf}/ct"])).backward()
    for leaf in tree_leaves(params):
        LM.sum_replicated_grads(leaf)
    grads = LM.gather_tree(T.map_leaves(params, lambda a: a.map(lambda q: q.grad)))
    return y.detach(), grads, x.grad


@pytest.mark.parametrize("cf", MOE_CAPACITIES)
def test_all_to_all_moe_block_matches_reference(ref, cf):
    """The train path's MoE on a 2 x 2 mesh (tokens over the model axis,
    copies exchanged with two ``all_to_all``s each way) against the
    reference's ``_moe_block`` under its mesh: output, every parameter's
    gradient and the input's; at capacity 8.0 (nothing dropped) also the
    dense oracle; at 1.25 the local capacities drop copies the dense
    result keeps, as the reference's do."""
    y, grads, gx = _moe_run(ref, cf)
    np.testing.assert_allclose(y.numpy(), ref[f"moe{cf}/y"], rtol=0, atol=MOE_TOL)
    dense_gap = float(np.abs(ref[f"moe{cf}/y"] - ref[f"moe{cf}/dense"]).max())
    if cf == 8.0:
        np.testing.assert_allclose(y.numpy(), ref[f"moe{cf}/dense"], rtol=0, atol=MOE_TOL)
    else:
        assert dense_gap > 1e-2  # copies dropped
    np.testing.assert_allclose(gx.numpy(), ref[f"moe{cf}/gx"], rtol=0, atol=MOE_TOL)
    want = _flat(ref.tree(f"moe{cf}/gparams"))
    for key, g in _flat(grads).items():
        np.testing.assert_allclose(g.numpy(), want[key].numpy(), rtol=0, atol=MOE_TOL, err_msg=key)


def test_moe_refuses_a_tensor_where_ranks_are_lists():
    s = X.MoESpec(16, 32, n_experts=8, top_k=2)
    with pytest.raises(TypeError, match="per-rank lists"):
        X.moe_apply({}, s, torch.zeros(1, 4, 16), axis_name="model")


# -- checkpoints onto shardings -------------------------------------------------------


def test_reference_mesh_checkpoint_restores_onto_1x4_bit_exact(ref):
    """A checkpoint the reference saved from its (2, 2) mesh, restored by
    the port onto a 1 x 4 mesh (``restore(shardings=)`` and the runner's
    ``resume_or_init(shardings=)``): every part its block of the
    reference's params bit for bit; saving the shards again writes the
    same files byte for byte."""
    want = ref.tree("ckpt/params")
    template = T.map_leaves(want, torch.zeros_like)  # the reference's leaf order, which the manifest keeps
    mesh = _mesh(1, 4)
    specs = PS.param_shardings(template, PS.ShardingRules(mesh=mesh, batch="data", fsdp="data"))
    shardings = _named(specs, mesh)
    mgr = CheckpointManager(ref.ckpt_dir)
    step, got = mgr.restore(template, shardings=shardings)
    assert step == 7
    runner = FaultTolerantRunner(lambda s, b: (torch.zeros(()), s), mgr)
    step2, got2 = runner.resume_or_init(template, shardings=shardings)
    for tree in (got, got2):
        wf = _flat(want)
        for key, leaf in _flat(tree).items():
            assert isinstance(leaf, LM.Sharded) and leaf.mesh.shape == (1, 4)
            for part, blk in _blocks(leaf, wf[key]):
                assert torch.equal(part, blk), key
    out = CheckpointManager(ref.ckpt_dir.parent / "port_ckpt")
    out.save(7, got)
    for f in sorted((ref.ckpt_dir / "step_00000007").iterdir()):
        assert (out.dir / "step_00000007" / f.name).read_bytes() == f.read_bytes(), f.name


def _named(specs, mesh):
    if isinstance(specs, dict):
        return {k: _named(v, mesh) for k, v in specs.items()}
    return LM.NamedSharding(mesh, specs)


def test_runner_retry_restores_shards_and_reshards_onto_other_meshes(tmp_path):
    """The fault-tolerant runner over a 2 x 2 mesh (mamba2-130m): a failure
    after the step-2 checkpoint restores the sharded state onto its mesh
    and the run ends as a fault-free one does, loss for loss and bit for
    bit; the checkpoint restored onto 1 x 4 and 4 x 1 meshes equals the
    gathered state of step 2 bit for bit."""
    cfg = _cfg("mamba2-130m")
    mesh = _mesh()
    rules = PS.ShardingRules(mesh=mesh, batch="data", fsdp="data")
    params0 = T.init_params(cfg, seed=0, device="cpu")
    specs = PS.param_shardings(params0, rules)
    step = S.make_train_step(cfg, rules, S.TrainStepConfig(n_micro=1, lr=LR))

    def init():
        params = LM.shard_tree(T.map_leaves(params0, torch.clone), specs, mesh)
        return params, step.optimizer.init(params)

    def train(state, batch):
        loss, params, opt = step(*state, batch)
        if int(opt.step) == 3:  # the state after step 2 (the step count counts from 1)
            snapshots["step2"] = LM.gather_tree((params, opt))
        return loss, (params, opt)

    runs = {}
    for fail in (False, True):
        snapshots, losses, failed = {}, [], []

        def injector(s, fail=fail, failed=failed):
            if fail and s == 3 and not failed:
                failed.append(s)
                raise RuntimeError("injected")

        def batches(s):
            return _batch(cfg, s)

        mgr = CheckpointManager(tmp_path / f"ckpt_{fail}", keep=5)
        runner = FaultTolerantRunner(lambda st, b: (lambda out: losses.append(float(out[0])) or out)(train(st, b)),
                                     mgr, RunnerConfig(ckpt_every=2))
        state, stats = runner.run(init(), batches, 5, failure_injector=injector)
        assert stats.restarts == int(fail)
        assert isinstance(state[0]["embed"], LM.Sharded) and state[0]["embed"].mesh is mesh
        runs[fail] = (losses, LM.gather_tree(state), mgr, snapshots)
    assert runs[True][0] == runs[False][0]
    for a, b in zip(tree_leaves(runs[True][1]), tree_leaves(runs[False][1])):
        assert torch.equal(a, b)
    mgr = runs[True][2]
    assert mgr.all_steps() == [0, 2, 4]
    template = init()
    for dp, mp in ((1, 4), (4, 1)):
        other = _mesh(dp, mp)
        ospecs = PS.param_shardings(params0, PS.ShardingRules(mesh=other, batch="data", fsdp="data"))
        named = _named(ospecs, other)
        shardings = (named, AdamWState(step=None, mu=named, nu=named))
        step_no, restored = mgr.restore(template, step=2, shardings=shardings)
        assert step_no == 2 and restored[0]["embed"].mesh.shape == (dp, mp)
        for a, b in zip(tree_leaves(LM.gather_tree(restored)), tree_leaves(runs[False][3]["step2"])):
            assert torch.equal(a, b)


# -- planted faults the checks must reject ----------------------------------------------


def test_a_skipped_data_axis_gradient_sum_is_caught(ref, monkeypatch):
    """Replica 1 keeps its own gradients (skips the data-axis sum): the
    gradient check over every copy rejects it."""
    cfg, mesh, rules, _ = _case("llama_none")
    inner = LM.sum_replicated_grads

    def skipping(x):
        if "data" in x.axes():
            return inner(x)
        keep = {k: x.parts[k].grad.clone() for k in range(mesh.mp, 2 * mesh.mp)}
        inner(x)
        for k, g in keep.items():
            x.parts[k].grad.copy_(g)

    monkeypatch.setattr(LM, "sum_replicated_grads", skipping)
    _, grads = S.make_train_step(cfg, rules, S.TrainStepConfig(n_micro=N_MICRO)).loss_and_grads(
        _sharded_params(ref, "llama_none", mesh, rules), _batch(cfg, 0))
    with pytest.raises(AssertionError, match="relative L2"):
        check_grads(grads, ref.tree("llama_none/grads"))


def test_a_replicated_leaf_counted_twice_in_the_clip_norm_is_caught(ref, monkeypatch):
    """The clip's global norm over every copy of a replicated leaf (not one
    part a block): the norm check rejects it."""
    cfg, mesh, rules, _ = _case("llama_zero3")
    _, grads = S.make_train_step(cfg, rules, S.TrainStepConfig(n_micro=N_MICRO)).loss_and_grads(
        _sharded_params(ref, "llama_zero3", mesh, rules), _batch(cfg, 0))
    monkeypatch.setattr(LM.Sharded, "unique_parts", lambda self: list(self.parts))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(float(global_norm(grads)), float(ref["llama_zero3/gnorm"]), rtol=LOSS_RTOL)


def test_a_skipped_return_all_to_all_is_caught(ref, monkeypatch):
    """The MoE's second exchange skipped (each rank keeps the expert
    outputs it computed for others' copies): the output check rejects it."""
    calls = []
    inner = X.all_to_all

    def skipping(parts):
        calls.append(1)
        return list(parts) if len(calls) % 3 == 0 else inner(parts)

    monkeypatch.setattr(X, "all_to_all", skipping)
    y, _, _ = _moe_run(ref, 8.0)
    assert len(calls) == 6
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(y.numpy(), ref["moe8.0/y"], rtol=0, atol=MOE_TOL)


# -- refusals -------------------------------------------------------------------------


def test_mesh_train_refuses_encdec_hybrid_and_undivided_heads():
    """Under mesh rules the encdec and hybrid families are refused with
    their ROADMAP.md item; a head count that does not divide by ``mp``
    raises; sharded params without rules raise."""
    mesh = _mesh()
    rules = PS.ShardingRules(mesh=mesh, batch="data")
    for arch in ("whisper-tiny", "zamba2-1.2b"):
        cfg = _cfg(arch)
        params = T.init_params(cfg, seed=0, device="cpu")
        sp = LM.shard_tree(params, PS.param_shardings(params, rules), mesh)
        with pytest.raises(NotImplementedError, match="ROADMAP.md, port queue 1, item 2"), PS.use_rules(rules):
            T.forward_train(sp, cfg, _batch(cfg, 0))
    cfg = _cfg("llama3.2-3b", n_heads=2, kv_heads=1, head_dim=32)
    params = T.init_params(cfg, seed=0, device="cpu")
    mesh4 = _mesh(1, 4)
    rules4 = PS.ShardingRules(mesh=mesh4, batch="data")
    sp = LM.shard_tree(params, PS.param_shardings(params, rules4), mesh4)
    with pytest.raises(ValueError, match="n_heads"), PS.use_rules(rules4):
        T.forward_train(sp, cfg, _batch(cfg, 0))
    with pytest.raises(TypeError, match="use_rules"):
        T.forward_train(sp, cfg, _batch(cfg, 0))


# -- the bf16 tensor-parallel decode rows (the mp 2 watch) ------------------------------


def _bf16_tp_rows(mp: int, packed: bool) -> tuple[np.ndarray, np.ndarray]:
    """Three chunked steps of llama3.2-3b smoke at bfloat16 on ``mp`` ranks
    (``mp = 1``: the single-rank path), the reference's shards (w4a4
    packed words and head, or float slices) on both sides: the
    reference's step under ``jax.vmap`` with the model axis named, and the
    port's ``forward_decode_paged_tp``, both summing the ranks' shares in
    rank order.  Returns both sides' live rows."""
    rcfg, cfg = ref_get_config("llama3.2-3b", smoke=True), get_config("llama3.2-3b", smoke=True)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    if packed:
        rshards = RA._packed_shards(rp, rcfg, mp, w_bits=4, a_bits=4)
        emb = rp["embed"]
        vs = emb.shape[0] // mp
        rheads = RS.stack_decode_shards([ref_prepack_lm_head(emb[r * vs:(r + 1) * vs], w_bits=4, a_bits=4,
                                                             t_max=ref_weight_tanh_max(emb)) for r in range(mp)])
    else:
        rshards = RS.stack_decode_shards([RS.slice_decode_params(rp, rcfg, mp, r) for r in range(mp)])
        rheads = None
    np_tree = jax.tree.map(np.asarray, (rshards, rheads))
    shards = [T.unstack_layers(sh, cfg.n_layers) for sh in shards_from_jax(np_tree[0], mp)]
    heads = None if rheads is None else shards_from_jax(np_tree[1], mp)
    lcfg, rlcfg = dataclasses.replace(cfg, tp_shards=mp), dataclasses.replace(rcfg, tp_shards=mp)
    rstate = jax.tree.map(lambda a: jnp.stack([a] * mp), RT.init_paged_state(rlcfg, 4, 9, 8))
    states = [T.init_paged_state(lcfg, 4, 9, 8, device="cpu") for _ in range(mp)]
    table = np.array([[0, 0, 0, 0], [3, 7, 1, 5], [2, 6, 0, 0], [4, 8, 0, 0]], np.int32)
    lens = np.array([0, 1, 3, 4], np.int32)
    pos = np.array([0, 9, 6, 5], np.int32)

    def one(p, h, st, tokens, pos):
        return RT.forward_decode_paged(p, rlcfg, st, jnp.asarray(table), tokens, pos, head=h, lens=jnp.asarray(lens),
                                       axis_name="model" if mp > 1 else None)

    ref_step = jax.jit(jax.vmap(one, in_axes=(0, None if heads is None else 0, 0, None, None), axis_name="model"))
    rng = np.random.default_rng(3)
    live = lens > 0
    theirs, ours = [], []
    for step in range(3):
        tokens = rng.integers(1, cfg.vocab, (4, 4)).astype(np.int32)
        p = pos + step * lens
        rlogits, rstate = ref_step(rshards, rheads, rstate, jnp.asarray(tokens), jnp.asarray(p))
        logits, _ = T.forward_decode_paged_tp(shards, lcfg, states, torch.from_numpy(table),
                                              torch.from_numpy(tokens), torch.from_numpy(p), heads=heads,
                                              lens=torch.from_numpy(lens))
        theirs.append(np.asarray(rlogits[0], np.float64)[live])
        ours.append(logits.double().numpy()[live])
    return np.concatenate(theirs), np.concatenate(ours)


def _row_rel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)


@pytest.mark.parametrize("packed", [True, False], ids=["w4a4", "float"])
def test_bf16_w4a4_tp_decode_rows_match_the_reference_tp_step(packed):
    """The port's bf16 tensor-parallel rows (mp 2) against the reference's
    bf16 tp step, where both sum the ranks' shares in the same order: every
    live row within ``BF16_TP_ROW_REL`` relative L2, the bound the port's
    single-rank rows meet against the reference's single-rank ones (bf16
    rounding placed differently by XLA and PyTorch, moved across 4-bit
    activation boundaries at w4a4).  The reference's own mp 2 rows part
    from its mp 1 rows too, by as much as the port's do: a card's mp 2
    parting from the single engine is that arithmetic, not the port."""
    tol = BF16_TP_ROW_REL[packed]
    r1, p1 = _bf16_tp_rows(1, packed)
    r2, p2 = _bf16_tp_rows(2, packed)
    got = {"port mp2 vs ref mp2": _row_rel(p2, r2), "port mp1 vs ref mp1": _row_rel(p1, r1),
           "ref mp2 vs ref mp1": _row_rel(r2, r1), "port mp2 vs port mp1": _row_rel(p2, p1)}
    print({k: [round(float(v), 4) for v in rows] for k, rows in got.items()})
    assert got["port mp2 vs ref mp2"].max() <= tol and got["port mp1 vs ref mp1"].max() <= tol, got
    assert got["ref mp2 vs ref mp1"].max() > tol / 10, got  # the reference parts from itself
    assert got["port mp2 vs port mp1"].max() <= tol, got
