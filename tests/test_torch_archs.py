"""The six decoder-only archs the port gained last (gemma-2b,
granite-3-8b, yi-34b, chameleon-34b, kimi-k2-1t-a32b,
llama4-maverick-400b-a17b) against the JAX package's, on the CPU.

What they add to the families the port already had: tied embeddings
and the sqrt(d_model) embedding scale (gemma), an odd vocabulary padded
to a multiple of tp (granite), q heads padded to a multiple of tp (yi,
llama4), MQA (gemma), qk-norm and the vlm family (chameleon), and MoE
at 8 experts top-2 and top-1 (kimi, llama4, at smoke width).

In process: every registered arch's ``CONFIG`` and ``SMOKE`` equal the
JAX package's on every field the port has; the port's parameter defs
(paths, shapes, dims, inits, storage specs) equal the JAX bundle's for
the six smoke configs at (2, 2, 1) and (2, 2, 2); a ``mode_overrides``
rule naming gemma's absent ``head`` fails in both packages;
``cache_bytes_per_chip`` and two ``MemoryPlanner``s (a synthetic peak,
as ``tests/test_torch_cache.py`` gives them) equal the reference's with
``==`` on the tied and the qk-norm configs; ``convert`` carries a tied
tree and the qk-norm leaves; the paged engine's greedy tokens (and
captured logits, 1e-3) of the dense and vlm smoke configs equal the JAX
engine's in fp32, the JAX side picking by a plain argmax
(``tests/test_torch_serve.py``'s note); kimi's and llama4's contiguous
prefill and two greedy decode steps give the JAX steps' logits within
``tests/test_torch_jamba.py``'s fp32 5e-3; the flash kernel's plain
version at head dims 112 and 256 (GQA 8, MQA) equals the Pallas kernel
in interpret mode (kv expanded on the JAX side), and the wrapper sends
both head dims to the mma.sync kernel; both launchers take the new
``--arch`` values.

Train: one fcdp step of each smoke config at (pod 2, data 2, model 1)
and (2, 2, 2) in fp32, from the same weights (drawn by the port's
initializer from seed 0 at the mesh's tp), held to the JAX step at
``tests/test_system.py:84-89``'s tolerances (loss rtol 1e-4, grad norm
1e-3, updated parameters rtol 2e-2 / atol 2e-3; aux 1e-4), and every
(op, axis) byte count equal to the JAX trace; gemma's tied table also
under zero3, at prefetch depth 1 and at microbatch 2 under the async
'pod' reduce (the table is gathered twice a step, at both ends, and
reduced twice); yi-smoke at (2, 1, 4), its 6 heads padded to 8; the
losses of gemma and kimi fall over 4 steps at (2, 2, 2). The JAX steps
run in subprocesses with XLA's excess precision off, while the port's
ranks run (gloo, one spawn a mesh, every arch's model in turn through
``ModeRun.model``), once per session (``shared_result``).
"""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (OptimizerConfig, RunConfig, ShapeCell,
                                      SystemConfig)
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_smoke_config)
from repro_torch.core.partition import init_params, tree_items
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.train import ModeRun, TrainJob, spawn
from repro_torch.models.lm import LM
from test_torch_train import assemble, shared_result

SHORT = {"gemma-2b": "gemma", "granite-3-8b": "granite", "yi-34b": "yi",
         "chameleon-34b": "chameleon", "kimi-k2-1t-a32b": "kimi",
         "llama4-maverick-400b-a17b": "llama4"}
NEW = tuple(SHORT)
ARCH = {v: k for k, v in SHORT.items()}
PAGED = ("gemma", "granite", "yi", "chameleon")     # dense and vlm
MOE = ("kimi", "llama4")
SEQ, BATCH, VOCAB = 64, 8, 512
AXES = ("pod", "data", "model")
MESHES = {1: (2, 2, 1), 2: (2, 2, 2), 4: (2, 1, 4)}
F32 = "float32"
OPT = dict(total_steps=8, warmup_steps=2, lr=1e-3)
FALL_STEPS = 4
FALLING = ("gemma", "kimi")
LOSS_RTOL, GNORM_RTOL, AUX_RTOL = 1e-4, 1e-3, 1e-4
PARAM_TOL = dict(rtol=2e-2, atol=2e-3)

# run id -> (arch short name, tp, ModeRun knobs); every run one fcdp step
# unless it says otherwise
RUNS = {f"{s}_fcdp_tp{tp}": (s, tp, dict(
            mode="fcdp", steps=FALL_STEPS if tp == 2 and s in FALLING
            else 1)) for tp in (1, 2) for s in SHORT.values()}
RUNS.update({
    "gemma_zero3_tp2": ("gemma", 2, dict(mode="zero3")),
    "gemma_prefetch1_tp2": ("gemma", 2, dict(mode="fcdp", prefetch_depth=1)),
    "gemma_async_tp2": ("gemma", 2, dict(mode="fcdp", microbatch=2,
                                         async_grad_reduce=True)),
    "yi_fcdp_tp4": ("yi", 4, dict(mode="fcdp")),
})
RUN_IDS = list(RUNS)
# the JAX runs, one subprocess a group, side by side
JAX_GROUPS = (
    ("gemma_fcdp_tp1", "granite_fcdp_tp1", "yi_fcdp_tp1"),
    ("chameleon_fcdp_tp1", "kimi_fcdp_tp1", "llama4_fcdp_tp1"),
    ("gemma_fcdp_tp2", "gemma_zero3_tp2", "gemma_prefetch1_tp2",
     "gemma_async_tp2"),
    ("granite_fcdp_tp2", "yi_fcdp_tp2", "chameleon_fcdp_tp2"),
    ("kimi_fcdp_tp2", "llama4_fcdp_tp2", "yi_fcdp_tp4"),
)
assert sorted(sum(JAX_GROUPS, ())) == sorted(RUNS)


def smoke(short):
    return get_smoke_config(ARCH[short])


def make_batch(seed=0):
    """ids and labels in [1, 512): valid in every smoke vocabulary."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(1, VOCAB, (BATCH, SEQ)).astype(np.int32)
    return {"ids": ids, "labels": labels, "mask": np.ones_like(labels, bool)}


def _nest(flat):
    out: dict = {}
    for path, t in flat:
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def init_tree(short, tp):
    """The smoke config's full parameters at tp (its vocabulary and q
    heads padded to a multiple of tp) as a nested dict of fp32 numpy
    arrays, drawn by the port's initializer from seed 0, as the port's
    ranks draw them."""
    defs = LM(smoke(short), SystemConfig(), tp).defs
    flat = init_params(defs, 0, torch.device("cpu"), torch.float32)
    return _nest((p, t.numpy()) for p, t in tree_items(flat))


# -- in process: configs, defs, overrides, accounting -----------------------

def _assert_fields_equal(port, ref, where):
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):
            _assert_fields_equal(got, want, f"{where}.{f.name}")
        else:
            assert got == want, (where, f.name, got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_jax(arch):
    """Both configs of every registered arch, field for field (the
    fields the port has), in the JAX package's registry order."""
    from repro.configs import registry as jreg
    _assert_fields_equal(get_config(arch), jreg.get_config(arch), arch)
    _assert_fields_equal(get_smoke_config(arch), jreg.get_smoke_config(arch),
                         f"{arch} smoke")
    assert ARCH_IDS == jreg.ARCH_IDS


def _jax_system(**kw):
    from repro.configs.base import SystemConfig as JSystemConfig
    dtype = kw.pop("dtype", "bfloat16")
    return JSystemConfig(min_shard_size=8, quant_impl="jnp", fused_impl="jnp",
                         param_dtype=dtype, compute_dtype=dtype, **kw)


def _jax_bundle(short, sizes, kind="train", microbatch=0, seq=SEQ,
                batch=BATCH, **kw):
    import jax
    from repro.configs.base import OptimizerConfig as JOptimizerConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import ShapeCell as JShapeCell
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.core.engine import StepBundle as JStepBundle
    from repro.launch.mesh import make_mesh
    run = JRunConfig(model=j_smoke(ARCH[short]),
                     shape=JShapeCell("t", kind, seq, batch),
                     system=_jax_system(**kw),
                     optimizer=JOptimizerConfig(**OPT), microbatch=microbatch)
    n = int(np.prod(sizes))
    return JStepBundle(run, make_mesh(sizes, AXES, devices=jax.devices()[:n]))


def _port_bundle(short, sizes, kind="train", microbatch=0, seq=SEQ,
                 batch=BATCH, **kw):
    from repro_torch.core.engine import StepBundle
    run = RunConfig(model=smoke(short),
                    shape=ShapeCell("t", kind, seq, batch),
                    system=SystemConfig(min_shard_size=8, **kw),
                    optimizer=OptimizerConfig(**OPT), microbatch=microbatch)
    return StepBundle(run, device="cpu",
                      mesh=None if sizes is None else MeshShape(AXES, sizes))


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("short", list(SHORT.values()))
def test_defs_equal_jax(short, tp):
    """Leaf for leaf at (2, 2, tp): the paths in treedef order, shapes
    (the vocabulary and the q heads padded alike), dims, inits and
    storage specs. gemma has no ``head``; chameleon's attention has
    ``q_norm`` / ``k_norm`` of [hd]."""
    jb = _jax_bundle(short, MESHES[tp])
    pb = _port_bundle(short, MESHES[tp])
    assert pb.paths == [d.label for d in jb.def_leaves]
    assert [(d.shape, d.dims, d.init, d.init_scale) for d in pb.def_leaves] \
        == [(d.shape, d.dims, d.init, d.init_scale) for d in jb.def_leaves]
    assert pb.leaf_specs == [tuple(s) for s in jb.leaf_specs]
    assert ("head" in pb.paths) == (short != "gemma")
    norms = [p for p in pb.paths if p.endswith(("q_norm", "k_norm"))]
    assert norms == (["blocks.pos0.attn.k_norm", "blocks.pos0.attn.q_norm"]
                     if short == "chameleon" else [])


def test_override_naming_the_tied_head_fails_as_in_jax():
    """A ``mode_overrides`` rule for ``head`` matches no leaf of a tied
    model: both packages refuse it where the bundle resolves the
    strategies; ``embed`` is matched."""
    with pytest.raises(ValueError, match="matched zero parameters") as port:
        _port_bundle("gemma", MESHES[2], mode_overrides=(("head", "zero3"),))
    with pytest.raises(ValueError, match="matched zero parameters") as ref:
        _jax_bundle("gemma", MESHES[2], mode_overrides=(("head", "zero3"),))
    head = "mode_overrides rule 'head'='zero3' matched zero parameters"
    assert str(port.value).startswith(head)
    assert str(ref.value).startswith(head)
    pb = _port_bundle("gemma", MESHES[2], mode_overrides=(("embed", "zero3"),))
    assert pb.def_leaves[pb.paths.index("embed")].strategy == "zero3"


ACCOUNTING = {"fcdp": dict(mode="fcdp"), "zero3": dict(mode="zero3"),
              "fcdp_d1": dict(mode="fcdp", prefetch_depth=1),
              "fcdp_async": dict(mode="fcdp", microbatch=2,
                                 async_grad_reduce=True),
              "fcdp_q8": dict(mode="fcdp", param_compress="int8_pod",
                              grad_compress="int8_pod")}


@pytest.mark.parametrize("cid", list(ACCOUNTING))
@pytest.mark.parametrize("short", ["gemma", "chameleon"])
def test_cache_accounting_equals_jax(short, cid):
    """``cache_bytes_per_chip`` (every key, ``by_group`` included) and
    ``stage1_dcn_gather_bytes`` of the tied and the qk-norm configs at
    (2, 2, 2) equal the JAX package's."""
    from repro.core import cache as jc
    from repro_torch.core import cache as pc
    kw = dict(ACCOUNTING[cid])
    mb = kw.pop("microbatch", 0)
    jb = _jax_bundle(short, MESHES[2], microbatch=mb, **kw)
    pb = _port_bundle(short, MESHES[2], microbatch=mb, **kw)
    assert pc.cache_bytes_per_chip(pb) == jc.cache_bytes_per_chip(jb)
    assert pc.stage1_dcn_gather_bytes(pb) == jc.stage1_dcn_gather_bytes(jb)


def _planner(pkg, fit, **kw):
    """``pkg``'s MemoryPlanner whose peak is synthetic: a configuration
    in ``fit`` ((fraction, depth)) peaks at 0, the rest above any budget
    but block_io's half."""
    import importlib
    base = importlib.import_module(f"{pkg}.core.cache").MemoryPlanner
    if pkg == "repro_torch":
        kw["device"] = "cpu"

    class Synthetic(base):
        def _peak(self, bundle):
            s = bundle.run.system
            if (s.device_cache_fraction, s.prefetch_depth) in fit:
                return 0
            peak = 1000 + int(100 * s.device_cache_fraction) \
                + 10 * s.prefetch_depth
            return peak // 2 if s.activation_policy == "block_io" else peak
    return Synthetic(**kw)


@pytest.mark.parametrize("case", ["walk", "impossible"])
@pytest.mark.parametrize("short", ["gemma", "chameleon"])
def test_planner_equals_jax(short, case, mesh3):
    """Both planners walk the same attempts (every key of every
    iteration) and return the same plan for the tied and the qk-norm
    configs."""
    import importlib
    fit = {(0.0, 0)} if case == "walk" else set()
    budget = 500 if case == "walk" else 1
    plans = {}
    for pkg, mesh in (("repro", mesh3), ("repro_torch",
                                         MeshShape(AXES, MESHES[2]))):
        base = importlib.import_module(f"{pkg}.configs.base")
        reg = importlib.import_module(f"{pkg}.configs.registry")
        sysc = (_jax_system(mode="fcdp", prefetch_depth=2) if pkg == "repro"
                else SystemConfig(min_shard_size=8, mode="fcdp",
                                  prefetch_depth=2))
        run = base.RunConfig(model=reg.get_smoke_config(ARCH[short]),
                             shape=base.ShapeCell("t", "train", SEQ, BATCH),
                             system=sysc,
                             optimizer=base.OptimizerConfig(**OPT))
        planner = _planner(pkg, fit, hbm_budget=budget)
        plans[pkg] = dataclasses.asdict(planner.plan(run, mesh, (1.0, 0.0)))
    assert plans["repro_torch"] == plans["repro"]
    if case == "impossible":
        assert not plans["repro_torch"]["fits"]


# -- conversion ---------------------------------------------------------------

@pytest.mark.parametrize("short", ["gemma", "chameleon"])
def test_params_from_jax_carries_tied_and_qk_norm_trees(short):
    """The JAX bundle's whole tree (no ``head`` under tied embeddings;
    the qk-norm leaves) into the port's parameter dict, bit for bit in
    bf16, and a tree with a leaf too many or too few refused."""
    import jax
    from repro_torch.convert import params_from_jax
    jb = _jax_bundle(short, (1, 1, 1), kind="decode")
    leaves = jb.init_all_params(seed=0)
    tree = jax.tree.unflatten(jb.treedef, [np.asarray(x) for x in leaves])
    params = params_from_jax(tree, smoke(short), device="cpu")
    got = dict(tree_items(params))
    assert list(got) == [d.label for d in jb.def_leaves]
    for (path, t), leaf in zip(got.items(), leaves):
        a = np.asarray(leaf)
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16), path)
    if short == "gemma":
        extra = dict(tree, head=np.zeros((64, VOCAB), np.float32))
        with pytest.raises(ValueError, match="extra \\['head'\\]"):
            params_from_jax(extra, smoke(short), device="cpu")
    else:
        attn = {k: v for k, v in tree["blocks"]["pos0"]["attn"].items()
                if k != "q_norm"}
        bad = dict(tree, blocks={"pos0": dict(tree["blocks"]["pos0"],
                                              attn=attn)})
        with pytest.raises(ValueError, match="missing"):
            params_from_jax(bad, smoke(short), device="cpu")


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("short", ["gemma", "chameleon"])
def test_shards_from_jax_carries_tied_and_qk_norm_trees(short, tp):
    """``convert.shards_from_jax`` cuts the tree into every rank's shards
    at (2, 2, tp); put back together they are the tree, bit for bit."""
    from types import SimpleNamespace

    from repro_torch.convert import shards_from_jax
    from repro_torch.core.engine import StepBundle
    tree = init_tree(short, tp)
    ms = MeshShape(AXES, MESHES[tp])
    run = RunConfig(model=smoke(short),
                    shape=ShapeCell("t", "train", SEQ, BATCH),
                    system=SystemConfig(min_shard_size=8, dtype=F32))
    shards = {}
    for rank in range(ms.world):
        b = StepBundle(run, device="cpu", mesh=SimpleNamespace(
            mesh_shape=ms, coords=ms.coords(rank)))
        shards[rank] = dict(tree_items(shards_from_jax(tree, b)))
    want = dict(tree_items(tree))
    assert set(b.paths) == set(want)
    for path, spec in zip(b.paths, b.leaf_specs):
        full = assemble({r: sh[path].detach() for r, sh in shards.items()},
                        spec, ms)
        np.testing.assert_array_equal(full.numpy(), want[path], path)


# -- the flash kernel's plain version at the new head dims --------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hk,hd", [(16, 2, 112), (8, 1, 256)],
                         ids=["kimi_gqa8_hd112", "gemma_mqa_hd256"])
def test_plain_matches_pallas_flash_at_new_head_dims(H, Hk, hd, causal):
    """``ref.attention_plain`` reads the kv heads by index; the Pallas
    kernel (interpret mode) takes them expanded. fp32, atol = rtol =
    2e-5 (``tests/test_kernels.py``'s fp32 tolerance)."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro_torch.kernels import ref
    rng = np.random.default_rng(hd)
    B, S = 2, 96
    q = rng.normal(0, 1, (B, S, H, hd)).astype(np.float32)
    k, v = (rng.normal(0, 1, (B, S, Hk, hd)).astype(np.float32)
            for _ in range(2))
    rep = H // Hk
    want = jops.flash_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=2)),
        jnp.asarray(np.repeat(v, rep, axis=2)), causal=causal,
        impl="pallas_interpret", block_q=32, block_k=32)
    got = ref.attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), None, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("Sq", [1, 128])
@pytest.mark.parametrize("H,Hk,hd", [(64, 8, 112), (8, 1, 256)])
def test_wrapper_sends_new_head_dims_to_mma(H, Hk, hd, Sq, monkeypatch):
    """hd 112 and 256 launch the mma.sync kernel at prefill and at
    decode (the split-KV decode takes hd 64 and 128 only), with hd
    among its arguments."""
    from test_torch_kernels import _FakeCuda4

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    calls = []
    monkeypatch.setattr(fa, "_kernels", lambda: {
        kind: (lambda *a, kind=kind: calls.append((kind, a)) or 0)
        for kind in ("tma", "mma", "split")})
    monkeypatch.setattr(fa, "_new_output", lambda q: torch.empty(0))
    monkeypatch.setattr(_build, "launch", lambda device, fn, *a: fn(*a, 0))
    B, Skv = 8, 544
    kv = _FakeCuda4(B, Skv, Hk, hd)
    fa.flash_attention_fwd(_FakeCuda4(B, Sq, H, hd), kv, kv,
                           _FakeCuda4(B, dtype=torch.int32), True)
    (kind, args), = calls
    assert kind == fa.variant(Sq, H, Hk, hd) == "mma"
    assert args[5:11] == (B, Sq, Skv, H, Hk, hd)
    assert hd in fa.HEAD_DIMS and hd not in fa.SPLIT_HEAD_DIMS


# -- serving ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _served(short):
    """The JAX engine and the port's engine on ``mixed_requests`` (8
    requests of up to 64 tokens, 4 generated, batch 4, chunks of 16),
    fp32, from the JAX bundle's weights."""
    import jax
    import jax.numpy as jnp
    from repro.core.engine.serve import default_paged_kv as j_default_kv
    from repro.core.serve_schedule import PagedServeEngine as JEngine
    from repro.launch.serve import mixed_requests as j_mixed
    from repro_torch.convert import params_from_jax
    from repro_torch.core.engine.serve import default_paged_kv
    from repro_torch.core.serve_schedule import PagedServeEngine
    from repro_torch.launch.serve import mixed_requests
    jb = _jax_bundle(short, (1, 1, 1), kind="decode", batch=4, dtype=F32)
    pb = _port_bundle(short, None, kind="decode", batch=4, dtype=F32)
    leaves = jb.init_all_params(seed=0)
    tree = jax.tree.unflatten(jb.treedef, [np.asarray(x) for x in leaves])
    params = params_from_jax(tree, pb.run.model, dtype=torch.float32,
                             device="cpu")
    vocab = pb.run.model.vocab_size
    je = JEngine(jb, j_default_kv(jb, jb.run.shape), chunk=16,
                 capture_logits=True)
    # the JAX greedy pick fails on a mesh whose 'model' axis has size 1
    # (ROADMAP Queue 3): the plain argmax it computes at tp 1
    je._pick = jax.jit(lambda lg: jnp.argmax(lg, axis=-1).astype(jnp.int32))
    jres, _ = je.serve(leaves, j_mixed(8, SEQ, 4, vocab, seed=0))
    pe = PagedServeEngine(pb, default_paged_kv(pb, pb.run.shape), chunk=16,
                          capture_logits=True)
    pres, _ = pe.serve(params, mixed_requests(8, SEQ, 4, vocab, seed=0))
    return je, jres, pe, pres


@pytest.mark.parametrize("short", PAGED)
def test_paged_engine_tokens_equal_jax(short):
    """The same schedule, the same greedy tokens for every request, and
    every captured logit row within 1e-3 (``tests/test_torch_serve.py``'s
    fp32 tolerance); the pages all return to the free list."""
    je, jres, pe, pres = _served(short)
    assert pe.steps == je.steps and pe.decode_calls > 0
    want = {r.rid: r.tokens for r in jres}
    got = {r.rid: r.tokens for r in pres}
    assert got == want and all(len(t) == 4 for t in got.values())
    for rid in want:
        assert len(pe.captured[rid]) == len(je.captured[rid])
        for a, b in zip(pe.captured[rid], je.captured[rid]):
            np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                       rtol=1e-3, atol=1e-3)
    assert all(a.n_free == pe.kv.pages_per_replica - 1 for a in pe.allocs)


@pytest.mark.parametrize("short", MOE)
def test_moe_archs_are_gated_off_the_paged_path(short):
    from repro.core.engine.serve import check_paged_plan as j_check
    from repro_torch.core.engine.serve import check_paged_plan
    for check, model in ((check_paged_plan, LM(smoke(short), SystemConfig())),
                         (j_check, _jax_bundle(short, (1, 1, 1),
                                               kind="decode").model)):
        with pytest.raises(ValueError, match="moe"):
            check(model)


@pytest.mark.parametrize("short", MOE)
def test_moe_contiguous_steps_match_jax(short):
    """A 64-token prompt and two greedy decode steps through both
    packages' contiguous steps (``make_prefill_step`` /
    ``make_decode_step``) from the same weights, fp32: the logits of
    every step within 5e-3 (``tests/test_torch_jamba.py``'s fp32
    tolerance), the greedy tokens equal."""
    import jax
    import jax.numpy as jnp
    from repro_torch.convert import params_from_jax
    B = 2
    jb = _jax_bundle(short, (1, 1, 1), kind="decode", seq=SEQ + 8, batch=B,
                     dtype=F32)
    pb = _port_bundle(short, None, kind="decode", seq=SEQ + 8, batch=B,
                      dtype=F32)
    leaves = jb.init_all_params(seed=0)
    tree = jax.tree.unflatten(jb.treedef, [np.asarray(x) for x in leaves])
    params = params_from_jax(tree, pb.run.model, dtype=torch.float32,
                             device="cpu")
    ids = np.random.default_rng(1).integers(1, VOCAB, (B, SEQ)
                                            ).astype(np.int32)
    jl, jst = jb.make_prefill_step()(leaves, jnp.asarray(ids),
                                     jb.init_state(jb.run.shape))
    tl, st = pb.make_prefill_step()(params, torch.from_numpy(ids),
                                    pb.init_state())
    jdec, dec = jb.make_decode_step(), pb.make_decode_step()
    for step in range(3):
        want = np.asarray(jl, np.float32)
        assert tl.shape == want.shape == (B, VOCAB)
        np.testing.assert_allclose(tl.numpy(), want, rtol=0, atol=5e-3,
                                   err_msg=f"{short} step {step}")
        tok = want.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        if step < 2:
            jl, jst = jdec(leaves, jnp.asarray(tok)[:, None], jst)
            tl, st = dec(params, torch.from_numpy(tok)[:, None], st)
    assert int(st["pos0"]["attn"]["idx"][0]) == SEQ + 2


# -- the launchers ------------------------------------------------------------

@pytest.mark.parametrize("short", PAGED)
def test_serve_launcher_takes_the_arch(short):
    from repro_torch.launch import serve as launcher
    summary, results = launcher.main(
        ["--arch", ARCH[short], "--smoke", "--requests", "3", "--seq-len",
         "32", "--gen-len", "2", "--batch", "2", "--chunk", "16",
         "--device", "cpu"])
    assert summary["requests"] == len(results) == 3


@pytest.mark.parametrize("short", ["gemma", "kimi"])
def test_train_launcher_takes_the_arch(monkeypatch, tmp_path, short):
    """``python -m repro_torch.launch.train --arch <arch> --smoke --device
    cpu`` takes a step on one rank (torchrun's environment)."""
    import socket

    from repro_torch.launch import train as launcher
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    res = launcher.main(["--arch", ARCH[short], "--smoke", "--steps", "1",
                         "--batch", "2", "--seq-len", "32", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path)])
    m = res["runs"][0]["metrics"][0]
    assert np.isfinite(m["loss"]) and (m["aux_loss"] > 0) == (short == "kimi")


# -- training: the JAX reference (subprocesses) -------------------------------

def _jax_run(rid, init, batch):
    """The JAX step of run ``rid`` from ``init``: the bytes per (op,
    axis), traced, the first step's metrics and the updated trainable
    parameters."""
    import functools as ft

    import jax
    from jax.sharding import NamedSharding
    from repro.launch.roofline import collect_collectives
    from repro.optim.adamw import init_opt_state
    short, tp, kw = RUNS[rid]
    kw = {k: v for k, v in kw.items() if k != "steps"}
    mb = kw.pop("microbatch", 0)
    b = _jax_bundle(short, MESHES[tp], microbatch=mb, dtype=F32, **kw)
    src = b.treedef.flatten_up_to(init)
    tp_, fp = b.split([jax.device_put(np.asarray(a, np.float32),
                                      NamedSharding(b.mesh, spec))
                       for a, spec in zip(src, b.leaf_specs)])
    ost = jax.jit(ft.partial(init_opt_state, sys=b.run.system))(tp_)
    step = b.make_train_step()
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    stats = collect_collectives(step.trace(tp_, fp, ost, jb).jaxpr,
                                {a: b.mi.size(a) for a in b.mi.axis_names})
    tp_, ost, m = step(tp_, fp, ost, jb)
    return {"bytes": {k: v for k, v in stats.by_op_axis.items() if v},
            "metrics": {k: float(v) for k, v in m.items()},
            "params": {b.def_leaves[i].label: np.asarray(x, np.float32)
                       for i, x in zip(b.train_idx, tp_)}}


def _reference(init_path, group):
    with open(init_path, "rb") as f:
        inits = pickle.load(f)
    batch = make_batch()
    return {rid: _jax_run(rid, inits[RUNS[rid][0], RUNS[rid][1]], batch)
            for rid in JAX_GROUPS[group]}


def _start_reference(tmp, init_path, group):
    """``_reference(init_path, group)`` in a fresh interpreter with eight
    CPU devices and XLA's excess precision off (as
    ``tests/test_torch_families.py`` runs it)."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    out = os.path.join(tmp, f"archs_reference_{group}.pickle")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    code = ("import pickle, sys, test_torch_archs as t; pickle.dump("
            "t._reference(sys.argv[1], int(sys.argv[2])), "
            "open(sys.argv[3], 'wb'))")
    proc = subprocess.Popen([sys.executable, "-c", code, init_path,
                             str(group), out],
                            env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def _finish_reference(proc, out):
    try:
        _, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    if proc.returncode:
        raise RuntimeError(f"the JAX reference failed:\n{err[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


# -- training: the port -------------------------------------------------------

def _mode_run(rid):
    short, _, kw = RUNS[rid]
    return ModeRun(dtype=F32, model=smoke(short), **kw)


def _compute(tmp_path_factory):
    """The JAX reference in its own processes while the port's ranks run
    from the same weights: one spawn a mesh, every arch's runs in
    turn."""
    tmp = str(tmp_path_factory.mktemp("archs"))
    init_path = os.path.join(tmp, "inits.pickle")
    with open(init_path, "wb") as f:
        pickle.dump({(s, tp): init_tree(s, tp) for s, tp, _ in
                     RUNS.values()}, f)
    procs = [_start_reference(tmp, init_path, g)
             for g in range(len(JAX_GROUPS))]
    port = {}
    try:
        for tp, mesh in MESHES.items():
            rids = [rid for rid in RUNS if RUNS[rid][1] == tp]
            job = TrainJob(
                run=RunConfig(model=smoke(RUNS[rids[0]][0]),
                              shape=ShapeCell("t", "train", SEQ, BATCH),
                              system=SystemConfig(min_shard_size=8),
                              optimizer=OptimizerConfig(**OPT)),
                mesh=MeshShape(AXES, mesh),
                runs=[_mode_run(rid) for rid in rids], device="cpu", seed=0,
                batches=[make_batch()] * FALL_STEPS, return_params=True)
            ranks = spawn(job, tmp, timeout_s=900)
            for i, rid in enumerate(rids):
                port[rid] = [rk["runs"][i] for rk in ranks]
    except BaseException:
        for proc, _ in procs:
            proc.kill()
            proc.wait()
        raise
    ref = {}
    for proc, path in procs:
        ref.update(_finish_reference(proc, path))
    return {"ref": ref, "port": port}


@pytest.fixture(scope="module")
def arch_runs(tmp_path_factory):
    return shared_result(tmp_path_factory, "torch_archs_runs",
                         lambda: _compute(tmp_path_factory))


def _port_params(ranks, tp):
    specs = ranks[0]["specs"]
    mesh = MeshShape(AXES, MESHES[tp])
    return {path: assemble({r: torch.from_numpy(res["params"][path])
                            for r, res in enumerate(ranks)},
                           specs[path], mesh).numpy()
            for path in specs}


@pytest.mark.parametrize("rid", RUN_IDS)
def test_step_matches_jax(arch_runs, rid):
    """The first step from the same weights and batch: loss, aux loss,
    grad norm and the updated parameters, every rank alike."""
    ref, ranks = arch_runs["ref"][rid], arch_runs["port"][rid]
    m, mj = ranks[0]["metrics"][0], ref["metrics"]
    np.testing.assert_allclose(m["loss"], mj["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"], mj["grad_norm"],
                               rtol=GNORM_RTOL)
    np.testing.assert_allclose(m["aux_loss"], mj["aux_loss"], rtol=AUX_RTOL)
    assert (m["aux_loss"] > 0) == (RUNS[rid][0] in MOE)
    assert m["tokens"] == mj["tokens"]
    if "microbatch" not in RUNS[rid][2]:
        assert m["tokens"] == BATCH * SEQ
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    params = _port_params(ranks, RUNS[rid][1])
    assert set(params) == set(ref["params"])
    for path, want in ref["params"].items():
        np.testing.assert_allclose(params[path], want, **PARAM_TOL,
                                   err_msg=f"{rid} {path}")


@pytest.mark.parametrize("rid", RUN_IDS)
def test_bytes_match_jax(arch_runs, rid):
    """Every (op, axis) byte count of the step equals the JAX trace on
    every rank: gemma's table gathered and reduced at both ends of the
    step, under every schedule."""
    want = arch_runs["ref"][rid]["bytes"]
    for rank, r in enumerate(arch_runs["port"][rid]):
        assert r["bytes"][0] == want, (rid, rank)


@pytest.mark.parametrize("short", FALLING)
def test_losses_fall_over_four_steps(arch_runs, short):
    """fcdp at (2, 2, 2), 4 steps on one batch: finite and falling."""
    losses = [m["loss"] for m in
              arch_runs["port"][f"{short}_fcdp_tp2"][0]["metrics"]]
    assert len(losses) == FALL_STEPS and np.isfinite(losses).all()
    assert losses[-1] < losses[0], (short, losses)


def test_yi_heads_pad_at_tp4(arch_runs):
    """yi-smoke's 6 q heads pad to 8 at tp 4 (6 at tp 1 and 2): wq is
    [64, 8 x 16] a layer, each 'model' rank holding 2 heads."""
    ranks = arch_runs["port"]["yi_fcdp_tp4"]
    assert _port_params(ranks, 4)["blocks.pos0.attn.wq"].shape \
        == (2, 64, 128)
    assert ranks[0]["specs"]["blocks.pos0.attn.wq"][2] == "model"
    assert _port_params(arch_runs["port"]["yi_fcdp_tp2"], 2)[
        "blocks.pos0.attn.wq"].shape == (2, 64, 96)
