"""seamless-m4t-medium, the encoder-decoder arch, in the port against
the JAX package's, on the CPU.

What the arch adds to the decoder-only ones: a second model class
(``models/encdec.EncDec``: ``enc_blocks`` and ``dec_blocks``, each with
its own gather schedule), cross-attention (``xattn``: wq / wo
head-parallel, wk / wv replicated over 'model', an exact closing sum,
no adapter consumed), the encoder's non-causal self-attention, and the
encoder output as an input of every decoder layer, whose gradient is
summed over the decoder's cross-attentions (and over 'model' at tp 2)
and flows back through the encoder under every activation policy.

In process: the defs (paths, shapes, dims, inits, storage specs) of the
smoke config at (2, 2, 1) and (2, 2, 2) equal the JAX bundle's;
``ref.attention_plain`` without a mask over fewer keys than queries
equals the JAX ``chunked_causal_attention(causal=False)``; the loader's
frames equal the JAX loader's bit for bit; the conversion carries the
tree at tp 1 and 2; the paged path refuses the model (the JAX package
fails with an ``AttributeError``); ``cache_bytes_per_chip`` and two
``MemoryPlanner``s equal the JAX package's with ``==``; the launch plans
walk both stacks; a prefill with the encoder frames and two greedy
decode steps give the JAX steps' logits within
``tests/test_torch_jamba.py``'s fp32 5e-3 and its cross-attention state
within one bf16 step; both launchers take the arch (the serve launcher
to refuse it).

Train: one step of the smoke config at (pod 2, data 2, model 1) and
(2, 2, 2) in fp32 from the same weights (drawn by the port's
initializer from seed 0 at the mesh's tp), under zero3 and fcdp; at tp
1 fcdp at prefetch depth 1 (each stack its own ring) and fcdp with
PEFT; at tp 2 fcdp + int8 qwZ/qgZ, fcdp + the gather-fused
``ag_matmul``, fcdp at microbatch 2 under the async 'pod' reduce,
block_io (with act int8, and without) and save_collectives. Each is held to the JAX step
at ``tests/test_system.py:84-89``'s tolerances (loss rtol 1e-4, grad
norm 1e-3, updated parameters rtol 2e-2 / atol 2e-3) and to every (op,
axis) byte count of its trace. The recompute policies give the encoder
the update of save_all; the cross-attention adapters stay as drawn; a
device fraction of 0.5 leaves the step bit for bit as it was. The JAX
steps run in subprocesses with XLA's excess precision off while the
port's ranks run (gloo, one spawn a mesh), once per session
(``shared_result``); a JAX process that a signal ends runs again
(``JAX_RETRIES``: XLA's CPU runtime, not the port, crashes there now
and then).
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (OptimizerConfig, RunConfig, ShapeCell,
                                      SystemConfig)
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.partition import init_params, tree_items
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.train import ModeRun, TrainJob, spawn
from test_torch_train import assemble, shared_result

ARCH = "seamless-m4t-medium"
SEQ, BATCH = 64, 8
ENC = max(SEQ // 4, 8)
AXES = ("pod", "data", "model")
MESHES = {1: (2, 2, 1), 2: (2, 2, 2)}
F32 = "float32"
OPT = dict(total_steps=8, warmup_steps=2, lr=1e-3)
LOSS_RTOL, GNORM_RTOL = 1e-4, 1e-3
PARAM_TOL = dict(rtol=2e-2, atol=2e-3)
LORA_RANK = 4
INT8 = dict(param_compress="int8_pod", grad_compress="int8_pod")

# run id -> (tp, system knobs), one step each; "frac" and the policies
# are held to the JAX run named in ``SAME_AS``
RUNS = {
    "zero3_tp1": (1, dict(mode="zero3")),
    "fcdp_tp1": (1, dict(mode="fcdp")),
    "fcdp_d1_tp1": (1, dict(mode="fcdp", prefetch_depth=1)),
    "peft_fcdp_tp1": (1, dict(mode="fcdp", peft=True, lora_rank=LORA_RANK)),
    "frac_fcdp_tp1": (1, dict(mode="fcdp", device_cache_fraction=0.5)),
    "zero3_tp2": (2, dict(mode="zero3")),
    "fcdp_tp2": (2, dict(mode="fcdp")),
    "fcdp_q8_tp2": (2, dict(mode="fcdp", **INT8)),
    "fcdp_ag_tp2": (2, dict(mode="fcdp", fused_matmul="ag_matmul")),
    "fcdp_async_tp2": (2, dict(mode="fcdp", microbatch=2,
                               async_grad_reduce=True)),
    "blockio_act8_tp2": (2, dict(mode="fcdp", activation_policy="block_io",
                                 act_psum="int8")),
    "blockio_tp2": (2, dict(mode="fcdp", activation_policy="block_io")),
    "savecoll_tp2": (2, dict(mode="fcdp",
                             activation_policy="save_collectives")),
}
RUN_IDS = list(RUNS)
# the JAX package ignores the device fraction: its step is fcdp's
SAME_AS = {"frac_fcdp_tp1": "fcdp_tp1"}
# the JAX runs, one subprocess a group, side by side; a group keeps to one
# mesh (a process that runs steps on both meshes can crash in XLA's CPU
# collectives)
JAX_GROUPS = (
    ("zero3_tp1", "fcdp_tp1"),
    ("fcdp_d1_tp1", "peft_fcdp_tp1"),
    ("zero3_tp2",),
    ("fcdp_tp2", "fcdp_q8_tp2", "fcdp_async_tp2"),
    ("fcdp_ag_tp2", "blockio_act8_tp2"),
    ("blockio_tp2", "savecoll_tp2"),
)
# a JAX process that a signal ends (XLA's CPU runtime corrupts its heap
# in about 1 of 8 runs of seamless-smoke's zero3 step at (2, 2, 2), and
# its in-process collectives may time out on a loaded host; ROADMAP
# Queue 3) runs again, up to this many times
JAX_RETRIES = 2
assert sorted(sum(JAX_GROUPS, ()) + tuple(SAME_AS)) == sorted(RUNS)


def smoke():
    return get_smoke_config(ARCH)


def make_batch(seed=0):
    """ids and labels in [1, 515) and frames [B, 16, 64] of bf16 values
    (carried in fp32: both packages cast them to the step's dtype)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 515, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(1, 515, (BATCH, SEQ)).astype(np.int32)
    frames = torch.from_numpy(rng.standard_normal(
        (BATCH, ENC, 64)).astype(np.float32)).bfloat16().float().numpy()
    return {"ids": ids, "labels": labels, "mask": np.ones_like(labels, bool),
            "enc_embeds": frames}


def _nest(flat):
    out: dict = {}
    for path, t in flat:
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def _jax_system(**kw):
    from repro.configs.base import SystemConfig as JSystemConfig
    dtype = kw.pop("dtype", "bfloat16")
    return JSystemConfig(min_shard_size=8, quant_impl="jnp", fused_impl="jnp",
                         param_dtype=dtype, compute_dtype=dtype, **kw)


def _jax_bundle(sizes, kind="train", seq=SEQ, batch=BATCH, microbatch=0,
                **kw):
    import jax
    from repro.configs.base import OptimizerConfig as JOptimizerConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import ShapeCell as JShapeCell
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.core.engine import StepBundle as JStepBundle
    from repro.launch.mesh import make_mesh
    run = JRunConfig(model=j_smoke(ARCH), shape=JShapeCell("t", kind, seq,
                                                           batch),
                     system=_jax_system(**kw),
                     optimizer=JOptimizerConfig(**OPT),
                     microbatch=microbatch)
    n = int(np.prod(sizes))
    return JStepBundle(run, make_mesh(sizes, AXES, devices=jax.devices()[:n]))


def _port_bundle(sizes, kind="train", seq=SEQ, batch=BATCH, **kw):
    from repro_torch.core.engine import StepBundle
    run = RunConfig(model=smoke(), shape=ShapeCell("t", kind, seq, batch),
                    system=SystemConfig(min_shard_size=8, **kw),
                    optimizer=OptimizerConfig(**OPT))
    return StepBundle(run, device="cpu",
                      mesh=None if sizes is None else MeshShape(AXES, sizes))


def init_tree(tp, **kw):
    """The smoke config's full parameters at tp (adapters included
    under ``peft``) as a nested dict of fp32 numpy arrays, drawn by the
    port's initializer from seed 0, as the port's ranks draw them."""
    defs = _port_bundle(MESHES[tp], **kw).defs
    flat = init_params(defs, 0, torch.device("cpu"), torch.float32)
    return _nest((p, t.numpy()) for p, t in tree_items(flat))


# -- in process ---------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2])
def test_defs_equal_jax(tp):
    """Leaf for leaf at (2, 2, tp): the paths in treedef order (embed,
    enc_blocks, enc_norm, dec_blocks, final_norm, head), shapes (the
    vocabulary padded to 516 at tp 2), dims, inits and storage specs;
    cross-attention has no bias and no qk-norm."""
    jb = _jax_bundle(MESHES[tp])
    pb = _port_bundle(MESHES[tp])
    assert pb.paths == [d.label for d in jb.def_leaves]
    assert [(d.shape, d.dims, d.init, d.init_scale, d.fusable)
            for d in pb.def_leaves] == [
        (d.shape, d.dims, d.init, d.init_scale, d.fusable)
        for d in jb.def_leaves]
    assert pb.leaf_specs == [tuple(s) for s in jb.leaf_specs]
    xattn = sorted(p.rsplit(".", 1)[1] for p in pb.paths if ".xattn." in p)
    assert xattn == ["norm", "wk", "wo", "wq", "wv"]
    assert pb.def_leaves[pb.paths.index("embed")].shape[0] == 515 + (tp - 1)


@pytest.mark.parametrize("Sq,Hk", [(48, 4), (1, 4), (48, 2)],
                         ids=["prefill", "decode", "gqa"])
def test_plain_noncausal_matches_jax_chunked(Sq, Hk):
    """``ref.attention_plain(causal=False)`` of Sq queries over 17 keys
    (the kv heads read by index) equals the JAX
    ``chunked_causal_attention(causal=False)`` (kv expanded), fp32 within
    2e-5 (``tests/test_kernels.py``'s fp32 tolerance)."""
    import jax.numpy as jnp
    from repro.models.attention import chunked_causal_attention
    from repro_torch.kernels import ref
    rng = np.random.default_rng(Sq + Hk)
    B, Skv, H, hd = 2, 17, 4, 16
    q = rng.normal(0, 1, (B, Sq, H, hd)).astype(np.float32)
    k, v = (rng.normal(0, 1, (B, Skv, Hk, hd)).astype(np.float32)
            for _ in range(2))
    rep = H // Hk
    want = chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=2)),
        jnp.asarray(np.repeat(v, rep, axis=2)), causal=False, q_chunk=16,
        kv_chunk=8)
    got = ref.attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), None, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_loader_frames_equal_jax_bit_for_bit():
    """``ShardedLoader`` with the arch's frame width gives every batch
    the JAX loader's ``enc_embeds`` [8, 16, 64] bf16, bit for bit, and
    each rank its rows of them."""
    import jax
    from jax.sharding import Mesh
    from repro.configs.base import ShapeCell as JShapeCell
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import ShardedLoader as JLoader
    from repro.data.pipeline import SyntheticPackedLM as JData
    from repro_torch.data.pipeline import (DataConfig, ShardedLoader,
                                           SyntheticPackedLM, enc_embed_dim)
    from types import SimpleNamespace
    cell = ShapeCell("t", "train", SEQ, BATCH)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jl = JLoader(JData(j_smoke(ARCH), JShapeCell("t", "train", SEQ, BATCH),
                       JDataConfig(seed=3)), mesh, {}, enc_embed_dim=64)
    pb = _port_bundle(MESHES[1])
    assert enc_embed_dim(smoke()) == 64
    assert enc_embed_dim(get_smoke_config("qwen2.5-3b")) == 0
    for step in (0, 5):
        want = np.asarray(jl.get(step)["enc_embeds"])
        rows = []
        for rank in range(4):
            b = SimpleNamespace(mesh_shape=pb.mesh_shape,
                                coords=pb.mesh_shape.coords(rank),
                                device=torch.device("cpu"))
            b.shard_batch = lambda batch, b=b: type(pb).shard_batch(b, batch)
            got = ShardedLoader(SyntheticPackedLM(smoke(), cell,
                                                  DataConfig(seed=3)), b,
                                64).get(step)["enc_embeds"]
            assert got.dtype == torch.bfloat16 and got.shape == (2, ENC, 64)
            rows.append(got)
        got = torch.cat([rows[c] for c in (0, 2, 1, 3)])
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))


def test_params_from_jax_carries_the_tree():
    """The JAX bundle's whole tree into the port's parameter dict, bit
    for bit in bf16; a tree without a cross-attention leaf is refused."""
    import jax
    from repro_torch.convert import params_from_jax
    jb = _jax_bundle((1, 1, 1), kind="decode")
    leaves = jb.init_all_params(seed=0)
    tree = jax.tree.unflatten(jb.treedef, [np.asarray(x) for x in leaves])
    params = params_from_jax(tree, smoke(), device="cpu")
    got = dict(tree_items(params))
    assert list(got) == [d.label for d in jb.def_leaves]
    for (path, t), leaf in zip(got.items(), leaves):
        a = np.asarray(leaf)
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16), path)
    pos = tree["dec_blocks"]["pos0"]
    bad = dict(tree, dec_blocks={"pos0": dict(pos, xattn={
        k: v for k, v in pos["xattn"].items() if k != "wk"})})
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(bad, smoke(), device="cpu")


@pytest.mark.parametrize("tp", [1, 2])
def test_shards_from_jax_carries_the_tree(tp):
    """``convert.shards_from_jax`` cuts the tree into every rank's shards
    at (2, 2, tp); put back together they are the tree, bit for bit."""
    from types import SimpleNamespace

    from repro_torch.convert import shards_from_jax
    from repro_torch.core.engine import StepBundle
    tree = init_tree(tp)
    ms = MeshShape(AXES, MESHES[tp])
    run = RunConfig(model=smoke(), shape=ShapeCell("t", "train", SEQ, BATCH),
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


def test_paged_path_refuses_the_model():
    """The port's gate names the contiguous steps; the JAX gate reads a
    ``plan`` the JAX ``EncDec`` does not have (ROADMAP Queue 3)."""
    from repro.core.engine.serve import check_paged_plan as j_check
    from repro_torch.core.engine.serve import check_paged_plan
    from repro_torch.launch import serve as launcher
    from repro_torch.models.encdec import EncDec
    with pytest.raises(ValueError, match="contiguous prefill/decode"):
        check_paged_plan(EncDec(smoke(), SystemConfig()))
    with pytest.raises(AttributeError, match="plan"):
        j_check(_jax_bundle((1, 1, 1), kind="decode").model)
    with pytest.raises(ValueError, match="encoder-decoder"):
        launcher.main(["--arch", ARCH, "--smoke", "--requests", "2",
                       "--seq-len", "32", "--gen-len", "2", "--batch", "2",
                       "--device", "cpu"])


ACCOUNTING = {"fcdp": dict(mode="fcdp"), "zero3": dict(mode="zero3"),
              "fcdp_d1": dict(mode="fcdp", prefetch_depth=1),
              "fcdp_q8": dict(mode="fcdp", **INT8),
              "fcdp_frac": dict(mode="fcdp", device_cache_fraction=0.5)}


@pytest.mark.parametrize("cid", list(ACCOUNTING))
def test_cache_accounting_equals_jax(cid):
    """``cache_bytes_per_chip`` (every key, ``by_group`` included; no
    paged KV bytes for a model without a paged stack) and
    ``stage1_dcn_gather_bytes`` at (2, 2, 2) equal the JAX package's."""
    from repro.core import cache as jc
    from repro.core.kv_cache import PagedKVConfig as JKV
    from repro_torch.core import cache as pc
    from repro_torch.core.kv_cache import PagedKVConfig
    jb = _jax_bundle(MESHES[2], **ACCOUNTING[cid])
    pb = _port_bundle(MESHES[2], **ACCOUNTING[cid])
    assert pc.cache_bytes_per_chip(pb) == jc.cache_bytes_per_chip(jb)
    assert pc.stage1_dcn_gather_bytes(pb) == jc.stage1_dcn_gather_bytes(jb)
    got = pc.cache_bytes_per_chip(pb, PagedKVConfig(16, 9, 4))
    assert got == jc.cache_bytes_per_chip(jb, JKV(16, 9, 4))
    assert got["kv_page_bytes_per_chip"] == 0.0


@pytest.mark.parametrize("case", ["walk", "impossible"])
def test_planner_equals_jax(case, mesh3):
    """Both planners walk the same attempts and return the same plan
    under a synthetic peak (``tests/test_torch_archs.py``'s)."""
    import importlib

    from test_torch_archs import _planner
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
        run = base.RunConfig(model=reg.get_smoke_config(ARCH),
                             shape=base.ShapeCell("t", "train", SEQ, BATCH),
                             system=sysc,
                             optimizer=base.OptimizerConfig(**OPT))
        planner = _planner(pkg, fit, hbm_budget=budget)
        plans[pkg] = dataclasses.asdict(planner.plan(run, mesh, (1.0, 0.0)))
    assert plans["repro_torch"] == plans["repro"]


PLANS = {
    # (tp, knobs, activation all-reduces carried in int8, chunk matmuls)
    "act8_block_io": (2, dict(mode="fcdp", act_psum="int8",
                              activation_policy="block_io"), 20, 0),
    "act8_save_all": (2, dict(mode="fcdp", act_psum="int8"), 16, 0),
    "ag_block_io": (1, dict(mode="fcdp", fused_matmul="ag_matmul",
                            activation_policy="block_io"), 0, 32),
    "ag_save_all": (1, dict(mode="fcdp", fused_matmul="ag_matmul"), 0, 20),
}


@pytest.mark.parametrize("pid", list(PLANS))
def test_launch_plans_walk_both_stacks(pid):
    """The launch plans count the encoder's and the decoder's layers. Act
    int8 at tp 2: attention and the MLP reduce their output and their
    input's gradient in int8 (4 a layer, 2 + 2 layers), block_io runs
    the forward's again for all but each stack's last sublayer (the
    self-attention's: 5 a layer); the cross-attention's sum is exact.
    ag_matmul over 'data' (2 ranks) at tp 1: the fusable ``wo`` /
    ``w_out`` of every layer (2 in an encoder layer, 3 in a decoder
    layer: 20 chunks), under block_io again for all but each stack's
    last sublayer (the MLP's ``w_out``; the cross-attention's ``wo``
    runs again: 32). No Mamba scan."""
    from repro_torch.core.engine.train import (act_int8_launch_plan,
                                               mamba_scan_launch_plan,
                                               matmul_chunk_launch_plan)
    tp, kw, act, mm = PLANS[pid]
    pb = _port_bundle(MESHES[tp], **kw)
    assert act_int8_launch_plan(pb) == {"quantize": act,
                                        "dequantize": act,
                                        "dequant_accumulate": act}
    assert matmul_chunk_launch_plan(pb) == mm
    assert mamba_scan_launch_plan(pb) == 0


# -- serving ------------------------------------------------------------------

def test_contiguous_steps_match_jax():
    """The frames [2, 16, 64] and a 48-token prompt through both
    packages' ``make_prefill_step`` (which takes the frames), then two
    greedy decode steps, from the same weights, fp32: the logits of
    every step within 5e-3, the greedy tokens equal, and the
    cross-attention K/V state (bf16) within one bf16 step of the JAX
    one."""
    import jax
    import jax.numpy as jnp
    from repro_torch.convert import params_from_jax
    B, P = 2, 48
    jb = _jax_bundle((1, 1, 1), kind="decode", seq=SEQ, batch=B, dtype=F32)
    pb = _port_bundle(None, kind="decode", seq=SEQ, batch=B, dtype=F32)
    leaves = jb.init_all_params(seed=0)
    tree = jax.tree.unflatten(jb.treedef, [np.asarray(x) for x in leaves])
    params = params_from_jax(tree, pb.run.model, dtype=torch.float32,
                             device="cpu")
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 515, (B, P)).astype(np.int32)
    frames = rng.standard_normal((B, ENC, 64)).astype(np.float32)
    jframes = jnp.asarray(frames, jnp.bfloat16)
    tframes = torch.from_numpy(frames).bfloat16()
    jl, jst = jb.make_prefill_step()(leaves, jframes, jnp.asarray(ids),
                                     jb.init_state(jb.run.shape))
    tl, st = pb.make_prefill_step()(params, tframes, torch.from_numpy(ids),
                                    pb.init_state())
    for name in ("k", "v"):
        want = np.asarray(jst["pos0"]["xattn"][name], np.float32)
        got = st["pos0"]["xattn"][name]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == \
            want.shape == (2, B, ENC, 4, 16)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=1e-6)
    jdec, dec = jb.make_decode_step(), pb.make_decode_step()
    for step in range(3):
        want = np.asarray(jl, np.float32)
        assert tl.shape == want.shape == (B, 515)
        np.testing.assert_allclose(tl.numpy(), want, rtol=0, atol=5e-3,
                                   err_msg=f"step {step}")
        tok = want.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        if step < 2:
            jl, jst = jdec(leaves, jnp.asarray(tok)[:, None], jst)
            tl, st = dec(params, torch.from_numpy(tok)[:, None], st)
    assert st["pos0"]["attn"]["idx"].tolist() == [P + 2] * 2


def test_train_launcher_takes_the_arch(monkeypatch, tmp_path):
    """``python -m repro_torch.launch.train --arch seamless-m4t-medium
    --smoke --device cpu`` takes a step on one rank (torchrun's
    environment), its batches carrying the frames."""
    import socket

    from repro_torch.launch import train as launcher
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    res = launcher.main(["--arch", ARCH, "--smoke", "--steps", "1",
                         "--batch", "2", "--seq-len", "32", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path)])
    m = res["runs"][0]["metrics"][0]
    assert np.isfinite(m["loss"]) and m["aux_loss"] == 0


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
    tp, kw = RUNS[rid]
    b = _jax_bundle(MESHES[tp], dtype=F32, **kw)
    src = b.treedef.flatten_up_to(init)
    tp_, fp = b.split([jax.device_put(np.asarray(a, np.float32),
                                      NamedSharding(b.mesh, spec))
                       for a, spec in zip(src, b.leaf_specs)])
    ost = jax.jit(ft.partial(init_opt_state, sys=b.run.system))(tp_)
    step = b.make_train_step()
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    jb["enc_embeds"] = jb["enc_embeds"].astype(jax.numpy.bfloat16)
    stats = collect_collectives(step.trace(tp_, fp, ost, jb).jaxpr,
                                {a: b.mi.size(a) for a in b.mi.axis_names})
    tp_, ost, m = step(tp_, fp, ost, jb)
    return {"bytes": {k: v for k, v in stats.by_op_axis.items() if v},
            "metrics": {k: float(v) for k, v in m.items()},
            "params": {b.def_leaves[i].label: np.asarray(x, np.float32)
                       for i, x in zip(b.train_idx, tp_)}}


def _init_key(rid):
    tp, kw = RUNS[rid]
    return tp, bool(kw.get("peft"))


def _reference(init_path, group):
    with open(init_path, "rb") as f:
        inits = pickle.load(f)
    batch = make_batch()
    return {rid: _jax_run(rid, inits[_init_key(rid)], batch)
            for rid in JAX_GROUPS[group]}


def _start_reference(tmp, init_path, group):
    """``_reference(init_path, group)`` in a fresh interpreter with eight
    CPU devices and XLA's excess precision off (as
    ``tests/test_torch_archs.py`` runs it)."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    out = os.path.join(tmp, f"encdec_reference_{group}.pickle")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    code = ("import pickle, sys, test_torch_encdec as t; pickle.dump("
            "t._reference(sys.argv[1], int(sys.argv[2])), "
            "open(sys.argv[3], 'wb'))")
    proc = subprocess.Popen([sys.executable, "-c", code, init_path,
                             str(group), out],
                            env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def _finish_reference(proc, out, tmp, init_path, group):
    for attempt in range(JAX_RETRIES + 1):
        try:
            _, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        if proc.returncode >= 0 or attempt == JAX_RETRIES:
            break
        proc, out = _start_reference(tmp, init_path, group)
    if proc.returncode:
        raise RuntimeError(f"the JAX reference failed (exit "
                           f"{proc.returncode}):\n{err[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


# -- training: the port -------------------------------------------------------

def _mode_run(rid):
    _, kw = RUNS[rid]
    return ModeRun(dtype=F32, model=smoke(), **kw)


def _compute(tmp_path_factory):
    """The JAX reference in its own processes while the port's ranks run
    from the same weights: one spawn a mesh."""
    tmp = str(tmp_path_factory.mktemp("encdec"))
    init_path = os.path.join(tmp, "inits.pickle")
    with open(init_path, "wb") as f:
        pickle.dump({(tp, peft): init_tree(tp, **(
            dict(peft=True, lora_rank=LORA_RANK) if peft else {}))
            for tp, peft in {_init_key(r) for r in RUNS}}, f)
    procs = [_start_reference(tmp, init_path, g)
             for g in range(len(JAX_GROUPS))]
    port = {}
    try:
        for tp, mesh in MESHES.items():
            rids = [rid for rid in RUNS if RUNS[rid][0] == tp]
            job = TrainJob(
                run=RunConfig(model=smoke(),
                              shape=ShapeCell("t", "train", SEQ, BATCH),
                              system=SystemConfig(min_shard_size=8),
                              optimizer=OptimizerConfig(**OPT)),
                mesh=MeshShape(AXES, mesh),
                runs=[_mode_run(rid) for rid in rids], device="cpu", seed=0,
                batches=[make_batch()], return_params=True)
            ranks = spawn(job, tmp, timeout_s=900)
            for i, rid in enumerate(rids):
                port[rid] = [rk["runs"][i] for rk in ranks]
    except BaseException:
        for proc, _ in procs:
            proc.kill()
            proc.wait()
        raise
    ref = {}
    for group, (proc, path) in enumerate(procs):
        ref.update(_finish_reference(proc, path, tmp, init_path, group))
    return {"ref": ref, "port": port}


@pytest.fixture(scope="module")
def encdec_runs(tmp_path_factory):
    return shared_result(tmp_path_factory, "torch_encdec_runs",
                         lambda: _compute(tmp_path_factory))


def _port_params(ranks, tp, key="params"):
    specs = ranks[0]["specs"]
    mesh = MeshShape(AXES, MESHES[tp])
    return {path: assemble({r: torch.from_numpy(res[key][path])
                            for r, res in enumerate(ranks)},
                           specs[path], mesh).numpy()
            for path in specs}


@pytest.mark.parametrize("rid", RUN_IDS)
def test_step_matches_jax(encdec_runs, rid):
    """The first step from the same weights and batch: loss, grad norm
    and the updated trainable parameters, every rank alike, no aux
    loss."""
    ref = encdec_runs["ref"][SAME_AS.get(rid, rid)]
    ranks = encdec_runs["port"][rid]
    m, mj = ranks[0]["metrics"][0], ref["metrics"]
    np.testing.assert_allclose(m["loss"], mj["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"], mj["grad_norm"],
                               rtol=GNORM_RTOL)
    assert m["aux_loss"] == 0 and m["tokens"] == mj["tokens"]
    if "microbatch" not in RUNS[rid][1]:
        assert m["tokens"] == BATCH * SEQ
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    params = _port_params(ranks, RUNS[rid][0])
    for path, want in ref["params"].items():
        np.testing.assert_allclose(params[path], want, **PARAM_TOL,
                                   err_msg=f"{rid} {path}")


@pytest.mark.parametrize("rid", RUN_IDS)
def test_bytes_match_jax(encdec_runs, rid):
    """Every (op, axis) byte count of the step equals the JAX trace on
    every rank, 'model' included at tp 2 (cross-attention's k / v
    gradients summed there, its output summed exactly)."""
    want = encdec_runs["ref"][SAME_AS.get(rid, rid)]["bytes"]
    for rank, r in enumerate(encdec_runs["port"][rid]):
        assert r["bytes"][0] == want, (rid, rank)


@pytest.mark.parametrize("rid", ["fcdp_q8_tp2", "fcdp_ag_tp2",
                                 "blockio_act8_tp2"])
def test_kernel_calls_equal_the_plans(encdec_runs, rid):
    """The int8 trio and the chunk matmul (their plain versions on the
    CPU) are called as often as the launch plans say, over both
    stacks."""
    for r in encdec_runs["port"][rid]:
        assert r["calls"][0] == r["int8_plan"], rid
        assert r["mm_calls"][0] == r["mm_plan"], rid
    r = encdec_runs["port"][rid][0]
    assert any(r["int8_plan"].values()) == ("q8" in rid or "act8" in rid)
    assert (r["mm_plan"] > 0) == ("_ag_" in rid)


@pytest.mark.parametrize("rid", ["blockio_tp2", "savecoll_tp2",
                                 "blockio_act8_tp2"])
def test_recompute_gives_the_encoder_its_gradient(encdec_runs, rid):
    """Under block_io and save_collectives the decoder's layers run
    through ``_Recompute``: the encoder output's gradient crosses it, so
    the encoder's updated weights equal save_all's within fp32
    rounding (act int8 within its quantization, 2e-3)."""
    got = _port_params(encdec_runs["port"][rid], 2)
    want = _port_params(encdec_runs["port"]["fcdp_tp2"], 2)
    tol = dict(rtol=2e-3, atol=2e-3) if "act8" in rid else dict(rtol=1e-5,
                                                                  atol=1e-6)
    init = init_tree(2)
    moved = 0
    for path in got:
        if path.startswith(("enc_blocks", "enc_norm")):
            np.testing.assert_allclose(got[path], want[path], **tol,
                                       err_msg=f"{rid} {path}")
            flat = dict(tree_items(init))[path]
            moved += not np.array_equal(got[path], flat)
    assert moved == 9      # every encoder leaf moved


def test_cross_attention_adapters_stay_unchanged(encdec_runs):
    """Under PEFT the cross-attention dicts hold wq/wk/wv/wo adapters, as
    the JAX package injects them, but the cross-attention never reads
    them: they take a zero gradient and stay as drawn (B zero), while
    the self-attention's move; the trunk stays frozen."""
    ranks = encdec_runs["port"]["peft_fcdp_tp1"]
    got = _port_params(ranks, 1)
    init = dict(tree_items(init_tree(1, peft=True, lora_rank=LORA_RANK)))
    xattn = [p for p in got if ".xattn." in p and "_lora_" in p]
    assert len(xattn) == 8 and all("_lora_" in p for p in xattn)
    for path in xattn:
        np.testing.assert_array_equal(got[path], init[path], path)
    assert not np.array_equal(got["dec_blocks.pos0.attn.wq_lora_b"],
                              init["dec_blocks.pos0.attn.wq_lora_b"])
    assert not np.array_equal(got["enc_blocks.pos0.attn.wv_lora_b"],
                              init["enc_blocks.pos0.attn.wv_lora_b"])
    assert all(r["frozen_unchanged"] for r in ranks)


def test_device_fraction_leaves_the_step_unchanged(encdec_runs):
    """As in the JAX package, ``EncDec`` has no FCDP-Cache segments: a
    device fraction of 0.5 gives fcdp's step bit for bit, its bytes and
    its cache places (every stage-1 cache on the host)."""
    frac, base = (encdec_runs["port"][k] for k in ("frac_fcdp_tp1",
                                                    "fcdp_tp1"))
    for a, b in zip(frac, base):
        assert a["final_digest"] == b["final_digest"]
        assert a["metrics"] == b["metrics"] and a["bytes"] == b["bytes"]
        assert a["cache_places"] == b["cache_places"]
