"""The port's paged serve path against the JAX package's, on the CPU.

Both packages run the ``t-dense`` model of ``tests/test_serve_engine.py``
(4 layers, d_model 64, GQA 4/2, vocab 256) on the same weights: the
JAX bundle's on a one-device (pod, data, model) mesh, converted with
``repro_torch.convert.params_from_jax``. The paged pools are bf16 in
both packages.

Tolerances: at dtype float32 the logits agree within 1e-3 (the
only roundings the packages share are the bf16 KV writes; a K/V value
on the edge of a bf16 rounding step can round apart, which moves a
logit by ~1e-4 in this model). At bf16 the JAX and PyTorch CPU
matmuls round their bf16 outputs at different places, so the logits
(~N(0, 1)) agree within 0.1, a few bf16 steps at their magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeCell as JShapeCell
from repro.configs.base import SystemConfig as JSystemConfig
from repro.core.engine import StepBundle as JStepBundle
from repro.core.engine.serve import default_paged_kv as j_default_paged_kv
from repro.core.serve_schedule import PagedServeEngine as JEngine
from repro.launch.mesh import make_mesh
from repro.launch.serve import mixed_requests as j_mixed_requests
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeCell
from repro_torch.configs.base import SystemConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import StepBundle
from repro_torch.core.engine.serve import default_paged_kv
from repro_torch.core.partition import tree_items
from repro_torch.core.serve_schedule import PagedServeEngine, Request
from repro_torch.launch.serve import mixed_requests

DENSE = dict(name="t-dense", family="dense", num_layers=4, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             qkv_bias=True)
B, SEQ = 8, 128
LOGIT_TOL = {"float32": 1e-3, "bfloat16": 0.1}


def _jax_bundle(dtype: str):
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"),
                     devices=jax.devices()[:1])
    run = JRunConfig(model=JModelConfig(**DENSE),
                     shape=JShapeCell("t", "decode", SEQ, B),
                     system=JSystemConfig(mode="fcdp", min_shard_size=8,
                                          param_dtype=dtype,
                                          compute_dtype=dtype))
    return JStepBundle(run, mesh)


def _port_bundle(dtype: str):
    run = RunConfig(model=ModelConfig(**DENSE),
                    shape=ShapeCell("t", "decode", SEQ, B),
                    system=SystemConfig(dtype=dtype))
    return StepBundle(run, device="cpu")


@pytest.fixture(scope="module")
def jax_side():
    """JAX bundles (one per dtype) and the shared weights as numpy."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jb = _jax_bundle(dtype)
        leaves = jb.init_all_params(seed=0)
        out[dtype] = (jb, leaves)
    tree = jax.tree.unflatten(out["float32"][0].treedef,
                              [np.asarray(x) for x in out["float32"][1]])
    return out, tree


def _port(dtype, tree):
    pb = _port_bundle(dtype)
    return pb, params_from_jax(tree, pb.run.model,
                               dtype=pb.run.system.torch_dtype, device="cpu")


def test_params_from_jax_bit_equal(jax_side):
    out, tree = jax_side
    jb, leaves = out["float32"]
    pb = _port_bundle("bfloat16")
    params = params_from_jax(tree, pb.run.model, device="cpu")
    defs = dict(tree_items(pb.defs))
    got = dict(tree_items(params))
    assert list(got) == list(defs)
    # the port enumerates the JAX bundle's leaves, in treedef order,
    # with the same labels and the same serve-frozen classification
    assert [d.label for d in jb.def_leaves] == list(defs)
    assert [d.frozen for d in jb.def_leaves] == [d.frozen
                                                 for d in defs.values()]
    for (path, t), leaf in zip(got.items(), leaves):
        a = np.asarray(leaf)
        assert t.shape == defs[path].shape == a.shape
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    with pytest.raises(ValueError, match="differ"):
        params_from_jax({k: v for k, v in tree.items() if k != "head"},
                        pb.run.model, device="cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_steps_match_jax(dtype, jax_side):
    """Two prefill chunks and a decode step over the same pools, tables
    and positions; rows 3..7 ride along on the scratch page."""
    out, tree = jax_side
    jb, leaves = out[dtype]
    pb, params = _port(dtype, tree)
    kv = default_paged_kv(pb, pb.run.shape)
    jkv = j_default_paged_kv(jb, jb.run.shape)
    assert kv == type(kv)(jkv.page_size, jkv.pages_per_replica,
                          jkv.max_pages_per_seq)
    jpre, jdec = jb.make_prefill_chunk_step(jkv), jb.make_paged_decode_step(jkv)
    pre, dec = pb.make_prefill_chunk_step(kv), pb.make_paged_decode_step(kv)
    jstate, state = jb.init_paged_state(jkv), pb.init_paged_state(kv)

    rng = np.random.default_rng(7)
    C = 16
    table = np.zeros((B, kv.max_pages_per_seq), np.int32)
    table[0, :2], table[1, :1], table[2, :3] = [1, 2], [3], [4, 5, 6]
    plens = {0: 20, 1: 7, 2: 33}
    prompts = {r: rng.integers(1, 256, (n,)).astype(np.int32)
               for r, n in plens.items()}
    tol = LOGIT_TOL[dtype]

    def run_both(jfn, fn, *args):
        nonlocal jstate, state
        jl, jstate = jfn(leaves, *(jnp.asarray(a) for a in args), jstate)
        tl, state = fn(params, *(torch.from_numpy(a) for a in args), state)
        return _np(jl), _np(tl)

    for start in (0, C):
        ids = np.zeros((B, C), np.int32)
        ptab = np.zeros_like(table)
        pos0 = np.zeros((B,), np.int32)
        last = np.zeros((B,), np.int32)
        rows = [r for r in plens if plens[r] > start]
        for r in rows:
            n = min(C, plens[r] - start)
            ids[r, :n] = prompts[r][start:start + n]
            ptab[r], pos0[r], last[r] = table[r], start, n - 1
        want, got = run_both(jpre, pre, ids, ptab, pos0, last)
        assert got.shape == (B, 256)
        np.testing.assert_allclose(got[rows], want[rows], rtol=tol, atol=tol)

    lengths = np.zeros((B,), np.int32)
    for r, n in plens.items():
        lengths[r] = n
    tok = np.zeros((B, 1), np.int32)
    tok[:3, 0] = rng.integers(1, 256, (3,))
    want, got = run_both(jdec, dec, tok, table, lengths)
    np.testing.assert_allclose(got[:3], want[:3], rtol=tol, atol=tol)
    # the live pages of every layer's pools hold the same K/V: within a
    # bf16 rounding step at fp32 compute, the logit bound at bf16
    ptol = 2e-2 if dtype == "float32" else tol
    for name in ("k", "v"):
        jp = np.asarray(jstate["pos0"]["attn"][name], np.float32)[:, 1:7]
        tp = state["pos0"]["attn"][name].float().numpy()[:, 1:7]
        np.testing.assert_allclose(tp, jp, rtol=ptol, atol=ptol)


_jax_argmax = jax.jit(lambda logits: jnp.argmax(logits, axis=-1)
                      .astype(jnp.int32))


@pytest.fixture(scope="module")
def served(jax_side):
    """The JAX engine and the port's engine on mixed_requests(seed=0),
    fp32, under both admission policies."""
    out, tree = jax_side
    jb, leaves = out["float32"]
    pb, params = _port("float32", tree)
    jkv = j_default_paged_kv(jb, jb.run.shape)
    kv = default_paged_kv(pb, pb.run.shape)
    reqs = mixed_requests(12, SEQ, 8, 256, seed=0)
    jreqs = j_mixed_requests(12, SEQ, 8, 256, seed=0)
    runs = {}
    jshare = None
    for policy in ("continuous", "static"):
        je = JEngine(jb, jkv, chunk=32, policy=policy, capture_logits=True,
                     share_steps_with=jshare)
        # the JAX greedy pick fails shard_map's replication check on a
        # mesh whose 'model' axis has size 1 (jax 0.9.0; only the tp > 1
        # branch's all-gather types its output replicated); at tp 1 it
        # is the plain argmax over the vocab, lowest index on ties
        je._pick = _jax_argmax
        jshare = jshare or je
        jres, _ = je.serve(leaves, list(jreqs))
        pe = PagedServeEngine(pb, kv, chunk=32, policy=policy,
                              capture_logits=True)
        pres, _ = pe.serve(params, list(reqs))
        runs[policy] = (je, jres, pe, pres)
    return reqs, jreqs, runs


def test_mixed_requests_same_workload(served):
    reqs, jreqs, _ = served
    assert len(reqs) == len(jreqs)
    for r, j in zip(reqs, jreqs):
        assert r.rid == j.rid and r.max_new_tokens == j.max_new_tokens
        np.testing.assert_array_equal(r.prompt, j.prompt)


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_engine_greedy_tokens_match_jax(policy, served):
    reqs, _, runs = served
    je, jres, pe, pres = runs[policy]
    assert pe.steps == je.steps
    assert pe.prefill_calls > 0 and pe.decode_calls > 0
    assert [r.rid for r in pres] == [r.rid for r in jres]   # same order
    want = {r.rid: r.tokens for r in jres}
    got = {r.rid: r.tokens for r in pres}
    assert got == want
    assert all(len(t) == 8 for t in got.values())
    for rid in want:
        assert len(pe.captured[rid]) == len(je.captured[rid])
        for a, b in zip(pe.captured[rid], je.captured[rid]):
            np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                       rtol=1e-3, atol=1e-3)
    # every page returns to the free list once drained
    assert all(a.n_free == pe.kv.pages_per_replica - 1 for a in pe.allocs)


def test_engine_rejects_a_request_that_cannot_fit(served):
    _, _, runs = served
    pe = runs["continuous"][2]
    with pytest.raises(ValueError, match="exceeds"):
        pe.serve(None, [Request(rid=99, prompt=np.ones((200,), np.int32),
                                max_new_tokens=9)])


def test_greedy_pick_ties_to_lowest_index():
    pb = _port_bundle("float32")
    pick = pb.make_greedy_pick()
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert pick(logits).tolist() == [1, 0]
    assert pick(logits).dtype == torch.int32
