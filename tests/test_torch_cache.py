"""The port's FCDP-Cache (``core/cache.py``: the memory accounting and
the planner), its device-cache fraction and its activation policies
against the JAX package's, on the CPU.

  * Analytic parity: ``cache_bytes_per_chip`` (every key, ``by_group``
    included) and ``stage1_dcn_gather_bytes`` equal the JAX functions'
    with ``==`` on ``tests/test_schedule.py``'s ``DENSE`` model (3
    layers, d_model 64, GQA 4/2, d_ff 128, vocab 256, qkv bias) under
    zero3, zeropp, fcdp, mics, hier, qwZ, depths 1-2, microbatch 2 with
    the async reduce and the cross-step carry, PEFT and the
    ``embed=hier, blocks.*.mlp.*=zero3`` composite, at (pod 2, data 2,
    model 2) and (data 4, model 2); ``kv_page_bytes_per_chip`` too.
  * Planner parity: one synthetic ``_peak`` (keyed on the fraction, the
    depth, the cross-step flag and the activation policy) in both
    packages; at every fit point of the JAX package's planner tests the
    two ``MemoryPlanner``s walk the same attempts and return the same
    ``CachePlan``.
  * Step runs: both packages train ``DENSE`` one step at (2, 2, 2) with
    ``min_shard_size=8`` from the JAX bundle's parameters, the JAX step
    on eight CPU devices (in a subprocess, XLA's excess precision off,
    as ``tests/test_torch_sched.py`` runs it), the port on eight gloo
    ranks (once per session behind ``shared_result``). Under each
    activation policy, fcdp, zero3, fcdp + ag_matmul, fcdp + the int8
    activation all-reduce, fcdp + qwZ/qgZ, and fcdp and zero3 at
    prefetch depth 2 (the recompute's weights from a ring slot) and at
    microbatch 2 under the async reduce (from the resident stage-1
    view) move every (op, axis) byte count of the JAX trace, but for
    the pinned divergences (``PINNED``), and are bit-equal to the
    port's save_all step of the same configuration; the device fraction
    (0, 0.5, 1.0 at depths 0 and 2) and ``host_offload=False`` are
    bit-equal to fraction 0 and move the measured caches between the
    tiers by the promoted layers' ``cached_bytes_for``.
  * hier with the MLP projections 'inter_only' widens them over two axes
    ('data', 'pod'): the port's per-axis reduce-scatter and gather back
    count what the JAX package's one multi-axis reduce-scatter counts
    (its hierarchical attribution), but for the pinned double sums.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      RunConfig, ShapeCell, SystemConfig)
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.train import ModeRun, TrainJob, spawn

DENSE = dict(name="t-dense", family="dense", num_layers=3, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             qkv_bias=True)
SEQ, BATCH = 64, 8
AXES = ("pod", "data", "model")
MESH3 = MeshShape(AXES, (2, 2, 2))
MESH2 = MeshShape(("data", "model"), (4, 2))
OPT = dict(total_steps=8, warmup_steps=2, lr=1e-3)
LOSS_RTOL, GNORM_RTOL = 1e-4, 1e-3
PARAM_TOL = dict(rtol=2e-2, atol=2e-3)
INT8 = "int8_pod"
POLICIES = ("save_all", "block_io", "offload_acts", "save_collectives")
COMPOSITE = (("embed", "hier"), ("blocks.*.mlp.*", "zero3"))


def mlp_inter_only(defs):
    """The stack's MLP projections sharded over 'pod' only (the same
    transform as ``tests/test_torch_sched.py``'s)."""
    def walk(tree, in_mlp):
        return {k: (walk(v, in_mlp or k == "mlp") if isinstance(v, dict)
                    else dataclasses.replace(v, fsdp_scope="inter_only")
                    if in_mlp and k.startswith("w_") else v)
                for k, v in tree.items()}
    return walk(defs, False)


# -- the configurations of either package -----------------------------------

def _system(pkg, **kw):
    """``pkg``'s SystemConfig with ``min_shard_size=8`` and ``kw``; the
    JAX package's kernels on their plain paths."""
    import importlib
    base = importlib.import_module(f"{pkg}.configs.base")
    kw = dict(kw)
    dtype = kw.pop("dtype", "bfloat16")
    if pkg == "repro":
        kw.update(quant_impl="jnp", fused_impl="jnp", param_dtype=dtype,
                  compute_dtype=dtype)
    else:
        kw["dtype"] = dtype
    return base.SystemConfig(min_shard_size=8, **kw)


def _run(pkg, system, microbatch=0, kind="train"):
    import importlib
    base = importlib.import_module(f"{pkg}.configs.base")
    return base.RunConfig(model=base.ModelConfig(**DENSE),
                          shape=base.ShapeCell("t", kind, SEQ, BATCH),
                          system=system,
                          optimizer=base.OptimizerConfig(**OPT),
                          microbatch=microbatch)


def _bundles(spec, jmesh, mesh, kind="train"):
    """The JAX and the port bundle of one configuration."""
    from repro.core.engine import StepBundle as JStepBundle
    from repro_torch.core.engine import StepBundle
    spec = dict(spec)
    mb = spec.pop("microbatch", 0)
    defs_fn = spec.pop("defs_fn", None)
    jb = JStepBundle(_run("repro", _system("repro", **spec), mb, kind),
                     jmesh, defs_fn=defs_fn)
    pb = StepBundle(_run("repro_torch", _system("repro_torch", **spec), mb,
                         kind), device="cpu", mesh=mesh, defs_fn=defs_fn)
    return jb, pb


# -- analytic parity -------------------------------------------------------

ANALYTIC = {
    "zero3": dict(mode="zero3"), "zeropp": dict(mode="zeropp"),
    "fcdp": dict(mode="fcdp"), "mics": dict(mode="mics"),
    "hier": dict(mode="hier"),
    "fcdp_q8": dict(mode="fcdp", param_compress=INT8, grad_compress=INT8),
    "zero3_q8": dict(mode="zero3", param_compress=INT8),
    "fcdp_d1": dict(mode="fcdp", prefetch_depth=1),
    "fcdp_d2": dict(mode="fcdp", prefetch_depth=2),
    "zero3_d2": dict(mode="zero3", prefetch_depth=2),
    "fcdp_async": dict(mode="fcdp", microbatch=2, async_grad_reduce=True),
    "fcdp_xstep": dict(mode="fcdp", microbatch=2, async_grad_reduce=True,
                       cross_step_pipeline=True, prefetch_depth=2),
    "zero3_async": dict(mode="zero3", microbatch=2, async_grad_reduce=True),
    "fcdp_peft": dict(mode="fcdp", peft=True),
    "zero3_peft": dict(mode="zero3", peft=True),
    "composite": dict(mode="fcdp", mode_overrides=COMPOSITE),
    "fcdp_frac1": dict(mode="fcdp", device_cache_fraction=1.0),
    "fcdp_no_offload": dict(mode="fcdp", host_offload=False),
    "hier_inter": dict(mode="hier", defs_fn=mlp_inter_only),
}
# the JAX trace's figures (fcdp at (2, 2, 2)): the cache, the stage-1
# wire bytes, qwZ's
FCDP_HOST, FCDP_DCN, FCDP_Q8_DCN = 78272, 39136, 19984


@pytest.fixture(params=["mesh3", "mesh2"])
def meshes(request):
    return (request.getfixturevalue(request.param),
            MESH3 if request.param == "mesh3" else MESH2, request.param)


@pytest.mark.parametrize("cid", list(ANALYTIC))
def test_cache_bytes_match_jax(meshes, cid):
    """``cache_bytes_per_chip`` and ``stage1_dcn_gather_bytes`` equal the
    JAX package's, every key, ``by_group`` included."""
    from repro.core import cache as jc
    from repro_torch.core import cache as pc
    jmesh, mesh, name = meshes
    jb, pb = _bundles(ANALYTIC[cid], jmesh, mesh)
    got, want = pc.cache_bytes_per_chip(pb), jc.cache_bytes_per_chip(jb)
    assert got == want, (cid, name)
    assert pc.stage1_dcn_gather_bytes(pb) == jc.stage1_dcn_gather_bytes(jb)
    if cid in ("fcdp", "fcdp_frac1", "fcdp_no_offload") \
            and name == "mesh3":
        # the fraction and host_offload do not move the analytic figures
        assert (got["host_cache_bytes_per_chip"],
                got["cached_bytes_per_chip"],
                got["stage1_dcn_gather_bytes_per_chip"]) \
            == (FCDP_HOST, FCDP_HOST, FCDP_DCN)
    if cid == "fcdp_q8" and name == "mesh3":
        assert (got["stage1_dcn_gather_bytes_per_chip"],
                got["stage1_dcn_gather_bytes_exact"]) == (FCDP_Q8_DCN,
                                                          FCDP_DCN)


@pytest.mark.parametrize("pages", [33, 66])
def test_kv_page_bytes_match_jax(meshes, pages):
    """``kv_page_bytes_per_chip`` and the accounting's KV tenant equal
    the JAX package's on a decode cell's bundle."""
    from repro.core import cache as jc
    from repro.core.kv_cache import PagedKVConfig as JKV
    from repro.core.kv_cache import kv_page_bytes_per_chip as jkv
    from repro_torch.core import cache as pc
    from repro_torch.core.kv_cache import PagedKVConfig, kv_page_bytes_per_chip
    jmesh, mesh, _ = meshes
    jb, pb = _bundles(dict(mode="fcdp"), jmesh, mesh, kind="decode")
    kv = dict(page_size=16, pages_per_replica=pages, max_pages_per_seq=4)
    got = kv_page_bytes_per_chip(pb.run.model, mesh, pb.model.plan,
                                 pb.model.n_groups, PagedKVConfig(**kv))
    want = jkv(jb.run.model, jb.mi, jb.model.plan, jb.model.n_groups,
               JKV(**kv))
    assert got == want > 0
    assert pc.cache_bytes_per_chip(pb, kv=PagedKVConfig(**kv)) \
        == jc.cache_bytes_per_chip(jb, kv=JKV(**kv))


# -- planner parity ----------------------------------------------------------

def _synthetic(sysc, kv=None) -> int:
    """The synthetic peak both packages' planners read: larger with the
    fraction, the depth, the cross-step carry and the pool, block_io
    half of save_all's."""
    peak = (1000 + int(100 * sysc.device_cache_fraction)
            + 10 * sysc.prefetch_depth + 5 * sysc.cross_step_pipeline)
    if kv is not None:
        peak += kv.pages_per_replica
    return peak // 2 if sysc.activation_policy == "block_io" else peak


def _planner(pkg, fit, **kw):
    """``pkg``'s MemoryPlanner with the synthetic peak; a configuration
    in ``fit`` ((fraction, depth, cross-step, policy)) peaks at 0."""
    import importlib
    base = importlib.import_module(f"{pkg}.core.cache").MemoryPlanner
    if pkg == "repro_torch":
        kw["device"] = "cpu"

    class Synthetic(base):
        def _peak(self, bundle):
            s = bundle.run.system
            key = (s.device_cache_fraction, s.prefetch_depth,
                   s.cross_step_pipeline, s.activation_policy)
            return 0 if key in fit else _synthetic(s)

        def _peak_serve(self, bundle, kv):
            return _synthetic(bundle.run.system, kv)
    return Synthetic(**kw)


PLANS = {
    # tests/test_schedule.py:250
    "depth_then_fraction": (dict(prefetch_depth=2), 0, (1.0, 0.0),
                            {(1.0, 0, False, "save_all")}, 500),
    "fits_at_full_depth": (dict(prefetch_depth=2), 0, (1.0, 0.0),
                           {(1.0, 2, False, "save_all")}, 500),
    "fraction_walk": (dict(), 0, (1.0, 0.0),
                      {(0.0, 0, False, "save_all")}, 500),
    # tests/test_cross_step.py:225
    "cross_step_first": (dict(prefetch_depth=2, async_grad_reduce=True,
                              cross_step_pipeline=True), 2, (1.0, 0.0),
                         {(1.0, 2, False, "save_all")}, 500),
    "keeps_cross_step": (dict(prefetch_depth=2, async_grad_reduce=True,
                              cross_step_pipeline=True), 2, (1.0, 0.0),
                         {(1.0, 2, True, "save_all")}, 500),
    # tests/test_planner_roofline.py:18-60
    "generous": (dict(), 0, (1.0, 0.0), set(), 1 << 40),
    "impossible": (dict(), 0, (1.0, 0.0), set(), 1),
    "block_io_fallback": (dict(), 0, (0.0,), set(), 750),
    "zero3_impossible": (dict(mode="zero3", prefetch_depth=1), 0,
                         (1.0, 0.5, 0.25, 0.0), set(), 1),
    "host_budget": (dict(), 0, (1.0, 0.0), set(), 1 << 40),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_planner_matches_jax(mesh3, case):
    """Under one synthetic peak both planners walk the same attempts
    (every key of every iteration) and return the same ``CachePlan``."""
    extra, mb, fractions, fit, budget = PLANS[case]
    sys_kw = dict(dict(mode="fcdp"), **extra)
    host = 1 if case == "host_budget" else None
    plans = {}
    for pkg, mesh in (("repro", mesh3), ("repro_torch", MESH3)):
        run = _run(pkg, _system(pkg, **sys_kw), mb)
        planner = _planner(pkg, fit, hbm_budget=budget, host_budget=host)
        plans[pkg] = dataclasses.asdict(planner.plan(run, mesh, fractions))
    assert plans["repro_torch"] == plans["repro"], case
    got = plans["repro_torch"]
    if case == "depth_then_fraction":
        assert [(i["device_fraction"], i["prefetch_depth"])
                for i in got["iterations"]] == [(1.0, 2), (1.0, 1), (1.0, 0)]
    if case == "cross_step_first":
        assert not got["cross_step"] and len(got["iterations"]) == 2
    if case == "impossible":
        assert not got["fits"] and len(got["iterations"]) == 3
        assert got["iterations"][-1]["activation_policy"] == "block_io"
    if case == "block_io_fallback":
        assert got["fits"] and got["activation_policy"] == "block_io"


@pytest.mark.parametrize("case", ["generous", "impossible"])
def test_plan_serve_matches_jax(mesh3, case):
    """``plan_serve`` walks the JAX package's attempts (the pool halved
    last, down to one sequence and the scratch page) and returns its
    plan."""
    plans = {}
    for pkg, mesh in (("repro", mesh3), ("repro_torch", MESH3)):
        import importlib
        kvm = importlib.import_module(f"{pkg}.core.kv_cache")
        kv = kvm.PagedKVConfig(page_size=16, pages_per_replica=33,
                               max_pages_per_seq=4)
        run = _run(pkg, _system(pkg, mode="fcdp"), kind="decode")
        budget = 1 << 40 if case == "generous" else 1
        planner = _planner(pkg, set(), hbm_budget=budget)
        plans[pkg] = dataclasses.asdict(planner.plan_serve(
            run, mesh, kv, fractions=(1.0,) if case == "generous"
            else (0.0,)))
    assert plans["repro_torch"] == plans["repro"]
    pools = [i["kv_pages"] for i in plans["repro_torch"]["iterations"]]
    assert pools == sorted(pools, reverse=True)
    if case == "impossible":
        assert pools[0] == 33 and pools[-1] == 5


def test_budget_required_off_the_card():
    """The device budget defaults to the card's memory; off a CUDA
    device there is none to read, and the planner asks for it."""
    from repro_torch.core.cache import MemoryPlanner
    with pytest.raises(ValueError, match="hbm_budget"):
        MemoryPlanner(device="cpu")
    assert MemoryPlanner(hbm_budget=5, device="cpu").hbm == 5


def test_peak_reads_no_allocator_on_the_cpu():
    """On the CPU there is no allocator to read: the planner raises,
    and never makes a figure up."""
    from repro_torch.core.cache import MemoryPlanner
    from repro_torch.core.engine import StepBundle
    run = _run("repro_torch", _system("repro_torch", mode="fcdp"))
    b = StepBundle(run, device="cpu", mesh=MESH3)
    with pytest.raises(RuntimeError, match="allocator"):
        MemoryPlanner(hbm_budget=1, device="cpu")._peak(b)


def test_config_validation_matches_jax():
    """The fraction's range and the policy's name are checked with the
    reference's messages (``tests/test_schedule.py:64-73``)."""
    import importlib
    for kw in (dict(device_cache_fraction=1.5),
               dict(device_cache_fraction=-0.1),
               dict(activation_policy="bogus")):
        msgs = []
        for pkg in ("repro", "repro_torch"):
            base = importlib.import_module(f"{pkg}.configs.base")
            with pytest.raises(ValueError) as e:
                base.SystemConfig(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    from repro.configs.base import ACTIVATION_POLICIES as J
    from repro_torch.configs.base import ACTIVATION_POLICIES as P
    assert J == P == POLICIES


@pytest.mark.parametrize("mode", ["zero3", "zeropp", "fcdp", "mics", "hier",
                                  "fcdp+mics", "mics+hier"])
def test_device_cache_groups_match_jax(mode):
    """The fraction applies under fcdp only, and to a composite when any
    group is fcdp (``tests/test_strategy.py:144-148``)."""
    import importlib
    got = []
    for pkg in ("repro", "repro_torch"):
        st = importlib.import_module(f"{pkg}.core.strategy")
        if "+" in mode:
            names = mode.split("+")
            s = st.CompositeStrategy(st.get_strategy(names[0]),
                                     {n: st.get_strategy(n) for n in names})
        else:
            s = st.get_strategy(mode)
        got.append([s.supports_device_cache]
                   + [s.device_cache_groups(n, f) for n in (3, 8)
                      for f in (0.0, 0.25, 0.5, 1.0)])
    assert got[0] == got[1]
    assert got[1][0] == ("fcdp" in mode)


# -- step runs: the JAX reference (run in a subprocess) ------------------------

ROWS = {"fcdp": dict(mode="fcdp"), "zero3": dict(mode="zero3"),
        "fcdp_ag": dict(mode="fcdp", fused_matmul="ag_matmul"),
        "fcdp_act8": dict(mode="fcdp", act_psum="int8"),
        "fcdp_q8": dict(mode="fcdp", param_compress=INT8,
                        grad_compress=INT8),
        # the recompute's weights from a ring slot and from the resident
        # stage-1 view (stream 2)
        "fcdp_d2": dict(mode="fcdp", prefetch_depth=2),
        "zero3_d2": dict(mode="zero3", prefetch_depth=2),
        "fcdp_async": dict(mode="fcdp", microbatch=2, async_grad_reduce=True),
        "zero3_async": dict(mode="zero3", microbatch=2,
                            async_grad_reduce=True)}
INT8_ROWS = ("fcdp_act8", "fcdp_q8")
RUNS = {f"{row}_{pol}": ModeRun(**kw, activation_policy=pol)
        for row, kw in ROWS.items() for pol in POLICIES}
FRACTIONS = (0.0, 0.5, 1.0)
for _d in (0, 2):
    for _f in FRACTIONS:
        RUNS[f"fcdp_f{_f}_d{_d}"] = ModeRun("fcdp", prefetch_depth=_d,
                                            device_cache_fraction=_f)
for _m in ("zero3", "zeropp"):
    for _f in (0.0, 0.5):
        RUNS[f"{_m}_f{_f}"] = ModeRun(_m, device_cache_fraction=_f)
RUNS["fcdp_no_offload"] = ModeRun("fcdp", host_offload=False)
RUNS["fcdp_no_offload_f0.5"] = ModeRun("fcdp", host_offload=False,
                                       device_cache_fraction=0.5)
RUNS["hier_inter"] = ModeRun("hier", defs_fn=mlp_inter_only)
# the int8 rows held to the JAX step in fp32 (their bf16 roundings part)
for _row in INT8_ROWS:
    for _pol in ("save_all", "block_io"):
        RUNS[f"{_row}_{_pol}_f32"] = ModeRun(
            **ROWS[_row], activation_policy=_pol, dtype="float32")

# the pinned divergences: (run, op/axis) -> (JAX bytes, port bytes)
#  * the JAX remat recomputes the int8 activation all-reduce under
#    every policy; the port keeps its output under save_all and
#    save_collectives and recomputes it under block_io / offload_acts
#  * hier sums the widened 'inter_only' leaves' gradients over 'data'
#    and 'pod' twice (ROADMAP Queue 3)
ACT8_KEEP = {"all_to_all/model": (62400, 49920),
             "all_gather/model": (62400, 49920)}
PINNED = {("hier_inter", "psum/data"): (74320, 592),
          ("hier_inter", "psum/pod"): (120871, 295)}
for _rid in ("fcdp_act8_save_all", "fcdp_act8_save_collectives",
             "fcdp_act8_save_all_f32"):
    for _k, _v in ACT8_KEEP.items():
        PINNED[_rid, _k] = _v


def make_batch(seed=0):
    """``tests/test_schedule.py:make_batch`` as numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(1, 256, (BATCH, SEQ)).astype(np.int32)
    return {"ids": ids, "labels": labels, "mask": np.ones_like(labels, bool)}


def _jax_bundle(mr):
    from repro.core.engine import StepBundle as JStepBundle
    from repro.launch.mesh import make_mesh
    sysc = _system("repro", mode=mr.mode, param_compress=mr.param_compress,
                   grad_compress=mr.grad_compress,
                   fused_matmul=mr.fused_matmul, act_psum=mr.act_psum,
                   prefetch_depth=mr.prefetch_depth, dtype=mr.dtype,
                   async_grad_reduce=mr.async_grad_reduce,
                   device_cache_fraction=mr.device_cache_fraction,
                   activation_policy=mr.activation_policy,
                   host_offload=mr.host_offload)
    return JStepBundle(_run("repro", sysc, mr.microbatch),
                       make_mesh((2, 2, 2), AXES), defs_fn=mr.defs_fn)


def _jax_run(mr, batch):
    """The bytes per (op, axis) of the step, traced on its arrays, its
    analytic accounting and, executed, the metrics of the first step."""
    import functools

    import jax
    from repro.core.cache import cache_bytes_per_chip
    from repro.launch.roofline import collect_collectives
    from repro.optim.adamw import init_opt_state
    b = _jax_bundle(mr)
    tp, fp = b.split(b.init_all_params(seed=0))
    tp = [jax.device_put(x.astype(mr.dtype), x.sharding) for x in tp]
    fp = [jax.device_put(x.astype(mr.dtype), x.sharding) for x in fp]
    ost = jax.jit(functools.partial(init_opt_state, sys=b.run.system))(tp)
    step = b.make_train_step()
    stats = collect_collectives(step.trace(tp, fp, ost, batch).jaxpr,
                                {a: b.mi.size(a) for a in b.mi.axis_names})
    out = {"bytes": {k: v for k, v in stats.by_op_axis.items() if v},
           "accounting": cache_bytes_per_chip(b)}
    _, _, m = step(tp, fp, ost, batch)
    out["metrics"] = {k: float(v) for k, v in m.items()}
    return out


PARTS = 3                    # reference processes


def _jax_init():
    import jax
    b = _jax_bundle(RUNS["fcdp_save_all"])
    return jax.tree.unflatten(b.treedef, [np.asarray(x) for x in
                                          b.init_all_params(seed=0)])


def _reference(part, init_path=None):
    """Part ``part`` of the JAX runs; part 0 first writes the initial
    parameter tree to ``init_path``."""
    if init_path:
        with open(init_path + ".part", "wb") as f:
            pickle.dump(_jax_init(), f)
        os.rename(init_path + ".part", init_path)
    batch = make_batch()
    return {rid: _jax_run(RUNS[rid], batch) for rid in list(RUNS)[part::PARTS]}


def _start_reference(tmp, part):
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    out = os.path.join(tmp, f"cache_reference_{part}.pickle")
    init = os.path.join(tmp, "cache_init.pickle") if part == 0 else ""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    code = ("import pickle, sys, test_torch_cache as t; "
            "pickle.dump(t._reference(int(sys.argv[2]), sys.argv[3]), "
            "open(sys.argv[1], 'wb'))")
    proc = subprocess.Popen([sys.executable, "-c", code, out, str(part),
                             init], env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    return proc, out, init


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


def _wait_for(path, proc):
    """The pickle at ``path``, once the process writing it has."""
    import time
    while not os.path.exists(path):
        if proc.poll() is not None:
            _finish_reference(proc, path)       # raises with its errors
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


# -- the port: eight gloo ranks -------------------------------------------------

def _compute(tmp_path_factory):
    """The reference in PARTS processes; the port's ranks start once the
    first has written the initial parameters."""
    tmp = str(tmp_path_factory.mktemp("cache"))
    procs = [_start_reference(tmp, k) for k in range(PARTS)]
    try:
        init = _wait_for(procs[0][2], procs[0][0])
        job = TrainJob(
            run=RunConfig(model=ModelConfig(**DENSE),
                          shape=ShapeCell("t", "train", SEQ, BATCH),
                          system=SystemConfig(min_shard_size=8),
                          optimizer=OptimizerConfig(**OPT)),
            mesh=MESH3, runs=list(RUNS.values()), device="cpu",
            params=init, batches=[make_batch()], return_params=True)
        ranks = spawn(job, tmp, timeout_s=900)
        port = {rid: [rk["runs"][i] for rk in ranks]
                for i, rid in enumerate(RUNS)}
        ref = {}
        for proc, out, _ in procs:
            ref.update(_finish_reference(proc, out))
    except BaseException:
        for proc, _, _ in procs:
            proc.kill()
            proc.wait()
        raise
    return {"ref": ref, "port": port}


@pytest.fixture(scope="module")
def cache_runs(tmp_path_factory):
    from test_torch_train import shared_result
    return shared_result(tmp_path_factory, "torch_cache_runs",
                         lambda: _compute(tmp_path_factory))


def _params(ranks):
    from test_torch_train import assemble
    import torch
    specs = ranks[0]["specs"]
    return {path: assemble({r: torch.from_numpy(res["params"][path])
                            for r, res in enumerate(ranks)},
                           specs[path], MESH3).numpy()
            for path in specs}


def _bit_equal(a, b, what):
    """Two port runs: equal metrics on every rank, equal updated shards
    (a SHA-256 a rank) and parameters, bit for bit."""
    assert [r["metrics"] for r in a] == [r["metrics"] for r in b], what
    assert [r["final_digest"] for r in a] \
        == [r["final_digest"] for r in b], what
    pa, pb = _params(a), _params(b)
    for path in pa:
        np.testing.assert_array_equal(pa[path], pb[path],
                                      err_msg=f"{what} {path}")


# -- step runs: bytes -------------------------------------------------------

@pytest.mark.parametrize("rid", list(RUNS))
def test_bytes_match_jax(cache_runs, rid):
    """Every (op, axis) byte count of every rank equals the JAX trace,
    but for the pinned divergences."""
    want = dict(cache_runs["ref"][rid]["bytes"])
    for (r, key), (jax_b, port_b) in PINNED.items():
        if r == rid:
            assert want[key] == jax_b, (rid, key, want[key])
            want[key] = port_b
    for rank, r in enumerate(cache_runs["port"][rid]):
        assert r["bytes"] == [want], (rid, rank)


@pytest.mark.parametrize("rid", list(RUNS))
def test_accounting_matches_jax(cache_runs, rid):
    """Each run's ``cache_bytes_per_chip`` equals the JAX bundle's."""
    want = cache_runs["ref"][rid]["accounting"]
    for r in cache_runs["port"][rid]:
        assert r["cache_accounting"] == want, rid


def test_int8_act_divergence_vanishes_under_block_io(cache_runs):
    """The JAX remat recomputes the int8 activation all-reduce under
    every policy; the port does under block_io and offload_acts, where
    its 'model' bytes equal the reference's, and keeps the output under
    save_all and save_collectives (PINNED)."""
    ref, port = cache_runs["ref"], cache_runs["port"]
    for pol in POLICIES:
        rid = f"fcdp_act8_{pol}"
        got = port[rid][0]["bytes"][0]
        for key, (jax_b, port_b) in ACT8_KEEP.items():
            assert ref[rid]["bytes"][key] == jax_b
            assert got[key] == (jax_b if pol in ("block_io", "offload_acts")
                                else port_b), (rid, key)


@pytest.mark.parametrize("row", list(ROWS))
def test_recompute_issues_no_stage1_gather(cache_runs, row):
    """No policy adds a stage-1 ('pod') gather: every policy's 'pod'
    bytes equal save_all's; block_io and offload_acts re-run only the
    layers' 'model' sums (and, under ag_matmul, the fused ring over
    'data')."""
    port = cache_runs["port"]
    base = port[f"{row}_save_all"][0]["bytes"][0]
    for pol in POLICIES[1:]:
        got = port[f"{row}_{pol}"][0]["bytes"][0]
        assert {k: v for k, v in got.items() if k.endswith("/pod")} \
            == {k: v for k, v in base.items() if k.endswith("/pod")}, pol
        assert got["all_gather/data"] == base["all_gather/data"], pol
    if row != "fcdp_act8":
        assert port[f"{row}_block_io"][0]["bytes"][0]["psum/model"] \
            > base["psum/model"]
        assert port[f"{row}_save_collectives"][0]["bytes"][0] \
            ["psum/model"] == base["psum/model"]
    if row == "fcdp_ag":
        assert port["fcdp_ag_block_io"][0]["bytes"][0]["ppermute/data"] \
            > base["ppermute/data"]
        assert port["fcdp_ag_save_collectives"][0]["bytes"][0] \
            ["ppermute/data"] == base["ppermute/data"]


# -- step runs: values ----------------------------------------------------------

HELD = [rid for rid in RUNS
        if not rid.startswith(INT8_ROWS) or rid.endswith("_f32")]


@pytest.mark.parametrize("rid", HELD)
def test_step_matches_jax(cache_runs, rid):
    """The first step's loss and grad norm equal the JAX step's (hier
    with the 'inter_only' MLP: the JAX zero3 step's, the reference's
    double sum aside)."""
    ref = cache_runs["ref"]["zero3_save_all" if rid == "hier_inter"
                            else rid]["metrics"]
    for r in cache_runs["port"][rid]:
        m = r["metrics"][0]
        np.testing.assert_allclose(m["loss"], ref["loss"], rtol=LOSS_RTOL,
                                   err_msg=rid)
        np.testing.assert_allclose(m["grad_norm"], ref["grad_norm"],
                                   rtol=GNORM_RTOL, err_msg=rid)


@pytest.mark.parametrize("row", list(ROWS))
@pytest.mark.parametrize("pol", POLICIES[1:])
def test_policy_bit_equal_to_save_all(cache_runs, row, pol):
    """Every policy recomputes the same values: losses, grad norms and
    updated shards equal save_all's bit for bit."""
    port = cache_runs["port"]
    _bit_equal(port[f"{row}_{pol}"], port[f"{row}_save_all"], f"{row} {pol}")


@pytest.mark.parametrize("row", list(ROWS))
def test_offload_acts_is_block_io(cache_runs, row):
    """offload_acts is block_io, in bytes and in bits, as in the JAX
    package (no value carries the mark it would offload)."""
    port, ref = cache_runs["port"], cache_runs["ref"]
    a, b = port[f"{row}_offload_acts"], port[f"{row}_block_io"]
    _bit_equal(a, b, row)
    assert [r["bytes"] for r in a] == [r["bytes"] for r in b]
    assert ref[f"{row}_offload_acts"]["bytes"] \
        == ref[f"{row}_block_io"]["bytes"]


@pytest.mark.parametrize("rid", [r for r in RUNS if r.startswith(
    ("fcdp_ag_", "fcdp_act8_", "fcdp_q8_"))])
def test_launches_match_the_plans(cache_runs, rid):
    """The int8 trio and the chunk matmul are called as the extended
    plans say: block_io and offload_acts run the activation all-reduce
    and the fused ring of wo again (not the layer's last sublayer's,
    w_out's, whose product the recompute never reads); save_collectives
    at tp 2 runs no ring again (it keeps the all-reduces the rings
    feed)."""
    for r in cache_runs["port"][rid]:
        assert r["calls"] == [r["int8_plan"]], rid
        assert r["mm_calls"] == [r["mm_plan"]], rid
        assert r["launches"] == [{k: 0 for k in r["int8_plan"]}]
    r = cache_runs["port"][rid][0]
    if rid.startswith("fcdp_ag_"):
        # 2 fused leaves (wo, w_out) x 3 layers x 2 chunks a ring, and
        # wo's ring again in the recompute
        again = rid.endswith(("block_io", "offload_acts"))
        assert r["mm_plan"] == 12 + 6 * again, rid
    if rid.startswith("fcdp_act8_") and not rid.endswith("_f32"):
        pol = rid[len("fcdp_act8_"):]
        # a forward and a backward all-reduce a sublayer; the recompute
        # runs the attention's again (not the layer's last, the MLP's)
        per = 5 if pol in ("block_io", "offload_acts") else 4
        assert r["int8_plan"]["dequantize"] == per * 3, rid


# -- the device fraction and host offload ------------------------------------------

def _layer_cached(rid):
    """Per layer, the stage-1 cache bytes of the stack's leaves (the
    port's ``cached_bytes_for``, bf16)."""
    from repro_torch.core.engine import StepBundle
    mr = RUNS[rid]
    sysc = SystemConfig(mode=mr.mode, min_shard_size=8)
    b = StepBundle(RunConfig(model=ModelConfig(**DENSE),
                             shape=ShapeCell("t", "train", SEQ, BATCH),
                             system=sysc, optimizer=OptimizerConfig(**OPT)),
                   device="cpu", mesh=MESH3)
    total = sum(b.strategy.cached_bytes_for(d, p, MESH3)
                for d, p in zip(b.def_leaves, b.plan_leaves)
                if d.label.startswith("blocks."))
    return total / DENSE["num_layers"]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("frac", FRACTIONS)
def test_fraction_moves_caches_between_tiers(cache_runs, frac, depth):
    """At fraction f the stack's leading round(3 f) layers keep their
    stage-1 caches on the device: the measured tiers move by exactly
    those layers' ``cached_bytes_for``; the step is bit-equal to
    fraction 0 and moves the same bytes; the analytic host bytes stay
    the reference's (it does not read the fraction)."""
    port = cache_runs["port"]
    rid = f"fcdp_f{frac}_d{depth}"
    n_dev = int(round(frac * DENSE["num_layers"]))
    per = _layer_cached(rid)
    for r in port[rid]:
        cached = r["cached"][0]
        assert cached.get("device", 0) == n_dev * per, (rid, cached)
        assert cached.get("host", 0) \
            == (DENSE["num_layers"] - n_dev) * per, (rid, cached)
        assert r["cache_accounting"]["host_cache_bytes_per_chip"] \
            == FCDP_HOST
    _bit_equal(port[rid], port["fcdp_f0.0_d0"], rid)
    assert port[rid][0]["bytes"] == port["fcdp_f0.0_d0"][0]["bytes"]
    # the ring starts again at the segment boundary: a segment shorter
    # than k caps its own depth, the longest sets the live depth
    segs = [n for n in (n_dev, DENSE["num_layers"] - n_dev) if n]
    assert port[rid][0]["live_depth"] == [max(min(depth, n) for n in segs)]


@pytest.mark.parametrize("mode", ["zero3", "zeropp"])
def test_fraction_ignored_outside_fcdp(cache_runs, mode):
    """zero3 and zeropp ignore the fraction: the same caches, bytes and
    bits."""
    port = cache_runs["port"]
    a, b = port[f"{mode}_f0.5"], port[f"{mode}_f0.0"]
    _bit_equal(a, b, mode)
    assert [r["cached"] for r in a] == [r["cached"] for r in b]
    assert [r["bytes"] for r in a] == [r["bytes"] for r in b]


@pytest.mark.parametrize("rid", ["fcdp_no_offload", "fcdp_no_offload_f0.5"])
def test_host_offload_false_keeps_caches_on_the_device(cache_runs, rid):
    """``host_offload=False``: every cache on the device, as many bytes
    as fcdp parks on the host, bit-equal to fcdp."""
    port = cache_runs["port"]
    host = port["fcdp_f0.0_d0"][0]["cached"][0]["host"]
    for r in port[rid]:
        assert r["cached"][0] == {"device": host}
    _bit_equal(port[rid], port["fcdp_f0.0_d0"], rid)


# -- the two-axis widening ------------------------------------------------------

def test_hier_inter_only_widens_over_two_axes(cache_runs):
    """hier with the MLP projections 'inter_only' stores them
    replicated and widens their optimizer state over ('data', 'pod'):
    the epilogue's reduce-scatter over 'data' then 'pod' and its gather
    back count what the JAX package's one multi-axis reduce-scatter
    counts (the ICI axis the whole payload, 'pod' what is left), so
    every (op, axis) key but the pinned double sums equals the trace
    (``test_bytes_match_jax[hier_inter]``); the step equals the port's
    zero3 within the step tolerances."""
    port = cache_runs["port"]
    r0 = port["hier_inter"][0]
    assert {tuple(v) for k, v in r0["widened"].items() if ".mlp.w_" in k} \
        == {("data", "pod")}
    m, m0 = r0["metrics"][0], port["zero3_save_all"][0]["metrics"][0]
    np.testing.assert_allclose(m["loss"], m0["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"], m0["grad_norm"],
                               rtol=GNORM_RTOL)
