"""The port's dry run (``launch/dryrun.py``: one rank's train step on fake
tensors over a collective with no wire) against the JAX package's dry
run, on the CPU.

The JAX side runs in two subprocesses, each once per session with its
part of the port's rows (``shared_result``, two parts that two workers
compute at once): one on 8 forced host devices, one on 512. It traces
each step as the JAX dry run does (``dryrun_cell``'s configuration, then
``collect_collectives`` and ``flops_bytes_from_jaxpr`` on the trace,
``cache_bytes_per_chip`` on the bundle) without compiling it; two cases
also go through the JAX ``dryrun_cell`` itself, compile included, which
the trace-only rows must equal.

Held, with the tolerances stated:

  * the (2, 2, 2) toy (``tests/test_cross_step.py``'s DENSE and MOE on
    its CELL, ``min_shard_size`` 8, ``loss_chunk`` 0, the dry run's
    block_io) under zero3, zeropp, fcdp, mics and hier at ring depths 0
    and 1, fcdp with qwZ/qgZ, PEFT under fcdp and zero3, the fused
    ag_matmul, and one case on the dry run's own ``loss_chunk`` 2048:
    every (op, axis) byte count, ``stage1_dcn_gather_bytes_*``,
    ``cache_by_group`` and the buffer bytes equal exactly; hier's
    ``psum/pod`` is pinned (the JAX hier step sums its gradient over
    'pod' twice, a fault of the reference the port does not copy, see
    ``tests/test_torch_sched.py``); ``flops_per_chip`` within 2 %, by the
    two terms named below;
  * the narrow config at (2, 16, 16) (16 heads of 16, d_model 256, d_ff
    512, vocab 1024, seq 64, batch 64): every (op, axis) equal, zero3's
    ``all_gather/pod`` 63,696 B and fcdp's 32,880;
  * qwen2.5-3b's widths at ``train_4k`` on (2, 16, 16), cut to 4 layers
    (the whole model's four fake steps take ~150 s; ``chip_smoke.py``'s
    dryrun phase holds the 36 layers to the JAX trace's numbers), under
    zero3, fcdp, zero3 + PEFT and fcdp + PEFT at depth 0: every (op, axis)
    equal; FLOPs within 2 %: the port's are 1.7 % above at 4 layers (1.2 %
    at 36), by exactly two named terms (``_flops_terms``): each layer's
    output projection (w_out), which the port's block_io recompute runs
    again and the JAX remat drops (its output is not read), less the
    JAX attention's QK and PV forward, run again inside its chunk
    scan's backward (the toy's FLOPs differ by the same terms, and under
    the fused ring by the JAX backward's replay of each fused
    projection's forward);
  * every arch's full widths at (2, 16, 16), 2 layers (jamba one period
    of 8, seamless 2 + 2), seq 256, batch 64, fcdp at depth 1: every
    (op, axis) equal but two pinned differences of the reference's
    remat, not of the partition: the JAX rwkv sums u's gradient once per
    WKV chunk inside its chunk scan (the port once), and the JAX MoE's
    nested remat runs its two dispatch all-to-alls a third time in the
    backward of every MoE sublayer but a layer's last (jamba's
    ``all_to_all/model`` 1.25x the port's);
  * the cross-step dry run: the piped step's bytes equal the fused async
    step's, its carry equal to ``cross_step_buffer_bytes_per_chip``;
  * the dry run of comm_smoke's model against the bytes eight gloo ranks
    measured on the real wire (``tests/test_torch_sched.py``'s runs):
    equal, per (op, axis), for every mode and depth;
  * the serve cells are ``unported``, long_500k on a full-attention arch
    ``skipped``, and ``main`` writes a row per cell.

This module imports nothing of JAX at its top: the subprocesses import
it to run the reference.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import pytest

AXES = ("pod", "data", "model")
DENSE = dict(name="t-dense", family="dense", num_layers=3, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             qkv_bias=True)
MOE = dict(name="t-moe", family="moe", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=256)
MOE_KW = dict(num_experts=4, top_k=2, d_ff_expert=64)
CELL = ("t", "train", 64, 8)
MODELS = {"dense": DENSE, "moe": MOE}
# the toy's overrides of the dry run's pins (test_cross_step.py's)
TOY_OVERRIDES = {"min_shard_size": 8, "loss_chunk": 0}
MODES = ("zero3", "zeropp", "fcdp", "mics", "hier")
INT8 = "int8_pod"
# case -> (model, dryrun_cell keyword arguments, extra system overrides;
# None: the dry run's own loss_chunk)
TOY = {f"{m}_{mode}_d{d}": (m, dict(mode=mode, prefetch_depth=d), {})
       for m in MODELS for mode in MODES for d in (0, 1)}
TOY.update({
    "dense_fcdp_q8": ("dense", dict(mode="fcdp", param_compress=INT8),
                      {"grad_compress": INT8}),
    "moe_fcdp_q8": ("moe", dict(mode="fcdp", param_compress=INT8),
                    {"grad_compress": INT8}),
    "dense_fcdp_peft": ("dense", dict(mode="fcdp"), {"peft": True}),
    "dense_zero3_peft": ("dense", dict(mode="zero3"), {"peft": True}),
    "dense_fcdp_ag": ("dense", dict(mode="fcdp", fused_matmul="ag_matmul"),
                      {}),
    "dense_fcdp_own": ("dense", dict(mode="fcdp"), None),
})
# the cases that also run through the JAX dryrun_cell, compile included
JAX_DRYRUN = ("dense_fcdp_d1", "dense_fcdp_own")
FLOPS_RTOL = 0.02

NARROW = dict(name="t-narrow", family="dense", num_layers=3, d_model=256,
              num_heads=16, num_kv_heads=16, d_ff=512, vocab_size=1024,
              qkv_bias=True, head_dim=16)
NARROW_CELL = ("t", "train", 64, 64)
# the JAX trace's 'pod' all-gather bytes a step at (2, 16, 16), depth 0
NARROW_POD_AG = {"zero3": 63696.0, "fcdp": 32880.0}
QWEN_LAYERS = 4
QWEN_RUNS = {"zero3": ("zero3", False), "fcdp": ("fcdp", False),
             "zero3_peft": ("zero3", True), "fcdp_peft": ("fcdp", True)}
ARCH_CELL = ("t", "train", 256, 64)
# (arch, op/axis) -> the JAX trace's bytes over the port's (the pinned
# reference remat differences of the module note)
ARCH_PINNED = {("jamba-v0.1-52b", "all_to_all/model"): 1.25}
ARCH_PINNED_PSUM = ("rwkv6-3b",)     # psum/data and psum/pod: u per chunk


def _flops_terms(model, cell, sizes, fused="none"):
    """The named terms by which the FLOPs a chip of the two packages'
    steps differ under a recomputing policy, for a dense or moe model
    (dict) on ``cell`` over mesh ``sizes``: (the JAX trace's own, the
    port's own). The JAX trace's: each layer's attention QK and PV
    forward, run again inside its chunk scan's backward; under the
    fused ring, each fused projection's (wo, w_out) forward matmul, run
    again by its backward, which replays the unfused op sequence. The
    port's: each dense layer's w_out, which its recompute runs again and
    the JAX remat drops (its output is not read); not under the fused
    ring, whose recompute reads no product, nor for a MoE layer."""
    seq, batch = cell[2], cell[3]
    tp = sizes.get("model", 1)
    tokens = batch // (sizes.get("pod", 1) * sizes.get("data", 1)) * seq
    heads = -(-model["num_heads"] // tp)
    hd = model.get("head_dim") or model["d_model"] // model["num_heads"]
    d, layers = model["d_model"], model["num_layers"]
    wo = 2.0 * tokens * heads * hd * d
    w_out = 2.0 * tokens * (model["d_ff"] // tp) * d
    jax_only = layers * 2 * (2.0 * tokens * heads * seq * hd)
    port_only = 0.0
    if fused != "none":
        jax_only += layers * (wo + (w_out if model["family"] == "dense"
                                    else 0.0))
    elif model["family"] == "dense":
        port_only = layers * w_out
    return jax_only, port_only


def _arch_cut(cfg):
    kw = {"num_layers": cfg.hybrid_period or 2}
    if cfg.num_encoder_layers:
        kw["num_encoder_layers"] = 2
    return dataclasses.replace(cfg, **kw)


# -- the JAX reference (run in subprocesses) -----------------------------------

def _jax_model(name):
    from repro.configs.base import ModelConfig, MoEConfig
    kw = dict(MODELS[name])
    if name == "moe":
        kw["moe"] = MoEConfig(**MOE_KW)
    return ModelConfig(**kw)


def _jax_row(run, mesh, full=True):
    """The JAX dry run's numbers of ``run`` on ``mesh`` from the trace:
    the bytes per (op, axis), the FLOPs and, with ``full``, the cache
    accounting and the fused credit's leaf count."""
    from repro.core.cache import cache_bytes_per_chip
    from repro.core.engine import StepBundle
    from repro.launch.roofline import (collect_collectives,
                                       flops_bytes_from_jaxpr,
                                       fused_overlap_credit)
    sizes = {a: int(mesh.shape[a]) for a in mesh.axis_names}
    b = StepBundle(run, mesh)
    closed = b.make_train_step().trace(*b.train_input_sds()).jaxpr
    stats = collect_collectives(closed, sizes)
    flops, _ = flops_bytes_from_jaxpr(closed, mesh.devices.size)
    out = {"bytes": {k: v for k, v in stats.by_op_axis.items() if v},
           "flops": flops}
    if full:
        acct = cache_bytes_per_chip(b)
        out.update({k: acct[k] for k in (
            "stage1_dcn_gather_bytes_per_chip",
            "stage1_dcn_gather_bytes_exact", "prefetch_depth",
            "prefetch_buffer_bytes_per_chip", "async_buffer_bytes_per_chip",
            "cross_step_buffer_bytes_per_chip")})
        out["cache_by_group"] = acct["by_group"]
        out["fused_n_leaves"] = fused_overlap_credit(
            b.def_leaves, b.plan_leaves, sizes, run.shape,
            tp=b.mi.tp)["n_fused_leaves"]
    return out


def _toy_overrides(extra):
    """A toy case's ``system_overrides`` of the dry run's pins."""
    if extra is None:
        return {"min_shard_size": 8}
    return dict(TOY_OVERRIDES, **extra)


def _jax_toy_system(kw):
    """``dryrun_cell``'s SystemConfig of a toy case before its
    overrides (depth 1 unless the case names one)."""
    from repro.configs.base import SystemConfig
    return SystemConfig(**{"prefetch_depth": 1, **kw}).replace(
        loss_chunk=2048, activation_policy="block_io")


def _reference_toy():
    from repro.configs.base import RunConfig, ShapeCell
    from repro.launch import dryrun as dr
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((2, 2, 2), AXES)
    out = {}
    for case, (model, kw, extra) in TOY.items():
        sysc = _jax_toy_system(kw).replace(**_toy_overrides(extra))
        out[case] = _jax_row(RunConfig(model=_jax_model(model),
                                       shape=ShapeCell(*CELL), system=sysc),
                             mesh)
    # the JAX dryrun_cell itself, on the same monkeypatched mesh and config
    dr.make_production_mesh = lambda multi_pod=False: mesh
    dr.cell_supported = lambda cfg, cell: (True, "")
    dr.shape_cell = lambda name: ShapeCell(*CELL)
    cells = {}
    for case in JAX_DRYRUN:
        model, kw, extra = TOY[case]
        dr.get_config = lambda arch, m=model: dataclasses.replace(
            _jax_model(m), name=arch)
        r = dr.dryrun_cell("toy", "train_4k", True,
                           system_overrides=_toy_overrides(extra),
                           verbose=False, **kw)
        cells[case] = {k: r[k] for k in (
            "status", "flops_per_chip", "stage1_dcn_gather_bytes_per_chip",
            "stage1_dcn_gather_bytes_exact", "cache_by_group",
            "prefetch_depth", "prefetch_buffer_bytes_per_chip",
            "async_buffer_bytes_per_chip",
            "cross_step_buffer_bytes_per_chip", "fused_n_leaves",
            "memory")}
    return {"toy": out, "dryrun_cell": cells}


def _reference_prod():
    from repro.configs.base import ModelConfig, RunConfig, ShapeCell
    from repro.configs.base import SystemConfig, shape_cell
    from repro.configs.registry import ARCH_IDS, get_config
    from repro.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=True)
    pinned = dict(loss_chunk=2048, activation_policy="block_io")
    out = {"narrow": {}, "qwen": {}, "arch": {}}
    for mode in NARROW_POD_AG:
        out["narrow"][mode] = _jax_row(RunConfig(
            model=ModelConfig(**NARROW), shape=ShapeCell(*NARROW_CELL),
            system=SystemConfig(mode=mode, min_shard_size=8)), mesh, False)
    qwen = dataclasses.replace(get_config("qwen2.5-3b"),
                               num_layers=QWEN_LAYERS)
    for rid, (mode, peft) in QWEN_RUNS.items():
        out["qwen"][rid] = _jax_row(RunConfig(
            model=qwen, shape=shape_cell("train_4k"),
            system=SystemConfig(mode=mode, peft=peft, prefetch_depth=0,
                                **pinned)), mesh, False)
    for arch in ARCH_IDS:
        out["arch"][arch] = _jax_row(RunConfig(
            model=_arch_cut(get_config(arch)), shape=ShapeCell(*ARCH_CELL),
            system=SystemConfig(mode="fcdp", prefetch_depth=1, **pinned)),
            mesh, False)
    return out


def _start(tmp, fn, devices):
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    out = os.path.join(tmp, f"{fn}.pickle")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    code = ("import pickle, sys, test_torch_dryrun as t; "
            f"pickle.dump(t.{fn}(), open(sys.argv[1], 'wb'))")
    proc = subprocess.Popen([sys.executable, "-c", code, out], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def _finish(proc, out):
    try:
        _, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    if proc.returncode:
        raise RuntimeError(f"the JAX reference failed:\n{err[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


# -- the port, in process -------------------------------------------------------

def _port_model(name):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    kw = dict(MODELS[name])
    if name == "moe":
        kw["moe"] = MoEConfig(**MOE_KW)
    return ModelConfig(**kw)


def _toy_dryrun(model, microbatch=0, **kw):
    """The port's ``dryrun_cell`` on the toy, the module patched as the
    JAX test patches the reference's (``tests/test_cross_step.py``)."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import MeshShape
    patched = {"make_production_mesh":
               lambda multi_pod=False: MeshShape(AXES, (2, 2, 2)),
               "get_config": lambda arch: dataclasses.replace(
                   _port_model(model), name=arch),
               "cell_supported": lambda cfg, cell: (True, ""),
               "shape_cell": lambda name: ShapeCell(*CELL)}
    saved = {k: getattr(dr, k) for k in patched}
    try:
        for k, v in patched.items():
            setattr(dr, k, v)
        return dr.dryrun_cell("toy", "train_4k", True, verbose=False,
                              microbatch=microbatch, **kw)
    finally:
        for k, v in saved.items():
            setattr(dr, k, v)


def _port_toy():
    out = {}
    for case, (model, kw, extra) in TOY.items():
        out[case] = _toy_dryrun(model, system_overrides=_toy_overrides(extra),
                                **kw)
    for rid, cross in (("async", False), ("cross_step", True)):
        out[rid] = _toy_dryrun("dense", microbatch=2, mode="fcdp",
                               async_grad_reduce=True, cross_step=cross,
                               system_overrides=TOY_OVERRIDES)
    return out


def _port_prod():
    from repro_torch.configs.base import (ModelConfig, RunConfig, ShapeCell,
                                          SystemConfig, shape_cell)
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.launch.dryrun import dryrun_run
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=True)
    pinned = dict(loss_chunk=2048, activation_policy="block_io")
    out = {"narrow": {}, "qwen": {}, "arch": {}}
    for mode in NARROW_POD_AG:
        out["narrow"][mode] = dryrun_run(RunConfig(
            model=ModelConfig(**NARROW), shape=ShapeCell(*NARROW_CELL),
            system=SystemConfig(mode=mode, min_shard_size=8)), mesh)
    qwen = dataclasses.replace(get_config("qwen2.5-3b"),
                               num_layers=QWEN_LAYERS)
    for rid, (mode, peft) in QWEN_RUNS.items():
        out["qwen"][rid] = dryrun_run(RunConfig(
            model=qwen, shape=shape_cell("train_4k"),
            system=SystemConfig(mode=mode, peft=peft, prefetch_depth=0,
                                **pinned)), mesh)
    for arch in ARCH_IDS:
        out["arch"][arch] = dryrun_run(RunConfig(
            model=_arch_cut(get_config(arch)), shape=ShapeCell(*ARCH_CELL),
            system=SystemConfig(mode="fcdp", prefetch_depth=1, **pinned)),
            mesh)
    return out


def _compute(tmp_path_factory, part):
    """One part ("toy" or "prod") of both packages' rows: its JAX
    reference in a process of its own, meanwhile the port's rows (JSON
    round-tripped, as ``main`` writes them). The two parts are shared
    apart, so two workers compute them at once."""
    tmp = str(tmp_path_factory.mktemp(f"dryrun_{part}"))
    job = _start(tmp, f"_reference_{part}", 8 if part == "toy" else 512)
    try:
        port = json.loads(json.dumps(_port_toy() if part == "toy"
                                     else _port_prod()))
    except BaseException:
        job[0].kill()
        job[0].wait()
        raise
    return {"port": port, "jax": _finish(*job)}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    from test_torch_train import shared_result
    return shared_result(tmp_path_factory, "torch_dryrun_toy",
                         lambda: _compute(tmp_path_factory, "toy"))


@pytest.fixture(scope="module")
def prod(tmp_path_factory):
    from test_torch_train import shared_result
    return shared_result(tmp_path_factory, "torch_dryrun_prod",
                         lambda: _compute(tmp_path_factory, "prod"))


def _rel(a, b):
    return abs(a - b) / abs(b)


# -- the toy ---------------------------------------------------------------------

ACCT_KEYS = ("stage1_dcn_gather_bytes_per_chip",
             "stage1_dcn_gather_bytes_exact", "prefetch_depth",
             "prefetch_buffer_bytes_per_chip", "async_buffer_bytes_per_chip",
             "cross_step_buffer_bytes_per_chip", "cache_by_group",
             "fused_n_leaves")


@pytest.mark.parametrize("case", list(TOY))
def test_toy_bytes_match_jax(toy, case):
    """Every (op, axis) byte count of the port's dry run equals the JAX
    trace's; hier's 'pod' psum is pinned: the reference sums hier's
    gradient over 'pod' twice, the port once, as its zero3 step does."""
    got = toy["port"][case]
    want = dict(toy["jax"]["toy"][case]["bytes"])
    assert got["status"] == "ok"
    bytes_ = dict(got["collective_bytes"])
    if TOY[case][1]["mode"] == "hier":
        zero3 = toy["port"][case.replace("hier", "zero3")]
        assert bytes_.pop("psum/pod") == \
            zero3["collective_bytes"]["psum/pod"]
        assert want.pop("psum/pod") > zero3["collective_bytes"]["psum/pod"]
    assert bytes_ == want


@pytest.mark.parametrize("case", list(TOY))
def test_toy_accounting_and_flops_match_jax(toy, case):
    """The cache accounting, the buffers and the fused leaves equal the
    JAX dry run's exactly; the FLOPs equal the JAX trace's less and plus
    the named terms (``_flops_terms``; at the toy's widths the attention
    term is up to 3.2 % of a step, so FLOPS_RTOL is held at the
    production mesh)."""
    got, want = toy["port"][case], toy["jax"]["toy"][case]
    for k in ACCT_KEYS:
        assert got[k] == want[k], k
    model, kw, _ = TOY[case]
    jax_only, port_only = _flops_terms(MODELS[model], CELL,
                                       dict(zip(AXES, (2, 2, 2))),
                                       kw.get("fused_matmul", "none"))
    assert got["flops_per_chip"] == want["flops"] - jax_only + port_only


@pytest.mark.parametrize("case", JAX_DRYRUN)
def test_toy_rows_match_jax_dryrun_cell(toy, case):
    """The JAX ``dryrun_cell``'s own JSON (compiled) equals its trace-only
    replica and the port's row; the port's argument bytes are the JAX
    arguments' less the optimizer's step counter (an int32 there, a
    Python int in the port)."""
    cell = toy["jax"]["dryrun_cell"][case]
    rep = toy["jax"]["toy"][case]
    got = toy["port"][case]
    assert cell["status"] == "ok"
    assert cell["flops_per_chip"] == rep["flops"] == got["flops_per_chip"]
    for k in ACCT_KEYS:
        assert cell[k] == rep[k] == got[k], k
    assert got["memory"]["argument_bytes"] == \
        cell["memory"]["argument_bytes"] - 4


def test_toy_modes_and_depths(toy):
    """fcdp's 'pod' all-gather is below zero3's at depth 0; at depth 1
    the ring keeps zero3's stage 1 for its backward, so the two equal
    (the paper's 50 % shows at depth 0); mics moves no stage-1 bytes."""
    t = toy["port"]
    for m in MODELS:
        ag = {k: t[f"{m}_{k}"]["collective_bytes"].get("all_gather/pod", 0.0)
              for k in ("zero3_d0", "zero3_d1", "fcdp_d0", "fcdp_d1",
                        "mics_d0")}
        assert ag["fcdp_d0"] < ag["zero3_d0"]
        assert ag["zero3_d1"] == ag["fcdp_d1"] == ag["fcdp_d0"]
        assert ag["mics_d0"] == 0.0
        assert t[f"{m}_zero3_d1"]["prefetch_depth"] == 1
        assert t[f"{m}_mics_d1"]["prefetch_depth"] == 0


def test_toy_peft_pod_gather(toy):
    """PEFT: fcdp's 'pod' all-gather is the adapters' alone, a small
    fraction of zero3's."""
    t = toy["port"]
    f = t["dense_fcdp_peft"]["collective_bytes"]["all_gather/pod"]
    z = t["dense_zero3_peft"]["collective_bytes"]["all_gather/pod"]
    assert 0 < f < 0.1 * z


def test_toy_cross_step_equals_async(toy):
    """The cross-step dry run (the piped step after an uncounted prime)
    moves the fused async step's bytes; its carry equals
    ``cross_step_buffer_bytes_per_chip``, echoed by the roofline."""
    a, x = toy["port"]["async"], toy["port"]["cross_step"]
    assert x["cross_step"] and not a["cross_step"]
    assert x["collective_bytes"] == a["collective_bytes"]
    assert x["carry_bytes"] == x["cross_step_buffer_bytes_per_chip"] > 0
    assert x["roofline"]["cross_step"] == {
        "enabled": True,
        "carry_buffer_bytes_per_chip": x["cross_step_buffer_bytes_per_chip"]}
    assert a["cross_step_buffer_bytes_per_chip"] == 0.0


@pytest.mark.parametrize("case", ["dense_fcdp_d0", "dense_zero3_d0",
                                  "dense_fcdp_q8", "dense_fcdp_peft"])
def test_toy_memory_tiers(toy, case):
    """The memory tracker: fcdp keeps the layers' stage-1 caches in host
    storage (``host_bytes``, their peak, = the host tier's cached bytes;
    the analytic host cache also counts the embedding's and the head's,
    which autograd keeps on the device), zero3 none; the peak is the
    arguments plus the step's temporaries."""
    r = toy["port"][case]
    mem = r["memory"]
    assert mem["peak_est_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    host = sum(g["cached_bytes_per_chip"] for g in r["cache_by_group"].values()
               if g["placement"] == "host")
    assert mem["host_bytes"] == r["cached_bytes"].get("host", 0) <= host
    assert (mem["host_bytes"] > 0) == case.startswith("dense_fcdp")


def test_toy_roofline_terms(toy):
    """The row's roofline: its terms are the row's counts over the H100
    constants; the stage-1 gathers hide under compute at depth 1."""
    from repro_torch.launch import roofline as troof
    for case in ("dense_fcdp_d0", "dense_fcdp_d1"):
        r = toy["port"][case]
        rep = r["roofline"]
        assert rep["compute_s"] == r["flops_per_chip"] / troof.PEAK_FLOPS
        assert rep["memory_s"] == r["bytes_per_chip"] / troof.HBM_BW
        pod = sum(v for k, v in r["collective_bytes"].items()
                  if k.endswith("/pod"))
        assert rep["dcn_bytes_per_chip"] == pytest.approx(pod, rel=1e-12)
        assert rep["prefetch"]["enabled"] == case.endswith("d1")
        assert sum(r["collective_calls"].values()) == rep["n_collectives"]


# -- the production mesh -----------------------------------------------------------

@pytest.mark.parametrize("mode", list(NARROW_POD_AG))
def test_narrow_production_mesh_matches_jax(prod, mode):
    """The narrow config at (2, 16, 16): every (op, axis) equal to the
    JAX trace, FLOPs equal."""
    got = prod["port"]["narrow"][mode]
    want = prod["jax"]["narrow"][mode]
    assert got["collective_bytes"] == want["bytes"]
    assert got["collective_bytes"]["all_gather/pod"] == NARROW_POD_AG[mode]
    assert got["flops_per_chip"] == want["flops"]


@pytest.mark.parametrize("rid", list(QWEN_RUNS))
def test_qwen_production_mesh_matches_jax(prod, rid):
    """qwen2.5-3b's widths, 4 layers, ``train_4k`` on (2, 16, 16) at
    depth 0: every (op, axis) equal; FLOPs the JAX trace's less and plus
    the two named terms, 1.7 % above it."""
    from repro_torch.configs.registry import get_config
    got = prod["port"]["qwen"][rid]
    want = prod["jax"]["qwen"][rid]
    assert got["n_chips"] == 512
    assert got["collective_bytes"] == want["bytes"]
    qwen = dataclasses.asdict(dataclasses.replace(
        get_config("qwen2.5-3b"), num_layers=QWEN_LAYERS))
    jax_only, port_only = _flops_terms(
        qwen, ("train_4k", "train", 4096, 256),
        {"pod": 2, "data": 16, "model": 16})
    assert got["flops_per_chip"] == want["flops"] - jax_only + port_only
    assert 0 < _rel(got["flops_per_chip"], want["flops"]) <= FLOPS_RTOL


def test_qwen_production_ratios(prod):
    """The paper's two ratios on the port's dry run at 4 layers: fcdp's
    'pod' all-gather below 3/4 of zero3's (the layers' half, the
    embedding's and head's whole; 0.543 at 36 layers, ``chip_smoke.py``),
    fcdp + PEFT's under 1 % of zero3 + PEFT's."""
    q = prod["port"]["qwen"]
    ag = {k: r["collective_bytes"]["all_gather/pod"] for k, r in q.items()}
    assert 0.5 < ag["fcdp"] / ag["zero3"] < 0.75
    assert ag["fcdp_peft"] / ag["zero3_peft"] < 0.01


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma-2b", "granite-3-8b",
                                  "yi-34b", "kimi-k2-1t-a32b",
                                  "llama4-maverick-400b-a17b",
                                  "chameleon-34b", "rwkv6-3b",
                                  "seamless-m4t-medium", "jamba-v0.1-52b"])
def test_arch_production_mesh_matches_jax(prod, arch):
    """Every arch's widths at tp 16: every (op, axis) equal to the JAX
    trace but the pinned remat differences (module note). A leaf read in
    fp32 (norm scales, rwkv's u and ln_x, Mamba's A_log and D_skip) sums
    its replicated gradient in fp32 (chameleon's qk-norm scales, jamba's
    and rwkv's leaves summed in bf16 before this slice)."""
    got = dict(prod["port"]["arch"][arch]["collective_bytes"])
    want = dict(prod["jax"]["arch"][arch]["bytes"])
    for (a, key), ratio in ARCH_PINNED.items():
        if a == arch:
            assert want.pop(key) == ratio * got.pop(key)
    if arch in ARCH_PINNED_PSUM:
        for key in ("psum/data", "psum/pod"):
            assert want.pop(key) > got.pop(key)
    assert got == want


# -- the dry run against the measured wire ----------------------------------------

def _comm_run_ids():
    from test_torch_sched import COMM_RUNS
    return list(COMM_RUNS)


@pytest.fixture(scope="module")
def sched_runs(tmp_path_factory):
    import test_torch_sched
    from test_torch_train import shared_result
    return shared_result(tmp_path_factory, "torch_sched_runs",
                         lambda: test_torch_sched._compute(tmp_path_factory))


@pytest.mark.parametrize("rid", _comm_run_ids())
def test_dryrun_equals_measured_gloo_bytes(sched_runs, rid):
    """The dry run of comm_smoke's model at (2, 2, 2) (the five modes at
    depths 0-2 and fcdp with 'inter_only' MLP leaves) moves, per (op,
    axis), the bytes that ``tests/test_torch_sched.py``'s eight gloo
    ranks measured on the real wire in that step, exactly."""
    from test_torch_sched import COMM_MODEL, COMM_RUNS, MESH3

    from repro_torch.configs.base import (ModelConfig, RunConfig, ShapeCell,
                                          SystemConfig)
    from repro_torch.launch.dryrun import dryrun_run
    mr = COMM_RUNS[rid]
    run = RunConfig(model=ModelConfig(**COMM_MODEL),
                    shape=ShapeCell("t", "train", 64, 8),
                    system=SystemConfig(min_shard_size=8, mode=mr.mode,
                                        prefetch_depth=mr.prefetch_depth))
    row = dryrun_run(run, MESH3, mr.defs_fn)
    measured = [r["bytes"][0] for r in sched_runs["comm"][rid]]
    assert all(m == measured[0] for m in measured)
    assert row["collective_bytes"] == {k: v for k, v in measured[0].items()
                                       if v}
    assert row["prefetch_depth"] == sched_runs["comm"][rid][0][
        "live_depth"][0]


# -- cells, statuses and the command line ---------------------------------------

@pytest.mark.parametrize("cell,status", [("prefill_32k", "unported"),
                                         ("decode_32k", "unported"),
                                         ("long_500k", "skipped")])
def test_serve_cells_are_not_run(cell, status):
    """The serve cells report ``unported`` (never ``ok``), naming the
    queue item that brings them; long_500k on a full-attention arch is
    skipped, as the reference skips it; on rwkv it is unported."""
    from repro_torch.launch.dryrun import dryrun_cell
    r = dryrun_cell("qwen2.5-3b", cell, True, verbose=False)
    assert r["status"] == status
    if status == "unported":
        assert "Queue 1 item 4" in r["reason"]
    assert dryrun_cell("rwkv6-3b", cell, False,
                       verbose=False)["status"] == "unported"


def test_main_writes_rows(tmp_path, monkeypatch, capsys):
    """``main`` on one train cell (gemma-2b cut to 1 layer) and its serve
    cells: one row each, the train row ``ok``, the counts printed, exit
    without error."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as dr
    monkeypatch.setattr(dr, "get_config", lambda arch: dataclasses.replace(
        get_config(arch), num_layers=1))
    out = tmp_path / "rows.json"
    dr.main(["--arch", "gemma-2b", "--multi-pod", "--prefetch-depth", "0",
             "--out", str(out)])
    rows = json.loads(out.read_text())
    assert [r["cell"] for r in rows] == ["train_4k", "prefill_32k",
                                         "decode_32k", "long_500k"]
    assert [r["status"] for r in rows] == ["ok", "unported", "unported",
                                           "skipped"]
    assert rows[0]["prefetch_depth"] == 0 and rows[0]["n_chips"] == 512
    assert "1 ok, 2 unported, 1 skipped, 0 failures" in capsys.readouterr().out
