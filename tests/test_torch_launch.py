"""The port's launch tools against the JAX package's, on the CPU: the
shape cells and the cell table (``configs/base.py``,
``configs/registry.py``), the analytic parameter counts
(``models/registry.count_params``), the shared system flags
(``launch/cli.py``) and the roofline (``launch/roofline.py``).

Everything here is exact: counts, cells and flags are equal to the JAX
package's with ``==``; the roofline's terms are the byte and FLOP counts
over the port's H100 constants, and the JAX package's own functions,
run with those constants in place of its TPU ones, give the same report
to the last bit.
"""
import argparse
import dataclasses

import pytest

from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPE_CELLS, ShapeCell, shape_cell
from repro_torch.launch import cli as tcli
from repro_torch.launch import roofline as troof
from repro_torch.models.registry import count_params

ARCHS = list(treg.ARCH_IDS)


# -- configs ---------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_jax(arch, which):
    """Total and active counts equal the JAX package's, for the full and
    the smoke config of every arch."""
    from repro.configs import registry as jreg
    from repro.models.registry import count_params as jcount
    get_t = treg.get_config if which == "CONFIG" else treg.get_smoke_config
    get_j = jreg.get_config if which == "CONFIG" else jreg.get_smoke_config
    ct, cj = get_t(arch), get_j(arch)
    assert count_params(ct) == jcount(cj)
    assert count_params(ct, active_only=True) == jcount(cj, active_only=True)
    assert (ct.param_count(), ct.active_param_count()) == (
        cj.param_count(), cj.active_param_count())


def test_count_params_qwen():
    """qwen2.5-3b: 3,397,103,616 parameters, all active."""
    cfg = treg.get_config("qwen2.5-3b")
    assert count_params(cfg) == count_params(cfg, active_only=True) \
        == 3_397_103_616


def test_shape_cells_match_jax():
    from repro.configs import base as jbase
    assert [dataclasses.astuple(c) for c in SHAPE_CELLS] == [
        dataclasses.astuple(c) for c in jbase.SHAPE_CELLS]
    for c in jbase.SHAPE_CELLS:
        assert dataclasses.astuple(shape_cell(c.name)) == \
            dataclasses.astuple(jbase.shape_cell(c.name))
    with pytest.raises(KeyError, match="unknown shape cell"):
        shape_cell("train_8k")


def test_all_cells_match_jax():
    """40 rows, (arch, cell, supported, reason) equal to the JAX table:
    long_500k only for the sub-quadratic archs."""
    from repro.configs import registry as jreg
    rows = treg.all_cells()
    assert len(rows) == 40
    assert rows == jreg.all_cells()
    assert {a for a, c, ok, _ in rows if c == "long_500k" and ok} == {
        "rwkv6-3b", "jamba-v0.1-52b"}


@pytest.mark.parametrize("cell", [c.name for c in SHAPE_CELLS])
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_supported_matches_jax(arch, cell):
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    assert treg.cell_supported(treg.get_config(arch), shape_cell(cell)) == \
        jreg.cell_supported(jreg.get_config(arch), jbase.shape_cell(cell))


# -- the shared command line ------------------------------------------------------

# SystemConfig fields both packages have and the shared flags set
SHARED = ("mode", "mode_overrides", "prefetch_depth", "async_grad_reduce",
          "cross_step_pipeline", "device_cache_fraction", "peft",
          "lora_rank", "lora_alpha", "lora_targets", "activation_policy",
          "loss_chunk", "grad_compress", "param_compress", "fused_matmul",
          "min_shard_size")
ARGVS = {
    "defaults": [],
    "zero3_d2": ["--mode", "zero3", "--prefetch-depth", "2"],
    "peft": ["--peft", "--lora-rank", "4", "--lora-alpha", "8",
             "--lora-targets", "wq, wo", "--mode-override", "*lora*=zero3"],
    "int8_both": ["--param-compress", "int8_pod", "--grad-compress",
                  "int8_pod", "--fused-matmul", "both"],
    "streams": ["--async-grad-reduce", "--cross-step-pipeline",
                "--device-cache-fraction", "0.5", "--activation-policy",
                "block_io", "--loss-chunk", "512"],
    "mixed": ["--mode", "hier", "--mode-override", "embed=mics",
              "--mode-override", "blocks.*=zero3", "--prefetch-depth", "0"],
}


def _both(argv, depth=None, **overrides):
    from repro.launch import cli as jcli
    out = []
    for mod in (tcli, jcli):
        ap = argparse.ArgumentParser()
        mod.add_system_args(ap, default_prefetch_depth=depth)
        out.append(mod.system_config_from_args(ap.parse_args(argv),
                                               **overrides))
    return out


@pytest.mark.parametrize("depth", [None, 1])
@pytest.mark.parametrize("name", list(ARGVS))
def test_system_config_matches_jax(name, depth):
    """Every shared field of the port's config equals the JAX config's
    for the same argv (with the train launchers' default depth and the
    dry run's)."""
    t, j = _both(ARGVS[name], depth, min_shard_size=8)
    for f in SHARED:
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("flag", ["--quant-impl", "--fused-impl"])
def test_impl_flags_are_rejected(flag, capsys):
    """The port has no implementation knob: argparse refuses both."""
    ap = argparse.ArgumentParser()
    tcli.add_system_args(ap)
    with pytest.raises(SystemExit):
        ap.parse_args([flag, "jnp"])
    assert "unrecognized arguments" in capsys.readouterr().err


def test_cli_flags_match_jax_but_the_impls():
    """The port's flags are the JAX package's less the two impl flags,
    with the same defaults."""
    from repro.launch import cli as jcli

    def flags(mod):
        ap = argparse.ArgumentParser()
        g = mod.add_system_args(ap)
        return {a.option_strings[0]: a.default for a in g._group_actions}
    t, j = flags(tcli), flags(jcli)
    assert set(j) - set(t) == {"--quant-impl", "--fused-impl"}
    assert set(t) <= set(j)
    assert {k: j[k] for k in t} == t


def test_train_launcher_takes_cell_and_loss_chunk():
    """The train launcher's system knobs come from cli.py: ``--loss-chunk``
    reaches the run, ``--cell`` sets a full config's shape."""
    from repro_torch.launch import train as launcher
    ap = launcher.parser()
    run = launcher.build_run(ap.parse_args(
        ["--arch", "qwen2.5-3b", "--cell", "train_4k", "--loss-chunk",
         "1024", "--mode", "zero3"]))
    assert dataclasses.astuple(run.shape) == ("train_4k", "train", 4096, 256)
    assert (run.system.loss_chunk, run.system.mode,
            run.system.min_shard_size) == (1024, "zero3", 2048)
    run = launcher.build_run(ap.parse_args(
        ["--arch", "qwen2.5-3b", "--smoke", "--seq-len", "32", "--batch",
         "2"]))
    assert dataclasses.astuple(run.shape) == ("train", "train", 32, 2)
    assert run.system.min_shard_size == 8
    with pytest.raises(SystemExit):
        ap.parse_args(["--arch", "qwen2.5-3b", "--cell", "decode_32k"])


def test_train_launcher_runs_loss_chunk_on_the_cpu(monkeypatch, tmp_path):
    """One CPU rank through ``main`` with ``--loss-chunk``: the run's
    record carries it and the loss is finite."""
    import math

    from test_torch_package import _one_rank_env

    from repro_torch.launch import train as launcher
    _one_rank_env(monkeypatch)
    res = launcher.main(["--arch", "qwen2.5-3b", "--smoke", "--device",
                         "cpu", "--steps", "1", "--batch", "2", "--seq-len",
                         "32", "--loss-chunk", "16", "--ckpt-dir",
                         str(tmp_path)])
    r = res["runs"][0]
    assert r["run"]["loss_chunk"] == 16
    assert math.isfinite(r["metrics"][0]["loss"])


# -- the roofline ---------------------------------------------------------------

COUNTS = {"all_gather/pod": 1.5e7, "all_gather/data": 8.5e8,
          "psum/model": 5.7e10, "psum/data": 8.6e4, "psum/pod": 2880.75,
          "psum_scatter/data": 4.6e8, "psum_scatter/pod": 1.5e7,
          "ppermute/data": 3.0e6, "all_to_all/model": 2.0e8}
CALLS = {k: i + 1 for i, k in enumerate(COUNTS)}


def _jax_stats(jroof):
    """The JAX stats of the same calls, each key's bytes added at once
    in the port's order (float sums in another order differ in the last
    bit)."""
    stats = jroof.CollectiveStats()
    for key, nbytes in sorted(COUNTS.items()):
        op, axis = key.split("/")
        stats.add(op, axis, nbytes, is_dcn=(axis == "pod"))
    stats.count = sum(CALLS.values())
    return stats


def _with_port_constants(monkeypatch, jroof):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "DCN_BW"):
        monkeypatch.setattr(jroof, name, getattr(troof, name))


def test_constants_are_the_h100_data_sheet():
    assert (troof.PEAK_FLOPS, troof.PEAK_FLOPS_FP32, troof.HBM_BW,
            troof.ICI_BW, troof.DCN_BW) == (989e12, 67e12, 3.35e12, 450e9,
                                            25e9)


def test_collective_stats_from_counts():
    s = troof.CollectiveStats.from_counts(COUNTS, CALLS)
    assert dict(s.by_op_axis) == COUNTS
    assert s.dcn_bytes == sum(v for k, v in COUNTS.items()
                              if k.endswith("/pod"))
    assert s.ici_bytes == sum(v for k, v in COUNTS.items()
                              if not k.endswith("/pod"))
    assert s.count == sum(CALLS.values())


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("fused", [None, {"credit_s": 1e-3}])
def test_roofline_terms_and_jax_report(monkeypatch, depth, fused):
    """Each term is its count over the port's constant; the JAX
    ``roofline_report`` with the port's constants gives the same dict
    (keys and values) on the same inputs."""
    from repro.configs import registry as jreg
    from repro.launch import roofline as jroof
    cell = shape_cell("train_4k")
    cfg = treg.get_config("qwen2.5-3b")
    flops, hbm = 6.9e13, 4.9e11
    stats = troof.CollectiveStats.from_counts(COUNTS, CALLS)
    kw = dict(prefetch=depth, inflight_bytes=123.0,
              group_bytes={"fcdp": {"n_leaves": 3}}, cross_step=True,
              cross_step_bytes=77.0, fused=fused)
    rep = troof.roofline_report(flops, hbm, stats, cfg, cell, 512, **kw)
    assert rep["compute_s"] == flops / 989e12
    assert rep["memory_s"] == hbm / 3.35e12
    assert rep["ici_s"] == stats.ici_bytes / 450e9
    assert rep["dcn_s"] == stats.dcn_bytes / 25e9
    assert rep["collective_s"] == rep["ici_s"] + rep["dcn_s"]
    _with_port_constants(monkeypatch, jroof)
    want = jroof.roofline_report(flops, hbm, _jax_stats(jroof),
                                 jreg.get_config("qwen2.5-3b"),
                                 cell, 512, **kw)
    assert rep == want


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_matches_jax(arch):
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.launch import roofline as jroof
    for c in SHAPE_CELLS:
        for n in (256, 512):
            assert troof.model_flops(treg.get_config(arch), c, n) == \
                jroof.model_flops(jreg.get_config(arch),
                                  jbase.shape_cell(c.name), n)


@pytest.mark.parametrize("fused", ["ag_matmul", "both"])
def test_fused_overlap_credit_matches_jax(monkeypatch, mesh3, fused):
    """The fused ring's credit from the port's plans equals the JAX
    function's on the JAX bundle's plans, with the port's constants;
    each ring pass is min(chunk bytes / ICI_BW, chunk FLOPs /
    PEAK_FLOPS) over its n - 1 hops."""
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import SystemConfig as JSystemConfig
    from repro.core.engine import StepBundle as JStepBundle
    from repro.launch import roofline as jroof
    from test_cross_step import CELL, DENSE

    from repro_torch.configs.base import ModelConfig, RunConfig, SystemConfig
    from repro_torch.core.engine import StepBundle
    from repro_torch.launch.mesh import MeshShape
    ms = MeshShape(("pod", "data", "model"), (2, 2, 2))
    cell = ShapeCell(*dataclasses.astuple(CELL))
    # a dense config: every field is a plain value
    tb = StepBundle(RunConfig(model=ModelConfig(**dataclasses.asdict(DENSE)),
                              shape=cell,
                              system=SystemConfig(min_shard_size=8,
                                                  fused_matmul=fused)),
                    device="cpu", mesh=ms)
    jb = JStepBundle(JRunConfig(model=DENSE, shape=CELL,
                                system=JSystemConfig(min_shard_size=8,
                                                     fused_matmul=fused)),
                     mesh3)
    got = troof.fused_overlap_credit(tb.def_leaves, tb.plan_leaves, ms.shape,
                                     cell, tp=2)
    assert got["enabled"] and got["mode"] == fused
    assert got["n_fused_leaves"] > 0
    _with_port_constants(monkeypatch, jroof)
    want = jroof.fused_overlap_credit(jb.def_leaves, jb.plan_leaves,
                                      {"pod": 2, "data": 2, "model": 2},
                                      CELL, tp=2)
    assert got == want
