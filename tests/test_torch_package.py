"""Package-level contracts of the PyTorch port: it stands alone (no
module imports JAX or the JAX package), its entry points run on the
card unless asked for the CPU, and its host-side configuration and
paged-KV bookkeeping hold their invariants."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (ModelConfig, RunConfig, ShapeCell,
                                      SystemConfig)
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import StepBundle
from repro_torch.core.engine.serve import check_paged_plan
from repro_torch.core.kv_cache import SCRATCH_PAGE, PageAllocator, PagedKVConfig
from repro_torch.core.partition import tree_items, tree_map
from repro_torch.launch import serve as serve_launcher

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "ml_dtypes"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_registry_resolves_only_port_modules():
    """All ten archs of the JAX package resolve to the port's own config
    modules; an unknown one raises."""
    from repro_torch.configs import registry
    assert get_config("qwen2.5-3b").num_layers == 36
    assert get_smoke_config("qwen2.5-3b").head_dim == 16
    assert len(registry.ARCH_IDS) == 10
    for arch in registry.ARCH_IDS:
        assert type(get_config(arch)).__module__ == "repro_torch.configs.base"
        assert registry._load(arch).__name__.startswith("repro_torch.configs.")
    assert get_config("seamless-m4t-medium").num_encoder_layers == 12
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_serve_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    run = RunConfig(model=get_smoke_config("qwen2.5-3b"),
                    shape=ShapeCell("t", "decode", 64, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StepBundle(run)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_launcher.main(["--arch", "qwen2.5-3b", "--smoke"])
    assert StepBundle(run, device="cpu").device.type == "cpu"


def test_serve_launcher_on_cpu(capsys):
    summary, results = serve_launcher.main(
        ["--arch", "qwen2.5-3b", "--smoke", "--requests", "5",
         "--seq-len", "64", "--gen-len", "4", "--batch", "4", "--chunk", "16",
         "--device", "cpu"])
    assert summary["requests"] == len(results) == 5
    assert all(len(r.tokens) == 4 for r in results)
    assert summary["kv"]["pool_shape"] == [2, 17, 16, 2, 16]
    assert summary["device"] == "cpu"
    assert '"throughput_tok_s"' in capsys.readouterr().out


def test_launcher_does_not_accept_the_strategy_flags():
    with pytest.raises(SystemExit):
        serve_launcher.main(["--arch", "qwen2.5-3b", "--mode", "fcdp",
                             "--device", "cpu"])


def test_system_config_validation():
    with pytest.raises(ValueError, match="dtype"):
        SystemConfig(dtype="float16")
    assert SystemConfig().torch_dtype == torch.bfloat16
    assert SystemConfig(dtype="float32").torch_dtype == torch.float32


def test_params_from_jax_runs_on_cuda_unless_asked(monkeypatch):
    """The converter is an entry point: without a device it places the
    weights on the card, and without a card it raises."""
    cfg = get_smoke_config("qwen2.5-3b")
    defs = StepBundle(RunConfig(model=cfg, shape=ShapeCell(
        "t", "decode", 64, 2)), device="cpu").defs
    tree = tree_map(lambda d: np.zeros(d.shape, np.float32), defs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree, cfg)
    params = params_from_jax(tree, cfg, device="cpu")
    assert all(t.device.type == "cpu" for _, t in tree_items(params))


def test_init_is_seeded_and_follows_the_defs():
    cfg = get_smoke_config("qwen2.5-3b")
    run = RunConfig(model=cfg, shape=ShapeCell("t", "decode", 64, 2))
    b = StepBundle(run, device="cpu")
    p0, p1 = b.init_all_params(seed=3), b.init_all_params(seed=3)
    p2 = b.init_all_params(seed=4)
    defs = dict(tree_items(b.defs))
    for (path, a), (_, c), (_, d) in zip(tree_items(p0), tree_items(p1),
                                         tree_items(p2)):
        assert a.shape == defs[path].shape and a.dtype == torch.bfloat16
        assert torch.equal(a, c)
        if defs[path].init == "normal":
            assert not torch.equal(a, d)
    assert torch.all(p0["final_norm"] == 1)
    assert torch.all(p0["blocks"]["pos0"]["attn"]["bq"] == 0)
    assert all(d.frozen for d in defs.values())      # serving: all frozen


def test_paged_kv_config_invariants():
    kv = PagedKVConfig(page_size=16, pages_per_replica=17,
                       max_pages_per_seq=8)
    assert kv.max_seq_len == 128
    assert [kv.pages_needed(n) for n in (1, 16, 17, 128)] == [1, 1, 2, 8]
    with pytest.raises(ValueError):
        PagedKVConfig(page_size=0, pages_per_replica=17, max_pages_per_seq=8)
    with pytest.raises(ValueError):
        PagedKVConfig(page_size=16, pages_per_replica=8, max_pages_per_seq=8)


def test_page_allocator_all_or_nothing():
    kv = PagedKVConfig(page_size=16, pages_per_replica=9, max_pages_per_seq=8)
    al = PageAllocator(kv)
    assert al.n_free == 8
    got = al.alloc(8)
    assert sorted(got) == list(range(1, 9)) and SCRATCH_PAGE not in got
    assert al.alloc(1) is None and al.n_free == 0
    al.free(got[:3])
    assert al.alloc(4) is None and al.n_free == 3
    with pytest.raises(ValueError):
        al.free([SCRATCH_PAGE])


def test_check_paged_plan_rejects_recurrent_mixers():
    class M:
        plan = (("attn", "mlp"), ("mamba", "mlp"))
    with pytest.raises(ValueError, match="mamba"):
        check_paged_plan(M)


def test_pools_start_as_zeros():
    """Pages are read (masked) before they are written: they must hold
    finite values, never uninitialized memory."""
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=32,
                      num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=64)
    b = StepBundle(RunConfig(model=cfg, shape=ShapeCell("t", "decode", 32,
                                                        2)), device="cpu")
    st = b.init_paged_state(PagedKVConfig(4, 17, 8))
    for name in ("k", "v"):
        pool = st["pos0"]["attn"][name]
        assert pool.shape == (2, 17, 4, 1, 16)
        assert pool.dtype == torch.bfloat16 and not pool.any()


def test_library_path_follows_the_shared_headers(tmp_path, monkeypatch):
    """A kernel library is named by its source, every header beside it
    (``csrc/*.cuh``, which the sources include) and the flags: an edit to
    a shared header names a new library, so a stale one is never
    loaded; an unchanged tree names the same one."""
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src, header = csrc / "k.cu", csrc / "shared.cuh"
    src.write_text('#include "shared.cuh"\n')
    header.write_text("// v1\n")
    monkeypatch.setattr(_build, "SOURCES", {"k": src})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    assert first.parent == tmp_path / "build" and first.name.startswith("libk_")
    header.write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    (csrc / "added.cuh").write_text("// new\n")
    assert _build.library_path("k") not in (first, second)
    (csrc / "added.cuh").unlink()
    assert _build.library_path("k") == second
    src.write_text('#include "shared.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_rank_env(monkeypatch):
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)


PEFT_FLAGS = ["--arch", "qwen2.5-3b", "--smoke", "--peft", "--lora-rank", "2",
              "--mode-override", "*lora*=zero3", "--device", "cpu"]


def test_train_launcher_parses_peft_and_builds_the_composite():
    """``--peft --lora-rank 2 --mode-override '*lora*=zero3'``: the trunk
    frozen on fcdp, the adapters trainable on zero3, on the 4-rank
    multi-pod mesh."""
    from repro_torch.core.strategy import CompositeStrategy, leaf_group
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import train_mesh_shape
    run = launcher.build_run(launcher.parser().parse_args(
        PEFT_FLAGS + ["--multi-pod"]))
    sysc = run.system
    assert (sysc.peft, sysc.lora_rank, sysc.lora_alpha, sysc.lora_targets,
            sysc.mode_overrides) == (True, 2, None, ("wq", "wk", "wv", "wo"),
                                     (("*lora*", "zero3"),))
    b = StepBundle(run, device="cpu", mesh=train_mesh_shape(4, True))
    assert isinstance(b.strategy, CompositeStrategy)
    assert b.strategy.group_names() == ("fcdp", "zero3")
    assert {leaf_group(b.strategy, b.def_leaves[i])
            for i in b.train_idx} == {"zero3"}
    assert all("_lora_" in b.paths[i] for i in b.train_idx)
    frozen = [b.plan_leaves[i].residency for i in b.frozen_idx]
    assert {r.update for r in frozen} == {"frozen_cached"}
    args = launcher.parser().parse_args(
        PEFT_FLAGS + ["--lora-alpha", "8", "--lora-targets", "wq, wo"])
    sysc = launcher.build_run(args).system
    assert (sysc.lora_alpha, sysc.lora_targets) == (8.0, ("wq", "wo"))


def test_train_launcher_runs_a_peft_step_on_the_cpu(monkeypatch, capsys,
                                                   tmp_path):
    """One CPU rank trains the adapters: the JSON line reports the
    trainable fraction; the frozen trunk is left as it was. (The
    launcher resumes from the latest checkpoint in its --ckpt-dir, so
    the run gets a directory of its own.)"""
    from repro_torch.launch import train as launcher
    _one_rank_env(monkeypatch)
    res = launcher.main(PEFT_FLAGS + ["--steps", "2", "--batch", "2",
                                      "--seq-len", "32",
                                      "--ckpt-dir", str(tmp_path)])
    r = res["runs"][0]
    assert all(np.isfinite(m["loss"]) for m in r["metrics"])
    assert r["frozen_unchanged"] and r["lora_b_moved"]
    assert 0 < r["params_trainable"] < 0.1 * r["params_total"]
    assert '"trainable_frac"' in capsys.readouterr().out


def test_train_launcher_raises_when_peft_finds_no_target(monkeypatch):
    from repro_torch.launch import train as launcher
    _one_rank_env(monkeypatch)
    with pytest.raises(ValueError, match="no LoRA injection sites"):
        launcher.main(["--arch", "qwen2.5-3b", "--smoke", "--peft",
                       "--lora-targets", "q_proj", "--device", "cpu"])


@pytest.mark.parametrize("flags", [["--peft"], ["--lora-rank", "8"],
                                   ["--mode-override", "*lora*=zero3"]])
def test_serve_launcher_refuses_the_peft_flags(flags):
    with pytest.raises(SystemExit):
        serve_launcher.main(["--arch", "qwen2.5-3b", "--device", "cpu"]
                            + flags)
