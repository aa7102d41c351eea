"""The port's rwkv (ssm family) serve path against the JAX package's, on
the CPU.

Both packages run ``rwkv6-smoke`` (2 layers, d_model 64, 4 heads of 16,
vocab 512) on the same weights, drawn with numpy from a seed: the JAX
bundle on a one-device (pod, data, model) mesh, the port through
``repro_torch.convert.params_from_jax``. The zero-initialised leaves
(``maa_base``, ``maa_w1``, ``decay_base``, ``decay_w1``, ``u``,
``mu_k``, ``mu_r``) are overwritten with seeded draws, the same in both
packages: at their default init the ddlerp deltas vanish, every log
decay is -1 and the u-bonus is 0, and neither the WKV nor the parity
would see a data-dependent decay.

The WKV's plain version (``kernels.ref.wkv6_plain``, what the port runs
on CPU tensors) is held to the JAX model's ``_wkv_chunked`` at 1e-5
relative in fp32 (the same chunked algorithm; only the order of fp32
sums differs) and to the Pallas kernel in interpret mode at 2e-3, the
tolerance of ``tests/test_kernels.py``. The CUDA kernel itself runs only
on the card, where ``chip_smoke.py`` holds it to ``wkv6_plain``.

Greedy picks on the JAX side are a plain argmax: the JAX package's
``build_greedy_pick`` fails on a mesh whose model axis has size 1
(ROADMAP Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeCell as JShapeCell
from repro.configs.base import SystemConfig as JSystemConfig
from repro.configs.registry import get_smoke_config as j_smoke
from repro.core.engine import StepBundle as JStepBundle
from repro.core.engine.serve import check_paged_plan as j_check_paged_plan
from repro.kernels import ops as jops
from repro.launch import serve as j_serve_launcher
from repro.launch.mesh import make_mesh
from repro.models.sublayers import _wkv_chunked
from repro_torch.configs.base import RunConfig, ShapeCell, SystemConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core.engine import StepBundle
from repro_torch.core.engine.serve import check_paged_plan
from repro_torch.core.partition import tree_items, tree_map
from repro_torch.kernels import ops, ref
from repro_torch.kernels.wkv6 import wkv6_fwd
from repro_torch.launch import serve as serve_launcher

B, SEQ, DECODE_STEPS = 2, 128, 3
WKV_RTOL = 1e-5            # fp32, same chunked algorithm as the JAX model
KERNEL_TOL = 2e-3          # tests/test_kernels.py's wkv6 tolerance
LOGIT_TOL = {"float32": 1e-3, "bfloat16": 0.1}   # tests/test_torch_serve.py
# The decode state. fp32: the WKV state differs only by fp32 sums in
# another order over 128 steps (|s| up to ~18; measured 5e-5), held at
# atol 1e-4. bf16: r, k, v enter the WKV already one bf16 rounding of a
# projection apart in the two packages (2^-8 relative each), and the
# state sums 128 decayed products of them; every leaf is held to max
# |diff| <= 2e-2 x max |leaf| (about five bf16 steps at the largest
# entry; measured 7e-3).
STATE_ATOL_F32 = 1e-4
STATE_RTOL_BF16 = 2e-2
ZERO_INIT = ("maa_base", "maa_w1", "decay_base", "decay_w1", "u", "mu_k",
             "mu_r")


# -- inputs -------------------------------------------------------------------

def _wkv_inputs(rng, shape, decay="drawn", with_s0=False):
    """r, k, v ~ N(0, 1); logw = -exp(N(-0.5, 1)) as tests/test_kernels.py
    draws it (or -20: strong decay); u ~ N(0, 1); s0 ~ N(0, 1)."""
    Bs, S, H, hd = shape
    r, k, v = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(3))
    if decay == "strong":
        logw = np.full(shape, -20.0, np.float32)
    else:
        logw = -np.exp(rng.normal(-0.5, 1.0, shape)).astype(np.float32)
    u = rng.normal(0, 1, (H, hd)).astype(np.float32)
    s0 = (rng.normal(0, 1, (Bs, H, hd, hd)).astype(np.float32)
          if with_s0 else None)
    return r, k, v, logw, u, s0


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jnp(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _assert_rel(got, want, rtol, what=""):
    """max |got - want| <= rtol * max |want|: a tolerance relative to the
    magnitude of the whole tensor (elementwise relative tolerances blow
    up on entries that cancel towards 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, mag = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * mag, f"{what}: max |diff| {err} > {rtol} x {mag}"


# -- the WKV ------------------------------------------------------------------

WKV_CASES = [
    # (shape, chunk, decay, with_s0)
    ((2, 128, 2, 16), 16, "drawn", False),
    ((2, 128, 2, 16), 32, "drawn", False),
    ((2, 128, 2, 16), 64, "drawn", False),
    ((2, 128, 2, 16), 16, "drawn", True),
    ((2, 128, 2, 16), 32, "drawn", True),
    ((2, 128, 2, 16), 64, "drawn", True),
    ((3, 1, 4, 16), 64, "drawn", True),        # decode: S = 1, chunk 1
    ((3, 1, 4, 16), 64, "drawn", False),
    ((1, 64, 2, 64), 64, "drawn", True),
    ((1, 64, 1, 16), 32, "strong", False),     # tests/test_kernels.py:71
    ((1, 64, 1, 16), 32, "strong", True),
]


@pytest.mark.parametrize("shape,chunk,decay,with_s0", WKV_CASES)
def test_wkv6_plain_matches_jax_chunked(shape, chunk, decay, with_s0, rng):
    r, k, v, logw, u, s0 = _wkv_inputs(rng, shape, decay, with_s0)
    want_o, want_s = _wkv_chunked(*_jnp(r, k, v, logw, u), chunk=chunk,
                                  s0=None if s0 is None else jnp.asarray(s0))
    got_o, got_s = ref.wkv6_plain(*_torch(r, k, v, logw, u, s0), chunk=chunk)
    assert got_o.dtype == torch.float32 and got_s.dtype == torch.float32
    assert got_s.shape == (shape[0], shape[2], shape[3], shape[3])
    assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
    _assert_rel(got_o.numpy(), want_o, WKV_RTOL, "out")
    _assert_rel(got_s.numpy(), want_s, WKV_RTOL, "state")


@pytest.mark.parametrize("shape", [(1, 64, 1, 16), (2, 128, 2, 32),
                                   (1, 128, 4, 64)])
@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv6_plain_matches_pallas_interpret(shape, chunk, rng):
    """The TPU kernel itself, run as the JAX package's own tests run it
    on the CPU (tests/test_kernels.py:53's sweep)."""
    r, k, v, logw, u, _ = _wkv_inputs(rng, shape)
    want_o, want_s = jops.wkv6(*_jnp(r, k, v, logw, u), chunk=chunk,
                               impl="pallas_interpret")
    got_o, got_s = ref.wkv6_plain(*_torch(r, k, v, logw, u), chunk=chunk)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)


def test_wkv6_plain_carries_state_across_calls(rng):
    """Prefill then decode: the WKV over S steps equals the WKV over the
    first S-1 steps followed by one step from its final state (what the
    decode step relies on)."""
    r, k, v, logw, u, _ = _torch(*_wkv_inputs(rng, (2, 65, 2, 16)))
    o, s = ref.wkv6_plain(r, k, v, logw, u, chunk=65)
    o1, s1 = ref.wkv6_plain(*(t[:, :64] for t in (r, k, v, logw)), u)
    o2, s2 = ref.wkv6_plain(*(t[:, 64:] for t in (r, k, v, logw)), u, s0=s1)
    _assert_rel(torch.cat([o1, o2], 1).numpy(), o.numpy(), WKV_RTOL, "out")
    _assert_rel(s2.numpy(), s.numpy(), WKV_RTOL, "state")


def test_wkv6_plain_bf16_output_in_r_dtype(rng):
    r, k, v, logw, u, s0 = _torch(*_wkv_inputs(rng, (1, 32, 2, 16),
                                               with_s0=True))
    o, s = ops.wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), logw, u, s0)
    want, want_s = ref.wkv6_plain(r.bfloat16().float(), k.bfloat16().float(),
                                  v.bfloat16().float(), logw, u, s0)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.equal(o, want.bfloat16()) and torch.equal(s, want_s)


@pytest.mark.parametrize("S,chunk", [(96, 64), (100, 32), (48, 32)])
def test_wkv6_chunk_contract_raises_on_both_sides(S, chunk, rng):
    r, k, v, logw, u, _ = _wkv_inputs(rng, (1, S, 1, 16))
    with pytest.raises(AssertionError, match="not divisible"):
        _wkv_chunked(*_jnp(r, k, v, logw, u), chunk=chunk)
    with pytest.raises(ValueError, match="not divisible"):
        ops.wkv6(*_torch(r, k, v, logw, u), chunk=chunk)


# -- dispatch ---------------------------------------------------------------

def test_wkv6_cpu_takes_the_plain_version_and_launches_nothing(rng):
    args = _torch(*_wkv_inputs(rng, (1, 32, 2, 16), with_s0=True))
    launches, calls = ops.wkv6.launches, ops.wkv6.calls
    o, s = ops.wkv6(*args)
    want_o, want_s = ref.wkv6_plain(*args)
    assert torch.equal(o, want_o) and torch.equal(s, want_s)
    assert ops.wkv6.launches == launches and ops.wkv6.calls == calls + 1


def test_wkv6_rejects_other_devices():
    t = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no wkv6 kernel"):
        ops.wkv6(t, t, t, t, torch.empty((2, 16), device="meta"))


def test_wkv6_wrapper_refuses_what_the_kernel_does_not_take(rng):
    """The kernel wrapper never falls back: a tensor it cannot take
    raises before anything is built or launched."""
    r, k, v, logw, u, _ = _torch(*_wkv_inputs(rng, (1, 8, 2, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_fwd(r, k, v, logw, u)
    with pytest.raises(ValueError, match="head dim"):
        wkv6_fwd(*(t[..., :8] for t in (r, k, v, logw)), u[:, :8])


class _FakeCuda:
    """Stands in for a CUDA tensor (contiguous and aligned unless told
    otherwise) on a machine without one."""

    def __init__(self, *shape, dtype=torch.float32, ptr=0, contiguous=True):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)
        self.ptr, self.contiguous = ptr, contiguous

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self.contiguous

    def data_ptr(self):
        return self.ptr


def test_cuda_tensor_launches_or_raises(monkeypatch):
    """A CUDA tensor goes to the kernel: when the kernel cannot be built
    the call raises, counts no launch and never runs the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import wkv6 as wkv6_mod

    def no_nvcc(name):
        raise RuntimeError(f"cannot build {name}")
    monkeypatch.setattr(_build, "load", no_nvcc)
    monkeypatch.setattr(ref, "wkv6_plain",
                        lambda *a, **kw: pytest.fail("plain version ran"))
    wkv6_mod._lib.cache_clear()
    shape = (8, 512, 40, 64)
    r = _FakeCuda(*shape, dtype=torch.bfloat16)
    launches = ops.wkv6.launches
    try:
        with pytest.raises(RuntimeError, match="cannot build wkv6"):
            ops.wkv6(r, r, r, _FakeCuda(*shape), _FakeCuda(40, 64))
    finally:
        wkv6_mod._lib.cache_clear()
    assert ops.wkv6.launches == launches


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_wrapper_launches_through_build_launch(dtype, with_s0,
                                                    monkeypatch):
    """The wrapper hands its kernel's C entry point to ``_build.launch``
    (which launches on the device's current stream, switching the
    current device only when it is another) with the pointers, None for
    an absent s0, and (B, S, H, hd)."""
    import types
    from repro_torch.kernels import _build
    from repro_torch.kernels import wkv6 as wkv6_mod

    fns = {"wkv6_fwd_bf16": object(), "wkv6_fwd_f32": object()}
    calls = []
    monkeypatch.setattr(wkv6_mod, "_lib",
                        lambda: types.SimpleNamespace(**fns))
    monkeypatch.setattr(wkv6_mod, "_new_outputs", lambda r, B, H, hd: (
        _FakeCuda(*r.shape, dtype=r.dtype, ptr=4096),
        _FakeCuda(B, H, hd, hd, ptr=8192)))
    monkeypatch.setattr(_build, "launch", lambda device, fn, *a:
                        calls.append((device, fn, a)) or 0)
    B, S, H, hd = 8, 512, 40, 64
    r = _FakeCuda(B, S, H, hd, dtype=dtype, ptr=16)
    s0 = _FakeCuda(B, H, hd, hd, ptr=32) if with_s0 else None
    out, state = wkv6_fwd(r, r, r, _FakeCuda(B, S, H, hd, ptr=48),
                          _FakeCuda(H, hd, ptr=64), s0)
    (device, fn, args), = calls
    assert device == torch.device("cuda", 0)
    assert fn is fns["wkv6_fwd_bf16" if dtype == torch.bfloat16
                     else "wkv6_fwd_f32"]
    assert args == (16, 16, 16, 48, 64, 32 if with_s0 else None, 4096, 8192,
                    B, S, H, hd)
    assert out.dtype == dtype and state.shape == (B, H, hd, hd)


def _wkv_fakes(**over):
    B, S, H, hd = 2, 100, 4, 64
    t = {"r": _FakeCuda(B, S, H, hd, dtype=torch.bfloat16),
         "k": _FakeCuda(B, S, H, hd, dtype=torch.bfloat16),
         "v": _FakeCuda(B, S, H, hd, dtype=torch.bfloat16),
         "logw": _FakeCuda(B, S, H, hd), "u": _FakeCuda(H, hd),
         "s0": _FakeCuda(B, H, hd, hd)}
    t.update(over)
    return t


@pytest.mark.parametrize("over,match", [
    ({"r": _FakeCuda(2, 100, 4, 64, dtype=torch.float16)}, "must be one of"),
    ({"r": _FakeCuda(2, 100, 4, 128, dtype=torch.bfloat16)}, "head dim"),
    ({"k": _FakeCuda(2, 100, 4, 64)}, "k must be torch.bfloat16"),
    ({"logw": _FakeCuda(2, 100, 4, 64, dtype=torch.bfloat16)},
     "logw must be torch.float32"),
    ({"u": _FakeCuda(4, 32)}, r"u must be \(4, 64\)"),
    ({"s0": _FakeCuda(2, 4, 64, 32)}, r"s0 must be \(2, 4, 64, 64\)"),
    ({"v": _FakeCuda(2, 100, 4, 64, dtype=torch.bfloat16,
                     contiguous=False)}, "v must be contiguous"),
    ({"logw": _FakeCuda(2, 100, 4, 64, ptr=8)}, "logw must be 16-byte aligned"),
    ({"s0": _FakeCuda(2, 4, 64, 64, ptr=4)}, "s0 must be 16-byte aligned"),
])
def test_wkv6_wrapper_refuses_cuda_tensors_the_kernel_does_not_take(
        over, match, monkeypatch):
    """The kernel wrapper never falls back: a CUDA tensor it cannot take
    raises before anything is built or launched."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail("a kernel was built"))
    monkeypatch.setattr(_build, "launch",
                        lambda *a: pytest.fail("a kernel was launched"))
    t = _wkv_fakes(**over)
    with pytest.raises(ValueError, match=match):
        wkv6_fwd(t["r"], t["k"], t["v"], t["logw"], t["u"], t["s0"])


# -- the model --------------------------------------------------------------

def _draw_weights(defs, seed=0):
    """Numpy weights for every leaf of ``defs``: normal leaves N(0, 1) x
    init_scale / sqrt(fan_in) (0.02 for the embedding), ones as ones,
    and the zero-initialised leaves drawn: decay_base ~ N(-0.5, 1) (the
    log-log decay tests/test_kernels.py:60 draws), the others ~ 0.1 N(0,
    1)."""
    rng = np.random.default_rng(seed)

    def one(d):
        name = d.label.rsplit(".", 1)[-1]
        if name == "decay_base":
            return rng.normal(-0.5, 1.0, d.shape).astype(np.float32)
        if name in ZERO_INIT:
            return (0.1 * rng.normal(0, 1, d.shape)).astype(np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        assert d.init in ("normal", "embed"), d
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = (0.02 * d.init_scale if d.init == "embed"
                 else d.init_scale / np.sqrt(fan_in))
        return (scale * rng.normal(0, 1, d.shape)).astype(np.float32)
    return tree_map(one, defs)


def _jax_bundle(dtype, seq=SEQ):
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"),
                     devices=jax.devices()[:1])
    run = JRunConfig(model=j_smoke("rwkv6-3b"),
                     shape=JShapeCell("t", "decode", seq, B),
                     system=JSystemConfig(mode="fcdp", min_shard_size=8,
                                          param_dtype=dtype,
                                          compute_dtype=dtype))
    return JStepBundle(run, mesh)


def _port_bundle(dtype, seq=SEQ):
    run = RunConfig(model=get_smoke_config("rwkv6-3b"),
                    shape=ShapeCell("t", "decode", seq, B),
                    system=SystemConfig(dtype=dtype))
    return StepBundle(run, device="cpu")


@pytest.fixture(scope="module")
def weights():
    return _draw_weights(_port_bundle("float32").defs, seed=0)


def _jax_leaves(tree, dtype):
    return [jnp.asarray(a, dtype) for _, a in tree_items(tree)]


def _np_tree(jtree):
    """A JAX state tree as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, jtree)


def test_port_defs_count_rwkv6_3b_params():
    b = StepBundle(RunConfig(model=get_config("rwkv6-3b"),
                             shape=ShapeCell("t", "decode", 512, 8)),
                   device="cpu")
    assert sum(d.size() for _, d in tree_items(b.defs)) == 3_099_609_600


def test_params_from_jax_bit_equal(weights):
    jb = _jax_bundle("bfloat16")
    pb = _port_bundle("bfloat16")
    # the port enumerates the JAX bundle's leaves, in treedef order
    assert [d.label for d in jb.def_leaves] == [p for p, _ in
                                                tree_items(pb.defs)]
    leaves = _jax_leaves(weights, jnp.bfloat16)
    tree = jax.tree.unflatten(jb.treedef, [np.asarray(x) for x in leaves])
    params = params_from_jax(tree, pb.run.model, device="cpu")
    for (path, t), leaf, d in zip(tree_items(params), leaves, jb.def_leaves):
        a = np.asarray(leaf)
        assert t.shape == a.shape == d.shape, path
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))


def _assert_bf16_carry(t, a, path):
    """The fp32 run's token-shift carry, rounded to bf16 in both packages
    (as the JAX package stores it). Layer 0's time-mix carries the normed
    embedding, computed alike on both sides: the same bf16 bits. Deeper
    carries are rounded from fp32 values that differ by ~1e-7 (the sums
    of the layers below, in another order), and a value that lies on the
    edge of a bf16 rounding step may round to the neighbouring bf16
    number: at most one step apart, and almost all bits equal."""
    got = t.view(torch.int16).numpy().astype(np.int32)
    want = a.view(np.int16).astype(np.int32)
    if path == "pos0.rwkv_tm.xprev":
        np.testing.assert_array_equal(got[0], want[0], path)
    assert np.abs(got - want).max() <= 1, path
    assert (got == want).mean() >= 0.99, path


def _compare_state(got, jtree, dtype):
    want = dict(tree_items(_np_tree(jtree)))
    got = dict(tree_items(got))
    assert list(got) == list(want)
    for path, t in got.items():
        a = want[path]
        assert tuple(t.shape) == a.shape, path
        if path.endswith("xprev"):
            assert t.dtype == torch.bfloat16 and a.dtype.name == "bfloat16"
        else:
            assert t.dtype == torch.float32 and a.dtype == np.float32
        if dtype == "bfloat16":
            _assert_rel(t.float().numpy(), a.astype(np.float32),
                        STATE_RTOL_BF16, path)
        elif path.endswith("xprev"):
            _assert_bf16_carry(t, a, path)
        else:
            np.testing.assert_allclose(t.numpy(), a, rtol=0,
                                       atol=STATE_ATOL_F32, err_msg=path)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def served(request, weights):
    """Prefill of a 128-token prompt and 3 greedy decode steps through
    both packages' steps, from the same weights. Returns per-step
    (logits, tokens, state) of each side."""
    dtype = request.param
    jb, pb = _jax_bundle(dtype), _port_bundle(dtype)
    jleaves = _jax_leaves(weights, jnp.dtype(dtype))
    params = params_from_jax(weights, pb.run.model,
                             dtype=pb.run.system.torch_dtype, device="cpu")
    ids = np.random.default_rng(1).integers(
        1, pb.run.model.vocab_size, (B, SEQ)).astype(np.int32)
    jpre, jdec = jb.make_prefill_step(), jb.make_decode_step()
    pre, dec = pb.make_prefill_step(), pb.make_decode_step()
    jl, jst = jpre(jleaves, jnp.asarray(ids), jb.init_state(jb.run.shape))
    tl, st = pre(params, torch.from_numpy(ids), pb.init_state())
    steps = [(np.asarray(jl, np.float32), tl.float().numpy(),
              _np_tree(jst), st)]
    for _ in range(DECODE_STEPS):
        jtok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        ttok = torch.argmax(tl, dim=-1).to(torch.int32)
        steps[-1] += (jtok, ttok.numpy())
        jl, jst = jdec(jleaves, jnp.asarray(jtok)[:, None], jst)
        tl, st = dec(params, ttok[:, None], st)
        steps.append((np.asarray(jl, np.float32), tl.float().numpy(),
                      _np_tree(jst), st))
    return dtype, steps, (jb, pb, jleaves, params)


def test_prefill_then_decode_match_jax(served):
    dtype, steps, _ = served
    tol = LOGIT_TOL[dtype]
    for i, (jl, tl, *_rest) in enumerate(steps):
        assert tl.shape == jl.shape == (B, 512)
        assert np.isfinite(tl).all()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=tol,
                                   err_msg=f"step {i}")


def test_greedy_tokens_equal(served):
    _, steps, _ = served
    for i, step in enumerate(steps[:-1]):
        jtok, ttok = step[4], step[5]
        np.testing.assert_array_equal(ttok, jtok, f"step {i}")


def test_state_after_prefill_matches_jax(served):
    dtype, steps, _ = served
    _compare_state(steps[0][3], steps[0][2], dtype)


def test_state_after_decode_matches_jax(served):
    dtype, steps, _ = served
    _compare_state(steps[-1][3], steps[-1][2], dtype)


def test_decode_from_a_jax_state(served):
    """One decode step from the JAX package's state after prefill,
    handed over with ``state_from_jax``, equals the JAX step from the
    same state."""
    dtype, steps, (jb, pb, jleaves, params) = served
    jstate_np = steps[0][2]
    tok = steps[0][4]
    state = state_from_jax(jstate_np, device="cpu")
    for (path, t), (_, a) in zip(tree_items(state), tree_items(jstate_np)):
        assert t.dtype == (torch.bfloat16 if path.endswith("xprev")
                           else torch.float32)
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy(), a.view(np.int16) if a.dtype.name == "bfloat16"
            else a, path)
    jstate = jax.tree.map(jnp.asarray, jstate_np)
    jl, jst = jb.make_decode_step()(jleaves, jnp.asarray(tok)[:, None],
                                    jstate)
    tl, st = pb.make_decode_step()(params, torch.from_numpy(tok)[:, None],
                                   state)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=0, atol=LOGIT_TOL[dtype])
    _compare_state(st, jst, dtype)


def test_whole_sequence_apply_equals_prefill(weights):
    """The stack without state (``rwkv_tm_apply`` / ``rwkv_cm_apply``)
    computes the prefill's activations: same weights, same prompt, the
    same output to the bit."""
    from repro_torch.models import stack as stk
    pb = _port_bundle("float32")
    params = params_from_jax(weights, pb.run.model, dtype=torch.float32,
                             device="cpu")
    m = pb.model
    x = m._embed(params, torch.from_numpy(np.random.default_rng(2).integers(
        1, m.cfg.vocab_size, (B, SEQ)).astype(np.int32)))
    y_apply, st = stk.apply_stack(m.cfg, m.plan, m.n_groups,
                                  params["blocks"], x, {})
    y_pre, _ = stk.apply_stack(m.cfg, m.plan, m.n_groups, params["blocks"],
                               x, {"prefill": True}, pb.init_state())
    assert st is None and torch.equal(y_apply, y_pre)


def test_decode_state_shapes_and_dtypes():
    """The port's decode state has the JAX package's leaves, shapes and
    dtypes: {pos0: {rwkv_tm: {s [L,B,H,hd,hd] f32, xprev [L,B,D] bf16},
    rwkv_cm: {xprev [L,B,D] bf16}}}, zeros."""
    jb, pb = _jax_bundle("float32"), _port_bundle("float32")
    want = dict(tree_items(_np_tree(jb.init_state(jb.run.shape))))
    got = dict(tree_items(pb.init_state()))
    assert list(got) == list(want) == ["pos0.rwkv_cm.xprev", "pos0.rwkv_tm.s",
                                       "pos0.rwkv_tm.xprev"]
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape
        assert str(t.dtype).split(".")[-1] == want[path].dtype.name
        assert not t.any()


def test_non_multiple_prompt_raises_on_both_sides(weights):
    """A 96-token prompt is not a multiple of the WKV's 64-step chunk."""
    seq = 96
    jb, pb = _jax_bundle("float32", seq), _port_bundle("float32", seq)
    ids = np.ones((B, seq), np.int32)
    with pytest.raises(AssertionError, match="not divisible"):
        jb.make_prefill_step()(_jax_leaves(weights, jnp.float32),
                               jnp.asarray(ids), jb.init_state(jb.run.shape))
    params = params_from_jax(weights, pb.run.model, dtype=torch.float32,
                             device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        pb.make_prefill_step()(params, torch.from_numpy(ids),
                               pb.init_state())


def test_paged_serving_rejects_rwkv():
    """The paged path has no recurrent state: both packages' launchers
    and plan gates refuse the ssm family."""
    pb = _port_bundle("float32")
    with pytest.raises(ValueError, match="rwkv_cm"):
        check_paged_plan(pb.model)
    with pytest.raises(ValueError, match="rwkv_cm"):
        j_check_paged_plan(_jax_bundle("float32").model)
    argv = ["--arch", "rwkv6-3b", "--smoke", "--requests", "2",
            "--seq-len", "64", "--gen-len", "4", "--batch", "2"]
    with pytest.raises(ValueError, match="paged serving supports"):
        serve_launcher.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match="paged serving supports"):
        j_serve_launcher.main(argv)
