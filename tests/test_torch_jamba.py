"""The port's hybrid (jamba) serve path against the JAX package's, on the
CPU.

Both packages run ``jamba-smoke`` (4 layers in 2 groups of period 2:
attention + MLP, then mamba + MoE; d_model 64, 4/2 heads of 16, mamba
d_state 8, 4 experts top-2, vocab 512) on the same weights, drawn with
numpy from a seed: the JAX bundle on a one-device (pod, data, model)
mesh, the port through ``repro_torch.convert.params_from_jax``. The
mamba leaves that start constant (``A_log`` ones, ``dt_bias`` and
``conv_b`` zeros, ``D_skip`` ones) are overwritten with seeded draws,
the same in both packages, so that the decays vary by channel.

Tolerances, each with its reason:
- the scan's plain version (``kernels.ref.mamba_scan_plain``, what the
  port runs on CPU tensors) is held to the JAX oracle
  ``ref.mamba_scan_ref`` and to the Pallas kernel in interpret mode at
  1e-4, the tolerance of ``tests/test_kernels.py:112-113``; over long
  memory (a = 0.999, 512 steps) |h| grows to ~20 and the bound is
  1e-4 x max |h| instead;
- sublayers in fp32 (``_mamba_core``, ``moe_apply``) within 1e-4
  relative to the tensor's magnitude (fp32 sums in other orders: the
  JAX scan is an associative scan, the port's a sequential walk;
  measured ~2e-7), contiguous-cache attention within 1e-3 (its K/V
  pass through the bf16 cache, where a value on a rounding edge can
  round apart, as in ``tests/test_torch_layers.py``); the MoE's
  dispatch (expert ids, slot positions, keep masks) exactly equal;
- the whole model, greedy tokens equal, and:
  - fp32 logits within 5e-3, not the dense path's 1e-3: both packages
    round K/V to bf16 in the cache, and fp32 values ~1e-7 apart that
    straddle a rounding edge round one bf16 step apart (3 of layer 0's
    4,608 V values here); the mamba state carries each such step to
    every later token. The port against itself with its embedding
    table perturbed by 1e-7 relative moves by up to 1.05e-3; JAX
    against the port measured 1.05e-3 here and 2.2e-3 at worst over 4
    weight seeds (~3e-6 where no value rounds apart);
  - bf16 logits within 0.25, not 0.1: the packages round their bf16
    matmuls and elementwise chains at other places (JAX's ``silu`` is
    four bf16 ops, torch's one), measured 0.03-0.13 over 4 weight
    seeds; a router decision flipped by that noise (the top-2 margin
    of the 4 smoke experts is within a few bf16 steps for some of a
    prompt's tokens) moves one row by ~1 (once in 16 decode steps over
    those seeds, none in this seed's);
  - every state leaf as stated at ``_compare_state``.

The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it to ``mamba_scan_plain``. Greedy picks on the JAX side are a
plain argmax: the JAX package's ``build_greedy_pick`` fails on a mesh
whose model axis has size 1 (ROADMAP Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeCell as JShapeCell
from repro.configs.base import SystemConfig as JSystemConfig
from repro.configs.registry import get_smoke_config as j_smoke
from repro.core.engine import StepBundle as JStepBundle
from repro.core.engine.serve import check_paged_plan as j_check_paged_plan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.mesh import make_mesh
from repro.models import attention as jattn
from repro.models import sublayers as jsl
from repro.models.common import MeshInfo as JMeshInfo
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeCell
from repro_torch.configs.base import SystemConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core.engine import StepBundle
from repro_torch.core.engine.serve import check_paged_plan, default_paged_kv
from repro_torch.core.partition import tree_items, tree_map
from repro_torch.kernels import ops, ref
from repro_torch.kernels.mamba_scan import mamba_scan_fwd
from repro_torch.models import attention, sublayers

B, SEQ, DECODE_STEPS, MAX_LEN = 2, 64, 3, 72
SCAN_TOL = 1e-4            # tests/test_kernels.py:112-113
CORE_RTOL = 1e-4           # fp32 sublayers, relative to the magnitude
ATTN_TOL = 1e-3            # through the bf16 cache
LOGIT_TOL = {"float32": 5e-3, "bfloat16": 0.25}
# bf16 state leaf, per K/V slot or mamba row that no routing difference
# reaches, relative to max |leaf|: 3x the 1.6e-2 measured at worst over
# 4 weight seeds (a flipped token's slots: 0.26-0.34)
BF16_SLOT_TOL = 5e-2


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh((1, 1, 1), ("pod", "data", "model"),
                     devices=jax.devices()[:1])


def _in_mesh(mesh, fn, *args):
    f = shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                  out_specs=P(), check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(f)(*args))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_rel(got, want, rtol, what=""):
    """max |got - want| <= rtol * max |want|: a tolerance relative to the
    magnitude of the whole tensor (elementwise relative tolerances blow
    up on entries that cancel towards 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, mag = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * mag, f"{what}: max |diff| {err} > {rtol} x {mag}"


# -- the scan -------------------------------------------------------------------

def _scan_inputs(rng, shape, with_h0=False, a_const=None):
    """a ~ U(0.2, 0.999) as tests/test_kernels.py:108 draws it (or a
    constant), b ~ N(0, 1), h0 ~ N(0, 1)."""
    Bs, S, C = shape
    a = (np.full(shape, a_const, np.float32) if a_const is not None
         else rng.uniform(0.2, 0.999, shape).astype(np.float32))
    b = rng.normal(0, 1, shape).astype(np.float32)
    h0 = rng.normal(0, 1, (Bs, C)).astype(np.float32) if with_h0 else None
    return a, b, h0


SCAN_CASES = [
    # (shape, with_h0, a_const)
    ((1, 64, 32), False, None),
    ((2, 256, 64), True, None),
    ((1, 128, 48), True, None),
    ((3, 1, 40), True, None),          # decode: S = 1 from the carry
    ((2, 77, 1000), False, None),      # ragged S and C
    ((1, 512, 16), False, 0.999),      # long memory
]


@pytest.mark.parametrize("shape,with_h0,a_const", SCAN_CASES)
def test_mamba_scan_plain_matches_jax_ref(shape, with_h0, a_const, rng):
    a, b, h0 = _scan_inputs(rng, shape, with_h0, a_const)
    Bs, S, C = shape
    want, want_last = jref.mamba_scan_ref(
        jnp.asarray(a).reshape(Bs, S, C, 1), jnp.asarray(b).reshape(
            Bs, S, C, 1), None if h0 is None else jnp.asarray(h0)[..., None])
    got = ref.mamba_scan_plain(_t(a), _t(b), None if h0 is None else _t(h0))
    assert got.dtype == torch.float32 and got.shape == shape
    want = np.asarray(want).reshape(shape)
    mag = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=SCAN_TOL * mag)
    np.testing.assert_allclose(got[:, -1].numpy(),
                               np.asarray(want_last)[..., 0], rtol=0,
                               atol=SCAN_TOL * mag)


@pytest.mark.parametrize("shape", [(1, 64, 32), (2, 256, 64), (1, 128, 48)])
@pytest.mark.parametrize("chunk", [32, 64])
def test_mamba_scan_plain_matches_pallas_interpret(shape, chunk, rng):
    """The TPU kernel itself, run as the JAX package's own tests run it
    on the CPU (tests/test_kernels.py:105's sweep)."""
    a, b, _ = _scan_inputs(rng, shape)
    want = jops.ssm_scan(jnp.asarray(a), jnp.asarray(b), chunk=chunk,
                         channel_block=32, interpret=True)
    got = ref.mamba_scan_plain(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("s1,s2", [(63, 1), (32, 45), (1, 1)])
def test_mamba_scan_plain_carries_state_across_calls(s1, s2, rng):
    """Scanning s1 steps and then s2 from the returned last state equals
    scanning s1 + s2 (what the decode step relies on), bit for bit: the
    walk is sequential either way."""
    a, b, h0 = (_t(x) for x in _scan_inputs(rng, (2, s1 + s2, 24), True))
    hs = ref.mamba_scan_plain(a, b, h0)
    hs1 = ref.mamba_scan_plain(a[:, :s1], b[:, :s1], h0)
    hs2 = ref.mamba_scan_plain(a[:, s1:], b[:, s1:], hs1[:, -1])
    assert torch.equal(torch.cat([hs1, hs2], 1), hs)


def test_mamba_scan_plain_takes_bf16(rng):
    a, b, h0 = (_t(x) for x in _scan_inputs(rng, (2, 16, 24), True))
    got = ops.mamba_scan(a.bfloat16(), b.bfloat16(), h0)
    want = ref.mamba_scan_plain(a.bfloat16().float(), b.bfloat16().float(),
                                h0)
    assert got.dtype == torch.float32 and torch.equal(got, want)


# -- dispatch -----------------------------------------------------------------

def test_mamba_scan_cpu_takes_the_plain_version_and_launches_nothing(rng):
    args = [_t(x) for x in _scan_inputs(rng, (2, 16, 24), True)]
    launches, calls = ops.mamba_scan.launches, ops.mamba_scan.calls
    got = ops.mamba_scan(*args)
    assert torch.equal(got, ref.mamba_scan_plain(*args))
    assert (ops.mamba_scan.launches == launches
            and ops.mamba_scan.calls == calls + 1)


def test_mamba_scan_rejects_other_devices():
    t = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no mamba_scan kernel"):
        ops.mamba_scan(t, t)


def test_mamba_scan_wrapper_refuses_what_the_kernel_does_not_take(rng):
    """The kernel wrapper never falls back: a tensor it cannot take
    raises before anything is built or launched."""
    a, b, h0 = (_t(x) for x in _scan_inputs(rng, (1, 8, 16), True))
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_fwd(a, b, h0)
    with pytest.raises(ValueError, match="one of"):
        mamba_scan_fwd(a.double(), b.double())
    with pytest.raises(ValueError, match=r"\[B,S,C\]"):
        mamba_scan_fwd(a[0], b[0])


class _FakeCuda:
    """Stands in for a contiguous CUDA tensor on a machine without one."""

    def __init__(self, *shape, dtype=torch.float32):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


def test_cuda_tensor_launches_or_raises(monkeypatch):
    """A CUDA tensor goes to the kernel: when the kernel cannot be built
    the call raises, counts no launch and never runs the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba_scan as scan_mod

    def no_nvcc(name):
        raise RuntimeError(f"cannot build {name}")
    monkeypatch.setattr(_build, "load", no_nvcc)
    monkeypatch.setattr(ref, "mamba_scan_plain",
                        lambda *a, **kw: pytest.fail("plain version ran"))
    scan_mod._lib.cache_clear()
    a = _FakeCuda(8, 512, 131072)
    launches = ops.mamba_scan.launches
    try:
        with pytest.raises(RuntimeError, match="cannot build mamba_scan"):
            ops.mamba_scan(a, a, _FakeCuda(8, 131072))
    finally:
        scan_mod._lib.cache_clear()
    assert ops.mamba_scan.launches == launches


# -- sublayers -------------------------------------------------------------------

def _mamba_weights(cfg, rng):
    """Every mamba leaf drawn: projections ~ N(0, 1) / sqrt(fan_in) (conv
    x 0.5), A_log = log U(1, d_state), dt_bias ~ N(-2, 0.5), conv_b ~
    0.1 N(0, 1), D_skip ~ 1 + 0.1 N(0, 1)."""
    defs = sublayers.mamba_defs(cfg)
    out = {}
    for n, d in defs.items():
        out[n] = _draw_leaf(n, d, rng)
    return out


def _draw_leaf(name, d, rng):
    if name == "A_log":
        return np.log(rng.uniform(1.0, d.shape[-1], d.shape)).astype(
            np.float32)
    if name == "dt_bias":
        return rng.normal(-2.0, 0.5, d.shape).astype(np.float32)
    if name == "conv_b":
        return (0.1 * rng.normal(0, 1, d.shape)).astype(np.float32)
    if name == "D_skip":
        return (1.0 + 0.1 * rng.normal(0, 1, d.shape)).astype(np.float32)
    if d.init == "ones":
        return np.ones(d.shape, np.float32)
    assert d.init in ("normal", "embed"), d
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    scale = (0.02 * d.init_scale if d.init == "embed"
             else d.init_scale / np.sqrt(fan_in))
    return (scale * rng.normal(0, 1, d.shape)).astype(np.float32)


MAMBA_CASES = [
    # (S, with_state): prefill from zero state, decode from a carried one
    (64, False),
    (37, False),       # a prompt length that is no multiple of anything
    (1, True),
    (5, True),
    (1024, False),     # the JAX scan's 512-step chunks
]


@pytest.mark.parametrize("S,with_state", MAMBA_CASES)
def test_mamba_core_matches_jax(S, with_state, mesh1, rng):
    cfg = get_smoke_config("jamba-v0.1-52b")
    jcfg = j_smoke("jamba-v0.1-52b")
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    p = _mamba_weights(cfg, rng)
    Bs = 1 if S > 512 else 2
    xz = rng.normal(0, 1, (Bs, S, 2 * d_in)).astype(np.float32)
    conv = (rng.normal(0, 1, (Bs, mc.d_conv - 1, d_in)).astype(np.float32)
            if with_state else None)
    h = (rng.normal(0, 1, (Bs, d_in, mc.d_state)).astype(np.float32)
         if with_state else None)
    mi = JMeshInfo.from_mesh(mesh1)
    names = sorted(p)

    if with_state:
        def jfn(xz_, conv_, h_, *w):
            return jsl._mamba_core(jcfg, mi, dict(zip(names, w)), xz_,
                                   conv_state=conv_, h_state=h_)
        want_y, (want_conv, want_h) = _in_mesh(
            mesh1, jfn, jnp.asarray(xz), jnp.asarray(conv), jnp.asarray(h),
            *(jnp.asarray(p[n]) for n in names))
    else:
        def jfn(xz_, *w):
            return jsl._mamba_core(jcfg, mi, dict(zip(names, w)), xz_)
        want_y, (want_conv, want_h) = _in_mesh(
            mesh1, jfn, jnp.asarray(xz), *(jnp.asarray(p[n]) for n in names))
    got_y, (got_conv, got_h) = sublayers._mamba_core(
        cfg, {n: _t(a) for n, a in p.items()}, _t(xz),
        conv_state=None if conv is None else _t(conv),
        h_state=None if h is None else _t(h))
    assert got_y.shape == want_y.shape and got_h.dtype == torch.float32
    _assert_rel(got_y.numpy(), want_y, CORE_RTOL, "y")
    _assert_rel(got_h.numpy(), want_h, CORE_RTOL, "h")
    np.testing.assert_array_equal(got_conv.numpy(), want_conv)


def test_softplus_is_jax_softplus_without_a_threshold():
    x = np.linspace(-60, 60, 2401, dtype=np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = sublayers.softplus(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


def _moe_weights(cfg, rng, skew=0.0):
    """MoE leaves drawn as the bundle's init does; ``skew`` > 0 adds
    skew / d_model to expert 0's router column, which (with inputs
    shifted to a positive mean) raises expert 0's logit by ~skew for
    every token: most tokens pick it, and the capacity drops some."""
    p = {n: _draw_leaf(n, d, rng) for n, d in sublayers.moe_defs(cfg).items()}
    p["router"][:, 0] += skew / cfg.d_model
    return p


MOE_CASES = [
    # (B, S, token_chunk, skew)
    (2, 32, 8192, 0.0),
    (2, 32, 8192, 3.0),        # skewed router: the capacity drops slots
    (2, 32, 16, 0.0),          # 4 chunks of 16 tokens
    (2, 32, 16, 3.0),
    (3, 7, 8, 0.0),            # 8 does not divide 21: one chunk of 21
    (2, 1, 8192, 0.0),         # decode: capacity floor of 4
]


@pytest.mark.parametrize("Bs,S,chunk,skew", MOE_CASES)
def test_moe_apply_matches_jax(Bs, S, chunk, skew, mesh1, rng):
    cfg = get_smoke_config("jamba-v0.1-52b")
    jcfg = j_smoke("jamba-v0.1-52b")
    jsys = JSystemConfig(moe_token_chunk=chunk)
    p = _moe_weights(cfg, rng, skew)
    x = rng.normal(2.0 if skew else 0.0, 1, (Bs, S, cfg.d_model)).astype(
        np.float32)
    mi = JMeshInfo.from_mesh(mesh1)
    names = sorted(p)

    def jfn(x_, *w):
        return jsl.moe_apply(jcfg, jsys, mi, dict(zip(names, w)), x_)
    want_y, want_aux = _in_mesh(mesh1, jfn, jnp.asarray(x),
                                *(jnp.asarray(p[n]) for n in names))
    tp = {n: _t(a) for n, a in p.items()}
    got_y, got_aux = sublayers.moe_apply(cfg, tp, _t(x), chunk,
                                         with_aux=True)
    _assert_rel(got_y.numpy(), want_y, CORE_RTOL, "y")
    np.testing.assert_allclose(got_aux.item(), float(want_aux), rtol=1e-5)
    # serving asks for no aux loss: the same output, no loss computed
    serve_y, serve_aux = sublayers.moe_apply(cfg, tp, _t(x), chunk)
    assert serve_aux is None and torch.equal(serve_y, got_y)

    # the dispatch of every chunk, exactly: router top-2, slot positions
    # and keep masks
    T = Bs * S
    n = T // chunk if T % chunk == 0 and chunk < T else 1
    c = T // n
    capacity = sublayers.moe_capacity(cfg, c)
    h = sublayers.rms_norm(_t(x), tp["norm"], cfg.norm_eps).reshape(T, -1)
    dropped = 0
    for i in range(n):
        hc = h[i * c:(i + 1) * c]
        logits = (jnp.asarray(hc.numpy()) @ jnp.asarray(p["router"])
                  ).astype(jnp.float32)
        jgate, jeid = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                    cfg.moe.top_k)
        jpos, jkeep = jsl._dispatch_indices(jeid.reshape(-1),
                                            cfg.moe.num_experts, capacity)
        _, gate, eid = sublayers._route(cfg, tp, hc)
        pos, keep = sublayers._dispatch_indices(eid.reshape(-1), capacity)
        np.testing.assert_array_equal(eid.numpy(), np.asarray(jeid))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        np.testing.assert_allclose(gate.numpy(), np.asarray(jgate)
                                   / np.asarray(jgate).sum(-1, keepdims=True),
                                   rtol=0, atol=1e-6)
        dropped += int((~keep).sum())
    assert (dropped > 0) == (skew > 0), dropped


@pytest.mark.parametrize("seed", range(4))
def test_dispatch_indices_match_jax(seed):
    """Slot positions and keep masks of random expert ids, exactly,
    including ids that overflow the capacity."""
    r = np.random.default_rng(seed)
    eid = r.integers(0, 6, (200,)).astype(np.int32)
    pos, keep = sublayers._dispatch_indices(torch.from_numpy(eid).long(), 24)
    jpos, jkeep = jsl._dispatch_indices(jnp.asarray(eid), 6, 24)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert not keep.all()


def _attn_weights(cfg, rng):
    return {k: rng.normal(0, 0.3, d.shape).astype(np.float32)
            for k, d in sublayers.attn_defs(cfg).items()}


ATTN_NAMES = ("wq", "wk", "wv", "wo")


@pytest.mark.parametrize("S", [1, 12])
def test_attention_block_contiguous_cache_matches_jax(S, mesh1, rng):
    """A prompt of S tokens written at idx 5 of a cache holding 5 stale
    random positions, then one decode token at idx 5 + S: outputs, the
    caches and idx, against the JAX package's ``kv_cache`` branch."""
    cfg = get_smoke_config("jamba-v0.1-52b")
    jcfg = j_smoke("jamba-v0.1-52b")
    p = _attn_weights(cfg, rng)
    L = 24
    shape = (B, L, cfg.num_kv_heads, cfg.resolved_head_dim())
    caches = [rng.normal(0, 1, shape).astype(np.float32) for _ in range(2)]
    mi = JMeshInfo.from_mesh(mesh1)

    def jfn(x_, pos_, k_, v_, idx_, *w):
        return jattn.attention_block(x_, *w, None, None, None, jcfg, mi,
                                     pos_, kv_cache=(k_, v_, idx_))
    jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in caches)
    jidx = jnp.asarray(5, jnp.int32)
    tk, tv = (_t(a).bfloat16() for a in caches)
    tidx = torch.tensor(5, dtype=torch.int32)
    for step, (n, positions) in enumerate(
            ((S, np.arange(S)[None]), (1, None))):
        x = rng.normal(0, 1, (B, n, cfg.d_model)).astype(np.float32)
        if positions is None:          # decode: position idx
            positions = np.asarray(jidx).reshape(1, 1)
        want_y, (jk, jv, jidx) = jax.jit(shard_map(
            jfn, mesh=mesh1, in_specs=tuple(P() for _ in range(9)),
            out_specs=P(), check_vma=False))(
            jnp.asarray(x), jnp.asarray(positions, jnp.int32), jk, jv, jidx,
            *(jnp.asarray(p[nm]) for nm in ATTN_NAMES))
        got_y, (ck, cv, cidx) = attention.attention_block(
            _t(x), *(_t(p[nm]) for nm in ATTN_NAMES), None, None, None, cfg,
            torch.from_numpy(np.asarray(positions, np.int64)),
            kv_cache=(tk, tv, tidx))
        assert ck is tk and cv is tv and cidx is tidx     # in place
        assert int(cidx) == int(jidx), step
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)
        for got, want in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=2e-2, atol=2e-2)


def test_contiguous_cache_overflow_raises(mesh1, rng):
    """A write past the cache's end fails in the port (on the CPU a
    RuntimeError before anything is written); the JAX package's
    ``dynamic_update_slice`` clamps it to the end without a word: a
    3-token write at idx 6 into 8 positions lands on positions 5-7 and
    idx becomes 9 (ROADMAP Queue 3)."""
    cfg = get_smoke_config("jamba-v0.1-52b")
    jcfg = j_smoke("jamba-v0.1-52b")
    p = _attn_weights(cfg, rng)
    st = sublayers.attn_init_state(cfg, B, 8, "cpu")
    st["idx"].fill_(6)
    x = rng.normal(0, 1, (B, 3, cfg.d_model)).astype(np.float32)
    with pytest.raises(RuntimeError, match="KV cache overflow"):
        attention.attention_block(
            _t(x), *(_t(p[nm]) for nm in ATTN_NAMES), None, None, None, cfg,
            torch.arange(3)[None], kv_cache=(st["k"], st["v"], st["idx"]))
    assert int(st["idx"]) == 6 and not st["k"].any()
    mi = JMeshInfo.from_mesh(mesh1)

    def jfn(x_, k_, v_, idx_, *w):
        return jattn.attention_block(x_, *w, None, None, None, jcfg, mi,
                                     jnp.arange(3)[None],
                                     kv_cache=(k_, v_, idx_))
    _, (jk, _, jidx) = _in_mesh(
        mesh1, jfn, jnp.asarray(x), jnp.zeros(st["k"].shape, jnp.bfloat16),
        jnp.zeros(st["v"].shape, jnp.bfloat16), jnp.asarray(6, jnp.int32),
        *(jnp.asarray(p[nm]) for nm in ATTN_NAMES))
    written = np.abs(np.asarray(jk, np.float32)).sum(axis=(0, 2, 3)) > 0
    assert int(jidx) == 9
    np.testing.assert_array_equal(written, [False] * 5 + [True] * 3)


# -- the model --------------------------------------------------------------

def test_port_defs_count_jamba_params():
    """51,570,315,264 parameters at full depth, 26,053,595,136 at the 16
    layers the one-card serve path runs, 3,678,941,184 for the
    full-width parity model (2 layers, period 2)."""
    from repro_torch.models.lm import LM
    full = get_config("jamba-v0.1-52b")
    for cfg, want in (
            (full, 51_570_315_264),
            (dataclasses.replace(full, num_layers=16), 26_053_595_136),
            (dataclasses.replace(full, num_layers=2, hybrid_period=2,
                                 hybrid_attn_positions=(0,)),
             3_678_941_184)):
        defs = LM(cfg, SystemConfig()).defs
        assert sum(d.size() for _, d in tree_items(defs)) == want


def test_layer_plan_matches_jax():
    from repro.models.lm import layer_plan as j_layer_plan
    from repro_torch.models.lm import layer_plan
    from repro.configs.registry import get_config as j_get_config
    for cfg, jcfg in ((get_config("jamba-v0.1-52b"),
                       j_get_config("jamba-v0.1-52b")),
                      (get_smoke_config("jamba-v0.1-52b"),
                       j_smoke("jamba-v0.1-52b"))):
        assert layer_plan(cfg) == j_layer_plan(jcfg)
    plan, groups = layer_plan(get_config("jamba-v0.1-52b"))
    assert groups == 4 and plan[4] == ("attn", "mlp")
    assert plan[:2] == [("mamba", "mlp"), ("mamba", "moe")]
    with pytest.raises(ValueError, match="whole number of periods"):
        layer_plan(dataclasses.replace(get_config("jamba-v0.1-52b"),
                                       num_layers=12))


def _draw_weights(defs, seed=0):
    rng = np.random.default_rng(seed)
    return tree_map(lambda d: _draw_leaf(d.label.rsplit(".", 1)[-1], d, rng),
                    defs)


def _jax_bundle(dtype, max_len=MAX_LEN):
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"),
                     devices=jax.devices()[:1])
    run = JRunConfig(model=j_smoke("jamba-v0.1-52b"),
                     shape=JShapeCell("t", "decode", max_len, B),
                     system=JSystemConfig(mode="fcdp", min_shard_size=8,
                                          param_dtype=dtype,
                                          compute_dtype=dtype))
    return JStepBundle(run, mesh)


def _port_bundle(dtype, max_len=MAX_LEN, cfg=None):
    run = RunConfig(model=cfg or get_smoke_config("jamba-v0.1-52b"),
                    shape=ShapeCell("t", "decode", max_len, B),
                    system=SystemConfig(dtype=dtype))
    return StepBundle(run, device="cpu")


@pytest.fixture(scope="module")
def weights():
    return _draw_weights(_port_bundle("float32").defs, seed=0)


def _jax_leaves(tree, dtype):
    return [jnp.asarray(a, dtype) for _, a in tree_items(tree)]


def _np_tree(jtree):
    return jax.tree.map(np.asarray, jtree)


def _clone(state):
    return tree_map(lambda t: t.clone(), state)


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


def test_decode_state_shapes_and_dtypes():
    """The port's decode state has the JAX package's leaves, shapes and
    dtypes: {pos0: {attn: {idx [L] i32, k/v [L,B,max_len,KVH,hd] bf16}},
    pos1: {mamba: {conv [L,B,d_conv-1,d_in] bf16, h [L,B,d_in,n]
    f32}}}, zeros."""
    jb, pb = _jax_bundle("float32"), _port_bundle("float32")
    want = dict(tree_items(_np_tree(jb.init_state(jb.run.shape))))
    got = dict(tree_items(pb.init_state()))
    assert list(got) == list(want) == [
        "pos0.attn.idx", "pos0.attn.k", "pos0.attn.v", "pos1.mamba.conv",
        "pos1.mamba.h"]
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape, path
        assert str(t.dtype).split(".")[-1] == want[path].dtype.name, path
        assert not t.any()


def _compare_state(got, jtree, dtype, step, flips=()):
    """Every leaf of the decode state against the JAX package's, with its
    name, shape and dtype; ``idx`` exactly. The values, relative to the
    leaf's magnitude:
    - fp32 runs: max |diff| <= 1e-2 x max |leaf| and mean |diff| <= 1e-3
      x mean |leaf|. A K/V or conv value that rounds one bf16 step apart
      (see the module's note) moves the later tokens' K/V and the mamba
      state: measured 4.3e-3 and 2.1e-4 at worst over 4 weight seeds;
    - bf16 runs: mean |diff| <= 5e-2 x mean |leaf| (measured 0.6-5e-2
      over 4 weight seeds, 1.3e-2 in this one), and max |diff| <=
      BF16_SLOT_TOL x max |leaf| in every K/V slot (layer, row,
      position) and every mamba state row (layer, row) that no
      routing difference reaches. ``flips`` (``_flipped_tokens``) holds
      the tokens the MoE dispatched otherwise in the two packages: such
      a token's residual leaves its group far apart, so its K/V slots
      in every later group (up to 0.34 x max |leaf| measured) and its
      row's mamba state in every later group are held by the mean
      alone."""
    want = dict(tree_items(_np_tree(jtree)))
    got = dict(tree_items(got))
    assert list(got) == list(want)
    for path, t in got.items():
        a = want[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).split(".")[-1] == a.dtype.name, path
        what = f"step {step} {path}"
        if path.endswith("idx"):
            np.testing.assert_array_equal(t.numpy(), a, what)
            continue
        g, w = t.float().numpy().astype(np.float64), a.astype(np.float64)
        d = np.abs(g - w)
        if dtype == "float32":
            assert d.max() <= 1e-2 * np.abs(w).max(), what
            assert d.mean() <= 1e-3 * np.abs(w).mean(), what
            continue
        assert d.mean() <= 5e-2 * np.abs(w).mean(), what
        if path.endswith((".k", ".v")):        # [L, B, max_len, KVH, hd]
            d = d.max(axis=(3, 4))
            for group, row, pos in flips:
                d[group + 1:, row, pos] = 0
        else:                                  # [L, B, ...]
            d = d.reshape(d.shape[0], d.shape[1], -1).max(-1)
            for group, row, _pos in flips:
                d[group + 1:, row] = 0
        worst = np.unravel_index(d.argmax(), d.shape)
        assert d.max() <= BF16_SLOT_TOL * np.abs(w).max(), (what, worst)


def _logged_dispatch():
    """Record every MoE dispatch in both packages, as the experts that
    each (token, slot) is kept for (-1 where the capacity drops it):
    the JAX package's ``_dispatch_indices`` (through a host callback, as
    its jitted step runs) and the port's. Returns (JAX log, port log,
    restore)."""
    jlog, tlog = [], []
    jorig, torig = jsl._dispatch_indices, sublayers._dispatch_indices

    def jlogged(eid_flat, num_experts, capacity):
        pos, keep = jorig(eid_flat, num_experts, capacity)
        jax.debug.callback(lambda e: jlog.append(np.asarray(e)),
                           jnp.where(keep, eid_flat, -1))
        return pos, keep

    def tlogged(eid_flat, capacity):
        pos, keep = torig(eid_flat, capacity)
        tlog.append(torch.where(keep, eid_flat, -1).numpy())
        return pos, keep

    jsl._dispatch_indices, sublayers._dispatch_indices = jlogged, tlogged

    def restore():
        jsl._dispatch_indices, sublayers._dispatch_indices = jorig, torig
    return jlog, tlog, restore


def _flipped_tokens(jlog, tlog, k, n_groups, first_step=0):
    """The tokens dispatched otherwise in the two logs (other top-k
    experts, or a slot kept in one and dropped in the other), as
    (group, batch row, position). The logs hold one dispatch per group
    and step, in order: the prefill's (B x SEQ tokens), then each
    decode step's (B tokens, at position SEQ + step - 1). A flip moves
    the slot positions of the chunk's later tokens, so a token of
    another row may cross the capacity in one package only. Logs that
    start at decode step ``first_step`` hold no prefill."""
    assert len(jlog) == len(tlog)
    out = set()
    for call, (je, te) in enumerate(zip(jlog, tlog)):
        step, group = divmod(call, n_groups)
        step += first_step
        je, te = je.reshape(-1, k), te.reshape(-1, k)
        per_row = je.shape[0] // B
        diff = (np.sort(je, -1) != np.sort(te, -1)).any(-1)
        for t in np.nonzero(diff)[0].tolist():
            row, pos = divmod(t, per_row)
            out.add((group, row, pos if step == 0 else SEQ + step - 1))
    return out


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def served(request, weights):
    """Prefill of a 64-token prompt and 3 greedy decode steps through both
    packages' steps, from the same weights. Returns per-step (JAX
    logits, port logits, JAX state, port state (a copy), the tokens
    dispatched otherwise by the MoE so far (``_flipped_tokens``), JAX
    tokens, port tokens)."""
    dtype = request.param
    jb, pb = _jax_bundle(dtype), _port_bundle(dtype)
    jleaves = _jax_leaves(weights, jnp.dtype(dtype))
    params = params_from_jax(weights, pb.run.model,
                             dtype=pb.run.system.torch_dtype, device="cpu")
    ids = np.random.default_rng(1).integers(
        1, pb.run.model.vocab_size, (B, SEQ)).astype(np.int32)
    n_moe = sum(kinds[1] == "moe" for kinds in pb.model.plan)
    assert n_moe == 1

    def flips(jlog, tlog):
        return _flipped_tokens(jlog, tlog, pb.run.model.moe.top_k,
                               pb.model.n_groups)
    jlog, tlog, restore = _logged_dispatch()
    try:
        jpre, jdec = jb.make_prefill_step(), jb.make_decode_step()
        pre, dec = pb.make_prefill_step(), pb.make_decode_step()
        jl, jst = jpre(jleaves, jnp.asarray(ids),
                       jb.init_state(jb.run.shape))
        tl, st = pre(params, torch.from_numpy(ids), pb.init_state())
        jax.effects_barrier()
        steps = [[np.asarray(jl, np.float32), tl.float().numpy(),
                  _np_tree(jst), _clone(st), flips(jlog, tlog)]]
        for _ in range(DECODE_STEPS):
            jtok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
            ttok = torch.argmax(tl, dim=-1).to(torch.int32)
            steps[-1] += [jtok, ttok.numpy()]
            jl, jst = jdec(jleaves, jnp.asarray(jtok)[:, None], jst)
            tl, st = dec(params, ttok[:, None], st)
            jax.effects_barrier()
            steps.append([np.asarray(jl, np.float32), tl.float().numpy(),
                          _np_tree(jst), _clone(st), flips(jlog, tlog)])
    finally:
        restore()
    assert len(tlog) == pb.model.n_groups * (1 + DECODE_STEPS)
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
        np.testing.assert_array_equal(step[6], step[5], f"step {i}")


def test_state_after_each_step_matches_jax(served):
    dtype, steps, _ = served
    for i, step in enumerate(steps):
        if dtype == "float32":       # fp32 dispatch is exactly equal
            assert not step[4], step[4]
        _compare_state(step[3], step[2], dtype, i, step[4])
        assert int(step[3]["pos0"]["attn"]["idx"][0]) == SEQ + i


def test_decode_from_a_jax_state(served):
    """One decode step from the JAX package's state after prefill,
    handed over with ``state_from_jax`` (bf16 and int32 leaves bit for
    bit), equals the JAX step from the same state."""
    dtype, steps, (jb, pb, jleaves, params) = served
    jstate_np, tok = steps[0][2], steps[0][5]
    state = state_from_jax(jstate_np, device="cpu")
    for (path, t), (_, a) in zip(tree_items(state), tree_items(jstate_np)):
        assert str(t.dtype).split(".")[-1] == a.dtype.name, path
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy(), a.view(np.int16) if a.dtype.name == "bfloat16"
            else a, path)
    jstate = jax.tree.map(jnp.asarray, jstate_np)
    jlog, tlog, restore = _logged_dispatch()
    try:
        jl, jst = jb.make_decode_step()(jleaves, jnp.asarray(tok)[:, None],
                                        jstate)
        tl, st = pb.make_decode_step()(params,
                                       torch.from_numpy(tok)[:, None], state)
        jax.effects_barrier()
    finally:
        restore()
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=0, atol=LOGIT_TOL[dtype])
    flips = _flipped_tokens(jlog, tlog, pb.run.model.moe.top_k,
                            pb.model.n_groups, first_step=1)
    assert len(tlog) == pb.model.n_groups and (dtype != "float32"
                                               or not flips)
    _compare_state(st, jst, dtype, 1, flips)


def test_odd_prompt_length_matches_jax(weights):
    """A 37-token prompt (no multiple of the scan's or any chunk) in fp32,
    prefill and one decode step."""
    jb, pb = _jax_bundle("float32"), _port_bundle("float32")
    jleaves = _jax_leaves(weights, jnp.float32)
    params = params_from_jax(weights, pb.run.model, dtype=torch.float32,
                             device="cpu")
    ids = np.random.default_rng(3).integers(1, 512, (B, 37)).astype(np.int32)
    jl, jst = jb.make_prefill_step()(jleaves, jnp.asarray(ids),
                                     jb.init_state(jb.run.shape))
    tl, st = pb.make_prefill_step()(params, torch.from_numpy(ids),
                                    pb.init_state())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL["float32"])
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    jl, _ = jb.make_decode_step()(jleaves, jnp.asarray(tok), jst)
    tl, _ = pb.make_decode_step()(params, torch.from_numpy(tok), st)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL["float32"])


def test_paged_serving_rejects_jamba():
    """The paged path holds no recurrent state: both packages' plan
    gates refuse the hybrid family."""
    pb = _port_bundle("float32")
    with pytest.raises(ValueError, match="mamba"):
        check_paged_plan(pb.model)
    with pytest.raises(ValueError, match="mamba"):
        j_check_paged_plan(_jax_bundle("float32").model)


# -- paged equals contiguous inside the port ---------------------------------

DENSE = dict(name="t-dense", family="dense", num_layers=4, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             qkv_bias=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_equals_contiguous_bit_for_bit(dtype):
    """The dense smoke model served both ways inside the port: the
    prompt as one prefill chunk over pages that cover exactly the
    contiguous cache's ``max_len``, then greedy decode steps. Every
    logit is equal to the bit: the two paths compute the same
    operations on tensors of the same shapes (the gathered pages are
    the cache's positions in order; unwritten positions differ, stale
    pages against zeros, but the causal mask gives them weight exactly
    0)."""
    cfg = ModelConfig(**DENSE)
    S, max_len, steps = 24, 32, 4
    pb = _port_bundle(dtype, max_len=max_len, cfg=cfg)
    params = pb.init_all_params(seed=0)
    kv = default_paged_kv(pb, pb.run.shape)
    assert kv.max_pages_per_seq * kv.page_size == max_len
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int64))
    # contiguous
    lc, st = pb.make_prefill_step()(params, ids, pb.init_state())
    # paged: row r owns pages 1 + r * mpps ... ; stale pools, not zeros
    pools = pb.init_paged_state(kv)
    gen = torch.Generator().manual_seed(9)
    for t in pools["pos0"]["attn"].values():
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    mpps = kv.max_pages_per_seq
    table = (1 + torch.arange(B)[:, None] * mpps
             + torch.arange(mpps)[None, :]).to(torch.int32)
    lp, pools = pb.make_prefill_chunk_step(kv)(
        params, ids, table, torch.zeros(B, dtype=torch.int32),
        torch.full((B,), S - 1, dtype=torch.int32), pools)
    assert torch.equal(lp, lc)
    dec_c, dec_p = pb.make_decode_step(), pb.make_paged_decode_step(kv)
    pick = pb.make_greedy_pick()
    for i in range(steps):
        tok = pick(lc)
        assert torch.equal(tok, pick(lp))
        lc, st = dec_c(params, tok[:, None].long(), st)
        lp, pools = dec_p(params, tok[:, None].long(), table,
                          torch.full((B,), S + i, dtype=torch.int32), pools)
        assert torch.equal(lp, lc), f"decode step {i}"
