"""The port's layers against their JAX counterparts, in fp32.

The JAX functions that reduce over the tensor-parallel axis run inside
``shard_map`` on a one-device ``(pod, data, model)`` mesh, the mesh the
port's world of one rank corresponds to. Inputs come from numpy and
feed both sides; the tolerance is 1e-5 (fp32; the two packages order
their sums differently), 2e-5 where attention is involved (the
tolerance of the kernel tests)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SystemConfig as JSystemConfig
from repro.launch.mesh import make_mesh
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import sublayers as jsl
from repro.models.common import MeshInfo as JMeshInfo
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, sublayers

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(name="t-dense", family="dense", num_layers=1, d_model=64,
           num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
           qkv_bias=True, rope_theta=1_000_000.0, norm_eps=1e-6)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh((1, 1, 1), ("pod", "data", "model"),
                     devices=jax.devices()[:1])


def _in_mesh(mesh, fn, *args):
    f = shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                  out_specs=P(), check_vma=False)
    return np.asarray(jax.jit(f)(*args))


def _t(a):
    return torch.from_numpy(np.asarray(a))


ATTN_NAMES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def _attn_weights(cfg, rng):
    return {k: rng.normal(0, 0.3, d.shape).astype(np.float32)
            for k, d in sublayers.attn_defs(cfg).items()}


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rms_norm(eps, rng):
    x = rng.normal(0, 3, (2, 5, 64)).astype(np.float32)
    s = rng.normal(1, 0.1, (64,)).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s), eps)
    got = layers.rms_norm(_t(x), _t(s), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_norm_bf16_upcasts_like_jax(rng):
    x = rng.normal(0, 3, (3, 64)).astype(np.float32)
    s = rng.normal(1, 0.1, (64,)).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(s, jnp.bfloat16))
    got = layers.rms_norm(_t(x).bfloat16(), _t(s).bfloat16())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=8e-3,
                               atol=8e-3)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
@pytest.mark.parametrize("hd", [16, 128])
def test_apply_rope(theta, hd, rng):
    x = rng.normal(0, 1, (3, 7, 2, hd)).astype(np.float32)
    pos = rng.integers(0, 500, (3, 7)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_freqs():
    np.testing.assert_allclose(layers.rope_freqs(128, 1e6).numpy(),
                               np.asarray(jlayers.rope_freqs(128, 1e6)),
                               **TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_glu_mlp(act, mesh1, rng):
    cfg_kw = dict(CFG, act=act)
    jcfg, cfg = JModelConfig(**cfg_kw), ModelConfig(**cfg_kw)
    defs = sublayers.mlp_defs(cfg)
    p = {k: rng.normal(0, 0.2, d.shape).astype(np.float32)
         for k, d in defs.items()}
    x = rng.normal(0, 1, (2, 6, 64)).astype(np.float32)
    mi = JMeshInfo.from_mesh(mesh1)
    want = _in_mesh(mesh1, lambda p_, x_: jsl.mlp_apply(
        jcfg, JSystemConfig(), mi, p_, x_),
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = sublayers.mlp_apply(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_embed_lookup(mesh1, rng):
    table = rng.normal(0, 1, (256, 64)).astype(np.float32)
    ids = rng.integers(0, 256, (3, 9)).astype(np.int32)
    ids[0, 0], ids[1, 3] = 256, 300        # out of range -> zero rows
    mi = JMeshInfo.from_mesh(mesh1)
    want = _in_mesh(mesh1, lambda t_, i_: jlayers.embed_lookup(t_, i_, mi),
                    jnp.asarray(table), jnp.asarray(ids))
    got = layers.embed_lookup(_t(table), _t(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)
    assert not got[0, 0].any() and not got[1, 3].any()


@pytest.mark.parametrize("causal", [True, False])
def test_attention_block_without_cache(causal, mesh1, rng):
    """The cache-free branch: q_offset 0, kv read by index in the port,
    sliced and expanded in the JAX package."""
    jcfg, cfg = JModelConfig(**CFG), ModelConfig(**CFG)
    p = _attn_weights(cfg, rng)
    x = rng.normal(0, 1, (2, 12, 64)).astype(np.float32)
    S = x.shape[1]
    mi = JMeshInfo.from_mesh(mesh1)

    def jfn(x_, *w):
        y, _ = jattn.attention_block(x_, *w, jcfg, mi,
                                     jnp.arange(S)[None, :], causal=causal)
        return y
    want = _in_mesh(mesh1, jfn, jnp.asarray(x),
                    *(jnp.asarray(p[n]) for n in ATTN_NAMES))
    got, cache = attention.attention_block(
        _t(x), *(_t(p[n]) for n in ATTN_NAMES), cfg,
        torch.arange(S)[None, :], causal=causal)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# page size 4, four pages per row (16 positions): row 0 writes pages
# 1-4, row 1 pages 5-7 with its last table entry on the scratch page,
# row 2 is an inactive slot whose table points at the scratch page only
PAGE, N_PAGES = 4, 10
TABLE = np.array([[1, 2, 3, 4], [5, 6, 7, 0], [0, 0, 0, 0]], np.int32)


@pytest.mark.parametrize("S,pos0", [
    (1, [9, 3, 0]),          # decode
    (1, [15, 11, 0]),        # decode at the last slot of the table
    (4, [8, 0, 0]),          # prefill chunk
    (4, [6, 9, 0]),          # chunks that straddle a page boundary
    (8, [12, 4, 0]),         # chunk whose padding runs past the table
], ids=["decode", "decode_last_slot", "chunk", "chunk_straddle",
        "chunk_overshoot"])
def test_attention_block_paged(S, pos0, mesh1, rng):
    """The paged branch against the JAX package's on the same pools
    (stale pages hold finite random values), table and positions: the
    active rows' outputs and every non-scratch page after the write.
    The scratch page takes duplicate writes in any order and the
    inactive row reads it, so neither is compared. K/V are written in
    bf16 in both packages, and a value on the edge of a bf16 rounding
    step can round apart: pages agree within one bf16 step at their
    magnitude (1e-2 relative), outputs within 1e-3."""
    jcfg, cfg = JModelConfig(**CFG), ModelConfig(**CFG)
    p = _attn_weights(cfg, rng)
    B = TABLE.shape[0]
    x = rng.normal(0, 1, (B, S, 64)).astype(np.float32)
    positions = (np.asarray(pos0, np.int32)[:, None]
                 + np.arange(S, dtype=np.int32)[None, :])
    pool_shape = (N_PAGES, PAGE, cfg.num_kv_heads, cfg.resolved_head_dim())
    pools = [rng.normal(0, 1, pool_shape).astype(np.float32)
             for _ in range(2)]
    mi = JMeshInfo.from_mesh(mesh1)

    def jfn(x_, pos_, pk_, pv_, tab_, *w):
        return jattn.attention_block(x_, *w, jcfg, mi, pos_,
                                     paged_kv=(pk_, pv_, tab_))
    f = shard_map(jfn, mesh=mesh1, in_specs=tuple(P() for _ in range(12)),
                  out_specs=P(), check_vma=False)
    want_y, want_pools = jax.tree.map(np.asarray, jax.jit(f)(
        jnp.asarray(x), jnp.asarray(positions),
        *(jnp.asarray(a, jnp.bfloat16) for a in pools), jnp.asarray(TABLE),
        *(jnp.asarray(p[n]) for n in ATTN_NAMES)))

    pk, pv = (_t(a).bfloat16() for a in pools)
    got_y, got_pools = attention.attention_block(
        _t(x), *(_t(p[n]) for n in ATTN_NAMES), cfg, _t(positions),
        paged_kv=(pk, pv, _t(TABLE)))
    assert got_pools[0] is pk and got_pools[1] is pv     # updated in place
    active = [0, 1]
    np.testing.assert_allclose(got_y.numpy()[active], want_y[active],
                               rtol=1e-3, atol=1e-3)
    for got, want in zip(got_pools, want_pools):
        np.testing.assert_allclose(got.float().numpy()[1:],
                                   np.asarray(want, np.float32)[1:],
                                   rtol=1e-2, atol=1e-2)


# -- the train branch ----------------------------------------------------------

@pytest.mark.parametrize("shape,chunk,causal", [
    ((2, 12, 4, 16), 1024, True),      # one chunk, as the train path runs
    ((2, 20, 2, 16), 8, True),         # 3 q x 3 kv chunks, ragged edges
    ((1, 16, 2, 32), 4, False),
], ids=["one_chunk", "ragged_chunks", "full"])
def test_chunked_causal_attention_and_its_grad(shape, chunk, causal, rng):
    """``chunked_causal_attention`` against the JAX function and its
    gradient (the port differentiates it under autograd, as the JAX
    train path does)."""
    q, k, v, r = (rng.normal(0, 1, shape).astype(np.float32)
                  for _ in range(4))

    def jloss(q_, k_, v_):
        out = jattn.chunked_causal_attention(q_, k_, v_, q_chunk=chunk,
                                             kv_chunk=chunk, causal=causal)
        return (out * r).sum(), out
    (_, want), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    got = attention.chunked_causal_attention(qt, kt, vt, q_chunk=chunk,
                                             kv_chunk=chunk, causal=causal)
    (got * _t(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    for t, g in zip((qt, kt, vt), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=2e-5, atol=2e-5)


def test_attention_train_matches_jax(mesh1, rng):
    """The train sublayer's attention: GQA expanded to the q heads and
    the chunked attention, against the JAX block's jnp branch."""
    jcfg, cfg = JModelConfig(**CFG), ModelConfig(**CFG)
    p = _attn_weights(cfg, rng)
    x = rng.normal(0, 1, (2, 12, 64)).astype(np.float32)
    S = x.shape[1]
    mi = JMeshInfo.from_mesh(mesh1)

    def jfn(x_, *w):
        return jattn.attention_block(x_, *w, jcfg, mi,
                                     jnp.arange(S)[None, :])[0]
    want = _in_mesh(mesh1, jfn, jnp.asarray(x),
                    *(jnp.asarray(p[n]) for n in ATTN_NAMES))
    got = attention.attention_train(_t(x), *(_t(p[n]) for n in ATTN_NAMES),
                                    cfg, torch.arange(S)[None, :])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("chunk", [0, 4, 16], ids=["unchunked", "chunk4",
                                                   "chunk_eq_S"])
def test_softmax_xent_matches_jax(chunk, mesh1, rng):
    """Logits and cross entropy, whole or in sequence chunks (each chunk
    recomputed in the backward), against ``chunked_tp_softmax_xent`` at
    tp 1: the sum, the count, and the gradients of x and the head."""
    x = rng.normal(0, 1, (2, 16, 64)).astype(np.float32)
    head = rng.normal(0, 0.3, (64, 256)).astype(np.float32)
    labels = rng.integers(0, 256, (2, 16)).astype(np.int32)
    labels[0, 3] = 256                       # outside the vocab: masked
    mask = rng.random((2, 16)) > 0.2
    mi = JMeshInfo.from_mesh(mesh1)

    def jfn(x_, h_, l_, m_):
        s, c = jlayers.chunked_tp_softmax_xent(x_, h_, l_, mi, 256, chunk,
                                               m_)
        return jnp.stack([s, c])
    want = _in_mesh(mesh1, jfn, *map(jnp.asarray, (x, head, labels, mask)))
    jgrad = jax.grad(lambda x_, h_: _in_mesh_raw(mesh1, jfn, x_, h_, labels,
                                                  mask)[0], argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    xt, ht = _t(x).requires_grad_(True), _t(head).requires_grad_(True)
    s, c = layers.chunked_tp_softmax_xent(xt, ht, _t(labels).long(), 256,
                                          chunk, _t(mask))
    s.backward()
    np.testing.assert_allclose([s.item(), c.item()], want, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad[0]), **TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jgrad[1]), **TOL)


def _in_mesh_raw(mesh, fn, *args):
    """``_in_mesh`` without leaving JAX, so it can be differentiated."""
    f = shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                  out_specs=P(), check_vma=False)
    return f(*map(jnp.asarray, args))
