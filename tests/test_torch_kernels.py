"""The port's attention core against the JAX package.

``repro_torch.kernels.ref.attention_plain`` (fp32, torch) is held
against the JAX package's oracle ``ref.attention_ref``, its Pallas
flash kernel in interpret mode, and ``chunked_causal_attention`` with a
per-row ``q_offset`` -- at ``atol=rtol=2e-5``, the fp32 tolerance of
``tests/test_kernels.py``. The hand-written CUDA kernel itself runs
only on the card: ``chip_smoke.py`` holds it against
``attention_plain`` there. Here the dispatch is checked: a CPU tensor
goes to the plain version and never counts a launch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import chunked_causal_attention
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention_fwd

TOL = dict(rtol=2e-5, atol=2e-5)
SWEEP = [(1, 128, 1, 64), (2, 256, 4, 64), (1, 192, 2, 128), (2, 64, 2, 32),
         (2, 200, 2, 16)]


def _qkv(rng, shape, kv_heads=None):
    B, S, H, hd = shape
    kvs = (B, S, kv_heads or H, hd)
    return (rng.normal(0, 1, shape).astype(np.float32),
            rng.normal(0, 1, kvs).astype(np.float32),
            rng.normal(0, 1, kvs).astype(np.float32))


def _plain(q, k, v, q_offset=None, causal=True):
    t = torch.from_numpy
    off = None if q_offset is None else t(np.asarray(q_offset, np.int32))
    return ref.attention_plain(t(q), t(k), t(v), off, causal).numpy()


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_attention_ref(shape, causal, rng):
    q, k, v = _qkv(rng, shape)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
    np.testing.assert_allclose(_plain(q, k, v, causal=causal),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_flash_interpret(shape, causal, rng):
    """The TPU kernel's own function (q_offset 0, kv pre-expanded), run
    as the JAX package runs it on the CPU."""
    q, k, v = _qkv(rng, shape)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                impl="pallas_interpret", block_q=64,
                                block_k=64)
    np.testing.assert_allclose(_plain(q, k, v, causal=causal),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("B,Sq,Skv,H,Hk,hd", [
    (4, 16, 128, 4, 2, 16),     # prefill chunk over a paged window
    (4, 1, 128, 4, 2, 16),      # decode
    (3, 24, 96, 8, 1, 32),      # MQA, ragged chunk
    (2, 64, 64, 2, 2, 64),
])
def test_plain_matches_chunked_causal_with_row_offsets(B, Sq, Skv, H, Hk, hd,
                                                       rng):
    """Per-row offsets as the paged serve path passes them; the port
    reads the Hk kv heads by index, the JAX function takes them
    expanded."""
    q, k, v = _qkv(rng, (B, Sq, H, hd), kv_heads=Hk)
    if Skv != Sq:
        k = rng.normal(0, 1, (B, Skv, Hk, hd)).astype(np.float32)
        v = rng.normal(0, 1, (B, Skv, Hk, hd)).astype(np.float32)
    off = rng.integers(0, Skv - Sq + 1, size=B).astype(np.int32)
    off[0] = 0
    rep = H // Hk
    want = chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=2)),
        jnp.asarray(np.repeat(v, rep, axis=2)), q_chunk=8, kv_chunk=32,
        q_offset=jnp.asarray(off))
    np.testing.assert_allclose(_plain(q, k, v, off), np.asarray(want), **TOL)


def test_dispatch_cpu_goes_to_plain_without_a_launch(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, (2, 32, 4, 16), 2))
    off = torch.tensor([0, 5], dtype=torch.int32)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, off, causal=True)
    assert ops.flash_attention.launches == before
    torch.testing.assert_close(got, ref.attention_plain(q, k, v, off, True),
                               rtol=0, atol=0)


def test_dispatch_bf16_cpu_matches_fp32_plain(rng):
    """bf16 inputs are upcast to fp32 inside, and the output rounds once
    to bf16: within the bf16 tolerance of tests/test_kernels.py."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, (2, 48, 4, 32), 1))
    got = ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    want = ref.attention_plain(q.bfloat16().float(), k.bfloat16().float(),
                               v.bfloat16().float())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    """The kernel wrapper never falls back: a tensor it cannot take
    raises before anything is built or launched."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(rng, (1, 16, 2, 16)))
    with pytest.raises(ValueError, match="must lie on"):
        flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q[..., :8].contiguous(), k[..., :8].contiguous(),
                            v[..., :8].contiguous())


def test_dispatch_rejects_other_devices():
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        ops.flash_attention(q, q, q)


def test_expand_kv_maps_q_head_to_kv_head():
    k = torch.arange(2 * 3 * 2 * 1, dtype=torch.float32).reshape(2, 3, 2, 1)
    e = ref.expand_kv(k, 3)
    assert e.shape == (2, 3, 6, 1)
    for h in range(6):
        torch.testing.assert_close(e[:, :, h], k[:, :, h // 3])


class _FakeCuda4:
    """Stands in for a contiguous CUDA tensor of the flash wrapper."""
    device = torch.device("cuda", 0)

    def __init__(self, *shape, dtype=torch.bfloat16):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


# (B, Sq, Skv, H, Hk, hd) -> the variant the wrapper launches
FLASH_VARIANTS = [
    ((8, 128, 512, 16, 2, 128), "tma"),     # qwen2.5-3b paged prefill chunk
    ((8, 512, 544, 32, 8, 128), "tma"),     # jamba's prompt
    ((2, 200, 200, 16, 16, 128), "tma"),    # the TPU kernel's own function
    ((8, 64, 64, 4, 1, 128), "tma"),        # GQA 4, Sq at the threshold
    ((8, 1, 512, 16, 2, 128), "split"),     # decode
    ((8, 1, 544, 32, 8, 128), "split"),     # jamba decode
    ((8, 63, 512, 16, 2, 128), "mma"),      # a short query
    ((8, 128, 512, 16, 2, 64), "mma"),      # hd 64
    ((8, 32, 128, 4, 2, 16), "mma"),        # hd 16
    ((2, 128, 128, 12, 4, 128), "mma"),     # a GQA group of 3 (not of 64)
    ((8, 1, 512, 16, 2, 64), "split"),      # decode at hd 64
    ((1, 1, 37, 8, 1, 128), "split"),       # ragged Skv, one split, GQA 8
    ((2, 1, 545, 4, 4, 128), "split"),      # GQA 1
    ((4, 1, 300, 16, 1, 128), "split"),     # the largest group, 16
    ((4, 1, 300, 32, 1, 128), "mma"),       # a group of 32 (> 16 rows)
    ((8, 1, 128, 4, 2, 32), "mma"),         # decode at hd 32
    ((8, 2, 512, 16, 2, 128), "mma"),       # Sq 2
]


@pytest.mark.parametrize("shape,want", FLASH_VARIANTS)
def test_flash_wrapper_sends_prefill_to_the_wgmma_variant(shape, want,
                                                          monkeypatch):
    """hd 128 with Sq >= 64 (and a GQA group dividing 64) launches the
    wgmma + TMA prefill kernel, decode (Sq 1, hd 64/128, a group of at
    most 16) the split-KV kernel, everything else the mma.sync kernel,
    with the arguments each takes: the split-KV kernel its workspace and
    counters (none when one split covers the keys) and its keys per
    split."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, Hk, hd = shape
    calls, spaces, counters = [], [], []
    monkeypatch.setattr(fa, "_kernels", lambda: {
        kind: (lambda *a, kind=kind: calls.append((kind, a)) or 0)
        for kind in ("tma", "mma", "split")})
    monkeypatch.setattr(fa, "_new_output", lambda q: torch.empty(0))
    monkeypatch.setattr(fa, "_new_workspace", lambda q, n: spaces.append(n)
                        or _FakeCuda4(n, dtype=torch.float32))
    monkeypatch.setattr(fa, "_counters", lambda dev, n: counters.append(n)
                        or _FakeCuda4(n, dtype=torch.int32))
    monkeypatch.setattr(_build, "launch", lambda device, fn, *a: fn(*a, 0))
    q = _FakeCuda4(B, Sq, H, hd)
    kv = _FakeCuda4(B, Skv, Hk, hd)
    off = _FakeCuda4(B, dtype=torch.int32)
    flash_attention_fwd(q, kv, kv, off, True)
    (kind, args), = calls
    assert kind == want == fa.variant(Sq, H, Hk, hd)
    tail = (1, pytest.approx(hd ** -0.5), 0)
    if kind == "split":
        keys, splits, floats = fa.split_plan(B, H, Hk, Skv, hd)
        assert args[7:] == (B, Skv, H, Hk, hd, keys) + tail
        if splits == 1:
            assert args[5:7] == (None, None) and not spaces and not counters
        else:
            assert args[5:7] == (0, 0)
            assert spaces == [floats] == [splits * B * H * (hd + 2)]
            assert counters == [B * Hk]
        return
    assert not spaces and not counters
    assert args[5:10] == (B, Sq, Skv, H, Hk)
    assert args[10:] == ((hd,) if kind == "mma" else ()) + tail


@pytest.mark.parametrize("shape", [(8, 512, 16, 2), (8, 544, 32, 8)])
def test_split_wrapper_holds_its_workspace_through_the_launch(shape,
                                                              monkeypatch):
    """The decode variant's workspace is still referenced when the kernel
    is launched (a buffer freed before could be handed to another
    allocation the kernel then overwrites), and the counters are
    allocated before it."""
    import weakref
    from repro_torch.kernels import flash_attention as fa
    B, Skv, H, Hk = shape
    made, alive = [], []

    def workspace(q, n):
        ws = _FakeCuda4(n, dtype=torch.float32)
        made.append(("workspace", weakref.ref(ws)))
        return ws

    def launch(device, fn, *args):
        alive.extend(ref() is not None for kind, ref in made
                     if kind == "workspace")
        return 0

    monkeypatch.setattr(fa, "_kernels", lambda: {"split": None})
    monkeypatch.setattr(fa, "_new_output", lambda q: torch.empty(0))
    monkeypatch.setattr(fa, "_new_workspace", workspace)
    monkeypatch.setattr(fa, "_counters", lambda dev, n: made.append(
        ("counters", None)) or _FakeCuda4(n, dtype=torch.int32))
    monkeypatch.setattr(_build, "launch", launch)
    kv = _FakeCuda4(B, Skv, Hk, 128)
    flash_attention_fwd(_FakeCuda4(B, 1, H, 128), kv, kv,
                        _FakeCuda4(B, dtype=torch.int32), True)
    assert [kind for kind, _ in made] == ["counters", "workspace"]
    assert alive == [True]


# (B, H, Hk, Skv, hd) -> (keys per split, splits)
SPLIT_PLANS = [
    ((8, 16, 2, 512, 128), (64, 8)),      # qwen2.5-3b paged decode
    ((8, 32, 8, 544, 128), (64, 9)),      # jamba decode
    ((1, 8, 1, 37, 128), (64, 1)),        # ragged, one split
    ((1, 8, 1, 64, 128), (64, 1)),        # one split exactly, no workspace
    ((2, 16, 1, 1000, 128), (64, 16)),
    ((64, 32, 8, 4096, 128), (64, 64)),
    ((8, 16, 4, 1024, 64), (64, 16)),
]


@pytest.mark.parametrize("dims,want", SPLIT_PLANS)
def test_split_plan_splits_the_keys_by_64(dims, want):
    """64 keys a split at every shape; the workspace holds (acc [G, hd],
    m, l) per query head and split, and is not needed for one split."""
    from repro_torch.kernels import flash_attention as fa
    B, H, Hk, Skv, hd = dims
    keys, splits, floats = fa.split_plan(B, H, Hk, Skv, hd)
    assert (keys, splits) == want
    assert keys == fa.KEYS_PER_SPLIT and splits == -(-Skv // keys)
    assert floats == (0 if splits == 1 else splits * B * H * (hd + 2))


def _split_decode(q, k, v, off, causal):
    """The decode variant's algebra in fp32: the keys split as
    ``split_plan`` splits them, each split's partial (m, l, acc) -- an
    empty split (every key masked) gives (-1e30, 0, 0) -- and the merge
    out = sum e^(m_s - m*) acc_s / max(sum e^(m_s - m*) l_s, 1e-20)."""
    from repro_torch.kernels import flash_attention as fa
    B, _, H, hd = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    keys, splits, _ = fa.split_plan(B, H, Hk, Skv, hd)
    kf, vf = ref.expand_kv(k, H // Hk), ref.expand_kv(v, H // Hk)
    s_all = torch.einsum("bhd,bkhd->bhk", q[:, 0], kf) / hd ** 0.5
    parts = []
    for sp in range(splits):
        k0, k1 = sp * keys, min(sp * keys + keys, Skv)
        pos = torch.arange(k0, k1)
        vis = (pos[None, :] <= off[:, None] if causal
               else torch.ones(B, k1 - k0, dtype=torch.bool))[:, None]
        s = torch.where(vis, s_all[..., k0:k1], torch.tensor(-1e30))
        m = s.amax(-1)
        p = torch.where(vis, torch.exp(s - m[..., None]), torch.tensor(0.))
        m = torch.where(vis.any(-1), m, torch.tensor(-1e30))
        parts.append((m, p.sum(-1),
                      torch.einsum("bhk,bkhd->bhd", p, vf[:, k0:k1])))
    m_star = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.where(l > 0, torch.exp(m - m_star), torch.tensor(0.))
         for m, l, _ in parts]
    den = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    acc = sum(wi[..., None] * a for wi, (_, _, a) in zip(w, parts))
    return (acc / torch.clamp(den, min=1e-20)[..., None])[:, None], splits


# (B, Skv, H, Hk, hd, offsets, causal): both serve shapes, offset 0 (only
# key 0 visible), offsets whose last visible key ends a split, ragged Skv,
# GQA groups of 1, 2, 4 and 8, and a non-causal decode
SPLIT_CASES = [
    (8, 512, 16, 2, 128, [37, 511, 200, 16, 300, 128, 64, 400], True),
    (8, 544, 32, 8, 128, [512, 520, 530, 543, 515, 525, 535, 540], True),
    (2, 512, 16, 2, 128, [0, 0], True),
    (4, 512, 16, 2, 128, [63, 127, 191, 511], True),
    (2, 544, 32, 8, 128, [127, 383], True),
    (1, 37, 8, 1, 64, [36], True),
    (2, 545, 4, 4, 64, [544, 100], True),
    (2, 300, 4, 2, 64, [150, 299], True),
    (2, 300, 4, 1, 64, [0, 17], True),
    (2, 200, 16, 2, 64, [0, 0], False),
]


@pytest.mark.parametrize("B,Skv,H,Hk,hd,offsets,causal", SPLIT_CASES)
def test_split_decode_merge_equals_plain_and_jax(B, Skv, H, Hk, hd, offsets,
                                                 causal, rng):
    """Splitting the keys as the decode variant does and merging the
    fp32 partials gives ``attention_plain`` and the JAX package's
    ``chunked_causal_attention(..., q_offset=)`` (kv pre-expanded) within
    tests/test_kernels.py's fp32 tolerance, with splits wholly masked
    among them."""
    q, k, v = _qkv(rng, (B, 1, H, hd), kv_heads=Hk)
    k = rng.normal(0, 1, (B, Skv, Hk, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, Skv, Hk, hd)).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    got, splits = _split_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(off), causal)
    np.testing.assert_allclose(got.numpy(), _plain(q, k, v, off, causal),
                               **TOL)
    rep = H // Hk
    want = chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=2)),
        jnp.asarray(np.repeat(v, rep, axis=2)), q_chunk=1,
        kv_chunk=32 if causal else Skv, causal=causal,
        q_offset=jnp.asarray(off))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if causal and min(offsets) < Skv - 128:
        assert splits > 1      # some split lies wholly past an offset
