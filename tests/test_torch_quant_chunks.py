"""The int8 kernels' chunked layout against the JAX package's padding.

Quantize and dequantize take the callers' ragged chunks and dtypes
themselves (``repro_torch.kernels.quant.chunk_layout``): ``n_chunks``
chunks of ``chunk_elems`` elements, back to back, each quantized into
its own blocks with zeros past its elements; dequantize writes float32 or
bfloat16 straight into the dense values. Held here, on numpy inputs from
a seed:

  * the chunked plain quantize against the JAX package's pad-then-
    quantize (``core/grad_compress.py``'s ``_quantize`` for one chunk,
    ``int8_psum_scatter``'s per-chunk padding for n), bit for bit;
  * the chunked plain dequantize against the JAX qwZ arrival (dequantize
    to fp32, drop each rank's padding, ``astype``), bit for bit;
  * qwZ (``quantized_gather``), qgZ (``int8_psum_scatter``) and the int8
    TP all-reduce (``int8_psum``) on CPU tensors against the padded
    composition (pad, widen, quantize whole blocks; dequantize to fp32,
    slice, cast) over the same loopback wire, bit for bit and byte for
    byte, and with no ``F.pad``, no widening of a bf16 tensor and no
    slice or cast after the dequantize.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.grad_compress import _quantize as j_quantize
from repro.kernels import ops as jops
from repro_torch.core import act_compress, grad_compress
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quant import BLOCK

CHUNK_ELEMS = [1, 100, 256, 300, 2100, 4099]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _draw(rng, n, dtype):
    """n values of N(0, 2) in ``dtype``: (torch tensor, jax array) of the
    same values (bf16 rounded once, by torch; its fp32 widening is exact,
    so JAX casts back to the same bits)."""
    x = torch.from_numpy(rng.normal(0, 2, n).astype(np.float32))
    x = x.to(DTYPES[dtype][0])
    return x, jnp.asarray(x.float().numpy()).astype(DTYPES[dtype][1])


def _assert_pair_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _np32(t):
    """float32 numpy values of a torch tensor or jax array (exact for
    bf16)."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk_elems", CHUNK_ELEMS)
@pytest.mark.parametrize("n", [1, 2, 4])
def test_chunked_quantize_equals_jax_padding(n, chunk_elems, dtype):
    """The chunked quantize (the plain version, its dispatcher and
    ``grad_compress._quantize``) equals the JAX package's per-chunk
    padding and quantize of ``int8_psum_scatter`` (and, for one chunk,
    its ``_quantize``) bit for bit."""
    rng = np.random.default_rng(1000 * n + chunk_elems)
    x, xj = _draw(rng, n * chunk_elems, dtype)
    # repro/core/grad_compress.py int8_psum_scatter: widen, pad each chunk
    flat = xj.reshape(n, chunk_elems).astype(jnp.float32)
    pad = (-chunk_elems) % BLOCK
    if pad:
        flat = jnp.pad(flat, ((0, 0), (0, pad)))
    want = jops.int8_quantize_blocks(flat.reshape(-1, BLOCK), impl="jnp")
    nb = -(-chunk_elems // BLOCK)
    got = ref.int8_quantize_blocks_plain(x, n_chunks=n,
                                         chunk_elems=chunk_elems)
    assert got[0].shape == (n * nb, BLOCK) and got[1].shape == (n * nb, 1)
    _assert_pair_equal(got, want)
    _assert_pair_equal(ops.int8_quantize_blocks(
        x.reshape(n, chunk_elems), n_chunks=n), want)
    _assert_pair_equal(grad_compress._quantize(x, n), want)
    if n == 1:
        _assert_pair_equal(got, j_quantize(xj, impl="jnp"))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk_elems", CHUNK_ELEMS)
@pytest.mark.parametrize("n", [1, 2, 4])
def test_chunked_dequantize_equals_jax_arrival(n, chunk_elems, dtype):
    """The chunked dequantize with ``out_dtype`` equals the JAX qwZ
    arrival (``_quantized_gather_fwd``: dequantize to fp32, drop each
    rank's padding, ``astype``) bit for bit."""
    rng = np.random.default_rng(7000 + 1000 * n + chunk_elems)
    nb = -(-chunk_elems // BLOCK)
    q = rng.integers(-127, 128, (n * nb, BLOCK)).astype(np.int8)
    s = (np.abs(rng.normal(0, 0.05, (n * nb, 1))) + 1e-4).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    vals = jops.int8_dequantize_blocks(jnp.asarray(q), jnp.asarray(s),
                                       impl="jnp")
    want = vals.reshape(n, -1)[:, :chunk_elems].reshape(-1).astype(jdt)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    for got in (ref.int8_dequantize_blocks_plain(
                    qt, st, n_chunks=n, chunk_elems=chunk_elems,
                    out_dtype=tdt),
                ops.int8_dequantize_blocks(qt, st, n_chunks=n,
                                           chunk_elems=chunk_elems,
                                           out_dtype=tdt),
                grad_compress._dequantize(qt, st, n, chunk_elems, tdt)):
        assert got.dtype == tdt and got.shape == (n * chunk_elems,)
        np.testing.assert_array_equal(_np32(got), _np32(want))


def test_all_zero_tail_blocks():
    """Blocks past a chunk's elements quantize zeros (scale 1e-12, q 0),
    and a dequantize of them writes nothing past ``chunk_elems``."""
    x = torch.arange(1, 301, dtype=torch.float32)
    q, s = ops.int8_quantize_blocks(x, blocks_per_chunk=4)
    assert q.shape == (4, BLOCK)
    assert torch.all(q[2:] == 0) and torch.all(s[2:] == np.float32(1e-12))
    assert torch.all(q[1, 300 - BLOCK:] == 0)
    vals = ops.int8_dequantize_blocks(q, s, chunk_elems=300,
                                      out_dtype=torch.bfloat16)
    assert vals.shape == (300,)
    assert torch.equal(vals, (q.float() * s).reshape(-1)[:300].bfloat16())


def test_bf16_output_rounds_ties_to_even():
    """A product half way between two bf16 values rounds to the even one,
    as ``(q.float() * s).to(torch.bfloat16)`` does: 1 + 2^-8 lies
    between 1 and 1 + 2^-7 (bf16 keeps 7 fraction bits)."""
    q = torch.zeros(1, BLOCK, dtype=torch.int8)
    q[0, :3] = torch.tensor([1, 3, 5], dtype=torch.int8)
    s = torch.tensor([[1 + 2 ** -8]], dtype=torch.float32)
    got = ops.int8_dequantize_blocks(q, s, out_dtype=torch.bfloat16)
    want = (q.float() * s).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert got[0, 0].item() == 1.0      # the tie went down, to the even


# -- the callers, against the padded composition ------------------------------

class Loopback:
    """A collective over ``n`` ranks whose wire is made from this rank's
    payload alone (rank r's copy is this rank's rolled by r rows; an
    all-to-all reverses the rows), so one process runs a caller end to
    end. Keeps every tensor it was sent, to compare the bytes."""

    def __init__(self, n):
        self.n = n
        self.mesh = SimpleNamespace(mesh_shape=self)
        self.sent = []

    def size(self, axis):
        return self.n

    def all_gather(self, x, axis, dim):
        assert dim == 0
        self.sent.append(x.clone())
        return torch.cat([x.roll(r, 0) for r in range(self.n)])

    def all_to_all(self, x, axis):
        self.sent.append(x.clone())
        return x.flip(0)

    def all_gather_async(self, x, axis, dim):
        return SimpleNamespace(wait=lambda out=self.all_gather(x, axis, dim):
                               out)

    def all_to_all_async(self, x, axis):
        return SimpleNamespace(wait=lambda out=self.all_to_all(x, axis): out)


def _padded_quantize(flat, nb):
    """Widen to fp32, pad the flat tensor to nb whole blocks, quantize."""
    flat = flat.float()
    flat = F.pad(flat, (0, nb * BLOCK - flat.numel()))
    return ops.int8_quantize_blocks(flat.reshape(nb, BLOCK))


def _padded_gather(w, coll, dim):
    """qwZ as pad, widen, quantize whole blocks; dequantize to fp32,
    slice each rank's padding, cast."""
    n, moved = coll.n, w.movedim(dim, 0)
    elems = moved.numel()
    q, s = _padded_quantize(moved.reshape(-1), -(-elems // BLOCK))
    vals = ops.int8_dequantize_blocks(coll.all_gather(q, "pod", 0),
                                      coll.all_gather(s, "pod", 0))
    out = vals.reshape(n, -1)[:, :elems].reshape(
        (n * moved.shape[0],) + tuple(moved.shape[1:]))
    return out.movedim(0, dim).to(w.dtype)


def _padded_psum_scatter(g, coll, dim):
    """qgZ as widen, pad each chunk, quantize whole blocks."""
    n, moved = coll.n, g.movedim(dim, 0)
    shape = (moved.shape[0] // n,) + tuple(moved.shape[1:])
    elems = moved.numel() // n
    nb = -(-elems // BLOCK)
    flat = F.pad(moved.reshape(n, elems).float(), (0, nb * BLOCK - elems))
    q, s = ops.int8_quantize_blocks(flat.reshape(n * nb, BLOCK))
    summed = ops.int8_dequant_accumulate(
        coll.all_to_all(q, "pod").reshape(n, nb, BLOCK),
        coll.all_to_all(s, "pod").reshape(n, nb, 1)).reshape(-1)
    return summed[:elems].reshape(shape).movedim(0, dim).to(g.dtype)


def _padded_allreduce(x, coll):
    """The int8 TP all-reduce as widen, pad to n whole chunks, quantize;
    dequantize to fp32, slice, cast."""
    n, total = coll.n, x.numel()
    nb = -(-total // (n * BLOCK))
    q, s = _padded_quantize(x.reshape(-1), n * nb)
    own = ops.int8_dequant_accumulate(
        coll.all_to_all(q, "model").reshape(n, nb, BLOCK),
        coll.all_to_all(s, "model").reshape(n, nb, 1))
    q2, s2 = ops.int8_quantize_blocks(own)
    vals = ops.int8_dequantize_blocks(coll.all_gather(q2, "model", 0),
                                      coll.all_gather(s2, "model", 0))
    return vals.reshape(-1)[:total].reshape(x.shape).to(x.dtype)


CALLER_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _same(got, want, c_got, c_want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert len(c_got.sent) == len(c_want.sent)
    for a, b in zip(c_got.sent, c_want.sent):      # the bytes on the wire
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", CALLER_DTYPES)
@pytest.mark.parametrize("shape,dim,n", [((300, 7), 0, 2), ((31, 33), 1, 2),
                                         ((1024,), 0, 4), ((8, 5, 13), 2, 4),
                                         ((512, 2), 0, 2)])
def test_quantized_gather_equals_padded_composition(shape, dim, n, dtype):
    g = torch.Generator().manual_seed(sum(shape) + n)
    w = torch.randn(shape, generator=g).to(dtype)
    a, b = Loopback(n), Loopback(n)
    _same(grad_compress.quantized_gather(w, a, "pod", dim),
          _padded_gather(w, b, dim), a, b)


@pytest.mark.parametrize("dtype", CALLER_DTYPES)
@pytest.mark.parametrize("shape,dim,n", [((4, 300), 0, 2), ((33, 8), 1, 4),
                                         ((1024, 3), 0, 4), ((6, 2, 7), 1, 2),
                                         ((2, 1024), 0, 2)])
def test_psum_scatter_equals_padded_composition(shape, dim, n, dtype):
    g = torch.Generator().manual_seed(sum(shape) + 10 * n)
    x = torch.randn(shape, generator=g).to(dtype)
    a, b = Loopback(n), Loopback(n)
    _same(grad_compress.int8_psum_scatter(x, a, "pod", dim),
          _padded_psum_scatter(x, b, dim), a, b)


@pytest.mark.parametrize("dtype", CALLER_DTYPES)
@pytest.mark.parametrize("shape,n", [((2, 5, 64), 2), ((300,), 4),
                                     ((4, 1024), 2), ((3, 7, 11), 4),
                                     ((2, 16, 256), 2)])
def test_int8_psum_equals_padded_composition(shape, n, dtype):
    g = torch.Generator().manual_seed(sum(shape) + 100 * n)
    x = torch.randn(shape, generator=g).to(dtype)
    a, b = Loopback(n), Loopback(n)
    _same(act_compress.int8_psum(x, a, "model"), _padded_allreduce(x, b),
          a, b)


@pytest.fixture
def glue_spy(monkeypatch):
    """F.pad raises; the quantize and dequantize dispatchers record what
    they were handed and what they returned."""
    def no_pad(*a, **k):
        raise AssertionError("a caller padded")
    monkeypatch.setattr(F, "pad", no_pad)
    seen = {"quantize": [], "dequantize": []}
    quantize, dequantize = ops.int8_quantize_blocks, ops.int8_dequantize_blocks

    def spy_quantize(x, **kw):
        seen["quantize"].append((x.dtype, x.data_ptr()))
        return quantize(x, **kw)

    def spy_dequantize(q, s, **kw):
        out = dequantize(q, s, **kw)
        seen["dequantize"].append((out.dtype, out.data_ptr()))
        return out
    for spy in (spy_quantize, spy_dequantize):   # the counters they raise
        spy.calls = spy.launches = 0
    monkeypatch.setattr(ops, "int8_quantize_blocks", spy_quantize)
    monkeypatch.setattr(ops, "int8_dequantize_blocks", spy_dequantize)
    return seen


def test_callers_neither_pad_nor_widen_nor_slice_bf16(glue_spy):
    """On a ragged bf16 tensor the three callers hand the kernels the
    caller's own tensor (no pad, no fp32 copy) and return the kernel's
    output itself (no slice copy, no cast)."""
    w = torch.randn(300, 7).bfloat16()                      # 2,100 elements
    out = grad_compress.quantized_gather(w, Loopback(2), "pod", 0)
    assert glue_spy["quantize"] == [(torch.bfloat16, w.data_ptr())]
    assert glue_spy["dequantize"] == [(torch.bfloat16, out.data_ptr())]
    g = torch.randn(2, 1050).bfloat16()
    grad_compress.int8_psum_scatter(g, Loopback(2), "pod", 0)
    assert glue_spy["quantize"][1] == (torch.bfloat16, g.data_ptr())
    x = torch.randn(3, 7, 11).bfloat16()
    y = act_compress.int8_psum(x, Loopback(4), "model")
    assert glue_spy["quantize"][2] == (torch.bfloat16, x.data_ptr())
    assert glue_spy["quantize"][3][0] == torch.float32      # the requantize
    assert glue_spy["dequantize"][1] == (torch.bfloat16, y.data_ptr())
