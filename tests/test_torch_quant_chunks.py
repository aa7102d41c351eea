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
  * the chunked plain dequant-accumulate (fp32 or bf16 written by the
    kernel, fp16 cast by qgZ's ``_accumulate``) against the JAX qgZ
    arrival (``int8_psum_scatter``: fold to fp32, slice the chunk,
    ``astype``), and qgZ itself on a loopback wire against the JAX
    arrival of the same wire bytes, bit for bit at power-of-two scales
    (XLA may contract the fold's multiply and add on the CPU);
  * qwZ (``quantized_gather``), qgZ (``int8_psum_scatter``) and the int8
    TP all-reduce (``int8_psum``) on CPU tensors against the padded
    composition (pad, widen, quantize whole blocks; dequantize or fold
    to fp32, slice, cast; requantize the fold in a second pass) over the
    same loopback wire, bit for bit and byte for byte, and with no
    ``F.pad``, no widening of a bf16 tensor, no slice or cast after the
    dequantize or the fold, and no second quantize for the requantize.
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
ARRIVAL_DTYPES = {**DTYPES, "float16": (torch.float16, jnp.float16)}


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


def _jax_folds(q, s):
    """The JAX fold of n sources (q [n, nb, BLOCK], s [n, nb, 1]) as the
    oracle and as the interpret-mode Pallas kernel, flat."""
    qj, sj = jnp.asarray(q), jnp.asarray(s)
    return [jops.int8_dequant_accumulate(qj, sj, impl="jnp").reshape(-1),
            jops.int8_dequant_accumulate(qj, sj, impl="pallas",
                                         interpret=True).reshape(-1)]


@pytest.mark.parametrize("dtype", list(ARRIVAL_DTYPES))
@pytest.mark.parametrize("chunk_elems", [1, 300, 1050, 2100, 2048, 4096])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_chunked_dequant_accumulate_equals_jax_arrival(n, chunk_elems, dtype):
    """The fold written as its first ``chunk_elems`` elements in the
    caller's dtype (the plain version, its dispatcher and qgZ's
    ``_accumulate``; fp16 only through ``_accumulate``, which casts the
    fp32 fold) equals the JAX qgZ arrival (fold, ``[:chunk_elems]``,
    ``astype``) bit for bit, ragged and whole-block chunks alike."""
    rng = np.random.default_rng(3000 + 100 * n + chunk_elems)
    nb = -(-chunk_elems // BLOCK)
    q = rng.integers(-127, 128, (n, nb, BLOCK)).astype(np.int8)
    s = (2.0 ** rng.integers(-8, 2, (n, nb, 1))).astype(np.float32)
    tdt, jdt = ARRIVAL_DTYPES[dtype]
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    got = [grad_compress._accumulate(qt, st, chunk_elems, tdt)]
    if tdt != torch.float16:
        kw = dict(chunk_elems=chunk_elems, out_dtype=tdt)
        got += [ref.int8_dequant_acc_plain(qt, st, **kw),
                ops.int8_dequant_accumulate(qt, st, **kw)]
    for fold in _jax_folds(q, s):
        want = fold[:chunk_elems].astype(jdt)
        for g in got:
            assert g.dtype == tdt and g.shape == (chunk_elems,)
            np.testing.assert_array_equal(_np32(g), _np32(want))


def _exact_chunks(rng, n, chunk_elems):
    """[n, chunk_elems] float32 values that quantize exactly: each block
    of each chunk holds integers of [-127, 127] times a power of two
    2^k, its first one +-127 * 2^k, so its scale is 2^k (fl(127 *
    INV_QMAX) is 1) and its codes are the integers. Exact in bf16 and
    fp16 too."""
    nb = -(-chunk_elems // BLOCK)
    ints = rng.integers(-127, 128, (n, nb, BLOCK)).astype(np.float32)
    ints[:, :, 0] = 127 * rng.choice([-1.0, 1.0], (n, nb))
    scale = 2.0 ** rng.integers(-6, 3, (n, nb, 1))
    return (ints * scale).reshape(n, -1)[:, :chunk_elems].astype(np.float32)


@pytest.mark.parametrize("dtype", list(ARRIVAL_DTYPES))
@pytest.mark.parametrize("shape,dim,n", [((2, 1050), 0, 2), ((4, 1050), 0, 2),
                                         ((3, 2100), 0, 3), ((8, 512), 0, 4),
                                         ((7, 6, 50), 1, 3), ((4, 256), 0, 4)])
def test_psum_scatter_equals_jax_arrival(shape, dim, n, dtype):
    """qgZ (``int8_psum_scatter``) over a loopback wire equals the JAX
    package's arrival (``int8_psum_scatter``'s fold, slice, reshape,
    ``moveaxis`` and ``astype``) of the same wire bytes bit for bit, in
    fp32, bf16 and fp16, ragged chunks (1,050, 2,100, 700 elements) and
    whole-block ones."""
    tdt, jdt = ARRIVAL_DTYPES[dtype]
    moved = list(shape)
    moved.insert(0, moved.pop(dim))
    chunk_shape = (moved[0] // n,) + tuple(moved[1:])
    elems = int(np.prod(chunk_shape))
    rng = np.random.default_rng(sum(shape) + n)
    vals = _exact_chunks(rng, n, elems).reshape(moved)
    g = torch.from_numpy(np.moveaxis(vals, 0, dim).copy()).to(tdt)
    coll = Loopback(n)
    got = grad_compress.int8_psum_scatter(g, coll, "pod", dim)
    q, s = (x.flip(0).numpy() for x in coll.sent)     # what arrived
    nb = -(-elems // BLOCK)
    q, s = q.reshape(n, nb, BLOCK), s.reshape(n, nb, 1)
    assert set(np.unique(s)) <= {2.0 ** k for k in range(-6, 3)}
    for fold in _jax_folds(q, s):
        want = jnp.moveaxis(fold[:elems].reshape(chunk_shape), 0,
                            dim).astype(jdt)
        assert got.dtype == tdt and tuple(got.shape) == want.shape
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
    """F.pad raises; the quantize, dequantize, dequant-accumulate and
    dequant-requantize dispatchers record what they were handed and what
    they returned (the accumulate also its keyword arguments)."""
    def no_pad(*a, **k):
        raise AssertionError("a caller padded")
    monkeypatch.setattr(F, "pad", no_pad)
    seen = {"quantize": [], "dequantize": [], "dequant_accumulate": [],
            "dequant_requantize": []}
    quantize, dequantize = ops.int8_quantize_blocks, ops.int8_dequantize_blocks
    accumulate, requantize = (ops.int8_dequant_accumulate,
                              ops.int8_dequant_requantize)

    def spy_quantize(x, **kw):
        seen["quantize"].append((x.dtype, x.data_ptr()))
        return quantize(x, **kw)

    def spy_dequantize(q, s, **kw):
        out = dequantize(q, s, **kw)
        seen["dequantize"].append((out.dtype, out.data_ptr()))
        return out

    def spy_accumulate(q, s, **kw):
        out = accumulate(q, s, **kw)
        seen["dequant_accumulate"].append((out.dtype, out.data_ptr(), kw))
        return out

    def spy_requantize(q, s):
        out = requantize(q, s)
        seen["dequant_requantize"].append((q.dtype, out[0].dtype))
        return out
    for spy in (spy_quantize, spy_dequantize, spy_accumulate):
        spy.calls = spy.launches = 0             # the counters they raise
    monkeypatch.setattr(ops, "int8_quantize_blocks", spy_quantize)
    monkeypatch.setattr(ops, "int8_dequantize_blocks", spy_dequantize)
    monkeypatch.setattr(ops, "int8_dequant_accumulate", spy_accumulate)
    monkeypatch.setattr(ops, "int8_dequant_requantize", spy_requantize)
    return seen


def test_callers_neither_pad_nor_widen_nor_slice_bf16(glue_spy):
    """On a ragged bf16 tensor the three callers hand the kernels the
    caller's own tensor (no pad, no fp32 copy) and return the kernel's
    output itself (no slice copy, no cast); the TP all-reduce's fold is
    requantized in its own kernel (no accumulate, no second quantize)."""
    w = torch.randn(300, 7).bfloat16()                      # 2,100 elements
    out = grad_compress.quantized_gather(w, Loopback(2), "pod", 0)
    assert glue_spy["quantize"] == [(torch.bfloat16, w.data_ptr())]
    assert glue_spy["dequantize"] == [(torch.bfloat16, out.data_ptr())]
    g = torch.randn(2, 1050).bfloat16()
    r = grad_compress.int8_psum_scatter(g, Loopback(2), "pod", 0)
    assert glue_spy["quantize"][1] == (torch.bfloat16, g.data_ptr())
    assert glue_spy["dequant_accumulate"][0][:2] == (torch.bfloat16,
                                                     r.data_ptr())
    x = torch.randn(3, 7, 11).bfloat16()
    y = act_compress.int8_psum(x, Loopback(4), "model")
    assert glue_spy["quantize"][2:] == [(torch.bfloat16, x.data_ptr())]
    assert len(glue_spy["dequant_accumulate"]) == 1
    assert glue_spy["dequant_requantize"] == [(torch.int8, torch.int8)]
    assert glue_spy["dequantize"][1] == (torch.bfloat16, y.data_ptr())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,dim,n", [((2, 1050), 0, 2),
                                         ((7, 6, 50), 1, 3),
                                         ((8, 512), 0, 4)])
def test_qgz_wait_returns_the_fold_itself(glue_spy, shape, dim, n, dtype):
    """qgZ's wait hands the accumulate the chunk's elements and the
    gradient's dtype and returns the dispatcher's own output (the same
    storage, a view moved back to ``dim``): no fp32 copy, no slice copy,
    no cast; nothing else is quantized or dequantized."""
    g = torch.randn(shape).to(dtype)
    got = grad_compress.int8_psum_scatter(g, Loopback(n), "pod", dim)
    elems = g.numel() // n
    (out_dtype, ptr, kw), = glue_spy["dequant_accumulate"]
    assert kw == {"chunk_elems": elems, "out_dtype": dtype}
    assert got.dtype == out_dtype == dtype and got.data_ptr() == ptr
    # the issue reads g in place where its dim needs no move
    (q_dtype, q_ptr), = glue_spy["quantize"]
    assert q_dtype == dtype and (dim != 0 or q_ptr == g.data_ptr())
    assert glue_spy["dequantize"] == glue_spy["dequant_requantize"] == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n", [((3, 7, 11), 4), ((2, 16, 256), 2)])
def test_int8_allreduce_requantizes_in_the_accumulate(glue_spy, shape, n,
                                                      dtype):
    """The int8 TP all-reduce makes one quantize call (the tensor
    itself), one requantizing fold (``int8_dequant_requantize``, no
    separate accumulate) and one dequantize into the tensor's dtype,
    which it returns."""
    x = torch.randn(shape).to(dtype)
    y = act_compress.int8_psum(x, Loopback(n), "model")
    assert glue_spy["quantize"] == [(dtype, x.data_ptr())]
    assert glue_spy["dequant_accumulate"] == []
    assert glue_spy["dequant_requantize"] == [(torch.int8, torch.int8)]
    assert glue_spy["dequantize"] == [(dtype, y.data_ptr())]
