"""The port's int8 block quantization against the JAX package's.

The plain versions (``repro_torch.kernels.ref``, what the dispatchers
run on CPU tensors and what ``chip_smoke.py`` holds the CUDA kernels to
on the card) are held against the JAX package's oracles
(``repro.kernels.ref.int8_*_ref``) and its Pallas kernels in interpret
mode, on the same numpy inputs:

  * quantize and dequantize bit-exact: the same operations, each
    rounded once (max, the shared INV_QMAX multiply, a true division,
    round half to even, clip);
  * dequant-accumulate bit-exact at power-of-two scales (every product
    and sum exact), and within ``tests/test_quant.py``'s rtol/atol 1e-5
    at random scales: the accumulation order is the same, but XLA may
    contract the multiply and add on the CPU, where PyTorch rounds each;
  * its requantizing output (the int8 TP all-reduce's fold, quantized
    in the same kernel) bit-exact against the JAX package's
    dequant-accumulate followed by its quantize, all-zero blocks and
    exact half-ties included.

The CUDA kernels themselves run only on the card; here the dispatch is
checked: a CPU tensor takes the plain version and counts no launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.grad_compress import _quantize as j_quantize
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quant import BLOCK as J_BLOCK
from repro.kernels.quant import INV_QMAX as J_INV_QMAX
from repro.kernels.quant import SCALE_EPS as J_SCALE_EPS
from repro_torch.core.grad_compress import _quantize
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quant import BLOCK, INV_QMAX, SCALE_EPS


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_pair(x):
    """(oracle, interpret-mode Pallas) quantization of x (f32 numpy)."""
    xj = jnp.asarray(x)
    return (jref.int8_quantize_blocks_ref(xj),
            jops.int8_quantize_blocks(xj, impl="pallas", interpret=True))


def _assert_quant_equal(got, want):
    q, s = got
    np.testing.assert_array_equal(q.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want[1]))


def test_constants_are_shared():
    assert (BLOCK, SCALE_EPS, INV_QMAX) == (J_BLOCK, J_SCALE_EPS, J_INV_QMAX)
    assert np.float32(INV_QMAX).view(np.uint32) == 0x3C010204


@pytest.mark.parametrize("nb", [1, 3, 8, 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_exact(nb, dtype, rng):
    x = jnp.asarray(rng.normal(0, 3, (nb, BLOCK)), dtype).astype(jnp.float32)
    x = np.asarray(x)
    oracle, pallas = _jax_pair(x)
    got = ops.int8_quantize_blocks(_t(x))
    assert got[0].dtype == torch.int8 and got[1].shape == (nb, 1)
    _assert_quant_equal(got, oracle)
    _assert_quant_equal(got, pallas)


def test_quantize_bf16_input_is_its_f32_widening(rng):
    """A bf16 tensor quantizes exactly as its (exact) f32 widening, the
    cast the JAX wrapper makes first."""
    x = torch.from_numpy(rng.normal(0, 2, (5, BLOCK)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    a, b = ops.int8_quantize_blocks(xb), ops.int8_quantize_blocks(xb.float())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_quantize_zero_const_and_ramp_blocks():
    """All-zero blocks hit the scale floor (q = 0); constant blocks hit
    +-127; a ramp spreads over the whole int8 range."""
    ramp = (np.arange(BLOCK, dtype=np.float32) - 127.5)    # max |x| 127.5
    x = np.stack([np.zeros(BLOCK, np.float32),
                  np.full(BLOCK, 7.5, np.float32),
                  np.full(BLOCK, -0.25, np.float32), ramp])
    oracle, pallas = _jax_pair(x)
    q, s = ops.int8_quantize_blocks(_t(x))
    _assert_quant_equal((q, s), oracle)
    _assert_quant_equal((q, s), pallas)
    assert torch.all(q[0] == 0) and s[0, 0] == np.float32(SCALE_EPS)
    assert torch.all(q[1:3].abs() == 127)
    assert q[3].min() == -127 and q[3].max() == 127


def test_quantize_exact_half_ties():
    """max |x| = 127 gives the scale fl(127 * INV_QMAX) = 1.0 exactly, so
    x = k + 0.5 divides to exact ties: they round half to even, as
    jnp.round does (roundf would send 0.5 to 1, 2.5 to 3)."""
    assert np.float32(127.0) * np.float32(INV_QMAX) == np.float32(1.0)
    vals = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0],
                    np.float32)
    x = np.zeros((1, BLOCK), np.float32)
    x[0, :vals.size] = vals
    x[0, -1] = np.float32(127.0)                  # pins max |x| = 127
    q, sc = ops.int8_quantize_blocks(_t(x))
    oracle, pallas = _jax_pair(x)
    _assert_quant_equal((q, sc), oracle)
    _assert_quant_equal((q, sc), pallas)
    assert sc[0, 0] == 1.0
    assert q[0, :vals.size].tolist() == [0, 2, 2, 0, -2, -2, 126, 127]


@pytest.mark.parametrize("nb", [1, 5, 16])
def test_dequantize_bit_exact(nb, rng):
    q = rng.integers(-127, 128, (nb, BLOCK)).astype(np.int8)
    s = (2.0 ** rng.integers(-8, 3, (nb, 1))).astype(np.float32)
    s[0, 0] = np.float32(0.0371)                  # one arbitrary scale
    got = ops.int8_dequantize_blocks(_t(q), _t(s)).numpy()
    qj, sj = jnp.asarray(q), jnp.asarray(s)
    np.testing.assert_array_equal(
        got, np.asarray(jref.int8_dequantize_blocks_ref(qj, sj)))
    np.testing.assert_array_equal(
        got, np.asarray(jops.int8_dequantize_blocks(qj, sj, impl="pallas",
                                                    interpret=True)))


@pytest.mark.parametrize("n,nb", [(2, 5), (4, 8), (3, 1), (8, 17)])
def test_dequant_accumulate_bit_exact_pow2(n, nb, rng):
    q = rng.integers(-127, 128, (n, nb, BLOCK)).astype(np.int8)
    s = (2.0 ** rng.integers(-8, 2, (n, nb, 1))).astype(np.float32)
    got = ops.int8_dequant_accumulate(_t(q), _t(s)).numpy()
    qj, sj = jnp.asarray(q), jnp.asarray(s)
    np.testing.assert_array_equal(
        got, np.asarray(jref.int8_dequant_acc_ref(qj, sj)))
    np.testing.assert_array_equal(
        got, np.asarray(jops.int8_dequant_accumulate(qj, sj, impl="pallas",
                                                     interpret=True)))


def test_dequant_accumulate_random_scales_close(rng):
    q = rng.integers(-127, 128, (4, 8, BLOCK)).astype(np.int8)
    s = (np.abs(rng.normal(0, 0.05, (4, 8, 1))) + 1e-4).astype(np.float32)
    got = ops.int8_dequant_accumulate(_t(q), _t(s)).numpy()
    want = np.asarray(jref.int8_dequant_acc_ref(jnp.asarray(q),
                                                jnp.asarray(s)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the port's own order: each product and each sum rounded once
    acc = np.zeros((8, BLOCK), np.float32)
    for i in range(4):
        acc = (acc + (q[i].astype(np.float32) * s[i])).astype(np.float32)
    np.testing.assert_array_equal(got, acc)


def _jax_requantized(q, s):
    """The JAX int8 TP all-reduce's fold then requantize
    (``act_compress._int8_allreduce``), as the oracles and as the
    interpret-mode Pallas kernels."""
    qj, sj = jnp.asarray(q), jnp.asarray(s)
    return [jops.int8_quantize_blocks(
                jops.int8_dequant_accumulate(qj, sj, impl="jnp"),
                impl="jnp"),
            jops.int8_quantize_blocks(
                jops.int8_dequant_accumulate(qj, sj, impl="pallas",
                                             interpret=True),
                impl="pallas", interpret=True)]


@pytest.mark.parametrize("n,nb", [(2, 5), (3, 1), (4, 8), (2, 17)])
def test_dequant_accumulate_requantize_equals_jax(n, nb, rng):
    """The requantizing output equals the JAX fold followed by its
    quantize bit for bit at power-of-two scales (the fold exact), and
    the port's own plain composition at random ones."""
    q = rng.integers(-127, 128, (n, nb, BLOCK)).astype(np.int8)
    s = (2.0 ** rng.integers(-8, 2, (n, nb, 1))).astype(np.float32)
    got = ops.int8_dequant_requantize(_t(q), _t(s))
    assert got[0].shape == (nb, BLOCK) and got[1].shape == (nb, 1)
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    for want in _jax_requantized(q, s):
        _assert_quant_equal(got, want)
    s = (np.abs(rng.normal(0, 0.05, (n, nb, 1))) + 1e-4).astype(np.float32)
    got = ref.int8_dequant_requant_plain(_t(q), _t(s))
    want = ref.int8_quantize_blocks_plain(
        ref.int8_dequant_acc_plain(_t(q), _t(s)))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_dequant_accumulate_requantize_zero_blocks_and_ties():
    """A block whose sources are all zero requantizes to q 0, s 1e-12;
    a fold of max |x| 127 has scale 1.0, and its k + 0.5 values (1 at
    scale 0.5 added to integers) round half to even."""
    q = np.zeros((2, 3, BLOCK), np.int8)
    s = np.ones((2, 3, 1), np.float32)
    q[0, 1, :7] = [0, 1, 2, -1, -2, 126, 127]
    q[1, 1, :7] = [1, 1, 1, -1, -1, 1, 0]
    s[1, 1] = 0.5                      # fold 0.5 1.5 2.5 -1.5 -2.5 126.5 127
    q[:, 2] = 5
    got = ops.int8_dequant_requantize(_t(q), _t(s))
    for want in _jax_requantized(q, s):
        _assert_quant_equal(got, want)
    assert torch.all(got[0][0] == 0) and got[1][0, 0] == np.float32(SCALE_EPS)
    assert got[1][1, 0] == 1.0
    assert got[0][1, :7].tolist() == [0, 2, 2, -2, -2, 126, 127]
    assert torch.all(got[0][2] == 127)


@pytest.mark.parametrize("shape", [(100,), (256,), (300, 7), (31, 33)])
def test_quantize_pad_path_matches_jax(shape, rng):
    """Tensors that are not a whole number of blocks take the pad path
    of ``grad_compress._quantize`` in both packages."""
    g = rng.normal(0, 1, shape).astype(np.float32)
    qj, sj = j_quantize(jnp.asarray(g), impl="jnp")
    q, s = _quantize(_t(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    deq = ref.int8_dequantize_blocks_plain(q, s).reshape(-1).numpy()
    lsb = s.numpy()[:, 0].repeat(BLOCK)[: g.size]
    assert np.all(np.abs(deq[: g.size] - g.reshape(-1)) <= 0.5 * lsb)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing(rng):
    x = _t(rng.normal(0, 1, (2, BLOCK)).astype(np.float32))
    before = {k: (f.launches, f.calls) for k, f in ops.INT8_KERNELS.items()}
    q, s = ops.int8_quantize_blocks(x)
    ops.int8_dequantize_blocks(q, s)
    ops.int8_dequant_accumulate(q[None], s[None])
    for k, f in ops.INT8_KERNELS.items():
        assert f.launches == before[k][0]
        assert f.calls == before[k][1] + 1


@pytest.mark.parametrize("fn,args", [
    ("quantize_blocks", lambda: (torch.zeros(2, BLOCK),)),
    ("dequantize_blocks", lambda: (torch.zeros(2, BLOCK, dtype=torch.int8),
                                   torch.ones(2, 1))),
    ("dequant_accumulate", lambda: (torch.zeros(2, 2, BLOCK,
                                                dtype=torch.int8),
                                    torch.ones(2, 2, 1))),
    ("quantize_blocks", lambda: (torch.zeros(2, 2100).bfloat16(),
                                 {"n_chunks": 2, "chunk_elems": 2100})),
    ("quantize_blocks", lambda: (torch.zeros(300),
                                 {"blocks_per_chunk": 4})),
    ("dequantize_blocks", lambda: (torch.zeros(18, BLOCK, dtype=torch.int8),
                                   torch.ones(18, 1),
                                   {"n_chunks": 2, "chunk_elems": 2100,
                                    "out_dtype": torch.bfloat16})),
    ("dequant_accumulate", lambda: (torch.zeros(2, 5, BLOCK,
                                                dtype=torch.int8),
                                    torch.ones(2, 5, 1),
                                    {"chunk_elems": 1050,
                                     "out_dtype": torch.bfloat16})),
    ("dequant_requantize", lambda: (torch.zeros(2, 5, BLOCK,
                                                dtype=torch.int8),
                                    torch.ones(2, 5, 1))),
])
def test_kernel_wrappers_refuse_cpu_tensors(fn, args):
    """The CUDA wrappers never run a plain version: a CPU tensor
    raises before anything is built or launched, with the chunked
    layout's arguments too."""
    from repro_torch.kernels import quant
    a = args()
    kw = a[-1] if isinstance(a[-1], dict) else {}
    with pytest.raises(ValueError, match="CUDA"):
        getattr(quant, fn)(*a[:len(a) - bool(kw)], **kw)


@pytest.mark.parametrize("fn,args,match", [
    ("quantize", lambda: (torch.zeros(300), {"n_chunks": 7}), "n_chunks"),
    ("quantize", lambda: (torch.zeros(300), {"n_chunks": 2,
                                             "chunk_elems": 100}),
     "chunk_elems"),
    ("quantize", lambda: (torch.zeros(600), {"chunk_elems": 600,
                                             "blocks_per_chunk": 2}),
     "blocks_per_chunk"),
    ("dequantize", lambda: (torch.zeros(2, BLOCK, dtype=torch.int8),
                            torch.ones(2, 1), {"out_dtype": torch.float16}),
     "out_dtype"),
    ("dequantize", lambda: (torch.zeros(3, BLOCK, dtype=torch.int8),
                            torch.ones(3, 1), {"n_chunks": 2}), "n_chunks"),
    ("dequantize", lambda: (torch.zeros(2, BLOCK, dtype=torch.int8),
                            torch.ones(2, 1), {"n_chunks": 2,
                                               "chunk_elems": 257}),
     "chunk_elems"),
])
def test_wrappers_and_plain_versions_refuse_bad_layouts(fn, args, match):
    """A layout or output dtype the kernels do not take raises in the
    CUDA wrapper (before the device check) and in the plain version: the
    card and the CPU accept the same arguments."""
    from repro_torch.kernels import quant
    *tensors, kw = args()
    for f in (getattr(quant, f"{fn}_blocks"),
              getattr(ref, f"int8_{fn}_blocks_plain"),
              getattr(ops, f"int8_{fn}_blocks")):
        with pytest.raises(ValueError, match=match):
            f(*tensors, **kw)


def _acc_args(n=2, nb=4):
    return torch.zeros(n, nb, BLOCK, dtype=torch.int8), torch.ones(n, nb, 1)


@pytest.mark.parametrize("args,kw,match", [
    (_acc_args, {"chunk_elems": 4 * BLOCK + 1}, "chunk_elems"),
    (_acc_args, {"chunk_elems": 0}, "chunk_elems"),
    (_acc_args, {"out_dtype": torch.float16}, "out_dtype"),
    (_acc_args, {"chunk_elems": 1000, "out_dtype": torch.int8}, "out_dtype"),
    (_acc_args, {"chunk_elems": -1}, "chunk_elems"),
    (_acc_args, {"out_dtype": torch.int8}, "out_dtype"),
    (lambda: (torch.zeros(4, BLOCK, dtype=torch.int8), torch.ones(4, 1)), {},
     r"\[n>0, nb>0"),
    (lambda: (torch.zeros(2, 0, BLOCK, dtype=torch.int8),
              torch.ones(2, 0, 1)), {}, r"\[n>0, nb>0"),
])
def test_dequant_accumulate_refuses_bad_layouts(args, kw, match):
    """A chunk beyond the blocks or empty, an output dtype the kernel
    does not write, or a q that is not [n, nb, BLOCK] raises in the CUDA
    wrapper (before the device check), in the plain version and in the
    dispatcher alike."""
    from repro_torch.kernels import quant
    q, s = args()
    for f in (quant.dequant_accumulate, ref.int8_dequant_acc_plain,
              ops.int8_dequant_accumulate):
        with pytest.raises(ValueError, match=match):
            f(q, s, **kw)


@pytest.mark.parametrize("shape", [(4, BLOCK), (2, 0, BLOCK), (0, 3, BLOCK),
                                   (2, 3, BLOCK + 1)])
def test_dequant_requantize_refuses_bad_layouts(shape):
    """A q that is not [n>0, nb>0, BLOCK] raises in the CUDA wrapper
    (before the device check), in the plain version and in the
    dispatcher alike."""
    from repro_torch.kernels import quant
    q = torch.zeros(shape, dtype=torch.int8)
    s = torch.ones(shape[:-1] + (1,))
    for f in (quant.dequant_requantize, ref.int8_dequant_requant_plain,
              ops.int8_dequant_requantize):
        with pytest.raises(ValueError, match=r"\[n>0, nb>0"):
            f(q, s)


def test_dequant_requantize_counts_on_the_accumulate(rng):
    """The requantizing fold is the dequant-accumulate kernel's: its call
    raises that dispatcher's count (the launch plans' one entry for it),
    and a CPU tensor launches nothing."""
    q = _t(rng.integers(-127, 128, (2, 3, BLOCK)).astype(np.int8))
    s = _t(np.full((2, 3, 1), 0.5, np.float32))
    acc = ops.INT8_KERNELS["dequant_accumulate"]
    before = {k: (f.launches, f.calls) for k, f in ops.INT8_KERNELS.items()}
    ops.int8_dequant_requantize(q, s)
    assert (acc.launches, acc.calls) == (before["dequant_accumulate"][0],
                                         before["dequant_accumulate"][1] + 1)
    for k in ("quantize", "dequantize"):
        f = ops.INT8_KERNELS[k]
        assert (f.launches, f.calls) == before[k]
