"""The port's gather-fused collective matmul against the JAX package's
(``repro.kernels.collective_matmul``), on the CPU.

  * the chunk matmul's plain version (``ref.matmul_chunk_plain``, what a
    CPU tensor runs and what ``chip_smoke.py`` holds the CUDA kernel to)
    against the JAX Pallas kernel in interpret mode, on
    ``tests/test_fused_matmul.py``'s four shapes in float32 and bfloat16;
  * the rings on spawned gloo ranks, at n = 2 (mesh pod 2 x data 2) and
    n = 4 (mesh data 4), where a ring turned the wrong way would show:
    bit for bit against the port's plain oracles, and against the JAX
    oracles (``ag_matmul_ref``, ``matmul_rs_ref``, ``fused_bwd_dx_ref``)
    within tolerance; mode 'ag_matmul''s gradients equal the unfused
    gather-then-matmul's bit for bit;
  * the dispatch: a CPU tensor takes the plain version and counts no
    launch; the CUDA wrapper refuses a CPU tensor, and a CUDA tensor
    whose kernel cannot be built raises instead of falling back.

The train step under ``fused_matmul`` is held to the JAX step in
``tests/test_torch_train.py`` and the plan gate in
``tests/test_torch_strategy.py``.

Tolerances. Against JAX, both sides sum the K products of an output in
fp32, in their own orders, and round once to the output dtype: per
element |diff| <= 2 gamma_K (|x| @ |w|) with gamma_K = K 2^-24 (the
textbook bound of a K-term fp32 dot product, once for each side), plus
one unit in the last place of the bfloat16 result for bf16 outputs. The
rings against the JAX oracles: rtol = atol = 1e-5, test_fused_matmul.py's
bound for the same sums taken in another order.
"""
import dataclasses
import os
import queue as queue_mod
import tempfile
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.kernels import collective_matmul as jcm
from repro.kernels import ref as jref
from repro_torch.configs.base import RunConfig, ShapeCell, SystemConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.collectives import Collectives
from repro_torch.core.engine import StepBundle
from repro_torch.core.engine.train import matmul_chunk_launch_plan
from repro_torch.core.fcdp import AllGather
from repro_torch.kernels import _build, collective_matmul as cm
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import MeshShape, RankMesh

SHAPES = [(128, 64, 128), (7, 96, 100), (130, 32, 257), (1, 16, 1)]
M, K, NC = 6, 16, 8                  # the ring cases: x [M, K], w [K, n NC]
MESHES = {2: MeshShape(("pod", "data", "model"), (2, 2, 1)),
          4: MeshShape(("pod", "data", "model"), (1, 4, 1))}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _dot_bound(x, w, out, bf16):
    """Per-element bound of |port - JAX| (module docstring)."""
    k = x.shape[1]
    mag = np.abs(x.astype(np.float64)) @ np.abs(w.astype(np.float64))
    bound = 2 * k * 2.0 ** -24 * mag
    if bf16:
        e = np.floor(np.log2(np.maximum(np.abs(out), 2.0 ** -126)))
        bound = bound + 2.0 ** (e - 7)
    return bound


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_chunk_plain_matches_jax_kernel(shape, dtype, rng):
    m, k, n = shape
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 1, (k, n)).astype(np.float32)
    want = jcm.matmul_chunk(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                            interpret=True)
    tdt = getattr(torch, dtype)
    got = ref.matmul_chunk_plain(_t(x, tdt), _t(w, tdt))
    assert got.dtype == tdt and str(want.dtype) == dtype
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    # the inputs as both sides see them (bf16 rounds alike in both)
    xr, wr = _t(x, tdt).float().numpy(), _t(w, tdt).float().numpy()
    assert np.all(np.abs(got - want)
                  <= _dot_bound(xr, wr, want, dtype == "bfloat16"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(128, 64, 64), (128, 128, 64)])
def test_plain_matmul_column_identity_at_the_test_widths(dtype, m, k, n,
                                                         rng):
    """What the CPU bit parity of 'ag_matmul' rests on: at the train
    tests' shapes PyTorch's CPU matmul gives the column blocks of x @ w
    bit for bit when it multiplies the blocks alone."""
    x = _t(rng.normal(0, 1, (m, k)), dtype)
    w = _t(rng.normal(0, 1, (k, n)), dtype)
    half = n // 2
    assert torch.equal(x @ w, torch.cat([x @ w[:, :half], x @ w[:, half:]],
                                        dim=1))


def test_chunk_schedule_equals_jax():
    for args in ((1024, 2048, 1024, 2), (128, 64, 32, 4, 4.0)):
        assert cm.chunk_schedule(*args) == jcm.chunk_schedule(*args)
    assert cm.ring_perm(4) == jcm._ring_perm(4)


# -- the rings on spawned gloo ranks --------------------------------------------

def _ring_cases(coll, inp):
    """Every ring case on this rank; numpy results."""
    n, r = coll.size("data"), coll.index("data")
    x, w = _t(inp["x"]), _t(inp["w"])
    shard = w[:, r * NC:(r + 1) * NC].contiguous()
    out = {"ag": cm.ring_ag_matmul(x, shard, coll, "data"),
           "ag_bf16": cm.ring_ag_matmul(x.bfloat16(), shard.bfloat16(),
                                        coll, "data").float(),
           "rs": cm.ring_matmul_rs(_t(inp["a"][r]), _t(inp["b"][r]), coll,
                                   "data")}
    before = coll.snapshot()
    cm.ring_ag_matmul(x, shard, coll, "data")
    out["ag_bytes"] = coll.snapshot().get("ppermute/data", 0.0) \
        - before.get("ppermute/data", 0.0)
    for mode in ("ag_matmul", "both", "unfused"):
        xg = x.clone().requires_grad_(True)
        wg = shard.clone().requires_grad_(True)
        if mode == "unfused":
            y = xg @ AllGather.apply(wg, coll, "data", 1)
        else:
            y = ops.collective_ag_matmul(xg, wg, coll, "data", mode)
        (y * y).sum().backward()
        out[f"dx_{mode}"], out[f"dw_{mode}"] = xg.grad, wg.grad
    return {k: (v.detach().numpy() if torch.is_tensor(v) else v)
            for k, v in out.items()}


def _ring_worker(rank, world, init_method, mesh, inp, results):
    try:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world)
        try:
            rank_mesh = RankMesh(mesh, "gloo")
            out = _ring_cases(Collectives(rank_mesh), inp)
            out["coords"] = rank_mesh.coords
        finally:
            dist.destroy_process_group()
        results.put((rank, out, None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))


def _spawn(mesh, inp, tmp, timeout_s=300.0):
    import time
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{os.path.join(tmp, 'store')}"
    procs = [ctx.Process(target=_ring_worker,
                         args=(r, mesh.world, init, mesh, inp, results))
             for r in range(mesh.world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(got) < mesh.world:
            try:
                rank, res, err = results.get(timeout=5.0)
            except queue_mod.Empty:
                assert time.monotonic() < deadline, "ring ranks timed out"
                continue
            assert err is None, f"ring rank {rank} failed:\n{err}"
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    return [got[r] for r in range(mesh.world)]


@pytest.fixture(scope="module")
def rings():
    """n -> (inputs, each rank's results), for n = 2 and n = 4."""
    out = {}
    for n, mesh in MESHES.items():
        rng = np.random.default_rng(n)
        inp = {"x": rng.normal(0, 1, (M, K)).astype(np.float32),
               "w": rng.normal(0, 1, (K, n * NC)).astype(np.float32),
               "a": rng.normal(0, 1, (n, 6, 10)).astype(np.float32),
               "b": rng.normal(0, 1, (n, 10, 8 * n)).astype(np.float32)}
        with tempfile.TemporaryDirectory(prefix="ring_rdzv_") as tmp:
            out[n] = (inp, _spawn(mesh, inp, tmp))
    return out


def _w_chunks(inp, n):
    return torch.stack(torch.split(_t(inp["w"]), NC, dim=1))


@pytest.mark.parametrize("n", sorted(MESHES))
def test_ring_ag_matmul_vs_oracles(rings, n):
    inp, ranks = rings[n]
    x, chunks = _t(inp["x"]), _w_chunks(inp, n)
    want = ref.ag_matmul_plain(x, chunks)
    want_bf16 = ref.ag_matmul_plain(x.bfloat16(), chunks.bfloat16()).float()
    jwant = np.asarray(jref.ag_matmul_ref(jnp.asarray(inp["x"]),
                                          jnp.asarray(chunks.numpy())))
    for res in ranks:
        assert torch.equal(torch.from_numpy(res["ag"]), want)
        assert torch.equal(torch.from_numpy(res["ag_bf16"]), want_bf16)
        np.testing.assert_allclose(res["ag"], jwant, rtol=1e-5, atol=1e-5)
        # n - 1 hops of one [K, NC] fp32 chunk, all of it per hop
        assert res["ag_bytes"] == (n - 1) * K * NC * 4


@pytest.mark.parametrize("n", sorted(MESHES))
def test_ring_matmul_rs_vs_oracles(rings, n):
    inp, ranks = rings[n]
    a, b = _t(inp["a"]), _t(inp["b"])
    for res in ranks:
        r = res["coords"]["data"]
        assert torch.equal(torch.from_numpy(res["rs"]),
                           ref.matmul_rs_plain(a, b, r)), r
        np.testing.assert_allclose(
            res["rs"], np.asarray(jref.matmul_rs_ref(jnp.asarray(inp["a"]),
                                                     jnp.asarray(inp["b"]),
                                                     r)),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", sorted(MESHES))
def test_both_grads_vs_ring_oracles(rings, n):
    """Mode 'both': dx is the ring-ordered sum, dw the matmul ->
    reduce-scatter ring of x.T @ g (x is replicated, so every rank's a
    and b are x.T and g); both close to the unfused gradients."""
    inp, ranks = rings[n]
    x, chunks = _t(inp["x"]), _w_chunks(inp, n)
    g = 2.0 * ref.ag_matmul_plain(x, chunks)            # d(sum y^2)/dy
    a = x.T.contiguous().expand(n, K, M)
    b = g.expand(n, M, n * NC)
    for res in ranks:
        r = res["coords"]["data"]
        assert torch.equal(torch.from_numpy(res["dx_both"]),
                           ref.fused_bwd_dx_plain(g, chunks, r)), r
        assert torch.equal(torch.from_numpy(res["dw_both"]),
                           ref.matmul_rs_plain(a, b, r)), r
        np.testing.assert_allclose(
            res["dx_both"], np.asarray(jref.fused_bwd_dx_ref(
                jnp.asarray(g.numpy()), jnp.asarray(chunks.numpy()), r)),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["dx_both"], res["dx_unfused"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["dw_both"], res["dw_unfused"],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", sorted(MESHES))
def test_ag_matmul_grads_equal_unfused(rings, n):
    """Mode 'ag_matmul' replays the unfused backward: both gradients
    equal the gather-then-matmul's bit for bit."""
    for res in rings[n][1]:
        assert torch.equal(torch.from_numpy(res["dx_ag_matmul"]),
                           torch.from_numpy(res["dx_unfused"]))
        assert torch.equal(torch.from_numpy(res["dw_ag_matmul"]),
                           torch.from_numpy(res["dw_unfused"]))


# -- dispatch -----------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_launch_nothing(rng):
    x, w = _t(rng.normal(0, 1, (7, 96))), _t(rng.normal(0, 1, (96, 100)))
    launches, calls = ops.matmul_chunk.launches, ops.matmul_chunk.calls
    assert torch.equal(ops.matmul_chunk(x, w), x @ w)
    assert ops.matmul_chunk.launches == launches
    assert ops.matmul_chunk.calls == calls + 1


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        cm.matmul_chunk(torch.zeros(4, 8), torch.zeros(8, 4))


class _FakeCuda:
    """Stands in for a contiguous CUDA matrix on a machine without one."""
    device = torch.device("cuda", 0)

    def __init__(self, *shape):
        self.shape, self.dtype = torch.Size(shape), torch.bfloat16

    def dim(self):
        return len(self.shape)

    def stride(self, i=None):
        s = (self.shape[1], 1)
        return s if i is None else s[i]

    def data_ptr(self):
        return 0


def test_cuda_tensor_launches_or_raises(monkeypatch):
    """A CUDA tensor goes to the kernel: when the kernel cannot be built
    the call raises, counts no launch and never runs the plain version."""
    from repro_torch.kernels import _build

    def no_nvcc(name):
        raise RuntimeError(f"cannot build {name}")
    monkeypatch.setattr(_build, "load", no_nvcc)
    monkeypatch.setattr(ref, "matmul_chunk_plain",
                        lambda *a: pytest.fail("plain version ran"))
    cm._lib.cache_clear()
    launches = ops.matmul_chunk.launches
    try:
        with pytest.raises(RuntimeError, match="cannot build"):
            ops.matmul_chunk(_FakeCuda(1024, 2048), _FakeCuda(2048, 1024))
    finally:
        cm._lib.cache_clear()
    assert ops.matmul_chunk.launches == launches


@pytest.mark.parametrize("fused,want", [("none", 0), ("ag_matmul", 8),
                                        ("both", 24)])
def test_launch_plan_at_the_smoke_runs_width(fused, want):
    """qwen2.5-3b at full width, depth 2, mesh pod 2 x data 2: wo and
    w_out fuse over 'data' (n = 2), so a rank-step launches 2 x 2 x 2
    chunk matmuls under 'ag_matmul' and three times that under 'both'
    (what chip_smoke.py checks on the card)."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2)
    run = RunConfig(model=cfg, shape=ShapeCell("t", "train", 512, 8),
                    system=SystemConfig(fused_matmul=fused))
    b = StepBundle(run, device="cpu",
                   mesh=MeshShape(("pod", "data", "model"), (2, 2, 1)))
    assert matmul_chunk_launch_plan(b) == want
    assert sum(p.is_fused for p in b.plan_leaves) == (0 if fused == "none"
                                                       else 2)


# -- the kernel's variants on the card (launch_plan), with stand-ins ----------

class _FakeMat:
    """Stands in for a bf16 CUDA matrix view: a shape, element strides and
    an address. A copy would show as a call to ``contiguous``, which
    fails the test."""
    device = torch.device("cuda", 0)
    dtype = torch.bfloat16

    def __init__(self, shape, strides, ptr=0):
        self.shape, self._strides, self._ptr = torch.Size(shape), \
            tuple(strides), ptr

    @classmethod
    def rows(cls, r, c, ptr=0):
        return cls((r, c), (c, 1), ptr)

    def dim(self):
        return 2

    def stride(self, i=None):
        return self._strides if i is None else self._strides[i]

    def data_ptr(self):
        return self._ptr

    def t(self):
        return _FakeMat(self.shape[::-1], self._strides[::-1], self._ptr)

    def cols(self, j0, j1):
        """The column slice [:, j0:j1]."""
        return _FakeMat((self.shape[0], j1 - j0), self._strides,
                        self._ptr + 2 * j0 * self._strides[1])

    def reshape(self, *shape):
        assert tuple(shape) in ((-1, self.shape[1]), tuple(self.shape))
        return self

    def contiguous(self):
        pytest.fail("an operand was copied")


@pytest.fixture
def fake_launches(monkeypatch):
    """Replaces the built library, the output allocation and the stream
    with recorders; yields the list of (entry point, args) launched."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *a: calls.append((name, a)) or 0
    monkeypatch.setattr(cm, "_lib", lambda: Lib())
    monkeypatch.setattr(cm, "_new_output", lambda m, n, like: torch.empty(
        (m, n), dtype=torch.bfloat16))
    monkeypatch.setattr(_build, "launch", lambda device, fn, *a: fn(*a, 0))
    return calls


# the train phase's shapes: 1,024 tokens, d_model 2,048, d_ff 11,008, a
# ring of n = 2 over data (chunks of 1,024 output columns)
TOK, DM, DFF = 1024, 2048, 11008


@pytest.mark.parametrize("case", ["forward", "forward_stage1_col_major",
                                  "both_dx_chunk_T", "both_dw_x2_T"])
def test_smoke_shapes_reach_the_wgmma_variant_in_place(case, fake_launches):
    """The forward chunk, mode 'both''s ``chunk.T`` and ``x2.T`` take the
    wgmma + TMA variant with their own layout (the transpose bits) and
    leading dimensions: no operand is copied."""
    g2 = _FakeMat.rows(TOK, DM, ptr=1 << 20)
    chunk = _FakeMat.rows(DFF, DM // 2, ptr=1 << 24)
    x2 = _FakeMat.rows(TOK, DFF, ptr=1 << 28)
    x, w, want = {
        "forward": (x2, chunk, (0, DFF, 1, DM // 2)),
        "forward_stage1_col_major": (
            x2, _FakeMat((DFF, DM // 2), (1, DFF)), (0, DFF, 0, DFF)),
        "both_dx_chunk_T": (g2.cols(DM // 2, DM), chunk.t(),
                            (0, DM, 0, DM // 2)),
        "both_dw_x2_T": (x2.t(), g2.cols(0, DM // 2), (1, DFF, 1, DM)),
    }[case]
    launches = ops.matmul_chunk.launches
    out = cm._chunk_mm(x, w)
    assert ops.matmul_chunk.launches == launches + 1
    assert out.shape == (x.shape[0], w.shape[1])
    (name, args), = fake_launches
    assert name == "matmul_chunk_bf16_tma"
    m, n, k, lda, ldb, ldc, x_mn, w_mn = args[3:11]
    assert (m, n, k, ldc) == (x.shape[0], w.shape[1], x.shape[1],
                              w.shape[1])
    assert (x_mn, lda, w_mn, ldb) == want
    assert args[:2] == (x.data_ptr(), w.data_ptr())


@pytest.mark.parametrize("x,w", [
    (_FakeMat.rows(7, 96), _FakeMat.rows(96, 100)),            # ld 100
    (_FakeMat.rows(130, 32), _FakeMat.rows(32, 257)),          # ld 257
    (_FakeMat.rows(1, 16), _FakeMat.rows(16, 1)),              # ld 1
    (_FakeMat.rows(64, 100).cols(4, 100), _FakeMat.rows(96, 64)),  # x + 8 B
    (_FakeMat.rows(7, 96), _FakeMat((96, 100), (1, 100)).cols(0, 96)),
])
def test_ragged_and_misaligned_take_the_mma_variant(x, w):
    """What TMA cannot read (a leading dimension not a multiple of 8, a
    K-major operand off a 16-byte boundary) takes the mma.sync variant."""
    plan = cm.launch_plan(x, w)
    assert plan.variant == "mma"


def test_mma_variant_copies_only_a_column_major_operand(fake_launches,
                                                        monkeypatch):
    """The mma.sync variant reads rows: a column-major operand TMA cannot
    take is copied to row-major (and only then)."""
    copied = []
    monkeypatch.setattr(_FakeMat, "contiguous", lambda self: copied.append(
        self.shape) or _FakeMat.rows(*self.shape))
    x = _FakeMat.rows(7, 100)
    w_col = _FakeMat((100, 36), (1, 104))     # K-major, ld 104
    w_bad = _FakeMat((100, 36), (1, 101))     # ld 101
    assert cm.launch_plan(x, w_col).variant == "mma"    # x's ld is 100
    cm.matmul_chunk(x, w_bad)
    (name, args), = fake_launches
    assert name == "matmul_chunk_bf16" and copied == [torch.Size((100, 36))]
    assert args[6:9] == (100, 36, 36)                           # lda ldb ldc


@pytest.mark.parametrize("k,n,ranks", [(96, 200, 2), (2048, 2048, 2),
                                       (11008, 2048, 2), (96, 264, 4)])
def test_full_matrix_and_its_column_chunks_take_one_variant(k, n, ranks):
    """A column chunk of a row-major weight starts at any element; the
    wgmma variant's MN-major map starts at the base rounded down, so
    every chunk takes the variant its full matrix takes (the column
    identity the ring rests on does not meet a change of variant)."""
    x = _FakeMat.rows(70, k, ptr=4096)
    w = _FakeMat.rows(k, n, ptr=1 << 20)
    full = cm.launch_plan(x, w)
    nc = n // ranks
    for j in range(ranks):
        assert cm.launch_plan(x, w.cols(j * nc, (j + 1) * nc)) == full
    assert full.variant == "tma"
