"""CPU twins of the port's sequence parallelism
(`paddle_tpu_torch.parallel.ring_attention`, `.ulysses`) against the JAX
package's ring, zigzag ring and Ulysses (`paddle_tpu.parallel`) — the
cases of `test_distributed.py`'s TestRingAttention and its Ulysses and
`sp_attention` cases.

The port runs in one 8-rank gloo world on the CPU (tests/torch_dist_util)
with the inputs the reference's tests draw; every rank returns its
shard of the output and the gradients it holds. The reference side runs
in this process on the 8 virtual devices of tests/conftest.py: its
chunked and zigzag rings as they are, and, where its ring reaches the
Pallas kernels, the reference tests' own oracle (full attention and its
jax.grad) — on the CPU the port's flash ring runs the plain versions of
K4, K6, K7 and K8 in every ring step. Tolerances are the reference tests'
(rtol 2e-4 / atol 2e-5 forward, 5e-3 / 5e-4 gradients of the flash
ring); the chunked and zigzag rings are held to the reference's own
functions at rtol 1e-5 / atol 1e-6 where they run (the zigzag ring's
gradients go against the oracle: jax.grad through the reference's ring
compiles for a minute), Ulysses to the oracle at 1e-4 of its largest
value.
"""
import numpy as np
import pytest
import torch

from torch_dist_util import run_world

torch.set_num_threads(1)

N = 8


def _inputs(seed, shape, how="rand"):
    if isinstance(seed, np.random.RandomState):
        rs = seed
    else:
        rs = np.random.RandomState(seed)
    f = rs.rand if how == "rand" else rs.randn
    return [f(*shape).astype(np.float32) for _ in range(3)]


CASES = {
    # name: (seed, (b, h, s, d), how)
    "matches_full": (0, (1, 2, 64, 8), "rand"),
    "flash": (1, (1, 2, 8 * 128, 32), "rand"),
    "flash_bwd": (2, (1, 1, 8 * 128, 32), "rand"),
    "long_shard": (3, (1, 1, 8 * 192, 8), "rand"),
    "ulysses": (10, (2, 8, 256, 32), "randn"),
    "ulysses_bwd": (11, (1, 4, 256, 32), "randn"),
    "auto": (12, (1, 4, 512, 32), "randn"),
    "d256": (13, (1, 1, 8 * 128, 256), "rand"),
}


def _zigzag_inputs(n):
    rs = np.random.RandomState(n)
    return [rs.rand(2, 2, 16 * n, 8).astype(np.float32) for _ in range(3)]


def _world(rank):
    """Every case on the port: (outputs, grads) gathered into globals."""
    import sys

    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel.ulysses import (sp_attention,
                                                   ulysses_attention)
    import paddle_tpu_torch.parallel.ring_attention  # noqa: F401
    R = sys.modules["paddle_tpu_torch.parallel.ring_attention"]

    mesh8 = make_mesh(dp=1, sp=N)
    mesh4 = make_mesh(dp=1, sp=4, ranks=range(4))
    out = {}

    def tensors(case):
        seed, shape, how = CASES[case]
        return [torch.from_numpy(a).requires_grad_(True)
                for a in _inputs(seed, shape, how)]

    def grads_of(o, ts):
        (o.float() ** 2).sum().backward()
        return [t.grad for t in ts]

    q, k, v = tensors("matches_full")
    for causal in (False, True):
        out[f"matches_full/{causal}"] = R.ring_attention_sharded(
            q, k, v, mesh8, causal=causal)
    out["matches_full/impl"] = R.last_impl_used()
    q, k, v = tensors("flash")
    for causal in (False, True):
        out[f"flash/{causal}"] = R.ring_attention_sharded(
            q, k, v, mesh8, causal=causal, impl="flash")
    out["flash/impl"] = R.last_impl_used()
    ts = tensors("flash_bwd")
    o = R.ring_attention_sharded(*ts, mesh8, causal=True, impl="flash")
    out["flash_bwd/grads"] = grads_of(o, ts)
    q, k, v = tensors("long_shard")
    out["long_shard"] = R.ring_attention_sharded(q, k, v, mesh8,
                                                 causal=True, impl="chunked")
    for n, mesh in ((4, mesh4), (8, mesh8)):
        if not mesh.member:
            continue
        ts = [torch.from_numpy(a).requires_grad_(True)
              for a in _zigzag_inputs(n)]
        o = R.zigzag_ring_attention_sharded(*ts, mesh)
        out[f"zigzag{n}"] = o
        out[f"zigzag{n}/grads"] = grads_of(o, ts)
    if mesh4.member:
        qz = torch.from_numpy(_zigzag_inputs_sp())
        perm, inv = R.zigzag_order(4, qz.shape[2]), R.zigzag_inverse(4,
                                                                    qz.shape[2])
        loc = R.shard_sequence(qz[:, :, perm], mesh4)
        oz = sp_attention(loc, loc, loc, causal=True, impl="zigzag",
                          mesh=mesh4)
        out["sp_zigzag"] = torch.cat(comm.all_gather(oz, mesh4.group("sp")),
                                     2)[:, :, inv]
        try:
            sp_attention(loc, loc, loc, causal=False, impl="zigzag",
                         mesh=mesh4)
            out["sp_zigzag/raises"] = ""
        except ValueError as e:
            out["sp_zigzag/raises"] = str(e)
        for case in ("ulysses", "ulysses_bwd"):
            ts = [R.shard_sequence(t.detach(), mesh4).clone()
                  .requires_grad_(True) for t in tensors(case)]
            o = ulysses_attention(*ts, causal=True, mesh=mesh4)
            out[case] = o
            if case == "ulysses_bwd":
                out[case + "/grads"] = grads_of(o, ts)
    ts = [R.shard_sequence(t.detach(), mesh8) for t in tensors("auto")]
    out["auto"] = sp_attention(*ts, causal=True, mesh=mesh8)
    out["auto/impl"] = R.last_impl_used()
    q, k, v = tensors("d256")
    out["d256"] = R.ring_attention_sharded(q, k, v, mesh8, causal=True)
    out["d256/impl"] = R.last_impl_used()
    return {k: ([x.detach() for x in v] if isinstance(v, list) else
                (v.detach() if torch.is_tensor(v) else v))
            for k, v in out.items()}


def _zigzag_inputs_sp():
    rs = np.random.RandomState(0)
    return rs.rand(1, 2, 16 * 4, 8).astype(np.float32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_world(_world, N, tmp_path_factory.mktemp("ring"))


def _full_attn_np(q, k, v, causal):
    s = q.shape[2]
    sc = q.shape[-1] ** -0.5
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) * sc
    if causal:
        logits = np.where(np.tril(np.ones((s, s), bool)), logits, -1e30)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", w, v)


def _ref_grads(q, k, v, causal):
    import jax
    import jax.numpy as jnp

    def loss(q, k, v):
        s = q.shape[2]
        logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
        if causal:
            logits = jnp.where(jnp.tril(jnp.ones((s, s), bool)), logits,
                               -1e30)
        o = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(logits, -1), v)
        return (o * o).sum()

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _ref_mesh(n):
    import jax

    from paddle_tpu.parallel.mesh import make_mesh
    return make_mesh(dp=1, mp=1, pp=1, sp=n, devices=jax.devices()[:n])


def test_matches_full_attention(port):
    """Contiguous ring at S_local 8 (the chunked impl): the reference's
    ring_attention under shard_map and the full-attention oracle."""
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.parallel.ring_attention import ring_attention
    q, k, v = _inputs(0, (1, 2, 64, 8))
    mesh = _ref_mesh(N)
    assert port[0]["matches_full/impl"] == "chunked"
    for causal in (False, True):
        ref = np.asarray(shard_map(
            lambda q, k, v: ring_attention(q, k, v, "sp", causal=causal),
            mesh=mesh, in_specs=(P(None, None, "sp", None),) * 3,
            out_specs=P(None, None, "sp", None))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
        for r in range(N):
            got = port[r][f"matches_full/{causal}"]
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got, _full_attn_np(q, k, v, causal),
                                       rtol=2e-4, atol=2e-5)


def test_flash_in_ring_matches_full(port):
    """S_local 128, D 32: the flash impl (K4's plain version a ring
    step) against full attention."""
    q, k, v = _inputs(1, (1, 2, 8 * 128, 32))
    for r in range(N):
        assert port[r]["flash/impl"] == "flash"
        for causal in (False, True):
            np.testing.assert_allclose(port[r][f"flash/{causal}"],
                                       _full_attn_np(q, k, v, causal),
                                       rtol=2e-3, atol=2e-4)


def test_flash_in_ring_backward_matches_full(port):
    """The ring's backward (K6, K7, K8's plain versions a ring step, dk
    and dv travelling home) against jax.grad of full attention."""
    q, k, v = _inputs(2, (1, 1, 8 * 128, 32))
    want = _ref_grads(q, k, v, True)
    for r in range(N):
        for a, b in zip(port[r]["flash_bwd/grads"], want):
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4)


def test_zigzag_ring_matches_full_and_grads(port):
    """The load-balanced causal ring over 4 and 8 ranks: its output
    against the reference's zigzag_ring_attention_sharded (4 ranks) and
    full attention, its gradients against jax.grad of full attention (the
    reference test's oracle; jax.grad through the reference's ring costs
    a minute of compiling here)."""
    import jax.numpy as jnp

    from paddle_tpu.parallel.ring_attention import (
        zigzag_inverse, zigzag_order, zigzag_ring_attention_sharded)
    from paddle_tpu_torch.parallel.ring_attention import (
        zigzag_inverse as t_inv, zigzag_order as t_order)
    for n in (4, 8):
        q, k, v = _zigzag_inputs(n)
        want = _full_attn_np(q, k, v, True)
        g_ref = _ref_grads(q, k, v, True)
        ref = None
        if n == 4:
            ref = np.asarray(zigzag_ring_attention_sharded(
                *(jnp.asarray(a) for a in (q, k, v)), _ref_mesh(n)))
        for r in range(n):
            got = port[r][f"zigzag{n}"]
            if ref is not None:
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
            for a, b in zip(port[r][f"zigzag{n}/grads"], g_ref):
                np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4)
        s = 16 * n
        np.testing.assert_array_equal(t_order(n, s), zigzag_order(n, s))
        np.testing.assert_array_equal(t_inv(n, s), zigzag_inverse(n, s))


def test_sp_attention_zigzag_impl(port):
    """sp_attention(impl="zigzag") on a zigzag-layout shard equals full
    causal attention; the non-causal case is refused."""
    q = _zigzag_inputs_sp()
    want = _full_attn_np(q, q, q, True)
    for r in range(4):
        np.testing.assert_allclose(port[r]["sp_zigzag"], want, rtol=2e-4,
                                   atol=2e-5)
        assert "causal" in port[r]["sp_zigzag/raises"]


def test_chunked_ring_long_shard(port):
    """S_local 192 (not flash-eligible): the chunked impl."""
    q, k, v = _inputs(3, (1, 1, 8 * 192, 8))
    for r in range(N):
        np.testing.assert_allclose(port[r]["long_shard"],
                                   _full_attn_np(q, k, v, True),
                                   rtol=2e-4, atol=2e-5)


def _shard(x, r, n):
    c = x.shape[2] // n
    return x[:, :, r * c:(r + 1) * c]


def test_ulysses_matches_full_attention(port):
    """All-to-all sequence parallelism over 4 ranks (seq -> head, the
    port's flash_attention over the full sequence, head -> seq)."""
    q, k, v = _inputs(10, (2, 8, 256, 32), "randn")
    want = _full_attn_np(q, k, v, True)
    for r in range(4):
        got = port[r]["ulysses"]
        assert np.abs(got - _shard(want, r, 4)).max() \
            <= 1e-4 * np.abs(want).max()


def test_ulysses_backward_matches_full(port):
    """Ulysses' gradients (each rank's shard) against jax.grad of full
    attention."""
    q, k, v = _inputs(11, (1, 4, 256, 32), "randn")
    want = _ref_grads(q, k, v, True)
    for r in range(4):
        for a, b in zip(port[r]["ulysses_bwd/grads"], want):
            sb = _shard(b, r, 4)
            assert np.abs(a - sb).max() <= 1e-4 * np.abs(b).max()


def test_sp_attention_auto_picks(port):
    """H 4 < sp 8: auto takes the ring (Ulysses cannot split the heads),
    whose output equals full attention."""
    q, k, v = _inputs(12, (1, 4, 512, 32), "randn")
    want = _full_attn_np(q, k, v, True)
    for r in range(N):
        got = port[r]["auto"]
        assert got.shape == (1, 4, 64, 32)
        assert port[r]["auto/impl"] == "chunked"
        np.testing.assert_allclose(got, _shard(want, r, N), rtol=2e-4,
                                   atol=2e-5)


def test_flash_gate_head_dim_256(port):
    """ROADMAP §C 21: the reference's gate admits D 256, the port's
    kernels take D 32/64/128, so at D 256 the port's ring takes the
    chunked impl, with the same output."""
    import jax.numpy as jnp

    from paddle_tpu.parallel.ring_attention import _flash_ok as ref_ok
    from paddle_tpu_torch.parallel.ring_attention import _flash_ok
    assert ref_ok(jnp.zeros((1, 1, 128, 256)))
    assert not _flash_ok(torch.zeros(1, 1, 128, 256))
    assert _flash_ok(torch.zeros(1, 1, 128, 128))
    q, k, v = _inputs(13, (1, 1, 8 * 128, 256))
    for r in range(N):
        assert port[r]["d256/impl"] == "chunked"
        np.testing.assert_allclose(port[r]["d256"],
                                   _full_attn_np(q, k, v, True),
                                   rtol=2e-4, atol=2e-5)
