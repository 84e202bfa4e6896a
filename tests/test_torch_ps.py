"""CPU twins of the port's parameter-server tables
(`paddle_tpu_torch.distributed.ps`) against the JAX package's — the PS
cases of `test_spawn_ps.py` (TestSparseTable, TestPSEmbedding).

The host tables draw their rows from the same numpy seed in both
packages, so every table is compared element for element (1e-6 after
float32 updates). The recsys tower trains both packages' towers from the
same table and dense weights (the port's dense layer is a torch Linear
holding the reference's numbers, its Adam the port's): every step's loss
within 1e-5 relative or 1e-8 absolute (the loss falls to ~1e-8), the
table after 60 steps within 1e-5.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _tables(**kw):
    from paddle_tpu.distributed.ps import SparseTable as RefTable
    from paddle_tpu_torch.distributed.ps import SparseTable
    return RefTable(**kw), SparseTable(**kw)


def test_pull_push_sgd():
    for t in _tables(rows=100, dim=4, learning_rate=1.0, seed=0):
        before = t.pull([3, 7]).copy()
        t.push([3, 7], np.ones((2, 4), np.float32))
        np.testing.assert_allclose(t.pull([3, 7]), before - 1.0, atol=1e-6)
    r, p = _tables(rows=100, dim=4, learning_rate=1.0, seed=0)
    np.testing.assert_array_equal(p.data, r.data)


def test_duplicate_ids_accumulate_and_adagrad():
    for opt in ("sgd", "adagrad"):
        r, p = _tables(rows=10, dim=2, optimizer=opt, learning_rate=1.0)
        for t in (r, p):
            t.push([5, 5, 1], np.stack([np.full(2, 2.0, np.float32),
                                        np.ones(2, np.float32),
                                        np.full(2, -3.0, np.float32)]))
        np.testing.assert_allclose(p.data, r.data, atol=1e-6)
        if opt == "adagrad":
            np.testing.assert_allclose(p.state_dict()["g2"],
                                       r.state_dict()["g2"], atol=1e-6)


def test_row_sharding_routes_by_modulo():
    for sid in (0, 1):
        r, p = _tables(rows=10, dim=2, num_shards=2, shard_id=sid, seed=1)
        np.testing.assert_array_equal(p.pull([sid, sid + 2]),
                                      r.pull([sid, sid + 2]))
        with pytest.raises(ValueError, match="wrong shard"):
            p.pull([1 - sid])


def test_state_roundtrip():
    from paddle_tpu_torch.distributed.ps import SparseTable
    t = SparseTable(10, 2, seed=3)
    t.push([2], np.ones((1, 2), np.float32))
    t2 = SparseTable(10, 2, seed=99)
    t2.set_state_dict(t.state_dict())
    np.testing.assert_allclose(t2.pull([2]), t.pull([2]))
    with pytest.raises(ValueError, match="unsupported"):
        SparseTable(10, 2, optimizer="adam")


def test_train_recsys_tower():
    """PS-backed embedding + a dense layer, 60 steps: the port's tower
    against the reference's on the same table and weights; the table must
    learn (the loss falls below 0.35 of its start, the reference test's
    bound)."""
    import jax.numpy as jnp

    import paddle_tpu as paddle
    import paddle_tpu.nn as rnn
    import paddle_tpu.optimizer as ropt
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.distributed.ps import PSEmbedding as RefEmb
    import paddle_tpu_torch.optimizer as popt
    from paddle_tpu_torch.distributed.ps import PSEmbedding

    paddle.seed(0)
    remb = RefEmb(50, 8, learning_rate=0.5)
    fc = rnn.Linear(8, 1)
    w0, b0 = fc.weight.numpy().copy(), fc.bias.numpy().copy()
    ropt_ = ropt.Adam(learning_rate=0.05, parameters=fc.parameters())
    emb = PSEmbedding(50, 8, learning_rate=0.5, device="cpu")
    np.testing.assert_array_equal(emb.table.data, remb.table.data)
    lin = torch.nn.Linear(8, 1)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w0).T)
        lin.bias.copy_(torch.from_numpy(b0))
    popt_ = popt.Adam(learning_rate=0.05,
                      parameters=list(lin.named_parameters()), device="cpu")
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 50, (32,))
    y = (ids % 2).astype(np.float32)[:, None]
    losses, ref_losses = [], []
    for _ in range(60):
        e = remb(Tensor(jnp.asarray(ids.astype(np.int32))))
        loss = ((fc(e) - Tensor(jnp.asarray(y))) ** 2).mean()
        loss.backward()
        ropt_.step()
        ropt_.clear_grad()
        remb.apply_gradients()
        ref_losses.append(float(loss.numpy()))
        out = lin(emb(torch.from_numpy(ids)))
        loss = ((out - torch.from_numpy(y)) ** 2).mean()
        loss.backward()
        popt_.step()
        popt_.clear_grad()
        emb.apply_gradients()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(emb.table.data, remb.table.data, atol=1e-5)
    assert losses[-1] < losses[0] * 0.35, (losses[0], losses[-1])
    assert not emb._pending


def test_fleet_ps_role_api(tmp_path, monkeypatch):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import ps as psmod
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    fleet.init(is_collective=False, device="cpu")
    assert fleet.fleet.is_server() and not fleet.fleet.is_worker()
    t = psmod.runtime().register_table("emb", psmod.SparseTable(10, 2,
                                                                seed=4))
    fleet.fleet.init_server()
    fleet.fleet.run_server()
    assert psmod.runtime().running
    t.push([1], np.ones((1, 2), np.float32))
    saved = t.data.copy()
    psmod.save_persistables(str(tmp_path))
    t.data[:] = 0
    fleet.fleet.init_server(str(tmp_path))
    np.testing.assert_array_equal(t.data, saved)
    fleet.fleet.stop_worker()
    assert not psmod.runtime().running
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
    fleet.init(is_collective=True, device="cpu")
    assert fleet.fleet.is_worker() and fleet.fleet.is_first_worker()
