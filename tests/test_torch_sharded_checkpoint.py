"""CPU twins of the port's sharded checkpoint
(`paddle_tpu_torch.distributed.checkpoint`) against the JAX package's
(`paddle_tpu.distributed.checkpoint`) — the cases of
`test_sharded_checkpoint.py`, and a checkpoint written by each package
loaded by the other.

The sharded cases run the port in one 8-rank gloo world on the
reference's meshes (dp 4 x mp 2, its transpose mp 2 x dp 4, dp 8); the
reference writes and reads its checkpoints in this process on the 8
virtual devices of tests/conftest.py. Values are compared exactly (a
checkpoint moves bytes).
"""
import collections
import os

import numpy as np
import pytest
import torch

from torch_dist_util import run_world

torch.set_num_threads(1)

N = 8
OptState = collections.namedtuple("OptState", ["m", "v"])


def _state_np():
    rs = np.random.RandomState(0)
    return rs.randn(16, 8).astype(np.float32), rs.randn(8).astype(np.float32)


def _bf16_np():
    return np.random.RandomState(3).randn(16, 8).astype(np.float32)


SPECS = {"['w']": ("dp", "mp"), "['nested']['b']": None, "['wb']": ("dp",
                                                                     "mp")}


def _world(rank, dirs):
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.parallel.mesh import Mesh, local_slice

    m42 = Mesh({"dp": 4, "mp": 2}, range(N))
    m24 = Mesh({"mp": 2, "dp": 4}, range(N))
    m8 = Mesh({"dp": 8}, range(N))
    w_np, b_np = _state_np()
    w, b = torch.from_numpy(w_np), torch.from_numpy(b_np)
    wb = torch.from_numpy(_bf16_np()).to(torch.bfloat16)

    def loc(x, mesh, spec):
        return local_slice(x, spec, mesh.coords, mesh.shape).clone()

    state = {"w": loc(w, m42, ("dp", "mp")), "nested": {"b": b.clone()},
             "step": 7, "wb": loc(wb, m42, ("dp", "mp"))}
    out = {}
    ckpt.save(state, dirs["same"], m42, SPECS)
    like = {"w": torch.zeros(4, 4), "nested": {"b": torch.zeros(8)},
            "step": 0, "wb": torch.zeros(4, 4, dtype=torch.bfloat16)}
    got = ckpt.load(dirs["same"], like, m42, SPECS)
    out["same"] = (got["w"], got["nested"]["b"], got["step"],
                   got["wb"].float())
    spec_t = {"['w']": ("mp", "dp"), "['nested']['b']": None,
              "['wb']": ("mp", "dp")}
    got = ckpt.load(dirs["same"], {"w": torch.zeros(8, 2),
                                   "nested": {"b": torch.zeros(8)},
                                   "step": 0, "wb": torch.zeros(
                                       8, 2, dtype=torch.bfloat16)},
                    m24, spec_t)
    out["reshard"] = (got["w"], got["wb"].float(), m24.coords)
    out["files"] = sorted(os.listdir(dirs["same"]))

    opt = {"opt": OptState(m=loc(torch.arange(16.0), m8, ("dp",)),
                           v=loc(torch.ones(16), m8, ("dp",)))}
    ospec = {"['opt'].m": ("dp",), "['opt'].v": ("dp",)}
    ckpt.save(opt, dirs["nt"], m8, ospec)
    got = ckpt.load(dirs["nt"], {"opt": OptState(m=torch.zeros(2),
                                                 v=torch.zeros(2))},
                    m8, ospec)
    out["nt"] = (type(got["opt"]).__name__, got["opt"].m)

    sp = {"['w']": ("dp",)}
    ckpt.save({"w": torch.full((1,), 1.0)}, dirs["resave"], m8, sp)
    ckpt.save({"w": torch.full((1,), 2.0)}, dirs["resave"], m8, sp)
    out["resave"] = ckpt.load(dirs["resave"], {"w": torch.zeros(1)}, m8,
                              sp)["w"]
    try:
        ckpt.load(dirs["resave"], {"w": torch.zeros(1, dtype=torch.bfloat16)},
                  m8, sp)
        out["dtype_err"] = ""
    except ValueError as e:
        out["dtype_err"] = str(e)

    cs = {"['a_b']": ("dp",), "['a/b']": ("dp",)}
    ckpt.save({"a_b": torch.full((1,), 1.0), "a/b": torch.full((1,), 2.0)},
              dirs["collide"], m8, cs)
    got = ckpt.load(dirs["collide"], {"a_b": torch.zeros(1),
                                      "a/b": torch.zeros(1)}, m8, cs)
    out["collide"] = (got["a_b"], got["a/b"])

    # a checkpoint the reference wrote, into the port's transposed mesh
    got = ckpt.load(dirs["from_ref"], {"w": torch.zeros(8, 2),
                                       "nested": {"b": torch.zeros(8)},
                                       "step": 0}, m24,
                    {"['w']": ("mp", "dp")})
    out["from_ref"] = (got["w"], got["nested"]["b"], got["step"])
    # and one for the reference to read
    ckpt.save(state, dirs["to_ref"], m42, SPECS)
    return out


def _ref_mesh(shape, names):
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def _ref_state():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    w, b = _state_np()
    mesh = _ref_mesh((4, 2), ("dp", "mp"))
    return {"w": jax.device_put(w, NamedSharding(mesh, P("dp", "mp"))),
            "nested": {"b": jax.device_put(b, NamedSharding(mesh, P(None)))},
            "step": 7}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    from paddle_tpu.distributed import checkpoint as rckpt
    root = tmp_path_factory.mktemp("ckpt")
    dirs = {k: str(root / k) for k in ("same", "nt", "resave", "collide",
                                       "from_ref", "to_ref")}
    rckpt.save(_ref_state(), dirs["from_ref"])
    return dirs, run_world(_world, N, root, dirs)


def _block(x, r, shape, spec):
    from paddle_tpu_torch.parallel.mesh import local_slice, mesh_coords
    return local_slice(torch.from_numpy(x), spec, mesh_coords(r, shape),
                       shape).numpy()


def test_save_load_same_sharding(port):
    _dirs, res = port
    w, b = _state_np()
    for r in range(N):
        gw, gb, step, gwb = res[r]["same"]
        np.testing.assert_array_equal(
            gw, _block(w, r, {"dp": 4, "mp": 2}, ("dp", "mp")))
        np.testing.assert_array_equal(gb, b)
        assert step == 7


def test_reshard_on_load(port):
    """Saved dp 4 x mp 2, loaded mp-major (mp 2 x dp 4, spec (mp, dp))."""
    _dirs, res = port
    w, _b = _state_np()
    for r in range(N):
        gw, _gwb, _c = res[r]["reshard"]
        np.testing.assert_array_equal(
            gw, _block(w, r, {"mp": 2, "dp": 4}, ("mp", "dp")))


def test_namedtuple_optimizer_state(port):
    _dirs, res = port
    for r in range(N):
        name, m = res[r]["nt"]
        assert name == "OptState"
        np.testing.assert_array_equal(m, [2.0 * r, 2.0 * r + 1])


def test_resave_overwrites_and_dtype_checked(port):
    dirs, res = port
    for r in range(N):
        np.testing.assert_array_equal(res[r]["resave"], [2.0])
        assert "dtype" in res[r]["dtype_err"]
    # the first save's files are gone: one save id left
    ids = {f.split(".")[1] for f in os.listdir(dirs["resave"])
           if f.endswith(".npy")}
    assert len(ids) == 1


def test_replicated_saved_once(port):
    dirs, res = port
    b_files = [f for f in res[0]["files"]
               if f.endswith(".npy") and "nested.b" in f]
    assert len(b_files) == 1
    assert len([f for f in res[0]["files"] if f.startswith("index.p")]) == N


def test_bf16_roundtrip(port):
    """bf16 slabs are stored as raw bytes: bitwise back, also resharded."""
    _dirs, res = port
    wb = torch.from_numpy(_bf16_np()).to(torch.bfloat16).float().numpy()
    for r in range(N):
        np.testing.assert_array_equal(
            res[r]["same"][3], _block(wb, r, {"dp": 4, "mp": 2},
                                      ("dp", "mp")))
        np.testing.assert_array_equal(
            res[r]["reshard"][1], _block(wb, r, {"mp": 2, "dp": 4},
                                         ("mp", "dp")))


def test_colliding_sanitized_keys(port):
    _dirs, res = port
    for r in range(N):
        a, b = res[r]["collide"]
        np.testing.assert_array_equal(a, [1.0])
        np.testing.assert_array_equal(b, [2.0])


def test_reference_checkpoint_loads_in_the_port(port):
    """The reference's save (one process, 8 devices) into 8 port ranks on
    a transposed mesh."""
    _dirs, res = port
    w, b = _state_np()
    for r in range(N):
        gw, gb, step = res[r]["from_ref"]
        np.testing.assert_array_equal(
            gw, _block(w, r, {"mp": 2, "dp": 4}, ("mp", "dp")))
        np.testing.assert_array_equal(gb, b)
        assert step == 7


def test_port_checkpoint_loads_in_the_reference(port):
    """The port's 8-rank save (8 index files) into the reference, on its
    dp 4 x mp 2 mesh and resharded onto the transpose."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from paddle_tpu.distributed import checkpoint as rckpt
    dirs, _res = port
    w, b = _state_np()
    for shape, names, spec in (((4, 2), ("dp", "mp"), P("dp", "mp")),
                               ((2, 4), ("mp", "dp"), P("mp", "dp"))):
        mesh = _ref_mesh(shape, names)
        like = {"w": jax.device_put(jnp.zeros((16, 8)),
                                    NamedSharding(mesh, spec)),
                "nested": {"b": jax.device_put(jnp.zeros(8),
                                               NamedSharding(mesh, P()))},
                "step": 0,
                "wb": jax.device_put(jnp.zeros((16, 8), jnp.bfloat16),
                                     NamedSharding(mesh, spec))}
        out = rckpt.load(dirs["to_ref"], like)
        np.testing.assert_array_equal(np.asarray(out["w"]), w)
        np.testing.assert_array_equal(np.asarray(out["nested"]["b"]), b)
        np.testing.assert_array_equal(
            np.asarray(out["wb"]).astype(np.float32),
            torch.from_numpy(_bf16_np()).to(torch.bfloat16).float().numpy())
        assert out["step"] == 7
        assert out["w"].sharding.spec == spec


def test_rank_like_key_survives_cleanup(tmp_path):
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    d = str(tmp_path / "ck")
    ckpt.save({"p1": torch.arange(8.0)}, d)
    out = ckpt.load(d, {"p1": torch.zeros(8)})
    np.testing.assert_array_equal(out["p1"].numpy(), np.arange(8.0))


def test_simulated_two_process_save(tmp_path):
    """Two halves of one save share a save_id and load; uncoordinated ids
    are an incomplete save, refused."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    w, b = _state_np()
    state = {"w": torch.from_numpy(w), "nested": {"b": torch.from_numpy(b)},
             "step": 0}
    d = str(tmp_path / "ck")
    for pi in (0, 1):
        ckpt.save(state, d, process_index=pi, save_id="aaaaaaaaaaaa",
                  process_count=2)
    like = {"w": torch.zeros(16, 8), "nested": {"b": torch.zeros(8)},
            "step": 1}
    np.testing.assert_array_equal(ckpt.load(d, like)["w"].numpy(), w)
    d2 = str(tmp_path / "ck2")
    ckpt.save(state, d2, process_index=0, save_id="bbbbbbbbbbbb",
              process_count=2)
    ckpt.save(state, d2, process_index=1, save_id="cccccccccccc",
              process_count=2)
    with pytest.raises(ValueError, match="no complete save"):
        ckpt.load(d2, like)
    with pytest.raises(ValueError, match="12 lowercase hex"):
        ckpt.save(state, d2, save_id="nothex")


def test_tensor_leaves_and_missing_key(tmp_path):
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    d = str(tmp_path / "ck")
    ckpt.save({"w": np.arange(6, dtype=np.float32)}, d)
    out = ckpt.load(d, {"w": np.zeros(6, np.float32)})
    np.testing.assert_array_equal(out["w"], np.arange(6, dtype=np.float32))
    with pytest.raises(KeyError):
        ckpt.load(d, {"missing": torch.zeros(3)})
