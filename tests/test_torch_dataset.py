"""CPU twins of the port's file datasets and data generators
(`paddle_tpu_torch.distributed.dataset`, `distributed.fleet.
data_generator`) against the JAX package's — the cases of
`test_static_nn_extra.py::TestPSDatasets` and the dataset cases of
`test_fluid_toplevel.py` (a MultiSlot file streamed by a QueueDataset, a
generator attached to an InMemoryDataset).

Both packages read the same files; every batch is compared array for
array (the same numpy values and dtypes), with the reference test's
assertions on the port's. The in-memory shuffle draws from Python's
`random`, seeded alike before each side's shuffle.
"""
import random

import numpy as np
import pytest


def _write_files(tmp_path, n_files=2, lines_per=5):
    paths = []
    rng = np.random.RandomState(0)
    for i in range(n_files):
        p = tmp_path / f"part-{i}.txt"
        with open(p, "w") as f:
            for _ in range(lines_per):
                f.write(" ".join(str(rng.randint(0, 9))
                                 for _ in range(4)) + "\n")
        paths.append(str(p))
    return paths


def _pair(kind):
    import paddle_tpu.distributed as rdist
    import paddle_tpu_torch.distributed as pdist
    return getattr(rdist, kind)(), getattr(pdist, kind)()


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k])


def test_in_memory_dataset(tmp_path):
    files = _write_files(tmp_path)
    out = []
    for ds in _pair("InMemoryDataset"):
        ds.init(batch_size=4, use_var=[])
        ds.set_filelist(files)
        ds.load_into_memory()
        assert ds.get_memory_data_size() == 10
        random.seed(3)
        ds.local_shuffle()
        batches = list(ds)
        assert len(batches) == 3  # 4 + 4 + 2
        assert batches[0]["slot_0"].shape == (4, 4)
        out.append(batches)
        ds.release_memory()
        assert ds.get_memory_data_size() == 0
    _same(*out)


def test_queue_dataset_streams_and_rejects_shuffle(tmp_path):
    files = _write_files(tmp_path)
    out = []
    for ds in _pair("QueueDataset"):
        ds.init(batch_size=3)
        ds.set_filelist(files)
        batches = list(ds)
        assert sum(b["slot_0"].shape[0] for b in batches) == 10
        with pytest.raises(NotImplementedError):
            ds.local_shuffle()
        with pytest.raises(NotImplementedError):
            ds.global_shuffle()
        out.append(batches)
    _same(*out)


def _gens():
    from paddle_tpu.distributed import fleet as rfleet
    from paddle_tpu_torch.distributed import fleet as pfleet
    out = []
    for fl in (rfleet, pfleet):
        class G(fl.MultiSlotDataGenerator):
            def generate_sample(self, line):
                def gen():
                    toks = line.split()
                    yield ("ids", [int(t) for t in toks[:2]])
                    yield ("label", [float(toks[2])])
                return gen

        class S(fl.MultiSlotStringDataGenerator):
            def generate_sample(self, line):
                def gen():
                    yield ("words", line.split())
                return gen

        class Bad(fl.MultiSlotDataGenerator):
            def generate_sample(self, line):
                return iter([("w", ["x"])])

        out.append((G, S, Bad))
    return out


def test_multislot_data_generator(tmp_path, capsys, monkeypatch):
    import io
    p = tmp_path / "f.txt"
    p.write_text("1 2 0\n3 4 1\n")
    seen = []
    for G, S, Bad in _gens():
        g = G()
        samples = g.run_from_memory(["1 2 0", "3 4 1"])
        assert samples[0][0] == ("ids", [1, 2])
        assert samples[1][1] == ("label", [1.0])
        assert g._to_protocol(samples[0]) == "2 2 1 2 1 0.0\n"
        assert S().run_from_memory(["a b c"])[0][0] == ("words",
                                                        ["a", "b", "c"])
        with pytest.raises(ValueError, match="numeric"):
            Bad().run_from_memory(["x"])
        monkeypatch.setattr("sys.stdin", io.StringIO("5 6 1\n\n7 8 0\n"))
        g.run_from_stdin()
        seen.append((samples, capsys.readouterr().out))
    assert seen[0] == seen[1]
    assert seen[1][1] == "2 2 5 6 1 1.0\n2 2 7 8 1 0.0\n"
    out = []
    for (G, _, _), ds in zip(_gens(), _pair("InMemoryDataset")):
        ds.init(batch_size=2)
        ds.set_filelist([str(p)])
        ds.set_data_generator(G())
        ds.load_into_memory()
        (b,) = list(ds)
        np.testing.assert_array_equal(b["ids"], [[1, 2], [3, 4]])
        np.testing.assert_array_equal(b["label"], [[0.0], [1.0]])
        out.append([b])
    _same(*out)


def test_dataset_generator_coercion_applies(tmp_path):
    p = tmp_path / "s.txt"
    p.write_text("1 2\n")
    out = []
    for (_, S, _), ds in zip(_gens(), _pair("InMemoryDataset")):
        class Ints(S):
            def generate_sample(self, line):
                def gen():
                    yield ("words", [int(t) for t in line.split()])
                return gen

        ds.init(batch_size=1)
        ds.set_filelist([str(p)])
        ds.set_data_generator(Ints())
        ds.load_into_memory()
        (b,) = list(ds)
        assert b["words"].dtype.kind in ("U", "S")
        out.append([b])
    _same(*out)


def test_queue_dataset_streams_multislot_file(tmp_path):
    """The fluid case: MultiSlot lines written in the slot protocol by a
    generator, read back as whitespace floats by a QueueDataset (16 rows
    a batch), and a generator attached to an InMemoryDataset."""
    from paddle_tpu_torch.distributed.fleet import MultiSlotDataGenerator

    class Gen(MultiSlotDataGenerator):
        def generate_sample(self, line):
            def reader():
                rs = np.random.RandomState(0)
                for _ in range(32):
                    x = rs.rand(4)
                    yield [("x", [float(v) for v in x]),
                           ("y", [int(x.sum() > 2.0)])]
            return reader

    g = Gen()
    lines = [g._to_protocol(s) for s in g.generate_sample(None)()]
    path = tmp_path / "part-000"
    path.write_text("".join(lines))
    out = []
    for ds in _pair("QueueDataset"):
        ds.set_batch_size(16)
        ds.set_filelist([str(path)])
        batches = list(ds)
        assert len(batches) == 2 and batches[0]["slot_0"].shape == (16, 8)
        out.append(batches)
    _same(*out)
    csv = tmp_path / "raw.csv"
    csv.write_text("1,0.5\n2,1.5\n3,2.5\n")
    out = []
    for (G, _, _), ds in zip(_gens(), _pair("InMemoryDataset")):
        class C(G):
            def generate_sample(self, line):
                def gen():
                    toks = line.split(",")
                    yield ("a", [int(toks[0])])
                    yield ("b", [float(toks[1])])
                return gen

        ds.set_batch_size(2)
        ds.set_filelist([str(csv)])
        ds.set_data_generator(C())
        ds.load_into_memory()
        batches = list(ds)
        assert len(batches) == 2
        np.testing.assert_array_equal(batches[0]["a"], [[1], [2]])
        np.testing.assert_array_equal(batches[1]["b"], [[2.5]])
        out.append(batches)
    _same(*out)
