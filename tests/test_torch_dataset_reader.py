"""CPU twins of the port's 1.x data pipeline — `paddle_tpu_torch.reader`,
`paddle_tpu_torch.dataset`, `paddle_tpu_torch.text` — and
`incubate.complex` against the reference's:

  * `tests/test_dataset_pkg.py`'s `TestDatasetLoaders` (12 cases) and
    `TestIncubateComplex` (2), run on the port;
  * `tests/test_reader_datasets.py`'s `TestReaderDecorators` (10) and its
    text cases (the aclImdb layout, housing.data); its vision cases and
    `TestSyntheticFallbackGeneralization` have their twins in
    `test_torch_vision.py`;
  * every synthetic fallback bitwise the reference's: each 1.x loader's
    samples and each `text` dataset's items, the same `RandomState`
    draws in the same order; the shuffling decorators give the
    reference's order under the same `random.seed`;
  * `text.viterbi_decode` against the reference's scans (paths equal,
    scores within 1e-5, ties to the first maximum).
"""
import io
import random
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.dataset as RD
import paddle_tpu.reader as RR
import paddle_tpu.text as RTX

import paddle_tpu_torch as ptt
import paddle_tpu_torch.dataset as PD
import paddle_tpu_torch.reader as reader_mod
import paddle_tpu_torch.text as PTX
from paddle_tpu_torch import device as pdevice

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def same(a, b, path="sample"):
    """Bitwise equality of nested samples (tuples, lists, arrays,
    numbers), dtypes included."""
    if isinstance(b, (list, tuple)):
        assert isinstance(a, type(b)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray) or np.isscalar(b) and not isinstance(
            b, (int, float, str)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _counting_reader(n):
    def r():
        return iter(range(n))
    return r


# ---- the 1.x loaders --------------------------------------------------------

LOADERS = {
    "uci_housing.train": lambda D: D.uci_housing.train(),
    "uci_housing.test": lambda D: D.uci_housing.test(),
    "mnist.test": lambda D: D.mnist.test(),
    "cifar.test10": lambda D: D.cifar.test10(),
    "cifar.test100": lambda D: D.cifar.test100(),
    "imdb.train": lambda D: D.imdb.train(D.imdb.word_dict()),
    "imdb.test": lambda D: D.imdb.test(D.imdb.word_dict()),
    "imikolov.train ngram": lambda D: D.imikolov.train(
        D.imikolov.build_dict(), 5),
    "imikolov.test seq": lambda D: D.imikolov.test(
        D.imikolov.build_dict(), 5, D.imikolov.DataType.SEQ),
    "movielens.train": lambda D: D.movielens.train(),
    "movielens.test": lambda D: D.movielens.test(),
    "conll05.test": lambda D: D.conll05.test(),
    "flowers.train": lambda D: D.flowers.train(),
    "flowers.valid": lambda D: D.flowers.valid(),
    "voc2012.val": lambda D: D.voc2012.val(),
    "wmt14.train": lambda D: D.wmt14.train(30),
    "wmt16.validation": lambda D: D.wmt16.validation(30, 20),
}


@pytest.mark.parametrize("name", list(LOADERS))
def test_loader_samples_bitwise_the_references(name):
    got = list(LOADERS[name](PD)())
    want = list(LOADERS[name](RD)())
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        same(a, b, f"{name}[{i}]")


def test_loader_dicts_and_tables_are_the_references():
    assert PD.imdb.word_dict() == RD.imdb.word_dict()
    assert PD.imikolov.build_dict(2) == RD.imikolov.build_dict(2)
    assert PD.conll05.get_dict() == RD.conll05.get_dict()
    same(PD.conll05.get_embedding(), RD.conll05.get_embedding())
    assert PD.wmt14.get_dict(30, reverse=True) == \
        RD.wmt14.get_dict(30, reverse=True)
    assert PD.wmt16.get_dict("en", 20) == RD.wmt16.get_dict("en", 20)
    assert PD.movielens.get_movie_title_dict() == \
        RD.movielens.get_movie_title_dict()
    assert [repr(u) for u in PD.movielens.user_info().values()] == \
        [repr(u) for u in RD.movielens.user_info().values()]


class TestDatasetLoaders:
    def test_uci_housing(self):
        from paddle_tpu_torch.dataset import uci_housing
        assert len(uci_housing.feature_names) == 13
        samples = list(uci_housing.train()())
        assert len(samples) == 404
        x, y = samples[0]
        assert x.shape == (13,) and y.shape == (1,)
        assert len(list(uci_housing.test()())) == 102

    def test_mnist_reader_contract(self):
        from paddle_tpu_torch.dataset import mnist
        img, label = next(mnist.train()())
        assert img.shape == (784,)
        assert -1.0 <= float(img.min()) and float(img.max()) <= 1.0
        assert 0 <= label < 10
        same((img, label), next(RD.mnist.train()()))

    def test_cifar_readers(self):
        from paddle_tpu_torch.dataset import cifar
        img, label = next(cifar.train10()())
        assert img.shape == (3072,) and 0 <= label < 10
        same((img, label), next(RD.cifar.train10()()))
        img, label = next(cifar.test100()())
        assert 0 <= label < 100

    def test_imdb_dict_and_readers(self):
        from paddle_tpu_torch.dataset import imdb
        d = imdb.word_dict()
        assert "<unk>" in d
        samples = list(imdb.train(d)())
        assert {s[1] for s in samples} == {0, 1}
        ids, label = samples[0]
        assert all(0 <= i < len(d) for i in ids)

    def test_imikolov_ngrams_and_seq(self):
        from paddle_tpu_torch.dataset import imikolov
        d = imikolov.build_dict()
        gram = next(imikolov.train(d, 5)())
        assert len(gram) == 5
        src, trg = next(imikolov.train(d, 5, imikolov.DataType.SEQ)())
        assert src[1:] == trg[:-1]

    def test_movielens(self):
        from paddle_tpu_torch.dataset import movielens
        s = next(movielens.train()())
        assert len(s) == 8
        assert movielens.max_movie_id() == 200
        assert movielens.max_user_id() == 120
        assert len(movielens.movie_categories()) == 18
        assert "Movie 1" in repr(movielens.movie_info()[1])

    def test_conll05(self):
        from paddle_tpu_torch.dataset import conll05
        wd, vd, ld = conll05.get_dict()
        assert conll05.get_embedding().shape == (len(wd), 32)
        sample = next(conll05.test()())
        assert len(sample) == 9
        n = len(sample[0])
        assert all(len(col) == n for col in sample)

    def test_flowers_voc(self):
        from paddle_tpu_torch.dataset import flowers, voc2012
        img, label = next(flowers.train()())
        assert img.shape == (3 * 32 * 32,) and 0 <= label < 102
        img, mask = next(voc2012.train()())
        assert img.shape[0] == 3 and mask.shape == img.shape[1:]

    def test_wmt(self):
        from paddle_tpu_torch.dataset import wmt14, wmt16
        src, trg_in, trg_out = next(wmt14.train(30)())
        assert trg_in[0] == 0 and trg_out[-1] == 1
        assert trg_in[1:] == trg_out[:-1]
        d = wmt14.get_dict(30)[0]
        assert d["<s>"] == 0 and d["<e>"] == 1 and d["<unk>"] == 2
        src, trg_in, trg_out = next(wmt16.train(30, 30)())
        assert trg_in[1:] == trg_out[:-1]

    def test_dataset_composes_with_reader_decorators(self):
        from paddle_tpu_torch.dataset import uci_housing
        r = reader_mod.buffered(
            reader_mod.shuffle(uci_housing.train(), 64), 16)
        random.seed(3)
        got = list(r())
        random.seed(3)
        want = list(RR.buffered(RR.shuffle(RD.uci_housing.train(), 64),
                                16)())
        assert len(got) == 404
        same(got, want)

    def test_common_split_and_cluster(self, tmp_path):
        from paddle_tpu_torch.dataset import common
        paths = common.split(_counting_reader(10), 3,
                             suffix=str(tmp_path / "p-%05d.pickle"))
        assert len(paths) == 4
        shard = common.cluster_files_reader(
            str(tmp_path / "p-*.pickle"), trainer_count=2, trainer_id=0)
        got = sorted(list(shard()) + list(common.cluster_files_reader(
            str(tmp_path / "p-*.pickle"), 2, 1)()))
        assert got == list(range(10))
        with pytest.raises(RuntimeError, match="cannot download"):
            common.download("https://host/x/absent.tgz", "nowhere", None)

    def test_image_transforms(self):
        from paddle_tpu_torch.dataset import image as dimg
        im = (np.random.RandomState(0).rand(40, 50, 3) * 255).astype(
            np.uint8)
        r = dimg.resize_short(im, 32)
        assert min(r.shape[:2]) == 32
        same(r, RD.image.resize_short(im, 32))
        c = dimg.center_crop(r, 28)
        assert c.shape[:2] == (28, 28)
        np.random.seed(1)
        chw = dimg.simple_transform(im, 36, 28, is_train=True)
        np.random.seed(1)
        same(chw, RD.image.simple_transform(im, 36, 28, is_train=True))
        assert chw.shape == (3, 28, 28) and chw.dtype == np.float32


# ---- the reader decorators --------------------------------------------------

class TestReaderDecorators:
    def test_cache(self):
        calls = []

        def r():
            calls.append(1)
            return iter([1, 2, 3])

        cached = reader_mod.cache(r)
        assert list(cached()) == [1, 2, 3]
        assert list(cached()) == [1, 2, 3]
        assert len(calls) == 1

    def test_map_readers(self):
        out = list(reader_mod.map_readers(
            lambda a, b: a + b, _counting_reader(3), _counting_reader(3))())
        assert out == [0, 2, 4]

    def test_shuffle_is_permutation(self):
        random.seed(0)
        out = list(reader_mod.shuffle(_counting_reader(100), 32)())
        assert sorted(out) == list(range(100))
        assert out != list(range(100))
        random.seed(0)
        assert out == list(RR.shuffle(_counting_reader(100), 32)())

    def test_chain(self):
        out = list(reader_mod.chain(_counting_reader(2),
                                    _counting_reader(3))())
        assert out == [0, 1, 0, 1, 2]

    def test_compose_flattens_and_checks_alignment(self):
        def pair():
            return iter([(1, 2), (3, 4)])

        out = list(reader_mod.compose(pair, _counting_reader(2))())
        assert out == [(1, 2, 0), (3, 4, 1)]
        with pytest.raises(reader_mod.ComposeNotAligned):
            list(reader_mod.compose(_counting_reader(2),
                                    _counting_reader(5))())
        out = list(reader_mod.compose(_counting_reader(2),
                                      _counting_reader(5),
                                      check_alignment=False)())
        assert len(out) == 2

    def test_buffered(self):
        out = list(reader_mod.buffered(_counting_reader(50), 8)())
        assert out == list(range(50))

    def test_firstn(self):
        assert list(reader_mod.firstn(_counting_reader(100), 7)()) == \
            list(range(7))

    def test_xmap_unordered_and_ordered(self):
        sq = lambda x: x * x  # noqa: E731
        un = list(reader_mod.xmap_readers(sq, _counting_reader(40), 4, 8)())
        assert sorted(un) == [i * i for i in range(40)]
        od = list(reader_mod.xmap_readers(sq, _counting_reader(40), 4, 8,
                                          order=True)())
        assert od == [i * i for i in range(40)]

    def test_batch(self):
        assert ptt.batch is reader_mod.batch
        out = list(ptt.batch(_counting_reader(7), 3)())
        assert out == [[0, 1, 2], [3, 4, 5], [6]]
        assert out == list(paddle.batch(_counting_reader(7), 3)())
        out = list(ptt.batch(_counting_reader(7), 3, drop_last=True)())
        assert out == [[0, 1, 2], [3, 4, 5]]
        with pytest.raises(ValueError):
            ptt.batch(_counting_reader(3), 0)

    def test_multiprocess_reader(self):
        r = reader_mod.multiprocess_reader(
            [_counting_reader(10), _counting_reader(10)], queue_size=8)
        assert sorted(r()) == sorted(list(range(10)) * 2)

    def test_decorator_module_path(self):
        from paddle_tpu_torch.reader import decorator
        assert decorator.shuffle is reader_mod.shuffle
        assert sorted(decorator.__all__) == sorted(
            __import__("paddle_tpu.reader.decorator",
                       fromlist=["x"]).__all__)


# ---- text -------------------------------------------------------------------

TEXT = {
    "Imdb train": lambda T: T.Imdb(mode="train"),
    "Imdb test": lambda T: T.Imdb(mode="test"),
    "WMT14 test": lambda T: T.WMT14(mode="test", dict_size=500),
    "WMT16 train": lambda T: T.WMT16(mode="train"),
    "Imikolov test": lambda T: T.Imikolov(mode="test"),
    "Movielens test": lambda T: T.Movielens(mode="test", rand_seed=3),
    "UCIHousing train": lambda T: T.UCIHousing(mode="train"),
    "Conll05st test": lambda T: T.Conll05st(mode="test"),
}


@pytest.mark.parametrize("name", list(TEXT))
def test_text_dataset_items_bitwise_the_references(name):
    got, want = TEXT[name](PTX), TEXT[name](RTX)
    assert isinstance(got, ptt.io.Dataset)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        same(got[i], want[i], f"{name}[{i}]")


def test_text_datasets_alias_and_module_paths():
    import importlib
    assert PTX.datasets is PTX
    for leaf in ("conll05", "imdb", "imikolov", "movielens", "uci_housing",
                 "wmt14", "wmt16"):
        m = importlib.import_module(f"paddle_tpu_torch.text.datasets.{leaf}")
        assert m is getattr(PD, leaf) and getattr(PTX.datasets, leaf) is m


def test_text_imdb_aclimdb_layout(tmp_path):
    p = str(tmp_path / "aclImdb_v1.tar.gz")
    docs = {
        "aclImdb/train/pos/0_9.txt": b"great great movie loved it",
        "aclImdb/train/pos/1_8.txt": b"great fun, great cast!",
        "aclImdb/train/neg/0_2.txt": b"terrible boring film",
        "aclImdb/test/pos/0_10.txt": b"great",
    }
    with tarfile.open(p, "w:gz") as tf:
        for name, data in docs.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    ds = PTX.Imdb(data_file=p, mode="train", cutoff=2)
    assert len(ds) == 3
    assert ds.word_idx["great"] == 0
    ref = RTX.Imdb(data_file=p, mode="train", cutoff=2)
    assert ds.word_idx == ref.word_idx
    for i in range(3):
        same(ds[i], ref[i])
    test = PTX.Imdb(data_file=p, mode="test", cutoff=0)
    assert len(test) == 1
    assert test.word_idx == PTX.Imdb(data_file=p, mode="train",
                                     cutoff=0).word_idx


def test_text_uci_housing_data_file(tmp_path):
    rng = np.random.RandomState(5)
    rows = np.hstack([rng.rand(10, 13), rng.rand(10, 1) * 50])
    p = str(tmp_path / "housing.data")
    np.savetxt(p, rows)
    tr = PTX.UCIHousing(data_file=p, mode="train")
    te = PTX.UCIHousing(data_file=p, mode="test")
    assert len(tr) == 8 and len(te) == 2
    assert tr[0][0].shape == (13,)
    ref = RTX.UCIHousing(data_file=p, mode="train")
    for i in range(8):
        same(tr[i], ref[i])


@pytest.mark.parametrize("b,t,n,integer", [(8, 64, 32, False),
                                           (4, 10, 5, True),
                                           (3, 1, 6, False)])
def test_viterbi_decode_matches_reference(b, t, n, integer):
    """Paths equal, scores within 1e-5; integer potentials make ties,
    which go to the first maximum on both sides."""
    rs = np.random.RandomState(b * t)
    pot = rs.randn(b, t, n).astype(np.float32)
    trans = rs.randn(n, n).astype(np.float32)
    if integer:
        pot, trans = np.round(pot), np.round(trans)
    scores, path = PTX.viterbi_decode(torch.from_numpy(pot),
                                      torch.from_numpy(trans))
    rscores, rpath = RTX.viterbi_decode(pot, trans)
    assert path.dtype == torch.int64 and tuple(path.shape) == (b, t)
    np.testing.assert_array_equal(path.numpy(), np.asarray(rpath.numpy()))
    np.testing.assert_allclose(scores.numpy(), np.asarray(rscores.numpy()),
                               rtol=1e-5, atol=1e-5)


# ---- incubate.complex -------------------------------------------------------

class TestIncubateComplex:
    def test_elementwise_and_matmul(self):
        cpx = ptt.incubate.complex
        an = np.asarray([[1 + 2j, 3 - 1j], [0 + 1j, 2 + 0j]], np.complex64)
        bn = np.asarray([[2 - 1j, 1 + 1j], [1 + 0j, 1 - 1j]], np.complex64)
        a, b = torch.from_numpy(an), torch.from_numpy(bn)
        np.testing.assert_allclose(cpx.elementwise_add(a, b).numpy(),
                                   an + bn)
        np.testing.assert_allclose(cpx.matmul(a, b).numpy(), an @ bn,
                                   rtol=1e-6)
        np.testing.assert_allclose(cpx.trace(a).numpy(), 3 + 2j)
        assert tuple(cpx.kron(a, b).shape) == (4, 4)
        assert tuple(cpx.reshape(a, [4]).shape) == (4,)
        np.testing.assert_allclose(cpx.transpose(a, [1, 0]).numpy(), an.T)
        np.testing.assert_allclose(cpx.sum(a, axis=0).numpy(), an.sum(0))
        np.testing.assert_allclose(cpx.elementwise_div(a, b).numpy(),
                                   an / bn, rtol=1e-6)
        rc = paddle.incubate.complex
        import jax.numpy as jnp
        from paddle_tpu.core.tensor import Tensor
        ra, rb = Tensor(jnp.asarray(an)), Tensor(jnp.asarray(bn))
        for name in ("elementwise_sub", "elementwise_mul", "kron",
                     "matmul"):
            np.testing.assert_allclose(
                getattr(cpx, name)(a, b).numpy(),
                np.asarray(getattr(rc, name)(ra, rb).numpy()), rtol=1e-6)
        # a real input is taken as complex64
        assert cpx.elementwise_add(torch.ones(2), a[0]).dtype == \
            torch.complex64

    def test_complex_grad_flows(self):
        cpx = ptt.incubate.complex
        a = torch.tensor([1 + 1j, 2 - 1j], dtype=torch.complex64,
                         requires_grad=True)
        out = cpx.sum(cpx.elementwise_mul(a, a))
        (out.real ** 2 + out.imag ** 2).backward()
        assert a.grad is not None and torch.isfinite(
            torch.view_as_real(a.grad)).all()
