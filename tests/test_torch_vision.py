"""CPU twins of the port's `paddle_tpu_torch.vision` against the
reference's `paddle_tpu.vision`.

  * models: the vision half of `test_models.py` (LeNet trains, ResNet-18,
    MobileNet V2 and VGG-11 forward, pretrained=True never random,
    NHWC == NCHW exactly), each on the reference's weights (carried by
    `load_reference_state`) and held to the reference's outputs (and
    LeNet's Adam losses step by step); the other depths and MobileNet V1
    forward, ResNet-18's train-mode step (gradients, an AdamW step, the
    BatchNorm buffers); pretrained files written by the reference's
    `paddle.save`;
  * datasets: the vision cases of `test_reader_datasets.py` (CIFAR-10/100
    tar.gz and the single pickle, FashionMNIST IDX, the Flowers layout,
    the shared class prototypes), every synthetic fallback bitwise the
    reference's arrays, and the folder datasets;
  * transforms: every transform and functional form on the same image
    with the same seeds of Python's `random` and numpy, bitwise the
    reference's arrays (`ToTensor` a CPU tensor of the same values);
  * `vision.ops` against the reference (box_area, box_iou, nms, roi_align,
    yolo_box_decode, yolo_box, yolo_loss).

Tolerances: model outputs rtol 1e-4, atol 1e-5 (float32 convolutions in
another order of summation); ops rtol 1e-5, atol 1e-5; indices, data and
transforms exactly.
"""
import gzip
import io
import os
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision as RV

import paddle_tpu_torch as ptt
import paddle_tpu_torch.vision as PV
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.nn.layer.layers import load_reference_state

torch.set_num_threads(1)
M_RTOL, M_ATOL = 1e-4, 1e-5
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def f32(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if torch.is_tensor(x):
        return x.detach().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def close(got, want, rtol=RTOL, atol=ATOL):
    g, w = _np(got), _np(want)
    if isinstance(g, list):
        for a, b in zip(g, w):
            close(a, b, rtol, atol)
        return
    assert g.shape == w.shape, (g.shape, w.shape)
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    else:
        np.testing.assert_array_equal(g, w)


def carry(ref, port):
    """The reference model's state (parameters and BatchNorm buffers)
    loaded into the port's."""
    assert list(port.state_dict()) == list(ref.state_dict())
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return port


def pair(name, *args, **kw):
    paddle.seed(0)
    ref = getattr(RV.models, name)(*args, **kw)
    return ref, carry(ref, getattr(PV.models, name)(*args, **kw))


def forward(ref, port, x, train=False):
    for m in (ref, port):
        m.train() if train else m.eval()
    want = ref(paddle.to_tensor(x))
    got = port(torch.from_numpy(x))
    return got, want


# ---- models (test_models.py, TestVisionModels and TestResNetNHWC) ------------

def test_lenet_forward_and_train():
    import paddle_tpu.nn as rnn
    import paddle_tpu.optimizer as ropt

    ref, port = pair("LeNet")
    x = f32(4, 1, 28, 28)
    got, want = forward(ref, port, x, train=True)
    assert list(got.shape) == [4, 10]
    close(got, want, M_RTOL, M_ATOL)
    labels = np.array([1, 2, 3, 4])
    r_ce, p_ce = rnn.CrossEntropyLoss(), ptt.nn.CrossEntropyLoss()
    r_opt = ropt.Adam(1e-3, parameters=ref.parameters())
    p_opt = ptt.optimizer.Adam(1e-3, parameters=port.parameters())
    losses = []
    for _ in range(8):
        rl = r_ce(ref(paddle.to_tensor(x)), paddle.to_tensor(labels))
        pl = p_ce(port(torch.from_numpy(x)), torch.from_numpy(labels))
        for loss, opt in ((rl, r_opt), (pl, p_opt)):
            loss.backward()
            opt.step()
            opt.clear_grad()
        losses.append((pl.item(), float(rl.numpy())))
    np.testing.assert_allclose(*zip(*losses), rtol=M_RTOL)
    assert losses[-1][0] < losses[0][0]


@pytest.mark.parametrize("name,kw,shape", [
    ("resnet18", dict(num_classes=10), (1, 3, 64, 64)),
    ("mobilenet_v2", dict(num_classes=7), (1, 3, 32, 32)),
    ("vgg11", dict(num_classes=5), (1, 3, 224, 224)),
    ("resnet34", dict(num_classes=3), (1, 3, 32, 32)),
    ("mobilenet_v1", dict(num_classes=4, scale=0.5), (1, 3, 32, 32)),
    ("vgg13", dict(num_classes=2, batch_norm=True), (1, 3, 32, 32)),
], ids=["resnet18", "mobilenet_v2", "vgg11", "resnet34",
        "mobilenet_v1_x0.5", "vgg13_bn"])
def test_forward_matches_reference(name, kw, shape):
    ref, port = pair(name, **kw)
    got, want = forward(ref, port, f32(*shape))
    assert list(got.shape) == [1, kw["num_classes"]]
    close(got, want, M_RTOL, M_ATOL)


def test_resnet18_train_step_matches_reference():
    """One train-mode forward, backward and AdamW step (lr 1e-4, wd 0.01)
    of ResNet-18 at B 8, 32 x 32: the loss, every gradient (within 1e-3 of
    its leaf's largest magnitude, phase 4c's limit), every parameter after
    the step (within 2 · lr, 4c's limit: Adam's first step moves a leaf by
    about lr, whatever its gradient's size) and the BatchNorm running
    statistics. (At a batch whose last
    BatchNorm sees a handful of values a channel, float32 rounding moves
    some gradients by tens of percent in either package against float64:
    such a step is not a comparison.)"""
    import paddle_tpu.nn.functional as RF
    import paddle_tpu.optimizer as ropt
    ref, port = pair("resnet18", num_classes=10)
    x = f32(8, 3, 32, 32)
    y = np.arange(8) % 10
    got, want = forward(ref, port, x, train=True)
    r_loss = RF.cross_entropy(want, paddle.to_tensor(y))
    p_loss = torch.nn.functional.cross_entropy(got, torch.from_numpy(y))
    np.testing.assert_allclose(float(p_loss), float(r_loss.numpy()),
                               rtol=M_RTOL)
    r_opt = ropt.AdamW(1e-4, parameters=ref.parameters(), weight_decay=0.01)
    p_opt = ptt.optimizer.AdamW(1e-4, parameters=port.parameters(),
                                weight_decay=0.01)
    r_loss.backward()
    p_loss.backward()
    r_grads = {n: np.asarray(p.grad.numpy())
               for n, p in ref.named_parameters()}
    for n, p in port.named_parameters():
        g, w = p.grad.numpy(), r_grads[n]
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), n
    r_opt.step()
    p_opt.step()
    rs = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    for k, v in port.state_dict().items():
        if k.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(v.numpy(), rs[k], rtol=M_RTOL,
                                       atol=M_ATOL, err_msg=k)
        else:  # phase 4c's parameter limit: 2 * lr * steps
            assert np.abs(v.detach().numpy() - rs[k]).max() <= 2e-4, k


def test_pretrained_true_is_honest(tmp_path, monkeypatch):
    from paddle_tpu_torch.vision import models as M
    monkeypatch.setenv("PADDLE_TPU_PRETRAINED_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="PADDLE_TPU_PRETRAINED_DIR"):
        M.resnet18(pretrained=True)
    src = M.resnet18(num_classes=4)
    ptt.save(src.state_dict(), str(tmp_path / "resnet18.pdparams"))
    dst = M.resnet18(pretrained=True, num_classes=4)
    assert torch.equal(dst.state_dict()["conv1.weight"],
                       src.state_dict()["conv1.weight"])
    with pytest.raises(FileNotFoundError):
        M.mobilenet_v2(pretrained=True)
    with pytest.raises(FileNotFoundError):
        M.vgg11(pretrained=True)


def test_pretrained_reads_the_references_file(tmp_path, monkeypatch):
    """A .pdparams the reference's paddle.save wrote loads through the
    port's paddle.load, and the model computes the reference's logits."""
    monkeypatch.setenv("PADDLE_TPU_PRETRAINED_DIR", str(tmp_path))
    paddle.seed(3)
    ref = RV.models.resnet18(num_classes=6)
    paddle.save(ref.state_dict(), str(tmp_path / "resnet18.pdparams"))
    port = PV.models.resnet18(pretrained=True, num_classes=6)
    got, want = forward(ref, port, f32(1, 3, 32, 32, seed=2))
    close(got, want, M_RTOL, M_ATOL)


def test_nhwc_matches_nchw_exactly():
    from paddle_tpu_torch.vision.models.resnet import BasicBlock, ResNet
    ref, m1 = pair("resnet18", num_classes=10)
    m2 = carry(ref, ResNet(BasicBlock, 18, num_classes=10,
                           data_format="NHWC"))
    x = f32(2, 3, 32, 32)
    m1.eval()
    m2.eval()
    ref.eval()
    o1 = m1(torch.from_numpy(x))
    o2 = m2(torch.from_numpy(x.transpose(0, 2, 3, 1).copy()))
    np.testing.assert_array_equal(o1.detach().numpy(), o2.detach().numpy())
    close(o1, ref(paddle.to_tensor(x)), M_RTOL, M_ATOL)


# ---- vision.ops ---------------------------------------------------------------

def _boxes(n, seed, size=32.0):
    rs = np.random.RandomState(seed)
    xy = rs.rand(n, 2).astype(np.float32) * size
    wh = rs.rand(n, 2).astype(np.float32) * size / 2 + 1
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _ops(name, *args, **kw):
    def conv(a, to):
        return to(a) if isinstance(a, np.ndarray) else a
    want = getattr(RV.ops, name)(*[conv(a, paddle.to_tensor) for a in args],
                                 **{k: conv(v, paddle.to_tensor)
                                    for k, v in kw.items()})
    got = getattr(PV.ops, name)(*[conv(a, torch.from_numpy) for a in args],
                                **{k: conv(v, torch.from_numpy)
                                   for k, v in kw.items()})
    return got, want


@pytest.mark.parametrize("name,args,kw", [
    ("box_area", lambda: (_boxes(5, 0),), {}),
    ("box_iou", lambda: (_boxes(5, 0), _boxes(4, 1)), {}),
    ("nms", lambda: (_boxes(12, 2, 16), np.random.RandomState(3).rand(12)
                     .astype(np.float32)), dict(iou_threshold=0.3)),
    ("nms", lambda: (_boxes(12, 2, 16), np.random.RandomState(3).rand(12)
                     .astype(np.float32)),
     dict(iou_threshold=0.1, top_k=5)),
    ("nms", lambda: (_boxes(8, 4, 8),), dict(iou_threshold=0.5)),
    ("nms", lambda: (np.repeat(_boxes(3, 5), 2, axis=0),
                     np.array([0.5, 0.5, 0.9, 0.9, 0.1, 0.1],
                              np.float32)), dict(iou_threshold=0.5)),
    ("roi_align", lambda: (f32(2, 3, 8, 9), _boxes(5, 6, 7)),
     dict(boxes_num=np.array([2, 3]), output_size=3, spatial_scale=1.0)),
    ("roi_align", lambda: (f32(1, 2, 8, 8), _boxes(3, 7, 14)),
     dict(output_size=(2, 3), spatial_scale=0.5, aligned=False)),
    ("yolo_box_decode", lambda: (f32(2, 2 * 8, 3, 4),
                                 [10, 13, 16, 30]),
     dict(downsample_ratio=16, class_num=3)),
    ("yolo_box", lambda: (f32(1, 2 * 7, 4, 4),
                          np.array([[64, 80]], np.int32), [10, 13, 16, 30],
                          2), dict(conf_thresh=0.3)),
    ("yolo_loss", lambda: (np.random.RandomState(0).randn(2, 3 * 7, 4, 4)
                           .astype(np.float32),
                           np.array([[[0.5, 0.5, 0.3, 0.4],
                                      [0.2, 0.7, 0.1, 0.1]],
                                     [[0.8, 0.1, 0.2, 0.3],
                                      [0, 0, 0, 0]]], np.float32),
                           np.array([[1, 0], [1, 0]]),
                           [10, 13, 16, 30, 33, 23], [0, 1, 2], 2),
     dict(use_label_smooth=False)),
], ids=["box_area", "box_iou", "nms", "nms_top_k", "nms_no_scores",
        "nms_ties", "roi_align_batched", "roi_align_unaligned",
        "yolo_box_decode", "yolo_box", "yolo_loss"])
def test_vision_op_against_reference(name, args, kw):
    got, want = _ops(name, *args(), **kw)
    close(got, want, RTOL, 1e-4 if name == "yolo_loss" else ATOL)


def test_nms_indices_are_padded_and_ordered():
    b = np.array([[0, 0, 10, 10], [1, 1, 10, 10], [20, 20, 30, 30]],
                 np.float32)
    s = np.array([0.5, 0.9, 0.7], np.float32)
    out = PV.ops.nms(torch.from_numpy(b), torch.from_numpy(s), 0.5)
    assert out.dtype == torch.int32
    assert out.tolist() == [1, 2, -1]


# ---- datasets (test_reader_datasets.py) --------------------------------------

def _write_cifar10_targz(path, n_per_batch=6, n_batches=2):
    rng = np.random.RandomState(0)
    with tarfile.open(path, "w:gz") as tf:
        def add(name, labels_key):
            data = rng.randint(0, 256, (n_per_batch, 3072), np.uint8)
            labels = rng.randint(0, 10, n_per_batch).tolist()
            blob = pickle.dumps({b"data": data, labels_key: labels})
            info = tarfile.TarInfo("cifar-10-batches-py/" + name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))

        for i in range(1, n_batches + 1):
            add(f"data_batch_{i}", b"labels")
        add("test_batch", b"labels")
    return n_per_batch, n_batches


def _write_cifar100_targz(path, n=8):
    rng = np.random.RandomState(1)
    with tarfile.open(path, "w:gz") as tf:
        for name in ("train", "test"):
            data = rng.randint(0, 256, (n, 3072), np.uint8)
            fine = rng.randint(0, 100, n).tolist()
            blob = pickle.dumps({b"data": data, b"fine_labels": fine})
            info = tarfile.TarInfo("cifar-100-python/" + name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    return n


def _write_idx_pair(img_path, lbl_path, n=10):
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (n, 28, 28), np.uint8)
    labels = rng.randint(0, 10, n, dtype=np.uint8)
    with gzip.open(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(imgs.tobytes())
    with gzip.open(lbl_path, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())
    return imgs, labels


def _same_items(port_ds, ref_ds, idx=(0, 1, -1)):
    assert len(port_ds) == len(ref_ds)
    for i in idx:
        for a, b in zip(port_ds[i], ref_ds[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cifar10_targz_multibatch(tmp_path):
    p = str(tmp_path / "cifar-10-python.tar.gz")
    n_per, n_b = _write_cifar10_targz(p)
    train = PV.datasets.Cifar10(data_file=p, mode="train")
    assert len(train) == n_per * n_b
    test = PV.datasets.Cifar10(data_file=p, mode="test")
    assert len(test) == n_per
    img, label = train[0]
    assert img.shape == (3, 32, 32) and 0 <= int(label) < 10
    _same_items(train, RV.datasets.Cifar10(data_file=p, mode="train"))
    _same_items(test, RV.datasets.Cifar10(data_file=p, mode="test"))


def test_cifar100_targz(tmp_path):
    p = str(tmp_path / "cifar-100-python.tar.gz")
    n = _write_cifar100_targz(p)
    train = PV.datasets.Cifar100(data_file=p, mode="train")
    test = PV.datasets.Cifar100(data_file=p, mode="test")
    assert len(train) == n and len(test) == n
    assert train.num_classes == 100
    assert 0 <= int(train[1][1]) < 100
    _same_items(train, RV.datasets.Cifar100(data_file=p, mode="train"))


def test_cifar10_legacy_single_pickle(tmp_path):
    rng = np.random.RandomState(3)
    p = str(tmp_path / "batch.pkl")
    with open(p, "wb") as f:
        pickle.dump({b"data": rng.randint(0, 256, (4, 3072), np.uint8),
                     b"labels": [0, 1, 2, 3]}, f)
    ds = PV.datasets.Cifar10(data_file=p)
    assert len(ds) == 4
    _same_items(ds, RV.datasets.Cifar10(data_file=p))


def test_fashion_mnist_real_idx_files(tmp_path):
    ip = str(tmp_path / "train-images-idx3-ubyte.gz")
    lp = str(tmp_path / "train-labels-idx1-ubyte.gz")
    imgs, labels = _write_idx_pair(ip, lp)
    ds = PV.datasets.FashionMNIST(image_path=ip, label_path=lp, mode="train")
    assert len(ds) == len(imgs)
    np.testing.assert_array_equal(ds.images, imgs)
    np.testing.assert_array_equal(ds.labels, labels.astype(np.int64))
    _same_items(ds, RV.datasets.FashionMNIST(image_path=ip, label_path=lp))


def test_flowers_published_layout(tmp_path):
    from PIL import Image
    import scipy.io

    rng = np.random.RandomState(0)
    tgz = str(tmp_path / "102flowers.tgz")
    with tarfile.open(tgz, "w:gz") as tf:
        for i in range(1, 7):
            arr = (rng.rand(12, 10, 3) * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG")
            info = tarfile.TarInfo(f"jpg/image_{i:05d}.jpg")
            info.size = buf.getbuffer().nbytes
            buf.seek(0)
            tf.addfile(info, buf)
    lab = str(tmp_path / "imagelabels.mat")
    scipy.io.savemat(lab, {"labels": np.arange(1, 7)[None, :]})
    sid = str(tmp_path / "setid.mat")
    scipy.io.savemat(sid, {"trnid": np.asarray([[1, 2, 3, 4]]),
                           "valid": np.asarray([[5]]),
                           "tstid": np.asarray([[6]])})
    kw = dict(data_file=tgz, label_file=lab, setid_file=sid)
    test = PV.datasets.Flowers(mode="test", **kw)
    assert len(test) == 4
    img, label = test[1]
    assert img.shape[0] == 3 and int(label) == 2
    train = PV.datasets.Flowers(mode="train", **kw)
    assert len(train) == 1 and int(train[0][1][0]) == 6
    with pytest.raises(ValueError, match="missing"):
        PV.datasets.Flowers(data_file=tgz, label_file=lab,
                            setid_file=str(tmp_path / "nope.mat"))
    clone = pickle.loads(pickle.dumps(test))
    np.testing.assert_array_equal(np.asarray(clone[1][0]), np.asarray(img))
    _same_items(test, RV.datasets.Flowers(mode="test", **kw))


def test_fashion_mnist_synthetic_differs_from_mnist():
    f = PV.datasets.FashionMNIST(mode="test")
    m = PV.datasets.MNIST(mode="test")
    assert not np.array_equal(f.images, m.images)
    assert len(f) == len(m)


@pytest.mark.parametrize("name,mode", [
    ("MNIST", "train"), ("MNIST", "test"), ("FashionMNIST", "test"),
    ("Cifar10", "train"), ("Cifar10", "test"), ("Cifar100", "test"),
    ("Flowers", "train"), ("Flowers", "test"), ("VOC2012", "train")])
def test_synthetic_fallback_is_the_references(name, mode):
    p = getattr(PV.datasets, name)(mode=mode)
    r = getattr(RV.datasets, name)(mode=mode)
    for attr in ("images", "labels", "masks", "indexes"):
        if hasattr(r, attr):
            np.testing.assert_array_equal(getattr(p, attr), getattr(r, attr))
    _same_items(p, r)


def test_train_test_share_class_prototypes():
    tr = PV.datasets.MNIST(mode="train")
    te = PV.datasets.MNIST(mode="test")
    acc = {}
    for i in range(600):
        img, lab = tr[i]
        acc.setdefault(int(np.ravel(lab)[0]), []).append(np.asarray(img))
    prot = np.stack([np.mean(acc[c], 0) for c in range(10)])
    n = 200
    correct = sum(int(((prot - np.asarray(te[i][0])) ** 2).sum(
        axis=(1, 2, 3)).argmin()) == int(np.ravel(te[i][1])[0])
        for i in range(n))
    assert correct / n > 0.9, correct / n


def test_cifar_prototypes_shared():
    tr = PV.datasets.Cifar10(mode="train")
    te = PV.datasets.Cifar10(mode="test")
    prot = {}
    for i in range(500):
        img, lab = tr[i]
        prot.setdefault(int(np.ravel(lab)[0]), []).append(np.asarray(img))
    prot = {c: np.mean(v, 0) for c, v in prot.items()}
    n = 100
    correct = 0
    for i in range(n):
        img, lab = te[i]
        d = {c: ((p - np.asarray(img)) ** 2).sum() for c, p in prot.items()}
        correct += min(d, key=d.get) == int(np.ravel(lab)[0])
    assert correct / n > 0.9, correct / n


def test_folder_datasets(tmp_path):
    rs = np.random.RandomState(0)
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / cls)
        for i in range(3):
            np.save(tmp_path / cls / f"{i}.npy",
                    rs.randint(0, 256, (5, 4, 3)).astype(np.uint8))
    for ds_name in ("DatasetFolder", "ImageFolder"):
        p = getattr(PV.datasets, ds_name)(str(tmp_path))
        r = getattr(RV.datasets, ds_name)(str(tmp_path))
        assert len(p) == len(r) == 6
        _same_items(p, r, idx=range(6))
    assert PV.datasets.DatasetFolder(str(tmp_path)).class_to_idx == \
        {"cat": 0, "dog": 1}


# ---- transforms ----------------------------------------------------------------

def _img(seed=0, shape=(12, 10, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


TRANSFORMS = [
    ("ToTensor", (), {}),
    ("ToTensor", (), dict(data_format="HWC")),
    ("Normalize", (), dict(mean=[100.0, 120.0, 90.0], std=[50.0, 60.0, 70.0],
                           data_format="HWC")),
    ("Resize", ((7, 9),), {}),
    ("Resize", (6,), dict(interpolation="nearest")),
    ("CenterCrop", (6,), {}),
    ("RandomCrop", (8,), dict(padding=2)),
    ("RandomCrop", ((14, 12),), dict(pad_if_needed=True)),
    ("RandomHorizontalFlip", (), dict(prob=0.5)),
    ("RandomVerticalFlip", (), dict(prob=0.5)),
    ("Transpose", (), {}),
    ("BrightnessTransform", (0.4,), {}),
    ("ContrastTransform", (0.4,), {}),
    ("SaturationTransform", (0.4,), {}),
    ("HueTransform", (0.2,), {}),
    ("ColorJitter", (), dict(brightness=0.3, contrast=0.3, saturation=0.3,
                             hue=0.1)),
    ("Grayscale", (), dict(num_output_channels=3)),
    ("Pad", (2,), dict(fill=7)),
    ("Pad", ((1, 2),), dict(padding_mode="reflect")),
    ("RandomRotation", (30,), {}),
    ("RandomResizedCrop", (8,), {}),
]


@pytest.mark.parametrize("name,args,kw", TRANSFORMS,
                         ids=[f"{t[0]}-{i}" for i, t in
                              enumerate(TRANSFORMS)])
def test_transform_bitwise_the_references(name, args, kw):
    img = _img()
    out = []
    for mod in (PV.transforms, RV.transforms):
        random.seed(7)
        np.random.seed(7)
        t = getattr(mod, name)(*args, **kw)
        out.append([np.asarray(t(img.copy())) for _ in range(4)])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_to_tensor_is_a_cpu_tensor():
    t = PV.transforms.ToTensor()(_img())
    assert torch.is_tensor(t) and t.device.type == "cpu"
    assert t.dtype == torch.float32 and tuple(t.shape) == (3, 12, 10)
    np.testing.assert_array_equal(
        t.numpy(), RV.transforms.ToTensor()(_img()))


@pytest.mark.parametrize("name,args", [
    ("to_tensor", ()), ("normalize", ([1.0, 2.0, 3.0], [2.0, 2.0, 2.0],
                                      "HWC")),
    ("resize", ((5, 7),)), ("hflip", ()), ("vflip", ()),
    ("crop", (2, 3, 5, 4)), ("center_crop", (5,)), ("pad", ((1, 2, 3, 4),)),
    ("rotate", (45,)), ("to_grayscale", ()), ("adjust_brightness", (1.5,)),
    ("adjust_contrast", (0.5,)), ("adjust_hue", (0.1,))])
def test_functional_transform_bitwise(name, args):
    a = getattr(PV.transforms, name)(_img(), *args)
    b = getattr(RV.transforms, name)(_img(), *args)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_compose_pipeline_and_dataset_transform():
    """Cifar10's synthetic data through Compose([Normalize, Transpose]),
    the pipeline of chip_smoke's phase 4v (c): bitwise the reference's."""
    mk = lambda T: T.Compose([T.Normalize(mean=[125.3, 123.0, 113.9],  # noqa: E731
                                          std=[63.0, 62.1, 66.7],
                                          data_format="HWC"),
                              T.Transpose()])
    p = PV.datasets.Cifar10(mode="test", transform=mk(PV.transforms))
    r = RV.datasets.Cifar10(mode="test", transform=mk(RV.transforms))
    _same_items(p, r, idx=range(5))


# ---- the namespace ---------------------------------------------------------------

def test_top_level_names_and_image_helpers(tmp_path):
    names = {n for n in dir(RV) if not n.startswith("_")}
    missing = sorted(n for n in names if not hasattr(PV, n))
    assert not missing, missing
    PV.set_image_backend("cv2")
    with pytest.raises(ValueError):
        PV.set_image_backend("bogus")
    assert PV.get_image_backend() == RV.get_image_backend()
    np.save(tmp_path / "a.npy", _img())
    np.testing.assert_array_equal(PV.image_load(str(tmp_path / "a.npy")),
                                  _img())
    from PIL import Image
    Image.fromarray(_img()).save(tmp_path / "a.png")
    np.testing.assert_array_equal(PV.image_load(str(tmp_path / "a.png")),
                                  RV.image_load(str(tmp_path / "a.png")))
    assert ptt.vision is PV
