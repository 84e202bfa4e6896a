"""CPU twins of the port's tensor API (`paddle_tpu_torch`: dtypes,
places and `set_device`, the seeded generators, `to_tensor`, and the op
library of `ops.creation` / `random` / `math` / `manipulation` /
`search` / `linalg`) against the JAX package's `paddle_tpu` on the same
seeded numpy inputs: every case of `tests/test_tensor_ops.py`, and one
case per semantic where torch's same-named call differs (to_tensor of
float64, split's int, gather's index select, scatter without overwrite,
pad's order, unbiased std/var, unique's outputs, ...).

Tolerances: elementwise and shape ops exact or rtol 1e-6; reductions,
cumulative ops and contractions rtol 1e-5, atol 1e-6; linalg
decompositions rtol 1e-4, atol 1e-5. Random ops cannot match JAX's bits:
they are held to their arithmetic (shape, dtype, bounds, moments within
stated tolerances) and to replay under the same seed.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import ops as rops

import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch import ops as pops

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def rt(x):
    return paddle.to_tensor(np.asarray(x))


def pt(x):
    return ptt.to_tensor(np.asarray(x))


def rnp(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def pnp(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def same(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(pnp(got), rnp(want), rtol=rtol, atol=atol)


def f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---- the cases of tests/test_tensor_ops.py -----------------------------------

class TestArithmetic:
    @pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide",
                                    "maximum", "minimum", "pow",
                                    "remainder", "floor_divide", "atan2"])
    def test_binary(self, op):
        a, b = f32(3, 4), np.abs(f32(3, 4, seed=1)) + 0.5
        same(getattr(pops, op)(pt(a), pt(b)), getattr(rops, op)(rt(a), rt(b)),
             rtol=1e-6)

    def test_broadcast_and_scalars(self):
        a, b = f32(2, 3), f32(3, seed=1)
        same(pops.multiply(pt(a), pt(b)), rops.multiply(rt(a), rt(b)))
        same(pops.add(pt(a), 1), rops.add(rt(a), 1))
        same(pops.multiply(2, pt(a)), rops.multiply(2, rt(a)))
        same(pops.divide(1, pt(b)), rops.divide(1, rt(b)))
        same(pops.subtract(1.5, pt(a)), rops.subtract(1.5, rt(a)))

    def test_matmul(self):
        a, b = f32(3, 4), f32(4, 5, seed=1)
        same(pops.matmul(pt(a), pt(b)), rops.matmul(rt(a), rt(b)),
             rtol=1e-5, atol=1e-6)
        same(pops.matmul(pt(a), pt(a), transpose_y=True),
             rops.matmul(rt(a), rt(a), transpose_y=True), rtol=1e-5,
             atol=1e-6)

    def test_comparisons(self):
        a, b = np.array([1.0, 5.0, 2.0], np.float32), \
            np.array([2.0, 2.0, 2.0], np.float32)
        for op in ("less_than", "less_equal", "greater_than",
                   "greater_equal", "equal", "not_equal"):
            same(getattr(pops, op)(pt(a), pt(b)),
                 getattr(rops, op)(rt(a), rt(b)))
        assert bool(pops.equal_all(pt(a), pt(a))) == \
            bool(rnp(rops.equal_all(rt(a), rt(a))))
        assert bool(pops.allclose(pt(a), pt(b))) == \
            bool(rnp(rops.allclose(rt(a), rt(b))))

    def test_pow_mod(self):
        a = np.array([2.0, 3.0], np.float32)
        same(pops.pow(pt(a), 2), rops.pow(rt(a), 2))
        same(pops.remainder(pt([5.0, -5.0]), pt([3.0, 3.0])),
             rops.remainder(rt(np.float32([5.0, -5.0])),
                            rt(np.float32([3.0, 3.0]))))

    @pytest.mark.parametrize("op", [
        "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
        "abs", "square", "reciprocal", "sin", "cos", "tan", "asin", "acos",
        "atan", "sinh", "cosh", "tanh", "asinh", "erf", "ceil", "floor",
        "round", "trunc", "sign", "neg", "digamma", "lgamma", "isnan",
        "isinf", "isfinite"])
    def test_unary(self, op):
        x = np.random.RandomState(3).uniform(0.1, 0.9, (3, 4)) \
            .astype(np.float32)
        same(getattr(pops, op)(pt(x)), getattr(rops, op)(rt(x)), rtol=2e-6)

    def test_clip_scale_lerp_logical(self):
        x, y = f32(3, 4), f32(3, 4, seed=2)
        same(pops.clip(pt(x), -0.5, 0.5), rops.clip(rt(x), -0.5, 0.5))
        same(pops.scale(pt(x), 2.0, 1.0, False),
             rops.scale(rt(x), 2.0, 1.0, False))
        same(pops.lerp(pt(x), pt(y), 0.3), rops.lerp(rt(x), rt(y), 0.3))
        same(pops.add_n([pt(x), pt(y), pt(x)]),
             rops.add_n([rt(x), rt(y), rt(x)]))
        m, n = x > 0, y > 0
        for op in ("logical_and", "logical_or", "logical_xor"):
            same(getattr(pops, op)(pt(m), pt(n)),
                 getattr(rops, op)(rt(m), rt(n)))
        same(pops.logical_not(pt(m)), rops.logical_not(rt(m)))


class TestReductions:
    @pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "prod",
                                    "logsumexp", "all", "any"])
    @pytest.mark.parametrize("axis", [None, 1, [0, 2], -1])
    @pytest.mark.parametrize("keepdim", [False, True])
    def test_reduce(self, op, axis, keepdim):
        x = np.random.RandomState(4).uniform(0.5, 1.5, (2, 3, 4)) \
            .astype(np.float32)
        if op in ("all", "any"):
            x = x > 1.0
        same(getattr(pops, op)(pt(x), axis=axis, keepdim=keepdim),
             getattr(rops, op)(rt(x), axis=axis, keepdim=keepdim),
             rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("unbiased", [True, False])
    def test_std_var_unbiased(self, unbiased):
        """std and var are unbiased by default (ops/math.py:318)."""
        x = f32(10)
        same(pops.std(pt(x)), rops.std(rt(x)), rtol=1e-5)
        same(pops.var(pt(x), unbiased=unbiased),
             rops.var(rt(x), unbiased=unbiased), rtol=1e-5)
        np.testing.assert_allclose(pnp(pops.std(pt(x))), x.std(ddof=1),
                                   rtol=1e-5)
        x2 = f32(3, 5, seed=1)
        same(pops.var(pt(x2), axis=1, keepdim=True),
             rops.var(rt(x2), axis=1, keepdim=True), rtol=1e-5)

    def test_cumulative_and_others(self):
        x = np.random.RandomState(5).uniform(0.5, 1.5, (3, 4)) \
            .astype(np.float32)
        same(pops.cumsum(pt(x)), rops.cumsum(rt(x)), rtol=1e-5)
        same(pops.cumsum(pt(x), axis=1), rops.cumsum(rt(x), axis=1),
             rtol=1e-5)
        same(pops.cumprod(pt(x), dim=0), rops.cumprod(rt(x), dim=0),
             rtol=1e-5)
        same(pops.cummax(pt(x), axis=1), rops.cummax(rt(x), axis=1))
        same(pops.cummin(pt(x)), rops.cummin(rt(x)))
        same(pops.trace(pt(x)), rops.trace(rt(x)), rtol=1e-6)
        same(pops.kron(pt(x[:2, :2]), pt(x[1:, 2:])),
             rops.kron(rt(x[:2, :2]), rt(x[1:, 2:])))
        same(pops.count_nonzero(pt(x > 1), axis=1, keepdim=True),
             rops.count_nonzero(rt(x > 1), axis=1, keepdim=True))

    def test_mean_of_ints_is_float(self):
        x = np.arange(6, dtype=np.int64).reshape(2, 3)
        got = pops.mean(pt(x), axis=1)
        assert got.dtype == torch.float32
        same(got, rops.mean(rt(x), axis=1))


class TestManipulation:
    def test_reshape_transpose(self):
        x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        assert list(pops.reshape(pt(x), [4, 6]).shape) == \
            rops.reshape(rt(x), [4, 6]).shape
        same(pops.transpose(pt(x), [2, 0, 1]), rops.transpose(rt(x),
                                                              [2, 0, 1]))
        same(pops.t(pt(x[0])), rops.t(rt(x[0])))
        same(pops.moveaxis(pt(x), 0, 2), rops.moveaxis(rt(x), 0, 2))

    def test_concat_split_stack(self):
        a, b = f32(2, 3), f32(2, 3, seed=1)
        same(pops.concat([pt(a), pt(b)], axis=0),
             rops.concat([rt(a), rt(b)], axis=0))
        same(pops.stack([pt(a), pt(b)], axis=1),
             rops.stack([rt(a), rt(b)], axis=1))
        x = np.arange(12, dtype=np.float32).reshape(2, 6)
        for secs in (3, [1, 2, -1], [2, 4]):
            got = pops.split(pt(x), secs, axis=1)
            want = rops.split(rt(x), secs, axis=1)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                same(g, w)

    def test_split_int_is_a_number_of_sections(self):
        """split's int counts sections, not a section size; -1 is
        inferred (ops/manipulation.py:64-79)."""
        x = np.arange(12, dtype=np.float32).reshape(2, 6)
        parts = pops.split(pt(x), 2, axis=1)
        assert [list(p.shape) for p in parts] == [[2, 3], [2, 3]]
        assert [list(p.shape) for p in torch.split(pt(x), 2, 1)] == \
            [[2, 2]] * 3  # torch's int is a size
        parts = pops.split(pt(x), [1, -1, 2], axis=1)
        assert [p.shape[1] for p in parts] == [1, 3, 2]

    def test_chunk_unstack(self):
        x = f32(7, 2)
        for g, w in zip(pops.chunk(pt(x), 3), rops.chunk(rt(x), 3)):
            same(g, w)
        for g, w in zip(pops.unstack(pt(x), axis=1),
                        rops.unstack(rt(x), axis=1)):
            same(g, w)

    def test_squeeze_unsqueeze_flatten(self):
        x = np.ones((1, 3, 1, 4), np.float32)
        for axis in (None, 0, [0, 2], [1]):
            assert list(pops.squeeze(pt(x), axis).shape) == \
                rops.squeeze(rt(x), axis).shape
        y = np.ones(3, np.float32)
        for axis in ([0, 2], [-1], 0, [0, -1]):
            assert list(pops.unsqueeze(pt(y), axis).shape) == \
                rops.unsqueeze(rt(y), axis).shape
        z = f32(2, 3, 4)
        for a, b in ((0, -1), (1, -1), (0, 1)):
            same(pops.flatten(pt(z), a, b), rops.flatten(rt(z), a, b))

    def test_gather_is_an_index_select(self):
        """gather(x, index, axis) selects rows (ops/manipulation.py:139),
        an [N, 1] index counting as [N]; torch.gather is elementwise."""
        x = np.arange(12, dtype=np.float32).reshape(4, 3)
        for idx, axis in (([0, 2], 0), ([[1], [3]], 0), ([2, 0], 1),
                          ([[0, 1], [2, 2]], 0)):
            i = np.asarray(idx)
            same(pops.gather(pt(x), pt(i), axis), rops.gather(rt(x), rt(i),
                                                              axis))
        same(pops.gather_nd(pt(x), pt(np.array([[0, 1], [3, 2]]))),
             rops.gather_nd(rt(x), rt(np.array([[0, 1], [3, 2]]))))
        same(pops.index_select(pt(x), pt(np.array([2, 0])), axis=1),
             rops.index_select(rt(x), rt(np.array([2, 0])), axis=1))
        ind = np.array([[0, 2], [1, 1], [2, 0], [0, 0]])
        same(pops.index_sample(pt(x), pt(ind)),
             rops.index_sample(rt(x), rt(ind)))
        same(pops.take_along_axis(pt(x), pt(ind), 1),
             rops.take_along_axis(rt(x), rt(ind), 1))

    @pytest.mark.parametrize("overwrite", [True, False])
    def test_scatter(self, overwrite):
        """overwrite=True sets the rows; overwrite=False adds the updates
        to x's rows, as the reference's x.at[index].add does
        (ops/manipulation.py:178)."""
        base = f32(4, 3)
        idx = np.array([0, 2])
        upd = f32(2, 3, seed=1)
        same(pops.scatter(pt(base), pt(idx), pt(upd), overwrite),
             rops.scatter(rt(base), rt(idx), rt(upd), overwrite))
        nd_idx = np.array([[0, 1], [2, 2], [0, 1]])
        nd_upd = np.float32([1.0, 2.0, 3.0])
        same(pops.scatter_nd_add(pt(base), pt(nd_idx), pt(nd_upd)),
             rops.scatter_nd_add(rt(base), rt(nd_idx), rt(nd_upd)))
        same(pops.scatter_nd(pt(nd_idx), pt(nd_upd), [3, 3]),
             rops.scatter_nd(rt(nd_idx), rt(nd_upd), [3, 3]))

    def test_put_along_axis(self):
        x = f32(3, 4)
        ind = np.array([[0], [2], [3]])
        same(pops.put_along_axis(pt(x), pt(ind), 9.0, 1),
             rops.put_along_axis(rt(x), rt(ind), 9.0, 1))
        # the reference's "add" raises (jnp.put_along_axis has no "add"
        # mode); the port adds, as its own `_put_along` fallback would
        want = x.copy()
        np.add.at(want, (np.arange(3)[:, None], ind), 9.0)
        np.testing.assert_allclose(
            pnp(pops.put_along_axis(pt(x), pt(ind), 9.0, 1, "add")), want)

    def test_tile_expand_broadcast(self):
        x = f32(2, 2)
        same(pops.tile(pt(x), [2, 3]), rops.tile(rt(x), [2, 3]))
        same(pops.tile(pt(x), [2, 1, 3]), rops.tile(rt(x), [2, 1, 3]))
        y = f32(1, 3)
        same(pops.expand(pt(y), [5, 3]), rops.expand(rt(y), [5, 3]))
        same(pops.expand(pt(y), [2, -1, 3]), rops.expand(rt(y), [2, -1, 3]))
        same(pops.broadcast_to(pt(y), [4, 3]), rops.broadcast_to(rt(y),
                                                                 [4, 3]))
        same(pops.expand_as(pt(y), pt(f32(4, 3))),
             rops.expand_as(rt(y), rt(f32(4, 3))))

    @pytest.mark.parametrize("pad,kw", [
        ([1, 1, 1, 1], {}),
        ([1, 2, 0, 3], {}),
        ([1, 0, 2, 1], {"data_format": "NHWC"}),
        ([0, 1, 1, 0, 2, 1, 1, 2], {}),
        ([2, 1], {"mode": "reflect"}),
        ([1, 2, 2, 1], {"mode": "replicate"}),
        ([1, 2, 0, 3], {"mode": "circular"}),
        ([1, 1, 1, 1], {"value": 3.5})])
    def test_pad(self, pad, kw):
        """A list of 2·ndim numbers pads dims in order from dim 0; a
        shorter one the trailing spatial dims from the last
        (ops/manipulation.py:233)."""
        x = f32(2, 3, 4, 5)
        same(pops.pad(pt(x), pad, **kw), rops.pad(rt(x), pad, **kw))

    def test_pad_full_list_order_differs_from_torch(self):
        x = f32(2, 3)
        got = pops.pad(pt(x), [1, 0, 0, 2])  # dim 0 by (1, 0), dim 1 (0, 2)
        assert list(got.shape) == [3, 5]
        assert list(torch.nn.functional.pad(pt(x), [1, 0, 0, 2]).shape) \
            == [4, 4]

    def test_flip_roll_rot90_repeat(self):
        x = f32(3, 4)
        same(pops.flip(pt(x), [0, 1]), rops.flip(rt(x), [0, 1]))
        same(pops.roll(pt(x), 2, 1), rops.roll(rt(x), 2, 1))
        same(pops.roll(pt(x), 3), rops.roll(rt(x), 3))
        same(pops.rot90(pt(x), 1, [0, 1]), rops.rot90(rt(x), 1, [0, 1]))
        same(pops.repeat_interleave(pt(x), 2, 0),
             rops.repeat_interleave(rt(x), 2, 0))

    def test_slices(self):
        x = f32(4, 6)
        same(pops.slice(pt(x), [0, 1], [1, -4], [3, 5]),
             rops.slice(rt(x), [0, 1], [1, -4], [3, 5]))
        same(pops.strided_slice(pt(x), [1], [0], [6], [2]),
             rops.strided_slice(rt(x), [1], [0], [6], [2]))
        same(pops.strided_slice(pt(x), [0, 1], [3, 5], [0, 0], [-1, -2]),
             rops.strided_slice(rt(x), [0, 1], [3, 5], [0, 0], [-1, -2]))
        same(pops.crop(pt(x), [2, 3], [1, 2]), rops.crop(rt(x), [2, 3],
                                                         [1, 2]))

    def test_where_masked_cast(self):
        x = np.float32([1.0, -2.0, 3.0])
        same(pops.where(pt(x) > 0, pt(x), pops.zeros([3])),
             rops.where(rt(x) > 0, rt(x), rops.zeros([3])))
        same(pops.masked_fill(pt(x), pt(x < 0), 7.0),
             rops.masked_fill(rt(x), rt(x < 0), 7.0))
        same(pops.masked_select(pt(x), pt(x > 0)),
             rops.masked_select(rt(x), rt(x > 0)))
        same(pops.cast(pt(x), "int32"), rops.cast(rt(x), "int32"))

    def test_getitem_setitem(self):
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        same(pops.getitem(pt(x), (1,)), rt(x)[1])
        same(pt(x)[:, 1:3], rt(x)[:, 1:3])
        out = pops.setitem(pt(x), (slice(None), 1), 5.0)
        same(out, rops.setitem(rt(x), (slice(None), 1), 5.0))
        assert pt(x)[0, 1] == 1.0  # out of place


class TestSearch:
    def test_argmax_topk(self):
        x = np.float32([[1.0, 5.0, 2.0], [7.0, 0.0, 3.0]])
        same(pops.argmax(pt(x), axis=1), rops.argmax(rt(x), axis=1))
        same(pops.argmin(pt(x), axis=0, keepdim=True),
             rops.argmin(rt(x), axis=0, keepdim=True))
        (pv, pi), (rv, ri) = pops.topk(pt(x), 2), rops.topk(rt(x), 2)
        same(pv, rv)
        same(pi, ri)
        (pv, pi), (rv, ri) = pops.topk(pt(x), 2, axis=0, largest=False), \
            rops.topk(rt(x), 2, axis=0, largest=False)
        same(pv, rv)
        same(pi, ri)

    def test_sort_argsort_ties(self):
        x = np.float32([3.0, 1.0, 3.0, 2.0, 1.0])
        for desc in (False, True):
            same(pops.sort(pt(x), descending=desc),
                 rops.sort(rt(x), descending=desc))
            same(pops.argsort(pt(x), descending=desc),
                 rops.argsort(rt(x), descending=desc))

    def test_unique_nonzero(self):
        """unique gives sorted values, first-occurrence indices, the
        inverse and counts (ops/search.py:164)."""
        x = np.array([1, 2, 2, 3, 1, 5, 3])
        got = pops.unique(pt(x), return_index=True, return_inverse=True,
                          return_counts=True)
        want = rops.unique(rt(x), return_index=True, return_inverse=True,
                           return_counts=True)
        for g, w in zip(got, want):
            same(g, w)
        same(pops.unique(pt(x)), rops.unique(rt(x)))
        nz = np.array([0, 1, 0, 2])
        same(pops.nonzero(pt(nz)), rops.nonzero(rt(nz)))

    def test_kthvalue_mode_median_quantile(self):
        x = np.float32([[3.0, 1.0, 2.0, 2.0], [5.0, 5.0, 4.0, 4.0]])
        for g, w in zip(pops.kthvalue(pt(x), 2), rops.kthvalue(rt(x), 2)):
            same(g, w)
        for g, w in zip(pops.mode(pt(x)), rops.mode(rt(x))):
            same(g, w)
        same(pops.median(pt(x), axis=1), rops.median(rt(x), axis=1))
        same(pops.median(pt(x)), rops.median(rt(x)))
        same(pops.quantile(pt(x), 0.3, axis=1),
             rops.quantile(rt(x), 0.3, axis=1), rtol=1e-6)

    def test_searchsorted_bucketize_histogram(self):
        s = np.float32([1.0, 3.0, 5.0, 7.0])
        v = np.float32([0.0, 3.0, 6.0, 8.0])
        for right in (False, True):
            same(pops.searchsorted(pt(s), pt(v), right=right),
                 rops.searchsorted(rt(s), rt(v), right=right))
            same(pops.bucketize(pt(v), pt(s), right=right),
                 rops.bucketize(rt(v), rt(s), right=right))
        h = np.float32([0.1, 0.2, 0.9, 0.5, 0.5])
        same(pops.histogram(pt(h), 4), rops.histogram(rt(h), 4))

    def test_unique_consecutive_axis_matches_torch(self):
        x = np.array([[1, 1], [1, 1], [2, 3], [2, 3], [1, 1]])
        got = ptt.unique_consecutive(pt(x), return_inverse=True,
                                     return_counts=True, axis=0)
        want = paddle.unique_consecutive(rt(x), return_inverse=True,
                                         return_counts=True, axis=0)
        for g, w in zip(got, want):
            same(g, w)
        tout = torch.unique_consecutive(torch.tensor(x), return_inverse=True,
                                        return_counts=True, dim=0)
        for g, w in zip(got, tout):
            np.testing.assert_array_equal(pnp(g), w.numpy())
        flat = np.array([1, 1, 2, 2, 3, 1, 1, 2])
        for g, w in zip(ptt.unique_consecutive(pt(flat), True, True),
                        paddle.unique_consecutive(rt(flat), True, True)):
            same(g, w)


class TestLinalg:
    def test_norm(self):
        x = f32(3, 4)
        for kw in ({}, {"p": 1, "axis": 1}, {"p": 2, "axis": 0},
                   {"p": float("inf"), "axis": 1}, {"p": 0, "axis": 1},
                   {"p": 3, "axis": 1, "keepdim": True},
                   {"p": "fro", "axis": [0, 1]}, {"p": 2}):
            same(pops.norm(pt(x), **kw), rops.norm(rt(x), **kw), rtol=1e-5)
        same(pops.dist(pt(x), pt(f32(3, 4, seed=1)), 3),
             rops.dist(rt(x), rt(f32(3, 4, seed=1)), 3), rtol=1e-5)

    def test_inverse_solve_decompositions(self):
        a = np.random.RandomState(0).rand(3, 3).astype(np.float32) \
            + 3 * np.eye(3, dtype=np.float32)
        spd = a @ a.T
        b = f32(3, 2)
        for op, args in (("inverse", (a,)), ("det", (a,)),
                         ("slogdet", (a,)), ("solve", (a, b)),
                         ("cholesky", (spd,)), ("matrix_power", (a, 3)),
                         ("pinv", (a,)), ("eigvalsh", (spd,))):
            conv = [pt(v) if isinstance(v, np.ndarray) else v for v in args]
            ref = [rt(v) if isinstance(v, np.ndarray) else v for v in args]
            same(getattr(pops, op)(*conv), getattr(rops, op)(*ref),
                 rtol=1e-4, atol=1e-5)
        L = np.linalg.cholesky(spd).astype(np.float32)
        same(pops.cholesky_solve(pt(b), pt(L)),
             rops.cholesky_solve(rt(b), rt(L)), rtol=1e-4, atol=1e-5)
        U = np.triu(a)
        for tr in (False, True):
            same(pops.triangular_solve(pt(U), pt(b), transpose=tr),
                 rops.triangular_solve(rt(U), rt(b), transpose=tr),
                 rtol=1e-4, atol=1e-5)
        s_p = pops.svd(pt(a))[1]
        s_r = rops.svd(rt(a))[1]
        same(s_p, s_r, rtol=1e-4, atol=1e-5)
        over = f32(5, 2)
        y = f32(5, 1, seed=3)
        for g, w in zip(pops.lstsq(pt(over), pt(y))[:2],
                        rops.lstsq(rt(over), rt(y))[:2]):
            same(g, w, rtol=1e-4, atol=1e-5)

    def test_einsum_contractions(self):
        a, b = f32(2, 3), f32(3, 4, seed=1)
        same(pops.einsum("ij,jk->ik", pt(a), pt(b)),
             rops.einsum("ij,jk->ik", rt(a), rt(b)), rtol=1e-5, atol=1e-6)
        v = f32(3, seed=2)
        for op, args in (("mv", (a, v)), ("outer", (v, v)),
                         ("inner", (a, a)), ("dot", (a, a)),
                         ("bmm", (f32(2, 2, 3), f32(2, 3, 2, seed=1))),
                         ("addmm", (f32(2, 4), a, b)),
                         ("cross", (f32(4, 3), f32(4, 3, seed=5))),
                         ("cov", (a,)), ("corrcoef", (a,)),
                         ("multi_dot", ([a, b, f32(4, 2)],))):
            conv = [pt(x) if isinstance(x, np.ndarray) else [pt(y)
                                                             for y in x]
                    for x in args]
            ref = [rt(x) if isinstance(x, np.ndarray) else [rt(y)
                                                            for y in x]
                   for x in args]
            same(getattr(pops, op)(*conv), getattr(rops, op)(*ref),
                 rtol=1e-5, atol=1e-5)
        i = np.array([0, 1, 1, 3])
        same(pops.bincount(pt(i), minlength=5),
             rops.bincount(rt(i), minlength=5))
        same(ptt.linalg.inv(pt(np.eye(2, dtype=np.float32) * 2)),
             paddle.linalg.inv(rt(np.eye(2, dtype=np.float32) * 2)))


class TestCreation:
    def test_creation(self):
        assert list(ptt.zeros([2, 3]).shape) == [2, 3]
        assert ptt.ones([2], "int64").dtype == ptt.int64
        same(ptt.arange(5), paddle.arange(5))
        same(ptt.arange(1, 7, 2, "float32"), paddle.arange(1, 7, 2,
                                                           "float32"))
        same(pops.eye(3, 4), rops.eye(3, 4))
        same(pops.full([2, 2], 7.0), rops.full([2, 2], 7.0))
        same(pops.linspace(0, 1, 5), rops.linspace(0, 1, 5), rtol=1e-6)
        same(pops.logspace(0, 2, 3), rops.logspace(0, 2, 3), rtol=1e-5)
        x = f32(3, 3)
        for op in ("tril", "triu"):
            same(getattr(pops, op)(pt(x), 1), getattr(rops, op)(rt(x), 1))
        v = np.float32([1.0, 2.0])
        same(pops.diag(pt(v), 1, 9.0), rops.diag(rt(v), 1, 9.0))
        same(pops.diag(pt(x)), rops.diag(rt(x)))
        same(pops.diagflat(pt(v), -1), rops.diagflat(rt(v), -1))
        same(pops.diag_embed(pt(x), 1), rops.diag_embed(rt(x), 1))
        for g, w in zip(pops.meshgrid(pt(v), pt(x[0])),
                        rops.meshgrid(rt(v), rt(x[0]))):
            same(g, w)
        for op in ("zeros_like", "ones_like"):
            same(getattr(pops, op)(pt(x)), getattr(rops, op)(rt(x)))
        same(pops.full_like(pt(x), 2.5), rops.full_like(rt(x), 2.5))
        same(pops.assign(x), rops.assign(rt(x)))

    def test_default_device_and_place(self):
        assert ptt.get_device() == "cpu"
        assert ptt.zeros([2]).device.type == "cpu"
        t = ptt.to_tensor([1.0], place=ptt.CPUPlace())
        assert t.device.type == "cpu" and not t.requires_grad
        assert ptt.to_tensor([1.0], stop_gradient=False).requires_grad
        assert ptt.CUDAPlace(1).torch_device() == torch.device("cuda", 1)
        assert ptt.TPUPlace is ptt.CUDAPlace and ptt.XPUPlace is ptt.CUDAPlace
        assert ptt.CUDAPinnedPlace() == ptt.CPUPlace()
        assert not ptt.is_compiled_with_tpu()

    def test_to_tensor_float64_gives_float32(self):
        """to_tensor of float64 numpy data is float32 (core/tensor.py:
        30-31); torch.as_tensor keeps float64."""
        x = np.arange(3, dtype=np.float64)
        assert ptt.to_tensor(x).dtype == torch.float32
        assert paddle.to_tensor(x).dtype.name == "float32"
        assert torch.as_tensor(x).dtype == torch.float64
        assert ptt.to_tensor([0.5, 1.5]).dtype == torch.float32
        assert ptt.to_tensor(x, dtype="float64").dtype == torch.float64
        same(ptt.to_tensor(x), paddle.to_tensor(x))

    def test_random_arithmetic(self):
        ptt.seed(42)
        a = pops.randn([4000])
        assert a.dtype == torch.float32 and abs(float(a.mean())) < 0.1
        assert abs(float(a.std()) - 1.0) < 0.05
        u = pops.uniform([4000], min=2.0, max=3.0)
        assert 2.0 <= float(u.min()) and float(u.max()) < 3.0
        assert abs(float(u.mean()) - 2.5) < 0.02
        p = pops.randperm(10)
        assert sorted(p.tolist()) == list(range(10)) and p.dtype == \
            torch.int64
        r = pops.randint(3, 9, [2000])
        assert int(r.min()) >= 3 and int(r.max()) <= 8
        tn = pops.truncated_normal([4000], 1.0, 2.0)
        assert float(tn.min()) >= -3.0 and float(tn.max()) <= 5.0
        n = pops.normal(1.0, 3.0, [4000])
        assert abs(float(n.mean()) - 1.0) < 0.2 and \
            abs(float(n.std()) - 3.0) < 0.15
        b = pops.bernoulli(ptt.full([4000], 0.25))
        assert abs(float(b.mean()) - 0.25) < 0.03
        m = pops.multinomial(ptt.to_tensor([0.0, 1.0, 3.0]), 2000, True)
        frac = np.bincount(m.numpy(), minlength=3) / 2000
        assert frac[0] == 0.0 and abs(frac[2] - 0.75) < 0.04
        e = pops.exponential(ptt.zeros([4000]), lam=2.0)
        assert abs(float(e.mean()) - 0.5) < 0.04
        s = pops.shuffle(ptt.arange(10))
        assert sorted(s.tolist()) == list(range(10))

    def test_seed_determinism(self):
        ptt.seed(7)
        a = pops.randn([4]).numpy()
        ptt.seed(7)
        b = pops.randn([4]).numpy()
        np.testing.assert_array_equal(a, b)
        state = ptt.get_rng_state()
        c = pops.rand([5]).numpy()
        pops.rand([5])
        ptt.set_rng_state(state)
        np.testing.assert_array_equal(pops.rand([5]).numpy(), c)


class TestCast:
    def test_cast(self):
        x = pt(np.float32([1.5, 2.5]))
        assert pops.cast(x, "int32").dtype == ptt.int32
        assert pops.cast(x, ptt.float64).dtype == ptt.float64
        same(pops.cast(x, "int32"), rops.cast(rt(np.float32([1.5, 2.5])),
                                              "int32"))
        assert pops.cast(x, "bf16").dtype == torch.bfloat16

    def test_dtype_names(self):
        from paddle_tpu_torch.core import dtype as d
        assert d.convert_dtype("fp16") == torch.float16
        assert d.convert_dtype(np.int8) == torch.int8
        assert d.convert_dtype(None) == torch.float32
        d.set_default_dtype("float64")
        try:
            assert ptt.get_default_dtype() == "float64"
            assert pops.zeros([1]).dtype == torch.float64
        finally:
            d.set_default_dtype("float32")
        with pytest.raises(ValueError):
            d.convert_dtype("float8")


class TestModulePaths:
    """The module paths of `tests/test_submodule_paths.py` the port has:
    the tensor, optimizer and nn paths, the compat-fed
    `tensor.to_string`, the legacy `nn.layer.extension`, and the
    decoder, hapi and distributed utility paths."""

    @pytest.mark.parametrize("mod", [
        "device", "amp.grad_scaler", "optimizer.adam", "optimizer.adamw",
        "optimizer.sgd", "optimizer.momentum", "optimizer.rmsprop",
        "optimizer.lamb", "optimizer.adagrad", "optimizer.adadelta",
        "optimizer.adamax", "tensor.attribute", "tensor.logic",
        "tensor.stat", "tensor.tensor", "nn.layer.distance",
        "nn.layer.vision", "nn.utils.weight_norm_hook",
        "nn.functional.transformer", "linalg", "autograd",
        "tensor.to_string", "nn.layer.extension", "nn.decode",
        "hapi.progressbar", "hapi.dynamic_flops", "distributed.utils",
        "distributed.cloud_utils", "distributed.fleet.utils",
        "distributed.fleet.utils.fs", "distributed.fleet.cloud_utils",
        "distributed.fleet.launch_utils", "distributed.fleet.launch"])
    def test_user_facing_module_paths_import(self, mod):
        import importlib
        importlib.import_module(f"paddle_tpu_torch.{mod}")
        importlib.import_module(f"paddle_tpu.{mod}")

    def test_classic_from_imports(self):
        from paddle_tpu_torch.amp.grad_scaler import GradScaler
        from paddle_tpu_torch.device import get_device
        from paddle_tpu_torch.optimizer.adam import Adam
        from paddle_tpu_torch.tensor.stat import mean
        assert GradScaler is ptt.amp.GradScaler
        assert Adam is ptt.optimizer.Adam and mean is pops.mean
        assert isinstance(get_device(), str)

    def test_dtype_predicates(self):
        f = ptt.to_tensor(np.ones(3, np.float32))
        assert bool(ptt.is_floating_point(f))
        assert not bool(ptt.is_integer(f)) and not bool(ptt.is_complex(f))
        assert bool(ptt.is_integer(ptt.to_tensor(np.ones(3, np.int32))))
        r = paddle.to_tensor(np.ones(3, np.float32))
        assert bool(paddle.is_floating_point(r)) == \
            bool(ptt.is_floating_point(f))

    def test_top_level_names_bind_lazily(self):
        import subprocess
        import sys
        code = ("import sys, paddle_tpu_torch as p\n"
                "assert 'paddle_tpu_torch.nn' not in sys.modules\n"
                "assert 'paddle_tpu_torch.ops' not in sys.modules\n"
                "assert 'paddle_tpu_torch.amp' not in sys.modules\n"
                "assert callable(p.reshape) and p.nn.Linear and p.amp\n"
                "print('OK')\n")
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0 and r.stdout.startswith("OK"), r.stderr
