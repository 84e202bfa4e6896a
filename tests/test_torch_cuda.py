"""The port's CUDA kernels on the card: K1 (ragged stream) and K2 (paged
decode), dense and int8, against their plain PyTorch versions on the same
inputs, across the shapes the serving path uses (head_dim 32/64/128,
block sizes 4/16/128, 4 and 12 heads), plus the launch counters and a
short decoder run on the card against the CPU.

Marked `cuda`: every test skips without a card (decided inside the
fixture, never at import). Run on the card with
`python -m pytest tests/test_torch_cuda.py -q --noconftest` (the repo's
conftest imports JAX, which the port's machines need not have).

Tolerances: float32 atol=1e-4 (the kernel sums in float32 in another
order; TF32 is off); bfloat16 atol=rtol=2e-2 against the plain version
computed in float32 from the same bfloat16 inputs (the kernel rounds
only its output)."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _pools(g, n, bs, h, dh, dtype, quant, dev):
    from paddle_tpu_torch.inference.kv_quant import QuantizedKV, kv_encode

    k = torch.randn(n, bs, h, dh, generator=g, device=dev)
    v = torch.randn(n, bs, h, dh, generator=g, device=dev)
    if not quant:
        return k.to(dtype), v.to(dtype)
    return (QuantizedKV(*kv_encode(k, dtype)),
            QuantizedKV(*kv_encode(v, dtype)))


def _f32(kv):
    if hasattr(kv, "codes"):
        return type(kv)(kv.codes, kv.scales.float())
    return kv.float()


def _tables(g, lens, bs, dev):
    """Disjoint random blocks per row, 0-padded; an empty row (ctx 1
    on the trash block) for lens[b] == 1 at b == 0."""
    m = max(-(-int(c) // bs) for c in lens)
    need = sum(-(-int(c) // bs) for c in lens)
    perm = torch.randperm(need + 4, generator=g, device="cpu") + 1
    tab = np.zeros((len(lens), m), np.int32)
    o = 0
    for b, c in enumerate(lens):
        nb = -(-int(c) // bs)
        if b == 0 and c == 1:
            continue
        tab[b, :nb] = perm[o:o + nb].numpy()
        o += nb
    return torch.from_numpy(tab).to(dev), need + 5


def _close(out, ref, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                               rtol=0 if dtype == torch.float32 else tol)


SHAPES = [(4, 32, 4), (12, 64, 16), (12, 64, 128), (12, 128, 16)]


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,dh,bs", SHAPES)
def test_paged_decode_kernel_matches_plain(dev, h, dh, bs, dtype, quant):
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import (paged_decode_attention,
                                                paged_decode_attention_plain)

    g = torch.Generator(device=dev).manual_seed(h * dh + bs)
    lens = [1, 300, 2 * bs, 37, 129, bs]
    tables, n = _tables(torch.Generator().manual_seed(1), lens, bs, dev)
    kb, vb = _pools(g, n, bs, h, dh, dtype, quant, dev)
    q = torch.randn(len(lens), h, dh, generator=g, device=dev).to(dtype)
    ctx = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = kernels.PAGED_DECODE[quant].launches
    out = paged_decode_attention(q, kb, vb, tables, ctx)
    torch.cuda.synchronize()
    assert kernels.PAGED_DECODE[quant].launches == before + 1
    ref = paged_decode_attention_plain(q.float(), _f32(kb), _f32(vb),
                                       tables, ctx)
    assert out.dtype == dtype and torch.isfinite(out).all()
    _close(out, ref, dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,dh,bs", SHAPES)
def test_ragged_stream_kernel_matches_plain(dev, h, dh, bs, dtype, quant):
    """A cached-prefix chunk, a fresh segment, a partial segment with
    pads, an unaligned segment boundary inside a 16-row tile, and a pad
    region."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import (
        ragged_prefill_attention, ragged_prefill_attention_plain)

    g = torch.Generator(device=dev).manual_seed(7 + h * dh + bs)
    segs = [(0, 90, 40), (1, 0, 21), (2, 0, 13), (3, 5, 30)]
    tables, n = _tables(torch.Generator().manual_seed(2),
                        [s0 + m for _r, s0, m in segs], bs, dev)
    seg, pos = [], []
    for r, s0, m in segs:
        seg += [r] * m
        pos += list(range(s0, s0 + m))
        if r == 2:
            seg += [0] * 3
            pos += [-1] * 3
    seg += [0] * 20
    pos += [-1] * 20
    seg = torch.tensor(seg, dtype=torch.int32, device=dev)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    kb, vb = _pools(g, n, bs, h, dh, dtype, quant, dev)
    q = torch.randn(len(seg), h, dh, generator=g, device=dev).to(dtype)
    before = kernels.RAGGED_STREAM[quant].launches
    out = ragged_prefill_attention(q, kb, vb, tables, seg, pos)
    torch.cuda.synchronize()
    assert kernels.RAGGED_STREAM[quant].launches == before + 1
    ref = ragged_prefill_attention_plain(q.float(), _f32(kb), _f32(vb),
                                         tables, seg, pos)
    valid = pos >= 0
    assert torch.isfinite(out).all()
    assert (out[~valid] == 0).all()  # pad rows flush zeros
    _close(out[valid], ref[valid], dtype)


def test_kernel_refuses_unsupported_head_dim(dev):
    from paddle_tpu_torch.ops.attention import paged_decode_attention

    q = torch.zeros(1, 2, 48, device=dev)
    pool = torch.zeros(2, 4, 2, 48, device=dev)
    with pytest.raises(ValueError, match="head_dim 48"):
        paged_decode_attention(q, pool, pool,
                               torch.ones(1, 1, dtype=torch.int32,
                                          device=dev),
                               torch.ones(1, dtype=torch.int32, device=dev))


def test_decoder_on_card_matches_cpu(dev):
    """A tiny decoder's packed prefill and steps on the card (kernels)
    agree with the CPU (plain versions) on the same float32 weights."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache
    from paddle_tpu_torch.models import GPT2, GPT2Config
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.sampling import greedy_args

    cfg = GPT2Config(vocab_size=512, hidden_size=128, num_layers=2,
                     num_heads=4, max_position=64)
    model = GPT2(cfg, seed=3, device="cpu")
    out = {}
    for d in ("cpu", dev):
        params = {k: v.to(d) for k, v in model.flat_params().items()}
        c = PagedKVCache(2, 4, 32, block_size=4, num_blocks=16, device=d)
        c.ensure_many([(0, 14), (1, 9)])
        tab = torch.from_numpy(c.table_array([0, 1], 4)).to(d)
        dec = PagedDecoder.for_config(cfg, 4, return_logits=True)
        toks = torch.arange(1, 17, dtype=torch.int32, device=d)
        seg = torch.tensor([0] * 10 + [1] * 6, dtype=torch.int32, device=d)
        pos = torch.tensor(list(range(10)) + list(range(6)),
                           dtype=torch.int32, device=d)
        sidx = torch.tensor([9, 15], dtype=torch.int32, device=d)
        r = dec.packed_prefill(params, toks, seg, pos, tab, sidx,
                               c.k_blocks, c.v_blocks, greedy_args(2, d))
        s = dec.step(params, r[0], torch.tensor([10, 6], dtype=torch.int32,
                                                device=d),
                     torch.ones(2, dtype=torch.bool, device=d), tab,
                     c.k_blocks, c.v_blocks, greedy_args(2, d))
        out[str(d)] = (r[5].cpu(), s[5].cpu())
    for a, b in zip(out["cpu"], out[str(dev)]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=0)
