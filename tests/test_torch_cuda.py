"""The port's CUDA kernels on the card: K1 (ragged stream) and K2 (paged
decode), dense and int8, against their plain PyTorch versions on the same
inputs, across the shapes the serving path uses (head_dim 32/64/128,
block sizes 4/16/128, 4 and 12 heads), plus the launch counters and a
short decoder run on the card against the CPU. K2 is the split-KV kernel
of `csrc/paged_decode_sm90.cu`: its cases run several splits and a
one-split plan, contexts on a split boundary and one key either side,
ctx past M * BS, an idle row and a ctx 0 row (zeros); two launches give
the same bits, and a call makes no host synchronisation. K1 in bf16 is
the tensor-core kernel of `csrc/ragged_stream_sm90.cu` (64-row tiles, a
key pass per distinct segment in a tile): its cases hold mixed, short
(several segments a tile) and serving-like streams, BS 4 at Dh 64 and
BS 3 (one-row boxes, staged and converted), repeat bit for bit and make
no host synchronisation. And the flash
kernels K4 (forward with LSE), K6 (delta: 16-byte loads, several rows a
warp, at every D and dtype, bitwise over two launches) and K9 (fused
backward)
against theirs, causal and not, at aligned, ragged and Sq != Sk
lengths, plus a tiny
GPT-2 train step on the card against the CPU; and the per-key-bias
variants K4 bias / K9 bias against theirs at chip_smoke.py phase 3c's
shapes (padding masks, a broadcast bias, a fully masked row), plus a tiny
BERT train step on padded batches on the card against the CPU; and the
two-pass backward K7 (dq) / K8 (dk, dv, dbias), plain and bias, against
theirs at the same shapes, with an LSE of a larger attention, bitwise
from launch to launch, plus the launch counts of a padded 2-layer GPT-2
step at S = 13312, past the reference's switch to the two-pass
backward. In bfloat16 K4 and K4 bias are the Hopper kernel of
`csrc/flash_fwd_sm90.cu` (wgmma, TMA): the shapes take in D 128 at
S 2048 and Sq > Sk with Sk off its 128-key tiles, and two launches must
give the same bits; K9 and K9 bias are that of `csrc/flash_bwd_sm90.cu`,
held at D 32, 64 and 128, tails, Sq != Sk both ways, and every bias
kind, with dk, dv and dbias bitwise equal over two launches. The bf16
K8 and K8 bias are that file's body without its dq: two launches give the
same bits at D 32, 64 and 128, with dead rows and a fully masked batch
row, and dk, dv and dbias equal the bf16 K9's bit for bit on every
two-pass case. The bf16 K7 and K7 bias are the kernel of
`csrc/flash_bwd_dq_sm90.cu`: their dq lies within 5e-3 of the bf16 K9's
magnitude plus one bf16 rounding step on every two-pass case, and two
launches give the same bits, also where q tiles see no key at all (their
dq is zero). Every flash wrapper takes B * H = 65536, past grid y's
65535.

Marked `cuda`: every test skips without a card (decided inside the
fixture, never at import). Run on the card with
`python -m pytest tests/test_torch_cuda.py -q --noconftest` (the repo's
conftest imports JAX, which the port's machines need not have).

Tolerances: float32 atol=1e-4 (the kernel sums in float32 in another
order; TF32 is off); bfloat16 atol=rtol=2e-2 against the plain version
computed in float32 from the same bfloat16 inputs (the kernels round
their output; the bf16 K1 also rounds P and int8 vectors to bf16, as the
reference's Pallas kernel does). The flash cases hold the largest error to that
tolerance times the plain output's largest magnitude (K9's dq is summed
with atomics in a varying order)."""
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
# K1's also BS 4 at Dh 64 (512-byte TMA boxes, half the 128-byte swizzle's
# 1024-byte period) and BS 3 at Dh 32 (one-row boxes of 64 bytes could not
# start on TMA's 128-byte alignment in the tile: the bf16 K1 stages them
# unswizzled and converts, as it does int8 codes)
STREAM_SHAPES = SHAPES + [(12, 64, 4), (4, 32, 3)]


def _decode_inputs(dev, h, dh, bs, dtype, quant, layout, seed):
    """K2's inputs at one of two plan layouts (`kernels.decode_split_plan`
    of B, H, M, BS): "many" — 8 rows over a 512-key table, so several
    splits, with lengths for an idle row (ctx 1 on the trash block), a
    context on a split boundary and one key either side of it, one inside
    the first split, several splits, ctx > M * BS (clamped) and a full
    table; "one" — enough rows that the plan has a single split (the
    split kernel writes the output, no combine). Returns (q, k pool,
    v pool, tables, ctx_lens, splits)."""
    from paddle_tpu_torch.ops import kernels

    m = 512 // bs
    if layout == "many":
        b = 8
        splits, chunk = kernels.decode_split_plan(b, h, m, bs)
        lens = [1, chunk, chunk - 1, chunk + 1, chunk // 2, 3 * chunk + 5,
                m * bs + 40, m * bs]
    else:
        groups = -(-h // min(h, kernels.SPLIT_HEADS))
        b = -(-kernels.SPLIT_TARGET_CTAS // groups)
        splits, _ = kernels.decode_split_plan(b, h, m, bs)
        rs = np.random.RandomState(seed)
        lens = [1] + list(rs.randint(1, m * bs + 50, b - 1))
    gt = torch.Generator().manual_seed(seed)
    nb = [min(-(-int(c) // bs), m) for c in lens]
    perm = torch.randperm(sum(nb) + 4, generator=gt) + 1
    tab = np.zeros((b, m), np.int32)
    o = 0
    for r, k in enumerate(nb):
        if r == 0:
            continue  # the idle row: all trash
        tab[r, :k] = perm[o:o + k].numpy()
        o += k
    g = torch.Generator(device=dev).manual_seed(seed)
    kb, vb = _pools(g, sum(nb) + 5, bs, h, dh, dtype, quant, dev)
    q = torch.randn(b, h, dh, generator=g, device=dev).to(dtype)
    ctx = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kb, vb, torch.from_numpy(tab).to(dev), ctx, splits


@pytest.mark.parametrize("layout", ["many", "one"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,dh,bs", SHAPES)
def test_paged_decode_kernel_matches_plain(dev, h, dh, bs, dtype, quant,
                                           layout):
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import (paged_decode_attention,
                                                paged_decode_attention_plain)

    q, kb, vb, tables, ctx, splits = _decode_inputs(
        dev, h, dh, bs, dtype, quant, layout, h * dh + bs)
    assert (splits > 1) == (layout == "many")
    before = kernels.PAGED_DECODE[quant].launches
    out = paged_decode_attention(q, kb, vb, tables, ctx)
    torch.cuda.synchronize()
    assert kernels.PAGED_DECODE[quant].launches == before + 1
    ref = paged_decode_attention_plain(q.float(), _f32(kb), _f32(vb),
                                       tables, ctx)
    assert out.dtype == dtype and torch.isfinite(out).all()
    _close(out, ref, dtype)


@pytest.mark.parametrize("layout", ["many", "one"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("h,dh,bs", SHAPES)
def test_paged_decode_is_bitwise_reproducible(dev, h, dh, bs, quant, layout):
    """Splits and combine in a fixed order, no atomics: two launches on the
    same inputs give the same bits."""
    from paddle_tpu_torch.ops.attention import paged_decode_attention

    q, kb, vb, tables, ctx, _ = _decode_inputs(
        dev, h, dh, bs, torch.bfloat16, quant, layout, 3 + bs)
    a = paged_decode_attention(q, kb, vb, tables, ctx)
    b = paged_decode_attention(q, kb, vb, tables, ctx)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_decode_ctx_zero_gives_zeros(dev, dtype, quant):
    """A row with ctx 0 attends nothing and gives zeros (as the Pallas
    kernel's untouched accumulator does), with and without a combine;
    the other rows are unaffected."""
    from paddle_tpu_torch.ops.attention import (paged_decode_attention,
                                                paged_decode_attention_plain)

    for layout in ("many", "one"):
        q, kb, vb, tables, ctx, _ = _decode_inputs(
            dev, 12, 64, 16, dtype, quant, layout, 5)
        ctx[2] = 0
        out = paged_decode_attention(q, kb, vb, tables, ctx)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert (out[2] == 0).all()
        ref = paged_decode_attention_plain(q.float(), _f32(kb), _f32(vb),
                                           tables, ctx)
        keep = torch.arange(len(ctx), device=dev) != 2
        _close(out[keep], ref[keep], dtype)


def test_paged_decode_makes_no_host_sync(dev):
    """The wrapper plans its splits from shapes alone: no read of ctx_lens
    (or anything else) back to the host."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import paged_decode_attention

    q, kb, vb, tables, ctx, _ = _decode_inputs(
        dev, 12, 64, 16, torch.bfloat16, True, "many", 9)
    kernels.library()  # the build and load are not under test
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = paged_decode_attention(q, kb, vb, tables, ctx)
        out2 = paged_decode_attention(q, kb, vb, tables, ctx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


def _stream_inputs(dev, h, dh, bs, dtype, quant, stream, seed):
    """K1's inputs for one packing: "mixed" (a cached-prefix chunk, a
    fresh segment, a partial segment with pads, an unaligned segment
    boundary inside a tile, a pad region), "short" (24 segments of 8
    query tokens, last positions in 8..300: a stream of verify windows,
    several segments a tile) or "serving" (two fresh 128-token chunks and
    two second chunks at positions 128..255, as prefill packs them)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if stream == "mixed":
        segs = [(0, 90, 40), (1, 0, 21), (2, 0, 13), (3, 5, 30)]
    elif stream == "short":
        last = np.random.RandomState(seed).randint(8, 301, 24)
        segs = [(r, int(e) - 7, 8) for r, e in enumerate(last)]
    else:
        segs = [(0, 0, 128), (1, 128, 128), (2, 0, 128), (3, 128, 128)]
    tables, n = _tables(torch.Generator().manual_seed(2),
                        [s0 + m for _r, s0, m in segs], bs, dev)
    seg, pos = [], []
    for r, s0, m in segs:
        seg += [r] * m
        pos += list(range(s0, s0 + m))
        if stream == "mixed" and r == 2:
            seg += [0] * 3
            pos += [-1] * 3
    if stream == "mixed":
        seg += [0] * 20
        pos += [-1] * 20
    seg = torch.tensor(seg, dtype=torch.int32, device=dev)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    kb, vb = _pools(g, n, bs, h, dh, dtype, quant, dev)
    q = torch.randn(len(seg), h, dh, generator=g, device=dev).to(dtype)
    return q, kb, vb, tables, seg, pos


@pytest.mark.parametrize("stream", ["mixed", "short", "serving"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,dh,bs", STREAM_SHAPES)
def test_ragged_stream_kernel_matches_plain(dev, h, dh, bs, dtype, quant,
                                            stream):
    """The packings of `_stream_inputs`; pad rows flush zeros. In bf16 the
    tensor-core kernel of csrc/ragged_stream_sm90.cu, in float32 the SIMT
    one."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import (
        ragged_prefill_attention, ragged_prefill_attention_plain)

    q, kb, vb, tables, seg, pos = _stream_inputs(
        dev, h, dh, bs, dtype, quant, stream, 7 + h * dh + bs)
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


@pytest.mark.parametrize("stream", ["mixed", "short"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("h,dh,bs", STREAM_SHAPES)
def test_ragged_stream_bf16_is_bitwise_reproducible(dev, h, dh, bs, quant,
                                                    stream):
    """No atomics and one order of sums: two launches of the bf16 K1 on
    the same inputs give the same bits."""
    from paddle_tpu_torch.ops.attention import ragged_prefill_attention

    q, kb, vb, tables, seg, pos = _stream_inputs(
        dev, h, dh, bs, torch.bfloat16, quant, stream, 11 + bs)
    a = ragged_prefill_attention(q, kb, vb, tables, seg, pos)
    b = ragged_prefill_attention(q, kb, vb, tables, seg, pos)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_ragged_stream_makes_no_host_sync(dev):
    """The wrapper reads nothing of seg, pos or tables back to the host."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import ragged_prefill_attention

    kernels.library()  # the build and load are not under test
    for quant in (False, True):
        q, kb, vb, tables, seg, pos = _stream_inputs(
            dev, 12, 64, 16, torch.bfloat16, quant, "short", 5)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = ragged_prefill_attention(q, kb, vb, tables, seg, pos)
            out2 = ragged_prefill_attention(q, kb, vb, tables, seg, pos)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert torch.equal(out, out2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_delta_matches_plain_and_repeats(dev, d, dtype):
    """K6 (16-byte loads, several rows a warp) at a row count that is no
    multiple of the rows of a warp or of a block (B 3, H 5, S 67: 1005
    rows), against its plain version (1e-4 of its magnitude in float32,
    2e-2 in bf16, as phase 3b), bit for bit over two launches."""
    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    g = torch.Generator(device=dev).manual_seed(d)
    o, do = (torch.randn(3, 5, 67, d, generator=g, device=dev).to(dtype)
             for _ in range(2))
    delta = kernels.flash_delta(o, do)
    again = kernels.flash_delta(o, do)
    torch.cuda.synchronize()
    assert delta.shape == (15, 67) and torch.equal(delta, again)
    ref = pf.flash_delta_plain(o.float(), do.float())
    _rel_close(delta, ref, 1e-4 if dtype == torch.float32 else 2e-2,
               "delta")


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


# ---- flash attention: K4, K6, K9 -------------------------------------------

# with D 128 at S 2048 (two TMA boxes a row, the bf16 K4's register
# peak) and Sk not a multiple of the bf16 K4's 128-key tile with Sq > Sk
# (dead rows)
FLASH_SHAPES = [(2, 3, 128, 128, 32), (1, 2, 200, 200, 64),
                (2, 2, 64, 192, 128), (1, 2, 192, 64, 64), (1, 1, 1, 1, 32),
                (1, 2, 2048, 2048, 128), (2, 2, 300, 200, 64)]


def _rel_close(out, ref, tol, what, floor=1e-6):
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), floor)
    assert torch.isfinite(out).all(), what
    assert err <= tol * scale, f"{what}: max abs err {err:.3g} > " \
        f"{tol} x {scale:.3g}"


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,sq,sk,d", FLASH_SHAPES)
def test_flash_kernels_match_plain(dev, b, h, sq, sk, d, dtype, causal):
    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    g = torch.Generator(device=dev).manual_seed(sq * 7 + sk + d)
    q = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, h, sk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, h, sk, d, generator=g, device=dev).to(dtype)
    do = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
    sc = d ** -0.5
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    before = kernels.launch_counts()
    out, lse = kernels.flash_fwd(q, k, v, sc, causal)
    delta = kernels.flash_delta(out, do)
    dq, dk, dv = kernels.flash_bwd(q, k, v, do, lse, delta, sc, causal)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for n in ("flash_fwd", "flash_delta", "flash_bwd"):
        assert after[n] == before[n] + 1, n
    f = [t.float() for t in (q, k, v, do)]
    out_p, lse_p = pf.flash_fwd_lse_plain(f[0], f[1], f[2], sc, causal)
    _rel_close(out, out_p, tol, "out")
    _rel_close(lse, lse_p, 1e-4, "lse")
    delta_p = pf.flash_delta_plain(out.float(), f[3])
    _rel_close(delta, delta_p, 1e-4, "delta")
    grads_p = pf.flash_bwd_plain(f[0], f[1], f[2], f[3], lse, delta, sc,
                                 causal)
    for name, a, p in zip(("dq", "dk", "dv"), (dq, dk, dv), grads_p):
        assert a.dtype == dtype
        _rel_close(a, p, tol, name)


def test_flash_attention_autograd_on_card_matches_cpu(dev):
    from paddle_tpu_torch.ops.flash_attention import flash_attention

    rs = np.random.RandomState(0)
    arrs = [rs.randn(2, 2, 96, 64).astype(np.float32) for _ in range(4)]
    res = {}
    for d in ("cpu", dev):
        q, k, v = (torch.from_numpy(a).to(d).requires_grad_(True)
                   for a in arrs[:3])
        out = flash_attention(q, k, v, causal=True)
        out.backward(torch.from_numpy(arrs[3]).to(d))
        res[str(d)] = [t.detach().cpu() for t in (out, q.grad, k.grad,
                                                  v.grad)]
    for a, b in zip(res["cpu"], res[str(dev)]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


def test_train_step_on_card_matches_cpu(dev):
    """A tiny GPT-2's float32 loss and gradients on the card (K4, K6, K9:
    one launch of each per layer) against the CPU (plain versions)."""
    from paddle_tpu_torch.models.gpt2 import GPT2Config, build_train_step
    from paddle_tpu_torch.ops import kernels

    cfg = GPT2Config.tiny()
    cfg.dropout = 0.0
    rs = np.random.RandomState(1)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 100)))
    loss_fn, init_params = build_train_step(cfg, device="cpu")
    weights = init_params()
    res = {}
    for d in ("cpu", dev):  # the same weights on both sides
        params = {n: w.detach().to(d).requires_grad_(True)
                  for n, w in weights.items()}
        kernels.reset_launch_counts()
        loss = loss_fn(params, {"input_ids": ids.to(d),
                                "labels": ids.to(d)})
        grads = torch.autograd.grad(loss, list(params.values()))
        counts = kernels.launch_counts()
        res[str(d)] = (loss.item(), [g.cpu() for g in grads], counts)
    assert res[str(dev)][2]["flash_fwd"] == cfg.num_layers
    assert res[str(dev)][2]["flash_delta"] == cfg.num_layers
    assert res[str(dev)][2]["flash_bwd"] == cfg.num_layers
    assert res["cpu"][2]["flash_fwd"] == 0
    assert abs(res[str(dev)][0] - res["cpu"][0]) <= 1e-5 * abs(res["cpu"][0])
    for a, b in zip(res["cpu"][1], res[str(dev)][1]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-3)


# ---- per-key-bias flash attention: K4 bias, K9 bias ------------------------

BIAS_SHAPES = [  # (b, h, sq, sk, d, causal, bias kind), chip_smoke phase 3c
    (16, 16, 512, 512, 64, False, "lengths"),
    (2, 4, 300, 300, 32, True, "lengths"),
    (2, 4, 256, 384, 64, False, "lengths"),
    (2, 4, 256, 384, 64, True, "lengths"),
    (2, 4, 256, 256, 64, False, "broadcast"),
    (2, 4, 256, 256, 32, False, "dead_row"),
    (2, 4, 256, 256, 32, True, "dead_row"),
    (1, 2, 2048, 2048, 128, True, "lengths"),
    (2, 2, 300, 200, 64, True, "lengths"),
    (2, 2, 1, 1, 64, False, "lengths"),
]


def _bias(kind, b, sk, seed, dev):
    """A float32 per-key bias: padding masks from lengths in
    [sk/4, sk] ("lengths"), the same with batch row 0 fully masked
    ("dead_row"), or one random row over the batch ("broadcast")."""
    rs = np.random.RandomState(seed)
    if kind == "broadcast":
        return torch.from_numpy(rs.randn(1, sk).astype(np.float32)).to(dev)
    lens = rs.randint(sk // 4, sk + 1, b)
    if kind == "dead_row":
        lens[0] = 0
    bias = np.where(np.arange(sk)[None] < lens[:, None], 0.0, -1e30)
    return torch.from_numpy(bias.astype(np.float32)).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,sq,sk,d,causal,kind", BIAS_SHAPES)
def test_flash_bias_kernels_match_plain(dev, b, h, sq, sk, d, causal, kind,
                                        dtype):
    """With one key the exact dq, dk and dbias are zero (p = 1, dp =
    delta) and both sides are rounding noise: there they are held against
    the inputs' scale (1), as in the two-pass test."""
    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    g = torch.Generator(device=dev).manual_seed(sq + 3 * sk + d)
    q = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, h, sk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, h, sk, d, generator=g, device=dev).to(dtype)
    do = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
    bias = _bias(kind, b, sk, sq + sk, dev)
    sc = d ** -0.5
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    before = kernels.launch_counts()
    out, lse = kernels.flash_fwd_bias(q, k, v, bias, sc, causal)
    delta = kernels.flash_delta(out, do)
    dq, dk, dv, db = kernels.flash_bwd_bias(q, k, v, do, lse, delta, bias,
                                            sc, causal)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for n in ("flash_fwd_bias", "flash_delta", "flash_bwd_bias"):
        assert after[n] == before[n] + 1, n
    for n in ("flash_fwd", "flash_bwd"):
        assert after[n] == before[n], n
    f = [t.float() for t in (q, k, v, do)]
    out_p, lse_p = pf.flash_fwd_lse_plain(f[0], f[1], f[2], sc, causal,
                                          bias)
    _rel_close(out, out_p, tol, "out")
    live = lse_p > -1e29
    _rel_close(lse[live], lse_p[live], 1e-4, "lse")
    assert (lse[~live] <= -1e29).all()
    grads_p = pf.flash_bwd_plain(f[0], f[1], f[2], f[3], lse, delta, sc,
                                 causal, bias)
    floor = 1.0 if sk == 1 else 1e-6
    for name, a, p in zip(("dq", "dk", "dv"), (dq, dk, dv), grads_p):
        assert a.dtype == dtype
        _rel_close(a, p, tol, name, floor)
    assert db.shape == (b * h, sk) and db.dtype == torch.float32
    _rel_close(db, grads_p[3], tol, "dbias", floor)


@pytest.mark.parametrize("kind", [None, "lengths"], ids=["plain", "bias"])
def test_flash_fwd_bf16_is_bitwise_reproducible(dev, kind):
    """The bf16 K4 and K4 bias use no atomics: two launches on the same
    inputs give the same bits."""
    from paddle_tpu_torch.ops import kernels

    b, h, s, d = 2, 4, 1000, 64
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=dev).bfloat16()
               for _ in range(3))
    bias = None if kind is None else _bias(kind, b, s, 5, dev)
    sc = d ** -0.5

    def fwd():
        return (kernels.flash_fwd(q, k, v, sc, True) if bias is None else
                kernels.flash_fwd_bias(q, k, v, bias, sc, True))

    (o1, l1), (o2, l2) = fwd(), fwd()
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


# the bf16 K9 and K9 bias of csrc/flash_bwd_sm90.cu: D 32 (64-byte
# swizzle, each consumer's half of dQ inside one box), 64 and 128 (two
# TMA boxes a row), tails (S 1000, S 300), Sq < Sk and Sq > Sk under
# causal masking (dead rows), full attention, and with a bias: padding
# lengths, one row broadcast over the batch, a fully masked batch row;
# Sk below one consumer's 64 keys
K9_BF16_CASES = [
    (2, 4, 1000, 1000, 32, True, None),
    (2, 4, 1000, 1000, 64, False, None),
    (2, 2, 300, 300, 128, True, None),
    (1, 2, 200, 300, 64, True, None),
    (1, 2, 384, 256, 64, True, None),
    (1, 2, 300, 200, 128, True, None),
    (2, 2, 300, 300, 32, False, None),
    (2, 4, 300, 300, 32, True, "lengths"),
    (2, 4, 256, 384, 64, False, "lengths"),
    (2, 4, 256, 256, 128, False, "broadcast"),
    (2, 4, 256, 256, 32, False, "dead_row"),
    (2, 4, 256, 256, 64, True, "dead_row"),
    (1, 2, 384, 256, 128, True, "lengths"),
    (1, 2, 130, 5, 64, True, None),          # Sk < 64: one consumer idle
    (2, 2, 70, 70, 128, False, "dead_row"),
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,kind", K9_BF16_CASES)
def test_flash_bwd_bf16_matches_plain(dev, b, h, sq, sk, d, causal, kind):
    """The bf16 K9 (K9 bias with a bias) against the plain version within
    2e-2 of its magnitude (the kernel rounds p and ds to bf16 before its
    products, as the reference's `_tile_p_ds`); dk, dv and dbias bitwise
    equal over two launches (each block owns its keys), and the launch
    counter up by one per call."""
    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    g = torch.Generator(device=dev).manual_seed(5 * sq + sk + d)
    q, k, v, do = (torch.randn(b, h, n, d, generator=g, device=dev)
                   .bfloat16() for n in (sq, sk, sk, sq))
    bias = None if kind is None else _bias(kind, b, sk, sq + 2 * sk, dev)
    sc = d ** -0.5
    if bias is None:
        out, lse = kernels.flash_fwd(q, k, v, sc, causal)
        name, counter = "flash_bwd", kernels.FLASH_BWD

        def bwd():
            return kernels.flash_bwd(q, k, v, do, lse, delta, sc,
                                     causal) + (None,)
    else:
        out, lse = kernels.flash_fwd_bias(q, k, v, bias, sc, causal)
        name, counter = "flash_bwd_bias", kernels.FLASH_BWD_BIAS

        def bwd():
            return kernels.flash_bwd_bias(q, k, v, do, lse, delta, bias, sc,
                                          causal)
    delta = kernels.flash_delta(out, do)
    before = counter.launches
    first = bwd()
    assert counter.launches == before + 1, name
    again = bwd()
    assert counter.launches == before + 2, name
    torch.cuda.synchronize()
    for what, a, a2 in zip(("dk", "dv", "dbias"), first[1:], again[1:]):
        if a is not None:
            assert torch.equal(a, a2), f"{what} differs between launches"
    f = [t.float() for t in (q, k, v, do)]
    plain = pf.flash_bwd_plain(*f, lse, delta, sc, causal, bias)
    for what, a, p in zip(("dq", "dk", "dv", "dbias"), first, plain):
        if a is None:
            assert p is None
            continue
        assert a.dtype == (torch.float32 if what == "dbias"
                           else torch.bfloat16)
        _rel_close(a, p, 2e-2, what)


@pytest.mark.parametrize("kind", [None, "lengths"], ids=["plain", "bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_take_bh_above_the_grid_limit(dev, dtype, kind):
    """B * H = 65536, one past grid y's 65535: K4, K6, K9, K7 and K8 (their
    bias variants with a bias) against their plain versions. The SIMT
    kernels launch in chunks of bh, the bf16 K4 and K9 put bh on grid x."""
    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    b, h, s, d = 4096, 16, 8, 32
    g = torch.Generator(device=dev).manual_seed(17)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    bias = None if kind is None else _bias(kind, b, s, 3, dev)
    sc = d ** -0.5
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    f = [t.float() for t in (q, k, v, do)]
    if bias is None:
        out, lse = kernels.flash_fwd(q, k, v, sc, True)
        delta = kernels.flash_delta(out, do)
        fused = kernels.flash_bwd(q, k, v, do, lse, delta, sc, True)
        dq = kernels.flash_bwd_dq(q, k, v, do, lse, delta, sc, True)
        two = (dq,) + kernels.flash_bwd_dkv(q, k, v, do, lse, delta, sc, True)
    else:
        out, lse = kernels.flash_fwd_bias(q, k, v, bias, sc, True)
        delta = kernels.flash_delta(out, do)
        fused = kernels.flash_bwd_bias(q, k, v, do, lse, delta, bias, sc,
                                       True)
        dq = kernels.flash_bwd_dq_bias(q, k, v, do, lse, delta, bias, sc,
                                       True)
        two = (dq,) + kernels.flash_bwd_dkv_bias(q, k, v, do, lse, delta,
                                                 bias, sc, True)
    torch.cuda.synchronize()
    assert lse.shape == (b * h, s)
    out_p, lse_p = pf.flash_fwd_lse_plain(*f[:3], sc, True, bias)
    _rel_close(out, out_p, tol, "out")
    live = lse_p > -1e29
    _rel_close(lse[live], lse_p[live], 1e-4, "lse")
    _rel_close(delta, pf.flash_delta_plain(out.float(), f[3]), 1e-4,
               "delta")
    plain = pf.flash_bwd_plain(*f, lse, delta, sc, True, bias)
    for which, grads in (("K9", fused), ("K7/K8", two)):
        for what, a, p in zip(("dq", "dk", "dv", "dbias"), grads, plain):
            _rel_close(a, p, tol, f"{which} {what}")


def test_bert_train_step_on_card_matches_cpu(dev):
    """A tiny BERT's float32 pretraining loss on a padded batch (MLM +
    NSP) and its gradients on the card (K4 bias, K6, K9 bias: one launch
    of each per layer, none of the unbiased K4/K9) against the CPU."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import kernels

    cfg = bert.BertConfig.tiny()
    cfg.dropout = 0.0
    rs = np.random.RandomState(2)
    lens = np.array([100, 61])
    am = (np.arange(100)[None] < lens[:, None]).astype(np.int32)
    ids = rs.randint(1, cfg.vocab_size, (2, 100)).astype(np.int32) * am
    masked, labels = bert.create_mlm_batch(ids, cfg.vocab_size, 3, seed=0)
    tt = (np.arange(100)[None] >= 50).repeat(2, 0).astype(np.int32)
    nsp = np.array([0, 1], np.int32)
    arrays = [masked.astype(np.int32), labels.astype(np.int32), nsp, tt, am]
    model = bert.Bert(cfg, device="cpu")
    weights = {n: p.detach() for n, p in model.named_parameters()}
    res = {}
    for d in ("cpu", dev):
        m = model.to(d)
        params = {n: w.to(d).requires_grad_(True) for n, w in weights.items()}
        kernels.reset_launch_counts()
        loss = bert.pretraining_loss_with(
            m, params, *(torch.from_numpy(a).to(d) for a in arrays))
        grads = torch.autograd.grad(loss, list(params.values()))
        res[str(d)] = (loss.item(), [g.cpu() for g in grads],
                       kernels.launch_counts())
    counts = res[str(dev)][2]
    for n in ("flash_fwd_bias", "flash_delta", "flash_bwd_bias"):
        assert counts[n] == cfg.num_layers, n
    assert counts["flash_fwd"] == counts["flash_bwd"] == 0
    assert res["cpu"][2]["flash_fwd_bias"] == 0
    assert abs(res[str(dev)][0] - res["cpu"][0]) <= 1e-5 * abs(res["cpu"][0])
    for a, b in zip(res["cpu"][1], res[str(dev)][1]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-3)


# ---- the two-pass backward: K7, K8 and their bias variants -----------------

def _two_pass_inputs(dev, b, h, sq, sk, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, h, sk, d, generator=g, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, do


def _two_pass(kernels, q, k, v, do, lse, delta, bias, sc, causal):
    """(dq, dk, dv, dbias or None) from K7 and K8 (their bias variants
    with a bias)."""
    if bias is None:
        dq = kernels.flash_bwd_dq(q, k, v, do, lse, delta, sc, causal)
        dk, dv = kernels.flash_bwd_dkv(q, k, v, do, lse, delta, sc, causal)
        return dq, dk, dv, None
    dq = kernels.flash_bwd_dq_bias(q, k, v, do, lse, delta, bias, sc, causal)
    return (dq,) + kernels.flash_bwd_dkv_bias(q, k, v, do, lse, delta, bias,
                                              sc, causal)


TWO_PASS_CASES = ([(b, h, sq, sk, d, causal, None)
                   for b, h, sq, sk, d in FLASH_SHAPES
                   for causal in (False, True)]
                  + [(b, h, sq, sk, d, causal, kind)
                     for b, h, sq, sk, d, causal, kind in BIAS_SHAPES])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,sq,sk,d,causal,kind", TWO_PASS_CASES)
def test_two_pass_kernels_match_plain(dev, b, h, sq, sk, d, causal, kind,
                                      dtype):
    """K7/K8 (bias) against their plain versions on the K4 forward's lse,
    one launch each, and K9 (bias) on the same inputs within the same
    tolerance. With one key the exact gradients are zero (p = 1, dp =
    delta) and both sides are rounding noise of order 1e-7: there errors
    are held against the inputs' scale (standard normal, so 1) instead of
    the output's."""
    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    q, k, v, do = _two_pass_inputs(dev, b, h, sq, sk, d, dtype,
                                   5 * sq + sk + d)
    bias = None if kind is None else _bias(kind, b, sk, sq + 2 * sk, dev)
    sc = d ** -0.5
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    out, lse = (kernels.flash_fwd(q, k, v, sc, causal) if bias is None else
                kernels.flash_fwd_bias(q, k, v, bias, sc, causal))
    delta = kernels.flash_delta(out, do)
    before = kernels.launch_counts()
    grads = _two_pass(kernels, q, k, v, do, lse, delta, bias, sc, causal)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    tag = "" if bias is None else "_bias"
    for n in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert after[n + tag] == before[n + tag] + 1, n + tag
    assert after["flash_bwd" + tag] == before["flash_bwd" + tag]
    f = [t.float() for t in (q, k, v, do)]
    dq_p = pf.flash_bwd_dq_plain(*f, lse, delta, sc, causal, bias)
    dk_p, dv_p, db_p = pf.flash_bwd_dkv_plain(*f, lse, delta, sc, causal,
                                              bias)
    fused = (kernels.flash_bwd(q, k, v, do, lse, delta, sc, causal)
             if bias is None else
             kernels.flash_bwd_bias(q, k, v, do, lse, delta, bias, sc,
                                    causal))
    floor = 1.0 if sk == 1 else 1e-6
    for name, a, p, fz in zip(("dq", "dk", "dv"), grads, (dq_p, dk_p, dv_p),
                              fused):
        assert a.dtype == dtype and a.shape == p.shape
        _rel_close(a, p, tol, name, floor)
        _rel_close(a, fz.float(), tol, name + " vs K9", floor)
    if bias is not None:
        assert grads[3].shape == (b * h, sk)
        _rel_close(grads[3], db_p, tol, "dbias", floor)


REPRO_CASES = {  # (b, h, sq, sk, d, causal, bias kind)
    "plain": (2, 4, 1000, 1000, 64, True, None),
    "bias": (2, 4, 1000, 1000, 64, True, "lengths"),
    "d32": (2, 4, 1000, 1000, 32, True, None),
    "d128-bias": (1, 2, 1000, 1000, 128, True, "lengths"),
    "dead-rows": (2, 2, 300, 200, 64, True, None),
    "dead-rows-bias": (2, 2, 300, 200, 64, True, "lengths"),
    "masked-batch-row": (2, 4, 256, 256, 32, False, "dead_row"),
    "masked-batch-row-causal": (2, 4, 256, 256, 128, True, "dead_row"),
    # q tiles wholly before Sk's horizon: blocks whose key loop is empty
    "empty-key-loop": (2, 2, 600, 100, 64, True, None),
    "empty-key-loop-bias": (2, 2, 600, 100, 64, True, "lengths"),
}


@pytest.mark.parametrize("case", list(REPRO_CASES))
def test_two_pass_is_bitwise_reproducible(dev, case):
    """No atomics: two launches on the same bf16 inputs give the same
    bits, at D 32, 64 and 128, with dead rows (causal Sq > Sk; their dq is
    zero, also in q tiles that see no key at all) and with a fully masked
    batch row."""
    from paddle_tpu_torch.ops import kernels

    b, h, sq, sk, d, causal, kind = REPRO_CASES[case]
    q, k, v, do = _two_pass_inputs(dev, b, h, sq, sk, d, torch.bfloat16, 11)
    bias = None if kind is None else _bias(kind, b, sk, 3, dev)
    sc = d ** -0.5
    out, lse = (kernels.flash_fwd(q, k, v, sc, causal) if bias is None else
                kernels.flash_fwd_bias(q, k, v, bias, sc, causal))
    delta = kernels.flash_delta(out, do)
    first = _two_pass(kernels, q, k, v, do, lse, delta, bias, sc, causal)
    second = _two_pass(kernels, q, k, v, do, lse, delta, bias, sc, causal)
    for a, b_ in zip(first, second):
        assert (a is None) == (b_ is None)
        if a is not None:
            assert torch.isfinite(a).all()
            assert torch.equal(a, b_)
    if causal and sq > sk:  # dq is written, as zeros, for the dead rows
        assert not first[0][:, :, :sq - sk].any()


@pytest.mark.parametrize("b,h,sq,sk,d,causal,kind", TWO_PASS_CASES)
def test_two_pass_dkv_bf16_equals_fused(dev, b, h, sq, sk, d, causal, kind):
    """The bf16 K8 (bias) is the bf16 K9 (bias)'s body without its dq: the
    same per-tile arithmetic in the same q-tile order, so its dk, dv and
    dbias equal K9's bit for bit on the same inputs."""
    from paddle_tpu_torch.ops import kernels

    q, k, v, do = _two_pass_inputs(dev, b, h, sq, sk, d, torch.bfloat16,
                                   5 * sq + sk + d)
    bias = None if kind is None else _bias(kind, b, sk, sq + 2 * sk, dev)
    sc = d ** -0.5
    if bias is None:
        out, lse = kernels.flash_fwd(q, k, v, sc, causal)
        delta = kernels.flash_delta(out, do)
        dkv = kernels.flash_bwd_dkv(q, k, v, do, lse, delta, sc, causal)
        fused = kernels.flash_bwd(q, k, v, do, lse, delta, sc, causal)[1:]
    else:
        out, lse = kernels.flash_fwd_bias(q, k, v, bias, sc, causal)
        delta = kernels.flash_delta(out, do)
        dkv = kernels.flash_bwd_dkv_bias(q, k, v, do, lse, delta, bias, sc,
                                         causal)
        fused = kernels.flash_bwd_bias(q, k, v, do, lse, delta, bias, sc,
                                       causal)[1:]
    torch.cuda.synchronize()
    assert len(dkv) == len(fused)
    for what, a, f in zip(("dk", "dv", "dbias"), dkv, fused):
        assert torch.equal(a, f), f"{what} differs from K9's"


def _bf16_step(x):
    """The spacing of bfloat16 values at |x| (0 where x is 0)."""
    m, e = torch.frexp(x.float().abs())
    return torch.where(m == 0, torch.zeros_like(m),
                       torch.ldexp(torch.ones_like(m), e - 8))


@pytest.mark.parametrize("b,h,sq,sk,d,causal,kind", TWO_PASS_CASES)
def test_two_pass_dq_bf16_matches_fused(dev, b, h, sq, sk, d, causal, kind):
    """The bf16 K7 (bias) forms p and ds as the bf16 K9 (bias) does and
    rounds the same bf16 dS into its dS.K product; the two differ only in
    the order of their float32 sums (K9 adds its key tiles through bulk
    reductions) and in the rounding of their S products. So each dq
    element lies within 5e-3 of K9's largest magnitude plus one bf16
    rounding step at that element: two float32 sums that straddle a
    rounding boundary round one step apart, which near a power of two is
    up to 2^-7 (7.8e-3) of the largest magnitude, past 5e-3 alone."""
    from paddle_tpu_torch.ops import kernels

    q, k, v, do = _two_pass_inputs(dev, b, h, sq, sk, d, torch.bfloat16,
                                   5 * sq + sk + d)
    bias = None if kind is None else _bias(kind, b, sk, sq + 2 * sk, dev)
    sc = d ** -0.5
    if bias is None:
        out, lse = kernels.flash_fwd(q, k, v, sc, causal)
        delta = kernels.flash_delta(out, do)
        dq = kernels.flash_bwd_dq(q, k, v, do, lse, delta, sc, causal)
        fused = kernels.flash_bwd(q, k, v, do, lse, delta, sc, causal)[0]
    else:
        out, lse = kernels.flash_fwd_bias(q, k, v, bias, sc, causal)
        delta = kernels.flash_delta(out, do)
        dq = kernels.flash_bwd_dq_bias(q, k, v, do, lse, delta, bias, sc,
                                       causal)
        fused = kernels.flash_bwd_bias(q, k, v, do, lse, delta, bias, sc,
                                       causal)[0]
    torch.cuda.synchronize()
    assert dq.dtype == torch.bfloat16 and torch.isfinite(dq).all()
    err = (dq.float() - fused.float()).abs()
    floor = 1.0 if sk == 1 else 1e-6
    scale = max(fused.float().abs().max().item(), floor)
    over = err - (5e-3 * scale + _bf16_step(fused))
    assert over.max().item() <= 0, (
        f"dq: max abs diff {err.max().item():.3g} from K9's, past 5e-3 x "
        f"{scale:.3g} plus one bf16 step by {over.max().item():.3g}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_two_pass_takes_the_lse_it_is_given(dev, dtype):
    """The LSE and delta of attention over [k0; k1], the kernels run on k1
    alone (a ring block): the plain versions on the same arguments, and
    with k0's share the full backward (dq summed, dk/dv concatenated)."""
    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    b, h, sq, sk, d = 2, 2, 192, 128, 64
    q, k, v, do = _two_pass_inputs(dev, b, h, sq, 2 * sk, d, dtype, 17)
    sc = d ** -0.5
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    out, lse = kernels.flash_fwd(q, k, v, sc, False)
    delta = kernels.flash_delta(out, do)
    halves = [(k[:, :, i * sk:(i + 1) * sk].contiguous(),
               v[:, :, i * sk:(i + 1) * sk].contiguous()) for i in (0, 1)]
    parts = [_two_pass(kernels, q, kh, vh, do, lse, delta, None, sc, False)
             for kh, vh in halves]
    f = [t.float() for t in (q, halves[1][0], halves[1][1], do)]
    dq_p = pf.flash_bwd_dq_plain(*f, lse, delta, sc, False)
    dk_p, dv_p, _ = pf.flash_bwd_dkv_plain(*f, lse, delta, sc, False)
    for name, a, p in zip(("dq", "dk", "dv"), parts[1], (dq_p, dk_p, dv_p)):
        _rel_close(a, p, tol, name)
    full = kernels.flash_bwd(q, k, v, do, lse, delta, sc, False)
    _rel_close(parts[0][0].float() + parts[1][0].float(), full[0].float(),
               tol, "dq summed over the blocks")
    _rel_close(torch.cat([parts[0][1], parts[1][1]], 2), full[1].float(),
               tol, "dk")
    _rel_close(torch.cat([parts[0][2], parts[1][2]], 2), full[2].float(),
               tol, "dv")


def test_long_padded_step_launches_the_two_pass_kernels(dev):
    """A 2-layer GPT-2 layout at S = 13312 (13 x 1024, past the
    reference's switch at S = 13108 for D = 64), padded to 9000 tokens: one
    float32 loss and backward launch K4 bias, K6, K7 bias and K8 bias once
    per layer, and no K9."""
    from paddle_tpu_torch.models.gpt2 import GPT2Config, build_train_step
    from paddle_tpu_torch.models.gpt2 import logits
    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.loss import cross_entropy

    S, n = 13312, 9000
    cfg = GPT2Config(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_heads=2, max_position=S, dropout=0.0)
    assert pf.uses_two_pass(S, 64) and not pf.uses_two_pass(13107, 64)
    _loss_fn, init_params = build_train_step(cfg, device=dev)
    params = init_params()
    rs = np.random.RandomState(3)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (1, S))).to(dev)
    labels = ids.clone()
    labels[:, n:] = -100
    mask = torch.zeros(1, 1, 1, S, device=dev)
    mask[..., n:] = -1e30
    kernels.reset_launch_counts()
    lg = logits(params, cfg, ids, attn_mask=mask)
    loss = cross_entropy(lg.reshape(-1, cfg.vocab_size), labels.reshape(-1))
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                        for g in grads)
    for name in ("flash_fwd_bias", "flash_delta", "flash_bwd_dq_bias",
                 "flash_bwd_dkv_bias"):
        assert counts[name] == cfg.num_layers, (name, counts)
    for name in ("flash_fwd", "flash_bwd", "flash_bwd_bias", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        assert counts[name] == 0, (name, counts)


# ---- the head-dim route and the sampler ------------------------------------

@pytest.mark.parametrize("d", [16, 48, 64])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "bias"])
def test_sdpa_head_dim_route_on_card_matches_cpu(dev, d, masked):
    """D 16 and 48 (no kernel takes them) compute on the card through
    `dense_attention` and match the CPU, launching no flash kernel; D 64
    still launches K4 (bias) once, as before."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import scaled_dot_product_attention

    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(2, 3, 40, d, generator=g) for _ in range(3))
    mask = None
    if masked:
        mask = torch.zeros(2, 1, 1, 40)
        mask[1, ..., 30:] = -1e9
    ref, _ = scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          is_causal=not masked)
    kernels.reset_launch_counts()
    out, _ = scaled_dot_product_attention(
        q.to(dev), k.to(dev), v.to(dev),
        attn_mask=None if mask is None else mask.to(dev),
        is_causal=not masked)
    counts = kernels.launch_counts()
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)
    fwd = "flash_fwd_bias" if masked else "flash_fwd"
    assert counts[fwd] == (1 if d == 64 else 0), counts
    assert sum(counts.values()) == counts[fwd], counts


def test_prng_on_card_equals_cpu(dev):
    """The threefry keys, random bits and uniforms bitwise, and the
    Gumbel noise within 4 ulp (of max(|g|, 1)), card vs CPU."""
    from paddle_tpu_torch.sampling import prng

    seeds = torch.tensor([0, 1, 2**31, 2**32 - 1, 7, 123456789],
                         dtype=torch.int64)
    steps = torch.tensor([0, 1, 31, 2**31 - 1, 5, 9], dtype=torch.int64)
    out = {}
    for d in ("cpu", dev):
        keys = prng.fold_in_keys(seeds.to(d), steps.to(d))
        out[str(d)] = [x.cpu() for x in (keys, prng.random_bits(keys, 50257),
                                         prng.uniform(keys, 50257),
                                         prng.gumbel(keys, 50257))]
    (kh, bh, uh, gh), (kc, bc, uc, gc) = out["cpu"], out[str(dev)]
    assert torch.equal(kc, kh) and torch.equal(bc, bh)
    assert torch.equal(uc.view(torch.int32), uh.view(torch.int32))
    ulp = np.spacing(np.maximum(gh.abs().numpy(), 1.0).astype(np.float32))
    assert (np.abs(gc.double().numpy() - gh.double().numpy()) / ulp).max() \
        <= 4


@pytest.mark.parametrize("mode", [(False, False), (True, False),
                                  (False, True), (True, True)])
def test_sample_tokens_on_card_equals_cpu(dev, mode):
    """One [8, 1000] float32 logits array through the whole pipeline on
    the card and on the CPU: identical tokens, and an identical count
    update."""
    from paddle_tpu_torch.sampling import SamplingParams, SlotParamStore
    from paddle_tpu_torch.sampling import processors as proc

    V = 1000
    rs = np.random.RandomState(3)
    logits = (rs.randn(8, V) * 2).astype(np.float32)
    prompts = [rs.randint(0, V, 40) for _ in range(8)]
    rows = [dict(), dict(top_k=20), dict(top_p=0.9), dict(min_p=0.05),
            dict(top_k=50, top_p=0.8), dict(), dict(top_p=0.95),
            dict(min_p=0.1, top_k=5)]
    toks = {}
    for d in ("cpu", dev):
        store = SlotParamStore(8, V, d)
        for i, kw in enumerate(rows):
            if mode[0] and i % 4:
                kw = dict(kw, temperature=0.5 + 0.25 * i)
            if mode[1] and i % 3:
                kw = dict(kw, repetition_penalty=1.2, presence_penalty=0.3,
                          frequency_penalty=0.1 * i)
            store.set_slot(i, SamplingParams(**kw), 50 + i,
                           prompt_ids=prompts[i])
        sp, got = store.step_args(np.arange(8, dtype=np.int32) * 3)
        assert got == mode
        tok = proc.sample_tokens(torch.from_numpy(logits).to(d), sp,
                                 sampled=mode[0], penalties=mode[1])
        counts = (proc.update_counts(sp["counts"], torch.arange(8, device=d),
                                     tok, torch.ones(8, dtype=torch.bool,
                                                     device=d))
                  if mode[1] else None)
        toks[str(d)] = (tok.cpu(), None if counts is None else counts.cpu())
    (th, ch), (tc, cc) = toks["cpu"], toks[str(dev)]
    assert torch.equal(tc, th)
    assert (cc is None) == (ch is None)
    if cc is not None:
        assert torch.equal(cc, ch)


def test_sample_tokens_makes_no_host_sync(dev):
    """The sampled pipeline with penalties reads nothing back to the host
    (the decode step can be captured with it inside), and the multi-step
    decode threads its counts on the card."""
    from paddle_tpu_torch.sampling import SamplingParams, SlotParamStore
    from paddle_tpu_torch.sampling import processors as proc

    V = 50257
    store = SlotParamStore(8, V, dev)
    for i in range(8):
        store.set_slot(i, SamplingParams(temperature=0.8, top_p=0.95,
                                         top_k=50 * i, min_p=0.01,
                                         presence_penalty=0.5), i,
                       prompt_ids=[i, 2 * i])
    sp, mode = store.step_args(np.arange(8, dtype=np.int32))
    logits = torch.randn(8, V, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok = proc.sample_tokens(logits, sp, sampled=True, penalties=True)
        counts = proc.update_counts(sp["counts"], torch.arange(8, device=dev),
                                    tok, torch.ones(8, dtype=torch.bool,
                                                    device=dev))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert mode == (True, True)
    assert int(counts.sum()) == int(sp["counts"].sum()) + 8
