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
dq is zero). The float16 instances of K4, K6, K9, K7 and K8 (plain and
bias) hold their plain versions on the same float16 tensors within
5e-3, K9's and K8's dk, dv and dbias bitwise over launches and equal to
each other, each launch on its float16 counter; K1 and K2 refuse
float16. Every flash wrapper takes B * H = 65536, past grid y's
65535. The prefix cache's copy-on-write (`PagedKVCache.prepare_write`)
copies a block bit for bit, float32, bf16 and int8 (codes with scales),
with no host synchronisation, and the host tier returns an int8 block
bit for bit through page-locked memory (a dense one within its codec's
bound). The decode graphs (`nn/decode_graph.py`) equal the eager loop
bit for bit over a capture and two replays (tokens, stops, counts,
every pool element) at k 1, 4 and 8, greedy, sampled, penalties and
both, dense and int8 pools, bf16 and W8A16 weights; a replay's launch
counts equal the eager loop's, its penalty counts thread through three
dispatches, it makes no host synchronisation, a replaced pool gets a
new capture, and the server replays one graph per decode dispatch.
Speculation and the unified round: K1 on verify windows (P 8 x W 9,
pad rows zeros, the plain version on the rows with pos >= 0, bitwise
over two launches); the verify graph and the window-round graph (carry
chained) equal the eager programs bit for bit over a capture and two
replays, with the eager launch counts and no host synchronisation; the
speculating server (split, unified, async) gives the CPU's tokens in
float32; and an async engine's dispatches make no host synchronisation.
The seq2seq Transformer: K4 at one query (Sq = 1, the cached decode
step) over 1 to 255 keys at D 32, 64 and 128 against its plain version,
bitwise over two launches; the cached decoder on the card against the
CPU (float32, head dim 32: step logits, greedy and beam tokens); and a
bf16 cached decode that launches K4 two times a layer a step at Sq = 1
and never calls the dense path. Offline generation: the dense decode
program's graph equals its eager run on the card bit for bit (bf16,
W8A16, int8 KV, sampled; left-padded rows), temperatures 0.7, 1.3 and
0.0 capture two graphs and a repeat none, the dense and the paged
generate give the CPU's tokens in float32 (the paged one launching K2
once a layer a step), and an exported generator loaded onto the card
serves GenerationServer's rows as each prompt's generate. Parallel
training: two ranks sharing the card over gloo run the ring's flash
forward and backward (K4, K6, K7, K8 a ring step) against
flash_attention on one rank, float32 and bf16; NCCL asked for with more
ranks than cards raises; a CUDA all-to-all staged through host memory
gives the CPU all-to-all's bits. The fleet: two ranks' ZeRO-3 step (its
reduce-scatter and all-gather staged through the host) and
SyncBatchNorm on the card give the CPU world's numbers within 1e-5 of
their magnitude. The serving fleet's engine hooks on a card pool, dense
and int8: `run_host_op` runs on the engine thread, `export_session`
swaps a held session out mid-stream and `import_kv_payload` installs it
in a second server (an int8 payload's blocks equal bit for bit after the
import, also through the wire codec); the target resumes with no
prefill, launches K1 and K2, and gives the one-server run's tokens.

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


# float16: the five flash kernels' float16 instances (the sm90 kernels of
# the bf16 path, instantiated on __half) at aligned, ragged and Sq != Sk
# shapes, plain and with every bias kind, against the plain versions on
# the same float16 tensors (which round p and ds to float16 as the
# kernels do): within 5e-3 of the plain output's largest magnitude (bf16's
# limit is 2e-2; float16 has 8x its mantissa), LSE and delta within 1e-4;
# K9's and K8's dk, dv and dbias bitwise over two launches and K8's equal
# to K9's; each launch on the float16 counter only.
F16_CASES = [(2, 3, 128, 128, 32, True, None),
             (1, 2, 200, 200, 64, False, None),
             (2, 2, 300, 200, 64, True, None),
             (1, 2, 1000, 1000, 128, True, None),
             (2, 4, 300, 300, 32, True, "lengths"),
             (2, 4, 256, 256, 128, False, "broadcast"),
             (2, 4, 256, 256, 64, True, "dead_row"),
             (1, 2, 384, 256, 128, True, "lengths")]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,kind", F16_CASES)
def test_flash_float16_kernels_match_plain(dev, b, h, sq, sk, d, causal,
                                           kind):
    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    q, k, v, do = _two_pass_inputs(dev, b, h, sq, sk, d, torch.float16,
                                   7 * sq + sk + d)
    bias = None if kind is None else _bias(kind, b, sk, sq + 2 * sk, dev)
    sc = d ** -0.5
    sfx = "" if bias is None else "_bias"
    kernels.reset_launch_counts()
    if bias is None:
        out, lse = kernels.flash_fwd(q, k, v, sc, causal)
    else:
        out, lse = kernels.flash_fwd_bias(q, k, v, bias, sc, causal)
    delta = kernels.flash_delta(out, do)

    def fused():
        if bias is None:
            return kernels.flash_bwd(q, k, v, do, lse, delta, sc,
                                     causal) + (None,)
        return kernels.flash_bwd_bias(q, k, v, do, lse, delta, bias, sc,
                                      causal)

    first, again = fused(), fused()
    two = _two_pass(kernels, q, k, v, do, lse, delta, bias, sc, causal)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {f"flash_fwd{sfx}_f16": 1, "flash_delta_f16": 1,
            f"flash_bwd{sfx}_f16": 2, f"flash_bwd_dq{sfx}_f16": 1,
            f"flash_bwd_dkv{sfx}_f16": 1}
    assert {n: c for n, c in counts.items() if c} == want
    out_p, lse_p = pf.flash_fwd_lse_plain(q, k, v, sc, causal, bias)
    assert out.dtype == torch.float16
    _rel_close(out, out_p, 5e-3, "out")
    live = lse_p > -1e29
    _rel_close(lse[live], lse_p[live], 1e-4, "lse")
    _rel_close(delta, pf.flash_delta_plain(out, do), 1e-4, "delta")
    plain = pf.flash_bwd_plain(q, k, v, do, lse, delta, sc, causal, bias)
    for what, a, a2, t, p in zip(("dq", "dk", "dv", "dbias"), first, again,
                                 two, plain):
        if p is None:
            assert a is None and t is None
            continue
        if what != "dq":
            assert torch.equal(a, a2), f"K9 {what} differs between launches"
            assert torch.equal(a, t), f"K8 {what} differs from K9's"
        assert a.dtype == (torch.float32 if what == "dbias"
                           else torch.float16)
        _rel_close(a, p, 5e-3, what)
        _rel_close(t, p, 5e-3, what + " (two-pass)")


def test_paged_kernels_refuse_float16(dev):
    """K1 and K2 take float32 and bfloat16 only: the reference's serving
    names no float16 (`kernels.POOL_DTYPE_CODES`)."""
    from paddle_tpu_torch.ops import kernels

    q = torch.zeros(1, 2, 64, device=dev, dtype=torch.float16)
    pool = torch.zeros(2, 4, 2, 64, device=dev, dtype=torch.float16)
    tables = torch.ones(1, 1, dtype=torch.int32, device=dev)
    ones = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernels.paged_decode(q, pool, pool, tables, ones, 0.125)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernels.ragged_stream(q, pool, pool, tables, ones * 0, ones * 0,
                              0.125)


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


def test_gumbel_noise_on_card_is_the_cpus_bit_for_bit(dev):
    """The noise's logs are IEEE-exact float64 arithmetic
    (`prng._log`), so card and CPU give the same bits: phase 4s's rows."""
    from paddle_tpu_torch.sampling import prng

    seeds = torch.tensor([0, 1, 2**31, 2**32 - 1, 7, 123456789, 5, 2**30],
                         dtype=torch.int64)
    steps = torch.tensor([0, 1, 31, 2**31 - 1, 5, 9, 0, 3],
                         dtype=torch.int64)
    g = [prng.gumbel(prng.fold_in_keys(seeds.to(d), steps.to(d)),
                     50257).cpu() for d in ("cpu", dev)]
    assert torch.equal(g[0].view(torch.int32), g[1].view(torch.int32))


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


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_prepare_write_makes_no_host_sync(dev, kind):
    """The prefix cache's copy-on-write runs on the card's stream with no
    host read (it sits between the table build and the dispatch), and
    the new block equals its source bit for bit in every layer: codes
    and scales together for an int8 pool."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache

    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    c = PagedKVCache(3, 4, 32, block_size=8, num_blocks=8, dtype=dtype,
                     kv_dtype="int8" if kind == "int8" else None,
                     device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    for kv in (c.k_blocks, c.v_blocks):
        if kind == "int8":
            kv.codes.copy_(torch.randint(-127, 128, kv.codes.shape,
                                         generator=g, device=dev))
            kv.scales.copy_(torch.rand(kv.scales.shape, generator=g,
                                       device=dev))
        else:
            kv.copy_(torch.randn(kv.shape, generator=g, device=dev))
    toks = np.arange(1, 13, dtype=np.int32)
    c.allocate("a", 12)
    c.publish_prefix("a", toks)
    assert c.attach_prefix("b", toks) == 11
    src = c.block_table("b")[1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert c.prepare_write("b", 11) is True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    new = c.block_table("b")[1]
    assert new != src and c.block_table("a")[1] == src
    for kv in (c.k_blocks, c.v_blocks):
        leaves = (kv.codes, kv.scales) if kind == "int8" else (kv,)
        for a in leaves:
            assert torch.equal(a[:, new], a[:, src])


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
def test_tier_round_trip_on_card(dev, kv_dtype):
    """Demotion to page-locked host memory and promotion back by an
    asynchronous copy: an int8 block returns bit for bit, a dense bf16
    block within absmax/254 per vector (its kv_encode codes) plus the
    bf16 roundings of its scale and product, and equal to the CPU
    pool's promotion of the same rows."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache
    from paddle_tpu_torch.inference.kv_tier import HostKVTier

    pools = {}
    for d in (dev, "cpu"):
        c = PagedKVCache(2, 4, 32, block_size=8, num_blocks=8,
                         dtype=torch.bfloat16, kv_dtype=kv_dtype, device=d,
                         tier=HostKVTier(capacity_blocks=8, watermark=0.0))
        c.allocate("a", 20)
        g = torch.Generator().manual_seed(4)
        for kv in (c.k_blocks, c.v_blocks):
            if kv_dtype == "int8":
                kv.codes.copy_(torch.randint(-127, 128, kv.codes.shape,
                                             generator=g))
                kv.scales.copy_(torch.rand(kv.scales.shape, generator=g))
            else:
                kv.copy_(torch.randn(kv.shape, generator=g))
        pools[d] = c
    c = pools[dev]
    ids = np.arange(100, 120, dtype=np.int32)
    table = c.block_table("a")
    before = [(kv.codes[:, table].cpu(), kv.scales[:, table].cpu())
              if kv_dtype else (kv[:, table].cpu(),)
              for kv in (c.k_blocks, c.v_blocks)]
    for p in pools.values():
        p.publish_prefix("a", ids)
        p.free("a")
        assert p.demote_cold(8) == 3
        assert all(pay.codes.is_pinned() for _f, _p, pay, _v
                   in p.tier._entries.values()) == (p is c)
        assert p.match_prefix_len(ids) == 19
        assert p.attach_prefix("b", ids) == 19
    table = c.block_table("b")
    assert table == pools["cpu"].block_table("b")
    for i, kv in enumerate((c.k_blocks, c.v_blocks)):
        cpu_kv = (pools["cpu"].k_blocks, pools["cpu"].v_blocks)[i]
        if kv_dtype == "int8":
            for j, a in enumerate((kv.codes, kv.scales)):
                for bi, b in enumerate(table):
                    rows = min(8, 20 - 8 * bi)
                    assert torch.equal(a[:, b, :rows].cpu(),
                                       before[i][j][:, bi, :rows])
        else:
            for bi, b in enumerate(table):
                rows = min(8, 20 - 8 * bi)
                got = kv[:, b, :rows].float().cpu()
                old = before[i][0][:, bi, :rows].float()
                amax = old.abs().amax(-1, keepdim=True)
                # absmax/254 of the codes, plus the bf16 rounding of the
                # scale (127 codes x 2^-8 of it) and of code * scale
                bound = amax / 254 + amax / 256 + got.abs() / 256
                assert ((got - old).abs() <= bound).all()
                assert torch.equal(kv[:, b, :rows].cpu(),
                                   cpu_kv[:, b, :rows])


# ---- decode graphs (nn/decode_graph.py) -------------------------------------

GRAPH_MODES = {"greedy": (False, False), "sampled": (True, False),
               "penalties": (False, True), "both": (True, True)}


def _graph_side(dev, cfg, kv_dtype, dtype, mode, seed=0):
    """A pool with random contents, a slot store in `mode` (row 1 with
    three stop ids: a stop matrix 4 wide) and the first dispatch's
    inputs, for 4 slots of which slot 2 is idle."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache
    from paddle_tpu_torch.sampling import SamplingParams, SlotParamStore

    H, Dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    cache = PagedKVCache(cfg.num_layers, H, Dh, block_size=4, num_blocks=96,
                         dtype=dtype, kv_dtype=kv_dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for kv in (cache.k_blocks, cache.v_blocks):
        if kv_dtype:
            kv.codes.copy_(torch.randint(-127, 128, kv.codes.shape,
                                         generator=g, device=dev))
            kv.scales.copy_(torch.rand(kv.scales.shape, generator=g,
                                       device=dev) * 0.02)
        else:
            kv.copy_(torch.randn(kv.shape, generator=g, device=dev))
    lens = [37, 5, 1, 60]
    cache.ensure_many([(b, lens[b] + 24) for b in range(4)])
    tables = torch.from_numpy(cache.table_array(range(4), 24)).to(dev)
    store = SlotParamStore(4, cfg.vocab_size, dev)
    rs = np.random.RandomState(seed)
    for b in range(4):
        kw = {}
        if mode[0] and b != 0:
            kw.update(temperature=0.8, top_p=0.9, top_k=40 * b)
        if mode[1] and b != 3:
            kw.update(repetition_penalty=1.3, presence_penalty=0.4,
                      frequency_penalty=0.2)
        if b == 1:
            kw.update(stop_token_ids=(3, 7, 11))
        store.set_slot(b, SamplingParams(**kw), 100 + b,
                       prompt_ids=rs.randint(0, cfg.vocab_size, lens[b]))
    tok = torch.from_numpy(rs.randint(0, cfg.vocab_size, 4).astype(
        np.int32)).to(dev)
    pos = torch.tensor([n - 1 for n in lens], dtype=torch.int32, device=dev)
    act = torch.tensor([True, True, False, True], device=dev)
    return cache, store, tok, pos, act, tables


def _graph_leaves(cache):
    return [t for kv in (cache.k_blocks, cache.v_blocks)
            for t in ((kv.codes, kv.scales) if hasattr(kv, "codes")
                      else (kv,))]


def _graph_model(dev, w8, dtype=torch.bfloat16):
    from paddle_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from paddle_tpu_torch.nn.decode import PagedDecoder

    cfg = GPT2Config(vocab_size=1000, hidden_size=128, num_layers=2,
                     num_heads=4, max_position=256)
    model = GPT2(cfg, seed=3, dtype=dtype, device=dev)
    params = model.quantize_weights() if w8 else model.flat_params()
    return cfg, params, PagedDecoder


def _graph_run(dev, cfg, params, dec, k, mode, side, graph, n=3):
    """n dispatches of k tokens (each fed the last one's tokens at
    pos + k, the counts swapped back into the store); returns the
    outputs of each dispatch."""
    cache, store, tok, pos, act, tables = side
    outs = []
    steps = np.zeros(4, np.int32)
    for _ in range(n):
        sp, got = store.step_args(steps)
        assert got == mode
        args = (params, tok, pos, act, tables, cache.k_blocks,
                cache.v_blocks, sp)
        if graph:
            toks, stops, _kc, _vc, counts = dec.graphs(k, mode, *args)
        else:
            toks, stops, _kc, _vc, counts = dec.multistep(k, mode)(*args)
        outs.append((toks.clone(), stops.clone(),
                     None if counts is None else counts.clone()))
        store.swap_counts(counts)
        tok, pos, steps = toks[-1].clone(), pos + k, steps + k
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("w8", [False, True], ids=["bf16", "w8a16"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
@pytest.mark.parametrize("mode", list(GRAPH_MODES))
@pytest.mark.parametrize("k", [1, 4, 8])
def test_decode_graph_equals_eager_bitwise(dev, k, mode, kv_dtype, w8):
    """Three dispatches through one captured graph (a capture, then two
    pure replays on new inputs) against the eager loop on a copy of the
    same pool: tokens, stops, counts, the store's counts and every pool
    element equal bit for bit."""
    cfg, params, Dec = _graph_model(dev, w8)
    m = GRAPH_MODES[mode]
    sides = [_graph_side(dev, cfg, kv_dtype, torch.bfloat16, m)
             for _ in range(2)]
    dec = Dec.for_config(cfg, 4, kv_dtype=kv_dtype)
    eager = _graph_run(dev, cfg, params, dec, k, m, sides[0], False)
    graph = _graph_run(dev, cfg, params, dec, k, m, sides[1], True)
    assert dec.graphs.captures == 1 and dec.graphs.replays == 3
    for (te, se, ce), (tg, sg, cg) in zip(eager, graph):
        assert te.shape == (k, 4)
        assert torch.equal(te, tg) and torch.equal(se, sg)
        assert (ce is None) == (cg is None) == (not m[1])
        assert ce is None or torch.equal(ce, cg)
        assert (te[:, 2] == 0).all()  # the idle slot emits 0
    for a, b in zip(_graph_leaves(sides[0][0]), _graph_leaves(sides[1][0])):
        assert torch.equal(a, b)
    if m[1]:
        assert torch.equal(sides[0][1].counts, sides[1][1].counts)


def test_decode_graph_launch_counts_equal_eager(dev):
    """A replay adds what its capture counted: one dispatch's launches
    read as the eager loop's (K2 once a layer a step), and the capture
    itself adds nothing beyond its eager warm-up."""
    from paddle_tpu_torch.ops import kernels

    cfg, params, Dec = _graph_model(dev, False)
    m = GRAPH_MODES["greedy"]
    dec = Dec.for_config(cfg, 4)
    counts = {}
    for graph in (False, True):
        side = _graph_side(dev, cfg, None, torch.bfloat16, m)
        if graph:  # capture first, then count pure replays
            _graph_run(dev, cfg, params, dec, 4, m, side, True, n=1)
        kernels.reset_launch_counts()
        _graph_run(dev, cfg, params, dec, 4, m, side, graph, n=2)
        counts[graph] = kernels.launch_counts()
    assert counts[True] == counts[False]
    assert counts[True]["paged_decode_dense"] == 2 * 4 * cfg.num_layers
    kernels.reset_launch_counts()
    side = _graph_side(dev, cfg, None, torch.bfloat16, m, seed=1)
    _graph_run(dev, cfg, params, Dec.for_config(cfg, 4), 4, m, side, True,
               n=1)  # warm-up (4 x L) + replay (4 x L); the capture none
    assert kernels.launch_counts()["paged_decode_dense"] == \
        2 * 4 * cfg.num_layers


def test_penalty_counts_after_three_graph_dispatches(dev):
    """The count buffer threads through three replays as through the
    eager loop, and stays the store's own tensor."""
    cfg, params, Dec = _graph_model(dev, False)
    m = GRAPH_MODES["both"]
    stores = []
    for graph in (False, True):
        side = _graph_side(dev, cfg, "int8", torch.bfloat16, m, seed=4)
        buf = side[1].counts
        before = buf.clone()
        _graph_run(dev, cfg, params, Dec.for_config(cfg, 4, kv_dtype="int8"),
                   2, m, side, graph)
        assert side[1].counts is buf
        stores.append(side[1].counts)
    assert torch.equal(stores[0], stores[1])
    # 3 dispatches x k 2 x the 3 active rows (the idle row adds none)
    assert int((stores[1] - before).sum()) == 3 * 2 * 3


def test_decode_graph_replay_makes_no_host_sync(dev):
    cfg, params, Dec = _graph_model(dev, True)
    m = GRAPH_MODES["both"]
    side = _graph_side(dev, cfg, "int8", torch.bfloat16, m)
    cache, store, tok, pos, act, tables = side
    dec = Dec.for_config(cfg, 4, kv_dtype="int8")
    sp, _ = store.step_args(np.zeros(4, np.int32))
    args = (params, tok, pos, act, tables, cache.k_blocks, cache.v_blocks, sp)
    dec.graphs(8, m, *args)  # the capture is not under test
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = dec.graphs(8, m, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out[0].shape == (8, 4) and dec.graphs.captures == 1


def test_decode_graph_recaptures_for_a_replaced_pool(dev):
    """A new pool is a new key, so a new capture that writes the new
    pool (the old graph, which holds the old pool, is never replayed
    against it); the old pool's graph is still found."""
    cfg, params, Dec = _graph_model(dev, False)
    m = GRAPH_MODES["greedy"]
    dec = Dec.for_config(cfg, 4)
    first = _graph_side(dev, cfg, None, torch.bfloat16, m)
    _graph_run(dev, cfg, params, dec, 4, m, first, True, n=1)
    assert dec.graphs.captures == 1
    second, ref = (_graph_side(dev, cfg, None, torch.bfloat16, m, seed=7)
                   for _ in range(2))
    got = _graph_run(dev, cfg, params, dec, 4, m, second, True, n=2)
    assert dec.graphs.captures == 2
    want = _graph_run(dev, cfg, params, dec, 4, m, ref, False, n=2)
    for (tg, _s, _c), (te, _s2, _c2) in zip(got, want):
        assert torch.equal(tg, te)
    assert torch.equal(second[0].k_blocks, ref[0].k_blocks)
    _graph_run(dev, cfg, params, dec, 4, m, first, True, n=1)
    assert dec.graphs.captures == 2 and len(dec.graphs) == 2


def test_server_on_card_replays_one_graph_per_dispatch(dev):
    """Every decode dispatch of the server on the card is one replay, at
    k = 1 and k = 4, and both give the same tokens."""
    from paddle_tpu_torch.inference import PagedGenerationServer

    cfg, _params, _Dec = _graph_model(dev, False, torch.float32)
    from paddle_tpu_torch.models.gpt2 import GPT2

    model = GPT2(cfg, seed=3, device=dev)
    rs = np.random.RandomState(2)
    prompts = [rs.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 30, 17)]
    outs = {}
    for k in (1, 4):
        srv = PagedGenerationServer(model, max_slots=2, block_size=4,
                                    max_new_tokens=12, steps_per_dispatch=k,
                                    device=dev)
        futs = [srv.submit(p) for p in prompts]
        srv.start()
        try:
            outs[k] = [f.result(timeout=300) for f in futs]
            st = srv.stats()
        finally:
            srv.stop()
        assert st["decode_graph_replays"] == st["decode_steps"] > 0
        assert 1 <= st["decode_graph_captures"] <= 2
    for a, b in zip(outs[1], outs[4]):
        np.testing.assert_array_equal(a, b)


# ---- speculation and the unified round (verify windows on K1) --------------

def _verify_inputs(dev, h, dh, bs, dtype, quant, seed, P=8, W=9):
    """P windows of W query rows (K = W - 1) over contexts of 64-300
    positions: row r's window [last token, k_r drafts] ends its context,
    the rest of the window is pad (-1); row P - 1 is a padding row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rs = np.random.RandomState(seed)
    ctx = rs.randint(64, 301, P)
    ks = rs.randint(0, W, P)
    lens = [int(c) for c in ctx]
    tables, n = _tables(torch.Generator().manual_seed(seed), lens, bs, dev)
    kb, vb = _pools(g, n, bs, h, dh, dtype, quant, dev)
    pos = np.full((P, W), -1, np.int32)
    for r in range(P - 1):
        k = int(ks[r])
        pos[r, :1 + k] = np.arange(lens[r] - 1 - k, lens[r])
    q = torch.randn(P, W, h, dh, generator=g, device=dev).to(dtype)
    return q, kb, vb, tables, torch.from_numpy(pos).to(dev)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,dh,bs", [(12, 64, 16), (4, 32, 4)])
def test_verify_window_kernel_matches_plain(dev, h, dh, bs, dtype, quant):
    """`verify_window_attention` on the card is K1 on the flattened
    [P·W] stream: held to its plain version (the reference's dense
    per-row fallback) on the rows with pos >= 0; pad rows are zeros (the
    fallback averages them; no readout reads one); two launches give the
    same bits; one K1 launch a call."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import (verify_window_attention,
                                                verify_window_attention_plain)

    q, kb, vb, tables, pos = _verify_inputs(dev, h, dh, bs, dtype, quant,
                                            3 + h + bs)
    before = kernels.RAGGED_STREAM[quant].launches
    out = verify_window_attention(q, kb, vb, tables, pos)
    again = verify_window_attention(q, kb, vb, tables, pos)
    torch.cuda.synchronize()
    assert kernels.RAGGED_STREAM[quant].launches == before + 2
    ref = verify_window_attention_plain(q.float(), _f32(kb), _f32(vb),
                                        tables, pos)
    live = pos >= 0
    assert torch.isfinite(out).all()
    assert (out[~live] == 0).all()
    _close(out[live], ref[live], dtype)
    assert torch.equal(out, again)


def _spec_model(dev, dtype=torch.bfloat16):
    from paddle_tpu_torch.models.gpt2 import GPT2, GPT2Config

    cfg = GPT2Config(vocab_size=1000, hidden_size=128, num_layers=2,
                     num_heads=4, max_position=256)
    return cfg, GPT2(cfg, seed=3, dtype=dtype, device=dev)


def _strict(call, strict):
    """call() under set_sync_debug_mode("error") when strict."""
    if not strict:
        return call()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return call()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _verify_dispatches(dev, cfg, params, dec, mode, side, graph, n=3, K=4,
                       strict=False):
    """n verify dispatches over the 4 slots of `_graph_side` (slot 2 a
    padding row): drafts from a seeded RandomState each dispatch (the
    same on both sides), each row's next token and position taken from
    the accepted prefix. Returns each dispatch's outputs. strict: the
    decoder calls run under set_sync_debug_mode("error")."""
    from paddle_tpu_torch.spec_decode import build_verify_plan

    cache, store, tok, pos, _act, tables = side
    rs = np.random.RandomState(17)
    last = tok.cpu().numpy().copy()
    wpos = pos.cpu().numpy().copy()
    steps = np.zeros(4, np.int32)
    outs = []
    for _ in range(n):
        entries = [(b, int(last[b]), int(wpos[b]), int(steps[b]),
                    rs.randint(0, cfg.vocab_size,
                               (int(rs.randint(0, K + 1)),)).astype(np.int32))
                   for b in (0, 1, 3)]
        plan = build_verify_plan(entries, K, 1, min_rows=4)
        sp, got = store.verify_args([0, 1, 3, None], plan.steps)
        assert got == mode
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        tab = tables[[0, 1, 3, 0]].contiguous()
        args = (params, t(plan.toks), t(plan.seg), t(plan.pos), tab,
                t(plan.sample_idx), t(plan.dlen), cache.k_blocks,
                cache.v_blocks, sp)
        out = _strict(lambda: (dec.graphs.verify(mode, *args) if graph
                               else dec.packed_verify(*args, mode)), strict)
        vtok, acc, stopped, _kc, _vc, counts = out
        outs.append((vtok.clone(), acc.clone(), stopped.clone(),
                     None if counts is None else counts.clone()))
        store.swap_counts(counts)
        vt, ac = vtok.cpu().numpy(), acc.cpu().numpy()
        for r, b in enumerate((0, 1, 3)):
            a = int(ac[r])
            last[b] = vt[r, a]
            wpos[b] += a + 1
            steps[b] += a + 1
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_verify_graph_equals_eager_bitwise(dev, mode, kv_dtype):
    """Three verify dispatches through one captured graph against the
    eager `packed_verify` on a copy of the same pool: vtok, accepted,
    stopped, counts and every pool element bit for bit; one capture."""
    cfg, model = _spec_model(dev)
    params = model.flat_params()
    m = GRAPH_MODES[mode]
    from paddle_tpu_torch.nn.decode import PagedDecoder

    sides = [_graph_side(dev, cfg, kv_dtype, torch.bfloat16, m)
             for _ in range(2)]
    dec = PagedDecoder.for_config(cfg, 4, kv_dtype=kv_dtype)
    eager = _verify_dispatches(dev, cfg, params, dec, m, sides[0], False)
    graph = _verify_dispatches(dev, cfg, params, dec, m, sides[1], True)
    assert dec.graphs.captures == 1 and dec.graphs.replays == 3
    for e, g in zip(eager, graph):
        for a, b in zip(e, g):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
    for a, b in zip(_graph_leaves(sides[0][0]), _graph_leaves(sides[1][0])):
        assert torch.equal(a, b)


def test_verify_replay_launch_counts_and_no_host_sync(dev):
    """A verify replay adds its capture's K1 launches (one a layer) and
    makes no host synchronisation."""
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.ops import kernels

    cfg, model = _spec_model(dev)
    params = model.flat_params()
    m = GRAPH_MODES["both"]
    side = _graph_side(dev, cfg, "int8", torch.bfloat16, m)
    dec = PagedDecoder.for_config(cfg, 4, kv_dtype="int8")
    _verify_dispatches(dev, cfg, params, dec, m, side, True, n=1)
    kernels.reset_launch_counts()
    outs = _verify_dispatches(dev, cfg, params, dec, m, side, True, n=1,
                              strict=True)
    assert kernels.launch_counts()["ragged_stream_int8"] == cfg.num_layers
    assert dec.graphs.captures == 1
    assert outs[0][0].shape == (4, 5)


def _window_dispatches(dev, cfg, params, dec, mode, side, graph, n=3, K=3,
                       strict=False):
    """n window rounds over slots 0, 1, 3 fed through the device carry
    (each round's carry into the next), drafts from a seeded RandomState;
    returns each round's outputs and carries. strict: as
    `_verify_dispatches`."""
    cache, store, tok, pos, _act, tables = side
    rs = np.random.RandomState(23)
    W = K + 1
    P = 4
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    carry = (tok.clone(), pos.clone(), torch.zeros(4, dtype=torch.int32,
                                                   device=dev))
    outs = []
    for _ in range(n):
        T = P * W
        toks = np.zeros(T, np.int32)
        seg = np.zeros(T, np.int32)
        pp = np.full(T, -1, np.int32)
        cmap = np.full(T, -1, np.int32)
        pmap = np.full(T, -1, np.int32)
        sidx = np.zeros((P, W), np.int32)
        dlen = np.full(P, -1, np.int32)
        rslot = np.full(P, -1, np.int32)
        smap = np.full(P, -1, np.int32)
        for r, b in enumerate((0, 1, 3)):
            k = int(rs.randint(0, K + 1))
            o = r * W
            seg[o:o + 1 + k] = r
            toks[o + 1:o + 1 + k] = rs.randint(0, cfg.vocab_size, k)
            cmap[o] = b
            pp[o:o + 1 + k] = np.arange(1 + k)
            pmap[o:o + 1 + k] = b
            smap[r] = b
            sidx[r] = o + np.minimum(np.arange(W), k)
            dlen[r], rslot[r] = k, b
        sp, got = store.unified_args([0, 1, 3, None],
                                     [True, True, True, False],
                                     np.zeros(P, np.int32))
        assert got == mode
        tab = tables[[0, 1, 3, 0]].contiguous()
        args = (params, t(toks), t(seg), t(pp), tab, t(sidx), t(dlen),
                t(rslot), t(cmap), t(pmap), t(smap), *carry,
                cache.k_blocks, cache.v_blocks, sp)
        out = _strict(lambda: (dec.graphs.unified(mode, *args) if graph
                               else dec.unified_round(*args, mode,
                                                      window=True)), strict)
        vtok, acc, stopped, _kc, _vc, counts, ct, cp, cs = out
        outs.append(tuple(x.clone() if x is not None else None
                          for x in (vtok, acc, stopped, counts, ct, cp, cs)))
        store.swap_counts(counts)
        carry = (ct, cp, cs)
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_window_round_graph_equals_eager_bitwise(dev, mode, kv_dtype):
    """Three chained window rounds (the carry of each the next one's
    input, as in the async loop) through one graph against the eager
    `unified_round(window=True)`: outputs, carries, counts and pools bit
    for bit."""
    from paddle_tpu_torch.nn.decode import PagedDecoder

    cfg, model = _spec_model(dev)
    params = model.flat_params()
    m = GRAPH_MODES[mode]
    sides = [_graph_side(dev, cfg, kv_dtype, torch.bfloat16, m)
             for _ in range(2)]
    dec = PagedDecoder.for_config(cfg, 4, kv_dtype=kv_dtype)
    eager = _window_dispatches(dev, cfg, params, dec, m, sides[0], False)
    graph = _window_dispatches(dev, cfg, params, dec, m, sides[1], True)
    assert dec.graphs.captures == 1 and dec.graphs.replays == 3
    for e, g in zip(eager, graph):
        for a, b in zip(e, g):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
    for a, b in zip(_graph_leaves(sides[0][0]), _graph_leaves(sides[1][0])):
        assert torch.equal(a, b)


def test_window_replay_launch_counts_and_no_host_sync(dev):
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.ops import kernels

    cfg, model = _spec_model(dev)
    params = model.quantize_weights()
    m = GRAPH_MODES["sampled"]
    side = _graph_side(dev, cfg, None, torch.bfloat16, m)
    dec = PagedDecoder.for_config(cfg, 4)
    _window_dispatches(dev, cfg, params, dec, m, side, True, n=1)
    kernels.reset_launch_counts()
    _window_dispatches(dev, cfg, params, dec, m, side, True, n=2,
                       strict=True)
    assert kernels.launch_counts()["ragged_stream_dense"] == \
        2 * cfg.num_layers
    assert dec.graphs.captures == 1


def _serve_on(device, model, prompts, sampling, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    srv = PagedGenerationServer(model, max_slots=3, block_size=4,
                                max_new_tokens=16, prefill_chunk_tokens=16,
                                device=device, **kw)
    futs = [srv.submit(p, sampling=s) for p, s in zip(prompts, sampling)]
    srv.start()
    try:
        outs = [f.result(timeout=600) for f in futs]
        st = srv.stats()
    finally:
        srv.stop()
    return outs, st


@pytest.mark.parametrize("engine", ["split", "unified", "async"])
def test_speculating_server_on_card_matches_cpu(dev, engine):
    """float32 (TF32 off): the n-gram speculating server on the card
    gives the CPU's tokens (greedy, seeded sampled and penalized
    requests), on the split, unified and async engines; every verify
    dispatch (split) and every window round (unified) is one replay."""
    from paddle_tpu_torch.sampling import SamplingParams

    cfg, model = _spec_model(dev, torch.float32)
    rs = np.random.RandomState(4)
    base = rs.randint(1, cfg.vocab_size, 5).astype(np.int32)
    prompts = [np.tile(base, 4)[:12 + 3 * i] for i in range(5)]
    sampling = [None, SamplingParams(temperature=0.8, top_p=0.9, seed=5),
                SamplingParams(repetition_penalty=1.3, presence_penalty=0.2),
                None, SamplingParams(temperature=1.0, top_k=20, seed=6)]
    kw = dict(speculation=True, unified_round=engine == "unified",
              async_rounds=engine == "async")
    card, st = _serve_on(dev, model, prompts, sampling, **kw)
    host, _ = _serve_on("cpu", model, prompts, sampling, **kw)
    for a, b in zip(card, host):
        np.testing.assert_array_equal(a, b)
    sp = st["speculation"]
    assert sp["verify_dispatches"] > 0 and sp["accepted_tokens"] > 0
    if engine == "split":
        assert st["verify_graph_replays"] == sp["verify_dispatches"]
        assert st["decode_graph_replays"] == st["decode_steps"]
    else:
        assert st["rounds"]["dispatches_per_round"] == 1.0
        assert st["round_graph_replays"] > 0


def test_async_dispatch_makes_no_host_sync(dev):
    """Every dispatch of the async engine (plan uploads, the graph replay
    or the eager mixed round, the outputs' copies to page-locked memory)
    runs under set_sync_debug_mode("error"); a capture, which synchronises
    by design, is let through. A sync would raise inside the dispatch and
    fail its requests."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.sampling import SamplingParams

    cfg, model = _spec_model(dev)
    rs = np.random.RandomState(9)
    prompts = [rs.randint(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rs.randint(8, 60, 6)]
    srv = PagedGenerationServer(model, max_slots=3, block_size=4,
                                max_new_tokens=12, prefill_chunk_tokens=32,
                                async_rounds=True, speculation=True,
                                device=dev)
    graphs = srv._decoder.graphs
    capture = graphs._capture
    dispatch = srv._dispatch_round
    seen = {"dispatches": 0}

    def quiet_capture(*a, **k):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return capture(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    def strict_dispatch(plan):
        seen["dispatches"] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(plan)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    graphs._capture = quiet_capture
    srv._dispatch_round = strict_dispatch
    sp = SamplingParams(temperature=0.7, seed=3)
    futs = [srv.submit(p, sampling=sp if i % 2 else None)
            for i, p in enumerate(prompts)]
    srv.start()
    try:
        outs = [f.result(timeout=600) for f in futs]
        st = srv.stats()
    finally:
        srv.stop()
    assert all(o.size == p.size + 12 for o, p in zip(outs, prompts))
    assert seen["dispatches"] == st["rounds"]["rounds"] > 0
    assert st["rounds"]["mixed_rounds"] > 0 and st["round_graph_replays"] > 0


# ---- the seq2seq Transformer: K4 at one query ------------------------------

# chip_smoke.py phase 3e's key lengths: a cached decode step's
# self-attention sees 1..max_len keys, its cross-attention S_src
Q1_SK = (1, 2, 63, 64, 65, 127, 128, 129, 255)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sk", Q1_SK)
def test_flash_fwd_one_query_matches_plain(dev, sk, d, dtype):
    """K4 at Sq = 1 (one row of the bf16 kernel's 128-row q tile and its
    TMA box), Sk on and off the 128-key tile, against its plain version;
    two launches give the same bits."""
    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    g = torch.Generator(device=dev).manual_seed(sk * 3 + d)
    q = torch.randn(4, 8, 1, d, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(4, 8, sk, d, generator=g, device=dev).to(dtype)
            for _ in range(2))
    sc = d ** -0.5
    out, lse = kernels.flash_fwd(q, k, v, sc, False)
    out2, lse2 = kernels.flash_fwd(q, k, v, sc, False)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    out_p, lse_p = pf.flash_fwd_lse_plain(q.float(), k.float(), v.float(),
                                          sc, False)
    _rel_close(out, out_p, 1e-4 if dtype == torch.float32 else 2e-2, "out")
    _rel_close(lse, lse_p, 1e-4, "lse")


def _s2s_cfg():
    """TransformerConfig.tiny() with 2 heads: head dim 32, the flash
    route; dropout 0."""
    from paddle_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig.tiny()
    cfg.nhead, cfg.dropout = 2, 0.0
    return cfg


def test_seq2seq_cached_decoder_on_card_matches_cpu(dev):
    """The cached decoder (K4 at Sq = 1 against the self-attention cache
    and the memory) on the card against the CPU's plain path, float32, the
    same weights: each step's logits within 1e-4 of their largest
    magnitude, and greedy and beam tokens identical."""
    from paddle_tpu_torch.models.transformer import TransformerModel

    cfg = _s2s_cfg()
    models = {"cpu": TransformerModel(cfg, device="cpu").eval()}
    models[str(dev)] = TransformerModel(cfg, device=dev).eval()
    src = np.random.RandomState(0).randint(2, cfg.src_vocab_size, (3, 11))
    res = {}
    for name, m in models.items():
        s = torch.from_numpy(src).to(m.pos_enc.device)
        with torch.no_grad():
            memory = m.transformer.encoder(m._embed_at(m.src_embed, s, 0),
                                           None)
            caches = m.transformer.decoder.gen_cache(memory)
            tok, steps = m._bos(3), []
            for step in range(12):
                logits, caches = m._decode_step(tok, step, memory, caches)
                steps.append(logits.cpu())
                tok = logits.argmax(-1).to(torch.int32)[:, None]
        res[name] = (steps, m.greedy_decode(s, 12).cpu(),
                     m.beam_search_decode(s, 4, 12).cpu())
    for a, b in zip(res["cpu"][0], res[str(dev)][0]):
        _rel_close(b, a, 1e-4, "step logits")
    assert torch.equal(res["cpu"][1], res[str(dev)][1])
    assert torch.equal(res["cpu"][2], res[str(dev)][2])


def test_seq2seq_bf16_cached_decode_launches_k4_never_the_dense_path(dev):
    """A bf16 cached greedy decode on the card: the encoder's K4
    launches, then two K4 launches a layer a step at Sq = 1 (self- and
    cross-attention), and no call of the dense path (no fallback); the
    same for beam search's steps."""
    from paddle_tpu_torch.models.transformer import TransformerModel
    from paddle_tpu_torch.ops import attention, kernels

    cfg = _s2s_cfg()
    model = TransformerModel(cfg, dtype=torch.bfloat16, device=dev).eval()
    src = torch.from_numpy(np.random.RandomState(1).randint(
        2, cfg.src_vocab_size, (4, 9))).to(dev)
    calls, real_dense, real_fwd = {"dense": 0, "q1": 0}, \
        attention.dense_attention, kernels.flash_fwd

    def dense_spy(*a, **k):
        calls["dense"] += 1
        return real_dense(*a, **k)

    def fwd_spy(q, *a, **k):
        calls["q1"] += q.shape[2] == 1
        return real_fwd(q, *a, **k)

    attention.dense_attention, kernels.flash_fwd = dense_spy, fwd_spy
    try:
        for run in ("greedy", "beam"):
            calls["dense"] = calls["q1"] = 0
            kernels.reset_launch_counts()
            out = model.greedy_decode(src, 10) if run == "greedy" else \
                model.beam_search_decode(src, 3, 10)
            torch.cuda.synchronize()
            steps = out.shape[1] - 1
            q1 = 2 * cfg.num_decoder_layers * steps
            assert calls == {"dense": 0, "q1": q1}, (run, calls)
            assert kernels.launch_counts()["flash_fwd"] == \
                q1 + cfg.num_encoder_layers
            assert out.dtype == torch.int32 and (out[:, 0] == 0).all()
    finally:
        attention.dense_attention, kernels.flash_fwd = real_dense, real_fwd


# ---- offline generation: the dense program's graphs, the paged generate ----

def _gen_models(dev, dtype=torch.float32):
    """A 2-layer GPT-2 (vocab 1000) on the card and the same weights on
    the CPU, float32 unless asked."""
    from paddle_tpu_torch.models.gpt2 import GPT2, GPT2Config

    cfg = GPT2Config(vocab_size=1000, hidden_size=128, num_layers=2,
                     num_heads=4, max_position=256)
    cpu = GPT2(cfg, seed=5, dtype=dtype, device="cpu")
    card = GPT2(cfg, device=dev, init=False)
    with torch.no_grad():
        for (_, pc), (_, pg) in zip(card.named_parameters(),
                                    cpu.named_parameters()):
            pc.data = pg.detach().to(dev)
    return cfg, cpu, card


@pytest.mark.parametrize("kw", [
    dict(), dict(weight_quant="int8"), dict(kv_quant="int8"),
    dict(temperature=0.8, top_k=40, top_p=0.95, seed=3),
    dict(temperature=0.8, seed=3, weight_quant="int8", kv_quant="int8")],
    ids=["greedy", "w8a16", "kv8", "sampled", "sampled_w8_kv8"])
def test_dense_generate_graph_equals_eager_bitwise(dev, kw):
    """The dense program's graph (a capture, then a pure replay) against
    the same program run eagerly on the card, bf16 weights, left-padded
    rows: tokens bit for bit."""
    from paddle_tpu_torch.models import gpt2_decode

    cfg, _cpu, card = _gen_models(dev, torch.bfloat16)
    ids = np.random.RandomState(2).randint(1, 1000, (4, 12)).astype(np.int32)
    ids[1, :5] = 0
    outs = [card.generate(ids, 10, pad_token_id=0, **kw) for _ in range(2)]
    prog = gpt2_decode.decode_program(
        cfg, 10, kw.get("top_k", 0), kw.get("top_p", 1.0) < 1.0,
        kw.get("kv_quant") == "int8")
    assert prog.graphs.captures >= 1 and prog.graphs.replays >= 2
    params = card._decode_params(kw.get("weight_quant"))
    key = torch.tensor([0, kw.get("seed", 0)], dtype=torch.int64,
                       device=dev)

    def scalar(v, dt):
        return torch.tensor(v, dtype=dt, device=dev)

    eager = prog.run(params, torch.from_numpy(ids).to(dev), key,
                     scalar(kw.get("temperature", 0.0), torch.float32),
                     scalar(-1, torch.int32),
                     scalar(kw.get("top_p", 1.0), torch.float32),
                     scalar(0, torch.int32), kw.get("temperature", 0) > 0)
    for out in outs:
        assert out.dtype == torch.int32 and out.device == dev
        assert torch.equal(out, eager)


def test_dense_generate_captures_once_per_mode(dev):
    """Temperatures 0.7, 1.3 and 0.0 through one program: two captures
    (sampled and greedy), and none more when the three calls repeat with
    other seeds and eos."""
    from paddle_tpu_torch.models import gpt2_decode

    _cfg, _cpu, card = _gen_models(dev)
    ids = np.array([[1, 2, 3]], np.int64)
    gpt2_decode._generate_impl.cache_clear()
    for seed in (1, 2):
        card.generate(ids, 4, temperature=0.7, seed=seed)
        card.generate(ids, 4, temperature=1.3, seed=seed + 5,
                      eos_token_id=5)
        card.generate(ids, 4, temperature=0.0, seed=seed + 9)
    assert gpt2_decode._generate_impl.cache_info().misses == 1
    prog = gpt2_decode.decode_program(card.cfg, 4)
    assert prog.graphs.captures == 2 and prog.graphs.replays == 6


@pytest.mark.parametrize("kw", [dict(), dict(kv_quant="int8"),
                                dict(temperature=0.9, seed=4)],
                         ids=["greedy", "kv8", "sampled"])
def test_generate_on_card_matches_cpu(dev, kw):
    """float32 (TF32 off): the dense and the paged generate on the card
    give the CPU's tokens; the paged one launches K2 once a layer a
    step (its steps are graph replays; the capture's eager warm-up is
    one step more)."""
    from paddle_tpu_torch.ops import kernels

    cfg, cpu, card = _gen_models(dev)
    ids = np.random.RandomState(3).randint(1, 1000, (3, 9)).astype(np.int32)
    for cache in ("dense", "paged"):
        kernels.reset_launch_counts()
        got = card.generate(ids, 8, kv_cache=cache, block_size=4, **kw)
        torch.cuda.synchronize()
        n = kernels.launch_counts()
        want = cpu.generate(ids, 8, kv_cache=cache, block_size=4, **kw)
        assert torch.equal(got.cpu(), want), cache
        tag = "int8" if kw.get("kv_quant") else "dense"
        k2 = n[f"paged_decode_{tag}"]
        # the paged steps: the step graph's eager warm-up, then 7 replays
        assert k2 == (8 * cfg.num_layers if cache == "paged" else 0), n


def test_loaded_generator_and_server_on_card(dev, tmp_path):
    """An exported generator loaded onto the card returns CPU tensors
    equal to the CPU's; GenerationServer over it serves each row as the
    prompt's generate."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import GenerationServer
    from paddle_tpu_torch.models.gpt2 import export_generator

    _cfg, cpu, card = _gen_models(dev)
    export_generator(card, str(tmp_path / "g"), prompt_len=8,
                     max_new_tokens=6, batch_size=4)
    served = jit.load(str(tmp_path / "g"))
    assert served.device.type == "cuda"
    rs = np.random.RandomState(6)
    prompts = [rs.randint(1, 1000, (n,)).astype(np.int32)
               for n in (8, 5, 3, 8, 1, 7)]
    srv = GenerationServer(served, pad_token_id=0, max_wait_ms=50)
    futs = [srv.submit(p) for p in prompts]
    srv.start()
    try:
        for p, f in zip(prompts, futs):
            row = np.zeros((1, 8), np.int32)
            row[0, 8 - p.size:] = p
            want = cpu.generate(row, 6, pad_token_id=0).numpy()[0] \
                if p.size < 8 else cpu.generate(row, 6).numpy()[0]
            np.testing.assert_array_equal(f.result(timeout=120), want)
    finally:
        srv.stop()
    out = served(np.stack([prompts[0]] * 4), 0, 0.0, -1, 1.0, -1)
    assert out.device.type == "cpu" and out.dtype == torch.int32


# ---- reliability and the capture tracker on the card ------------------------

def _rel_serve(model, prompts, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    srv = PagedGenerationServer(model, max_slots=2, block_size=4,
                                max_new_tokens=10, **kw)
    futs = [srv.submit(p) for p in prompts]
    srv.start()
    try:
        outs = [f.result(timeout=300) for f in futs]
        st = srv.stats()
    finally:
        srv.stop()
    return outs, st


@pytest.mark.parametrize("kw", [{}, {"enable_prefix_cache": True},
                                {"unified_round": True,
                                 "async_rounds": True}],
                         ids=["split", "prefix", "async"])
def test_recovered_fault_replays_the_same_graphs(dev, kw):
    """A recovered decode (window) fault on the card: every decode
    dispatch is still one graph replay, the faulted run captures no
    graph the fault-free run did not, and the tokens equal the
    fault-free run's up to the cold resume's K/V rounding (float32 here,
    TF32 off: they match exactly on this model)."""
    from paddle_tpu_torch.models.gpt2 import GPT2

    cfg, _params, _Dec = _graph_model(dev, False, torch.float32)
    model = GPT2(cfg, seed=3, device=dev)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 30, 17)]
    ref, st0 = _rel_serve(model, prompts, **kw)
    seam = "unified_round:3" if kw.get("async_rounds") else "decode:2"
    got, st = _rel_serve(model, prompts, fault_plan=seam, **kw)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    rel = st["reliability"]
    assert rel["faults_injected"] == 1 and rel["recoveries"] == 1
    assert rel["quarantined"] == 0 and rel["resumes"] >= 1
    if kw.get("enable_prefix_cache"):
        assert rel["warm_resumes"] >= 1
    assert st["decode_graph_replays"] == st["decode_steps"] or \
        st["round_graph_replays"] > 0
    if not kw.get("unified_round"):
        assert st["decode_graph_replays"] == st["decode_steps"] > 0
    assert st["decode_graph_captures"] == st0["decode_graph_captures"]


def test_warm_buckets_captures_are_not_in_flight(dev):
    """warm_buckets captures every decode graph the loop reaches for
    its modes before start(), labelled not in flight; a measured window
    of traffic after it counts no capture at all."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.models.gpt2 import GPT2
    from paddle_tpu_torch.observability import compile_tracker as CT
    from paddle_tpu_torch.sampling import SamplingParams

    cfg, _params, _Dec = _graph_model(dev, False, torch.float32)
    model = GPT2(cfg, seed=3, device=dev)
    for kw in ({}, {"unified_round": True, "speculation": True}):
        srv = PagedGenerationServer(model, max_slots=3, block_size=4,
                                    max_new_tokens=8, **kw)
        mark = CT.mark()
        n = srv.warm_buckets([(False, False), (True, False)])
        assert n >= 2
        evs = CT.events_since(mark)
        assert len(evs) == n and not any(e["in_flight"] for e in evs)
        assert srv.readiness()[1]["warmed"] is True
        srv.start()
        try:
            srv.reset_stats()
            rs = np.random.RandomState(8)
            futs = [srv.submit(rs.randint(1, cfg.vocab_size, m)
                               .astype(np.int32),
                               sampling=SamplingParams(
                                   temperature=0.8, seed=i)
                               if i % 2 else None)
                    for i, m in enumerate((5, 12, 7, 3))]
            for f in futs:
                f.result(timeout=300)
            st = srv.stats()
        finally:
            srv.stop()
        assert st["compiles"] == {"window_total": 0,
                                  "window_in_flight": 0}, (kw, st)


# ---- the front door on the card ----------------------------------------------

def _fd_preempt(device, model, engine_kw, cache_on=True):
    """A batch request preempted by an interactive one on a one-slot
    front door; the batch request holds the engine at its second token
    until the interactive one is queued. Returns (tokens, stats, K1 and
    K2 launches)."""
    import threading

    from paddle_tpu_torch.frontend import FrontDoor
    from paddle_tpu_torch.ops import kernels

    rs = np.random.RandomState(33)
    pv = rs.randint(1, 1000, 7).astype(np.int32)
    pi = rs.randint(1, 1000, 4).astype(np.int32)
    fd = FrontDoor(model, max_slots=1, block_size=4, max_prompt_len=16,
                   max_new_tokens=24, enable_prefix_cache=cache_on,
                   device=device, **engine_kw)
    reached, go = threading.Event(), threading.Event()
    seen = [0]

    def hold(_tok, _reason):
        seen[0] += 1
        if seen[0] == 2:
            reached.set()
            go.wait(60)

    kernels.reset_launch_counts()
    fd.start()
    try:
        hv = fd.submit(pv, lane="batch", max_new_tokens=24, on_token=hold)
        assert reached.wait(300)
        caps0 = fd.server.stats()["decode_graph_captures"]
        hi = fd.submit(pi, lane="interactive", max_new_tokens=3)
        go.set()
        outs = [hv.result(timeout=600), hi.result(timeout=600)]
        st = fd.stats()
    finally:
        fd.stop()
    counts = kernels.launch_counts()
    k1 = sum(n for name, n in counts.items()
             if name.startswith("ragged_stream"))
    k2 = sum(n for name, n in counts.items()
             if name.startswith("paged_decode"))
    return outs, st, (k1, k2), caps0


@pytest.mark.parametrize("engine", ["split", "unified", "async"])
def test_frontdoor_preemption_on_card_matches_cpu(dev, engine):
    """float32 (TF32 off): a preempted and resumed request on the card
    gives the CPU's tokens, on the split, unified and async engines; the
    resume re-prefill runs K1, and on the split engine decode runs K2
    and every decode dispatch is one graph replay (the unified rounds
    run K1 for every row)."""
    _cfg, model = _spec_model(dev, torch.float32)
    kw = {"split": {}, "unified": {"unified_round": True},
          "async": {"async_rounds": True}}[engine]
    card, st, (k1, k2), _ = _fd_preempt(dev, model, kw)
    host, hst, _, _ = _fd_preempt("cpu", model, kw)
    for a, b in zip(card, host):
        np.testing.assert_array_equal(a, b)
    fr = st["frontdoor"]
    assert fr["preemptions"] >= 1 and fr["resumes"] >= 1
    assert fr["preempt_cached_tokens"] > 0
    assert hst["frontdoor"]["preemptions"] == fr["preemptions"]
    assert k1 > 0
    if engine == "split":
        assert k2 > 0
        assert st["decode_graph_replays"] == st["decode_steps"] > 0


def test_decode_after_preemption_replays_not_captures(dev):
    """The swapped-out slot is an idle row of the same decode graph
    (ctx 1 on the trash block): after the preemption every decode
    dispatch is still a replay and no graph is captured, greedy mode
    throughout."""
    _cfg, model = _spec_model(dev, torch.float32)
    _outs, st, _k, caps0 = _fd_preempt(dev, model, {}, cache_on=False)
    assert st["frontdoor"]["preemptions"] >= 1
    assert caps0 == 1
    assert st["decode_graph_captures"] == caps0
    assert st["decode_graph_replays"] == st["decode_steps"] > 0


# ---- the serving fleet's engine hooks on the card ----------------------------

def _fleet_server(model, dev, kv_dtype):
    from paddle_tpu_torch.inference import PagedGenerationServer

    return PagedGenerationServer(model, max_slots=2, block_size=16,
                                 max_prompt_len=64, max_new_tokens=24,
                                 enable_prefix_cache=True,
                                 kv_dtype=kv_dtype, device=dev)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_fleet_hooks_migrate_a_session_between_card_pools(dev, kv_dtype):
    """float32 (TF32 off): a session held at its third token is exported
    from one server's card pool and imported into another's; the target
    resumes it with no prefill (its decode launches K2 over the imported
    blocks), then prefills a prompt extending the migrated sequence (K1
    reads the imported chain through the block table), and both give an
    uninterrupted server's tokens. An int8 payload's blocks equal the
    exported ones bit for bit in the target pool (through the wire codec
    too)."""
    import threading
    import time

    from paddle_tpu_torch.fleet import (deserialize_kv_payload,
                                        serialize_kv_payload)
    from paddle_tpu_torch.ops import kernels

    _cfg, model = _spec_model(dev, torch.float32)
    prompt = np.random.RandomState(51).randint(1, 1000, 37).astype(
        np.int32)
    ref_srv = _fleet_server(model, dev, kv_dtype).start()
    try:
        want = ref_srv.submit(prompt, max_new_tokens=20).result(timeout=300)
        want2 = ref_srv.submit(want, max_new_tokens=4).result(timeout=300)
    finally:
        ref_srv.stop()
    src = _fleet_server(model, dev, kv_dtype)
    assert src.run_host_op(lambda: 7) == 7  # not started: inline
    seen, reached, go = [], threading.Event(), threading.Event()

    def hold(tok, _reason):
        seen.append(tok)
        if len(seen) == 3:
            reached.set()
            go.wait(60)

    src.start()
    try:
        src.submit(prompt, max_new_tokens=20, on_token=hold, rid="m")
        assert reached.wait(300)
        box = {}
        t = threading.Thread(target=lambda: box.update(
            r=src.export_session("m"),
            thread=src.run_host_op(threading.get_ident)))
        t.start()
        deadline = time.monotonic() + 60
        while not src._host_ops and time.monotonic() < deadline:
            time.sleep(0.001)
        go.set()
        t.join(120)
        assert box["thread"] == src._thread.ident
        with pytest.raises(KeyError):
            src.export_session("m")
    finally:
        src.stop()
    ent, payload = box["r"]
    assert len(ent["gen0"]) >= 3 and payload is not None
    dst = _fleet_server(model, dev, kv_dtype)
    wire = deserialize_kv_payload(serialize_kv_payload(payload))
    kernels.reset_launch_counts()
    dst.start()
    try:
        assert dst.import_kv_payload(wire) == len(payload["tokens"])
        if kv_dtype == "int8":
            back = dst.run_host_op(
                lambda: dst.cache.export_prefix(payload["tokens"]))
            for side in ("k", "v"):
                for a, b in zip(payload[side], back[side]):
                    np.testing.assert_array_equal(a.codes, b.codes)
                    np.testing.assert_array_equal(a.scales, b.scales)
        out = dst.admit_journal_entry(ent).result(timeout=300)
        st = dst.stats()
        resumed = kernels.launch_counts()
        out2 = dst.submit(out, max_new_tokens=4).result(timeout=300)
    finally:
        dst.stop()
    counts = kernels.launch_counts()
    name = "int8" if kv_dtype == "int8" else "dense"
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out2, want2)
    assert st["prefills"] == 0 and st["prefill_dispatches"] == 0
    assert st["frontdoor"]["resumes"] >= 1
    assert resumed[f"paged_decode_{name}"] > 0
    assert counts[f"ragged_stream_{name}"] > 0


# ---- parallel training: ranks sharing the card over gloo ---------------------

def _ring_rank(rank, dtype_name):
    """One rank of a 2-rank ring on the card: its shard's output and
    gradients, and the ring's launches."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel.ring_attention import (last_impl_used,
                                                          ring_attention,
                                                          shard_sequence)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    mesh = make_mesh(dp=1, sp=2)
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(1, 4, 512, 64, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    loc = [shard_sequence(t, mesh).contiguous().requires_grad_(True)
           for t in (q, k, v)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    o = ring_attention(*loc, "sp", causal=True, mesh=mesh)
    grads = torch.autograd.grad(o, loc, shard_sequence(do, mesh))
    torch.cuda.synchronize()
    return {"out": [o.detach().float()] + [x.float() for x in grads],
            "counts": kernels.launch_counts(), "impl": last_impl_used()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_rank_ring_on_card_matches_one_rank(dev, dtype, tmp_path):
    """Two ranks on the one card (gloo, host-staged ppermutes): the ring's
    flash forward (K4 a ring step) and backward (K6, K7, K8 a ring step)
    against flash_attention on one rank with the same inputs."""
    from torch_dist_util import run_world

    from paddle_tpu_torch.ops.flash_attention import flash_attention
    res = run_world(_ring_rank, 2, tmp_path, dtype)
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = (torch.randn(1, 4, 512, 64, generator=g, device=dev)
                   .to(dt) for _ in range(4))
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention(*ts, causal=True)
    want = [o.detach()] + list(torch.autograd.grad(o, ts, do))
    tol = 1e-4 if dtype == "float32" else 2e-2
    for r in range(2):
        assert res[r]["impl"] == "flash"
        for name in ("flash_fwd", "flash_delta", "flash_bwd_dq",
                     "flash_bwd_dkv"):
            assert res[r]["counts"][name] > 0, (name, res[r]["counts"])
        for a, w in zip(res[r]["out"], want):
            w = w.float()[:, :, r * 256:(r + 1) * 256].cpu().numpy()
            assert np.abs(a - w).max() <= tol * np.abs(w).max()


def test_nccl_on_a_shared_card_raises(dev, monkeypatch):
    """NCCL refuses two ranks on one device, so asking for it with more
    ranks than cards raises, naming the fix; None resolves to gloo."""
    from paddle_tpu_torch.distributed import resolve_backend
    monkeypatch.setenv("LOCAL_WORLD_SIZE",
                       str(torch.cuda.device_count() + 1))
    with pytest.raises(RuntimeError, match="Duplicate GPU"):
        resolve_backend("nccl", "cuda")
    assert resolve_backend(None, "cuda") == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert resolve_backend(None, "cuda") == "nccl"


def _a2a_rank(rank):
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel.mesh import make_mesh
    torch.cuda.set_device(0)
    mesh = make_mesh(dp=1, sp=2)
    x = torch.arange(2 * 6 * 8 * 3, dtype=torch.float32).reshape(
        2, 6, 8, 3) + 1000 * rank
    comm.reset_staged()
    on_card = comm.all_to_all(x.cuda(), "sp", 1, 2, mesh)
    staged = comm.STAGED["calls"]
    on_cpu = comm.all_to_all(x, "sp", 1, 2, mesh)
    return {"card": on_card.cpu(), "cpu": on_cpu, "staged": staged,
            "pinned": comm._Stage.buffer(x).is_pinned()}


def test_staged_all_to_all_equals_gloo_on_cpu(dev, tmp_path):
    """A CUDA tensor's all-to-all over gloo goes through page-locked host
    memory (the transport rule: send and receive buffers page-locked)
    and gives the CPU all-to-all's bits."""
    from torch_dist_util import run_world
    res = run_world(_a2a_rank, 2, tmp_path)
    for r in range(2):
        np.testing.assert_array_equal(res[r]["card"], res[r]["cpu"])
        assert res[r]["staged"] == 1
        assert res[r]["pinned"]


def _fleet_rank(rank):
    """The fleet's ZeRO-3 SGD step (reduce-scatter and all-gather staged
    through the host for CUDA tensors over gloo) and a SyncBatchNorm, on
    the card and on the CPU from the same numbers."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn import SyncBatchNorm
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    rs = np.random.RandomState(3)
    w0 = rs.randn(8, 6).astype(np.float32)
    batch = {"x": rs.rand(16, 8).astype(np.float32),
             "y": rs.rand(16, 6).astype(np.float32)}
    x_bn = torch.from_numpy(rs.randn(4, 3, 5, 5).astype(np.float32) + rank)

    def loss(p, b, key):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    out = {}
    for d in ("cuda", "cpu"):
        s = fleet.DistributedStrategy()
        s.sharding = True
        s.sharding_configs = {"stage": 3}
        step, _ = fleet.build_hybrid_train_step(s, loss, SGD(0.1, device=d))
        params, state = step.init_opt_state({"w": torch.from_numpy(w0)},
                                            device=d)
        comm.reset_staged()
        for _ in range(2):
            _loss, params, state = step(params, state, batch, None)
        out[d] = {"w": step.gather_params(params)["w"].cpu(),
                  "chunk": tuple(params["w"].shape),
                  "staged": comm.STAGED["calls"]}
        bn = SyncBatchNorm(3, mesh=make_mesh(dp=2), device=d)
        out[d]["bn"] = bn(x_bn.to(d)).detach().cpu()
        out[d]["bn_mean"] = bn._mean.cpu()
    return out


def test_fleet_zero3_and_sync_batchnorm_on_card_match_cpu(dev, tmp_path):
    """Two ranks sharing the card over gloo: the fleet's ZeRO-3 step
    (the parameters split over dp, their gradients reduce-scattered and
    the leaves all-gathered through page-locked memory) and SyncBatchNorm
    give the CPU world's numbers within 1e-5 of their magnitude (phase
    4k (d)'s limit; float32 sums in another order)."""
    from torch_dist_util import run_world
    res = run_world(_fleet_rank, 2, tmp_path)
    errs = {(r, k): float(np.abs(res[r]["cuda"][k] - res[r]["cpu"][k]).max()
                          / np.abs(res[r]["cpu"][k]).max())
            for r in range(2) for k in ("w", "bn", "bn_mean")}
    assert max(errs.values()) <= 1e-5, errs
    for r in range(2):
        card, cpu = res[r]["cuda"], res[r]["cpu"]
        assert card["chunk"] == cpu["chunk"] == (4, 6)
        assert card["staged"] > 0 and cpu["staged"] == 0, (card, cpu)
    np.testing.assert_array_equal(res[0]["cuda"]["w"], res[1]["cuda"]["w"])


def _sharded_serving_rank(rank):
    """A tp-2 sharded server (rank 0 plans, rank 1 follows) and, on rank
    0, the unsharded server, both on the card, on the same prompts."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.models import GPT2, GPT2Config
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving_dist import ShardedEngineConfig

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = GPT2(GPT2Config.tiny(), seed=0, dtype=torch.float32,
                 device="cuda")
    rs = np.random.RandomState(3)
    prompts = [rs.randint(1, 1024, (n,)).astype(np.int32)
               for n in (5, 37, 9, 23)]
    kw = dict(max_slots=2, block_size=8, max_prompt_len=64,
              max_new_tokens=8, prefill_chunk_tokens=16)
    kernels.reset_launch_counts()
    srv = PagedGenerationServer(model, sharding=ShardedEngineConfig(tp=2),
                                **kw)
    if rank:
        out = srv.serve_follower()
    else:
        srv.start()
        out = {"outs": [f.result(timeout=120) for f in
                        [srv.submit(p) for p in prompts]]}
        srv.stop()
        out.update(digest=srv._dist.digest(),
                   graphs=srv.stats()["sharding"]["graphs"])
    out["counts"] = kernels.launch_counts()
    if rank == 0:
        plain = PagedGenerationServer(model, **kw).start()
        out["plain"] = [f.result(timeout=120) for f in
                        [plain.submit(p) for p in prompts]]
        plain.stop()
    return out


def test_sharded_server_on_card_matches_unsharded(dev, tmp_path):
    """Two ranks sharing the card over gloo, tp 2: the tokens equal the
    unsharded server's on the card (the tiny float32 GPT-2 has no near
    tie on these prompts), both ranks' token digests are equal, every
    dispatch is eager, and K1 and K2 launch on both ranks."""
    from torch_dist_util import run_world
    res = run_world(_sharded_serving_rank, 2, tmp_path)
    for a, b in zip(res[0]["outs"], res[0]["plain"]):
        np.testing.assert_array_equal(a, b)
    assert res[0]["digest"] == res[1]["digest"]
    assert res[0]["graphs"].startswith("off (world > 1")
    for r in range(2):
        c = res[r]["counts"]
        assert c["ragged_stream_dense"] > 0 and c["paged_decode_dense"] > 0


# ---- the Paddle 2.0 eager API on the card ------------------------------------

def _api_classifier(ptt, n_layers):
    """chip_smoke.py phase 4a's user model at a small width (hidden 128,
    2 heads of D 64)."""
    nn = ptt.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(1000, 128)
            layer = nn.TransformerEncoderLayer(128, 2, 256, dropout=0.0,
                                               attn_dropout=0.0)
            self.encoder = nn.TransformerEncoder(layer, n_layers)
            self.head = nn.Linear(128, 2)

        def forward(self, ids, mask):
            attn = ptt.cast(ptt.unsqueeze(mask, [1, 2]), "bool")
            h = self.encoder(self.embed(ids), attn)
            m = ptt.unsqueeze(ptt.cast(mask, "float32"), -1)
            return self.head(ptt.sum(h * m, axis=1) / ptt.sum(m, axis=1))

    return Net()


def _api_batch(ptt):
    rs = np.random.RandomState(4)
    real = np.arange(96)[None] < np.array([96, 50])[:, None]
    return (ptt.to_tensor(rs.randint(1, 1000, (2, 96)) * real),
            ptt.to_tensor(real.astype(np.int64)),
            ptt.to_tensor(np.array([0, 1])))


def test_api_encoder_classifier_on_card_matches_cpu(dev):
    """A user's encoder classifier (N = 2) through the 2.0 API: built on
    the default device (the card), its weights carried to a CPU copy by
    state_dict / set_state_dict; one AdamW step of the user loop on each:
    loss within 1e-4, gradients within 1e-3 of their magnitude, K4 bias
    / K6 / K9 bias launched once a layer."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.device import device_guard
    from paddle_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    ptt.seed(0)
    net = _api_classifier(ptt, 2)
    assert net.embed.weight.device.type == "cuda"
    with device_guard("cpu"):
        cpu = _api_classifier(ptt, 2)
        cpu.set_state_dict(net.state_dict())
    out = {}
    for d, model in (("cuda", net), ("cpu", cpu)):
        with device_guard(d):
            opt = ptt.optimizer.AdamW(1e-4, parameters=model.parameters())
            ids, mask, labels = _api_batch(ptt)
            kernels.reset_launch_counts()
            loss = ptt.nn.functional.cross_entropy(model(ids, mask), labels)
            loss.backward()
            out[d] = (loss.item(), [p.grad.cpu() for p in model.parameters()],
                      kernels.launch_counts())
            opt.step()
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    # phase 4d's floor: a gradient whose exact value is zero (the k_proj
    # biases) is rounding noise on both sides
    floor = 1e-3 * max(c.abs().max() for c in out["cpu"][1])
    for a, c in zip(out["cuda"][1], out["cpu"][1]):
        assert (a - c).abs().max() <= 1e-3 * max(c.abs().max(), floor)
    for n in ("flash_fwd_bias", "flash_delta", "flash_bwd_bias"):
        assert out["cuda"][2][n] == 2, out["cuda"][2]
    for a, c in zip(net.parameters(), cpu.parameters()):
        assert (a.detach().cpu() - c.detach()).abs().max() <= 2e-4 + 1e-6


def test_api_auto_cast_reaches_bf16_flash(dev):
    """Under amp.auto_cast at O2 (or O1 with the attention's op name in
    custom_white_list) the encoder's attention runs in bfloat16 through
    K4 bias / K9 bias; at the default O1 it runs float32 (the
    reference's lists) — the same kernels, float32 operands."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import attention, kernels

    ptt.seed(0)
    net = _api_classifier(ptt, 2)
    ids, mask, labels = _api_batch(ptt)
    seen = []
    real = attention.flash_attention_bias

    def spy(q, *a, **k):
        seen.append(q.dtype)
        return real(q, *a, **k)

    attention.flash_attention_bias = spy
    try:
        for kw in ({"level": "O2"},
                   {"custom_white_list": ["scaled_dot_product_attention"]},
                   {}):
            seen.clear()
            kernels.reset_launch_counts()
            with ptt.amp.auto_cast(**kw):
                loss = ptt.nn.functional.cross_entropy(net(ids, mask),
                                                       labels)
            loss.backward()
            c = kernels.launch_counts()
            want = torch.float32 if not kw else torch.bfloat16
            assert seen == [want, want], (kw, seen)
            assert c["flash_fwd_bias"] == 2 and c["flash_bwd_bias"] == 2, c
            assert torch.isfinite(loss)
            net.zero_grad()
    finally:
        attention.flash_attention_bias = real


def test_api_float16_attention_takes_the_dense_path(dev):
    """float16 reaches the flash kernels' float16 instances, as bfloat16
    does (the name is kept from the rule it replaced, ROADMAP §C 31):
    MultiHeadAttention in float16 on the card launches K4, K6 and K9 on
    their float16 counters only, and no dense-path call."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import attention, kernels

    mha = ptt.nn.MultiHeadAttention(128, 2).to(dtype="float16")
    x = ptt.randn([2, 64, 128]).half()
    kernels.reset_launch_counts()
    calls, real = [], attention.dense_attention
    attention.dense_attention = lambda *a, **k: (calls.append(1),
                                                 real(*a, **k))[1]
    try:
        out = mha(x, x, x)
        out.float().sum().backward()
    finally:
        attention.dense_attention = real
    assert out.dtype == torch.float16 and torch.isfinite(out).all()
    launched = {n: v for n, v in kernels.launch_counts().items() if v}
    assert launched == {"flash_fwd_f16": 1, "flash_delta_f16": 1,
                        "flash_bwd_f16": 1} and not calls, launched
    with torch.no_grad():
        want = ptt.nn.MultiHeadAttention(128, 2)
        want.set_state_dict(mha.state_dict())
        ref = want(x.float(), x.float(), x.float())
    assert (out.float() - ref).abs().max() <= 1e-2


# ---- the Paddle 2.0 API, part 2: Model.fit and the DataLoader on the card ----

class _PaddedText:
    """(ids [96] with pad id 0 past the length, label) a sample."""

    def __init__(self, n=8):
        rs = np.random.RandomState(6)
        lens = rs.randint(20, 97, n)
        self.ids = rs.randint(1, 1000, (n, 96)) * (
            np.arange(96)[None] < lens[:, None])
        self.labels = rs.randint(0, 2, (n, 1))

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.labels[i]


def _masked(ptt, inner):
    """The user's network of one input: the padding mask from the ids."""

    class Masked(ptt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.inner = inner

        def forward(self, ids):
            return self.inner(ids, ptt.cast(ids != 0, "int64"))

    return Masked()


def test_api_model_fit_on_card_matches_cpu(dev):
    """paddle.Model(net).fit over DataLoader worker processes on the card
    against num_workers=0 on the CPU from the same weights and seed: the
    same batches, each step's loss within 1e-4, the parameters within
    2 · lr · steps; K4 bias / K6 / K9 bias launched once a layer a step
    (2 layers, 2 steps)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.device import device_guard
    from paddle_tpu_torch.ops import kernels

    ptt.seed(0)
    net = _masked(ptt, _api_classifier(ptt, 2))
    with device_guard("cpu"):
        cpu = _masked(ptt, _api_classifier(ptt, 2))
        cpu.set_state_dict(net.state_dict())
    seen = {}
    for d, model, workers in (("cuda", net, 2), ("cpu", cpu, 0)):
        with device_guard(d):
            m = ptt.Model(model)
            m.prepare(ptt.optimizer.AdamW(1e-4,
                                          parameters=model.parameters()),
                      ptt.nn.CrossEntropyLoss(), ptt.metric.Accuracy())
            losses, batches = [], []

            class Rec(ptt.callbacks.Callback):
                def on_batch_end(self, mode, step, logs=None):
                    losses.append(logs[0][0])

            real = m.train_batch

            def spy(inputs, labels=None):
                batches.append(inputs[0].cpu().clone())
                assert inputs[0].device.type == d
                return real(inputs, labels)

            m.train_batch = spy
            kernels.reset_launch_counts()
            np.random.seed(3)
            m.fit(_PaddedText(), batch_size=4, epochs=1, shuffle=True,
                  num_workers=workers, verbose=0, callbacks=[Rec()])
            seen[d] = (losses, batches, kernels.launch_counts())
    (lc, bc, counts), (lp, bp, _) = seen["cuda"], seen["cpu"]
    assert len(bc) == len(bp) == 2
    for a, b in zip(bc, bp):
        assert torch.equal(a, b)
    for a, b in zip(lc, lp):
        assert abs(a - b) <= 1e-4 * abs(b)
    for n in ("flash_fwd_bias", "flash_delta", "flash_bwd_bias"):
        assert counts[n] == 4, counts
    assert counts["flash_fwd"] == counts["flash_bwd"] == 0
    for a, c in zip(net.parameters(), cpu.parameters()):
        assert (a.detach().cpu() - c.detach()).abs().max() <= 4e-4 + 1e-6


class _CudaState:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        return np.array([i, int(torch.cuda.is_initialized())], np.int64)


def test_api_dataloader_worker_does_not_init_cuda(dev):
    """The consumer has started CUDA; its forked workers never do (they
    ship numpy), and the batches land on the card."""
    import paddle_tpu_torch as ptt

    torch.zeros(1, device=dev)
    assert torch.cuda.is_initialized()
    rows = []
    for b in ptt.io.DataLoader(_CudaState(), batch_size=2, num_workers=2):
        assert b.device.type == "cuda"
        rows.append(b.cpu())
    rows = torch.cat(rows)
    assert rows[:, 0].tolist() == list(range(8))
    assert rows[:, 1].tolist() == [0] * 8


# ---- paddle.vision and the fluid-era detection ops on the card --------------

def test_vision_resnet50_step_card_vs_cpu(dev):
    """ResNet-50 (1000 classes) at B 2, 224², one train step + AdamW
    (lr 1e-4, wd 0.01), NCHW and NHWC on the card against NCHW on the CPU
    from one set of weights: in float64 the loss, every gradient (1e-3 of
    its leaf's magnitude), the BatchNorm buffers and the parameters; in
    float32 the loss (1e-4), the buffers (1e-4) and the parameters
    (2 * lr): float32 rounding through batch norm's backward at B 2 moves
    some gradients by a tenth on either device, so they are held in
    float64 only."""
    import copy

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.device import device_guard
    from paddle_tpu_torch.vision.models.resnet import BottleneckBlock, ResNet

    rs = np.random.RandomState(61)
    x = torch.from_numpy(rs.rand(2, 3, 224, 224).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 1000, 2))
    with device_guard("cpu"):
        ptt.seed(61)
        bases = {f: ResNet(BottleneckBlock, 50, data_format=f)
                 for f in ("NCHW", "NHWC")}
        bases["NHWC"].set_state_dict(bases["NCHW"].state_dict())
    xs = {"NCHW": x, "NHWC": x.permute(0, 2, 3, 1).contiguous()}

    def step(fmt, d, dt):
        m = copy.deepcopy(bases[fmt]).to(device=d, dtype=dt)
        m.train()
        opt = ptt.optimizer.AdamW(1e-4, parameters=m.parameters(),
                                  weight_decay=0.01, device=d)
        loss = ptt.nn.functional.cross_entropy(m(xs[fmt].to(d, dt)),
                                               y.to(d))
        loss.backward()
        grads = {n: p.grad.double().cpu() for n, p in m.named_parameters()}
        opt.step()
        return loss.item(), grads, {k: v.detach().double().cpu()
                                    for k, v in m.state_dict().items()}

    for dt in (torch.float64, torch.float32):
        lc, gc, sc = step("NCHW", "cpu", dt)
        for fmt in ("NCHW", "NHWC"):
            lg, gg, sg = step(fmt, dev, dt)
            assert abs(lg - lc) <= 1e-4 * abs(lc), (fmt, dt)
            for k, v in sc.items():
                if k.endswith(("_mean", "_variance")):
                    assert (sg[k] - v).abs().max() <= 1e-4 * v.abs().max()
                else:
                    assert (sg[k] - v).abs().max() <= 2e-4 + 1e-6, k
            if dt == torch.float64:
                for n, g in gc.items():
                    assert (gg[n] - g).abs().max() <= \
                        1e-3 * g.abs().max(), n


def test_detection_chain_card_vs_cpu(dev):
    """yolo_box -> multiclass_nms, roi_align / roi_pool, prior_box ->
    box_coder and generate_proposals on the card against the CPU:
    indices and classes equal, floats within 1e-4 of the largest
    magnitude; NMS's loop makes no host synchronisation."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import vision

    rs = np.random.RandomState(7)
    yx = torch.from_numpy(rs.randn(1, 16, 16, 16).astype(np.float32))
    rx = torch.from_numpy(rs.randn(2, 8, 20, 20).astype(np.float32))
    xy = rs.rand(6, 2) * 14
    rois = torch.from_numpy(np.concatenate(
        [xy, xy + rs.rand(6, 2) * 5 + 1], 1).astype(np.float32))
    gt = torch.from_numpy(rs.rand(5, 4).astype(np.float32) * 0.5)
    gt[:, 2:] += gt[:, :2] + 0.05
    ps = torch.from_numpy(rs.rand(1, 3, 8, 8).astype(np.float32))
    pd = torch.from_numpy(rs.randn(1, 12, 8, 8).astype(np.float32) * 0.1)

    def chain(d):
        out = {}
        b, s = F.yolo_box(yx.to(d), torch.tensor([[416, 416]], device=d),
                          [10, 13, 16, 30], 3)
        out["nms"] = F.multiclass_nms(b[0], s[0].T, score_threshold=0.05,
                                      nms_top_k=100, keep_top_k=30,
                                      background_label=-1)
        out["roi_align"] = vision.ops.roi_align(
            rx.to(d), rois.to(d), boxes_num=torch.tensor([2, 4]),
            output_size=5)
        out["roi_pool"] = F.roi_pool(rx.to(d), rois.to(d), output_size=5)
        pb, pv = F.prior_box(torch.zeros(1, 8, 10, 10, device=d),
                             torch.zeros(1, 3, 160, 160, device=d), [32.0],
                             [64.0], [2.0], flip=True, clip=True)
        out["box_coder"] = F.box_coder(pb.reshape(-1, 4), pv.reshape(-1, 4),
                                       gt.to(d))
        an, av = F.anchor_generator(torch.zeros(1, 4, 8, 8, device=d),
                                    [32.0], [0.5, 1.0, 2.0], stride=[16., 16.])
        out["proposals"] = F.generate_proposals(
            ps.to(d), pd.to(d), torch.tensor([[128., 128., 1.]], device=d),
            an, av, pre_nms_top_n=100, post_nms_top_n=20,
            return_rois_num=True)
        return out

    card = chain(dev)
    cpu = chain("cpu")
    boxes = rois.to(dev)
    scores = torch.rand(6, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kept = vision.ops.nms(boxes, scores, 0.3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(kept.cpu(), vision.ops.nms(rois, scores.cpu(), 0.3))
    for k, want in cpu.items():
        got = card[k] if isinstance(card[k], tuple) else (card[k],)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            a = a.cpu()
            if not b.is_floating_point():
                assert torch.equal(a, b), k
            else:
                assert (a - b).abs().max() <= 1e-4 * max(
                    b.abs().max().item(), 1e-30), k
    assert torch.equal(card["nms"][:, 0].cpu(), cpu["nms"][:, 0])


# ---- paddle.slim's integer path on the card -----------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 147, 1000), (16, 8, 8), (17, 9, 3),
                                   (64, 576, 64), (200, 4608, 512),
                                   (3, 2048, 10)])
def test_slim_int_mm_padded_shapes_match_cpu(dev, m, k, n):
    """`slim.int8_matmul` (`torch._int_mm` through cuBLASLt, its shape
    rules met by padding) gives the CPU integer path's int32 accumulators
    exactly, m <= 16 and k, n off multiples of 8 included."""
    from paddle_tpu_torch import slim

    g = torch.Generator().manual_seed(m * k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    want = slim.int8_matmul(a, slim.int8_weight_matrix(w), n)
    got = slim.int8_matmul(a.to(dev), slim.int8_weight_matrix(w.to(dev)), n)
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want.long(), a.long() @ w.long())


def test_slim_int8_conv_and_codes_match_cpu(dev):
    """A calibrated int8 QuantedConv2D (stride 2, padding, dilation,
    groups) and QuantedLinear on the card: the same codes, accumulators
    and outputs as on the CPU (the rescale within 1e-6)."""
    from paddle_tpu_torch import nn, slim
    from paddle_tpu_torch.device import device_guard

    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 8, 23, 23, generator=g)
    with device_guard("cpu"):
        conv = nn.Conv2D(8, 16, 3, stride=2, padding=2, dilation=2,
                         groups=2)
        lin = nn.Linear(24, 40)
    xl = torch.randn(5, 24, generator=g)
    for layer, inp, wq in ((conv, x, "channel_wise_abs_max"),
                           (lin, xl, "abs_max")):
        cls = slim.QuantedConv2D if layer is conv else slim.QuantedLinear
        outs = {}
        for d in ("cpu", dev):
            import copy
            q = cls(copy.deepcopy(layer).to(d), mode="calib",
                    act_observer="hist", weight_quantize_type=wq)
            q(inp.to(d))
            q.convert()
            xq = slim.quantize_symmetric(inp.to(d), q._a_scale_frozen)
            outs[str(d)] = (q._a_scale_frozen, q._wq.cpu(), xq.cpu(),
                            q._contract_int8(xq).cpu(), q(inp.to(d)).cpu())
        cpu, card = outs["cpu"], outs[str(dev)]
        assert abs(card[0] - cpu[0]) <= 1e-6 * cpu[0]
        for a, b in zip(card[1:4], cpu[1:4]):
            assert torch.equal(a, b)
        assert (card[4] - cpu[4]).abs().max() <= 1e-6 * cpu[4].abs().max()


def test_predictor_replays_the_exported_program_on_the_card(dev, tmp_path):
    """jit.save of a padded 2-layer encoder on the card, served by
    create_predictor on the card: one CUDA graph a batch shape, its output
    bitwise the loaded program run eagerly and within 1e-5 of the eager
    layer's largest logit, K4 bias launched once a layer a replay (a
    capturing run adds its eager warm-up's)."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.static import InputSpec

    class Enc(ptt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = ptt.nn.Embedding(100, 64)
            self.enc = ptt.nn.TransformerEncoder(
                ptt.nn.TransformerEncoderLayer(64, 2, 128, dropout=0.0), 2)

        def forward(self, ids, mask):
            bias = (1.0 - mask.float())[:, None, None, :] * -1e4
            return self.enc(self.embed(ids), bias).mean(1)

    with ptt.device.device_guard(dev):
        net = Enc().eval()
    prefix = str(tmp_path / "enc")
    jit.save(net, prefix, input_spec=[InputSpec([None, 32], "int64")] * 2)
    pred = create_predictor(Config(prefix + ".pdmodel",
                                   prefix + ".pdiparams"))
    for b, launches in ((2, 4), (3, 4), (2, 2)):
        rs = np.random.RandomState(b)
        ids = rs.randint(1, 100, (b, 32))
        mask = (np.arange(32)[None] < rs.randint(8, 33, (b, 1))) \
            .astype(np.int64)
        kernels.reset_launch_counts()
        out = pred.run([ids, mask])
        assert kernels.launch_counts()["flash_fwd_bias"] == launches
        ts = [torch.from_numpy(a).to(dev) for a in (ids, mask)]
        assert torch.equal(out, pred._translated(*ts).cpu())
        with torch.no_grad():
            want = net(*ts).cpu()
        assert (out - want).abs().max() <= 1e-5 * want.abs().max()
    assert (pred.graph_captures, pred.graph_replays) == (2, 3)


def test_static_program_trains_through_the_kernels_on_the_card(dev):
    """A static Program with the attention op, run by an Executor on the
    card: K4 bias, K6 and K9 bias launch once a step, and the step's loss
    and gradients match the same Program on the CPU (1e-4, 1e-3 of a
    leaf)."""
    import numpy as np
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.static as st
    from paddle_tpu_torch.ops import kernels

    def build(device):
        main, startup = st.Program(), st.Program()
        with ptt.device.device_guard(device), st.program_guard(main,
                                                                startup):
            x = st.data("x", [2, 4, 16, 32], "float32")
            bias = st.data("bias", [2, 16], "float32")
            q = st.nn.fc(x, 32, num_flatten_dims=3)
            out = ptt.ops.flash_attention.flash_attention_bias(
                q, q, q, bias)
            loss = (out * out).mean()
            ptt.optimizer.SGD(0.1).minimize(loss)
        return main, startup, loss, st.Executor(device)

    ptt.enable_static()
    try:
        progs = [build(d) for d in (dev, "cpu")]
        feed = {"x": np.random.RandomState(0).randn(2, 4, 16, 32)
                .astype(np.float32),
                "bias": np.where(np.arange(16)[None] < [[16], [9]], 0.0,
                                 -1e9).astype(np.float32)}
        outs, init = [], None
        for i, (main, startup, loss, exe) in enumerate(progs):
            scope = st.Scope()
            exe.run(startup, scope=scope)
            names = [p.name for p in main.all_parameters()]
            if init is None:  # the card's initial weights, for the CPU
                init = [scope.find_var(n).cpu().clone() for n in names]
            else:
                for n, v in zip(names, init):
                    scope.set(n, v)
            kernels.reset_launch_counts()
            outs.append(exe.run(main, feed=feed, fetch_list=[loss] + [
                p.name + "@GRAD" for p in main.all_parameters()],
                scope=scope))
            if i == 0:
                c = kernels.launch_counts()
                assert (c["flash_fwd_bias"], c["flash_delta"],
                        c["flash_bwd_bias"]) == (1, 1, 1)
    finally:
        ptt.disable_static()
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-4)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
