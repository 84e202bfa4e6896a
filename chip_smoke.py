#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`paddle_tpu_torch`) on one card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs a CUDA
card and the CUDA toolkit (`nvcc`); it imports nothing of JAX or of the
JAX package. Phases, each printing its own line; any failure exits
non-zero before the result line:

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — the kernels from paddle_tpu_torch/csrc (the first-use path
               of ops/kernels.py), with the seconds it took;
  3. kernels — K1 (ragged stream) and K2 (paged decode), dense and int8,
               at GPT-2-small shapes (H=12, Dh=64, BS=16; one K2 case at
               BS=128; a tiny H=4, Dh=32, BS=4 case), each against its
               plain PyTorch version on the same inputs, with times:
               the kernel, the plain version, and as `library_ms`
               F.scaled_dot_product_attention on pre-gathered contiguous
               K/V (excluding the gather; the port never calls it).
               K1 in bf16 is the tensor-core kernel of
               csrc/ragged_stream_sm90.cu: every K1 case must give the
               same bits over two launches and zeros on pad rows; its
               timed rows print the profiler's device time and the
               wrapper's host time a call; beside phase 3's ~512-token
               case (T 512) it holds C1, a serving-scale stream (T 4096:
               4 fresh 512-token chunks and 4 second chunks of
               1024-token prompts; timed, with its share of the bound,
               TFLOP/s and a contiguous torch.sum of the same bytes), C2
               (Dh 128 BS 16, and Dh 64 BS 128; untimed) and C3, 64
               segments of 8 query tokens ending at
               np.random.RandomState(12).randint(64, 1025, 64) (T 512,
               several segments a tile; timed, with the key passes of
               each 64-row tile).
               K2 is the split-KV kernel of csrc/paged_decode_sm90.cu
               (split + combine): its rows also print the profiler's
               device time per call beside the CUDA-event time (which
               includes the wrapper's host time at this size); every K2
               case must give the same bits over two launches; edge
               lengths at each K2 shape (a context on a split boundary
               of `decode_split_plan` and one key either side, ctx past
               M * BS, an idle row, ctx 0 giving zeros); and a timed
               serving-scale case (B=128 slots, H=12, Dh=64, BS=16,
               lengths np.random.RandomState(11).randint(64, 1025, 128)
               with row 0 idle: sum ctx 66,399, M 64) with its share of
               the bound and, as the practical ceiling under this
               measurement, a contiguous torch.sum of the same bytes;
  4. decoder — GPT-2 small, 12 layers, float32 (TF32 off): one packed
               prefill of a 3-segment stream, 8 steps and one
               multistep(4) on the card (kernels) and on the CPU (plain
               versions, device="cpu") with the same weights; logits
               within atol=2e-3 and identical greedy tokens. The same on
               int8 pools (4b), which is the run the int8 K2's launch
               count comes from;
  4f. bf16 decoder — the same program (prefill and 8 steps) with GPT-2
               small's weights in bf16 on the card, dense and int8 pools,
               against those weights in float32 on the CPU: logits within
               5e-2 of the CPU logits' largest magnitude (its basis at
               BF16_DECODER_REL), greedy tokens identical but for near
               ties. The int8 run is the bf16 K1's only main path with
               int8 pools: the int8 K1's launch count comes from it;
  4s. sampler — float32, TF32 off: (a) the PRNG streams
               (paddle_tpu_torch/sampling/prng.py) for 8 rows x V 50257,
               seeds {0, 1, 2^31, 2^32 - 1} and four from
               RandomState(2026), steps {0, 1, 31, 2^31 - 1}: random bits
               and uniforms on the card bitwise the CPU's, the Gumbel
               noise within 4 ulp (the ulp of max(|g|, 1)); (b) one
               [8, 50257] float32 logits array from RandomState(5)
               through sample_tokens on the card and on the CPU in every
               mode (greedy, sampled, penalties, both), rows mixing
               greedy, temperature, top-k, top-p, min-p and the three
               penalties: identical tokens, each row's smallest top-two
               margin of filt + gumbel printed; (c) GPT-2 small float32
               (phase 4's weights) served on the card: 8 requests mixing
               greedy, sampled and penalized with fixed seeds, at k = 1,
               k = 4 and k = 1 with the requests in reverse order (other
               slots): the three runs' tokens identical, and each token
               of the first run replayed by the CPU sampler from the
               card's own logits (return_logits; a decode dispatch is a
               graph replay, whose logits the eager step recomputes on
               the card, `GraphSpy`) and the same (seed,
               step) — identical wherever the top-two margin of
               filt + gumbel is >= MARGIN (1e-5); the draws below it are
               counted and printed (a stated tolerance);
  4g. offline generation — float32 GPT-2 small (phase 4's weights), TF32
               off, 16-token prompts from RandomState(41) x 16 new tokens,
               the card against the same weights on the CPU: the dense
               greedy generate (its graph bitwise the eager program on
               the card), a left-padded batch of lengths 16/9/12/3 (== the
               CPU's and == each prompt generated alone), a sampled
               generate (temperature 0.8, top-k 40, top-p 0.95, seed 1234:
               identical but where the CPU's top-two margin of filt +
               gumbel is under MARGIN, printed), the paged generate with
               dense and int8 pools (== the dense generate of the same
               kind and == the CPU's; K2 L x 16 launches each: the step
               graph's eager warm-up and 15 replays), W8A16, int8 KV and
               both through the dense program; then a W8A16
               export_generator -> jit.load onto the card (served ==
               generate bitwise) and GenerationServer over it (8
               mixed-length requests in one batch, each row == its
               prompt's generate). Greedy rows may differ only at a near
               tie: both tokens' CPU logits (one prefill of the prefix)
               within 2 x phase 4's limit of the top one at the first
               difference, listed;
  5. serving — GPT-2 small in bfloat16: PagedGenerationServer(max_slots=8,
               block_size=16, max_prompt_len=768, max_new_tokens=32,
               prefill_chunk_tokens=512) serving 16 prompts of 64-768
               tokens, a warm and a measured pass, then again with
               steps_per_dispatch=8. Launch counters are zeroed just
               before each measured pass and read just after: K1 must
               have run >= 12 x prefill dispatches and K2 >= 12 x decode
               steps. Every decode dispatch is one CUDA graph replay
               (replays must equal dispatches); a third pass runs under
               torch.profiler for the device's busy time and idle share
               (1 - busy / the measured pass's wall, as
               scripts/torch_serve_profile.py reads it). The k = 1 and
               k = 8 passes give the same greedy tokens but for near ties
               (phase 4f's rule: prefill packings differ between them);
  5g. decode graph — before phase 5, outside the server: GPT-2 small's
               decoder on 8 slots (lengths RandomState(5) 64-768, slot 5
               idle), two dispatches of multistep(k) through one captured
               graph and through the eager loop from one state, for
               weights bf16 / W8A16 x pools dense / int8 x greedy /
               sampled / penalties x k 1 / 4 / 8: tokens, stops, counts
               and every pool element bitwise equal; the replay's launch
               counts equal the eager loop's and it makes no host sync
               (set_sync_debug_mode("error")); host us a dispatch and wall
               ms to a synchronize, eager against graph;
  5s. sampled serving — phase 5's 16 prompts at k = 1, every request
               sampled (temperature 0.8, top-p 0.95, seeds 1000 + the
               request's index): tokens/s, TTFT and ITL beside phase 5's
               greedy k = 1 pass of the same call, with phase 5's launch
               and graph checks and idle share; then the sampler alone
               at 8 x 50257 (the
               store's arguments of that traffic): its device time and
               kernel launches per decode step (torch.profiler), its
               host time per call, and the store's host time per
               `step_args`, beside the greedy argmax's;
  5w. W8A16 weights — (a) float32 GPT-2 small (phase 4's weights) with
               quantization="w8a16", dense and int8 pools: phase 4's
               decoder program card vs CPU within phase 4's limits, then
               served (8 prompts of 16-60 tokens from RandomState(9), 16
               new tokens) on the card and on the CPU: tokens identical
               but for near ties (both tokens' CPU logits within 2 x phase
               4's limit at the first difference), counted; (b) bf16
               W8A16 on phase 5's traffic at k = 1: tokens/s, ITL, TTFT,
               the params' bytes and idle share beside phase 5's bf16
               k = 1 pass of the same call;
  5p. prefix cache — (b) `PagedKVCache.prepare_write`'s copy-on-write
               at GPT-2 small's pool shape (L12 H12 Dh64 BS16) equals its
               source block bit for bit in every layer, float32, bf16 and
               int8 (codes with scales), under
               torch.cuda.set_sync_debug_mode("error"); an int8 chain
               demoted to the host tier and promoted back is bit for bit
               the original; the host time a call of attach_prefix,
               prepare_write (one copy), free and publish_prefix on a
               578-token prompt resubmitted at that shape in bf16. (a) float32, TF32
               off, phase 4's weights on
               phase 5's server with 8 new tokens: a 512-token system
               prompt from RandomState(7) with tails of 1, 7, 16, 33 and
               96 tokens, then the 16-token prompt again (attached at
               len - 1, mid-block: a copy-on-write); the first alone, four
               as a burst, the resubmission alone. Caching on and off give
               identical tokens on dense and int8 pools, greedy and at
               fixed seeds (temperature 0.8, top-p 0.95), with hit_tokens,
               cow_copies and K1 launches > 0; then a pool one block above
               one request's worst case plus its spare (evictions > 0,
               tokens identical), and on it a HostKVTier at watermark 0.5
               (demotions, promotions and tier hit_tokens > 0; every
               promoted row held to the row demoted: int8 bit for bit,
               dense within absmax/254; int8 tokens identical to the
               tier-off run, the dense run's differing requests counted).
               (c) bench.py's shared-prefix axis (bench.py:675-734) in
               bf16 on phase 5's server, cut to 16 requests: a 512-token
               prefix, tails of 32-96 tokens (warm pools salts 21 and 23,
               measured salt 22), 4 new tokens, Poisson arrivals (seed
               4321) at 0.3 x the uncached closed-loop drain rate measured
               in the same call; caching off then on: TTFT p50/p99, ITL
               p99, tokens/s, prefill dispatches, prompt tokens dispatched,
               hit rate, evictions and cow_copies, with K1 >= 12 x prefill
               dispatches and K2 >= 12 x decode steps; greedy tokens on vs
               off identical but for near ties by phase 4f's rule
               (counted);
  5v. speculation and the unified round — (k) K1 on a verify stream
               through `verify_window_attention`: 8 windows of 9 query
               rows (K 8) at H 12, Dh 64, BS 16 over contexts of 64-1024
               positions (RandomState(51) dense, (52) int8), pad rows and
               a padding row, dense and int8, bf16 and float32: held to
               `verify_window_attention_plain` (the reference's dense
               per-row fallback) on the rows with pos >= 0 within phase
               3's tolerances (2e-2 bf16, 1e-4 float32), pad rows zeros,
               two launches bit for bit; in bf16 the key passes per tile,
               events, profiler device time, the wrapper's host time, the
               plain version, SDPA over each row's pre-gathered keys as
               `library_ms`, and the share of the bound. (a) float32,
               TF32 off, GPT-2 small (phase 4's weights): `packed_verify`
               and the window `unified_round` (carry chained) through one
               graph each against the eager programs on 8 slots, dense
               and int8, greedy and sampled + penalties: outputs, counts,
               carries and pools bitwise, a replay's launches the eager
               dispatch's, no host sync in a replay; then 8 repetitive
               prompts (RandomState(31)) x 16 new tokens, requests
               cycling greedy / sampled / penalties / both, served on
               the card and on the CPU with speculation off, n-gram
               (K 8), replay (the card's speculation-off tokens), the
               unified round and async rounds: every server's tokens card
               == CPU == speculation off; verify replays == verify
               dispatches, window replays == rounds without prefill rows,
               dispatches_per_round 1.0 with a mixed round, every async
               dispatch under set_sync_debug_mode("error"). (b) bf16 GPT-2
               small (phase 4f's weights), block 16: bench.py's
               speculation axis (bench.py:1655-1700, its on-TPU
               parameters: 16 repetitive prompts picked from 64 by a
               simulated n-gram drafter over continuations recorded by the
               port's plain server, 8 slots, K 8, 64 new tokens, chunk
               512): speculation off, n-gram, replay, int8 pools off and
               n-gram; then its unified axis (bench.py:1758-1800: 32
               prompts of 64-256 tokens from RandomState(17), 128 new
               tokens, chunk 256, Poisson arrivals at 8 x the split
               drain rate): split, unified sync, async. A warm, a
               measured and a profiled pass each: tokens/s, TTFT and ITL
               p50/p99, acceptance, verify dispatches and the K1
               launches they added (counted around each verify replay),
               idle share, overlap_fraction; tokens against speculation
               off / split but for near ties (phase 4f's rule); the
               served verify dispatch alone (8 x 9 rows, one replay): ms
               by events, device ms, K1's device ms and launches;
  3b. flash  — K4 (forward with LSE), K6 (delta) and K9 (fused
               backward) against their plain versions on the same inputs,
               bf16 and f32: at the training path's shape (B=16, H=12,
               S=1024, D=64, causal), a ragged one (B=2, H=4, S=1000,
               D=32, causal and not) and, in bf16, B=2 H=8 S=2048 D=128
               causal (the bf16 kernels' two TMA boxes a row and their
               register peak) and B=2 H=4 Sq=384 Sk=256 D=64 causal (dead
               rows through the bf16 K9). In bf16 K4 and K9 are the
               tensor-core kernels of csrc/flash_fwd_sm90.cu and
               csrc/flash_bwd_sm90.cu. K9's dk and dv must be bitwise
               equal over two launches. Errors are relative to the plain
               output's largest magnitude: 2e-2 for out/dq/dk/dv in bf16,
               1e-4 for everything else. Times at the main shape in bf16:
               the kernel, the plain version, and as `library_ms` one
               PyTorch call for the same function (K4: the forward of
               F.scaled_dot_product_attention; K9: its backward through
               torch.autograd.grad; K6: torch.linalg.vecdot) — none of
               them on the port's path. For K4 and K9 also the achieved
               TFLOP/s, the share of the bound and the ratio to the
               library time (the same for K4 bias and K9 bias in 3c);
               for K6 its device time (profiler), share of the bound and
               a contiguous torch.sum of the same bytes;
  4c. train parity — GPT-2 small, 12 layers, float32 (TF32 off), batch
               2 x 256, dropout 0: two AdamW steps (lr 1e-4, wd 0.01) on
               the card (kernels) and on the CPU (plain versions) from the
               same weights; loss within 1e-4 relative at each step, each
               gradient within 1e-3 of its largest magnitude, parameters
               within 2 * lr * steps + 1e-6 after two steps; K4, K6 and K9
               must each launch exactly 12 times per step on the card;
  6. training — GPT-2 small, bf16 compute on float32 masters (the
               reference bench's mixed-precision step), batch 16 x 1024,
               AdamW: 2 warm and 5 measured steps on one fixed batch;
               tokens/s, ms per step (CUDA events), peak memory, first and
               last loss. Fails on a non-finite loss, a last loss not
               below the first, or K4/K6/K9 launching other than
               12 x steps times in the measured steps;
  3c. bias flash — K4 bias (forward with a per-key bias) and K9 bias
               (fused backward with dbias), with K6 between them, against
               their plain versions, bf16 and f32: at BERT-large's
               attention shape (B=16, H=16, S=512, D=64, not causal) with
               a per-row padding mask from lengths in 128-512; a ragged
               causal one (B=2, H=4, S=300, D=32); Sq != Sk (256 x 384);
               a [1, Sk] bias broadcast over the batch; and a batch row
               that is fully masked (not causal and causal). out, lse, dq,
               dk, dv and dbias within phase 3b's tolerances; K9 bias's dk,
               dv and dbias bitwise equal over two launches. Times at the
               main shape in bf16: the kernel, the plain version, and as
               `library_ms` F.scaled_dot_product_attention with attn_mask
               = bias[:, None, None, :] (its forward; its backward through
               torch.autograd.grad);
  4d. BERT train parity — BERT-large width and depth, float32 (TF32 off),
               batch 2 x 128 padded to lengths 128 and 77, MLM labels from
               the port's create_mlm_batch plus NSP labels: two AdamW steps
               through pretraining_loss(..., attention_mask=...) on the card
               and on the CPU from the same weights, with phase 4c's limits
               (a gradient whose exact value is zero — the k_proj biases —
               is held to 1e-3 of the step's largest gradient); K4 bias, K6
               and K9 bias launch exactly num_layers times per step on the
               card, the unbiased K4/K9 never;
  6b. BERT training — BERT-large, bf16 compute on float32 masters,
               AdamW (lr 1e-4, wd 0.01), dropout 0, batch 16 x 512 padded
               with lengths from np.random.RandomState(0) in 128-512 (pad
               id 0; token types 0 for the first half of each sequence, 1
               after; MLM labels from create_mlm_batch(mask_prob=0.15);
               random NSP labels): 2 warm and 13 measured steps (at this
               constant lr without warmup, post-LN BERT-large's loss spikes
               at step 2 and falls below its start only from step 9 on —
               in the kernels, the plain attention and float32 alike);
               tokens/s (padded tokens, as bench.py counts them), ms per
               step (CUDA events), peak memory, first and last loss. Fails
               on a non-finite loss, a last loss not below the first, or
               K4 bias/K6/K9 bias launching other than 24 x steps times;
  3d. two-pass flash — K7 (dq) and K8 (dk, dv) and their bias variants
               K7 bias / K8 bias (dbias too), with K4 (bias) and K6 before
               them, against their plain versions on the same inputs, bf16
               and f32, within phase 3b's tolerances: (a) the training
               shape (B=16, H=12, S=1024, D=64, causal), also against K9
               (bias) on the same inputs; (b) B=1, H=2, S=16384, D=64,
               causal, bf16 (the plain version at H=2: its [S, S] float32
               tensors take 2.1 GB each); (c) ragged B=2, H=4, S=1000,
               D=32, causal and not; (d) Sq != Sk, 256 x 384, not causal,
               and 600 x 100 causal (dead rows; q tiles that see no key),
               and in bf16 B=2, H=8, S=2048, D=128, causal;
               (e) an LSE and delta of attention over [k0; k1] with the
               kernels run on k1 alone (a ring block); (f) phase 3c's bias
               cases, and phase 6c's padded batch at H=2 (B=2, S=16384,
               D=64, causal, bf16, lengths 16384 and 10240, the per-row
               bias at its long batch stride; the plain version peaks near
               26 GB). In every case two launches must give the same bits
               (g: no atomics), and K9 (bias) runs on the same inputs
               (h): K7's dq within the tolerance of K9's (its largest
               difference printed), and in bf16 K8's dk, dv and dbias
               equal to K9's bit for bit. In bf16 K7 is the tensor-core
               kernel of csrc/flash_bwd_dq_sm90.cu (K4's wgmma/TMA loop
               with dS.K in place of P.V, its dS formed as the bf16 K9's)
               and K8 csrc/flash_bwd_sm90.cu's body without its dq; the
               float32 K7 and K8 are SIMT kernels of
               csrc/flash_bwd_two_pass.cu. Times at (a) and at 3c's main
               shape in bf16: the kernel, the plain version, and as
               `library_ms` the backward of F.scaled_dot_product_attention
               through torch.autograd.grad (K9's yardstick, for the pair),
               and K7's and K8's achieved TFLOP/s, share of the bound and
               ratio to that library time;
  4e. long-context parity — GPT-2 layout with 2 layers, hidden 128, 2
               heads (D 64), vocab 1024, max_position 13312 (13 x 1024,
               past the reference's switch to the two-pass backward at
               S 13108 for D 64), float32 (TF32 off): two AdamW steps on
               the card and on the CPU from the same weights at 1 x 13312
               unpadded, then padded to 9000 tokens (an additive
               [1, 1, 1, S] mask through logits(..., attn_mask=) and
               cross_entropy, pad labels -100), with phase 4c's limits;
               per step on the card K7 and K8 (their bias variants when
               padded) launch num_layers times each and K9 (bias) never;
  6c. long-context training — GPT-2 small at full width with
               max_position 16384, dropout 0, bf16 on float32 masters,
               AdamW (lr 1e-4, wd 0.01): 1 x 16384 unpadded (1 warm and 3
               measured steps) and 2 x 16384 padded to lengths 16384 and
               10240 (1 warm and 2 measured); tokens/s (padded tokens
               counted), ms per step (CUDA events), peak memory, losses.
               Fails on a non-finite loss, K7/K8 (bias) launching other
               than 12 x steps times, or K9/K9 bias launching at all;
  3e. seq2seq kernels — K4 at the cached decode step's shape, one query
               (Sq = 1) over Sk in {1, 2, 63, 64, 65, 127, 128, 129, 255}
               keys (B 32, H 8, D 64: WMT base's heads), bf16 and f32,
               against its plain version within phase 3b's tolerances, out
               and lse bitwise over two launches; at Sk 64 in bf16 the
               kernel by events and by the profiler, the plain version,
               SDPA and the dense path (`ops.attention.dense_attention`,
               the route of a masked call) by events and by the profiler,
               and the bound. Then phase 3b's K4/K6/K9 case at the
               training cross-attention's Sq 96 / Sk 128 (B 4, not
               causal) and phase 3c's K4 bias/K6/K9 bias case under a
               padded source (B 8, H 8, S 128), both dtypes, with K4
               (bias)'s out and lse bitwise over two launches;
  4t. seq2seq parity — the seq2seq Transformer at WMT base (Vaswani et al.
               2017: 6 + 6 layers, d 512, 8 heads, ffn 2048, V 30000; the
               reference's TransformerConfig defaults; the embeddings
               drawn from N(0, d_model^-0.5), the published model's
               initialization, see `wmt_embeddings`), float32 (TF32
               off), dropout 0: (a) two AdamW steps (lr 1e-4, wd 0.01) of
               the label-smoothed (0.1) loss at B 4, S_src 128, S_tgt 96 on
               the card and on the CPU from the same weights, with phase
               4c's limits (the k_proj biases as in 4d); K4, K6 and K9
               launch 12 times a step (6 encoder self-attentions, 6
               cross-attentions; the decoder's masked self-attention is
               the dense path), the bias kernels never; then the logits of
               a padded source (lengths 128/100/77/40: K4 bias in the
               encoder, 6 launches) card vs CPU within 1e-4 of their
               largest magnitude. (b) 8 sources of 64 tokens
               (RandomState(41)), max_len 64: greedy cached, greedy
               uncached and beam 4 (length penalty 0.6) on the card
               against the CPU's cached greedy and beam: identical but
               where the CPU's margin at a row's first difference is below
               1e-4 (the top two logits; for beams the smallest gap among
               a row's top K + 1 candidates up to that step), printed; the
               cached greedy run launches K4 6 + 12 x 63 times, 12 x 63 of
               them at Sq = 1;
  6t. seq2seq training and decoding — (a) WMT base (4t's
               initialization) at its published dropout 0.1 (so every attention is the dense path), bf16 on
               float32 masters (phase 6's recipe through
               `models.transformer.loss_with`), label smoothing 0.1,
               AdamW, B 32, S_src 128, S_tgt 128: 2 warm and 5 measured
               steps on one batch: ms per step (CUDA events), target
               tokens/s, peak memory, losses (finite, falling), and from a
               profiled pass of 2 steps the device's busy time and idle
               share; no kernel launches. (b) bf16 greedy and beam 4
               (length penalty 0.6) decoding of 32 sources x 64 tokens
               (RandomState(43)) at max_len 64: ms per decode step and
               output tokens/s (host clock), K4's launches (12 a step at
               Sq = 1 plus the encoder's 6; the dense path never runs), and
               from a profiled run K4's device time, its share of the
               busy time and the idle share;
  6g. offline generation in bf16 — GPT-2 small (phase 4f's weights): (a)
               bench.py's decode axis (bench.py:340-390: B 8, prompt 64,
               192 new, greedy) in bf16, W8A16 and W8A16 with int8 KV,
               each through the dense program's graph and through the
               paged generate: ms per token step by bench.py's
               differencing of 192 and 64 new tokens (each the best
               of two calls after a warm one), tokens/s, peak memory,
               and from one
               profiled 64-token call the device's busy time, idle
               share and device kernels a token step; (b) bench.py's
               padded-batcher axis (bench.py:585-600): GenerationServer
               over an exported bf16 artifact loaded onto the card (B 8,
               prompt_len 768, 32 new), phase 5's 16 prompts, a warm and
               a measured pass: tokens/s, latency p50/p99, batch_fill,
               beside phase 5's paged k = 1 pass of the same call;
  5r. fault-tolerant, observable serving (after 6g) — (a) float32 GPT-2
               small (phase 4's weights), TF32 off, 4 slots, block 16, 16
               new tokens: the composed split stack (prefix cache, n-gram
               speculation, a stop-string request through a toy
               detokenizer, an on_token stream; 4 random prompts from
               RandomState(61) and a periodic one queued behind them)
               under the reference test's chaos plan R_PLAN_SPLIT, then
               unified + async under R_PLAN_UNIFIED: a fault-free run with
               an empty plan first (it counts each seam's occurrences:
               every planned one must be reachable), then the plan. Every
               planned seam fires; the survivors equal the fault-free run
               but for near ties (phase 4g's rule, listed); at most one
               request is quarantined; health ok with recoveries >= 1; K1
               (and K2 on the split stack) launched; every decode, verify
               and window dispatch a replay; captures equal the fault-free
               run's. (b) decode:0,decode:1,decode:2 on two requests:
               exactly one quarantined at seam decode, the other the
               fault-free tokens (prefix cache on: warm resumes). (c) 8 requests
               (RandomState(64)) with a
               journal; kill() from the main thread once R_KILL_AT tokens
               were streamed (the stream holds that token until the server
               is stopped); the killed server freed (gc, empty_cache); a
               fresh one recovers the journal; all 8 outputs equal the
               uninterrupted run but for near ties; resumes, warm resumes
               and re-prefilled tokens printed. (d) bf16 (phase 4f's
               weights) on phase 5's server and traffic at k = 1 with the
               ops endpoint (expose_port=0): /healthz, /healthz/live,
               /healthz/ready, /metrics and /statusz answer 200 during the
               first pass, /metrics holds R_METRICS; warm_buckets before
               start() leaves the first pass and the measured window with
               no capture; a GenerationServer over 6g (b)'s artifact, in
               an untimed pass with the registry on (6g (b)'s timed pass
               keeps it off), counted its requests, latencies and stop
               reasons. (e) telemetry off and on (metrics, tracing, flight
               recorder, endpoint) in turns, off, on, on, off: tokens/s,
               TTFT p50 and idle share of each, the ratio of the means;
               the seconds from an injected fault at decode dispatch
               R_FAULT_AT to the first successful dispatch after it
               (flight-recorder timestamps);
  5f. the serving front door (after 5r) — (a) float32 GPT-2 small
               (phase 4's weights), TF32 off, 2 slots, block 16, a pool
               two batch residents hold whole (F_BLOCKS): 4 batch
               requests of tenants t1 and t4 (weights 1 and 4; one with a
               stop string of 5r's toy detokenizer) queued before start(),
               the engine held at their second token until 2 interactive
               requests (TTFT deadline 250 ms) are queued; on the split
               stack, then unified + async: every request's tokens equal
               a plain PagedGenerationServer's but for near ties (phase
               4g's rule, listed), preemptions >= 1 with cached tokens
               > 0, each stream's text is its detokenized tokens (the stop
               string suppressed), K1 (and K2 on the split stack)
               launched, every decode dispatch (window round) a replay.
               (b) float32, HostKVTier + tier_prefetch=2 under a front
               door on three prompts sharing a 256-token prefix (its chain
               demoted, the one slot held busy while they queue): prefetch
               hits >= 1, tokens equal tier_prefetch off. (c) bf16 (phase
               4f's weights) on phase 5's server (prefix cache on) and its
               16 prompts at k = 1, 8 batch (tenants alternating) then 8
               interactive (deadline 250 ms) once the batch residents
               stream: the plain server, then the front door (SLOs,
               attribution, the ops endpoint): tokens/s, TTFT p50/p99 a
               lane, preemptions, deadline misses and the idle share of
               each; /slo and /capacity answer 200 (schema_version 1); the
               cost report's tenants' device-ns equal its busy-ns; the
               timeline has dispatch-track events; every request's causal
               trace tiles its wall clock and each preempted request's
               trace shows its requeue; 5f's wall time;
  4h. parallel training (after 6t), float32, TF32 off: 16 ranks spawned
               on the card (`hybrid_phase`; init_parallel_env resolves
               gloo: NCCL refuses two ranks on one device), each with a
               hard limit (H_TIMEOUT: the ranks are killed and the phase
               fails). The parent first computes reference_loss of the
               hybrid GPT-2 small (hidden 768, 12 heads, 12 layers, vocab
               50257 padded to 50258) at B 8 x S 1024, its gradients and
               two AdamW steps (lr 1e-4, wd 0.01) on the card; (d) the
               world of one (the hybrid code, every axis 1) within 1e-6
               of it — at every axis 1 the hybrid code takes the same
               attention, layer norm and log_softmax as reference_loss,
               as the reference's does, so this holds the plumbing only;
               the vocab-parallel CE and the ring are held by (b). In the
               ranks: (a) ring_attention flash at B 2, H 12,
               S 1024, D 64, causal, over sp 2 and sp 4, zigzag and
               Ulysses over sp 4, out and the three gradients within 1e-4
               of flash_attention on one rank, every ring rank launching
               K4, K6, K7 and K8 (Ulysses K4, K6, K9); (b) dp 2 x pp 2 x mp
               2 x sp 2, 2 microbatches: the loss within 1e-4 and every
               gradient within 1e-3 of reference_loss's (phase 4c's
               limits), last_impl_used() == "flash"; (d) the step twice,
               bitwise; (g) the params saved as a sharded checkpoint and
               reloaded into dp 4 x pp 2 x mp 2: the loss within 1e-5;
               (c) two AdamW steps with ZeRO-1 slots against the parent's:
               each step's loss within 1e-4 and each leaf's update within
               H_UPDATE_REL (||p - p_ref|| / ||p_ref - p0||, the worst
               leaf; the state before the updates reads 1 there), every
               parameter within 2 * lr * steps; (e) build_pp_train_step over pp 2, GPipe
               and interleaved (V 2), B 4 x S 256, against lm_loss (K4 and
               K9 launched); (f) MoE over ep 4 (T 1024, d 768, hidden 3072,
               4 experts) against the experts whole on one rank;
  6h. the hybrid's bf16 step on float32 masters (ZeRO-1 AdamW) in the
               same 16 ranks: ms a step, each rank's device busy share
               (profiler over one step), the seconds a step spent in
               host-staged collectives (`parallel.comm.STAGED`) — 16 ranks
               time-sharing one card over gloo: not a multi-GPU number —
               and the world of one's bf16 step beside phase 6's;
  4k. the fleet's strategy layer (after 4h/6h), float32, TF32 off: the
               parent runs the world of one (`fleet.init` ->
               `distributed_optimizer` -> `build_hybrid_train_step`,
               GPT-2 small, B 4 x S 1024: its gradients at the initial
               weights and two AdamW steps, lr 1e-4, wd 0.01; then the
               amp step timed), 2 ranks spawned on the card over gloo,
               hard limit K_TIMEOUT: (a) plain, ZeRO stages 1-3,
               gradient merge (k 2), recompute full and selective, two
               steps each, losses within 1e-4 and gradients within 1e-3
               of the world of one's (phase 4c's limits), each leaf's
               update within 1e-2 (4h (c)'s), every rank launching K4,
               K6 and K9; amp: float32 masters, losses within
               BF16_DECODER_REL of float32, its ms a step beside the
               world of one's (2 ranks time-sharing one card: not a
               multi-GPU number); (b) at 2 layers, B 4 x S 128: localsgd
               (copies differ after step 1, bitwise equal after step 2),
               dgc (residual non-zero, the loss falls), int8_allreduce
               (and the int8 all-reduce of the gradients within 2 max|g|
               / 254 of the float32 mean), fp16_allreduce, lamb, lars
               (Momentum) and the pipeline over pp 2, each card vs CPU by
               phase 4c's limits (parameters 2 lr steps; Lars also the
               update within 1e-2); (d) SyncBatchNorm over the 2 ranks vs
               BatchNorm over the global batch within 1e-5; then in the
               parent (c) a PSEmbedding tower card vs CPU and (e) `python
               -m paddle_tpu_torch.distributed.launch --nproc_per_node 2`
               with one all_reduce on the card;
  5d. sharded serving (after 4k; `sharded_phase`), ranks spawned on the
               card over gloo (hard limit D_TIMEOUT), every rank building
               each server with the same arguments, rank 0 planning and
               the others following (`serve_follower()`), every dispatch
               eager: K1/K2 at H 6 (a tp-2 rank's heads) vs plain, then
               GPT-2 small against the unsharded server on the card
               (graphs on), float32: (a) tp 2, phase 5's 16 prompts x 32
               with 4s's sampling rows — tokens equal but for near ties
               (phase 4g's rule; sampled rows: both draws within 4e-3 of
               the top draw), every rank's token digest equal to rank
               0's, K1 and K2 launched on every rank (counts printed a
               rank); (b) tp 2 prefix cache off == on (hits and a
               copy-on-write the pool mirror replays) == unsharded, 4
               slots, then a front door preempt-and-resume; (c) tp 2 x
               sp 2 (4 ranks), allgather and ring, one D_LONG-token
               prompt over the D_CHUNKS sweep: tokens equal, ring's peak
               fresh-K/V bytes within `sp_attention_flat_bound`,
               max_memory_allocated a rank; bf16: (e) tp 2 on phase 5's
               traffic (warm pass, measured pass, rank 0 profiled):
               tokens/s, TTFT, ITL, rank 0's idle share beside phase 5's
               k = 1 — ranks time-sharing one card over gloo: not a
               multi-GPU number; (d) tp 2 int8 collectives on 8 of the
               prompts, tokens equal (e)'s but for phase 4f's near ties,
               wire bytes <= D_WIRE_RATIO of the bf16 wire;
  7. the kernels line (JSON; each kernel's launches summed over the
     main-path runs that reach it: phases 5, 5s, 5w, 5p, 5v (b), 5r, 5f, 4b, 4f,
     4g, 6g (a), 6, 6b, 6c, 4t, 6t, 4h/6h's, 4k's and 5d's ranks ((a),
     (b), (c)); the `ragged_stream_verify_*` rows
     are K1 on verify streams: 5v (k)'s numbers, and the launches 5v (b)'s verify
     dispatches added; the `flash_fwd_decode` row is K4 at Sq = 1: 3e's
     numbers at Sk 64, and the Sq = 1 launches of 4t's and 6t's decodes,
     which the `flash_fwd` row counts too), the card line, and as the last
     line {"ok": true, "device": {...}}.

Bounds (`bound_ms`): the larger of the bytes the function must move (each
input read once, each output written once; only the K/V positions this
run's lengths reach) over 3.35 TB/s and its FLOPs over 989 TFLOP/s (the
H100 SXM bf16 dense peak, applied to the float32 SIMT kernels too), from
this run's inputs. Flash FLOPs count only the (query, key) pairs the
causal mask leaves visible; the bias variants count every pair (the bias
is data, not structure). Per pair K4 does 4 * D FLOPs, K9 10 * D, K7
6 * D (s, dp, dq) and K8 8 * D (s, dp, dv, dk).
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 989e12
REPO = os.path.dirname(os.path.abspath(__file__))
K1_REPLACES = "paddle_tpu/ops/pallas/unified_attention.py:206"
K2_REPLACES = "paddle_tpu/ops/pallas/unified_attention.py:327"
FLASH_REPLACES = {
    "flash_fwd": "paddle_tpu/ops/pallas/flash_attention.py:228",
    "flash_delta": "paddle_tpu/ops/pallas/flash_attention.py:483",
    "flash_bwd": "paddle_tpu/ops/pallas/flash_attention.py:504",
    "flash_fwd_bias":
        "paddle_tpu/ops/pallas/flash_attention.py:228 (has_bias)",
    "flash_bwd_bias":
        "paddle_tpu/ops/pallas/flash_attention.py:504 (has_bias)",
    "flash_bwd_dq": "paddle_tpu/ops/pallas/flash_attention.py:580",
    "flash_bwd_dkv": "paddle_tpu/ops/pallas/flash_attention.py:615",
    "flash_bwd_dq_bias":
        "paddle_tpu/ops/pallas/flash_attention.py:580 (has_bias)",
    "flash_bwd_dkv_bias":
        "paddle_tpu/ops/pallas/flash_attention.py:615 (has_bias)"}
# K1 in bf16 (the timed rows); the float32 K1 is unified_attention.cu's
SOURCE = "paddle_tpu_torch/csrc/ragged_stream_sm90.cu"
FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
FWD_SOURCE = "paddle_tpu_torch/csrc/flash_fwd_sm90.cu"  # K4 (bias) in bf16
# K9 and K8 (bias) in bf16
BWD_SOURCE = "paddle_tpu_torch/csrc/flash_bwd_sm90.cu"
DQ_SOURCE = "paddle_tpu_torch/csrc/flash_bwd_dq_sm90.cu"  # K7 (bias) in bf16
DECODE_SOURCE = "paddle_tpu_torch/csrc/paged_decode_sm90.cu"  # K2
# K2's kernels in a profiler key (the split kernel and its combine)
K2_NAME = re.compile(r"(?:^|[\s:])paged_decode\w*")
K1_NAME = re.compile(r"(?:^|[\s:])ragged_stream\w*")  # either dtype's
K6_NAME = re.compile(r"(?:^|[\s:])flash_delta\w*")
# phase 4f's limit: the bf16 decoder's logits within this share of the
# float32 CPU logits' largest magnitude. Basis: bf16 keeps 8 significant
# bits (unit roundoff 2^-8, 0.39%); the logits come out of a residual
# stream rounded at ~80 sites in series (12 layers: layer norms, q/k/v,
# attention, projections, MLP), whose errors add as a random walk to
# ~sqrt(80) * 0.39% = 3.5% at worst alignment of a vector; int8 K/V add at
# most half a code step, 1/254 of a vector's largest element.
BF16_DECODER_REL = 5e-2
FLASH = ("flash_fwd", "flash_delta", "flash_bwd")
FLASH_BIAS = ("flash_fwd_bias", "flash_delta", "flash_bwd_bias")
TWO_PASS = ("flash_fwd", "flash_delta", "flash_bwd_dq", "flash_bwd_dkv")
TWO_PASS_BIAS = ("flash_fwd_bias", "flash_delta", "flash_bwd_dq_bias",
                 "flash_bwd_dkv_bias")
FUSED_BWD = ("flash_bwd", "flash_bwd_bias")
# phase 4s: the PRNG rows (seed, step) and the tolerances
SAMPLE_SEEDS = [0, 1, 2**31, 2**32 - 1] + [
    int(x) for x in np.random.RandomState(2026).randint(
        0, 2**32, 4, dtype=np.uint64)]
SAMPLE_STEPS = [0, 1, 31, 2**31 - 1] * 2
# the Gumbel noise on the card within this many ulp of the CPU's, the ulp
# taken at max(|g|, 1): -log(-log(u)) of bitwise-equal uniforms, two
# correctly rounded logs (<= 1 ulp each) whose error near g = 0 is that of
# the inner -log(u) relative to its size. Since the logs are IEEE-exact
# float64 arithmetic (prng._log) the two sides are expected bitwise; the
# count of entries that are not is printed
GUMBEL_ULPS = 4
# a replayed draw must give the card's token where the top two of
# filt + gumbel lie at least this far apart: 10x the noise's largest
# error at |g| <= 8 (4 ulp of 8 is 3.8e-6)
MARGIN = 1e-5
DEV = "cuda"  # the card every phase runs on (the CPU is the other side
# of the phase 4 comparison)


def say(*parts):
    print(*parts, flush=True)


def fail(msg):
    say(f"FAIL {msg}")
    sys.exit(1)


# ---- timing ----------------------------------------------------------------

class Timer:
    """Median of per-launch CUDA-event times, with the 50 MB L2 flushed
    (a 64 MiB write) before every launch: on the serving path each layer's
    launch reads another layer's pool, cold."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)

    def ms(self, fn, reps=25, warm=2):
        torch = self.torch
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def device_ms(self, fn, pattern, reps=25, warm=2):
        """Device time per call of the kernels whose profiler key matches
        `pattern`, summed over a window of `reps` calls (L2 flushed before
        each) under torch.profiler: the kernels' own time, without the
        wrapper's host time that CUDA events around a short call see."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA \
                    and pattern.search(ev.key):
                us += getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0))
        if us <= 0:
            fail(f"the profiler recorded no device time for {pattern.pattern}")
        return us / 1e3 / reps


# ---- phase 3: kernel cases --------------------------------------------------

def _tables(torch, lens, bs, idle_first, seed, m=None):
    """Disjoint random pool blocks per row, 0-padded, m columns (default:
    the longest row's blocks; a row longer than m * bs fills its m); row 0
    all-trash when idle_first (an idle decode slot: ctx 1 on block 0)."""
    rs = np.random.RandomState(seed)
    nb = [-(-int(c) // bs) for c in lens]
    m = m or max(nb)
    nb = [min(k, m) for k in nb]
    perm = rs.permutation(sum(nb) + 8) + 1
    tab = np.zeros((len(lens), m), np.int32)
    o = 0
    for b, k in enumerate(nb):
        if idle_first and b == 0:
            continue
        tab[b, :k] = perm[o:o + k]
        o += k
    return torch.from_numpy(tab).to(DEV), int(perm.max()) + 1


def _pools(torch, n, bs, h, dh, quant, g):
    from paddle_tpu_torch.inference.kv_quant import QuantizedKV, kv_encode

    k = torch.randn(n, bs, h, dh, generator=g, device=DEV)
    v = torch.randn(n, bs, h, dh, generator=g, device=DEV)
    if quant:
        return (QuantizedKV(*kv_encode(k, torch.bfloat16)),
                QuantizedKV(*kv_encode(v, torch.bfloat16)))
    return k.bfloat16(), v.bfloat16()


def _dequant(kv, dtype):
    if hasattr(kv, "codes"):
        return kv.codes.to(dtype) * kv.scales[..., None].to(dtype)
    return kv.to(dtype)


def _f32(kv):
    if hasattr(kv, "codes"):
        return type(kv)(kv.codes, kv.scales.float())
    return kv.float()


def _elem(kv):
    """Bytes per pool vector element, and per-vector scale bytes."""
    if hasattr(kv, "codes"):
        return 1, kv.scales.element_size()
    return kv.element_size(), 0


def decode_lens(torch, h, bs, m):
    """Phase 3's K2 edge lengths over an m-column table (8 rows):
    an idle row (ctx 1 on the trash block), contexts on a split boundary
    of `decode_split_plan` and one key either side, one inside the first
    split, several splits, ctx past m * bs (clamped), the full table, and
    ctx 0 (zeros)."""
    from paddle_tpu_torch.ops.kernels import decode_split_plan

    _splits, c = decode_split_plan(8, h, m, bs)
    return [1, c, c - 1, c + 1, c // 2, 3 * c + 5, m * bs + 40, 0]


def serving_lens():
    """Phase 3's serving-scale K2 case: 128 slots of GPT-2 small (up to
    its 1024 positions), row 0 idle (ctx 1 on the trash block)."""
    lens = np.random.RandomState(11).randint(64, 1025, 128)
    lens[0] = 1
    return [int(c) for c in lens]


def decode_case(torch, timer, h, dh, bs, quant, seed, timed, lens=None,
                m=None):
    """K2 against its plain version on one set of lengths (rows with ctx 0
    must be zeros; the plain version averages the table there), and two
    launches bit for bit; timed: CUDA events around the call, the
    profiler's device time of the split and combine kernels per call,
    the plain version, and SDPA on pre-gathered K/V."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import paged_decode_attention_plain

    if lens is None:
        lens = [1, 1024, 512, 777, 33, 1000, 300, 129]
        if bs == 4:
            lens = [1, 37, 16, 64]
    g = torch.Generator(device=DEV).manual_seed(seed)
    tables, n = _tables(torch, lens, bs, True, seed, m)
    kb, vb = _pools(torch, n, bs, h, dh, quant, g)
    B, M = tables.shape
    q = torch.randn(B, h, dh, generator=g, device=DEV).bfloat16()
    ctx = torch.tensor(lens, dtype=torch.int32, device=DEV)
    sc = dh ** -0.5
    out = kernels.paged_decode(q, kb, vb, tables, ctx, sc)
    again = kernels.paged_decode(q, kb, vb, tables, ctx, sc)
    torch.cuda.synchronize()
    ref = paged_decode_attention_plain(q.float(), _f32(kb), _f32(vb),
                                       tables, ctx, sc)
    live = ctx > 0
    err = (out[live].float() - ref[live]).abs().max().item()
    bitwise = torch.equal(out, again)
    ok = torch.isfinite(out).all().item() and torch.allclose(
        out[live].float(), ref[live], atol=2e-2, rtol=2e-2) \
        and bool((out[~live] == 0).all().item())
    res = {"max_abs_err": err, "ok": bool(ok), "bitwise": bitwise,
           "splits": kernels.decode_split_plan(B, h, M, bs)}
    if not timed:
        return res
    res["ms"] = timer.ms(lambda: kernels.paged_decode(q, kb, vb, tables,
                                                      ctx, sc))
    res["device_ms"] = timer.device_ms(
        lambda: kernels.paged_decode(q, kb, vb, tables, ctx, sc), K2_NAME)
    # the wrapper's host time: a host clock over many calls, no synchronise
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        kernels.paged_decode(q, kb, vb, tables, ctx, sc)
    res["host_ms"] = (time.perf_counter() - t0) * 1e3 / 200
    torch.cuda.synchronize()
    res["plain_ms"] = timer.ms(lambda: paged_decode_attention_plain(
        q, kb, vb, tables, ctx, sc))
    # library: SDPA over pre-gathered contiguous K/V (gather excluded)
    cmax = min(max(lens), M * bs)
    gk = _dequant(kb, torch.bfloat16)[tables.long()].reshape(
        B, -1, h, dh)[:, :cmax].permute(0, 2, 1, 3).contiguous()
    gv = _dequant(vb, torch.bfloat16)[tables.long()].reshape(
        B, -1, h, dh)[:, :cmax].permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(cmax, device=DEV)[None, :]
            < ctx[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    res["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
        q4, gk, gv, attn_mask=mask, scale=sc))
    del gk, gv
    e, s = _elem(kb)
    used = [min(c, M * bs) for c in lens]   # the keys each row reads
    tot = sum(used)
    nbytes = (2 * q.numel() * q.element_size()          # q in, out
              + 2 * tot * h * (dh * e + s)             # live K and V
              + sum(-(-c // bs) for c in used) * 4 + B * 4)
    flops = 4 * h * dh * tot
    res.update(_bound(nbytes, flops))
    return res


def stream_segs(kind):
    """Phase 3's K1 packings: (table row, first position, tokens) per
    segment (each padded to 8 rows, as serving packs at pack_align 8),
    and the pad rows after them. "tiny": a prefix chunk, a fresh segment,
    pads; "main" (~512 tokens): a cached-prefix chunk, a fresh segment, a
    partial segment with pads, a pad region; "serving" (C1, T 4096): 4
    fresh 512-token chunks and 4 second chunks of 1024-token prompts
    (positions 512-1023 over a 512-token cached prefix); "short" (C3, T
    512): 64 segments of 8 query tokens ending at positions from
    np.random.RandomState(12).randint(64, 1025, 64), a stream of
    speculative verify windows."""
    if kind == "tiny":
        return [(0, 10, 16), (1, 0, 13)], 5
    if kind == "main":
        return [(0, 300, 128), (1, 0, 200), (2, 0, 101)], 80
    if kind == "serving":
        return ([(r, 0, 512) for r in range(4)]
                + [(r, 512, 512) for r in range(4, 8)]), 0
    last = np.random.RandomState(12).randint(64, 1025, 64)
    return [(r, int(e) - 7, 8) for r, e in enumerate(last)], 0


def stream_passes(seg, pos, b):
    """The key passes each of the bf16 K1's tiles runs: its distinct
    segments (kernels.STREAM_ROWS rows a tile)."""
    from paddle_tpu_torch.ops.kernels import STREAM_ROWS

    out = []
    for t0 in range(0, len(seg), STREAM_ROWS):
        live = {s for s, p in zip(seg[t0:t0 + STREAM_ROWS],
                                  pos[t0:t0 + STREAM_ROWS])
                if 0 <= s < b and p >= 0}
        out.append(len(live))
    return out


def stream_case(torch, timer, h, dh, bs, quant, seed, timed, kind=None):
    """K1 against its plain version on one packing (`stream_segs`; pad
    rows must be zeros), and two launches bit for bit; timed: CUDA events
    around the call, the profiler's device time per call, the wrapper's
    host time, the plain version, and SDPA on pre-gathered K/V."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import ragged_prefill_attention_plain

    kind = kind or ("tiny" if bs == 4 else "main")
    segs, pads = stream_segs(kind)
    g = torch.Generator(device=DEV).manual_seed(seed)
    tables, n = _tables(torch, [s0 + m for _r, s0, m in segs], bs, False,
                        seed)
    seg, pos = [], []
    for r, s0, m in segs:
        fill = -(-m // 8) * 8
        seg += [r] * fill
        pos += list(range(s0, s0 + m)) + [-1] * (fill - m)
    seg += [0] * pads
    pos += [-1] * pads
    T = len(seg)
    seg_t = torch.tensor(seg, dtype=torch.int32, device=DEV)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
    kb, vb = _pools(torch, n, bs, h, dh, quant, g)
    q = torch.randn(T, h, dh, generator=g, device=DEV).bfloat16()
    sc = dh ** -0.5
    out = kernels.ragged_stream(q, kb, vb, tables, seg_t, pos_t, sc)
    again = kernels.ragged_stream(q, kb, vb, tables, seg_t, pos_t, sc)
    torch.cuda.synchronize()
    ref = ragged_prefill_attention_plain(q.float(), _f32(kb), _f32(vb),
                                         tables, seg_t, pos_t, sc)
    valid = pos_t >= 0
    ref = ref[valid]
    err = (out[valid].float() - ref).abs().max().item()
    ok = torch.isfinite(out).all().item() and torch.allclose(
        out[valid].float(), ref, atol=2e-2, rtol=2e-2) \
        and bool((out[~valid] == 0).all().item())
    del ref
    res = {"max_abs_err": err, "ok": bool(ok), "tokens": T,
           "bitwise": torch.equal(out, again),
           "passes": stream_passes(seg, pos, tables.shape[0])}
    if not timed:
        return res
    call = lambda: kernels.ragged_stream(  # noqa: E731
        q, kb, vb, tables, seg_t, pos_t, sc)
    res["ms"] = timer.ms(call)
    res["device_ms"] = timer.device_ms(call, K1_NAME)
    # the wrapper's host time: a host clock over many calls, no synchronise
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    res["host_ms"] = (time.perf_counter() - t0) * 1e3 / 200
    torch.cuda.synchronize()
    res["plain_ms"] = timer.ms(lambda: ragged_prefill_attention_plain(
        q, kb, vb, tables, seg_t, pos_t, sc), reps=10)
    # library: one SDPA call over every segment's pre-gathered keys, the
    # segment-causal mask spelled out (gather excluded)
    kd, vd = _dequant(kb, torch.bfloat16), _dequant(vb, torch.bfloat16)
    cols_k, cols_v, col_seg, col_pos = [], [], [], []
    for r, s0, m in segs:
        c = s0 + m
        rows = tables[r].long()
        cols_k.append(kd[rows].reshape(-1, h, dh)[:c])
        cols_v.append(vd[rows].reshape(-1, h, dh)[:c])
        col_seg += [r] * c
        col_pos += list(range(c))
    gk = torch.cat(cols_k).permute(1, 0, 2)[None].contiguous()
    gv = torch.cat(cols_v).permute(1, 0, 2)[None].contiguous()
    del kd, vd, cols_k, cols_v
    cs = torch.tensor(col_seg, device=DEV)
    cp = torch.tensor(col_pos, device=DEV)
    mask = (seg_t.long()[:, None] == cs[None]) & \
        (cp[None] <= pos_t.long()[:, None])
    mask[~valid, 0] = True  # pad rows: one key, no NaN row
    q4 = q.permute(1, 0, 2)[None]
    res["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
        q4, gk, gv, attn_mask=mask[None, None], scale=sc))
    del gk, gv, mask
    e, s = _elem(kb)
    keys = sum(s0 + m for _r, s0, m in segs)  # each segment's horizon
    nbytes = (2 * q.numel() * q.element_size() + 2 * T * 4
              + 2 * keys * h * (dh * e + s)
              + sum(-(-(s0 + m) // bs) for _r, s0, m in segs) * 4)
    flops = 4 * h * dh * sum(p + 1 for p in pos if p >= 0)
    res.update(_bound(nbytes, flops))
    return res


def _bound(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations",
            "bytes": int(nbytes), "flops": int(flops)}


# ---- phase 3b: flash kernels ----------------------------------------------

def _pairs(sq, sk, causal):
    """(query, key) pairs the mask leaves visible (bottom-right causal)."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq))


def _rates(phase, name, tag, r):
    """A kernel's achieved TFLOP/s, share of its bound and ratio to the
    library call, from a timed row."""
    say(f"phase {phase} {name} {tag}: {r['flops'] / r['ms'] / 1e9:.1f} "
        f"TFLOP/s achieved, {r['bound_ms'] / r['ms']:.3f} of the bound "
        f"({r['bound_by']}), {r['ms'] / r['library_ms']:.2f}x the "
        f"library's time")


def _rel_err(out, ref):
    """(max abs error, that error over the plain output's max abs)."""
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def flash_case(torch, timer, b, h, sq, sk, d, causal, dtype, seed, timed,
               phase="3b"):
    """K4, K6 and K9 against their plain versions (computed in float32
    from the same inputs), and K4's out and lse and K9's dk and dv bitwise
    equal over two launches; with `timed`, the kernel, plain and library
    times and the bounds. Returns {kernel name: row} or fails."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    g = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, n, d, generator=g, device=DEV)
                   .to(dtype) for n in (sq, sk, sk, sq))
    sc = d ** -0.5
    out, lse = kernels.flash_fwd(q, k, v, sc, causal)
    fwd_again = kernels.flash_fwd(q, k, v, sc, causal)
    delta = kernels.flash_delta(out, do)
    grads = kernels.flash_bwd(q, k, v, do, lse, delta, sc, causal)
    again = kernels.flash_bwd(q, k, v, do, lse, delta, sc, causal)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, do)]
    out_p, lse_p = pf.flash_fwd_lse_plain(f[0], f[1], f[2], sc, causal)
    delta_p = pf.flash_delta_plain(out.float(), f[3])
    grads_p = pf.flash_bwd_plain(f[0], f[1], f[2], f[3], lse, delta, sc,
                                 causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    checks = {"out": (out, out_p, tol), "lse": (lse, lse_p, 1e-4),
              "delta": (delta, delta_p, 1e-4)}
    for name, a, p in zip(("dq", "dk", "dv"), grads, grads_p):
        checks[name] = (a, p, tol)
    errs = {}
    tag = (f"B{b} H{h} {f'S{sq}' if sq == sk else f'Sq{sq} Sk{sk}'} D{d} "
           f"{'causal' if causal else 'full'} {str(dtype).split('.')[-1]}")
    for name, a, a2 in zip(("out", "lse", "dk", "dv"),
                           (out, lse) + grads[1:], fwd_again + again[1:]):
        if not torch.equal(a, a2):
            fail(f"phase {phase} {tag}: {name} differs between two "
                 f"launches")
    del again, fwd_again
    for name, (a, p, t) in checks.items():
        err, rel = _rel_err(a, p)
        errs[name] = err
        if not torch.isfinite(a).all().item() or rel > t:
            fail(f"phase {phase} {tag}: {name} disagrees with plain (max "
                 f"abs err {err:.3g}, {rel:.3g} of its magnitude > {t})")
    rows = {"flash_fwd": {"max_abs_err": max(errs["out"], errs["lse"])},
            "flash_delta": {"max_abs_err": errs["delta"]},
            "flash_bwd": {"max_abs_err": max(errs["dq"], errs["dk"],
                                             errs["dv"])}}
    say(f"phase {phase} {tag}: max abs err out {errs['out']:.3g} lse "
        f"{errs['lse']:.3g} delta {errs['delta']:.3g} dq {errs['dq']:.3g} "
        f"dk {errs['dk']:.3g} dv {errs['dv']:.3g}; out, lse, dk, dv bitwise "
        f"repeatable")
    if not timed:
        return rows
    del out_p, lse_p, delta_p, grads_p, f
    fw, dl, bw = rows["flash_fwd"], rows["flash_delta"], rows["flash_bwd"]
    fw["ms"] = timer.ms(lambda: kernels.flash_fwd(q, k, v, sc, causal))
    fw["plain_ms"] = timer.ms(lambda: pf.flash_fwd_lse_plain(
        q, k, v, sc, causal), reps=10)
    fw["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=sc))
    dl["ms"] = timer.ms(lambda: kernels.flash_delta(out, do))
    dl["device_ms"] = timer.device_ms(lambda: kernels.flash_delta(out, do),
                                      K6_NAME)
    dl["plain_ms"] = timer.ms(lambda: pf.flash_delta_plain(out, do))
    dl["library_ms"] = timer.ms(lambda: torch.linalg.vecdot(out, do))
    bw["ms"] = timer.ms(lambda: kernels.flash_bwd(q, k, v, do, lse, delta,
                                                  sc, causal))
    bw["plain_ms"] = timer.ms(lambda: pf.flash_bwd_plain(
        q, k, v, do, lse, delta, sc, causal), reps=10)
    lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                        scale=sc)
    bw["library_ms"] = timer.ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv), do, retain_graph=True))
    e, bh, pairs = q.element_size(), b * h, _pairs(sq, sk, causal)
    qv = bh * sq * d * e  # bytes of q (and out, do, dq)
    kv = bh * sk * d * e  # bytes of k (and v, dk, dv)
    fw.update(_bound(2 * qv + 2 * kv + 4 * bh * sq, 4 * bh * d * pairs))
    dl.update(_bound(2 * qv + 4 * bh * sq, 2 * bh * sq * d))
    bw.update(_bound(3 * qv + 4 * kv + 8 * bh * sq, 10 * bh * d * pairs))
    for name, r in rows.items():
        say(f"phase 3b {name} {tag}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    _rates("3b", "flash_fwd", tag, fw)
    _rates("3b", "flash_bwd", tag, bw)
    buf = torch.zeros(dl["bytes"] // 2, dtype=torch.bfloat16, device=DEV)
    dl["stream_ms"] = timer.ms(lambda: buf.sum())
    del buf
    say(f"phase 3b flash_delta {tag}: device {dl['device_ms']:.4f} ms "
        f"(profiler), {dl['bound_ms'] / dl['device_ms']:.3f} of the bound "
        f"({dl['bytes'] / 1e6:.1f} MB, {dl['bound_by']}), "
        f"{dl['bytes'] / dl['device_ms'] / 1e9:.2f} TB/s; CUDA events "
        f"{dl['ms']:.4f} ms; torch.linalg.vecdot {dl['library_ms']:.4f} ms; "
        f"a contiguous read of the same bytes (torch.sum) "
        f"{dl['stream_ms']:.4f} ms")
    return rows


# ---- phase 3c: per-key-bias flash kernels -----------------------------------

def _key_bias(torch, kind, b, sk, seed, lo, lengths=None):
    """float32 per-key bias: padding masks (0 / -1e30) from lengths in
    [lo, sk] or the `lengths` given ("lengths"), the same with batch row 0
    fully masked ("dead_row"), or one random row broadcast over the batch
    ("broadcast")."""
    rs = np.random.RandomState(seed)
    if kind == "broadcast":
        return torch.from_numpy(rs.randn(1, sk).astype(np.float32)).to(DEV)
    lens = (np.asarray(lengths) if lengths is not None
            else rs.randint(lo, sk + 1, b))
    if kind == "dead_row":
        lens[0] = 0
    bias = np.where(np.arange(sk)[None] < lens[:, None], 0.0, -1e30)
    return torch.from_numpy(bias.astype(np.float32)).to(DEV)


def bias_flash_case(torch, timer, b, h, sq, sk, d, causal, kind, dtype,
                    seed, timed, phase="3c"):
    """K4 bias, K6 and K9 bias against their plain versions (float32,
    from the same inputs), and K4 bias's out and lse and K9 bias's dk, dv
    and dbias bitwise equal over two launches; with `timed`, the kernel,
    plain and library times and the bounds. Returns {kernel name: row} or
    fails."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    g = torch.Generator(device=DEV).manual_seed(seed)
    q, do = (torch.randn(b, h, sq, d, generator=g, device=DEV).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, h, sk, d, generator=g, device=DEV).to(dtype)
            for _ in range(2))
    # the main shape's lengths are BERT's padded batch (128-512)
    bias = _key_bias(torch, kind, b, sk, seed, 128 if sk == 512 else sk // 4)
    sc = d ** -0.5
    out, lse = kernels.flash_fwd_bias(q, k, v, bias, sc, causal)
    fwd_again = kernels.flash_fwd_bias(q, k, v, bias, sc, causal)
    delta = kernels.flash_delta(out, do)
    grads = kernels.flash_bwd_bias(q, k, v, do, lse, delta, bias, sc, causal)
    again = kernels.flash_bwd_bias(q, k, v, do, lse, delta, bias, sc, causal)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, do)]
    out_p, lse_p = pf.flash_fwd_lse_plain(f[0], f[1], f[2], sc, causal,
                                          bias)
    grads_p = pf.flash_bwd_plain(f[0], f[1], f[2], f[3], lse, delta, sc,
                                 causal, bias)
    tag = (f"B{b} H{h} Sq{sq} Sk{sk} D{d} {'causal' if causal else 'full'} "
           f"{kind} {str(dtype).split('.')[-1]}")
    for name, a, a2 in zip(("out", "lse", "dk", "dv", "dbias"),
                           (out, lse) + grads[1:], fwd_again + again[1:]):
        if not torch.equal(a, a2):
            fail(f"phase {phase} {tag}: {name} differs between two "
                 f"launches")
    del again, fwd_again
    live = lse_p > -1e29  # a fully masked row's lse is the -1e30 fill
    if not (lse[~live] <= -1e29).all().item():
        fail(f"phase {phase} {tag}: a fully masked row's lse is not the "
             f"fill")
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    checks = {"out": (out, out_p, tol), "lse": (lse[live], lse_p[live], 1e-4)}
    for name, a, p in zip(("dq", "dk", "dv", "dbias"), grads, grads_p):
        checks[name] = (a, p, tol)
    errs = {}
    for name, (a, p, t) in checks.items():
        err, rel = _rel_err(a, p)
        errs[name] = err
        if not torch.isfinite(a).all().item() or rel > t:
            fail(f"phase {phase} {tag}: {name} disagrees with plain (max "
                 f"abs err {err:.3g}, {rel:.3g} of its magnitude > {t})")
    say(f"phase {phase} {tag}: max abs err " + " ".join(
        f"{n} {e:.3g}" for n, e in errs.items())
        + "; out, lse, dk, dv, dbias bitwise repeatable")
    rows = {"flash_fwd_bias": {"max_abs_err": max(errs["out"], errs["lse"])},
            "flash_bwd_bias": {"max_abs_err": max(
                errs["dq"], errs["dk"], errs["dv"], errs["dbias"])}}
    if not timed:
        return rows
    del out_p, lse_p, grads_p, f
    fw, bw = rows["flash_fwd_bias"], rows["flash_bwd_bias"]
    fw["ms"] = timer.ms(lambda: kernels.flash_fwd_bias(q, k, v, bias, sc,
                                                       causal))
    fw["plain_ms"] = timer.ms(lambda: pf.flash_fwd_lse_plain(
        q, k, v, sc, causal, bias), reps=10)
    mask = bias.to(dtype)[:, None, None, :]
    fw["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, scale=sc))
    bw["ms"] = timer.ms(lambda: kernels.flash_bwd_bias(
        q, k, v, do, lse, delta, bias, sc, causal))
    bw["plain_ms"] = timer.ms(lambda: pf.flash_bwd_plain(
        q, k, v, do, lse, delta, sc, causal, bias), reps=10)
    lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                        is_causal=causal, scale=sc)
    bw["library_ms"] = timer.ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv), do, retain_graph=True))
    # every (query, key) pair counts: the bias is data, not structure
    e, bh, pairs = q.element_size(), b * h, sq * sk
    qv = bh * sq * d * e   # bytes of q (and out, do, dq)
    kv = bh * sk * d * e   # bytes of k (and v, dk, dv)
    nb = bias.numel() * 4
    fw.update(_bound(2 * qv + 2 * kv + 4 * bh * sq + nb,
                     4 * bh * d * pairs))
    bw.update(_bound(3 * qv + 4 * kv + 8 * bh * sq + nb + 4 * bh * sk,
                     10 * bh * d * pairs))
    for name, r in rows.items():
        say(f"phase 3c {name} {tag}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    _rates("3c", "flash_fwd_bias", tag, fw)
    _rates("3c", "flash_bwd_bias", tag, bw)
    return rows


# ---- phase 3d: the two-pass backward ----------------------------------------

def _two_pass_launch(kernels, q, k, v, do, lse, delta, bias, sc, causal):
    """(dq, dk, dv, dbias or None) from K7 and K8 (bias variants with a
    bias)."""
    if bias is None:
        dq = kernels.flash_bwd_dq(q, k, v, do, lse, delta, sc, causal)
        return (dq,) + kernels.flash_bwd_dkv(q, k, v, do, lse, delta, sc,
                                             causal) + (None,)
    dq = kernels.flash_bwd_dq_bias(q, k, v, do, lse, delta, bias, sc, causal)
    return (dq,) + kernels.flash_bwd_dkv_bias(q, k, v, do, lse, delta, bias,
                                              sc, causal)


def two_pass_case(torch, timer, b, h, sq, sk, d, causal, kind, dtype, seed,
                  timed, external=False, lengths=None):
    """K7 and K8 (K7 bias and K8 bias with a bias of `kind`, from
    `lengths` when given) against their plain versions, on K4 (bias)'s lse
    and K6's delta; two launches must agree bit for bit. external: the lse
    and delta are those of attention over [k0; k1] and the kernels run on
    k1 alone. With `timed`, also
    K9 (bias) on the same inputs, the times and the bounds. Returns
    {kernel name: row} or fails."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    g = torch.Generator(device=DEV).manual_seed(seed)
    nk = 2 * sk if external else sk
    q, do = (torch.randn(b, h, sq, d, generator=g, device=DEV).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, h, nk, d, generator=g, device=DEV).to(dtype)
            for _ in range(2))
    bias = None
    if kind is not None:
        bias = _key_bias(torch, kind, b, sk, seed, 128 if sk == 512
                         else sk // 4, lengths)
    sc = d ** -0.5
    if bias is None:
        out, lse = kernels.flash_fwd(q, k, v, sc, causal)
    else:
        out, lse = kernels.flash_fwd_bias(q, k, v, bias, sc, causal)
    delta = kernels.flash_delta(out, do)
    if external:  # the second block of keys, under the global lse
        k, v = (t[:, :, sk:].contiguous() for t in (k, v))
    grads = _two_pass_launch(kernels, q, k, v, do, lse, delta, bias, sc,
                             causal)
    again = _two_pass_launch(kernels, q, k, v, do, lse, delta, bias, sc,
                             causal)
    torch.cuda.synchronize()
    tag = (f"B{b} H{h} Sq{sq} Sk{sk} D{d} {'causal' if causal else 'full'}"
           f"{' ' + kind if kind else ''}"
           f"{' ' + '/'.join(map(str, lengths)) if lengths else ''}"
           f"{' external-lse' if external else ''}"
           f" {str(dtype).split('.')[-1]}")
    for name, a, a2 in zip(("dq", "dk", "dv", "dbias"), grads, again):
        if a is not None and not torch.equal(a, a2):
            fail(f"phase 3d {tag}: {name} differs between two launches")
    f = [t.float() for t in (q, k, v, do)]
    plain = (pf.flash_bwd_dq_plain(*f, lse, delta, sc, causal, bias),) + \
        pf.flash_bwd_dkv_plain(*f, lse, delta, sc, causal, bias)
    del f
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    errs = {}
    for name, a, p in zip(("dq", "dk", "dv", "dbias"), grads, plain):
        if a is None:
            continue
        err, rel = _rel_err(a, p)
        errs[name] = err
        if not torch.isfinite(a).all().item() or rel > tol:
            fail(f"phase 3d {tag}: {name} disagrees with plain (max abs "
                 f"err {err:.3g}, {rel:.3g} of its magnitude > {tol})")
    del plain
    # (h) K9 (bias) on the same inputs: dq within the tolerance; in bf16
    # K8 is K9's tensor-core body without its dq, so dk, dv and dbias must
    # equal K9's bit for bit
    fused = (kernels.flash_bwd(q, k, v, do, lse, delta, sc, causal)
             if bias is None else
             kernels.flash_bwd_bias(q, k, v, do, lse, delta, bias, sc,
                                    causal))
    k9_diff = 0.0
    for name, a, p in zip(("dq", "dk", "dv", "dbias"), grads, fused):
        if a is None:
            continue
        err, rel = _rel_err(a, p)
        if name == "dq":
            dq_diff = err
        else:
            k9_diff = max(k9_diff, err)
        if name != "dq" and dtype == torch.bfloat16 and not torch.equal(a, p):
            fail(f"phase 3d {tag}: K8's {name} is not K9's bit for bit (max "
                 f"abs diff {err:.3g})")
        if rel > tol:
            fail(f"phase 3d {tag}: {name} disagrees with K9 (max abs "
                 f"err {err:.3g}, {rel:.3g} of its magnitude > {tol})")
    del fused
    say(f"phase 3d {tag}: max abs err vs plain " + " ".join(
        f"{n} {e:.3g}" for n, e in errs.items()) + ", bitwise repeatable; "
        + ("K8 equals K9 bit for bit" if k9_diff == 0.0 else
           f"K8 within tolerance of K9 (max abs diff {k9_diff:.3g})")
        + f"; K7's dq max abs diff from K9's {dq_diff:.3g}")
    suffix = "" if bias is None else "_bias"
    dq_row = {"max_abs_err": errs["dq"]}
    dkv_row = {"max_abs_err": max(v_ for n, v_ in errs.items() if n != "dq")}
    rows = {"flash_bwd_dq" + suffix: dq_row,
            "flash_bwd_dkv" + suffix: dkv_row}
    if not timed:
        return rows
    args = (q, k, v, do, lse, delta)
    if bias is None:
        dq_ms = timer.ms(lambda: kernels.flash_bwd_dq(*args, sc, causal))
        dkv_ms = timer.ms(lambda: kernels.flash_bwd_dkv(*args, sc, causal))
        k9_ms = timer.ms(lambda: kernels.flash_bwd(*args, sc, causal))
        mask = None
    else:
        dq_ms = timer.ms(lambda: kernels.flash_bwd_dq_bias(*args, bias, sc,
                                                           causal))
        dkv_ms = timer.ms(lambda: kernels.flash_bwd_dkv_bias(*args, bias, sc,
                                                             causal))
        k9_ms = timer.ms(lambda: kernels.flash_bwd_bias(*args, bias, sc,
                                                        causal))
        mask = bias.to(dtype)[:, None, None, :]
    dq_row["ms"], dkv_row["ms"] = dq_ms, dkv_ms
    dq_row["plain_ms"] = timer.ms(lambda: pf.flash_bwd_dq_plain(
        *args, sc, causal, bias), reps=10)
    dkv_row["plain_ms"] = timer.ms(lambda: pf.flash_bwd_dkv_plain(
        *args, sc, causal, bias), reps=10)
    lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                        is_causal=causal, scale=sc)
    lib = timer.ms(lambda: torch.autograd.grad(lo, (lq, lk, lv), do,
                                               retain_graph=True))
    dq_row["library_ms"] = dkv_row["library_ms"] = lib
    e, bh = q.element_size(), b * h
    pairs = _pairs(sq, sk, causal)
    qv, kv = bh * sq * d * e, bh * sk * d * e  # bytes of q (dO, dq); k (v)
    vec = 8 * bh * sq                           # lse and delta
    nb = 0 if bias is None else bias.numel() * 4
    dq_row.update(_bound(3 * qv + 2 * kv + vec + nb, 6 * bh * d * pairs))
    dkv_row.update(_bound(2 * qv + 4 * kv + vec + nb
                          + (0 if bias is None else 4 * bh * sk),
                          8 * bh * d * pairs))
    for name, r in rows.items():
        say(f"phase 3d {name} {tag}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    _rates("3d", "flash_bwd_dq" + suffix, tag, dq_row)
    _rates("3d", "flash_bwd_dkv" + suffix, tag, dkv_row)
    say(f"phase 3d {tag}: K7 + K8 {dq_ms + dkv_ms:.4f} ms, K9"
        f"{'' if bias is None else ' bias'} {k9_ms:.4f} ms on the same "
        f"inputs (ratio {(dq_ms + dkv_ms) / k9_ms:.2f})")
    return rows


# ---- phases 4c and 6: training ---------------------------------------------

def _batch(torch, cfg, b, s, seed, dev, lengths=None):
    """Random ids and labels [b, s]; with lengths, a padded batch: labels
    -100 and an additive [b, 1, 1, s] float32 mask of -1e30 past each
    row's length."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rs.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"input_ids": ids, "labels": labels}
    if lengths is not None:
        pad = np.arange(s)[None] >= np.asarray(lengths)[:, None]
        labels[pad] = -100
        batch["attn_mask"] = np.where(pad, -1e30, 0.0).astype(
            np.float32)[:, None, None, :]
    return {n: torch.from_numpy(a).to(dev) for n, a in batch.items()}


def lm_batch_loss(cfg, loss_fn):
    """loss(params, batch): build_train_step's loss_fn for an unpadded
    batch; for a padded one (an "attn_mask"), logits(..., attn_mask=) and
    cross_entropy over the non-pad labels (the reference's GPT2.forward
    takes the mask; its loss and train step do not)."""
    from paddle_tpu_torch.models.gpt2 import logits
    from paddle_tpu_torch.ops.loss import cross_entropy

    def loss(params, batch):
        if "attn_mask" not in batch:
            return loss_fn(params, batch)
        lg = logits(params, cfg, batch["input_ids"],
                    attn_mask=batch["attn_mask"])
        return cross_entropy(lg.reshape(-1, cfg.vocab_size),
                             batch["labels"].reshape(-1))

    return loss


def amp_train_step(torch, cfg, batch, lr=1e-4):
    """The reference bench's mixed-precision step (bench.py:179-188) on
    the card: float32 masters, bf16 copies made inside the autograd
    graph, the loss cast to float32, gradients landing on the masters,
    AdamW (wd 0.01) in float32. Returns step() -> the loss tensor."""
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.optimizer import AdamW

    loss_fn, init_params = build_train_step(cfg, device=DEV)
    loss_fn = lm_batch_loss(cfg, loss_fn)
    masters = init_params()
    opt = AdamW(lr, weight_decay=0.01, device=DEV)
    state = opt.functional_init(masters)

    def step():
        low = {n: p.to(torch.bfloat16) for n, p in masters.items()}
        loss = loss_fn(low, batch).float()
        grads = torch.autograd.grad(loss, list(masters.values()))
        opt.functional_update(masters, dict(zip(masters, grads)), state)
        return loss.detach()

    return step


def train_parity(torch, cfg, lr=1e-4, steps=2, b=2, s=256, lengths=None,
                 expect=FLASH, never=(), phase="4c"):
    """Phases 4c and 4e: float32 AdamW steps on the card and on the CPU
    from the same weights, on a [b, s] batch (padded to `lengths` with a
    mask); per step on the card each kernel of `expect` launches
    num_layers times and none of `never` launches. Returns the worst
    (loss, gradient, parameter) differences."""
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW

    loss_fn, init_params = build_train_step(cfg, device=DEV)
    loss_fn = lm_batch_loss(cfg, loss_fn)
    params = {DEV: init_params()}
    params["cpu"] = {n: p.detach().cpu().requires_grad_(True)
                     for n, p in params[DEV].items()}
    opts = {d: AdamW(lr, weight_decay=0.01, device=d) for d in params}
    states = {d: opts[d].functional_init(params[d]) for d in params}
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for step in range(steps):
        out = {}
        for d in (DEV, "cpu"):
            batch = _batch(torch, cfg, b, s, 11, d, lengths)
            kernels.reset_launch_counts()
            loss = loss_fn(params[d], batch)
            grads = torch.autograd.grad(loss, list(params[d].values()))
            counts = kernels.launch_counts()
            opts[d].functional_update(params[d], dict(zip(params[d], grads)),
                                      states[d])
            out[d] = (loss.item(), grads, counts)
        for n in expect + never:
            want = cfg.num_layers if n in expect else 0
            if out[DEV][2][n] != want:
                fail(f"phase {phase} step {step}: {n} launched "
                     f"{out[DEV][2][n]} times, expected {want}")
        rel = abs(out[DEV][0] - out["cpu"][0]) / abs(out["cpu"][0])
        worst["loss"] = max(worst["loss"], rel)
        if rel > 1e-4:
            fail(f"phase {phase} step {step}: loss {out[DEV][0]} vs CPU "
                 f"{out['cpu'][0]} (relative {rel:.3g} > 1e-4)")
        for name, a, c in zip(params[DEV], out[DEV][1], out["cpu"][1]):
            _err, r = _rel_err(a.cpu(), c)
            worst["grad"] = max(worst["grad"], r)
            if r > 1e-3:
                fail(f"phase {phase} step {step}: gradient {name} differs "
                     f"by {r:.3g} of its magnitude (> 1e-3)")
    limit = 2 * lr * steps + 1e-6
    for name, p in params[DEV].items():
        diff = (p.detach().cpu() - params["cpu"][name].detach()).abs().max()
        worst["param"] = max(worst["param"], diff.item())
        if diff.item() > limit:
            fail(f"phase {phase}: parameter {name} differs by "
                 f"{diff.item():.3g} after {steps} steps (> {limit:.3g})")
    return worst


def train_throughput(torch, cfg, batch_size=16, seq=1024, warm=2, steps=5,
                     lengths=None):
    """Phases 6 and 6c: the mixed-precision step on one fixed batch
    (padded to `lengths` with a mask); returns the measured numbers
    (tokens/s over padded tokens) and the launch counts of the measured
    steps."""
    from paddle_tpu_torch.ops import kernels

    step = amp_train_step(torch, cfg, _batch(torch, cfg, batch_size, seq, 0,
                                             DEV, lengths))
    losses = [step().item() for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()                          # main path
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    measured = [step() for _ in range(steps)]
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    losses += [x.item() for x in measured]
    ms = start.elapsed_time(end) / steps
    return {"losses": losses, "ms_per_step": ms,
            "tokens_per_sec": batch_size * seq * steps / (ms * steps / 1e3),
            "wall_s": wall, "peak": torch.cuda.max_memory_allocated(),
            "counts": counts}


# ---- phases 4d and 6b: BERT training ----------------------------------------

def bert_batch(torch, cfg, lens, seq, seed, dev):
    """A padded pretraining batch: random ids (pad id 0 past each length),
    token types 0 for the first half of each sequence and 1 after, MLM
    labels from create_mlm_batch (mask id 103) and random NSP labels.
    Returns the pretraining_loss arguments (input_ids, labels,
    next_sentence_label, token_type_ids, attention_mask)."""
    from paddle_tpu_torch.models.bert import create_mlm_batch

    rs = np.random.RandomState(seed)
    lens = np.asarray(lens)
    am = (np.arange(seq)[None] < lens[:, None]).astype(np.int32)
    ids = rs.randint(1, cfg.vocab_size, am.shape).astype(np.int32) * am
    tt = (np.arange(seq)[None] >= lens[:, None] // 2).astype(np.int32)
    masked, labels = create_mlm_batch(ids, cfg.vocab_size, 103,
                                      mask_prob=0.15, seed=seed)
    nsp = rs.randint(0, 2, (len(lens),)).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                 for a in (masked, labels, nsp, tt, am))


def bert_amp_train_step(torch, cfg, batch, lr=1e-4):
    """The mixed-precision BERT step on the card: the model's float32
    parameters are the masters; bf16 copies made inside the autograd
    graph are bound through functional_call for pretraining_loss on the
    padded batch (attention mask included); the loss is cast to float32;
    AdamW (wd 0.01) updates the masters in float32. Returns step() -> the
    loss tensor."""
    from paddle_tpu_torch.models.bert import Bert, pretraining_loss_with
    from paddle_tpu_torch.optimizer import AdamW

    model = Bert(cfg, device=DEV)
    model.train()
    masters = dict(model.named_parameters())
    opt = AdamW(lr, weight_decay=0.01, device=DEV)
    state = opt.functional_init(masters)

    def step():
        low = {n: p.to(torch.bfloat16) for n, p in masters.items()}
        loss = pretraining_loss_with(model, low, *batch).float()
        grads = torch.autograd.grad(loss, list(masters.values()))
        opt.functional_update(masters, dict(zip(masters, grads)), state)
        return loss.detach()

    return step


def bert_train_parity(torch, cfg, lr=1e-4, steps=2):
    """Phase 4d: float32 AdamW steps through pretraining_loss on a padded
    batch, on the card and on the CPU from the same weights. Returns the
    worst (loss, gradient, parameter) differences."""
    from paddle_tpu_torch.models.bert import Bert, pretraining_loss_with
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW

    models = {DEV: Bert(cfg, device=DEV), "cpu": Bert(cfg, device="cpu")}
    params = {DEV: {n: p.detach().clone().requires_grad_(True)
                    for n, p in models[DEV].named_parameters()}}
    params["cpu"] = {n: p.detach().cpu().requires_grad_(True)
                     for n, p in params[DEV].items()}
    opts = {d: AdamW(lr, weight_decay=0.01, device=d) for d in params}
    states = {d: opts[d].functional_init(params[d]) for d in params}
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for step in range(steps):
        out = {}
        for d in (DEV, "cpu"):
            batch = bert_batch(torch, cfg, [128, 77], 128, 21 + step, d)
            kernels.reset_launch_counts()
            loss = pretraining_loss_with(models[d], params[d], *batch)
            grads = torch.autograd.grad(loss, list(params[d].values()))
            counts = kernels.launch_counts()
            opts[d].functional_update(params[d], dict(zip(params[d], grads)),
                                      states[d])
            out[d] = (loss.item(), grads, counts)
        counts = out[DEV][2]
        for n in FLASH_BIAS:
            if counts[n] != cfg.num_layers:
                fail(f"phase 4d step {step}: {n} launched {counts[n]} "
                     f"times, expected {cfg.num_layers}")
        if counts["flash_fwd"] or counts["flash_bwd"]:
            fail(f"phase 4d step {step}: the unbiased kernels ran {counts}")
        rel = abs(out[DEV][0] - out["cpu"][0]) / abs(out["cpu"][0])
        worst["loss"] = max(worst["loss"], rel)
        if rel > 1e-4:
            fail(f"phase 4d step {step}: loss {out[DEV][0]} vs CPU "
                 f"{out['cpu'][0]} (relative {rel:.3g} > 1e-4)")
        # a gradient whose exact value is zero (the k_proj biases: softmax
        # is shift-invariant) is rounding noise on both sides: its scale
        # is taken as at least 1e-3 of the step's largest gradient
        floor = 1e-3 * max(g.abs().max().item() for g in out["cpu"][1])
        for name, a, c in zip(params[DEV], out[DEV][1], out["cpu"][1]):
            err = (a.cpu() - c).abs().max().item()
            r = err / max(c.abs().max().item(), floor)
            worst["grad"] = max(worst["grad"], r)
            if r > 1e-3:
                fail(f"phase 4d step {step}: gradient {name} differs by "
                     f"{r:.3g} of its magnitude (> 1e-3)")
    limit = 2 * lr * steps + 1e-6
    for name, p in params[DEV].items():
        diff = (p.detach().cpu() - params["cpu"][name].detach()).abs().max()
        worst["param"] = max(worst["param"], diff.item())
        if diff.item() > limit:
            fail(f"phase 4d: parameter {name} differs by {diff.item():.3g} "
                 f"after {steps} steps (> {limit:.3g})")
    return worst


def bert_lengths(batch_size, seq):
    """Phase 6b's padded lengths: uniform in 128..seq from RandomState(0)."""
    return np.random.RandomState(0).randint(128, seq + 1, batch_size)


def bert_train_throughput(torch, cfg, batch_size=16, seq=512, warm=2,
                          steps=5):
    """Phase 6b: the mixed-precision BERT step on a padded batch; returns
    the measured numbers and the launch counts of the measured steps."""
    from paddle_tpu_torch.ops import kernels

    lens = bert_lengths(batch_size, seq)
    step = bert_amp_train_step(torch, cfg, bert_batch(torch, cfg, lens, seq,
                                                      0, DEV))
    losses = [step().item() for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()                          # main path
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    measured = [step() for _ in range(steps)]
    end.record()
    end.synchronize()
    counts = kernels.launch_counts()
    losses += [x.item() for x in measured]
    ms = start.elapsed_time(end) / steps
    return {"losses": losses, "ms_per_step": ms,
            "tokens_per_sec": batch_size * seq / (ms / 1e3),
            "real_tokens": int(lens.sum()),
            "peak": torch.cuda.max_memory_allocated(), "counts": counts}


# ---- phase 4: decoder parity across devices --------------------------------

def decoder_parity(torch, cfg, params_gpu, kv_dtype, atol, rel=False):
    """Packed prefill + 8 steps + multistep(4) on the card and on the CPU
    (teacher-forced with the card's tokens). Returns (the largest logit
    difference, the near-tie count): greedy tokens must be identical
    except where the CPU's top two logits are within 2*atol (a tie the
    summation order may break). The card runs params_gpu in their dtype
    (and its cache in it), the CPU their float32 copy; with `rel` (a
    bf16 card side) atol is relative to the largest magnitude of the
    CPU's logits at each comparison, the largest difference is returned
    in that unit, and the tokens of multistep(4), which returns no
    logits, are not compared."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.sampling import greedy_args

    BS = 16
    rs = np.random.RandomState(3)
    lens = [150, 77, 33]
    prompts = [rs.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    H, Dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    T = sum(-(-n // 8) * 8 for n in lens)
    toks = np.zeros(T, np.int32)
    seg = np.zeros(T, np.int32)
    pos = np.full(T, -1, np.int32)
    sidx = np.zeros(3, np.int32)
    o = 0
    for r, p in enumerate(prompts):
        toks[o:o + p.size] = p
        seg[o:o + p.size] = r
        pos[o:o + p.size] = np.arange(p.size)
        sidx[r] = o + p.size - 1
        o += -(-p.size // 8) * 8
    sides = {}
    card_dtype = params_gpu["ln_f.weight"].dtype
    for dev in (DEV, "cpu"):
        params = (params_gpu if dev == DEV  # W8A16 codes stay int8
                  else {k: (v.float() if v.is_floating_point() else v)
                        .cpu() for k, v in params_gpu.items()})
        cache = PagedKVCache(cfg.num_layers, H, Dh, block_size=BS,
                             num_blocks=40,
                             dtype=card_dtype if dev == DEV
                             else torch.float32,
                             kv_dtype=kv_dtype, device=dev)
        cache.ensure_many([(r, lens[r] + 16) for r in range(3)])
        dec = PagedDecoder.for_config(cfg, BS, return_logits=True,
                                      kv_dtype=kv_dtype)
        sides[dev] = (params, cache, dec, torch.from_numpy(
            cache.table_array([0, 1, 2], 12)).to(dev))

    def tens(a, dev):
        return torch.from_numpy(np.asarray(a)).to(dev)

    ties = 0

    def compare(what, tok_gpu, lg_gpu, lg_cpu):
        nonlocal ties
        unit = lg_cpu.abs().max().item() if rel else 1.0
        tol = atol * unit
        diff = (lg_gpu.cpu().float() - lg_cpu).abs().max().item()
        if diff > tol:
            fail(f"decoder {kv_dtype or 'dense'} {card_dtype} {what}: logits "
                 f"differ by {diff:.3g} > {tol:.3g}")
        top = lg_cpu.argmax(-1)
        for b in range(lg_cpu.shape[0]):
            if int(top[b]) != int(tok_gpu[b]):
                gap = (lg_cpu[b, top[b]] - lg_cpu[b, int(tok_gpu[b])]).item()
                if gap > 2 * tol:
                    fail(f"decoder {kv_dtype or 'dense'} {card_dtype} "
                         f"{what}: greedy token differs in row {b} (gap "
                         f"{gap:.3g})")
                ties += 1
        return diff / unit

    worst = 0.0
    outs = {}
    for dev, (params, cache, dec, tab) in sides.items():
        outs[dev] = dec.packed_prefill(
            params, tens(toks, dev), tens(seg, dev), tens(pos, dev), tab,
            tens(sidx, dev), cache.k_blocks, cache.v_blocks,
            greedy_args(3, dev))
    tok = outs[DEV][0].cpu()
    worst = max(worst, compare("prefill", tok, outs[DEV][5],
                               outs["cpu"][5]))
    p = np.asarray(lens, np.int32)
    act = np.ones(3, bool)
    for step in range(8):
        for dev, (params, cache, dec, tab) in sides.items():
            outs[dev] = dec.step(params, tok.to(dev), tens(p, dev),
                                 tens(act, dev), tab, cache.k_blocks,
                                 cache.v_blocks, greedy_args(3, dev))
        worst = max(worst, compare(f"step {step}", outs[DEV][0].cpu(),
                                   outs[DEV][5], outs["cpu"][5]))
        tok = outs[DEV][0].cpu()
        p = p + 1
    if rel:
        return worst, ties
    multi = {}
    for dev, (params, cache, dec, tab) in sides.items():
        multi[dev] = dec.multistep(4)(
            params, tok.to(dev), tens(p, dev), tens(act, dev), tab,
            cache.k_blocks, cache.v_blocks, greedy_args(3, dev))[0].cpu()
    if not torch.equal(multi[DEV], multi["cpu"]):
        fail(f"decoder {kv_dtype or 'dense'} multistep(4): tokens differ "
             f"{multi[DEV].tolist()} vs {multi['cpu'].tolist()}")
    return worst, ties


# ---- phase 4s: the sampler on the card --------------------------------------

def prng_parity(torch):
    """(a): random bits, uniforms and Gumbel noise of SAMPLE_SEEDS x
    SAMPLE_STEPS at V 50257, card vs CPU. Returns (the Gumbel noise's
    largest error in ulp, the count of entries that differ)."""
    from paddle_tpu_torch.sampling import prng

    V = 50257
    out = {}
    for dev in (DEV, "cpu"):
        keys = prng.fold_in_keys(
            torch.tensor(SAMPLE_SEEDS, dtype=torch.int64, device=dev),
            torch.tensor(SAMPLE_STEPS, dtype=torch.int64, device=dev))
        out[dev] = [x.cpu() for x in (keys, prng.random_bits(keys, V),
                                      prng.uniform(keys, V),
                                      prng.gumbel(keys, V))]
    (kc, bc, uc, gc), (kh, bh, uh, gh) = out[DEV], out["cpu"]
    for name, a, b in (("keys", kc, kh), ("random bits", bc, bh),
                       ("uniforms", uc.view(torch.int32),
                        uh.view(torch.int32))):
        if not torch.equal(a, b):
            fail(f"phase 4s (a): {name} on the card differ from the CPU's "
                 f"in {int((a != b).sum())} entries")
    ulp = np.spacing(np.maximum(gh.abs().numpy(), 1.0).astype(np.float32))
    err = np.abs(gc.double().numpy() - gh.double().numpy()) / ulp
    if err.max() > GUMBEL_ULPS:
        fail(f"phase 4s (a): Gumbel noise differs by {err.max():.3g} ulp "
             f"> {GUMBEL_ULPS}")
    return float(err.max()), int((gc != gh).sum())


def draw_margins(torch, logits, sp, mode):
    """Each row's top-two margin of filt + gumbel (the sampled draw),
    inf for rows that do not sample."""
    from paddle_tpu_torch.sampling import prng
    from paddle_tpu_torch.sampling import processors as proc

    if not mode[0]:
        return np.full(logits.shape[0], np.inf)
    lg = logits
    if mode[1]:
        counts = sp["counts"]
        if "crows" in sp:
            counts = counts[sp["crows"].long()]
        lg = proc.apply_penalties(lg, counts, sp["rep"], sp["pres"],
                                  sp["freq"])
    scaled = lg / torch.clamp_min(sp["temperature"], 1e-6)[:, None]
    z = proc.filter_logits(scaled, sp["top_k"], sp["top_p"], sp["min_p"]) \
        + prng.gumbel(prng.fold_in_keys(sp["seeds"], sp["steps"]),
                      lg.shape[-1])
    top2 = torch.topk(z, 2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy().astype(np.float64)
    return np.where(sp["sample"].cpu().numpy(), gap, np.inf)


# one dispatch's rows in each mode of phase 4s (b)
SAMPLER_ROWS = {
    "greedy": [{}] * 8,
    "sampled": [{}, dict(temperature=1.0), dict(temperature=0.7, top_k=40),
                dict(temperature=1.0, top_p=0.9),
                dict(temperature=1.0, min_p=0.05),
                dict(temperature=1.3, top_k=200, top_p=0.95, min_p=0.01),
                dict(temperature=0.5), dict(temperature=2.0, top_p=0.5)],
    "penalties": [{}, dict(repetition_penalty=1.3),
                  dict(presence_penalty=0.5), dict(frequency_penalty=0.3),
                  dict(repetition_penalty=0.8, presence_penalty=-0.2),
                  {}, dict(frequency_penalty=1.0), dict(presence_penalty=2.0)],
    "both": [{}, dict(temperature=1.0, repetition_penalty=1.2),
             dict(temperature=0.8, top_k=50, presence_penalty=0.4),
             dict(temperature=1.1, top_p=0.9, frequency_penalty=0.2),
             dict(temperature=1.0, min_p=0.05, repetition_penalty=1.5,
                  presence_penalty=0.3, frequency_penalty=0.1),
             dict(presence_penalty=0.6), dict(temperature=0.9),
             dict(temperature=1.4, top_k=100, top_p=0.8)]}


def sampler_parity(torch):
    """(b): one [8, 50257] float32 logits array through sample_tokens on
    the card and on the CPU in every mode. Returns {mode name: each row's
    margin} for the modes that sample."""
    from paddle_tpu_torch.sampling import SamplingParams, SlotParamStore
    from paddle_tpu_torch.sampling import processors as proc

    V = 50257
    rs = np.random.RandomState(5)
    logits = (rs.randn(8, V) * 2.0).astype(np.float32)
    prompts = [rs.randint(0, V, (int(rs.randint(16, 300)),))
               for _ in range(8)]
    steps = rs.randint(0, 64, 8).astype(np.int32)
    margins = {}
    for name, rows in SAMPLER_ROWS.items():
        toks = {}
        for dev in (DEV, "cpu"):
            store = SlotParamStore(8, V, dev)
            for i, kw in enumerate(rows):
                store.set_slot(i, SamplingParams(**kw), 7000 + 13 * i,
                               prompt_ids=prompts[i])
            sp, mode = store.step_args(steps)
            lg = torch.from_numpy(logits).to(dev)
            toks[dev] = proc.sample_tokens(lg, sp, sampled=mode[0],
                                           penalties=mode[1]).cpu()
            if dev == "cpu" and mode[0]:
                margins[name] = draw_margins(torch, lg, sp, mode)
        if not torch.equal(toks[DEV], toks["cpu"]):
            fail(f"phase 4s (b) {name} {mode}: tokens differ, card "
                 f"{toks[DEV].tolist()} CPU {toks['cpu'].tolist()}")
    return margins


SERVE_ROWS = [{}, dict(temperature=1.0, seed=11),
              dict(temperature=0.8, top_k=40, seed=12),
              dict(temperature=1.0, top_p=0.9, seed=13),
              dict(temperature=1.0, min_p=0.05, seed=14),
              dict(temperature=0.9, repetition_penalty=1.3,
                   presence_penalty=0.5, frequency_penalty=0.3, seed=15),
              dict(presence_penalty=0.8),
              dict(temperature=1.2, top_k=100, top_p=0.95,
                   frequency_penalty=0.2, seed=17)]


class GraphSpy:
    """Stands in for a server decoder's graph cache in phase 4s (c): each
    decode dispatch runs through the real cache (one graph replay), then
    the eager step recomputes the same step on the card for its logits
    (it rewrites the K/V rows the replay wrote with the same bits: phase
    5g holds graph and eager bitwise), and the record takes the graph's
    tokens beside those logits."""

    def __init__(self, dec, record):
        self.dec, self.record = dec, record
        self.real = dec.graphs

    @property
    def captures(self):
        return self.real.captures

    def __call__(self, k, mode, params, tok, pos, active, tables, kc, vc,
                 sp):
        out = self.real(k, mode, params, tok, pos, active, tables, kc, vc,
                        sp)
        logits = self.dec._step(params, tok, pos, active, tables, kc, vc,
                                sp, mode)[5]
        self.record.append((logits.cpu(), {
            key: v.to("cpu", copy=True) for key, v in sp.items()}, mode,
            out[0][0].cpu(), active.cpu()))
        return out


def sampled_serving(torch, model):
    """(c): 8 requests of SERVE_ROWS served on the card at k = 1, k = 4
    and k = 1 in reverse order; every draw of the first run replayed on
    the CPU from the card's logits. Returns (the runs' tokens, draws
    replayed, draws below MARGIN, greedy rows replayed)."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.sampling import SamplingParams
    from paddle_tpu_torch.sampling import processors as proc

    V = model.cfg.vocab_size
    rs = np.random.RandomState(9)
    # 16-60 tokens: the burst is one packed prefill in every run
    prompts = [rs.randint(1, V, (int(rs.randint(16, 61)),))
               .astype(np.int32) for _ in range(8)]
    params = [SamplingParams(**kw) for kw in SERVE_ROWS]
    runs = {}
    record = []
    for tag, k, order in (("k1", 1, range(8)), ("k4", 4, range(8)),
                          ("k1 reversed", 1, range(7, -1, -1))):
        srv = PagedGenerationServer(model, max_slots=8, block_size=16,
                                    max_prompt_len=128, max_new_tokens=16,
                                    steps_per_dispatch=k, device=DEV)
        if tag == "k1":
            dec = srv._decoder
            dec.return_logits = True
            real = dec.packed_prefill

            def spy(*a):
                out = real(*a)
                sp = {key: v.to("cpu", copy=True)
                      for key, v in a[8].items()}
                record.append((out[5].cpu(), sp, a[9], out[0].cpu(), None))
                return out[:5]
            dec.packed_prefill = spy
            dec._graphs = GraphSpy(dec, record)
        futs = {i: srv.submit(prompts[i], sampling=params[i]) for i in order}
        srv.start()               # a burst: every request in the first round
        try:
            runs[tag] = [futs[i].result(timeout=600) for i in range(8)]
        finally:
            srv.stop()
    for tag in ("k4", "k1 reversed"):
        for i in range(8):
            if not np.array_equal(runs[tag][i], runs["k1"][i]):
                fail(f"phase 4s (c): request {i} differs between k1 and "
                     f"{tag}: {runs['k1'][i][prompts[i].size:].tolist()} vs "
                     f"{runs[tag][i][prompts[i].size:].tolist()}")
    draws = near = greedy = 0
    for logits, sp, mode, tok, active in record:
        rep = proc.sample_tokens(logits, sp, sampled=mode[0],
                                 penalties=mode[1])
        margin = draw_margins(torch, logits, sp, mode)
        sample = sp["sample"].numpy() if mode[0] else np.zeros(
            len(tok), bool)
        for r in range(len(tok)):
            if active is not None and not bool(active[r]):
                continue
            if sample[r]:
                draws += 1
                if margin[r] < MARGIN:
                    near += 1
                    continue
            else:
                greedy += 1
            if int(rep[r]) != int(tok[r]):
                fail(f"phase 4s (c): the CPU's replay gives token "
                     f"{int(rep[r])} where the card drew {int(tok[r])} "
                     f"(mode {mode}, row {r}, margin {margin[r]:.3g})")
    if draws == 0:
        fail("phase 4s (c): no sampled draw was replayed")
    return runs, draws, near, greedy


def sampler_cost(torch, reps=50):
    """Phase 5s: the sampler at 8 x 50257 with phase 5s's slot params,
    and the greedy argmax: {mode name: (device ms per call, kernel
    launches per call, host us per call, store host us per step_args)}."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.sampling import SamplingParams, SlotParamStore
    from paddle_tpu_torch.sampling import processors as proc

    V = 50257
    logits = torch.from_numpy(
        (np.random.RandomState(6).randn(8, V) * 2.0).astype(np.float32)) \
        .to(DEV)
    steps = np.arange(8, dtype=np.int32)
    out = {}
    for name, temp in (("sampled", 0.8), ("greedy", 0.0)):
        store = SlotParamStore(8, V, DEV)
        for i in range(8):
            store.set_slot(i, SamplingParams(temperature=temp, top_p=0.95),
                           1000 + i)
        t0 = time.perf_counter()
        for _ in range(reps):
            sp, mode = store.step_args(steps)
        store_us = (time.perf_counter() - t0) / reps * 1e6

        def fn(sp=sp, mode=mode):
            return proc.sample_tokens(logits, sp, sampled=mode[0],
                                      penalties=mode[1])
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = launches = 0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                us += getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0))
                launches += ev.count
        if us <= 0:
            fail(f"phase 5s: the profiler recorded no device time for the "
                 f"{name} sampler")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        out[name] = (us / 1e3 / reps, launches / reps, host_us, store_us)
    return out


# ---- phase 5: serving -------------------------------------------------------

def serve(torch, model, prompts, k, sampling=None, profile=False, **kw):
    """A warm and a measured pass of `prompts` (each with its
    `sampling` entry, default greedy) through a server at k tokens a
    dispatch (`kw`: more server options); the launch counts are zeroed
    just before the measured pass and read just after. Every decode
    dispatch must be one graph replay. With `profile`, a third pass runs
    under torch.profiler, as scripts/torch_serve_profile.py reads it: the
    device's busy time over its kernels, and the idle share 1 - busy / the
    measured pass's wall time. Returns (stats, launch counts, peak
    memory, outputs, {"wall", "busy", "idle", "k2_traced",
    "param_bytes"})."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.ops import kernels

    sampling = sampling or [None] * len(prompts)
    srv = PagedGenerationServer(model, max_slots=8, block_size=16,
                                max_prompt_len=768, max_new_tokens=32,
                                prefill_chunk_tokens=512,
                                steps_per_dispatch=k, device=DEV,
                                **kw).start()
    extra = {"busy": None, "idle": None, "k2_traced": None}

    def one_pass():
        return [f.result(timeout=600) for f in
                [srv.submit(p, sampling=sp)
                 for p, sp in zip(prompts, sampling)]]

    try:
        one_pass()                                         # warm pass
        srv.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()                      # main path
        t0 = time.perf_counter()
        outs = one_pass()
        torch.cuda.synchronize()
        extra["wall"] = time.perf_counter() - t0
        counts = kernels.launch_counts()
        st = srv.stats()
        extra["param_bytes"] = sum(t.numel() * t.element_size()
                                   for t in srv._params.values())
        if profile:
            busy, k2 = traced_busy(torch, one_pass)
            if busy <= 0:
                fail(f"serving k={k}: the profiler recorded no device time")
            extra.update(busy=busy, idle=1 - busy / extra["wall"],
                         k2_traced=k2)
    finally:
        srv.stop()
    V = model.cfg.vocab_size
    for p, o in zip(prompts, outs):
        if o.shape != (p.size + 32,) or not (o[:p.size] == p).all() \
                or o[p.size:].min() < 0 or o[p.size:].max() >= V:
            fail(f"serving k={k}: bad output for a {p.size}-token prompt")
    L = model.cfg.num_layers
    need_k1 = L * st["prefill_dispatches"]
    need_k2 = L * st["decode_steps"] * k
    if counts["ragged_stream_dense"] < need_k1 or need_k1 == 0:
        fail(f"serving k={k}: K1 ran {counts['ragged_stream_dense']} times,"
             f" expected >= {need_k1}")
    if counts["paged_decode_dense"] < need_k2 or need_k2 == 0:
        fail(f"serving k={k}: K2 ran {counts['paged_decode_dense']} times,"
             f" expected >= {need_k2}")
    if st["decode_graph_replays"] != st["decode_steps"]:
        fail(f"serving k={k}: {st['decode_graph_replays']} graph replays "
             f"for {st['decode_steps']} decode dispatches")
    return st, counts, torch.cuda.max_memory_allocated(), outs, extra


def traced_busy(torch, one_pass):
    """Run `one_pass()` under torch.profiler (as
    scripts/torch_serve_profile.py reads it): (the device's busy seconds
    over its kernels, the K2 kernels traced)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    with profiler(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        one_pass()
        torch.cuda.synchronize()
    busy = k2 = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy += getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0))
        if K2_NAME.search(ev.key):
            k2 += ev.count
    return busy / 1e6, k2


def idle_text(extra, st, k, L):
    """The profiled pass's device busy time and idle share, or why the
    idle share is not measured (the trace holds fewer K2 kernels than the
    pass launched: graph kernels untraced)."""
    if extra["idle"] is None:
        return "idle share not measured"
    want = L * st["decode_steps"] * k
    if extra["k2_traced"] < want:
        return (f"device busy {extra['busy'] * 1e3:.1f} ms; idle share not "
                f"measured: the trace holds {extra['k2_traced']} K2 kernels "
                f"of >= {want}")
    return (f"device busy {extra['busy'] * 1e3:.1f} ms of "
            f"{extra['wall'] * 1e3:.1f} ms wall, idle share "
            f"{extra['idle']:.3f} (K2 kernels traced {extra['k2_traced']})")


# ---- phase 5g: one decode graph against the eager loop ----------------------

G_SLOTS = 8
G_MODES = (("greedy", (False, False)), ("sampled", (True, False)),
           ("penalties", (False, True)))


def graph_store(torch, cfg, mode, lens, rs):
    """Phase 5g's slot store in `mode`: sampled rows alternate with greedy
    ones (temperature 0.8, top-p 0.95), penalised rows carry every
    penalty with counts from a random prompt of their length; slot 1 has
    three stop ids (a stop matrix 4 wide)."""
    from paddle_tpu_torch.sampling import SamplingParams, SlotParamStore

    store = SlotParamStore(G_SLOTS, cfg.vocab_size, DEV)
    for b in range(G_SLOTS):
        kw = {}
        if mode[0] and b % 2:
            kw.update(temperature=0.8, top_p=0.95)
        if mode[1] and b % 3 != 2:
            kw.update(repetition_penalty=1.2, presence_penalty=0.3,
                      frequency_penalty=0.1)
        if b == 1:
            kw.update(stop_token_ids=(11, 220, 13))
        store.set_slot(b, SamplingParams(**kw), 500 + b,
                       prompt_ids=rs.randint(0, cfg.vocab_size, lens[b]))
    return store


def graph_parity(torch, model, card):
    """5g: GPT-2 small's decoder on the card, outside the server: two
    dispatches of multistep(k) through one captured graph and through the
    eager loop, from one state (two pools with the same random contents,
    two stores with the same parameters), for weights bf16 / W8A16 x pools
    dense / int8 x modes greedy / sampled / penalties x k 1 / 4 / 8; 8
    slots of lengths RandomState(5).randint(64, 769), slot 5 idle. Tokens,
    stops, counts, the stores' counts and every pool element must be equal
    bit for bit after each case; the launches of the second dispatch (a
    pure replay, under set_sync_debug_mode("error")) must equal the eager
    loop's. Returns {(weights, pool, mode, k): (eager host us, graph host
    us, eager ms, graph ms)} of the second dispatch."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache, blocks_for
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.ops import kernels

    cfg = model.cfg
    L, H = cfg.num_layers, cfg.num_heads
    Dh = cfg.hidden_size // H
    rs = np.random.RandomState(5)
    lens = rs.randint(64, 769, G_SLOTS)
    act = torch.ones(G_SLOTS, dtype=torch.bool, device=DEV)
    act[5] = False
    nb = sum(blocks_for(int(n) + 16, 16) for n in lens) + 1
    width = blocks_for(int(lens.max()) + 16, 16)
    g = torch.Generator(device=DEV).manual_seed(5)
    res = {}
    for wname in ("bf16", "w8a16"):
        params = (model.flat_params() if wname == "bf16"
                  else model.quantize_weights())
        for kv_dtype in (None, "int8"):
            pools = [PagedKVCache(L, H, Dh, block_size=16, num_blocks=nb,
                                  dtype=torch.bfloat16, kv_dtype=kv_dtype,
                                  device=DEV) for _ in range(2)]
            for c in pools:
                c.ensure_many([(b, int(n) + 16) for b, n in enumerate(lens)])
            leaves = [c._pool_leaves() for c in pools]
            for a, b in zip(*leaves):
                if a.dtype == torch.int8:
                    a.copy_(torch.randint(-127, 128, a.shape, generator=g,
                                          device=DEV))
                elif kv_dtype:                     # int8 scales
                    a.copy_(torch.rand(a.shape, generator=g, device=DEV)
                            * 0.02)
                else:
                    a.copy_(torch.randn(a.shape, generator=g, device=DEV))
                b.copy_(a)
            tables = torch.from_numpy(pools[0].table_array(
                range(G_SLOTS), width)).to(DEV)
            dec = PagedDecoder.for_config(cfg, 16, kv_dtype=kv_dtype)
            tag = f"{wname} {kv_dtype or 'dense'}"
            for mname, mode in G_MODES:
                stores = [graph_store(torch, cfg, mode, lens,
                                      np.random.RandomState(6))
                          for _ in range(2)]
                for k in (1, 4, 8):
                    outs, counts, times = [], [], []
                    for side, graph in ((0, False), (1, True)):
                        c, store = pools[side], stores[side]
                        tok = torch.full((G_SLOTS,), 50, dtype=torch.int32,
                                         device=DEV)
                        pos = torch.from_numpy((lens - 1).astype(
                            np.int32)).to(DEV)
                        steps = np.zeros(G_SLOTS, np.int32)
                        got = []
                        for d in range(2):
                            sp, m = store.step_args(steps)
                            if m != mode:
                                fail(f"phase 5g: the store's mode {m}")
                            args = (params, tok, pos, act, tables,
                                    c.k_blocks, c.v_blocks, sp)
                            torch.cuda.synchronize()
                            if d == 1:
                                kernels.reset_launch_counts()
                            if graph and d == 1:
                                torch.cuda.set_sync_debug_mode("error")
                            t0 = time.perf_counter()
                            try:
                                out = (dec.graphs(k, mode, *args) if graph
                                       else dec.multistep(k, mode)(*args))
                                t_host = time.perf_counter() - t0
                            finally:
                                torch.cuda.set_sync_debug_mode("default")
                            torch.cuda.synchronize()
                            t_wall = time.perf_counter() - t0
                            toks, stops, _kc, _vc, cnt = out
                            got.append((toks.clone(), stops.clone(),
                                        None if cnt is None else cnt.clone()))
                            store.swap_counts(cnt)
                            tok, pos = toks[-1].clone(), pos + k
                            steps = steps + k
                        counts.append(kernels.launch_counts())
                        times.append((t_host * 1e6, t_wall * 1e3))
                        outs.append(got)
                    what = f"phase 5g {tag} {mname} k={k}"
                    for (te, se, ce), (tg, sg, cg) in zip(*outs):
                        if not (torch.equal(te, tg) and torch.equal(se, sg)
                                and (ce is None) == (cg is None)
                                and (ce is None or torch.equal(ce, cg))):
                            fail(f"{what}: graph and eager outputs differ")
                        if te[:, 5].any():
                            fail(f"{what}: the idle slot emitted a token")
                    if mode[1] and not torch.equal(stores[0].counts,
                                                   stores[1].counts):
                        fail(f"{what}: the stores' counts differ")
                    for a, b in zip(*[c._pool_leaves() for c in pools]):
                        if not torch.equal(a, b):
                            fail(f"{what}: the pools differ")
                    k2 = counts[1]["paged_decode_" + (kv_dtype or "dense")]
                    if counts[0] != counts[1] or k2 != L * k:
                        fail(f"{what}: launches of a replay "
                             f"{ {n: v for n, v in counts[1].items() if v} } "
                             f"vs eager "
                             f"{ {n: v for n, v in counts[0].items() if v} }")
                    res[(wname, kv_dtype or "dense", mname, k)] = (
                        times[0][0], times[1][0], times[0][1], times[1][1])
            if dec.graphs.captures != len(G_MODES) * 3:
                fail(f"phase 5g {tag}: {dec.graphs.captures} captures for "
                     f"{len(G_MODES) * 3} keys")
            del pools, dec, leaves
            torch.cuda.empty_cache()
    return res


# ---- phase 5w: W8A16 weights ------------------------------------------------

def w8_prefix_logits(torch, cfg, params_cpu, seq, kv_dtype):
    """float32 CPU logits of the last position of `seq` under W8A16
    params: one packed prefill of the whole sequence."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache, blocks_for
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.sampling import greedy_args

    n = int(seq.size)
    H = cfg.num_heads
    cache = PagedKVCache(cfg.num_layers, H, cfg.hidden_size // H,
                         block_size=16, num_blocks=blocks_for(n, 16) + 1,
                         kv_dtype=kv_dtype, device="cpu")
    cache.allocate(0, n)
    dec = PagedDecoder.for_config(cfg, 16, return_logits=True,
                                  kv_dtype=kv_dtype)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32))

    out = dec.packed_prefill(
        params_cpu, t(seq), t(np.zeros(n)), t(np.arange(n)),
        t(cache.table_array([0], blocks_for(n, 16))), t([n - 1]),
        cache.k_blocks, cache.v_blocks, greedy_args(1, "cpu"))
    return out[5][0]


def w8_serving_parity(torch, model32, card):
    """5w (a): float32 GPT-2 small (phase 4's weights) served with
    quantization="w8a16", alone and with kv_dtype="int8", on the card and
    on the CPU: 8 prompts of 16-60 tokens from RandomState(9) as one
    burst, 16 new tokens, greedy. Tokens must be identical; where they
    are not, both tokens' CPU logits at the first difference must lie
    within 2 x phase 4's limit (a tie the summation order may break),
    counted. Before it, the decoder itself (phase 4's program) on W8A16
    params, card vs CPU, within phase 4's limits. Returns {kv: (largest
    logit difference, decoder near-ties, served near-ties, tokens)}."""
    from paddle_tpu_torch.inference import PagedGenerationServer

    cfg = model32.cfg
    V = cfg.vocab_size
    rs = np.random.RandomState(9)
    prompts = [rs.randint(1, V, (int(rs.randint(16, 61)),)).astype(np.int32)
               for _ in range(8)]
    wq = model32.quantize_weights()
    params_cpu = {k: v.cpu() for k, v in wq.items()}
    res = {}
    for kv_dtype, atol in ((None, 2e-3), ("int8", 2e-2)):
        worst, dec_ties = decoder_parity(torch, cfg, wq, kv_dtype, atol)
        outs = {}
        for dev in (DEV, "cpu"):
            srv = PagedGenerationServer(model32, max_slots=8, block_size=16,
                                        max_prompt_len=128,
                                        max_new_tokens=16,
                                        quantization="w8a16",
                                        kv_dtype=kv_dtype, device=dev)
            futs = [srv.submit(p) for p in prompts]
            srv.start()
            try:
                outs[dev] = [f.result(timeout=600) for f in futs]
                st = srv.stats()
            finally:
                srv.stop()
            q = st["quantization"]
            if q["mode"] != "w8a16" or q["kv_dtype"] != (kv_dtype or
                                                          "float32"):
                fail(f"phase 5w (a): stats quantization {q}")
            if dev == DEV and st["decode_graph_replays"] != \
                    st["decode_steps"]:
                fail("phase 5w (a): a decode dispatch was not a replay")
        ties = 0
        for p, a, b in zip(prompts, outs[DEV], outs["cpu"]):
            if np.array_equal(a, b):
                continue
            i = int(np.nonzero(a != b)[0][0])
            lg = w8_prefix_logits(torch, cfg, params_cpu, a[:i], kv_dtype)
            gap = abs(lg[int(a[i])].item() - lg[int(b[i])].item())
            if i < p.size or gap > 2 * atol:
                fail(f"phase 5w (a) {kv_dtype or 'dense'}: card and CPU "
                     f"tokens differ at {i} (logit gap {gap:.3g})")
            ties += 1
        res[kv_dtype or "dense"] = (worst, dec_ties, ties,
                                    sum(o.size - p.size for p, o in
                                        zip(prompts, outs[DEV])))
    return res


# ---- phase 5p: the prefix cache on the serving path -------------------------

P_TAILS = (1, 7, 16, 33, 96)
P_NEW = 8
SP_LEN, SP_TAILS, SP_NEW, SP_REQS = 512, (32, 96), 4, 16


def prefix_prompts(vocab):
    """5p(a)'s traffic: a 512-token system prompt from RandomState(7) with
    tails of 1, 7, 16, 33 and 96 tokens, then the 16-token one again (its
    resubmission attaches at len - 1, mid-block: a copy-on-write)."""
    rs = np.random.RandomState(7)
    sys_p = rs.randint(1, vocab, (512,)).astype(np.int32)
    prompts = [np.concatenate([sys_p, rs.randint(1, vocab, (n,))
                               .astype(np.int32)]) for n in P_TAILS]
    return prompts + [prompts[2].copy()]


def prefix_serve(torch, model, prompts, sampling=None, spy=None, **kw):
    """5p(a)'s traffic on phase 5's server (P_NEW new tokens): the first
    prompt alone (it publishes the system prompt), the next four as one
    burst (sharing its blocks live), the resubmission alone. Launch
    counts zeroed just before, read just after. Returns (outputs, stats,
    counts)."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.ops import kernels

    sampling = sampling or [None] * len(prompts)
    srv = PagedGenerationServer(model, max_slots=8, block_size=16,
                                max_prompt_len=768, max_new_tokens=P_NEW,
                                prefill_chunk_tokens=512, device=DEV, **kw)
    if spy is not None:
        spy(srv.cache)
    kernels.reset_launch_counts()
    srv.start()
    try:
        outs = [srv.submit(prompts[0], sampling=sampling[0])
                .result(timeout=600)]
        outs += [f.result(timeout=600) for f in
                 [srv.submit(p, sampling=s)
                  for p, s in zip(prompts[1:-1], sampling[1:-1])]]
        outs.append(srv.submit(prompts[-1], sampling=sampling[-1])
                    .result(timeout=600))
        counts = kernels.launch_counts()
        st = srv.stats()
    finally:
        srv.stop()
    V = model.cfg.vocab_size
    for p, o in zip(prompts, outs):
        if o.shape != (p.size + P_NEW,) or not (o[:p.size] == p).all() \
                or o[p.size:].min() < 0 or o[p.size:].max() >= V:
            fail(f"phase 5p: bad output for a {p.size}-token prompt")
    return outs, st, counts


class TierSpy:
    """Holds every promoted row of a pool to the row that was demoted:
    the pool's `_tier_grab` and `_tier_install` wrapped to keep the
    device rows a demotion read and compare them after the promotion's
    write. An int8 pool must return bit for bit; a dense pool within
    absmax/254 of each vector (its int8 codec's bound) plus 4 float32
    ulp of the element. Instrumentation only: it reads the card."""

    def __init__(self, torch, cache):
        self.torch, self.cache = torch, cache
        self.snaps, self.rows, self.worst = {}, 0, 0.0
        self._grab, self._install = cache._tier_grab, cache._tier_install
        cache._tier_grab, cache._tier_install = self.grab, self.install

    def _rows(self, b, fill):
        c = self.cache
        out = []
        for kv in (c.k_blocks, c.v_blocks):
            leaves = (kv.codes, kv.scales) if c.kv_dtype else (kv,)
            out += [a[:, b, :fill].clone() for a in leaves]
        return out

    def grab(self, b, fill):
        kp, vp = self._grab(b, fill)
        self.snaps[id(kp)] = self._rows(b, fill)
        return kp, vp

    def install(self, b, fill, kp, vp):
        self._install(b, fill, kp, vp)
        old = self.snaps.pop(id(kp))
        for o, n in zip(old, self._rows(b, fill)):
            if self.cache.kv_dtype == "int8":
                if not self.torch.equal(o, n):
                    fail("phase 5p (a): an int8 block promoted from the "
                         "tier differs from the block demoted")
                continue
            o, n = o.float(), n.float()
            bound = o.abs().amax(-1, keepdim=True) / 254
            err = (n - o).abs()
            if (err > bound + o.abs() * 2 ** -21).any():
                fail(f"phase 5p (a): a promoted dense row is "
                     f"{float((err / bound.clamp_min(1e-30)).max()):.4g} "
                     f"x absmax/254 from the demoted row")
            self.worst = max(self.worst, float(
                (err / bound.clamp_min(1e-30)).max()))
        self.rows += fill


def prefix_parity(torch, model, card):
    """5p (a): float32, TF32 off, GPT-2 small with phase 4's weights.
    Caching on against off (dense and int8 pools, greedy and at fixed
    seeds) token for token; then a pool barely above one request's worst
    case plus its spare (evictions); then a HostKVTier at watermark 0.5
    on that pool (demotion mid-run). Returns K1/K2 launches by name."""
    from paddle_tpu_torch.inference import blocks_for
    from paddle_tpu_torch.inference.kv_tier import HostKVTier
    from paddle_tpu_torch.sampling import SamplingParams

    prompts = prefix_prompts(model.cfg.vocab_size)
    seeded = [SamplingParams(temperature=0.8, top_p=0.95, seed=2000 + i)
              for i in range(len(prompts))]
    worst = blocks_for(max(p.size for p in prompts) + P_NEW, 16) + 1
    small = worst + 2   # trash block + one block above the worst case
    launches = {}
    plain = {}
    for kv_dtype in (None, "int8"):
        tag = kv_dtype or "dense"
        for mode, sampling in (("greedy", None), ("seeded", seeded)):
            off, _st, c_off = prefix_serve(torch, model, prompts, sampling,
                                           kv_dtype=kv_dtype)
            on, st, c_on = prefix_serve(torch, model, prompts, sampling,
                                        kv_dtype=kv_dtype,
                                        enable_prefix_cache=True)
            for c in (c_off, c_on):
                for n in (f"ragged_stream_{tag}", f"paged_decode_{tag}"):
                    launches[n] = launches.get(n, 0) + c[n]
            bad = [i for i, (a, b) in enumerate(zip(off, on))
                   if not np.array_equal(a, b)]
            if bad:
                fail(f"phase 5p (a) {tag} {mode}: caching on and off differ "
                     f"in requests {bad}")
            pc = st["kv_cache"]["prefix_cache"]
            k1 = c_on[f"ragged_stream_{tag}"]
            if pc["hit_tokens"] <= 0 or pc["cow_copies"] <= 0 or k1 <= 0:
                fail(f"phase 5p (a) {tag} {mode}: hit_tokens "
                     f"{pc['hit_tokens']}, cow_copies {pc['cow_copies']}, "
                     f"K1 launches {k1} (each must be > 0)")
            say(f"phase 5p (a) f32 {tag} {mode}: {len(prompts)} requests x "
                f"{P_NEW} tokens identical with caching on and off; on: "
                f"hit_tokens {pc['hit_tokens']} of {pc['lookup_tokens']}, "
                f"cow_copies {pc['cow_copies']}, prefill_dispatches "
                f"{st['prefill_dispatches']}, K1 launches {k1} (off "
                f"{c_off[f'ragged_stream_{tag}']}), K2 "
                f"{c_on[f'paged_decode_{tag}']} [{card}]")
            if mode == "greedy":
                plain[kv_dtype] = off
        # a pool barely above one request's worst case plus its spare
        ev, st, c = prefix_serve(torch, model, prompts, kv_dtype=kv_dtype,
                                 enable_prefix_cache=True, num_blocks=small)
        pc = st["kv_cache"]["prefix_cache"]
        bad = [i for i, (a, b) in enumerate(zip(plain[kv_dtype], ev))
               if not np.array_equal(a, b)]
        if bad or pc["evictions"] <= 0:
            fail(f"phase 5p (a) {tag} pool of {small - 1} blocks: evictions "
                 f"{pc['evictions']} (must be > 0), requests differing from "
                 f"caching off {bad}")
        # the host tier, demoting mid-run under its watermark
        spies = []
        tiered, st, c = prefix_serve(
            torch, model, prompts, kv_dtype=kv_dtype, enable_prefix_cache=True,
            num_blocks=small, kv_tier=HostKVTier(watermark=0.5),
            spy=lambda cache: spies.append(TierSpy(torch, cache)))
        t = st["kv_cache"]["tier"]
        if t["demotions"] <= 0 or t["promotions"] <= 0 \
                or t["hit_tokens"] <= 0:
            fail(f"phase 5p (a) {tag} tier: demotions {t['demotions']}, "
                 f"promotions {t['promotions']}, hit_tokens "
                 f"{t['hit_tokens']} (each must be > 0)")
        differ = [i for i, (a, b) in enumerate(zip(plain[kv_dtype], tiered))
                  if not np.array_equal(a, b)]
        if kv_dtype == "int8" and differ:
            fail(f"phase 5p (a) int8 tier: requests {differ} differ from "
                 f"the tier-off run")
        spy = spies[0]
        rows = ("bit for bit" if kv_dtype else
                f"within {spy.worst:.6g} x absmax/254 (limit 1)")
        say(f"phase 5p (a) f32 {tag} pool of {small - 1} blocks (worst case "
            f"{worst - 1} + 1 spare): evictions {pc['evictions']}, tokens "
            f"identical to caching off; with HostKVTier(watermark=0.5): "
            f"demotions {t['demotions']}, promotions {t['promotions']}, "
            f"tier hit_tokens {t['hit_tokens']}, bytes out/in "
            f"{t['bytes_out']}/{t['bytes_in']}, {spy.rows} promoted rows "
            f"{rows}, requests whose tokens differ from the tier-off run "
            f"{len(differ)} of {len(prompts)} [{card}]")
    return launches


def copy_checks(torch, card):
    """5p (b): prepare_write's copy-on-write at GPT-2 small's pool shape
    (12 layers, 12 heads, Dh 64, BS 16) equals its source block bit for
    bit in every layer — float32, bf16, and int8 codes with scales — and
    runs under torch.cuda.set_sync_debug_mode("error"); an int8 block
    demoted to the host tier and promoted back returns bit for bit."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache
    from paddle_tpu_torch.inference.kv_tier import HostKVTier

    toks = np.arange(1, 41, dtype=np.int32)    # 2 full blocks + fill 8
    g = torch.Generator(device=DEV).manual_seed(5)
    for kind in ("f32", "bf16", "int8"):
        quant = kind == "int8"
        c = PagedKVCache(12, 12, 64, block_size=16, num_blocks=8,
                         dtype=torch.bfloat16 if kind == "bf16"
                         else torch.float32,
                         kv_dtype="int8" if quant else None, device=DEV,
                         tier=HostKVTier(watermark=0.0) if quant else None)
        leaves = [a for kv in (c.k_blocks, c.v_blocks)
                  for a in ((kv.codes, kv.scales) if quant else (kv,))]
        for a in leaves:
            if a.dtype == torch.int8:
                a.copy_(torch.randint(-127, 128, a.shape, generator=g,
                                      device=DEV))
            else:
                a.copy_(torch.randn(a.shape, generator=g, device=DEV))
        c.allocate("a", 40)
        c.publish_prefix("a", toks)
        if c.attach_prefix("b", toks) != 39:
            fail(f"phase 5p (b) {kind}: attach did not reach len - 1")
        src = c.block_table("b")[2]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            copied = c.prepare_write("b", 39)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        new = c.block_table("b")[2]
        if not copied or new == src or not all(
                torch.equal(a[:, new], a[:, src]) for a in leaves):
            fail(f"phase 5p (b) {kind}: the copy-on-write copy differs from "
                 f"its source block")
        if quant:
            c.free("b")
            before = [a[:, c.block_table("a")].clone() for a in leaves]
            c.free("a")
            if c.demote_cold(8) != 3 or c.attach_prefix("c", toks) != 39:
                fail("phase 5p (b): the int8 chain did not demote and "
                     "promote back")
            table = c.block_table("c")
            if not all(torch.equal(a[:, table][:, :2], o[:, :2])
                       and torch.equal(a[:, table[2], :8], o[:, 2, :8])
                       for a, o in zip(leaves, before)):
                fail("phase 5p (b): an int8 block demoted and promoted "
                     "differs from the original")
    say(f"phase 5p (b) prepare_write copies at L12 H12 Dh64 BS16: f32, bf16 "
        f"and int8 (codes and scales) equal their source block bit for bit "
        f"in every layer, with no host sync (set_sync_debug_mode 'error'); "
        f"an int8 chain of 3 blocks demoted to page-locked host memory and "
        f"promoted back is bit for bit the original [{card}]")


def pool_costs(torch, card, reps=50):
    """5p (b): host time of the prefix cache's pool operations at GPT-2
    small's pool shape in bf16 (L12 H12 Dh64 BS16) on a published
    578-token prompt (37 blocks, the last holding 2 tokens) resubmitted:
    microseconds a call of attach_prefix (577 tokens matched, mid-block),
    prepare_write (one copy-on-write: its launches, not their device
    time), free and publish_prefix (re-indexing a chain whose hashes
    exist)."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache

    c = PagedKVCache(12, 12, 64, block_size=16, num_blocks=128,
                     dtype=torch.bfloat16, device=DEV)
    ids = np.random.RandomState(8).randint(1, 50257, 578).astype(np.int32)
    c.allocate("p", 578)
    c.publish_prefix("p", ids)
    us = {"attach_prefix": 0.0, "prepare_write": 0.0, "free": 0.0,
          "publish_prefix": 0.0}
    torch.cuda.synchronize()
    for i in range(reps):
        t0 = time.perf_counter()
        c.attach_prefix(i, ids)
        t1 = time.perf_counter()
        c.prepare_write(i, 577)
        t2 = time.perf_counter()
        c.publish_prefix("p", ids)
        t3 = time.perf_counter()
        c.free(i)
        t4 = time.perf_counter()
        for k, dt in (("attach_prefix", t1 - t0), ("prepare_write", t2 - t1),
                      ("publish_prefix", t3 - t2), ("free", t4 - t3)):
            us[k] += dt * 1e6 / reps
    torch.cuda.synchronize()
    if c.stats()["prefix_cache"]["cow_copies"] != reps:
        fail("phase 5p (b): the timed prepare_write did not copy")
    say("phase 5p (b) pool host time a call at L12 H12 Dh64 BS16 bf16, a "
        "578-token prompt (37 blocks) resubmitted: " + ", ".join(
            f"{k} {v:.1f} us" for k, v in us.items()) + f" [{card}]")
    return us


def poisson_drive(srv, pool, rps, seed=4321, new=SP_NEW):
    """bench.py's measure_poisson_load: the pool's prompts submitted at
    fixed-seed Poisson arrivals (exponential gaps of mean 1/rps), then
    all awaited. Returns (outputs, the server's stats)."""
    gaps = np.random.RandomState(seed).exponential(1.0 / max(rps, 1e-9),
                                                   size=len(pool))
    futs = []
    t0 = time.perf_counter()
    arrival = 0.0
    for p, gap in zip(pool, gaps):
        arrival += gap
        now = time.perf_counter() - t0
        if now < arrival:
            time.sleep(arrival - now)
        futs.append(srv.submit(p, max_new_tokens=new))
    return [f.result(timeout=600) for f in futs], srv.stats()


def near_tie_rule(torch, params_cpu, cfg, out_a, out_b, prompt_len,
                  phase="5p (c)"):
    """Phase 4f's rule for two bf16 generations that differ: at their
    first difference both tokens' float32 CPU logits lie within
    2 * BF16_DECODER_REL of the logits' largest magnitude of the top one.
    Returns True for such a near tie."""
    from paddle_tpu_torch.models.gpt2 import logits

    i = int(np.nonzero(out_a != out_b)[0][0])
    if i < prompt_len:
        fail(f"phase {phase}: an output does not start with its prompt")
    with torch.no_grad():
        lg = logits(params_cpu, cfg, torch.from_numpy(
            out_a[:i].astype(np.int64))[None])[0, -1]
    tol = 2 * BF16_DECODER_REL * lg.abs().max().item()
    top = lg.max().item()
    return all(top - lg[int(o[i])].item() <= tol for o in (out_a, out_b))


def shared_prefix_serving(torch, model, rng, card):
    """5p (c): bench.py's shared-prefix axis (bench.py:675-734) on phase 5's
    server in bf16, cut to 16 requests: a 512-token prefix from phase 5's
    RandomState(7) stream, tails of 32-96 tokens per pool (warm salts 21
    and 23, measured salt 22), 4 new tokens; Poisson arrivals (seed 4321)
    at 0.3 x the uncached closed-loop drain rate of this call; caching off
    then on, on the same server. Returns the measured passes' K1/K2
    launches."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.ops import kernels

    cfg = model.cfg
    V = cfg.vocab_size
    prefix = rng.randint(1, V, (SP_LEN,)).astype(np.int32)

    def sp_pool(salt):
        r2 = np.random.RandomState(salt)
        return [np.concatenate([prefix, r2.randint(1, V, (int(r2.randint(
            SP_TAILS[0], SP_TAILS[1] + 1)),)).astype(np.int32)])
            for _ in range(SP_REQS)]

    warm_pool, warm2_pool, meas_pool = sp_pool(21), sp_pool(23), sp_pool(22)
    srv = PagedGenerationServer(model, max_slots=8, block_size=16,
                                max_prompt_len=768, max_new_tokens=32,
                                prefill_chunk_tokens=512, device=DEV).start()

    def warm(pool):
        for f in [srv.submit(p, max_new_tokens=SP_NEW) for p in pool]:
            f.result(timeout=600)

    res = {}
    launches = {"ragged_stream_dense": 0, "paged_decode_dense": 0}
    try:
        srv.enable_prefix_cache = False
        t0 = time.perf_counter()
        warm(warm_pool)
        rps = 0.3 * SP_REQS / max(time.perf_counter() - t0, 1e-6)
        for on in (False, True):
            srv.enable_prefix_cache = on
            if on:
                warm(warm_pool)          # seeds the index with the prefix
            poisson_drive(srv, warm2_pool, rps)    # unmeasured
            srv.reset_stats()
            pc0 = srv.cache.stats()["prefix_cache"]
            kernels.reset_launch_counts()                 # main path
            outs, st = poisson_drive(srv, meas_pool, rps)
            counts = kernels.launch_counts()
            pc1 = srv.cache.stats()["prefix_cache"]
            res[on] = (outs, st, counts, {
                k: pc1[k] - pc0[k] for k in ("lookups", "hits", "hit_tokens",
                                            "lookup_tokens", "evictions",
                                            "cow_copies")})
    finally:
        srv.stop()
    L = cfg.num_layers
    total = sum(p.size for p in meas_pool)
    for on, (outs, st, counts, d) in res.items():
        k1, k2 = counts["ragged_stream_dense"], counts["paged_decode_dense"]
        if k1 < L * st["prefill_dispatches"] or k2 < L * st["decode_steps"] \
                or k1 == 0 or k2 == 0:
            fail(f"phase 5p (c) caching {'on' if on else 'off'}: K1 ran {k1} "
                 f"times for {st['prefill_dispatches']} prefill dispatches, "
                 f"K2 {k2} for {st['decode_steps']} decode steps (need "
                 f">= {L} each)")
        for n in launches:
            launches[n] += counts[n]
        say(f"phase 5p (c) shared prefix bf16, caching "
            f"{'on ' if on else 'off'}: {SP_REQS} requests at {rps:.3f} "
            f"req/s (Poisson, seed 4321): ttft p50/p99 "
            f"{st['ttft_p50_ms']:.1f}/{st['ttft_p99_ms']:.1f} ms itl p99 "
            f"{st['itl_p99_ms']:.2f} ms tokens_per_sec "
            f"{st['tokens_per_sec']:.1f} prefill_dispatches "
            f"{st['prefill_dispatches']} prompt tokens dispatched "
            f"{total - d['hit_tokens']} of {total} hit_rate "
            f"{d['hit_tokens'] / max(d['lookup_tokens'], 1):.4f} evictions "
            f"{d['evictions']} cow_copies {d['cow_copies']} launches K1 {k1} "
            f"K2 {k2} [{card}]")
    params_cpu = {k: v.float().cpu() for k, v in model.flat_params().items()}
    ties = 0
    for p, a, b in zip(meas_pool, res[False][0], res[True][0]):
        if np.array_equal(a, b):
            continue
        if not near_tie_rule(torch, params_cpu, cfg, a, b, p.size):
            fail("phase 5p (c): greedy tokens differ between caching on and "
                 "off beyond phase 4f's near-tie rule")
        ties += 1
    off, on = res[False][1], res[True][1]
    ratio = on["ttft_p50_ms"] / max(off["ttft_p50_ms"], 1e-9)
    say(f"phase 5p (c) greedy tokens caching on vs off: {SP_REQS - ties} of "
        f"{SP_REQS} requests identical, {ties} differ at a near tie (phase "
        f"4f's rule); TTFT p50 on/off {ratio:.3f} [{card}]")
    return launches


# ---- phase 5v: speculation and the unified round ----------------------------

V_P, V_K = 8, 8          # verify plan rows (8 slots) and draft budget (W 9)
V_NEW = 16               # 5v (a) new tokens
S_NEW, S_REQS, S_MP = 64, 16, 256       # 5v (b) speculation axis
U_NEW, U_REQS, U_MP = 128, 32, 256      # 5v (b) unified axis


def verify_case(torch, timer, quant, dtype, seed, timed):
    """(k): K1 on a verify stream, through `verify_window_attention`: P 8
    windows of W 9 (K 8) at H 12, Dh 64, BS 16; row r's window is its
    last token and k_r drafts ending a context of 64-1024 positions
    (RandomState(seed)), the rest of the window pad (-1), row 7 a padding
    row. Held to `verify_window_attention_plain` on the rows with
    pos >= 0 (2e-2 in bf16, 1e-4 in float32), pad rows zeros, two
    launches bit for bit; timed (bf16): events, profiler device time,
    the wrapper's host time, the plain version, and SDPA over each row's
    pre-gathered keys with the window's mask (gather excluded)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.attention import (verify_window_attention,
                                                verify_window_attention_plain)

    P, W, H, Dh, BS = V_P, V_K + 1, 12, 64, 16
    rs = np.random.RandomState(seed)
    ctx = rs.randint(64, 1025, P)
    ks = rs.randint(0, W, P)
    ctx[P - 1] = 1            # the padding row holds only the trash block
    g = torch.Generator(device=DEV).manual_seed(seed)
    tables, n = _tables(torch, [int(c) for c in ctx], BS, False, seed)
    kb, vb = _pools(torch, n, BS, H, Dh, quant, g)
    if dtype == torch.float32:
        kb, vb = _f32(kb), _f32(vb)
    pos = np.full((P, W), -1, np.int32)
    for r in range(P - 1):
        pos[r, :1 + ks[r]] = np.arange(ctx[r] - 1 - ks[r], ctx[r])
    pos_t = torch.from_numpy(pos).to(DEV)
    q = torch.randn(P, W, H, Dh, generator=g, device=DEV).to(dtype)
    sc = Dh ** -0.5
    out = verify_window_attention(q, kb, vb, tables, pos_t)
    again = verify_window_attention(q, kb, vb, tables, pos_t)
    torch.cuda.synchronize()
    ref = verify_window_attention_plain(q.float(), _f32(kb), _f32(vb),
                                        tables, pos_t)
    live = pos_t >= 0
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    err = (out[live].float() - ref[live]).abs().max().item()
    ok = torch.isfinite(out).all().item() and torch.allclose(
        out[live].float(), ref[live], atol=tol, rtol=tol) \
        and bool((out[~live] == 0).all().item())
    seg = [r for r in range(P) for _ in range(W)]
    res = {"max_abs_err": err, "ok": bool(ok), "tol": tol,
           "bitwise": torch.equal(out, again),
           "passes": stream_passes(seg, list(pos.reshape(-1)), P)}
    if not timed:
        return res

    def call():
        return verify_window_attention(q, kb, vb, tables, pos_t)

    res["ms"] = timer.ms(call)
    res["device_ms"] = timer.device_ms(call, K1_NAME)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    res["host_ms"] = (time.perf_counter() - t0) * 1e3 / 200
    torch.cuda.synchronize()
    res["plain_ms"] = timer.ms(lambda: verify_window_attention_plain(
        q, kb, vb, tables, pos_t), reps=10)
    # library: one SDPA call over [P, H, C] pre-gathered keys, each row's
    # window masked to positions <= its own (pad queries see key 0)
    C = int(ctx.max())
    kd, vd = _dequant(kb, dtype), _dequant(vb, dtype)
    tb = tables.long()
    gk = kd[tb].reshape(P, -1, H, Dh)[:, :C].permute(0, 2, 1, 3).contiguous()
    gv = vd[tb].reshape(P, -1, H, Dh)[:, :C].permute(0, 2, 1, 3).contiguous()
    del kd, vd
    mask = torch.arange(C, device=DEV)[None, None, :] <= pos_t[:, :, None]
    mask[..., 0] |= ~live
    q4 = q.permute(0, 2, 1, 3)
    res["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
        q4, gk, gv, attn_mask=mask[:, None], scale=sc))
    del gk, gv
    e, s = _elem(kb)
    horizon = [int(ctx[r]) for r in range(P - 1)]   # each row's keys
    nbytes = (2 * q.numel() * q.element_size() + P * W * 4 * 2
              + 2 * sum(horizon) * H * (Dh * e + s)
              + sum(-(-c // BS) for c in horizon) * 4)
    flops = 4 * H * Dh * int(sum(p + 1 for p in pos.reshape(-1) if p >= 0))
    res.update(_bound(nbytes, flops))
    return res


class LaunchSpy:
    """Wraps a decoder's verify and window-round graph calls and sums the
    launch counts each call adds (the replay's `kernels.add_launches`):
    K1's launches on verify streams, apart from the prefill's."""

    def __init__(self, graphs):
        from paddle_tpu_torch.ops import kernels

        self.kernels = kernels
        self.counts = {}
        for name in ("verify", "unified"):
            setattr(graphs, name, self._wrap(getattr(graphs, name)))

    def _wrap(self, fn):
        def run(*a, **k):
            before = self.kernels.launch_counts()
            out = fn(*a, **k)
            for n, v in self.kernels.launch_counts().items():
                if v != before[n]:
                    self.counts[n] = self.counts.get(n, 0) + v - before[n]
            return out
        return run


def strict_dispatches(torch, srv):
    """Runs every unified-round dispatch of `srv` under
    torch.cuda.set_sync_debug_mode("error") (a graph capture, which
    synchronises by design, is let through): a host sync raises inside
    the dispatch and fails its requests. Returns a counter dict."""
    graphs = srv._decoder.graphs
    capture, dispatch = graphs._capture, srv._dispatch_round
    seen = {"dispatches": 0}

    def quiet_capture(*a, **k):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return capture(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    def strict(plan):
        seen["dispatches"] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(plan)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    graphs._capture = quiet_capture
    srv._dispatch_round = strict
    return seen


class ReplayDrafter:
    """Proposes the recorded continuation's next tokens (every draft
    accepted where the recording is the server's own output)."""

    def __init__(self, refs):
        self.refs = [np.asarray(r, np.int32) for r in refs]

    def propose(self, ctx, max_tokens):
        ctx = np.asarray(ctx, np.int32)
        for ref in self.refs:
            if ctx.size < ref.size and np.array_equal(ref[:ctx.size], ctx):
                return ref[ctx.size:ctx.size + int(max_tokens)]
        return np.empty((0,), np.int32)


def spec_server(model, dev, kw, new, mp, slots=8, chunk=512):
    from paddle_tpu_torch.inference import PagedGenerationServer

    return PagedGenerationServer(model, max_slots=slots, block_size=16,
                                 max_prompt_len=mp, max_new_tokens=new,
                                 prefill_chunk_tokens=chunk, device=dev,
                                 **kw)


def graph_program_parity(torch, model32):
    """5v (a), outside the server: GPT-2 small float32 on 8 slots
    (contexts RandomState(41) 64-512, slot 5 idle), two dispatches of
    `packed_verify` (a verify plan of K 8 with random drafts) and two
    window rounds (carry chained) through one captured graph each and
    eagerly, from one state: outputs, counts and every pool element bit
    for bit; the second replay's launches equal the eager dispatch's and
    it runs under set_sync_debug_mode("error"). Greedy and sampled +
    penalties, dense and int8 pools. Returns the cases run."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache, blocks_for
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.spec_decode import build_verify_plan

    cfg = model32.cfg
    params = model32.flat_params()
    L, H = cfg.num_layers, cfg.num_heads
    Dh = cfg.hidden_size // H
    S, K = G_SLOTS, V_K
    W = K + 1
    rs = np.random.RandomState(41)
    lens = rs.randint(64, 513, S)
    live = [b for b in range(S) if b != 5]
    nb = sum(blocks_for(int(n) + 4 * W, 16) for n in lens) + 1
    width = blocks_for(int(lens.max()) + 4 * W, 16)
    g = torch.Generator(device=DEV).manual_seed(41)
    cases = 0
    for kv_dtype in (None, "int8"):
        pools = [PagedKVCache(L, H, Dh, block_size=16, num_blocks=nb,
                              dtype=torch.float32, kv_dtype=kv_dtype,
                              device=DEV) for _ in range(2)]
        for c in pools:
            c.ensure_many([(b, int(n) + 4 * W) for b, n in enumerate(lens)])
        for a, b in zip(*[c._pool_leaves() for c in pools]):
            if a.dtype == torch.int8:
                a.copy_(torch.randint(-127, 128, a.shape, generator=g,
                                      device=DEV))
            elif kv_dtype:
                a.copy_(torch.rand(a.shape, generator=g, device=DEV) * 0.02)
            else:
                a.copy_(torch.randn(a.shape, generator=g, device=DEV))
            b.copy_(a)
        tables = torch.from_numpy(pools[0].table_array(range(S), width)) \
            .to(DEV)
        for mname, mode in (("greedy", (False, False)),
                            ("sampled+penalties", (True, True))):
            dec = PagedDecoder.for_config(cfg, 16, kv_dtype=kv_dtype)
            stores = [graph_store(torch, cfg, mode, lens,
                                  np.random.RandomState(6))
                      for _ in range(2)]
            for prog in ("packed_verify", "unified_window"):
                outs, counts = [], []
                for side, graph in ((0, False), (1, True)):
                    c, store = pools[side], stores[side]
                    drs = np.random.RandomState(43)
                    last = np.full(S, 50, np.int32)
                    wpos = (lens - 1).astype(np.int32)
                    carry = None
                    got = []
                    for d in range(2):
                        entries = [(b, int(last[b]), int(wpos[b]), 0,
                                    drs.randint(0, cfg.vocab_size, (int(
                                        drs.randint(0, K + 1)),)).astype(
                                        np.int32)) for b in live]
                        plan = build_verify_plan(entries, K, 1, min_rows=S)
                        rows = plan.slots + [None] * (S - plan.rows)
                        tab = tables[[r if r is not None else 0
                                      for r in rows]].contiguous()
                        dev_t = lambda a: torch.from_numpy(  # noqa: E731
                            np.asarray(a)).to(DEV)
                        if prog == "packed_verify":
                            sp, m = store.verify_args(rows, plan.steps)
                            args = (params, dev_t(plan.toks),
                                    dev_t(plan.seg), dev_t(plan.pos), tab,
                                    dev_t(plan.sample_idx),
                                    dev_t(plan.dlen), c.k_blocks,
                                    c.v_blocks, sp)
                        else:
                            if carry is None:
                                carry = (dev_t(last), dev_t(wpos),
                                         dev_t(np.zeros(S, np.int32)))
                            cmap = np.full(plan.toks.size, -1, np.int32)
                            pmap = np.full(plan.toks.size, -1, np.int32)
                            pp = plan.pos.copy()
                            for r in range(plan.rows):
                                o, k = r * W, plan.drafts[r].size
                                cmap[o] = rows[r]
                                pmap[o:o + 1 + k] = rows[r]
                                pp[o:o + 1 + k] = np.arange(1 + k)
                            rslot = np.array([r if r is not None else -1
                                              for r in rows], np.int32)
                            sp, m = store.unified_args(
                                rows, [r is not None for r in rows],
                                plan.steps)
                            args = (params, dev_t(plan.toks),
                                    dev_t(plan.seg), dev_t(pp), tab,
                                    dev_t(plan.sample_idx),
                                    dev_t(plan.dlen), dev_t(rslot),
                                    dev_t(cmap), dev_t(pmap), dev_t(rslot),
                                    *carry, c.k_blocks, c.v_blocks, sp)
                        if m != mode:
                            fail(f"phase 5v (a): the store's mode {m}")
                        torch.cuda.synchronize()
                        if d == 1:
                            kernels.reset_launch_counts()
                        if graph and d == 1:
                            torch.cuda.set_sync_debug_mode("error")
                        try:
                            if prog == "packed_verify":
                                out = (dec.graphs.verify(mode, *args)
                                       if graph else
                                       dec.packed_verify(*args, mode))
                            else:
                                out = (dec.graphs.unified(mode, *args)
                                       if graph else dec.unified_round(
                                           *args, mode, window=True))
                        finally:
                            torch.cuda.set_sync_debug_mode("default")
                        torch.cuda.synchronize()
                        vals = [out[0], out[1], out[2], out[5]] + (
                            list(out[6:9]) if prog != "packed_verify"
                            else [])
                        got.append([None if v is None else v.clone()
                                    for v in vals])
                        store.swap_counts(out[5])
                        if prog != "packed_verify":
                            carry = tuple(v.clone() for v in out[6:9])
                        vt, ac = out[0].cpu().numpy(), out[1].cpu().numpy()
                        for r in range(plan.rows):
                            a = int(ac[r])
                            last[rows[r]] = vt[r, a]
                            wpos[rows[r]] += a + 1
                    counts.append(kernels.launch_counts())
                    outs.append(got)
                what = (f"phase 5v (a) {prog} {kv_dtype or 'dense'} "
                        f"{mname}")
                for ge, gg in zip(*outs):
                    for a, b in zip(ge, gg):
                        if (a is None) != (b is None) or (
                                a is not None and not torch.equal(a, b)):
                            fail(f"{what}: graph and eager outputs differ")
                for a, b in zip(*[c._pool_leaves() for c in pools]):
                    if not torch.equal(a, b):
                        fail(f"{what}: the pools differ")
                k1 = counts[1]["ragged_stream_" + (kv_dtype or "dense")]
                if counts[0] != counts[1] or k1 != L:
                    fail(f"{what}: a replay's launches {counts[1]} vs eager "
                         f"{counts[0]}")
                cases += 1
            if dec.graphs.captures != 2:
                fail(f"phase 5v (a): {dec.graphs.captures} captures for 2 "
                     f"keys")
        del pools
        torch.cuda.empty_cache()
    return cases


def spec_prompts(vocab, seed, n, lo, hi):
    """Tiled short motifs (2-5 tokens) of lo..hi tokens: traffic the
    n-gram drafter can predict (bench.py's speculation axis)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        motif = rng.randint(1, vocab, (int(rng.randint(2, 6)),)).astype(
            np.int32)
        m = int(rng.randint(lo, hi + 1))
        out.append(np.tile(motif, -(-m // motif.size))[:m])
    return out


V_SAMPLING = ({}, dict(temperature=0.8, top_p=0.9, seed=7),
              dict(repetition_penalty=1.3, presence_penalty=0.3,
                   frequency_penalty=0.1),
              dict(temperature=1.0, top_k=50, seed=8, presence_penalty=0.5))


def spec_parity(torch, model32, card):
    """5v (a): float32 GPT-2 small (phase 4's weights, TF32 off) serving
    8 repetitive prompts of 48-96 tokens (RandomState(31)) with V_NEW new
    tokens, requests cycling greedy / seeded sampled / penalties /
    sampled with a penalty, on the card and on the CPU: speculation off,
    n-gram (K 8), replay (K 8, the card's own speculation-off tokens),
    the unified round (sync, n-gram) and async rounds (n-gram). Every
    server's card tokens equal its CPU tokens and the speculation-off
    card tokens. On the card: replays equal verify dispatches (split) and
    window rounds (unified); dispatches_per_round 1.0 with a mixed round;
    every async dispatch under set_sync_debug_mode("error"). Returns
    {server: (stats, launch counts)}."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.sampling import SamplingParams
    from paddle_tpu_torch.spec_decode import SpecConfig

    cfg = model32.cfg
    prompts = spec_prompts(cfg.vocab_size, 31, 8, 48, 96)
    sampling = [SamplingParams(**V_SAMPLING[i % 4]) if V_SAMPLING[i % 4]
                else None for i in range(len(prompts))]

    def run(dev, kw):  # the server snapshots model32's params on dev
        srv = spec_server(model32, dev, kw, V_NEW, 128)
        seen = (strict_dispatches(torch, srv)
                if dev == DEV and kw.get("async_rounds") else None)
        futs = [srv.submit(p, sampling=s) for p, s in zip(prompts, sampling)]
        kernels.reset_launch_counts()
        srv.start()
        try:
            outs = [f.result(timeout=600) for f in futs]
            st = srv.stats()
        finally:
            srv.stop()
        if seen is not None and seen["dispatches"] != st["rounds"]["rounds"]:
            fail("phase 5v (a) async: a dispatch escaped the sync check")
        return outs, st, kernels.launch_counts()

    base = {}
    res = {}
    servers = [("off", {}), ("ngram", dict(speculation=SpecConfig(
        max_draft_tokens=V_K))), ("replay", None),
        ("unified", dict(unified_round=True,
                         speculation=SpecConfig(max_draft_tokens=V_K))),
        ("async", dict(async_rounds=True,
                       speculation=SpecConfig(max_draft_tokens=V_K)))]
    for name, kw in servers:
        if kw is None:  # the replay drafter replays the card's tokens
            kw = dict(speculation=SpecConfig(
                max_draft_tokens=V_K, drafter=ReplayDrafter(base[DEV])))
        outs = {}
        for dev in (DEV, "cpu"):
            outs[dev], st, counts = run(dev, kw)
            if dev == DEV:
                res[name] = (st, counts)
        if name == "off":
            base = outs
        for i, (a, b) in enumerate(zip(outs[DEV], outs["cpu"])):
            if not np.array_equal(a, b):
                fail(f"phase 5v (a) {name}: request {i} differs card vs CPU")
        for i, (a, b) in enumerate(zip(outs[DEV], base[DEV])):
            if not np.array_equal(a, b):
                fail(f"phase 5v (a) {name}: request {i} differs from "
                     f"speculation off")
        st, counts = res[name]
        sp, rd = st["speculation"], st["rounds"]
        if name in ("ngram", "replay"):
            if sp["verify_dispatches"] == 0 or \
                    st["verify_graph_replays"] != sp["verify_dispatches"]:
                fail(f"phase 5v (a) {name}: {st['verify_graph_replays']} "
                     f"verify replays for {sp['verify_dispatches']} verify "
                     f"dispatches")
            if name == "replay" and sp["acceptance_rate"] != 1.0:
                fail(f"phase 5v (a) replay: acceptance {sp}")
        if name in ("unified", "async"):
            if rd["dispatches_per_round"] != 1.0 or rd["mixed_rounds"] < 1:
                fail(f"phase 5v (a) {name}: rounds {rd}")
            if st["round_graph_replays"] != \
                    rd["rounds"] - st["prefill_dispatches"]:
                fail(f"phase 5v (a) {name}: {st['round_graph_replays']} "
                     f"window replays for {rd['rounds']} rounds, "
                     f"{st['prefill_dispatches']} with prefill rows")
    return res


def spec_axis_pool(torch, model, card):
    """5v (b)'s speculation traffic: bench.py's speculation axis
    (bench.py:1655-1700) at its on-TPU parameters: 64 candidate prompts
    of tiled 2-5-token motifs (RandomState(11), lengths drawn in
    [85, 253) and cut to a multiple of 32: 64-224), their greedy
    continuations recorded by the port's plain server, and the 16 whose
    recordings an n-gram drafter (max 3, min 1) predicts in the fewest
    rounds. Returns (pool, recordings)."""
    from paddle_tpu_torch.spec_decode import NgramDrafter

    vocab = model.cfg.vocab_size
    rng = np.random.RandomState(11)
    step = max(4, S_MP // 8)
    cands = []
    for _ in range(4 * S_REQS):
        motif = rng.randint(1, vocab, (int(rng.randint(2, 6)),)).astype(
            np.int32)
        n = int(rng.randint(max(4, S_MP // 3), S_MP - 3))
        n = max(step, n // step * step)
        cands.append(np.tile(motif, -(-n // motif.size))[:n])
    srv = spec_server(model, DEV, {}, S_NEW, S_MP).start()
    try:
        refs = [f.result(timeout=600) for f in
                [srv.submit(p) for p in cands]]
    finally:
        srv.stop()
    drafter = NgramDrafter(max_match=3, min_match=1)
    scored = []
    for idx, (p, out) in enumerate(zip(cands, refs)):
        n, pos, rounds = p.size, 1, 0
        while pos < S_NEW:
            prop = drafter.propose(out[:n + pos],
                                   min(V_K, S_NEW - pos - 1) or 1)
            rounds += 1
            hits = 0
            for j, tk in enumerate(prop):
                if int(tk) != int(out[n + pos + j]):
                    break
                hits += 1
            pos += hits + 1
        scored.append((rounds, idx))
    keep = [i for _r, i in sorted(scored)[:S_REQS]]
    return [cands[i] for i in keep], [refs[i] for i in keep]


def profiled_busy(torch, drive):
    """One more pass of `drive` under torch.profiler: the device's busy
    time in seconds (every CUDA kernel and copy)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drive()
        torch.cuda.synchronize()
    busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy += getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0))
    return busy / 1e6


def axis_run(torch, model, kw, pool, drive, new, mp, chunk, spy=False):
    """A warm pass (closed), a measured pass and a profiled pass of
    `drive(srv)` on one server. Returns (outputs, stats, launch counts,
    verify-stream launches, the profiled pass's busy s, the measured
    pass's wall s): the idle share is 1 - busy / wall, as phase 5 and
    scripts/torch_serve_profile.py read it."""
    from paddle_tpu_torch.ops import kernels

    srv = spec_server(model, DEV, kw, new, mp, chunk=chunk).start()
    ls = LaunchSpy(srv._decoder.graphs) if spy else None
    try:
        for f in [srv.submit(p) for p in pool]:
            f.result(timeout=600)
        srv.reset_stats()
        kernels.reset_launch_counts()                        # main path
        if ls is not None:
            ls.counts.clear()
        t0 = time.perf_counter()
        outs = drive(srv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        st = srv.stats()
        vcounts = dict(ls.counts) if ls is not None else {}
        busy = profiled_busy(torch, lambda: drive(srv))
    finally:
        srv.stop()
    for p, o in zip(pool, outs):
        if o.shape != (p.size + new,) or not (o[:p.size] == p).all():
            fail(f"phase 5v (b): bad output for a {p.size}-token prompt")
    return outs, st, counts, vcounts, busy, wall


def verify_dispatch_cost(torch, model, m_width, reps=30, K=V_K):
    """The served verify dispatch alone (8 rows of W K + 1 at GPT-2 small
    bf16, contexts RandomState(45) 100-200, a pool of m_width columns):
    one graph replay's time by CUDA events, and under torch.profiler the
    device time per dispatch of every kernel and of K1 with K1's
    launches (the profiler's count)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference.kv_cache import PagedKVCache, blocks_for
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.sampling import SlotParamStore
    from paddle_tpu_torch.spec_decode import build_verify_plan

    cfg = model.cfg
    H = cfg.num_heads
    rs = np.random.RandomState(45)
    lens = rs.randint(100, 201, V_P)
    nb = sum(blocks_for(int(n) + K + 1, 16) for n in lens) + 1
    c = PagedKVCache(cfg.num_layers, H, cfg.hidden_size // H, block_size=16,
                     num_blocks=nb, dtype=torch.bfloat16, device=DEV)
    c.ensure_many([(b, int(n) + K + 1) for b, n in enumerate(lens)])
    tables = torch.from_numpy(c.table_array(range(V_P), m_width)).to(DEV)
    store = SlotParamStore(V_P, cfg.vocab_size, DEV)
    entries = [(b, 50, int(lens[b]) - 1, 0,
                rs.randint(1, cfg.vocab_size, K).astype(np.int32))
               for b in range(V_P)]
    plan = build_verify_plan(entries, K, 1, min_rows=V_P)
    sp, mode = store.verify_args(list(range(V_P)), plan.steps)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(DEV)

    args = (model.flat_params(), t(plan.toks), t(plan.seg), t(plan.pos),
            tables, t(plan.sample_idx), t(plan.dlen), c.k_blocks,
            c.v_blocks, sp)
    dec = PagedDecoder.for_config(cfg, 16)

    def call():
        return dec.graphs.verify(mode, *args)

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        call()
    e.record()
    e.synchronize()
    ms = s.elapsed_time(e) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    total = k1 = n1 = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        total += us
        if K1_NAME.search(ev.key):
            k1 += us
            n1 += ev.count
    return {"ms": ms, "device_ms": total / 1e3 / reps,
            "k1_ms": k1 / 1e3 / reps, "k1_launches": n1 / reps}


def axis_text(st, counts, busy, wall, extra=""):
    """One 5v (b) server's measured numbers as text."""
    rd = st["rounds"]
    return (f"tokens_per_sec {st['tokens_per_sec']:.1f} ttft "
            f"p50/p99 {st['ttft_p50_ms']:.1f}/{st['ttft_p99_ms']:.1f} ms itl "
            f"p50/p99 {st['itl_p50_ms']:.2f}/{st['itl_p99_ms']:.2f} ms "
            f"prefill_dispatches {st['prefill_dispatches']} decode "
            f"dispatches {st['decode_steps']} rounds {rd['rounds']} "
            f"attention dispatches {rd['attention_dispatches']} (mixed "
            f"{rd['mixed_rounds']}) launches K1 "
            f"{counts['ragged_stream_dense'] + counts['ragged_stream_int8']}"
            f" K2 {counts['paged_decode_dense'] + counts['paged_decode_int8']}"
            f"; device busy {busy * 1e3:.1f} ms of {wall * 1e3:.1f} ms wall, "
            f"idle share {1 - busy / wall:.3f}; overlap_fraction "
            f"{rd['overlap_fraction']:.3f}{extra}")


def spec_serving(torch, model, card):
    """5v (b): GPT-2 small bf16 (phase 4f's weights), block 16. The
    speculation axis (`spec_axis_pool`; 8 slots, K 8, S_NEW new tokens,
    chunk 512): speculation off, n-gram, replay (the recordings), then
    int8 pools off and n-gram; tokens against speculation off (the int8
    n-gram against int8 off) but for near ties (phase 4f's rule). Then
    bench.py's unified axis (bench.py:1758-1800 at its on-TPU parameters:
    32 prompts of 64-256 tokens from RandomState(17), U_NEW new tokens,
    chunk 256, Poisson arrivals (seed 978) at 8x the split engine's
    closed drain rate of this call): split, unified sync, async; tokens
    against split but for near ties. Returns the main path's K1/K2
    launches, the verify-stream K1 launches and the verify dispatch's
    cost."""
    from paddle_tpu_torch.spec_decode import SpecConfig

    cfg = model.cfg
    L = cfg.num_layers
    pool, refs = spec_axis_pool(torch, model, card)
    launches = {"ragged_stream_dense": 0, "ragged_stream_int8": 0,
                "paged_decode_dense": 0, "paged_decode_int8": 0}
    verify = {"ragged_stream_dense": 0, "ragged_stream_int8": 0}
    params_cpu = {k: v.float().cpu() for k, v in model.flat_params().items()}

    def closed(srv):
        return [f.result(timeout=600) for f in
                [srv.submit(p) for p in pool]]

    spec = SpecConfig(max_draft_tokens=V_K)
    runs = {}
    for name, kw in (("off", {}), ("ngram", dict(speculation=spec)),
                     ("replay", dict(speculation=SpecConfig(
                         max_draft_tokens=V_K, drafter=ReplayDrafter(refs)))),
                     ("int8 off", dict(kv_dtype="int8")),
                     ("int8 ngram", dict(kv_dtype="int8", speculation=spec))):
        outs, st, counts, vc, busy, wall = axis_run(
            torch, model, kw, pool, closed, S_NEW, S_MP, 512, spy=True)
        runs[name] = outs
        for n in launches:
            launches[n] += counts[n]
        for n in verify:
            verify[n] += vc.get(n, 0)
        sp = st["speculation"]
        base = runs["int8 off" if name.startswith("int8") else "off"]
        ties = 0
        for p, a, b in zip(pool, base, outs):
            if not np.array_equal(a, b):
                if not near_tie_rule(torch, params_cpu, cfg, a, b, p.size,
                                     phase="5v (b)"):
                    fail(f"phase 5v (b) {name}: tokens differ from "
                         f"speculation off beyond phase 4f's near-tie rule")
                ties += 1
        extra = ""
        if sp["enabled"]:
            kv = "int8" if name.startswith("int8") else "dense"
            k1v = vc.get(f"ragged_stream_{kv}", 0)
            if sp["verify_dispatches"] == 0 or \
                    k1v != L * sp["verify_dispatches"] or \
                    st["verify_graph_replays"] != sp["verify_dispatches"]:
                fail(f"phase 5v (b) {name}: {k1v} verify-stream K1 launches"
                     f" and {st['verify_graph_replays']} replays for "
                     f"{sp['verify_dispatches']} verify dispatches")
            extra = (f"; acceptance_rate {sp['acceptance_rate']:.4f} "
                     f"(proposed {sp['proposed_tokens']}, accepted "
                     f"{sp['accepted_tokens']}) verify dispatches "
                     f"{sp['verify_dispatches']} (graph replays "
                     f"{st['verify_graph_replays']}), K1 on verify streams "
                     f"{k1v} = {k1v / sp['verify_dispatches']:.1f} a verify "
                     f"dispatch")
        say(f"phase 5v (b) speculation axis bf16 {name}: {S_REQS} requests x "
            f"{S_NEW} tokens, " + axis_text(st, counts, busy, wall, extra)
            + f"; {len(pool) - ties} of {len(pool)} requests identical to "
            f"speculation off, {ties} at a near tie [{card}]")
    cost = verify_dispatch_cost(torch, model, -(-(S_MP + S_NEW + V_K) // 16))
    say(f"phase 5v (b) one verify dispatch at the served shape (8 rows x W "
        f"{V_K + 1}, GPT-2 small bf16, one graph replay): {cost['ms']:.4f} "
        f"ms by events, device {cost['device_ms']:.4f} ms (profiler, every "
        f"kernel), K1 {cost['k1_ms']:.4f} ms device in "
        f"{cost['k1_launches']:.1f} launches a dispatch [{card}]")

    # the unified axis
    rng = np.random.RandomState(17)
    upool = [rng.randint(1, cfg.vocab_size,
                         (int(rng.randint(max(4, U_MP // 4), U_MP + 1)),))
             .astype(np.int32) for _ in range(U_REQS)]
    srv = spec_server(model, DEV, {}, U_NEW, U_MP, chunk=256).start()
    try:
        for f in [srv.submit(p) for p in upool]:   # warm
            f.result(timeout=600)
        t0 = time.perf_counter()
        for f in [srv.submit(p) for p in upool]:
            f.result(timeout=600)
        rps = 8.0 * U_REQS / max(time.perf_counter() - t0, 1e-6)
    finally:
        srv.stop()

    def poisson(srv):
        return poisson_drive(srv, upool, rps, seed=978, new=U_NEW)[0]

    uruns = {}
    for name, kw in (("split", {}), ("unified", dict(unified_round=True)),
                     ("async", dict(async_rounds=True))):
        outs, st, counts, _vc, busy, wall = axis_run(
            torch, model, kw, upool, poisson, U_NEW, U_MP, 256)
        uruns[name] = outs
        for n in launches:
            launches[n] += counts[n]
        rd = st["rounds"]
        if name != "split" and rd["dispatches_per_round"] != 1.0:
            fail(f"phase 5v (b) unified axis {name}: rounds {rd}")
        ties = 0
        for p, a, b in zip(upool, uruns["split"], outs):
            if not np.array_equal(a, b):
                if not near_tie_rule(torch, params_cpu, cfg, a, b, p.size,
                                     phase="5v (b)"):
                    fail(f"phase 5v (b) unified axis {name}: tokens differ "
                         f"from split beyond phase 4f's near-tie rule")
                ties += 1
        say(f"phase 5v (b) unified axis bf16 {name}: {U_REQS} requests x "
            f"{U_NEW} tokens at {rps:.2f} req/s (Poisson, seed 978), "
            + axis_text(st, counts, busy, wall) + f"; window-round replays {st['round_graph_replays']}; "
            f"{U_REQS - ties} of {U_REQS} requests identical to split, "
            f"{ties} at a near tie [{card}]")
    return launches, verify, cost


# ---- phases 3e, 4t and 6t: the seq2seq Transformer (WMT base) ---------------

# 3e: the key lengths of K4's one-query (Sq = 1) cases: a cached decode
# step's self-attention sees 1..max_len keys, its cross-attention S_src
Q1_SK = (1, 2, 63, 64, 65, 127, 128, 129, 255)
K4_NAME = re.compile(r"(?:^|[\s:])flash_fwd\w*")
NOT_FLUSH = re.compile(r"^(?!.*FillFunctor)")  # every kernel but Timer's
# 4t / 6t: the WMT base config (Vaswani et al. 2017, the reference's
# TransformerConfig defaults) and the traffic
S2S_LR = 1e-4
S2S_NEAR = 1e-4  # 4t: a token may differ only where the CPU's margin is
# below this (phase 4f's near-tie rule, on float32 logits or beam scores)


def q1_flash_case(torch, timer, b, h, sk, d, dtype, seed, timed):
    """Phase 3e: K4 at one query (Sq = 1, the cached decode step) over sk
    keys, not causal, against its plain version (float32 from the same
    inputs), out and lse bitwise equal over two launches; with `timed`,
    the kernel (events and profiler), the plain version, SDPA and the
    dense path (`ops.attention.dense_attention`, the route of a masked
    call), and the bound. Returns the row or fails."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import dense_attention

    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn(b, h, 1, d, generator=g, device=DEV).to(dtype)
    k, v = (torch.randn(b, h, sk, d, generator=g, device=DEV).to(dtype)
            for _ in range(2))
    sc = d ** -0.5
    out, lse = kernels.flash_fwd(q, k, v, sc, False)
    out2, lse2 = kernels.flash_fwd(q, k, v, sc, False)
    torch.cuda.synchronize()
    tag = f"B{b} H{h} Sq1 Sk{sk} D{d} {str(dtype).split('.')[-1]}"
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        fail(f"phase 3e {tag}: two launches differ")
    out_p, lse_p = pf.flash_fwd_lse_plain(q.float(), k.float(), v.float(),
                                          sc, False)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    errs = {}
    for name, a, p, t in (("out", out, out_p, tol), ("lse", lse, lse_p,
                                                     1e-4)):
        err, rel = _rel_err(a, p)
        errs[name] = err
        if not torch.isfinite(a).all().item() or rel > t:
            fail(f"phase 3e {tag}: {name} disagrees with plain (max abs err "
                 f"{err:.3g}, {rel:.3g} of its magnitude > {t})")
    row = {"max_abs_err": max(errs.values()), "tag": tag}
    if not timed:
        return row
    row["ms"] = timer.ms(lambda: kernels.flash_fwd(q, k, v, sc, False))
    row["device_ms"] = timer.device_ms(
        lambda: kernels.flash_fwd(q, k, v, sc, False), K4_NAME)
    row["plain_ms"] = timer.ms(lambda: pf.flash_fwd_lse_plain(
        q, k, v, sc, False))
    row["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=sc))
    row["library_device_ms"] = timer.device_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=sc),
        NOT_FLUSH)
    row["dense_ms"] = timer.ms(lambda: dense_attention(q, k, v, scale=sc))
    row["dense_device_ms"] = timer.device_ms(
        lambda: dense_attention(q, k, v, scale=sc), NOT_FLUSH)
    e, bh = q.element_size(), b * h
    row.update(_bound(2 * bh * d * e + 2 * bh * sk * d * e + 4 * bh,
                      4 * bh * d * sk))
    return row


class Q1Spy:
    """Counts the K4 launches at one query (Sq = 1) through
    `kernels.flash_fwd` while it is installed (the wrapper itself counts
    every K4 launch): the cached decode steps' share."""

    def __init__(self):
        from paddle_tpu_torch.ops import kernels

        self.kernels, self.real, self.count = kernels, kernels.flash_fwd, 0

    def __enter__(self):
        def spy(q, *a, **k):
            out = self.real(q, *a, **k)
            self.count += q.shape[2] == 1
            return out
        self.kernels.flash_fwd = spy
        return self

    def __exit__(self, *exc):
        self.kernels.flash_fwd = self.real


def wmt_embeddings(torch, model, seed=0):
    """Re-draws the source and target embeddings of `model` from
    N(0, d_model^-0.5) (a seeded CPU generator), the published model's
    initialization (Vaswani et al. 2017 scale them by sqrt(d_model): unit
    scale in; tensor2tensor and fairseq draw them so). The reference's
    N(0, 1) gives the first layers inputs of scale sqrt(d_model) ~ 22:
    their attention is saturated at init (scores std ~500 at WMT base, a
    row's top weight 0.995 on average), so the ±lr moves of AdamW's first
    step on elements whose gradient is rounding noise make the second
    step's gradients chaotic. Two CPU runs of 4t's steps that differ only
    in their thread count (their sums' order) differ by 3.6e-3 of a
    gradient's magnitude there at step 2, by 4.3e-5 with these
    embeddings. Returns the model."""
    g = torch.Generator().manual_seed(seed)
    std = model.cfg.d_model ** -0.5
    with torch.no_grad():
        for emb in (model.src_embed, model.tgt_embed):
            emb.weight.copy_(torch.empty(emb.weight.shape).normal_(
                0.0, std, generator=g))
    return model


def s2s_batch(torch, cfg, b, s_src, s_tgt, seed, dev):
    """(src [b, s_src], tgt_in [b, s_tgt] from bos, tgt_out [b, s_tgt])
    random ids from RandomState(seed), as int64 on dev."""
    rs = np.random.RandomState(seed)
    src = rs.randint(2, cfg.src_vocab_size, (b, s_src))
    tgt = rs.randint(2, cfg.tgt_vocab_size, (b, s_tgt + 1))
    tgt[:, 0] = cfg.bos_id
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (src, tgt[:, :-1], tgt[:, 1:]))


def s2s_train_parity(torch, cfg, lr=S2S_LR, steps=2, b=4, s_src=128,
                     s_tgt=96):
    """Phase 4t (a): float32 AdamW steps (wd 0.01) of the label-smoothed
    loss on the card and on the CPU from the same weights, with phase 4c's
    limits; per step on the card K4, K6 and K9 launch once for each
    encoder self-attention and each cross-attention (the decoder's masked
    self-attention is the dense path), the bias kernels never. Then the
    logits of a padded source (K4 bias in the encoder) card vs CPU.
    Returns (worst differences, the card's launch counts summed)."""
    from paddle_tpu_torch.models.transformer import (TransformerModel,
                                                     loss_with)
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW

    models = {d: wmt_embeddings(torch, TransformerModel(cfg, device=d))
              for d in (DEV, "cpu")}
    params = {DEV: {n: p.detach().clone().requires_grad_(True)
                    for n, p in models[DEV].named_parameters()}}
    params["cpu"] = {n: p.detach().cpu().requires_grad_(True)
                     for n, p in params[DEV].items()}
    opts = {d: AdamW(lr, weight_decay=0.01, device=d) for d in params}
    states = {d: opts[d].functional_init(params[d]) for d in params}
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    per_step = cfg.num_encoder_layers + cfg.num_decoder_layers
    total = {}
    for step in range(steps):
        out = {}
        for d in (DEV, "cpu"):
            batch = s2s_batch(torch, cfg, b, s_src, s_tgt, 31 + step, d)
            kernels.reset_launch_counts()
            loss = loss_with(models[d], params[d], *batch,
                             label_smoothing=0.1)
            grads = torch.autograd.grad(loss, list(params[d].values()))
            counts = kernels.launch_counts()
            opts[d].functional_update(params[d], dict(zip(params[d], grads)),
                                      states[d])
            out[d] = (loss.item(), grads, counts)
        counts = out[DEV][2]
        for n in FLASH + FLASH_BIAS[::2]:
            want = per_step if n in FLASH else 0
            if counts[n] != want:
                fail(f"phase 4t step {step}: {n} launched {counts[n]} "
                     f"times, expected {want}")
        for n, v in counts.items():
            total[n] = total.get(n, 0) + v
        rel = abs(out[DEV][0] - out["cpu"][0]) / abs(out["cpu"][0])
        worst["loss"] = max(worst["loss"], rel)
        if rel > 1e-4:
            fail(f"phase 4t step {step}: loss {out[DEV][0]} vs CPU "
                 f"{out['cpu'][0]} (relative {rel:.3g} > 1e-4)")
        # as phase 4d: the k_proj biases' exact gradient is zero
        floor = 1e-3 * max(g.abs().max().item() for g in out["cpu"][1])
        for name, a, c in zip(params[DEV], out[DEV][1], out["cpu"][1]):
            err = (a.cpu() - c).abs().max().item()
            r = err / max(c.abs().max().item(), floor)
            worst["grad"] = max(worst["grad"], r)
            if r > 1e-3:
                fail(f"phase 4t step {step}: gradient {name} differs by "
                     f"{r:.3g} of its magnitude (> 1e-3)")
    limit = 2 * lr * steps + 1e-6
    for name, p in params[DEV].items():
        diff = (p.detach().cpu() - params["cpu"][name].detach()).abs().max()
        worst["param"] = max(worst["param"], diff.item())
        if diff.item() > limit:
            fail(f"phase 4t: parameter {name} differs by {diff.item():.3g} "
                 f"after {steps} steps (> {limit:.3g})")
    # a padded source: the encoder's padding mask is a per-key bias
    lens = np.array([s_src, 100, 77, 40])[:b]
    pad = (np.arange(s_src)[None] < lens[:, None]).astype(np.int64)
    logits = {}
    for d in (DEV, "cpu"):
        models[d].load_state_dict(params[d])
        models[d].eval()
        src, tin, _ = s2s_batch(torch, cfg, b, s_src, s_tgt, 33, d)
        kernels.reset_launch_counts()
        with torch.no_grad():
            logits[d] = models[d](src, tin, torch.from_numpy(pad).to(d))
        if d == DEV:
            counts = kernels.launch_counts()
    want = {"flash_fwd_bias": cfg.num_encoder_layers,
            "flash_fwd": cfg.num_decoder_layers}
    for n, v in want.items():
        if counts[n] != v:
            fail(f"phase 4t: the padded-source forward launched {n} "
                 f"{counts[n]} times, expected {v}")
        total[n] += v
    _err, rel = _rel_err(logits[DEV].cpu(), logits["cpu"])
    worst["logits"] = rel
    if rel > 1e-4:
        fail(f"phase 4t: padded-source logits card vs CPU differ by {rel:.3g}"
             f" of their largest magnitude (> 1e-4)")
    return worst, total, models


def _greedy_margin(torch, model_cpu, src_row, toks, i):
    """The CPU model's top-two margin of the logits that chose token i of
    `toks` (its prefix teacher-forced)."""
    with torch.no_grad():
        lg = model_cpu(src_row[None], torch.from_numpy(
            np.ascontiguousarray(toks[:i]))[None])[0, -1]
    top = torch.topk(lg.float(), 2).values
    return (top[0] - top[1]).item()


class BeamMargins:
    """While installed, records for each beam step the smallest gap
    between neighbours among the top K + 1 candidates of each row
    (`models.transformer.topk_impl`'s input): a beam choice within that
    gap of another is a near tie."""

    def __init__(self):
        from paddle_tpu_torch.models import transformer

        self.mod, self.real, self.steps = transformer, transformer.topk_impl, []

    def __enter__(self):
        def spy(x, k, *a, **kw):
            top = x.float().sort(-1, descending=True).values[:, :k + 1]
            self.steps.append((top[:, :-1] - top[:, 1:]).min(-1).values.cpu())
            return self.real(x, k, *a, **kw)
        self.mod.topk_impl = spy
        return self

    def __exit__(self, *exc):
        self.mod.topk_impl = self.real


def s2s_decode_parity(torch, card, cpu, cfg, b=8, s_src=64, max_len=64,
                      beam=4, alpha=0.6):
    """Phase 4t (b): float32 greedy (cached and not) and beam decoding of
    b sources on the card against the CPU's, by phase 4f's near-tie rule:
    a row may differ only where the CPU's margin at its first difference
    is below S2S_NEAR (greedy: the top two logits there; beam: the
    smallest gap among a row's top K + 1 candidates over the steps up to
    it). The cached greedy run launches K4 num_encoder_layers + 2 x
    num_decoder_layers x (max_len - 1) times and never the dense path.
    Returns ({run: differing rows with their margins}, the card's launch
    counts summed, the Sq = 1 launches)."""
    from paddle_tpu_torch.ops import kernels

    rs = np.random.RandomState(41)
    src = torch.from_numpy(rs.randint(2, cfg.src_vocab_size, (b, s_src)))
    total, q1 = {}, 0
    outs = {}
    for name, fn in (("greedy", lambda m: m.greedy_decode(src, max_len)),
                     ("uncached", lambda m: m.greedy_decode(
                         src, max_len, use_cache=False)),
                     ("beam", lambda m: m.beam_search_decode(
                         src, beam, max_len, alpha))):
        kernels.reset_launch_counts()
        with Q1Spy() as spy:
            outs[name] = fn(card).cpu().numpy()
        counts = kernels.launch_counts()
        for n, v in counts.items():
            total[n] = total.get(n, 0) + v
        q1 += spy.count
        steps = outs[name].shape[1] - 1
        if name == "greedy":
            want = cfg.num_encoder_layers + 2 * cfg.num_decoder_layers * steps
            if counts["flash_fwd"] != want or spy.count != want - \
                    cfg.num_encoder_layers:
                fail(f"phase 4t: the cached greedy run launched K4 "
                     f"{counts['flash_fwd']} times ({spy.count} at Sq = 1),"
                     f" expected {want}")
    with BeamMargins() as bm:
        outs["beam_cpu"] = cpu.beam_search_decode(src, beam, max_len,
                                                  alpha).numpy()
    outs["greedy_cpu"] = cpu.greedy_decode(src, max_len).numpy()
    near = {}
    for name, ref in (("greedy", "greedy_cpu"), ("uncached", "greedy_cpu"),
                      ("beam", "beam_cpu")):
        a, c = outs[name], outs[ref]
        if a.shape != c.shape and name != "beam":
            fail(f"phase 4t: {name} tokens {a.shape} vs CPU {c.shape}")
        T = min(a.shape[1], c.shape[1])
        for r in range(b):
            if a.shape == c.shape and np.array_equal(a[r], c[r]):
                continue
            diff = np.nonzero(a[r, :T] != c[r, :T])[0]
            i = int(diff[0]) if len(diff) else T
            if name == "beam":
                m = min(float(s[r]) for s in bm.steps[:max(i, 1)])
            else:
                m = _greedy_margin(torch, cpu, src[r], c[r], i)
            near.setdefault(name, []).append((r, i, m))
            if m >= S2S_NEAR:
                fail(f"phase 4t: {name} row {r} differs from the CPU's at "
                     f"token {i}, where the CPU's margin is {m:.3g} "
                     f"(>= {S2S_NEAR})")
    return near, total, q1, outs


def s2s_amp_train_step(torch, cfg, batch, lr=S2S_LR):
    """The mixed-precision step of phase 6's recipe on the seq2seq model:
    float32 masters, bf16 copies made inside the autograd graph and bound
    through `loss_with`, the label-smoothed loss cast to float32, AdamW
    (wd 0.01) in float32; dropout (cfg.dropout) draws from a seeded card
    generator. Returns step() -> the loss tensor."""
    from paddle_tpu_torch.models.transformer import (TransformerModel,
                                                     loss_with)
    from paddle_tpu_torch.nn import set_dropout_generator
    from paddle_tpu_torch.optimizer import AdamW

    model = wmt_embeddings(torch, TransformerModel(cfg, device=DEV))
    model.train()
    set_dropout_generator(model,
                          torch.Generator(device=DEV).manual_seed(0))
    masters = {n: p.detach().clone().requires_grad_(True)
               for n, p in model.named_parameters()}
    opt = AdamW(lr, weight_decay=0.01, device=DEV)
    state = opt.functional_init(masters)

    def step():
        low = {n: p.to(torch.bfloat16) for n, p in masters.items()}
        loss = loss_with(model, low, *batch, label_smoothing=0.1).float()
        grads = torch.autograd.grad(loss, list(masters.values()))
        opt.functional_update(masters, dict(zip(masters, grads)), state)
        return loss.detach()

    return step


def s2s_train_throughput(torch, cfg, b=32, s_src=128, s_tgt=128, warm=2,
                         steps=5, profiled=2):
    """Phase 6t (a): the mixed-precision step at the published config
    (dropout 0.1: the attention is the dense path) on one fixed batch:
    ms per step (CUDA events), target tokens/s, peak memory, losses, the
    launch counts of the measured steps, and the device's idle share (a
    profiled pass of `profiled` steps: 1 - busy per step / the measured
    wall per step)."""
    from paddle_tpu_torch.ops import kernels

    step = s2s_amp_train_step(torch, cfg, s2s_batch(torch, cfg, b, s_src,
                                                    s_tgt, 0, DEV))
    losses = [step().item() for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()                          # main path
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    measured = [step() for _ in range(steps)]
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) / steps
    counts = kernels.launch_counts()
    losses += [x.item() for x in measured]
    ms = start.elapsed_time(end) / steps
    busy = profiled_busy(torch, lambda: [step() for _ in range(profiled)])
    return {"losses": losses, "ms_per_step": ms, "wall_ms": wall * 1e3,
            "tokens_per_sec": b * s_tgt / (ms / 1e3),
            "peak": torch.cuda.max_memory_allocated(), "counts": counts,
            "busy_ms": busy / profiled * 1e3,
            "idle": 1 - busy / profiled / wall}


def s2s_decode_throughput(torch, model, src, max_len, fn):
    """Phase 6t (b): one warm and one measured run of `fn(model, src,
    max_len)` (a decode), then a profiled one: ms per decode step and
    output tokens/s (host clock to a synchronize), the launch counts,
    Sq = 1 K4 launches and dense-path calls of the measured run, K4's
    device time and its share of the device's busy time, and the idle
    share."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels

    from paddle_tpu_torch.ops import attention

    fn(model, src, max_len)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()                          # main path
    dense, real_dense = [0], attention.dense_attention

    def dense_spy(*a, **k):
        dense[0] += 1
        return real_dense(*a, **k)

    attention.dense_attention = dense_spy
    try:
        with Q1Spy() as spy:
            t0 = time.perf_counter()
            out = fn(model, src, max_len)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        attention.dense_attention = real_dense
    counts = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(model, src, max_len)
        torch.cuda.synchronize()
    busy = k4 = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            busy += us
            k4 += us if K4_NAME.search(ev.key) else 0.0
    steps = out.shape[1] - 1
    if not torch.isfinite(out.float()).all() or out.shape[0] != src.shape[0]:
        fail(f"phase 6t: bad decode output {tuple(out.shape)}")
    return {"ms_per_step": wall * 1e3 / steps, "steps": steps,
            "tokens_per_sec": out.shape[0] * steps / wall,
            "counts": counts, "q1": spy.count, "dense": dense[0],
            "k4_ms": k4 / 1e3,
            "busy_ms": busy / 1e3, "k4_share": k4 / max(busy, 1e-9),
            "idle": 1 - busy / 1e6 / wall}


# ---- phases 4g and 6g: offline generation and the dense serving path -------

G_PROMPT, G_NEW = 16, 16          # 4g: prompt width and new tokens
G_SAMPLING = dict(temperature=0.8, top_k=40, top_p=0.95, seed=1234)
# 6g (a): bench.py's decode axis (bench.py:340-390): B, prompt, new, and
# the short length the step time is differenced against
D_BATCH, D_PROMPT, D_NEW = 8, 64, 192
D_SHORT = min(max(4, D_NEW // 3), D_NEW - 4)
D_MODES = (("bf16", {}), ("w8a16", dict(weight_quant="int8")),
           ("w8a16_kv8", dict(weight_quant="int8", kv_quant="int8")))


def _strip(row):
    """A left-padded row (pad 0; prompts draw ids >= 1) without its pads."""
    return row[int(np.argmax(row != 0)):]


def gen_tie(torch, cfg, params_cpu, a, b, start, kv_dtype, phase):
    """For rows a and b (left pads stripped; `start` the prompt's
    length) that differ: True when at
    their first difference both tokens' float32 CPU logits (one packed
    prefill of a's prefix, the same params and pool dtype) lie within 2 x
    phase 4's limit (2e-3, int8 pools 2e-2) of the top logit — a near
    tie the summation order may break."""
    a, b = _strip(a), _strip(b)
    i = int(np.nonzero(a != b)[0][0]) if a.size == b.size else -1
    if i < start:
        fail(f"phase {phase}: two outputs differ inside the prompt or in "
             f"length")
    lg = w8_prefix_logits(torch, cfg, params_cpu, a[:i], kv_dtype)
    tol = 2 * (2e-2 if kv_dtype else 2e-3)
    top = lg.max().item()
    return all(top - lg[int(o[i])].item() <= tol for o in (a, b))


def gen_compare(torch, cfg, params_cpu, got, want, starts, kv_dtype, what,
                ties):
    """Rows of got == want but for near ties (`gen_tie`), which are
    appended to `ties` as (what, row, first differing token index)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        fail(f"phase 4g {what}: shapes {got.shape} vs {want.shape}")
    for r in range(got.shape[0]):  # starts: each row's prompt length
        if np.array_equal(got[r], want[r]):
            continue
        if not gen_tie(torch, cfg, params_cpu, got[r], want[r], starts[r],
                       kv_dtype, f"4g {what}"):
            fail(f"phase 4g {what}: row {r} differs beyond the near-tie "
                 f"rule")
        ties.append((what, r, int(np.nonzero(got[r] != want[r])[0][0])))


def gen_parity(torch, model32, card):
    """4g: float32 GPT-2 small (phase 4's weights), TF32 off, the card
    against the same weights on the CPU. Returns (near ties, sampled
    draws under MARGIN, K2 launches by pool kind, lines to print)."""
    import tempfile

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import GenerationServer
    from paddle_tpu_torch.models import GPT2, gpt2_decode
    from paddle_tpu_torch.models.gpt2 import export_generator
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.sampling import prng

    cfg = model32.cfg
    V = cfg.vocab_size
    cpu = GPT2(cfg, device="cpu", init=False)
    with torch.no_grad():
        for (_, pc), (_, pg) in zip(cpu.named_parameters(),
                                    model32.named_parameters()):
            pc.data = pg.detach().cpu().clone()
    params_cpu = {None: cpu.flat_params(),
                  "int8": cpu.quantize_weights()}
    rs = np.random.RandomState(41)
    ids = rs.randint(1, V, (4, G_PROMPT)).astype(np.int32)
    lens = [G_PROMPT, 9, 12, 3]
    left = np.zeros_like(ids)
    for r, n in enumerate(lens):
        left[r, G_PROMPT - n:] = ids[r, :n]
    starts = [G_PROMPT] * 4
    ties, lines = [], []

    def gen(m, x, **kw):
        out = m.generate(x, G_NEW, **kw)
        return out.cpu().numpy()

    # (1) dense greedy: card == CPU; the graph == the eager program
    t0 = time.perf_counter()
    got = gen(model32, ids)
    gen_compare(torch, cfg, params_cpu[None], got, gen(cpu, ids), starts,
                None, "dense greedy", ties)
    prog = gpt2_decode.decode_program(cfg, G_NEW)
    sc = {k: torch.tensor(v, dtype=dt, device=DEV) for k, v, dt in (
        ("temp", 0.0, torch.float32), ("eos", -1, torch.int32),
        ("top_p", 1.0, torch.float32), ("pad", -1, torch.int32))}
    eager = prog.run(model32.flat_params(), torch.from_numpy(ids).to(DEV),
                     prng.seed_key(0, DEV), sc["temp"], sc["eos"],
                     sc["top_p"], sc["pad"], False)
    if not np.array_equal(eager.cpu().numpy(), got):
        fail("phase 4g: the dense program's graph differs from its eager "
             "run on the card")
    if prog.graphs.captures < 1:
        fail("phase 4g: the dense generate captured no graph")

    # (2) a left-padded batch of mixed lengths: each row == its prompt
    # generated alone; the batch card == CPU
    batch = gen(model32, left, pad_token_id=0)
    gen_compare(torch, cfg, params_cpu[None], batch,
                gen(cpu, left, pad_token_id=0), lens, None,
                "left-padded", ties)
    alone = np.stack([
        np.concatenate([np.zeros(G_PROMPT - n, np.int32),
                        gen(model32, ids[r:r + 1, :n])[0]])
        for r, n in enumerate(lens)])
    gen_compare(torch, cfg, params_cpu[None], batch, alone, lens, None,
                "left-padded vs alone", ties)

    # (3) sampled: card == CPU but where the CPU's draw has a top-two
    # margin of filt + gumbel under MARGIN (the CPU run records them)
    got = gen(model32, ids, **G_SAMPLING)
    margins, real = [], prng.categorical

    def spy(key, lg):
        g = prng.gumbel(key.reshape(1, 2), lg.numel()).reshape(lg.shape)
        top2 = torch.topk(g + lg, 2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).numpy())
        return real(key, lg)

    prng.categorical = spy
    try:
        want = gen(cpu, ids, **G_SAMPLING)
    finally:
        prng.categorical = real
    near = []
    for r in range(ids.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if diff.size:
            step = int(diff[0]) - G_PROMPT
            if step < 0 or margins[step][r] >= MARGIN:
                fail(f"phase 4g sampled: row {r} differs card vs CPU at "
                     f"step {step}, CPU margin "
                     f"{margins[max(step, 0)][r]:.3g} >= {MARGIN}")
            near.append((r, step, float(margins[step][r])))
    lo = min(float(m.min()) for m in margins)
    lines.append(f"sampled (temperature 0.8, top-k 40, top-p 0.95, seed "
                 f"1234) card == CPU but {len(near)} draws under the margin "
                 f"{MARGIN} {near}; smallest CPU margin {lo:.3g}")

    # (4) the paged generate, dense and int8 pools (K2 on the card, each
    # step a graph replay): greedy == the dense generate of the same kind
    k2 = {}
    for kv in (None, "int8"):
        tag = kv or "dense"
        kernels.reset_launch_counts()
        paged = gen(model32, ids, kv_cache="paged", kv_quant=kv)
        k2[tag] = kernels.launch_counts()[f"paged_decode_{tag}"]
        # a layer a step: the graph's eager warm-up step, then G_NEW - 1
        # replays (the prefill is dense products)
        if k2[tag] != cfg.num_layers * G_NEW:
            fail(f"phase 4g paged {tag}: K2 launched {k2[tag]} times, "
                 f"expected {cfg.num_layers} x {G_NEW}")
        gen_compare(torch, cfg, params_cpu[None], paged,
                    gen(model32, ids, kv_quant=kv), starts, kv,
                    f"paged {tag} vs dense", ties)
        gen_compare(torch, cfg, params_cpu[None], paged,
                    gen(cpu, ids, kv_cache="paged", kv_quant=kv), starts,
                    kv, f"paged {tag} card vs CPU", ties)

    # (5) W8A16 and int8 KV through the dense program, card vs CPU
    for name, kw in (("w8a16", dict(weight_quant="int8")),
                     ("kv8", dict(kv_quant="int8")),
                     ("w8a16 kv8", dict(weight_quant="int8",
                                        kv_quant="int8"))):
        pc = params_cpu["int8" if "weight_quant" in kw else None]
        gen_compare(torch, cfg, pc, gen(model32, left, pad_token_id=0, **kw),
                    gen(cpu, left, pad_token_id=0, **kw), lens,
                    kw.get("kv_quant"), f"dense {name}", ties)

    # (6) export_generator -> jit.load -> served == in-process (W8A16:
    # a quarter of the float32 artifact's bytes)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "gen")
        export_generator(model32, prefix, prompt_len=G_PROMPT,
                         max_new_tokens=G_NEW, weight_quant="int8")
        nbytes = os.path.getsize(prefix + ".pdiparams")
        served = jit.load(prefix)
    if served.device.type != "cuda":
        fail("phase 4g: jit.load did not put the params on the card")
    out = served(left, 0, 0.0, -1, 1.0, 0)
    if out.device.type != "cpu" or not np.array_equal(
            out.numpy(), gen(model32, left, pad_token_id=0,
                             weight_quant="int8")):
        fail("phase 4g: the served artifact differs from the in-process "
             "W8A16 generate")

    # (7) GenerationServer on the loaded artifact: 8 mixed-length
    # requests in one batch, each row == its prompt's generate alone
    prompts = [rs.randint(1, V, (int(n),)).astype(np.int32)
               for n in rs.randint(1, G_PROMPT + 1, 8)]
    srv = GenerationServer(served, pad_token_id=0, max_wait_ms=50)
    futs = [srv.submit(p) for p in prompts]
    srv.start()
    try:
        rows = np.stack([f.result(timeout=300) for f in futs])
    finally:
        srv.stop()
    st = srv.stats()
    alone = []
    for p in prompts:
        row = np.zeros((1, G_PROMPT), np.int32)
        row[0, G_PROMPT - p.size:] = p
        kw = dict(pad_token_id=0) if p.size < G_PROMPT else {}
        alone.append(gen(model32, row, weight_quant="int8", **kw)[0])
    gen_compare(torch, cfg, params_cpu["int8"], rows, np.stack(alone),
                [p.size for p in prompts], None,
                "GenerationServer vs generate", ties)
    lines.append(f"export_generator (W8A16, {nbytes / 2**20:.1f} MiB npz) "
                 f"-> jit.load on the card -> served == generate bitwise; "
                 f"GenerationServer 8 requests (lengths "
                 f"{[p.size for p in prompts]}) in {st['batches']} batch(es) "
                 f"== each prompt's generate; "
                 f"{time.perf_counter() - t0:.1f} s")
    return ties, k2, lines


def gen_profile(torch, fn):
    """One run of fn under torch.profiler: (device busy s, wall s of the
    run, kernels and copies recorded on the device)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy += getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0))
            n += ev.count
    return busy / 1e6, wall, n


def gen_decode_axis(torch, model):
    """6g (a): bench.py's decode axis on bf16 GPT-2 small (phase 4f's
    weights): B 8, prompt 64, 192 new, greedy, in bf16, W8A16 and W8A16
    with int8 KV, each through the dense program's graph and through the
    paged generate. The ms per token step is bench.py's: (T(192) -
    T(64)) / 128, each T the best of two calls after a warm one (which
    captures; None when T(192) <= T(64));
    tokens/s = 8 / that; peak memory over the timed calls; then one
    profiled 64-token call: device busy, idle share (1 - busy / its
    wall), device kernels and copies a token step (the prefill's
    included). Returns ({(mode,
    path): row}, K2 launches by pool kind)."""
    from paddle_tpu_torch.ops import kernels

    V = model.cfg.vocab_size
    ids = np.random.RandomState(0).randint(1, V, (D_BATCH, D_PROMPT)) \
        .astype(np.int32)
    rows, k2 = {}, {"dense": 0, "int8": 0}
    for mode, kw in D_MODES:
        for path in ("dense", "paged"):
            def one(n):
                t0 = time.perf_counter()
                out = model.generate(ids, n, kv_cache=path, **kw)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                if out.shape != (D_BATCH, D_PROMPT + n) or \
                        out[:, D_PROMPT:].min() < 0 or \
                        out[:, D_PROMPT:].max() >= V:
                    fail(f"phase 6g (a) {mode} {path}: bad output")
                return dt

            one(D_NEW)
            one(D_SHORT)
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()                 # main path
            t_full = min(one(D_NEW) for _ in range(2))
            t_short = min(one(D_SHORT) for _ in range(2))
            counts = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            tag = kw.get("kv_quant") or "dense"
            n_k2 = counts[f"paged_decode_{tag}"]
            # a paged call of n tokens: the step graph's eager warm-up,
            # then n - 1 replays, a K2 launch a layer each
            want = 2 * model.cfg.num_layers * (D_NEW + D_SHORT) \
                if path == "paged" else 0
            if n_k2 != want:
                fail(f"phase 6g (a) {mode} {path}: K2 launched {n_k2} "
                     f"times, expected {want}")
            k2[tag] += n_k2
            # bench.py's differencing; a longer call no slower than the
            # short one is timer noise, and the step is not measured
            step_ms = (t_full - t_short) / (D_NEW - D_SHORT) * 1e3 \
                if t_full > t_short else None
            busy, wall, n_dev = gen_profile(
                torch, lambda: model.generate(ids, D_SHORT, kv_cache=path,
                                              **kw))
            rows[(mode, path)] = dict(
                step_ms=step_ms,
                tok_s=None if step_ms is None else D_BATCH / step_ms * 1e3,
                full_ms=t_full * 1e3, short_ms=t_short * 1e3, peak=peak,
                busy_ms=busy * 1e3, wall_ms=wall * 1e3,
                idle=1 - busy / wall if busy > 0 else None,
                per_step=n_dev / D_SHORT)
    return rows, k2


def gen_padded_batcher(torch, model, prompts):
    """6g (b): bench.py's padded-batcher axis (bench.py:585-600):
    GenerationServer over an exported bf16 artifact (jit.load onto the
    card), 8 slots, prompt_len 768, 32 new tokens, phase 5's 16 prompts;
    a warm pass (it captures), then a measured pass. Returns the
    measured pass's stats, the outputs, the graph captures and the loaded
    artifact."""
    import tempfile

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import GenerationServer
    from paddle_tpu_torch.models.gpt2 import export_generator

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "gen16")
        export_generator(model, prefix, prompt_len=768, max_new_tokens=32,
                         batch_size=8)
        served = jit.load(prefix)
    srv = GenerationServer(served, pad_token_id=0,
                           max_wait_ms=5.0).start()
    try:
        for f in [srv.submit(p) for p in prompts]:     # warm pass
            f.result(timeout=600)
        srv.reset_stats()
        outs = [f.result(timeout=600)
                for f in [srv.submit(p) for p in prompts]]
        st = srv.stats()
    finally:
        srv.stop()
    V = model.cfg.vocab_size
    for p, o in zip(prompts, outs):
        if o.shape != (800,) or not (o[768 - p.size:768] == p).all() \
                or o[768:].min() < 0 or o[768:].max() >= V:
            fail(f"phase 6g (b): bad output for a {p.size}-token prompt")
    return st, outs, served._program.graphs.captures, served


# ---- phase 5r: fault-tolerant, observable serving ---------------------------

R_SLOTS, R_BS, R_NEW, R_PROMPT = 4, 16, 16, 128
# the reference test's chaos plan (tests/test_reliability.py:721-723), and
# its counterpart for the unified round (no prefill/decode/verify seams:
# one unified_round seam a dispatch)
R_PLAN_SPLIT = ("prefill:1,decode:0,verify:0,ensure_many:2,"
                "slow_dispatch:0,detokenize:1,stream_consumer:0")
R_PLAN_UNIFIED = ("unified_round:1,ensure_many:3,slow_dispatch:0,"
                  "detokenize:1,stream_consumer:0")
R_KILL_AT = 72     # (c): kill() once this many tokens were streamed
R_FAULT_AT = 8     # (e): the decode dispatch the recovery-time run fails


def r_detok(toks):
    """5r's toy detokenizer (a token -> a letter): prefix-stable, so a stop
    string is matched on the detokenized tail as a real one would be."""
    return "".join(chr(97 + int(t) % 26) for t in toks)


def r_work(V, sink):
    """5r (a)'s work, greedy: four random prompts (RandomState(61); the
    first streams through `sink`, the third carries a stop string that
    never matches, so every token of it goes through the detokenizer) and a
    periodic one that waits for a slot (4 slots): the first decode rounds
    have no n-gram proposal (plain decode dispatches), the periodic prompt
    always proposes (verify dispatches)."""
    from paddle_tpu_torch.sampling import SamplingParams

    rs = np.random.RandomState(61)
    work = [(rs.randint(1, V, n).astype(np.int32), {})
            for n in (48, 33, 57, 40)]
    work[0] = (work[0][0], {"on_token": lambda t, r: sink.append(t)})
    work[2] = (work[2][0], {"sampling": SamplingParams(
        stop_strings=("zqz!",))})
    work.append((np.tile(rs.randint(1, V, 6).astype(np.int32), 8), {}))
    return work


def r_serve(torch, model, work, plan=None, **kw):
    """Serve `work` on a fresh server (every request submitted before
    start(), so admissions are fixed) under `plan`; the launch counts are
    zeroed just before start() and read after the drain. Returns
    (results [("ok", tokens) | (ExceptionName, exc)], stats, health, launch
    counts, the plan)."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.reliability import FaultPlan

    plan = FaultPlan.parse(plan) if isinstance(plan, str) else plan
    kw.setdefault("max_slots", R_SLOTS)
    srv = PagedGenerationServer(model, block_size=R_BS,
                                max_prompt_len=R_PROMPT,
                                max_new_tokens=R_NEW, device=DEV,
                                fault_plan=plan, **kw)
    futs = [srv.submit(ids, **k) for ids, k in work]
    kernels.reset_launch_counts()                              # main path
    srv.start()
    res = []
    try:
        for f in futs:
            try:
                res.append(("ok", f.result(timeout=600)))
            except Exception as e:  # noqa: BLE001 — an outcome to check
                res.append((type(e).__name__, e))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        st, health = srv.stats(), srv.health()
    finally:
        srv.stop()
    return res, st, health, counts, plan


def r_same(torch, cfg, params_cpu, want, got, work, what, ties):
    """Each ok result equals the fault-free run's but for near ties (phase
    4g's rule, `gen_tie`), which are appended to `ties`; returns the
    quarantined indices."""
    quarantined = []
    for r, ((_, a), (kind, b), (ids, _k)) in enumerate(zip(want, got,
                                                          work)):
        if kind != "ok":
            if kind != "QuarantinedRequest":
                fail(f"phase 5r {what}: request {r} failed with {kind}: "
                     f"{b}")
            quarantined.append((r, b.seam))
            continue
        if np.array_equal(a, b):
            continue
        if not gen_tie(torch, cfg, params_cpu, b, a, ids.size, None,
                       f"5r {what}"):
            fail(f"phase 5r {what}: request {r} differs from the "
                 f"fault-free run beyond the near-tie rule")
        ties.append((what, r, int(np.nonzero(a != b)[0][0])))
    return quarantined


def r_check_graphs(st, st0, what):
    """Every decode, verify and window dispatch of a faulted run was one
    replay, and it captured what the fault-free run captured."""
    if st["decode_graph_replays"] != st["decode_steps"] and \
            not st["rounds"]["unified"]:
        fail(f"phase 5r {what}: {st['decode_graph_replays']} replays for "
             f"{st['decode_steps']} decode dispatches")
    if st["verify_graph_replays"] != (
            0 if st["rounds"]["unified"]
            else st["speculation"]["verify_dispatches"]):
        fail(f"phase 5r {what}: {st['verify_graph_replays']} verify "
             f"replays for {st['speculation']['verify_dispatches']} verify "
             f"dispatches")
    if st["rounds"]["unified"] and st["round_graph_replays"] != \
            st["rounds"]["rounds"] - st["prefill_dispatches"]:
        fail(f"phase 5r {what}: {st['round_graph_replays']} window "
             f"replays for {st['rounds']['rounds']} rounds, "
             f"{st['prefill_dispatches']} with chunk rows")
    if st["decode_graph_captures"] != st0["decode_graph_captures"]:
        fail(f"phase 5r {what}: {st['decode_graph_captures']} graph "
             f"captures, the fault-free run {st0['decode_graph_captures']}")


def r_chaos(torch, model32, params_cpu, counts_out, ties):
    """5r (a): the chaos plan over the composed split stack (prefix cache,
    n-gram speculation, a stop-string request, a stream), then the unified
    async round. Returns the lines to print."""
    from paddle_tpu_torch.reliability import FaultPlan

    cfg = model32.cfg
    lines = []
    fired_all = {}
    for name, plan_s, kw in (
            ("split", R_PLAN_SPLIT, {}),
            ("unified+async", R_PLAN_UNIFIED,
             {"unified_round": True, "async_rounds": True})):
        kw = dict(kw, enable_prefix_cache=True, speculation=True,
                  detokenize=r_detok)
        work = r_work(cfg.vocab_size, [])
        # the fault-free run, with an empty plan that counts each seam's
        # occurrences: every planned index must be reachable
        want, st0, _h0, _c0, count = r_serve(torch, model32, work,
                                             FaultPlan([], name="count"),
                                             **kw)
        if any(k != "ok" for k, _ in want):
            fail(f"phase 5r (a) {name}: the fault-free run failed {want}")
        seen = count.stats()["occurrences"]
        plan = FaultPlan.parse(plan_s)
        for part in plan_s.split(","):
            seam, idx = part.split(":")
            if seen.get(seam, 0) <= int(idx):
                fail(f"phase 5r (a) {name}: the fault-free run reaches "
                     f"seam {seam} {seen.get(seam, 0)} times, the plan "
                     f"fires it at occurrence {idx}")
        got, st, health, counts, _p = r_serve(torch, model32,
                                              r_work(cfg.vocab_size, []),
                                              plan, **kw)
        fired = plan.fired()
        for part in plan_s.split(","):
            if fired.get(part.split(":")[0], 0) < 1:
                fail(f"phase 5r (a) {name}: seam {part} never fired "
                     f"({fired})")
        for s, n in fired.items():
            fired_all[s] = fired_all.get(s, 0) + n
        q = r_same(torch, cfg, params_cpu, want, got, work, f"(a) {name}",
                   ties)
        rel = st["reliability"]
        if len(q) > 1:
            fail(f"phase 5r (a) {name}: {len(q)} requests quarantined {q}")
        if health[0] != "ok" or rel["recoveries"] < 1:
            fail(f"phase 5r (a) {name}: health {health[0]}, recoveries "
                 f"{rel['recoveries']}")
        if counts["ragged_stream_dense"] <= 0 \
                or counts["paged_decode_dense"] <= 0 and not kw.get(
                    "unified_round"):
            fail(f"phase 5r (a) {name}: K1/K2 launches {counts}")
        r_check_graphs(st, st0, f"(a) {name}")
        for n in ("ragged_stream_dense", "paged_decode_dense"):
            counts_out[n] = counts_out.get(n, 0) + counts[n]
        lines.append(
            f"(a) f32 {name}, plan {plan_s}: fired {fired}; "
            f"{sum(k == 'ok' for k, _ in got)} of {len(got)} requests == "
            f"the fault-free run, quarantined {q or 'none'}; recoveries "
            f"{rel['recoveries']} retries {rel['dispatch_retries']} "
            f"resumes {rel['resumes']} (warm {rel['warm_resumes']}); "
            f"health {health[0]}; replays decode "
            f"{st['decode_graph_replays']}/{st['decode_steps']} verify "
            f"{st['verify_graph_replays']} window "
            f"{st['round_graph_replays']}, captures "
            f"{st['decode_graph_captures']} (fault-free "
            f"{st0['decode_graph_captures']}); launches K1 "
            f"{counts['ragged_stream_dense']} K2 "
            f"{counts['paged_decode_dense']}")
    return lines, fired_all


def r_persistent(torch, model32, params_cpu, counts_out, ties):
    """5r (b): decode fails three times in a row; exactly one request is
    quarantined, its co-resident finishes with the fault-free tokens. The
    prefix cache is on, so each retry is a warm resume straight into the
    next decode dispatch: a cold resume's successful re-prefill would be a
    clean recovery and reset the streak (ROADMAP §C 19)."""
    cfg = model32.cfg
    rs = np.random.RandomState(63)
    work = [(rs.randint(1, cfg.vocab_size, n).astype(np.int32), {})
            for n in (40, 52)]
    want, _st0, _h, _c, _p = r_serve(torch, model32, work,
                                     enable_prefix_cache=True)
    got, st, health, counts, _p = r_serve(
        torch, model32, work, "decode:0,decode:1,decode:2",
        enable_prefix_cache=True)
    q = r_same(torch, cfg, params_cpu, want, got, work, "(b)", ties)
    if len(q) != 1 or q[0][1] != "decode":
        fail(f"phase 5r (b): quarantined {q}, expected exactly one at "
             f"seam decode")
    if health[0] != "ok":
        fail(f"phase 5r (b): health {health[0]} after the survivor's "
             f"dispatch")
    for n in ("ragged_stream_dense", "paged_decode_dense"):
        counts_out[n] = counts_out.get(n, 0) + counts[n]
    return (f"(b) f32 decode:0,decode:1,decode:2 (prefix cache on): "
            f"request {q[0][0]} quarantined ({got[q[0][0]][1].failures} "
            f"failures), the other == the fault-free run; resumes "
            f"{st['reliability']['resumes']} (warm "
            f"{st['reliability']['warm_resumes']}), recoveries "
            f"{st['reliability']['recoveries']}, health {health[0]}")


def r_journal(torch, model32, params_cpu, counts_out, ties):
    """5r (c): 8 requests served with a journal; kill() from the main
    thread once R_KILL_AT tokens were streamed (the stream waits at that
    token until the server is stopped, so the crash lands there whatever
    the speed); the server is freed, a fresh one recovers the journal.
    Every output equals the uninterrupted run's but for near ties."""
    import gc
    import tempfile
    import threading

    from paddle_tpu_torch.inference import PagedGenerationServer

    cfg = model32.cfg
    rs = np.random.RandomState(64)
    prompts = [rs.randint(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rs.randint(16, 65, 8)]
    kw = dict(max_slots=R_SLOTS, block_size=R_BS, max_prompt_len=R_PROMPT,
              max_new_tokens=R_NEW, enable_prefix_cache=True, device=DEV)
    want, _st, _h, _c, _p = r_serve(torch, model32,
                                    [(p, {}) for p in prompts],
                                    enable_prefix_cache=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "session.jsonl")
        srv = PagedGenerationServer(model32, journal=path, **kw)
        n = [0]
        reached = threading.Event()

        def stream(_tok, _reason):
            n[0] += 1
            if n[0] == R_KILL_AT:
                reached.set()
                deadline = time.monotonic() + 120
                while not srv.liveness()[1]["stopped"] \
                        and time.monotonic() < deadline:
                    time.sleep(0.001)

        futs = [srv.submit(p, on_token=stream) for p in prompts]
        srv.start()
        if not reached.wait(600):
            fail("phase 5r (c): the stream never reached the kill point")
        srv.kill()
        done = [f.done() for f in futs]
        before = [f.result(timeout=1) if d else None
                  for f, d in zip(futs, done)]
        # free the killed server's pool and graphs before the next one
        del srv, futs
        gc.collect()
        torch.cuda.empty_cache()
        srv = PagedGenerationServer(model32, journal=path, **kw)
        from paddle_tpu_torch.ops import kernels

        rec = srv.recover_from_journal()
        kernels.reset_launch_counts()                         # main path
        srv.start()
        try:
            outs = {rid: f.result(timeout=600) for rid, f in rec.items()}
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            st = srv.stats()
        finally:
            srv.stop()
        left = srv._journal.stats()["interrupted"]
    if len(outs) != done.count(False) or left:
        fail(f"phase 5r (c): {len(outs)} requests recovered for "
             f"{done.count(False)} interrupted, {left} left in the journal")
    # the recovered futures in journal (accept) order are the unfinished
    # requests in submit order
    it = iter(outs.values())
    got = [("ok", b if b is not None else next(it)) for b in before]
    r_same(torch, cfg, params_cpu, want, got, [(p, {}) for p in prompts],
           "(c)", ties)
    for k in ("ragged_stream_dense", "paged_decode_dense"):
        counts_out[k] = counts_out.get(k, 0) + counts[k]
    rel, g = st["reliability"], st["goodput"]
    return (f"(c) f32 journal: kill() at streamed token {R_KILL_AT} with "
            f"{done.count(True)} of 8 requests done; a fresh server "
            f"recovered {len(outs)}: resumes {rel['resumes']} (warm "
            f"{rel['warm_resumes']}: the fresh pool holds no prefix), "
            f"re-prefilled tokens {g['replayed_tokens']}; all 8 outputs "
            f"== the uninterrupted run")


def r_ops_serve(torch, model, prompts, telemetry):
    """5r (d)/(e): phase 5's bf16 traffic at k = 1 on phase 5's server, its
    graphs captured by warm_buckets before start(). With `telemetry`:
    metrics and tracing on, the ops endpoint (expose_port=0: the flight
    recorder and the stall watchdog with it), and /healthz, /healthz/live,
    /healthz/ready, /metrics and /statusz read on loopback while the first
    pass runs. A first pass (no capture may land in it), a measured pass
    (launch counts zeroed just before it) and a pass under torch.profiler
    (busy time and idle share, as `serve`). Returns (stats, counts,
    extra, endpoint results)."""
    import urllib.request

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.observability import compile_tracker
    from paddle_tpu_torch.ops import kernels

    if telemetry:
        obs.enable()
    srv = PagedGenerationServer(model, max_slots=8, block_size=16,
                                max_prompt_len=768, max_new_tokens=32,
                                prefill_chunk_tokens=512, device=DEV,
                                expose_port=0 if telemetry else None)
    n_warm = srv.warm_buckets([(False, False)])
    mark = compile_tracker.mark()
    srv.start()
    got = {}
    extra = {"busy": None, "idle": None, "k2_traced": None,
             "warm_graphs": n_warm}

    def one_pass():
        return [f.result(timeout=600)
                for f in [srv.submit(p) for p in prompts]]

    def scrape(stop):
        while not stop.is_set() or not got:
            for path in ("/healthz", "/healthz/live", "/healthz/ready",
                         "/metrics", "/statusz"):
                r = urllib.request.urlopen(srv.exporter.url + path,
                                           timeout=30)
                got[path] = (r.status, r.read().decode())
            stop.wait(0.05)

    try:
        if telemetry:
            import threading

            stop = threading.Event()
            th = threading.Thread(target=scrape, args=(stop,))
            th.start()
            one_pass()
            stop.set()
            th.join(timeout=120)
        else:
            one_pass()
        extra["first_pass_captures"] = compile_tracker.count_since(mark)
        extra["first_pass_in_flight"] = compile_tracker.count_since(
            mark, in_flight=True)
        srv.reset_stats()
        kernels.reset_launch_counts()                          # main path
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        extra["wall"] = time.perf_counter() - t0
        counts = kernels.launch_counts()
        st = srv.stats()
        busy, k2 = traced_busy(torch, one_pass)
        if busy > 0:
            extra.update(busy=busy, idle=1 - busy / extra["wall"],
                         k2_traced=k2)
    finally:
        srv.stop()
        if telemetry:
            obs.disable()
            obs.tracing.TRACER.reset()
    return st, counts, extra, got


R_METRICS = ("serving_requests_total", "serving_ttft_seconds",
             "serving_queue_depth", "serving_tokens_decoded_total",
             "serving_goodput_ratio", "serving_xla_compiles_total",
             "serving_recoveries_total", "serving_health_state",
             "kv_pool_used_blocks", "paddle_tpu_serving_itl_seconds")


def r_recovery_time(torch, model, prompts):
    """5r (e): phase 5's bf16 traffic (one pass) with decode dispatch
    R_FAULT_AT failing; from the flight recorder's timestamps, the seconds
    from the injected fault to the first successful dispatch after it (the
    backoff, the snapshots and the resumes' re-prefill included)."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.observability import FlightRecorder

    rec = FlightRecorder(capacity=1 << 14, enabled=True)
    srv = PagedGenerationServer(model, max_slots=8, block_size=16,
                                max_prompt_len=768, max_new_tokens=32,
                                prefill_chunk_tokens=512, device=DEV,
                                flight_recorder=rec,
                                fault_plan=f"decode:{R_FAULT_AT}").start()
    try:
        for f in [srv.submit(p) for p in prompts]:
            f.result(timeout=600)
        st = srv.stats()
    finally:
        srv.stop()
    evs = rec.events()
    t_f = [e["ts"] for e in evs if e["name"] == "fault_injected"]
    t_r = [e["ts"] for e in evs if e["name"] == "recovered"]
    if len(t_f) != 1 or not t_r or st["reliability"]["recoveries"] != 1:
        fail(f"phase 5r (e): fault events {len(t_f)}, recovered events "
             f"{len(t_r)}, stats {st['reliability']}")
    return t_r[0] - t_f[0], st["reliability"]["resumes"]


def r_dense_metrics(torch, served, prompts):
    """5r (d): one untimed pass of phase 5's prompts through a
    GenerationServer over 6g (b)'s artifact with the metrics registry on;
    returns the dense server's request count, latency observations and
    stop reasons."""
    from paddle_tpu_torch.inference import GenerationServer
    from paddle_tpu_torch.observability import metrics as obs_metrics

    obs_metrics.enable()
    try:
        srv = GenerationServer(served, pad_token_id=0,
                               max_wait_ms=5.0).start()
        try:
            for f in [srv.submit(p) for p in prompts]:
                f.result(timeout=600)
        finally:
            srv.stop()
        snap = obs_metrics.snapshot()
    finally:
        obs_metrics.disable()
        obs_metrics.reset()

    def dense(name, key="value"):
        return {s["labels"].get("reason", "all"): s[key]
                for s in snap[name]["series"]
                if s["labels"]["server"] == "dense"}

    got = {"done": dense("serving_requests_total").get("all", 0),
           "lat": dense("serving_request_latency_seconds",
                        "count").get("all", 0),
           "reasons": dense("serving_stop_reason_total")}
    if got["done"] != len(prompts) or got["lat"] != len(prompts):
        fail(f"phase 5r (d): the dense server's metrics {got} for "
             f"{len(prompts)} requests")
    return got


def reliability_phase(torch, model, prompts, card, artifact):
    """Phase 5r (a)-(e); returns the K1/K2 launches of its main-path runs
    and prints its lines."""
    import gc

    from paddle_tpu_torch.models import GPT2

    t0 = time.perf_counter()
    cfg = model.cfg
    counts = {}
    ties = []
    model32 = GPT2(cfg, seed=0, dtype=torch.float32, device=DEV)
    params_cpu = {k: v.detach().cpu() for k, v in
                  model32.flat_params().items()}
    lines, fired = r_chaos(torch, model32, params_cpu, counts, ties)
    lines.append(r_persistent(torch, model32, params_cpu, counts, ties))
    lines.append(r_journal(torch, model32, params_cpu, counts, ties))
    del model32, params_cpu
    gc.collect()
    torch.cuda.empty_cache()
    for line in lines:
        say(f"phase 5r {line} [{card}]")
    say(f"phase 5r (a)-(c) seams fired: {fired}; near ties (phase 4g's "
        f"rule): {ties or 'none'}; {time.perf_counter() - t0:.1f} s")

    # (d) and (e): bf16, phase 5's traffic, telemetry off and on in turns
    # (off, on, on, off: a call's drift falls on both sides)
    dense_metrics = r_dense_metrics(torch, artifact, prompts)
    runs = []
    for tel in (False, True, True, False):
        st, c, extra, got = r_ops_serve(torch, model, prompts, tel)
        for n in ("ragged_stream_dense", "paged_decode_dense"):
            counts[n] = counts.get(n, 0) + c[n]
        if extra["first_pass_in_flight"] or extra["first_pass_captures"]:
            fail(f"phase 5r (d): {extra['first_pass_captures']} captures "
                 f"({extra['first_pass_in_flight']} in flight) after "
                 f"warm_buckets")
        if st["compiles"]["window_in_flight"]:
            fail(f"phase 5r (d): the measured window holds "
                 f"{st['compiles']} captures")
        if st["decode_graph_replays"] != st["decode_steps"]:
            fail("phase 5r (d): a decode dispatch was not a replay")
        if tel:
            for path in ("/healthz", "/healthz/live", "/healthz/ready",
                         "/metrics", "/statusz"):
                if got.get(path, (0,))[0] != 200:
                    fail(f"phase 5r (d): {path} answered "
                         f"{got.get(path, (None,))[0]}")
            prom = got["/metrics"][1]
            missing = [m for m in R_METRICS if f"# TYPE {m} " not in prom]
            if missing or json.loads(got["/statusz"][1])["server"] \
                    != "paged":
                fail(f"phase 5r (d): /metrics lacks {missing}")
        runs.append((tel, st, extra))
    say(f"phase 5r (d) ops endpoint during bf16 serving passes: /healthz, "
        f"/healthz/live, /healthz/ready, /metrics, /statusz answered 200, "
        f"/metrics holds {', '.join(R_METRICS)}; warm_buckets captured "
        f"{runs[1][2]['warm_graphs']} graph(s) before start(), the first "
        f"pass and the measured window captured none; GenerationServer "
        f"over 6g (b)'s artifact (an untimed pass, registry on): "
        f"serving_requests_total"
        f"{{server=\"dense\"}} {dense_metrics['done']}, latency "
        f"observations {dense_metrics['lat']}, stop reasons "
        f"{dense_metrics['reasons']} [{card}]")
    for tel, st, extra in runs:
        say(f"phase 5r (e) telemetry {'on' if tel else 'off'} (phase 5's "
            f"bf16 traffic, k=1): tokens_per_sec {st['tokens_per_sec']:.1f}"
            f" ttft p50 {st['ttft_p50_ms']:.1f} ms; "
            f"{idle_text(extra, st, 1, cfg.num_layers)} [{card}]")

    def mean(tel, key):
        return statistics.mean(st[key] for t, st, _e in runs if t == tel)

    say(f"phase 5r (e) telemetry on / off (means of the two runs each): "
        f"tokens_per_sec {mean(True, 'tokens_per_sec') / mean(False, 'tokens_per_sec'):.4f}x, "
        f"ttft p50 {mean(True, 'ttft_p50_ms') / max(mean(False, 'ttft_p50_ms'), 1e-9):.4f}x"
        f" [{card}]")
    rec_s, resumes = r_recovery_time(torch, model, prompts)
    say(f"phase 5r (e) recovery: an injected fault at decode dispatch "
        f"{R_FAULT_AT} of phase 5's bf16 traffic to the first successful "
        f"dispatch after it {rec_s * 1e3:.2f} ms ({resumes} requests "
        f"resumed; backoff 20 ms included) [{card}]")
    say(f"phase 5r: {time.perf_counter() - t0:.1f} s")
    return counts


# ---- phase 5f: the serving front door ---------------------------------------

F_SLOTS, F_BS, F_NEW = 2, 16, 32
# (a)'s pool: two batch residents at their worst case (a 96-token prompt,
# 32 new tokens, one round of async overshoot, the copy-on-write spare)
# hold it whole
F_BLOCKS = 2 * (-(-(96 + F_NEW + 1) // F_BS) + 1) + 1
F_DEADLINE_MS = 250.0
F_TENANTS = (("t1", 1.0), ("t4", 4.0))


def f_hold(n):
    """An on_token callback shared by a run's batch requests: at their
    n-th token overall it holds the engine (bounded) until `go` is set,
    so the interactive requests queue behind residents whatever the
    speed of the engine. Returns (callback, reached, go)."""
    import threading

    reached, go = threading.Event(), threading.Event()
    seen = [0]

    def cb(_tok, _reason):
        seen[0] += 1
        if seen[0] == n:
            reached.set()
            go.wait(120)

    return cb, reached, go


def f_stop_string(gen):
    """A 3-letter stop string of 5r's toy detokenizer that first occurs
    in `gen`'s text at a token index of at least 6 (None when there is
    none)."""
    text = r_detok(gen)
    for j in range(6, len(text) - 3):
        if text[j:j + 3] not in text[:j + 2]:
            return text[j:j + 3]
    return None


def f_tenants():
    from paddle_tpu_torch.frontend import TenantConfig

    return [TenantConfig(t, weight=w) for t, w in F_TENANTS]


def f_preempt_run(torch, model32, batch, inter, stops, **kw):
    """5f (a) on a front door (2 slots, F_BLOCKS blocks, prefix cache on):
    the 4 batch requests (tenants t1/t4 alternating) are queued before
    start(); at their second token the engine is held until the 2
    interactive requests (a TTFT deadline of F_DEADLINE_MS) are queued.
    The launch counts are zeroed just before start() and read after the
    drain. Returns (tokens, streamed texts, stats, launch counts)."""
    from paddle_tpu_torch.frontend import FrontDoor
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.sampling import SamplingParams

    fd = FrontDoor(model32, max_slots=F_SLOTS, block_size=F_BS,
                   max_new_tokens=F_NEW, num_blocks=F_BLOCKS,
                   detokenize=r_detok, tenants=f_tenants(), device=DEV,
                   **kw)
    hold, reached, go = f_hold(2)
    handles = [fd.submit(p, lane="batch", tenant=F_TENANTS[i % 2][0],
                         sampling=(SamplingParams(stop_strings=(s,))
                                   if s else None), on_token=hold)
               for i, (p, s) in enumerate(zip(batch, stops))]
    kernels.reset_launch_counts()                              # main path
    fd.start()
    try:
        if not reached.wait(600):
            fail("phase 5f (a): the batch requests never streamed")
        handles += [fd.submit(p, lane="interactive", tenant="t4",
                              deadline_ms=F_DEADLINE_MS) for p in inter]
        go.set()
        outs, texts = [], []
        for h in handles:
            list(h)  # the stream, to its last event
            outs.append(h.result(timeout=600))
            texts.append(h.text())
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        st = fd.stats()
    finally:
        go.set()
        fd.stop()
    return outs, texts, st, counts


def f_plain_run(torch, model32, prompts, stops):
    """The same requests on a plain PagedGenerationServer (no scheduler,
    same pool), all queued before start()."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.sampling import SamplingParams

    srv = PagedGenerationServer(model32, max_slots=F_SLOTS,
                                block_size=F_BS, max_new_tokens=F_NEW,
                                num_blocks=F_BLOCKS, detokenize=r_detok,
                                enable_prefix_cache=True, device=DEV)
    futs = [srv.submit(p, sampling=(SamplingParams(stop_strings=(s,))
                                    if s else None))
            for p, s in zip(prompts, stops)]
    srv.start()
    try:
        return [f.result(timeout=600) for f in futs]
    finally:
        srv.stop()


def f_preemption(torch, model32, params_cpu, counts_out, ties):
    """5f (a): float32, TF32 off, 2 slots, block 16, F_BLOCKS blocks. The
    front door on the split stack, then on unified + async: every
    request's tokens equal the plain server's but for near ties (phase
    4g's rule), preemptions >= 1 with cached tokens > 0, the streamed
    text is the detokenized tokens with the stop string suppressed, K1
    launched (and K2 on the split stack) and every decode dispatch
    (window round) a replay."""
    cfg = model32.cfg
    rs = np.random.RandomState(71)
    batch = [rs.randint(1, cfg.vocab_size, int(n)).astype(np.int32)
             for n in rs.randint(40, 97, 4)]
    inter = [rs.randint(1, cfg.vocab_size, int(n)).astype(np.int32)
             for n in rs.randint(16, 49, 2)]
    prompts = batch + inter
    free = f_plain_run(torch, model32, prompts, [None] * 6)
    stop = f_stop_string(free[0][batch[0].size:])
    if stop is None:
        fail("phase 5f (a): no stop string in request 0's text")
    stops = [stop, None, None, None]
    want = f_plain_run(torch, model32, prompts, stops + [None, None])
    lines = []
    for name, kw in (("split", {}), ("unified+async",
                                     {"async_rounds": True})):
        outs, texts, st, counts = f_preempt_run(torch, model32, batch,
                                                inter, stops, **kw)
        for r, (a, b, p) in enumerate(zip(want, outs, prompts)):
            if np.array_equal(a, b):
                continue
            if not gen_tie(torch, cfg, params_cpu, b, a, p.size, None,
                           f"5f (a) {name}"):
                fail(f"phase 5f (a) {name}: request {r} differs from the "
                     f"plain server beyond the near-tie rule")
            ties.append((name, r, int(np.nonzero(a != b)[0][0])))
        for r, (o, p, text) in enumerate(zip(outs, prompts, texts)):
            full = r_detok(o[p.size:])
            s = stops[r] if r < len(stops) else None
            cut = full[:full.find(s)] if s else full
            if text != cut or (s and s in text):
                fail(f"phase 5f (a) {name}: request {r} streamed "
                     f"{text!r}, its tokens read {full!r} (stop {s!r})")
        fr = st["frontdoor"]
        if fr["preemptions"] < 1 or fr["preempt_cached_tokens"] <= 0:
            fail(f"phase 5f (a) {name}: preemptions {fr['preemptions']}, "
                 f"cached tokens {fr['preempt_cached_tokens']}")
        if st["stop_reasons"]["stop_string"] != 1:
            fail(f"phase 5f (a) {name}: stop reasons {st['stop_reasons']}")
        if counts["ragged_stream_dense"] <= 0 or (
                not kw and counts["paged_decode_dense"] <= 0):
            fail(f"phase 5f (a) {name}: K1/K2 launches {counts}")
        if not kw and st["decode_graph_replays"] != st["decode_steps"]:
            fail(f"phase 5f (a) {name}: {st['decode_graph_replays']} "
                 f"replays for {st['decode_steps']} decode dispatches")
        if kw and st["round_graph_replays"] != \
                st["rounds"]["rounds"] - st["prefill_dispatches"]:
            fail(f"phase 5f (a) {name}: {st['round_graph_replays']} window "
                 f"replays for {st['rounds']['rounds']} rounds, "
                 f"{st['prefill_dispatches']} with chunk rows")
        for k in ("ragged_stream_dense", "paged_decode_dense"):
            counts_out[k] = counts_out.get(k, 0) + counts[k]
        lines.append(
            f"(a) f32 {name}: 4 batch (tenants t1:t4 = 1:4) + 2 "
            f"interactive requests on 2 slots, {F_BLOCKS} blocks: "
            f"preemptions {fr['preemptions']} (cached tokens "
            f"{fr['preempt_cached_tokens']}), resumes {fr['resumes']}; "
            f"tokens == the plain server's; streams == the detokenized "
            f"tokens (stop string {stop!r} suppressed); deadline misses "
            f"{fr['deadline_misses']}; K1 {counts['ragged_stream_dense']} "
            f"K2 {counts['paged_decode_dense']} launches, decode replays "
            f"{st['decode_graph_replays']} of {st['decode_steps']}, window "
            f"replays {st['round_graph_replays']}")
    return lines


def f_prefetch_run(torch, model32, prompts, other, prefetch):
    """5f (b): a one-slot front door over a HostKVTier: prompts[0] served,
    its chain demoted whole, then an interactive occupier held at its
    first token while prompts[1:] (sharing prompts[0]'s prefix) queue;
    with `prefetch` the tick promotes their chains during the occupier's
    rounds. Returns (tokens of prompts[1:], stats)."""
    from paddle_tpu_torch.frontend import FrontDoor
    from paddle_tpu_torch.inference.kv_tier import HostKVTier

    fd = FrontDoor(model32, max_slots=1, block_size=F_BS,
                   max_new_tokens=16, prefill_chunk_tokens=512,
                   kv_tier=HostKVTier(capacity_blocks=256, watermark=0.0),
                   tier_prefetch=2 if prefetch else None, device=DEV)
    fd.start()
    try:
        fd.submit(prompts[0], lane="batch").result(timeout=600)
        if fd.server.cache.demote_cold(1 << 12) <= 0:
            fail("phase 5f (b): nothing demoted")
        hold, reached, go = f_hold(1)
        occ = fd.submit(other, lane="interactive", on_token=hold)
        if not reached.wait(600):
            fail("phase 5f (b): the occupier never streamed")
        hs = [fd.submit(p, lane="batch") for p in prompts[1:]]
        go.set()
        occ.result(timeout=600)
        outs = [h.result(timeout=600) for h in hs]
        st = fd.stats()
    finally:
        fd.stop()
    return outs, st


def f_prefetch(torch, model32):
    """5f (b): shared-prefix prompts (a 256-token prefix, RandomState(72))
    under a front door with tier_prefetch=2: prefetch hits >= 1 and the
    tokens equal the same run with tier_prefetch off."""
    V = model32.cfg.vocab_size
    rs = np.random.RandomState(72)
    shared = rs.randint(1, V, 256).astype(np.int32)
    prompts = [np.concatenate([shared, rs.randint(1, V, int(n))
                               .astype(np.int32)]) for n in (9, 21, 40)]
    other = rs.randint(1, V, 24).astype(np.int32)
    off, _ = f_prefetch_run(torch, model32, prompts, other, False)
    on, st = f_prefetch_run(torch, model32, prompts, other, True)
    for r, (a, b) in enumerate(zip(off, on)):
        if not np.array_equal(a, b):
            fail(f"phase 5f (b): request {r + 1} differs with prefetch on")
    tp = st["tier_prefetch"]
    if tp["hit_blocks"] < 1:
        fail(f"phase 5f (b): prefetch {tp}")
    return (f"(b) f32 kv_tier + tier_prefetch=2 under a front door, "
            f"shared 256-token prefix: issued {tp['issued_blocks']} blocks, "
            f"hits {tp['hit_blocks']}, wasted {tp['wasted_blocks']}, "
            f"overlapped promote {tp['overlap_promote_s'] * 1e3:.2f} ms; "
            f"tokens == tier_prefetch off")


def f_serve(torch, model, prompts, front):
    """5f (c): phase 5's server (8 slots, block 16, chunk 512, 32 new,
    prefix cache on) with or without the front door (tenants t1/t4, SLOs,
    attribution, the ops endpoint). A pass queues prompts[:8] as batch
    (tenants alternating), holds the engine at the first batch token and
    queues prompts[8:] as interactive (deadline F_DEADLINE_MS): a warm
    pass, a measured pass under tracing (launch counts zeroed just before
    it), and a pass under torch.profiler (busy time and idle share).
    Returns (stats, counts, extra)."""
    import urllib.error
    import urllib.request

    from paddle_tpu_torch.frontend import FrontDoor
    from paddle_tpu_torch.inference import (PagedGenerationServer,
                                            RequestMeta)
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.ops import kernels

    kw = dict(max_slots=8, block_size=16, max_prompt_len=768,
              max_new_tokens=32, prefill_chunk_tokens=512,
              enable_prefix_cache=True, device=DEV)
    if front:
        fd = FrontDoor(model, tenants=f_tenants(), slos=True,
                       attribution=True, expose_port=0, **kw)
        srv = fd.server
    else:
        fd, srv = None, PagedGenerationServer(model, **kw)
    batch, inter = prompts[:8], prompts[8:]

    def submit(p, lane, tenant, **k):
        if fd is not None:
            return fd.submit(p, lane=lane, tenant=tenant, **k)
        dl = k.pop("deadline_ms", None)
        k.pop("stream", None)
        return srv.submit(p, meta=RequestMeta(
            lane=lane, tenant=tenant,
            deadline_s=None if dl is None else dl * 1e-3), **k)

    def one_pass():
        hold, reached, go = f_hold(1)
        hs = [submit(p, "batch", F_TENANTS[i % 2][0], on_token=hold)
              for i, p in enumerate(batch)]
        if not reached.wait(600):
            fail("phase 5f (c): the batch requests never streamed")
        hs += [submit(p, "interactive", F_TENANTS[i % 2][0],
                      deadline_ms=F_DEADLINE_MS)
               for i, p in enumerate(inter)]
        go.set()
        return [h.result(timeout=600) for h in hs]

    extra = {"busy": None, "idle": None, "k2_traced": None}
    srv.start()
    try:
        one_pass()                                         # warm pass
        srv.reset_stats()
        tracing.enable()
        tracing.reset()
        kernels.reset_launch_counts()                      # main path
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        extra["wall"] = time.perf_counter() - t0
        counts = kernels.launch_counts()
        tracing.disable()
        extra["events"] = tracing.events()
        st = srv.stats()
        if fd is not None:
            extra["cost"] = fd.cost_report()
            got = {}
            for path in ("/slo", "/capacity"):
                try:
                    r = urllib.request.urlopen(fd.ops_url + path,
                                               timeout=30)
                    got[path] = (r.status, json.loads(r.read()))
                except urllib.error.HTTPError as e:
                    got[path] = (e.code, json.loads(e.read()))
            extra["endpoints"] = got
            import tempfile

            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "timeline.json")
                extra["timeline_n"] = fd.export_timeline(path)
                with open(path) as f:
                    extra["timeline"] = json.load(f)["traceEvents"]
        busy, k2 = traced_busy(torch, one_pass)
        if busy > 0:
            extra.update(busy=busy, idle=1 - busy / extra["wall"],
                         k2_traced=k2)
    finally:
        tracing.disable()
        tracing.TRACER.reset()
        srv.stop()
    return st, counts, extra


def f_check_observability(st, extra):
    """5f (c)'s front-door checks: /slo and /capacity answer 200 (the
    snapshot's schema_version 1), the cost report's tenants' device-ns
    sum to its busy-ns exactly, the timeline holds dispatch-track
    events, every request's causal trace tiles its wall clock, and each
    preempted request's per-engine trace shows its requeue."""
    from paddle_tpu_torch.observability import (assemble_causal_traces,
                                                check_tiling)
    from paddle_tpu_torch.observability.tracing import \
        assemble_request_traces

    got = extra["endpoints"]
    if got["/slo"][0] != 200 or got["/capacity"][0] != 200 or \
            got["/capacity"][1].get("schema_version") != 1:
        fail(f"phase 5f (c): /slo {got['/slo'][0]}, /capacity "
             f"{got['/capacity'][0]} {got['/capacity'][1].get('schema_version')}")
    cost = extra["cost"]
    dev_ns = sum(a["device_ns"] for a in cost.tenants.values())
    if dev_ns != cost.totals["busy_ns"] or dev_ns <= 0:
        fail(f"phase 5f (c): tenants' device-ns {dev_ns} vs busy-ns "
             f"{cost.totals['busy_ns']}")
    tl = extra["timeline"]
    tracks = {(e["pid"], e["tid"]): e["args"]["name"] for e in tl
              if e.get("ph") == "M" and e["name"] == "thread_name"}
    n_dispatch = sum(1 for e in tl if e.get("ph") in ("X", "i")
                     and tracks.get((e["pid"], e["tid"])) == "dispatch")
    if n_dispatch == 0:
        fail("phase 5f (c): the timeline has no dispatch-track event")
    evs = extra["events"]
    causal = assemble_causal_traces(evs)
    if len(causal) != 16:
        fail(f"phase 5f (c): {len(causal)} causal traces for 16 requests")
    worst = 0.0
    for rec in causal.values():
        if not rec["complete"]:
            fail(f"phase 5f (c): trace of {rec['request_id']} incomplete")
        worst = max(worst, check_tiling(rec))
    if worst > 0.05:
        fail(f"phase 5f (c): a causal trace tiles its wall clock within "
             f"{worst:.4f} ms only")
    per = assemble_request_traces(evs)
    pre = [r for r in per.values() if r.get("preemptions")]
    if sum(r["preemptions"] for r in pre) != st["frontdoor"]["preemptions"]:
        fail(f"phase 5f (c): the traces show "
             f"{sum(r['preemptions'] for r in pre)} preemptions, the stats "
             f"{st['frontdoor']['preemptions']}")
    if any(not r.get("requeue_ms") or r["requeue_ms"] <= 0 for r in pre):
        fail("phase 5f (c): a preempted request's trace has no requeue")
    return dev_ns, n_dispatch, worst, len(pre)


def frontdoor_phase(torch, model, prompts, card):
    """Phase 5f (a)-(c); returns the K1/K2 launches of its main-path runs
    and prints its lines."""
    import gc

    from paddle_tpu_torch.models import GPT2

    t0 = time.perf_counter()
    cfg = model.cfg
    counts = {}
    ties = []
    model32 = GPT2(cfg, seed=0, dtype=torch.float32, device=DEV)
    params_cpu = {k: v.detach().cpu() for k, v in
                  model32.flat_params().items()}
    lines = f_preemption(torch, model32, params_cpu, counts, ties)
    lines.append(f_prefetch(torch, model32))
    del model32, params_cpu
    gc.collect()
    torch.cuda.empty_cache()
    for line in lines:
        say(f"phase 5f {line} [{card}]")
    say(f"phase 5f (a) near ties (phase 4g's rule): {ties or 'none'}")

    runs = {}
    for front in (False, True):
        st, c, extra = f_serve(torch, model, prompts, front)
        for n in ("ragged_stream_dense", "paged_decode_dense"):
            counts[n] = counts.get(n, 0) + c[n]
        if c["ragged_stream_dense"] <= 0 or c["paged_decode_dense"] <= 0:
            fail(f"phase 5f (c): K1/K2 launches {c}")
        if st["decode_graph_replays"] != st["decode_steps"]:
            fail("phase 5f (c): a decode dispatch was not a replay")
        runs[front] = (st, extra)
    st, extra = runs[True]
    dev_ns, n_dispatch, worst, n_pre = f_check_observability(st, extra)
    for front in (False, True):
        st, extra = runs[front]
        fr = st["frontdoor"]
        lanes = " ".join(
            f"{lane} ttft p50/p99 {v['ttft']['p50_ms']:.1f}/"
            f"{v['ttft']['p99_ms']:.1f} ms"
            for lane, v in sorted(fr["lanes"].items()))
        say(f"phase 5f (c) bf16 {'front door' if front else 'plain server'}"
            f" (phase 5's 16 prompts, k=1, 8 batch then 8 interactive, "
            f"deadline {F_DEADLINE_MS:.0f} ms, prefix cache on): "
            f"tokens_per_sec {st['tokens_per_sec']:.1f}; {lanes}; "
            f"preemptions {fr['preemptions']} deadline misses "
            f"{fr['deadline_misses']} of {fr['deadline_requests']}; "
            f"{idle_text(extra, st, 1, cfg.num_layers)} [{card}]")
    s0, s1 = runs[False][0], runs[True][0]
    say(f"phase 5f (c) front door / plain: tokens_per_sec "
        f"{s1['tokens_per_sec'] / max(s0['tokens_per_sec'], 1e-9):.4f}x; "
        f"/slo and /capacity answered 200 (capacity schema_version 1); "
        f"cost report: tenants' device-ns {dev_ns} == busy-ns; timeline "
        f"{extra['timeline_n']} events, {n_dispatch} on the dispatch "
        f"track; 16 causal traces tile their wall clock (worst "
        f"{worst:.4f} ms), {n_pre} preempted requests show their requeue "
        f"[{card}]")
    say(f"phase 5f: {time.perf_counter() - t0:.1f} s")
    return counts


# ---- phase 5d: sharded serving over torch.distributed -----------------------

# the ranks share the card over gloo (NCCL refuses two ranks on one device);
# GPT-2 small at full width and depth, phase 5's server shape
D_CFG = {}                      # GPT2Config overrides (none on the card)
D_NEW = 32                      # (a), (c)-(e): new tokens a request
D_FD_NEW = 24                   # (b): the front door's batch request
D_LONG = 960                    # (c): the long prompt's tokens
D_CHUNKS = (128, 256, 480)      # (c): prefill_chunk_tokens (x sp a dispatch)
D_TIMEOUT = 420.0               # a world's hard limit (s)
# (d): int8 wire bytes / the bf16 wire's: a code a byte plus one float32
# scale a chunk of E / tp lanes against two bytes a lane, 0.505 at E 768
D_WIRE_RATIO = 0.55
D_SERVER = dict(max_slots=8, block_size=16, max_prompt_len=768,
                max_new_tokens=D_NEW, prefill_chunk_tokens=512)


def _d_cfg(GPT2Config):
    return GPT2Config(**D_CFG)


def _d_prompts(vocab):
    """Phase 5's pinned prompts (16, 64-768 tokens)."""
    rng = np.random.RandomState(7)
    return [rng.randint(1, vocab, (int(rng.randint(64, 769)),))
            .astype(np.int32) for _ in range(16)]


def _d_sampling():
    from paddle_tpu_torch.sampling import SamplingParams

    return [SamplingParams(**SERVE_ROWS[i % len(SERVE_ROWS)])
            for i in range(16)]


def _d_prefix_prompts(prompts):
    """(b): four of phase 5's prompts and four that share their
    prefixes, served 4 slots at a time (the first four are published
    before the others are admitted: prefix hits; the last repeats a whole
    prompt, so its one prefilled token writes into a cached block — the
    copy-on-write the pool mirror replays on the other rank)."""
    p = [q[:200] for q in prompts[:4]]
    return p + [np.concatenate([p[0], p[1][:37]]),
                np.concatenate([p[1][:150], p[2][:20]]),
                np.concatenate([p[2], p[3][:9]]), p[3].copy()]


def _d_pair(vocab):
    rs = np.random.RandomState(2)
    return (rs.randint(1, vocab, (40,)).astype(np.int32),
            rs.randint(1, vocab, (17,)).astype(np.int32))


def _d_long(vocab):
    return np.random.RandomState(8).randint(1, vocab, (D_LONG,)) \
        .astype(np.int32)


def _d_serve(torch, model, prompts, sampling, sharding, rank, passes=1,
             profile=False, **kw):
    """`prompts` served by a sharded server (every rank builds it; rank 0
    plans, the others follow). The launch counts are zeroed just before
    the server is built and read when it stopped. Returns rank 0's
    outputs, stats, wall time of the last pass and (profile) its device
    busy time; every rank's digest, dispatches, launches and peak
    memory."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.ops import kernels

    args = dict(D_SERVER)
    args.update(kw)
    if DEV == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    srv = PagedGenerationServer(model, sharding=sharding, device=DEV,
                                **args)
    res = {}
    if rank:
        res.update(srv.serve_follower())
    else:
        sampling = sampling or [None] * len(prompts)

        def one_pass():
            return [f.result(timeout=600) for f in
                    [srv.submit(p, sampling=s)
                     for p, s in zip(prompts, sampling)]]

        srv.start()
        try:
            for _ in range(passes - 1):
                one_pass()
            srv.reset_stats()
            t0 = time.perf_counter()
            res["outs"] = one_pass()
            if DEV == "cuda":
                torch.cuda.synchronize()
            res["wall"] = time.perf_counter() - t0
            res["st"] = srv.stats()
            if profile:
                res["busy"] = traced_busy(torch, one_pass)[0]
        finally:
            srv.stop()
        res.update(digest=srv._dist.digest(),
                   dispatches=srv._dist.dispatches)
    if DEV == "cuda":
        torch.cuda.synchronize()
        res["peak"] = torch.cuda.max_memory_allocated()
    res["counts"] = kernels.launch_counts()
    return res


def _d_preempt(torch, model, sharding, rank):
    """(b): a front door of one slot: a batch request is held at its
    second token until an interactive one queues; it is preempted
    (swapped out through the prefix cache) and resumes."""
    from paddle_tpu_torch.frontend import FrontDoor

    pv, pi = _d_pair(model.cfg.vocab_size)
    fd = FrontDoor(model, max_slots=1, block_size=16, max_prompt_len=64,
                   max_new_tokens=D_FD_NEW, enable_prefix_cache=True,
                   sharding=sharding, device=DEV)
    if rank:
        return fd.server.serve_follower()
    hold, reached, go = f_hold(2)
    hv = fd.submit(pv, lane="batch", max_new_tokens=D_FD_NEW,
                   on_token=hold)
    fd.start()
    try:
        if not reached.wait(600):
            fail("phase 5d (b): the batch request never streamed")
        hi = fd.submit(pi, lane="interactive", max_new_tokens=3)
        go.set()
        out_i = hi.result(timeout=600)
        out_v = hv.result(timeout=600)
        st = fd.stats()
    finally:
        go.set()
        fd.stop()
    return {"v": out_v, "i": out_i, "fd": st["frontdoor"],
            "digest": fd.server._dist.digest()}


def _d_two(torch, dev, rank, out):
    """The 2-rank world: (a), (b), (e), (d) at tp 2."""
    from paddle_tpu_torch.models import GPT2, GPT2Config
    from paddle_tpu_torch.serving_dist import ShardedEngineConfig

    cfg = _d_cfg(GPT2Config)
    tp2 = ShardedEngineConfig(tp=2)
    prompts = _d_prompts(cfg.vocab_size)
    model = GPT2(cfg, seed=0, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    out["a"] = _d_serve(torch, model, prompts, _d_sampling(), tp2, rank)
    out["a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pp = _d_prefix_prompts(prompts)
    out["b_off"] = _d_serve(torch, model, pp, None, tp2, rank,
                            max_slots=4)
    out["b_on"] = _d_serve(torch, model, pp, None, tp2, rank, max_slots=4,
                           enable_prefix_cache=True)
    out["b_fd"] = _d_preempt(torch, model, tp2, rank)
    out["b_s"] = time.perf_counter() - t0
    del model
    model = GPT2(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    out["e"] = _d_serve(torch, model, prompts, None, tp2, rank, passes=2,
                        profile=DEV == "cuda")
    out["e_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["d"] = _d_serve(torch, model, prompts[:8], None,
                        ShardedEngineConfig(tp=2, collective_quant="int8"),
                        rank)
    out["d_s"] = time.perf_counter() - t0


def _d_four(torch, dev, rank, out):
    """The 4-rank world: (c) tp 2 x sp 2, allgather and ring, one long
    prompt over a chunk sweep."""
    from paddle_tpu_torch.models import GPT2, GPT2Config
    from paddle_tpu_torch.serving_dist import ShardedEngineConfig

    cfg = _d_cfg(GPT2Config)
    model = GPT2(cfg, seed=0, dtype=torch.float32, device=dev)
    long = _d_long(cfg.vocab_size)
    t0 = time.perf_counter()
    for mode in ("allgather", "ring"):
        sh = ShardedEngineConfig(tp=2, sp=2, sp_attention=mode)
        for chunk in D_CHUNKS:
            out[(mode, chunk)] = _d_serve(
                torch, model, [long], None, sh, rank, max_slots=1,
                max_prompt_len=D_LONG, prefill_chunk_tokens=chunk)
    out["c_s"] = time.perf_counter() - t0


def _d_rank(rank, nprocs, store, out_dir, dev, job):
    """One rank of a 5d world (gloo: the ranks share the card)."""
    import pickle
    import traceback

    import torch
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(nprocs), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE=str(nprocs))
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        import datetime

        import paddle_tpu_torch.distributed as pdist
        torch.set_num_threads(2)
        if dev == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        pdist.init_parallel_env(
            init_method=f"file://{store}", rank=rank, world_size=nprocs,
            device=dev, timeout=datetime.timedelta(seconds=D_TIMEOUT))
        out = {"backend": torch.distributed.get_backend()}
        (_d_two if job == "two" else _d_four)(torch, dev, rank, out)
        with open(path + ".pkl", "wb") as f:
            pickle.dump(out, f)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:  # noqa: BLE001
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def _d_world(out_dir, dev, job, n):
    """Spawn the n ranks of `job`, wait (hard limit D_TIMEOUT: kill them
    all and fail), return ({rank: results}, seconds)."""
    import multiprocessing as mp
    import pickle
    ctx = mp.get_context("spawn")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_d_rank,
                         args=(r, n, store, out_dir, dev, job))
             for r in range(n)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + D_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)
    errs = [f"rank {r}: " + open(os.path.join(out_dir, f"rank{r}.err"))
            .read()[-3000:] for r in range(n)
            if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))]
    if errs:
        fail(f"phase 5d ({job}): " + "\n".join(errs))
    if alive:
        fail(f"phase 5d ({job}): the world of {n} ranks passed its "
             f"{D_TIMEOUT:.0f} s limit; ranks {alive} killed")
    res = {}
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            res[r] = pickle.load(f)
    return res, time.perf_counter() - t0


def _d_reference(torch, model32):
    """The unsharded port server on the card (graphs on): (a), (b) and
    (c)'s workloads and the preempt pair, float32."""
    from paddle_tpu_torch.inference import PagedGenerationServer

    cfg = model32.cfg
    prompts = _d_prompts(cfg.vocab_size)

    def run(ps, sampling=None, **kw):
        args = dict(D_SERVER)
        args.update(kw)
        srv = PagedGenerationServer(model32, device=DEV, **args).start()
        try:
            sampling = sampling or [None] * len(ps)
            return [f.result(timeout=600) for f in
                    [srv.submit(p, sampling=s)
                     for p, s in zip(ps, sampling)]]
        finally:
            srv.stop()

    pv, pi = _d_pair(cfg.vocab_size)
    return {"a": run(prompts, _d_sampling()),
            "b": run(_d_prefix_prompts(prompts), max_slots=4),
            "v": run([pv], max_slots=1, max_prompt_len=64,
                     max_new_tokens=D_FD_NEW)[0],
            "i": run([pi], max_slots=1, max_prompt_len=64,
                     max_new_tokens=3)[0],
            "c": run([_d_long(cfg.vocab_size)], max_slots=1,
                     max_prompt_len=D_LONG)[0]}


def _d_draw_tie(torch, cfg, params_cpu, a, b, start, sampling):
    """Two sampled outputs that differ: True when at the first difference
    both tokens' draw values (penalties, temperature, filters and the
    request's Gumbel noise over the float32 CPU logits) lie within 4e-3
    of the top draw — a near tie the summation order may break."""
    from paddle_tpu_torch.models.gpt2 import logits
    from paddle_tpu_torch.sampling import prng
    from paddle_tpu_torch.sampling import processors as proc

    i = int(np.nonzero(a != b)[0][0])
    if i < start:
        fail("phase 5d: two outputs differ inside the prompt")
    with torch.no_grad():
        lg = logits(params_cpu, cfg, torch.from_numpy(
            a[:i].astype(np.int64))[None])[0, -1:]
    sp = sampling
    if sp.uses_penalties:
        counts = torch.from_numpy(np.bincount(
            a[:i], minlength=cfg.vocab_size)[None].astype(np.int32))
        lg = proc.apply_penalties(
            lg, counts, torch.tensor([sp.repetition_penalty]),
            torch.tensor([sp.presence_penalty]),
            torch.tensor([sp.frequency_penalty]))
    z = lg
    if sp.temperature > 0:
        z = proc.filter_logits(
            lg / sp.temperature, torch.tensor([sp.top_k]),
            torch.tensor([sp.top_p]), torch.tensor([sp.min_p])) \
            + prng.gumbel(prng.fold_in_keys(
                torch.tensor([sp.seed], dtype=torch.int64),
                torch.tensor([i - start], dtype=torch.int32)), lg.shape[-1])
    z = z[0]
    top = z.max().item()
    return all(top - z[int(o[i])].item() <= 4e-3 for o in (a, b))


def _d_same(torch, cfg, params_cpu, got, want, starts, sampling, what,
            ties):
    """got == want row by row but for near ties (greedy rows: phase 4g's
    `gen_tie`; sampled rows: `_d_draw_tie`), appended to `ties`."""
    for r, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if np.array_equal(g, w):
            continue
        if g.shape != w.shape:
            fail(f"phase 5d {what}: request {r} has {g.size} tokens, the "
                 f"unsharded server's {w.size}")
        sp = sampling[r] if sampling else None
        if sp is None or (sp.temperature <= 0 and not sp.uses_penalties):
            tie = gen_tie(torch, cfg, params_cpu, g, w, starts[r], None,
                          f"5d {what}")
        else:
            tie = _d_draw_tie(torch, cfg, params_cpu, g, w, starts[r], sp)
        if not tie:
            fail(f"phase 5d {what}: request {r} differs from the unsharded "
                 f"server beyond the near-tie rule")
        ties.append((what, r, int(np.nonzero(g != w)[0][0])))


def _d_ranks_line(res, key, n, k1=True):
    """Every rank's digest equals rank 0's; K2 (and K1) launched on every
    rank. Returns 'launches K1/K2 a rank ...'."""
    d0 = res[0][key]["digest"]
    bad = [r for r in range(n) if res[r][key]["digest"] != d0]
    if bad:
        fail(f"phase 5d {key}: ranks {bad} sampled other tokens than rank "
             f"0 (digests differ)")
    parts = []
    for r in range(n):
        c = res[r][key]["counts"]
        n1, n2 = c["ragged_stream_dense"], c["paged_decode_dense"]
        if n2 <= 0 or (k1 and n1 <= 0):
            fail(f"phase 5d {key}: rank {r} launched K1 {n1} and K2 {n2} "
                 f"times")
        parts.append(f"r{r} {n1}/{n2}")
    return "launches K1/K2 a rank " + " ".join(parts)


def sharded_phase(torch, card, unsharded_k1):
    """Phase 5d (module constants D_*): returns the main path's launches
    {kernel: n} summed over the ranks ((a), (b), (c))."""
    import shutil
    import tempfile

    from paddle_tpu_torch.models import GPT2, GPT2Config
    from paddle_tpu_torch.serving_dist import sp_attention_flat_bound

    t_all = time.perf_counter()
    cfg = _d_cfg(GPT2Config)
    hl = cfg.num_heads // 2
    if DEV == "cuda":  # K1 and K2 at the heads a tp-2 rank holds
        timer = Timer(torch)
        errs = []
        for quant in (False, True):
            for case in (decode_case, stream_case):
                r = case(torch, timer, hl, cfg.hidden_size // cfg.num_heads,
                         16, quant, 21, False)
                if not (r["ok"] and r["bitwise"]):
                    fail(f"phase 5d {case.__name__} H {hl} quant {quant}: "
                         f"disagrees with the plain version or differs "
                         f"over two launches (max abs err "
                         f"{r['max_abs_err']:.3g})")
                errs.append(r["max_abs_err"])
        say(f"phase 5d K1/K2 at H {hl} (a tp-2 rank's heads), dense and "
            f"int8, bf16: within 2e-2 of plain (max abs err "
            f"{max(errs):.3g}), bitwise over two launches")
    model32 = GPT2(cfg, seed=0, dtype=torch.float32, device=DEV)
    params_cpu = {k: v.detach().float().cpu()
                  for k, v in model32.flat_params().items()}
    ref = _d_reference(torch, model32)
    del model32
    tmp = tempfile.mkdtemp(prefix="phase5d_")
    counts = {"ragged_stream_dense": 0, "paged_decode_dense": 0}
    try:
        two, wall2 = _d_world(os.path.join(tmp, "two"), DEV, "two", 2)
        four, wall4 = _d_world(os.path.join(tmp, "four"), DEV, "four", 4)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ties = []
    prompts = _d_prompts(cfg.vocab_size)
    sampling = _d_sampling()
    r0 = two[0]
    # (a)
    a = r0["a"]
    _d_same(torch, cfg, params_cpu, a["outs"], ref["a"],
            [p.size for p in prompts], sampling, "(a)", ties)
    st = a["st"]
    if st["sharding"]["graphs"].startswith("on") or \
            st["decode_graph_replays"]:
        fail(f"phase 5d (a): a world of 2 replayed graphs "
             f"({st['sharding']['graphs']})")
    say(f"phase 5d (a) tp 2 float32 GPT-2 small, 16 requests x {D_NEW} "
        f"(greedy, sampled, penalties: 4s's rows): tokens equal the "
        f"unsharded server's on the card "
        f"({sum(1 for t in ties if t[0] == '(a)')} near ties), every rank's "
        f"tokens equal rank 0's (digest over {a['dispatches']} dispatches),"
        f" {_d_ranks_line(two, 'a', 2)}; prefill dispatches "
        f"{st['prefill_dispatches']} decode dispatches {st['decode_steps']} "
        f"(eager: {st['sharding']['graphs']}); {r0['a_s']:.1f} s")
    for r in range(2):
        for n in counts:
            counts[n] += two[r]["a"]["counts"][n]
    # (b)
    pp = _d_prefix_prompts(prompts)
    starts = [p.size for p in pp]
    _d_same(torch, cfg, params_cpu, r0["b_off"]["outs"], ref["b"], starts,
            None, "(b) cache off", ties)
    _d_same(torch, cfg, params_cpu, r0["b_on"]["outs"], r0["b_off"]["outs"],
            starts, None, "(b) cache on", ties)
    pc = r0["b_on"]["st"]["kv_cache"]["prefix_cache"]
    if pc["hits"] < 1 or pc["cow_copies"] < 1:
        fail(f"phase 5d (b): prefix cache hits {pc['hits']} copies "
             f"{pc['cow_copies']} (each >= 1: the mirror untested)")
    fd = r0["b_fd"]
    if fd["fd"]["preemptions"] < 1 or fd["fd"]["resumes"] < 1:
        fail(f"phase 5d (b): front door preemptions "
             f"{fd['fd']['preemptions']} resumes {fd['fd']['resumes']}")
    if two[1]["b_fd"]["digest"] != fd["digest"]:
        fail("phase 5d (b): the follower's tokens differ from rank 0's")
    for r in range(2):
        for key in ("b_off", "b_on"):
            for n in counts:
                counts[n] += two[r][key]["counts"][n]
    pv, pi = _d_pair(cfg.vocab_size)
    _d_same(torch, cfg, params_cpu, [fd["v"], fd["i"]],
            [ref["v"], ref["i"]], [pv.size, pi.size], None,
            "(b) preempt-resume", ties)
    say(f"phase 5d (b) tp 2 prefix cache on == off == unsharded on 8 "
        f"shared-prefix prompts (hits {pc['hits']}, hit tokens "
        f"{pc['hit_tokens']}, copy-on-write {pc['cow_copies']} mirrored), "
        f"{_d_ranks_line(two, 'b_on', 2)}; front door preempt-and-resume "
        f"(preemptions {fd['fd']['preemptions']}, resumes "
        f"{fd['fd']['resumes']}): both requests equal the unsharded "
        f"server's; {r0['b_s']:.1f} s")
    # (c)
    long = _d_long(cfg.vocab_size)
    lines = []
    bound = sp_attention_flat_bound("ring", 2, cfg.num_heads,
                                    cfg.hidden_size // cfg.num_heads)
    for mode in ("allgather", "ring"):
        for chunk in D_CHUNKS:
            rc = four[0][(mode, chunk)]
            _d_same(torch, cfg, params_cpu, rc["outs"], [ref["c"]],
                    [long.size], None, f"(c) {mode} chunk {chunk}", ties)
            peak = rc["st"]["sharding"]["sp_attention_bytes_peak"]
            if mode == "ring" and not 0 < peak <= bound:
                fail(f"phase 5d (c) ring chunk {chunk}: peak fresh-K/V "
                     f"{peak} B against the flat bound {bound} B")
            # ring's prefill attention is the reference's XLA math in
            # torch: K1 runs in allgather mode only
            line = _d_ranks_line(four, (mode, chunk), 4,
                                 k1=mode == "allgather")
            mem = "/".join(f"{four[r][(mode, chunk)].get('peak', 0) / 2**20:.0f}"
                           for r in range(4))
            limit = (f"flat bound {bound} B" if mode == "ring"
                     else "linear in the chunk")
            lines.append(f"{mode} chunk {chunk} x sp 2: peak fresh-K/V "
                         f"{peak} B ({limit}), "
                         f"max_memory_allocated a rank {mem} MiB, "
                         f"prefill dispatches "
                         f"{rc['st']['prefill_dispatches']}, {line}")
            for r in range(4):
                for n in counts:
                    counts[n] += four[r][(mode, chunk)]["counts"][n]
    say(f"phase 5d (c) tp 2 x sp 2 (4 ranks), one {D_LONG}-token prompt x "
        f"{D_NEW} greedy: tokens equal the unsharded server's in every "
        f"case; " + "; ".join(lines) + f"; {four[0]['c_s']:.1f} s")
    # (e) and (d)
    e, d = r0["e"], r0["d"]
    _d_ranks_line(two, "e", 2)
    _d_ranks_line(two, "d", 2)
    model16 = GPT2(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    params16 = {k: v.detach().float().cpu()
                for k, v in model16.flat_params().items()}
    del model16
    cmp_ties = 0
    for p, g, w in zip(prompts[:8], d["outs"], e["outs"][:8]):
        if not np.array_equal(g, w):
            if not near_tie_rule(torch, params16, cfg, g, w, p.size,
                                 phase="5d (d)"):
                fail("phase 5d (d): int8-collective tokens differ from the "
                     "exact collectives' beyond phase 4f's near-tie rule")
            cmp_ties += 1
    c = d["st"]["collectives"]
    if not c["enabled"] or c["mode"] != "int8" or c["bytes_total"] <= 0 \
            or c["bytes_total"] > D_WIRE_RATIO * c["bytes_baseline"]:
        fail(f"phase 5d (d): collectives {c}")
    say(f"phase 5d (d) tp 2 int8 collectives, bf16, 8 of (a)'s prompts "
        f"greedy: tokens equal the exact collectives' but {cmp_ties} near "
        f"ties (phase 4f's rule); wire bytes a rank {c['bytes_total']} vs "
        f"the bf16 wire's {c['bytes_baseline']} "
        f"({c['bytes_total'] / c['bytes_baseline']:.3f}x, limit "
        f"{D_WIRE_RATIO}), by collective {c['by_collective']}; "
        f"{r0['d_s']:.1f} s")
    est = e["st"]
    busy = e.get("busy")
    idle = ("not measured" if not busy else
            f"{1 - busy / e['wall']:.3f} (rank 0's kernels; the other "
            f"rank's share the card)")
    say(f"phase 5d (e) ranks time-sharing one card over gloo: not a "
        f"multi-GPU number. tp 2 bf16 on phase 5's traffic (16 greedy "
        f"requests x {D_NEW}): tokens_per_sec {est['tokens_per_sec']:.1f} "
        f"ttft p50 {est['ttft_p50_ms']:.1f} ms itl p50 "
        f"{est['itl_p50_ms']:.2f} ms, idle share {idle}; the unsharded "
        f"server (phase 5 k=1, graphs) tokens_per_sec "
        f"{unsharded_k1['tokens_per_sec']:.1f} itl p50 "
        f"{unsharded_k1['itl_p50_ms']:.2f} ms [{card}]")
    say(f"phase 5d: worlds {wall2:.1f} s (2 ranks) + {wall4:.1f} s "
        f"(4 ranks), near ties {ties or 'none'}, the phase "
        f"{time.perf_counter() - t_all:.1f} s")
    return counts


# ---- phases 4h and 6h: parallel training over torch.distributed ------------

# GPT-2 small's widths; the hybrid's batch; the pipeline's and MoE's sizes
H_MODEL = dict(vocab=50257, hidden=768, heads=12, layers=12, max_pos=1024)
H_BATCH, H_SEQ, H_MICRO = 8, 1024, 2
H_RING = (2, 12, 1024, 64)     # (a): B, H, S, D
H_PP = (4, 256)                # (e): B, S
H_MOE = (1024, 768, 3072, 4)   # (f): tokens, d_model, d_hidden, experts
H_LR = 1e-4                    # (c): phase 4c's AdamW
H_STEPS = 3                    # 6h: measured steps (after one warm step)
H_RANKS = 16
H_TIMEOUT = 420.0              # the world's hard limit (s)
H_SEED = 2024
H_UPDATE_REL = 1e-2            # (c): a leaf's update against the reference's


def _h_params(torch, dev, mp=2, pp=2):
    from paddle_tpu_torch.models.gpt2_hybrid import init_hybrid_gpt2_params
    m = H_MODEL
    g = torch.Generator(device=dev).manual_seed(H_SEED)
    return init_hybrid_gpt2_params(g, m["vocab"], m["hidden"], m["heads"],
                                   m["layers"], pp, m["max_pos"], mp=mp,
                                   device=dev)


def _h_batch(torch, dev):
    rs = np.random.RandomState(H_SEED)
    return {n: torch.from_numpy(rs.randint(0, H_MODEL["vocab"],
                                           (H_BATCH, H_SEQ))).to(dev)
            for n in ("input_ids", "labels")}


def _h_err(torch, a, ref):
    """max abs error over the reference's max abs (0 for an all-zero
    reference compared exactly)."""
    err = (a.float() - ref.float()).abs().max().item()
    return err / max(ref.float().abs().max().item(), 1e-30)


def _h_update_err(torch, got, want, init):
    """How far a leaf's update misses the reference's: ||(got - init) -
    (want - init)|| / ||want - init||. A leaf left as it was reads 1, a
    leaf half of which was updated about 0.7."""
    moved = (want.double() - init.double()).norm().item()
    return (got.double() - want.double()).norm().item() / max(moved, 1e-30)


def _h_counted(torch, dev, out, name, fn):
    """Run fn with the launch counters zeroed just before and read just
    after: the main path's launches of this rank."""
    from paddle_tpu_torch.ops import kernels
    if dev == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    r = fn()
    if dev == "cuda":
        torch.cuda.synchronize()
    out["counts"][name] = {k: v for k, v in kernels.launch_counts().items()
                           if v}
    return r


def _h_ring(torch, dev, rank, out):
    """(a) ring flash over sp 2 and sp 4, zigzag and Ulysses over sp 4,
    against the single-rank flash_attention on the same inputs."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel.ring_attention import (
        last_impl_used, ring_attention, shard_sequence, zigzag_order,
        zigzag_ring_attention)
    from paddle_tpu_torch.parallel.ulysses import ulysses_attention

    meshes = {2: make_mesh(dp=1, sp=2, ranks=range(2)),
              4: make_mesh(dp=1, sp=4, ranks=range(4))}
    if rank >= 4:
        return
    b, h, s, d = H_RING
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device=dev)
                   for _ in range(4))
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_o = flash_attention(*qkv, causal=True)
    ref = [ref_o.detach()] + list(torch.autograd.grad(ref_o, qkv, do))

    def run(name, mesh, fn, perm=None):
        def shard(t):
            t = t if perm is None else t[:, :, perm]
            return shard_sequence(t, mesh).contiguous()

        loc = [shard(t).requires_grad_(True) for t in (q, k, v)]

        def go():
            o = fn(*loc, mesh)
            return [o.detach()] + list(torch.autograd.grad(o, loc,
                                                           shard(do)))

        got = _h_counted(torch, dev, out, name, go)
        out[name] = {n: _h_err(torch, a, shard(r)) for n, a, r in
                     zip(("out", "dq", "dk", "dv"), got, ref)}

    for n, mesh in meshes.items():
        if mesh.member:
            run(f"ring{n}", mesh, lambda a, b_, c, m: ring_attention(
                a, b_, c, "sp", causal=True, mesh=m))
            out[f"ring{n}"]["impl"] = last_impl_used()
    m4 = meshes[4]
    run("zigzag", m4, lambda a, b_, c, m: zigzag_ring_attention(
        a, b_, c, "sp", mesh=m), perm=torch.as_tensor(
        zigzag_order(4, s), device=dev))
    run("ulysses", m4, lambda a, b_, c, m: ulysses_attention(
        a, b_, c, "sp", causal=True, mesh=m))


def _h_hybrid(torch, dev, rank, out, ref_dir, ckpt_dir):
    """(b) loss and gradients against reference_loss, (d) twice bitwise,
    (g) a sharded checkpoint reloaded into dp 4 x pp 2 x mp 2, (c) two
    AdamW steps with ZeRO-1 slots; 6h the bf16 step."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.models import gpt2_hybrid as H
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel.mesh import local_slice, make_mesh
    from paddle_tpu_torch.parallel.ring_attention import last_impl_used

    V = H_MODEL["vocab"]
    mesh = make_mesh(dp=2, pp=2, mp=2, sp=2)
    mesh_b = make_mesh(dp=4, pp=2, mp=2, sp=1)
    out["transport"] = comm.transport(mesh.group("mp"))
    glob = _h_params(torch, dev)
    specs = H.hybrid_param_specs(glob)
    shapes = {k: tuple(v.shape) for k, v in glob.items()}
    params = {k: v.clone().requires_grad_(True) for k, v in
              H.hybrid_local_params(mesh, glob).items()}
    del glob
    batch = _h_batch(torch, dev)

    def local_batch(m):
        return {n: local_slice(t, ("dp", "sp"), m.coords, m.shape)
                for n, t in batch.items()}

    loss_fn = H.build_hybrid_gpt2_loss(mesh, H_MICRO, vocab_size=V)

    def step(p):
        loss = loss_fn(p, local_batch(mesh))
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        H.reduce_hybrid_gradients(grads, mesh)
        return loss.detach(), grads

    runs = [_h_counted(torch, dev, out, f"hybrid{i}", lambda: step(params))
            for i in range(2)]
    out["impl"] = last_impl_used()
    (l0, g0), (l1, g1) = runs
    out["bitwise"] = [n for n in g0 if not torch.equal(g0[n], g1[n])] + \
        ([] if torch.equal(l0, l1) else ["loss"])
    ref = torch.load(os.path.join(ref_dir, "ref.pt"), mmap=True)
    out["loss"] = l0.item()
    out["loss_rel"] = abs(l0.item() - ref["loss"]) / abs(ref["loss"])
    want = H.hybrid_local_params(mesh, ref["grads"])
    out["grad_rel"] = {n: _h_err(torch, g0[n], want[n].to(dev)) for n in g0}
    del runs, g1, want

    # (g): save, reload into dp 4 x pp 2 x mp 2, the same loss
    keyed = {f"[{k!r}]": s for k, s in specs.items()}
    ckpt.save({k: v.detach() for k, v in params.items()}, ckpt_dir, mesh,
              keyed)
    like = {k: torch.empty(v.shape, device=dev) for k, v in
            H.hybrid_local_params(mesh_b, {k: torch.empty(s, device="meta")
                                           for k, s in shapes.items()})
            .items()}
    loaded = ckpt.load(ckpt_dir, like, mesh_b, keyed)
    with torch.no_grad():
        lb = H.build_hybrid_gpt2_loss(mesh_b, H_MICRO, vocab_size=V)(
            loaded, local_batch(mesh_b))
    out["ckpt_loss_rel"] = abs(lb.item() - l0.item()) / abs(l0.item())
    del loaded, like

    # (c): two AdamW steps with ZeRO-1 slots over dp
    opt = AdamW(H_LR, weight_decay=0.01, device=dev)
    _s, slot_specs = H.hybrid_shardings(
        mesh, params, {"slots": {n: {"moment1": 0, "moment2": 0}
                                 for n in params}})
    state = H.zero_init(opt, params, mesh, slot_specs)
    init = {n: p.detach().clone() for n, p in params.items()}
    losses = [l0.item()]
    for i in range(2):
        if i:
            loss, grads = step(params)
            losses.append(loss.item())
        else:
            grads = g0
        H.zero_update(opt, params, grads, state, mesh, slot_specs)
    trained = torch.load(os.path.join(ref_dir, "trained.pt"), mmap=True)
    out["train_losses"] = losses
    want = H.hybrid_local_params(mesh, trained["params"])
    out["param_diff"] = max((params[n].detach() - want[n].to(dev))
                            .abs().max().item() for n in params)
    out["update_rel"] = {n: _h_update_err(torch, params[n].detach(),
                                          want[n].to(dev), init[n])
                         for n in params}
    # the control: the state before the updates, held the same way
    out["update_rel_unchanged"] = min(
        _h_update_err(torch, init[n], want[n].to(dev), init[n])
        for n in params)
    out["zero_slot"] = tuple(state["slots"]["wpe"]["moment1"].shape)
    del trained, want, init, g0, state

    # 6h: the bf16 step on float32 masters, ZeRO-1 AdamW
    state = H.zero_init(opt, params, mesh, slot_specs)

    def amp_step():
        low = {n: p.to(torch.bfloat16) for n, p in params.items()}
        loss = loss_fn(low, local_batch(mesh)).float()
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        H.reduce_hybrid_gradients(grads, mesh)
        H.zero_update(opt, params, grads, state, mesh, slot_specs)
        return loss.detach()

    amp_step()
    _h_sync(torch, dev)
    comm.reset_staged()
    t0 = time.perf_counter()
    losses = _h_counted(torch, dev, out, "hybrid_bf16",
                        lambda: [amp_step() for _ in range(H_STEPS)])
    _h_sync(torch, dev)
    out["bf16_ms"] = (time.perf_counter() - t0) * 1e3 / H_STEPS
    out["bf16_staged_s"] = comm.STAGED["seconds"] / H_STEPS
    out["bf16_losses"] = [x.item() for x in losses]
    out["bf16_busy"] = _h_busy(torch, dev, amp_step)


def _h_sync(torch, dev):
    import torch.distributed as dist
    if dev == "cuda":
        torch.cuda.synchronize()
    dist.barrier()


def _h_busy(torch, dev, fn):
    """This rank's device busy share over one step: the profiler's CUDA
    kernel time over the step's wall time (None off the card or when the
    profiler records no device time)."""
    if dev != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    _h_sync(torch, dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    us = sum(getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
             for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e6 / wall if us > 0 else None


def _h_pipeline(torch, dev, rank, out):
    """(e) the pipelined GPT-2 small over pp 2 (ranks 0-1), GPipe and
    interleaved (V 2), against lm_loss on one rank."""
    from paddle_tpu_torch.models.gpt2 import GPT2Config, lm_loss
    from paddle_tpu_torch.models.gpt2_pipeline import (
        _merge_block_params, _split_block_params, build_pp_train_step,
        pp_stage_params)
    from paddle_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=1, pp=2, ranks=range(2))
    if not mesh.member:
        return
    cfg = GPT2Config(dropout=0.0)
    b, s = H_PP
    rs = np.random.RandomState(5)
    batch = {n: torch.from_numpy(rs.randint(0, cfg.vocab_size, (b, s)))
             .to(dev) for n in ("input_ids", "labels")}
    for sched, nv in (("gpipe", 1), ("interleaved", 2)):
        loss_pp, init = build_pp_train_step(cfg, mesh, 2, schedule=sched,
                                            num_virtual=nv, device=dev)
        stacked, other = init()
        flat = {n: p.clone().requires_grad_(True) for n, p in
                _merge_block_params(stacked, other).items()}
        ref = lm_loss(flat, cfg, batch["input_ids"], batch["labels"])
        ref_g = dict(zip(flat, torch.autograd.grad(ref, list(flat.values()))))
        rs_, ro = _split_block_params(ref_g)
        want = pp_stage_params(cfg, rs_, mesh, sched, nv)
        st = {k: v.clone().requires_grad_(True) for k, v in
              pp_stage_params(cfg, stacked, mesh, sched, nv).items()}
        ot = {k: v.clone().requires_grad_(True) for k, v in other.items()}

        def go():
            loss = loss_pp(st, ot, batch)
            return loss.detach(), torch.autograd.grad(
                loss, list(st.values()) + list(ot.values()))

        loss, grads = _h_counted(torch, dev, out, f"pp_{sched}", go)
        names = list(st) + list(ot)
        wants = [want[k] for k in st] + [ro[k] for k in ot]
        out[f"pp_{sched}"] = {
            "loss_rel": abs(loss.item() - ref.item()) / abs(ref.item()),
            "grad_rel": max(_h_err(torch, a, w) for a, w in
                            zip(grads, wants)),
            "worst": names[int(np.argmax([_h_err(torch, a, w) for a, w in
                                          zip(grads, wants)]))]}


def _h_moe(torch, dev, rank, out):
    """(f) MoE over ep 4 (ranks 0-3) against the same experts whole on
    one rank, forward and gradients."""
    from paddle_tpu_torch.parallel.mesh import Mesh
    from paddle_tpu_torch.parallel.moe import (init_moe_params,
                                               moe_layer_apply,
                                               moe_local_params)

    mesh = Mesh({"ep": 4}, range(4))
    if not mesh.member:
        return
    t, d, hdn, e = H_MOE
    g = torch.Generator(device=dev).manual_seed(11)
    glob = init_moe_params(g, d, hdn, e, device=dev)
    x = torch.randn(t, d, generator=g, device=dev)

    def value_and_grads(p, m):
        p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        o, aux = moe_layer_apply(p, x, mesh=m)
        loss = (o ** 2).mean() + 0.01 * aux
        return o.detach(), dict(zip(p, torch.autograd.grad(
            loss, list(p.values()))))

    ref_o, ref_g = value_and_grads(glob, None)
    o, grads = value_and_grads(moe_local_params(mesh, glob), mesh)
    want = moe_local_params(mesh, ref_g)
    out["moe"] = {"out": _h_err(torch, o, ref_o),
                  "grad": max(_h_err(torch, grads[k], want[k])
                              for k in grads)}


def _h_rank(rank, nprocs, store, out_dir, dev, ref_dir):
    """One rank of the 4h/6h world: joins over gloo (init_parallel_env
    resolves it: the ranks share one card), runs (a)-(g) and 6h, writes
    its results for the parent."""
    import pickle
    import traceback

    import torch
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(nprocs), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE=str(nprocs))
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        import datetime

        import paddle_tpu_torch.distributed as pdist
        torch.set_num_threads(1)
        if dev == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        pdist.init_parallel_env(
            init_method=f"file://{store}", rank=rank, world_size=nprocs,
            device=dev, timeout=datetime.timedelta(seconds=H_TIMEOUT))
        out = {"counts": {}, "backend": torch.distributed.get_backend()}
        _h_ring(torch, dev, rank, out)
        _h_pipeline(torch, dev, rank, out)
        _h_moe(torch, dev, rank, out)
        _h_hybrid(torch, dev, rank, out, ref_dir,
                  os.path.join(out_dir, "ckpt"))
        with open(path + ".pkl", "wb") as f:
            pickle.dump(out, f)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:  # noqa: BLE001
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def _h_world(out_dir, dev, ref_dir):
    """Spawn the ranks, wait (hard limit H_TIMEOUT: kill them all and
    fail), return {rank: results}."""
    import multiprocessing as mp
    import pickle
    ctx = mp.get_context("spawn")
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_h_rank, args=(r, H_RANKS, store, out_dir,
                                               dev, ref_dir))
             for r in range(H_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + H_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)
    errs = [f"rank {r}: " + open(os.path.join(out_dir, f"rank{r}.err"))
            .read()[-3000:] for r in range(H_RANKS)
            if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))]
    if errs:
        fail("phase 4h: " + "\n".join(errs[:3]))
    if alive:
        fail(f"phase 4h: the world of {H_RANKS} ranks passed its "
             f"{H_TIMEOUT:.0f} s limit; ranks {alive} killed")
    res = {}
    for r in range(H_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            res[r] = pickle.load(f)
    return res, time.perf_counter() - t0


def _h_reference(torch, dev, ref_dir):
    """On this process's card: reference_loss and its gradients, the
    world of one against them, and two AdamW steps (their losses and
    parameters saved for the ranks). Returns the world of one's (loss
    diff, worst gradient diff) and the two steps' losses (the first is
    reference_loss's)."""
    from paddle_tpu_torch.models import gpt2_hybrid as H
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.mesh import make_mesh

    V = H_MODEL["vocab"]
    params = {k: v.requires_grad_(True) for k, v in
              _h_params(torch, dev).items()}
    batch = _h_batch(torch, dev)
    loss = H.reference_loss(params, batch, V)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    ref_loss = loss.item()
    torch.save({"loss": ref_loss,
                "grads": {k: v.cpu() for k, v in grads.items()}},
               os.path.join(ref_dir, "ref.pt"))
    # (d) the world of one: the hybrid code with every axis of size 1
    # (one stage: the stacked leaves [2, L/2, ...] viewed as [1, L, ...])
    one = {k: (v.reshape((1, -1) + tuple(v.shape[2:]))
               if k.startswith("blk.") else v) for k, v in params.items()}
    l1 = H.build_hybrid_gpt2_loss(make_mesh(1, 1, 1, 1), H_MICRO,
                                  vocab_size=V)(one, batch)
    g1 = torch.autograd.grad(l1, list(params.values()))
    one = (abs(l1.item() - loss.item()),
           max((a - b).abs().max().item() for a, b in
               zip(g1, grads.values())))
    del l1, g1
    opt = AdamW(H_LR, weight_decay=0.01, device=dev)
    state = opt.functional_init(params)
    losses = [ref_loss]
    for i in range(2):
        if i:
            loss = H.reference_loss(params, batch, V)
            losses.append(loss.item())
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
        opt.functional_update(params, grads, state)
    torch.save({"params": {k: v.detach().cpu() for k, v in params.items()},
                "losses": losses}, os.path.join(ref_dir, "trained.pt"))
    return one, losses


def _h_one_bf16(torch, dev):
    """6h: the world of one's bf16 step (float32 masters, AdamW) at the
    hybrid's batch: (ms a step, losses)."""
    from paddle_tpu_torch.models import gpt2_hybrid as H
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.mesh import make_mesh

    masters = {k: v.requires_grad_(True) for k, v in
               _h_params(torch, dev, mp=1, pp=1).items()}
    batch = _h_batch(torch, dev)
    loss_fn = H.build_hybrid_gpt2_loss(make_mesh(1, 1, 1, 1), H_MICRO,
                                       vocab_size=H_MODEL["vocab"])
    opt = AdamW(H_LR, weight_decay=0.01, device=dev)
    state = opt.functional_init(masters)

    def step():
        low = {n: p.to(torch.bfloat16) for n, p in masters.items()}
        loss = loss_fn(low, batch).float()
        grads = torch.autograd.grad(loss, list(masters.values()))
        opt.functional_update(masters, dict(zip(masters, grads)), state)
        return loss.detach()

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(H_STEPS)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / H_STEPS, \
        [x.item() for x in losses]


H_KERNELS = ("flash_fwd", "flash_delta", "flash_bwd_dq", "flash_bwd_dkv")


def hybrid_phase(torch, card, phase6_ms):
    """Phases 4h and 6h (module constants H_*): returns the main path's
    launches {kernel: n} summed over the ranks."""
    import tempfile

    t_all = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase4h_")
    try:
        (one_loss, one_grad), ref_losses = _h_reference(torch, DEV, tmp)
        ref_loss = ref_losses[0]
        torch.cuda.empty_cache()
        if one_loss > 1e-6 * abs(ref_loss) or one_grad > 1e-6:
            fail(f"phase 4h (d) world of one vs reference_loss: loss diff "
                 f"{one_loss:.3g}, worst gradient diff {one_grad:.3g}")
        say(f"phase 4h (d) world of one vs reference_loss (f32 B{H_BATCH} "
            f"S{H_SEQ}): loss diff {one_loss:.3g}, largest gradient diff "
            f"{one_grad:.3g} (limit 1e-6; at every axis 1 the hybrid code runs "
        f"reference_loss's attention, layer norm and log_softmax, so this "
        f"holds the plumbing only: the vocab-parallel CE and the ring are "
        f"held by (b))")
        res, wall = _h_world(tmp, DEV, tmp)
        checks_hybrid(res, ref_loss, ref_losses)
        counts = {}
        for r, o in res.items():
            for name, c in o["counts"].items():
                for k, v in c.items():
                    counts[k] = counts.get(k, 0) + v
        b0 = res[0]
        one_ms, one_losses = _h_one_bf16(torch, DEV)
        busy = [res[r]["bf16_busy"] for r in range(H_RANKS)]
        busy_txt = ("not measured" if any(x is None for x in busy) else
                    f"{min(busy):.3f}-{max(busy):.3f} (sum {sum(busy):.3f})")
        say(f"phase 6h bf16/f32-master hybrid step dp2 x pp2 x mp2 x sp2, "
            f"B{H_BATCH} S{H_SEQ}, ZeRO-1 AdamW: ms_per_step "
            f"{b0['bf16_ms']:.1f}, device busy share per rank {busy_txt}, "
            f"host-staged collectives {b0['bf16_staged_s']:.3f} s a step "
            f"(rank 0; max {max(res[r]['bf16_staged_s'] for r in res):.3f})"
            f", losses {' '.join(f'{x:.4f}' for x in b0['bf16_losses'])} — "
            f"16 ranks time-sharing one card over gloo: not a multi-GPU "
            f"number [{card}]")
        say(f"phase 6h world of one (the same code, every axis 1) bf16 B"
            f"{H_BATCH} S{H_SEQ}: ms_per_step {one_ms:.1f}, losses "
            f"{' '.join(f'{x:.4f}' for x in one_losses)}; phase 6's GPT-2 "
            f"step (B16 S1024) {phase6_ms:.2f} ms [{card}]")
        say(f"phase 4h/6h: world of {H_RANKS} {wall:.1f} s, both phases "
            f"{time.perf_counter() - t_all:.1f} s")
        return counts
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def checks_hybrid(res, ref_loss, ref_losses):
    """Phase 4h's checks on the ranks' results; prints its lines."""
    r0 = res[0]
    say(f"phase 4h transport: backend {r0['backend']} (ranks share one "
        f"card), {r0['transport']}")
    for name in ("ring2", "ring4", "zigzag", "ulysses"):
        ranks = [r for r in res if name in res[r]]
        worst = {k: max(res[r][name][k] for r in ranks)
                 for k in ("out", "dq", "dk", "dv")}
        if any(v > 1e-4 for v in worst.values()):
            fail(f"phase 4h (a) {name}: errors {worst} (limit 1e-4, phase "
                 f"3b's float32 tolerance)")
        need = {"zigzag": (), "ulysses": ("flash_fwd", "flash_delta",
                                          "flash_bwd")}.get(name, H_KERNELS)
        for r in ranks:
            c = res[r]["counts"][name]
            if any(c.get(k, 0) <= 0 for k in need):
                fail(f"phase 4h (a) {name} rank {r}: launches {c}")
            if name.startswith("ring") and res[r][name]["impl"] != "flash":
                fail(f"phase 4h (a) {name}: impl {res[r][name]['impl']}")
        say(f"phase 4h (a) {name} f32 B{H_RING[0]} H{H_RING[1]} "
            f"S{H_RING[2]} D{H_RING[3]} causal over {len(ranks)} ranks vs "
            f"flash_attention on one: max error of its magnitude "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
            + f" (limit 1e-4); launches by rank "
            + "; ".join(f"{r}: {res[r]['counts'][name]}" for r in ranks))
    for r, o in res.items():
        if o["impl"] != "flash":
            fail(f"phase 4h (b) rank {r}: last_impl_used {o['impl']}")
        for name in ("hybrid0", "hybrid1"):
            if any(o["counts"][name].get(k, 0) <= 0 for k in H_KERNELS):
                fail(f"phase 4h (b) rank {r}: launches {o['counts'][name]}")
    loss_rel = max(o["loss_rel"] for o in res.values())
    grad = max((v, n, r) for r, o in res.items()
               for n, v in o["grad_rel"].items())
    if loss_rel > 1e-4 or grad[0] > 1e-3:
        fail(f"phase 4h (b): loss rel diff {loss_rel:.3g} (limit 1e-4), "
             f"worst gradient {grad[1]} on rank {grad[2]} {grad[0]:.3g} of "
             f"its magnitude (limit 1e-3)")
    say(f"phase 4h (b) hybrid GPT-2 small dp2 x pp2 x mp2 x sp2 ({H_RANKS} "
        f"ranks) f32 B{H_BATCH} S{H_SEQ}, {H_MICRO} microbatches, vocab "
        f"{H_MODEL['vocab']} padded to {-(-H_MODEL['vocab'] // 2) * 2}: loss {r0['loss']:.6f} vs "
        f"reference_loss {ref_loss:.6f}, rel diff {loss_rel:.3g} (limit "
        f"1e-4), worst gradient {grad[1]} {grad[0]:.3g} of its magnitude "
        f"(limit 1e-3); last_impl_used flash on every rank; launches on rank "
        f"0 {r0['counts']['hybrid0']}")
    upd = max((v, n, r) for r, o in res.items()
              for n, v in o["update_rel"].items())
    ctl = min(o["update_rel_unchanged"] for o in res.values())
    tl = max(abs(a - b) / abs(b) for o in res.values()
             for a, b in zip(o["train_losses"], ref_losses))
    diff = max(o["param_diff"] for o in res.values())
    limit = 2 * H_LR * 2 + 1e-6
    if upd[0] > H_UPDATE_REL or tl > 1e-4 or diff > limit or \
            len(r0["train_losses"]) != len(ref_losses):
        fail(f"phase 4h (c): worst leaf update error {upd[1]} on rank "
             f"{upd[2]} {upd[0]:.3g} (limit {H_UPDATE_REL:g}), step losses "
             f"rel diff {tl:.3g} (limit 1e-4), parameter diff {diff:.3g} "
             f"(limit {limit:.3g})")
    if ctl < 0.99:
        fail(f"phase 4h (c): the unchanged-state control reads {ctl:.3g}, "
             f"not 1")
    say(f"phase 4h (c) two AdamW steps (lr {H_LR}, wd 0.01) with ZeRO-1 "
        f"slots (wpe's moments {r0['zero_slot']} a rank) vs single-rank "
        f"AdamW: worst leaf update error ||p - p_ref|| / ||p_ref - p0|| "
        f"{upd[0]:.3g} ({upd[1]}, rank {upd[2]}; limit {H_UPDATE_REL:g}; "
        f"the state before the updates reads {ctl:.3g}), the two steps' "
        f"losses {' '.join(f'{x:.6f}' for x in r0['train_losses'])} vs "
        f"{' '.join(f'{x:.6f}' for x in ref_losses)}, rel diff {tl:.3g} "
        f"(limit 1e-4); worst parameter diff {diff:.3g} (limit {limit:.3g})")
    bad = {r: o["bitwise"] for r, o in res.items() if o["bitwise"]}
    if bad:
        fail(f"phase 4h (d) two runs of the {H_RANKS}-rank step differ: "
             f"{bad}")
    say(f"phase 4h (d) two runs of the {H_RANKS}-rank step: loss and every "
        f"gradient bitwise equal on every rank")
    for sched in ("gpipe", "interleaved"):
        w = [res[r][f"pp_{sched}"] for r in (0, 1)]
        lr_, gr = max(x["loss_rel"] for x in w), max(x["grad_rel"] for x in w)
        c = res[0]["counts"][f"pp_{sched}"]
        if lr_ > 1e-4 or gr > 1e-3 or c.get("flash_fwd", 0) <= 0 or \
                c.get("flash_bwd", 0) <= 0:
            fail(f"phase 4h (e) {sched}: loss {lr_:.3g}, grad {gr:.3g} "
                 f"({w[0]['worst']}), launches {c}")
        say(f"phase 4h (e) build_pp_train_step pp2 {sched} GPT-2 small f32 "
            f"B{H_PP[0]} S{H_PP[1]} vs lm_loss: loss rel diff {lr_:.3g}, "
            f"worst gradient {gr:.3g} of its magnitude (limits 1e-4, 1e-3);"
            f" launches on rank 0 {c}")
    m = max(max(res[r]["moe"].values()) for r in range(4))
    if m > 1e-4:
        fail(f"phase 4h (f) MoE ep 4: error {m:.3g}")
    say(f"phase 4h (f) MoE ep 4 (T {H_MOE[0]}, d {H_MOE[1]}, hidden "
        f"{H_MOE[2]}, {H_MOE[3]} experts) vs the experts whole on one rank: "
        f"worst output/gradient error {m:.3g} of its magnitude (limit 1e-4)")
    c = max(o["ckpt_loss_rel"] for o in res.values())
    if c > 1e-5:
        fail(f"phase 4h (g): reloaded loss rel diff {c:.3g}")
    say(f"phase 4h (g) sharded checkpoint saved by {H_RANKS} ranks, "
        f"reloaded into dp4 x pp2 x mp2: loss rel diff {c:.3g} (limit 1e-5)")


# ---- phase 4k: the fleet's strategy layer over torch.distributed ------------

K_BATCH, K_SEQ = 4, 1024       # (a): the global batch of GPT-2 small
K_SMALL = (4, 128)             # (b): B, S of the 2-layer full-width GPT-2
K_LR = 1e-4                    # phase 4c's AdamW
K_RANKS = 2
K_TIMEOUT = 420.0              # the world's hard limit (s)
K_UPDATE_REL = 1e-2            # 4h (c)'s per-leaf update limit
K_SETS = (                     # (a): each must equal the world of one
    ("plain", {}),
    ("zero1", {"sharding": True, "sharding_configs": {"stage": 1}}),
    ("zero2", {"sharding": True, "sharding_configs": {"stage": 2}}),
    ("zero3", {"sharding": True, "sharding_configs": {"stage": 3}}),
    ("gradient_merge", {"gradient_merge": True,
                        "gradient_merge_configs": {"k_steps": 2,
                                                   "avg": True}}),
    ("recompute_full", {"recompute": True,
                        "recompute_configs": {"granularity": "full"}}),
    ("recompute_selective", {"recompute": True, "recompute_configs":
                             {"granularity": "selective"}}),
)
K_GRAD_SETS = ("plain", "gradient_merge", "recompute_full",
               "recompute_selective")
K_SMALL_SETS = (               # (b): card against the CPU
    ("localsgd", {"localsgd": True, "localsgd_configs": {"k_steps": 2}},
     "AdamW"),
    ("dgc", {"dgc": True, "dgc_configs": {"sparsity": [0.999]}}, "AdamW"),
    ("int8_allreduce", {"int8_allreduce": True}, "AdamW"),
    ("fp16_allreduce", {"fp16_allreduce": True}, "AdamW"),
    ("lamb", {"lamb": True}, "AdamW"),
    ("lars", {"lars": True}, "Momentum"),
    ("pipeline", {"pipeline": True, "pipeline_configs":
                  {"accumulate_steps": 2}}, "AdamW"),
)
K_KERNELS = ("flash_fwd", "flash_delta", "flash_bwd")


def _k_cfg(small=False):
    from paddle_tpu_torch.models import GPT2Config
    return GPT2Config(num_layers=2 if small else 12, dropout=0.0)


def _k_batch(torch, cfg, b, s, seed):
    rs = np.random.RandomState(seed)
    return {n: torch.from_numpy(rs.randint(0, cfg.vocab_size, (b, s)))
            for n in ("input_ids", "labels")}


def _k_params(torch, dev, small=False):
    """GPT-2's parameters drawn on the card from seed 0 (the same on every
    process), as leaves on `dev`."""
    from paddle_tpu_torch.models import build_train_step
    _loss, init = build_train_step(_k_cfg(small), device="cuda")
    return {n: p.detach().to(dev).clone() for n, p in init().items()}


def _k_loss(cfg):
    from paddle_tpu_torch.models import build_train_step
    loss_fn, _ = build_train_step(cfg, device="cpu")
    return loss_fn


def _k_optimizer(name, dev):
    import paddle_tpu_torch.optimizer as popt
    if name == "Momentum":
        return popt.Momentum(learning_rate=0.1, momentum=0.9, device=dev)
    return popt.AdamW(learning_rate=K_LR, weight_decay=0.01, device=dev)


def _k_step(torch, strategy_flags, opt, dev, loss_fn, **kw):
    """fleet.init -> distributed_optimizer -> build_hybrid_train_step."""
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    for k, v in strategy_flags.items():
        setattr(s, k, v)
    s.hybrid_configs = kw.pop("hybrid", {"dp_degree": -1, "mp_degree": 1,
                                         "pp_degree": 1, "sp_degree": 1})
    fleet.init(is_collective=True, strategy=s, device=dev)
    opt = fleet.distributed_optimizer(opt, s)
    step, _mesh = fleet.build_hybrid_train_step(s, loss_fn, opt, **kw)
    return step, opt


def _k_reference(torch, ref_dir):
    """On this process's card, the world of one: the plain fleet step on
    the global batch (its gradients at the initial weights, two AdamW
    steps) saved for the ranks, then the amp step timed. Returns (the
    plain losses, the amp losses, the amp ms a step)."""
    cfg = _k_cfg()
    batch = _k_batch(torch, cfg, K_BATCH, K_SEQ, 21)
    params = _k_params(torch, DEV)
    step, opt = _k_step(torch, {}, _k_optimizer("AdamW", DEV), DEV,
                        _k_loss(cfg))
    params, state = step.init_opt_state(params, device=DEV)
    _loss, grads = step.value_and_grad(params, batch, None)
    torch.save({n: g.cpu() for n, g in grads.items()},
               os.path.join(ref_dir, "grads.pt"))
    del grads
    losses = []
    for _ in range(2):
        loss, params, state = step(params, state, batch, None)
        losses.append(loss.item())
    torch.save({"params": {n: p.cpu() for n, p in params.items()},
                "losses": losses}, os.path.join(ref_dir, "trained.pt"))
    del params, state
    torch.cuda.empty_cache()
    step, opt = _k_step(torch, {"amp": True}, _k_optimizer("AdamW", DEV),
                        DEV, _k_loss(cfg))
    params, state = step.init_opt_state(_k_params(torch, DEV), device=DEV)
    amp = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, params, state = step(params, state, batch, None)
        amp.append(loss.item())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    del params, state
    torch.cuda.empty_cache()
    return losses, amp, ms


def _k_sync(torch, dev):
    import torch.distributed as dist
    if dev == "cuda":
        torch.cuda.synchronize()
    dist.barrier()


def _k_counted(torch, dev, out, name, fn):
    from paddle_tpu_torch.ops import kernels
    _k_sync(torch, dev)
    kernels.reset_launch_counts()
    r = fn()
    _k_sync(torch, dev)
    out["counts"][name] = {k: v for k, v in kernels.launch_counts().items()
                           if v}
    return r


def _k_full(torch, dev, out, ref_dir):
    """(a): GPT-2 small at full width and depth, S 1024, dp 2, two steps
    per flag set against the world of one."""
    cfg = _k_cfg()
    batch = _k_batch(torch, cfg, K_BATCH, K_SEQ, 21)
    ref_g = torch.load(os.path.join(ref_dir, "grads.pt"), mmap=True)
    trained = torch.load(os.path.join(ref_dir, "trained.pt"), mmap=True)
    init = {n: p.cpu() for n, p in _k_params(torch, dev).items()}
    for name, flags in K_SETS + (("amp", {"amp": True}),):
        step, opt = _k_step(torch, flags, _k_optimizer("AdamW", dev), dev,
                            _k_loss(cfg))
        params, state = step.init_opt_state(_k_params(torch, dev),
                                            device=dev)
        res = {}
        if name in K_GRAD_SETS:
            _loss, grads = step.value_and_grad(params, batch, None)
            res["grad_rel"] = max(_h_err(torch, grads[n], ref_g[n].to(dev))
                                  for n in grads)
            del grads

        box = [params, state]

        def two():
            losses = []
            for _ in range(2):
                _k_sync(torch, dev)
                t0 = time.perf_counter()
                loss, box[0], box[1] = step(*box, batch, None)
                losses.append(loss.item())
                _k_sync(torch, dev)
                res["ms"] = (time.perf_counter() - t0) * 1e3
            return losses

        res["losses"] = _k_counted(torch, dev, out, name, two)
        params, state = box
        full = step.gather_params(params)
        if name == "amp":
            res["dtypes"] = sorted({str(p.dtype) for p in full.values()})
        else:
            want = trained["params"]
            res["update_rel"] = max(
                (_h_update_err(torch, full[n].cpu(), want[n], init[n]), n)
                for n in full)
        out[name] = res
        del step, params, state, full
        torch.cuda.empty_cache()


def _k_pipeline_parts(torch, cfg, params, batch):
    """GPT-2's blocks as the pipeline's stages: the stacked block leaves
    [layers, ...], the embedded batch as the stages' input, and a loss
    head (final norm and tied head, fixed) on the last stage's output."""
    import torch.nn.functional as F

    from paddle_tpu_torch.models.gpt2 import _block
    from paddle_tpu_torch.ops.loss import cross_entropy

    names = [n[len("h.0."):] for n in params if n.startswith("h.0.")]
    stacked = {n: torch.stack([params[f"h.{i}.{n}"]
                               for i in range(cfg.num_layers)])
               for n in names}
    ids = batch["input_ids"].to(params["wte.weight"].device)
    pos = torch.arange(ids.shape[1], device=ids.device)
    x = (F.embedding(ids, params["wte.weight"])
         + F.embedding(pos, params["wpe.weight"])).detach()
    wte, lw, lb = (params[n].detach() for n in ("wte.weight",
                                                "ln_f.weight", "ln_f.bias"))

    def stage_fn(stage, a):
        return _block({f"h.0.{k}": v for k, v in stage.items()}, 0, a, cfg,
                      0.0, None)

    def loss_head(y, labels):
        h = F.layer_norm(y, (cfg.hidden_size,), lw, lb,
                         cfg.layer_norm_epsilon)
        lg = h.reshape(-1, cfg.hidden_size) @ wte.T
        return cross_entropy(lg, labels.reshape(-1))

    return stacked, {"x": x, "labels": batch["labels"]}, stage_fn, loss_head


def _k_small(torch, dev, rank, out):
    """(b): the other flags on the 2-layer GPT-2, each run on the card and
    on the CPU from the same weights."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.collective import (
        bucketed_quantized_all_reduce)
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel.mesh import make_mesh

    cfg = _k_cfg(small=True)
    b, s = K_SMALL
    batch = _k_batch(torch, cfg, b, s, 22)
    base = _k_params(torch, "cpu", small=True)
    for name, flags, opt_name in K_SMALL_SETS:
        runs = {}
        for d in (dev, "cpu"):
            params = {n: p.to(d) for n, p in base.items()}
            kw, feed, loss_fn = {}, batch, _k_loss(cfg)
            if name == "pipeline":
                params, feed, sf, lh = _k_pipeline_parts(torch, cfg, params,
                                                         batch)
                kw = dict(stage_fn=sf, loss_head=lh, hybrid={
                    "dp_degree": 1, "mp_degree": 1, "pp_degree": 2,
                    "sp_degree": 1})
                loss_fn = None
            step, opt = _k_step(torch, flags, _k_optimizer(opt_name, d), d,
                                loss_fn, **kw)
            params, state = step.init_opt_state(params, device=d)
            init = {n: p.detach().cpu().clone() for n, p in
                    step.gather_params(params).items()}
            r = {"losses": [], "copies": []}
            box = [params, state]

            def steps():
                for i in range(3 if name == "dgc" else 2):
                    loss, box[0], box[1] = step(*box, feed, None)
                    r["losses"].append(loss.item())
                    if name == "localsgd":
                        w = box[0]["h.0.fc1.weight"].detach()
                        other = comm.all_gather(w.contiguous(),
                                                dist.group.WORLD)
                        r["copies"].append(torch.equal(other[0], other[1]))

            if d == dev:
                _k_counted(torch, dev, out, f"small_{name}", steps)
            else:
                steps()
            params, state = box
            r["params"] = {n: p.detach().cpu() for n, p in
                           step.gather_params(params).items()}
            r["init"] = init
            if name == "dgc":
                r["residual"] = sum(e.abs().sum().item() for e in
                                    state["dgc_err"].values())
            runs[d] = r
            del step, params, state
        got, want = runs[dev], runs["cpu"]
        out[f"small_{name}"] = {
            "losses": got["losses"], "cpu_losses": want["losses"],
            "loss_rel": max(abs(a - c) / abs(c) for a, c in
                            zip(got["losses"], want["losses"])),
            "param_diff": max(((got["params"][n] - want["params"][n])
                               .abs().max().item(), n)
                              for n in got["params"]),
            "update_rel": max((_h_update_err(torch, got["params"][n],
                                             want["params"][n],
                                             got["init"][n]), n)
                              for n in got["params"]),
            "copies": got["copies"], "residual": got.get("residual")}
        torch.cuda.empty_cache()
    # the int8 all-reduce against the float32 mean, on GPT-2's gradients
    params = {n: p.to(dev).requires_grad_(True) for n, p in base.items()}
    mesh = make_mesh(dp=K_RANKS)
    rows = {n: t[rank * (b // K_RANKS):(rank + 1) * (b // K_RANKS)].to(dev)
            for n, t in batch.items()}
    loss = _k_loss(cfg)(params, rows)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    exact = {n: comm.all_reduce_(g.clone(), mesh.group("dp")) / K_RANKS
             for n, g in grads.items()}
    q = bucketed_quantized_all_reduce(grads, "dp", mesh=mesh)
    amax = {n: comm.all_reduce_(g.abs().max().reshape(1),
                                mesh.group("dp"),
                                dist.ReduceOp.MAX)[0].item()
            for n, g in grads.items()}
    # each rank's codes err by at most half a step of its block's scale
    # (<= amax / 254), the reduced sum's by half a step of its own
    # (<= n * amax / 254): the mean errs by at most 2 * amax / 254
    out["int8_bound"] = max(
        ((q[n] / K_RANKS - exact[n]).abs().max().item()
         / (2 * amax[n] / 254), n) for n in grads)


def _k_syncbn(torch, dev, rank, out):
    """(d): SyncBatchNorm over the 2 ranks against BatchNorm over the
    global batch (every rank computes the latter on the whole batch)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.nn import SyncBatchNorm
    from paddle_tpu_torch.parallel.mesh import make_mesh

    g = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(2 * K_RANKS * 8, 64, 16, 16, generator=g, device=dev) \
        * 3 + 1
    per = x.shape[0] // K_RANKS
    bn = SyncBatchNorm(64, mesh=make_mesh(dp=K_RANKS), device=dev)
    out_l = bn(x[rank * per:(rank + 1) * per])
    rm, rv = torch.zeros(64, device=dev), torch.ones(64, device=dev)
    ref = F.batch_norm(x, rm, rv, bn.weight, bn.bias, True, 0.1, 1e-5)
    out["syncbn"] = max(
        _h_err(torch, out_l, ref[rank * per:(rank + 1) * per]),
        (bn._mean - rm).abs().max().item(),
        (bn._variance - rv).abs().max().item() / rv.abs().max().item())


def _k_rank(rank, nprocs, store, out_dir, dev, ref_dir):
    """One rank of the 4k world (gloo: the ranks share the card)."""
    import pickle
    import traceback

    import torch
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(nprocs), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE=str(nprocs))
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        import datetime

        import paddle_tpu_torch.distributed as pdist
        torch.set_num_threads(4)
        if dev == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        pdist.init_parallel_env(
            init_method=f"file://{store}", rank=rank, world_size=nprocs,
            device=dev, timeout=datetime.timedelta(seconds=K_TIMEOUT))
        out = {"counts": {}, "backend": torch.distributed.get_backend()}
        t0 = time.perf_counter()
        _k_full(torch, dev, out, ref_dir)
        out["a_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _k_small(torch, dev, rank, out)
        out["b_s"] = time.perf_counter() - t0
        _k_syncbn(torch, dev, rank, out)
        with open(path + ".pkl", "wb") as f:
            pickle.dump(out, f)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:  # noqa: BLE001
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def _k_world(out_dir, dev, ref_dir):
    """Spawn the ranks, wait (hard limit K_TIMEOUT: kill them all and
    fail), return ({rank: results}, seconds)."""
    import multiprocessing as mp
    import pickle
    ctx = mp.get_context("spawn")
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_k_rank, args=(r, K_RANKS, store, out_dir,
                                               dev, ref_dir))
             for r in range(K_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + K_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)
    errs = [f"rank {r}: " + open(os.path.join(out_dir, f"rank{r}.err"))
            .read()[-3000:] for r in range(K_RANKS)
            if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))]
    if errs:
        fail("phase 4k: " + "\n".join(errs))
    if alive:
        fail(f"phase 4k: the world of {K_RANKS} ranks passed its "
             f"{K_TIMEOUT:.0f} s limit; ranks {alive} killed")
    lost = [(r, p.exitcode) for r, p in enumerate(procs) if not
            os.path.exists(os.path.join(out_dir, f"rank{r}.pkl"))]
    if lost:
        fail(f"phase 4k: ranks (rank, exit code) {lost} ended without a "
             f"result")
    res = {}
    for r in range(K_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            res[r] = pickle.load(f)
    return res, time.perf_counter() - t0


def _k_ps(torch):
    """(c): a recsys tower on PSEmbedding pulling to the card, against the
    same tower on the CPU: (worst loss rel diff, table diff, losses)."""
    import paddle_tpu_torch.optimizer as popt
    from paddle_tpu_torch.distributed.ps import PSEmbedding

    ids = np.random.RandomState(0).randint(0, 5000, (256,))
    y = torch.from_numpy((ids % 2).astype(np.float32)[:, None])
    runs = {}
    for d in (DEV, "cpu"):
        emb = PSEmbedding(5000, 64, learning_rate=0.5, device=d)
        g = torch.Generator().manual_seed(3)
        lin = torch.nn.Linear(64, 1)
        with torch.no_grad():
            lin.weight.copy_(torch.randn(1, 64, generator=g) * 0.1)
            lin.bias.zero_()
        lin.to(d)
        opt = popt.Adam(learning_rate=0.05,
                        parameters=list(lin.named_parameters()), device=d)
        losses = []
        for _ in range(8):
            loss = ((lin(emb(torch.from_numpy(ids))) - y.to(d)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            emb.apply_gradients()
            losses.append(loss.item())
        runs[d] = (losses, emb.table.data.copy())
    rel = max(abs(a - c) / abs(c) for a, c in zip(runs[DEV][0],
                                                  runs["cpu"][0]))
    return rel, float(np.abs(runs[DEV][1] - runs["cpu"][1]).max()), \
        runs[DEV][0]


_K_LAUNCHED = """
import os, sys
import torch
import paddle_tpu_torch.distributed as dist
env = dist.init_parallel_env()
t = torch.tensor([float(dist.get_rank() + 1)], device="cuda")
dist.all_reduce(t)
with open(os.path.join(sys.argv[1], f"rank{dist.get_rank()}.txt"), "w") as f:
    f.write(f"{dist.get_world_size()} {t.item()} {t.device} "
            f"{torch.distributed.get_backend()}")
"""


def _k_launch(tmp):
    """(e): `python -m paddle_tpu_torch.distributed.launch` with 2 ranks
    on the card and one all_reduce: [each rank's (world, sum, device,
    backend)]."""
    script = os.path.join(tmp, "launched.py")
    with open(script, "w") as f:
        f.write(_K_LAUNCHED)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", script, tmp], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180)
    if r.returncode != 0:
        fail(f"phase 4k (e): the launcher exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    return [open(os.path.join(tmp, f"rank{i}.txt")).read().split()
            for i in range(2)]


def fleet_phase(torch, card):
    """Phase 4k (module constants K_*): returns the main path's launches
    {kernel: n} summed over the ranks."""
    import shutil
    import tempfile

    t_all = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase4k_")
    try:
        ref_losses, one_amp, one_ms = _k_reference(torch, tmp)
        res, wall = _k_world(tmp, DEV, tmp)
        counts = checks_fleet(res, ref_losses, one_amp, one_ms, card)
        rel, table, losses = _k_ps(torch)
        if rel > 1e-4 or table > 1e-5 or not losses[-1] < losses[0]:
            fail(f"phase 4k (c): losses rel diff {rel:.3g} (limit 1e-4), "
                 f"table diff {table:.3g} (limit 1e-5), losses {losses}")
        say(f"phase 4k (c) PSEmbedding (5000 x 64, sgd 0.5) pulling to the "
            f"card + a dense layer (port Adam), 8 steps on 256 ids: losses "
            f"{losses[0]:.5f} -> {losses[-1]:.5f}, card vs CPU losses rel "
            f"diff {rel:.3g} (limit 1e-4), host table diff {table:.3g} "
            f"(limit 1e-5)")
        got = _k_launch(tmp)
        if any(r[0] != "2" or float(r[1]) != 3.0 or not r[2].startswith(
                "cuda") for r in got):
            fail(f"phase 4k (e): ranks reported {got}")
        say(f"phase 4k (e) python -m paddle_tpu_torch.distributed.launch "
            f"--nproc_per_node 2: both ranks joined (world 2, backend "
            f"{got[0][3]}: they share the card), all_reduce of rank + 1 on "
            f"{got[0][2]} = {float(got[0][1]):g} on each")
        say(f"phase 4k: world of {K_RANKS} {wall:.1f} s ((a) "
            f"{res[0]['a_s']:.1f} s, (b) {res[0]['b_s']:.1f} s), the phase "
            f"{time.perf_counter() - t_all:.1f} s")
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def checks_fleet(res, ref_losses, one_amp, one_ms, card):
    """Phase 4k's checks (a), (b), (d) on the ranks' results; prints their
    lines and returns the ranks' launches of K4, K6 and K9."""
    counts = {k: 0 for k in K_KERNELS}
    for name, _flags in K_SETS + (("amp", None),):
        for r, o in res.items():
            c = o["counts"][name]
            if any(c.get(k, 0) <= 0 for k in K_KERNELS):
                fail(f"phase 4k (a) {name} rank {r}: launches {c}")
            for k in K_KERNELS:
                counts[k] += c.get(k, 0)
    for name, _flags in K_SETS:
        rows = [o[name] for o in res.values()]
        tl = max(abs(a - b) / abs(b) for x in rows
                 for a, b in zip(x["losses"], ref_losses))
        upd = max(x["update_rel"] for x in rows)
        grad = max((x.get("grad_rel", 0.0) for x in rows))
        if tl > 1e-4 or upd[0] > K_UPDATE_REL or grad > 1e-3:
            fail(f"phase 4k (a) {name}: step losses rel diff {tl:.3g} "
                 f"(limit 1e-4), worst leaf update error {upd[1]} "
                 f"{upd[0]:.3g} (limit {K_UPDATE_REL:g}), gradients "
                 f"{grad:.3g} of their magnitude (limit 1e-3)")
        say(f"phase 4k (a) fleet {name} GPT-2 small f32 dp {K_RANKS} B"
            f"{K_BATCH} S{K_SEQ}, 2 AdamW steps vs the world of one: losses "
            f"{' '.join(f'{x:.6f}' for x in rows[0]['losses'])} (rel diff "
            f"{tl:.3g}), worst leaf update error {upd[0]:.3g} ({upd[1]})"
            + (f", gradients {grad:.3g} of their magnitude" if name in
               K_GRAD_SETS else "") + "; launches by rank "
            + "; ".join(f"{r}: {o['counts'][name]}" for r, o in res.items()))
    amp = [o["amp"] for o in res.values()]
    rel = max(abs(a - b) / abs(b) for x in amp
              for a, b in zip(x["losses"], ref_losses))
    if rel > BF16_DECODER_REL or any(x["dtypes"] != ["torch.float32"]
                                     for x in amp):
        fail(f"phase 4k (a) amp: losses rel diff {rel:.3g} from float32 "
             f"(limit {BF16_DECODER_REL}), master dtypes "
             f"{[x['dtypes'] for x in amp]}")
    say(f"phase 4k (a) fleet amp (bf16 compute, float32 masters): losses "
        f"{' '.join(f'{x:.5f}' for x in amp[0]['losses'])} vs float32 "
        f"{' '.join(f'{x:.5f}' for x in ref_losses)} (rel diff {rel:.3g}, "
        f"limit {BF16_DECODER_REL}); masters {amp[0]['dtypes']}; ms_per_step "
        f"(second step) dp {K_RANKS}: {amp[0]['ms']:.1f}, world of one "
        f"(B{K_BATCH} on one process): {one_ms:.1f}, one amp loss "
        f"{one_amp[0]:.5f} — {K_RANKS} ranks time-sharing one card over "
        f"gloo: not a multi-GPU number [{card}]")
    for name, _flags, opt_name in K_SMALL_SETS:
        rows = [o[f"small_{name}"] for o in res.values()]
        lr_ = max(x["loss_rel"] for x in rows)
        upd = max(x["update_rel"] for x in rows)
        diff = max(x["param_diff"] for x in rows)
        # phase 4c's limits: parameters within 2 * lr * steps (Adam's
        # family moves a weight whose gradient is rounding noise — the k
        # biases' — by about +-lr whatever its sign); a Momentum-family
        # step scales with the gradient, so Lars also holds 4h (c)'s
        # per-leaf update error
        steps = 3 if name == "dgc" else 2
        lim = 2 * (0.1 if opt_name == "Momentum" else K_LR) * steps + 1e-6
        extra = ""
        bad = lr_ > 1e-4 or diff[0] > lim or (
            opt_name == "Momentum" and upd[0] > K_UPDATE_REL)
        if name == "localsgd":
            cps = rows[0]["copies"]
            bad |= cps != [False, True]
            extra = f", ranks' copies equal after step 1/2: {cps}"
        if name == "dgc":
            los = rows[0]["losses"]
            bad |= not (rows[0]["residual"] > 0 and los[-1] < los[0])
            extra = (f", residual sum {rows[0]['residual']:.4g}, losses "
                     f"{' '.join(f'{x:.5f}' for x in los)}")
        if bad:
            fail(f"phase 4k (b) {name}: card vs CPU losses rel diff "
                 f"{lr_:.3g} (limit 1e-4), parameters {diff[1]} "
                 f"{diff[0]:.3g} (limit {lim:.3g}), worst leaf update "
                 f"error {upd[1]} {upd[0]:.3g} (limit {K_UPDATE_REL:g} "
                 f"for Lars){extra}")
        say(f"phase 4k (b) fleet {name} ({opt_name}) GPT-2 2 layers full "
            f"width B{K_SMALL[0]} S{K_SMALL[1]}, card vs CPU: losses rel "
            f"diff {lr_:.3g} (limit 1e-4), worst parameter diff "
            f"{diff[0]:.3g} ({diff[1]}; limit {lim:.3g}), worst leaf "
            f"update error {upd[0]:.3g} ({upd[1]}){extra}")
    ib = max(o["int8_bound"] for o in res.values())
    if ib[0] > 1.0:
        fail(f"phase 4k (b) int8 all-reduce of GPT-2's gradients: {ib[1]} "
             f"errs {ib[0]:.3g} of the quantization bound")
    say(f"phase 4k (b) int8 all-reduce of the 2-layer GPT-2's gradients vs "
        f"the float32 mean: worst error {ib[0]:.3g} of the bound 2 * "
        f"max|g| / 254 ({ib[1]})")
    sb = max(o["syncbn"] for o in res.values())
    if sb > 1e-5:
        fail(f"phase 4k (d) SyncBatchNorm: error {sb:.3g} (limit 1e-5)")
    say(f"phase 4k (d) SyncBatchNorm over {K_RANKS} ranks on the card "
        f"(B 16 x 64 x 16 x 16, 8 a rank) vs BatchNorm over the global "
        f"batch: outputs and running statistics within {sb:.3g} (limit "
        f"1e-5)")
    say(f"phase 4k launches of the fleet's main path, summed over the "
        f"ranks: {counts}")
    return counts


def main():
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        say("FAIL device: torch.cuda.is_available() is False "
            "(chip_smoke needs a CUDA card)")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    say(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 comparisons
    torch.backends.cudnn.allow_tf32 = False        # are full float32

    from paddle_tpu_torch.models import GPT2, GPT2Config
    from paddle_tpu_torch.ops import kernels

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    say(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(lib_path, REPO)}")

    # phase 3: kernels vs plain
    timer = Timer(torch)
    rows = {}
    for quant in (False, True):
        tag = "int8" if quant else "dense"
        r2 = decode_case(torch, timer, 12, 64, 16, quant, 1, True)
        r2s = decode_case(torch, timer, 12, 64, 16, quant, 11, True,
                          lens=serving_lens())
        # what one streaming read of the same bytes takes here (a
        # contiguous torch.sum, L2 flushed as for the kernel): the
        # practical ceiling under this measurement, beside the nominal
        # 3.35 TB/s of the bound
        buf = torch.zeros(r2s["bytes"] // 2, dtype=torch.bfloat16,
                          device=DEV)
        r2s["stream_ms"] = timer.ms(lambda: buf.sum())
        del buf
        cases = [(f"K2 {tag} H12 Dh64 BS16", r2),
                 (f"K2 {tag} H12 Dh64 BS16 B128 serving-scale", r2s),
                 (f"K2 {tag} H12 Dh64 BS128",
                  decode_case(torch, timer, 12, 64, 128, quant, 2, False)),
                 (f"K2 {tag} H4 Dh32 BS4",
                  decode_case(torch, timer, 4, 32, 4, quant, 3, False))]
        for h, dh, bs, m, seed in ((12, 64, 16, 64, 6), (12, 64, 128, 8, 7),
                                   (4, 32, 4, 64, 8)):
            cases.append((f"K2 {tag} H{h} Dh{dh} BS{bs} edge lengths",
                          decode_case(torch, timer, h, dh, bs, quant, seed,
                                      False, decode_lens(torch, h, bs, m),
                                      m)))
        r1 = stream_case(torch, timer, 12, 64, 16, quant, 4, True)
        r1s = stream_case(torch, timer, 12, 64, 16, quant, 13, True,
                          "serving")                                # C1
        r1c = stream_case(torch, timer, 12, 64, 16, quant, 12, True,
                          "short")                                  # C3
        buf = torch.zeros(r1s["bytes"] // 2, dtype=torch.bfloat16,
                          device=DEV)
        r1s["stream_ms"] = timer.ms(lambda: buf.sum())
        del buf
        cases += [(f"K1 {tag} H12 Dh64 BS16 T{r1['tokens']}", r1),
                  (f"K1 {tag} H4 Dh32 BS4",
                   stream_case(torch, timer, 4, 32, 4, quant, 5, False)),
                  (f"K1 {tag} H12 Dh64 BS16 T4096 serving-scale (C1)", r1s),
                  (f"K1 {tag} H12 Dh128 BS16 (C2)",
                   stream_case(torch, timer, 12, 128, 16, quant, 14,
                               False)),
                  (f"K1 {tag} H12 Dh64 BS128 (C2)",
                   stream_case(torch, timer, 12, 64, 128, quant, 15,
                               False)),
                  (f"K1 {tag} H12 Dh64 BS16 64 x 8-token segments (C3)",
                   r1c)]
        for name, r in cases:
            if not r["ok"]:
                fail(f"phase 3 {name}: kernel disagrees with plain "
                     f"(max abs err {r['max_abs_err']:.3g}, atol=rtol=2e-2;"
                     f" ctx 0 rows and pad rows must be zeros)")
            if not r["bitwise"]:
                fail(f"phase 3 {name}: two launches differ")
        say(f"phase 3 K2 {tag}: every case within 2e-2 of plain and bitwise "
            f"equal over two launches (splits x keys: " + ", ".join(
                f"{n.split(' ', 2)[2]} {r['splits'][0]}x{r['splits'][1]}"
                for n, r in cases if n.startswith("K2")) + ")")
        say(f"phase 3 K1 {tag}: every case within 2e-2 of plain, pad rows "
            f"zeros, bitwise equal over two launches (max abs err, key "
            f"passes per 64-row tile max/mean: " + ", ".join(
                f"{n.split(' ', 2)[2]} {r['max_abs_err']:.3g} "
                f"{max(r['passes'])}/"
                f"{sum(r['passes']) / len(r['passes']):.2f}"
                for n, r in cases if n.startswith("K1")) + ")")
        for name, r in ((f"paged_decode_{tag}", r2),
                        (f"ragged_stream_{tag}", r1)):
            rows[name] = r
            what = ("split + combine per call" if name.startswith("paged")
                    else "per call")
            say(f"phase 3 {name}: max_abs_err {r['max_abs_err']:.3g} "
                f"kernel {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms "
                f"(profiler, {what}), wrapper host {r['host_ms']:.4f} ms a "
                f"call, plain {r['plain_ms']:.4f} ms, library (SDPA, gather "
                f"excluded) {r['library_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
        say(f"phase 3 ragged_stream_{tag} serving-scale (C1) T4096 H12 Dh64 "
            f"BS16 (sum (pos+1) {r1s['flops'] // (4 * 12 * 64)}, "
            f"{r1s['bytes'] / 1e6:.1f} MB, {r1s['flops'] / 1e9:.2f} "
            f"GFLOP): max_abs_err {r1s['max_abs_err']:.3g} kernel "
            f"{r1s['ms']:.4f} ms, device {r1s['device_ms']:.4f} ms "
            f"(profiler), wrapper host {r1s['host_ms']:.4f} ms, plain "
            f"{r1s['plain_ms']:.4f} ms, library (SDPA, gather excluded) "
            f"{r1s['library_ms']:.4f} ms, bound {r1s['bound_ms']:.4f} ms "
            f"({r1s['bound_by']}); share of the bound "
            f"{r1s['bound_ms'] / r1s['device_ms']:.3f} (device), "
            f"{r1s['bound_ms'] / r1s['ms']:.3f} (events); "
            f"{r1s['flops'] / r1s['device_ms'] / 1e9:.1f} TFLOP/s (device); "
            f"kernel / library {r1s['ms'] / r1s['library_ms']:.2f}x; a "
            f"contiguous read of the same bytes (torch.sum) "
            f"{r1s['stream_ms']:.4f} ms [{card}]")
        say(f"phase 3 ragged_stream_{tag} short segments (C3) T512 H12 Dh64 "
            f"BS16, 64 x 8 tokens (sum (pos+1) "
            f"{r1c['flops'] // (4 * 12 * 64)}, {r1c['bytes'] / 1e6:.1f} MB): "
            f"key passes per 64-row tile {r1c['passes']}; kernel "
            f"{r1c['ms']:.4f} ms, device {r1c['device_ms']:.4f} ms "
            f"(profiler), wrapper host {r1c['host_ms']:.4f} ms, plain "
            f"{r1c['plain_ms']:.4f} ms, library (SDPA, gather excluded) "
            f"{r1c['library_ms']:.4f} ms, bound {r1c['bound_ms']:.4f} ms "
            f"({r1c['bound_by']}); share of the bound "
            f"{r1c['bound_ms'] / r1c['device_ms']:.3f} (device) [{card}]")
        say(f"phase 3 paged_decode_{tag} serving-scale B128 H12 Dh64 BS16 "
            f"(sum ctx {r2s['flops'] // (4 * 12 * 64)}, "
            f"{r2s['bytes'] / 1e6:.1f} MB): max_abs_err "
            f"{r2s['max_abs_err']:.3g} kernel {r2s['ms']:.4f} ms, device "
            f"{r2s['device_ms']:.4f} ms (profiler), wrapper host "
            f"{r2s['host_ms']:.4f} ms, plain "
            f"{r2s['plain_ms']:.4f} ms, library (SDPA, gather excluded) "
            f"{r2s['library_ms']:.4f} ms, bound {r2s['bound_ms']:.4f} ms "
            f"({r2s['bound_by']}); share of the bound "
            f"{r2s['bound_ms'] / r2s['device_ms']:.3f} (device), "
            f"{r2s['bound_ms'] / r2s['ms']:.3f} (events); kernel / library "
            f"{r2s['ms'] / r2s['library_ms']:.2f}x; a contiguous read of "
            f"the same bytes (torch.sum) {r2s['stream_ms']:.4f} ms, "
            f"{r2s['stream_ms'] / r2s['device_ms']:.3f} of the kernel's "
            f"rate [{card}]")
        torch.cuda.empty_cache()

    # phase 3b: flash kernels vs plain
    both, bf16 = (torch.bfloat16, torch.float32), (torch.bfloat16,)
    for b, h, sq, sk, d, causal, timed, dtypes in (
            (16, 12, 1024, 1024, 64, True, True, both),
            (2, 4, 1000, 1000, 32, True, False, both),
            (2, 4, 1000, 1000, 32, False, False, both),
            (2, 8, 2048, 2048, 128, True, False, bf16),
            (2, 4, 384, 256, 64, True, False, bf16)):  # dead rows
        for dtype in dtypes:
            r = flash_case(torch, timer, b, h, sq, sk, d, causal, dtype,
                           b * sq + d, timed and dtype == torch.bfloat16)
            if timed and dtype == torch.bfloat16:
                rows.update(r)
    torch.cuda.empty_cache()

    # phase 3c: per-key-bias flash kernels vs plain
    for b, h, sq, sk, d, causal, kind in (
            (16, 16, 512, 512, 64, False, "lengths"),
            (2, 4, 300, 300, 32, True, "lengths"),
            (2, 4, 256, 384, 64, False, "lengths"),
            (2, 4, 256, 256, 64, False, "broadcast"),
            (2, 4, 256, 256, 32, False, "dead_row"),
            (2, 4, 256, 256, 32, True, "dead_row")):
        for dtype in (torch.bfloat16, torch.float32):
            timed = b == 16 and dtype == torch.bfloat16
            r = bias_flash_case(torch, timer, b, h, sq, sk, d, causal, kind,
                                dtype, b * sq + sk + d, timed)
            if timed:
                rows.update(r)
    torch.cuda.empty_cache()

    # phase 3d: the two-pass backward (K7, K8, bias variants) vs plain
    for b, h, sq, sk, d, causal, kind, dtypes, external in (
            (16, 12, 1024, 1024, 64, True, None, both, False),      # (a)
            (1, 2, 16384, 16384, 64, True, None, bf16, False),      # (b)
            (2, 4, 1000, 1000, 32, True, None, both, False),        # (c)
            (2, 4, 1000, 1000, 32, False, None, both, False),
            (2, 4, 256, 384, 64, False, None, both, False),         # (d)
            (2, 4, 600, 100, 64, True, None, both, False),  # dead rows
            (2, 8, 2048, 2048, 128, True, None, bf16, False),       # D 128
            (2, 4, 256, 256, 64, False, None, both, True),          # (e)
            (16, 16, 512, 512, 64, False, "lengths", both, False),  # (f)
            (2, 4, 300, 300, 32, True, "lengths", both, False),
            (2, 4, 256, 384, 64, False, "lengths", both, False),
            (2, 4, 256, 256, 64, False, "broadcast", both, False),
            (2, 4, 256, 256, 32, False, "dead_row", both, False),
            (2, 4, 256, 256, 32, True, "dead_row", both, False)):
        for dtype in dtypes:
            timed = b == 16 and dtype == torch.bfloat16
            r = two_pass_case(torch, timer, b, h, sq, sk, d, causal, kind,
                              dtype, b * sq + sk + d, timed, external)
            if timed:
                rows.update(r)
        torch.cuda.empty_cache()
    # (f) phase 6c's padded batch, its mask and per-row bias, at H 2
    two_pass_case(torch, timer, 2, 2, 16384, 16384, 64, True, "lengths",
                  torch.bfloat16, 7, False, lengths=(16384, 10240))
    torch.cuda.empty_cache()

    # phase 3e: K4 at the seq2seq decode shapes (one query over 1-255
    # keys), the cross-attention's Sq != Sk, and K4 bias under a padded
    # source (WMT base: H 8, D 64)
    t0 = time.perf_counter()
    for dtype in (torch.bfloat16, torch.float32):
        errs = []
        for sk in Q1_SK:
            timed = dtype == torch.bfloat16 and sk == 64
            r = q1_flash_case(torch, timer, 32, 8, sk, 64, dtype, 300 + sk,
                              timed)
            errs.append(f"Sk{sk} {r['max_abs_err']:.3g}")
            if timed:
                rows["flash_fwd_decode"] = r
        say(f"phase 3e flash_fwd Sq1 B32 H8 D64 "
            f"{str(dtype).split('.')[-1]}: within tolerance of plain, out "
            f"and lse bitwise over two launches; max abs err "
            + ", ".join(errs))
    r = rows["flash_fwd_decode"]
    say(f"phase 3e flash_fwd {r['tag']}: kernel {r['ms']:.4f} ms, device "
        f"{r['device_ms']:.4f} ms (profiler), plain {r['plain_ms']:.4f} ms, "
        f"library (SDPA) {r['library_ms']:.4f} ms (device "
        f"{r['library_device_ms']:.4f}), dense path {r['dense_ms']:.4f} ms "
        f"(device {r['dense_device_ms']:.4f}), bound {r['bound_ms']:.5f} ms "
        f"({r['bound_by']}); share of the bound "
        f"{r['bound_ms'] / r['device_ms']:.3f} (device); device time / "
        f"SDPA's {r['device_ms'] / r['library_device_ms']:.2f}x, / the "
        f"dense path's {r['device_ms'] / r['dense_device_ms']:.2f}x [{card}]")
    for dtype in both:
        flash_case(torch, timer, 4, 8, 96, 128, 64, False, dtype, 396, False,
                   phase="3e")
        bias_flash_case(torch, timer, 8, 8, 128, 128, 64, False, "lengths",
                        dtype, 1160, False, phase="3e")
    say(f"phase 3e: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # phase 4: decoder parity, GPT-2 small float32, card vs CPU
    cfg = GPT2Config()  # GPT-2 small, full width and depth
    model32 = GPT2(cfg, seed=0, dtype=torch.float32, device=DEV)
    params32 = model32.flat_params()
    main_counts = {}
    for kv_dtype, atol in ((None, 2e-3), ("int8", 2e-2)):
        kernels.reset_launch_counts()
        worst, ties = decoder_parity(torch, cfg, params32, kv_dtype, atol)
        counts = kernels.launch_counts()
        if kv_dtype == "int8":
            main_counts["paged_decode_int8"] = counts["paged_decode_int8"]
        if min(v for n, v in counts.items()
               if n.endswith(kv_dtype or "dense")) == 0:
            fail(f"phase 4 {kv_dtype}: a kernel was not launched {counts}")
        say(f"phase 4 decoder {kv_dtype or 'dense'} f32: max logit diff "
            f"{worst:.3g} (atol {atol}), near-ties {ties}, launches "
            f"{counts}")

    # phase 4s: the sampler on the card, float32 (TF32 is off)
    t0 = time.perf_counter()
    ulps, n_diff = prng_parity(torch)
    say(f"phase 4s (a) PRNG 8 rows x 50257: keys, random bits and uniforms "
        f"bitwise the CPU's; Gumbel noise within {ulps:.3g} ulp (limit "
        f"{GUMBEL_ULPS}), {n_diff} of {8 * 50257} entries not bitwise")
    margins = sampler_parity(torch)
    say("phase 4s (b) sample_tokens 8 x 50257, modes greedy/sampled/"
        "penalties/both: tokens identical card vs CPU; smallest top-two "
        "margin of filt + gumbel per row: " + "; ".join(
            f"{name} " + " ".join(f"{m:.3g}" for m in ms)
            for name, ms in margins.items()))
    runs, draws, near, greedy = sampled_serving(torch, model32)
    say(f"phase 4s (c) served f32 GPT-2 small, 8 requests (greedy, sampled,"
        f" penalized; fixed seeds) x 16 tokens: k=1, k=4 and k=1 in "
        f"reverse slot order give the same tokens; {draws} sampled draws "
        f"and {greedy} greedy rows replayed on the CPU from the card's "
        f"logits, identical; {near} draws below the margin {MARGIN}; "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 4g: offline generation, float32 (phase 4's weights), card vs
    # CPU; the paged generates' K2 launches join the kernels line
    ties, k2, lines = gen_parity(torch, model32, card)
    for tag, v in k2.items():
        main_counts[f"paged_decode_{tag}"] = \
            main_counts.get(f"paged_decode_{tag}", 0) + v
    say(f"phase 4g f32 GPT-2 small, {G_PROMPT}-token prompts x {G_NEW} "
        f"new: dense greedy card == CPU and the graph == the eager program "
        f"bitwise; a left-padded batch (lengths 16/9/12/3) == CPU and == "
        f"each prompt alone; the paged generate (dense, int8) == the dense "
        f"one and == CPU, K2 {k2}; W8A16, int8 KV, both through the dense "
        f"program card == CPU; near ties (phase 4's limits x 2 at the "
        f"first difference): {ties or 'none'}")
    for line in lines:
        say(f"phase 4g {line}")
    del model32, params32
    torch.cuda.empty_cache()

    # phase 4f: the bf16 decoder, dense and int8 pools, card vs the same
    # weights in float32 on the CPU; the int8 run's K1 launches are the
    # kernels line's (the bf16 K1's only main path with int8 pools)
    model = GPT2(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    params16 = model.flat_params()
    for kv_dtype in (None, "int8"):
        kernels.reset_launch_counts()
        worst, ties = decoder_parity(torch, cfg, params16, kv_dtype,
                                     BF16_DECODER_REL, rel=True)
        counts = kernels.launch_counts()
        tag = kv_dtype or "dense"
        if counts[f"ragged_stream_{tag}"] == 0 \
                or counts[f"paged_decode_{tag}"] == 0:
            fail(f"phase 4f {tag} bf16: a kernel was not launched {counts}")
        if kv_dtype == "int8":
            main_counts["ragged_stream_int8"] = counts["ragged_stream_int8"]
        say(f"phase 4f decoder {tag} bf16 (card) vs float32 (CPU): max "
            f"logit diff {worst:.3g} of the CPU logits' largest magnitude "
            f"(limit {BF16_DECODER_REL}), near-ties {ties}, launches "
            f"{ {n: v for n, v in counts.items() if v} }")
    del params16
    torch.cuda.empty_cache()

    # phase 4c: training parity, GPT-2 small float32, card vs CPU
    cfg_train = GPT2Config(dropout=0.0)
    t0 = time.perf_counter()
    worst = train_parity(torch, cfg_train)
    say(f"phase 4c train parity f32 B2 S256, 2 AdamW steps: loss rel diff "
        f"{worst['loss']:.3g} (limit 1e-4), worst gradient diff "
        f"{worst['grad']:.3g} of its magnitude (limit 1e-3), worst "
        f"parameter diff {worst['param']:.3g} (limit 4.01e-4), K4/K6/K9 "
        f"12 launches each per step, {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # phase 4d: BERT training parity, BERT-large float32, card vs CPU
    from paddle_tpu_torch.models.bert import BertConfig

    bert_cfg = BertConfig.large()
    bert_cfg.dropout = 0.0
    t0 = time.perf_counter()
    worst = bert_train_parity(torch, bert_cfg)
    say(f"phase 4d BERT-large ({bert_cfg.num_layers} layers) train parity "
        f"f32 B2 S128 lengths 128/77, 2 AdamW steps: loss rel diff "
        f"{worst['loss']:.3g} (limit 1e-4), worst gradient diff "
        f"{worst['grad']:.3g} of its magnitude (limit 1e-3), worst "
        f"parameter diff {worst['param']:.3g} (limit 4.01e-4), K4 bias/K6/"
        f"K9 bias {bert_cfg.num_layers} launches each per step, unbiased "
        f"K4/K9 none, {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # phase 4e: long-context training parity past the switch, card vs CPU
    S = 13312
    cfg_long = GPT2Config(vocab_size=1024, hidden_size=128, num_layers=2,
                          num_heads=2, max_position=S, dropout=0.0)
    for lengths, expect in ((None, TWO_PASS), ([9000], TWO_PASS_BIAS)):
        t0 = time.perf_counter()
        worst = train_parity(torch, cfg_long, b=1, s=S, lengths=lengths,
                             expect=expect, never=FUSED_BWD, phase="4e")
        say(f"phase 4e long-context train parity f32 B1 S{S} "
            f"{'padded to 9000' if lengths else 'unpadded'}, 2 layers, 2 "
            f"AdamW steps: loss rel diff {worst['loss']:.3g} (limit 1e-4), "
            f"worst gradient diff {worst['grad']:.3g} of its magnitude "
            f"(limit 1e-3), worst parameter diff {worst['param']:.3g} "
            f"(limit 4.01e-4), {'/'.join(expect)} "
            f"{cfg_long.num_layers} launches each per step, K9/K9 bias "
            f"none, {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

    # phase 4t: the seq2seq Transformer at WMT base, float32, card vs CPU:
    # training, then decoding (its launches join the kernels line)
    from paddle_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerModel)

    cfg_s2s = TransformerConfig(dropout=0.0)
    t0 = time.perf_counter()
    worst, s2s_counts, s2s_models = s2s_train_parity(torch, cfg_s2s)
    say(f"phase 4t (a) WMT base ({cfg_s2s.num_encoder_layers} + "
        f"{cfg_s2s.num_decoder_layers} layers, d {cfg_s2s.d_model}, ffn "
        f"{cfg_s2s.dim_feedforward}, V {cfg_s2s.tgt_vocab_size}) train "
        f"parity f32 B4 S_src 128 S_tgt 96, label smoothing 0.1, 2 AdamW "
        f"steps: loss rel diff {worst['loss']:.3g} (limit 1e-4), worst "
        f"gradient diff {worst['grad']:.3g} of its magnitude (limit 1e-3), "
        f"worst parameter diff {worst['param']:.3g} (limit "
        f"{2 * S2S_LR * 2 + 1e-6:.3g}); K4/K6/K9 "
        f"{cfg_s2s.num_encoder_layers + cfg_s2s.num_decoder_layers} "
        f"launches each per step, the bias kernels none; padded-source "
        f"logits (lengths 128/100/77/40: K4 bias in the encoder) within "
        f"{worst['logits']:.3g} of their largest magnitude (limit 1e-4); "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    near, counts, s2s_q1, outs = s2s_decode_parity(
        torch, s2s_models[DEV], s2s_models["cpu"], cfg_s2s)
    for n, v in counts.items():
        s2s_counts[n] += v
    say(f"phase 4t (b) f32 decoding, 8 sources x 64 tokens, max_len 64: "
        f"greedy cached and uncached and beam 4 (length penalty 0.6, "
        f"{outs['beam'].shape[1]} tokens) on the card == the CPU's but for "
        f"near ties (row, token, CPU margin < {S2S_NEAR}): "
        f"{near or 'none'}; K4 {counts['flash_fwd']} launches over the "
        f"three runs, {s2s_q1} of them at Sq = 1; the cached greedy run "
        f"{cfg_s2s.num_encoder_layers} + "
        f"{2 * cfg_s2s.num_decoder_layers} x {outs['greedy'].shape[1] - 1};"
        f" {time.perf_counter() - t0:.1f} s")
    del s2s_models, outs
    torch.cuda.empty_cache()

    # phase 5g: the decode graph against the eager loop, GPT-2 small bf16
    # (phase 4f's weights) and its W8A16 packing, outside the server
    t0 = time.perf_counter()
    host = graph_parity(torch, model, card)
    say(f"phase 5g graph vs eager: weights bf16/w8a16 x pools dense/int8 x "
        f"greedy/sampled/penalties x k 1/4/8 ({len(host)} cases, 8 slots): "
        f"tokens, stops, counts and pools bitwise equal over a capture and "
        f"a replay; a replay's launches equal the eager loop's; no host "
        f"sync in a replay; {time.perf_counter() - t0:.1f} s")
    for (w, kv, mname) in sorted({key[:3] for key in host}):
        say(f"phase 5g host us per dispatch {w} {kv} {mname}, eager -> graph"
            f" (wall ms to a synchronize, eager -> graph): " + "; ".join(
                f"k={k} {host[(w, kv, mname, k)][0]:.0f} -> "
                f"{host[(w, kv, mname, k)][1]:.0f} us "
                f"({host[(w, kv, mname, k)][2]:.3f} -> "
                f"{host[(w, kv, mname, k)][3]:.3f} ms)" for k in (1, 4, 8))
            + f" [{card}]")

    # phase 5: serving, GPT-2 small bf16 (phase 4f's weights); every decode
    # dispatch one graph replay
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, cfg.vocab_size,
                           (int(rng.randint(64, 769)),)).astype(np.int32)
               for _ in range(16)]
    main_counts["ragged_stream_dense"] = 0
    main_counts.setdefault("paged_decode_dense", 0)  # 4g's paged generates
    served = {}
    for k in (1, 8):
        st, counts, peak, outs, extra = serve(torch, model, prompts, k,
                                              profile=True)
        served[k] = (st, outs, extra)
        for n in ("ragged_stream_dense", "paged_decode_dense"):
            main_counts[n] += counts[n]
        say(f"phase 5 serving k={k}: tokens_per_sec "
            f"{st['tokens_per_sec']:.1f} ttft p50/p99 "
            f"{st['ttft_p50_ms']:.1f}/{st['ttft_p99_ms']:.1f} ms itl "
            f"p50/p99 {st['itl_p50_ms']:.2f}/{st['itl_p99_ms']:.2f} ms "
            f"requests {st['requests']} new_tokens {st['new_tokens']} "
            f"prefill_dispatches {st['prefill_dispatches']} decode "
            f"dispatches {st['decode_steps']} graph replays "
            f"{st['decode_graph_replays']} (captures "
            f"{st['decode_graph_captures']}) launches K1 "
            f"{counts['ragged_stream_dense']} K2 "
            f"{counts['paged_decode_dense']} max_memory_allocated "
            f"{peak / 2**20:.0f} MiB; "
            f"{idle_text(extra, st, k, cfg.num_layers)} [{card}]")
    greedy_k1 = served[1][0]
    params_cpu = {k: v.float().cpu() for k, v in model.flat_params().items()}
    ties = 0
    for p, a, b in zip(prompts, served[1][1], served[8][1]):
        if not np.array_equal(a, b):
            if not near_tie_rule(torch, params_cpu, cfg, a, b, p.size,
                                 phase="5"):
                fail("phase 5: greedy tokens differ between k=1 and k=8 "
                     "beyond phase 4f's near-tie rule")
            ties += 1
    r18 = served[8][0]["tokens_per_sec"] / max(greedy_k1["tokens_per_sec"],
                                               1e-9)
    say(f"phase 5 k=8 vs k=1: tokens_per_sec {r18:.3f}x; greedy tokens "
        f"{len(prompts) - ties} of {len(prompts)} requests identical, {ties} "
        f"differ at a near tie (phase 4f's rule) [{card}]")
    del params_cpu

    # phase 5s: the same traffic, every request sampled (this slice's
    # main path: its K1/K2 launches join the kernels line)
    from paddle_tpu_torch.sampling import SamplingParams

    sampling = [SamplingParams(temperature=0.8, top_p=0.95, seed=1000 + i)
                for i in range(len(prompts))]
    st, counts, peak, _outs, extra = serve(torch, model, prompts, 1,
                                           sampling, profile=True)
    if st["sampling_sampled_dispatches"] != st["decode_steps"]:
        fail(f"phase 5s: {st['sampling_sampled_dispatches']} of "
             f"{st['decode_steps']} decode dispatches sampled")
    for n in ("ragged_stream_dense", "paged_decode_dense"):
        main_counts[n] += counts[n]
    g = greedy_k1
    say(f"phase 5s serving k=1 sampled (temperature 0.8, top-p 0.95): "
        f"tokens_per_sec {st['tokens_per_sec']:.1f} (greedy "
        f"{g['tokens_per_sec']:.1f}) ttft p50/p99 {st['ttft_p50_ms']:.1f}/"
        f"{st['ttft_p99_ms']:.1f} ms (greedy {g['ttft_p50_ms']:.1f}/"
        f"{g['ttft_p99_ms']:.1f}) itl p50/p99 {st['itl_p50_ms']:.2f}/"
        f"{st['itl_p99_ms']:.2f} ms (greedy {g['itl_p50_ms']:.2f}/"
        f"{g['itl_p99_ms']:.2f}) requests {st['requests']} new_tokens "
        f"{st['new_tokens']} prefill_dispatches {st['prefill_dispatches']} "
        f"decode dispatches {st['decode_steps']} graph replays "
        f"{st['decode_graph_replays']} launches K1 "
        f"{counts['ragged_stream_dense']} K2 {counts['paged_decode_dense']}"
        f" max_memory_allocated {peak / 2**20:.0f} MiB; "
        f"{idle_text(extra, st, 1, cfg.num_layers)} [{card}]")
    cost = sampler_cost(torch)
    for name, (ms, launches, host_us, store_us) in cost.items():
        say(f"phase 5s sampler {name} 8 x 50257: device {ms:.4f} ms and "
            f"{launches:.0f} kernel launches per decode step (profiler), "
            f"host {host_us:.1f} us per call, store step_args host "
            f"{store_us:.1f} us [{card}]")

    # phase 5w: W8A16 weights. (a) float32, card vs CPU; (b) bf16 on phase
    # 5's traffic at k = 1 (its K1/K2 launches join the kernels line)
    t0 = time.perf_counter()
    model32 = GPT2(cfg, seed=0, dtype=torch.float32, device=DEV)
    for kv, (worst, dties, sties, n_tok) in w8_serving_parity(
            torch, model32, card).items():
        say(f"phase 5w (a) W8A16 f32 {kv} pool: decoder max logit diff "
            f"{worst:.3g} (phase 4's limit {2e-3 if kv == 'dense' else 2e-2}"
            f"), near-ties {dties}; served 8 requests x 16 tokens card vs "
            f"CPU: {8 - sties} identical, {sties} differ at a near tie "
            f"({n_tok} tokens)")
    del model32
    torch.cuda.empty_cache()
    st, counts, peak, _outs, extra = serve(torch, model, prompts, 1,
                                           profile=True,
                                           quantization="w8a16")
    for n in ("ragged_stream_dense", "paged_decode_dense"):
        main_counts[n] += counts[n]
    g, gx = greedy_k1, served[1][2]
    say(f"phase 5w (b) serving k=1 bf16 W8A16: tokens_per_sec "
        f"{st['tokens_per_sec']:.1f} (bf16 {g['tokens_per_sec']:.1f}) itl "
        f"p50/p99 {st['itl_p50_ms']:.2f}/{st['itl_p99_ms']:.2f} ms (bf16 "
        f"{g['itl_p50_ms']:.2f}/{g['itl_p99_ms']:.2f}) ttft p50 "
        f"{st['ttft_p50_ms']:.1f} ms (bf16 {g['ttft_p50_ms']:.1f}) param "
        f"bytes {extra['param_bytes']} (bf16 {gx['param_bytes']}, "
        f"{extra['param_bytes'] / gx['param_bytes']:.3f}x) decode "
        f"dispatches {st['decode_steps']} graph replays "
        f"{st['decode_graph_replays']} launches K1 "
        f"{counts['ragged_stream_dense']} K2 {counts['paged_decode_dense']}"
        f" max_memory_allocated {peak / 2**20:.0f} MiB; "
        f"{idle_text(extra, st, 1, cfg.num_layers)}; "
        f"{time.perf_counter() - t0:.1f} s [{card}]")

    # phase 5p: the prefix cache on the serving path: (b) the copies, (a)
    # parity in float32 (phase 4's weights), (c) shared-prefix serving in
    # bf16; their K1/K2 launches join the kernels line
    t0 = time.perf_counter()
    copy_checks(torch, card)
    pool_costs(torch, card)
    model32 = GPT2(cfg, seed=0, dtype=torch.float32, device=DEV)
    for n, v in prefix_parity(torch, model32, card).items():
        main_counts[n] = main_counts.get(n, 0) + v
    del model32
    torch.cuda.empty_cache()
    for n, v in shared_prefix_serving(torch, model, rng, card).items():
        main_counts[n] += v
    say(f"phase 5p: {time.perf_counter() - t0:.1f} s")

    # phase 5v: speculation and the unified round. (k) K1 on verify
    # streams; (a) float32 parity card vs CPU; (b) bf16 serving (its
    # K1/K2 launches join the kernels line, its verify-stream K1 launches
    # are the verify rows')
    t0 = time.perf_counter()
    vrows = {}
    for quant in (False, True):
        tag = "int8" if quant else "dense"
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            bf = dtype == torch.bfloat16
            r = verify_case(torch, timer, quant, dtype, 51 + quant, bf)
            if not r["ok"]:
                fail(f"phase 5v (k) {tag} {dtype}: K1 disagrees with "
                     f"verify_window_attention_plain (max abs err "
                     f"{r['max_abs_err']:.3g}, atol=rtol={r['tol']}; pad "
                     f"rows must be zeros)")
            if not r["bitwise"]:
                fail(f"phase 5v (k) {tag} {dtype}: two launches differ")
            errs.append(f"{'bf16' if bf else 'f32'} {r['max_abs_err']:.3g}")
            if bf:
                vrows[f"ragged_stream_verify_{tag}"] = r
        r = vrows[f"ragged_stream_verify_{tag}"]
        say(f"phase 5v (k) ragged_stream_{tag} on a verify stream P{V_P} x "
            f"W{V_K + 1} H12 Dh64 BS16 (contexts 64-1024, pad rows, a "
            f"padding row; sum (pos+1) {r['flops'] // (4 * 12 * 64)}, "
            f"{r['bytes'] / 1e6:.2f} MB): within tolerance of "
            f"verify_window_attention_plain on rows with pos >= 0 (max abs "
            f"err {', '.join(errs)}), pad rows zeros, bitwise over two "
            f"launches; key passes per 64-row tile {r['passes']}; kernel "
            f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms (profiler), "
            f"wrapper host {r['host_ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, library (SDPA, gather excluded) {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}); share of the "
            f"bound {r['bound_ms'] / r['device_ms']:.3f} (device) [{card}]")
    model32 = GPT2(cfg, seed=0, dtype=torch.float32, device=DEV)
    cases = graph_program_parity(torch, model32)
    say(f"phase 5v (a) graph vs eager, f32 GPT-2 small, 8 slots, K {V_K}: "
        f"packed_verify and the window round (carry chained) x dense/int8 x "
        f"greedy/sampled+penalties ({cases} cases): outputs, counts, carries "
        f"and pools bitwise over a capture and a replay; a replay's launches "
        f"equal the eager dispatch's (K1 once a layer); no host sync in a "
        f"replay")
    for name, (st, counts) in spec_parity(torch, model32, card).items():
        sp, rd = st["speculation"], st["rounds"]
        say(f"phase 5v (a) f32 {name}: 8 requests x {V_NEW} tokens (greedy, "
            f"sampled, penalties) card == CPU == speculation off; "
            f"acceptance_rate {sp['acceptance_rate']:.4f} verify dispatches "
            f"{sp['verify_dispatches']} (replays "
            f"{st['verify_graph_replays']}) rounds {rd['rounds']} "
            f"dispatches_per_round {rd['dispatches_per_round']:.3f} mixed "
            f"{rd['mixed_rounds']} window replays "
            f"{st['round_graph_replays']}"
            + ("; every async dispatch under set_sync_debug_mode('error')"
               if rd["async"] else "") + f" [{card}]")
    del model32
    torch.cuda.empty_cache()
    launches, verify_launches, _cost = spec_serving(torch, model, card)
    for n, v in launches.items():
        main_counts[n] += v
    say(f"phase 5v: {time.perf_counter() - t0:.1f} s")

    # phase 6g: offline generation in bf16 (phase 4f's weights). (a)
    # bench.py's decode axis through the dense graph and the paged
    # generate (its K2 launches join the kernels line); (b) the padded
    # batcher over an exported artifact beside phase 5's paged k = 1
    t0 = time.perf_counter()
    rows6, k2 = gen_decode_axis(torch, model)
    for tag, v in k2.items():
        main_counts[f"paged_decode_{tag}"] += v
    for (mode, path), r in rows6.items():
        idle = "idle share not measured (no device time traced)" \
            if r["idle"] is None else (
                f"device busy {r['busy_ms']:.1f} of {r['wall_ms']:.1f} ms, "
                f"idle share {r['idle']:.3f}")
        step = "not measured (T192 <= T64: timer noise)" \
            if r["step_ms"] is None else (
                f"{r['step_ms']:.4f} tokens_per_sec {r['tok_s']:.1f}")
        say(f"phase 6g (a) decode axis B{D_BATCH} prompt {D_PROMPT} "
            f"{mode} {path}: ms_per_token_step {step} "
            f"(T{D_NEW} {r['full_ms']:.2f} ms, T{D_SHORT} "
            f"{r['short_ms']:.2f} ms) "
            f"max_memory_allocated {r['peak'] / 2**20:.0f} MiB; profiled "
            f"{D_SHORT}-token call: {idle}, {r['per_step']:.1f} device "
            f"kernels and copies a token step [{card}]")
    st, _outs, caps, artifact = gen_padded_batcher(torch, model, prompts)
    g = greedy_k1
    say(f"phase 6g (b) padded batcher (GenerationServer over an exported "
        f"bf16 artifact, B 8, prompt_len 768, 32 new; {caps} graph "
        f"captures): tokens_per_sec {st['tokens_per_sec']:.1f} latency "
        f"p50/p99 {st['p50_ms']:.1f}/{st['p99_ms']:.1f} ms batch_fill "
        f"{st['batch_fill']:.3f} batches {st['batches']} requests "
        f"{st['requests']}; phase 5's paged k=1 in this call: "
        f"tokens_per_sec {g['tokens_per_sec']:.1f} latency p50/p99 "
        f"{g['p50_ms']:.1f}/{g['p99_ms']:.1f} ms; padded / "
        f"paged {st['tokens_per_sec'] / g['tokens_per_sec']:.3f}x; "
        f"{time.perf_counter() - t0:.1f} s [{card}]")

    # phase 5r: fault-tolerant, observable serving (its K1/K2 launches join
    # the kernels line)
    for n, v in reliability_phase(torch, model, prompts, card,
                                  artifact).items():
        main_counts[n] += v
    del artifact

    # phase 5f: the serving front door (its K1/K2 launches join the
    # kernels line)
    for n, v in frontdoor_phase(torch, model, prompts, card).items():
        main_counts[n] += v

    del model
    torch.cuda.empty_cache()

    # phase 6: training throughput, GPT-2 small, bf16 on float32 masters
    steps = 5
    tr = train_throughput(torch, cfg_train, steps=steps)
    losses = tr["losses"]
    if not all(np.isfinite(losses)):
        fail(f"phase 6: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"phase 6: loss did not fall ({losses[0]} -> {losses[-1]})")
    for n in FLASH:
        want = cfg_train.num_layers * steps
        if tr["counts"][n] != want:
            fail(f"phase 6: {n} launched {tr['counts'][n]} times in "
                 f"{steps} steps, expected {want}")
        main_counts[n] = tr["counts"][n]
    phase6_ms = tr["ms_per_step"]
    say(f"phase 6 training B16 S1024 bf16/f32-master AdamW: tokens_per_sec "
        f"{tr['tokens_per_sec']:.1f} ms_per_step {tr['ms_per_step']:.2f} "
        f"(wall {tr['wall_s']:.2f} s for {steps} steps) "
        f"max_memory_allocated {tr['peak'] / 2**20:.0f} MiB loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} launches "
        f"{ {n: tr['counts'][n] for n in FLASH} } [{card}]")
    torch.cuda.empty_cache()

    # phase 6b: BERT-large training on padded batches, bf16 on f32 masters;
    # 13 measured steps, so the loss is read past its early spike
    steps = 13
    tr = bert_train_throughput(torch, bert_cfg, steps=steps)
    losses = tr["losses"]
    if not all(np.isfinite(losses)):
        fail(f"phase 6b: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"phase 6b: loss did not fall ({losses[0]} -> {losses[-1]})")
    for n in FLASH_BIAS:
        want = bert_cfg.num_layers * steps
        if tr["counts"][n] != want:
            fail(f"phase 6b: {n} launched {tr['counts'][n]} times in "
                 f"{steps} steps, expected {want}")
    for n in ("flash_fwd_bias", "flash_bwd_bias", "flash_delta"):
        main_counts[n] = main_counts.get(n, 0) + tr["counts"][n]
    say(f"phase 6b BERT-large training B16 S512 (padded; {tr['real_tokens']} "
        f"real tokens a step) bf16/f32-master AdamW: tokens_per_sec "
        f"{tr['tokens_per_sec']:.1f} ms_per_step {tr['ms_per_step']:.2f} "
        f"max_memory_allocated {tr['peak'] / 2**20:.0f} MiB loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} launches "
        f"{ {n: tr['counts'][n] for n in FLASH_BIAS} } unbiased "
        f"{ {n: tr['counts'][n] for n in ('flash_fwd', 'flash_bwd')} } "
        f"[{card}]")
    torch.cuda.empty_cache()

    # phase 6c: long-context GPT-2 small training, through K7/K8 (bias)
    cfg_16k = GPT2Config(max_position=16384, dropout=0.0)
    for b, lengths, steps, names in ((1, None, 3, TWO_PASS),
                                     (2, [16384, 10240], 2, TWO_PASS_BIAS)):
        tr = train_throughput(torch, cfg_16k, batch_size=b, seq=16384,
                              warm=1, steps=steps, lengths=lengths)
        losses = tr["losses"]
        tag = f"B{b} S16384" + (" padded to 16384/10240" if lengths else "")
        if not all(np.isfinite(losses)):
            fail(f"phase 6c {tag}: non-finite loss {losses}")
        for n in names + FUSED_BWD:
            want = cfg_16k.num_layers * steps if n in names else 0
            if tr["counts"][n] != want:
                fail(f"phase 6c {tag}: {n} launched {tr['counts'][n]} "
                     f"times in {steps} steps, expected {want}")
        for n in names:
            main_counts[n] = main_counts.get(n, 0) + tr["counts"][n]
        say(f"phase 6c long-context training {tag} bf16/f32-master AdamW: "
            f"tokens_per_sec {tr['tokens_per_sec']:.1f} ms_per_step "
            f"{tr['ms_per_step']:.2f} max_memory_allocated "
            f"{tr['peak'] / 2**20:.0f} MiB losses "
            f"{' '.join(f'{x:.4f}' for x in losses)} launches "
            f"{ {n: tr['counts'][n] for n in names + FUSED_BWD} } [{card}]")
        torch.cuda.empty_cache()

    # phase 6t: the seq2seq Transformer at WMT base, bf16 on float32
    # masters: training at the published dropout 0.1 (dense attention),
    # then bf16 greedy and beam decoding (K4 at Sq = 1)
    cfg_pub = TransformerConfig()
    steps = 5
    tr = s2s_train_throughput(torch, cfg_pub, steps=steps)
    losses = tr["losses"]
    if not all(np.isfinite(losses)):
        fail(f"phase 6t: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"phase 6t: loss did not fall ({losses[0]} -> {losses[-1]})")
    for n in FLASH + FLASH_BIAS:
        if tr["counts"][n]:
            fail(f"phase 6t: {n} launched at dropout 0.1 {tr['counts']}")
    say(f"phase 6t (a) WMT base training B32 S_src 128 S_tgt 128 bf16/"
        f"f32-master AdamW, dropout 0.1 (dense attention), label smoothing "
        f"0.1: target tokens_per_sec {tr['tokens_per_sec']:.1f} ms_per_step "
        f"{tr['ms_per_step']:.2f} (host {tr['wall_ms']:.2f}) "
        f"max_memory_allocated {tr['peak'] / 2**20:.0f} MiB loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; device busy "
        f"{tr['busy_ms']:.2f} ms a step (profiler), idle share "
        f"{tr['idle']:.3f} [{card}]")
    del tr
    torch.cuda.empty_cache()
    model16 = wmt_embeddings(torch, TransformerModel(cfg_s2s, device=DEV))
    model16.to(torch.bfloat16).eval()
    src16 = torch.from_numpy(np.random.RandomState(43).randint(
        2, cfg_s2s.src_vocab_size, (32, 64))).to(DEV)
    per_step = 2 * cfg_s2s.num_decoder_layers
    for name, fn in (("greedy", lambda m, s, n: m.greedy_decode(s, n)),
                     ("beam 4", lambda m, s, n: m.beam_search_decode(
                         s, 4, n, 0.6))):
        r = s2s_decode_throughput(torch, model16, src16, 64, fn)
        if r["q1"] != per_step * r["steps"] or r["dense"] or \
                r["counts"]["flash_fwd"] != r["q1"] + \
                cfg_s2s.num_encoder_layers:
            fail(f"phase 6t {name}: {r['counts']['flash_fwd']} K4 launches, "
                 f"{r['q1']} at Sq = 1 (expected {per_step} x {r['steps']} "
                 f"and the encoder's {cfg_s2s.num_encoder_layers}), "
                 f"{r['dense']} dense-path calls")
        for n, v in r["counts"].items():
            s2s_counts[n] += v
        s2s_q1 += r["q1"]
        say(f"phase 6t (b) bf16 {name} decoding, 32 sources x 64 tokens, "
            f"max_len 64 ({r['steps']} steps): ms_per_decode_step "
            f"{r['ms_per_step']:.3f} output tokens_per_sec "
            f"{r['tokens_per_sec']:.1f}; K4 {r['counts']['flash_fwd']} "
            f"launches ({r['q1']} at Sq = 1), dense path none; K4 device "
            f"{r['k4_ms']:.2f} ms of busy {r['busy_ms']:.2f} ms (share "
            f"{r['k4_share']:.3f}), idle share {r['idle']:.3f} [{card}]")
    del model16
    torch.cuda.empty_cache()
    for n, v in s2s_counts.items():
        if v:
            main_counts[n] = main_counts.get(n, 0) + v

    # phases 4h and 6h: parallel training, 16 ranks on the card over gloo
    # (their main-path launches, counted in the ranks, join the kernels line)
    for n, v in hybrid_phase(torch, card, phase6_ms).items():
        main_counts[n] = main_counts.get(n, 0) + v

    # phase 4k: the fleet's strategy layer, 2 ranks on the card over gloo
    # (their K4/K6/K9 launches join the kernels line)
    for n, v in fleet_phase(torch, card).items():
        main_counts[n] = main_counts.get(n, 0) + v

    # phase 5d: sharded serving, 2 and 4 ranks on the card over gloo
    # (their K1/K2 launches, counted in the ranks, join the kernels line)
    for n, v in sharded_phase(torch, card, greedy_k1).items():
        main_counts[n] = main_counts.get(n, 0) + v

    # phase 7: the kernels line
    out = []
    for name, replaces in (("ragged_stream_dense", K1_REPLACES),
                           ("ragged_stream_int8", K1_REPLACES),
                           ("paged_decode_dense", K2_REPLACES),
                           ("paged_decode_int8", K2_REPLACES)):
        r = rows[name]
        if main_counts[name] <= 0:
            fail(f"{name} was not launched on the main path")
        src = DECODE_SOURCE if name.startswith("paged_decode") else SOURCE
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": main_counts[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    # K1 on verify streams (5v): the verify case's numbers, launched by
    # 5v (b)'s verify dispatches
    for kv in ("dense", "int8"):
        name = f"ragged_stream_verify_{kv}"
        r = vrows[name]
        n = verify_launches[f"ragged_stream_{kv}"]
        if n <= 0:
            fail(f"{name} was not launched on the main path")
        out.append({"name": name, "route": "cuda", "source": SOURCE,
                    "replaces": K1_REPLACES, "launches": n,
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    for name in FLASH + ("flash_fwd_bias", "flash_bwd_bias") + \
            TWO_PASS[2:] + TWO_PASS_BIAS[2:]:
        r = rows[name]
        if main_counts[name] <= 0:
            fail(f"{name} was not launched on the main path")
        # the rows are timed in bf16: K4, K9, K7 and K8 (bias) run their
        # sm90 units
        src = (DQ_SOURCE if "_bwd_dq" in name else
               FWD_SOURCE if name.startswith("flash_fwd") else
               BWD_SOURCE if name.startswith("flash_bwd") else FLASH_SOURCE)
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": FLASH_REPLACES[name],
                    "launches": main_counts[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    # K4 at one query (the seq2seq cached decode steps of 4t and 6t): 3e's
    # numbers
    r = rows["flash_fwd_decode"]
    if s2s_q1 <= 0:
        fail("flash_fwd_decode was not launched on the main path")
    out.append({"name": "flash_fwd_decode", "route": "cuda",
                "source": FWD_SOURCE, "replaces": FLASH_REPLACES["flash_fwd"],
                "launches": s2s_q1, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]})
    say(json.dumps({"kernels": out}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
