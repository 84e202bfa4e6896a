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
               the card with speculation off, n-gram (K 8), replay (the
               card's speculation-off tokens), the unified round and
               async rounds, and on the CPU with speculation off: every
               server's card tokens == the card's speculation off == the
               CPU's (the CPU's other servers equal its speculation off
               in the tier-1 twins: test_torch_spec_decode.py,
               test_torch_unified_round.py); verify replays == verify
               dispatches, window replays == rounds without prefill rows,
               dispatches_per_round 1.0 with a mixed round, every async
               dispatch under set_sync_debug_mode("error"). (b) bf16 GPT-2
               small (phase 4f's weights), block 16: bench.py's
               speculation axis (bench.py:1655-1700, its on-TPU
               parameters: 16 repetitive prompts picked from 64 by a
               simulated n-gram drafter over continuations recorded by the
               port's plain server, 8 slots, K 8, 64 new tokens, chunk
               512): speculation off, n-gram, replay, int8 pools off and
               n-gram; then its unified axis (bench.py:1758-1800: 16 of
               its 32 prompts of 64-256 tokens from RandomState(17), 128 new
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
  4a. the Paddle 2.0 eager API (after 4d) — a text classifier written as
               a user writes it (`api_classifier`: a `nn.Layer` subclass,
               nn.Embedding(30522, 768) and positions initialised through
               ParamAttr(Normal(0, 0.02)), nn.TransformerEncoder of
               TransformerEncoderLayer(768, 12, 3072, attn_dropout=0),
               mean pooling over the real tokens, nn.Linear(768, 2)),
               built with `ptt.seed` on the default device (the card),
               its weights carried to a CPU copy by state_dict /
               set_state_dict; 2 AdamW steps of the user loop
               (CrossEntropyLoss, loss.backward(), opt.step(),
               opt.clear_grad()) on each, float32 (TF32 off), 2 layers,
               B2 S128: (a) no mask, (b) a [B, 1, 1, S] padding mask
               (lengths 128/77); (c) a Conv2D + BatchNorm2D + MaxPool2D +
               bidirectional LSTM net (`conv_lstm_net`). Phase 4d's limits
               (loss 1e-4, gradients 1e-3 of their magnitude, parameters
               and running statistics 2 · lr · steps); K4 / K6 / K9 in (a)
               and their bias variants in (b) twice a step, the dense path
               never (`DenseSpy`);
  6a. the user loop's throughput (after 6b) — the same classifier, 12
               layers, dropout 0.1, B16 S512 padded at 6b's lengths, under
               (a) `amp.auto_cast()` (bf16, O1: the projections in bf16,
               the attention in float32, the reference's lists) and (b)
               the same with "scaled_dot_product_attention" in
               `custom_white_list` (the attention in bf16), with
               GradScaler and AdamW on float32 parameters: 2 warm and 5
               measured steps; tokens/s, ms a step, peak memory, losses
               (finite; the last below the first measured one), K4 bias /
               K6 / K9 bias 12 x steps (they join the kernels line), no
               unbiased kernel and no dense path, and the idle share of a
               profiled pass of 2 steps;
  4i. the static graph and the deployment path (after 6a;
               `deploy_phase`): (a) `jit.save` of the same classifier (12
               layers, S 512, dropout 0.1, eval) from the card with two
               free batch dims, float32 and bf16 (`amp.auto_cast` with
               the attention in bf16); a fresh process (PREDICTOR_CHILD:
               `paddle_tpu_torch.inference` only, no model class) serves
               both through Config -> create_predictor -> input handles
               -> run -> copy_to_cpu at batches 1, 8 and 32 padded (6b's
               lengths): one CUDA graph a batch shape, its replay bitwise
               the loaded program run eagerly, logits against the eager
               layer in the parent within I_F32_REL of the largest in
               both precisions (the same kernels and aten ops), K4 bias 12 launches a batch and nothing else
               (counted in the process); (b) a static Program at
               BERT-base width (static.data, static.nn.fc / layer_norm,
               the attention op: one flash node), one encoder block at B
               16 x S 512 padded, 3 Adam steps by Executor.run, float32
               on the card (K4 bias, K6, K9 bias 3 each) against float64
               on the CPU from the same weights (loss, step-1 gradients,
               each element's update, and every leaf with a gradient
               moved), then save_inference_model ->
               load_inference_model on the card, logits against the
               Executor's; (c) GPT-2 small float32 through jit.save
               (InputSpec [None, 1024]) and jit.load on the card, logits
               at 1 x 1024 against GPT2.forward, K4 12 launches;
  6i. the Predictor timed (4i (a)'s process): a batch's ms through the
               handle flow (host clock, 20 runs), samples/s, the graph
               replay against the loaded program run eagerly (CUDA
               events), the idle share of 5 profiled runs, the first
               (capturing) run's seconds; the artifacts' sizes;
  4v. paddle.vision and the fluid-era ops (after 4j; `vision_parity_phase`),
               TF32 off: (a) ResNet-50 (1000 classes) at B 2, 224², one
               train step + AdamW (lr 1e-4, wd 0.01) on the card, NCHW
               and NHWC, against NCHW on the CPU from one set of weights:
               float64 — loss 1e-4, every gradient 1e-3 of its leaf,
               BatchNorm buffers 1e-4, parameters 2 lr; float32 — the
               loss, buffers and parameters by the same limits, the
               gradients printed beside the CPU's own float32 step
               against float64 (batch norm's backward at B 2 moves them
               by tenths on either device: not gated); the CPU's NHWC
               step bitwise its NCHW one; (b) the sequence ops, CRF,
               nce, deformable_conv, image_resize,
               fused_multi_head_attention (one dense-path call) and the
               detection chain (yolo_box -> multiclass_nms, roi_align /
               roi_pool, prior_box -> box_coder, generate_proposals),
               card vs CPU: indices and classes equal, floats within 1e-4
               of the largest; (c) Model(resnet18(num_classes=10)).fit,
               2 Momentum steps over Cifar10's synthetic data through
               Compose([Normalize, Transpose]), 2 workers on the card vs
               0 on the CPU: batches bitwise; float64 losses and
               gradients within 4j's limits, float32's first loss;
  4q. paddle.slim and the 1.x pipeline (after 4v; `quant_parity_phase`),
               float32, TF32 off, ResNet-50 at B 2, 224²: (a) codes (a
               float and a tensor scale, per channel), fake_quant values
               and the STE mask of one tensor, card vs CPU bitwise; (b)
               fuse_conv_bn (4 pairs), PostTrainingQuantization (abs_max
               and hist, channel-wise) over 2 batches of
               `paddle.batch(paddle.reader.shuffle(q_reader, 64), 2)`,
               convert: frozen weight codes and scales bitwise, activation
               scales within Q_SCALE_REL, the share of activation codes
               that differ, int8 logits within Q_LOGIT_REL of the CPU's
               largest, top-1 equal but at near ties; (c) QAT, two AdamW
               steps, gated in float64 (losses, parameters, BatchNorm and
               act_scale buffers, gradients), float32 printed; (d)
               text.viterbi_decode [8, 64, 32], paths equal, scores 1e-5;
  6q. quantization timed (after 6v; `quant_throughput_phase`): (a)
               ResNet-50 at 224², fuse_conv_bn + PTQ hist channel-wise,
               int8 inference (`torch._int_mm`, im2col for the convs) at
               B 64 and 256 beside the float32 (TF32 off) and
               amp.auto_cast() bf16 forwards: ms a batch, samples/s, idle
               share, peak memory; (b) `utils.profiler.top_ops` of the
               int8 forward (its top 5 device kernels) and im2col's share
               of im2col + `_int_mm` by CUDA events; (c) QAT at B 64
               float32 through `paddle.batch(reader.buffered(
               reader.shuffle(...), 4), 64)`, 2 warm and 5 measured steps,
               beside the plain float32 step: ms a step, the reader's
               wait, idle share, peak memory, the loss falling;
  6v. bench.py's resnet50 axis (after 6j; `vision_throughput_phase`):
               ResNet-50 at 224², B 128 and 256, NCHW and NHWC,
               amp.auto_cast() (bf16 convolutions, O1) + AdamW on float32
               parameters, random images and labels from RandomState(0);
               2 warm and 5 measured steps: ms a step, samples/s, FLOP/s
               at bench.py's 3 x 4.1e9 a sample beside the 989 TFLOP/s
               peak, peak memory, the idle share of a profiled step,
               finite losses; no kernel of the port on this path;
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
  4e. long-context parity — GPT-2 layout with 2 layers, hidden 128, 1
               head (D 128), vocab 1024, max_position 7168 (7 x 1024,
               past the reference's switch to the two-pass backward at
               S 6554 for D 128; a third of the CPU's attention at S
               13312, D 64), float32 (TF32 off): two AdamW steps on
               the card and on the CPU from the same weights at 1 x 7168
               unpadded, then padded to 4800 tokens (an additive
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
  5m. the serving fleet (after 5f; `serving_fleet_phase`), GPT-2 small
               in bf16 (phase 4f's weights) on phase 5's server with the
               prefix cache on, phase 5's 16 prompts, the odd ones with
               4s's sampling rows; every comparison against a fault-free
               single server of the same call, tokens equal but for near
               ties (greedy: phase 4f's rule; sampled: 5d's draw rule at
               2 x BF16_DECODER_REL of the logits over the temperature).
               (a) FleetRouter over 2 in-process replicas: a fault-free
               pass (tokens/s beside the single server's and phase 5's k
               = 1), then requests 0 and 1 hold their replicas' engines at
               their second token while 2-7 are placed, and the seeded
               replica_kill fires at placement M_KILL_AT (the gate opens
               as the kill begins): failover sessions >= the killed
               replica's mid-stream sessions, the ms from the kill to each
               failed-over session's first token on the survivor (after
               the killed engine stopped), K1/K2 launched. (b) a planned
               migration of one live session (held at token
               M_MIGRATE_AT until the export is queued), dense and int8
               pools: the target's prefills unchanged and a resume, the
               tokens equal, the dense wire bytes against the raw bytes
               at the pool's width, the int8 payload bit for bit through
               the wire codec, the export / wire / import ms. (c) three
               worker subprocesses spawned in parallel on the card
               (`RemoteReplica.spawn`, bf16 weights from an npz written to
               a temporary directory, warm_buckets before the handshake;
               spawn seconds), each one's K1/K2 counts read from its
               /stats after the spawn: a pass of 8 requests on w0 and w1
               with one live migration over the wire; then (d)
               DisaggRouter from w0 (prefill) to w1 (decode), 4 requests:
               handoffs >= 1, w1's K2 launches over the pass > 0; then a
               pass of 4 requests on the victim wk and w0: wk runs
               M_STALL_PLAN (it sleeps at its third dispatch), is found
               holding >= 1 session mid-decode (0 < tokens < budget), and
               is SIGKILLed: every session completes on w0. The K1 and K2
               launches of w0 and w1 over the passes (their /stats less
               the counts after the spawn) > 0, wk's K1 before the kill >
               0; the workers are terminated on
               the way out, also on a failure;
  4h. parallel training (after 6t), float32, TF32 off: 16 ranks spawned
               on the card (`hybrid_phase`; init_parallel_env resolves
               gloo: NCCL refuses two ranks on one device), each with a
               hard limit (H_TIMEOUT: the ranks are killed and the phase
               fails). The parent first computes reference_loss of the
               hybrid GPT-2 small (hidden 768, 12 heads, vocab 50257
               padded to 50258; depth cut to 4 of its 12 layers,
               `H_MODEL`, for (b)-(d), (g) and 6h) at B 8 x S 1024, its gradients and
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
               GPT-2 small widths at 4 of its 12 layers (`K_LAYERS`),
               B 4 x S 1024: its gradients at the initial
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
               multi-GPU number); (b) at 2 layers, B 2 x S 128: localsgd
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
               max_memory_allocated a rank; bf16: (e) tp 2 on
               D_E_PROMPTS of phase 5's prompts (warm pass, measured
               pass, rank 0 profiled):
               tokens/s, TTFT, ITL, rank 0's idle share beside phase 5's
               k = 1 — ranks time-sharing one card over gloo: not a
               multi-GPU number; (d) tp 2 int8 collectives on the same
               D_E_PROMPTS prompts, tokens equal (e)'s but for phase
               4f's near ties,
               wire bytes <= D_WIRE_RATIO of the bf16 wire;
  7. the kernels line (JSON; each kernel's launches summed over the
     main-path runs that reach it: phases 5, 5s, 5w, 5p, 5v (b), 5r, 5f,
     5m ((a), (b) and the workers' /stats), 4b, 4f, 4g, 6g (a), 6, 6b,
     6a, 4i (the Predictor's process, the Executor, the loaded
     programs), 6j, 6c, 4t, 6t, 4h/6h's, 4k's and 5d's ranks ((a), (b),
     (c)); the `ragged_stream_verify_*` rows
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
        # a window whose kernel records the profiler lost (no key of the
        # kernels at all) is profiled again, at most twice
        for _ in range(3):
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
            if us > 0:
                return us / 1e3 / reps
        fail(f"the profiler recorded no device time for {pattern.pattern} "
             f"in 3 windows")


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


# ---- phases 4a / 6a: the Paddle 2.0 eager API, a user's training loop -----

A_VOCAB, A_HIDDEN, A_HEADS, A_FFN = 30522, 768, 12, 3072  # BERT-base width
A_LR = 1e-4


def api_classifier(ptt, n_layers, dropout, max_len=512):
    """A text classifier written the way a Paddle user writes one against
    the 2.0 API: token and position embeddings (normal(0, 0.02), through
    ParamAttr), nn.TransformerEncoder at BERT-base width with
    attn_dropout 0 (attention dropout takes the dense path), mean
    pooling over the real tokens, nn.Linear(768, 2). Built on the
    default device."""
    nn = ptt.nn

    class TextClassifier(nn.Layer):
        def __init__(self):
            super().__init__()
            init = ptt.ParamAttr(initializer=nn.initializer.Normal(0.0, 0.02))
            self.embed = nn.Embedding(A_VOCAB, A_HIDDEN, weight_attr=init)
            self.pos = nn.Embedding(max_len, A_HIDDEN, weight_attr=init)
            layer = nn.TransformerEncoderLayer(
                A_HIDDEN, A_HEADS, A_FFN, dropout=dropout, attn_dropout=0.0,
                activation="gelu")
            self.encoder = nn.TransformerEncoder(layer, n_layers)
            self.head = nn.Linear(A_HIDDEN, 2)

        def forward(self, ids, mask=None):
            """ids [B, S]; mask [B, S], 1 on real tokens (None: none)."""
            pos = ptt.unsqueeze(ptt.arange(ids.shape[1]), 0)
            h = self.embed(ids) + self.pos(pos)
            attn = None if mask is None else \
                ptt.cast(ptt.unsqueeze(mask, [1, 2]), "bool")  # [B,1,1,S]
            h = self.encoder(h, attn)
            if mask is None:
                return self.head(ptt.mean(h, axis=1))
            m = ptt.unsqueeze(ptt.cast(mask, "float32"), -1)
            return self.head(ptt.sum(h * m, axis=1) / ptt.sum(m, axis=1))

    return TextClassifier()


def conv_lstm_net(ptt):
    """Phase 4a (c): Conv2D + BatchNorm2D + MaxPool2D, then an LSTM over
    the rows and a Linear head — the rest of the API on the card."""
    nn = ptt.nn

    class ConvLSTM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 16, 3, padding=1)
            self.bn = nn.BatchNorm2D(16)
            self.pool = nn.MaxPool2D(2, 2)
            self.lstm = nn.LSTM(16 * 8, 32, direction="bidirect")
            self.head = nn.Linear(64, 5)

        def forward(self, x):
            h = self.pool(nn.functional.relu(self.bn(self.conv(x))))
            seq = ptt.reshape(ptt.transpose(h, [0, 2, 1, 3]),
                              [h.shape[0], h.shape[2], -1])
            out, _ = self.lstm(seq)
            return self.head(out[:, -1])

    return ConvLSTM()


class DenseSpy:
    """Counts the dense attention path's calls inside the block."""

    def __enter__(self):
        from paddle_tpu_torch.ops import attention
        self.calls, self._real = 0, attention.dense_attention

        def spy(*a, **k):
            self.calls += 1
            return self._real(*a, **k)

        attention.dense_attention = spy
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import attention
        attention.dense_attention = self._real


def api_step_parity(torch, ptt, build, batch_fn, loss_fn, steps, phase,
                    expect=(), never=()):
    """Phase 4a: the same user model on the card and, with the card's
    initial weights carried over by state_dict / set_state_dict, on the
    CPU; `steps` AdamW steps of the user loop (loss.backward(),
    opt.step(), opt.clear_grad()) on each. Checks each step's loss
    (relative 1e-4), gradients (1e-3 of their magnitude, phase 4d's
    floor), the parameters and buffers after the steps (2 · lr · steps)
    and, on the card, the launches per step: `expect` kernels once a
    layer (n_layers, given by build), `never` ones and the dense path
    not at all. Returns the worst differences."""
    from paddle_tpu_torch.device import device_guard
    from paddle_tpu_torch.ops import kernels

    ptt.seed(23)
    net, n_layers = build()
    with device_guard("cpu"):
        net_cpu, _ = build()
        net_cpu.set_state_dict(net.state_dict())
    sides = {"card": (DEV, net), "cpu": ("cpu", net_cpu)}
    opts = {}
    for key, (d, model) in sides.items():
        with device_guard(d):
            opts[key] = ptt.optimizer.AdamW(
                A_LR, parameters=model.parameters(), weight_decay=0.01)
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for step in range(steps):
        out = {}
        for key, (d, model) in sides.items():
            with device_guard(d):
                args = batch_fn(step)
                kernels.reset_launch_counts()
                with DenseSpy() as dense:
                    loss = loss_fn(model, *args)
                    loss.backward()
                counts = kernels.launch_counts()
                grads = [p.grad.detach().clone() for p in model.parameters()]
                opts[key].step()
                opts[key].clear_grad()
            out[key] = (loss.item(), grads, counts, dense.calls)
        counts, dense_calls = out["card"][2], out["card"][3]
        for n in expect:
            if counts[n] != n_layers:
                fail(f"phase {phase} step {step}: {n} launched {counts[n]} "
                     f"times, expected {n_layers}")
        for n in never:
            if counts[n]:
                fail(f"phase {phase} step {step}: {n} launched {counts}")
        if dense_calls:
            fail(f"phase {phase} step {step}: the dense attention path ran "
                 f"{dense_calls} times")
        rel = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        worst["loss"] = max(worst["loss"], rel)
        if rel > 1e-4:
            fail(f"phase {phase} step {step}: loss {out['card'][0]} vs CPU "
                 f"{out['cpu'][0]} (relative {rel:.3g} > 1e-4)")
        floor = 1e-3 * max(g.abs().max().item() for g in out["cpu"][1])
        for (name, _), a, c in zip(net.named_parameters(), out["card"][1],
                                   out["cpu"][1]):
            r = (a.cpu() - c).abs().max().item() / max(
                c.abs().max().item(), floor)
            worst["grad"] = max(worst["grad"], r)
            if r > 1e-3:
                fail(f"phase {phase} step {step}: gradient {name} differs "
                     f"by {r:.3g} of its magnitude (> 1e-3)")
    limit = 2 * A_LR * steps + 1e-6
    cpu_state = net_cpu.state_dict()
    for name, t in net.state_dict().items():
        diff = (t.cpu().float() - cpu_state[name].float()).abs().max().item()
        worst["param"] = max(worst["param"], diff)
        if diff > limit:
            fail(f"phase {phase}: {name} differs by {diff:.3g} after "
                 f"{steps} steps (> {limit:.3g})")
    return worst


def api_text_batch(ptt, b, s, lengths, seed):
    """(ids [B, S] with pad id 0 past each length, mask [B, S] or None,
    labels [B]) on the default device, from RandomState(seed)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, A_VOCAB, (b, s))
    mask = None
    if lengths is not None:
        real = (np.arange(s)[None] < np.asarray(lengths)[:, None])
        ids = ids * real
        mask = ptt.to_tensor(real.astype(np.int64))
    return (ptt.to_tensor(ids), mask,
            ptt.to_tensor(rs.randint(0, 2, (b,))))


def api_parity_phase(torch, card):
    """Phase 4a: (a) the text classifier at BERT-base width, 2 layers, no
    mask; (b) a padded [B, 1, 1, S] mask; (c) the conv / BatchNorm / pool
    / LSTM net — each card vs CPU over 2 AdamW steps of the user loop,
    float32 (TF32 off)."""
    import paddle_tpu_torch as ptt

    t0 = time.perf_counter()
    ce = ptt.nn.CrossEntropyLoss()

    def text_loss(net, ids, mask, labels):
        return ce(net(ids, mask), labels)

    def build_text():
        return api_classifier(ptt, 2, 0.0), 2

    for tag, lengths, expect, never in (
            ("(a) no mask", None, FLASH, ("flash_fwd_bias",
                                          "flash_bwd_bias")),
            ("(b) padded mask, lengths 128/77", [128, 77], FLASH_BIAS,
             ("flash_fwd", "flash_bwd"))):
        worst = api_step_parity(
            torch, ptt, build_text,
            lambda step: api_text_batch(ptt, 2, 128, lengths, 31 + step),
            text_loss, 2, "4a", expect, never)
        say(f"phase 4a {tag}: user TextClassifier (nn.Embedding "
            f"{A_VOCAB} x {A_HIDDEN} + positions, nn.TransformerEncoder 2 "
            f"x ({A_HIDDEN}, {A_HEADS}, {A_FFN}), mean pooling, nn.Linear "
            f"{A_HIDDEN} -> 2) f32 B2 S128, 2 AdamW steps card vs CPU: loss "
            f"rel diff {worst['loss']:.3g} (limit 1e-4), worst gradient "
            f"diff {worst['grad']:.3g} of its magnitude (limit 1e-3), worst "
            f"parameter diff {worst['param']:.3g} (limit "
            f"{2 * A_LR * 2 + 1e-6:.3g}); {'/'.join(expect)} 2 launches "
            f"each per step, {'/'.join(never)} and the dense path none")

    def conv_loss(net, x, labels):
        return ce(net(x), labels)

    def conv_batch(step):
        rs = np.random.RandomState(41 + step)
        return (ptt.to_tensor(rs.randn(8, 3, 16, 16).astype(np.float32)),
                ptt.to_tensor(rs.randint(0, 5, (8,))))

    worst = api_step_parity(torch, ptt, lambda: (conv_lstm_net(ptt), 0),
                            conv_batch, conv_loss, 2, "4a (c)")
    say(f"phase 4a (c) user Conv2D(3, 16, 3) + BatchNorm2D + MaxPool2D + "
        f"bidirectional LSTM(128, 32) + Linear f32 B8 16x16, 2 AdamW steps "
        f"card vs CPU (BatchNorm in training): loss rel diff "
        f"{worst['loss']:.3g} (limit 1e-4), worst gradient diff "
        f"{worst['grad']:.3g} (limit 1e-3), worst parameter / running "
        f"statistic diff {worst['param']:.3g}; {time.perf_counter() - t0:.1f}"
        f" s [{card}]")


def api_train_throughput(torch, n_layers=12, batch_size=16, seq=512,
                         warm=2, steps=5, profiled=2, white=None):
    """Phase 6a: the user loop at BERT-base width on a padded batch
    (phase 6b's lengths), `amp.auto_cast(custom_white_list=white)` (bf16,
    O1) with GradScaler and AdamW on float32 parameters, dropout 0.1: ms
    a step (CUDA events), tokens/s, peak memory, losses, the measured
    steps' launch counts and dense-path calls, and the idle share of a
    profiled pass."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import kernels

    ptt.seed(29)
    net = api_classifier(ptt, n_layers, 0.1)
    net.train()
    opt = ptt.optimizer.AdamW(A_LR, parameters=net.parameters(),
                              weight_decay=0.01)
    scaler = ptt.amp.GradScaler()
    ce = ptt.nn.CrossEntropyLoss()
    lens = bert_lengths(batch_size, seq)
    ids, mask, labels = api_text_batch(ptt, batch_size, seq, lens, 0)

    def step():
        with ptt.amp.auto_cast(custom_white_list=white):
            loss = ce(net(ids, mask), labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss.detach()

    losses = [step().item() for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()                          # main path
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with DenseSpy() as dense:
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
            "tokens_per_sec": batch_size * seq / (ms / 1e3),
            "real_tokens": int(lens.sum()),
            "peak": torch.cuda.max_memory_allocated(), "counts": counts,
            "dense": dense.calls, "busy_ms": busy / profiled * 1e3,
            "idle": 1 - busy / profiled / wall}


# ---- phases 4j / 6j: the Paddle 2.0 API, part 2 — paddle.Model.fit over
# DataLoader worker processes ------------------------------------------------

J_SEQ, J_TRAIN, J_EVAL = 512, 64, 32   # 6j: padded length, samples
J_BEAM = dict(vocab=1000, embed=128, hidden=256, batch=8, beam=4, steps=16)


def j_dataset(ptt, n, seq, lo, seed):
    """A user's paddle.io.Dataset: n samples of token ids padded with id 0
    past a length uniform in lo..seq (RandomState(seed)), and a label in
    {0, 1}; returns it and the lengths."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(lo, seq + 1, n)
    ids = rs.randint(1, A_VOCAB, (n, seq)) * (np.arange(seq)[None]
                                              < lens[:, None])
    labels = rs.randint(0, 2, (n, 1))

    class PaddedText(ptt.io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return ids[i], labels[i]

    return PaddedText(), lens


def j_network(ptt, n_layers, dropout):
    """api_classifier as a user wraps it for paddle.Model, whose batches
    give the network one input: the padding mask comes from the ids."""
    inner = api_classifier(ptt, n_layers, dropout)

    class PaddedClassifier(ptt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.inner = inner

        def forward(self, ids):
            return self.inner(ids, ptt.cast(ids != 0, "int64"))

    return PaddedClassifier()


def j_spied_model(ptt, net, rec):
    """paddle.Model(net) prepared as a user does (AdamW 1e-4,
    CrossEntropyLoss, Accuracy), with spies that record each step's batch,
    launches, gradients (the fused step's functional_update) and logits."""
    from paddle_tpu_torch.ops import kernels

    opt = ptt.optimizer.AdamW(A_LR, parameters=net.parameters(),
                              weight_decay=0.01)
    real_update = opt.functional_update

    def update(params, grads, state, lr=None, **kw):
        rec["grads"].append({n: g.detach().cpu().clone()
                             for n, g in grads.items()})
        return real_update(params, grads, state, lr=lr, **kw)

    opt.functional_update = update

    class Acc(ptt.metric.Accuracy):
        def compute(self, pred, label, *args):
            rec["logits"].append(pred.detach().cpu().clone())
            return super().compute(pred, label, *args)

    model = ptt.Model(net)
    model.prepare(opt, ptt.nn.CrossEntropyLoss(), Acc())
    real_step = model.train_batch

    def train_batch(inputs, labels=None):
        rec["batches"].append((inputs[0].cpu().clone(),
                               labels[0].cpu().clone()))
        kernels.reset_launch_counts()
        logs = real_step(inputs, labels)
        rec["counts"].append(kernels.launch_counts())
        rec["losses"].append(logs[0][0])
        rec["accs"].append(logs[1]["acc"])
        return logs

    model.train_batch = train_batch
    return model


def model_fit_parity(torch, ptt, tmp):
    """Phase 4j (a)-(c): api_classifier at 2 layers through paddle.Model:
    fit over one epoch of 16 padded samples (B 4, S 128) on the card with
    DataLoader(num_workers=2) and on the CPU with num_workers=0, from one
    seed and the card's initial weights; then save -> load into a fresh
    network -> predict."""
    from paddle_tpu_torch.device import device_guard

    ptt.seed(37)
    net = j_network(ptt, 2, 0.0)
    with device_guard("cpu"):
        net_cpu = j_network(ptt, 2, 0.0)
        net_cpu.set_state_dict(net.state_dict())
    ds, _ = j_dataset(ptt, 16, 128, 32, 41)
    recs, models = {}, {}
    for key, dev, model, workers in (("card", DEV, net, 2),
                                     ("cpu", "cpu", net_cpu, 0)):
        rec = recs[key] = {k: [] for k in ("batches", "counts", "grads",
                                           "logits", "losses", "accs")}
        with device_guard(dev), DenseSpy() as dense:
            models[key] = j_spied_model(ptt, model, rec)
            np.random.seed(43)
            models[key].fit(ds, batch_size=4, epochs=1, shuffle=True,
                            num_workers=workers, verbose=0)
        rec["dense"] = dense.calls
    card, cpu = recs["card"], recs["cpu"]
    steps = len(cpu["losses"])
    if steps != 4 or len(card["losses"]) != steps:
        fail(f"phase 4j: {len(card['losses'])} / {steps} steps, expected 4")
    for i, ((a, la), (b, lb)) in enumerate(zip(card["batches"],
                                               cpu["batches"])):
        if not (torch.equal(a, b) and torch.equal(la, lb)):
            fail(f"phase 4j step {i}: the worker batch on the card differs "
                 f"from the CPU's")
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0, "ties": 0}
    for i in range(steps):
        rel = abs(card["losses"][i] - cpu["losses"][i]) / abs(
            cpu["losses"][i])
        worst["loss"] = max(worst["loss"], rel)
        if rel > 1e-4:
            fail(f"phase 4j step {i}: loss {card['losses'][i]} vs CPU "
                 f"{cpu['losses'][i]} (relative {rel:.3g} > 1e-4)")
        gc = cpu["grads"][i]
        floor = 1e-3 * max(g.abs().max().item() for g in gc.values())
        for n, a in card["grads"][i].items():
            r = (a - gc[n]).abs().max().item() / max(
                gc[n].abs().max().item(), floor)
            worst["grad"] = max(worst["grad"], r)
            if r > 1e-3:
                fail(f"phase 4j step {i}: gradient {n} differs by {r:.3g} "
                     f"of its magnitude (> 1e-3)")
        if card["accs"][i] != cpu["accs"][i]:
            gap = min((lg[:, 0] - lg[:, 1]).abs().min().item()
                      for lg in (card["logits"][i], cpu["logits"][i]))
            if gap >= 1e-4:
                fail(f"phase 4j step {i}: accuracy {card['accs'][i]} vs "
                     f"CPU {cpu['accs'][i]} with no logit pair within 1e-4 "
                     f"(closest {gap:.3g})")
            worst["ties"] += 1
        c = card["counts"][i]
        for n in FLASH_BIAS:
            if c[n] != 2:
                fail(f"phase 4j step {i}: {n} launched {c[n]} times, "
                     f"expected 2 (a layer)")
        if c["flash_fwd"] or c["flash_bwd"]:
            fail(f"phase 4j step {i}: unbiased kernels ran {c}")
    if card["dense"]:
        fail(f"phase 4j: the dense attention path ran {card['dense']} times")
    limit = 2 * A_LR * steps + 1e-6
    cpu_state = net_cpu.state_dict()
    for name, t in net.state_dict().items():
        d = (t.cpu() - cpu_state[name]).abs().max().item()
        worst["param"] = max(worst["param"], d)
        if d > limit:
            fail(f"phase 4j: {name} differs by {d:.3g} after {steps} steps "
                 f"(> {limit:.3g})")
    # (b) save -> load into a fresh network -> predict, bitwise
    path = os.path.join(tmp, "4j")
    models["card"].save(path)
    fresh = ptt.Model(j_network(ptt, 2, 0.0))
    fresh.prepare(ptt.optimizer.AdamW(A_LR,
                                      parameters=fresh.parameters()),
                  ptt.nn.CrossEntropyLoss())
    fresh.load(path)
    a = models["card"].predict(ds, batch_size=4, stack_outputs=True)[0]
    b = fresh.predict(ds, batch_size=4, stack_outputs=True)[0]
    if a.shape != (16, 2) or not np.array_equal(a, b):
        fail(f"phase 4j (b): predict after save -> load differs (max "
             f"{np.abs(a - b).max() if a.shape == b.shape else a.shape})")
    worst["saved"] = sorted(os.listdir(tmp))
    return worst, steps


def beam_parity(torch, ptt):
    """Phase 4j (c): BeamSearchDecoder + dynamic_decode over an LSTMCell
    (beam 4; the output layer scaled x4 so the scores spread) on the card
    and on the CPU with the same weights: the same tokens."""
    from paddle_tpu_torch.device import device_guard

    c = J_BEAM
    ptt.seed(47)
    mods = (ptt.nn.LSTMCell(c["embed"], c["hidden"]),
            ptt.nn.Embedding(c["vocab"], c["embed"]),
            ptt.nn.Linear(c["hidden"], c["vocab"]))
    with torch.no_grad():
        mods[2].weight.mul_(4.0)
    with device_guard("cpu"):
        cpu = (ptt.nn.LSTMCell(c["embed"], c["hidden"]),
               ptt.nn.Embedding(c["vocab"], c["embed"]),
               ptt.nn.Linear(c["hidden"], c["vocab"]))
    for a, b in zip(mods, cpu):
        b.set_state_dict(a.state_dict())
    rs = np.random.RandomState(53)
    h0 = rs.randn(c["batch"], c["hidden"]).astype(np.float32)
    c0 = rs.randn(c["batch"], c["hidden"]).astype(np.float32)
    out = {}
    for key, dev, (cell, emb, head) in (("card", DEV, mods),
                                        ("cpu", "cpu", cpu)):
        dec = ptt.nn.BeamSearchDecoder(cell, 1, 2, c["beam"],
                                       embedding_fn=emb, output_fn=head)
        with torch.no_grad():
            ids, _, lens = ptt.nn.dynamic_decode(
                dec, (torch.from_numpy(h0).to(dev),
                      torch.from_numpy(c0).to(dev)),
                max_step_num=c["steps"], return_length=True)
        out[key] = (ids.cpu(), lens.cpu())
    if not (torch.equal(out["card"][0], out["cpu"][0])
            and torch.equal(out["card"][1], out["cpu"][1])):
        fail("phase 4j (c): beam-search tokens on the card differ from the "
             "CPU's")
    return tuple(out["card"][0].shape)


def model_fit_phase(torch, card):
    """Phase 4j: paddle.Model card vs CPU (a), save / load (b), beam
    search (c)."""
    import tempfile

    import paddle_tpu_torch as ptt

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        worst, steps = model_fit_parity(torch, ptt, tmp)
    shape = beam_parity(torch, ptt)
    say(f"phase 4j (a) paddle.Model(api_classifier, 2 layers, padding mask "
        f"from the ids).fit, f32 B4 S128 (16 samples, lengths 32-128, one "
        f"epoch, {steps} fused AdamW steps), DataLoader(num_workers=2) on "
        f"the card vs num_workers=0 on the CPU: batches bitwise equal, loss "
        f"rel diff {worst['loss']:.3g} (limit 1e-4), worst gradient diff "
        f"{worst['grad']:.3g} of its magnitude (limit 1e-3), worst "
        f"parameter diff {worst['param']:.3g} (limit "
        f"{2 * A_LR * steps + 1e-6:.3g}), accuracies equal ({worst['ties']} "
        f"near ties); {'/'.join(FLASH_BIAS)} 2 launches each per step, "
        f"unbiased and the dense path none")
    say(f"phase 4j (b) Model.save -> Model.load into a fresh network: "
        f"predict bitwise equal ({', '.join(worst['saved'])}); (c) "
        f"BeamSearchDecoder + dynamic_decode over LSTMCell (beam "
        f"{J_BEAM['beam']}, ids {list(shape)}): tokens card == CPU; "
        f"{time.perf_counter() - t0:.1f} s [{card}]")


def model_fit_throughput(torch):
    """Phase 6j: a user's paddle.Model.fit at BERT-base width (12 layers,
    float32 — Model has no amp — dropout 0.1 outside attention) on
    J_TRAIN padded samples (lengths 64..512) with
    fit(batch_size=16, epochs=2, shuffle=True, num_workers=2,
    drop_last=True): ms a step (median of steps 3-8, host clock: a step
    ends on its loss's host read), padded tokens/s, the DataLoader's wait
    between steps, peak memory, launches; then evaluate and predict on
    J_EVAL samples. Two idle shares: within a step (two profiled
    train_batch calls on one batch over the median step) and over fit's
    whole window (a second, profiled fit's device busy time over the
    measured fit's wall, which holds the workers' start at each epoch)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import kernels

    ptt.seed(59)
    net = j_network(ptt, 12, 0.1)
    model = ptt.Model(net)
    model.prepare(ptt.optimizer.AdamW(A_LR, parameters=net.parameters(),
                                      weight_decay=0.01),
                  ptt.nn.CrossEntropyLoss(), ptt.metric.Accuracy())
    train, lens = j_dataset(ptt, J_TRAIN, J_SEQ, 64, 61)
    held, _ = j_dataset(ptt, J_EVAL, J_SEQ, 64, 67)
    marks = {"begin": [], "end": []}

    class Clock(ptt.callbacks.Callback):
        def on_batch_begin(self, mode, step, logs=None):
            marks["begin"].append(time.perf_counter())

        def on_batch_end(self, mode, step, logs=None):
            marks["end"].append(time.perf_counter())
            marks.setdefault("losses", []).append(logs[0][0])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()                          # main path
    with DenseSpy() as dense:
        np.random.seed(71)
        t0 = time.perf_counter()
        model.fit(train, batch_size=16, epochs=2, shuffle=True,
                  num_workers=2, drop_last=True, verbose=0,
                  callbacks=[Clock()])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    fit_counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [(e - b) * 1e3 for b, e in zip(marks["begin"], marks["end"])]
    waits = [(b - e) * 1e3 for e, b in zip(marks["end"][:-1],
                                          marks["begin"][1:])]
    kernels.reset_launch_counts()                          # main path
    res = model.evaluate(held, batch_size=16, num_workers=2)
    eval_counts = kernels.launch_counts()
    kernels.reset_launch_counts()                          # main path
    pred = model.predict(held, batch_size=16, stack_outputs=True)[0]
    pred_counts = kernels.launch_counts()
    ids = torch.from_numpy(np.stack([held[i][0] for i in range(16)]))
    labels = torch.from_numpy(np.stack([held[i][1] for i in range(16)]))
    ids, labels = ids.to(DEV), labels.to(DEV)
    busy = profiled_busy(torch, lambda: [model.train_batch([ids], [labels])
                                         for _ in range(2)])
    # the whole fit window: one more fit as the measured one, profiled;
    # its device busy time over the measured fit's wall
    np.random.seed(71)
    fit_busy = profiled_busy(torch, lambda: model.fit(
        train, batch_size=16, epochs=2, shuffle=True, num_workers=2,
        drop_last=True, verbose=0), host_ops=False)
    ms = statistics.median(step_ms[2:8])
    return {"step_ms": step_ms, "ms": ms, "waits": waits,
            "first_wait": (marks["begin"][0] - t0) * 1e3,
            "fit_busy_s": fit_busy, "fit_idle": 1 - fit_busy / fit_s,
            "tokens_per_sec": 16 * J_SEQ / (ms / 1e3),
            "real_tokens": int(lens.sum()), "peak": peak, "fit_s": fit_s,
            "fit_counts": fit_counts, "eval_counts": eval_counts,
            "pred_counts": pred_counts, "dense": dense.calls,
            "losses": marks["losses"], "eval": res, "pred_shape":
            pred.shape, "pred_finite": bool(np.isfinite(pred).all()),
            "busy_ms": busy / 2 * 1e3, "idle": 1 - busy / 2 / (ms / 1e3)}


# ---- phases 4i / 6i: the static graph, jit.save and the inference
# Predictor ------------------------------------------------------------------

I_SEQ = 512                    # (a), 6i: the classifier's padded length
I_BATCHES = (1, 8, 32)         # (a), 6i: the Predictor's batches
I_REPS = 20                    # 6i: timed runs a batch and a mode
I_F32_REL = 1e-5               # (a), (c): vs the eager layer, of its largest
I_BLOCK = (16, 512)            # (b): the encoder block's B x S
I_LR, I_STEPS = 1e-4, 3        # (b): Adam
I_GRAD_REL = 1e-3              # (b): card f32 vs CPU f64, of a leaf's largest
I_UPDATE_REL = 1e-2            # (b): |card's - CPU's update| / |CPU's|, a leaf
I_LIVE_GRAD = 1e-6             # (b): a leaf whose step-1 gradient exceeds it
I_MOVED = I_LR / 100           # (b): moves at least this far on the CPU
I_LOSS_REL = 1e-4              # (b)

# The Predictor's process (4i (a), 6i): it imports the inference package
# and nothing of the model (the classifier's class lives in this script,
# which it never imports), serves each artifact at I_BATCHES through the
# handle flow (one CUDA graph a batch shape), and prints one JSON line.
PREDICTOR_CHILD = r'''
import json, os, sys, time
import numpy as np
import torch
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.ops import kernels

args = json.loads(sys.argv[1])
data = np.load(args["inputs"])
res = {"artifacts": {}}
outs = {}


def busy_s(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0))
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e6


for tag, prefix in args["artifacts"].items():
    t0 = time.perf_counter()
    pred = create_predictor(Config(prefix + ".pdmodel",
                                   prefix + ".pdiparams"))
    load_s = time.perf_counter() - t0
    names = pred.get_input_names()
    rows = {}
    for b in args["batches"]:
        ids, mask = data[f"ids{b}"], data[f"mask{b}"]

        def handle_run():
            pred.get_input_handle(names[0]).copy_from_cpu(ids)
            pred.get_input_handle(names[1]).copy_from_cpu(mask)
            pred.run()
            return pred.get_output_handle(
                pred.get_output_names()[0]).copy_to_cpu()

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        first = handle_run()                 # the capture (warm-up + graph)
        first_s = time.perf_counter() - t0
        captured = kernels.launch_counts()
        ts = [torch.from_numpy(a).cuda() for a in (ids, mask)]
        with torch.no_grad():
            eager = pred._translated(*ts).cpu().numpy()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(args["reps"]):
            out = handle_run()
        run_ms = (time.perf_counter() - t0) / args["reps"] * 1e3
        counts = kernels.launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with torch.no_grad():
            ev[0].record()
            for _ in range(args["reps"]):
                pred._replay(ts)
            ev[1].record()
            for _ in range(args["reps"]):
                pred._translated(*ts)
            ev[2].record()
        torch.cuda.synchronize()
        replay_ms = ev[0].elapsed_time(ev[1]) / args["reps"]
        eager_ms = ev[1].elapsed_time(ev[2]) / args["reps"]
        t0 = time.perf_counter()
        busy = busy_s(lambda: [handle_run() for _ in range(5)])
        wall = time.perf_counter() - t0
        outs[f"{tag}{b}"] = first
        rows[str(b)] = {
            "bitwise_replay_eager": bool(np.array_equal(first, eager)),
            "repeat_bitwise": bool(np.array_equal(first, out)),
            "first_s": first_s, "run_ms": run_ms, "replay_ms": replay_ms,
            "eager_ms": eager_ms, "idle": 1 - busy / wall,
            "captured": {k: v for k, v in captured.items() if v},
            "per_run": {k: v / args["reps"] for k, v in counts.items()
                        if v}}
    res["artifacts"][tag] = {"rows": rows, "load_s": load_s,
                             "captures": pred.graph_captures,
                             "replays": pred.graph_replays}
leaked = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m.startswith("paddle_tpu_torch.models") or m == "paddle_tpu"
          or m.startswith("paddle_tpu.") or m == "chip_smoke"]
res["leaked"] = leaked
res["device"] = torch.cuda.get_device_name(0)
np.savez(args["outputs"], **outs)
print("PREDICTOR_RESULT " + json.dumps(res))
'''


def i_batch(b, seed):
    """(ids, mask) int64 numpy [b, I_SEQ]: 6b's lengths for b, pad id 0."""
    rs = np.random.RandomState(seed)
    lens = bert_lengths(b, I_SEQ)
    real = np.arange(I_SEQ)[None] < lens[:, None]
    return rs.randint(1, A_VOCAB, (b, I_SEQ)) * real, real.astype(np.int64)


def i_eager(torch, ptt, net, ids, mask, bf16):
    """The eager layer's logits on the card (under the export's amp)."""
    import contextlib
    amp = ptt.amp.auto_cast(custom_white_list=[
        "scaled_dot_product_attention"]) if bf16 else contextlib.nullcontext()
    with torch.no_grad(), amp:
        return net(torch.from_numpy(ids).to(DEV),
                   torch.from_numpy(mask).to(DEV)).float().cpu().numpy()


def i_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def predictor_parity(torch, tmp):
    """Phase 4i (a): jit.save of the BERT-base-width classifier (12
    layers, S 512) from the card, float32 and bf16 (auto_cast with the
    attention in bf16); a fresh process serves both through the Predictor
    at I_BATCHES (module constant PREDICTOR_CHILD). Returns (the child's
    result, the artifacts' sizes, save seconds)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.static import InputSpec

    ptt.seed(31)
    net = api_classifier(ptt, 12, 0.1)
    net.eval()
    spec = [InputSpec([None, I_SEQ], "int64")] * 2
    arts, sizes, save_s = {}, {}, {}
    for tag in ("f32", "bf16"):
        prefix = os.path.join(tmp, f"classifier_{tag}")
        t0 = time.perf_counter()
        if tag == "bf16":
            with ptt.amp.auto_cast(custom_white_list=[
                    "scaled_dot_product_attention"]):
                ptt.jit.save(net, prefix, input_spec=spec)
        else:
            ptt.jit.save(net, prefix, input_spec=spec)
        save_s[tag] = time.perf_counter() - t0
        arts[tag] = prefix
        sizes[tag] = (os.path.getsize(prefix + ".pdmodel"),
                      os.path.getsize(prefix + ".pdiparams"))
    batches = {}
    for b in I_BATCHES:
        batches[f"ids{b}"], batches[f"mask{b}"] = i_batch(b, 300 + b)
    np.savez(os.path.join(tmp, "inputs.npz"), **batches)
    args = {"artifacts": arts, "batches": list(I_BATCHES), "reps": I_REPS,
            "inputs": os.path.join(tmp, "inputs.npz"),
            "outputs": os.path.join(tmp, "outputs.npz")}
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", PREDICTOR_CHILD,
                        json.dumps(args)], capture_output=True, text=True,
                       timeout=600, env=env, cwd=tmp)
    line = [x for x in r.stdout.splitlines()
            if x.startswith("PREDICTOR_RESULT ")]
    if r.returncode != 0 or not line:
        fail(f"phase 4i (a): the Predictor's process failed "
             f"(rc {r.returncode}): {r.stderr[-3000:]}")
    res = json.loads(line[0][len("PREDICTOR_RESULT "):])
    if res["leaked"]:
        fail(f"phase 4i (a): the Predictor's process imported {res['leaked']}")
    outs = np.load(args["outputs"])
    worst = {}
    for tag in arts:
        rel = []
        for b in I_BATCHES:
            row = res["artifacts"][tag]["rows"][str(b)]
            ids, mask = batches[f"ids{b}"], batches[f"mask{b}"]
            got = outs[f"{tag}{b}"]
            if got.shape != (b, 2) or not np.isfinite(got).all():
                fail(f"phase 4i (a) {tag} B {b}: logits {got.shape}")
            if not (row["bitwise_replay_eager"] and row["repeat_bitwise"]):
                fail(f"phase 4i (a) {tag} B {b}: the graph replay is not "
                     f"bitwise the loaded program run eagerly ({row})")
            pr = row["per_run"]
            if pr.get("flash_fwd_bias") != 12 or set(pr) != {
                    "flash_fwd_bias"}:
                fail(f"phase 4i (a) {tag} B {b}: launches a run {pr}, "
                     f"expected K4 bias 12 and nothing else")
            rel.append(i_rel(got, i_eager(torch, ptt, net, ids, mask,
                                          tag == "bf16")))
        worst[tag] = max(rel)
        if worst[tag] > I_F32_REL:
            fail(f"phase 4i (a) {tag}: served logits {worst[tag]:.3g} of the "
                 f"eager layer's largest (limit {I_F32_REL})")
    del net
    torch.cuda.empty_cache()
    return res, sizes, save_s, worst


def i_encoder_block(ptt, st, dtype):
    """Phase 4i (b)'s Program: one encoder block at BERT-base width over
    static.data (x [B, S, 768], a [B, 1, 1, S] padding bias, labels), q,
    k and v by static.nn.fc, the attention op, out projection, residual +
    layer_norm, the 3072-wide feed-forward, residual + layer_norm, mean
    pooling, a 2-way head; cross entropy; Adam. Returns (loss, logits)."""
    b, s = I_BLOCK
    d, heads = A_HIDDEN, A_HEADS
    x = st.data("x", [b, s, d], dtype)
    bias = st.data("bias", [b, 1, 1, s], dtype)
    label = st.data("label", [b], "int64")

    def heads_of(t):
        return ptt.ops.transpose(ptt.ops.reshape(t, [b, s, heads,
                                                     d // heads]),
                                 [0, 2, 1, 3])

    q, k, v = (heads_of(st.nn.fc(x, d, num_flatten_dims=2))
               for _ in range(3))
    att, _ = ptt.ops.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    att = ptt.ops.reshape(ptt.ops.transpose(att, [0, 2, 1, 3]), [b, s, d])
    h = st.nn.layer_norm(x + st.nn.fc(att, d, num_flatten_dims=2),
                         begin_norm_axis=2)
    f = st.nn.fc(st.nn.fc(h, A_FFN, num_flatten_dims=2, act="gelu"), d,
                 num_flatten_dims=2)
    h = st.nn.layer_norm(h + f, begin_norm_axis=2)
    logits = st.nn.fc(ptt.ops.mean(h, axis=1), 2)
    loss = ptt.nn.functional.cross_entropy(logits, label)
    ptt.optimizer.Adam(learning_rate=I_LR).minimize(loss)
    return loss, logits


def static_parity(torch, tmp):
    """Phase 4i (b): the encoder block's Program trained I_STEPS Adam
    steps by Executor.run on the card (float32: K4 bias, K6, K9 bias) and
    the same Program on the CPU in float64 from the same weights; then
    save_inference_model -> load_inference_model on the card."""
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.static as st
    from paddle_tpu_torch import device as pdevice
    from paddle_tpu_torch.ops import kernels

    ptt.enable_static()
    try:
        progs = []
        for dev, dtype in ((DEV, "float32"), ("cpu", "float64")):
            main, startup = st.Program(), st.Program()
            with pdevice.device_guard(dev), \
                    st.program_guard(main, startup):
                progs.append((main, startup, i_encoder_block(ptt, st, dtype),
                              st.Executor(dev), st.Scope()))
        (mc, sc, (loss_c, logits_c), exe_c, scope_c), \
            (mh, _, (loss_h, _), exe_h, scope_h) = progs
        flash = [op.type for op in mc.global_block().ops
                 if op.type == "paddle_tpu_torch::flash_attn"]
        if len(flash) != 1:
            fail(f"phase 4i (b): the Program holds {len(flash)} flash nodes")
        ptt.seed(37)
        exe_c.run(sc, scope=scope_c)
        pc = [v for v in mc.global_block().vars.values() if v.persistable]
        ph = [v for v in mh.global_block().vars.values() if v.persistable]
        for a, h in zip(pc, ph):
            scope_h.set(h.name, scope_c.find_var(a.name).detach().double()
                        .cpu())
        start = [scope_h.find_var(h.name).clone() for h in ph]
        b, s = I_BLOCK
        rs = np.random.RandomState(41)
        lens = bert_lengths(b, s)
        real = np.arange(s)[None] < lens[:, None]
        feed = {"x": rs.randn(b, s, A_HIDDEN).astype(np.float32),
                "bias": np.where(real, 0.0, -1e9).astype(np.float32)[
                    :, None, None, :],
                "label": rs.randint(0, 2, (b,)).astype(np.int64)}
        feed64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
                  for k, v in feed.items()}
        kernels.reset_launch_counts()                      # main path
        t0 = time.perf_counter()
        losses_c, losses_h, grad_rel, live = [], [], 0.0, []
        for step in range(I_STEPS):
            names = [p.name + "@GRAD" for p in pc] if step == 0 else []
            out_c = exe_c.run(mc, feed=feed, fetch_list=[loss_c] + names,
                              scope=scope_c)
            out_h = exe_h.run(mh, feed=feed64, fetch_list=[loss_h] + [
                p.name + "@GRAD" for p in ph] if step == 0 else [loss_h],
                scope=scope_h)
            losses_c.append(float(out_c[0]))
            losses_h.append(float(out_h[0]))
            if step == 0:
                live = [float(np.abs(gh).max()) > I_LIVE_GRAD
                        for gh in out_h[1:]]
            for gc, gh in zip(out_c[1:], out_h[1:]):
                # a leaf whose gradient is 0 in exact arithmetic (the key
                # bias) holds rounding noise: its scale floors at 1e-4
                grad_rel = max(grad_rel, float(np.abs(gc - gh).max()
                                               / max(np.abs(gh).max(),
                                                     1e-4)))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        loss_rel = max(abs(a - h) / abs(h) for a, h in zip(losses_c,
                                                             losses_h))
        # each leaf's update (its parameters less the shared start), the
        # card's against the CPU's in the 2-norm: a skipped update reads
        # 1, one of the wrong sign 2. A leaf without a gradient (the key
        # bias) moves by rounding noise on both devices and is left out;
        # every other leaf must have moved on the CPU, or a step that
        # updates nothing on both devices would pass
        update_rel, moved = 0.0, []
        for a, h, w0, is_live in zip(pc, ph, start, live):
            if is_live:
                upd_h = scope_h.find_var(h.name) - w0
                upd_c = scope_c.find_var(a.name).double().cpu() - w0
                update_rel = max(update_rel, float(
                    (upd_c - upd_h).norm() / upd_h.norm()))
                moved.append(float(upd_h.abs().max()))
        param_moved = min(moved)
        if loss_rel > I_LOSS_REL or grad_rel > I_GRAD_REL or \
                not update_rel <= I_UPDATE_REL or param_moved < I_MOVED or \
                not all(np.isfinite(losses_c)):
            fail(f"phase 4i (b): card f32 vs CPU f64 loss {loss_rel:.3g} "
                 f"(limit {I_LOSS_REL}), gradients {grad_rel:.3g} (limit "
                 f"{I_GRAD_REL}), updates {update_rel:.3g} (limit "
                 f"{I_UPDATE_REL}), the least-moved of {len(moved)} "
                 f"leaves with a gradient {param_moved:.3g} (at least "
                 f"{I_MOVED:.3g}); losses {losses_c}")
        want = {"flash_fwd_bias": I_STEPS, "flash_delta": I_STEPS,
                "flash_bwd_bias": I_STEPS}
        got = {k: v for k, v in counts.items() if v}
        if got != want:
            fail(f"phase 4i (b): the Program launched {got}, expected {want}")
        # the inference model: the forward from the feeds to the logits
        test = mc.clone(for_test=True)
        fwd = exe_c.run(test, feed=feed, fetch_list=[logits_c],
                        scope=scope_c)[0]
        prefix = os.path.join(tmp, "encoder_block")
        with st.scope_guard(scope_c):
            st.save_inference_model(prefix, [mc.global_block().var("x"),
                                             mc.global_block().var("bias")],
                                    [logits_c], exe_c, program=test)
            loaded, feeds, fetches = st.load_inference_model(prefix, exe_c)
        kernels.reset_launch_counts()                      # main path
        served = exe_c.run(loaded, feed={k: feed[k] for k in feeds},
                           fetch_list=fetches)[0]
        served_counts = {k: v for k, v in kernels.launch_counts().items()
                         if v}
        served_rel = i_rel(served, fwd)
        if served_counts != {"flash_fwd_bias": 1} or served_rel > I_F32_REL:
            fail(f"phase 4i (b): the loaded inference model launched "
                 f"{served_counts} (expected K4 bias 1) and gives "
                 f"{served_rel:.3g} of the Executor's logits (limit "
                 f"{I_F32_REL})")
    finally:
        ptt.disable_static()
    torch.cuda.empty_cache()
    return {"losses": losses_c, "losses_cpu": losses_h, "loss_rel": loss_rel,
            "grad_rel": grad_rel, "update_rel": update_rel,
            "param_moved": param_moved, "n_moved": len(moved),
            "n_leaves": len(pc), "counts": got,
            "served_counts": served_counts, "train_s": train_s,
            "served_rel": served_rel,
            "served_bitwise": bool(np.array_equal(served, fwd)),
            "size": (os.path.getsize(prefix + ".pdmodel"),
                     os.path.getsize(prefix + ".pdiparams"))}


def gpt2_export_parity(torch, tmp):
    """Phase 4i (c): GPT-2 small (float32) through jit.save with a free
    batch dim, loaded on the card: logits at 1 x 1024 against
    GPT2.forward on the card; K4 launched (12 a forward)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import GPT2, GPT2Config
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.static import InputSpec

    cfg = GPT2Config(dropout=0.0)
    model = GPT2(cfg, seed=0, dtype=torch.float32, device=DEV).eval()
    prefix = os.path.join(tmp, "gpt2_small")
    t0 = time.perf_counter()
    jit.save(model, prefix, input_spec=[InputSpec([None, 1024], "int64")])
    save_s = time.perf_counter() - t0
    loaded = jit.load(prefix)
    ids = torch.from_numpy(np.random.RandomState(43).randint(
        0, cfg.vocab_size, (1, 1024))).to(DEV)
    with torch.no_grad():
        want = model(ids).cpu().numpy()
    kernels.reset_launch_counts()                          # main path
    got = loaded(ids).cpu().numpy()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    rel = i_rel(got, want)
    if counts != {"flash_fwd": cfg.num_layers} or rel > I_F32_REL:
        fail(f"phase 4i (c): GPT-2 small's loaded logits {rel:.3g} of "
             f"GPT2.forward's largest (limit {I_F32_REL}), launches "
             f"{counts} (expected K4 {cfg.num_layers})")
    del model, loaded
    torch.cuda.empty_cache()
    return {"rel": rel, "counts": counts, "save_s": save_s,
            "size": (os.path.getsize(prefix + ".pdmodel"),
                     os.path.getsize(prefix + ".pdiparams"))}


def deploy_phase(torch, card):
    """Phases 4i and 6i (module docstring). Returns the main path's
    launches: the Predictor's (its captures and timed runs), the
    Executor's and the loaded programs'."""
    import tempfile

    t_all = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res, sizes, save_s, worst = predictor_parity(torch, tmp)
        a_s = time.perf_counter() - t0
        for tag, art in res["artifacts"].items():
            for b, row in art["rows"].items():
                for src in (row["captured"], {
                        k: v * I_REPS for k, v in row["per_run"].items()}):
                    for k, v in src.items():
                        launches[k] = launches.get(k, 0) + int(round(v))
        say(f"phase 4i (a) jit.save of api_classifier (BERT-base width, 12 "
            f"layers, S {I_SEQ}) from the card, float32 and bf16 "
            f"(auto_cast, attention in bf16; save "
            f"{save_s['f32']:.1f} / {save_s['bf16']:.1f} s) -> a fresh "
            f"process (inference only, no model class imported) -> "
            f"Config/create_predictor/handles/run/copy_to_cpu at B "
            f"{'/'.join(map(str, I_BATCHES))} padded: graph replay bitwise "
            f"the loaded program run eagerly, served logits vs the eager "
            f"layer {worst['f32']:.3g} (f32) and {worst['bf16']:.3g} (bf16) "
            f"of the largest (limit {I_F32_REL}); "
            f"K4 bias 12 launches a batch (counted in the process), nothing "
            f"else; {a_s:.1f} s [{card}]")
        t0 = time.perf_counter()
        r = static_parity(torch, tmp)
        for k, v in list(r["counts"].items()) + list(
                r["served_counts"].items()):
            launches[k] = launches.get(k, 0) + v
        say(f"phase 4i (b) static Program: encoder block at BERT-base width "
            f"(static.data + static.nn.fc/layer_norm + the attention op, one "
            f"flash node) B {I_BLOCK[0]} x S {I_BLOCK[1]} padded, "
            f"{I_STEPS} Adam steps by Executor.run, card f32 vs CPU f64: "
            f"loss {r['loss_rel']:.3g} (limit {I_LOSS_REL}), step-1 "
            f"gradients {r['grad_rel']:.3g} (limit {I_GRAD_REL}), "
            f"each leaf's update after {I_STEPS} steps {r['update_rel']:.3g} "
            f"of the CPU's in the 2-norm (limit {I_UPDATE_REL}; a skipped "
            f"update reads 1) over the {r['n_moved']} of {r['n_leaves']} "
            f"leaves with a gradient, the least of them moved "
            f"{r['param_moved']:.3g} on the CPU (limit >= {I_MOVED:.3g}); "
            f"losses {' '.join(f'{x:.4f}' for x in r['losses'])}; launches "
            f"{r['counts']}; save_inference_model -> load_inference_model "
            f"on the card: logits {r['served_rel']:.3g} of the Executor's "
            f"largest (limit {I_F32_REL}; bitwise {r['served_bitwise']}), "
            f"launches {r['served_counts']}; "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        g = gpt2_export_parity(torch, tmp)
        for k, v in g["counts"].items():
            launches[k] = launches.get(k, 0) + v
        say(f"phase 4i (c) GPT-2 small f32 jit.save (InputSpec [None, "
            f"1024]; {g['save_s']:.1f} s) -> jit.load on the card: logits "
            f"at 1 x 1024 {g['rel']:.3g} of GPT2.forward's largest (limit "
            f"{I_F32_REL}), launches {g['counts']}; "
            f"{time.perf_counter() - t0:.1f} s")
        for tag, art in res["artifacts"].items():
            rows = " ".join(
                f"B {b}: {row['run_ms']:.2f} ms a batch "
                f"({int(b) / row['run_ms'] * 1e3:.1f} samples/s), graph "
                f"replay {row['replay_ms']:.2f} ms vs eager "
                f"{row['eager_ms']:.2f} ms, idle {row['idle']:.3f}, first "
                f"run (capture) {row['first_s']:.2f} s;"
                for b, row in art["rows"].items())
            say(f"phase 6i Predictor {tag} (api_classifier, S {I_SEQ} "
                f"padded; handle flow: copy_from_cpu, run, copy_to_cpu, "
                f"host clock, {I_REPS} runs; replay / eager by CUDA events "
                f"on the card's tensors): {rows} load "
                f"{art['load_s']:.2f} s, {art['captures']} graphs; artifact "
                f".pdmodel {sizes[tag][0]} B .pdiparams {sizes[tag][1]} B "
                f"[{card}]")
        say(f"phase 6i artifacts: encoder block .pdmodel {r['size'][0]} B "
            f".pdiparams {r['size'][1]} B; GPT-2 small .pdmodel "
            f"{g['size'][0]} B .pdiparams {g['size'][1]} B; phases 4i + 6i "
            f"{time.perf_counter() - t_all:.1f} s")
    return launches


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
U_NEW, U_REQS, U_MP = 128, 16, 256      # 5v (b) unified axis (of 32)


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
    sampled with a penalty, on the card: speculation off, n-gram (K 8),
    replay (K 8, the card's own speculation-off tokens), the unified
    round (sync, n-gram) and async rounds (n-gram); on the CPU:
    speculation off. Every server's card tokens equal the card's
    speculation-off tokens, which equal the CPU's (on the CPU each other
    server equals speculation off in the tier-1 twins:
    `test_torch_spec_decode.py::TestSpecParity`,
    `test_torch_unified_round.py::TestParity`). On the card: replays
    equal verify dispatches (split) and
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
        for dev in (DEV, "cpu") if name == "off" else (DEV,):
            outs[dev], st, counts = run(dev, kw)
            if dev == DEV:
                res[name] = (st, counts)
        if name == "off":
            base = outs
            for i, (a, b) in enumerate(zip(outs[DEV], outs["cpu"])):
                if not np.array_equal(a, b):
                    fail(f"phase 5v (a) off: request {i} differs card vs "
                         f"CPU")
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


def profiled_busy(torch, drive, host_ops=True):
    """One more pass of `drive` under torch.profiler: the device's busy
    time in seconds (every CUDA kernel and copy). host_ops=False records
    the device's activity alone (a cheaper trace of a long pass)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if host_ops else [ProfilerActivity.CUDA]) as prof:
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


# ---- phase 5m: the serving fleet on the card ---------------------------------

# phase 5's server (prefix cache on) in every replica and worker
M_SERVER = dict(max_slots=8, block_size=16, max_prompt_len=768,
                max_new_tokens=32, prefill_chunk_tokens=512,
                enable_prefix_cache=True)
M_KILL_AT = 8       # (a): the replica_kill seam fires at this placement
M_MIGRATE_AT = 4    # (b), (c): tokens a session streams before it moves
M_TIMEOUT = 300.0   # a wait on a condition (s)
# (c): the kill's victim sleeps at its third dispatch (slow_dispatch
# occurrence 2, the only one this seed schedules; after its first prefill
# and one more dispatch) until it is SIGKILLed, as the CPU twin's does
M_STALL_PLAN = "seed=3,rate=0.5,horizon=3,slow=600,seams=slow_dispatch"


def m_sampling(n):
    """Phase 4s's sampling rows (SERVE_ROWS' sampled ones) on the odd
    requests; the even ones greedy."""
    from paddle_tpu_torch.sampling import SamplingParams

    return [SamplingParams(**SERVE_ROWS[i % len(SERVE_ROWS)]) if i % 2
            else None for i in range(n)]


def m_wait(cond, what):
    deadline = time.monotonic() + M_TIMEOUT
    while not cond():
        if time.monotonic() > deadline:
            fail(f"phase 5m: {what} within {M_TIMEOUT:.0f} s")
        time.sleep(0.002)


def m_passes(torch, submit, prompts, sampling, passes):
    """`passes` passes of `prompts` through `submit`; returns the last
    pass's outputs and its tokens/s."""
    for _ in range(passes):
        t0 = time.perf_counter()
        outs = [f.result(timeout=600) for f in
                [submit(p, sampling=s) for p, s in zip(prompts, sampling)]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return outs, sum(o.size - p.size for o, p in zip(outs, prompts)) / wall


def m_single(torch, model, prompts, sampling, passes=2, **kw):
    """The fault-free single-server run of `prompts` (phase 5's server,
    prefix cache on): a warm pass, then the measured one. Returns
    (outputs, tokens/s)."""
    from paddle_tpu_torch.inference import PagedGenerationServer

    srv = PagedGenerationServer(model, device=DEV, **dict(M_SERVER, **kw))
    srv.warm_buckets()
    srv.start()
    try:
        return m_passes(torch, srv.submit, prompts, sampling, passes)
    finally:
        srv.stop()


def m_fleet(torch, model, prompts, sampling):
    """The fault-free 2-replica fleet on the same traffic: a warm pass,
    then the measured one. Each replica must have run prefill and decode
    dispatches (K1 and K2 launches a dispatch, 12 each: phase 5 holds
    that; the launch counters are the process's, shared by the
    replicas). Returns (outputs, tokens/s, {replica: (prefill, decode
    dispatches)})."""
    from paddle_tpu_torch.fleet import FleetRouter

    reps = m_replicas(model, 2)
    router = FleetRouter(reps, probe_interval_s=30.0)
    router.start()
    try:
        outs, tps = m_passes(torch, router.submit, prompts, sampling, 2)
        per = {r.name: (r.server.stats()["prefill_dispatches"],
                        r.server.stats()["decode_steps"]) for r in reps}
    finally:
        router.stop()
    if min(min(v) for v in per.values()) <= 0:
        fail(f"phase 5m (a): a replica ran no prefill or decode dispatch "
             f"{per}")
    return outs, tps, per


def draw_replay(torch, cfg, params_cpu, a, b, start, sp, phase):
    """The replay of a sampled row that two outputs `a`, `b` of one request
    share up to their first difference i (the rules of 5m and 5d read it):
    returns (i, the float32 CPU logits there after the request's
    penalties, shape (1, V), and its Gumbel noise at step i - start,
    shape (1, V), or None at temperature 0)."""
    from paddle_tpu_torch.models.gpt2 import logits
    from paddle_tpu_torch.sampling import prng
    from paddle_tpu_torch.sampling import processors as proc

    i = int(np.nonzero(a != b)[0][0])
    if i < start:
        fail(f"phase {phase}: two outputs differ inside the prompt")
    with torch.no_grad():
        lg = logits(params_cpu, cfg, torch.from_numpy(
            a[:i].astype(np.int64))[None])[0, -1:]
    if sp.uses_penalties:
        counts = torch.from_numpy(np.bincount(
            a[:i], minlength=cfg.vocab_size)[None].astype(np.int32))
        lg = proc.apply_penalties(
            lg, counts, torch.tensor([sp.repetition_penalty]),
            torch.tensor([sp.presence_penalty]),
            torch.tensor([sp.frequency_penalty]))
    g = None
    if sp.temperature > 0:
        g = prng.gumbel(prng.fold_in_keys(
            torch.tensor([sp.seed], dtype=torch.int64),
            torch.tensor([i - start], dtype=torch.int32)), lg.shape[-1])
    return i, lg, g


def m_draw_tie(torch, cfg, params_cpu, a, b, start, sp):
    """Two outputs of one sampled request that differ: True when at the
    first difference each token is a draw that logits within phase 4f's
    bf16 limit of the float32 CPU logits could give (each logit moved by
    at most d = BF16_DECODER_REL x their largest magnitude; penalties,
    temperature, the request's Gumbel noise: `draw_replay`): the token
    can be inside the top-k / top-p / min-p set (its logit up by d, the
    others down) and its draw value up by d reaches the draw value down
    by d of a token that stays in the set however the logits move (its
    logit down by d, the others up). A draw flipped by a filter's
    boundary is such a tie; returns (tie, detail)."""
    from paddle_tpu_torch.sampling import processors as proc

    i, lg, g = draw_replay(torch, cfg, params_cpu, a, b, start, sp, "5m")
    lg = lg[0]
    d = BF16_DECODER_REL * lg.abs().max().item()
    toks = (int(a[i]), int(b[i]))
    if sp.temperature <= 0:
        top = lg.max().item()
        return all(top - lg[t].item() <= 2 * d for t in toks), (i, d)
    eps = d / sp.temperature
    sc = lg / sp.temperature
    g = g[0]
    filt = (torch.tensor([sp.top_k]), torch.tensor([sp.top_p]),
            torch.tensor([sp.min_p]))

    def kept(v, t):
        return bool(proc.filter_logits(v[None], *filt)[0, t] > -np.inf)

    def moved(t, up):
        v = sc - eps if up else sc + eps
        v[t] = sc[t] + eps if up else sc[t] - eps
        return v

    low = sc - eps + g
    floor = -np.inf
    for u in torch.argsort(low, descending=True)[:64].tolist():
        if kept(moved(u, False), u):
            floor = low[u].item()
            break
    reach = [kept(moved(t, True), t) and (sc[t] + eps + g[t]).item()
             >= floor for t in toks]
    return all(reach), (i, d, floor, [(sc[t] + g[t]).item()
                                      for t in toks], reach)


def m_same(torch, cfg, params_cpu, got, want, prompts, sampling, what,
           ties):
    """got == want request by request but for near ties: greedy rows by
    phase 4f's rule (`near_tie_rule`), sampled rows by `m_draw_tie`; each
    tie is appended to `ties`."""
    for r, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if np.array_equal(g, w):
            continue
        if g.shape != w.shape:
            fail(f"phase 5m {what}: request {r} has {g.size} tokens, the "
                 f"single server's {w.size}")
        sp = sampling[r]
        start = prompts[r].size
        detail = ""
        if sp is None:
            tie = near_tie_rule(torch, params_cpu, cfg, g, w, start,
                                phase=f"5m {what}")
        else:
            tie, detail = m_draw_tie(torch, cfg, params_cpu, g, w, start,
                                     sp)
        if not tie:
            fail(f"phase 5m {what}: request {r} differs from the fault-free "
                 f"single server beyond the near-tie rule {detail}")
        ties.append((what, r, int(np.nonzero(g != w)[0][0])))


def m_replicas(model, n, **kw):
    from paddle_tpu_torch.fleet import Replica
    from paddle_tpu_torch.inference import PagedGenerationServer

    reps = []
    for i in range(n):
        srv = PagedGenerationServer(model, device=DEV, **dict(M_SERVER, **kw))
        srv.warm_buckets()
        reps.append(Replica(f"m{i}", srv))
    return reps


def m_chaos(torch, model, prompts, sampling, want, params_cpu, ties):
    """(a): FleetRouter over 2 in-process replicas. Requests 0 and 1 (one
    a replica: least-loaded placement) each hold their replica's engine
    at their second token (`f_hold`'s gate); once both are held the rest
    are submitted, and the replica_kill seam fires at placement
    M_KILL_AT, killing the replica chosen for it while its held session
    is mid-stream (the gate opens as the kill begins; the killed engine
    finishes its round, then stops). Returns (stats,
    K1/K2 launches, kill -> first survivor token ms (min, max), tokens/s,
    mid-stream sessions at the kill)."""
    import threading

    from paddle_tpu_torch.fleet import FleetRouter
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.reliability import FaultPlan

    reps = m_replicas(model, 2)
    router = FleetRouter(reps, probe_interval_s=0.2, fault_plan=FaultPlan(
        [("replica_kill", M_KILL_AT)], name="5m-kill"))
    times = [[] for _ in prompts]
    go = threading.Event()
    reached = [threading.Event(), threading.Event()]
    kill = {}
    plain_kill = router._kill_replica

    def on_token(i):
        def cb(_t, _r):
            times[i].append(time.perf_counter())
            if i < 2 and len(times[i]) == 2:
                reached[i].set()
                go.wait(60)
        return cb

    def timed_kill(rep, why="injected replica_kill"):
        with router._lock:
            kill["mid"] = sum(1 for s in router._sessions.values()
                              if s.replica is rep and s.toks and not s.done)
        kill["t"] = time.perf_counter()
        go.set()
        return plain_kill(rep, why)

    def halted(rep):
        plain = rep.kill

        def run():
            plain()  # the engine stops; its last round's tokens are out
            kill["halted"] = time.perf_counter()
        return run

    for rep in reps:
        rep.kill = halted(rep)
    router._kill_replica = timed_kill
    router.start()
    try:
        kernels.reset_launch_counts()                          # main path
        t0 = time.perf_counter()
        futs = []
        for i, (p, sp) in enumerate(zip(prompts, sampling)):
            if i == M_KILL_AT:
                m_wait(lambda: all(e.is_set() for e in reached),
                       "both replicas held at a session's second token")
            futs.append(router.submit(p, sampling=sp, on_token=on_token(i)))
        go.set()
        outs = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        st = router.stats()
        sessions = list(router._sessions.values())
    finally:
        go.set()
        router.stop()
    if st["replica_kills"] != 1 or not kill or kill["mid"] < 1:
        fail(f"phase 5m (a): the kill did not land mid-stream ({kill}, "
             f"{st['replica_kills']} kills)")
    if st["failovers"] < 1 or st["failover_sessions"] < kill["mid"]:
        fail(f"phase 5m (a): {st['failover_sessions']} sessions failed "
             f"over for {kill['mid']} mid-stream on the killed replica")
    # a failed-over session's first token from the survivor: the first
    # after the killed engine stopped (its last round's tokens precede it)
    firsts = [next(t for t in times[i] if t > kill["halted"]) - kill["t"]
              for i, s in enumerate(sessions) if s.failovers]
    m_same(torch, model.cfg, params_cpu, outs, want, prompts, sampling,
           "(a)", ties)
    new = sum(o.size - p.size for o, p in zip(outs, prompts))
    if counts["ragged_stream_dense"] <= 0 or \
            counts["paged_decode_dense"] <= 0:
        fail(f"phase 5m (a): K1/K2 launches {counts}")
    return st, counts, (min(firsts) * 1e3, max(firsts) * 1e3), \
        new / wall, kill["mid"]


def m_migrate(torch, model, prompt, want, params_cpu, kv_dtype, ties):
    """(b): one live session moved between two in-process replicas. It
    holds its engine at its M_MIGRATE_AT-th token until `migrate_session`
    (on another thread) has queued the export on the source engine, so
    the export runs at the next round boundary, mid-stream; the export
    (from the gate's opening), the wire round trip and the import are
    timed inside `migrate_session`. Returns a dict of the numbers and the
    K1/K2 launches."""
    import threading

    from paddle_tpu_torch.fleet import (FleetRouter, deserialize_kv_payload,
                                        router as fleet_router,
                                        serialize_kv_payload)
    from paddle_tpu_torch.ops import kernels

    reps = m_replicas(model, 2, kv_dtype=kv_dtype)
    ms, seen = {}, {}
    reached, go = threading.Event(), threading.Event()

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            t = max(t, seen.get("go", t)) if name == "export" else t
            ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t) * 1e3
            if name == "export":
                seen["payload"] = out[1]
            return out
        return run

    for r in reps:
        r.server.export_session = timed("export", r.server.export_session)
        r.server.import_kv_payload = timed("import",
                                           r.server.import_kv_payload)
    plain = (fleet_router.serialize_kv_payload,
             fleet_router.deserialize_kv_payload)
    fleet_router.serialize_kv_payload = timed("wire", plain[0])
    fleet_router.deserialize_kv_payload = timed("wire", plain[1])
    router = FleetRouter(reps, probe_interval_s=30.0)
    router.start()
    try:
        kernels.reset_launch_counts()                          # main path
        n = [0]

        def hold(_t, _r):
            n[0] += 1
            if n[0] == M_MIGRATE_AT:
                reached.set()
                go.wait(60)

        fut = router.submit(prompt, on_token=hold)
        m_wait(reached.is_set, "the session's first tokens")
        rid = next(iter(router._sessions))
        source = router._sessions[rid].replica
        before = {r.name: r.server.stats()["prefills"] for r in reps}
        moved = {}

        def move():
            t = time.perf_counter()
            try:
                moved["to"] = router.migrate_session(rid)
            except KeyError as e:
                moved["err"] = e
            moved["ms"] = (time.perf_counter() - t) * 1e3

        mover = threading.Thread(target=move)
        mover.start()
        m_wait(lambda: source.server._host_ops, "the export queued")
        seen["go"] = time.perf_counter()
        go.set()
        mover.join(M_TIMEOUT)
        if "to" not in moved:
            fail(f"phase 5m (b): migrate_session failed: {moved}")
        target = moved["to"]
        ms["migrate"] = moved["ms"]
        out = fut.result(timeout=600)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        tst = next(r for r in reps if r.name == target).server.stats()
        st = router.stats()
    finally:
        go.set()
        fleet_router.serialize_kv_payload, \
            fleet_router.deserialize_kv_payload = plain
        router.stop()
    what = f"(b) {kv_dtype or 'dense'}"
    if target == source.name or st["migrations"] != 1:
        fail(f"phase 5m {what}: the session did not move ({target})")
    if tst["prefills"] != before[target] or \
            tst["frontdoor"]["resumes"] < 1:
        fail(f"phase 5m {what}: the target prefilled "
             f"{tst['prefills'] - before[target]} times, resumes "
             f"{tst['frontdoor']['resumes']}")
    m_same(torch, model.cfg, params_cpu, [out], [want], [prompt], [None],
           what, ties)
    payload = seen["payload"]
    if payload is None:
        fail(f"phase 5m {what}: the export carried no K/V")
    wire = serialize_kv_payload(payload)
    back = deserialize_kv_payload(wire)
    res = {"ms": ms, "kv_tokens": len(payload["tokens"]),
           "wire": len(wire), "counts": counts}
    if kv_dtype == "int8":
        for side in ("k", "v"):
            for a, b in zip(payload[side], back[side]):
                if not (np.array_equal(a.codes, b.codes)
                        and np.array_equal(a.scales, b.scales)):
                    fail("phase 5m (b) int8: the payload did not round-trip "
                         "bit for bit")
    else:
        # the pool's own width (bf16 here) is the raw bytes' yardstick;
        # the port's export carries bf16 as float32 (numpy has no bf16)
        elems = sum(int(np.asarray(a).size)
                    for a in payload["k"] + payload["v"])
        res["raw_pool"] = elems * model.flat_params()[
            "wte.weight"].element_size()
        res["raw_f32"] = len(serialize_kv_payload(payload,
                                                  wire_compress=False))
    return res


def m_spawn(cfg, names, npz, stall=()):
    """Spawn one worker a name in parallel (phase 5's server, the bf16
    weights from `npz`, on the card); the workers named in `stall` run
    M_STALL_PLAN. Returns (replicas, spawn seconds each)."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.fleet import RemoteReplica

    def one(name):
        server = dict(M_SERVER)
        if name in stall:
            server["fault_plan"] = M_STALL_PLAN
        t = time.perf_counter()
        rep = RemoteReplica.spawn(name, {
            "model": {"kind": "gpt2", "weights": npz, "dtype": "bfloat16",
                      "config": dataclasses.asdict(cfg)},
            "server": server}, keep_alive_on_stop=True,
            startup_timeout_s=M_TIMEOUT)
        return rep, time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        got = list(ex.map(one, names))
    return [g[0] for g in got], [g[1] for g in got]


def m_kernels(rep, base=(0, 0)):
    """A worker's K1/K2 launches from its /stats since `base` (a worker
    counts from its start: its warm-up's eager decode launches K2)."""
    c = rep.server.stats()["kernel_launches"]
    return (c["ragged_stream_dense"] - base[0],
            c["paged_decode_dense"] - base[1])


def m_workers(torch, model, prompts, sampling, want, params_cpu, ties,
              tmp):
    """(c) and (d): worker subprocesses on the card. (c) a live migration
    over the wire within a pass of requests on w0 and w1, (d)
    DisaggRouter from w0 (prefill) to w1 (decode), (c) a pass on the
    victim wk and w0 in which wk, held mid-decode by M_STALL_PLAN, is
    SIGKILLed: every session completes on w0. The victim is a third
    worker because a stall plan counts dispatches from the worker's
    start, and how many w1 runs in (c) and (d) depends on timing. Every
    launch count is a delta over the passes from the counts read after
    the spawn. Returns the numbers and the workers' K1/K2 launches."""
    from paddle_tpu_torch.fleet import DisaggRouter, FleetRouter

    npz = os.path.join(tmp, "gpt2_small_bf16_as_f32.npz")
    np.savez(npz, **{k: v.float().cpu().numpy()
                     for k, v in model.flat_params().items()})
    workers, spawn_s = m_spawn(model.cfg, ["w0", "w1", "wk"], npz,
                               stall=("wk",))
    w0, w1, wk = workers
    res = {"spawn_s": spawn_s}
    try:
        for w in workers:
            ready, detail = w.readiness()
            if not ready or not detail.get("warmed"):
                fail(f"phase 5m (c): worker {w.name} not ready and warm "
                     f"({detail})")
        base = {w.name: m_kernels(w) for w in workers}
        # (c) a pass with one live migration over the wire
        idx = list(range(0, 8))
        router = FleetRouter([w0, w1], probe_interval_s=0.5,
                             journal=os.path.join(tmp, "c1.journal"))
        router.start()
        try:
            n = [0]

            def count(_t, _r):
                n[0] += 1

            futs = [router.submit(prompts[0], sampling=sampling[0],
                                  on_token=count)]
            m_wait(lambda: n[0] >= 1,
                   "the first request's first token over the wire")
            rid = next(iter(router._sessions))
            t = time.perf_counter()
            try:
                moved = router.migrate_session(rid)
            except KeyError:
                fail("phase 5m (c): the session finished before the "
                     "migration over the wire")
            res["wire_migrate_ms"] = (time.perf_counter() - t) * 1e3
            futs += [router.submit(prompts[i], sampling=sampling[i])
                     for i in idx[1:]]
            outs = [f.result(timeout=600) for f in futs]
            st = router.stats()
        finally:
            router.stop()
        if st["migrations"] != 1 or moved not in ("w0", "w1"):
            fail(f"phase 5m (c): the live migration did not happen ({st})")
        m_same(torch, model.cfg, params_cpu, outs, [want[i] for i in idx],
               [prompts[i] for i in idx], [sampling[i] for i in idx],
               "(c) migration", ties)
        # (d) prefill on w0, decode on w1
        idx = list(range(8, 12))
        k2_before = m_kernels(w1, base["w1"])[1]
        drouter = DisaggRouter([w0], [w1], handoff_poll_s=0.002,
                               probe_interval_s=0.5,
                               journal=os.path.join(tmp, "d.journal"))
        drouter.start()
        try:
            outs = [f.result(timeout=600) for f in
                    [drouter.submit(prompts[i], sampling=sampling[i])
                     for i in idx]]
            dst = drouter.stats()["disagg"]
        finally:
            drouter.stop()
        m_same(torch, model.cfg, params_cpu, outs, [want[i] for i in idx],
               [prompts[i] for i in idx], [sampling[i] for i in idx],
               "(d) disagg", ties)
        res["disagg"] = dst
        res["w1"] = m_kernels(w1, base["w1"])
        res["k2_decode"] = res["w1"][1] - k2_before
        if dst["handoffs"] < 1 or dst["handoffs_failed"] or \
                res["k2_decode"] <= 0:
            fail(f"phase 5m (d): handoffs {dst}, the decode worker's K2 "
                 f"launches {res['k2_decode']}")
        # (c) the kill: the victim (first in placement order) stalls at
        # its third dispatch until it is SIGKILLed
        idx = list(range(12, 16))
        router = FleetRouter([wk, w0], probe_interval_s=0.2,
                             journal=os.path.join(tmp, "c2.journal"))
        router.start()
        try:
            futs = [router.submit(prompts[i], sampling=sampling[i])
                    for i in idx]

            def held():
                with router._lock:
                    return [(s.rid, len(s.toks), s.budget)
                            for s in router._sessions.values()
                            if s.replica is wk and s.toks and not s.done]

            m_wait(held, "a session held mid-decode on the victim")
            res["wk"] = m_kernels(wk, base["wk"])
            res["mid"] = held()
            wk.kill()  # SIGKILL
            outs = [f.result(timeout=600) for f in futs]
            st = router.stats()
        finally:
            router.stop()
        if not all(0 < n < budget for _rid, n, budget in res["mid"]):
            fail(f"phase 5m (c): the victim's sessions were not mid-decode "
                 f"at the kill ({res['mid']})")
        if st["failover_sessions"] < len(res["mid"]):
            fail(f"phase 5m (c): {st['failover_sessions']} sessions failed "
                 f"over for {len(res['mid'])} on the killed worker")
        m_same(torch, model.cfg, params_cpu, outs, [want[i] for i in idx],
               [prompts[i] for i in idx], [sampling[i] for i in idx],
               "(c) kill", ties)
        res["w0"] = m_kernels(w0, base["w0"])
        for name in ("w0", "w1"):
            if min(res[name]) <= 0:
                fail(f"phase 5m (c): worker {name} launched K1/K2 "
                     f"{res[name]} times in the passes")
        if res["wk"][0] <= 0:
            fail(f"phase 5m (c): the victim streamed a token but launched "
                 f"K1 {res['wk'][0]} times")
    finally:
        for w in workers:
            w.terminate()
    return res


def serving_fleet_phase(torch, model, prompts, card, single_k1):
    """Phase 5m (a)-(d); returns the K1/K2 launches of its main-path runs
    (the in-process fleets' and the workers') and prints its lines."""
    import gc
    import shutil
    import tempfile

    t_all = time.perf_counter()
    cfg = model.cfg
    params_cpu = {k: v.float().cpu() for k, v in model.flat_params().items()}
    sampling = m_sampling(len(prompts))
    ties = []
    counts = {}

    def add(c):
        for k, v in c.items():
            if k.startswith(("ragged_stream", "paged_decode")):
                counts[k] = counts.get(k, 0) + v

    t0 = time.perf_counter()
    want, single_tps = m_single(torch, model, prompts, sampling)
    outs, fleet_tps, per = m_fleet(torch, model, prompts, sampling)
    m_same(torch, cfg, params_cpu, outs, want, prompts, sampling,
           "(a) fault-free", ties)
    st, c, (k_min, k_max), chaos_tps, mid = m_chaos(
        torch, model, prompts, sampling, want, params_cpu, ties)
    add(c)
    say(f"phase 5m (a) FleetRouter over 2 in-process replicas (phase 5's "
        f"server, prefix cache on), phase 5's 16 prompts x 32, the odd ones "
        f"sampled (4s's rows): replica_kill at placement {M_KILL_AT} killed "
        f"a replica holding {mid} mid-stream sessions; failovers "
        f"{st['failovers']} failover_sessions {st['failover_sessions']}; "
        f"every session == the fault-free single server's but for near "
        f"ties ({len([t for t in ties if t[0] == '(a)'])}); kill -> first "
        f"token on the survivor {k_min:.2f} ms (the last failed-over "
        f"session's {k_max:.2f} ms); tokens_per_sec: the fault-free fleet "
        f"{fleet_tps:.1f} (its tokens == the single server's but for near "
        f"ties; prefill/decode dispatches a replica over both passes "
        f"{per}), the single server {single_tps:.1f} (both a warm pass, then "
        f"the measured one), phase 5's k=1 server {single_k1:.1f}, the "
        f"chaos run {chaos_tps:.1f} (two engines held at a token, the kill "
        f"and the failover inside its window); launches "
        f"K1 {c['ragged_stream_dense']} K2 {c['paged_decode_dense']}; "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    want8, _ = m_single(torch, model, prompts[:1], [None], passes=1,
                        kv_dtype="int8")
    for kv, w in ((None, want[0]), ("int8", want8[0])):
        r = m_migrate(torch, model, prompts[0], w, params_cpu, kv, ties)
        add(r["counts"])
        ms = r["ms"]
        if kv is None:
            size = (f"wire {r['wire']} B vs raw {r['raw_pool']} B at the "
                    f"pool's bf16 width ({r['wire'] / r['raw_pool']:.3f}x; "
                    f"the uncompressed npz as the port ships it, float32, "
                    f"{r['raw_f32']} B)")
        else:
            size = f"wire {r['wire']} B, codes and scales bit for bit"
        say(f"phase 5m (b) planned migration, {kv or 'dense'} pool, one "
            f"{prompts[0].size}-token prompt moved after {M_MIGRATE_AT} "
            f"tokens ({r['kv_tokens']} K/V tokens): the target's prefills "
            f"did not move, tokens == the single server's; {size}; export "
            f"{ms['export']:.2f} ms (a host op at the next round boundary) "
            f"wire {ms['wire']:.2f} ms import {ms['import']:.2f} ms, "
            f"migrate_session {ms['migrate']:.2f} ms [{card}]")
    say(f"phase 5m (b): {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase5m_")
    try:
        r = m_workers(torch, model, prompts, sampling, want, params_cpu,
                      ties, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in ("w0", "w1", "wk"):
        add({"ragged_stream_dense": r[name][0],
             "paged_decode_dense": r[name][1]})
    say(f"phase 5m (c) worker subprocesses on the card (python -m "
        f"paddle_tpu_torch.fleet.transport, bf16 weights from an npz, "
        f"warm_buckets before the handshake): spawn w0/w1/wk "
        f"{', '.join(f'{s:.1f}' for s in r['spawn_s'])} s (in parallel); "
        f"a live migration over the wire after the first token "
        f"({r['wire_migrate_ms']:.1f} ms) inside 8 requests on w0 and w1; "
        f"the victim wk held by its stall plan with {len(r['mid'])} "
        f"mid-decode sessions (tokens {[n for _, n, _ in r['mid']]}) and "
        f"SIGKILLed: every session completed on w0; tokens == the single "
        f"server's but for near ties; K1/K2 launches over the passes by "
        f"/stats (less the counts after the spawn) w0 "
        f"{r['w0'][0]}/{r['w0'][1]} w1 {r['w1'][0]}/{r['w1'][1]}, wk "
        f"before the kill {r['wk'][0]}/{r['wk'][1]} [{card}]")
    d = r["disagg"]
    say(f"phase 5m (d) DisaggRouter, prefill w0 -> decode w1, 4 requests: "
        f"handoffs {d['handoffs']} (failed {d['handoffs_failed']}, "
        f"finished early {d['handoffs_finished_early']}); tokens == the "
        f"single server's; the decode worker's K2 launches {r['k2_decode']}"
        f"; (c) + (d) {time.perf_counter() - t0:.1f} s [{card}]")
    say(f"phase 5m: near ties {ties or 'none'}; "
        f"{time.perf_counter() - t_all:.1f} s")
    return counts


# ---- phase 5d: sharded serving over torch.distributed -----------------------

# the ranks share the card over gloo (NCCL refuses two ranks on one device);
# GPT-2 small at full width and depth, phase 5's server shape
D_CFG = {}                      # GPT2Config overrides (none on the card)
D_SERVE_NEW = 32                # (a), (c)-(e): new tokens a request
D_FD_NEW = 24                   # (b): the front door's batch request
D_E_PROMPTS = 4                 # (d), (e): phase 5's prompts (of 16)
D_LONG = 960                    # (c): the long prompt's tokens
D_CHUNKS = (256, 480)           # (c): prefill_chunk_tokens (x sp a dispatch)
D_TIMEOUT = 420.0               # a world's hard limit (s)
# (d): int8 wire bytes / the bf16 wire's: a code a byte plus one float32
# scale a chunk of E / tp lanes against two bytes a lane, 0.505 at E 768
D_WIRE_RATIO = 0.55
D_SERVER = dict(max_slots=8, block_size=16, max_prompt_len=768,
                max_new_tokens=D_SERVE_NEW, prefill_chunk_tokens=512)


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
    out["e"] = _d_serve(torch, model, prompts[:D_E_PROMPTS], None, tp2,
                        rank, passes=2,
                        profile=DEV == "cuda")
    out["e_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["d"] = _d_serve(torch, model, prompts[:D_E_PROMPTS], None,
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
    request's Gumbel noise over the float32 CPU logits: `draw_replay`)
    lie within 4e-3 of the top draw — a near tie the summation order may
    break."""
    from paddle_tpu_torch.sampling import processors as proc

    sp = sampling
    i, z, g = draw_replay(torch, cfg, params_cpu, a, b, start, sp, "5d")
    if g is not None:
        z = proc.filter_logits(
            z / sp.temperature, torch.tensor([sp.top_k]),
            torch.tensor([sp.top_p]), torch.tensor([sp.min_p])) + g
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
    say(f"phase 5d (a) tp 2 float32 GPT-2 small, 16 requests x "
        f"{D_SERVE_NEW} "
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
        f"{D_SERVE_NEW} greedy: tokens equal the unsharded server's in every "
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
    for p, g, w in zip(prompts[:D_E_PROMPTS], d["outs"], e["outs"]):
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
    say(f"phase 5d (d) tp 2 int8 collectives, bf16, {D_E_PROMPTS} of (a)'s "
        f"prompts "
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
        f"multi-GPU number. tp 2 bf16 on {D_E_PROMPTS} of phase 5's "
        f"prompts (greedy, x {D_SERVE_NEW}): tokens_per_sec "
        f"{est['tokens_per_sec']:.1f} "
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
# depth cut to 4 of GPT-2 small's 12 layers for 4h (b)-(d), (g) and 6h
# (the script's time limit; every check stays; pp 2 takes 2 layers a stage)
H_MODEL = dict(vocab=50257, hidden=768, heads=12, layers=4, max_pos=1024)
H_DEPTH = f"{H_MODEL['layers']} of its 12 layers"
H_BATCH, H_SEQ, H_MICRO = 8, 1024, 2
H_RING = (2, 12, 1024, 64)     # (a): B, H, S, D
H_PP = (4, 256)                # (e): B, S
H_MOE = (1024, 768, 3072, 4)   # (f): tokens, d_model, d_hidden, experts
H_LR = 1e-4                    # (c): phase 4c's AdamW
H_STEPS = 2                    # 6h: measured steps (after one warm step)
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
            f"S{H_SEQ}, {H_DEPTH}): loss diff {one_loss:.3g}, largest gradient diff "
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
            f"GPT-2 small widths, {H_DEPTH}, B{H_BATCH} S{H_SEQ}, ZeRO-1 "
            f"AdamW: ms_per_step "
            f"{b0['bf16_ms']:.1f}, device busy share per rank {busy_txt}, "
            f"host-staged collectives {b0['bf16_staged_s']:.3f} s a step "
            f"(rank 0; max {max(res[r]['bf16_staged_s'] for r in res):.3f})"
            f", losses {' '.join(f'{x:.4f}' for x in b0['bf16_losses'])} — "
            f"16 ranks time-sharing one card over gloo: not a multi-GPU "
            f"number [{card}]")
        say(f"phase 6h world of one (the same code, every axis 1) bf16 B"
            f"{H_BATCH} S{H_SEQ}, {H_DEPTH}: ms_per_step {one_ms:.1f}, losses "
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
    say(f"phase 4h (b) hybrid GPT-2 small widths, {H_DEPTH}, dp2 x pp2 x "
        f"mp2 x sp2 ({H_RANKS} ranks) f32 B{H_BATCH} S{H_SEQ}, {H_MICRO} microbatches, vocab "
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
    say(f"phase 4h (c) {H_DEPTH}: two AdamW steps (lr {H_LR}, wd 0.01) "
        f"with ZeRO-1 slots (wpe's moments {r0['zero_slot']} a rank) vs single-rank "
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
    say(f"phase 4h (d) two runs of the {H_RANKS}-rank step ({H_DEPTH}): "
        f"loss and every gradient bitwise equal on every rank")
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
    say(f"phase 4h (g) sharded checkpoint ({H_DEPTH}) saved by {H_RANKS} "
        f"ranks, "
        f"reloaded into dp4 x pp2 x mp2: loss rel diff {c:.3g} (limit 1e-5)")


# ---- phase 4k: the fleet's strategy layer over torch.distributed ------------

K_BATCH, K_SEQ = 4, 1024       # (a): the global batch of GPT-2 small
K_SMALL = (2, 128)             # (b): B, S of the 2-layer full-width GPT-2
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
K_LAYERS = 4                   # (a): depth cut to 4 of GPT-2 small's 12


def _k_cfg(small=False):
    from paddle_tpu_torch.models import GPT2Config
    return GPT2Config(num_layers=2 if small else K_LAYERS, dropout=0.0)


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
    """(a): GPT-2 small at full width, K_LAYERS of its 12 layers, S 1024,
    dp 2, two steps per flag set against the world of one."""
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
        say(f"phase 4k (a) fleet {name} GPT-2 small widths, {K_LAYERS} of "
            f"its 12 layers, f32 dp {K_RANKS} B"
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
    say(f"phase 4k (a) fleet amp ({K_LAYERS} of 12 layers, bf16 compute, "
        f"float32 masters): losses "
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



# ---- phases 4v / 6v: paddle.vision and the fluid-era ops --------------------

V_SEED = 61
V_LR = 1e-4                    # phase 4c's AdamW
V_B, V_IMG = 2, 224            # 4v (a): ResNet-50's parity step
V_FLOPS = 3 * 4.1e9            # bench.py's FLOPs a ResNet-50 sample (224²)
V_BATCHES = (128, 256)         # 6v: bench.py's candidates on the card
V_CIFAR_MEAN = [125.3, 123.0, 113.9]
V_CIFAR_STD = [63.0, 62.1, 66.7]


def _v_resnet50(ptt, data_format):
    from paddle_tpu_torch.vision.models.resnet import BottleneckBlock, ResNet
    return ResNet(BottleneckBlock, 50, num_classes=1000,
                  data_format=data_format)


def v_step(torch, ptt, model, x, y):
    """One train-mode forward, backward and AdamW step (lr 1e-4, wd 0.01)
    of `model` on its device: (loss, gradients, state after the step),
    the tensors as float64 on the CPU."""
    model.train()
    dev = model.parameters()[0].device
    opt = ptt.optimizer.AdamW(V_LR, parameters=model.parameters(),
                              weight_decay=0.01, device=dev)
    loss = ptt.nn.functional.cross_entropy(model(x), y)
    loss.backward()
    grads = {n: p.grad.detach().double().cpu()
             for n, p in model.named_parameters()}
    opt.step()
    state = {k: v.detach().double().cpu()
             for k, v in model.state_dict().items()}
    return loss.item(), grads, state


def _v_worst(torch, got, want, keys=None):
    """(worst error over the reference's largest magnitude, its key)."""
    out = (-1.0, "")
    for k in keys if keys is not None else want:
        r = (got[k] - want[k]).abs().max().item() / max(
            want[k].abs().max().item(), 1e-30)
        out = max(out, (r, k))
    return out


def v_resnet_parity(torch, ptt):
    """Phase 4v (a): ResNet-50 (1000 classes) at 224², B 2, one step on
    the card and on the CPU from one set of weights, NCHW and NHWC, in
    float32 and in float64. Returns the rows and the float32 floor."""
    import copy

    from paddle_tpu_torch.device import device_guard

    rs = np.random.RandomState(V_SEED)
    x = torch.from_numpy(rs.rand(V_B, 3, V_IMG, V_IMG).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 1000, V_B))
    with device_guard("cpu"):
        ptt.seed(V_SEED)
        base = _v_resnet50(ptt, "NCHW")
        base_nhwc = _v_resnet50(ptt, "NHWC")
        base_nhwc.set_state_dict(base.state_dict())
    xs = {"NCHW": x, "NHWC": x.permute(0, 2, 3, 1).contiguous()}
    bases = {"NCHW": base, "NHWC": base_nhwc}

    def run(fmt, dev, dt):
        m = copy.deepcopy(bases[fmt]).to(device=dev, dtype=dt)
        return v_step(torch, ptt, m, xs[fmt].to(dev, dt), y.to(dev))

    cpu = {dt: run("NCHW", "cpu", dt) for dt in (torch.float32,
                                                torch.float64)}
    cpu_nhwc = run("NHWC", "cpu", torch.float32)
    if cpu_nhwc[0] != cpu[torch.float32][0] or any(
            not torch.equal(cpu_nhwc[1][n], g)
            for n, g in cpu[torch.float32][1].items()):
        fail("phase 4v (a): the NHWC ResNet-50's step on the CPU differs "
             "from the NCHW one's (they must be bitwise equal there)")
    floor = _v_worst(torch, cpu[torch.float32][1], cpu[torch.float64][1])
    rows = []
    limit = 2 * V_LR + 1e-6
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        loss_c, grads_c, state_c = cpu[dt]
        for fmt in ("NCHW", "NHWC"):
            loss, grads, state = run(fmt, DEV, dt)
            rel = abs(loss - loss_c) / abs(loss_c)
            grad = _v_worst(torch, grads, grads_c)
            bufs = [k for k in state_c if k.endswith(("_mean", "_variance"))]
            buf = _v_worst(torch, state, state_c, bufs)
            par = max(((state[k] - state_c[k]).abs().max().item(), k)
                      for k in state_c if k not in bufs)
            if rel > 1e-4 or buf[0] > 1e-4 or par[0] > limit:
                fail(f"phase 4v (a) ResNet-50 {fmt} {tag}: loss rel diff "
                     f"{rel:.3g} (limit 1e-4), BatchNorm buffer {buf[1]} "
                     f"{buf[0]:.3g} of its magnitude (limit 1e-4), "
                     f"parameter {par[1]} {par[0]:.3g} (limit {limit:.3g})")
            if dt == torch.float64 and grad[0] > 1e-3:
                fail(f"phase 4v (a) ResNet-50 {fmt} f64: gradient {grad[1]} "
                     f"differs by {grad[0]:.3g} of its magnitude (> 1e-3)")
            rows.append((fmt, tag, loss, loss_c, rel, grad, buf, par))
        torch.cuda.empty_cache()
    return rows, floor


def v_ops_parity(torch, ptt):
    """Phase 4v (b): the fluid-era functional ops and the detection chain
    on seeded inputs, card vs CPU: [(name, max error over the CPU's
    largest magnitude, or 'equal')]."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import vision
    from paddle_tpu_torch.device import device_guard

    rs = np.random.RandomState(V_SEED + 1)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(
            np.float32))

    def boxes(n, size):
        xy = rs.rand(n, 2) * size
        wh = rs.rand(n, 2) * size / 3 + 1
        return torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(
            np.float32))

    store = F.legacy_param_store()
    x, cw, cb = f32(8, 64, 32), f32(96, 48, scale=0.1), f32(48)
    lens = torch.from_numpy(rs.randint(1, 65, 8))
    ids = torch.from_numpy(rs.randint(0, 1000, (8, 64)))
    emis = f32(16, 40, 12)
    tags = torch.from_numpy(rs.randint(0, 12, (16, 40)))
    tlens = torch.from_numpy(rs.randint(1, 41, 16))
    store.set_buffer("crf_transition_12", f32(14, 12, scale=0.5))
    nx, nl = f32(64, 128), torch.from_numpy(rs.randint(0, 1000, (64, 1)))
    nw, nb = f32(1000, 128, scale=0.1), f32(1000, scale=0.1)
    dx, doff = f32(2, 16, 32, 32), f32(2, 18, 32, 32, scale=2.0)
    dmask, dw = torch.sigmoid(f32(2, 9, 32, 32)), f32(32, 16, 3, 3,
                                                      scale=0.1)
    img = f32(4, 8, 37, 53)
    ax, qkv_w, qkv_b = f32(4, 128, 256), f32(256, 768, scale=0.05), \
        f32(768, scale=0.05)
    out_w, out_b = f32(256, 256, scale=0.05), f32(256, scale=0.05)
    yx = f32(1, 2 * 8, 16, 16)
    rx, rois = f32(2, 16, 24, 24), boxes(7, 20)
    feat, image = torch.zeros(1, 64, 19, 19), torch.zeros(1, 3, 300, 300)
    gt, dl = boxes(8, 250) / 300, f32(19 * 19 * 4, 4, scale=0.1)
    ps, pd = torch.rand(1, 3, 16, 16, generator=torch.Generator()
                        .manual_seed(V_SEED)), f32(1, 12, 16, 16, scale=0.1)
    fmap = torch.zeros(1, 8, 16, 16)
    im_info = torch.tensor([[256.0, 256.0, 1.0]])

    def cases(dev, tag):
        t = (lambda a: a.to(dev))  # noqa: E731
        for name in ("w", "b"):
            store.parameter(f"nce/v_{tag}.{name}", (nw if name == "w"
                                                    else nb).shape,
                            device=dev).data.copy_(nw if name == "w" else nb)
        store.parameter(f"deformable_conv/v_{tag}", dw.shape,
                        device=dev).data.copy_(dw)
        out = {}
        for kind in ("sum", "average", "sqrt", "max", "min", "first",
                     "last"):
            out[f"sequence_pool {kind}"] = F.sequence_pool(
                t(x), kind, seq_len=t(lens))
        out["sequence_softmax"] = F.sequence_softmax(t(x), t(lens))
        out["sequence_reverse"] = F.sequence_reverse(t(x), t(lens))
        out["sequence_pad"] = F.sequence_pad(t(x), -1.0, 80, t(lens))
        out["sequence_unpad"] = F.sequence_unpad(t(x), t(lens))
        out["sequence_conv"] = F.sequence_conv(t(x), t(cw), t(cb),
                                               seq_len=t(lens))
        out["sequence_enumerate"] = F.sequence_enumerate(t(ids), 3, 0)
        out["sequence_slice"] = F.sequence_slice(
            t(x), t(lens // 4), lens // 2)
        out["sequence_scatter"] = F.sequence_scatter(
            t(x), t(ids[:, :5] % 64), t(x[:, :5]))
        out["sequence_expand"] = F.sequence_expand(t(x[:, :1]), t(x))
        out["sequence_last_step"] = F.sequence_last_step(t(x), t(lens))
        out["linear_chain_crf"] = F.linear_chain_crf(t(emis), t(tags),
                                                     length=t(tlens))
        out["crf_decoding"] = F.crf_decoding(t(emis))
        out["nce"] = F.nce(t(nx), t(nl), 1000, num_neg_samples=16,
                           name=f"v_{tag}", generator=torch.Generator()
                           .manual_seed(V_SEED))
        out["deformable_conv"] = F.deformable_conv(
            t(dx), t(doff), t(dmask), 32, 3, padding=1, name=f"v_{tag}")
        out["image_resize bilinear"] = F.image_resize(t(img), [64, 80])
        out["image_resize nearest"] = F.resize_nearest(t(img), [20, 90])
        with DenseSpy() as dense:
            out["fused_multi_head_attention"] = \
                F.fused_multi_head_attention(t(ax), t(qkv_w), t(qkv_b),
                                             t(out_w), t(out_b), 8,
                                             is_causal=True)
        if dense.calls != 1:
            fail(f"phase 4v (b): fused_multi_head_attention took the dense "
                 f"path {dense.calls} times on {tag}, expected 1")
        bx, sc = F.yolo_box(t(yx), t(torch.tensor([[512, 512]])),
                            [10, 13, 16, 30], 3, conf_thresh=0.01)
        out["yolo_box boxes"], out["yolo_box scores"] = bx, sc
        out["yolo_box -> multiclass_nms"] = F.multiclass_nms(
            bx[0], sc[0].T, score_threshold=0.05, nms_top_k=200,
            keep_top_k=50, nms_threshold=0.45, background_label=-1)
        out["roi_align"] = vision.ops.roi_align(
            t(rx), t(rois), boxes_num=t(torch.tensor([3, 4])),
            output_size=7, spatial_scale=1.0)
        out["roi_pool"] = F.roi_pool(t(rx), t(rois), output_size=7)
        pb, pv = F.prior_box(t(feat), t(image), [60.0], [111.0], [2.0],
                             flip=True, clip=True)
        pb, pv = pb.reshape(-1, 4), pv.reshape(-1, 4)
        out["prior_box"] = pb
        out["prior_box -> box_coder encode"] = F.box_coder(
            pb, pv, t(gt), code_type="encode_center_size")
        out["prior_box -> box_coder decode"] = F.box_coder(
            pb, pv, t(dl), code_type="decode_center_size")
        an, av = F.anchor_generator(t(fmap), [32.0], [0.5, 1.0, 2.0],
                                    stride=[16.0, 16.0])
        out["generate_proposals"] = F.generate_proposals(
            t(ps), t(pd), t(im_info), an, av, pre_nms_top_n=500,
            post_nms_top_n=100, return_rois_num=True)
        return out

    with device_guard(DEV):
        card = cases(DEV, "card")
    with device_guard("cpu"):
        cpu = cases("cpu", "cpu")
    rows = []
    for name, want in cpu.items():
        got = card[name]
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        worst = 0.0
        for a, b in zip(got, want):
            a = a.detach().cpu()
            b = b.detach()
            if a.shape != b.shape:
                fail(f"phase 4v (b) {name}: shape {tuple(a.shape)} on the "
                     f"card vs {tuple(b.shape)} on the CPU")
            if not b.is_floating_point():
                if not torch.equal(a, b):
                    fail(f"phase 4v (b) {name}: indices / classes differ "
                         f"between the card and the CPU")
                continue
            e = (a - b).abs().max().item() / max(b.abs().max().item(),
                                                 1e-30)
            worst = max(worst, e)
        if name == "yolo_box -> multiclass_nms":
            a, b = got[0].detach().cpu(), want[0].detach()
            if not torch.equal(a[:, 0], b[:, 0]):
                fail("phase 4v (b) yolo_box -> multiclass_nms: the kept "
                     "rows' classes (and order) differ between the card "
                     "and the CPU")
        if worst > 1e-4:
            fail(f"phase 4v (b) {name}: card vs CPU {worst:.3g} of the "
                 f"largest magnitude (limit 1e-4)")
        rows.append((name, worst))
    kept = int((cpu["yolo_box -> multiclass_nms"][:, 0] >= 0).sum())
    n_props = int(cpu["generate_proposals"][2])
    return rows, kept, n_props


def _v_fit(torch, ptt, dev, net, ds, workers, rec):
    """Model(net).fit over `ds` for one epoch of B 8 on `dev`, recording
    each step's batch, loss and (the fused step's) gradients."""
    from paddle_tpu_torch.device import device_guard

    with device_guard(dev):
        m = ptt.Model(net)
        opt = ptt.optimizer.Momentum(0.01, momentum=0.9,
                                     parameters=net.parameters())
        real_update = opt.functional_update

        def update(params, grads, state, lr=None, **kw):
            rec["grads"].append({n: g.detach().double().cpu()
                                 for n, g in grads.items()})
            return real_update(params, grads, state, lr=lr, **kw)

        opt.functional_update = update
        m.prepare(opt, ptt.nn.CrossEntropyLoss())
        real = m.train_batch

        def train_batch(inputs, labels=None):
            rec["batches"].append((inputs[0].cpu().clone(),
                                   labels[0].cpu().clone()))
            logs = real(inputs, labels)
            rec["losses"].append(logs[0])
            return logs

        m.train_batch = train_batch
        np.random.seed(43)
        m.fit(ds, batch_size=8, epochs=1, shuffle=True, num_workers=workers,
              verbose=0)


def v_fit_parity(torch, ptt):
    """Phase 4v (c): paddle.Model(resnet18(num_classes=10)).fit, 2 steps
    of B 8 (Momentum lr 0.01, 0.9), over Cifar10's synthetic test split
    through Compose([Normalize, Transpose]) — in float64 the network
    casts its float32 batch on entry — DataLoader(num_workers=2) on the
    card vs
    num_workers=0 on the CPU, from one set of weights. Batches bitwise
    equal in both; float64: losses within 1e-4 and gradients within 1e-3
    (4j's limits); float32: the first loss within 1e-4 (the forward), the
    second printed with the first step's gradient errors against the CPU's
    float64 step."""
    from paddle_tpu_torch import vision
    from paddle_tpu_torch.device import device_guard

    T = vision.transforms
    with device_guard("cpu"):
        ptt.seed(V_SEED + 2)
        base = vision.models.resnet18(num_classes=10)
    out = {}
    for dt in (torch.float64, torch.float32):
        ds = ptt.io.Subset(vision.datasets.Cifar10(
            mode="test", transform=T.Compose([
                T.Normalize(mean=V_CIFAR_MEAN, std=V_CIFAR_STD,
                            data_format="HWC"), T.Transpose()])),
            list(range(16)))
        recs = {}
        for key, dev, workers in (("card", DEV, 2), ("cpu", "cpu", 0)):
            with device_guard(dev):
                net = vision.models.resnet18(num_classes=10).to(dtype=dt)
            net.set_state_dict(base.state_dict())
            if dt == torch.float64:  # the float32 batch, cast on entry
                net.register_forward_pre_hook(
                    lambda m, inputs: tuple(x.double() for x in inputs))
            recs[key] = {"batches": [], "losses": [], "grads": []}
            _v_fit(torch, ptt, dev, net, ds, workers, recs[key])
        card, cpu = recs["card"], recs["cpu"]
        if len(card["losses"]) != 2 or len(cpu["losses"]) != 2:
            fail(f"phase 4v (c): {len(card['losses'])} / "
                 f"{len(cpu['losses'])} steps, expected 2")
        for i, ((a, la), (b, lb)) in enumerate(zip(card["batches"],
                                                   cpu["batches"])):
            if not (torch.equal(a, b) and torch.equal(la, lb)):
                fail(f"phase 4v (c) step {i}: the worker batch on the card "
                     f"differs from the CPU's")
        rel = [abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                   cpu["losses"])]
        out[dt] = (card, cpu, rel)
    card64, cpu64, rel64 = out[torch.float64]
    floor = 1e-3 * max(g.abs().max().item()
                       for g in cpu64["grads"][0].values())
    g64 = max(((card64["grads"][0][n] - g).abs().max().item()
               / max(g.abs().max().item(), floor), n)
              for n, g in cpu64["grads"][0].items())
    if max(rel64) > 1e-4 or g64[0] > 1e-3:
        fail(f"phase 4v (c) float64: losses {card64['losses']} vs CPU "
             f"{cpu64['losses']} (relative {max(rel64):.3g}, limit 1e-4), "
             f"gradient {g64[1]} {g64[0]:.3g} (limit 1e-3)")
    card32, cpu32, rel32 = out[torch.float32]
    if rel32[0] > 1e-4:
        fail(f"phase 4v (c) float32: first loss {card32['losses'][0]} vs "
             f"CPU {cpu32['losses'][0]} (relative {rel32[0]:.3g} > 1e-4)")
    truth = cpu64["grads"][0]
    err = {k: _v_worst(torch, r["grads"][0], truth)
           for k, r in (("card", card32), ("cpu", cpu32))}
    return {"losses64": (card64["losses"], cpu64["losses"], max(rel64)),
            "grad64": g64, "losses32": (card32["losses"],
                                        cpu32["losses"], rel32),
            "grad32": err, "shape": tuple(card32["batches"][0][0].shape)}


def vision_parity_phase(torch, card):
    """Phase 4v: (a) ResNet-50's step, (b) the ops, (c) Model.fit."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    rows, floor = v_resnet_parity(torch, ptt)
    for fmt, tag, loss, loss_c, rel, grad, buf, par in rows:
        gate = "limit 1e-3" if tag == "f64" else (
            f"not gated in float32: the CPU's own float32 step is "
            f"{floor[0]:.3g} from float64 at {floor[1]}")
        say(f"phase 4v (a) ResNet-50 {fmt} {tag} B{V_B} {V_IMG}² train "
            f"step + AdamW (lr {V_LR}, wd 0.01) card vs CPU: loss "
            f"{loss:.6f} vs {loss_c:.6f} (rel diff {rel:.3g}, limit 1e-4), "
            f"worst gradient {grad[1]} {grad[0]:.3g} of its magnitude "
            f"({gate}), worst BatchNorm buffer {buf[1]} {buf[0]:.3g} "
            f"(limit 1e-4), worst parameter {par[1]} {par[0]:.3g} (limit "
            f"{2 * V_LR + 1e-6:.3g})")
    t1 = time.perf_counter()
    ops, kept, n_props = v_ops_parity(torch, ptt)
    say(f"phase 4v (b) fluid-era ops and the detection chain, card vs CPU "
        f"({len(ops)} outputs; indices and classes equal, floats within "
        f"1e-4 of the largest magnitude; multiclass_nms kept {kept} rows, "
        f"generate_proposals {n_props}): " + ", ".join(
            f"{n} {e:.2g}" for n, e in ops))
    t2 = time.perf_counter()
    r = v_fit_parity(torch, ptt)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    (c64, p64, rel64), (c32, p32, rel32) = r["losses64"], r["losses32"]
    say(f"phase 4v (c) Model(resnet18(num_classes=10)).fit, 2 Momentum "
        f"steps (lr 0.01) of B8 Cifar10 (synthetic) through Compose("
        f"[Normalize, Transpose]), DataLoader(num_workers=2) on the card vs "
        f"num_workers=0 on the CPU: batches {list(r['shape'])} bitwise "
        f"equal; float64 losses {' '.join(f'{x:.6f}' for x in c64)} vs "
        f"{' '.join(f'{x:.6f}' for x in p64)} (rel diff {rel64:.3g}, limit "
        f"1e-4), worst gradient {r['grad64'][1]} {r['grad64'][0]:.3g} "
        f"(limit 1e-3); float32 losses {' '.join(f'{x:.6f}' for x in c32)} "
        f"vs {' '.join(f'{x:.6f}' for x in p32)} (rel diff "
        f"{' '.join(f'{x:.3g}' for x in rel32)}; the first, the forward, "
        f"limit 1e-4), the first step's float32 gradients against the "
        f"CPU's float64: card {r['grad32']['card'][0]:.3g} at "
        f"{r['grad32']['card'][1]}, CPU {r['grad32']['cpu'][0]:.3g} at "
        f"{r['grad32']['cpu'][1]}; kernel launches in 4v {counts or 'none'} "
        f"(this path reaches no TPU kernel); (a) {t1 - t0:.1f} s, (b) "
        f"{t2 - t1:.1f} s, (c) {time.perf_counter() - t2:.1f} s [{card}]")


def v_throughput(torch, ptt, batch, data_format, warm=2, steps=5):
    """Phase 6v: bench.py's resnet50 axis — ResNet-50 at 224² training
    under amp.auto_cast() (bf16 convolutions and products, O1) with AdamW
    (lr 1e-4, wd 0.01) on float32 parameters, on random images and labels
    from RandomState(0): ms a step (CUDA events), samples/s, peak memory,
    FLOP/s at bench.py's 3 x 4.1e9 a sample, the idle share of a profiled
    step, the losses."""
    ptt.seed(V_SEED)
    model = _v_resnet50(ptt, data_format)
    model.train()
    opt = ptt.optimizer.AdamW(V_LR, parameters=model.parameters(),
                              weight_decay=0.01)
    ce = ptt.nn.CrossEntropyLoss()
    rs = np.random.RandomState(0)
    shape = (batch, V_IMG, V_IMG, 3) if data_format == "NHWC" else \
        (batch, 3, V_IMG, V_IMG)
    images = torch.from_numpy(rs.rand(*shape).astype(np.float32)).to(DEV)
    labels = torch.from_numpy(rs.randint(0, 1000, (batch,))).to(DEV)

    def step():
        with ptt.amp.auto_cast():
            loss = ce(model(images), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    losses = [step() for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses += [step() for _ in range(steps)]
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) / steps
    ms = start.elapsed_time(end) / steps
    busy = profiled_busy(torch, step)
    losses = [x.item() for x in losses]
    if not all(np.isfinite(losses)):
        fail(f"phase 6v ResNet-50 {data_format} B{batch}: non-finite loss "
             f"{losses}")
    out = {"ms": ms, "wall_ms": wall * 1e3, "samples": batch / (ms / 1e3),
           "peak": torch.cuda.max_memory_allocated(),
           "flops": V_FLOPS * batch / (ms / 1e3), "busy_ms": busy * 1e3,
           "idle": 1 - busy / wall, "losses": losses}
    del model, opt, images
    torch.cuda.empty_cache()
    return out


def vision_throughput_phase(torch, card):
    """Phase 6v: `v_throughput` at each of bench.py's batches, NCHW and
    NHWC."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import kernels

    for batch in V_BATCHES:
        for fmt in ("NCHW", "NHWC"):
            t0 = time.perf_counter()
            kernels.reset_launch_counts()
            r = v_throughput(torch, ptt, batch, fmt)
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            say(f"phase 6v ResNet-50 {fmt} B{batch} {V_IMG}² train, "
                f"amp.auto_cast() bf16 (O1) + AdamW on f32 parameters: "
                f"ms_per_step {r['ms']:.2f} (host {r['wall_ms']:.2f}) "
                f"samples_per_sec {r['samples']:.1f} FLOP/s "
                f"{r['flops'] / 1e12:.1f} T at bench.py's 3 x 4.1e9 a "
                f"sample ({r['flops'] / PEAK_FLOPS:.3f} of the 989 TFLOP/s "
                f"bf16 peak) max_memory_allocated {r['peak'] / 2**20:.0f} "
                f"MiB; device busy {r['busy_ms']:.2f} ms in a profiled "
                f"step, idle share {r['idle']:.3f}; losses "
                f"{' '.join(f'{x:.4f}' for x in r['losses'])}; kernel "
                f"launches {counts or 'none'}; "
                f"{time.perf_counter() - t0:.1f} s [{card}]")


# ---- phases 4q / 6q: paddle.slim (QAT, int8 PTQ) and the 1.x pipeline --------

Q_POOL = 16             # 4q (b): images in the seeded calibration reader
Q_CALIB = 2             # 4q (b): calibration batches of B V_B
Q_SCALE_REL = 1e-5      # 4q (b): calibrated activation scales card vs CPU
#                         (50 float32 layers in another order of summation:
#                         2.35e-6-2.42e-6 measured)
Q_QAT_SCALE_REL = 1e-6  # 4q (c): act_scale buffers in float64
Q_LOGIT_REL = 2e-2      # 4q (b): int8 logits, of the CPU's largest |logit|
Q_BATCHES = (64, 256)   # 6q (a): int8 inference batches
Q_QAT_B = 64            # 6q (c): the QAT step's batch
Q_STEPS = (2, 5)        # 6q (c): warm, measured steps


def q_reader(n, seed, pool=None):
    """A seeded 224² 1.x reader: n (image CHW float32, label) samples drawn
    from RandomState(seed), or cycling over the first `pool` draws."""
    def draw(rs):
        return (rs.rand(3, V_IMG, V_IMG).astype(np.float32),
                int(rs.randint(0, 1000)))

    def reader():
        rs = np.random.RandomState(seed)
        made = [draw(rs) for _ in range(pool)] if pool else None
        for i in range(n):
            yield made[i % pool] if pool else draw(rs)
    return reader


def _q_stack(batch):
    """A `paddle.batch` list of samples -> (images [B, 3, H, W], labels)."""
    return (np.stack([s[0] for s in batch]),
            np.asarray([s[1] for s in batch], np.int64))


def q_codes_parity(torch, ptt):
    """4q (a): codes of an activation-sized tensor (B 2 x 64 x 112 x 112,
    a scale that clips) per tensor by a float and by a tensor, of a conv
    weight per channel, and fake_quant's values and STE mask, card vs
    CPU: the number of elements that differ in each (all must be 0)."""
    from paddle_tpu_torch import slim

    rs = np.random.RandomState(V_SEED + 3)
    x = torch.from_numpy((rs.randn(V_B, 64, 112, 112) * 3).astype(
        np.float32))
    w = torch.from_numpy((rs.randn(256, 64, 3, 3) * 0.05).astype(
        np.float32))
    a = 0.7 * float(x.abs().max())
    out = {}
    for dev in (DEV, "cpu"):
        xd = x.to(dev).requires_grad_()
        wd = w.to(dev)
        at = torch.tensor(a, device=dev)
        y = slim.fake_quant(xd, at)
        y.backward(torch.ones_like(y))
        out[dev] = [slim.quantize_symmetric(xd.detach(), a),
                    slim.quantize_symmetric(xd.detach(), at),
                    slim.quantize_symmetric(wd, slim.weight_scale_of(
                        wd, "channel_wise_abs_max", "conv")),
                    y.detach(), xd.grad != 0]
    names = ("codes (float scale)", "codes (tensor scale)",
             "weight codes (per channel)", "fake_quant values", "STE mask")
    diff = {n: int((g.cpu() != c).sum()) for n, g, c in
            zip(names, out[DEV], out["cpu"])}
    if any(diff.values()):
        fail(f"phase 4q (a): card vs CPU elements differ: {diff}")
    clipped = float(1 - out["cpu"][4].float().mean())
    return diff, x.numel(), clipped


def q_ptq_parity(torch, ptt):
    """4q (b): ResNet-50 (1000 classes) at B 2, 224², eval, float32: on
    the card and on the CPU from one set of weights, `fuse_conv_bn` (4
    pairs), then PostTrainingQuantization (channel-wise weights) over
    Q_CALIB batches of `paddle.batch(paddle.reader.shuffle(q_reader,
    64), 2)`, abs_max and hist, then convert; checks per algo: every
    frozen weight code and scale bitwise, the activation scales within
    Q_SCALE_REL, the int8 logits of a seeded batch within Q_LOGIT_REL of
    the CPU's largest, top-1 equal but at near ties; the share of
    activation codes that differ."""
    import copy
    import random

    from paddle_tpu_torch import slim
    from paddle_tpu_torch.device import device_guard

    with device_guard("cpu"):
        ptt.seed(V_SEED + 4)
        base = _v_resnet50(ptt, "NCHW")
    base.eval()
    random.seed(V_SEED)
    calib = [(_q_stack(b)[0],) for b in ptt.batch(ptt.reader.shuffle(
        q_reader(Q_POOL, V_SEED + 5), 64), V_B)()][:Q_CALIB]
    x = torch.from_numpy(np.random.RandomState(V_SEED + 6).rand(
        V_B, 3, V_IMG, V_IMG).astype(np.float32))
    rows = {}
    for algo in ("abs_max", "hist"):
        res = {}
        for dev in (DEV, "cpu"):
            m = copy.deepcopy(base).to(dev)
            pairs = slim.fuse_conv_bn(m)
            ptq = slim.PostTrainingQuantization(
                model=m, algo=algo, weight_quantize_type="channel_wise_abs_max")
            ptq.quantize(data_loader=calib)
            codes = []

            def grab(mod, inputs):
                codes.append(slim.quantize_symmetric(
                    inputs[0], mod._a_scale_frozen).cpu())

            hooks = [q.register_forward_pre_hook(grab) for q in ptq._wrapped]
            with torch.no_grad():
                logits = m(x.to(dev)).cpu()
            for h in hooks:
                h.remove()
            res[dev] = dict(pairs=pairs, n=len(ptq._wrapped), codes=codes,
                            logits=logits,
                            wq=[q._wq.cpu() for q in ptq._wrapped],
                            ws=[q._w_scale_frozen.cpu() for q in ptq._wrapped],
                            a=[q._a_scale_frozen for q in ptq._wrapped])
            del m, ptq
        card, cpu = res[DEV], res["cpu"]
        if card["pairs"] != 4 or cpu["pairs"] != 4 or card["n"] != 54:
            fail(f"phase 4q (b) {algo}: fuse_conv_bn fused {card['pairs']} "
                 f"/ {cpu['pairs']} pairs (expected 4), {card['n']} "
                 f"quantized layers (expected 54)")
        bad_w = sum(not (torch.equal(a, b) and torch.equal(s, t))
                    for a, b, s, t in zip(card["wq"], cpu["wq"], card["ws"],
                                          cpu["ws"]))
        a_rel = max(abs(p - q) / q for p, q in zip(card["a"], cpu["a"]))
        n_codes = sum(c.numel() for c in cpu["codes"])
        d_codes = sum(int((a != b).sum()) for a, b in zip(card["codes"],
                                                         cpu["codes"]))
        big = cpu["logits"].abs().max().item()
        l_rel = (card["logits"] - cpu["logits"]).abs().max().item() / big
        top2 = cpu["logits"].topk(2, dim=1).values
        tie = (top2[:, 0] - top2[:, 1]) < Q_LOGIT_REL * big
        agree = card["logits"].argmax(1) == cpu["logits"].argmax(1)
        if bad_w or a_rel > Q_SCALE_REL or l_rel > Q_LOGIT_REL or \
                not bool((agree | tie).all()):
            fail(f"phase 4q (b) {algo}: {bad_w} layers' frozen weight codes "
                 f"or scales differ card vs CPU; activation scales "
                 f"{a_rel:.3g} apart (limit {Q_SCALE_REL}); logits "
                 f"{l_rel:.3g} of the largest (limit {Q_LOGIT_REL}); top-1 "
                 f"{agree.tolist()} near ties {tie.tolist()}")
        rows[algo] = dict(a_rel=a_rel, share=d_codes / n_codes, n=n_codes,
                          l_rel=l_rel, ties=int(tie.sum()),
                          top1=agree.tolist())
    return rows


def q_qat_parity(torch, ptt):
    """4q (c): QAT (channel-wise weights, moving_average_abs_max) of
    ResNet-50 at B 2, 224², two AdamW steps (lr 1e-4, wd 0.01) on the
    card and on the CPU from one set of weights, in float64 and in
    float32. Gated in float64 (ROADMAP §C 44, §C 50): losses within
    1e-4, parameters within 2 lr steps, BatchNorm buffers 1e-4, the
    act_scale buffers within Q_QAT_SCALE_REL, the first step's gradients
    within 1e-3 of their leaf. In float32 the fake quantization turns
    the devices' rounding differences into code flips that cascade
    through the layers (the losses differ at the int8 noise level): its
    numbers are printed, and only finiteness is gated."""
    import copy

    from paddle_tpu_torch import slim
    from paddle_tpu_torch.device import device_guard

    rs = np.random.RandomState(V_SEED + 7)
    x = torch.from_numpy(rs.rand(V_B, 3, V_IMG, V_IMG).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 1000, V_B))
    with device_guard("cpu"):
        ptt.seed(V_SEED + 7)
        base = _v_resnet50(ptt, "NCHW")

    def run(dev, dt):
        m = copy.deepcopy(base).to(device=dev, dtype=dt)
        slim.ImperativeQuantAware(
            weight_quantize_type="channel_wise_abs_max",
            activation_quantize_type="moving_average_abs_max").quantize(m)
        m.train()
        opt = ptt.optimizer.AdamW(V_LR, parameters=m.parameters(),
                                  weight_decay=0.01, device=dev)
        losses, grads = [], None
        for _ in range(2):
            loss = ptt.nn.functional.cross_entropy(m(x.to(dev, dt)),
                                                   y.to(dev))
            loss.backward()
            if grads is None:
                grads = {n: p.grad.detach().double().cpu()
                         for n, p in m.named_parameters()}
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        state = {k: v.detach().double().cpu()
                 for k, v in m.state_dict().items()}
        return losses, grads, state

    rows = {}
    limit = 2 * V_LR * 2 + 1e-6
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        (lc, gc, sc), (lg, gg, sg) = run("cpu", dt), run(DEV, dt)
        rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
        acts = [k for k in sc if k.endswith("act_scale")]
        bufs = [k for k in sc if k.endswith(("_mean", "_variance"))]
        a_rel = max(abs(sg[k].item() - sc[k].item()) / sc[k].item()
                    for k in acts)
        buf = _v_worst(torch, sg, sc, bufs)
        par = max(((sg[k] - sc[k]).abs().max().item(), k)
                  for k in sc if k not in acts and k not in bufs)
        grad = _v_worst(torch, gg, gc)
        if not np.isfinite(lg + lc).all() or dt == torch.float64 and (
                rel > 1e-4 or a_rel > Q_QAT_SCALE_REL or buf[0] > 1e-4 or
                par[0] > limit or grad[0] > 1e-3):
            fail(f"phase 4q (c) QAT ResNet-50 {tag}: losses {lg} vs {lc} "
                 f"(rel {rel:.3g}, limit 1e-4), act_scale {a_rel:.3g} (limit "
                 f"{Q_QAT_SCALE_REL}), BatchNorm buffer {buf[1]} "
                 f"{buf[0]:.3g} (limit 1e-4), parameter {par[1]} "
                 f"{par[0]:.3g} (limit {limit:.3g}), gradient {grad[1]} "
                 f"{grad[0]:.3g} (limit 1e-3)")
        rows[tag] = dict(losses=(lg, lc), rel=rel, a_rel=a_rel, n=len(acts),
                         buf=buf, par=par, grad=grad)
        torch.cuda.empty_cache()
    return rows


def q_viterbi_parity(torch, ptt):
    """4q (d): text.viterbi_decode on a seeded [8, 64, 32] potential and
    [32, 32] transitions, card vs CPU: paths equal, scores within 1e-5."""
    rs = np.random.RandomState(V_SEED + 8)
    pot = torch.from_numpy(rs.randn(8, 64, 32).astype(np.float32))
    trans = torch.from_numpy(rs.randn(32, 32).astype(np.float32))
    sc, pc = ptt.text.viterbi_decode(pot, trans)
    sg, pg = ptt.text.viterbi_decode(pot.to(DEV), trans.to(DEV))
    err = (sg.cpu() - sc).abs().max().item()
    if not torch.equal(pg.cpu(), pc) or err > 1e-5:
        fail(f"phase 4q (d) viterbi_decode: paths equal "
             f"{torch.equal(pg.cpu(), pc)}, scores {err:.3g} (limit 1e-5)")
    return err


def quant_parity_phase(torch, card):
    """Phase 4q: (a) codes, (b) PTQ, (c) QAT, (d) viterbi_decode."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    diff, n, clipped = q_codes_parity(torch, ptt)
    say(f"phase 4q (a) quantize_symmetric / fake_quant card vs CPU on "
        f"{n} activations (B{V_B} x 64 x 112 x 112, {clipped:.3f} clipped) "
        f"and a 256 x 64 x 3 x 3 weight per channel: elements that differ "
        f"{diff} (all must be 0)")
    t1 = time.perf_counter()
    for algo, r in q_ptq_parity(torch, ptt).items():
        say(f"phase 4q (b) PTQ {algo} ResNet-50 B{V_B} {V_IMG}² f32 (TF32 "
            f"off): fuse_conv_bn 4 pairs on both; 54 layers' frozen weight "
            f"codes and per-channel scales bitwise card vs CPU; activation "
            f"scales {r['a_rel']:.3g} apart (limit {Q_SCALE_REL}); "
            f"activation codes that differ {r['share']:.3g} of {r['n']}; "
            f"int8 logits {r['l_rel']:.3g} of the CPU's largest (limit "
            f"{Q_LOGIT_REL}); top-1 equal {r['top1']} ({r['ties']} near "
            f"ties)")
    t2 = time.perf_counter()
    for tag, r in q_qat_parity(torch, ptt).items():
        (lg, lc) = r["losses"]
        gate = (f"limits 1e-4 / {Q_QAT_SCALE_REL} / 1e-4 / "
                f"{2 * V_LR * 2 + 1e-6:.3g} / 1e-3" if tag == "f64" else
                "not gated in float32: code flips cascade, ROADMAP §C 50")
        say(f"phase 4q (c) QAT ResNet-50 {tag} B{V_B} {V_IMG}², channel-wise "
            f"weights, moving_average_abs_max, 2 AdamW steps card vs CPU "
            f"({gate}): losses {' '.join(f'{v:.6f}' for v in lg)} vs "
            f"{' '.join(f'{v:.6f}' for v in lc)} (rel {r['rel']:.3g}); "
            f"{r['n']} act_scale buffers {r['a_rel']:.3g} apart; BatchNorm "
            f"buffer {r['buf'][1]} {r['buf'][0]:.3g}; parameter "
            f"{r['par'][1]} {r['par'][0]:.3g}; first step's worst gradient "
            f"{r['grad'][1]} {r['grad'][0]:.3g} of its leaf")
    t3 = time.perf_counter()
    err = q_viterbi_parity(torch, ptt)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    say(f"phase 4q (d) text.viterbi_decode [8, 64, 32] card vs CPU: paths "
        f"equal, scores {err:.3g} (limit 1e-5); kernel launches in 4q "
        f"{counts or 'none'} (this path reaches no TPU kernel); (a) "
        f"{t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) {t3 - t2:.1f} s, (d) "
        f"{time.perf_counter() - t3:.1f} s [{card}]")


def _q_timed(torch, fn, warm=2, steps=5):
    """`fn` timed on the card: ms a call (CUDA events over `steps` calls
    after `warm`), host ms a call, peak memory over the timed calls, the
    idle share of one profiled call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated()
    busy = profiled_busy(torch, fn)
    return dict(ms=start.elapsed_time(end) / steps, wall_ms=wall * 1e3,
                peak=peak, idle=1 - busy / wall, busy_ms=busy * 1e3)


def q_inference_timed(torch, ptt, card):
    """6q (a), (b): ResNet-50 at 224², `fuse_conv_bn` then PTQ (hist,
    channel-wise) calibrated on 2 batches of 8 from q_reader(16, 0); at
    B 64 and 256, random images from RandomState(0), eval under no_grad:
    the int8 forward beside the float32 forward (TF32 off) and the
    `amp.auto_cast()` bf16 forward of the same model; then at B 64
    `utils.profiler.top_ops` of the int8 forward and the share of its
    CUDA-event time in im2col against `_int_mm`."""
    import copy

    from paddle_tpu_torch import slim

    ptt.seed(V_SEED)
    model = _v_resnet50(ptt, "NCHW")
    model.eval()
    int8 = copy.deepcopy(model)
    pairs = slim.fuse_conv_bn(int8)
    calib = [(_q_stack(b)[0],) for b in ptt.batch(q_reader(16, 0), 8)()]
    slim.PostTrainingQuantization(
        model=int8, algo="hist",
        weight_quantize_type="channel_wise_abs_max").quantize(
        data_loader=calib, batch_nums=2)
    rs = np.random.RandomState(0)
    rows = {}
    for b in Q_BATCHES:
        images = torch.from_numpy(rs.rand(b, 3, V_IMG, V_IMG).astype(
            np.float32)).to(DEV)

        def bf16():
            with ptt.amp.auto_cast():
                return model(images)

        with torch.no_grad():
            for tag, fn in (("int8", lambda: int8(images)),
                            ("float32", lambda: model(images)),
                            ("bf16", bf16)):
                rows[(b, tag)] = _q_timed(torch, fn)
            out8, out32 = int8(images), model(images)
        agree = (out8.argmax(1) == out32.argmax(1)).float().mean().item()
        rel = ((out8 - out32).abs().max() / out32.abs().max()).item()
        if not torch.isfinite(out8).all():
            fail(f"phase 6q (a) B{b}: non-finite int8 logits")
        rows[(b, "agree")] = (agree, rel)
        del images, out8, out32
        torch.cuda.empty_cache()
    images = torch.from_numpy(rs.rand(Q_BATCHES[0], 3, V_IMG, V_IMG).astype(
        np.float32)).to(DEV)
    with torch.no_grad():
        top = ptt.utils.profiler.top_ops(lambda: int8(images), steps=3, k=5)
        events = {"im2col": [], "int_mm": []}
        real = (slim.im2col, slim.int8_matmul)

        def timed(name, f):
            def g(*a, **kw):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = f(*a, **kw)
                e.record()
                events[name].append((s, e))
                return out
            return g

        slim.im2col = timed("im2col", real[0])
        slim.int8_matmul = timed("int_mm", real[1])
        try:
            int8(images)
        finally:
            slim.im2col, slim.int8_matmul = real
        torch.cuda.synchronize()
    split = {k: (sum(s.elapsed_time(e) for s, e in v), len(v))
             for k, v in events.items()}
    del model, int8, images
    torch.cuda.empty_cache()
    return pairs, rows, top, split


def q_qat_timed(torch, ptt):
    """6q (c): QAT of ResNet-50 (channel-wise weights,
    moving_average_abs_max) at B Q_QAT_B, 224², float32 (TF32 off), AdamW
    (lr 1e-4, wd 0.01), batches through `paddle.batch(paddle.reader.
    buffered(paddle.reader.shuffle(q_reader(.., pool 64), 64), 4), 64)`
    (every batch the pool's 64 seeded images, reshuffled), beside the
    plain float32 step of the same model on the same batches: ms a step,
    the reader's wait a step (host ms to the next batch on the card), the
    idle share of one profiled step, peak memory, the losses."""
    import copy
    import random

    from paddle_tpu_torch import slim

    ptt.seed(V_SEED)
    plain = _v_resnet50(ptt, "NCHW")
    qat = copy.deepcopy(plain)
    slim.ImperativeQuantAware(
        weight_quantize_type="channel_wise_abs_max",
        activation_quantize_type="moving_average_abs_max").quantize(qat)
    out = {}
    for tag, model in (("qat", qat), ("float32", plain)):
        model.train()
        opt = ptt.optimizer.AdamW(V_LR, parameters=model.parameters(),
                                  weight_decay=0.01)
        random.seed(0)
        n = Q_QAT_B * (sum(Q_STEPS) + 1)
        it = ptt.batch(ptt.reader.buffered(ptt.reader.shuffle(
            q_reader(n, 0, pool=Q_QAT_B), Q_QAT_B), 4), Q_QAT_B)()
        waits, losses = [], []

        def step():
            t0 = time.perf_counter()
            xs, ys = _q_stack(next(it))
            x, y = torch.from_numpy(xs).to(DEV), torch.from_numpy(ys).to(DEV)
            waits.append(time.perf_counter() - t0)
            loss = ptt.nn.functional.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.detach())
            return loss

        r = _q_timed(torch, step, *Q_STEPS)
        r["wait_ms"] = 1e3 * sum(waits[Q_STEPS[0]:sum(Q_STEPS)]) / Q_STEPS[1]
        r["losses"] = [v.item() for v in losses]
        if not all(np.isfinite(r["losses"])):
            fail(f"phase 6q (c) {tag}: non-finite loss {r['losses']}")
        if tag == "qat" and not r["losses"][-1] < r["losses"][0]:
            fail(f"phase 6q (c) QAT: the loss did not fall {r['losses']}")
        out[tag] = r
        del opt
        torch.cuda.empty_cache()
    act = [float(q.act_scale) for q in qat.sublayers()
           if isinstance(q, slim.QuantedConv2D)]
    del plain, qat
    torch.cuda.empty_cache()
    return out, act


def quant_throughput_phase(torch, card):
    """Phase 6q: (a) int8 inference, (b) its profile, (c) QAT steps."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    pairs, rows, top, split = q_inference_timed(torch, ptt, card)
    for b in Q_BATCHES:
        i8, f32, b16 = (rows[(b, t)] for t in ("int8", "float32", "bf16"))
        agree, rel = rows[(b, "agree")]
        say(f"phase 6q (a) ResNet-50 B{b} {V_IMG}² inference, fuse_conv_bn "
            f"({pairs} pairs) + PTQ hist channel-wise int8 (_int_mm, int32 "
            f"accumulators): ms_per_batch {i8['ms']:.2f} (host "
            f"{i8['wall_ms']:.2f}) samples_per_sec {b / i8['ms'] * 1e3:.1f} "
            f"idle {i8['idle']:.3f} max_memory_allocated "
            f"{i8['peak'] / 2**20:.0f} MiB; float32 (TF32 off) "
            f"{f32['ms']:.2f} ms ({b / f32['ms'] * 1e3:.1f}/s, idle "
            f"{f32['idle']:.3f}, {f32['peak'] / 2**20:.0f} MiB); "
            f"amp.auto_cast() bf16 {b16['ms']:.2f} ms "
            f"({b / b16['ms'] * 1e3:.1f}/s, idle {b16['idle']:.3f}, "
            f"{b16['peak'] / 2**20:.0f} MiB); int8 vs float32 top-1 "
            f"agreement {agree:.3f}, logits {rel:.3g} of the largest [{card}]")
    mm, n_mm = split["int_mm"]
    i2c, n_i2c = split["im2col"]
    say(f"phase 6q (b) utils.profiler.top_ops of the int8 forward, B"
        f"{Q_BATCHES[0]}, 3 calls (device kernels, ms over the 3 calls, "
        f"count): " + "; ".join(f"{n[:90]} {ms:.3f} ms x{c}"
                                for n, ms, c in top)
        + f"; CUDA events around each call of one forward: im2col {i2c:.3f}"
        f" ms ({n_i2c} calls), int8_matmul (_int_mm with its padding) "
        f"{mm:.3f} ms ({n_mm} calls): im2col's share "
        f"{i2c / max(i2c + mm, 1e-9):.3f} [{card}]")
    t1 = time.perf_counter()
    out, act = q_qat_timed(torch, ptt)
    q, p = out["qat"], out["float32"]
    say(f"phase 6q (c) QAT ResNet-50 B{Q_QAT_B} {V_IMG}² float32 (TF32 off), "
        f"channel-wise weights, moving_average_abs_max, AdamW, batches "
        f"through paddle.batch(reader.buffered(reader.shuffle(...), 4)): "
        f"ms_per_step {q['ms']:.2f} (host {q['wall_ms']:.2f}) vs the plain "
        f"float32 step {p['ms']:.2f} (host {p['wall_ms']:.2f}): "
        f"{q['ms'] / p['ms']:.2f}x; samples_per_sec "
        f"{Q_QAT_B / q['ms'] * 1e3:.1f} vs {Q_QAT_B / p['ms'] * 1e3:.1f}; "
        f"reader wait {q['wait_ms']:.2f} / {p['wait_ms']:.2f} ms a step; idle "
        f"{q['idle']:.3f} / {p['idle']:.3f}; max_memory_allocated "
        f"{q['peak'] / 2**20:.0f} / {p['peak'] / 2**20:.0f} MiB; QAT losses "
        f"{' '.join(f'{v:.4f}' for v in q['losses'])} (plain "
        f"{' '.join(f'{v:.4f}' for v in p['losses'])}); act_scale range "
        f"{min(act):.3g}-{max(act):.3g} over {len(act)} convs")
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    say(f"phase 6q: kernel launches {counts or 'none'} (no TPU kernel on this "
        f"path); (a)+(b) {t1 - t0:.1f} s, (c) {time.perf_counter() - t1:.1f} "
        f"s [{card}]")


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

    # phase 4a: the Paddle 2.0 eager API — a user's model and training
    # loop, card vs CPU
    api_parity_phase(torch, card)
    torch.cuda.empty_cache()

    # phase 4j: the Paddle 2.0 API, part 2 — paddle.Model over DataLoader
    # worker processes, save / load, beam search; card vs CPU
    model_fit_phase(torch, card)
    torch.cuda.empty_cache()

    # phase 4v: paddle.vision and the fluid-era ops — ResNet-50's step, the
    # ops and the detection chain, Model.fit over a vision dataset; card
    # vs CPU
    vision_parity_phase(torch, card)
    torch.cuda.empty_cache()

    # phase 4q: paddle.slim — quantization card vs CPU (codes, PTQ with
    # fuse_conv_bn over a 1.x reader, QAT steps) and text.viterbi_decode
    quant_parity_phase(torch, card)
    torch.cuda.empty_cache()

    # phase 4e: long-context training parity past the switch, card vs CPU.
    # Head dim 128 puts S 7168 past the two-pass switch (S * D * 10 > 8 Mi):
    # the CPU's dense attention costs a third of S 13312's at head dim 64
    S = 7168
    cfg_long = GPT2Config(vocab_size=1024, hidden_size=128, num_layers=2,
                          num_heads=1, max_position=S, dropout=0.0)
    for lengths, expect in ((None, TWO_PASS), ([4800], TWO_PASS_BIAS)):
        t0 = time.perf_counter()
        worst = train_parity(torch, cfg_long, b=1, s=S, lengths=lengths,
                             expect=expect, never=FUSED_BWD, phase="4e")
        say(f"phase 4e long-context train parity f32 B1 S{S} "
            f"{'padded to 4800' if lengths else 'unpadded'}, H1 D128, 2 "
            f"layers, 2 "
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
    t_k = time.perf_counter() - t0
    model32 = GPT2(cfg, seed=0, dtype=torch.float32, device=DEV)
    cases = graph_program_parity(torch, model32)
    t_graph = time.perf_counter() - t0 - t_k
    say(f"phase 5v (a) graph vs eager, f32 GPT-2 small, 8 slots, K {V_K}: "
        f"packed_verify and the window round (carry chained) x dense/int8 x "
        f"greedy/sampled+penalties ({cases} cases): outputs, counts, carries "
        f"and pools bitwise over a capture and a replay; a replay's launches "
        f"equal the eager dispatch's (K1 once a layer); no host sync in a "
        f"replay")
    for name, (st, counts) in spec_parity(torch, model32, card).items():
        sp, rd = st["speculation"], st["rounds"]
        say(f"phase 5v (a) f32 {name}: 8 requests x {V_NEW} tokens (greedy, "
            f"sampled, penalties) card == speculation off on the card == "
            f"CPU; "
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
    t_a = time.perf_counter() - t0 - t_k - t_graph
    launches, verify_launches, _cost = spec_serving(torch, model, card)
    for n, v in launches.items():
        main_counts[n] += v
    t_all = time.perf_counter() - t0
    say(f"phase 5v: {t_all:.1f} s ((k) {t_k:.1f} s, (a) graph vs eager "
        f"{t_graph:.1f} s, (a) servers (card; CPU off) {t_a:.1f} s, (b) "
        f"{t_all - t_k - t_graph - t_a:.1f} s)")

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

    # phase 5m: the serving fleet (its in-process replicas' and the
    # workers' K1/K2 launches join the kernels line)
    for n, v in serving_fleet_phase(torch, model, prompts, card,
                                    greedy_k1["tokens_per_sec"]).items():
        main_counts[n] = main_counts.get(n, 0) + v

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

    # phase 6a: the user loop at BERT-base width under amp.auto_cast():
    # (a) the reference's O1 lists (attention in float32), (b) the
    # attention's op name added to custom_white_list (bf16 attention);
    # their K4 bias / K6 / K9 bias launches join the kernels line
    steps = 5
    for tag, white in (("(a) O1", None),
                       ("(b) O1 + custom_white_list="
                        "['scaled_dot_product_attention']",
                        ["scaled_dot_product_attention"])):
        t0 = time.perf_counter()
        tr = api_train_throughput(torch, steps=steps, white=white)
        losses = tr["losses"]
        if not all(np.isfinite(losses)):
            fail(f"phase 6a {tag}: non-finite loss {losses}")
        if not losses[-1] < losses[2]:  # the measured steps, past the spike
            fail(f"phase 6a {tag}: loss did not fall over the measured "
                 f"steps ({losses[2]} -> {losses[-1]})")
        for n in FLASH_BIAS:
            if tr["counts"][n] != 12 * steps:
                fail(f"phase 6a {tag}: {n} launched {tr['counts'][n]} "
                     f"times in {steps} steps, expected {12 * steps}")
        if tr["counts"]["flash_fwd"] or tr["counts"]["flash_bwd"] \
                or tr["dense"]:
            fail(f"phase 6a {tag}: unbiased kernels or the dense path ran "
                 f"({tr['counts']}, dense {tr['dense']})")
        for n in FLASH_BIAS:
            main_counts[n] = main_counts.get(n, 0) + tr["counts"][n]
        say(f"phase 6a {tag}: user TextClassifier at BERT-base width (12 "
            f"layers) B16 S512 (padded; {tr['real_tokens']} real tokens a "
            f"step), amp.auto_cast() bf16 + GradScaler + AdamW on f32 "
            f"parameters, dropout 0.1: tokens_per_sec "
            f"{tr['tokens_per_sec']:.1f} ms_per_step "
            f"{tr['ms_per_step']:.2f} (host {tr['wall_ms']:.2f}) "
            f"max_memory_allocated {tr['peak'] / 2**20:.0f} MiB losses "
            f"{' '.join(f'{x:.4f}' for x in losses)}; launches "
            f"{ {n: tr['counts'][n] for n in FLASH_BIAS} }, unbiased and "
            f"dense path none; device busy {tr['busy_ms']:.2f} ms a step "
            f"(profiler), idle share {tr['idle']:.3f}; "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
    del tr
    torch.cuda.empty_cache()

    # phases 4i and 6i: the static graph, jit.save and the inference
    # Predictor; their K4 bias / K4 / K6 / K9 bias launches join the kernels
    # line
    for n, v in deploy_phase(torch, card).items():
        main_counts[n] = main_counts.get(n, 0) + v
    torch.cuda.empty_cache()

    # phase 6j: a user's paddle.Model.fit at BERT-base width over
    # DataLoader worker processes, then evaluate and predict; their K4 bias
    # / K6 / K9 bias launches join the kernels line
    t0 = time.perf_counter()
    tr = model_fit_throughput(torch)
    steps = len(tr["step_ms"])
    layers = 12
    if steps != 8 or not all(np.isfinite(tr["losses"])):
        fail(f"phase 6j: {steps} steps (expected 8), losses {tr['losses']}")
    if not 0 < tr["fit_busy_s"] < tr["fit_s"] * 1.5:
        fail(f"phase 6j: the profiled fit recorded {tr['fit_busy_s']} s of "
             f"device time against a {tr['fit_s']} s fit")
    for n in FLASH_BIAS:
        if tr["fit_counts"][n] != layers * steps:
            fail(f"phase 6j: fit launched {n} {tr['fit_counts'][n]} times "
                 f"in {steps} steps, expected {layers * steps}")
    for what in ("eval_counts", "pred_counts"):
        c = tr[what]
        if c["flash_fwd_bias"] != layers * 2 or c["flash_delta"] or \
                c["flash_bwd_bias"]:
            fail(f"phase 6j: {what[:-7]} (2 batches) launched {c}, "
                 f"expected K4 bias {layers * 2} and no backward")
    for c in (tr["fit_counts"], tr["eval_counts"], tr["pred_counts"]):
        if c["flash_fwd"] or c["flash_bwd"]:
            fail(f"phase 6j: unbiased kernels ran {c}")
        for n in FLASH_BIAS:
            main_counts[n] = main_counts.get(n, 0) + c[n]
    if tr["dense"]:
        fail(f"phase 6j: the dense attention path ran {tr['dense']} times")
    if tr["pred_shape"] != (J_EVAL, 2) or not tr["pred_finite"] or \
            not np.isfinite(tr["eval"]["loss"][0]):
        fail(f"phase 6j: evaluate {tr['eval']}, predict {tr['pred_shape']}")
    say(f"phase 6j paddle.Model(api_classifier at BERT-base width, 12 "
        f"layers).fit f32 (Model has no amp), dropout 0.1, AdamW, "
        f"batch_size 16 x {J_SEQ} padded ({J_TRAIN} samples, lengths "
        f"64-{J_SEQ}, {tr['real_tokens']} real tokens an epoch), 2 epochs, "
        f"shuffle, num_workers=2, drop_last: ms_per_step {tr['ms']:.2f} "
        f"(median of steps 3-8, host clock; all "
        f"{' '.join(f'{x:.1f}' for x in tr['step_ms'])}) tokens_per_sec "
        f"{tr['tokens_per_sec']:.1f} (padded) max_memory_allocated "
        f"{tr['peak'] / 2**20:.0f} MiB; DataLoader wait between steps "
        f"median {statistics.median(tr['waits']):.2f} ms (max "
        f"{max(tr['waits']):.2f}; before the first step "
        f"{tr['first_wait']:.1f} ms, at epoch 2's start "
        f"{tr['waits'][3]:.1f} ms); device busy {tr['busy_ms']:.2f} ms a "
        f"step (profiler), idle share within a step {tr['idle']:.3f}; fit "
        f"{tr['fit_s'] * 1e3:.1f} ms wall, device busy "
        f"{tr['fit_busy_s'] * 1e3:.1f} ms over it (a profiled second fit), "
        f"idle share over fit {tr['fit_idle']:.3f}; launches fit "
        f"{ {n: tr['fit_counts'][n] for n in FLASH_BIAS} } ({layers} each a "
        f"step), evaluate / predict K4 bias "
        f"{tr['eval_counts']['flash_fwd_bias']} / "
        f"{tr['pred_counts']['flash_fwd_bias']} ({layers} a batch), "
        f"unbiased and the dense path none; evaluate loss "
        f"{tr['eval']['loss'][0]:.4f} acc {tr['eval']['acc']:.3f}; phase "
        f"{time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    del tr
    torch.cuda.empty_cache()

    # phase 6v: bench.py's resnet50 axis on the card, B 128 and 256, NCHW
    # and NHWC
    vision_throughput_phase(torch, card)
    torch.cuda.empty_cache()

    # phase 6q: ResNet-50 int8 inference (PTQ) beside float32 and bf16, its
    # profile through utils.profiler, and QAT steps over a 1.x reader
    quant_throughput_phase(torch, card)
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
