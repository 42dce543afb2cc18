#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rlaifv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one progress line each (or a few):
  1. environment: Python/torch/CUDA/nvcc/triton versions, the card's name
     and power limit (nvidia-smi); TF32 off for matmuls and convolutions;
  2. build: nvcc builds the package's CUDA kernels from csrc/;
  3. each kernel against its plain PyTorch version on the same bf16 inputs
     at the serving slice's shapes: max abs error against a stated
     tolerance, and median times over 20 CUDA-event-timed runs, beside the
     bound (bytes and operations at the card's peaks) and the time of
     torch's scaled_dot_product_attention on the same inputs (the flash
     forward at the autocheck prefix and GQA B 2 L 1024); the kernels one
     flash call launches (a CUDA graph of the call: one); three broken
     copies of the flash forward (the diagonal tile unmasked, the rescale
     skipped, the last ragged key tile dropped), built while 3 and 3b run,
     each of which must break the comparison; the prefix decode kernel (#4)
     against its plain version and its split twin at the card's plan
     (prefix_plan): phase 4's shape at four valid_len, then the bf16
     batch-24 run, the bf16 Llama3-8B backend's GQA step (B 8, KVH 8,
     valid_len 2200) and phase 13's short prompts (valid_len 384) from a
     generator of their own, each with its key splits and the kernels one
     call launches (a CUDA graph of the call) against the plan, its time
     beside the plain version, SDPA and the bound; three broken copies of
     #4 (one split left out of the merge, a split not rescaled, the last
     partial key tile dropped), built with the flash copies, each of which
     must break the bound on the GQA step at valid_len 600;
  3b. the flash forward and backward kernels (dq, dk/dv) against the plain
     versions on the same bf16 inputs and dO at the train step's shapes:
     five fixed ones, the three calls phase 6's collated pair makes
     (plain, paired prefix, paired suffix at q_offset = Pa), with its
     masks, and the same three of phase 17's OmniLMM-12B pair at Mistral's
     GQA (KVH 8); max abs errors against stated tolerances, median times,
     TFLOP/s, the kernels one call of each launches (one), bounds, SDPA's
     forward and autograd backward (plain dpo B 2 L 2048, the two
     suffixes);
     three broken copies of the dk/dv kernel (the last query head of a kv
     head skipped, the causal mask off, the delta term dropped) and three of
     the dq kernel (the diagonal tile unmasked, the delta term dropped, the
     last ring stage of the key walk skipped) on the GQA case, each of which
     must break the comparison;
  3c. the fused LM head kernels (forward; the backward's dl, dx and dW,
     walked in vocabulary chunks) against the plain versions at the train
     step's head (M = 2 (L - 1), H = 4096, V = 32000), the ref-logp
     fallback's (M = 16 x 1023 - 5, forward), the QLoRA step's frozen head
     (M = 16 x 1023, dx only, four chunks), H = 1024, ragged vocabularies
     and eight chunks with a ragged last one; times of the forward, dl + dx,
     dW given dl and the whole backward call beside the bounds, the
     two-call library composite (F.linear + F.cross_entropy, its autograd
     backward) and a recompute composite (the backward's three products as
     torch calls), and the kernels one forward call launched (captured in a
     CUDA graph; 2 planned: the split tiles, the combine); then planted
     faults (g dropped, one-hot dropped, lse shifted, ragged tile unmasked,
     one chunk's dx dropped; and three broken copies of the forward kernel:
     the running sum not rescaled, the target dropped after a split's first
     tile, a ring stage reloading k-tile 0), each of which must break the
     bounds;
  4. the slice: LLaVA-1.5-7B at full width and depth in bf16 with random
     weights (seeded), a synthetic character-level tokenizer and
     examples/test.jpeg: autocheck of 8 facts (shared-prefix prefill ->
     flash kernel), diverse_gen of 10 samples (generate_repeated -> decode
     kernel) and greedy_gen of 4 items (generate -> decode kernel), with the
     kernels' launch counters reset just before and read just after;
  5. the slice against its plain path: shared-prefix logits with every
     attention forced dense, same weights;
  14. (run after 5, on phase 4's bf16 model) the eval slice:
     evals.vqa.generate_answers over 8 rows on examples/test.jpeg in one
     batch with 3 beams and 64 new tokens (the eval CLI's default is 1024;
     EVAL_NEW says why 64): #1 in the prefill (square over the prompt
     columns), #4 on every beam step (32 a step), the launch counters reset
     just before and read just after; tok/s, the beam step's median wall
     ms, the cache reorder's device ms a step (CUDA events around it
     alone) and rows copied, peak memory; the step's breakdown (the model
     step's device time, #4 at the beam shape B 24 timed beside its plain
     version, SDPA and its bound, the weights' byte bound, the reorder,
     the rest); generate_beam(num_beams=1) equal to greedy generate; the
     recorded parents and tokens of 4 steps replayed through beam_step with
     attention forced dense, each step's log-probs within phase 5's bound;
     evals.run_eval's Object HalBench (no GPT, a synthetic COCO directory),
     MMHal and RefoMB (a stub judge transport: the machine has no network)
     on the answers, each writing its files and printing its summary;
  19. (run after 14, beside phase 4's bf16 model, which it leaves
     unchanged) the serving options ported last. 19a: the seed-0 model
     in fp32, calibrated on the chat's RLAIFV_INT4_SMOOTH sentence and
     smoothed in place with the alpha search (models/quant_smooth.py,
     layer by layer on the card): its first logits on 8 prompts before
     and after the fold within FOLD_FP32_REL_TOL; the bf16 model rebuilt,
     smoothed and quantised to int4 in place (the alphas' histogram,
     seconds, peak GiB): the prefill and 4 forced steps on #11 equal, bit
     for bit, the same with every #11 product by its plain twin, #11
     against the plan; plain and smoothed int4 against float (logged).
     19b: greedy lookup_generate (32 tokens) on the bf16 model (4 prompts)
     and on 19a's (2), each prompt quoting the model's own greedy
     continuation: #1 a layer a prefill, no #4 in the window loop, #11 at
     9 rows a window (int4), more than one token a window, the tokens
     against generate under phase 15's tie rule, tok/s beside one
     prompt's generate; the token embeddings scaled by 2^16 meanwhile
     (exact, undone after: a random 7B's text otherwise follows no quote).
     19c: a LLaVA-1.6-vicuna-7b geometry (phase 4's
     modules under anyres grids, a seeded image_newline):
     examples/test.jpeg's 5 views merged on the card bit for bit as the
     numpy merge (T 2144), encode and prefill ms, the 3-beam chat of 64
     tokens, #1 and #4 against the plan. 19d: Llama3-8B through
     llama3_backend(int4, int4_smooth, fused_decode) on 8 divide prompts:
     #11 on the prefill, #16 once a step; its prefill and 4 forced steps
     against the unfused smoothed int4 engine's (phase 11's bound and
     cosine). Phase 3 holds #1 at 19c's prefill and #4 at its beam
     steps, 3e #11 at 19b's 9-row window, bit for bit;
  15. continuous batching (genai/continuous.py), in three parts. 15a (after
     3h): kernels #4, #5 and #16 against their split twins at the masks
     continuous batching gives them (utils/synth.py:continuous_mask:
     windows ending at the write column with different starts, finished
     rows, an empty slot, and the same rolled by a compaction) with phases
     3, 3f and 3g's bounds; 15b (after 14, on phase 4's bf16 model):
     diverse generation of 2 questions x 10 repeats through
     a ContinuousGenerator (share_keys from the repeat groups, 8 slots, chunk
     16, at most 64 new tokens under lognormal(4.45, 0.8) budgets,
     headroom 32: one compaction), then diverse_gen(continuous=True), the
     batch path and generate_many on the same items, then greedy
     continuous against generate on 8 prompts (first and decode logits
     within phase 5's bound, a row first differing only at a near-tie
     under a fixed bound); 15c (after 11 and after 12): the same greedy
     check on 12 prompts through 4 slots with a compaction on the int8-KV
     engine (#5 every step, #7, #9) and on the fused engine (#16 every
     step, compact_stacked, the slot scatter), the decode tokens whose keys
     sit at the same offset in the key blocks on both paths held to phase
     5's bound and the others to phase 11's int8-KV bound and cosine; each
     run logs its refill waves, prefills, scatter refills, compactions,
     launches against the plan, host syncs over the whole run with its
     refills (counted under torch.cuda.set_sync_debug_mode("warn"): one a
     chunk planned, none in a refill) and tok/s beside the card's name and
     power limit;
  11. (run after 14, on phase 4's model) the int8-KV serving path, the JAX
     package's headline serving configuration (scripts/bench_7b_serve.py):
     one generate of 24 prompts of 896 tokens and 64 new tokens on the bf16
     model, then the model quantised in place to int8 weights (head bf16),
     its q/k/v and gate/up projections fused and its cache switched to int8;
     phase 4's three workloads and the batch-24 generate again (kernel #5
     on every decode step, #7/#9 at the fused widths), their rates and peak
     memory beside the bf16 ones; one beam batch (4 rows, 3 beams, 16 new
     tokens; #5 on every beam step, no #4); then the prefill and 4 forced
     decode steps of greedy_gen's prompts on the kernel route against attn_impl
     "dense" (the dequantised formula) and against a bf16 cache;
  8. the reference-logp precompute: 16 synthetic RLAIF-V rows at the train
     geometry through score_preference_rows on the frozen starting policy
     (LLaVA-1.5-7B with remat, seed 0): the shared-prefix path (a spy
     counts the rows it scored), the plain scorer with the fused head and
     with the "xla" head; their agreement, pairs/s and peak memory;
  7. the train slice against its plain paths on the first row's pair and
     phase 8's reference logps, before any update: paired + flash vs plain
     concatenated + flash vs plain + dense attention, and the fused head vs
     the "xla" head; loss, logps and the gradients of named tensors;
  6. the train slice: the 7B full fine-tune with remat, the shared-prefix
     paired forward and lm_head_impl "auto" (the fused head at hidden
     4096), that pair collated as train.py collates it: 4 AdamW steps,
     loss near ln 2 at step 0 (bound stated), lower by step 3; step time,
     pairs/s, tokens/s with and without padding, peak memory and every
     kernel's launches per step; then 3 steps with the "xla" head on the
     same optimizer, for its step time and peak memory beside them;
  3d. (run after 3c) the int8 weight kernels (#7 in-kernel quantisation,
     #8 its dx, #9 and #10 the prequantised pair) against their plain twins
     at the 7B widths
     (K x N = 4096 x 4096, 4096 x 11008, 11008 x 4096) and M = 16, 64, 127
     (in-kernel route), 128 and the M values of phase 9's batches, and at
     phase 11's fused widths (4096 x 12288, 4096 x 22016) and its decode and
     prefill rows (M = 10, 24, 832, 3328, 21504): max abs
     difference 0, #7 == #9 and #8 == #10; also at Llama3-8B's widths
     (4096 x 6144, 4096 x 28672, 14336 x 4096) and phase 13's decode and
     prefill rows (M = 8, 64, 128, 8 x its divide prompt bucket), and at
     EVA02-enormous's quantised projections (1792 x 5376, 1792 x 15360,
     15360 x 1792; M = 1025 and 8200, phase 16's rows), then QuantDense
     with its bias at those shapes against the twin plus the bias, its
     whole call timed;
     times beside the bound (int8 at
     1,979 TOP/s or the bytes), torch._int_mm on the same int8 operands
     (product only; on the rows zero-padded to 32 where it refuses 16 or
     fewer) and the "dequant" route (a bf16 cuBLAS product of the
     dequantised weight), #7's cp.async kernel (its route before the split
     product) below 128 rows, #7 against #9 plus its torch row quantisation
     at M 64, 127 and 128, the kernels one #7, one #8 and one #10 call
     launched (each call captured in a CUDA graph; they must match
     fwd_plan's, dx_launches' and dx_prequant_plan's plans; #7's and #10's
     routes logged), one case with
     N % 16 != 0 (#10 on the rows TMA cannot map), and one projection's
     int8 route against the dequant route (the activation-quantisation
     error, ~1%); #9's route (fwd_prequant_plan: the wide tile, or the
     cp.async kernel where TMA cannot map the rows) and kernels a call
     (captured), its cp.async kernel (the parent's route) from 128 rows and
     the whole int8_matmul_prequant call (the row pass on the card and the
     product) beside it; then #8 on rows whose quotients fall on and next to
     half-integers (synth.quotient_ties; M = 1, 63, 64, 127, the short
     step's, ragged K and N), reruns bit-equal, and ten planted faults
     (#8: one contraction slice dropped, sy from the next row; #10 on its
     wide tile: the last contraction stage dropped, sy from the wrong row of
     a tile; #7's split product: one K slice dropped, sx from the next row,
     the column scale one column off; #9's wide tile: the last contraction
     stage dropped, sx from the next row, the column scale one column off),
     each a broken copy of csrc/quant_matmul.cu built beside the kernels,
     that must break the bit-exact check;
  9. the QLoRA slice (configs/llava15_dpo_qlora.json): phase 8's seed-0
     LLaVA-1.5-7B rebuilt after phase 6 is freed, its LLM projections
     quantised to int8 on the card (head, CLIP and projector bf16), the
     reference logps of phase 8's 16 rows and one short row scored on that
     base (shared-prefix path), step 0 of r=64 / alpha=16 adapters on all 7
     projections x 32 layers against the same step on the "dequant" route
     (and the SFT term's gradient on both routes),
     3 AdamW steps of 8 pairs collated as train.py collates them (loss near
     ln 2 at step 0, lower by step 2), then one step on the short pair whose
     suffix has fewer than INT8_DEQUANT_MIN_M rows (#7 and #8 on the train
     path); step time, pairs/s, tokens/s, peak memory and launches a step.

  3e. (run after 3d) the int4 weight kernels (#11 forward on rows quantised
     in torch, #12 its dx) against their plain twins at the same widths and
     M = 16, 64, 127, 128 and phase 10's prefix and suffix rows, and at
     3d's Llama3-8B and EVA02 widths and rows (QuantDense with its bias at
     the EVA02 shapes, as in 3d): max abs
     difference 0 (#12 also at N = 11008, which the dispatch sends to the
     dequant dx); times beside the int8 bound, torch._int_mm on the
     unpacked int8 operands (product only, both weight layouts) and the
     "dequant" route, the kernels one call of each launched (captured in a
     CUDA graph; 1 and 2 planned), and one projection's int4 route against
     it; #11 again at groups of 256 at every shape; then #12 on tie
     quotients (groups of 128 and 256), reruns bit-equal, and three planted
     faults in each (#12: the guard band removed, sy from group j + 1, one
     ring stage loading chunk 0 again; #11: gs from group g + 1, the
     accumulator not cleared, a nibble's sign dropped), each of which must
     break the check;
  3f. (run after 3e) kernel #5, prefix decode over an int8 cache, against
     its split twin (decode_attention_prefix_int8_split_ref at the key
     splits prefix_int8_plan gives on this card) at phase 11's shapes (B =
     10 and 4 at L = 896, block 128; B = 24 at L = 1024, block 256), the
     int8 Llama3 backend's GQA step (B 8, H 32, KVH 8, L 2304, valid_len
     2200: 4 splits) and the edges (one live column, mid-block, a block
     edge, L % 256 != 0, n_rep 4, D 64, fully masked rows), NaN scales past
     the last live block, reruns bit-equal, each case's splits and the
     kernels one call launched (a CUDA graph: the split kernel and, with
     splits, the merge); times beside the bound and SDPA over the cache
     dequantised to bf16; then planted faults (the v-scale fold dropped, p
     quantised with one global max, valid_len one block short, the mask
     ignored; and two broken copies of the merge on the GQA case: one
     split's state left out, the splits merged without rescaling to the
     common max), each of which must break the bound;
  3g. (run after 3f) kernel #16, fused decode through the layer stack,
     against its plain twin (fused_decode_step_ref, with the cache blocks
     cut into the kernel's key splits: fused_plan) at the 7B widths
     (Vicuna-7B, 32 layers, random int8/int4 stacked weights and cache):
     B = 8 and 10 at L = 896, batch 24 at L = 1024 and cache_index 960, a
     block edge with a fully masked row, mid-block, n_rep 4, int4; at one
     layer of each shape at most B/4 rows may hold a quantisation flip,
     through 32 layers x_out and the fresh k/v within gross bounds beside
     the twin's own one-ulp spread; times beside the bound and the twin's;
     planted faults (the fresh column dropped, the mask ignored, the
     activation quantised over the whole of I, rope skipped on k, one
     I-block of the down sum dropped), each of which must break the
     one-layer bound; Llama3-8B (I 14336: Ip 14336, bi 2048; KVH 8, B 8,
     L 2304), int8 and int4; each case's plan and the kernels one call
     launched (a CUDA graph of the call); three broken copies of the kernel
     on the n_rep 4 case (3 key splits: one split left out of the merge, a
     split merged without rescaling to the common max, a product ring stage
     consumed before its wait), built while 3-3b run, each of which must
     break the one-layer bound; the per-phase breakdown at batch 24 (a
     copy with barrier stamps, tools/fused_times.py) and the barrier-bound
     floor of a launch, beside the first design's;
  3h. (run after 3g) kernel #6, single-query attention over the whole
     cache (fp32 math), against its plain twin at run_tpu_checks' shapes (B
     4, L 896, H 8, KVH 8 and 4, fp32, rows masked from 700 and from 13),
     batch 24 at L 1024 and Llama3's GQA (B 8, L 2304, H 32, KVH 8) in bf16,
     and the edges (a fully masked row -> 0, L 781, D 64, n_rep 2 and 8,
     interior holes): fp32 within 1e-5 x max(1, max|twin|), bf16 within
     phase 3's bound, each case's key splits (full_plan) and the kernels
     one call launched (a CUDA graph of the call: the split kernel and,
     with splits, the merge); times beside the twin, SDPA on KV repeated to
     H and the bound; then planted faults (the mask ignored, the scale
     dropped, q head h reading kv head h % KVH, the last partial key tile
     dropped, the denominator clamp removed; and two broken copies of the
     kernel: one split left out of the merge, a split's state merged
     without rescaling to the common max), each of which must break the
     bound;
  12. (run after 11, on its model) the fused engine: the eager int8-KV
     path's forced logits and step time first, the LLM's weights stacked in
     place (memory before and after, flat within one layer's weights),
     phase 11's three workloads and the batch-24 headline with #16 on every
     decode step (launches = decode steps, #4/#5/#7 none), rates and peak
     memory beside phase 11's, then greedy_gen's prompts with 4 forced
     tokens: the fused prefill against phase 11's, each step's #16 against
     its twin on the same cache, and the path against phase 11's;
  13. (run after 12, on its fused generator) the RLAIF-V feedback pipeline:
     rlaifv_tpu_torch.pipeline.run_pipeline over 4 questions on
     examples/test.jpeg (4 answers each), phase 12's fused LLaVA generator
     as the generator and the labeler, Llama3-8B (full width and depth,
     bf16, random weights, seed 0; both heads shaped to the fake
     tokenizer's printable ids) as the divide and changeq backends at the
     reference's sampling (T 0.2, top-p 0.9, 256 new tokens): each stage
     file and its rows, facts > 0 and yes/no questions > 0, the pair count,
     the backend's tok/s, peak memory and #1 / #4 launches; then the same
     model quantised in place to int8 (head bf16, fused, int8 KV) on one
     divide batch (#9 prefill, #7 decode rows, #5 every step, no #4), its
     route against attn_impl "dense" on a prefill and 4 forced steps, then
     stacked for fused decode (memory before and after; #16 once a decode
     step, no #4 / #5 / #7) and each forced step's #16 against its twin; its work directory stays for 16e;
  16. (run after 13, with the 7B serving models freed) OmniLMM-12B, the
     reference loop's labeler, at full width and depth with random weights
     (seed 0; EVA02-enormous with 63 of its 64 blocks, the resampler's 64
     queries, Mistral-7B's 32 layers; the head shaped to the fake
     tokenizer's printable ids), 448 px images (the position tables
     re-gridded bicubically): 16a bf16: the encode's ms an image, autocheck
     of 2 images x 8 facts through the shared prefix and plain (yes/no
     logits within phase 5's bound), diverse_gen 2 x 5 repeats
     (generate_repeated) and 3-beam chat decoding (chat_12b sampling), 64
     new tokens, #1 and #4 counted against the path's plan (each LLM pass's
     attention route), the prefill and 4 forced steps against attn_impl
     "dense"; 16e: pipeline.stage_autocheck on phase 13's yes/no questions
     with that model, then stage_pairs and stage_length_balance; 16b: the
     model quantised in place (both towers int8, head bf16, int8 KV cache):
     autocheck at batch 8 (the JAX package's 12B headline geometry), one
     generate, #9, #7, #5 and #1 against the plan, the prefill and 4 forced
     steps against the dense route on a bf16 cache (phase 11's bounds);
     16c: that model fused and served through the fused engine: #16 once a
     step, no #4, #5 or #7, each forced step's #16 against its twin; 16d:
     the seed-0 model rebuilt and quantised to int4 on both towers, one
     autocheck batch, #11 against the plan; facts/s, tok/s, peak GiB;
  17. (run after 16, its models freed) OmniLMM-12B QLoRA training at full
     width and depth on configs/omnilmm_dpo_qlora.json (17a) and
     omnilmm_dpo_qlora_int4.json (17b), each loaded unchanged: the model
     built by the train entry point's build_omnilmm (seed-0 random weights,
     63 EVA02 blocks, the head shaped as 16's) and quantised by its
     quantize_base (17a: the LLM's 7 x 32 projections int8, the tower
     bf16; 17b: both towers int4); phase 8's 16 rows and 9's short row in
     the omni convention at 448 px; the reference logps on that base
     through the shared prefix against the plain scorer; step 0 equal bit
     for bit to the twin route (every int8 / int4 product by its plain
     twin), and two planted faults (a doubled dx, a dropped contraction
     slice) caught by that comparison; step 0 against the "dequant" route
     (DPO and SFT adapter gradients, bounds set from readings), near ln 2;
     3 AdamW steps of the config's 4 pairs (the loss
     lower by step 2); one short step (#7/#8 on 17a); every counted run's
     #1-#3 and #7-#15 launches against the plan `TrainPlan` derives from
     its calls (each attention call's route, each quantised projection's
     rows, each head call's vocabulary chunks; backwards where a gradient
     arrives); s a step, pairs/s, tokens/s, peak GiB, launches a step;
  18. (run after 17, its models freed) MiniCPM-Llama3-V 2.5, the
     reference's third VLM family, at full width and depth with random
     weights (seed 0; SigLIP-so400m's 27 blocks at head dim 72, its
     attention plain torch; the resampler's 96 queries; Llama3-8B's 32
     layers, n_rep 4; the head shaped as 13's), images cut by the real
     slicer (examples/test.jpeg: a source and a 2 x 1 grid, three 96-token
     spans a row): 18a bf16: the encode's ms a slice and an item, autocheck
     of 2 images x 8 facts through the shared prefix and plain (yes/no
     logits within phase 5's bound), diverse_gen 2 x 5 repeats
     (generate_repeated), one chat, a 3-beam generate_beam with spans, 64
     new tokens, #1 and #4 counted against the plan, the prefill and 4
     forced steps against attn_impl "dense"; 18e (on 18a's model)
     generate_continuous with spans on 12 prompts through 4 slots against
     generate, the first wave bit-equal to generate of its prompts alone,
     launches and host syncs against the plan; 18b: the model quantised in
     place (int8 LLM, head and SigLIP bf16, int8 KV) at
     scripts/bench_minicpmv_serve.py's geometry (8 items of 5 slices of 448
     px, 576-token prompts): encode, prefill and decode-step ms, autocheck
     facts/s at batch 8, #9, #7, #5 and #1 against the plan, the prefill and
     4 forced steps against the dense route on a bf16 cache (phase 11's
     bounds); 18c: that model fused and served through the fused engine:
     #16 once a step, no #4, #5 or #7, greedy tokens and logits against
     18b's eager engine, each forced step's #16 against its twin; 18d: the
     seed-0 model rebuilt with an int4 LLM, one autocheck batch, #11
     against the plan; 3 holds #1 at 18b's prefill, 3d / 3e #7, #9 and #11
     bit for bit at 18b's rows;
  10. the int4 QLoRA slice (llava15_dpo_qlora.json with quantize_bits 4,
     built in memory): phase 8's seed-0 model rebuilt after phase 9 is
     freed, its LLM projections quantised to nibble-packed int4 with
     group-128 scales on the card, the reference logps of the 16 rows on
     that base, step 0 against the "dequant" route (DPO and SFT
     gradients), 3 AdamW steps of 8 pairs (loss near ln 2 at step 0, lower
     by step 2); step time, pairs/s, tokens/s, peak memory, and the
     launches a step of #11, #12 and the dequant dx (gate/up);
  20. the modules ported last, in four parts. 20a-c run after 19, on
     phase 4's bf16 model, which they leave unchanged. 20a: the native
     JPEG loader (data/native_loader.py) built by g++ from the repo's
     copy of the C++ source into build/, on examples/test.jpeg and a
     resized and a mirrored copy (re-encoded) as a batch of 64: byte-equal
     to the PIL path, ms/image, the PIL fallbacks (0 on JPEG input); a
     machine without libjpeg prints that on a line of its own and every
     image takes the PIL path. 20b: the device image pipeline
     (ops/image_kernels.py) at bench.py's geometry (64 seeded 640 px
     images to 336) and on 20a's images, within 2 uint8 steps of the host
     ClipImageProcessor; the device program's ms/image (the BASELINE
     preprocess metric) and the whole call's; the CLIP tower and
     projector on device and on host pixels. 20c: export
     (models/export.py) of phase 4's model to an HF dir at fp16, reloaded
     by load_pretrained_llava into a fresh model: every tensor the
     original rounded bf16 -> fp16 -> bf16, bit for bit; 4 prompts x 16
     greedy tokens equal to the original's with its weights rounded the
     same way (restored after); then r 64 LoRA adapters on q_proj and
     v_proj (b drawn from the seed) over phase 4's model cut to 4 LLM
     layers (full width, its own export as the base: the loader's fp32
     conversion of a 32-layer base takes ~100 s) through export_peft_lora
     and load_pretrained_llava(adapter, base): its merged weights (within
     one bf16 ulp) and first logits (phase 5's bound) against the cut
     model with the same fp16 adapters merged in fp32 on the card, the
     drift against the adapters attached logged; GB written, export and
     reload seconds. 20d (after 10, every model freed): the reference-logp
     precompute over two processes on the one card (subprocesses with
     torchrun's variables, a gloo group, each building phase 8's seed-0
     7B): inference_logp on phase 8's rows, the shared-prefix path and the
     plain scorer with the fused head, rank 0 writing the parquet; row for
     row against phase 8's single-process results within its bounds and
     bit for bit (each shard's batches hold the same pairs as phase 8's);
     the three processes' peak device memory, wall seconds and pairs/s.
  21. (after 20d, every model freed) the mesh slice (parallel/sharding.py):
     21a: phase 8's seed-0 7B rebuilt, wrapped through create_mesh(1,
     None, 1) on a one-process group with NCCL axis groups and
     shard_params (FSDP2 units a block, the root for the rest), then
     phase 6's four steps on phase 6's pair through the sharded step:
     every step's loss, logps and grad norm and the fingerprint of every
     parameter after the last (an exact integer checksum of its bits) equal
     phase 6's bit for bit, the launches of #1-#3 and the head kernels
     equal phase 6's; s a step and peak GiB beside phase 6's. 21b:
     DPOTrainer with that mesh passed in, in configs/llava15_dpo_lora.json's
     mode (bf16 base sharded, r 64 adapters whole), two steps on phase 8's
     rows and their reference logps, a checkpoint; its state.pt reloaded:
     the adapters equal the trained ones bit for bit. 21c: world 2 on the
     one card (two subprocesses, as 20d's, the mesh's groups gloo over CUDA
     tensors: NCCL refuses two ranks on one device): the seed-0 7B at full
     width cut to 8 layers, sharded at (1, 2, 1), a global batch of the
     first two rows' pairs (one a rank), one step; against a one-process
     reference in this process (the same cut model unsharded, each pair a
     micro-batch at the shape its rank runs, the gradients summed): both
     ranks' loss and logps (the global means) within the CPU tests' metric
     tolerance (atol 1e-5 + rtol 1e-6), their grad norm (after the gloo
     reduce-scatter) within 1e-3 relative; the two pairs' logps must
     differ by far more than that tolerance.
     Phase 3b holds #1-#3 at the train suffix with 16 and 8 local heads
     (tp 2 and 4) too.

Each path of the main run (4, 14's beam batch, 15's runs, 11's two
headline runs, its slice and its beam batch, 12's
slice and headline, 13's pipeline and its int8 and fused batches, 16a-e's
runs, 17a-b's precomputes, steps and short steps, 18a-e's runs, 19a-d's
runs, 20c's reloaded model, 20d's workers, 21a-c's runs, 8, 6,
9's precompute, steps and short step, and 10's precompute and steps)
starts with every launch counter at 0 and is read just after; the
`kernels` line reports those launches beside each kernel's error, times,
bound and library time; kernel #6 is on no path (no module of either
package calls it), so its launches there are 0. Each phase prints its wall
seconds. Any failure raises (non-zero exit). The last two lines are a JSON object of
per-kernel results and `{"ok": true, "device": {...}}`. Without a CUDA
device it exits non-zero before measuring anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from rlaifv_tpu_torch.constants import IGNORE_INDEX  # noqa: E402
from rlaifv_tpu_torch.core.config import Config  # noqa: E402
from rlaifv_tpu_torch.data import ClipImageProcessor, DPOCollator  # noqa: E402
from rlaifv_tpu_torch import pipeline as pipe  # noqa: E402
from rlaifv_tpu_torch.evals import gpt_client  # noqa: E402
from rlaifv_tpu_torch.evals import run_eval  # noqa: E402
from rlaifv_tpu_torch.evals.vqa import generate_answers  # noqa: E402
from rlaifv_tpu_torch.chat import CALIBRATION_TEXT as CHAT_CALIBRATION_TEXT  # noqa: E402
from rlaifv_tpu_torch.chat import RLAIFV7B  # noqa: E402
from rlaifv_tpu_torch.data.image_processing import process_anyres_image_full  # noqa: E402
from rlaifv_tpu_torch.genai import beam as beam_mod  # noqa: E402
from rlaifv_tpu_torch.genai.lookup_decode import lookup_generate  # noqa: E402
from rlaifv_tpu_torch.models.anyres import (  # noqa: E402
    encode_anyres,
    merge_anyres_device,
    merge_anyres_features,
)
from rlaifv_tpu_torch.models.quant_smooth import (  # noqa: E402
    collect_llm_act_stats,
    quantize_llm_int4_smooth,
    smooth_llm_for_int4,
)
from rlaifv_tpu_torch.genai import divide_conquer as dcq  # noqa: E402
from rlaifv_tpu_torch.genai.continuous import ContinuousGenerator  # noqa: E402
from rlaifv_tpu_torch.genai.engine import (DecodeEngine, GenerateResult, group_consecutive,  # noqa: E402
                                          left_pad_batch)
from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator, yesno_token_ids  # noqa: E402
from rlaifv_tpu_torch.genai.minicpmv_gen import MiniCPMVGenerator  # noqa: E402
from rlaifv_tpu_torch.genai.omni_gen import OmniLMMGenerator, omni_yesno_ids  # noqa: E402
from rlaifv_tpu_torch.genai.sampling import SamplingParams  # noqa: E402
from rlaifv_tpu_torch.models import llama as llama_mod  # noqa: E402
from rlaifv_tpu_torch.models.llama import (  # noqa: E402
    LlamaAttention,
    LlamaConfig,
    LlamaForCausalLM,
    QuantDense,
)
from rlaifv_tpu_torch.models.minicpmv import (  # noqa: E402
    MiniCPMVConfig,
    MiniCPMVForCausalLM,
    init_minicpmv_weights_,
)
from rlaifv_tpu_torch.models.omnilmm import (  # noqa: E402
    OmniLMMConfig,
    OmniLMMForCausalLM,
    init_omnilmm_weights_,
)
from rlaifv_tpu_torch.models.llava import (  # noqa: E402
    LlavaConfig,
    LlavaForCausalLM,
    init_weights_,
)
from rlaifv_tpu_torch.models.convert import (  # noqa: E402
    fuse_llm_projections_,
    quantize_int4_torch,
    quantize_kernel_int8_torch,
    quantize_llm_int4,
    quantize_llm_int8,
    quantize_vision_int4,
    quantize_vision_int8,
    set_llm_config,
)
from rlaifv_tpu_torch.ops import _build  # noqa: E402
from rlaifv_tpu_torch.ops.attention import (  # noqa: E402
    attention_route,
    dense_attention,
    kernel_domain,
)
from rlaifv_tpu_torch.ops import fused_decode as fd  # noqa: E402
from rlaifv_tpu_torch.ops import int4_matmul as i4  # noqa: E402
from rlaifv_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from rlaifv_tpu_torch.ops.decode_attention import (  # noqa: E402
    NEG_INF,
    decode_attention,
    decode_attention_prefix,
    decode_attention_prefix_int8,
    decode_attention_prefix_int8_ref,
    decode_attention_prefix_int8_split_ref,
    decode_attention_prefix_ref,
    decode_attention_prefix_split_ref,
    decode_attention_ref,
    dequantize_kv,
    full_plan,
    prefix_block_l,
    prefix_int8_plan,
    prefix_plan,
    quantize_kv,
)
from rlaifv_tpu_torch.ops import fused_head as fh  # noqa: E402
from rlaifv_tpu_torch.ops.fused_head import (  # noqa: E402
    FIRST,
    LAST,
    _kernel_dl,
    _kernel_dw,
    _kernel_dx,
    _kernel_fwd,
    chunk_width,
    fwd_splits,
    fused_head_bwd,
    fused_head_bwd_plain,
    fused_head_fwd_plain,
    fused_target_logp,
)
from rlaifv_tpu_torch.core import distributed as dist_mod  # noqa: E402
from rlaifv_tpu_torch.data import native_loader  # noqa: E402
from rlaifv_tpu_torch.models import export as export_mod  # noqa: E402
from rlaifv_tpu_torch.models.convert import (  # noqa: E402
    llava_config_from_hf,
    load_jax_params,
    load_pretrained_llava,
    torch_module_name,
)
from rlaifv_tpu_torch.ops.image_kernels import DeviceImagePipeline, _resize_normalize  # noqa: E402
from rlaifv_tpu_torch.train.ref_logp import inference_logp  # noqa: E402
from rlaifv_tpu_torch.utils.file_io import read_jsonlines, write_jsonlines  # noqa: E402
from rlaifv_tpu_torch.utils.synth import continuous_mask, quotient_ties  # noqa: E402
from rlaifv_tpu_torch.train.train_step import (  # noqa: E402
    DPOHparams,
    LlavaDPOAdapter,
    batch_to_device,
    derive_shared_prefix_len,
    dpo_loss_from_batch,
    make_dpo_train_step,
    make_lora_dpo_train_step,
    make_optimizer,
    named_tensors,
    paired_masks,
    validate_shared_prefix,
)
from rlaifv_tpu_torch.train.lora import (  # noqa: E402
    adapter_pairs,
    attach_lora,
    lora_init,
    lora_scaled,
)
from rlaifv_tpu_torch.train import paired_forward as paired_mod  # noqa: E402
from rlaifv_tpu_torch.train.__main__ import (  # noqa: E402
    build_omnilmm as build_omnilmm_entry,
    quantize_base,
)
from rlaifv_tpu_torch.train.family import get_family  # noqa: E402
from rlaifv_tpu_torch.train.ref_logp import _encode_rows, score_preference_rows  # noqa: E402
from rlaifv_tpu_torch.train.trainer import DPOTrainer, resolve_head  # noqa: E402
from rlaifv_tpu_torch.parallel import sharding  # noqa: E402
from rlaifv_tpu_torch.ops.flash_attention import (  # noqa: E402
    _kernel_bwd_dkv,
    _kernel_bwd_dq,
    bwd_delta,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)

# bf16 outputs, checked as |kernel - plain| <= OUT_TOL + OUT_RTOL * |plain|:
# each side rounds once to bf16 (2^-8 relative) and the kernel also rounds
# the probabilities to bf16 for its P.V product, so outputs near 4 (a row
# that sees one key returns that value row) differ by one bf16 ulp, 2^-6;
# lse stays fp32 end to end
OUT_TOL = 1e-2
OUT_RTOL = 1e-2
LSE_TOL = 1e-3
# slice vs plain path: bf16 activations through 32 layers in two summation
# orders drift by a few bf16 ulps of the largest logit
SLICE_REL_TOL = 5e-2
# p(yes) is a softmax entry over 32000 tokens; logits within the bound
# above move it by far less than this
PROB_TOL = 1e-3
HBM_PEAK_GBPS = 3350.0  # H100 SXM data sheet
PEAK_BF16_TFLOPS = 989.0  # dense bf16 tensor-core rate, H100 SXM data sheet
PEAK_INT8_TOPS = 1979.0  # dense int8 tensor-core rate, H100 SXM data sheet
PEAK_FP32_TFLOPS = 67.0  # fp32 outside the tensor cores, H100 SXM data sheet
# backward, per gradient: max|kernel - plain| <= BWD_TOL x max|plain|. The
# kernels round P and dS to bf16 for their products (2^-9 relative each)
# and write bf16 outputs (one more rounding), while the plain backward
# stays fp32 to its final cast; over up to 2048 summed terms that leaves
# about one bf16 ulp of the largest entry (0.4-0.8% of max|plain|)
BWD_TOL = 2e-2
# train slice: policy == reference at step 0 makes the DPO margin exactly 0
# (the kernels are deterministic), so the loss is ln 2 to fp32 rounding
LN2_TOL = 1e-4
TRAIN_LR = 1e-4  # constant: a bf16 weight near 0.02 moves by ~1 ulp a step
# train slice vs its plain paths (bf16 activations through 32 layers in
# other summation orders): sequence logps (~-11 nats a token, ~2900 a
# sequence) within LOGP_RTOL of each other, losses within LOSS_TOL (the
# margin within 1 nat), and for each named gradient ||g - g_ref|| <=
# GRAD_REL_TOL ||g_ref|| and cosine >= GRAD_COS_MIN. The margin's gradient
# is the difference of the win and rej sequences' gradients, each a few
# times larger, so a few percent of bf16 noise in each shows as 5-10% in
# the difference (measured against dense attention, where the forward
# rounds other values than the kernels do: rel <= 0.098, cosine >= 0.9957
# on the 7B pair). Backward faults planted around the sound kernels and run
# through this comparison (dS scaled wrong, dk or dv zeroed, delta left
# out, q_offset ignored, the causal diagonal off by one, a dropped 64-row
# tile) each read, on the path they break, rel >= 0.35 and cosine <= 0.945
# on at least one tensor (PERF.md, PR 2); the bounds sit between the two
LOGP_RTOL = 5e-3
LOSS_TOL = 0.1
GRAD_REL_TOL = 0.2
GRAD_COS_MIN = 0.99
# fused head forward (3c): logp and lse within HEAD_FWD_TOL nats of the
# plain version. Both sum the same exact bf16 x bf16 products in fp32 over
# H (the kernel on the tensor cores, in another order): ~1e-5 at scores of
# ~1 and lse ~11. A ragged vocabulary tile left unmasked adds its zero
# scores to the sum: 63 columns at V = 32001 move lse by ~63 e^-11 = 9e-4
HEAD_FWD_TOL = 2e-4
# fused head backward (3c), elementwise: |kernel - plain| <= HEAD_GRAD_RTOL
# |plain| + HEAD_GRAD_ATOL max|plain|. Both round dl to bf16, sum in fp32
# and round the sum to bf16 once, so an entry differs by an ulp or two
# (one ulp is 2^-8 to 2^-7 of it); the atol covers entries that cancel to
# ~0. Not against max|plain| alone: dW's vocabulary rows that no label hits
# (the softmax part, ~1e-3) are ~1e-3 of the label rows, and a fault there
# (lse off, p wrong) would hide under a bound on the largest entry
HEAD_GRAD_RTOL = 2 ** -6
HEAD_GRAD_ATOL = 1e-5
# 3c's many-chunk case and its "chunk" fault: 8 vocabulary chunks at V =
# 32001, the last 3329 columns wide
PROBE_VC = 4096
# 8, ref-logp paths on the same rows: sequence sums and means within
# LOGP_RTOL between the shared-prefix scorer and the plain one (the
# attention paths round bf16 activations in other places, as in 7), within
# HEAD_LOGP_RTOL between the fused and the "xla" head on one forward (the
# "xla" head rounds each logit to bf16 first: 2^-9 of |logit| ~ 1, random
# in sign, ~0.004 nats a token and ~1e-5 of a ~-2700-nat sum); per-token
# logps within TOKEN_MEAN_TOL nats on average (single tokens spread wider)
HEAD_LOGP_RTOL = 1e-3
TOKEN_MEAN_TOL = 0.05
# 6, step 0: the reference logps come from phase 8's shared-prefix scorer
# (bf16 logits, the prefix left-padded to 128 columns) and the policy's
# from the paired forward with the fused head (fp32 logits, the prefix
# right-padded), so the margin is not exactly 0. loss = ln(1 + e^-beta m)
# ~ ln 2 - beta m / 2: REF_LN2_TOL = 0.1 allows a margin of 2 nats, each of
# the four ~-2700-nat sequence logps within ~2.5e-4 of its reference, the
# order phase 7 reads between attention paths
REF_LN2_TOL = 0.1
# 9: the QLoRA step-0 logps, loss and adapter gradients against the same
# step on the "dequant" route (the int8 weights dequantised to bf16, no
# activation quantisation). Rowwise int8 quantisation rounds each entry of
# a row to a step of max|row| / 127: for Gaussian-like rows (max ~4.5 rms
# at K = 4096) that is ~1% rms noise on every projection's input in the
# forward and on every dy * s in the backward, against the ~0.4% of one
# bf16 rounding. The logps stay within QLORA_LOGP_RTOL (read 6.1e-4) and
# the losses within LOSS_TOL. The gradients of b at layers 0 and 31 (a and
# its gradient are 0 at step 0: b starts at 0) collect that noise from
# every layer between them and the loss, twice (forward activations and
# backward dy): the SFT term's gradient (the chosen sequences' mean logp,
# the same step with dpo_weight 0 and sft_weight 1) read rel 0.046-0.25
# and cosine >= 0.967, the DPO margin's gradient, a difference of the win
# and rej gradients each several times larger, rel 0.16-0.43 and cosine
# >= 0.914 (on an H100 80GB HBM3, PERF.md section 6; the same inputs and
# deterministic kernels repeat these readings). The bounds sit about 1.5x outside them:
# a scale left out or a dy quantised without its row scale moves rel far
# past 1, a wrong or dropped dx turns the cosine to ~0
QLORA_LOGP_RTOL = 5e-3
# 3d: one projection's int8 route against the dequant route on Gaussian
# inputs: ~1% (see route_noise), plus bf16 rounding of both outputs
ROUTE_REL_TOL = 0.03
QLORA_GRAD_REL_TOL = 0.6
QLORA_GRAD_COS_MIN = 0.85
QLORA_SFT_GRAD_REL_TOL = 0.4
QLORA_SFT_GRAD_COS_MIN = 0.95
QLORA_LR = 1e-4  # constant: the adapters' b moves off 0 by ~lr a step
# 3f: kernel #5 against its twin, max|kernel - twin| <= KV8_TOL max|twin|.
# Both sum the integer products exactly, quantise q and p with IEEE
# divisions and round the fp32 epilogues alike (no FMA contraction); expf
# against torch's exp moves a probability by an ulp, which can flip one p8
# by one step (~1/127 of one key's share), and the output is bf16 (2^-9)
KV8_TOL = 2 ** -7
# 11 against its plain paths (logits of a prefill and 4 forced decode
# steps). The JAX package holds a tiny fp32 model's int8-cache decode to 5%
# of max|logit| (tests/test_kv_int8.py). A random-weight 7B model in bf16
# amplifies ulp-level differences far more: flash against dense attention
# moves phase 5's logits by 4.3% of max|logit|, and with int8 weights every
# projection's row quantisation turns such differences into whole
# quantisation steps: the int8-KV prefill (fresh-window flash) against a
# bf16-cache prefill run dense over max_len columns, the same function, read
# 0.159-0.177 (NVIDIA H100 80GB HBM3, PERF.md section 6; both prefills now
# run flash over the prompt columns and read 0). So each comparison is held to
# INT8_KV_REL_TOL of max|logit| and, for the direction of every logit row,
# to a cosine of at least INT8_KV_COS_MIN
INT8_KV_REL_TOL = 0.4
INT8_KV_COS_MIN = 0.9
# 11: the JAX package's headline serving shape (scripts/bench_7b_serve.py)
HEADLINE_B, HEADLINE_PROMPT, HEADLINE_NEW = 24, 896, 64
# 14: the eval slice (evals/vqa.py's generate_answers, 3 beams, the eval
# scripts' default) on 8 rows in one batch; 64 new tokens where the eval CLI
# defaults to 1024: a random-weight model never emits EOS, so every row
# would run all 1024 steps (~16x the phase's decode time) at the same
# kernels and the same step shape but a longer live prefix; 64 keeps the
# step at L 896 (the shape the row-4 timing below takes) within the run's
# time. Phase 11's int8-KV beam batch: 4 rows, 3 beams, 16 new tokens
EVAL_ROWS, EVAL_BEAMS, EVAL_NEW = 8, 3, 64
EVAL_QUESTIONS = ["What is in the image?", "Describe the scene in detail.",
                  "What colors do you see?", "Is it daytime?", "How many objects are there?",
                  "What is on the left side?", "Describe the background.",
                  "What is the main object doing?"]
EVAL_REPLAY_STEPS = 4
KV8_BEAM_ROWS, KV8_BEAM_NEW = 4, 16
# 10: the int4 QLoRA step 0 against the "dequant" route (the int4 weights
# dequantised to bf16, no activation quantisation), as in 9: the same ~1%
# rowwise activation quantisation on every projection's forward and on the
# dx of q/k/v/o/down (#12 quantises dy * gs[j] per row and group); gate/up
# dx takes the dequant formula on both routes. Read on an H100 80GB HBM3
# (PERF.md section 6, PR 5; deterministic kernels on the same inputs):
# logps 7.6e-4 relative; the DPO margin's b gradients rel 0.24-0.48, cosine
# >= 0.887 (layer 31 q_proj; a little below 9's 0.914); the SFT term's rel
# 0.047-0.24, cosine >= 0.970. The bounds sit about 1.5x outside the
# readings (rel, and 1 - cosine), as in 9
INT4_LOGP_RTOL = QLORA_LOGP_RTOL
INT4_GRAD_REL_TOL = 0.75
INT4_GRAD_COS_MIN = 0.82
INT4_SFT_GRAD_REL_TOL = QLORA_SFT_GRAD_REL_TOL
INT4_SFT_GRAD_COS_MIN = QLORA_SFT_GRAD_COS_MIN


def _fake_tokenizer():
    """tests/fake_tokenizer.py, loaded by path: an installed package named
    `tests` would shadow the repository's namespace package."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "rlaifv_fake_tokenizer", ROOT / "tests" / "fake_tokenizer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FakeTokenizer()


def log(msg: str) -> None:
    print(msg, flush=True)


COUNTERS = {  # every kernel's launch count: (owner, attribute)
    "flash": (flash_attention, "launches"),
    "dq": (flash_attention_bwd, "dq_launches"),
    "dkv": (flash_attention_bwd, "dkv_launches"),
    "decode": (decode_attention_prefix, "launches"),
    "decode_int8": (decode_attention_prefix_int8, "launches"),
    "decode_full": (decode_attention, "launches"),
    "head_fwd": (fused_target_logp, "fwd_launches"),
    "head_dl": (fused_target_logp, "dl_launches"),
    "head_dx": (fused_target_logp, "dx_launches"),
    "head_dw": (fused_target_logp, "dw_launches"),
    "int8": (qm.int8_matmul, "launches"),
    "int8_dx": (qm.int8_matmul_dx, "launches"),
    "int8_prequant": (qm.int8_matmul_prequant, "launches"),
    "int8_dx_prequant": (qm.int8_matmul_dx_prequant, "launches"),
    "int4": (i4.int4_matmul, "launches"),
    "int4_dx": (i4.int4_matmul_dx, "launches"),
    "fused": (fd.fused_decode_step, "launches"),
}


def reset_counts() -> None:
    for owner, attr in COUNTERS.values():
        setattr(owner, attr, 0)


def read_counts() -> dict:
    return {k: getattr(owner, attr) for k, (owner, attr) in COUNTERS.items()}


def add_counts(total: dict, more: dict) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 20) -> float:
    """Median CUDA-event time of fn() over `runs` launches, after warm-up.

    A spin kernel first holds the stream for ~25 ms so the host queues all
    runs ahead of the device: each event pair then brackets device work
    only, not the Python wrapper's time before the launch (which is longer
    than a small decode kernel)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}  # CUgraphNodeType


def launched_ops(fn) -> dict:
    """What one call of fn() puts on the card: the call is captured into a
    CUDA graph (never replayed) and the graph's nodes are read back through
    the driver, {"kernel": n, "memset": n, ...}. A wrapper's
    `.launches` counts its calls; this counts what a call launched."""
    import ctypes
    from collections import Counter

    cu = ctypes.CDLL("libcuda.so.1")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    ops = Counter()
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        ops[GRAPH_NODE_TYPES.get(kind.value, f"node type {kind.value}")] += 1
    graph.reset()
    return dict(ops)


def ops_text(ops: dict) -> str:
    return ", ".join(f"{n} {what} node{'s' * (n != 1)}" for what, n in sorted(ops.items()))


def bound(flop: float, nbytes: float, peak_tera: float = PEAK_BF16_TFLOPS) -> dict:
    """The least time the card could take for the work: the larger of the
    operations at the tensor-core peak for their type (bf16 unless given)
    and the bytes (each input read once, each output written once) at the
    HBM peak."""
    t_ops = flop / (peak_tera * 1e12) * 1e3
    t_bytes = nbytes / (HBM_PEAK_GBPS * 1e9) * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _visible(mask: torch.Tensor, Lq: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs this mask lets the attention read: keys with mask
    1, and (causal) at or before the query's absolute position."""
    if not causal:
        return int(mask.sum()) * Lq
    last = torch.clamp(q_offset + torch.arange(Lq, device=mask.device), max=mask.shape[1] - 1)
    return int(torch.cumsum(mask.long(), dim=1)[:, last].sum())


def _sdpa_mask(mask: torch.Tensor, Lq: int, causal: bool, q_offset: int) -> torch.Tensor:
    """The boolean (B, 1, Lq, Lk) mask of the same attention for SDPA."""
    keep = (mask != 0)[:, None, None, :]
    if causal:
        qpos = q_offset + torch.arange(Lq, device=mask.device)[:, None]
        keep = keep & (torch.arange(mask.shape[1], device=mask.device)[None, :] <= qpos)
    return keep


def sdpa(q, k, v, keep):
    """torch's scaled_dot_product_attention on (B, L, H, D) operands: the
    library yardstick of the attention kernels, timed here only."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=keep)
    return out.transpose(1, 2)


def phase_environment() -> str:
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    cutlass = "/usr/local/cutlass/include"
    smi = nvidia_smi()
    log(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | nvcc: {nvcc.splitlines()[-1]} | "
        f"triton {triton_v} | cutlass {cutlass if os.path.isdir(cutlass) else 'absent'}")
    log(f"[1 env] nvidia-smi: {smi} | torch sees {torch.cuda.device_count()} x "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_kernels()
    log(f"[2 build] nvcc -> {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    entry = ""
    for line in _build.build_log.splitlines():
        if "entry function" in line:
            entry = line.split("'")[1][:48]
        elif "Used" in line or ("bytes spill" in line and
                                "0 bytes spill stores, 0 bytes spill loads" not in line):
            log(f"[2 build] ptxas {entry}: {line.split(':', 1)[-1].strip()}")


def build_variants(variants: dict) -> dict:
    """Deliberately broken copies of the kernels, for planted faults: each
    variant {tag: [(file, old, new), ...]} replaces, in a copy of csrc/
    under build/, each `old` text (which must occur exactly once) with
    `new`, and builds its changed sources with common.cu into a library of
    its own (all variants' nvcc processes started together). Returns {tag:
    library}; `kernels_from(library)` runs the wrappers on it."""
    root = _build.BUILD_DIR / "variants"
    jobs = []
    for tag, edits in variants.items():
        d = root / tag
        d.mkdir(parents=True, exist_ok=True)
        texts = {}
        for name, old, new in edits:
            text = texts.get(name, (_build.CSRC / name).read_text())
            if text.count(old) != 1:
                raise AssertionError(f"variant {tag}: {old!r} occurs {text.count(old)} "
                                     f"times in {name}")
            texts[name] = text.replace(old, new)
        srcs = []
        for name, text in texts.items():
            (d / name).write_text(text)
            srcs.append(d / name)
        jobs.append((tag, d / "lib.so", srcs + [_build.CSRC / "common.cu"]))
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda j: _build.compile_and_link(j[1], j[2], include=_build.CSRC),
                      jobs))
    return {tag: _build.open_library(path) for tag, path, _ in jobs}


@contextlib.contextmanager
def kernels_from(lib):
    """The ops' wrappers launch from `lib` (a variant) inside the block."""
    saved = _build._lib
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = saved


def _within(out: torch.Tensor, ref: torch.Tensor) -> bool:
    out, ref = out.float(), ref.float()
    return bool(((out - ref).abs() <= OUT_TOL + OUT_RTOL * ref.abs()).all())


def _randn(g, *shape):
    return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)


# 3: the flash forward's cases at the serving slice's shapes
FLASH_FWD_CASES = [
    dict(name="autocheck prefix", B=1, L=740, H=32, KVH=32, D=128, causal=True, masked=20),
    dict(name="gqa", B=2, L=1024, H=32, KVH=8, D=128, causal=True, masked=0),
    dict(name="bidirectional", B=1, L=577, H=16, KVH=16, D=64, causal=False, masked=0),
    # phase 18b's prefill: 8 MiniCPM-V prompts of 576 tokens, Llama3-8B's GQA
    dict(name="minicpmv prefill", B=8, L=576, H=32, KVH=8, D=128, causal=True, masked=16),
    # phase 19c's prefill: one LLaVA-1.6 anyres prompt of 2349 tokens, MHA
    dict(name="anyres prefill", B=1, L=2349, H=32, KVH=32, D=128, causal=True, masked=0),
]

# 3 / 3b: planted faults in the redesigned flash kernels, each a broken copy
# of one source (build_variants) that must break its phase's comparison: #1
# on the autocheck prefix (3), #3 and #2 on 3b's GQA case (n_rep 4)
FLASH_FWD_FAULTS = {
    "fwd: the diagonal tile left unmasked": [(
        "flash_attention.cu", "const bool diag = p.causal && k0 + BK - 1 > p.q_offset + r_wg;",
        "const bool diag = false;")],
    "fwd: the alpha rescale skipped": [(
        "flash_attention.cu", "for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];",
        "for (int i = 0; i < D / 2; ++i) o[i] *= 1.f;")],
    "fwd: the last ragged key tile dropped": [(
        "flash_attention.cu", "int key_tiles(int end) { return (end + BK - 1) / BK; }",
        "int key_tiles(int end) { return end / BK; }")],
}
FLASH_DKV_FAULTS = {
    "dkv: the last query head of a kv head skipped": [(
        "flash_attention_bwd.cu", "const int steps = n_rep * n_q;",
        "const int steps = (n_rep - 1) * n_q;")],
    "dkv: the causal mask off": [(
        "flash_attention_bwd.cu", "const bool diag = p.causal && kw0 + 63 > p.q_offset + qt;",
        "const bool diag = false;")],
    "dkv: the delta term dropped": [(
        "flash_attention_bwd.cu", "dp[i] = pv * (dp[i] - dlt) * p.scale;",
        "dp[i] = pv * dp[i] * p.scale;")],
}
FLASH_DQ_FAULTS = {
    "dq: the diagonal tile left unmasked": [(
        "flash_attention_bwd.cu",
        "const bool on_diagonal = p.causal && k0 + BK - 1 > p.q_offset + r_wg;",
        "const bool on_diagonal = false;")],
    "dq: the delta term dropped": [(
        "flash_attention_bwd.cu", "ds[e] = pv * (dp[i] - dlt[hh]) * p.scale;",
        "ds[e] = pv * dp[i] * p.scale;")],
    "dq: the last ring stage of the key walk skipped": [(
        "flash_attention_bwd.cu",
        "n_wg = p.causal ? key_tiles(min(p.Lk, p.q_offset + min(r_wg + 64, p.Lq))) : n_tiles;",
        "n_wg = p.causal ? key_tiles(min(p.Lk, p.q_offset + min(r_wg + 64, p.Lq))) - 1\n"
        "                   : n_tiles - 1;")],
}


def flash_fwd_inputs(g, c: dict) -> tuple:
    """q, k, v and the int32 key mask of a FLASH_FWD_CASES case: the first
    `masked` keys of every row off (its first queries see nothing) and, for
    "gqa", a padded key tail on row 1."""
    B, L, H, KVH, D = c["B"], c["L"], c["H"], c["KVH"], c["D"]
    q, k, v = _randn(g, B, L, H, D), _randn(g, B, L, KVH, D), _randn(g, B, L, KVH, D)
    mask = torch.ones((B, L), dtype=torch.int32, device="cuda")
    mask[:, :c["masked"]] = 0
    if c["name"] == "gqa":
        mask[1, -100:] = 0
    return q, k, v, mask


def flash_library(q, k, v, mask, causal: bool, q_offset: int, out, lse) -> dict:
    """SDPA's time on the same attention (KV heads repeated to H beforehand)
    and the forward's bound: 4 D flops a visible (query, key) pair of a
    head; q, k, v, the mask read and out, lse written once."""
    B, Lq, H, D = q.shape
    n_rep = H // k.shape[2]
    kr, vr = (x.repeat_interleave(n_rep, dim=2) for x in (k, v))
    keep = _sdpa_mask(mask, Lq, causal, q_offset)
    flop = 4 * H * D * _visible(mask, Lq, causal, q_offset)
    return dict(library_ms=time_ms(lambda: sdpa(q, kr, vr, keep)),
                **bound(flop, _nbytes(q, k, v, out, lse, mask)))


def flash_faults_caught(tag: str, libs: dict, run, check) -> None:
    """Each broken variant in libs must fail `check(run())`, the phase's own
    comparison (True = within its bounds)."""
    for name, lib in libs.items():
        with kernels_from(lib):
            got = run()
        torch.cuda.synchronize()
        ok, reading = check(got)
        log(f"{tag} planted fault {name!r}: {reading} | {'MISSED' if ok else 'caught'}")
        if ok:
            raise AssertionError(f"{tag}: the comparison misses the planted fault {name!r}")


def phase_kernels(g, variants) -> dict:
    """3: the flash forward (#1) and the prefix decode kernel (#4) against
    their plain versions at the serving shapes (#4 also against its split
    twin at the card's plan, and at the Llama3 GQA step); #1's and #4's
    planted faults from the broken copies `variants` (a future of
    build_variants) builds."""
    results = {}
    # --- flash attention forward
    err_max = 0.0
    for c in FLASH_FWD_CASES:
        B, L, H, KVH, D = c["B"], c["L"], c["H"], c["KVH"], c["D"]
        q, k, v, mask = flash_fwd_inputs(g, c)
        kw = dict(attention_mask=mask, causal=c["causal"])
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = flash_attention_ref(q, k, v, mask, c["causal"])
        torch.cuda.synchronize()
        e_out = (out.float() - ref.float()).abs().max().item()
        ok_out = _within(out, ref)
        e_lse = (lse - ref_lse).abs().max().item()
        if c["masked"]:
            assert (out[:, :c["masked"]] == 0).all(), "fully masked rows must be 0"
        ok = ok_out and e_lse <= LSE_TOL and bool(torch.isfinite(out.float()).all())
        t_k = time_ms(lambda: flash_attention(q, k, v, **kw))
        t_p = time_ms(lambda: flash_attention_ref(q, k, v, mask, c["causal"]))
        launched = launched_ops(lambda: flash_attention(q, k, v, **kw))
        ok = ok and launched == {"kernel": 1}
        log(f"[3 flash] {c['name']}: B={B} L={L} H={H} KVH={KVH} D={D} "
            f"causal={c['causal']} | max|out err| {e_out:.3e} (tol {OUT_TOL} + "
            f"{OUT_RTOL} x |plain|) "
            f"max|lse err| {e_lse:.3e} (tol {LSE_TOL}) | kernel {t_k:.4f} ms "
            f"plain {t_p:.4f} ms | one call captured in a CUDA graph: {ops_text(launched)} "
            f"| {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version: {c}")
        err_max = max(err_max, e_out)
        if c["name"] in ("autocheck prefix", "gqa"):
            lib = flash_library(q, k, v, mask, c["causal"], 0, out, lse)
            results.setdefault("flash_cases", {})[c["name"]] = dict(ms=t_k, plain_ms=t_p, **lib)
            log(f"[3 flash] {c['name']}: SDPA with the same boolean mask "
                f"{lib['library_ms']:.4f} ms (library yardstick) | bound "
                f"{lib['bound_ms']:.4f} ms ({lib['bound_by']}) | kernel "
                f"{4 * H * D * _visible(mask, L, True, 0) / (t_k * 1e-3) / 1e12:.1f} TFLOP/s")
        if c["name"] == "autocheck prefix":
            results["flash"] = results["flash_cases"][c["name"]]
            kept = (q, k, v, kw, ref, ref_lse)
    results["flash"]["max_abs_err"] = err_max

    # broken copies of #1 on the autocheck prefix
    q, k, v, kw, ref, ref_lse = kept

    def check_fwd(got):
        out, lse = got
        e_lse = (lse - ref_lse).abs().max().item()
        ok = _within(out, ref) and e_lse <= LSE_TOL
        return ok, (f"max|out err| {(out.float() - ref.float()).abs().max().item():.3e} "
                    f"max|lse err| {e_lse:.3e}")

    libs = variants.result()
    flash_faults_caught("[3 flash]", {n: libs[n] for n in FLASH_FWD_FAULTS},
                        lambda: flash_attention(q, k, v, return_lse=True, **kw), check_fwd)

    # --- prefix decode attention (#4): phase 4's shape at four valid_len,
    # then its other main-path shapes from a generator of their own
    B, L, H, KVH, D = 10, 896, 32, 32, 128
    q, k0, v0 = _randn(g, B, H, D), _randn(g, B, L, KVH, D), _randn(g, B, L, KVH, D)
    err_max = 0.0
    for valid_len in (1, 640, 700, 896):
        mask = torch.zeros((B, L), dtype=torch.int32, device="cuda")
        for b in range(B):
            mask[b, 7 * b:valid_len] = 1  # left padding of 7b columns
        k, v = k0.clone(), v0.clone()
        k[:, valid_len:] = float("nan")  # never read: poison
        v[:, valid_len:] = float("nan")
        r = _prefix_case(f"phase 4 valid_len={valid_len}", q, k, v, mask, valid_len,
                         timed=valid_len == 896)
        err_max = max(err_max, r["max_abs_err"])
        if valid_len == 896:
            results["decode"] = r
    gp = torch.Generator(device="cuda").manual_seed(18)
    for c in PREFIX_CASES:
        B, L, H, KVH, valid_len = (c[x] for x in ("B", "L", "H", "KVH", "valid"))
        q, k, v = _randn(gp, B, H, D), _randn(gp, B, L, KVH, D), _randn(gp, B, L, KVH, D)
        mask = torch.zeros((B, L), dtype=torch.int32, device="cuda")
        for b in range(B):
            mask[b, 7 * b:valid_len] = 1
        k[:, valid_len:] = float("nan")
        v[:, valid_len:] = float("nan")
        r = _prefix_case(c["name"], q, k, v, mask, valid_len,
                         timed=c["name"] != PREFIX_FAULT_CASE)
        err_max = max(err_max, r["max_abs_err"])
        results.setdefault("decode_cases", {})[c["name"]] = r
        if c["name"] == PREFIX_FAULT_CASE:
            twin = decode_attention_prefix_split_ref(q, k, v, mask, valid_len, r["splits"])
            flash_faults_caught(
                "[3 decode]", {n: libs[n] for n in PREFIX_FAULTS},
                lambda: decode_attention_prefix(q, k, v, mask, valid_len),
                lambda got: _prefix_fault_reading(got, twin, r["splits"]))
        del q, k, v, mask
    results["decode"]["max_abs_err"] = err_max
    torch.cuda.empty_cache()
    return results


# 3: kernel #4 at the main path's other shapes: the bf16 batch-24 run, the
# bf16 Llama3-8B divide-and-conquer backend's GQA step at a long prefix and at
# phase 13's short prompts, phase 19c's 3 anyres beams (MHA, a long prefix:
# key splits); then the GQA step at a prefix where a dropped partial tile
# moves the output well past the bound (the planted faults' case)
PREFIX_CASES = [
    dict(name="batch 24", B=24, L=1024, H=32, KVH=32, valid=960),
    dict(name="Llama3 GQA", B=8, L=2304, H=32, KVH=8, valid=2200),
    dict(name="phase 13 short", B=8, L=512, H=32, KVH=8, valid=384),
    dict(name="19c anyres beams", B=3, L=2432, H=32, KVH=32, valid=2400),
    dict(name="Llama3 GQA valid_len 600", B=8, L=2304, H=32, KVH=8, valid=600),
]
# 3: broken copies of csrc/decode_attention.cu that must break the bf16
# bound against the split twin on PREFIX_FAULT_CASE (2 key splits of 300
# keys: each split's last 16-key tile holds 12)
PREFIX_FAULT_CASE = "Llama3 GQA valid_len 600"
PREFIX_FAULTS = {
    "#4: one split left out of the merge": [(
        "decode_attention.cu",
        "  for (int s = 0; s < splits; ++s) {\n    const float *ps = p + s * (D + 2);",
        "  for (int s = 1; s < splits; ++s) {\n    const float *ps = p + s * (D + 2);")],
    "#4: a split merged without rescaling to the common max": [(
        "decode_attention.cu", "    const float c = exp2f(mx - m_new), a = exp2f(m_s - m_new);",
        "    const float c = 1.f, a = 1.f;")],
    "#4: the last partial key tile dropped": [(
        "decode_attention.cu", "const int n_tiles = (l1 - l0 + TILE - 1) / TILE;",
        "const int n_tiles = (l1 - l0) / TILE;")],
}


def _prefix_fault_reading(got: torch.Tensor, twin: torch.Tensor, splits: int) -> tuple:
    ratio = _full_ratio(got, twin)[1]
    return ratio <= 1, f"{ratio:.3g} of the bf16 bound against the split twin ({splits} splits)"


def _prefix_case(name: str, q, k, v, mask, valid_len: int, timed: bool) -> dict:
    """Kernel #4 on one case against its plain version and its split twin at
    the card's plan, within the bf16 bound; rows padded past valid_len
    exactly 0; the kernels one call launches (a CUDA graph of one call)
    against the plan; with `timed`, the kernel, plain and SDPA times (SDPA
    over the live prefix, KV repeated to H beforehand, the repeat not timed)
    and the bound. Logs one line; raises on a disagreement."""
    B, H, D = q.shape
    L, KVH = k.shape[1], k.shape[2]
    splits = prefix_plan(B, KVH, valid_len, qm._sms(0), H // KVH)
    out = decode_attention_prefix(q, k, v, mask, valid_len)
    ref = decode_attention_prefix_ref(q, k, v, mask, valid_len)
    twin = decode_attention_prefix_split_ref(q, k, v, mask, valid_len, splits)
    torch.cuda.synchronize()
    (e, ratio), (e_t, ratio_t) = _full_ratio(out, ref), _full_ratio(out, twin)
    e, ratio = max(e, e_t), max(ratio, ratio_t)
    dead = [b for b in range(B) if not bool(mask[b, :valid_len].any())]
    launched = launched_ops(lambda: decode_attention_prefix(q, k, v, mask, valid_len))
    ok = ratio <= 1 and all(bool((out[b] == 0).all()) for b in dead) and \
        launched == {"kernel": 1 + (splits > 1)}
    t_k = time_ms(lambda: decode_attention_prefix(q, k, v, mask, valid_len))
    t_p = time_ms(lambda: decode_attention_prefix_ref(q, k, v, mask, valid_len), 10)
    live = [x[:, :valid_len] for x in (k, v, mask)]
    nbytes = _nbytes(q, *live, out)
    gbps = nbytes / (t_k * 1e-3) / 1e9
    msg = (f"[3 decode] {name}: B={B} L={L} H={H} KVH={KVH} D={D} valid_len={valid_len}, "
           f"{splits} key splits; one call captured in a CUDA graph: {ops_text(launched)}, "
           f"{1 + (splits > 1)} planned | max|err| {e:.3e} = {ratio:.3f} of the bound (tol "
           f"{OUT_TOL} + {OUT_RTOL} x |plain|, against the plain version and the split "
           f"twin), {len(dead)} fully masked rows | kernel {t_k:.4f} ms plain {t_p:.4f} ms | "
           f"{gbps:.0f} GB/s = {gbps / HBM_PEAK_GBPS:.1%} of {HBM_PEAK_GBPS:.0f} GB/s")
    res = dict(ms=t_k, plain_ms=t_p, gbps=gbps, max_abs_err=e, splits=splits,
               kernels_a_call=launched.get("kernel", 0))
    if timed:
        kr, vr = (x.repeat_interleave(H // KVH, dim=2) for x in live[:2])
        keep = (live[2] != 0)[:, None, None, :]
        res["library_ms"] = time_ms(lambda: sdpa(q[:, None], kr, vr, keep))
        res.update(bound(4 * H * D * int(live[2].sum()), nbytes))
        msg += (f", bound {res['bound_ms']:.4f} ms ({res['bound_by']}), "
                f"{t_k / res['bound_ms']:.2f}x; SDPA over the live prefix "
                f"{res['library_ms']:.4f} ms (library yardstick)")
        del kr, vr
    log(msg + f" | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode kernel #4 disagrees: {name}")
    return res


def _visible_pairs(Lq: int, Lk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs the attention reads: causal rows see keys up to
    their absolute position."""
    if not causal:
        return Lq * Lk
    return int(torch.clamp(q_offset + torch.arange(Lq) + 1, max=Lk).sum())


def _bwd_cases(pair: dict, omni: dict = None) -> list:
    """3b's cases: five fixed train shapes, then the three attention calls
    the train step makes on its collated pair (phase 6's batch), with that
    batch's own masks: the plain path (2, L, L), the paired prefix
    (1, Pa, Pa) and the paired suffix (2, W, Pa + W) at q_offset = Pa; then
    given `omni`, the same three of phase 17's OmniLMM-12B pair at
    Mistral's GQA (8 KV heads for 32)."""
    def ones(B, Lk):
        return torch.ones((B, Lk), dtype=torch.int32, device="cuda")

    tail = ones(2, 2048)
    tail[-1, -300:] = 0  # padded key tail of the last row
    pre = ones(1, 640)
    pre[:, -5:] = 0  # alignment pad rows of Pa = 640
    suf = tail.clone()
    suf[:, 635:640] = 0  # the prefix's pad rows, tiled
    return [
        dict(name="plain dpo", Lq=2048, KVH=32, off=0, mask=tail),
        dict(name="gqa", Lq=2048, KVH=8, off=0, mask=tail),
        dict(name="paired prefix", Lq=640, KVH=32, off=0, mask=pre),
        dict(name="paired suffix", Lq=1408, KVH=32, off=640, mask=suf),
        dict(name="ragged", Lq=901, KVH=32, off=0, mask=ones(1, 901)),
    ] + _pair_cases("train", pair, KVH=32) + \
        (_pair_cases("12B", omni, KVH=8) if omni else []) + \
        [dict(c, name=f"{c['name']} tp{32 // h}", H=h, KVH=h)
         for c in _pair_cases("train", pair, KVH=32) if c["name"] == "train suffix"
         for h in (16, 8)]


def _pair_cases(name: str, pair: dict, KVH: int) -> list:
    """The three attention calls of one collated pair's step: plain over its
    2 rows, the paired prefix and the paired suffix at q_offset = Pa."""
    mask = torch.from_numpy(pair["batch_np"]["attention_mask"]).cuda()
    P, L = pair["P"], mask.shape[1]
    pmask, smask = paired_masks(mask, P, L - P)
    Pa = pmask.shape[1]
    return [dict(name=f"{name} plain", Lq=L, KVH=KVH, off=0, mask=mask),
            dict(name=f"{name} prefix", Lq=Pa, KVH=KVH, off=0, mask=pmask),
            dict(name=f"{name} suffix", Lq=L - P, KVH=KVH, off=Pa, mask=smask)]


def phase_backward(g, pair: dict, variants, omni: dict) -> dict:
    """3b: the forward kernel and the two backward kernels against their
    plain versions at the train step's shapes (causal, H = 32, D = 128), at
    phase 17's 12B pair (KVH 8) and at the train suffix's tensor-parallel
    shards (16 and 8 local heads, phase 21's tp 2 and 4); #3's and #2's
    planted faults on the GQA case."""
    D = 128
    res = {"fwd_err": 0.0, "dq_err": 0.0, "dkv_err": 0.0, "cases": {}}
    # the 12B pair's and the tp shards' cases draw from generators of their
    # own: the phases after 3b keep the inputs they had before those cases
    # were added
    g12 = torch.Generator(device="cuda").manual_seed(12)
    gtp = torch.Generator(device="cuda").manual_seed(21)
    for c in _bwd_cases(pair, omni):
        mask, Lq, KVH, off, H = c["mask"], c["Lq"], c["KVH"], c["off"], c.get("H", 32)
        B, Lk = mask.shape
        cg = g12 if c["name"].startswith("12B") else gtp if "tp" in c["name"] else g
        q, k, v = _randn(cg, B, Lq, H, D), _randn(cg, B, Lk, KVH, D), _randn(cg, B, Lk, KVH, D)
        out, lse = flash_attention(q, k, v, attention_mask=mask, q_offset=off,
                                   return_lse=True)
        ref_out, ref_lse = flash_attention_ref(q, k, v, mask, True, off)
        do = _randn(cg, B, Lq, H, D)
        args = (q, k, v, mask, out, lse, do, True, off)
        got = flash_attention_bwd(*args)
        ref = flash_attention_bwd_ref(*args)
        torch.cuda.synchronize()
        e_out = (out.float() - ref_out.float()).abs().max().item()
        e_lse = (lse - ref_lse).abs().max().item()
        ok = _within(out, ref_out) and e_lse <= LSE_TOL and \
            bool(torch.isfinite(out.float()).all())
        errs = []
        for a, r in zip(got, ref):
            errs.append((a.float() - r.float()).abs().max().item())
            ok = ok and errs[-1] <= BWD_TOL * r.float().abs().max().item() and \
                bool(torch.isfinite(a.float()).all())
        kargs = (q, k, v, mask, do, lse, bwd_delta(out, do), True, off)
        t_fwd = time_ms(lambda: flash_attention(q, k, v, attention_mask=mask, q_offset=off))
        t_dq = time_ms(lambda: _kernel_bwd_dq(*kargs))
        t_dkv = time_ms(lambda: _kernel_bwd_dkv(*kargs))
        t_pair = time_ms(lambda: flash_attention_bwd(*args))
        t_plain = time_ms(lambda: flash_attention_bwd_ref(*args), runs=10)
        launched = [launched_ops(fn) for fn in (
            lambda: flash_attention(q, k, v, attention_mask=mask, q_offset=off),
            lambda: _kernel_bwd_dq(*kargs), lambda: _kernel_bwd_dkv(*kargs))]
        ok = ok and all(n == {"kernel": 1} for n in launched)
        pairs = H * D * _visible(mask, Lq, True, off)
        log(f"[3b flash bwd] {c['name']}: B={B} Lq={Lq} Lk={Lk} H={H} KVH={KVH} "
            f"D={D} q_offset={off} | fwd max|out err| {e_out:.3e} (tol {OUT_TOL} + "
            f"{OUT_RTOL} x |plain|) max|lse err| {e_lse:.3e} (tol {LSE_TOL}) | bwd "
            f"max|err| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (tol "
            f"{BWD_TOL} x max|plain|) | fwd kernel {t_fwd:.4f} ms = "
            f"{4 * pairs / (t_fwd * 1e-3) / 1e12:.1f} TFLOP/s, dq kernel {t_dq:.4f} ms = "
            f"{6 * pairs / (t_dq * 1e-3) / 1e12:.1f}, dk/dv kernel {t_dkv:.4f} ms = "
            f"{8 * pairs / (t_dkv * 1e-3) / 1e12:.1f}, pair with delta {t_pair:.4f} ms | "
            f"plain {t_plain:.4f} ms | kernels a call (CUDA graphs of one fwd, dq, dk/dv "
            f"call): {', '.join(ops_text(n) for n in launched)} | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernels disagree with the plain versions: "
                                 f"{c['name']}")
        res["fwd_err"] = max(res["fwd_err"], e_out)
        res["dq_err"] = max(res["dq_err"], errs[0])
        res["dkv_err"] = max(res["dkv_err"], errs[1], errs[2])
        res["cases"][c["name"]] = dict(fwd_ms=t_fwd, dq_ms=t_dq, dkv_ms=t_dkv,
                                       plain_ms=t_plain)
        # the longest, the 7B and the 12B train steps' largest
        if c["name"] in ("plain dpo", "train suffix", "12B suffix", "train suffix tp2",
                         "train suffix tp4"):
            # KV heads repeated to H beforehand (GQA), as flash_library does
            ql, kl, vl = (t.detach().repeat_interleave(H // t.shape[2], dim=2)
                          .requires_grad_(True) for t in (q, k, v))
            lib_out = sdpa(ql, kl, vl, _sdpa_mask(mask, Lq, True, off))
            t_lib = time_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                        retain_graph=True))
            fwd_lib = flash_library(q, k, v, mask, True, off, out, lse)
            fwd_lib["plain_ms"] = time_ms(lambda: flash_attention_ref(q, k, v, mask, True, off),
                                          runs=10)
            stats = _nbytes(lse, lse, mask)  # lse, delta, mask
            res["cases"][c["name"]].update(
                library_ms=t_lib, fwd_library=fwd_lib,
                dq_bound=bound(6 * pairs, _nbytes(q, k, v, do, q) + stats),
                dkv_bound=bound(8 * pairs, _nbytes(q, k, v, do, k, v) + stats))
            r = res["cases"][c["name"]]
            log(f"[3b flash bwd] {c['name']}: SDPA's autograd backward (dq, dk, dv "
                f"together) {t_lib:.4f} ms, SDPA forward {fwd_lib['library_ms']:.4f} ms "
                f"(library yardsticks), plain forward {fwd_lib['plain_ms']:.4f} ms | bound fwd "
                f"{fwd_lib['bound_ms']:.4f} ms "
                f"({fwd_lib['bound_by']}), dq {r['dq_bound']['bound_ms']:.4f} ms "
                f"({r['dq_bound']['bound_by']}), dk/dv {r['dkv_bound']['bound_ms']:.4f} ms "
                f"({r['dkv_bound']['bound_by']})")
        if c["name"] == "gqa":
            kept = (kargs, ref)

    # broken copies of #3 and #2 on the GQA case (n_rep 4)
    kargs, ref = kept

    def check_dkv(got):
        errs = [(a.float() - r.float()).abs().max().item() / r.float().abs().max().item()
                for a, r in zip(got, ref[1:])]
        return max(errs) <= BWD_TOL, f"max|err| / max|plain| dk {errs[0]:.3e} dv {errs[1]:.3e}"

    def check_dq(got):
        err = (got.float() - ref[0].float()).abs().max().item() / \
            ref[0].float().abs().max().item()
        return err <= BWD_TOL, f"max|err| / max|plain| dq {err:.3e}"

    libs = variants.result()
    flash_faults_caught("[3b flash bwd]", {n: libs[n] for n in FLASH_DKV_FAULTS},
                        lambda: _kernel_bwd_dkv(*kargs), check_dkv)
    flash_faults_caught("[3b flash bwd]", {n: libs[n] for n in FLASH_DQ_FAULTS},
                        lambda: _kernel_bwd_dq(*kargs), check_dq)
    return res


def _head_inputs(g, M: int, H: int, V: int) -> tuple:
    """bf16 hidden rows ~N(0, 1) (the final RMSNorm's scale), the (V, H)
    head weight ~N(0, 0.02) (its init), labels and upstream gradients."""
    x = torch.randn(M, H, generator=g, device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn(V, H, generator=g, device="cuda")).to(torch.bfloat16)
    y = torch.randint(0, V, (M,), generator=g, device="cuda", dtype=torch.int32)
    gr = torch.randn(M, generator=g, device="cuda")
    return x, w, y, gr


def _grad_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max|got - ref|, the largest ratio of an entry's error to its 3c
    bound: within the bound at <= 1)."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    allowed = HEAD_GRAD_RTOL * ref.abs() + HEAD_GRAD_ATOL * ref.abs().max()
    ratio = (d / allowed).max().item() if bool(torch.isfinite(got).all()) else math.inf
    return d.max().item(), ratio


# 3c's bound on the dl kernel: within one bf16 rounding of the plain dl
# (the two sum x.w in other orders, so an entry near a rounding boundary
# can land on either side: one ulp, <= 2^-7 of its magnitude)
HEAD_DL_RTOL = 2 ** -7


def _dl_ratio(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(entries that differ, the largest ratio of an entry's difference to
    HEAD_DL_RTOL x its larger magnitude: one bf16 rounding apart at <= 1)."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    allowed = HEAD_DL_RTOL * torch.maximum(got.abs(), ref.abs())
    ratio = torch.where(d == 0, torch.zeros_like(d), d / allowed).max().item() \
        if bool(torch.isfinite(got).all()) else math.inf
    return int((d != 0).sum()), ratio


@contextlib.contextmanager
def _captured_dl():
    """The dl kernel's output of each vocabulary chunk, in order, as
    fused_head_bwd hands it to the dx kernel (the port's wrapper is patched
    for the block only)."""
    real, chunks = fh._kernel_dx, []

    def capture(dl, w, dx32, dx, c0, vw, mode):
        chunks.append(dl[:, :vw].clone())
        real(dl, w, dx32, dx, c0, vw, mode)

    fh._kernel_dx = capture
    try:
        yield chunks
    finally:
        fh._kernel_dx = real


def head_check(x, w, y, gr, backward: bool = True, fault: str = "", need_dw: bool = True,
               vc=None) -> dict:
    """The fused-head kernels against the plain versions on one input set,
    the backward through fused_head_bwd's chunk walk (vc forced if given):
    dx against the plain dx, the dl kernel within one bf16 rounding of the
    plain dl, and dW against dl^T x in fp32 from the kernel's own dl (a
    rounding flip in dl moves the plain dW by more than dW's bound where an
    entry's terms cancel; the plain dW is logged beside it).
    `fault` plants one error around the sound kernels (the probe): "g" drops
    the upstream gradient, "onehot" drops the label's one-hot, "lse" shifts
    the saved lse by 0.5, "ragged" leaves the ragged vocabulary tile
    unmasked (zero weight rows scored as real columns), "chunk" drops the
    second vocabulary chunk's dx product."""
    M, V = x.shape[0], w.shape[0]
    ref_logp, ref_lse = fused_head_fwd_plain(x, w, y)
    kx, kw, ky = x, w, y
    if fault == "ragged":
        kw = torch.cat([w, w.new_zeros((-V % 64, w.shape[1]))])
    if fault == "onehot":
        ky = torch.full_like(y, V + 7)  # a label no column matches
    logp, lse = _kernel_fwd(kx, kw, ky)
    out = {"logp_err": (logp - ref_logp).abs().max().item(),
           "lse_err": (lse - ref_lse).abs().max().item()}
    ok = out["logp_err"] <= HEAD_FWD_TOL and out["lse_err"] <= HEAD_FWD_TOL and \
        bool(torch.isfinite(logp).all())
    if backward:
        ref_dx, ref_dw = fused_head_bwd_plain(x, w, y, ref_lse, gr)
        klse = lse + 0.5 if fault == "lse" else lse
        kg = torch.ones_like(gr) if fault == "g" else gr
        with _dropped_dx_chunk(1) if fault == "chunk" else contextlib.nullcontext(), \
                _captured_dl() as chunks:
            dx, dw = fused_head_bwd(kx, kw, ky, klse, kg, need_dw=need_dw, vc=vc)
        dl = torch.cat(chunks, dim=1)[:, :V]
        out["dx_err"], out["dx_ratio"] = _grad_err(dx, ref_dx)
        out["dl_flips"], out["dl_ratio"] = _dl_ratio(dl, fh._dl_plain(x, w, y, ref_lse, gr, 0))
        ok = ok and out["dx_ratio"] <= 1 and out["dl_ratio"] <= 1
        if need_dw:
            own = torch.matmul(dl.float().T, x.float()).to(w.dtype)
            out["dw_err"], out["dw_ratio"] = _grad_err(dw[:V], own)
            out["dw_plain_ratio"] = _grad_err(dw[:V], ref_dw)[1]
            ok = ok and out["dw_ratio"] <= 1
    torch.cuda.synchronize()
    out["ok"] = ok
    return out


@contextlib.contextmanager
def _dropped_dx_chunk(index: int):
    """The probe's "chunk" fault: fused_head_bwd skips the dx product of its
    index-th vocabulary chunk (the port's wrapper is patched for the block
    only)."""
    real, calls = fh._kernel_dx, []

    def dropping(dl, w, dx32, dx, c0, vw, mode):
        calls.append(c0)
        if len(calls) != index + 1:
            real(dl, w, dx32, dx, c0, vw, mode)

    fh._kernel_dx = dropping
    try:
        yield
    finally:
        fh._kernel_dx = real


def _composite(x, w, y):
    """The library yardstick of the fused head: no single PyTorch call
    computes it, so two: F.linear then F.cross_entropy(reduction="none")
    (-logp), timed here only. Its autograd backward keeps the (M, V) logits
    from the forward, so it does two products where the fused head does
    three."""
    return -torch.nn.functional.cross_entropy(torch.nn.functional.linear(x, w),
                                              y.long(), reduction="none")


def _recompute_composite(x, w, y, lse, gr, vc: int, need_dw: bool = True):
    """The second yardstick of the fused head's backward, timed here only:
    the same products as PyTorch calls, per vocabulary chunk of vc columns
    F.linear for the scores, the dl formula in torch, then dl W_c and (with
    need_dw) dl^T x as torch.matmul (bf16 products, fp32 sums, bf16 out;
    dx's chunks summed in fp32)."""
    V = w.shape[0]
    dx, dw = None, torch.empty_like(w) if need_dw else None
    for c0 in range(0, V, vc):
        w_c = w[c0:c0 + vc]
        s = torch.nn.functional.linear(x, w_c).float()
        cols = torch.arange(c0, c0 + w_c.shape[0], device=x.device)
        dl = (gr[:, None] * ((y[:, None] == cols).float() - torch.exp(s - lse[:, None]))
              ).to(x.dtype)
        part = torch.matmul(dl, w_c).float()
        dx = part if dx is None else dx + part
        if need_dw:
            dw[c0:c0 + vc] = torch.matmul(dl.T, x)
    return dx.to(x.dtype), dw


# 3c: planted faults in the redesigned forward (#13/#14), each a broken copy
# of csrc/fused_head.cu that must break HEAD_FWD_TOL
HEAD_FWD_FAULTS = {
    "running sum not rescaled when the max rises": [(
        "fused_head.cu", "st.s[h] = st.s[h] * __expf(st.m[h] - m_new) + sum;",
        "st.s[h] = st.s[h] + sum;")],
    "target logit dropped after a split's first tile": [(
        "fused_head.cu", "epi_fwd(acc, p, n0, y0, y1, st);",
        "epi_fwd(acc, p, n0, t == t0 ? y0 : -1, t == t0 ? y1 : -1, st);")],
    "one ring stage reloads k-tile 0": [(
        "fused_head.cu", "const int k0 = kt * TK;", "const int k0 = (kt == 1 ? 0 : kt) * TK;")],
}


def head_cases(pair: dict) -> list:
    """3c's cases: the train step's head (M = 2 (L - 1) rows of the collated
    pair, H = 4096, V = 32000), the ref-logp plain fallback at batch_pairs 8
    (M = 16 x 1023, less 5 for a ragged row tile; forward only), the QLoRA
    step's frozen head (M = 16 x 1023 rows, dx only, four vocabulary chunks
    of 8192), the single-pass regime of TPU row 13 (H = 1024), ragged
    vocabularies (V = 32001 and 300) and many chunks with a ragged last one
    (the probe's shape at vc = 4096)."""
    M = 2 * (pair["batch_np"]["input_ids"].shape[1] - 1)
    return [
        dict(name="train step", M=M, H=4096, V=32000, backward=True, time_fwd=True,
             time_bwd=True),
        dict(name="ref-logp fallback", M=16 * 1023 - 5, H=4096, V=32000, backward=False,
             time_fwd=True),
        dict(name="QLoRA head (dx only)", M=16 * 1023, H=4096, V=32000, backward=True,
             need_dw=False, time_bwd=True),
        dict(name="small H (row 13)", M=M, H=1024, V=32000, backward=True, time_fwd=True,
             time_bwd=True),
        dict(name="ragged vocab", M=1000, H=4096, V=32001, backward=True),
        dict(name="tiny ragged", M=77, H=1024, V=300, backward=True),
        dict(name="many chunks", M=2046, H=1024, V=32001, backward=True, vc=PROBE_VC),
    ]


def _time_head_bwd(x, w, y, gr, need_dw: bool) -> dict:
    """Times of the backward at one shape, beside the bounds and the two
    yardsticks: dl + dx (the kernels on preallocated buffers; the whole
    chunk walk when there is more than one chunk), dW given dl (one
    product; one chunk only), the whole fused_head_bwd call (wrapper
    included), the plain backward, the composite's autograd backward and
    the recompute composite."""
    M, H = x.shape
    V = w.shape[0]
    flop = 2 * M * H * V
    _, lse = _kernel_fwd(x, w, y)
    vc = chunk_width(M, V)
    if need_dw and vc < V:
        raise ValueError("3c times dW given dl at one vocabulary chunk")
    stats = _nbytes(x, w, y, lse, gr)
    t = {}
    if vc >= V:  # one chunk: the two kernels alone
        dl, dx = x.new_empty((M, vc)), torch.empty_like(x)
        t["dx"] = time_ms(lambda: (_kernel_dl(x, w, y, lse, gr, dl, 0, V),
                                   _kernel_dx(dl, w, None, dx, 0, V, FIRST | LAST)))
    else:
        t["dx"] = time_ms(lambda: fused_head_bwd(x, w, y, lse, gr, need_dw=False), 5)
    out = {"dx": dict(ms=t["dx"], **bound(2 * flop, stats + _nbytes(x)))}
    if need_dw:
        dw = torch.empty_like(w)
        t["dw"] = time_ms(lambda: _kernel_dw(dl, x, dw, V))
        out["dw"] = dict(ms=t["dw"], **bound(flop, _nbytes(dl[:, :V], x, w)))
        t["bwd"] = time_ms(lambda: fused_head_bwd(x, w, y, lse, gr))
        out["bwd"] = dict(ms=t["bwd"], **bound(3 * flop, stats + _nbytes(x, w)))
    runs = 10 if M <= 4096 else 3
    t["plain"] = time_ms(lambda: fused_head_bwd_plain(x, w, y, lse, gr), runs)
    xl = x.detach().clone().requires_grad_(True)
    wl = w.detach().clone().requires_grad_(need_dw)
    lib = _composite(xl, wl, y)
    grads = (xl, wl) if need_dw else (xl,)
    t["library"] = time_ms(lambda: torch.autograd.grad(lib, grads, gr, retain_graph=True),
                           runs)
    t["recompute"] = time_ms(lambda: _recompute_composite(x, w, y, lse, gr, vc, need_dw),
                             runs)
    for row in out.values():
        row.update(plain_ms=t["plain"], library_ms=t["library"],
                   recompute_ms=t["recompute"])
    return out


def phase_head(g, pair: dict) -> dict:
    """3c: the fused-head kernels (forward, dl, dx, dW) against the plain
    versions, their times beside the bounds and the library yardsticks,
    then the planted-fault probe."""
    res = {"fwd_err": 0.0, "dx_err": 0.0, "dw_err": 0.0}
    for c in head_cases(pair):
        M, H, V = c["M"], c["H"], c["V"]
        need_dw = c.get("need_dw", True)
        x, w, y, gr = _head_inputs(g, M, H, V)
        r = head_check(x, w, y, gr, backward=c["backward"], need_dw=need_dw,
                       vc=c.get("vc"))
        msg = (f"[3c fused head] {c['name']}: M={M} H={H} V={V} vc="
               f"{c.get('vc') or chunk_width(M, V)} | max|logp err| {r['logp_err']:.3e} "
               f"max|lse err| {r['lse_err']:.3e} (tol {HEAD_FWD_TOL})")
        if c["backward"]:
            msg += (f" | max|dx err| {r['dx_err']:.3e}"
                    + (f", dW against dl^T x from the kernel's dl max|err| {r['dw_err']:.3e}"
                       if need_dw else " (no dW)")
                    + f" (tol {HEAD_GRAD_RTOL:.4f} x |ref| + {HEAD_GRAD_ATOL} x "
                    f"max|ref|; worst entry at {r['dx_ratio']:.3f}"
                    + (f" / {r['dw_ratio']:.3f}" if need_dw else "") + " of it"
                    + (f"; dW against the plain dW at {r['dw_plain_ratio']:.3f}, not a gate"
                       if need_dw else "")
                    + f") | dl: {r['dl_flips']} of {M * V} entries one rounding off the "
                    f"plain dl, worst at {r['dl_ratio']:.3f} of one bf16 rounding")
        res["fwd_err"] = max(res["fwd_err"], r["logp_err"], r["lse_err"])
        res["dx_err"] = max(res["dx_err"], r.get("dx_err", 0.0))
        res["dw_err"] = max(res["dw_err"], r.get("dw_err", 0.0))
        if c.get("time_bwd"):
            flop = 2 * M * H * V
            tb = _time_head_bwd(x, w, y, gr, need_dw)
            res.setdefault("bwd", {})[c["name"]] = tb
            d = tb["dx"]
            msg += (f" | dl + dx {d['ms']:.3f} ms = {2 * flop / (d['ms'] * 1e-3) / 1e12:.1f} "
                    f"TFLOP/s (bound {d['bound_ms']:.3f} ms)")
            if need_dw:
                dw_t, b = tb["dw"], tb["bwd"]
                msg += (f", dW given dl {dw_t['ms']:.3f} ms = "
                        f"{flop / (dw_t['ms'] * 1e-3) / 1e12:.1f} TFLOP/s (bound "
                        f"{dw_t['bound_ms']:.3f} ms), whole fused_head_bwd {b['ms']:.3f} ms = "
                        f"{3 * flop / (b['ms'] * 1e-3) / 1e12:.1f} TFLOP/s (3-product bound "
                        f"{b['bound_ms']:.3f} ms, {b['bound_ms'] / b['ms']:.1%} of it)")
            msg += (f" | plain backward {d['plain_ms']:.3f} ms, composite's autograd "
                    f"backward {d['library_ms']:.3f} ms (two products: it keeps the "
                    f"logits), recompute composite {d['recompute_ms']:.3f} ms (three "
                    f"products in torch)")
        if c.get("time_fwd"):
            runs = 10 if M > 4096 else 20
            flop = 2 * M * H * V
            t_f = time_ms(lambda: _kernel_fwd(x, w, y), runs)
            t_fp = time_ms(lambda: fused_head_fwd_plain(x, w, y), runs)
            t_fl = time_ms(lambda: _composite(x, w, y), runs)
            b_f = bound(flop, _nbytes(x, w, y) + 8 * M)
            launched = launched_ops(lambda: _kernel_fwd(x, w, y))
            nsplit = fwd_splits(M, V, torch.cuda.get_device_properties(0).multi_processor_count)
            msg += (f" | fwd kernel {t_f:.3f} ms = {flop / (t_f * 1e-3) / 1e12:.1f} "
                    f"TFLOP/s, plain {t_fp:.3f} ms, library composite (F.linear + "
                    f"F.cross_entropy) {t_fl:.3f} ms, bound {b_f['bound_ms']:.3f} ms "
                    f"({b_f['bound_by']}) | one forward call captured in a CUDA graph: "
                    f"{ops_text(launched)}; 2 kernels planned ({nsplit} vocabulary splits "
                    f"of 128-row CTAs, then the combine)")
            r["ok"] = r["ok"] and launched.get("kernel", 0) == 2 and len(launched) == 1
            res.setdefault("fwd", {})[c["name"]] = dict(
                ms=t_f, plain_ms=t_fp, library_ms=t_fl, kernels_a_call=launched.get("kernel", 0),
                **b_f)
        log(msg + f" | {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            raise AssertionError(f"fused head kernels disagree with the plain versions: "
                                 f"{c['name']}")
        del x, w, y, gr
        torch.cuda.empty_cache()

    # the probe: each planted fault must break the bounds above; "chunk"
    # walks PROBE_VC-wide chunks (the "many chunks" case above passes there)
    x, w, y, gr = _head_inputs(g, 2046, 1024, 32001)
    for fault in ("g", "onehot", "lse", "ragged", "chunk"):
        r = head_check(x, w, y, gr, fault=fault, vc=PROBE_VC if fault == "chunk" else None)
        log(f"[3c fused head] planted fault {fault!r} (M=2046 H=1024 V=32001"
            f"{f' vc={PROBE_VC}' if fault == 'chunk' else ''}): max|logp err| "
            f"{r['logp_err']:.3e} max|lse err| {r['lse_err']:.3e} max|dx err| "
            f"{r['dx_err']:.3e} max|dW err| {r['dw_err']:.3e} (worst entry at "
            f"{r['dx_ratio']:.3g} / {r['dw_ratio']:.3g} of its bound; dl at "
            f"{r['dl_ratio']:.3g} of one rounding) | "
            f"{'caught' if not r['ok'] else 'MISSED'}")
        if r["ok"]:
            raise AssertionError(f"the 3c bounds miss the planted fault {fault!r}")
    # broken copies of the forward kernel (build_variants) on the same inputs
    t0 = time.perf_counter()
    libs = build_variants(HEAD_FWD_FAULTS)
    log(f"[3c fused head] forward planted faults: {len(libs)} broken variants built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        with kernels_from(lib):
            r = head_check(x, w, y, gr, backward=False)
        log(f"[3c fused head] planted fault {name!r} (M=2046 H=1024 V=32001, "
            f"{fwd_splits(2046, 32001, torch.cuda.get_device_properties(0).multi_processor_count)}"
            f" splits): max|logp err| {r['logp_err']:.3e} max|lse err| {r['lse_err']:.3e} "
            f"(tol {HEAD_FWD_TOL}) | {'caught' if not r['ok'] else 'MISSED'}")
        if r["ok"]:
            raise AssertionError(f"the 3c bounds miss the planted fault {name!r}")
    return res


def _items(image_bytes: bytes, questions):
    return [{"question": q, "question_id": i, "image_bytes": image_bytes,
             "metainfos": {"ds_question_id": f"smoke{i}"}}
            for i, q in enumerate(questions)]


FACTS = [f"Is there a {w} in the image? Please answer yes or no." for w in
         ("dog", "cat", "car", "tree", "person", "bicycle", "cup", "clock")]


def phase_slice(gen: Llava15Generator, image_bytes: bytes, tag: str = "4 slice",
                decode: str = "decode", per_step: int = 0) -> tuple:
    """autocheck of 8 facts, diverse_gen 10 x 64 (one batch) and greedy_gen
    4 x 32, with every launch counter reset just before and read just after
    -> (launches, rates). `decode` names the decode kernel of the path, which
    launches `per_step` times a decode step (default: once a layer)."""
    facts = _items(image_bytes, FACTS)
    diverse = _items(image_bytes, ["Describe the image in detail."] * 10)
    greedy = _items(image_bytes, ["What is in the image?", "Describe the scene.",
                                  "What colors do you see?", "Is it daytime?"])
    # warm-up (cuBLAS handles, allocator) outside the counted run
    gen.autocheck(facts[:2], batch_size=8)
    gen.diverse_gen(diverse[:2], max_new_tokens=2)
    torch.cuda.synchronize()

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scored = gen.autocheck(facts, batch_size=8)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    owner, attr = COUNTERS[decode]
    steps0 = getattr(owner, attr)
    sampled = gen.diverse_gen(diverse, temperature=0.7, max_new_tokens=64, seed=0,
                              batch_size=len(diverse))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    steps1 = getattr(owner, attr)
    greedy_rows = gen.greedy_gen(greedy, max_new_tokens=32)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    assert len(scored) == 8 and all(
        0.0 <= p <= 1.0 for r in scored for p in r["scores"].values())
    assert len(sampled) == 10 and len(greedy_rows) == 4
    assert all(isinstance(r["answer"], str) for r in sampled + greedy_rows)
    n_layers = gen.model.cfg.llm.num_layers
    per_step = per_step or n_layers
    log(f"[{tag}] launches during the slice: " + ", ".join(
        f"{k} {v}" for k, v in launches.items() if v))
    if launches["flash"] < n_layers or launches[decode] < per_step:
        raise AssertionError(f"a kernel of the path did not run: {launches}")
    # tokens sampled = rows x (decode steps + the first token, which comes
    # from the prefill logits)
    n_div = 10 * ((steps1 - steps0) // per_step + 1)
    n_greedy = 4 * ((launches[decode] - steps1) // per_step + 1)
    rates = dict(facts_s=8 / (t1 - t0), diverse_tok_s=n_div / (t2 - t1),
                 greedy_tok_s=n_greedy / (t3 - t2), peak_gb=peak_gb)
    log(f"[{tag}] autocheck 8 facts in {t1 - t0:.3f} s = {rates['facts_s']:.2f} facts/s "
        f"(p(yes) row 0 = {scored[0]['scores']['yes']:.3e})")
    log(f"[{tag}] diverse_gen 10 rows, {n_div} tokens in {t2 - t1:.3f} s = "
        f"{rates['diverse_tok_s']:.1f} tok/s (prefill and vision encode included)")
    log(f"[{tag}] greedy_gen 4 rows, {n_greedy} tokens in {t3 - t2:.3f} s = "
        f"{rates['greedy_tok_s']:.1f} tok/s (prefill and vision encode included)")
    log(f"[{tag}] peak device memory {peak_gb:.2f} GiB")
    return launches, rates


def phase_slice_vs_plain(gen: Llava15Generator, image_bytes: bytes) -> None:
    facts = _items(image_bytes, FACTS)
    prompts, starts, images = gen._prepare(facts)
    P = int(starts[0]) + gen.num_patches
    attn = [m for m in gen.model.modules() if isinstance(m, LlamaAttention)]

    def score(impl):
        for m in attn:
            m.attn_impl = impl
        return torch.from_numpy(gen.engine.score_shared_prefix(
            prompts[0][:P], [p[P:] for p in prompts], image=images[0],
            image_start=int(starts[0]), batch_size=8))

    fast, plain = score("auto"), score("dense")
    for m in attn:
        m.attn_impl = "auto"
    assert fast.shape == plain.shape == (8, gen.engine.vocab_size)
    assert torch.isfinite(fast).all() and torch.isfinite(plain).all()
    d_logit = (fast - plain).abs().max().item()
    scale = plain.abs().max().item()
    yes = yesno_token_ids(gen.tokenizer)["yes"]
    d_prob = (fast.double().softmax(-1)[:, yes]
              - plain.double().softmax(-1)[:, yes]).abs().max().item()
    ok = d_logit <= SLICE_REL_TOL * scale and d_prob <= PROB_TOL
    log(f"[5 slice vs plain] shared-prefix logits, flash vs dense attention: "
        f"max|dlogit| {d_logit:.4f} vs max|logit| {scale:.3f} (tol "
        f"{SLICE_REL_TOL} x max) | max|dp(yes)| {d_prob:.3e} (tol {PROB_TOL}) | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("slice disagrees with its plain path")


class BeamMeter:
    """Wraps genai/beam.py's beam_start, beam_step and reorder_rows (module
    attributes, which beam_search looks up at each call) inside a `with`:
    each step's wall ms (a step holds the loop's one sync), the steps that
    called the model, each reorder's device ms (CUDA events around it
    alone) and rows copied, and for the first `record` steps the (parent,
    tok) host arrays and the log-probs, with the first tokens and the
    prefill's log-probs of the first call."""

    def __init__(self, record: int = 0):
        self.record = record
        self.step_ms, self.model_steps, self.events, self.rows_copied = [], 0, [], []
        self.first = self.logp0 = None
        self.forced, self.logps = [], []

    def __enter__(self):
        self._saved = start, step, reorder = (beam_mod.beam_start, beam_mod.beam_step,
                                              beam_mod.reorder_rows)

        def metered_start(*a, **k):
            state, first, logp0 = start(*a, **k)
            if self.first is None:
                self.first, self.logp0 = first.copy(), logp0.clone()
            return state, first, logp0

        def metered_step(*a, **k):
            t0 = time.perf_counter()
            parent, tok, logp = step(*a, **k)
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            if logp is not None:
                self.model_steps += 1
                if len(self.forced) < self.record:
                    self.forced.append((parent.copy(), tok.copy()))
                    self.logps.append(logp.clone())
            return parent, tok, logp

        def timed_reorder(*a, **k):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            n = reorder(*a, **k)
            e1.record()
            self.events.append((e0, e1))
            self.rows_copied.append(n)
            return n

        beam_mod.beam_start, beam_mod.beam_step, beam_mod.reorder_rows = (
            metered_start, metered_step, timed_reorder)
        return self

    def __exit__(self, *exc):
        beam_mod.beam_start, beam_mod.beam_step, beam_mod.reorder_rows = self._saved

    def reorder_ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def _eval_rows(image_bytes: bytes, questions) -> list:
    """Benchmark rows as evals/vqa.py reads them (image bytes inline)."""
    return [{"question_id": i, "question": q, "image_bytes": image_bytes,
             "metainfos": {"ds_question_id": f"eval{i}"}} for i, q in enumerate(questions)]


def _synthetic_coco(d: str, n: int) -> str:
    """A COCO val2014 layout of n images: instance labels from six COCO
    classes (numpy seed 14) and one caption each; Object HalBench's ground
    truth reads both."""
    names = ["person", "dog", "cat", "car", "chair", "dining table"]
    rng = np.random.default_rng(14)
    os.makedirs(d, exist_ok=True)
    labels = {i: sorted(set(rng.integers(1, len(names) + 1, 2).tolist())) for i in range(n)}
    with open(os.path.join(d, "instances_val2014.json"), "w") as f:
        json.dump({"categories": [{"id": i + 1, "name": x} for i, x in enumerate(names)],
                   "annotations": [{"image_id": i, "category_id": c}
                                   for i, cs in labels.items() for c in cs]}, f)
    with open(os.path.join(d, "captions_val2014.json"), "w") as f:
        json.dump({"annotations": [{"image_id": i, "caption": f"A {names[labels[i][0] - 1]}."}
                                   for i in range(n)]}, f)
    return d


def _stub_judge(model, messages, **kw):
    """The judge's transport on a machine with no network: a fixed reply
    per prompt (a rating for MMHal, a verdict for RefoMB's two passes)."""
    import zlib

    h = zlib.crc32(messages[-1]["content"].encode())
    return f"Stub review. Rating: {h % 7}, stub. [[{'ABC'[h % 3]}]]", {"total_tokens": 0}


def phase_eval_scorers(answers: list) -> None:
    """14: evals.run_eval's three benchmarks on the beam answers, each
    tiled to its benchmark's cardinality: Object HalBench without GPT
    against a synthetic COCO directory, MMHal and RefoMB judged through a
    stub transport; each writes its files and prints its summary."""
    import tempfile

    from rlaifv_tpu_torch.evals.mmhal import NUM_QUESTIONS
    from rlaifv_tpu_torch.evals.refomb import load_dev_set

    n_obj, n_ref = 300, len(load_dev_set())
    saved = gpt_client.openai_http_transport
    gpt_client.openai_http_transport = lambda **kw: _stub_judge
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "objhal_answers.jsonl")
            write_jsonlines(path, [{"question_id": i, "image_id": i,
                                    "prompt": answers[i % len(answers)]["prompt"],
                                    "text": answers[i % len(answers)]["text"]}
                                   for i in range(n_obj)])
            out = run_eval.eval_objhal(path, _synthetic_coco(os.path.join(tmp, "coco"), n_obj),
                                       os.path.join(tmp, "objhal"), use_gpt=False)
            with open(out) as f:
                om = json.load(f)["overall_metrics"]
            assert om["sentence_num"] == n_obj, om
            log(f"[14 eval] Object HalBench (no GPT, synthetic COCO of {n_obj} images, the "
                f"{len(answers)} answers tiled): CHAIRs {om['CHAIRs']:.4f} CHAIRi "
                f"{om['CHAIRi']:.4f} -> {os.path.basename(out)}")
            path = os.path.join(tmp, "mmhal_answers.json")
            with open(path, "w") as f:
                json.dump([{"question_id": i, "text": answers[i % len(answers)]["text"]}
                           for i in range(NUM_QUESTIONS)], f)
            summary = run_eval.eval_mmhal(path, os.path.join(tmp, "mmhal"))
            assert os.path.exists(os.path.join(tmp, "mmhal", "mmhal_review.json"))
            log(f"[14 eval] MMHal ({NUM_QUESTIONS} answers, stub judge): average score "
                f"{summary['average_score']:.3f}, hallucination rate "
                f"{summary['hallucination_rate']:.3f} -> mmhal_review.json")
            path = os.path.join(tmp, "refomb_answers.jsonl")
            write_jsonlines(path, [{"question_id": i, "text": answers[i % len(answers)]["text"]}
                                   for i in range(n_ref)])
            summary = run_eval.eval_refomb(path, os.path.join(tmp, "refomb"))
            written = sorted(os.listdir(os.path.join(tmp, "refomb")))
            assert written == ["refomb_reviews.hall.jsonl", "refomb_reviews.jsonl"], written
            log(f"[14 eval] RefoMB ({n_ref} answers, stub judge, both passes): "
                f"{summary['pairwise']['total']} pairwise verdicts, hallucination score "
                f"{summary['hallucination']['hallucination_score']:.3f} -> {', '.join(written)}")
    finally:
        gpt_client.openai_http_transport = saved


def _eval_step_device_ms(eng: DecodeEngine, prompts, starts, images, valid: int) -> float:
    """Device ms of one model step of the beam batch (B x K rows) at the
    eval cache width, the live prefix `valid` columns: the step captured
    once in a CUDA graph and its replays timed (time_ms), so the host's
    launch time is kept out."""
    Lp, ids, mask, starts = _padded(eng, prompts, starts)
    max_len = -(-(Lp + EVAL_NEW) // 128) * 128
    with torch.inference_mode():
        _, cache, cmask = eng._prefill(ids, mask, eng._device_images(images), starts, max_len,
                                       beams=EVAL_BEAMS)
        cmask[:, Lp:valid] = 1
        tok = torch.full((cmask.shape[0],), 5, dtype=torch.long, device="cuda")
        pos = mask.sum(dim=1).repeat_interleave(EVAL_BEAMS) + valid - 1 - Lp
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the capture
            eng._step(tok, cmask, pos, cache, valid - 1)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            eng._step(tok, cmask, pos, cache, valid - 1)
        ms = time_ms(graph.replay)
    del graph, cache
    torch.cuda.empty_cache()
    return ms


def _eval_decode_case(B: int, L: int, valid: int) -> dict:
    """Kernel #4 at the beam step's shape (phase 3's checks and timings, a
    generator of its own, seed 14): B x K rows, the eval cache width, the
    live prefix half way through the run."""
    gp = torch.Generator(device="cuda").manual_seed(14)
    H, D = 32, 128
    q, k, v = _randn(gp, B, H, D), _randn(gp, B, L, H, D), _randn(gp, B, L, H, D)
    mask = torch.zeros((B, L), dtype=torch.int32, device="cuda")
    mask[:, 7:valid] = 1
    return dict(_prefix_case("phase 14 beam step", q, k, v, mask, valid, timed=True),
                B=B, L=L, valid=valid)


def phase_eval(gen: Llava15Generator, image_bytes: bytes) -> tuple:
    """14: evals.vqa.generate_answers over 8 rows in one batch with 3 beams
    -> (launches of that run, the beam-shape #4 case)."""
    eng, n_layers = gen.engine, gen.model.cfg.llm.num_layers
    rows = _eval_rows(image_bytes, EVAL_QUESTIONS[:EVAL_ROWS])
    generate_answers(gen, rows[:2], max_new_tokens=2, batch_size=2, num_beams=EVAL_BEAMS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with BeamMeter(record=EVAL_REPLAY_STEPS) as meter:
        reset_counts()
        t0 = time.perf_counter()
        answers = generate_answers(gen, rows, max_new_tokens=EVAL_NEW, batch_size=EVAL_ROWS,
                                   num_beams=EVAL_BEAMS, model_id="random-llava15-7b")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    assert len(answers) == EVAL_ROWS and all(isinstance(a["text"], str) for a in answers)
    assert [a["question_id"] for a in answers] == list(range(EVAL_ROWS))
    steps = meter.model_steps
    log(f"[14 eval] launches during generate_answers ({EVAL_ROWS} rows, {EVAL_BEAMS} beams, "
        f"{EVAL_NEW} new tokens, one batch): " + ", ".join(
            f"{k} {v}" for k, v in launches.items() if v))
    if launches["flash"] < n_layers or launches["decode"] != n_layers * steps or \
            launches["decode_int8"] or steps < 1:
        raise AssertionError(f"14: the beam path's kernels did not run as planned "
                             f"({steps} model steps): {launches}")
    prompts, starts, images = gen._prepare(rows)
    Lp = -(-max(len(p) for p in prompts) // 64) * 64
    reorder = meter.reorder_ms()
    step_ms = statistics.median(meter.step_ms)
    reorder_ms = statistics.mean(reorder) if reorder else 0.0
    rows_copied = statistics.mean(meter.rows_copied) if meter.rows_copied else 0.0
    log(f"[14 eval] {EVAL_ROWS} x {EVAL_BEAMS} beams, prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens (Lp {Lp}, max_len "
        f"{-(-(Lp + EVAL_NEW) // 128) * 128}): {steps} beam steps in {wall:.3f} s = "
        f"{EVAL_ROWS * (steps + 1) / wall:.1f} tok/s of the best beams "
        f"({EVAL_ROWS * EVAL_BEAMS * (steps + 1) / wall:.1f} beam tok/s; prefill and vision "
        f"encode included); beam step {step_ms:.2f} ms (median wall, its one sync included); "
        f"reorder {reorder_ms:.3f} ms a step on the device (CUDA events around it alone; mean "
        f"{rows_copied:.1f} of {EVAL_ROWS * EVAL_BEAMS} rows copied, live columns only); "
        f"peak {peak_gb:.2f} GiB")
    valid = Lp + EVAL_NEW // 2
    step_dev = _eval_step_device_ms(eng, prompts, starts, images, valid)
    beam4 = _eval_decode_case(EVAL_ROWS * EVAL_BEAMS, -(-(Lp + EVAL_NEW) // 128) * 128, valid)
    log(f"[14 eval] beam step breakdown at valid_len {valid}: wall {step_ms:.2f} ms = the "
        f"model step's device time {step_dev:.2f} ms (a CUDA graph of the step; #4 {n_layers} x "
        f"{beam4['ms']:.4f} = {n_layers * beam4['ms']:.2f} ms of it, the weights' byte bound "
        f"{_weight_bytes(gen.model.llm) / (HBM_PEAK_GBPS * 1e9) * 1e3:.2f} ms) + reorder "
        f"{reorder_ms:.3f} ms + the rest (host: launches, the pick, the sync) "
        f"{step_ms - step_dev - reorder_ms:.2f} ms")

    # K = 1 against greedy decoding on the same rows
    with torch.inference_mode():
        one = eng.generate_beam(prompts, images=images, image_starts=starts, num_beams=1,
                                max_new_tokens=EVAL_NEW)
        greedy = eng.generate(prompts, images=images, image_starts=starts,
                              max_new_tokens=EVAL_NEW)
    same = np.array_equal(one.tokens, greedy.tokens) and np.array_equal(one.lengths,
                                                                        greedy.lengths)
    log(f"[14 eval] generate_beam(num_beams=1) against generate (greedy), {EVAL_ROWS} rows x "
        f"{EVAL_NEW} tokens: {'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("14: one beam is not greedy decoding")
    phase_eval_replay(gen, prompts, starts, images, meter)
    phase_eval_scorers(answers)
    return launches, beam4


def _weight_bytes(llm) -> int:
    """Bytes of the LLM's weights one decode step reads (every parameter
    and buffer but the token embedding, of which a step reads B rows)."""
    emb = llm.model.tok_embed.weight
    total = sum(t.numel() * t.element_size() for t in [*llm.parameters(), *llm.buffers()])
    return total - emb.numel() * emb.element_size()


def phase_eval_replay(gen: Llava15Generator, prompts, starts, images, meter: BeamMeter) -> None:
    """14: the kernel run's first tokens and the parents and tokens of its
    first EVAL_REPLAY_STEPS steps, replayed through beam_step with every
    attention on the dense route: the prefill's and each step's log-probs
    against the kernel run's, within phase 5's bound."""
    eng = gen.engine
    attn = [m for m in gen.model.modules() if isinstance(m, LlamaAttention)]
    Lp, ids, mask, starts = _padded(eng, prompts, starts)
    max_len = -(-(Lp + EVAL_NEW) // 128) * 128
    gaps = []

    def gap(got, ref):
        d, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        gaps.append((d, scale))

    for m in attn:
        m.attn_impl = "dense"
    try:
        with torch.inference_mode():
            first, cache, cmask = eng._prefill(ids, mask, eng._device_images(images), starts,
                                               max_len, beams=EVAL_BEAMS)
            state, _, logp0 = beam_mod.beam_start(
                first, cache, cmask, mask.sum(dim=1).repeat_interleave(EVAL_BEAMS),
                num_beams=EVAL_BEAMS, eos_id=eng.eos_id)
            gap(meter.logp0, logp0)
            state.last_tok = torch.from_numpy(meter.first).cuda()
            state.done = state.last_tok == eng.eos_id
            for t, (forced, kernel) in enumerate(zip(meter.forced, meter.logps), start=1):
                _, _, logp = beam_mod.beam_step(eng._step, state, t, Lp=Lp, eos_id=eng.eos_id,
                                                pad_id=eng.pad_id, forced=forced)
                gap(kernel, logp)
            del cache, state
    finally:
        for m in attn:
            m.attn_impl = "auto"
    ok = len(gaps) == 1 + EVAL_REPLAY_STEPS and all(d <= SLICE_REL_TOL * sc for d, sc in gaps)
    log(f"[14 eval] replay on the dense route (the prefill, then the recorded parents and "
        f"tokens of {len(gaps) - 1} steps): max|dlogp| / max|logp| " + ", ".join(
            f"{d / sc:.4f}" for d, sc in gaps) + f" (tol {SLICE_REL_TOL}, phase 5's) | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("14: the beam path disagrees with its dense route")


def phase_kv8_beam(gen: Llava15Generator, image_bytes: bytes) -> dict:
    """11: one beam batch on the int8-KV model (KV8_BEAM_ROWS rows, 3 beams,
    KV8_BEAM_NEW new tokens): kernel #5 on every beam step, no #4 ->
    its launches."""
    n_layers = gen.model.cfg.llm.num_layers
    items = _items(image_bytes, EVAL_QUESTIONS[:KV8_BEAM_ROWS])
    gen.greedy_gen(items[:1], max_new_tokens=2, num_beams=EVAL_BEAMS)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with BeamMeter() as meter:
        reset_counts()
        t0 = time.perf_counter()
        rows = gen.greedy_gen(items, max_new_tokens=KV8_BEAM_NEW, batch_size=KV8_BEAM_ROWS,
                              num_beams=EVAL_BEAMS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    steps = meter.model_steps
    assert len(rows) == KV8_BEAM_ROWS and all(isinstance(r["answer"], str) for r in rows)
    log(f"[11 int8-kv beam] {KV8_BEAM_ROWS} rows x {EVAL_BEAMS} beams, {KV8_BEAM_NEW} new "
        f"tokens: {steps} beam steps in {wall:.3f} s, beam step {statistics.median(meter.step_ms):.2f} "
        f"ms (median wall), reorder {statistics.mean(meter.reorder_ms() or [0.0]):.3f} ms a step "
        f"on the device; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches: "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    if launches["decode"] or launches["decode_int8"] != n_layers * steps or steps < 1:
        raise AssertionError(f"11: the int8-KV beam batch missed kernel #5: {launches}")
    return launches


def _kv8_cache(g, B: int, L: int, H: int, KVH: int, D: int, valid_len: int,
               pad: int = 7) -> list:
    """Kernel #5's operands: bf16 q, a quantised random cache whose scales
    past the last live block are NaN (never read), and a mask with `pad` x b
    columns of left padding in row b, live up to valid_len."""
    q = _randn(g, B, H, D)
    kq, ks = quantize_kv(_randn(g, B, L, KVH, D))
    vq, vs = quantize_kv(_randn(g, B, L, KVH, D))
    end = -(-valid_len // prefix_block_l(L)) * prefix_block_l(L)
    ks[:, end:] = float("nan")
    vs[:, end:] = float("nan")
    mask = torch.zeros((B, L), dtype=torch.int32, device="cuda")
    for b in range(B):
        mask[b, pad * b:valid_len] = 1
    return [q, kq, ks, vq, vs, mask]


def _kv8_ratio(out: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max|out - ref|, that error over 3f's bound KV8_TOL x max|ref|)."""
    err = (out.float() - ref.float()).abs().max().item()
    if not bool(torch.isfinite(out.float()).all()):
        return math.inf, math.inf
    return err, err / (KV8_TOL * ref.float().abs().max().item())


KV8_CASES = [  # 3f: the serving path's shapes, then the edges
    dict(name="diverse_gen", B=10, L=896, H=32, KVH=32, D=128, valid=896, time=True),
    # the int8 Llama3-8B backend's GQA decode step (phase 13), from a
    # generator of its own: the shared one keeps giving 3g its inputs
    dict(name="Llama3 GQA", B=8, L=2304, H=32, KVH=8, D=128, valid=2200, time=True, own=True),
    dict(name="greedy_gen", B=4, L=896, H=32, KVH=32, D=128, valid=833, time=False),
    dict(name="batch-24 headline", B=24, L=1024, H=32, KVH=32, D=128, valid=960, time=True),
    dict(name="one live column", B=4, L=1024, H=32, KVH=32, D=128, valid=1, time=False),
    dict(name="mid-block", B=4, L=1024, H=32, KVH=32, D=128, valid=200, time=False),
    dict(name="block edge", B=4, L=1024, H=32, KVH=32, D=128, valid=256, time=False),
    dict(name="block 128, n_rep 4", B=3, L=384, H=32, KVH=8, D=128, valid=300, time=False),
    dict(name="D 64", B=2, L=512, H=8, KVH=8, D=64, valid=137, time=False),
]


def kv8_splits(B: int, L: int, H: int, KVH: int, valid: int) -> int:
    """The key splits kernel #5 takes on this card (prefix_int8_plan)."""
    return prefix_int8_plan(B, KVH, max(-(-valid // prefix_block_l(L)), 1), qm._sms(0), H // KVH)


# 3f: planted faults in #5's merge, each a broken copy of
# csrc/decode_attention_int8.cu run on the Llama3 GQA case (4 key splits on
# 132 SMs)
KV8_MERGE_FAULTS = {
    "one split's state left out of the merge": [(
        "decode_attention_int8.cu", "  for (int si = 0; si < splits; ++si) {",
        "  for (int si = 0; si < splits - 1; ++si) {")],
    "the splits merged without rescaling to the common max": [(
        "decode_attention_int8.cu", "    const float w = expf(__fsub_rn(ps[D], mx));",
        "    const float w = 1.f;")],
}


def phase_kv8_kernel(g) -> dict:
    """3f: kernel #5 against its split twin (at the key splits the card's
    plan gives) at the serving path's shapes, the int8 Llama3 backend's and
    the edges, the kernels one call launched (a CUDA graph of the call),
    times beside the bound and the library yardstick, then planted faults
    (four around the kernel, two broken merges) that must break the bound."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(1)
    merge_variants = pool.submit(build_variants, KV8_MERGE_FAULTS)
    own = torch.Generator(device="cuda").manual_seed(5)
    res = {"err": 0.0}
    for c in KV8_CASES:
        B, L, H, KVH, D, valid = (c[k] for k in ("B", "L", "H", "KVH", "D", "valid"))
        args = _kv8_cache(own if c.get("own") else g, B, L, H, KVH, D, valid)
        splits = kv8_splits(B, L, H, KVH, valid)
        out = decode_attention_prefix_int8(*args, valid)
        again = decode_attention_prefix_int8(*args, valid)
        ref = decode_attention_prefix_int8_split_ref(*args, valid, splits)
        torch.cuda.synchronize()
        err, ratio = _kv8_ratio(out, ref)
        dead = [b for b in range(B) if 7 * b >= valid]  # rows that see no key
        launched = launched_ops(lambda: decode_attention_prefix_int8(*args, valid))
        ok = ratio <= 1 and all(bool((out[b] == 0).all()) for b in dead) and \
            torch.equal(again, out) and launched.get("kernel", 0) == 1 + (splits > 1)
        msg = (f"[3f int8 decode] {c['name']}: B={B} L={L} H={H} KVH={KVH} D={D} "
               f"valid_len={valid} block_l={prefix_block_l(L)}, {splits} key splits; one call "
               f"captured in a CUDA graph: {ops_text(launched)} | max|err| against the split "
               f"twin {err:.3e} = {ratio:.3f} of the bound ({KV8_TOL:.4f} x max|twin|), rerun "
               f"equal {torch.equal(again, out)}, {len(dead)} fully masked rows")
        if c["time"]:
            q, kq, ks, vq, vs, mask = args
            t_k = time_ms(lambda: decode_attention_prefix_int8(*args, valid))
            t_p = time_ms(lambda: decode_attention_prefix_int8_ref(*args, valid), 10)
            live = [t[:, :valid] for t in (kq, ks, vq, vs, mask)]
            kd, vd = (dequantize_kv(a, sc, torch.bfloat16).repeat_interleave(H // KVH, dim=2)
                      for a, sc in ((live[0], live[1]), (live[2], live[3])))
            keep = (live[4] != 0)[:, None, None, :]
            t_lib = time_ms(lambda: sdpa(q[:, None], kd, vd, keep))
            ops = 4 * H * D * valid * B
            b = bound(ops, _nbytes(q, *live, out), PEAK_INT8_TOPS)
            gbps = _nbytes(q, *live, out) / (t_k * 1e-3) / 1e9
            res[c["name"]] = dict(ms=t_k, plain_ms=t_p, library_ms=t_lib, gbps=gbps,
                                  splits=splits, kernels_a_call=launched.get("kernel", 0), **b)
            msg += (f" | kernel {t_k:.4f} ms = {gbps:.0f} GB/s ({gbps / HBM_PEAK_GBPS:.1%} of "
                    f"{HBM_PEAK_GBPS:.0f}), bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
                    f"twin {t_p:.3f} ms, SDPA over the live prefix dequantised to bf16 "
                    f"(dequantisation not timed{', KV repeated to H' if H > KVH else ''}) "
                    f"{t_lib:.4f} ms")
        log(msg + f" | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel #5 disagrees with its split twin, a rerun or its "
                                 f"planned launches: {c['name']}")
        res["err"] = max(res["err"], err)
        if c["name"] == "Llama3 GQA":
            merge_case = (args, ref, valid)
        else:
            del args
        del out, ref, again
    torch.cuda.empty_cache()

    # the probe: block 0 holds two keys scoring ~6 above the rest, so the
    # later blocks' probabilities are ~e^-6 of the peak and their p8 needs
    # the per-block scale; rows b > 0 have 100 b padded columns
    B, L, H, D, valid = 4, 1024, 32, 128, 1000
    q = _randn(g, B, H, D)
    qf = q.float()
    kf = torch.randn(B, L, H, D, generator=g, device="cuda")
    for t in (3, 40):
        kf[:, t] += 6 * D ** 0.5 * qf / qf.square().sum(dim=-1, keepdim=True)
    args = _kv8_cache(g, B, L, H, H, D, valid, pad=100)
    args[0] = q
    args[1], args[2] = quantize_kv(kf.to(torch.bfloat16))
    splits = kv8_splits(B, L, H, H, valid)
    ref = decode_attention_prefix_int8_split_ref(*args, valid, splits)
    q, kq, ks, vq, vs, mask = args
    sound = decode_attention_prefix_int8(*args, valid)
    faults = {
        "v-scale fold dropped": decode_attention_prefix_int8(
            q, kq, ks, vq, torch.ones_like(vs), mask, valid),
        "p quantised with one global max (the twin with one block)":
            decode_attention_prefix_int8_ref(*args, valid, block_l=L),
        "valid_len clamp one block short": decode_attention_prefix_int8(
            *args, valid - prefix_block_l(L)),
        "mask ignored": decode_attention_prefix_int8(
            q, kq, ks, vq, vs, torch.ones_like(mask), valid),
    }
    torch.cuda.synchronize()
    err, ratio = _kv8_ratio(sound, ref)
    log(f"[3f int8 decode] probe B={B} L={L} H={H} D={D} valid_len={valid}, {splits} key "
        f"splits: the sound kernel at {ratio:.3f} of the bound (against the split twin) | "
        f"{'ok' if ratio <= 1 else 'FAIL'}")
    if ratio > 1:
        raise AssertionError("kernel #5 disagrees with its twin on the probe")
    # the broken merges, on the Llama3 GQA case's splits
    t0 = time.perf_counter()
    libs = merge_variants.result()
    pool.shutdown()
    log(f"[3f int8 decode] planted faults: {len(libs)} broken merges built in the background "
        f"(waited {time.perf_counter() - t0:.1f} s)")
    margs, mref, mvalid = merge_case
    (mB, mH, _), (_, mL, mKVH, _) = margs[0].shape, margs[1].shape
    assert kv8_splits(mB, mL, mH, mKVH, mvalid) > 1
    checks = [(name, out, ref) for name, out in faults.items()]
    for name, lib in libs.items():
        with kernels_from(lib):
            checks.append((name, decode_attention_prefix_int8(*margs, mvalid), mref))
    torch.cuda.synchronize()
    for name, out, want in checks:
        err, ratio = _kv8_ratio(out, want)
        log(f"[3f int8 decode] planted fault {name!r}: max|err| {err:.3e} = {ratio:.3g} of "
            f"the bound | {'caught' if ratio > 1 else 'MISSED'}")
        if ratio <= 1:
            raise AssertionError(f"the 3f bound misses the planted fault {name!r}")
    return res

# 3g: kernel #16 against its twin (fused_decode_step_ref at the kernel's
# plan: the same key splits, fused_plan(...).attn_splits). Both sum the
# integer products exactly, quantise with IEEE divisions and round the fp32
# formulas alike, but the norm's sum of squares, the fresh column's dot and
# the softmax sums reduce in other orders and expf / sigmoid / rsqrt round
# differently, so now and then a value lands on the other side of a
# quantisation step. Such a flip changes its row's products by one step of
# the row's scale; the next layers quantise the difference again, and through
# 32 random-weight layers the flips spread: the twin against itself with x
# moved by one ulp reads as far apart as the kernel does (PERF.md section 6).
# So the check is two-fold. One layer (the first of the stack, at each case's
# shape), the sharp check: a row of x_out (and of the fresh k/v) either
# equals the twin's to FUSED_ROW_TOL of max|x_out| or holds a flip; at most
# FUSED_FLIP_ROWS(B) rows may hold one, every row's x_out within
# FUSED_FLIP_STEPS int8 steps of that row's own scale (max|x_out row| / 127)
# and the fresh k/v within FUSED_LAYER_KV_STEPS steps. Each planted fault
# (the twin with one piece of the function broken) must break one of these,
# also when it touches only the rows of the second 16-row mma tile. All 32
# layers, a gross check: x_out within FUSED_X_TOL of max|x_out|, the fresh
# k/v at most FUSED_KV_STEPS int8 steps apart, their scales within
# FUSED_SCALE_RTOL. Read on an H100 80GB HBM3 over two draws of the data
# (PERF.md section 6): one layer, at most 1 of 10, 2 of 8 and 4 of 24 rows
# with a flip, the worst row 3.42 steps of its scale, the fresh k/v 1 step;
# the planted faults move 7-8 of 8 rows (all 8 of rows 16-23), a row
# 3.7-87 steps, rope's k 254 steps. 32 layers: the kernel 0.06-0.24 of
# max|x_out|, 16-54 steps, scales 0.07-0.26, the twin against itself with x
# one ulp up 0.06-0.23; planted faults read 0.19-0.22 there, so this check
# catches only what breaks the step outright.
FUSED_ROW_TOL = 1e-5
FUSED_FLIP_STEPS = 8.0
FUSED_LAYER_KV_STEPS = 1
FUSED_X_TOL = 0.3
FUSED_KV_STEPS = 64
FUSED_SCALE_RTOL = 0.4
FUSED_LAYERS = 32
FUSED_TILE_ROWS = 16  # rows of one mma tile: a fault on the second tile starts here


def FUSED_FLIP_ROWS(B: int) -> int:  # noqa: N802 (a bound, named like the others)
    return max(1, B // 4)


FD_CASES = [  # 3g: the fused path's shapes at the 7B widths, then the edges
    dict(name="greedy_gen, mid-block", B=8, L=896, ci=840, KVH=32, bits=8, time=True),
    dict(name="diverse_gen", B=10, L=896, ci=895, KVH=32, bits=8, time=True),
    dict(name="batch-24 headline", B=24, L=1024, ci=960, KVH=32, bits=8, time=True),
    dict(name="block edge, a fully masked row", B=8, L=1024, ci=768, KVH=32, bits=8,
         time=False, dead_row=True),
    dict(name="early, mid-block", B=6, L=1024, ci=200, KVH=32, bits=8, time=False),
    dict(name="GQA n_rep 4", B=6, L=512, ci=300, KVH=8, bits=8, time=True),
    dict(name="int4 diverse_gen", B=10, L=896, ci=895, KVH=32, bits=4, time=True),
    dict(name="int4 batch-24 headline", B=24, L=1024, ci=960, KVH=32, bits=4, time=True),
    # phase 13's divide-and-conquer model: Llama3-8B, I 14336 (Ip 14336, bi 2048), GQA
    dict(name="Llama3-8B", B=8, L=2304, ci=2200, KVH=8, bits=8, time=True, llama3=True),
    dict(name="int4 Llama3-8B", B=8, L=2304, ci=2200, KVH=8, bits=4, time=True, llama3=True),
]


# 3g: planted faults in #16's key-split merge and its product ring, each a
# broken copy of csrc/fused_decode.cu run through one layer of
# FUSED_FAULT_CASE (3 key splits on 264 CTAs) that must break the sharp bounds
# (the names are build_variants' directories: none may repeat another
# phase's, or the second build reopens the first one's library)
FUSED_FAULT_CASE = "GQA n_rep 4"
FUSED_KERNEL_FAULTS = {
    "#16: one split left out of the merge": [(
        "fused_decode.cu", "        for (int s = 0; s < S; ++s) {\n          const float *ps",
        "        for (int s = 1; s < S; ++s) {\n          const float *ps")],
    "#16: a split merged without rescaling to the common max": [(
        "fused_decode.cu", "          const float wgt = expf(__fsub_rn(__ldcg(ps + DH), mx));",
        "          const float wgt = 1.f;")],
    # the wait moved after the products: the stage is read while its TMA may
    # still be landing, the barrier protocol intact
    "#16: a product ring stage consumed before its wait": [
        ("fused_decode.cu", "      bar_wait(full + 8 * st, (u0 / G::STAGES) & 1);\n", ""),
        ("fused_decode.cu", "      chunk_mma<W4>(d, ws, ws + G::WBYTES, MT, qchunk, qbyte, g, t);\n",
         "      chunk_mma<W4>(d, ws, ws + G::WBYTES, MT, qchunk, qbyte, g, t);\n"
         "      bar_wait(full + 8 * st, (u0 / G::STAGES) & 1);\n")],
}
# kernel #16's first design (commit 1b0ed56: one cooperative launch, cp.async
# sub-chunks, one attention item a (row, kv head)) at the batch-24 headline's
# step, us a layer (tools/fused_times.py on an NVIDIA H100 80GB HBM3, 700 W),
# and its barrier-bound floor in ms
FUSED_PARENT_PHASES = dict(rms=22.4, qkv=48.6, attention=102.1, o=22.2, rms2=21.6,
                           gate_up=72.8, act=9.7, down=49.4)
FUSED_PARENT_FLOOR_MS = 1.1992


def _fused_times_tool():
    """tools/fused_times.py, loaded by path (its stamped copy of #16)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("fused_times",
                                                  ROOT / "tools" / "fused_times.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fused_variants() -> dict:
    """#16's broken copies and its stamped copy, built together."""
    return build_variants({**FUSED_KERNEL_FAULTS,
                           "fused_stamps": _fused_times_tool().STAMP_EDITS})


def _fd_cfg(KVH: int, bits: int, llama3: bool = False, **kw):
    """The 7B LLM config of the fused path (Vicuna-7B widths), or with
    llama3 Llama3-8B's (I 14336, rope theta 5e5, eps 1e-5)."""
    kw.setdefault("num_layers", FUSED_LAYERS)
    base = LlamaConfig.llama3_8b if llama3 else LlamaConfig.vicuna_7b
    return base(num_kv_heads=KVH, quantize=True, quantize_bits=bits, fuse_proj=True,
                kv_cache_dtype="int8", **kw)


def _fd_weights(g, cfg) -> dict:
    """Stacked weights of `cfg` (the layouts of ops/fused_decode.py): each
    projection N(0, 0.02) quantised on the card as the package quantises a
    model (int8 per column, or int4 in groups of 128), the MLP padded to Ip
    as stack_llama_params pads it; norms 1 + N(0, 0.1)."""
    d = fd.default_dims(cfg, 128)
    HD, I, Ip = d.H * d.Dh, d.I, d.Ip
    out = {}
    for (wk, sk), K, N in ((("wqkv", "sqkv"), d.D, d.Nq), (("wo", "so"), HD, d.D),
                           (("wgu", "sgu"), d.D, 2 * I), (("wdown", "sdown"), I, d.D)):
        ws, ss = [], []
        for _ in range(d.n_layers):
            w = torch.randn(K, N, generator=g, device="cuda") * 0.02
            q, sc = quantize_int4_torch(w) if d.w4 else quantize_kernel_int8_torch(w)
            sc = sc if d.w4 else sc[None]
            if wk == "wgu":
                q, sc = fd._pad_cols(q, I, Ip), fd._pad_cols(sc, I, Ip)
            elif wk == "wdown":
                q = fd._pad_rows(q, Ip // 2 if d.w4 else Ip)
                sc = fd._pad_rows(sc, Ip // d.g_down) if d.w4 else sc
            ws.append(q)
            ss.append(sc)
        out[wk], out[sk] = torch.stack(ws), torch.stack(ss)
        del ws, ss
    out["ln"] = 1 + 0.1 * torch.randn(d.n_layers, 2, d.D, generator=g, device="cuda")
    return out


def _fd_inputs(g, d, B: int, ci: int, dead_row: bool = False) -> tuple:
    """A random stacked cache whose scales past the last live block are NaN
    (never read), a mask with 7 b columns of left padding in row b (all of
    row 1 masked with dead_row) live up to ci (the fresh column), x ~ N(0,
    0.02) (an embedding's scale) and rope positions."""
    shape = (d.n_layers, d.KVH, B, d.L)
    cache = {}
    for key in ("k", "v"):
        cache[key] = torch.randint(-127, 128, shape + (d.Dh,), generator=g, device="cuda",
                                   dtype=torch.int8)
        sc = 0.01 + 0.02 * torch.rand(shape, generator=g, device="cuda")
        sc[..., -(-ci // d.bl) * d.bl:] = float("nan")
        cache[f"{key}_scale"] = sc
    mask = torch.zeros((B, d.L), dtype=torch.int32, device="cuda")
    for b in range(B):
        mask[b, 7 * b:ci + 1] = 1
    if dead_row:
        mask[1] = 0
    x = 0.02 * torch.randn(B, d.D, generator=g, device="cuda")
    pos = ci - 7 * torch.arange(B, device="cuda")
    return cache, mask, x, pos


def _fd_gap(x_out, kv, x_ref, kv_ref) -> dict:
    """x_out's max|d| (absolute, and over max|ref|), the largest row error in
    int8 steps of that row's scale (max|ref row| / 127), the fresh k/v's
    largest int8 step difference and count of differing values, their
    scales' largest relative difference, and the batch rows that differ at
    all (x_out beyond FUSED_ROW_TOL of max|ref|, or any fresh k/v value or
    scale) (inf for anything not finite)."""
    if not all(bool(torch.isfinite(t).all()) for t in (x_out, kv["k_scale"], kv["v_scale"])):
        return dict(x_rel=math.inf, x_abs=math.inf, row_steps=math.inf, steps=math.inf,
                    flips=-1, scale_rel=math.inf, rows=math.inf)
    err = (x_out - x_ref).abs().amax(dim=1)
    top = x_ref.abs().max()
    rows = err > FUSED_ROW_TOL * top
    diffs = [(kv[k].int() - kv_ref[k].int()).abs() for k in ("k", "v")]
    srel = [(kv[k] - kv_ref[k]).abs() / kv_ref[k].abs() for k in ("k_scale", "v_scale")]
    for t in diffs:  # (n_layers, KVH, B, Dh) -> (B,)
        rows |= (t != 0).any(dim=3).any(dim=1).any(dim=0)
    for t in srel:  # (n_layers, KVH, B)
        rows |= (t > FUSED_ROW_TOL).any(dim=1).any(dim=0)
    return dict(x_rel=err.max().item() / top.item(), x_abs=err.max().item(),
                row_steps=(err / (x_ref.abs().amax(dim=1) / 127)).max().item(),
                steps=max(t.max().item() for t in diffs),
                flips=sum(int((t != 0).sum()) for t in diffs),
                scale_rel=max(t.max().item() for t in srel), rows=int(rows.sum()))


def _fd_layer_broken(gap: dict, B: int) -> list:
    """One layer: the sharp bounds `gap` breaks."""
    return [name for name, bad in (
        (f"{gap['rows']} rows differ > {FUSED_FLIP_ROWS(B)}", gap["rows"] > FUSED_FLIP_ROWS(B)),
        (f"a row {gap['row_steps']:.3g} steps of its scale off > {FUSED_FLIP_STEPS}",
         gap["row_steps"] > FUSED_FLIP_STEPS),
        (f"k/v {gap['steps']} steps > {FUSED_LAYER_KV_STEPS}",
         gap["steps"] > FUSED_LAYER_KV_STEPS)) if bad]


def _fd_within(gap: dict) -> bool:
    """All 32 layers: the gross bounds."""
    return (gap["x_rel"] <= FUSED_X_TOL and gap["steps"] <= FUSED_KV_STEPS
            and gap["scale_rel"] <= FUSED_SCALE_RTOL)


def _fd_layer0(args: tuple) -> tuple:
    """The same step through the first layer of the stack only."""
    stacked, cache, x, mask, pos, ci, d = args
    return ({k: v[:1] for k, v in stacked.items()}, {k: v[:1] for k, v in cache.items()},
            x, mask, pos, ci, dataclasses.replace(d, n_layers=1))


def _fd_rows_from(ref: tuple, bad: tuple, start: int) -> tuple:
    """The twin's output `ref` with the batch rows from `start` on taken
    from `bad`: a fault confined to the second mma row tile."""
    x = ref[0].clone()
    x[start:] = bad[0][start:]
    kv = {k: v.clone() for k, v in ref[1].items()}
    for k, v in kv.items():
        v[:, :, start:] = bad[1][k][:, :, start:]
    return x, kv


def _fd_faults(args: tuple, kw: dict, out: tuple, first_row: int = 0) -> None:
    """The planted faults on one layer: the twin with one piece of the
    function broken (on the rows from `first_row` on), each against the
    sound kernel's output, must break a sharp bound."""
    from unittest import mock

    stacked, cache, x, mask, pos, ci, d = args
    rope, down = fd._rope, fd._down
    calls = [0]

    def rope_q_only(t, cos, sin):  # the second rope of a layer is k's
        calls[0] += 1
        return t if calls[0] % 2 == 0 else rope(t, cos, sin)

    def no_fresh(qg, k, v, scale):
        m = torch.full(qg.shape[:-1] + (1,), fd.NEG_INF, device=qg.device)
        return m, torch.zeros_like(m), torch.zeros_like(qg)

    def act_whole_I(gu, d):
        g, u = gu[:, :d.Ip], gu[:, d.Ip:]
        a8, sa = qm.quantize_rows((g * torch.sigmoid(g)) * u)
        return [(a8[:, b * d.bi:(b + 1) * d.bi], sa) for b in range(d.nI)]

    def drop_last_block(a8, sa, wdown, sdown, blk, d):
        y = down(a8, sa, wdown, sdown, blk, d)
        return torch.zeros_like(y) if blk == d.nI - 1 else y

    faults = {"the fresh column dropped": ("_fresh_column", no_fresh, mask),
              "the mask ignored": (None, None, torch.ones_like(mask)),
              "the activation quantised over the whole of I, not per I-block":
                  ("_act_quant", act_whole_I, mask),
              "rope skipped on k": ("_rope", rope_q_only, mask),
              "one I-block of the down sum dropped": ("_down", drop_last_block, mask)}
    B = x.shape[0]
    where = f"rows {first_row}-{B - 1}" if first_row else f"all {B} rows"
    sound = fd.fused_decode_step_ref(*args, **kw) if first_row else None
    missed = []
    for name, (attr, fn, fmask) in faults.items():
        calls[0] = 0
        with mock.patch.object(fd, attr, fn) if attr else contextlib.nullcontext():
            ref = fd.fused_decode_step_ref(stacked, cache, x, fmask, pos, ci, d, **kw)
        if first_row:
            ref = _fd_rows_from(sound, ref, first_row)
        gap = _fd_gap(*out, *ref)
        broken = _fd_layer_broken(gap, B)
        log(f"[3g fused decode] planted fault {name!r} on {where}, one layer: {gap['rows']} of "
            f"{B} rows differ, x_out {gap['x_rel']:.3e} of max, a row {gap['row_steps']:.3g} "
            f"steps of its scale off, k/v {gap['steps']} steps ({gap['flips']} values), scales "
            f"{gap['scale_rel']:.2e} | {'caught: ' + '; '.join(broken) if broken else 'MISSED'}")
        if not broken:
            missed.append(name)
    if missed:
        raise AssertionError(f"the 3g bounds miss the planted faults {missed} on {where}")


def _fd_bytes(d, B: int, ci: int) -> int:
    """The bytes one step must move: every weight and scale read once at
    the true intermediate size I (the zero padding to Ip is not part of the
    function), the live cache prefix (columns [0, ci) of every layer, values
    and scales), x in and out, the mask, the fresh k/v out."""
    weights = sum(math.prod(s) * (1 if k.startswith("w") else 4)
                  for k, s in fd._stacked_shapes(dataclasses.replace(d, Ip=d.I)).items())
    prefix = d.n_layers * d.KVH * B * ci * 2 * (d.Dh + 4)
    fresh = d.n_layers * d.KVH * B * 2 * (d.Dh + 4)
    return weights + prefix + fresh + 2 * B * d.D * 4 + B * d.L * 4


def _fd_bound(d, B: int, ci: int) -> dict:
    """One step's bound: _fd_bytes at the HBM peak, or the int8 operations
    (every weight used by B rows, q.k and p.v over the live prefix) at the
    int8 peak."""
    macs = d.D * d.Nq + d.H * d.Dh * d.D + d.D * 2 * d.I + d.I * d.D
    ops = d.n_layers * (2 * B * macs + 4 * B * d.H * d.Dh * ci)
    return bound(ops, _fd_bytes(d, B, ci), PEAK_INT8_TOPS)


def phase_fused_kernel(g, variants=None) -> dict:
    """3g: kernel #16 against its twin at the kernel's plan at the fused
    path's shapes and edges (int8 and int4, MHA and GQA), times beside the
    bound and the twin's; the plan and the kernels a call (a CUDA graph of
    one call); the per-phase breakdown at the batch-24 headline (the stamped
    copy) and the barrier-bound floor, beside the first design's; then the
    planted faults: five in the twin, three broken copies of the kernel
    (`variants`: a future of fused_variants(), built here if None)."""
    res = {"err": 0.0}
    libs = variants.result() if variants is not None else fused_variants()
    tool = _fused_times_tool()
    tool.declare(libs["fused_stamps"])
    weights = {}
    for c in FD_CASES:
        key = (c["KVH"], c["bits"], c.get("llama3", False))
        if key not in weights:
            weights.clear()
            gc.collect()
            torch.cuda.empty_cache()
            weights[key] = _fd_weights(g, _fd_cfg(*key))
        cfg = _fd_cfg(*key)
        d = fd.default_dims(cfg, c["L"])
        B, ci = c["B"], c["ci"]
        cache, mask, x, pos = _fd_inputs(g, d, B, ci, c.get("dead_row", False))
        args = (weights[key], cache, x, mask, pos, ci, d)
        kw = dict(rope_theta=cfg.rope_theta)
        plan = fd.fused_plan(d, B, ci)
        kwr = dict(kw, attn_splits=plan.attn_splits)  # the twin at the kernel's plan
        out = fd.fused_decode_step(*args, **kw)
        ref = fd.fused_decode_step_ref(*args, **kwr)
        xp = torch.nextafter(x, torch.full_like(x, math.inf))
        spread = _fd_gap(*fd.fused_decode_step_ref(weights[key], cache, xp, *args[3:], **kwr),
                         *ref)
        args1 = _fd_layer0(args)
        out1 = fd.fused_decode_step(*args1, **kw)
        gap1 = _fd_gap(*out1, *fd.fused_decode_step_ref(*args1, **kwr))
        torch.cuda.synchronize()
        gap = _fd_gap(*out, *ref)
        broken = _fd_layer_broken(gap1, B)
        ok = _fd_within(gap) and not broken
        msg = (f"[3g fused decode] {c['name']}: int{c['bits']} B={B} L={d.L} cache_index={ci} "
               f"KVH={d.KVH} I={d.I} (Ip {d.Ip}, bi {d.bi}), {plan} | one layer: {gap1['rows']} of {B} rows hold a flip (bound "
               f"{FUSED_FLIP_ROWS(B)}), x_out {gap1['x_rel']:.2e} of max, the worst row "
               f"{gap1['row_steps']:.3g} steps of its scale (tol {FUSED_FLIP_STEPS}), k/v "
               f"{gap1['steps']} steps (tol {FUSED_LAYER_KV_STEPS}) | {d.n_layers} layers: "
               f"x_out max|d| {gap['x_abs']:.3e} = {gap['x_rel']:.3e} of max (tol "
               f"{FUSED_X_TOL}), fresh k/v {gap['steps']} steps apart in {gap['flips']} of "
               f"{2 * out[1]['k'].numel()} values (tol {FUSED_KV_STEPS}), scales "
               f"{gap['scale_rel']:.2e} (tol {FUSED_SCALE_RTOL}); the twin against itself with "
               f"x one ulp up: {spread['x_rel']:.3e}, {spread['steps']} steps, "
               f"{spread['scale_rel']:.2e}")
        if c["time"]:
            try:
                ops = ops_text(launched_ops(lambda: fd.fused_decode_step(*args, **kw)))
            except RuntimeError as e:  # a cooperative launch the graph cannot hold
                ops = f"not captured ({str(e).splitlines()[0][:80]})"
            msg += f" | one call: {ops} (a CUDA graph of one call; the wrapper's rope tables too)"
            t_k = time_ms(lambda: fd.fused_decode_step(*args, **kw), 10)
            t_p = time_ms(lambda: fd.fused_decode_step_ref(*args, **kwr), 2)
            b = _fd_bound(d, B, ci)
            gbps = _fd_bytes(d, B, ci) / (t_k * 1e-3) / 1e9
            res[c["name"]] = dict(ms=t_k, plain_ms=t_p, library_ms=None, gbps=gbps, **b)
            msg += (f" | kernel {t_k:.3f} ms a step (the wrapper's rope tables and copies "
                    f"included) = {gbps:.0f} GB/s ({gbps / HBM_PEAK_GBPS:.1%} of "
                    f"{HBM_PEAK_GBPS:.0f}), bound {b['bound_ms']:.3f} ms ({b['bound_by']}), "
                    f"{t_k / b['bound_ms']:.2f}x; twin {t_p:.1f} ms; no single PyTorch call "
                    f"computes this function")
        log(msg + f" | {'ok' if ok else 'FAIL ' + '; '.join(broken)}")
        if not ok:
            raise AssertionError(f"kernel #16 disagrees with its twin: {c['name']}")
        res["err"] = max(res["err"], gap["x_abs"])
        if c["name"] == "batch-24 headline":
            with kernels_from(libs["fused_stamps"]):
                rows = tool.breakdown(torch, libs["fused_stamps"],
                                      lambda: fd.fused_decode_step(*args, **kw), d.n_layers)
            res["phases"] = rows
            log(f"[3g fused decode] phases at the batch-24 headline ({tool.phases_text(rows)}); "
                f"the first design's: " + ", ".join(
                    f"{k} {v}" for k, v in FUSED_PARENT_PHASES.items()) +
                f" = {sum(FUSED_PARENT_PHASES.values()):.1f} us a layer")
        if c["name"] == FUSED_FAULT_CASE:
            ref1 = fd.fused_decode_step_ref(*args1, **kwr)
            missed = []
            for name in FUSED_KERNEL_FAULTS:
                with kernels_from(libs[name]):
                    bad = fd.fused_decode_step(*args1, **kw)
                torch.cuda.synchronize()
                gapf = _fd_gap(*bad, *ref1)
                broken = _fd_layer_broken(gapf, B)
                log(f"[3g fused decode] planted fault {name!r} (a broken copy of the kernel, "
                    f"{plan.attn_splits} key splits), one layer: {gapf['rows']} of {B} rows "
                    f"differ, x_out {gapf['x_rel']:.3e} of max, a row {gapf['row_steps']:.3g} "
                    f"steps off, k/v {gapf['steps']} steps | "
                    f"{'caught: ' + '; '.join(broken) if broken else 'MISSED'}")
                if not broken:
                    missed.append(name)
            if missed:
                raise AssertionError(f"the 3g bounds miss the kernel faults {missed}")
        if c["name"].startswith("greedy_gen"):
            _fd_faults(args1, kwr, out1)
        elif c["name"] == "batch-24 headline":
            _fd_faults(args1, kwr, out1, first_row=FUSED_TILE_ROWS)
        del cache, args, out, ref
    weights.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # the barrier-bound floor: 32 layers of 8 phases on work too small to
    # matter (D 256, one kv head pair, B 1, one live column)
    cfg = _fd_cfg(2, 8, hidden_size=256, intermediate_size=512, num_heads=2)
    d = fd.default_dims(cfg, 128)
    tiny = _fd_weights(g, cfg)
    cache, mask, x, pos = _fd_inputs(g, d, 1, 1)
    t_floor = time_ms(lambda: fd.fused_decode_step(tiny, cache, x, mask, pos, 1, d), 20)
    n_bar = 8 * d.n_layers
    res["floor_ms"] = t_floor
    log(f"[3g fused decode] barrier-bound floor: {t_floor:.4f} ms a launch at D 256, B 1 "
        f"({n_bar} grid barriers: <= {t_floor / n_bar * 1e3:.2f} us a barrier and phase); the "
        f"first design's {FUSED_PARENT_FLOOR_MS} ms")
    return res


# 3h: kernel #6 against its twin (decode_attention_ref). Both compute in
# fp32; they sum the same products in other orders, scale q . k after the
# sum alike, and the kernel's exp2f of log2-scaled scores (its key splits
# merged in log2 units) rounds differently from torch's exp. fp32 inputs:
# |kernel - twin| <= FULL_RTOL x max(1, max|twin|); bf16 inputs: both round
# the fp32 result to bf16 once, so the bf16 bound of phase 3 (OUT_TOL +
# OUT_RTOL x |twin|). A fully masked row must be exactly 0.
FULL_RTOL = 1e-5

FULL_CASES = [  # 3h: run_tpu_checks' shapes, batch 24, Llama3 GQA, then the edges
    dict(name="run_tpu_checks KVH 8", B=4, L=896, H=8, KVH=8, D=128, fp32=True,
         mask="tpu_checks"),
    dict(name="run_tpu_checks KVH 4", B=4, L=896, H=8, KVH=4, D=128, fp32=True,
         mask="tpu_checks"),
    dict(name="batch 24", B=24, L=1024, H=32, KVH=32, D=128, fp32=False, time=True),
    dict(name="Llama3 GQA", B=8, L=2304, H=32, KVH=8, D=128, fp32=False, time=True),
    dict(name="L 781, a fully masked row", B=4, L=781, H=32, KVH=8, D=128, fp32=True,
         dead_row=True),
    dict(name="L 781 bf16", B=3, L=781, H=32, KVH=8, D=128, fp32=False, dead_row=True),
    dict(name="D 64", B=3, L=600, H=8, KVH=8, D=64, fp32=False),
    dict(name="D 64 fp32, n_rep 2", B=3, L=333, H=8, KVH=4, D=64, fp32=True),
    dict(name="n_rep 8", B=3, L=640, H=32, KVH=4, D=128, fp32=True),
    dict(name="interior holes", B=3, L=1000, H=32, KVH=8, D=128, fp32=True, mask="holes"),
]
FULL_FAULT_CASE = "L 781, a fully masked row"  # 6 key splits on 132 SMs
# 3h: planted faults in the merge of #6's key splits, each a broken copy of
# csrc/decode_attention_full.cu that must break the bound on FULL_FAULT_CASE
FULL_SPLIT_FAULTS = {
    "one split left out of the merge": [(
        "decode_attention_full.cu",
        "  for (int s = 0; s < splits; ++s) {\n    const float *ps = p + s * (D + 2);",
        "  for (int s = 1; s < splits; ++s) {\n    const float *ps = p + s * (D + 2);")],
    "a split's state merged without rescaling to the common max": [(
        "decode_attention_full.cu", "    const float a = exp2f(ps[D] - mx);",
        "    const float a = 1.f;")],
}


def _full_inputs(g, c: dict) -> list:
    """Kernel #6's operands for a 3h case: q, k, v ~ N(0, 1) in fp32 or bf16
    and the mask: run_tpu_checks' (row 0 masked from 700, row 2 from 13),
    random interior holes (a third of row 0's columns and a run in row 1),
    or 7 b columns of left padding in row b; `dead_row` masks all of row 1."""
    B, L, H, KVH, D = (c[k] for k in ("B", "L", "H", "KVH", "D"))
    dtype = torch.float32 if c["fp32"] else torch.bfloat16
    q, k, v = (torch.randn(*shape, generator=g, device="cuda").to(dtype)
               for shape in ((B, H, D), (B, L, KVH, D), (B, L, KVH, D)))
    mask = torch.ones((B, L), dtype=torch.int32, device="cuda")
    kind = c.get("mask", "pad")
    if kind == "tpu_checks":
        mask[0, 700:] = 0
        mask[2, 13:] = 0
    elif kind == "holes":
        mask[0] = (torch.rand(L, generator=g, device="cuda") >= 1 / 3).int()
        mask[1, L // 3:L // 2] = 0
    else:
        for b in range(B):
            mask[b, :7 * b] = 0
    if c.get("dead_row"):
        mask[1] = 0
    return [q, k, v, mask]


def _full_ratio(out: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max|out - ref|, that error over 3h's bound: FULL_RTOL x max(1,
    max|ref|) for fp32, the largest |err| / (OUT_TOL + OUT_RTOL |ref|) for
    bf16; inf where either holds a value that is not finite)."""
    if not (bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(ref.float()).all())):
        return math.inf, math.inf
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    if out.dtype == torch.float32:
        return err.max().item(), err.max().item() / (FULL_RTOL * max(1.0, r.abs().max().item()))
    return err.max().item(), (err / (OUT_TOL + OUT_RTOL * r.abs())).max().item()


def full_tile(D: int, dtype: torch.dtype, n_rep: int) -> int:
    """Keys csrc/decode_attention_full.cu reads per tile: its warps (8 at
    n_rep 1-2, 4 above) x the key rows a warp covers (32 lanes over D / (16
    bytes of elements) lanes a row)."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return (8 if n_rep <= 2 else 4) * 32 // (D // vec)


def _full_fault(q, k, v, mask, fault: str) -> torch.Tensor:
    """The twin's formula with one piece of kernel #6's function broken."""
    B, H, D = q.shape
    L, KVH = k.shape[1], k.shape[2]
    if fault == "mask ignored":
        mask = torch.ones_like(mask)
    elif fault == "last partial key tile dropped":
        mask = mask.clone()
        tile = full_tile(D, q.dtype, H // KVH)
        mask[:, L // tile * tile:] = 0
    heads = torch.arange(H, device=q.device)
    kv_of = heads % KVH if fault == "q head h read kv head h % KVH" else heads // (H // KVH)
    kf, vf = k.float()[:, :, kv_of], v.float()[:, :, kv_of]  # (B, L, H, D)
    scale = 1.0 if fault == "scale dropped" else 1.0 / D ** 0.5
    s = torch.einsum("bhd,blhd->bhl", q.float(), kf) * scale
    s = s + torch.where(mask[:, None, :] != 0, 0.0, NEG_INF)
    p = torch.exp(s - torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF / 2))
    den = p.sum(dim=-1, keepdim=True)
    if fault != "denominator clamp removed":
        den = torch.clamp(den, min=1e-30)
    return torch.einsum("bhl,blhd->bhd", p / den, vf).to(q.dtype)


def phase_full_kernel(g) -> dict:
    """3h: kernel #6 (full-cache decode attention) against its twin at
    run_tpu_checks' shapes, batch 24, the Llama3 GQA geometry and the edges;
    times beside the twin, SDPA and the bound; then planted faults that
    must break the bound."""
    res = {"err": 0.0}
    t0 = time.perf_counter()
    split_faults = build_variants(FULL_SPLIT_FAULTS)
    log(f"[3h full decode] planted faults: {len(split_faults)} broken variants built in "
        f"{time.perf_counter() - t0:.1f} s")
    for c in FULL_CASES:
        args = _full_inputs(g, c)
        q, k, v, mask = args
        out = decode_attention(*args)
        ref = decode_attention_ref(*args)
        torch.cuda.synchronize()
        err, ratio = _full_ratio(out, ref)
        dead = [b for b in range(c["B"]) if not bool(mask[b].any())]
        splits = full_plan(c["B"], c["KVH"], c["L"], qm._sms(0), c["H"] // c["KVH"])
        tile = full_tile(c["D"], q.dtype, c["H"] // c["KVH"])
        launched = launched_ops(lambda: decode_attention(*args))
        ok = ratio <= 1 and all(bool((out[b] == 0).all()) for b in dead) and \
            launched.get("kernel", 0) == 1 + (splits > 1)
        tol = (f"{FULL_RTOL} x max(1, max|twin|)" if c["fp32"]
               else f"{OUT_TOL} + {OUT_RTOL} x |twin|")
        msg = (f"[3h full decode] {c['name']}: {'fp32' if c['fp32'] else 'bf16'} "
               f"B={c['B']} L={c['L']} H={c['H']} KVH={c['KVH']} D={c['D']} (tile "
               f"{tile} keys, {splits} key splits; one call captured in a CUDA graph: "
               f"{ops_text(launched)}, {1 + (splits > 1)} planned) | max|err| {err:.3e} = "
               f"{ratio:.3f} of the bound ({tol}), {len(dead)} fully masked rows")
        if c.get("time"):
            t_k = time_ms(lambda: decode_attention(*args))
            t_p = time_ms(lambda: decode_attention_ref(*args), 10)
            n_rep = c["H"] // c["KVH"]
            kr, vr = (t.repeat_interleave(n_rep, dim=2) for t in (k, v))
            keep = (mask != 0)[:, None, None, :]
            t_lib = time_ms(lambda: sdpa(q[:, None], kr, vr, keep))
            ops = 4 * c["H"] * c["D"] * c["L"] * c["B"]
            b = bound(ops, _nbytes(q, k, v, mask, out),
                      PEAK_FP32_TFLOPS if c["fp32"] else PEAK_BF16_TFLOPS)
            gbps = _nbytes(q, k, v, mask, out) / (t_k * 1e-3) / 1e9
            res[c["name"]] = dict(ms=t_k, plain_ms=t_p, library_ms=t_lib, gbps=gbps,
                                  splits=splits, kernels_a_call=launched.get("kernel", 0), **b)
            msg += (f" | kernel {t_k:.4f} ms = {gbps:.0f} GB/s ({gbps / HBM_PEAK_GBPS:.1%} of "
                    f"{HBM_PEAK_GBPS:.0f}), bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
                    f"{t_k / b['bound_ms']:.2f}x; twin {t_p:.3f} ms; SDPA with the same "
                    f"boolean mask on KV repeated to H (the repeat not timed) {t_lib:.4f} ms")
            del kr, vr
        log(msg + f" | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel #6 disagrees with its twin: {c['name']}")
        res["err"] = max(res["err"], err)
        if c["name"] == FULL_FAULT_CASE:
            missed = []
            for fault in ("mask ignored", "scale dropped", "q head h read kv head h % KVH",
                          "last partial key tile dropped", "denominator clamp removed"):
                f_err, f_ratio = _full_ratio(out, _full_fault(*args, fault))
                log(f"[3h full decode] planted fault {fault!r} ({c['name']}, "
                    f"{c['L'] % tile} keys in the last tile): max|err| "
                    f"{f_err:.3e} = {f_ratio:.3g} of the bound | "
                    f"{'caught' if f_ratio > 1 else 'MISSED'}")
                if f_ratio <= 1:
                    missed.append(fault)
            for fault, lib in split_faults.items():
                with kernels_from(lib):
                    got = decode_attention(*args)
                torch.cuda.synchronize()
                f_err, f_ratio = _full_ratio(got, ref)
                dead_ok = all(bool((got[b] == 0).all()) for b in dead)
                log(f"[3h full decode] planted fault {fault!r} ({c['name']}, {splits} key "
                    f"splits; a broken copy of the kernel): max|err| {f_err:.3e} = "
                    f"{f_ratio:.3g} of the bound, fully masked rows 0: {dead_ok} | "
                    f"{'caught' if f_ratio > 1 else 'MISSED'}")
                if f_ratio <= 1:
                    missed.append(fault)
            if missed:
                raise AssertionError(f"the 3h bound misses the planted faults {missed}")
        del args, q, k, v, mask, out, ref
    torch.cuda.empty_cache()
    return res


def _headline_items(gen: Llava15Generator, image_bytes: bytes) -> list:
    """HEADLINE_B items whose prompts are HEADLINE_PROMPT tokens long (the
    character-level tokenizer: one token a character), one image."""
    base = len(gen._prepare(_items(image_bytes, ["Q"]))[0][0])
    fill = HEADLINE_PROMPT - base
    return _items(image_bytes, ["Q" + chr(ord("a") + i % 26) * fill
                                for i in range(HEADLINE_B)])


def phase_headline(gen: Llava15Generator, items: list, tag: str, decode: str,
                   per_step: int = 0) -> tuple:
    """One generate at the JAX package's headline serving shape
    (scripts/bench_7b_serve.py: batch 24, 896-token prompts, 64 new tokens,
    greedy), after a max_new_tokens=1 run of the same batch: prefill and
    decode rates apart -> (launches of the 64-token run, rates)."""
    prompts, starts, images = gen._prepare(items)
    assert {len(p) for p in prompts} == {HEADLINE_PROMPT}, {len(p) for p in prompts}
    kw = dict(images=images, image_starts=starts)
    gen.engine.generate(prompts[:2], images=images[:2], image_starts=starts[:2],
                        max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen.engine.generate(prompts, max_new_tokens=1, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reset_counts()
    res = gen.engine.generate(prompts, max_new_tokens=HEADLINE_NEW, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_counts()
    steps = launches[decode] // (per_step or gen.model.cfg.llm.num_layers)
    assert res.tokens.shape == (HEADLINE_B, HEADLINE_NEW)
    rates = dict(prefill_s=t1 - t0, total_s=t2 - t1, steps=steps,
                 tok_s=HEADLINE_B * (steps + 1) / (t2 - t1),
                 decode_tok_s=HEADLINE_B * steps / max(t2 - t1 - (t1 - t0), 1e-9),
                 peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"[{tag}] headline batch {HEADLINE_B} x {HEADLINE_PROMPT}-token prompts: prefill "
        f"(max_new_tokens=1) {rates['prefill_s']:.3f} s; {HEADLINE_NEW} new tokens "
        f"({steps} decode steps) in {rates['total_s']:.3f} s = {rates['tok_s']:.1f} tok/s, "
        f"decode alone {rates['decode_tok_s']:.1f} tok/s; peak {rates['peak_gb']:.2f} GiB")
    return launches, rates


def _padded(eng: DecodeEngine, prompts, starts) -> tuple:
    """generate's left padding of `prompts` to a bucket of 64 -> (Lp, ids,
    mask, the image starts shifted by each row's padding or None)."""
    Lp = -(-max(len(p) for p in prompts) // 64) * 64
    ids_np, mask_np = left_pad_batch(prompts, eng.pad_id, Lp)
    ids, mask = (torch.from_numpy(a).cuda() for a in (ids_np, mask_np))
    if starts is not None:
        starts = np.asarray(starts) + Lp - np.asarray([len(p) for p in prompts])
    return Lp, ids, mask, starts


def _padded_spans(eng: DecodeEngine, prompts, spans, Lp: int):
    """(span features, span starts relative to each prompt) -> the engine's
    spans at generate's left padding to Lp, or None."""
    if spans is None:
        return None
    return eng._spans(spans[0], spans[1], Lp - np.asarray([len(p) for p in prompts]))


def _forced_logits(eng: DecodeEngine, prompts, starts, images, tokens: torch.Tensor,
                   impls: tuple, spans=None) -> torch.Tensor:
    """The prefill, then one decode step for each column of `tokens` (the
    same tokens on every route), as DecodeEngine.generate runs them, at the
    cache width generate gives 64 new tokens, with attn_impl impls[0] for
    the prefill and impls[1] for the steps -> fp32 logits (1 + steps, B, V):
    the last prompt position's, then each step's. A bare language model's
    engine takes starts and images None; a MiniCPM-V prompt its spans
    (features (B, S, Q, D), starts (B, S)) and starts and images None."""
    attn = [m for m in eng.model.modules() if isinstance(m, LlamaAttention)]
    Lp, ids, mask, starts = _padded(eng, prompts, starts)
    with torch.inference_mode():
        for m in attn:
            m.attn_impl = impls[0]
        first, cache, cmask = eng._prefill(ids, mask, eng._device_images(images), starts,
                                           -(-(Lp + 64) // 128) * 128,
                                           spans=_padded_spans(eng, prompts, spans, Lp))
        for m in attn:
            m.attn_impl = impls[1]
        out, plen = [first.float()], mask.sum(dim=1)
        for t in range(tokens.shape[1]):
            cmask[:, Lp + t] = 1
            logits, cache = eng.llm(input_ids=tokens[:, t:t + 1], attention_mask=cmask,
                                    position_ids=(plen + t)[:, None], cache=cache,
                                    cache_index=Lp + t)
            out.append(logits[:, 0].float())
    for m in attn:
        m.attn_impl = "auto"
    return torch.stack(out)


def _logit_gap(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(max|a - b| / max|b|, the least cosine between matching logit rows)."""
    rel = ((a - b).abs().max() / b.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(a.flatten(0, -2), b.flatten(0, -2), dim=-1)
    return rel, cos.min().item()


def phase_int8_kv_vs_plain(gen: Llava15Generator, image_bytes: bytes) -> None:
    """11, against the plain paths on greedy_gen's 4 prompts and 4 forced
    decode steps, each route named by (cache, prefill attn_impl, decode
    attn_impl): the path ("auto": fresh-window flash, kernel #5) against
    the same weights with a bf16 cache, and kernel #5 against the dense
    dequantised formula after the same prefill."""
    prompts, starts, images = gen._prepare(_items(image_bytes, [
        "What is in the image?", "Describe the scene.", "What colors do you see?",
        "Is it daytime?"]))
    tokens = torch.randint(10, min(300, gen.engine.vocab_size), (4, 4),
                           generator=torch.Generator().manual_seed(0)).cuda()
    routes = {"path": ("int8", "auto", "auto"), "int8 #5": ("int8", "dense", "auto"),
              "int8 dense": ("int8", "dense", "dense"), "bf16": ("fp", "auto", "auto"),
              "bf16 dense": ("fp", "dense", "dense")}
    runs = {}
    for name, (kv, *impls) in routes.items():
        set_llm_config(gen.model, kv_cache_dtype=kv)
        runs[name] = _forced_logits(gen.engine, prompts, starts, images, tokens,
                                    tuple(impls))
    set_llm_config(gen.model, kv_cache_dtype="int8")
    assert all(bool(torch.isfinite(r).all()) for r in runs.values())
    checks = [
        ("prefill: the path (fresh-window flash) vs the bf16 cache (flash over the "
         "prompt columns)", "path", "bf16", slice(0, 1)),
        ("prefill, both dense: the fresh window vs the bf16 cache's prompt columns",
         "int8 dense", "bf16 dense", slice(0, 1)),
        ("decode steps 1-4: the path (#5) vs the bf16 cache (#4)", "path", "bf16",
         slice(1, None)),
        ("decode steps 1-4 after one dense prefill: #5 vs the dense dequantised formula",
         "int8 #5", "int8 dense", slice(1, None)),
        ("decode steps 1-4, both dense: the int8 cache vs the bf16 cache",
         "int8 dense", "bf16 dense", slice(1, None)),
    ]
    ok = True
    for text, a, b, steps in checks:
        rel, cos = _logit_gap(runs[a][steps], runs[b][steps])
        good = rel <= INT8_KV_REL_TOL and cos >= INT8_KV_COS_MIN
        ok = ok and good
        log(f"[11 int8-kv vs plain] {text}: max|d| / max|ref| {rel:.4f} (tol "
            f"{INT8_KV_REL_TOL}), least row cosine {cos:.5f} (tol {INT8_KV_COS_MIN}) | "
            f"{'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError("the int8-KV path disagrees with its plain paths")


def phase_int8_kv(gen: Llava15Generator, image_bytes: bytes, bf16: dict) -> dict:
    """11: phase 4's seed-0 model at the headline shape in bf16, then
    quantised in place to int8 weights (head bf16), fused (qkv_proj,
    gate_up_proj) and given an int8 KV cache: phase 4's workloads and the
    headline again, against the plain paths -> the launches of its runs."""
    items = _headline_items(gen, image_bytes)
    launches, bf16_head = phase_headline(gen, items, "11 bf16 headline", "decode")
    t0 = time.perf_counter()
    quantize_llm_int8(gen.model, include_lm_head=False)
    set_llm_config(fuse_llm_projections_(gen.model), kv_cache_dtype="int8")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[11 int8-kv] quantised to int8 (head bf16), fused and switched to the int8 cache "
        f"in {time.perf_counter() - t0:.1f} s: {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
        f"GiB allocated")
    slice_launches, rates = phase_slice(gen, image_bytes, "11 int8-kv", "decode_int8")
    add_counts(launches, slice_launches)
    n_layers = gen.model.cfg.llm.num_layers
    if slice_launches["decode"] or slice_launches["decode_int8"] % n_layers or \
            not slice_launches["int8"] or not slice_launches["int8_prequant"]:
        raise AssertionError(f"11: not the int8-KV path's kernels: {slice_launches}")
    head_launches, head = phase_headline(gen, items, "11 int8-kv headline", "decode_int8")
    add_counts(launches, head_launches)
    add_counts(launches, phase_kv8_beam(gen, image_bytes))
    log(f"[11 int8-kv] decode kernel #5: {slice_launches['decode_int8'] // n_layers} steps x "
        f"{n_layers} launches in the slice, {head_launches['decode_int8']} in the headline, "
        f"#4 {slice_launches['decode'] + head_launches['decode']}")
    for key, name in (("facts_s", "autocheck facts/s"), ("diverse_tok_s", "diverse_gen tok/s"),
                      ("greedy_tok_s", "greedy_gen tok/s"), ("peak_gb", "slice peak GiB")):
        log(f"[11 int8-kv] {name}: int8-KV {rates[key]:.2f} vs phase 4 bf16 {bf16[key]:.2f}")
    for key, name in (("tok_s", "tok/s"), ("decode_tok_s", "decode tok/s"),
                      ("prefill_s", "prefill s"), ("peak_gb", "peak GiB")):
        log(f"[11 int8-kv] headline {name}: int8-KV {head[key]:.2f} vs bf16 {bf16_head[key]:.2f}")
    phase_int8_kv_vs_plain(gen, image_bytes)
    return launches, dict(rates, **{f"head_{k}": v for k, v in head.items()})


# 12 against its plain routes, on greedy_gen's 4 prompts and 4 forced
# tokens. Each step's kernel #16 against fused_decode_step_ref on the same
# cache (the kernel's cache carried forward): 3g's 32-layer drift through
# the model's activations, read 0.085 of max|logit| and a least row cosine
# of 0.9957, where the twin against itself with x one ulp up reads 0.137 and
# 0.987 (H100 80GB HBM3, PERF.md section 6); held to FUSED_LOGIT_REL_TOL and
# FUSED_LOGIT_COS_MIN. Against phase 11's eager int8-KV path (a different
# function: fp32 residual, the activations quantised per head and per
# I-block, the fresh column unquantised; read 0.226 and 0.976), gross faults
# only: phase 11's bounds
FUSED_LOGIT_REL_TOL = 0.3
FUSED_LOGIT_COS_MIN = 0.95


def _fused_forced(eng: DecodeEngine, prompts, starts, images, tokens: torch.Tensor,
                  spans=None) -> tuple:
    """The fused engine's prefill, then one fused step for each column of
    `tokens`, each through kernel #16, through the twin on the same cache
    and through the twin with x one ulp up -> fp32 logits (1 + steps, B, V)
    of the three (the prefill's first in each); the kernel's fresh k/v go
    into the cache. spans as in _forced_logits."""
    cfg = eng.llm.cfg
    Lp, ids, mask, starts = _padded(eng, prompts, starts)
    max_len = -(-(Lp + 64) // 128) * 128
    d = fd.default_dims(cfg, max_len)
    with torch.inference_mode():
        first, cache, cmask = eng._fused_prefill(ids, mask, eng._device_images(images), starts,
                                                 max_len,
                                                 spans=_padded_spans(eng, prompts, spans, Lp))
        kern, twin, spread = [first.float()], [first.float()], [first.float()]
        plen = mask.sum(dim=1)
        for t in range(tokens.shape[1]):
            cmask[:, Lp + t] = 1
            x = eng.llm.embed(tokens[:, t:t + 1])[:, 0].float()
            rest = (cmask, plen + t, Lp + t, d)
            # the twin cuts the cache blocks as the kernel's plan does
            kw = dict(rope_theta=cfg.rope_theta,
                      attn_splits=fd.fused_plan(d, x.shape[0], Lp + t).attn_splits)
            x_k, kv = fd.fused_decode_step(eng._fused_stacked, cache, x, *rest,
                                           rope_theta=cfg.rope_theta)
            x_r, _ = fd.fused_decode_step_ref(eng._fused_stacked, cache, x, *rest, **kw)
            x_p, _ = fd.fused_decode_step_ref(eng._fused_stacked, cache,
                                              torch.nextafter(x, torch.full_like(x, math.inf)),
                                              *rest, **kw)
            for out, xo in ((kern, x_k), (twin, x_r), (spread, x_p)):
                out.append(eng._head(xo).float())
            fd.scatter_new_kv(cache, kv, Lp + t)
    return torch.stack(kern), torch.stack(twin), torch.stack(spread)


def _step_ms(eng, B: int, L: int, ci: int) -> float:
    """One decode step of `eng` (embed, the layers, the head) at batch B, a
    cache of L columns and cache_index ci, the cache zero and the mask live
    up to ci: CUDA-event median of 10."""
    cfg = eng.llm.cfg
    cache = (fd.init_stacked_cache(cfg, B, L, "cuda") if eng.fused_decode
             else eng.llm.init_cache(B, L))
    mask = torch.zeros((B, L), dtype=torch.int32, device="cuda")
    mask[:, :ci + 1] = 1
    tok = torch.full((B,), 5, dtype=torch.int64, device="cuda")
    pos = torch.full((B,), ci, dtype=torch.int64, device="cuda")
    with torch.inference_mode():
        t = time_ms(lambda: eng._step(tok, mask, pos, cache, ci), 10)
    del cache
    return t


def phase_fused(gen: Llava15Generator, image_bytes: bytes, eager: dict) -> tuple:
    """12: phase 11's quantised, fused int8-KV model served through the
    fused engine (kernel #16 on every decode step): the eager path's forced
    logits and step time first (stacking consumes the per-layer weights),
    memory before and after stacking, phase 11's workloads and the
    batch-24 headline with every launch counted, then the forced logits of
    the kernel against the twin and against the eager path -> (launches,
    the fused generator)."""
    prompts, starts, images = gen._prepare(_items(image_bytes, [
        "What is in the image?", "Describe the scene.", "What colors do you see?",
        "Is it daytime?"]))
    tokens = torch.randint(10, min(300, gen.engine.vocab_size), (4, 4),
                           generator=torch.Generator().manual_seed(0)).cuda()
    eager_logits = _forced_logits(gen.engine, prompts, starts, images, tokens,
                                  ("auto", "auto"))
    B, L, ci = HEADLINE_B, 1024, 960
    eager_ms = _step_ms(gen.engine, B, L, ci)
    layer = gen.model.llm.model.layers[0]
    layer_bytes = sum(m.q.numel() + 4 * m.scale.numel() for m in (
        layer.attn.qkv_proj, layer.attn.o_proj, layer.mlp.gate_up_proj, layer.mlp.down_proj))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fgen = Llava15Generator(gen.model, gen.tokenizer, gen.num_patches,
                            image_size=gen.model.cfg.vision.image_size,
                            checkpoint_name=gen.checkpoint_name, fused_decode=True)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    stack_peak = torch.cuda.max_memory_allocated()
    GiB = 2 ** 30
    log(f"[12 fused] stacked the LLM's weights in place in {time.perf_counter() - t0:.1f} s: "
        f"{before / GiB:.3f} GiB in use before, {after / GiB:.3f} after ({(after - before) / 2 ** 20:+.1f}"
        f" MiB; one layer's weights and scales {layer_bytes / 2 ** 20:.1f} MiB; the zero "
        f"padding of I to Ip included), {stack_peak / GiB:.3f} GiB peak while stacking")
    if abs(after - before) > layer_bytes:
        raise AssertionError("12: stacking did not replace the per-layer weights in place")
    fused_ms = _step_ms(fgen.engine, B, L, ci)
    log(f"[12 fused] one decode step (embed, {gen.model.cfg.llm.num_layers} layers, the head) at B={B} L={L} "
        f"cache_index={ci}: fused {fused_ms:.3f} ms vs phase 11's eager int8-KV step "
        f"{eager_ms:.3f} ms ({eager_ms / fused_ms:.2f}x)")

    # the engine's decode steps, counted beside the launch counters (and
    # reset with them): #16 must launch once a step and #4, #5, #7 never
    spy, step = types.SimpleNamespace(steps=0), fgen.engine._step

    def counted(*a):
        spy.steps += 1
        return step(*a)

    fgen.engine._step, COUNTERS["steps"] = counted, (spy, "steps")
    try:
        launches, rates = phase_slice(fgen, image_bytes, "12 fused", "fused", per_step=1)
        head_launches, head = phase_headline(fgen, _headline_items(fgen, image_bytes),
                                             "12 fused headline", "fused", per_step=1)
    finally:
        fgen.engine._step = step
        del COUNTERS["steps"]
    decode_free = ("decode", "decode_int8", "int8")
    for run in (launches, head_launches):
        if run.pop("steps") != run["fused"] or any(run[k] for k in decode_free) \
                or not run["int8_prequant"]:
            raise AssertionError(f"12: #16 launches against the decode steps, or a per-layer "
                                 f"decode kernel ran: {run}")
    add_counts(launches, head_launches)
    log(f"[12 fused] #16 launches = decode steps: {launches['fused'] - head_launches['fused']} "
        f"in the slice, {head_launches['fused']} in the headline; #4, #5 and #7 "
        f"{sum(launches[k] for k in decode_free)}; the prefill's #9 {launches['int8_prequant']}, "
        f"flash {launches['flash']}")
    for key, name in (("facts_s", "autocheck facts/s"), ("diverse_tok_s", "diverse_gen tok/s"),
                      ("greedy_tok_s", "greedy_gen tok/s"), ("peak_gb", "slice peak GiB")):
        log(f"[12 fused] {name}: fused {rates[key]:.2f} vs phase 11 eager int8-KV {eager[key]:.2f}")
    for key, name in (("tok_s", "tok/s"), ("decode_tok_s", "decode tok/s"),
                      ("prefill_s", "prefill s"), ("peak_gb", "peak GiB")):
        log(f"[12 fused] headline {name}: fused {head[key]:.2f} vs eager int8-KV "
            f"{eager['head_' + key]:.2f}")

    kern, twin, spread = _fused_forced(fgen.engine, prompts, starts, images, tokens)
    assert all(bool(torch.isfinite(r).all()) for r in (kern, twin, spread, eager_logits))
    rel, cos = _logit_gap(spread[1:], twin[1:])
    log(f"[12 fused vs plain] the twin against itself with each step's x one ulp up: max|d| / "
        f"max|ref| {rel:.4f}, least row cosine {cos:.5f} (the 32-layer drift of 3g)")
    checks = [("prefill: the fused tower vs phase 11's per-layer prefill", kern[:1],
               eager_logits[:1], INT8_KV_REL_TOL, INT8_KV_COS_MIN),
              ("decode steps 1-4: kernel #16 vs the twin on the same cache", kern[1:], twin[1:],
               FUSED_LOGIT_REL_TOL, FUSED_LOGIT_COS_MIN),
              ("decode steps 1-4: the fused path vs phase 11's eager int8-KV path", kern[1:],
               eager_logits[1:], INT8_KV_REL_TOL, INT8_KV_COS_MIN)]
    ok = True
    for text, a, b, rel_tol, cos_min in checks:
        rel, cos = _logit_gap(a, b)
        good = rel <= rel_tol and cos >= cos_min
        ok = ok and good
        log(f"[12 fused vs plain] {text}: max|d| / max|ref| {rel:.4f} (tol {rel_tol}), least "
            f"row cosine {cos:.5f} (tol {cos_min}) | {'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError("the fused path disagrees with its plain routes")
    return launches, fgen


# 13: the RLAIF-V feedback pipeline (rlaifv_tpu_torch.pipeline.run_pipeline)
# on the card: phase 12's fused LLaVA generator as the generator and the
# labeler, Llama3-8B (full width and depth, bf16, random weights from seed 0)
# as the divide and changeq backends, with the reference's sampling (T 0.2,
# top-p 0.9, 256 new tokens). The fake tokenizer decodes only ids 10-299,
# so each seeded random head keeps the rows of printable characters (and
# the newline that separates facts), scaled up by HEAD_GAIN, and has the
# others zeroed: samples then decode to text, so the fact lists and the
# yes/no questions are not empty. A random row's logit has a std of ~1.3 at
# hidden 4096 (0.02 x |ln_f(h)| ~ 64), so zeroing alone leaves the ~128k
# (or ~32k) zeroed logits of 0 most of the mass; x3 puts the largest of the
# 96 kept logits ~10 above them, which at T 0.7 still leaves the diverse
# answers to one question room to differ (a pair needs two answers that
# score apart, and pairs/length_filter.py raises on an empty pair list, as
# the JAX module does).
PIPE_QUESTIONS = ["What is in the image?", "Describe the scene.", "What colors do you see?",
                  "Is it daytime?"]
PIPE_REPEAT = 4  # answers a question: 16 answers, two batches of each backend
PIPE_MAX_TOKENS = 64  # the diverse-gen answers
PIPE_BATCH = 8
PIPE_NEW_TOKENS = 256  # the reference's divide/changeq budget (make_llama3_backend)
HEAD_GAIN = 3.0


def printable_ids(tok) -> list:
    """The fake tokenizer's ids of printable ASCII (space to '~') and the
    newline."""
    return sorted({tok.convert_tokens_to_ids(c) for c in "\n" + "".join(
        chr(i) for i in range(32, 127))})


@torch.no_grad()
def shape_head_(weight: torch.Tensor, keep: list) -> None:
    """Scale the head rows (vocabulary ids) in `keep` by HEAD_GAIN and zero
    the others, in place."""
    rows = torch.ones(weight.shape[0], dtype=torch.bool, device=weight.device)
    rows[torch.as_tensor(keep, device=weight.device)] = False
    weight[rows] = 0
    weight[~rows] *= HEAD_GAIN


def _divide_prompt_bucket(tok) -> int:
    """generate's prompt bucket (64) of the longest divide prompt phase 13
    can build: the longest question with a PIPE_MAX_TOKENS-character answer
    (one token a character)."""
    longest = max(PIPE_QUESTIONS, key=len)
    text = tok.apply_chat_template(dcq.divide_messages(
        {"question": longest, "answer": "x" * PIPE_MAX_TOKENS}), tokenize=False,
        add_generation_prompt=True)
    return -(-len(tok(text).input_ids) // 64) * 64


class BackendMeter:
    """Wraps a DecodeEngine's generate and _step (instance attributes): the
    tokens generated, the seconds (synchronised), the decode steps, the peak
    device memory and the growth of every launch counter over the engine's
    own calls, and each call's prefill rows."""

    def __init__(self, engine: DecodeEngine):
        self.tokens, self.seconds, self.steps, self.peak = 0, 0.0, 0, 0
        self.launches, self.prefill_rows = {}, []
        generate, step = engine.generate, engine._step

        def metered(prompts, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before, t0 = read_counts(), time.perf_counter()
            res = generate(prompts, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.tokens += int(res.lengths.sum())
            self.peak = max(self.peak, torch.cuda.max_memory_allocated())
            add_counts(self.launches, {k: v - before[k] for k, v in read_counts().items()})
            self.prefill_rows.append(len(prompts) * (-(-max(map(len, prompts)) // 64) * 64))
            return res

        def counted(*a):
            self.steps += 1
            return step(*a)

        engine.generate, engine._step = metered, counted

    def rates(self) -> str:
        return (f"{self.tokens} tokens in {self.seconds:.2f} s = {self.tokens / self.seconds:.1f} "
                f"tok/s (prefill included), {self.steps} decode steps, prefill rows "
                f"{self.prefill_rows}, peak {self.peak / 2 ** 30:.2f} GiB")


def build_llama3(tok, tag: str = "13 pipeline") -> LlamaForCausalLM:
    """Llama3-8B at full width and depth in bf16 on the card, random weights
    from seed 0, its head shaped to the fake tokenizer's printable ids."""
    t0 = time.perf_counter()
    cfg = LlamaConfig.llama3_8b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="meta").to_empty(device="cuda")
    init_weights_(model, torch.Generator(device="cuda").manual_seed(0)).eval()
    shape_head_(model.lm_head.weight, printable_ids(tok))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"[{tag}] Llama3-8B bf16 on cuda: {n / 1e9:.3f} B params (vocab {cfg.vocab_size}, "
        f"I {cfg.intermediate_size}, {cfg.num_kv_heads} KV heads for {cfg.num_heads}, rope theta "
        f"{cfg.rope_theta:g}), {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, built "
        f"in {time.perf_counter() - t0:.1f} s; random weights (seed 0), the head's rows of "
        f"{len(printable_ids(tok))} printable ids x{HEAD_GAIN:g}, the others zeroed")
    return model


def _stage_files(ans_dir: str) -> dict:
    """Every file the pipeline wrote -> its rows."""
    return {n: read_jsonlines(os.path.join(ans_dir, n)) for n in sorted(os.listdir(ans_dir))}


def phase_pipeline(fgen: Llava15Generator, tok, work: str) -> dict:
    """13: run_pipeline end to end (phase 12's fused generator, the bf16
    Llama3-8B backend) in `work` (kept for phase 16e), the same model
    quantised in place to int8 and then stacked for fused decode on one
    divide batch, and the logit checks -> the launches of its runs."""
    shape_head_(fgen.model.llm.lm_head.weight, printable_ids(tok))
    log(f"[13 pipeline] phase 12's fused LLaVA generator serves as the generator and the "
        f"labeler; its head shaped the same way")
    model = build_llama3(tok)
    bf16_fn, tmpl = dcq.llama3_backend(model, tok, max_new_tokens=PIPE_NEW_TOKENS)
    meter = BackendMeter(bf16_fn.engine)
    launches = {}
    ques = os.path.join(work, "questions.jsonl")
    image_path = str(ROOT / "examples" / "test.jpeg")
    write_jsonlines(ques, [{"question": q, "image_path": image_path,
                            "ds_question_id": f"q{i}",
                            "metainfos": {"ds_question_id": f"q{i}"}}
                           for i, q in enumerate(PIPE_QUESTIONS)])
    ans_dir = os.path.join(work, "results")
    reset_counts()
    t0 = time.perf_counter()
    out = pipe.run_pipeline(fgen, fgen, (bf16_fn, tmpl), (bf16_fn, tmpl), ques, ans_dir,
                            repeat=PIPE_REPEAT, batch_size=PIPE_BATCH,
                            max_tokens=PIPE_MAX_TOKENS, sample_num=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    add_counts(launches, read_counts())
    files = _stage_files(ans_dir)
    for name, rows in files.items():
        log(f"[13 pipeline] {name}: {len(rows)} rows")
    divide = next(rows for n, rows in files.items() if n.endswith(".llama3-8b_divide.jsonl"))
    # the divide stage's questions (the labeler's output also ends in
    # .gq.qas.jsonl, under the autocheck_ prefix), as 16e picks them
    qas = next(rows for n, rows in files.items()
               if n.endswith(".gq.qas.jsonl") and not n.startswith("autocheck_"))
    pairs = next(rows for n, rows in files.items() if n.endswith(".pair_diff1.jsonl"))
    n_facts = sum(len(r["facts"]) for r in divide)
    log(f"[13 pipeline] run_pipeline in {wall:.1f} s -> {os.path.basename(out)}: "
        f"{len(divide)} answers, {n_facts} facts, {len(qas)} yes/no questions, {len(pairs)} "
        f"pairs, {len(files[os.path.basename(out)])} after the length balance")
    if not (n_facts > 0 and qas and out.endswith("_pair_diff1_samp2_balanceshort.jsonl")):
        raise AssertionError("13: the pipeline produced no facts or no yes/no questions")
    # generate's bf16 prefill runs over the cache's first Lp columns (square:
    # #1, a layer a prefill); #1 also serves the fresh-window prefills of the
    # int8 and fused backends below (and phase 12's fused LLaVA prefills)
    log(f"[13 pipeline] the bf16 Llama3-8B backend: {meter.rates()} | launches in its calls: "
        f"decode #4 {meter.launches['decode']} ({meter.steps} steps x {model.cfg.num_layers} "
        f"layers = {meter.steps * model.cfg.num_layers}), flash #1 {meter.launches['flash']} "
        f"(the prefills, square); the whole pipeline: {launches}")
    if meter.launches["decode"] != meter.steps * model.cfg.num_layers:
        raise AssertionError(f"13: the bf16 backend did not run #4 a layer a step: "
                             f"{meter.launches}")

    # step 2: the same model quantised in place (int8, head bf16, fused, int8
    # KV), then stacked for fused decode, on one divide batch
    rows = divide[:PIPE_BATCH]
    prompts = [tmpl(dcq.divide_messages(r)) for r in rows]
    int8_fn, _ = dcq.llama3_backend(model, tok, int8=True, max_new_tokens=PIPE_NEW_TOKENS)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    m8 = BackendMeter(int8_fn.engine)
    reset_counts()
    int8_fn(prompts)
    add_counts(launches, read_counts())
    n_layers = model.cfg.num_layers
    log(f"[13 pipeline] --llm-int8 backend, one divide batch: {m8.rates()} | #9 "
        f"{m8.launches['int8_prequant']} (prefill), #1 {m8.launches['flash']} (the prefill's "
        f"fresh window), #7 {m8.launches['int8']} (decode rows), #5 {m8.launches['decode_int8']} "
        f"({m8.steps} steps x {n_layers}), #4 {m8.launches['decode']}")
    if not (m8.launches["int8_prequant"] and m8.launches["int8"] and m8.launches["flash"]) \
            or m8.launches["decode"] or m8.launches["decode_int8"] != m8.steps * n_layers:
        raise AssertionError(f"13: the int8 backend's kernels: {m8.launches}")

    # step 3a, before stacking consumes the per-layer weights: the int8
    # route against attn_impl "dense" on the prefill and 4 forced steps
    tok_ids = [tok(p).input_ids for p in prompts[:4]]
    keep = printable_ids(tok)
    forced = torch.as_tensor(keep, device="cuda")[torch.randint(
        len(keep), (4, 4), generator=torch.Generator().manual_seed(0)).cuda()]
    route = _forced_logits(int8_fn.engine, tok_ids, None, None, forced, ("auto", "auto"))
    dense = _forced_logits(int8_fn.engine, tok_ids, None, None, forced, ("dense", "dense"))
    ok = bool(torch.isfinite(route).all() and torch.isfinite(dense).all())
    for text, a, b in (("prefill: the int8 route (fresh-window flash) vs attn_impl dense",
                        route[:1], dense[:1]),
                       ("decode steps 1-4: the int8 route (#5) vs the dense dequantised formula",
                        route[1:], dense[1:])):
        rel, cos = _logit_gap(a, b)
        good = rel <= INT8_KV_REL_TOL and cos >= INT8_KV_COS_MIN
        ok = ok and good
        log(f"[13 vs plain] {text}: max|d| / max|ref| {rel:.4f} (tol {INT8_KV_REL_TOL}), least "
            f"row cosine {cos:.5f} (tol {INT8_KV_COS_MIN}) | {'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError("13: the int8 route disagrees with attn_impl dense")

    layer = model.model.layers[0]
    layer_bytes = sum(m.q.numel() + 4 * m.scale.numel() for m in (
        layer.attn.qkv_proj, layer.attn.o_proj, layer.mlp.gate_up_proj, layer.mlp.down_proj))
    int8_rate = m8.tokens / m8.seconds
    del int8_fn, m8
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fused_fn, _ = dcq.llama3_backend(model, tok, fused_decode=True,
                                     max_new_tokens=PIPE_NEW_TOKENS)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    log(f"[13 pipeline] --llm-fused-decode: stacked in place, {before / 2 ** 30:.3f} GiB in use "
        f"before, {after / 2 ** 30:.3f} after ({(after - before) / 2 ** 20:+.1f} MiB; one layer's "
        f"weights and scales {layer_bytes / 2 ** 20:.1f} MiB)")
    if abs(after - before) > layer_bytes:
        raise AssertionError("13: stacking did not replace the per-layer weights in place")
    mf = BackendMeter(fused_fn.engine)
    reset_counts()
    fused_fn(prompts)
    add_counts(launches, read_counts())
    log(f"[13 pipeline] --llm-fused-decode backend, the same batch: {mf.rates()} | #16 "
        f"{mf.launches['fused']} = {mf.steps} decode steps; #4 {mf.launches['decode']}, #5 "
        f"{mf.launches['decode_int8']}, #7 {mf.launches['int8']}; the prefill's #9 "
        f"{mf.launches['int8_prequant']} and #1 {mf.launches['flash']}")
    if mf.launches["fused"] != mf.steps or not mf.launches["flash"] or \
            any(mf.launches[k] for k in ("decode", "decode_int8", "int8")):
        raise AssertionError(f"13: the fused backend's kernels: {mf.launches}")
    log(f"[13 pipeline] tok/s (prefill included, {PIPE_BATCH}-row batches of "
        f"{PIPE_NEW_TOKENS} new tokens): bf16 {meter.tokens / meter.seconds:.1f} (step 1), int8 "
        f"{int8_rate:.1f}, fused {mf.tokens / mf.seconds:.1f}")

    # step 3b: each fused step's #16 against its twin on the same cache
    kern, twin, spread = _fused_forced(fused_fn.engine, tok_ids, None, None, forced)
    ok = all(bool(torch.isfinite(r).all()) for r in (kern, twin, spread))
    rel, cos = _logit_gap(spread[1:], twin[1:])
    log(f"[13 vs plain] the twin against itself with each step's x one ulp up: max|d| / max|ref| "
        f"{rel:.4f}, least row cosine {cos:.5f}")
    rel, cos = _logit_gap(kern[1:], twin[1:])
    good = ok and rel <= FUSED_LOGIT_REL_TOL and cos >= FUSED_LOGIT_COS_MIN
    log(f"[13 vs plain] decode steps 1-4: kernel #16 vs the twin on the same cache: max|d| / "
        f"max|ref| {rel:.4f} (tol {FUSED_LOGIT_REL_TOL}), least row cosine {cos:.5f} (tol "
        f"{FUSED_LOGIT_COS_MIN}) | {'ok' if good else 'FAIL'}")
    if not good:
        raise AssertionError("13: kernel #16 disagrees with its twin at Llama3-8B")
    del fused_fn, model
    return launches


def _text(rng, k: int) -> str:
    chars = np.asarray(list("abcdefghijklmnopqrstuvwxyz     "))
    return "q" + "".join(rng.choice(chars, k - 2)) + "e"


def _raw_row(idx: str, question: str, chosen: str, rejected: str,
             image_bytes: bytes) -> dict:
    return {"idx": idx, "question": question, "chosen": chosen, "rejected": rejected,
            "image": {"bytes": image_bytes, "path": "test.jpeg"},
            "image_path": "test.jpeg", "origin_dataset": "chip_smoke",
            "origin_split": "{}"}


def synth_rows(image_bytes: bytes, n: int = 16) -> list:
    """n raw RLAIF-V rows (question, chosen, rejected, image) at the train
    pair's geometry: with the character-level tokenizer a 24-token question
    and answers of 224-256 (chosen) and 160-224 (rejected) tokens after the
    llava_v1 system prompt and the image's 576 slots; random letters and
    spaces, seeded; every row on examples/test.jpeg."""
    rng = np.random.default_rng(0)
    return [_raw_row(str(i), _text(rng, 24), _text(rng, int(rng.integers(224, 257))),
                     _text(rng, int(rng.integers(160, 225))), image_bytes)
            for i in range(n)]


def short_row(image_bytes: bytes) -> dict:
    """9's short pair: an 8-token question and answers of 10 and 8 tokens,
    so that its suffix past the image (question, the assistant tag, the
    answer), trimmed to the labels, has fewer rows (two of W tokens) than
    INT8_DEQUANT_MIN_M."""
    rng = np.random.default_rng(1)
    return _raw_row("short", _text(rng, 8), _text(rng, 10), _text(rng, 8), image_bytes)


def preference_items(rows: list, tok, cfg: LlavaConfig, logps=None) -> list:
    """The (rej, win) items DPODataset._get_one builds from parquet rows and
    their reference logps, built in memory (no parquet on this path)."""
    spec = get_family("llava15")
    mm_cfg = spec.mm_cfg(ClipImageProcessor(image_size=cfg.vision.image_size),
                         cfg.num_image_tokens)
    items = _encode_rows(rows, tok, mm_cfg, spec.preprocess_func)
    for (rej, win), lp in zip(items, logps or []):
        win["ref_win_logp"], win["ref_win_avg_logp"], win["ref_win_per_token_logp"] = lp[:3]
        rej["ref_rej_logp"], rej["ref_rej_avg_logp"], rej["ref_rej_per_token_logp"] = lp[3:]
    return items


def train_collator(tok, cfg: LlavaConfig, beta: float) -> DPOCollator:
    """train.py's collator at max_len 2048 (DPOCollator's default bucket:
    the batch pads to the next multiple of 256 tokens)."""
    return DPOCollator(pad_token_id=tok.pad_token_id, max_len=2048,
                       num_patches=cfg.num_image_tokens, beta=beta,
                       **get_family("llava15").collator_kwargs(tok))


def collate_train_pair(items: list, tok, cfg: LlavaConfig) -> dict:
    """6, data: configs/llava15_dpo.json's training settings (one pair a
    step, max_len 2048, shared_prefix_len -1, lm_head_impl "auto"); the
    first row's pair collated as train.py collates it (DPOCollator's default
    bucket: the batch pads to the next multiple of 256 tokens) and its shared
    prefix derived from the batch."""
    t = Config.from_json(str(ROOT / "configs" / "llava15_dpo.json")).training
    assert t.shared_prefix_len == -1 and t.per_device_batch_pairs == 1
    assert getattr(t, "lm_head_impl", "auto") == "auto"
    batch_np = train_collator(tok, cfg, t.dpo_beta)(items[:1])
    P = derive_shared_prefix_len(batch_np, cfg.num_image_tokens)
    validate_shared_prefix(batch_np, P, cfg.num_image_tokens)
    return dict(batch_np=batch_np, P=P, training=t)


def build_model(cfg: LlavaConfig, tag: str = "8 ref-logp", device: str = "cuda"):
    """The model of `cfg` (LLaVA-1.5-7B with remat here), random weights
    from seed 0: the frozen starting policy of phase 8, the policy of 6 and,
    built again, the base that 9 quantises."""
    t0 = time.perf_counter()
    model = LlavaForCausalLM(cfg, device="meta").to_empty(device=device)
    init_weights_(model, torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[{tag}] LLaVA-1.5-7B {str(cfg.llm.dtype).split('.')[-1]}, remat "
        f"{'on' if cfg.llm.remat else 'off'}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def _seq_close(a: list, b: list, rtol: float) -> tuple:
    """(max relative difference of the sums and means, mean |difference| of
    the per-token logps, max of it) between two row lists of one layout."""
    rel, tok_mean, tok_max = 0.0, 0.0, 0.0
    for ra, rb in zip(a, b):
        for k in (0, 1, 3, 4):
            rel = max(rel, abs(ra[k] - rb[k]) / abs(rb[k]))
        for k in (2, 5):
            assert len(ra[k]) == len(rb[k]), "per-token layouts differ"
            d = np.abs(np.asarray(ra[k]) - np.asarray(rb[k]))
            tok_mean, tok_max = max(tok_mean, float(d.mean())), max(tok_max, float(d.max()))
    return rel, tok_mean, tok_max


def phase_ref_logp(model, tok, rows: list, cfg: LlavaConfig, keep: dict = None) -> tuple:
    """8: the reference-logp precompute of the rows through the port's
    score_preference_rows three times: the shared-prefix path (the default
    of inference_logp), the plain scorer with the fused head (what rows
    that cannot share take, and what "auto" picks at 7B) and the plain
    scorer with the "xla" head (the comparison, not counted). A spy on
    DecodeEngine.score_pair_logps counts the rows the shared path scored.
    `keep` (a dict) receives the three runs' rows by name."""
    kw = dict(max_len=2048, num_patches=cfg.num_image_tokens, batch_pairs=8,
              image_processor=ClipImageProcessor(image_size=cfg.vision.image_size),
              progress=False)
    spied = []
    orig = DecodeEngine.score_pair_logps

    def spy(self, prefixes, *a, **k):
        spied.append(len(prefixes))
        return orig(self, prefixes, *a, **k)

    DecodeEngine.score_pair_logps = spy
    runs, launches = {}, {}
    try:
        for name, extra in (("shared", dict(shared_prefix=True)),
                            ("fused", dict(lm_head_impl="fused")),
                            ("xla", dict(lm_head_impl="xla"))):
            score_preference_rows(rows[:2], model, tok, **kw, **extra)  # warm-up
            torch.cuda.synchronize()
            spied.clear()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            out = score_preference_rows(rows, model, tok, **kw, **extra)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if name != "xla":  # the comparison's launches do not count
                add_counts(launches, read_counts())
            runs[name] = out
            ok = all(np.isfinite(r[k]) for r in out for k in (0, 1, 3, 4))
            log(f"[8 ref-logp] {name}: {len(rows)} pairs in {dt:.3f} s = "
                f"{len(rows) / dt:.2f} pairs/s | peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | rows through "
                f"the shared-prefix engine {sum(spied)} | logps row 0 "
                f"{out[0][0]:.2f}/{out[0][3]:.2f}")
            if not ok:
                raise AssertionError(f"8: non-finite logps on the {name} path")
            if sum(spied) != (len(rows) if name == "shared" else 0):
                raise AssertionError(f"8: the shared path scored {sum(spied)} of "
                                     f"{len(rows)} rows on the {name} run")
    finally:
        DecodeEngine.score_pair_logps = orig
    ok = True
    for a, b, rtol in (("shared", "fused", LOGP_RTOL), ("fused", "xla", HEAD_LOGP_RTOL)):
        rel, tmean, tmax = _seq_close(runs[a], runs[b], rtol)
        good = rel <= rtol and tmean <= TOKEN_MEAN_TOL
        ok = ok and good
        log(f"[8 ref-logp] {a} vs {b}: sums and means max rel {rel:.3e} (tol {rtol}) | "
            f"per-token |d| mean {tmean:.3e} (tol {TOKEN_MEAN_TOL}) max {tmax:.3e} | "
            f"{'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError("8: the ref-logp paths disagree")
    if launches["head_fwd"] < 1 or launches["flash"] < 2 * cfg.llm.num_layers:
        raise AssertionError(f"8: a kernel of the ref-logp path did not run: {launches}")
    if keep is not None:
        keep.update(runs)
    log(f"[8 ref-logp] launches: flash fwd {launches['flash']}, fused head fwd "
        f"{launches['head_fwd']}")
    return runs["shared"], launches


def build_train(pair: dict, model, device: str = "cuda", tag: str = "6 train") -> dict:
    """6, set-up: the step's hyperparameters and the collated pair with the
    reference logps phase 8 wrote for it."""
    cfg = model.cfg
    t, P, batch_np = pair["training"], pair["P"], pair["batch_np"]
    L = batch_np["input_ids"].shape[1]
    hp = DPOHparams(beta=t.dpo_beta, dpo_use_average=t.dpo_use_average,
                    lm_head_impl=resolve_head(t, cfg.llm.hidden_size, cfg.llm.dtype),
                    shared_prefix_len=P)
    assert hp.lm_head_impl == "fused", hp.lm_head_impl
    batch = batch_to_device(batch_np, device)
    adapter = LlavaDPOAdapter(model)
    model.train()
    # the paired path's rows: the prefix once, each suffix padded to W
    tokens = P + 2 * (L - P)
    real = P + int(batch_np["attention_mask"][:, P:].sum())
    log(f"[{tag}] LLaVA-1.5 bf16 full fine-tune, remat on | "
        f"one pair padded to L={L} (bucket 256), derived P={P} (array "
        f"{-(-P // 128) * 128}), W={L - P}: {tokens} tokens a step, {real} of them "
        f"not padding | head {hp.lm_head_impl} (\"auto\" at hidden "
        f"{cfg.llm.hidden_size}), beta {hp.beta}, constant lr {TRAIN_LR}, weight decay "
        f"{t.weight_decay}, clip {t.max_grad_norm} | reference logps from phase 8 "
        f"{float(batch_np['ref_win_logp'][0]):.3f}/{float(batch_np['ref_rej_logp'][0]):.3f}")
    return dict(model=model, adapter=adapter, batch=batch, hp=hp, tokens=tokens,
                real_tokens=real, training=t)


def param_fingerprint(model) -> str:
    """An exact fingerprint of every parameter's bits: per parameter (whole,
    gathered from its shards on a sharded model) the sum and the
    position-weighted sum of its 16- or 32-bit words in int64 (wrapping),
    taken on the card, hashed in parameter order."""
    import hashlib

    plan = sharding.mesh_plan(model)
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        t = (plan.full_tensor(name, p) if plan else p).detach().contiguous()
        w = t.view(torch.int16 if t.element_size() == 2 else torch.int32).flatten().long()
        pos = torch.arange(1, w.numel() + 1, device=w.device)
        h.update(f"{name}:{int(w.sum())}:{int((w * pos).sum())};".encode())
        del w, pos
    return h.hexdigest()


def train_steps(tr: dict, step, tag: str, n_steps: int = 4) -> dict:
    """`n_steps` steps of `step` on tr's batch: each step's loss, logps,
    grad norm, seconds and launches, the peak memory after step 0."""
    n_layers = tr["model"].cfg.llm.num_layers
    rec = dict(losses=[], logps=[], gnorms=[], times=[], counts=[])
    for i in range(n_steps):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ts = time.perf_counter()
        metrics = step(tr["batch"])
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        rec["times"].append(time.perf_counter() - ts)
        n = read_counts()
        rec["counts"].append(n)
        rec["losses"].append(loss)
        rec["gnorms"].append(gnorm)
        rec["logps"].append((float(metrics["logps_train/chosen"]),
                             float(metrics["logps_train/rejected"])))
        log(f"[{tag}] step {i}: loss {loss:.6e} grad_norm {gnorm:.4e} | "
            f"{rec['times'][-1]:.3f} s | flash launches fwd {n['flash']} bwd dq {n['dq']} "
            f"dk/dv {n['dkv']} | fused head fwd {n['head_fwd']} dl {n['head_dl']} "
            f"dx {n['head_dx']} dW {n['head_dw']}" + (f" | policy logps {rec['logps'][0][0]:.3f}"
                                     f"/{rec['logps'][0][1]:.3f}" if i == 0 else ""))
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"{tag}: non-finite loss or grad norm at step {i}")
        if min(n["flash"], n["dq"], n["dkv"]) < n_layers or \
                min(n["head_fwd"], n["head_dl"], n["head_dx"], n["head_dw"]) < 1:
            raise AssertionError(f"{tag}: a kernel of the train path did not run: {n}")
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["step_s"] = statistics.mean(rec["times"][1:]) if n_steps > 1 else rec["times"][0]
    return rec


def phase_train(tr: dict) -> dict:
    """6: four AdamW steps of the full fine-tune on the pair; -> the launches
    and the record 21a holds its sharded steps to (each step's loss, logps,
    grad norm and launches, the parameters' fingerprint after the fourth)."""
    model, t = tr["model"], tr["training"]
    optimizer = make_optimizer(model, TRAIN_LR, total_steps=t.max_steps,
                               warmup_ratio=0.0, weight_decay=t.weight_decay,
                               max_grad_norm=t.max_grad_norm, schedule="constant")
    step = make_dpo_train_step(tr["adapter"], optimizer, tr["hp"])
    rec = train_steps(tr, step, "6 train")
    launches = {}
    for n in rec["counts"]:
        add_counts(launches, n)
    losses, gnorm = rec["losses"], rec["gnorms"][0]
    if abs(losses[0] - math.log(2)) > REF_LN2_TOL or not gnorm > 0:
        raise AssertionError(f"step 0: loss {losses[0]} not within {REF_LN2_TOL} of ln 2 "
                             f"(policy == reference) or grad norm {gnorm} not above 0")
    rec["fingerprint"] = param_fingerprint(model)
    peak_gb, step_s = rec["peak_gib"], rec["step_s"]
    log(f"[6 train] parameters after step 3: fingerprint {rec['fingerprint'][:16]}")
    log(f"[6 train] steps 1-3 (after the warm-up step 0): {step_s:.3f} s a step = "
        f"{1 / step_s:.3f} pairs/s = {tr['tokens'] / step_s:.0f} tokens/s with padding, "
        f"{tr['real_tokens'] / step_s:.0f} without | peak device memory "
        f"{peak_gb:.2f} GiB | loss {losses[0]:.6f} -> {losses[-1]:.3e} "
        f"(step 0 within {REF_LN2_TOL} of ln 2 = {math.log(2):.6f}: "
        f"{losses[0] - math.log(2):+.3e})")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall after 3 updates: {losses}")

    # the same step with the "xla" head on the same optimizer and batch, for
    # the step time and peak memory beside the fused head's (not counted)
    xla_step = make_dpo_train_step(tr["adapter"], optimizer,
                                   dataclasses.replace(tr["hp"], lm_head_impl="xla"))
    torch.cuda.reset_peak_memory_stats()
    xla_times = []
    for _ in range(3):
        ts = time.perf_counter()
        float(xla_step(tr["batch"])["loss"])
        xla_times.append(time.perf_counter() - ts)
    log(f"[6 train] the same step with the \"xla\" head (comparison, after the fused "
        f"steps): {', '.join(f'{t:.3f}' for t in xla_times)} s, mean "
        f"{statistics.mean(xla_times):.3f} s against {step_s:.3f} s fused | peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB against "
        f"{peak_gb:.2f} GiB fused")
    return dict(launches=launches, record=rec)


def train_run(model, adapter, batch, hp, impl: str) -> tuple:
    """One loss and backward with every Llama attention set to `impl` ->
    (loss, (chosen, rejected) logps, the named gradients in fp32, forward
    kernel launches). Holds one full gradient set at a time."""
    params = dict(model.named_parameters())
    last = model.cfg.llm.num_layers - 1
    names = {
        "layer 0 q_proj": "llm.model.layers.0.attn.q_proj.weight",
        f"layer {last} q_proj": f"llm.model.layers.{last}.attn.q_proj.weight",
        # the first readers of the dk/dv kernel's output
        f"layer {last} k_proj": f"llm.model.layers.{last}.attn.k_proj.weight",
        f"layer {last} v_proj": f"llm.model.layers.{last}.attn.v_proj.weight",
        "lm_head": "llm.lm_head.weight",
        "final norm": "llm.model.ln_f.weight",
        "clip patch_embed": "vision_tower.patch_embed.weight",
    }
    attn = [m for m in model.modules() if isinstance(m, LlamaAttention)]
    for m in attn:
        m.attn_impl = impl
    model.zero_grad(set_to_none=True)
    f0 = flash_attention.launches
    loss, metrics = dpo_loss_from_batch(adapter, batch, hp)
    loss.backward()
    grads = {k: params[n].grad.float().clone() for k, n in names.items()}
    model.zero_grad(set_to_none=True)
    for m in attn:
        m.attn_impl = "auto"
    logps = (float(metrics["logps_train/chosen"]), float(metrics["logps_train/rejected"]))
    return float(loss.detach()), logps, grads, flash_attention.launches - f0


def compare_runs(run: tuple, ref: tuple) -> tuple:
    """(|loss - ref loss|, max relative logp difference, {name: (relative
    gradient error ||g - g_ref|| / ||g_ref||, cosine)})."""
    d_logp = max(abs(a - b) / abs(b) for a, b in zip(run[1], ref[1]))
    grads = {}
    for key, g in run[2].items():
        r = ref[2][key]
        grads[key] = (((g - r).norm() / r.norm()).item(),
                      torch.nn.functional.cosine_similarity(g.flatten(), r.flatten(),
                                                            dim=0).item())
    return abs(run[0] - ref[0]), d_logp, grads


def phase_train_vs_plain(model, adapter, batch, hp) -> None:
    """7: paired + flash, plain + flash and plain + dense on one pair with
    the fused head, and paired + flash with the "xla" head, at the weights
    the reference logps came from (loss about ln 2 on the paired path), each
    path's loss, logps and named gradients."""
    plain = dataclasses.replace(hp, shared_prefix_len=0)
    xla = dataclasses.replace(hp, lm_head_impl="xla")
    runs = {"paired+flash": train_run(model, adapter, batch, hp, "auto"),
            "plain+flash": train_run(model, adapter, batch, plain, "auto"),
            "plain+dense": train_run(model, adapter, batch, plain, "dense"),
            "paired+flash xla head": train_run(model, adapter, batch, xla, "auto")}
    ok = runs["plain+dense"][3] == 0 and runs["paired+flash"][3] > 0
    for name, ref_name in (("paired+flash", "plain+dense"), ("plain+flash", "plain+dense"),
                           ("paired+flash", "plain+flash"),
                           ("paired+flash", "paired+flash xla head")):
        (loss, logps, _, n_flash), ref = runs[name], runs[ref_name]
        d_loss, d_logp, grads = compare_runs(runs[name], ref)
        parts = [f"[7 train vs plain] {name} vs {ref_name}: loss {loss:.5f} vs "
                 f"{ref[0]:.5f} (tol {LOSS_TOL}) | logps {logps[0]:.2f}/{logps[1]:.2f} "
                 f"vs {ref[1][0]:.2f}/{ref[1][1]:.2f}, max rel {d_logp:.2e} "
                 f"(tol {LOGP_RTOL}) | flash fwd launches {n_flash}"]
        ok = ok and d_loss <= LOSS_TOL and d_logp <= LOGP_RTOL
        for key, (rel, cos) in grads.items():
            parts.append(f"{key}: rel {rel:.3e} cos {cos:.6f}")
            ok = ok and rel <= GRAD_REL_TOL and cos >= GRAD_COS_MIN
        log(" | ".join(parts) + f" (tol rel {GRAD_REL_TOL}, cos {GRAD_COS_MIN}) | "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the train slice disagrees with its plain paths")


def qlora_batches(rows: list, short, tok, cfg: LlavaConfig, ref=None, bits: int = 8) -> dict:
    """9 and 10, data: configs/llava15_dpo_qlora.json (int8 base, adapters r
    64 / alpha 16, 8 pairs a step, max_len 2048, shared_prefix_len -1; with
    bits 4 the same file with model.quantize_bits set to 4, in memory)
    collated as train.py collates it (DPOCollator's bucket 256): the first 8
    rows as one batch, its shared prefix derived; and, given a short row,
    its pair with the suffix trimmed to the labels (shared_suffix_len W, a
    multiple of 16). `ref`: the reference logps of rows (+ [short]). The
    projections' row counts (prefix 8 Pa, suffix 2 x 8 (L - P), short
    suffix 2 W) follow from the shapes alone, so phases 3d and 3e read them
    before any logps exist."""
    c = Config.from_json(str(ROOT / "configs" / "llava15_dpo_qlora.json"))
    t, n = c.training, cfg.num_image_tokens
    assert c.model.quantize and c.model.quantize_bits == 8 and t.use_lora
    assert t.per_device_batch_pairs == 8 and t.shared_prefix_len == -1
    c.model.quantize_bits = bits
    collator = DPOCollator(pad_token_id=tok.pad_token_id, max_len=c.data.max_len,
                           num_patches=n, beta=t.dpo_beta,
                           **get_family("llava15").collator_kwargs(tok))
    items = preference_items(rows + ([short] if short else []), tok, cfg, ref)
    batch = collator(items[:t.per_device_batch_pairs])
    P = derive_shared_prefix_len(batch, n)
    validate_shared_prefix(batch, P, n)
    B, L = t.per_device_batch_pairs, batch["input_ids"].shape[1]
    out = dict(config=c, batch_np=batch, P=P, m_prefix=B * (-(-P // 128) * 128),
               m_suffix=2 * B * (L - P))
    if not short:
        return out
    sbatch = collator(items[-1:])
    Ps = derive_shared_prefix_len(sbatch, n)
    last = int(np.nonzero((sbatch["labels"] != IGNORE_INDEX).any(axis=0))[0].max()) + 1
    W = -(-(last - Ps) // 16) * 16
    validate_shared_prefix(sbatch, Ps, n, suffix_len=W)
    assert 2 * W < qm.INT8_DEQUANT_MIN_M, (W, qm.INT8_DEQUANT_MIN_M)
    return dict(out, short_np=sbatch, Ps=Ps, W=W, m_short=2 * W)


def int_mm_ms(a: torch.Tensor, b: torch.Tensor, tag: str = "[3d int8]"):
    """torch._int_mm (cuBLASLt, int8 x int8 -> int32) on the same int8
    operands: the library yardstick of the int8 kernels, product only (no
    quantisation, no scales), timed here only; None where it refuses the
    operands (it takes more than 16 rows)."""
    try:
        torch._int_mm(a, b)
    except RuntimeError as e:
        log(f"{tag} torch._int_mm refuses {tuple(a.shape)} x {tuple(b.shape)}: "
            f"{str(e).splitlines()[0][:120]}")
        return None
    return time_ms(lambda: torch._int_mm(a, b))


def int_mm_padded_ms(a: torch.Tensor, b: torch.Tensor) -> float:
    """torch._int_mm on a's rows zero-padded to 32 (it refuses 16 rows or
    fewer): the yardstick where the rows themselves are refused."""
    pad = torch.zeros((32, a.shape[1]), dtype=a.dtype, device=a.device)
    pad[:a.shape[0]] = a
    return time_ms(lambda: torch._int_mm(pad, b))


def route_noise(tag: str, out, dx, deq_out, deq_dx) -> None:
    """One projection's int8 (int4) route against the "dequant" route on
    Gaussian x and dy: the activation-quantisation error of a single
    forward and dx, ~1% of a row's rms for Gaussian rows (a step of
    max|row| / 127, max ~4.5 rms). Phases 9 and 10 read the same noise
    summed over 32 layers."""
    rel = [((a.float() - r.float()).norm() / r.float().norm()).item()
           for a, r in ((out, deq_out), (dx, deq_dx))]
    ok = max(rel) <= ROUTE_REL_TOL
    log(f"{tag} M={out.shape[0]} K={dx.shape[1]} N={out.shape[1]}: kernel route against "
        f"the dequant route, ||d|| / ||dequant||: forward {rel[0]:.3e} dx {rel[1]:.3e} "
        f"(tol {ROUTE_REL_TOL}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: the quantisation error exceeds its bound")


# 3d at the fused widths of phase 11's model (qkv_proj N = 3 x 4096,
# gate_up_proj N = 2 x 11008): the decode rows of diverse_gen and the
# batch-24 headline, and the prefill rows of diverse_gen (one 832-token
# prompt), greedy_gen (4 x 832) and the headline (24 x 896)
FUSED_WIDTHS = ((4096, 12288), (4096, 22016))
FUSED_MS = (10, 24, 832, 4 * 832, 24 * 896)
# phase 13's Llama3-8B: fused qkv (4096 + 2 x 1024 columns), fused gate/up
# (2 x 14336) and down (K 14336); its decode rows (8), and the prefill rows
# of one divide batch: 8 prompts padded to the bucket of the longest
# divide prompt phase 13 can build (PIPE_MAX_TOKENS-character answers)
LLAMA3_WIDTHS = ((4096, 6144), (4096, 28672), (14336, 4096))
# phase 16's EVA02-enormous tower quantised (int8 in 16b, int4 in 16d): qkv
# (1792 -> 3 x 1792), fc1 (1792 -> 15360) and fc2 (15360 -> 1792), at one
# 448 px image's rows (32 x 32 patches + the cls token) and a batch of 8
EVA_WIDTHS = ((1792, 5376), (1792, 15360), (15360, 1792))
EVA_MS = (1025, 8 * 1025)
# phase 17's Mistral-7B projections, unfused: q and o (4096 x 4096), k and v
# (4096 x 1024), gate and up (4096 x 14336), down (14336 x 4096); held bit
# for bit at 17's rows (`omni_ms`), and 17b's int4 EVA02 tower at its 4
# images a step (3e)
MISTRAL_WIDTHS = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
EVA_STEP_M = 4 * 1025
# phase 18's Llama3-8B projections unfused are the same four widths: held bit
# for bit at 18b's decode rows (8) and prefill rows (8 prompts of
# MCV_BENCH_LP, bench_minicpmv_serve's geometry), int8 in 3d and int4 (18d
# autochecks those 8 prompts) in 3e
MCV_MS = (8, 8 * 576)


def omni_ms(rows: list, short: dict, tok) -> tuple:
    """Phase 17's projection rows from the shapes alone (3d and 3e read
    them before 17 runs): the config's 4-pair step's prefix B Pa (P padded
    to a multiple of 128) and suffix 2 B (L - P), the short pair's prefix
    Pa and suffix 2 W."""
    c = Config.from_json(str(ROOT / "configs" / OMNI_QLORA[0][1]))
    qb = omni_batches(rows, short, tok, c)
    B, L = c.training.per_device_batch_pairs, qb["batch_np"]["input_ids"].shape[1]
    return (B * (-(-qb["P"] // 128) * 128), 2 * B * (L - qb["P"]),
            -(-qb["Ps"] // 128) * 128, 2 * qb["W"])


def _exact_cases(tag: str, cases, gen, run) -> None:
    """Each (M, K, N) of `cases` on x, dy from `gen`: run(x, dy, M, K, N)
    -> {name: (the kernel's output, the twin's)}, every pair equal bit for
    bit."""
    for M, K, N in cases:
        x, dy = _randn(gen, M, K), _randn(gen, M, N)
        outs = run(x, dy, M, K, N)
        torch.cuda.synchronize()
        bad = {k: (a.float() - b.float()).abs().max().item() for k, (a, b) in outs.items()
               if not torch.equal(a, b)}
        log(f"{tag} M={M} K={K} N={N}: " + ", ".join(outs) + " equal to the twin bit for bit "
            f"| {'ok' if not bad else f'FAIL {bad}'}")
        if bad:
            raise AssertionError(f"{tag}: kernels disagree with the twins at M={M} K={K} "
                                 f"N={N}: {bad}")


def _exact_int8(name: str, ms, gen) -> None:
    """3d: #7-#10 and the prequant wrappers bit for bit against the twins at
    MISTRAL_WIDTHS and the rows `ms`, weights and inputs from `gen`."""
    for K, N in MISTRAL_WIDTHS:
        q, s = quantize_kernel_int8_torch(0.02 * torch.randn(K, N, generator=gen, device="cuda"))

        def run(x, dy, M, K, N):
            xq, sx = qm.quantize_rows(x.float())
            dyq, sy = qm.quantize_rows(dy.float() * s)
            fwd, dx = qm.int8_matmul_plain(x, q, s), qm.int8_matmul_dx_plain(dy, q, s)
            return {"#7": (qm._kernel_fwd(x, q, s), fwd),
                    "#9": (qm._kernel_prequant(xq, sx.reshape(-1), q, s), fwd),
                    "int8_matmul_prequant": (qm.int8_matmul_prequant(x, q, s), fwd),
                    "#8": (qm._kernel_dx(dy, q, s), dx),
                    "#10": (qm._kernel_dx_prequant(dyq, sy.reshape(-1), q), dx),
                    "int8_matmul_dx_prequant": (qm.int8_matmul_dx_prequant(dy, q, s), dx)}

        _exact_cases(f"[3d int8] {name}", [(M, K, N) for M in ms], gen, run)
        del q, s


def llama3_ms() -> tuple:
    return (8, 64, 128, PIPE_BATCH * _divide_prompt_bucket(_fake_tokenizer()))


# 3d / 3e: planted faults in the redesigned dx kernels, each a broken copy of
# one source (build_variants) that must break the bit-exact check
DX8_FAULTS = {
    "one contraction slice dropped": [(
        "quant_matmul.cu", "    for (int s = 0; s < split; ++s) acc += part[s * MK + e];",
        "    for (int s = 1; s < split; ++s) acc += part[s * MK + e];")],
    "sy taken from the next row": [(
        "quant_matmul.cu", "sy[e / K]));", "sy[(e / K + 1) % M]));")],
}
# 3d: planted faults in #7's split product (qfwd), on a case whose K
# contraction is split (FWD7_FAULT_CASE: 4 slices on 132 SMs)
FWD7_FAULTS = {
    "#7: one K slice dropped": [(
        "quant_matmul.cu", "qdx::slice_range(slice, split, (K + TK - 1) / TK, c0, c1);",
        "qdx::slice_range(slice, split, (K + TK - 1) / TK, c0, c1);\n"
        "  if (slice == split - 1) c1 = c0;")],
    "#7: sx taken from the next row": [(
        "quant_matmul.cu", "const float rs = sx[row];", "const float rs = sx[(row + 1) % M];")],
    "#7: the column scale read one column off": [(
        "quant_matmul.cu", "for (int e = 0; e < 4; ++e) cs[e] = s[col + e];",
        "for (int e = 0; e < 4; ++e) cs[e] = s[(col + e + 1) % N];")],
}
FWD7_FAULT_CASE = (24, 4096, 4096)  # M, K, N: the o projection at the batch-24 decode rows
# 3d: planted faults in #9's wide tile (qpre::fwd_wide), on the 8-pair
# step's prefix rows at gate/up, from a generator of its own
FWD9_FAULTS = {
    "#9: the last contraction stage dropped": [(
        "quant_matmul.cu", "const int chunks = (K + TK - 1) / TK;",
        "const int chunks = (K + TK - 1) / TK - 1;")],
    "#9: sx taken from the next row": [(
        "quant_matmul.cu", "const float rowscale = sx[m];",
        "const float rowscale = sx[(m + 1) % M];")],
    "#9: the column scale read one column off": [(
        "quant_matmul.cu", "colscale[e] = s[col + e];", "colscale[e] = s[(col + e + 1) % N];")],
}
# 3d: planted faults in #10's wide tile (qdx::dx_wide)
DX10_FAULTS = {
    "#10: the last contraction stage dropped": [(
        "quant_matmul.cu", "const int nc = (N + TC - 1) / TC;",
        "const int nc = (N + TC - 1) / TC - 1;")],
    "#10: sy taken from the wrong row of a tile": [(
        "quant_matmul.cu", "const float row_scale = sy[row];",
        "const float row_scale = sy[row ^ 1];")],
}
DX4_FAULTS = {
    "guard band removed (rint(v r) alone)": [
        ("int4_matmul.cu", "constexpr float BRACKET_LO = 1.0f - 0x1p-20f;",
         "constexpr float BRACKET_LO = 1.0f;"),
        ("int4_matmul.cu", "constexpr float BRACKET_HI = 1.0f + 0x1p-20f;",
         "constexpr float BRACKET_HI = 1.0f;")],
    "sy taken from group j + 1": [(
        "int4_matmul.cu", "amax[(long long)m * J + j0 + ju[u]]",
        "amax[(long long)m * J + (j0 + ju[u] + 1) % J]")],
    "one ring stage skipped (chunk 0 loaded again for chunk 1)": [
        ("int4_matmul.cu", "tma_load(st, &map_dy, c * TC, m0, bar);",
         "tma_load(st, &map_dy, (c == 1 ? 0 : c) * TC, m0, bar);"),
        ("int4_matmul.cu", "tma_load(st + D_BYTES, &map_qp, c * TC, p0, bar);",
         "tma_load(st + D_BYTES, &map_qp, (c == 1 ? 0 : c) * TC, p0, bar);"),
        ("int4_matmul.cu", "tma_load(st + D_BYTES + P_BYTES, &map_gs, c * TC, j0, bar);",
         "tma_load(st + D_BYTES + P_BYTES, &map_gs, (c == 1 ? 0 : c) * TC, j0, bar);")],
}


# 3e: planted faults in the redesigned forward (#11)
FWD4_FAULTS = {
    "gs taken from group g + 1": [(
        "int4_matmul.cu", "tma_load(st + G_OFF, &map_gs, n0, g, bar);",
        "tma_load(st + G_OFF, &map_gs, n0, (g + 1) % J, bar);")],
    "the accumulator not cleared between groups": [(
        "int4_matmul.cu", "keep = i % per_group != 0;", "keep = 1;")],
    "a nibble's sign extension dropped": [(
        "int4_matmul.cu", "hi = o[b] & 0xf0f0f0f0u;", "hi = o[b] & 0x70707070u;")],
}


def tie_case(M: int, N: int, J: int, seed: int) -> tuple:
    """synth.quotient_ties on the card: bf16 dy (M, N), fp32 scales (J, N)
    whose row quotients fall on and next to half-integers (Gaussian rows
    hit few of them; 3e logs what #12 without its guard band does on
    both)."""
    dy, gs = quotient_ties(M, N, J, seed=seed)
    return torch.from_numpy(dy).cuda().to(torch.bfloat16), torch.from_numpy(gs).cuda()


def planted_faults(tag: str, faults: dict, cases: dict) -> None:
    """Build each fault's broken kernels and run its case {name: (fn, args,
    want)} on them: the output must differ from the twin's bits."""
    t0 = time.perf_counter()
    libs = build_variants(faults)
    log(f"{tag} planted faults: {len(libs)} broken variants built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        fn, args, want = cases[name]
        with kernels_from(lib):
            got = fn(*args)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        log(f"{tag} planted fault {name!r}: {n_diff} of {want.numel()} outputs differ from "
            f"the twin | {'caught' if n_diff else 'NOT CAUGHT'}")
        if not n_diff:
            raise AssertionError(f"{tag}: the check misses the planted fault {name!r}")
    return libs


def phase_int8(g, qb: dict) -> dict:
    """3d: the four int8 kernels against their plain twins (max abs
    difference 0; #7 == #9, #8 == #10) at the 7B projection widths, the
    fused ones and Llama3-8B's, with times beside the int8 bound, torch._int_mm and the
    "dequant" route."""
    res = {"err": 0.0}
    ms = sorted({16, 64, 127, 128, qb["m_short"], qb["m_suffix"], qb["m_prefix"]})
    cases = [(K, N, M) for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)) for M in ms]
    cases += [(K, N, M) for K, N in FUSED_WIDTHS for M in FUSED_MS]
    cases += [(K, N, M) for K, N in LLAMA3_WIDTHS for M in llama3_ms()]
    # the N % 16 != 0 case (#10 on rows TMA cannot map), #10's planted
    # faults and the EVA02 widths draw from generators of their own: the
    # phases after 3d keep the inputs the shared generator has always given
    # them (3g's one-layer flip-row bound trips on a few percent of random
    # draws, PERF.md §7)
    own = torch.Generator(device="cuda").manual_seed(1)
    eva = torch.Generator(device="cuda").manual_seed(16)
    for K, N, M, gen in [(*c, g) for c in cases] + [(4096, 1000, 512, own)] + \
            [(K, N, M, eva) for K, N in EVA_WIDTHS for M in EVA_MS]:
        x, dy = _randn(gen, M, K), _randn(gen, M, N)
        q, s = quantize_kernel_int8_torch(
            0.02 * torch.randn(K, N, generator=gen, device="cuda"))
        xq, sx = qm.quantize_rows(x.float())
        dyq, sy = qm.quantize_rows(dy.float() * s)
        sx, sy = sx.reshape(-1), sy.reshape(-1)
        run = {7: lambda: qm._kernel_fwd(x, q, s),
               9: lambda: qm._kernel_prequant(xq, sx, q, s),
               8: lambda: qm._kernel_dx(dy, q, s),
               10: lambda: qm._kernel_dx_prequant(dyq, sy, q)}
        out = {k: fn() for k, fn in run.items()}
        plain = {7: qm.int8_matmul_plain(x, q, s), 8: qm.int8_matmul_dx_plain(dy, q, s)}
        plain[9], plain[10] = plain[7], plain[8]
        torch.cuda.synchronize()
        err = {k: (out[k].float() - plain[k].float()).abs().max().item() for k in out}
        ok = max(err.values()) == 0 and torch.equal(out[7], out[9]) and \
            torch.equal(out[8], out[10]) and \
            all(bool(torch.isfinite(o.float()).all()) for o in out.values())
        t = {k: time_ms(fn) for k, fn in run.items()}
        t_quant = time_ms(lambda: qm.quantize_rows(x.float()))
        # #9: the whole wrapper call (the row pass on the card and the
        # product) and, from 128 rows, its cp.async kernel (the parent's route)
        t_call9 = time_ms(lambda: qm.int8_matmul_prequant(x, q, s))
        t_rows9 = time_ms(lambda: qm._kernel_prequant(
            xq, sx, q, s, qm.FwdPlan("rows", (128, 128), 1, 1))) if M >= 128 else None
        # #7's cp.async kernel (the parent's route below 128 rows) in this run
        t_tile = time_ms(lambda: qm._kernel_fwd(x, q, s, qm.FwdPlan("tile", (128, 128), 1, 1))) \
            if M < 128 else None
        t_plain = {7: time_ms(lambda: qm.int8_matmul_plain(x, q, s), 5),
                   8: time_ms(lambda: qm.int8_matmul_dx_plain(dy, q, s), 5)}
        t_lib = {7: int_mm_ms(xq, q), 8: int_mm_ms(dyq, q.T)}
        t_pad = int_mm_padded_ms(xq, q) if t_lib[7] is None else None
        t_deq = {7: time_ms(lambda: qm.dequant_matmul(x, q, s)),
                 8: time_ms(lambda: qm.dequant_matmul_dx(dy, q, s))}
        nbytes = {7: _nbytes(x, q, s, out[7]), 9: _nbytes(xq, sx, q, s, out[9]),
                  8: _nbytes(dy, q, s, out[8]), 10: _nbytes(dyq, sy, q, out[10])}
        ops = 2 * M * K * N
        entry = {}
        for k in run:
            ref = 7 if k in (7, 9) else 8
            entry[k] = dict(ms=t[k], plain_ms=t_plain[ref], library_ms=t_lib[ref],
                            dequant_ms=t_deq[ref],
                            **bound(ops, nbytes[k], PEAK_INT8_TOPS))
        entry[7].update(tile_ms=t_tile, padded_library_ms=t_pad, quant_ms=t_quant)
        entry[9].update(call_ms=t_call9, rows_ms=t_rows9)
        res[(M, K, N)] = entry

        def lib(k):
            if t_lib[k] is None:
                return "refused" + (f" ({t_pad:.4f} on the rows zero-padded to 32)"
                                    if k == 7 else "")
            return f"{t_lib[k]:.4f}"

        split = qm.dx_split(M, K, N, qm._sms(0), q.data_ptr() % 16 == 0)
        launched = launched_ops(run[8])
        entry[8]["kernels_a_call"] = launched.get("kernel", 0)
        plan = qm.dx_prequant_plan(M, K, N, qm._sms(0),
                                   q.data_ptr() % 16 == 0 and dyq.data_ptr() % 16 == 0)
        launched10 = launched_ops(run[10])
        entry[10].update(kernels_a_call=launched10.get("kernel", 0), route=plan.route)
        fplan = qm.fwd_plan(M, K, N, qm._sms(0),
                            q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)
        launched7 = launched_ops(run[7])
        entry[7].update(kernels_a_call=launched7.get("kernel", 0), route=fplan.route,
                        split=fplan.split)
        plan9 = qm.fwd_prequant_plan(M, K, N, qm._sms(0),
                                     q.data_ptr() % 16 == 0 and xq.data_ptr() % 16 == 0)
        launched9 = launched_ops(run[9])
        entry[9].update(kernels_a_call=launched9.get("kernel", 0), route=plan9.route)
        ok = ok and launched.get("kernel", 0) == qm.dx_launches(split) and \
            launched10.get("kernel", 0) == plan.launches and \
            launched7.get("kernel", 0) == fplan.launches and \
            launched9.get("kernel", 0) == plan9.launches
        log(f"[3d int8] M={M} K={K} N={N}: one #7 call captured in a CUDA graph: "
            f"{ops_text(launched7)}; route {fplan.route}, tile {fplan.tile[0]} x "
            f"{fplan.tile[1]}, {fplan.split} K slices, {fplan.launches} kernels planned"
            + (f"; its cp.async kernel (the parent's route) {t_tile:.4f} ms, "
               f"{t_tile / t[7]:.2f}x" if t_tile else "")
            + f" | one #9 call: {ops_text(launched9)}; route {plan9.route}, tile "
            f"{plan9.tile[0]} x {plan9.tile[1]}, {plan9.launches} kernel planned"
            + (f"; its cp.async kernel (the parent's route) {t_rows9:.4f} ms, "
               f"{t_rows9 / t[9]:.2f}x" if t_rows9 else "")
            + f"; the whole int8_matmul_prequant call (row pass on the card + product) "
            f"{t_call9:.4f} ms | one #8 call: "
            f"{ops_text(launched)}; {split} contraction slices, {qm.dx_launches(split)} kernels "
            f"planned | one #10 call: {ops_text(launched10)}; route {plan.route}, tile "
            f"{plan.tile[0]} x {plan.tile[1]}, {plan.split} slices, {plan.launches} kernels "
            f"planned | max|err| #7 {err[7]:.1e} #9 {err[9]:.1e} "
            f"#8 {err[8]:.1e} #10 {err[10]:.1e} (tol 0), #7==#9 "
            f"{torch.equal(out[7], out[9])} #8==#10 {torch.equal(out[8], out[10])} | "
            + " ".join(f"#{k} {t[k]:.4f} ms = {ops / (t[k] * 1e-3) / 1e12:.1f} TOP/s "
                       f"(bound {entry[k]['bound_ms']:.4f}, {entry[k]['bound_by']})"
                       for k in run)
            + f" | torch row quantisation of x (the prequant route's pass) "
            f"{t_quant:.4f} ms | plain fwd {t_plain[7]:.3f} dx {t_plain[8]:.3f} ms | "
            f"torch._int_mm fwd {lib(7)} dx {lib(8)} ms (product only) | dequant "
            f"route fwd {t_deq[7]:.4f} dx {t_deq[8]:.4f} ms | "
            f"{'ok' if ok else 'FAIL'}")
        if M in (64, 127, 128):  # the crossover INT8_DEQUANT_MIN_M wants
            log(f"[3d int8] M={M} K={K} N={N}: #7 ({fplan.route}) {t[7]:.4f} ms against #9 "
                f"{t[9]:.4f} + its torch row quantisation {t_quant:.4f} = "
                f"{t[9] + t_quant:.4f} ms")
        if not ok:
            raise AssertionError(f"int8 kernels disagree with the plain twins, or #7, #8, #9 "
                                 f"or #10 with its planned launches, at M={M} K={K} N={N}: "
                                 f"{err}")
        res["err"] = max(res["err"], max(err.values()))
        if M == qb["m_prefix"]:
            route_noise("[3d int8]", out[9], out[10], qm.dequant_matmul(x, q, s),
                        qm.dequant_matmul_dx(dy, q, s))
        del x, dy, q, s, xq, dyq, out, plain, run
        torch.cuda.empty_cache()

    # phase 17's Mistral-7B widths at 17's rows and phase 18's Llama3-8B
    # (the same widths) at 18b's rows, bit for bit only (no times), each from
    # a generator of its own (above): the four kernels and the wrappers the
    # path calls (the row pass on the card, then #9 / #10)
    for name, ms, seed in (("phase 17's", qb["omni_ms"], 17), ("phase 18b's", MCV_MS, 18)):
        _exact_int8(name, ms, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.empty_cache()


    # #8 on quotients at and next to half-integers: the short step's rows
    # and the edges of its row tiles, both widths; reruns give the same bits
    for K, N, M in [(4096, 11008, M) for M in (1, 63, 64, 127, qb["m_short"])] + \
            [(11008, 4096, qb["m_short"]), (300, 1008, 64)]:
        q, _ = quantize_kernel_int8_torch(0.02 * torch.randn(K, N, generator=g, device="cuda"))
        dy, s = tie_case(M, N, 1, seed=M + K)
        got = qm._kernel_dx(dy, q, s[0])
        want = qm.int8_matmul_dx_plain(dy, q, s[0])
        again = qm._kernel_dx(dy, q, s[0])
        torch.cuda.synchronize()
        ok = torch.equal(got, want) and torch.equal(again, got)
        log(f"[3d int8] #8 on tie quotients M={M} K={K} N={N}: equal to the twin "
            f"{torch.equal(got, want)}, rerun equal {torch.equal(again, got)} | "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"#8 disagrees with its twin on ties at M={M} K={K} N={N}")

    M, K, N = qb["m_short"], 4096, 11008  # split into slices: the finishing pass runs
    assert qm.dx_split(M, K, N, qm._sms(0)) > 1
    q, s = quantize_kernel_int8_torch(0.02 * torch.randn(K, N, generator=g, device="cuda"))
    dy = _randn(g, M, N)
    case = (qm._kernel_dx, (dy, q, s), qm.int8_matmul_dx_plain(dy, q, s))
    M, K, N = qb["m_prefix"], 4096, 11008  # #10 on its wide tile
    assert qm.dx_prequant_plan(M, K, N, qm._sms(0)).route == "wide"
    q, s = quantize_kernel_int8_torch(0.02 * torch.randn(K, N, generator=own, device="cuda"))
    dy = _randn(own, M, N)
    dyq, sy = qm.quantize_rows(dy.float() * s)
    case10 = (qm._kernel_dx_prequant, (dyq, sy.reshape(-1), q), qm.int8_matmul_dx_plain(dy, q, s))
    M, K, N = FWD7_FAULT_CASE  # #7's split product, from a generator of its own
    assert qm.fwd_plan(M, K, N, qm._sms(0)).split > 1
    g7 = torch.Generator(device="cuda").manual_seed(7)
    q, s = quantize_kernel_int8_torch(0.02 * torch.randn(K, N, generator=g7, device="cuda"))
    x = _randn(g7, M, K)
    case7 = (qm._kernel_fwd, (x, q, s), qm.int8_matmul_plain(x, q, s))
    M, K, N = qb["m_prefix"], 4096, 11008  # #9 on its wide tile
    assert qm.fwd_prequant_plan(M, K, N, qm._sms(0)).route == "wide"
    g9 = torch.Generator(device="cuda").manual_seed(9)
    q, s = quantize_kernel_int8_torch(0.02 * torch.randn(K, N, generator=g9, device="cuda"))
    x = _randn(g9, M, K)
    xq, sx = qm.quantize_rows(x.float())
    case9 = (qm._kernel_prequant, (xq, sx.reshape(-1), q, s), qm.int8_matmul_plain(x, q, s))
    planted_faults("[3d int8]", {**DX8_FAULTS, **DX10_FAULTS, **FWD7_FAULTS, **FWD9_FAULTS},
                   {**{k: case for k in DX8_FAULTS}, **{k: case10 for k in DX10_FAULTS},
                    **{k: case7 for k in FWD7_FAULTS}, **{k: case9 for k in FWD9_FAULTS}})
    res["eva_quant_dense"] = eva_quant_dense("[3d int8]", eva, 8)
    return res


def phase_int4(g, qb: dict) -> dict:
    """3e: kernels #11 and #12 against their plain twins (max abs difference
    0; #11 at groups of 128 and 256) at the 7B projection widths and
    Llama3-8B's, the kernels one call of each launches (a CUDA graph of the
    call), planted faults in both, with times beside the int8 bound,
    torch._int_mm on the unpacked int8 operands (product only; the weight
    row-major as it unpacks and in cuBLASLt's fast column-major layout) and
    the "dequant" route (a bf16 dequantisation plus one cuBLAS product). #12
    is checked at N = 11008 too, where the dispatch takes the dequant dx."""
    res = {"err": 0.0}
    # 9: phase 19b's lookup window (k + 1 rows) on the smoothed int4 7B
    ms = sorted({9, 16, 64, 127, 128, qb["m_suffix"], qb["m_prefix"]})
    # the EVA02 widths from a generator of their own (3d says why)
    eva = torch.Generator(device="cuda").manual_seed(16)
    widths = [(K, N, ms, g) for K, N in ((4096, 4096), (4096, 11008), (11008, 4096))]
    widths += [(K, N, llama3_ms(), g) for K, N in LLAMA3_WIDTHS]
    widths += [(K, N, EVA_MS, eva) for K, N in EVA_WIDTHS]
    for K, N, ms, gen in widths:
        qp, gs = quantize_int4_torch(0.02 * torch.randn(K, N, generator=gen, device="cuda"))
        w8 = i4.unpack_int4(qp)  # (K, N) row-major
        w8_col = w8.T.contiguous().T  # the same values column-major
        for M in ms:
            x, dy = _randn(gen, M, K), _randn(gen, M, N)
            xq, sx = qm.quantize_rows(x.float())
            sx = sx.reshape(-1)
            dyq = qm.quantize_rows(dy.float() * gs[0])[0]  # one group's operand
            run = {11: lambda: i4._kernel_fwd(xq, sx, qp, gs),
                   12: lambda: i4._kernel_dx(dy, qp, gs)}
            out = {k: fn() for k, fn in run.items()}
            plain = {11: i4.int4_matmul_plain(x, qp, gs), 12: i4.int4_matmul_dx_plain(dy, qp, gs)}
            torch.cuda.synchronize()
            err = {k: (out[k].float() - plain[k].float()).abs().max().item() for k in out}
            ok = max(err.values()) == 0 and \
                all(bool(torch.isfinite(o.float()).all()) for o in out.values())
            t = {k: time_ms(fn) for k, fn in run.items()}
            t_quant = time_ms(lambda: qm.quantize_rows(x.float()))
            t_plain = {11: time_ms(lambda: i4.int4_matmul_plain(x, qp, gs), 5),
                       12: time_ms(lambda: i4.int4_matmul_dx_plain(dy, qp, gs), 5)}
            t_lib = {11: int_mm_ms(xq, w8_col, "[3e int4]"), 12: int_mm_ms(dyq, w8.T, "[3e int4]")}
            t_lib_row = int_mm_ms(xq, w8, "[3e int4]")
            t_deq = {11: time_ms(lambda: i4.dequant_int4_matmul(x, qp, gs)),
                     12: time_ms(lambda: i4.dequant_int4_matmul_dx(dy, qp, gs))}
            nbytes = {11: _nbytes(xq, sx, qp, gs, out[11]), 12: _nbytes(dy, qp, gs, out[12])}
            ops = 2 * M * K * N
            entry = {k: dict(ms=t[k], plain_ms=t_plain[k], library_ms=t_lib[k],
                             dequant_ms=t_deq[k], **bound(ops, nbytes[k], PEAK_INT8_TOPS))
                     for k in run}
            res[(M, K, N)] = entry

            def lib(v):
                return "refused" if v is None else f"{v:.4f}"

            launched = launched_ops(run[12])
            launched11 = launched_ops(run[11])
            entry[12]["kernels_a_call"] = launched.get("kernel", 0)
            entry[11]["kernels_a_call"] = launched11.get("kernel", 0)
            ok = ok and launched.get("kernel", 0) == 2 and launched11 == {"kernel": 1}
            log(f"[3e int4] M={M} K={K} N={N}: one #11 call captured in a CUDA graph: "
                f"{ops_text(launched11)}; 1 kernel planned | one #12 call: "
                f"{ops_text(launched)}; 2 kernels planned (row maxima, product) | "
                f"max|err| #11 {err[11]:.1e} #12 {err[12]:.1e} "
                f"(tol 0) | " + " ".join(
                    f"#{k} {t[k]:.4f} ms = {ops / (t[k] * 1e-3) / 1e12:.1f} TOP/s (bound "
                    f"{entry[k]['bound_ms']:.4f}, {entry[k]['bound_by']})" for k in run)
                + f" | torch row quantisation of x {t_quant:.4f} ms | plain #11 "
                f"{t_plain[11]:.3f} #12 {t_plain[12]:.3f} ms | torch._int_mm on the unpacked "
                f"operands (product only) fwd {lib(t_lib[11])} (weight row-major "
                f"{lib(t_lib_row)}) dx {lib(t_lib[12])} ms | dequant route fwd "
                f"{t_deq[11]:.4f} dx {t_deq[12]:.4f} ms | {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"int4 kernels disagree with the plain twins, or #11 or "
                                     f"#12 with its planned launches, at M={M} K={K} N={N}: "
                                     f"{err}")
            res["err"] = max(res["err"], max(err.values()))
            if M == qb["m_prefix"]:
                route_noise("[3e int4]", out[11], out[12], i4.dequant_int4_matmul(x, qp, gs),
                            i4.dequant_int4_matmul_dx(dy, qp, gs))
            del x, dy, xq, dyq, out, plain, run
        del qp, gs, w8, w8_col
        torch.cuda.empty_cache()

    # phase 17's Mistral-7B widths at 17's rows and 17b's EVA02 tower at its
    # 4 images, bit for bit only (no times), from a generator of their own:
    # #11 through the wrapper the path calls (the rows quantised in torch),
    # #12 (the dispatch takes the dequant dx above INT4_DX_MAX_N columns)
    mis = torch.Generator(device="cuda").manual_seed(17)
    for K, N, ms17 in [(K, N, qb["omni_ms"]) for K, N in MISTRAL_WIDTHS] + \
            [(K, N, (EVA_STEP_M,)) for K, N in EVA_WIDTHS]:
        qp, gs = quantize_int4_torch(0.02 * torch.randn(K, N, generator=mis, device="cuda"))

        def run(x, dy, M, K, N):
            return {"int4_matmul (#11)": (i4.int4_matmul(x, qp, gs),
                                          i4.int4_matmul_plain(x, qp, gs)),
                    "#12": (i4._kernel_dx(dy, qp, gs), i4.int4_matmul_dx_plain(dy, qp, gs))}

        _exact_cases("[3e int4] phase 17's", [(M, K, N) for M in ms17], mis, run)
        del qp, gs
    # phase 18d's int4 Llama3-8B (MISTRAL_WIDTHS) at 18b's prefill rows, #11
    # through the wrapper, from a generator of its own
    mcv = torch.Generator(device="cuda").manual_seed(18)
    for K, N in MISTRAL_WIDTHS:
        qp, gs = quantize_int4_torch(0.02 * torch.randn(K, N, generator=mcv, device="cuda"))
        _exact_cases("[3e int4] phase 18d's", [(MCV_MS[1], K, N)], mcv, lambda x, dy, M, K, N: {
            "int4_matmul (#11)": (i4.int4_matmul(x, qp, gs), i4.int4_matmul_plain(x, qp, gs))})
        del qp, gs
    torch.cuda.empty_cache()

    # #11 at groups of 256, every shape above
    n256 = 0
    for K, N, ms, gen in widths:
        qp, gs = quantize_int4_torch(0.02 * torch.randn(K, N, generator=gen, device="cuda"), 256)
        for M in ms:
            x = _randn(gen, M, K)
            xq, sx = qm.quantize_rows(x.float())
            got = i4._kernel_fwd(xq, sx.reshape(-1), qp, gs)
            if not torch.equal(got, i4.int4_matmul_plain(x, qp, gs)):
                raise AssertionError(f"#11 disagrees with its twin at G=256, M={M} K={K} N={N}")
            n256 += 1
        del qp, gs
    log(f"[3e int4] #11 at groups of 256: equal to the twin at all {n256} shapes above | ok")

    # #12 on quotients at and next to half-integers, groups of 128 and 256;
    # reruns give the same bits
    for M, K, N, G in ((qb["m_prefix"], 11008, 4096, 128), (127, 4096, 4096, 128),
                       (qb["m_suffix"], 4096, 11008, 128), (200, 4096, 4096, 256)):
        qp, _ = quantize_int4_torch(0.02 * torch.randn(K, N, generator=g, device="cuda"), G)
        dy, gs = tie_case(M, N, K // G, seed=M + G)
        got = i4._kernel_dx(dy, qp, gs)
        want = i4.int4_matmul_dx_plain(dy, qp, gs)
        again = i4._kernel_dx(dy, qp, gs)
        torch.cuda.synchronize()
        ok = torch.equal(got, want) and torch.equal(again, got)
        log(f"[3e int4] #12 on tie quotients M={M} K={K} N={N} G={G}: equal to the twin "
            f"{torch.equal(got, want)}, rerun equal {torch.equal(again, got)} | "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"#12 disagrees with its twin on ties at M={M} K={K} N={N}")

    M, K, N = 256, 4096, 4096
    qp, gs = quantize_int4_torch(0.02 * torch.randn(K, N, generator=g, device="cuda"))
    dy = _randn(g, M, N)
    tdy, tgs = tie_case(M, N, K // 128, seed=7)
    gauss = (i4._kernel_dx, (dy, qp, gs), i4.int4_matmul_dx_plain(dy, qp, gs))
    ties = (i4._kernel_dx, (tdy, qp, tgs), i4.int4_matmul_dx_plain(tdy, qp, tgs))
    names = list(DX4_FAULTS)
    libs = planted_faults("[3e int4] #12", DX4_FAULTS, {names[0]: ties, names[1]: gauss,
                                                        names[2]: gauss})
    with kernels_from(libs[names[0]]):  # what Gaussian rows alone would show
        n_diff = int((i4._kernel_dx(dy, qp, gs) != gauss[2]).sum())
    log(f"[3e int4] #12 without its guard band on Gaussian rows (M={M} K={K} N={N}): "
        f"{n_diff} of {gauss[2].numel()} outputs differ from the twin")
    x = _randn(g, M, K)
    xq, sx = qm.quantize_rows(x.float())
    case = (i4._kernel_fwd, (xq, sx.reshape(-1), qp, gs), i4.int4_matmul_plain(x, qp, gs))
    planted_faults("[3e int4] #11", FWD4_FAULTS, {k: case for k in FWD4_FAULTS})
    res["eva_quant_dense"] = eva_quant_dense("[3e int4]", eva, 4)
    return res


def _lora_loss_grads(model, adapter, batch, hp, lora, alpha, names) -> tuple:
    """One loss and backward with the adapters attached and no update ->
    (loss, (chosen, rejected) logps, the named adapter gradients in fp32)."""
    tensors = dict(named_tensors(lora))
    for t in tensors.values():
        t.grad = None
    attach_lora(model, lora_scaled(lora, alpha=alpha))
    loss, metrics = dpo_loss_from_batch(adapter, batch, hp)
    loss.backward()
    attach_lora(model, None)
    logps = (float(metrics["logps_train/chosen"]), float(metrics["logps_train/rejected"]))
    return (float(loss.detach()), logps,
            {k: tensors[n].grad.float().clone() for k, n in names.items()})


def phase_qlora(model, tok, rows: list, short: dict, cfg: LlavaConfig,
                ref_bf16: list) -> dict:
    """9: the QLoRA slice on phase 8's seed-0 model (built anew): int8
    quantisation on the card, the reference logps on the int8 base, step 0
    against the "dequant" route, 3 AdamW steps of 8 pairs, one short step."""
    from rlaifv_tpu_torch.models.llama import QuantDense

    L_layers = cfg.llm.num_layers
    t0 = time.perf_counter()
    quantize_llm_int8(model, include_lm_head=False)
    torch.cuda.synchronize()
    n_q = sum(isinstance(m, QuantDense) for m in model.modules())
    log(f"[9 qlora] LLM projections quantised to int8 on the card: {n_q} QuantDense "
        f"(7 x {L_layers} layers) in {time.perf_counter() - t0:.2f} s; lm_head "
        f"{type(model.llm.lm_head).__name__} {model.llm.lm_head.weight.dtype}, CLIP and "
        f"projector bf16 | device memory {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    if n_q != 7 * L_layers or isinstance(model.llm.lm_head, QuantDense):
        raise AssertionError("9: the int8 base is not the 7 projections x layers")
    launches = {}

    # the reference logps of the 16 rows and the short one on the int8 base
    kw = dict(max_len=2048, num_patches=cfg.num_image_tokens, batch_pairs=8,
              image_processor=ClipImageProcessor(image_size=cfg.vision.image_size),
              progress=False, shared_prefix=True)
    score_preference_rows(rows[:2], model, tok, **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    ref = score_preference_rows(rows + [short], model, tok, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = read_counts()
    add_counts(launches, n)
    rel, tmean, tmax = _seq_close(ref[:len(ref_bf16)], ref_bf16, 1.0)
    log(f"[9 qlora] ref-logp on the int8 base (shared-prefix path): {len(ref)} pairs in "
        f"{dt:.3f} s = {len(ref) / dt:.2f} pairs/s | peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | launches #9 "
        f"{n['int8_prequant']} #7 {n['int8']} flash {n['flash']} | against phase 8's bf16 "
        f"base (weights and activations quantised): sums and means max rel {rel:.3e}, "
        f"per-token |d| mean {tmean:.3e} max {tmax:.3e}")
    if not all(np.isfinite(r[k]) for r in ref for k in (0, 1, 3, 4)) or \
            n["int8_prequant"] < 7 * L_layers:
        raise AssertionError(f"9: the int8 ref-logp path failed: {n}")

    qb = qlora_batches(rows, short, tok, cfg, ref)
    t = qb["config"].training
    hp = DPOHparams(beta=t.dpo_beta, dpo_use_average=t.dpo_use_average,
                    lm_head_impl=resolve_head(t, cfg.llm.hidden_size, cfg.llm.dtype),
                    shared_prefix_len=qb["P"])
    assert hp.lm_head_impl == "fused", hp.lm_head_impl
    batch = batch_to_device(qb["batch_np"], "cuda")
    adapter = LlavaDPOAdapter(model)
    model.train()
    lora = lora_init(torch.Generator(device="cuda").manual_seed(t.seed), model, r=t.lora_r)
    n_lora = sum(x.numel() for _, x in named_tensors(lora))
    optimizer = make_optimizer(lora, QLORA_LR, total_steps=t.max_steps, warmup_ratio=0.0,
                               weight_decay=t.weight_decay, max_grad_norm=t.max_grad_norm,
                               schedule="constant")
    step = make_lora_dpo_train_step(adapter, optimizer, hp, lora, lora_alpha=t.lora_alpha)
    L, P = qb["batch_np"]["input_ids"].shape[1], qb["P"]
    B = t.per_device_batch_pairs
    tokens = B * P + 2 * B * (L - P)
    real = B * P + int(qb["batch_np"]["attention_mask"][:, P:].sum())
    log(f"[9 qlora] {B} pairs padded to L={L} (bucket 256), derived P={P} (array "
        f"{-(-P // 128) * 128}), W={L - P}: {tokens} tokens a step, {real} not padding | "
        f"adapters r {t.lora_r} alpha {t.lora_alpha} on every projection: {n_lora / 1e6:.1f} M "
        f"fp32 values | head {hp.lm_head_impl}, remat, constant lr {QLORA_LR}, weight decay "
        f"{t.weight_decay} | projection rows: prefix {qb['m_prefix']}, suffix "
        f"{qb['m_suffix']} (from {qm.INT8_DEQUANT_MIN_M}: the prequant kernels)")

    # step 0 on the "dequant" route first (the comparison, not counted),
    # and the SFT term's gradient on both routes
    last = L_layers - 1
    names = {f"layer {i} {p} b": f"llm/model/layer_{i}/{blk}/{p}/b"
             for i in (0, last)
             for blk, p in (("attn", "q_proj"), ("attn", "v_proj"), ("mlp", "down_proj"))}
    hp_sft = dataclasses.replace(hp, dpo_weight=0.0, sft_weight=1.0)
    sft = {}
    for impl in ("dequant", "prequant"):
        qm.INT8_LARGE_M_IMPL = impl
        try:
            if impl == "dequant":
                deq = _lora_loss_grads(model, adapter, batch, hp, lora, t.lora_alpha, names)
            sft[impl] = _lora_loss_grads(model, adapter, batch, hp_sft, lora, t.lora_alpha,
                                         names)
        finally:
            qm.INT8_LARGE_M_IMPL = "prequant"
    _, _, sft_grads = compare_runs(sft["prequant"], sft["dequant"])
    ok = all(rel <= QLORA_SFT_GRAD_REL_TOL and cos >= QLORA_SFT_GRAD_COS_MIN
             for rel, cos in sft_grads.values())
    log("[9 qlora] step 0, SFT term (chosen mean logp), prequant vs dequant route: "
        + " | ".join(f"{k}: rel {r:.3e} cos {c:.6f}" for k, (r, c) in sft_grads.items())
        + f" (tol rel {QLORA_SFT_GRAD_REL_TOL}, cos {QLORA_SFT_GRAD_COS_MIN}) | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("9: the int8 SFT gradient disagrees with the dequant route")

    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        reset_counts()
        ts = time.perf_counter()
        metrics = step(batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        times.append(time.perf_counter() - ts)
        n = read_counts()
        add_counts(launches, n)
        losses.append(loss)
        log(f"[9 qlora] step {i}: loss {loss:.6e} grad_norm {gnorm:.4e} | "
            f"{times[-1]:.3f} s | int8 launches #9 {n['int8_prequant']} #10 "
            f"{n['int8_dx_prequant']} #7 {n['int8']} #8 {n['int8_dx']} | flash fwd "
            f"{n['flash']} dq {n['dq']} dk/dv {n['dkv']} | fused head fwd {n['head_fwd']} "
            f"dl {n['head_dl']} dx {n['head_dx']} dW {n['head_dw']} (the head is frozen)")
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
            raise AssertionError(f"9: non-finite loss or zero grad norm at step {i}")
        if min(n["int8_prequant"], n["int8_dx_prequant"]) < 7 * L_layers or \
                min(n["flash"], n["dq"], n["head_fwd"], n["head_dl"], n["head_dx"]) < 1:
            raise AssertionError(f"9: a kernel of the QLoRA step did not run: {n}")
        if i == 0:
            tensors = dict(named_tensors(lora))
            run = (loss, (float(metrics["logps_train/chosen"]),
                          float(metrics["logps_train/rejected"])),
                   {k: tensors[nm].grad.float().clone() for k, nm in names.items()})
            d_loss, d_logp, grads = compare_runs(run, deq)
            ok = d_loss <= LOSS_TOL and d_logp <= QLORA_LOGP_RTOL and all(
                rel <= QLORA_GRAD_REL_TOL and cos >= QLORA_GRAD_COS_MIN
                for rel, cos in grads.values())
            log(f"[9 qlora] step 0, prequant (int8 kernels) vs dequant route: loss "
                f"{loss:.5f} vs {deq[0]:.5f} (tol {LOSS_TOL}) | logps "
                f"{run[1][0]:.2f}/{run[1][1]:.2f} vs {deq[1][0]:.2f}/{deq[1][1]:.2f}, max "
                f"rel {d_logp:.2e} (tol {QLORA_LOGP_RTOL}) | "
                + " | ".join(f"{k}: rel {r:.3e} cos {c:.6f}" for k, (r, c) in grads.items())
                + f" (tol rel {QLORA_GRAD_REL_TOL}, cos {QLORA_GRAD_COS_MIN}) | "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("9: the int8 step disagrees with the dequant route")
            if abs(loss - math.log(2)) > REF_LN2_TOL:
                raise AssertionError(f"9: step-0 loss {loss} not within {REF_LN2_TOL} "
                                     f"of ln 2")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = statistics.mean(times[1:])
    log(f"[9 qlora] steps 1-2 (after step 0): {step_s:.3f} s a step = {B / step_s:.3f} "
        f"pairs/s = {tokens / step_s:.0f} tokens/s with padding, {real / step_s:.0f} "
        f"without | peak device memory {peak_gb:.2f} GiB | loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} (step 0 within {REF_LN2_TOL} of ln 2 = {math.log(2):.6f}: "
        f"{losses[0] - math.log(2):+.3e})")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"9: the loss did not fall over 2 updates: {losses}")

    # the short pair: its suffix rows (2 W) take the in-kernel pair #7/#8
    Ps, W = qb["Ps"], qb["W"]
    short_step = make_lora_dpo_train_step(
        adapter, optimizer, dataclasses.replace(hp, shared_prefix_len=Ps,
                                                shared_suffix_len=W),
        lora, lora_alpha=t.lora_alpha)
    reset_counts()
    ts = time.perf_counter()
    metrics = short_step(batch_to_device(qb["short_np"], "cuda"))
    loss = float(metrics["loss"])
    dt = time.perf_counter() - ts
    n = read_counts()
    add_counts(launches, n)
    log(f"[9 qlora] short step: 1 pair, P={Ps}, suffix trimmed to W={W} ({2 * W} rows < "
        f"{qm.INT8_DEQUANT_MIN_M}): loss {loss:.6e} | {dt:.3f} s | int8 launches #7 "
        f"{n['int8']} #8 {n['int8_dx']} #9 {n['int8_prequant']} #10 "
        f"{n['int8_dx_prequant']}")
    # every suffix projection, forward (and its remat recompute) and dx, but
    # layer 0's q, k and v read the embeddings, which need no gradient
    if not math.isfinite(loss) or n["int8"] < 7 * L_layers or \
            n["int8_dx"] < 7 * L_layers - 3:
        raise AssertionError(f"9: the short step missed the in-kernel pair: {n}")
    keys = ("int8", "int8_dx", "int8_prequant", "int8_dx_prequant")
    log(f"[9 qlora] launches on the QLoRA path (ref-logp, 3 steps, short step): "
        f"{ {k: launches[k] for k in keys} }")
    if min(launches[k] for k in keys) < 1:
        raise AssertionError(f"9: an int8 kernel never ran: {launches}")
    return launches


def phase_qlora_int4(model, tok, rows: list, cfg: LlavaConfig, ref_bf16: list) -> dict:
    """10: the int4 QLoRA slice (llava15_dpo_qlora.json with quantize_bits 4)
    on phase 8's seed-0 model (built anew): int4 quantisation on the card,
    the reference logps of the 16 rows on the int4 base, step 0 against the
    "dequant" route, 3 AdamW steps of 8 pairs. A spy counts the dequant dx
    calls (gate/up, N = 11008 > INT4_DX_MAX_N)."""
    from rlaifv_tpu_torch.models.llama import QuantDense

    L_layers = cfg.llm.num_layers
    t0 = time.perf_counter()
    quantize_llm_int4(model)
    torch.cuda.synchronize()
    quant = [m for m in model.modules() if isinstance(m, QuantDense)]
    base_gb = _nbytes(*(b for m in quant for b in (m.q, m.scale))) / 1e9
    log(f"[10 int4] LLM projections quantised to int4 (group 128) on the card: "
        f"{len(quant)} QuantDense (7 x {L_layers} layers) in {time.perf_counter() - t0:.2f} s; "
        f"lm_head {type(model.llm.lm_head).__name__} {model.llm.lm_head.weight.dtype}, CLIP "
        f"and projector bf16 | device memory {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"| packed weights and scales {base_gb:.3f} GB")
    if len(quant) != 7 * L_layers or any(m.bits != 4 for m in quant) or \
            isinstance(model.llm.lm_head, QuantDense) or model.cfg.llm.quantize_bits != 4:
        raise AssertionError("10: the int4 base is not the 7 projections x layers")
    launches = {}
    deq_dx = {"calls": 0}
    orig_deq_dx = i4.dequant_int4_matmul_dx

    def spy_deq_dx(*a):
        deq_dx["calls"] += 1
        return orig_deq_dx(*a)

    # the reference logps of the 16 rows on the int4 base
    kw = dict(max_len=2048, num_patches=cfg.num_image_tokens, batch_pairs=8,
              image_processor=ClipImageProcessor(image_size=cfg.vision.image_size),
              progress=False, shared_prefix=True)
    score_preference_rows(rows[:2], model, tok, **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    ref = score_preference_rows(rows, model, tok, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = read_counts()
    add_counts(launches, n)
    rel, tmean, tmax = _seq_close(ref, ref_bf16, 1.0)
    log(f"[10 int4] ref-logp on the int4 base (shared-prefix path): {len(ref)} pairs in "
        f"{dt:.3f} s = {len(ref) / dt:.2f} pairs/s | peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | launches #11 {n['int4']} "
        f"flash {n['flash']} | against phase 8's bf16 base (weights and activations "
        f"quantised): sums and means max rel {rel:.3e}, per-token |d| mean {tmean:.3e} max "
        f"{tmax:.3e}")
    if not all(np.isfinite(r[k]) for r in ref for k in (0, 1, 3, 4)) or \
            n["int4"] < 7 * L_layers:
        raise AssertionError(f"10: the int4 ref-logp path failed: {n}")

    qb = qlora_batches(rows, None, tok, cfg, ref, bits=4)
    t = qb["config"].training
    hp = DPOHparams(beta=t.dpo_beta, dpo_use_average=t.dpo_use_average,
                    lm_head_impl=resolve_head(t, cfg.llm.hidden_size, cfg.llm.dtype),
                    shared_prefix_len=qb["P"])
    assert hp.lm_head_impl == "fused" and qb["config"].model.quantize_bits == 4
    batch = batch_to_device(qb["batch_np"], "cuda")
    adapter = LlavaDPOAdapter(model)
    model.train()
    lora = lora_init(torch.Generator(device="cuda").manual_seed(t.seed), model, r=t.lora_r)
    optimizer = make_optimizer(lora, QLORA_LR, total_steps=t.max_steps, warmup_ratio=0.0,
                               weight_decay=t.weight_decay, max_grad_norm=t.max_grad_norm,
                               schedule="constant")
    step = make_lora_dpo_train_step(adapter, optimizer, hp, lora, lora_alpha=t.lora_alpha)
    L, P = qb["batch_np"]["input_ids"].shape[1], qb["P"]
    B = t.per_device_batch_pairs
    tokens = B * P + 2 * B * (L - P)
    real = B * P + int(qb["batch_np"]["attention_mask"][:, P:].sum())
    log(f"[10 int4] {B} pairs padded to L={L}, derived P={P}, W={L - P}: {tokens} tokens a "
        f"step, {real} not padding | adapters r {t.lora_r} alpha {t.lora_alpha} (a of "
        f"{lora['llm']['model']['layer_0']['mlp']['down_proj']['a'].shape[0]} rows at "
        f"down_proj: the logical width) | head {hp.lm_head_impl}, remat, constant lr "
        f"{QLORA_LR} | projection rows: prefix {qb['m_prefix']}, suffix {qb['m_suffix']}")

    # step 0 on the "dequant" route first (the comparison, not counted), and
    # the SFT term's gradient on both routes
    last = L_layers - 1
    names = {f"layer {i} {p} b": f"llm/model/layer_{i}/{blk}/{p}/b"
             for i in (0, last)
             for blk, p in (("attn", "q_proj"), ("attn", "v_proj"), ("mlp", "down_proj"))}
    hp_sft = dataclasses.replace(hp, dpo_weight=0.0, sft_weight=1.0)
    sft = {}
    for impl in ("dequant", "kernel"):
        i4.INT4_IMPL = impl
        try:
            if impl == "dequant":
                deq = _lora_loss_grads(model, adapter, batch, hp, lora, t.lora_alpha, names)
            sft[impl] = _lora_loss_grads(model, adapter, batch, hp_sft, lora, t.lora_alpha,
                                         names)
        finally:
            i4.INT4_IMPL = "kernel"
    _, _, sft_grads = compare_runs(sft["kernel"], sft["dequant"])
    ok = all(rel <= INT4_SFT_GRAD_REL_TOL and cos >= INT4_SFT_GRAD_COS_MIN
             for rel, cos in sft_grads.values())
    log("[10 int4] step 0, SFT term (chosen mean logp), kernel vs dequant route: "
        + " | ".join(f"{k}: rel {r:.3e} cos {c:.6f}" for k, (r, c) in sft_grads.items())
        + f" (tol rel {INT4_SFT_GRAD_REL_TOL}, cos {INT4_SFT_GRAD_COS_MIN}) | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("10: the int4 SFT gradient disagrees with the dequant route")

    losses, times = [], []
    per_step = []
    torch.cuda.reset_peak_memory_stats()
    i4.dequant_int4_matmul_dx = spy_deq_dx
    try:
        for i in range(3):
            reset_counts()
            deq_dx["calls"] = 0
            ts = time.perf_counter()
            metrics = step(batch)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            times.append(time.perf_counter() - ts)
            n = read_counts()
            add_counts(launches, n)
            losses.append(loss)
            per_step.append((n["int4"], n["int4_dx"], deq_dx["calls"]))
            log(f"[10 int4] step {i}: loss {loss:.6e} grad_norm {gnorm:.4e} | "
                f"{times[-1]:.3f} s | int4 launches #11 {n['int4']} #12 {n['int4_dx']}, "
                f"dequant dx calls {deq_dx['calls']} | int8 #7-#10 "
                f"{n['int8'] + n['int8_dx'] + n['int8_prequant'] + n['int8_dx_prequant']} | "
                f"flash fwd {n['flash']} dq {n['dq']} dk/dv {n['dkv']} | fused head fwd "
                f"{n['head_fwd']} dl {n['head_dl']} dx {n['head_dx']} dW {n['head_dw']} "
                f"(the head is frozen)")
            if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
                raise AssertionError(f"10: non-finite loss or zero grad norm at step {i}")
            # every projection's forward (prefix and suffix), and the dx of
            # q/k/v/o/down but layer 0's q/k/v (their input needs no gradient)
            if n["int4"] < 2 * 7 * L_layers or n["int4_dx"] < 2 * (5 * L_layers - 3) or \
                    deq_dx["calls"] < 1 or \
                    min(n["flash"], n["dq"], n["head_fwd"], n["head_dl"], n["head_dx"]) < 1:
                raise AssertionError(f"10: a kernel of the int4 QLoRA step did not run: "
                                     f"{n}, dequant dx {deq_dx['calls']}")
            if i == 0:
                tensors = dict(named_tensors(lora))
                run = (loss, (float(metrics["logps_train/chosen"]),
                              float(metrics["logps_train/rejected"])),
                       {k: tensors[nm].grad.float().clone() for k, nm in names.items()})
                d_loss, d_logp, grads = compare_runs(run, deq)
                ok = d_loss <= LOSS_TOL and d_logp <= INT4_LOGP_RTOL and all(
                    rel <= INT4_GRAD_REL_TOL and cos >= INT4_GRAD_COS_MIN
                    for rel, cos in grads.values())
                log(f"[10 int4] step 0, kernel (#11/#12) vs dequant route: loss {loss:.5f} vs "
                    f"{deq[0]:.5f} (tol {LOSS_TOL}) | logps {run[1][0]:.2f}/{run[1][1]:.2f} vs "
                    f"{deq[1][0]:.2f}/{deq[1][1]:.2f}, max rel {d_logp:.2e} (tol "
                    f"{INT4_LOGP_RTOL}) | "
                    + " | ".join(f"{k}: rel {r:.3e} cos {c:.6f}" for k, (r, c) in grads.items())
                    + f" (tol rel {INT4_GRAD_REL_TOL}, cos {INT4_GRAD_COS_MIN}) | "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("10: the int4 step disagrees with the dequant route")
                if abs(loss - math.log(2)) > REF_LN2_TOL:
                    raise AssertionError(f"10: step-0 loss {loss} not within {REF_LN2_TOL} "
                                         f"of ln 2")
    finally:
        i4.dequant_int4_matmul_dx = orig_deq_dx
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = statistics.mean(times[1:])
    log(f"[10 int4] steps 1-2 (after step 0): {step_s:.3f} s a step = {B / step_s:.3f} "
        f"pairs/s = {tokens / step_s:.0f} tokens/s with padding, {real / step_s:.0f} "
        f"without | peak device memory {peak_gb:.2f} GiB | launches a step (#11, #12, "
        f"dequant dx): {per_step} | loss {losses[0]:.6f} -> {losses[-1]:.6f} (step 0 "
        f"within {REF_LN2_TOL} of ln 2 = {math.log(2):.6f}: {losses[0] - math.log(2):+.3e})")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"10: the loss did not fall over 2 updates: {losses}")
    log(f"[10 int4] launches on the int4 QLoRA path (ref-logp, 3 steps): #11 "
        f"{launches['int4']} #12 {launches['int4_dx']}")
    return launches


# 15: slot-refill continuous batching (genai/continuous.py) on the card, on
# the models phases 4, 11 and 12 build. Two short questions put every prompt
# in the 768 bucket (766 and 763 tokens with the character-level tokenizer),
# so CONT_HEADROOM gives a 896-column cache: 128 columns of room, which the
# 160-192 decode steps of a run pass, so each run compacts at least once
CONT_QUESTIONS = ["Is it daytime?", "Any people?"]
CONT_REPEATS = 10  # the diverse-gen repeat expansion (muffin/llava15_gen_data.py)
CONT_SLOTS, CONT_CHUNK, CONT_NEW, CONT_HEADROOM = 8, 16, 64, 32
CONT_BUDGET = (4.45, 0.8)  # lognormal per-prompt budgets (scripts/bench_7b_gen.py)
CONT_BUDGET_SEED = 0
# greedy continuous against generate: 8 distinct prompts of varied length
CONT_GREEDY = ["Is it daytime?", "Any people?", "Is it dark?", "What colour?", "Is it wet?",
               "Where?", "Any cars?", "Is it?"]
CONT_GREEDY_NEW = 32
# the two paths put a prompt at other cache columns with another valid_len
# and batch (other key splits, tile alignments and kernel plans), so their
# logits differ by rounding, and a random model's near-ties then pick other
# tokens: they are compared token by token while their histories agree
# (_greedy_vs_generate), in bf16 within phase 5's bound, and with the int8
# cache within phase 11's (INT8_KV_REL_TOL, INT8_KV_COS_MIN: with int8
# weights every row quantisation turns such rounding into whole steps).
# The witness that the gap is the engine's and not the continuous path's:
# the run's first wave sits at generate's columns, so it must equal
# generate on those prompts alone (the same batch) within phase 5's bound,
# while generate itself moves between that batch and the whole one. A row
# may first differ from generate only where generate's top-2 logit gap is
# under CONT_TIE x max|first logit|, a fixed bound (phase 5's share): the
# first mismatches read on the H100 sit at gaps of 0-0.0415 of it, the
# first wave is bit-equal to generate at its own batch, and generate moves
# by 0.137 (int8-KV), 0.121 (fused) and 0.010 (bf16) of it between that
# batch and the whole one (PERF.md section 5)
CONT_TIE = SLICE_REL_TOL
# (c): the int8-KV and fused engines on 12 prompts (6 questions x 2
# images' worth of repeats, distinct prompts) through 4 slots
CONT_SMALL = ["Is it daytime?", "Any people?", "Is it dark?", "What colour?", "Is it wet?",
              "Any cars?"] * 2
CONT_SMALL_SLOTS = 4


def cont_budgets(n: int) -> np.ndarray:
    mu, sigma = CONT_BUDGET
    b = np.random.default_rng(CONT_BUDGET_SEED).lognormal(mu, sigma, n)
    return np.clip(b, 8, CONT_NEW).astype(np.int64)


@contextlib.contextmanager
def run_syncs():
    """Counts the host syncs of every ContinuousGenerator.run, refills and
    compactions included, under torch.cuda.set_sync_debug_mode("warn"):
    every synchronizing CUDA call warns "called a synchronizing CUDA
    operation" (the mode's one-time notice that it is a prototype is not
    one), and those warnings are counted -> a list with one record a run:
    the generator (its stats), the syncs of the whole run, those of each
    chunk (ContinuousGenerator._chunk), and the source lines that made
    them."""
    import warnings

    runs, run, chunk = [], ContinuousGenerator.run, ContinuousGenerator._chunk
    caught = []

    def syncs(ws):
        return [w for w in ws if "called a synchronizing" in str(w.message)]

    def counted_chunk(self, *a):
        n0 = len(caught)
        out = chunk(self, *a)
        runs[-1]["chunks"].append(len(syncs(caught[n0:])))
        return out

    def counted_run(self, *a, **kw):
        nonlocal caught
        rec = dict(gen=self, chunks=[], total=0, sites={})
        runs.append(rec)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return run(self, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                found = syncs(caught)
                rec["total"] = len(found)
                for w in found:
                    site = f"{os.path.basename(w.filename)}:{w.lineno}"
                    rec["sites"][site] = rec["sites"].get(site, 0) + 1

    ContinuousGenerator.run, ContinuousGenerator._chunk = counted_run, counted_chunk
    try:
        yield runs
    finally:
        ContinuousGenerator.run, ContinuousGenerator._chunk = run, chunk


def _cont_masks(B: int, L: int, gt: int, seed: int) -> dict:
    """15a's masks on the card: windows ending at gt with different starts,
    finished rows, an empty slot (row 1); the same rolled by a compaction."""
    return {name: torch.from_numpy(continuous_mask(B, L, gt, seed=seed, shift=s)).cuda()
            for name, s in (("windows", 0), ("compacted", L - 1 - gt))}


def phase_continuous_kernels(g) -> dict:
    """15a: kernels #4, #5 and #16 against their split twins at the masks
    continuous batching gives them (utils/synth.py:continuous_mask), with
    phases 3, 3f and 3g's bounds and checks."""
    res = {"cases": 0}
    # #4: phase 15b's bf16 step (8 slots, 896 columns) and a GQA step
    for (B, L, H, KVH, gt), seed in (((8, 896, 32, 32, 700), 1), ((8, 2304, 32, 8, 2000), 2)):
        for name, mask in _cont_masks(B, L, gt, seed).items():
            q, k, v = _randn(g, B, H, 128), _randn(g, B, L, KVH, 128), _randn(g, B, L, KVH, 128)
            k[:, gt + 1:] = float("nan")  # past valid_len: never read
            v[:, gt + 1:] = float("nan")
            _prefix_case(f"15a #4 {name} B={B} KVH={KVH}", q, k, v, mask, gt + 1, timed=False)
            res["cases"] += 1
    # #5: phase 15c's int8-KV step (4 slots) and the 8-slot one
    for B, L, gt, seed in ((4, 896, 700, 3), (8, 896, 300, 4)):
        for name, mask in _cont_masks(B, L, gt, seed).items():
            args = _kv8_cache(g, B, L, 32, 32, 128, gt + 1)
            args[5] = mask
            splits = kv8_splits(B, L, 32, 32, gt + 1)
            out = decode_attention_prefix_int8(*args, gt + 1)
            again = decode_attention_prefix_int8(*args, gt + 1)
            ref = decode_attention_prefix_int8_split_ref(*args, gt + 1, splits)
            torch.cuda.synchronize()
            err, ratio = _kv8_ratio(out, ref)
            launched = launched_ops(lambda: decode_attention_prefix_int8(*args, gt + 1))
            ok = ratio <= 1 and bool((out[1] == 0).all()) and torch.equal(again, out) and \
                launched.get("kernel", 0) == 1 + (splits > 1)
            log(f"[15a #5] {name} B={B} L={L} valid_len={gt + 1}, {splits} key splits; one "
                f"call: {ops_text(launched)} | max|err| against the split twin {err:.3e} = "
                f"{ratio:.3f} of the bound ({KV8_TOL:.4f} x max|twin|), the empty slot 0, "
                f"rerun equal | {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel #5 disagrees at a continuous mask: {name}")
            res["cases"] += 1
    # #16: phase 15c's fused step (4 slots, 896 columns), two layers of the
    # 7B widths: the sharp bound at one layer, the gross one at two
    cfg = _fd_cfg(32, 8, num_layers=2)
    weights = _fd_weights(g, cfg)
    d = fd.default_dims(cfg, 896)
    for B, gt, seed in ((4, 700, 5), (8, 300, 6)):
        for name, mask in _cont_masks(B, 896, gt, seed).items():
            cache, _, x, _ = _fd_inputs(g, d, B, gt)
            pos = mask.sum(dim=1) - 1
            args = (weights, cache, x, mask, pos, gt, d)
            plan = fd.fused_plan(d, B, gt)
            kw = dict(rope_theta=cfg.rope_theta)
            kwr = dict(kw, attn_splits=plan.attn_splits)
            out = fd.fused_decode_step(*args, **kw)
            gap = _fd_gap(*out, *fd.fused_decode_step_ref(*args, **kwr))
            args1 = _fd_layer0(args)
            gap1 = _fd_gap(*fd.fused_decode_step(*args1, **kw),
                           *fd.fused_decode_step_ref(*args1, **kwr))
            torch.cuda.synchronize()
            broken = _fd_layer_broken(gap1, B)
            ok = _fd_within(gap) and not broken
            log(f"[15a #16] {name} B={B} L=896 cache_index={gt}, {plan} | one layer: "
                f"{gap1['rows']} of {B} rows hold a flip (bound {FUSED_FLIP_ROWS(B)}), the worst "
                f"row {gap1['row_steps']:.3g} steps (tol {FUSED_FLIP_STEPS}), k/v "
                f"{gap1['steps']} steps | 2 layers: x_out {gap['x_rel']:.3e} of max (tol "
                f"{FUSED_X_TOL}), k/v {gap['steps']} steps | {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel #16 disagrees at a continuous mask: {name}")
            res["cases"] += 1
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _cont_run(fn) -> tuple:
    """fn() with every launch counter reset just before and read just after,
    the syncs of its continuous runs counted -> (result, wall s, launches,
    run_syncs's records)."""
    torch.cuda.synchronize()
    reset_counts()
    with run_syncs() as runs:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, read_counts(), runs


def _cont_check(tag: str, n_layers: int, launches: dict, runs: list, decode: str,
                per_step: int, compacts: bool = True) -> dict:
    """One continuous run's launches against its plan: #1 once a layer a
    prefill (batched and window), `decode` per_step times a decode step;
    one host sync a chunk and none besides over the whole run (refills and
    compactions included); with `compacts`, a compaction -> the
    generator's stats."""
    (rec,) = runs
    st = rec["gen"].stats
    prefills = st["prefills"] + st["window_prefills"]
    want = {"flash": n_layers * prefills, decode: per_step * st["steps"]}
    got = {k: launches[k] for k in want}
    ok = (got == want and rec["chunks"] == [1] * st["chunks"] and rec["total"] == st["chunks"]
          and st["compactions"] >= compacts)
    log(f"[{tag}] {st}; launches {', '.join(f'{k} {v}' for k, v in launches.items() if v)}; "
        f"planned {want}; host syncs over the whole run, {st['refill_waves']} refill waves "
        f"included: {rec['total']} for {st['chunks']} chunks = {rec['total'] / st['chunks']:.2f} "
        f"a chunk (each chunk's own {sorted(set(rec['chunks']))}; 1 planned, the packed read, "
        f"and none in a refill; from {rec['sites']}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: launches, syncs or compactions off the plan")
    return st


def _media(starts, images, spans, rows=None) -> dict:
    """generate's media arguments (images and their starts, or MiniCPM-V's
    spans: features (B, S, Q, D) and starts (B, S)), of `rows` only when
    given."""
    if spans is not None:
        feats, sstarts = spans
        if rows is not None:
            feats, sstarts = feats[list(rows)], np.asarray(sstarts)[list(rows)]
        return dict(span_features=feats, span_starts=sstarts)
    if rows is not None:
        starts, images = [starts[p] for p in rows], np.asarray(images)[list(rows)]
    return dict(images=np.asarray(images), image_starts=starts)


def _recorded_generate(eng: DecodeEngine, prompts, starts, images, new: int,
                       spans=None) -> tuple:
    """eng.generate of the prompts -> (result, each row's logits a token:
    token 0 the first logits, token k from decode step k - 1, on the
    device; generate's (Lp, max_len)); spans as in _media."""
    steps, geom, step, batch = [], [], eng._step, eng._batch

    def recorded_step(*a):
        logits, cache = step(*a)
        steps.append(logits.float().clone())  # kept on the device: no sync
        return logits, cache

    def recorded_batch(*a):
        out = batch(*a)
        geom.append((out[1].shape[1], out[-1]))
        return out

    eng._step, eng._batch = recorded_step, recorded_batch
    try:
        res = eng.generate(prompts, max_new_tokens=new, **_media(starts, images, spans))
    finally:
        eng._step, eng._batch = step, batch
    first = torch.from_numpy(res.first_logits).float().to(eng.device)
    return res, [[first[b]] + [x[b] for x in steps] for b in range(len(prompts))], geom[0]


def _agree(new: int, a_rows, a_res, b_rows, b_res) -> tuple:
    """Two runs' logits a token while their histories agree, row by row ->
    (largest |difference| over the decode tokens, least row cosine, tokens
    compared, each row's first differing token, rows equal in full)."""
    worst, cos, compared, first_diff, full = 0.0, 1.0, 0, [], 0
    for b in range(len(a_rows)):
        n = min(new, int(a_res.lengths[b]), int(b_res.lengths[b]))
        diff = np.flatnonzero(a_res.tokens[b, :n] != b_res.tokens[b, :n])
        m = int(diff[0]) if len(diff) else n
        first_diff.append(m)
        full += int(m == n)
        for k in range(1, min(m + 1, n)):
            x, y = a_rows[b][k], b_rows[b][k]
            worst = max(worst, (x - y).abs().max().item())
            cos = min(cos, torch.nn.functional.cosine_similarity(x, y, dim=0).item())
            compared += 1
    return worst, cos, compared, first_diff, full


def _greedy_vs_generate(tag: str, eng: DecodeEngine, prompts, starts, images, slots: int,
                        new: int, smi: str, rel_tol: float = SLICE_REL_TOL,
                        cos_min: float = -1.0, block=None, spans=None,
                        wave_bit_equal: bool = False) -> dict:
    """Greedy continuous (a ContinuousGenerator with slots, CONT_CHUNK and
    CONT_HEADROOM) against one generate of all the prompts, token by token.

    Each prompt's logits a token on both paths (token 0 from the prefill,
    token k from decode step k - 1; the continuous ones mapped from slots
    back to prompts through the run's refills) are compared while the
    row's history is equal on both: the first logits within phase 5's
    bound (SLICE_REL_TOL x max|first logits|), the decode logits within
    rel_tol x that and a row cosine of at least cos_min. A row may first
    differ only at a step where generate's top-2 gap is under CONT_TIE x
    max|first logits|. The witness: the run's first wave, at generate's
    columns, against generate of those prompts alone (the same batch),
    within phase 5's bound; beside it generate of that batch against the
    whole one. With the int8 cache's key block(L) given, the decode tokens
    are also split by whether their keys sat at the same offset in the key
    blocks on both paths through their whole history (p is quantised per
    block): the largest gap of each share is logged. MiniCPM-V prompts take
    their spans (features, starts) in place of starts and images; with
    wave_bit_equal the first wave must equal generate of its prompts alone
    bit for bit."""
    ref, gen_rows, (Lp_gen, L_gen) = _recorded_generate(eng, prompts, starts, images, new,
                                                        spans)
    cont_steps, refills, moves, geom, step = [], [], [], {}, eng._step
    cg = ContinuousGenerator
    reset, compact, init = cg._reset_slots, cg._compact, cg._init_slots

    def recorded_step(*a):
        logits, cache = step(*a)
        cont_steps.append(logits.float().clone())
        return logits, cache

    def recorded_reset(self, st, idx, ids, mask, first, gt, budgets):
        n = idx.numel()
        refills.append((self.stats["chunks"], gt, idx.clone(), ids[:n], mask[:n],
                        first[:n].float().clone()))
        return reset(self, st, idx, ids, mask, first, gt, budgets)

    def recorded_compact(self, st, gt, shift):
        moves.append((self.stats["chunks"], shift))
        return compact(self, st, gt, shift)

    def recorded_init(self, max_len):
        geom["continuous"] = max_len
        return init(self, max_len)

    gen = ContinuousGenerator(eng, slots=slots, chunk=CONT_CHUNK, max_new_tokens=new,
                              headroom=CONT_HEADROOM)
    eng._step = recorded_step
    cg._reset_slots, cg._compact, cg._init_slots = recorded_reset, recorded_compact, recorded_init
    try:
        run, wall, launches, runs = _cont_run(lambda: gen.run(
            prompts, **_media(starts, images, spans)))
    finally:
        eng._step = step
        cg._reset_slots, cg._compact, cg._init_slots = reset, compact, init
    # each prompt's logits a token (token k from the slot's decode step k - 1
    # from its refill's chunk on), its first wave, and the first token
    # whose history ran with the row's keys at another offset in the blocks
    N = len(prompts)
    index = {}  # equal prompts (greedy: equal outputs) map in queue order
    for i, p in enumerate(prompts):
        index.setdefault(tuple(p), []).append(i)
    bl = (block(L_gen), block(geom["continuous"])) if block else None
    cont_rows, shifted_from, wave = [None] * N, [new + 1] * N, []
    for c0, gt, idx, ids, mask, fl in refills:
        for r, s in enumerate(idx.tolist()):
            p = index[tuple(ids[r][mask[r] == 1].tolist())].pop(0)
            cont_rows[p] = [fl[r]] + [x[s] for x in cont_steps[c0 * CONT_CHUNK:]]
            wave += [p] if c0 == 0 else []
            off, at = gt - Lp_gen, 1  # the keys' column offset against generate's
            for c, shift in [(c0, 0)] + [m for m in moves if m[0] >= c0]:
                off, at = off - shift, (c - c0) * CONT_CHUNK + 1
                if bl and (bl[0] != bl[1] or off % bl[0]):
                    shifted_from[p] = at
                    break
    scale = gen_rows[0][0].abs().max().item()
    for b in range(1, N):
        scale = max(scale, gen_rows[b][0].abs().max().item())
    first_gap = max((cont_rows[b][0] - gen_rows[b][0]).abs().max().item() for b in range(N))
    worst, cos, compared, mismatch, full = _agree(new, cont_rows, run, gen_rows, ref)
    at_mismatch, ok = [], first_gap <= SLICE_REL_TOL * scale
    split = {"aligned": 0.0, "shifted": 0.0}
    for b in range(N):
        for k in range(1, min(mismatch[b] + 1, new, int(ref.lengths[b]))):
            share = "shifted" if k >= shifted_from[b] else "aligned"
            split[share] = max(split[share],
                               (cont_rows[b][k] - gen_rows[b][k]).abs().max().item())
        if mismatch[b] < min(new, int(ref.lengths[b]), int(run.lengths[b])):
            top2 = gen_rows[b][mismatch[b]].topk(2).values
            gap = (top2[0] - top2[1]).item()
            at_mismatch.append(f"{b}@{mismatch[b]} {gap / scale:.4f}")
            ok = ok and gap < CONT_TIE * scale
    ok = ok and worst <= rel_tol * scale and cos >= cos_min
    # the witness: the first wave against generate of its prompts alone
    sub = [prompts[p] for p in wave]
    if spans is None:
        w_ref, w_rows, _ = _recorded_generate(eng, sub, [starts[p] for p in wave],
                                              np.asarray(images)[wave], new)
    else:
        w_ref, w_rows, _ = _recorded_generate(
            eng, sub, None, None, new, tuple(_media(None, None, spans, wave).values()))
    w_run = GenerateResult(run.tokens[wave], run.lengths[wave], None)
    w = _agree(new, [cont_rows[p] for p in wave], w_run, w_rows, w_ref)
    g_ref = GenerateResult(ref.tokens[wave], ref.lengths[wave], None)
    g = _agree(new, w_rows, w_ref, [gen_rows[p] for p in wave], g_ref)
    ok = ok and w[0] <= SLICE_REL_TOL * scale and (w[0] == 0 or not wave_bit_equal)
    blocks = (f"; by the keys' offset in the key blocks ({bl[0]} at generate's L={L_gen}, "
              f"{bl[1]} at L={geom['continuous']}), first shifted token {shifted_from}: at "
              f"most {split['aligned'] / scale:.4f} aligned, {split['shifted'] / scale:.4f} "
              f"shifted" if bl else "")
    log(f"[{tag}] greedy continuous ({slots} slots) vs generate on {N} prompts x {new} "
        f"tokens, max|first logit| {scale:.4f}: the first logits differ by at most "
        f"{first_gap / scale:.4f} of it (tol {SLICE_REL_TOL}); the decode logits of the "
        f"{compared} tokens whose history both paths share by at most {worst / scale:.4f} "
        f"(tol {rel_tol}), least row cosine {cos:.5f}"
        + (f" (tol {cos_min})" if cos_min > -1 else "") + blocks
        + f" | each row's first differing token {mismatch} (of {new}), generate's top-2 gap "
        f"there as a share of max|first logit| {at_mismatch} (tie bound {CONT_TIE}); {full} "
        f"of {N} rows equal in full | witness, the first wave {wave} against generate of "
        f"those {len(wave)} prompts alone: {w[0] / scale:.4f} over {w[2]} tokens (tol "
        f"{SLICE_REL_TOL}; {'bit-equal' if w[0] == 0 else 'not bit-equal'}), {w[4]} of "
        f"{len(wave)} rows equal in full; generate of those alone against generate of all "
        f"{N}: {g[0] / scale:.4f} over {g[2]} tokens, least row cosine {g[1]:.5f}, {g[4]} of "
        f"{len(wave)} rows equal in full | {smi} | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: continuous disagrees with generate beyond a near-tie")
    return dict(launches=launches, runs=runs, wall=wall, rows_full=full)


def phase_continuous(gen: Llava15Generator, image_bytes: bytes, smi: str) -> dict:
    """15b: the bf16 per-layer engine (phase 4's model): diverse generation
    of 2 questions x 10 repeats through a ContinuousGenerator (share_keys
    from the repeat groups, 8 slots, chunk 16, per-prompt lognormal budgets,
    CONT_HEADROOM: a compaction), diverse_gen(continuous=True) on the same
    items, then the batch path and generate_many on them; greedy continuous
    against generate -> the launches of its runs."""
    items = _items(image_bytes, [q for q in CONT_QUESTIONS for _ in range(CONT_REPEATS)])
    prompts, starts, images = gen._prepare(items)
    keys = [None] * len(items)
    for k, idx in enumerate(group_consecutive(items, with_question=True)):
        for i in idx:
            keys[i] = k
    budgets = cont_budgets(len(items))
    sp = SamplingParams.diverse_gen()
    eng = gen.engine
    n_layers = gen.model.cfg.llm.num_layers
    eng.generate_continuous(prompts[:2], images=images[:2], image_starts=starts[:2],
                            slots=2, max_new_tokens=2)  # warm-up
    cont = ContinuousGenerator(eng, slots=CONT_SLOTS, chunk=CONT_CHUNK, max_new_tokens=CONT_NEW,
                               sampling=sp, headroom=CONT_HEADROOM)
    res, wall, launches, runs = _cont_run(lambda: cont.run(
        prompts, images=np.asarray(images), image_starts=starts, seed=0,
        max_new_per_prompt=budgets, share_keys=keys))
    st = _cont_check("15b continuous", n_layers, launches, runs, "decode", n_layers)
    ends = res.tokens[np.arange(len(items)), np.maximum(res.lengths - 1, 0)]
    assert res.tokens.shape == (len(items), CONT_NEW) and all(
        n == b or (n < b and e == eng.eos_id) for n, b, e in zip(res.lengths, budgets, ends))
    toks = int(res.lengths.sum())
    rates = {"continuous": toks / wall}
    log(f"[15b continuous] {len(items)} prompts ({len(CONT_QUESTIONS)} questions x "
        f"{CONT_REPEATS}), budgets {budgets.tolist()} (sum {toks}): {wall:.3f} s, "
        f"{rates['continuous']:.1f} tok/s, {st['steps']} decode steps of {CONT_SLOTS} slots "
        f"({toks / (st['steps'] * CONT_SLOTS):.1%} of the slot-steps emit a budgeted token) | "
        f"{smi}")
    total = add_counts({}, launches)
    # diverse_gen's continuous branch (its defaults: chunk 32, no budgets)
    rows, wall, more, runs = _cont_run(lambda: gen.diverse_gen(
        items, max_new_tokens=CONT_NEW, batch_size=CONT_SLOTS, continuous=True))
    assert len(rows) == len(items) and all(isinstance(r["answer"], str) for r in rows)
    st = _cont_check("15b diverse_gen", n_layers, more, runs, "decode", n_layers,
                     compacts=False)
    add_counts(total, more)
    n = len(items) * CONT_NEW
    rates["diverse_gen continuous"] = n / wall
    log(f"[15b diverse_gen continuous] {len(items)} rows x {CONT_NEW}: {wall:.3f} s, "
        f"{n / wall:.1f} tok/s ({st['steps']} steps, {st}) | {smi}")
    # the fixed-batch paths on the same prompts (no per-prompt budgets:
    # every row runs CONT_NEW steps; the budgeted rate counts the tokens the
    # budgets ask for, as the continuous run delivers them)
    for name, fn in (
            ("diverse_gen batch", lambda: gen.diverse_gen(
                items, max_new_tokens=CONT_NEW, batch_size=CONT_SLOTS)),
            ("generate_many", lambda: eng.generate_many(
                prompts, images=images, image_starts=starts, batch_size=CONT_SLOTS,
                sampling=sp, max_new_tokens=CONT_NEW))):
        _, wall, more, _ = _cont_run(fn)
        add_counts(total, more)
        rates[name] = n / wall
        log(f"[15b {name}] {len(items)} rows x {CONT_NEW}: {wall:.3f} s, {n / wall:.1f} tok/s; "
            f"the budgets' {toks} tokens at {toks / wall:.1f} tok/s against the continuous "
            f"run's {rates['continuous']:.1f} | {smi}")
    g_items = _items(image_bytes, CONT_GREEDY)
    p, s, im = gen._prepare(g_items)
    out = _greedy_vs_generate("15b greedy", eng, p, s, im, CONT_SLOTS // 2, CONT_GREEDY_NEW,
                              smi)
    _cont_check("15b greedy", n_layers, out["launches"], out["runs"], "decode", n_layers,
                compacts=False)
    add_counts(total, out["launches"])
    return total, rates


def phase_continuous_engine(gen: Llava15Generator, image_bytes: bytes, smi: str, tag: str,
                            decode: str, per_step: int, absent: tuple, present: tuple,
                            block) -> dict:
    """15c: greedy continuous on 12 prompts through 4 slots with a
    compaction, on phase 11's int8-KV engine (#5 every step, #7 on the
    decode rows, #9 in the refill prefills) or phase 12's fused engine (#16
    every step, compact_stacked, the slot scatter of the write-through
    prefill), against the same engine's generate, its decode tokens split
    by their key offset modulo the engine's key block(L) -> the launches."""
    p, s, im = gen._prepare(_items(image_bytes, CONT_SMALL))
    eng = gen.engine
    eng.generate_continuous(p[:2], images=im[:2], image_starts=s[:2], slots=2,
                            max_new_tokens=2)  # warm-up
    out = _greedy_vs_generate(tag, eng, p, s, im, CONT_SMALL_SLOTS, CONT_NEW, smi,
                              INT8_KV_REL_TOL, INT8_KV_COS_MIN, block)
    st = _cont_check(tag, eng.llm.cfg.num_layers, out["launches"], out["runs"], decode,
                     per_step)
    if any(out["launches"][k] for k in absent) or not all(out["launches"][k] for k in present):
        raise AssertionError(f"{tag}: not this engine's kernels ({absent} none, {present} "
                             f"some): {out['launches']}")
    n = len(p) * CONT_NEW
    log(f"[{tag}] {len(p)} prompts x {CONT_NEW} through {CONT_SMALL_SLOTS} slots: "
        f"{out['wall']:.3f} s, {n / out['wall']:.1f} tok/s ({st['steps']} steps) | {smi}")
    return out["launches"]


# 16: OmniLMM-12B, the reference loop's labeler (scripts/run_data_pipeline.py
# labeler_name "omni"), at full width and depth with random weights from seed
# 0: EVA02-enormous (1792 wide, 63 of its 64 blocks run, head dim 112: its
# attention is plain torch), the resampler (64 queries, 32 heads), Mistral-7B
# (32 layers, 8 KV heads: n_rep 4), 448 px images as scripts/bench_12b_serve.py
# feeds them (the 16 x 16 position table re-gridded to 32 x 32, the
# resampler's 8 x 8 sincos table to 32 x 32), the head shaped to the fake
# tokenizer's printable ids (phase 13's HEAD_GAIN). 16a bf16: the encode, the
# shared-prefix and plain autocheck, diverse_gen, 3-beam chat decoding, the
# kernels against attn_impl "dense"; 16e (on 16a's model) stage 3 of the
# pipeline on phase 13's yes/no questions; 16b the same model quantised in
# place (both towers int8, the head bf16, an int8 KV cache: the JAX package's
# 12B headline, bench_12b_serve's batch 8); 16c that model through the fused
# engine; 16d the seed-0 model rebuilt and quantised to int4 on both towers.
# Depth and widths are the published ones; repeats and tokens are cut to keep
# the phase near two minutes.
OMNI_IMAGE = 448
OMNI_QUERIES = 64  # the resampler's queries: image tokens a row
OMNI_BATCH = 8
OMNI_NEW = 64
OMNI_DIVERSE = (["Describe the image in detail.", "What is happening here?"], 5)
OMNI_GREEDY = ["What is in the image?", "Describe the scene.", "What colors do you see?",
               "Is it daytime?"]
OMNI_FORCED = 4
# 16a's kernels (#1 prefill, #4 steps) against attn_impl "dense", as a share
# of max|first logit|: phase 5's 0.05 holds LLaVA-1.5, but this random 12B
# model drifts further from a change of rounding: read 0.0625 (prefill) and
# 0.0708 (4 steps) on an H100 80GB HBM3, and the shared prefix against the
# plain path 0.053 over the whole vocabulary. 16a logs beside them the dense
# route against itself one prompt at a time, and the norm of a resampled
# image token beside a text embedding's. The bound sits ~2x outside the
# readings, as phase 12's FUSED_LOGIT_REL_TOL does
OMNI_LOGIT_REL_TOL = 0.15


def _omni_images(image_bytes: bytes) -> list:
    """Two images: examples/test.jpeg and its mirror image (numpy)."""
    from PIL import Image, ImageOps

    from rlaifv_tpu_torch.data.image_processing import decode_image

    img = decode_image(image_bytes)
    return [np.asarray(img), np.asarray(ImageOps.mirror(img))]


def _omni_items(images: list, questions, per_image: bool = True) -> list:
    """Each question about each image (image-major), or question i about
    image i % len(images)."""
    pairs = ([(im, q) for im in images for q in questions] if per_image
             else [(images[i % len(images)], q) for i, q in enumerate(questions)])
    return [{"question": q, "question_id": i, "image": im,
             "metainfos": {"ds_question_id": f"omni{i}"}} for i, (im, q) in enumerate(pairs)]


def build_omnilmm(tok, tag: str):
    """OmniLMM-12B in bf16 on the card, random weights from seed 0, the
    head's rows of printable ids x HEAD_GAIN and the others zeroed."""
    t0 = time.perf_counter()
    model = OmniLMMForCausalLM(OmniLMMConfig.omnilmm_12b(), device="meta").to_empty(
        device="cuda")
    init_omnilmm_weights_(model, torch.Generator(device="cuda").manual_seed(0)).eval()
    shape_head_(model.llm.lm_head.weight, printable_ids(tok))
    torch.cuda.synchronize()
    parts = {name: sum(p.numel() for p in getattr(model, name).parameters()) / 1e9
             for name in ("vision_tower", "resampler", "llm")}
    cfg = model.cfg
    log(f"[{tag}] OmniLMM-12B bf16 on cuda: {sum(parts.values()):.3f} B params (EVA02-enormous "
        f"{parts['vision_tower']:.3f}: {cfg.vision.embed_dim} wide, {len(model.vision_tower.blocks)}"
        f" of {cfg.vision.depth} blocks run, MLP {cfg.vision.mlp_hidden}; resampler "
        f"{parts['resampler']:.3f}: {cfg.num_query} queries, {cfg.resampler.num_heads} heads; "
        f"Mistral-7B {parts['llm']:.3f}: {cfg.llm.num_layers} layers, I "
        f"{cfg.llm.intermediate_size}, {cfg.llm.num_kv_heads} KV heads for "
        f"{cfg.llm.num_heads}), {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
        f"built in {time.perf_counter() - t0:.1f} s; random weights (seed 0)")
    return model


class PathPlan:
    """The launches a path plans, read off its calls inside a `with`: each
    pass of the language model `llm` (where one is given) plans #1 a layer
    where ops/attention.py:attention_route says "flash", #4 a layer on a
    decode step it routes to "decode", #5 a layer on an int8-cache decode
    step in the kernel's domain; each quantised projection (QuantDense,
    both towers) plans its forward kernel by rows and bits (#9 from
    INT8_DEQUANT_MIN_M rows on INT8_LARGE_M_IMPL "prequant", #7 below; #11
    where its kernel takes the shapes) and, when its output takes a
    gradient, its dx (#10 after #9, #8 after #7; #12 up to INT4_DX_MAX_N
    columns, the dequant formula above). Backwards count the gradients that
    arrive (a hook on the output). Counted beside the launch counters, from
    the shapes and the routes' own rules."""

    def __init__(self, llm: LlamaForCausalLM = None):
        self.llm, self.counts = llm, {}

    def _add(self, key: str, n: int) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def _when_grad(self, out: torch.Tensor, keys: dict) -> None:
        if out.requires_grad:
            def planned(grad):
                for key, n in keys.items():
                    self._add(key, n)
            out.register_hook(planned)

    def _attention(self, L: int, attention_mask, cache, cache_index) -> None:
        cfg = self.llm.cfg
        impl = next(m.attn_impl for m in self.llm.modules() if isinstance(m, LlamaAttention))
        n_rep = cfg.num_heads // cfg.num_kv_heads
        if cache is not None and "k_scale" in cache[0] and L == 1:
            if impl != "dense" and (impl != "auto" or kernel_domain(
                    cfg.dtype, cfg.head_size, n_rep, decode=True)):
                self._add("decode_int8", cfg.num_layers)
            return
        Lk, q_offset = L, None
        if cache is not None and "k_scale" not in cache[0]:
            Lk, q_offset = cache[0]["k"].shape[1], cache_index
        route = attention_route(Lq=L, Lk=Lk, D=cfg.head_size, q_offset=q_offset,
                                has_mask=attention_mask is not None, on_cuda=True,
                                dtype=cfg.dtype, n_rep=n_rep, impl=impl)
        if route in ("flash", "decode"):
            self._add(route, cfg.num_layers)

    def __enter__(self):
        product = llama_mod.quant_product
        dx_of = {"int8": "int8_dx", "int8_prequant": "int8_dx_prequant"}

        def planned_product(x, q, scale, bits):
            out = product(x, q, scale, bits)
            if bits == 4:
                kernel = i4._impl() == "kernel" and i4._kernel_legal(q, scale)
                if kernel:
                    self._add("int4", 1)
                self._when_grad(out, {"int4_dx" if kernel and q.shape[1] <= i4.INT4_DX_MAX_N
                                      else "int4_dequant_dx": 1})
                return out
            impl = qm._large_m_impl() if qm._rows(x) >= qm.INT8_DEQUANT_MIN_M else "kernel"
            fwd = {"prequant": "int8_prequant", "kernel": "int8"}.get(impl)
            if fwd:
                self._add(fwd, 1)
                self._when_grad(out, {dx_of[fwd]: 1})
            return out

        self._product = product
        llama_mod.quant_product = planned_product
        if self.llm is not None:
            forward = self.llm.forward

            def planned_forward(input_ids=None, *, inputs_embeds=None, attention_mask=None,
                                cache=None, cache_index=None, **kw):
                L = (input_ids if inputs_embeds is None else inputs_embeds).shape[1]
                self._attention(L, attention_mask, cache, cache_index)
                return forward(input_ids, inputs_embeds=inputs_embeds,
                               attention_mask=attention_mask, cache=cache,
                               cache_index=cache_index, **kw)

            self.llm.forward = planned_forward
        return self

    def __exit__(self, *exc):
        if self.llm is not None:
            del self.llm.forward  # the class's method again
        llama_mod.quant_product = self._product

    def check(self, tag: str, launches: dict, keys) -> None:
        """Each named kernel's launches against the plan; raise if one is
        off or a planned kernel never ran."""
        rows = [(k, launches.get(k, 0), self.counts.get(k, 0)) for k in keys]
        ok = all(got == want for _, got, want in rows) and any(want for *_, want in rows)
        log(f"[{tag}] launches against the path's plan: " + ", ".join(
            f"{k} {got} (planned {want})" for k, got, want in rows)
            + f" | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: launches differ from the plan: {rows}")


def _omni_rates(tag: str, n: int, what: str, seconds: float) -> float:
    rate = n / seconds
    log(f"[{tag}] {what}: {n} in {seconds:.3f} s = {rate:.2f}/s")
    return rate


def phase_omni_bf16(gen: OmniLMMGenerator, image_bytes: bytes) -> tuple:
    """16a: the encode's time per image, autocheck of 2 images x 8 facts
    through the shared prefix and plain (their yes/no logits within phase
    5's bound), diverse_gen 2 x 5 repeats (generate_repeated), 3-beam chat
    decoding with SamplingParams.chat_12b(), each counted against its
    plan (#1 a layer a prefill pass, #4 a layer a decode step, beams
    included), and the kernels' prefill and 4 forced steps against attn_impl
    "dense" -> (launches, rates)."""
    tag = "16a omnilmm bf16"
    model, eng = gen.model, gen.engine
    images = _omni_images(image_bytes)
    facts = _omni_items(images, FACTS)
    pix = torch.from_numpy(np.stack([gen.processor(im) for im in images] * 4)).cuda()
    with torch.inference_mode():
        feat_norm = model.encode_images(pix[:1]).float().norm(dim=-1).mean().item()
        text_norm = model.llm.model.tok_embed.weight.float().norm(dim=-1).mean().item()
        enc1 = time_ms(lambda: model.encode_images(pix[:1]), 5)
        enc8 = time_ms(lambda: model.encode_images(pix), 3)
        vit8 = time_ms(lambda: model.vision_tower(pix), 3)
        # one block of the tower at 8 images, and its attention alone (plain
        # torch: fp32 scores and softmax, the head dim 112 outside #1's domain)
        vt = model.cfg.vision
        grid = OMNI_IMAGE // vt.patch_size
        L, H = grid * grid + 1, vt.num_heads
        x = torch.randn((OMNI_BATCH, L, vt.embed_dim), device="cuda").to(torch.bfloat16)
        q, k, v = (torch.randn((OMNI_BATCH, L, H, vt.embed_dim // H), device="cuda").to(
            torch.bfloat16) for _ in range(3))
        block = time_ms(lambda: model.vision_tower.blocks[0](x, None), 5)
        attn = time_ms(lambda: dense_attention(q, k, v, None), 5)
        del x, q, k, v
    log(f"[{tag}] encode (EVA02-enormous at {OMNI_IMAGE} px: {grid} x {grid} + 1 tokens, the "
        f"pos table re-gridded {vt.grid} -> {grid}; then the resampler): one image "
        f"{enc1:.2f} ms, {OMNI_BATCH} images {enc8:.2f} ms = {enc8 / OMNI_BATCH:.2f} ms an "
        f"image (the tower alone {vit8 / OMNI_BATCH:.2f}); one block at {OMNI_BATCH} images "
        f"{block:.3f} ms, its attention alone (plain fp32 torch) {attn:.3f} ms; a resampled "
        f"token's norm {feat_norm:.2f} on average, a text embedding's {text_norm:.3f}")
    rates = dict(encode_ms=enc8 / OMNI_BATCH, block_ms=block, attn_ms=attn)
    gen.autocheck(facts[:2], batch_size=OMNI_BATCH)  # warm-up
    gen.diverse_gen(_omni_items(images[:1], ["Warm up."] * 2), max_new_tokens=2)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    with PathPlan(model.llm) as plan:
        reset_counts()
        t0 = time.perf_counter()
        shared = gen.autocheck(facts, batch_size=OMNI_BATCH)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plain = gen.autocheck(facts, batch_size=OMNI_BATCH, shared_prefix=False)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rates["facts_s"] = _omni_rates(tag, len(facts), "autocheck facts, shared prefix",
                                       t1 - t0)
        rates["facts_plain_s"] = _omni_rates(tag, len(facts), "autocheck facts, plain (one "
                                             "encode and prefill a fact)", t2 - t1)
        steps0 = read_counts()["decode"]
        qs, rep = OMNI_DIVERSE
        sampled = gen.diverse_gen(_omni_items(images[:1], [q for q in qs for _ in range(rep)]),
                                  max_new_tokens=OMNI_NEW, seed=0)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        n_layers = model.cfg.llm.num_layers
        steps = (read_counts()["decode"] - steps0) // n_layers
        n_div = rep * (steps + len(qs))
        rates["diverse_tok_s"] = _omni_rates(
            tag, n_div, f"diverse_gen {len(qs)} x {rep} repeats (generate_repeated: one encode "
            f"and prefill a question), {steps} decode steps: tokens", t3 - t2)
        beam_items = _omni_items(images, OMNI_GREEDY[:2], per_image=False)
        steps0 = read_counts()["decode"]
        beams = gen.generate_beam(beam_items, num_beams=3, sampling=SamplingParams.chat_12b(),
                                  max_new_tokens=OMNI_NEW, seed=0)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        bsteps = (read_counts()["decode"] - steps0) // n_layers
        rates["beam_tok_s"] = _omni_rates(
            tag, len(beam_items) * (bsteps + 1), f"generate_beam 3 beams (chat_12b sampling) "
            f"of {len(beam_items)} rows, {bsteps} steps: tokens of the best beams", t4 - t3)
        launches = read_counts()
    rates["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] launches: " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f"; peak {rates['peak_gb']:.2f} GiB")
    plan.check(tag, launches, ("flash", "decode", "decode_int8"))
    assert len(sampled) == rep * len(qs) and all(isinstance(r["answer"], str) for r in sampled)
    assert len(beams) == 2 and all(isinstance(r[1], str) for r in beams)

    # the shared prefix against the plain path: the yes/no probabilities of
    # the 16 facts, then the logits of 8 facts about one image at the yes/no
    # ids (the gate) and over the whole vocabulary; the plain path encodes
    # the image at batch 8 and at batch 1 (the shared path's batch)
    d_prob = max(abs(a["scores"][w] - b["scores"][w]) for a, b in zip(shared, plain)
                 for w in a["scores"])
    prompts, starts, pixels = gen._prepare(facts[:8])
    P = int(starts[0]) + gen.num_query + 1
    via_prefix = torch.from_numpy(eng.score_shared_prefix(
        prompts[0][:P], [p[P:] for p in prompts], image=pixels[0],
        image_start=int(starts[0]), batch_size=OMNI_BATCH))
    via_plain = torch.from_numpy(eng.generate(prompts, images=pixels, image_starts=starts,
                                              max_new_tokens=1).first_logits)
    via_one = torch.from_numpy(np.concatenate([eng.generate(
        prompts[i:i + 1], images=pixels[i:i + 1], image_starts=starts[i:i + 1],
        max_new_tokens=1).first_logits for i in range(len(prompts))]))
    yn = list(omni_yesno_ids(gen.tokenizer).values())
    scale = via_plain.abs().max().item()
    d_yn = (via_prefix[:, yn] - via_plain[:, yn]).abs().max().item()
    d_all = (via_prefix - via_plain).abs().max().item()
    d_one = (via_prefix - via_one).abs().max().item()
    ok = d_yn <= SLICE_REL_TOL * scale and d_prob <= PROB_TOL and \
        bool(torch.isfinite(via_prefix).all())
    log(f"[{tag}] shared prefix (prefix {P} tokens) vs plain path, 8 facts of one image: "
        f"yes/no logits max|d| {d_yn:.4f} vs max|logit| {scale:.3f} (tol {SLICE_REL_TOL} x "
        f"max) | max|dp| over the 16 facts' yes/no {d_prob:.3e} (tol {PROB_TOL}) | "
        f"{'ok' if ok else 'FAIL'}; over the whole vocabulary max|d| {d_all:.4f} against "
        f"the plain path at batch 8, {d_one:.4f} against it at batch 1")
    if not ok:
        raise AssertionError("16a: the shared prefix disagrees with the plain path")

    # the kernels (#1 prefill, #4 steps) against attn_impl "dense"
    prompts, starts, pixels = gen._prepare(_omni_items(images, OMNI_GREEDY, per_image=False))
    keep = printable_ids(gen.tokenizer)
    tokens = torch.as_tensor(keep, device="cuda")[torch.randint(
        len(keep), (len(prompts), OMNI_FORCED), generator=torch.Generator().manual_seed(0)).cuda()]
    fast = _forced_logits(eng, prompts, starts, pixels, tokens, ("auto", "auto"))
    dense = _forced_logits(eng, prompts, starts, pixels, tokens, ("dense", "dense"))
    # the dense route against itself, each prompt alone: the same function
    # at other GEMM shapes, i.e. the model's own bf16 drift
    alone = torch.cat([_forced_logits(eng, prompts[i:i + 1], starts[i:i + 1],
                                      pixels[i:i + 1], tokens[i:i + 1], ("dense", "dense"))
                       for i in range(len(prompts))], dim=1)
    ok = all(bool(torch.isfinite(r).all()) for r in (fast, dense, alone))
    first = dense[0].abs().max()
    for text, steps in (("prefill: #1 vs dense", slice(0, 1)),
                        (f"decode steps 1-{OMNI_FORCED}: #4 vs dense", slice(1, None))):
        rel = ((fast[steps] - dense[steps]).abs().max() / first).item()
        drift = ((alone[steps] - dense[steps]).abs().max() / first).item()
        cos = torch.nn.functional.cosine_similarity(
            fast[steps].flatten(0, -2), dense[steps].flatten(0, -2), dim=-1).min().item()
        good = rel <= OMNI_LOGIT_REL_TOL
        ok = ok and good
        log(f"[{tag} vs plain] {text}: max|d| / max|first logit| {rel:.4f} (tol "
            f"{OMNI_LOGIT_REL_TOL}; the dense route against itself one prompt at a time "
            f"{drift:.4f}), least row cosine {cos:.5f} | {'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError("16a: the kernels disagree with attn_impl dense")
    return launches, rates


def phase_omni_labeler(gen: OmniLMMGenerator, work: str) -> dict:
    """16e: the reference's labeler configuration: stage 3 of the pipeline
    (pipeline.stage_autocheck) scores phase 13's yes/no questions with
    OmniLMM-12B, then stage 4 (pairs) and 5 (length balance) on its scores;
    each file's rows -> the launches."""
    tag = "16e omnilmm labeler"
    results = os.path.join(work, "results")
    qas = next(os.path.join(results, n) for n in sorted(os.listdir(results))
               if n.endswith(".gq.qas.jsonl") and not n.startswith("autocheck_"))
    gq = next(os.path.join(results, n) for n in sorted(os.listdir(results))
              if n.endswith(".gq.jsonl"))
    out_dir = os.path.join(work, "omnilmm")
    os.makedirs(out_dir, exist_ok=True)
    reset_counts()
    t0 = time.perf_counter()
    scored = pipe.stage_autocheck(gen, qas, out_dir, batch_size=OMNI_BATCH)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_counts()
    balanced = pipe.stage_length_balance(pipe.stage_pairs(scored, gq, sample_num=2))
    n_qas, n_scored = len(read_jsonlines(qas)), len(read_jsonlines(scored))
    log(f"[{tag}] stage_autocheck on phase 13's {os.path.basename(qas)} ({n_qas} yes/no "
        f"questions): {n_scored} rows in {t1 - t0:.2f} s = {n_scored / (t1 - t0):.2f} facts/s")
    for name, rows in _stage_files(out_dir).items():
        log(f"[{tag}] {name}: {len(rows)} rows")
    if n_scored != n_qas or not all(0.0 <= p <= 1.0 for r in read_jsonlines(scored)
                                    for p in r["scores"].values()):
        raise AssertionError("16e: the labeler's rows do not match the questions")
    assert balanced.endswith("_balanceshort.jsonl")
    return launches


def phase_omni_int8(gen: OmniLMMGenerator, image_bytes: bytes) -> tuple:
    """16b: 16a's model quantised in place (both towers int8, the head
    bf16, an int8 KV cache; OmniLMMConfig.omnilmm_12b_int8): autocheck at
    batch 8 on the plain path (bench_12b_serve's geometry: one encode and
    prefill a fact), one greedy generate, each launch against the plan;
    the prefill and 4 forced steps against attn_impl "dense" on a bf16
    cache (phase 11's bounds) -> (launches, rates)."""
    tag = "16b omnilmm int8"
    model = gen.model
    t0 = time.perf_counter()
    quantize_llm_int8(model, include_lm_head=False)
    quantize_vision_int8(model)
    set_llm_config(model, kv_cache_dtype="int8")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] both towers quantised to int8 in place (the head and the resampler bf16), the "
        f"cache int8, in {time.perf_counter() - t0:.1f} s: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    images = _omni_images(image_bytes)
    facts = _omni_items(images, FACTS)
    greedy = _omni_items(images, OMNI_GREEDY, per_image=False)
    gen.autocheck(facts[:2], batch_size=OMNI_BATCH, shared_prefix=False)  # warm-up
    torch.cuda.synchronize()
    rates = {}
    torch.cuda.reset_peak_memory_stats()
    with PathPlan(model.llm) as plan:
        reset_counts()
        t0 = time.perf_counter()
        scored = gen.autocheck(facts, batch_size=OMNI_BATCH, shared_prefix=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rates["facts_s"] = _omni_rates(tag, len(facts), f"autocheck facts at batch {OMNI_BATCH}"
                                       " (plain: one encode and prefill a fact)", t1 - t0)
        rows = gen.generate(greedy, sampling=SamplingParams.greedy(), max_new_tokens=OMNI_NEW)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = read_counts()
    n_layers = model.cfg.llm.num_layers
    steps = launches["decode_int8"] // n_layers
    rates["tok_s"] = _omni_rates(tag, len(greedy) * (steps + 1), f"greedy generate of "
                                 f"{len(greedy)} rows, {steps} steps: tokens", t2 - t1)
    rates["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] launches: " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f"; peak {rates['peak_gb']:.2f} GiB")
    plan.check(tag, launches, ("flash", "decode", "decode_int8", "int8", "int8_prequant"))
    assert len(scored) == len(facts) and len(rows) == len(greedy)

    prompts, starts, pixels = gen._prepare(greedy)
    keep = printable_ids(gen.tokenizer)
    tokens = torch.as_tensor(keep, device="cuda")[torch.randint(
        len(keep), (len(prompts), OMNI_FORCED), generator=torch.Generator().manual_seed(0)).cuda()]
    path = _forced_logits(gen.engine, prompts, starts, pixels, tokens, ("auto", "auto"))
    set_llm_config(model, kv_cache_dtype="fp")
    dense = _forced_logits(gen.engine, prompts, starts, pixels, tokens, ("dense", "dense"))
    set_llm_config(model, kv_cache_dtype="int8")
    ok = bool(torch.isfinite(path).all() and torch.isfinite(dense).all())
    for text, a, b in (("prefill: the path (fresh-window #1) vs dense on a bf16 cache",
                        path[:1], dense[:1]),
                       (f"decode steps 1-{OMNI_FORCED}: the path (#5) vs dense on a bf16 cache",
                        path[1:], dense[1:])):
        rel, cos = _logit_gap(a, b)
        good = rel <= INT8_KV_REL_TOL and cos >= INT8_KV_COS_MIN
        ok = ok and good
        log(f"[{tag} vs plain] {text}: max|d| / max|ref| {rel:.4f} (tol {INT8_KV_REL_TOL}), "
            f"least row cosine {cos:.5f} (tol {INT8_KV_COS_MIN}) | {'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError("16b: the int8 path disagrees with the dense route")
    return launches, rates


def phase_omni_fused(gen: OmniLMMGenerator, image_bytes: bytes) -> tuple:
    """16c: 16b's model with its projections fused, served through the
    fused engine (the LLM's weights stacked in place): one greedy generate
    with #16 once a decode step and no #4, #5 or #7 anywhere in the run,
    then 4 forced steps with each step's #16 against its twin on the same
    cache -> (launches, rates)."""
    tag = "16c omnilmm fused"
    fuse_llm_projections_(gen.model)
    fgen = OmniLMMGenerator(gen.model, gen.tokenizer, image_size=OMNI_IMAGE,
                            checkpoint_name=gen.checkpoint_name, fused_decode=True)
    images = _omni_images(image_bytes)
    greedy = _omni_items(images, OMNI_GREEDY, per_image=False)
    fgen.generate(greedy[:1], sampling=SamplingParams.greedy(), max_new_tokens=2)  # warm-up
    spy, step = types.SimpleNamespace(steps=0), fgen.engine._step

    def counted(*a):
        spy.steps += 1
        return step(*a)

    fgen.engine._step = counted
    reset_counts()
    t0 = time.perf_counter()
    rows = fgen.generate(greedy, sampling=SamplingParams.greedy(), max_new_tokens=OMNI_NEW)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_counts()
    fgen.engine._step = step
    rates = {"tok_s": _omni_rates(tag, len(greedy) * (spy.steps + 1), f"greedy generate of "
                                  f"{len(greedy)} rows, {spy.steps} steps: tokens", t1 - t0)}
    decode_free = ("decode", "decode_int8", "int8")
    ok = launches["fused"] == spy.steps > 0 and not any(launches[k] for k in decode_free) \
        and launches["int8_prequant"] > 0 and len(rows) == len(greedy)
    log(f"[{tag}] launches: " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f" | #16 {launches['fused']} = {spy.steps} decode steps, #4/#5/#7 "
        f"{sum(launches[k] for k in decode_free)} | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"16c: the fused path's launches: {launches}")
    prompts, starts, pixels = fgen._prepare(greedy)
    keep = printable_ids(gen.tokenizer)
    tokens = torch.as_tensor(keep, device="cuda")[torch.randint(
        len(keep), (len(prompts), OMNI_FORCED), generator=torch.Generator().manual_seed(0)).cuda()]
    kern, twin, spread = _fused_forced(fgen.engine, prompts, starts, pixels, tokens)
    ok = all(bool(torch.isfinite(r).all()) for r in (kern, twin, spread))
    rel, cos = _logit_gap(spread[1:], twin[1:])
    log(f"[{tag} vs plain] the twin against itself with each step's x one ulp up: max|d| / "
        f"max|ref| {rel:.4f}, least row cosine {cos:.5f}")
    rel, cos = _logit_gap(kern[1:], twin[1:])
    good = ok and rel <= FUSED_LOGIT_REL_TOL and cos >= FUSED_LOGIT_COS_MIN
    log(f"[{tag} vs plain] decode steps 1-{OMNI_FORCED}: kernel #16 vs the twin on the same "
        f"cache: max|d| / max|ref| {rel:.4f} (tol {FUSED_LOGIT_REL_TOL}), least row cosine "
        f"{cos:.5f} (tol {FUSED_LOGIT_COS_MIN}) | {'ok' if good else 'FAIL'}")
    if not good:
        raise AssertionError("16c: kernel #16 disagrees with its twin at OmniLMM-12B")
    return launches, rates


def phase_omni_int4(tok, image_bytes: bytes) -> tuple:
    """16d: the seed-0 model rebuilt, both towers quantised to int4 on the
    card (group 128, the head bf16, an int8 cache): one autocheck batch of
    8 facts on the plain path, #11 against the plan -> (launches, rates)."""
    tag = "16d omnilmm int4"
    model = build_omnilmm(tok, tag)
    t0 = time.perf_counter()
    quantize_llm_int4(model, include_lm_head=False)
    quantize_vision_int4(model)
    set_llm_config(model, kv_cache_dtype="int8")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] both towers quantised to int4 in place in {time.perf_counter() - t0:.1f} s: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    gen = OmniLMMGenerator(model, tok, image_size=OMNI_IMAGE, checkpoint_name="random-omnilmm-12b")
    facts = _omni_items(_omni_images(image_bytes), FACTS[:OMNI_BATCH // 2])
    gen.autocheck(facts[:1], batch_size=OMNI_BATCH, shared_prefix=False)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with PathPlan(model.llm) as plan:
        reset_counts()
        t0 = time.perf_counter()
        scored = gen.autocheck(facts, batch_size=OMNI_BATCH, shared_prefix=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = read_counts()
    rates = {"facts_s": _omni_rates(tag, len(facts), f"autocheck facts at batch {OMNI_BATCH} "
                                    "(plain)", t1 - t0),
             "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[{tag}] launches: " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f"; peak {rates['peak_gb']:.2f} GiB")
    plan.check(tag, launches, ("flash", "int4", "int8", "int8_prequant"))
    assert len(scored) == len(facts) and all(
        0.0 <= p <= 1.0 for r in scored for p in r["scores"].values())
    del gen, model
    return launches, rates


def phase_omnilmm(tok, image_bytes: bytes, work: str, smi: str) -> dict:
    """16: OmniLMM-12B's serving slice, a-e (above) -> the launches of its
    counted runs."""
    model = build_omnilmm(tok, "16 omnilmm")
    gen = OmniLMMGenerator(model, tok, image_size=OMNI_IMAGE,
                           checkpoint_name="random-omnilmm-12b")
    launches, bf16 = timed("16a omnilmm bf16", phase_omni_bf16, gen, image_bytes)
    add_counts(launches, timed("16e omnilmm labeler", phase_omni_labeler, gen, work))
    int8_launches, int8 = timed("16b omnilmm int8", phase_omni_int8, gen, image_bytes)
    add_counts(launches, int8_launches)
    fused_launches, fused = timed("16c omnilmm fused", phase_omni_fused, gen, image_bytes)
    add_counts(launches, fused_launches)
    del gen, model
    gc.collect()
    torch.cuda.empty_cache()
    int4_launches, int4 = timed("16d omnilmm int4", phase_omni_int4, tok, image_bytes)
    add_counts(launches, int4_launches)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[16 omnilmm] {smi}: bf16 encode {bf16['encode_ms']:.2f} ms an image (a block at "
        f"{OMNI_BATCH} images {bf16['block_ms']:.3f} ms, its attention {bf16['attn_ms']:.3f}), autocheck "
        f"{bf16['facts_s']:.2f} facts/s shared / {bf16['facts_plain_s']:.2f} plain, diverse_gen "
        f"{bf16['diverse_tok_s']:.1f} tok/s, 3-beam chat {bf16['beam_tok_s']:.1f} tok/s, peak "
        f"{bf16['peak_gb']:.2f} GiB | int8 autocheck {int8['facts_s']:.2f} facts/s at batch "
        f"{OMNI_BATCH}, generate {int8['tok_s']:.1f} tok/s, peak {int8['peak_gb']:.2f} GiB | "
        f"fused generate {fused['tok_s']:.1f} tok/s | int4 autocheck {int4['facts_s']:.2f} "
        f"facts/s, peak {int4['peak_gb']:.2f} GiB | launches {launches}")
    return launches


# 17: OmniLMM-12B QLoRA training, configs/omnilmm_dpo_qlora.json (17a: LLM
# projections int8, EVA02 tower bf16) and omnilmm_dpo_qlora_int4.json (17b:
# both towers int4), each loaded unchanged and quantised by the entry
# point's own `quantize_base`; phase 8's 16 rows and 9's short row in the omni
# convention (omni_preprocess, a literal <im_patch> span) at 448 px. The
# keys whose launches each counted run holds to its plan:
TRAIN_KEYS = ("flash", "dq", "dkv", "int8", "int8_dx", "int8_prequant", "int8_dx_prequant",
              "int4", "int4_dx", "head_fwd", "head_dl", "head_dx", "head_dw")
OMNI_QLORA = (("17a omnilmm int8", "omnilmm_dpo_qlora.json"),
              ("17b omnilmm int4", "omnilmm_dpo_qlora_int4.json"))
# 17's bounds. The gate on the kernels is exact: step 0 on the kernel
# route against the twin route (`twin_products`: every int8 / int4 product
# by its plain twin on the card, the same int8 operands summed exactly in
# fp64, the row passes and every other kernel kept), the loss, both logps
# and every adapter gradient equal bit for bit; 3d / 3e hold the product
# kernels bit-equal to the twins at this phase's shapes, and the other
# kernels are deterministic, so a sound run repeats the twin route's bits.
# Two planted faults (OMNI_FAULTS) go through the same comparison and must
# fail it. The bounds below, set from readings (NVIDIA H100 80GB HBM3,
# PERF.md section 6), hold the quantised routes to the float formula.
# This random 12B model moves far more than LLaVA under any change of
# rounding (its resampled image tokens have norm ~63 against ~1.3 for text,
# 16a), and an int8 or int4 projection turns an ulp of difference into a
# whole step of its row's quantisation (tools/omni_witness.py reads the
# same comparisons with every attention forced dense). Shared-prefix
# reference logps against the plain scorer (fused head) on the same base:
# sums and means max rel 0.0273 (int8) / 0.0184 (int4), per-token |d| mean
# 0.235 / 0.247 nats; on the bf16 base 0.0025 and 0.061 (phase 8's bounds,
# 5e-3 and 0.05, are LLaVA's); the bounds sit ~2x outside the quantised
# readings
OMNI_REF_RTOL = 0.06
OMNI_REF_TOKEN_TOL = 0.5
# Step 0 against the "dequant" route (as in 9 and 10): logps max rel
# 2.15e-3 / 2.49e-3 (phase 9's QLORA_LOGP_RTOL holds), losses 0.089 / 0.230
# apart; the DPO margin's b gradients rel 0.68-0.78 / 0.50-0.70, cosine >=
# 0.730 / 0.797 (phase 9's 0.6 / 0.85 do not hold); the SFT term's rel
# 0.086-0.485 / 0.095-0.514, cosine >= 0.882 / 0.868. The bounds sit ~1.5x
# outside the readings (rel, 1 - cosine), ~2x for the loss
OMNI_ROUTE_TOL = dict(logp=QLORA_LOGP_RTOL, loss=0.5, rel=1.2, cos=0.6, sft_rel=0.8,
                      sft_cos=0.8)
# 17's planted faults around the sound product kernels of the base (#9 /
# #10 on int8, #11 / #12 on int4), on step 0: every dx the kernel returns
# doubled, and each forward product without the last 128 columns of its
# contraction (the rows' operand zeroed there: a dropped stage)
OMNI_FAULTS = ("dx doubled", "last contraction slice dropped")
# Step 0 near ln 2: the reference logps come from the shared-prefix engine
# (the prefix left-padded) and the policy's from the paired forward (right-
# padded): read +0.107 (int8) / +0.140 (int4), a margin of ~2-3 nats on
# sequences of ~2600. Held ~2x outside the readings
OMNI_LN2_TOL = 0.3


class TrainPlan(PathPlan):
    """A training path's plan: PathPlan's quantised projections, and each
    attention call (not each pass: a training pass's calls take the paired
    path's own shapes) plans #1 where ops/attention.py:attention_route says
    "flash" and, when its output takes a gradient, #2 and #3; each
    fused-head forward plans #13/#14 and, when its logps take a gradient,
    #15's dl and dx once a vocabulary chunk (`chunk_width`), dW where the
    head trains. Forwards count every call, a remat recompute included."""

    def __enter__(self):
        super().__enter__()
        attention, head_fwd, head_apply = (llama_mod.multi_head_attention, fh.fused_head_fwd,
                                           fh._FusedHead.apply)

        def planned_attention(q, k, v, *, attention_mask=None, causal=True, q_offset=None,
                              impl="auto"):
            same = q.dtype == k.dtype == v.dtype
            route = attention_route(Lq=q.shape[1], Lk=k.shape[1], D=q.shape[3],
                                    q_offset=q_offset, has_mask=attention_mask is not None,
                                    on_cuda=q.is_cuda, dtype=q.dtype if same else None,
                                    n_rep=q.shape[2] // k.shape[2], impl=impl)
            out = attention(q, k, v, attention_mask=attention_mask, causal=causal,
                            q_offset=q_offset, impl=impl)
            if route == "flash":
                self._add("flash", 1)
                self._when_grad(out, {"dq": 1, "dkv": 1})
            return out

        def planned_head_fwd(x, w, y):
            if x.is_cuda:
                self._add("head_fwd", 1)
            return head_fwd(x, w, y)

        def planned_head_apply(x, w, y):
            logp = head_apply(x, w, y)
            chunks = -(-w.shape[0] // chunk_width(x.shape[0], w.shape[0]))
            self._when_grad(logp, {"head_dl": chunks, "head_dx": chunks,
                                   "head_dw": chunks if w.requires_grad else 0})
            return logp

        self._restore = (attention, head_fwd)
        llama_mod.multi_head_attention = paired_mod.multi_head_attention = planned_attention
        fh.fused_head_fwd = planned_head_fwd
        fh._FusedHead.apply = planned_head_apply
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        attention, head_fwd = self._restore
        llama_mod.multi_head_attention = paired_mod.multi_head_attention = attention
        fh.fused_head_fwd = head_fwd
        del fh._FusedHead.apply  # torch.autograd.Function's again


@contextlib.contextmanager
def twin_products():
    """Inside, every int8 / int4 product kernel of a quantised projection
    (#7-#12) is replaced by its plain twin on the card: the same int8
    operands summed exactly (fp64), then the kernels' own fp32 rounding
    and scaling. The row passes and every other kernel stay. Nothing here
    launches #7-#12."""
    saved = [(m, n, getattr(m, n)) for m, n in (
        (qm, "_kernel_fwd"), (qm, "_kernel_dx"), (qm, "_kernel_prequant"),
        (qm, "_kernel_dx_prequant"), (i4, "_kernel_fwd"), (i4, "_kernel_dx"))]
    bf16 = torch.bfloat16
    qm._kernel_fwd = lambda x2, q, scale, plan=None: qm.int8_matmul_plain(x2, q, scale)
    qm._kernel_dx = qm.int8_matmul_dx_plain
    qm._kernel_prequant = lambda xq, sx, q, scale, plan=None: qm.int8_matmul_prequant_plain(
        xq, sx.reshape(-1, 1), q, scale).to(bf16)
    qm._kernel_dx_prequant = lambda dyq, sy, q: qm.int8_matmul_dx_prequant_plain(
        dyq, sy.reshape(-1, 1), q).to(bf16)
    i4._kernel_fwd = lambda xq, sx, qp, gs: i4.int4_product_plain(
        xq, sx.reshape(-1, 1), qp, gs).to(bf16)
    i4._kernel_dx = i4.int4_matmul_dx_plain
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


@contextlib.contextmanager
def omni_fault(name: str, bits: int):
    """One of OMNI_FAULTS planted around the sound kernels inside: the
    large-row int8 kernels (#9, #10) or the int4 ones (#11, #12)."""
    owner, fwd, dx = (qm, "_kernel_prequant", "_kernel_dx_prequant") if bits == 8 \
        else (i4, "_kernel_fwd", "_kernel_dx")
    attr = dx if name == "dx doubled" else fwd
    real = getattr(owner, attr)

    def doubled(*args):
        return 2 * real(*args)

    def sliced(xq, *args):
        xq = xq.clone()
        xq[:, -128:] = 0
        return real(xq, *args)

    setattr(owner, attr, doubled if name == "dx doubled" else sliced)
    try:
        yield
    finally:
        setattr(owner, attr, real)


def omni_grad_names(n_layers: int) -> dict:
    """The adapter gradients 17 compares by relative error and cosine: the
    b of q, v and down in the first and last layers."""
    return {f"layer {i} {p} b": f"llm/model/layer_{i}/{blk}/{p}/b"
            for i in (0, n_layers - 1)
            for blk, p in (("attn", "q_proj"), ("attn", "v_proj"), ("mlp", "down_proj"))}


def step0_verdict(run: tuple, twin: tuple, deq: tuple, names: dict, tol: dict) -> dict:
    """17's step-0 comparison of `run` (loss, logps, every adapter gradient
    by tensor name): equal to the twin route's bit for bit, and within tol
    of the dequant route's (loss, logps, the `names` gradients by relative
    error and cosine)."""
    equal = run[0] == twin[0] and run[1] == twin[1] and \
        all(torch.equal(g, twin[2][n]) for n, g in run[2].items())
    max_d = max((g - twin[2][n]).abs().max().item() for n, g in run[2].items())
    d_loss, d_logp, grads = compare_runs(
        (run[0], run[1], {k: run[2][n] for k, n in names.items()}), deq)
    near = d_loss <= tol["loss"] and d_logp <= tol["logp"] and all(
        r <= tol["rel"] and cs >= tol["cos"] for r, cs in grads.values())
    return dict(equal=equal, max_d=max_d, d_loss_twin=abs(run[0] - twin[0]), d_loss=d_loss,
                d_logp=d_logp, grads=grads, near=near, ok=equal and near)


def _verdict_text(v: dict, tol: dict) -> str:
    return (f"against the twin route: equal bit for bit {v['equal']} (loss |d| "
            f"{v['d_loss_twin']:.3e}, gradients max|d| {v['max_d']:.3e}) | against the dequant "
            f"route: loss |d| {v['d_loss']:.4f} (tol {tol['loss']}), logps max rel "
            f"{v['d_logp']:.2e} (tol {tol['logp']}), "
            + " | ".join(f"{k}: rel {r:.3e} cos {cs:.6f}" for k, (r, cs) in v["grads"].items())
            + f" (tol rel {tol['rel']}, cos {tol['cos']}): within {v['near']}")


def omni_items(rows: list, tok, logps=None) -> list:
    """The (rej, win) items DPODataset builds from parquet rows in the omni
    convention (omni_preprocess, the <image> tag expanded to <im_start>
    <im_patch>*64 <im_end> as text), at 448 px, with their reference
    logps."""
    spec = get_family("omnilmm")
    mm_cfg = spec.mm_cfg(spec.image_processor(OMNI_IMAGE), OMNI_QUERIES)
    items = _encode_rows(rows, tok, mm_cfg, spec.preprocess_func)
    for (rej, win), lp in zip(items, logps or []):
        win["ref_win_logp"], win["ref_win_avg_logp"], win["ref_win_per_token_logp"] = lp[:3]
        rej["ref_rej_logp"], rej["ref_rej_avg_logp"], rej["ref_rej_per_token_logp"] = lp[3:]
    return items


def omni_batches(rows: list, short, tok, c, ref=None) -> dict:
    """17, data: the config's pairs a step (the first rows) collated as
    train.py collates them (DPOCollator's bucket 256, the <im_patch> span
    located, max_len from the config), its shared prefix derived (P = the
    first <im_patch> + 64: the image ends inside the prefix); given a short
    row, its pair with the suffix trimmed to the labels (W a multiple of 16,
    or the rest of the row where that is shorter; 2 W rows <
    INT8_DEQUANT_MIN_M)."""
    t = c.training
    collator = DPOCollator(pad_token_id=tok.pad_token_id, max_len=c.data.max_len,
                           num_patches=OMNI_QUERIES, beta=t.dpo_beta,
                           **get_family("omnilmm").collator_kwargs(tok))
    items = omni_items(rows + ([short] if short else []), tok, ref)
    batch = collator(items[:t.per_device_batch_pairs])
    P = derive_shared_prefix_len(batch, OMNI_QUERIES)
    validate_shared_prefix(batch, P, OMNI_QUERIES)
    assert P == int(batch["image_starts"].max()) + OMNI_QUERIES, P
    out = dict(batch_np=batch, P=P)
    if short:
        sbatch = collator(items[-1:])
        Ps = derive_shared_prefix_len(sbatch, OMNI_QUERIES)
        last = int(np.nonzero((sbatch["labels"] != IGNORE_INDEX).any(axis=0))[0].max()) + 1
        W = min(-(-(last - Ps) // 16) * 16, sbatch["labels"].shape[1] - Ps)
        validate_shared_prefix(sbatch, Ps, OMNI_QUERIES, suffix_len=W)
        assert 2 * W < qm.INT8_DEQUANT_MIN_M, (W, qm.INT8_DEQUANT_MIN_M)
        out.update(short_np=sbatch, Ps=Ps, W=W)
    return out


def omni_pair(rows: list, tok) -> dict:
    """3b's 12B pair: the first row collated alone as phase 17 collates."""
    c = Config.from_json(str(ROOT / "configs" / OMNI_QLORA[0][1]))
    c.training.per_device_batch_pairs = 1
    return omni_batches(rows, None, tok, c)


def _omni_train_model(tok, c, tag: str):
    """The entry point's build_omnilmm for config `c` on the card, random
    weights from seed 0 (the head shaped to the printable ids, as phase
    16's), then its `quantize_base`: the config's own
    quantisation rule, in place."""
    t0 = time.perf_counter()
    cfg, model = build_omnilmm_entry(c, "cuda")
    init_omnilmm_weights_(model, torch.Generator(device="cuda").manual_seed(0))
    shape_head_(model.llm.lm_head.weight, printable_ids(tok))
    quantize_base(c, model)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    llm_q = [m for m in model.llm.modules() if isinstance(m, QuantDense)]
    tower_q = [m for m in model.vision_tower.modules() if isinstance(m, QuantDense)]
    bits, depth = c.model.quantize_bits, len(model.vision_tower.blocks)
    qkv = model.vision_tower.blocks[0].attn.qkv
    log(f"[{tag}] OmniLMM-12B by the entry point's build_omnilmm (remat "
        f"{model.cfg.llm.remat}), random weights (seed 0), quantised by its quantize_base in "
        f"{time.perf_counter() - t0:.1f} s: {len(llm_q)} int{bits} QuantDense in the LLM "
        f"(7 x {cfg.llm.num_layers}), {len(tower_q)} in the EVA02 tower ({depth} blocks; "
        f"qkv {type(qkv).__name__}"
        f"{'' if isinstance(qkv, QuantDense) else ' ' + str(qkv.weight.dtype)}), lm_head "
        f"{type(model.llm.lm_head).__name__} {model.llm.lm_head.weight.dtype} | "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    if len(llm_q) != 7 * cfg.llm.num_layers or any(m.bits != bits for m in llm_q + tower_q) \
            or len(tower_q) != (4 * depth if bits == 4 else 0) \
            or isinstance(model.llm.lm_head, QuantDense) or not model.cfg.llm.remat \
            or (bits == 8 and qkv.weight.dtype != torch.bfloat16):
        raise AssertionError(f"{tag}: the base is not the config's quantisation rule")
    return model


def _planned_run(tag: str, fn):
    """fn() with every counter at 0 inside a TrainPlan -> (its result, the
    launches, seconds, the plan's counts); the launches held to the plan."""
    torch.cuda.synchronize()
    with TrainPlan() as plan:
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = read_counts()
    plan.check(tag, n, TRAIN_KEYS)
    return out, n, dt, plan.counts


def phase_omni_qlora(tok, rows: list, short: dict, tag: str, name: str) -> tuple:
    """17a / 17b: the config's base, the reference logps of the 16 rows and
    the short one on it (shared prefix, against the plain scorer), step 0
    against the "dequant" route (DPO and SFT gradients), 3 AdamW steps of
    the config's 4 pairs, one short step -> (launches, rates)."""
    c = Config.from_json(str(ROOT / "configs" / name))
    t, bits = c.training, c.model.quantize_bits
    assert c.model.model_family == "omnilmm" and c.model.quantize and t.use_lora
    assert t.per_device_batch_pairs == 4 and c.data.max_len == 2048
    assert t.shared_prefix_len == -1 and getattr(t, "lm_head_impl", "auto") == "auto"
    model = _omni_train_model(tok, c, tag)
    cfg, spec = model.cfg, get_family("omnilmm")
    n_layers = cfg.llm.num_layers
    launches = {}

    # the reference logps on the quantised base
    kw = dict(max_len=c.data.max_len, num_patches=cfg.num_image_tokens, batch_pairs=8,
              image_processor=spec.image_processor(OMNI_IMAGE), progress=False,
              family="omnilmm")
    score_preference_rows(rows[:2], model, tok, shared_prefix=True, **kw)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ref, n, ref_s, _ = _planned_run(f"{tag} ref-logp", lambda: score_preference_rows(
        rows + [short], model, tok, shared_prefix=True, **kw))
    add_counts(launches, n)
    ref_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    plain = score_preference_rows(rows + [short], model, tok, shared_prefix=False,
                                  lm_head_impl="fused", **kw)
    rel, tmean, tmax = _seq_close(ref, plain, OMNI_REF_RTOL)
    ok = rel <= OMNI_REF_RTOL and tmean <= OMNI_REF_TOKEN_TOL and \
        all(np.isfinite(r[k]) for r in ref for k in (0, 1, 3, 4))
    log(f"[{tag}] ref-logp on the int{bits} base (shared-prefix path): {len(ref)} pairs in "
        f"{ref_s:.3f} s = {len(ref) / ref_s:.2f} pairs/s | peak {ref_gb:.2f} GiB | launches "
        + ", ".join(f"{k} {n[k]}" for k in TRAIN_KEYS if n[k])
        + f" | against the plain scorer (fused head, not counted): sums and means max rel "
        f"{rel:.3e} (tol {OMNI_REF_RTOL}), per-token |d| mean {tmean:.3e} (tol "
        f"{OMNI_REF_TOKEN_TOL}) max {tmax:.3e} | logps row 0 {ref[0][0]:.2f}/{ref[0][3]:.2f} | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: the shared-prefix reference logps disagree with the "
                             "plain scorer")

    qb = omni_batches(rows, short, tok, c, ref)
    hp = DPOHparams(beta=t.dpo_beta, dpo_use_average=t.dpo_use_average,
                    lm_head_impl=resolve_head(t, cfg.llm.hidden_size, cfg.llm.dtype),
                    shared_prefix_len=qb["P"])
    assert hp.lm_head_impl == "fused", hp.lm_head_impl
    batch = batch_to_device(qb["batch_np"], "cuda")
    adapter = spec.adapter(model)
    assert type(adapter).__name__ == "OmnilmmDPOAdapter"
    model.train()
    lora = lora_init(torch.Generator(device="cuda").manual_seed(t.seed), model, r=t.lora_r)
    n_lora = sum(x.numel() for _, x in named_tensors(lora))
    optimizer = make_optimizer(lora, QLORA_LR, total_steps=t.max_steps, warmup_ratio=0.0,
                               weight_decay=t.weight_decay, max_grad_norm=t.max_grad_norm,
                               schedule="constant")
    step = make_lora_dpo_train_step(adapter, optimizer, hp, lora, lora_alpha=t.lora_alpha)
    feats = adapter.encode_images_fn(batch["images"][:1])  # grad mode on, base frozen
    tower_graph = feats.requires_grad
    del feats
    B, (L, P) = t.per_device_batch_pairs, (qb["batch_np"]["input_ids"].shape[1], qb["P"])
    tokens = B * P + 2 * B * (L - P)
    real = B * P + int(qb["batch_np"]["attention_mask"][:, P:].sum())
    log(f"[{tag}] {B} pairs padded to L={L} (bucket 256), image spans at "
        f"{sorted(set(int(s) for s in qb['batch_np']['image_starts']))}, derived P={P} "
        f"(array {-(-P // 128) * 128}), W={L - P}: {tokens} tokens a step, {real} not "
        f"padding | adapters r {t.lora_r} alpha {t.lora_alpha} on the LLM's 7 x {n_layers} "
        f"projections: {n_lora / 1e6:.1f} M fp32 values | head {hp.lm_head_impl}, remat, "
        f"constant lr {QLORA_LR} | the frozen tower's features require grad: {tower_graph}")
    if tower_graph:
        raise AssertionError(f"{tag}: the frozen EVA02 tower records a graph")

    # step 0, none of it counted: on the kernel route, the twin route and
    # the "dequant" route (DPO loss and the SFT term), then with each
    # planted fault through the same comparison
    names = omni_grad_names(n_layers)
    every = {nm: nm for nm, _ in named_tensors(lora)}
    tol = OMNI_ROUTE_TOL
    owner, attr, kernel_impl = (qm, "INT8_LARGE_M_IMPL", "prequant") if bits == 8 \
        else (i4, "INT4_IMPL", "kernel")
    hp_sft = dataclasses.replace(hp, dpo_weight=0.0, sft_weight=1.0)

    def loss_grads(hp_, grads=every):
        return _lora_loss_grads(model, adapter, batch, hp_, lora, t.lora_alpha, grads)

    setattr(owner, attr, "dequant")
    try:
        deq, sft_deq = loss_grads(hp, names), loss_grads(hp_sft, names)
    finally:
        setattr(owner, attr, kernel_impl)
    t0 = time.perf_counter()
    ker = loss_grads(hp)
    torch.cuda.synchronize()
    ker_s = time.perf_counter() - t0
    with twin_products():
        t0 = time.perf_counter()
        twin = loss_grads(hp)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
    verdict = step0_verdict(ker, twin, deq, names, tol)
    log(f"[{tag}] step 0, {kernel_impl} (kernels) route: loss {ker[0]:.6f}, logps "
        f"{ker[1][0]:.2f}/{ker[1][1]:.2f} ({ker_s:.2f} s; the twin route {twin_s:.2f} s) | "
        + _verdict_text(verdict, tol) + f" | {'ok' if verdict['ok'] else 'FAIL'}")
    if not verdict["ok"]:
        raise AssertionError(f"{tag}: step 0 disagrees with the twin or the dequant route")
    _, _, sft_grads = compare_runs(loss_grads(hp_sft, names), sft_deq)
    ok = all(r <= tol["sft_rel"] and cs >= tol["sft_cos"] for r, cs in sft_grads.values())
    log(f"[{tag}] step 0, SFT term (chosen mean logp), {kernel_impl} vs dequant route: "
        + " | ".join(f"{k}: rel {r:.3e} cos {cs:.6f}" for k, (r, cs) in sft_grads.items())
        + f" (tol rel {tol['sft_rel']}, cos {tol['sft_cos']}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: the SFT gradient disagrees with the dequant route")
    for fault in OMNI_FAULTS:
        with omni_fault(fault, bits):
            v = step0_verdict(loss_grads(hp), twin, deq, names, tol)
        log(f"[{tag}] step 0, planted fault {fault!r}: " + _verdict_text(v, tol)
            + f" | {'caught' if not v['ok'] else 'MISSED'}")
        if v["ok"]:
            raise AssertionError(f"{tag}: the step-0 comparison misses the fault {fault!r}")
    del ker, twin

    losses, times, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        metrics, n, dt, planned = _planned_run(f"{tag} step {i}", lambda: step(batch))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        times.append(dt)
        add_counts(launches, n)
        losses.append(loss)
        per_step.append({k: n[k] for k in TRAIN_KEYS if n[k]})
        log(f"[{tag}] step {i}: loss {loss:.6e} grad_norm {gnorm:.4e} | {dt:.3f} s | "
            f"launches {per_step[-1]} (dequant dx planned "
            f"{planned.get('int4_dequant_dx', 0)}; the head is frozen)")
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
            raise AssertionError(f"{tag}: non-finite loss or zero grad norm at step {i}")
        if i == 0 and abs(loss - math.log(2)) > OMNI_LN2_TOL:
            raise AssertionError(f"{tag}: step-0 loss {loss} not within {OMNI_LN2_TOL} "
                                 "of ln 2")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = statistics.mean(times[1:])
    rates = dict(step_s=step_s, pairs_s=B / step_s, tokens_s=tokens / step_s,
                 real_tokens_s=real / step_s, peak_gb=peak_gb, ref_pairs_s=len(ref) / ref_s,
                 ref_gb=ref_gb, launches_step=per_step[-1])
    log(f"[{tag}] steps 1-2 (after step 0): {step_s:.3f} s a step = {B / step_s:.3f} "
        f"pairs/s = {tokens / step_s:.0f} tokens/s with padding, {real / step_s:.0f} "
        f"without | peak device memory {peak_gb:.2f} GiB | loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} (step 0 within {OMNI_LN2_TOL} of ln 2 = {math.log(2):.6f}: "
        f"{losses[0] - math.log(2):+.3e})")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: the loss did not fall over 2 updates: {losses}")

    # the short pair: its suffix rows (2 W) take #7 / #8 (int8) or #11 / #12
    Ps, W = qb["Ps"], qb["W"]
    short_step = make_lora_dpo_train_step(
        adapter, optimizer, dataclasses.replace(hp, shared_prefix_len=Ps, shared_suffix_len=W),
        lora, lora_alpha=t.lora_alpha)
    metrics, n, dt, _ = _planned_run(f"{tag} short step", lambda: short_step(
        batch_to_device(qb["short_np"], "cuda")))
    add_counts(launches, n)
    loss = float(metrics["loss"])
    log(f"[{tag}] short step: 1 pair, P={Ps}, suffix trimmed to W={W} ({2 * W} rows < "
        f"{qm.INT8_DEQUANT_MIN_M}): loss {loss:.6e} | {dt:.3f} s | launches "
        f"{ {k: n[k] for k in TRAIN_KEYS if n[k]} }")
    small = ("int8", "int8_dx") if bits == 8 else ("int4", "int4_dx")
    if not math.isfinite(loss) or min(n[k] for k in small) < 1:
        raise AssertionError(f"{tag}: the short step missed its kernels: {n}")
    rates["short_s"] = dt
    del step, short_step, optimizer, lora, batch, model, adapter
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rates


def phase_omni_train(tok, image_bytes: bytes, smi: str) -> dict:
    """17: OmniLMM-12B QLoRA training, 17a int8 then 17b int4 (each on a
    seed-0 model of its own, the other freed) -> the launches of their
    counted runs."""
    rows, short = synth_rows(image_bytes), short_row(image_bytes)
    launches, rates = {}, {}
    for tag, name in OMNI_QLORA:
        n, rates[tag] = timed(tag, phase_omni_qlora, tok, rows, short, tag, name)
        add_counts(launches, n)
    log(f"[17 omnilmm qlora] {smi}: " + " | ".join(
        f"{tag}: {r['step_s']:.3f} s a step, {r['pairs_s']:.3f} pairs/s, "
        f"{r['tokens_s']:.0f} tokens/s ({r['real_tokens_s']:.0f} without padding), peak "
        f"{r['peak_gb']:.2f} GiB; ref-logp {r['ref_pairs_s']:.2f} pairs/s, peak "
        f"{r['ref_gb']:.2f} GiB; short step {r['short_s']:.3f} s; launches a step "
        f"{r['launches_step']}" for tag, r in rates.items())
        + f" | launches {launches}")
    return launches


# 18: MiniCPM-Llama3-V 2.5, the reference's third VLM family and a labeler
# of its own (SURVEY.md M13, G3), at full width and depth with random weights
# from seed 0: SigLIP-so400m (27 blocks of width 1152, head dim 72: its
# attention is plain torch, outside #1's domain; the 70 x 70 position table
# re-gridded per slice), the resampler (96 queries, 32 heads, no query-side
# table, each slice's sincos grid on the keys), Llama3-8B (32 layers, 8 KV
# heads for 32: n_rep 4, rope theta 500000, vocabulary 128256) with the head
# shaped to the fake tokenizer's printable ids (phase 13's HEAD_GAIN), images
# sliced by the real slicer (data/minicpmv_slicing.py): examples/test.jpeg
# and its mirror give a source of 546 x 364 px and a 2 x 1 grid of 392 x 518
# px slices, three 96-token spans a row. 18a bf16: the encode, the
# shared-prefix and plain autocheck, diverse_gen (generate_repeated), one
# chat, a 3-beam generate_beam with spans, the kernels against attn_impl
# "dense"; 18e (on 18a's model) greedy continuous with spans against
# generate; 18b the model quantised in place (int8 LLM, bf16 head and
# SigLIP, int8 KV: MiniCPMVConfig.minicpm_llama3_v25_int8) at
# scripts/bench_minicpmv_serve.py's geometry (B 8 items of 5 slices, the
# source and a 2 x 2 grid of 448 px, Q 96: 896 x 896 px images, prompts
# padded to MCV_BENCH_LP); 18c that model through the fused engine; 18d the
# seed-0 model rebuilt with an int4 LLM. Repeats and tokens are cut as
# phase 16's.
MCV_NEW = 64
MCV_BENCH_B, MCV_BENCH_PX, MCV_BENCH_SLICES = 8, 896, 5
MCV_BENCH_LP = MCV_MS[1] // MCV_BENCH_B  # bench_minicpmv_serve: (5 x 96 + 96) to 64
# 18a's kernels (#1 prefill, #4 steps) against attn_impl "dense", as a share
# of max|first logit|. Phase 5's 0.05 holds LLaVA-1.5; this random model,
# like 16a's, carries resampled tokens of norm ~64 against ~1.3 for text,
# and its own bf16 drift fills that bound: read on an H100 80GB HBM3, #1
# 0.0464 and #4 0.0497 against "dense", and the dense route against itself
# one prompt at a time (the same function at other GEMM shapes) 0.0389 on
# the decode steps. The bound sits ~2x outside the readings, as 16a's
MCV_LOGIT_REL_TOL = 0.1
# 18a's shared prefix against the plain path on the yes/no probabilities:
# phase 5's PROB_TOL holds LLaVA-1.5, whose yes/no logits sit near the
# vocabulary's bulk; this random model's do not (its head keeps only the
# printable ids), and its resampled tokens have norm ~64 against ~1.3 for
# text, so the same relative logit drift moves p further. Read on an H100
# 80GB HBM3: max|dp| 1.548e-3 with the yes/no logits 0.0160 of max|logit|
# apart (phase 5's logit bound, 0.05, holds; 0.0398 over the whole
# vocabulary). The bound sits ~3x outside the reading
MCV_PROB_TOL = 5e-3
MCV_CONT = ["Is it daytime?", "Any people?", "Is it dark?", "What colour?", "Is it wet?",
            "Any cars?"]  # x 2 images: 12 distinct prompts through CONT_SMALL_SLOTS


def build_minicpmv(tok, tag: str) -> MiniCPMVForCausalLM:
    """MiniCPM-Llama3-V 2.5 in bf16 on the card, random weights from seed 0,
    the head's rows of printable ids x HEAD_GAIN and the others zeroed."""
    t0 = time.perf_counter()
    model = MiniCPMVForCausalLM(MiniCPMVConfig.minicpm_llama3_v25(), device="meta").to_empty(
        device="cuda")
    init_minicpmv_weights_(model, torch.Generator(device="cuda").manual_seed(0)).eval()
    shape_head_(model.llm.lm_head.weight, printable_ids(tok))
    torch.cuda.synchronize()
    parts = {name: sum(p.numel() for p in getattr(model, name).parameters()) / 1e9
             for name in ("vpm", "resampler", "llm")}
    cfg = model.cfg
    log(f"[{tag}] MiniCPM-Llama3-V 2.5 bf16 on cuda: {sum(parts.values()):.3f} B params "
        f"(SigLIP-so400m {parts['vpm']:.3f}: {cfg.vision.hidden_size} wide, "
        f"{cfg.vision.num_layers} blocks, {cfg.vision.num_heads} heads of "
        f"{cfg.vision.hidden_size // cfg.vision.num_heads}, MLP {cfg.vision.intermediate_size}, "
        f"a {cfg.vision.grid} x {cfg.vision.grid} position table; resampler "
        f"{parts['resampler']:.3f}: {cfg.query_num} queries, {cfg.resampler.num_heads} heads; "
        f"Llama3-8B {parts['llm']:.3f}: {cfg.llm.num_layers} layers, I "
        f"{cfg.llm.intermediate_size}, {cfg.llm.num_kv_heads} KV heads for {cfg.llm.num_heads}, "
        f"vocab {cfg.llm.vocab_size}), {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated, built in {time.perf_counter() - t0:.1f} s; random weights (seed 0)")
    return model


def _mcv_bench_images(image_bytes: bytes) -> list:
    """18b's images: examples/test.jpeg and its mirror resized to
    MCV_BENCH_PX square, which the slicer cuts into a 448 px source and a
    2 x 2 grid of 448 px slices."""
    from PIL import Image

    return [np.asarray(Image.fromarray(im).resize((MCV_BENCH_PX, MCV_BENCH_PX),
                                                  Image.Resampling.BICUBIC))
            for im in _omni_images(image_bytes)]


def _slice_buckets(gen: MiniCPMVGenerator, items: list) -> list:
    """The items' slices, normalised and grouped by shape as _prepare
    encodes them: one (N, H, W, 3) fp32 tensor on the card a bucket."""
    buckets: dict = {}
    for item in items:
        for s in gen._build_prompt(item)[2]:
            arr = np.asarray(s, np.uint8)
            buckets.setdefault(arr.shape, []).append(gen._normalize(arr))
    return [torch.from_numpy(np.stack(b)).cuda() for b in buckets.values()]


def _mcv_tokens(gen: MiniCPMVGenerator, n: int) -> torch.Tensor:
    keep = printable_ids(gen.tokenizer)
    return torch.as_tensor(keep, device="cuda")[torch.randint(
        len(keep), (n, OMNI_FORCED), generator=torch.Generator().manual_seed(0)).cuda()]


def phase_mcv_bf16(gen: MiniCPMVGenerator, image_bytes: bytes) -> tuple:
    """18a: the encode's time a slice and an item, autocheck of 2 images x 8
    facts through the shared prefix and plain (their yes/no logits within
    phase 5's bound), diverse_gen 2 x 5 repeats (generate_repeated), one
    chat and a 3-beam generate_beam with spans, each counted against its
    plan (#1 a layer a prefill pass, #4 a layer a decode step), and the
    kernels' prefill and 4 forced steps against attn_impl "dense" ->
    (launches, rates)."""
    tag = "18a minicpmv bf16"
    model, eng = gen.model, gen.engine
    images = _omni_images(image_bytes)
    facts = _omni_items(images, FACTS)
    ids, starts, slices = gen._build_prompt(facts[0])
    vt = model.cfg.vision
    item_buckets = _slice_buckets(gen, facts[:1])
    cells = next(b for b in item_buckets if b.shape[0] > 1)
    eight = cells.repeat(4, 1, 1, 1)  # 8 slices of one shape
    gh, gw = eight.shape[1] // vt.patch_size, eight.shape[2] // vt.patch_size
    H = vt.num_heads
    with torch.inference_mode():
        feat_norm = model.encode_slices(eight[:1]).float().norm(dim=-1).mean().item()
        text_norm = model.llm.model.tok_embed.weight.float().norm(dim=-1).mean().item()
        enc_item = time_ms(lambda: [model.encode_slices(b) for b in item_buckets], 5)
        enc8 = time_ms(lambda: model.encode_slices(eight), 3)
        vit8 = time_ms(lambda: model.vpm(eight), 3)
        x = torch.randn((8, gh * gw, vt.hidden_size), device="cuda").to(torch.bfloat16)
        q, k, v = (torch.randn((8, gh * gw, H, vt.hidden_size // H), device="cuda").to(
            torch.bfloat16) for _ in range(3))
        block = time_ms(lambda: model.vpm.layers[0](x), 5)
        attn = time_ms(lambda: dense_attention(q, k, v, None), 5)
        del x, q, k, v, eight
    log(f"[{tag}] slices of one item: {[tuple(s.size) for s in slices]} px, spans at {starts} "
        f"in a {len(ids)}-token prompt; encode (SigLIP-so400m, the {vt.grid} x {vt.grid} "
        f"position table re-gridded to each slice's grid, then the resampler at that grid): "
        f"one item ({len(slices)} slices, {len(item_buckets)} shape buckets) {enc_item:.2f} ms; "
        f"8 slices of {gh} x {gw} patches {enc8:.2f} ms = {enc8 / 8:.2f} ms a slice (the tower "
        f"alone {vit8 / 8:.2f}); one block at 8 slices {block:.3f} ms, its attention alone "
        f"(plain torch, head dim {vt.hidden_size // H}) {attn:.3f} ms; a resampled token's norm "
        f"{feat_norm:.2f} on average, a text embedding's {text_norm:.3f}")
    rates = dict(encode_slice_ms=enc8 / 8, encode_item_ms=enc_item, block_ms=block,
                 attn_ms=attn)
    gen.autocheck(facts[:2], batch_size=OMNI_BATCH)  # warm-up
    gen.diverse_gen(_omni_items(images[:1], ["Warm up."] * 2), max_new_tokens=2)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    n_layers = model.cfg.llm.num_layers
    with PathPlan(model.llm) as plan:
        reset_counts()
        t0 = time.perf_counter()
        shared = gen.autocheck(facts, batch_size=OMNI_BATCH)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plain = gen.autocheck(facts, batch_size=OMNI_BATCH, shared_prefix=False)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rates["facts_s"] = _omni_rates(tag, len(facts), "autocheck facts, shared prefix (one "
                                       "slice encode and prefix prefill an image)", t1 - t0)
        rates["facts_plain_s"] = _omni_rates(tag, len(facts), "autocheck facts, plain (one "
                                             "encode and prefill a fact)", t2 - t1)
        steps0 = read_counts()["decode"]
        qs, rep = OMNI_DIVERSE
        sampled = gen.diverse_gen(_omni_items(images[:1], [q for q in qs for _ in range(rep)]),
                                  max_new_tokens=MCV_NEW, seed=0)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        steps = (read_counts()["decode"] - steps0) // n_layers
        rates["diverse_tok_s"] = _omni_rates(
            tag, rep * (steps + len(qs)), f"diverse_gen {len(qs)} x {rep} repeats "
            f"(generate_repeated: one encode and prefill a question), {steps} decode steps: "
            "tokens", t3 - t2)
        steps0 = read_counts()["decode"]
        answer = gen.chat(OMNI_GREEDY[0], images[0], max_new_tokens=MCV_NEW)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        csteps = (read_counts()["decode"] - steps0) // n_layers
        rates["chat_tok_s"] = _omni_rates(tag, csteps + 1, f"chat (T 0.7, top-p 0.8, "
                                          f"repetition 1.05), {csteps} steps: tokens", t4 - t3)
        beam_items = _omni_items(images, OMNI_GREEDY[:2], per_image=False)
        prompts, feats, sst = gen._prepare(beam_items)
        steps0 = read_counts()["decode"]
        beams = eng.generate_beam(prompts, span_features=feats, span_starts=sst, num_beams=3,
                                  max_new_tokens=MCV_NEW)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        bsteps = (read_counts()["decode"] - steps0) // n_layers
        rates["beam_tok_s"] = _omni_rates(
            tag, len(beam_items) * (bsteps + 1), f"generate_beam with spans, 3 beams of "
            f"{len(beam_items)} rows, {bsteps} steps: tokens of the best beams", t5 - t4)
        launches = read_counts()
    rates["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] launches: " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f"; peak {rates['peak_gb']:.2f} GiB")
    plan.check(tag, launches, ("flash", "decode", "decode_int8"))
    assert len(sampled) == rep * len(qs) and all(isinstance(r["answer"], str) for r in sampled)
    assert isinstance(answer, str) and beams.tokens.shape[0] == len(beam_items)

    # the shared prefix against the plain path: the yes/no probabilities of
    # the 16 facts, then the logits of 8 facts about one image at the yes/no
    # ids (the gate) and over the whole vocabulary
    d_prob = max(abs(a["scores"][w] - b["scores"][w]) for a, b in zip(shared, plain)
                 for w in a["scores"])
    prompts, feats, sst = gen._prepare(facts[:8])
    P = eng.longest_common_prefix_len(prompts)
    via_prefix = torch.from_numpy(eng.score_shared_prefix(
        prompts[0][:P], [p[P:] for p in prompts], span_features=feats[0], span_starts=sst[0],
        batch_size=OMNI_BATCH))
    via_plain = torch.from_numpy(eng.generate(prompts, span_features=feats, span_starts=sst,
                                              max_new_tokens=1).first_logits)
    yn = list(gen._yesno_ids().values())
    scale = via_plain.abs().max().item()
    d_yn = (via_prefix[:, yn] - via_plain[:, yn]).abs().max().item()
    d_all = (via_prefix - via_plain).abs().max().item()
    ok = d_yn <= SLICE_REL_TOL * scale and d_prob <= MCV_PROB_TOL and \
        bool(torch.isfinite(via_prefix).all())
    log(f"[{tag}] shared prefix ({P} tokens, spans ending at {int(sst[0].max()) + 96}) vs "
        f"plain path, 8 facts of one image: yes/no logits max|d| {d_yn:.4f} vs max|logit| "
        f"{scale:.3f} (tol {SLICE_REL_TOL} x max) | max|dp| over the 16 facts' yes/no "
        f"{d_prob:.3e} (tol {MCV_PROB_TOL}) | {'ok' if ok else 'FAIL'}; over the whole "
        f"vocabulary max|d| {d_all:.4f}")
    if not ok:
        raise AssertionError("18a: the shared prefix disagrees with the plain path")

    # the kernels (#1 prefill, #4 steps) against attn_impl "dense"
    prompts, feats, sst = gen._prepare(_omni_items(images, OMNI_GREEDY, per_image=False))
    tokens = _mcv_tokens(gen, len(prompts))
    spans = (feats, sst)
    fast = _forced_logits(eng, prompts, None, None, tokens, ("auto", "auto"), spans)
    dense = _forced_logits(eng, prompts, None, None, tokens, ("dense", "dense"), spans)
    alone = torch.cat([_forced_logits(eng, prompts[i:i + 1], None, None, tokens[i:i + 1],
                                      ("dense", "dense"), (feats[i:i + 1], sst[i:i + 1]))
                       for i in range(len(prompts))], dim=1)
    ok = all(bool(torch.isfinite(r).all()) for r in (fast, dense, alone))
    first = dense[0].abs().max()
    for text, sl in (("prefill: #1 vs dense", slice(0, 1)),
                     (f"decode steps 1-{OMNI_FORCED}: #4 vs dense", slice(1, None))):
        rel = ((fast[sl] - dense[sl]).abs().max() / first).item()
        drift = ((alone[sl] - dense[sl]).abs().max() / first).item()
        cos = torch.nn.functional.cosine_similarity(
            fast[sl].flatten(0, -2), dense[sl].flatten(0, -2), dim=-1).min().item()
        good = rel <= MCV_LOGIT_REL_TOL
        ok = ok and good
        log(f"[{tag} vs plain] {text}: max|d| / max|first logit| {rel:.4f} (tol "
            f"{MCV_LOGIT_REL_TOL}; the dense route against itself one prompt at a time "
            f"{drift:.4f}), least row cosine {cos:.5f} | {'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError("18a: the kernels disagree with attn_impl dense")
    return launches, rates


def phase_mcv_continuous(gen: MiniCPMVGenerator, image_bytes: bytes, smi: str) -> dict:
    """18e: greedy generate_continuous with spans (the "spans" refill mode)
    on 12 prompts (6 questions x 2 images) through CONT_SMALL_SLOTS slots
    on 18a's bf16 engine, against generate (phase 15's comparison); the
    first wave bit-equal to generate of its prompts alone; the launches and
    host syncs against the plan -> the launches."""
    tag = "18e minicpmv continuous"
    items = _omni_items(_omni_images(image_bytes), MCV_CONT)
    prompts, feats, sst = gen._prepare(items)
    eng = gen.engine
    eng.generate_continuous(prompts[:2], span_features=feats[:2], span_starts=sst[:2], slots=2,
                            max_new_tokens=2)  # warm-up
    out = _greedy_vs_generate(tag, eng, prompts, None, None, CONT_SMALL_SLOTS, CONT_NEW, smi,
                              spans=(feats, sst), wave_bit_equal=True)
    n_layers = gen.model.cfg.llm.num_layers
    st = _cont_check(tag, n_layers, out["launches"], out["runs"], "decode", n_layers)
    n = len(prompts) * CONT_NEW
    log(f"[{tag}] {len(prompts)} prompts x {CONT_NEW} through {CONT_SMALL_SLOTS} slots: "
        f"{out['wall']:.3f} s, {n / out['wall']:.1f} tok/s ({st['steps']} steps) | {smi}")
    return out["launches"]


def phase_mcv_int8(gen: MiniCPMVGenerator, image_bytes: bytes) -> tuple:
    """18b: 18a's model quantised in place (int8 LLM, the head, resampler
    and SigLIP bf16, an int8 KV cache) at bench_minicpmv_serve's geometry:
    the encode of 8 items x 5 slices, the prefill of their 8 x
    MCV_BENCH_LP-token prompts, autocheck at batch 8 on the plain path (one
    encode and prefill a fact), the decode step from a 65-token generate,
    each launch against the plan; the prefill and 4 forced steps against
    the dense route on a bf16 cache (phase 11's bounds) -> (launches,
    rates, the eager forced logits and first logits phase 18c compares
    with)."""
    tag = "18b minicpmv int8"
    model, eng = gen.model, gen.engine
    t0 = time.perf_counter()
    quantize_llm_int8(model, include_lm_head=False)
    set_llm_config(model, kv_cache_dtype="int8")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] the LLM quantised to int8 in place (the head, resampler and SigLIP bf16), "
        f"the cache int8, in {time.perf_counter() - t0:.1f} s: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    items = _omni_items(_mcv_bench_images(image_bytes), FACTS[:MCV_BENCH_B // 2])
    prompts, feats, sst = gen._prepare(items)
    Lp = -(-max(len(p) for p in prompts) // 64) * 64
    buckets = _slice_buckets(gen, items)
    n_slices = sum(b.shape[0] for b in buckets)
    log(f"[{tag}] bench_minicpmv_serve's geometry: {len(items)} items of {MCV_BENCH_PX} px, "
        f"{feats.shape[1]} spans a row ({n_slices} slices of "
        f"{[tuple(b.shape[1:3]) for b in buckets]} px), Q {feats.shape[2]}, prompts of "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens padded to {Lp}")
    if feats.shape[1] != MCV_BENCH_SLICES or Lp != MCV_BENCH_LP or len(buckets) != 1:
        raise AssertionError(f"18b: not the bench geometry: {feats.shape}, Lp {Lp}")
    gen.autocheck(items[:2], batch_size=MCV_BENCH_B, shared_prefix=False)  # warm-up
    with torch.inference_mode():
        enc = time_ms(lambda: model.encode_slices(buckets[0]), 3)
    rates = {"encode_ms": enc}
    torch.cuda.reset_peak_memory_stats()
    with PathPlan(model.llm) as plan:
        reset_counts()
        t0 = time.perf_counter()
        scored = gen.autocheck(items, batch_size=MCV_BENCH_B, shared_prefix=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rates["facts_s"] = _omni_rates(tag, len(items), f"autocheck facts at batch "
                                       f"{MCV_BENCH_B} (plain: one encode and prefill a fact)",
                                       t1 - t0)
        walls = {}
        for new in (1, 65):
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            res = eng.generate(prompts, span_features=feats, span_starts=sst,
                               max_new_tokens=new)
            torch.cuda.synchronize()
            walls[new] = time.perf_counter() - t2
        launches = read_counts()
    rates["prefill_ms"] = walls[1] * 1e3
    rates["decode_step_ms"] = (walls[65] - walls[1]) / 64 * 1e3
    rates["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] encode of the {n_slices} slices {enc:.2f} ms ({enc / n_slices:.2f} ms a "
        f"slice, {enc / len(items):.2f} an item); prefill of {len(items)} x {Lp} tokens with "
        f"the splice (generate of 1 token) {rates['prefill_ms']:.2f} ms; a decode step at "
        f"batch {len(items)} ((generate of 65 - generate of 1) / 64) "
        f"{rates['decode_step_ms']:.2f} ms; launches: "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f"; peak {rates['peak_gb']:.2f} GiB")
    plan.check(tag, launches, ("flash", "decode", "decode_int8", "int8", "int8_prequant"))
    assert len(scored) == len(items) and res.tokens.shape == (len(items), 65)

    greedy = _omni_items(_omni_images(image_bytes), OMNI_GREEDY, per_image=False)
    prompts, feats, sst = gen._prepare(greedy)
    tokens, spans = _mcv_tokens(gen, len(prompts)), (feats, sst)
    path = _forced_logits(eng, prompts, None, None, tokens, ("auto", "auto"), spans)
    set_llm_config(model, kv_cache_dtype="fp")
    dense = _forced_logits(eng, prompts, None, None, tokens, ("dense", "dense"), spans)
    set_llm_config(model, kv_cache_dtype="int8")
    ok = bool(torch.isfinite(path).all() and torch.isfinite(dense).all())
    for text, a, b in (("prefill: the path (fresh-window #1) vs dense on a bf16 cache",
                        path[:1], dense[:1]),
                       (f"decode steps 1-{OMNI_FORCED}: the path (#5) vs dense on a bf16 cache",
                        path[1:], dense[1:])):
        rel, cos = _logit_gap(a, b)
        good = rel <= INT8_KV_REL_TOL and cos >= INT8_KV_COS_MIN
        ok = ok and good
        log(f"[{tag} vs plain] {text}: max|d| / max|ref| {rel:.4f} (tol {INT8_KV_REL_TOL}), "
            f"least row cosine {cos:.5f} (tol {INT8_KV_COS_MIN}) | {'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError("18b: the int8 path disagrees with the dense route")
    eager = _recorded_generate(eng, prompts, None, None, MCV_NEW, spans)
    return launches, rates, dict(forced=path, greedy=eager)


def phase_mcv_fused(gen: MiniCPMVGenerator, image_bytes: bytes, eager: dict) -> tuple:
    """18c: 18b's model with its projections fused, served through the
    fused engine (the LLM's weights stacked in place): a greedy generate
    with #16 once a decode step and no #4, #5 or #7 in the run; its first
    logits and its decode logits while the histories agree against 18b's
    eager int8-KV generate (phase 11's bounds), each row's first differing
    token logged; 4 forced steps: the fused prefill against 18b's, each
    step's #16 against its twin on the same cache (phase 12's checks) ->
    (launches, rates)."""
    tag = "18c minicpmv fused"
    fuse_llm_projections_(gen.model)
    fgen = MiniCPMVGenerator(gen.model, gen.tokenizer, checkpoint_name=gen.checkpoint_name,
                             fused_decode=True)
    greedy = _omni_items(_omni_images(image_bytes), OMNI_GREEDY, per_image=False)
    prompts, feats, sst = fgen._prepare(greedy)
    spans = (feats, sst)
    fgen.engine.generate(prompts[:1], span_features=feats[:1], span_starts=sst[:1],
                         max_new_tokens=2)  # warm-up
    spy, step = types.SimpleNamespace(steps=0), fgen.engine._step

    def counted(*a):
        spy.steps += 1
        return step(*a)

    fgen.engine._step = counted
    reset_counts()
    t0 = time.perf_counter()
    res = fgen.engine.generate(prompts, span_features=feats, span_starts=sst,
                               max_new_tokens=MCV_NEW)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_counts()
    fgen.engine._step = step
    rates = {"tok_s": _omni_rates(tag, len(prompts) * (spy.steps + 1), f"greedy generate of "
                                  f"{len(prompts)} rows, {spy.steps} steps: tokens", t1 - t0)}
    decode_free = ("decode", "decode_int8", "int8")
    ok = launches["fused"] == spy.steps > 0 and not any(launches[k] for k in decode_free) \
        and launches["int8_prequant"] > 0
    log(f"[{tag}] launches: " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f" | #16 {launches['fused']} = {spy.steps} decode steps, #4/#5/#7 "
        f"{sum(launches[k] for k in decode_free)} | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"18c: the fused path's launches: {launches}")

    # greedy tokens against 18b's eager int8-KV generate of the same prompts
    fres, frows, _ = _recorded_generate(fgen.engine, prompts, None, None, MCV_NEW, spans)
    eres, erows, _ = eager["greedy"]
    assert np.array_equal(fres.tokens, res.tokens)
    scale = max(erows[b][0].abs().max().item() for b in range(len(prompts)))
    first_rel, first_cos = _logit_gap(torch.stack([r[0] for r in frows]),
                                      torch.stack([r[0] for r in erows]))
    worst, cos, compared, mismatch, full = _agree(MCV_NEW, frows, fres, erows, eres)
    gaps = []
    for b, m in enumerate(mismatch):
        if m < MCV_NEW:
            top2 = erows[b][m].topk(2).values
            gaps.append(f"{b}@{m} {(top2[0] - top2[1]).item() / scale:.4f}")
    good = first_rel <= INT8_KV_REL_TOL and first_cos >= INT8_KV_COS_MIN and \
        worst <= INT8_KV_REL_TOL * scale and cos >= INT8_KV_COS_MIN
    log(f"[{tag} vs eager int8-KV] greedy generate of {len(prompts)} rows x {MCV_NEW}: first "
        f"logits max|d| / max|ref| {first_rel:.4f}, least row cosine {first_cos:.5f}; the "
        f"decode logits of the {compared} tokens whose history both share by at most "
        f"{worst / scale:.4f} of max|first logit|, least row cosine {cos:.5f} (tol "
        f"{INT8_KV_REL_TOL}, {INT8_KV_COS_MIN}); each row's first differing token {mismatch} "
        f"(of {MCV_NEW}), the eager top-2 gap there {gaps}; {full} of {len(prompts)} rows "
        f"equal in full | {'ok' if good else 'FAIL'}")
    tokens = _mcv_tokens(fgen, len(prompts))
    kern, twin, spread = _fused_forced(fgen.engine, prompts, None, None, tokens, spans)
    ok = good and all(bool(torch.isfinite(r).all()) for r in (kern, twin, spread))
    rel, cos = _logit_gap(spread[1:], twin[1:])
    log(f"[{tag} vs plain] the twin against itself with each step's x one ulp up: max|d| / "
        f"max|ref| {rel:.4f}, least row cosine {cos:.5f}")
    for text, a, b, rel_tol, cos_min in (
            ("prefill: the fused tower vs 18b's per-layer prefill", kern[:1],
             eager["forced"][:1], INT8_KV_REL_TOL, INT8_KV_COS_MIN),
            (f"decode steps 1-{OMNI_FORCED}: kernel #16 vs the twin on the same cache",
             kern[1:], twin[1:], FUSED_LOGIT_REL_TOL, FUSED_LOGIT_COS_MIN),
            (f"decode steps 1-{OMNI_FORCED}: the fused path vs 18b's eager int8-KV path",
             kern[1:], eager["forced"][1:], INT8_KV_REL_TOL, INT8_KV_COS_MIN)):
        rel, cos = _logit_gap(a, b)
        good = rel <= rel_tol and cos >= cos_min
        ok = ok and good
        log(f"[{tag} vs plain] {text}: max|d| / max|ref| {rel:.4f} (tol {rel_tol}), least row "
            f"cosine {cos:.5f} (tol {cos_min}) | {'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError("18c: the fused path disagrees with its plain routes")
    return launches, rates


def phase_mcv_int4(tok, image_bytes: bytes) -> tuple:
    """18d: the seed-0 model rebuilt, its LLM quantised to int4 on the card
    (group 128, the head and SigLIP bf16, an int8 cache): autocheck of
    18b's 8 items at batch 8 on the plain path, #11 against the plan ->
    (launches, rates)."""
    tag = "18d minicpmv int4"
    model = build_minicpmv(tok, tag)
    t0 = time.perf_counter()
    quantize_llm_int4(model, include_lm_head=False)
    set_llm_config(model, kv_cache_dtype="int8")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] the LLM quantised to int4 in place in {time.perf_counter() - t0:.1f} s: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    gen = MiniCPMVGenerator(model, tok, checkpoint_name="random-minicpm-llama3-v25")
    items = _omni_items(_mcv_bench_images(image_bytes), FACTS[:MCV_BENCH_B // 2])
    gen.autocheck(items[:1], batch_size=MCV_BENCH_B, shared_prefix=False)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with PathPlan(model.llm) as plan:
        reset_counts()
        t0 = time.perf_counter()
        scored = gen.autocheck(items, batch_size=MCV_BENCH_B, shared_prefix=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = read_counts()
    rates = {"facts_s": _omni_rates(tag, len(items), f"autocheck facts at batch {MCV_BENCH_B} "
                                    "(plain)", t1 - t0),
             "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[{tag}] launches: " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f"; peak {rates['peak_gb']:.2f} GiB")
    plan.check(tag, launches, ("flash", "int4", "int8", "int8_prequant"))
    assert len(scored) == len(items) and all(
        0.0 <= p <= 1.0 for r in scored for p in r["scores"].values())
    del gen, model
    return launches, rates


def phase_minicpmv(tok, image_bytes: bytes, smi: str) -> dict:
    """18: MiniCPM-Llama3-V 2.5's serving slice, a-e (above) -> the
    launches of its counted runs."""
    model = build_minicpmv(tok, "18 minicpmv")
    gen = MiniCPMVGenerator(model, tok, checkpoint_name="random-minicpm-llama3-v25")
    launches, bf16 = timed("18a minicpmv bf16", phase_mcv_bf16, gen, image_bytes)
    add_counts(launches, timed("18e minicpmv continuous", phase_mcv_continuous, gen,
                               image_bytes, smi))
    int8_launches, int8, eager = timed("18b minicpmv int8", phase_mcv_int8, gen, image_bytes)
    add_counts(launches, int8_launches)
    fused_launches, fused = timed("18c minicpmv fused", phase_mcv_fused, gen, image_bytes,
                                  eager)
    add_counts(launches, fused_launches)
    del gen, model, eager
    gc.collect()
    torch.cuda.empty_cache()
    int4_launches, int4 = timed("18d minicpmv int4", phase_mcv_int4, tok, image_bytes)
    add_counts(launches, int4_launches)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[18 minicpmv] {smi}: bf16 encode {bf16['encode_slice_ms']:.2f} ms a slice, "
        f"{bf16['encode_item_ms']:.2f} ms an item (a block at 8 slices {bf16['block_ms']:.3f} "
        f"ms, its attention {bf16['attn_ms']:.3f}), autocheck {bf16['facts_s']:.2f} facts/s "
        f"shared / {bf16['facts_plain_s']:.2f} plain, diverse_gen {bf16['diverse_tok_s']:.1f} "
        f"tok/s, chat {bf16['chat_tok_s']:.1f} tok/s, 3-beam {bf16['beam_tok_s']:.1f} tok/s, "
        f"peak {bf16['peak_gb']:.2f} GiB | int8 at the bench geometry: encode "
        f"{int8['encode_ms']:.2f} ms, prefill {int8['prefill_ms']:.2f} ms, autocheck "
        f"{int8['facts_s']:.2f} facts/s, decode step {int8['decode_step_ms']:.2f} ms, peak "
        f"{int8['peak_gb']:.2f} GiB | fused generate {fused['tok_s']:.1f} tok/s | int4 "
        f"autocheck {int4['facts_s']:.2f} facts/s, peak {int4['peak_gb']:.2f} GiB | launches "
        f"{launches}")
    return launches


# ---------------------------------------------------------------- 19


# 19a's fold gate: the seed-0 model in fp32, its first logits over 8
# prompts after the smoothing folds against its own before them, as a share
# of max|first logit|. The fold is exact in real arithmetic; on an H100 80GB
# HBM3 the fp32 model reads 1.84e-5 (the alpha search's folds at 0.25 in
# every layer). The bound sits ~50x above that reading and far below the
# percent-level move of a fold that is partly wrong.
FOLD_FP32_REL_TOL = 1e-3
LOOKUP_QUESTIONS = ["Describe the image in detail.", "What is in the image?",
                    "What colors do you see?", "Why did the car in the picture stop?"]
LOOKUP_NEW = 32
LOOKUP_TAIL = 4  # the prompt's last tokens, repeated after its continuation
LOOKUP_ALTER = 10  # every 10th token of the quoted continuation altered
LOOKUP_INT4_PROMPTS = 2
# 19b's token embeddings scaled by 2^16 (exact in bf16): the residual stream
# then follows the current token, so a random model's greedy text follows a
# quote of itself and lookup's drafts are accepted; unscaled, a random 7B's
# text neither repeats nor follows a quote (1.000 tokens a window on an H100
# 80GB HBM3, quoted or not)
LOOKUP_EMBED_GAIN = 2.0 ** 16
ANYRES_PINS = [[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]]
# examples/test.jpeg (640 x 420) picks 672 x 672: the base and a 2 x 2 grid,
# 576 base features + a 48 x 48 grid unpadded to 32 rows of 48 + a newline
ANYRES_T = 576 + 32 * 49
ANYRES_NEW = 64
D3_NEW = 64  # 19d's new tokens a prompt
D3_ANSWERS = ["A red car waits at a crossing while people walk past it.",
              "Two dogs sleep on a blue sofa next to a window.",
              "The kitchen has a white table and three wooden chairs.",
              "A man rides a bicycle down a wet street at night.",
              "Snow covers the roofs of the small houses by the lake.",
              "A child holds a yellow kite on a windy beach.",
              "The clock on the tower shows a quarter past nine.",
              "Green apples lie in a basket on the market stall."]


def _first_logits(eng: DecodeEngine, prompts, starts, images) -> torch.Tensor:
    """generate's first logits (max_new_tokens 1) on the card, fp32."""
    with torch.inference_mode():
        res = eng.generate(prompts, images=images, image_starts=starts, max_new_tokens=1)
    return torch.from_numpy(res.first_logits).float().cuda()


def _drift(x: torch.Tensor, ref: torch.Tensor) -> str:
    rel = ((x - ref).abs().max() / ref.abs().max()).item()
    top1 = (x.argmax(-1) == ref.argmax(-1)).float().mean().item()
    return f"max|d first logit| / max|ref| {rel:.4f}, top-1 agreement {top1:.3f}"


def _alpha_hist(log: dict) -> dict:
    """A smoothing log's chosen alphas counted by producer group."""
    hist = {}
    for rec in log.values():
        for key, (a, _) in rec.items():
            hist.setdefault(key, {}).setdefault(a, 0)
            hist[key][a] += 1
    return hist


@contextlib.contextmanager
def int4_rows():
    """Inside, the rows of every kernel #11 call, counted by row count."""
    rows, real = {}, i4._kernel_fwd

    def counted(xq, *a):
        rows[xq.shape[0]] = rows.get(xq.shape[0], 0) + 1
        return real(xq, *a)

    i4._kernel_fwd = counted
    try:
        yield rows
    finally:
        i4._kernel_fwd = real


def phase_smooth(gen: Llava15Generator, tok, image_bytes: bytes, smi: str) -> tuple:
    """19a: LLaVA-1.5-7B smoothed for int4 (models/quant_smooth.py, the
    --load-4bit chat's RLAIFV_INT4_SMOOTH=1 path): the fold gate on the
    seed-0 model in fp32 (calibrated on the chat's sentence, the alpha
    search run layer by layer on the card; its first logits against its own
    before the fold within FOLD_FP32_REL_TOL); the bf16 model rebuilt,
    smoothed and quantised to int4 in place; its prefill and 4
    forced steps on #11 against the same with every #11 product by its
    plain twin, bit for bit, #11 against the plan; the drift of plain and
    smoothed int4 against float over 8 prompts (logged) -> (launches, the
    smoothed int4 chat, readings)."""
    tag = "19a smooth"
    cfg = LlavaConfig.llava15_7b()
    n_layers = cfg.llm.num_layers
    prompts, starts, images = gen._prepare(_items(image_bytes, FACTS))
    ref = _first_logits(gen.engine, prompts, starts, images)
    calib = np.asarray(tok(CHAT_CALIBRATION_TEXT).input_ids, np.int64)[None]

    # the fold gate, in fp32 (the JAX package's smoothed float tree is
    # fp32): the seed-0 model in fp32, its first logits before and after
    # the fold in place (the alpha search)
    model = build_model(LlavaConfig.llava15_7b(dtype=torch.float32, param_dtype=torch.float32),
                        tag)
    eng = DecodeEngine(model, eos_id=tok.eos_token_id)
    ref32 = _first_logits(eng, prompts, starts, images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = collect_llm_act_stats(model, calib)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    smooth_llm_for_int4(model, stats)
    fold32 = _first_logits(eng, prompts, starts, images)
    scale32 = ref32.abs().max().item()
    d_fold = (fold32 - ref32).abs().max().item()
    del eng, model, stats
    gc.collect()
    torch.cuda.empty_cache()
    ok = d_fold <= FOLD_FP32_REL_TOL * scale32
    log(f"[{tag}] calibration on {calib.shape[1]} tokens {t_cal:.2f} s (fp32); the fold gate: "
        f"the smoothed fp32 model's first logits on {len(prompts)} prompts against its own "
        f"before the fold: max|d| {d_fold:.3e} = {d_fold / scale32:.2e} of max|first logit| "
        f"{scale32:.3f} (tol {FOLD_FP32_REL_TOL}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("19a: the smoothing folds changed the model")

    model = build_model(cfg, tag)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alphas = {}
    t0 = time.perf_counter()
    quantize_llm_int4_smooth(model, calib, log=alphas)
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    hist = _alpha_hist(alphas)
    log(f"[{tag}] calibrated, searched and quantised to int4 in place in {t_q:.2f} s, peak "
        f"{peak:.2f} GiB, {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated after; the "
        f"alphas chosen over {n_layers} layers by group: {hist} | {smi}")
    schat = RLAIFV7B.from_model(model, tok, max_new_tokens=LOOKUP_NEW)
    eng = schat.engine

    keep = printable_ids(tok)
    forced = torch.as_tensor(keep, device="cuda")[torch.randint(
        len(keep), (4, 4), generator=torch.Generator().manual_seed(19)).cuda()]
    torch.cuda.synchronize()
    with PathPlan(model.llm) as plan:
        reset_counts()
        kern = _forced_logits(eng, prompts[:4], starts[:4], images[:4], forced, ("auto", "auto"))
        torch.cuda.synchronize()
        launches = read_counts()
    with twin_products():
        twin = _forced_logits(eng, prompts[:4], starts[:4], images[:4], forced, ("auto", "auto"))
    equal = bool(torch.isfinite(kern).all()) and torch.equal(kern, twin)
    want_int4 = 7 * n_layers * (1 + forced.shape[1])
    log(f"[{tag}] the prefill and {forced.shape[1]} forced steps of 4 prompts on #11 against "
        f"the same with every #11 product by its plain twin (attention #1 / #4 on both): "
        f"{'bit-equal' if equal else 'NOT EQUAL'} (max|d| {(kern - twin).abs().max().item():.3e}); "
        f"#11 {launches['int4']} launches = 7 projections x {n_layers} layers x "
        f"{1 + forced.shape[1]} passes ({want_int4})")
    plan.check(tag, launches, ("flash", "decode", "int4"))
    if not equal or launches["int4"] != want_int4:
        raise AssertionError("19a: the smoothed int4 model's #11 route differs from its twin")

    smoothed = _first_logits(eng, prompts, starts, images)
    plain = build_model(cfg, tag)
    quantize_llm_int4(plain)
    plain_logits = _first_logits(DecodeEngine(plain, eos_id=tok.eos_token_id), prompts, starts,
                                 images)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] int4 against the float model over {len(prompts)} prompts (random weights carry "
        f"no outlier channels: logged, not gated): plain group int4 {_drift(plain_logits, ref)}; "
        f"smoothed {_drift(smoothed, ref)}")
    return launches, schat, dict(calib_s=t_cal, quant_s=t_q, peak_gb=peak, hist=hist)


@contextlib.contextmanager
def scaled_embeddings(llm):
    """Inside, the LM's token embeddings times LOOKUP_EMBED_GAIN; restored
    bit for bit after."""
    w = llm.model.tok_embed.weight
    keep = w.detach().clone()
    with torch.no_grad():
        w.mul_(LOOKUP_EMBED_GAIN)
    try:
        yield
    finally:
        with torch.no_grad():
            w.copy_(keep)


def _lookup_prompts(chat: "RLAIFV7B", image_bytes: bytes, n: int) -> tuple:
    """The chat's prompts of LOOKUP_QUESTIONS[:n], each followed by the
    model's own greedy continuation (generate, LOOKUP_NEW tokens, EOS
    dropped, every LOOKUP_ALTER-th token moved to the next id) and its last
    LOOKUP_TAIL tokens again: the prompt-lookup n-gram at the end of such a
    prompt finds the continuation, as in a prompt that quotes the
    answer-to-be, so windows accept drafts up to an altered token and
    reject it -> (prompts, image starts, images)."""
    eng = chat.engine
    image = chat.image_processor.resize_uint8(image_bytes)
    exs = [chat.prompt(q) for q in LOOKUP_QUESTIONS[:n]]
    prompts = [ex["input_ids"].tolist() for ex in exs]
    starts = [int(ex["image_start"]) for ex in exs]
    images = np.stack([image] * n)
    res = eng.generate(prompts, images=images, image_starts=starts, max_new_tokens=LOOKUP_NEW)
    vocab = chat.model.llm.cfg.vocab_size
    quotes = [[int(t) for t in res.tokens[b][:res.lengths[b]] if t != eng.eos_id]
              for b in range(n)]
    quotes = [[(t + 1) % vocab if i % LOOKUP_ALTER == LOOKUP_ALTER - 1 else t
               for i, t in enumerate(q)] for q in quotes]
    return [p + q + p[-LOOKUP_TAIL:] for p, q in zip(prompts, quotes)], starts, images


def _lookup_run(tag: str, chat: "RLAIFV7B", image_bytes: bytes, n: int, smi: str) -> dict:
    """Greedy lookup_generate of n prompts from _lookup_prompts on
    `chat`'s engine (each prompt alone, LOOKUP_NEW tokens) counted against
    the plan: #1 once a layer a prefill, no #4 in the window loop, #11 (an
    int4 model) on every projection, 9 rows a window; more than one token a
    window (drafts accepted); the tokens against one greedy generate of the
    same prompts under the tie rule; lookup's tok/s beside a one-prompt
    generate's -> launches."""
    eng, llm = chat.engine, chat.model.llm
    n_layers = llm.cfg.num_layers
    prompts, starts, images = _lookup_prompts(chat, image_bytes, n)
    lookup_generate(eng, prompts[0], images=images[:1], image_starts=starts[:1],
                    max_new_tokens=4)  # warm-up
    torch.cuda.synchronize()
    with PathPlan(llm) as plan, int4_rows() as rows:
        reset_counts()
        t0 = time.perf_counter()
        res = [lookup_generate(eng, p, images=images[b:b + 1], image_starts=starts[b:b + 1],
                               max_new_tokens=LOOKUP_NEW) for b, p in enumerate(prompts)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    n_tok, n_steps = sum(len(r.tokens) for r in res), sum(r.n_steps for r in res)
    quant = llm.cfg.quantize
    want_rows = {9: 7 * n_layers * n_steps} if quant else {}
    ok = (launches["flash"] == n_layers * len(prompts) and launches["decode"] == 0
          and {m: n for m, n in rows.items() if m == 9} == want_rows and n_tok > n_steps)
    log(f"[{tag}] {len(prompts)} prompts ({min(map(len, prompts))}-{max(map(len, prompts))} "
        f"tokens, each quoting its greedy continuation; embeddings x {LOOKUP_EMBED_GAIN:g}) x "
        f"{LOOKUP_NEW} new tokens: {n_tok} "
        f"tokens in {n_steps} windows = {n_tok / n_steps:.3f} a window (> 1: drafts accepted; "
        f"{[r.n_steps for r in res]}), {wall:.3f} s = {n_tok / wall:.1f} tok/s (prefill and "
        f"encode included); launches {', '.join(f'{k} {v}' for k, v in launches.items() if v)}; "
        f"#11 calls by rows {rows} (planned 9 rows: {want_rows.get(9, 0)} = 7 x {n_layers} x "
        f"windows); #4 in the window loop {launches['decode']} (planned 0) | "
        f"{'ok' if ok else 'FAIL'}")
    plan.check(tag, launches, ("flash", "decode", "int4"))
    if not ok:
        raise AssertionError(f"{tag}: lookup's launches off the plan, or no draft accepted")

    ref, gen_rows, _ = _recorded_generate(eng, prompts, starts, images, LOOKUP_NEW)
    scale = max(gen_rows[b][0].abs().max().item() for b in range(len(prompts)))
    first_diff, gaps, ok = [], [], True
    for b, r in enumerate(res):
        want = [int(t) for t in ref.tokens[b][:ref.lengths[b]]]
        m = next((i for i, (x, y) in enumerate(zip(r.tokens, want)) if x != y),
                 None if len(r.tokens) == len(want) else min(len(r.tokens), len(want)))
        first_diff.append(len(want) if m is None else m)
        if m is not None:
            top2 = gen_rows[b][m].topk(2).values
            gap = (top2[0] - top2[1]).item() / scale
            gaps.append(f"{b}@{m} {gap:.4f}")
            ok = ok and gap < CONT_TIE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = eng.generate(prompts[:1], images=images[:1], image_starts=starts[:1],
                       max_new_tokens=LOOKUP_NEW)
    torch.cuda.synchronize()
    gen_tok_s = int(one.lengths[0]) / (time.perf_counter() - t0)
    log(f"[{tag}] lookup tokens against generate greedy (the {len(prompts)} prompts batched; "
        f"the window's dense logits and #4's round differently): each row's first differing "
        f"token {first_diff} (of {LOOKUP_NEW}), generate's top-2 gap there as a share of "
        f"max|first logit| {scale:.3f}: {gaps} (tie bound {CONT_TIE}); generate of one prompt "
        f"({LOOKUP_NEW} tokens, prefill and encode included) {gen_tok_s:.1f} tok/s against "
        f"lookup's {n_tok / wall:.1f} | {smi} | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: lookup differs from greedy generate beyond a near-tie")
    return launches


def phase_lookup(gen: Llava15Generator, schat: "RLAIFV7B", tok, image_bytes: bytes,
                 smi: str) -> dict:
    """19b: --lookup-decode on the bf16 model (phase 4's, 4 prompts) and on
    19a's smoothed int4 model (LOOKUP_INT4_PROMPTS prompts), each with its
    embeddings scaled (scaled_embeddings), then the --load-4bit
    --lookup-decode chat's answer once, unscaled -> launches."""
    with scaled_embeddings(gen.model.llm):
        launches = _lookup_run("19b lookup bf16", RLAIFV7B.from_model(
            gen.model, tok, max_new_tokens=LOOKUP_NEW, lookup_decode=True), image_bytes,
            len(LOOKUP_QUESTIONS), smi)
    chat4 = RLAIFV7B.from_model(schat.model, tok, max_new_tokens=16, lookup_decode=True)
    with scaled_embeddings(schat.model.llm):
        add_counts(launches, _lookup_run("19b lookup int4 smoothed", chat4, image_bytes,
                                         LOOKUP_INT4_PROMPTS, smi))
    answer = chat4.chat({"image": image_bytes, "question": LOOKUP_QUESTIONS[3]})
    assert isinstance(answer, str)
    log(f"[19b lookup] the --load-4bit --lookup-decode chat answered {len(answer)} characters")
    return launches


def phase_anyres(gen: Llava15Generator, tok, image_bytes: bytes, smi: str) -> dict:
    """19c: a LLaVA-1.6-vicuna-7b geometry (phase 4's modules and weights
    under an anyres configuration, a seeded image_newline): the device merge
    of examples/test.jpeg's views against the numpy merge bit for bit, the
    encode's and the 3-beam prefill's ms, then the 3-beam chat of 64 new
    tokens counted against the plan (#1 32 a prefill, #4 32 a beam step)
    -> launches."""
    tag = "19c anyres"
    base = gen.model
    cfg = dataclasses.replace(base.cfg, image_aspect_ratio="anyres",
                              image_grid_pinpoints=ANYRES_PINS,
                              mm_patch_merge_type="spatial_unpad")
    model = LlavaForCausalLM(cfg, device="meta")
    model.vision_tower, model.mm_projector, model.llm = (base.vision_tower, base.mm_projector,
                                                         base.llm)
    model.eval()
    D, n_layers = cfg.llm.hidden_size, cfg.llm.num_layers
    newline = (torch.randn(D, generator=torch.Generator(device="cuda").manual_seed(19),
                           device="cuda") / math.sqrt(D)).to(torch.bfloat16)
    chat = RLAIFV7B.from_model(model, tok, max_new_tokens=ANYRES_NEW, image_newline=newline)
    views, grid, size = process_anyres_image_full(image_bytes, chat.image_processor, ANYRES_PINS)
    with torch.inference_mode():
        feats = model.encode_images(torch.from_numpy(views).cuda())
    merged = merge_anyres_device(feats, grid, original_size=size, image_newline=newline)
    want = merge_anyres_features(feats.float().cpu().numpy(), grid, original_size=size,
                                 image_newline=newline.float().cpu().numpy())
    equal = np.array_equal(merged.float().cpu().numpy(), want)
    T = merged.shape[0]
    log(f"[{tag}] examples/test.jpeg {size[0]} x {size[1]}: {len(views)} views, grid {grid}, "
        f"T {T} merged features (planned {ANYRES_T}); the device merge against the numpy merge: "
        f"{'bit-equal' if equal else 'NOT EQUAL'}")
    if not equal or T != ANYRES_T:
        raise AssertionError("19c: the anyres merge")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    span = encode_anyres(model, chat.image_processor, cfg, image_bytes, image_newline=newline)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    ex = chat.prompt(LOOKUP_QUESTIONS[0], T)
    t0 = time.perf_counter()
    chat.engine.generate_beam([ex["input_ids"].tolist()], span_features=span[None, None],
                              span_starts=[[int(ex["image_start"])]], num_beams=3,
                              max_new_tokens=1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    with BeamMeter() as meter:
        reset_counts()
        t0 = time.perf_counter()
        answer = chat.chat({"image": image_bytes, "question": LOOKUP_QUESTIONS[0]})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = meter.model_steps
    ok = (isinstance(answer, str) and launches["flash"] == n_layers
          and launches["decode"] == n_layers * steps and steps >= 1)
    log(f"[{tag}] the 3-beam chat, {len(ex['input_ids'])}-token prompt, {ANYRES_NEW} new tokens: "
        f"encode {encode_ms:.1f} ms ({len(views)} views and the merge), the 3-beam prefill "
        f"{prefill_ms:.1f} ms, the chat {wall:.3f} s = {(steps + 1) / wall:.1f} tok/s of the best "
        f"beam ({3 * (steps + 1) / wall:.1f} beam tok/s; encode and prefill included), {steps} "
        f"beam steps; launches flash {launches['flash']} (planned {n_layers}), #4 "
        f"{launches['decode']} (planned {n_layers} x {steps}); peak {peak:.2f} GiB | {smi} | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("19c: the anyres chat's launches off the plan")
    return launches


def phase_smooth_backend(tok, smi: str) -> dict:
    """19d: Llama3-8B at full width and depth through the divide-and-conquer
    backend with int4_smooth and fused decode (llama3_backend: smoothing at
    alpha 0.5, int4, fused projections, an int8 cache, kernel #16), 8
    divide prompts of D3_NEW tokens: #11 on the prefill's projections, #16
    once a step; its prefill and OMNI_FORCED forced steps (#16) against the
    unfused smoothed int4 engine's (#11 and #5 a layer) on a first build
    (phase 11's bound and cosine) -> launches."""
    tag = "19d llama3 int4 smoothed"
    msgs = [dcq.divide_messages({"question": q, "answer": a})
            for q, a in zip(PIPE_QUESTIONS * 2, D3_ANSWERS)]
    model = build_llama3(tok, tag)
    ref_fn, tmpl = dcq.llama3_backend(model, tok, int4=True, int4_smooth=True,
                                      max_new_tokens=D3_NEW)
    prompts = [tmpl(m) for m in msgs]
    ids = [tok(p).input_ids for p in prompts]
    keep = printable_ids(tok)
    forced = torch.as_tensor(keep, device="cuda")[torch.randint(
        len(keep), (len(ids), OMNI_FORCED), generator=torch.Generator().manual_seed(19)).cuda()]
    ref = _forced_logits(ref_fn.engine, ids, None, None, forced, ("auto", "auto"))
    del ref_fn, model
    gc.collect()
    torch.cuda.empty_cache()

    model = build_llama3(tok, tag)
    t0 = time.perf_counter()
    fn, _ = dcq.llama3_backend(model, tok, int4=True, int4_smooth=True, fused_decode=True,
                               max_new_tokens=D3_NEW)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    n_layers = model.cfg.num_layers
    meter = BackendMeter(fn.engine)
    reset_counts()
    out = fn(prompts)
    launches = read_counts()
    rates = meter.rates()
    ok = (len(out) == len(prompts) and launches["fused"] == meter.steps >= 1
          and launches["int4"] == 4 * n_layers
          and not any(launches[k] for k in ("decode", "decode_int8", "int8", "int8_prequant")))
    log(f"[{tag}] smoothed (alpha 0.5), int4, fused and stacked in {t_build:.1f} s; "
        f"{len(prompts)} divide prompts: {rates}; #16 {launches['fused']} = {meter.steps} decode "
        f"steps; #11 {launches['int4']} (planned 4 products x {n_layers} layers x 1 prefill); "
        f"#1 {launches['flash']}; #4 {launches['decode']}, #5 {launches['decode_int8']} | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"19d: the smoothed int4 fused backend's kernels: {launches}")
    reset_counts()
    kern, twin, spread = _fused_forced(fn.engine, ids, None, None, forced)
    n_fused = read_counts()["fused"]
    w_rel, w_cos = _logit_gap(spread[1:], twin[1:])
    good = n_fused == forced.shape[1]
    lines = []
    for what, a, b in (("the stacked prefill", kern[:1], ref[:1]),
                       (f"decode steps 1-{forced.shape[1]} (#16 against #11 and #5 a layer)",
                        kern[1:], ref[1:])):
        rel, cos = _logit_gap(a, b)
        good = good and rel <= INT8_KV_REL_TOL and cos >= INT8_KV_COS_MIN
        lines.append(f"{what}: max|d| / max|ref| {rel:.4f}, least row cosine {cos:.5f}")
    log(f"[{tag}] the fused engine against the unfused smoothed int4 engine (int8 cache) on "
        f"{len(ids)} prompts and {forced.shape[1]} forced tokens: {'; '.join(lines)} (tol "
        f"{INT8_KV_REL_TOL}, cosine {INT8_KV_COS_MIN}); the model's own spread: #16's twin with "
        f"x one ulp up against the twin {w_rel:.4f}, cosine {w_cos:.5f}; #16 {n_fused} launches "
        f"(planned {forced.shape[1]}) | {smi} | {'ok' if good else 'FAIL'}")
    if not good:
        raise AssertionError("19d: the fused smoothed int4 engine disagrees with the unfused one")
    del fn, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_options(gen: Llava15Generator, tok, image_bytes: bytes, smi: str) -> dict:
    """19: the serving options of the root chat.py and the serving loaders
    ported last (a-d above) -> the launches of their counted runs."""
    launches, schat, _ = timed("19a smooth", phase_smooth, gen, tok, image_bytes, smi)
    add_counts(launches, timed("19b lookup", phase_lookup, gen, schat, tok, image_bytes, smi))
    del schat
    gc.collect()
    torch.cuda.empty_cache()
    add_counts(launches, timed("19c anyres", phase_anyres, gen, tok, image_bytes, smi))
    add_counts(launches, timed("19d llama3 int4 smoothed", phase_smooth_backend, tok, smi))
    log(f"[19 options] launches {launches}")
    return launches


def eva_quant_dense(tag: str, g, bits: int) -> dict:
    """3d / 3e at the EVA02 tower's projections: QuantDense with its bias,
    the whole call (row pass, product, bias) at M = 1025 (one 448 px
    image) and 8200 (a batch of 8), against the plain twin plus the bias
    bit for bit, one kernel launch counted a call, its time beside the
    product alone -> {(M, K, N): ms}."""
    out = {}
    for K, N in EVA_WIDTHS:
        w = 0.02 * torch.randn(K, N, generator=g, device="cuda")
        layer = QuantDense(K, N, dtype=torch.bfloat16, bits=bits, bias=True,
                           param_dtype=torch.bfloat16, device="cuda")
        layer.q, layer.scale = (quantize_int4_torch(w) if bits == 4
                                else quantize_kernel_int8_torch(w))
        layer.bias.copy_(torch.randn(N, generator=g, device="cuda"))
        for M in EVA_MS:
            x = _randn(g, M // 1025, 1025, K)
            counter = (i4.int4_matmul, "launches") if bits == 4 else \
                (qm.int8_matmul_prequant, "launches")
            n0 = getattr(*counter)
            with torch.inference_mode():
                got = layer(x)
                torch.cuda.synchronize()
                n1 = getattr(*counter)
                x2 = x.reshape(M, K)
                twin = (i4.int4_matmul_plain(x2, layer.q, layer.scale) if bits == 4
                        else qm.int8_matmul_plain(x2, layer.q, layer.scale))
                want = (twin + layer.bias.to(torch.bfloat16)).reshape(got.shape)
                t_call = time_ms(lambda: layer(x))
                t_prod = time_ms(lambda: (i4.int4_matmul if bits == 4
                                          else qm.int8_matmul_prequant)(x, layer.q, layer.scale))
            ok = torch.equal(got, want) and n1 - n0 == 1
            out[(M, K, N)] = t_call
            log(f"{tag} QuantDense(bits={bits}, bias) M={M} K={K} N={N}: the whole call (row "
                f"pass, product, bias) {t_call:.4f} ms, the wrapper's product call alone "
                f"{t_prod:.4f} ms; equal to the twin + bias {torch.equal(got, want)}, "
                f"{n1 - n0} launch | {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag}: QuantDense with a bias disagrees with its twin "
                                     f"at M={M} K={K} N={N}")
        del w, layer
    torch.cuda.empty_cache()
    return out


# 20: the modules ported last (registry, TSV sources and profiling have no
# device path; the rest run here)
LOADER_BATCH = 64
PRE_B, PRE_S = 64, 640  # bench.py:448's preprocess geometry (to 336)
PIXEL_STEPS = 2.0  # tests/test_image_kernels.py:30: PIL's int16 taps, 2 uint8 LSBs
PEAK_FP32_TFLOPS = 67.0  # H100 SXM data sheet, float32 outside the tensor cores
EXPORT_QUESTIONS = ["What is in the image?", "Describe the scene.",
                    "What colors do you see?", "Is it daytime?"]
EXPORT_NEW = 16
FP16_MIN_NORMAL = 2.0 ** -14
PEFT_R, PEFT_ALPHA = 64, 16.0
EXPORT_LAYERS = 4  # 20c's LLM depth (full width; tools/export_roundtrip.py: all 32)
PEFT_PROJ = ("q_proj", "v_proj")  # peft's default LoRA targets for Llama
PEFT_TARGET = rf"llm/.*({'|'.join(PEFT_PROJ)})/kernel$"
PEFT_B_STD = 0.1  # merged delta ~0.2 of a weight's std: visible, not dominant
PEFT_SEED = 20
REF2_WORLD = 2
REF2_TIMEOUT = 600  # the workers' wall limit (start, build, score)


def _loader_blobs(image_bytes: bytes) -> tuple:
    """20a's batch: examples/test.jpeg, a copy resized to 3/4 and a mirrored
    copy (both re-encoded as JPEG, quality 90), cycled to LOADER_BATCH."""
    from PIL import Image, ImageOps

    img = Image.open(io.BytesIO(image_bytes)).convert("RGB")

    def jpeg(im) -> bytes:
        buf = io.BytesIO()
        im.save(buf, format="JPEG", quality=90)
        return buf.getvalue()

    w, h = img.size
    three = [image_bytes, jpeg(img.resize((w * 3 // 4, h * 3 // 4), Image.Resampling.BICUBIC)),
             jpeg(ImageOps.mirror(img))]
    sizes = [Image.open(io.BytesIO(b)).size for b in three]
    return [three[i % 3] for i in range(LOADER_BATCH)], sizes


def phase_loader(image_bytes: bytes, smi: str) -> list:
    """20a: the native JPEG loader on a batch of 64 -> the decoded, padded
    images. Where it builds: byte-equal to the PIL path, no JPEG falling
    back to PIL, and timed. Where it does not, every image takes the PIL
    path: the phase says so, decodes the batch for 20b and times nothing."""
    blobs, sizes = _loader_blobs(image_bytes)
    loader = native_loader.NativeImageLoader()
    t0 = time.perf_counter()
    native = native_loader.native_available()
    build_s = time.perf_counter() - t0
    if not native:
        log("[20a native loader] NOT AVAILABLE on this machine: the C++ loader did not build "
            f"(libjpeg's header /usr/include/jpeglib.h "
            f"{'present' if os.path.exists('/usr/include/jpeglib.h') else 'absent'}); "
            f"{len(blobs)} images decoded on the PIL path for 20b, nothing timed")
        return loader(blobs)
    so = native_loader.library_path()
    pkg_files = sorted(os.listdir(ROOT / "rlaifv_tpu_torch" / "native"))
    log(f"[20a native loader] g++ built {so.relative_to(ROOT)} from the repo's copy "
        f"in {build_s:.1f} s; rlaifv_tpu_torch/native holds {pkg_files}")
    if so.parent != ROOT / "build" / "rlaifv_tpu_torch" or pkg_files != ["image_loader.cpp"]:
        raise AssertionError("20a: the loader's library is not under build/ alone")
    fell_back = []
    orig = native_loader.NativeImageLoader._fallback

    def spy(self, batch):
        fell_back.append(len(batch))
        return orig(self, batch)

    native_loader.NativeImageLoader._fallback = spy
    try:
        loader(blobs[:4])  # warm-up
        fell_back.clear()
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = loader(blobs)
            runs.append(time.perf_counter() - t0)
    finally:
        native_loader.NativeImageLoader._fallback = orig
    n_fallback = sum(fell_back) // len(runs)
    t0 = time.perf_counter()
    pil = loader._fallback(blobs)
    pil_ms = (time.perf_counter() - t0) / len(blobs) * 1e3
    equal = all(a.shape == b.shape and np.array_equal(a, b) for a, b in zip(out, pil))
    ms = min(runs) / len(blobs) * 1e3
    log(f"[20a native loader] {len(blobs)} JPEGs ({' / '.join(f'{w}x{h}' for w, h in sizes)}, "
        f"cycled) decoded and padded to squares: {ms:.4f} ms/image (native, "
        f"{loader.num_threads} threads, best of 3 batches) | the PIL path alone "
        f"{pil_ms:.4f} ms/image | PIL fallbacks {n_fallback} of {len(blobs)} images | "
        f"byte-equal to the PIL path: {equal} | {smi}")
    if not equal:
        raise AssertionError("20a: the loader's images differ from the PIL path's")
    if n_fallback:
        raise AssertionError(f"20a: {n_fallback} JPEGs fell back to PIL")
    return out


def _pixel_steps(got: torch.Tensor, want: np.ndarray, std: np.ndarray) -> float:
    """max |device - host| in whole uint8 steps: |d| x std x 255 after the
    normalisation, rounded to the nearest step (the fp32 normalisation
    leaves ~1e-5 of a step on it)."""
    return float(np.rint(np.abs(got.cpu().numpy() - want) * std * 255.0).max())


def phase_preprocess(model: LlavaForCausalLM, decoded: list, smi: str) -> dict:
    """20b: DeviceImagePipeline on the card at bench.py's geometry and on
    20a's images, within PIXEL_STEPS of the host processor; the device
    program's ms/image (bench.py's metric: the fused resize + normalise on
    device-resident pixels) and the whole call's (host pad and upload
    included); then the CLIP tower and projector on device and on host
    pixels of 20a's images."""
    D = model.cfg.vision.image_size
    pipe = DeviceImagePipeline(image_size=D, device=model.device)
    host = ClipImageProcessor(image_size=D)
    std = np.asarray(host.std, np.float32)
    rng = np.random.default_rng(0)
    bench = list(rng.integers(0, 255, size=(PRE_B, PRE_S, PRE_S, 3), dtype=np.uint8))
    dev_u8 = torch.from_numpy(np.stack(bench)).to(model.device)
    Wr = pipe.resize_weights(PRE_S)
    dev_ms = time_ms(lambda: _resize_normalize(dev_u8, Wr, Wr, pipe.mean, pipe.std),
                     runs=10) / PRE_B
    flop = 2 * 3 * PRE_B * (PRE_S * PRE_S * D + PRE_S * D * D)  # the two dense products
    nbytes = PRE_B * PRE_S * PRE_S * 3 + PRE_B * D * D * 3 * 4
    b = bound(flop, nbytes, PEAK_FP32_TFLOPS)
    pipe(bench[:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe(bench)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) / PRE_B * 1e3
    del dev_u8
    dev_pix = pipe(decoded)
    steps = {}
    for name, imgs, got in (("bench", bench, out), ("20a", decoded, dev_pix)):
        if got.device != model.device or got.dtype != torch.float32 or \
                tuple(got.shape) != (len(imgs), D, D, 3):
            raise AssertionError(f"20b: {name}: {got.device} {got.dtype} {tuple(got.shape)}")
        steps[name] = _pixel_steps(got, np.stack([host(im) for im in imgs]), std)
    log(f"[20b preprocess] DeviceImagePipeline {PRE_B} x {PRE_S}^2 -> {D}: device program "
        f"{dev_ms:.5f} ms/image (the BASELINE preprocess metric; bound "
        f"{b['bound_ms'] / PRE_B:.5f} ms/image by {b['bound_by']} at {PEAK_FP32_TFLOPS} fp32 "
        f"TFLOP/s: dense products, TF32 off) | the whole call with host pad and upload "
        f"{call_ms:.4f} ms/image | max |device - host ClipImageProcessor| "
        f"{steps['bench']:.3f} uint8 steps (bench), {steps['20a']:.3f} (20a's "
        f"{len(decoded)} images) (tol {PIXEL_STEPS}) | {smi}")
    if max(steps.values()) > PIXEL_STEPS:
        raise AssertionError(f"20b: device pixels off the host processor's: {steps}")
    host_pix = torch.from_numpy(np.stack([host(im) for im in decoded])).to(model.device)
    rel = 0.0
    with torch.inference_mode():
        for i in range(0, len(decoded), 16):
            f_dev = model.encode_images(dev_pix[i:i + 16]).float()
            f_host = model.encode_images(host_pix[i:i + 16]).float()
            rel = max(rel, ((f_dev - f_host).abs().max() / f_host.abs().max()).item())
            if not (torch.isfinite(f_dev).all() and torch.isfinite(f_host).all()):
                raise AssertionError("20b: non-finite image features")
    log(f"[20b preprocess] CLIP tower + projector (bf16) on 20a's {len(decoded)} images: "
        f"device pixels against host pixels, max |d feature| / max |feature| {rel:.4f}")
    return dict(device_ms=dev_ms, call_ms=call_ms, steps=steps, feature_rel=rel)


def _host_gib() -> float:
    """This process's peak resident host memory, GiB (ru_maxrss: KiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _dir_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e9


def _round_fp16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float16).to(t.dtype) if t.is_floating_point() else t


def _greedy(gen: Llava15Generator, prompts, starts, images) -> np.ndarray:
    with torch.inference_mode():
        return gen.engine.generate(prompts, images=images, image_starts=starts,
                                   max_new_tokens=EXPORT_NEW).tokens


def _empty_llava(cfg: LlavaConfig, device) -> LlavaForCausalLM:
    return LlavaForCausalLM(cfg, device="meta").to_empty(device=device).eval()


def _reload(path: str, device, **kw) -> LlavaForCausalLM:
    """load_pretrained_llava(path, **kw) into a fresh bf16 model on `device`,
    its config from path's config.json."""
    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    cfg = llava_config_from_hf(kw.get("model_base") or path, llm=bf16, vision=bf16)
    tree = load_pretrained_llava(path, **kw)
    model = load_jax_params(_empty_llava(cfg, device), tree)
    del tree
    gc.collect()
    torch.cuda.synchronize()
    return model


def _ulps(x: torch.Tensor, ref: torch.Tensor) -> int:
    """max distance in bf16 ulps between two bf16 tensors: their bit
    patterns mapped onto one integer line (negative values mirrored, so
    +0 and -0 meet and a step across zero counts one)."""
    def line(t: torch.Tensor) -> torch.Tensor:
        bits = t.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return int((line(x) - line(ref)).abs().max())


def _cut_llava(model: LlavaForCausalLM, n_layers: int) -> LlavaForCausalLM:
    """`model` with its LLM cut to the first n_layers layers (full width),
    its tensors shared with `model`, not copied."""
    cfg = dataclasses.replace(model.cfg, llm=dataclasses.replace(model.cfg.llm,
                                                                 num_layers=n_layers))
    keep = {k: v for k, v in model.state_dict().items()
            if not (k.startswith("llm.model.layers.") and int(k.split(".")[3]) >= n_layers)}
    cut = LlavaForCausalLM(cfg, device="meta")
    cut.load_state_dict(keep, assign=True)
    return cut.eval()


@contextlib.contextmanager
def _restored(model: torch.nn.Module):
    """Run the block with `model`'s parameters changed in place, then put
    them back bit for bit (their device copies kept meanwhile)."""
    params = list(model.parameters())
    saved = [p.detach().clone() for p in params]
    try:
        yield
    finally:
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
        if not all(torch.equal(p, s) for p, s in zip(params, saved)):
            raise AssertionError("20c: a model was not restored")


def _round_model_(model: torch.nn.Module) -> None:
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(_round_fp16(p))


def _export(model: LlavaForCausalLM, out: str) -> tuple:
    """params_from_model + export_llava_hf (fp16, no base_dir: the dead
    final ViT block stays out) -> (seconds, the bridge's seconds)."""
    t0 = time.perf_counter()
    with torch.no_grad():
        tree = export_mod.params_from_model(model)
    t_bridge = time.perf_counter() - t0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        export_mod.export_llava_hf(tree, out, cfg=model.cfg)
    del tree
    gc.collect()
    return time.perf_counter() - t0, t_bridge


def export_roundtrip(gen: Llava15Generator, tok, image_bytes: bytes, smi: str, out: str,
                     tag: str = "20c export") -> dict:
    """gen's model exported as an HF checkpoint (fp16) into `out` and
    reloaded through load_pretrained_llava into a fresh model (its generate
    runs with the launch counters reset just before and read just after).
    Gates: every reloaded tensor bit-equal to the original rounded as the
    export rounds (bf16 -> fp16 -> bf16), and EXPORT_QUESTIONS x EXPORT_NEW
    greedy tokens equal to those of the rounded original (restored bit for
    bit after)."""
    model = gen.model
    items = _items(image_bytes, EXPORT_QUESTIONS)
    prompts, starts, images = gen._prepare(items)
    need = sum(p.numel() for p in model.parameters()) * 2  # fp16
    free = shutil.disk_usage(os.path.dirname(out)).free
    log(f"[{tag}] {out}: {free / 1e9:.1f} GB free, the export needs ~{need / 1e9:.1f} GB")
    if free < 2 * need:
        raise AssertionError(f"{tag}: {free / 1e9:.1f} GB free under {out}, "
                             f"{2 * need / 1e9:.1f} GB wanted")
    t_export, t_bridge = _export(model, out)
    gb = _dir_gb(out)
    t0 = time.perf_counter()
    model2 = _reload(out, model.device, dtype=np.float16)
    t_reload = time.perf_counter() - t0
    n_layers = model.cfg.llm.num_layers
    log(f"[{tag}] LLaVA-1.5-7B at full width, {n_layers} LLM layers: params_from_model + "
        f"export_llava_hf (fp16): {gb:.2f} GB written in {t_export:.1f} s "
        f"({gb / t_export:.2f} GB/s; the bridge {t_bridge:.1f} s) | load_pretrained_llava + "
        f"load_jax_params into a fresh model: {t_reload:.1f} s | host peak "
        f"{_host_gib():.1f} GiB | {smi}")
    # every tensor: the original rounded bf16 -> fp16 -> bf16, bit for bit
    own, got = model.state_dict(), model2.state_dict()
    if set(own) != set(got):
        raise AssertionError(f"{tag}: the reloaded state's names differ: {set(own) ^ set(got)}")
    n, n_moved, n_sub, bad = 0, 0, 0, []
    for name, t in own.items():
        r = _round_fp16(t)
        n += t.numel()
        n_moved += int((r != t).sum())
        n_sub += int(((t.abs() < FP16_MIN_NORMAL) & (t != 0)).sum())
        if not torch.equal(got[name], r):
            bad.append(name)
    n_tensors = len(own)
    del own, got
    log(f"[{tag}] reloaded state vs the original rounded bf16 -> fp16 -> bf16: "
        f"{n_tensors - len(bad)} of {n_tensors} tensors bit-equal ({n / 1e9:.3f} B "
        f"values; exact in fp16's normal range: {n_sub} nonzero values below 2^-14 "
        f"({n_sub / n:.2e}), {n_moved} values moved by the rounding)")
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} reloaded tensors differ, e.g. {bad[:3]}")
    gen2 = Llava15Generator(model2, tok, model2.cfg.num_image_tokens,
                            image_size=model2.cfg.vision.image_size)
    _greedy(gen2, prompts[:1], starts[:1], images[:1])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    got_tok = _greedy(gen2, prompts, starts, images)
    torch.cuda.synchronize()
    launches = read_counts()
    del gen2, model2
    gc.collect()
    torch.cuda.empty_cache()
    with _restored(model):
        _round_model_(model)
        want_tok = _greedy(gen, prompts, starts, images)
    torch.cuda.empty_cache()
    same = bool(np.array_equal(got_tok, want_tok))
    log(f"[{tag}] {len(prompts)} prompts x {EXPORT_NEW} greedy tokens through "
        f"Llava15Generator on the reloaded model: equal to the rounded original's: {same} "
        f"| launches: flash {launches['flash']}, decode {launches['decode']}")
    if not same:
        raise AssertionError(f"{tag}: the reloaded model's greedy tokens differ")
    if launches["flash"] < n_layers or launches["decode"] < n_layers:
        raise AssertionError(f"{tag}: a kernel of the reloaded model's path did not run: "
                             f"{launches}")
    return dict(launches=launches, gb=gb, export_s=t_export, reload_s=t_reload,
                inputs=(prompts, starts, images))


def phase_export(gen: Llava15Generator, tok, image_bytes: bytes, smi: str) -> dict:
    """20c: phase 4's model cut to EXPORT_LAYERS LLM layers (full width, its
    tensors shared) through `export_roundtrip`, then `phase_export_peft`
    over that export as the base; phase 4's model is left unchanged.
    tools/export_roundtrip.py runs the same round trip at full depth."""
    cut = _cut_llava(gen.model, EXPORT_LAYERS)
    gen_cut = Llava15Generator(cut, tok, cut.cfg.num_image_tokens,
                               image_size=cut.cfg.vision.image_size)
    work = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        base = os.path.join(work, "base")
        res = export_roundtrip(gen_cut, tok, image_bytes, smi, base)
        res["peft"] = phase_export_peft(cut, base, tok, *res.pop("inputs"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del gen_cut, cut
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_export_peft(cut: LlavaForCausalLM, base: str, tok, prompts, starts,
                      images) -> dict:
    """20c, LoRA: adapters on the cut model through export_peft_lora and
    load_pretrained_llava(adapter, base) over its export `base`. The
    reference is the cut model rounded as exported, with the adapters' fp16
    values merged in fp32 as the loader merges them, restored after; the
    drift against the adapters attached is logged."""
    device = cut.device
    work = tempfile.mkdtemp(prefix="chip_smoke_peft_")
    try:
        peft = os.path.join(work, "peft")
        g = torch.Generator(device=device).manual_seed(PEFT_SEED)
        lora = lora_init(g, cut, r=PEFT_R, target=PEFT_TARGET)
        for _, node in adapter_pairs(lora):
            node["b"] = torch.randn(node["b"].shape, generator=g, device=device) * PEFT_B_STD
        t0 = time.perf_counter()
        export_mod.export_peft_lora(export_mod.lora_params(lora), peft, alpha=PEFT_ALPHA,
                                    r=PEFT_R, base_model_name=base)
        t_peft = time.perf_counter() - t0
        t0 = time.perf_counter()
        model3 = _reload(peft, device, model_base=base, dtype=np.float32,
                         lora_alpha=PEFT_ALPHA)
        t_merge = time.perf_counter() - t0
        eng = dict(eos_id=tok.eos_token_id, pad_id=tok.pad_token_id or 0)
        got_l = _first_logits(DecodeEngine(model3, **eng), prompts, starts, images)
        scale = PEFT_ALPHA / PEFT_R
        n_w, n_diff, ulps = 0, 0, 0
        with _restored(cut), torch.no_grad():
            _round_model_(cut)
            for path, node in adapter_pairs(lora):
                name = torch_module_name(path)
                w = cut.get_submodule(name).weight
                a, b = (node[k].half().float() for k in ("a", "b"))
                w.copy_((w.float() + (a @ b).T * scale).to(w.dtype))
                w3 = model3.get_submodule(name).weight
                n_w += w.numel()
                n_diff += int((w3 != w).sum())
                ulps = max(ulps, _ulps(w3, w))
            want_l = _first_logits(DecodeEngine(cut, **eng), prompts, starts, images)
        del model3
        attach_lora(cut, lora_scaled(lora, PEFT_ALPHA))
        try:
            attached_l = _first_logits(DecodeEngine(cut, **eng), prompts, starts, images)
        finally:
            attach_lora(cut, None)
        gb = _dir_gb(peft)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del lora
    gc.collect()
    torch.cuda.empty_cache()
    d = (got_l - want_l).abs().max().item()
    scale_l = want_l.abs().max().item()
    ok = d <= SLICE_REL_TOL * scale_l and bool(torch.isfinite(got_l).all())
    log(f"[20c export] LoRA r {PEFT_R} on {'/'.join(PEFT_PROJ)} (b ~ N(0, {PEFT_B_STD}), seed "
        f"{PEFT_SEED}) over the same {cut.cfg.llm.num_layers}-layer model, its export above as "
        f"the base: export_peft_lora {gb:.3f} GB in {t_peft:.1f} s; "
        f"load_pretrained_llava(adapter, base) merged + loaded in {t_merge:.1f} s | merged "
        f"weights against the in-memory merge: {n_diff} of {n_w} differ, at most {ulps} bf16 "
        f"ulp | first logits: max|d| {d:.4f} vs max|logit| {scale_l:.3f} (tol {SLICE_REL_TOL} "
        f"x max) | {'ok' if ok else 'FAIL'} | with the adapters attached instead (bf16 side "
        f"term, no rounding) max|d| {(got_l - attached_l).abs().max().item():.4f} | host peak "
        f"{_host_gib():.1f} GiB")
    if not ok or ulps > 1:  # fp32 sums in another order may flip a bf16 rounding
        raise AssertionError("20c: the reloaded LoRA model disagrees with the merge")
    return dict(gb=gb, reload_s=t_merge)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _ref2_rows(path: str) -> list:
    import pandas as pd

    files = sorted(f for f in os.listdir(path) if f.endswith(".parquet"))
    frame = pd.concat([pd.read_parquet(os.path.join(path, f)) for f in files])
    return [json.loads(x)["logps"] for x in frame["logps"]]


REF2_RUNS = {"shared": dict(), "fused": dict(shared_prefix=False, lm_head_impl="fused")}


def ref_logp_worker(out_dir: str) -> None:
    """`python3 chip_smoke.py --ref-logp-worker OUT` under torchrun's
    variables: one rank of 20d. Builds phase 8's seed-0 7B, runs
    inference_logp on phase 8's rows (both REF2_RUNS) over the gloo group,
    and writes its launches, seconds and peak memory to OUT/rank<r>.json."""
    dist_mod.initialize()
    rank = dist_mod.process_index()
    torch.backends.cuda.matmul.allow_tf32 = False  # phase 1's settings, as in phase 8
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlavaConfig.llava15_7b(remat=True)
    image_bytes = (ROOT / "examples" / "test.jpeg").read_bytes()
    rows, tok = synth_rows(image_bytes), _fake_tokenizer()
    model = build_model(cfg, f"20d rank {rank}")
    kw = dict(max_len=2048, num_patches=cfg.num_image_tokens, batch_pairs=8,
              image_processor=ClipImageProcessor(image_size=cfg.vision.image_size))
    score_preference_rows(rows[:2], model, tok, progress=False, shared_prefix=True,
                          **kw)  # warm-up, as phase 8's
    torch.cuda.synchronize()
    dist_mod.barrier("warm")
    res = {"rank": rank, "world": dist_mod.process_count(), "runs": {}}
    torch.cuda.reset_peak_memory_stats()
    for name, extra in REF2_RUNS.items():
        reset_counts()
        t0 = time.perf_counter()
        inference_logp(rows, model, tok, os.path.join(out_dir, name), **kw, **extra)
        torch.cuda.synchronize()
        res["runs"][name] = dict(seconds=time.perf_counter() - t0, launches=read_counts())
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def phase_ref_logp_two(ref_runs: dict, smi: str) -> dict:
    """20d: the precompute over REF2_WORLD processes sharing the card, each
    its own seed-0 7B (every model of this process freed first); rank 0's
    parquet against phase 8's single-process rows. The parent samples the
    card's used memory (all processes) while they run."""
    work = tempfile.mkdtemp(prefix="chip_smoke_ref2_")
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(REF2_WORLD)}
    free, total = torch.cuda.mem_get_info()
    base_used = peak_used = total - free
    launches = {}
    try:
        t0 = time.perf_counter()
        # each worker writes to a file: a pipe nobody reads while they run
        # would block a worker that prints more than its buffer holds
        log_paths = [os.path.join(work, f"rank{r}.log") for r in range(REF2_WORLD)]
        procs = []
        for r, path in enumerate(log_paths):
            with open(path, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--ref-logp-worker", work],
                    env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                    stdout=out, stderr=subprocess.STDOUT))
        try:
            while any(p.poll() is None for p in procs):
                peak_used = max(peak_used, total - torch.cuda.mem_get_info()[0])
                if time.perf_counter() - t0 > REF2_TIMEOUT:
                    raise AssertionError(f"20d: the workers ran past {REF2_TIMEOUT} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        logs = [open(path).read() for path in log_paths]
        for r, (p, out) in enumerate(zip(procs, logs)):
            for line in out.splitlines():
                if line.startswith("[20d"):
                    log(line)
            if p.returncode != 0:
                raise AssertionError(f"20d: rank {r} exited {p.returncode}:\n{out[-4000:]}")
        ranks = [json.load(open(os.path.join(work, f"rank{r}.json")))
                 for r in range(REF2_WORLD)]
        for name in REF2_RUNS:
            got, want = _ref2_rows(os.path.join(work, name)), ref_runs[name]
            if len(got) != len(want):
                raise AssertionError(f"20d: {name}: {len(got)} rows written, {len(want)} "
                                     "expected")
            rel, tmean, tmax = _seq_close(got, want, LOGP_RTOL)
            n_equal = sum(a == b for a, b in zip(got, want))
            secs = max(rk["runs"][name]["seconds"] for rk in ranks)
            ok = rel <= LOGP_RTOL and tmean <= TOKEN_MEAN_TOL and n_equal == len(want)
            for rk in ranks:
                add_counts(launches, rk["runs"][name]["launches"])
            log(f"[20d ref-logp world {REF2_WORLD}] {name}: {len(got)} pairs in {secs:.3f} s "
                f"(the slower rank) = {len(got) / secs:.2f} pairs/s | against phase 8's one "
                f"process: sums and means max rel {rel:.3e} (tol {LOGP_RTOL}) | per-token |d| "
                f"mean {tmean:.3e} (tol {TOKEN_MEAN_TOL}) max {tmax:.3e} | rows bit-equal "
                f"{n_equal} of {len(want)} | {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"20d: the {name} rows at world {REF2_WORLD} disagree")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[20d ref-logp world {REF2_WORLD}] {REF2_WORLD} worker processes on one card: wall "
        f"{wall:.1f} s (start, build, warm-up, both runs) | peak device memory, all three "
        f"processes {peak_used / 2 ** 30:.2f} GiB of {total / 2 ** 30:.1f} (this process "
        f"alone {base_used / 2 ** 30:.2f}), each worker's allocator peak "
        f"{max(rk['peak_gib'] for rk in ranks):.2f} GiB | launches {launches} | {smi}")
    if peak_used >= 80e9:
        raise AssertionError(f"20d: {peak_used / 1e9:.1f} GB used on the card")
    if launches["flash"] < 2 * LlavaConfig.llava15_7b().llm.num_layers or \
            launches["head_fwd"] < 1:
        raise AssertionError(f"20d: a kernel of the precompute did not run: {launches}")
    return launches


MESH_TWO_WORLD = 2
MESH_TWO_LAYERS = 8  # 21c's depth (full width): gloo stages each collective through the host
MESH_TWO_TIMEOUT = 300  # the 21c workers' wall limit (start, build, one step)
# tests/test_torch_mesh_train.py's metric tolerance (the CPU tests')
METRIC_ATOL, METRIC_RTOL = 1e-5, 1e-6
# 21c's grad norm against its one-process reference: the two pairs'
# bf16 gradients are summed by gloo's reduce-scatter there and by autograd
# here, each rounding once to bf16
MESH_TWO_GNORM_RTOL = 1e-3
MESH_KERNELS = ("flash", "dq", "dkv", "head_fwd", "head_dl", "head_dx", "head_dw")


def _train_optimizer(model, t):
    """Phase 6's optimizer: constant TRAIN_LR, no warm-up."""
    return make_optimizer(model, TRAIN_LR, total_steps=t.max_steps, warmup_ratio=0.0,
                          weight_decay=t.weight_decay, max_grad_norm=t.max_grad_norm,
                          schedule="constant")


def phase_mesh(train6: dict, train_pair: dict, smi: str) -> tuple:
    """21a: phase 6's seed-0 model rebuilt and wrapped through
    create_mesh(1, None, 1) and shard_params on this process's one-process
    group (NCCL axis groups), then phase 6's four steps on its pair through
    the sharded step; -> (launches, the mesh). Every number phase 6 recorded
    and the parameters' fingerprint must equal phase 6's bit for bit, and
    every step launch the kernels phase 6's did."""
    model = build_model(LlavaConfig.llava15_7b(remat=True), "21a mesh")
    mesh = sharding.create_mesh(1, None, 1, device_type="cuda")
    t0 = time.perf_counter()
    sharding.shard_params(model, mesh)
    torch.cuda.synchronize()
    t_shard = time.perf_counter() - t0
    units = sum(1 for m in model.modules() if type(m).__name__.startswith("FSDP"))
    log(f"[21a mesh] mesh {dict(sharding.axis_sizes(mesh))}, groups "
        f"{torch.distributed.get_backend(mesh.get_group('fsdp'))}; shard_params "
        f"{t_shard:.2f} s: {units} FSDP units (the root and every block), "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB after")
    tr = build_train(train_pair, model, tag="21a mesh")
    step = make_dpo_train_step(tr["adapter"], _train_optimizer(model, tr["training"]),
                               tr["hp"])
    rec = train_steps(tr, step, "21a mesh")
    rec["fingerprint"] = param_fingerprint(model)
    ref = train6["record"]
    same = {k: rec[k] == ref[k] for k in ("losses", "logps", "gnorms", "fingerprint")}
    plan = [{k: n[k] for k in MESH_KERNELS} for n in rec["counts"]]
    plan_ok = plan == [{k: n[k] for k in MESH_KERNELS} for n in ref["counts"]]
    log(f"[21a mesh] against phase 6, bit for bit: " +
        ", ".join(f"{k} {'equal' if v else 'DIFFER'}" for k, v in same.items()) +
        f" (fingerprint {rec['fingerprint'][:16]}) | launches a step {plan[0]} "
        f"{'equal to' if plan_ok else 'DIFFER from'} phase 6's | steps 1-3 "
        f"{rec['step_s']:.3f} s a step against phase 6's {ref['step_s']:.3f} "
        f"({rec['step_s'] / ref['step_s']:.2f}x), peak {rec['peak_gib']:.2f} GiB against "
        f"{ref['peak_gib']:.2f} | {smi}")
    if not (all(same.values()) and plan_ok):
        raise AssertionError(f"21a: the sharded step at one device differs from phase 6: "
                             f"{same}, launches equal {plan_ok}")
    launches = {}
    for n in rec["counts"]:
        add_counts(launches, n)
    del tr, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, mesh


def phase_mesh_lora(mesh, rows: list, tok, cfg: LlavaConfig, ref_logps: list,
                    smi: str) -> dict:
    """21b: DPOTrainer with 21a's mesh passed in, in
    configs/llava15_dpo_lora.json's mode (the bf16 base sharded, r 64
    adapters whole): two steps over phase 8's rows and reference logps, a
    checkpoint; its state.pt reloaded holds the trained adapters bit for
    bit."""
    c = Config.from_json(str(ROOT / "configs" / "llava15_dpo_lora.json"))
    t = c.training
    assert t.use_lora and (t.mesh_dp, t.mesh_fsdp, t.mesh_tp) == (1, None, 1)
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_lora_")
    t.output_dir, t.max_steps, t.save_steps = work, 2, 2
    try:
        model = build_model(LlavaConfig.llava15_7b(remat=True), "21b mesh lora")
        lora = lora_init(torch.Generator(device="cuda").manual_seed(t.seed), model, r=t.lora_r)
        items = preference_items(rows, tok, cfg, ref_logps)
        trainer = DPOTrainer(c, model, items, train_collator(tok, cfg, t.dpo_beta),
                             adapter=LlavaDPOAdapter(model), lora=lora,
                             lora_alpha=t.lora_alpha, mesh=mesh)
        if sharding.mesh_plan(model) is None:
            raise AssertionError("21b: the trainer left the model unsharded")
        reset_counts()
        t0 = time.perf_counter()
        steps = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_counts()
        restored = trainer.ckpt.restore()
        trained = dict(named_tensors(lora))
        differ = [k for k, x in trained.items()
                  if not torch.equal(restored["params"][k], x.detach().cpu())]
        with open(os.path.join(work, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f if '"loss"' in line]
        loss0 = logged[0]["loss"]
        log(f"[21b mesh lora] DPOTrainer(mesh=21a's) on llava15_dpo_lora.json: {steps} steps "
            f"in {wall:.2f} s (build of the step, checkpoint included), losses "
            f"{[round(r['loss'], 6) for r in logged]} (step 0 within {REF_LN2_TOL} of ln 2: "
            f"{loss0 - math.log(2):+.3e}) | state.pt at step {restored['step']}: "
            f"{len(trained) - len(differ)} of {len(trained)} adapters equal the trained ones "
            f"bit for bit | launches {dict((k, n[k]) for k in MESH_KERNELS)} | {smi}")
        if differ or steps != 2 or restored["step"] != 2 or \
                abs(loss0 - math.log(2)) > REF_LN2_TOL:
            raise AssertionError(f"21b: steps {steps}, checkpoint step {restored['step']}, "
                                 f"step-0 loss {loss0}, adapters differing {differ[:4]}")
        layers = cfg.llm.num_layers
        if min(n["flash"], n["dq"], n["dkv"]) < 2 * layers or n["head_fwd"] < 2 or \
                n["head_dx"] < 2 or n["head_dw"]:
            raise AssertionError(f"21b: the LoRA path's kernels ran off plan: {n}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del trainer, model, lora
    gc.collect()
    torch.cuda.empty_cache()
    return n


def _mesh_two_batch(ref_logps: list) -> tuple:
    """21c's model config and data: LLaVA-1.5-7B at full width cut to
    MESH_TWO_LAYERS layers, a global batch of the first two rows' pairs
    with phase 8's reference logps, collated and split as the trainer
    does; -> (cfg, training config, global batch, P)."""
    cfg = LlavaConfig.llava15_7b(remat=True)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=MESH_TWO_LAYERS))
    rows, tok = synth_rows((ROOT / "examples" / "test.jpeg").read_bytes()), _fake_tokenizer()
    items = preference_items(rows, tok, cfg, ref_logps)
    t = Config.from_json(str(ROOT / "configs" / "llava15_dpo.json")).training
    global_np = train_collator(tok, cfg, t.dpo_beta)(items[:MESH_TWO_WORLD])
    return cfg, t, global_np, derive_shared_prefix_len(global_np, cfg.num_image_tokens)


def mesh_worker(out_dir: str) -> None:
    """`python3 chip_smoke.py --mesh-worker OUT` under torchrun's variables:
    one rank of 21c. Builds the seed-0 model of `_mesh_two_batch`, shards
    it at (1, 2, 1) over gloo groups (both ranks share the card), trains
    one step on its pair of the global batch (gloo stages every collective
    through the host), and writes its record to OUT/rank<r>.json."""
    dist_mod.initialize()
    rank = dist_mod.process_index()
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False  # phase 1's settings, as in phase 6
    torch.backends.cudnn.allow_tf32 = False
    tag = f"21c rank {rank}"
    with open(os.path.join(out_dir, "ref_logps.json")) as f:
        cfg, t, global_np, P = _mesh_two_batch(json.load(f))
    model = build_model(cfg, tag)
    mesh = sharding.create_mesh(1, None, 1, device_type="cuda", backend="gloo")
    sharding.shard_params(model, mesh)
    tr = build_train(dict(batch_np=sharding.shard_pairs(global_np, mesh), P=P, training=t),
                     model, tag=tag)
    step = make_dpo_train_step(tr["adapter"], _train_optimizer(model, t), tr["hp"])
    dist_mod.barrier("built")
    rec = train_steps(tr, step, tag, n_steps=1)
    rec.update(rank=rank, mesh=sharding.axis_sizes(mesh))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def mesh_two_reference(ref_logps: list) -> dict:
    """21c's reference, in this process with no group: the same seed-0 cut
    model unsharded, each rank's pair run as a micro-batch at the shape that
    rank runs it, the gradients summed in .grad; -> each pair's loss and
    logps, their means, and the norm of the mean gradient (the sum's norm
    halved, exactly). Its launches count toward no path."""
    cfg, t, global_np, P = _mesh_two_batch(ref_logps)
    model = build_model(cfg, "21c reference")
    pairs = []
    for r in range(MESH_TWO_WORLD):
        part = sharding.shard_pairs(global_np, (1, MESH_TWO_WORLD, 1), rank=r)
        tr = build_train(dict(batch_np=part, P=P, training=t), model,
                         tag=f"21c reference, rank {r}'s pair")
        loss, metrics = dpo_loss_from_batch(tr["adapter"], tr["batch"], tr["hp"])
        loss.backward()
        pairs.append(dict(loss=float(loss.detach()),
                          logps=(float(metrics["logps_train/chosen"]),
                                 float(metrics["logps_train/rejected"]))))
    grads = ((n, p.grad) for n, p in model.named_parameters())
    gnorm = float(sharding.global_norm(grads)) / MESH_TWO_WORLD
    reset_counts()
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(pairs=pairs, gnorm=gnorm,
                loss=sum(p["loss"] for p in pairs) / MESH_TWO_WORLD,
                logps=[sum(p["logps"][i] for p in pairs) / MESH_TWO_WORLD for i in (0, 1)])


def phase_mesh_two(ref_logps: list, ref6: dict, smi: str) -> dict:
    """21c: the sharded trainer's step over MESH_TWO_WORLD processes on the
    one card (every model of this process freed first), each rank on its
    own pair, against `mesh_two_reference` on both pairs: both ranks' loss
    and logps (the global batch's means) within the CPU tests' metric
    tolerance, their grad norm (the gradients reduce-scattered over gloo)
    within MESH_TWO_GNORM_RTOL. The two pairs' logps must differ by far more
    than that tolerance, so that a rank training on the wrong pair shows."""
    t0 = time.perf_counter()
    ref = mesh_two_reference(ref_logps)
    t_ref = time.perf_counter() - t0
    tol = lambda x: METRIC_ATOL + METRIC_RTOL * abs(x)  # noqa: E731
    (c0, r0), (c1, r1) = (p["logps"] for p in ref["pairs"])
    if min(abs(c0 - c1), abs(r0 - r1)) < 100 * tol(max(abs(c0), abs(c1), abs(r0), abs(r1))):
        raise AssertionError(f"21c: the two pairs' logps are too close to tell apart: "
                             f"{ref['pairs']}")
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_two_")
    with open(os.path.join(work, "ref_logps.json"), "w") as f:
        json.dump(ref_logps, f, default=lambda x: x.tolist() if hasattr(x, "tolist")
                  else float(x))
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(MESH_TWO_WORLD)}
    free, total = torch.cuda.mem_get_info()
    base_used = peak_used = total - free
    log(f"[21c mesh world {MESH_TWO_WORLD}] reference on both pairs in {t_ref:.1f} s "
        f"(build included): losses {[p['loss'] for p in ref['pairs']]}, chosen/rejected "
        f"logps {[p['logps'] for p in ref['pairs']]}, grad norm {ref['gnorm']} | before the "
        f"workers start: {base_used / 2 ** 30:.2f} GiB of the card in use")
    launches = {}
    try:
        t0 = time.perf_counter()
        log_paths = [os.path.join(work, f"rank{r}.log") for r in range(MESH_TWO_WORLD)]
        procs = []
        for r, path in enumerate(log_paths):
            with open(path, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker", work],
                    env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                    stdout=out, stderr=subprocess.STDOUT))
        try:
            while any(p.poll() is None for p in procs):
                peak_used = max(peak_used, total - torch.cuda.mem_get_info()[0])
                if time.perf_counter() - t0 > MESH_TWO_TIMEOUT:
                    raise AssertionError(f"21c: the workers ran past {MESH_TWO_TIMEOUT} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        failed = []
        for r, (p, path) in enumerate(zip(procs, log_paths)):
            out = open(path).read()
            for line in out.splitlines():
                if line.startswith("[21c"):
                    log(line)
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n{out[-3000:]}")
        if failed:
            raise AssertionError("21c: " + "\n".join(failed))
        ranks = [json.load(open(os.path.join(work, f"rank{r}.json")))
                 for r in range(MESH_TWO_WORLD)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    off = []
    for rk in ranks:
        got = [rk["losses"][0], *rk["logps"][0]]
        for what, g, w in zip(("loss", "chosen logp", "rejected logp"), got,
                              [ref["loss"], *ref["logps"]]):
            if abs(g - w) > tol(w):
                off.append(f"rank {rk['rank']} {what} {g} against {w}")
        if abs(rk["gnorms"][0] - ref["gnorm"]) > MESH_TWO_GNORM_RTOL * ref["gnorm"]:
            off.append(f"rank {rk['rank']} grad norm {rk['gnorms'][0]} against {ref['gnorm']}")
        for n in rk["counts"]:
            add_counts(launches, n)
    loss_err = max(abs(rk["losses"][0] - ref["loss"]) for rk in ranks)
    gn_err = max(abs(rk["gnorms"][0] - ref["gnorm"]) for rk in ranks) / ref["gnorm"]
    log(f"[21c mesh world {MESH_TWO_WORLD}] mesh {ranks[0]['mesh']} over gloo groups on one "
        f"card, {MESH_TWO_LAYERS} layers at full width, a pair a rank: step-0 loss "
        f"{[rk['losses'][0] for rk in ranks]} against the reference's mean {ref['loss']} "
        f"(|d| {loss_err:.3e}, tol {tol(ref['loss']):.3e}) | logps "
        f"{[rk['logps'][0] for rk in ranks]} against {ref['logps']} | grad norm "
        f"{[rk['gnorms'][0] for rk in ranks]} against {ref['gnorm']} (relative {gn_err:.3e}, "
        f"tol {MESH_TWO_GNORM_RTOL}) | the step {max(rk['times'][0] for rk in ranks):.3f} s "
        f"(the slower rank; phase 6's steps 1-3 at 32 layers {ref6['step_s']:.3f}) | wall "
        f"{wall:.1f} s | peak device memory, all three processes "
        f"{peak_used / 2 ** 30:.2f} GiB of {total / 2 ** 30:.1f} (this process alone "
        f"{base_used / 2 ** 30:.2f}), each worker's allocator peak "
        f"{max(rk['peak_gib'] for rk in ranks):.2f} GiB | "
        f"launches {dict((k, launches[k]) for k in MESH_KERNELS)} | {smi}")
    if off:
        raise AssertionError(f"21c: world {MESH_TWO_WORLD} is off its one-process reference: "
                             + "; ".join(off))
    return launches


def _row(name, source, replaces, launches, err, timing, note: str = "") -> dict:
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, **{k: timing[k] for k in keys},
            **({"note": note} if note else {})}


def timed(tag: str, fn, *args):
    """fn(*args), then one line with the phase's wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    log(f"[{tag}] phase wall {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        sys.exit(1)
    t_start = time.perf_counter()
    smi = phase_environment()
    timed("2 build", phase_build)
    # the flash kernels' and #4's broken copies build while 3 and 3b run
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(1)
    flash_variants = pool.submit(build_variants, {**FLASH_FWD_FAULTS, **FLASH_DKV_FAULTS,
                                                  **FLASH_DQ_FAULTS, **PREFIX_FAULTS})
    fused_copies = pool.submit(fused_variants)
    g = torch.Generator(device="cuda").manual_seed(0)
    kern = timed("3 kernels", phase_kernels, g, flash_variants)
    cfg = LlavaConfig.llava15_7b()
    image_bytes = (ROOT / "examples" / "test.jpeg").read_bytes()
    tok = _fake_tokenizer()
    rows = synth_rows(image_bytes)
    pair = collate_train_pair(preference_items(rows, tok, cfg), tok, cfg)
    short = short_row(image_bytes)
    bwd = timed("3b flash backward", phase_backward, g, pair, flash_variants,
                omni_pair(rows, tok))
    pool.shutdown()
    head = timed("3c fused head", phase_head, g, pair)
    qb = dict(qlora_batches(rows, short, tok, cfg), omni_ms=omni_ms(rows, short, tok))
    int8 = timed("3d int8", phase_int8, g, qb)
    int4 = timed("3e int4", phase_int4, g, qb)
    kv8 = timed("3f int8 decode", phase_kv8_kernel, g)
    fused = timed("3g fused decode", phase_fused_kernel, g, fused_copies)
    full = timed("3h full decode", phase_full_kernel, g)
    timed("15a continuous kernels", phase_continuous_kernels, g)

    t0 = time.perf_counter()
    model = LlavaForCausalLM(cfg, device="meta").to_empty(device="cuda")
    init_weights_(model, torch.Generator(device="cuda").manual_seed(0)).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[4 slice] LLaVA-1.5-7B bf16 on cuda: {n_params / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    log("[4 slice] weights are random (seed 0) and the tokenizer is the "
        "synthetic character-level tests/fake_tokenizer.py: the text is "
        "meaningless, the shapes and paths are the real ones")
    gen = Llava15Generator(model, tok, cfg.num_image_tokens,
                           image_size=cfg.vision.image_size,
                           checkpoint_name="random-llava15-7b")
    launches, bf16_rates = timed("4 slice", phase_slice, gen, image_bytes)
    timed("5 slice vs plain", phase_slice_vs_plain, gen, image_bytes)
    # 14 runs the eval slice on the same bf16 model before 11 changes it
    eval_launches, beam4 = timed("14 eval", phase_eval, gen, image_bytes)
    add_counts(launches, eval_launches)
    # 19 serves the options ported last (smoothed int4, prompt-lookup
    # decoding, LLaVA-1.6 anyres, the smoothed int4 D&C backend) on models of
    # its own beside phase 4's, which it reads and leaves unchanged
    add_counts(launches, timed("19 options", phase_options, gen, tok, image_bytes, smi))
    # 20a-c: the JPEG loader, the device image pipeline on phase 4's tower,
    # and phase 4's model exported and reloaded (left unchanged)
    decoded = timed("20a native loader", phase_loader, image_bytes, smi)
    timed("20b preprocess", phase_preprocess, model, decoded, smi)
    del decoded
    add_counts(launches, timed("20c export", phase_export, gen, tok, image_bytes,
                               smi)["launches"])
    # 15 runs continuous batching on the bf16 model, then (15c) on 11's
    # int8-KV model and on 12's fused engine
    cont_launches, _ = timed("15b continuous", phase_continuous, gen, image_bytes, smi)
    add_counts(launches, cont_launches)
    # 11 serves the same seed-0 model in the int8-KV configuration, 12 the
    # same quantised model through the fused engine (which consumes its
    # per-layer weights), 13 the feedback pipeline with that fused generator
    kv8_launches, int8_kv_rates = timed("11 int8-kv", phase_int8_kv, gen, image_bytes,
                                        bf16_rates)
    add_counts(launches, kv8_launches)
    n_layers = cfg.llm.num_layers
    add_counts(launches, timed("15c continuous int8-kv", phase_continuous_engine, gen,
                               image_bytes, smi, "15c int8-kv", "decode_int8", n_layers,
                               ("decode",), ("int8", "int8_prequant"), prefix_block_l))
    fused_launches, fgen = timed("12 fused", phase_fused, gen, image_bytes, int8_kv_rates)
    add_counts(launches, fused_launches)
    add_counts(launches, timed("15c continuous fused", phase_continuous_engine, fgen,
                               image_bytes, smi, "15c fused", "fused", 1,
                               ("decode", "decode_int8", "int8"), ("int8_prequant",),
                               lambda L: fd.default_dims(fgen.engine.llm.cfg, L).bl))
    del gen
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    try:
        add_counts(launches, timed("13 pipeline", phase_pipeline, fgen, tok, work))
        del fgen, model
        gc.collect()
        torch.cuda.empty_cache()
        # 16 serves OmniLMM-12B (its labeler stage on 13's questions), then
        # frees it before 8 builds the training model
        add_counts(launches, timed("16 omnilmm", phase_omnilmm, tok, image_bytes, work, smi))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # 17 trains OmniLMM-12B's adapters on its two QLoRA configs, 16's models
    # freed, each config on a model of its own
    add_counts(launches, timed("17 omnilmm qlora", phase_omni_train, tok, image_bytes, smi))
    # 18 serves MiniCPM-Llama3-V 2.5 (bf16, int8, fused, int4; continuous
    # with spans), 17's models freed
    add_counts(launches, timed("18 minicpmv", phase_minicpmv, tok, image_bytes, smi))

    # 8 scores the rows with the frozen starting policy; 7 and 6 train that
    # same model on the first row's pair against those reference logps (7
    # runs on the weights before any update: the DPO loss of this random
    # model saturates after one step at any lr that moves bf16 weights)
    model = build_model(LlavaConfig.llava15_7b(remat=True))
    ref_runs = {}
    ref_logps, rl = timed("8 ref-logp", phase_ref_logp, model, tok, rows, cfg, ref_runs)
    add_counts(launches, rl)
    train_pair = collate_train_pair(preference_items(rows, tok, cfg, ref_logps), tok, cfg)
    assert (train_pair["batch_np"]["input_ids"] == pair["batch_np"]["input_ids"]).all()
    tr = build_train(train_pair, model)
    timed("7 train vs plain", phase_train_vs_plain, tr["model"], tr["adapter"], tr["batch"],
          tr["hp"])
    train6 = timed("6 train", phase_train, tr)
    add_counts(launches, train6["launches"])
    del tr, model  # phase 6's model, gradients and optimizer (~55 GiB)
    gc.collect()
    torch.cuda.empty_cache()

    # 9 rebuilds phase 8's seed-0 model, quantises it and trains adapters
    model = build_model(LlavaConfig.llava15_7b(remat=True), "9 qlora")
    add_counts(launches, timed("9 qlora", phase_qlora, model, tok, rows, short, cfg, ref_logps))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 10 rebuilds it once more and quantises it to int4
    model = build_model(LlavaConfig.llava15_7b(remat=True), "10 int4")
    add_counts(launches, timed("10 int4", phase_qlora_int4, model, tok, rows, cfg, ref_logps))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 20d: phase 8's precompute again over two processes on this card
    add_counts(launches, timed("20d ref-logp world 2", phase_ref_logp_two, ref_runs, smi))

    # 21: the mesh slice. 21a and 21b on a one-process group of this
    # process (NCCL axis groups), 21c over two processes sharing the card
    dist_mod.initialize(coordinator=f"127.0.0.1:{_free_port()}", num_processes=1,
                        process_id=0)
    mesh_launches, mesh = timed("21a mesh", phase_mesh, train6, train_pair, smi)
    add_counts(launches, mesh_launches)
    add_counts(launches, timed("21b mesh lora", phase_mesh_lora, mesh, rows, tok, cfg,
                               ref_logps, smi))
    del mesh
    torch.distributed.destroy_process_group()
    add_counts(launches, timed("21c mesh world 2", phase_mesh_two, ref_logps,
                               train6["record"], smi))

    log(f"[10 int4] main-path launches (serving 4, the eval slice 14, continuous batching "
        f"15b-c, int8-KV serving 11 with its beam batch, fused serving 12, "
        f"the feedback pipeline 13, OmniLMM-12B 16a-e, OmniLMM-12B QLoRA 17a-b, "
        f"MiniCPM-Llama3-V 2.5 18a-e, the serving options 19a-d, the reloaded export 20c, "
        f"ref-logp 8, train 6, QLoRA 9, int4 QLoRA 10, ref-logp at world 2 20d, the mesh "
        f"21a-c): "
        f"{launches}")
    src = "rlaifv_tpu_torch/csrc/flash_attention_bwd.cu"
    head_src = "rlaifv_tpu_torch/csrc/fused_head.cu"
    suffix, sfx12 = bwd["cases"]["train suffix"], bwd["cases"]["12B suffix"]
    gqa = kern["decode_cases"]["Llama3 GQA"]
    kernels = [
        _row("flash_attention_fwd", "rlaifv_tpu_torch/csrc/flash_attention.cu",
             "rlaifv_tpu/ops/flash_attention.py:73", launches["flash"],
             max(kern["flash"]["max_abs_err"], bwd["fwd_err"]), kern["flash"],
             "redesigned: TMA-fed wgmma, online softmax and O in registers, P as the "
             "register A operand; one kernel a call (a CUDA graph of one call, 3)"),
        _row("flash_attention_bwd_dq", src, "rlaifv_tpu/ops/flash_attention.py:157",
             launches["dq"], bwd["dq_err"],
             dict(ms=suffix["dq_ms"], plain_ms=suffix["plain_ms"],
                  library_ms=suffix["library_ms"], **suffix["dq_bound"]),
             "redesigned: TMA-fed wgmma, dQ summed in registers, dS as the register A "
             "operand; one kernel a call (a CUDA graph of one call, 3b); at phase 17's "
             f"OmniLMM-12B suffix (GQA n_rep 4) {sfx12['dq_ms']:.4f} ms against a bound of "
             f"{sfx12['dq_bound']['bound_ms']:.4f}"),
        _row("flash_attention_bwd_dkv", src, "rlaifv_tpu/ops/flash_attention.py:191",
             launches["dkv"], bwd["dkv_err"],
             dict(ms=suffix["dkv_ms"], plain_ms=suffix["plain_ms"],
                  library_ms=suffix["library_ms"], **suffix["dkv_bound"]),
             "redesigned: TMA-fed wgmma, dK and dV summed in registers, P^T and dS^T as "
             "register A operands; one kernel a call (a CUDA graph of one call, 3b); at phase "
             f"17's OmniLMM-12B suffix (GQA n_rep 4) {sfx12['dkv_ms']:.4f} ms against a bound "
             f"of {sfx12['dkv_bound']['bound_ms']:.4f}"),
        _row("decode_attention_prefix", "rlaifv_tpu_torch/csrc/decode_attention.cu",
             "rlaifv_tpu/ops/decode_attention.py:59", launches["decode"],
             kern["decode"]["max_abs_err"], kern["decode"],
             "redesigned: the live keys split over CTAs where B x KVH does not fill a wave "
             f"({kern['decode']['splits']} here, {gqa['splits']} at the bf16 Llama3 GQA step: "
             f"{gqa['ms']:.4f} ms against a bound of {gqa['bound_ms']:.4f}, SDPA "
             f"{gqa['library_ms']:.4f}), each warp's k/v tiles by TMA through its own ring, "
             "both products on mma.sync; one call launched "
             f"{kern['decode']['kernels_a_call']} kernel here (a CUDA graph of one call, 3); "
             f"at phase 14's beam step (B {beam4['B']}, L {beam4['L']}, valid_len "
             f"{beam4['valid']}) "
             f"{beam4['ms']:.4f} ms against a bound of {beam4['bound_ms']:.4f}, SDPA "
             f"{beam4['library_ms']:.4f}"),
        _row("fused_head_fwd", head_src, "rlaifv_tpu/ops/fused_head.py:128,157",
             launches["head_fwd"], head["fwd_err"], head["fwd"]["train step"],
             "redesigned: the TMA + wgmma mainloop with an online-softmax epilogue over "
             "vocabulary splits, then the combine; one wrapper call launched "
             f"{head['fwd']['train step']['kernels_a_call']} kernels here (a CUDA graph of "
             "one call, 3c; launches counts calls)"),
        _row("fused_head_dx", head_src, "rlaifv_tpu/ops/fused_head.py:318",
             launches["head_dx"], head["dx_err"], head["bwd"]["train step"]["dx"],
             f"the dl and dx kernels, two products; dl launches {launches['head_dl']}"),
        _row("fused_head_dw", head_src, "rlaifv_tpu/ops/fused_head.py:334",
             launches["head_dw"], head["dw_err"], head["bwd"]["train step"]["dw"],
             "the dW product given dl, one product"),
    ]
    # rows 7-10 at the shapes of phase 9 that launch them: the short step's
    # suffix (#7, #8) and the 8-pair step's prefix (#9, #10), gate/up widths
    q_src, q_py = "rlaifv_tpu_torch/csrc/quant_matmul.cu", "rlaifv_tpu/ops/quant_matmul.py"
    small, large = int8[(qb["m_short"], 4096, 11008)], int8[(qb["m_prefix"], 4096, 11008)]
    eva_fc1 = (EVA_MS[1], 1792, 15360)
    eva8, eva4 = int8[eva_fc1], int4[eva_fc1]
    kernels += [
        _row("int8_matmul", q_src, f"{q_py}:36", launches["int8"], int8["err"], small[7],
             f"redesigned: a row pass and the split product (route {small[7]['route']}, "
             f"{small[7]['split']} K slices here); one wrapper call launched "
             f"{small[7]['kernels_a_call']} kernels here (a CUDA graph of one call, 3d; "
             "launches counts calls)"),
        _row("int8_matmul_dx", q_src, f"{q_py}:132", launches["int8_dx"], int8["err"],
             small[8], "redesigned: a row pass, the split wgmma product and the sum of "
             f"its slices; one wrapper call launched {small[8]['kernels_a_call']} kernels "
             "here (a CUDA graph of one call, 3d; launches counts calls)"),
        _row("int8_matmul_prequant", q_src, f"{q_py}:244", launches["int8_prequant"],
             int8["err"], large[9],
             f"redesigned: the {large[9]['route']} route here (a 128 x 256 TMA + wgmma tile "
             "with q^T built in registers); one product call launched "
             f"{large[9]['kernels_a_call']} kernel here (a CUDA graph of one call, 3d); the "
             f"whole wrapper call with its row pass {large[9]['call_ms']:.4f} ms; at EVA02's "
             f"fc1 (M {EVA_MS[1]}, K 1792, N 15360, 16b) {eva8[9]['ms']:.4f} ms against a bound "
             f"of {eva8[9]['bound_ms']:.4f}, torch._int_mm {eva8[9]['library_ms']:.4f}, the "
             f"QuantDense call with its bias {int8['eva_quant_dense'][eva_fc1]:.4f}"),
        _row("int8_matmul_dx_prequant", q_src, f"{q_py}:340",
             launches["int8_dx_prequant"], int8["err"], large[10],
             f"redesigned: the {large[10]['route']} route here (a 128 x 256 TMA + wgmma "
             "tile where its tiles fill the card, #8's split product where they do not); "
             f"one wrapper call launched {large[10]['kernels_a_call']} kernel here (a CUDA "
             "graph of one call, 3d)"),
    ]
    # rows 11-12 at the 8-pair step's prefix of phase 10: #11 at gate/up
    # (K = 4096, N = 11008), #12 at down_proj's dx (N = 4096, K = 11008)
    i4_src, i4_py = "rlaifv_tpu_torch/csrc/int4_matmul.cu", "rlaifv_tpu/ops/int4_matmul.py"
    kernels += [
        _row("int4_matmul", i4_src, f"{i4_py}:135", launches["int4"], int4["err"],
             int4[(qb["m_prefix"], 4096, 11008)][11],
             "redesigned: TMA ring, warp-specialised unpacking, int8 wgmma, per-group "
             "rescale; one wrapper call launched "
             f"{int4[(qb['m_prefix'], 4096, 11008)][11]['kernels_a_call']} kernel here (a "
             f"CUDA graph of one call, 3e); at EVA02's fc1 (M {EVA_MS[1]}, K 1792, N 15360, "
             f"16d) {eva4[11]['ms']:.4f} ms against a bound of {eva4[11]['bound_ms']:.4f}, "
             f"torch._int_mm {eva4[11]['library_ms']:.4f}, the QuantDense call with its bias "
             f"{int4['eva_quant_dense'][eva_fc1]:.4f}"),
        _row("int4_matmul_dx", i4_src, f"{i4_py}:240", launches["int4_dx"], int4["err"],
             int4[(qb["m_prefix"], 11008, 4096)][12],
             "redesigned: the row-maximum pass and the warp-specialised product; one "
             f"wrapper call launched {int4[(qb['m_prefix'], 11008, 4096)][12]['kernels_a_call']}"
             " kernels here (a CUDA graph of one call, 3e; launches counts calls)"),
    ]
    # row 14 at diverse_gen's decode step (B = 10, valid_len = L = 896), the
    # shape of row 4; the library time is SDPA over the cache dequantised
    # to bf16, the dequantisation left out
    kernels.append(_row(
        "decode_attention_prefix_int8", "rlaifv_tpu_torch/csrc/decode_attention_int8.cu",
        "rlaifv_tpu/ops/decode_attention.py:180", launches["decode_int8"], kv8["err"],
        kv8["diverse_gen"],
        f"redesigned: key blocks split over CTAs where B x KVH does not fill a wave "
        f"({kv8['diverse_gen']['splits']} here, {kv8['Llama3 GQA']['splits']} at the Llama3 "
        f"GQA step: {kv8['Llama3 GQA']['ms']:.4f} ms against a bound of "
        f"{kv8['Llama3 GQA']['bound_ms']:.4f}), a TMA ring of k/v tiles, both products on "
        "mma.sync; one call launched "
        f"{kv8['diverse_gen']['kernels_a_call']} kernel here (a CUDA graph of one call, 3f)"))
    # row 16 at the batch-24 headline's decode step (int8, L 1024, cache_index
    # 960); max_abs_err is x_out's over 3g's cases; no single PyTorch call
    # computes the function (library_ms null; 12 logs the eager step beside it)
    kernels.append(_row(
        "fused_decode_step", "rlaifv_tpu_torch/csrc/fused_decode.cu",
        "rlaifv_tpu/ops/fused_decode.py:603", launches["fused"], fused["err"],
        fused["batch-24 headline"],
        "redesigned: key-split attention (kernel #5's design) with the cache streamed by "
        "TMA, the weights through a TMA ring with int8 contraction slices, each phase's "
        "first stages issued before its barrier, an acquire-release grid barrier; one "
        "cooperative launch a step"))
    # row 6 at the Llama3 GQA geometry (B 8, L 2304, KVH 8, bf16): no path
    # of the port calls it (none of the JAX package does), so its launches
    # on the main path are 0
    kernels.append(_row(
        "decode_attention", "rlaifv_tpu_torch/csrc/decode_attention_full.cu",
        "rlaifv_tpu/ops/decode_attention.py:34", launches["decode_full"], full["err"],
        full["Llama3 GQA"],
        f"redesigned: the key axis in {full['Llama3 GQA']['splits']} splits here and their "
        f"merge; one call launched {full['Llama3 GQA']['kernels_a_call']} kernels here (a "
        "CUDA graph of one call, 3h)"))
    log(f"[done] {len(kernels)} kernels; chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _profile_steps(step, batch, label: str, extra: str) -> None:
    """torch.profiler over two steps after one warm-up step: wall and device
    time a step, the device's idle share, the kernels with the most device
    time and every kernel whose name holds `extra`."""
    from torch.profiler import ProfilerActivity, profile

    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 2 * 1e3
    # device-side events only (kernels, copies, sets): an operator's own row
    # repeats the time of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    device = sum(dev(e) for e in kernels) / 2 / 1e3
    log(f"[profile] {label}: {wall:.1f} ms a step wall (profiled), {device:.1f} "
        f"ms of device time ({1 - device / wall:.1%} idle), {len(kernels)} kernel names")
    top = sorted(kernels, key=dev, reverse=True)
    for e in top[:20] + [e for e in top[20:] if extra in e.key]:
        log(f"[profile]   {dev(e) / 2 / 1e3:8.2f} ms  x{e.count // 2:<5d} {e.key[:90]}")


def _profile_setup():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        sys.exit(1)
    phase_environment()
    phase_build()
    image_bytes = (ROOT / "examples" / "test.jpeg").read_bytes()
    return LlavaConfig.llava15_7b(), _fake_tokenizer(), image_bytes, synth_rows(image_bytes)


def profile_train() -> None:
    """`python3 chip_smoke.py --profile-train`: a one-off breakdown of the
    7B train step, not part of the smoke run. torch.profiler over two steps
    with the fused head and two with the "xla" head on phase 6's pair (the
    first row of phase 8's rows; zero reference logps, since only time is
    read), each after one warm-up step."""
    cfg, tok, _, rows = _profile_setup()
    pair = collate_train_pair(preference_items(rows, tok, cfg), tok, cfg)
    for key in ("ref_win_logp", "ref_rej_logp"):
        pair["batch_np"][key] = np.zeros(1, np.float32)
    tr = build_train(pair, build_model(LlavaConfig.llava15_7b(remat=True)))
    t = tr["training"]
    optimizer = make_optimizer(tr["model"], TRAIN_LR, total_steps=t.max_steps,
                               warmup_ratio=0.0, weight_decay=t.weight_decay,
                               max_grad_norm=t.max_grad_norm, schedule="constant")
    for head in ("fused", "xla"):
        step = make_dpo_train_step(tr["adapter"], optimizer,
                                   dataclasses.replace(tr["hp"], lm_head_impl=head))
        _profile_steps(step, tr["batch"], f"head {head}", "fused_head")


def profile_qlora(bits: int) -> None:
    """`python3 chip_smoke.py --profile-qlora [--int4]`: the same breakdown
    of phase 9's QLoRA step (8 pairs, int8 base quantised on the card, r 64
    adapters, the fused head; zero reference logps), or with --int4 of
    phase 10's (the int4 base)."""
    cfg, tok, image_bytes, rows = _profile_setup()
    qb = qlora_batches(rows, short_row(image_bytes), tok, cfg, bits=bits)
    t = qb["config"].training
    for key in ("ref_win_logp", "ref_rej_logp"):
        qb["batch_np"][key] = np.zeros(t.per_device_batch_pairs, np.float32)
    model = build_model(LlavaConfig.llava15_7b(remat=True), "profile")
    if bits == 4:
        quantize_llm_int4(model)
    else:
        quantize_llm_int8(model, include_lm_head=False)
    model.train()
    lora = lora_init(torch.Generator(device="cuda").manual_seed(t.seed), model, r=t.lora_r)
    optimizer = make_optimizer(lora, QLORA_LR, total_steps=t.max_steps, warmup_ratio=0.0,
                               weight_decay=t.weight_decay, max_grad_norm=t.max_grad_norm,
                               schedule="constant")
    hp = DPOHparams(beta=t.dpo_beta, lm_head_impl="fused", shared_prefix_len=qb["P"])
    step = make_lora_dpo_train_step(LlavaDPOAdapter(model), optimizer, hp, lora,
                                    lora_alpha=t.lora_alpha)
    _profile_steps(step, batch_to_device(qb["batch_np"], "cuda"),
                   f"qlora, int{bits} base, 8 pairs", "int4" if bits == 4 else "qmm")


def profile_omni_qlora(bits: int) -> None:
    """`python3 chip_smoke.py --profile-omni-qlora [--int4]`: the same
    breakdown of phase 17's OmniLMM-12B QLoRA step (the config's 4 pairs,
    its base built and quantised by the entry point, r 64 adapters, the
    fused head; zero reference logps): 17a's, or with --int4 17b's."""
    _, tok, image_bytes, rows = _profile_setup()
    c = Config.from_json(str(ROOT / "configs" / OMNI_QLORA[0 if bits == 8 else 1][1]))
    assert c.model.quantize_bits == bits
    qb = omni_batches(rows, None, tok, c)
    t = c.training
    for key in ("ref_win_logp", "ref_rej_logp"):
        qb["batch_np"][key] = np.zeros(t.per_device_batch_pairs, np.float32)
    model = _omni_train_model(tok, c, "profile")
    model.train()
    lora = lora_init(torch.Generator(device="cuda").manual_seed(t.seed), model, r=t.lora_r)
    optimizer = make_optimizer(lora, QLORA_LR, total_steps=t.max_steps, warmup_ratio=0.0,
                               weight_decay=t.weight_decay, max_grad_norm=t.max_grad_norm,
                               schedule="constant")
    hp = DPOHparams(beta=t.dpo_beta, lm_head_impl="fused", shared_prefix_len=qb["P"])
    step = make_lora_dpo_train_step(get_family("omnilmm").adapter(model), optimizer, hp, lora,
                                    lora_alpha=t.lora_alpha)
    _profile_steps(step, batch_to_device(qb["batch_np"], "cuda"),
                   f"omnilmm qlora, int{bits} base, {t.per_device_batch_pairs} pairs",
                   "int4" if bits == 4 else "qmm")


if __name__ == "__main__":
    if "--profile-train" in sys.argv[1:]:
        profile_train()
    elif "--profile-qlora" in sys.argv[1:]:
        profile_qlora(4 if "--int4" in sys.argv[1:] else 8)
    elif "--profile-omni-qlora" in sys.argv[1:]:
        profile_omni_qlora(4 if "--int4" in sys.argv[1:] else 8)
    elif "--ref-logp-worker" in sys.argv[1:]:
        ref_logp_worker(sys.argv[sys.argv.index("--ref-logp-worker") + 1])
    elif "--mesh-worker" in sys.argv[1:]:
        mesh_worker(sys.argv[sys.argv.index("--mesh-worker") + 1])
    else:
        main()
