#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (src/repro_torch) runs on an H100.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this checkout; it imports nothing of JAX or
of the JAX package.  Phases, each of which raises (exit code 1) on
failure:

1. build the fourteen CUDA kernels from kernels/csrc (poisson_counts.cu,
   fused_pass.cu, which holds the three fused ones, kmeans_assign.cu,
   fused_kmeans.cu, fused_grouped.cu, which holds the two GROUP BY ones
   (the keyed histogram with its index pass), weighted_moments.cu,
   weighted_hist.cu, fused_stream.cu, fused_binblocked.cu,
   flash_attention.cu and flash_attention_bwd.cu, kernel 12's backward;
   one nvcc per source, all at once) and print the build seconds and
   ptxas's registers and spills; kernel 12's tensor-core instances and
   every instance of its backward (each of its tensor-core route's three
   kernels named and present), kernels 2, 3, 4, 6, 7, 8 (its
   assignment pass too) and 10 and the keyed histogram must spill 0
   bytes, and kernel 8's instance of the B=256, n=2^22 bootstrap use at
   most 128 registers;
2. print the card's name and power limit (nvidia-smi);
3. hold every kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at B=256, n=2^20+37, with and without a
   validity mask, and on the binning's edge values: weights, w_tot and
   histogram and k-means counts bitwise; s1 and k-means sums within
   1e-5·Σw|x|, s2 within 1e-5·Σw·x² and k-means inertia within
   1e-5·Σw·min-d² per entry; the k-means kernels also at k=16, d=8 (past
   the fused kernel's register chunk) and on exact ties; group members
   bitwise equal to the dedicated kernels, a KMeansStep member included;
   the GROUP BY kernels at G=8, d in {1, 4}, with a key that has no rows
   and at G·(2d+1) > 128, and every keyed slot (moments, histogram,
   k-means) bitwise equal to the dedicated kernel masked to its key,
   also at G = 1 and at G = 32 with uniform and skewed keys; kernels 3
   and 4 and the keyed histogram with every value in one bin (bitwise)
   and under a mask of 0, 1, 0.5 (and 0.25), within 1e-6 of the row's
   mass a bin; kernels 6 and 8 on values with +-inf in one key's rows and
   NaN in another's (d in {1, 2}, with and without a mask): the plain
   version's NaN and inf positions, the finite entries within the bounds
   above, and every keyed slot the masked dedicated kernel's, bitwise
   with NaN at the same places; kernel 9 on +-inf and NaN (NaN also on a
   row of weight 0; d in {1, 2} and k = 16, d = 8; unit and whole-number
   weights) at the plain version's NaN and inf positions, counts bitwise,
   and at the k-means path's shape one kernel on the card a call
   (torch.profiler), two calls bitwise and no weights bitwise unit
   weights; the
   explicit-weight kernels (weighted_moments at B in {1, 7, 256}, n in
   {1, 1000, 2^20+37}, d in {1, 3, 8}; weighted_histogram at R in
   {1, 256}, d in {1, 4}, nbins in {256, 2048}, with NaN, +-inf, values
   past the edges and zero weights) under whole-number and fractional
   weights, R = 256 rows bitwise 256 one-row launches, every value in one
   bin (R in {1, 256}, and unit weights), n = 1, 2, 3 (mod 4) with W a
   row slice 0, 4 or 12 bytes off a 16-byte boundary, and repeat launches
   of whole-number weights bitwise; the output-tiled histogram (kernel
   7, block_bins in {128, 512, 2048}, d in {1, 4, 64} at nbins = 2048,
   ragged n, NaN, +-inf and values past the edges, with and without a
   mask) bitwise equal to the plain version and to the one-window kernel
   where that fits, keyed at G = 8, d = 4 (65,536 bins a row; bitwise the
   keyed histogram too, which raises, naming block_bins, at d = 32, past
   one key's row of an SM), over several column ranges (n = 2^20+37, d
   = 64) and one, with n_valid, and at B = 100; the streamed
   moments (kernel 5, B in {8, 256}, n in {300, 65,536, 2^20+37}, d in
   {1, 3, 64}, aligned and misaligned x, with and without a mask) bitwise
   equal to kernel 2 and within 1e-5·Σw|x| of the plain version; flash
   attention (kernel 12: bf16 on the tensor cores, f32 on the CUDA
   cores) at tests/test_kernels.py's sweep, the unaligned Sq = 67 at
   head_dim 120 and GQA 4, a decode-offset case (kv_offset = 4096, window
   4096), head dims 20 and 128, Sq and Skv of 200 and 513, a query block
   that sees no key (all zeros), head dims 168 and 256, and phase 15's
   non-causal geometries at batch 1 (64/8 heads of 128, 8192 queries over
   1600 keys; 12/12 heads of 64, 1500 over 1500 and 224 over 1500), each
   in f32
   (atol 2e-5, rtol
   1e-4) and bf16 (one bf16 rounding, 1e-3 + 2^-7·|want|, plus the
   rounding of P to bf16 before P·V, 2^-8·(Σ p·|v|)/l from the plain
   version on |v|), and at the full-width prefill shape (4 x 32 query
   heads on 8 KV heads, 8192 tokens, head_dim 120, window 4096) in bf16,
   where two launches must give the same bits, and in f32, and at
   gemma3-27b's (4 x 32 query heads on 16 KV heads of 168, window 1024
   and global, bf16 twice bitwise; f32 windowed);
4. the quickstart path, with every launch count set to 0 first and the
   geometry of every launch logged: the quickstart session
   (N = 2,000,000, StatisticGroup(Mean, Quantile(0.5), Std)), a Mean()
   and a Median() session, a bootstrap of a user statistic without a
   fused path (the materialized poisson_counts route), and the one-shot
   bootstrap of the group at B=256, n=2^24-1000, all matrix-free
   (backend="fused_rng"); the quickstart session is run again on the CPU
   and must agree;
5. the k-means path (examples/analytics_kmeans.py, paper §6.3), again
   from zeroed counts with its geometries logged: Lloyd over N = 400,000
   rows (k=5, d=2, 8 iterations) and over a 2% PreMapSampler sample, the
   bootstrap certificate over KMeansStep at B=24, and one bootstrap at
   B=256 over n=2^22 rows whose peak memory must stay below an (n, k)
   f32 tensor; the example is run again on the CPU and must agree;
6. the GROUP BY path (README "GROUP BY"), from zeroed counts with its
   geometries logged: keyed Mean and median sessions over a
   StratifiedSampler of N = 2,000,000 rows [value, key] (G = 8, key g
   with frequency ∝ 2^-g), each run again on the CPU, which must agree,
   and a keyed Mean bootstrap at B=256, n=2^24-1000 whose peak memory
   must stay below an (n, G) f32 tensor; the earlier kernels' launches
   on phases 4 to 6 must equal EARLIER_LAUNCHES (and kernel 10's, and
   those of kernels 5 and 7, EARLIER_LATER_LAUNCHES);
7. the materialized path (the JAX package's default backend=None), from
   zeroed counts with its geometries logged: the quickstart group's
   session with no backend, on the card and the CPU, which must agree;
   bootstraps at B=256, n=2^20 over a 1 GiB weight matrix (Mean with
   kernel 11 against the cuBLAS product, within 1e-5·Σw|x|/Σw; Median
   through kernel 10 at R=256) with the Knuth draw's own time and peak;
   fig10's delta extends (B=32, 1.6M rows) and its multinomial baseline
   (B=16, 30,000 + 30,000 rows; the same resamples and counts on the
   CPU); fig3's shared-base bootstrap (B=64, 4,000 rows); the chunked
   bootstrap with both backends at n=2^22;
10. (run after phase 7) the streaming path, from zeroed counts with its
   geometries logged: examples/fault_tolerance.py parts 1 to 3 on the card
   (100,000 x 4 rows, B = 64, chunk 8,192: a kill after checkpoint 6 and
   its resume, transient faults under a RetryPolicy, a split lost for good
   under FailurePolicy(on_exhausted="degrade"), each bitwise its oracle),
   the same walk's Mean and Count on the CPU (w_tot bitwise, Mean within
   1e-5·Σw|x|/Σw); then a host store of 2^22 x 64 f32 rows (1 GiB, B =
   256, chunk 65,536): a streamed Mean (kernel 2 each chunk) and
   Quantile(block_bins=2048) (kernel 7 each chunk), each bitwise
   bootstrap_chunked over store.read_all() on the card, a kill and resume
   of the Quantile at checkpoint_every=8, one more Quantile run under
   torch.profiler (kernel 7's summed card time beside the wall and the
   stage: which sets the pace), kernel 5's entry point over the
   same chunks (bitwise the streamed Mean's state), and both runs again
   at 2^20 rows: the peak device memory above the resident state must not
   grow with n;
11. (run after phase 10) the serving path, from zeroed counts with its
   geometries logged: h2o-danube-3-4b at full width (24 layers, d_model
   3840, 32/8 heads of 120, d_ff 10240, vocab 32000 padded to 32768,
   window 4096; 3.84e9 f32 parameters from a seeded generator) serves 4
   requests of 8192-token synthetic_tokens prompts: prefill with room for
   32 greedy decode steps (kernel 12 exactly 24 times a prefill, never in
   decode), the prefill wall and decode tokens/s, a peak below one layer's
   (4, 32, 8192, 8192) f32 score tensor above the params; a few more
   decode steps on the host's clock and one under torch.profiler (the
   card's busy time and the casts' share) and the weight casts a step
   makes timed alone; decode equals
   teacher forcing (one forward over the prompts and decoded tokens)
   within 2e-2 of the largest logit; the model cut to one layer on the
   card and the CPU (1 x 256 tokens, 8 steps) gives logits within that
   tolerance and the same greedy tokens; EarlEval over 20,000 documents
   of 513 tokens (eval_batch 32, sigma 0.01) certifies from under half
   of them, and again at sigma 1.5e-4, below the pilot's cv, where it must
   grow the sample past its pilot, still certify from under half, give
   the plain mean of the losses its forwards returned, and take the B,
   rows and iterations of an EarlSession on the CPU fed those losses;
   then the repaired routing: a group (Mean,
   GroupedStatistic(Mean, 8), a custom statistic) at B = 256, n = 2^20 is
   bitwise its members' dedicated runs (the custom member's tiled scan
   also against its CPU run), and a keyed custom statistic at B = 256,
   n = 2^24 - 1000 peaks below one (B, n) f32 matrix;
12. (run after phase 11) gemma3-27b at full width (d_model 5376, 32/16
   heads of 168, d_ff 21504, vocab 262,144) cut to one 5:1 local:global
   pattern group (6 of its 62 layers: all 62 in f32 would be 113 GB of
   parameters; seeded f32 params), from zeroed counts with its geometries
   logged: the same 4 x 8192-token prefill and 32 decode steps, with
   phase 11's gates (kernel 12 once a layer in the prefill and never in
   decode, the peak above the params below one layer's f32 scores, decode
   == teacher forcing within 2e-2 of the largest logit) and card == CPU on
   the group cut to a local and a global layer (1 x 256 tokens, 8 steps,
   the CPU fed the card's greedy tokens, each within 2e-2 of the largest
   logit of the CPU's);
13. (run after phase 12) the live path, from zeroed counts with its
   geometries logged, every file under a temporary directory removed
   afterwards: the quickstart group's EarlSession over the quickstart's
   law at 2^24 rows (sigma 0.002, tau 0.001, key 0: B = 16, 4 rounds on
   the card) killed after its first save and resumed, bitwise the
   uninterrupted run (result, CI, cv, n_used, iterations, history);
   resumed after a completed run with no kernel launch after its restore;
   on the CPU with the card's B and its first round within 1e-3; and
   resumed on the CPU from the card's first snapshot, in the card's
   rounds.
   Then 2^24 f32 rows in 256 batches of 65,536 from a producer thread
   into an IngestLog(capacity=64), folded at B = 256 by a sliding
   window of the group (4 panes, kernel 4 once a fold) and the README's
   SlidingWindow(Var(), 131072, 32768) (every batch spans 2 panes, kernel
   2 twice a fold, a checkpoint every 8 folds): launches a fold equal the
   panes a batch spans, the ring never holds more than its panes nor more
   device bytes than panes x one pane's; a cumulative Mean session is
   bitwise bootstrap_streaming(chunk=65,536); a delivery with duplicates
   and reorder (FaultyStore.delivery_plan) is bitwise in-order delivery;
   the Var session killed after fold 101 (its last snapshot at fold 96)
   and resumed is bitwise the uninterrupted run; a backlogged poll that
   sheds is bitwise the oracle fold of the same masks; a lost batch that
   arrives late at a lone median (kernel 3) folds (p_eff back to 1) or is
   dropped and counted; the
   first 16 batches at B = 8 on the card and the CPU: w_tot and histogram
   counts bitwise, s1 within 1e-5·Σw|x|, s2 within 1e-5·Σw·x².  The same
   batches through DurableIngestLog under fsync never, batch and always
   (the same segment bytes; append MB/s), the recovery scan's s/GB, a
   mode="tail" consumer folding Mean() against a producer thread (bitwise
   the in-memory log's session), and the last segment torn at a header,
   a record-frame, a payload and a footer byte (each recovery bitwise the
   in-memory log of the surviving batches);
14. (run after phase 13) the mesh path, from zeroed counts: in this
   process, with its geometries logged, a world of one NCCL rank
   (DeviceMesh("cuda", [0]), destroyed at the end of the phase), where
   sharded_fused_states(mesh=) at B = 256, n = 2^24 - 1000 is bitwise
   fused_resample_states for Mean and Var (kernel 2), Median (kernel 3),
   the quickstart group (kernel 4), GroupedStatistic(Mean(), 8) (kernel
   6) and KMeansStep at k = 5, d = 2 (kernel 8), each of which must
   launch; EarlSession(mesh=) on phase 13's law bitwise the session
   without a mesh (walls side by side); DistributedEarl(backend=
   "fused_rng") under failure_mask(n, 16, [0, 3, 7]) bitwise the fused
   path under that valid_mask; the materialized DistributedEarl at B =
   64, n = 2^20 bitwise its weights' update_batch, and those weights
   the CPU's _poisson_for_shard (drawn in a thread from the phase's
   start and held last: bitwise but for entries whose running log sum
   lies within an ulp of -1, where CUDA's and the host's f32 log may
   part; each such entry is replayed with both logs and counted).  Then a
   world of 4 gloo ranks on the one card (fresh
   interpreters of this script, --mesh-rank R; each with a timeout, any
   nonzero exit fails): on every rank the six families, their chunks of
   2^20 rows (with the estimate state) and a PoissonDelta's two extends
   bitwise sharded_fused_states(nshards=4) computed here (outside the
   geometry log); the group's
   session over the same law with key 1 bitwise across ranks, iterating,
   within 2% of the exact answers; the elastic reduce (shard 1 lost,
   shard 3 past its deadline) bitwise estimate_with_loss_mask at
   p_surviving = 0.5.  Prints psum_state's ms a call at world 1 (NCCL)
   and 4 (gloo, through pinned host memory), the spawn-to-join s and the
   phase's s beside the card's name and power limit;
15. (run after phase 14) the cross-attention serving path, from zeroed
   counts with its geometries logged: llama-3.2-vision-90b at its
   published widths (d_model 8192, 64/8 heads of 128, d_ff 28672, vocab
   128,256 padded to 129,024) cut to one ("full" x 4, "xattn") pattern
   group (5 of its 100 layers: all 100 in f32 would be about 358 GB),
   4 x 8192-token prompts each with 1600 stub image embeddings, then
   whisper-small whole (12 encoder and 12 decoder layers, d_model 768,
   12/12 heads of 64, vocab 51,865), 16 clips of 1500 stub frame
   embeddings with 224-token prompts; seeded f32 params with every
   cross-attention gate drawn from uniform [0.5, 1.0) (printed), 32
   greedy decode steps; phase 11's gates, generalised: kernel 12 once a
   self-attention, a cross-attention and an encoder layer in the prefill
   (6 and 36) and never in decode, the peak above the params below one
   layer's f32 scores plus the cross caches and enc_out, the parameter
   count the config's plus the leaves its num_params leaves out; the same
   prefill with every gate at zero moves the logits past the tolerance;
   decode == teacher forcing; card == CPU on llama's xattn layer and on
   the whole whisper model (one request, the CPU fed the card's tokens);
16. (run after phase 15) the MoE serving path, from zeroed counts with
   its geometries logged: mixtral-8x22b at its published widths (d_model
   6144, 48/8 heads of 128, window 4096, 8 experts top-2 of d_ff 16384,
   vocab 32,768) cut to 2 of its 56 layers in f32, then arctic-480b
   (d_model 7168, 56/8 heads of 128, 128 experts top-2 of d_ff 4864 beside
   a dense residual MLP, vocab 32,000) cut to 1 of its 35 layers in bf16,
   each SERVE_B x SERVE_PROMPT prompts and SERVE_GEN greedy steps at the
   published capacity factor 1.25 (the token-slots dropped in the prefill
   and in each decode step printed); phase 11's gates, with the peak
   against prefill_live_bytes extended by moe_live_bytes; swapping two
   experts' weights (not the router's) where a last token keeps a slot
   must move the prefill's logits past the tolerance; decode == teacher
   forcing at the capacity factor E/k (nothing drops) on 1 x 256 tokens,
   and card == CPU on the first layer (the CPU fed the card's tokens, its
   expert products a chunk of experts at a time), each with the routing
   held first (router probabilities within 2e-2 of a token's largest, a
   differing choice only at a near tie, near ties within 1e-3 counted),
   then the MoE outputs at the agreeing tokens and the logits before the
   first differing one; on mixtral's first layer, moe_ffn_shard_map in a
   world of one NCCL rank (one-way data and model axes) bitwise moe_ffn;
17. (run after phase 16) the recurrent serving path, from zeroed counts
   with its geometries logged: recurrentgemma-2b whole (26 layers, 8 x
   (rglru, rglru, local) and 2 rglru; d_model 2560, RG-LRU width 2560,
   10/1 heads of 256, window 2048; 2.894e9 f32 params), then xlstm-350m
   whole (24 layers, 12 x (slstm, mlstm); d_model 1024, 4 heads of 256;
   1.784e8), each SERVE_B x SERVE_PROMPT prompts, bf16 compute and
   SERVE_GEN greedy steps; phase 11's gates with the parameter count the
   config's plus the signed recurrent terms its num_params miscounts,
   kernel 12 8 and 0 times a prefill (once a local layer) and never in
   decode, the peak below prefill_live_bytes with recurrent_live_bytes;
   every recurrent state knocked out between the prefill and the first
   decode step (zeros, the stabilizers at -1e30) must move that step's
   logits past the tolerance; decode == teacher forcing (1 x 256 tokens,
   32 steps) and card == CPU on recurrentgemma-2b's first pattern group
   and on the whole xlstm-350m (1 x 256 tokens, the CPU fed the card's
   tokens), both held in f32 compute on the served params and printed in
   bf16, where the recurrences carry every step's roundings (the served
   4 x 8192 run's decode against teacher forcing too); then each
   recurrent cell alone over the served shape (its prefill wall; the
   sLSTM's device kernels a step) and one decode step's device kernels;
   and kernel 12's f32 route at the f32 checks' geometry on the replay's
   unit-normal data at scale 1 against its plain version and both against
   f64 (printed: there the plain version's own error passes the replay's
   f32 tolerance, so phase 17 hands phase 8 its bf16 geometries only);
18. (run after phase 17) the training path, from zeroed counts with its
   geometries logged: granite-3-2b whole (40 layers, 2.5e9 f32 params,
   f32 AdamW states, bf16 compute) on 4 x 4096 tokens (train_4k's global
   batch of 256 cut to 4): leg 1, three make_train_step steps and one
   adaptive step (4 microbatches through make_grad_step,
   earl_accumulate_gradients and adamw_update), kernel 12 twice a layer
   (the forward and remat's recompute) and its backward once a layer in
   every step and microbatch, each backward on the tensor cores
   (``tc_launches``), no plain version run, every leaf's
   gradient finite and non-zero, the accumulated mean bitwise the mean
   of the used microbatches' gradients (on a few leaves), the peak below
   the reckoning (train_reckoning); the adaptive step under
   torch.profiler (busy share) with the f32 backward products timed on
   CUDA events; card == CPU on the first layer (1 x 512 tokens, bf16 and
   f32 compute; gradients within 2e-2 of each leaf's largest, loss and
   grad_norm within 2e-2, and the step's AdamW update on the card's
   gradients within four ulps of the CPU's); five steps on one repeated batch
   lower the loss (4 layers); leg 2, launch/train.main at 4 layers with
   --adaptive-accum, --eval-every and --ckpt-every, and a run stopped
   after one step and resumed (losses within f32 rounding, cursor and
   step bitwise, checkpoint seconds and bytes printed); the embedding's
   backward twice, bitwise or not, with and without
   torch.use_deterministic_algorithms; leg 3, the two families whose heads
   pass 128 at their published widths, only depth and batch cut
   (wide_plan; the peak reckoned by train_reckoning with the chunked
   CE's terms under 70e9 bytes first, and measured under the
   reckoning): gemma3-27b's
   first 2 layers (both local, head dim 168) at 1 x 4096 tokens and
   recurrentgemma-2b's first pattern group (rglru, rglru, local, head dim
   256) at 4 x 4096, two make_train_step steps each, kernel 12 twice a
   local layer of a pattern group (the forward and remat's recompute) and
   once a remainder layer, its backward once a local layer, each on the
   tensor cores, no plain version run, the losses finite; a grad step
   under torch.profiler (every gradient finite and non-zero; busy share,
   the backward kernel's and the f32 backward products' ms), the peak
   at or under the reckoning; on the initial params' slice that holds
   the first attention layer, in bf16 the kernel against the backward's
   plain version on the card (within 2e-2 of each leaf's largest
   gradient) and card == CPU (2e-2; 5e-2 through recurrentgemma-2b's
   RG-LRU), and for recurrentgemma-2b card == CPU in f32 (2e-2), the CPU
   halves in a thread beside phase 8's replay; then
   kernel 12's backward against
   its plain version at the slice's geometry in bf16 and f32, at the
   other models' train-mode geometries (BWD_CASES), on a query block
   that sees no key and with kv_offset > 0, and against autograd
   through ref.mha_reference in f64 (each dq, dk, dv entry within
   1e-5·Σ|terms|, bf16 also 2^-7·|want|, and on the tensor-core route,
   bf16 at every D, also 2^-8·Σ|terms| for P and dS rounded to bf16;
   the route checked on every call; two launches bitwise);
19. (run after phase 18) the sharded path: granite-3-2b at full width cut
   to 4 of its 40 layers (0.348e9 f32 params, bf16 compute), its state
   placed by launch/sharding.distribute_tree on a DeviceMesh (data,
   model).  A world of one NCCL rank in this process (mesh 1 x 1, from
   zeroed counts with its geometries logged, destroyed at the end): two
   make_train_step steps of 4 x 4096 tokens under TRAIN_RULES bitwise the
   unsharded steps (loss and metrics of each, every leaf of params, m and
   v after them), a prefill and 8 decode steps (teacher tokens) under
   SERVE_RULES bitwise the unsharded logits, kernel 12 20 times and its
   backward 8 times through the sharded path, each step's wall beside the
   unsharded one's and its collectives.  Then a world of 4 gloo ranks on
   the card (fresh interpreters of this script, --shard-rank R; mesh 2 x
   2 under TRAIN_RULES and SERVE_RULES without the FSDP split of "embed",
   whose all-gather gloo's functional collectives cannot run on CUDA
   tensors): a prefill and 4 decode steps within 2e-2 of max |logit| of
   the unsharded steps run here meanwhile, one train step's gradients
   within phase 18's card == CPU law and its update within four ulps of
   adamw_update of those gradients, each rank's shapes resolve_spec's
   and kernel 12 and its backward on its 16 query and 4 kv heads; its
   collectives by kind with bytes (CommDebugMode and
   launch/hlo_analysis.CollectiveBytes, which must agree), step wall and
   spawn-to-join s; then the flash-decoding layout in the same world:
   h2o-danube-3-4b at full width cut to 4 layers, an unsharded prefill of
   1 x 8192 tokens (kernel 12) on each rank, its cache and the params
   placed by SERVE_RULES with the FSDP split of "embed" kept (the ring's
   slots and d over data) and 8 teacher-forced decode steps within 2e-2
   of max |logit| of the unsharded decode run here, each step's
   collectives by kind (all-reduces only: no all-gather) and a step's
   dot FLOPs a rank beside one step in the layout without the split;
   then the gspmd MoE in the same world: mixtral-8x22b at full width cut
   to 1 of its 56 layers (f32 params, bf16 compute, capacity 1.25), one
   prompt of 4096 Zipf tokens prefilled under SERVE_RULES with "embed"
   kept (each rank initialising the whole params in turn, then keeping
   its shards), within 2e-2 of max |logit| of the unsharded prefill run
   here, the MoE layer's kept slots bitwise the unsharded route of its
   own input (gathered here) and its routing held against the unsharded
   prefill's by phase 16's card == CPU law, its dropped slots,
   collectives (all-reduces and all-to-alls) and seconds;
20. (run after phase 19) the dry run and the last modules: the fake
   (FakeTensorMode, a "fake" process group) train step of phase 19's
   world of one counts the real step's dot FLOPs exactly, the fake 2 x 2
   train step and flash-decoding step issue the real world of 4's
   collectives by kind with their bytes exactly (the flash step also its
   dot FLOPs), both the same on "cuda"
   and "cpu" fake tensors in every FLOP, byte and collective field; two
   production cells' records (launch/dryrun.lower_cell on the card);
   configs/earl_analytics.CONFIG's Mean, Median and group sessions
   (kernels 2, 3, 4) and its k-means with a KMeansStep bootstrap (kernels
   9, 8), PostMapSampler's rows bitwise PreMapSampler's on the card; then
   kernel 12's host time a call through its operators and the direct
   launches (not counted);
8. replay every distinct launch geometry that phases 4 to 7 and 10 to 20
   logged on fresh data and hold it against the plain version as in
   phase 3 (kernel 12's forward also with lse written: the same bits,
   and lse the plain version's; its backward as in phase 18), printing
   each geometry's seconds, the longest first, while phase 18's leg 3 CPU
   halves of card == CPU run in a thread beside it;
9. time each kernel (CUDA events) beside its plain version, its bound
   and, for the explicit-weight kernels, one PyTorch call computing the
   same function; the sessions' wall times and the example's walls over a
   few warm runs, and the grouped moments kernel against G masked
   moments launches; kernel 5 beside kernel 2 and kernel 7 at the streamed
   Quantile's chunk shape, with kernel 7's cost terms (weights hashed and
   draws a weight, shared adds, bin_index evaluations, flush operations,
   bytes of x, of counts and of distributed shared memory); kernels 1 to
   11 and the keyed histogram also alone (launches back to back inside
   one wrapper call; kernel 8 also at the example's B = 24, n = 8,000),
   with the cost terms of kernels 3 and 4 and of the keyed histogram
   (weights hashed, which must be B·n, or B times the keyed columns;
   shared adds, bin_index evaluations, flush reads and global adds;
   keyed, the bytes of keys and index entries read) and of kernels 6 and
   8 (weights hashed, from the columns each key or cluster chunk holds in
   this run's data; shared read-add-writes; ptxas's registers and CTAs an
   SM), printed beside their times and kept out of the kernels line,
   and kernel 10 at the point estimate (R = 1, unit weights); kernel 12
   at the serving prefill's shape
   beside its plain version, its bound (4·D operations a visible
   query-key pair at the bf16 tensor-core rate, or q, k, v and o once
   over the memory rate), scaled_dot_product_attention with the boolean
   causal-window mask (bf16, and f32 on the memory-efficient backend) and
   its own f32 route, and at gemma3-27b's local and global layers and
   recurrentgemma-2b's local layers (D = 168 and 256) in bf16 and f32,
   and at phase 15's three non-causal geometries (llama's
   cross-attention, whisper's encoder and cross-attention) alone, with
   their bounds and one unmasked bf16 scaled_dot_product_attention call
   each, and at phase 16's causal prefill geometries (mixtral's 48/8
   heads with window 4096, arctic's 56/8 full causal) alone, through the
   wrapper and in f32, beside their bounds and one masked bf16
   scaled_dot_product_attention call each; kernel 12's backward at the
   slice's geometry alone (the tensor-core route), its share of its
   bound (10·D operations a visible pair), beside its plain version, its
   f32 route and scaled_dot_product_attention forward plus backward less
   its forward (boolean causal mask, and is_causal), and past head dim 128
   at gemma3-27b's local and global layers and recurrentgemma-2b's local
   layers (BWD_WIDE_TIMED) alone, beside its plain version, its bound,
   the masked scaled_dot_product_attention's backward and its launches in
   phase 18's leg 3; then print the kernels line, then the contract's
   last line.

Every plain version that a kernel is held against or timed beside runs
under a check that it launches no kernel.

Exit code 2: no card, or no port beside this script.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# Published H100 SXM rates (NVIDIA data sheet, 700 W): HBM3 bytes/s, and
# 32-bit integer operations/s: the 67 TFLOP/s f32 rate counts an FMA as two
# operations on 128 lanes per SM; an SM has 64 INT32 lanes, so a quarter.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# 32-bit integer operations per implicit weight; the count and its
# breakdown are in src/repro_torch/kernels/csrc/poisson_tile.cuh.
OPS_PER_WEIGHT = 73
# Published H100 SXM f32 rate outside the tensor cores (an FMA is two).
F32_FLOPS_PER_S = 67e12

REPLACES = {
    "poisson_counts": "src/repro/kernels/poisson_counts/kernel.py:63",
    "fused_poisson_moments": "src/repro/kernels/weighted_stats/kernel.py:173",
    "fused_poisson_hist": "src/repro/kernels/weighted_hist/kernel.py:253",
    "fused_poisson_multi": "src/repro/kernels/fused_multi/kernel.py:107",
    "kmeans_assign": "src/repro/kernels/kmeans_assign/kernel.py:93",
    "fused_poisson_kmeans": "src/repro/kernels/kmeans_assign/kernel.py:170",
    "fused_poisson_moments_grouped":
        "src/repro/kernels/weighted_stats/kernel.py:275",
    # no TPU kernel: the reference's keyed sketch is its scan lowering
    "fused_poisson_hist_grouped": "src/repro/kernels/weighted_hist/ops.py:107",
    "weighted_moments": "src/repro/kernels/weighted_stats/kernel.py:67",
    "weighted_histogram": "src/repro/kernels/weighted_hist/kernel.py:73",
    "fused_poisson_moments_stream":
        "src/repro/kernels/weighted_stats/kernel.py:406",
    "fused_poisson_hist_binblocked":
        "src/repro/kernels/weighted_hist/kernel.py:195",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:81",
    # no TPU kernel: XLA differentiates the reference's blockwise path
    "flash_attention_bwd": "src/repro/kernels/flash_attention/ops.py:43",
}
SOURCES = {
    "poisson_counts": "src/repro_torch/kernels/csrc/poisson_counts.cu",
    "fused_poisson_moments": "src/repro_torch/kernels/csrc/fused_pass.cu",
    "fused_poisson_hist": "src/repro_torch/kernels/csrc/fused_pass.cu",
    "fused_poisson_multi": "src/repro_torch/kernels/csrc/fused_pass.cu",
    "kmeans_assign": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
    "fused_poisson_kmeans": "src/repro_torch/kernels/csrc/fused_kmeans.cu",
    "fused_poisson_moments_grouped":
        "src/repro_torch/kernels/csrc/fused_grouped.cu",
    "fused_poisson_hist_grouped":
        "src/repro_torch/kernels/csrc/fused_grouped.cu",
    "weighted_moments": "src/repro_torch/kernels/csrc/weighted_moments.cu",
    "weighted_histogram": "src/repro_torch/kernels/csrc/weighted_hist.cu",
    "fused_poisson_moments_stream":
        "src/repro_torch/kernels/csrc/fused_stream.cu",
    "fused_poisson_hist_binblocked":
        "src/repro_torch/kernels/csrc/fused_binblocked.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
}
#: the kernels each main path must launch
QUICKSTART_KERNELS = ("poisson_counts", "fused_poisson_moments",
                      "fused_poisson_hist", "fused_poisson_multi")
KMEANS_KERNELS = ("kmeans_assign", "fused_poisson_kmeans")
GROUPBY_KERNELS = ("fused_poisson_moments_grouped",
                   "fused_poisson_hist_grouped")
MATERIALIZED_KERNELS = ("weighted_moments", "weighted_histogram")
STREAM_KERNELS = ("fused_poisson_moments", "fused_poisson_hist_binblocked",
                  "fused_poisson_moments_stream", "weighted_histogram")
#: the serving path's kernel, and the repaired routing's (a group with a
#: keyed and a custom member; a keyed custom statistic's tiled scan)
SERVE_KERNELS = ("flash_attention",)
ROUTING_KERNELS = ("poisson_counts", "fused_poisson_multi",
                   "fused_poisson_moments_grouped")
#: launches of the earlier kernels on the quickstart, k-means and GROUP BY
#: paths together in the run that ported the GROUP BY slice: a call that
#: lost its explicit backend="fused_rng" would change them
EARLIER_LAUNCHES = {"poisson_counts": 1, "fused_poisson_moments": 7,
                    "fused_poisson_hist": 7, "fused_poisson_multi": 8,
                    "kmeans_assign": 18, "fused_poisson_kmeans": 2,
                    "fused_poisson_moments_grouped": 8,
                    "fused_poisson_hist_grouped": 7}
#: the other kernels' launches on those three paths, and the materialized
#: path's launches, in the run that ported the materialized engines
EARLIER_LATER_LAUNCHES = {"weighted_moments": 0, "weighted_histogram": 111,
                          "fused_poisson_moments_stream": 0,
                          "fused_poisson_hist_binblocked": 0}
MATERIALIZED_LAUNCHES = {"fused_poisson_multi": 64, "weighted_moments": 1,
                         "weighted_histogram": 295}
NBINS, LO, HI = 2048, 0.0, 25.0
QUICKSTART_N = 2_000_000
BIG_B, BIG_N = 256, (1 << 20) + 37
BOOT_N = (1 << 24) - 1000
SESSION_REPS = 5
# examples/analytics_kmeans.py: N rows of k 2-d blobs, ITERS Lloyd steps,
# a 2% sample and B resamples; the wide (k, d) takes the fused kernel past
# one register chunk (16 entries of k·(d+1)+1).
KM_N, KM_K, KM_ITERS, KM_B = 400_000, 5, 8, 24
KM_SAMPLE = KM_N // 50
KM_WIDE = (16, 8)
KM_BOOT_N = 1 << 22
# the GROUP BY path: N rows [value, key] over G keys; the grouped kernel
# against G masked launches at the reference benchmark's shape
GB_N, GB_G = 2_000_000, 8
GB_RATIO_SHAPE = dict(B=256, n=65_536, d=4)
# the materialized path: bootstraps over a (B, n) weight matrix of 1 GiB;
# fig10's delta extends (B = 32, 1.6M rows) and its multinomial baseline
# (B = 16, 30,000 + 30,000 rows); fig3's shared-base bootstrap (B = 64,
# 4,000 rows); the chunked bootstrap at n = 2^22
MAT_B, MAT_N = 256, 1 << 20
FIG10_B, FIG10_N = 32, 1_600_000
MDB_B, MDB_ROWS = 16, 30_000
SB_B, SB_N = 64, 4_000
CHUNK_B, CHUNK_N, CHUNK = 64, 1 << 22, 65_536
# the streaming path: examples/fault_tolerance.py's store (100,000 x 4
# rows, splits of 4,096, B = 64, chunks of 8,192), then the README's
# 64-column store at 2^22 rows (1 GiB of f32 on the host) and at 2^20, B =
# 256, chunks of 65,536, a median of each column over 2,048 bins in
# windows of 2,048 (kernel 7)
FT_N, FT_D, FT_SPLIT, FT_B, FT_CHUNK = 100_000, 4, 4096, 64, 8192
ST_NS, ST_D, ST_SPLIT, ST_B, ST_CHUNK = (1 << 22, 1 << 20), 64, 65_536, \
    256, 65_536
ST_LO, ST_HI, ST_CKPT_EVERY, ST_KILL_AFTER = -6.0, 6.0, 8, 3
# kernel 7's parity: n for d = 64 (the others run at BIG_N) and the keyed
# case's G, d (65,536 bins a row); a keyed d past the keyed histogram's
# limit (32 · 2,048 bins a key's row)
K7_WIDE_N, K7_G, K7_GD, K7_PAST_D = (1 << 16) + 37, 8, 4, 32
# the serving path (phase 11): h2o-danube-3-4b at full width, 4 requests
# of 8192-token prompts (two windows) and 32 greedy decode steps; card ==
# CPU on the model cut to one layer (1 x 256 tokens, 8 steps); EarlEval
# over 20,000 documents of 513 tokens in batches of 32 at sigma 0.01
SERVE_ARCH, SERVE_SEED = "h2o-danube-3-4b", 16
SERVE_B, SERVE_PROMPT, SERVE_GEN = 4, 8192, 32
CPU_PROMPT, CPU_GEN = 256, 8
EVAL_DOCS, EVAL_DOC_LEN, EVAL_BATCH, EVAL_SIGMA, EVAL_TAU = \
    20_000, 513, 32, 0.01, 0.05
# a second EarlEval below the pilot's cv (about 4.7e-4 at these random
# weights), so the session grows the sample past its pilot
EVAL_SIGMA_GROW = 1.5e-4
# decode steps timed on the host's clock before the profiled one
PROFILE_STEPS = 4
# kernel 12's timing shape: the serving prefill's (B·Hq, S, D), Hkv, W
FA_B, FA_HQ, FA_HKV, FA_S, FA_D, FA_W = 4, 32, 8, 8192, 120, 4096
# gemma3-27b served at full width (phase 12): one 5:1 local:global pattern
# group of its 62 layers (in f32 all 62 would be 113 GB of parameters),
# 32/16 heads of 168, window 1024, the same 4 x 8192-token prompts and
# 32 decode steps; card == CPU on the group cut to its fifth (local) and
# sixth (global) layers
GEMMA_ARCH, GEMMA_SEED, GEMMA_LAYERS = "gemma3-27b", 27, 6
GEMMA_HQ, GEMMA_HKV, GEMMA_D, GEMMA_W = 32, 16, 168, 1024
# kernel 12 past head dim 128 at recurrentgemma-2b's local layers (10
# query heads on 1 KV head of 256, window 2048) at the prefill's B and S
RG_HQ, RG_HKV, RG_D, RG_W = 10, 1, 256, 2048
# cross-attention serving (phase 15): llama-3.2-vision-90b at its published
# widths cut to one ("full" x 4, "xattn") pattern group (5 of its 100
# layers: all 100 in f32 would be about 358 GB of parameters), SERVE_B
# requests of SERVE_PROMPT tokens, each with its 1600 stub image
# embeddings; whisper-small whole (12 encoder and 12 decoder layers), 16
# clips of 30 s (1500 stub frame embeddings each) with 224-token prompts
# (half its 448-token text context); both SERVE_GEN greedy decode steps,
# every cross-attention gate drawn from uniform [GATE_LO, GATE_HI) (the
# init law's zero gate would make the cross-attention add nothing).
# llama's stub image embeddings are normal with std VLM_AUX_STD: at std 1
# its one cross-attention's softmax over 1600 keys is near uniform, its
# output averages to about 1% of the residual, and zeroing the gate moved
# the prefill's logits by 0.059, under the 0.092 tolerance of the logit
# checks, which could then not see the cross-attention at all (whisper's
# twelve, over its encoder's normed output, move them by far more)
VLM_ARCH, VLM_SEED, VLM_LAYERS, VLM_AUX_STD = \
    "llama-3.2-vision-90b", 90, 5, 2.0
WHISPER_ARCH, WHISPER_SEED, WHISPER_B, WHISPER_PROMPT = \
    "whisper-small", 30, 16, 224
GATE_LO, GATE_HI = 0.5, 1.0
#: kernel 12's non-causal geometries of phase 15, timed in phase 9:
#: (name, B, Hq, Hkv, Sq, Skv, D)
XA_TIMED = (("llama_cross_attention", 4, 64, 8, 8192, 1600, 128),
            ("whisper_encoder", 16, 12, 12, 1500, 1500, 64),
            ("whisper_cross_attention", 16, 12, 12, 224, 1500, 64))
# the MoE serving path (phase 16): mixtral-8x22b at its published widths
# (d_model 6144, 48/8 heads of 128, window 4096, 8 experts top-2 of d_ff
# 16384) cut to 2 of its 56 layers in f32 (all 56 would be about 562 GB),
# and arctic-480b (d_model 7168, 56/8 heads of 128, 128 experts top-2 of
# d_ff 4864 beside a dense residual MLP) cut to 1 of its 35 layers in
# bf16 (all 35 would be about 953 GB); SERVE_B requests of SERVE_PROMPT
# tokens and SERVE_GEN greedy steps at the published capacity factor
# 1.25, which drops slots.  Decode == teacher forcing runs at the
# capacity factor E/k, where the capacity C is the token count and
# nothing drops (decode routes B tokens, the forward B·S, so at 1.25 they
# drop different slots), on 1 x CPU_PROMPT tokens.
MIXTRAL_ARCH, MIXTRAL_SEED, MIXTRAL_LAYERS = "mixtral-8x22b", 22, 2
ARCTIC_ARCH, ARCTIC_SEED, ARCTIC_LAYERS = "arctic-480b", 480, 1
#: a near tie: a token's k-th and (k+1)-th router probabilities within
#: this share of the k-th (counted and printed)
NEAR_TIE = 1e-3
#: router probabilities on the card against the CPU (or decode against
#: teacher forcing), each token's within this share of its largest (the
#: bf16 rule of logits_tolerance); a token may then choose another expert
#: only where its k-th and (k+1)-th lie within twice that of each other
ROUTER_TOL = 2e-2
#: kernel 12's causal geometries of phase 16, timed in phase 9:
#: (name, Hq, Hkv, D, window) at SERVE_B x SERVE_PROMPT
MOE_FA_TIMED = (("mixtral", 48, 8, 128, 4096), ("arctic", 56, 8, 128, None))
# the recurrent serving path (phase 17): recurrentgemma-2b whole (26
# layers: 8 x (rglru, rglru, local) and 2 rglru; d_model 2560, RG-LRU
# width 2560, 10/1 heads of 256, window 2048, d_ff 7680, vocab 256,000)
# and xlstm-350m whole (24 layers: 12 x (slstm, mlstm); d_model 1024, 4
# heads of 256, mlstm_chunk 256, no MLP, vocab 50,304), SERVE_B x
# SERVE_PROMPT prompts and SERVE_GEN greedy steps each, in bf16; card ==
# CPU on each model's first pattern group
RG_ARCH, RG_SEED = "recurrentgemma-2b", 26
XL_ARCH, XL_SEED = "xlstm-350m", 350
#: the recurrent block kinds (models/config.py's RECURRENT_KINDS)
RECURRENT = ("rglru", "mlstm", "slstm")
#: decode == teacher forcing of a model with recurrent cells in bf16, as a
#: share of max |logit|: whole, 26 and 24 layers deep, bf16 moves these
#: logits further than the attention models' 2e-2 (the served run itself
#: holds the reading below bf16's own distance from the f32 teacher
#: forcing on the same tokens)
RECURRENT_LOGIT_SHARE = 5e-2
#: the two prompt lengths the sLSTM's device kernels are counted at
#: (torch.profiler); their difference over the added tokens is a step's
#: (64 steps apart, so a few stray device events barely move the count)
STEP_COUNT_S = (16, 80)
# dense bf16 tensor-core rate of the H100 SXM (NVIDIA data sheet, 700 W)
BF16_FLOPS_PER_S = 989e12
# the training path (phase 18): granite-3-2b whole (40 layers, d_model
# 2048, 32/8 heads of 64, d_ff 8192, vocab 49,155 padded to 51,200; f32
# params and AdamW states, bf16 compute) at the JAX package's train_4k
# sequence length, 4,096, with its global batch of 256 cut to TRAIN_B = 4
# to fit one card: TRAIN_STEPS train steps, then one adaptive step of
# TRAIN_MICRO microbatches; card == CPU on its first layer at 1 x
# TRAIN_CPU_S tokens within TRAIN_CPU_SHARE of each leaf's largest entry
# (the serving law); TRAIN_FALL_STEPS steps on one repeated batch and leg
# 2 (launch/train.main) at granite's full width cut to LEG2_LAYERS layers,
# LEG2_STEPS steps of LEG2_MICRO microbatches
TRAIN_ARCH, TRAIN_SEED = "granite-3-2b", 18
TRAIN_B, TRAIN_S, TRAIN_DOCS = 4, 4096, 64
TRAIN_STEPS, TRAIN_MICRO = 3, 4
TRAIN_CPU_S, TRAIN_CPU_SHARE = 512, 2e-2
TRAIN_FALL_STEPS = 5
LEG2_LAYERS, LEG2_STEPS, LEG2_MICRO = 4, 2, 2
# phase 18's wide-head leg (leg 3): the two families whose heads pass 128
# trained at their published widths, only the depth and the batch cut:
# gemma3-27b (head dim 168, 32/16 heads, window 1024) cut to its first
# WIDE_GEMMA_LAYERS layers, both local (no pattern group: the remainder
# layers run outside remat, in the JAX package too), at WIDE_GEMMA_B x
# TRAIN_S tokens; recurrentgemma-2b (head dim 256, 10/1 heads, window
# 2048) cut to one pattern group (rglru, rglru, local) at WIDE_RG_B x
# TRAIN_S; WIDE_STEPS make_train_step steps each, the peak reckoned by
# train_reckoning with the chunked CE's terms (``chunked_ce``: what the CE
# keeps at a 256,000-wide vocabulary and more) under WIDE_PEAK_LIMIT bytes
# before the run and held at or under that reckoning on the card
WIDE_GEMMA_LAYERS, WIDE_GEMMA_B = 2, 1
WIDE_RG_LAYERS, WIDE_RG_B = 3, 4
WIDE_STEPS, WIDE_PEAK_LIMIT = 2, 70e9
#: leg 3's card == CPU (1 x TRAIN_CPU_S tokens, the initial params' slice
#: holding the first attention layer): every model in bf16 compute (the
#: leg's, through the backward's wide tensor-core route) with the kernel
#: within TRAIN_CPU_SHARE of each leaf's largest gradient of the same step
#: on the card with the backward's plain version in its place, and within
#: TRAIN_CPU_SHARE of the CPU's, but a model with recurrent cells within
#: WIDE_RECURRENT_SHARE of the CPU's there, and in f32 compute within
#: TRAIN_CPU_SHARE: through recurrentgemma-2b's RG-LRU the bf16 gradients
#: of card and CPU read 0.018-0.027 of a leaf's largest over four seeds,
#: and 0.018-0.023 with the plain version on the card in place of the
#: kernel (the worst leaves the cells' own; PERF.md §6)
WIDE_RECURRENT_SHARE = 5e-2
# the repaired routing: a keyed custom statistic's tiled scan at the
# one-shot bootstrap's size, and a group with keyed and custom members
ROUTE_G, ROUTE_GROUP_N = 8, 1 << 20
# the live path (phase 13): the quickstart group's session over the
# quickstart's law at 2^24 rows, sigma 0.002 and the quickstart's key 0,
# with tau 0.001: the default tau (0.01) is wider than the pilot's cv
# (about 0.008), so SSABE's phase A would stop at B = 4; at 0.001 it picks
# B = 16 and the session grows its sample over several rounds: 4, to
# 246,808 rows, on an H100; 3 on the CPU, whose first target is a row
# larger. On 2M rows B * n >= N sends it to the exact job, or it meets
# sigma in one round and leaves nothing to resume. Killed after its first
# save;
# 2^24 f32 rows (64 MiB) in 256 batches of 65,536
# from a producer thread into an IngestLog(capacity=64), folded at B = 256
# by session A (the group in 4 panes of 2^20 rows) and session B (the
# README's SlidingWindow(Var(), 131072, 32768): every batch spans 2 panes,
# a checkpoint every 8 folds, killed after fold 101); a backlogged poll of
# 32 batches that sheds; 24 batches with one lost, folded by a lone
# median (kernel 3); the first 16 batches on
# the CPU at B = 8 (the plain versions draw about 4.5e6 weights/s on the
# host, so B = 256 would take minutes); the same batches through the
# durable log
RESUME_N, RESUME_SIGMA, RESUME_TAU, RESUME_KEY = 1 << 24, 0.002, 0.001, 0
# SSABE's first target is a fitted real number of rows, which the card's
# f32 sums move by a row or so against the CPU's; a row more or less
# re-tiles every later resample weight, so the CPU's own run is held to
# the card's B and first target within RESUME_ROWS_RTOL, and the CPU
# resumed from the card's first snapshot to the card's rounds exactly
RESUME_ROWS_RTOL = 1e-3
LIVE_N, LIVE_BATCH, LIVE_B, LIVE_CAPACITY, LIVE_SEED = \
    1 << 24, 1 << 16, 256, 64, 13
LIVE_A, LIVE_B_WIN = (1 << 22, 1 << 20), (131_072, 32_768)
LIVE_CKPT_EVERY, LIVE_KILL_AT = 8, 101
LIVE_SHED_BATCHES, LIVE_LATE_BATCHES, LIVE_LOST = 32, 24, 5
LIVE_CPU_BATCHES, LIVE_CPU_B = 16, 8
#: the kernels the live path's main runs (the uninterrupted session and the
#: A/B drain) launch; kernel 3 runs in the late gate's lone median
LIVE_KERNELS = ("fused_poisson_moments", "fused_poisson_multi")
# the mesh path (phase 14): the one-shot bootstrap's size, B = 256 over
# n = 2^24 - 1000 rows (x of the quickstart's law, [value, key] over 8
# keys, k = 5 2-d blobs), in a world of one NCCL rank in this process and
# a world of 4 gloo ranks (fresh interpreters) sharing the one card:
# chunks of 2^20 rows, two delta extends of half the rows each, the
# quickstart group's session over phase 13's law, DistributedEarl with 3
# of 16 shards lost, the elastic reduce with shard 1 lost and shard 3
# past its deadline; the materialized step at B = 64, n = 2^20
MESH_B, MESH_N, MESH_CHUNK, MESH_WORLD = 256, BOOT_N, 1 << 20, 4
MESH_G, MESH_K, MESH_KEY = 8, 5, 14
MESH_FT_SHARDS, MESH_FT_LOST = 16, (0, 3, 7)
MESH_ELASTIC_LOST, MESH_ELASTIC_DONE_S, MESH_ELASTIC_DEADLINE_S = \
    (1,), (0.1, 0.2, 0.3, 9.0), 1.0
MESH_MAT_B, MESH_MAT_N = 64, 1 << 20
# the world of 4's session: phase 13's law with key 1.  Four shards draw
# other streams than one, and with key 0 SSABE's fit (n about 11.5M rows
# at B = 8 on the CPU) sends the group to the exact job; with key 1 it
# picks B = 32 and n about 165,000 rows, and the session iterates
MESH_SESSION_KEY = 1
MESH_PSUM_REPS, MESH_RANK_TIMEOUT_S = 20, 300
#: the kernels the mesh path's families launch: 2 (Mean, Var), 3 (Median),
#: 4 (the group), 6 (GroupedStatistic(Mean)) and 8 (KMeansStep)
MESH_KERNELS = ("fused_poisson_moments", "fused_poisson_hist",
                "fused_poisson_multi", "fused_poisson_moments_grouped",
                "fused_poisson_kmeans")
# the sharded path (phase 19): granite-3-2b at full width (d_model 2048,
# 32/8 heads of 64, d_ff 8192, vocab 49,155 padded to 51,200; f32 params
# and AdamW states, bf16 compute) cut to SHARD_LAYERS of its 40 layers,
# SHARD_B x SHARD_S tokens, its state placed by distribute_tree on a
# DeviceMesh (data, model): a world of one NCCL rank in this process
# (mesh 1 x 1; SHARD_STEPS train steps under TRAIN_RULES and a prefill
# with SHARD_DECODE1 decode steps under SERVE_RULES, bitwise the unsharded
# steps), and a world of SHARD_WORLD gloo ranks sharing the card (mesh
# SHARD_MESH; one train step and a prefill with SHARD_DECODE4 decode
# steps, within phase 18's card == CPU tolerances and SHARD_LOGIT_SHARE
# of max |logit| of the unsharded steps run here meanwhile)
SHARD_ARCH, SHARD_LAYERS, SHARD_SEED = "granite-3-2b", 4, 19
SHARD_B, SHARD_S, SHARD_STEPS = 4, 4096, 2
SHARD_DECODE1, SHARD_DECODE4 = 8, 4
SHARD_WORLD, SHARD_MESH, SHARD_AXES = 4, (2, 2), ("data", "model")
SHARD_LOGIT_SHARE, SHARD_RANK_TIMEOUT_S = 2e-2, 400
#: the logical axis the card's world of 4 leaves unsplit: gloo's functional
#: all-gather (``_c10d_functional.all_gather_into_tensor``, DTensor's Shard
#: -> Replicate) segfaults on CUDA tensors in torch 2.11 while its
#: all-reduce, reduce-scatter and all-to-all run (``probe_slots.py
#: --gloo-cuda``), so that world runs TRAIN_RULES and SERVE_RULES without
#: the FSDP split of "embed" over data: the batch split over data and the
#: weights over model, all-reduces only.  The FSDP gathers run in the
#: CPU's world of 4 (tests/test_torch_sharded.py)
SHARD_CARD4_UNSPLIT = "embed"
#: the flash-decoding layout in phase 19's world of 4: h2o-danube-3-4b at
#: full width cut to FLASH_LAYERS, an unsharded prefill of 1 x FLASH_S
#: tokens (kernel 12), its cache and the params placed by SERVE_RULES at
#: batch 1 (the ring's slots over data, and the FSDP split of "embed"
#: kept: the stream d-split over data, all-reduces only), then
#: FLASH_STEPS teacher-forced decode steps on the mesh against the
#: unsharded decode within SHARD_LOGIT_SHARE of max |logit|, and one step
#: in the layout without the split (SHARD_CARD4_UNSPLIT's) for its dot
#: FLOPs a rank
FLASH_ARCH, FLASH_LAYERS, FLASH_SEED = "h2o-danube-3-4b", 4, 23
FLASH_S, FLASH_STEPS = 8192, 8
#: the gspmd MoE in phase 19's world of 4: mixtral-8x22b at full width
#: (MIXTRAL_SEED, phase 16's f32 params and bf16 compute) cut to
#: SHARD_MOE_LAYERS of its 56 layers, moe_impl "gspmd" at capacity
#: SHARD_MOE_CAPACITY, one prompt of SHARD_MOE_S phase-16-style (Zipf)
#: tokens prefilled under SERVE_RULES with "embed" kept: the stream
#: d-split over data, the router on each data rank's rows (one
#: all-to-all), the dispatch by another, the experts on each rank's
#: columns of d.  About 11.6 GB of f32 params unsharded (each rank
#: initialises them whole in turn, then keeps its quarter)
SHARD_MOE_LAYERS, SHARD_MOE_S, SHARD_MOE_CAPACITY = 1, 4096, 1.25
#: phase 20's production cells, (arch, shape, multi-pod), dry-run on the
#: card: every cell of launch/dryrun.py --all runs on the CPU (PERF.md).
#: granite-3-2b's train_4k on 16 x 16 (10.5-15.6 s to trace on the H100
#: machine's host) was cut to keep the clock near its 1,000 s target;
#: phase 20's world-1 and world-4 checks trace the same model's step
DRY_CELLS = (("mixtral-8x22b", "decode_32k", True),
             ("h2o-danube-3-4b", "long_500k", False))
#: kernel 12's host time a call: calls a timing, at a shape whose launch
#: the host outruns
HOST_CALLS = 200


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(torch, fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up (CUDA
    events around the whole run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Parity:
    """Largest kernel-versus-plain error seen per kernel."""

    def __init__(self):
        self.err = {k: 0.0 for k in REPLACES}
        self.fa_share = {}

    def bitwise(self, name, a, b, what):
        check(a.shape == b.shape and bool((a == b).all()),
              f"{name} {what} not bitwise equal to the plain version")

    def moments(self, name, got, want, bound1, bound2, what):
        """got/want = (w_tot, s1, s2); bound1 = Σw|x|, bound2 = Σw·x²."""
        self.bitwise(name, got[0], want[0], f"w_tot {what}")
        for i, bound in ((1, bound1), (2, bound2)):
            self.within(name, got[i], want[i], bound, f"s{i} {what}")

    def within(self, name, got, want, bound, what):
        diff = (got - want).abs()
        self.err[name] = max(self.err[name], float(diff.max()))
        check(bool((diff <= 1e-5 * bound).all()),
              f"{name} {what}: max |err| {float(diff.max())} over its "
              f"1e-5 bound")

    def attention(self, got, want, what, pv_abs=None):
        """Kernel 12 against its plain version: f32 within atol 2e-5 and
        rtol 1e-4 (tests/test_kernels.py's tolerance); bf16, compared in
        f32, within one bf16 rounding of the output, 1e-3 + 2^-7·|want|,
        plus the kernel's rounding of P to bf16 before P·V, 2^-8·(Σ
        p·|v|)/l an output: ``pv_abs``, the plain version run on |v|
        (attention_pv_abs).  Records the largest error and the largest
        share of the bound used, per dtype."""
        diff = (got.float() - want.float()).abs()
        self.err["flash_attention"] = max(self.err["flash_attention"],
                                          float(diff.max()))
        if want.element_size() == 4:
            tol = 2e-5 + 1e-4 * want.float().abs()
        else:
            tol = 1e-3 + 2.0 ** -7 * want.float().abs() + 2.0 ** -8 * pv_abs
        key = str(want.dtype).replace("torch.", "")
        share = float((diff / tol).max())
        self.fa_share[key] = max(self.fa_share.get(key, 0.0), share)
        check(got.dtype == want.dtype and bool((diff <= tol).all()),
              f"flash_attention {what}: max |err| {float(diff.max())}")
        return float(diff.max()), share

    def kmeans(self, name, got, want, bound_sums, what):
        """got/want = (sums, counts, inertia); bound_sums = Σw|x| per dim
        (broadcast over clusters); inertia is held to 1e-5 of itself."""
        self.bitwise(name, got[1], want[1], f"counts {what}")
        self.within(name, got[0], want[0], bound_sums, f"sums {what}")
        self.within(name, got[2], want[2], want[2].abs(), f"inertia {what}")


def wrappers():
    """Each kernel's name and the function that counts its launches in
    ``launches``: the wrapper, or for the GROUP BY kernels and kernels 5
    and 7 the card path of the wrapper's keyed, streamed or block_bins
    call."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_backward_cuda)
    from repro_torch.kernels.fused_multi.ops import fused_poisson_multi
    from repro_torch.kernels.kmeans_assign.ops import (fused_poisson_kmeans,
                                                       kmeans_assign)
    from repro_torch.kernels.poisson_counts.ops import poisson_counts
    from repro_torch.kernels.weighted_hist.ops import (binblocked_cuda,
                                                       fused_poisson_hist,
                                                       grouped_hist_cuda,
                                                       weighted_histogram)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, grouped_moments_cuda, moments_stream_cuda,
        weighted_moments)
    return {"poisson_counts": poisson_counts,
            "fused_poisson_moments": fused_poisson_moments,
            "fused_poisson_hist": fused_poisson_hist,
            "fused_poisson_multi": fused_poisson_multi,
            "kmeans_assign": kmeans_assign,
            "fused_poisson_kmeans": fused_poisson_kmeans,
            "fused_poisson_moments_grouped": grouped_moments_cuda,
            "fused_poisson_hist_grouped": grouped_hist_cuda,
            "weighted_moments": weighted_moments,
            "weighted_histogram": weighted_histogram,
            "fused_poisson_moments_stream": moments_stream_cuda,
            "fused_poisson_hist_binblocked": binblocked_cuda,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_backward_cuda}


def zero_counts() -> None:
    for f in wrappers().values():
        f.launches = 0
    wrappers()["flash_attention_bwd"].tc_launches = 0
    for log in LaunchLog.entered:       # a log around the zeroing goes on
        log.before = LaunchLog.counts()


def geometry(lib: str, args: tuple) -> tuple:
    """What a launch's result depends on besides its data, as sorted
    (field, value) pairs, from the arguments of ``earl_<lib>``."""
    if lib == "poisson_counts":
        _, Bp, np_, bb, bn, t0, _, _ = args
        fields = dict(Bp=Bp, np_=np_, bb=bb, bn=bn, offset=t0 > 0)
    elif lib in ("flash_attention", "flash_attention_bwd"):
        (dtype, BHq, Hq, Hkv, Sq, Skv, D, _, causal, window, kv_offset,
         *_) = args
        fields = dict(dtype=dtype, BHq=BHq, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv,
                      D=D, causal=causal, window=window, kv_offset=kv_offset)
    elif lib == "kmeans_assign":
        n, d, k, _, _, _, cols, ranges, threads, *_ = args
        fields = dict(n=n, d=d, k=k, cols=cols, ranges=ranges,
                      threads=threads)
    elif lib == "fused_kmeans":
        (_, n_valid, Bp, np_, bb, bn, d, k, _, mask, _, rows, dc, kc, tpc,
         ranges, asg, _, _, _) = args
        fields = dict(n_valid=n_valid, Bp=Bp, np_=np_, bb=bb, bn=bn, d=d,
                      k=k, masked=mask is not None, rows=rows, dc=dc, kc=kc,
                      tpc=tpc, ranges=ranges, in_place=asg is None)
    elif lib == "weighted_moments":
        B, n, d, _, _, rows, cols, ranges = args[:8]
        fields = dict(B=B, n=n, d=d, rows=rows, cols=cols, ranges=ranges)
    elif lib == "weighted_hist":
        (R, n, d, nbins, _, w, _, _, dc, rows, groups, ranges, copies,
         whole, _, _) = args
        fields = dict(R=R, n=n, d=d, nbins=nbins, unit=w is None, dc=dc,
                      rows=rows, groups=groups, ranges=ranges, copies=copies,
                      whole=whole)
    elif lib == "fused_stream":
        (_, n_valid, Bp, np_, bb, bn, d, _, mask, rows, tpc, ranges,
         *_) = args
        fields = dict(n_valid=n_valid, Bp=Bp, np_=np_, bb=bb, bn=bn, d=d,
                      masked=mask is not None, rows=rows, tpc=tpc,
                      ranges=ranges)
    elif lib == "fused_binblocked":
        (_, n_valid, Bp, np_, bb, bn, d, G, _, mask, keys, nbins, _, _,
         width, rows, tpc, cluster, ranges, _, _) = args
        fields = dict(n_valid=n_valid, Bp=Bp, np_=np_, bb=bb, bn=bn, d=d,
                      G=G, masked=mask is not None, keyed=keys is not None,
                      nbins=nbins, width=width, rows=rows, tpc=tpc,
                      cluster=cluster, ranges=ranges)
    elif lib == "fused_grouped":
        (_, n_valid, Bp, np_, bb, bn, d, G, _, mask, _, dc, kg, rows, tpc,
         ranges, part_w, _, _, _, _, _, nbins, _, _, _, _, _) = args
        fields = dict(n_valid=n_valid, Bp=Bp, np_=np_, bb=bb, bn=bn, d=d,
                      G=G, masked=mask is not None, dc=dc, kg=kg, rows=rows,
                      tpc=tpc, ranges=ranges, moments=part_w is not None,
                      nbins=nbins)
    else:
        (_, n_valid, Bp, np_, bb, bn, d, _, mask, rows, tpc, ranges, part_w,
         _, _, _, _, _, n_hist, _, _, _, hist_total, _, _) = args
        fields = dict(n_valid=n_valid, Bp=Bp, np_=np_, bb=bb, bn=bn, d=d,
                      masked=mask is not None, rows=rows, tpc=tpc,
                      ranges=ranges, moments=part_w is not None,
                      n_hist=n_hist, hist_total=hist_total)
    return tuple(sorted(fields.items()))


class LaunchLog:
    """Logs the geometry of every kernel launch while it is entered.

    Every wrapper launches through ``_build.launch``, so the log wraps that
    one call; the wrapper that launched is the one whose count went up
    since the launch before.  ``geometries`` maps (wrapper name, geometry)
    to the number of launches."""

    #: the logs entered now, which ``zero_counts`` keeps in step
    entered = []

    def __init__(self):
        from repro_torch.kernels import _build
        self.build = _build
        self.geometries = {}

    @staticmethod
    def counts():
        return {name: f.launches for name, f in wrappers().items()}

    def __enter__(self):
        self.orig, self.before = self.build.launch, self.counts()
        self.build.launch = self.launch
        LaunchLog.entered.append(self)
        return self

    def __exit__(self, *exc):
        self.build.launch = self.orig
        LaunchLog.entered.remove(self)

    def launch(self, lib, *args):
        now = self.counts()
        who = [k for k in now if now[k] != self.before[k]]
        self.before = now
        check(len(who) == 1, f"a launch of {lib} not made by exactly one "
              f"wrapper: {who}")
        key = (who[0], geometry(lib, args))
        self.geometries[key] = self.geometries.get(key, 0) + 1
        return self.orig(lib, *args)


class NoLaunch:
    """Fails on any kernel launch while it is entered: a plain version
    that a kernel is held against, or timed beside, computes without one."""

    def __init__(self, fn):
        from repro_torch.kernels import _build
        self.build, self.fn = _build, fn

    def __enter__(self):
        self.orig = self.build.launch
        self.build.launch = self.launch
        return self

    def __exit__(self, *exc):
        self.build.launch = self.orig

    def launch(self, lib, *args):
        check(False, f"the plain version {self.fn.__name__} launched the "
              f"{lib} kernel")


def plain(fn, *args, **kw):
    """``fn(*args, **kw)``, a plain version, checked to launch nothing."""
    with NoLaunch(fn):
        return fn(*args, **kw)


def phase_parity(torch, parity: Parity) -> None:
    from repro_torch.core.reduce_api import Mean, Quantile, StatisticGroup, Std
    from repro_torch.kernels.fused_multi.ops import (_multi_scan,
                                                     fused_poisson_multi)
    from repro_torch.kernels.poisson_counts.ops import poisson_counts
    from repro_torch.kernels.poisson_counts.ref import poisson_weights_plain
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, moments_plain, prepare)

    gen = torch.Generator().manual_seed(11)
    group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
    cases = [(4, 300), (8, 8192), (100, 300), (100, 8192), (BIG_B, BIG_N)]
    for B, n in cases:
        for masked in (False, True):
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
            x = (torch.randn(n, 1, generator=gen) * 2.0 + 10.0).cuda()
            n_valid = n - 17 if masked else n
            mask = None
            if masked:
                mask = (torch.rand(n, generator=gen) > 0.3).float().cuda()
            what = f"B={B} n={n}{' masked' if masked else ''}"

            pr = prepare(x, B, n_valid=n_valid, valid_mask=mask)
            w_k = poisson_counts(seed, B, n, device="cuda")
            w_p = plain(poisson_weights_plain, seed, pr.Bp, pr.np_, pr.bb,
                        pr.bn, device="cuda")[:B, :n]
            parity.bitwise("poisson_counts", w_k, w_p, f"weights {what}")

            mom_k = fused_poisson_moments(seed, x, B, n_valid=n_valid,
                                          valid_mask=mask)
            mom_p = [t[:B] for t in plain(moments_plain, pr, seed)]
            abs_p = [t[:B] for t in plain(
                moments_plain, prepare(x.abs(), B, n_valid=n_valid,
                                       valid_mask=mask), seed)]
            parity.moments("fused_poisson_moments", mom_k, mom_p, abs_p[1],
                           mom_p[2], what)

            lo = torch.full((1,), LO, device="cuda")
            hi = torch.full((1,), HI, device="cuda")
            h_k = fused_poisson_hist(seed, x, LO, HI, NBINS, B,
                                     n_valid=n_valid, valid_mask=mask)
            h_p = plain(hist_plain, pr, seed, lo, hi, NBINS)[:B]
            parity.bitwise("fused_poisson_hist", h_k, h_p, f"counts {what}")

            g_k = fused_poisson_multi(group, seed, x, B, n_valid=n_valid,
                                      valid_mask=mask)
            g_p = plain(_multi_scan, group.slots, seed, pr)
            g_p = (tuple(t[:B] for t in (g_p[0].w, g_p[0].s1, g_p[0].s2)),
                   g_p[1].counts[:B])
            parity.moments("fused_poisson_multi",
                           (g_k[0].w, g_k[0].s1, g_k[0].s2), g_p[0],
                           abs_p[1], mom_p[2], what)
            parity.bitwise("fused_poisson_multi", g_k[1].counts, g_p[1],
                           f"counts {what}")
            # members against the dedicated kernels, bitwise
            for a, b, f in ((g_k[0].w, mom_k[0], "w_tot"),
                            (g_k[0].s1, mom_k[1], "s1"),
                            (g_k[0].s2, mom_k[2], "s2"),
                            (g_k[1].counts, h_k, "counts")):
                check(bool((a == b).all()),
                      f"group {f} differs from the dedicated kernel, {what}")
    # the binning edge cases: NaN mass dropped, +-inf and x == hi clipped
    x = torch.tensor([[float("nan")], [float("inf")], [-float("inf")],
                      [HI], [LO], [HI * 2], [12.5]] * 60).cuda()
    seed = 12345
    pr = prepare(x, 8)
    lo = torch.full((1,), LO, device="cuda")
    hi = torch.full((1,), HI, device="cuda")
    parity.bitwise("fused_poisson_hist",
                   fused_poisson_hist(seed, x, LO, HI, NBINS, 8),
                   plain(hist_plain, pr, seed, lo, hi, NBINS)[:8],
                   "edge values")
    # every value in one bin (the most contended adds), kernels 3 and 4
    x = torch.full((BIG_N, 1), 12.5, device="cuda")
    want = plain(hist_plain, prepare(x, BIG_B), seed, lo, hi, NBINS)[:BIG_B]
    parity.bitwise("fused_poisson_hist",
                   fused_poisson_hist(seed, x, LO, HI, NBINS, BIG_B), want,
                   "all values in one bin")
    parity.bitwise("fused_poisson_multi", fused_poisson_multi(
        group, seed, x, BIG_B)[1].counts, want, "all values in one bin")
    # a mask of 0.5 and 0.25 in the first columns: those CTAs add in f32,
    # the rest in u32, within 1e-6 of the row's mass a bin
    x = (torch.randn(BIG_N, 1, generator=gen) * 2.0 + 10.0).cuda()
    mask = (torch.rand(BIG_N, generator=gen) > 0.3).float()
    mask[:300_000:7] = 0.5
    mask[1:300_000:11] = 0.25
    mask = mask.cuda()
    want = plain(hist_plain, prepare(x, BIG_B, valid_mask=mask), seed, lo,
                 hi, NBINS)[:BIG_B]
    for name, got in (
            ("fused_poisson_hist", fused_poisson_hist(
                seed, x, LO, HI, NBINS, BIG_B, valid_mask=mask)),
            ("fused_poisson_multi", fused_poisson_multi(
                group, seed, x, BIG_B, valid_mask=mask)[1].counts)):
        hold_fractional(parity, name, got, want, "a mask of 0, 1, 0.5, 0.25")
    torch.cuda.synchronize()
    print(f"parity: all kernels match their plain versions; max |err| "
          f"{json.dumps(parity.err)}")


def hold_fractional(parity, name, got, want, what) -> None:
    """Counts under a mask value other than 0/1 (f32 adds in any order)
    against the plain version: within 1e-6 of the row's mass a bin."""
    diff = (got.double() - want.double()).abs()
    parity.err[name] = max(parity.err[name], float(diff.max()))
    bound = 1e-6 * want.double().sum(dim=tuple(range(1, want.ndim)))
    check(bool((diff <= bound.reshape(-1, *[1] * (want.ndim - 1))).all()),
          f"{name} {what}: max |err| {float(diff.max())} over 1e-6 of the "
          f"row's mass")
    check(not bool((got == got.round()).all()), f"{name} {what}: whole "
          "counts")


def km_data(torch, n: int, k: int, d: int, seed: int):
    """k Gaussian blobs (n, d) on the card, and centroids near their
    centers."""
    import numpy as np
    from repro_torch.data import synthetic_clusters
    x, centers = synthetic_clusters(n, k=k, dim=d, seed=seed)
    cent = centers + np.random.default_rng(seed).normal(0, 0.1, centers.shape)
    return (torch.from_numpy(x).cuda(),
            torch.from_numpy(cent.astype(np.float32)).cuda())


def hold_fused_kmeans(parity, seed, x, cent, B, what, **kw) -> None:
    """The fused k-means kernel against its plain version on one input;
    ``kw`` are n_valid / valid_mask."""
    from repro_torch.kernels.kmeans_assign.ops import (fused_kmeans_plain,
                                                       fused_poisson_kmeans)
    from repro_torch.kernels.weighted_stats.ops import moments_plain, prepare
    got = fused_poisson_kmeans(seed, x, cent, B, **kw)
    want = [t[:B] for t in plain(fused_kmeans_plain, prepare(x, B, **kw),
                                 seed, cent)]
    bound = plain(moments_plain, prepare(x.abs(), B, **kw), seed)[1][:B]
    parity.kmeans("fused_poisson_kmeans", got, want, bound[:, None, :],
                  what)


def hold_kmeans_assign(parity, x, w, cent, what) -> None:
    """kmeans_assign against its plain version under weights ``w``."""
    from repro_torch.kernels.kmeans_assign.ops import (assign_plain,
                                                       kmeans_assign)
    parity.kmeans("kmeans_assign", kmeans_assign(x, w, cent),
                  plain(assign_plain, x, w, cent),
                  (w.double() @ x.abs().double()).float(), what)


def assign_one_launch(torch) -> None:
    """Kernel 9 at the k-means path's shape: one call is one kernel on the
    card (torch.profiler: the last CTA sums the partials, no second
    pass), two calls give the same bits, and no weights is unit weights,
    bitwise; also in the shared-slot layout (k = 16, d = 8)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
    for k, d in ((KM_K, 2), KM_WIDE):
        x, cent = km_data(torch, KM_N, k, d, seed=11)
        ones = torch.ones(KM_N, device="cuda")
        kmeans_assign(x, None, cent)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            a = kmeans_assign(x, None, cent)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        check(len(kernels) == 1, f"kmeans_assign at k={k}, d={d}: one call "
              f"ran {kernels} on the card")
        for u, v, o in zip(a, kmeans_assign(x, None, cent),
                           kmeans_assign(x, ones, cent)):
            check(torch.equal(u, v) and torch.equal(u, o),
                  f"kmeans_assign at k={k}, d={d}: two calls, or no "
                  "weights and unit weights, differ")
        print(f"parity: kmeans_assign at n={KM_N}, k={k}, d={d} is one "
              f"launch a call ({kernels[0][:60]}), bitwise repeatable")


def int_weights(torch, n: int, gen):
    """Whole weights 0..3 on the card."""
    return torch.randint(0, 4, (n,), generator=gen).float().cuda()


def phase_parity_kmeans(torch, parity: Parity) -> None:
    from repro_torch.core.reduce_api import (KMeansStep, Mean, Quantile,
                                             StatisticGroup)
    from repro_torch.kernels.fused_multi.ops import fused_poisson_multi
    from repro_torch.kernels.kmeans_assign.ops import (fused_poisson_kmeans,
                                                       kmeans_assign)
    from repro_torch.kernels.weighted_stats.ops import fused_poisson_moments

    gen = torch.Generator().manual_seed(17)
    cases = [(KM_B, KM_SAMPLE), (4, KM_N), (BIG_B, BIG_N)]
    for B, n in cases:
        for k, d in ((KM_K, 2), KM_WIDE):
            x, cent = km_data(torch, n, k, d, seed=n + k)
            for masked in (False, True):
                seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
                mask = None
                if masked:
                    mask = (torch.rand(n, generator=gen) > 0.3).float().cuda()
                what = (f"k-means B={B} n={n} k={k} d={d}"
                        f"{' masked' if masked else ''}")
                n_valid = n - 17 if masked else n
                hold_fused_kmeans(parity, seed, x, cent, B, what,
                                  n_valid=n_valid, valid_mask=mask)
                w = int_weights(torch, n, gen)
                if masked:
                    w = w * mask
                    w[n_valid:] = 0.0
                hold_kmeans_assign(parity, x, w, cent, what)
    # exact ties: (0, y) is as far from (-1, 0) as from (1, 0); the lower
    # cluster takes it, in the kernels as in the plain versions
    y = torch.linspace(-1.0, 1.0, 300)
    x = torch.stack([torch.zeros_like(y), y], dim=1).cuda()
    cent = torch.tensor([[-1.0, 0.0], [1.0, 0.0], [0.0, 3.0]]).cuda()
    hold_fused_kmeans(parity, 99, x, cent, 8, "exact ties")
    hold_kmeans_assign(parity, x, int_weights(torch, 300, gen), cent,
                       "exact ties")
    counts = kmeans_assign(x, None, cent)[1]
    check(counts.tolist() == [300.0, 0.0, 0.0],
          f"tied points not all in cluster 0: {counts.tolist()}")
    assign_one_launch(torch)
    # a group with a KMeansStep member: each slot bitwise its dedicated
    # kernel (the k-means slot runs the k-means kernel with the same seed)
    x, cent = km_data(torch, KM_SAMPLE, KM_K, 2, seed=3)
    group = StatisticGroup((Mean(), KMeansStep(cent),
                            Quantile(0.5, nbins=256, lo=-8.0, hi=8.0)))
    for mask in (None, (torch.rand(KM_SAMPLE, generator=gen) > 0.3).float()
                 .cuda()):
        g = fused_poisson_multi(group, 7, x, KM_B, valid_mask=mask)
        ded_k = fused_poisson_kmeans(7, x, cent, KM_B, valid_mask=mask)
        ded_m = fused_poisson_moments(7, x, KM_B, valid_mask=mask)
        for a, b in zip((g[0].w, g[0].s1, g[0].s2, g[1].sums, g[1].counts,
                         g[1].inertia), (*ded_m, *ded_k)):
            check(bool((a == b).all()), "a group member differs from its "
                  "dedicated kernel (KMeansStep group)")
    torch.cuda.synchronize()
    print(f"parity (k-means): both kernels match their plain versions; "
          f"max |err| kmeans_assign {parity.err['kmeans_assign']}, "
          f"fused_poisson_kmeans {parity.err['fused_poisson_kmeans']}")


def keyed_rows(n: int, d: int = 1, G: int = 8, seed: int = 8, absent=None,
               uniform: bool = False):
    """Rows [x (d columns), key], numpy f32: key g with frequency ∝ 2^-g,
    or uniform (none for the key ``absent``; at n = 2,000,000 and G = 8
    the rarest key has about 7,800 rows), x Normal(10 + key, 2)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    p = np.ones(G) if uniform else 2.0 ** -np.arange(G)
    if absent is not None:
        p[absent] = 0.0
    keys = rng.choice(G, size=n, p=p / p.sum())
    x = rng.normal(10.0 + keys[:, None], 2.0, size=(n, d))
    return np.concatenate([x, keys[:, None]], axis=1).astype(np.float32)


def hold_grouped(torch, parity, seed, x, keys, G, B, nbins, what,
                 mask=None, kmeans_plain=False) -> None:
    """Both GROUP BY kernels against their plain versions on one input,
    and every keyed slot (moments, histogram, k-means) against the
    dedicated kernel masked to its key, bitwise."""
    from repro_torch.kernels.kmeans_assign.ops import (fused_poisson_kmeans,
                                                       grouped_kmeans_plain)
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       grouped_hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, grouped_moments_plain, prepare)
    kw = dict(valid_mask=mask, group_ids=keys, num_groups=G)
    pr = prepare(x, B, **kw)
    d = x.shape[1]
    got = fused_poisson_moments(seed, x, B, **kw)
    want = [t[:B] for t in plain(grouped_moments_plain, pr, seed)]
    bound = plain(grouped_moments_plain, prepare(x.abs(), B, **kw),
                  seed)[1][:B]
    parity.moments("fused_poisson_moments_grouped", got, want, bound,
                   want[2], what)
    lo = torch.full((d,), LO, device="cuda")
    hi = torch.full((d,), HI, device="cuda")
    h = fused_poisson_hist(seed, x, LO, HI, nbins, B, **kw)
    parity.bitwise("fused_poisson_hist_grouped", h,
                   plain(grouped_hist_plain, pr, seed, lo, hi, nbins)[:B],
                   f"counts {what}")
    cent = x[:KM_K].contiguous()
    km = fused_poisson_kmeans(seed, x, cent, B, **kw)
    if kmeans_plain:
        wk = [t[:B] for t in plain(grouped_kmeans_plain, pr, seed, cent)]
        parity.kmeans("fused_poisson_kmeans", km, wk, bound[:, :, None, :],
                      f"keyed {what}")
    for g in range(G):
        m = (keys == g).float() if mask is None else mask * (keys == g)
        ded = fused_poisson_moments(seed, x, B, valid_mask=m)
        for a, b, f in zip(got, ded, ("w_tot", "s1", "s2")):
            check(torch.equal(a[:, g], b), f"grouped moments slot {g} {f} "
                  f"differs from the masked kernel, {what}")
        check(torch.equal(h[:, g], fused_poisson_hist(
            seed, x, LO, HI, nbins, B, valid_mask=m)),
            f"keyed hist slot {g} differs from the masked kernel, {what}")
        ded = fused_poisson_kmeans(seed, x, cent, B, valid_mask=m)
        for a, b, f in zip(km, ded, ("sums", "counts", "inertia")):
            check(torch.equal(a[:, g], b), f"keyed k-means slot {g} {f} "
                  f"differs from the masked kernel, {what}")


def same_or_nan(a, b) -> bool:
    """Bitwise equal with NaN at the same places (torch.equal is false on
    NaN)."""
    nan = a != a
    return (bool((nan == (b != b)).all())
            and bool((a[~nan] == b[~nan]).all()))


def within_positions(parity, name, got, want, bound, what) -> None:
    """NaN, +inf and -inf at the plain version's places, the finite
    entries within 1e-5·bound."""
    inf = float("inf")
    for f in (lambda t: t != t, lambda t: t == inf, lambda t: t == -inf):
        check(bool((f(got) == f(want)).all()), f"{name} {what}: NaN or inf "
              "positions differ from the plain version")
    fin = (want == want) & (want.abs() != inf)
    if bool(fin.any()):
        parity.within(name, got[fin], want[fin],
                      bound.expand_as(want)[fin], what)


def hold_nonfinite_assign(torch, parity) -> None:
    """Kernel 9 on values with +inf, -inf and NaN, NaN also on a row of
    weight 0, at d = 1 and 2 (k = 5, the register layout) and k = 16,
    d = 8 (the shared slots), under unit and whole-number weights: the
    plain version's NaN and inf positions (every other cluster's sums of
    that dimension NaN, 0·x in its one-hot contraction, whatever the
    weight), counts bitwise, finite entries within its bounds."""
    from repro_torch.kernels.kmeans_assign.ops import (assign_plain,
                                                       kmeans_assign)
    gen = torch.Generator().manual_seed(29)
    for k, d in ((KM_K, 1), (KM_K, 2), KM_WIDE):
        for n in (KM_N, (1 << 16) + 37):
            x, cent = km_data(torch, n, k, d, seed=n + 3 * d)
            x[7, 0], x[n // 3, d - 1] = float("inf"), -float("inf")
            x[n - 2, d - 1], x[n // 2, 0] = float("nan"), float("nan")
            for unit in (True, False):
                w = (torch.ones(n, device="cuda") if unit
                     else int_weights(torch, n, gen))
                w[n // 2] = 0.0
                what = (f"non-finite x, n={n} k={k} d={d} "
                        f"{'unit' if unit else 'whole'} weights")
                got = kmeans_assign(x, w, cent)
                want = plain(assign_plain, x, w, cent)
                check(bool((want[0] != want[0]).any()), f"{what}: no NaN")
                parity.bitwise("kmeans_assign", got[1], want[1],
                               f"counts {what}")
                bound = (w.double() @ x.double().abs().nan_to_num(
                    0, 0, 0)).float()
                within_positions(parity, "kmeans_assign", got[0], want[0],
                                 bound, f"sums {what}")
                within_positions(parity, "kmeans_assign", got[2], want[2],
                                 want[2].abs(), f"inertia {what}")


def hold_nonfinite(torch, parity) -> None:
    """Kernels 6 and 8 on values with +inf and -inf in rows of key 1 and
    NaN in a row of key 2: the plain version's NaN and inf positions
    (finite entries within its bounds, w_tot and counts bitwise), and
    every keyed slot the dedicated kernel masked to its key, bitwise with
    NaN at the same places (another key's non-finite value is 0·x = NaN
    in the masked run); then kernel 9 (hold_nonfinite_assign)."""
    from repro_torch.kernels.kmeans_assign.ops import (fused_kmeans_plain,
                                                       fused_poisson_kmeans,
                                                       grouped_kmeans_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, grouped_moments_plain, prepare)
    B, n, G = 64, (1 << 16) + 37, GB_G
    gen = torch.Generator().manual_seed(23)
    t0 = time.perf_counter()
    for d in (1, 2):
        xk = keyed_rows(n, d, G, seed=40 + d)
        one = (xk[:, -1] == 1).nonzero()[0]
        two = (xk[:, -1] == 2).nonzero()[0]
        xk[one[3], 0], xk[two[5], d - 1], xk[one[9], d - 1] = (
            float("inf"), float("nan"), -float("inf"))
        xk = torch.from_numpy(xk).cuda()
        x, keys = xk[:, :-1].contiguous(), xk[:, -1].contiguous()
        cent = x[:KM_K].clone()
        cent[0, 0] = 0.0
        for masked in (False, True):
            mask = None
            if masked:
                mask = (torch.rand(n, generator=gen) > 0.3).float().cuda()
            what = f"non-finite x, B={B} n={n} d={d}" + (
                " masked" if masked else "")
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
            kw = dict(valid_mask=mask, group_ids=keys, num_groups=G)
            pr = prepare(x, B, **kw)
            bound = plain(grouped_moments_plain, prepare(
                x.abs().nan_to_num(0, 0, 0), B, **kw), seed)[1][:B]
            got = fused_poisson_moments(seed, x, B, **kw)
            want = [t[:B] for t in plain(grouped_moments_plain, pr, seed)]
            name = "fused_poisson_moments_grouped"
            parity.bitwise(name, got[0], want[0], f"w_tot {what}")
            within_positions(parity, name, got[1], want[1], bound,
                             f"s1 {what}")
            within_positions(parity, name, got[2], want[2], want[2].abs(),
                             f"s2 {what}")
            check(bool((want[1] != want[1]).any()), f"{what}: no NaN")
            name = "fused_poisson_kmeans"
            km = fused_poisson_kmeans(seed, x, cent, B, **kw)
            for run, args, b in (
                    (grouped_kmeans_plain, kw, bound[:, :, None, :]),
                    (fused_kmeans_plain, dict(valid_mask=mask),
                     bound.sum(1)[:, None, :])):
                g = km if run is grouped_kmeans_plain else \
                    fused_poisson_kmeans(seed, x, cent, B, valid_mask=mask)
                wk = [t[:B] for t in plain(run, prepare(x, B, **args), seed,
                                           cent)]
                parity.bitwise(name, g[1], wk[1], f"counts {what}")
                within_positions(parity, name, g[0], wk[0], b,
                                 f"sums {what}")
                within_positions(parity, name, g[2], wk[2], wk[2].abs(),
                                 f"inertia {what}")
            for g in range(G):
                m = (keys == g).float() if mask is None else \
                    mask * (keys == g)
                for a, b in zip(got, fused_poisson_moments(seed, x, B,
                                                           valid_mask=m)):
                    check(same_or_nan(a[:, g], b), f"grouped moments slot "
                          f"{g} differs from the masked kernel, {what}")
                for a, b in zip(km, fused_poisson_kmeans(seed, x, cent, B,
                                                         valid_mask=m)):
                    check(same_or_nan(a[:, g], b), f"keyed k-means slot "
                          f"{g} differs from the masked kernel, {what}")
    hold_nonfinite_assign(torch, parity)
    torch.cuda.synchronize()
    print("parity (non-finite x): kernels 6, 8 and 9 give the plain "
          "versions' NaN and inf positions, every keyed slot its masked "
          f"kernel's ({time.perf_counter() - t0:.1f} s)")


def phase_parity_grouped(torch, parity: Parity) -> None:
    from repro_torch.kernels._pass import grouped_geometry

    gen = torch.Generator().manual_seed(19)
    hold_nonfinite(torch, parity)
    # (B, n, d, G, nbins, absent key, uniform keys): the main shapes, a key
    # with no rows, G·(2d+1) = 144 > 128, which takes two z chunks of 8
    # keys, one key, and 32 keys uniform and skewed (the keyed histogram
    # then holds several keys a CTA)
    cases = [(BIG_B, BIG_N, 1, GB_G, NBINS, None, False),
             (BIG_B, BIG_N, 4, GB_G, 256, None, False),
             (100, 8192, 1, GB_G + 1, NBINS, GB_G, False),
             (64, (1 << 16) + 37, 4, 16, 64, 15, False),
             (BIG_B, BIG_N, 1, 1, NBINS, None, False),
             (64, (1 << 16) + 37, 1, 32, 256, None, True),
             (64, (1 << 16) + 37, 4, 32, 64, None, False)]
    check(grouped_geometry(64, (1 << 16) + 512, 512, 16, 4).chunks == 2,
          "G=16, d=4 is not chunked")
    for B, n, d, G, nbins, absent, uniform in cases:
        xk = torch.from_numpy(keyed_rows(n, d, G, seed=n + d + G,
                                         absent=absent,
                                         uniform=uniform)).cuda()
        x, keys = xk[:, :-1].contiguous(), xk[:, -1].contiguous()
        for masked in (False, True):
            if absent is not None and masked:
                continue
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
            mask = None
            if masked:
                mask = (torch.rand(n, generator=gen) > 0.3).float().cuda()
            what = (f"grouped B={B} n={n} d={d} G={G}"
                    f"{' uniform' if uniform else ''}"
                    f"{' masked' if masked else ''}")
            hold_grouped(torch, parity, seed, x, keys, G, B, nbins, what,
                         mask=mask, kmeans_plain=n < BIG_N)
            if absent is not None:
                from repro_torch.kernels.weighted_stats.ops import \
                    fused_poisson_moments
                w = fused_poisson_moments(seed, x, B, group_ids=keys,
                                          num_groups=G)[0]
                check(float(w[:, absent].abs().sum()) == 0.0,
                      f"the key without rows has weight, {what}")
    # the keyed histogram with every value in one bin, and under a mask of
    # 0, 1 and 0.5 (f32 adds in the ranges that hold 0.5)
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       grouped_hist_plain)
    from repro_torch.kernels.weighted_stats.ops import prepare
    xk = torch.from_numpy(keyed_rows(BIG_N, 1, GB_G, seed=21)).cuda()
    keys = xk[:, -1].contiguous()
    lo = torch.full((1,), LO, device="cuda")
    hi = torch.full((1,), HI, device="cuda")
    kw = dict(group_ids=keys, num_groups=GB_G)
    x = torch.full((BIG_N, 1), 12.5, device="cuda")
    parity.bitwise("fused_poisson_hist_grouped",
                   fused_poisson_hist(5, x, LO, HI, NBINS, BIG_B, **kw),
                   plain(grouped_hist_plain, prepare(x, BIG_B, **kw), 5, lo,
                         hi, NBINS)[:BIG_B], "all values in one bin")
    x = xk[:, :1].contiguous()
    mask = (torch.rand(BIG_N, generator=gen) > 0.3).float()
    mask[:300_000:7] = 0.5
    mask = mask.cuda()
    kw["valid_mask"] = mask
    hold_fractional(parity, "fused_poisson_hist_grouped",
                    fused_poisson_hist(5, x, LO, HI, NBINS, BIG_B, **kw),
                    plain(grouped_hist_plain, prepare(x, BIG_B, **kw), 5,
                          lo, hi, NBINS)[:BIG_B], "a mask of 0, 1, 0.5")
    torch.cuda.synchronize()
    print(f"parity (GROUP BY): both kernels match their plain versions and "
          f"every keyed slot its masked dedicated kernel; max |err| "
          f"grouped moments {parity.err['fused_poisson_moments_grouped']}")


def phase_main_path(torch):
    """Runs the main path from zeroed launch counts; returns the counts,
    the logged launch geometries and the quickstart session (a function
    of the device) for the timing phase."""
    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.core import (EarlSession, Mean, Median, Quantile,
                                  StatisticGroup, Std, bootstrap)
    from repro_torch.core.reduce_api import MomentState, Statistic
    from repro_torch.data import PreMapSampler, ShardedStore, synthetic_numeric
    from repro_torch.kernels.fused_multi.ops import fused_poisson_multi

    class RMS(Statistic):
        def init_state(self, dim, device="cpu"):
            z = torch.zeros(dim, device=device)
            return MomentState(w=torch.zeros((), device=device), s1=z, s2=z)

        def update(self, state, values, weights=None):
            x = values.reshape(values.shape[0], -1)
            w = (torch.ones(x.shape[0], device=x.device) if weights is None
                 else weights)
            return MomentState(w=state.w + w.sum(), s1=state.s1,
                               s2=state.s2 + w @ (x * x))

        def finalize(self, state):
            return torch.sqrt(state.s2 / (state.w.unsqueeze(-1) + 1e-12))

    data = synthetic_numeric(QUICKSTART_N, mean=10.0, std=2.0, seed=0)
    exact = (float(data.mean()), float(np.median(data)), float(data.std()))

    def quickstart(device):
        store = ShardedStore.from_array(data, split_size=65_536)
        group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
        session = EarlSession(PreMapSampler(store, seed=1, device=device),
                              group, sigma=0.05, backend="fused_rng",
                              device=device)
        return session.run(trandom.PRNGKey(0))

    def single(stat):
        store = ShardedStore.from_array(data, split_size=65_536)
        return EarlSession(PreMapSampler(store, seed=1), stat, sigma=0.05,
                           backend="fused_rng").run(trandom.PRNGKey(0))

    xs = torch.from_numpy(data[:65_536]).cuda()
    xb = torch.from_numpy(synthetic_numeric(BOOT_N, seed=7)).cuda()
    torch.cuda.synchronize()
    zero_counts()
    with LaunchLog() as log:
        t0 = time.perf_counter()
        out = quickstart(None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        quick_launches = fused_poisson_multi.launches
        mean_out = single(Mean())
        median_out = single(Median(lo=LO, hi=HI))
        rms = bootstrap(xs, RMS(), 64, trandom.PRNGKey(3), backend="fused_rng")

        group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
        key = trandom.PRNGKey(5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        big = bootstrap(xb, group, BIG_B, key, backend="fused_rng")
        end.record()
        end.synchronize()
        boot_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated() - base
    launches = log.counts()

    # ---- checks of what came out -------------------------------------
    print(f"main path launches: {json.dumps(launches)} (quickstart session: "
          f"fused_poisson_multi x{quick_launches})")
    check(quick_launches > 0, "the quickstart session launched no "
          "fused_poisson_multi kernel")
    check(all(launches[k] > 0 for k in QUICKSTART_KERNELS),
          f"a kernel of the quickstart path was not launched: {launches}")
    names = ("mean", "median", "std")
    summary = dict(B=out.B, iterations=out.iterations, n_used=out.n_used,
                   worst_cv=out.cv, wall_s=wall, members={})
    for name, res, rep, ex in zip(names, out.result, out.reports, exact):
        est = float(torch.as_tensor(res).reshape(-1)[0])
        rel = abs(est - ex) / abs(ex)
        summary["members"][name] = dict(
            estimate=est, exact=ex, rel_err=rel, cv=rep.cv,
            ci=[float(rep.ci_lo.reshape(-1)[0]),
                float(rep.ci_hi.reshape(-1)[0])])
        check(math.isfinite(est) and rel < 0.02,
              f"quickstart {name}: estimate {est} vs exact {ex}")
    print("quickstart (cuda): " + json.dumps(summary))

    cpu = quickstart("cpu")
    check((cpu.B, cpu.n_used, cpu.iterations)
          == (out.B, out.n_used, out.iterations),
          f"cpu session took (B, n_used, iterations) = "
          f"{(cpu.B, cpu.n_used, cpu.iterations)}, cuda "
          f"{(out.B, out.n_used, out.iterations)}")
    # moments agree to f32 rounding (1e-5); Std = sqrt(E[x²] - E[x]²)
    # scales that by E[x²] / Var[x] = 26 for this data; the median comes
    # from histogram counts and is bitwise.
    for name, a, b in zip(names, out.result, cpu.result):
        a, b = float(a.reshape(-1)[0]), float(b.reshape(-1)[0])
        if name == "median":
            check(a == b, f"median cuda {a} != cpu {b}")
        rtol = 26e-5 if name == "std" else 1e-5
        check(abs(a - b) <= rtol * abs(b), f"{name} cuda {a} vs cpu {b}")
    print(f"quickstart (cpu): B={cpu.B} iterations={cpu.iterations} "
          f"n_used={cpu.n_used}: agrees with the card")

    for label, o, ex in (("Mean()", mean_out, exact[0]),
                         ("Median()", median_out, exact[1])):
        est = float(torch.as_tensor(o.result).reshape(-1)[0])
        check(abs(est - ex) / abs(ex) < 0.02, f"{label} session {est} vs {ex}")
        print(f"{label} session: B={o.B} iterations={o.iterations} "
              f"n_used={o.n_used} estimate={est} cv={o.cv}")
    rms_mean = float(rms.thetas.mean())
    rms_exact = float(np.sqrt(np.mean(data[:65_536].astype(np.float64) ** 2)))
    check(abs(rms_mean - rms_exact) / rms_exact < 1e-2,
          f"RMS bootstrap {rms_mean} vs {rms_exact}")

    thetas = big.thetas
    check(all(t.shape == (BIG_B, 1) or t.shape == (BIG_B,) for t in thetas)
          and all(bool(torch.isfinite(t).all()) for t in thetas),
          "bootstrap thetas not finite or of the wrong shape")
    bn_bytes = BIG_B * BOOT_N * 4
    check(peak < bn_bytes // 4, f"bootstrap peak {peak} B suggests a (B, n) "
          f"tensor ({bn_bytes} B)")
    boot = dict(B=BIG_B, n=BOOT_N, ms=boot_ms, peak_bytes=peak,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                weight_draws=BIG_B * BOOT_N, cv=big.report.cvs,
                estimate=[float(torch.as_tensor(e).reshape(-1)[0])
                          for e in big.estimate])
    print("bootstrap (cuda): " + json.dumps(boot))
    return launches, log.geometries, quickstart


def kmeans_example(torch, device):
    """examples/analytics_kmeans.py on ``device``: Lloyd over the full data
    and over a 2% sample, then the bootstrap certificate over KMeansStep.
    Returns the two fits' centroids, the bootstrap and the walls."""
    from repro_torch import random as trandom
    from repro_torch.core import KMeansStep, bootstrap, kmeans_fit
    from repro_torch.data import (PreMapSampler, ShardedStore,
                                  synthetic_clusters)

    x_np, _ = synthetic_clusters(KM_N, k=KM_K, dim=2, seed=5)
    sampler = PreMapSampler(ShardedStore.from_array(x_np, 65_536), seed=6,
                            device=device)
    xs = sampler.take(0, KM_SAMPLE)
    init = xs[:KM_K]
    x_full = torch.from_numpy(x_np).to(sampler.device)

    def sync():
        if sampler.device.type == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    full, _ = kmeans_fit(x_full, KM_K, KM_ITERS, trandom.PRNGKey(0),
                         init=init, device=device)
    sync()
    t1 = time.perf_counter()
    earl, _ = kmeans_fit(xs, KM_K, KM_ITERS, trandom.PRNGKey(0), init=init,
                         device=device)
    boot = bootstrap(xs, KMeansStep(earl), KM_B, trandom.PRNGKey(0),
                     backend="fused_rng", device=device)
    sync()
    t2 = time.perf_counter()
    return dict(x=x_np, full=full.cpu(), earl=earl.cpu(), boot=boot,
                fit_full_s=t1 - t0, earl_s=t2 - t1)


def mean_min_d2(x, cents) -> float:
    """The example's inertia: mean squared distance to the nearest
    centroid, in float64 numpy."""
    import numpy as np
    d2 = ((x[:, None, :].astype(np.float64)
           - np.asarray(cents, np.float64)[None]) ** 2).sum(-1)
    return float(d2.min(axis=1).mean())


def phase_kmeans_path(torch):
    """The k-means path from zeroed launch counts: the example, then a
    B=256 bootstrap over 2^22 rows.  Returns the counts and the logged
    geometries."""
    from repro_torch import random as trandom
    from repro_torch.core import KMeansStep, bootstrap

    xb, cb = km_data(torch, KM_BOOT_N, KM_K, 2, seed=7)
    torch.cuda.synchronize()
    zero_counts()
    with LaunchLog() as log:
        ex = kmeans_example(torch, None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        big = bootstrap(xb, KMeansStep(cb), BIG_B, trandom.PRNGKey(11),
                        backend="fused_rng")
        end.record()
        end.synchronize()
        boot_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated() - base
    launches = log.counts()
    print(f"k-means path launches: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in KMEANS_KERNELS),
          f"a kernel of the k-means path was not launched: {launches}")

    # ---- checks of what came out -------------------------------------
    x = ex["x"]
    i_full, i_earl = mean_min_d2(x, ex["full"]), mean_min_d2(x, ex["earl"])
    gap = (i_earl - i_full) / i_full
    thetas = ex["boot"].thetas
    summary = dict(inertia_full=i_full, inertia_earl=i_earl, gap=gap,
                   centroid_cv=ex["boot"].cv, fit_full_s=ex["fit_full_s"],
                   earl_s=ex["earl_s"], rows=f"{KM_SAMPLE}/{KM_N}")
    print("k-means example (cuda): " + json.dumps(summary))
    check(thetas.shape == (KM_B, KM_K, 2)
          and bool(torch.isfinite(thetas).all()), "example thetas")
    check(math.isfinite(i_full) and gap < 0.05,
          f"EARL inertia gap {gap} (the paper validates < 5%)")

    # The CPU run: f32 sums in another order move a centroid by ~1e-6; a
    # point within that of a boundary may then change cluster, which moves
    # its centroid by |x - c| / count, under 1e-3 at the sample's ~1600
    # rows a cluster.  So centroids and thetas agree within 1e-3 (data
    # of scale 5), the example's inertia within 1e-4 of itself, and the
    # cv (a spread of ~1e-2 over 24 thetas) within 5% of itself.
    cpu = kmeans_example(torch, "cpu")
    for name in ("full", "earl"):
        diff = float((ex[name] - cpu[name]).abs().max())
        check(diff <= 1e-3, f"{name} fit: cuda and cpu centroids differ "
              f"by {diff}")
    tdiff = float((thetas.cpu() - cpu["boot"].thetas).abs().max())
    check(tdiff <= 1e-3, f"bootstrap thetas differ by {tdiff}")
    ci_full = mean_min_d2(x, cpu["full"])
    check(abs(ci_full - i_full) <= 1e-4 * i_full,
          f"full-fit inertia cuda {i_full} vs cpu {ci_full}")
    check(abs(cpu["boot"].cv - ex["boot"].cv) <= 0.05 * cpu["boot"].cv,
          f"centroid cv cuda {ex['boot'].cv} vs cpu {cpu['boot'].cv}")
    print(f"k-means example (cpu): agrees with the card; max |centroid "
          f"diff| full {float((ex['full'] - cpu['full']).abs().max())} "
          f"earl {float((ex['earl'] - cpu['earl']).abs().max())}, thetas "
          f"{tdiff}; cv {cpu['boot'].cv}; walls fit_full "
          f"{cpu['fit_full_s']:.2f} s, earl {cpu['earl_s']:.2f} s")

    check(big.thetas.shape == (BIG_B, KM_K, 2)
          and bool(torch.isfinite(big.thetas).all()),
          "B=256 k-means bootstrap thetas not finite or of the wrong shape")
    nk_bytes = KM_BOOT_N * KM_K * 4
    check(peak < nk_bytes, f"k-means bootstrap peak {peak} B suggests an "
          f"(n, k) tensor ({nk_bytes} B) or a (B, n) one "
          f"({BIG_B * KM_BOOT_N * 4} B)")
    print("k-means bootstrap (cuda): " + json.dumps(dict(
        B=BIG_B, n=KM_BOOT_N, k=KM_K, d=2, ms=boot_ms, peak_bytes=peak,
        nk_bytes=nk_bytes, Bn_bytes=BIG_B * KM_BOOT_N * 4, cv=big.cv,
        weight_draws=BIG_B * KM_BOOT_N)))
    return launches, log.geometries


def groupby_session(data, name, device):
    """The README's keyed session of the inner ``GB_INNERS[name]`` over a
    StratifiedSampler on ``device``; returns (result, session, wall of
    run() in s)."""
    import torch
    from repro_torch import core
    from repro_torch import random as trandom
    from repro_torch.data import ShardedStore, StratifiedSampler
    sampler = StratifiedSampler(ShardedStore.from_array(data, 65_536), GB_G,
                                seed=1, device=device)
    session = core.EarlSession(
        sampler, core.GroupedStatistic(GB_INNERS[name](core), GB_G),
        sigma=0.05, backend="fused_rng", device=device)
    t0 = time.perf_counter()
    out = session.run(trandom.PRNGKey(0))
    if sampler.device.type == "cuda":
        torch.cuda.synchronize()
    return out, session, time.perf_counter() - t0


#: the inner statistics of the GROUP BY path's sessions
GB_INNERS = {"mean": lambda core: core.Mean(),
             "median": lambda core: core.Quantile(0.5, lo=LO, hi=HI)}


def keyed_summary(out, session):
    from repro_torch.core import KeyedAccuracyReport
    return dict(B=out.B, n_used=out.n_used, iterations=out.iterations,
                fell_back=out.fell_back,
                worst_key=KeyedAccuracyReport(out.reports).worst_key,
                p_keys=session._p_keys(out.n_used).tolist())


def phase_groupby_path(torch):
    """The GROUP BY path from zeroed launch counts: the keyed Mean and
    median sessions, then a keyed Mean bootstrap at B=256, n=2^24-1000.
    Returns the counts, the logged geometries and the sessions' cold
    walls."""
    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.core import GroupedStatistic, Mean, bootstrap

    data = keyed_rows(GB_N, G=GB_G)
    xb = torch.from_numpy(keyed_rows(BOOT_N, G=GB_G, seed=9)).cuda()
    torch.cuda.synchronize()
    zero_counts()
    outs = {}
    with LaunchLog() as log:
        for name in GB_INNERS:
            outs[name] = groupby_session(data, name, None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        big = bootstrap(xb, GroupedStatistic(Mean(), GB_G), BIG_B,
                        trandom.PRNGKey(13), backend="fused_rng")
        end.record()
        end.synchronize()
        boot_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated() - base
    launches = log.counts()
    print(f"GROUP BY path launches: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in GROUPBY_KERNELS),
          f"a kernel of the GROUP BY path was not launched: {launches}")

    # ---- checks of what came out -------------------------------------
    vals, keys = data[:, 0].astype(np.float64), data[:, 1]
    exact = {"mean": [float(vals[keys == g].mean()) for g in range(GB_G)],
             "median": [float(np.median(vals[keys == g]))
                        for g in range(GB_G)]}
    walls = {}
    for name in GB_INNERS:
        out, session, wall = outs[name]
        walls[name] = wall
        est = out.result.reshape(GB_G).cpu()
        summary = keyed_summary(out, session)
        check(not out.fell_back and len(out.reports) == GB_G,
              f"keyed {name} session fell back or has no per-key reports")
        check(bool(torch.isfinite(est).all()), f"keyed {name}: {est}")
        rel = [abs(float(est[g]) - exact[name][g]) / exact[name][g]
               for g in range(GB_G)]
        check(max(rel) < 0.02, f"keyed {name} vs exact per key: rel {rel}")
        summary.update(wall_s=wall, worst_cv=out.cv, max_rel_err=max(rel),
                       cvs=[r.cv for r in out.reports])
        print(f"keyed {name} session (cuda): " + json.dumps(summary))
        cpu, cpu_session, cpu_wall = groupby_session(data, name, "cpu")
        cpu_summary = keyed_summary(cpu, cpu_session)
        same = {k: summary[k] for k in cpu_summary}
        check(cpu_summary == same, f"keyed {name}: cpu {cpu_summary} vs "
              f"cuda {same}")
        # moments agree to f32 rounding; the median comes from histogram
        # counts and is bitwise
        got, want = est, cpu.result.reshape(GB_G)
        if name == "median":
            check(torch.equal(got, want), f"keyed median cuda {got} != "
                  f"cpu {want}")
        check(bool(((got - want).abs() <= 1e-5 * want.abs()).all()),
              f"keyed {name} cuda {got} vs cpu {want}")
        print(f"keyed {name} session (cpu): agrees with the card "
              f"({json.dumps(cpu_summary)}); wall {cpu_wall:.2f} s")

    check(big.thetas.shape == (BIG_B, GB_G, 1)
          and bool(torch.isfinite(big.thetas).all()),
          "keyed bootstrap thetas not finite or of the wrong shape")
    ng_bytes = BOOT_N * GB_G * 4
    check(peak < ng_bytes, f"keyed bootstrap peak {peak} B suggests an "
          f"(n, G) tensor ({ng_bytes} B)")
    print("keyed bootstrap (cuda): " + json.dumps(dict(
        B=BIG_B, n=BOOT_N, G=GB_G, ms=boot_ms, peak_bytes=peak,
        nG_bytes=ng_bytes, weight_draws=BIG_B * BOOT_N,
        cvs=big.report.cvs, worst_key=big.report.worst_key)))
    return launches, log.geometries, walls


def hold_weighted_moments(torch, parity, w, x, what) -> None:
    """Kernel 11 against its plain version under (B, n) weights ``w``:
    w_tot bitwise for whole-number weights (else within 1e-6·Σw), s1 and
    s2 within 1e-5·Σw|x| and 1e-5·Σw·x²."""
    from repro_torch.kernels.weighted_stats.ops import weighted_moments
    from repro_torch.kernels.weighted_stats.ref import weighted_moments_ref
    name = "weighted_moments"
    got, want = weighted_moments(w, x), plain(weighted_moments_ref, w, x)
    wd, xd = w.double(), x.double()
    b1, b2 = wd @ xd.abs(), wd @ (xd * xd)
    if bool((w == w.round()).all()):
        parity.moments(name, got, want, b1, b2, what)
    else:
        parity.within(name, got[0], want[0], 0.1 * wd.sum(1), f"w_tot {what}")
        parity.within(name, got[1], want[1], b1, f"s1 {what}")
        parity.within(name, got[2], want[2], b2, f"s2 {what}")


def hold_weighted_hist(torch, parity, x, w, nbins, what) -> None:
    """Kernel 10 against its plain version: counts bitwise for
    whole-number weights (``w`` None: unit weights), else within
    1e-6·Σ|w| of the row a bin."""
    from repro_torch.kernels.weighted_hist.ops import (weighted_hist_plain,
                                                       weighted_histogram)
    d = x.shape[1]
    lo = torch.full((d,), LO, device="cuda")
    hi = torch.full((d,), HI, device="cuda")
    got = weighted_histogram(x, w, LO, HI, nbins)
    want = plain(weighted_hist_plain, x, None if w is None else w.reshape(
        -1, x.shape[0]), lo, hi, nbins).reshape(got.shape)
    if w is None or bool((w == w.round()).all()):
        parity.bitwise("weighted_histogram", got, want, what)
    else:
        bound = 0.1 * w.double().abs().sum(-1)
        parity.within("weighted_histogram", got, want,
                      bound.reshape(*bound.shape, 1, 1), what)


def phase_parity_materialized(torch, parity: Parity) -> None:
    """Kernels 11 and 10 against their plain versions: B in {1, 7, 256},
    n in {1, 1000, 2^20+37}, d in {1, 3, 8} for kernel 11, and R in
    {1, 256}, d in {1, 4}, nbins in {256, 2048} for kernel 10, with
    whole-number and fractional weights; R = 256 also against 256 one-row
    launches; kernel 10 also with every value in one bin (R in {1, 256}
    and unit weights), at n = 1, 2, 3 (mod 4) and with W a row slice off a
    16-byte boundary, repeat launches bitwise."""
    from repro_torch.kernels.weighted_hist.ops import weighted_histogram
    from repro_torch.kernels.weighted_stats.ops import weighted_moments

    gen = torch.Generator(device="cuda").manual_seed(23)
    for B in (1, 7, BIG_B):
        for n in (1, 1000, BIG_N):
            for d in (1, 3, 8):
                x = torch.randn(n, d, device="cuda", generator=gen) * 2 + 3
                whole = torch.randint(0, 5, (B, n), device="cuda",
                                      generator=gen).float()
                frac = torch.rand(B, n, device="cuda", generator=gen)
                for w, kind in ((whole, "whole"), (frac, "fractional")):
                    hold_weighted_moments(torch, parity, w, x,
                                          f"B={B} n={n} d={d} {kind}")
    again = [weighted_moments(frac, x) for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*again)),
          "weighted_moments repeat runs differ (fractional weights)")
    frac_repeat = []
    for R in (1, BIG_B):
        for d in (1, 4):
            for nbins in (256, NBINS):
                n = BIG_N
                x = torch.randn(n, d, device="cuda", generator=gen) * 6 + 12
                # NaN, +-inf, the bin edges and values past them
                x[:7, 0] = torch.tensor([float("nan"), float("inf"),
                                         -float("inf"), LO, HI, 10 * HI, -HI])
                w = torch.randint(0, 5, (R, n), device="cuda",
                                  generator=gen).float()
                w[:, 100:200] = 0.0
                what = f"R={R} n={n} d={d} nbins={nbins}"
                hold_weighted_hist(torch, parity, x, w, nbins, what)
                hold_weighted_hist(torch, parity, x, w[0], nbins,
                                   f"{what} (n,) weights")
                frac = torch.rand(R, n, device="cuda", generator=gen)
                hold_weighted_hist(torch, parity, x, frac, nbins,
                                   f"{what} fractional")
                frac_repeat.append(torch.equal(
                    weighted_histogram(x, frac, LO, HI, nbins),
                    weighted_histogram(x, frac, LO, HI, nbins)))
                if R == 1:
                    hold_weighted_hist(torch, parity, x, None, nbins,
                                       f"{what} unit weights")
                else:
                    rows = torch.stack([weighted_histogram(
                        x, w[r], LO, HI, nbins) for r in range(R)])
                    check(torch.equal(rows, weighted_histogram(
                        x, w, LO, HI, nbins)), f"R={R} is not {R} one-row "
                        f"launches, {what}")
    # every value in one bin (the most contended adds), n = 1, 2, 3 (mod
    # 4), and W a row slice whose base is off a 16-byte boundary
    whole_repeat = []
    for R in (1, BIG_B):
        x = torch.full((BIG_N, 1), 0.5 * (LO + HI), device="cuda")
        w = torch.randint(0, 5, (R, BIG_N), device="cuda",
                          generator=gen).float()
        hold_weighted_hist(torch, parity, x, w, NBINS,
                           f"R={R} every value in one bin")
        hold_weighted_hist(torch, parity, x, None, NBINS,
                           "unit weights, every value in one bin")
    for n in (BIG_N, BIG_N + 1, BIG_N + 2):
        x = torch.randn(n, 1, device="cuda", generator=gen) * 6 + 12
        big = torch.randint(0, 5, (BIG_B * n + 3,), device="cuda",
                            generator=gen).float()
        for off in (0, 1, 3):
            w = big[off:off + BIG_B * n].reshape(BIG_B, n)
            what = (f"R={BIG_B} n={n} (n mod 4 = {n % 4}), W base "
                    f"{w.data_ptr() % 16} bytes off 16")
            hold_weighted_hist(torch, parity, x, w, NBINS, what)
            whole_repeat.append(torch.equal(
                weighted_histogram(x, w, LO, HI, NBINS),
                weighted_histogram(x, w, LO, HI, NBINS)))
    check(all(whole_repeat), "kernel 10 repeat launches of whole-number "
          "weights differ")
    torch.cuda.synchronize()
    print(f"parity (materialized): both kernels match their plain versions; "
          f"max |err| weighted_moments {parity.err['weighted_moments']}, "
          f"weighted_histogram (fractional) "
          f"{parity.err['weighted_histogram']}; repeat runs bitwise: "
          f"weighted_moments True (fractional), weighted_histogram whole "
          f"True, fractional {frac_repeat}")


def phase_parity_stream(torch, parity: Parity) -> None:
    """Kernel 7 (block_bins) against hist_plain and, where its one window
    fits, against kernel 3, at d in {1, 4, 64}, nbins = 2048 and
    block_bins in {128, 512, 2048}, with the binning's edge values; keyed
    at G = 8, d = 4 against the plain keyed version and the keyed
    histogram, which raises at d = 32; at n = 2^20 + 37, d = 64 (several
    column ranges), with n_valid, and at B = 100.  Kernel 5 (stream=True)
    against kernel 2, bitwise, and the plain version."""
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       grouped_hist_plain,
                                                       hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, moments_plain, prepare)

    name = "fused_poisson_hist_binblocked"
    gen = torch.Generator().manual_seed(29)
    for d, n in ((1, BIG_N), (4, BIG_N), (64, K7_WIDE_N)):
        x = torch.randn(n, d, generator=gen) * 6.0 + 12.0
        x[:6, 0] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                                 HI, 10 * HI, -HI])
        x = x.cuda()
        lo = torch.full((d,), LO, device="cuda")
        hi = torch.full((d,), HI, device="cuda")
        for masked in (False, True):
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
            mask = ((torch.rand(n, generator=gen) > 0.3).float().cuda()
                    if masked else None)
            want = plain(hist_plain, prepare(x, BIG_B, valid_mask=mask),
                         seed, lo, hi, NBINS)[:BIG_B]
            one = (fused_poisson_hist(seed, x, LO, HI, NBINS, BIG_B,
                                      valid_mask=mask) if d <= 4 else None)
            for bb in (128, 512, NBINS):
                what = (f"counts d={d} n={n} block_bins={bb}"
                        f"{' masked' if masked else ''}")
                got = fused_poisson_hist(seed, x, LO, HI, NBINS, BIG_B,
                                         valid_mask=mask, block_bins=bb)
                parity.bitwise(name, got, want, what)
                check(one is None or torch.equal(got, one),
                      f"kernel 7 differs from kernel 3, {what}")
    # keyed: G·d·nbins = 65,536 bins a row.  The keyed histogram keeps one
    # key's d·nbins = 8,192 a row, so it runs here too, bitwise kernel 7;
    # past one key's row of an SM (d·nbins > about 57,800) it raises and
    # names block_bins.
    xk = torch.from_numpy(keyed_rows(K7_WIDE_N, K7_GD, K7_G, seed=3)).cuda()
    x, keys = xk[:, :-1].contiguous(), xk[:, -1].contiguous()
    kw = dict(group_ids=keys, num_groups=K7_G)
    try:
        wide = torch.zeros(1000, K7_PAST_D, device="cuda")
        fused_poisson_hist(1, wide, LO, HI, NBINS, BIG_B,
                           group_ids=torch.zeros(1000, device="cuda"),
                           num_groups=K7_G)
        check(False, "the keyed histogram ran past its shared memory")
    except NotImplementedError as e:
        check("block_bins" in str(e), f"the keyed raise names no "
              f"block_bins: {e}")
    lo = torch.full((K7_GD,), LO, device="cuda")
    hi = torch.full((K7_GD,), HI, device="cuda")
    for masked in (False, True):
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
        mask = ((torch.rand(K7_WIDE_N, generator=gen) > 0.3).float().cuda()
                if masked else None)
        got = fused_poisson_hist(seed, x, LO, HI, NBINS, BIG_B,
                                 valid_mask=mask, block_bins=NBINS, **kw)
        want = plain(grouped_hist_plain, prepare(x, BIG_B, valid_mask=mask,
                                                 **kw), seed, lo, hi, NBINS)
        what = f"keyed G={K7_G} d={K7_GD}{' masked' if masked else ''}"
        parity.bitwise(name, got, want[:BIG_B], what)
        parity.bitwise("fused_poisson_hist_grouped",
                       fused_poisson_hist(seed, x, LO, HI, NBINS, BIG_B,
                                          valid_mask=mask, **kw),
                       want[:BIG_B], what)

    # several column ranges (global-atomic flush) beside one range (plain
    # stores), n_valid, and B = 100 (a row block past the last whole 4)
    from repro_torch.kernels._pass import binblocked_geometry
    ranges_seen = set()
    for B, d, n, n_valid in ((BIG_B, 64, BIG_N, None),
                             (BIG_B, 64, K7_WIDE_N, None),
                             (BIG_B, 4, BIG_N, BIG_N - 1000),
                             (100, 4, 20_000, None)):
        x = (torch.randn(n, d, generator=gen) * 6.0 + 12.0).cuda()
        lo = torch.full((d,), LO, device="cuda")
        hi = torch.full((d,), HI, device="cuda")
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
        pr = prepare(x, B, n_valid=n_valid)
        geo = binblocked_geometry(pr.Bp, pr.np_, pr.bn, d * NBINS, NBINS)
        ranges_seen.add(geo.ranges > 1)
        got = fused_poisson_hist(seed, x, LO, HI, NBINS, B, n_valid=n_valid,
                                 block_bins=NBINS)
        parity.bitwise(name, got, plain(hist_plain, pr, seed, lo, hi,
                                        NBINS)[:B],
                       f"counts B={B} d={d} n={n} n_valid={n_valid} "
                       f"({geo.ranges} ranges, cluster {geo.cluster})")
    check(ranges_seen == {False, True}, "kernel 7's parity did not cover "
          "one column range and several")

    name = "fused_poisson_moments_stream"
    for B in (8, BIG_B):
        for n in (300, 65_536, BIG_N):
            for d in (1, 3, 64):
                xfull = (torch.randn(n + 1, d, generator=gen) * 2.0
                         + 3.0).cuda()
                for masked in (False, True):
                    # masked runs read x at a 4-byte offset: tiles that do
                    # not start on a 16-byte boundary
                    x = xfull[1:] if masked else xfull[:n]
                    seed = int(torch.randint(0, 2 ** 31 - 1, (),
                                             generator=gen))
                    mask = ((torch.rand(n, generator=gen) > 0.3).float()
                            .cuda() if masked else None)
                    what = (f"B={B} n={n} d={d}"
                            f"{' masked, misaligned' if masked else ''}")
                    k2 = fused_poisson_moments(seed, x, B, valid_mask=mask)
                    k5 = fused_poisson_moments(seed, x, B, valid_mask=mask,
                                               stream=True)
                    for a, b, f in zip(k5, k2, ("w_tot", "s1", "s2")):
                        check(torch.equal(a, b), f"kernel 5 {f} differs "
                              f"from kernel 2, {what}")
                    want = [t[:B] for t in plain(
                        moments_plain, prepare(x, B, valid_mask=mask), seed)]
                    bound = plain(moments_plain, prepare(
                        x.abs(), B, valid_mask=mask), seed)[1][:B]
                    parity.moments(name, k5, want, bound, want[2], what)
    torch.cuda.synchronize()
    print(f"parity (streaming slice): kernel 7 matches the plain version "
          f"(and kernel 3 where one window fits), keyed too, over one and "
          f"several column ranges, with n_valid and B = 100; kernel 5 is "
          f"bitwise kernel 2; max |err| kernel 5 "
          f"{parity.err['fused_poisson_moments_stream']}")


class _Die(Exception):
    """The fault-tolerance walk's simulated crash."""


def dying_manager(root: str, after: int):
    """A CheckpointManager that raises _Die right after its ``after``-th
    committed save (examples/fault_tolerance.py's _DyingManager)."""
    from repro_torch.checkpoint import CheckpointManager

    class Dying(CheckpointManager):
        saves = 0

        def save(self, *a, **kw):
            super().save(*a, **kw)
            self.saves += 1
            if self.saves >= after:
                raise _Die

    return Dying(root, async_save=False)


def masked_fold(torch, data, lost, stat, B, key, chunk, device):
    """The degraded run's oracle: bootstrap_chunked's chunk update over
    ``data`` with the ``lost`` row ranges zeroed and masked out; returns
    (thetas, estimate, valid rows)."""
    import numpy as np
    from repro_torch.core.bootstrap import (fused_resample_states,
                                            offset_seed, seed_from_key)
    data = np.array(data, np.float32)
    for lo, hi in lost:
        data[lo:hi] = 0.0
    n, d = data.shape
    states, est = stat.init_batch(d, B, device), stat.init_state(d, device)
    base, valid = seed_from_key(key), 0
    for i in range(-(-n // chunk)):
        rows = data[i * chunk:(i + 1) * chunk]
        xb = np.zeros((chunk, d), np.float32)
        xb[:len(rows)] = rows
        mask = np.zeros(chunk, np.float32)
        mask[:len(rows)] = 1.0
        for lo, hi in lost:
            mask[max(lo - i * chunk, 0):max(min(hi, i * chunk + len(rows))
                                            - i * chunk, 0)] = 0.0
        valid += int(mask.sum())
        x = torch.from_numpy(xb).to(device)
        m = torch.from_numpy(mask).to(device)
        est = stat.update(est, x, m)
        states = stat.merge(states, fused_resample_states(
            stat, offset_seed(base, i), x, B, valid_mask=m))
    p_eff = valid / n
    return (stat.correct(stat.finalize_batch(states), p_eff),
            stat.correct(stat.finalize(est), p_eff), valid)


def report_dict(sr) -> dict:
    """A StreamReport's fields, JSON-ready."""
    out = {k: v for k, v in vars(sr).items() if k != "faults"}
    out["lost_splits"] = list(sr.lost_splits)
    if sr.faults is not None:
        out["faults"] = dict(vars(sr.faults))
    return out


def counted(fn):
    """(fn(), the launches it made per kernel)."""
    before = LaunchLog.counts()
    out = fn()
    after = LaunchLog.counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def main_run(fn):
    """(fn(), the launches per kernel of that run alone): a run of the
    main path, from zeroed counts (a LaunchLog around it goes on logging
    geometries)."""
    zero_counts()
    out = fn()
    return out, LaunchLog.counts()


def add_counts(*runs) -> dict:
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def fault_tolerance_walk(torch):
    """examples/fault_tolerance.py parts 1 to 3 on the card, each held
    bitwise against its oracle, then the walk's Mean and Count on the
    CPU."""
    import tempfile

    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import (Count, Mean, StatisticGroup,
                                  bootstrap_streaming)
    from repro_torch.data import ShardedStore
    from repro_torch.ft import FailurePolicy, Fault, FaultyStore, RetryPolicy

    key = trandom.PRNGKey(0)
    data = np.random.default_rng(1).normal(10.0, 2.0, size=(FT_N, FT_D))
    store = ShardedStore.from_array(data, split_size=FT_SPLIT,
                                    interleave=False)

    def run(s, stat=None, device=None, **kw):
        return bootstrap_streaming(s, stat or Mean(), FT_B, key,
                                   chunk=FT_CHUNK, device=device, **kw)

    def same(a, b, what):
        check(torch.equal(a.thetas, b.thetas)
              and torch.equal(a.estimate, b.estimate),
              f"fault-tolerance walk: {what} not bitwise its oracle")

    reference = run(store)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            run(store, checkpoint=dying_manager(tmp, 6), checkpoint_every=1)
            check(False, "the dying checkpoint manager did not die")
        except _Die:
            pass
        resumed = run(store, resume=True, checkpoint=CheckpointManager(tmp))
    check(resumed.stream.resumed_from_chunk == 6, "resume did not pick up "
          f"at chunk 6: {resumed.stream.resumed_from_chunk}")
    same(resumed, reference, "the resumed run")
    flaky = FaultyStore(store, [
        Fault(split=1, kind="io", attempts=2),
        Fault(split=4, kind="corrupt", attempts=1),
        Fault(split=7, kind="latency", attempts=1, latency_s=0.2)])
    transient = run(flaky, retry=RetryPolicy(max_attempts=4,
                                             base_delay=0.01, timeout=0.05))
    same(transient, reference, "the transient-fault run")
    f = transient.stream.faults
    check((f.io_errors, f.checksum_failures) == (2, 1)
          and f.deadline_misses >= 1, f"fault counters {vars(f)}")
    dead = FaultyStore(store, [Fault(split=3, kind="io", permanent=True)])
    degraded = run(dead, policy=FailurePolicy(
        retry=RetryPolicy(max_attempts=3, base_delay=0.0),
        on_exhausted="degrade"))
    lost = [(int(store.offsets[3]), int(store.offsets[4]))]
    thetas, est, valid = masked_fold(torch, store.read_all(), lost, Mean(),
                                     FT_B, key, FT_CHUNK, "cuda")
    check(degraded.stream.lost_splits == (3,)
          and degraded.stream.valid_rows == valid == FT_N - FT_SPLIT,
          f"degraded run lost {degraded.stream.lost_splits}, "
          f"{degraded.stream.valid_rows} valid rows")
    check(torch.equal(degraded.thetas, thetas)
          and torch.equal(degraded.estimate, est),
          "the degraded run is not bitwise its masked oracle")
    p_eff = degraded.stream.valid_rows / FT_N
    # the walk's Mean and Count (w_tot) on the card and the CPU
    group = StatisticGroup((Mean(), Count()))
    card, cpu = run(store, group), run(store, group, device="cpu")
    bound = 1e-5 * run(ShardedStore.from_array(np.abs(data), FT_SPLIT,
                                               interleave=False),
                       device="cpu").thetas
    check(torch.equal(card.thetas[0], reference.thetas),
          "the group's Mean member differs from the dedicated run")
    check(torch.equal(card.thetas[1].cpu(), cpu.thetas[1]),
          "w_tot of the walk differs between the card and the CPU")
    diff = (card.thetas[0].cpu() - cpu.thetas[0]).abs()
    check(bool((diff <= bound).all()), f"Mean thetas card vs CPU differ by "
          f"{float(diff.max())}")
    summary = dict(
        rows=FT_N, d=FT_D, B=FT_B, chunk=FT_CHUNK,
        estimate=float(reference.estimate.reshape(-1)[0]),
        kill_resume=dict(resumed_from_chunk=resumed.stream.resumed_from_chunk,
                         bitwise=True),
        transient=dict(faults=dict(vars(f)), bitwise=True),
        degraded=dict(lost_splits=list(degraded.stream.lost_splits),
                      valid_rows=degraded.stream.valid_rows, p_eff=p_eff,
                      cv=degraded.report.cv, cv_full=reference.report.cv,
                      bitwise_masked_oracle=True),
        cpu=dict(w_tot_bitwise=True, mean_max_abs_diff=float(diff.max())))
    print("fault-tolerance walk (cuda, cpu): " + json.dumps(summary))


def state_bytes(stat, dim: int, B: int) -> int:
    """Bytes of B resample states and the estimate of ``stat``."""
    from repro_torch.checkpoint.manager import _leaves
    return sum(t.numel() * t.element_size() for _, t in _leaves(
        (stat.init_batch(dim, B, "cpu"), stat.init_state(dim, "cpu"))))


def stream_real_size(torch):
    """The README's 64-column streaming store at 2^22 rows (1 GiB) and
    2^20: a streamed Mean (kernel 2 each chunk) and Quantile(block_bins)
    (kernel 7 each chunk), bitwise bootstrap_chunked over store.read_all()
    on the card, a kill and resume of the Quantile at 2^22 and a rerun of
    it under torch.profiler (kernel 7's summed card time beside the wall
    and the stage), kernel 5 over the Mean's chunks, and the peak device
    memory above the resident state at both sizes."""
    import tempfile

    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import (Mean, Quantile, bootstrap_chunked,
                                  bootstrap_streaming, offset_seed,
                                  seed_from_key)
    from repro_torch.data import ShardedStore
    from repro_torch.kernels.weighted_stats.ops import fused_poisson_moments

    data = np.random.default_rng(42).standard_normal(
        (max(ST_NS), ST_D), dtype=np.float32)
    key = trandom.PRNGKey(7)
    stats = {"Mean": (Mean(), "fused_poisson_moments"),
             "Quantile": (Quantile(0.5, NBINS, ST_LO, ST_HI,
                                   block_bins=NBINS),
                          "fused_poisson_hist_binblocked")}
    peaks = {}
    for n in ST_NS:
        store = ShardedStore.from_array(data[:n], split_size=ST_SPLIT,
                                        interleave=False)
        xdev = torch.from_numpy(store.read_all()).cuda()
        for name, (stat, kernel) in stats.items():
            def stream(**kw):
                return bootstrap_streaming(store, stat, ST_B, key,
                                           chunk=ST_CHUNK, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            res, launches = counted(stream)
            peak = torch.cuda.max_memory_allocated() - base
            resident = state_bytes(stat, ST_D, ST_B)
            peaks[(name, n)] = peak - resident
            n_chunks = res.stream.n_chunks
            check(launches.get(kernel) == n_chunks, f"streamed {name} at "
                  f"n={n} launched {launches}, not {kernel} once per chunk "
                  f"({n_chunks})")
            want = bootstrap_chunked(xdev, stat, ST_B, key, chunk=ST_CHUNK,
                                     backend="fused_rng")
            check(torch.equal(res.thetas, want.thetas)
                  and torch.equal(res.estimate, want.estimate),
                  f"streamed {name} at n={n} is not bitwise "
                  f"bootstrap_chunked")
            check(bool(torch.isfinite(res.thetas).all())
                  and res.thetas.shape == (ST_B, ST_D),
                  f"streamed {name} thetas")
            rec = dict(name=name, n=n, d=ST_D, B=ST_B, chunk=ST_CHUNK,
                       report=report_dict(res.stream), launches=launches,
                       peak_above_state_bytes=peak - resident,
                       state_bytes=resident, nd_bytes=n * ST_D * 4,
                       cv=res.report.cv, bitwise_chunked=True)
            if name == "Mean":
                # kernel 5's entry point over the same chunks: its folded
                # moments are the streamed Mean's state, so its thetas
                seed = seed_from_key(key)
                ones = torch.ones(ST_CHUNK, device="cuda")
                acc = [torch.zeros(ST_B, device="cuda"),
                       torch.zeros(ST_B, ST_D, device="cuda"),
                       torch.zeros(ST_B, ST_D, device="cuda")]
                for i in range(n // ST_CHUNK):
                    part = fused_poisson_moments(
                        offset_seed(seed, i),
                        xdev[i * ST_CHUNK:(i + 1) * ST_CHUNK], ST_B,
                        valid_mask=ones, stream=True)
                    acc = [a + b for a, b in zip(acc, part)]
                check(torch.equal(stat.finalize_batch(stat.from_moments(
                    *acc)), res.thetas), "kernel 5 over the chunks is not "
                    "the streamed Mean")
            if name == "Quantile" and n == max(ST_NS):
                with tempfile.TemporaryDirectory() as tmp:
                    try:
                        stream(checkpoint=dying_manager(tmp, ST_KILL_AFTER),
                               checkpoint_every=ST_CKPT_EVERY)
                        check(False, "the dying manager did not die")
                    except _Die:
                        pass
                    resumed = stream(resume=True,
                                     checkpoint_every=ST_CKPT_EVERY,
                                     checkpoint=CheckpointManager(tmp))
                check(resumed.stream.resumed_from_chunk
                      == ST_KILL_AFTER * ST_CKPT_EVERY
                      and torch.equal(resumed.thetas, res.thetas)
                      and torch.equal(resumed.estimate, res.estimate),
                      "the resumed Quantile stream is not bitwise the "
                      "uninterrupted one")
                rec["kill_resume"] = report_dict(resumed.stream)
                rec["pace"] = stream_pace(torch, stream, res.stream)
            print("streamed bootstrap (cuda): " + json.dumps(rec))
        del xdev, store
    for name in stats:
        big, small = (peaks[(name, n)] for n in ST_NS)
        check(abs(big - small) <= 0.05 * max(big, small),
              f"streamed {name}: peak above the state {big} B at "
              f"n={ST_NS[0]} vs {small} B at n={ST_NS[1]}")
        check(big < ST_NS[0] * ST_D * 4 / 2, f"streamed {name}: peak "
              f"{big} B is not far below the store ({ST_NS[0] * ST_D * 4})")


def stream_pace(torch, stream, measured) -> dict:
    """What sets the streamed Quantile's pace: the summed card time of
    kernel 7 over its chunks (and of every kernel and copy, their union)
    in one more streamed run under torch.profiler, beside the wall and the
    stage (the pinned host copies) of that run and of the measured one."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = stream()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    k7 = [b - a for a, b, name in spans if "binblocked_kernel" in name]
    busy_us, end = 0.0, -math.inf
    for a, b, _ in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    # the profiler may drop kernel records: scale its mean launch to the
    # chunks, and say how many it saw
    check(len(k7) > 0, "the profiler saw no launch of kernel 7")
    out = dict(kernel7_launches_seen=len(k7),
               kernel7_card_s=sum(k7) / len(k7) * res.stream.n_chunks * 1e-6,
               card_busy_s=busy_us * 1e-6,
               profiled_wall_s=res.stream.wall_s,
               profiled_stage_s=res.stream.stage_s,
               measured_wall_s=measured.wall_s,
               measured_stage_s=measured.stage_s)
    lead = max(("kernel 7", out["kernel7_card_s"]),
               ("the card", out["card_busy_s"]),
               ("the staging", out["measured_stage_s"]), key=lambda t: t[1])
    print(f"streamed Quantile's pace: kernel 7 {out['kernel7_card_s']:.4f} s "
          f"of card time over {res.stream.n_chunks} chunks ({len(k7)} "
          f"launches seen by the profiler), the card busy "
          f"{out['card_busy_s']:.4f} s; wall {measured.wall_s:.4f} s and "
          f"stage {measured.stage_s:.4f} s (profiled run: "
          f"{res.stream.wall_s:.4f} s, {res.stream.stage_s:.4f} s): "
          f"{lead[0]} sets the pace")
    return out


def phase_stream_path(torch):
    """The streaming path from zeroed launch counts with its geometries
    logged; returns the counts and the geometries."""
    torch.cuda.synchronize()
    zero_counts()
    with LaunchLog() as log:
        fault_tolerance_walk(torch)
        stream_real_size(torch)
    launches = log.counts()
    print(f"streaming path launches: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in STREAM_KERNELS),
          f"a kernel of the streaming path was not launched: {launches}")
    return launches, log.geometries


def materialized_session(data, device):
    """The quickstart group's EarlSession with the JAX package's default
    backend (None: materialized Poisson weights) on ``device``."""
    from repro_torch import random as trandom
    from repro_torch.core import (EarlSession, Mean, Quantile,
                                  StatisticGroup, Std)
    from repro_torch.data import PreMapSampler, ShardedStore
    store = ShardedStore.from_array(data, split_size=65_536)
    group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
    return EarlSession(PreMapSampler(store, seed=1, device=device), group,
                       sigma=0.05, device=device).run(trandom.PRNGKey(0))


def timed(torch, fn):
    """(result, wall s, peak bytes above what was allocated before) of
    ``fn()`` on the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def mdb_run(stat, rows, device):
    """fig10's multinomial delta baseline: B = 16, two extends."""
    from repro_torch.core import MultinomialDeltaBootstrap
    m = MultinomialDeltaBootstrap(stat, MDB_B, seed=11, device=device)
    m.extend(rows[:MDB_ROWS])
    m.extend(rows[MDB_ROWS:])
    return m, m.result()


def phase_materialized_path(torch):
    """The materialized path (the JAX package's default backend=None),
    from zeroed launch counts with its geometries logged: the default
    quickstart session, bootstraps over a 1 GiB weight matrix (Mean with
    and without kernel 11, Median through kernel 10 at R = 256), fig10's
    delta extends and multinomial baseline, fig3's shared-base bootstrap
    and the chunked bootstrap with both backends.  Returns the counts and
    the logged geometries."""
    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.core import (Mean, Median, Quantile, StatisticGroup,
                                  Std, bootstrap, bootstrap_chunked,
                                  poisson_delta_extend, poisson_delta_init,
                                  poisson_delta_result, poisson_weights,
                                  shared_base_bootstrap)
    from repro_torch.data import synthetic_numeric
    from repro_torch.kernels.weighted_hist.ops import weighted_histogram
    from repro_torch.kernels.weighted_stats.ops import weighted_moments

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "f32 matmuls are not IEEE on the materialized path")
    data = synthetic_numeric(QUICKSTART_N, mean=10.0, std=2.0, seed=0)
    exact = (float(data.mean()), float(np.median(data)), float(data.std()))
    xm = torch.from_numpy(synthetic_numeric(MAT_N, seed=21)).cuda()
    x10 = torch.from_numpy(synthetic_numeric(FIG10_N, 10.0, 2.0,
                                             seed=9)).cuda()
    mdb_rows = synthetic_numeric(2 * MDB_ROWS, 10.0, 2.0, seed=10)
    x3 = synthetic_numeric(SB_N, 10.0, 2.0, seed=1)
    xc = torch.from_numpy(synthetic_numeric(CHUNK_N, seed=22)).cuda()
    med = Median(lo=LO, hi=HI)
    key = trandom.PRNGKey(31)
    torch.cuda.synchronize()
    zero_counts()
    boots = {}
    with LaunchLog() as log:
        out, wall, _ = timed(torch, lambda: materialized_session(data, None))
        session_hist = weighted_histogram.launches
        for label, stat, uk in (("Mean use_kernel", Mean(), True),
                                ("Mean", Mean(), False),
                                ("Median", med, False)):
            boots[label] = timed(torch, lambda: bootstrap(
                xm, stat, MAT_B, key, use_kernel=uk))
        half = FIG10_N // 2

        def fig10():
            pd = poisson_delta_init(Mean(), FIG10_B, 1, trandom.PRNGKey(6))
            pd = poisson_delta_extend(pd, x10[:half])
            return poisson_delta_result(poisson_delta_extend(pd, x10[half:]))
        f10, f10_wall, f10_peak = timed(torch, fig10)
        mdbs = {name: mdb_run(stat, mdb_rows, None)
                for name, stat in (("mean", Mean()), ("median", med))}
        sb, sb_wall, _ = timed(torch, lambda: shared_base_bootstrap(
            x3, med, SB_B, trandom.PRNGKey(4)))
        group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
        chunked = {be: timed(torch, lambda be=be: bootstrap_chunked(
            xc, group, CHUNK_B, trandom.PRNGKey(33), chunk=CHUNK,
            backend=be)) for be in (None, "fused_rng")}
    launches = log.counts()
    print(f"materialized path launches: {json.dumps(launches)} (default "
          f"session: weighted_histogram x{session_hist})")
    check(all(launches[k] > 0 for k in MATERIALIZED_KERNELS),
          f"a kernel of the materialized path was not launched: {launches}")

    # ---- the default session, on the card and the CPU -----------------
    names = ("mean", "median", "std")
    summary = dict(B=out.B, iterations=out.iterations, n_used=out.n_used,
                   worst_cv=out.cv, wall_s=wall, fell_back=out.fell_back,
                   weighted_histogram_launches=session_hist, members={})
    for name, res, ex in zip(names, out.result, exact):
        est = float(torch.as_tensor(res).reshape(-1)[0])
        rel = abs(est - ex) / abs(ex)
        summary["members"][name] = dict(estimate=est, exact=ex, rel_err=rel)
        check(math.isfinite(est) and rel < 0.02,
              f"default session {name}: estimate {est} vs exact {ex}")
    check(session_hist > 0, "the default session launched no "
          "weighted_histogram kernel")
    print("default session (cuda): " + json.dumps(summary))
    cpu = materialized_session(data, "cpu")
    check((cpu.B, cpu.n_used, cpu.iterations)
          == (out.B, out.n_used, out.iterations),
          f"default session: cpu took (B, n_used, iterations) = "
          f"{(cpu.B, cpu.n_used, cpu.iterations)}, cuda "
          f"{(out.B, out.n_used, out.iterations)}")
    for name, a, b in zip(names, out.result, cpu.result):
        a, b = float(a.reshape(-1)[0]), float(b.reshape(-1)[0])
        if name == "median":
            check(a == b, f"default session median cuda {a} != cpu {b}")
        rtol = 26e-5 if name == "std" else 1e-5
        check(abs(a - b) <= rtol * abs(b),
              f"default session {name} cuda {a} vs cpu {b}")
    print(f"default session (cpu): B={cpu.B} iterations={cpu.iterations} "
          f"n_used={cpu.n_used}: agrees with the card")

    # ---- the B = 256 bootstraps over a 1 GiB weight matrix --------------
    # the Knuth draw alone: its own time and peak; its weights are the
    # bootstraps' (same key), for the bound of the use_kernel comparison
    w, draw_wall, draw_peak = timed(torch, lambda: poisson_weights(
        key, MAT_B, MAT_N, device="cuda"))
    x2 = xm.reshape(MAT_N, -1)
    # the card's logf against the CPU's log: the share of equal weights
    shape = (64, 1 << 16)
    w_cpu = poisson_weights(key, *shape, device="cpu")
    unequal = int((poisson_weights(key, *shape, device="cuda").cpu()
                   != w_cpu).sum())
    check(unequal <= 1e-4 * w_cpu.numel(), f"{unequal} Poisson weights "
          f"differ between the card and the CPU")
    print(f"Poisson(1) weights, card against CPU: {unequal} of "
          f"{w_cpu.numel()} differ (share equal "
          f"{1 - unequal / w_cpu.numel()})")
    k11_ms = time_ms(torch, lambda: weighted_moments(w, x2), 5)
    k10_ms = time_ms(torch, lambda: weighted_histogram(x2, w, LO, HI, NBINS),
                     5)
    wd = w.double()
    theta_bound = 1e-5 * (wd @ x2.double().abs())[:, 0] / wd.sum(1)
    tk, tp = (boots[k][0].thetas[:, 0] for k in ("Mean use_kernel", "Mean"))
    diff = (tk.double() - tp.double()).abs()
    check(bool((diff <= theta_bound).all()), f"Mean thetas with and without "
          f"kernel 11 differ by up to {float(diff.max())}")
    w_bytes = MAT_B * MAT_N * 4
    for label, (res, bwall, peak) in boots.items():
        th = res.thetas
        check(th.shape[0] == MAT_B and bool(torch.isfinite(th).all()),
              f"{label} bootstrap thetas")
        check(peak < 4 * w_bytes, f"{label} bootstrap peak {peak} B, over "
              f"four (B, n) weight matrices")
        print(f"materialized bootstrap {label} (cuda): " + json.dumps(dict(
            B=MAT_B, n=MAT_N, wall_s=bwall, peak_bytes=peak,
            weight_bytes=w_bytes, cv=res.cv,
            kernel="weighted_moments" if label == "Mean use_kernel" else
            "weighted_histogram" if label == "Median" else "cuBLAS W @ x",
            kernel_ms=k11_ms if label == "Mean use_kernel" else
            k10_ms if label == "Median" else None)))
    print("Knuth Poisson(1) draw (cuda): " + json.dumps(dict(
        B=MAT_B, n=MAT_N, wall_s=draw_wall, peak_bytes=draw_peak,
        weight_bytes=w_bytes, mean=float(w.mean()), var=float(w.var()),
        max_abs_theta_diff_kernel_vs_matmul=float(diff.max()))))
    del w, wd

    # ---- fig10 and fig3 shapes -----------------------------------------
    est = float(f10.estimate.reshape(-1)[0])
    ex10 = float(x10.double().mean())
    check(bool(torch.isfinite(f10.thetas).all())
          and abs(est - ex10) <= 1e-5 * abs(ex10),
          f"fig10 delta estimate {est} vs {ex10}")
    print("fig10 materialized delta (cuda): " + json.dumps(dict(
        B=FIG10_B, n=FIG10_N, extends=2, wall_s=f10_wall,
        peak_bytes=f10_peak, cv=f10.cv)))
    for name, stat in (("mean", Mean()), ("median", med)):
        m, res = mdbs[name]
        mc, rc = mdb_run(stat, mdb_rows, "cpu")
        check((m.disk_accesses, m.items_moved, m.n)
              == (mc.disk_accesses, mc.items_moved, mc.n)
              and all(np.array_equal(a, b)
                      for a, b in zip(m.resamples, mc.resamples)),
              f"multinomial delta {name}: resamples or counts differ "
              f"between the card and the CPU")
        got, want = res.thetas.cpu(), rc.thetas
        if name == "median":
            check(torch.equal(got, want), "multinomial delta median thetas "
                  "differ between the card and the CPU")
        check(bool(((got - want).abs() <= 1e-5 * want.abs()).all()),
              f"multinomial delta {name} thetas cuda vs cpu")
        print(f"fig10 multinomial delta {name}: " + json.dumps(dict(
            B=MDB_B, rows=2 * MDB_ROWS, disk_accesses=m.disk_accesses,
            items_moved=m.items_moved, cv=res.cv,
            cpu_agrees=True)))
    sb_cpu = shared_base_bootstrap(x3, med, SB_B, trandom.PRNGKey(4),
                                   device="cpu")
    check(torch.equal(sb.thetas.cpu(), sb_cpu.thetas),
          "shared-base median thetas differ between the card and the CPU")
    print("fig3 shared-base bootstrap (cuda): " + json.dumps(dict(
        B=SB_B, n=SB_N, wall_s=sb_wall, cv=sb.cv, cpu_agrees=True)))
    (cn, cn_wall, cn_peak), (cf, cf_wall, cf_peak) = (
        chunked[None], chunked["fused_rng"])
    for a, b in zip(cn.estimate, cf.estimate):
        check(torch.equal(a, b), "chunked estimates differ between backends")
    for t in cn.thetas + cf.thetas:
        check(bool(torch.isfinite(t).all()), "chunked thetas not finite")
    ratios = [a / b for a, b in zip(cn.report.cvs, cf.report.cvs)]
    check(all(0.5 < r < 2.0 for r in ratios),
          f"chunked cvs of the two backends differ: {ratios}")
    print("bootstrap_chunked (cuda): " + json.dumps(dict(
        B=CHUNK_B, n=CHUNK_N, chunk=CHUNK, none=dict(
            wall_s=cn_wall, peak_bytes=cn_peak, cvs=cn.report.cvs),
        fused_rng=dict(wall_s=cf_wall, peak_bytes=cf_peak,
                       cvs=cf.report.cvs))))
    return launches, log.geometries


def replay_materialized(torch, parity, gen, name, fields, what) -> None:
    """One launch geometry of kernel 10 or 11 on fresh data (whole-number
    weights) against the plain version."""
    g = dict(fields)
    rows = g["B"] if name == "weighted_moments" else g["R"]
    x = (torch.rand(g["n"], g["d"], generator=gen) * (HI - LO) + LO).cuda()
    w = torch.randint(0, 5, (rows, g["n"]), generator=gen).float().cuda()
    with LaunchLog() as log:
        if name == "weighted_moments":
            hold_weighted_moments(torch, parity, w, x, what)
        else:
            hold_weighted_hist(torch, parity, x, None if g["unit"] else
                               w[0] if rows == 1 else w, g["nbins"], what)
    check((name, fields) in log.geometries, f"{what}: launched "
          f"{list(log.geometries)}")


def phase_replay(torch, geometries, parity: Parity) -> None:
    """Holds every kernel against its plain version at each launch
    geometry of the main path, on fresh data: x is uniform on [LO, HI), so
    x >= 0 and the plain s1 is Σw|x|."""
    from repro_torch.core.reduce_api import (Mean, MomentState, Quantile,
                                             StatisticGroup, Std)
    from repro_torch.kernels.fused_multi.ops import (_multi_scan,
                                                     fused_poisson_multi)
    from repro_torch.kernels.poisson_counts.ops import (poisson_counts,
                                                        poisson_tiles)
    from repro_torch.kernels.poisson_counts.ref import (poisson_weights_plain,
                                                        weight_block)
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, moments_plain, prepare)

    gen = torch.Generator().manual_seed(13)
    gen_cuda = torch.Generator(device="cuda").manual_seed(13)
    lo = torch.full((1,), LO, device="cuda")
    hi = torch.full((1,), HI, device="cuda")
    shapes = {}

    def one(name, fields, count):
        g = dict(fields)
        Bp, np_ = g.get("Bp"), g.get("np_")
        what = f"replay of {count} main-path launch(es) at {g}"
        if name in MATERIALIZED_KERNELS:
            shapes.setdefault(name, []).append((g.get("B", g.get("R")),
                                                g["n"]))
            replay_materialized(torch, parity, gen, name, fields, what)
            return
        if name in ("flash_attention", "flash_attention_bwd"):
            shapes.setdefault(name, []).append((g["BHq"], g["Sq"], g["Skv"],
                                                g["D"]))
            (replay_attention if name == "flash_attention"
             else replay_attention_bwd)(torch, parity, gen_cuda, fields,
                                        what)
            return
        if name in ("fused_poisson_moments_stream",
                    "fused_poisson_hist_binblocked"):
            shapes.setdefault(name, []).append((Bp, np_))
            replay_stream(torch, parity, gen, name, fields, what)
            return
        shapes.setdefault(name, []).append(
            (g["n"], g["k"], g["d"]) if name == "kmeans_assign"
            else (Bp, np_))
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
        if name in GROUPBY_KERNELS:
            replay_grouped(torch, parity, gen, seed, name, fields, what)
            return
        if name in KMEANS_KERNELS:
            # the plain versions launch nothing, so the log sees only the
            # kernel's launch
            x, cent = km_data(torch, g.get("n", np_), g["k"], g["d"], seed)
            with LaunchLog() as log:
                if name == "kmeans_assign":
                    hold_kmeans_assign(parity, x,
                                       int_weights(torch, g["n"], gen),
                                       cent, what)
                else:
                    mask = None
                    if g["masked"]:
                        mask = (torch.rand(np_, generator=gen) > 0.3
                                ).float().cuda()
                    hold_fused_kmeans(parity, seed, x, cent, Bp, what,
                                      n_valid=g["n_valid"], valid_mask=mask)
            check((name, fields) in log.geometries, f"{what}: launched "
                  f"{list(log.geometries)}")
            return
        if name == "poisson_counts" and g["offset"]:
            # a chunk of the tiled scan: n-tiles from an offset
            t0, t1 = 5, 5 + np_ // g["bn"]
            with LaunchLog() as log:
                w_k = poisson_tiles(seed, np_ * 4, Bp, g["bb"], g["bn"], t0,
                                    t1, device="cuda")
            check((name, fields) in log.geometries, f"{what}: launched "
                  f"{list(log.geometries)}")
            parity.bitwise(name, w_k, plain(
                weight_block, seed, np_ * 4, Bp, g["bb"], g["bn"], t0, t1,
                device="cuda"), what)
            return
        if name == "poisson_counts":
            with LaunchLog() as log:
                w_k = poisson_counts(seed, Bp, np_, device="cuda")
            check((name, fields) in log.geometries, f"{what}: launched "
                  f"{list(log.geometries)}")
            parity.bitwise(name, w_k, plain(
                poisson_weights_plain, seed, Bp, np_, g["bb"], g["bn"],
                device="cuda"), what)
            return
        d = g["d"]
        x = (torch.rand(np_, d, generator=gen) * (HI - LO) + LO).cuda()
        mask = None
        if g["masked"]:
            mask = (torch.rand(np_, generator=gen) > 0.3).float().cuda()
        kw = dict(n_valid=g["n_valid"], valid_mask=mask)
        pr = prepare(x, Bp, **kw)
        check(g["n_hist"] <= 1 and g["hist_total"] % d == 0,
              f"{what}: the replay covers at most one histogram slot")
        nbins = g["hist_total"] // d
        stats = []
        if g["moments"]:
            stats += [Mean(), Std()]
        if g["n_hist"]:
            stats.insert(1, Quantile(0.5, nbins=nbins, lo=LO, hi=HI))
        group = StatisticGroup(tuple(stats))
        with LaunchLog() as log:
            if g["moments"]:
                mom_k = fused_poisson_moments(seed, x, Bp, **kw)
            if g["n_hist"]:
                h_k = fused_poisson_hist(seed, x, LO, HI, nbins, Bp, **kw)
            if name == "fused_poisson_multi":
                g_k = fused_poisson_multi(group, seed, x, Bp, **kw)
        check((name, fields) in log.geometries, f"{what}: launched "
              f"{list(log.geometries)}")
        if name == "fused_poisson_moments":
            want = plain(moments_plain, pr, seed)
            parity.moments(name, mom_k, want, want[1], want[2], what)
        elif name == "fused_poisson_hist":
            parity.bitwise(name, h_k,
                           plain(hist_plain, pr, seed, lo, hi, nbins), what)
        else:
            for sk, sp in zip(g_k, plain(_multi_scan, group.slots, seed, pr)):
                if isinstance(sk, MomentState):
                    parity.moments(name, (sk.w, sk.s1, sk.s2),
                                   (sp.w, sp.s1, sp.s2), sp.s1, sp.s2, what)
                    ded, got = mom_k, (sk.w, sk.s1, sk.s2)
                else:
                    parity.bitwise(name, sk.counts, sp.counts, what)
                    ded, got = (h_k,), (sk.counts,)
                for a, b in zip(got, ded):
                    check(bool((a == b).all()), f"{what}: a group member "
                          "differs from the dedicated kernel")
    seconds = []
    for (name, fields), count in sorted(geometries.items(), key=str):
        t0 = time.perf_counter()
        one(name, fields, count)
        torch.cuda.synchronize()
        seconds.append((time.perf_counter() - t0, name, dict(fields)))
    torch.cuda.synchronize()
    print(f"replay: {sum(len(v) for v in shapes.values())} main-path launch "
          f"geometries match their plain versions; (Bp, np), (n, k, d) "
          f"for kmeans_assign, (rows, n) for the explicit-weight kernels, "
          f"or (B·Hq, Sq, Skv, D) for flash_attention, per kernel "
          f"{json.dumps(shapes)}")
    seconds.sort(key=lambda r: -r[0])
    print(f"replay seconds: {sum(r[0] for r in seconds):.1f} s over "
          f"{len(seconds)} geometries, the longest first: "
          + json.dumps([[round(t, 3), n, g] for t, n, g in seconds]))


def replay_grouped(torch, parity, gen, seed, name, fields, what) -> None:
    """One GROUP BY launch geometry on fresh data (x uniform on [LO, HI),
    so the plain s1 is Σw|x|) against the plain version."""
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       grouped_hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, grouped_moments_plain, prepare)
    g = dict(fields)
    Bp, np_, d, G = g["Bp"], g["np_"], g["d"], g["G"]
    x = (torch.rand(np_, d, generator=gen) * (HI - LO) + LO).cuda()
    keys = torch.randint(0, G, (np_,), generator=gen).float().cuda()
    mask = None
    if g["masked"]:
        mask = (torch.rand(np_, generator=gen) > 0.3).float().cuda()
    kw = dict(n_valid=g["n_valid"], valid_mask=mask, group_ids=keys,
              num_groups=G)
    pr = prepare(x, Bp, **kw)
    with LaunchLog() as log:
        if g["moments"]:
            got = fused_poisson_moments(seed, x, Bp, **kw)
        else:
            got = fused_poisson_hist(seed, x, LO, HI, g["nbins"], Bp, **kw)
    check((name, fields) in log.geometries, f"{what}: launched "
          f"{list(log.geometries)}")
    if g["moments"]:
        want = plain(grouped_moments_plain, pr, seed)
        parity.moments(name, got, want, want[1], want[2], what)
    else:
        lo = torch.full((d,), LO, device="cuda")
        hi = torch.full((d,), HI, device="cuda")
        parity.bitwise(name, got, plain(grouped_hist_plain, pr, seed, lo,
                                        hi, g["nbins"]), what)


def replay_stream(torch, parity, gen, name, fields, what) -> None:
    """One launch geometry of kernel 5 or 7 on fresh data (x uniform on
    [LO, HI), so the plain s1 is Σw|x|) against the plain version."""
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       grouped_hist_plain,
                                                       hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, moments_plain, prepare)
    g = dict(fields)
    Bp, np_, d = g["Bp"], g["np_"], g["d"]
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
    x = (torch.rand(np_, d, generator=gen) * (HI - LO) + LO).cuda()
    mask = None
    if g["masked"]:
        mask = (torch.rand(np_, generator=gen) > 0.3).float().cuda()
    kw = dict(n_valid=g["n_valid"], valid_mask=mask)
    if g.get("keyed"):
        kw.update(group_ids=torch.randint(0, g["G"], (np_,), generator=gen)
                  .float().cuda(), num_groups=g["G"])
    pr = prepare(x, Bp, **kw)
    with LaunchLog() as log:
        if name == "fused_poisson_moments_stream":
            got = fused_poisson_moments(seed, x, Bp, stream=True, **kw)
        else:
            got = fused_poisson_hist(seed, x, LO, HI, g["nbins"], Bp,
                                     block_bins=g["width"], **kw)
    check((name, fields) in log.geometries, f"{what}: launched "
          f"{list(log.geometries)}")
    if name == "fused_poisson_moments_stream":
        want = plain(moments_plain, pr, seed)
        parity.moments(name, got, want, want[1], want[2], what)
    else:
        lo = torch.full((d,), LO, device="cuda")
        hi = torch.full((d,), HI, device="cuda")
        run = grouped_hist_plain if g.get("keyed") else hist_plain
        parity.bitwise(name, got, plain(run, pr, seed, lo, hi, g["nbins"]),
                       what)


def stream_rows(torch, launches, parity: Parity):
    """Kernel rows of kernels 5 and 7: kernel 5 beside kernel 2 at B = 256,
    n = 2^20 + 37, d = 1; kernel 7 at the streamed Quantile's chunk (B =
    256, n = 65,536, d = 64, nbins = block_bins = 2048).  Both are bound by
    the hash, one a weight; kernel 7 draws each weight once (the design
    before drew it once per window its column lands in, 64 here), and its
    cost terms beside the hash are printed."""
    import numpy as np
    from repro_torch.kernels._pass import binblocked_geometry
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, moments_plain, prepare)

    B, n, seed = BIG_B, BIG_N, 2027
    x = (torch.randn(n, 1, generator=torch.Generator().manual_seed(3))
         * 2.0 + 10.0).cuda()
    pr = prepare(x, B)
    xq = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (ST_CHUNK, ST_D), dtype=np.float32)).cuda()
    prq = prepare(xq, B)
    lo = torch.full((ST_D,), ST_LO, device="cuda")
    hi = torch.full((ST_D,), ST_HI, device="cuda")
    geo = binblocked_geometry(prq.Bp, prq.np_, prq.bn, ST_D * NBINS, NBINS)
    windows = geo.windows
    rowblocks = -(-prq.Bp // geo.rows)
    terms = dict(
        geometry=geo._asdict(), ctas=rowblocks * geo.ranges * geo.cluster,
        smem_bytes=geo.smem_bytes(prq.bn), weights_hashed=B * ST_CHUNK,
        draws_a_weight=1, draws_a_weight_before=windows,
        shared_adds_expected=round((1 - math.exp(-1)) * B * ST_CHUNK * ST_D),
        bin_index_evaluations=rowblocks * geo.ranges * ST_CHUNK * ST_D,
        flush_operations=geo.ranges * prq.Bp * ST_D * NBINS,
        flush="plain stores" if geo.ranges == 1 else "global atomics",
        x_bytes_read=ST_CHUNK * ST_D * 4,
        counts_bytes_written=prq.Bp * ST_D * NBINS * 4,
        dsmem_bytes_read=rowblocks * geo.ranges * geo.cluster * len(
            geo.windows_of(0)) * (geo.cluster - 1) * 16 * -(
                -geo.tiles_per_cta * prq.bn // 4))
    print(f"kernel 7 cost terms at the streamed chunk: {json.dumps(terms)}")
    runs = {
        "fused_poisson_moments_stream": (
            lambda: fused_poisson_moments(seed, x, B, stream=True),
            lambda: plain(moments_plain, pr, seed), n * 4 + 3 * B * 4,
            B * n, dict(B=B, n=n, d=1)),
        "fused_poisson_hist_binblocked": (
            lambda: fused_poisson_hist(seed, xq, ST_LO, ST_HI, NBINS, B,
                                       block_bins=NBINS),
            lambda: plain(hist_plain, prq, seed, lo, hi, NBINS),
            ST_CHUNK * ST_D * 4 + B * ST_D * NBINS * 4, B * ST_CHUNK,
            dict(B=B, n=ST_CHUNK, d=ST_D, nbins=NBINS, block_bins=NBINS,
                 windows=windows, draws_a_weight=1)),
    }
    rows = []
    libs = {"fused_poisson_moments_stream": "fused_stream",
            "fused_poisson_hist_binblocked": "fused_binblocked"}
    for name, (kernel, plain_fn, nbytes, weights, shape) in runs.items():
        ms = time_ms(torch, kernel, 5)
        alone_ms = launch_ms(torch, kernel, libs[name], 5)
        plain_ms = time_ms(torch, plain_fn, 1)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = weights * OPS_PER_WEIGHT / INT32_OPS_PER_S * 1e3
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=parity.err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, launch_ms=alone_ms, shape=shape))
        print(f"timing {name}: {ms:.4f} ms (the kernel alone {alone_ms:.4f} "
              f"ms; plain {plain_ms:.2f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms by {rows[-1]['bound_by']}) at "
              f"{shape}")
    # kernel 2 beside kernel 5, in turns, in this call
    turns = [time_ms(torch, lambda s=s: fused_poisson_moments(
        seed, x, B, stream=s), 5) for s in (False, True, True, False)]
    print(f"timing kernel 2 vs kernel 5 (B={B}, n={n}, d=1), in turns "
          f"k2, k5, k5, k2 (ms): {json.dumps(turns)}")
    ms2 = time_ms(torch, lambda: fused_poisson_moments(seed, xq, B), 5)
    ms5 = time_ms(torch, lambda: fused_poisson_moments(seed, xq, B,
                                                       stream=True), 5)
    print(f"timing at the streamed chunk (B={B}, n={ST_CHUNK}, d={ST_D}): "
          f"kernel 2 {ms2:.4f} ms, kernel 5 {ms5:.4f} ms; kernel 7 walks "
          f"{windows} windows over one draw of each weight (the design "
          f"before drew it {windows} times)")
    return rows


def kmeans_rows(torch, launches, parity: Parity):
    """Kernel rows of the two k-means kernels, at the shapes their main
    path gives them: kmeans_assign at the example's full fit (n = 400,000,
    k = 5, d = 2, unit weights), the fused kernel at the B = 256,
    n = 2^22 bootstrap."""
    from repro_torch.kernels._pass import kmeans_geometry
    from repro_torch.kernels.kmeans_assign.ops import (assign_plain,
                                                       fused_kmeans_plain,
                                                       fused_poisson_kmeans,
                                                       kmeans_assign)
    from repro_torch.kernels.weighted_stats.ops import prepare

    k, d, B, seed = KM_K, 2, BIG_B, 2025
    entries = k * (d + 1) + 1
    x, cent = km_data(torch, KM_N, k, d, seed=5)
    w = torch.ones(KM_N, device="cuda")
    xb, cb = km_data(torch, KM_BOOT_N, k, d, seed=7)
    pr = prepare(xb, B)
    # kmeans_assign: f32 operations a point, an FMA counted as two: xx
    # (2d-1), per centroid x·c (2d-1) and d² (3), and the accumulation of
    # d+1 sums and the inertia (2(d+2)); bytes: x and w read once, the
    # centroids read and the state written once.
    flops_pt = 2 * d - 1 + k * (2 * d + 2) + 2 * (d + 2)
    a_bytes = KM_N * (d + 1) * 4 + (k * d + entries) * 4
    a_flops = KM_N * flops_pt
    # fused: 73 integer operations a weight (the hash) and one FMA into
    # each of its row's k·(d+1)+1 entries; bytes: x read once, the states
    # written once.
    f_bytes = KM_BOOT_N * d * 4 + (k * d + B * entries) * 4
    runs = {
        "kmeans_assign": (
            lambda: kmeans_assign(x, w, cent),
            lambda: plain(assign_plain, x, w, cent),
            a_bytes / HBM_BYTES_PER_S,
            a_flops / F32_FLOPS_PER_S, dict(n=KM_N, k=k, d=d)),
        "fused_poisson_kmeans": (
            lambda: fused_poisson_kmeans(seed, xb, cb, B),
            lambda: plain(fused_kmeans_plain, pr, seed, cb),
            f_bytes / HBM_BYTES_PER_S,
            max(B * KM_BOOT_N * OPS_PER_WEIGHT / INT32_OPS_PER_S,
                B * KM_BOOT_N * entries * 2 / F32_FLOPS_PER_S),
            dict(B=B, n=KM_BOOT_N, k=k, d=d)),
    }
    libs = {"kmeans_assign": "kmeans_assign",
            "fused_poisson_kmeans": "fused_kmeans"}
    rows = []
    for name, (kernel, plain_fn, t_bytes, t_ops, shape) in runs.items():
        reps = 20 if name == "kmeans_assign" else 5
        ms = time_ms(torch, kernel, reps)
        alone_ms = launch_ms(torch, kernel, libs[name], reps)
        plain_ms = time_ms(torch, plain_fn, 1)
        bound = max(t_bytes, t_ops) * 1e3
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=parity.err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, launch_ms=alone_ms, shape=shape))
        print(f"timing {name}: {ms:.4f} ms (the kernel alone {alone_ms:.4f} "
              f"ms; plain {plain_ms:.2f} ms, bound {bound:.4f} ms by "
              f"{rows[-1]['bound_by']}) at {shape}")
    # the columns each cluster chunk hashes: those whose nearest centroid
    # it holds, from the plain assignment of the padded columns
    geo = kmeans_geometry(pr.Bp, pr.np_, pr.bn, k, d)
    jstar = torch.cat([((xc[:, None, :] - cb[None]) ** 2).sum(-1).argmin(1)
                       for xc in pr.xp.split(1 << 20)])
    per = torch.bincount(jstar, minlength=k)
    cols = [int(per[c:c + geo.kc].sum()) for c in range(0, k, geo.kc)]
    del jstar
    terms = slot_cost_terms(geo, "fused_kmeans_kernel", pr, cols)
    print(f"kernel 8 cost terms beside its {rows[-1]['launch_ms']:.4f} ms "
          f"alone: {json.dumps(terms)}")
    # the example's shapes of the fused kernel, a call and alone
    xs, cs = km_data(torch, KM_SAMPLE, k, d, seed=6)
    example = lambda: fused_poisson_kmeans(seed, xs, cs, KM_B)  # noqa: E731
    ms = time_ms(torch, example, 20)
    alone_ms = launch_ms(torch, example, "fused_kmeans", 20)
    rows[-1]["example"] = dict(B=KM_B, n=KM_SAMPLE, ms=ms, launch_ms=alone_ms)
    print(f"timing fused_poisson_kmeans at the example's B={KM_B}, "
          f"n={KM_SAMPLE}: {ms:.4f} ms a call, the kernel alone "
          f"{alone_ms:.4f} ms")
    return rows


def groupby_rows(torch, launches, parity: Parity, walls):
    """Kernel rows of the two GROUP BY kernels at B = 256, n = 2^20 + 37,
    G = 8, d = 1 (nbins = 2048), the sessions' warm walls, and the grouped
    kernel against G masked moments launches at the reference benchmark's
    shape."""
    from repro_torch.kernels._pass import grouped_geometry
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       grouped_hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, grouped_moments_plain, prepare)

    B, n, G, d, seed = BIG_B, BIG_N, GB_G, 1, 2026
    xk = torch.from_numpy(keyed_rows(n, d, G, seed=4)).cuda()
    x, keys = xk[:, :-1].contiguous(), xk[:, -1].contiguous()
    kw = dict(group_ids=keys, num_groups=G)
    pr = prepare(x, B, **kw)
    lo = torch.full((d,), LO, device="cuda")
    hi = torch.full((d,), HI, device="cuda")
    weights = B * n
    t_hash = weights * OPS_PER_WEIGHT / INT32_OPS_PER_S
    # moments: one f32 FMA per weight and accumulator, G·(2d+1) of them;
    # bytes: x and the keys read once, w_tot, s1, s2 written once
    t_fma = weights * G * (2 * d + 1) * 2 / F32_FLOPS_PER_S
    in_bytes = n * (d + 1) * 4
    runs = {
        "fused_poisson_moments_grouped": (
            lambda: fused_poisson_moments(seed, x, B, **kw),
            lambda: plain(grouped_moments_plain, pr, seed),
            in_bytes + B * G * (2 * d + 1) * 4, max(t_hash, t_fma)),
        "fused_poisson_hist_grouped": (
            lambda: fused_poisson_hist(seed, x, LO, HI, NBINS, B, **kw),
            lambda: plain(grouped_hist_plain, pr, seed, lo, hi, NBINS),
            in_bytes + B * G * d * NBINS * 4, t_hash),
    }
    rows = []
    for name, (kernel, plain_fn, nbytes, t_ops) in runs.items():
        ms = time_ms(torch, kernel, 5)
        alone_ms = launch_ms(torch, kernel, "fused_grouped", 5)
        plain_ms = time_ms(torch, plain_fn, 1)
        t_bytes = nbytes / HBM_BYTES_PER_S
        bound = max(t_bytes, t_ops) * 1e3
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=parity.err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, launch_ms=alone_ms,
            shape=dict(B=B, n=n, d=d, G=G, nbins=NBINS)))
        print(f"timing {name}: {ms:.4f} ms (the kernel alone {alone_ms:.4f} "
              f"ms; plain {plain_ms:.2f} ms, bound {bound:.4f} ms by "
              f"{rows[-1]['bound_by']})")
    print("keyed histogram cost terms: " + json.dumps(hist_cost_terms(
        torch, x, B, seed, keys, G)))
    # the columns each key chunk hashes: those with a key in it
    geo = grouped_geometry(pr.Bp, pr.np_, pr.bn, G, d)
    gp = pr.gp
    keyed = (gp >= 0) & (gp < G) & (gp == gp.floor())
    cols = [int((keyed & (gp >= g) & (gp < g + geo.kc)).sum())
            for g in range(0, G, geo.kc)]
    terms = slot_cost_terms(geo, "grouped_moments_kernel", pr, cols)
    print(f"kernel 6 cost terms beside its {rows[0]['launch_ms']:.4f} ms "
          f"alone: {json.dumps(terms)}")

    # the grouped kernel against G masked launches of the moments kernel
    sh = GB_RATIO_SHAPE
    xk = torch.from_numpy(keyed_rows(sh["n"], sh["d"], G, seed=5)).cuda()
    x, keys = xk[:, :-1].contiguous(), xk[:, -1].contiguous()
    masks = [(keys == g).float() for g in range(G)]
    grouped_ms = time_ms(torch, lambda: fused_poisson_moments(
        seed, x, sh["B"], group_ids=keys, num_groups=G), 20)
    masked_ms = time_ms(torch, lambda: [fused_poisson_moments(
        seed, x, sh["B"], valid_mask=m) for m in masks], 20)
    print("grouped vs masked moments: " + json.dumps(dict(
        shape=dict(sh, G=G), grouped_ms=grouped_ms, masked_ms=masked_ms,
        masked_over_grouped=masked_ms / grouped_ms)))

    data = keyed_rows(GB_N, G=GB_G)
    for name in GB_INNERS:
        warm = [groupby_session(data, name, None)[2]
                for _ in range(SESSION_REPS)]
        print(f"keyed {name} session wall (s): cold {walls[name]}, "
              f"{SESSION_REPS} warm {json.dumps(warm)}; median "
              f"{sorted(warm)[SESSION_REPS // 2]}")
    return rows


def materialized_rows(torch, launches, parity: Parity):
    """Kernel rows of kernels 11 and 10 at B = 256, n = 2^20 + 37, d = 1
    under Poisson(1) weights (nbins = 2048), and kernel 10 at the point
    estimate of the one-shot bootstraps (unit weights, n = 2^24 - 1000)."""
    from repro_torch.core import poisson_weights
    from repro_torch.data import synthetic_numeric
    from repro_torch.kernels.weighted_hist.ops import (weighted_hist_plain,
                                                       weighted_histogram)
    from repro_torch.kernels.weighted_hist.ref import _bin_indices
    from repro_torch import random as trandom
    from repro_torch.kernels.weighted_stats.ops import weighted_moments
    from repro_torch.kernels.weighted_stats.ref import weighted_moments_ref

    B, n, d = BIG_B, BIG_N, 1
    x = (torch.randn(n, d, generator=torch.Generator().manual_seed(5))
         * 2.0 + 10.0).cuda()
    w = poisson_weights(trandom.PRNGKey(41), B, n, device="cuda")
    lo = torch.full((d,), LO, device="cuda")
    hi = torch.full((d,), HI, device="cuda")
    x3 = torch.cat([torch.ones_like(x), x, x * x], dim=1)
    flat = (torch.arange(B, device="cuda")[:, None] * (d * NBINS)
            + _bin_indices(x, lo, hi, NBINS)[:, 0][None, :]).reshape(-1)
    w_bytes, x_bytes = B * n * 4, n * d * 4
    runs = {
        # bytes: W and x read once, w_tot, s1, s2 written once; operations:
        # an f32 add and 2d FMAs a weight
        "weighted_moments": (
            lambda: weighted_moments(w, x),
            lambda: plain(weighted_moments_ref, w, x),
            lambda: torch.matmul(w, x3),
            w_bytes + x_bytes + B * (2 * d + 1) * 4,
            B * n * (2 * d + 1) * 2),
        # bytes: W and x read once, the counts written once; operations:
        # one add a weight (the binning, per value, is n·d of them)
        "weighted_histogram": (
            lambda: weighted_histogram(x, w, LO, HI, NBINS),
            lambda: plain(weighted_hist_plain, x, w, lo, hi, NBINS),
            lambda: torch.bincount(flat, weights=w.reshape(-1),
                                   minlength=B * d * NBINS),
            w_bytes + x_bytes + B * d * NBINS * 4, B * n),
    }
    rows = []
    libs = {"weighted_moments": "weighted_moments",
            "weighted_histogram": "weighted_hist"}
    for name, (kernel, plain_fn, library, nbytes, flops) in runs.items():
        ms = time_ms(torch, kernel, 10)
        alone_ms = launch_ms(torch, kernel, libs[name], 10)
        plain_ms = time_ms(torch, plain_fn, 2)
        library_ms = time_ms(torch, library, 5)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=parity.err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=library_ms, launch_ms=alone_ms,
            shape=dict(B=B, n=n, d=d,
                       nbins=NBINS if "hist" in name else None)))
        print(f"timing {name}: {ms:.4f} ms (the kernel alone {alone_ms:.4f} "
              f"ms; plain {plain_ms:.2f} ms, library "
              f"{library_ms:.4f} ms, bound {rows[-1]['bound_ms']:.4f} ms by "
              f"{rows[-1]['bound_by']})")
    del w, flat
    xb = torch.from_numpy(synthetic_numeric(BOOT_N, seed=7)).cuda().reshape(
        BOOT_N, 1)
    def point():
        return weighted_histogram(xb, None, LO, HI, NBINS)
    ms = time_ms(torch, point, 20)
    alone_ms = launch_ms(torch, point, "weighted_hist", 20)
    bound = (BOOT_N * 4 + NBINS * 4) / HBM_BYTES_PER_S * 1e3
    rows[-1]["point_estimate"] = dict(n=BOOT_N, ms=ms, launch_ms=alone_ms,
                                      bound_ms=bound)
    print(f"timing weighted_histogram at the point estimate (unit weights, "
          f"n={BOOT_N}, nbins={NBINS}): {ms:.4f} ms a call on CUDA events, "
          f"the kernel alone {alone_ms:.4f} ms (launches back to back; the "
          f"rest is the wrapper's host time between calls) (bound "
          f"{bound:.4f} ms by bytes)")
    return rows


def hist_cost_terms(torch, x, B: int, seed: int, keys=None, G=None) -> dict:
    """The histogram side's cost terms of kernels 3 and 4 (no keys) or of
    the keyed histogram, for x (n, d) at nbins = NBINS: weights hashed,
    shared adds (the nonzero weights of hashed columns, times d), bin_index
    evaluations, flush reads of shared bins, global adds in the flush (the
    nonzero bins of each range's CTAs, counted by running the kernel on
    each range alone under a mask) and, keyed, the key and index bytes
    read.  Each weight is hashed once: the count must equal B·n (keyed:
    B times the columns with a key)."""
    from repro_torch.kernels._pass import (keyed_hist_geometry,
                                           pass_geometry, pass_hist_rows)
    from repro_torch.kernels.poisson_counts.ops import poisson_counts
    from repro_torch.kernels.weighted_hist.ops import fused_poisson_hist
    from repro_torch.kernels.weighted_stats.ops import prepare
    n, d = x.shape
    kw = {} if keys is None else dict(group_ids=keys, num_groups=G)
    pr = prepare(x, B, **kw)
    tpc, ranges = pass_geometry(pr.Bp, pr.np_, pr.bn)
    hashed = torch.ones(n, dtype=torch.bool, device="cuda")
    if keys is not None:
        hashed = (keys >= 0) & (keys < G) & (keys == keys.floor())
        geo = keyed_hist_geometry(pr.Bp, pr.np_, pr.bn, G, d, NBINS)
        rowblocks = -(-pr.Bp // geo.rows)
        flush_reads = geo.ranges * pr.Bp * G * d * NBINS
    else:
        rows = pass_hist_rows(tpc, 1, d, d * NBINS)
        rowblocks = -(-pr.Bp // rows)
        flush_reads = ranges * pr.Bp * d * NBINS
    w = poisson_counts(seed, B, n, device="cuda")
    cols = int(hashed.sum())
    nonzero = int(((w != 0) & hashed[None, :]).sum())
    del w
    global_adds = 0
    for i in range(ranges):
        m = torch.zeros(n, device="cuda")
        m[i * tpc * pr.bn:(i + 1) * tpc * pr.bn] = 1.0
        h = fused_poisson_hist(seed, x, LO, HI, NBINS, B, valid_mask=m, **kw)
        global_adds += int((h != 0).sum())
    terms = dict(
        weights_hashed=B * cols, b_times_n=B * n, shared_adds=nonzero * d,
        bin_index_evaluations=rowblocks * (cols if keys is not None
                                           else pr.np_) * d,
        flush_shared_reads=flush_reads, flush_global_adds=global_adds,
        ctas=ranges * rowblocks * (1 if keys is None else geo.chunks))
    check(terms["weights_hashed"] == B * (n if keys is None else cols),
          f"a weight hashed more than once: {terms}")
    if keys is not None:
        terms.update(
            geometry=geo._asdict(),
            index_pass_key_bytes=2 * pr.np_ * 4,
            entry_bytes_read=rowblocks * cols * 4,
            x_bytes_read=rowblocks * cols * d * 4,
            key_bytes_read_by_ballot_design=rowblocks * geo.chunks
            * pr.np_ * 4)
    return terms


def launch_ms(torch, fn, lib: str, reps: int) -> float:
    """Mean ms of one launch of ``earl_<lib>``, alone: ``fn`` runs once,
    and inside its own launch (its temporaries alive) the kernel is
    launched ``reps`` more times back to back between CUDA events, after
    one warm-up.  No wrapper work runs between them, and the extra
    launches add nothing to any count."""
    from repro_torch.kernels import _build
    orig, times = _build.launch, []

    def launch(name, *args):
        orig(name, *args)
        if name != lib:
            return
        orig(name, *args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            orig(name, *args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    _build.launch = launch
    try:
        fn()
    finally:
        _build.launch = orig
    check(len(times) == 1, f"{lib} launched {len(times)} times in one call")
    return times[0]


def phase_timing(torch, launches, parity: Parity, quickstart):
    from repro_torch.core.reduce_api import Mean, Quantile, StatisticGroup, Std
    from repro_torch.kernels.fused_multi.ops import (_multi_scan,
                                                     fused_poisson_multi)
    from repro_torch.kernels.poisson_counts.ops import poisson_counts
    from repro_torch.kernels.poisson_counts.ref import poisson_weights_plain
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, moments_plain, prepare)

    B, n, seed = BIG_B, BIG_N, 2024
    x = (torch.randn(n, 1, generator=torch.Generator().manual_seed(3))
         * 2.0 + 10.0).cuda()
    pr = prepare(x, B)
    lo = torch.full((1,), LO, device="cuda")
    hi = torch.full((1,), HI, device="cuda")
    group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
    weights = B * n
    x_bytes = n * 4
    runs = {
        "poisson_counts": (
            lambda: poisson_counts(seed, B, n, device="cuda"),
            lambda: plain(poisson_weights_plain, seed, pr.Bp, pr.np_, pr.bb,
                          pr.bn, device="cuda"),
            B * n * 4),
        "fused_poisson_moments": (
            lambda: fused_poisson_moments(seed, x, B),
            lambda: plain(moments_plain, pr, seed), x_bytes + 3 * B * 4),
        "fused_poisson_hist": (
            lambda: fused_poisson_hist(seed, x, LO, HI, NBINS, B),
            lambda: plain(hist_plain, pr, seed, lo, hi, NBINS),
            x_bytes + B * NBINS * 4),
        "fused_poisson_multi": (
            lambda: fused_poisson_multi(group, seed, x, B),
            lambda: plain(_multi_scan, group.slots, seed, pr),
            x_bytes + 3 * B * 4 + B * NBINS * 4),
    }
    rows = []
    for name, (kernel, plain_fn, out_bytes) in runs.items():
        ms = time_ms(torch, kernel, 5)
        lib = "poisson_counts" if name == "poisson_counts" else "fused_pass"
        alone_ms = launch_ms(torch, kernel, lib, 5)
        plain_ms = time_ms(torch, plain_fn, 1)
        t_bytes = out_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = weights * OPS_PER_WEIGHT / INT32_OPS_PER_S * 1e3
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=parity.err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, launch_ms=alone_ms,
            shape=dict(B=B, n=n, d=1, nbins=NBINS)))
        print(f"timing {name}: {ms:.4f} ms (the kernel alone {alone_ms:.4f} "
              f"ms; plain {plain_ms:.2f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms)")
    print("kernels 3 and 4 cost terms (their histogram side): "
          + json.dumps(hist_cost_terms(torch, x, B, seed)))
    # the session is host work around microsecond kernels: its wall time
    # varies run to run, so it is timed again, warm, a few times
    walls = []
    for _ in range(SESSION_REPS):
        t0 = time.perf_counter()
        quickstart(None)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"quickstart session wall, {SESSION_REPS} warm runs (s): "
          f"{json.dumps(walls)}; median {sorted(walls)[SESSION_REPS // 2]}")
    rows += kmeans_rows(torch, launches, parity)
    walls = [kmeans_example(torch, None) for _ in range(SESSION_REPS)]
    for key in ("fit_full_s", "earl_s"):
        v = [w[key] for w in walls]
        print(f"k-means example {key}, {SESSION_REPS} warm runs (s): "
              f"{json.dumps(v)}; median {sorted(v)[SESSION_REPS // 2]}")
    return rows


# ---------------------------------------------------------------------------
# the serving path: kernel 12 and the model stack (phase 11)
# ---------------------------------------------------------------------------
#: (b, hq, hkv, sq, skv, d), kwargs: tests/test_kernels.py's sweep, the
#: unaligned Sq = 67 at head_dim 120 and GQA 4, a decode-offset case, head
#: dims 20 (padded to 24 for TMA) and 128, Sq and Skv off the 128-row
#: tiles (200, 513), a query block that sees no key at all, and phase
#: 15's non-causal geometries at batch 1 (XA_TIMED: llama-3.2-vision's
#: cross-attention, GQA 64/8 at D = 128 over 1600 keys; whisper-small's
#: encoder, 1500 frames, and its cross-attention, 224 queries over them)
FA_NO_KEY_OFFSET = 100
FA_CASES = [
    ((2, 4, 2, 64, 64, 32), dict(causal=True)),
    ((1, 4, 4, 128, 128, 32), dict(causal=True, window=32)),
    ((2, 8, 2, 96, 96, 16), dict(causal=False)),
    ((1, 2, 1, 64, 192, 32), dict(causal=True, kv_offset=128)),
    ((1, 8, 1, 80, 80, 64), dict(causal=True)),
    ((1, 32, 8, 67, 67, 120), dict(causal=True)),
    ((4, 32, 8, 64, 4160, 120), dict(causal=True, window=4096,
                                     kv_offset=4096)),
    ((2, 4, 1, 200, 200, 20), dict(causal=True, window=50)),
    ((1, 8, 1, 513, 513, 128), dict(causal=True)),
    ((1, 4, 4, 200, 513, 64), dict(causal=False)),
    ((1, 2, 1, 64, 32, 16), dict(causal=True, window=16,
                                 kv_offset=FA_NO_KEY_OFFSET)),
    ((1, 64, 8, 8192, 1600, 128), dict(causal=False)),
    ((1, 12, 12, 1500, 1500, 64), dict(causal=False)),
    ((1, 12, 12, 224, 1500, 64), dict(causal=False)),
]
#: head dims past 128, held in both routes: gemma3-27b's 168 at its 32/16
#: heads (three TMA boxes, the third 24 columns of zero fill) and 256
#: (four), causal and windowed, Sq and Skv off the tiles
FA_WIDE_CASES = [
    ((1, 32, 16, 200, 200, 168), dict(causal=True)),
    ((2, 4, 2, 300, 300, 168), dict(causal=True, window=100)),
    ((1, 8, 2, 513, 513, 256), dict(causal=True)),
    ((1, 4, 4, 130, 260, 256), dict(causal=True, window=64, kv_offset=130)),
]


def fa_inputs(torch, shape, dtype, gen):
    b, hq, hkv, sq, skv, d = shape
    return tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d),
                           (b, hkv, skv, d)))


def attention_pv_abs(q, k, v, kw):
    """The plain version on |v| with the same q, k and masks, in f32:
    (Σ p·|v|)/l an output, which bounds the P-rounding term of kernel
    12's bf16 tolerance (Parity.attention)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    return plain(flash_attention_plain, q.float(), k.float(), v.float().abs(),
                 **kw)


def hold_attention(parity, got, q, k, v, kw, what):
    """Kernel 12's output ``got`` against the plain version on q, k, v;
    returns the max |err| and the share of the bound it used."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    want = plain(flash_attention_plain, q, k, v, **kw)
    pv_abs = attention_pv_abs(q, k, v, kw) if q.element_size() == 2 else None
    return parity.attention(got, want, what, pv_abs)


def phase_parity_attention(torch, parity: Parity) -> None:
    """Kernel 12 against its plain version at the sweep (f32 and bf16),
    at head dims 168 and 256, and at the full-width prefill shapes of
    h2o-danube-3-4b and gemma3-27b (bf16, and f32 to hold the window's
    tile skip tightly where Sq passes the window); two bf16 launches at
    those shapes and past head dim 128 must give the same bits."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = [(s, kw, dt) for s, kw in FA_CASES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((FA_B, FA_HQ, FA_HKV, FA_S, FA_S, FA_D),
               dict(causal=True, window=FA_W), dt)
              for dt in (torch.bfloat16, torch.float32)]
    cases += [(s, kw, dt) for s, kw in FA_WIDE_CASES
              for dt in (torch.float32, torch.bfloat16)]
    # gemma3-27b's prefill: its local (window 1024) and global layers
    gemma = (FA_B, GEMMA_HQ, GEMMA_HKV, FA_S, FA_S, GEMMA_D)
    cases += [(gemma, dict(causal=True, window=GEMMA_W), torch.bfloat16),
              (gemma, dict(causal=True), torch.bfloat16),
              (gemma, dict(causal=True, window=GEMMA_W), torch.float32)]
    for shape, kw, dt in cases:
        q, k, v = fa_inputs(torch, shape, dt, gen)
        got = flash_attention(q, k, v, **kw)
        err, share = hold_attention(parity, got, q, k, v, kw,
                                    f"{shape} {kw} {dt}")
        if shape[3] == FA_S:
            print(f"parity: flash_attention at the full-width prefill "
                  f"shape {shape} {kw} in {dt}: max |err| {err}, largest "
                  f"share of the bound {share}")
        if kw.get("kv_offset") == FA_NO_KEY_OFFSET:
            check(bool((got == 0).all()), f"flash_attention {shape} {kw} "
                  f"{dt}: rows that see no key are not 0")
        if dt == torch.bfloat16 and (shape[3] == FA_S or shape[5] > 128):
            check(torch.equal(got, flash_attention(q, k, v, **kw)),
                  f"flash_attention {shape} {kw}: two bf16 launches differ")
    torch.cuda.synchronize()
    print(f"parity: flash_attention matches its plain version at "
          f"{len(cases)} cases; max |err| "
          f"{parity.err['flash_attention']}, largest share of the bound "
          f"{json.dumps(parity.fa_share)}; two bf16 launches at the "
          f"full-width shapes and past head dim 128 bitwise equal")


def logits_tolerance(want, share: float = 2e-2) -> float:
    """bf16 tolerance of a logit: ``share`` (2e-2) of the largest |logit|
    (bf16 keeps 8 bits; roundings in another order move a logit by a few
    of them)."""
    return share * float(want.abs().max())


def serve(torch, cfg, params, prompts, gen_steps, cache_len, forced=None,
          aux=None, on_prefill=None):
    """prefill (with room for the decode steps; ``aux`` the stub image or
    frame embeddings of a model with cross-attention) and greedy decode
    steps, or steps fed the tokens ``forced`` (B, gen_steps); ``on_prefill``
    is called with the prefill's cache before the decode clock starts (the
    steps write that cache in place); returns
    (logits per step, decoded tokens, prefill seconds, decode seconds,
    flash_attention launches of the prefill and of the decode, the cache
    after the last step)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import prefill
    from repro_torch.train import make_decode_step
    decode_step = make_decode_step(cfg)

    def sync():
        if prompts.is_cuda:
            torch.cuda.synchronize()
    sync()
    n0 = flash_attention.launches
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = prefill(cfg, params, prompts, aux=aux,
                                cache_len=cache_len)
    sync()
    t_prefill = time.perf_counter() - t0
    n_prefill = flash_attention.launches - n0
    if on_prefill is not None:
        on_prefill(cache)
    steps, toks = [logits], []
    t0 = time.perf_counter()
    for t in range(gen_steps):
        tok = (torch.argmax(logits, -1)[:, None] if forced is None
               else forced[:, t:t + 1])
        toks.append(tok)
        logits, cache = decode_step(params, cache, tok,
                                    prompts.shape[1] + t)
        steps.append(logits)
    sync()
    t_decode = time.perf_counter() - t0
    return (steps, torch.cat(toks, dim=1), t_prefill, t_decode, n_prefill,
            flash_attention.launches - n0 - n_prefill, cache)


def _weight_leaves(tree, name=""):
    """The parameter tensors a forward casts to the compute dtype: every
    one but the norm scales (which the norms read in f32)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _weight_leaves(v, k)
    elif not name.endswith("norm"):
        yield tree


def profile_decode(torch, cfg, params, cache, tok, pos) -> dict:
    """Where a decode step's time goes: PROFILE_STEPS steps on the host's
    clock (when the host returned from each, and when the card was done),
    one step under torch.profiler (the card's busy time, the union of its
    kernels' intervals, and the device time of the casts,
    aten::_to_copy), and the casts of the f32 weights to the compute
    dtype that a step makes, timed alone with CUDA events."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.layers import dtype_of
    from repro_torch.train import make_decode_step
    step = make_decode_step(cfg)
    host, wall = [], []
    for i in range(PROFILE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, cache, tok, pos + i)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, cache, tok, pos + PROFILE_STEPS)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    cast_us = sum(r.device_time_total for r in prof.key_averages()
                  if r.key == "aten::_to_copy")
    # the host's calls into the CUDA runtime: launches, and any wait on
    # the card inside the step (the profiled step ends in one
    # cudaDeviceSynchronize of its own)
    calls = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("cu")):
            calls[e.name] = calls.get(e.name, 0) + 1
    leaves = list(_weight_leaves(params))
    cd = dtype_of(cfg.compute_dtype)

    def cast_all():
        for t in leaves:
            t.to(cd)
    cast_ms = time_ms(torch, cast_all, 3)
    cast_bytes = sum(t.numel() * (t.element_size() + cd.itemsize)
                     for t in leaves)
    out = dict(decode_step_host_return_s=host, decode_step_wall_s=wall,
               profiled_step_wall_s=prof_wall,
               profiled_device_kernels=len(spans),
               profiled_device_busy_s=(busy_us * 1e-6 if spans else None),
               profiled_cast_device_s=(cast_us * 1e-6 if spans else None),
               weight_cast_ms=cast_ms, weight_cast_bytes=cast_bytes,
               profiled_runtime_calls=calls)
    busy = ("not measured (the profiler saw no device kernel)" if not spans
            else f"{busy_us * 1e-3:.3f} ms busy on the card in "
                 f"{len(spans)} kernels and copies, casts "
                 f"{cast_us * 1e-3:.3f} ms of it")
    print(f"decode step (cuda): host returned after {host} s, card done "
          f"after {wall} s ({PROFILE_STEPS} steps); one step profiled: wall "
          f"{prof_wall * 1e3:.3f} ms, {busy}; the weight casts alone "
          f"{cast_ms:.3f} ms for {cast_bytes} bytes; runtime calls "
          f"{json.dumps(calls)}")
    return out


def routing_on_the_card(torch):
    """The repaired routing: a group with a keyed and a custom member,
    each bitwise its dedicated run, and a keyed custom statistic over
    B = 256, n = 2^24 - 1000 rows whose peak stays below one (B, n) f32
    weight matrix.  Returns (info, the launches of the group's run and
    the keyed custom statistic's, each from zeroed counts: the dedicated
    runs and the CPU comparison are checks)."""
    from repro_torch.core import (GroupedStatistic, Mean, MomentState,
                                  Statistic, StatisticGroup)
    from repro_torch.core.bootstrap import fused_resample_states
    from repro_torch.kernels.fused_multi.ops import (fused_poisson_multi,
                                                     fused_poisson_tiled)
    from repro_torch.kernels.weighted_stats.ops import fused_poisson_moments

    class AbsSum(Statistic):
        """A user statistic with its own tile math: Σw and Σw|x|."""

        def init_state(self, dim, device="cpu"):
            z = torch.zeros(dim, device=device)
            return MomentState(w=torch.zeros((), device=device), s1=z, s2=z)

        def update(self, state, values, weights=None):
            x = values.to(torch.float32)
            w = (torch.ones(x.shape[0], device=x.device) if weights is None
                 else weights)
            return MomentState(w=state.w + w.sum(), s1=state.s1 + w @ x.abs(),
                               s2=state.s2)

        def tile_update(self, states, x_tile, w_tile):
            return MomentState(w=states.w + w_tile.sum(dim=1),
                               s1=states.s1 + w_tile @ x_tile.abs(),
                               s2=states.s2)

        def finalize(self, state):
            return state.s1 / torch.clamp_min(state.w.unsqueeze(-1), 1.0)

    def keyed_rows(n, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(n, 1, generator=gen, device="cuda") * 2.0 + 10.0
        keys = torch.randint(0, ROUTE_G, (n, 1), generator=gen,
                             device="cuda").float()
        return torch.cat([x, keys], dim=1)

    vals = keyed_rows(ROUTE_GROUP_N, 1)
    keyed, custom = GroupedStatistic(Mean(), ROUTE_G), AbsSum()
    got, group_launches = main_run(lambda: fused_poisson_multi(
        StatisticGroup((Mean(), keyed, custom)), 77, vals, BIG_B))
    want = (fused_poisson_moments(77, vals, BIG_B),
            keyed.fused_poisson_states(77, vals, BIG_B),
            fused_poisson_tiled(custom, 77, vals, BIG_B))
    pairs = [(got[0].w, want[0][0]), (got[0].s1, want[0][1]),
             (got[0].s2, want[0][2]), (got[1].w, want[1].w),
             (got[1].s1, want[1].s1), (got[1].s2, want[1].s2),
             (got[2].w, want[2].w), (got[2].s1, want[2].s1)]
    check(all(bool((a == b).all()) for a, b in pairs),
          "a group member differs from its dedicated run")
    # the CPU's tiled scan (on the first 2^16 rows: the plain draw is
    # slow): weights bitwise, so w_tot; Σw|x| within 1e-5 of itself
    head = vals[:1 << 16]
    card = fused_poisson_tiled(custom, 77, head, BIG_B)
    cpu = fused_poisson_tiled(custom, 77, head.cpu(), BIG_B)
    check(bool((cpu.w == card.w.cpu()).all()),
          "the tiled scan's w_tot differs from its CPU run")
    check(bool(((cpu.s1 - card.s1.cpu()).abs() <= 1e-5 * cpu.s1).all()),
          "the tiled scan's Σw|x| is off its CPU run by more than 1e-5")
    del vals, got, want, head, card, cpu
    vals = keyed_rows(BOOT_N, 2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, keyed_launches = main_run(lambda: fused_resample_states(
        GroupedStatistic(AbsSum(), ROUTE_G), 99, vals, BIG_B))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    bn_bytes = BIG_B * BOOT_N * 4
    check(st.w.shape == (BIG_B, ROUTE_G) and peak < bn_bytes,
          f"keyed custom statistic: peak {peak} B against a (B, n) matrix "
          f"of {bn_bytes} B")
    print(f"routing (cuda): a group (Mean, GroupedStatistic(Mean, "
          f"{ROUTE_G}), custom) at B={BIG_B}, n={ROUTE_GROUP_N} is bitwise "
          f"its members' dedicated runs; a keyed custom statistic at "
          f"B={BIG_B}, n={BOOT_N}: {wall:.3f} s, peak {peak} B above the "
          f"data (a (B, n) f32 matrix is {bn_bytes} B)")
    return (dict(keyed_custom_s=wall, keyed_custom_peak_bytes=peak),
            add_counts(group_launches, keyed_launches))


def layer_kinds(cfg):
    return [cfg.layer_pattern[i % cfg.pattern_len]
            for i in range(cfg.n_layers)]


def prefill_launches(cfg) -> int:
    """Kernel 12's launches in one prefill (or forward): one an attention
    layer's self-attention (a recurrent layer has none), one a
    cross-attention (``xattn``/``dec`` layers) and one an encoder
    layer."""
    kinds = layer_kinds(cfg)
    return (sum(k not in RECURRENT for k in kinds)
            + sum(k in ("xattn", "dec") for k in kinds) + cfg.enc_layers)


def aux_len(cfg) -> int:
    return cfg.vision_tokens or cfg.enc_seq


def layer_score_bytes(cfg, batch: int, prompt: int) -> int:
    """The largest f32 score tensor one layer would hold, B·Hq·Sq·Skv·4
    summed over its attentions: a decoder layer's self-attention and
    cross-attention, or an encoder layer's self-attention over the aux."""
    per = batch * cfg.n_heads * 4
    cross = any(k in ("xattn", "dec") for k in cfg.layer_pattern)
    out = per * prompt * (prompt + (aux_len(cfg) if cross else 0))
    if cfg.is_encdec:
        out = max(out, per * cfg.enc_seq * cfg.enc_seq)
    return out


def aux_cache_bytes(cfg, batch: int) -> int:
    """Bytes of the prefill's cache that the cross-attention adds: each
    ``xattn``/``dec`` layer's K/V over the aux, and ``enc_out``."""
    cd = 2 if cfg.compute_dtype == "bfloat16" else 4
    kv = 2 * batch * cfg.n_kv_heads * aux_len(cfg) * cfg.head_dim_ * cd
    n = sum(k in ("xattn", "dec") for k in layer_kinds(cfg))
    enc = batch * cfg.enc_seq * cfg.d_model * cd if cfg.is_encdec else 0
    return n * kv + enc


def self_cache_bytes(cfg, batch: int, cache_len: int) -> int:
    """Bytes of the self caches a prefill returns: an attention layer's K
    and V over its ring (the window for ``swa``/``local``), a recurrent
    layer's state (``recurrent_state_bytes``)."""
    cd = 2 if cfg.compute_dtype == "bfloat16" else 4
    out = 0
    for kind in layer_kinds(cfg):
        if kind in RECURRENT:
            out += recurrent_state_bytes(cfg, kind, batch)
            continue
        ring = (min(cfg.window, cache_len) if kind in ("swa", "local")
                and cfg.window else cache_len)
        out += 2 * batch * cfg.n_kv_heads * ring * cfg.head_dim_ * cd
    return out


def recurrent_state_bytes(cfg, kind: str, batch: int) -> int:
    """A recurrent layer's serving state: ``rglru`` the f32 (B, r) lru and
    the (B, cw - 1, r) conv state in the compute dtype; ``mlstm`` the f32
    (B, H, dh, dh) C, (B, H, dh) n and (B, H) m; ``slstm`` four f32
    (B, H, dh)."""
    cd = 2 if cfg.compute_dtype == "bfloat16" else 4
    h, dh, r = cfg.n_heads, cfg.head_dim_, cfg.rnn_width_
    if kind == "rglru":
        return batch * r * 4 + batch * (cfg.conv_width - 1) * r * cd
    if kind == "mlstm":
        return batch * h * (dh * dh + dh + 1) * 4
    return 4 * batch * h * dh * 4


def recurrent_live_bytes(cfg, tokens: int) -> int:
    """What the largest recurrent cell of the config holds at once over
    ``tokens`` tokens, from its own tensors (``models/layers.py``), with
    its weights cast to the compute dtype: ``rglru_block`` at most eight
    f32 (T, r) tensors (a and the gated input, and the doubling scan's a,
    b, their two new levels and a product), the gate branch in
    matmul_out_dtype and three (T, r) in the compute dtype (the raw and
    convolved inputs and a conv term); ``mlstm_block`` seven f32
    (T, H·dh) (q, k, v, the chunks' outputs, their concatenation and its
    copies) and a projection in matmul_out_dtype; ``slstm_block`` twelve
    f32 (T, H·dh) (the gates' (T, 4·H·dh) projections and their
    heads-first copy, the steps' outputs, their stack and copies), and
    its recurrent matrices in f32."""
    cd = 2 if cfg.compute_dtype == "bfloat16" else 4
    ob = 4 if cfg.matmul_out_dtype == "float32" else cd
    d, h, dh, r = cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.rnn_width_
    hd = h * dh
    kinds = set(layer_kinds(cfg))
    out = 0
    if "rglru" in kinds:
        out = max(out, tokens * r * (8 * 4 + ob + 3 * cd)
                  + (3 * d * r + 2 * r * r + cfg.conv_width * r) * cd)
    if "mlstm" in kinds:
        out = max(out, tokens * hd * (7 * 4 + ob)
                  + (4 * d * hd + 2 * d * h) * cd)
    if "slstm" in kinds:
        out = max(out, tokens * hd * 12 * 4 + 5 * d * hd * cd
                  + 4 * h * dh * dh * 4)
    return out


def prefill_live_bytes(cfg, batch: int, prompt: int, cache_len: int
                       ) -> int:
    """What the prefill can hold at once besides the params, from the
    code's own tensors, for the widest pass (the decoder's B·prompt tokens
    or the encoder's B·enc_seq frames): the MLP's four (tokens, d_ff)
    products in matmul_out_dtype (gate, up, silu(gate) and their product),
    four (tokens, d_model) f32 residual-stream tensors, one layer's weights
    and the embedding cast to the compute dtype, and the caches the
    prefill returns (self K/V or recurrent state, cross K/V, enc_out).  A
    layer with experts takes ``moe_live_bytes`` in place of the MLP's
    products and weights (and keeps them beside it under
    ``dense_residual``); a recurrent cell adds ``recurrent_live_bytes``."""
    cd = 2 if cfg.compute_dtype == "bfloat16" else 4
    ob = 4 if cfg.matmul_out_dtype == "float32" else cd
    tokens = max(batch * prompt, batch * cfg.enc_seq if cfg.is_encdec else 0)
    attn = ((2 * cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim_
            * cfg.d_model)
    cross = any(k in ("xattn", "dec") for k in cfg.layer_pattern)
    dense = not cfg.num_experts or cfg.dense_residual
    layer = (attn * (2 if cross else 1)
             + (3 * cfg.d_model * cfg.d_ff if dense else 0)) * cd
    return ((4 * tokens * cfg.d_ff * ob if dense else 0)
            + 4 * tokens * cfg.d_model * 4
            + layer + cfg.padded_vocab * cfg.d_model * cd
            + self_cache_bytes(cfg, batch, cache_len)
            + aux_cache_bytes(cfg, batch)
            + (moe_live_bytes(cfg, tokens) if cfg.num_experts else 0)
            + recurrent_live_bytes(cfg, tokens))


def moe_live_bytes(cfg, tokens: int) -> int:
    """What one MoE layer (``layers._moe_route_compute``) holds at once
    over ``tokens`` tokens, from its own tensors, with C = ceil(T·k·cf/E)
    and R = E·C dispatch rows: the routing's (T, E) probabilities (f32,
    twice: the softmax and its sorted values) and sort order (int64) and
    its nine (T·k,) slot arrays (int64), the (R + 1, d) dispatch buffer
    and the (T·k, d) rows gathered into it (compute dtype), three (R, f)
    expert products in f32 (gate, up, their product; the compute-dtype
    h is smaller than the third), the (R, d) output in matmul_out_dtype
    and its f32 copy with the zero row, the (T·k, d) f32 contributions and
    the (T, d) f32 output, and one layer's expert and router weights
    cast to the compute dtype."""
    cd = 2 if cfg.compute_dtype == "bfloat16" else 4
    ob = 4 if cfg.matmul_out_dtype == "float32" else cd
    d, f, e, k = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.top_k
    slots = tokens * k
    rows = e * math.ceil(tokens * k * cfg.capacity_factor / e)
    return (tokens * e * (4 + 4 + 8) + 9 * slots * 8
            + (rows + 1) * d * cd + slots * d * cd
            + 3 * rows * f * 4
            + rows * d * ob + (rows + 1) * d * 4
            + slots * d * 4 + tokens * d * 4
            + (3 * e * d * f + d * e) * cd)


def cross_leaves(cache) -> dict:
    """The cross-attention's part of a serving cache, by name: enc_out,
    and each ``xattn``/``dec`` layer's K and V (a stacked group's one
    layer at a time)."""
    out = {}
    if "enc_out" in cache:
        out["enc_out"] = cache["enc_out"]
    for part in ("groups", "rem"):
        for name, c in cache.get(part, {}).items():
            if "xattn" not in c:
                continue
            for kv in ("k", "v"):
                for i, t in enumerate(c["xattn"][kv]):
                    out[f"{part}.{name}[{i}].xattn.{kv}"] = t
    return out


class CrossTap:
    """Records, in call order, the output of every cross-attention a
    prefill runs (``models.layers.cross_attention`` in prefill mode),
    copied to the host, while it is entered."""

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, self.orig, self.outs = layers, layers.cross_attention, []

        def tap(cfg, p, x, aux, cache=None, mode="train"):
            y, c = self.orig(cfg, p, x, aux, cache=cache, mode=mode)
            if mode == "prefill":
                self.outs.append(y.detach().float().cpu())
            return y, c
        layers.cross_attention = tap
        return self

    def __exit__(self, *exc):
        self.layers.cross_attention = self.orig


class RouteTap:
    """Records, in call order, every MoE routing a run makes
    (``models.layers.moe_route``: the Route, its tensors where they lie)
    and, with ``outputs``, every MoE layer's output (``models.layers
    .moe_ffn``) copied to the host, while it is entered.  Recording a
    Route launches nothing: its tensors are the run's own."""

    def __init__(self, outputs: bool = False):
        self.outputs = outputs

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, self.orig = layers, (layers.moe_route, layers.moe_ffn)
        self.routes, self.ys = [], []
        route, ffn = self.orig

        def tap_route(cfg, p, xt):
            r = route(cfg, p, xt)
            self.routes.append(r)
            return r

        def tap_ffn(cfg, p, x):
            y = ffn(cfg, p, x)
            if self.outputs:
                self.ys.append(y.detach().float().cpu())
            return y
        layers.moe_route, layers.moe_ffn = tap_route, tap_ffn
        return self

    def __exit__(self, *exc):
        self.layers.moe_route, self.layers.moe_ffn = self.orig


def route_drops(routes, n_layers: int):
    """(the prefill's dropped token-slots, each decode step's): a served
    run routes n_layers times in the prefill, then n_layers times a
    step."""
    from repro_torch.models.layers import dropped_slots
    d = [int(dropped_slots(r)) for r in routes]
    return sum(d[:n_layers]), [sum(d[i:i + n_layers])
                               for i in range(n_layers, len(d), n_layers)]


def concat_routes(torch, routes):
    """One Route, on the host, of batch-1 routings of consecutive tokens
    (a prefill's, then a decode step's each): positions in order."""
    from repro_torch.models.layers import Route
    sts, off = [], 0
    for r in routes:
        sts.append(r.st.cpu() + off)
        off += r.probs.shape[0]

    def cat(name):
        return torch.cat([getattr(r, name).cpu() for r in routes])
    return Route(cat("logits"), cat("probs"), cat("eidx"), routes[0].cap,
                 cat("se"), torch.cat(sts), cat("sg"), cat("keep"),
                 cat("slot"))


def hold_routing(torch, got, want, what: str):
    """Two runs' routings of the same tokens, call by call (``got`` on the
    card, ``want`` on the CPU or in a teacher-forced forward): the router
    logits within logits_tolerance (2e-2 of the call's largest |logit|:
    a wrong router product fails here), every token that chose other
    experts or kept other slots explained by ``route_agreement`` where its
    k-th and (k+1)-th logits lie within twice that tolerance of each other
    (only there can two roundings within it flip a choice), and the near
    ties (NEAR_TIE) and flips counted.  Returns (info, each call's (T,)
    mask of the tokens that agree)."""
    from repro_torch.models.layers import near_ties, route_agreement
    check(len(got) == len(want), f"{what}: {len(got)} routings against "
          f"{len(want)}")
    info = dict(tokens=0, near_ties=0, flips=0, flips_at_near_tie=0,
                differing_tokens=0, router_logit_share=0.0)
    agrees = []
    for i, (g, w) in enumerate(zip(got, want)):
        lg, lw = g.logits.float().cpu(), w.logits.float().cpu()
        tol = logits_tolerance(lw)
        err = float((lg - lw).abs().max())
        check(err <= tol, f"{what}: routing {i}'s router logits differ by "
              f"{err}, past {tol}")
        # p_(k+1) / p_k > exp(-2·tol): the logits of the two within 2·tol
        agree, _, unexplained = route_agreement(g, w,
                                                -math.expm1(-2 * tol))
        check(unexplained == 0, f"{what}: routing {i}: {unexplained} tokens "
              f"chose other experts (or kept other slots) with no near tie")
        flipped = (g.eidx.cpu().sort(-1).values
                   != w.eidx.cpu().sort(-1).values).any(-1)
        near = near_ties(g, NEAR_TIE).cpu() | near_ties(w, NEAR_TIE).cpu()
        info["tokens"] += int(agree.numel())
        info["near_ties"] += int(near.sum())
        info["flips"] += int(flipped.sum())
        info["flips_at_near_tie"] += int((flipped & near).sum())
        info["differing_tokens"] += int((~agree).sum())
        info["router_logit_share"] = max(info["router_logit_share"],
                                         err / tol)
        agrees.append(agree)
    return info, agrees


def differing_positions(agrees, positions) -> set:
    """The positions (batch 1) whose routing differs in any call;
    ``positions[i]`` is call i's first.  Only these are left out of a
    logit check: a later token reads a differing one through attention
    with a weight of about one over the keys it sees, far below the
    tolerance."""
    out = set()
    for agree, base in zip(agrees, positions):
        out.update(base + int(j) for j in (~agree).nonzero().flatten())
    return out


def hold_moe_outputs(torch, got, want, agrees, what: str) -> float:
    """Each MoE layer's output on the card against the CPU's at the
    tokens whose routing agrees, within 2e-2 of the CPU output's largest
    |value| (logits_tolerance's bf16 rule); returns the largest share of
    that tolerance."""
    check(len(got) == len(want) == len(agrees), f"{what}: {len(got)} and "
          f"{len(want)} MoE outputs for {len(agrees)} routings")
    share = 0.0
    for i, (g, w, a) in enumerate(zip(got, want, agrees)):
        g, w = g.reshape(-1, g.shape[-1])[a], w.reshape(-1, w.shape[-1])
        tol = logits_tolerance(w)
        err = float((g - w[a]).abs().max()) if len(g) else 0.0
        check(tol > 0 and err <= tol, f"card vs CPU: {what}: MoE output "
              f"{i}: max |err| {err} over {tol}")
        share = max(share, err / tol)
    return share


def moe_teacher_forcing(torch, cfg, params, prompts) -> dict:
    """Decode == teacher forcing for a model with experts, at the capacity
    factor E/k (C = T: no slot drops, so the decode's B tokens and the
    forward's B·S route alike) on 1 x CPU_PROMPT tokens and SERVE_GEN
    greedy steps: the routings held layer by layer (``hold_routing``,
    each layer's decode calls in a row against the forward's), then the
    logits within logits_tolerance at the positions before the first
    token whose routing differs.  Then the routed experts reach the
    logits: at that capacity every slot is kept, so swapping the weights
    of an expert the prompt's last token uses with one it does not (the
    router kept) must move the prefill's logits past the tolerance."""
    import dataclasses
    from repro_torch.models import forward_hidden, logits_from_hidden, prefill
    from repro_torch.models.layers import dropped_slots
    nd = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                             / cfg.top_k)
    prompt = prompts[:1, :CPU_PROMPT]
    with RouteTap() as dec_tap:
        steps, toks, *_ = serve(torch, nd, params, prompt, SERVE_GEN,
                                CPU_PROMPT + SERVE_GEN)
    full = torch.cat([prompt, toks], dim=1)
    with RouteTap() as tf_tap, torch.no_grad():
        h, _ = forward_hidden(nd, params, full, mode="train")
        tf = logits_from_hidden(nd, params,
                                h[:, CPU_PROMPT - 1:])[..., :cfg.vocab]
    del h
    dropped = sum(int(dropped_slots(r))
                  for r in dec_tap.routes + tf_tap.routes)
    check(dropped == 0, f"decode vs teacher forcing: {dropped} slots "
          f"dropped at the capacity factor {nd.capacity_factor}")
    n = cfg.n_layers
    info, agrees = hold_routing(
        torch, [concat_routes(torch, dec_tap.routes[i::n]) for i in range(n)],
        tf_tap.routes, "decode vs teacher forcing")
    differ = differing_positions(agrees, [0] * n)
    dec = torch.stack([s[:, :cfg.vocab] for s in steps], dim=1)
    held = [i for i in range(dec.shape[1])
            if CPU_PROMPT - 1 + i not in differ]
    check(len(held) > 0, "decode vs teacher forcing: no position whose "
          "routing agrees")
    err = float((dec[:, held] - tf[:, held]).abs().max())
    tol = logits_tolerance(tf)
    check(err <= tol, f"decode vs teacher forcing: max |err| {err} over "
          f"{tol}")
    info.update(teacher_forcing_max_err=err, teacher_forcing_tol=tol,
                teacher_forcing_positions=len(held),
                teacher_forcing_capacity_factor=nd.capacity_factor)
    print(f"serve: decode == teacher forcing at the capacity factor "
          f"{nd.capacity_factor} (no slot dropped), 1 x {CPU_PROMPT} tokens "
          f"and {SERVE_GEN} steps: max |logit err| {err} (tolerance {tol}) "
          f"over {len(held)} of {dec.shape[1]} positions; routing: "
          f"{json.dumps({k: v for k, v in info.items() if not k.startswith('teacher')})}")

    last = tf_tap.routes[-1].eidx[CPU_PROMPT - 1].tolist()
    a = last[0]
    b = next(e for e in range(cfg.num_experts) if e not in last)
    swap_experts(params, a, b)
    try:
        with torch.no_grad():
            ml, _ = prefill(nd, params, prompt, cache_len=CPU_PROMPT)
    finally:
        swap_experts(params, a, b)
    moved = float((ml[:, :cfg.vocab] - steps[0][:, :cfg.vocab]).abs().max())
    tol = logits_tolerance(steps[0][:, :cfg.vocab])
    check(moved > tol, f"swapping experts {a} and {b} moved the prefill's "
          f"logits by {moved}, not past the tolerance {tol}")
    info.update(expert_swap=[a, b], expert_swap_moved=moved,
                expert_swap_tol=tol)
    print(f"serve: with experts {a} and {b} swapped (router kept) the "
          f"prefill's logits move by {moved} (tolerance {tol}): the routed "
          f"experts count")
    return info


def swap_experts(params, a: int, b: int) -> None:
    """Swaps experts a and b's weights (not the router's columns) in every
    layer, in place; a second call undoes it bitwise."""
    for block in params["groups"].values():
        for name in ("we_gate", "we_up", "we_down"):
            t = block["mlp"][name]
            held = t[:, a].clone()
            t[:, a] = t[:, b]
            t[:, b] = held


def hold_relative(torch, got: dict, want: dict, what: str) -> dict:
    """Each of ``got`` (card) against ``want`` (CPU) within 2e-2 of its
    own largest |value| (logits_tolerance's bf16 rule); returns each
    error's share of its tolerance."""
    check(list(got) == list(want), f"{what}: the card has {list(got)}, the "
          f"CPU {list(want)}")
    shares = {}
    for name, w in want.items():
        w = w.float().cpu()
        err = float((got[name].float().cpu() - w).abs().max())
        tol = logits_tolerance(w)
        check(tol > 0 and err <= tol, f"card vs CPU: {what} {name}: max "
              f"|err| {err} over {tol}")
        shares[name] = err / tol
    return shares


def gate_leaves(params) -> list:
    """Every cross-attention gate tensor of a params tree."""
    out = []

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "gate":
                out.append(v)
    walk(params)
    return out


def set_gates(torch, params, seed: int) -> list:
    """Draws every gate in place from uniform [GATE_LO, GATE_HI) (a
    generator seeded ``seed``) and returns their values: the init law's
    zero gates would make every cross-attention add nothing, and a wrong
    kernel 12 result, K/V or cache would pass every logit check."""
    gen = torch.Generator().manual_seed(seed)
    for g in gate_leaves(params):
        g.copy_(torch.rand(g.shape, generator=gen) * (GATE_HI - GATE_LO)
                + GATE_LO)
    values = [float(v) for g in gate_leaves(params) for v in g.reshape(-1)]
    check(bool(values) and all(v != 0.0 for v in values),
          f"cross-attention gates not set: {values}")
    return values


def stub_aux(torch, cfg, batch: int, seed: int, std: float = 1.0):
    """Seeded normal (batch, Ta, d_model) f32 stub embeddings of standard
    deviation ``std`` on the card: the image's patches or the audio's
    frames (the frontends are stubs, as in the JAX package); None for a
    model without cross-attention."""
    if not aux_len(cfg):
        return None
    return torch.randn((batch, aux_len(cfg), cfg.d_model),
                       generator=torch.Generator(device="cuda")
                       .manual_seed(seed), device="cuda") * std


def serve_at_full_width(torch, cfg, seed, cut, profile: bool,
                        forced_cpu: bool = False, batch: int = SERVE_B,
                        prompt: int = SERVE_PROMPT, aux_std: float = 1.0):
    """A model at full width on the card: seeded f32 params (a model with
    cross-attention: its gates drawn by ``set_gates`` and seeded stub aux
    embeddings), batch x prompt prompts prefilled and SERVE_GEN greedy
    decode steps (kernel 12 ``prefill_launches`` times in the prefill,
    never in decode; the peak above the params below one layer's f32
    score tensors and the cache the cross-attention adds), with
    ``profile`` one decode step under torch.profiler, then decode ==
    teacher forcing and card == CPU on ``cut(cfg, params)`` = (config,
    params, what): the CPU's own greedy steps, or with ``forced_cpu``
    steps fed the card's greedy tokens, whose every token must then be
    the CPU's argmax or within the tolerance of its largest logit (among
    100,000s of random logits, two can lie closer than bf16's rounding,
    and one flipped token sends two greedy runs apart).  With
    cross-attention, the same prefill with every gate at zero must move
    the logits past the tolerance, and card == CPU also holds enc_out,
    the cross K/V and each cross-attention's output.  With experts: the
    token-slots the served run drops are counted (RouteTap), swapping two
    experts' weights must move the prefill's logits past the tolerance,
    decode == teacher forcing runs at the no-drop capacity
    (``moe_teacher_forcing``), and card == CPU holds the routing first
    (``hold_routing``), then the MoE outputs at the agreeing tokens and
    the logits before the first differing one.  With recurrent cells: the
    first decode step from the prefill's cache with every state knocked
    out must move its logits past the tolerance, and decode == teacher
    forcing is held within RECURRENT_LOGIT_SHARE of max |logit| and below
    the teacher forcing's own distance from the same in f32 compute (the
    control: what bf16 alone moves).  Returns (params, info,
    the launches of the served prefill and decode alone, from zeroed
    counts); the caller deletes the params."""
    from repro_torch.data import synthetic_tokens
    from repro_torch.models import (forward_hidden, init_params,
                                    logits_from_hidden, num_params, prefill)

    info = {}
    torch.cuda.synchronize()
    free0 = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    torch.cuda.synchronize()
    count, nbytes = num_params(params)
    extra = cfg.uncounted_params()
    check(count == cfg.num_params() + extra, f"params {count} != the "
          f"config's {cfg.num_params()} and {extra} uncounted leaves")
    param_bytes = torch.cuda.memory_allocated() - free0
    print(f"serve: {cfg.name}: {count} parameters ({extra} of them "
          f"uncounted by num_params), {nbytes} bytes in {cfg.param_dtype}; "
          f"{cfg.n_layers} layers {cfg.layer_pattern}, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab} "
          f"(padded {cfg.padded_vocab}), window {cfg.window}, "
          f"{cfg.enc_layers} encoder layers, aux {aux_len(cfg)} tokens")
    if gate_leaves(params):
        gates = set_gates(torch, params, seed)
        info.update(gates=gates)
        print(f"serve: {cfg.name}'s cross-attention gates, drawn from "
              f"uniform [{GATE_LO}, {GATE_HI}): {gates}")
    aux = stub_aux(torch, cfg, batch, seed + 1, aux_std)
    if aux is not None:
        print(f"serve: {batch} x {aux_len(cfg)} stub aux embeddings, "
              f"normal with std {aux_std}")
    docs = synthetic_tokens(batch, prompt, cfg.vocab, seed=seed)
    prompts = torch.from_numpy(docs).cuda()
    torch.cuda.reset_peak_memory_stats()
    # the main path: the served prefill and decode, from zeroed counts
    recurrent = any(k in RECURRENT for k in layer_kinds(cfg))
    snap = {}

    def keep(cache):
        """the prefill's cache, for the state knock-out"""
        snap["cache"] = _tree_clone(cache)
    zero_counts()
    with RouteTap() as served:
        steps, toks, t_pre, t_dec, n_pre, n_dec, cache = serve(
            torch, cfg, params, prompts, SERVE_GEN, prompt + SERVE_GEN,
            aux=aux, on_prefill=keep if recurrent else None)
    launches = LaunchLog.counts()
    peak = torch.cuda.max_memory_allocated() - param_bytes - free0
    scores = layer_score_bytes(cfg, batch, prompt)
    cross_bytes = aux_cache_bytes(cfg, batch)
    live = prefill_live_bytes(cfg, batch, prompt, prompt + SERVE_GEN)
    check(tensor_bytes({k: v for k, v in cache.items() if k == "enc_out"})
          + sum(tensor_bytes(c["xattn"]) for part in ("groups", "rem")
                for c in cache.get(part, {}).values() if "xattn" in c)
          == cross_bytes, f"the prefill's cross caches are not the "
          f"{cross_bytes} B their shapes give")
    want_pre = prefill_launches(cfg)
    check(n_pre == want_pre and n_dec == 0,
          f"flash_attention launched {n_pre} times in the prefill and "
          f"{n_dec} in decode, expected {want_pre} and 0")
    check(peak < scores + cross_bytes, f"serve peak {peak} B above the "
          f"params, not below one layer's score tensors ({scores} B) and "
          f"the cross caches ({cross_bytes} B)")
    check(peak < live, f"serve peak {peak} B above the params, not below "
          f"what the prefill can hold at once ({live} B, "
          f"prefill_live_bytes)")
    check(all(bool(torch.isfinite(s[:, :cfg.vocab]).all())
              for s in steps), "serve logits are not finite")
    info.update(prefill_s=t_pre, decode_s=t_dec,
                decode_tokens_per_s=batch * SERVE_GEN / t_dec,
                peak_above_params_bytes=peak, param_bytes=param_bytes,
                peak_bound_scores_bytes=scores + cross_bytes,
                peak_bound_live_bytes=live,
                prefill_launches=n_pre, decode_launches=n_dec)
    print(f"serve (cuda): {batch} x {prompt} prompt tokens "
          f"prefilled in {t_pre:.3f} s ({n_pre} flash_attention "
          f"launches), {SERVE_GEN} greedy steps in {t_dec:.3f} s = "
          f"{batch * SERVE_GEN / t_dec:.1f} tokens/s; peak {peak} B "
          f"above the params (one layer's f32 scores: {scores} B, the "
          f"cross caches: {cross_bytes} B, what the prefill can hold at "
          f"once: {live} B); launches {json.dumps(launches)}")
    if cfg.num_experts:
        from repro_torch.models.layers import near_ties
        pre, per_step = route_drops(served.routes, cfg.n_layers)
        ties = sum(int(near_ties(r, NEAR_TIE).sum())
                   for r in served.routes[:cfg.n_layers])
        slots = batch * prompt * cfg.top_k * cfg.n_layers
        info.update(prefill_dropped_slots=pre, prefill_slots=slots,
                    decode_dropped_slots=per_step, prefill_near_ties=ties,
                    capacity_factor=cfg.capacity_factor)
        print(f"serve: {cfg.name} at the capacity factor "
              f"{cfg.capacity_factor}: the prefill dropped {pre} of its "
              f"{slots} token-slots ({ties} tokens at a near tie); each "
              f"decode step dropped {per_step} of "
              f"{batch * cfg.top_k * cfg.n_layers}")
    if profile:
        info.update(profile_decode(torch, cfg, params, cache, toks[:, -1:],
                                   prompt + SERVE_GEN))
    del cache

    del served

    if aux is not None:
        # the cross-attention moved the logits: the same prefill with
        # every gate at zero
        saved = [g.clone() for g in gate_leaves(params)]
        for g in gate_leaves(params):
            g.zero_()
        with torch.no_grad():
            zl, zc = prefill(cfg, params, prompts, aux=aux,
                             cache_len=prompt + SERVE_GEN)
        del zc
        for g, v in zip(gate_leaves(params), saved):
            g.copy_(v)
        moved = float((zl[:, :cfg.vocab] - steps[0][:, :cfg.vocab]).abs()
                      .max())
        tol = logits_tolerance(steps[0][:, :cfg.vocab])
        check(moved > tol, f"the cross-attention moved the prefill's "
              f"logits by {moved}, not past the tolerance {tol}")
        info.update(gates_zero_moved=moved, gates_zero_tol=tol)
        print(f"serve: with every gate at zero the prefill's logits move "
              f"by {moved} (tolerance {tol}): the cross-attention counts")
        del zl

    if recurrent:
        # the recurrent state counts: the first decode step from the
        # prefill's cache with every cell's state knocked out
        from repro_torch.train import make_decode_step
        ko = snap.pop("cache")
        knock_out_states(ko)
        with torch.no_grad():
            kl, _ = make_decode_step(cfg)(params, ko, toks[:, :1], prompt)
        del ko
        moved = float((kl[:, :cfg.vocab] - steps[1][:, :cfg.vocab]).abs()
                      .max())
        tol = logits_tolerance(steps[1][:, :cfg.vocab])
        check(moved > tol, f"knocking out the recurrent state moved the "
              f"first decode step's logits by {moved}, not past the "
              f"tolerance {tol}")
        info.update(state_knockout_moved=moved, state_knockout_tol=tol)
        print(f"serve: with every recurrent state knocked out after the "
              f"prefill, the first decode step's logits move by {moved} "
              f"(tolerance {tol}): the state counts")
        del kl

    if cfg.num_experts:
        del steps
        info["teacher_forcing"] = moe_teacher_forcing(torch, cfg, params,
                                                      prompts)
    else:
        # decode == teacher forcing: the prompt extended by the decoded
        # tokens, in one forward
        full = torch.cat([prompts, toks], dim=1)
        with torch.no_grad():
            h, _ = forward_hidden(cfg, params, full, aux=aux, mode="train")
            tf = logits_from_hidden(cfg, params,
                                    h[:, prompt - 1:])[..., :cfg.vocab]
        del h
        dec = torch.stack([s[:, :cfg.vocab] for s in steps], dim=1)
        err = float((dec - tf).abs().max())
        tol = logits_tolerance(tf, RECURRENT_LOGIT_SHARE if recurrent
                               else 2e-2)
        agree = float((dec.argmax(-1) == tf.argmax(-1)).float().mean())
        del dec, steps
        check(err <= tol, f"decode vs teacher forcing: max |err| {err} "
              f"over {tol}")
        info.update(teacher_forcing_max_err=err, teacher_forcing_tol=tol,
                    teacher_forcing_argmax_agreement=agree)
        print(f"serve: decode == teacher forcing over {SERVE_GEN + 1} "
              f"positions: max |logit err| {err} (tolerance {tol}); "
              f"argmax agreement {agree}")
        if recurrent:
            # the control: the same teacher forcing in f32 compute
            import dataclasses
            f32 = dataclasses.replace(cfg, compute_dtype="float32")
            with torch.no_grad():
                h, _ = forward_hidden(f32, params, full, aux=aux,
                                      mode="train")
                drift = float((logits_from_hidden(
                    f32, params, h[:, prompt - 1:])[..., :cfg.vocab]
                    - tf).abs().max())
            del h
            check(err <= drift, f"decode vs teacher forcing in "
                  f"{cfg.compute_dtype}: max |err| {err}, past the "
                  f"{drift} that {cfg.compute_dtype} alone moves the "
                  f"teacher forcing's logits from f32")
            info.update(teacher_forcing_vs_f32=drift)
            print(f"serve: in {cfg.compute_dtype}, teacher forcing lies "
                  f"{drift} from the same in f32 (max |logit| "
                  f"{float(tf.abs().max())}): decode lies closer to it")
        del full, tf

    # card == CPU on the cut model
    one, p1, what = cut(cfg, params)
    p1_cpu = _tree_to(p1, "cpu")
    prompt1 = prompts[:1, :CPU_PROMPT]
    aux1 = None if aux is None else aux[:1]
    with CrossTap() as c_tap, RouteTap(outputs=True) as c_route:
        c_steps, c_toks, *_, c_cache = serve(
            torch, one, p1, prompt1, CPU_GEN, prompt1.shape[1] + CPU_GEN,
            aux=aux1)
    with CrossTap() as h_tap, RouteTap(outputs=True) as h_route:
        h_steps, h_toks, t_cpu, *_, h_cache = serve(
            torch, one, p1_cpu, prompt1.cpu(), CPU_GEN,
            prompt1.shape[1] + CPU_GEN,
            forced=c_toks.cpu() if forced_cpu else None,
            aux=None if aux1 is None else aux1.cpu())
    c = torch.stack(c_steps).cpu()[..., :cfg.vocab]
    hh = torch.stack(h_steps)[..., :cfg.vocab]
    held = list(range(c.shape[0]))
    if one.num_experts:
        # the routing first: a token whose choice may flip between two
        # roundings moves its output by far more than the tolerance, so
        # the outputs and logits are held where the routing agrees
        import resource
        n, p0 = one.n_layers, prompt1.shape[1]
        rinfo, agrees = hold_routing(torch, c_route.routes, h_route.routes,
                                     what)
        rinfo["moe_output_share"] = hold_moe_outputs(
            torch, c_route.ys, h_route.ys, agrees, what)
        differ = differing_positions(
            agrees, [0 if i < n else p0 + i // n - 1
                     for i in range(len(agrees))])
        held = [i for i in held if p0 - 1 + i not in differ]
        check(len(held) > 0, f"card vs CPU at {what}: no position whose "
              f"routing agrees")
        rinfo.update(logit_positions=len(held),
                     host_peak_rss_bytes=resource.getrusage(
                         resource.RUSAGE_SELF).ru_maxrss * 1024)
        info.update(card_vs_cpu_routing=rinfo)
        print(f"serve: card == CPU at {what}, the routing: "
              f"{json.dumps(rinfo)}")
    del c_route, h_route
    err = float((c[held] - hh[held]).abs().max())
    tol = logits_tolerance(hh)
    check(err <= tol, f"card vs CPU at {what}: max |err| {err} over {tol}")
    if aux is not None:
        # the cross-attention's own part, each within 2e-2 of its own
        # largest value: enc_out, every cross K/V, every cross-attention
        # output of the prefill (the logit check sees a wrong one only
        # past the tolerance of the logits)
        check(len(c_tap.outs) == len(h_tap.outs) == sum(
            k in ("xattn", "dec") for k in layer_kinds(one)),
            f"the prefills ran {len(c_tap.outs)} and {len(h_tap.outs)} "
            f"cross-attentions")
        shares = hold_relative(torch, cross_leaves(c_cache),
                               cross_leaves(h_cache), what)
        shares.update(hold_relative(
            torch, {f"cross_attention[{i}]": y
                    for i, y in enumerate(c_tap.outs)},
            {f"cross_attention[{i}]": y for i, y in enumerate(h_tap.outs)},
            what))
        info.update(card_vs_cpu_cross_shares=shares)
        print(f"serve: card == CPU at {what}, the cross-attention's part: "
              f"max |err| as a share of 2e-2 of each one's largest value: "
              f"{json.dumps(shares)}")
    if one.is_encdec:
        # which part moves the logits: the CPU's decoder fed the card's
        # enc_out (the CPU's prefill logits against the card's, with its
        # own encoder and with the card's)
        from repro_torch.models import decoder
        card_enc = c_cache["enc_out"].cpu()
        own = decoder.encode
        decoder.encode = lambda cfg_, params_, aux_: card_enc
        try:
            with torch.no_grad():
                dl, _ = prefill(one, p1_cpu, prompt1.cpu(), aux=aux1.cpu(),
                                cache_len=prompt1.shape[1] + CPU_GEN)
        finally:
            decoder.encode = own
        pre_err = float((c[0] - hh[0]).abs().max())
        dec_err = float((c[0] - dl[:, :cfg.vocab]).abs().max())
        info.update(card_vs_cpu_prefill_err=pre_err,
                    card_vs_cpu_prefill_err_card_enc_out=dec_err)
        print(f"serve: card == CPU at {what}, the prefill's logits: max "
              f"|err| {pre_err} with the CPU's own encoder, {dec_err} with "
              f"the card's enc_out fed to the CPU's decoder")
    del c_cache, h_cache
    if forced_cpu:
        # the logits that chose each card token, on the CPU
        chose = hh[:-1]
        gap = (chose.max(-1).values
               - chose.gather(-1, c_toks.cpu().T[..., None])[..., 0])
        gap = gap[[i for i in held if i < gap.shape[0]]]
        ties = int((chose.argmax(-1) != c_toks.cpu().T).sum())
        check(bool((gap <= tol).all()), f"card vs CPU: a card token is "
              f"{float(gap.max())} below the CPU's largest logit, past "
              f"{tol}")
        info.update(card_vs_cpu_near_ties=ties)
    else:
        check(torch.equal(c_toks.cpu(), h_toks), f"card vs CPU greedy "
              f"tokens differ: {c_toks.tolist()} vs {h_toks.tolist()}")
    info.update(card_vs_cpu_max_err=err, card_vs_cpu_tol=tol)
    tokens = (f"the CPU fed the card's greedy tokens {c_toks.tolist()}, "
              f"{info['card_vs_cpu_near_ties']} of them a near tie on the "
              f"CPU" if forced_cpu else
              f"greedy tokens equal {c_toks.tolist()}")
    print(f"serve: card == CPU at {what} (1 x {prompt1.shape[1]} tokens, "
          f"{CPU_GEN} steps): max |logit err| {err} (tolerance {tol}), "
          f"{tokens}; CPU prefill {t_cpu:.2f} s")
    del p1, p1_cpu, prompts, aux
    return params, info, launches


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.clone()


def knock_out_states(cache) -> None:
    """Every recurrent cell's state in a serving cache back to its start:
    lru, conv_state, mC, mn, sc, sn and sh to zero, the stabilizers mm
    and sm to -1e30."""
    for part in ("groups", "rem"):
        for block in cache.get(part, {}).values():
            for name, t in block.get("cell", {}).items():
                t.fill_(-1e30 if name in ("mm", "sm") else 0.0)


def device_ops(torch, fn):
    """The device kernels and copies of ``fn()`` under torch.profiler;
    None where the profiler saw none (device tracing unavailable)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events())
    return n or None


def recurrent_block_times(torch, cfg, params) -> dict:
    """Each recurrent kind of the config alone on the card, on its first
    layer's params: one cell (``layers.rglru_block``, ``mlstm_block`` or
    ``slstm_block``) in prefill mode over SERVE_B x SERVE_PROMPT seeded
    normal hidden states in the compute dtype, its wall on the host's
    clock around a synchronized call after a warm-up; the sLSTM's device
    kernels a step (torch.profiler at the STEP_COUNT_S lengths, their
    difference over the added steps); and one decode step of the whole
    model, its device kernels (from a fresh cache: values do not change
    what it launches)."""
    from repro_torch.models import decoder, init_serve_cache
    from repro_torch.models.blocks import _CELLS
    from repro_torch.models.layers import _cdtype
    from repro_torch.train import make_decode_step
    gen = torch.Generator(device="cuda").manual_seed(17)
    out = {}

    def hidden(s):
        return torch.randn((SERVE_B, s, cfg.d_model), generator=gen,
                           device="cuda").to(_cdtype(cfg))
    for i, kind in enumerate(cfg.layer_pattern):
        if kind not in RECURRENT or f"{kind}_prefill_s" in out:
            continue
        p = decoder.tree_map(lambda t: t[0],
                             params["groups"][str(i)]["cell"])
        cell = _CELLS[kind][2]
        with torch.no_grad():
            cell(cfg, p, hidden(SERVE_PROMPT // 32), mode="prefill")
            x = hidden(SERVE_PROMPT)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cell(cfg, p, x, mode="prefill")
            torch.cuda.synchronize()
            out[f"{kind}_prefill_s"] = time.perf_counter() - t0
            del x
            if kind == "slstm":
                a, b = (device_ops(torch, lambda: cell(
                    cfg, p, hidden(s), mode="prefill"))
                        for s in STEP_COUNT_S)
                out["slstm_kernels_a_step"] = (
                    None if a is None or b is None
                    else (b - a) / (STEP_COUNT_S[1] - STEP_COUNT_S[0]))
    n = sum(k == "slstm" for k in layer_kinds(cfg))
    if n:
        out["slstm_layers_prefill_s"] = n * out["slstm_prefill_s"]
    cache = init_serve_cache(cfg, SERVE_B, SERVE_PROMPT + SERVE_GEN,
                             device="cuda")
    tok = torch.zeros((SERVE_B, 1), dtype=torch.int64, device="cuda")
    step = make_decode_step(cfg)
    with torch.no_grad():
        step(params, cache, tok, SERVE_PROMPT)
        out["decode_step_kernels"] = device_ops(
            torch, lambda: step(params, cache, tok, SERVE_PROMPT + 1))
    del cache
    print(f"serve: {cfg.name}'s recurrent cells alone ({SERVE_B} x "
          f"{SERVE_PROMPT} tokens, prefill mode, one layer each): "
          f"{json.dumps(out)} (device kernels and copies from "
          f"torch.profiler; None: not measured)")
    return out


def one_layer(cfg, params):
    """The model cut to its first layer."""
    import dataclasses
    return (dataclasses.replace(cfg, n_layers=1),
            {"embedding": params["embedding"],
             "final_norm": params["final_norm"],
             "groups": {"0": _tree_slice(params["groups"]["0"])}},
            "one layer")


def local_and_global(cfg, params):
    """gemma3's pattern group cut to its last local and its global layer:
    both kinds of layer at head dim 168, in 2 of 6 layers."""
    import dataclasses
    groups = params["groups"]
    return (dataclasses.replace(cfg, n_layers=2,
                                layer_pattern=("local", "global")),
            {"embedding": params["embedding"],
             "final_norm": params["final_norm"],
             "groups": {"0": _tree_slice(groups["4"]),
                        "1": _tree_slice(groups["5"])}},
            "a local and a global layer")


def phase_serve_path(torch):
    """Phase 11: h2o-danube-3-4b at full width on the card, its
    geometries logged; its launches are the main path's runs' (the served
    run, the two EarlEval runs, the routing's group and keyed custom
    statistic), each from zeroed counts."""
    from repro_torch import random as trandom
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.data.pipeline import EvalSamplePipeline
    from repro_torch.train import EarlEval, make_eval_step

    cfg = get_config(SERVE_ARCH)
    with LaunchLog() as log:
        params, info, serve_launches = serve_at_full_width(
            torch, cfg, SERVE_SEED, one_layer, profile=True)

        # EarlEval at full width
        corpus = synthetic_tokens(EVAL_DOCS, EVAL_DOC_LEN, cfg.vocab,
                                  seed=SERVE_SEED + 1)
        pipe = EvalSamplePipeline(corpus, seq_len=EVAL_DOC_LEN - 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, eval_launches = main_run(lambda: EarlEval(
            make_eval_step(cfg), params, pipe, sigma=EVAL_SIGMA,
            tau=EVAL_TAU, eval_batch=EVAL_BATCH).run(trandom.PRNGKey(0)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev = res.history[-1]
        batches = -(-ev["model_forwards"] // EVAL_BATCH)
        check(ev["model_forwards"] < 0.5 * ev["full_pass_forwards"]
              and res.cv <= EVAL_SIGMA,
              f"EarlEval did not certify from under half the corpus: {ev}, "
              f"cv {res.cv}")
        check(eval_launches["flash_attention"] == batches * cfg.n_layers,
              f"EarlEval launched flash_attention "
              f"{eval_launches['flash_attention']} times for {batches} "
              f"batches")
        est = float(torch.as_tensor(res.result).reshape(-1)[0])
        info.update(eval_forwards=ev["model_forwards"],
                    eval_full_pass=ev["full_pass_forwards"], eval_cv=res.cv,
                    eval_wall_s=wall, eval_estimate=est, eval_B=res.B,
                    eval_iterations=res.iterations)
        print(f"EarlEval (cuda): model_forwards={ev['model_forwards']} of "
              f"full_pass_forwards={ev['full_pass_forwards']}, B={res.B}, "
              f"iterations={res.iterations}, loss {est}, cv={res.cv}, wall "
              f"{wall:.2f} s")
        grows, grow_launches = main_run(lambda: earl_eval_grows(
            torch, cfg, params, pipe, res.n_used))
        info.update(grows)
        del params, pipe, res
        torch.cuda.empty_cache()

        routing, routing_launches = routing_on_the_card(torch)
        info.update(routing)
    launches = add_counts(serve_launches, eval_launches, grow_launches,
                          routing_launches)
    for k in SERVE_KERNELS + ROUTING_KERNELS:
        check(launches[k] > 0, f"phase 11 launched no {k}")
    print(f"launches, the serving path: {json.dumps(launches)}")
    print("serve summary: " + json.dumps(info))
    return launches, log.geometries, info


def phase_serve_gemma(torch):
    """Phase 12: gemma3-27b at full width (head dim 168) on the card, cut
    to one 5:1 local:global pattern group, its geometries logged; the
    launches are the served run's, from zeroed counts."""
    import dataclasses
    from repro_torch.configs import get_config

    cfg = get_config(GEMMA_ARCH)
    check((cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads, cfg.window)
          == (GEMMA_D, GEMMA_HQ, GEMMA_HKV, GEMMA_W),
          f"{cfg.name} is not the shape kernel 12 is timed at")
    full_layers = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=GEMMA_LAYERS)
    print(f"serve: {cfg.name} cut from {full_layers} layers to one pattern "
          f"group {cfg.layer_pattern} ({GEMMA_LAYERS} layers): all "
          f"{full_layers} in f32 would be "
          f"{4 * get_config(GEMMA_ARCH).num_params()} bytes of parameters")
    with LaunchLog() as log:
        params, info, launches = serve_at_full_width(
            torch, cfg, GEMMA_SEED, local_and_global, profile=False,
            forced_cpu=True)
        del params
        torch.cuda.empty_cache()
    for k in SERVE_KERNELS:
        check(launches[k] > 0, f"phase 12 launched no {k}")
    print(f"launches, the gemma3 serving path: {json.dumps(launches)}")
    print("serve summary (gemma3-27b): " + json.dumps(info))
    return launches, log.geometries, info


def xattn_layer(cfg, params):
    """llama-3.2-vision's pattern group cut to its ``xattn`` layer: causal
    self-attention, then gated cross-attention over the image tokens, at
    full width."""
    import dataclasses
    return (dataclasses.replace(cfg, n_layers=1, layer_pattern=("xattn",)),
            {"embedding": params["embedding"],
             "final_norm": params["final_norm"],
             "groups": {"0": _tree_slice(params["groups"]["4"])}},
            "the xattn layer")


def whole_model(cfg, params):
    return cfg, params, "the whole model"


def first_group(cfg, params):
    """The model cut to its first pattern group (recurrentgemma-2b's two
    rglru layers and a local one; xlstm-350m's slstm and mlstm)."""
    import dataclasses
    return (dataclasses.replace(cfg, n_layers=cfg.pattern_len),
            {"embedding": params["embedding"],
             "final_norm": params["final_norm"],
             "groups": _tree_slice(params["groups"])},
            "the first pattern group")


def phase_serve_xattn(torch):
    """Phase 15: cross-attention serving on the card, its geometries
    logged and its launches the two served runs', each from zeroed
    counts: llama-3.2-vision-90b at its
    published widths cut to one pattern group, then whisper-small whole,
    each through ``serve_at_full_width`` (card == CPU on the xattn layer
    and on the whole whisper model, the CPU fed the card's tokens)."""
    import dataclasses
    from repro_torch.configs import get_config

    vlm = get_config(VLM_ARCH)
    wsp = get_config(WHISPER_ARCH)
    _, b, hq, hkv, _, ta, d = XA_TIMED[0]
    check((vlm.n_heads, vlm.n_kv_heads, vlm.vision_tokens, vlm.head_dim_)
          == (hq, hkv, ta, d) and b == SERVE_B, f"{vlm.name} is not the "
          f"shape kernel 12 is timed at")
    _, b, hq, hkv, sq, ta, d = XA_TIMED[2]
    check((wsp.n_heads, wsp.n_kv_heads, wsp.enc_seq, wsp.head_dim_)
          == (hq, hkv, ta, d) and (b, sq) == (WHISPER_B, WHISPER_PROMPT),
          f"{wsp.name} is not the shape kernel 12 is timed at")
    full_layers = vlm.n_layers
    vlm = dataclasses.replace(vlm, n_layers=VLM_LAYERS)
    print(f"serve: {vlm.name} cut from {full_layers} layers to one pattern "
          f"group {vlm.layer_pattern} ({VLM_LAYERS} layers): all "
          f"{full_layers} in f32 would be "
          f"{4 * get_config(VLM_ARCH).num_params()} bytes of parameters")
    t0 = time.perf_counter()
    info = {}
    with LaunchLog() as log:
        params, info["vlm"], vlm_launches = serve_at_full_width(
            torch, vlm, VLM_SEED, xattn_layer, profile=False,
            forced_cpu=True, aux_std=VLM_AUX_STD)
        del params
        torch.cuda.empty_cache()
        params, info["whisper"], wsp_launches = serve_at_full_width(
            torch, wsp, WHISPER_SEED, whole_model, profile=False,
            forced_cpu=True, batch=WHISPER_B, prompt=WHISPER_PROMPT)
        del params
        torch.cuda.empty_cache()
    launches = add_counts(vlm_launches, wsp_launches)
    for k in SERVE_KERNELS:
        check(launches[k] > 0, f"phase 15 launched no {k}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    info.update(card=smi, phase_s=time.perf_counter() - t0)
    print(f"launches, the cross-attention serving path: "
          f"{json.dumps(launches)}")
    print("serve summary (cross-attention): " + json.dumps(info))
    return launches, log.geometries, info


def shard_map_world1(torch, cfg, params) -> dict:
    """``moe_ffn_shard_map`` in a world of one NCCL rank (this process; a
    FileStore under a removed temporary directory; NCCL_SOCKET_IFNAME
    defaulted to lo), the mapping's "batch" on a one-way data axis and
    "mlp" on a one-way model axis, against ``moe_ffn`` on the model's
    first MoE layer at full width, over SERVE_B x SERVE_PROMPT seeded
    normal hidden states in the compute dtype: bitwise."""
    import dataclasses
    import os
    import shutil
    import tempfile
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.layers import (_cdtype, moe_ffn,
                                           moe_ffn_shard_map)

    p = {k: (v[0] if not isinstance(v, dict) else
             {n: t[0] for n, t in v.items()})
         for k, v in params["groups"]["0"]["mlp"].items()}
    x = torch.randn((SERVE_B, SERVE_PROMPT, cfg.d_model),
                    generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda").to(_cdtype(cfg))
    tmp = tempfile.mkdtemp(prefix="earl_moe_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "nccl"),
                                                 1))
    try:
        mesh = DeviceMesh("cuda", [[0]], mesh_dim_names=("data", "model"))
        mapping = mapping_from_mesh(mesh, {"batch": ("pod", "data"),
                                           "mlp": ("model",)})
        check(mapping == {"batch": (("data", 1),), "mlp": (("model", 1),)},
              f"mapping_from_mesh gave {mapping}")
        t0 = time.perf_counter()
        with torch.no_grad():
            want = moe_ffn(cfg, p, x)
            with activation_sharding(mapping, mesh=mesh):
                got = moe_ffn_shard_map(
                    dataclasses.replace(cfg, moe_impl="shard_map"), p, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(torch.equal(got, want), f"moe_ffn_shard_map in a world of one "
              f"NCCL rank differs from moe_ffn by "
              f"{float((got.float() - want.float()).abs().max())}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"serve: {cfg.name}: moe_ffn_shard_map in a world of one NCCL "
          f"rank ({mapping}) is moe_ffn bitwise on its first layer over "
          f"{SERVE_B} x {SERVE_PROMPT} tokens ({wall:.3f} s for both)")
    return dict(bitwise=True, mapping={k: list(v) for k, v in
                                       mapping.items()}, both_s=wall)


def phase_serve_moe(torch):
    """Phase 16: the MoE serving path on the card, its geometries logged
    and its launches the two served runs', each from zeroed counts:
    mixtral-8x22b cut to MIXTRAL_LAYERS layers in f32, then arctic-480b
    cut to ARCTIC_LAYERS in bf16, each through ``serve_at_full_width``
    (the routing mutation, decode == teacher forcing at the no-drop
    capacity, card == CPU on the first layer with the CPU fed the card's
    tokens and the routing held first), and on mixtral's first layer
    ``moe_ffn_shard_map`` in a world of one NCCL rank bitwise
    ``moe_ffn``."""
    import dataclasses
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    info, runs = {}, []
    with LaunchLog() as log:
        for key, arch, seed, n_layers in (
                ("mixtral", MIXTRAL_ARCH, MIXTRAL_SEED, MIXTRAL_LAYERS),
                ("arctic", ARCTIC_ARCH, ARCTIC_SEED, ARCTIC_LAYERS)):
            cfg = get_config(arch)
            _, hq, hkv, d, w = next(m for m in MOE_FA_TIMED if m[0] == key)
            check((cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
                   cfg.window or None) == (hq, hkv, d, w),
                  f"{cfg.name} is not the shape kernel 12 is timed at")
            width = 4 if cfg.param_dtype == "float32" else 2
            print(f"serve: {cfg.name} cut from {cfg.n_layers} layers to "
                  f"{n_layers}: all {cfg.n_layers} in {cfg.param_dtype} "
                  f"would be {width * cfg.num_params()} bytes of parameters")
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
            params, info[key], made = serve_at_full_width(
                torch, cfg, seed, one_layer, profile=False, forced_cpu=True)
            runs.append(made)
            if key == "mixtral":
                info[key]["shard_map_world1"] = shard_map_world1(
                    torch, cfg, params)
            del params
            torch.cuda.empty_cache()
    launches = add_counts(*runs)
    for k in SERVE_KERNELS:
        check(launches[k] > 0, f"phase 16 launched no {k}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    info.update(card=smi, phase_s=time.perf_counter() - t0)
    print(f"launches, the MoE serving path: {json.dumps(launches)}")
    print("serve summary (MoE): " + json.dumps(info))
    return launches, log.geometries, info


def phase_serve_recurrent(torch):
    """Phase 17: the recurrent serving path on the card, its geometries
    logged and its launches the two served runs', each from zeroed
    counts: recurrentgemma-2b whole, then xlstm-350m whole, each served in
    bf16 through ``serve_at_full_width`` (the state knock-out; decode ==
    teacher forcing with its f32 control; card == CPU on the first
    pattern group, the CPU fed the card's tokens), then each recurrent
    cell alone (``recurrent_block_times``)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    info, runs = {}, []
    with LaunchLog() as log:
        for key, arch, seed in (("recurrentgemma", RG_ARCH, RG_SEED),
                                ("xlstm", XL_ARCH, XL_SEED)):
            cfg = get_config(arch)
            if key == "recurrentgemma":
                check((cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
                       cfg.window) == (RG_HQ, RG_HKV, RG_D, RG_W),
                      f"{cfg.name} is not the shape kernel 12 is timed at")
            params, info[key], made = serve_at_full_width(
                torch, cfg, seed, first_group, profile=False,
                forced_cpu=True)
            runs.append(made)
            info[key].update(recurrent_block_times(torch, cfg, params))
            del params
            torch.cuda.empty_cache()
    launches = add_counts(*runs)
    check(launches["flash_attention"] == 8, f"phase 17 launched "
          f"flash_attention {launches['flash_attention']} times, expected "
          f"recurrentgemma-2b's 8 local layers' prefill")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    info.update(card=smi, phase_s=time.perf_counter() - t0)
    print(f"launches, the recurrent serving path: {json.dumps(launches)}")
    print("serve summary (recurrent): " + json.dumps(info))
    return launches, log.geometries, info


class _LossRows:
    """A sampler over a vector of per-document losses: an EarlSession on
    the CPU fed the losses that the card's EarlEval computed."""

    def __init__(self, losses, N: int):
        self.losses, self.N = losses, N

    def take(self, start: int, stop: int):
        check(stop <= len(self.losses), f"the CPU session took rows up to "
              f"{stop}, past the {len(self.losses)} the card computed")
        return self.losses[start:stop]


def earl_eval_grows(torch, cfg, params, pipe, n_before: int) -> dict:
    """EarlEval at sigma EVAL_SIGMA_GROW, below the pilot's cv: the
    session must grow the sample past the n_before rows that the run at
    EVAL_SIGMA used (its pilot) and certify
    from under half the corpus; its estimate is held against the plain
    mean of the losses its forwards returned, and its B, rows, iterations
    and estimate against an EarlSession on the CPU fed those losses."""
    from repro_torch import random as trandom
    from repro_torch.core import EarlSession, Mean
    from repro_torch.train import EarlEval, make_eval_step
    eval_step = make_eval_step(cfg)
    recorded = []

    def recording_step(p, batch):
        out = eval_step(p, batch)
        recorded.append(out.to(torch.float32).cpu())
        return out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = EarlEval(recording_step, params, pipe, sigma=EVAL_SIGMA_GROW,
                   tau=EVAL_TAU, eval_batch=EVAL_BATCH).run(
        trandom.PRNGKey(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = res.history[-1]
    losses = torch.cat(recorded)
    est = float(torch.as_tensor(res.result).reshape(-1)[0])
    check(not res.fell_back and res.n_used > n_before
          and res.cv <= EVAL_SIGMA_GROW
          and ev["model_forwards"] < 0.5 * ev["full_pass_forwards"],
          f"EarlEval at sigma {EVAL_SIGMA_GROW} did not grow past "
          f"{n_before} rows and certify from under half the "
          f"corpus: n_used {res.n_used}, {ev}, cv {res.cv}, fell back "
          f"{res.fell_back}")
    check(len(losses) == ev["model_forwards"] >= res.n_used,
          f"{len(losses)} losses recorded for {ev['model_forwards']} "
          f"forwards and {res.n_used} rows")
    x = losses[:res.n_used].double()
    plain = float(x.mean())
    tol = 1e-5 * float(x.abs().mean())
    check(abs(est - plain) <= tol, f"EarlEval's estimate {est} is not the "
          f"plain mean {plain} of its {res.n_used} losses (tolerance {tol})")
    cpu = EarlSession(_LossRows(losses, pipe.N), Mean(),
                      sigma=EVAL_SIGMA_GROW, tau=EVAL_TAU,
                      device="cpu").run(trandom.PRNGKey(0))
    cpu_est = float(torch.as_tensor(cpu.result).reshape(-1)[0])
    check((cpu.B, cpu.n_used, cpu.iterations, cpu.fell_back)
          == (res.B, res.n_used, res.iterations, res.fell_back)
          and abs(cpu_est - est) <= tol,
          f"the CPU session on the card's losses took B {cpu.B}, rows "
          f"{cpu.n_used}, {cpu.iterations} iterations, estimate {cpu_est}; "
          f"the card's EarlEval B {res.B}, rows {res.n_used}, "
          f"{res.iterations} iterations, estimate {est}")
    print(f"EarlEval (cuda, sigma {EVAL_SIGMA_GROW}): model_forwards="
          f"{ev['model_forwards']} of {ev['full_pass_forwards']}, B={res.B}, "
          f"n_used={res.n_used}, iterations={res.iterations}, loss {est} "
          f"(plain mean of its losses {plain}), cv={res.cv}, wall "
          f"{wall:.2f} s; the CPU session on the same losses agrees (B "
          f"{cpu.B}, n_used {cpu.n_used}, iterations {cpu.iterations}, "
          f"loss {cpu_est}, cv {cpu.cv})")
    return dict(grow_sigma=EVAL_SIGMA_GROW,
                grow_forwards=ev["model_forwards"], grow_n_used=res.n_used,
                grow_B=res.B, grow_iterations=res.iterations,
                grow_cv=res.cv, grow_estimate=est, grow_plain_mean=plain,
                grow_wall_s=wall, grow_history=res.history[:-1],
                grow_cpu_cv=cpu.cv)


def _tree_slice(tree):
    """Layer 0 of a stacked group of blocks, keeping the stacking axis."""
    if isinstance(tree, dict):
        return {k: _tree_slice(v) for k, v in tree.items()}
    return tree[:1]


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def replay_attention(torch, parity, gen, fields, what) -> None:
    """One kernel 12 launch geometry on fresh data against the plain
    version, at the scale the models use, D^-0.5; the same launch with
    lse written (a training forward's) must give the same bits, and lse
    the plain version's within 1e-4 + 1e-5·|lse| (-inf at its rows)."""
    from repro_torch.kernels.flash_attention import ops
    g = dict(fields)
    b = g["BHq"] // g["Hq"]
    dt = torch.float32 if g["dtype"] == 0 else torch.bfloat16
    q, k, v = fa_inputs(torch, (b, g["Hq"], g["Hkv"], g["Sq"], g["Skv"],
                                g["D"]), dt, gen)
    kw = dict(causal=bool(g["causal"]), window=g["window"] or None,
              kv_offset=g["kv_offset"], scale=g["D"] ** -0.5)
    with LaunchLog() as log:
        got = ops.flash_attention(q, k, v, **kw)
    check(("flash_attention", fields) in log.geometries,
          f"{what}: launched {list(log.geometries)}")
    want, lse_p = plain(ops.flash_attention_plain_lse, q, k, v, **kw)
    pv_abs = attention_pv_abs(q, k, v, kw) if q.element_size() == 2 else None
    parity.attention(got, want, what, pv_abs)
    del want, pv_abs
    with_lse, lse = ops._forward_cuda(q, k, v, with_lse=True, **kw)
    check(torch.equal(with_lse, got), f"{what}: the output with lse "
          f"differs from without")
    fin = torch.isfinite(lse_p)
    check(torch.equal(fin, torch.isfinite(lse)) and (
        not bool(fin.any()) or bool(((lse - lse_p)[fin].abs() <= 1e-4
                                     + 1e-5 * lse_p[fin].abs()).all())),
        f"{what}: lse is not the plain version's")


def library_f32_ms(torch, q, k, v, mask, scale):
    """One f32 scaled_dot_product_attention call of the same function,
    K/V expanded to the query heads beforehand and the memory-efficient
    backend asked for (f32 with a mask; PyTorch's math fallback would
    build the (B, H, S, S) scores); None, with the reason printed, where
    PyTorch refuses it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rep = q.shape[1] // k.shape[1]
    k32, v32 = (t.float().repeat_interleave(rep, dim=1) for t in (k, v))
    q32 = q.float()
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return time_ms(torch, lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               q32, k32, v32, attn_mask=mask, scale=scale), 2)
    except RuntimeError as e:
        print(f"scaled_dot_product_attention in f32 not timed: {e}")
        return None


def wide_head_times(torch, gen):
    """Kernel 12 past head dim 128 at the serving prefill's B and S: gemma3
    -27b's local (window 1024) and global layers (32/16 heads of 168) and
    recurrentgemma-2b's local layers (10/1 heads of 256, window 2048, the
    shape phase 17 serves); bf16 through the wrapper and alone (launches
    back to back inside one wrapper call), the f32 route and one bf16
    scaled_dot_product_attention call with the boolean causal(-window)
    mask; bound as the main row's."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain, visible_pairs)
    out = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    i = torch.arange(FA_S, device="cuda")
    for name, hq, hkv, d, w in (("gemma3_local", GEMMA_HQ, GEMMA_HKV, GEMMA_D,
                                 GEMMA_W),
                                ("gemma3_global", GEMMA_HQ, GEMMA_HKV,
                                 GEMMA_D, None),
                                ("recurrentgemma_local", RG_HQ, RG_HKV, RG_D,
                                 RG_W)):
        q, k, v = fa_inputs(torch, (FA_B, hq, hkv, FA_S, FA_S, d),
                            torch.bfloat16, gen)
        kw = dict(causal=True, window=w, scale=d ** -0.5)
        row = dict(case=name, B=FA_B, Hq=hq, Hkv=hkv, S=FA_S, D=d, window=w,
                   ms=time_ms(torch, lambda: flash_attention(q, k, v, **kw),
                              5),
                   alone_ms=launch_ms(torch, lambda: flash_attention(
                       q, k, v, **kw), "flash_attention", 5))
        if name == "gemma3_local":
            row["plain_ms"] = time_ms(torch, lambda: plain(
                flash_attention_plain, q, k, v, **kw), 1)
        q32, k32, v32 = (x.float() for x in (q, k, v))
        row["f32_ms"] = time_ms(torch, lambda: flash_attention(
            q32, k32, v32, **kw), 1)
        del q32, k32, v32
        mask = (i[None, :] <= i[:, None])
        if w is not None:
            mask = mask & (i[None, :] > i[:, None] - w)
        try:
            row["library_ms"] = time_ms(torch, lambda: sdpa(
                q, k, v, attn_mask=mask, scale=d ** -0.5, enable_gqa=True),
                2)
        except RuntimeError as e:
            row["library_ms"] = None
            print(f"scaled_dot_product_attention at {name} not timed: {e}")
        pairs = visible_pairs(FA_S, FA_S, True, w, 0)
        flops = 4 * d * pairs * FA_B * hq
        nbytes = 2 * (2 * FA_B * hq + 2 * FA_B * hkv) * FA_S * d
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        row.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   flops=flops, bytes=nbytes)
        out.append(row)
        del q, k, v, mask
        print(f"timing flash_attention at {name} ({FA_B} x {hq}/{hkv} heads "
              f"of {d}, {FA_S} tokens, window {w}): bf16 "
              f"{row['ms']:.4f} ms, alone {row['alone_ms']:.4f} ms; f32 "
              f"{row['f32_ms']:.4f} ms; masked bf16 sdpa "
              f"{row['library_ms']} ms; "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}"
              + (f"; plain {row['plain_ms']:.2f} ms" if "plain_ms" in row
                 else ""))
    return out


def cross_attention_times(torch, gen):
    """Kernel 12 at phase 15's non-causal geometries (XA_TIMED) in bf16:
    its time alone (launches back to back inside one wrapper call) and
    through the wrapper, its bound (4·D operations a query-key pair, all
    Sq·Skv of them visible, at the bf16 tensor-core rate, or q, k, v and o
    once over the memory rate) and one bf16 scaled_dot_product_attention
    call with no mask, K/V expanded to the query heads beforehand."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    for name, b, hq, hkv, sq, skv, d in XA_TIMED:
        q, k, v = fa_inputs(torch, (b, hq, hkv, sq, skv, d), torch.bfloat16,
                            gen)
        kw = dict(causal=False, scale=d ** -0.5)
        row = dict(case=name, B=b, Hq=hq, Hkv=hkv, Sq=sq, Skv=skv, D=d,
                   causal=False,
                   ms=launch_ms(torch, lambda: flash_attention(q, k, v, **kw),
                                "flash_attention", 10),
                   wrapper_ms=time_ms(torch, lambda: flash_attention(
                       q, k, v, **kw), 10))
        ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
        row["library_ms"] = time_ms(torch, lambda: sdpa(q, ke, ve,
                                                        scale=d ** -0.5), 10)
        flops = 4 * d * sq * skv * b * hq
        nbytes = 2 * (2 * b * hq * sq + 2 * b * hkv * skv) * d
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        row.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   flops=flops, bytes=nbytes)
        out.append(row)
        del q, k, v, ke, ve
        print(f"timing flash_attention at {name} ({b} x {hq}/{hkv} heads of "
              f"{d}, {sq} queries over {skv} keys, not causal): bf16 "
              f"{row['ms']:.4f} ms alone, {row['wrapper_ms']:.4f} ms through "
              f"the wrapper; sdpa {row['library_ms']:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']}")
    return out


def moe_attention_times(torch, gen):
    """Kernel 12 at phase 16's causal prefill geometries (MOE_FA_TIMED at
    SERVE_B x SERVE_PROMPT): mixtral's windowed layers and arctic's full
    causal ones, in bf16 (alone, launches back to back inside one wrapper
    call, and through the wrapper) and in f32, beside one bf16
    scaled_dot_product_attention call with the boolean causal(-window)
    mask and the bound (4·D operations a visible query-key pair at the
    bf16 tensor-core rate, or q, k, v and o once over the memory rate)."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         visible_pairs)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    i = torch.arange(SERVE_PROMPT, device="cuda")
    out = []
    for name, hq, hkv, d, w in MOE_FA_TIMED:
        q, k, v = fa_inputs(torch, (SERVE_B, hq, hkv, SERVE_PROMPT,
                                    SERVE_PROMPT, d), torch.bfloat16, gen)
        kw = dict(causal=True, window=w, scale=d ** -0.5)
        row = dict(case=name, B=SERVE_B, Hq=hq, Hkv=hkv, S=SERVE_PROMPT,
                   D=d, window=w,
                   ms=launch_ms(torch, lambda: flash_attention(q, k, v, **kw),
                                "flash_attention", 5),
                   wrapper_ms=time_ms(torch, lambda: flash_attention(
                       q, k, v, **kw), 5))
        q32, k32, v32 = (x.float() for x in (q, k, v))
        row["f32_ms"] = time_ms(torch, lambda: flash_attention(
            q32, k32, v32, **kw), 1)
        del q32, k32, v32
        mask = i[None, :] <= i[:, None]
        if w is not None:
            mask = mask & (i[None, :] > i[:, None] - w)
        row["library_ms"] = time_ms(torch, lambda: sdpa(
            q, k, v, attn_mask=mask, scale=d ** -0.5, enable_gqa=True), 2)
        pairs = visible_pairs(SERVE_PROMPT, SERVE_PROMPT, True, w, 0)
        flops = 4 * d * pairs * SERVE_B * hq
        nbytes = 2 * (2 * SERVE_B * hq + 2 * SERVE_B * hkv) * SERVE_PROMPT * d
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        row.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   flops=flops, bytes=nbytes)
        out.append(row)
        del q, k, v, mask
        print(f"timing flash_attention at {name}'s prefill ({SERVE_B} x "
              f"{hq}/{hkv} heads of {d}, {SERVE_PROMPT} tokens, window {w}): "
              f"bf16 {row['ms']:.4f} ms alone, {row['wrapper_ms']:.4f} ms "
              f"through the wrapper; f32 {row['f32_ms']:.4f} ms; sdpa "
              f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms "
              f"by {row['bound_by']}")
    return out


def serve_rows(torch, launches, parity: Parity):
    """Kernel 12 at the serving prefill's shape: 4 x 32 query heads on 8
    KV heads, 8192 tokens, head_dim 120, window 4096, bf16; the f32 route
    and scaled_dot_product_attention in f32 beside it; then past head dim
    128 (wide_head_times)."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain, visible_pairs)
    gen = torch.Generator(device="cuda").manual_seed(99)
    q, k, v = fa_inputs(torch, (FA_B, FA_HQ, FA_HKV, FA_S, FA_S, FA_D),
                        torch.bfloat16, gen)
    i = torch.arange(FA_S, device="cuda")
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - FA_W)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = dict(causal=True, window=FA_W, scale=FA_D ** -0.5)
    ms = time_ms(torch, lambda: flash_attention(q, k, v, **kw), 5)
    plain_ms = time_ms(torch, lambda: plain(flash_attention_plain, q, k, v,
                                            **kw), 2)
    # the f32 route (CUDA cores, IEEE f32) at the same shape
    q32, k32, v32 = (x.float() for x in (q, k, v))
    f32_ms = time_ms(torch, lambda: flash_attention(q32, k32, v32, **kw), 2)
    del q32, k32, v32
    library_ms = time_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask,
                                             scale=FA_D ** -0.5,
                                             enable_gqa=True), 5)
    f32_library_ms = library_f32_ms(torch, q, k, v, mask, FA_D ** -0.5)
    pairs = visible_pairs(FA_S, FA_S, True, FA_W, 0)
    # operations: QK^T and PV, 2·D each a visible pair; bytes: q, k, v and
    # o once each, in bf16
    flops = 4 * FA_D * pairs * FA_B * FA_HQ
    nbytes = 2 * (2 * FA_B * FA_HQ + 2 * FA_B * FA_HKV) * FA_S * FA_D
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    row = dict(name="flash_attention", route="cuda",
               source=SOURCES["flash_attention"],
               replaces=REPLACES["flash_attention"],
               launches=launches["flash_attention"],
               max_abs_err=parity.err["flash_attention"], ms=ms,
               plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=library_ms, f32_ms=f32_ms,
               library_f32_ms=f32_library_ms,
               registers={n: r for n, r in PTXAS_REGISTERS.items()
                          if "attention_tc" in n or "attention_f32" in n},
               shape=dict(B=FA_B, Hq=FA_HQ, Hkv=FA_HKV, S=FA_S, D=FA_D,
                          window=FA_W, dtype="bfloat16", pairs_per_head=pairs,
                          flops=flops, bytes=nbytes))
    print(f"flash_attention over phase 3 and the replay: max |err| "
          f"{parity.err['flash_attention']}, largest share of the bound "
          f"{json.dumps(parity.fa_share)}")
    print(f"timing flash_attention: {ms:.4f} ms in bf16 ({flops / ms / 1e9:.1f} "
          f"TFLOP/s of visible work; f32 route {f32_ms:.4f} ms; plain "
          f"{plain_ms:.2f} ms, scaled_dot_product_attention "
          f"{library_ms:.4f} ms (f32 {f32_library_ms} ms), bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']}: {pairs} visible "
          f"pairs a head, {flops} flops, {nbytes} bytes)")
    row["wide_heads"] = wide_head_times(torch, gen)
    row["not_causal"] = cross_attention_times(torch, gen)
    row["moe_models"] = moe_attention_times(torch, gen)
    return [row]



#: registers of every kernel instance ptxas reported in phase 1, by its
#: mangled name
PTXAS_REGISTERS = {}


def ptxas_registers(log: str) -> dict:
    """{mangled kernel name: registers} from a ptxas report."""
    regs, entry = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            entry = line.rsplit(" ", 1)[-1]
        elif "Used" in line and "registers" in line and entry:
            regs[entry] = int(line.split("Used", 1)[1].split()[0])
    return regs


def slot_registers(kernel: str, rows: int, dc: int):
    """Registers of the <rows, dc> instance of a slot kernel (None when
    the library was built before this run, with no report)."""
    tag = f"{kernel}ILi{rows}ELi{dc}E"
    found = [r for name, r in PTXAS_REGISTERS.items() if tag in name]
    return found[0] if found else None


def ctas_per_sm(regs, smem: int) -> int:
    """CTAs of 256 threads an H100 SM holds at ``regs`` registers a
    thread (allocated 256 a warp) and ``smem`` dynamic shared bytes (1 KB
    more a CTA reserved, 228 KB an SM), at most 8 (2,048 threads)."""
    by_regs = 8 if regs is None else 65536 // (8 * (-(-regs * 32 // 256))
                                              * 256)
    return min(8, by_regs, 233472 // (smem + 1024))


def slot_cost_terms(geo, kernel: str, pr, hashed_cols) -> dict:
    """A slot pass's cost terms, printed beside its time: the weights
    hashed, counted from this run's data (``hashed_cols``: for each chunk
    of keys (clusters), the columns whose key (cluster) it holds, each
    hashed once a row and chunk of DC columns of x), the shared
    read-add-writes those weights make (a key's 2·DC+1 slots; for kernel 8
    a cluster's DC sums, and its count in the first column chunk only),
    the registers ptxas reported in this run (None when the library was
    built before it) and the CTAs an SM they and the shared bytes allow."""
    ndc = -(-pr.d // geo.dc)
    cols = int(sum(hashed_cols))
    hashed = pr.Bp * cols * ndc
    if kernel == "grouped_moments_kernel":
        rmw = hashed * geo.per_key
    else:
        rmw = hashed * geo.dc + pr.Bp * cols
    regs = slot_registers(kernel, geo.rows, geo.dc)
    return dict(geometry=geo._asdict(), hashed_columns_by_chunk=hashed_cols,
                weights_hashed=hashed, rows_times_columns=pr.Bp * pr.np_,
                shared_read_add_writes=rmw, registers=regs,
                smem_bytes=geo.smem_bytes(),
                ctas_per_sm=ctas_per_sm(regs, geo.smem_bytes()))


def check_no_spills(log: str, kernel: str) -> None:
    """Every instance of ``kernel`` in a ptxas report spills 0 bytes (an
    empty report: the library was built before, nothing to read)."""
    entry, seen = None, 0
    for line in log.splitlines():
        if "Function properties for" in line:
            entry = line.rsplit(" ", 1)[-1]
        elif "spill" in line and entry and kernel in entry:
            seen += 1
            check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                  f"ptxas: {kernel} spills: {line.strip()}")
    check(seen > 0 or not log, f"ptxas reported no {kernel} instance")


# ---------------------------------------------------------------------------
# the live path (phase 13): session resume, windows, the live session and
# durable ingest
# ---------------------------------------------------------------------------
def tensor_bytes(tree) -> int:
    from repro_torch.checkpoint.manager import _leaves
    return sum(t.numel() * t.element_size() for _, t in _leaves(tree))


def ring_bytes(session) -> int:
    """Device bytes of a LiveSession's pane ring."""
    return tensor_bytes([(p.states, p.est) for p in session._ring.values()])


class FoldMeter:
    """Times a LiveSession's folds (the host's dispatch, the batch's copy
    included) and emits (the panes' merge, finalize and report, which ends
    in a device sync), counts the launches of ``kernel`` each fold made
    beside the panes its batch spans, and keeps the ring's largest
    occupancy and device bytes."""

    def __init__(self, session, kernel):
        self.fold_ms, self.emit_ms, self.per_fold = [], [], []
        self.max_panes = self.max_bytes = 0
        fold, emit = session._fold_into_panes, session._emit

        def timed_fold(batch, valid):
            before = kernel.launches
            t0 = time.perf_counter()
            fold(batch, valid)
            self.fold_ms.append(1e3 * (time.perf_counter() - t0))
            spans = len(session._masks_for(batch.row0, batch.rows, valid))
            self.per_fold.append((kernel.launches - before, spans))

        def timed_emit(seq, shed):
            t0 = time.perf_counter()
            out = emit(seq, shed)
            self.emit_ms.append(1e3 * (time.perf_counter() - t0))
            self.max_panes = max(self.max_panes, session.panes_live)
            self.max_bytes = max(self.max_bytes, ring_bytes(session))
            return out

        session._fold_into_panes = timed_fold
        session._emit = timed_emit

    def summary(self) -> dict:
        import statistics
        return dict(folds=len(self.fold_ms),
                    fold_ms_median=statistics.median(self.fold_ms),
                    emit_ms_median=statistics.median(self.emit_ms),
                    max_panes=self.max_panes, max_ring_bytes=self.max_bytes)


def same_live_report(a, b) -> bool:
    """Bitwise: thetas, estimate and the accounting the CI rides on."""
    def leaves(t):
        return list(t) if isinstance(t, tuple) else [t]
    return (all(bool(torch_equal(u, v)) for u, v in zip(
        leaves(a.thetas) + leaves(a.estimate),
        leaves(b.thetas) + leaves(b.estimate)))
        and (a.rows, a.valid_rows, a.p_eff, a.window_start, a.window_end)
        == (b.rows, b.valid_rows, b.p_eff, b.window_start, b.window_end))


def torch_equal(u, v) -> bool:
    return u.shape == v.shape and bool((u == v).all())


def live_resume(torch, tmp: str):
    """The quickstart group's EarlSession over RESUME_N rows on the card:
    killed after its first save and resumed (bitwise the uninterrupted
    run), resumed after a completed run (no kernel launch after the
    restore), run on the CPU (the same B, its first round within
    RESUME_ROWS_RTOL) and resumed on the CPU from the card's first
    snapshot (the card's rounds; mean within 1e-5, Std 26e-5 relative,
    the median within a bin).  Returns the walls and the launches of the
    uninterrupted run, the main path's, from zeroed counts."""
    import os
    import shutil
    from repro_torch import random as trandom
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import (EarlSession, Mean, Quantile,
                                  StatisticGroup, Std)
    from repro_torch.data import PreMapSampler, ShardedStore, synthetic_numeric

    data = synthetic_numeric(RESUME_N, mean=10.0, std=2.0, seed=0)

    def run(device=None, checkpoint=None, resume=False):
        store = ShardedStore.from_array(data, split_size=65_536)
        group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
        session = EarlSession(PreMapSampler(store, seed=1, device=device),
                              group, sigma=RESUME_SIGMA, tau=RESUME_TAU,
                              backend="fused_rng", checkpoint=checkpoint,
                              device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = session.run(trandom.PRNGKey(RESUME_KEY), resume=resume)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def same(a, b) -> bool:
        return ((a.B, a.n_used, a.iterations, a.cv, a.fell_back,
                 [e["n"] for e in a.history])
                == (b.B, b.n_used, b.iterations, b.cv, b.fell_back,
                    [e["n"] for e in b.history])
                and all(torch_equal(u, v) for u, v in zip(
                    a.result + a.ci_lo + a.ci_hi,
                    b.result + b.ci_lo + b.ci_hi)))

    class Restoring(CheckpointManager):
        """Notes the launch counts when its restore returns."""
        at_restore = None

        def restore(self, *a, **kw):
            out = super().restore(*a, **kw)
            torch.cuda.synchronize()
            self.at_restore = LaunchLog.counts()
            return out

    run()                                   # warm: builds and first calls
    zero_counts()
    base, base_s = run()
    launches = LaunchLog.counts()
    check(not base.fell_back and base.iterations >= 2 and base.B >= 16,
          f"the resume session did not iterate at a real B: B = {base.B}, "
          f"{base.iterations} rounds, fell_back={base.fell_back}")
    kill = os.path.join(tmp, "session_kill")
    try:
        run(checkpoint=dying_manager(kill, 1))
        check(False, "the session outlived its first save")
    except _Die:
        pass
    first = os.path.join(tmp, "session_first")    # for the CPU's resume
    shutil.copytree(kill, first)
    got, resume_s = run(checkpoint=CheckpointManager(kill, async_save=False),
                        resume=True)
    check(same(got, base), "the resumed session differs from the "
          "uninterrupted run")
    check(all(r.is_cuda for r in got.result), "the resumed result is not "
          "on the card")
    done = os.path.join(tmp, "session_done")
    full, _ = run(checkpoint=CheckpointManager(done, async_save=False))
    mgr = Restoring(done, async_save=False)
    again, again_s = run(checkpoint=mgr, resume=True)
    check(mgr.at_restore is not None
          and LaunchLog.counts() == mgr.at_restore,
          "the resume after a completed run launched a kernel after its "
          "restore")
    check(same(again, full) and same(full, base), "the resume after a "
          "completed run differs from the run")
    rows = [e["n"] for e in base.history]
    cpu, cpu_s = run("cpu")
    cpu_rows = [e["n"] for e in cpu.history]
    check(cpu.B == base.B and not cpu.fell_back
          and abs(cpu_rows[0] - rows[0]) <= RESUME_ROWS_RTOL * rows[0],
          f"cpu session took B = {cpu.B}, rounds {cpu_rows}; cuda B = "
          f"{base.B}, rounds {rows}")
    carried, carried_s = run("cpu", CheckpointManager(first, async_save=False),
                             resume=True)
    carried_rows = [e["n"] for e in carried.history]
    check((carried.B, carried.n_used, carried.iterations, carried.fell_back,
           carried_rows)
          == (base.B, base.n_used, base.iterations, base.fell_back, rows),
          f"the cpu session resumed from the card's first snapshot took "
          f"B = {carried.B}, rounds {carried_rows}; cuda B = {base.B}, "
          f"rounds {rows}")
    for name, c, g, tol in zip(
            ("mean", "median", "std"), carried.result, base.result,
            (1e-5, None, 26e-5)):
        c, g = float(c.reshape(-1)[0]), float(g.reshape(-1)[0])
        ok = (abs(c - g) <= (HI - LO) / NBINS if tol is None
              else abs(c - g) <= tol * abs(g))
        check(ok, f"the cpu resumed session's {name} {c} against the "
              f"card's {g}")
    info = dict(N=RESUME_N, sigma=RESUME_SIGMA, tau=RESUME_TAU,
                key=RESUME_KEY, B=base.B, n_used=base.n_used,
                iterations=base.iterations, rounds=rows, cpu_rounds=cpu_rows,
                cv=base.cv, killed_after_round=1, uninterrupted_s=base_s,
                resumed_s=resume_s, resumed_after_completion_s=again_s,
                cpu_s=cpu_s, cpu_resumed_from_card_s=carried_s)
    print("live: session resume (cuda): " + json.dumps(info))
    return info, launches


def window_oracle(torch, log, window, key, valid_of, B: int,
                  device="cuda"):
    """The window's report folded by hand: each pane of the last window
    from the batches it overlaps (whole batch, the pane's mask of
    ``valid_of(seq, rows)``, the batch's seed), the panes merged in
    ascending order; (thetas, estimate, p_eff)."""
    import numpy as np
    from repro_torch.core.bootstrap import (fused_resample_states,
                                            offset_seed, seed_from_key)
    stat, base = window.stat, seed_from_key(key)
    top = (log.total_rows - 1) // window.slide
    states = est = None
    rows = valid = 0
    for p in range(max(0, top - window.panes + 1), top + 1):
        lo, hi = window.pane_rows(p)
        st, es = stat.init_batch(1, B, device), stat.init_state(1, device)
        for sq in range(log.next_seq):
            b = log.batch(sq)
            if b.row_end <= lo or b.row0 >= hi:
                continue
            a, e = max(lo, b.row0) - b.row0, min(hi, b.row_end) - b.row0
            m = np.zeros(b.rows, np.float32)
            m[a:e] = valid_of(sq, b.rows)[a:e]
            x = torch.from_numpy(np.ascontiguousarray(b.data)).to(device)
            mt = torch.from_numpy(m).to(device)
            es = stat.update(es, x, mt)
            st = stat.merge(st, fused_resample_states(
                stat, offset_seed(base, sq), x, B, valid_mask=mt))
            rows += e - a
            valid += int(m.sum())
        states = st if states is None else stat.merge(states, st)
        est = es if est is None else stat.merge(est, es)
    p_eff = valid / rows
    return (stat.correct(stat.finalize_batch(states), p_eff),
            stat.correct(stat.finalize(est), p_eff), p_eff)


def hold_live_panes(torch, card, cpu, absolute, what) -> None:
    """Each pane of a card session against the CPU session's: w_tot and
    histogram counts bitwise, s1 within 1e-5·Σw|x| (``absolute``: the card
    session over |x|), s2 within 1e-5·Σw·x²."""
    from repro_torch.core.reduce_api import HistogramState, MomentState

    def hold(g, c, a, where):
        if isinstance(g, tuple):
            for i, parts in enumerate(zip(g, c, a)):
                hold(*parts, f"{where} slot {i}")
        elif isinstance(g, MomentState):
            check(torch_equal(g.w.cpu(), c.w), f"{what} {where}: w_tot "
                  "differs from the CPU's")
            for got, want, bound, name in ((g.s1, c.s1, a.s1, "s1"),
                                           (g.s2, c.s2, c.s2, "s2")):
                diff = (got.cpu() - want).abs()
                check(bool((diff <= 1e-5 * bound.cpu().abs()).all()),
                      f"{what} {where}: {name} max |err| "
                      f"{float(diff.max())} over its 1e-5 bound")
        else:
            check(isinstance(g, HistogramState)
                  and torch_equal(g.counts.cpu(), c.counts),
                  f"{what} {where}: histogram counts differ from the CPU's")

    check(sorted(card._ring) == sorted(cpu._ring) == sorted(absolute._ring),
          f"{what}: the card and the CPU hold other panes")
    for p in card._ring:
        hold(card._ring[p].states, cpu._ring[p].states,
             absolute._ring[p].states, f"pane {p} states")
        hold(card._ring[p].est, cpu._ring[p].est, absolute._ring[p].est,
             f"pane {p} estimate")


def live_stream(torch, tmp: str) -> dict:
    """2^24 f32 rows in 256 batches of 65,536 from a producer thread into
    an IngestLog(capacity=64), folded by session A (the quickstart group
    in 4 panes of 2^20 rows, kernel 4 once a fold) and session B (the
    README's Var window, two panes a batch, kernel 2 twice a fold, a
    checkpoint every 8 folds) at B = 256; then the gates on the same
    batches, and the durable log."""
    import dataclasses
    import os
    import threading

    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.core import (Mean, Median, Quantile, SlidingWindow,
                                  StatisticGroup, Std, Var)
    from repro_torch.core.streaming import bootstrap_streaming
    from repro_torch.data import synthetic_numeric
    from repro_torch.ft import FaultyStore, LagPolicy
    from repro_torch.kernels.fused_multi.ops import fused_poisson_multi
    from repro_torch.kernels.weighted_stats.ops import fused_poisson_moments
    from repro_torch.live import IngestLog, LiveSession

    n_b = LIVE_N // LIVE_BATCH
    data = synthetic_numeric(LIVE_N, mean=10.0, std=2.0, seed=LIVE_SEED)
    batches = [data[i * LIVE_BATCH:(i + 1) * LIVE_BATCH] for i in range(n_b)]
    key = trandom.PRNGKey(LIVE_SEED)

    def window_a():
        return SlidingWindow(StatisticGroup((Mean(), Quantile(
            0.5, lo=LO, hi=HI), Std())), *LIVE_A)

    def window_b():
        return SlidingWindow(Var(), *LIVE_B_WIN)

    # ---- sessions A and B against a producer thread ------------------
    log = IngestLog(capacity=LIVE_CAPACITY)
    a = LiveSession(log, window_a(), B=LIVE_B, key=key, name="A")
    b = LiveSession(log, window_b(), B=LIVE_B, key=key, name="B",
                    checkpoint=os.path.join(tmp, "B"),
                    checkpoint_every=LIVE_CKPT_EVERY)
    meters = {"A": FoldMeter(a, fused_poisson_multi),
              "B": FoldMeter(b, fused_poisson_moments)}
    errors = []

    def produce():
        try:
            for xb in batches:
                log.append(xb, timeout=120.0)
        except BaseException as exc:            # noqa: BLE001 — reported
            errors.append(exc)

    producer = threading.Thread(target=produce, name="live-producer",
                                daemon=True)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    producer.start()
    while min(a.counters.folded, b.counters.folded) < n_b:
        check(not errors, f"the producer failed: {errors}")
        check(time.perf_counter() - t0 < 300.0, "the live sessions did not "
              "drain the log within 300 s")
        if not (a.poll() + b.poll()):
            time.sleep(0.0002)
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = LaunchLog.counts()
    check(launches["fused_poisson_multi"] == n_b
          and launches["fused_poisson_moments"] == 2 * n_b,
          f"the drain of {n_b} batches launched {launches}")
    producer.join(timeout=60.0)
    check(not producer.is_alive() and not errors,
          f"the producer did not finish: {errors}")
    b.checkpoint.wait()
    rep_a, rep_b = a.report(), b.report()
    stream = dict(batches=n_b, rows=LIVE_N, B=LIVE_B, drain_s=drain_s,
                  batches_per_s=n_b / drain_s)
    for name, s, meter, launches_per in (("A", a, meters["A"], 1),
                                         ("B", b, meters["B"], 2)):
        pane = s._init_pane()
        pane_bytes = tensor_bytes((pane.states, pane.est))
        summary = meter.summary()
        summary.update(panes=s.window.panes, pane_bytes=pane_bytes)
        stream[name] = summary
        check(meter.max_panes <= s.window.panes,
              f"session {name}'s ring held {meter.max_panes} panes")
        check(meter.max_bytes <= s.window.panes * pane_bytes,
              f"session {name}'s ring held {meter.max_bytes} device bytes, "
              f"over {s.window.panes} x {pane_bytes}")
        check(all(k == p == launches_per for k, p in meter.per_fold),
              f"session {name}: launches per fold against the panes each "
              f"batch spans: {sorted(set(meter.per_fold))}")
    tail_rows = data[-LIVE_A[0]:, 0].astype(np.float64)
    for got, exact, tol, what in (
            (rep_a.estimate[0], tail_rows.mean(), 1e-5, "mean"),
            (rep_a.estimate[1], np.median(tail_rows), (HI - LO) / NBINS,
             "median"),
            (rep_a.estimate[2], tail_rows.std(), 1e-3, "std")):
        v = float(got.reshape(-1)[0])
        err = abs(v - exact) if what == "median" else abs(v / exact - 1)
        check(math.isfinite(v) and err <= tol,
              f"session A's window {what} {v} against {exact}")
    check(all(t.shape[0] == LIVE_B and bool(torch.isfinite(t).all())
              for t in rep_a.thetas + (rep_b.thetas,)),
          "a live session's thetas are not finite or of the wrong shape")
    var_exact = data[-LIVE_B_WIN[0]:, 0].astype(np.float64).var()
    check(abs(float(rep_b.estimate.reshape(-1)[0]) / var_exact - 1) < 1e-3,
          f"session B's window Var {rep_b.estimate} against {var_exact}")
    print("live: sessions A and B (cuda): " + json.dumps(stream))

    # ---- a cumulative Mean is the streaming bootstrap ---------------
    c = LiveSession(log, Mean(), B=LIVE_B, key=key, name="cumulative")
    c.poll()
    rep_c = c.report()
    ref = bootstrap_streaming(log.store, Mean(), LIVE_B, key,
                              chunk=LIVE_BATCH)
    check(torch_equal(rep_c.thetas, ref.thetas)
          and torch_equal(rep_c.estimate, ref.estimate),
          "the cumulative Mean session differs from bootstrap_streaming")

    # ---- duplicated and reordered delivery --------------------------
    faulty = FaultyStore(log.store)
    plan = faulty.delivery_plan(seed=42, p_duplicate=0.05, max_reorder=3)
    d = LiveSession(None, window_b(), B=LIVE_B, key=key)
    for sq in plan:
        d.feed(log.batch(sq))
    check(d.counters.folded == n_b
          and d.counters.duplicates == faulty.injected.duplicates > 0
          and faulty.injected.reordered > 0,
          f"the faulty delivery folded {d.counters}")
    check(same_live_report(d.report(), rep_b), "duplicated and reordered "
          "delivery differs from in-order delivery")

    # ---- session B killed between checkpoints, resumed --------------
    kill = os.path.join(tmp, "kill")
    k = LiveSession(None, window_b(), B=LIVE_B, key=key, checkpoint=kill,
                    checkpoint_every=LIVE_CKPT_EVERY)
    for sq in range(LIVE_KILL_AT):
        k.feed(log.batch(sq))
    k.checkpoint.wait()     # its last snapshot is on disk; later folds die
    del k
    t0 = time.perf_counter()
    r = LiveSession(log, window_b(), B=LIVE_B, key=key, checkpoint=kill,
                    checkpoint_every=LIVE_CKPT_EVERY, resume=True,
                    name="resumed")
    restored = r.counters.folded
    check(restored == LIVE_KILL_AT // LIVE_CKPT_EVERY * LIVE_CKPT_EVERY,
          f"the resumed session restored {restored} folds")
    check(all(t.is_cuda for p in r._ring.values()
              for t in (p.states.w, p.est.s1)),
          "the restored panes are not on the card")
    r.poll()
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    check(r.counters.folded == n_b and same_live_report(r.report(), rep_b),
          "the resumed session B differs from the uninterrupted run")

    # ---- shedding against the masked oracle ------------------------
    shed_log = IngestLog()
    for xb in batches[:LIVE_SHED_BATCHES]:
        shed_log.append(xb)
    policy = LagPolicy(max_lag_batches=LIVE_CAPACITY, shed_backlog=0,
                       p_shed=0.5, shed_seed=99)
    s = LiveSession(shed_log, window_b(), B=LIVE_B, key=key, policy=policy)
    shed = [rep.shed for rep in s.poll()]
    check(shed == [True] * (LIVE_SHED_BATCHES - 1) + [False],
          f"the backlogged poll shed {shed}")
    rep_s = s.report()

    def shed_mask(sq, rows):
        if sq == LIVE_SHED_BATCHES - 1:
            return np.ones(rows, np.float32)
        return (np.random.default_rng((99, sq)).random(rows) < 0.5
                ).astype(np.float32)

    thetas, estimate, p_eff = window_oracle(torch, shed_log, window_b(), key,
                                            shed_mask, LIVE_B)
    check(rep_s.p_eff == p_eff < 1.0 and torch_equal(rep_s.thetas, thetas)
          and torch_equal(rep_s.estimate, estimate),
          "the shed session differs from the masked oracle")

    # ---- a lost batch and its late arrival --------------------------
    late = {}
    for mode in ("fold", "drop"):     # a lone median: kernel 3 a fold
        s = LiveSession(None, Median(lo=LO, hi=HI), B=LIVE_B, key=key,
                        policy=LagPolicy(max_lag_batches=3, late=mode))
        hist = wrappers()["fused_poisson_hist"]
        before = hist.launches
        for sq in range(LIVE_LATE_BATCHES):
            if sq != LIVE_LOST:
                s.feed(log.batch(sq))
        lost_p = s.report().p_eff
        out = s.feed(log.batch(LIVE_LOST))
        late[mode] = (dataclasses.asdict(s.counters), lost_p,
                      s.report().p_eff, len(out))
        folds = s.counters.folded + s.counters.late_folded
        check(hist.launches - before == folds > 0,
              f"late={mode!r}: {hist.launches - before} launches of kernel "
              f"3 for {folds} folds")
    full_p = (LIVE_LATE_BATCHES - 1) / LIVE_LATE_BATCHES
    check(late["fold"][0]["gaps_skipped"] == 1 and late["fold"][1] == full_p
          and late["fold"][0]["late_folded"] == 1 and late["fold"][2] == 1.0
          and late["fold"][3] == 1, f"late='fold': {late['fold']}")
    check(late["drop"][0]["late_dropped"] == 1 and late["drop"][2] == full_p
          and late["drop"][3] == 0, f"late='drop': {late['drop']}")

    # ---- the first batches on the CPU ------------------------------
    small, absolute = IngestLog(), IngestLog()
    for xb in batches[:LIVE_CPU_BATCHES]:
        small.append(xb)
        absolute.append(np.abs(xb))
    t0 = time.perf_counter()
    for name, window in (("A", window_a), ("B", window_b)):
        runs = [LiveSession(lg, window(), B=LIVE_CPU_B, key=key, device=dev,
                            name=f"{name}-{dev}")
                for lg, dev in ((small, None), (small, "cpu"),
                                (absolute, None))]
        for s in runs:
            s.poll()
        hold_live_panes(torch, *runs, f"session {name}'s first "
                        f"{LIVE_CPU_BATCHES} batches at B={LIVE_CPU_B}")
    cpu_s = time.perf_counter() - t0

    stream.update(cumulative_equals_streaming=True,
                  delivery=dict(plan=len(plan),
                                duplicates=faulty.injected.duplicates,
                                reordered=faulty.injected.reordered),
                  resume=dict(killed_at_fold=LIVE_KILL_AT,
                              restored_folds=restored, resume_s=resume_s,
                              uninterrupted_drain_s=drain_s),
                  shed=dict(batches=LIVE_SHED_BATCHES, p_eff=p_eff),
                  late={m: dict(p_eff_lost=v[1], p_eff_after=v[2])
                        for m, v in late.items()},
                  cpu_check_s=cpu_s)
    print("live: gates (cuda): " + json.dumps(
        {k: stream[k] for k in ("delivery", "resume", "shed", "late",
                                "cpu_check_s")}))
    stream["durable"] = live_durable(torch, batches, log, rep_c, key, tmp)
    return stream, launches


def live_durable(torch, batches, log, rep_c, key, tmp: str) -> dict:
    """The same batches through DurableIngestLog under each fsync policy:
    append MB/s, the same segment bytes, the recovery scan, a tail
    consumer folding Mean() against a producer thread (bitwise the
    in-memory log's session), and the last segment torn at a header, a
    record-frame, a payload and a footer byte (each recovery bitwise the
    in-memory log fed the surviving batches)."""
    import os
    import shutil
    import threading

    import numpy as np
    from repro_torch.core import Mean
    from repro_torch.ft import torn_write
    from repro_torch.live import DurableIngestLog, IngestLog, LiveSession
    from repro_torch.live import segment as seg

    n_b = len(batches)
    seg_bytes = (seg.HEADER_SIZE + seg.REC_HEADER_SIZE + 4 + seg.FOOTER_SIZE
                 + LIVE_BATCH * 4)
    total = n_b * seg_bytes
    rates = {}
    for fsync in ("batch", "never", "always"):
        root = os.path.join(tmp, f"log_{fsync}")
        t0 = time.perf_counter()
        with DurableIngestLog(root, fsync=fsync) as dl:
            for xb in batches:
                dl.append(xb)
        rates[fsync] = total / (time.perf_counter() - t0) / 1e6
        names = sorted(os.listdir(root))
        check(names == [seg.segment_name(i) for i in range(n_b)],
              f"fsync={fsync!r} left {len(names)} files")
    base_root = os.path.join(tmp, "log_batch")
    for fsync in ("never", "always"):
        for i in range(n_b):
            name = seg.segment_name(i)
            with open(os.path.join(base_root, name), "rb") as f1, \
                    open(os.path.join(tmp, f"log_{fsync}", name), "rb") as f2:
                check(f1.read() == f2.read(), f"fsync={fsync!r} wrote other "
                      f"bytes than 'batch' in {name}")

    def same_store(store, n) -> bool:
        return len(store.splits) == n and all(
            np.array_equal(store.splits[i], log.store.splits[i])
            and store.split_checksum(i) == log.store.split_checksum(i)
            for i in range(n))

    t0 = time.perf_counter()
    rec = DurableIngestLog(base_root)
    scan_s = time.perf_counter() - t0
    check(rec.recovery.batches == n_b and rec.recovery.truncated_at is None
          and same_store(rec.store, n_b), f"recovery of the clean log: "
          f"{rec.recovery}")
    rec.close()

    # a tail consumer against a producer thread
    tail_root = os.path.join(tmp, "log_tail")
    os.makedirs(tail_root)
    errors = []

    def produce():
        try:
            with DurableIngestLog(tail_root, fsync="batch") as dl:
                for i, xb in enumerate(batches):
                    dl.append(xb)
                    if i % 8 == 7:
                        dl.flush()
        except BaseException as exc:            # noqa: BLE001 — reported
            errors.append(exc)

    tail = DurableIngestLog(tail_root, mode="tail")
    s = LiveSession(tail, Mean(), B=LIVE_B, key=key, name="tail")
    producer = threading.Thread(target=produce, name="durable-producer",
                                daemon=True)
    t0 = time.perf_counter()
    producer.start()
    while s.counters.folded < n_b:
        check(not errors, f"the durable producer failed: {errors}")
        check(time.perf_counter() - t0 < 300.0, "the tail consumer did not "
              "see every batch within 300 s")
        if not s.poll():
            time.sleep(0.001)
    tail_s = time.perf_counter() - t0
    producer.join(timeout=60.0)
    check(not producer.is_alive() and not errors,
          f"the durable producer did not finish: {errors}")
    check(s.counters.duplicates == 0
          and same_live_report(s.report(), rep_c), "the tail consumer's "
          "Mean differs from the in-memory log's session")

    # the last segment torn at a byte of each region
    last = seg.segment_name(n_b - 1)
    size = os.path.getsize(os.path.join(base_root, last))
    cuts = {"header": 10, "record frame": seg.HEADER_SIZE + 10,
            "payload": seg.HEADER_SIZE + seg.REC_HEADER_SIZE + 1000,
            "footer": size - 5}
    work = os.path.join(tmp, "log_work")
    for region, cut in cuts.items():
        shutil.copytree(base_root, work)
        torn_write(os.path.join(work, last), cut)
        dl = DurableIngestLog(work)
        r = dl.recovery
        check((r.batches, r.truncated_at, r.files_dropped,
               dl.counters.short_reads) == (n_b - 1, n_b - 1, 1, 1)
              and same_store(dl.store, n_b - 1),
              f"the last segment torn at its {region} (byte {cut}): {r}")
        dl.close()
        shutil.rmtree(work)
    info = dict(segment_bytes=seg_bytes, log_bytes=total,
                append_MB_per_s=rates, recovery_scan_s=scan_s,
                recovery_s_per_GB=scan_s / (total / 1e9),
                tail_consumer_s=tail_s, torn_cuts=cuts)
    print("live: durable ingest: " + json.dumps(info))
    return info


def phase_live_path(torch):
    """Phase 13: the session's checkpoint and resume, the live sessions
    and durable ingest on the card; every launch's geometry is logged for
    phase 8, and the launches of the main path (the uninterrupted session
    and the A/B drain, each from zeroed counts) are returned; every file
    goes under a temporary directory that is removed afterwards."""
    import shutil
    import tempfile

    torch.cuda.synchronize()
    zero_counts()
    tmp = tempfile.mkdtemp(prefix="earl_live_")
    t0 = time.perf_counter()
    try:
        with LaunchLog() as log:
            session, session_launches = live_resume(torch, tmp)
            live, drain_launches = live_stream(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    info = dict(session=session, live=live,
                phase_s=time.perf_counter() - t0)
    launches = {k: session_launches[k] + drain_launches[k]
                for k in session_launches}
    check(all(launches[k] > 0 for k in LIVE_KERNELS),
          f"a kernel of the live path was not launched: {launches}")
    print(f"launches, the live path: the session {json.dumps(session_launches)}"
          f"; the drain {json.dumps(drain_launches)}; phase 13 took "
          f"{info['phase_s']:.1f} s")
    return launches, log.geometries, info


def mesh_inputs(torch):
    """The mesh phase's global values, made alike in every process from
    MESH_KEY: x (MESH_N, 1) of the quickstart's law, [value, key] over
    MESH_G keys, and MESH_K 2-d blobs, on the card; and the blobs'
    centroids (near their centers) on the host."""
    import numpy as np
    from repro_torch.data import synthetic_clusters
    gen = torch.Generator().manual_seed(MESH_KEY)
    x = torch.randn(MESH_N, 1, generator=gen) * 2.0 + 10.0
    keys = torch.randint(0, MESH_G, (MESH_N, 1), generator=gen).float()
    blobs, centers = synthetic_clusters(MESH_N, k=MESH_K, dim=2,
                                        seed=MESH_KEY)
    cent = centers + 0.1 * np.random.default_rng(MESH_KEY).normal(
        size=centers.shape)
    values = dict(x=x.cuda(), keyed=torch.cat([x, keys], 1).cuda(),
                  blobs=torch.from_numpy(blobs).cuda())
    return values, torch.from_numpy(cent.astype(np.float32))


def mesh_families(cent):
    """Each family's statistic and the values it runs over."""
    from repro_torch.core import (GroupedStatistic, KMeansStep, Mean,
                                  Quantile, StatisticGroup, Std, Var)
    return {
        "mean": (Mean(), "x"), "var": (Var(), "x"),
        "median": (Quantile(0.5, nbins=NBINS, lo=LO, hi=HI), "x"),
        "group": (StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI),
                                  Std())), "x"),
        "grouped": (GroupedStatistic(Mean(), MESH_G), "keyed"),
        "kmeans": (KMeansStep(cent), "blobs")}


def mesh_states(stat, v, mesh=None, nshards=None):
    """A family's states in the three runs the world of 4 holds: one
    call, chunks of MESH_CHUNK rows (with the estimate state) and a
    PoissonDelta's two extends over the halves of the rows (through
    ``mesh``, or the ``nshards`` oracle merged as an extend merges)."""
    from repro_torch import random as trandom
    from repro_torch.core import (poisson_delta_extend, poisson_delta_init,
                                  sharded_fused_states)
    from repro_torch.core.bootstrap import seed_from_key
    key = trandom.PRNGKey(MESH_KEY)
    base = seed_from_key(key)
    kw = dict(mesh=mesh, nshards=nshards)
    half = v.shape[0] // 2
    out = {"one": sharded_fused_states(stat, base, v, MESH_B, **kw),
           "chunk": sharded_fused_states(stat, base, v, MESH_B,
                                         chunk=MESH_CHUNK,
                                         with_estimate=True, **kw)}
    if mesh is not None:
        pd = poisson_delta_init(stat, MESH_B, v.shape[1], key,
                                backend="fused_rng", mesh=mesh)
        for part in (v[:half], v[half:]):
            pd = poisson_delta_extend(pd, part)
        out["delta"] = (pd.states, pd.est_state)
        return out
    states = stat.init_batch(v.shape[1], MESH_B, v.device)
    est = stat.init_state(v.shape[1], v.device)
    for step, part in enumerate((v[:half], v[half:])):
        states = stat.merge(states, sharded_fused_states(
            stat, base, part, MESH_B, nshards=nshards, step=step))
        est = stat.update(est, part)
    out["delta"] = (states, est)
    return out


def flat_leaves(tree, prefix: str) -> dict:
    from repro_torch.checkpoint.manager import _leaves
    return {prefix + p: t for p, t in _leaves(tree)}


def psum_ms(torch, stat, states, groups) -> float:
    """ms a ``psum_state`` call of ``states`` (host clock, the card synced
    after each call; every rank of the groups calls it alike)."""
    stat.psum_state(states, groups)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_PSUM_REPS):
        stat.psum_state(states, groups)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / MESH_PSUM_REPS


def mesh_session(torch, data, mesh, key=RESUME_KEY):
    """The quickstart group's EarlSession over phase 13's law (RESUME_*)
    on the card, with ``mesh`` or without; (result, wall s)."""
    from repro_torch import random as trandom
    from repro_torch.core import (EarlSession, Mean, Quantile,
                                  StatisticGroup, Std)
    from repro_torch.data import PreMapSampler, ShardedStore
    store = ShardedStore.from_array(data, split_size=65_536)
    group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
    session = EarlSession(PreMapSampler(store, seed=1), group,
                          sigma=RESUME_SIGMA, tau=RESUME_TAU,
                          backend="fused_rng", mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = session.run(trandom.PRNGKey(key))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def session_key(r) -> tuple:
    """What two runs of a session must share bitwise, besides its
    tensors."""
    return (r.B, r.n_used, r.iterations, r.cv, r.fell_back,
            [(e["n"], e["cv"], e.get("member_cvs")) for e in r.history])


def same_session(torch, a, b) -> bool:
    return session_key(a) == session_key(b) and all(
        torch_equal(u, v) for u, v in zip(a.result + a.ci_lo + a.ci_hi,
                                          b.result + b.ci_lo + b.ci_hi))


def mesh_rank(argv) -> int:
    """One rank of phase 14's gloo world (``--mesh-rank R --mesh-world W
    --mesh-store FILE --mesh-out DIR``): the families' states, the
    session, the elastic reduce and ``psum_state``'s ms through the host,
    on the card, written to DIR/rank<R>.pt and DIR/rank<R>.json."""
    import os
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    opts = dict(zip(argv[1::2], argv[2::2]))
    rank, world = int(opts["--mesh-rank"]), int(opts["--mesh-world"])
    out = opts["--mesh-out"]
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import random as trandom
    from repro_torch.core import DistributedEarl
    from repro_torch.core._mesh import data_groups
    from repro_torch.data import synthetic_numeric
    from repro_torch.ft import (FailurePolicy, ShardEvents, elastic_estimate,
                                failure_mask)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(opts["--mesh-store"], world))
    try:
        mesh = DeviceMesh("cpu", list(range(world)), mesh_dim_names=("data",))
        values, cent = mesh_inputs(torch)
        res, info, runs = {}, {}, {}
        for name, (stat, vname) in mesh_families(cent).items():
            runs[name] = mesh_states(stat, values[vname], mesh=mesh)
            for run, tree in runs[name].items():
                res.update(flat_leaves(tree, f"{name}/{run}"))
        group = mesh_families(cent)["group"][0]
        info["psum_ms"] = psum_ms(torch, group, runs["group"]["one"],
                                  data_groups(mesh, "data"))
        data = synthetic_numeric(RESUME_N, mean=10.0, std=2.0, seed=0)
        r, info["session_s"] = mesh_session(torch, data, mesh,
                                            MESH_SESSION_KEY)
        res.update(flat_leaves((r.result, r.ci_lo, r.ci_hi), "session"))
        info["session"] = session_key(r)
        earl = DistributedEarl(mesh, group, MESH_B, backend="fused_rng")
        key = trandom.PRNGKey(MESH_KEY)
        er = elastic_estimate(
            earl, values["x"], key,
            ShardEvents(n_shards=world, lost=MESH_ELASTIC_LOST,
                        completion_s=MESH_ELASTIC_DONE_S),
            FailurePolicy(deadline_s=MESH_ELASTIC_DEADLINE_S))
        direct = earl.estimate_with_loss_mask(
            values["x"], failure_mask(MESH_N, world, [1, 3]), key,
            p=er.report.p_surviving)
        res.update(flat_leaves((er.report.result, er.report.ci_lo,
                                er.report.ci_hi), "elastic"))
        res.update(flat_leaves((direct.estimate, direct.report.ci_lo,
                                direct.report.ci_hi), "direct"))
        info["elastic"] = dict(lost=list(er.lost), late=list(er.late),
                               p=er.report.p_surviving, cv=er.report.cv,
                               direct_cv=direct.cv,
                               shards_lost=er.report.shards_lost)
        torch.save({k: t.cpu() for k, t in res.items()},
                   os.path.join(out, f"rank{rank}.pt"))
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    finally:
        dist.destroy_process_group()
    return 0


def spawn_mesh_world(tmp: str) -> list:
    """Phase 14's gloo ranks, fresh interpreters of this script (never a
    fork of a process that holds a CUDA context)."""
    import os
    procs = []
    for rank in range(MESH_WORLD):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--mesh-rank", str(rank), "--mesh-world", str(MESH_WORLD),
             "--mesh-store", os.path.join(tmp, "store"), "--mesh-out", tmp],
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def join_mesh_world(procs, tmp: str) -> None:
    """Waits for every rank (MESH_RANK_TIMEOUT_S each); any rank that
    exits nonzero or outlives its time fails the phase, with its log."""
    import os
    try:
        for p, _ in procs:
            p.wait(timeout=MESH_RANK_TIMEOUT_S)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for rank, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"rank{rank}.log")) as f:
                print(f.read()[-4000:], file=sys.stderr)
        check(p.returncode == 0, f"mesh rank {rank} exited {p.returncode}")


def mesh_world1(torch, values, cent):
    """Phase 14 (a) and (c) in this process, a world of one NCCL rank:
    the families, the session and DistributedEarl through the mesh
    bitwise the unsharded path.  Returns (info, the mesh calls'
    launches, the materialized step's weights on the host)."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch import random as trandom
    from repro_torch.core import (DistributedEarl, fused_resample_states,
                                  sharded_fused_states)
    from repro_torch.core._mesh import data_groups
    from repro_torch.core.bootstrap import offset_seed, seed_from_key
    from repro_torch.core.distributed import _poisson_for_shard
    from repro_torch.data import synthetic_numeric
    from repro_torch.ft import failure_mask

    mesh = DeviceMesh("cuda", [0], mesh_dim_names=("data",))
    launches, info = {}, {}

    def mesh_call(fn):
        out, made = counted(fn)
        for k, v in made.items():
            launches[k] = launches.get(k, 0) + v
        return out

    key = trandom.PRNGKey(MESH_KEY)
    base = seed_from_key(key)
    for name, (stat, vname) in mesh_families(cent).items():
        v = values[vname]
        got = mesh_call(lambda: sharded_fused_states(stat, base, v, MESH_B,
                                                     mesh=mesh))
        want = fused_resample_states(stat, base, v, MESH_B)
        check(all(torch_equal(a, b) for a, b in zip(
            flat_leaves(got, "").values(), flat_leaves(want, "").values())),
            f"mesh: world 1 {name} differs from the unsharded fused path")
    group = mesh_families(cent)["group"][0]
    info["psum_ms_world1_nccl"] = psum_ms(
        torch, group, fused_resample_states(group, base, values["x"],
                                            MESH_B),
        data_groups(mesh, "data"))
    data = synthetic_numeric(RESUME_N, mean=10.0, std=2.0, seed=0)
    mesh_session(torch, data, None)              # warm both
    mesh_session(torch, data, mesh)
    got, wall = mesh_call(lambda: mesh_session(torch, data, mesh))
    walls = {"mesh": [wall], "no_mesh": []}
    for kind in ("no_mesh", "no_mesh", "mesh"):
        r, wall = mesh_session(torch, data, mesh if kind == "mesh" else None)
        walls[kind].append(wall)
        if kind == "no_mesh":
            want = r
    check(same_session(torch, got, want) and got.iterations >= 2,
          f"mesh: the world-1 session differs from the one without a mesh "
          f"or did not iterate: {session_key(got)} against "
          f"{session_key(want)}")
    info.update(session_world1_walls_s=walls, session_world1=dict(
        B=got.B, n_used=got.n_used, iterations=got.iterations, cv=got.cv))
    mask = failure_mask(MESH_N, MESH_FT_SHARDS, MESH_FT_LOST).cuda()
    earl = DistributedEarl(mesh, group, MESH_B, backend="fused_rng")
    res = mesh_call(lambda: earl.estimate_with_loss_mask(values["x"], mask,
                                                         key))
    want = group.finalize_batch(fused_resample_states(
        group, offset_seed(base, 0), values["x"], MESH_B, valid_mask=mask))
    check(all(torch_equal(a, b) for a, b in zip(res.thetas, want))
          and res.n == int(mask.sum()),
          "mesh: DistributedEarl under failure_mask(n, 16, [0, 3, 7]) "
          "differs from the fused path under that valid_mask")
    # (c) the materialized step, and its shard's weights on the card,
    # which phase_mesh_path holds against the CPU's draw
    xs = values["x"][:MESH_MAT_N]
    mat = DistributedEarl(mesh, group, MESH_MAT_B)
    res = mesh_call(lambda: mat.estimate(xs, key))
    w = _poisson_for_shard(key, 0, MESH_MAT_B, MESH_MAT_N)
    want = group.finalize_batch(group.update_batch(
        group.init_batch(1, MESH_MAT_B, xs.device), xs, w))
    check(all(torch_equal(a, b) for a, b in zip(res.thetas, want)),
          "mesh: the materialized DistributedEarl differs from its "
          "weights' update_batch")
    check(all(launches.get(k, 0) > 0 for k in MESH_KERNELS),
          f"mesh: a kernel of the mesh path was not launched: {launches}")
    return info, launches, w.cpu()


def poisson_flips(torch, key, card, host, tol: float = 1e-6):
    """Holds the card's Poisson(1) draw of shard 0 (``_poisson_for_shard``)
    against the host's: bitwise, but for the flips ROADMAP §3 documents,
    where CUDA's and the host's f32 log differ by an ulp and an entry's
    running sum lies within that of -1.  Each differing entry is replayed
    from its own uniforms with both logs: the card's ladder must give the
    card's draw, the host's the host's, and the host's sum must lie within
    ``tol`` of -1 at the step where the first of the two stops.  Returns
    (flips, the largest |sum + 1| there)."""
    from repro_torch import random as trandom
    card = card.cpu().reshape(-1)
    host = host.reshape(-1)
    pos = (card != host).nonzero().reshape(-1)
    if pos.numel() == 0:
        return 0, 0.0
    rng = trandom.fold_in(key, 0)
    sums = {"cpu": torch.zeros(pos.numel()),
            "cuda": torch.zeros(pos.numel(), device="cuda")}
    draws = {d: torch.full((pos.numel(),), -1, dtype=torch.int64)
             for d in sums}
    history = []
    t = 0
    while any(bool((v < 0).any()) for v in draws.values()):
        check(t < 64, "mesh: a replayed Poisson ladder did not stop")
        rng, sub = trandom.split(rng)
        u = trandom._unit_floats(trandom.bits_at(sub, pos))
        for d in sums:
            sums[d] = sums[d] + torch.log(u.to(d))
            stop = (draws[d] < 0) & ~(sums[d].cpu() > -1.0)
            draws[d][stop] = t
        history.append(sums["cpu"].clone())
        t += 1
    first = torch.minimum(draws["cpu"], draws["cuda"])
    at = torch.stack(history)[first, torch.arange(pos.numel())]
    gap = float((at + 1.0).abs().max())
    check(torch.equal(draws["cuda"], card[pos].long())
          and torch.equal(draws["cpu"], host[pos].long()) and gap <= tol,
          f"mesh: {pos.numel()} of the card's shard weights differ from "
          f"the CPU's _poisson_for_shard, not all by the ulp flip of f32 "
          f"log near -1 (largest |sum + 1| {gap})")
    return int(pos.numel()), gap


def mesh_world4(torch, values, cent, tmp: str):
    """Phase 14 (b): the gloo world of 4 ranks on the one card, each rank
    bitwise the ``nshards=4`` oracle computed here while they run; their
    sessions bitwise each other and within 2% of the exact answers; the
    elastic reduce bitwise ``estimate_with_loss_mask`` at p = 0.5."""
    import numpy as np
    from repro_torch.data import synthetic_numeric
    t0 = time.perf_counter()
    procs = spawn_mesh_world(tmp)
    try:
        oracle = {}
        for name, (stat, vname) in mesh_families(cent).items():
            for run, tree in mesh_states(stat, values[vname],
                                         nshards=MESH_WORLD).items():
                oracle.update(flat_leaves(tree, f"{name}/{run}"))
        torch.cuda.synchronize()
    finally:
        join_mesh_world(procs, tmp)
    spawn_to_join = time.perf_counter() - t0
    ranks = []
    for rank in range(MESH_WORLD):
        got = torch.load(f"{tmp}/rank{rank}.pt", weights_only=True)
        with open(f"{tmp}/rank{rank}.json") as f:
            ranks.append((got, json.load(f)))
    for rank, (got, info) in enumerate(ranks):
        for k, want in oracle.items():
            check(torch_equal(got[k], want.cpu()), f"mesh: rank {rank}'s "
                  f"{k} differs from sharded_fused_states(nshards=4)")
        e = info["elastic"]
        check(e["p"] == 0.5 and e["shards_lost"] == 2 and e["late"] == [3]
              and e["cv"] == e["direct_cv"]
              and all(torch_equal(got[k], got["direct" + k[7:]])
                      for k in got if k.startswith("elastic")),
              f"mesh: rank {rank}'s elastic reduce {e} differs from "
              f"estimate_with_loss_mask at p = 0.5")
    got0, info0 = ranks[0]
    for rank, (got, info) in enumerate(ranks[1:], 1):
        check(info["session"] == info0["session"] and all(
            torch_equal(got[k], got0[k]) for k in got
            if k.startswith("session")),
            f"mesh: rank {rank}'s session differs from rank 0's")
    data = synthetic_numeric(RESUME_N, mean=10.0, std=2.0, seed=0)
    exact = (float(data.mean()), float(np.median(data)), float(data.std()))
    result = [float(got0[f"session[0][{i}]"].reshape(-1)[0])
              for i in range(3)]
    rel = [abs(r - e) / abs(e) for r, e in zip(result, exact)]
    check(max(rel) < 0.02 and not info0["session"][4],
          f"mesh: the world-4 session's rel_err {rel}, or it fell back to "
          f"the exact job: {info0['session'][:5]}")
    return dict(spawn_to_join_s=spawn_to_join,
                psum_ms_world4_gloo=info0["psum_ms"],
                session_world4_s=[i["session_s"] for _, i in ranks],
                session_world4=info0["session"][:5], rel_err=rel)


def phase_mesh_path(torch):
    """Phase 14: the mesh path, from zeroed counts; a world of one NCCL
    rank in this process, with its geometries logged for phase 8, then a
    world of 4 gloo ranks on the card (the ``nshards=4`` oracle they are
    held to runs here while they run, outside the log: phase 8 replays
    this process's main path).  The CPU's draw
    of the materialized step's weights runs in a thread from the start
    and is held to the card's last.  Returns the world-1 mesh calls'
    launches, the geometries and the info printed."""
    import numpy as np
    import os
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import torch.distributed as dist
    from repro_torch import random as trandom
    from repro_torch.core.distributed import _poisson_for_shard

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    zero_counts()
    tmp = tempfile.mkdtemp(prefix="earl_mesh_")
    pool = ThreadPoolExecutor(max_workers=1)
    draw = pool.submit(_poisson_for_shard, trandom.PRNGKey(MESH_KEY), 0,
                       MESH_MAT_B, MESH_MAT_N, "cpu")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "nccl"),
                                                 1))
    try:
        values, cent = mesh_inputs(torch)
        gloo = os.path.join(tmp, "gloo")
        os.makedirs(gloo)
        with LaunchLog() as log:
            info, launches, w = mesh_world1(torch, values, cent)
        info.update(mesh_world4(torch, values, cent, gloo))
        t1 = time.perf_counter()
        w_cpu = draw.result()
        info["cpu_draw_wait_s"] = time.perf_counter() - t1
        flips, gap = poisson_flips(torch, trandom.PRNGKey(MESH_KEY), w,
                                   w_cpu)
        info["materialized_weights"] = dict(
            entries=int(np.prod(w.shape)), ulp_flips=flips,
            largest_gap_to_minus_1=gap)
    finally:
        dist.destroy_process_group()
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    info.update(card=smi, phase_s=time.perf_counter() - t0)
    print("mesh: " + json.dumps(info))
    print(f"launches, the mesh path (world 1): {json.dumps(launches)}; "
          f"phase 14 took {info['phase_s']:.1f} s")
    return launches, log.geometries, info


# ---------------------------------------------------------------------------
# the training path (phase 18): granite-3-2b trained whole, gemma3-27b and
# recurrentgemma-2b at their published widths
# ---------------------------------------------------------------------------
#: kernel 12's backward against its plain version, beside the slice's own
#: geometry: (name, (b, hq, hkv, sq, skv, d), kwargs) at the other
#: models' train-mode geometries, 1 x TRAIN_S tokens (h2o-danube-3-4b's
#: window 4096, gemma3-27b's local and global layers at head dim 168,
#: recurrentgemma-2b's window 2048 at head dim 256), phase 15's non-causal
#: ones at batch 1, a query block that sees no key and a kv_offset > 0
BWD_CASES = (
    ("h2o_window", (1, 32, 8, 4096, 4096, 120), dict(causal=True,
                                                      window=4096)),
    ("gemma3_local", (1, 32, 16, 4096, 4096, 168), dict(causal=True,
                                                         window=1024)),
    ("gemma3_global", (1, 32, 16, 4096, 4096, 168), dict(causal=True)),
    ("recurrentgemma_local", (1, 10, 1, 4096, 4096, 256),
     dict(causal=True, window=2048)),
    ("llama_cross_attention", (1, 64, 8, 8192, 1600, 128),
     dict(causal=False)),
    ("whisper_encoder", (1, 12, 12, 1500, 1500, 64), dict(causal=False)),
    ("whisper_cross_attention", (1, 12, 12, 224, 1500, 64),
     dict(causal=False)),
    ("no_key", (1, 2, 1, 64, 32, 16), dict(causal=True, window=16,
                                            kv_offset=FA_NO_KEY_OFFSET)),
    ("kv_offset", (2, 4, 2, 200, 300, 64), dict(causal=True,
                                                kv_offset=64)),
)


def bwd_bounds(torch, q, k, v, o, do, lse, causal, window, kv_offset,
               scale, heads: int = 8):
    """Σ|terms| of each entry of dq, dk and dv, dense in f32 a few query
    heads at a time: P from lse, |dS| bounded by P·(|dO|·|V|ᵀ + rowsum|dO
    ∘ O|)."""
    from repro_torch.kernels.flash_attention.ref import attention_mask
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    mask = attention_mask(sq, skv, causal, window, kv_offset, q.device)
    lse4 = lse.reshape(b, hq, sq, 1)
    bq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    bk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    bv = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    for h0 in range(0, hq, heads):
        hs = slice(h0, min(h0 + heads, hq))
        kvh = torch.arange(hs.start, hs.stop, device=q.device) // g
        qf, of, dof = (t[:, hs].float() for t in (q, o, do))
        kf, vf = k[:, kvh].float(), v[:, kvh].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
        p = torch.where(mask, torch.exp(s - lse4[:, hs]), 0.0)
        del s
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof.abs(), vf.abs())
                  + (dof * of).abs().sum(-1, keepdim=True))
        bq[:, hs] = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kf.abs())
        bk.index_add_(1, kvh, scale * torch.einsum("bhqk,bhqd->bhkd", ds,
                                                   qf.abs()))
        bv.index_add_(1, kvh, torch.einsum("bhqk,bhqd->bhkd", p, dof.abs()))
        del p, ds
    return bq, bk, bv


def hold_backward(torch, parity, got, want, bounds, what, tc=False):
    """The backward kernel's (dq, dk, dv) against the plain version's:
    each entry within 1e-5·Σ|terms| (``bwd_bounds``), and in bf16 also
    one bf16 rounding of the value, 2^-7·|want|; on the tensor-core route
    (``tc``) also 2^-8·Σ|terms|: P and dS are rounded to bf16 (RNE,
    relative 2^-8 at most) before the products that take them, one
    rounded factor in each term.  Returns the largest share of the bound
    used."""
    share = 0.0
    for name, g, w, bd in zip(("dq", "dk", "dv"), got, want, bounds):
        diff = (g.float() - w.float()).abs()
        tol = (1e-5 + (2.0 ** -8 if tc else 0.0)) * bd
        if w.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * w.float().abs()
        parity.err["flash_attention_bwd"] = max(
            parity.err["flash_attention_bwd"], float(diff.max()))
        share = max(share, float((diff / tol.clamp_min(1e-30)).max()))
        check(g.dtype == w.dtype and g.shape == w.shape
              and bool((diff <= tol).all()),
              f"flash_attention_bwd {what}: {name} max |err| "
              f"{float(diff.max())}")
    return share


def backward_case(torch, parity, gen, shape, kw, dtype, what):
    """Kernel 12 with lse and its backward kernel on fresh unit-normal q, k,
    v and dO at the models' scale D^-0.5, against the plain versions
    (each checked to launch nothing): the forward's output bitwise the
    same with and without lse, lse within 1e-4 + 1e-5·|lse| of the plain
    version's (-inf at the same rows), the backward on the tensor cores
    exactly when bf16 and D <= BWD_TC_MAX_D, the gradients by
    ``hold_backward``.  Returns the largest share of the bound used."""
    from repro_torch.kernels._pass import BWD_TC_MAX_D
    from repro_torch.kernels.flash_attention import ops
    q, k, v = fa_inputs(torch, shape, dtype, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=kw["causal"], window=kw.get("window"),
              kv_offset=kw.get("kv_offset", 0), scale=shape[5] ** -0.5)
    o, lse = ops._forward_cuda(q, k, v, with_lse=True, **kw)
    check(torch.equal(o, ops.flash_attention_cuda(q, k, v, **kw)),
          f"kernel 12 {what}: the output with lse differs from without")
    _, lse_p = plain(ops.flash_attention_plain_lse, q, k, v, **kw)
    fin = torch.isfinite(lse_p)
    check(torch.equal(fin, torch.isfinite(lse)), f"kernel 12 {what}: lse "
          f"is not finite at the plain version's rows")
    if bool(fin.any()):
        err = (lse - lse_p)[fin].abs()
        check(bool((err <= 1e-4 + 1e-5 * lse_p[fin].abs()).all()),
              f"kernel 12 {what}: lse max |err| {float(err.max())}")
    tc0 = ops.flash_attention_backward_cuda.tc_launches
    got = ops.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    tc = dtype == torch.bfloat16 and shape[5] <= BWD_TC_MAX_D
    check(ops.flash_attention_backward_cuda.tc_launches == tc0 + int(tc),
          f"flash_attention_bwd {what}: the tensor-core route ran "
          f"{ops.flash_attention_backward_cuda.tc_launches - tc0} times, "
          f"expected {int(tc)}")
    want = plain(ops.flash_attention_backward_plain, q, k, v, o, lse, do,
                 **kw)
    bounds = bwd_bounds(torch, q, k, v, o, do, lse, kw["causal"],
                        kw["window"], kw["kv_offset"], kw["scale"])
    share = hold_backward(torch, parity, got, want, bounds, what, tc)
    if kw["kv_offset"] == FA_NO_KEY_OFFSET:
        check(all(bool((t == 0).all()) for t in got), f"{what}: rows that "
              f"see no key got non-zero gradients")
    again = ops.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_attention_bwd {what}: two launches differ")
    return share


def backward_oracle_f64(torch, parity) -> float:
    """The second oracle: the backward kernel in f32 on the card against
    autograd through ref.mha_reference in f64 on the CPU, at a small
    geometry, each entry within 1e-5·Σ|terms| (the f64 oracle has no
    error of its own at that scale)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import mha_reference
    g = torch.Generator().manual_seed(64)
    shape = (2, 8, 2, 77, 93, 64)
    b, hq, hkv, sq, skv, d = shape
    q, k, v, do = (torch.randn(s, generator=g, dtype=torch.float64)
                   for s in ((b, hq, sq, d), (b, hkv, skv, d),
                             (b, hkv, skv, d), (b, hq, sq, d)))
    kw = dict(causal=True, window=40, kv_offset=16, scale=d ** -0.5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    mha_reference(*leaves, **kw).backward(do)
    qc, kc, vc, dc = (t.float().cuda() for t in (q, k, v, do))
    o, lse = ops._forward_cuda(qc, kc, vc, with_lse=True, **kw)
    got = ops.flash_attention_backward_cuda(qc, kc, vc, o, lse, dc, **kw)
    bounds = bwd_bounds(torch, qc, kc, vc, o, dc, lse, kw["causal"],
                        kw["window"], kw["kv_offset"], kw["scale"])
    want = [leaf.grad.float().cuda() for leaf in leaves]
    return hold_backward(torch, parity, got, want, bounds,
                         "against autograd of mha_reference in f64")


def phase_parity_backward(torch, parity: Parity) -> dict:
    """Kernel 12's backward against its plain version at the slice's
    geometry (TRAIN_B x TRAIN_S, granite's 32/8 heads of 64, causal) in
    bf16 and f32 and at BWD_CASES in bf16 (f32 too at the small ones), and
    against the f64 oracle; returns the largest share of the bound per
    case."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    shares = {}
    cases = [("granite_train", (TRAIN_B, 32, 8, TRAIN_S, TRAIN_S, 64),
              dict(causal=True), dt)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(n, s, kw, torch.bfloat16) for n, s, kw in BWD_CASES]
    cases += [(n, s, kw, torch.float32) for n, s, kw in BWD_CASES
              if s[3] <= 1500]
    for name, shape, kw, dt in cases:
        key = f"{name}_{str(dt).replace('torch.', '')}"
        shares[key] = backward_case(torch, parity, gen, shape, kw, dt,
                                    f"{name} {shape} {kw} {dt}")
        torch.cuda.empty_cache()
    shares["f64_oracle"] = backward_oracle_f64(torch, parity)
    torch.cuda.synchronize()
    print(f"parity: flash_attention_bwd matches its plain version at "
          f"{len(cases)} cases and the f64 oracle; max |err| "
          f"{parity.err['flash_attention_bwd']}; share of the bound per "
          f"case {json.dumps(shares)}")
    return shares


class PlainCalls:
    """Counts calls of kernel 12's plain versions (forward and backward)
    while entered: the card's training path must make none."""

    NAMES = ("flash_attention_plain", "flash_attention_plain_lse",
             "flash_attention_backward_plain")

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops
        self.ops, self.orig, self.calls = ops, {}, 0
        for n in self.NAMES:
            self.orig[n] = fn = getattr(ops, n)
            setattr(ops, n, self._counted(fn))
        return self

    def _counted(self, fn):
        def counted_fn(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        return counted_fn

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.ops, n, fn)


class ProductTimer:
    """CUDA events around every backward of the f32-output products
    (models/layers._ProductOut) while entered; ``ms()`` their sum."""

    def __enter__(self):
        import torch
        from repro_torch.models import layers
        self.cls, self.orig, self.pairs = layers._ProductOut, \
            layers._ProductOut.backward, []
        orig = self.orig

        def backward(ctx, g):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(ctx, g)
            b.record()
            self.pairs.append((a, b))
            return out
        self.cls.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        self.cls.backward = staticmethod(self.orig)

    def ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def device_busy_ms(torch, prof):
    """The union of the device spans a profiler saw, in ms (None where it
    saw none: then not measured)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us * 1e-3 if spans else None


def leaf_dict(tree) -> dict:
    from repro_torch.optim.adamw import tree_leaves
    return dict(tree_leaves(tree))


def train_reckoning(cfg, n_params: int, batch: int = TRAIN_B,
                    chunked_ce: bool = False) -> dict:
    """The memory reckoning of a training step of ``batch`` x TRAIN_S
    tokens written before the first run (bytes): params, gradients, m and v
    in f32, remat's saved group inputs, one group's recompute (six f32
    (tokens, d_ff) products of the SwiGLU), the logits the chunked CE keeps
    for the backward, and a second gradient tree under adaptive
    accumulation.  With ``chunked_ce``, the rest of what the chunked CE
    keeps for the backward (``models/decoder._chunked_ce``): each chunk of
    loss_chunk positions saves two f32 (tokens, padded_vocab) tensors in
    all (the exp that ``logits`` counts, and the logits ``gather`` saves)
    and its own bf16 copy of the (padded_vocab, d_model) output weight
    (the f32 product's operand), ceil(TRAIN_S / loss_chunk) copies.  Leg
    1's reckoning, written before its first run, leaves them out: at
    granite's 51,200-wide vocabulary they are 4.2 GB, and its peak stays
    under the reckoning without them."""
    tokens = batch * TRAIN_S
    r = dict(params=4 * n_params, grads=4 * n_params, m_v=8 * n_params,
             remat_inputs=cfg.n_layers * tokens * cfg.d_model * 2,
             group_recompute=6 * tokens * cfg.d_ff * 4,
             logits=tokens * cfg.padded_vocab * 4,
             second_grads=4 * n_params)
    if chunked_ce:
        chunks = -(-TRAIN_S // (cfg.loss_chunk or TRAIN_S))
        r.update(ce_gathered_logits=tokens * cfg.padded_vocab * 4,
                 ce_weight_copies=chunks * cfg.padded_vocab * cfg.d_model
                 * 2)
    r["total"] = sum(r.values())
    return r


def grads_nonzero(torch, grads, what: str) -> None:
    """Every leaf's gradient finite and not all zero."""
    for path, g in leaf_dict(grads).items():
        check(bool(torch.isfinite(g).all()), f"{what}: the gradient of "
              f"{path} is not finite")
        check(float(g.abs().max()) > 0, f"{what}: the gradient of {path} "
              f"is zero")


def train_leg1(torch, cfg, opt_cfg) -> tuple:
    """Leg 1 of phase 18: TRAIN_STEPS ``make_train_step`` steps on the card
    at full depth, then one adaptive-accumulation step (TRAIN_MICRO
    microbatches through ``make_grad_step``, ``earl_accumulate_gradients``
    and ``adamw_update``), as ``launch/train.main`` composes them.  Each
    step (and microbatch) must launch kernel 12 twice a layer (the forward
    and remat's recompute) and its backward once, and no plain version
    may run.  Returns (state, info, launches)."""
    from repro_torch.data import synthetic_tokens
    from repro_torch.data.pipeline import TokenBatchPipeline
    from repro_torch.models import num_params
    from repro_torch.optim import adamw_update, earl_accumulate_gradients
    from repro_torch.train import (init_train_state, make_grad_step,
                                   make_train_step)
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    state = init_train_state(gen, cfg, opt_cfg, device="cuda")
    n_params, n_bytes = num_params(state.params)
    docs = synthetic_tokens(TRAIN_DOCS, TRAIN_S + 1, cfg.vocab,
                            seed=TRAIN_SEED)
    pipe = TokenBatchPipeline(docs, TRAIN_B, TRAIN_S, seed=TRAIN_SEED,
                              device="cuda")
    train_step = make_train_step(cfg, opt_cfg)
    grad_step = make_grad_step(cfg)
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers}
    walls, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with PlainCalls() as plains:
        for _ in range(TRAIN_STEPS):
            tokens, labels = pipe.next_batch()
            t = time.perf_counter()
            (state, m), made = counted(lambda: train_step(
                state, {"tokens": tokens, "labels": labels}))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            check(made == per_step, f"a train step launched {made}, "
                  f"expected {per_step}")
        mbs = []
        for _ in range(TRAIN_MICRO):
            tokens, labels = pipe.next_batch()
            mbs.append({"tokens": tokens, "labels": labels})
        # a few leaves of every microbatch's gradients, kept to hold the
        # accumulated mean against
        kept = ("/final_norm", "/groups/0/attn_norm", "/embedding")
        seen, micro = [], []

        def watched(params, mb):
            out, made = counted(lambda: grad_step(params, mb))
            check(made == per_step, f"a microbatch launched {made}, "
                  f"expected {per_step}")
            flat = leaf_dict(out[0])
            if not seen:
                grads_nonzero(torch, out[0], "the first microbatch")
            seen.append({p: flat[p][:64].clone() for p in kept})
            micro.append(float(out[1]))
            return out
        t = time.perf_counter()
        with ProductTimer() as products, torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            grads, decision = earl_accumulate_gradients(
                watched, state.params, mbs, sigma=0.02)
            torch.cuda.synchronize()
            t_acc = time.perf_counter() - t
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, _, om = adamw_update(state.params, grads, state.opt, opt_cfg)
            end.record()
            torch.cuda.synchronize()
        step_wall = time.perf_counter() - t
        adamw_ms = start.elapsed_time(end)
        products_ms = products.ms()
    launches = LaunchLog.counts()
    tc = wrappers()["flash_attention_bwd"].tc_launches
    check(tc == launches["flash_attention_bwd"], f"leg 1's backward took "
          f"the tensor cores {tc} of {launches['flash_attention_bwd']} times")
    peak = torch.cuda.max_memory_allocated()
    check(plains.calls == 0, f"the card's training path ran kernel 12's "
          f"plain versions {plains.calls} times")
    used = decision.microbatches_used
    flat = leaf_dict(grads)
    for p in kept:
        want = seen[0][p].clone()
        for s in seen[1:used]:
            want += s[p]
        want /= used
        check(torch.equal(flat[p][:64], want), f"the accumulated mean of "
              f"{p} is not the mean of the {used} used microbatches")
    del grads
    busy = device_busy_ms(torch, prof)
    tokens = TRAIN_B * TRAIN_S
    warm = sorted(walls[1:])
    wall = warm[len(warm) // 2] if len(warm) % 2 else \
        0.5 * (warm[len(warm) // 2 - 1] + warm[len(warm) // 2])
    pairs = TRAIN_S * (TRAIN_S + 1) // 2
    flops = 6 * n_params * tokens + 12 * cfg.head_dim_ * pairs * TRAIN_B \
        * cfg.n_heads * cfg.n_layers
    reck = train_reckoning(cfg, n_params)
    check(peak < reck["total"], f"phase 18's peak {peak} bytes is past the "
          f"reckoning's {reck['total']}")
    info = dict(params=n_params, param_bytes=n_bytes,
                losses=losses, step_walls_s=walls, step_wall_s=wall,
                tokens_per_s=tokens / wall, flops_per_step=flops,
                flops_share=flops / wall / BF16_FLOPS_PER_S,
                micro_used=used, grad_cv=decision.cv, tc_launches=tc,
                micro_grad_norms=micro, adaptive_step_s=step_wall,
                accumulate_s=t_acc, adaptive_loss=decision.mean_loss,
                adamw_ms=adamw_ms, grad_norm=float(om["grad_norm"]),
                profiled_device_ms=busy,
                busy_share=None if busy is None else busy / (step_wall * 1e3),
                f32_backward_products_ms=products_ms,
                f32_backward_products_share=products_ms / (step_wall * 1e3),
                peak_bytes=peak, reckoning=reck)
    print(f"phase 18 leg 1: {cfg.name} at full depth, {n_params} params "
          f"({n_bytes} bytes), {TRAIN_B} x {TRAIN_S} tokens: losses "
          f"{losses}, step walls {walls} s (warm median {wall:.3f} s, "
          f"{tokens / wall:.1f} tokens/s, {flops:.4g} flops a step, "
          f"{info['flops_share']:.4f} of 989e12); adaptive step: "
          f"{used} of {TRAIN_MICRO} microbatches used, grad_cv "
          f"{decision.cv}, {step_wall:.3f} s, AdamW update {adamw_ms:.2f} "
          f"ms; busy {busy} ms of it ({info['busy_share']}), f32 "
          f"backward products {products_ms:.1f} ms "
          f"({info['f32_backward_products_share']:.3f}); peak {peak} bytes "
          f"against the reckoning's {reck['total']} "
          f"({json.dumps(reck)})")
    return state, info, launches


def first_layer(cfg, params):
    """granite cut to its first layer: the embedding, the final norm and
    layer 0 of every stacked leaf, as fresh tensors."""
    import dataclasses
    from repro_torch.models.decoder import tree_map
    one = dataclasses.replace(cfg, n_layers=cfg.pattern_len)
    p = {"embedding": params["embedding"].clone(),
         "final_norm": params["final_norm"].clone(),
         "groups": tree_map(lambda t: t[:1].clone(), params["groups"])}
    return one, p


def attention_slice(cfg, params):
    """The model cut to the first piece that holds its first attention
    layer: its first pattern group (``first_layer``), or, for a model cut
    below one group (gemma3-27b's two remainder layers), its first
    remainder layer."""
    import dataclasses
    if cfg.n_groups > 0:
        return first_layer(cfg, params)
    check(cfg.rem_pattern[0] not in RECURRENT, f"{cfg.name}'s first layer "
          f"is not an attention layer")
    from repro_torch.models.decoder import tree_map
    one = dataclasses.replace(cfg, n_layers=1)
    return one, {"embedding": params["embedding"].clone(),
                 "final_norm": params["final_norm"].clone(),
                 "rem": {"0": tree_map(lambda t: t.clone(),
                                       params["rem"]["0"])}}


def card_cpu_batch(torch, cfg) -> dict:
    """card == CPU's batch: 1 x TRAIN_CPU_S tokens from a seeded
    generator, on the CPU."""
    g = torch.Generator().manual_seed(TRAIN_SEED + 1)
    toks = torch.randint(0, cfg.vocab, (1, TRAIN_CPU_S + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def hold_card_cpu_grads(torch, label: str, card, cpu,
                        share_max: float = TRAIN_CPU_SHARE) -> dict:
    """card == CPU's law on a grad step's (grads, grad_norm, loss) from the
    card and from the CPU (or from another run on the card): every leaf's
    gradient within ``share_max`` of that leaf's largest |gradient|, loss
    and grad_norm within TRAIN_CPU_SHARE relative; ``label`` names the
    comparison in a failure."""
    (gc, nc, lc), (gh, nh, lh) = card, cpu
    worst = {}
    flat_h = leaf_dict(gh)
    for path, t in leaf_dict(gc).items():
        want = flat_h[path]
        share = float((t.cpu() - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        worst[path] = share
        check(share <= share_max, f"{label}: the gradient of {path} is "
              f"{share} of its largest entry away")
    for what, a, b in (("grad_norm", nc, nh), ("loss", lc, lh)):
        check(abs(a - b) <= TRAIN_CPU_SHARE * abs(b), f"{label}: {what} "
              f"{a} against {b}")
    return dict(grad_share=max(worst.values()),
                worst_leaf=max(worst, key=worst.get),
                loss=(lc, lh), grad_norm=(nc, nh))


def card_equals_cpu(torch, cfg, params, opt_cfg) -> dict:
    """granite's first layer at full width on 1 x TRAIN_CPU_S tokens, the
    CPU fed the card's params, in bf16 and f32 compute, by
    ``hold_card_cpu_grads``; then the train step's update
    (``adamw_update``, as ``make_train_step`` composes it after the
    gradients) on the card and on the CPU from the same state and the
    card's gradients, within four f32 ulps of each param plus 1e-6·lr.
    The update is held on the same gradients because a first AdamW step
    moves each entry by lr·g/(|g| + eps), a sign function of g: gradients
    equal within bf16's rounding still flip it at entries near zero (the
    norm scales start at zero, so their new values are the update
    alone)."""
    import dataclasses
    from repro_torch.models.decoder import tree_map
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.train import make_grad_step
    one, p = first_layer(cfg, params)
    batch = card_cpu_batch(torch, cfg)
    out = {}
    for compute in ("bfloat16", "float32"):
        c = dataclasses.replace(one, compute_dtype=compute)
        res = {}
        for dev in ("cuda", "cpu"):
            pd = tree_map(lambda t: t.to(dev), p)
            grads, gnorm, loss = make_grad_step(c)(pd, batch)
            res[dev] = (grads, float(gnorm), float(loss))
        out[compute] = hold_card_cpu_grads(
            torch, f"card == CPU ({compute})", res["cuda"], res["cpu"])
        gc, gh = res["cuda"][0], res["cpu"][0]
        steps = {}
        for dev in ("cuda", "cpu"):
            pd = tree_map(lambda t: t.to(dev).clone(), p)
            gd = tree_map(lambda t: t.to(dev), gc)
            _, st, m = adamw_update(pd, gd, adamw_init(pd, opt_cfg), opt_cfg)
            steps[dev] = (leaf_dict(pd), float(m["grad_norm"]),
                          float(m["lr"]))
        (pc, mnc, lrc), (ph, mnh, lrh) = steps["cuda"], steps["cpu"]
        check(abs(mnc - mnh) <= 1e-6 * mnh and lrc == lrh, f"card == CPU "
              f"({compute}): the update's grad_norm {mnc} against {mnh}")
        ulps = 0.0
        for path, want in ph.items():
            got = pc[path].cpu()
            tol = 4 * torch.abs(torch.nextafter(want, want + 1) - want) \
                + 1e-6 * lrh
            diff = (got - want).abs()
            ulps = max(ulps, float((diff / tol).max()))
            check(bool((diff <= tol).all()), f"card == CPU ({compute}): the "
                  f"updated {path} max |err| {float(diff.max())}")
        out[compute]["update_share_of_tolerance"] = ulps
        del gc, gh, pc, ph, res
    print(f"phase 18 card == CPU on {cfg.name}'s first layer, 1 x "
          f"{TRAIN_CPU_S} tokens: {json.dumps(out)}")
    return out


def wide_card_cpu(torch, cfg, params, compute: str, share_max: float):
    """Leg 3's card == CPU in ``compute`` on the slice of a model that holds
    its first attention layer (``attention_slice``) at 1 x TRAIN_CPU_S
    tokens, by ``hold_card_cpu_grads`` within ``share_max``.  In bf16
    compute, where the backward takes the wide tensor-core route, the
    card's grad step is first held within TRAIN_CPU_SHARE of the same step
    on the card with the backward's plain version in the kernel's place
    (the kernel alone, without the CPU's bf16 rounding of the rest).
    Returns (that comparison, or {}, and the CPU's half: a function that
    runs the CPU's grad step and holds it against the card's)."""
    import dataclasses
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.decoder import tree_map
    from repro_torch.train import make_grad_step
    one, p = attention_slice(cfg, params)
    one = dataclasses.replace(one, compute_dtype=compute)
    batch = card_cpu_batch(torch, cfg)
    step = make_grad_step(one)

    def run(pd):
        grads, gnorm, loss = step(pd, batch)
        return tree_map(lambda t: t.cpu(), grads), float(gnorm), float(loss)

    card, out = run(p), {}
    if compute == "bfloat16":
        kernel = ops.flash_attention_backward_cuda

        def plain_bwd(*a, **kw):
            return ops.flash_attention_backward_plain(*a, **kw)
        # the kernel's counts, unchanged, for a LaunchLog that reads them at
        # the forward's launches meanwhile
        plain_bwd.launches = kernel.launches
        plain_bwd.tc_launches = kernel.tc_launches
        ops.flash_attention_backward_cuda = plain_bwd
        try:
            plain = run(p)
        finally:
            ops.flash_attention_backward_cuda = kernel
        out["kernel_vs_plain"] = hold_card_cpu_grads(
            torch, f"{cfg.name}: the kernel against the backward's plain "
            f"version on the card ({compute})", card, plain)
    p_cpu = tree_map(lambda t: t.cpu(), p)
    del p

    def cpu_half() -> dict:
        t = time.perf_counter()
        res = hold_card_cpu_grads(
            torch, f"{cfg.name}: card == CPU ({compute})", card, run(p_cpu),
            share_max)
        res.update(out, share_max=share_max, cpu_s=time.perf_counter() - t)
        print(f"phase 18 card == CPU on {cfg.name} cut to {one.n_layers} "
              f"layers, 1 x {TRAIN_CPU_S} tokens, {compute}: "
              f"{json.dumps(res)}")
        return res
    return out, cpu_half


def loss_falls(torch, cfg, opt_cfg) -> dict:
    """TRAIN_FALL_STEPS train steps on one repeated batch of granite at
    full width cut to LEG2_LAYERS layers: the loss must fall."""
    import dataclasses
    from repro_torch.train import init_train_state, make_train_step
    c = dataclasses.replace(cfg, n_layers=LEG2_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED + 2)
    state = init_train_state(gen, c, opt_cfg, device="cuda")
    g = torch.Generator().manual_seed(TRAIN_SEED + 3)
    toks = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S + 1), generator=g)
    batch = {"tokens": toks[:, :-1].cuda(), "labels": toks[:, 1:].cuda()}
    step = make_train_step(c, opt_cfg)
    losses = []
    for _ in range(TRAIN_FALL_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    del state
    torch.cuda.empty_cache()
    check(losses[-1] < losses[0], f"five steps on one batch did not lower "
          f"the loss: {losses}")
    print(f"phase 18 the loss falls on one repeated batch ({LEG2_LAYERS} "
          f"layers, {TRAIN_B} x {TRAIN_S}): {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (predicted: from about ln(vocab) = "
          f"{math.log(cfg.vocab):.2f}, lower after {TRAIN_FALL_STEPS} "
          f"steps); every step {losses}")
    return dict(losses=losses)


def embedding_determinism(torch, cfg) -> dict:
    """The embedding's backward (index_put_ with accumulate, atomics on the
    card) at leg 1's tokens: two runs bitwise or not, by default and under
    torch.use_deterministic_algorithms."""
    g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED + 4)
    toks = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S), generator=g,
                         device="cuda")
    emb = torch.randn((cfg.padded_vocab, cfg.d_model), generator=g,
                      device="cuda")
    ct = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), generator=g,
                     device="cuda").to(torch.bfloat16)

    def grad():
        w = emb.detach().requires_grad_(True)
        w[toks].to(torch.bfloat16).backward(ct)
        return w.grad

    out = {}
    for mode in (False, True):
        torch.use_deterministic_algorithms(mode)
        try:
            a, b = grad(), grad()
        finally:
            torch.use_deterministic_algorithms(False)
        out["deterministic" if mode else "default"] = bool(torch.equal(a, b))
    print(f"phase 18 the embedding's backward twice bitwise: "
          f"{json.dumps(out)}")
    return out


def train_leg2(torch, tmp: str) -> dict:
    """Leg 2 of phase 18: ``repro_torch.launch.train.main`` itself at
    granite's full width cut to LEG2_LAYERS layers, TRAIN_B x TRAIN_S,
    with adaptive accumulation, EarlEval every 2 steps, a checkpoint
    every 2 steps and the final save: LEG2_STEPS steps uninterrupted, then
    a run stopped after 1 step (its final save) and resumed to LEG2_STEPS
    (``--ckpt-every 0``: the final save only).  The resumed
    run's losses must equal the uninterrupted run's within f32 rounding
    (the embedding's backward adds with atomics), its pipeline cursor and
    step bitwise.  Returns (info, launches of the uninterrupted run)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as tlaunch
    over = json.dumps({"n_layers": LEG2_LAYERS})

    def run(root, steps, every, *extra):
        return tlaunch.main([
            "--arch", TRAIN_ARCH, "--override", over, "--steps", str(steps),
            "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--docs",
            str(TRAIN_DOCS), "--ckpt-dir", root, "--ckpt-every", str(every),
            "--eval-every", "2", "--adaptive-accum", "--microbatches",
            str(LEG2_MICRO), "--seed", str(TRAIN_SEED), *extra])
    zero_counts()
    with PlainCalls() as plains:
        full = run(f"{tmp}/full", LEG2_STEPS, 2)
        launches = LaunchLog.counts()
        run(f"{tmp}/part", 1, 2)
        # the resumed run saves once, at its end (a save is about 13 s
        # of 4.2 GB through the card's host disk)
        resumed = run(f"{tmp}/part", LEG2_STEPS, 0, "--resume")
    check(plains.calls == 0, f"main on the card ran kernel 12's plain "
          f"versions {plains.calls} times")
    a, b = full["history"][1:], resumed["history"]
    check(len(a) == len(b) == LEG2_STEPS - 1, f"resumed {len(b)} steps")
    for x, y in zip(a, b):
        for key in ("loss", "grad_norm"):
            check(abs(x[key] - y[key]) <= 1e-5 * abs(x[key]), f"the resumed "
                  f"run's {key} {y[key]} is not the uninterrupted {x[key]}")
        check(x["micro_used"] == y["micro_used"] and x["lr"] == y["lr"],
              f"the resumed run's step differs: {y} against {x}")
    ma = CheckpointManager(f"{tmp}/full").meta()
    mb = CheckpointManager(f"{tmp}/part").meta()
    check(ma == mb, f"the resumed run's cursor {mb} is not the "
          f"uninterrupted {ma}")
    bitwise = all(x == y for x, y in zip(a, b))
    info = dict(steps=LEG2_STEPS, history=full["history"],
                resumed_history=resumed["history"], resumed_bitwise=bitwise,
                cursor=ma, ckpt=full["ckpt"], resumed_ckpt=resumed["ckpt"],
                evals=full["evals"], wall_s=full["wall_s"])
    print(f"phase 18 leg 2: main at {LEG2_LAYERS} layers, {LEG2_STEPS} "
          f"steps: {json.dumps(full['history'])}; checkpoints "
          f"{json.dumps(full['ckpt'])}; EarlEval forwards "
          f"{json.dumps(full['evals'])}; resumed from step 1 "
          f"{'bitwise' if bitwise else 'within f32 rounding'}: "
          f"{json.dumps(resumed['history'])}, cursor {json.dumps(ma)}")
    return info, launches


def wide_plan():
    """Leg 3's models: [(cfg, batch, params, reckoning)], gemma3-27b and
    recurrentgemma-2b at their published widths cut in depth
    (WIDE_GEMMA_LAYERS, WIDE_RG_LAYERS) with their batches, the params
    counted on meta tensors (shapes only) and the peak reckoned by
    ``train_reckoning`` with the chunked CE's terms before anything is
    allocated."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.decoder import init_params, num_params
    plan = []
    for arch, layers, batch in (("gemma3-27b", WIDE_GEMMA_LAYERS,
                                 WIDE_GEMMA_B),
                                ("recurrentgemma-2b", WIDE_RG_LAYERS,
                                 WIDE_RG_B)):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        n = num_params(init_params(cfg, device="meta"))[0]
        plan.append((cfg, batch, n, train_reckoning(cfg, n, batch,
                                                    chunked_ce=True)))
    return plan


def wide_step_launches(cfg) -> dict:
    """Kernel 12's launches in one train step: the forward of every
    attention layer, again in remat's recompute for the layers of a pattern
    group (the remainder layers run outside remat), and its backward once
    an attention layer."""
    group = sum(k not in RECURRENT for k in cfg.layer_pattern)
    rem = sum(k not in RECURRENT for k in cfg.rem_pattern)
    return {"flash_attention": 2 * cfg.n_groups * group + rem,
            "flash_attention_bwd": cfg.n_groups * group + rem}


def kernel_device_ms(torch, prof, name: str) -> float:
    """The summed device time of the kernels whose name holds ``name``
    that a profiler saw, in ms."""
    return 1e-3 * sum(e.time_range.end - e.time_range.start
                      for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and name in e.name)


def train_wide_heads(torch, opt_cfg) -> tuple:
    """Leg 3 of phase 18: the two families whose heads pass 128
    (``wide_plan``) trained on the card through ``init_train_state`` and
    ``make_train_step``, WIDE_STEPS steps each on fresh batches of batch x
    TRAIN_S tokens in bf16 compute, remat as configured.  Each step must
    launch kernel 12 and its backward as ``wide_step_launches`` says, every
    backward on the tensor cores, no plain version; the loss finite; then
    one ``make_grad_step`` under torch.profiler and ``ProductTimer``:
    every gradient finite and non-zero, the card's busy time, the backward
    kernel's and the f32 backward products' ms; the peak at or under the
    reckoning, itself under WIDE_PEAK_LIMIT before the run.  Before the
    steps, the card's halves of card == CPU on the initial params' slice
    that holds the first attention layer (``wide_card_cpu``; in bf16, and
    for a model with recurrent cells in f32 too: WIDE_RECURRENT_SHARE).
    Returns (info, launches, the CPU's halves), the CPU's halves to run
    after the leg's timed steps, so that they do not share the host with
    them."""
    from repro_torch.train import (init_train_state, make_grad_step,
                                   make_train_step)
    info, launches, halves = {}, {k: 0 for k in LaunchLog.counts()}, []
    for cfg, batch, n_params, reck in wide_plan():
        check(reck["total"] < WIDE_PEAK_LIMIT, f"{cfg.name} reckons at "
              f"{reck['total']} bytes, past {WIDE_PEAK_LIMIT}")
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED + 5)
        state = init_train_state(gen, cfg, opt_cfg, device="cuda")
        recurrent = any(k in RECURRENT for k in cfg.layer_pattern)
        laws = [("bfloat16", WIDE_RECURRENT_SHARE if recurrent
                 else TRAIN_CPU_SHARE)]
        laws += [("float32", TRAIN_CPU_SHARE)] if recurrent else []
        kernel_vs_plain = {}
        for compute, share_max in laws:
            kernel_vs_plain[compute], half = wide_card_cpu(
                torch, cfg, state.params, compute, share_max)
            halves.append(half)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        g = torch.Generator().manual_seed(TRAIN_SEED + 6)
        toks = torch.randint(0, cfg.vocab, (WIDE_STEPS + 1, batch,
                                            TRAIN_S + 1), generator=g)
        batches = [{"tokens": t[:, :-1].cuda(), "labels": t[:, 1:].cuda()}
                   for t in toks]
        step = make_train_step(cfg, opt_cfg)
        per_step = wide_step_launches(cfg)
        walls, losses = [], []
        zero_counts()
        with PlainCalls() as plains:
            for b in batches[:WIDE_STEPS]:
                t = time.perf_counter()
                (state, m), made = counted(lambda: step(state, b))
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
                check(made == per_step, f"a {cfg.name} train step launched "
                      f"{made}, expected {per_step}")
            counts = LaunchLog.counts()
            tc = wrappers()["flash_attention_bwd"].tc_launches
            t = time.perf_counter()
            with ProductTimer() as products, torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA]) as prof:
                grads, gnorm, gloss = make_grad_step(cfg)(state.params,
                                                          batches[-1])
                torch.cuda.synchronize()
                # the step's wall, without the profiler's collection
                grad_wall = time.perf_counter() - t
        check(plains.calls == 0, f"{cfg.name}'s training on the card ran "
              f"kernel 12's plain versions {plains.calls} times")
        check(tc == counts["flash_attention_bwd"] > 0, f"{cfg.name}'s "
              f"backward took the tensor cores {tc} of "
              f"{counts['flash_attention_bwd']} times")
        check(all(math.isfinite(x) for x in losses + [float(gloss)]),
              f"{cfg.name}'s losses {losses}, {float(gloss)}")
        grads_nonzero(torch, grads, f"{cfg.name} (leg 3)")
        del grads
        peak = torch.cuda.max_memory_allocated()
        check(peak <= reck["total"], f"{cfg.name}'s peak {peak} bytes is "
              f"past the reckoning's {reck['total']}")
        busy = device_busy_ms(torch, prof)
        bwd_ms = kernel_device_ms(torch, prof, "attention_bwd")
        tokens = batch * TRAIN_S
        wall = walls[-1]
        launches = add_counts(launches, counts)
        one = dict(n_layers=cfg.n_layers, batch=batch, params=n_params,
                   head_dim=cfg.head_dim_, losses=losses, step_walls_s=walls,
                   step_wall_s=wall, tokens_per_s=tokens / wall,
                   launches=counts, tc_launches=tc,
                   grad_step_s=grad_wall, grad_loss=float(gloss),
                   grad_norm=float(gnorm), profiled_device_ms=busy,
                   busy_share=None if busy is None
                   else busy / (grad_wall * 1e3),
                   bwd_kernel_ms=bwd_ms,
                   bwd_kernel_share=bwd_ms / (grad_wall * 1e3),
                   f32_backward_products_ms=products.ms(),
                   f32_backward_products_share=products.ms()
                   / (grad_wall * 1e3),
                   peak_bytes=peak, reckoning=reck,
                   kernel_vs_plain=kernel_vs_plain["bfloat16"])
        del state, batches
        torch.cuda.empty_cache()
        one["leg_s"] = time.perf_counter() - t0
        info[cfg.name] = one
        print(f"phase 18 leg 3: {cfg.name} at {cfg.n_layers} layers (head "
              f"dim {cfg.head_dim_}), {n_params} params, {batch} x {TRAIN_S} "
              f"tokens: losses {losses}, step walls {walls} s "
              f"({tokens / wall:.1f} tokens/s); launches {json.dumps(counts)}"
              f" ({tc} backward on the tensor cores); a grad step "
              f"{grad_wall:.3f} s under the profiler, busy {busy} ms "
              f"({one['busy_share']}), the backward kernel {bwd_ms:.3f} ms "
              f"({one['bwd_kernel_share']:.4f}), the f32 backward products "
              f"{products.ms():.1f} ms "
              f"({one['f32_backward_products_share']:.3f}); peak {peak} "
              f"bytes against the reckoning's {reck['total']} "
              f"({json.dumps(reck)}); {one['leg_s']:.1f} s on the card; the "
              f"kernel against the backward's plain version "
              f"{json.dumps(kernel_vs_plain['bfloat16'])}")
    return info, launches, halves


def phase_train_path(torch, parity: Parity):
    """Phase 18: the training path on the card, its geometries logged and
    its launches leg 1's, leg 2's uninterrupted run and leg 3's train
    steps, each from zeroed counts.  Leg 1 trains granite-3-2b whole
    (train_leg1), leg 2 runs launch/train.main at LEG2_LAYERS layers
    (train_leg2), leg 3 trains gemma3-27b and recurrentgemma-2b, whose
    heads pass 128 (train_wide_heads); beside them the backward kernel's
    parity (phase_parity_backward), card == CPU on the first layer, the
    loss on one repeated batch and the embedding's determinism.  Returns
    (launches, geometries, info, leg 3's CPU halves of card == CPU, each a
    function to call)."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim_) == (40, 2048, 32, 8, 64), f"{cfg.name} is not the "
          f"shape phase 18 reckons with")
    opt_cfg = AdamWConfig(warmup_steps=1, state_dtype=cfg.adam_dtype)
    info = {}
    with LaunchLog() as log:
        state, info["leg1"], l1 = train_leg1(torch, cfg, opt_cfg)
        info["card_cpu"] = card_equals_cpu(torch, cfg, state.params, opt_cfg)
        del state
        torch.cuda.empty_cache()
        info["loss_falls"] = loss_falls(torch, cfg, opt_cfg)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
        try:
            info["leg2"], l2 = train_leg2(torch, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        t3 = time.perf_counter()
        info["wide"], l3, halves = train_wide_heads(torch, opt_cfg)
        info["wide_s"] = time.perf_counter() - t3
    info["embedding"] = embedding_determinism(torch, cfg)
    info["backward_parity"] = phase_parity_backward(torch, parity)
    launches = add_counts(l1, l2, l3)
    want = {"flash_attention": 2 * cfg.n_layers * (TRAIN_STEPS
                                                   + info["leg1"]["micro_used"]),
            "flash_attention_bwd": cfg.n_layers * (
                TRAIN_STEPS + info["leg1"]["micro_used"])}
    check(all(l1[k] == v for k, v in want.items()), f"leg 1 launched "
          f"{l1}, expected {want}")
    check(all(v == 0 for k, v in l1.items() if k not in want),
          f"leg 1 launched another kernel: {l1}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    info.update(card=smi, phase_s=time.perf_counter() - t0)
    print(f"nvidia-smi: {smi}")
    print(f"launches, the training path: leg 1 {json.dumps(l1)}, leg 2 "
          f"{json.dumps(l2)}, leg 3 {json.dumps(l3)}")
    print("train summary: " + json.dumps(info))
    return launches, log.geometries, info, halves


def replay_attention_bwd(torch, parity, gen, fields, what) -> None:
    """One backward launch geometry on fresh data against the plain
    version (``backward_case``)."""
    g = dict(fields)
    dt = torch.float32 if g["dtype"] == 0 else torch.bfloat16
    shape = (g["BHq"] // g["Hq"], g["Hq"], g["Hkv"], g["Sq"], g["Skv"],
             g["D"])
    kw = dict(causal=bool(g["causal"]), window=g["window"] or None,
              kv_offset=g["kv_offset"])
    with LaunchLog() as log:
        backward_case(torch, parity, gen, shape, kw, dt, what)
    check(("flash_attention_bwd", fields) in log.geometries,
          f"{what}: launched {list(log.geometries)}")


def sdpa_backward_ms(torch, q, k, v, do, kw) -> dict:
    """scaled_dot_product_attention on the same q, k, v (GQA by
    ``enable_gqa``) and dO: {"mask": (forward ms, forward and backward
    ms) with the boolean mask of ``kw`` (none where every key is
    visible), "is_causal": the same with ``is_causal=True`` where the mask
    is the causal one alone, else absent}; (None, None) with the reason
    printed where PyTorch refuses a call."""
    from repro_torch.kernels.flash_attention.ref import attention_mask
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sq, skv = q.shape[2], k.shape[2]
    full = not kw["causal"] and kw["window"] is None
    mask = None if full else attention_mask(
        sq, skv, kw["causal"], kw["window"], kw["kv_offset"], q.device)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    ways = {"mask": dict(attn_mask=mask)}
    if kw["causal"] and kw["window"] is None and kw["kv_offset"] == 0 \
            and sq == skv:
        ways["is_causal"] = dict(is_causal=True)
    out = {}
    for name, extra in ways.items():
        def fwd():
            return sdpa(qs, ks, vs, scale=kw["scale"], enable_gqa=True,
                        **extra)

        def fwd_bwd():
            fwd().backward(do)
        try:
            out[name] = (time_ms(torch, fwd, 3), time_ms(torch, fwd_bwd, 3))
        except RuntimeError as e:
            out[name] = (None, None)
            print(f"scaled_dot_product_attention ({name}) not timed: {e}")
    return out


#: the backward's shapes past head dim 128 that phase 9 times (BWD_CASES'
#: names) and the leg 3 model whose layers launch each (None: no layer of
#: leg 3's cut; gemma3-27b's global layer is the sixth of its pattern)
BWD_WIDE_TIMED = (("gemma3_local", "gemma3-27b"),
                  ("recurrentgemma_local", "recurrentgemma-2b"),
                  ("gemma3_global", None))


def backward_wide_times(torch, wide: dict) -> list:
    """Kernel 12's backward in bf16 past head dim 128 (the tensor cores'
    wide route) at BWD_WIDE_TIMED's shapes: alone (launches back to back
    inside one wrapper call), its plain version, its bound (10·D
    operations a visible pair at the bf16 tensor-core rate,
    ``ops.attention_flops``, or the bytes of q, k, v, o, dO and lse read
    and dq, dk, dv written once over the memory rate),
    scaled_dot_product_attention's backward with the boolean mask
    (forward and backward less its forward) and its launches in leg 3
    (``wide``: train_wide_heads' info)."""
    from repro_torch.kernels.flash_attention import ops
    gen = torch.Generator(device="cuda").manual_seed(182)
    cases = {n: (sh, kw) for n, sh, kw in BWD_CASES}
    out = []
    for name, model in BWD_WIDE_TIMED:
        shape, kw = cases[name]
        b, hq, hkv, sq, skv, d = shape
        q, k, v = fa_inputs(torch, shape, torch.bfloat16, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        kw = dict(causal=kw["causal"], window=kw.get("window"),
                  kv_offset=kw.get("kv_offset", 0), scale=d ** -0.5)
        o, lse = ops._forward_cuda(q, k, v, with_lse=True, **kw)
        tc0 = ops.flash_attention_backward_cuda.tc_launches
        ms = launch_ms(torch, lambda: ops.flash_attention_backward_cuda(
            q, k, v, o, lse, do, **kw), "flash_attention_bwd", 5)
        check(ops.flash_attention_backward_cuda.tc_launches == tc0 + 1,
              f"the timed bf16 backward at {name} did not take the "
              f"tensor-core route")
        plain_ms = time_ms(torch, lambda: plain(
            ops.flash_attention_backward_plain, q, k, v, o, lse, do, **kw), 1)
        lib = sdpa_backward_ms(torch, q, k, v, do, kw)["mask"]
        flops = ops.attention_flops(q.shape, k.shape, kw["causal"],
                                    kw["window"], kw["kv_offset"], 10)
        nbytes = 2 * (3 * b * hq * sq * d + 2 * b * hkv * skv * d) \
            + 4 * b * hq * sq + 2 * (b * hq * sq + 2 * b * hkv * skv) * d
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        row = dict(case=name, shape=list(shape), **kw, ms=ms,
                   plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_share=max(t_ops, t_bytes) * 1e3 / ms,
                   library_ms=(None if lib[1] is None else lib[1] - lib[0]),
                   library_fwd_bwd_ms=lib[1], library_fwd_ms=lib[0],
                   flops=flops, bytes=nbytes, train_model=model,
                   train_launches=(0 if model is None else
                                   wide[model]["launches"]
                                   ["flash_attention_bwd"]))
        out.append(row)
        print(f"timing flash_attention_bwd past head dim 128 at {name} "
              f"{shape} {kw}: {ms:.4f} ms alone "
              f"({flops / ms / 1e9:.1f} TFLOP/s of visible work, "
              f"{row['bound_share']:.4f} of its bound {row['bound_ms']:.4f} "
              f"ms by {row['bound_by']}); plain {plain_ms:.2f} ms; "
              f"scaled_dot_product_attention's backward {row['library_ms']} "
              f"ms with the boolean mask; {row['train_launches']} launches "
              f"in leg 3 ({model})")
        del q, k, v, do, o, lse
    return out


def backward_rows(torch, launches, parity: Parity, shares, wide):
    """Kernel 12's backward at the slice's geometry (TRAIN_B x TRAIN_S,
    32/8 heads of 64, causal), bf16: alone (launches back to back inside
    one wrapper call), its plain version, its f32 route, its bound (10·D
    operations a visible pair at the bf16 tensor-core rate, or the f32
    rate for f32; or the bytes of q, k, v, o, dO and lse read and dq, dk,
    dv written once over the memory rate) and scaled_dot_product_attention
    with the boolean causal mask and with ``is_causal`` (``sdpa_backward_ms``),
    forward plus backward less its forward; then past head dim 128
    (``backward_wide_times``, with leg 3's info ``wide``)."""
    from repro_torch.kernels.flash_attention import ops
    gen = torch.Generator(device="cuda").manual_seed(181)
    B, hq, hkv, S, d = TRAIN_B, 32, 8, TRAIN_S, 64
    q, k, v = fa_inputs(torch, (B, hq, hkv, S, S, d), torch.bfloat16, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    kw = dict(causal=True, window=None, kv_offset=0, scale=d ** -0.5)
    o, lse = ops._forward_cuda(q, k, v, with_lse=True, **kw)
    tc0 = ops.flash_attention_backward_cuda.tc_launches
    ms = launch_ms(torch, lambda: ops.flash_attention_backward_cuda(
        q, k, v, o, lse, do, **kw), "flash_attention_bwd", 5)
    check(ops.flash_attention_backward_cuda.tc_launches == tc0 + 1,
          "the timed bf16 backward did not take the tensor-core route")
    plain_ms = time_ms(torch, lambda: plain(
        ops.flash_attention_backward_plain, q, k, v, o, lse, do, **kw), 1)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o32, lse32 = ops._forward_cuda(q32, k32, v32, with_lse=True, **kw)
    f32_ms = launch_ms(torch, lambda: ops.flash_attention_backward_cuda(
        q32, k32, v32, o32, lse32, do32, **kw), "flash_attention_bwd", 2)
    del q32, k32, v32, do32, o32, lse32
    lib = sdpa_backward_ms(torch, q, k, v, do, kw)
    sdpa_fwd_ms, sdpa_ms = lib["mask"]
    causal_fwd_ms, causal_ms = lib.get("is_causal", (None, None))
    pairs = ops.visible_pairs(S, S, True, None, 0)
    flops = 10 * d * pairs * B * hq
    nbytes = 2 * (3 * B * hq * S * d + 2 * B * hkv * S * d) \
        + 4 * B * hq * S + 2 * (B * hq + 2 * B * hkv) * S * d
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    f32_bound = max(flops / F32_FLOPS_PER_S, 2 * t_bytes) * 1e3
    row = dict(name="flash_attention_bwd", route="cuda",
               source=SOURCES["flash_attention_bwd"],
               replaces=REPLACES["flash_attention_bwd"],
               launches=launches["flash_attention_bwd"],
               max_abs_err=parity.err["flash_attention_bwd"], ms=ms,
               plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=(None if sdpa_ms is None
                           else sdpa_ms - sdpa_fwd_ms), f32_ms=f32_ms,
               f32_bound_ms=f32_bound, library_fwd_bwd_ms=sdpa_ms,
               library_fwd_ms=sdpa_fwd_ms,
               library_is_causal_ms=(None if causal_ms is None
                                     else causal_ms - causal_fwd_ms),
               bound_share=max(t_ops, t_bytes) * 1e3 / ms,
               bound_shares=shares,
               registers={n: r for n, r in PTXAS_REGISTERS.items()
                          if "attention_bwd" in n},
               shape=dict(B=B, Hq=hq, Hkv=hkv, S=S, D=d, causal=True,
                          dtype="bfloat16", pairs_per_head=pairs,
                          flops=flops, bytes=nbytes))
    print(f"timing flash_attention_bwd at {B} x {hq}/{hkv} heads of {d}, "
          f"{S} tokens, causal: bf16 (tensor cores) {ms:.4f} ms alone "
          f"({flops / ms / 1e9:.1f} TFLOP/s of visible work, "
          f"{row['bound_share']:.4f} of its bound), f32 "
          f"{f32_ms:.4f} ms (its bound {f32_bound:.4f} ms at the f32 rate); "
          f"plain {plain_ms:.2f} ms; scaled_dot_product_attention's "
          f"backward {row['library_ms']} ms with the boolean mask (forward "
          f"and backward {sdpa_ms}, forward {sdpa_fwd_ms}), "
          f"{row['library_is_causal_ms']} ms with is_causal; bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']}")
    row["wide_heads"] = backward_wide_times(torch, wide)
    return [row]

# ---------------------------------------------------------------------------
# the sharded path (phase 19): granite-3-2b trained and served on a mesh
# ---------------------------------------------------------------------------
def shard_setup(torch):
    """granite-3-2b cut to SHARD_LAYERS at full width, its params on the
    card, the training batch, the serving prompts and their teacher tokens
    and the AdamW config, all drawn from SHARD_SEED by a generator on the
    card: every process that calls this holds the same values."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config(SHARD_ARCH), n_layers=SHARD_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SHARD_SEED)
    params = init_params(cfg, gen, device="cuda")
    toks = torch.randint(0, cfg.vocab, (SHARD_B, SHARD_S + SHARD_DECODE1 + 1),
                         generator=gen, device="cuda", dtype=torch.int32)
    batch = {"tokens": toks[:, :SHARD_S].contiguous(),
             "labels": toks[:, 1:SHARD_S + 1].contiguous()}
    teacher = toks[:, SHARD_S:SHARD_S + SHARD_DECODE1].contiguous()
    opt = AdamWConfig(warmup_steps=1, state_dtype=cfg.adam_dtype)
    return cfg, params, batch, teacher, opt


def flash_setup(torch):
    """h2o-danube-3-4b cut to FLASH_LAYERS at full width, its params on
    the card, a 1 x FLASH_S prompt and FLASH_STEPS teacher tokens, from
    FLASH_SEED by a generator on the card (the same values in every
    process)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config(FLASH_ARCH), n_layers=FLASH_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(FLASH_SEED)
    params = init_params(cfg, gen, device="cuda")
    toks = torch.randint(0, cfg.vocab, (1, FLASH_S + FLASH_STEPS),
                         generator=gen, device="cuda", dtype=torch.int32)
    return cfg, params, toks[:, :FLASH_S].contiguous(), \
        toks[:, FLASH_S:].contiguous()


def flash_logits(torch, cfg, params, prompt, teacher):
    """The unsharded prefill's cache and the unsharded decode's logits of
    each teacher token (the reference of the flash-decoding steps)."""
    from repro_torch.models import decode_step, prefill
    out = []
    with torch.no_grad():
        _, cache = prefill(cfg, params, prompt,
                           cache_len=FLASH_S + FLASH_STEPS)
        for i in range(FLASH_STEPS):
            logits, cache = decode_step(cfg, params, cache,
                                        teacher[:, i:i + 1], FLASH_S + i)
            out.append(logits)
    return out


def flash_rank(torch, mesh) -> tuple:
    """A rank's flash-decoding run: the unsharded prefill, its cache and
    the params placed by SERVE_RULES (the cache's ring slots over data at
    batch 1, and the FSDP split of "embed" kept: the stream d-split over
    data), FLASH_STEPS decode steps on the mesh, the first under
    ``DotFlops``; then the first step again in the layout without the
    split (SHARD_CARD4_UNSPLIT's rules, the weights gathered whole over
    data) on another placement of the same cache, under ``DotFlops``.
    Returns (the local logits, their placements, each step's collectives,
    whether every cache k split its slots, {"split", "unsplit": a step's
    dot FLOPs record}, the unsplit step's collectives and local logits)."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.hlo_flops import DotFlops
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.partitioning import (batch_axes, cache_axes,
                                                 param_axes)
    rules, unsplit = sh.SERVE_RULES, card4_rules(sh.SERVE_RULES)
    cfg, params, prompt, teacher = flash_setup(torch)
    with torch.no_grad():
        _, cache = prefill(cfg, params, prompt,
                           cache_len=FLASH_S + FLASH_STEPS)
    p_sh = place(params, param_axes, mesh, rules)
    c_sh = place(cache, cache_axes, mesh, rules)
    p_un = place(params, param_axes, mesh, unsplit)
    c_un = place(cache, cache_axes, mesh, unsplit)
    del params, cache
    torch.cuda.empty_cache()
    split = all(placement_codes(t)[0] == ("S", t.ndim - 2)
                for path, t in leaf_dict(c_sh).items() if path.endswith("/k"))
    logits, colls, dots = [], [], {}

    def step(p, c, r, i):
        tok = place({"token": teacher[:, i:i + 1]}, batch_axes, mesh,
                    r)["token"]
        with activation_sharding(mapping_from_mesh(mesh, r), mesh), \
                DotFlops() as d:
            out = counted_collectives(
                torch, lambda: decode_step(cfg, p, c, tok, FLASH_S + i))
        return out, d.record_dict()
    with torch.no_grad():
        for i in range(FLASH_STEPS):
            ((lg, c_sh), coll, _), d = step(p_sh, c_sh, rules, i)
            if i == 0:
                dots["split"] = d
            logits.append(lg.to_local().cpu())
            colls.append(coll)
        ((lg_un, _), coll_un, _), dots["unsplit"] = step(p_un, c_un,
                                                         unsplit, 0)
    return (logits, placement_codes(lg), colls, split, dots, coll_un,
            (lg_un.to_local().cpu(), placement_codes(lg_un)))


def shard_moe_setup(torch):
    """mixtral-8x22b cut to SHARD_MOE_LAYERS at full width, moe_impl
    "gspmd" at SHARD_MOE_CAPACITY, its params on the card from
    MIXTRAL_SEED by a generator on the card, and the 1 x SHARD_MOE_S
    prompt (phase 16's ``synthetic_tokens``): the same values in every
    process."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config(MIXTRAL_ARCH),
                              n_layers=SHARD_MOE_LAYERS, moe_impl="gspmd",
                              capacity_factor=SHARD_MOE_CAPACITY)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        MIXTRAL_SEED), device="cuda")
    prompt = torch.from_numpy(synthetic_tokens(
        1, SHARD_MOE_S, cfg.vocab, seed=MIXTRAL_SEED)).cuda()
    return cfg, params, prompt


#: the Route fields whose equality is the same kept slots
ROUTE_KEPT = ("eidx", "se", "st", "keep", "slot")


def moe_rank(torch, mesh, rank: int) -> tuple:
    """A rank's gspmd MoE leg: the ranks initialise the whole params in
    turn (each placing them by SERVE_RULES with "embed" kept, then
    freeing them), then one prefill of the prompt from zeroed counts,
    counting its collectives, the MoE layer's own (``CommDebugMode``) and
    recording the Route it sorts (``layers.route_of``) and the layer's
    local input.  Returns (info, tensors: the local logits and their
    placements, the route's kept-slot fields and logits, the layer
    input's local block and placements)."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch import sharding as sh
    from repro_torch.models import layers, prefill, sharded
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.partitioning import batch_axes, param_axes
    t0 = time.perf_counter()
    rules = sh.SERVE_RULES
    for r in range(SHARD_WORLD):        # one rank's whole params at a time
        if r == rank:
            cfg, params, prompt = shard_moe_setup(torch)
            p_sh = place(params, param_axes, mesh, rules)
            del params
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    init_s = time.perf_counter() - t0
    tok = place({"tokens": prompt}, batch_axes, mesh, rules)["tokens"]
    seen = {"routes": [], "inputs": [], "comms": []}
    moe, route_of = sharded._moe, layers.route_of

    def tap_moe(cfg_, norm, p, x):
        with CommDebugMode() as comm:
            y = moe(cfg_, norm, p, x)
        seen["comms"].append({str(k).split(".")[-1]: v for k, v in
                              comm.get_comm_counts().items()})
        seen["inputs"].append((x.to_local().cpu(), placement_codes(x)))
        return y

    def tap_route(*a):
        r = route_of(*a)
        seen["routes"].append(r)
        return r
    zero_counts()
    sharded._moe, layers.route_of = tap_moe, tap_route
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad(), activation_sharding(
                mapping_from_mesh(mesh, rules), mesh):
            (logits, _), coll, _ = counted_collectives(
                torch, lambda: prefill(cfg, p_sh, tok,
                                       cache_len=SHARD_MOE_S))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
    finally:
        sharded._moe, layers.route_of = moe, route_of
    launches = LaunchLog.counts()
    r = seen["routes"][0]
    info = dict(init_s=init_s, prefill_s=prefill_s,
                leg_s=time.perf_counter() - t0, collectives=coll,
                moe_comms=seen["comms"], launches=launches,
                dropped=int(layers.dropped_slots(r)),
                stream=seen["inputs"][0][1])
    out = dict(logits=logits.to_local().cpu(),
               logit_placements=placement_codes(logits),
               route={f: getattr(r, f).cpu() for f in ROUTE_KEPT},
               route_logits=r.logits.cpu(),
               moe_input=seen["inputs"][0][0],
               moe_input_placements=seen["inputs"][0][1])
    return info, out


def place(tree, axes_of, mesh, rules):
    """``distribute_tree`` of ``tree`` with its placements from
    ``axes_of`` (a partitioning function) and ``rules``."""
    from repro_torch.launch import sharding as sh
    return sh.distribute_tree(tree, sh.resolve_tree(tree, axes_of(tree),
                                                    mesh, rules), mesh)


def card4_rules(rules) -> dict:
    """``rules`` for the card's world of 4 (SHARD_CARD4_UNSPLIT)."""
    return dict(rules, **{SHARD_CARD4_UNSPLIT: None})


def serve_logits(torch, cfg, params, tokens, teacher, steps, mesh=None,
                 rules=None):
    """(the prefill's last logits and ``steps`` decode steps' logits, each
    step fed the teacher's token; their placements).  On ``mesh`` under
    ``rules`` (SERVE_RULES when None; tokens placed by ``BATCH_AXES``)
    each rank's local logits, else the whole ones and None."""
    import contextlib
    from repro_torch.launch import sharding as sh
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.partitioning import batch_axes

    rules = sh.SERVE_RULES if rules is None else rules

    def inputs(d):
        return place(d, batch_axes, mesh, rules) if mesh else d

    def local(t):
        return t.to_local() if mesh else t

    ctx = (activation_sharding(mapping_from_mesh(mesh, rules), mesh)
           if mesh else contextlib.nullcontext())
    out = []
    with torch.no_grad(), ctx:
        logits, cache = prefill(cfg, params, inputs({"tokens": tokens})[
            "tokens"], cache_len=SHARD_S + steps)
        out.append(local(logits))
        for i in range(steps):
            tok = inputs({"token": teacher[:, i:i + 1]})["token"]
            logits, cache = decode_step(cfg, params, cache, tok, SHARD_S + i)
            out.append(local(logits))
    return out, (placement_codes(logits) if mesh else None)


def placement_codes(t) -> list:
    """A DTensor's placements as ("S", dim) or ("R",), for ``stitch``."""
    return [("S", q.dim) if hasattr(q, "dim") else ("R",)
            for q in t.placements]


def counted_collectives(torch, fn):
    """(fn(), {kind: [count, bytes]}, CommDebugMode's counts and the
    dispatch mode's by op): the collectives of one call, from both
    counters, whose counts must agree."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.hlo_analysis import CollectiveBytes
    with CommDebugMode() as comm, CollectiveBytes() as cb:
        out = fn()
    torch.cuda.synchronize()
    debug = {str(k).split(".")[-1]: v
             for k, v in comm.get_comm_counts().items()}
    names = {"all-reduce": "all_reduce",
             "all-gather": "all_gather_into_tensor",
             "reduce-scatter": "reduce_scatter_tensor",
             "all-to-all": "all_to_all_single"}
    check(all(debug.get(names[k], 0) == n for k, n in cb.counts.items())
          and sum(debug.values()) == sum(cb.counts.values()),
          f"sharded: CommDebugMode counted {debug}, the dispatch mode "
          f"{cb.counts}")
    return out, {k: [cb.counts[k], cb.bytes[k]] for k in cb.counts}, \
        dict(debug=debug, ops=cb.ops)


def shard_world1(torch, tmp: str) -> tuple:
    """Phase 19 (a), a world of one NCCL rank in this process: SHARD_STEPS
    train steps of the state placed on a 1 x 1 mesh bitwise the unsharded
    steps (each step's loss and metrics, and every leaf of params, m and
    v after them), then the prefill and SHARD_DECODE1 decode steps under
    SERVE_RULES bitwise the unsharded ones; kernel 12 and its backward
    launched through the sharded path, counted from zero; the first
    step's products counted (``hlo_flops.DotFlops``) for phase 20.
    Returns (info, launches)."""
    import contextlib
    import os
    import torch.distributed as dist
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.hlo_flops import DotFlops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.decoder import tree_map
    from repro_torch.models.partitioning import batch_axes
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.train.steps import TrainState, train_state_axes
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "nccl"),
                                                 1))
    try:
        mesh = make_mesh((1, 1), SHARD_AXES)
        cfg, params, batch, teacher, opt = shard_setup(torch)
        glob = TrainState(tree_map(lambda t: t.clone(), params),
                          adamw_init(params, opt))
        state = place(glob, train_state_axes, mesh, sh.TRAIN_RULES)
        del glob
        b_sh = place(batch, batch_axes, mesh, sh.TRAIN_RULES)
        ref = TrainState(params, adamw_init(params, opt))
        step = make_train_step(cfg, opt)
        walls = {"unsharded": [], "sharded": []}
        ref_m = []
        for _ in range(SHARD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step(ref, batch)
            torch.cuda.synchronize()
            walls["unsharded"].append(time.perf_counter() - t0)
            ref_m.append({k: v.clone() for k, v in m.items()})
        ref_logits, _ = serve_logits(torch, cfg, ref.params,
                                     batch["tokens"], teacher, SHARD_DECODE1)
        mapping = mapping_from_mesh(mesh, sh.TRAIN_RULES)
        zero_counts()
        collectives = []
        for i in range(SHARD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the first step's products counted for phase 20's dry run
            with activation_sharding(mapping, mesh), (
                    DotFlops() if i == 0 else contextlib.nullcontext()) as d:
                (_, m), coll, _ = counted_collectives(
                    torch, lambda: step(state, b_sh))
            if i == 0:
                dots = d.record_dict()
            torch.cuda.synchronize()
            walls["sharded"].append(time.perf_counter() - t0)
            collectives.append(coll)
            for k, v in ref_m[i].items():
                check(torch_equal(m[k], v), f"sharded: world 1 step {i}'s "
                      f"{k} {float(m[k])} is not the unsharded "
                      f"{float(v)}")
        for part, a, b in (("params", state.params, ref.params),
                           ("m", state.opt.m, ref.opt.m),
                           ("v", state.opt.v, ref.opt.v)):
            want = leaf_dict(b)
            for path, t in leaf_dict(a).items():
                check(torch_equal(t.to_local(), want[path]), f"sharded: "
                      f"world 1 {part}{path} differs from the unsharded "
                      f"steps'")
        got, _ = serve_logits(torch, cfg, state.params, batch["tokens"],
                              teacher, SHARD_DECODE1, mesh)
        torch.cuda.synchronize()
        launches = LaunchLog.counts()
        for i, (a, b) in enumerate(zip(got, ref_logits)):
            check(torch_equal(a, b), f"sharded: world 1 serving step {i}'s "
                  f"logits differ from the unsharded step's")
        want = {"flash_attention": SHARD_LAYERS * (2 * SHARD_STEPS + 1),
                "flash_attention_bwd": SHARD_LAYERS * SHARD_STEPS}
        check(all(launches[k] == v for k, v in want.items()) and all(
            v == 0 for k, v in launches.items() if k not in want),
            f"sharded: world 1 launched {launches}, expected {want}")
        info = dict(step_walls_s=walls, collectives_per_step=collectives,
                    loss=[float(m["loss"]) for m in ref_m],
                    serve_steps_bitwise=len(got), dot_flops=dots)
    finally:
        dist.destroy_process_group()
    return info, launches


def stitch(torch, pieces, shape):
    """The global tensor of ``shape`` from each rank's (coordinate, local
    tensor, placements): each local block written where ``local_shard``
    cut it from."""
    out = None
    for coord, local, places in pieces:
        if out is None:
            out = torch.empty(shape, dtype=local.dtype)
        idx = [slice(None)] * len(shape)
        for m, p in enumerate(places):
            if p[0] == "S":
                dim, n = p[1], SHARD_MESH[m]
                cur = idx[dim]
                start = cur.start or 0
                size = ((cur.stop if cur.stop is not None else shape[dim])
                        - start) // n
                idx[dim] = slice(start + coord[m] * size,
                                 start + (coord[m] + 1) * size)
        out[tuple(idx)] = local
    return out


def shard_rank(argv) -> int:
    """One rank of phase 19's gloo world (``--shard-rank R --shard-world W
    --shard-store FILE --shard-out DIR``) on the card: the prefill and
    SHARD_DECODE4 decode steps under SERVE_RULES, then one train step
    (``value_and_grad`` and ``adamw_update``, as ``make_train_step``
    composes them) under TRAIN_RULES, both without SHARD_CARD4_UNSPLIT's
    split (``card4_rules``), each rank's local shapes against
    ``resolve_spec``; its local logits, gradients and updated params, the
    step's wall and collectives and kernel 12's launches and geometries,
    then the flash-decoding steps (``flash_rank``) and the gspmd MoE leg
    (``moe_rank``), to DIR/rank<R>.pt and DIR/rank<R>.json."""
    import faulthandler
    import os
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    faulthandler.enable()
    opts = dict(zip(argv[1::2], argv[2::2]))
    rank, world = int(opts["--shard-rank"]), int(opts["--shard-world"])
    out = opts["--shard-out"]
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.partitioning import batch_axes, param_axes
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.train.steps import TrainState, value_and_grad
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(opts["--shard-store"],
                                                 world))
    try:
        mesh = make_mesh(SHARD_MESH, SHARD_AXES)
        cfg, params, batch, teacher, opt = shard_setup(torch)
        train_rules = card4_rules(sh.TRAIN_RULES)
        serve_rules = card4_rules(sh.SERVE_RULES)
        shapes = {path: tuple(t.shape)
                  for path, t in leaf_dict(params).items()}
        axes = leaf_dict(param_axes(params))
        p_sh = place(params, param_axes, mesh, train_rules)
        del params
        torch.cuda.empty_cache()
        sizes = dict(zip(SHARD_AXES, SHARD_MESH))
        info = {"coordinate": list(mesh.get_coordinate())}
        bad = []
        for path, t in leaf_dict(p_sh).items():
            parts = sh.resolve_spec(shapes[path], axes[path], mesh,
                                    train_rules)
            want = [n // math.prod(sizes[a] for a in (
                () if p is None else (p,) if isinstance(p, str) else p))
                for n, p in zip(shapes[path], parts)]
            if list(t.to_local().shape) != want:
                bad.append(path)
        info["shapes_unlike_resolve_spec"] = bad
        zero_counts()
        with LaunchLog() as log:
            logits, logit_places = serve_logits(
                torch, cfg, p_sh, batch["tokens"], teacher, SHARD_DECODE4,
                mesh, serve_rules)
            torch.cuda.synchronize()
            info["serve_launches"] = LaunchLog.counts()
            state = TrainState(p_sh, adamw_init(p_sh, opt))
            b_sh = place(batch, batch_axes, mesh, train_rules)
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with activation_sharding(mapping_from_mesh(
                    mesh, train_rules), mesh):
                (grads, metrics), coll, debug = counted_collectives(
                    torch, lambda: value_and_grad(cfg, state.params, b_sh))
                (_, _, om), coll_u, _ = counted_collectives(
                    torch, lambda: adamw_update(state.params, grads,
                                                state.opt, opt))
            torch.cuda.synchronize()
            info["step_wall_s"] = time.perf_counter() - t0
            info["train_launches"] = LaunchLog.counts()
        info["geometries"] = sorted({
            json.dumps(dict(g)) for (who, g), _ in log.geometries.items()
            if who in ("flash_attention", "flash_attention_bwd")})
        info.update(collectives_grad=coll, collectives_update=coll_u,
                    comm_debug_grad=debug, loss=float(metrics["loss"]),
                    grad_norm=float(om["grad_norm"]), lr=float(om["lr"]))
        # a block replicated over data is written by data coordinate 0 only
        places = {p: placement_codes(t) for p, t in leaf_dict(grads).items()}
        mine = {p for p, c in places.items()
                if c[0][0] == "S" or mesh.get_coordinate()[0] == 0}
        res = {"grads": {p: t.to_local().cpu()
                         for p, t in leaf_dict(grads).items() if p in mine},
               "params": {p: t.to_local().cpu()
                          for p, t in leaf_dict(state.params).items()
                          if p in mine},
               "placements": places,
               "logits": [t.cpu() for t in logits],
               "logit_placements": logit_places}
        del state, grads, b_sh, p_sh, metrics
        torch.cuda.empty_cache()
        (res["flash_logits"], res["flash_placements"],
         info["flash_collectives"], info["flash_split"],
         info["flash_dot_flops"], info["flash_unsplit_collectives"],
         res["flash_unsplit"]) = flash_rank(torch, mesh)
        torch.cuda.empty_cache()
        info["moe"], res["moe"] = moe_rank(torch, mesh, rank)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    finally:
        dist.destroy_process_group()
    return 0


def shard_world4(torch, tmp: str) -> dict:
    """Phase 19 (b): the gloo world of SHARD_WORLD ranks on the card (fresh
    interpreters, ``--shard-rank``; the rules without SHARD_CARD4_UNSPLIT's
    split), while this process runs the unsharded serving steps and the
    unsharded gradients on the same values.  The ranks' logits, stitched,
    within SHARD_LOGIT_SHARE of max |logit|; their
    gradients, stitched, within TRAIN_CPU_SHARE of each leaf's largest
    entry, and loss and grad_norm within TRAIN_CPU_SHARE relative (phase
    18's card == CPU law); their updated params within four f32 ulps plus
    1e-6·lr of ``adamw_update`` applied here to the stitched gradients;
    each rank's shapes resolve_spec's and kernel 12 and its backward run
    on each rank's 16 query and 4 kv heads; the flash-decoding steps
    (``flash_rank``), stitched, within SHARD_LOGIT_SHARE of max |logit| of
    the unsharded decode, each step's collectives the same."""
    import os
    from repro_torch.models import prefill
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.train import make_grad_step
    t0 = time.perf_counter()
    procs = []
    for rank in range(SHARD_WORLD):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--shard-rank", str(rank), "--shard-world", str(SHARD_WORLD),
             "--shard-store", os.path.join(tmp, "store"), "--shard-out",
             tmp], stdout=log, stderr=subprocess.STDOUT), log))
    try:
        cfg, params, batch, teacher, opt = shard_setup(torch)
        want_logits, _ = serve_logits(torch, cfg, params, batch["tokens"],
                                      teacher, SHARD_DECODE4)
        grads, gnorm, loss = make_grad_step(cfg)(params, batch)
        fcfg, fparams, fprompt, fteacher = flash_setup(torch)
        flash_want = [t.cpu() for t in flash_logits(torch, fcfg, fparams,
                                                    fprompt, fteacher)]
        del fparams
        torch.cuda.synchronize()
    finally:
        try:
            for p, _ in procs:
                p.wait(timeout=SHARD_RANK_TIMEOUT_S)
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
    spawn_to_join = time.perf_counter() - t0
    for rank, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"rank{rank}.log")) as f:
                print(f.read()[-6000:], file=sys.stderr)
        check(p.returncode == 0, f"sharded rank {rank} exited "
              f"{p.returncode}")
    # the unsharded MoE prefill once the ranks are done, so that it shares
    # the card with none of their timed steps
    torch.cuda.empty_cache()
    mcfg, mparams, mprompt = shard_moe_setup(torch)
    with torch.no_grad(), RouteTap() as mtap:
        moe_want, _ = prefill(mcfg, mparams, mprompt, cache_len=SHARD_MOE_S)
    moe_want = moe_want.cpu()
    infos, ranks = [], []
    for rank in range(SHARD_WORLD):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            infos.append(json.load(f))
        ranks.append(torch.load(os.path.join(tmp, f"rank{rank}.pt"),
                                weights_only=False))
    for rank, info in enumerate(infos):
        check(not info["shapes_unlike_resolve_spec"], f"sharded: rank "
              f"{rank}'s local shapes differ from resolve_spec's: "
              f"{info['shapes_unlike_resolve_spec']}")
        geos = [json.loads(g) for g in info["geometries"]]
        check(geos and all(g["Hq"] == cfg.n_heads // SHARD_MESH[1]
                           and g["Hkv"] == cfg.n_kv_heads // SHARD_MESH[1]
                           for g in geos),
              f"sharded: rank {rank}'s kernel 12 geometries {geos} are not "
              f"its 16 query and 4 kv heads")
        for key, want in (("serve_launches", {
                "flash_attention": SHARD_LAYERS}), ("train_launches", {
                "flash_attention": 2 * SHARD_LAYERS,
                "flash_attention_bwd": SHARD_LAYERS})):
            got = info[key]
            check(all(got[k] == v for k, v in want.items()) and all(
                v == 0 for k, v in got.items() if k not in want),
                f"sharded: rank {rank}'s {key} {got}, expected {want}")
        for what, a, b in (("loss", info["loss"], float(loss)),
                           ("grad_norm", info["grad_norm"], float(gnorm))):
            check(abs(a - b) <= TRAIN_CPU_SHARE * abs(b), f"sharded: rank "
                  f"{rank}'s {what} {a} against the unsharded {b}")
    coords = [tuple(i["coordinate"]) for i in infos]
    worst_logit = 0.0
    for i, want in enumerate(want_logits):
        want = want.cpu()
        got = stitch(torch, [(c, r["logits"][i], r["logit_placements"])
                             for c, r in zip(coords, ranks)],
                     tuple(want.shape))
        err = float((got - want).abs().max())
        tol = logits_tolerance(want[..., :cfg.vocab], SHARD_LOGIT_SHARE)
        worst_logit = max(worst_logit, err / tol)
        check(err <= tol, f"sharded: world 4 serving step {i}'s logits "
              f"{err} from the unsharded, past {tol}")
    worst_flash = 0.0
    for i, want in enumerate(flash_want):
        got = stitch(torch, [(c, r["flash_logits"][i], r["flash_placements"])
                             for c, r in zip(coords, ranks)],
                     tuple(want.shape))
        err = float((got - want).abs().max())
        tol = logits_tolerance(want[..., :fcfg.vocab], SHARD_LOGIT_SHARE)
        worst_flash = max(worst_flash, err / tol)
        check(err <= tol, f"sharded: flash-decoding step {i}'s logits {err} "
              f"from the unsharded decode, past {tol}")
    for rank, info in enumerate(infos):
        check(info["flash_split"], f"sharded: rank {rank}'s flash-decoding "
              f"cache does not split its slots over data")
        check(all(c == infos[0]["flash_collectives"][0]
                  for c in info["flash_collectives"]), f"sharded: rank "
              f"{rank}'s flash-decoding steps issued "
              f"{info['flash_collectives']}, not one count a step")
        check(all(set(c) == {"all-reduce"} for c in info[
            "flash_collectives"]), f"sharded: rank {rank}'s flash-decoding "
            f"steps with \"embed\" split issued {info['flash_collectives']}"
            f": all-reduces only were expected")
        dots = info["flash_dot_flops"]
        check(dots["split"]["flops"] < dots["unsplit"]["flops"],
              f"sharded: rank {rank}'s flash-decoding step with \"embed\" "
              f"split runs {dots}, not fewer products than without it")
    got = stitch(torch, [(c, *r["flash_unsplit"])
                         for c, r in zip(coords, ranks)],
                 tuple(flash_want[0].shape))
    err = float((got - flash_want[0]).abs().max())
    tol = logits_tolerance(flash_want[0][..., :fcfg.vocab], SHARD_LOGIT_SHARE)
    check(err <= tol, f"sharded: the flash-decoding step without the split "
          f"of \"embed\": logits {err} from the unsharded decode, past "
          f"{tol}")
    unsplit_share = err / tol
    moe = moe_checks(torch, mcfg, mparams, moe_want, mtap.routes[0], coords,
                     infos, ranks)
    del mparams
    torch.cuda.empty_cache()
    flat_g = leaf_dict(grads)
    stitched, grad_share = {}, {}
    for path, want in flat_g.items():
        got = stitch(torch, [(c, r["grads"][path], r["placements"][path])
                             for c, r in zip(coords, ranks)
                             if path in r["grads"]], tuple(want.shape))
        want = want.cpu()
        grad_share[path] = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        check(grad_share[path] <= TRAIN_CPU_SHARE, f"sharded: world 4's "
              f"gradient of {path} is {grad_share[path]} of its largest "
              f"entry away")
        stitched[path] = got
    from repro_torch.models.decoder import tree_map
    from repro_torch.train.steps import _rebuild
    g_tree = _rebuild(params, iter([stitched[p].cuda() for p in flat_g]))
    p_new = tree_map(lambda t: t.clone(), params)
    _, _, um = adamw_update(p_new, g_tree, adamw_init(p_new, opt), opt)
    ulps = 0.0
    for path, want in leaf_dict(p_new).items():
        got = stitch(torch, [(c, r["params"][path], r["placements"][path])
                             for c, r in zip(coords, ranks)
                             if path in r["params"]], tuple(want.shape))
        want = want.cpu()
        tol = 4 * torch.abs(torch.nextafter(want, want + 1) - want) \
            + 1e-6 * float(um["lr"])
        diff = (got - want).abs()
        ulps = max(ulps, float((diff / tol).max()))
        check(bool((diff <= tol).all()), f"sharded: world 4's updated "
              f"{path} max |err| {float(diff.max())} from adamw_update of "
              f"its gradients")
    return dict(spawn_to_join_s=spawn_to_join, unsplit=SHARD_CARD4_UNSPLIT,
                step_walls_s=[i["step_wall_s"] for i in infos],
                collectives_grad=infos[0]["collectives_grad"],
                collectives_update=infos[0]["collectives_update"],
                loss=(infos[0]["loss"], float(loss)),
                grad_norm=(infos[0]["grad_norm"], float(gnorm)),
                grad_share=max(grad_share.values()),
                worst_grad_leaf=max(grad_share, key=grad_share.get),
                update_share_of_tolerance=ulps,
                logit_share_of_tolerance=worst_logit,
                flash_collectives_per_step=infos[0]["flash_collectives"][0],
                flash_logit_share_of_tolerance=worst_flash,
                flash_dot_flops=infos[0]["flash_dot_flops"],
                flash_unsplit_collectives=infos[0][
                    "flash_unsplit_collectives"],
                flash_unsplit_logit_share_of_tolerance=unsplit_share,
                moe=moe, geometries=infos[0]["geometries"])


def moe_checks(torch, cfg, params, want, route_want, coords, infos,
               ranks) -> dict:
    """The gspmd MoE leg against this process's unsharded prefill: the
    ranks' logits, stitched, within SHARD_LOGIT_SHARE of max |logit|;
    every rank's Route the same; its kept slots bitwise the unsharded
    route (``layers.moe_route``) of the MoE layer's own input (the ranks'
    blocks, stitched) and in agreement with the unsharded prefill's
    routing as phase 16 holds card against CPU (``hold_routing``);
    kernel 12 once a layer on each rank; no all-gather in the prefill or
    the MoE layer.  Returns the figures printed."""
    from repro_torch.models import layers as L
    got = stitch(torch, [(c, r["moe"]["logits"], r["moe"]["logit_placements"])
                         for c, r in zip(coords, ranks)], tuple(want.shape))
    err = float((got - want).abs().max())
    tol = logits_tolerance(want[..., :cfg.vocab], SHARD_LOGIT_SHARE)
    check(err <= tol, f"sharded: the gspmd MoE prefill's logits {err} from "
          f"the unsharded prefill's, past {tol}")
    routes = [r["moe"]["route"] for r in ranks]
    check(all(torch.equal(r[f], routes[0][f]) for r in routes
              for f in ROUTE_KEPT), "sharded: the MoE ranks sorted "
          "different routes")
    x = stitch(torch, [(c, r["moe"]["moe_input"],
                        r["moe"]["moe_input_placements"])
                       for c, r in zip(coords, ranks) if c[1] == 0],
               (1, SHARD_MOE_S, cfg.d_model))
    layer = {k: v[0] for k, v in params["groups"]["0"]["mlp"].items()}
    with torch.no_grad():
        h = L.rms_norm(x.cuda(), params["groups"]["0"]["mlp_norm"][0],
                       cfg.norm_eps).reshape(-1, cfg.d_model)
        own = L.moe_route(cfg, layer, h)
    logit_diff = float((ranks[0]["moe"]["route_logits"]
                        - own.logits.cpu()).abs().max())
    same = [f for f in ROUTE_KEPT
            if not torch.equal(routes[0][f], getattr(own, f).cpu())]
    check(not same, f"sharded: the gspmd MoE's {same} differ from the "
          f"unsharded route of the same input (router logits "
          f"{logit_diff} apart)")
    # the layer's input is the sharded attention's, whose bf16 products
    # sum their d-split partials in another order: phase 16's card == CPU
    # law for the routing
    held, _ = hold_routing(torch, [own], [route_want], "sharded: the gspmd "
                           "MoE against the unsharded prefill's routing")
    for rank, info in enumerate(infos):
        m = info["moe"]
        check(m["launches"].get("flash_attention") == SHARD_MOE_LAYERS
              and sum(m["launches"].values()) == SHARD_MOE_LAYERS,
              f"sharded: rank {rank}'s MoE prefill launched "
              f"{m['launches']}")
        check("all-gather" not in m["collectives"] and all(
            "all_gather_into_tensor" not in c for c in m["moe_comms"]),
            f"sharded: rank {rank}'s gspmd MoE prefill issued "
            f"{m['collectives']}, its MoE layer {m['moe_comms']}")
        check([list(q) for q in m["stream"]] == [["S", 2], ["R"]],
              f"sharded: rank {rank}'s "
              f"MoE input is placed {m['stream']}, not d-split over data")
    return dict(logit_share_of_tolerance=err / tol,
                dropped=infos[0]["moe"]["dropped"],
                dropped_unsharded=int(L.dropped_slots(route_want)),
                router_logits_max_diff=logit_diff,
                against_unsharded_prefill=held,
                leg_s=max(i["moe"]["leg_s"] for i in infos),
                init_s=max(i["moe"]["init_s"] for i in infos),
                prefill_s=max(i["moe"]["prefill_s"] for i in infos),
                collectives=infos[0]["moe"]["collectives"],
                moe_layer_comms=infos[0]["moe"]["moe_comms"])


def phase_sharded_path(torch):
    """Phase 19: the sharded path; the world of one NCCL rank in this
    process, its launches from zeroed counts and its geometries logged for
    phase 8, then the world of SHARD_WORLD gloo ranks on the card.
    Returns the world-1 launches, the geometries and the info printed."""
    import os
    import shutil
    import tempfile
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="earl_sharded_")
    try:
        with LaunchLog() as log:
            w1, launches = shard_world1(torch, tmp)
        torch.cuda.empty_cache()
        w4dir = os.path.join(tmp, "world4")
        os.makedirs(w4dir)
        w4 = shard_world4(torch, w4dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    info = dict(world1=w1, world4=w4, card=smi,
                phase_s=time.perf_counter() - t0)
    print("sharded: " + json.dumps(info))
    print(f"launches, the sharded path (world 1): {json.dumps(launches)}; "
          f"phase 19 took {info['phase_s']:.1f} s")
    return launches, log.geometries, info


# ---------------------------------------------------------------------------
# the dry run and the last modules (phase 20)
# ---------------------------------------------------------------------------
def dry_trace(torch, world: int, mesh_shape, device: str, cfg, shape,
              rules_train, rules_serve) -> dict:
    """``launch/dryrun.trace_step`` of one step on a mesh of ``mesh_shape``
    (SHARD_AXES) over a fake process group of ``world`` ranks started in
    this process (rank 0) and destroyed after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_mesh(mesh_shape, SHARD_AXES, device=device)
        return trace_step(cfg, shape, mesh, rules_train, rules_serve)
    finally:
        dist.destroy_process_group()


def summed_collectives(*colls) -> dict:
    """{kind: [count, bytes]} records added kind by kind."""
    out = {}
    for c in colls:
        for kind, (n, b) in c.items():
            got = out.setdefault(kind, [0, 0])
            got[0] += n
            got[1] += b
    return out


def dry_collectives(rec) -> dict:
    return {k: [n, rec["collective_bytes_per_chip"][k]]
            for k, n in rec["collective_counts_per_chip"].items()}


#: a record's fields that must not depend on the fake tensors' device
DEVICE_FREE = ("flops", "bytes_accessed", "memory",
               "collective_bytes_per_chip", "collective_counts_per_chip",
               "dot_flops_per_chip", "dot_bytes_per_chip",
               "dot_flops_attention_per_chip", "dot_flops_by_op", "num_dots",
               "state_bytes_global", "state_bytes_per_chip", "leaf_params",
               "local_shapes")


def dryrun_checks(torch, sharded: dict) -> dict:
    """Phase 20 (a): the dry run against phase 19's real runs.  World 1:
    the fake 1 x 1 train step's dot FLOPs, bytes and count equal to the
    real step's (``hlo_flops.DotFlops``), exactly.  World 4: the fake
    2 x 2 train step's collectives (SHARD_CARD4_UNSPLIT's rules) equal to
    the real world's grad step and update, by kind with their bytes, and
    the fake flash-decoding step's (SERVE_RULES, "embed" kept) to each
    real one's, and its dot FLOPs to the real step's, exactly.  Both fake
    runs again with CPU tensors: every FLOP, byte and collective field the
    same.  Then DRY_CELLS' production records (``lower_cell`` on the
    card)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.models.config import ShapeConfig
    cfg = dataclasses.replace(get_config(SHARD_ARCH), n_layers=SHARD_LAYERS)
    train = ShapeConfig("phase19", "train", SHARD_S, SHARD_B)
    fcfg = dataclasses.replace(get_config(FLASH_ARCH), n_layers=FLASH_LAYERS)
    fshape = ShapeConfig("flash", "decode", FLASH_S + FLASH_STEPS, 1)
    card4 = (card4_rules(sh.TRAIN_RULES), card4_rules(sh.SERVE_RULES))
    serve = (card4[0], sh.SERVE_RULES)
    out = {}
    rec1 = dry_trace(torch, 1, (1, 1), "cuda", cfg, train, sh.TRAIN_RULES,
                     sh.SERVE_RULES)
    real1 = sharded["world1"]["dot_flops"]
    fake1 = dict(flops=rec1["dot_flops_per_chip"],
                 dot_bytes=rec1["dot_bytes_per_chip"],
                 num_dots=rec1["num_dots"])
    check(fake1 == real1, f"dry run: world 1's fake step counts {fake1}, "
          f"the real step {real1}")
    out["world1_dot_flops"] = real1
    recs = {}
    for device in ("cuda", "cpu"):
        recs[device] = (
            dry_trace(torch, SHARD_WORLD, SHARD_MESH, device, cfg, train,
                      *card4),
            dry_trace(torch, SHARD_WORLD, SHARD_MESH, device, fcfg, fshape,
                      *serve))
    w4 = sharded["world4"]
    want4 = summed_collectives(w4["collectives_grad"],
                               w4["collectives_update"])
    got4 = dry_collectives(recs["cuda"][0])
    check(got4 == want4, f"dry run: world 4's fake train step issues {got4}, "
          f"the real grad step and update {want4}")
    gotf = dry_collectives(recs["cuda"][1])
    wantf = w4["flash_collectives_per_step"]
    check(gotf == wantf, f"dry run: the fake flash-decoding step issues "
          f"{gotf}, each real one {wantf}")
    flops_f = recs["cuda"][1]["dot_flops_per_chip"]
    real_f = w4["flash_dot_flops"]["split"]["flops"]
    check(flops_f == real_f, f"dry run: the fake flash-decoding step counts "
          f"{flops_f} dot FLOPs, the real one {real_f}")
    for a, b, what in ((recs["cuda"][0], recs["cpu"][0], "train step"),
                       (recs["cuda"][1], recs["cpu"][1], "flash decode")):
        diff = {k: (a[k], b[k]) for k in DEVICE_FREE if a[k] != b[k]
                and k != "local_shapes"}
        check(not diff and a["local_shapes"] == b["local_shapes"],
              f"dry run: the {what}'s record on cuda and cpu differs: "
              f"{diff}")
    out.update(world4_collectives=got4, flash_collectives=gotf,
               world4_dot_flops=recs["cuda"][0]["dot_flops_per_chip"],
               flash_dot_flops=recs["cuda"][1]["dot_flops_per_chip"],
               lower_s={d: [r["lower_s"] for r in recs[d]] for d in recs})
    cells = {}
    for arch, shape, multi in DRY_CELLS:
        rec = lower_cell(arch, shape, multi, device="cuda")
        check(rec["status"] == "ok", f"dry run: {arch} {shape} "
              f"{rec['mesh']} is {rec['status']}: {rec.get('error')}")
        cells[f"{arch}.{shape}.{rec['mesh']}"] = dict(
            dot_flops_per_chip=rec["dot_flops_per_chip"],
            collective_bytes_per_chip=rec["collective_bytes_per_chip"],
            state_bytes_per_chip=rec["state_bytes_per_chip"],
            temp_bytes=rec["memory"]["temp_bytes"], lower_s=rec["lower_s"])
    out["production"] = cells
    return out


def analytics_checks(torch) -> dict:
    """Phase 20 (b): configs/earl_analytics.CONFIG on the card:
    EarlSession(backend="fused_rng") over Mean, Median and their group at
    CONFIG's N, split size, sigma, tau, pilot p and l (kernels 2, 3 and 4),
    kmeans_fit at its k and iterations and a KMeansStep bootstrap of the
    fit (kernels 9 and 8), each estimate against the exact one; walls and
    rows read; PostMapSampler's rows bitwise PreMapSampler's."""
    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.configs.earl_analytics import CONFIG
    from repro_torch.core import (EarlSession, KMeansStep, Mean, Median,
                                  StatisticGroup, bootstrap, kmeans_fit)
    from repro_torch.data import (PostMapSampler, PreMapSampler,
                                  ShardedStore, synthetic_clusters,
                                  synthetic_numeric)
    data = synthetic_numeric(CONFIG.N, mean=10.0, std=2.0, seed=0)
    exact = {"Mean": float(data.mean()), "Median": float(np.median(data))}

    def since(before):
        return {k: v - before[k] for k, v in LaunchLog.counts().items()}
    before = LaunchLog.counts()
    res = {}
    for name, stat in (("Mean", Mean()), ("Median", Median(lo=LO, hi=HI)),
                       ("group", StatisticGroup((Mean(),
                                                 Median(lo=LO, hi=HI))))):
        store = ShardedStore.from_array(data, split_size=CONFIG.split_size)
        session = EarlSession(PreMapSampler(store, seed=1), stat,
                              sigma=CONFIG.sigma, tau=CONFIG.tau,
                              p_pilot=CONFIG.p_pilot, l=CONFIG.l,
                              backend="fused_rng")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = session.run(trandom.PRNGKey(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        est = [float(torch.as_tensor(e).reshape(-1)[0]) for e in (
            o.result if name == "group" else [o.result])]
        want = [exact["Mean"], exact["Median"]] if name == "group" \
            else [exact[name]]
        for e, w in zip(est, want):
            check(abs(e - w) / abs(w) < 0.02, f"analytics: {name} session "
                  f"{e} against {w}")
        res[name] = dict(wall_s=wall, rows_read=store.stats.rows_read,
                         n_used=o.n_used, B=o.B, iterations=o.iterations,
                         fell_back=o.fell_back, cv=o.cv, estimate=est)
    launches = since(before)
    for k in ("fused_poisson_moments", "fused_poisson_hist",
              "fused_poisson_multi"):
        check(launches.get(k, 0) > 0, f"analytics: the sessions launched no "
              f"{k}: {launches}")
    x_np, _ = synthetic_clusters(KM_N, k=CONFIG.kmeans_k, dim=2, seed=5)
    x = torch.from_numpy(x_np).cuda()
    before = LaunchLog.counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cents, inertia = kmeans_fit(x, CONFIG.kmeans_k, CONFIG.kmeans_iters,
                                trandom.PRNGKey(0))
    boot = bootstrap(x, KMeansStep(cents), KM_B, trandom.PRNGKey(0),
                     backend="fused_rng")
    torch.cuda.synchronize()
    km_wall = time.perf_counter() - t0
    km_launches = since(before)
    check(km_launches["kmeans_assign"] > 0
          and km_launches["fused_poisson_kmeans"] > 0,
          f"analytics: k-means launched {km_launches}")
    check(bool(torch.isfinite(cents).all()) and bool(torch.isfinite(
        torch.as_tensor(boot.thetas[0] if isinstance(boot.thetas, tuple)
                        else boot.thetas)).all()),
          "analytics: k-means centroids or thetas not finite")
    res["kmeans"] = dict(wall_s=km_wall, k=CONFIG.kmeans_k,
                         iters=CONFIG.kmeans_iters, n=KM_N, B=KM_B,
                         inertia=float(inertia))
    res["launches"] = {k: launches[k] + km_launches[k] for k in launches
                       if launches[k] + km_launches[k]}
    small = synthetic_numeric(200_000, mean=10.0, std=2.0, seed=3)
    pre = PreMapSampler(ShardedStore.from_array(small, CONFIG.split_size),
                        seed=9)
    post_store = ShardedStore.from_array(small, CONFIG.split_size)
    post = PostMapSampler(post_store, seed=9)
    a, b = pre.take(0, 50_000), post.take(0, 50_000)
    check(a.is_cuda and b.is_cuda and torch_equal(a, b) and post.kv_count
          == post_store.N and post_store.stats.rows_read == post_store.N,
          "analytics: PostMapSampler's rows are not PreMapSampler's")
    res["post_map"] = dict(rows=50_000, rows_read=post_store.stats.rows_read)
    return res


def host_us_per_call(torch) -> dict:
    """Phase 20 (c): kernel 12's host time a call, the operator against
    the direct launch the wrappers made before (``flash_attention_cuda``,
    ``_forward_cuda``, ``flash_attention_backward_cuda``): HOST_CALLS
    calls without a sync at (1, 2, 128, 64) bf16, whose launches the host
    outruns, after a warm-up, the best of three."""
    from repro_torch.kernels.flash_attention import ops as fa
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((1, 2, 128, 64), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    kw = dict(causal=True, window=None, scale=0.125, kv_offset=0)
    args = (True, None, 0.125, 0, 512, 512)
    o, lse = fa._forward_cuda(q, k, v, with_lse=True, **kw)
    ops = torch.ops.repro_torch
    calls = {
        "forward_op": lambda: ops.flash_attention(q, k, v, *args),
        "forward_direct": lambda: fa.flash_attention_cuda(q, k, v, **kw),
        "lse_op": lambda: ops.flash_attention_lse(q, k, v, *args),
        "lse_direct": lambda: fa._forward_cuda(q, k, v, with_lse=True, **kw),
        "backward_op": lambda: ops.flash_attention_backward(
            q, k, v, o, lse, do, *args),
        "backward_direct": lambda: fa.flash_attention_backward_cuda(
            q, k, v, o, lse, do, **kw)}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            t = (time.perf_counter() - t0) / HOST_CALLS * 1e6
            torch.cuda.synchronize()
            best = t if best is None else min(best, t)
        out[name] = best
    return out


def phase_dryrun(torch, sharded: dict) -> dict:
    """Phase 20: the dry run against phase 19's real runs and on the
    production meshes, and CONFIG of earl_analytics on the card; printed
    with the card's name and power limit.  Kernel 12's host time a call
    (``host_us_per_call``) runs after it, outside the launch counts."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    dry = dryrun_checks(torch, sharded)
    t_dry = time.perf_counter() - t0
    analytics = analytics_checks(torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    info = dict(dryrun=dry, dryrun_s=t_dry, analytics=analytics, card=smi,
                phase_s=time.perf_counter() - t0)
    print("dryrun: " + json.dumps(info))
    for cell, rec in dry["production"].items():
        print(f"dry run {cell} ({smi}): dot FLOPs/chip "
              f"{rec['dot_flops_per_chip']:.4e}, collective bytes/chip "
              f"{json.dumps(rec['collective_bytes_per_chip'])}, state "
              f"bytes/chip {rec['state_bytes_per_chip']:.4e}, temp bytes "
              f"{rec['temp_bytes']:.4e}, {rec['lower_s']} s")
    print(f"phase 20 took {info['phase_s']:.1f} s")
    return info


def main() -> int:
    import torch
    if "--mesh-rank" in sys.argv:
        return mesh_rank(sys.argv)
    if "--shard-rank" in sys.argv:
        return shard_rank(sys.argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port (src/repro_torch) is not beside this "
              f"script: {e}", file=sys.stderr)
        return 2
    torch.manual_seed(0)

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(REPLACES)} kernels from {len(_build.SIGNATURES)} "
          f"sources in {time.perf_counter() - t0:.1f} s")
    for lib, log in sorted(logs.items()):
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "wgmma")):
                print(f"ptxas {lib}: {line.split(':', 1)[-1].strip()}")
    check_no_spills(logs.get("flash_attention", ""), "attention_tc")
    for kernel in ("attention_bwd", "attention_bwd_prep",
                   "attention_bwd_dkdv_tc", "attention_bwd_dkdv_wide",
                   "attention_bwd_dq_tc"):
        check_no_spills(logs.get("flash_attention_bwd", ""), kernel)
    check_no_spills(logs.get("fused_binblocked", ""), "binblocked_kernel")
    check_no_spills(logs.get("weighted_hist", ""), "hist_kernel")
    check_no_spills(logs.get("fused_pass", ""), "fused_pass_kernel")
    check_no_spills(logs.get("fused_grouped", ""), "grouped_hist_kernel")
    check_no_spills(logs.get("fused_grouped", ""), "keyed_index_kernel")
    check_no_spills(logs.get("fused_grouped", ""), "grouped_moments_kernel")
    check_no_spills(logs.get("fused_kmeans", ""), "fused_kmeans")
    for log in logs.values():
        PTXAS_REGISTERS.update(ptxas_registers(log))
    from repro_torch.kernels._pass import kmeans_geometry
    geo = kmeans_geometry(BIG_B, KM_BOOT_N, 512, KM_K, 2)
    km_regs = slot_registers("fused_kmeans_kernel", geo.rows, geo.dc)
    check(km_regs is None or km_regs <= 128, f"fused_kmeans_kernel<"
          f"{geo.rows}, {geo.dc}> uses {km_regs} registers, more than 128")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")

    def lap(phase):
        print(f"phase {phase} done at {time.perf_counter() - t0:.1f} s")

    parity = Parity()
    phase_parity(torch, parity)
    phase_parity_kmeans(torch, parity)
    phase_parity_grouped(torch, parity)
    phase_parity_materialized(torch, parity)
    phase_parity_stream(torch, parity)
    phase_parity_attention(torch, parity)
    lap("3 (parity)")
    launches, geometries, quickstart = phase_main_path(torch)
    lap("4 (quickstart path)")
    km_launches, km_geometries = phase_kmeans_path(torch)
    lap("5 (k-means path)")
    gb_launches, gb_geometries, gb_walls = phase_groupby_path(torch)
    lap("6 (GROUP BY path)")
    earlier = {k: launches[k] + km_launches[k] + gb_launches[k]
               for k in launches}
    check(all(earlier[k] == v for k, v in EARLIER_LAUNCHES.items()),
          f"the earlier paths launched {earlier}, expected "
          f"{EARLIER_LAUNCHES}")
    check(all(earlier[k] == v for k, v in EARLIER_LATER_LAUNCHES.items()),
          f"the earlier paths launched {earlier}, expected "
          f"{EARLIER_LATER_LAUNCHES} of kernels 10, 11, 5 and 7")
    mat_launches, mat_geometries = phase_materialized_path(torch)
    lap("7 (materialized path)")
    check(all(mat_launches[k] == MATERIALIZED_LAUNCHES.get(k, 0)
              for k in mat_launches), f"the materialized path launched "
          f"{mat_launches}, expected {MATERIALIZED_LAUNCHES}")
    st_launches, st_geometries = phase_stream_path(torch)
    lap("10 (streaming path)")
    sv_launches, sv_geometries, _ = phase_serve_path(torch)
    lap("11 (serving path)")
    gm_launches, gm_geometries, _ = phase_serve_gemma(torch)
    lap("12 (gemma3-27b serving path)")
    lv_launches, lv_geometries, _ = phase_live_path(torch)
    lap("13 (live path)")
    ms_launches, ms_geometries, _ = phase_mesh_path(torch)
    lap("14 (mesh path)")
    xa_launches, xa_geometries, _ = phase_serve_xattn(torch)
    lap("15 (cross-attention serving path)")
    mo_launches, mo_geometries, _ = phase_serve_moe(torch)
    lap("16 (MoE serving path)")
    rc_launches, rc_geometries, _ = phase_serve_recurrent(torch)
    lap("17 (recurrent serving path)")
    tr_launches, tr_geometries, tr_info, tr_halves = phase_train_path(
        torch, parity)
    lap("18 (training path)")
    sh_launches, sh_geometries, sh_info = phase_sharded_path(torch)
    lap("19 (sharded path)")
    zero_counts()
    with LaunchLog() as dr_log:
        phase_dryrun(torch, sh_info)
        dr_launches = LaunchLog.counts()
    print(f"kernel 12 host us a call ({smi}): "
          + json.dumps(host_us_per_call(torch)))
    lap("20 (dry run, earl_analytics)")
    launches = {k: earlier[k] + mat_launches[k] + st_launches[k]
                + sv_launches[k] + gm_launches[k] + lv_launches[k]
                + ms_launches.get(k, 0) + xa_launches[k] + mo_launches[k]
                + rc_launches[k] + tr_launches[k] + sh_launches[k]
                + dr_launches[k] for k in launches}
    print(f"launches, the three earlier paths: {json.dumps(earlier)}; all "
          f"paths: {json.dumps(launches)}; the training path's "
          f"{json.dumps(tr_launches)}")
    # phase 18's leg 3 CPU halves of card == CPU run in a thread beside the
    # replay, which times nothing: run inline they add about 80 s of host
    # to the script's clock
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = [pool.submit(half) for half in tr_halves]
        phase_replay(torch, {**geometries, **km_geometries, **gb_geometries,
                             **mat_geometries, **st_geometries,
                             **sv_geometries, **gm_geometries,
                             **lv_geometries, **ms_geometries,
                             **xa_geometries, **mo_geometries,
                             **rc_geometries, **tr_geometries,
                             **sh_geometries, **dr_log.geometries}, parity)
        t = time.perf_counter()
        for f in pending:
            f.result()
    print(f"phase 18 leg 3 card == CPU's CPU halves: "
          f"{time.perf_counter() - t:.1f} s waited after the replay")
    lap("8 (replay)")
    rows = phase_timing(torch, launches, parity, quickstart)
    rows += groupby_rows(torch, launches, parity, gb_walls)
    rows += materialized_rows(torch, launches, parity)
    rows += stream_rows(torch, launches, parity)
    rows += serve_rows(torch, launches, parity)
    rows[-1]["train_launches"] = tr_launches["flash_attention"]
    rows += backward_rows(torch, launches, parity,
                          tr_info["backward_parity"], tr_info["wide"])
    lap("9 (timing)")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
