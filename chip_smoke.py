#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths (retrieval padded,
packed and through ring attention; ranking padded and packed; eager and as
CUDA graphs; from interaction files on disk; with Muon and Scion; with
remat, async checkpoints, the profiler and the loggers) on one NVIDIA card
and check its kernels.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. The card's name and power limit (nvidia-smi), then the nvcc build of every
   kernel from csrc/ (one nvcc per source, all started together), with the
   build time and the -Xptxas -v summary.
2. Each kernel against its plain PyTorch version on the card, then both timed
   with CUDA events and set against the kernel's bound:
   - the attention forward at the serving shape (B=32, N=L=211, H=1, d=50,
     ragged lengths including 1 and 211, ml-1m-era timestamps) and at the
     ml-20m-hstu-long widths (B=4, N=L=1035, H=2, d=64), rtol 2e-4 / atol 2e-5,
     rows past the length exactly zero and the output bit for bit the same in
     a second call (no atomics touch it);
   - the attention backward against autograd of the plain version at the
     training shape (B=128, N=L=211, H=1, d=50, ragged) and at the wide shape:
     dq, dk, dv at rtol 2e-4 / atol 2e-5, d_pos_w and d_ts_w at rtol 5e-4
     (they sum ~N^2 terms per row, here with float atomics whose order changes
     from run to run), rows past the length exactly zero, and dq, dk, dv bit
     for bit the same in a second call (no atomics touch them);
   - both attention kernels with `seg_positions` (packed rows) at a row of
     ml-1m-hstu-packed (B=56, N=256, L=211, H=1, d=50) and at the widest row
     of ml-20m-hstu-long (B=4, N=1152, L=1035, H=2, d=64: wider than the bias
     table reaches), segments of mixed lengths including 1 and L, one row with
     trailing padding, the same tolerances; a gradient sent into one segment
     must leave dq, dk, dv of every other segment and row exactly zero, and a
     null `seg_positions` must give the bits of one segment per row; the
     backward also at B=4, N=1121 (not a multiple of its 32-row tile), L=1035,
     H=2, d=64, packed, with rows of packed length 1 and 20;
   - both attention kernels at the ranking shape R (B=128, N=L=422: two
     tokens, item and rating, a history position; N off the 64-key tile;
     each timestamp repeated for the two tokens of a pair; ragged even
     lengths), and packed at B=48, N=512, L=422 (rows of 256 doubled,
     segment positions doubled to (2p, 2p + 1)), with the checks and
     tolerances above;
   - the negative count at [26880, 128] into X=3,706, X=3,883 (the ml-1m
     catalog read from its files in phase 15) and X=26,744, with
     accidental hits and sentinels, exactly; at [37, 16] and [37, 300] into
     X=1, 15 and 17 (rows narrower than a 16-byte store or just wider); and
     at [26880, 256] into X=3,706 (int32 counts, one bin of 256), with the
     lse kernels on those counts;
   - the dense-negative lse forward and backward at [26880, 50] x [3706, 50]
     with those counts, tau 0.05, one all-hit row: lse, dq, dcat at rtol 2e-4
     / atol 2e-5, lse, dq and dcat against the dense plain version (autograd
     of it for the gradients), the forward's m_safe and s against the sparse
     plain forward (`dense_neg_lse_stats_sparse_plain`) and dq and dcat
     against the sparse plain backward (`dense_neg_lse_bwd_plain`, given the
     sparse plain forward's m_safe and s), the all-hit row's lse -inf and dq
     exactly zero, and lse and dq bit for bit the same in a second call (no
     atomics touch them); the forward's log gives the live logits and the
     rate at which it read the count; the same at [26880, 50] x [3883, 50]
     (phase 15's ml-1m catalog); the same
     over the ml-20m catalog, at [26880, 50] x [26744, 50] (the step of
     ml-20m-hstu), at [24552, 64] x [26744, 64] (the 1024-token class of a
     packed ml-20m-hstu-long step) and at [4297, 64] x [26744, 64] (its
     256-token class), where the dense plain version runs 2,048 rows at a
     time; and at [4096, 64] x [150, 64] with 255 draws a row, rows denser
     than the backward's list of 128 live logits, where each dcat entry sums
     thousands of terms (the kernel sums them in float64; dcat's bits in a
     second call are logged);
   - the same lse kernels with `sup_off` (`fused_dense_neg_lse`, each row's
     positive masked in the kernel) at [8192, 64] x [26744, 64], with the same
     checks, and an all -1 sup_off on the same count against the null pointer,
     lse and dq bit for bit;
   - the ring's chunk attention forward and backward against autograd of the
     plain version at ml-20m-hstu-long's widths (B=32, H=2, d=64, L=1035) on
     the zigzag ring's 130 x 130 chunks and the contiguous ring's 259 x 259,
     at the offsets the ring gives them (fully live, the diagonal, dead: all
     zeros), a partial one and padded rows past the bias table; neither
     kernel zero-fills anything or takes atomics on out, dq, dk, dv, so rows
     that no live pair reaches must come out exactly zero and a second call
     must give the same bits; each kernel's host time to queue a call.
3. The serving path at the full width of `synthetic-hstu`: `cli.serve.build_engine`
   on a .pt checkpoint written from a seeded init (its engine runs every
   program as a CUDA graph replay, serving/service.py), the HTTP server on
   an ephemeral port, a warm-up request (the retrieve graph's capture),
   /healthz, a 32-row /v1/retrieve, a burst of concurrent single-row
   requests through the coalescer, then rounds of timed 32-row requests
   alternated with the same call made on the engine directly (the
   difference is the HTTP + JSON cost). The launch counts are set to 0 just
   before and read just after: each engine call must launch the attention
   kernel once per HSTU block (a replay counts the launches its capture
   recorded). The same requests then go through an engine built with
   device="cpu" from the same checkpoint; the two must agree. An eager
   engine on the card over the same model (graphs=False) must give the
   graphed one's ids and scores bit for bit. Last, the eager and the graphed
   32-row engine call side by side: p50, and torch.profiler's device kernel
   time, launches and idle share.
3b. Generation over HTTP on the same graphed engine: /v1/generate with the
   32 rows at steps=11 (the whole output window) for greedy, sample
   (temperature 0.7, top_k 50, top_p 0.9, seed 3) and beam (4 beams), after
   a warm-up request of each (their captures); then ten rounds of the three
   with the counts set to 0 just before and read just after: num_blocks
   attention launches per generation call (the prefill; the decode steps
   are torch ops), replays only. Every id in the catalog, none from its
   row's history, none twice in a row; the same request gives the same ids
   every time; the eager engine's ids equal the graphed one's. Against the
   CPU engine: the prefill's query rows and the first decode step's output
   within E2E_ATOL, and the greedy ids equal up to the first step whose
   top-2 margin on the CPU is within E2E_ATOL. Then p50 and p99 of each mode
   over HTTP, and each mode's eager and graphed engine call side by side as
   in phase 3.
4. The training path at the full width of `synthetic-hstu` (batch 128, so
   26,880 supervision rows, 128 negatives, 3,706 catalog rows, dropout 0.2,
   fused AdamW): `cli.train.main` on the card for 30 epochs (480 optimizer
   steps, validation after each, then the test pass on the best checkpoint),
   the run of the JAX package's recipe validation (PARITY.md, "Recipe
   validation": test ndcg@10 0.037-0.039 on the same data). The preset's
   `trainer.steps_per_call=8` makes every step and eval batch a replay of a
   CUDA graph (train/graphs.py). The launch counts and the graphs' counts are
   set to 0 just before and read just after: every step and eval batch a
   replay, each replay counting the launches its capture recorded and each
   capture's warm-up runs their own; per optimizer step 2 attention
   forwards, 2 attention backwards, 1 count, 1 lse forward, 1 lse backward,
   and 2 attention forwards per eval batch. Every loss must be finite, the
   last five lower than the first five on average, the metrics in [0, 1] and
   the test ndcg@10 at least 0.03 (chance is 10 / 3706; torch's random
   streams are not JAX's, so the band itself is not asserted). Then a second
   trainer is stepped by hand, eagerly (steps_per_call=1's step) and graphed,
   side by side: step p50, per-step launch counts, device ms and idle share
   from torch.profiler, the graphs captured, and the graphed 8-step call.
5. One step on the card against the same step on the CPU: the same weights,
   batch and negative offsets, dropout off, through the port on `cuda`
   (kernels) and on `cpu` (plain versions): the loss at rtol 1e-5, every
   parameter's gradient at rtol 5e-4 / atol 1e-6.
6. The packed, long-sequence, wide-catalog training path at the full width of
   `ml-20m-hstu-long` on synthetic data (D=64, 8 blocks, H=2, L=1035, batches
   of 32 examples packed into rows of 256 / 512 / 1024 / 1152 tokens, 26,744
   catalog rows among ids up to 131,262, 128 negatives, dropout 0.2, AdamW):
   `cli.train.main` on the card for two epochs with the packed eval after
   each and the test pass on the best checkpoint, graphed (the preset's
   steps_per_call=8: one graph a class of capacity, whose row count is
   fixed). The launch counts are set to 0 just before and read just after,
   as in phase 4: per optimizer step 8 attention forwards, 8 backwards, 1
   count, 1 lse forward, 1 lse backward, and 8 forwards per eval batch.
   Losses finite and falling, metrics in [0, 1]. Then a second trainer is
   stepped by hand, class of capacity by class, eager and graphed side by
   side as in phase 4, with examples/s and tokens a step.
7. Phase 5 once more on one packed batch of capacity 256 of that
   configuration.
8. Ring (sequence-parallel) attention at the full width of ml-20m-hstu-long
   on synthetic data with padded rows: `cli.train.main` with
   model.encoder.sp_shards=4 and the zigzag layout, the 4 shards of the ring
   run in turn on the card, for two epochs over 1,024 users with validation
   after each and the test pass, graphed (steps_per_call=8). The launch counts
   are set to 0 just before and read just after, as in phase 4: per optimizer
   step 8 x 36 chunk forwards and as many backwards, 1 count, 1 lse forward,
   1 lse backward and no full attention kernel; 8 x 36 chunk forwards per
   eval batch. Then hand-stepped trainers in the zigzag and contiguous (8 x 10
   chunk calls) layouts, eager and graphed side by side as in phase 4, the
   eager step's profiled launches logged beside the expected 4,923 (zigzag)
   and 1,355 (contiguous); then zigzag eval batches, forward only, where the
   chunk forward runs alone, eager and graphed: 288 chunk forwards each.
9. The ring model, zigzag and contiguous, against the same weights at
   sp_shards=1 on the card: one full-width batch, the same negatives, dropout
   off, the loss at rtol 1e-5 and every gradient at rtol 5e-4 / atol 1e-6.
10. The graphed step against the eager step: two trainers of one
   configuration (the same weights, negatives and dropout streams, dropout
   on), steps_per_call=1 and 8, three steps each on one batch: the losses at
   rtol 1e-5, the parameters at rtol 5e-4 / atol 1e-6 (phase 5's). A padded
   synthetic-hstu batch, packed ml-20m-hstu-long batches of class 256 and
   1152, a zigzag ring batch, and a padded and a packed synthetic-rank batch.
11. The ranking task at the full width of `synthetic-rank` (the ml-1m-rank
   recipe on ratings drawn around each item's quality: D=50, 2 blocks, H=1,
   211 input positions interleaved into 422 item and rating tokens, 6 rating
   classes, batch 128, 2,048 users, dropout 0.2, AdamW): `cli.train.main` on
   the card for up to 30 epochs (early stopping on val/ap may end it
   sooner), validation after each and the test pass on the best checkpoint,
   graphed (steps_per_call=8). The launch counts are set to 0 just before
   and read just after: every step and eval batch a replay, per optimizer
   step 2 attention forwards and 2 backwards and no count or lse launch, 2
   forwards per eval batch. Losses finite and falling, metrics in [0, 1],
   test AUROC above 0.62 and precision above 0.25 (the JAX package's bars;
   chance 0.5 and about 0.2), precision equal to recall. Then a second
   trainer's train step and eval batch, eager and graphed side by side, as
   in phase 4.
12. Phase 5 for the ranking loss: one padded and one packed synthetic-rank
   batch (one capacity class of 256 tokens), card against CPU, the same
   tolerances.
13. `synthetic-large-vocab` at full width on one card, with the JAX package's
   one-chip overlay (model.embedding.kind=local, num_shards=1): 10,000,000
   items, D=64, 4 blocks, H=2, batch 64, N=211, 512 negatives, int8 index
   (phase 2 also checks rows 1-2 at this shape V: B=64, N=L=211, H=2, d=64).
   The data's build time; `cli.train.main` on the lazy overlay (shared
   negatives, the lazy row AdamW) for one epoch of 2,048 users (cut from
   4,096 for phase 24), graphed (steps_per_call=4: 32 steps, then
   validation and the test pass on the int8 index), its
   checkpoint (~7.7 GB: the model, mv and the AdamW state) in a temporary
   directory that is removed after, with the seconds of a save and the peak
   memory. Cut: the number of epochs (the preset allows 500). Launch counts
   as in phase 4: per optimizer step 4 attention forwards and 4 backwards,
   no count or lse; 4 forwards per eval batch. Then the trained checkpoint
   served with the int8 index: 32-row /v1/retrieve (k=200) over HTTP, ids
   in the catalog and none from the row's history, p50 and p99; greedy
   /v1/generate at steps=11 (sample mode's Gumbel buffer would be 14 GB and
   is not driven); the graphed engine bit for bit against the eager one;
   the int8 pre-rank with its exact re-score against the exact scan on the
   same 32 queries: recall >= 0.95 (the JAX package's bar) and the scores
   the exact inner products (rtol 1e-5) where the ids agree. Last, trainers
   stepped by hand, eager and graphed side by side as in phase 4: (a) the
   gather loss with dense fused AdamW, (b') shared negatives with dense
   fused AdamW, (b) shared negatives with the lazy update; each with its
   build time, peak memory and the optimizer's share of the eager step's
   device time, and for (a) and (b') the fused AdamW kernels' time against
   the table's 17.9 GB of traffic a step.
14. Phase 5 for (a) and (b) at X=10M: one step on the card and on the CPU
   from the same weights, batch and negatives, dropout off: (a) on 8 rows
   of the batch (cut from 64 to 16 for phase 24, to 8 for its (d)), on the loss
   (rtol 1e-5) and every gradient (rtol 5e-4 / atol 1e-6), (b) on mv, the
   count and every parameter but the table after the step, at the same
   tolerances, and the table on each device against the AdamW step of its
   own moments in float64 (card against CPU directly, Adam's first step
   lr * g / (|g| + eps) would turn the float32 difference of a gradient near
   eps into up to lr / 4 of it; the largest such difference is logged),
   untouched rows bit for bit. Then
   phase 10's check for (a) and (b): three graphed steps against three
   eager ones on one batch with the same negatives; for (b) the rows no step
   touched are bit for bit unchanged and their moments zero.

15. Files on disk (ml-1m-hstu at its full width and size). A
   `movielens_ml-1m.zip` in MovieLens 1M's own format (`::`, latin-1:
   ratings.dat, movies.dat, users.dat) at its published counts: 6,040 users,
   3,883 listed movies of which 3,706 are rated, ids up to 3,952, titles with
   commas, latin-1 letters, quotes and none with no year; the ratings are the
   port's synthetic generator at 6,040 users. `cli.prepare_data` in a
   process of its own, then the native parser's train and test splits equal,
   array for array and bit for bit, to the plain parser's and to the
   in-memory generator's for the same draw (both parse times logged), and
   the catalog movies.csv's 3,883 ids with max id 3,952. `cli.train` for 30
   epochs at the preset's width (D=50, 2 blocks, H=1, N=211, batch 128, 128
   negatives, steps_per_call=8, graphed; min_epochs=30, so early stopping
   cannot end it sooner): launch counts as in phase 4 (the count and lse
   kernels at X=3,883), losses finite and falling. `cli.eval` and
   `cli.predict` from best.pt: one predictions.csv row per user, ids in the
   catalog, equal to an eager eval step's top-k on the same checkpoint up to
   near-ties (atol 1e-5). A Lightning-style `.ckpt` written from best.pt
   (`state_dict` under `model.`, epoch, hyper_parameters), `cli.convert_ckpt`,
   then `cli.eval` on the converted `.pt` and on the `.ckpt` itself: the
   metrics of best.pt bit for bit. Then at cut depth, each at its preset's
   full width: ml-20m-hstu-long from an ml-20m-format zip (the synthetic
   draw of 1,024 users, cut from 2,048 for phase 24, written as ratings.csv
   with float ratings, a third of them x.5), prepare, one packed graphed
   epoch; amzn-books from a ratings_Books.csv (string ASINs, power-law
   popularity, 10,000 users, cut from 20,000 for phase 24),
   prepare at min_count 5, one epoch (packing, the lazy update, shared
   negatives, packed eval); finite losses, and their timings.

16. Muon and Scion (the two-optimizer split: AdamW on the embeddings and
   vectors, Muon or Scion with bfloat16 Newton-Schulz on the encoder's
   matrices, each learning rate with its plateau controller) at ml-1m-hstu's
   width on phase 15's files: `cli.train` for 3 graphed epochs (SPLIT_EPOCHS:
   cut from 30 to 10 for phase 22, to 3 for phase 23) of ml-1m-hstu-muon and
   of ml-1m-hstu-scion (min_epochs=3), launch counts as
   in phase 4, losses finite and falling, best.pt and last.pt written, test
   ndcg@10 at least 0.030 (about 80% of the JAX package's 0.0367; its 0.0376
   and 0.0367 are from a TPU v5e on synthetic ml-1m-shaped data), printed
   beside phase 15's AdamW run. Then the train step of ml-1m-hstu, -muon and
   -scion, eager and graphed side by side as in phase 4, with the
   optimizer's device ms and share; phase 10's check of one graphed step
   against one eager one for both presets (from the second step on the
   attention backward's float atomics differ from run to run, and bfloat16
   NS-5 turns that noise into ulps of the update: two eager runs of three
   steps are logged side by side to show it); and two steps of each on the
   card and on the CPU, the same weights, batch and negatives, each
   optimizer given the CPU's gradients: the AdamW part at phase 5's
   gradient tolerance, each Muon / Scion matrix within 0.15 of its own
   movement (the band the CPU tests hold the port to JAX with).

17. The aux preprocessor, SASRec, the in-batch sampler and BCE at
   ml-1m-hstu's width on phase 15's files (users.dat with ml-1m's sexes, age
   groups, occupations and 3,439 zip strings feeds the aux token):
   `cli.train` for 3 graphed epochs (CUT_EPOCHS: cut from 30 to 10 for
   phase 22, to 3 for phase 23) of ml-1m-hstu-aux, ml-1m-sasrec and ml-1m-hstu with
   `model.sampler.kind=in_batch`, and one of ml-1m-hstu with
   `model.loss.kind=bce`; launch counts as in phase 4 (SASRec launches no
   attention kernel, in-batch and BCE no count or lse: they take the gather
   loss), losses finite and falling, best.pt and last.pt written, test
   ndcg@10 at least 0.030 for the three longer runs, printed beside the
   JAX package's bars (TPU v5e numbers) and phase 15's ml-1m-hstu. Then the
   three train steps eager and graphed side by side as in phase 4; phase
   10's check of three graphed steps against three eager ones for each;
   phase 5's check of one step on the card against the CPU for each (the
   same catalog offsets, or the in-batch sampler's uniforms); and
   `/v1/retrieve` on the 30-epoch SASRec model: the graphed engine's top-k
   against a CPU engine's on the same weights over a 32-row request and 8
   single rows, and the engine call's p50, eager and graphed.

18. The other model families at ml-1m-hstu's width on phase 15's files
   (movies.dat's titles carry the years): `cli.train` for 3 graphed epochs
   (CUT_EPOCHS) of ml-1m-hstu with
   `model.embedding.kind=item_year` (the fork's own
   model: 25 + 25 columns) and for 6 (MOL_EPOCHS: cut from 30 to 15, then
   to 10 for phase 23 and to 6 for phase 24) with `model.similarity.kind=mol` (P = Q = 4,
   dd = 16, per-group L2, temperature 0.05; the gather loss), one epoch each
   of `model.postprocessor.kind=layer_norm`,
   `model.encoder.normalization=softmax_rel_bias` and ml-1m-sasrec with
   Muon on its encoder; launch counts as in phase 4 (MoL launches no count
   or lse, softmax_rel_bias and SASRec no attention kernel), losses finite
   and falling, best.pt and last.pt written, test ndcg@10 at least 0.030 for
   those two runs beside phase 15's ml-1m-hstu: the item_year run's
   from the eval step, the MoL run's with the catalog ranked by MoL itself
   on its last weights (`mol_scored_test`), printed beside the eval step's
   dot-product ranking, which is JAX's eval for an MoL model. The item_year run's
   best weights go into a fork-layout Lightning `.ckpt` (the year table at
   the fork's num_items + 1 rows and its item -> year buffer), which
   `cli.eval` reads to the run's own test metrics. Then the item_year and
   MoL train steps eager and graphed side by side as in phase 4, phase 10's
   check of three graphed steps against three eager ones, and phase 5's
   check of one step on the card against the CPU, for both.

19. The training variants. Per-block remat at the full width of
   ml-20m-hstu-long (phase 6's hand-stepped configuration: D=64, 8 blocks,
   H=2, L=1035, packed classes 256-1152, dropout 0.2): for each class a
   trainer without and one with `model.encoder.remat=true` (the same seed)
   take their first graphed step on the same batch from one dropout seed,
   and the remat step's loss and every gradient must equal the other's at
   rtol 1e-5 / atol 1e-6 (the largest difference logged), with the peak
   memory allocated over that first call (the warm-up runs and the
   capture: a replay allocates nothing); then each class's graphed step,
   remat off against on: p50, device ms and launches (remat runs 16
   attention forwards a step, 8 without). The same check on one zigzag ring
   step (sp_shards=4, 1,024 users; 576 chunk forwards a step with remat).
   Then `cli.train` of ml-1m-hstu on phase 15's files for 3 graphed epochs
   (CUT_EPOCHS: cut from 30 for phase 24) with remat (launch counts as in
   phase 4, the forwards doubled; test ndcg@10 at least 0.030) and without it at
   `trainer.seed` 1 for 3 epochs (CUT_EPOCHS; seed 2's run cut for phase
   23; at least 0.030), printed beside phase 15's run.
   At 10M items (phase 13's one-card lazy overlay, after two graphed steps):
   a synchronous save and two async ones of the same state, the seconds the
   caller is blocked and until each file has landed, both files read back
   and equal tensor for tensor. Last, ml-1m-hstu for one epoch each with
   `trainer.profiler=true` (the trace must name the attention, count and
   lse kernels), with `trainer.mlflow_dir` (its metric files hold every row
   of metrics.jsonl) and `trainer.tensorboard=true` (its scalars written,
   or the named ValueError where neither package imports; the log says
   which), and a 2-point `cli.sweep` over optimizer1.lr (its
   sweep_results.csv printed).
20. The last one-card gaps, on phase 15's ml-1m files. First the wide
   kernels' registers (-Xptxas -v) and shared memory at widths 130, 192 and
   256, and rows 1, 2, 4 and 5 at width 256 (rows 4-5 also at 192) against
   their plain versions with the phase 2 checks, timed beside their bounds.
   (a) `cli.train` of ml-1m-hstu with `model.compute_dtype=bfloat16` for 3
   graphed epochs (CUT_EPOCHS; launch
   counts as in phase 4; test ndcg@10 at least 0.030,
   printed beside phase 15's float32 run), its train step eager and graphed
   side by side, and phase 5's check of one step on the card against the
   CPU (bfloat16 flips counted, BF16_FLIP_SHARE). (b) ml-1m-hstu with
   `model.item_embedding_dim=256` (one 256-wide head): `cli.train` for one
   graphed epoch with its eval pass and test (launch counts as in phase 4,
   rows 1, 2, 4 and 5 launched at width 256), the step eager and graphed
   side by side, phase 10's and phase 5's checks, and `/v1/retrieve` from
   its best.pt against the CPU engine. (c) `/v1/retrieve` on phase 3's
   weights with `index.approx_top_k_recall=0.95`: ids and scores equal to
   the exact engine's. (d) a competition-style CSV (user_id,
   sequence_item_ids, sequence_timestamps, sequence_ratings) written from
   phase 15's draw, through `DynamicSequenceDataset` into two epochs of
   graphed ml-1m-hstu steps: losses finite and falling.
21. The ring's wide chunk kernels and the sharded embedding kinds (their
   shards run in turn on the card), after phase 20. (a) The wide chunk
   kernels' registers and shared memory at widths 130, 192 and 256, rows
   9-10 at width 256 against their plain versions (phase 2's checks) on the
   live 130 x 130 chunk and the 259 x 259 fully live one, timed beside their
   bounds. (b) ml-20m-hstu-long's ring at two 256-wide heads, zigzag and
   contiguous: one step on the card against the CPU on 1 row (2 before
   phase 24 (d)), one graphed
   step against one eager one, the step eager and graphed side by side.
   (c) On phase 15's ml-1m files: `cli.train` of sharded_a2a (8 shards) for
   3 graphed epochs (CUT_EPOCHS: cut from 30 for phase 24) with its eval on
   the sharded top-k (test ndcg@10 at least 0.030, beside phase 15's local
   run); sharded_local,
   sharded_a2a, sharded_2d (8 x 2) and sharded_column (2) each: the step
   eager and graphed beside the local table's, phase 10's and phase 5's
   checks. (d) synthetic-large-vocab as shipped (sharded_a2a, 8 shards, the
   sharded int8 index): `cli.train` for one graphed epoch, `/v1/retrieve`
   from its best.pt (the run cut to 1,024 users), the exact sharded top-k
   against `mips_top_k`, the int8
   sharded recall (at least 0.95, beside phase 13's), the step's peak memory
   and device ms beside phase 13's overlay. (e) synthetic-large-vocab-100m's
   2-D table at 10M items (cut from 100M): two graphed steps, and one step on
   the card against the CPU (8 rows; 16 before phase 24 (d)); amzn-books-sharded on phase
   15's amzn-books files for one graphed epoch, beside phase 15's run.

22. Data parallel over processes (`trainer.distributed`,
   parallel/process_group.py), after phase 21. The card's machine has one
   card, so no number here is a multi-card time. (a) The production form in
   this process: NCCL at world size 1, the step's two all-reduces (the
   global weight sum, and the flat gradient buffer with the loss) captured
   in its CUDA graph; for synthetic-hstu and for ml-20m-hstu-long's
   class-1152 packed step, 8 graphed steps with the trainer against the same
   steps of two one-process trainers from the same seed and batches. Checked:
   the first step's gradients and the parameters after it within rtol 1e-6 /
   atol 0 of the first one-process run's (one rank's sum is an identity),
   but for the bias tables, whose float atomics add in an order that changes
   from run to run (their gradients at rtol 5e-4); the losses of the 8 steps
   at rtol 1e-5; the two all-reduces issued while the step's graph was being
   captured (on the weight sum and on the flat gradient buffer, seen at
   torch.distributed's call), none issued from the host in a profiled
   replay, and the port's count of 2 a step; and an out-of-place NCCL
   all-gather captured in a graph of its own, whose replay must copy.
   Logged, not checked: the parameters after the 8 steps beside the gap of
   the two one-process runs (the bias tables' atomics part both pairs from
   the first step on). At world size 1 NCCL issues nothing for the step's
   in-place sums, so a capture of NCCL over more than one rank is not
   shown. The graphed step's p50, device ms, launches and idle share beside
   the one-process trainer's. (b) Two processes of this
   script share cuda:0 over gloo, eagerly, on synthetic-hstu
   (2,001 users, padded) and ml-1m-hstu-packed (synthetic): one step over a
   global batch whose halves have different tails, dropout off, the
   offsets handed in, equal to the one-process step over that batch (loss at
   rtol 1e-5, every gradient and parameter at rtol 2e-4 / atol 2e-5); then
   two epochs of `fit` on each rank: finite losses, and both ranks' val
   metrics and losses equal to the bit. A rank that fails fails the phase.
23. The "model" axis (parallel/tensor_parallel.py, `ProcessGroupShards`),
   after phase 22, on synthetic-large-vocab's model at full width with
   sharded_a2a over 2 shards and `encoder.tp_shards=2`, the catalog cut to
   1M items and the users to 512 (`MP_ARGS`). (a) The one-card TP form in
   this process: phase 5's check (the eager loss and every gradient on the
   card against the CPU, 16 rows), phase 10's check (three graphed steps
   against three eager ones), and the step eager and graphed side by side
   (launches as in phase 4: 4 attention forwards and backwards, no count or
   lse: the gather loss). (b) Two processes of this script
   share cuda:0 over gloo, eagerly, as one model group (gloo stages every
   collective through host memory: a step at 64 rows takes ~8 s): the step
   over the group on the last batch of 500 users (52 of its 64 rows with a
   target), dropout off, the offsets handed in, against the one-process
   step on the same weights (loss at rtol 1e-5; every gradient and
   parameter in the one-process layout at rtol 2e-4 / atol 2e-5, the bias
   tables' gradients at 5e-4), its time (one timed step, the first of its
   trainer; gloo, two processes on one card, not a multi-card time);
   one epoch of `fit` on 32 users (cut from 512) in batches of 16 with the
   int8 sharded index: both ranks' val metrics and
   losses equal to the bit, the replicated leaves bit-equal across the
   ranks, and the checkpoint (the one-process layout) loaded in this
   process giving the same val metrics within 1e-6; and JAX's
   packed_sharded recipe on ml-1m-hstu-packed (synthetic, 512 users) for
   two epochs: both ranks equal, the packed eval equal to the unpacked one
   within 1e-6. A rank that fails fails the phase.
24. The ring over a process group (`encoder.sp_shards` on the mesh's sp
   axis, parallel/ring_attention.py: `ProcessGroupRing`), after phase 23,
   on ml-20m-hstu-long at full width (D=64, 8 blocks, H=2, N=1,035 padded to
   1,036, batch 32, 26,744 items, synthetic, padded rows) with
   `sp_shards=2`. In this process, for zigzag and contiguous: one step of
   the one-process ring (`OneDeviceRing`, its two shards in turn on the
   card) on the first train batch of 64 users, dropout off, the offsets
   handed in, timed with its peak memory. Two processes of this script
   share cuda:0 over gloo, eagerly, as one sp group, each rank holding
   its rows of the sequence from the block stack's entry to its exit: (a)
   each layout's step on the same batch, weights and offsets against the
   one-process step (loss at rtol 1e-5, every gradient and parameter at
   rtol 2e-4 / atol 2e-5, the bias tables' gradients at 5e-4), each rank's
   launches those of its body (zigzag 5 chunk forwards and backwards a
   block on each rank; contiguous 1 on rank 0 and 2 on rank 1; one count
   and one lse pair a step), 3 collectives a block and 2 a step over the
   sp group, and each rank's peak memory over what it held below the
   one-process ring's; (b) one epoch of `fit` of the zigzag ring on 96 users
   (cut from the preset's 2,048) with its val eval and the test pass: both
   ranks' metrics and losses equal to the bit, the replicated leaves
   bit-equal, and the checkpoint loaded in this process (the one-process
   ring) giving the same val metrics within 1e-6; (c) each rank's step
   time (one timed step, the first of its trainer) and peak memory beside
   the one-process ring's (gloo, two processes on one card, not a
   multi-card time); (d) four more processes of this script (`--ranks4`,
   started with the two, their trainers built while the two run) share the
   card over gloo as model 2 x sp 2 with `tp_shards=2`, each model rank on
   one of the two heads, after the two: one zigzag step
   on (a)'s batch and offsets against the one-process zigzag ring step (TP
   changes no value), each rank's chunk calls on one head and its launches
   those of its sp rank's body, 9 collectives a block and 2 a step. Phases
   22 (b), 23 (b) and 24 (a)-(c) run in one launch of the two rank
   processes (`--ranks`): one start-up for the three.

It ends with one JSON line of the kernels' numbers and, last, the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import collections
import gc
import json
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
OUT_DIR = HERE / "build" / "chip_smoke"
# seconds of the phases' parts that the summary at the end reads, and of
# each stretch of `main` between two `lap` calls
PHASE_S: dict = {}
LAPS: dict = {}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 non-tensor FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
RTOL, ATOL = 2e-4, 2e-5  # kernel vs plain: fp32 sums in another order
BIAS_RTOL = 5e-4  # bias-table gradients: ~N^2 terms per entry, atomics in any order
# one step on the card vs on the CPU: loss and per-parameter gradients. The
# gradients sum float32 terms over 26,880 supervision rows in different orders
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-5, 5e-4, 1e-6
TRAIN_BT, TRAIN_R = 128 * 210, 128  # supervision rows and negatives of synthetic-hstu
# 30 epochs of synthetic-hstu: the JAX package lands at test ndcg@10
# 0.037-0.039; chance is 10 / 3706 = 0.0027. Below this the training is broken
MIN_TEST_NDCG10 = 0.03
# model.compute_dtype=bfloat16: two runs whose float32 sums differ in their
# last bits can round a bfloat16 cotangent to neighbouring values; a gradient
# element that took such a flip is off by up to 2^-8 of its tensor's largest
# entry, and at most this share of them may (tests/test_torch_port_mixed_precision.py)
BF16_FLIP_SHARE = 1e-3
# card vs CPU engine: L2-normalized fp32 scores (|s| <= 1) through two blocks,
# summed in different orders on the two devices
E2E_ATOL = 1e-4


def lap(name: str) -> None:
    """Record the seconds since the last lap (or the start) under `name`."""
    now = time.perf_counter()
    LAPS[name] = now - LAPS.pop("_last", now)
    LAPS["_last"] = now


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def build_kernels(_build, names) -> dict:
    """Builds the sources; -> nvcc's output of each."""
    built = _build.build(names)
    for name, res in built.items():
        log(f"built {name} in {res.seconds:.2f} s -> {res.path.name}")
        for line in res.log.splitlines():
            if "ptxas" in line or "reused" in line:
                log(f"  {line.strip()}")
    return {name: res.log for name, res in built.items()}


# ---------------------------------------------------------------- phase 2


def packed_layout(seed, b, n, max_seg):
    """Within-segment positions [b, n] and packed lengths [b] of rows that hold
    segments of mixed lengths end to end. Row 0 keeps a fifth of the row as
    trailing padding (positions 0 there, as the loader leaves them); row 1
    starts with a segment of 1 and one of max_seg (or what the row has left)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((b, n), dtype=np.int32)
    lengths, bounds = [], []
    for r in range(b):
        room = n - (n // 5 if r == 0 else 0)
        segs = [1, min(max_seg, room - 1)] if r == 1 else []
        while sum(segs) < room:
            segs.append(int(min(rng.integers(1, max_seg + 1), room - sum(segs))))
        at, row_bounds = 0, []
        for seg in segs:
            pos[r, at : at + seg] = np.arange(seg)
            row_bounds.append((at, at + seg))
            at += seg
        lengths.append(at)
        bounds.append(row_bounds)
    return pos, lengths, bounds


def attention_inputs(seed, b, n, h, d, lengths, proj_grad: bool = False, max_len=None,
                     seg=None, paired=False):
    """q, k, v as column slices of one uvqk projection `proj`, as the block
    gives them; with proj_grad, proj is a leaf that takes their gradients and
    is returned beside the inputs. `max_len` (default n) sizes pos_w; `seg`
    [b, n] are the within-segment positions of packed rows; `paired` repeats
    each timestamp for two adjacent tokens, as the ranking task's interleaved
    item and rating tokens have them (a zero gap between the two)."""
    rng = np.random.default_rng(seed)
    max_len = max_len or n
    proj = torch.tensor(rng.normal(size=(b, n, 4 * h * d)), dtype=torch.float32).cuda()
    proj.requires_grad_(proj_grad)
    _, v, q, k = torch.split(proj, [h * d] * 4, dim=-1)
    ts = np.sort(978_000_000 + rng.integers(0, 3 * 365 * 86400, size=(b, n)), axis=1)
    if paired:
        ts = np.repeat(ts[:, : (n + 1) // 2], 2, axis=1)[:, :n]
    inputs = dict(
        q=q.unflatten(-1, (h, d)), k=k.unflatten(-1, (h, d)), v=v.unflatten(-1, (h, d)),
        timestamps=torch.tensor(ts, dtype=torch.int32).cuda(),
        pos_w=torch.tensor(rng.normal(size=(2 * max_len - 1,)) * 0.02, dtype=torch.float32).cuda(),
        ts_w=torch.tensor(rng.normal(size=(129,)) * 0.02, dtype=torch.float32).cuda(),
        max_len=max_len, num_buckets=128,
        lengths=torch.tensor(lengths, dtype=torch.int32).cuda(),
    )
    if seg is not None:
        inputs["seg_positions"] = torch.tensor(seg, dtype=torch.int32).cuda()
    return (inputs, proj) if proj_grad else inputs


def device_ms(fn, reps: int) -> float:
    """Device time per call: a sleep kernel holds the stream while the host
    queues all `reps` calls, so the events time them back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s at H100 clocks
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least ms the card could take: bytes at peak bandwidth or fp32
    operations at the peak non-tensor rate, whichever is longer."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def within(got, want, rtol: float, atol: float) -> tuple[bool, float]:
    diff = (got - want).detach().abs()
    return bool((diff <= atol + rtol * want.detach().abs()).all()), float(diff.max())


def attention_work(a) -> tuple[int, int, int, int]:
    """(valid rows, timestamps read, table entries read, live pairs) of this
    call's lengths and segments. A valid row sees the keys from its segment's
    start on: position + 1 of them, the position being the row index in an
    unpacked row. In a packed row the positions are read too."""
    b, n = a["q"].shape[:2]
    seq = torch.clamp(a["lengths"].cpu().long(), max=n)
    rows = int(seq.sum())
    stamps = int(torch.clamp(seq + 1, max=n).sum())
    idx = torch.arange(n)
    valid = idx[None, :] < seq[:, None]
    seg = a.get("seg_positions")
    pos = idx[None, :].expand(b, n) if seg is None else seg.cpu().long()
    pairs = int((pos + 1)[valid].sum())
    small = b + int(pos[valid].max()) + 1 + a["ts_w"].numel() + (0 if seg is None else rows)
    return rows, stamps, small, pairs


def attention_bound(a) -> tuple[float, str]:
    """Least time for this call: the bytes it must move at peak bandwidth vs
    the multiply-adds of q.k and p.v over the live pairs at peak fp32, both
    for this call's lengths and segments. Reads: q, k, v and the timestamps of
    the valid rows only (row m < len, and the next-item stamp of the last
    one), the lengths, the pos_w entries the live offsets reach and all of
    ts_w; writes: the whole output, zeros past the length included."""
    b, n, h, dqk = a["q"].shape
    dv = a["v"].shape[-1]
    rows, stamps, small, pairs = attention_work(a)
    reads = rows * h * (2 * dqk + dv) + stamps + small
    return bound(4 * (reads + b * n * h * dv), pairs * h * 2 * (dqk + dv))


def check_attention(kern, name, seed, b, n, h, d, lengths, max_len=None, seg=None,
                    paired=False) -> dict:
    a = attention_inputs(seed, b, n, h, d, lengths, max_len=max_len, seg=seg, paired=paired)
    got = kern.hstu_attention_fused(**a)
    want = kern.hstu_attention_fused_plain(**a)
    # each output row is written once by the block that owns it, without
    # atomics: a second call gives the same bits
    same = torch.equal(got, kern.hstu_attention_fused(**a))
    torch.cuda.synchronize()
    diff = (got - want).abs()
    max_abs = float(diff.max())
    big = want.abs() > 1e-3
    max_rel = float((diff[big] / want.abs()[big]).max()) if bool(big.any()) else 0.0
    ok = bool((diff <= ATOL + RTOL * want.abs()).all())
    dead = all(not bool(got[i, length:].any()) for i, length in enumerate(lengths))
    shape = (f"B={b} N={n} L={a['max_len']} H={h} d={d}" + (" packed" if seg is not None else "")
             + (" paired timestamps" if paired else ""))
    log(f"{name} {shape}: max_abs_err={max_abs:.3e} "
        f"max_rel_err={max_rel:.3e} (|want|>1e-3), within rtol {RTOL} atol {ATOL}: {ok}, "
        f"rows past length zero: {dead}, bit-identical in a second call: {same}")
    check(ok and dead, f"{name} disagrees with its plain version at {shape}")
    check(same, f"{name}: the output changed between two calls at {shape}")
    if seg is None:
        # one segment per row is an unpacked row: the null pointer and the
        # positions 0..n-1 must give the same bits
        whole = torch.arange(n, dtype=torch.int32, device="cuda").expand(b, n).contiguous()
        same = torch.equal(got, kern.hstu_attention_fused(**a, seg_positions=whole))
        log(f"  null seg_positions equals one segment per row bit for bit: {same}")
        check(same, f"{name}: the unpacked call differs from one segment per row")
    ms = device_ms(lambda: kern.hstu_attention_fused(**a), 200)
    plain_ms = device_ms(lambda: kern.hstu_attention_fused_plain(**a), 30)
    bound_ms, bound_by = attention_bound(a)
    log(f"  kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def attention_bwd_bound(a) -> tuple[float, str]:
    """As attention_bound, for the backward: it reads the valid rows of q, k,
    v and g, and writes dq, dk, dv whole and both table gradients; per live
    pair and head it does q.k, g.v, dz k, dz q and p g."""
    b, n, h, dqk = a["q"].shape
    dv = a["v"].shape[-1]
    rows, stamps, small, pairs = attention_work(a)
    reads = rows * h * (2 * dqk + 2 * dv) + stamps + small
    writes = b * n * h * (2 * dqk + dv) + a["pos_w"].numel() + a["ts_w"].numel()
    return bound(4 * (reads + writes), pairs * h * 2 * (3 * dqk + 2 * dv))


def check_attention_bwd(kern, seed, b, n, h, d, lengths, max_len=None, seg=None,
                        bounds=None, paired=False) -> dict:
    """`bounds[r]` lists the (start, end) of row r's segments, for the check
    that no gradient crosses a segment's edge."""
    a, proj = attention_inputs(seed, b, n, h, d, lengths, proj_grad=True, max_len=max_len,
                               seg=seg, paired=paired)
    a["pos_w"].requires_grad_(), a["ts_w"].requires_grad_()
    leaves = [proj, a["pos_w"], a["ts_w"]]
    rng = np.random.default_rng(seed + 100)
    # a non-contiguous upstream gradient: the wrapper makes it contiguous
    g = torch.tensor(rng.normal(size=(b, h, n, d)), dtype=torch.float32).cuda().transpose(1, 2)

    def split(grads):
        # dq, dk, dv arrive as the column slices of proj's gradient (u's is zero)
        du, dv, dq, dk = torch.split(grads[0], [h * d] * 4, dim=-1)
        check(not bool(du.any()), "a gradient reached the u columns")
        return dq, dk, dv, grads[1], grads[2]

    out = kern.hstu_attention_fused(**a)
    got = split(torch.autograd.grad(out, leaves, g, retain_graph=True))
    again = split(torch.autograd.grad(out, leaves, g, retain_graph=True))
    same = all(torch.equal(x, y) for x, y in zip(got[:3], again[:3]))
    out_plain = kern.hstu_attention_fused_plain(**a)
    want = split(torch.autograd.grad(out_plain, leaves, g, retain_graph=True))
    torch.cuda.synchronize()
    ok, errs = True, []
    for i, name in enumerate(("dq", "dk", "dv", "d_pos_w", "d_ts_w")):
        good, err = within(got[i], want[i], BIAS_RTOL if i >= 3 else RTOL, ATOL)
        ok = ok and good
        errs.append(f"{name} {err:.3e}")
    dead = all(
        not bool(t[i, length:].any()) for t in got[:3] for i, length in enumerate(lengths)
    )
    shape = (f"B={b} N={n} L={a['max_len']} H={h} d={d}" + (" packed" if seg is not None else "")
             + (" paired timestamps" if paired else ""))
    log(f"{kern.KERNEL_BWD} {shape}: max_abs_err " + ", ".join(errs)
        + f"; within rtol {RTOL} (tables {BIAS_RTOL}) atol {ATOL}: {ok}, "
        f"rows past length zero: {dead}, dq, dk, dv bit-identical in a second call: {same}")
    check(ok and dead, f"{kern.KERNEL_BWD} disagrees with autograd of its plain version "
          f"at {shape}")
    check(same, f"{kern.KERNEL_BWD}: dq, dk, dv changed between two calls at {shape}")
    if bounds is not None:
        # an upstream gradient on one segment alone (row 1's second) must leave
        # dq, dk and dv of every other row and segment exactly zero
        lo, hi = bounds[1][1]
        inside = torch.zeros((b, n, 1, 1), dtype=torch.bool, device="cuda")
        inside[1, lo:hi] = True
        one = split(torch.autograd.grad(out, leaves, torch.where(inside, g, 0.0),
                                        retain_graph=True))
        crossed = any(bool(torch.where(inside.flatten(2), 0.0, t).any()) for t in one[:3])
        reached = all(bool(t[1, lo:hi].any()) for t in one[:3])
        log(f"  gradient sent into row 1 [{lo}, {hi}) alone: reaches it: {reached}, "
            f"dq, dk, dv exactly zero everywhere else: {not crossed}")
        check(reached and not crossed, f"{kern.KERNEL_BWD}: a gradient crossed a segment's edge")
    ms = device_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 50)
    plain_ms = device_ms(
        lambda: torch.autograd.grad(out_plain, leaves, g, retain_graph=True), 5
    )
    bound_ms, bound_by = attention_bwd_bound(a)
    log(f"  kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return dict(max_abs_err=max(float((x - y).detach().abs().max()) for x, y in zip(got, want)),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def negative_draws(seed, bt, r, x):
    """[bt, r] offsets and [bt] positives: some draws equal to the positive,
    one all-hit row (row 5), the last 100 rows half sentinels."""
    rng = np.random.default_rng(seed)
    offsets = rng.integers(0, x, size=(bt, r)).astype(np.int32)
    positive = rng.integers(-1, x, size=bt).astype(np.int32)
    offsets[::7, :5] = positive[::7, None]
    positive[5] = 11
    offsets[5, :] = 11
    offsets[-100:, r // 2 :] = x + 5
    if r > 255:  # a bin past a byte: every draw of row 6 on one item
        positive[6] = -1
        offsets[6, :] = 13
    return torch.tensor(offsets).cuda(), torch.tensor(positive).cuda()


def check_count(kern, bt, r, x) -> dict:
    offsets, positive = negative_draws(x, bt, r, x)
    got = kern.count_offsets(offsets, positive, x)
    want = kern.count_offsets_plain(offsets, positive, x)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    hits = int((offsets == positive[:, None]).sum())
    log(f"{kern.KERNEL} [{bt}, {r}] into X={x}: {got.dtype} counts equal to plain: {equal} "
        f"({int(got.sum())} draws counted, {hits} accidental hits and "
        f"{int((offsets >= x).sum())} sentinels dropped, largest bin {int(got.max())})")
    check(equal, f"{kern.KERNEL} disagrees with its plain version at X={x}")
    check(not bool(got[5].any()), "the all-hit row has a count")
    check(got.dtype == (torch.uint8 if r <= 255 else torch.int32),
          f"{r} draws a row gave {got.dtype} counts")
    check(r <= 255 or int(got[6, 13]) == r, "a bin past a byte was not counted whole")
    ms = device_ms(lambda: kern.count_offsets(offsets, positive, x), 50)
    plain_ms = device_ms(lambda: kern.count_offsets_plain(offsets, positive, x), 10)
    # one PyTorch call for the same counts: scatter_add_ into a zeroed int32
    # matrix with the dead draws already routed to a spare column (the mask
    # and the cast to uint8 are left out of its time)
    live = (offsets >= 0) & (offsets < x) & (offsets != positive[:, None])
    index = torch.where(live, offsets, x).long()
    ones = torch.ones_like(index, dtype=torch.int32)
    library_ms = device_ms(
        lambda: torch.zeros((bt, x + 1), dtype=torch.int32, device="cuda").scatter_add_(
            1, index, ones), 10)
    bound_ms, bound_by = bound(4 * (bt * r + bt) + bt * x, bt * r)
    log(f"  kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, scatter_add_ {library_ms:.5f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, count=got)


def check_count_edges(kern) -> None:
    """The count, uint8 and int32, exactly, at widths whose 37 rows start at
    every offset from a 16-byte boundary and hold less than one vector, or
    one and a bit: what the kernel writes element by element."""
    for r in (16, 300):
        for x in (1, 15, 17):
            offsets, positive = negative_draws(x, 37, r, x)
            got = kern.count_offsets(offsets, positive, x)
            want = kern.count_offsets_plain(offsets, positive, x)
            check(torch.equal(got, want), f"{kern.KERNEL} disagrees with its plain version at "
                  f"[37, {r}] into X={x}")
    log(f"{kern.KERNEL} [37, 16] and [37, 300] into X=1, 15, 17: equal to plain")


def plain_lse_in_chunks(kern, q, cat, count, tau, gl, chunk, with_grads=True):
    """`dense_neg_lse_plain` and its gradients on `chunk` rows at a time: at a
    wide catalog its [BT, X] float32 logits (2.9 GB at 26,880 x 26,744, several
    times that under autograd) do not have to exist at once."""
    lse, dq = [], []
    dcat = torch.zeros_like(cat)
    for lo in range(0, q.shape[0], chunk):
        qc = q[lo : lo + chunk].detach().requires_grad_(with_grads)
        part = kern.dense_neg_lse_plain(qc, cat, count[lo : lo + chunk], tau)
        lse.append(part.detach())
        if with_grads:
            g_q, g_cat = torch.autograd.grad(part, [qc, cat], gl[lo : lo + chunk])
            dq.append(g_q)
            dcat += g_cat
    return torch.cat(lse), (torch.cat(dq) if with_grads else None), dcat


def check_lse_stats(name, kern, q, cat, count, tau, lse, sup_off=None):
    """The forward kernel's per-row (m_safe, s) against the sparse plain
    forward (`dense_neg_lse_stats_sparse_plain`), and its lse the same bits
    in a second call (each row is written once, without atomics). Returns
    the plain (m_safe, s), which the sparse plain backward takes, and the
    largest error."""
    q, cat = q.detach(), cat.detach()
    again, m_k, s_k = kern.dense_neg_lse_stats(q, cat, count, tau, sup_off)
    m_safe, s = kern.dense_neg_lse_stats_sparse_plain(q, cat, count, tau, sup_off)
    torch.cuda.synchronize()
    ok_m, err_m = within(m_k, m_safe, RTOL, ATOL)
    ok_s, err_s = within(s_k, s, RTOL, ATOL)
    same = bool(torch.equal(again, lse.detach()))
    log(f"  {name}: m_safe, s max_abs_err vs the sparse plain forward {err_m:.3e}, {err_s:.3e} "
        f"within rtol {RTOL} atol {ATOL}: {ok_m and ok_s}; lse the same bits in a second call: "
        f"{same}")
    check(ok_m and ok_s, f"{name}: m_safe or s disagrees with the sparse plain forward")
    check(same, f"{name}: lse differs between two calls")
    return m_safe, s, max(err_m, err_s)


def lse_rates(fwd_ms, nnz, bt, x, count_bytes) -> str:
    return (f"{nnz} live logits of {bt * x} ({100 * nnz / (bt * x):.2f}%), the count read at "
            f"{count_bytes / fwd_ms * 1e-6:.0f} GB/s")


def check_lse_bwd(name, got, want_dense, want_sparse, all_hit):
    """The backward kernel's (dq, dcat) against autograd of the dense plain
    version and against the sparse plain backward; dq of an all-hit row
    exactly zero. Returns the largest error of the two comparisons."""
    errs, oks = [], []
    for want in (want_dense, want_sparse):
        for g, w in zip(got, want):
            ok, err = within(g, w, RTOL, ATOL)
            oks.append(ok)
            errs.append(err)
    zero = not bool(got[0][all_hit].any())
    log(f"  {name}: dq, dcat max_abs_err vs autograd of the plain version {errs[0]:.3e}, "
        f"{errs[1]:.3e}, vs the sparse plain backward {errs[2]:.3e}, {errs[3]:.3e}; within "
        f"rtol {RTOL} atol {ATOL}: {all(oks)}; the all-hit row's dq zero: {zero}")
    check(all(oks) and zero, f"{name} disagrees with its plain versions")
    return max(errs)


def check_dense_neg_lse(kern, count, bt, d, x, tau, chunk=None) -> tuple[dict, dict]:
    """`chunk`: rows of the plain version at a time (None: all at once)."""
    chunk = chunk or bt
    rng = np.random.default_rng(17)
    q = torch.tensor(rng.normal(size=(bt, d)), dtype=torch.float32)
    cat = torch.tensor(rng.normal(size=(x, d)), dtype=torch.float32)
    q = (q / q.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    cat = (cat / cat.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    gl = torch.tensor(rng.normal(size=(bt,)), dtype=torch.float32).cuda()
    lse = kern.dense_neg_lse(q, cat, count, tau)
    # the -inf of an all-hit row passes no gradient on; the loss's logaddexp
    # sends it 0, and here the row's gl is zeroed
    finite = torch.isfinite(lse)
    gl = torch.where(finite, gl, 0.0)
    got = torch.autograd.grad(lse, [q, cat], gl, retain_graph=True)
    again = torch.autograd.grad(lse, [q, cat], gl, retain_graph=True)
    lse_plain, *want = plain_lse_in_chunks(kern, q, cat, count, tau, gl, chunk)
    torch.cuda.synchronize()
    same_inf = bool(torch.equal(finite, torch.isfinite(lse_plain)))
    ok_lse, err_lse = within(lse[finite], lse_plain[finite], RTOL, ATOL)
    same_dq = bool(torch.equal(got[0], again[0]))
    same_dcat = bool(torch.equal(got[1], again[1]))
    log(f"{kern.KERNEL} / {kern.KERNEL_BWD} [{bt}, {d}] x [{x}, {d}], tau {tau}, "
        f"{count.dtype} counts: max_abs_err lse {err_lse:.3e} within rtol {RTOL} atol {ATOL}: "
        f"{ok_lse}; all-hit row 5: lse {float(lse[5].detach())}, -inf rows agree: {same_inf}; "
        f"dq the same bits in a second call: {same_dq} (dcat: {same_dcat})")
    check(same_inf and float(lse[5].detach()) == float("-inf"), "the all-hit row's lse is not -inf")
    check(ok_lse, f"{kern.KERNEL} disagrees with its plain version")
    check(same_dq, f"{kern.KERNEL_BWD}: dq differs between two calls")
    m_safe, s, err_stats = check_lse_stats(kern.KERNEL, kern, q, cat, count, tau, lse)
    sparse = kern.dense_neg_lse_bwd_plain(q.detach(), cat.detach(), count, m_safe, s, gl, tau)
    err_bwd = check_lse_bwd(kern.KERNEL_BWD, got, want, sparse, 5)
    nnz = int(count.count_nonzero())
    with torch.no_grad():
        fwd_ms = device_ms(lambda: kern.dense_neg_lse(q, cat, count, tau), 50)
        fwd_plain = device_ms(
            lambda: plain_lse_in_chunks(kern, q, cat, count, tau, gl, chunk, with_grads=False), 5)
    bwd_ms = device_ms(lambda: torch.autograd.grad(lse, [q, cat], gl, retain_graph=True), 30)
    # the backward's own plain version: the sparse form, given (m_safe, s)
    bwd_plain = device_ms(lambda: kern.dense_neg_lse_bwd_plain(
        q.detach(), cat.detach(), count, m_safe, s, gl, tau), 5)
    # only the logits whose count is positive are needed: the operations
    # counted are those of this run's nnz live logits, not of all BT*X
    count_bytes = bt * x * count.element_size()
    fwd_bound = bound(4 * (bt * d + x * d + 3 * bt) + count_bytes, nnz * 2 * d)
    bwd_bound = bound(4 * (2 * bt * d + 2 * x * d + 3 * bt) + count_bytes, nnz * 6 * d)
    log(f"  forward: kernel {fwd_ms:.5f} ms, plain {fwd_plain:.5f} ms, bound "
        f"{fwd_bound[0]:.5f} ms ({fwd_bound[1]}); {lse_rates(fwd_ms, nnz, bt, x, count_bytes)}")
    log(f"  backward: kernel {bwd_ms:.5f} ms, sparse plain {bwd_plain:.5f} ms, bound "
        f"{bwd_bound[0]:.5f} ms ({bwd_bound[1]})")
    fwd = dict(max_abs_err=max(err_lse, err_stats), ms=fwd_ms, plain_ms=fwd_plain,
               bound_ms=fwd_bound[0], bound_by=fwd_bound[1])
    bwd = dict(max_abs_err=err_bwd, ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bwd_bound[0],
               bound_by=bwd_bound[1])
    return fwd, bwd


def check_fused_lse(kern, count, positive, bt, d, x, tau, chunk) -> tuple[dict, dict]:
    """`fused_dense_neg_lse` (the lse kernels with a `sup_off` pointer)
    against the plain version on the count with each row's positive zeroed;
    then an all -1 sup_off against the null pointer of the training path,
    lse and dq bit for bit (dcat sums in float64 with atomics in no fixed
    order)."""
    rng = np.random.default_rng(19)
    q = torch.tensor(rng.normal(size=(bt, d)), dtype=torch.float32)
    cat = torch.tensor(rng.normal(size=(x, d)), dtype=torch.float32)
    q = (q / q.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    cat = (cat / cat.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    gl = torch.tensor(rng.normal(size=(bt,)), dtype=torch.float32).cuda()
    # the count kernel dropped the accidental hits already: put some back,
    # for sup_off to take out
    count = count.clone()
    rows = torch.arange(0, bt, 3, device="cuda")
    hit = positive[rows] >= 0
    count[rows[hit], positive[rows[hit]].long()] += 2
    before = kern.fused_launches
    lse = kern.fused_dense_neg_lse(q, cat, count, positive, tau)
    finite = torch.isfinite(lse)
    gl = torch.where(finite, gl, 0.0)
    got = torch.autograd.grad(lse, [q, cat], gl, retain_graph=True)
    check(kern.fused_launches == before + 1, "fused_dense_neg_lse did not launch its kernel")
    again = torch.autograd.grad(lse, [q, cat], gl, retain_graph=True)
    masked = count.clone()
    live = positive >= 0
    masked[torch.arange(bt, device="cuda")[live], positive[live].long()] = 0
    lse_plain, *want = plain_lse_in_chunks(kern, q, cat, masked, tau, gl, chunk)
    torch.cuda.synchronize()
    ok_lse, err_lse = within(lse[finite], lse_plain[finite], RTOL, ATOL)
    same_inf = bool(torch.equal(finite, torch.isfinite(lse_plain)))
    same_dq = bool(torch.equal(got[0], again[0]))
    log(f"{kern.FUSED} (sup_off) [{bt}, {d}] x [{x}, {d}]: max_abs_err lse {err_lse:.3e} within "
        f"rtol {RTOL} atol {ATOL}: {ok_lse}, -inf rows agree: {same_inf}; dq the same bits in a "
        f"second call: {same_dq}")
    check(ok_lse and same_inf, f"{kern.FUSED} disagrees with its plain version")
    check(same_dq, f"{kern.FUSED} backward: dq differs between two calls")
    m_safe, s, err_stats = check_lse_stats(kern.FUSED, kern, q, cat, count, tau, lse, positive)
    sparse = kern.dense_neg_lse_bwd_plain(q.detach(), cat.detach(), count, m_safe, s, gl, tau,
                                          positive)
    all_hit = torch.nonzero(~finite)[:1, 0]
    err_bwd = check_lse_bwd(kern.FUSED + " backward", got, want, sparse, all_hit)
    none = torch.full_like(positive, -1)
    lse_none = kern.fused_dense_neg_lse(q, cat, count, none, tau)
    lse_null = kern.dense_neg_lse(q, cat, count, tau)
    dq_none = torch.autograd.grad(lse_none, [q], gl)[0]
    dq_null = torch.autograd.grad(lse_null, [q], gl)[0]
    same = bool(torch.equal(lse_none, lse_null)) and bool(torch.equal(dq_none, dq_null))
    log(f"  all -1 sup_off equals the null pointer bit for bit (lse, dq): {same}")
    check(same, "an all -1 sup_off differs from the null pointer")
    nnz = int(masked.count_nonzero())
    with torch.no_grad():
        fwd_ms = device_ms(lambda: kern.fused_dense_neg_lse(q, cat, count, positive, tau), 30)
        fwd_plain = device_ms(lambda: plain_lse_in_chunks(
            kern, q, cat, masked, tau, gl, chunk, with_grads=False), 3)
    bwd_ms = device_ms(lambda: torch.autograd.grad(lse, [q, cat], gl, retain_graph=True), 20)
    bwd_plain = device_ms(lambda: kern.dense_neg_lse_bwd_plain(
        q.detach(), cat.detach(), count, m_safe, s, gl, tau, positive), 5)
    fwd_bound = bound(4 * (bt * d + x * d + 4 * bt) + bt * x, nnz * 2 * d)
    bwd_bound = bound(4 * (2 * bt * d + 2 * x * d + 4 * bt) + bt * x, nnz * 6 * d)
    log(f"  forward: kernel {fwd_ms:.5f} ms, plain {fwd_plain:.5f} ms, bound {fwd_bound[0]:.5f} "
        f"ms ({fwd_bound[1]}); {lse_rates(fwd_ms, nnz, bt, x, bt * x)}; backward: kernel "
        f"{bwd_ms:.5f} ms, sparse plain {bwd_plain:.5f} ms, bound {bwd_bound[0]:.5f} ms "
        f"({bwd_bound[1]})")
    fwd = dict(max_abs_err=max(err_lse, err_stats), ms=fwd_ms, plain_ms=fwd_plain,
               bound_ms=fwd_bound[0], bound_by=fwd_bound[1])
    bwd = dict(max_abs_err=err_bwd, ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bwd_bound[0],
               bound_by=bwd_bound[1])
    return fwd, bwd


def chunk_inputs(seed, b, nq, nc, h, d, max_len):
    """q [b, nq], k, v [b, nc] as strided slices of one projection `proj` (a
    leaf that takes their gradients), as the ring hands a chunk over; the
    query rows' next-item timestamps and the chunk's, ml-20m-era."""
    rng = np.random.default_rng(seed)
    proj = torch.tensor(rng.normal(size=(b, nq + nc, 3 * h * d)), dtype=torch.float32).cuda()
    proj.requires_grad_()
    q, k, v = (t.unflatten(-1, (h, d)) for t in torch.split(proj, [h * d] * 3, dim=-1))
    ts = np.sort(1_100_000_000 + rng.integers(0, 10 * 365 * 86400, size=(b, nq + nc)), axis=1)
    ts = torch.tensor(ts, dtype=torch.int32).cuda()
    a = dict(
        q=q[:, :nq], k=k[:, nq:], v=v[:, nq:], tsq_next=ts[:, :nq], tsk=ts[:, nq:],
        pos_w=torch.tensor(rng.normal(size=(2 * max_len - 1,)) * 0.02,
                           dtype=torch.float32).cuda().requires_grad_(),
        ts_w=torch.tensor(rng.normal(size=(129,)) * 0.02,
                          dtype=torch.float32).cuda().requires_grad_(),
    )
    return a, proj


def chunk_bounds(b, nq, nc, h, d, offd, max_len) -> tuple:
    """(forward, backward) least times of one chunk call: the multiply-adds of
    its live pairs (n - m >= offd) at peak fp32, or the bytes it must move,
    each input read once (q and the query stamps; the k, v rows and stamps
    that a live pair reaches; the table entries) and each output written
    once, whichever is longer."""
    rows = np.arange(nq)
    pairs = int(np.clip(rows - offd + 1, 0, nc).sum())
    keys = int(np.clip(nq - offd, 0, nc))  # chunk rows some live pair reads
    entries = min(nq + keys, 2 * max_len - 1) + 129
    fwd_reads = b * (nq * h * d + nq + keys * (2 * h * d + 1)) + entries
    fwd = bound(4 * (fwd_reads + b * nq * h * d), b * pairs * h * 2 * 2 * d)
    bwd_reads = fwd_reads + b * nq * h * d  # g
    bwd_writes = b * (nq + 2 * nc) * h * d + 2 * max_len - 1 + 129
    bwd = bound(4 * (bwd_reads + bwd_writes), b * pairs * h * 2 * 5 * d)
    return fwd, bwd, pairs


def check_chunk(kern, seed, b, nq, nc, h, d, offd, max_len, timed=False):
    """The chunk kernels against their plain version, forward and (through
    autograd) dq, dk, dv, d_pos_w, d_ts_w, at one offset; with `timed` both
    kernels and the plain version are timed -> (forward, backward) dicts."""
    a, proj = chunk_inputs(seed, b, nq, nc, h, d, max_len)
    kw = dict(off_delta=offd, inv_n=1.0 / max_len, max_len=max_len, num_buckets=128)
    leaves = [proj, a["pos_w"], a["ts_w"]]
    g = torch.tensor(np.random.default_rng(seed + 1).normal(size=(b, nq, h, d)),
                     dtype=torch.float32).cuda()

    def split(grads):
        dq, dk, dv = torch.split(grads[0], [h * d] * 3, dim=-1)
        return dq[:, :nq], dk[:, nq:], dv[:, nq:], grads[1], grads[2]

    out = kern.hstu_chunk_attention(**a, **kw)
    got = split(torch.autograd.grad(out, leaves, g, retain_graph=True))
    out_plain = kern.hstu_chunk_attention_plain(**a, **kw)
    want = split(torch.autograd.grad(out_plain, leaves, g, retain_graph=True))
    torch.cuda.synchronize()
    ok_out, err_out = within(out, out_plain, RTOL, ATOL)
    ok, errs = ok_out, [f"out {err_out:.3e}"]
    for i, name in enumerate(("dq", "dk", "dv", "d_pos_w", "d_ts_w")):
        good, err = within(got[i], want[i], BIAS_RTOL if i >= 3 else RTOL, ATOL)
        ok = ok and good
        errs.append(f"{name} {err:.3e}")
    dead = offd >= nq
    zeros = not (bool(out.any()) or any(bool(t.any()) for t in got)) if dead else True
    # both kernels write their outputs whole (no zero fill): query rows
    # before offd and key rows from nq - offd on meet no live pair and must
    # come out exactly zero (out and dq; dk and dv); no atomics touch out, dq,
    # dk, dv, so a second call gives the same bits
    q_dead, k_reached = min(max(offd, 0), nq), min(max(nq - offd, 0), nc)
    unreached = not (bool(out[:, :q_dead].any()) or bool(got[0][:, :q_dead].any())
                     or bool(got[1][:, k_reached:].any()) or bool(got[2][:, k_reached:].any()))
    again = split(torch.autograd.grad(out, leaves, g, retain_graph=True))
    same = all(torch.equal(x, y) for x, y in zip(got[:3], again[:3]))
    same = same and torch.equal(out, kern.hstu_chunk_attention(**a, **kw))
    shape = f"B={b} Nq={nq} Nc={nc} H={h} d={d} L={max_len} offd={offd}"
    log(f"{kern.KERNEL} / {kern.KERNEL_BWD} {shape}: max_abs_err " + ", ".join(errs)
        + f"; within rtol {RTOL} (tables {BIAS_RTOL}) atol {ATOL}: {ok}"
        + (f"; dead chunk all zeros: {zeros}" if dead else "")
        + f"; {q_dead} query and {nc - k_reached} key rows without a live pair exactly zero: "
        f"{unreached}; out, dq, dk, dv bit-identical in a second call: {same}")
    check(ok and zeros, f"the chunk kernels disagree with their plain version at {shape}")
    check(unreached, f"rows without a live pair are not zero in the chunk kernels at {shape}")
    check(same, f"the chunk kernels' out, dq, dk, dv differ between two calls at {shape}")
    if not timed:
        return None
    # host time to queue a call: the wrapper's checks, ctypes and the launch
    # (the backward through autograd, with its outputs and zeroed tables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        kern.hstu_chunk_attention(**a, **kw)
    fwd_host_us = 1e6 * (time.perf_counter() - t0) / 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        torch.autograd.grad(out, leaves, g, retain_graph=True)
    bwd_host_us = 1e6 * (time.perf_counter() - t0) / 50
    torch.cuda.synchronize()
    log(f"  host time to queue a call: forward {fwd_host_us:.1f} us, backward through autograd "
        f"{bwd_host_us:.1f} us")
    fwd_ms = device_ms(lambda: kern.hstu_chunk_attention(**a, **kw), 200)
    fwd_plain = device_ms(lambda: kern.hstu_chunk_attention_plain(**a, **kw), 30)
    bwd_ms = device_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 100)
    bwd_plain = device_ms(lambda: torch.autograd.grad(out_plain, leaves, g, retain_graph=True), 20)
    fwd_bound, bwd_bound, pairs = chunk_bounds(b, nq, nc, h, d, offd, max_len)
    log(f"  {pairs} live pairs a row and head; forward: kernel {fwd_ms:.5f} ms, plain "
        f"{fwd_plain:.5f} ms, bound {fwd_bound[0]:.5f} ms ({fwd_bound[1]}); backward: kernel "
        f"{bwd_ms:.5f} ms, plain {bwd_plain:.5f} ms, bound {bwd_bound[0]:.5f} ms ({bwd_bound[1]})")
    fwd = dict(max_abs_err=err_out, ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fwd_bound[0],
               bound_by=fwd_bound[1])
    bwd = dict(max_abs_err=max(float((x - y).detach().abs().max()) for x, y in zip(got, want)),
               ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bwd_bound[0], bound_by=bwd_bound[1])
    return fwd, bwd


# ---------------------------------------------------------------- phase 3


def http(port: int, path: str, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        body = json.loads(resp.read())
        check(resp.status == 200, f"{path} answered {resp.status}: {body}")
    return body, time.perf_counter() - t0


def make_requests(catalog: np.ndarray, seed: int):
    """32 ragged histories (1 to 250 items: the longest are truncated to the
    last 200) with ml-1m-era timestamps, and 48 single rows, half timed."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([[1, 200, 250], rng.integers(2, 200, size=29)])
    rows = [rng.choice(catalog, size=int(n)).tolist() for n in lens]
    stamps = [np.sort(978_000_000 + rng.integers(0, 10**8, size=len(r))).tolist() for r in rows]
    singles = []
    for i in range(48):
        r = rng.choice(catalog, size=int(rng.integers(1, 220))).tolist()
        one = {"sequences": [r], "k": 10}
        if i % 2:
            one["timestamps"] = [np.sort(978_000_000 + rng.integers(0, 10**8, size=len(r))).tolist()]
        singles.append(one)
    return {"sequences": rows, "timestamps": stamps, "k": 50}, singles


def check_answer(req: dict, body: dict, catalog_set: set, max_len: int, k: int) -> None:
    check(len(body["ids"]) == len(req["sequences"]), "one answer row per request row")
    for hist, ids, scores in zip(req["sequences"], body["ids"], body["scores"]):
        check(len(ids) == k and len(scores) == k, f"k={k} not honoured: {len(ids)}")
        check(set(ids) <= catalog_set, "an id outside the catalog")
        check(not set(hist[-max_len:]) & set(ids), "an id from the row's own history")
        s = np.asarray(scores)
        check(bool(np.isfinite(s).all()), "a non-finite score")
        check(bool((np.diff(s) <= 0).all()), "scores not descending")


def run_main_path(kern, num_blocks_expected: int, card: str):
    from mygenerativerecommenders_tpu_torch.cli.serve import build_engine
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.data.catalog import load_catalog
    from mygenerativerecommenders_tpu_torch.models.model import build_model
    from mygenerativerecommenders_tpu_torch.ops.topk import topk_agree
    from mygenerativerecommenders_tpu_torch.serving.service import RecommenderHTTPServer

    args = ["experiment=synthetic-hstu", f"data.data_dir={OUT_DIR / 'data'}"]
    cfg = parse_args(args)
    catalog, max_id = load_catalog(cfg.data)
    resolve(cfg, max_id)
    num_blocks = cfg.model.encoder.num_blocks
    check(num_blocks == num_blocks_expected, f"synthetic-hstu has {num_blocks} blocks")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    ckpt = OUT_DIR / "synthetic-hstu.pt"
    torch.save(build_model(cfg, device="cpu", seed=1234).state_dict(), ckpt)
    argv = args + [f"trainer.ckpt_path={ckpt}"]
    t0 = time.perf_counter()
    engine, _ = build_engine(argv)  # default device: cuda
    log(f"engine on {engine.device}: synthetic-hstu D={cfg.model.item_embedding_dim} "
        f"blocks={num_blocks} H={cfg.model.encoder.num_heads} "
        f"N={cfg.data.max_sequence_length + cfg.model.gr_output_length + 1} "
        f"catalog={len(catalog)} (max id {max_id}) k={cfg.model.index.k} "
        f"batch={engine.batch_size}, built in {time.perf_counter() - t0:.2f} s")
    check(engine.device.type == "cuda", "the engine is not on the card")
    big, singles = make_requests(catalog, seed=7)
    catalog_set = set(catalog.tolist())
    server = RecommenderHTTPServer(engine, "127.0.0.1", 0).start()
    try:
        http(server.port, "/v1/retrieve", big)  # warm-up, before the counts
        kern.launches, engine.calls = 0, 0
        health, _ = http(server.port, "/healthz")
        check(health["status"] == "ok" and health["catalog_size"] == len(catalog), str(health))
        body_big, _ = http(server.port, "/v1/retrieve", big)
        check_answer(big, body_big, catalog_set, engine.max_len, 50)
        answers = [None] * len(singles)
        lat_single = [0.0] * len(singles)

        def one(i):
            answers[i], lat_single[i] = http(server.port, "/v1/retrieve", singles[i])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(singles))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            check(not t.is_alive(), "a single-row request hung")
        for req, body in zip(singles, answers):
            check(body is not None, "a single-row request failed")
            check_answer(req, body, catalog_set, engine.max_len, 10)
        burst_calls = engine.calls - 1
        http_s, direct_s = timed_rounds(server.port, engine, big)
        launches, calls = kern.launches, engine.calls
    finally:
        server.stop()
    log(f"main path: {calls} engine calls ({burst_calls} for {len(singles)} coalesced "
        f"single rows), {launches} attention launches")
    check(launches > 0, "the attention kernel was not launched on the main path")
    check(launches == num_blocks * calls,
          f"launches {launches} != {num_blocks} blocks x {calls} engine calls")

    cpu_engine, _ = build_engine(argv + ["serve.device=cpu"])
    want_big = cpu_engine.retrieve(big["sequences"], big["timestamps"], k=50)
    problem = topk_agree(body_big["ids"], body_big["scores"], *want_big, atol=E2E_ATOL)
    check(problem is None, f"card vs CPU engine, 32-row request: {problem}")
    for req, body in zip(singles, answers):
        want = cpu_engine.retrieve(req["sequences"], req.get("timestamps"), k=10)
        problem = topk_agree(body["ids"], body["scores"], *want, atol=E2E_ATOL)
        check(problem is None, f"card vs CPU engine, single row: {problem}")
    err = max(
        float(np.abs(np.asarray(body_big["scores"]) - np.asarray(want_big[1])).max()), 0.0
    )
    log(f"card and CPU engines agree: max score diff {err:.3e} on the 32-row request "
        f"(atol {E2E_ATOL}), ids equal up to near-ties, {len(singles)} single rows too")

    p = np.percentile
    http_ms, direct_ms = 1e3 * http_s, 1e3 * direct_s
    lat_single_ms = 1e3 * np.asarray(lat_single)
    round_http, round_direct = np.median(http_ms, axis=1), np.median(direct_ms, axis=1)
    gap = round_http - round_direct
    log(f"32-row /v1/retrieve over HTTP, {http_ms.size} back to back in {len(http_ms)} rounds: "
        f"p50 {p(http_ms, 50):.3f} ms, p99 {p(http_ms, 99):.3f} ms, "
        f"{32e3 * http_ms.size / http_ms.sum():.1f} rows/s; round p50s "
        f"{round_http.min():.3f}-{round_http.max():.3f} ms on {card}")
    log(f"the same 32-row call on the engine directly, alternated with those rounds: "
        f"p50 {p(direct_ms, 50):.3f} ms, p99 {p(direct_ms, 99):.3f} ms; round p50s "
        f"{round_direct.min():.3f}-{round_direct.max():.3f} ms; HTTP + JSON per round "
        f"(HTTP p50 - engine p50): median {np.median(gap):.3f} ms, "
        f"range {gap.min():.3f}-{gap.max():.3f} ms on {card}")
    log(f"{len(singles)} concurrent single-row requests: p50 {p(lat_single_ms, 50):.3f} ms, "
        f"p99 {p(lat_single_ms, 99):.3f} ms on {card}")
    eager = eager_twin(engine)
    got = engine.retrieve(big["sequences"], big["timestamps"])
    want = eager.retrieve(big["sequences"], big["timestamps"])
    check(got[0] == want[0] and got[1] == want[1],
          "the graphed engine's 32-row answer differs from the eager engine's")
    log("graphed and eager engines on the card: the same ids and scores, bit for bit")
    engines_side_by_side(
        "retrieve, 32 rows", card,
        {name: (lambda e=e: e.retrieve(big["sequences"], big["timestamps"], k=big["k"]))
         for name, e in (("eager", eager), ("graphed", engine))},
    )
    return launches, engine, eager, cpu_engine, big


def eager_twin(engine):
    """An engine on the card over the same model, with graphs=False."""
    from mygenerativerecommenders_tpu_torch.serving.service import ServingEngine

    return ServingEngine(engine.model, engine.cfg, engine.all_item_ids, engine.max_item_id,
                         engine.batch_size, device=engine.device, graphs=False)


def engines_side_by_side(what: str, card: str, calls: dict, reps: int = 20,
                         profiled: int = 10) -> None:
    """Each engine call of `calls` (name -> a call), eager and graphed: the
    p50 of `reps` host-clock calls (each ends in its read-back), then
    torch.profiler's device ms, launches and idle share of a call, averaged
    over `profiled` calls."""
    for name, fn in calls.items():
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        wall_ms = 1e3 * float(np.median(times))
        profile_device(lambda _: fn(), reps=profiled, top=3, wall_ms=wall_ms,
                       what=f"engine call, {what}, {name}, p50 on {card}")


# ---------------------------------------------------------------- phase 3b


GEN_STEPS = 11  # synthetic-hstu's gr_output_length + 1: the whole output window
GEN_MODES = {
    "greedy": {},
    "sample": {"temperature": 0.7, "top_k": 50, "top_p": 0.9, "seed": 3},
    "beam": {"num_beams": 4},
}


def check_generated(req: dict, ids: list, catalog_set: set, max_len: int) -> None:
    check(len(ids) == len(req["sequences"]), "one answer row per request row")
    for hist, row in zip(req["sequences"], ids):
        check(len(row) == GEN_STEPS, f"{len(row)} ids generated, not {GEN_STEPS}")
        check(set(row) <= catalog_set, "a generated id outside the catalog")
        check(not set(hist[-max_len:]) & set(row), "a generated id from the row's history")
        check(len(set(row)) == GEN_STEPS, "an id generated twice in one row")


def greedy_replay(engine, req: dict):
    """The greedy program step by step on the engine's device, through
    models/decode.py: -> (ids [rows, steps], each pick's top-2 margin [rows,
    steps], the prefill's query rows, the first decode step's output rows)."""
    from mygenerativerecommenders_tpu_torch.models import decode
    from mygenerativerecommenders_tpu_torch.ops.sequence import (
        get_current_embeddings,
        scatter_at_lengths,
    )
    from mygenerativerecommenders_tpu_torch.ops.topk import masked_mips_scores
    from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch

    batch, n = engine._pack(req["sequences"], req["timestamps"])
    tensors = {k: torch.from_numpy(v).to(engine.device) for k, v in batch.items()}
    catalog = engine._catalog
    ids, margins, queries = [], [], []
    with torch.no_grad():
        seq, _, _ = seq_features_from_batch(tensors, GEN_STEPS)
        encoded, cache = decode.prefill(engine.model, seq)
        query = get_current_embeddings(cache.lengths, encoded)
        invalid = seq.past_ids
        for _ in range(GEN_STEPS):
            queries.append(query[:n].cpu().numpy())
            scores = masked_mips_scores(query, engine.candidates, catalog, invalid,
                                        engine.max_item_id)
            top2, idx = torch.topk(scores, 2, dim=1)
            margins.append((top2[:, 0] - top2[:, 1])[:n].cpu().numpy())
            picked = catalog[idx[:, 0]]
            ids.append(picked[:n].cpu().numpy())
            invalid = scatter_at_lengths(invalid, cache.lengths, picked.to(invalid.dtype))
            query, cache = decode.decode_step(engine.model, cache, picked,
                                              decode.last_timestamps(cache))
    return np.stack(ids, axis=1), np.stack(margins, axis=1), queries[0], queries[1]


def run_generation_path(kern, engine, eager, cpu_engine, req: dict, num_blocks: int,
                        card: str, rounds: int = 10) -> int:
    """/v1/generate at synthetic-hstu's full width on phase 3's graphed engine.
    -> the attention launches of its counted requests."""
    from mygenerativerecommenders_tpu_torch.serving.service import RecommenderHTTPServer
    from mygenerativerecommenders_tpu_torch.train import graphs

    req = {"sequences": req["sequences"], "timestamps": req["timestamps"], "steps": GEN_STEPS}
    catalog_set = set(engine.all_item_ids.tolist())
    server = RecommenderHTTPServer(engine, "127.0.0.1", 0).start()
    lat = {mode: [] for mode in GEN_MODES}
    answers = {mode: [] for mode in GEN_MODES}
    try:
        for mode, kw in GEN_MODES.items():  # warm-up: each program's capture
            http(server.port, "/v1/generate", {**req, "mode": mode, **kw})
        before = graphs.counts["serve"].copy()
        kern.launches, engine.calls = 0, 0
        for _ in range(rounds):
            for mode, kw in GEN_MODES.items():
                body, seconds = http(server.port, "/v1/generate", {**req, "mode": mode, **kw})
                answers[mode].append(body["ids"])
                lat[mode].append(1e3 * seconds)
        launches, calls = kern.launches, engine.calls
    finally:
        server.stop()
    made = dict(graphs.counts["serve"] - before)
    check(made == {"replays": calls}, f"the counted requests were not all replays: {made}")
    log(f"generation: {calls} engine calls, {launches} attention launches, graphs "
        f"{dict(graphs.counts['serve'])}")
    check(launches == num_blocks * calls,
          f"launches {launches} != {num_blocks} blocks x {calls} generation calls")
    for mode in GEN_MODES:
        for ids in answers[mode]:
            check_generated(req, ids, catalog_set, engine.max_len)
        check(all(ids == answers[mode][0] for ids in answers[mode]),
              f"{mode}: the same request gave other ids")
        want = eager.generate(req["sequences"], req["timestamps"], steps=GEN_STEPS, mode=mode,
                              **GEN_MODES[mode])
        check(answers[mode][0] == want, f"{mode}: the graphed engine's ids differ from the eager's")
    check(answers["sample"][0] != answers["greedy"][0], "sampling gave the greedy ids")
    log(f"generated ids in the catalog, none from a row's history, none twice in a row; "
        f"{rounds} identical answers per mode (sample: seed 3); graphed = eager on the card")

    # the card against the CPU: the prefill, one decode step, the greedy ids
    ids_gpu, _, q_gpu, d_gpu = greedy_replay(engine, req)
    ids_cpu, margin, q_cpu, d_cpu = greedy_replay(cpu_engine, req)
    check((ids_gpu == np.asarray(answers["greedy"][0])).all(),
          "the step-by-step greedy replay on the card differs from the engine's ids")
    check((ids_cpu == np.asarray(cpu_engine.generate(
        req["sequences"], req["timestamps"], steps=GEN_STEPS))).all(),
        "the step-by-step greedy replay on the CPU differs from the CPU engine's ids")
    err_q = float(np.abs(q_gpu - q_cpu).max())
    clear = margin[:, 0] > E2E_ATOL  # rows whose first pick, the step's input, is no near tie
    err_d = float(np.abs(d_gpu - d_cpu)[clear].max())
    check(err_q <= E2E_ATOL and err_d <= E2E_ATOL,
          f"card vs CPU: prefill queries {err_q:.3e}, decode step {err_d:.3e} (atol {E2E_ATOL})")
    tie = margin <= E2E_ATOL
    first_tie = np.where(tie.any(axis=1), tie.argmax(axis=1), GEN_STEPS)
    for r, upto in enumerate(first_tie):
        check((ids_gpu[r, :upto] == ids_cpu[r, :upto]).all(),
              f"row {r}: greedy ids differ from the CPU's before a near tie (step {upto})")
    log(f"card vs CPU: prefill query rows {err_q:.3e}, first decode step {err_d:.3e} apart "
        f"(atol {E2E_ATOL}); greedy ids equal through step {int(first_tie.min())} of "
        f"{GEN_STEPS} in every row ({int((first_tie < GEN_STEPS).sum())} rows reach a near "
        f"tie on the CPU, min margin {float(margin.min()):.3e})")

    p = np.percentile
    for mode, ms in lat.items():
        log(f"32-row /v1/generate, {mode}, {GEN_STEPS} steps, over HTTP: p50 "
            f"{p(ms, 50):.3f} ms, p99 {p(ms, 99):.3f} ms ({len(ms)} requests) on {card}")
    for mode, kw in GEN_MODES.items():
        engines_side_by_side(
            f"generate {mode}, 32 rows x {GEN_STEPS} steps", card,
            {name: (lambda e=e, mode=mode, kw=kw: e.generate(
                req["sequences"], req["timestamps"], steps=GEN_STEPS, mode=mode, **kw))
             for name, e in (("eager", eager), ("graphed", engine))},
            # a generation call is ~1,100-1,500 kernels: the profiler's
            # bookkeeping of many calls would take most of the phase
            reps=10, profiled=2,
        )
    return launches


def timed_rounds(port: int, engine, req: dict, rounds: int = 3, reps: int = 10):
    """Host-clock seconds of the 32-row request over HTTP and of the same
    call made on the engine directly, alternated round by round so that both
    see the same host noise. -> two [rounds, reps] arrays."""
    over_http, direct = [], []
    for _ in range(rounds):
        over_http.append([http(port, "/v1/retrieve", req)[1] for _ in range(reps)])
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            engine.retrieve(req["sequences"], req["timestamps"], k=req["k"])
            times.append(time.perf_counter() - t0)
        direct.append(times)
    return np.asarray(over_http), np.asarray(direct)


def profile_device(fn, reps: int, what: str, wall_ms: float, top: int,
                   by_count: int = 0) -> tuple[float, float]:
    """Where the time of `fn` goes: torch.profiler's device time of the kernels
    one call launches, against its host wall time `wall_ms` (measured without
    the profiler); with `by_count`, also the kernels launched most often.
    -> (device ms, device launches) of one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    # device-side events only (an aten op's row repeats its kernels' time),
    # without annotation ranges such as the optimizer's, which do the same
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    launches = sum(e.count for e in kernels) / reps
    log(f"{what}: wall {wall_ms:.3f} ms; device kernels {device_ms:.3f} ms in "
        f"{launches:.0f} launches per call; device idle "
        f"{100 * max(0.0, 1 - device_ms / wall_ms):.1f}% of the wall time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3 / reps:.4f} ms/call x{e.count / reps:.1f} "
            f"{e.key[:90]}")
    if by_count:
        log("  most launched: " + "; ".join(
            f"x{e.count / reps:.0f} {e.self_device_time_total / 1e3 / reps:.3f} ms {e.key[:60]}"
            for e in sorted(kernels, key=lambda e: -e.count)[:by_count]))
    return device_ms, launches


# ---------------------------------------------------------------- phase 4


class Counts:
    """The launch counters of every kernel wrapper on the training paths, in
    the order attention forward and backward, count, lse forward and
    backward, chunk forward and backward; and the CUDA graphs' captures,
    warm-up runs and replays (train/graphs.py), which a reset clears too."""

    def __init__(self, attn, count_kern, lse_kern, chunk, graphs):
        self.attn, self.count, self.lse, self.chunk = attn, count_kern, lse_kern, chunk
        self.graphs = graphs

    def read_graphs(self) -> dict:
        return {name: dict(c) for name, c in self.graphs.counts.items()}

    def read(self) -> dict:
        a, c, l, k = self.attn, self.count, self.lse, self.chunk
        return {
            a.KERNEL: a.launches, a.KERNEL_BWD: a.bwd_launches, c.KERNEL: c.launches,
            l.KERNEL: l.launches, l.KERNEL_BWD: l.bwd_launches,
            k.KERNEL: k.launches, k.KERNEL_BWD: k.bwd_launches,
        }

    def reset(self) -> None:
        self.attn.launches = self.attn.bwd_launches = 0
        self.count.launches = 0
        self.lse.launches = self.lse.bwd_launches = 0
        self.chunk.launches = self.chunk.bwd_launches = 0
        self.graphs.counts.clear()

    def per_step(self, attn: int, chunk: int, lse: int = 1) -> list:
        """One optimizer step's launches: `attn` attention and `chunk` chunk
        forwards and as many backwards, and `lse` counts and lse pairs (one
        for retrieval, none for ranking, which samples no negatives)."""
        return [attn, attn, lse, lse, lse, chunk, chunk]


def read_training_run(metrics: Path, epochs: int, monitored: float, key: str = "ndcg@100",
                      chance: str = f"log 129 = {np.log(129):.4f}"):
    """The losses, optimizer steps, val rows and test row a `cli.train` run
    logged, checked: finite and falling losses, a val row per epoch (rows
    carrying `key`) and one test row, every metric and the monitored one in
    [0, 1]. With log_every_n_steps=1 a loss is logged at every call: every
    step eagerly, the call's last step in calls of k; the last one's step is
    the run's."""
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = np.asarray([r["train/loss"] for r in rows if "train/loss" in r])
    steps = max(r["step"] for r in rows if "train/loss" in r)
    val = [r for r in rows if f"val/{key}" in r]
    test = [r for r in rows if f"test/{key}" in r]
    log(f"  loss: first {losses[0]:.4f} ({chance}), first five mean "
        f"{losses[:5].mean():.4f}, last five mean {losses[-5:].mean():.4f}")
    check(bool(np.isfinite(losses).all()), "a non-finite training loss")
    check(losses[-5:].mean() < losses[:5].mean(), "the loss did not fall")
    check(len(val) == epochs and len(test) == 1, "val/ or test/ metric rows are missing")
    for r in val + test:
        for key, value in r.items():
            if "/" in key and not key.startswith("train/"):
                check(0.0 <= value <= 1.0, f"{key}={value} outside [0, 1]")
    check(0.0 <= monitored <= 1.0, f"the monitored metric {monitored} is outside [0, 1]")
    return losses, steps, val, test[0]


def check_step_launches(kc: Counts, steps: int, eval_batches: int, counts: dict,
                        graph_counts: dict, attn: int = 0, chunk: int = 0, lse: int = 1,
                        remat: bool = False) -> None:
    """Per optimizer step `attn` attention forwards and backwards (one per
    block) or `chunk` chunk forwards and backwards (the ring's, per block
    times chunk calls), `lse` counts and lse forwards and backwards; per eval
    batch the forwards alone. With `remat` a step runs each forward twice
    (the recompute in the backward). With graphs (`graph_counts`, read with
    `counts`), every step and eval batch must be a replay, and each replay
    counts the launches its capture recorded; a capture's warm-up runs are
    steps too, and add theirs."""
    runs = {}
    for name, n in (("train", steps), ("eval", eval_batches)):
        g = graph_counts.get(name)
        if g:
            check(g["replays"] == n, f"{name}: {g['replays']} graph replays, expected {n}")
            n += g["warmup_runs"]
        runs[name] = n
    tr, ev = runs["train"], runs["eval"]
    fwd = (2 if remat else 1) * tr
    per = kc.per_step(attn, chunk, lse)
    want = dict(zip(kc.read(), (
        per[0] * (fwd + ev), per[1] * tr, lse * tr, lse * tr, lse * tr, per[5] * (fwd + ev),
        per[6] * tr,
    )))
    check(counts == want, f"launches {counts} != expected {want}")
    log("  graphs: " + "; ".join(
        f"{name} {g['captures']} captured ({g['warmup_runs']} warm-up runs), {g['replays']} "
        f"replays" for name, g in sorted(graph_counts.items())) if graph_counts else
        "  no graphs: every step eager")


def step_numbers(kc: Counts, fn, what: str, per_step: list, reps: int = 8, warm: int = 2,
                 top: int = 6) -> dict:
    """One form of a step (fn(i) taking batch i): the p50 of `reps` calls
    synced each call after `warm` calls (a graphed form captures there), each
    call's launches checked against `per_step` (a replay adds the launches
    its capture recorded), device ms and idle share from torch.profiler.
    -> {"p50", "device_ms", "idle", "launches"}"""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        before = kc.read()
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        after = kc.read()
        delta = [after[key] - before[key] for key in after]
        check(delta == per_step, f"{what}: launches of one call {delta}, expected {per_step}")
    p50 = float(np.percentile(times, 50))
    dev, launches = profile_device(fn, reps=4, what=what, wall_ms=p50, top=top)
    return dict(p50=p50, device_ms=dev, idle=max(0.0, 1 - dev / p50), launches=launches)


def eager_and_graphed(kc: Counts, fns: dict, what: str, per_step: list, graphs, card: str,
                      reps: int = 8, warm: int = 2) -> dict:
    """The eager and the graphed form of one step ({"eager": fn, "graphed":
    fn}) side by side (`step_numbers`), and the graphs captured.
    -> {mode: {"p50", "device_ms", "idle", "launches"}}"""
    out = {mode: step_numbers(kc, fn, f"{what}, {mode}", per_step, reps, warm)
           for mode, fn in fns.items()}
    e, g = out["eager"], out["graphed"]
    log(f"{what}, eager | graphed, synced each call: p50 {e['p50']:.3f} | {g['p50']:.3f} ms; "
        f"device {e['device_ms']:.3f} | {g['device_ms']:.3f} ms in {e['launches']:.0f} | "
        f"{g['launches']:.0f} profiled launches; idle {100 * e['idle']:.1f}% | "
        f"{100 * g['idle']:.1f}%; {len(graphs)} graphs captured so far on {card}")
    return out


def run_training_path(kc: Counts, card: str) -> dict:
    """`cli.train.main` on the card at the full width of synthetic-hstu, then a
    second trainer stepped by hand for times. -> launch counts of the first."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    epochs = 30
    out_dir = OUT_DIR / "train"
    args = [
        "experiment=synthetic-hstu", f"trainer.output_dir={out_dir}",
        f"trainer.max_epochs={epochs}", "trainer.log_every_n_steps=1",
    ]
    metrics = out_dir / "synthetic-hstu" / "metrics.jsonl"
    metrics.unlink(missing_ok=True)
    cfg = cli_train.parse_args(args)
    check(cfg.trainer.device == "cuda", "cli.train does not default to the card")
    kc.reset()
    t0 = time.perf_counter()
    monitored = cli_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graph_counts = kc.read(), kc.read_graphs()

    blocks = cfg.model.encoder.num_blocks
    per_epoch = -(-cfg.data.synthetic_num_users // cfg.data.batch_size)
    eval_batches = (epochs + 1) * per_epoch  # validation each epoch, then the test pass
    log(f"training path: cli.train on {card}, synthetic-hstu D={cfg.model.item_embedding_dim} "
        f"blocks={blocks} N={cfg.data.max_sequence_length + cfg.model.gr_output_length + 1} "
        f"batch={cfg.data.batch_size} R={cfg.model.loss.num_to_sample} "
        f"dropout={cfg.model.encoder.linear_dropout_rate}, steps_per_call="
        f"{cfg.trainer.steps_per_call}: {epochs * per_epoch} optimizer steps, "
        f"{eval_batches} eval batches in {wall:.2f} s; launches {counts}")
    losses, steps, val, test = read_training_run(metrics, epochs, monitored)
    check(steps == epochs * per_epoch, f"{steps} optimizer steps, expected {epochs * per_epoch}")
    best = max(val, key=lambda r: r["val/ndcg@100"])
    log(f"  val/ndcg@100 first epoch {val[0]['val/ndcg@100']:.5f}, best {best['val/ndcg@100']:.5f} "
        f"(epoch {best['epoch']}), last {val[-1]['val/ndcg@100']:.5f}; test on the best "
        f"checkpoint: ndcg@10 {test['test/ndcg@10']:.5f}, ndcg@100 "
        f"{test['test/ndcg@100']:.5f}, hr@200 {test['test/hr@200']:.5f} (the JAX "
        f"package's 30-epoch band on this data: ndcg@10 0.037-0.039, PARITY.md)")
    check(test["test/ndcg@10"] >= MIN_TEST_NDCG10,
          f"test ndcg@10 {test['test/ndcg@10']} below {MIN_TEST_NDCG10} after {epochs} epochs")
    check(cfg.trainer.steps_per_call > 1 and graph_counts.get("train"),
          "the cli.train run did not replay graphed steps")
    check_step_launches(kc, steps, eval_batches, counts, graph_counts, attn=blocks)
    for name in ("best.pt", "last.pt"):
        check((out_dir / "synthetic-hstu" / "checkpoints" / name).exists(), f"no {name}")

    # a second trainer, stepped by hand: the eager step (steps_per_call=1's)
    # and the graphed one (the preset's 8) side by side
    trainer = Trainer(cli_train.parse_args(args[:1] + [f"trainer.output_dir={OUT_DIR / 'train2'}"]))
    trainer.model.train()
    batches = [trainer._put(b) for b in trainer.data.loader("train")]
    n = len(batches)
    k = trainer.steps_per_call
    times = eager_and_graphed(kc, {
        "eager": lambda i: trainer.train_step(batches[i % n], trainer.lr1),
        "graphed": lambda i: trainer.train_steps([batches[i % n]], trainer.lr1),
    }, f"train step, batch {cfg.data.batch_size} ({TRAIN_BT} supervision rows)",
        kc.per_step(blocks, 0), trainer.train_steps.graphs, card, reps=40)
    t0 = time.perf_counter()
    for _ in range(8):
        trainer.train_steps(batches[:k], trainer.lr1)
        torch.cuda.synchronize()
    call_ms = 1e3 * (time.perf_counter() - t0) / 8
    log(f"  examples/s at the synced p50: eager {1e3 * cfg.data.batch_size / times['eager']['p50']:.1f}, "
        f"graphed {1e3 * cfg.data.batch_size / times['graphed']['p50']:.1f}; graphed in calls "
        f"of {k} steps synced a call, mean of 8: {call_ms / k:.3f} ms a step, "
        f"{1e3 * k * cfg.data.batch_size / call_ms:.1f} examples/s on {card}")
    return counts


# ---------------------------------------------------------------- phase 6

LONG_ARGS = [
    "experiment=ml-20m-hstu-long", "data.dataset_name=synthetic",
    "data.synthetic_max_seq_len=1024",
]


def run_long_path(kc: Counts, card: str) -> dict:
    """`cli.train.main` on the card at the full width of ml-20m-hstu-long on
    synthetic data: packed train batches, packed eval after each epoch, the
    test pass. Then a second trainer stepped by hand, class of capacity by
    class. -> launch counts of the first."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    epochs = 2
    out_dir = OUT_DIR / "long"
    args = LONG_ARGS + [
        f"trainer.output_dir={out_dir}", f"trainer.max_epochs={epochs}",
        "trainer.log_every_n_steps=1",
    ]
    name = "ml-20m-hstu-long"
    metrics = out_dir / name / "metrics.jsonl"
    metrics.unlink(missing_ok=True)
    cfg = cli_train.parse_args(args)
    check(cfg.trainer.device == "cuda" and cfg.data.pack_sequences, "not the packed card path")
    kc.reset()
    t0 = time.perf_counter()
    monitored = cli_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graph_counts = kc.read(), kc.read_graphs()

    # the batches that run must have held, from loaders of the same plan
    planner = Trainer(cli_train.parse_args(LONG_ARGS + [f"trainer.output_dir={OUT_DIR / 'long2'}"]))
    check(planner._packed and planner._eval_packed, "packing or packed eval is off")
    train_loader = planner._loader("train", packed=True)
    want_steps = sum(len(train_loader._plan(e)) for e in range(epochs))
    eval_batches = (epochs + 1) * len(planner._loader("val", packed=True))
    blocks = cfg.model.encoder.num_blocks
    log(f"long path: cli.train on {card}, {name} on synthetic data, packed: "
        f"D={cfg.model.item_embedding_dim} blocks={blocks} H={cfg.model.encoder.num_heads} "
        f"L={cfg.data.max_sequence_length + cfg.model.gr_output_length + 1} "
        f"batch={cfg.data.batch_size} examples, capacities {list(cfg.data.pack_capacities)}, "
        f"catalog={len(planner.all_item_ids)} (max id {planner.data.max_item_id}), "
        f"R={cfg.model.loss.num_to_sample}, dropout={cfg.model.encoder.linear_dropout_rate}, "
        f"steps_per_call={cfg.trainer.steps_per_call}: {want_steps} optimizer steps, "
        f"{eval_batches} packed eval batches in {wall:.2f} s; launches {counts}")
    losses, steps, val, test = read_training_run(metrics, epochs, monitored)
    check(steps == want_steps, f"{steps} optimizer steps, expected {want_steps}")
    log(f"  val/ndcg@100 by epoch {[round(r['val/ndcg@100'], 5) for r in val]}, test on the best "
        f"checkpoint: ndcg@10 {test['test/ndcg@10']:.5f}, ndcg@100 "
        f"{test['test/ndcg@100']:.5f}, hr@200 {test['test/hr@200']:.5f} (chance hr@200: "
        f"{200 / len(planner.all_item_ids):.5f})")
    check_step_launches(kc, steps, eval_batches, counts, graph_counts, attn=blocks)
    for ckpt in ("best.pt", "last.pt"):
        check((out_dir / name / "checkpoints" / ckpt).exists(), f"no {ckpt}")
    del planner

    # a second trainer, stepped by hand, class by class. Histories of up to
    # 1,200 items (cut to the newest 1,024) give the widest class, 1,152, its
    # segments of 1,025; the command line above leaves that class empty
    trainer = Trainer(cli_train.parse_args(
        LONG_ARGS[:2] + ["data.synthetic_max_seq_len=1200", "trainer.steps_per_call=8",
                         f"trainer.output_dir={OUT_DIR / 'long3'}"]))
    trainer.model.train()
    by_cap = {}
    for batch in trainer._loader("train", packed=True):
        by_cap.setdefault(batch["ids"].shape[1], []).append(batch)
    check(sorted(by_cap) == sorted(cfg.data.pack_capacities), f"classes {sorted(by_cap)}")
    for host in by_cap.values():  # one row count a class: one graph a class
        check(len({b["ids"].shape for b in host}) == 1, "a class with two row counts")
    epoch_s, epoch_examples = {"eager": 0.0, "graphed": 0.0}, 0
    for cap in sorted(by_cap):
        host = by_cap[cap]
        batches = [trainer._put(b) for b in host[:4]]
        n = len(batches)
        examples = float(np.mean([b["num_segments"].sum() for b in host[:4]]))
        tokens = float(np.mean([b["lengths"].sum() for b in host[:4]]))
        rows_cap = host[0]["ids"].shape[0]
        times = eager_and_graphed(kc, {
            "eager": lambda i: trainer.train_step(batches[i % n], trainer.lr1),
            "graphed": lambda i: trainer.train_steps([batches[i % n]], trainer.lr1),
        }, f"train step, class {cap}", kc.per_step(blocks, 0), trainer.train_steps.graphs, card)
        log(f"  class {cap}: {rows_cap} rows x {cap} ({rows_cap * (cap - 1)} supervision rows), "
            f"{examples:.1f} examples and {tokens:.0f} tokens a step; examples/s eager "
            f"{1e3 * examples / times['eager']['p50']:.1f}, graphed "
            f"{1e3 * examples / times['graphed']['p50']:.1f}; tokens/s eager "
            f"{1e3 * tokens / times['eager']['p50']:.0f}, graphed "
            f"{1e3 * tokens / times['graphed']['p50']:.0f} on {card}; {len(host)} such steps an "
            f"epoch")
        for mode in epoch_s:
            epoch_s[mode] += 1e-3 * times[mode]["p50"] * len(host)
        epoch_examples += sum(int(b["num_segments"].sum()) for b in host)
    log(f"an epoch of these steps ({epoch_examples} examples, from the class p50s): eager "
        f"{epoch_s['eager']:.2f} s, {epoch_examples / epoch_s['eager']:.1f} examples/s; graphed "
        f"{epoch_s['graphed']:.2f} s, {epoch_examples / epoch_s['graphed']:.1f} examples/s on {card}")
    return counts


# ---------------------------------------------------------------- phases 5, 7 and 12


def compare_card_and_cpu(what: str, cfg, batch, loss_of, year_of_item=None,
                         atol_of_max: float = 0.0) -> None:
    """One loss and its gradients through the port on the card (kernels) and
    on the CPU (plain versions): the same weights (a seeded init) and batch,
    dropout off. loss_of(model, device_batch, device) -> the loss;
    `year_of_item` for an item_year model; `atol_of_max` raises a gradient's
    atol to that share of its largest entry. At model.compute_dtype=bfloat16
    the gradients may also hold flips (BF16_FLIP_SHARE)."""
    import copy

    from mygenerativerecommenders_tpu_torch.models.model import build_model

    results = {}
    # one seeded build (eval mode: dropout off), the card's a copy of it
    cpu_model = build_model(cfg, device="cpu", seed=99, year_of_item=year_of_item)
    for device in ("cuda", "cpu"):
        model = copy.deepcopy(cpu_model).to(device) if device == "cuda" else cpu_model
        dev_batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        loss = loss_of(model, dev_batch, device)
        loss.backward()
        results[device] = (
            loss.item(), {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        )
    (loss_card, grads_card), (loss_cpu, grads_cpu) = results["cuda"], results["cpu"]
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    log(f"one step of {what}, card (kernels) vs CPU (plain versions): loss {loss_card:.6f} vs "
        f"{loss_cpu:.6f}, relative difference {rel:.3e} (rtol {STEP_LOSS_RTOL})")
    check(rel <= STEP_LOSS_RTOL, "the card's loss disagrees with the CPU's")
    worst, flips, total = True, 0, 0
    bf16 = cfg.model.compute_dtype == "bfloat16"
    for name, want in grads_cpu.items():
        atol = max(STEP_GRAD_ATOL, atol_of_max * float(want.abs().max()))
        ok, err = within(grads_card[name], want, STEP_GRAD_RTOL, atol)
        if not ok and bf16:
            n, far = flips_of(grads_card[name], want, STEP_GRAD_RTOL, atol)
            flips, ok = flips + n, far <= 2.0**-8
        total += want.numel()
        log(f"  grad {name}: max_abs_err {err:.3e}, max |grad| {float(want.abs().max()):.3e}, "
            f"within rtol {STEP_GRAD_RTOL} atol {atol:.3e}: {ok}")
        worst = worst and ok
    if bf16:
        log(f"  bfloat16 flips (elements one of whose bfloat16 cotangents rounded the other "
            f"way, each within 2^-8 of its tensor's largest entry): {flips} of {total} "
            f"(at most {BF16_FLIP_SHARE:.1%})")
        worst = worst and flips <= BF16_FLIP_SHARE * total
    check(worst, "a parameter's gradient on the card disagrees with the CPU's")


def flips_of(got, want, rtol: float, atol: float) -> tuple:
    """(elements outside rtol / atol, the largest distance of one over the
    tensor's largest |want|)."""
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    scale = float(want.abs().max()) or 1.0
    return int(bad.sum()), float(diff[bad].max()) / scale if bool(bad.any()) else 0.0


def card_against_cpu_step(args, packed_capacity=None) -> None:
    """One loss and its gradients through the port on the card (kernels) and
    on the CPU (plain versions): same weights, batch and negatives, dropout
    off. With `packed_capacity` the batch is the first packed train batch of
    that class of capacity."""
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.data.packing import PackedBatchLoader
    from mygenerativerecommenders_tpu_torch.train.task_retrieval import make_loss_fn

    cfg = parse_args(args)
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    resolve(cfg, data.max_item_id)
    if packed_capacity:
        loader = PackedBatchLoader(
            data.dataset("train"), rows_per_batch=1, row_capacity=max(cfg.data.pack_capacities),
            capacities=cfg.data.pack_capacities, segments_per_batch=cfg.data.batch_size,
        )
        batch = next(b for b in loader if b["ids"].shape[1] == packed_capacity)
    else:
        batch = next(iter(data.loader("train")))
    rows = batch["ids"].shape[0]
    n = batch["ids"].shape[1] + (0 if packed_capacity else cfg.model.gr_output_length + 1)
    gen = torch.Generator().manual_seed(3)
    offsets = torch.randint(
        0, len(data.all_item_ids), (rows, n - 1, cfg.model.loss.num_to_sample),
        generator=gen, dtype=torch.int32,
    )
    what = f"{cfg.experiment}, " + (
        f"a packed batch of {rows} rows x {packed_capacity}" if packed_capacity
        else f"a batch of {rows} rows")
    compare_card_and_cpu(what, cfg, batch, lambda model, b, device: make_loss_fn(
        model, cfg, data.all_item_ids, packed=bool(packed_capacity))(
            b, neg_offsets=offsets.to(device)))


# ---------------------------------------------------------------- phases 8 and 9

RING_ARGS = LONG_ARGS + [
    "data.pack_sequences=false", "model.encoder.sp_shards=4", "model.encoder.sp_zigzag=true",
]
RING_USERS = 1024  # the run's depth cut: users (ml-20m-hstu-long's default is 2,048)


def ring_chunk_calls(shards: int, zigzag: bool) -> int:
    """Chunk calls of one ring attention over P shards: zigzag 2 per step and
    shard (back x front, and the one of front x front or back x back that is
    live, both at the diagonal) = P*P + P*(P+1); contiguous the chunks at or
    before the diagonal, P*(P+1)/2."""
    return shards * shards + shards * (shards + 1) if zigzag else shards * (shards + 1) // 2


def run_ring_path(kc: Counts, card: str) -> dict:
    """`cli.train.main` on the card at the full width of ml-20m-hstu-long on
    synthetic data with padded rows and the zigzag ring at sp_shards=4, then
    hand-stepped trainers in both layouts for times. -> launch counts of the
    first."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    epochs = 2
    out_dir = OUT_DIR / "ring"
    args = RING_ARGS + [
        f"data.synthetic_num_users={RING_USERS}", f"trainer.output_dir={out_dir}",
        f"trainer.max_epochs={epochs}", "trainer.log_every_n_steps=1",
    ]
    name = "ml-20m-hstu-long"
    metrics = out_dir / name / "metrics.jsonl"
    metrics.unlink(missing_ok=True)
    cfg = cli_train.parse_args(args)
    enc = cfg.model.encoder
    check(cfg.trainer.device == "cuda" and not cfg.data.pack_sequences and enc.sp_shards == 4
          and enc.sp_zigzag, "not the ring card path")
    kc.reset()
    t0 = time.perf_counter()
    monitored = cli_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graph_counts = kc.read(), kc.read_graphs()

    per_epoch = -(-RING_USERS // cfg.data.batch_size)
    eval_batches = (epochs + 1) * per_epoch  # validation each epoch, then the test pass
    blocks = enc.num_blocks
    calls = blocks * ring_chunk_calls(enc.sp_shards, True)
    n = cfg.data.max_sequence_length + cfg.model.gr_output_length + 1
    log(f"ring path: cli.train on {card}, {name} on synthetic data, padded rows, zigzag ring "
        f"sp_shards={enc.sp_shards} on one device: D={cfg.model.item_embedding_dim} "
        f"blocks={blocks} H={enc.num_heads} N=L={n} (padded to {-(-n // 8) * 8}, chunks of "
        f"{-(-n // 8)} rows) batch={cfg.data.batch_size} ({cfg.data.batch_size * (n - 1)} "
        f"supervision rows) R={cfg.model.loss.num_to_sample} dropout={enc.linear_dropout_rate}, "
        f"steps_per_call={cfg.trainer.steps_per_call}, {RING_USERS} users: {epochs * per_epoch} "
        f"optimizer steps, {eval_batches} eval batches in {wall:.2f} s; launches {counts}")
    losses, steps, val, test = read_training_run(metrics, epochs, monitored)
    check(steps == epochs * per_epoch, f"{steps} optimizer steps, expected {epochs * per_epoch}")
    log(f"  val/ndcg@100 by epoch {[round(r['val/ndcg@100'], 5) for r in val]}, test on the best "
        f"checkpoint: ndcg@10 {test['test/ndcg@10']:.5f}, ndcg@100 "
        f"{test['test/ndcg@100']:.5f}, hr@200 {test['test/hr@200']:.5f}")
    check_step_launches(kc, steps, eval_batches, counts, graph_counts, chunk=calls)
    for ckpt in ("best.pt", "last.pt"):
        check((out_dir / name / "checkpoints" / ckpt).exists(), f"no {ckpt}")

    # hand-stepped trainers, zigzag then contiguous: the eager and the graphed
    # step side by side, their launches and profiles
    for zigzag in (True, False):
        trainer = Trainer(cli_train.parse_args(RING_ARGS + [
            f"data.synthetic_num_users={RING_USERS}", f"model.encoder.sp_zigzag={zigzag}",
            "trainer.steps_per_call=8", f"trainer.output_dir={OUT_DIR / 'ring2'}"]))
        trainer.model.train()
        batches = [trainer._put(b) for _, b in zip(range(4), trainer.data.loader("train"))]
        step_calls = blocks * ring_chunk_calls(enc.sp_shards, zigzag)
        layout = "zigzag" if zigzag else "contiguous"
        times = eager_and_graphed(kc, {
            "eager": lambda i: trainer.train_step(batches[i % 4], trainer.lr1),
            "graphed": lambda i: trainer.train_steps([batches[i % 4]], trainer.lr1),
        }, f"ring train step, {layout}, batch {cfg.data.batch_size}", kc.per_step(0, step_calls),
            trainer.train_steps.graphs, card)
        log(f"  examples/s eager {1e3 * cfg.data.batch_size / times['eager']['p50']:.1f}, graphed "
            f"{1e3 * cfg.data.batch_size / times['graphed']['p50']:.1f}; launches per step "
            f"{step_calls} chunk fwd, {step_calls} chunk bwd, 1 count, 1 lse fwd, 1 lse bwd")
        # the chunk backward zero-fills nothing: a step launches 2 x step_calls
        # fewer kernels than with the atomic design's zeroed dk and dv; the lse
        # backward's call launches two (the walk and dcat's rounding)
        expected = 4923 if zigzag else 1355
        log(f"  profiled launches of an eager {layout} step: {times['eager']['launches']:.0f}, "
            f"expected {expected} (the zero-filling design's {expected + 2 * step_calls} less "
            f"{2 * step_calls} fills); of a graphed step: {times['graphed']['launches']:.0f}")
        if zigzag:
            ring_eval_read(trainer, kc, step_calls, cfg.data.batch_size, card)
        del trainer, batches
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def ring_eval_read(trainer, kc: Counts, calls: int, batch_size: int, card: str) -> None:
    """The ring's eval batches, forward only (the chunk forward is the one
    attention kernel that runs there), eager and graphed: p50 of 8 synced
    batches of the validation split, their launches, a torch.profiler batch."""
    trainer.model.eval()
    candidates = trainer.candidate_fn()
    batches = [trainer._put(b) for _, b in zip(range(4), trainer.data.loader("val"))]
    with torch.no_grad():
        times = eager_and_graphed(kc, {
            "eager": lambda i: trainer.eval_step(batches[i % 4], candidates),
            "graphed": lambda i: trainer.eval_steps([batches[i % 4]], candidates),
        }, f"ring eval batch, zigzag, batch {batch_size}", [0, 0, 0, 0, 0, calls, 0],
            trainer.eval_steps.graphs, card)
    log(f"  examples/s eager {1e3 * batch_size / times['eager']['p50']:.1f}, graphed "
        f"{1e3 * batch_size / times['graphed']['p50']:.1f}; launches per batch {calls} chunk "
        f"fwd, nothing else counted")
    trainer.model.train()


def ring_against_unsharded() -> None:
    """One loss and its gradients on the card through the ring model, zigzag
    and contiguous, against the same weights at sp_shards=1 (the fused
    attention kernels): the first full-width padded batch of
    ml-20m-hstu-long, the same negatives, dropout off."""
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.models.model import build_model
    from mygenerativerecommenders_tpu_torch.train.task_retrieval import make_loss_fn

    base = LONG_ARGS + ["data.pack_sequences=false", f"data.synthetic_num_users={RING_USERS}"]
    cfg = parse_args(base)
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    resolve(cfg, data.max_item_id)
    batch = next(iter(data.loader("train")))
    rows, n = batch["ids"].shape[0], batch["ids"].shape[1] + cfg.model.gr_output_length + 1
    offsets = torch.randint(
        0, len(data.all_item_ids), (rows, n - 1, cfg.model.loss.num_to_sample),
        generator=torch.Generator().manual_seed(3), dtype=torch.int32,
    ).cuda()
    dev_batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    results = {}
    for layout, extra in (("sp_shards=1", []),
                          ("zigzag", ["model.encoder.sp_shards=4", "model.encoder.sp_zigzag=true"]),
                          ("contiguous", ["model.encoder.sp_shards=4"])):
        lcfg = parse_args(base + extra)
        resolve(lcfg, data.max_item_id)
        model = build_model(lcfg, device="cuda", seed=99)  # eval mode: dropout off
        loss = make_loss_fn(model, lcfg, data.all_item_ids)(dev_batch, neg_offsets=offsets)
        loss.backward()
        results[layout] = (loss.item(), {k: p.grad.detach().clone()
                                         for k, p in model.named_parameters()})
        del model, loss
        torch.cuda.empty_cache()
    loss_ref, grads_ref = results.pop("sp_shards=1")
    for layout, (loss, grads) in results.items():
        rel = abs(loss - loss_ref) / abs(loss_ref)
        log(f"ring ({layout}, sp_shards=4) vs sp_shards=1 on the card, {cfg.experiment} at full "
            f"width, a padded batch of {rows} rows x {n}: loss {loss:.6f} vs {loss_ref:.6f}, "
            f"relative difference {rel:.3e} (rtol {STEP_LOSS_RTOL})")
        check(rel <= STEP_LOSS_RTOL, f"the {layout} ring's loss disagrees with sp_shards=1")
        worst, worst_name, ok_all = 0.0, "", True
        for name, want in grads_ref.items():
            ok, err = within(grads[name], want, STEP_GRAD_RTOL, STEP_GRAD_ATOL)
            ok_all = ok_all and ok
            if err >= worst:
                worst, worst_name = err, name
            if not ok:
                log(f"  grad {name}: max_abs_err {err:.3e}, max |grad| "
                    f"{float(want.abs().max()):.3e}: outside rtol {STEP_GRAD_RTOL} atol "
                    f"{STEP_GRAD_ATOL}")
        log(f"  all {len(grads_ref)} gradients within rtol {STEP_GRAD_RTOL} atol {STEP_GRAD_ATOL}: "
            f"{ok_all}; largest difference {worst:.3e} in {worst_name} (max |grad| "
            f"{float(grads_ref[worst_name].abs().max()):.3e})")
        check(ok_all, f"a gradient of the {layout} ring disagrees with sp_shards=1")


# ---------------------------------------------------------------- phases 11 and 12 (ranking)

RANK_ARGS = ["experiment=synthetic-rank"]
# 30 epochs of synthetic-rank: the JAX package's own bars for its ranking
# recipe (tests/test_train_e2e.py:278-280); chance is 0.5 and about 0.2
MIN_TEST_AUROC, MIN_TEST_PRECISION = 0.62, 0.25


def run_ranking_path(kc: Counts, card: str) -> dict:
    """`cli.train.main` on the card at the full width of synthetic-rank (the
    ranking task: interleaved item and rating tokens, N = 2 x 211), graphed,
    then a second trainer stepped by hand for times. -> launch counts of the
    first."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    epochs = 30
    out_dir = OUT_DIR / "rank"
    args = RANK_ARGS + [
        f"trainer.output_dir={out_dir}", f"trainer.max_epochs={epochs}",
        "trainer.log_every_n_steps=1",
    ]
    name = "synthetic-rank"
    metrics = out_dir / name / "metrics.jsonl"
    metrics.unlink(missing_ok=True)
    cfg = cli_train.parse_args(args)
    check(cfg.trainer.device == "cuda" and cfg.model.task == "ranking"
          and cfg.trainer.steps_per_call > 1, "not the graphed ranking card path")
    kc.reset()
    t0 = time.perf_counter()
    monitored = cli_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graph_counts = kc.read(), kc.read_graphs()

    blocks = cfg.model.encoder.num_blocks
    n_in = cfg.data.max_sequence_length + cfg.model.gr_output_length + 1
    per_epoch = -(-cfg.data.synthetic_num_users // cfg.data.batch_size)
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    ran = sum(1 for r in rows if "val/ap" in r)  # early stopping may end the run sooner
    check(cfg.trainer.min_epochs <= ran <= epochs, f"{ran} epochs ran")
    eval_batches = (ran + 1) * per_epoch  # validation each epoch, then the test pass
    log(f"ranking path: cli.train on {card}, {name}: D={cfg.model.item_embedding_dim} "
        f"blocks={blocks} H={cfg.model.encoder.num_heads} N={n_in} input positions, {2 * n_in} "
        f"encoder tokens, R={cfg.model.preprocessor.num_ratings} rating classes, batch="
        f"{cfg.data.batch_size}, dropout={cfg.model.encoder.linear_dropout_rate}, steps_per_call="
        f"{cfg.trainer.steps_per_call}: {ran} epochs, {ran * per_epoch} optimizer steps, "
        f"{eval_batches} eval batches in {wall:.2f} s; launches {counts}")
    losses, steps, val, test = read_training_run(
        metrics, ran, monitored, key="ap",
        chance=f"log {cfg.model.preprocessor.num_ratings} = {np.log(6):.4f} at uniform scores")
    check(steps == ran * per_epoch, f"{steps} optimizer steps, expected {ran * per_epoch}")
    best = max(val, key=lambda r: r["val/ap"])
    log(f"  val/ap first epoch {val[0]['val/ap']:.5f}, best {best['val/ap']:.5f} (epoch "
        f"{best['epoch']}), last {val[-1]['val/ap']:.5f}; test on the best checkpoint: auroc "
        f"{test['test/auroc']:.5f}, ap {test['test/ap']:.5f}, precision "
        f"{test['test/precision']:.5f}, recall {test['test/recall']:.5f} (bars: auroc > "
        f"{MIN_TEST_AUROC}, precision > {MIN_TEST_PRECISION})")
    check(test["test/auroc"] > MIN_TEST_AUROC, f"test auroc {test['test/auroc']} too low")
    check(test["test/precision"] > MIN_TEST_PRECISION,
          f"test precision {test['test/precision']} too low")
    check(test["test/precision"] == test["test/recall"], "precision and recall differ")
    check(graph_counts.get("train") and graph_counts.get("eval"),
          "the ranking run did not replay graphed steps and eval batches")
    check_step_launches(kc, steps, eval_batches, counts, graph_counts, attn=blocks, lse=0)
    for ckpt in ("best.pt", "last.pt"):
        check((out_dir / name / "checkpoints" / ckpt).exists(), f"no {ckpt}")

    # a second trainer, stepped by hand: the eager and the graphed step
    trainer = Trainer(cli_train.parse_args(RANK_ARGS + [f"trainer.output_dir={OUT_DIR / 'rank2'}"]))
    trainer.model.train()
    batches = [trainer._put(b) for _, b in zip(range(8), trainer.data.loader("train"))]
    n = len(batches)
    times = eager_and_graphed(kc, {
        "eager": lambda i: trainer.train_step(batches[i % n], trainer.lr1),
        "graphed": lambda i: trainer.train_steps([batches[i % n]], trainer.lr1),
    }, f"ranking train step, batch {cfg.data.batch_size} ({2 * n_in} tokens a row)",
        kc.per_step(blocks, 0, lse=0), trainer.train_steps.graphs, card, reps=40)
    log(f"  examples/s at the synced p50: eager "
        f"{1e3 * cfg.data.batch_size / times['eager']['p50']:.1f}, graphed "
        f"{1e3 * cfg.data.batch_size / times['graphed']['p50']:.1f} on {card}")
    trainer.model.eval()
    val_batches = [trainer._put(b) for _, b in zip(range(4), trainer.data.loader("val"))]
    with torch.no_grad():
        eager_and_graphed(kc, {
            "eager": lambda i: trainer.eval_step(val_batches[i % 4]),
            "graphed": lambda i: trainer.eval_steps([val_batches[i % 4]]),
        }, f"ranking eval batch, batch {cfg.data.batch_size}", [blocks, 0, 0, 0, 0, 0, 0],
            trainer.eval_steps.graphs, card)
    return counts


def card_against_cpu_ranking_step(packed: bool) -> None:
    """Phase 5 for the ranking loss: the first padded train batch of
    synthetic-rank, or its first packed batch (data.pack_sequences=true, one
    capacity class of 256 tokens, 512 after the interleaving)."""
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.data.packing import PackedBatchLoader
    from mygenerativerecommenders_tpu_torch.train.task_ranking import make_loss_fn

    cfg = parse_args(RANK_ARGS + (["data.pack_sequences=true"] if packed else []))
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    resolve(cfg, data.max_item_id)
    if packed:
        cap = (cfg.data.max_sequence_length + 1 + 127) // 128 * 128  # the trainer's one class
        batch = next(iter(PackedBatchLoader(data.dataset("train"), rows_per_batch=1,
                                            row_capacity=cap,
                                            segments_per_batch=cfg.data.batch_size)))
        what = (f"synthetic-rank, a packed batch of {batch['ids'].shape[0]} rows x {cap} "
                f"({int(batch['num_segments'].sum())} examples)")
    else:
        batch = next(iter(data.loader("train")))
        what = f"synthetic-rank, a batch of {batch['ids'].shape[0]} rows"
    compare_card_and_cpu(
        what, cfg, batch, lambda model, b, device: make_loss_fn(model, cfg, packed)(b))


# ---------------------------------------------------------------- phase 10


def graphed_against_eager(cases=None, steps: int = 3, data=None) -> None:
    """The graphed step against the eager step on the card: two trainers of
    one configuration (the same seeds, so the same weights, negatives and
    dropout streams; dropout on), steps_per_call=1 (eager) and 8 (graphed),
    `steps` optimizer steps each on one batch: the losses at phase 5's rtol and
    the parameters at its gradients' rtol / atol. By default a padded
    synthetic-hstu batch, packed ml-20m-hstu-long batches of class 256 then
    1152, a zigzag ring batch, and a padded and a packed synthetic-rank batch
    (the ranking graph binds no negatives' buffer); `cases` as
    [(label, args, [packed class or None])] otherwise, `data` their RecoData
    when the caller has built it."""
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    cases = cases or [
        ("synthetic-hstu, padded", ["experiment=synthetic-hstu"], [None]),
        ("ml-20m-hstu-long, packed", LONG_ARGS[:2] + ["data.synthetic_max_seq_len=1200"],
         [256, 1152]),
        ("ml-20m-hstu-long, zigzag ring", RING_ARGS + [f"data.synthetic_num_users={RING_USERS}"],
         [None]),
        ("synthetic-rank, padded", RANK_ARGS, [None]),
        ("synthetic-rank, packed", RANK_ARGS + ["data.pack_sequences=true"], [None]),
    ]
    for label, args, classes in cases:
        eager, graphed = (
            Trainer(parse_args(args + [f"trainer.steps_per_call={k}",
                                       f"trainer.output_dir={OUT_DIR / 'graphed_vs_eager'}"]),
                    data=data)
            for k in (1, 8)
        )
        for t in (eager, graphed):
            t.model.train()
        for cap in classes:
            loader = eager._loader("train", packed=eager._packed)
            host = next(b for b in loader if cap is None or b["ids"].shape[1] == cap)
            batch = eager._put(host)
            torch.manual_seed(17)
            want = torch.stack([eager.train_step(batch, eager.lr1, eager.lr2)
                                for _ in range(steps)]).cpu()
            torch.manual_seed(17)
            got = graphed.train_steps([batch] * steps, graphed.lr1, graphed.lr2).cpu()
            rel = float(((got - want).abs() / want.abs()).max())
            what = f"{label}" + (f" class {cap}" if cap else "") + f", {host['ids'].shape[0]} rows"
            ok_all, worst, worst_name = True, 0.0, ""
            for (name, p), q in zip(eager.model.named_parameters(), graphed.model.parameters()):
                ok, err = within(q, p, STEP_GRAD_RTOL, STEP_GRAD_ATOL)
                ok_all = ok_all and ok
                if err >= worst:
                    worst, worst_name = err, name
                if not ok:
                    log(f"  {name}: max_abs_err {err:.3e} outside rtol {STEP_GRAD_RTOL} atol "
                        f"{STEP_GRAD_ATOL}")
            log(f"graphed vs eager, {steps} step(s) on one batch, {what}: losses {got.tolist()} vs "
                f"{want.tolist()}, largest relative difference {rel:.3e} (rtol {STEP_LOSS_RTOL}); "
                f"parameters within rtol {STEP_GRAD_RTOL} atol {STEP_GRAD_ATOL}: {ok_all}, largest "
                f"difference {worst:.3e} in {worst_name}; {len(graphed.train_steps.graphs)} graphs")
            check(rel <= STEP_LOSS_RTOL, f"{what}: the graphed losses disagree with the eager ones")
            check(ok_all, f"{what}: the graphed parameters disagree with the eager ones")
        del eager, graphed
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phases 13 and 14 (10M items)

# synthetic-large-vocab on one card: the JAX package's one-chip overlay
LARGE_ARGS = ["experiment=synthetic-large-vocab", "model.embedding.kind=local",
              "model.embedding.num_shards=1"]
SHARED = ["model.loss.shared_negatives=true"]
LAZY = SHARED + ["model.embedding.lazy_update=true"]
LARGE_RUN_USERS = 2048  # phase 13's cli.train: cut from 4,096 for phase 24's time
# the hand-stepped trainers: (a) the preset as it stands, the gather loss
# (64 x 211 x 10M is past the 3e9 gate) with dense fused AdamW; (b') shared
# negatives with dense fused AdamW; (b) the lazy overlay
LARGE_VARIANTS = {"(a) gather + dense AdamW": [], "(b') shared + dense AdamW": SHARED,
                  "(b) shared + lazy update": LAZY}
# the optimizer's profiler ranges, outermost first: the lazy one's and the
# split one's (AdamW and Muon / Scion) around torch's
OPTIMIZER_RANGES = ("LazyEmbeddingAdamW.step", "SplitOptimizer.step",
                    "Optimizer.step#AdamW.step")


# phase 13's one-card overlay: the int8 recall and each hand-stepped
# variant's peak memory and graphed device ms, printed beside phase 21's
PHASE13: dict = {}


def gb(nbytes: float) -> str:
    return f"{nbytes / 1e9:.2f} GB"


def peak() -> str:
    return gb(torch.cuda.max_memory_allocated())


def profile_optimizer(fn, reps: int) -> tuple[float, float, float]:
    """torch.profiler over `reps` eager steps: (device ms of every kernel,
    device ms under the optimizer's range, device ms of the fused AdamW
    kernels) a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    total = sum(e.self_device_time_total for e in kernels)
    adam = sum(e.self_device_time_total for e in kernels if "FusedAdam" in e.key)
    ranges = {e.key: e.device_time_total for e in events if e.device_type == DeviceType.CPU}
    # the lazy range holds the AdamW's of the other parameters: count it alone where it ran
    opt = next((ranges[k] for k in OPTIMIZER_RANGES if k in ranges), 0.0)
    return total / 1e3 / reps, opt / 1e3 / reps, adam / 1e3 / reps


def run_large_vocab_path(kc: Counts, card: str):
    """Phase 13: synthetic-large-vocab at full width on the card. -> (the
    launch counts of its cli.train run and engine calls, the data)."""
    import shutil
    import tempfile

    from mygenerativerecommenders_tpu_torch.checkpoint import CheckpointManager
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData

    cfg = cli_train.parse_args(LARGE_ARGS)
    t0 = time.perf_counter()
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    for split in ("train", "val", "test"):
        data.dataset(split)
    x, max_id = len(data.all_item_ids), data.max_item_id
    log(f"synthetic-large-vocab data: {x:,} catalog items (max id {max_id:,}), "
        f"{cfg.data.synthetic_num_users} users, built in {time.perf_counter() - t0:.2f} s "
        f"(the catalog's cdf once, one rng.random draw a user)")
    d, blocks = cfg.model.item_embedding_dim, cfg.model.encoder.num_blocks
    n = cfg.data.max_sequence_length + cfg.model.gr_output_length + 1
    r = cfg.model.loss.num_to_sample
    check(x == 10_000_000 and d == 64 and blocks == 4 and r == 512, "not the preset's widths")

    tmp = Path(tempfile.mkdtemp(prefix="large_vocab_", dir=OUT_DIR))
    saves = []
    save = CheckpointManager.save

    def timed_save(self, *a, **k):
        t = time.perf_counter()
        save(self, *a, **k)
        saves.append(time.perf_counter() - t)

    # the run's depth cut: LARGE_RUN_USERS of the preset's 4,096 users, four
    # steps a call (eight logged losses)
    epochs = 1
    args = LARGE_ARGS + LAZY + [
        f"trainer.output_dir={tmp}", f"trainer.max_epochs={epochs}", "trainer.min_epochs=1",
        "trainer.steps_per_call=4", "trainer.log_every_n_steps=1",
        f"data.synthetic_num_users={LARGE_RUN_USERS}",
    ]
    try:
        torch.cuda.reset_peak_memory_stats()
        kc.reset()
        CheckpointManager.save = timed_save
        t0 = time.perf_counter()
        try:
            monitored = cli_train.main(args)
        finally:
            CheckpointManager.save = save
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, graph_counts = kc.read(), kc.read_graphs()
        per_epoch = -(-LARGE_RUN_USERS // cfg.data.batch_size)
        eval_batches = 2 * per_epoch  # validation after the epoch, then the test pass
        log(f"large-vocab path: cli.train (b) on {card}, D={d} blocks={blocks} "
            f"H={cfg.model.encoder.num_heads} N={n} batch={cfg.data.batch_size} R={r} "
            f"shared negatives, lazy update, int8 index (over-fetch "
            f"{cfg.model.index.rescore_over_fetch}), steps_per_call=4, {LARGE_RUN_USERS} "
            f"users (cut from 4,096): {per_epoch} optimizer "
            f"steps and {eval_batches} eval batches in {wall:.2f} s; peak memory {peak()}; "
            f"checkpoint saves {', '.join(f'{s:.2f}' for s in saves)} s "
            f"({gb(sum(f.stat().st_size for f in tmp.rglob('last.pt')))} each); launches {counts}")
        metrics = tmp / "synthetic-large-vocab" / "metrics.jsonl"
        losses, steps, val, test = read_training_run(
            metrics, epochs, monitored, chance=f"log {r + 1} = {np.log(r + 1):.4f}")
        check(steps == per_epoch, f"{steps} optimizer steps, expected {per_epoch}")
        log(f"  val/ndcg@100 {val[0]['val/ndcg@100']:.5f}, test ndcg@10 "
            f"{test['test/ndcg@10']:.5f}, hr@200 {test['test/hr@200']:.5f} after one epoch")
        check(graph_counts.get("train") and graph_counts.get("eval"),
              "the cli.train run did not replay graphed steps and eval batches")
        check_step_launches(kc, steps, eval_batches, counts, graph_counts, attn=blocks, lse=0)
        check(len(saves) == 1, f"{len(saves)} checkpoint saves, expected 1")
        serve_counts = serve_large_vocab(kc, card, tmp / "synthetic-large-vocab" / "checkpoints"
                                        / "best.pt", data)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    step_large_vocab_by_hand(kc, card, data)
    return {key: counts[key] + serve_counts.get(key, 0) for key in counts}, data


def serve_large_vocab(kc: Counts, card: str, ckpt: Path, data) -> dict:
    """The trained checkpoint behind the HTTP server with the int8 index:
    /v1/retrieve and greedy /v1/generate with 32 rows, graphed against eager,
    and the int8 scan against the exact one on the same queries."""
    from mygenerativerecommenders_tpu_torch.cli.serve import build_engine
    from mygenerativerecommenders_tpu_torch.ops.quantized_topk import (
        QuantizedCatalog,
        mips_top_k_int8,
    )
    from mygenerativerecommenders_tpu_torch.ops.sequence import get_current_embeddings
    from mygenerativerecommenders_tpu_torch.ops.topk import mips_top_k
    from mygenerativerecommenders_tpu_torch.serving.service import RecommenderHTTPServer
    from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch

    t0 = time.perf_counter()
    engine, _ = build_engine(LARGE_ARGS + [f"trainer.ckpt_path={ckpt}"])
    check(engine.device.type == "cuda" and engine.graphed, "the engine is not graphed on the card")
    check(isinstance(engine.candidates, QuantizedCatalog), "the engine's index is not int8")
    log(f"large-vocab engine from the trained checkpoint in {time.perf_counter() - t0:.2f} s; "
        f"peak memory {peak()}")
    catalog = np.asarray(data.all_item_ids)
    in_catalog = np.zeros(data.max_item_id + 1, dtype=bool)
    in_catalog[catalog] = True
    rng = np.random.default_rng(13)
    lens = np.concatenate([[1, 200, 250], rng.integers(2, 200, size=29)])
    rows = [rng.choice(catalog, size=int(m)).tolist() for m in lens]
    stamps = [np.sort(978_000_000 + rng.integers(0, 10**8, size=len(q))).tolist() for q in rows]
    req = {"sequences": rows, "timestamps": stamps}
    k = engine.cfg.model.index.k

    def check_ids(body_ids, what):
        for hist, ids in zip(rows, body_ids):
            ids = np.asarray(ids)
            check(bool(in_catalog[ids].all()), f"{what}: an id outside the catalog")
            check(not set(hist[-engine.max_len:]) & set(ids.tolist()),
                  f"{what}: an id from the row's own history")

    server = RecommenderHTTPServer(engine, "127.0.0.1", 0).start()
    try:
        http(server.port, "/v1/retrieve", req)  # the captures, before the counts
        http(server.port, "/v1/generate", {**req, "steps": 11, "mode": "greedy"})
        kc.reset()
        engine.calls = 0
        retrieve_ms, generate_ms = [], []
        for _ in range(10):
            body, sec = http(server.port, "/v1/retrieve", req)
            retrieve_ms.append(1e3 * sec)
        gen, sec = http(server.port, "/v1/generate", {**req, "steps": 11, "mode": "greedy"})
        generate_ms.append(1e3 * sec)
        counts, graph_counts, calls = kc.read(), kc.read_graphs(), engine.calls
    finally:
        server.stop()
    blocks = engine.cfg.model.encoder.num_blocks
    check(counts[kc.attn.KERNEL] == blocks * calls == blocks * 11,
          f"{counts[kc.attn.KERNEL]} attention launches for {calls} engine calls")
    check(graph_counts["serve"]["replays"] == 11 and not graph_counts["serve"].get("captures"),
          f"engine calls not all replays: {graph_counts}")
    for scores in body["scores"]:
        check(len(scores) == k and bool(np.all(np.diff(scores) <= 0)), "retrieve scores")
    check_ids(body["ids"], "/v1/retrieve")
    check_ids(gen["ids"], "/v1/generate greedy")
    p = np.percentile
    log(f"large-vocab /v1/retrieve, 32 rows, k={k}, int8 pre-rank of {engine.all_item_ids.size:,}"
        f" items then {engine.cfg.model.index.rescore_over_fetch * k} exact: p50 "
        f"{p(retrieve_ms, 50):.3f} ms, p99 {p(retrieve_ms, 99):.3f} ms over 10 requests; "
        f"/v1/generate greedy, steps=11: {generate_ms[0]:.3f} ms; launches {counts} on {card}")
    log(f"  sample mode is not driven here: its Gumbel buffer [steps, B, X] would be "
        f"{gb(11 * 32 * engine.all_item_ids.size * 4)}")

    eager = eager_twin(engine)
    got, want = engine.retrieve(rows, stamps), eager.retrieve(rows, stamps)
    check(got[0] == want[0] and got[1] == want[1], "graphed and eager large-vocab answers differ")
    check(engine.generate(rows, stamps, steps=11) == eager.generate(rows, stamps, steps=11),
          "graphed and eager greedy ids differ")
    log("graphed and eager large-vocab engines: the same ids and scores, bit for bit "
        "(retrieve and greedy generate)")
    engines_side_by_side("large-vocab retrieve, 32 rows, int8", card, {
        name: (lambda e=e: e.retrieve(rows, stamps)) for name, e in (("eager", eager),
                                                                   ("graphed", engine))
    }, reps=10, profiled=3)

    # the int8 index against the exact scan on the engine's own queries
    batch, _ = engine._pack(rows, stamps)
    with torch.no_grad():
        dev = {key: torch.from_numpy(v).cuda() for key, v in batch.items()}
        seq, _, _ = seq_features_from_batch(dev, engine.cfg.model.gr_output_length + 1)
        seq = seq._replace(past_embeddings=engine.model.item_embeddings(seq.past_ids))
        encoded, lengths = engine.model(seq)
        queries = get_current_embeddings(lengths, encoded)
        cat_t = torch.as_tensor(catalog.astype(np.int64), device="cuda")
        cands = engine.candidates
        q_ids, q_scores = mips_top_k_int8(queries, cands, cat_t, k, invalid_ids=seq.past_ids,
                                          max_item_id=data.max_item_id)
        e_ids, e_scores = mips_top_k(queries, cands.exact, cat_t, k, invalid_ids=seq.past_ids,
                                     max_item_id=data.max_item_id)
        int8_ms = device_ms(lambda: mips_top_k_int8(
            queries, cands, cat_t, k, invalid_ids=seq.past_ids, max_item_id=data.max_item_id), 5)
        exact_ms = device_ms(lambda: mips_top_k(
            queries, cands.exact, cat_t, k, invalid_ids=seq.past_ids,
            max_item_id=data.max_item_id), 5)
    q_ids, e_ids = q_ids.cpu().numpy(), e_ids.cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(q_ids, e_ids)]))
    agree = q_ids == e_ids
    rel = float(((q_scores - e_scores).abs() / e_scores.abs()).cpu().numpy()[agree].max())
    log(f"int8 + exact re-score against the exact scan, 32 queries, k={k}, X={len(catalog):,}: "
        f"recall {recall:.4f} (the JAX package's bar 0.95), {int(agree.sum())} of {agree.size} "
        f"ranks the same id, largest relative score difference there {rel:.3e} (rtol 1e-5); "
        f"device {int8_ms:.3f} ms int8 vs {exact_ms:.3f} ms exact a call on {card}")
    check(recall >= 0.95, f"int8 recall {recall} below 0.95")
    check(rel <= 1e-5, "the re-scored scores are not the exact inner products")
    PHASE13.update(recall=recall)
    del engine, eager
    return counts


def step_large_vocab_by_hand(kc: Counts, card: str, data) -> None:
    """(a), (b') and (b) stepped by hand, eager against graphed, with their
    peak memory and the optimizer's share of the eager step's device time."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    for label, extra in LARGE_VARIANTS.items():
        torch.cuda.reset_peak_memory_stats()
        held = gb(torch.cuda.memory_allocated())  # before this trainer
        t0 = time.perf_counter()
        trainer = Trainer(cli_train.parse_args(LARGE_ARGS + extra + [
            "trainer.steps_per_call=8", f"trainer.output_dir={OUT_DIR / 'large_by_hand'}"]),
            data=data)
        log(f"large-vocab trainer {label}: model and optimizer built in "
            f"{time.perf_counter() - t0:.2f} s; {gb(torch.cuda.memory_allocated())} allocated on "
            f"the card ({held} before it)")
        trainer.model.train()
        batches = [trainer._put(b) for _, b in zip(range(4), trainer.data.loader("train"))]
        blocks = trainer.cfg.model.encoder.num_blocks
        times = eager_and_graphed(kc, {
            "eager": lambda i: trainer.train_step(batches[i % 4], trainer.lr1),
            "graphed": lambda i: trainer.train_steps([batches[i % 4]], trainer.lr1),
        }, f"large-vocab step {label}", kc.per_step(blocks, 0, lse=0),
            trainer.train_steps.graphs, card, reps=8)
        dev, opt, adam = profile_optimizer(
            lambda i: trainer.train_step(batches[i % 4], trainer.lr1), reps=3)
        table = trainer.model.embeddings._item_emb.weight
        line = (f"  {label}: peak memory {peak()} ({held} held before the trainer); eager "
                f"step device {dev:.3f} ms, optimizer "
                f"{opt:.3f} ms ({100 * opt / dev:.1f}%)")
        if "dense" in label:
            # fused AdamW over the table: read p, g, m, v and write p, m, v
            traffic = 7 * table.numel() * 4
            line += (f"; fused AdamW kernels {adam:.3f} ms against {gb(traffic)} of table "
                     f"traffic, {traffic / PEAK_BYTES_PER_S * 1e3:.3f} ms at the peak rate "
                     f"({traffic / (adam / 1e3) / 1e9:.0f} GB/s reached)")
        log(line + f"; graphed p50 {times['graphed']['p50']:.3f} ms on {card}")
        PHASE13[label] = dict(peak=peak(), device_ms=times["graphed"]["device_ms"],
                              p50=times["graphed"]["p50"])
        del trainer, batches, table  # the table holds its dense gradient too
        gc.collect()
        torch.cuda.empty_cache()


# rows of phase 14 (a)'s card-against-CPU batch, cut from the batch's 64 to 16
# for phase 24's time and to 8 for phase 24 (d)'s (the CPU's gather loss at
# 10M items)
LARGE_CPU_ROWS = 8


def large_vocab_card_against_cpu(data) -> None:
    """Phase 14, first half: one step of (a) and one of (b) on the card and on
    the CPU, the same weights, batch and negatives, dropout off; (a) on the
    loss and every gradient, (b) on the parameters, `mv` and the count after
    the step (`check_lazy_step`)."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.models.model import build_model
    from mygenerativerecommenders_tpu_torch.train.lazy_embedding import init_lazy_optimizer
    from mygenerativerecommenders_tpu_torch.train.task_retrieval import (
        make_loss_fn,
        make_train_step,
    )

    batch = next(iter(data.loader("train")))
    ids = data.all_item_ids
    cfg = cli_train.parse_args(LARGE_ARGS)
    resolve(cfg, data.max_item_id)
    r = cfg.model.loss.num_to_sample
    gen = torch.Generator().manual_seed(3)
    # (a) on LARGE_CPU_ROWS of the batch and of its draw (the CPU side's depth
    # cut; the whole batch's draw keeps the generator where (b) draws from it)
    rows = {k: v[:LARGE_CPU_ROWS] for k, v in batch.items()}
    n = batch["ids"].shape[1] + cfg.model.gr_output_length
    offsets = torch.randint(0, len(ids), (batch["ids"].shape[0], n, r), generator=gen,
                            dtype=torch.int32)[:LARGE_CPU_ROWS]
    t0 = time.perf_counter()
    compare_card_and_cpu(f"synthetic-large-vocab (a), gather loss, X={len(ids):,}, "
                         f"{LARGE_CPU_ROWS} rows", cfg, rows,
                         lambda model, b, device: make_loss_fn(model, cfg, ids)(
                             b, neg_offsets=offsets.to(device)))
    log(f"  (a) card and CPU step with both models built: {time.perf_counter() - t0:.1f} s")

    cfg = cli_train.parse_args(LARGE_ARGS + LAZY)
    resolve(cfg, data.max_item_id)
    shared = torch.randint(0, len(ids), (r,), generator=gen, dtype=torch.int32)
    after = {}
    t0 = time.perf_counter()
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device, seed=99)  # eval mode: dropout off
        table0 = model.embeddings._item_emb.weight.detach().cpu().clone()
        opt = init_lazy_optimizer(cfg, model, fused=device == "cuda")
        step = make_train_step(model, cfg, ids, opt)
        step({k: torch.as_tensor(v).to(device) for k, v in batch.items()}, cfg.optimizer1.lr,
             neg_offsets=shared.to(device))
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        state["mv"], state["count"] = opt.mv.detach().cpu(), opt.count.cpu()
        after[device] = state
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    touched = torch.zeros(table0.shape[0], dtype=torch.bool)
    touched[torch.as_tensor(batch["ids"]).long()] = True
    touched[torch.as_tensor(batch["target_id"]).long()] = True
    touched[torch.as_tensor(np.asarray(ids))[shared.long()].long()] = True
    touched[0] = True
    check_lazy_step(after, table0, touched, cfg, "synthetic-large-vocab (b)")
    log(f"  (b) card and CPU step with both models built: {time.perf_counter() - t0:.1f} s")


def check_lazy_step(after: dict, table0: torch.Tensor, touched: torch.Tensor, cfg,
                    what: str) -> None:
    """One lazy step on the card against the CPU (`after[device]`: the
    state_dict, "mv" and "count" after it). mv (the moments, so the
    gradient), the count and every parameter but the table are held card
    against CPU at rtol 5e-4 / atol 1e-6. The table is held, on each device,
    to the AdamW step that device's own moments give, computed in float64
    (rtol 5e-4 / atol 1e-6): card against CPU directly it would not be,
    because Adam's first step lr * g / (|g| + eps) turns the few-percent
    difference of a gradient near eps = 1e-8 (a softmax tail, summed in
    another order) into up to lr / 4 of that difference. Rows no step
    touched must equal the initial table bit for bit, moments zero."""
    b1, b2 = cfg.optimizer1.betas
    lr, eps, wd = cfg.optimizer1.lr, cfg.optimizer1.eps, cfg.optimizer1.weight_decay
    key = "embeddings._item_emb.weight"
    d = table0.shape[1]
    ok_all = True
    for name, want in after["cpu"].items():
        if name == key:
            continue
        ok, err = within(after["cuda"][name].double(), want.double(), STEP_GRAD_RTOL,
                         STEP_GRAD_ATOL)
        ok_all = ok_all and ok
        if not ok or name in ("mv", "count"):
            log(f"  {what}, card vs CPU after one lazy step, {name}: max_abs_err {err:.3e}, "
                f"within rtol {STEP_GRAD_RTOL} atol {STEP_GRAD_ATOL}: {ok}")
    c = float(after["cpu"]["count"])
    p0 = table0[touched].double()
    for device, state in after.items():
        mv = state["mv"][touched].double()
        m_hat, v_hat = mv[:, :d] / (1 - b1**c), mv[:, d:] / (1 - b2**c)
        want = p0 - lr * (m_hat / (torch.sqrt(v_hat) + eps) + wd * p0)
        ok, err = within(state[key][touched].double(), want, STEP_GRAD_RTOL, STEP_GRAD_ATOL)
        same = torch.equal(state[key][~touched], table0[~touched])
        zero = not bool(state["mv"][~touched].any())
        log(f"  {what} on {device}: the {int(touched.sum()):,} touched rows are the AdamW step "
            f"of its own moments (float64), max_abs_err {err:.3e}: {ok}; "
            f"{int((~touched).sum()):,} untouched rows bit for bit unchanged: {same}, "
            f"moments zero: {zero}")
        ok_all = ok_all and ok and same and zero
    diff = (after["cuda"][key] - after["cpu"][key]).abs()
    flat = int(diff.argmax())
    row, col = divmod(flat, d)
    g = [float(after[dev]["mv"][row, col]) / (1 - b1) for dev in ("cuda", "cpu")]
    log(f"  {what}: the table card vs CPU directly differs by at most {float(diff.max()):.3e}, "
        f"at row {row} col {col}, whose gradient is {g[0]:.4e} on the card and {g[1]:.4e} "
        f"on the CPU (Adam's eps {eps})")
    check(ok_all, f"{what}: the lazy step on the card disagrees with the CPU's")


def table_moments(trainer, lazy: bool) -> tuple:
    """(m, v) of the item table: the lazy update's mv, or the AdamW state."""
    table = trainer.model.embeddings._item_emb.weight
    if lazy:
        d = table.shape[1]
        return trainer.optimizer.mv[:, :d], trainer.optimizer.mv[:, d:]
    state = trainer.optimizer.state[table]
    return state["exp_avg"], state["exp_avg_sq"]


def check_adam_table(want, got, moments, opt, steps: int, what: str) -> bool:
    """The item table after `steps` Adam steps of two runs whose gradients
    differ by float32 rounding (graphed against eager: the attention
    backward's bias tables take float atomics, and every step after the
    first sees their last bits). An element whose gradient is near Adam's
    eps moves by lr * g / (|g| + eps), which turns the gradient's rounding
    into up to lr / 4 of its relative difference; so the table is held at
    rtol 5e-4 / atol 1e-6 where the bias-corrected second moment is at least
    (1000 eps)^2 in both runs (a gradient's relative difference then moves
    the step by at most 1e-3 of it), and elsewhere to the most `steps` Adam
    steps can part two runs, 2 * lr * steps, with their moments (held by the
    caller) the gradients' check. -> whether both hold."""
    lr, eps, b2 = opt.lr, opt.eps, opt.betas[1]
    floor = (1000 * eps) ** 2 * (1 - b2**steps)
    well = (moments[0][1] >= floor) & (moments[1][1] >= floor)
    ok, err = within(got[well], want[well], STEP_GRAD_RTOL, STEP_GRAD_ATOL)
    small = float((got[~well] - want[~well]).abs().max()) if bool((~well).any()) else 0.0
    ok_small = small <= 2 * lr * steps
    log(f"  {what}: the table where sqrt(v_hat) >= {1000 * eps:g} ({int(well.sum()):,} "
        f"elements) within rtol {STEP_GRAD_RTOL} atol {STEP_GRAD_ATOL}: {ok}, largest "
        f"difference {err:.3e}; the other {int((~well).sum()):,} (gradients near eps) differ "
        f"by at most {small:.3e} (bound 2 x lr x steps = {2 * lr * steps:g}): {ok_small}")
    return ok and ok_small


def large_vocab_graphed_against_eager(data) -> None:
    """Phase 14, second half: phase 10's check for (a) and (b), three graphed
    steps against three eager ones on one batch with the same injected
    negatives: the losses, every parameter but the table and the table's
    moments at phase 10's tolerances, the table by `check_adam_table`; for
    (b) the rows no step touched are unchanged, bit for bit, and their
    moments zero."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    for label, extra in (("(a)", []), ("(b)", LAZY)):
        eager, graphed = (
            Trainer(cli_train.parse_args(LARGE_ARGS + extra + [
                f"trainer.steps_per_call={k}", f"trainer.output_dir={OUT_DIR / 'large_vs'}"]),
                data=data)
            for k in (1, 8)
        )
        for t in (eager, graphed):
            t.model.train()
        host = next(iter(eager.data.loader("train")))
        batch = eager._put(host)
        r = eager.cfg.model.loss.num_to_sample
        n = host["ids"].shape[1] + eager.cfg.model.gr_output_length
        gen = torch.Generator().manual_seed(21)
        offsets = [torch.randint(0, len(eager.all_item_ids), (r,) if extra else (64, n, r),
                                 generator=gen, dtype=torch.int32).cuda() for _ in range(3)]
        table0 = eager.model.embeddings._item_emb.weight.detach().clone()
        torch.manual_seed(17)
        want = torch.stack([eager.train_step(batch, eager.lr1, neg_offsets=o)
                            for o in offsets]).cpu()
        torch.manual_seed(17)
        got = graphed.train_steps([batch] * 3, graphed.lr1, neg_offsets=offsets).cpu()
        rel = float(((got - want).abs() / want.abs()).max())
        ok_all, worst, worst_name = True, 0.0, ""
        key = "embeddings._item_emb.weight"
        moments = [table_moments(t, bool(extra)) for t in (eager, graphed)]
        pairs = [(name, p, q) for (name, p), q in zip(eager.model.named_parameters(),
                                                      graphed.model.parameters()) if name != key]
        pairs += [("table m", moments[0][0], moments[1][0]), ("table v", moments[0][1],
                                                              moments[1][1])]
        for name, p, q in pairs:
            ok, err = within(q, p, STEP_GRAD_RTOL, STEP_GRAD_ATOL)
            ok_all = ok_all and ok
            if err >= worst:
                worst, worst_name = err, name
        what = f"synthetic-large-vocab {label}, three steps on one batch of 64"
        log(f"graphed vs eager, {what}: losses {got.tolist()} vs {want.tolist()}, largest "
            f"relative difference {rel:.3e} (rtol {STEP_LOSS_RTOL}); every other parameter and "
            f"the table's moments within rtol {STEP_GRAD_RTOL} atol {STEP_GRAD_ATOL}: "
            f"{ok_all}, largest difference {worst:.3e} in {worst_name}")
        ok_all = check_adam_table(
            eager.model.embeddings._item_emb.weight.detach(),
            graphed.model.embeddings._item_emb.weight.detach(),
            moments, eager.cfg.optimizer1, 3, what) and ok_all
        check(rel <= STEP_LOSS_RTOL, f"{what}: the graphed losses disagree with the eager ones")
        check(ok_all, f"{what}: the graphed parameters disagree with the eager ones")
        if extra:
            catalog = torch.as_tensor(np.asarray(eager.all_item_ids, dtype=np.int64),
                                      device="cuda")
            touched = torch.zeros(table0.shape[0], dtype=torch.bool, device="cuda")
            touched[batch["ids"].long()] = True
            touched[batch["target_id"].long()] = True
            for o in offsets:
                touched[catalog[o.long()]] = True
            touched[0] = True
            for t, name in ((eager, "eager"), (graphed, "graphed")):
                table = t.model.embeddings._item_emb.weight.detach()
                same = torch.equal(table[~touched], table0[~touched])
                zero = not bool(t.optimizer.mv[~touched].any())
                log(f"  {name}: {int((~touched).sum()):,} untouched rows bit for bit unchanged: "
                    f"{same}, their moments zero: {zero}; count {int(t.optimizer.count)}")
                check(same and zero, f"{name} lazy steps moved an untouched row")
                check(int(t.optimizer.count) == 3, "the lazy step count is not 3")
        del eager, graphed
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 15 (files on disk)

REAL_DIR = OUT_DIR / "real"
SEQ_FIELDS = ("lengths", "ids", "ratings", "timestamps", "target_id", "target_rating",
              "target_timestamp", "user_ids")


def _title(i: int, m: int, year: int) -> str:
    """MovieLens-style titles: a comma and "The", latin-1 letters, quotes,
    no year; the rest "Movie <id> (<year>)"."""
    kind = i % 10
    if kind == 0:
        return f"Movie {m}, The ({year})"
    if kind == 1:
        return f"Café Señor {m} ({year})"
    if kind == 2:
        return f"Untitled {m}"
    if kind == 3:
        return f'"Quoted" Movie {m} ({year})'
    return f"Movie {m} ({year})"


def _zip(path: Path, files: dict) -> int:
    import zipfile

    with zipfile.ZipFile(path, "w") as z:
        for name, data in files.items():
            z.writestr(name, data)
    return path.stat().st_size


def _rating_lines(inter, fmt) -> str:
    users = np.repeat(inter.user_ids, [len(a) for a in inter.item_ids])
    cols = [np.concatenate(a) for a in (inter.item_ids, inter.ratings, inter.timestamps)]
    return "".join(fmt(u, i, r, t, j) for j, (u, i, r, t) in enumerate(zip(
        users.tolist(), *(c.tolist() for c in cols))))


def write_movielens_1m(root: Path):
    """MovieLens 1M's own format at its published counts: 6,040 users, 3,883
    listed movies of which 3,706 are rated, ids up to 3,952; the ratings the
    port's synthetic generator draws for 6,040 users (the in-memory
    synthetic-hstu draw at that size); users.dat with ml-1m's sexes, age
    groups, occupations and 3,439 zip strings. -> the interactions, the
    listed ids."""
    from mygenerativerecommenders_tpu_torch.data.synthetic import synthetic_interactions

    t0 = time.perf_counter()
    inter = synthetic_interactions(num_users=6040, num_items=3706, max_item_id=3952)
    unrated = np.setdiff1d(np.arange(1, 3952), inter.catalog)  # 3,952 listed anyway
    listed = np.union1d(inter.catalog, [3952])
    extra = np.random.default_rng(15).choice(unrated, size=3883 - len(listed), replace=False)
    listed = np.union1d(listed, extra)
    check(len(listed) == 3883 and listed[-1] == 3952, f"{len(listed)} listed movies")
    ratings = _rating_lines(inter, lambda u, i, r, t, j: f"{u}::{i}::{r}::{t}\n")
    movies = "".join(f"{m}::{_title(i, m, 1919 + m % 82)}::Drama|Comedy\n"
                     for i, m in enumerate(listed.tolist()))
    # ml-1m's user columns at its published counts: sex M/F, the 7 age groups,
    # the 21 occupations and 3,439 distinct zip strings (some ZIP+4), each
    # string held by one user at least (ml-1m-hstu-aux's table has 3,439 rows)
    zips = [f"{(z * 7919) % 99999:05d}{'-1234' if z % 50 == 0 else ''}" for z in range(3439)]
    users = "".join(
        f"{u}::{'MF'[u % 2]}::{(1, 18, 25, 35, 45, 50, 56)[u % 7]}::{u % 21}::"
        f"{zips[(u - 1) % len(zips)]}\n" for u in range(1, 6041))
    check(len(set(zips)) == 3439, "the fixture's zip strings are not 3,439 distinct ones")
    size = _zip(root / "movielens_ml-1m.zip", {
        "ml-1m/ratings.dat": ratings.encode("latin-1"),
        "ml-1m/movies.dat": movies.encode("latin-1"),
        "ml-1m/users.dat": users.encode("latin-1"),
    })
    log(f"ml-1m fixture: {sum(len(a) for a in inter.item_ids):,} ratings of 6,040 users over "
        f"3,706 of 3,883 listed movies (max id 3952), movielens_ml-1m.zip {size:,} bytes, "
        f"written in {time.perf_counter() - t0:.2f} s")
    return inter, listed


def prepare(args: list, what: str) -> float:
    """`cli.prepare_data` in a subprocess (no card), timed."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mygenerativerecommenders_tpu_torch.cli.prepare_data", *args],
        cwd=HERE, capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"prepare_data {what} failed:\n{proc.stdout}{proc.stderr}")
    log(f"  cli.prepare_data {what}: {seconds:.2f} s (a process of its own); "
        f"{proc.stdout.strip().splitlines()[-1]}")
    return seconds


def check_parsers(csv_path: Path, inter, max_len: int) -> None:
    """The native parser's splits against the plain parser's and against the
    in-memory generator's arrays for the same draw, bit for bit."""
    from mygenerativerecommenders_tpu_torch.data.dataset import SequenceDataset

    for ignore in (1, 0):
        t0 = time.perf_counter()
        nat = SequenceDataset.from_csv(str(csv_path), max_len, ignore, parser="native")
        t1 = time.perf_counter()
        py = SequenceDataset.from_csv(str(csv_path), max_len, ignore, parser="python")
        t2 = time.perf_counter()
        mem = SequenceDataset.from_sequences(
            zip(inter.item_ids, inter.ratings, inter.timestamps), inter.user_ids, max_len, ignore)
        for f in SEQ_FIELDS:
            a, b, c = getattr(nat, f), getattr(py, f), getattr(mem, f)
            check(a.dtype == b.dtype == c.dtype and np.array_equal(a, b) and np.array_equal(a, c),
                  f"{f} of the {'train' if ignore else 'test'} split differs between the parsers")
        log(f"  {'train' if ignore else 'test'} split ({len(nat)} users, L={max_len}): native "
            f"parser {t1 - t0:.3f} s, plain parser {t2 - t1:.3f} s; every array equal to the "
            f"other parser's and to the in-memory draw's")


def _finite_run(metrics: Path, what: str) -> tuple:
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = np.asarray([r["train/loss"] for r in rows if "train/loss" in r])
    test = [r for r in rows if any(k.startswith("test/") for k in r)]
    check(len(losses) > 0 and bool(np.isfinite(losses).all()), f"{what}: a non-finite loss")
    check(len(test) == 1, f"{what}: no test row")
    return losses, test[0]


def run_real_data_path(kc: Counts, card: str) -> tuple:
    """Phase 15: ml-1m-hstu at full width and size from a MovieLens-format zip
    (prepare, 30 graphed epochs, eval, predict, a Lightning .ckpt), then
    ml-20m-hstu-long and amzn-books from files at cut depth. -> (the ml-1m
    runs' launch counts, the other two runs', {"root": the ml-1m data
    directory, "test": the 30-epoch run's test row})."""
    import csv as csv_module
    import shutil

    from mygenerativerecommenders_tpu_torch.cli import convert_ckpt as cli_convert
    from mygenerativerecommenders_tpu_torch.cli import eval as cli_eval
    from mygenerativerecommenders_tpu_torch.cli import predict as cli_predict
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.ops.topk import topk_agree
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    shutil.rmtree(REAL_DIR, ignore_errors=True)
    root = REAL_DIR / "ml-1m"
    root.mkdir(parents=True)
    inter, listed = write_movielens_1m(root)
    base = ["experiment=ml-1m-hstu", f"data.data_dir={root}"]
    prepare(base, "experiment=ml-1m-hstu")
    check_parsers(root / "processed" / "ml-1m" / "sasrec_format.csv", inter, 200)
    cfg = cli_train.parse_args(base)
    t0 = time.perf_counter()
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    for split in ("train", "val", "test"):
        data.dataset(split)
    data_s = time.perf_counter() - t0
    check(data.all_item_ids.tolist() == listed.tolist() and data.max_item_id == 3952,
          "the catalog is not movies.csv's 3,883 listed ids with max id 3952")
    check(data.year_of_item is not None and int(data.year_of_item[listed[1]]) > 1900,
          "no year_of_item")

    epochs, out = 30, REAL_DIR / "out"
    args = base + [f"trainer.output_dir={out}", f"trainer.max_epochs={epochs}",
                   f"trainer.min_epochs={epochs}", "trainer.log_every_n_steps=1"]
    metrics = out / "ml-1m-hstu" / "metrics.jsonl"
    kc.reset()
    t0 = time.perf_counter()
    monitored = cli_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graph_counts = kc.read(), kc.read_graphs()
    blocks = cfg.model.encoder.num_blocks
    per_epoch = -(-6040 // cfg.data.batch_size)
    eval_batches = (epochs + 1) * per_epoch
    log(f"real-data path: cli.train on {card}, ml-1m-hstu from files, D="
        f"{cfg.model.item_embedding_dim} blocks={blocks} H={cfg.model.encoder.num_heads} "
        f"N={cfg.data.max_sequence_length + cfg.model.gr_output_length + 1} "
        f"batch={cfg.data.batch_size} R={cfg.model.loss.num_to_sample} X={len(listed)}, "
        f"steps_per_call={cfg.trainer.steps_per_call}: {epochs * per_epoch} optimizer steps, "
        f"{eval_batches} eval batches in {wall:.2f} s ({epochs * 6040 / wall:.1f} training "
        f"examples/s end to end); data (RecoData on the processed files, three splits) "
        f"{data_s:.2f} s; launches {counts}")
    losses, steps, val, test = read_training_run(metrics, epochs, monitored)
    check(steps == epochs * per_epoch, f"{steps} optimizer steps, expected {epochs * per_epoch}")
    log(f"  test on the best checkpoint: ndcg@10 {test['test/ndcg@10']:.5f}, hr@10 "
        f"{test['test/hr@10']:.5f}, mrr {test['test/mrr']:.5f}, ndcg@100 "
        f"{test['test/ndcg@100']:.5f} (chance hr@10: {10 / len(listed):.5f})")
    check(graph_counts.get("train") and graph_counts.get("eval"),
          "the cli.train run did not replay graphed steps and eval batches")
    check_step_launches(kc, steps, eval_batches, counts, graph_counts, attn=blocks)
    ml1m = dict(counts)

    def add(into: dict) -> None:
        for key, value in kc.read().items():
            into[key] += value

    best = out / "ml-1m-hstu" / "checkpoints" / "best.pt"
    with_best = args + [f"trainer.ckpt_path={best}"]
    kc.reset()
    t0 = time.perf_counter()
    from_best = cli_eval.main(with_best)
    eval_s = time.perf_counter() - t0
    add(ml1m)
    kc.reset()
    t0 = time.perf_counter()
    predictions = cli_predict.main(with_best)
    predict_s = time.perf_counter() - t0
    pred_counts = kc.read()
    add(ml1m)
    with open(predictions, newline="", encoding="utf-8") as f:
        rows = list(csv_module.DictReader(f))
    check(len(rows) == 6040, f"{len(rows)} prediction rows, expected 6,040")
    ids = [json.loads(r["top_k_ids"]) for r in rows]
    scores = [json.loads(r["top_k_scores"]) for r in rows]
    catalog = set(listed.tolist())
    check(all(len(x) == cfg.model.index.k and set(x) <= catalog for x in ids),
          "a prediction row with ids outside the catalog")
    # the same checkpoint through an in-process eval step, eagerly
    trainer = Trainer(cli_train.parse_args(with_best))
    trainer.load_weights(best)
    trainer.model.eval()
    want_ids, want_scores = [], []
    with torch.no_grad():
        candidates = trainer.candidate_fn()
        loader = trainer.data.loader("test")
        for batch, dev in trainer._batches(loader, len(loader)):
            got_i, got_s = trainer.eval_step(dev, candidates)
            valid = batch["sample_weight"] > 0
            want_ids.extend(got_i.cpu().numpy()[valid].tolist())
            want_scores.extend(got_s.cpu().numpy()[valid].tolist())
    problem = topk_agree(ids, scores, want_ids, want_scores, atol=1e-5)
    check(problem is None, f"predictions.csv against the eval step: {problem}")
    same = sum(a == b for a, b in zip(ids, want_ids))
    del trainer
    log(f"  cli.eval from best.pt {eval_s:.2f} s: {from_best}; cli.predict {predict_s:.2f} s "
        f"(graphed k-batch eval form; launches {pred_counts}): {len(rows)} rows, ids in the "
        f"catalog; top-{cfg.model.index.k} ids equal to the eager eval step's in {same} of "
        f"{len(rows)} rows, the rest within near-ties at atol 1e-5")

    # a reference-style Lightning file from best.pt: convert, then evaluate
    state = torch.load(best, map_location="cpu", weights_only=True)
    ref = REAL_DIR / "reference.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in state["model"].items()},
                "epoch": state["epoch"], "global_step": state["step"],
                "hyper_parameters": {"experiment": "ml-1m-hstu", "lr": 1e-3}}, ref)
    t0 = time.perf_counter()
    converted = cli_convert.main([str(ref), str(REAL_DIR / "converted.pt"), *base])
    convert_s = time.perf_counter() - t0
    kc.reset()
    from_converted = cli_eval.main(args + [f"trainer.ckpt_path={converted}"])
    add(ml1m)
    kc.reset()
    from_ckpt = cli_eval.main(args + [f"trainer.ckpt_path={ref}"])
    add(ml1m)
    check(from_converted == from_best and from_ckpt == from_best,
          f"the .ckpt round trip moved the metrics: {from_converted} / {from_ckpt} vs {from_best}")
    log(f"  Lightning .ckpt from best.pt: cli.convert_ckpt {convert_s:.2f} s; cli.eval on the "
        f"converted .pt and on the .ckpt itself: the metrics of best.pt bit for bit")
    gc.collect()
    torch.cuda.empty_cache()
    others = {key: 0 for key in ml1m}
    long_cut_depth(kc, card, others)
    amazon_cut_depth(kc, card, others)
    return ml1m, others, {"root": root, "test": test}


# the from-files runs' depth cuts: ml-20m-hstu-long's and amzn-books' users,
# cut from 2,048 and 20,000 for phase 24's time
LONG_FILE_USERS = 1024
AMZN_FILE_USERS = 10_000


def long_cut_depth(kc: Counts, card: str, into: dict) -> None:
    """ml-20m-hstu-long from an ml-20m-format zip: the synthetic draw of
    LONG_FILE_USERS users (histories up to 1,024) written as ratings.csv
    with float ratings (some x.5) and movies.csv; prepare, then one packed,
    graphed epoch."""
    import csv as csv_module
    import io

    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.data.synthetic import synthetic_interactions

    root = REAL_DIR / "ml-20m"
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    inter = synthetic_interactions(num_users=LONG_FILE_USERS, num_items=26744,
                                   max_item_id=131262, max_seq_len=1024)
    ratings = "userId,movieId,rating,timestamp\n" + _rating_lines(
        inter, lambda u, i, r, t, j: f"{u},{i},{r - 0.5 if j % 3 == 0 else float(r)},{t}\n")
    movies = io.StringIO()
    w = csv_module.writer(movies, lineterminator="\n")
    w.writerow(["movieId", "title", "genres"])
    for i, m in enumerate(inter.catalog.tolist()):
        w.writerow([m, _title(i, m, 1919 + m % 97), "Action|Sci-Fi"])
    size = _zip(root / "movielens_ml-20m.zip", {
        "ml-20m/ratings.csv": ratings.encode(), "ml-20m/movies.csv": movies.getvalue().encode()})
    log(f"ml-20m fixture: {sum(len(a) for a in inter.item_ids):,} ratings (float, a third "
        f"x.5) of {LONG_FILE_USERS:,} users over 26,744 movies (max id 131262), {size:,} bytes, "
        f"written in {time.perf_counter() - t0:.2f} s")
    base = ["experiment=ml-20m-hstu-long", f"data.data_dir={root}"]
    prepare(base, "experiment=ml-20m-hstu-long")
    out = REAL_DIR / "out"
    args = base + [f"trainer.output_dir={out}", "trainer.max_epochs=1", "trainer.min_epochs=1",
                   "trainer.log_every_n_steps=1"]
    cfg = cli_train.parse_args(args)
    kc.reset()
    t0 = time.perf_counter()
    cli_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graphs_run = kc.read(), kc.read_graphs()
    for key, value in counts.items():
        into[key] += value
    losses, test = _finite_run(out / "ml-20m-hstu-long" / "metrics.jsonl", "ml-20m-hstu-long")
    check(cfg.data.pack_sequences and graphs_run.get("train"), "not packed and graphed")
    log(f"  ml-20m-hstu-long from files at cut depth ({LONG_FILE_USERS:,} users, one epoch): D="
        f"{cfg.model.item_embedding_dim} blocks={cfg.model.encoder.num_blocks} H="
        f"{cfg.model.encoder.num_heads} packed {list(cfg.data.pack_capacities)}, graphed: "
        f"{len(losses)} logged steps in {wall:.2f} s, loss first {losses[0]:.4f} last "
        f"{losses[-1]:.4f}, test ndcg@10 {test['test/ndcg@10']:.5f}; launches {counts}")


PHASE15_AMZN: dict = {}  # phase 15's amzn-books run, printed beside phase 21's sharded one


def amazon_cut_depth(kc: Counts, card: str, into: dict) -> None:
    """amzn-books from a ratings_Books.csv: string ASINs (some all digits),
    power-law popularity, AMZN_FILE_USERS users; prepare (min_count 5), then
    one epoch: packing, the lazy update, shared negatives, packed eval."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train

    root = REAL_DIR / "amzn"
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(16)
    num_users, num_items = AMZN_FILE_USERS, 60_000
    lengths = np.minimum(2 + rng.geometric(1 / 16, size=num_users), 600)
    pop = 1.0 / np.arange(1, num_items + 1) ** 0.9
    cdf = np.cumsum(pop) / pop.sum()
    items = cdf.searchsorted(rng.random(int(lengths.sum())), side="right")
    users = np.repeat(np.arange(num_users), lengths)
    stamps = 1_200_000_000 + rng.integers(0, 10**8, size=len(items))
    stars = rng.integers(1, 6, size=len(items))
    asin = [f"{i:010d}" if i % 4 == 0 else f"B{i:09X}" for i in range(num_items)]
    user = [f"A{(u * 2654435761) % 16**12:012X}" for u in range(num_users)]
    lines = "".join(f"{user[u]},{asin[i]},{float(r)},{t}\n" for u, i, r, t in zip(
        users.tolist(), items.tolist(), stars.tolist(), stamps.tolist()))
    (root / "ratings_Books.csv").write_text(lines)
    log(f"amzn-books fixture: {len(items):,} ratings of {num_users:,} users over "
        f"{num_items:,} ASINs (power law 0.9), {len(lines):,} bytes, written in "
        f"{time.perf_counter() - t0:.2f} s")
    base = ["experiment=amzn-books", f"data.data_dir={root}"]
    prepare(base, "experiment=amzn-books")
    out = REAL_DIR / "out"
    args = base + [f"trainer.output_dir={out}", "trainer.max_epochs=1", "trainer.min_epochs=1",
                   "trainer.log_every_n_steps=1"]
    cfg = cli_train.parse_args(args)
    check(cfg.data.pack_sequences and cfg.model.embedding.lazy_update
          and cfg.model.loss.shared_negatives, "not the amzn-books overlay")
    kc.reset()
    t0 = time.perf_counter()
    cli_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kc.read()
    for key, value in counts.items():
        into[key] += value
    losses, test = _finite_run(out / "amzn-books" / "metrics.jsonl", "amzn-books")
    PHASE15_AMZN.update(wall=wall, steps=len(losses), loss=float(losses[-1]),
                        ndcg10=test["test/ndcg@10"])
    log(f"  amzn-books from files at cut depth (one epoch): D={cfg.model.item_embedding_dim} "
        f"blocks={cfg.model.encoder.num_blocks} H={cfg.model.encoder.num_heads} "
        f"R={cfg.model.loss.num_to_sample} shared, lazy update, packed "
        f"{list(cfg.data.pack_capacities)}: {len(losses)} logged steps in {wall:.2f} s, loss "
        f"first {losses[0]:.4f} last {losses[-1]:.4f}, test ndcg@10 {test['test/ndcg@10']:.5f}; "
        f"launches {counts}")


# ---------------------------------------------------------------- phase 16 (Muon and Scion)

SPLIT_PRESETS = ("ml-1m-hstu-muon", "ml-1m-hstu-scion")
# the JAX package's 30-epoch test ndcg@10 of the two presets (PARITY.md:113-115),
# from a TPU v5e on synthetic ml-1m-shaped data: not numbers of this card
JAX_SPLIT_NDCG10 = {"ml-1m-hstu-muon": 0.0376, "ml-1m-hstu-scion": 0.0367}
MIN_SPLIT_NDCG10 = 0.030  # about 80% of the lower of the two
# cut from 30 to 10 for phase 22's time and to 3 for phase 23's (the 30-epoch
# numbers are in PERF.md section 5; at 3 epochs on an H100 at 700 W, test
# ndcg@10 0.0372 (Scion) and 0.0391 (Muon), PERF.md section 4)
SPLIT_EPOCHS = 3
# the split step on the card against the CPU on the same gradients: each Muon
# / Scion matrix within this share of its own movement (NS-5 in bfloat16, the
# band tests/test_torch_port_optimizers.py holds the port to JAX with), the
# AdamW part at phase 5's gradient tolerance
SPLIT_BAND = 0.15


def run_split_optimizer_path(kc: Counts, card: str, ml1m: dict) -> dict:
    """Phase 16: `cli.train` for 30 graphed epochs of ml-1m-hstu-muon and of
    ml-1m-hstu-scion on phase 15's ml-1m files. -> the launch counts of the
    two runs."""
    import shutil

    from mygenerativerecommenders_tpu_torch.cli import train as cli_train

    total = None
    epochs, out = SPLIT_EPOCHS, OUT_DIR / "split"
    adamw = ml1m["test"]
    summary = [f"ml-1m-hstu (AdamW, phase 15): ndcg@10 {adamw['test/ndcg@10']:.5f}, hr@10 "
               f"{adamw['test/hr@10']:.5f}, mrr {adamw['test/mrr']:.5f}"]
    for preset in SPLIT_PRESETS:
        args = [f"experiment={preset}", f"data.data_dir={ml1m['root']}",
                f"trainer.output_dir={out}", f"trainer.max_epochs={epochs}",
                f"trainer.min_epochs={epochs}", "trainer.log_every_n_steps=1"]
        run = out / preset
        shutil.rmtree(run, ignore_errors=True)
        cfg = cli_train.parse_args(args)
        check(cfg.optimizer2.enabled and cfg.scheduler2.kind == "plateau",
              f"{preset}: no matrix optimizer with its plateau controller")
        kc.reset()
        t0 = time.perf_counter()
        monitored = cli_train.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, graph_counts = kc.read(), kc.read_graphs()
        blocks = cfg.model.encoder.num_blocks
        per_epoch = -(-6040 // cfg.data.batch_size)
        eval_batches = (epochs + 1) * per_epoch
        log(f"split-optimizer path: cli.train on {card}, {preset} from files (AdamW lr "
            f"{cfg.optimizer1.lr:g} on the embeddings and vectors, {cfg.optimizer2.kind} lr "
            f"{cfg.optimizer2.lr:g} on the encoder's matrices), D={cfg.model.item_embedding_dim} "
            f"blocks={blocks} N={cfg.data.max_sequence_length + cfg.model.gr_output_length + 1} "
            f"batch={cfg.data.batch_size} R={cfg.model.loss.num_to_sample}: {epochs * per_epoch} "
            f"optimizer steps, {eval_batches} eval batches in {wall:.2f} s "
            f"({epochs * 6040 / wall:.1f} training examples/s end to end); launches {counts}")
        losses, steps, val, test = read_training_run(run / "metrics.jsonl", epochs, monitored)
        check(steps == epochs * per_epoch, f"{steps} optimizer steps, expected {epochs * per_epoch}")
        check(graph_counts.get("train") and graph_counts.get("eval"),
              f"{preset}: the cli.train run did not replay graphed steps and eval batches")
        check_step_launches(kc, steps, eval_batches, counts, graph_counts, attn=blocks)
        for name in ("best.pt", "last.pt"):
            check((run / "checkpoints" / name).exists(), f"{preset}: no {name}")
        rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        rates = sorted({(r["lr1"], r["lr2"]) for r in rows if "train/loss" in r})
        log(f"  (lr1, lr2) over the run: {rates}; test on the best checkpoint: ndcg@10 "
            f"{test['test/ndcg@10']:.5f}, hr@10 {test['test/hr@10']:.5f}, mrr "
            f"{test['test/mrr']:.5f}, ndcg@100 {test['test/ndcg@100']:.5f}")
        summary.append(f"{preset}: ndcg@10 {test['test/ndcg@10']:.5f}, hr@10 "
                       f"{test['test/hr@10']:.5f}, mrr {test['test/mrr']:.5f} (the JAX "
                       f"package's {JAX_SPLIT_NDCG10[preset]}: TPU v5e, synthetic ml-1m-shaped "
                       f"data)")
        check(test["test/ndcg@10"] >= MIN_SPLIT_NDCG10,
              f"{preset}: test ndcg@10 {test['test/ndcg@10']} below {MIN_SPLIT_NDCG10}")
        total = counts if total is None else {k: total[k] + v for k, v in counts.items()}
    log(f"  test metrics after {epochs} epochs on {card}: " + "; ".join(summary))
    return total


def split_steps_side_by_side(kc: Counts, card: str, root: Path) -> None:
    """The train step of ml-1m-hstu (AdamW), -muon and -scion on the files,
    eager and graphed side by side as in phase 4, and the optimizer's device
    ms and share of the eager step's (`profile_optimizer`)."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    table = []
    for preset in ("ml-1m-hstu",) + SPLIT_PRESETS:
        trainer = Trainer(cli_train.parse_args([
            f"experiment={preset}", f"data.data_dir={root}",
            f"trainer.output_dir={OUT_DIR / 'split_by_hand'}"]))
        trainer.model.train()
        batches = [trainer._put(b) for _, b in zip(range(4), trainer.data.loader("train"))]
        blocks = trainer.cfg.model.encoder.num_blocks
        times = eager_and_graphed(kc, {
            "eager": lambda i: trainer.train_step(batches[i % 4], trainer.lr1, trainer.lr2),
            "graphed": lambda i: trainer.train_steps([batches[i % 4]], trainer.lr1, trainer.lr2),
        }, f"{preset} train step", kc.per_step(blocks, 0), trainer.train_steps.graphs, card,
            reps=40)
        dev, opt, _ = profile_optimizer(
            lambda i: trainer.train_step(batches[i % 4], trainer.lr1, trainer.lr2), reps=4)
        g = times["graphed"]
        table.append(f"{preset}: graphed p50 {g['p50']:.3f} ms, device {g['device_ms']:.3f} ms "
                     f"in {g['launches']:.0f} launches; eager step device {dev:.3f} ms, "
                     f"optimizer {opt:.3f} ms ({100 * opt / dev:.1f}%)")
        del trainer, batches
        gc.collect()
        torch.cuda.empty_cache()
    log(f"train steps at ml-1m width on {card}: " + " | ".join(table))


def split_eager_twice(root: Path) -> None:
    """Three eager steps of each split preset on one batch, twice, from the
    same seeds (dropout on): logs the largest difference a parameter shows
    between the two runs. The attention backward adds the bias tables'
    gradients with float atomics, whose order changes from run to run; from
    the second step on that float noise reaches the matrices' gradients, and
    NS-5 in bfloat16 turns it into ulps of their updates. It is why phase 16
    holds the graphed step to the eager one over one step."""
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    for preset in SPLIT_PRESETS:
        runs = []
        for _ in range(2):
            trainer = Trainer(parse_args([f"experiment={preset}", f"data.data_dir={root}",
                                          "trainer.steps_per_call=1",
                                          f"trainer.output_dir={OUT_DIR / 'eager_twice'}"]))
            trainer.model.train()
            batch = trainer._put(next(iter(trainer.data.loader("train"))))
            torch.manual_seed(17)
            for _ in range(3):
                trainer.train_step(batch, trainer.lr1, trainer.lr2)
            runs.append({k: p.detach().cpu() for k, p in trainer.model.named_parameters()})
            del trainer
        diffs = {k: float((runs[0][k] - runs[1][k]).abs().max()) for k in runs[0]}
        log(f"eager against eager, three {preset} steps from the same seeds: largest "
            f"differences " + ", ".join(f"{k.split('_attention_layers.')[-1]} {d:.3e}"
                                        for k, d in diffs.items() if d > 0))


def split_card_against_cpu(root: Path) -> None:
    """Two steps of each split optimizer on the card and on the CPU from the
    same weights, batch and negatives, dropout off, each optimizer given the
    CPU's gradients: the AdamW-stepped parameters at phase 5's gradient
    tolerance, each Muon / Scion matrix within SPLIT_BAND of its movement."""
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.models.model import build_model
    from mygenerativerecommenders_tpu_torch.train.optimizers import build_optimizer, param_labels
    from mygenerativerecommenders_tpu_torch.train.task_retrieval import make_loss_fn

    for preset in SPLIT_PRESETS:
        cfg = parse_args([f"experiment={preset}", f"data.data_dir={root}"])
        data = RecoData(cfg.data, seed=cfg.trainer.seed)
        resolve(cfg, data.max_item_id)
        batch = next(iter(data.loader("train")))
        n = batch["ids"].shape[1] + cfg.model.gr_output_length + 1
        offsets = torch.randint(0, len(data.all_item_ids),
                                (batch["ids"].shape[0], n - 1, cfg.model.loss.num_to_sample),
                                generator=torch.Generator().manual_seed(3), dtype=torch.int32)
        sides = {}
        for device in ("cuda", "cpu"):
            model = build_model(cfg, device=device, seed=99)  # eval mode: dropout off
            opt = build_optimizer(cfg.optimizer1, cfg.optimizer2, model.named_parameters(),
                                  cfg.optimizer1.lr, cfg.optimizer2.lr, fused=device == "cuda")
            loss_fn = make_loss_fn(model, cfg, data.all_item_ids)
            dev_batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
            sides[device] = (model, opt, loss_fn, dev_batch, offsets.to(device))
        start = {k: p.detach().cpu().clone() for k, p in sides["cpu"][0].named_parameters()}
        for _ in range(2):
            for device in ("cpu", "cuda"):
                model, opt, loss_fn, dev_batch, offs = sides[device]
                opt.zero_grad(set_to_none=True)
                loss_fn(dev_batch, neg_offsets=offs).backward()
            for p, q in zip(sides["cuda"][0].parameters(), sides["cpu"][0].parameters()):
                p.grad.copy_(q.grad)  # the same gradients into both optimizers
            for device in ("cpu", "cuda"):
                sides[device][1].step()
        labels = param_labels(sides["cpu"][0].named_parameters())
        ok_all, lines = True, []
        for (name, p), q in zip(sides["cuda"][0].named_parameters(), sides["cpu"][0].parameters()):
            got, want = p.detach().cpu(), q.detach()
            err = float((got - want).abs().max())
            if labels[name] == "matrix":
                moved = float((want - start[name]).abs().max())
                ok = err <= SPLIT_BAND * moved
                lines.append(f"{name.split('_attention_layers.')[-1]} {err:.3e} of "
                             f"{moved:.3e} ({err / moved:.3f})")
            else:
                ok, _ = within(got, want, STEP_GRAD_RTOL, STEP_GRAD_ATOL)
            ok_all = ok_all and ok
            if not ok:
                log(f"  {name}: max_abs_err {err:.3e} outside its tolerance")
        log(f"two {cfg.optimizer2.kind} steps, card against CPU on the same gradients: AdamW "
            f"part within rtol {STEP_GRAD_RTOL} atol {STEP_GRAD_ATOL}; each matrix's largest "
            f"difference of its movement (band {SPLIT_BAND}): " + ", ".join(lines))
        check(ok_all, f"{preset}: the card's split step disagrees with the CPU's")
        del sides
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 17 (aux, SASRec, in-batch, BCE)

# (label, preset, overrides, HSTU attention launches a step, count / lse pairs a step)
FAMILY_RUNS = (
    ("ml-1m-hstu-aux", "ml-1m-hstu-aux", [], 2, 1),
    ("ml-1m-sasrec", "ml-1m-sasrec", [], 0, 1),
    ("ml-1m-hstu in-batch", "ml-1m-hstu", ["model.sampler.kind=in_batch"], 2, 0),
)
BCE_RUN = ("ml-1m-hstu bce", "ml-1m-hstu", ["model.loss.kind=bce"], 2, 0)
# the JAX package's 30-epoch test ndcg@10 of the three recipes (PARITY.md:120-122),
# from a TPU v5e on synthetic ml-1m-shaped data: not numbers of this card
JAX_FAMILY_NDCG10 = {"ml-1m-hstu-aux": 0.0385, "ml-1m-sasrec": 0.0388,
                     "ml-1m-hstu in-batch": 0.0380}
MIN_FAMILY_NDCG10 = 0.030
# the families' runs' epochs (aux, SASRec, in-batch; phase 18's item_year and
# phase 20's bfloat16 run, phase 19's seed run): cut from 30 to 10 for phase
# 22's time and to 3 for phase 23's; their 30-epoch numbers are in PERF.md
# section 5 (at 3 epochs on an H100 at 700 W, test ndcg@10 0.0363-0.0393,
# PERF.md section 4)
CUT_EPOCHS = 3


def family_args(run: tuple, root: Path) -> list:
    label, preset, extra, _, _ = run
    return [f"experiment={preset}", f"data.data_dir={root}", *extra]


def train_family(kc: Counts, card: str, run: tuple, epochs: int, root: Path, out: Path,
                 what: str) -> tuple:
    """`cli.train` of one (label, preset, overrides, attention launches,
    count / lse pairs) run for `epochs` graphed epochs on the files in
    `root`, checked as in phase 4: launch counts, finite and falling losses,
    best.pt and last.pt. -> (launch counts, test row, run directory)."""
    import shutil

    from mygenerativerecommenders_tpu_torch.cli import train as cli_train

    label, preset, extra, attn, lse = run
    args = family_args(run, root) + [
        f"trainer.output_dir={out / label.replace(' ', '_')}",
        f"trainer.max_epochs={epochs}", f"trainer.min_epochs={epochs}",
        "trainer.log_every_n_steps=1"]
    rundir = out / label.replace(" ", "_") / preset
    shutil.rmtree(rundir, ignore_errors=True)
    cfg = cli_train.parse_args(args)
    kc.reset()
    t0 = time.perf_counter()
    monitored = cli_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graph_counts = kc.read(), kc.read_graphs()
    per_epoch = -(-6040 // cfg.data.batch_size)
    eval_batches = (epochs + 1) * per_epoch
    m = cfg.model
    log(f"{what}: cli.train on {card}, {label} from files (embedding {m.embedding.kind}, "
        f"preprocessor {m.preprocessor.kind}, encoder {m.encoder.kind} "
        f"{m.encoder.normalization}, postprocessor {m.postprocessor.kind}, similarity "
        f"{m.similarity.kind}, sampler {m.sampler.kind}, loss {m.loss.kind}, optimizer2 "
        f"{cfg.optimizer2.kind if cfg.optimizer2.enabled else 'off'}), "
        f"D={m.item_embedding_dim} blocks={m.encoder.num_blocks} "
        f"N={cfg.data.max_sequence_length + m.gr_output_length + 1} "
        f"batch={cfg.data.batch_size} R={m.loss.num_to_sample if m.loss.kind != 'bce' else 1}: "
        f"{epochs * per_epoch} optimizer steps, {eval_batches} eval batches in {wall:.2f} s "
        f"({epochs * 6040 / wall:.1f} training examples/s end to end); launches {counts}")
    if m.loss.kind == "bce":
        chance = "log 2 = 0.6931"
    elif m.similarity.kind == "mol":
        chance = "MoL's logits divided by its temperature and the loss's"
    else:
        chance = f"log 129 = {np.log(129):.4f}"
    losses, steps, val, test = read_training_run(rundir / "metrics.jsonl", epochs, monitored,
                                                 chance=chance)
    check(steps == epochs * per_epoch, f"{steps} optimizer steps, expected {epochs * per_epoch}")
    check(graph_counts.get("train") and graph_counts.get("eval"),
          f"{label}: the cli.train run did not replay graphed steps and eval batches")
    check_step_launches(kc, steps, eval_batches, counts, graph_counts, attn=attn, lse=lse,
                        remat=cfg.model.encoder.remat)
    for name in ("best.pt", "last.pt"):
        check((rundir / "checkpoints" / name).exists(), f"{label}: no {name}")
    log(f"  test on the best checkpoint: ndcg@10 {test['test/ndcg@10']:.5f}, hr@10 "
        f"{test['test/hr@10']:.5f}, mrr {test['test/mrr']:.5f}, ndcg@100 "
        f"{test['test/ndcg@100']:.5f}")
    return counts, test, rundir


def test_line(label: str, epochs: int, test: dict) -> str:
    return (f"{label} ({epochs} epoch{'s' if epochs > 1 else ''}): ndcg@10 "
            f"{test['test/ndcg@10']:.5f}, hr@10 {test['test/hr@10']:.5f}, mrr "
            f"{test['test/mrr']:.5f}")


def add_counts(total, counts: dict) -> dict:
    return dict(counts) if total is None else {k: total[k] + v for k, v in counts.items()}


def run_families_path(kc: Counts, card: str, ml1m: dict) -> dict:
    """Phase 17: `cli.train` for 30 graphed epochs of ml-1m-hstu-aux,
    ml-1m-sasrec and ml-1m-hstu with the in-batch sampler, and one epoch of
    ml-1m-hstu with BCE, on phase 15's ml-1m files (users.dat's columns feed
    the aux token). -> the launch counts of the four runs and the SASRec
    run's best checkpoint."""
    total, out = None, OUT_DIR / "families"
    base = ml1m["test"]
    summary = [f"ml-1m-hstu (phase 15): ndcg@10 {base['test/ndcg@10']:.5f}, hr@10 "
               f"{base['test/hr@10']:.5f}, mrr {base['test/mrr']:.5f}"]
    sasrec_best = None
    for run, epochs in [(r, CUT_EPOCHS) for r in FAMILY_RUNS] + [(BCE_RUN, 1)]:
        label, preset = run[:2]
        counts, test, rundir = train_family(kc, card, run, epochs, ml1m["root"], out,
                                            "families path")
        line = test_line(label, epochs, test)
        if label in JAX_FAMILY_NDCG10:
            line += (f" (the JAX package's {JAX_FAMILY_NDCG10[label]}: TPU v5e, synthetic "
                     f"ml-1m-shaped data)")
            check(test["test/ndcg@10"] >= MIN_FAMILY_NDCG10,
                  f"{label}: test ndcg@10 {test['test/ndcg@10']} below {MIN_FAMILY_NDCG10}")
        summary.append(line)
        if preset == "ml-1m-sasrec":
            sasrec_best = rundir / "checkpoints" / "best.pt"
        total = add_counts(total, counts)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"  test metrics on {card}: " + "; ".join(summary))
    return {"counts": total, "sasrec_best": sasrec_best}


def family_steps_side_by_side(kc: Counts, card: str, root: Path, runs=FAMILY_RUNS) -> None:
    """The train step of each run (by default the aux model, SASRec and the
    in-batch sampler) on the files, eager and graphed side by side as in
    phase 4."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    table = []
    for run in runs:
        label, _, _, attn, lse = run
        trainer = Trainer(cli_train.parse_args(family_args(run, root) + [
            f"trainer.output_dir={OUT_DIR / 'families_by_hand'}"]))
        trainer.model.train()
        batches = [trainer._put(b) for _, b in zip(range(4), trainer.data.loader("train"))]
        times = eager_and_graphed(kc, {
            "eager": lambda i: trainer.train_step(batches[i % 4], trainer.lr1),
            "graphed": lambda i: trainer.train_steps([batches[i % 4]], trainer.lr1),
        }, f"{label} train step", kc.per_step(attn, 0, lse), trainer.train_steps.graphs, card,
            reps=40)
        e, g = times["eager"], times["graphed"]
        table.append(f"{label}: eager p50 {e['p50']:.3f} ms, device {e['device_ms']:.3f} ms, "
                     f"idle {100 * e['idle']:.1f}% | graphed p50 {g['p50']:.3f} ms, device "
                     f"{g['device_ms']:.3f} ms, idle {100 * g['idle']:.1f}%, "
                     f"{g['launches']:.0f} launches")
        del trainer, batches
        gc.collect()
        torch.cuda.empty_cache()
    log(f"train steps at ml-1m width on {card}: " + " | ".join(table))


def family_card_against_cpu(root: Path, runs=FAMILY_RUNS) -> None:
    """One loss and its gradients of each run (by default the aux model,
    SASRec and the in-batch sampler) on the card and on the CPU (phase 5's
    check): the same weights, batch and negatives (the catalog offsets, or
    the in-batch sampler's uniforms), dropout off."""
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.train.task_retrieval import make_loss_fn

    for run in runs:
        cfg = parse_args(family_args(run, root))
        data = RecoData(cfg.data, seed=cfg.trainer.seed)
        resolve(cfg, data.max_item_id)
        batch = next(iter(data.loader("train")))
        shape = (batch["ids"].shape[0], batch["ids"].shape[1] + cfg.model.gr_output_length,
                 cfg.model.loss.num_to_sample)
        gen = torch.Generator().manual_seed(3)
        if cfg.model.sampler.kind == "in_batch":
            drawn = {"neg_uniforms": torch.rand(shape, generator=gen)}
        else:
            drawn = {"neg_offsets": torch.randint(0, len(data.all_item_ids), shape, generator=gen,
                                                  dtype=torch.int32)}
        compare_card_and_cpu(f"{run[0]}, a batch of {shape[0]} rows", cfg, batch,
                             lambda model, b, device: make_loss_fn(
                                 model, cfg, data.all_item_ids)(
                                     b, **{k: v.to(device) for k, v in drawn.items()}),
                             year_of_item=data.year_of_item,
                             atol_of_max=MOL_GRAD_ATOL_OF_MAX if "mol" in run[0] else 0.0)
        gc.collect()
        torch.cuda.empty_cache()


def serve_sasrec(card: str, root: Path, ckpt: Path) -> None:
    """/v1/retrieve on the 30-epoch SASRec model (`serve_against_cpu`)."""
    serve_against_cpu(card, "SASRec", ["experiment=ml-1m-sasrec", f"data.data_dir={root}",
                                       f"trainer.ckpt_path={ckpt}"])


def serve_against_cpu(card: str, label: str, argv: list) -> None:
    """/v1/retrieve on the model `argv` names: the graphed engine's top-k
    against a CPU engine's on the same weights (a 32-row request and 8 single
    rows), then the engine call's p50, eager and graphed."""
    from mygenerativerecommenders_tpu_torch.cli.serve import build_engine
    from mygenerativerecommenders_tpu_torch.ops.topk import topk_agree
    from mygenerativerecommenders_tpu_torch.serving.service import RecommenderHTTPServer
    from mygenerativerecommenders_tpu_torch.train import graphs

    engine, _ = build_engine(argv)
    cpu_engine, _ = build_engine(argv + ["serve.device=cpu"])
    check(engine.graphed and engine.device.type == "cuda", f"the {label} engine is not graphed")
    big, singles = make_requests(engine.all_item_ids, seed=17)
    catalog_set = set(engine.all_item_ids.tolist())
    graphs.counts.clear()
    server = RecommenderHTTPServer(engine, "127.0.0.1", 0).start()
    try:
        answers = [(big, http(server.port, "/v1/retrieve", big)[0])]
        answers += [(req, http(server.port, "/v1/retrieve", req)[0]) for req in singles[:8]]
    finally:
        server.stop()
    worst = 0.0
    for req, body in answers:
        check_answer(req, body, catalog_set, engine.max_len, req["k"])
        want = cpu_engine.retrieve(req["sequences"], req.get("timestamps"), k=req["k"])
        problem = topk_agree(body["ids"], body["scores"], *want, atol=E2E_ATOL)
        check(problem is None, f"{label}, card vs CPU engine: {problem}")
        worst = max(worst, float(np.abs(np.asarray(body["scores"]) - np.asarray(want[1])).max()))
    served = dict(graphs.counts["serve"])
    check(served.get("captures", 0) >= 1 and served.get("replays", 0) >= 1,
          f"the {label} engine did not capture and replay its program: {served}")
    log(f"{label} /v1/retrieve on {card}: the graphed engine (graphs {served}) and the CPU engine "
        f"agree on {len(answers)} requests (a 32-row one, 8 single rows): top-k ids equal up to "
        f"near-ties, largest score difference {worst:.3e} (atol {E2E_ATOL})")
    engines_side_by_side(
        f"{label} retrieve, 32 rows", card,
        {name: (lambda e=e: e.retrieve(big["sequences"], big["timestamps"], k=big["k"]))
         for name, e in (("eager", eager_twin(engine)), ("graphed", engine))},
    )
    del engine, cpu_engine


# ---------------------------------------------------------------- phase 18 (item_year, MoL, ...)

# (label, preset, overrides, HSTU attention launches a step, count / lse pairs a step)
ITEM_YEAR_RUN = ("ml-1m-hstu item_year", "ml-1m-hstu", ["model.embedding.kind=item_year"], 2, 1)
# MoL's negative logits are no dot products: it takes the gather loss (no count, no lse)
MOL_RUN = ("ml-1m-hstu mol", "ml-1m-hstu", ["model.similarity.kind=mol"], 2, 0)
# the MoL run's depth cut (the script's time limit): 6 of the recipe's 30
# epochs (~40 ms a step; its 30-epoch numbers are in PERF.md section 5; ranked
# by MoL, test ndcg@10 0.03895 at 15 epochs, 0.03712 at 10, 0.03620 at 6 and
# 0.03133 at 4, close to MIN_FAMILY_NDCG10, on an H100 at 700 W, PERF.md
# section 4; cut from 10 to 6 for phase 24)
MOL_EPOCHS = 6
# the loss divides MoL's logits by two temperatures (0.05 x 0.05): its gradients
# reach ~10-30, and an entry sums ~B*T terms of that size, so float32 sums in
# another order move the small entries by ~1e-6 of the largest (the CPU tests'
# atol against JAX, tests/test_torch_port_mol.py, is 5e-6 of it too)
MOL_GRAD_ATOL_OF_MAX = 5e-6
# ml-1m-hstu-muon's split (AdamW 5e-4, Muon 5e-3 with its plateau controller) over SASRec
SASREC_MUON = ["optimizer1.lr=0.0005", "optimizer2.enabled=true", "optimizer2.kind=muon",
               "optimizer2.lr=0.005", "optimizer2.momentum=0.95", "optimizer2.weight_decay=0.0",
               "scheduler2.kind=plateau"]
ONE_EPOCH_RUNS = (
    ("ml-1m-hstu layer_norm", "ml-1m-hstu", ["model.postprocessor.kind=layer_norm"], 2, 1),
    ("ml-1m-hstu softmax_rel_bias", "ml-1m-hstu",
     ["model.encoder.normalization=softmax_rel_bias"], 0, 1),
    ("ml-1m-sasrec muon", "ml-1m-sasrec", SASREC_MUON, 0, 1),
)


def fork_checkpoint(best: Path, year_of_item: np.ndarray, path: Path) -> None:
    """best.pt's weights as the fork's Lightning file: the reference's key
    names under `model.`, the year table at the fork's num_items + 1 rows
    (rows past the model's 2,201 zero: no year reaches them) and the fork's
    item -> year buffer."""
    state = dict(torch.load(best, map_location="cpu", weights_only=True)["model"])
    year = state["embeddings._year_emb.weight"]
    rows = len(year_of_item)
    if rows > year.shape[0]:
        year = torch.cat([year, year.new_zeros((rows - year.shape[0], year.shape[1]))])
    state["embeddings._year_emb.weight"] = year[:rows]
    state["embeddings.year_lookup_table"] = torch.as_tensor(year_of_item, dtype=torch.int64)
    torch.save({"state_dict": {f"model.{k}": v for k, v in state.items()}, "epoch": 0,
                "global_step": 0, "hyper_parameters": {"item_embedding_dim": 50}}, path)


def mol_scored_test(args: list, ckpt: Path) -> dict:
    """The test metrics of an MoL model's checkpoint with the catalog ranked
    by the model's own similarity (`model.score`, as its training loss
    scores), where the eval step ranks by the dot product, as the JAX
    package's eval does (ROADMAP.md queue 3): each test row's query against
    every normalized catalog row, its history masked as the eval step masks
    it. A measurement of what MoL learned; the port's eval stays JAX's."""
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.models.metrics import retrieval_metrics
    from mygenerativerecommenders_tpu_torch.ops.sequence import get_current_embeddings
    from mygenerativerecommenders_tpu_torch.ops.topk import NEG_INF
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer
    from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch

    trainer = Trainer(parse_args(args))
    trainer.load_weights(ckpt)
    model, cfg = trainer.model.eval(), trainer.cfg
    ids = torch.as_tensor(trainer.all_item_ids, dtype=torch.int64, device=trainer.device)
    max_id, k = int(ids.max()), min(cfg.model.index.k, len(ids))
    all_topk, all_targets = [], []
    loader = trainer.data.loader("test")
    with torch.no_grad():
        candidates = trainer.candidate_fn()  # [X, D], normalized as the loss's rows
        for batch, dev in trainer._batches(loader, len(loader)):
            seq, _, _ = seq_features_from_batch(dev, cfg.model.gr_output_length + 1)
            encoded, lengths = model(seq._replace(
                past_embeddings=model.item_embeddings(seq.past_ids)))
            scores = model.score(get_current_embeddings(lengths, encoded), candidates[None])
            past = torch.zeros((scores.shape[0], max_id + 1), dtype=torch.bool,
                               device=scores.device)
            past.scatter_(1, seq.past_ids.long().clamp(0, max_id), True)
            past[:, 0] = False
            scores = torch.where(past[:, ids], NEG_INF, scores)
            top = ids[torch.topk(scores, k, dim=1).indices].cpu().numpy()
            valid = batch["sample_weight"] > 0
            all_topk.append(top[valid])
            all_targets.append(batch["target_id"][valid])
    del trainer
    return retrieval_metrics(np.concatenate(all_topk), np.concatenate(all_targets),
                             cfg.model.metrics.at_k_list)


def run_other_families_path(kc: Counts, card: str, ml1m: dict) -> dict:
    """Phase 18: `cli.train` for 30 graphed epochs of ml-1m-hstu with the
    item_year embedding and with MoL, one epoch each of the layer_norm
    postprocessor, softmax_rel_bias and SASRec with Muon, on phase 15's
    ml-1m files; the item_year run's weights through a fork-layout `.ckpt`
    and `cli.eval`. -> the launch counts of the five runs."""
    from mygenerativerecommenders_tpu_torch.cli import eval as cli_eval
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.data.catalog import item_catalog

    total, out, root = None, OUT_DIR / "other_families", ml1m["root"]
    base = ml1m["test"]
    summary = [f"ml-1m-hstu (phase 15): ndcg@10 {base['test/ndcg@10']:.5f}, hr@10 "
               f"{base['test/hr@10']:.5f}, mrr {base['test/mrr']:.5f}"]
    for run, epochs in ([(ITEM_YEAR_RUN, CUT_EPOCHS), (MOL_RUN, MOL_EPOCHS)]
                        + [(r, 1) for r in ONE_EPOCH_RUNS]):
        label = run[0]
        counts, test, rundir = train_family(kc, card, run, epochs, root, out,
                                            "other families path")
        summary.append(test_line(label, epochs, test))
        total = add_counts(total, counts)
        if run is MOL_RUN:
            # the eval step ranks by the dot product (JAX's eval), which an
            # MoL model is not trained for: its own similarity ranks here,
            # on the last weights (best.pt is chosen by the dot-product metric)
            kc.reset()
            mol = mol_scored_test(family_args(run, root) + [
                f"trainer.output_dir={out / 'mol_scored'}"], rundir / "checkpoints" / "last.pt")
            total = add_counts(total, kc.read())
            summary.append(f"{label}, ranked by MoL (last.pt): ndcg@10 {mol['ndcg@10']:.5f}, "
                           f"hr@10 {mol['hr@10']:.5f}, mrr {mol['mrr']:.5f}")
            test = {f"test/{k}": v for k, v in mol.items()}
        if epochs > 1:
            check(test["test/ndcg@10"] >= MIN_FAMILY_NDCG10,
                  f"{label}: test ndcg@10 {test['test/ndcg@10']} below {MIN_FAMILY_NDCG10}")
        if run is ITEM_YEAR_RUN:
            # the fork's own checkpoint of this model, read back by cli.eval
            args = family_args(run, root) + [f"trainer.output_dir={out / 'fork_eval'}"]
            years = item_catalog(parse_args(args).data)[2]
            fork = out / "fork.ckpt"
            fork_checkpoint(rundir / "checkpoints" / "best.pt", years, fork)
            kc.reset()
            from_best = cli_eval.main(args + [f"trainer.ckpt_path={rundir / 'checkpoints' / 'best.pt'}"])
            from_fork = cli_eval.main(args + [f"trainer.ckpt_path={fork}"])
            total = add_counts(total, kc.read())
            worst = max(abs(v - test[f"test/{k}"]) for k, v in from_best.items())
            log(f"  fork-layout .ckpt of best.pt (year table {len(years)} rows, item -> year "
                f"buffer): cli.eval {from_fork}; equal to best.pt's cli.eval: "
                f"{from_fork == from_best}; largest difference to the run's own test row "
                f"{worst:.3e}")
            check(from_fork == from_best, "the fork .ckpt evaluates to other metrics than best.pt")
            check(worst <= 1e-6, "cli.eval of best.pt differs from the run's own test row")
        gc.collect()
        torch.cuda.empty_cache()
    log(f"  test metrics on {card}: " + "; ".join(summary))
    return total


# ---------------------------------------------------------------- phase 19 (training variants)

# remat reruns the same arithmetic: JAX tests/test_remat.py:52's tolerance
REMAT_RTOL, REMAT_ATOL = 1e-5, 1e-6
# the JAX package's 30-epoch test ndcg@10 band of ml-1m-hstu (PARITY.md, "Recipe
# validation"), from a TPU v5e on synthetic ml-1m-shaped data: not this card's
JAX_NDCG10_BAND = (0.037, 0.039)
# trainer.seed of one more ml-1m-hstu run (the preset's is 42); cut from two
# seeds (1, 2) for phase 23
SEED_RUNS = (1,)
REMAT_RUN = ("ml-1m-hstu remat", "ml-1m-hstu", ["model.encoder.remat=true"], 2, 1)
# the kernels a profiled ml-1m-hstu step must show in its trace, by the
# substrings of their names
TRACED_KERNELS = ("hstu_attention_fwd_kernel", "hstu_attention_bwd_kernel",
                  "count_offsets_kernel", "dense_neg_lse_fwd_kernel", "dense_neg_lse_bwd_kernel")


def remat_pair(args: list, data=None) -> dict:
    """Two trainers of `args`, without and with `encoder.remat` (the same
    seed: the same weights, negatives and dropout streams), on one data."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    pair = {}
    for mode in ("off", "on"):
        trainer = Trainer(cli_train.parse_args(args + [
            f"model.encoder.remat={mode == 'on'}", f"trainer.output_dir={OUT_DIR / 'remat'}"]),
            data=data)
        data = trainer.data
        trainer.model.train()
        pair[mode] = trainer
    return pair


def remat_against_plain(what: str, pair: dict, batch: dict, card: str) -> dict:
    """The first graphed step of each trainer of the pair on `batch`'s shape
    (two warm-up runs, the capture, one replay) from one dropout seed
    (dropout 0.2), then each put back as it was (weights and optimizer
    state: `training_state`): the loss and every gradient of the remat step
    against the step without it at REMAT_RTOL / REMAT_ATOL. -> {mode: (peak
    memory allocated over the call, the part of it over what was held
    before)}: a replay allocates nothing, so the step's activations show
    in its first call alone."""
    from mygenerativerecommenders_tpu_torch.train.graphs import training_state

    out, peaks = {}, {}
    for mode, trainer in pair.items():
        restore = training_state(list(trainer.model.parameters()), trainer.optimizer)()
        torch.manual_seed(19)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = trainer.train_steps([batch], trainer.lr1)
        torch.cuda.synchronize()
        top = torch.cuda.max_memory_allocated()
        peaks[mode] = (top, top - held)
        out[mode] = (loss.clone(), {n: p.grad.detach().clone()
                                    for n, p in trainer.model.named_parameters()})
        restore()
    (want_loss, want), (got_loss, got) = out["off"], out["on"]
    ok, loss_err = within(got_loss, want_loss, REMAT_RTOL, 0.0)
    check(ok, f"{what}: the remat step's loss {got_loss.item()} against {want_loss.item()}")
    worst, worst_name, worst_rel = 0.0, "", 0.0
    for name, g in want.items():
        ok, err = within(got[name], g, REMAT_RTOL, REMAT_ATOL)
        check(ok, f"{what}: the remat gradient of {name} differs by up to {err:.3e}")
        if err > worst:
            worst, worst_name = err, name
            worst_rel = err / max(float(g.abs().max()), 1e-30)
    log(f"{what}: remat against no remat, one graphed step, dropout "
        f"{pair['on'].cfg.model.encoder.linear_dropout_rate}: loss {got_loss.item():.6f} | "
        f"{want_loss.item():.6f} (|diff| {loss_err:.3e}); every gradient within rtol "
        f"{REMAT_RTOL} / atol {REMAT_ATOL}, the largest |diff| {worst:.3e} ({worst_name}, "
        f"{worst_rel:.3e} of its largest entry) on {card}")
    return peaks


def remat_long_classes(kc: Counts, card: str) -> None:
    """ml-20m-hstu-long's packed classes, remat off against on: each class's
    gradients (one graphed step each from the same state), then its graphed
    step's p50, device ms, launches and peak memory."""
    t0 = time.perf_counter()
    pair = remat_pair(LONG_ARGS[:2] + ["data.synthetic_max_seq_len=1200",
                                       "trainer.steps_per_call=8"])
    trainer = pair["off"]
    cfg = trainer.cfg
    blocks = cfg.model.encoder.num_blocks
    by_cap = {}
    for batch in trainer._loader("train", packed=True):
        by_cap.setdefault(batch["ids"].shape[1], []).append(batch)
    check(sorted(by_cap) == sorted(cfg.data.pack_capacities), f"classes {sorted(by_cap)}")
    log(f"remat on ml-20m-hstu-long: two trainers (encoder.remat false | true) built in "
        f"{time.perf_counter() - t0:.2f} s: D={cfg.model.item_embedding_dim} blocks={blocks} "
        f"H={cfg.model.encoder.num_heads}, classes {sorted(by_cap)}")
    batches = {cap: [trainer._put(b) for b in host[:4]] for cap, host in by_cap.items()}
    peaks = {cap: remat_against_plain(f"class {cap}", pair, batches[cap][0], card)
             for cap in sorted(batches)}
    rows = []
    for cap in sorted(batches):
        got = {}
        for mode, t in pair.items():
            per = kc.per_step(blocks, 0)
            if mode == "on":
                per[0] = 2 * blocks  # the recompute's forwards
            bs = batches[cap]
            got[mode] = step_numbers(
                kc, lambda i, t=t, bs=bs: t.train_steps([bs[i % len(bs)]], t.lr1),
                f"graphed train step, class {cap}, remat {mode} on {card}", per, top=4)
            got[mode]["peak"], got[mode]["over"] = peaks[cap][mode]
        off, on = got["off"], got["on"]
        rows.append(
            f"class {cap} ({by_cap[cap][0]['ids'].shape[0]} x {cap}): p50 {off['p50']:.3f} | "
            f"{on['p50']:.3f} ms; device {off['device_ms']:.3f} | {on['device_ms']:.3f} ms "
            f"(+{100 * (on['device_ms'] / off['device_ms'] - 1):.1f}%); launches "
            f"{off['launches']:.0f} | {on['launches']:.0f}; peak {gb(off['peak'])} | "
            f"{gb(on['peak'])} over its first call ({gb(off['over'])} | {gb(on['over'])} over "
            f"what was held)")
    log(f"remat off | on, graphed, on {card}:\n  " + "\n  ".join(rows))
    del pair, batches, trainer
    gc.collect()
    torch.cuda.empty_cache()


def remat_ring_step(kc: Counts, card: str) -> None:
    """One zigzag ring step (sp_shards=4) at ml-20m-hstu-long's width, remat
    off against on, held as the classes are."""
    pair = remat_pair(RING_ARGS + [f"data.synthetic_num_users={RING_USERS}",
                                   "trainer.steps_per_call=8"])
    trainer = pair["off"]
    block = trainer.model.sequence_encoder["_hstu"]._attention_layers[0]
    check(block.sp_shards == 4 and block.sp_zigzag, "not the zigzag ring")
    batch = trainer._put(next(iter(trainer.data.loader("train"))))
    calls = kc.chunk.launches
    peaks = remat_against_plain("zigzag ring step (sp_shards=4)", pair, batch, card)
    blocks = trainer.cfg.model.encoder.num_blocks
    per = blocks * ring_chunk_calls(4, True)
    # each trainer's first call: two warm-up runs and the replay (the
    # capture launches nothing); with remat every forward runs twice
    want = (kc.graphs.WARMUP_RUNS + 1) * (per + 2 * per)
    check(kc.chunk.launches - calls == want,
          f"chunk forwards {kc.chunk.launches - calls}, expected {want}")
    log(f"  zigzag ring step: {per} | {2 * per} chunk forwards a step, remat off | on; peak "
        f"over its first graphed call {gb(peaks['off'][0])} | {gb(peaks['on'][0])} "
        f"({gb(peaks['off'][1])} | {gb(peaks['on'][1])} over what was held) on {card}")
    del pair, batch, trainer
    gc.collect()
    torch.cuda.empty_cache()


def ml1m_remat_and_seeds(kc: Counts, card: str, ml1m: dict) -> dict:
    """ml-1m-hstu from phase 15's files for CUT_EPOCHS graphed epochs with
    `encoder.remat=true` (cut from 30 for phase 24's time; its 30-epoch
    numbers are in PERF.md section 5), and without it at one more seed. ->
    launch counts."""
    total, out = None, OUT_DIR / "variants"
    base = ml1m["test"]["test/ndcg@10"]
    counts, remat, _ = train_family(kc, card, REMAT_RUN, CUT_EPOCHS, ml1m["root"], out,
                                    "remat path")
    total = add_counts(total, counts)
    seeds = {}
    for seed in SEED_RUNS:
        run = (f"ml-1m-hstu seed {seed}", "ml-1m-hstu", [f"trainer.seed={seed}"], 2, 1)
        counts, test, _ = train_family(kc, card, run, CUT_EPOCHS, ml1m["root"], out, "seeds")
        seeds[seed] = test["test/ndcg@10"]
        total = add_counts(total, counts)
        check(test["test/ndcg@10"] >= MIN_FAMILY_NDCG10,
              f"seed {seed}: test ndcg@10 {test['test/ndcg@10']} below {MIN_FAMILY_NDCG10}")
    got = remat["test/ndcg@10"]
    log(f"ml-1m-hstu on {card}, test ndcg@10: encoder.remat=true {got:.5f} ({CUT_EPOCHS} "
        f"epochs) beside no remat {base:.5f} (phase 15, seed 42, 30 epochs); seeds "
        f"({CUT_EPOCHS} epochs) "
        + ", ".join(f"{s}: {v:.5f}" for s, v in seeds.items())
        + f"; {1 + len(seeds)} seeds {np.mean([base, *seeds.values()]):.5f} +- "
        f"{np.std([base, *seeds.values()]):.5f} (the JAX package's 30-epoch band "
        f"{JAX_NDCG10_BAND[0]}-{JAX_NDCG10_BAND[1]}: TPU v5e, synthetic ml-1m-shaped data)")
    check(got >= MIN_FAMILY_NDCG10,
          f"the remat run's test ndcg@10 {got} below {MIN_FAMILY_NDCG10}")
    return total


def async_checkpoint_at_10m(card: str, data) -> None:
    """synthetic-large-vocab's lazy overlay after two graphed steps: a
    synchronous save and two async saves of the same state, timed (the
    seconds the caller is blocked, and until the file has landed), then
    both files read back and compared, tensor for tensor."""
    import shutil
    import tempfile

    from mygenerativerecommenders_tpu_torch.checkpoint import CheckpointManager
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    trainer = Trainer(cli_train.parse_args(LARGE_ARGS + LAZY + [
        "trainer.steps_per_call=8", f"trainer.output_dir={OUT_DIR / 'large_async'}"]), data=data)
    trainer.model.train()
    batches = [trainer._put(b) for _, b in zip(range(2), trainer.data.loader("train"))]
    trainer.train_steps(batches, trainer.lr1)
    torch.cuda.synchronize()
    tmp = Path(tempfile.mkdtemp(prefix="large_async_", dir=OUT_DIR))
    try:
        state = dict(step=2, epoch=0, metric_value=0.0, extra=trainer._controller_state())
        managers = {"sync": CheckpointManager(str(tmp / "sync")),
                    "async": CheckpointManager(str(tmp / "async"), async_save=True)}
        lines = []
        for label, ckpt in [("sync", managers["sync"]), ("async, first", managers["async"]),
                            ("async, second", managers["async"])]:
            t0 = time.perf_counter()
            ckpt.save(trainer.model, trainer.optimizer, **state)
            blocked = time.perf_counter() - t0
            ckpt.flush()
            landed = time.perf_counter() - t0
            lines.append(f"{label}: the loop blocked {blocked:.3f} s, the file landed after "
                         f"{landed:.3f} s")
        size = (tmp / "async" / "last.pt").stat().st_size
        t0 = time.perf_counter()
        sync = CheckpointManager.load(str(tmp / "sync" / "last.pt"))
        got = CheckpointManager.load(str(tmp / "async" / "last.pt"))
        compared = [0]

        def same(a, b, where):
            if isinstance(a, torch.Tensor):
                check(a.dtype == b.dtype and torch.equal(a, b), f"async checkpoint: {where}")
                compared[0] += a.numel() * a.element_size()
            elif isinstance(a, dict):
                check(a.keys() == b.keys(), f"async checkpoint: the keys of {where}")
                for k in a:
                    same(a[k], b[k], f"{where}.{k}")
            elif isinstance(a, (list, tuple)):
                check(len(a) == len(b), f"async checkpoint: {where}")
                for i, (x, y) in enumerate(zip(a, b)):
                    same(x, y, f"{where}[{i}]")
            else:
                check(a == b, f"async checkpoint: {where}: {a} != {b}")

        same(sync, got, "state")
        log(f"async checkpoint at 10M items on {card} ({gb(size)} a file: the table, mv, "
            f"the AdamW state): " + "; ".join(lines) + f"; both files read back and equal, "
            f"{gb(compared[0])} of tensors bit for bit, in {time.perf_counter() - t0:.2f} s")
        del sync, got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()


def one_epoch_knobs(kc: Counts, card: str, ml1m: dict) -> dict:
    """ml-1m-hstu, one epoch each on phase 15's files: with the profiler
    (the trace must name the port's kernels), with MLflow (its files must
    hold every logged row) and TensorBoard (its scalars written, or the
    named ValueError where neither package imports), and a 2-point
    `cli.sweep` over optimizer1.lr. -> their launch counts."""
    from mygenerativerecommenders_tpu_torch.cli import sweep as cli_sweep
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train

    out = OUT_DIR / "knobs"
    shutil.rmtree(out, ignore_errors=True)
    base = ["experiment=ml-1m-hstu", f"data.data_dir={ml1m['root']}", "trainer.max_epochs=1",
            "trainer.min_epochs=1"]
    total = None

    kc.reset()
    t0 = time.perf_counter()
    cli_train.main(base + [f"trainer.output_dir={out / 'profiler'}", "trainer.profiler=true"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = add_counts(total, kc.read())
    trace = out / "profiler" / "ml-1m-hstu" / "profile" / "trace_epoch0.json"
    check(trace.exists(), f"no profiler trace at {trace}")
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in e.get("name", "") for e in kernels) for k in TRACED_KERNELS}
    log(f"profiler run on {card}: cli.train, one epoch with trainer.profiler=true (one step "
        f"a call) in {wall:.2f} s; {trace.name}: {len(events)} events, {len(kernels)} device "
        f"kernels over steps 2-4, the port's by name: {found}")
    check(all(found.values()), f"the trace does not name every kernel: {found}")

    kc.reset()
    args = base + [f"trainer.output_dir={out / 'loggers'}", f"trainer.mlflow_dir={out / 'mlruns'}",
                   "trainer.log_every_n_steps=1"]
    try:
        cli_train.main(args + ["trainer.tensorboard=true"])
        tb_dir = out / "loggers" / "ml-1m-hstu" / "tb"
        records = sum(tfrecord_count(f) for f in tb_dir.iterdir())
        tb = f"scalars written: {records} event records under {tb_dir.name}/"
        check(records > 1, "no TensorBoard scalars")
    except ValueError as error:
        check("tensorboardX" in str(error), f"an unexpected ValueError: {error}")
        tb = f"raised the named ValueError: {error}"
        cli_train.main(args)
    total = add_counts(total, kc.read())
    rows = [json.loads(line) for line in
            (out / "loggers" / "ml-1m-hstu" / "metrics.jsonl").read_text().splitlines()]
    (run_dir,) = [d for d in (out / "mlruns" / "0").iterdir() if d.is_dir()]
    logged = 0
    for key in ("train/loss", "lr1", "val/ndcg@10", "test/ndcg@10"):
        want = [(r["step"], r[key]) for r in rows if key in r]
        lines = (run_dir / "metrics" / key.replace("/", ".")).read_text().splitlines()
        got = [(int(s), float(v)) for _, v, s in (line.split() for line in lines)]
        check(want and got == want, f"MLflow's {key} rows differ from metrics.jsonl's")
        logged += len(got)
    params = len(list((run_dir / "params").iterdir()))
    log(f"loggers run on {card}: MLflow {params} params and {logged} metric lines of "
        f"train/loss, lr1, val/ndcg@10 and test/ndcg@10, every row of metrics.jsonl; "
        f"TensorBoard {tb}")

    kc.reset()
    t0 = time.perf_counter()
    best = cli_sweep.main(base + ["sweep.optimizer1.lr=1e-3,5e-4",
                                  f"trainer.output_dir={out / 'sweep'}"])
    total = add_counts(total, kc.read())
    table = (out / "sweep" / "sweep_results.csv").read_text().strip()
    log(f"cli.sweep on {card}, 2 points of one epoch in {time.perf_counter() - t0:.2f} s; "
        f"sweep_results.csv:\n  " + table.replace("\n", "\n  ") + f"\n  best: {best}")
    check(len(table.splitlines()) == 3, "sweep_results.csv does not hold two runs")
    return total


def tfrecord_count(path: Path) -> int:
    """The records of a TFRecord file (an 8-byte length, its CRC, the
    record, its CRC), counted without a protobuf reader."""
    data, i, n = path.read_bytes(), 0, 0
    while i + 12 <= len(data):
        (length,) = np.frombuffer(data[i:i + 8], dtype="<u8")
        i += 12 + int(length) + 4
        n += 1
    return n


def run_training_variants_path(kc: Counts, card: str, ml1m: dict, large_data) -> dict:
    """Phase 19. -> the launch counts of its ml-1m runs."""
    t0 = time.perf_counter()
    remat_long_classes(kc, card)
    remat_ring_step(kc, card)
    t1 = time.perf_counter()
    counts = ml1m_remat_and_seeds(kc, card, ml1m)
    t2 = time.perf_counter()
    async_checkpoint_at_10m(card, large_data)
    t3 = time.perf_counter()
    counts = add_counts(counts, one_epoch_knobs(kc, card, ml1m))
    log(f"phase 19 took {time.perf_counter() - t0:.1f} s: remat on ml-20m-hstu-long "
        f"{t1 - t0:.1f} s, the ml-1m remat and seed runs {t2 - t1:.1f} s, async checkpoints "
        f"{t3 - t2:.1f} s, the one-epoch runs {time.perf_counter() - t3:.1f} s")
    return counts

# ---------------------------------------------------------------- phase 20 (the last one-card gaps)

# (label, preset, overrides, HSTU attention launches a step, count / lse pairs a step)
BF16_RUN = ("ml-1m-hstu bfloat16", "ml-1m-hstu", ["model.compute_dtype=bfloat16"], 2, 1)
# item_embedding_dim=256 alone: attention_dim and linear_dim follow it (one
# 256-wide head), and the lse runs at D=256
WIDE_RUN = ("ml-1m-hstu D=256", "ml-1m-hstu", ["model.item_embedding_dim=256"], 2, 1)
WIDE = 256


def wide_kernel_resources(kern, build_logs: dict) -> None:
    """Registers (nvcc -Xptxas -v, phase 1's build) and dynamic shared memory
    a block of the wide kernels uses: the attention pair's wide kernels and
    the lse pair's 256-column-slice instantiations (kSliced)."""
    import re

    for name, text in build_logs.items():
        lines = text.splitlines()
        for i, line in enumerate(lines):
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if not entry or not re.search(r"wide_kernel|ILi\dELi32ELi\dELb1E", entry.group(1)):
                continue
            used = next((x.strip() for x in lines[i + 1 : i + 4] if "Used" in x), "")
            spill = next((x.strip() for x in lines[i + 1 : i + 4] if "spill" in x), "")
            short = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_\d+_", "", entry.group(1))[:90]
            log(f"  {name}: {short}: {used} {spill}")
    fwd, bwd = kern._kernel_lib(), kern._kernel_lib_bwd()
    for d in (130, 192, WIDE):
        log(f"  width {d}: attention forward {fwd.hstu_attention_fwd_smem_bytes(d, d, 128)} "
            f"bytes of dynamic shared memory a block, backward (N=L=211) "
            f"{bwd.hstu_attention_bwd_smem_bytes(211, d, d, 211, 128)}; the lse pair none "
            f"(its 4 KB lists are static)")


def check_wide_kernels(kern, count_kern, lse_kern) -> dict:
    """Rows 1, 2, 4 and 5 at width 256 against their plain versions, timed
    beside their bounds as phase 2 does: the attention pair at the padded
    ml-1m training shape (B=128, N=L=211, one 256-wide head, ragged), the lse
    pair at [26880, 256] x [3883, 256] (the ml-1m catalog) and at D=192."""
    ragged = np.random.default_rng(2).integers(2, 211, size=126).tolist()
    lengths = [1, 211] + ragged
    rows = {"fwd": check_attention(kern, kern.KERNEL, 80, 128, 211, 1, WIDE, lengths),
            "bwd": check_attention_bwd(kern, 81, 128, 211, 1, WIDE, lengths)}
    offsets, positive = negative_draws(3883, TRAIN_BT, TRAIN_R, 3883)
    count = count_kern.count_offsets(offsets, positive, 3883)
    rows["lse_fwd"], rows["lse_bwd"] = check_dense_neg_lse(lse_kern, count, TRAIN_BT, WIDE, 3883,
                                                           0.05)
    check_dense_neg_lse(lse_kern, count, TRAIN_BT, 192, 3883, 0.05)
    return rows


def approx_against_exact(card: str) -> None:
    """/v1/retrieve on phase 3's synthetic-hstu model with
    index.approx_top_k_recall=0.95, graphed: ids and scores equal to the
    exact engine's, a 32-row request and 8 single rows (ops/topk.py: the knob
    selects exactly off the TPU, as jax.lax.approx_max_k does)."""
    from mygenerativerecommenders_tpu_torch.cli.serve import build_engine
    from mygenerativerecommenders_tpu_torch.serving.service import RecommenderHTTPServer

    argv = ["experiment=synthetic-hstu", f"data.data_dir={OUT_DIR / 'data'}",
            f"trainer.ckpt_path={OUT_DIR / 'synthetic-hstu.pt'}"]
    exact, _ = build_engine(argv)
    approx, _ = build_engine(argv + ["model.index.approx_top_k_recall=0.95"])
    check(approx.graphed and approx.cfg.model.index.approx_top_k_recall == 0.95,
          "the approx engine is not graphed or lost its recall target")
    big, singles = make_requests(exact.all_item_ids, seed=7)
    catalog_set = set(exact.all_item_ids.tolist())
    server = RecommenderHTTPServer(approx, "127.0.0.1", 0).start()
    try:
        answers = [(req, http(server.port, "/v1/retrieve", req)[0]) for req in [big] + singles[:8]]
    finally:
        server.stop()
    for req, body in answers:
        check_answer(req, body, catalog_set, approx.max_len, req["k"])
        want = exact.retrieve(req["sequences"], req.get("timestamps"), k=req["k"])
        check(body["ids"] == want[0] and body["scores"] == want[1],
              "index.approx_top_k_recall=0.95 answered otherwise than the exact engine")
    log(f"/v1/retrieve with index.approx_top_k_recall=0.95 on {card} (phase 3's "
        f"synthetic-hstu weights): ids and scores equal to the exact engine's on "
        f"{len(answers)} requests (a 32-row one, 8 single rows)")
    del exact, approx


def csv_front_end(card: str, root: Path) -> None:
    """A competition-style CSV (user_id, sequence_item_ids,
    sequence_timestamps, sequence_ratings) written from phase 15's ml-1m
    draw, through DynamicSequenceDataset into two epochs of graphed
    ml-1m-hstu train steps on the card: losses finite and falling."""
    import csv as csv_module

    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.data.dynamic_dataset import DynamicSequenceDataset
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    src = root / "processed" / "ml-1m" / "sasrec_format.csv"
    dst = OUT_DIR / "competition.csv"
    cols = ["user_id", "sequence_item_ids", "sequence_timestamps", "sequence_ratings"]
    with open(src, newline="") as f, open(dst, "w", newline="") as g:
        writer = csv_module.writer(g)
        writer.writerow(cols)
        for row in csv_module.DictReader(f):
            writer.writerow([row[c] for c in cols])
    t0 = time.perf_counter()
    ds = DynamicSequenceDataset.from_csv(str(dst), max_sequence_length=200)
    parse_s = time.perf_counter() - t0
    check(ds.item_column == "item_ids" and len(ds) == 6040 and int(ds.lengths.min()) >= 1,
          f"the CSV gave {len(ds)} users, item column {ds.item_column}")
    trainer = Trainer(parse_args(["experiment=ml-1m-hstu", f"data.data_dir={root}",
                                  f"trainer.output_dir={OUT_DIR / 'csv_front_end'}"]))
    trainer.model.train()
    k = trainer.cfg.trainer.steps_per_call
    losses = []
    t0 = time.perf_counter()
    for epoch in range(2):
        batches = [trainer._put(b) for b in ds.batches(128, shuffle=True, seed=epoch)]
        for i in range(0, len(batches), k):
            losses += trainer.train_steps(batches[i : i + k], trainer.lr1).cpu().tolist()
    torch.cuda.synchronize()
    losses = np.asarray(losses)
    log(f"CSV front end on {card}: {dst.name} ({len(ds)} users, columns {cols}) parsed in "
        f"{parse_s:.2f} s by DynamicSequenceDataset; {len(losses)} graphed ml-1m-hstu steps in "
        f"{time.perf_counter() - t0:.2f} s: loss first eight mean {losses[:8].mean():.4f}, last "
        f"eight mean {losses[-8:].mean():.4f}")
    check(bool(np.isfinite(losses).all()), "a non-finite loss on the CSV's batches")
    check(losses[-8:].mean() < losses[:8].mean(), "the loss on the CSV's batches did not fall")
    del trainer


def run_last_gaps_path(kc: Counts, card: str, ml1m: dict, kern, count_kern, lse_kern,
                       build_logs: dict) -> dict:
    """Phase 20. -> {"bf16_counts": the bfloat16 run's launches,
    "wide_counts": the D=256 run's, "wide": rows 1, 2, 4, 5 at width 256}."""
    t0 = time.perf_counter()
    root, out = ml1m["root"], OUT_DIR / "last_gaps"
    wide_kernel_resources(kern, build_logs)
    wide = check_wide_kernels(kern, count_kern, lse_kern)
    # (a) compute_dtype=bfloat16: the rounding points of models/precision.py
    counts, test, _ = train_family(kc, card, BF16_RUN, CUT_EPOCHS, root, out, "bfloat16 path")
    base = ml1m["test"]
    log(f"  test metrics on {card}: {test_line(BF16_RUN[0], CUT_EPOCHS, test)} beside ml-1m-hstu at "
        f"float32 (phase 15): ndcg@10 {base['test/ndcg@10']:.5f}, hr@10 "
        f"{base['test/hr@10']:.5f}, mrr {base['test/mrr']:.5f}")
    check(test["test/ndcg@10"] >= MIN_FAMILY_NDCG10,
          f"bfloat16: test ndcg@10 {test['test/ndcg@10']} below {MIN_FAMILY_NDCG10}")
    family_steps_side_by_side(kc, card, root, runs=(BF16_RUN,))
    family_card_against_cpu(root, runs=(BF16_RUN,))
    # (b) item_embedding_dim=256: rows 1, 2, 4 and 5 take their wide paths
    wide_counts, test, rundir = train_family(kc, card, WIDE_RUN, 1, root, out, "wide path")
    log(f"  {test_line(WIDE_RUN[0], 1, test)}; launched at width {WIDE}: "
        f"{kern.KERNEL} {wide_counts[kern.KERNEL]}, {kern.KERNEL_BWD} "
        f"{wide_counts[kern.KERNEL_BWD]}, {lse_kern.KERNEL} {wide_counts[lse_kern.KERNEL]}, "
        f"{lse_kern.KERNEL_BWD} {wide_counts[lse_kern.KERNEL_BWD]}")
    check(all(wide_counts[name] > 0 for name in (kern.KERNEL, kern.KERNEL_BWD, lse_kern.KERNEL,
                                                 lse_kern.KERNEL_BWD)),
          "a wide kernel was not launched on the D=256 run")
    family_steps_side_by_side(kc, card, root, runs=(WIDE_RUN,))
    graphed_against_eager([(WIDE_RUN[0] + ", padded", family_args(WIDE_RUN, root), [None])])
    family_card_against_cpu(root, runs=(WIDE_RUN,))
    serve_against_cpu(card, WIDE_RUN[0], family_args(WIDE_RUN, root) + [
        f"trainer.ckpt_path={rundir / 'checkpoints' / 'best.pt'}"])
    # (c) index.approx_top_k_recall and (d) the CSV front end
    approx_against_exact(card)
    csv_front_end(card, root)
    log(f"phase 20 took {time.perf_counter() - t0:.1f} s")
    return {"bf16_counts": counts, "wide_counts": wide_counts, "wide": wide}


# ---------------------------------------------------------------- phase 21

# (b) ml-20m-hstu-long's ring at two 256-wide heads (attention_dim and
# linear_dim follow item_embedding_dim: dqk = dv = 256, H = 2)
WIDE_RING_ARGS = RING_ARGS + ["model.item_embedding_dim=256",
                              f"data.synthetic_num_users={RING_USERS}"]
# rows of the card-against-CPU batch: the CPU side's depth cut (2 before phase
# 24 (d))
WIDE_RING_ROWS = 1
# (c) the four kinds at ml-1m width (D=50, which 2 column shards divide)
LOCAL_RUN = ("ml-1m-hstu local", "ml-1m-hstu", [], 2, 1)
A2A_RUN = ("ml-1m-hstu sharded_a2a", "ml-1m-hstu",
           ["model.embedding.kind=sharded_a2a", "model.embedding.num_shards=8"], 2, 1)
SHARDED_RUNS = (
    ("ml-1m-hstu sharded_local", "ml-1m-hstu",
     ["model.embedding.kind=sharded_local", "model.embedding.num_shards=8"], 2, 1),
    A2A_RUN,
    ("ml-1m-hstu sharded_2d", "ml-1m-hstu",
     ["model.embedding.kind=sharded_2d", "model.embedding.num_shards=8",
      "model.embedding.col_shards=2"], 2, 1),
    ("ml-1m-hstu sharded_column", "ml-1m-hstu",
     ["model.embedding.kind=sharded_column", "model.embedding.num_shards=2"], 2, 1),
)
# (d) synthetic-large-vocab as shipped: sharded_a2a, 8 shards, int8 index,
# index.sharded=auto; (e) the 100M preset's 2-D layout at 10M items
SHIPPED_ARGS = ["experiment=synthetic-large-vocab"]
# the shipped cli.train's depth cut: users (the preset's 4,096; 2,048 before
# phase 24)
SHIPPED_USERS = 1024
# rows of the 2-D card-against-CPU batch: the CPU side's depth cut (16 before
# phase 24 (d))
TWO_D_CPU_ROWS = 8
TWO_D_ARGS = ["experiment=synthetic-large-vocab-100m", "data.expected_max_item_id=10000000",
              "data.expected_num_unique_items=10000000"]


def wide_chunk_kernels(chunk_kern, build_logs: dict) -> dict:
    """(a) The wide chunk kernels' registers (-Xptxas -v, phase 1's build)
    and dynamic shared memory at widths 130, 192 and 256; rows 9-10 at width
    256 against their plain versions with phase 2's checks, timed beside
    their bounds, on the live 130 x 130 chunk and the 259 x 259 fully live
    one (B=32, H=2, L=1035). -> {"fwd", "bwd"} of the 130 x 130 chunk."""
    import re

    for name in (chunk_kern.KERNEL, chunk_kern.KERNEL_BWD):
        lines = build_logs.get(name, "").splitlines()
        for i, line in enumerate(lines):
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if not entry or "wide_kernel" not in entry.group(1):
                continue
            used = next((x.strip() for x in lines[i + 1 : i + 4] if "Used" in x), "")
            spill = next((x.strip() for x in lines[i + 1 : i + 4] if "spill" in x), "")
            log(f"  {name}: {entry.group(1)[:90]}: {used} {spill}")
    fwd, bwd = chunk_kern._kernel_lib(), chunk_kern._kernel_lib_bwd()
    for d in (130, 192, WIDE):
        log(f"  width {d}: chunk forward {fwd.hstu_chunk_fwd_smem_bytes(d, d, 128)} bytes of "
            f"dynamic shared memory a block, backward (L=1035) "
            f"{bwd.hstu_chunk_bwd_smem_bytes(d, d, 1035, 128)}")
    fwd_row, bwd_row = check_chunk(chunk_kern, 57, 32, 130, 130, 2, WIDE, -130, 1035, timed=True)
    check_chunk(chunk_kern, 58, 32, 130, 130, 2, WIDE, 0, 1035)
    check_chunk(chunk_kern, 59, 32, 259, 259, 2, WIDE, -518, 1035, timed=True)
    check_chunk(chunk_kern, 60, 32, 130, 130, 2, WIDE, -910, 1035)
    return {"fwd": fwd_row, "bwd": bwd_row}


def wide_ring(kc: Counts, card: str) -> dict:
    """(b) The ring at two 256-wide heads, zigzag then contiguous: phase 5's
    check of one step on the card against the CPU (WIDE_RING_ROWS rows),
    phase 10's check of one graphed step against one eager one, and the step
    eager and graphed side by side. -> the launch counts of it all,
    every count set to 0 just before."""
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer
    from mygenerativerecommenders_tpu_torch.train.task_retrieval import make_loss_fn

    kc.reset()
    for zigzag in (True, False):
        layout = "zigzag" if zigzag else "contiguous"
        args = WIDE_RING_ARGS + [f"model.encoder.sp_zigzag={zigzag}"]
        cfg = parse_args(args)
        enc = cfg.model.encoder
        data = RecoData(cfg.data, seed=cfg.trainer.seed)
        resolve(cfg, data.max_item_id)
        check((enc.attention_dim, enc.linear_dim, enc.num_heads, enc.sp_shards) == (WIDE, WIDE,
                                                                                     2, 4),
              f"not two {WIDE}-wide heads on the ring: {enc}")
        batch = {k: v[:WIDE_RING_ROWS] for k, v in next(iter(data.loader("train"))).items()}
        n = batch["ids"].shape[1] + cfg.model.gr_output_length + 1
        offsets = torch.randint(0, len(data.all_item_ids),
                                (WIDE_RING_ROWS, n - 1, cfg.model.loss.num_to_sample),
                                generator=torch.Generator().manual_seed(3), dtype=torch.int32)
        t0 = time.perf_counter()
        compare_card_and_cpu(
            f"{cfg.experiment}, {layout} ring at two {WIDE}-wide heads, {WIDE_RING_ROWS} rows",
            cfg, batch, lambda model, b, device: make_loss_fn(model, cfg, data.all_item_ids)(
                b, neg_offsets=offsets.to(device)))
        log(f"  the card-against-CPU step took {time.perf_counter() - t0:.1f} s")
        # one step, as phase 16 holds NS-5: from the second on the chunk
        # backward's float atomics (the bias tables' gradients) differ run to
        # run, eager against eager too, and Adam turns that noise into steps
        # of near-zero gradients (3 steps, contiguous: one _uvqk element of
        # block 7 1.9e-6 and 2.8e-6 apart, against atol 1e-6, in two of five
        # runs; the losses equal to the bit)
        graphed_against_eager([(f"{cfg.experiment}, {layout} ring, D={WIDE}", args, [None])],
                              steps=1, data=data)
        trainer = Trainer(parse_args(args + ["trainer.steps_per_call=8",
                                             f"trainer.output_dir={OUT_DIR / 'wide_ring'}"]),
                          data=data)
        trainer.model.train()
        batches = [trainer._put(b) for _, b in zip(range(2), trainer.data.loader("train"))]
        calls = enc.num_blocks * ring_chunk_calls(enc.sp_shards, zigzag)
        times = eager_and_graphed(kc, {
            "eager": lambda i: trainer.train_step(batches[i % 2], trainer.lr1),
            "graphed": lambda i: trainer.train_steps([batches[i % 2]], trainer.lr1),
        }, f"ring train step, {layout}, D={WIDE}, H=2, batch {cfg.data.batch_size}",
            kc.per_step(0, calls), trainer.train_steps.graphs, card, reps=3)
        log(f"  chunk forwards and backwards a step: {calls} and {calls}; examples/s eager "
            f"{1e3 * cfg.data.batch_size / times['eager']['p50']:.1f}, graphed "
            f"{1e3 * cfg.data.batch_size / times['graphed']['p50']:.1f}")
        del trainer, batches
        gc.collect()
        torch.cuda.empty_cache()
    counts = kc.read()
    check(counts[kc.chunk.KERNEL] > 0 and counts[kc.chunk.KERNEL_BWD] > 0,
          f"the wide ring launched no chunk kernel: {counts}")
    return counts


def sharded_kinds(kc: Counts, card: str, ml1m: dict) -> dict:
    """(c) The four kinds at ml-1m width on phase 15's files: `cli.train` of
    sharded_a2a for CUT_EPOCHS graphed epochs (cut from 30 for phase 24's
    time; its 30-epoch numbers are in PERF.md section 5), its eval on the
    sharded top-k (test ndcg@10 at least MIN_FAMILY_NDCG10, beside phase
    15's local run); each kind's step eager and graphed beside the local
    table's, phase 10's and phase 5's checks. -> the run's launch counts."""
    root, out = ml1m["root"], OUT_DIR / "sharded"
    counts, test, _ = train_family(kc, card, A2A_RUN, CUT_EPOCHS, root, out, "sharded_a2a path")
    base = ml1m["test"]
    log(f"  test metrics on {card}: {test_line(A2A_RUN[0], CUT_EPOCHS, test)} (the sharded "
        f"index: 8 shards of the catalog padded to 3,888 rows) beside ml-1m-hstu's local table "
        f"(phase 15, 30 epochs): ndcg@10 {base['test/ndcg@10']:.5f}, hr@10 "
        f"{base['test/hr@10']:.5f}, mrr {base['test/mrr']:.5f}")
    check(test["test/ndcg@10"] >= MIN_FAMILY_NDCG10,
          f"sharded_a2a: test ndcg@10 {test['test/ndcg@10']} below {MIN_FAMILY_NDCG10}")
    family_steps_side_by_side(kc, card, root, runs=(LOCAL_RUN,) + SHARDED_RUNS)
    graphed_against_eager([(run[0] + ", padded", family_args(run, root), [None])
                           for run in SHARDED_RUNS])
    family_card_against_cpu(root, runs=SHARDED_RUNS)
    return counts


def shipped_large_vocab(kc: Counts, card: str, data) -> dict:
    """(d) synthetic-large-vocab as shipped: `cli.train` for one graphed
    epoch (its eval on the sharded int8 top-k), `/v1/retrieve` from its
    best.pt; on the engine's queries the exact sharded top-k against
    `mips_top_k` and the int8 sharded recall against the exact scan; the
    step's peak memory and device ms beside phase 13's one-card overlay.
    -> the launch counts of the run and the engine calls."""
    import shutil
    import tempfile

    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.cli.serve import build_engine
    from mygenerativerecommenders_tpu_torch.ops.sequence import get_current_embeddings
    from mygenerativerecommenders_tpu_torch.ops.topk import mips_top_k, topk_agree
    from mygenerativerecommenders_tpu_torch.parallel.topk_sharded import (
        sharded_mips_top_k,
        sharded_mips_top_k_int8,
    )
    from mygenerativerecommenders_tpu_torch.serving.service import RecommenderHTTPServer
    from mygenerativerecommenders_tpu_torch.train import task_retrieval
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer
    from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch

    cfg = cli_train.parse_args(SHIPPED_ARGS)
    e = cfg.model.embedding
    check((e.kind, e.num_shards, cfg.model.index.quantize, cfg.model.index.sharded)
          == ("sharded_a2a", 8, "int8", "auto") and task_retrieval.index_sharded_on(cfg),
          "synthetic-large-vocab is not shipped as sharded_a2a with the sharded int8 index")
    tmp = Path(tempfile.mkdtemp(prefix="shipped_", dir=OUT_DIR))
    # graphed (the preset's trainer takes one step a call), two steps a call:
    # eight logged losses over the cut epoch
    args = SHIPPED_ARGS + [f"trainer.output_dir={tmp}", "trainer.max_epochs=1",
                           "trainer.min_epochs=1", "trainer.log_every_n_steps=1",
                           "trainer.steps_per_call=2", f"data.synthetic_num_users={SHIPPED_USERS}"]
    made = []  # the run's trainer, kept to time its step afterwards
    init = Trainer.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    try:
        torch.cuda.reset_peak_memory_stats()
        kc.reset()
        t0 = time.perf_counter()
        Trainer.__init__ = keep
        try:
            monitored = cli_train.main(args)
        finally:
            Trainer.__init__ = init
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, graph_counts = kc.read(), kc.read_graphs()
        per_epoch = -(-SHIPPED_USERS // cfg.data.batch_size)
        run_peak = peak()
        log(f"synthetic-large-vocab as shipped: cli.train on {card}, {e.kind} with "
            f"{e.num_shards} shards of {-(-10_000_001 // 8):,} rows, the gather loss, the "
            f"sharded int8 index, {SHIPPED_USERS} users (cut from 4,096): {per_epoch} optimizer "
            f"steps and {2 * per_epoch} eval batches in {wall:.2f} s; peak memory {run_peak}; "
            f"launches {counts}")
        losses, steps, _, test = read_training_run(
            tmp / "synthetic-large-vocab" / "metrics.jsonl", 1, monitored,
            chance=f"log 513 = {np.log(513):.4f}")
        check(steps == per_epoch, f"{steps} optimizer steps, expected {per_epoch}")
        check(graph_counts.get("train") and graph_counts.get("eval"),
              "the shipped run did not replay graphed steps and eval batches")
        check_step_launches(kc, steps, 2 * per_epoch, counts, graph_counts,
                            attn=cfg.model.encoder.num_blocks, lse=0)
        log(f"  test ndcg@10 {test['test/ndcg@10']:.5f}, hr@200 {test['test/hr@200']:.5f} after "
            f"one epoch")

        engine, _ = build_engine(SHIPPED_ARGS + [
            f"trainer.ckpt_path={tmp / 'synthetic-large-vocab' / 'checkpoints' / 'best.pt'}"])
        check(engine.graphed and engine.candidates.exact.shape[0] % 8 == 0,
              "the shipped engine is not graphed on the sharded index")
        catalog = np.asarray(data.all_item_ids)
        rng = np.random.default_rng(21)
        rows = [rng.choice(catalog, size=int(m)).tolist()
                for m in np.concatenate([[1, 200], rng.integers(2, 200, size=30)])]
        req = {"sequences": rows}
        server = RecommenderHTTPServer(engine, "127.0.0.1", 0).start()
        try:
            http(server.port, "/v1/retrieve", req)  # the capture
            kc.reset()
            ms = [1e3 * http(server.port, "/v1/retrieve", req)[1] for _ in range(5)]
            body = http(server.port, "/v1/retrieve", req)[0]
            serve_counts = kc.read()
        finally:
            server.stop()
        k = engine.cfg.model.index.k
        for hist, ids in zip(rows, body["ids"]):
            check(len(ids) == k and not set(hist) & set(ids) and 0 not in ids,
                  "a shipped /v1/retrieve answer holds a history id, id 0 or too few ids")
        log(f"  /v1/retrieve from its best.pt, 32 rows, k={k}: p50 {np.percentile(ms, 50):.3f} "
            f"ms over 5 requests on the sharded int8 index; launches {serve_counts}")

        # the engine's own queries through the three top-k's
        batch, _ = engine._pack(rows, None)
        with torch.no_grad():
            dev = {key: torch.from_numpy(v).cuda() for key, v in batch.items()}
            seq, _, _ = seq_features_from_batch(dev, engine.cfg.model.gr_output_length + 1)
            seq = seq._replace(past_embeddings=engine.model.item_embeddings(seq.past_ids))
            encoded, lengths = engine.model(seq)
            queries = get_current_embeddings(lengths, encoded)
            cands = engine.candidates
            group = task_retrieval.index_shards(engine.cfg)
            padded = torch.as_tensor(task_retrieval.padded_catalog(catalog, group), device="cuda")
            cat_t = torch.as_tensor(catalog.astype(np.int64), device="cuda")
            s_ids, s_scores = sharded_mips_top_k(group, queries, cands.exact, padded, k,
                                                 invalid_ids=seq.past_ids)
            e_ids, e_scores = mips_top_k(queries, cands.exact[: len(catalog)], cat_t, k,
                                         invalid_ids=seq.past_ids, max_item_id=data.max_item_id)
            q_ids, _ = sharded_mips_top_k_int8(group, queries, cands.q, cands.scales, cands.exact,
                                               padded, k, invalid_ids=seq.past_ids,
                                               over_fetch=engine.cfg.model.index.rescore_over_fetch)
            sharded_ms = device_ms(lambda: sharded_mips_top_k(
                group, queries, cands.exact, padded, k, invalid_ids=seq.past_ids), 3)
            int8_ms = device_ms(lambda: sharded_mips_top_k_int8(
                group, queries, cands.q, cands.scales, cands.exact, padded, k,
                invalid_ids=seq.past_ids), 3)
        agree = topk_agree(s_ids.cpu().numpy(), s_scores.cpu().numpy(), e_ids.cpu().numpy(),
                           e_scores.cpu().numpy(), 1e-5)
        q_np, e_np = q_ids.cpu().numpy(), e_ids.cpu().numpy()
        recall = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(q_np, e_np)]))
        log(f"  the exact sharded top-k against mips_top_k, 32 queries, k={k}, X="
            f"{len(catalog):,}: {'agree' if agree is None else agree}; the int8 sharded top-k's "
            f"recall against the exact scan {recall:.4f} beside the replicated int8 path's "
            f"{PHASE13.get('recall', float('nan')):.4f} (phase 13; JAX's bar 0.95); device "
            f"{sharded_ms:.3f} ms exact sharded, {int8_ms:.3f} ms int8 sharded a call")
        check(agree is None, f"the exact sharded top-k disagrees with mips_top_k: {agree}")
        check(recall >= 0.95, f"int8 sharded recall {recall} below 0.95")
        del engine
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # the run's graphed step by hand (its trainer, after the epoch), beside
    # phase 13's one-card overlay (a); graphed only: the eager step's
    # activations do not fit beside the run's graph pools
    trainer = made[0]
    trainer.model.train()
    batches = [trainer._put(b) for _, b in zip(range(2), trainer.data.loader("train"))]
    times = {"graphed": step_numbers(
        kc, lambda i: trainer.train_steps([batches[i % 2]], trainer.lr1),
        "synthetic-large-vocab step as shipped (sharded_a2a), graphed",
        kc.per_step(trainer.cfg.model.encoder.num_blocks, 0, lse=0), reps=4)}
    overlay = PHASE13.get("(a) gather + dense AdamW", {})
    log(f"  as shipped: peak memory {run_peak} (the cli.train run), graphed device "
        f"{times['graphed']['device_ms']:.3f} "
        f"ms, p50 {times['graphed']['p50']:.3f} ms | phase 13's one-card overlay (local table, "
        f"the same gather loss): peak {overlay.get('peak')}, graphed device "
        f"{overlay.get('device_ms', float('nan')):.3f} ms, p50 "
        f"{overlay.get('p50', float('nan')):.3f} ms on {card}")
    del trainer, batches, made
    gc.collect()
    torch.cuda.empty_cache()
    return {key: counts[key] + serve_counts[key] for key in counts}


def two_d_and_amazon(kc: Counts, card: str, data) -> None:
    """(e) synthetic-large-vocab-100m's 2-D layout (8 row x 2 column shards)
    at a 10M vocabulary: two graphed steps, and phase 5's check (the CPU
    holds the 10M table, as in phase 14's check of the local one; the same
    weights, batch and negatives); then amzn-books-sharded on phase 15's
    amzn-books files for one graphed epoch, beside phase 15's amzn-books
    run."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer
    from mygenerativerecommenders_tpu_torch.train.task_retrieval import loss_variant, make_loss_fn

    torch.cuda.reset_peak_memory_stats()
    cfg = cli_train.parse_args(TWO_D_ARGS + ["trainer.steps_per_call=8",
                                             f"trainer.output_dir={OUT_DIR / 'two_d'}"])
    e = cfg.model.embedding
    check((e.kind, e.num_shards, e.col_shards) == ("sharded_2d", 8, 2), "not the 2-D layout")
    trainer = Trainer(cfg, data=data)
    batches = [trainer._put(b) for _, b in zip(range(2), trainer.data.loader("train"))]
    trainer.model.train()
    kc.reset()
    t0 = time.perf_counter()
    losses = trainer.train_steps(batches, trainer.lr1).cpu().numpy()
    torch.cuda.synchronize()
    counts, graphs_made = kc.read(), kc.read_graphs()
    check(bool(np.isfinite(losses).all()) and graphs_made["train"]["replays"] == 2,
          f"the 2-D steps: losses {losses}, graphs {graphs_made}")
    walls = []
    for i in range(3):
        t1 = time.perf_counter()
        trainer.train_steps([batches[i % 2]], trainer.lr1)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t1))
    dev = profile_device(lambda i: trainer.train_steps([batches[i % 2]], trainer.lr1), reps=2,
                         what="the 2-D step, graphed", wall_ms=float(np.median(walls)), top=4)[0]
    log(f"synthetic-large-vocab-100m's 2-D table at 10,000,000 items (cut from 100M: the table, "
        f"AdamW's moments and the dense gradient would take 102 GB), {e.num_shards} x "
        f"{e.col_shards} shards: two graphed steps (their capture and warm-up runs included) in "
        f"{time.perf_counter() - t0:.2f} s, losses {losses.tolist()}, graphed p50 "
        f"{np.median(walls):.3f} ms and device {dev:.3f} ms a step, peak memory {peak()}; "
        f"launches of the two steps {counts} on {card}")
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()

    check(loss_variant(cfg, len(data.all_item_ids)) == "gather",
          "the 2-D step is not the gather loss")
    batch = {k: v[:TWO_D_CPU_ROWS] for k, v in next(iter(data.loader("train"))).items()}
    n = batch["ids"].shape[1] + cfg.model.gr_output_length + 1
    offsets = torch.randint(0, len(data.all_item_ids),
                            (batch["ids"].shape[0], n - 1, cfg.model.loss.num_to_sample),
                            generator=torch.Generator().manual_seed(3), dtype=torch.int32)
    t0 = time.perf_counter()
    compare_card_and_cpu(
        f"synthetic-large-vocab-100m's 2-D table at 10,000,000 items, a batch of "
        f"{batch['ids'].shape[0]} rows (the gather loss)", cfg, batch,
        lambda model, b, device: make_loss_fn(model, cfg, data.all_item_ids)(
            b, neg_offsets=offsets.to(device)))
    log(f"  the card and CPU step with both models built: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    root = REAL_DIR / "amzn"
    out = OUT_DIR / "amzn_sharded"
    args = ["experiment=amzn-books-sharded", f"data.data_dir={root}",
            f"trainer.output_dir={out}", "trainer.max_epochs=1", "trainer.min_epochs=1",
            "trainer.log_every_n_steps=1"]
    acfg = cli_train.parse_args(args)
    check(acfg.model.embedding.kind == "sharded_a2a" and not acfg.model.embedding.lazy_update,
          "not amzn-books-sharded")
    kc.reset()
    t0 = time.perf_counter()
    cli_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kc.read()
    check(counts[kc.attn.KERNEL] > 0, "amzn-books-sharded launched no attention kernel")
    losses, test = _finite_run(out / "amzn-books-sharded" / "metrics.jsonl", "amzn-books-sharded")
    base = PHASE15_AMZN
    log(f"amzn-books-sharded on phase 15's amzn-books files, one graphed epoch (packed, "
        f"sharded_a2a over 8 shards, dense AdamW, packed eval on the sharded index): "
        f"{len(losses)} logged steps in {wall:.2f} s, last loss {losses[-1]:.4f}, test ndcg@10 "
        f"{test['test/ndcg@10']:.5f} | phase 15's amzn-books (local table, lazy update): "
        f"{base.get('steps')} logged steps in {base.get('wall', float('nan')):.2f} s, last loss "
        f"{base.get('loss', float('nan')):.4f}, test ndcg@10 "
        f"{base.get('ndcg10', float('nan')):.5f}; launches {counts} on {card}")


def run_sharded_path(kc: Counts, card: str, ml1m: dict, chunk_kern, build_logs: dict,
                     large_data) -> dict:
    """Phase 21. -> {"wide_chunk": rows 9-10 at width 256, "ring_counts": the
    wide ring's launches, "kinds_counts": the 30-epoch sharded_a2a run's,
    "shipped_counts": the shipped synthetic-large-vocab run's}."""
    t0 = time.perf_counter()
    wide_chunk = wide_chunk_kernels(chunk_kern, build_logs)
    t1 = time.perf_counter()
    ring_counts = wide_ring(kc, card)
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    kinds_counts = sharded_kinds(kc, card, ml1m)
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    shipped_counts = shipped_large_vocab(kc, card, large_data)
    t4 = time.perf_counter()
    two_d_and_amazon(kc, card, large_data)
    PHASE_S["21 (a)-(d)"] = t4 - t0
    log(f"phase 21 took {time.perf_counter() - t0:.1f} s: (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, "
        f"(c) {t3 - t2:.1f}, (d) {t4 - t3:.1f}, (e) {time.perf_counter() - t4:.1f}")
    return {"wide_chunk": wide_chunk, "ring_counts": ring_counts, "kinds_counts": kinds_counts,
            "shipped_counts": shipped_counts}


# ---------------------------------------------------------------- phase 22

DP_STEPS = 8  # phase 22 (a): one call of the presets' steps_per_call
DP_RTOL = 1e-6  # (a): one rank's all-reduce is an identity; atol 0
DP_DROPOUT_OFF = ["model.preprocessor.dropout_rate=0.0", "model.encoder.linear_dropout_rate=0.0"]
# (b): two processes on the one card over gloo, eagerly; each rank's batch is
# half the preset's global one
DP_TWO_PROCESS = {
    # 2,001 users: the ranks' last batches hold 41 and 40 rows of 64
    "synthetic-hstu, padded": ["experiment=synthetic-hstu", "data.synthetic_num_users=2001"],
    "ml-1m-hstu-packed": ["experiment=ml-1m-hstu-packed", "data.dataset_name=synthetic"],
}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def params_gap(got: dict, want: dict, names=None) -> tuple:
    """(the largest |got - want| / |want| of any element of the tensors
    `names` (default all), its tensor, whether they are all equal bit for
    bit); an element where want is 0 and got is not counts as inf."""
    worst, where, bits = 0.0, "", True
    for name, w in want.items():
        if names is not None and name not in names:
            continue
        g = got[name]
        bits &= torch.equal(g, w)
        diff = (g.double() - w.double()).abs()
        rel = torch.where(w != 0, diff / w.double().abs(), torch.where(diff > 0, np.inf, 0.0))
        if float(rel.max()) > worst:
            worst, where = float(rel.max()), name
    return worst, where, bits


def port_counts() -> Counts:
    """The launch counters of the port's kernel wrappers and its graphs."""
    from mygenerativerecommenders_tpu_torch.ops.kernels import (
        count_offsets,
        dense_neg_lse,
        hstu_attention,
        hstu_chunk,
    )
    from mygenerativerecommenders_tpu_torch.train import graphs

    return Counts(hstu_attention, count_offsets, dense_neg_lse, hstu_chunk, graphs)


def start_ranks(flag: str, job_path: Path, world: int = 2) -> list:
    """`world` processes of this script (`flag` and the job's path), each
    with torchrun's environment, sharing cuda:0, started before their job
    exists: each imports and makes its CUDA context, then waits for the job
    (`ranks_main`), so their start-up overlaps the work that writes it."""
    import os

    port, procs = str(free_port()), []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=port, PYTHONPATH=str(HERE))
        with open(job_path.parent / f"rank{rank}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "chip_smoke.py"), flag, str(job_path)],
                cwd=str(HERE), env=env, stdout=out, stderr=subprocess.STDOUT))
    return procs


def finish_ranks(phase: str, procs: list, job_path: Path, timeout: float = 900) -> list:
    """Wait for the rank processes (killed past `timeout`); a rank that fails
    fails the phase. -> each rank's results (`<job>.rank<r>.pt`)."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, p in enumerate(procs):
        text = (job_path.parent / f"rank{rank}.log").read_text()
        check(p.returncode == 0, f"{phase}: rank {rank} failed:\n{text[-3000:]}")
    return [torch.load(f"{job_path}.rank{r}.pt", weights_only=False) for r in range(len(procs))]


def compare_step(label: str, rank: int, got: dict, want: dict, bias_rtol: float = RTOL,
                 lr: float = 0.0) -> dict:
    """Hold a rank's step to the one-process step: the loss at rtol 1e-5,
    every gradient and parameter at RTOL / ATOL (a bias table's gradient at
    `bias_rtol`). With `lr`, a parameter whose one-process gradient is below
    EPS_GRAD in magnitude is held to 2 x lr instead: AdamW's first step, lr
    * g / (|g| + eps), moves it by up to lr, and there turns float noise in
    g into a gap of up to lr / eps times it (phase 14's rule for the 10M
    table). -> {(part, name): the largest gap}."""
    check(abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]),
          f"{label}: rank {rank}'s loss {got['loss']} vs {want['loss']}")
    gaps = {}
    for part in ("grads", "params"):
        for name, w in want[part].items():
            rtol = bias_rtol if part == "grads" and "_rel_attn_bias" in name else RTOL
            g = got[part][name]
            if part == "params" and lr:
                flat = want["grads"][name].abs() < EPS_GRAD
                ok, gaps[part, name] = within(g[~flat], w[~flat], rtol, ATOL) if (~flat).any() \
                    else (True, 0.0)
                if flat.any():
                    gap = float((g[flat] - w[flat]).abs().max())
                    ok = ok and gap <= 2 * lr
                    gaps["near eps", name] = gap
            else:
                ok, gaps[part, name] = within(g, w, rtol, ATOL)
            check(ok, f"{label}: rank {rank}'s {part[:-1]} {name} off by {gaps[part, name]:.3e}")
    return gaps


# a gradient entry below this is at the cliff of AdamW's first step (eps 1e-8)
EPS_GRAD = 1e-7


def nccl_world_one(kc: Counts, card: str, label: str, args: list, batches_of) -> dict:
    """Phase 22 (a) on one recipe: DP_STEPS graphed steps of a trainer with
    `trainer.distributed=true` (NCCL, world size 1, the all-reduces inside
    the step's graph) against the same steps of two trainers without it,
    from the same seed and batches. The first step's gradients, which the
    all-reduce sums, and the parameters after it within rtol DP_RTOL / atol
    0 of the one-process trainer's but for the bias tables (the attention
    backward adds theirs with float atomics, in an order that changes from
    run to run: their gradients held at BIAS_RTOL); the two all-reduces of
    the step issued while its graph was captured; the losses of the DP_STEPS
    steps at rtol 1e-5; the parameters after them logged (not checked)
    beside the gap of two one-process runs. Then the graphed step of each
    timed, a profiled replay's NCCL kernels and host calls, and an NCCL
    all-gather captured and replayed. -> (the timings, the launch
    counts of the data-parallel trainer's DP_STEPS steps: this slice's path)."""
    import os

    import torch.distributed as dist

    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.parallel import process_group
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    all_reduce, calls = dist.all_reduce, []

    def observed(t, *a, **k):  # torch's all_reduce, noting whether a capture is on
        calls.append((torch.cuda.is_current_stream_capturing(), t.numel()))
        return all_reduce(t, *a, **k)

    cfg = cli_train.parse_args(args)
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    blocks = cfg.model.encoder.num_blocks
    runs, times = {}, {}
    for name, extra in (("one process", []), ("one process, again", []),
                        ("trainer.distributed, NCCL world size 1", ["trainer.distributed=true"])):
        os.environ["MASTER_PORT"] = str(free_port())
        trainer = Trainer(cli_train.parse_args(
            args + extra + [f"trainer.output_dir={OUT_DIR / 'dp'}"]), data=data)
        check(trainer.steps_per_call == DP_STEPS, f"{label}: steps_per_call {trainer.steps_per_call}")
        distributed = trainer.dp is not None
        check(not distributed or (trainer.dp.backend, trainer.dp.size) == ("nccl", 1),
              f"{label}: not NCCL at world size 1")
        trainer.model.train()
        batches = batches_of(trainer)
        kc.reset()
        process_group.all_reduces = process_group.all_gathers = 0
        calls.clear()
        dist.all_reduce = observed
        try:
            first = trainer.train_steps(batches[:1], trainer.lr1)  # the capture, one replay
        finally:
            dist.all_reduce = all_reduce
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
        stepped = {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
        if distributed:
            # the warm-ups' sums eagerly, then the capture's: the weight sum
            # and the flat buffer of every gradient and the loss
            flat = sum(p.numel() for grp in trainer.optimizer.param_groups for p in grp["params"]
                       if p.requires_grad) + 1
            check([n for c, n in calls if c] == [1, flat]
                  and sum(not c for c, _ in calls) == 2 * kc.graphs.WARMUP_RUNS,
                  f"{label}: the all-reduces seen (capturing, size): {calls}")
        losses = torch.cat([first, trainer.train_steps(batches[1:], trainer.lr1)])
        torch.cuda.synchronize()
        if distributed:
            path_counts = kc.read()
        g = kc.read_graphs()["train"]
        check(g == {"captures": 1, "warmup_runs": 2, "replays": DP_STEPS}, f"{label}: graphs {g}")
        steps_run = g["warmup_runs"] + g["replays"]
        per_step = process_group.all_reduces / steps_run
        check(per_step == (2 if distributed else 0) and process_group.all_gathers == 0,
              f"{label}, {name}: {process_group.all_reduces} all-reduces in {steps_run} steps")
        runs[name] = (losses.cpu(), grads, stepped, {n: p.detach().cpu().clone()
                                                     for n, p in trainer.model.named_parameters()})
        if name != "one process, again":
            n = len(batches)
            times[name] = step_numbers(
                kc, lambda i: trainer.train_steps([batches[i % n]], trainer.lr1),
                f"phase 22 (a) {label}, {name}, graphed", kc.per_step(blocks, 0), reps=20)
            times[name]["all_reduces_a_step"] = per_step
        if distributed:
            # the all-reduces are nodes of the replayed graph: NCCL kernels
            # in the trace of one replay, nothing issued from the host
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                trainer.train_steps([batches[0]], trainer.lr1)
                torch.cuda.synchronize()
            nccl = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()]
            host_calls = [e for e in prof.key_averages()
                          if "allreduce" in e.key.lower().replace("_", "")]
            log(f"  {label}: one profiled replay's NCCL kernels: " + "; ".join(
                f"x{e.count} {e.self_device_time_total / 1e3:.4f} ms {e.key[:70]}" for e in nccl)
                + f"; host-side all_reduce calls in it: {sum(e.count for e in host_calls)}")
            check(not host_calls, f"{label}: an all_reduce issued from the host during a replay")
            nccl_gather_in_a_graph(trainer.device, label)
            process_group.shutdown()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    (l1, g1, s1, p1), (l2, g2, _, p2), (l3, g3, s3, p3) = runs.values()
    tables = {n for n in g1 if "_rel_attn_bias" in n}
    rest = set(g1) - tables
    gap, where, bits = params_gap(g3, g1, rest)
    check(gap <= DP_RTOL, f"{label}: the first step's gradient of {where} is {gap:.3e} from the "
          f"one-process step's, past rtol {DP_RTOL} / atol 0")
    sgap, swhere, sbits = params_gap(s3, s1, rest)
    check(sgap <= DP_RTOL, f"{label}: {swhere} after the first step is {sgap:.3e} from the "
          f"one-process step's, past rtol {DP_RTOL} / atol 0")
    for name in tables:
        ok, err = within(g3[name], g1[name], BIAS_RTOL, STEP_GRAD_ATOL)
        check(ok, f"{label}: the first step's gradient of {name} off by {err:.3e}")
    tgap, twhere, _ = params_gap(g3, g1, tables)
    again, _, again_bits = params_gap(g2, g1, rest)
    np.testing.assert_allclose(l3.numpy(), l1.numpy(), rtol=1e-5)
    after, after_where, after_bits = params_gap(p3, p1)
    floor, floor_where, _ = params_gap(p2, p1)
    log(f"phase 22 (a) {label} on {card}: the first graphed step's gradients but the bias "
        f"tables' {'bit-equal to' if bits else f'within {gap:.3e} of'} the one-process step's "
        f"(a second one-process run: {'bit-equal' if again_bits else f'{again:.3e}'}); the "
        f"bias tables' within {tgap:.3e} ({twhere}: float atomics); the parameters after the "
        f"first step but the bias tables' {'bit-equal' if sbits else f'within {sgap:.3e}'}; "
        f"losses of the {DP_STEPS} steps {'equal' if torch.equal(l3, l1) else 'within rtol 1e-5'}"
        f", last {float(l3[-1]):.6f}; logged, not checked: the parameters after them "
        f"{'bit-equal' if after_bits else 'not bit-equal'} (largest relative gap {after:.3e}, "
        f"in {after_where}), as two one-process runs are not ({floor:.3e}, in {floor_where}): "
        f"the bias tables' float atomics part them from the first step on, and Adam turns that "
        f"noise in gradients near zero into steps of up to the learning rate")
    one, dp = times["one process"], times["trainer.distributed, NCCL world size 1"]
    log(f"phase 22 (a) {label}, graphed step on {card} (one card, world size 1; no multi-card "
        f"time): one process | distributed: p50 {one['p50']:.3f} | {dp['p50']:.3f} ms, device "
        f"{one['device_ms']:.3f} | {dp['device_ms']:.3f} ms in {one['launches']:.0f} | "
        f"{dp['launches']:.0f} profiled launches, idle {100 * one['idle']:.1f}% | "
        f"{100 * dp['idle']:.1f}%, all-reduces a step 0 | {dp['all_reduces_a_step']:.0f}")
    return times, path_counts


def nccl_gather_in_a_graph(device, label: str) -> None:
    """An out-of-place NCCL all-gather at world size 1, captured in a CUDA
    graph: NCCL copies even for one rank, so each replay must fill `out`
    with what `src` holds then (the step's in-place sums issue nothing at
    world size 1, so they cannot show this)."""
    import torch.distributed as dist

    src = torch.arange(1 << 20, dtype=torch.float32, device=device)
    out = torch.zeros_like(src)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):  # the warm-up, as a captured step has
        dist.all_gather_into_tensor(out, src)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dist.all_gather_into_tensor(out, src)
    for bump in (1.0, 2.0):
        src.add_(bump)
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(out, src), f"{label}: a replayed NCCL all-gather did not copy")
    log(f"  {label}: an NCCL all-gather (world size 1) captured in a CUDA graph copied its "
        f"{src.numel():,} values at each of 2 replays")


def dp_padded_batches(trainer) -> list:
    return [trainer._put(b) for _, b in zip(range(DP_STEPS), trainer._loader("train"))]


def dp_class_1152_batches(trainer) -> list:
    host = [b for b in trainer._loader("train", packed=True) if b["ids"].shape[1] == 1152]
    check(bool(host), "no batch of the 1152 class")
    return [trainer._put(host[i % len(host)]) for i in range(DP_STEPS)]


def rank_loader(trainer, rank: int, packed: bool):
    """The train loader rank `rank` of two builds (its rows of global batches
    of the trainer's batch size), from a one-process trainer."""
    data_cfg, full = trainer.cfg.data, trainer.cfg.data.batch_size
    trainer._loader_sharding = lambda: (rank, 2)
    data_cfg.batch_size = full // 2
    try:
        return trainer._loader("train", packed=packed)
    finally:
        del trainer._loader_sharding
        data_cfg.batch_size = full


def two_process_job(label: str, base: list, job_dir: Path) -> tuple:
    """The one-process step over a global batch whose halves have different
    tails, dropout off, with drawn offsets; -> (the ranks' job, what the
    ranks must give: the loss, gradients and parameters after the step)."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    trainer = Trainer(cli_train.parse_args(
        base + DP_DROPOUT_OFF + [f"trainer.output_dir={job_dir / 'one'}"]))
    packed = trainer._packed
    pairs = list(zip(*(rank_loader(trainer, r, packed) for r in (0, 1))))
    if packed:
        halves = max(pairs, key=lambda p: abs(int(p[0]["num_segments"].sum())
                                              - int(p[1]["num_segments"].sum())))
        tails = [int(h["num_segments"].sum()) for h in halves]
    else:
        halves = pairs[-1]
        tails = [int(h["sample_weight"].sum()) for h in halves]
    check(tails[0] != tails[1], f"{label}: the halves' tails are alike {tails}")
    whole = {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}
    rows, cols = whole["ids"].shape
    cols += -1 if packed else trainer.cfg.model.gr_output_length
    r = trainer.cfg.model.loss.num_to_sample
    offsets = torch.randint(0, len(trainer.all_item_ids), (rows, cols, r), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(22))
    trainer.model.train()
    loss = trainer.train_step(trainer._put(whole), trainer.lr1,
                              neg_offsets=offsets.to(trainer.device))
    want = {"loss": float(loss),
            "grads": {n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters()},
            "params": {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}}
    half = len(halves[0]["ids"])
    job = {"base": base, "batches": list(halves), "offsets": [offsets[:half], offsets[half:]],
           "tails": tails}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return job, want


def dp_rank_part(jobs: dict, rank: int) -> dict:
    """Phase 22 (b) in a rank of `ranks_main`: the step of each job on its
    half of the global batch, then two epochs of `fit` with the val eval,
    both over gloo on cuda:0 (the launch's MASTER_PORT). A collective that
    gloo refuses on a CUDA tensor fails the rank, and so the phases."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.parallel import process_group
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    results = {}
    for label, job in jobs.items():
        rank_args = [f"data.batch_size={cli_train.parse_args(job['base']).data.batch_size // 2}",
                     "trainer.device=cuda:0", "trainer.distributed=true",
                     f"trainer.output_dir={OUT_DIR / 'dp2' / label.replace(' ', '_')}"]
        trainer = Trainer(cli_train.parse_args(job["base"] + DP_DROPOUT_OFF + rank_args),
                          backend="gloo")
        trainer.model.train()
        batch = trainer._put(job["batches"][rank])
        loss = trainer.train_step(batch, trainer.lr1,
                                  neg_offsets=job["offsets"][rank].to(trainer.device))
        step = {"loss": float(loss),
                "grads": {n: p.grad.detach().cpu().clone()
                          for n, p in trainer.model.named_parameters()},
                "params": {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}}
        del trainer
        trainer = Trainer(cli_train.parse_args(job["base"] + rank_args + [
            "trainer.max_epochs=2", "trainer.min_epochs=1"]), backend="gloo")
        losses = []
        train_epoch = trainer.train_epoch
        trainer.train_epoch = lambda loader: losses.append(train_epoch(loader)) or losses[-1]
        t0 = time.perf_counter()
        val = trainer.fit()
        results[label] = {"step": step, "val": val, "losses": losses,
                          "fit_s": time.perf_counter() - t0}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    process_group.shutdown()
    return results


def two_processes_jobs() -> tuple:
    """Phase 22 (b)'s one-process part, before the ranks are launched: ->
    (each recipe's job, what its ranks must give)."""
    job_dir = OUT_DIR / "dp2"
    shutil.rmtree(job_dir, ignore_errors=True)
    job_dir.mkdir(parents=True)
    jobs, wants = {}, {}
    for label, base in DP_TWO_PROCESS.items():
        jobs[label], wants[label] = two_process_job(label, base, job_dir)
    return jobs, wants


def two_processes_on_the_card(card: str, jobs: dict, wants: dict, ranks: list) -> None:
    """Phase 22 (b): two processes of this script share cuda:0 over gloo,
    eagerly; each job's step equals the one-process step over the global
    batch (gradients and parameters at the kernel tolerances), then both
    ranks' val metrics after two epochs are equal to the bit."""
    for label, want in wants.items():
        worst = {}
        for rank in (0, 1):
            for (part, _), err in compare_step(label, rank, ranks[rank][label]["step"],
                                               want).items():
                worst[part] = max(worst.get(part, 0.0), err)
        a, b = (ranks[r][label] for r in (0, 1))
        check(a["val"] == b["val"] and bool(a["val"]), f"{label}: the ranks' val metrics differ")
        check(a["losses"] == b["losses"] and bool(np.all(np.isfinite(a["losses"]))),
              f"{label}: the ranks' losses {a['losses']} {b['losses']}")
        log(f"phase 22 (b) {label} on {card} (two processes sharing one card over gloo, eager; "
            f"no multi-card time): halves' tails {jobs[label]['tails']}; the two-rank step "
            f"against the one-process step: loss {a['step']['loss']:.6f} vs {want['loss']:.6f}, "
            f"largest gradient gap {worst['grads']:.3e}, parameters {worst['params']:.3e} "
            f"(rtol {RTOL} / atol {ATOL}); two epochs in {a['fit_s']:.1f} s, losses "
            f"{[round(x, 5) for x in a['losses']]}, val on both ranks "
            + ", ".join(f"{k}={v:.5f}" for k, v in list(a["val"].items())[:4]))


LONG_1152 = LONG_ARGS[:2] + ["data.synthetic_max_seq_len=1200", "trainer.steps_per_call=8"]


def run_data_parallel_path(kc: Counts, card: str) -> dict:
    """Phase 22: (a) NCCL at world size 1 in this process, graphed; (b)'s
    one-process steps, which its two ranks (launched with phases 23 (b) and
    24's, `ranks_main`) are held to. -> {label: (a)'s launch counts, "jobs"
    and "wants": (b)'s}; (b)'s launches are the ranks' own, not counted
    here."""
    import os

    from mygenerativerecommenders_tpu_torch.parallel import process_group

    t0 = time.perf_counter()
    # torchrun's environment for one rank; each run sets its MASTER_PORT
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost")
    try:
        counts = {
            "synthetic-hstu": nccl_world_one(kc, card, "synthetic-hstu",
                                             ["experiment=synthetic-hstu"], dp_padded_batches)[1],
            "long": nccl_world_one(kc, card, "ml-20m-hstu-long class 1152", LONG_1152,
                                   dp_class_1152_batches)[1],
        }
    finally:
        process_group.shutdown()
        for name in process_group.ENV:
            os.environ.pop(name, None)
    t1 = time.perf_counter()
    counts["jobs"], counts["wants"] = two_processes_jobs()
    PHASE_S["22 (a)"], PHASE_S["22 (b) one process"] = t1 - t0, time.perf_counter() - t1
    return counts


# ---------------------------------------------------------------- phase 23

# synthetic-large-vocab's model at full width with its table over 2 shards and
# TP over 2, the catalog cut to 1M items and the users to 512
MP_ARGS = ["experiment=synthetic-large-vocab", "model.embedding.num_shards=2",
           "model.encoder.tp_shards=2", "data.expected_max_item_id=1000000",
           "data.expected_num_unique_items=1000000", "data.synthetic_num_users=512"]
# (b) over gloo, whose every collective is staged through host memory (a
# step at batch 64 took 8.2 s: its gather loss's 6.9M rows cross the
# exchange): the step on 500 users' last batch (52 of its 64 rows with a
# target; at 16 rows AdamW's first step turned the float noise of the
# gradients near zero into parameter gaps past atol 2e-5), timed (one step,
# the first of its trainer); one epoch of `fit` on 32 users in batches of
# 16 (cut from 512 users: at ~3 s a 16-row step over gloo, 32 steps)
MP_CPU_ROWS = 16  # rows of (a)'s card-against-CPU batch: the CPU side's depth cut
MP_STEP_ARGS = MP_ARGS + ["data.synthetic_num_users=500"]
MP_FIT_ARGS = MP_ARGS + ["data.batch_size=16", "data.synthetic_num_users=32",
                         "trainer.max_epochs=1", "trainer.min_epochs=1"]
# JAX's packed_sharded recipe (tests/distributed_worker.py) on ml-1m-hstu-packed
MP_PACKED = ["experiment=ml-1m-hstu-packed", "data.dataset_name=synthetic",
             "data.pack_eval=true", "model.embedding.kind=sharded_a2a",
             "model.embedding.num_shards=2", "model.index.sharded=true",
             "trainer.steps_per_call=2", "trainer.mesh_data_innermost=true",
             "data.synthetic_num_users=512", "trainer.max_epochs=2", "trainer.min_epochs=1"]


def placed_grads(model) -> dict:
    """Every parameter's gradient in the one-process layout (a placed block's
    gathered over the mesh)."""
    from mygenerativerecommenders_tpu_torch.parallel.tensor_parallel import (
        full_tensor,
        mesh_groups,
    )

    placements = getattr(model, "placements", {})
    groups = mesh_groups() if placements else None
    return {n: (full_tensor(p.grad, placements[n], groups) if n in placements else p.grad)
            .detach().cpu().clone() for n, p in model.named_parameters()}


def one_device_tp(kc: Counts, card: str, data) -> tuple:
    """Phase 23 (a): the one-device TP form (no group) on the card: phase 5's
    check of the loss and gradients against the CPU on 16 rows, phase 10's
    check of three graphed steps against three eager ones, and the step
    eager and graphed side by side; then the one-process step on (b)'s
    batch that (b)'s ranks are held to. -> (the side-by-side's
    launches, that step, its job, the side-by-side's numbers)."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer
    from mygenerativerecommenders_tpu_torch.train.task_retrieval import loss_variant, make_loss_fn

    cfg = cli_train.parse_args(MP_ARGS)
    check(cfg.model.encoder.tp_shards == 2 and cfg.model.embedding.kind == "sharded_a2a",
          "not the TP layout")
    from mygenerativerecommenders_tpu_torch.configs import resolve
    resolve(cfg, data.max_item_id)
    check(loss_variant(cfg, len(data.all_item_ids)) == "gather", "not the gather loss")
    batch = {k: v[:MP_CPU_ROWS] for k, v in next(iter(data.loader("train"))).items()}
    n = batch["ids"].shape[1] + cfg.model.gr_output_length
    offsets = torch.randint(0, len(data.all_item_ids),
                            (batch["ids"].shape[0], n, cfg.model.loss.num_to_sample),
                            generator=torch.Generator().manual_seed(3), dtype=torch.int32)
    compare_card_and_cpu(
        f"synthetic-large-vocab with tp_shards=2 on one device and sharded_a2a over 2 shards "
        f"at {len(data.all_item_ids):,} items, {batch['ids'].shape[0]} rows", cfg, batch,
        lambda model, b, device: make_loss_fn(model, cfg, data.all_item_ids)(
            b, neg_offsets=offsets.to(device)))
    graphed_against_eager([("synthetic-large-vocab tp_shards=2 on one device", MP_ARGS,
                            [None])], data=data)

    trainer = Trainer(cli_train.parse_args(MP_ARGS + ["trainer.steps_per_call=8",
                                                      f"trainer.output_dir={OUT_DIR / 'mp1'}"]),
                      data=data)
    trainer.model.train()
    batches = [trainer._put(b) for _, b in zip(range(4), data.loader("train"))]
    blocks = trainer.cfg.model.encoder.num_blocks
    kc.reset()
    eager_and_graphed(kc, {
        "eager": lambda i: trainer.train_step(batches[i % 4], trainer.lr1),
        "graphed": lambda i: trainer.train_steps([batches[i % 4]], trainer.lr1),
    }, "synthetic-large-vocab tp_shards=2, sharded_a2a over 2 shards, one device, train step",
        kc.per_step(blocks, 0, lse=0), trainer.train_steps.graphs, card, reps=3)
    counts = kc.read()
    check(counts[kc.attn.KERNEL] > 0 and counts[kc.attn.KERNEL_BWD] > 0,
          "the one-device TP step launched no attention kernel")
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()

    # the one-process step (b)'s two ranks are held to: the epoch's last
    # batch (its tail of rows without a target), dropout off, drawn offsets;
    # every parameter's largest gap logged
    one = Trainer(cli_train.parse_args(MP_STEP_ARGS + DP_DROPOUT_OFF + [
        f"trainer.output_dir={OUT_DIR / 'mp1'}"]))
    host = list(one.data.loader("train"))[-1]
    check(0 < int(host["sample_weight"].sum()) < len(host["ids"]), "the last batch has no tail")
    cols = host["ids"].shape[1] + one.cfg.model.gr_output_length
    offsets = torch.randint(0, len(one.all_item_ids),
                            (host["ids"].shape[0], cols, one.cfg.model.loss.num_to_sample),
                            generator=torch.Generator().manual_seed(23), dtype=torch.int32)
    one.model.train()
    loss = one.train_step(one._put(host), one.lr1, neg_offsets=offsets.cuda())
    want = {"loss": float(loss), "grads": placed_grads(one.model),
            "params": {n: p.detach().cpu().clone() for n, p in one.model.named_parameters()}}
    job = {"batch": host, "offsets": offsets, "rows": int(host["sample_weight"].sum()),
           "of": len(host["ids"])}
    del one
    gc.collect()
    torch.cuda.empty_cache()
    return counts, want, job


def mp_rank_part(job: dict) -> dict:
    """Phase 23 (b) in a rank of `ranks_main`, sharing cuda:0 over gloo,
    eagerly: the step over the model group (2 shards, TP over 2) on the
    job's batch and offsets, timed; then one epoch of `fit` with the int8
    sharded index, and two of JAX's packed_sharded recipe; each run's kernel
    launches, counted from 0 just before it."""
    import os

    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.parallel import process_group
    from mygenerativerecommenders_tpu_torch.parallel.tensor_parallel import full_state_dict
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    ports = iter(job["ports"])
    rank_args = ["trainer.device=cuda:0", "trainer.distributed=true"]
    kc, out = port_counts(), {}

    os.environ["MASTER_PORT"] = str(next(ports))
    trainer = Trainer(cli_train.parse_args(MP_STEP_ARGS + DP_DROPOUT_OFF + rank_args + [
        f"trainer.output_dir={OUT_DIR / 'mp2' / 'step'}"]), backend="gloo")
    check(trainer.dp.model_size == 2 and trainer.dp.size == 1, "not a model group of 2")
    trainer.model.train()
    batch = trainer._put(job["batch"])
    offsets = job["offsets"].cuda()
    # the groups' connections made before the timed step
    trainer.dp.model.psum(torch.zeros(1, 1, device=offsets.device))
    kc.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = trainer.train_step(batch, trainer.lr1, neg_offsets=offsets)
    torch.cuda.synchronize()
    # one timed step, the checked one: the first of its trainer
    out["step_ms"], out["step_counts"] = 1e3 * (time.perf_counter() - t0), kc.read()
    out["step"] = {"loss": float(loss), "grads": placed_grads(trainer.model),
                   "params": {k: v.cpu() for k, v in full_state_dict(trainer.model).items()}}
    del trainer
    process_group.shutdown()

    for label, args in (("fit", MP_FIT_ARGS), ("packed", MP_PACKED)):
        os.environ["MASTER_PORT"] = str(next(ports))
        trainer = Trainer(cli_train.parse_args(args + rank_args + [
            f"trainer.output_dir={OUT_DIR / 'mp2' / label}"]), backend="gloo")
        losses = []
        train_epoch = trainer.train_epoch
        trainer.train_epoch = lambda loader: losses.append(train_epoch(loader)) or losses[-1]
        kc.reset()
        t0 = time.perf_counter()
        val = trainer.fit()
        res = {"val": val, "losses": losses, "s": time.perf_counter() - t0,
               "counts": kc.read()}
        trainer.dp.check_replicas(trainer.model.named_parameters())
        if trainer._eval_packed:
            res["val_unpacked"] = trainer.eval_epoch(trainer._loader("val"), "val")
        out[label] = res
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        process_group.shutdown()
    return out


def free_ports(n: int) -> list:
    ports = set()
    while len(ports) < n:
        ports.add(free_port())
    return sorted(ports)


def model_axis_on_the_card(card: str, want: dict, job: dict, ranks: list) -> dict:
    """Phase 23 (b): two processes of this script share cuda:0 over gloo,
    eagerly, a model group of 2. -> the ranks' kernel launches."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    job_dir = OUT_DIR / "mp2"
    worst = {}
    for rank in (0, 1):
        gaps = compare_step("phase 23 (b)", rank, ranks[rank]["step"], want, BIAS_RTOL)
        for (part, _), err in gaps.items():
            worst[part] = max(worst.get(part, 0.0), err)
        log(f"  rank {rank}'s largest gaps to the one-process step: " + ", ".join(
            f"{part[:-1]} {name.split('_attention_layers.')[-1]} {err:.2e}"
            for (part, name), err in gaps.items()))
    a, b = ranks
    for label in ("fit", "packed"):
        check(bool(a[label]["val"]) and a[label]["val"] == b[label]["val"],
              f"phase 23 (b) {label}: the ranks' val metrics differ")
        check(a[label]["losses"] == b[label]["losses"]
              and bool(np.all(np.isfinite(a[label]["losses"]))),
              f"phase 23 (b) {label}: the ranks' losses {a[label]['losses']} {b[label]['losses']}")
    for key, value in a["packed"]["val_unpacked"].items():
        check(abs(a["packed"]["val"][key] - value) < 1e-6,
              f"phase 23 (b): the packed eval's {key} {a['packed']['val'][key]} vs the "
              f"unpacked {value}")
    # the two-rank checkpoint in one process: the val metrics of its weights
    one = Trainer(cli_train.parse_args(MP_FIT_ARGS + [f"trainer.output_dir={OUT_DIR / 'mp1'}"]))
    one.load_weights(job_dir / "fit" / "synthetic-large-vocab" / "checkpoints" / "last.pt")
    val_one = one.eval_epoch(one._loader("val"), "val")
    del one
    gc.collect()
    torch.cuda.empty_cache()
    gap = max(abs(val_one[k] - v) for k, v in a["fit"]["val"].items())
    check(val_one.keys() == a["fit"]["val"].keys() and gap <= 1e-6,
          f"phase 23 (b): the checkpoint's val metrics in one process {val_one} vs the ranks' "
          f"{a['fit']['val']}")
    log(f"phase 23 (b) on {card} (gloo, two processes on one card, not a multi-card time): "
        f"the model-group step (2 shards, TP over 2) on a batch of {job['of']} rows "
        f"({job['rows']} with a target) against the one-process step: loss "
        f"{a['step']['loss']:.6f} vs {want['loss']:.6f}, largest gradient gap "
        f"{worst['grads']:.3e}, parameters {worst['params']:.3e} (rtol {RTOL} / atol {ATOL}, "
        f"bias tables {BIAS_RTOL}); one timed step (the first of its trainer) "
        f"{a['step_ms']:.2f} | {b['step_ms']:.2f} ms (rank 0 | 1; gloo, two processes on one "
        f"card, not a multi-card time); "
        f"one epoch on 32 users with the int8 sharded index in {a['fit']['s']:.1f} s, val on both ranks "
        + ", ".join(f"{k}={v:.5f}" for k, v in a["fit"]["val"].items())
        + f", the checkpoint in one process within {gap:.1e}; packed_sharded on "
        f"ml-1m-hstu-packed (synthetic, 512 users), two epochs in {a['packed']['s']:.1f} s, "
        f"losses {[round(x, 5) for x in a['packed']['losses']]}, packed eval = unpacked within "
        f"1e-6; launches rank 0: step {a['step_counts']}, fit {a['fit']['counts']}, packed "
        f"{a['packed']['counts']}")
    totals = collections.Counter()
    for r in ranks:
        for shape, counts in (("large", r["step_counts"]), ("large", r["fit"]["counts"]),
                              ("packed", r["packed"]["counts"])):
            totals.update({(shape, k): v for k, v in counts.items()})
    return dict(totals)


def run_model_axis_path(kc: Counts, card: str) -> tuple:
    """Phase 23: (a) the one-device TP form in this process, and the
    one-process step that (b)'s two ranks (launched with phases 22 (b) and
    24's, `ranks_main`) are held to. -> ((a)'s launches, that step, (b)'s
    job)."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData

    t0 = time.perf_counter()
    cfg = cli_train.parse_args(MP_ARGS)
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    counts, want, job = one_device_tp(kc, card, data)
    del data
    shutil.rmtree(OUT_DIR / "mp2", ignore_errors=True)
    job["ports"] = free_ports(3)
    PHASE_S["23 (a)"] = time.perf_counter() - t0
    return counts, want, job


# ---------------------------------------------------------------- phase 24

# ml-20m-hstu-long at full width (D=64, 8 blocks, H=2, N=1,035 padded to
# 1,036, batch 32, 26,744 items, synthetic), padded rows, the ring over an sp
# group of two processes; (a)'s step takes the first train batch of 64 users,
# (b)'s `fit` one epoch of 96 users (the depth cut: 3 steps, 3 val and 3 test
# batches over gloo; the preset's draw is 2,048 users)
RING24_ARGS = LONG_ARGS + ["data.pack_sequences=false", "model.encoder.sp_shards=2"]
RING24_STEP_USERS = 64
RING24_FIT_USERS = 96


def ring24_args(zigzag: bool, users: int) -> list:
    return RING24_ARGS + [f"model.encoder.sp_zigzag={zigzag}", f"data.synthetic_num_users={users}"]


def group_chunk_calls(shards: int, zigzag: bool, rank: int) -> int:
    """Chunk calls of rank p's ring body over an sp group of P: zigzag, back x
    front at every step plus front x front where the resident chunk s <= p
    and back x back where s >= p (P + P + 1, whatever p); contiguous, the
    chunks at or before the diagonal (p + 1)."""
    if not zigzag:
        return rank + 1
    return sum(1 + (s <= rank) + (s >= rank) for s in ((rank - t) % shards for t in range(shards)))


def ring_group_job(kc: Counts, card: str) -> tuple:
    """Phase 24's one-process part, before the ranks are launched: for
    zigzag and contiguous, one step of the one-process ring (`OneDeviceRing`
    at sp_shards=2, its shards in turn on the card) on the first train batch
    of RING24_STEP_USERS users, dropout off, the offsets handed in, timed
    (the first step of its trainer) with its peak memory. -> (what the ranks'
    steps must give, the ranks' job, the one-process numbers)."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    cfg = cli_train.parse_args(ring24_args(True, RING24_STEP_USERS))
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    host = next(iter(data.loader("train")))
    rows, cols = host["ids"].shape
    cols += cfg.model.gr_output_length
    offsets = torch.randint(0, len(data.all_item_ids), (rows, cols, cfg.model.loss.num_to_sample),
                            generator=torch.Generator().manual_seed(24), dtype=torch.int32)
    wants, one = {}, {}
    for zigzag in (True, False):
        layout = "zigzag" if zigzag else "contiguous"
        trainer = Trainer(cli_train.parse_args(ring24_args(zigzag, RING24_STEP_USERS)
                                               + DP_DROPOUT_OFF + [
            f"trainer.output_dir={OUT_DIR / 'ring24' / 'one'}"]), data=data)
        trainer.model.train()
        batch, dev_offsets = trainer._put(host), offsets.cuda()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        kc.reset()
        t0 = time.perf_counter()
        loss = trainer.train_step(batch, trainer.lr1, neg_offsets=dev_offsets)
        torch.cuda.synchronize()
        one[layout] = {"ms": 1e3 * (time.perf_counter() - t0), "held": held,
                       "peak": torch.cuda.max_memory_allocated(), "counts": kc.read()}
        wants[layout] = {
            "loss": float(loss),
            "grads": {n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters()},
            "params": {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}}
        del trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(OUT_DIR / "ring24", ignore_errors=True)
    job = {"batch": host, "offsets": offsets, "rows": int(host["sample_weight"].sum()),
           "ports": free_ports(3)}
    return wants, job, one


def ring_rank_part(job: dict) -> dict:
    """Phase 24 in a rank of `ranks_main`, sharing cuda:0 over gloo, eagerly:
    for zigzag and contiguous, the step over the sp group of 2 on the job's
    batch and offsets (timed: the first step of its trainer; its launches
    and peak memory); then one epoch of `fit` of the zigzag ring on
    RING24_FIT_USERS users with its val eval, and the test pass, its
    launches counted from 0 just before it."""
    import os

    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.parallel import embedding_sharding, process_group
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    ports = iter(job["ports"])
    rank_args = ["trainer.device=cuda:0", "trainer.distributed=true"]
    kc, out = port_counts(), {}
    for zigzag in (True, False):
        layout = "zigzag" if zigzag else "contiguous"
        os.environ["MASTER_PORT"] = str(next(ports))
        trainer = Trainer(cli_train.parse_args(ring24_args(zigzag, RING24_STEP_USERS)
                                               + DP_DROPOUT_OFF + rank_args + [
            f"trainer.output_dir={OUT_DIR / 'ring24' / layout}"]), backend="gloo")
        mesh = trainer.dp
        check(mesh.sp_size == 2 and mesh.size == 1 and mesh.model_size == 1,
              "phase 24: not an sp group of 2")
        trainer.model.train()
        batch, offsets = trainer._put(job["batch"]), job["offsets"].to(trainer.device)
        # the group's connections made before the timed step
        mesh.sp.rotate(torch.zeros(1, device=trainer.device), 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        kc.reset()
        sp_calls = embedding_sharding.collectives
        t0 = time.perf_counter()
        loss = trainer.train_step(batch, trainer.lr1, neg_offsets=offsets)
        torch.cuda.synchronize()
        out[layout] = {
            "ms": 1e3 * (time.perf_counter() - t0), "held": held,
            "peak": torch.cuda.max_memory_allocated(), "counts": kc.read(),
            "collectives": embedding_sharding.collectives - sp_calls,
            "step": {"loss": float(loss),
                     "grads": {n: p.grad.detach().cpu().clone()
                               for n, p in trainer.model.named_parameters()},
                     "params": {n: p.detach().cpu().clone()
                                for n, p in trainer.model.named_parameters()}}}
        del trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
        process_group.shutdown()

    os.environ["MASTER_PORT"] = str(next(ports))
    trainer = Trainer(cli_train.parse_args(ring24_args(True, RING24_FIT_USERS) + rank_args + [
        "trainer.max_epochs=1", "trainer.min_epochs=1",
        f"trainer.output_dir={OUT_DIR / 'ring24' / 'fit'}"]), backend="gloo")
    losses = []
    train_epoch = trainer.train_epoch
    trainer.train_epoch = lambda loader: losses.append(train_epoch(loader)) or losses[-1]
    kc.reset()
    t0 = time.perf_counter()
    val = trainer.fit()
    test = trainer.test()
    out["fit"] = {"val": val, "test": test, "losses": losses, "s": time.perf_counter() - t0,
                  "counts": kc.read()}
    trainer.dp.check_replicas(trainer.model.named_parameters())
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    process_group.shutdown()
    return out


def ring_group_on_the_card(card: str, wants: dict, job: dict, one: dict, ranks: list) -> dict:
    """Phase 24's checks of its ranks: (a) each rank's step within the
    tolerances of the one-process ring step, its launches those of its body,
    its collectives counted, its peak over what it held below the
    one-process ring's;
    (b) both ranks' fit metrics and losses equal, the checkpoint loaded in
    this process (the ring's shards in turn on the card) giving equal val
    metrics; (c) the steps' times and peak memory logged beside the
    one-process ring's. -> the ranks' launches, by kernel, both ranks."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.ops.kernels import (
        count_offsets,
        dense_neg_lse,
        hstu_attention,
        hstu_chunk,
    )
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    cfg = cli_train.parse_args(RING24_ARGS)
    blocks, lr = cfg.model.encoder.num_blocks, cfg.optimizer1.lr
    totals = collections.Counter()
    for layout in ("zigzag", "contiguous"):
        worst, times = {}, []
        for rank in (0, 1):
            got = ranks[rank][layout]
            for (part, _), err in compare_step(f"phase 24 (a) {layout}", rank, got["step"],
                                               wants[layout], BIAS_RTOL, lr=lr).items():
                worst[part] = max(worst.get(part, 0.0), err)
            calls = blocks * group_chunk_calls(2, layout == "zigzag", rank)
            expected = {hstu_attention.KERNEL: 0, hstu_attention.KERNEL_BWD: 0,
                        count_offsets.KERNEL: 1, dense_neg_lse.KERNEL: 1,
                        dense_neg_lse.KERNEL_BWD: 1, hstu_chunk.KERNEL: calls,
                        hstu_chunk.KERNEL_BWD: calls}
            check(got["counts"] == expected, f"phase 24 (a) {layout}: rank {rank} launched "
                                             f"{got['counts']}, its body {expected}")
            # each rank holds its rows from the stack's entry to its exit: the
            # exit's gather and, backward, the gather of the entry's cotangent
            # rows, once a step; a block's first timestamps' gather and one
            # rotation, and backward the rotation back (the blocks' partial
            # gradients are summed by the step's flat all-reduces, which the
            # data group counts)
            expected = 3 * blocks + 2
            check(got["collectives"] == expected,
                  f"phase 24 (a) {layout}: rank {rank} made {got['collectives']} collectives over "
                  f"the sp group, expected {expected}")
            over, one_over = got["peak"] - got["held"], one[layout]["peak"] - one[layout]["held"]
            check(over < one_over, f"phase 24 (a) {layout}: rank {rank}'s peak over what it held "
                                   f"{gb(over)}, the one-process ring's {gb(one_over)}")
            totals.update(got["counts"])
            times.append(f"rank {rank} {got['ms']:.2f} ms, peak {gb(got['peak'])} "
                         f"({gb(over)} over what was held, {100 * over / one_over:.1f}% of the "
                         f"one-process ring's)")
        log(f"phase 24 (a) {layout} ring over an sp group of 2 on {card} (two processes sharing "
            f"one card over gloo, not a multi-card time): ml-20m-hstu-long at full width, a padded "
            f"batch of {len(job['batch']['ids'])} rows ({job['rows']} with a target); the ranks' "
            f"step against the one-process ring step (OneDeviceRing, sp_shards=2, on the card): "
            f"loss {ranks[0][layout]['step']['loss']:.6f} vs {wants[layout]['loss']:.6f}, largest "
            f"gradient gap {worst['grads']:.3e}, parameters {worst['params']:.3e} (rtol {RTOL} / "
            f"atol {ATOL}, bias tables {BIAS_RTOL}), parameters whose gradient is below "
            f"{EPS_GRAD:g} {worst.get('near eps', 0.0):.3e} (bound 2 x lr = {2 * lr:g}); chunk "
            f"launches a step "
            f"{[ranks[r][layout]['counts'][hstu_chunk.KERNEL] for r in (0, 1)]} forward and as "
            f"many backward (rank 0, 1), 1 count, 1 lse pair; "
            f"{ranks[0][layout]['collectives']} collectives over the sp group a step")
        log(f"  (c) one timed step, the first of its trainer (two processes on one card over "
            f"gloo, not a multi-card time): {'; '.join(times)}; the one-process ring "
            f"{one[layout]['ms']:.2f} ms, peak {gb(one[layout]['peak'])} "
            f"({gb(one[layout]['peak'] - one[layout]['held'])} over what was held)")
    a, b = (ranks[r]["fit"] for r in (0, 1))
    check(bool(a["val"]) and a["val"] == b["val"] and a["test"] == b["test"],
          "phase 24 (b): the ranks' val or test metrics differ")
    check(a["losses"] == b["losses"] and bool(np.all(np.isfinite(a["losses"]))),
          f"phase 24 (b): the ranks' losses {a['losses']} {b['losses']}")
    for r in (0, 1):
        counts = ranks[r]["fit"]["counts"]
        check(all(counts[k] > 0 for k in (count_offsets.KERNEL, dense_neg_lse.KERNEL,
                                          dense_neg_lse.KERNEL_BWD, hstu_chunk.KERNEL,
                                          hstu_chunk.KERNEL_BWD))
              and counts[hstu_attention.KERNEL] == 0,
              f"phase 24 (b): rank {r}'s fit launched {counts}")
        totals.update(counts)
    one_fit = Trainer(cli_train.parse_args(ring24_args(True, RING24_FIT_USERS) + [
        f"trainer.output_dir={OUT_DIR / 'ring24' / 'one'}"]))
    one_fit.load_weights(OUT_DIR / "ring24" / "fit" / "ml-20m-hstu-long" / "checkpoints"
                         / "last.pt")
    val_one = one_fit.eval_epoch(one_fit._loader("val"), "val")
    del one_fit
    gc.collect()
    torch.cuda.empty_cache()
    gap = max(abs(val_one[k] - v) for k, v in a["val"].items())
    check(val_one.keys() == a["val"].keys() and gap <= 1e-6,
          f"phase 24 (b): the checkpoint's val metrics in one process {val_one} vs the ranks' "
          f"{a['val']}")
    log(f"phase 24 (b) on {card}: one epoch of the zigzag ring on {RING24_FIT_USERS} users over "
        f"gloo in {a['s']:.1f} s (val and test included), losses "
        f"{[round(x, 5) for x in a['losses']]}; val on both ranks "
        + ", ".join(f"{k}={v:.5f}" for k, v in list(a["val"].items())[:4])
        + f"; test ndcg@10 {a['test']['ndcg@10']:.5f} on both; the checkpoint in one process "
        f"within {gap:.1e}; launches rank 0 {ranks[0]['fit']['counts']}, rank 1 "
        f"{ranks[1]['fit']['counts']}")
    return dict(totals)


# (d): TP beside the ring, model 2 x sp 2 over four processes, one head a rank
RING24_TP_ARGS = ["model.encoder.tp_shards=2"]


def ring_tp_rank_part(job: dict, go: Path) -> dict:
    """Phase 24 (d) in a rank of `ranks_main`, one of four sharing cuda:0
    over gloo, eagerly: its trainer built as soon as the job is written
    (while the two ranks of (a)-(c) run), then, once `go` exists (after
    them), one zigzag step at model 2 x sp 2 with tp_shards=2 (one of the
    two heads a rank) on phase 24's batch and offsets, dropout off, timed
    (the first step of its trainer), with its launches, the heads of its
    chunk calls, its collectives over the sp and model groups and its peak
    memory; its gradients and weights gathered into the one-process layout
    after the count."""
    import os

    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.parallel import (
        embedding_sharding,
        process_group,
        ring_attention,
    )
    from mygenerativerecommenders_tpu_torch.parallel.tensor_parallel import (
        full_state_dict,
        full_tensor,
        mesh_groups,
    )
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    heads, chunk = [], ring_attention.hstu_chunk_attention

    def recorded(q, *args, **kwargs):  # the heads each chunk call sees
        heads.append(q.shape[2])
        return chunk(q, *args, **kwargs)

    ring_attention.hstu_chunk_attention = recorded
    os.environ["MASTER_PORT"] = str(job["ports"][0])
    kc = port_counts()
    t0 = time.perf_counter()
    trainer = Trainer(cli_train.parse_args(
        ring24_args(True, RING24_STEP_USERS) + DP_DROPOUT_OFF + RING24_TP_ARGS + [
            "trainer.device=cuda:0", "trainer.distributed=true",
            f"trainer.output_dir={OUT_DIR / 'ring24' / 'tp'}"]), backend="gloo")
    mesh = trainer.dp
    check(mesh.sp_size == 2 and mesh.model_size == 2 and mesh.size == 1,
          "phase 24 (d): not model 2 x sp 2")
    trainer.model.train()
    batch, offsets = trainer._put(job["batch"]), job["offsets"].to(trainer.device)
    # the groups' connections made before the timed step
    mesh.sp.rotate(torch.zeros(1, device=trainer.device), 1)
    mesh.model.rotate(torch.zeros(1, device=trainer.device), 1)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    while not go.exists():
        time.sleep(0.05)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kc.reset()
    heads.clear()
    calls = embedding_sharding.collectives
    t0 = time.perf_counter()
    loss = trainer.train_step(batch, trainer.lr1, neg_offsets=offsets)
    torch.cuda.synchronize()
    out = {"ms": 1e3 * (time.perf_counter() - t0), "held": held,
           "peak": torch.cuda.max_memory_allocated(), "counts": kc.read(),
           "collectives": embedding_sharding.collectives - calls, "heads": sorted(set(heads)),
           "coords": mesh.coords(), "built_s": built}
    placements, groups = trainer.model.placements, mesh_groups()
    out["step"] = {
        "loss": float(loss),
        "grads": {n: (full_tensor(p.grad, placements[n], groups) if n in placements else p.grad)
                  .detach().cpu().clone() for n, p in trainer.model.named_parameters()},
        "params": {n: v.detach().cpu().clone() for n, v in full_state_dict(trainer.model).items()}}
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    process_group.shutdown()
    return out


def ring_tp_on_the_card(card: str, want: dict, one: dict, ranks: list) -> dict:
    """Phase 24 (d)'s checks: each of the four ranks' steps within the
    tolerances of the one-process zigzag ring step (TP changes no weight and
    no value), its chunk calls on one head, its launches those of its sp
    rank's body, its collectives counted. -> the ranks' launches, by kernel."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.ops.kernels import (
        count_offsets,
        dense_neg_lse,
        hstu_attention,
        hstu_chunk,
    )

    cfg = cli_train.parse_args(RING24_ARGS)
    blocks, lr = cfg.model.encoder.num_blocks, cfg.optimizer1.lr
    totals, worst, times = collections.Counter(), {}, []
    for rank, got in enumerate(ranks):
        for (part, _), err in compare_step("phase 24 (d)", rank, got["step"], want, BIAS_RTOL,
                                           lr=lr).items():
            worst[part] = max(worst.get(part, 0.0), err)
        check(got["heads"] == [cfg.model.encoder.num_heads // 2],
              f"phase 24 (d): rank {rank}'s chunk calls saw {got['heads']} heads")
        calls = blocks * group_chunk_calls(2, True, got["coords"]["sp"])
        expected = {hstu_attention.KERNEL: 0, hstu_attention.KERNEL_BWD: 0,
                    count_offsets.KERNEL: 1, dense_neg_lse.KERNEL: 1,
                    dense_neg_lse.KERNEL_BWD: 1, hstu_chunk.KERNEL: calls,
                    hstu_chunk.KERNEL_BWD: calls}
        check(got["counts"] == expected,
              f"phase 24 (d): rank {rank} launched {got['counts']}, its body {expected}")
        # (a)'s 3 a block and 2 a step over the sp group; over the model group
        # a block's projection gather, the attention LayerNorm's two row
        # statistics summed and the output projection's partial sums summed,
        # and backward the first two summed back and the LayerNorm input's
        # cotangent summed (`enter`): 6 a block
        expected = 9 * blocks + 2
        check(got["collectives"] == expected,
              f"phase 24 (d): rank {rank} made {got['collectives']} collectives, expected "
              f"{expected}")
        totals.update(got["counts"])
        over = got["peak"] - got["held"]
        times.append(f"rank {rank} {got['ms']:.2f} ms, {gb(over)} over what was held "
                     f"({100 * over / (one['zigzag']['peak'] - one['zigzag']['held']):.1f}% of "
                     f"the one-process ring's; trainer built in {got['built_s']:.1f} s)")
    one_over = one["zigzag"]["peak"] - one["zigzag"]["held"]
    log(f"phase 24 (d) zigzag ring at model 2 x sp 2, tp_shards=2 on {card} (four processes "
        f"sharing one card over gloo, not a multi-card time): the ranks' step against the "
        f"one-process ring step: loss {ranks[0]['step']['loss']:.6f} vs {want['loss']:.6f}, "
        f"largest gradient gap {worst['grads']:.3e}, parameters {worst['params']:.3e}; chunk "
        f"calls on {ranks[0]['heads']} head(s), {ranks[0]['counts'][hstu_chunk.KERNEL]} forward "
        f"and as many backward a rank; {ranks[0]['collectives']} collectives a rank a step; one "
        f"timed step (the first of its trainer): {'; '.join(times)}; the one-process ring "
        f"{one['zigzag']['ms']:.2f} ms, {gb(one_over)} over what was held")
    return dict(totals)


def ranks_main(job_path: str, parts: tuple = ("dp", "mp", "ring")) -> int:
    """One of the rank processes of phases 22 (b), 23 (b) and 24 (a)-(c), or
    of the four of phase 24 (d) (`parts` ("ring_tp",)), started by the
    script with torchrun's environment before phase 22: once the job file
    appears, each phase's part in turn (`dp_rank_part`, `mp_rank_part`,
    `ring_rank_part`, `ring_tp_rank_part`), each on process groups of its
    own, timed; the results into `<job>.rank<r>.pt`."""
    import os

    rank = int(os.environ["RANK"])
    torch.cuda.init()
    deadline = time.monotonic() + 1800  # the parent kills the ranks when it fails
    while not Path(job_path).exists():
        check(time.monotonic() < deadline, f"rank {rank}: no job at {job_path}")
        time.sleep(0.1)
    job = torch.load(job_path, weights_only=False)
    out = {}
    for name, part in (("dp", lambda: dp_rank_part(job["dp"], rank)),
                       ("mp", lambda: mp_rank_part(job["mp"])),
                       ("ring", lambda: ring_rank_part(job["ring"])),
                       ("ring_tp", lambda: ring_tp_rank_part(job["ring_tp"],
                                                              Path(f"{job_path}.go")))):
        if name not in parts:
            continue
        t0 = time.perf_counter()
        out[name] = part()
        out[name + "_s"] = time.perf_counter() - t0
    torch.save(out, f"{job_path}.rank{rank}.pt")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    lap("start")
    if sys.argv[1:2] == ["--ranks"]:  # a rank of phases 22 (b), 23 (b) and 24
        return ranks_main(sys.argv[2])
    if sys.argv[1:2] == ["--ranks4"]:  # a rank of phase 24 (d)
        return ranks_main(sys.argv[2], ("ring_tp",))
    import mygenerativerecommenders_tpu_torch as port
    from mygenerativerecommenders_tpu_torch.ops.kernels import _build
    from mygenerativerecommenders_tpu_torch.ops.kernels import count_offsets as count_kern
    from mygenerativerecommenders_tpu_torch.ops.kernels import dense_neg_lse as lse_kern
    from mygenerativerecommenders_tpu_torch.ops.kernels import hstu_attention as kern
    from mygenerativerecommenders_tpu_torch.ops.kernels import hstu_chunk as chunk_kern
    from mygenerativerecommenders_tpu_torch.train import graphs

    check(Path(port.__file__).resolve().parent.parent == HERE,
          f"the port was imported from {port.__file__}, not from this checkout")
    card = card_line()
    log(card)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {count} x {kind}")

    build_logs = build_kernels(_build, [kern.KERNEL, kern.KERNEL_BWD, count_kern.KERNEL,
                                        lse_kern.LIBRARY, chunk_kern.KERNEL, chunk_kern.KERNEL_BWD])

    ragged = np.random.default_rng(2).integers(2, 211, size=126).tolist()
    serving = check_attention(kern, kern.KERNEL, 1, 32, 211, 1, 50, [1, 211] + ragged[:30])
    check_attention(kern, kern.KERNEL, 3, 4, 1035, 2, 64, [1, 1035, 517, 900])
    attn_bwd = check_attention_bwd(kern, 5, 128, 211, 1, 50, [1, 211] + ragged)
    check_attention_bwd(kern, 7, 4, 1035, 2, 64, [1, 1035, 517, 900])
    # packed rows: a row of ml-1m-hstu-packed, and the widest row of
    # ml-20m-hstu-long, which is wider than the bias table reaches (1152 > 1035)
    for seed, (b, n, max_len, h, d) in enumerate([(56, 256, 211, 1, 50), (4, 1152, 1035, 2, 64)]):
        pos, lens, seg_bounds = packed_layout(20 + seed, b, n, max_len)
        check_attention(kern, kern.KERNEL, 30 + seed, b, n, h, d, lens, max_len, pos)
        check_attention_bwd(kern, 40 + seed, b, n, h, d, lens, max_len, pos, seg_bounds)
    # the backward's 32-row tiles at a ragged edge: N = 1121 = 35 x 32 + 1, and
    # rows of packed length 1 and 20 (positions 0 past the length)
    pos, lens, seg_bounds = packed_layout(22, 4, 1121, 1035)
    pos[2], lens[2] = 0, 1
    pos[3, 20:], lens[3] = 0, 20
    check_attention_bwd(kern, 42, 4, 1121, 2, 64, lens, 1035, pos, seg_bounds)
    # the ranking shape R: synthetic-rank's interleaved rows, N = 2 x 211 = 422
    # (not a multiple of the 64-key tile), each timestamp on two adjacent
    # tokens, a table of 2 x 422 - 1 = 843 entries; lengths 2 x (history +
    # target). Then its packed rows: one class of 256 tokens doubled to 512,
    # wider than the table reaches, segments doubled to (2p, 2p + 1)
    rank_lengths = [2, 422] + [2 * (x + 1) for x in ragged]
    rank_fwd = check_attention(kern, kern.KERNEL, 60, 128, 422, 1, 50, rank_lengths, 422,
                               paired=True)
    rank_bwd = check_attention_bwd(kern, 61, 128, 422, 1, 50, rank_lengths, 422, paired=True)
    # the shape V of synthetic-large-vocab: B=64, N=L=211, H=2, d=64, ragged
    large_lengths = [1, 211] + ragged[:62]
    large_fwd = check_attention(kern, kern.KERNEL, 70, 64, 211, 2, 64, large_lengths)
    large_bwd = check_attention_bwd(kern, 71, 64, 211, 2, 64, large_lengths)
    pos, lens, seg_bounds = packed_layout(62, 48, 256, 201)
    pos = np.stack([2 * pos, 2 * pos + 1], axis=2).reshape(48, 512)
    lens = [2 * x for x in lens]
    seg_bounds = [[(2 * lo, 2 * hi) for lo, hi in row] for row in seg_bounds]
    check_attention(kern, kern.KERNEL, 63, 48, 512, 1, 50, lens, 422, pos, paired=True)
    check_attention_bwd(kern, 64, 48, 512, 1, 50, lens, 422, pos, seg_bounds, paired=True)
    counted = check_count(count_kern, TRAIN_BT, TRAIN_R, 3706)
    counted_wide = check_count(count_kern, TRAIN_BT, TRAIN_R, 26744)
    check_count_edges(count_kern)
    lse_fwd, lse_bwd = check_dense_neg_lse(
        lse_kern, counted.pop("count"), TRAIN_BT, 50, 3706, 0.05
    )
    # the ml-1m catalog read from its files (phase 15): movies.csv's 3,883
    # listed ids, the never-rated ones included
    counted_ml1m = check_count(count_kern, TRAIN_BT, TRAIN_R, 3883)
    lse_fwd_ml1m, lse_bwd_ml1m = check_dense_neg_lse(
        lse_kern, counted_ml1m.pop("count"), TRAIN_BT, 50, 3883, 0.05
    )
    # the ml-20m catalog: the step of ml-20m-hstu (batch 128, D=50), then the
    # 1024-token class of a packed ml-20m-hstu-long step (24 rows, D=64)
    _, lse_bwd_wide = check_dense_neg_lse(
        lse_kern, counted_wide.pop("count"), TRAIN_BT, 50, 26744, 0.05, chunk=2048
    )
    del counted_wide
    # loss.num_to_sample=256 at the padded shape: int32 counts, and the lse
    # kernels' int32 instantiation on them
    check_dense_neg_lse(lse_kern, check_count(count_kern, TRAIN_BT, 256, 3706)["count"],
                        TRAIN_BT, 50, 3706, 0.05)
    long_bt = 24 * 1023
    check_dense_neg_lse(
        lse_kern, check_count(count_kern, long_bt, TRAIN_R, 26744)["count"], long_bt, 64,
        26744, 0.05, chunk=2048,
    )
    # the 256-token class of that step (17 rows, 4,297 supervision rows): the
    # launch with the fewest rows on the packed path
    class256_bt = 4297
    check_dense_neg_lse(
        lse_kern, check_count(count_kern, class256_bt, TRAIN_R, 26744)["count"], class256_bt, 64,
        26744, 0.05, chunk=2048,
    )
    # dense rows: 255 draws into 150 columns leave few of them dead, more live
    # logits a row than the backward's list holds, which it takes in rounds.
    # 4,096 rows: each dcat entry sums ~3,300 terms with much cancelling,
    # where float32 sums in two orders part by most of the tolerance (the
    # kernel sums in float64); at 26,880 rows autograd's float32 product and
    # index_add_ in the sparse plain backward are themselves further than the
    # tolerance from the exact sum
    dense_bt = 4096
    check_dense_neg_lse(lse_kern, check_count(count_kern, dense_bt, 255, 150)["count"], dense_bt,
                        64, 150, 0.05)
    # rows 7-8: the lse with sup_off, over the ml-20m catalog at a quarter of
    # the ring step's 33,088 supervision rows
    fused_bt = 8192
    offsets, positive = negative_draws(23, fused_bt, TRAIN_R, 26744)
    fused_fwd, fused_bwd = check_fused_lse(
        lse_kern, count_kern.count_offsets(offsets, positive, 26744), positive, fused_bt, 64,
        26744, 0.05, chunk=2048,
    )
    del offsets, positive
    # rows 9-10: the ring's chunks at ml-20m-hstu-long's widths (B=32, H=2,
    # d=64, L=1035): zigzag 130 x 130 and contiguous 259 x 259, at the
    # offsets the ring gives them (fully live, the diagonal, dead) and a
    # partial one, then a chunk of padded rows past the bias table
    chunk_fwd, chunk_bwd = check_chunk(chunk_kern, 50, 32, 130, 130, 2, 64, -130, 1035, timed=True)
    check_chunk(chunk_kern, 51, 32, 130, 130, 2, 64, 0, 1035, timed=True)
    check_chunk(chunk_kern, 52, 32, 259, 259, 2, 64, -518, 1035, timed=True)
    check_chunk(chunk_kern, 53, 32, 259, 259, 2, 64, 0, 1035, timed=True)
    check_chunk(chunk_kern, 54, 32, 259, 259, 2, 64, 259, 1035)
    check_chunk(chunk_kern, 55, 32, 130, 130, 2, 64, 65, 1035)
    check_chunk(chunk_kern, 56, 32, 130, 130, 2, 64, -910, 1035)
    torch.cuda.empty_cache()

    kc = Counts(kern, count_kern, lse_kern, chunk_kern, graphs)
    lse_kern.fused_launches = lse_kern.fused_bwd_launches = 0
    lap("1-2")
    t0 = time.perf_counter()
    serving_launches, engine, eager, cpu_engine, big = run_main_path(
        kern, num_blocks_expected=2, card=kind)
    t1 = time.perf_counter()
    serving_launches += run_generation_path(kern, engine, eager, cpu_engine, big,
                                            num_blocks=2, card=kind)
    log(f"phase 3 took {t1 - t0:.1f} s, phase 3b {time.perf_counter() - t1:.1f} s")
    del engine, eager, cpu_engine
    lap("3-3b")
    train_counts = run_training_path(kc, card=kind)
    card_against_cpu_step(["experiment=synthetic-hstu"])
    gc.collect()
    torch.cuda.empty_cache()
    lap("4-5")
    long_counts = run_long_path(kc, card=kind)
    card_against_cpu_step(LONG_ARGS, packed_capacity=256)
    gc.collect()
    torch.cuda.empty_cache()
    lap("6-7")
    ring_counts = run_ring_path(kc, card=kind)
    ring_against_unsharded()
    fused_on_paths = (lse_kern.fused_launches, lse_kern.fused_bwd_launches)
    graphed_against_eager()
    gc.collect()
    torch.cuda.empty_cache()
    lap("8-10")
    rank_counts = run_ranking_path(kc, card=kind)
    card_against_cpu_ranking_step(packed=False)
    card_against_cpu_ranking_step(packed=True)
    gc.collect()
    torch.cuda.empty_cache()
    lap("11-12")
    t0 = time.perf_counter()
    large_counts, large_data = run_large_vocab_path(kc, card=kind)
    t1 = time.perf_counter()
    large_vocab_card_against_cpu(large_data)
    large_vocab_graphed_against_eager(large_data)
    log(f"phase 13 took {t1 - t0:.1f} s, phase 14 {time.perf_counter() - t1:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    lap("13-14")
    t0 = time.perf_counter()
    real_ml1m, real_others, ml1m_run = run_real_data_path(kc, card=kind)
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    lap("15")
    t0 = time.perf_counter()
    split_counts = run_split_optimizer_path(kc, kind, ml1m_run)
    t1 = time.perf_counter()
    split_steps_side_by_side(kc, kind, ml1m_run["root"])
    # one step: from the second on, the attention backward's float atomics
    # (the bias tables' gradients) differ run to run, eager against eager too,
    # and bfloat16 NS-5 turns that float noise into bfloat16 ulps of the
    # matrices' updates
    graphed_against_eager([(f"{preset}, padded", [f"experiment={preset}",
                                                  f"data.data_dir={ml1m_run['root']}"], [None])
                           for preset in SPLIT_PRESETS], steps=1)
    split_eager_twice(ml1m_run["root"])
    split_card_against_cpu(ml1m_run["root"])
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s ({t1 - t0:.1f} s of it the two "
        f"cli.train runs)")
    gc.collect()
    torch.cuda.empty_cache()
    lap("16")
    t0 = time.perf_counter()
    families = run_families_path(kc, kind, ml1m_run)
    family_counts = families["counts"]
    t1 = time.perf_counter()
    family_steps_side_by_side(kc, kind, ml1m_run["root"])
    graphed_against_eager([(run[0] + ", padded", family_args(run, ml1m_run["root"]), [None])
                           for run in FAMILY_RUNS])
    family_card_against_cpu(ml1m_run["root"])
    serve_sasrec(kind, ml1m_run["root"], families["sasrec_best"])
    log(f"phase 17 took {time.perf_counter() - t0:.1f} s ({t1 - t0:.1f} s of it the four "
        f"cli.train runs)")
    gc.collect()
    torch.cuda.empty_cache()
    lap("17")
    t0 = time.perf_counter()
    other_counts = run_other_families_path(kc, kind, ml1m_run)
    t1 = time.perf_counter()
    family_steps_side_by_side(kc, kind, ml1m_run["root"], runs=(ITEM_YEAR_RUN, MOL_RUN))
    graphed_against_eager([(run[0] + ", padded", family_args(run, ml1m_run["root"]), [None])
                           for run in (ITEM_YEAR_RUN, MOL_RUN)])
    family_card_against_cpu(ml1m_run["root"], runs=(ITEM_YEAR_RUN, MOL_RUN))
    log(f"phase 18 took {time.perf_counter() - t0:.1f} s ({t1 - t0:.1f} s of it the five "
        f"cli.train runs and the .ckpt read)")
    gc.collect()
    torch.cuda.empty_cache()
    lap("18")
    variant_counts = run_training_variants_path(kc, kind, ml1m_run, large_data)
    gc.collect()
    torch.cuda.empty_cache()
    lap("19")
    last = run_last_gaps_path(kc, kind, ml1m_run, kern, count_kern, lse_kern, build_logs)
    bf16_counts = last["bf16_counts"]
    gc.collect()
    torch.cuda.empty_cache()
    lap("20")
    sharded = run_sharded_path(kc, kind, ml1m_run, chunk_kern, build_logs, large_data)
    del large_data
    gc.collect()
    torch.cuda.empty_cache()
    lap("21")
    # phases 22 (b), 23 (b) and 24 run in two rank processes of this script,
    # sharing the card over gloo: one start-up for the three, made while
    # this process runs the one-process parts that write their job
    job_dir = OUT_DIR / "ranks"
    shutil.rmtree(job_dir, ignore_errors=True)
    job_dir.mkdir(parents=True)
    job_path = job_dir / "job.pt"
    job4_dir = OUT_DIR / "ranks4"
    shutil.rmtree(job4_dir, ignore_errors=True)
    job4_dir.mkdir(parents=True)
    job4_path = job4_dir / "job.pt"
    procs = start_ranks("--ranks", job_path) + start_ranks("--ranks4", job4_path, world=4)
    procs, procs4 = procs[:2], procs[2:]
    try:
        dp = run_data_parallel_path(kc, kind)
        gc.collect()
        torch.cuda.empty_cache()
        mp_one, mp_want, mp_job = run_model_axis_path(kc, kind)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ring_wants, ring_job, ring_one = ring_group_job(kc, kind)
        PHASE_S["24 one process"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        torch.save({"dp": dp["jobs"], "mp": mp_job, "ring": ring_job}, f"{job_path}.part")
        Path(f"{job_path}.part").replace(job_path)  # whole when the ranks see it
        # (d)'s four ranks build their trainers while the two run
        torch.save({"ring_tp": {"batch": ring_job["batch"], "offsets": ring_job["offsets"],
                                "ports": free_ports(1)}}, f"{job4_path}.part")
        Path(f"{job4_path}.part").replace(job4_path)
        t0 = time.perf_counter()
        ranks = finish_ranks("phases 22 (b), 23 (b) and 24", procs, job_path)
        launch_s = time.perf_counter() - t0
        # (d)'s steps after the two ranks, so their times are theirs alone
        t4 = time.perf_counter()
        Path(f"{job4_path}.go").touch()
        ranks4 = finish_ranks("phase 24 (d)", procs4, job4_path)
        PHASE_S["24 (d) ranks"] = time.perf_counter() - t4
    finally:
        for p in procs + procs4:
            if p.poll() is None:
                p.kill()
    dp_both = (dp["synthetic-hstu"], dp["long"])
    parts = {name: max(r[name + "_s"] for r in ranks) for name in ("dp", "mp", "ring")}
    log(f"phases 22 (b), 23 (b) and 24's two rank processes, started before phase 22 (a), "
        f"took {launch_s:.1f} s after their job was written: their parts {parts['dp']:.1f}, "
        f"{parts['mp']:.1f} and {parts['ring']:.1f} s (the slower rank's), the rest "
        f"{launch_s - sum(parts.values()):.1f} s")
    t0 = time.perf_counter()
    two_processes_on_the_card(kind, dp["jobs"], dp["wants"], [r["dp"] for r in ranks])
    t1 = time.perf_counter()
    mp_ranks = model_axis_on_the_card(kind, mp_want, mp_job, [r["mp"] for r in ranks])
    t2 = time.perf_counter()
    group_counts = ring_group_on_the_card(kind, ring_wants, ring_job, ring_one,
                                          [r["ring"] for r in ranks])
    tp_counts = ring_tp_on_the_card(kind, ring_wants["zigzag"], ring_one,
                                    [r["ring_tp"] for r in ranks4])
    group_counts = dict(collections.Counter(group_counts) + collections.Counter(tp_counts))
    t3 = time.perf_counter()
    PHASE_S["22"] = PHASE_S["22 (a)"] + PHASE_S["22 (b) one process"] + parts["dp"] + t1 - t0
    PHASE_S["23"] = PHASE_S["23 (a)"] + parts["mp"] + t2 - t1
    PHASE_S["24"] = PHASE_S["24 one process"] + parts["ring"] + PHASE_S["24 (d) ranks"] + t3 - t2
    log(f"phase 22 took {PHASE_S['22']:.1f} s: (a) {PHASE_S['22 (a)']:.1f}, (b) "
        f"{PHASE_S['22'] - PHASE_S['22 (a)']:.1f}; phase 23 {PHASE_S['23']:.1f} s: (a) "
        f"{PHASE_S['23 (a)']:.1f}, (b) {PHASE_S['23'] - PHASE_S['23 (a)']:.1f}; phase 24 "
        f"{PHASE_S['24']:.1f} s: the one-process steps {PHASE_S['24 one process']:.1f}, the "
        f"ranks' part {parts['ring']:.1f}, (d)'s four ranks {PHASE_S['24 (d) ranks']:.1f}, the "
        f"checks and the checkpoint in one process {t3 - t2:.1f} (each without the ranks' shared "
        f"start-up)")
    lap("22-24")
    # phase 23: (a)'s one-device steps and (b)'s ranks at shape V; (b)'s
    # packed_sharded ranks at ml-1m width (rows 1-4 and 6)
    mp_v = {k: mp_one.get(k, 0) + mp_ranks.get(("large", k), 0)
            for k in (kern.KERNEL, kern.KERNEL_BWD)}
    mp_packed = {k: mp_ranks.get(("packed", k), 0) for k in (
        kern.KERNEL, kern.KERNEL_BWD, count_kern.KERNEL, lse_kern.KERNEL, lse_kern.KERNEL_BWD)}
    check(all(mp_packed.values()) and all(mp_v.values()),
          f"phase 23 launched a kernel of its path no time: {mp_v} {mp_packed}")

    # no PyTorch call computes HSTU's silu attention with this bias, its
    # backward, or a count-weighted log-sum-exp over a matrix product that is
    # never materialised: library_ms is null for those
    rows = [
        # rows 1-2 and the count, lse rows below add phase 15's runs from
        # files: ml-1m at shape A, ml-20m-hstu-long packed, amzn-books; rows
        # 1-2 and the X=3,883 rows also phase 16's Muon and Scion runs,
        # phase 17's (rows 1-2: aux, in-batch, BCE; X=3,883: aux, SASRec)
        # and phase 18's (rows 1-2: item_year, MoL, layer_norm; X=3,883:
        # item_year, layer_norm, softmax_rel_bias, SASRec with Muon) and
        # phase 19's (rows 1-5 at X=3,883: ml-1m-hstu with remat, at two
        # more seeds, with the profiler, the loggers, the sweep's two runs);
        # rows 1-5 also phase 22 (a)'s data-parallel steps (synthetic-hstu at
        # shape A, class 1152 of ml-20m-hstu-long: rows 1-2, the count, the
        # lse forward and the wide-catalog backward)
        dict(name=kern.KERNEL, source=kern.SOURCE, replaces=kern.REPLACES,
             launches=serving_launches + sum(c[kern.KERNEL] for c in (
                 train_counts, long_counts, real_ml1m, real_others, split_counts,
                 family_counts, other_counts, variant_counts, bf16_counts,
                 sharded["kinds_counts"], *dp_both)) + mp_packed[kern.KERNEL],
             library_ms=None, **serving),
        dict(name=kern.KERNEL_BWD, source=kern.SOURCE_BWD, replaces=kern.REPLACES_BWD,
             launches=sum(c[kern.KERNEL_BWD] for c in (
                 train_counts, long_counts, real_ml1m, real_others, split_counts,
                 family_counts, other_counts, variant_counts, bf16_counts,
                 sharded["kinds_counts"], *dp_both)) + mp_packed[kern.KERNEL_BWD],
             library_ms=None, **attn_bwd),
        # rows 1-2 at the ranking shape R; their launches are the ranking run's
        dict(name=kern.KERNEL + " (ranking shape R)", source=kern.SOURCE,
             replaces=kern.REPLACES, launches=rank_counts[kern.KERNEL], library_ms=None,
             **rank_fwd),
        dict(name=kern.KERNEL_BWD + " (ranking shape R)", source=kern.SOURCE_BWD,
             replaces=kern.REPLACES_BWD, launches=rank_counts[kern.KERNEL_BWD],
             library_ms=None, **rank_bwd),
        # rows 1-2 at synthetic-large-vocab's shape V; their launches are
        # phase 13's (cli.train and the engine calls)
        dict(name=kern.KERNEL + " (large-vocab shape V)", source=kern.SOURCE,
             replaces=kern.REPLACES,
             launches=large_counts[kern.KERNEL] + sharded["shipped_counts"][kern.KERNEL]
             + mp_v[kern.KERNEL], library_ms=None, **large_fwd),
        dict(name=kern.KERNEL_BWD + " (large-vocab shape V)", source=kern.SOURCE_BWD,
             replaces=kern.REPLACES_BWD,
             launches=large_counts[kern.KERNEL_BWD] + sharded["shipped_counts"][kern.KERNEL_BWD]
             + mp_v[kern.KERNEL_BWD], library_ms=None, **large_bwd),
        # rows 3-4 and 6 also phase 24's ranks (the ring over an sp group of
        # 2 at X=26,744: both ranks' steps and fit)
        dict(name=count_kern.KERNEL, source=count_kern.SOURCE, replaces=count_kern.REPLACES,
             launches=sum(c[count_kern.KERNEL] for c in (
                 train_counts, long_counts, ring_counts, real_others, *dp_both, group_counts))
             + mp_packed[count_kern.KERNEL], **counted),
        dict(name=lse_kern.KERNEL, source=lse_kern.SOURCE, replaces=lse_kern.REPLACES,
             launches=sum(c[lse_kern.KERNEL] for c in (
                 train_counts, long_counts, ring_counts, real_others, *dp_both, group_counts))
             + mp_packed[lse_kern.KERNEL], library_ms=None, **lse_fwd),
        dict(name=lse_kern.KERNEL_BWD, source=lse_kern.SOURCE, replaces=lse_kern.REPLACES_BWD,
             launches=train_counts[lse_kern.KERNEL_BWD] + dp["synthetic-hstu"][lse_kern.KERNEL_BWD],
             library_ms=None, **lse_bwd),
        # rows 3-5 at the ml-1m catalog read from files, X = 3,883: their
        # launches are phase 15's ml-1m runs and phases 16-20's (the count's
        # also phase 20's D=256 run; its lse launches are the width-256 rows)
        dict(name=count_kern.KERNEL + " (ml-1m files, X=3883)", source=count_kern.SOURCE,
             replaces=count_kern.REPLACES,
             launches=sum(c[count_kern.KERNEL] for c in (
                 real_ml1m, split_counts, family_counts, other_counts, variant_counts,
                 bf16_counts, last["wide_counts"], sharded["kinds_counts"])),
             **counted_ml1m),
        dict(name=lse_kern.KERNEL + " (ml-1m files, X=3883)", source=lse_kern.SOURCE,
             replaces=lse_kern.REPLACES,
             launches=sum(c[lse_kern.KERNEL] for c in (
                 real_ml1m, split_counts, family_counts, other_counts, variant_counts,
                 bf16_counts, sharded["kinds_counts"])),
             library_ms=None, **lse_fwd_ml1m),
        dict(name=lse_kern.KERNEL_BWD + " (ml-1m files, X=3883)", source=lse_kern.SOURCE,
             replaces=lse_kern.REPLACES_BWD,
             launches=sum(c[lse_kern.KERNEL_BWD] for c in (
                 real_ml1m, split_counts, family_counts, other_counts, variant_counts,
                 bf16_counts, sharded["kinds_counts"])),
             library_ms=None, **lse_bwd_ml1m),
        # the same entry point over the ml-20m catalog, wider than one x-block
        # of the TPU kernels: its launches are the long path's, its numbers
        # those of the [26880, 50] x [26744, 50] check
        dict(name=lse_kern.KERNEL_BWD + " (wide catalog)", source=lse_kern.SOURCE,
             replaces=lse_kern.REPLACES_WIDE,
             launches=sum(c[lse_kern.KERNEL_BWD] for c in (
                 long_counts, ring_counts, real_others, dp["long"], group_counts))
             + mp_packed[lse_kern.KERNEL_BWD], library_ms=None, **lse_bwd_wide),
        # rows 7-8: the same entry points with a sup_off pointer; nothing on
        # the paths calls fused_dense_neg_lse (nor does the JAX package)
        dict(name=lse_kern.KERNEL + " (fused_dense_neg_lse, sup_off)", source=lse_kern.SOURCE,
             replaces=lse_kern.REPLACES_FUSED, launches=fused_on_paths[0],
             library_ms=None, **fused_fwd),
        dict(name=lse_kern.KERNEL_BWD + " (fused_dense_neg_lse, sup_off)", source=lse_kern.SOURCE,
             replaces=lse_kern.REPLACES_FUSED_BWD, launches=fused_on_paths[1],
             library_ms=None, **fused_bwd),
        # rows 1, 2, 4, 5 at width 256 (phase 20): their wide kernels, launched
        # by the D=256 run (its count launches are in the X=3,883 row above)
        dict(name=kern.KERNEL + f" (width {WIDE}, wide kernel)", source=kern.SOURCE,
             replaces=kern.REPLACES, launches=last["wide_counts"][kern.KERNEL],
             library_ms=None, **last["wide"]["fwd"]),
        dict(name=kern.KERNEL_BWD + f" (width {WIDE}, wide kernel)", source=kern.SOURCE_BWD,
             replaces=kern.REPLACES_BWD, launches=last["wide_counts"][kern.KERNEL_BWD],
             library_ms=None, **last["wide"]["bwd"]),
        dict(name=lse_kern.KERNEL + f" (width {WIDE}, 256-column slices)", source=lse_kern.SOURCE,
             replaces=lse_kern.REPLACES, launches=last["wide_counts"][lse_kern.KERNEL],
             library_ms=None, **last["wide"]["lse_fwd"]),
        dict(name=lse_kern.KERNEL_BWD + f" (width {WIDE}, 256-column slices)",
             source=lse_kern.SOURCE, replaces=lse_kern.REPLACES_BWD,
             launches=last["wide_counts"][lse_kern.KERNEL_BWD], library_ms=None,
             **last["wide"]["lse_bwd"]),
        # rows 9-10: numbers of the fully live 130 x 130 chunk, the zigzag
        # ring's most common call (28 of 36 a block); launches of phase 8's
        # ring and phase 24's ranks
        dict(name=chunk_kern.KERNEL, source=chunk_kern.SOURCE, replaces=chunk_kern.REPLACES,
             launches=ring_counts[chunk_kern.KERNEL] + group_counts[chunk_kern.KERNEL],
             library_ms=None, **chunk_fwd),
        dict(name=chunk_kern.KERNEL_BWD, source=chunk_kern.SOURCE_BWD,
             replaces=chunk_kern.REPLACES_BWD,
             launches=ring_counts[chunk_kern.KERNEL_BWD] + group_counts[chunk_kern.KERNEL_BWD],
             library_ms=None, **chunk_bwd),
        # rows 9-10 at width 256 (phase 21): the wide kernels on the live
        # 130 x 130 chunk; their launches are the D=256 ring's (both layouts)
        dict(name=chunk_kern.KERNEL + f" (width {WIDE}, wide kernel)", source=chunk_kern.SOURCE,
             replaces=chunk_kern.REPLACES,
             launches=sharded["ring_counts"][chunk_kern.KERNEL], library_ms=None,
             **sharded["wide_chunk"]["fwd"]),
        dict(name=chunk_kern.KERNEL_BWD + f" (width {WIDE}, wide kernel)",
             source=chunk_kern.SOURCE_BWD, replaces=chunk_kern.REPLACES_BWD,
             launches=sharded["ring_counts"][chunk_kern.KERNEL_BWD], library_ms=None,
             **sharded["wide_chunk"]["bwd"]),
    ]
    for row in rows:
        row["route"] = "cuda"
    # phases 13-15, 20, 21 (a)-(d) and 22: a measure of the host's speed (it
    # includes phases whose depth was cut; compare hosts on uncut phases too)
    speed = LAPS["13-14"] + LAPS["15"] + LAPS["20"] + PHASE_S["21 (a)-(d)"] + PHASE_S["22"]
    whole = sum(v for k, v in LAPS.items() if k != "_last")
    log("phase times (s): " + ", ".join(f"{k} {v:.1f}" for k, v in LAPS.items()
                                        if k not in ("start", "_last"))
        + f"; the whole {whole:.1f} s")
    log(f"host-speed sum (phases 13-15, 20, 21 (a)-(d) and 22): {speed:.1f} s (454.9 s on the "
        f"host where the whole took 963 s): the whole at that host's speed "
        f"{whole * 454.9 / speed:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
