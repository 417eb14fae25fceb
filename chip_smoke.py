#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU (written for the H100):

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. card  — CUDA must be available; prints the card's name and power limit.
2. build — compiles every ``src/repro_torch/kernels/*/csrc/*.cu`` with nvcc
   for sm_90a (one process per source, in parallel) into one library.
3. kernels — each of the six kernels against its plain PyTorch version on
   the card at the full width of ``sdim-paper`` (d=128, m=48, tau=3,
   L=1024, C=128, E=16), on margin-screened inputs, at B=32 and at every
   shape the main paths give it (history encode, query, fused serve, inline
   serve and target attention of a 16-request burst; the encode and update
   of a 32-user event burst), with ragged masks, ragged C and L and fully
   masked users where a kernel takes them; times of kernel and plain
   version at the main paths' shapes (CUDA events, median of 30 after 3
   warm-up calls, wrapper included), the device time per call of each
   kernel, its plain version and the library call there (torch.profiler
   over 20 calls, with the device launches it recorded of those the calls
   made: ``*_device_launches``; where it recorded fewer, the time per call
   comes from the calls they make up), the bound from the bytes and
   FLOP this run's data needs, and for target attention the time of
   PyTorch's ``scaled_dot_product_attention`` on the same inputs (a
   yardstick only). All six kernels split or share their work without
   atomics and must give the same bits on two launches (sdim_query off
   bf16 and fp32 tables, sdim_update on a fresh clone of the store each
   time); bse_encode is also timed at 8 and 16 group slices per user. The
   three backward kernels (bse_encode_backward, sdim_query_backward,
   target_attention_flash_backward) are held against their closed-form
   plain versions at the training step's shapes (B=32, L=1024, C=1) and at
   C=128, with bf16 behaviors, fully masked users and C=0 / L=0, give the
   same bits on two launches and are timed at C=1. target_attention_flash
   and its backward are also held and timed at the retrieval kinds' folded
   shape (B*C = 2,048 users of one candidate over the k = 32 rows each
   retrieved; some with fewer valid rows, some with none). Then the same
   checks and timings (one function, ``kernel_phase``, at a width) for
   all nine kernels at dien's behavior width d = 36, kernel 6 and its
   backward at the main and the folded shape too, where bf16 rows are 72
   bytes (an odd L, odd E) and int8 / fp8 rows 36 (the ``d36`` entry of
   each kernel's JSON). sdim_fused_serve's int8 store is timed beside its
   fp32 one at both widths. The bounds of the five kernels the engine
   dispatches are ``kernels/cost.py``'s counts, the ones the profiler of
   phase 11 predicts with.
4. decoupled path — ``sdim-paper`` FULL (10M x 64 item table) with random
   weights from a seeded generator, served through ``CTRServer.
   handle_requests``: 64 requests of 128 candidates in bursts of 16,
   unfused (fetch_many + sdim_query), fused (sdim_fused_serve) and fused
   off an int8 store; then an ingest_events burst (sdim_update) and the
   same requests again. Scores must be finite, fused and unfused must
   agree within the bf16 wire tolerance.
5. inline path — the same model and requests through ``mode="inline"``
   (bse_serve, once per burst), against a decoupled server with an fp32
   wire (max |d score| <= 1e-4) and phase 4's bf16-wire scores before the
   event burst (<= the wire tolerance).
6. target path — FULL with interest kind ``"target"`` (random weights from
   a seeded generator) through ``mode="target_attention"``
   (target_attention_flash, once per burst): finite scores, and the first
   burst's long-branch interest against the plain version.
7. train path — ``sdim-paper`` FULL, kind ``"sdim"``, seeded random
   weights, trained by ``make_train_step`` with the launcher's settings
   (Adagrad lr 0.05, clip 10, batches of 32 from the port's
   ``DeterministicStream`` of ``generate_batch_graded``). The item rows of
   what step 1 hashes are redrawn until they clear the hash margin; step
   1's gradients through the kernels are held against the same step
   through the plain versions on the card (each parameter's max error over
   its largest gradient <= 1e-4); 20 steps with finite losses, ms/step
   (median after warm-up, host clock ending in ``loss.item()``); a
   checkpoint saved, restored into a fresh model and optimizer, and the
   next step's loss bit-equal; then kind ``"target"`` the same way for 4
   steps. One step of each kind runs under ``torch.profiler``.
8. comparison path — the paper's Table 2/3 kinds on the card. (a) FULL
   width: ``sdim-paper`` FULL with each of ``avg``, ``sim_hard``, ``eta``,
   ``ubr4ctr``, ``din_mlp``, ``sdim`` of the SRHT family and
   ``sdim_expected`` swapped in, sharing one draw of the embedding tables:
   one 16-request burst of 128 candidates through ``CTRServer`` (inline;
   decoupled for sdim) with finite scores, the burst's long-branch
   interest against the plain versions on the card, step 1's gradients
   through the kernels against the plain versions' (as phase 7) and two
   Adagrad steps with finite losses. Where a hash decides a bucket or a
   top-k (eta, sdim) the item rows the burst and step 1 hash are
   margin-screened; for ubr4ctr the rows at each candidate's top-k
   boundary are redrawn until the k-th and (k+1)-th scores are apart.
   sdim_expected has no kernel and its gradient is not finite (ROADMAP.md
   §C, C2): it runs last, and its non-finite gradient is reported, not
   failed. (b) The protocol: first each of its kinds that runs a kernel
   (sim_hard, ubr4ctr, eta, sdim, target), built as the protocol builds it
   (d = 32, L = 256, k = 16) and screened, is held against the plain
   versions on the protocol's first batch of 128 and first eval batch of
   1,024 (logits, and step 1's gradients on the batch of 128); every kind
   trained twice for 5 AdamW steps from one seed at the protocol's shapes
   must end with parameters of the same bits (fault C5; sdim_expected's
   where finite); then ``repro_torch.bench.table23_auc`` at its ``quick``
   depth (600 steps,
   batch 128, L = 256, 4,096 eval examples) for all eight kinds: AUC,
   us/step and the two derived claims; every kind but sdim_expected must
   train with finite losses.
9. production path — ``sdim-paper`` FULL (seeded random weights) through
   the production serving runtime: ``CTRServer.build`` with the tiered
   store (hot 1,024 users = 64 MiB of fp32 rows, warm 2,048, cold
   segments under ``build/``, CLOCK), async ingest (a writer thread on its
   own CUDA stream), admission (concurrency 4, a token bucket) and a
   tracer, three times: fp32 fused, int8 fused, int8 unfused. Traffic:
   4,096 users in bursts of 16 requests of 128 candidates (missing users'
   histories enqueued), an event burst of 32 single events after every
   fourth burst, then the first 256 users again (warm and cold
   promotions); the item rows this traffic hashes are screened first.
   Checks, each failing the phase: each kernel the path called, held
   against its plain version on copies of the inputs of its first and
   widest call in the run (``KernelInputs``: history and event folds
   through bse_encode, the event fold on a clone of the hot tier, fused
   reads off a committed view's store and scales, unfused reads of
   fetched wire tables); after ``flush()`` a
   check burst across the tiers scores bit for bit as a synchronous,
   untiered server fed the same folds in the same order (the writer's
   folds are logged and replayed); reads during a fold held on the host
   and on the writer stream return the previous committed version, and
   a view held across folds keeps its bits; snapshot -> restore into a
   new server answers the check burst bit for bit (fp32); every residency
   pass keeps the batched bound (one hot gather, two hot scatters); the
   health probe is live and ready; the writer stops cleanly; no request
   is shed; all four kernels of the path launch. Prints ms/request,
   ``ctr.request_ms`` p50/p95/p99, the ingest stats, tier sizes, hit rate
   and moved bytes, the admission summary, the copy-on-write clone's
   time and ``tracer.report(5)``.

10. archs path — wide_deep, bst, dien and bert4rec at their FULL configs
   (seeded random weights from the port's init), one after another, the
   card freed between them; the item rows each burst, its events and
   step 1 hash are screened first. bst, dien and bert4rec serve 64
   requests of 128 candidates in bursts of 16 through ``CTRServer``
   decoupled unfused (bf16 wire), fused off an fp32 and an int8 store, and
   inline; 32 single events fold after the first pass, then the requests
   are served twice more. wide_deep scores the same bursts three times
   through ``score_candidates_many(..., sparse_ids=...,
   bucket_tables=...)`` on the bf16 wire and inline. Each arch then takes
   8 Adagrad steps at batch 32. Checks, each failing the phase: each kernel
   a server called, held against its plain version on copies of its own
   inputs (phase 9's ``KernelInputs`` seam); the burst's long branch and a
   batch's logits through the kernels against the plain versions;
   inline against decoupled on an fp32 wire (max |d score| <= 1e-4);
   fused against unfused (the wire tolerance); the event fold moves the
   scores; step 1's gradients (GRAD_TOL); finite losses; every kernel of
   the arch launched (bse_encode, sdim_query, bse_serve and both backward
   kernels; sdim_update and sdim_fused_serve for the CTRServer archs).
   Prints per arch the median, min and max ms/request of the 8 bursts
   after the fold (each setup) and ms/step of steps 2-8, one profiled
   fused burst of each CTRServer arch, one profiled training step of each
   arch (after the launch counts were read) and peak training memory.
   Then dien FULL (d = 36) with interest kind ``"target"``: one burst of
   16 x 128 through ``mode="target_attention"`` and two Adagrad steps;
   its scores against the same server on the plain version (<= 1e-4),
   step 1's gradients (GRAD_TOL), finite losses.
11. profile path — the serve launcher with ``--profile --profile-dir`` on
   ``sdim-paper`` FULL, in process (``launch.serve.build`` with the FULL
   config, this script's traffic, ``launch.serve.report``): fused, tiered
   (hot 128 users below 256 served, warm 64, a cold directory under
   ``build/``), once fp32 synchronous and once int8 with
   ``--async-ingest``; 32 single events after every fourth burst of 16 x
   128. Checks: finite scores; ``ledger.verify()`` empty; the written
   ``profile.json`` passes ``tools/bench_check.py::check_profile``;
   encode, serve_fused and (fp32) update each timed and compiled at least
   once; no record's unclamped predicted / measured time above 1.05,
   per kernel and per signature (the profiler counts every timed call on
   its own data; a ratio above would mean a count in ``kernels/cost.py``
   is wrong); the ledger's hot bytes those of the hot store's tensors.
   Prints each record and each signature's record (calls, compiles,
   measured and predicted ms, bottleneck, the ratio), how far the
   largest ratio lies below 1.05, the ledger, and ms/request of 8
   steady bursts of 16 with the profiler and 8 without, alternating
   (median and range).
12. sharded path — ``sdim-paper`` FULL (the seeded model of phases 4-5)
   with its BSE table store over 8 shards on this one card
   (``CTRServer.build(mesh=MeshCtx((cuda:0,) * 8))``), each run beside a
   single-device server fed the same traffic (a comparison: its launches
   are not counted): the store starts at 512 slots and ingests 4,096 users
   of L = 1024 in bursts of 512 (every shard doubles three times: 256 MiB
   of fp32 rows, 64 MiB of int8); 64 requests of 128 candidates, twice, in
   bursts of 16, the events of 32 users (E = 16) after every fourth burst;
   fp32 fused, int8 fused and unfused (bf16 wire); ``serve_sharded``
   against ``serve`` on a burst; then a sharded tiered store (hot 1,024,
   warm 2,048, cold) with async ingest, single events. Checks, each
   failing the phase: scores within 1e-5 of the single-device server's
   (the measured max printed; the masked launches add exact zeros, so it
   reads 0); ``serve_sharded`` within 1e-5 of ``serve``; ``shard_load()``
   balanced within 1 and three doublings; ``ledger.verify()`` empty;
   sdim_update and sdim_fused_serve as one shard's launch took them (the
   widest call; foreign rows masked out) against their plain versions
   (FP32); the tiered check burst bit for bit as a synchronous untiered
   single-device server replaying the same folds and after snapshot ->
   restore onto 8 shards. Prints launches per burst and per event fold,
   ms/request sharded beside single-device (8 launches a dispatch on one
   card: not a speed across GPUs), the card's name and power limit.
13. LM path — the dense GQA LM stack: ``qwen3-8b`` FULL (8,190,735,360
   parameters, fp32, built on the card from the port's init with seed 0,
   R from seed 1234), after the earlier phases' memory is freed; prints
   init seconds and ``max_memory_allocated``. (a) a prefill of 2,048
   random tokens on the query-chunked path (q_chunk 1,024) against the
   masked path (q_chunk above T): last-position logits within 1e-4 of the
   largest |logit|; (b) 256 tokens of exact decode from an empty fp32
   cache against the forward pass over the same tokens, every position's
   logits within the same tolerance; (c) the same tokens through
   ``sdim_decode_step`` from an empty SDIM cache: finite logits, layer 0's
   count table equal to ``encode_sdim_cache_from_kv`` of (b)'s cache (layer
   0 sees the same key bits on both paths) and its value table within
   1e-4, the offline encode the same bits twice; the exact-vs-SDIM
   next-token overlap and top-10 overlap are printed (an approximation: no
   limit); (d) sdim_query at the path's call, (8 kv heads, 4 query heads,
   128) against the last layer's table, held against its plain version
   (FP32), the same bits twice, timed beside its plain version and bound,
   with the kernel's per-launch device times warm and cold (the ``lm``
   entry of sdim_query's JSON); (e) ms/token (host clock to
   ``.item()``, median of 16 after 4 warm-ups) of exact decode at cache_len
   1,024 and 32,767 of a 32,768-row cache of random values and of SDIM
   decode, each beside its bound (every weight read once but the token
   embedding, of which one row, and the cache read, over 3.35 TB/s) and one
   step of each under torch.profiler (device-busy share, top five ops);
   the cache bytes of both paths; the card's name and power limit; (f)
   split-KV decode (``sp_decode_step``) over 8 sequence shards on this one
   card (``MeshCtx((cuda:0,) * 8, seq_axes=("model",))``) on (e)'s cache
   at cache_len 1,024 and 32,767 against ``decode_step``'s logits at the
   same position (within 1e-4 of the largest |logit|), the new token's k
   and v against the rows ``decode_step`` writes (the first layer's bit for
   bit, every layer's within 1e-4 of the largest), and its ms/token beside
   exact decode's (8 shards on one card: not a speed across GPUs).
14. MoE and latent attention path — ``deepseek-moe-16b`` FULL (28 layers,
   16,375,728,128 parameters, fp32) and ``deepseek-v2-236b`` at full width
   cut to 2 layers (its first dense block and one MoE layer with MLA,
   5,358,679,040 parameters), one after the other on the card freed by
   phase 13, each built from the port's init (seed 0), B = 1: (a) a prefill
   of 2,048 random tokens on the chunked path against the masked path
   (LM_TOL); (b) 64 tokens of exact decode against the forward pass over
   the same tokens within 1e-5 of the largest |logit|, every MoELayer's
   capacity_factor set to n_experts / top_k for this check only (at the
   default the forward's experts would drop tokens that single-token steps
   never drop); (c) the same tokens through ``sdim_decode_step``: finite
   logits, the overlap with exact printed, sdim_query launched once a
   scanned layer and token (27 and 1; for MLA on its wide path, the latent
   being 512 wide), and the first scanned layer's count table equal to the
   offline encode of an exact cache decoded with the dense block's output
   projections zeroed (the SDIM path skips the dense blocks, fault C6 of
   the reference: only then does that layer see the same inputs on both
   paths), its value table within 1e-4; (d) sdim_query at each arch's call
   against the first scanned layer's table on screened queries, as phase
   13's (d): deepseek-moe-16b's (16 kv heads, 1 query head, 128) on the
   fused body (the ``moe`` entry of sdim_query's JSON), deepseek-v2's (1,
   128, 512) on the wide path and at B = 8 against random tables (the
   ``mla`` entry); (e) ms/token and host issue
   time of exact decode at cache_len 1,024 and of SDIM decode, one profiled
   step of each, peak memory, and each step's bound: every weight read once
   but the unread embedding rows (the MoE runs every expert over its
   capacity buffer, as the reference), plus the cache read, over 3.35 TB/s;
   (f) split-KV decode as phase 13's (f) at cache_len 1,024, over 8
   sequence shards with the experts over 8 expert shards (64 and 160: 8
   and 20 a shard), every MoELayer's capacity_factor n_experts / top_k as
   in the reference's test; for deepseek-moe-16b also one MoE layer's
   forward at B = 2 x 64 tokens over ``MeshCtx((cuda:0,) * 4, data=2)``
   (two data groups, 16 experts a shard) against the one-device path
   within 1e-5 of the largest output. Prints the phase's wall time.
15. LM training path — ``lm_train``, on the card freed by phase 14, each
   model from the port's init (seed 0), fp32 with TF32 off, trained through
   ``launch.train.lm_setup`` and ``train.loop.run`` (AdamW 3e-4,
   warmup-cosine, clip 1) on ``lm_stream``'s batches. LM training launches
   none of the port's kernels (the reference's reaches no Pallas kernel):
   its counts are read and all are 0. (a) granite-3-2b FULL (40 layers,
   2,533,531,648 parameters, remat "full") at B = 2 x 4,096 tokens
   (LM_SHAPES' train_4k length; its global batch of 256 cut to 2): 4 AdamW
   steps, every loss finite; ms/step (median after the first), tokens/s,
   ``launch/flops.py``'s model flops over 67 TFLOP/s, peak memory beside
   the prediction; one more step under torch.profiler; then one batch
   repeated for 4 steps, whose last loss must lie below its first. (b)
   granite-3-2b at full width cut to 4 layers, B = 1 x 4,096: the loss and
   every gradient under remat "full", "dots" and "dots_no_batch" equal
   "none"'s bit for bit. (c) Two trainings of 3 AdamW steps from one seed
   end with parameters of the same bits: granite-3-2b at 4 layers (tied
   embedding), deepseek-moe-16b at 4 layers (the MoE dispatch). (d)
   deepseek-moe-16b at full width cut to 4 layers (1 dense, 3 MoE;
   2,267,039,744 parameters), B = 1 x 4,096, remat "full": the first of
   (c)'s trainings, with ms/step, peak memory and each step's aux loss, and
   one profiled forward and backward pass. (e) deepseek-v2-236b at full
   width cut to 2 layers, B = 1 x 2,048: one forward and backward pass and
   no optimizer step (its AdamW state does not fit one card), every
   gradient finite; the dense block's MLAttention forward and backward on
   its chunked path (CUDA events) and peak memory. Prints the phase's wall
   time.
16. GNN path — ``gnn``: gatedgcn FULL (16 layers, d_hidden 70, remat on)
   with ``registry.gnn_config_for_shape`` at three of its GNN_SHAPES, each
   from the port's init (seed 0), fp32 with TF32 off, trained with the
   launcher's AdamW (lr 1e-3) through ``train.loop.run`` on one graph
   resident on the card: ``full_graph_sm`` (``cora_like(0)``), ``molecule``
   (``molecule_batch(128, 30, 64, 16, 4)``, graph readout) and
   ``minibatch_lg`` (``NeighborSampler`` of fanout (15, 10) over
   ``random_graph(232,965, 114,615,892, 602)``, 1,024 seeds, flattened into
   its union subgraph with ``edge_mask`` by ``data/graph.flatten_block``;
   ogb_products, 17 GB an edge tensor and 277 GB of remat state, does not
   fit one card). (a) 4 steps each, every loss finite; ms/step (host clock
   to the loss's ``float``, median after the first), ``launch/flops.py``'s
   model flops over 67 TFLOP/s, peak memory and the graph's sizes; at
   minibatch_lg one more step under torch.profiler and then 4 more steps
   on its one batch, whose last loss must lie below its first. (b) At
   minibatch_lg remat on and off give the loss and every gradient with the
   same bits. (c) Two trainings of 3 steps from one seed end with
   parameters of the same bits (the gathers and segment sums add without
   atomics). (d) The edge-sharded loss and gradients (``loss(graph,
   mesh=MeshCtx((cuda:0,) * 4, data=2), axes=...)``) against the
   one-device path, the loss within 1e-5 and every gradient within 1e-4 of
   the largest: minibatch_lg over 8 blocks (``("data", "model")``) and
   full_graph_sm over 4 (``("model",)``; 10,556 edges do not divide by
   8). (e) The GNN reaches none of the port's kernels (the reference's
   reaches no Pallas kernel): its counts are read and all are 0. Prints
   the phase's wall time.
17. mesh path — ``mesh``: the sharded LM training state on
   ``MeshCtx((cuda:0,) * 4, data=2)`` (a (2, 4) data x model mesh on this
   one card), fp32 with TF32 off, from the port's init (seed 0). (a)
   granite-3-2b at full width cut to 4 layers, B = 2 x 4,096, remat
   "full": ``loss(mesh=)`` with ``act_seq_shard`` gives the loss and every
   gradient within 1e-5 of the largest of ``mesh=None`` (the same bits
   expected; printed), with ``manual_tp`` within 2e-2 (the reference's
   bf16 tolerance); remat "none" under the mesh gives remat "full"'s bits;
   ms per forward and backward (host clock to a synchronize, median of 3
   after the checked call) and peak memory of each beside each other. (b)
   deepseek-moe-16b at full width cut to 4 layers (1 dense, 3 MoE), B = 2
   x 2,048: the first MoE block under the mesh equals the one-device block
   run on each data shard's tokens alone within 1e-5 of the largest (one
   data shard's capacity); the model's loss under the mesh is finite and
   its distance from the one-device loss printed; with the capacity factor
   at n_experts / top_k (nothing drops) the loss and gradients under the
   mesh lie within 1e-5 of one device. (c) (b)'s model, B = 2: a
   256-token prefill under the mesh against one device (nothing dropping)
   within 1e-5 of the largest logit, the exact cache of those tokens, its
   offline SDIM encode, then 16 tokens of ``decode_step(mesh=)`` and
   ``sdim_decode_step(mesh=)`` against ``mesh=None`` within 1e-5 of the
   largest logit; kernel 4's launches in the SDIM tokens under the mesh are
   the path's count (3 a token), the ``mesh=None`` references uncounted.
   (d) (a)'s parameters exported (``export_lm_params``), saved
   (``train/checkpoint.save``) and restored by ``restore_on_mesh`` onto
   ``data=2, model=4`` and ``data=4, model=2``: every gathered leaf equals
   the saved one bit for bit, every spec equals ``valid_for_mesh(
   param_spec("lm", ...))``, the bytes one card of each mesh holds against
   the whole tree printed, and a model loaded from the gathered leaves
   gives (a)'s loss with the same bits. (e) ``compressed_psum`` over the
   gradient trees of (a)'s two data halves: every leaf within one int8
   step (the shared max|g| / 127) of the halves' mean, the same bits on
   two calls. Prints the phase's wall time.
18. dry run, examples, embedding — ``dryrun`` and ``examples``: the
   port's last modules. (a) ``launch/dryrun.run_cell`` for the 40 cells on
   the (16, 16) and (2, 16, 16) production meshes and the single-pod
   variant cells (LM train x amp/opt/bf16params/manual_tp, LM decode x
   sdim_kv, recsys x bf16emb/target_attention): the count of cells, the
   time, the largest counted ``hbm_total_per_chip_gib`` per family and
   mesh. (No (b): allocating each cell's card-0 blocks only repeats the
   count, which ``tests/test_torch_dryrun.py`` holds against the
   reference's ``shard_shape``.) (c) Real steps on one card from
   ``specs.materialize`` (seed 0) under the cell's one-card ``MeshCtx``
   (every block on cuda:0): the four recsys archs' ``serve_p99`` (B = 512)
   and bst's ``target_attention`` serve cell at FULL; gatedgcn
   ``full_graph_sm`` and ``molecule`` at FULL; granite-3-2b ``train_4k`` at
   full width cut to 2 layers and B = 2 (the cuts are printed). Each output
   is finite; a serve cell's (kind sdim: the item rows it hashes redrawn
   in the tree until they clear the hash margin, the count printed) is
   held against the same step with the
   model's long branch on the kernels' plain versions (``plain_long_branch``,
   uncounted; ATOMIC for kind sdim, FP32 for target), so bse_encode,
   sdim_query and target_attention_flash are held at this path's shapes,
   and must launch; a train cell's updated parameters are finite and its
   update counted once (no kernel there). (d) The
   four examples at their reference defaults (``train_ctr`` at 20 steps,
   then killed at step 10 by its preemption event and resumed to 20: the
   same parameters, bit for bit, as the run never stopped): wall seconds
   and each kernel's launches; serving_bse must launch bse_encode,
   sdim_update, sdim_query and bse_serve, tiered_serving bse_encode and
   sdim_update, train_ctr bse_encode and sdim_query. (e) The embedding
   functions at wide-deep's FULL field layout (40 one-hot fields of
   1,000,000 x 32): ``EmbeddingCollection.apply``, ``bag_lookup`` (sum,
   mean, max, weighted, an empty bag), ``multihot_lookup`` and
   ``qr_embedding`` on the card against the same on the CPU within atol
   1e-6, the same bits on two calls, and a bag sum's table gradient the
   same bits twice and within 1e-6 of the CPU's. Prints the phase's wall
   time.
19. bench — ``repro_torch.bench``, the paper's benchmarks, through their
   normal entry points. (a) ``table5_serving.run(quick=False)``: the
   decoupled, inline and target-attention ``CTRServer``s at T = 2,000, B =
   1,024, 20 requests; throughput and fused sections at N = 1,024; AUC
   parity after 400 AdamW steps; 8 shards x 512 users on this one card;
   ingest, pressure, SLO, trace and profile sections; each SDIM section
   also on its ``cpu`` side (the plain versions on the host, at the sizes
   the reference gives interpret-mode Pallas). Prints every row, the
   ms/request of each deployment and the share of TA the decoupled path
   saves, fused against two-dispatch (users/s, p50/p95/p99; fused within
   1e-5 of two-dispatch or the phase fails), the int8 bytes ratio and AUC
   gap, the hit rates, under-ingest p95 against read-only beside the
   reference's 1.2x (a number, not a gate), the SLO shed and degrade rates;
   then ``tools/bench_check.py`` on the ``results/torch/BENCH_serving.json``
   it wrote, in a child process (a non-zero exit fails the phase). (b)
   ``table1_complexity.run(quick=False)``: L up to 16,384, B up to 4,096,
   with the L-scaling row. (c) Fig. 2, Table 4 and Fig. 5 at smoke depth
   (AUCs printed, not gated; every tau trains through the kernels, tau 5
   and 10 through their large-tau paths). (d) each kernel at the phase's shapes
   against its plain version on screened inputs, uncounted
   (``bench_kernel_checks``). Prints the phase's wall time.
Every launch count is set to 0 just before each of phases 4-19 and read
just after it; each phase fails if one of its kernels never launched
(phase 7: bse_encode, sdim_query and both their backward kernels, and
target_attention_flash and its backward kernel; phase 8 the same six;
phase 9 bse_encode, sdim_update, sdim_fused_serve and sdim_query; phase
10 all nine; phase 11 bse_encode, sdim_update and sdim_fused_serve; phase
12 bse_encode, sdim_update, sdim_fused_serve, sdim_query and bse_serve;
phases 13 and 14 sdim_query; phase 14's counts are read after each
arch's SDIM decode and summed, so they count decode tokens only, as
phase 13's; phases 15 and 16 none; phase 17 sdim_query, counted over the
SDIM tokens under the mesh; phase 18 as its (c) and (d) say, (c) read as
``dryrun`` and (d) as ``examples``; phase 19 all six forward kernels,
read before its (d)).
Launches made only to hold a kernel against its plain version (step 1's
gradient checks, phase 8's and 10's long-branch checks, phase 9's, 10's
and 12's kernel checks, phase 8's repeated trainings) or by a server that
only serves as a comparison (phase 9's and 12's synchronous references
and restored servers, phase 10's fp32-wire server, phase 12's
single-device servers, phase 13's and 14's kernel checks) are not counted. After the
counts are read, each of phases 4-7 runs one more steady burst
or step under ``torch.profiler`` and prints the device-busy share of its
wall time and its five costliest device operations (fused server for
phase 4). Prints the kernels' JSON line (``launches``: the kernel's own
path; ``launches_by_path``: every phase, phase 10 as ``archs``, phase
11 as ``profile``, phase 12 as ``sharded``, phase 13 as ``lm``, phase 14
as ``moe_mla``, phase 15 as ``lm_train``, phase 16 as ``gnn``, phase 17
as ``mesh``, phase 18 as ``dryrun`` and ``examples``, phase 19 as
``bench``), then as the
last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

B, L, C, D, M, TAU, E = 32, 1024, 128, 128, 48, 3, 16
BURST, EV_USERS = 16, 32      # main path: requests per burst, users per event burst
G, U = M // TAU, 1 << TAU
FP32 = dict(atol=1e-5, rtol=1e-5)
ATOMIC = dict(atol=1e-4, rtol=1e-5)   # bse_encode: sums of up to L rows in another order
BF16_OUT = dict(atol=1e-5, rtol=8e-3)  # a gradient written in bf16: one bf16 step
TRAIN_B, TRAIN_STEPS = 32, 20          # phase 7: batch, steps of sdim-paper FULL
FOLD_L = 32                           # rows a retrieval kind retrieves per candidate at FULL
# phase 8: the kinds swapped into sdim-paper FULL; sdim_expected last, since
# its non-finite gradient (ROADMAP.md, C2) leaves NaN in the tables it trains
COMPARE_KINDS = ("avg", "sim_hard", "eta", "ubr4ctr", "din_mlp", "sdim-srht", "sdim_expected")
GRAD_TOL = 1e-4                       # phase 7: kernel vs plain gradients / largest gradient
WIRE_TOL = 5e-2                       # fused vs unfused: bf16 wire tables
INLINE_TOL = 1e-4                     # inline vs decoupled over an fp32 wire
# phase 9: hot and warm tier capacities, users (64 KiB a fp32 row: a 64 MiB
# hot tier, and at least 1,024 users spill to cold), single events per event
# burst, one event burst after every PROD_EV_EVERY request bursts, early
# users served again
PROD_HOT, PROD_WARM, PROD_USERS = 1024, 2048, 4096
PROD_EV, PROD_EV_EVERY, PROD_REVISIT = 32, 4, 256
PROD_QUEUE = 4 * PROD_USERS   # ingest queue bound: the first pass drops nothing
# phase 10: the four other CTR archs at FULL width, each on its own card-
# resident model; ARCH_REQUESTS requests served in bursts of BURST, ARCH_EV
# single events folded, the requests served twice more (the timed bursts);
# ARCH_STEPS Adagrad steps (step 1 untimed). Phase 3 also times the seven
# kernels these archs widen at dien's behavior width D36 = 2 * 18.
ARCHS = ("wide_deep", "bst", "dien", "bert4rec")
TARGET_KERNELS = {"target_attention_flash", "target_attention_flash_backward"}
ARCH_REQUESTS, ARCH_EV, ARCH_STEPS = 64, 32, 8
D36 = 36
# phase 11: the serve launcher's --profile at FULL: hot and warm tier
# capacities and users (hot below the users, so rows demote, and spill to
# cold), single events after every PROF_EV_EVERY bursts, steady bursts timed
# with and without the profiler, the most a prediction may exceed a
# measurement
PROF_HOT, PROF_WARM, PROF_USERS = 128, 64, 256
PROF_EV, PROF_EV_EVERY, PROF_STEADY = 32, 4, 8
PROF_RATIO = 1.05
C5_STEPS = 5            # phase 8 (b): AdamW steps of each of the two trainings a kind
# phase 12: the sharded path: SHARDS shards of the BSE store on this one
# card, starting at SHARD_CAP slots and ingesting SHARD_USERS users (L =
# 1024) in bursts of SHARD_INGEST, so every shard doubles three times; the
# first SHARD_REQUESTS users' requests, twice, in bursts of BURST, EV_USERS
# users' events after every PROD_EV_EVERY-th burst; scores against a
# single-device server within SHARD_TOL (the reference's sharded tolerance)
SHARDS, SHARD_CAP, SHARD_USERS, SHARD_INGEST = 8, 512, 4096, 512
SHARD_REQUESTS, SHARD_TOL = 64, 1e-5
# phase 13: the dense GQA LM stack, qwen3-8b FULL in fp32: an LM_PREFILL-
# token prefill, LM_DECODE tokens of exact and SDIM-compressed decode, logits
# within LM_TOL of the largest |logit|; ms/token at each of LM_CACHE_LENS in
# an LM_MAX_LEN-row exact cache and of the SDIM path, median of LM_TIMED
# steps after LM_WARM; HBM the card's memory rate (bytes/s)
LM_PREFILL, LM_DECODE, LM_MAX_LEN = 2048, 256, 32768
LM_CACHE_LENS = (1024, 32767)
LM_TIMED, LM_WARM, LM_TOL = 16, 4, 1e-4
LM_PARAMS = 8_190_735_360
HBM = 3.35e12
# phase 14: deepseek-moe-16b FULL and deepseek-v2-236b at full width cut to
# MOE_V2_LAYERS layers (each arch's parameter count in MOE_PARAMS): an
# LM_PREFILL-token prefill, MOE_DECODE tokens of exact and SDIM decode,
# ms/token of exact decode at cache_len MOE_CACHE_LEN and of SDIM decode;
# exact decode against the forward within MOE_TOL of the largest |logit|
MOE_DECODE, MOE_CACHE_LEN, MOE_V2_LAYERS, MOE_TOL = 64, 1024, 2, 1e-5
MOE_PARAMS = {"deepseek-moe-16b": 16_375_728_128, "deepseek-v2-236b": 5_358_679_040}
# phase 15: LM training. (a) granite-3-2b FULL (LMT_GRANITE_PARAMS
# parameters) at LMT_B x LMT_SEQ tokens (LM_SHAPES["train_4k"]'s length, its
# global batch cut), LMT_STEPS AdamW steps timed, then LMT_REPEAT on one
# batch; peak memory against LMT_PEAK_PREDICTED (GiB); model flops over the
# card's fp32 peak FP32_PEAK (TF32 off). (b), (c) granite-3-2b cut to
# LMT_CUT_LAYERS layers; (c), (d) deepseek-moe-16b cut to LMT_MOE_LAYERS
# (LMT_MOE_PARAMS parameters), each trained twice for LMT_REPRO_STEPS steps;
# (e) deepseek-v2-236b at LMT_V2_LAYERS layers, one backward at LMT_V2_SEQ
LMT_B, LMT_SEQ, LMT_STEPS, LMT_REPEAT = 2, 4096, 4, 4
LMT_GRANITE_PARAMS = 2_533_531_648
LMT_PEAK_PREDICTED = (45, 60)
FP32_PEAK = 67e12
LMT_CUT_LAYERS, LMT_REPRO_STEPS = 4, 3
LMT_MOE_LAYERS, LMT_MOE_PARAMS = 4, 2_267_039_744
LMT_V2_LAYERS, LMT_V2_SEQ = 2, 2048
# phases 13 (f) and 14 (f): split-KV decode over SP_SHARDS sequence shards
# on this one card (phase 14: the experts over SP_SHARDS expert shards),
# timed over SP_TIMED steps after SP_WARM; phase 14's expert-parallel MoE
# layer at EP_B x EP_T tokens over a (2, 4) mesh, within EP_TOL
SP_SHARDS, SP_TIMED, SP_WARM = 8, 8, 2
EP_B, EP_T, EP_TOL = 2, 64, 1e-5
# phase 16: gatedgcn FULL at the GNN_TRAINED shapes, GNN_STEPS AdamW steps
# each, GNN_REPEAT more on minibatch_lg's batch, GNN_REPRO_STEPS twice from
# one seed; the edge-sharded loss within GNN_LOSS_TOL, its gradients within
# GNN_GRAD_TOL of the largest (the reference's test_distributed.py:90)
GNN_TRAINED = ("full_graph_sm", "molecule", "minibatch_lg")
GNN_STEPS, GNN_REPEAT, GNN_REPRO_STEPS = 4, 4, 3
GNN_LOSS_TOL, GNN_GRAD_TOL = 1e-5, 1e-4
# phase 17: the sharded LM training state on MESH_SHAPE (data, model) blocks
# of this one card: (a) granite-3-2b cut to MESH_LAYERS layers at MESH_B x
# MESH_SEQ, each forward and backward timed MESH_TIMED times after its
# checked call; (b) deepseek-moe-16b cut to MESH_LAYERS layers at MESH_B x
# MESH_MOE_SEQ; (c) its decode, MESH_DECODE tokens after MESH_PREFILL;
# fp32 within MESH_TOL of the largest, manual_tp within MESH_TP_TOL
MESH_SHAPE, MESH_LAYERS, MESH_B, MESH_SEQ, MESH_MOE_SEQ = (2, 4), 4, 2, 4096, 2048
MESH_PREFILL, MESH_DECODE, MESH_TIMED = 256, 16, 3
MESH_TOL, MESH_TP_TOL = 1e-5, 2e-2
# the widest table row (at m = 48, tau = 3) whose sdim_query fits
# fused_query.cuh's shared memory on the H100; wider rows take the wide path
FUSED_MAX_D = 256


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# the host calls that put one operation on the card; torch.profiler records
# each of them on the host, beside the device operation it starts
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"})


def device_ms(fn, n: int = 20):
    """Device time per call of ``fn`` under torch.profiler over n calls,
    and the device launches it was taken over: (ms, {"seen": device
    operations recorded, "of": launches the host made}). Late in a long run
    the profiler has recorded only some of the launches made back to back
    (4 of 20): then it says so, and the time per call is the recorded
    operations' summed durations over the calls they make up (seen / (of /
    n)), not over n. (None, ...) where it recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e.time_range.end - e.time_range.start for e in events
           if e.device_type == DeviceType.CUDA]
    made = sum(1 for e in events if e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS)
    seen = dict(seen=len(dev), of=made)
    if not dev or sum(dev) <= 0:
        return None, seen
    calls = n * min(1.0, len(dev) / made) if made else n
    if len(dev) < made:
        print(f"device_ms: the profiler recorded {len(dev)} of the {made} device launches of "
              f"{n} calls; the time per call is over the {calls:.4g} calls they make up")
    return sum(dev) / calls / 1e3, seen


def device_times(kernel, plain, library=None) -> dict:
    """``device_ms`` of a kernel, its plain version and the library call (if
    any), each beside the launches it was taken over."""
    out = {}
    for key, fn in (("device", kernel), ("plain_device", plain), ("library_device", library)):
        ms, seen = (None, None) if fn is None else device_ms(fn)
        out[f"{key}_ms"], out[f"{key}_launches"] = ms, seen
    return out


def device_line(dt: dict) -> str:
    """Device times per call of kernel, plain version and library call,
    with the launches each was taken over."""
    def show(key):
        ms, seen = dt[f"{key}_ms"], dt[f"{key}_launches"]
        if ms is None:
            return "not measured"
        return f"{ms:.4f} ms ({seen['seen']} of {seen['of']} launches recorded)"

    parts = [f"device {show('device')}", f"plain {show('plain_device')}"]
    if dt["library_device_launches"] is not None:
        parts.append(f"library {show('library_device')}")
    return ", ".join(parts)


def same_bits(name, fn) -> None:
    """Two launches on the same inputs must agree bit for bit."""
    if not fn().equal(fn()):
        raise AssertionError(f"{name}: two launches on the same inputs differ")


def kernel_spread(torch, fn, n: int = 20) -> dict:
    """Per-launch device times of the sdim_query kernel that fn launches,
    warm (calls back to back) and cold (each call after a 128 MB write,
    more than the card's 50 MB L2), n calls each under torch.profiler:
    ``ms`` [min, median, max] over the kernel events recorded, ``seen`` of
    ``n`` how many it recorded, ``per_call`` every device event's time over
    n (``device_ms``'s figure; the flush's too when cold)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    out = {}
    for label, before in (("warm", lambda: None), ("cold", flush.zero_)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                before()
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ms = sorted((e.time_range.end - e.time_range.start) / 1e3 for e in dev
                    if "query_kernel" in e.name)
        out[label] = dict(ms=[ms[0], ms[len(ms) // 2], ms[-1]] if ms else None, seen=len(ms),
                          of=n, per_call=sum(e.time_range.end - e.time_range.start
                                             for e in dev) / n / 1e3)
    return out


def query_at_call(torch, label, q, table, R, tau, extra=()) -> dict:
    """sdim_query at a path's call: q (B, C, d) against table (B, G, U, d)
    within FP32 of its plain version with the same bits twice (and on each
    (name, q, table) of ``extra``), timed beside its plain version and its
    bound (the rows its queries select), with the kernel's device times:
    under torch.profiler, and ``back_to_back_ms``, CUDA events around 200
    launches in a row over 200 (the kernel's time where it outlasts the
    host's issue of a launch)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.sdim_query.sdim_query import sdim_query, sdim_query_ref

    d = table.shape[-1]
    with uncounted():
        err = 0.0
        for name, qq, tt in ((str(tuple(q.shape)), q, table), *extra):
            err = max(err, check_close(f"sdim_query {label} {name}", sdim_query(qq, tt, R, tau),
                                       sdim_query_ref(qq, tt, R, tau), **FP32))
            same_bits(f"sdim_query {label} {name}", partial(sdim_query, qq, tt, R, tau))
        kernel, plain = (partial(sdim_query, q, table, R, tau),
                         partial(sdim_query_ref, q, table, R, tau))
        k1, p1, p2, k2 = time_ms(kernel), time_ms(plain), time_ms(plain), time_ms(kernel)
        c = cost.settle(cost.query(q, table, R, tau=tau))
        bound_ms, bound_by = bound(c)
        kernel()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(200):
            kernel()
        b.record()
        b.synchronize()
        sel_rows = ((c.bytes - 2 * q.numel() * 4 - R.numel() * 4)
                    / (d * table.element_size()))
        kq = dict(shape=list(q.shape), table=list(table.shape),
                  path="wide" if d > FUSED_MAX_D else "fused", max_abs_err=err,
                  ms=min(k1, k2), plain_ms=min(p1, p2), bound_ms=bound_ms, bound_by=bound_by,
                  library_ms=None, **device_times(kernel, plain),
                  device_spread=kernel_spread(torch, kernel),
                  back_to_back_ms=a.elapsed_time(b) / 200)
    print(f"{label} (d) sdim_query {tuple(q.shape)} x table {tuple(table.shape)} on its "
          f"{kq['path']} path: {kq['ms']:.4f} ms, plain {kq['plain_ms']:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}; the {int(sel_rows)} of "
          f"{table.shape[0] * table.shape[1] * table.shape[2]} table rows its queries "
          f"select), {kq['ms'] / bound_ms:.0f}x the bound; {device_line(kq)}; back to back "
          f"{kq['back_to_back_ms']:.4f} ms a "
          f"launch; the kernel's launches under the profiler "
          f"{json.dumps(kq['device_spread'])}; max abs err {err:.3g}"
          f"{''.join(f', also at {name}' for name, *_ in extra)}; the same bits twice")
    return kq


def bound(c) -> tuple[float, str]:
    """The least time, in ms, the card takes for the work counted in ``c``
    (``kernels.cost.Cost``: fp32 operations and bytes moved): the roofline
    of ``distributed/roofline.py`` (3.35 TB/s HBM, 67 TFLOP/s fp32), and
    which of the two sets it."""
    from repro_torch.distributed import roofline
    r = roofline.analyze("bound", c.flops, c.bytes)
    return 1e3 * r.roofline_time, ("bytes" if r.t_memory >= r.t_compute else "operations")


def check_close(name, out, ref, atol, rtol) -> float:
    import torch
    err = (out.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    if not bool(torch.isfinite(out).all()) or bool((err > limit).any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {float(err.max()):.3g}, atol {atol}, rtol {rtol})")
    return float(err.max())


def kernel_phase(torch, dev, d: int = D):
    """Phase 3 at behavior width ``d`` (m = M, tau = TAU): each kernel
    against its plain version at B = 32 and at every shape the main paths
    give it, the same bits on two launches, then timed at the main path's
    shape: the nine kernels, kernel 6 and its backward also at the folded
    retrieval shape. The five the engine dispatches take their bounds from
    ``kernels/cost.py``, the profiler's counts. Returns each kernel's row
    of the JSON line."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.screen import screened_normal
    from repro_torch.kernels.sdim_bucket.sdim_bucket import (
        bse_encode, bse_encode_cuda, bse_encode_ref)
    from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import (
        sdim_fused_serve, sdim_fused_serve_ref)
    from repro_torch.kernels.sdim_query.sdim_query import sdim_query, sdim_query_ref
    from repro_torch.kernels.sdim_serve.sdim_serve import bse_serve, bse_serve_ref
    from repro_torch.kernels.sdim_update.sdim_update import sdim_update, sdim_update_ref
    from repro_torch.serve.quant import quantize_rows

    rng = np.random.default_rng(0 if d == D else d)
    Rn = rng.standard_normal((M, d)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    R = t(Rn)

    def history(b, l, dtype=torch.float32, masked_user=False):
        """Margin-screened behaviors (b, l, d) with front-padded ragged masks;
        with ``masked_user`` user 1 has every behavior masked."""
        seq = t(screened_normal(rng, (b, l, d), Rn, dtype)).to(dtype)
        lengths = rng.integers(l // 4, l + 1, b)
        if masked_user:
            lengths[1] = 0
        return seq, t((np.arange(l)[None] >= (l - lengths[:, None])).astype(np.float32))

    rows = []
    hash_flop = 2 * M * d + G * d          # per hashed row: projection + bucket add
    at = "" if d == D else f" at d = {d}"

    # bse_encode at B=32 (fp32, bf16), bf16 at the burst with L - 1 rows (at
    # d % 8 == 4 an odd user's rows start off a 16-byte boundary), at the
    # main path's int8 event fold (EV_USERS users, E events), at the burst
    # with a fully masked user (zero table) and at the main path's history
    # burst (BURST users, L behaviors); timed at the burst, at d = D also at
    # 8 and 16 group slices per user.
    err = 0.0
    for b, l, dtype, masked in ((B, L, torch.float32, False), (B, L, torch.bfloat16, False),
                                (BURST, L - 1, torch.bfloat16, False),
                                (EV_USERS, E, torch.float32, False),
                                (BURST, L, torch.float32, True),
                                (BURST, L, torch.float32, False)):
        seq, mask = history(b, l, dtype, masked)
        out = bse_encode(seq, mask, R, TAU)
        err = max(err, check_close(f"bse_encode {(b, l, d)} {dtype}", out,
                                   bse_encode_ref(seq, mask, R, TAU), **ATOMIC))
        if masked and bool(out[1].any()):
            raise AssertionError("bse_encode: a fully masked user has a non-zero table")
    same_bits("bse_encode", partial(bse_encode, seq, mask, R, TAU))
    for splits in (8, 16) if d == D else ():
        fn = partial(bse_encode_cuda, seq, mask, R, TAU, splits)
        check_close(f"bse_encode, {splits} group slices", fn(),
                    bse_encode_ref(seq, mask, R, TAU), **ATOMIC)
        k1, k2, (dev_ms, seen) = time_ms(fn), time_ms(fn), device_ms(fn)
        print(f"bse_encode at {splits} group slices per user ({BURST * splits} CTAs): "
              f"{min(k1, k2):.4f} ms (runs {k1:.4f}/{k2:.4f}), device {dev_ms} ms "
              f"({seen['seen']} of {seen['of']} launches recorded)")
    rows.append(("bse_encode", "src/repro_torch/kernels/sdim_bucket/csrc/bse_encode.cu",
                 "src/repro/kernels/sdim_bucket/sdim_bucket.py:117", err,
                 partial(bse_encode, seq, mask, R, TAU),
                 partial(bse_encode_ref, seq, mask, R, TAU),
                 bound(cost.encode(seq, mask, R, tau=TAU)), None))

    # sdim_query (unfused decoupled path: bf16 wire tables, and fp32) at
    # B=32 with a fully masked user (a zero table, read as zero) and at the
    # main path's burst; timed at the burst
    err = 0.0
    for b in (B, BURST):
        table = bse_encode_ref(*history(b, L, masked_user=b == B), R, TAU)
        wire = table.to(torch.bfloat16)
        q = t(screened_normal(rng, (b, C, d), Rn))
        for tb in (wire, table):
            out = sdim_query(q, tb, R, TAU)
            err = max(err, check_close(f"sdim_query {(b, C, d)} {tb.dtype}", out,
                                       sdim_query_ref(q, tb, R, TAU), **FP32))
            if b == B and bool(out[1].any()):
                raise AssertionError("sdim_query: a zero table read non-zero interest")
    for tb in (wire, table):
        same_bits(f"sdim_query {tb.dtype}", partial(sdim_query, q, tb, R, TAU))
    rows.append(("sdim_query", "src/repro_torch/kernels/sdim_query/csrc/sdim_query.cu",
                 "src/repro/kernels/sdim_query/sdim_query.py:52", err,
                 partial(sdim_query, q, wire, R, TAU),
                 partial(sdim_query_ref, q, wire, R, TAU),
                 bound(cost.query(q, wire, R, tau=TAU)), None))

    # sdim_fused_serve (fused path): fp32 / bf16 / int8 / fp8 stores at B=32
    # with a ragged present; fp32 / int8 / fp8 at the main path's burst,
    # every user present, user 1's history fully masked (a zero row); timed
    # at the burst on the fp32 store, the int8 store's time printed beside
    errs = {}
    for b, ragged in ((B, True), (BURST, False)):
        table = bse_encode_ref(*history(b, L, masked_user=not ragged), R, TAU)
        q = t(screened_normal(rng, (b, C, d), Rn))
        store = torch.cat([table, torch.zeros_like(table)])
        slots = torch.randperm(2 * b, generator=torch.Generator().manual_seed(b))[:b].to(
            dev, torch.int32)
        present = torch.ones(b, device=dev)
        if ragged:
            present[3::4] = 0
        stores = [("fp32", store, None), ("int8", *quantize_rows(store, dtype=torch.int8)),
                  ("fp8", *quantize_rows(store, dtype=torch.float8_e4m3fn))]
        if ragged:
            stores.insert(1, ("bf16", store.to(torch.bfloat16), None))
        for name, st, sc in stores:
            errs[name] = max(errs.get(name, 0.0), check_close(
                f"sdim_fused_serve {(b, C, d)} {name}",
                sdim_fused_serve(st, slots, q, R, TAU, scales=sc, present=present),
                sdim_fused_serve_ref(st, slots, q, R, TAU, scales=sc, present=present),
                **FP32))
    print(f"sdim_fused_serve max abs err by store dtype: {json.dumps(errs)}")
    for name, st, sc in stores:
        same_bits(f"sdim_fused_serve {name}",
                  partial(sdim_fused_serve, st, slots, q, R, TAU, scales=sc, present=present))
    _, st, sc = stores[1]
    fn = partial(sdim_fused_serve, st, slots, q, R, TAU, scales=sc, present=present)
    k1, k2 = time_ms(fn), time_ms(fn)
    dev_ms, seen = device_ms(fn)
    print(f"sdim_fused_serve{at}, int8 store: {min(k1, k2):.4f} ms (runs {k1:.4f}/{k2:.4f}), "
          f"device {dev_ms} ms ({seen['seen']} of {seen['of']} launches recorded)")
    rows.append(("sdim_fused_serve",
                 "src/repro_torch/kernels/sdim_fused_serve/csrc/sdim_fused_serve.cu",
                 "src/repro/kernels/sdim_fused_serve/sdim_fused_serve.py:86", max(errs.values()),
                 partial(sdim_fused_serve, store, slots, q, R, TAU, present=present),
                 partial(sdim_fused_serve_ref, store, slots, q, R, TAU, present=present),
                 bound(cost.serve_fused(store, slots, q, R, tau=TAU, present=present)), None))

    # sdim_update (event ingest, the main path's EV_USERS x E burst): bf16
    # events with E = 5 (at d % 8 == 4 rows on 8-byte boundaries), a
    # duplicate-heavy burst (every row on one of two slots), then
    # duplicate slots and a zero-mask row at slot 0; timed on the latter
    ev5 = t(screened_normal(rng, (EV_USERS, 5, d), Rn, torch.bfloat16)).to(torch.bfloat16)
    mask5 = t((rng.random((EV_USERS, 5)) > 0.2).astype(np.float32))
    events = t(screened_normal(rng, (EV_USERS, E, d), Rn))
    ev_mask = t((rng.random((EV_USERS, E)) > 0.2).astype(np.float32))
    ev_mask[0] = 0
    ev_slots = torch.tensor(np.r_[0, rng.integers(1, EV_USERS // 2, EV_USERS - 1)],
                            dtype=torch.int32, device=dev)
    two_slots = torch.tensor(np.where(rng.random(EV_USERS) > 0.5, 3, 5), dtype=torch.int32,
                             device=dev)
    base = torch.randn((2 * EV_USERS, G, U, d), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(d))
    err = 0.0
    for name, sl, ev, em in (("bf16, E = 5", ev_slots, ev5, mask5),
                             ("two slots", two_slots, events, ev_mask),
                             ("duplicate slots", ev_slots, events, ev_mask)):
        a, b = base.clone(), base.clone()
        sdim_update(a, sl, ev, em, R, TAU)
        sdim_update_ref(b, sl, ev, em, R, TAU)
        err = max(err, check_close(f"sdim_update d = {d}, {name}", a, b, **FP32))
    if not torch.equal(a[0], base[0]):
        raise AssertionError("sdim_update: a zero-mask row at slot 0 wrote to slot 0")
    for ev, em in ((ev5, mask5), (events, ev_mask)):
        same_bits("sdim_update", lambda: sdim_update(base.clone(), ev_slots, ev, em, R, TAU))
    rows.append(("sdim_update", "src/repro_torch/kernels/sdim_update/csrc/sdim_update.cu",
                 "src/repro/kernels/sdim_update/sdim_update.py:77", err,
                 partial(sdim_update, a, ev_slots, events, ev_mask, R, TAU),
                 partial(sdim_update_ref, b, ev_slots, events, ev_mask, R, TAU),
                 bound(cost.update(a, ev_slots, events, ev_mask, R, tau=TAU)), None))

    # bse_serve (inline path): B=32 and the main path's burst in fp32 and
    # bf16, then a burst with C=100 and a fully masked user (zero output);
    # timed at the burst in fp32, the main path's dtype
    err = 0.0
    for b, c, dtype, masked in ((B, C, torch.float32, False), (B, C, torch.bfloat16, False),
                                (BURST, C, torch.bfloat16, False),
                                (BURST, 100, torch.float32, True),
                                (BURST, C, torch.float32, False)):
        seq, mask = history(b, L, dtype, masked)
        q = t(screened_normal(rng, (b, c, d), Rn))
        out = bse_serve(q, seq, mask, R, TAU)
        err = max(err, check_close(f"bse_serve {(b, L, c, d)} {dtype}", out,
                                   bse_serve_ref(q, seq, mask, R, TAU), **FP32))
        if masked and bool(out[1].any()):
            raise AssertionError("bse_serve: a fully masked user read non-zero interest")
    same_bits("bse_serve", partial(bse_serve, q, seq, mask, R, TAU))
    rows.append(("bse_serve", "src/repro_torch/kernels/sdim_serve/csrc/bse_serve.cu",
                 "src/repro/kernels/sdim_serve/sdim_serve.py:68", err,
                 partial(bse_serve, q, seq, mask, R, TAU),
                 partial(bse_serve_ref, q, seq, mask, R, TAU),
                 bound(cost.serve(q, seq, mask, R, tau=TAU)), None))
    rows.append(target_row(torch, dev, history, d))
    rows += backward_rows(torch, dev, rng, t, Rn, R, history, hash_flop, d)

    timed = []
    for name, source, replaces, err, kernel, plain, (bound_ms, bound_by), library in rows:
        # kernel, plain, plain, kernel: both seen under the same clocks
        k1, p1, p2, k2 = time_ms(kernel), time_ms(plain), time_ms(plain), time_ms(kernel)
        lib_ms = None if library is None else time_ms(library)
        dt = device_times(kernel, plain, library)
        timed.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                          max_abs_err=err, ms=min(k1, k2), plain_ms=min(p1, p2),
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms, **dt))
        print(f"kernel {name}{at}: {min(k1, k2):.4f} ms (runs {k1:.4f}/{k2:.4f}), plain "
              f"{min(p1, p2):.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; {device_line(dt)}; "
              f"max abs err {err:.3g}")
    folded = folded_retrieval(torch, dev, rng, t, d)
    for k in timed:
        if k["name"] in folded:
            k["folded"] = folded[k["name"]]
    return timed


def target_row(torch, dev, history, d):
    """Phase 3's row of target_attention_flash at width ``d``."""
    import torch.nn.functional as F
    from repro_torch.kernels.cost import Cost
    from repro_torch.kernels.target_attn.target_attn import (
        target_attention_flash, target_attention_flash_ref)

    # target_attention_flash (target path): B=32 in fp32 and bf16, the burst
    # with L=1000, C=100 and a fully masked user (uniform over all L rows),
    # then the main path's burst; timed there. library_ms: PyTorch's
    # scaled_dot_product_attention on the same inputs with an additive
    # 0 / -1e30 mask, in fp32 (never called by the port)
    err = 0.0
    for b, c, l, dtype, masked in ((B, C, L, torch.float32, False),
                                   (B, C, L, torch.bfloat16, False),
                                   (BURST, 100, 1000, torch.float32, True),
                                   (BURST, C, L, torch.float32, False)):
        seq, mask = history(b, l, dtype, masked)
        q = torch.randn((b, c, d), generator=torch.Generator(device=dev).manual_seed(c),
                        device=dev)
        err = max(err, check_close(f"target_attention_flash {(b, l, c, d)} {dtype}",
                                   target_attention_flash(q, seq, mask),
                                   target_attention_flash_ref(q, seq, mask), **FP32))
    same_bits("target_attention_flash", partial(target_attention_flash, q, seq, mask))
    additive = torch.where(mask > 0, 0.0, -1e30)[:, None, :]
    library = partial(F.scaled_dot_product_attention, q, seq, seq, attn_mask=additive)
    print(f"target attention: |sdpa - plain| max "
          f"{float((library() - target_attention_flash_ref(q, seq, mask)).abs().max()):.3g}")
    # a user with a valid row needs only its valid rows (masked ones weigh
    # exactly 0); a fully masked user needs all L
    needed = float(sum(L if n == 0 else n for n in mask.sum(1).tolist()))
    return ("target_attention_flash", "src/repro_torch/kernels/target_attn/csrc/target_attn.cu",
            "src/repro/kernels/target_attn/target_attn.py:59", err,
            partial(target_attention_flash, q, seq, mask),
            partial(target_attention_flash_ref, q, seq, mask),
            bound(Cost(flops=4 * C * d * needed,
                       bytes=needed * d * 4 + mask.numel() * 4 + 2 * q.numel() * 4)),
            library)


def folded_retrieval(torch, dev, rng, t, d):
    """target_attention_flash and its backward at the retrieval kinds'
    folded shape at width d: BURST * C users of one candidate each over the FOLD_L
    rows it retrieved, valid rows first (top-k order), some with fewer and
    some with none (uniform over all FOLD_L). Held against the plain
    versions, same bits on two launches, timed like the rows above (SDPA
    on the same inputs as the forward's yardstick). Returns {kernel name:
    its numbers at this shape}."""
    import torch.nn.functional as F
    from repro_torch.kernels.cost import Cost
    from repro_torch.kernels.target_attn.target_attn import (
        target_attention_flash, target_attention_flash_backward,
        target_attention_flash_backward_ref, target_attention_flash_ref)

    n, l = BURST * C, FOLD_L
    f32 = lambda *shape: t(rng.standard_normal(shape).astype(np.float32))
    q, seq, dout = f32(n, 1, d), f32(n, l, d), f32(n, 1, d)
    found = rng.integers(0, l + 1, n)
    found[:2] = (0, l)
    mask = t((np.arange(l)[None] < found[:, None]).astype(np.float32))
    out = target_attention_flash(q, seq, mask)
    err_f = check_close(f"target_attention_flash folded {(n, l, 1, d)}", out,
                        target_attention_flash_ref(q, seq, mask), **FP32)
    got = target_attention_flash_backward(dout, q, seq, mask, out)
    ref = target_attention_flash_backward_ref(dout, q, seq, mask, out)
    err_b = max(check_close(f"target_attention_flash_backward folded {name}", a, b, **FP32)
                for name, a, b in (("dq", got[0], ref[0]), ("dseq", got[1], ref[1])))
    fwd = partial(target_attention_flash, q, seq, mask)
    bwd = partial(target_attention_flash_backward, dout, q, seq, mask, out)
    same_bits("target_attention_flash folded", fwd)
    same_bits("target_attention_flash_backward folded",
              lambda: torch.cat([g.reshape(-1) for g in bwd()]))
    needed = float(sum(l if f == 0 else f for f in found.tolist()))
    additive = torch.where(mask > 0, 0.0, -1e30)[:, None, :]
    cases = (("target_attention_flash", fwd, partial(target_attention_flash_ref, q, seq, mask),
              err_f, bound(Cost(flops=4 * d * needed,
                                bytes=needed * d * 4 + mask.numel() * 4 + 2 * q.numel() * 4)),
              partial(F.scaled_dot_product_attention, q, seq, seq, attn_mask=additive)),
             ("target_attention_flash_backward", bwd,
              partial(target_attention_flash_backward_ref, dout, q, seq, mask, out), err_b,
              bound(Cost(flops=10 * d * needed,
                         bytes=needed * d * 4 + seq.numel() * 4 + mask.numel() * 4
                         + 5 * q.numel() * 4)), None))
    info = {}
    for name, kernel, plain, err, (bound_ms, bound_by), library in cases:
        k1, p1, p2, k2 = time_ms(kernel), time_ms(plain), time_ms(plain), time_ms(kernel)
        lib_ms = None if library is None else time_ms(library)
        dt = device_times(kernel, plain, library)
        info[name] = dict(shape=dict(users=n, L=l, C=1, d=d), ms=min(k1, k2),
                          plain_ms=min(p1, p2), bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib_ms, max_abs_err=err, **dt)
        print(f"kernel {name} at the folded retrieval shape ({n} users, L={l}, C=1, d={d}): "
              f"{min(k1, k2):.4f} ms (runs {k1:.4f}/{k2:.4f}), plain {min(p1, p2):.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; {device_line(dt)}; "
              f"max abs err {err:.3g}")
    return info


def backward_rows(torch, dev, rng, t, Rn, R, history, hash_flop, d):
    """Phase 3 for the three backward kernels (no TPU kernel corresponds to
    them: the JAX package differentiates the XLA formulation), at width d,
    at the training step's shapes (B = TRAIN_B users, L, C = 1) and at C,
    against their closed-form plain versions; each timed at the training
    shape. ``history`` is kernel_phase's maker of screened, ragged
    behaviors."""
    from repro_torch.kernels.cost import Cost
    from repro_torch.kernels.screen import screened_normal
    from repro_torch.kernels.sdim_bucket import sdim_bucket as kb
    from repro_torch.kernels.sdim_query import sdim_query as kq
    from repro_torch.kernels.target_attn import target_attn as kt

    k = {**vars(kb), **vars(kq), **vars(kt)}

    rows = []
    gen = torch.Generator(device=dev).manual_seed(11)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)

    # bse_encode_backward: fp32 and bf16 behaviors, a fully masked user,
    # L = 0; timed on fp32 behaviors with ragged front-padded masks
    err, dT = 0.0, randn(TRAIN_B, G, U, d)
    for dtype, masked in ((torch.bfloat16, False), (torch.float32, True),
                          (torch.float32, False)):
        seq, mask = history(TRAIN_B, L, dtype, masked)
        out = k["bse_encode_backward"](dT, seq, mask, R, TAU)
        err = max(err, check_close(f"bse_encode_backward {(TRAIN_B, L, d)} {dtype}", out,
                                   k["bse_encode_backward_ref"](dT, seq, mask, R, TAU),
                                   **(FP32 if dtype == torch.float32 else BF16_OUT)))
        if masked and bool(out[1].any()):
            raise AssertionError("bse_encode_backward: a fully masked user got a gradient")
    empty = k["bse_encode_backward"](dT, seq[:, :0].contiguous(), mask[:, :0].contiguous(), R, TAU)
    if empty.shape != (TRAIN_B, 0, d):
        raise AssertionError(f"bse_encode_backward at L = 0: shape {tuple(empty.shape)}")
    same_bits("bse_encode_backward", partial(k["bse_encode_backward"], dT, seq, mask, R, TAU))
    valid = float(mask.sum())
    rows.append(("bse_encode_backward",
                 "src/repro_torch/kernels/sdim_bucket/csrc/bse_encode_backward.cu",
                 "none (gradient of src/repro/kernels/sdim_bucket/sdim_bucket.py:117)", err,
                 partial(k["bse_encode_backward"], dT, seq, mask, R, TAU),
                 partial(k["bse_encode_backward_ref"], dT, seq, mask, R, TAU),
                 bound(Cost(flops=valid * (hash_flop + d),
                            bytes=valid * d * 4 + seq.numel() * 4 + mask.numel() * 4
                            + R.numel() * 4 + dT.numel() * 4)), None))

    # sdim_query_backward: C = 1 (the training step) and C = 128, a fully
    # masked user (a zero table: its gradient is g / 1e-6, so the rows are
    # compared times their n = sqrt(|t|^2 + 1e-12)), C = 0 (zero, every row
    # written); timed at C = 1
    err = 0.0
    table = k["bse_encode_ref"](*history(TRAIN_B, L, masked_user=True), R, TAU)
    n = torch.sqrt(torch.sum(table * table, -1, keepdim=True) + 1e-12)
    for c in (C, 0, 1):
        q = t(screened_normal(rng, (TRAIN_B, c, d), Rn))
        dout = randn(TRAIN_B, c, d)
        out = k["sdim_query_backward"](dout, q, table, R, TAU)
        err = max(err, check_close(f"sdim_query_backward {(TRAIN_B, c, d)} (times n)", out * n,
                                   k["sdim_query_backward_ref"](dout, q, table, R, TAU) * n,
                                   **FP32))
        if c == 0 and bool(out.any()):
            raise AssertionError("sdim_query_backward: no candidate, yet a gradient")
    same_bits("sdim_query_backward", partial(k["sdim_query_backward"], dout, q, table, R, TAU))
    rows.append(("sdim_query_backward",
                 "src/repro_torch/kernels/sdim_query/csrc/sdim_query_backward.cu",
                 "none (gradient of src/repro/kernels/sdim_query/sdim_query.py:52)", err,
                 partial(k["sdim_query_backward"], dout, q, table, R, TAU),
                 partial(k["sdim_query_backward_ref"], dout, q, table, R, TAU),
                 bound(Cost(flops=TRAIN_B * hash_flop + TRAIN_B * G * U * 8 * d,
                            bytes=2 * q.numel() * 4 + 2 * table.numel() * 4
                            + R.numel() * 4)), None))

    # target_attention_flash_backward: C = 1 and C = 128 in fp32, bf16
    # behaviors, a fully masked user (uniform weights), C = 0 and L = 0;
    # timed at C = 1 in fp32
    err = 0.0
    for c, dtype, masked in ((C, torch.float32, False), (1, torch.bfloat16, False),
                             (1, torch.float32, True), (1, torch.float32, False)):
        seq, mask = history(TRAIN_B, L, dtype, masked)
        q, dout = randn(TRAIN_B, c, d), randn(TRAIN_B, c, d)
        out = k["target_attention_flash"](q, seq, mask)
        got = k["target_attention_flash_backward"](dout, q, seq, mask, out)
        ref = k["target_attention_flash_backward_ref"](dout, q, seq, mask, out)
        for name, a, b in (("dq", got[0], ref[0]), ("dseq", got[1], ref[1])):
            err = max(err, check_close(f"target_attention_flash_backward {name} "
                                       f"{(TRAIN_B, L, c, d)} {dtype}", a, b,
                                       **(FP32 if a.dtype == torch.float32 else BF16_OUT)))
        if masked and bool(got[0][1].any()):
            raise AssertionError("target_attention_flash_backward: a fully masked user's "
                                 "candidate got a gradient")
    for qq, ss, mm in ((q[:, :0], seq, mask), (q, seq[:, :0], mask[:, :0])):
        qq, ss, mm = qq.contiguous(), ss.contiguous(), mm.contiguous()
        got = k["target_attention_flash_backward"](qq, qq, ss, mm, qq)
        if got[0].any() or got[1].any() or got[1].shape != ss.shape:
            raise AssertionError("target_attention_flash_backward: C = 0 or L = 0 wrong")
    fn = partial(k["target_attention_flash_backward"], dout, q, seq, mask, out)
    same_bits("target_attention_flash_backward", lambda: torch.cat([g.reshape(-1) for g in fn()]))
    needed = float(sum(L if n == 0 else n for n in mask.sum(1).tolist()))
    rows.append(("target_attention_flash_backward",
                 "src/repro_torch/kernels/target_attn/csrc/target_attn_backward.cu",
                 "none (gradient of src/repro/kernels/target_attn/target_attn.py:59)", err, fn,
                 partial(k["target_attention_flash_backward_ref"], dout, q, seq, mask, out),
                 bound(Cost(flops=10 * d * needed,
                            bytes=needed * d * 4 + seq.numel() * 4 + mask.numel() * 4
                            + 5 * q.numel() * 4)), None))
    return rows


def request_stream(n_requests: int, cfg):
    from repro_torch.data.synthetic import SyntheticCTRConfig, generate_batch

    dcfg = SyntheticCTRConfig(hist_len=cfg.long_len, n_items=cfg.n_items, n_cats=cfg.n_cats)
    rng = np.random.default_rng(0)
    out = []
    for r in range(n_requests):
        raw = generate_batch(dcfg, 1, r)
        user = {k: v for k, v in raw.items() if k.startswith("hist")}
        ci = rng.integers(0, cfg.n_items, C).astype(np.int32)
        cc = rng.integers(0, cfg.n_cats, C).astype(np.int32)
        out.append((f"u{r}", user, ci, cc, np.zeros((C, cfg.ctx_dim), np.float32)))
    return out


def serve_all(torch, name, srv, requests, wrappers, times=None):
    """Serve ``requests`` in bursts of BURST; returns the (n, C) scores and
    each kernel's launches per burst. ``times``, a list, gets each burst's
    ms/request (the server's own clock)."""
    before = {w.__name__: w.launches for w in wrappers}
    srv.stats = type(srv.stats)()
    out = []
    for i in range(0, len(requests), BURST):
        spent = srv.stats.total_time_s
        out.extend(srv.handle_requests(requests[i:i + BURST]))
        if times is not None:
            times.append(1e3 * (srv.stats.total_time_s - spent) / len(requests[i:i + BURST]))
    torch.cuda.synchronize()
    scores = np.stack(out)
    if scores.shape != (len(requests), C) or not np.isfinite(scores).all():
        raise AssertionError(f"scores {name}: shape {scores.shape}, "
                             f"finite {np.isfinite(scores).all()}")
    per_burst = {w.__name__: (w.launches - before[w.__name__]) / (len(requests) // BURST)
                 for w in wrappers}
    print(f"serve {name}: {srv.stats.ms_per_request:.3f} ms/request over "
          f"{srv.stats.n_requests} requests, launches per {BURST}-request burst "
          f"{json.dumps(per_burst)}")
    return scores, per_burst


def profile_window(torch, label, fn):
    """``fn()`` once under torch.profiler: the share of its wall time in
    which the card ran a kernel (the union of the device events' intervals
    over the host clock around it) and the five device operations that took
    the most time. Launches made here are not counted: the path's counts
    were read before."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    if not spans:
        print(f"profiler {label}: no device time (not measured); wall {wall_us / 1e3:.3f} ms")
        return None
    busy, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"profiler {label}: wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
          f"{len(spans)} device ops; top 5 by device time:")
    for name, us in top:
        print(f"  {us / 1e3:8.4f} ms  {100 * us / wall_us:5.1f}%  {name[:100]}")
    return dict(device_ops=len(spans), busy_ms=busy / 1e3, wall_ms=wall_us / 1e3)


def profile_burst(torch, path, srv, burst):
    """One steady burst of ``path`` under torch.profiler (profile_window)."""
    profile_window(torch, f"{path}, burst of {len(burst)} requests",
                   partial(srv.handle_requests, burst))


def read_launches(wrappers, own, path):
    """The launch counts after a path; fails if one of its kernels ``own``
    never launched."""
    launches = {w.__name__: w.launches for w in wrappers}
    missing = [k for k in own if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: {missing}")
    print(f"{path} path launches: {json.dumps(launches)}")
    return launches


def reset(wrappers):
    for w in wrappers:
        w.launches = 0


def all_wrappers():
    """Every kernel wrapper: the six forward kernels, then the three
    backward kernels."""
    from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode, bse_encode_backward
    from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import sdim_fused_serve
    from repro_torch.kernels.sdim_query.sdim_query import sdim_query, sdim_query_backward
    from repro_torch.kernels.sdim_serve.sdim_serve import bse_serve
    from repro_torch.kernels.sdim_update.sdim_update import sdim_update
    from repro_torch.kernels.target_attn.target_attn import (target_attention_flash,
                                                             target_attention_flash_backward)
    return (bse_encode, sdim_update, sdim_fused_serve, sdim_query, bse_serve,
            target_attention_flash, bse_encode_backward, sdim_query_backward,
            target_attention_flash_backward)


class uncounted:
    """Within the block, kernel launches are not counted: a comparison of a
    kernel with its plain version is no launch of the path."""

    def __enter__(self):
        self.saved = [(w, w.launches) for w in all_wrappers()]

    def __exit__(self, *exc):
        for w, n in self.saved:
            w.launches = n


def decoupled_phase(torch, dev, wrappers, model, requests):
    from repro_torch.serve.ctr_server import CTRServer

    cfg = model.cfg
    servers = {
        "unfused": CTRServer.build(model, None, "decoupled", device=dev),
        "fused": CTRServer.build(model, None, "decoupled", fused=True, device=dev),
        "fused-int8": CTRServer.build(model, None, "decoupled", fused=True,
                                      table_dtype="int8", device=dev),
    }
    ev_rng = np.random.default_rng(1)
    ev_users = [f"u{u}" for u in ev_rng.integers(0, len(requests), EV_USERS)]
    ev_items = ev_rng.integers(0, cfg.n_items, (EV_USERS, E)).astype(np.int32)
    ev_cats = ev_rng.integers(0, cfg.n_cats, (EV_USERS, E)).astype(np.int32)

    reset(wrappers)
    scores = {}
    for rnd in ("before events", "after events"):
        if rnd == "after events":
            for srv in servers.values():
                srv.bse.ingest_events(ev_users, ev_items, ev_cats)
        for name, srv in servers.items():
            scores[(rnd, name)], _ = serve_all(torch, f"{name} ({rnd})", srv, requests,
                                               wrappers)
    launches = read_launches(wrappers, ("bse_encode", "sdim_update", "sdim_fused_serve",
                                        "sdim_query"), "decoupled")
    profile_burst(torch, "decoupled fused", servers["fused"], requests[:BURST])

    for rnd in ("before events", "after events"):
        for name in ("fused", "fused-int8"):
            diff = float(np.abs(scores[(rnd, name)] - scores[(rnd, "unfused")]).max())
            print(f"|{name} - unfused| max ({rnd}): {diff:.3g}")
            if diff > WIRE_TOL:
                raise AssertionError(f"{name} vs unfused scores differ by {diff} ({rnd})")
    moved = float(np.abs(scores[("after events", "fused")]
                         - scores[("before events", "fused")]).max())
    if moved == 0.0:
        raise AssertionError("the event burst changed no score")
    return launches, scores[("before events", "unfused")]


def inline_phase(torch, dev, wrappers, model, requests, bf16_wire_scores):
    from repro_torch.serve.ctr_server import CTRServer

    inline = CTRServer.build(model, None, "inline", device=dev)
    fp32_wire = CTRServer.build(model, None, "decoupled", wire_dtype=torch.float32, device=dev)
    reset(wrappers)
    scores, per_burst = serve_all(torch, "inline", inline, requests, wrappers)
    launches = read_launches(wrappers, ("bse_serve",), "inline")
    profile_burst(torch, "inline", inline, requests[:BURST])
    if per_burst["bse_serve"] != 1 or sum(per_burst.values()) != 1:
        raise AssertionError(f"inline serving launched {per_burst} per burst, "
                             f"not one bse_serve")
    ref, _ = serve_all(torch, "decoupled, fp32 wire", fp32_wire, requests, wrappers)
    for name, other, tol in (("decoupled fp32 wire", ref, INLINE_TOL),
                             ("decoupled bf16 wire", bf16_wire_scores, WIRE_TOL)):
        diff = float(np.abs(scores - other).max())
        print(f"|inline - {name}| max: {diff:.3g}")
        if diff > tol:
            raise AssertionError(f"inline vs {name} scores differ by {diff} (> {tol})")
    return launches


def target_phase(torch, dev, wrappers, requests):
    from repro_torch.configs import sdim_paper
    from repro_torch.kernels.target_attn.target_attn import target_attention_flash_ref
    from repro_torch.models.ctr import CTRModel
    from repro_torch.serve.ctr_server import CTRServer

    full = sdim_paper.FULL
    cfg = dataclasses.replace(full, interest=dataclasses.replace(full.interest, kind="target"))
    model = CTRModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    server = CTRServer.build(model, None, "target_attention", device=dev)
    reset(wrappers)
    _, per_burst = serve_all(torch, "target_attention", server, requests, wrappers)
    launches = read_launches(wrappers, ("target_attention_flash",), "target")
    profile_burst(torch, "target_attention", server, requests[:BURST])
    if per_burst["target_attention_flash"] != 1 or sum(per_burst.values()) != 1:
        raise AssertionError(f"target-attention serving launched {per_burst} per burst, "
                             f"not one target_attention_flash")

    # the first burst's long branch through the kernel against the plain
    # version (after the counts were read: a comparison is no path launch)
    first = requests[:BURST]
    hist = lambda k: torch.as_tensor(np.concatenate([r[1][k] for r in first]), device=dev)
    cand = lambda i: torch.as_tensor(np.stack([r[i] for r in first]), device=dev)
    with torch.no_grad():
        target_e = model._embed_behaviors(cand(2), cand(3))
        long_e = model._embed_behaviors(hist("hist_items"), hist("hist_cats"))
        mask = hist("hist_mask")
        err = check_close("target long branch", model.interest(target_e, long_e, mask),
                          target_attention_flash_ref(target_e, long_e, mask), **FP32)
    print(f"target long branch, first burst: max abs err {err:.3g} against the plain version")
    return launches


def plain_long_branch(model, refs):
    """Within the block, ``model``'s long branch runs the kernels' plain
    PyTorch versions on the card (``refs``: bse_encode_ref, sdim_query_ref,
    target_attention_flash_ref), autograd of plain PyTorch giving their
    gradients; everything else is the model's own code. The retrieval
    kinds keep their own top-k and gather and attend through
    target_attention_flash_ref; a kind with no kernel runs as it is."""
    import contextlib

    from repro_torch.core import retrieval

    interest = model.interest
    kind, tau = interest.cfg.kind, interest.cfg.tau

    def forward(q, seq, mask, **_):
        single = q.ndim == 2
        qc = (q[:, None, :] if single else q).float()
        if kind == "sdim":
            table = refs["bse_encode_ref"](seq, mask.float(), interest.R, tau)
            out = refs["sdim_query_ref"](qc, table, interest.R, tau)
        else:
            out = refs["target_attention_flash_ref"](qc, seq, mask.float())
        return (out[:, 0] if single else out).to(seq.dtype)

    @contextlib.contextmanager
    def swapped():
        if kind in ("sdim", "target"):
            interest.forward = forward      # nn.Module.__call__ reads self.forward
        kernel = retrieval.target_attention_flash
        retrieval.target_attention_flash = refs["target_attention_flash_ref"]
        try:
            yield
        finally:
            retrieval.target_attention_flash = kernel
            if kind in ("sdim", "target"):
                del interest.forward

    return swapped()


def plain_refs() -> dict:
    """The plain versions ``plain_long_branch`` swaps in."""
    from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode_ref
    from repro_torch.kernels.sdim_query.sdim_query import sdim_query_ref
    from repro_torch.kernels.target_attn.target_attn import target_attention_flash_ref

    return dict(bse_encode_ref=bse_encode_ref, sdim_query_ref=sdim_query_ref,
                target_attention_flash_ref=target_attention_flash_ref)


def step1_gradients(torch, model, batch, refs, label, finite=True):
    """Step 1's gradients through the kernels against the same step
    through the plain versions on the card: max |difference| over the
    parameter's largest gradient, at most GRAD_TOL. With ``finite=False``
    (sdim_expected, ROADMAP.md C2) non-finite gradients are counted and
    printed instead of failing; they must sit at the same places."""
    grads = {}
    for path in ("kernels", "plain"):
        model.zero_grad(set_to_none=True)
        if path == "kernels":
            with uncounted():
                model.loss(batch)[0].backward()
        else:
            with plain_long_branch(model, refs):
                model.loss(batch)[0].backward()
        grads[path] = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    worst = 0.0
    for n, g in grads["kernels"].items():
        ref = grads["plain"][n]
        if g is None or ref is None:        # ubr4ctr's projections only choose rows
            if g is not None or ref is not None:
                raise AssertionError(f"{label}: {n} has a gradient in one path only")
            print(f"  {label} step-1 gradient {n}: none in either path (jax.grad gives "
                  f"exactly 0)")
            continue
        ok = torch.isfinite(ref)
        if not bool(torch.equal(torch.isfinite(g), ok)):
            raise AssertionError(f"{label}: the kernel and plain gradients of {n} are "
                                 f"non-finite at different places")
        if not bool(ok.all()):
            if finite:
                raise AssertionError(f"{label}: non-finite gradient of {n}")
            print(f"  {label} step-1 gradient {n}: {int((~ok).sum())} of {ok.numel()} entries "
                  f"non-finite in both paths (ROADMAP.md C2)")
            g, ref = g[ok], ref[ok]
        if ref.numel() == 0:
            continue
        rel = float((g - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        print(f"  {label} step-1 gradient {n}: max |kernel - plain| / max |plain| "
              f"{rel:.3g} (largest {float(ref.abs().max()):.3g})")
        worst = max(worst, rel)
    if worst > GRAD_TOL:
        raise AssertionError(f"{label}: kernel gradients differ from the plain versions' "
                             f"by {worst:.3g} of the largest (> {GRAD_TOL})")


def train_phase(torch, dev, wrappers):
    """Phase 7: train sdim-paper FULL (kind sdim, then kind target) through
    ``make_train_step`` with the launcher's recsys settings (Adagrad lr
    0.05, clip 10, batches of ``generate_batch_graded`` from the port's
    ``DeterministicStream``). Returns the launch counts of the phase."""
    import tempfile

    from repro_torch.configs import sdim_paper
    from repro_torch.kernels.screen import hashed_behaviors, item_rows_clear, screen_item_rows
    from repro_torch.launch.train import recsys_setup
    from repro_torch.models.ctr import CTRModel
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.loop import make_train_step

    refs = plain_refs()
    full = sdim_paper.FULL
    loss_fn, stream, opt = recsys_setup(full, TRAIN_B)
    t0 = time.perf_counter()
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in next(stream).items()}
               for _ in range(TRAIN_STEPS + 1)]
    print(f"train: {len(batches)} batches of {TRAIN_B} from generate_batch_graded "
          f"({full.n_items} items) in {time.perf_counter() - t0:.1f} s")

    def train(model, steps, label):
        init, step = make_train_step(loss_fn, opt)
        state, losses, times = init(model), [], []
        for i in range(steps):
            t0 = time.perf_counter()
            state, metrics = step(state, batches[i])
            losses.append(metrics["loss"].item())          # waits for the card
            times.append(1e3 * (time.perf_counter() - t0))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{label}: non-finite loss {losses}")
        steady = times[3:] if len(times) > 3 else times
        print(f"{label}: {steps} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"{statistics.median(steady):.2f} ms/step (median of steps 4..{steps}, "
              f"host clock ending in loss.item()); losses {json.dumps([round(x, 5) for x in losses])}")
        return state, step

    reset(wrappers)
    gen = torch.Generator(device=dev).manual_seed(7)
    model = CTRModel(full, device=dev, generator=gen)
    redrawn = screen_item_rows(model, batches[:1], gen)
    if not bool(item_rows_clear(model, *hashed_behaviors(model, batches[0])).all()):
        raise AssertionError("step 1's hashed behaviors do not clear the hash margin")
    print(f"train sdim: {redrawn} item rows redrawn so that step 1's hashed behaviors and "
          f"candidates clear the margin")
    step1_gradients(torch, model, batches[0], refs, "sdim")
    torch.cuda.reset_peak_memory_stats()
    state, step = train(model, TRAIN_STEPS, "train sdim FULL")
    print(f"train sdim: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = {w.__name__: w.launches for w in wrappers}

    # checkpoint round trip: save, take the next step; restore into a fresh
    # model and optimizer, take the same step: the losses must be bit-equal
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        t0 = time.perf_counter()
        ck.save(d, TRAIN_STEPS, state)
        t_save = time.perf_counter() - t0
        _, m_a = step(state, batches[TRAIN_STEPS])
        del state, model
        torch.cuda.empty_cache()
        fresh = CTRModel(full, device=dev, generator=torch.Generator(device=dev).manual_seed(99))
        init, _ = make_train_step(loss_fn, opt)
        t0 = time.perf_counter()
        restored, at = ck.restore(d, init(fresh))
        t_restore = time.perf_counter() - t0
        _, m_b = step(restored, batches[TRAIN_STEPS])
        a, b = m_a["loss"].item(), m_b["loss"].item()
        print(f"checkpoint at step {at}: save {t_save:.1f} s, restore {t_restore:.1f} s; "
              f"next loss {a!r} before, {b!r} after restore")
        if a != b:
            raise AssertionError(f"the step after a checkpoint round trip differs: {a!r} vs {b!r}")
    profile_window(torch, "train sdim, one step", partial(step, restored, batches[1]))
    del restored, fresh
    torch.cuda.empty_cache()

    # kind target: step-1 gradients against the plain version, a few steps
    cfg = dataclasses.replace(full, interest=dataclasses.replace(full.interest, kind="target"))
    model = CTRModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(8))
    before = {w.__name__: w.launches for w in wrappers}
    step1_gradients(torch, model, batches[0], refs, "target")
    state, step = train(model, 4, "train target FULL")
    for w in wrappers:
        launches[w.__name__] += w.launches - before[w.__name__]
    profile_window(torch, "train target, one step", partial(step, state, batches[1]))
    del state, model
    torch.cuda.empty_cache()

    missing = [k for k in ("bse_encode", "sdim_query", "bse_encode_backward",
                           "sdim_query_backward", "target_attention_flash",
                           "target_attention_flash_backward") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the train path: {missing}")
    print(f"train path launches: {json.dumps(launches)}")
    return launches


def comparison_requests(cfg):
    """One BURST of requests for phase 8: histories as ``request_stream``'s,
    candidates half random items and half items of the user's own valid
    history (so sim_hard finds categories to match and some candidates
    repeat a behavior, as in ``generate_batch_graded``)."""
    from repro_torch.data.synthetic import SyntheticCTRConfig, generate_batch

    dcfg = SyntheticCTRConfig(hist_len=cfg.long_len, n_items=cfg.n_items, n_cats=cfg.n_cats)
    rng = np.random.default_rng(8)
    out = []
    for r in range(BURST):
        raw = generate_batch(dcfg, 1, 1000 + r)
        user = {k: v for k, v in raw.items() if k.startswith("hist")}
        valid = raw["hist_items"][0][raw["hist_mask"][0] > 0]
        ci = np.where(rng.random(C) < 0.5, rng.integers(0, cfg.n_items, C),
                      rng.choice(valid, C)).astype(np.int32)
        out.append((f"c{r}", user, ci, (ci // dcfg.items_per_cat).astype(np.int32),
                    np.zeros((C, cfg.ctx_dim), np.float32)))
    return out


def comparison_phase(torch, dev, wrappers):
    """Phase 8 (a): sdim-paper FULL with each of COMPARE_KINDS swapped in,
    served one burst and trained two steps, with kernel-vs-plain checks of
    the burst's long branch and of step 1's gradients. Returns the launch
    counts of phase 8 (a) and (b) together."""
    from repro_torch.configs import sdim_paper
    from repro_torch.core.interest import InterestModule
    from repro_torch.kernels.screen import MARGIN, screen_item_rows, screen_topk_rows
    from repro_torch.launch.train import recsys_setup
    from repro_torch.models.ctr import CTRModel
    from repro_torch.nn.layers import MLP
    from repro_torch.serve.ctr_server import CTRServer
    from repro_torch.train.loop import make_train_step

    refs = plain_refs()
    full = sdim_paper.FULL
    loss_fn, stream, opt = recsys_setup(full, TRAIN_B)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in next(stream).items()}
               for _ in range(2)]
    requests = comparison_requests(full)
    burst = {k: torch.as_tensor(np.concatenate([r[1][k] for r in requests]), device=dev)
             for k in ("hist_items", "hist_cats", "hist_mask")}
    burst["cand_item"] = torch.as_tensor(np.stack([r[2] for r in requests]), device=dev)
    burst["cand_cat"] = torch.as_tensor(np.stack([r[3] for r in requests]), device=dev)

    reset(wrappers)
    # the one draw of the tables; each kind swaps in its own interest module
    # and head, drawn from a generator of its own
    model = CTRModel(full, device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    for i, name in enumerate(COMPARE_KINDS):
        kind = "sdim" if name == "sdim-srht" else name
        extra = dict(family="srht") if name == "sdim-srht" else {}
        cfg = dataclasses.replace(full, interest=dataclasses.replace(full.interest, kind=kind,
                                                                     **extra))
        gen = torch.Generator(device=dev).manual_seed(20 + i)
        model.cfg = cfg
        model.interest = InterestModule(dataclasses.replace(cfg.interest, d=cfg.behavior_dim),
                                        device=dev, generator=gen)
        model.head = MLP(model._head_in_dim(), [*cfg.mlp_hidden, 1], "relu", device=dev,
                         generator=gen)
        torch.cuda.empty_cache()
        if kind in ("sdim", "eta"):
            n = screen_item_rows(model, [burst, batches[0]], gen)
            print(f"compare {name}: {n} item rows redrawn to clear the hash margin")
        if kind == "ubr4ctr":
            # 1e-4 of the largest score: the fp32 scores round at ~1e-6 of it,
            # and at 1e-3 the redraws do not settle (one user's 1,024 rows
            # feed all 128 of its candidates' boundaries)
            n = screen_topk_rows(model, [burst, batches[0]], gen, margin=MARGIN / 10)
            print(f"compare {name}: {n} item rows redrawn to part the top-k boundaries")

        # one burst through the server, twice: the second is timed steady
        mode = "decoupled" if kind == "sdim" else "inline"
        server = CTRServer.build(model, None, mode, device=dev)
        serve_all(torch, f"{name} ({mode}, first burst)", server, requests, wrappers)
        serve_all(torch, f"{name} ({mode}, again)", server, requests, wrappers)
        print(f"compare {name}: {BURST * server.stats.ms_per_request:.3f} ms per "
              f"{BURST}-request burst of {C} candidates (second burst)")
        with torch.no_grad():
            target_e = model._embed_behaviors(burst["cand_item"], burst["cand_cat"])
            long_e = model._embed_behaviors(burst["hist_items"], burst["hist_cats"])
            branch = lambda: model.interest(target_e, long_e, burst["hist_mask"],
                                            seq_cat=burst["hist_cats"], q_cat=burst["cand_cat"])
            with uncounted():
                ours = branch()
            with plain_long_branch(model, refs):
                ref = branch()
        err = check_close(f"{name} long branch", ours, ref,
                          **(ATOMIC if kind == "sdim" else FP32))
        print(f"compare {name}: burst long branch, kernels vs plain max abs err {err:.3g}")

        finite = name != "sdim_expected"
        step1_gradients(torch, model, batches[0], refs, f"compare {name}", finite=finite)
        init, step = make_train_step(loss_fn, opt)
        state, losses, times = init(model), [], []
        for b in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            losses.append(metrics["loss"].item())          # waits for the card
            times.append(1e3 * (time.perf_counter() - t0))
        if finite and not all(np.isfinite(losses)):
            raise AssertionError(f"compare {name}: non-finite loss {losses}")
        print(f"compare {name}: 2 Adagrad steps of {TRAIN_B}, losses {losses}, "
              f"{times[1]:.2f} ms/step (second step; first {times[0]:.2f})"
              + ("" if finite else "; a non-finite loss here follows step 1's non-finite "
                 "gradient (ROADMAP.md C2), a fault of the JAX reference, not of the port"))
        del state, server
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    table23_protocol(torch, dev)
    launches = read_launches(wrappers, ("bse_encode", "sdim_query", "target_attention_flash",
                                        "bse_encode_backward", "sdim_query_backward",
                                        "target_attention_flash_backward"), "comparison")
    return launches


def protocol_checks(torch, dev) -> None:
    """Phase 8 (b), before the protocol trains: each kind of it that runs a
    kernel, built as ``bench.common.train_and_eval`` builds it (its
    configuration at the protocol's shapes: d = 32, L = 256, k = 16; seed
    0) on the card, held against the plain versions on the protocol's first
    training batch (128) and first eval batch (1,024): the logits of
    ``model.apply`` on both (FP32; ATOMIC for sdim) and step 1's gradients
    on the training batch (GRAD_TOL). Rows that a hash or a top-k decides
    are screened on both batches first."""
    from repro_torch.bench import common, table23_auc
    from repro_torch.data.pipeline import DeterministicStream
    from repro_torch.data.synthetic import generate_batch_graded
    from repro_torch.kernels.screen import screen_item_rows, screen_topk_rows
    from repro_torch.models.ctr import CTRModel

    refs = plain_refs()
    dcfg = common.paper_data_config(256)
    seeds = DeterministicStream(None, base_seed=0)          # bench.common.train's stream
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()}
               for b in (generate_batch_graded(dcfg, 128, seeds.seed_for(0)),
                         generate_batch_graded(dcfg, common.EVAL_BATCH, common.EVAL_SEED0))]
    for kind, kw in table23_auc.BASELINES:
        if kind not in ("sim_hard", "ubr4ctr", "eta", "sdim", "target"):
            print(f"table23 {kind}: no kernel on its path; nothing to hold against a plain version")
            continue
        model = CTRModel(common.paper_model_config(kind, **kw), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
        gen = torch.Generator(device=dev).manual_seed(1)
        redrawn = 0
        if kind in ("sdim", "eta"):
            redrawn = screen_item_rows(model, batches, gen)
        if kind == "ubr4ctr":
            redrawn = screen_topk_rows(model, batches, gen)
        errs = []
        for b in batches:
            with torch.no_grad():
                with uncounted():
                    ours = model.apply(b)
                with plain_long_branch(model, refs):
                    ref = model.apply(b)
            errs.append(check_close(f"table23 {kind} logits of {len(ours)}", ours, ref,
                                    **(ATOMIC if kind == "sdim" else FP32)))
        print(f"table23 {kind}: {redrawn} item rows redrawn; logits, kernels vs plain max abs "
              f"err {errs[0]:.3g} (batch 128), {errs[1]:.3g} (eval batch {common.EVAL_BATCH})")
        step1_gradients(torch, model, batches[0], refs, f"table23 {kind}")
        del model
    torch.cuda.empty_cache()


def reproducible_training(torch, dev) -> None:
    """Phase 8 (b), fault C5: every kind of the protocol trained twice for
    C5_STEPS AdamW steps from one seed at its shapes (``bench.common.
    trained_params``); every parameter's bits must match
    (``bit_differences``: sdim_expected's where they are finite, C2).
    Launches made here are not counted."""
    from repro_torch.bench import common, table23_auc

    t0 = time.perf_counter()
    for kind, kw in table23_auc.BASELINES:
        with uncounted():
            runs = [common.trained_params(kind, C5_STEPS, device=dev, **kw) for _ in range(2)]
        differ = common.bit_differences(*runs)
        if differ:
            raise AssertionError(f"table23 {kind}: two trainings from one seed differ in "
                                 f"{differ} (fault C5)")
    print(f"table23: each of the {len(table23_auc.BASELINES)} kinds trained twice for "
          f"{C5_STEPS} AdamW steps from one seed: every parameter bit for bit "
          f"({time.perf_counter() - t0:.1f} s)")


def table23_protocol(torch, dev) -> None:
    """Phase 8 (b): the kernels held against their plain versions at the
    protocol's shapes, the repeated trainings of fault C5, then the Table
    2/3 protocol at its quick depth on the card."""
    from repro_torch.bench import table23_auc

    protocol_checks(torch, dev)
    reproducible_training(torch, dev)
    t0 = time.perf_counter()
    rows = table23_auc.run(quick=True, device=dev)
    print(f"table23 (quick: 600 steps, batch 128, L=256, 4096 eval examples) in "
          f"{time.perf_counter() - t0:.1f} s:")
    for r in rows:
        print("  " + json.dumps(r))
        kind, first = r["name"].split("/")[1], r.get("first_nonfinite_step")
        if kind == "sdim_expected":
            print(f"  table23 sdim_expected: first step with a non-finite loss or gradient: "
                  f"{first} — the JAX reference's own fault (ROADMAP.md §C, C2: the gradient "
                  f"of arccos is infinite where a candidate repeats a behavior), which the "
                  f"port reproduces; not a failure of the port")
        elif first is not None:
            raise AssertionError(f"table23 {kind}: non-finite loss or gradient at step {first}")


def production_traffic(cfg):
    """Phase 9's traffic: PROD_USERS users (history L = 1024 each, C
    candidates a request), and for every PROD_EV_EVERY-th burst an event
    burst of PROD_EV single events on users already served."""
    from repro_torch.data.synthetic import SyntheticCTRConfig, generate_batch

    dcfg = SyntheticCTRConfig(hist_len=cfg.long_len, n_items=cfg.n_items, n_cats=cfg.n_cats)
    h = generate_batch(dcfg, PROD_USERS, 9)
    rng = np.random.default_rng(9)
    ci = rng.integers(0, cfg.n_items, (PROD_USERS, C)).astype(np.int32)
    cc = rng.integers(0, cfg.n_cats, (PROD_USERS, C)).astype(np.int32)
    ctx = np.zeros((C, cfg.ctx_dim), np.float32)
    requests = [(f"p{u}", {k: h[k][u:u + 1] for k in ("hist_items", "hist_cats", "hist_mask")},
                 ci[u], cc[u], ctx) for u in range(PROD_USERS)]
    events = {}
    for b in range(PROD_EV_EVERY - 1, PROD_USERS // BURST, PROD_EV_EVERY):
        users = rng.integers(0, (b + 1) * BURST, PROD_EV)
        events[b] = ([f"p{u}" for u in users],
                     rng.integers(0, cfg.n_items, PROD_EV).astype(np.int32),
                     rng.integers(0, cfg.n_cats, PROD_EV).astype(np.int32))
    # the event burst folded across a held view: two events a check user
    k = np.arange(2 * BURST, dtype=np.int32)
    held_events = (k * 7919 % cfg.n_items, k % cfg.n_cats)
    return requests, events, held_events, h, ci, cc


def screen_production(torch, model, traffic) -> int:
    """Redraw the item rows that phase 9's traffic hashes (valid history
    rows, candidates, events) until each clears the hash margin, so that
    the kernels and their plain versions put every behavior in the same
    bucket (``kernels.screen.screen_item_rows``). Returns the rows
    redrawn."""
    from repro_torch.kernels.screen import screen_item_rows

    _, events, held_events, h, ci, cc = traffic
    dev = model.item_emb.weight.device
    t = lambda x: torch.as_tensor(np.asarray(x), device=dev)
    ev_items = np.concatenate([e[1] for e in events.values()] + [held_events[0]])
    ev_cats = np.concatenate([e[2] for e in events.values()] + [held_events[1]])
    none = np.zeros(0, np.int32)
    batches = [{"hist_items": t(h["hist_items"]), "hist_cats": t(h["hist_cats"]),
                "hist_mask": t(h["hist_mask"]), "cand_item": t(ci), "cand_cat": t(cc)},
               {"hist_items": t(ev_items[:, None]), "hist_cats": t(ev_cats[:, None]),
                "hist_mask": t(np.ones((len(ev_items), 1), np.float32)),
                "cand_item": t(none), "cand_cat": t(none)}]
    redrawn = screen_item_rows(model, batches, torch.Generator(device=dev).manual_seed(9))
    del batches
    torch.cuda.empty_cache()
    return redrawn


class KernelInputs:
    """An ``SDIMEngine.profiler`` that launches every kernel as the path
    asks and keeps copies of the inputs of each kernel's first call and of
    its widest one (most users or events), taken before the launch (the
    event fold writes its store in place), so that phase 9 can hold its
    kernels against their plain versions on the path's own tensors."""

    def __init__(self, torch):
        import threading
        self.torch, self.lock, self.calls = torch, threading.Lock(), {}

    def _copy(self, x):
        if isinstance(x, tuple):                  # a sharded store's blocks
            return tuple(map(self._copy, x))
        return x.clone() if self.torch.is_tensor(x) else x

    def profile(self, kernel, fn, args, kwargs):
        rows = (args[1] if kernel in ("serve_fused", "update", "serve_fused_sharded",
                                      "update_sharded") else args[0]).shape[0]
        with self.lock:
            seen = self.calls.setdefault(kernel, {})
            keep = [k for k in ("first", "widest") if k not in seen
                    or (k == "widest" and rows > seen[k][0])]
            if keep:
                snap = (rows, fn, tuple(map(self._copy, args)),
                        {k: self._copy(v) for k, v in kwargs.items()})
                for k in keep:
                    seen[k] = snap
        return fn(*args, **kwargs)


def record_folds(ingestor) -> list:
    """Wrap ``ingestor``'s two fold entry points so that each outermost call
    (the writer loop's, or an inline forced drain's) is logged with copies
    of its arguments, in fold order: what a synchronous server must be fed
    to reach the same state."""
    log, depth = [], [0]
    for name in ("ingest_histories", "ingest_events"):
        def wrapped(*args, _inner=getattr(ingestor, name), _name=name):
            if not depth[0]:
                log.append((_name, tuple(list(a) if isinstance(a, list) else
                                         None if a is None else np.array(a) for a in args)))
            depth[0] += 1
            try:
                return _inner(*args)
            finally:
                depth[0] -= 1
        setattr(ingestor, name, wrapped)
    return log


def bound_tier_moves(store) -> dict:
    """Make every residency pass of the tiered ``store`` check the batched
    bound (at most one hot gather and two hot scatters); returns the counts
    of passes and of passes that moved rows."""
    counts = {"passes": 0, "moved": 0, "max_gathers": 0, "max_scatters": 0}
    inner = store._ensure_resident

    def checked(users, create):
        g, s = store.stats.n_hot_gathers, store.stats.n_hot_scatters
        inner(users, create)
        dg, ds = store.stats.n_hot_gathers - g, store.stats.n_hot_scatters - s
        counts["passes"] += 1
        counts["moved"] += bool(dg or ds)
        counts["max_gathers"] = max(counts["max_gathers"], dg)
        counts["max_scatters"] = max(counts["max_scatters"], ds)
        if dg > 1 or ds > 2:
            raise AssertionError(f"a burst of {len(set(users))} users moved tiers in "
                                 f"{dg} hot gathers and {ds} hot scatters (bound 1 and 2)")
    store._ensure_resident = checked
    return counts


def same_scores(name, got, want) -> None:
    """Two lists of per-request scores, bit for bit (None for a shed one)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None or not np.array_equal(a.view(np.int32), b.view(np.int32)):
            diff = None if a is None or b is None else float(np.abs(a - b).max())
            raise AssertionError(f"{name}: request {i} differs (max abs diff {diff})")


def production_kernel_checks(torch, name, captured, expected) -> None:
    """Phase 9's kernels against their plain versions on the inputs the
    path itself gave them (``KernelInputs``): the history and event folds'
    behaviors through ``bse_encode`` (ATOMIC), the event fold on a clone of
    the hot tier (FP32), the fused reads off a committed view's store and
    scales and the unfused reads of fetched wire tables (FP32). Launches
    made here are not counted."""
    from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode_ref
    from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import sdim_fused_serve_ref
    from repro_torch.kernels.sdim_query.sdim_query import sdim_query_ref
    from repro_torch.kernels.sdim_serve.sdim_serve import bse_serve_ref
    from repro_torch.kernels.sdim_update.sdim_update import sdim_update_ref

    refs = {"encode": (bse_encode_ref, ATOMIC), "update": (sdim_update_ref, FP32),
            "serve_fused": (sdim_fused_serve_ref, FP32), "query": (sdim_query_ref, FP32),
            "serve": (bse_serve_ref, FP32)}
    if set(captured) != set(expected):
        raise AssertionError(f"{name}: the path called {sorted(captured)}, expected "
                             f"{sorted(expected)}")
    torch.cuda.synchronize()
    report = []
    with uncounted():
        for kernel, seen in sorted(captured.items()):
            plain, tol = refs[kernel]
            for rows, fn, args, kwargs in {id(v): v for v in seen.values()}.values():
                if kernel == "update":
                    out, ref = args[0].clone(), args[0].clone()
                    fn(out, *args[1:], **kwargs)
                    plain(ref, *args[1:], **kwargs)
                else:
                    out, ref = fn(*args, **kwargs), plain(*args, **kwargs)
                shapes = "x".join(str(tuple(a.shape)) + str(a.dtype)[6:]
                                  for a in args[:2] if torch.is_tensor(a))
                err = check_close(f"{name} {kernel} {shapes}", out, ref, **tol)
                report.append(f"{kernel} {shapes}: {err:.3g}")
    print(f"production {name}: kernels vs plain on the path's own inputs, max abs err: "
          + "; ".join(report))


def production_run(torch, dev, model, traffic, name, table_dtype, fused, tmp, full_checks):
    """One tiered, async, admission-controlled, traced server of phase 9
    through the traffic, its checks, and (``full_checks``) the in-flight
    read and snapshot -> restore checks. Returns ms/request."""
    import threading
    from repro_torch.serve.bse_server import BSEServer
    from repro_torch.serve.ctr_server import CTRServer
    from repro_torch.serve.health import health_snapshot
    from repro_torch.serve.tracing import Tracer

    requests, events, held_events = traffic[:3]
    tracer = Tracer()
    srv = CTRServer.build(model, None, "decoupled", fused=fused, table_dtype=table_dtype,
                          hot_capacity=PROD_HOT, warm_capacity=PROD_WARM,
                          store_dir=os.path.join(tmp, name), policy="clock",
                          async_ingest=True, queue_depth=PROD_QUEUE, max_concurrency=4,
                          rate_limit=1e6, tracer=tracer, device=dev)
    bse, rt, store = srv.bse, srv.bse.async_ingest, srv.bse.store
    log = record_folds(bse.ingestor)
    moves = bound_tier_moves(store)
    inputs = KernelInputs(torch)
    model.engine.profiler = inputs
    rt.start()
    t0 = time.perf_counter()
    for b, i in enumerate(range(0, PROD_USERS, BURST)):
        srv.handle_requests(requests[i:i + BURST])
        if b in events:
            bse.ingest_events(*events[b])
    for i in range(0, PROD_REVISIT, BURST):            # early users again: warm and cold
        srv.handle_requests(requests[i:i + BURST])
    rt.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_served = srv.stats.n_requests
    # check bursts: users from the cold, warm and hot ranges; a first read
    # misses and touches them, the writer promotes them, the second hits
    pick = np.unique(np.concatenate([np.linspace(0, PROD_USERS - 1, BURST - 4).astype(int),
                                     [1, 2, PROD_REVISIT + 1, PROD_USERS // 2 + 1]]))
    check = [requests[u] for u in pick]
    tiers_before = sorted({str(store.tier(r[0])) for r in check})
    for _ in range(4):        # a promotion may demote another user of the burst
        misses = bse.stats.n_misses
        before = srv.handle_requests(check)
        rt.flush()
        if bse.stats.n_misses == misses:
            break
    else:
        raise AssertionError(f"{name}: the check burst still missed users after four flushes")
    for s in before:
        if s is None or not np.isfinite(s).all():
            raise AssertionError(f"{name}: shed or non-finite scores in the check burst")

    view = rt.committed
    held = (view.data.clone(), None if view.scales is None else view.scales.clone())
    ev_users = [r[0] for r in check] * 2
    ev = (ev_users, held_events[0][:len(ev_users)], held_events[1][:len(ev_users)])
    if full_checks:
        # a fold held on the host (a gate inside the embedding) and on the
        # device (a sleep ahead of it on the writer stream): reads meanwhile
        # return the previous committed version
        gate, stall, entered = threading.Event(), threading.Event(), threading.Event()
        embed = bse.ingestor.embed_fn

        def gated(params, items, cats):
            if stall.is_set():
                torch.cuda._sleep(100_000_000)
                entered.set()
                if not gate.wait(60):
                    raise RuntimeError("the in-flight check never opened its gate")
            return embed(params, items, cats)
        bse.ingestor.embed_fn = gated
        stall.set()
        bse.ingest_events(*ev)
        if not entered.wait(60):
            raise AssertionError(f"{name}: the writer never started the gated fold")
        during = srv.handle_requests(check)
        if rt.committed is not view:
            raise AssertionError(f"{name}: a fold committed while its gate was shut")
        same_scores(f"{name}: read during an in-flight fold", during, before)
        gate.set()
        while rt.committed is view and rt.error is None:
            time.sleep(0.001)
        rows_now = view.rows(view.lookup([r[0] for r in check])[0])   # fold still on the device
        stall.clear()
        bse.ingestor.embed_fn = embed
        rt.flush()
        rows_then = view.rows(view.lookup([r[0] for r in check])[0])
        if not torch.equal(rows_now, rows_then):
            raise AssertionError(f"{name}: a held view's rows changed under a fold")
        print(f"production {name}: reads during an in-flight fold returned the previous "
              f"version (v{view.version}) bit for bit")
    else:
        bse.ingest_events(*ev)
        rt.flush()
    if not (torch.equal(view.data.view(torch.uint8), held[0].view(torch.uint8))
            and (held[1] is None or torch.equal(view.scales, held[1]))):
        raise AssertionError(f"{name}: the view held across folds changed")
    after = srv.handle_requests(check)
    if all(np.array_equal(a, b) for a, b in zip(after, before)):
        raise AssertionError(f"{name}: the event burst changed no score")
    health = health_snapshot(srv)
    if not (health["live"] and health["ready"]):
        raise AssertionError(f"{name}: health {json.dumps(health, default=str)}")
    if rt.stop() is not True or rt.error is not None or rt._thread is not None:
        raise AssertionError(f"{name}: the writer thread did not stop cleanly")
    if moves["max_gathers"] > 1 or moves["max_scatters"] > 2 or not moves["moved"]:
        raise AssertionError(f"{name}: tier movement {moves}")
    model.engine.profiler = None
    production_kernel_checks(torch, name, inputs.calls,
                             ("encode", "update", "serve_fused") if table_dtype == "fp32"
                             else ("encode", "serve_fused" if fused else "query"))
    del inputs

    # a synchronous, untiered server fed the same folds answers the same
    # bits (a comparison, not the path: its launches are not counted)
    with uncounted():
        ref = CTRServer.build(model, None, "decoupled", fused=fused, table_dtype=table_dtype,
                              capacity=PROD_USERS, device=dev)
        for fold, args in log:
            getattr(ref.bse.ingestor, fold)(*args)
        same_scores(f"{name} vs a synchronous untiered server", after,
                    ref.handle_requests(check))
        del ref
        if full_checks:
            snap = bse.snapshot(os.path.join(tmp, f"{name}-snapshot"))
            back = BSEServer.restore(snap, bse.ingestor.embed_fn, model, model.engine,
                                     device=dev)
            restored = CTRServer(model, back, mode="decoupled", fused=fused)
            same_scores(f"{name} snapshot -> restore", restored.handle_requests(check), after)
            print(f"production {name}: snapshot -> restore answered the check burst bit "
                  f"for bit")

    ts, ist, adm = store.stats, rt.stats, srv.admission.stats
    req = srv.metrics.snapshot()["histograms"]["ctr.request_ms"]
    spans = tracer.summary()["by_name"]
    move_ms = {k: spans[k]["total_ms"] / spans[k]["count"]
               for k in ("tier.promote", "tier.demote", "tier.cold_read") if k in spans}
    print(f"production {name}: {n_served} requests in {wall:.2f} s "
          f"({1e3 * srv.stats.total_time_s / max(n_served, 1):.3f} ms/request host), "
          f"ctr.request_ms p50/p95/p99 {req['p50']:.3f}/{req['p95']:.3f}/{req['p99']:.3f} "
          f"(n={req['count']}, per burst of {BURST}); check burst before the flush: {tiers_before}")
    print(f"production {name}: ingest {ist.n_enqueued} enqueued, {ist.n_dropped} dropped, "
          f"{ist.n_folds} folds (max batch {ist.max_drain_batch}), "
          f"{ist.n_histories_folded} histories, {ist.n_events_folded} events, "
          f"{ist.n_touches_folded} touches, {ist.n_forced_drains} forced drains, "
          f"staleness p95 {ist.staleness_p95():.1f} max {ist.staleness_max()}, "
          f"fold {1e3 * ist.fold_time_s / max(ist.n_folds, 1):.3f} ms each (host)")
    print(f"production {name}: tiers {store.tier_sizes()} (hot cap {store.hot_capacity}, "
          f"{store.cold.n_segments} cold segments), hit rate {ts.hit_rate:.3f}, "
          f"promote {ts.promote_bytes} B, demote {ts.demote_bytes} B, spill {ts.spill_bytes} B, "
          f"{ts.warm_promotions} warm + {ts.cold_promotions} cold promotions, "
          f"{ts.demotions} demotions; residency passes {json.dumps(moves)}; "
          f"ms per move (host, retained traces) {json.dumps(move_ms)}")
    if adm.n_shed:
        raise AssertionError(f"{name}: admission shed {adm.n_shed} requests")
    print(f"production {name}: admission {adm.n_admitted} admitted, {adm.n_shed} shed of "
          f"{adm.n_offered} (rate 1e6/s, concurrency 4); health live={health['live']} "
          f"ready={health['ready']}; {len(log)} folds replayed into the synchronous server")
    if full_checks:
        print(tracer.report(5))
        timed = store.hot.data.clone
        print(f"production {name}: copy-on-write clone of the "
              f"{store.hot.data.numel() * store.hot.data.element_size() / 2**20:.0f} MiB hot "
              f"tier: {time_ms(timed, iters=10, warmup=2):.4f} ms (event-timed)")
    return 1e3 * srv.stats.total_time_s / max(n_served, 1)


def production_phase(torch, dev, wrappers):
    """Phase 9: sdim-paper FULL through the production runtime (tiered
    store, async ingest, admission, metrics, tracing): fp32 fused, int8
    fused and int8 unfused. Returns the phase's launch counts."""
    import shutil
    import tempfile
    from repro_torch.configs import sdim_paper
    from repro_torch.models.ctr import CTRModel

    model = CTRModel(sdim_paper.FULL, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    traffic = production_traffic(model.cfg)
    t0 = time.perf_counter()
    redrawn = screen_production(torch, model, traffic)
    print(f"production: {redrawn} item rows redrawn to clear the hash margin "
          f"({time.perf_counter() - t0:.1f} s)")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        reset(wrappers)
        ms = {}
        for name, dtype, fused in (("fp32-fused", "fp32", True), ("int8-fused", "int8", True),
                                   ("int8-unfused", "int8", False)):
            ms[name] = production_run(torch, dev, model, traffic, name, dtype, fused, tmp,
                                      full_checks=name == "fp32-fused")
        launches = read_launches(wrappers, ("bse_encode", "sdim_update", "sdim_fused_serve",
                                            "sdim_query"), "production")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"production ms/request (host, all bursts): {json.dumps(ms)}")
    return launches


def arch_burst(torch, dev, requests) -> dict:
    """A burst of requests as tensors: hist_* (n, L), cand_* (n, C), ctx."""
    burst = {k: torch.as_tensor(np.concatenate([r[1][k] for r in requests]), device=dev)
             for k in ("hist_items", "hist_cats", "hist_mask")}
    for i, k in ((2, "cand_item"), (3, "cand_cat"), (4, "ctx")):
        burst[k] = torch.as_tensor(np.stack([r[i] for r in requests]), device=dev)
    return burst


def arch_checks(torch, model, burst, batch, refs, label) -> None:
    """The burst's long branch and the training batch's logits through the
    kernels against the same through the plain versions on the card
    (ATOMIC: bse_encode's row-order sums)."""
    with torch.no_grad():
        target_e = model._embed_behaviors(burst["cand_item"], burst["cand_cat"])
        long_e = model._embed_behaviors(burst["hist_items"], burst["hist_cats"])
        branch = lambda: model.interest(target_e, long_e, burst["hist_mask"])
        with uncounted():
            ours, logits = branch(), model.apply(batch)
        with plain_long_branch(model, refs):
            ref, ref_logits = branch(), model.apply(batch)
    e1 = check_close(f"{label} burst long branch", ours, ref, **ATOMIC)
    e2 = check_close(f"{label} logits of a training batch", logits, ref_logits, **ATOMIC)
    print(f"{label}: kernels vs plain, burst long branch max abs err {e1:.3g}, "
          f"logits of {TRAIN_B} max abs err {e2:.3g}")


def steady(times) -> dict:
    """Median and range of steady bursts' ms/request or steps' ms."""
    return {"median": statistics.median(times), "min": min(times), "max": max(times),
            "n": len(times)}


def arch_serving(torch, dev, wrappers, model, requests, events, label) -> dict:
    """bst, dien and bert4rec through ``CTRServer``: decoupled unfused on the
    bf16 wire, fused off an fp32 and an int8 store, inline; each serves the
    requests in bursts of BURST, folds the events (decoupled) and serves
    them twice more. Each kernel a server called is held against its plain
    version on the server's own inputs; inline against a decoupled server
    with an fp32 wire (INLINE_TOL), fused against unfused (WIRE_TOL).
    Returns by setup the ms/request of the bursts after the fold
    (``steady``)."""
    from repro_torch.serve.ctr_server import CTRServer

    setups = {"unfused": (dict(mode="decoupled"), {"encode", "update", "query"}),
              "fused": (dict(mode="decoupled", fused=True), {"encode", "update", "serve_fused"}),
              "fused-int8": (dict(mode="decoupled", fused=True, table_dtype="int8"),
                             {"encode", "serve_fused"}),   # an int8 store folds by encode
              "inline": (dict(mode="inline"), {"serve"})}
    scores, ms = {}, {}
    for name, (kw, expected) in setups.items():
        srv = CTRServer.build(model, None, device=dev, **kw)
        caps = KernelInputs(torch)
        model.engine.profiler = caps
        times = []
        try:
            first, _ = serve_all(torch, f"{label} {name}", srv, requests, wrappers)
            if srv.bse is not None:
                srv.bse.ingest_events(*events)
            again, _ = serve_all(torch, f"{label} {name}, again"
                                 + (f" after {ARCH_EV} events" if srv.bse else ""),
                                 srv, requests, wrappers, times)
            serve_all(torch, f"{label} {name}, a third time", srv, requests, wrappers, times)
        finally:
            model.engine.profiler = None
        scores[name], ms[name] = (first, again), steady(times)
        production_kernel_checks(torch, f"{label} {name}", caps.calls, expected)
        if name == "fused":
            with uncounted():
                profile_burst(torch, f"{label} fused", srv, requests[:BURST])
        del srv
    with uncounted():                       # a comparison server: its launches are not the path's
        ref_srv = CTRServer.build(model, None, "decoupled", wire_dtype=torch.float32, device=dev)
        ref, _ = serve_all(torch, f"{label} decoupled, fp32 wire", ref_srv, requests, wrappers)
        del ref_srv
    for what, got, want, tol in (
            ("inline - decoupled fp32 wire", scores["inline"][0], ref, INLINE_TOL),
            ("fused - unfused", scores["fused"][1], scores["unfused"][1], WIRE_TOL),
            ("fused-int8 - unfused", scores["fused-int8"][1], scores["unfused"][1], WIRE_TOL)):
        diff = float(np.abs(got - want).max())
        print(f"{label}: |{what}| max {diff:.3g} (tolerance {tol})")
        if diff > tol:
            raise AssertionError(f"{label}: {what} differ by {diff} (> {tol})")
    if float(np.abs(scores["unfused"][1] - scores["unfused"][0]).max()) == 0.0:
        raise AssertionError(f"{label}: the event fold changed no score")
    return ms


def wide_deep_serving(torch, dev, wrappers, model, burst, sparse_ids, label) -> dict:
    """wide_deep, whose fields ``CTRServer`` does not take, through
    ``score_candidates_many(..., sparse_ids=..., bucket_tables=...)`` on
    the bf16 wire and inline, in bursts of BURST, three times; each burst
    timed on the host clock; each kernel held against its plain version on
    the path's inputs, inline against fp32 tables (INLINE_TOL) and the bf16
    wire (WIRE_TOL). Returns by setup the ms/request of the second and
    third passes' bursts (``steady``)."""
    n = len(burst["cand_item"])

    def score(i, tables=None):
        part = {k: v[i:i + BURST] for k, v in burst.items()}
        users = {k: part[k] for k in ("hist_items", "hist_cats", "hist_mask")}
        kw = {} if tables is None else {
            "bucket_tables": model.encode_bse_table(users).to(tables)}
        return model.score_candidates_many(users, part["cand_item"], part["cand_cat"],
                                           part["ctx"], sparse_ids=sparse_ids[i:i + BURST],
                                           **kw).cpu().numpy()

    caps = KernelInputs(torch)
    model.engine.profiler = caps
    ms, scores = {"decoupled": [], "inline": []}, {}
    try:
        with torch.no_grad():
            for rnd in range(3):
                for name, tables in (("decoupled", torch.bfloat16), ("inline", None)):
                    out, times = [], []
                    for i in range(0, n, BURST):
                        t0 = time.perf_counter()
                        out.append(score(i, tables))
                        times.append(1e3 * (time.perf_counter() - t0) / len(out[-1]))
                    out = np.concatenate(out)
                    if out.shape != (n, C) or not np.isfinite(out).all():
                        raise AssertionError(f"{label} {name}: scores {out.shape}, finite "
                                             f"{np.isfinite(out).all()}")
                    scores.setdefault(name, out)
                    if rnd:
                        ms[name] += times
                    print(f"serve {label} {name} (pass {rnd + 1}): "
                          f"{statistics.median(times):.3f} ms/request median over "
                          f"{len(times)} bursts of {BURST}")
    finally:
        model.engine.profiler = None
    production_kernel_checks(torch, label, caps.calls, {"encode", "query", "serve"})
    with torch.no_grad(), uncounted():
        ref = np.concatenate([score(i, torch.float32) for i in range(0, n, BURST)])
    for what, want, tol in (("decoupled fp32 tables", ref, INLINE_TOL),
                            ("decoupled bf16 wire", scores["decoupled"], WIRE_TOL)):
        diff = float(np.abs(scores["inline"] - want).max())
        print(f"{label}: |inline - {what}| max {diff:.3g} (tolerance {tol})")
        if diff > tol:
            raise AssertionError(f"{label}: inline vs {what} differ by {diff} (> {tol})")
    return {k: steady(v) for k, v in ms.items()}


def archs_phase(torch, dev, wrappers):
    """Phase 10: wide_deep, bst, dien and bert4rec at their FULL configs
    (seeded random weights from the port's init), one after another, the
    card freed between them. Each: ARCH_REQUESTS requests of C candidates
    served in bursts of BURST (``arch_serving``; wide_deep
    ``wide_deep_serving``), their long branch and a batch's logits held
    against the plain
    versions, step 1's gradients against the plain versions' (GRAD_TOL),
    and ARCH_STEPS Adagrad steps at TRAIN_B. The item rows the burst, its
    events and step 1 hash are margin-screened first. Returns the phase's
    launch counts."""
    from repro_torch.configs import registry
    from repro_torch.kernels.screen import screen_item_rows
    from repro_torch.launch.train import recsys_setup
    from repro_torch.models.ctr import CTRModel
    from repro_torch.train.loop import make_train_step

    refs = plain_refs()
    reset(wrappers)
    summary = {}
    need = {"bse_encode", "sdim_query", "bse_serve", "bse_encode_backward",
            "sdim_query_backward"}
    for i, arch in enumerate(ARCHS):
        cfg = registry.get(arch.replace("_", "-")).FULL
        label = f"archs {arch}"
        before = {w.__name__: w.launches for w in wrappers}
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        model = CTRModel(cfg, device=dev, generator=gen)
        torch.cuda.synchronize()
        print(f"{label}: FULL (embed_dim {cfg.embed_dim}, behavior d {cfg.behavior_dim}, "
              f"short_len {cfg.short_len}), {sum(p.numel() for p in model.parameters()) / 1e6:.1f} "
              f"M parameters, init {time.perf_counter() - t0:.2f} s")
        requests = request_stream(ARCH_REQUESTS, cfg)
        burst = arch_burst(torch, dev, requests)
        loss_fn, stream, opt = recsys_setup(cfg, TRAIN_B)
        batches = [{k: torch.as_tensor(v, device=dev) for k, v in next(stream).items()}
                   for _ in range(ARCH_STEPS)]
        ev_rng = np.random.default_rng(10 + i)
        events = ([r[0] for r in requests[:ARCH_EV // 2]] * 2,
                  ev_rng.integers(0, cfg.n_items, (ARCH_EV, 1)).astype(np.int32),
                  ev_rng.integers(0, cfg.n_cats, (ARCH_EV, 1)).astype(np.int32))
        ev_batch = {"hist_items": torch.as_tensor(events[1], device=dev),
                    "hist_cats": torch.as_tensor(events[2], device=dev),
                    "hist_mask": torch.ones((ARCH_EV, 1), device=dev),
                    "cand_item": burst["cand_item"][:0], "cand_cat": burst["cand_cat"][:0]}
        n = screen_item_rows(model, [burst, ev_batch, batches[0]], gen)
        print(f"{label}: {n} item rows redrawn to clear the hash margin")

        if arch == "wide_deep":
            sids = torch.as_tensor(np.random.default_rng(7).integers(
                0, cfg.field_vocab, (ARCH_REQUESTS, C, cfg.n_sparse)).astype(np.int32),
                device=dev)
            ms = wide_deep_serving(torch, dev, wrappers, model, burst, sids, label)
        else:
            ms = arch_serving(torch, dev, wrappers, model, requests, events, label)
        arch_checks(torch, model, burst, batches[0], refs, label)
        step1_gradients(torch, model, batches[0], refs, label)

        init, step = make_train_step(loss_fn, opt)
        state, losses, times = init(model), [], []
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            losses.append(metrics["loss"].item())          # waits for the card
            times.append(1e3 * (time.perf_counter() - t0))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{label}: non-finite loss {losses}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{label}: {ARCH_STEPS} Adagrad steps of {TRAIN_B}, losses {losses}, "
              f"ms/step {json.dumps([round(x, 2) for x in times])} (host clock ending in "
              f"loss.item()); peak device memory {peak:.2f} GiB")
        delta = {w.__name__: w.launches - before[w.__name__] for w in wrappers}
        with uncounted():
            profile_window(torch, f"{label}, one training step",
                           partial(step, state, batches[0]))
        own = need if arch == "wide_deep" else need | {"sdim_update", "sdim_fused_serve"}
        summary[arch] = {"ms_per_request": ms, "ms_per_step": steady(times[1:]),
                         "peak_train_gib": round(peak, 2)}
        del state, model, burst
        torch.cuda.empty_cache()
        if arch == "dien":
            summary["dien-target"] = dien_target(torch, dev, cfg, requests, batches, refs)
            own = own | TARGET_KERNELS
            delta = {w.__name__: w.launches - before[w.__name__] for w in wrappers}
        missing = sorted(k for k in own if delta[k] == 0)
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        del batches
        torch.cuda.empty_cache()
    print(f"archs ms/request (host; the {2 * ARCH_REQUESTS // BURST} bursts after the event "
          f"fold) and ms/step (steps 2..{ARCH_STEPS}), median/min/max: {json.dumps(summary)}")
    return read_launches(wrappers, sorted(need | TARGET_KERNELS
                                          | {"sdim_update", "sdim_fused_serve"}), "archs")


def dien_target(torch, dev, cfg, requests, batches, refs) -> dict:
    """dien FULL (d = 36) with interest kind "target": one burst of BURST
    requests through ``mode="target_attention"`` (target_attention_flash)
    and two Adagrad steps (its backward too); the burst's scores through
    the kernel against the same server on the plain version (INLINE_TOL),
    step 1's gradients against the plain version's (GRAD_TOL), finite
    losses. Returns the burst's ms/request and the steps' ms."""
    from repro_torch.launch.train import recsys_setup
    from repro_torch.models.ctr import CTRModel
    from repro_torch.serve.ctr_server import CTRServer
    from repro_torch.train.loop import make_train_step

    label = "archs dien, kind target"
    cfg = dataclasses.replace(cfg, interest=dataclasses.replace(cfg.interest, kind="target"))
    model = CTRModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(104))
    srv = CTRServer.build(model, None, "target_attention", device=dev)
    burst = requests[:BURST]
    t0 = time.perf_counter()
    scores = np.stack(srv.handle_requests(burst))
    ms_request = 1e3 * (time.perf_counter() - t0) / len(burst)
    if scores.shape != (BURST, C) or not np.isfinite(scores).all():
        raise AssertionError(f"{label}: scores {scores.shape}, finite {np.isfinite(scores).all()}")
    with plain_long_branch(model, refs):
        plain = np.stack(srv.handle_requests(burst))
    diff = float(np.abs(scores - plain).max())
    print(f"{label}: a burst of {BURST} x {C} at d = {cfg.behavior_dim}, {ms_request:.3f} "
          f"ms/request (host, first burst); |kernel - plain| scores max {diff:.3g} "
          f"(tolerance {INLINE_TOL})")
    if diff > INLINE_TOL:
        raise AssertionError(f"{label}: scores through the kernel differ from the plain "
                             f"version's by {diff} (> {INLINE_TOL})")
    step1_gradients(torch, model, batches[0], refs, label)
    loss_fn, _, opt = recsys_setup(cfg, TRAIN_B)
    init, step = make_train_step(loss_fn, opt)
    state, losses, times = init(model), [], []
    for b in batches[:2]:
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(metrics["loss"].item())
        times.append(1e3 * (time.perf_counter() - t0))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    print(f"{label}: 2 Adagrad steps of {TRAIN_B}, losses {losses}, ms/step "
          f"{json.dumps([round(x, 2) for x in times])} (host clock ending in loss.item())")
    return {"ms_per_request_first_burst": ms_request, "ms_per_step": times}


def profile_run(torch, dev, tmp, name, dtype, async_ingest, requests, events) -> dict:
    """One run of phase 11: ``launch.serve.build`` at FULL with ``--profile
    --profile-dir`` (fused, tiered hot PROF_HOT / warm PROF_WARM / a cold
    directory, storage ``dtype``, async ingest or not), the requests in
    bursts of BURST with PROF_EV events folded after every PROF_EV_EVERY
    bursts, then PROF_STEADY steady bursts of hot users with the profiler
    and PROF_STEADY without, alternating; ``launch.serve.report`` last. The
    checks: finite scores; an empty ``ledger.verify()``; a ``profile.json``
    that ``tools/bench_check.py::check_profile`` accepts; encode,
    serve_fused and (fp32, whose events fold through sdim_update; int8
    folds by encode) update each with calls > 0 and compiles >= 1; no
    record's predicted time above PROF_RATIO times its measured time; the
    ledger's hot bytes those of the hot store's tensors. Returns the
    run's numbers."""
    import importlib.util

    from repro_torch.configs import sdim_paper
    from repro_torch.launch import serve as launcher

    pdir = os.path.join(tmp, name)
    argv = ["--arch", "sdim-paper", "--candidates", str(C), "--micro-batch", str(BURST),
            "--fused-serve", "--table-dtype", dtype, "--hot-capacity", str(PROF_HOT),
            "--warm-capacity", str(PROF_WARM), "--store-dir", os.path.join(pdir, "cold"),
            "--profile", "--profile-dir", pdir] + (["--async-ingest"] if async_ingest else [])
    launch = launcher.build(argv, cfg=sdim_paper.FULL)
    server, bse, profiler = launch.server, launch.server.bse, launch.profiler

    def burst(reqs):
        t0 = time.perf_counter()
        scores = server.handle_requests(reqs)
        ms = 1e3 * (time.perf_counter() - t0) / len(reqs)
        if any(x is None or not np.isfinite(x).all() for x in scores):
            raise AssertionError(f"profile {name}: a shed or non-finite score")
        return ms

    for i in range(0, len(requests), BURST):
        burst(requests[i:i + BURST])
        if (i // BURST + 1) % PROF_EV_EVERY == 0:
            users, items, cats = events(requests[i:i + BURST])
            bse.ingest_events(users, items, cats)
    if bse.async_ingest is not None:
        bse.async_ingest.flush()
    hot_reqs = requests[-PROF_HOT:][:PROF_STEADY * BURST]
    burst(hot_reqs[:BURST])                                   # their committed view
    times = {"with": [], "without": []}
    for i in range(PROF_STEADY):
        reqs = hot_reqs[i * BURST:(i + 1) * BURST]
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            bse.engine.profiler = profiler if on else None
            times["with" if on else "without"].append(burst(reqs))
    bse.engine.profiler = profiler
    profile = launcher.report(launch)                         # stops async ingest

    errs = launch.ledger.verify()
    if errs:
        raise AssertionError(f"profile {name}: the ledger missed events: {errs}")
    spec = importlib.util.spec_from_file_location(
        "bench_check", os.path.join(ROOT, "tools", "bench_check.py"))
    bench_check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_check)
    with open(os.path.join(pdir, "profile.json")) as f:
        print(f"profile {name}: {bench_check.check_profile(json.load(f))}")
    pk = profile["per_kernel"]
    need = {"encode", "serve_fused"} | ({"update"} if dtype == "fp32" else set())
    bad = sorted(k for k in need if k not in pk or pk[k]["calls"] < 1 or pk[k]["compiles"] < 1)
    if bad:
        raise AssertionError(f"profile {name}: kernels without a timed call and a compile: "
                             f"{bad} in {json.dumps({k: (v['calls'], v['compiles']) for k, v in pk.items()})}")
    ratios = {k: v["predicted"]["roofline_ms"] / v["time_ms"] for k, v in pk.items()}
    by_sig = {f"{k} {sig_label(sig)}": rec for (k, sig), rec in profiler.signatures.items()
              if rec.n_calls}
    sig_ratios = {k: rec.predicted.roofline_time / rec.mean_s for k, rec in by_sig.items()}
    over = {k: r for k, r in {**ratios, **sig_ratios}.items() if r > PROF_RATIO}
    if over:
        raise AssertionError(f"profile {name}: predicted above {PROF_RATIO} x measured: {over} "
                             f"(a count in kernels/cost.py is wrong)")
    hot = bse.store.hot
    hot_bytes = hot.data.numel() * hot.data.element_size() + (
        0 if hot.scales is None else hot.scales.numel() * hot.scales.element_size())
    if profile["mem"]["hot_bytes"] != hot_bytes:
        raise AssertionError(f"profile {name}: ledger hot bytes {profile['mem']['hot_bytes']} "
                             f"!= the hot store's {hot_bytes}")
    for k, v in pk.items():
        print(f"profile {name} {k}: {v['calls']} calls, {v['compiles']} compiles, measured "
              f"{v['time_ms']:.4f} ms (min {v['min_ms']:.4f}, max {v['max_ms']:.4f}), predicted "
              f"{v['predicted']['roofline_ms']:.6f} ms ({v['predicted']['bottleneck']}), "
              f"predicted / measured {ratios[k]:.4g}")
    for k, rec in by_sig.items():
        print(f"profile {name} {k}: {rec.n_calls} calls, measured {rec.time_ms:.4f} ms, "
              f"predicted {1e3 * rec.predicted.roofline_time:.6f} ms "
              f"({rec.predicted.bottleneck}), predicted / measured {sig_ratios[k]:.4g}")
    print(f"profile {name}: the largest predicted / measured, {max(sig_ratios.values()):.4g}, "
          f"is {PROF_RATIO / max(sig_ratios.values()):.4g} x below the {PROF_RATIO} limit")
    overhead = {k: steady(v) for k, v in times.items()}
    print(f"profile {name}: ms/request of {PROF_STEADY} steady bursts of {BURST} (host), "
          f"with --profile {json.dumps(overhead['with'])}, without {json.dumps(overhead['without'])}; "
          f"mem {json.dumps({k: profile['mem'][k] for k in ('hot_bytes', 'warm_bytes', 'cold_bytes', 'events', 'moved_bytes')})}")
    del launch, server, bse
    return {"per_kernel": pk, "mem": profile["mem"], "ms_per_request": overhead,
            "ratios": ratios, "signature_ratios": sig_ratios}


def sig_label(sig) -> str:
    """A dispatch signature (``serve/profiler.py``'s ``_signature``) as the
    shapes and dtypes of its tensor arguments."""
    return " ".join("x".join(map(str, a[0])) + ":" + str(a[1]).removeprefix("torch.")
                    for a in sig[0] if isinstance(a, tuple) and len(a) == 3)


def profile_phase(torch, dev, wrappers):
    """Phase 11: the serve launcher with --profile --profile-dir on
    sdim-paper at FULL, in process (``profile_run``): fp32 synchronous, then
    int8 with --async-ingest. Returns the phase's launch counts."""
    import shutil
    import tempfile
    from repro_torch.configs import sdim_paper

    cfg = sdim_paper.FULL
    requests = request_stream(PROF_USERS, cfg)
    rng = np.random.default_rng(11)

    def events(reqs):
        users = [r[0] for r in reqs] * (PROF_EV // len(reqs))
        return (users, rng.integers(0, cfg.n_items, (len(users), 1)).astype(np.int32),
                rng.integers(0, cfg.n_cats, (len(users), 1)).astype(np.int32))

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    summary = {}
    try:
        reset(wrappers)
        for name, dtype, async_ingest in (("fp32", "fp32", False), ("int8-async", "int8", True)):
            summary[name] = profile_run(torch, dev, tmp, name, dtype, async_ingest, requests,
                                        events)
            torch.cuda.empty_cache()
        launches = read_launches(wrappers, ("bse_encode", "sdim_update", "sdim_fused_serve"),
                                 "profile")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"profile: {json.dumps(summary)}")
    return launches


def sharded_traffic(cfg):
    """Phase 12's traffic: SHARD_USERS users' histories (L = 1024), the
    first SHARD_REQUESTS users' requests of C candidates, and for every
    PROD_EV_EVERY-th burst of the two passes an event burst: EV_USERS users
    with E events each (the synchronous runs) or one each (the async run,
    whose queue holds single events)."""
    from repro_torch.data.synthetic import SyntheticCTRConfig, generate_batch

    dcfg = SyntheticCTRConfig(hist_len=cfg.long_len, n_items=cfg.n_items, n_cats=cfg.n_cats)
    h = generate_batch(dcfg, SHARD_USERS, 12)
    rng = np.random.default_rng(12)
    ci = rng.integers(0, cfg.n_items, (SHARD_REQUESTS, C)).astype(np.int32)
    cc = rng.integers(0, cfg.n_cats, (SHARD_REQUESTS, C)).astype(np.int32)
    ctx = np.zeros((C, cfg.ctx_dim), np.float32)
    users = [f"s{u}" for u in range(SHARD_USERS)]
    requests = [(users[u], {k: h[k][u:u + 1] for k in ("hist_items", "hist_cats", "hist_mask")},
                 ci[u], cc[u], ctx) for u in range(SHARD_REQUESTS)]
    n_bursts = 2 * SHARD_REQUESTS // BURST
    events = {}
    for b in range(PROD_EV_EVERY - 1, n_bursts, PROD_EV_EVERY):
        ev_users = [users[u] for u in rng.integers(0, SHARD_REQUESTS, EV_USERS)]
        events[b] = (ev_users, rng.integers(0, cfg.n_items, (EV_USERS, E)).astype(np.int32),
                     rng.integers(0, cfg.n_cats, (EV_USERS, E)).astype(np.int32))
    return users, h, requests, events


def screen_sharded(torch, model, requests, events) -> int:
    """Redraw the item rows that the kernels phase 12 holds against their
    plain versions hash (the candidates for sdim_fused_serve, the events
    for sdim_update) until they clear the hash margin. Returns the rows
    redrawn."""
    from repro_torch.kernels.screen import screen_item_rows

    dev = model.item_emb.weight.device
    t = lambda x: torch.as_tensor(np.asarray(x), device=dev)
    none = t(np.zeros(0, np.int32))
    rows = [(np.stack([r[2] for r in requests]), np.stack([r[3] for r in requests])),
            (np.concatenate([e[1] for e in events.values()]),
             np.concatenate([e[2] for e in events.values()]))]
    batches = [{"hist_items": t(i), "hist_cats": t(c), "hist_mask": t(np.ones(i.shape, np.float32)),
                "cand_item": none, "cand_cat": none} for i, c in rows]
    return screen_item_rows(model, batches, torch.Generator(device=dev).manual_seed(12))


def ingest_all(bse, users, h) -> None:
    for lo in range(0, len(users), SHARD_INGEST):
        bse.ingest_histories(users[lo:lo + SHARD_INGEST], h["hist_items"][lo:lo + SHARD_INGEST],
                             h["hist_cats"][lo:lo + SHARD_INGEST],
                             h["hist_mask"][lo:lo + SHARD_INGEST])


def sharded_kernel_checks(torch, name, captured) -> None:
    """Kernels 2 and 3 as the sharded dispatches launched them on one
    shard: the shard that owns the most rows of the widest call, whose
    launch also held foreign rows (masked out: mask 0, present 0, slot 0),
    each against its plain version on the same per-shard arguments
    (``core.engine.shard_update_args`` / ``shard_serve_fused_args``, the
    ones the path built). Launches made here are not counted."""
    from repro_torch.core.engine import shard_serve_fused_args, shard_update_args
    from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import (sdim_fused_serve,
                                                                       sdim_fused_serve_ref)
    from repro_torch.kernels.sdim_update.sdim_update import sdim_update, sdim_update_ref

    report = []
    with uncounted():
        for kernel, seen in sorted(captured.items()):
            if kernel not in ("update_sharded", "serve_fused_sharded"):
                continue
            _, _, args, kwargs = seen["widest"]
            handles = args[1]
            k = int(np.bincount(handles[:, 0].numpy(), minlength=SHARDS).argmax())
            if kernel == "update_sharded":
                block, slots, ev, mk, R = shard_update_args(k, *args)
                foreign = int((mk.sum(1) == 0).sum())
                out, ref = block.clone(), block.clone()
                sdim_update(out, slots, ev, mk, R, TAU)
                sdim_update_ref(ref, slots, ev, mk, R, TAU)
            else:
                a, kw = shard_serve_fused_args(k, args[0], handles, args[2], args[3],
                                               kwargs["scales"], kwargs["present"])
                foreign = int((kw["present"] == 0).sum())
                out, ref = sdim_fused_serve(*a, TAU, **kw), sdim_fused_serve_ref(*a, TAU, **kw)
            if not foreign:
                raise AssertionError(f"sharded {name} {kernel}: shard {k}'s launch held no "
                                     f"foreign row")
            err = check_close(f"sharded {name} {kernel} shard {k}", out, ref, **FP32)
            report.append(f"{kernel} shard {k} ({len(handles)} rows, {foreign} foreign): "
                          f"{err:.3g}")
    torch.cuda.synchronize()
    print(f"sharded {name}: kernels vs plain on one shard's launch, max abs err: "
          + "; ".join(report))


def sharded_run(torch, dev, model, mesh, traffic, name, dtype, fused, wrappers) -> dict:
    """One synchronous run of phase 12: a sharded server and a
    single-device one (a comparison: its launches are not counted), both
    starting at SHARD_CAP slots, fed the same ingest and traffic; the
    checks of the phase on it. Returns ms/request of both."""
    from repro_torch.serve.ctr_server import CTRServer
    from repro_torch.serve.profiler import MemoryLedger

    users, h, requests, events = traffic
    srv = CTRServer.build(model, None, "decoupled", mesh=mesh, capacity=SHARD_CAP, fused=fused,
                          table_dtype=dtype, device=dev)
    store = srv.bse.store
    ledger = MemoryLedger()
    ledger.attach(store)
    inputs = KernelInputs(torch)
    model.engine.profiler = inputs
    t0 = time.perf_counter()
    ingest_all(srv.bse, users, h)
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    model.engine.profiler = None
    with uncounted():
        ref = CTRServer.build(model, None, "decoupled", capacity=SHARD_CAP, fused=fused,
                              table_dtype=dtype, device=dev)
        ingest_all(ref.bse, users, h)
    load = store.shard_load()
    if max(load) - min(load) > 1 or sum(load) != SHARD_USERS or store.n_grows < 3:
        raise AssertionError(f"sharded {name}: shard load {load}, {store.n_grows} grows")
    model.engine.profiler = inputs
    got, want, times, launches = [], [], {"sharded": [], "single": []}, []
    bursts = [requests[i:i + BURST] for i in range(0, SHARD_REQUESTS, BURST)] * 2
    for b, burst in enumerate(bursts):
        before = {w.__name__: w.launches for w in wrappers}
        t0 = time.perf_counter()
        got.extend(srv.handle_requests(burst))
        times["sharded"].append(1e3 * (time.perf_counter() - t0) / len(burst))
        launches.append({w.__name__: w.launches - before[w.__name__] for w in wrappers})
        with uncounted():
            t0 = time.perf_counter()
            want.extend(ref.handle_requests(burst))
            times["single"].append(1e3 * (time.perf_counter() - t0) / len(burst))
        if b in events:
            before = {w.__name__: w.launches for w in wrappers}
            srv.bse.ingest_events(*events[b])
            fold = {w.__name__: w.launches - before[w.__name__] for w in wrappers}
            with uncounted():
                ref.bse.ingest_events(*events[b])
    model.engine.profiler = None
    torch.cuda.synchronize()
    a, b = np.stack(got), np.stack(want)
    if a.shape != (len(got), C) or not np.isfinite(a).all():
        raise AssertionError(f"sharded {name}: scores {a.shape}, finite {np.isfinite(a).all()}")
    diff = float(np.abs(a - b).max())
    print(f"sharded {name}: {len(got)} requests, max |sharded - single-device| score "
          f"{diff:.3g} (limit {SHARD_TOL})")
    if diff > SHARD_TOL:
        raise AssertionError(f"sharded {name}: scores differ from the single-device server's "
                             f"by {diff}")
    moved = float(np.abs(a[SHARD_REQUESTS:] - a[:SHARD_REQUESTS]).max())
    if moved == 0.0:
        raise AssertionError(f"sharded {name}: the event burst changed no score")
    errs = ledger.verify()
    if errs:
        raise AssertionError(f"sharded {name}: the ledger missed events: {errs}")
    sharded_kernel_checks(torch, name, inputs.calls)
    per_burst = {k: statistics.mean(l[k] for l in launches) for k in launches[0]}
    print(f"sharded {name}: {SHARDS} shards on one card, {store.per_shard_capacity} slots each "
          f"after {store.n_grows} doublings, users per shard {load}; ingest of "
          f"{SHARD_USERS} users in {t_ingest:.2f} s; launches per {BURST}-request burst "
          f"{json.dumps(per_burst)}; per event fold of {EV_USERS} users {json.dumps(fold)}; "
          f"ledger {ledger.report()}")
    ms = {k: steady(v) for k, v in times.items()}
    print(f"sharded {name}: ms/request (host) sharded {json.dumps(ms['sharded'])}, "
          f"single-device {json.dumps(ms['single'])} — {SHARDS} launches a dispatch on one "
          f"card, not a speed across GPUs")
    del srv, ref, inputs
    torch.cuda.empty_cache()
    return ms


def sharded_tiered_run(torch, dev, model, mesh, traffic, tmp) -> None:
    """Phase 12's tiered run: a sharded hot tier (hot PROD_HOT users over
    SHARDS shards, warm PROD_WARM, cold segments) with async ingest, fused
    fp32; the histories and single events go through the queue. After a
    flush, a check burst across the tiers scores bit for bit as a
    synchronous, untiered single-device server fed the same folds, and as
    the server restored from a snapshot onto SHARDS shards; the ledger
    verifies; the shards stay balanced."""
    from repro_torch.serve.bse_server import BSEServer
    from repro_torch.serve.ctr_server import CTRServer
    from repro_torch.serve.profiler import MemoryLedger

    users, h, requests, events = traffic
    srv = CTRServer.build(model, None, "decoupled", mesh=mesh, fused=True,
                          hot_capacity=PROD_HOT, warm_capacity=PROD_WARM,
                          store_dir=os.path.join(tmp, "cold"), async_ingest=True,
                          queue_depth=4 * SHARD_USERS, device=dev)
    bse, rt, store = srv.bse, srv.bse.async_ingest, srv.bse.store
    ledger = MemoryLedger()
    ledger.attach(store)
    log = record_folds(bse.ingestor)
    rt.start()
    ingest_all(bse, users, h)
    bursts = [requests[i:i + BURST] for i in range(0, SHARD_REQUESTS, BURST)] * 2
    for b, burst in enumerate(bursts):
        scores = srv.handle_requests(burst)
        if any(x is None or not np.isfinite(x).all() for x in scores):
            raise AssertionError("sharded tiered: a shed or non-finite score")
        if b in events:
            ev_users, ev_i, ev_c = events[b]
            bse.ingest_events(ev_users, ev_i[:, 0], ev_c[:, 0])
    rt.flush()
    pick = np.unique(np.linspace(0, SHARD_USERS - 1, BURST).astype(int))
    check = [(users[u], {k: h[k][u:u + 1] for k in ("hist_items", "hist_cats", "hist_mask")},
              requests[0][2], requests[0][3], requests[0][4]) for u in pick]
    tiers = sorted({str(store.tier(r[0])) for r in check})
    for _ in range(4):        # a promotion may demote another user of the burst
        misses = bse.stats.n_misses
        before = srv.handle_requests(check)
        rt.flush()
        if bse.stats.n_misses == misses:
            break
    else:
        raise AssertionError("sharded tiered: the check burst still missed users after four "
                             "flushes")
    if rt.stop() is not True or rt.error is not None:
        raise AssertionError("sharded tiered: the writer thread did not stop cleanly")
    errs = ledger.verify()
    load = store.hot.shard_load()
    if errs or max(load) - min(load) > 1:
        raise AssertionError(f"sharded tiered: ledger {errs}, hot shard load {load}")
    with uncounted():
        ref = CTRServer.build(model, None, "decoupled", fused=True, capacity=SHARD_USERS,
                              device=dev)
        for fold, args in log:
            getattr(ref.bse.ingestor, fold)(*args)
        same_scores("sharded tiered vs a synchronous untiered single-device server", before,
                    ref.handle_requests(check))
        del ref
        snap = bse.snapshot(os.path.join(tmp, "snapshot"))
        back = BSEServer.restore(snap, bse.ingestor.embed_fn, model, model.engine, mesh=mesh,
                                 device=dev)
        if not (back.store.sharded and back.store.n_shards == SHARDS):
            raise AssertionError("sharded tiered: the restored store is not sharded")
        restored = CTRServer(model, back, mode="decoupled", fused=True)
        same_scores("sharded tiered snapshot -> restore", restored.handle_requests(check),
                    before)
    ts = store.stats
    print(f"sharded tiered: check burst across tiers {tiers} bit for bit as a synchronous "
          f"untiered single-device server replaying {len(log)} folds, and after snapshot -> "
          f"restore onto {SHARDS} shards; tiers {store.tier_sizes()} (hot cap "
          f"{store.hot_capacity}), hot users per shard {load}, {ts.demotions} demotions, "
          f"{ts.warm_promotions} warm + {ts.cold_promotions} cold promotions; "
          f"{ledger.report()}")


def sharded_phase(torch, dev, wrappers):
    """Phase 12: sdim-paper FULL (the seeded model of phases 4-5) with its
    BSE store over SHARDS shards on this one card (``MeshCtx((dev,) *
    SHARDS)``): fp32 fused, int8 fused and unfused (bf16 wire) against
    single-device servers, ``serve_sharded`` against ``serve``, then a
    tiered async run with snapshot -> restore. Returns the phase's launch
    counts."""
    import shutil
    import tempfile
    from repro_torch.configs import sdim_paper
    from repro_torch.distributed.mesh_ctx import MeshCtx
    from repro_torch.models.ctr import CTRModel

    model = CTRModel(sdim_paper.FULL, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    mesh = MeshCtx((dev,) * SHARDS)
    traffic = sharded_traffic(model.cfg)
    users, h, requests, events = traffic
    t0 = time.perf_counter()
    redrawn = screen_sharded(torch, model, requests, events)
    print(f"sharded: {redrawn} item rows redrawn to clear the hash margin "
          f"({time.perf_counter() - t0:.1f} s); {SHARDS} shards on {mesh.devices[0]} "
          f"({torch.cuda.get_device_name(dev)}; {card_line()})")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        reset(wrappers)
        ms = {}
        for name, dtype, fused in (("fp32-fused", "fp32", True), ("int8-fused", "int8", True),
                                   ("unfused", "fp32", False)):
            ms[name] = sharded_run(torch, dev, model, mesh, traffic, name, dtype, fused,
                                   wrappers)
        # serve_sharded: the first burst's users split over the shards
        burst = requests[:BURST]
        with torch.no_grad():
            t = lambda x: torch.as_tensor(np.asarray(x), device=dev)
            q = model._embed_behaviors(t(np.stack([r[2] for r in burst])),
                                       t(np.stack([r[3] for r in burst])))
            seq = model._embed_behaviors(t(h["hist_items"][:BURST]), t(h["hist_cats"][:BURST]))
            mask = t(h["hist_mask"][:BURST])
            got = model.engine.serve_sharded(q, seq, mask, mesh=mesh)
            with uncounted():
                want = model.engine.serve(q, seq, mask)
        diff = float((got - want).abs().max())
        print(f"sharded: serve_sharded ({BURST} users over {SHARDS} shards) vs serve, max abs "
              f"diff {diff:.3g} (limit {SHARD_TOL})")
        if diff > SHARD_TOL:
            raise AssertionError(f"sharded: serve_sharded differs from serve by {diff}")
        sharded_tiered_run(torch, dev, model, mesh, traffic, tmp)
        launches = read_launches(wrappers, ("bse_encode", "sdim_update", "sdim_fused_serve",
                                            "sdim_query", "bse_serve"), "sharded")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"sharded ms/request (host, median [min-max] of {2 * SHARD_REQUESTS // BURST} "
          f"bursts): {json.dumps(ms)}")
    del model
    torch.cuda.empty_cache()
    return launches


def token_ms(step, timed: int = LM_TIMED, warm: int = LM_WARM) -> dict:
    """ms per token of ``step()`` (which returns logits): host clock around
    one step ending in ``.item()`` of its argmax, median [min, max] of
    ``timed`` steps after ``warm``; and ``issue_ms``, the median host time
    until ``step()`` returns, before the wait: the time the host takes to
    issue the step's work (the whole step where the card keeps up with
    it)."""
    for _ in range(warm):
        step().argmax().item()
    times, issue = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        out = step()
        issue.append(1e3 * (time.perf_counter() - t0))
        out.argmax().item()
        times.append(1e3 * (time.perf_counter() - t0))
    return dict(ms=statistics.median(times), min=min(times), max=max(times),
                issue_ms=statistics.median(issue))


def logits_close(torch, name, got, want, tol=LM_TOL) -> float:
    """max |got - want| / max |want|; fails above ``tol`` or where not finite."""
    rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    if not bool(torch.isfinite(got).all()) or not rel <= tol:
        raise AssertionError(f"lm {name}: logits differ by {rel:.3g} of the largest "
                             f"(limit {tol})")
    print(f"lm {name}: max |d logit| / max |logit| = {rel:.3g} (limit {tol})")
    return rel


def next_token_overlap(torch, exact, compressed) -> tuple:
    """The overlap of the last next-token distributions of the exact and
    SDIM paths, and of their top 10 (an approximation: no limit)."""
    pe, ps = torch.softmax(exact[-1], -1), torch.softmax(compressed[-1], -1)
    top10 = len(set(torch.topk(pe, 10).indices.tolist())
                & set(torch.topk(ps, 10).indices.tolist()))
    return float(torch.minimum(pe, ps).sum()), top10


def exact_layouts(torch, cache, g, Gq: int, layer_row_bytes: int) -> dict:
    """One layer's exact decode read at the longest cache length (scores,
    fp32 softmax, weighted sum of values, for one token's query heads): the
    port's (head-major (B, Hkv, S, D), the sum split over rows by
    ``nn/attention._weighted_values``) against the head-major layout with
    one product over all rows and the reference's token-major (B, S, Hkv,
    D) einsums, on the same rows; CUDA event ms (each timed twice, in
    mirrored order; the least of each pair) beside the bound of reading the
    rows once."""
    import math
    from repro_torch.nn.attention import _weighted_values
    n = LM_CACHE_LENS[-1] + 1
    kh, vh = cache["stack"]["k"][0, :, :, :n], cache["stack"]["v"][0, :, :, :n]
    B, Hkv, _, D = kh.shape
    kt, vt = kh.transpose(1, 2).contiguous(), vh.transpose(1, 2).contiguous()
    q = torch.randn((B, 1, Hkv, Gq, D), generator=g, device=kh.device)

    def head_major(weighted):
        def read():
            scores = torch.matmul(q.reshape(B, Hkv, Gq, D), kh.transpose(-1, -2)) / math.sqrt(D)
            return weighted(torch.softmax(scores, -1), vh).reshape(B, 1, Hkv * Gq * D)
        return read

    def token_major():
        scores = torch.einsum("btkgd,bskd->bkgts", q, kt) / math.sqrt(D)
        out = torch.einsum("bkgts,bskd->btkgd", torch.softmax(scores, -1), vt)
        return out.reshape(B, 1, Hkv * Gq * D)

    reads = {"port": head_major(_weighted_values), "head_major_one_product":
             head_major(torch.matmul), "token_major": token_major}
    want = token_major()
    out = dict(cache_len=n - 1, bound_ms=1e3 * n * layer_row_bytes / HBM)
    for name, read in reads.items():
        rel = float((read() - want).abs().max() / want.abs().max())
        if not rel <= 1e-5:
            raise AssertionError(f"lm exact read: {name} and token-major differ by {rel:.3g}")
        out[f"{name}_max_rel_diff"] = rel
    order = list(reads) + list(reads)[::-1]
    for name, ms in zip(order, [time_ms(reads[k], iters=10) for k in order]):
        out[f"{name}_ms"] = min(ms, out.get(f"{name}_ms", ms))
    print(f"lm exact read, one layer at cache_len {n - 1} (CUDA events): the port's "
          f"{out['port_ms']:.4f} ms, head-major one product {out['head_major_one_product_ms']:.4f} "
          f"ms, token-major {out['token_major_ms']:.4f} ms; bound {out['bound_ms']:.4f} ms (the "
          f"rows read once)")
    del kt, vt
    return out


SEQ_AXIS = {"k": 3, "v": 3, "ckv": 2, "krope": 2}     # S in a stack cache (L, B, ...)


def sp_decode_check(torch, phase, arch_id, model, cache, tok, n: int, ctx) -> dict:
    """Phases 13 and 14 (f): ``sp_decode_step`` at position ``n`` of
    ``cache`` (only read) against ``decode_step``'s logits there (which
    writes row n) within LM_TOL of the largest; the new token's rows
    against the rows ``decode_step`` writes, the first block's bit for bit
    (it sees the same input on both paths) and every block's within LM_TOL
    of the largest; then ms/token of the split-KV step."""
    shards = ctx.axis_size(ctx.seq_axes)
    with torch.no_grad():
        logits, new = model.sp_decode_step(tok, cache, n, ctx)
        exact, _ = model.decode_step(tok, cache, n)
        rel = logits_close(torch, f"{arch_id} (f) split-KV decode over {shards} sequence "
                           f"shards at cache_len {n} vs exact", logits, exact)
        pairs = []                                # (the first block's, got, written)
        for i, rows in enumerate(new.get("dense", [])):
            for name, r in rows.items():
                pairs.append((i == 0, r[:, 0], cache["dense"][i][name].select(
                    SEQ_AXIS[name] - 1, n)))
        for name, r in new["stack"].items():
            written = cache["stack"][name].select(SEQ_AXIS[name], n)
            pairs.append((False, r[:, :, 0], written))
            if "dense" not in new:
                pairs.append((True, r[0, :, 0], written[0]))
        kv_rel = 0.0
        for first, got, want in pairs:
            err = float((got - want).abs().max() / want.abs().max())
            kv_rel = max(kv_rel, err)
            if (first and not torch.equal(got, want)) or not err <= LM_TOL:
                raise AssertionError(f"{phase} {arch_id} (f): the new token's rows differ from "
                                     f"those decode_step writes by {err:.3g} of the largest")
        timed = token_ms(lambda: model.sp_decode_step(tok, cache, n, ctx)[0], SP_TIMED, SP_WARM)
    print(f"{phase} {arch_id} (f) split-KV decode, cache_len {n}: the new k/v rows equal "
          f"decode_step's (first block bit for bit; all within {kv_rel:.3g} of the largest); "
          f"ms/token "
          f"{timed['ms']:.3f} [{timed['min']:.3f}-{timed['max']:.3f}] (median of {SP_TIMED} "
          f"after {SP_WARM}), host issue {timed['issue_ms']:.3f} ms ({shards} shards on one "
          f"card: not a speed across GPUs)")
    return dict(rel=rel, kv_rel=kv_rel, **timed)


def lm_phase(torch, dev, wrappers):
    """Phase 13: qwen3-8b FULL (8,190,735,360 parameters, fp32) on the card
    with the port's init (seed 0) and R (seed 1234): (a) a prefill of
    LM_PREFILL tokens on the chunked path against the masked path; (b)
    LM_DECODE tokens of exact decode from an empty cache against the
    forward pass over the same tokens; (c) the same tokens through the
    SDIM-compressed path (layer 0's count table equal to the offline
    encode of (b)'s cache, its value table within 1e-4; finite logits;
    the next-token overlaps printed); (d) sdim_query at the path's call
    against its plain version; (e) ms/token and the bound of each; (f)
    split-KV decode over SP_SHARDS sequence shards against exact. Returns
    the path's launch counts and sdim_query's timing at the LM shape."""
    import gc
    from repro_torch.configs import qwen3_8b
    from repro_torch.kernels.screen import screened_normal
    from repro_torch.models.lm import LMModel

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"lm: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the phase "
          f"({torch.cuda.get_device_name(dev)}; {card_line()})")
    cfg = qwen3_8b.FULL
    t0 = time.perf_counter()
    model = LMModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"lm: qwen3-8b FULL init {time.perf_counter() - t0:.2f} s, {n_params:,} parameters "
          f"({4 * n_params / 2**30:.2f} GiB fp32), max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if n_params != LM_PARAMS:
        raise AssertionError(f"lm: qwen3-8b FULL has {n_params} parameters, not {LM_PARAMS}")
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (1, LM_PREFILL), generator=g, device=dev)
    reset(wrappers)
    with torch.no_grad():
        # (a) the chunked prefill (T >= 2 * q_chunk) against the masked path
        for label, q_chunk in (("chunked", 1024), ("masked", LM_PREFILL + 1)):
            for block in model.stack:
                block.attn.q_chunk = q_chunk
            t0 = time.perf_counter()
            out = model.prefill(tokens)
            torch.cuda.synchronize()
            print(f"lm prefill {LM_PREFILL} tokens, {label} path: "
                  f"{time.perf_counter() - t0:.3f} s (first call)")
            if label == "chunked":
                chunked = out
        logits_close(torch, f"(a) prefill chunked vs masked at T = {LM_PREFILL}", chunked, out)
        for block in model.stack:
            block.attn.q_chunk = 1024
        # (b) exact decode of the first LM_DECODE tokens from an empty cache
        cache = model.init_cache(1, LM_DECODE, torch.float32)
        exact = torch.cat([model.decode_step(tokens[:, i:i + 1], cache, i)[0][0]
                           for i in range(LM_DECODE)])
        hidden, _ = model(tokens[:, :LM_DECODE])
        logits_close(torch, f"(b) exact decode of {LM_DECODE} tokens vs their forward",
                     exact, model._logits(hidden)[0])
        del hidden
        # (c) the same tokens through the SDIM-compressed KV
        sc = model.init_sdim_cache(1)
        compressed = torch.cat([model.sdim_decode_step(tokens[:, i:i + 1], sc)[0][0]
                                for i in range(LM_DECODE)])
        torch.cuda.synchronize()
        if not bool(torch.isfinite(compressed).all()):
            raise AssertionError("lm (c): SDIM decode gave non-finite logits")
        enc = model.encode_sdim_cache_from_kv(cache)
        again = model.encode_sdim_cache_from_kv(cache)
        if not (enc["vt"].equal(again["vt"]) and enc["ct"].equal(again["ct"])):
            raise AssertionError("lm (c): two offline encodes of one cache differ")
        if not sc["ct"][0].equal(enc["ct"][0]):
            raise AssertionError(f"lm (c): layer 0's count table differs from the offline "
                                 f"encode in {int((sc['ct'][0] != enc['ct'][0]).sum())} cells")
        vt_err = float((sc["vt"][0] - enc["vt"][0]).abs().max())
        if not vt_err <= 1e-4:
            raise AssertionError(f"lm (c): layer 0's value table differs by {vt_err:.3g}")
        overlap, top10 = next_token_overlap(torch, exact, compressed)
        print(f"lm (c) SDIM decode of {LM_DECODE} tokens: finite; layer 0 count table equals "
              f"the offline encode ({int(sc['ct'][0].sum())} keys), value table within "
              f"{vt_err:.3g}; next-token overlap exact vs SDIM {overlap:.4f}, top-10 overlap "
              f"{top10}/10 (an approximation: no limit)")
        del enc, again
    launches = read_launches(wrappers, ("sdim_query",), "lm")
    per_step = launches["sdim_query"] / LM_DECODE
    print(f"lm: sdim_query launches per SDIM step {per_step:g} ({cfg.n_layers} layers)")

    # (d) kernel 4 at the path's call: (B * Hkv, Gq, head_dim) against the
    # last layer's table, on screened queries
    Gq = cfg.n_heads // cfg.n_kv_heads
    q = torch.from_numpy(screened_normal(np.random.default_rng(13), (cfg.n_kv_heads, Gq,
                                                                     cfg.head_dim),
                                         model.R.cpu().numpy())).to(dev)
    table = sc["vt"][-1].reshape(cfg.n_kv_heads, *sc["vt"].shape[3:]).contiguous()
    kq = query_at_call(torch, "lm", q, table, model.R, cfg.sdim_tau)

    # (e) ms/token: exact at each cache length of an LM_MAX_LEN-row cache of
    # random values, and SDIM; each beside its bound (bytes: every weight
    # read once, one row of the token embedding, the cache rows attended)
    del cache
    torch.cuda.empty_cache()
    cache = model.init_cache(1, LM_MAX_LEN, torch.float32)
    for t in cache["stack"].values():
        t.normal_(generator=g)
    exact_bytes = sum(t.numel() * t.element_size() for t in cache["stack"].values())
    sdim_bytes = {k: sc[k].numel() * sc[k].element_size() for k in ("vt", "ct")}
    w_bytes = 4 * (n_params - cfg.vocab * cfg.d_model + cfg.d_model)
    row_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 4
    print(f"lm cache bytes: exact at {LM_MAX_LEN} rows {exact_bytes:,} B; SDIM "
          f"{sdim_bytes['vt']:,} + {sdim_bytes['ct']:,} B (vt + ct, any length)")
    tok = tokens[:, :1]
    timed = {}
    with torch.no_grad():
        for n in LM_CACHE_LENS:
            step = lambda n=n: model.decode_step(tok, cache, n)[0]
            timed[f"exact@{n}"] = dict(token_ms(step),
                                       bound_ms=1e3 * (w_bytes + (n + 1) * row_bytes) / HBM,
                                       all_params_bound_ms=1e3 * (4 * n_params + (n + 1) *
                                                                  row_bytes) / HBM)
            timed[f"exact@{n}"]["profile"] = profile_window(
                torch, f"lm exact decode step at cache_len {n}", step)
        step = lambda: model.sdim_decode_step(tok, sc)[0]
        timed["sdim"] = dict(token_ms(step),
                             bound_ms=1e3 * (w_bytes + sum(sdim_bytes.values())) / HBM,
                             all_params_bound_ms=1e3 * (4 * n_params
                                                        + sum(sdim_bytes.values())) / HBM)
        timed["sdim"]["profile"] = profile_window(torch, "lm SDIM decode step", step)
        layout = exact_layouts(torch, cache, g, Gq, row_bytes // cfg.n_layers)
    for name, r in timed.items():
        ops = r["profile"]["device_ops"] if r["profile"] else None
        per_op = "not measured" if not ops else f"{1e3 * r['issue_ms'] / ops:.1f} us"
        print(f"lm ms/token {name}: {r['ms']:.3f} [{r['min']:.3f}-{r['max']:.3f}] (host clock to "
              f".item(), median of {LM_TIMED} after {LM_WARM}); host issue {r['issue_ms']:.3f} "
              f"ms a step ({ops} device ops: {per_op} an op); bound {r['bound_ms']:.3f} ms "
              f"(every weight once, one embedding row, the cache read), "
              f"{r['all_params_bound_ms']:.3f} ms counting the whole embedding table; "
              f"{r['bound_ms'] / r['ms']:.1%} of the bound")
    # (f) split-KV decode over SP_SHARDS sequence shards on this card
    from repro_torch.distributed.mesh_ctx import MeshCtx
    ctx = MeshCtx((dev,) * SP_SHARDS, data_axes=None, seq_axes=("model",))
    for n in LM_CACHE_LENS:
        timed[f"sp@{n}"] = sp_decode_check(torch, "lm", "qwen3-8b", model, cache, tok, n, ctx)
        print(f"lm (f) ms/token at cache_len {n}: split-KV {timed[f'sp@{n}']['ms']:.3f}, exact "
              f"{timed[f'exact@{n}']['ms']:.3f}")
    print(f"lm: max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{card_line()}")
    print(f"lm ms/token: {json.dumps(timed)}")
    print(f"lm exact read layouts: {json.dumps(layout)}")
    del model, cache, sc
    gc.collect()
    torch.cuda.empty_cache()
    return launches, kq


def set_capacity_factor(model, factor) -> None:
    """Every MoELayer's capacity factor (None: each one's n_experts / top_k,
    the factor at which no expert can drop a token)."""
    from repro_torch.nn.moe import MoELayer
    for m in model.modules():
        if isinstance(m, MoELayer):
            m.capacity_factor = m.n_experts / m.top_k if factor is None else factor


def cache_row_bytes(cfg) -> int:
    """Bytes of one position's exact cache over every layer (fp32)."""
    per_layer = (cfg.kv_lora_rank + cfg.rope_head_dim if cfg.attention == "mla"
                 else 2 * cfg.n_kv_heads * cfg.head_dim)
    return 4 * cfg.n_layers * per_layer


def moe_mla_arch(torch, dev, wrappers, arch_id, cfg, g) -> tuple[dict, dict]:
    """Phase 14 for one arch (module docstring, (a)-(f)); returns its
    checks and timings, with sdim_query's at its call under ``kq``, and the
    launch counts of its path, read after its SDIM decode."""
    import gc
    from repro_torch.distributed.mesh_ctx import MeshCtx
    from repro_torch.kernels.screen import screened_normal
    from repro_torch.models.lm import LMModel
    from repro_torch.kernels.sdim_query.sdim_query import sdim_query

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LMModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"moe_mla {arch_id} ({cfg.n_layers} layers, first_k_dense {cfg.first_k_dense}, "
          f"{cfg.attention}, {cfg.moe['n_experts']} experts top-{cfg.moe['top_k']}): init "
          f"{time.perf_counter() - t0:.2f} s, {n_params:,} parameters "
          f"({4 * n_params / 2**30:.2f} GiB fp32)")
    if n_params != MOE_PARAMS[arch_id]:
        raise AssertionError(f"moe_mla: {arch_id} has {n_params} parameters, not "
                             f"{MOE_PARAMS[arch_id]}")
    blocks = [*model.dense_blocks, *model.stack]
    tokens = torch.randint(0, cfg.vocab, (1, LM_PREFILL), generator=g, device=dev)
    out = {}
    reset(wrappers)
    with torch.no_grad():
        # (a) the chunked prefill (T >= 2 * q_chunk) against the masked path
        for label, q_chunk in (("chunked", 1024), ("masked", LM_PREFILL + 1)):
            for block in blocks:
                block.attn.q_chunk = q_chunk
            t0 = time.perf_counter()
            logits = model.prefill(tokens)
            torch.cuda.synchronize()
            print(f"moe_mla {arch_id} prefill {LM_PREFILL} tokens, {label} path: "
                  f"{time.perf_counter() - t0:.3f} s")
            if label == "chunked":
                chunked = logits
        out["prefill_rel"] = logits_close(torch, f"{arch_id} (a) prefill chunked vs masked",
                                          chunked, logits)
        for block in blocks:
            block.attn.q_chunk = 1024
        # (b) exact decode against the forward, no expert dropping a token
        toks = tokens[:, :MOE_DECODE]
        cache = model.init_cache(1, MOE_DECODE, torch.float32)
        exact = torch.cat([model.decode_step(toks[:, i:i + 1], cache, i)[0][0]
                           for i in range(MOE_DECODE)])
        set_capacity_factor(model, None)
        hidden, aux = model(toks)
        set_capacity_factor(model, 1.25)
        out["decode_rel"] = logits_close(
            torch, f"{arch_id} (b) exact decode of {MOE_DECODE} tokens vs their forward "
            f"(capacity factor n_experts / top_k)", exact, model._logits(hidden)[0], MOE_TOL)
        del hidden, cache
        # (c) the same tokens through the SDIM-compressed KV
        before = sdim_query.launches
        sc = model.init_sdim_cache(1)
        compressed = torch.cat([model.sdim_decode_step(toks[:, i:i + 1], sc)[0][0]
                                for i in range(MOE_DECODE)])
        torch.cuda.synchronize()
        launched = sdim_query.launches - before
        launches = read_launches(wrappers, ("sdim_query",), f"moe_mla {arch_id}")
        if not bool(torch.isfinite(compressed).all()):
            raise AssertionError(f"moe_mla {arch_id} (c): SDIM decode gave non-finite logits")
        if launched != MOE_DECODE * cfg.n_scan_layers:
            raise AssertionError(f"moe_mla {arch_id} (c): {launched} sdim_query launches, not "
                                 f"{cfg.n_scan_layers} a token")
        overlap, top10 = next_token_overlap(torch, exact, compressed)
        out.update(sdim_query_per_token=launched / MOE_DECODE, overlap=overlap, top10=top10)
    # (d) kernel 4 at the path's call against the first scanned layer's
    # table, on screened queries: (Hkv, Gq, head_dim), or for MLA all H heads
    # against the one latent table, (1, H, kv_lora_rank), and at B = 8
    rng = np.random.default_rng(14)
    Rn, tau = model.R.cpu().numpy(), cfg.sdim_tau
    if cfg.attention == "mla":
        table = sc["vt"][0].reshape(1, *sc["vt"].shape[3:]).contiguous()
        q = torch.from_numpy(screened_normal(rng, (1, cfg.n_heads, cfg.kv_lora_rank),
                                             Rn)).to(dev)
        q8 = torch.from_numpy(screened_normal(rng, (8, cfg.n_heads, cfg.kv_lora_rank),
                                              Rn)).to(dev)
        t8 = torch.from_numpy(rng.standard_normal((8, *table.shape[1:])).astype(
            np.float32)).to(dev)
        extra = (("B = 8", q8, t8),)
    else:
        table = sc["vt"][0].reshape(cfg.n_kv_heads, *sc["vt"].shape[3:]).contiguous()
        q = torch.from_numpy(screened_normal(
            rng, (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim), Rn)).to(dev)
        extra = ()
    out["kq"] = query_at_call(torch, f"moe_mla {arch_id}", q, table, model.R, tau, extra)
    path = out["kq"]["path"]
    # (e) ms/token: exact at MOE_CACHE_LEN of a cache of random values, and SDIM
    with torch.no_grad():
        # rows for cache_len MOE_CACHE_LEN, in a length SP_SHARDS divides
        cache = model.init_cache(1, MOE_CACHE_LEN + SP_SHARDS, torch.float32)
        for t in [*cache["stack"].values(), *(v for c in cache.get("dense", ()) for v in
                                              c.values())]:
            t.normal_(generator=g)
        w_bytes = 4 * (n_params - cfg.vocab * cfg.d_model + cfg.d_model)
        sdim_bytes = sum(sc[k].numel() * sc[k].element_size() for k in ("vt", "ct"))
        tok = toks[:, :1]
        timing_sc = {k: v.clone() if torch.is_tensor(v) else v for k, v in sc.items()}
        steps = {f"exact@{MOE_CACHE_LEN}": (lambda: model.decode_step(tok, cache,
                                                                      MOE_CACHE_LEN)[0],
                                            (MOE_CACHE_LEN + 1) * cache_row_bytes(cfg)),
                 "sdim": (lambda: model.sdim_decode_step(tok, timing_sc)[0], sdim_bytes)}
        timed = {}
        for name, (step, read) in steps.items():
            timed[name] = dict(token_ms(step), bound_ms=1e3 * (w_bytes + read) / HBM,
                               weight_bytes=w_bytes, cache_bytes=read)
            timed[name]["profile"] = profile_window(torch, f"moe_mla {arch_id} {name} step",
                                                    step)
        # (f) split-KV decode, the experts expert-parallel, nothing dropped
        set_capacity_factor(model, None)
        ctx = MeshCtx((dev,) * SP_SHARDS, data_axes=None, seq_axes=("model",))
        out["sp"] = sp_decode_check(torch, "moe_mla", arch_id, model, cache, tok,
                                    MOE_CACHE_LEN, ctx)
        if arch_id == "deepseek-moe-16b":
            out["ep_layer"] = ep_layer_check(torch, dev, model.stack[0].ffn, g)
        set_capacity_factor(model, 1.25)
        del cache, timing_sc
        # (c) the first scanned layer's tables against the offline encode of an
        # exact cache decoded with the dense blocks passing their input through
        for block in model.dense_blocks:
            block.attn.wo.weight.zero_()
            block.ffn.wo.weight.zero_()
        cache = model.init_cache(1, MOE_DECODE, torch.float32)
        for i in range(MOE_DECODE):
            model.decode_step(toks[:, i:i + 1], cache, i)
        enc = model.encode_sdim_cache_from_kv(cache)
        if not sc["ct"][0].equal(enc["ct"][0]):
            raise AssertionError(f"moe_mla {arch_id} (c): the first scanned layer's count "
                                 f"table differs from the offline encode in "
                                 f"{int((sc['ct'][0] != enc['ct'][0]).sum())} cells")
        vt_err = float((sc["vt"][0] - enc["vt"][0]).abs().max())
        if not vt_err <= 1e-4:
            raise AssertionError(f"moe_mla {arch_id} (c): the first scanned layer's value "
                                 f"table differs by {vt_err:.3g}")
        del cache, enc
    print(f"moe_mla {arch_id} (c) SDIM decode of {MOE_DECODE} tokens: finite; sdim_query "
          f"{out['sdim_query_per_token']:g} launches a token on its {path} path; the first "
          f"scanned layer's count table equals the offline encode "
          f"({int(sc['ct'][0].sum())} keys), value table within {vt_err:.3g}; next-token "
          f"overlap exact vs SDIM {overlap:.4f}, top-10 {top10}/10 (an approximation: no "
          f"limit)")
    for name, r in timed.items():
        ops = r["profile"]["device_ops"] if r["profile"] else None
        per_op = "not measured" if not ops else f"{1e3 * r['issue_ms'] / ops:.1f} us"
        print(f"moe_mla {arch_id} ms/token {name}: {r['ms']:.3f} [{r['min']:.3f}-"
              f"{r['max']:.3f}] (host clock to .item(), median of {LM_TIMED} after "
              f"{LM_WARM}); host issue {r['issue_ms']:.3f} ms a step ({ops} device ops: "
              f"{per_op} an op); bound {r['bound_ms']:.3f} ms ({r['weight_bytes']:,} B of "
              f"weights, every expert, + {r['cache_bytes']:,} B of cache); "
              f"{r['bound_ms'] / r['ms']:.1%} of the bound")
    print(f"moe_mla {arch_id} (f) ms/token at cache_len {MOE_CACHE_LEN}: split-KV "
          f"{out['sp']['ms']:.3f}, exact {timed[f'exact@{MOE_CACHE_LEN}']['ms']:.3f}")
    out.update(timed=timed, vt_err=vt_err,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"moe_mla {arch_id}: max_memory_allocated {out['peak_gib']:.2f} GiB; {card_line()}")
    return out, launches


def ep_layer_check(torch, dev, layer, g) -> dict:
    """Phase 14 (f): one MoE layer at EP_B x EP_T tokens over
    ``MeshCtx((cuda:0,) * 4, data=2)`` (two data groups of EP_B / 2 rows,
    the experts over 4 shards) against the one-device path, the output
    within EP_TOL of the largest, the aux loss equal."""
    from repro_torch.distributed.mesh_ctx import MeshCtx

    mesh = MeshCtx((dev,) * 4, data=2)
    x = torch.randn((EP_B, EP_T, layer.d_model), generator=g, device=dev)
    with torch.no_grad():
        y, aux = layer(x)
        y_ep, aux_ep = layer(x, mesh=mesh)
        rel = float((y_ep - y).abs().max() / y.abs().max())
    if not rel <= EP_TOL or not torch.equal(aux, aux_ep):
        raise AssertionError(f"moe_mla (f): the expert-parallel MoE layer differs from one "
                             f"device by {rel:.3g} of the largest (limit {EP_TOL}); aux "
                             f"{float(aux_ep)} vs {float(aux)}")
    print(f"moe_mla (f) one MoE layer, B = {EP_B} x {EP_T} tokens over {mesh.dp} data groups "
          f"and {mesh.ep} expert shards ({layer.n_experts // mesh.ep} experts each): within "
          f"{rel:.3g} of the one-device output (limit {EP_TOL}), aux loss equal")
    return dict(rel=rel, dp=mesh.dp, ep=mesh.ep)


def moe_mla_phase(torch, dev, wrappers):
    """Phase 14: deepseek-moe-16b FULL and deepseek-v2-236b at full width,
    MOE_V2_LAYERS layers (module docstring). Returns the path's launch
    counts (each arch's SDIM decode, summed) and sdim_query's timings at
    the two calls, ``moe`` and ``mla``."""
    from repro_torch.configs import deepseek_moe_16b, deepseek_v2_236b

    t_phase = time.perf_counter()
    print(f"moe_mla: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the "
          f"phase ({torch.cuda.get_device_name(dev)}; {card_line()})")
    g = torch.Generator(device=dev).manual_seed(1)
    runs, launches = {}, {}
    for arch_id, cfg in (("deepseek-moe-16b", deepseek_moe_16b.FULL),
                         ("deepseek-v2-236b", dataclasses.replace(deepseek_v2_236b.FULL,
                                                                  n_layers=MOE_V2_LAYERS))):
        runs[arch_id], counts = moe_mla_arch(torch, dev, wrappers, arch_id, cfg, g)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    print(f"moe_mla path launches (both archs' SDIM decode): {json.dumps(launches)}")
    kq = {"moe": runs["deepseek-moe-16b"].pop("kq"), "mla": runs["deepseek-v2-236b"].pop("kq")}
    summary = {arch: {k: v for k, v in r.items() if k != "timed"} for arch, r in runs.items()}
    print(f"moe_mla checks: {json.dumps(summary)}")
    print(f"moe_mla ms/token: {json.dumps({a: r['timed'] for a, r in runs.items()})}")
    del runs
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    print(f"moe_mla: phase wall time {time.perf_counter() - t_phase:.1f} s; {card_line()}")
    return launches, kq


def free_card(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def lm_model(torch, dev, cfg, arch_id, params=None):
    """An LMModel of ``cfg`` on the card from the port's init (seed 0),
    its parameter count checked against ``params``."""
    from repro_torch.models.lm import LMModel

    t0 = time.perf_counter()
    model = LMModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    print(f"lm_train {arch_id} ({cfg.n_layers} layers, remat {cfg.remat!r}): init "
          f"{time.perf_counter() - t0:.2f} s, {n:,} parameters ({4 * n / 2**30:.2f} GiB fp32)")
    if params is not None and n != params:
        raise AssertionError(f"lm_train: {arch_id} has {n} parameters, not {params}")
    return model


def lm_train_run(model, batch, seq, steps, stream=None):
    """``steps`` AdamW steps of ``launch.train.lm_setup`` through
    ``train.loop.run`` (``stream``: its own unless given); fails on a
    non-finite loss. Returns (run's output, the losses, the step times in
    ms)."""
    from repro_torch.launch.train import lm_setup
    from repro_torch.train.loop import LoopConfig, run

    loss_fn, own, opt = lm_setup(model.cfg, batch, seq, steps)
    out = run(loss_fn, model, stream or own, opt, LoopConfig(n_steps=steps, log_every=1))
    losses = [m["loss"] for _, m in out["history"]]
    times = [1e3 * m["step_time_s"] for _, m in out["history"]]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"lm_train {model.cfg.name}: losses {losses}")
    return out, losses, times


def same_trained_bits(torch, label, first, second) -> None:
    """Two trained models' parameters must be equal bit for bit."""
    differ = [n for (n, a), (_, b) in zip(first.named_parameters(), second.named_parameters())
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"lm_train (c) {label}: two trainings from one seed differ in "
                             f"{len(differ)} parameters, first {differ[:3]}")
    print(f"lm_train (c) {label}: two trainings of {LMT_REPRO_STEPS} AdamW steps from one seed "
          f"end with the same bits in all {len(list(first.parameters()))} parameters")


def lm_train_granite(torch, dev) -> dict:
    """Phase 15 (a): granite-3-2b FULL trained at LMT_B x LMT_SEQ."""
    from repro_torch.configs import granite_3_2b, registry
    from repro_torch.data.pipeline import DeterministicStream
    from repro_torch.launch import flops
    from repro_torch.launch.train import lm_setup, lm_stream
    from repro_torch.train.loop import make_train_step

    free_card(torch)
    cfg = granite_3_2b.FULL
    model = lm_model(torch, dev, cfg, "granite-3-2b", LMT_GRANITE_PARAMS)
    out, losses, times = lm_train_run(model, LMT_B, LMT_SEQ, LMT_STEPS)
    ms = statistics.median(times[1:])
    shape = registry.LM_SHAPES["train_4k"]
    work = flops.model_flops("granite-3-2b", "train_4k") * LMT_B / shape["global_batch"]
    r = dict(losses=losses, step_ms=times, ms_per_step=ms,
             tokens_per_s=LMT_B * LMT_SEQ / (ms / 1e3), model_flops=work,
             flop_share=work / (ms / 1e3) / FP32_PEAK,
             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"lm_train (a) granite-3-2b FULL, B = {LMT_B} x {LMT_SEQ} tokens (train_4k's length; "
          f"its global batch of {shape['global_batch']} cut to {LMT_B}), remat 'full', fp32, "
          f"AdamW: losses {', '.join(f'{x:.4f}' for x in losses)}; step ms "
          f"{', '.join(f'{t:.1f}' for t in times)}; {ms:.1f} ms/step (median after the first), "
          f"{r['tokens_per_s']:.0f} tokens/s; model flops {work:.4g} a step "
          f"(launch/flops.py: 6 N D + attention) = {r['flop_share']:.1%} of {FP32_PEAK / 1e12:g} "
          f"TFLOP/s fp32 (no TF32); max_memory_allocated {r['peak_gib']:.2f} GiB (predicted "
          f"{LMT_PEAK_PREDICTED[0]}-{LMT_PEAK_PREDICTED[1]} GiB); {card_line()}")
    # one more step under torch.profiler, then one batch repeated
    loss_fn, _, opt = lm_setup(cfg, LMT_B, LMT_SEQ, LMT_STEPS)
    _, step = make_train_step(loss_fn, opt)
    state = out["state"]
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in lm_stream(cfg, LMT_B, LMT_SEQ)(LMT_STEPS).items()}
    r["profile"] = profile_window(torch, "lm_train granite-3-2b step",
                                  lambda: step(state, batch))
    del out, state
    free_card(torch)
    fixed = lm_stream(cfg, LMT_B, LMT_SEQ)(0)
    _, repeated, _ = lm_train_run(model, LMT_B, LMT_SEQ, LMT_REPEAT,
                                  stream=DeterministicStream(lambda s: fixed, 0))
    if not repeated[-1] < repeated[0]:
        raise AssertionError(f"lm_train (a): the loss on one batch repeated did not fall: "
                             f"{repeated}")
    r["repeated_losses"] = repeated
    print(f"lm_train (a) one batch repeated for {LMT_REPEAT} steps: losses "
          f"{', '.join(f'{x:.4f}' for x in repeated)} (falls)")
    return r


def lm_train_remat_and_repro(torch, dev) -> dict:
    """Phase 15 (b) and (c) for granite-3-2b cut to LMT_CUT_LAYERS layers."""
    from repro_torch.configs import granite_3_2b

    free_card(torch)
    g = torch.Generator(device=dev).manual_seed(15)
    tokens = torch.randint(0, granite_3_2b.FULL.vocab, (1, LMT_SEQ + 1), generator=g, device=dev)
    runs, ms = {}, {}
    for remat in ("none", "full", "dots", "dots_no_batch"):
        cfg = dataclasses.replace(granite_3_2b.FULL, n_layers=LMT_CUT_LAYERS, remat=remat)
        model = lm_model(torch, dev, cfg, f"granite-3-2b at {LMT_CUT_LAYERS} layers")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.loss(tokens[:, :-1], tokens[:, 1:])
        loss.backward()
        torch.cuda.synchronize()
        ms[remat] = dict(ms=1e3 * (time.perf_counter() - t0),
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        runs[remat] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()})
        del model, loss
    loss, grads = runs.pop("none")
    for remat, (r_loss, r_grads) in runs.items():
        differ = [n for n, gr in grads.items() if not torch.equal(r_grads[n], gr)]
        if not torch.equal(r_loss, loss) or differ:
            raise AssertionError(f"lm_train (b): remat {remat!r} differs from 'none' (loss "
                                 f"{float(r_loss)} vs {float(loss)}; gradients {differ[:3]})")
    print(f"lm_train (b) granite-3-2b at {LMT_CUT_LAYERS} layers, B = 1 x {LMT_SEQ}: the loss "
          f"({float(loss):.6f}) and all {len(grads)} gradients under remat 'full', 'dots' and "
          f"'dots_no_batch' equal 'none' bit for bit; fwd+bwd ms and peak GiB (first call "
          f"each): {json.dumps(ms)}")
    del runs, grads
    # (c) two trainings from one seed
    cfg = dataclasses.replace(granite_3_2b.FULL, n_layers=LMT_CUT_LAYERS)
    trained = []
    for _ in range(2):
        model = lm_model(torch, dev, cfg, f"granite-3-2b at {LMT_CUT_LAYERS} layers")
        out, _, _ = lm_train_run(model, 1, LMT_SEQ, LMT_REPRO_STEPS)
        del out
        trained.append(model)
    same_trained_bits(torch, f"granite-3-2b at {LMT_CUT_LAYERS} layers", *trained)
    return dict(remat=ms)


def lm_train_moe(torch, dev) -> dict:
    """Phase 15 (c) and (d): deepseek-moe-16b at full width cut to
    LMT_MOE_LAYERS layers, trained twice from one seed (the first timed and
    profiled, with each step's aux loss)."""
    from repro_torch.configs import deepseek_moe_16b
    from repro_torch.launch.train import lm_setup, lm_stream

    free_card(torch)
    cfg = dataclasses.replace(deepseek_moe_16b.FULL, n_layers=LMT_MOE_LAYERS)
    label = f"deepseek-moe-16b at {LMT_MOE_LAYERS} layers"
    first = lm_model(torch, dev, cfg, label, LMT_MOE_PARAMS)
    aux = []
    hook = first.register_forward_hook(lambda m, i, o: aux.append(float(o[1].detach())))
    out, losses, times = lm_train_run(first, 1, LMT_SEQ, LMT_REPRO_STEPS)
    hook.remove()
    r = dict(losses=losses, aux=aux, step_ms=times, ms_per_step=statistics.median(times[1:]),
             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"lm_train (d) {label} (1 dense, {cfg.n_scan_layers} MoE; 28 layers cut), B = 1 x "
          f"{LMT_SEQ}, remat 'full', fp32, AdamW: losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"aux loss a step {', '.join(f'{x:.6f}' for x in aux)}; step ms "
          f"{', '.join(f'{t:.1f}' for t in times)}; {r['ms_per_step']:.1f} ms/step (median after "
          f"the first); max_memory_allocated {r['peak_gib']:.2f} GiB")
    loss_fn = lm_setup(cfg, 1, LMT_SEQ, LMT_REPRO_STEPS)[0]
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in lm_stream(cfg, 1, LMT_SEQ)(LMT_REPRO_STEPS).items()}

    def fwd_bwd():
        loss_fn(first, batch).backward()
        for p in first.parameters():
            p.grad = None

    r["profile"] = profile_window(torch, f"lm_train {label} forward and backward", fwd_bwd)
    del out
    free_card(torch)
    second = lm_model(torch, dev, cfg, label)
    lm_train_run(second, 1, LMT_SEQ, LMT_REPRO_STEPS)
    same_trained_bits(torch, label, first, second)
    return r


def lm_train_mla(torch, dev) -> dict:
    """Phase 15 (e): deepseek-v2-236b at full width cut to LMT_V2_LAYERS
    layers, one forward and backward pass (its AdamW state does not fit)."""
    from repro_torch.configs import deepseek_v2_236b

    free_card(torch)
    cfg = dataclasses.replace(deepseek_v2_236b.FULL, n_layers=LMT_V2_LAYERS)
    label = f"deepseek-v2-236b at {LMT_V2_LAYERS} layers"
    model = lm_model(torch, dev, cfg, label, MOE_PARAMS["deepseek-v2-236b"])
    g = torch.Generator(device=dev).manual_seed(16)
    tokens = torch.randint(0, cfg.vocab, (1, LMT_V2_SEQ + 1), generator=g, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = model.loss(tokens[:, :-1], tokens[:, 1:])
    loss.backward()
    torch.cuda.synchronize()
    r = dict(loss=float(loss.detach()), fwd_bwd_ms=1e3 * (time.perf_counter() - t0))
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if not np.isfinite(r["loss"]) or bad:
        raise AssertionError(f"lm_train (e) {label}: loss {r['loss']}, gradients missing or "
                             f"not finite: {bad[:3]}")
    for p in model.parameters():
        p.grad = None
    # the latent attention's chunked path (T >= 2 q_chunk), forward and backward
    attn = model.dense_blocks[0].attn
    x = torch.randn((1, LMT_V2_SEQ, cfg.d_model), generator=g, device=dev, requires_grad=True)
    w = torch.randn((1, LMT_V2_SEQ, cfg.d_model), generator=g, device=dev)
    r["mla_chunked_ms"] = time_ms(lambda: (attn(x) * w).sum().backward(), iters=5, warmup=1)
    r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"lm_train (e) {label}, B = 1 x {LMT_V2_SEQ}, remat 'full', fp32: loss "
          f"{r['loss']:.4f}, all {len(list(model.parameters()))} gradients finite, no optimizer "
          f"step; forward and backward {r['fwd_bwd_ms']:.1f} ms (first call); one MLAttention's "
          f"chunked path ({LMT_V2_SEQ // attn.q_chunk} chunks of {attn.q_chunk}) forward and "
          f"backward {r['mla_chunked_ms']:.2f} ms (CUDA events, median of 5); "
          f"max_memory_allocated {r['peak_gib']:.2f} GiB")
    del model, x, w
    return r


def lm_train_phase(torch, dev, wrappers):
    """Phase 15 (module docstring): LM training on the card. Returns the
    path's launch counts (none of the port's kernels: LM training reaches
    none of them) and the phase's figures."""
    t_phase = time.perf_counter()
    free_card(torch)
    print(f"lm_train: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the "
          f"phase ({torch.cuda.get_device_name(dev)}; {card_line()}); LM training launches none "
          f"of the port's kernels (the reference's reaches no Pallas kernel)")
    reset(wrappers)
    out = dict(granite=lm_train_granite(torch, dev))
    out["granite_cut"] = lm_train_remat_and_repro(torch, dev)
    out["moe"] = lm_train_moe(torch, dev)
    out["mla"] = lm_train_mla(torch, dev)
    launches = read_launches(wrappers, (), "lm_train")
    print(f"lm_train figures: {json.dumps(out)}")
    free_card(torch)
    print(f"lm_train: phase wall time {time.perf_counter() - t_phase:.1f} s; {card_line()}")
    return launches


def gnn_graph(shape_name: str) -> dict:
    """Phase 16's graph of one GNN shape, as numpy (host set-up)."""
    from repro_torch.configs import registry
    from repro_torch.data.graph import (NeighborSampler, cora_like, flatten_block,
                                        molecule_batch, random_graph)

    if shape_name == "full_graph_sm":
        return cora_like(0)
    if shape_name == "molecule":
        return molecule_batch(128, 30, 64, 16, 4)
    s = registry.GNN_SHAPES["minibatch_lg"]
    t0 = time.perf_counter()
    big = random_graph(s["n_nodes"], s["n_edges"], s["d_feat"], seed=0,
                       n_classes=s["n_classes"])
    t1 = time.perf_counter()
    sampler = NeighborSampler(big["edge_index"], s["n_nodes"], list(s["fanout"]), seed=0)
    t2 = time.perf_counter()
    g = flatten_block(big, sampler.sample(np.arange(s["batch_nodes"])))
    print(f"gnn minibatch_lg host set-up: random_graph({s['n_nodes']:,}, {s['n_edges']:,}, "
          f"{s['d_feat']}) {t1 - t0:.1f} s, CSR {t2 - t1:.1f} s, sample + flatten "
          f"{time.perf_counter() - t2:.1f} s")
    return g


def gnn_on_card(torch, dev, g: dict) -> dict:
    """A numpy graph on the card (``n_graphs`` stays an int)."""
    return {k: torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray) else v
            for k, v in g.items()}


def gnn_model(torch, dev, shape_name: str, **over):
    """gatedgcn FULL at a shape (``gnn_config_for_shape``), the port's init
    (seed 0)."""
    from repro_torch.configs import gatedgcn, registry
    from repro_torch.models.gnn import GatedGCN

    cfg = dataclasses.replace(registry.gnn_config_for_shape(
        gatedgcn.FULL, registry.GNN_SHAPES[shape_name]), **over)
    return GatedGCN(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))


def gnn_train_run(model, graph, steps):
    """``steps`` steps of the launcher's AdamW (``launch.train.gnn_setup``)
    on ``graph`` every step, through ``train.loop.run``; fails on a
    non-finite loss. Returns (run's output, losses, step ms)."""
    from repro_torch.data.pipeline import DeterministicStream
    from repro_torch.launch.train import gnn_setup
    from repro_torch.train.loop import LoopConfig, run

    loss_fn, _, opt = gnn_setup(model.cfg)
    out = run(loss_fn, model, DeterministicStream(lambda seed: graph, 0), opt,
              LoopConfig(n_steps=steps, log_every=1))
    losses = [m["loss"] for _, m in out["history"]]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"gnn: losses {losses}")
    return out, losses, [1e3 * m["step_time_s"] for _, m in out["history"]]


def gnn_loss_and_grads(model, graph, **kw):
    for p in model.parameters():
        p.grad = None
    loss = model.loss(graph, **kw)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def gnn_phase(torch, dev, wrappers):
    """Phase 16 (module docstring): gatedgcn on the card. Returns the
    path's launch counts (none of the port's kernels)."""
    from repro_torch.distributed.mesh_ctx import MeshCtx
    from repro_torch.launch import flops
    from repro_torch.launch.train import gnn_setup
    from repro_torch.train.loop import make_train_step

    t_phase = time.perf_counter()
    free_card(torch)
    print(f"gnn: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the phase "
          f"({torch.cuda.get_device_name(dev)}; {card_line()}); the GNN launches none of the "
          f"port's kernels (the reference's reaches no Pallas kernel)")
    reset(wrappers)
    graphs, runs = {}, {}
    # (a) each shape trained from the port's init
    for name in GNN_TRAINED:
        free_card(torch)
        graphs[name] = gnn_on_card(torch, dev, gnn_graph(name))
        g = graphs[name]
        model = gnn_model(torch, dev, name)
        out, losses, times = gnn_train_run(model, g, GNN_STEPS)
        ms = statistics.median(times[1:])
        work = flops.model_flops("gatedgcn", name)
        n_nodes, n_edges = g["x"].shape[0], g["edge_index"].shape[1]
        r = dict(losses=losses, step_ms=times, ms_per_step=ms, model_flops=work,
                 flop_share=work / (ms / 1e3) / FP32_PEAK, flop_bound_ms=1e3 * work / FP32_PEAK,
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30, nodes=n_nodes,
                 edges=n_edges, params=sum(p.numel() for p in model.parameters()))
        print(f"gnn (a) {name}: {n_nodes:,} nodes, {n_edges:,} edges, {r['params']:,} "
              f"parameters, readout {model.cfg.readout!r}; losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; step ms "
              f"{', '.join(f'{t:.1f}' for t in times)}; {ms:.2f} ms/step (median after the "
              f"first); model flops {work:.4g} (launch/flops.py) = {r['flop_share']:.2%} of "
              f"{FP32_PEAK / 1e12:g} TFLOP/s fp32 (bound {r['flop_bound_ms']:.3f} ms); "
              f"max_memory_allocated {r['peak_gib']:.3f} GiB")
        if name == "minibatch_lg":
            loss_fn, _, opt = gnn_setup(model.cfg)
            _, step = make_train_step(loss_fn, opt)
            state = out["state"]
            r["profile"] = profile_window(torch, "gnn minibatch_lg step",
                                          lambda: step(state, g))
            repeated = [float(step(state, g)[1]["loss"]) for _ in range(GNN_REPEAT)]
            if not repeated[-1] < repeated[0]:
                raise AssertionError(f"gnn (a): the loss on one batch repeated did not fall: "
                                     f"{repeated}")
            r["repeated_losses"] = repeated
            print(f"gnn (a) minibatch_lg, its batch {GNN_REPEAT} more steps: losses "
                  f"{', '.join(f'{x:.4f}' for x in repeated)} (falls)")
            del state
        runs[name] = r
        del model, out
    # (b) remat on and off at minibatch_lg
    free_card(torch)
    big = graphs["minibatch_lg"]
    on = gnn_loss_and_grads(gnn_model(torch, dev, "minibatch_lg", remat=True), big)
    peak_on = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    off = gnn_loss_and_grads(gnn_model(torch, dev, "minibatch_lg", remat=False), big)
    peak_off = torch.cuda.max_memory_allocated() / 2**30
    differ = [n for n, gr in off[1].items() if not torch.equal(on[1][n], gr)]
    if not torch.equal(on[0], off[0]) or differ:
        raise AssertionError(f"gnn (b): remat on differs from off (loss {float(on[0])} vs "
                             f"{float(off[0])}; gradients {differ[:3]})")
    print(f"gnn (b) minibatch_lg: the loss ({float(off[0]):.6f}) and all {len(off[1])} "
          f"gradients with remat on equal remat off bit for bit; peak {peak_on:.3f} GiB on, "
          f"{peak_off:.3f} GiB off")
    del on, off
    # (c) two trainings from one seed
    trained = []
    for _ in range(2):
        model = gnn_model(torch, dev, "minibatch_lg")
        gnn_train_run(model, big, GNN_REPRO_STEPS)
        trained.append(model)
    differ = [n for (n, a), (_, b) in zip(trained[0].named_parameters(),
                                          trained[1].named_parameters()) if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"gnn (c): two trainings from one seed differ in {len(differ)} "
                             f"parameters, first {differ[:3]}")
    print(f"gnn (c) minibatch_lg: two trainings of {GNN_REPRO_STEPS} AdamW steps from one seed "
          f"end with the same bits in all {len(list(trained[0].parameters()))} parameters")
    del trained
    # (d) the edge-sharded path against one device
    mesh = MeshCtx((dev,) * 4, data=2)
    sharded = {}
    for name, axes in (("minibatch_lg", ("data", "model")), ("full_graph_sm", ("model",))):
        model = gnn_model(torch, dev, name)
        loss, grads = gnn_loss_and_grads(model, graphs[name])
        s_loss, s_grads = gnn_loss_and_grads(model, graphs[name], mesh=mesh, axes=axes)
        top = max(float(v.abs().max()) for v in grads.values())
        err = max(float((s_grads[n] - v).abs().max()) for n, v in grads.items()) / top
        d_loss = abs(float(s_loss) - float(loss))
        blocks = mesh.axis_size(axes)
        if not d_loss <= GNN_LOSS_TOL or not err <= GNN_GRAD_TOL:
            raise AssertionError(f"gnn (d) {name} over {blocks} edge blocks: loss differs by "
                                 f"{d_loss:.3g} (limit {GNN_LOSS_TOL}), gradients by {err:.3g} "
                                 f"of the largest (limit {GNN_GRAD_TOL})")
        sharded[name] = dict(blocks=blocks, loss_diff=d_loss, grad_rel=err)
        print(f"gnn (d) {name}, {graphs[name]['edge_index'].shape[1]:,} edges over {blocks} "
              f"blocks ({'/'.join(axes)}) on this one card: loss within {d_loss:.3g} (limit "
              f"{GNN_LOSS_TOL}), gradients within {err:.3g} of the largest (limit "
              f"{GNN_GRAD_TOL})")
        del model
    # (e) no kernel of the port on the path
    launches = read_launches(wrappers, (), "gnn")
    if any(launches.values()):
        raise AssertionError(f"gnn: the GNN launched kernels of the port: {launches}")
    del graphs, big
    print(f"gnn figures: {json.dumps(dict(runs=runs, sharded=sharded))}")
    free_card(torch)
    print(f"gnn: phase wall time {time.perf_counter() - t_phase:.1f} s; {card_line()}")
    return launches


def mesh_ctx(dev, data: int = MESH_SHAPE[0], model: int = MESH_SHAPE[1], **kw):
    from repro_torch.distributed.mesh_ctx import MeshCtx
    return MeshCtx((dev,) * model, data=data, **kw)


def rel_to_largest(got: dict, want: dict) -> float:
    """The largest |got - want| over every entry, over the largest |want|."""
    err = max(float((got[k] - w).abs().max()) for k, w in want.items())
    return err / max(float(w.abs().max()) for w in want.values())


def loss_and_grads(torch, model, a, b, mesh=None) -> tuple:
    """(loss, {name: grad}, ms, peak GiB) of one forward and backward."""
    for p in model.parameters():
        p.grad = None
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = model.loss(a, b, mesh=mesh)
    loss.backward()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    grads = {n: p.grad for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.detach(), grads, ms, torch.cuda.max_memory_allocated() / 2**30


def mesh_granite(torch, dev) -> tuple:
    """Phase 17 (a): granite-3-2b at MESH_LAYERS layers under the mesh.
    Returns (model, tokens, one-device loss and gradients, figures)."""
    from repro_torch.configs import granite_3_2b

    free_card(torch)
    cfg = dataclasses.replace(granite_3_2b.FULL, n_layers=MESH_LAYERS, remat="full")
    model = lm_model(torch, dev, cfg, f"granite-3-2b at {MESH_LAYERS} layers")
    g = torch.Generator(device=dev).manual_seed(17)
    tokens = torch.randint(0, cfg.vocab, (MESH_B, MESH_SEQ + 1), generator=g, device=dev)
    a, b = tokens[:, :-1], tokens[:, 1:]
    seq = mesh_ctx(dev, act_seq_shard=True)
    tp = dataclasses.replace(seq, manual_tp=True)
    runs = {}
    for label, mesh in (("one device", None), ("mesh", seq), ("manual_tp", tp)):
        loss, grads, first_ms, peak = loss_and_grads(torch, model, a, b, mesh)
        ms = statistics.median(loss_and_grads(torch, model, a, b, mesh)[2]
                               for _ in range(MESH_TIMED))
        runs[label] = dict(loss=loss, grads=grads, ms=ms, first_ms=first_ms, peak_gib=peak)
    base = runs["one device"]
    out = {}
    for label, tol in (("mesh", MESH_TOL), ("manual_tp", MESH_TP_TOL)):
        r = runs[label]
        rel = rel_to_largest(r["grads"], base["grads"])
        loss_rel = abs(float(r["loss"] - base["loss"])) / abs(float(base["loss"]))
        bits = torch.equal(r["loss"], base["loss"]) and all(
            torch.equal(r["grads"][n], gr) for n, gr in base["grads"].items())
        if not (rel <= tol and loss_rel <= tol and bool(torch.isfinite(r["loss"]))):
            raise AssertionError(f"mesh (a) {label}: loss {float(r['loss'])} vs "
                                 f"{float(base['loss'])}, gradients within {rel:.3g} of the "
                                 f"largest (limit {tol})")
        out[label] = dict(grad_rel=rel, loss_rel=loss_rel, same_bits=bits)
    # remat "none" under the mesh: remat "full"'s bits
    model.stack.remat = "none"
    loss, grads, out["remat_none_ms"], out["remat_none_peak_gib"] = loss_and_grads(
        torch, model, a, b, seq)
    model.stack.remat = "full"
    mesh_run = runs["mesh"]
    differ = [n for n, gr in mesh_run["grads"].items() if not torch.equal(grads[n], gr)]
    if not torch.equal(loss, mesh_run["loss"]) or differ:
        raise AssertionError(f"mesh (a): remat 'none' under the mesh differs from 'full' (loss "
                             f"{float(loss)} vs {float(mesh_run['loss'])}; {differ[:3]})")
    times = {label: dict(ms=r["ms"], first_ms=r["first_ms"], peak_gib=r["peak_gib"])
             for label, r in runs.items()}
    out["times"] = times
    out["loss"] = float(base["loss"])
    print(f"mesh (a) granite-3-2b at {MESH_LAYERS} layers (d {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"GQA {cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab:,}), B = {MESH_B} x {MESH_SEQ}, "
          f"remat 'full', over a {MESH_SHAPE} (data, model) mesh of {dev}: loss "
          f"{out['loss']:.6f}; act_seq_shard "
          f"within {out['mesh']['grad_rel']:.3g} of the largest gradient (limit {MESH_TOL}; "
          f"same bits: {out['mesh']['same_bits']}); manual_tp (bf16) loss within "
          f"{out['manual_tp']['loss_rel']:.3g}, gradients within "
          f"{out['manual_tp']['grad_rel']:.3g} of the largest (limit {MESH_TP_TOL}); remat "
          f"'none' under the mesh: remat 'full''s bits")
    print(f"mesh (a) ms per forward and backward (host clock to a synchronize, median of "
          f"{MESH_TIMED} after the checked call) and max_memory_allocated: "
          + "; ".join(f"{label} {t['ms']:.1f} ms ({t['peak_gib']:.2f} GiB)"
                      for label, t in times.items())
          + f"; mesh with remat 'none' {out['remat_none_ms']:.1f} ms "
          f"({out['remat_none_peak_gib']:.2f} GiB, first call); {card_line()}")
    base = {"loss": base["loss"]}
    del runs, mesh_run, grads
    return model, (a, b), base, out


def mesh_moe(torch, dev) -> tuple:
    """Phase 17 (b): deepseek-moe-16b at MESH_LAYERS layers under the mesh.
    Returns (model, figures)."""
    from repro_torch.configs import deepseek_moe_16b

    free_card(torch)
    cfg = dataclasses.replace(deepseek_moe_16b.FULL, n_layers=MESH_LAYERS)
    model = lm_model(torch, dev, cfg, f"deepseek-moe-16b at {MESH_LAYERS} layers",
                     LMT_MOE_PARAMS)
    g = torch.Generator(device=dev).manual_seed(18)
    tokens = torch.randint(0, cfg.vocab, (MESH_B, MESH_MOE_SEQ + 1), generator=g, device=dev)
    a, b = tokens[:, :-1], tokens[:, 1:]
    ctx = mesh_ctx(dev)
    out = {}
    with torch.no_grad():
        x = model.embed(a)
        for block in model.dense_blocks:
            x = block(x)[0]
        block = model.stack[0]
        y = block(x, mesh=ctx)[0]
        per_shard = torch.cat([block(x[i:i + 1])[0] for i in range(MESH_B)])
        out["block_rel"] = float((y - per_shard).abs().max() / per_shard.abs().max())
        whole = block(x)[0]
        out["block_vs_whole_batch"] = float((y - whole).abs().max() / whole.abs().max())
        del x, y, per_shard, whole
        loss_mesh = float(model.loss(a, b, mesh=ctx))
        loss_one = float(model.loss(a, b))
    if not out["block_rel"] <= MESH_TOL:
        raise AssertionError(f"mesh (b): the first MoE block under the mesh differs from the "
                             f"per-shard one-device block by {out['block_rel']:.3g}")
    if not np.isfinite(loss_mesh):
        raise AssertionError(f"mesh (b): the loss under the mesh is {loss_mesh}")
    out.update(loss_mesh=loss_mesh, loss_one=loss_one)
    set_capacity_factor(model, None)
    loss0, grads0, _, _ = loss_and_grads(torch, model, a, b)
    loss1, grads1, _, peak = loss_and_grads(torch, model, a, b, ctx)
    set_capacity_factor(model, 1.25)
    out["nodrop_grad_rel"] = rel_to_largest(grads1, grads0)
    out["nodrop_loss_rel"] = abs(float(loss1 - loss0)) / abs(float(loss0))
    out["nodrop_peak_gib"] = peak
    if not (out["nodrop_grad_rel"] <= MESH_TOL and out["nodrop_loss_rel"] <= MESH_TOL):
        raise AssertionError(f"mesh (b): nothing dropping, the mesh's loss {float(loss1)} vs "
                             f"{float(loss0)}, gradients within {out['nodrop_grad_rel']:.3g}")
    del grads0, grads1
    print(f"mesh (b) deepseek-moe-16b at {MESH_LAYERS} layers (1 dense, 3 MoE; full width), "
          f"B = {MESH_B} x {MESH_MOE_SEQ}: the first MoE block under the mesh within "
          f"{out['block_rel']:.3g} of the one-device block on each data shard's tokens alone "
          f"(limit {MESH_TOL}; {out['block_vs_whole_batch']:.3g} from the block on the whole "
          f"batch); loss at capacity factor 1.25 under the mesh {loss_mesh:.6f}, one device "
          f"{loss_one:.6f} ({abs(loss_mesh - loss_one):.3g} apart); nothing dropping (factor "
          f"n_experts / top_k): loss within {out['nodrop_loss_rel']:.3g}, gradients within "
          f"{out['nodrop_grad_rel']:.3g} of the largest (limit {MESH_TOL}); max_memory_allocated "
          f"{peak:.2f} GiB")
    return model, out


def mesh_decode(torch, dev, wrappers, model) -> tuple:
    """Phase 17 (c): prefill, exact and SDIM decode of (b)'s model under
    the mesh against one device. Returns (the launch counts of the SDIM
    tokens under the mesh, figures)."""
    from repro_torch.kernels.sdim_query.sdim_query import sdim_query

    cfg = model.cfg
    ctx = mesh_ctx(dev)
    g = torch.Generator(device=dev).manual_seed(19)
    toks = torch.randint(0, cfg.vocab, (MESH_B, MESH_PREFILL + MESH_DECODE), generator=g,
                         device=dev)
    out = {}
    with torch.no_grad():
        set_capacity_factor(model, None)
        out["prefill_rel"] = logits_close(
            torch, "mesh (c) prefill under the mesh vs one device (nothing dropping)",
            model.prefill(toks[:, :MESH_PREFILL], mesh=ctx), model.prefill(toks[:, :MESH_PREFILL]),
            MESH_TOL)
        set_capacity_factor(model, 1.25)
        cache = model.init_cache(MESH_B, MESH_PREFILL + MESH_DECODE, torch.float32)
        for i in range(MESH_PREFILL):
            model.decode_step(toks[:, i:i + 1], cache, i)
        mask = torch.zeros((MESH_B, MESH_PREFILL + MESH_DECODE), device=dev)
        mask[:, :MESH_PREFILL] = 1
        sc = dict(model.encode_sdim_cache_from_kv(cache, mask), len=MESH_PREFILL)
        exact = {"mesh": cache, "one": {"stack": {k: v.clone() for k, v in cache["stack"].items()},
                                        "dense": [{k: v.clone() for k, v in c.items()}
                                                  for c in cache["dense"]]}}
        sdim = {"mesh": sc, "one": {k: v.clone() if torch.is_tensor(v) else v
                                    for k, v in sc.items()}}
        got = {"exact": [], "sdim": []}
        want = {"exact": [], "sdim": []}
        reset(wrappers)
        for i in range(MESH_DECODE):
            pos = MESH_PREFILL + i
            tok = toks[:, pos:pos + 1]
            got["exact"].append(model.decode_step(tok, exact["mesh"], pos, mesh=ctx)[0])
            with uncounted():
                want["exact"].append(model.decode_step(tok, exact["one"], pos)[0])
                want["sdim"].append(model.sdim_decode_step(tok, sdim["one"])[0])
            got["sdim"].append(model.sdim_decode_step(tok, sdim["mesh"], mesh=ctx)[0])
        torch.cuda.synchronize()
        launches = read_launches(wrappers, ("sdim_query",), "mesh")
    if launches["sdim_query"] != MESH_DECODE * cfg.n_scan_layers:
        raise AssertionError(f"mesh (c): {launches['sdim_query']} sdim_query launches, not "
                             f"{cfg.n_scan_layers} a token")
    for path in ("exact", "sdim"):
        out[f"{path}_rel"] = logits_close(
            torch, f"mesh (c) {path} decode of {MESH_DECODE} tokens under the mesh vs one device",
            torch.cat(got[path]), torch.cat(want[path]), MESH_TOL)
    print(f"mesh (c) deepseek-moe-16b, B = {MESH_B}: {MESH_DECODE} tokens after a "
          f"{MESH_PREFILL}-token prefill; exact and SDIM decode under the mesh (experts over "
          f"{ctx.ep} shards, tokens replicated) within {out['exact_rel']:.3g} and "
          f"{out['sdim_rel']:.3g} of the largest logit (limit {MESH_TOL}); prefill within "
          f"{out['prefill_rel']:.3g}; sdim_query {launches['sdim_query']} launches under the "
          f"mesh ({cfg.n_scan_layers} a token)")
    del exact, sdim, cache
    return launches, out


def mesh_elastic(torch, dev, model, batch, base) -> dict:
    """Phase 17 (d): (a)'s parameters saved whole and restored onto two
    meshes; the loss of a model loaded from the gathered leaves."""
    import tempfile
    from repro_torch.distributed.sharding import (flatten, gather_tree, map_tree, param_spec,
                                                  shard_bytes, spec_tree, valid_for_mesh)
    from repro_torch.models.lm import LMModel
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.elastic import restore_on_mesh
    from repro_torch.weights import export_lm_params, load_jax_lm_params

    params = export_lm_params(model)
    flat = flatten({"params": params})
    whole = sum(v.nbytes for v in flat.values())
    out = {"whole_bytes": whole}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ck.save(d, 0, {"params": params})
        out["save_s"] = time.perf_counter() - t0
        for data, n_model in ((2, 4), (4, 2)):
            mesh = mesh_ctx(dev, data, n_model)

            def rules(path, shape, mesh=mesh):
                return valid_for_mesh(param_spec("lm", path, shape), shape, mesh)

            t0 = time.perf_counter()
            restored, _ = restore_on_mesh(d, {"params": params}, mesh, rules)
            restore_s = time.perf_counter() - t0
            specs = spec_tree(restored)
            wrong = [p for p, v in flat.items() if specs[p] != rules(p, v.shape)]
            gathered = gather_tree(restored, dev)
            differ = [path for path, t in flatten(gathered).items()
                      if not torch.equal(t, torch.from_numpy(flat[path]).to(dev))]
            on_card = all(blk.device == dev for leaf in flatten(restored).values()
                          for blk in leaf.blocks)
            if wrong or differ or not on_card:
                raise AssertionError(f"mesh (d) data={data}, model={n_model}: specs differ "
                                     f"{wrong[:3]}, gathered leaves differ {differ[:3]}, "
                                     f"blocks on the card {on_card}")
            held = shard_bytes(restored)
            out[f"{data}x{n_model}"] = dict(restore_s=restore_s, card_bytes=held,
                                            sharded=sum(1 for s in specs.values() if s))
            print(f"mesh (d) restore onto data={data}, model={n_model}: {restore_s:.2f} s; "
                  f"every gathered leaf equals the saved one bit for bit, every spec "
                  f"valid_for_mesh(param_spec('lm', ...)) ({out[f'{data}x{n_model}']['sharded']} "
                  f"of {len(specs)} leaves split; the tied embed.table "
                  f"{specs['params/embed/table']!r}); "
                  f"one card of the mesh holds {held:,} B of the tree's {whole:,} B "
                  f"({held / whole:.1%})")
            del restored
        numpy_tree = map_tree(lambda _, t: t.cpu().numpy(), gathered)
    loaded = LMModel(model.cfg, device=dev)
    load_jax_lm_params(loaded, numpy_tree["params"], model.R.cpu().numpy())
    with torch.no_grad():
        loss = loaded.loss(*batch)
    if not torch.equal(loss, base["loss"]):
        raise AssertionError(f"mesh (d): the model loaded from the gathered leaves gives loss "
                             f"{float(loss)}, not (a)'s {float(base['loss'])}")
    print(f"mesh (d) a model loaded from the gathered leaves gives (a)'s loss bit for bit "
          f"({float(loss):.6f}); save {out['save_s']:.2f} s")
    del loaded, gathered, numpy_tree
    return out


def mesh_compressed(torch, dev, model, batch) -> dict:
    """Phase 17 (e): compressed_psum over the gradient trees of (a)'s two
    data halves."""
    from repro_torch.train.compression import compressed_psum

    a, b = batch
    halves = [loss_and_grads(torch, model, a[i:i + 1], b[i:i + 1])[1] for i in range(2)]
    first, second = compressed_psum(halves), compressed_psum(halves)
    worst, bits = 0.0, True
    for n in halves[0]:
        mean = (halves[0][n] + halves[1][n]) / 2
        step = max(float(h[n].abs().max()) for h in halves) / 127
        err = float((first[0][n] - mean).abs().max())
        worst = max(worst, err / step if step else 0.0)
        bits = bits and all(torch.equal(x[n], y[n]) for x, y in zip(first, second)) and \
            torch.equal(first[0][n], first[1][n])
        if not err <= step:
            raise AssertionError(f"mesh (e): compressed_psum's {n} lies {err:.3g} from the "
                                 f"halves' mean, more than one int8 step {step:.3g}")
    if not bits:
        raise AssertionError("mesh (e): two compressed_psum calls differ, or its blocks do")
    print(f"mesh (e) compressed_psum over the gradient trees of (a)'s 2 data halves "
          f"({len(halves[0])} leaves): every leaf within {worst:.3f} of one int8 step (the "
          f"shared max|g| / 127) of the halves' mean; two calls and both blocks the same bits")
    return dict(worst_step_share=worst)


def mesh_phase(torch, dev, wrappers):
    """Phase 17 (module docstring): the sharded LM training state. Returns
    the path's launch counts (kernel 4 in (c)'s SDIM tokens under the
    mesh)."""
    t_phase = time.perf_counter()
    free_card(torch)
    print(f"mesh: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the phase "
          f"({torch.cuda.get_device_name(dev)}; {card_line()}); mesh {MESH_SHAPE} (data, model) "
          f"blocks, all on {dev}")
    reset(wrappers)
    model, batch, base, out = mesh_granite(torch, dev)
    figures = {"granite": out}
    figures["elastic"] = mesh_elastic(torch, dev, model, batch, base)
    figures["compressed"] = mesh_compressed(torch, dev, model, batch)
    del model, base
    moe, figures["moe"] = mesh_moe(torch, dev)
    launches, figures["decode"] = mesh_decode(torch, dev, wrappers, moe)
    del moe
    free_card(torch)
    print(f"mesh figures: {json.dumps(figures)}")
    print(f"mesh: phase wall time {time.perf_counter() - t_phase:.1f} s; {card_line()}")
    return launches


# ---------------------------------------------------------------------------
# phase 18: the dry run, the examples, the embedding functions
# ---------------------------------------------------------------------------
CARD_SERVE = ("wide-deep", "bst", "dien", "bert4rec")
TARGET_SERVE = "bst"                  # its serve_p99 with the target_attention variant
GRANITE_CUT = dict(depth=2, batch=2)  # granite-3-2b train_4k at full width
DRYRUN_KERNELS = ("bse_encode", "sdim_query", "target_attention_flash")
EXAMPLE_KERNELS = {"quickstart": (),
                   "serving_bse": ("bse_encode", "sdim_update", "sdim_query", "bse_serve"),
                   "tiered_serving": ("bse_encode", "sdim_update"),
                   "train_ctr": ("bse_encode", "sdim_query")}
TRAIN_CTR_STEPS, TRAIN_CTR_KILL = 20, 10
EMB_B, EMB_HOT, EMB_BAGS = 512, 8, 512


def dryrun_cells() -> list:
    """(multi_pod, arch, shape, variant) of every dry-run cell: the 40 on
    both meshes, then the single-pod variant cells."""
    from repro_torch.configs import registry

    lm = [a for a in registry.ARCH_IDS if registry.family(a) == "lm"]
    recsys = list(dict.fromkeys(a for a, _ in registry.cells()
                                if registry.family(a) == "recsys"))
    variants = ([(a, "train_4k", v) for a in lm for v in ("amp", "opt", "bf16params", "manual_tp")]
                + [(a, s, "sdim_kv") for a in lm for s in ("decode_32k", "long_500k")]
                + [(a, s, v) for a in recsys for s in registry.RECSYS_SHAPES
                   for v in ("bf16emb", "target_attention")])
    return ([(mp, a, s, "baseline") for mp in (False, True) for a, s in registry.cells()]
            + [(False, a, s, v) for a, s, v in variants])


def dryrun_counts() -> dict:
    """18 (a): every cell counted; the largest per-chip total per family
    and mesh."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rows = [dryrun.run_cell(a, s, mp, v, verbose=False) for mp, a, s, v in dryrun_cells()]
    dt = time.perf_counter() - t0
    largest = {}
    for r in rows:
        key = f"{registry.family(r['arch'])}/{r['mesh']}"
        if r["hbm_total_per_chip_gib"] > largest.get(key, (0, ""))[0]:
            largest[key] = (r["hbm_total_per_chip_gib"], r["name"])
    out = {"cells": len(rows), "seconds": dt, "largest_gib": largest,
           "fit_80gib": sum(r["fits_80gib"] for r in rows),
           "bottlenecks": {b: sum(r["bottleneck"] == b for r in rows)
                           for b in ("compute", "memory", "collective")}}
    print(f"dryrun (a): {len(rows)} cells counted in {dt:.2f} s; largest per-chip HBM (GiB, "
          f"temporaries not counted): {json.dumps(largest)}; {out['fit_80gib']} fit 80 GiB; "
          f"bottlenecks {out['bottlenecks']}")
    return out


def card_step(torch, dev, cell, label) -> dict:
    """One real step of ``cell`` on the card from ``materialize`` (seed 0):
    finite; an inference cell's output held against the same step with the
    model's long branch on the kernels' plain versions (uncounted; ATOMIC
    for kind sdim, FP32 for target); a train cell's updated state finite,
    its update applied once."""
    from repro_torch.distributed.sharding import flatten
    from repro_torch.kernels.screen import screen_item_rows
    from repro_torch.launch.specs import materialize, tree_leaves

    t0 = time.perf_counter()
    args = materialize(cell, dev, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_mat = time.perf_counter() - t0
    redrawn = 0
    if cell.kind != "train" and cell.runner.bind(args[0]).cfg.interest.kind == "sdim":
        model = cell.runner.model          # kernel and plain hash alike off the margin
        redrawn = screen_item_rows(model, [args[1]], torch.Generator(device=dev).manual_seed(1))
        args[0]["item_emb"]["table"].copy_(model.item_emb.weight)
    t0 = time.perf_counter()
    out = cell.step_fn(*args)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    if cell.kind == "train":
        state, got = out
        bad = [k for k, t in flatten(state["params"]).items() if not bool(torch.isfinite(t).all())]
        if bad or int(state["opt"]["count"]) != 1:
            raise AssertionError(f"dryrun (c) {label}: non-finite parameters {bad[:3]} or "
                                 f"{int(state['opt']['count'])} updates after the step")
        check = "the updated parameters finite, one update counted (no kernel on this path)"
    else:
        got = out
        model = cell.runner.model
        tol = FP32 if model.cfg.interest.kind == "target" else ATOMIC
        with uncounted(), plain_long_branch(model, plain_refs()):
            ref = cell.step_fn(*args)
        err = check_close(f"dryrun (c) {label} output", got, ref, **tol)
        check = (f"{redrawn} item rows redrawn to clear the hash margin; against the same "
                 f"step on the plain versions max abs err {err:.3g} (atol {tol['atol']}, "
                 f"rtol {tol['rtol']})")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"dryrun (c) {label}: non-finite output")
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(args))
    r = dict(shape=list(got.shape), argument_gib=n_bytes / 2**30, materialize_s=t_mat,
             step_s=t_step, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             out=float(got.float().mean()))
    if cell.kind != "train":
        r.update(max_abs_err=err, redrawn=redrawn)
    print(f"dryrun (c) {label}: output {tuple(got.shape)} finite; {check}; arguments "
          f"{r['argument_gib']:.2f} GiB materialized in {t_mat:.2f} s; step {t_step:.3f} s "
          f"(first call: the model built and loaded); peak {r['peak_gib']:.2f} GiB")
    return r


def card_steps(torch, dev, wrappers) -> tuple:
    """18 (c); returns (launch counts, figures)."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_cell

    mesh = make_production_mesh()
    print(f"dryrun (c): steps on {dev} under the (16, 16) cells' one-card MeshCtx (every "
          f"block on {dev}); cuts: granite-3-2b train_4k to {GRANITE_CUT['depth']} layers and "
          f"B = {GRANITE_CUT['batch']} (full width, S = 4,096); none elsewhere")
    reset(wrappers)
    figures = {}
    todo = ([(a, "serve_p99", "baseline", {}) for a in CARD_SERVE]
            + [(TARGET_SERVE, "serve_p99", "target_attention", {}),
               ("gatedgcn", "full_graph_sm", "baseline", {}),
               ("gatedgcn", "molecule", "baseline", {}),
               ("granite-3-2b", "train_4k", "baseline",
                dict(depth_override=GRANITE_CUT["depth"],
                     overrides=dict(global_batch=GRANITE_CUT["batch"])))])
    for arch, shape, variant, kw in todo:
        free_card(torch)
        cell = build_cell(arch, shape, mesh, variant=variant, **kw)
        figures[cell.name] = card_step(torch, dev, cell, cell.name)
        del cell
    free_card(torch)
    return read_launches(wrappers, DRYRUN_KERNELS, "dryrun"), figures


def run_examples(torch, dev, wrappers) -> tuple:
    """18 (d); returns (launch counts summed over the examples, figures)."""
    import tempfile

    from repro_torch.examples import quickstart, serving_bse, tiered_serving, train_ctr

    total = {w.__name__: 0 for w in wrappers}
    figures = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-examples-")
    runs = [("quickstart", quickstart, []), ("serving_bse", serving_bse, []),
            ("tiered_serving", tiered_serving, []),
            ("train_ctr", train_ctr, ["--steps", str(TRAIN_CTR_STEPS), "--ckpt",
                                      os.path.join(tmp, "whole")])]
    try:
        for name, mod, argv in runs:
            free_card(torch)
            reset(wrappers)
            t0 = time.perf_counter()
            out = mod.main(argv)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if name == "train_ctr":            # killed at step 10, resumed to 20
                cut = ["--steps", str(TRAIN_CTR_STEPS), "--ckpt", os.path.join(tmp, "cut")]
                first = mod.main(cut, stop_after=TRAIN_CTR_KILL)
                second = mod.main(cut)
                torch.cuda.synchronize()
                if (first["stopped_at"], second["stopped_at"]) != (TRAIN_CTR_KILL,
                                                                   TRAIN_CTR_STEPS):
                    raise AssertionError(f"examples train_ctr: stopped at "
                                         f"{first['stopped_at']}, {second['stopped_at']}")
                for (pn, a), (_, b) in zip(out["model"].named_parameters(),
                                           second["model"].named_parameters()):
                    if not torch.equal(a, b):
                        raise AssertionError(f"examples train_ctr: {pn} after the resume "
                                             f"differs from the run never stopped")
                out = {"stopped_at": out["stopped_at"], "params": out["params"],
                       "last_loss": out["history"][-1][1]["loss"], "resumed_bits": "equal"}
                del first, second
            counts = read_launches(wrappers, EXAMPLE_KERNELS[name], f"examples {name}")
            for k, v in counts.items():
                total[k] += v
            figures[name] = dict(seconds=dt, launches=counts,
                                 **{k: v for k, v in out.items() if isinstance(v, (int, float, str))})
            print(f"examples (d) {name}: {dt:.2f} s wall (first run; train_ctr's kill and "
                  f"resume after it); {json.dumps(figures[name])}")
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return total, figures


def embedding_on_card(torch, dev) -> dict:
    """18 (e) (module docstring)."""
    from repro_torch.configs import wide_deep
    from repro_torch.embedding import embedding_bag as eb
    from repro_torch.embedding.sharded import EmbeddingCollection, FieldSpec

    free_card(torch)
    t0 = time.perf_counter()
    cfg = wide_deep.FULL
    g = torch.Generator(device=dev).manual_seed(0)
    fields = [FieldSpec(f"f{i}", cfg.field_vocab, cfg.embed_dim) for i in range(cfg.n_sparse)]
    coll = EmbeddingCollection(fields, device=dev, generator=g)
    ids = {f.name: torch.randint(0, f.vocab, (EMB_B,), generator=g, device=dev) for f in fields}
    n_idx = EMB_BAGS * EMB_HOT
    idx = torch.randint(0, cfg.field_vocab, (n_idx,), generator=g, device=dev)
    seg = torch.randint(0, EMB_BAGS - 1, (n_idx,), generator=g, device=dev)
    seg = seg + (seg >= 7).long()                     # bag 7 stays empty
    w = torch.rand((n_idx,), generator=g, device=dev) + 0.5
    hot = torch.randint(0, cfg.field_vocab, (EMB_B, EMB_HOT), generator=g, device=dev)
    hmask = (torch.rand((EMB_B, EMB_HOT), generator=g, device=dev) < 0.7).float()
    buckets = 1000

    def calls(tables, coll_, to):
        t0_, t1_ = tables
        out = {"collection": coll_.apply({k: to(v) for k, v in ids.items()})}
        for mode in ("sum", "mean", "max"):
            out[f"bag_{mode}"] = eb.bag_lookup(t0_, to(idx), to(seg), EMB_BAGS, mode, to(w))
        out["multihot_mean"] = eb.multihot_lookup(t0_, to(hot), to(hmask), "mean")
        out["multihot_sum"] = eb.multihot_lookup(t0_, to(hot), None, "sum")
        for comb in ("add", "mul"):
            out[f"qr_{comb}"] = eb.qr_embedding(t0_, t1_[:buckets], to(hot), buckets, comb)
        return out

    def grad(table, to):
        t = table.detach().clone().requires_grad_(True)
        torch.sum(eb.bag_lookup(t, to(idx), to(seg), EMB_BAGS, "sum", to(w))).backward()
        return t.grad

    tables = (coll.tables["f0"], coll.tables["f1"])
    with torch.no_grad():
        card = calls(tables, coll, lambda x: x)
        again = calls(tables, coll, lambda x: x)
    g1, g2 = grad(tables[0], lambda x: x), grad(tables[0], lambda x: x)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    for k in card:
        if not torch.equal(card[k], again[k]):
            raise AssertionError(f"embedding (e) {k}: two calls differ on the card")
    if not torch.equal(g1, g2):
        raise AssertionError("embedding (e): the bag sum's gradient differs between two runs")
    if not bool(torch.all(card["bag_max"][7] == float("-inf"))):
        raise AssertionError("embedding (e): an empty max bag is not -inf")
    coll.cpu()
    cpu = lambda x: x.cpu()
    tables_cpu = (coll.tables["f0"], coll.tables["f1"])
    with torch.no_grad():
        host = calls(tables_cpu, coll, cpu)
    g_host = grad(tables_cpu[0], cpu)
    errs = {k: float(torch.nan_to_num((card[k].cpu() - host[k]).abs(), nan=0.0).max())
            for k in card}
    errs["bag_sum_grad"] = float((g1.cpu() - g_host).abs().max())
    for k, e in errs.items():
        if not e <= 1e-6:
            raise AssertionError(f"embedding (e) {k}: card against CPU {e:.3g} > 1e-6")
    out = dict(fields=cfg.n_sparse, vocab=cfg.field_vocab, dim=cfg.embed_dim,
               table_gib=cfg.n_sparse * cfg.field_vocab * cfg.embed_dim * 4 / 2**30,
               max_abs_err=errs, card_s=t_card, seconds=time.perf_counter() - t0)
    print(f"embedding (e): wide-deep's layout ({cfg.n_sparse} fields of {cfg.field_vocab:,} x "
          f"{cfg.embed_dim}, {out['table_gib']:.2f} GiB), B = {EMB_B}, {n_idx} bag indices over "
          f"{EMB_BAGS} bags: the card's results the same bits on two calls (the bag sum's "
          f"gradient too), against the CPU {json.dumps(errs)}; {out['seconds']:.1f} s")
    del coll
    free_card(torch)
    return out


def dryrun_examples_phase(torch, dev, wrappers) -> tuple:
    """Phase 18 (module docstring). Returns the launch counts of (c), the
    ``dryrun`` path, and of (d), the ``examples`` path."""
    t_phase = time.perf_counter()
    free_card(torch)
    print(f"dryrun: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the phase "
          f"({torch.cuda.get_device_name(dev)}; {card_line()})")
    figures = {"counts": dryrun_counts()}
    dry, figures["steps"] = card_steps(torch, dev, wrappers)
    examples, figures["examples"] = run_examples(torch, dev, wrappers)
    figures["embedding"] = embedding_on_card(torch, dev)
    print(f"dryrun figures: {json.dumps(figures)}")
    print(f"dryrun: phase wall time {time.perf_counter() - t_phase:.1f} s; {card_line()}")
    return dry, examples


BENCH_KERNELS = ("bse_encode", "sdim_update", "sdim_fused_serve", "sdim_query", "bse_serve",
                 "target_attention_flash")
BENCH_FUSED_TOL = 1e-5      # phase 19: fused against two-dispatch, fp32 wire
BENCH_INGEST_BOUND = 1.2    # the reference's under-ingest / read-only p95 bound (printed)


def bench_rows(label, rows) -> dict:
    """Print ``rows`` as ``run.py``'s CSV under ``label``; returns them by
    name."""
    for r in rows:
        print(f"bench {label}: {r['name']},{r['us_per_call']:.1f},{r.get('shards', '-')},"
              f"{r['derived']}")
    return {r["name"]: r for r in rows}


def bench_table5(torch, dev) -> dict:
    """19 (a): ``table5_serving.run`` at full size on the card (and its
    ``cpu`` sides on the host), then ``tools/bench_check.py`` on the file it
    wrote, in a child process. Returns the figures."""
    from repro_torch.bench import table5_serving

    t0 = time.perf_counter()
    rows = bench_rows("table5", table5_serving.run(quick=False, device=dev))
    seconds = time.perf_counter() - t0
    path = os.path.join(table5_serving.RESULTS_DIR, "BENCH_serving.json")
    with open(path) as f:
        bench = json.load(f)
    check = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "bench_check.py"), path],
                           capture_output=True, text=True, timeout=120)
    print(check.stdout + check.stderr, end="")
    if check.returncode:
        raise AssertionError(f"bench: tools/bench_check.py rejects {path} "
                             f"(exit {check.returncode})")
    ms = {tag: rows[f"table5/{tag}"]["us_per_call"] / 1e3
          for tag in ("decoupled[cuda]", "inline[cuda]", "target_attention",
                      "decoupled[cpu]", "inline[cpu]")}
    cuda = bench["backends"]["cuda"]
    err = cuda["max_abs_err_fused_vs_two_dispatch"]
    if not err <= BENCH_FUSED_TOL:
        raise AssertionError(f"bench: fused against two-dispatch {err:.3g} > {BENCH_FUSED_TOL}")
    ing, slo, q = bench["ingest"], bench["slo"], bench["quantization"]
    figures = dict(
        seconds=seconds, ms_per_request=ms,
        decoupled_saves_of_ta=1 - ms["decoupled[cuda]"] / ms["target_attention"],
        fused={v: cuda[v] for v in ("fused", "two_dispatch", "fused_int8")},
        speedup_fused_vs_two_dispatch=cuda["speedup_fused_vs_two_dispatch"],
        max_abs_err_fused_vs_two_dispatch=err,
        max_abs_err_int8_vs_fp32=cuda["max_abs_err_int8_vs_fp32"],
        bytes_ratio=q["bytes_ratio"], auc_gap=q["auc_gap"], roofline_bytes=bench["roofline"],
        hit_rate=bench["hit_rate"],
        ingest_p95_ms=dict(read_only=ing["read_only"]["p95_ms"],
                           under_ingest=ing["under_ingest"]["p95_ms"],
                           ratio=ing["p95_ratio"], reference_bound=BENCH_INGEST_BOUND),
        slo=dict(p50_ms=slo["p50_ms"], p95_ms=slo["p95_ms"], p99_ms=slo["p99_ms"],
                 shed_rate=slo["shed_rate"], degrade_rate=slo["degrade_rate"],
                 offered_rps=slo["offered_rps"]),
        span_coverage=bench["trace"]["span_coverage"],
        profile_serve_fused_ms=bench["profile"]["per_kernel"].get("serve_fused", {})
        .get("time_ms"))
    print(f"bench (a) Table 5 at T = 2,000, B = 1,024, 20 requests: ms/request decoupled "
          f"{ms['decoupled[cuda]']:.2f}, inline {ms['inline[cuda]']:.2f}, target attention "
          f"{ms['target_attention']:.2f} (cpu side: decoupled {ms['decoupled[cpu]']:.2f}, "
          f"inline {ms['inline[cpu]']:.2f}); decoupled saves "
          f"{100 * figures['decoupled_saves_of_ta']:.1f}% of TA (paper: 95%)")
    print(f"bench (a) fused {cuda['fused']['users_per_sec']:.0f} users/s (p50/p95/p99 "
          f"{cuda['fused']['p50_ms']}/{cuda['fused']['p95_ms']}/{cuda['fused']['p99_ms']} ms) "
          f"against two-dispatch {cuda['two_dispatch']['users_per_sec']:.0f} users/s "
          f"({cuda['two_dispatch']['p50_ms']}/{cuda['two_dispatch']['p95_ms']}/"
          f"{cuda['two_dispatch']['p99_ms']} ms), N = {cuda['n_users']}; max |fused - "
          f"two-dispatch| {err:.3g} (<= {BENCH_FUSED_TOL}); int8 bytes ratio "
          f"{q['bytes_ratio']}x, AUC gap {q['auc_gap']:.3g} (bound 1e-3)")
    print(f"bench (a) hot-tier hit rate {json.dumps(bench['hit_rate'])}; under-ingest p95 "
          f"{ing['under_ingest']['p95_ms']} ms against read-only {ing['read_only']['p95_ms']} "
          f"ms: {ing['p95_ratio']}x (the reference's bound {BENCH_INGEST_BOUND}x; printed, "
          f"not a gate); SLO p50/p95/p99 {slo['p50_ms']}/{slo['p95_ms']}/{slo['p99_ms']} ms, "
          f"shed {100 * slo['shed_rate']:.1f}%, degraded {100 * slo['degrade_rate']:.1f}%; "
          f"{seconds:.1f} s ({card_line()})")
    return figures


def bench_kernel_checks(torch, dev) -> dict:
    """19 (d): each kernel the phase runs, at the phase's own shapes, against
    its plain version on margin-screened inputs (uncounted): Table 5's
    request (one user of T = 2,000 behaviors, d = 64, against 1,024
    candidates: bse_encode, sdim_query off the bf16 wire, bse_serve,
    target_attention_flash), Table 1's eta (target_attention_flash over
    4,096 users of one candidate and the k = 48 rows retrieved, d = 128),
    the fused section's burst (sdim_fused_serve, 256 of 1,024 rows, fp32
    and int8), the throughput section's chunk at m = 24 (bse_encode over
    256 users of 256 behaviors, sdim_query of 8 candidates off the bf16
    wire, sdim_update of 256 events into 1,024 rows) and the sharded
    section's fold into one shard (16 events into 64 rows); the training
    shapes at d = 32 (bse_encode, sdim_query and both backward kernels, C =
    1): Table 4 and Fig. 5's (B = 128, L = 256) at every tau of Table 4
    (m = 48, 48, 48, 45, 40 for tau 1, 2, 3, 5, 10: tau 5 and 10 run the
    large-tau paths) and the AUC section's (B = 128, L = 64, m = 24, tau =
    3). At Table 4's tau 3, 5 and 10 it also times the four kernels and
    their plain versions (CUDA events, median of 10) beside the bound of
    their bytes and operations. Returns the max abs errors."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.screen import screened_normal
    from repro_torch.kernels.sdim_bucket.sdim_bucket import (bse_encode, bse_encode_backward,
                                                             bse_encode_backward_ref,
                                                             bse_encode_ref)
    from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import (sdim_fused_serve,
                                                                       sdim_fused_serve_ref)
    from repro_torch.kernels.sdim_query.sdim_query import (sdim_query, sdim_query_backward,
                                                           sdim_query_backward_ref,
                                                           sdim_query_ref)
    from repro_torch.kernels.sdim_serve.sdim_serve import bse_serve, bse_serve_ref
    from repro_torch.kernels.sdim_update.sdim_update import sdim_update, sdim_update_ref
    from repro_torch.kernels.target_attn.target_attn import (target_attention_flash,
                                                             target_attention_flash_ref)
    from repro_torch.serve.quant import quantize_rows

    rng = np.random.default_rng(19)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    front = lambda b, l: t((np.arange(l)[None] >= rng.integers(0, l // 2, b)[:, None])
                           .astype(np.float32))
    errs = {}

    def close(name, out, ref, tol):
        errs[name] = check_close(f"bench (d) {name}", out, ref, **tol)

    with uncounted():
        R = rng.standard_normal((48, 64)).astype(np.float32)
        seq, q = t(screened_normal(rng, (1, 2000, 64), R)), t(screened_normal(rng, (1, 1024, 64), R))
        mask, Rt = front(1, 2000), t(R)
        close("bse_encode T=2000", bse_encode(seq, mask, Rt, 3), bse_encode_ref(seq, mask, Rt, 3),
              ATOMIC)
        wire = bse_encode_ref(seq, mask, Rt, 3).to(torch.bfloat16)
        close("sdim_query B=1024 bf16 wire", sdim_query(q, wire, Rt, 3),
              sdim_query_ref(q, wire, Rt, 3), FP32)
        close("bse_serve T=2000 B=1024", bse_serve(q, seq, mask, Rt, 3),
              bse_serve_ref(q, seq, mask, Rt, 3), FP32)
        close("target_attention_flash T=2000 B=1024", target_attention_flash(q, seq, mask),
              target_attention_flash_ref(q, seq, mask), FP32)
        fq, fs = t(rng.standard_normal((4096, 1, 128)).astype(np.float32)), \
            t(rng.standard_normal((4096, 48, 128)).astype(np.float32))
        fm = torch.ones((4096, 48), device=dev)
        close("target_attention_flash eta 4096 x k=48", target_attention_flash(fq, fs, fm),
              target_attention_flash_ref(fq, fs, fm), FP32)

        R = rng.standard_normal((24, 32)).astype(np.float32)
        Rt = t(R)
        store = t(rng.standard_normal((1024, 8, 8, 32)).astype(np.float32))
        slots = torch.arange(256, dtype=torch.int32, device=dev)
        fq = t(screened_normal(rng, (256, 8, 32), R))
        close("sdim_fused_serve fp32 256 of 1024", sdim_fused_serve(store, slots, fq, Rt, 3),
              sdim_fused_serve_ref(store, slots, fq, Rt, 3), FP32)
        payload, scales = quantize_rows(store, dtype=torch.int8)
        close("sdim_fused_serve int8 256 of 1024",
              sdim_fused_serve(payload, slots, fq, Rt, 3, scales=scales),
              sdim_fused_serve_ref(payload, slots, fq, Rt, 3, scales=scales), FP32)
        ev_slots = t(rng.choice(1024, 256, replace=False).astype(np.int32))
        events = t(screened_normal(rng, (256, 1, 32), R))
        ev_mask = torch.ones((256, 1), device=dev)
        a, b = store.clone(), store.clone()
        sdim_update(a, ev_slots, events, ev_mask, Rt, 3)
        sdim_update_ref(b, ev_slots, events, ev_mask, Rt, 3)
        close("sdim_update 256 events into 1024 rows", a, b, FP32)
        shard_slots = t(rng.choice(64, 16, replace=False).astype(np.int32))
        a, b = store[:64].clone(), store[:64].clone()
        shard_events, shard_mask = events[:16].contiguous(), ev_mask[:16].contiguous()
        sdim_update(a, shard_slots, shard_events, shard_mask, Rt, 3)
        sdim_update_ref(b, shard_slots, shard_events, shard_mask, Rt, 3)
        close("sdim_update shard 16 events into 64 rows", a, b, FP32)
        seq = t(screened_normal(rng, (256, 256, 32), R))
        mask = front(256, 256)
        table = bse_encode_ref(seq, mask, Rt, 3)
        close("bse_encode m=24 256 users", bse_encode(seq, mask, Rt, 3), table, ATOMIC)
        wire, q = table.to(torch.bfloat16), t(screened_normal(rng, (256, 8, 32), R))
        close("sdim_query m=24 C=8 bf16 wire", sdim_query(q, wire, Rt, 3),
              sdim_query_ref(q, wire, Rt, 3), FP32)

        def timed(label, kernel, plain, c, args):
            ms, plain_ms = time_ms(lambda: kernel(*args), 10), time_ms(lambda: plain(*args), 10)
            b_ms, b_by = bound(c)
            times[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

        def training(label, B, L, m, tau, time_it=False):
            R = rng.standard_normal((m, 32)).astype(np.float32)
            Rt = t(R)
            seq = t(screened_normal(rng, (B, L, 32), R))
            q = t(screened_normal(rng, (B, 1, 32), R))
            mask = front(B, L)
            table = bse_encode_ref(seq, mask, Rt, tau)
            close(f"bse_encode {label}", bse_encode(seq, mask, Rt, tau), table, ATOMIC)
            close(f"sdim_query {label}", sdim_query(q, table, Rt, tau),
                  sdim_query_ref(q, table, Rt, tau), FP32)
            dout = t(rng.standard_normal((B, 1, 32)).astype(np.float32))
            dT = sdim_query_backward_ref(dout, q, table, Rt, tau)
            close(f"sdim_query_backward {label}", sdim_query_backward(dout, q, table, Rt, tau),
                  dT, FP32)
            close(f"bse_encode_backward {label}", bse_encode_backward(dT, seq, mask, Rt, tau),
                  bse_encode_backward_ref(dT, seq, mask, Rt, tau), FP32)
            if not time_it:
                return
            G, U, d, hash_flops = m // tau, 1 << tau, 32, 2 * m * 32 + (m // tau) * 32
            valid, bwd_bytes = float(mask.sum()), 4 * (2 * B * G * U * d + 2 * B * d + m * d)
            timed(f"bse_encode {label}", bse_encode, bse_encode_ref,
                  cost.settle(cost.encode(seq, mask, Rt, tau=tau)), (seq, mask, Rt, tau))
            timed(f"sdim_query {label}", sdim_query, sdim_query_ref,
                  cost.settle(cost.query(q, table, Rt, tau=tau)), (q, table, Rt, tau))
            timed(f"sdim_query_backward {label}", sdim_query_backward, sdim_query_backward_ref,
                  cost.Cost(B * hash_flops + 8.0 * B * G * U * d, float(bwd_bytes)),
                  (dout, q, table, Rt, tau))
            timed(f"bse_encode_backward {label}", bse_encode_backward, bse_encode_backward_ref,
                  cost.Cost(valid * (hash_flops + G * d),
                            4 * (valid * (G + 1) * d + B * L * (d + 1) + m * d)),
                  (dT, seq, mask, Rt, tau))

        times = {}
        for tau in (1, 2, 3, 5, 10):
            m = tau * (48 // tau)
            training(f"tau={tau} m={m}", 128, 256, m, tau, time_it=tau >= 3)
        training("auc m=24 L=64", 128, 64, 24, 3)
    print(f"bench (d) each kernel at the phase's shapes against its plain version "
          f"(screened inputs, uncounted): max abs err {json.dumps(errs)}")
    print(f"bench (d) Table 4's training shape (B = 128, L = 256, d = 32, C = 1), ms of the "
          f"kernel, its plain version and the bound: {json.dumps(times)}")
    return errs


def bench_phase(torch, dev, wrappers):
    """Phase 19 (module docstring). Returns the launch counts."""
    from repro_torch.bench import (fig2_attention_patterns, fig5_m_sweep, table1_complexity,
                                   table4_tau)

    t_phase = time.perf_counter()
    free_card(torch)
    reset(wrappers)
    figures = {"table5": bench_table5(torch, dev)}
    free_card(torch)
    t0 = time.perf_counter()
    rows = bench_rows("table1", table1_complexity.run(quick=False, device=dev))
    scaling = rows["table1/bse_query_L_scaling"]["derived"]
    figures["table1"] = dict(seconds=time.perf_counter() - t0, L_scaling=scaling,
                             us={n: r["us_per_call"] for n, r in rows.items()})
    print(f"bench (b) Table 1 at L up to 16,384 and B up to 4,096: {scaling}; "
          f"{figures['table1']['seconds']:.1f} s")
    free_card(torch)
    t0 = time.perf_counter()
    smoke = {"fig2": fig2_attention_patterns.run(),
             "table4": table4_tau.run(quick=True, smoke=True, device=dev),
             "fig5": fig5_m_sweep.run(quick=True, smoke=True, device=dev)}
    for name, r in smoke.items():
        bench_rows(name, r)
    figures["smoke"] = dict(seconds=time.perf_counter() - t0)
    print(f"bench (c) Fig. 2, Table 4, Fig. 5 at smoke depth (AUCs printed, not gated): "
          f"{figures['smoke']['seconds']:.1f} s")
    launches = read_launches(wrappers, BENCH_KERNELS, "bench")
    figures["launches"] = launches
    figures["max_abs_err"] = bench_kernel_checks(torch, dev)
    print(f"bench figures: {json.dumps(figures)}")
    print(f"bench: phase wall time {time.perf_counter() - t_phase:.1f} s; {card_line()}")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found next to this script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions hash in IEEE fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.configs import sdim_paper
    from repro_torch.kernels import _build
    from repro_torch.models.ctr import CTRModel

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib, ROOT)}")
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "Used" in line or line.startswith("=="):
            print("  " + line.strip())

    timed = kernel_phase(torch, dev)
    by_name = {k["name"]: k for k in timed}
    for k in kernel_phase(torch, dev, D36):
        by_name[k["name"]]["d36"] = {"d": D36, **{key: v for key, v in k.items() if key not in
                                                  ("name", "route", "source", "replaces")}}
    wrappers, backward = all_wrappers()[:6], all_wrappers()[6:]
    t0 = time.perf_counter()
    model = CTRModel(sdim_paper.FULL, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"model init: {time.perf_counter() - t0:.2f} s "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters)")
    requests = request_stream(64, model.cfg)
    by_path = {}
    launches, bf16_wire_scores = decoupled_phase(torch, dev, wrappers, model, requests)
    by_path["decoupled"] = dict(launches)
    by_path["inline"] = inline_phase(torch, dev, wrappers, model, requests, bf16_wire_scores)
    launches["bse_serve"] = by_path["inline"]["bse_serve"]
    del model
    by_path["target"] = target_phase(torch, dev, wrappers, requests)
    launches["target_attention_flash"] = by_path["target"]["target_attention_flash"]
    torch.cuda.empty_cache()
    by_path["train"] = train_phase(torch, dev, wrappers + backward)
    by_path["comparison"] = comparison_phase(torch, dev, wrappers + backward)
    torch.cuda.empty_cache()
    by_path["production"] = production_phase(torch, dev, wrappers)
    torch.cuda.empty_cache()
    by_path["archs"] = archs_phase(torch, dev, wrappers + backward)
    torch.cuda.empty_cache()
    by_path["profile"] = profile_phase(torch, dev, wrappers)
    torch.cuda.empty_cache()
    by_path["sharded"] = sharded_phase(torch, dev, wrappers)
    by_path["lm"], by_name["sdim_query"]["lm"] = lm_phase(torch, dev, wrappers)
    by_path["moe_mla"], moe_mla_query = moe_mla_phase(torch, dev, wrappers)
    by_name["sdim_query"].update(moe_mla_query)
    by_path["lm_train"] = lm_train_phase(torch, dev, wrappers + backward)
    by_path["gnn"] = gnn_phase(torch, dev, wrappers + backward)
    by_path["mesh"] = mesh_phase(torch, dev, wrappers + backward)
    by_path["dryrun"], by_path["examples"] = dryrun_examples_phase(torch, dev,
                                                                   wrappers + backward)
    by_path["bench"] = bench_phase(torch, dev, wrappers + backward)
    for w in backward:
        launches[w.__name__] = by_path["train"][w.__name__]
    for k in timed:
        k["launches"] = launches[k["name"]]
        k["launches_by_path"] = {path: counts.get(k["name"], 0)
                                 for path, counts in by_path.items()}
    print(card)
    print(json.dumps({"kernels": timed}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
