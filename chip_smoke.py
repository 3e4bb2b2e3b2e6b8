#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all started together, sm_90a) and prints the card, the
   versions and the build time.
2. Kernel phase: each of the four wire-encode kernels against its plain
   PyTorch version on the same CUDA tensors, bitwise (signed zeros and
   survivor counts included), at (1, n) for n ∈ {1, 3, 257, 8193, 2^20,
   2^24, 2^24 + 3}, (5, 8193) (rows off 16 bytes) and a stacked (16,
   2000); encode and select at k ∈ {1, n/100, n} (at least k kept),
   t = +inf and magnitudes tied at t; encode, select and absmax also on
   rows with NaN of either sign, ±inf and −0.0 (encode's NaN residuals
   held to the plain version on the CPU by position, their payloads
   being the arithmetic's); then CUDA-event times beside the byte bound,
   the plain version and one PyTorch library call where one computes the
   same function: encode and select median and min–max of 6 runs in
   turns with a device copy of the rows, beside the first design's
   recorded times (one atomic a warp, behind a zero fill); absmax in turns
   with ``vector_norm(x, inf, dim=1)``; quant-dequant the median of 20
   replays of a CUDA graph of the launches; all four also at the
   executors phase's (8 × 16, 2000) rows.  The int8 wire encode
   (``int8_encode``: EF add, scale, round trip and residual; one launch
   for rows of at most N_A = 16,384, absmax + quant above), with and
   without a residual, out, res and scale bitwise ``int8_encode_ref`` at
   those shapes and rows of N_A and N_A + 1, on the edge rows also equal
   to the plain version on the CPU by value and NaN position, and
   quant-dequant alone bitwise its plain version on the edge rows; timed
   in turns with the seven-launch chain it replaced at (16, 2000),
   (128, 2000), 2^24 and the training leaf.  Past grid.y's 65,535 blocks
   (each block loops over rows): every wire wrapper at 65,535, 65,536 and
   100,000 rows, bitwise its plain version with one launch a call —
   encode, select, absmax and quant-dequant at n 2,000 and 2,001, the int8
   encode's route A at n 2,000 and route B at n 16,392, with and without
   EF; encode, select and the int8 encode timed at (100,000, 2,000).
3. Main path: ``repro_torch.api.fit`` with ``GradientDescent(logistic_loss)``
   on the local executor at the shape of the dense PASCAL "epsilon" set
   (400,000 × 2,000 f32, K = 16 nodes of 25,000 rows; synthetic, made on
   the card from a seeded generator), 20 rounds each of (a) allreduce ×
   topk:0.01+ef, (b) allreduce × int8+ef, (c) delay_line(2) × topk:0.01,
   (d) sequential_server × dense.  Checks that the loss falls, that each
   kernel was launched steps × eligible leaves times, the ledger bytes,
   and that (a) and (b) with ``use_kernel=False`` are bitwise the same fit.
   Then, on the same data and counted with them: (e) allreduce ×
   ``LBFGS(logistic_loss)`` × dense (loss falls, θ finite, ledger rounds
   21, the initial gradient charged as one Allreduce of θ; its loss beside
   dense GD's), (f) allreduce × ``dp:1.0,0.0001>topk:0.01+ef`` (the encode
   kernel 20 times, uplink 20 × 16 top-k pushes, loss falls; beside run
   (a)'s), (g) delay_line(2) × ``topk:0.01>secagg`` and (h) allreduce ×
   ``int8+ef>secagg``, bitwise runs (c) and (b) (θ, trajectory, ledger)
   with their kernels' launches.  The security wires on the card at
   (16, 2000): DP with σ = 0 gives each row norm min(‖m‖, clip) to rtol
   1e-4; on zero messages its noise has std within 5 % of σ·clip and
   |mean| < 0.05, the same counters give the same draws and advanced ones
   new draws; secagg's payloads each differ from their message and sum to
   the aggregate to rtol = atol = 1e-3.  ``private_second_order`` at the
   epsilon shape: θ within rtol 1e-4 (atol 1e-4 of max |θ|) of a float64
   solve on the card, uplink 16 × (2000² + 2000) × 4 = 256,128,000 bytes
   and downlink 8,000.  The rest of ``ml/``, each within 60 s, with its
   wall time, peak memory and cuts: the cascade SVM (16 × 1,250 rows of
   the epsilon shape, 20,000 pooled, 4 rounds: each round's global SVs
   inside its pushed union, decision signs above chance), the GP experts
   and ``distributed_sgpr`` (1-D, 16 × 2,000 points: the four rules within
   rmse 0.12 of the exact GP in float64, the sparse posterior at its
   inducing points inside the exact GP's 2σ predictive band) and
   consensus MPLE (a 50-variable chain GMRF, 16 × 5,000 samples: support
   F1 above 0.95, the primal residual shrinking).
   The executors phase, on the same data: (i) ``executor="sweep"`` over 8
   learning rates × allreduce × ``topk:0.01+ef`` (the encode kernel 20
   times for the 8 × 20 scenario-rounds), scenario-rounds/s beside run
   (a)'s rounds/s; (ii) a staleness sweep D ∈ {0, 1, 2, 3} × delay_line ×
   ``topk:0.01`` (the select kernel 20 times); (iii) a dropout sweep p ∈
   {0, 0.2, 0.5} × a ``FaultPlan`` (a straggler lag, a quorum of 10) ×
   ``int8+ef`` (the one-launch int8 encode 20 times).  Each sweep: kernel on ≡
   off bitwise, every scenario's ledger its solo fit's, the same sweep
   over the dense wire within rtol 1e-6 / atol 1e-7 of its solo fits, and
   the kernel wire's θ gap to its solo fits with the first round apart
   (a swapped survivor or the next quantum: ROADMAP queue 3, item 18).
   Then over NCCL on a world of one: (iv) the mesh on run (a)'s spec,
   bitwise run (a); (v) multipod on a (1, 1) mesh, bitwise (iv), its
   ``by_hop`` split summing to the total; (vi) ``mesh+sweep`` of (i)'s 8
   learning rates, bitwise (i).
   Many clients (counts set to 0 before the phase and read after), on
   views of the same records: (m1) 100,000 clients of 4 records ×
   allreduce × ``topk:0.01+ef`` and (m2) × ``int8+ef``, 20 rounds — the
   encode launched once a round on all 100,000 rows, the loss falls, the
   uplink exactly 20 × 100,000 × 160 and × 2,004 bytes, bitwise the
   ``use_kernel=False`` fit; (m3) run (i)'s 8-lr sweep over 10,000
   clients of 40 records under both wires — one launch a round on 80,000
   folded rows, bitwise the ``use_kernel=False`` sweep, ledgers exact, the
   gap to the solo fits at lr 1.0 and 3.0 reported and the dense twin's
   held at rtol 1e-6 / atol 1e-7; rounds/s and peak memory of each.
4. Decode-attention kernel phase: the kernels (split over S, then the
   merge) against their plain version (``decode_attention_plain``) in f32
   and bf16 at the JAX package's test shapes, the serving shape (B 16, S
   1024, Hq 32, Hkv 4, D 64) and qwen2's heads (G 6, D 128), every row
   seeing valid lengths 0, 1, S and one that is no multiple of a tile;
   limits 2e-5 (f32) and 3e-2 (bf16), the JAX package's own.  The split
   kernel's partials and the merge each against their plain versions
   (``decode_partials_plain``, ``decode_merge_plain``); a CUDA graph of the
   pair replays bitwise to the eager result.  Times, in turns with
   ``F.scaled_dot_product_attention(..., enable_gqa=True)`` (median and
   min–max of 6 runs), at the serving shape with rows full and at the
   serving run's lengths (48–640), beside the byte bound and the plain
   version; the merge alone.  (H0) The same checks at the 16-slot serving
   shapes of Gemma-2B's (8 / 1 at D 256), Qwen2-7B's (G 7), StarCoder2-3B's
   (G 12), Falcon-7B's (MQA, G 71) and Phi-3-mini's (D 96) heads and at G
   3, 5, 12 and D 24, 40, 80, 36 (the last padded to 40 by the wrapper,
   with the true width's scale); Gemma-2B's and Falcon-7B's shapes timed
   in turns with SDPA beside the larger of the byte and operation bounds.
5. Serving: ``repro_torch.serve.ContinuousLMEngine`` as
   ``python -m repro_torch.launch.serve --continuous`` builds it, for
   tinyllama-1.1b at full width and depth (bf16 compute, f32 parameters
   from a seeded ``torch.Generator`` on the card), 16 slots, page size 16,
   max_seq 1024, 48 greedy requests with prompts of 32–512 and 16–128 new
   tokens (seeded numpy).  Checks every ticket, the split kernel's and the
   merge's launches (decode steps × 22 each) and hits, and the ledger
   bytes; holds one captured
   decode step's logits with the kernel against ``use_kernel=False``; prints
   tokens/s, step ms, time to first token, peak memory and set-up time, and
   where that step's time goes (host wall and enqueue, device time as a
   CUDA graph, aten operations dispatched, and the parts on the device).
   Then the CLI itself, briefly.  (H1) tinyllama-1.1b re-headed as
   Gemma-2B's attention (8 query heads and 1 KV head of 256 over the same
   width 2,048) served the same way: 22 launches of each decode kernel a
   step, a captured step held to the plain path, the step's wall, aten
   operations and device time; then 16 greedy requests of 32 tokens
   through it and through the same engine with ``use_kernel=False``,
   whose ids must agree up to a near tie the step's own kernel-vs-plain
   logit difference explains.  Then serving and tracing (each part's
   kernel counts set to 0 before it and read after): (A) run (a) again
   on ``api.ServingExecutor(registry=ModelRegistry(tmp),
   publish_as="epsilon")`` — bitwise run (a), 20 encode launches,
   ``registry.load`` bitwise θ — then 4,096 single-row requests of 2,000
   f32 through ``MicroBatcher(ServeEngine.from_registry(...),
   max_batch=64)``, drained as ``launch.serve._drain`` drains: each answer
   bitwise its bucket's predict, all within 1e-5 × max |answer| of one
   predict of the 4,096 rows (the largest gap printed), the ledger 4,096 ×
   8,000 bytes up and 4,096 × 4 down, a ``swap`` to a perturbed θ changes
   the answers; requests/s, p50 and p95 latency, flushes, padded slots.
   (B) run (a) with ``tracer=Tracer(), trace="phases"`` and again on the
   mesh of a world of one — both bitwise run (a), the spans ``fit/loop``,
   ``fit/ledger``, ``fit/metrics``, ``phase/local_step``,
   ``phase/encode`` (and ``hop/flat``, ``phase/stats_completion`` on the
   mesh) present with their ms; traced against untraced rounds/s in
   turns; ``export_chrome`` read back by ``json.load`` with one complete
   event a span; ``RunReport.from_fit(...).to_markdown()``; one
   ``device_trace`` around 3 rounds in which the profiler sees the
   ``topk_encode`` kernel by name, 3 times.  (C) tinyllama-1.1b at full
   width through ``launch.serve.main`` without ``--continuous`` (B 8,
   22 requests of 128 tokens, 32 generated: buckets 8, 8 and 8, two
   padded; batched prefill into a contiguous f32 cache, the plain
   ``_sdpa``, no kernel): the padded bucket's 6 real rows get the ids the
   same prompts get in a full bucket, the ledger 22 × 128 × 4 bytes up and
   22 × 32 × 4 down; tokens/s, p50 and p95 request latency, the stats
   JSON, and how often batched-prefill ids agree with loop-prefill ids for
   2 prompts (reported: bf16 may part them).  (D) the serving workload's
   first 6 requests on ``ContinuousLMEngine`` untraced and inside
   ``activated(Tracer())``: the same greedy ids, one ``serve/decode_step``
   span a step, 6 ``serve/requests``, the decode kernels' launches (steps
   × 22 each), ``RunReport.from_serve``.
6. Nearest-centroid kernel phase: the two kernels, routed by metric (l2
   to the tensor-core kernel, l1 and l∞ to the CUDA-core one), against
   their plain version (``pdist_argmin_ref``), f32 and bf16, at the JAX
   package's test shapes, K = 1, K 1024 × d 512, duplicated centroid rows
   (ties take the first index), 3,001 and 513 points (off the CUDA-core
   kernel's 256-point pass), the first 8,192 points of the main shape
   and an adversarial input for the l2 route (‖x‖² ≈ 1e6, centroids in
   pairs 1e-3 apart: the rows its guard re-checked are printed);
   distances within atol 1e-5 + rtol 1e-5·|plain|, indices equal
   wherever the top-2 gap clears that.  (H0) l1 and l∞ past one staged
   centroid row, 4,096 points × d 58,109 and 100,000 against 16 (the
   split kernel and its merge), in both types, and timed at d 100,000 in
   turns with ``torch.cdist(p)`` ``.min(dim=1)``.  Times in turns (median and
   min–max of 6 runs) at the main shape (4,898,432 × 42 against 1,000,
   l2, f32) of the tensor-core route (f32 and bf16) and
   ``torch.cdist(X, C).min(dim=1)`` (eager), beside the 3xTF32 operation
   bound and the f32 one.  The CUDA-core kernel under l1 and under l∞ at
   ``kmeans(metric="l1" | "linf")``'s shape (several 256-point passes a
   block), held to the plain version in f32 and bf16, with X on 16 bytes
   and one row off them, then timed in turns with ``torch.cdist(p=1)``
   and ``torch.cdist(p=inf)`` ``.min(dim=1)``, beside its
   instruction-issue bound and the first design's recorded times; and
   alone at the KDD shape, the last timed launch held to the plain
   version on its first 262,144 and last 65,536 points.
7. Clustering: ``repro_torch.ml.clustering.distributed_kmeans`` at the KDD
   Cup 1999 shape (16 sites × 306,152 × 42, K = 1000, 20 iterations; a
   planted mixture made on the card from a seed): exactly 21 launches of
   the tensor-core route and none of the CUDA-core one, the rows the
   guard re-checked in each E-step, inertia below C0's, the §4.1 identity
   against centralized k-means on the union (empty clusters kept, as
   ``distributed_kmeans`` keeps them; ``kmeans`` itself, which zeroes
   them, is run and reported), and where an iteration's time goes (E-step,
   M-step, profiled device busy time against wall).  Then, at a reduced
   16 × 20,000 × 42: k-windows through ``fit`` (ledger bytes checked),
   ``consensus_kmeans`` (launches = iterations × sites × local EM steps),
   ``kmeans_pp_init`` at K = 1000 on one site, and ``kmeans`` under l1 and
   l∞ (the CUDA-core route's path: iterations + 1 launches each).  (H3)
   ``kmeans(metric="l1")`` at 1,024 × 100,000, K 8: its E-steps through
   the split kernel, its assignments and centroids bitwise the same
   k-means with the plain E-step.
8. Flash-attention kernel phase: the two routes, by type (f32 to the
   3xTF32 kernel with its prep kernel, bf16 to the bf16 tensor-core one),
   against their plain version (``attention_ref``) at the JAX package's
   five test shapes (padding, window, bidirectional), a query offset with
   T < S, a window that leaves rows with no key (they must be 0), D 8, D
   128, a ragged S, tinyllama-1.1b's heads at B 8 × T 2048 and
   qwen2-1.5b's at B 2 × T 4096, causal, (H0) D 24, 40, 80, 96, 192, 256
   and 36 (padded to 40), causal, windowed and offset, and Gemma-2B's
   8 / 1 heads of 256 at B 8 × T 2048; limits 2e-5 (f32) and 3e-2
   (bf16), the JAX package's own; the prep kernel bitwise its plain
   version (``tf32_image_ref``) at every f32 shape; the bf16 kernel also
   against ``attention_bf16p`` (its own arithmetic); two bq/bk choices
   bitwise equal.  Times in turns (median and min–max of 6 runs) of the
   bf16 kernel and ``F.scaled_dot_product_attention(..., is_causal=True,
   enable_gqa=True)`` at the three heads' shapes, and of the f32 route (the
   3xTF32 kernel alone, and prep + kernel) with f32 SDPA at those shapes,
   beside the bound (causal operations at the type's rate, or the bytes of
   q, k, v and the output; for f32 the 3xTF32 and the CUDA-core bounds),
   the plain version and the earlier f32 kernel's recorded times.
9. Attention path: ``attn_apply(..., use_kernel=True)`` for each of
   tinyllama-1.1b's 22 layers at full width (parameters from a seeded
   ``torch.Generator`` on the card, bf16 compute) on a B 8 × T 2048 batch
   of embedded, RMS-normed tokens from a numpy seed: exactly 22 launches of
   the tensor-core kernel, each output row within 3e-2 and within 0.8 % in
   norm of the plain ``_sdpa`` and of ``_sdpa_q_chunked``
   (``attn_q_chunk=512``); the output's rms; wall ms, device ms and the
   memory each call adds, for the three paths.  Then the 22 layers again
   with f32 compute (22 launches each of the 3xTF32 kernel and its prep,
   TF32 off for the plain paths), within 2e-5, the summed device ms beside
   the bf16 run's, and a planted control (the kernel with ``q_offset=-1``:
   each query loses its own key) that both checks must catch in ≥ 99 % of
   the rows of the prompt's second half, at the first and last layer.
   The kernel path must add less memory a call than its activations take
   in f32 (``kernel_path_bytes``), which is under the plain path's logits.
   (H2) The re-headed model's 22 layers the same way in both types, its
   planted control included, 22 launches of each route's kernels.
10. Top-k phase: ``count_ge`` and ``apply_threshold`` against their plain
   versions, exactly (counts equal, masks bitwise), at the sizes of
   tests/test_kernels_topk.py, 2^24 and tinyllama-1.1b's largest leaf (the
   stacked (22, 2048, 5632) FFN projection, 253,755,392 f32), f32 and
   bf16, unsorted thresholds with 0 among them, the mask also on a view
   one element off 16 bytes; the count also on edge cases (NaN of either
   sign, ±inf and ±0.0 among elements and thresholds, duplicated and
   negative thresholds, x 0, 1 and 3 elements off 16 bytes) at 1 to 2^24
   elements; ``topk_sparsify`` on that leaf at k = 1 % (3 count and 1 mask
   launches, at least k survivors, every kept magnitude at least every
   dropped one, its peak device memory, and the bracket's max |x| as
   ``x.abs().max()`` (an |x| temporary) and as the one-pass
   ``vector_norm(x, inf)``: equal bits, peak memory and time in turns); times beside the bounds, median and min–max
   of 6 runs in turns: the count on the f32 and bf16 leaf (and at the
   second round's candidates, where nearly every element ranks 0), the
   mask with ``F.hardshrink(x, nextafter(t, 0))`` (bitwise the same
   function on f32), the whole function (graph-captured, so no host round
   trip) with ``torch.topk(x.abs().flatten(), k)`` (eager); encode and
   select on the leaf as one row at its exact k-th magnitude, bitwise the
   plain version, timed in turns as in 2.
11. Training: tinyllama-1.1b at full width and depth (f32 parameters from
   a seeded ``torch.Generator`` on the card, bf16 compute, the reference's
   train-shape settings ``remat_policy="full"`` and ``attn_q_chunk=512``)
   trains through ``repro_torch.api.fit`` as ``launch/train.py`` drives
   it: ``OptimizerStrategy`` (clip 1 ∘ Adam ∘ warmup-cosine) ×
   ``delay_line(1)`` × ``topk:0.01+ef``, one fit a step resumed from the
   last carry, 2 warm-up and 6 timed steps at B 8 × T 2048 of
   ``synthetic_lm_batches``.  First the gradient with ``forward``'s one
   ``unbind(0)`` against the same loss with the layer weights taken as
   ``x[r]``: bitwise on every stacked leaf, with each one's device ms and
   peak memory.  Checks: every loss finite and the last below the first;
   the ledger's uplink exactly steps × Σ max(1, round(0.01·n))·8; the
   encode kernel launched once per leaf per step and no other kernel; the
   last step's encode of the largest gradient leaf (the (22, 2048, 5632)
   FFN stack as one row) bitwise its plain version.  Prints per step the
   wall ms, tokens/s and peak memory, and device ms (CUDA events) of
   forward + backward, clip + Adam, the wire (of it ``torch.topk`` with
   ``c = u + r`` and ``|c|``, and the encode kernel) and the delay line;
   the model-FLOP share (6·N·tokens against 989 TFLOP/s dense bf16); the
   state's size; and one more forward + backward under the profiler,
   its device time by kind of kernel.  Then the int8 wire's training run
   (its counts set to 0 before it and read after): tinyllama-1.1b at full
   width cut to 2 layers, 3 steps of B 2 × T 256 under ``int8+ef``, each
   leaf one row: the norms through the one-launch encode, the matrices
   (up to 65.5 M elements) through absmax + quant, once a leaf a step;
   bitwise the same fit with ``use_kernel=False``.
12. MLA, MoE and multi-token prediction (each part's kernel counts set to
   0 before it and read after): olmoe-1b-7b at full width and depth (6.92
   B f32 parameters from a seeded generator on the card, bf16 compute, 64
   experts top-8) on ``ContinuousLMEngine`` as ``launch.serve
   --continuous`` builds it, 16 slots, 32 greedy requests (prompts
   16–256, 16–64 new tokens): both decode kernels launched steps × 16,
   no other kernel, every ticket, the ledger; decode tokens/s, step ms,
   peak memory, and one step of 16 live slots (wall, enqueue, aten
   operations, device ms as a CUDA graph, the 16 MoE FFNs alone) beside
   its byte bound (every weight the step reads, once); then the CLI
   itself, briefly.  olmoe at full width with 2 of its 16 layers in f32:
   a prefill of (4, 64) and 8 decode steps on the card against the port
   on the CPU with the same weights (logits within atol = rtol = 1e-4;
   expert choices equal wherever the k-th and (k+1)-th router
   probabilities are more than 1e-6 apart), two card runs bitwise equal in
   f32 and in bf16.  minicpm3-4b at full width and depth (62 MLA layers)
   through ``launch.serve.main`` (B 8, P 128, 32 generated, the contiguous
   ``MLACache``; no kernel): generated tokens/s and peak memory; one f32
   decode step absorbed against unabsorbed within 2e-3.  deepseek-v3-671b
   ``reduced()`` (MLA, a dense first layer, MoE with a shared expert,
   MTP) through ``launch.train.main --compress-topk 0.01`` for 8 steps of
   B 8 × T 128: the loss falls, the encode kernel once a step on each of
   the 51 leaves of ≥ 256 elements, the trained θ's ``ce`` / ``aux`` /
   ``mtp`` finite, and 8 greedy decode steps through ``prefill_and_decode``.
13. Recurrent, audio and VLM (each part's kernel counts set to 0 before it
   and read after): (V) qwen2-vl-2b at full size (1.54 B f32 parameters
   from a seeded generator on the card, bf16 compute): its plain forward
   end to end on B 4 × T 1024 whose first 256 positions are a seeded
   16 × 16 patch prefix with M-RoPE ids (temporal 0, height r, width c;
   text continuing on all three streams), each of its 28 layers' attention
   also through ``attn_apply(use_kernel=True, mrope_positions=…)`` on that
   layer's own inputs (28 bf16 flash launches, each within 3e-2 and 0.8 %
   a row of the plain branch, a planted control that must fail at the
   first layer and is recorded at the last), the M-RoPE ids moving the
   logits against 1-D positions; the continuous engine with 16 slots and 32 text requests
   (prompts 32–512, 16–128 new; the decode pair at G 6, D 128, steps × 28
   launches, one captured step held layer by layer and in its logits, its
   host wall, aten operations and device time beside its weight bytes);
   4 steps of ``api.fit`` training on one B 2 × T 1024 batch with the
   prefix (no loss on it), ``remat_policy="full"``, Adam ×
   ``delay_line(1)`` × ``topk:0.01+ef``: the loss falls, one encode
   launch a leaf a step.  (X) xlstm-125m at full size through
   ``launch.serve`` (B 8, P 128, 32 new, loop prefill, no kernel; the
   decode state's bytes, the same at a context of 2^20; one decode step's
   host wall, aten operations and device time) and ``launch.train`` (8
   steps of B 4 × T 256, ``topk:0.01+ef``: the mean loss on the batches it
   trained on falls, recomputed at θ_0 and at the checkpointed θ); one
   mLSTM and one sLSTM block in f32 on the card against the CPU at B 2 ×
   T 300 (max |Δ| within 1e-4 of max |y|).  (W) whisper-base
   at full size: encode B 8 × 1,500 stub frames and 64 greedy tokens
   through ``decode_step`` (one step's host wall, aten operations and
   device time); in f32 the cached decode within 2e-3 of the full
   ``decode`` and row 0's logits within atol = rtol = 1e-4 of the CPU's.  (J) jamba-1.5-large-398b ``reduced()`` (398 B parameters do not
   fit one card) through ``launch.serve`` and 8 steps of ``launch.train``
   (the mean loss on its batches falls, the encode kernel on every leaf); one mamba mixer at
   full width (d 8192, d_inner 16,384, d_state 16, dt_rank 512) in f32 on
   the card against the CPU at B 1 × T 384 (one chunk and a padded one),
   and its step-by-step decode after a prefill of one chunk against its
   forward, each within 1e-4 of max |y|.  (D) deepseek-67b at full width,
   4 of its 95 layers (the 95 are 67 B parameters): the continuous engine
   with 16 slots and 16 requests, the decode pair at G 8, D 128, held
   layer by layer on a captured step.
14. Launch specs and the dry run (each part's kernel counts set to 0
   before it and read after): (L1) tinyllama-1.1b's ``decode_32k`` serve
   step as ``launch.specs.build_jitted`` builds it on the host mesh, at
   full width and depth with B cut from 128 to 32 (the bf16 cache alone is
   94.49 GB at 128, 23.62 GB at 32; seeded values, filled to S − 1 of
   32,768): the plain step (the reference's default) and the same step
   with ``decode_attn="cuda"`` (the decode pair, 22 + 22 launches and no
   other kernel): on each layer the pair within 3e-2 and 0.8 % of a row's
   norm of its plain version on that layer's inputs, the logits and the 22
   layers' written K / V rows within ``LOGIT_TOL`` of the plain step's
   (argmax equal wherever the top-2 margin clears the difference; row
   errors reported), both steps' wall and
   device time under the profiler and the kernel step's aten operations,
   beside the bound (the cache and the f32 parameters read once); then the
   pair alone at (32, 32,768, 32, 4, 64) in turns with
   ``scaled_dot_product_attention(enable_gqa=True)``, 6 runs each, beside
   its 1.074 GB bound.  (L2) ``long_500k`` at its published B 1 × S
   524,288 with the 8,192 window on the plain path (the pair has no
   window): on each layer the windowed attention within 3e-2 and 0.8 % a
   row of the same query against only the last 8,192 positions on the
   layer's own inputs, the logits within ``LOGIT_TOL`` of the step on a
   cache of those 8,192 positions alone.  (L3) ``make_train_step`` at ``train_4k``'s T 4,096 with B
   cut from 256 to 4, in f32 compute: 4 microbatches against 1 from the
   same θ, θ after the step within tests/test_torch_train.py's f32 rule,
   the f32 gradients handed to the optimizer within 1e-5 × each leaf's
   max |g| of the whole batch's; the loss, the step's wall and peak
   memory.  (L4) the dry run of
   tinyllama-1.1b × ``train_4k`` on a fake world of 256 ranks on the
   host: per-device bytes, FLOPs and collective bytes (counts); then
   minicpm3-4b × ``decode_32k``, whisper-base × ``prefill_32k``,
   xlstm-125m × ``decode_32k`` and deepseek-v3-671b × ``train_4k`` (its
   widths with 2 layers, one of them MoE), each ``ok``, their FLOPs,
   collective and argument bytes beside those of torch 2.13.0+cpu.
15. Prints the redesigned kernels' times in turns, one JSON line of
   per-kernel numbers (fourteen kernels; the wire kernels' launches count
   the executors and many-client phases', ``topk_encode``'s the serving-and-tracing,
   training, deepseek-v3, qwen2-vl, xlstm and jamba paths' too, the decode
   kernels' those of the continuous engine under the tracer and of
   olmoe-1b-7b's, qwen2-vl-2b's, deepseek-67b's serving and the
   ``decode_32k`` step's, the bf16
   flash kernel's qwen2-vl-2b's prefill too), the whole run's seconds
   beside the recorded run before the many-client phases, the card's name
   and power limit, and last
   ``{"ok": true, "device": {...}}``.

No earlier phase is cut to make room for 8–14 or the serving-and-tracing
phase (≈ 30 s on the card each, the recurrent / audio / VLM one longer).

Imports nothing of JAX.  Exits non-zero, with no result line, when there
is no CUDA device or ``src/repro_torch`` is not beside it.  Any failed
check raises.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense (NVIDIA data sheet)
#: f32 instructions a second on the CUDA cores: 132 SMs × 128 lanes × 1.98
#: GHz (a plain add or max issues at this rate; only an FMA counts twice)
F32_ISSUE_PER_S = 132 * 128 * 1.98e9
K, N, D = 16, 25_000, 2_000  # epsilon: 400,000 × 2,000 over 16 nodes
STEPS = 20
TOPK_F = 0.01


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    """Registers, static shared memory and spills of each kernel entry in
    an ``nvcc -Xptxas -v`` log (dynamic shared memory is the launch's)."""
    import re

    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"entry": m.group(1)}
            out.append(cur)
        elif cur is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                cur["spill_stores"], cur["spill_loads"] = int(spill[1]), int(spill[2])
            regs = re.search(r"Used (\d+) registers", line)
            if regs:
                cur["registers"] = int(regs[1])
                smem = re.search(r"(\d+) bytes smem", line)
                cur["static_smem"] = int(smem[1]) if smem else 0
    return out


def check(cond, what: str):
    if not cond:
        raise AssertionError(what)


def graph_ms(torch, fn, *, inner: int, reps: int = 20) -> float:
    """Device time of one ``fn()``: median over ``reps`` replays of a CUDA
    graph holding ``inner`` calls, timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def eager_ms(torch, fn, *, inner: int, reps: int = 20) -> float:
    """Stream time of one ``fn()`` for calls that cannot be captured in a
    CUDA graph (they synchronise): median over ``reps`` runs of ``inner``
    back-to-back calls between CUDA events — launch gaps included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def turns_ms(torch, fns: dict, *, inner: int, rounds: int = 3, eager=()) -> dict:
    """Device time of one call of each function in ``fns`` (name -> fn),
    timed in turns within this call: a CUDA graph of ``inner`` calls is
    captured for each, and each round replays them in the order of ``fns``
    and then reversed (library, kernel, kernel, library).  One replay is
    one run; returns {name: {"median", "min", "max", "runs"}} in ms.  The
    names in ``eager`` (calls too large or too host-bound to capture) run
    as one direct call a run between the same CUDA events instead."""
    graphs = {}
    for name, fn in fns.items():
        if name in eager:
            fn()
            continue
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(inner):
                fn()
        graphs[name].replay()
    torch.cuda.synchronize()
    runs = {name: [] for name in fns}
    order = list(fns) + list(reversed(list(fns)))
    for _ in range(rounds):
        for name in order:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            if name in eager:
                fns[name]()
            else:
                graphs[name].replay()
            e1.record()
            e1.synchronize()
            runs[name].append(e0.elapsed_time(e1) / (1 if name in eager else inner))
    del graphs
    torch.cuda.empty_cache()
    return {name: {"median": statistics.median(v), "min": min(v), "max": max(v),
                   "runs": len(v)} for name, v in runs.items()}


def bound_ms(nbytes: float, ops: float, rate: float = F32_OPS_PER_S) -> tuple[float, str]:
    """The least time for ``nbytes`` of traffic and ``ops`` operations at the
    card's peak ``rate`` for the operands' type (f32 outside the tensor
    cores by default; bf16 operands take ``BF16_OPS_PER_S``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: encode's and select's shapes: one element, a row shorter than a float4,
#: rows off 16 bytes, grid-stride loops of several trips, the fit's (K, D)
ENCODE_SHAPES = [(1, 1), (1, 3), (1, 257), (1, 8193), (5, 8193), (1, 1 << 20),
                 (1, 1 << 24), (1, (1 << 24) + 3), (K, D)]
#: the first design's times (one float4 a thread, one atomic a warp,
#: behind a zero fill) as PERF.md's kernel table records them, printed
#: beside the new ones; all on an H100 80GB HBM3 at 700 W
EARLIER_ENCODE_MS = {
    ("topk_encode", "main"): 0.0024752, ("topk_select", "main"): 0.0027654,
    ("topk_encode", "2^24"): 0.11425, ("topk_select", "2^24"): 0.098835,
    ("topk_encode", "leaf"): 2.2790, ("topk_select", "leaf"): 1.9935,
}


def encode_cases(torch, x):
    """(case, rows, thresholds, k | None) for encode and select: the k-th
    magnitude of each row at k = 1, 1 % and n (every element survives);
    t = +inf (none does); half the elements tied at the threshold's
    magnitude."""
    n = x.shape[1]
    for k in sorted({1, max(1, n // 100), n}):
        yield f"k = {k}", x, torch.topk(x.abs(), k, dim=1).values[:, -1].contiguous(), k
    yield "t = +inf", x, torch.full((x.shape[0],), float("inf"), device="cuda"), None
    tied = x.clone()
    tied[:, ::2] = torch.copysign(torch.full_like(tied[:, ::2], 0.75), tied[:, ::2])
    yield "tied magnitudes", tied, torch.full((x.shape[0],), 0.75, device="cuda"), None


def encode_timings(torch, x, t, inner: int, label: str) -> dict:
    """Encode and select on rows ``x`` in turns with a device copy of the
    rows (8 bytes an element: select's traffic), median and min–max of 6
    runs; then each one's plain version, bound and the first design's
    recorded time at ``label``'s shape."""
    from repro_torch.kernels.topk_compress import kernel as tkk, ref as tkr

    rows, n = x.shape
    o = torch.empty_like(x)
    fns = {"copy": lambda: o.copy_(x)}
    for name, with_res in (("encode", True), ("select", False)):
        fns[name] = lambda w=with_res: tkk.encode_threshold(x, t, with_residual=w)
    turns = turns_ms(torch, fns, inner=inner)
    el, rows_b = rows * n, 4 * rows
    out = {}
    for name, with_res, nbytes, ops in (("encode", True, 12 * el + 2 * rows_b, 4 * el),
                                        ("select", False, 8 * el + 2 * rows_b, 3 * el)):
        b_ms, b_by = bound_ms(nbytes, ops)
        out[f"topk_{name}"] = {
            "ms": turns[name]["median"],
            "turns": {k: v for k, v in turns.items() if k in ("copy", name)},
            "plain_ms": graph_ms(torch, lambda w=with_res: tkr.encode_threshold_ref(
                x, t, with_residual=w), inner=max(1, inner // 5), reps=5),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "shape": [rows, n],
            "first_design_ms_recorded": EARLIER_ENCODE_MS.get((f"topk_{name}", label))}
    return out


def int8_encode_checks(torch, gen, same_bits) -> tuple[int, float]:
    """The int8 wire encode, both routes, with and without an EF residual:
    out, res and scale bitwise ``int8_encode_ref`` on the card at encode's
    shapes, the sweep's S·K rows and rows of N_A and N_A + 1 (N_A the
    longest row of one launch); on the edge rows (NaN, ±inf, −0.0) also
    equal to the plain version on the CPU wherever it is a number, NaN in
    the same places; and quant-dequant alone bitwise its plain version on
    the edge rows.  Returns the comparisons made and the largest |error|."""
    from repro_torch.kernels.int8_quant import kernel as q8k, ref as q8r

    n_a = q8k.one_launch_max()
    checked, err = 0, 0.0

    def nan_where_same(a, b):
        nan = torch.isnan(b)
        return torch.equal(torch.isnan(a), nan) and same_bits(a[~nan], b[~nan])

    shapes = ENCODE_SHAPES + [(8 * K, D), (1, n_a), (5, n_a), (1, n_a + 1), (5, n_a + 1)]
    edge = [(5, 8193), (K, D), (1, (1 << 24) + 3), (5, n_a), (5, n_a + 1)]
    for shape, on_edge in [(sh, False) for sh in shapes] + [(sh, True) for sh in edge]:
        m = edge_rows(torch, shape, gen) if on_edge else torch.randn(
            shape, generator=gen, device="cuda")
        r0 = 0.25 * torch.randn(shape, generator=gen, device="cuda")
        for r in (r0, None):
            got = q8k.int8_encode(m, r)
            want = q8r.int8_encode_ref(m, r)
            torch.cuda.synchronize()
            what = (f"int8 encode {shape} {'with' if r is not None else 'without'} EF"
                    + (" on the edge rows" if on_edge else "")
                    + f" (route {'A' if shape[1] <= n_a else 'B'})")
            for part, a, b in zip(("out", "res", "scale"), got, want):
                check((a is None) == (b is None), f"{what}: {part} missing")
                if a is None:
                    continue
                check(same_bits(a, b), f"{what}: {part} differs from the plain version")
                fin = torch.isfinite(b)
                if bool(fin.any()):
                    err = max(err, float((a[fin] - b[fin]).abs().max()))
            if on_edge:
                cpu = q8r.int8_encode_ref(m.cpu(), None if r is None else r.cpu())
                for part, a, b in zip(("out", "res", "scale"), got, cpu):
                    if a is not None:
                        check(nan_where_same(a.cpu(), b),
                              f"{what}: {part} differs from the plain version on the CPU")
            checked += 1
        if on_edge:
            s = torch.clamp_min(q8r.absmax_ref(m), 1e-12) * (1.0 / 127.0)
            q = q8k.quant_dequant(m, s)
            torch.cuda.synchronize()
            check(same_bits(q, q8r.quant_dequant_ref(m, s)),
                  f"int8 quant differs on the edge rows {shape}")
            checked += 1
        print(f"int8 encode {shape}{' edge rows' if on_edge else ''}, with and without EF: "
              f"bitwise the plain version (route {'A' if shape[1] <= n_a else 'B'})",
              flush=True)
    return checked, err


def int8_encode_timings(torch, m, r, inner: int) -> dict:
    """The int8 wire encode of rows ``m`` (+ ``r``) in turns with the chain
    it replaced (c = m + r, absmax's zero fill and kernel, clamp_min, the
    multiply by 1/127, quant-dequant, c - out: seven launches with EF),
    median and min–max of 6 runs; its plain version, bound (reading m and
    r, writing out, res and the scales) and route."""
    from repro_torch.kernels.int8_quant import kernel as q8k, ref as q8r

    def chain():
        c = m if r is None else m + r
        s = torch.clamp_min(q8k.absmax(c), 1e-12) * (1.0 / 127.0)
        o = q8k.quant_dequant(c, s)
        return o, (None if r is None else c - o), s

    turns = turns_ms(torch, {"chain": chain, "encode": lambda: q8k.int8_encode(m, r)},
                     inner=inner)
    rows, n = m.shape
    ef = r is not None
    one = n <= q8k.one_launch_max()
    b_ms, b_by = bound_ms((16 if ef else 8) * rows * n + 4 * rows, (8 if ef else 6) * rows * n)
    return {"ms": turns["encode"]["median"], "chain_ms": turns["chain"]["median"],
            "turns": turns,
            "plain_ms": graph_ms(torch, lambda: q8r.int8_encode_ref(m, r),
                                 inner=max(1, inner // 5), reps=5),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "shape": [rows, n],
            "ef": ef, "route": "A" if one else "B",
            "route_bytes_per_element": (16 if ef else 8) if one else (24 if ef else 12)}


#: node rows around grid.y's 65,535 blocks, past which the wire kernels
#: loop over rows; the many-client fits' leaf width; route B's row length
MANY_ROWS = (65535, 65536, 100_000)
MANY_N_B = 16392


def many_rows_checks(torch, gen, same_bits) -> int:
    """Every wire wrapper on more node rows than grid.y holds, bitwise its
    plain version, one launch each (route B: one absmax and one quant):
    encode and select, absmax and quant-dequant at n 2,000 and 2,001 (rows
    off 16 bytes), the int8 encode's route A at n 2,000 and route B at n
    16,392 (up to 6.6 GB an operand, held a block of 16,384 rows at a time:
    rows are independent), each with and without EF.  Returns the
    comparisons made."""
    from repro_torch import kernels
    from repro_torch.kernels.int8_quant import kernel as q8k, ref as q8r
    from repro_torch.kernels.topk_compress import kernel as tkk, ref as tkr

    def launched(fn, names):
        before = dict(kernels.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        delta = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.KERNEL_NAMES}
        check(delta == {k: int(k in names) for k in kernels.KERNEL_NAMES},
              f"launches {delta}, expected one of each of {names}")
        return out

    def held(got, want, what):
        for part, a, b in zip(("output", "residual", "count or scale"), got, want):
            check((a is None) == (b is None), f"{what}: {part} missing")
            if a is not None:
                check(same_bits(a, b), f"{what}: {part} differs from the plain version")

    checked = 0
    for rows in MANY_ROWS:
        for n in (D, D + 1):
            x = torch.randn((rows, n), generator=gen, device="cuda")
            r = 0.25 * torch.randn((rows, n), generator=gen, device="cuda")
            t = torch.topk(x.abs(), max(1, n // 100), dim=1).values[:, -1].contiguous()
            for name, w in (("topk_encode", True), ("topk_select", False)):
                got = launched(lambda: tkk.encode_threshold(x, t, with_residual=w), (name,))
                held(got, tkr.encode_threshold_ref(x, t, with_residual=w),
                     f"{name} at ({rows}, {n})")
            s = torch.clamp_min(q8r.absmax_ref(x), 1e-12) * (1.0 / 127.0)
            held((launched(lambda: q8k.absmax(x), ("int8_absmax",)),), (q8r.absmax_ref(x),),
                 f"int8 absmax at ({rows}, {n})")
            held((launched(lambda: q8k.quant_dequant(x, s), ("int8_quant",)),),
                 (q8r.quant_dequant_ref(x, s),), f"int8 quant at ({rows}, {n})")
            checked += 4
            if n == D:
                for rr in (r, None):
                    held(launched(lambda: q8k.int8_encode(x, rr), ("int8_encode",)),
                         q8r.int8_encode_ref(x, rr),
                         f"int8 encode (route A) at ({rows}, {n}), EF {rr is not None}")
                    checked += 1
            del x, r, t, s
        m = torch.randn((rows, MANY_N_B), generator=gen, device="cuda")
        r = 0.25 * torch.randn((rows, MANY_N_B), generator=gen, device="cuda")
        for rr in (r, None):
            got = launched(lambda: q8k.int8_encode(m, rr), ("int8_absmax", "int8_quant"))
            for i in range(0, rows, 16384):
                sl = slice(i, min(i + 16384, rows))
                held(tuple(None if a is None else a[sl] for a in got),
                     q8r.int8_encode_ref(m[sl], None if rr is None else rr[sl]),
                     f"int8 encode (route B) at ({rows}, {MANY_N_B}), EF {rr is not None}")
            checked += 1
            del got
        del m, r
        torch.cuda.empty_cache()
        print(f"wire kernels at {rows} rows: encode, select, absmax, quant (n {D}, {D + 1}), "
              f"int8 encode route A (n {D}) and route B (n {MANY_N_B}), with and without EF: "
              f"one launch each, bitwise the plain versions", flush=True)
    return checked


def kernel_phase(torch):
    from repro_torch.kernels.int8_quant import kernel as q8k, ref as q8r
    from repro_torch.kernels.topk_compress import kernel as tkk, ref as tkr

    def same_bits(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"topk_encode": 0.0, "topk_select": 0.0, "int8_absmax": 0.0, "int8_quant": 0.0}
    checked, err["int8_encode"] = int8_encode_checks(torch, gen, same_bits)
    for shape in ENCODE_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda")
        for case, xc, t, k in encode_cases(torch, x):
            for name, with_res in (("topk_encode", True), ("topk_select", False)):
                o, res, cnt = tkk.encode_threshold(xc, t, with_residual=with_res)
                o_r, res_r, cnt_r = tkr.encode_threshold_ref(xc, t, with_residual=with_res)
                torch.cuda.synchronize()
                check(same_bits(o, o_r), f"{name} output differs at {shape}, {case}")
                check(torch.equal(cnt, cnt_r), f"{name} count differs at {shape}, {case}")
                if k is not None:
                    check(bool((cnt >= k).all()), f"{name} kept fewer than k at {shape}, {case}")
                err[name] = max(err[name], float((o - o_r).abs().max()))
                if with_res:
                    check(same_bits(res, res_r), f"{name} residual differs at {shape}, {case}")
                    err[name] = max(err[name], float((res - res_r).abs().max()))
                checked += 1
        m, m_r = q8k.absmax(x), q8r.absmax_ref(x)
        s = torch.clamp_min(m_r, 1e-12) * (1.0 / 127.0)
        q, q_r = q8k.quant_dequant(x, s), q8r.quant_dequant_ref(x, s)
        torch.cuda.synchronize()
        check(same_bits(m, m_r), f"int8 absmax differs at {shape}")
        check(same_bits(q, q_r), f"int8 quant differs at {shape}")
        err["int8_absmax"] = max(err["int8_absmax"], float((m - m_r).abs().max()))
        err["int8_quant"] = max(err["int8_quant"], float((q - q_r).abs().max()))
        checked += 2
        print(f"kernel check {shape}: bitwise equal to the plain versions (encode and "
              f"select at k = 1, 1 %, n, t = +inf and tied magnitudes)", flush=True)
    # rows with NaN of either sign and ±inf: o and the count bitwise the
    # plain version on the CPU and on the card; res bitwise the plain
    # version on the card, and on the CPU wherever it is a number (a NaN's
    # payload is the arithmetic's: the CPU passes the input's on, the card
    # writes its own)
    for shape in [(5, 8193), (K, D), (1, (1 << 24) + 3)]:
        x = edge_rows(torch, shape, gen)
        xc = x.cpu()
        for case, t in (("k = 1 %", torch.topk(x.abs(), max(1, shape[1] // 100),
                                                dim=1).values[:, -1].contiguous()),
                        ("t = 0", torch.zeros((shape[0],), device="cuda"))):
            for name, with_res in (("topk_encode", True), ("topk_select", False)):
                o, res, cnt = tkk.encode_threshold(x, t, with_residual=with_res)
                o_c, res_c, cnt_c = tkr.encode_threshold_ref(xc, t.cpu(), with_residual=with_res)
                o_r, res_r, cnt_r = tkr.encode_threshold_ref(x, t, with_residual=with_res)
                torch.cuda.synchronize()
                what = f"{name} on the NaN rows {shape}, {case}"
                check(same_bits(o.cpu(), o_c) and same_bits(o, o_r), f"{what}: output differs")
                check(torch.equal(cnt.cpu(), cnt_c) and torch.equal(cnt, cnt_r),
                      f"{what}: count differs")
                if with_res:
                    nan = torch.isnan(res_c)
                    check(torch.equal(torch.isnan(res.cpu()), nan)
                          and same_bits(res.cpu()[~nan], res_c[~nan]),
                          f"{what}: residual differs from the plain version on the CPU")
                    check(same_bits(res, res_r), f"{what}: residual differs on the card")
                checked += 1
        print(f"encode and select, NaN rows {shape}: equal to the plain versions", flush=True)
    # absmax on rows with NaN (either sign), ±inf and −0.0, rows not on 16
    # bytes, K = 16 and rows whose grid-stride loop takes several trips
    # (a NaN row's max is |NaN| = 0x7fc00000, as the plain version gives it
    # on the CPU; torch's abs on the card writes 0x7fffffff, so NaN rows
    # are held to the plain version on the CPU, the others to both)
    for shape in [(5, 8193), (K, D), (K, 1 << 20), (1, 1 << 24)]:
        x = edge_rows(torch, shape, gen)
        m, m_r = q8k.absmax(x), q8r.absmax_ref(x)
        torch.cuda.synchronize()
        finite = ~torch.isnan(m)
        check(same_bits(m.cpu(), q8r.absmax_ref(x.cpu())),
              f"int8 absmax differs on the edge rows {shape} from the plain version on the CPU")
        check(same_bits(m[finite], m_r[finite]), f"int8 absmax differs on the edge rows {shape}")
        checked += 1
        print(f"absmax edge rows {shape}: bitwise equal ({m[:5].tolist()})", flush=True)
    checked += many_rows_checks(torch, gen, same_bits)
    print(f"kernel phase: {checked} comparisons, all bitwise equal", flush=True)

    # times at the main path's shape (one θ leaf of D for K nodes), at the
    # executors phase's sweep of 8 scenarios (S·K rows) and at 2^24
    timings = {}
    for label, shape, inner in (("main", (K, D), 50), ("sweep", (8 * K, D), 50),
                                ("2^24", (1, 1 << 24), 10)):
        rows, n = shape
        x = torch.randn(shape, generator=gen, device="cuda")
        k = max(1, int(round(TOPK_F * n)))
        t = torch.topk(x.abs(), k, dim=1).values[:, -1].contiguous()
        s = torch.clamp_min(x.abs().amax(dim=1), 1e-12) * (1.0 / 127.0)
        zp = torch.zeros((rows,), dtype=torch.int32, device="cuda")
        el = rows * n
        rows_b = 4 * rows
        for name, tm in encode_timings(torch, x, t, inner, label).items():
            timings[(name, label)] = tm
            print(f"time {name} {label} {shape}: {tm}", flush=True)
        cases = {
            "int8_absmax": (
                lambda: q8k.absmax(x), lambda: q8r.absmax_ref(x),
                lambda: torch.linalg.vector_norm(x, float("inf"), dim=1),
                4 * el + rows_b, 2 * el),
            # fake_quantize_per_channel_affine checks its zero points on the
            # host, so it cannot be captured: timed eagerly (eager_ms)
            "int8_quant": (
                lambda: q8k.quant_dequant(x, s), lambda: q8r.quant_dequant_ref(x, s),
                lambda: torch.fake_quantize_per_channel_affine(x, s, zp, 0, -127, 127),
                8 * el + rows_b, 6 * el),
        }
        for name, (kern, plain, lib, nbytes, ops) in cases.items():
            b_ms, b_by = bound_ms(nbytes, ops)
            tm = {"plain_ms": graph_ms(torch, plain, inner=inner),
                  "bound_ms": b_ms, "bound_by": b_by, "shape": list(shape)}
            if name == "int8_absmax":
                # in turns with vector_norm (library, kernel, kernel, library)
                turns = turns_ms(torch, {"library": lib, "kernel": kern}, inner=inner)
                tm.update(ms=turns["kernel"]["median"], turns=turns,
                          library_ms=turns["library"]["median"])
            else:
                lib_time = graph_ms if name != "int8_quant" else eager_ms
                tm.update(ms=graph_ms(torch, kern, inner=inner),
                          library_ms=None if lib is None else lib_time(torch, lib, inner=inner))
            timings[(name, label)] = tm
            print(f"time {name} {label} {shape}: {tm}", flush=True)
        r = 0.25 * torch.randn(shape, generator=gen, device="cuda")
        with_ef = [(label, r)] + ([] if label == "sweep" else [(f"{label} no EF", None)])
        for lab, rr in with_ef:
            tm = int8_encode_timings(torch, x, rr, inner)
            timings[("int8_encode", lab)] = tm
            print(f"time int8_encode {lab} {shape}: {tm}", flush=True)
    # the many-client fits' leaf: 100,000 node rows of D, each block of
    # the grid looping over rows past grid.y's 65,535
    shape = (MANY_ROWS[-1], D)
    x = torch.randn(shape, generator=gen, device="cuda")
    t = torch.topk(x.abs(), max(1, int(round(TOPK_F * D))), dim=1).values[:, -1].contiguous()
    for name, tm in encode_timings(torch, x, t, 5, "100k").items():
        timings[(name, "100k")] = tm
        print(f"time {name} 100k {shape}: {tm}", flush=True)
    tm = int8_encode_timings(torch, x, 0.25 * torch.randn(shape, generator=gen, device="cuda"), 5)
    timings[("int8_encode", "100k")] = tm
    print(f"time int8_encode 100k {shape}: {tm}", flush=True)
    return err, timings


def nan_of(torch, sign_bit: bool) -> float:
    """A quiet NaN; with its sign bit set, an order by raw bits puts it
    before every number."""
    bits = torch.tensor([0xFFC00000 if sign_bit else 0x7FC00000], dtype=torch.int64)
    return float(bits.to(torch.int32).view(torch.float32))


def edge_rows(torch, shape, gen):
    """(K, n) normal rows on the card.  With K >= 5: row 0 holds a NaN, row
    1 +inf and −inf, row 2 only −0.0, row 3 a sign-bit NaN and +inf, row 4
    −0.0 among tiny values; with fewer rows, row 0 holds −inf and a
    sign-bit NaN."""
    x = torch.randn(shape, generator=gen, device="cuda")
    rows, n = shape
    if rows >= 5:
        x[0, n // 2] = nan_of(torch, False)
        x[1, 0], x[1, n - 1] = float("inf"), float("-inf")
        x[2] = -0.0
        x[3, n - 1], x[3, n // 3] = nan_of(torch, True), float("inf")
        x[4] *= 1e-30
        x[4, 0] = -0.0
    else:
        x[0, n // 3], x[0, n // 2] = float("-inf"), nan_of(torch, True)
    return x


def make_epsilon_shaped(torch, seed: int):
    """Epsilon-shaped classification shards made on the card as
    ``make_feature_shards`` makes them: a planted w,
    y = sign(Xw + 0.05·noise) ∈ {−1, +1}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((D,), generator=gen, device="cuda")
    Xs = torch.randn((K, N, D), generator=gen, device="cuda")
    ys = torch.sign(Xs @ w + 0.05 * torch.randn((K, N), generator=gen, device="cuda"))
    ys[ys == 0] = 1.0
    return Xs, ys


def main_path(torch, data):
    from repro_torch import api, kernels
    from repro_torch.core import schedules
    from repro_torch.ml.linear import logistic_loss

    strategy = api.GradientDescent(logistic_loss, lr=1.0)
    loss0 = float(strategy.summary(strategy.init_theta(data), data)["loss"])
    print(f"data {tuple(data[0].shape)} f32 on the card "
          f"({data[0].numel() * 4 / 1e9:.2f} GB); loss at θ=0: {loss0:.6f}", flush=True)
    k = max(1, int(round(TOPK_F * D)))
    topk_push = k * (4 + 4)  # 4-byte index + f32 value per kept entry
    int8_push = D * 1 + 4  # one byte per entry + the f32 scale
    runs = {
        "a": dict(transport="allreduce", wire="topk:0.01+ef", steps=STEPS,
                  expect={"topk_encode": STEPS}, push=topk_push, pushes=STEPS * K),
        "b": dict(transport="allreduce", wire="int8+ef", steps=STEPS,
                  expect={"int8_encode": STEPS},
                  push=int8_push, pushes=STEPS * K),
        "c": dict(transport="delay_line", staleness=2, wire="topk:0.01", steps=STEPS,
                  expect={"topk_select": STEPS}, push=topk_push, pushes=STEPS * K),
        "d": dict(transport="sequential_server", wire="dense",
                  schedule=schedules.round_robin(K, STEPS), expect={},
                  push=4 * D, pushes=STEPS * K),
        # (f): the encode kernel after the privatization, once a round
        "f": dict(transport="allreduce", wire="dp:1.0,0.0001>topk:0.01+ef", steps=STEPS,
                  expect={"topk_encode": STEPS}, push=topk_push, pushes=STEPS * K,
                  loss_beside="a"),
        # (g), (h): secagg after a compressed stage is bitwise that stage alone
        "g": dict(transport="delay_line", staleness=2, wire="topk:0.01>secagg", steps=STEPS,
                  expect={"topk_select": STEPS}, push=topk_push, pushes=STEPS * K,
                  bitwise_of="c"),
        "h": dict(transport="allreduce", wire="int8+ef>secagg", steps=STEPS,
                  expect={"int8_encode": STEPS},
                  push=int8_push, pushes=STEPS * K, bitwise_of="b"),
    }
    # the first fit of a process pays one-off set-up (CUDA/cuBLAS handles,
    # lazy kernel loading, torch.func): time it apart from the runs
    t0 = time.perf_counter()
    api.fit(strategy, data, transport="allreduce", wire="topk:0.01+ef", steps=1,
            executor="local", device="cuda")
    torch.cuda.synchronize()
    print(f"warm-up fit (1 round, first in the process): "
          f"{time.perf_counter() - t0:.4f} s", flush=True)
    # runs (e) and (f) bring code the warm-up did not run (L-BFGS's
    # recursion, the DP draws): one round of each, timed apart too
    for label, strat, wire in (("e", api.LBFGS(logistic_loss), "dense"),
                               ("f", strategy, "dp:1.0,0.0001>topk:0.01+ef")):
        t0 = time.perf_counter()
        api.fit(strat, data, transport="allreduce", wire=wire, steps=1, device="cuda")
        torch.cuda.synchronize()
        print(f"warm-up fit of run {label} (1 round): {time.perf_counter() - t0:.4f} s",
              flush=True)
    results, walls = {}, {}
    kernels.reset_launches()
    for tag, spec in runs.items():
        spec = dict(spec)
        expect, push, pushes = spec.pop("expect"), spec.pop("push"), spec.pop("pushes")
        base, beside = spec.pop("bitwise_of", None), spec.pop("loss_beside", None)
        res, wall, delta, peak = timed_fit(torch, api, kernels, strategy, data, **spec)
        want = {n: expect.get(n, 0) for n in kernels.KERNEL_NAMES}
        check(delta == want, f"run {tag}: launches {delta}, expected {want}")
        loss = float(res.metrics["loss"])
        check(math.isfinite(loss) and loss < loss0, f"run {tag}: loss {loss} did not fall")
        check(bool(torch.isfinite(res.theta).all()) and res.theta.shape == (D,),
              f"run {tag}: θ not finite of shape ({D},)")
        check(res.ledger.uplink_bytes == pushes * push,
              f"run {tag}: uplink {res.ledger.uplink_bytes} != {pushes} × {push}")
        if ">" in spec["wire"]:
            check("wire_kernel_hits" not in res.metrics, f"run {tag}: a chain reports kernel hits")
        elif "wire_kernel_hits" in res.metrics:
            hits = res.metrics["wire_kernel_hits"]
            check(hits["kernel_leaves"] == 1 and hits["active"],
                  f"run {tag}: wire_kernel_hits {hits}")
        if base is not None:
            check(same_fit(torch, res, results[base]),
                  f"run {tag}: not bitwise run {base} (θ, trajectory, ledger)")
        rounds = STEPS if tag != "d" else STEPS * K
        results[tag] = res
        walls[tag] = wall
        note = (f" (run {beside}: {float(results[beside].metrics['loss']):.6f})"
                if beside else "") + (f", bitwise run {base} (θ, trajectory, ledger)"
                                      if base else "")
        print(f"run {tag} {spec.get('transport')} × {spec.get('wire')}: "
              f"loss {loss0:.6f} -> {loss:.6f}{note}, {rounds} rounds in {wall:.4f} s "
              f"({rounds / wall:.2f} rounds/s), peak {peak:.3f} GiB, launches {delta}, "
              f"uplink {res.ledger.uplink_bytes} B, total {res.ledger.total_bytes} B",
              flush=True)

    # kernel on ≡ off: the same fits through the reference formulas
    for tag, wire in (("a", api.TopKWire(TOPK_F, error_feedback=True, use_kernel=False)),
                      ("b", api.Int8Wire(error_feedback=True, use_kernel=False))):
        before = sum(kernels.LAUNCHES.values())
        off = api.fit(strategy, data, transport="allreduce", wire=wire, steps=STEPS,
                      executor="local", device="cuda")
        on = results[tag]
        check(sum(kernels.LAUNCHES.values()) == before, f"run {tag} off launched kernels")
        check(torch.equal(on.theta.view(torch.int32), off.theta.view(torch.int32)),
              f"run {tag}: θ differs with use_kernel=False")
        check(torch.equal(on.trajectory.view(torch.int32), off.trajectory.view(torch.int32)),
              f"run {tag}: trajectory differs with use_kernel=False")
        check(on.ledger.summary() == off.ledger.summary(),
              f"run {tag}: ledger differs with use_kernel=False")
        print(f"run {tag}: use_kernel on ≡ off, bitwise (θ, trajectory, ledger)", flush=True)
    lbfgs_run(torch, data, strategy, loss0)
    return dict(kernels.LAUNCHES), {"res": results["a"], "rounds_per_s": STEPS / walls["a"]}


def timed_fit(torch, api, kernels, strategy, data, **spec):
    """One fit on the card: (result, wall s, launches by kernel, peak GiB)."""
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = api.fit(strategy, data, device="cuda", **{"executor": "local", **spec})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = {n: kernels.LAUNCHES[n] - before[n] for n in kernels.KERNEL_NAMES}
    return res, wall, delta, torch.cuda.max_memory_allocated() / 2**30


def same_fit(torch, a, b) -> bool:
    """θ, trajectory and ledger of two fits bit for bit."""
    return (torch.equal(a.theta.view(torch.int32), b.theta.view(torch.int32))
            and torch.equal(a.trajectory.view(torch.int32), b.trajectory.view(torch.int32))
            and a.ledger.summary() == b.ledger.summary()
            and a.ledger.events == b.ledger.events)


#: the executors phase: 8 learning rates around run (a)'s, 4 staleness
#: levels, 3 dropout rates
SWEEP_LRS = (0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 2.0, 3.0)
SWEEP_DS = (0, 1, 2, 3)
SWEEP_PS = (0.0, 0.2, 0.5)
S_RTOL, S_ATOL = 1e-6, 1e-7  # sweep ≡ solo fits, the reference's tolerance


def swept_vs_solo(torch, what, res, solos):
    """Each scenario of ``res`` against its solo fit: θ and trajectory at
    rtol 1e-6 / atol 1e-7, ledgers exact.  Returns the largest |Δθ|."""
    gap = 0.0
    for i, solo in enumerate(solos):
        for a, b, name in ((res.theta[i], solo.theta, "θ"),
                           (res.trajectory[i], solo.trajectory, "trajectory")):
            check(bool(torch.isfinite(a).all()), f"{what} scenario {i}: {name} not finite")
            check(torch.allclose(a, b, rtol=S_RTOL, atol=S_ATOL),
                  f"{what} scenario {i}: {name} off its solo fit by "
                  f"{float((a - b).abs().max())}")
        gap = max(gap, float((res.theta[i] - solo.theta).abs().max()))
        check(res.ledger[i].summary() == solo.ledger.summary(),
              f"{what} scenario {i}: ledger differs from its solo fit")
    return gap


def same_sweep(torch, x, y) -> bool:
    """θ, trajectory and every scenario's ledger of two sweeps bit for bit."""
    return (torch.equal(x.theta.view(torch.int32), y.theta.view(torch.int32))
            and torch.equal(x.trajectory.view(torch.int32), y.trajectory.view(torch.int32))
            and [led.summary() for led in x.ledger] == [led.summary() for led in y.ledger])


def executors_phase(torch, data, run_a):
    """The executors beyond local on the main path's data: (i) a sweep of 8
    learning rates × allreduce × topk:0.01+ef (the encode kernel once a
    round for all 8), (ii) a staleness sweep × delay_line × topk:0.01 (the
    select kernel), (iii) a dropout sweep × a FaultPlan × int8+ef (absmax
    and quant).  Each sweep: kernel on ≡ off bitwise, every scenario's
    ledger its solo fit's, the same sweep over the dense wire held to its
    solo fits at rtol 1e-6 / atol 1e-7, and the kernel wire's gap to its
    solo fits reported (a selecting or rounding wire turns the batched
    products' last-bit differences into a swapped survivor or the next
    quantum: ROADMAP queue 3, items 13 and 18).  Then over NCCL on a world
    of one: (iv) the mesh on run (a), (v) multipod on a (1, 1) mesh, (vi)
    mesh+sweep, bitwise (i).  Returns the launches of the counted runs and a
    summary."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import api, kernels
    from repro_torch.ml.linear import logistic_loss

    def gd(lr=1.0):
        return api.GradientDescent(logistic_loss, lr=lr)

    total = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    out = {}

    def run(tag, expect, **spec):
        kernels.reset_launches()
        res, wall, delta, peak = timed_fit(torch, api, kernels, gd(), data, **spec)
        want = {n: expect.get(n, 0) for n in kernels.KERNEL_NAMES}
        check(delta == want, f"run {tag}: launches {delta}, expected {want}")
        for n in kernels.KERNEL_NAMES:
            total[n] += delta[n]
        return res, wall, peak, delta

    def sweep_checks(tag, res, spec, off_wire, solo_specs):
        """The counted sweep ``res`` of ``spec``: on ≡ off, ledgers, the
        dense twin at the sweep tolerance, the wire's gap."""
        off = api.fit(gd(), data, device="cuda", **dict(spec, wire=off_wire))
        check(same_sweep(torch, res, off), f"run {tag}: use_kernel on ≢ off under the sweep")
        solos = [api.fit(gd(sp.pop("lr", 1.0)), data, device="cuda", **sp)
                 for sp in (dict(x, wire=spec["wire"]) for x in solo_specs)]
        for i, solo in enumerate(solos):
            check(bool(torch.isfinite(res.theta[i]).all()), f"run {tag} scenario {i}: not finite")
            check(res.ledger[i].summary() == solo.ledger.summary(),
                  f"run {tag} scenario {i}: ledger differs from its solo fit")
        gaps = [float((res.theta[i] - s.theta).abs().max()) for i, s in enumerate(solos)]
        within = sum(bool(torch.allclose(res.theta[i], s.theta, rtol=S_RTOL, atol=S_ATOL))
                     for i, s in enumerate(solos))
        # the first round whose metric leaves the solo fit's (None: none does)
        apart = []
        for i, s in enumerate(solos):
            off_rounds = (~torch.isclose(res.trajectory[i], s.trajectory, rtol=S_RTOL,
                                         atol=S_ATOL)).nonzero()
            apart.append(int(off_rounds[0]) if len(off_rounds) else None)
        dense = api.fit(gd(), data, device="cuda", **dict(spec, wire="dense"))
        dense_gap = swept_vs_solo(torch, f"run {tag} (dense)", dense, [
            api.fit(gd(sp.pop("lr", 1.0)), data, device="cuda", **sp)
            for sp in (dict(x, wire="dense") for x in solo_specs)])
        return {"kernel_on_off_bitwise": True, "max_dtheta_vs_solo": gaps,
                "within_sweep_tol": within, "first_round_apart": apart,
                "dense_max_dtheta_vs_solo": dense_gap}

    # warm-up: the first vmapped round pays torch.func's set-up
    api.fit(gd(), data, transport="allreduce", wire="topk:0.01+ef", steps=1,
            executor="sweep", sweep={"lr": list(SWEEP_LRS)}, device="cuda")
    torch.cuda.synchronize()
    S = len(SWEEP_LRS)
    spec_i = dict(transport="allreduce", wire="topk:0.01+ef", steps=STEPS, executor="sweep",
                  sweep={"lr": list(SWEEP_LRS)})
    res_i, wall, peak, delta = run("i", {"topk_encode": STEPS}, **spec_i)
    out["i"] = {"scenarios": S, "rounds": STEPS, "wall_s": wall,
                "scenario_rounds_per_s": S * STEPS / wall,
                "run_a_rounds_per_s": run_a["rounds_per_s"], "peak_gib": peak,
                "launches": delta["topk_encode"],
                "losses": [float(x) for x in res_i.metrics["loss"]],
                **sweep_checks("i", res_i, spec_i,
                               api.TopKWire(TOPK_F, error_feedback=True, use_kernel=False),
                               [dict(transport="allreduce", steps=STEPS, lr=lr)
                                for lr in SWEEP_LRS])}
    print(f"run i sweep of {S} lr × allreduce × topk:0.01+ef: {S * STEPS} scenario-rounds "
          f"in {wall:.4f} s ({S * STEPS / wall:.2f} scenario-rounds/s; run a "
          f"{run_a['rounds_per_s']:.2f} rounds/s), topk_encode launched "
          f"{delta['topk_encode']} times for {S} × {STEPS}, kernel on ≡ off bitwise; "
          f"|Δθ| against the solo fits {out['i']['max_dtheta_vs_solo']} "
          f"({out['i']['within_sweep_tol']} of {S} within rtol 1e-6 / atol 1e-7; first "
          f"round apart {out['i']['first_round_apart']}), dense "
          f"wire {out['i']['dense_max_dtheta_vs_solo']:.3g}; peak {peak:.3f} GiB", flush=True)

    spec_ii = dict(transport="delay_line", wire="topk:0.01", steps=STEPS, executor="sweep",
                   sweep={"staleness": list(SWEEP_DS)})
    res, wall, peak, delta = run("ii", {"topk_select": STEPS}, **spec_ii)
    out["ii"] = {"scenarios": len(SWEEP_DS), "wall_s": wall,
                 "scenario_rounds_per_s": len(SWEEP_DS) * STEPS / wall,
                 "launches": delta["topk_select"],
                 **sweep_checks("ii", res, spec_ii, api.TopKWire(TOPK_F, use_kernel=False),
                                [dict(transport="delay_line", staleness=d, steps=STEPS)
                                 for d in SWEEP_DS])}
    print(f"run ii staleness sweep D ∈ {SWEEP_DS} × delay_line × topk:0.01: "
          f"{len(SWEEP_DS) * STEPS / wall:.2f} scenario-rounds/s, topk_select launched "
          f"{delta['topk_select']} times: " + json.dumps(out["ii"]), flush=True)

    plan = dict(seed=5, straggler=1, quorum=10)
    spec_iii = dict(transport="delay_line", staleness=1, wire="int8+ef", steps=STEPS,
                    faults=api.FaultPlan(**plan), executor="sweep",
                    sweep={"dropout_p": list(SWEEP_PS)})
    res, wall, peak, delta = run("iii", {"int8_encode": STEPS}, **spec_iii)
    out["iii"] = {"scenarios": len(SWEEP_PS), "wall_s": wall,
                  "scenario_rounds_per_s": len(SWEEP_PS) * STEPS / wall,
                  "launches": delta["int8_encode"],
                  "uplink_bytes": [led.uplink_bytes for led in res.ledger],
                  **sweep_checks("iii", res, spec_iii,
                                 api.Int8Wire(error_feedback=True, use_kernel=False),
                                 [dict(transport="delay_line", staleness=1, steps=STEPS,
                                       faults=api.FaultPlan(dropout_p=p, **plan))
                                  for p in SWEEP_PS])}
    print(f"run iii dropout sweep p ∈ {SWEEP_PS} × FaultPlan({plan}) × int8+ef: "
          f"{len(SWEEP_PS) * STEPS / wall:.2f} scenario-rounds/s, the one-launch int8 "
          f"encode launched {delta['int8_encode']} times: "
          + json.dumps(out["iii"]), flush=True)

    # NCCL: one card takes a world of one; ranks across cards are not here
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                                world_size=1, rank=0)
        try:
            check(dist.get_backend() == "nccl", "no NCCL process group")
            from repro_torch.launch.mesh import make_multipod_mesh, make_node_mesh

            mesh, pods = make_node_mesh(), make_multipod_mesh()
            check(type(mesh).__name__ == "DeviceMesh" and tuple(pods.shape) == (1, 1),
                  f"meshes {mesh}, {pods}")
            spec = dict(transport="allreduce", wire="topk:0.01+ef", steps=STEPS)
            api.fit(gd(), data, executor=api.MeshExecutor(mesh), device="cuda",
                    **dict(spec, steps=1))  # NCCL's communicator set-up, untimed
            res_m, wall_m, _, delta = run("iv", {"topk_encode": STEPS},
                                          executor=api.MeshExecutor(mesh), **spec)
            check(same_fit(torch, res_m, run_a["res"]),
                  "run iv: the mesh over NCCL is not bitwise run (a)")
            res_p, wall_p, _, _ = run("v", {"topk_encode": STEPS},
                                      executor=api.MultiPodExecutor(pods), **spec)
            check(torch.equal(res_p.theta.view(torch.int32), res_m.theta.view(torch.int32)),
                  "run v: multipod is not bitwise the mesh")
            by_hop = res_p.ledger.summary()["by_hop"]
            check(set(by_hop) == {"intra_pod", "inter_pod"}
                  and sum(v["total_bytes"] for v in by_hop.values())
                  == res_p.ledger.total_bytes == res_m.ledger.total_bytes,
                  f"run v: by_hop {by_hop}")
            res_ms, wall_ms, _, delta = run(
                "vi", {"topk_encode": STEPS}, executor="mesh+sweep",
                sweep={"lr": list(SWEEP_LRS)}, **spec)
            check(same_sweep(torch, res_ms, res_i), "run vi: mesh+sweep is not bitwise run i")
        finally:
            dist.destroy_process_group()
    out["iv"] = {"rounds_per_s": STEPS / wall_m, "bitwise_run_a": True}
    out["v"] = {"rounds_per_s": STEPS / wall_p, "by_hop": by_hop}
    out["vi"] = {"scenario_rounds_per_s": S * STEPS / wall_ms, "bitwise_run_i": True}
    print(f"run iv mesh over NCCL (world of one): bitwise run (a), {STEPS / wall_m:.2f} "
          f"rounds/s; run v multipod (1, 1): bitwise run iv, by_hop {json.dumps(by_hop)}; "
          f"run vi mesh+sweep of {S} lr: {S * STEPS / wall_ms:.2f} scenario-rounds/s, "
          f"bitwise run i", flush=True)
    return total, out


#: the many-client fits: the epsilon records as 100,000 clients of 4
#: records (m1, m2) and as 10,000 clients of 40 (m3, whose 8 scenarios
#: fold into 80,000 rows); the two learning rates held to solo fits
MANY_K, MANY_K_SWEEP = 100_000, 10_000
MANY_SOLO_LRS = (1.0, 3.0)


def many_clients_phase(torch, data, timings):
    """``repro_torch.api.fit`` at phone-scale client counts on the epsilon
    records, views of ``data`` (no copy): (m1) 100,000 clients × allreduce ×
    ``topk:0.01+ef`` and (m2) × ``int8+ef``, 20 rounds each — one encode
    launch a round on all 100,000 rows, the loss falls, the uplink exact,
    bitwise the ``use_kernel=False`` fit; (m3) the sweep of run (i)'s 8
    learning rates over 10,000 clients of 40 records under both wires —
    one launch a round on 80,000 rows, bitwise the ``use_kernel=False``
    sweep, ledgers exact, and for lr ∈ ``MANY_SOLO_LRS`` the gap to the
    solo fits (the dense twin held at rtol 1e-6 / atol 1e-7; ROADMAP queue
    3, item 18 for the compressed wires).  Counts are set to 0 before the
    phase and read after.  Returns (launches, summary)."""
    from repro_torch import api, kernels
    from repro_torch.kernels.int8_quant import kernel as q8k
    from repro_torch.kernels.topk_compress import kernel as tkk
    from repro_torch.ml.linear import logistic_loss

    def gd(lr=1.0):
        return api.GradientDescent(logistic_loss, lr=lr)

    Xs, ys = data
    few = (Xs.view(MANY_K, -1, D), ys.view(MANY_K, -1))
    sweep_data = (Xs.view(MANY_K_SWEEP, -1, D), ys.view(MANY_K_SWEEP, -1))
    loss0 = float(gd().summary(gd().init_theta(few), few)["loss"])
    rows_seen = []
    saved = (tkk.encode_threshold, q8k.int8_encode)

    def rows_of(fn):
        def wrapped(x, *args, **kw):
            rows_seen.append(x.shape[0])
            return fn(x, *args, **kw)
        return wrapped

    k = max(1, int(round(TOPK_F * D)))
    pushes = {"topk:0.01+ef": (k * 8, "topk_encode",
                               api.TopKWire(TOPK_F, error_feedback=True, use_kernel=False)),
              "int8+ef": (D + 4, "int8_encode",
                          api.Int8Wire(error_feedback=True, use_kernel=False))}
    out, total = {}, dict.fromkeys(kernels.KERNEL_NAMES, 0)
    # warm-up: the first round at this K pays the allocator's growth
    api.fit(gd(), few, transport="allreduce", wire="topk:0.01+ef", steps=1, device="cuda")
    kernels.reset_launches()
    tkk.encode_threshold, q8k.int8_encode = rows_of(saved[0]), rows_of(saved[1])
    try:
        for tag, wire in (("m1", "topk:0.01+ef"), ("m2", "int8+ef")):
            push, name, off_wire = pushes[wire]
            rows_seen.clear()
            res, wall, delta, peak = timed_fit(torch, api, kernels, gd(), few,
                                               transport="allreduce", wire=wire, steps=STEPS)
            want = {n: STEPS * (n == name) for n in kernels.KERNEL_NAMES}
            check(delta == want, f"run {tag}: launches {delta}, expected {want}")
            check(rows_seen == [MANY_K] * STEPS, f"run {tag}: encode rows {rows_seen}")
            loss = float(res.metrics["loss"])
            check(math.isfinite(loss) and loss < loss0, f"run {tag}: loss {loss} did not fall")
            check(res.ledger.uplink_bytes == STEPS * MANY_K * push,
                  f"run {tag}: uplink {res.ledger.uplink_bytes} != {STEPS} × {MANY_K} × {push}")
            off = api.fit(gd(), few, transport="allreduce", wire=off_wire, steps=STEPS,
                          device="cuda")
            check(same_fit(torch, res, off),
                  f"run {tag}: not bitwise its use_kernel=False fit (θ, trajectory, ledger)")
            for n in kernels.KERNEL_NAMES:
                total[n] += delta[n]
            enc = timings[(name, "100k")]
            out[tag] = {"clients": MANY_K, "records_each": int(few[0].shape[1]),
                        "wire": wire, "rounds": STEPS, "wall_s": wall,
                        "rounds_per_s": STEPS / wall, "peak_gib": peak, "launches": delta[name],
                        "loss": [loss0, loss], "uplink_bytes": res.ledger.uplink_bytes,
                        "encode_ms_at_100k": enc["ms"], "encode_bound_ms": enc["bound_ms"],
                        "bitwise_use_kernel_false": True}
            print(f"run {tag} {MANY_K} clients × allreduce × {wire}: loss {loss0:.6f} -> "
                  f"{loss:.6f}, {STEPS} rounds in {wall:.4f} s ({STEPS / wall:.2f} rounds/s), "
                  f"peak {peak:.3f} GiB, {name} launched {delta[name]} times on {MANY_K} rows "
                  f"each, uplink {res.ledger.uplink_bytes} B = {STEPS} × {MANY_K} × {push}, "
                  f"bitwise its use_kernel=False fit; one encode at ({MANY_K}, {D}) "
                  f"{enc['ms']:.6f} ms (bound {enc['bound_ms']:.6f} ms at 3.35 TB/s)",
                  flush=True)

        S = len(SWEEP_LRS)
        spec = dict(transport="allreduce", steps=STEPS, executor="sweep",
                    sweep={"lr": list(SWEEP_LRS)})
        idx = [SWEEP_LRS.index(lr) for lr in MANY_SOLO_LRS]
        dense = api.fit(gd(), sweep_data, device="cuda", **dict(spec, wire="dense"))
        dense_gap = 0.0
        for i, lr in zip(idx, MANY_SOLO_LRS):
            solo = api.fit(gd(lr), sweep_data, transport="allreduce", wire="dense",
                           steps=STEPS, device="cuda")
            for a, b, what in ((dense.theta[i], solo.theta, "θ"),
                               (dense.trajectory[i], solo.trajectory, "trajectory")):
                check(torch.allclose(a, b, rtol=S_RTOL, atol=S_ATOL),
                      f"run m3 (dense) lr {lr}: {what} off its solo fit by "
                      f"{float((a - b).abs().max())}")
            check(dense.ledger[i].summary() == solo.ledger.summary(),
                  f"run m3 (dense) lr {lr}: ledger differs from its solo fit")
            dense_gap = max(dense_gap, float((dense.theta[i] - solo.theta).abs().max()))
        out["m3"] = {"clients": MANY_K_SWEEP, "records_each": int(sweep_data[0].shape[1]),
                     "scenarios": S, "folded_rows": S * MANY_K_SWEEP,
                     "dense_max_dtheta_vs_solo": dense_gap}
        for wire in ("topk:0.01+ef", "int8+ef"):
            push, name, off_wire = pushes[wire]
            rows_seen.clear()
            kernels.reset_launches()
            res, wall, delta, peak = timed_fit(torch, api, kernels, gd(), sweep_data,
                                               wire=wire, **spec)
            want = {n: STEPS * (n == name) for n in kernels.KERNEL_NAMES}
            check(delta == want, f"run m3 {wire}: launches {delta}, expected {want}")
            check(rows_seen == [S * MANY_K_SWEEP] * STEPS,
                  f"run m3 {wire}: encode rows {rows_seen}")
            off = api.fit(gd(), sweep_data, device="cuda", **dict(spec, wire=off_wire))
            check(same_sweep(torch, res, off), f"run m3 {wire}: use_kernel on ≢ off")
            for n in kernels.KERNEL_NAMES:
                total[n] += delta[n]
            gaps, within = [], 0
            for i, lr in zip(idx, MANY_SOLO_LRS):
                solo = api.fit(gd(lr), sweep_data, transport="allreduce", wire=wire,
                               steps=STEPS, device="cuda")
                check(res.ledger[i].summary() == solo.ledger.summary()
                      and solo.ledger.uplink_bytes == STEPS * MANY_K_SWEEP * push,
                      f"run m3 {wire} lr {lr}: ledger differs from its solo fit")
                check(bool(torch.isfinite(res.theta[i]).all()), f"run m3 {wire}: θ not finite")
                gaps.append(float((res.theta[i] - solo.theta).abs().max()))
                within += bool(torch.allclose(res.theta[i], solo.theta, rtol=S_RTOL,
                                              atol=S_ATOL)
                               and torch.allclose(res.trajectory[i], solo.trajectory,
                                                  rtol=S_RTOL, atol=S_ATOL))
            out["m3"][wire] = {
                "wall_s": wall, "scenario_rounds_per_s": S * STEPS / wall, "peak_gib": peak,
                "launches": delta[name], "rows_a_launch": S * MANY_K_SWEEP,
                "losses": [float(x) for x in res.metrics["loss"]],
                "bitwise_use_kernel_false": True, "solo_lrs": list(MANY_SOLO_LRS),
                "max_dtheta_vs_solo": gaps, "within_sweep_tol": within}
            print(f"run m3 sweep of {S} lr × {MANY_K_SWEEP} clients × allreduce × {wire}: "
                  f"{S * STEPS / wall:.2f} scenario-rounds/s, peak {peak:.3f} GiB, {name} "
                  f"launched {delta[name]} times on {S * MANY_K_SWEEP} rows each, bitwise its "
                  f"use_kernel=False sweep, ledgers exact; |Δθ| to the solo fits at lr "
                  f"{MANY_SOLO_LRS}: {gaps} ({within} of 2 within rtol 1e-6 / atol 1e-7; "
                  f"the dense twin {dense_gap:.3g})", flush=True)
    finally:
        tkk.encode_threshold, q8k.int8_encode = saved
    kernels.reset_launches()
    return total, out


def lbfgs_run(torch, data, strategy, loss0):
    """Run (e) of the main path: allreduce × LBFGS(logistic_loss) × dense
    on the epsilon-shaped data of runs (a)–(d), beside dense GD."""
    from repro_torch import api, kernels
    from repro_torch.core.allreduce import CommLedger
    from repro_torch.ml.linear import logistic_loss

    none = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    lb, wall, delta, peak = timed_fit(torch, api, kernels, api.LBFGS(logistic_loss), data,
                                      transport="allreduce", wire="dense", steps=STEPS)
    gd, gd_wall, gd_delta, _ = timed_fit(torch, api, kernels, strategy, data,
                                         transport="allreduce", wire="dense", steps=STEPS)
    init = CommLedger()
    init.record_allreduce(torch.zeros((D,), device="cuda"), K, tag="fit/init")
    loss_e, loss_gd = float(lb.metrics["loss"]), float(gd.metrics["loss"])
    check(delta == none and gd_delta == none, f"run e launched kernels: {delta}, {gd_delta}")
    check(math.isfinite(loss_e) and loss_e < loss0, f"run e: loss {loss_e} did not fall")
    check(bool(torch.isfinite(lb.theta).all()) and lb.theta.shape == (D,), "run e: θ not finite")
    check(lb.ledger.rounds == STEPS + 1, f"run e: ledger rounds {lb.ledger.rounds}")
    check(lb.ledger.events[0] == init.events[0],
          f"run e: init charge {lb.ledger.events[0]} != {init.events[0]}")
    check(lb.ledger.uplink_bytes == init.uplink_bytes + STEPS * K * 4 * D,
          f"run e: uplink {lb.ledger.uplink_bytes}")
    print(f"run e allreduce × LBFGS × dense: loss {loss0:.6f} -> {loss_e:.6f} (dense GD "
          f"lr 1.0: {loss_gd:.6f}), ledger rounds {lb.ledger.rounds}, init charge "
          f"{lb.ledger.events[0]}, {STEPS} rounds in {wall:.4f} s ({STEPS / wall:.2f} "
          f"rounds/s; dense GD {STEPS / gd_wall:.2f}), peak {peak:.3f} GiB", flush=True)


def security_phase(torch):
    """The DP and secagg wires on the card at the fit's (K, D), and
    ``private_second_order`` at the epsilon shape."""
    from repro_torch import api
    from repro_torch.ml.linear import private_second_order

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    # DP with σ = 0 is the clip alone: each row's norm min(‖m‖, clip); the
    # rows' norms run from ≈ 0.045 to ≈ 45, so some are clipped and some not
    msgs = torch.randn((K, D), generator=gen, device="cuda")
    msgs = msgs * torch.logspace(-3, 0, K, device="cuda")[:, None]
    wi = api.DPWire(1.0, 0.0)
    _, hat, nb = wi.encode_updates(wi.init_state(msgs[0], K), msgs)
    norms = torch.linalg.norm(msgs, dim=1)
    want = torch.clamp(norms, max=1.0)
    rel = float(((torch.linalg.norm(hat, dim=1) - want).abs() / want).max())
    check(hat.device.type == "cuda", "dp: the privatized message left the card")
    check(rel <= 1e-4, f"dp σ=0: norms off min(‖m‖, clip) by {rel} (limit 1e-4)")
    check(int(nb) == K * D * 4, f"dp: metered {int(nb)} bytes")
    out["dp_clip"] = {"max_rel_err": rel, "rows_clipped": int((norms > 1.0).sum())}
    # zero messages: the output is the noise, N(0, (σ·clip)²) drawn on the card
    wi = api.DPWire(2.0, 0.5)
    zeros = torch.zeros((K, D), device="cuda")
    st = wi.init_state(zeros[0], K)
    st1, a, _ = wi.encode_updates(st, zeros)
    std, mean = float(a.std()), float(a.mean())
    check(abs(std - 1.0) <= 0.05 and abs(mean) < 0.05,
          f"dp noise: std {std} (want 1.0 ± 5 %), mean {mean} (want |mean| < 0.05)")
    _, a2, _ = wi.encode_updates(st, zeros)
    _, b, _ = wi.encode_updates(st1, zeros)
    check(torch.equal(a, a2), "dp: the same counters gave other draws")
    check(not torch.equal(a, b), "dp: advanced counters gave the same draws")
    check(st.device.type == "cpu", "dp: round counters are not on the host")
    dp_ms = eager_ms(torch, lambda: wi.encode_updates(st, msgs), inner=10)
    out["dp_noise"] = {"std": std, "want_std": 1.0, "mean": mean, "encode_ms": dp_ms}
    # secagg: each payload masked away from its message, the sum recovers
    # the aggregate (tests/test_property.py:241: rtol = atol = 1e-3)
    raw = torch.randn((K, D), generator=gen, device="cuda")
    sa = api.SecAggWire()
    st = sa.init_state(raw[0], K)
    pay = sa.uplink_payloads(st, raw)
    check(pay.device.type == "cuda", "secagg: payloads left the card")
    for k in range(K):
        check(not torch.allclose(pay[k], raw[k], atol=1e-3), f"secagg: payload {k} unmasked")
    sum_err = float((pay.sum(0) - raw.sum(0)).abs().max())
    check(torch.allclose(pay.sum(0), raw.sum(0), rtol=1e-3, atol=1e-3),
          f"secagg: the payload sum is {sum_err} off the aggregate")
    sa_ms = eager_ms(torch, lambda: sa.uplink_payloads(st, raw), inner=2, reps=5)
    out["secagg"] = {"sum_max_abs_err": sum_err, "payloads_ms": sa_ms,
                     "mask_draws": K * (K - 1) // 2}
    print(f"dp and secagg on the card at ({K}, {D}):", json.dumps(out), flush=True)
    del msgs, hat, zeros, a, a2, b, raw, pay

    # private_second_order at the epsilon shape: (16, 2000, 2000) f32 XᵀX
    Xs, ys = make_epsilon_shaped(torch, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    theta, ledger = private_second_order(Xs, ys, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    W64 = torch.zeros((D, D), dtype=torch.float64, device="cuda")
    V64 = torch.zeros((D,), dtype=torch.float64, device="cuda")
    for k in range(K):
        x = Xs[k].double()
        W64 += x.T @ x
        V64 += x.T @ ys[k].double()
    th64 = torch.linalg.solve(W64, V64)
    diff = (theta.double() - th64).abs()
    scale = float(th64.abs().max())
    tol_ok = bool((diff <= 1e-4 * th64.abs() + 1e-4 * scale).all())
    norm_rel = float(torch.linalg.norm(theta.double() - th64) / torch.linalg.norm(th64))
    up, down = K * (D * D + D) * 4, D * 4  # 256,128,000 and 8,000 at the epsilon shape
    check(tol_ok, f"private_second_order: θ off the float64 solve (max {float(diff.max())})")
    check(ledger.uplink_bytes == up and ledger.downlink_bytes == down,
          f"private_second_order: ledger {ledger.uplink_bytes} / {ledger.downlink_bytes}")
    out["private_second_order"] = {
        "wall_s": wall, "peak_gib": peak, "uplink": ledger.uplink_bytes,
        "downlink": ledger.downlink_bytes, "max_abs_err_vs_f64": float(diff.max()),
        "max_abs_theta": scale, "norm_rel_err_vs_f64": norm_rel,
        "check": "|θ − θ64| ≤ 1e-4·|θ64| + 1e-4·max|θ64| elementwise"}
    print(f"private_second_order at ({K}, {N}, {D}):",
          json.dumps(out["private_second_order"]), flush=True)
    del W64, V64, th64, theta

    del Xs, ys
    torch.cuda.empty_cache()
    return out


#: the item-7 families on the card (each listing its cuts):
#: cascade SVM at epsilon's width, 16 nodes × 1,250 rows = 20,000 pooled
#: (a 1.6 GB Gram matrix), linear kernel, C 1, 500 dual steps, 4 rounds;
CASCADE_NK, CASCADE_ROUNDS = 1_250, 4
#: GP: 1-D inputs in [-3, 3], y = sin 2x + 0.05 noise, 16 experts × 2,000
#: (the exact GP on all 32,000, in float64, is the yardstick: its 8.2 GB
#: Cholesky bounds N); 10 PoE-factorized hyper steps; M = 16 inducing
#: points as tests/test_sparse_gp_graphical.py (f32 solves of Σ bound M on
#: 1-D data); 64 query points;
GP_NK, GP_HYPER_STEPS, GP_M, GP_Q = 2_000, 10, 16, 64
#: MPLE: a 50-variable chain GMRF (tests/test_sparse_gp_graphical.py's
#: chain at d 50), 16 nodes × 5,000 samples, 50 ADMM iterations of 50
#: inner steps
MPLE_D, MPLE_NK = 50, 5_000
FAMILY_LIMIT_S = 60.0


def family_run(torch, name, fn):
    """Run ``fn`` on the card, timed; fails past ``FAMILY_LIMIT_S``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(wall < FAMILY_LIMIT_S, f"{name}: {wall:.1f} s, over {FAMILY_LIMIT_S} s")
    return out, wall, peak


def ml_families_phase(torch):
    """The cascade SVM, the GP experts and SGPR, and consensus MPLE on the card."""
    from repro_torch import api
    from repro_torch.ml import gp, graphical, svm

    out = {}
    # cascade SVM: the global SVs of each round ⊆ that round's pushed union
    Xs, ys = make_epsilon_shaped(torch, 1)
    Xs, ys = Xs[:, :CASCADE_NK].contiguous(), ys[:, :CASCADE_NK].contiguous()
    torch.cuda.empty_cache()
    res, wall, peak = family_run(torch, "cascade SVM", lambda: api.fit(
        svm.CascadeStrategy(C=1.0), (Xs, ys), transport="allreduce",
        steps=CASCADE_ROUNDS, device="cuda"))
    per = (D + 1) * 4
    union = [round(v) for v in (res.metrics["uplink_bytes_per_round"] / per).tolist()]
    svs = res.trajectory.sum(dim=1).tolist()
    # the byte hooks price in f32, as the reference's do: round back to counts
    check(svs == [round(v) for v in (res.metrics["downlink_bytes_per_round"] / per).tolist()],
          f"cascade: downlink {res.metrics['downlink_bytes_per_round']} != SVs {svs}")
    check(all(u >= v for u, v in zip(union, svs)), f"cascade: SVs {svs} beyond unions {union}")
    _, pushed = res.metrics["carry"][1]
    check(not bool((res.theta.sv_mask & ~pushed).any()), "cascade: an SV outside the union")
    X, y = Xs.reshape(-1, D), ys.reshape(-1)
    acc = float((torch.sign(svm.decision_function(res.theta, X)) == y).float().mean())
    check(acc > 0.5, f"cascade: training accuracy {acc} not above chance")
    out["cascade_svm"] = {
        "wall_s": wall, "peak_gib": peak, "pooled_rows": X.shape[0], "width": D,
        "union_per_round": union, "global_svs_per_round": svs,
        "union_non_decreasing": all(b >= a for a, b in zip(union, union[1:])),
        "stable_last_round": bool(torch.equal(res.trajectory[-1], res.trajectory[-2])),
        "train_accuracy": acc, "ledger_bytes": res.ledger.total_bytes,
        "cuts": f"16 × {CASCADE_NK} rows of the epsilon shape, {CASCADE_ROUNDS} rounds"}
    print("cascade SVM:", json.dumps(out["cascade_svm"]), flush=True)
    del Xs, ys, X, y, res, pushed
    torch.cuda.empty_cache()

    # GP: PoE-factorized hypers, the four expert rules and SGPR against the
    # exact GP on all points in float64
    gen = torch.Generator(device="cuda").manual_seed(5)
    N = K * GP_NK
    Xg = torch.rand((N, 1), generator=gen, device="cuda") * 6.0 - 3.0
    yg = torch.sin(2.0 * Xg[:, 0]) + 0.05 * torch.randn((N,), generator=gen, device="cuda")
    Xs, ys = Xg.reshape(K, GP_NK, 1), yg.reshape(K, GP_NK)
    Xq = torch.linspace(-2.5, 2.5, GP_Q, device="cuda")[:, None]
    Z = torch.linspace(-3.0, 3.0, GP_M, device="cuda")[:, None]

    def gp_family():
        hyp = gp.fit_hypers_distributed(Xs, ys, steps=GP_HYPER_STEPS, device="cuda")
        preds = gp.expert_predictions(hyp, Xs, ys, Xq)
        pv = gp.prior_variance(hyp, Xq)
        rules = {"poe": gp.poe(preds), "gpoe": gp.gpoe(preds), "bcm": gp.bcm(preds, pv),
                 "gbcm": gp.gbcm(preds, pv)}
        sgpr = gp.distributed_sgpr(hyp, Z, Xs, ys, Z, device="cuda")
        return hyp, rules, sgpr

    (hyp, rules, sgpr), wall, peak = family_run(torch, "GP experts and SGPR", gp_family)
    hyp64 = gp.GPHypers(*(v.double() for v in hyp))
    mu_e, var_e = gp.gp_posterior(hyp64, Xg.double(), yg.double(),
                                  torch.cat([Xq, Z]).double())
    sn2 = float(torch.exp(2.0 * hyp64.log_noise))
    rmse = {name: float(torch.sqrt(torch.mean((mu.double() - mu_e[:GP_Q]) ** 2)))
            for name, (mu, _) in rules.items()}
    check(all(math.isfinite(v) and v < 0.12 for v in rmse.values()),
          f"GP experts: rmse against the exact GP {rmse} (limit 0.12, tests/test_gp.py:82)")
    mu_s, var_s, stats_bytes = sgpr
    band = 2.0 * torch.sqrt(var_e[GP_Q:] + sn2)
    off = (mu_s.double() - mu_e[GP_Q:]).abs()
    check(bool(torch.isfinite(mu_s).all()) and bool((off <= band).all()),
          f"SGPR: mean at the inducing points leaves the exact GP's 2σ band by "
          f"{float((off - band).max())}")
    check(stats_bytes == (GP_M * GP_M + GP_M + 2) * 4, f"SGPR: {stats_bytes} bytes a node")
    out["gp"] = {
        "wall_s": wall, "peak_gib": peak, "points": N, "experts": K,
        "hypers": [float(v) for v in hyp], "rmse_vs_exact": rmse,
        "sgpr_max_off_exact_at_Z": float(off.max()), "sgpr_band_min": float(band.min()),
        "sgpr_bytes_per_node": stats_bytes,
        "cuts": f"1-D, {K} × {GP_NK} points, {GP_HYPER_STEPS} hyper steps, M {GP_M}"}
    print("GP experts and SGPR:", json.dumps(out["gp"]), flush=True)
    del Xg, yg, Xs, ys, mu_e, var_e, rules, sgpr
    torch.cuda.empty_cache()

    # consensus MPLE on a chain GMRF sampled on the card
    Theta = torch.eye(MPLE_D, device="cuda") * 1.5
    idx = torch.arange(MPLE_D - 1, device="cuda")
    Theta[idx, idx + 1] = Theta[idx + 1, idx] = 0.5
    Xm = graphical.sample_gmrf(torch.Generator(device="cuda").manual_seed(7), Theta,
                               K * MPLE_NK)
    (Th, admm), wall, peak = family_run(torch, "consensus MPLE", lambda: graphical.mple_consensus(
        Xm.reshape(K, MPLE_NK, MPLE_D), iters=50, inner_iters=50, device="cuda"))
    f1 = float(graphical.support_f1(Th, Theta))
    hist = admm.history[:, 0].tolist()
    check(f1 > 0.95, f"MPLE: support F1 {f1} (limit 0.95, tests/test_sparse_gp_graphical.py:97)")
    check(hist[-1] < hist[2], f"MPLE: primal residual {hist[2]} -> {hist[-1]} did not shrink")
    out["mple"] = {"wall_s": wall, "peak_gib": peak, "support_f1": f1,
                   "primal_residual": [hist[0], hist[2], hist[-1]],
                   "max_abs_err_vs_truth": float((Th - Theta).abs().max()),
                   "cuts": f"d {MPLE_D}, {K} × {MPLE_NK} samples, 50 × 50 steps"}
    print("consensus MPLE:", json.dumps(out["mple"]), flush=True)
    return out


# the decode kernel's shapes: (B, S, Hq, Hkv, D) of tests/test_kernels_decode.py,
# the serving shape of tinyllama-1.1b, qwen2-1.5b's heads (G 6, D 128) and
# olmoe-1b-7b's 16-slot serving shape (MHA: G 1, D 128); then the 16-slot
# serving shapes of public head layouts past the first kernel's list
# (Gemma-2B 8 / 1 at D 256, Qwen2-7B G 7, StarCoder2-3B G 12, Falcon-7B MQA
# G 71, Phi-3-mini D 96) and small odd ones (G 3, 5, 12; D 24, 40, 80, and
# D 36, which the wrapper pads to 40)
DECODE_GEMMA = (16, 1024, 8, 1, 256)
DECODE_FALCON = (16, 1024, 71, 1, 64)
DECODE_SHAPES = [
    (2, 256, 8, 2, 32), (1, 512, 4, 4, 64), (3, 128, 4, 1, 16), (2, 300, 8, 4, 32),
    (16, 1024, 32, 4, 64), (3, 200, 12, 2, 128), (16, 512, 16, 16, 128),
    DECODE_GEMMA, (16, 1024, 28, 4, 128), (16, 1024, 24, 2, 128), DECODE_FALCON,
    (16, 1024, 32, 32, 96), (3, 200, 3, 1, 24), (2, 300, 10, 2, 40), (2, 300, 12, 1, 80),
    (2, 200, 10, 2, 36),
]
DECODE_MAIN = (16, 1024, 32, 4, 64)
DECODE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # tests/test_kernels_decode.py:27,80


#: the serving run's valid lengths: prompts of 32–512 plus up to 128 new tokens
DECODE_SERVE_LENS = (48, 640)


def decode_partials_close(torch, got, want, tol: float) -> float:
    """The split kernel's partials against the plain ones: an empty split
    is exactly (−1e30, 0, 0); elsewhere m within 1e-4, l within 1e-4
    relative and acc / l within ``tol``.  Returns max |Δ(acc / l)|."""
    (ga, gml), (wa, wml) = got, want
    empty = wml[..., 1] == 0
    check(bool((gml[..., 0][empty] == -1e30).all() and (gml[..., 1][empty] == 0).all()
               and (ga[empty] == 0).all()), "decode partials: an empty split is not empty")
    full = ~empty
    if not bool(full.any()):  # every row of this case has length 0
        return 0.0
    dm = float((gml[..., 0] - wml[..., 0])[full].abs().max())
    dl = float(((gml[..., 1] - wml[..., 1]) / wml[..., 1].clamp_min(1e-30))[full].abs().max())
    da = float((ga / gml[..., 1:].clamp_min(1e-30) - wa / wml[..., 1:].clamp_min(1e-30))[full]
               .abs().max())
    check(dm <= 1e-4 and dl <= 1e-4 and da <= tol,
          f"decode partials: |Δm| {dm}, |Δl|/l {dl}, |Δ(acc/l)| {da}")
    return da


def decode_kernel_phase(torch):
    """The split kernel and the merge against their plain versions at every
    shape, type and length, graph replay, then times in turns with SDPA at
    the serving shape with every row full and at the serving run's
    lengths."""
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.kernels._heads import pad_heads, padded_width
    from repro_torch.kernels.decode_attention import kernel as dak, ops as dao, ref as dar

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(1)
    err = {"decode_attention": 0.0, "decode_attention_merge": 0.0}
    checked = 0
    for shape in DECODE_SHAPES:
        B, S, Hq, Hkv, D = shape
        Dp = padded_width(D)  # the width the kernels run (D padded by the wrapper)
        chunk, n_split = dak.plan_splits(B, Hkv, S, sms)
        # every row sees 0, 1, S and a length that is no multiple of a tile
        lens = [0, 1, S, S - 1 - S // 3]
        check(lens[3] % 32 != 0, f"length {lens[3]} is a multiple of a tile")
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dtype)
            k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
            v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
            tol = DECODE_TOL[str(dtype).split(".")[1]]
            worst = worst_merge = 0.0
            for shift in range(4):
                vl = torch.tensor([lens[(b + shift) % 4] for b in range(B)],
                                  dtype=torch.int32, device="cuda")
                pads = kernels.PADS["decode_attention"]
                out = dao.decode_attention(q, k, v, vl)
                check(kernels.PADS["decode_attention"] == pads + int(Dp != D),
                      f"decode pad count at {shape}")
                plain = dar.decode_attention_plain(q, k, v, vl)
                split_plain = dar.decode_attention_split_plain(q, k, v, vl, chunk)
                torch.cuda.synchronize()
                check(out.shape == q.shape and out.dtype == dtype, f"decode out at {shape}")
                check(bool(torch.isfinite(out).all()), f"decode non-finite at {shape} {dtype}")
                e = float((out.float() - plain.float()).abs().max())
                check(e <= tol, f"decode attention {shape} {dtype}: |kernel - plain| {e} > {tol}")
                e_split = float((split_plain.float() - plain.float()).abs().max())
                check(e_split <= tol, f"decode split plain {shape} {dtype}: {e_split} > {tol}")
                zero = vl == 0
                check(bool((out[zero] == 0).all()), f"decode valid_len 0 not 0 at {shape}")
                worst = max(worst, e)
                # each kernel against its plain version (on the padded
                # operands, at the true width's scale)
                qp, kp, vp = (pad_heads(x, Dp) for x in (q, k, v))
                parts = dak.decode_partials(qp, kp, vp, vl, chunk, scale_d=D)
                decode_partials_close(torch, parts, dar.decode_partials_plain(
                    qp, kp, vp, vl, chunk, scale=D ** -0.5), tol)
                merged = dak.decode_merge(*parts, dtype)
                e_m = float((merged.float() - dar.decode_merge_plain(*parts, dtype).float())
                            .abs().max())
                check(e_m <= tol, f"decode merge {shape} {dtype}: {e_m} > {tol}")
                worst_merge = max(worst_merge, e_m)
                checked += 1
            err["decode_attention"] = max(err["decode_attention"], worst)
            err["decode_attention_merge"] = max(err["decode_attention_merge"], worst_merge)
            print(f"decode check {shape} {dtype}: {n_split} splits of {chunk}; max |kernel - "
                  f"plain| {worst:.3g}, merge {worst_merge:.3g} (lengths {lens}"
                  + (f"; D padded to {Dp}" if Dp != D else "") + ")", flush=True)
    print(f"decode phase: {checked} comparisons within 2e-5 (f32) / 3e-2 (bf16); split "
          f"partials and merge each held to their plain versions", flush=True)

    B, S, Hq, Hkv, D = DECODE_MAIN
    chunk, n_split = dak.plan_splits(B, Hkv, S, sms)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").bfloat16()
    # a CUDA graph of the pair replays to the eager result, and reads the
    # lengths on the device at each replay
    vl = torch.full((B,), S, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dak.decode_attention(q, k, v, vl)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g = dak.decode_attention(q, k, v, vl)
    for lens in ([S] * B, torch.linspace(0, S, B).int().tolist()):
        vl.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        eager = dak.decode_attention(q, k, v, vl)
        torch.cuda.synchronize()
        check(torch.equal(out_g, eager), f"decode graph replay differs from eager at {lens}")
    del graph, out_g
    print(f"decode graph replay: bitwise the eager result, lengths full and 0..{S}", flush=True)

    timings = {}
    for label, lens in (("main", [S] * B),
                        ("serve lengths", torch.linspace(*DECODE_SERVE_LENS, B).int().tolist())):
        vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        mask = (torch.arange(S, device="cuda")[None, :] < vl[:, None])[:, None, None, :]
        q4, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        nbytes = 2 * int(vl.sum()) * Hkv * D * 2 + 2 * q.numel() * 2 + vl.numel() * 4
        ops = 4 * Hq * int(vl.sum()) * D
        b_ms, b_by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        t = turns_ms(torch, {
            "library": lambda: F.scaled_dot_product_attention(
                q4, kt, vt, attn_mask=mask, enable_gqa=True),
            "kernel": lambda: dak.decode_attention(q, k, v, vl),
        }, inner=50, rounds=3)
        timings[label] = {
            "ms": t["kernel"]["median"], "ms_runs": t["kernel"],
            "library_ms": t["library"]["median"], "library_runs": t["library"],
            "plain_ms": graph_ms(torch, lambda: dar.decode_attention_plain(q, k, v, vl),
                                 inner=20, reps=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_f32_cuda_cores_ms": bound_ms(nbytes, ops)[0],
            "shape": list(DECODE_MAIN), "bytes": nbytes,
            "valid_keys": int(vl.sum()), "lengths": [min(lens), max(lens)],
            "splits": n_split, "chunk": chunk, "launches_a_call": 2,
        }
        print(f"time decode_attention {label} {DECODE_MAIN} bf16 (split + merge, in turns "
              f"with SDPA): {timings[label]}", flush=True)

    # the merge alone, on the main shape's partials
    vl = torch.full((B,), S, dtype=torch.int32, device="cuda")
    parts = dak.decode_partials(q, k, v, vl, chunk)
    m_bytes = sum(x.numel() * 4 for x in parts) + q.numel() * 2
    t = turns_ms(torch, {"kernel": lambda: dak.decode_merge(*parts, torch.bfloat16)},
                 inner=50, rounds=3)
    merge_t = {
        "ms": t["kernel"]["median"], "ms_runs": t["kernel"], "library_ms": None,
        "plain_ms": graph_ms(torch, lambda: dar.decode_merge_plain(*parts, torch.bfloat16),
                             inner=20, reps=5),
        "bound_ms": m_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": m_bytes,
        "splits": n_split,
    }
    print(f"time decode_attention_merge main ({B * Hq} rows × {n_split} partials of D {D}): "
          f"{merge_t}", flush=True)

    # Gemma-2B's and Falcon-7B's heads at the 16-slot serving shape, every
    # row full, in turns with SDPA (median and min–max of 6 runs)
    for label, shape in (("gemma-2b", DECODE_GEMMA), ("falcon-7b", DECODE_FALCON)):
        B, S, Hq, Hkv, D = shape
        q = torch.randn((B, Hq, D), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").bfloat16()
        vl = torch.full((B,), S, dtype=torch.int32, device="cuda")
        q4, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        nbytes = 2 * B * S * Hkv * D * 2 + 2 * q.numel() * 2 + vl.numel() * 4
        ops = 4 * Hq * B * S * D
        b_ms, b_by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        t = turns_ms(torch, {
            "library": lambda: F.scaled_dot_product_attention(q4, kt, vt, enable_gqa=True),
            "kernel": lambda: dak.decode_attention(q, k, v, vl),
        }, inner=50, rounds=3)
        chunk, n_split = dak.plan_splits(B, Hkv, S, sms)
        timings[label] = {
            "ms": t["kernel"]["median"], "ms_runs": t["kernel"],
            "library_ms": t["library"]["median"], "library_runs": t["library"],
            "plain_ms": graph_ms(torch, lambda: dar.decode_attention_plain(q, k, v, vl),
                                 inner=20, reps=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_f32_cuda_cores_ms": bound_ms(nbytes, ops)[0],
            "shape": list(shape), "bytes": nbytes, "ops": ops, "splits": n_split, "chunk": chunk, "launches_a_call": 2,
        }
        print(f"time decode_attention {label} {shape} bf16 (split + merge, in turns with "
              f"SDPA): {timings[label]}", flush=True)
        del q, k, v, q4, kt, vt
    return err, timings, merge_t


SERVE_ARCH = "tinyllama-1.1b"
SERVE_SLOTS, SERVE_PAGE, SERVE_MAX_SEQ = 16, 16, 1024
SERVE_REQUESTS = 48
#: |logits(kernel) − logits(plain)| allowed on one captured bf16 decode step:
#: the two attention outputs differ by rounding (f32 sums in another order,
#: then one bf16 rounding each), and 22 bf16 layers carry that into logits of
#: unit scale; the argmax must agree wherever the top-2 margin is larger
#: than the difference measured
LOGIT_TOL = 0.25


def aten_ops(fn) -> int:
    """The aten operations one ``fn()`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with CountOps() as ops:
        fn()
    return ops.n


def host_and_device(torch, step, reps: int = 10) -> dict:
    """One eager ``step()``: median host wall (ending in a synchronize),
    aten operations, and device time as a CUDA-graph replay."""
    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"wall_ms": statistics.median(walls), "aten_ops": aten_ops(step),
            "device_ms": graph_ms(torch, step, inner=1, reps=reps)}


def step_breakdown(torch, step, parts: dict, weight_bytes: int) -> dict:
    """Where one decode step of the 16 live slots goes: host wall, host
    enqueue, device time (the step replayed as a CUDA graph), aten
    operations dispatched, decode-kernel launches, and each of ``parts``
    (name → (fn, times a step, bytes a call)) on the device beside its byte
    bound; the whole step beside ``weight_bytes`` read once."""
    from repro_torch import kernels

    step()
    torch.cuda.synchronize()
    launched = kernels.LAUNCHES["decode_attention"]
    ops = aten_ops(step)
    launched = kernels.LAUNCHES["decode_attention"] - launched
    wall, enq = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    summary = {"wall_ms": statistics.median(wall), "enqueue_ms": statistics.median(enq),
               "device_ms": graph_ms(torch, step, inner=1, reps=10), "aten_ops": ops,
               "kernel_launches": launched, "weight_bytes": weight_bytes,
               "weight_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3}
    for name, (fn, times, nbytes) in parts.items():
        ms = graph_ms(torch, fn, inner=times, reps=10) * times
        summary[name] = {"ms_a_step": ms, "bound_ms_a_step": nbytes * times / HBM_BYTES_PER_S * 1e3}
    check(summary["device_ms"] < summary["wall_ms"], "device time above wall time")
    return summary


def decode_step_parts(torch, W, cfg, args):
    """The step, its weight bytes (every weight read once; of the embedding
    only the 16 rows looked up) and the parts every attention stack shares:
    the decode kernel and the paged gather on layer 0's real cache, and the
    LM head."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.models import cache as cache_lib, layers, transformer as tf
    from repro_torch.utils.tree import tree_leaves

    tokens, cache, block, length = args

    def step():
        return tf.paged_decode_step(W, cfg, tokens, cache, block, length, decode_attn="cuda")

    emb = W["embed"]["embedding"]
    w_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(W)) - emb.numel() * 4
    lc = cache_lib.PagedKVCache(k=cache["seg0"]["l0"].k[0], v=cache["seg0"]["l0"].v[0])
    n = tokens.shape[0]
    x = torch.randn((n, 1, cfg.d_model), device="cuda").to(lc.k.dtype)
    q = torch.randn((n, cfg.num_heads, cfg.head_dim), device="cuda").to(lc.k.dtype)
    k_all, v_all = cache_lib.paged_view(lc, block)
    vl = (length + 1).to(torch.int32)
    L = cfg.num_layers
    parts = {
        "decode kernel": (lambda: da_ops.decode_attention(q, k_all, v_all, vl), L,
                          2 * int(vl.sum()) * cfg.num_kv_heads * cfg.head_dim * 2),
        "paged_view gather": (lambda: cache_lib.paged_view(lc, block), L,
                              2 * 2 * k_all.numel() * k_all.element_size()),
        "LM head": (lambda: layers.dense(W["lm_head"], x), 1,
                    W["lm_head"]["kernel"].numel() * 2),
    }
    return step, w_bytes, parts, x


def serve_phase(torch):
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import layers, transformer as tf
    from repro_torch.serve import ContinuousLMEngine, ServeMetrics
    from repro_torch.utils.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 stays f32 (prefill's _sdpa)
    cfg = get_config(SERVE_ARCH)
    n_layers = cfg.num_layers
    torch.cuda.synchronize()
    t_setup = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(gen, cfg)
    engine = ContinuousLMEngine(
        cfg, params, n_slots=SERVE_SLOTS, page_size=SERVE_PAGE, max_seq=SERVE_MAX_SEQ,
        tag=f"serve/{cfg.name}", device="cuda",
    )
    engine.submit(np.arange(40, dtype=np.int32), max_new=4).result()  # first-call costs
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    check(engine.kernel_plan["path"] == "cuda", f"plan {engine.kernel_plan}")
    print(f"serving set-up (weights on the card, engine, one warm-up request): "
          f"{setup_s:.4f} s; plan {engine.kernel_plan}", flush=True)

    rng = np.random.default_rng(0)
    plens = rng.integers(32, 513, size=SERVE_REQUESTS)
    gens = rng.integers(16, 129, size=SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in plens]
    engine.metrics = ServeMetrics()
    engine.kernel_hits = {"cuda": 0, "plain": 0}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    tickets = [engine.submit(p, max_new=int(g)) for p, g in zip(prompts, gens)]
    steps = engine.run_until_idle()
    outs = [t.result() for t in tickets]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stats = engine.stats()

    for o, g in zip(outs, gens):
        check(o.shape == (int(g),) and o.dtype == np.int32, f"ticket shape {o.shape} != ({g},)")
        check(bool(((o >= 0) & (o < cfg.vocab_size)).all()), "generated id out of range")
    check(launches["decode_attention"] == steps * n_layers,
          f"decode_attention launched {launches['decode_attention']} times, "
          f"expected {steps} steps × {n_layers}")
    check(launches["decode_attention_merge"] == steps * n_layers,
          f"decode_attention_merge launched {launches['decode_attention_merge']} times, "
          f"expected {steps} steps × {n_layers}")
    check(all(n == 0 for name, n in launches.items()
              if name not in ("decode_attention", "decode_attention_merge")),
          f"serving launched other kernels: {launches}")
    check(engine.kernel_hits == {"cuda": stats["tokens"], "plain": 0},
          f"kernel_hits {engine.kernel_hits} vs {stats['tokens']} decode tokens")
    check(stats["tokens"] == int(gens.sum()) - SERVE_REQUESTS,
          f"decode tokens {stats['tokens']} != Σ(max_new − 1)")
    check(stats["request_bytes"] == 4 * int(plens.sum())
          and stats["response_bytes"] == 4 * int(gens.sum()),
          f"ledger {stats['request_bytes']}/{stats['response_bytes']} B")
    check(engine.ledger.uplink_bytes == 4 * int(plens.sum()), "ledger uplink")
    peak = torch.cuda.max_memory_allocated()
    print(f"serving {SERVE_REQUESTS} requests ({int(plens.sum())} prompt tokens, "
          f"{int(gens.sum())} generated): {serve_s:.4f} s, {steps} decode steps", flush=True)
    print(f"serve metrics: decode {stats['tokens_per_s']:.2f} tokens/s, median step "
          f"{stats['p50_token_ms']:.4f} ms (p95 {stats['p95_token_ms']:.4f}), median "
          f"time to first token {stats['p50_ttft_ms']:.4f} ms (p95 "
          f"{stats['p95_ttft_ms']:.4f}), slot utilization {stats['slot_utilization']:.4f}, "
          f"peak memory {peak / 2**30:.3f} GiB; set-up {setup_s:.4f} s vs serving "
          f"{serve_s:.4f} s", flush=True)
    print("serve stats:", json.dumps(stats), flush=True)

    # one captured decode step, with the kernel and with use_kernel=False
    caught = [engine.submit(rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32),
                            max_new=8)
              for n in rng.integers(32, 513, size=SERVE_SLOTS)]
    engine.step()
    engine.step()
    active = [s for s, r in enumerate(engine.sched.slots) if r is not None]
    check(len(active) == SERVE_SLOTS, f"{len(active)} slots active for the capture")
    args = (
        torch.from_numpy(engine._last_tok[:, None].copy()).long().cuda(), engine._cache,
        torch.from_numpy(engine.sched.block.copy()).long().cuda(),
        torch.from_numpy(engine.sched.length.copy()).cuda(),
    )
    lg = {}
    for impl in ("cuda", "plain"):
        logits, _ = tf.paged_decode_step(engine._weights, cfg, args[0], args[1], args[2],
                                         args[3], decode_attn=impl)
        lg[impl] = logits[:, 0, : cfg.vocab_size].float()
    torch.cuda.synchronize()
    diff = float((lg["cuda"] - lg["plain"]).abs().max())
    top2 = lg["cuda"].topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    clear = margin > diff
    same = lg["cuda"].argmax(-1) == lg["plain"].argmax(-1)
    check(diff <= LOGIT_TOL, f"captured step: |logits kernel − plain| {diff} > {LOGIT_TOL}")
    check(bool(same[clear].all()), "captured step: argmax differs where the margin is clear")
    print(f"captured decode step (16 slots, lengths {engine.sched.length.tolist()}): "
          f"max |logits kernel − plain| {diff:.4g} (limit {LOGIT_TOL}); argmax equal on "
          f"{int(same.sum())}/16 rows, {int(clear.sum())} rows with top-2 margin > the "
          f"difference; logit scale {float(lg['cuda'].abs().max()):.3g}", flush=True)
    step, w_bytes, parts, x = decode_step_parts(torch, engine._weights, cfg, args)
    lw = tree_map(lambda t: t[0], engine._weights["seg0"])["l0"]
    a = lw["mixer"]
    parts["layer matmuls"] = (
        lambda: (layers.dense(a["wo"], layers.dense(a["wq"], x)), layers.dense(a["wk"], x),
                 layers.dense(a["wv"], x), layers.swiglu(lw["ffn"], x)), n_layers,
        sum(t.numel() * t.element_size() for t in tree_leaves({"m": a, "f": lw["ffn"]})
            if t.dim() == 2))
    summary = step_breakdown(torch, step, parts, w_bytes)
    check(summary["kernel_launches"] == n_layers, "breakdown step launches")
    print("decode step breakdown (16 live slots):", json.dumps(summary), flush=True)
    engine.run_until_idle()
    check(all(len(t.result()) == 8 for t in caught), "captured-step requests did not finish")
    del engine, params
    torch.cuda.empty_cache()

    # the CLI itself, at full width, a few requests
    t0 = time.perf_counter()
    outs = launch_serve.main(["--arch", SERVE_ARCH, "--continuous", "--batch", "4",
                              "--requests", "6", "--prompt-len", "40", "--gen", "8"])
    check(outs.shape == (6, 8), f"CLI output {outs.shape}")
    print(f"CLI run: {time.perf_counter() - t0:.4f} s", flush=True)
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------------
# The kernels' widened domains on the main paths: tinyllama-1.1b re-headed as
# Gemma-2B's attention, served and prefilled; l1 k-means at d 100,000
# ----------------------------------------------------------------------------

#: Gemma-2B's attention (arXiv:2403.08295): 8 query heads and 1 KV head of
#: 256 over tinyllama-1.1b's width 2,048, so wq and wo stay 2,048 × 2,048,
#: wk and wv 2,048 × 256, and the KV cache 1,024 bytes a token and layer in
#: bf16: full width and depth (22 layers) with no new weight bytes
REHEAD = dict(num_heads=8, num_kv_heads=1, head_dim=256)
#: greedy requests served by the kernel engine and the use_kernel=False one
REHEAD_ID_REQUESTS, REHEAD_ID_GEN = 16, 32


def reheaded_config():
    from repro_torch.configs import get_config

    cfg = get_config(SERVE_ARCH).replace(**REHEAD)
    check((cfg.d_model, cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim,
           cfg.num_layers) == (2048, 2048, 256, 22), f"re-headed config {cfg}")
    return cfg


def greedy_ids_with_logits(torch, engine, prompts, gen: int):
    """Serve ``prompts`` greedily, ``gen`` new tokens each, recording each
    decode step's f32 logits by (request, position): the engine's own step
    (``paged_decode_step`` then argmax, as ``_build_step`` has it at
    temperature 0) with the logits kept.  Returns (ids, logits)."""
    from repro_torch.models import transformer as tf

    cfg, seen = engine.cfg, {}

    def step(params, tokens, cache, block, length, seeds):
        logits, _ = tf.paged_decode_step(params, cfg, tokens, cache, block, length,
                                         decode_attn=engine._impl)
        lg = logits[:, 0, : cfg.vocab_size].float()
        for s, r in enumerate(engine.sched.slots):
            if r is not None:
                seen[(r.rid, len(r.tokens))] = lg[s].clone()
        return torch.argmax(lg, dim=-1).to(torch.int32)

    engine._step = step
    tickets = [engine.submit(p, max_new=gen) for p in prompts]
    engine.run_until_idle()
    order = {t._key: i for i, t in enumerate(tickets)}  # request id -> prompt index
    return ([t.result().tolist() for t in tickets],
            {(order[rid], pos): lg for (rid, pos), lg in seen.items()})


def reheaded_serve_phase(torch):
    """(H1) tinyllama-1.1b re-headed as Gemma-2B's attention (8 × 256 query
    heads, 1 × 256 KV) served through ``ContinuousLMEngine(device="cuda")``
    at the serving phase's slots, pages, length and requests: both decode
    kernels launched 22 times a step and nothing else, a captured step held
    to the plain path, the step's wall, aten operations and device time;
    then greedy ids against the same engine with ``use_kernel=False``.
    Where two ids differ, the first position that differs must be a near tie
    that the step's own kernel-vs-plain logit difference explains: there,
    the two engines have the same prefix, their logits differ by δ ≤
    ``LOGIT_TOL``, and the plain top-2 margin is at most 2δ."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ContinuousLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reheaded_config()
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    kernels.reset_launches()
    launches, out = continuous_run(
        torch, kernels, cfg, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
        requests=SERVE_REQUESTS, plen=(32, 512), glen=(16, 128), label="re-headed tinyllama")
    check(sum(kernels.PADS.values()) == 0, f"D 256 was padded: {kernels.PADS}")
    steps = out["decode_steps"]
    check(launches["decode_attention"] == 22 * steps, "re-headed: 22 launches a step")
    print(f"re-headed tinyllama-1.1b serving ({json.dumps(REHEAD)}; {smi_line()}): "
          f"{json.dumps(out)}", flush=True)

    # greedy ids, kernel engine against the use_kernel=False one
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(32, 257, size=REHEAD_ID_REQUESTS)]
    runs = {}
    for use_kernel in (True, False):
        engine = ContinuousLMEngine(cfg, params, n_slots=SERVE_SLOTS, page_size=SERVE_PAGE,
                                    max_seq=SERVE_MAX_SEQ, device="cuda", use_kernel=use_kernel)
        check(engine.kernel_plan["path"] == ("cuda" if use_kernel else "plain"),
              f"plan {engine.kernel_plan}")
        kernels.reset_launches()
        runs[use_kernel] = greedy_ids_with_logits(torch, engine, prompts, REHEAD_ID_GEN)
        moved = kernels.LAUNCHES["decode_attention"]
        check((moved > 0) == use_kernel, f"use_kernel={use_kernel}: {moved} decode launches")
        del engine
    (ids_k, lg_k), (ids_p, lg_p) = runs[True], runs[False]
    same = sum(a == b for a, b in zip(ids_k, ids_p))
    ties = []
    for i, (a, b) in enumerate(zip(ids_k, ids_p)):
        if a == b:
            continue
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        check(j > 0, f"request {i}: the first (prefill) token differs")
        key = (i, j)
        delta = float((lg_k[key] - lg_p[key]).abs().max())
        top2 = lg_p[key].topk(2).values
        margin = float(top2[0] - top2[1])
        check(delta <= LOGIT_TOL and margin <= 2 * delta,
              f"request {i} position {j}: ids differ with plain margin {margin} and logit "
              f"difference {delta} (limit {LOGIT_TOL})")
        ties.append({"request": i, "position": j, "margin": margin, "delta": delta})
    ids = {"requests": REHEAD_ID_REQUESTS, "new_tokens": REHEAD_ID_GEN,
           "identical_requests": same, "near_tie_divergences": ties}
    print(f"re-headed tinyllama-1.1b greedy ids, kernel engine vs use_kernel=False: "
          f"{json.dumps(ids)}", flush=True)
    out["greedy_ids"] = ids
    del params, runs
    torch.cuda.empty_cache()
    return launches, out


#: (H3) l1 k-means past one staged centroid row: N points in d dimensions
#: around K planted means, ITERS EM steps
WIDE_KM_N, WIDE_KM_K, WIDE_KM_D, WIDE_KM_ITERS = 1024, 8, 100_000, 4


def wide_kmeans_phase(torch):
    """(H3) ``ml.clustering.kmeans(..., metric="l1")`` at d 100,000 on the
    card, its E-steps through the split l1 kernel; the same k-means with the
    plain version as its E-step (in chunks) gives the same assignments and,
    from them, the same centroids bitwise."""
    from repro_torch import kernels
    from repro_torch.kernels.pdist_argmin import kernel as pdk, ref as pdr
    from repro_torch.ml import clustering

    N, K, d, iters = WIDE_KM_N, WIDE_KM_K, WIDE_KM_D, WIDE_KM_ITERS
    check(d > pdk.MAX_D_STAGED, "the k-means rows fit one staged centroid row")
    gen = torch.Generator(device="cuda").manual_seed(9)
    means = torch.randn((K, d), generator=gen, device="cuda")
    comp = torch.randint(0, K, (N,), generator=gen, device="cuda")
    X = means[comp] + 0.5 * torch.randn((N, d), generator=gen, device="cuda")
    C0 = X[torch.randperm(N, generator=gen, device="cuda")[:K]].clone()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km = clustering.kmeans(X, C0, num_clusters=K, metric="l1", iters=iters)
    torch.cuda.synchronize()
    km_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = {n: {"pdist_argmin": iters + 1, "pdist_argmin_tc": 1}.get(n, 0)
            for n in kernels.KERNEL_NAMES}
    check(launches == want, f"wide l1 kmeans launches {launches}, expected {want}")

    def plain(Xq, Cq, metric="l2"):  # the plain version, (rows, K, d) at a time
        outs = [pdr.pdist_argmin_ref(Xq[s:s + 64], Cq, metric) for s in range(0, Xq.shape[0], 64)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    ops = clustering.pdist_ops
    real = ops.pdist_argmin
    ops.pdist_argmin = lambda Xq, Cq, *, metric="l2", bn=128: plain(Xq, Cq, metric)
    try:
        t0 = time.perf_counter()
        ref = clustering.kmeans(X, C0, num_clusters=K, metric="l1", iters=iters)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    finally:
        ops.pdist_argmin = real
    check(torch.equal(km.assignments, ref.assignments), "wide l1 kmeans: assignments differ "
          "from the plain version's")
    check(torch.equal(km.centroids, ref.centroids), "wide l1 kmeans: centroids differ")
    obj0 = float(plain(X, C0, "l1")[1].sum())
    obj = float(plain(X, km.centroids, "l1")[1].sum())
    check(obj < obj0, f"wide l1 kmeans: objective {obj} not below C0's {obj0}")
    found = len(set(km.assignments.tolist()))
    out = {"N": N, "K": K, "d": d, "iters": iters, "seconds": km_s, "plain_e_step_seconds": ref_s,
           "launches": {n: v for n, v in launches.items() if v}, "objective": [obj0, obj],
           "clusters_used": found, "splits": list(pdk.plan_wide(
               N, K, d, torch.cuda.get_device_properties(0).multi_processor_count))}
    print(f"l1 k-means at d {d} (split kernel; {smi_line()}): {json.dumps(out)}", flush=True)
    del X, C0, means, km, ref
    torch.cuda.empty_cache()
    return launches["pdist_argmin"], out


# ----------------------------------------------------------------------------
# Serving and tracing: fit → publish → serve, a traced fit, the microbatched
# LM path and the continuous engine under an ambient tracer
# ----------------------------------------------------------------------------

SERVE_Q = 4_096  # single-row requests of phase (A)
SERVE_BUCKET = 64
LM_ARGS = ["--arch", SERVE_ARCH, "--batch", "8", "--requests", "22", "--prompt-len", "128",
           "--gen", "32", "--device", "cuda"]
#: phase (D): the first requests of the serving phase's workload
D_REQUESTS = 6


def _launch_delta(kernels, before: dict) -> dict:
    return {n: kernels.LAUNCHES[n] - before[n] for n in kernels.KERNEL_NAMES
            if kernels.LAUNCHES[n] - before[n]}


def fit_publish_serve(torch, api, kernels, data, ref_a, tmp):
    """(A): run (a) on the serving executor, published, then 4,096 requests
    through the registry's engine behind a microbatcher."""
    import numpy as np

    from repro_torch.launch.serve import _drain
    from repro_torch.ml.linear import logistic_loss
    from repro_torch.serve import MicroBatcher, ModelRegistry, ServeEngine, ServeMetrics

    strategy = api.GradientDescent(logistic_loss, lr=1.0)
    reg = ModelRegistry(os.path.join(tmp, "registry"))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = api.fit(strategy, data, transport="allreduce", wire="topk:0.01+ef", steps=STEPS,
                  executor=api.ServingExecutor(registry=reg, publish_as="epsilon"),
                  device="cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = {n: (STEPS if n == "topk_encode" else 0) for n in kernels.KERNEL_NAMES}
    check(launches == want, f"(A) launches {launches}, expected {want}")
    check(same_fit(torch, res, ref_a), "(A) the serving executor's fit is not bitwise run (a)")
    check(isinstance(res.metrics["serve_engine"], ServeEngine), "(A) no serve_engine")
    loaded = reg.load("epsilon")
    check(reg.latest("epsilon") == 1 and loaded.is_cuda
          and torch.equal(loaded.view(torch.int32), res.theta.view(torch.int32)),
          "(A) registry.load is not bitwise θ")

    engine = ServeEngine.from_registry(reg, "epsilon", strategy)
    check(engine.device.type == "cuda", f"(A) engine on {engine.device}")
    Xq = np.random.default_rng(7).standard_normal((SERVE_Q, D), dtype=np.float32)
    engine.predict(Xq[:SERVE_BUCKET])  # first-call costs (cuBLAS handle)
    engine.metrics = ServeMetrics()
    batcher = MicroBatcher(engine, max_batch=SERVE_BUCKET)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets = [batcher.submit(x) for x in Xq]
    _drain(batcher)
    answers = torch.stack([t.result() for t in tickets])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    stats = engine.stats()
    check(answers.is_cuda and answers.shape == (SERVE_Q,), f"(A) answers {answers.shape}")
    check(engine.ledger.uplink_bytes == SERVE_Q * D * 4
          and engine.ledger.downlink_bytes == SERVE_Q * 4,
          f"(A) ledger {engine.ledger.uplink_bytes} / {engine.ledger.downlink_bytes} B")
    check(batcher.flushes == SERVE_Q // SERVE_BUCKET and engine.metrics.padded_slots == 0,
          f"(A) {batcher.flushes} flushes, {engine.metrics.padded_slots} padded slots")
    # each bucket is 64 consecutive submits: its answers are that bucket's predict
    ref = ServeEngine(strategy, loaded)
    buckets = torch.cat([ref.predict(Xq[i: i + SERVE_BUCKET])
                         for i in range(0, SERVE_Q, SERVE_BUCKET)])
    check(torch.equal(answers.view(torch.int32), buckets.view(torch.int32)),
          "(A) an answer differs from its bucket's predict")
    whole = ref.predict(Xq)
    gap = float((answers - whole).abs().max())
    scale = float(whole.abs().max())
    check(gap <= 1e-5 * scale, f"(A) answers {gap} from one predict of all rows (scale {scale})")
    before = engine.predict(Xq[:SERVE_BUCKET])
    gen = torch.Generator(device="cuda").manual_seed(3)
    engine.swap(loaded + 0.01 * torch.randn(loaded.shape, generator=gen, device="cuda"))
    after = engine.predict(Xq[:SERVE_BUCKET])
    check(not torch.equal(before, after), "(A) swap did not change the answers")
    out = {
        "fit_s": fit_s, "fit_rounds_per_s": STEPS / fit_s, "launches": launches,
        "requests": SERVE_Q, "serve_s": serve_s, "requests_per_s": SERVE_Q / serve_s,
        "engine_requests_per_s": stats["requests_per_s"],
        "p50_latency_ms": stats["p50_latency_ms"], "p95_latency_ms": stats["p95_latency_ms"],
        "flushes": batcher.flushes, "padded_slots": engine.metrics.padded_slots,
        "max_gap_to_one_predict": gap, "answer_scale": scale,
        "request_bytes": engine.ledger.uplink_bytes, "response_bytes": engine.ledger.downlink_bytes,
    }
    print(f"(A) fit → publish → serve: {json.dumps(out)}", flush=True)
    return launches, out


def traced_fit(torch, api, kernels, data, ref_a, tmp):
    """(B): run (a) traced with trace="phases"; the tracing overhead in
    turns; the Chrome export; one device trace around 3 rounds."""
    from torch.autograd import DeviceType

    from repro_torch.ml.linear import logistic_loss
    from repro_torch.telemetry import RunReport, Tracer

    strategy = api.GradientDescent(logistic_loss, lr=1.0)
    spec = dict(transport="allreduce", wire="topk:0.01+ef", steps=STEPS, device="cuda")
    # the tracing overhead: untraced and traced (no phases) fits in turns
    walls = {"untraced": [], "traced": []}
    for _ in range(3):
        for label in ("untraced", "traced"):
            kw = {"tracer": Tracer()} if label == "traced" else {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = api.fit(strategy, data, **spec, **kw)
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
            check(same_fit(torch, r, ref_a), f"(B) {label} fit is not bitwise run (a)")
    rps = {k: STEPS / statistics.median(v) for k, v in walls.items()}

    tracer = Tracer()
    kernels.reset_launches()
    res = api.fit(strategy, data, **spec, tracer=tracer, trace="phases")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(same_fit(torch, res, ref_a), "(B) the traced fit is not bitwise run (a)")
    # 20 in the fit, 2 × 20 in the encode probe (warm-up + timed)
    want = {n: (3 * STEPS if n == "topk_encode" else 0) for n in kernels.KERNEL_NAMES}
    check(launches == want, f"(B) launches {launches}, expected {want}")
    launches = {n: c for n, c in launches.items() if c}
    summary = tracer.summary()
    names = ("fit/loop", "fit/ledger", "fit/metrics", "dispatch/local-update",
             "phase/local_step", "phase/encode")
    # phase/stats_completion and hop/* are probes of mesh placements only
    for name in names:
        check(name in summary, f"(B) span {name} missing: {sorted(summary)}")
    span_ms = {n: 1e3 * e["total_s"] for n, e in summary.items()}
    check(tracer.counters == {"program_cache/uncached": 1}, f"(B) counters {tracer.counters}")
    path = tracer.export_chrome(os.path.join(tmp, "run.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    complete = [e for e in events if e["ph"] == "X"]
    check(len(complete) == len(tracer.spans) and all(e["dur"] >= 0 for e in complete),
          f"(B) {len(complete)} complete events for {len(tracer.spans)} spans")
    report = RunReport.from_fit(res, tracer=tracer)
    check(report.as_dict()["wire_kernel_hits"]["launches"] == {"topk_encode": STEPS},
          f"(B) report launches {report.as_dict()['wire_kernel_hits']}")
    # the same fit placed on a mesh (a world of one, no process group): the
    # per-hop probe and the deferred statistics' completion join the spans
    mesh_tracer = Tracer()
    before = dict(kernels.LAUNCHES)
    res_m = api.fit(strategy, data, **spec, executor="mesh", tracer=mesh_tracer,
                    trace="phases")
    torch.cuda.synchronize()
    for n, c in _launch_delta(kernels, before).items():
        launches[n] = launches.get(n, 0) + c
    check(same_fit(torch, res_m, ref_a), "(B) the traced mesh fit is not bitwise run (a)")
    mesh_summary = mesh_tracer.summary()
    for name in names[:3] + ("dispatch/mesh-update", "phase/local_step", "phase/encode",
                             "hop/flat", "phase/stats_completion"):
        check(name in mesh_summary, f"(B) mesh span {name} missing: {sorted(mesh_summary)}")
    span_ms.update({f"mesh {n}": 1e3 * e["total_s"] for n, e in mesh_summary.items()
                    if n.startswith(("hop/", "phase/stats", "dispatch/"))})

    before = dict(kernels.LAUNCHES)
    with tracer.device_trace(os.path.join(tmp, "device_trace")) as prof:
        api.fit(strategy, data, transport="allreduce", wire="topk:0.01+ef", steps=3,
                device="cuda", tracer=tracer)
    dt_launches = _launch_delta(kernels, before)
    for n, c in dt_launches.items():
        launches[n] = launches.get(n, 0) + c
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    enc = [e for e in on_card if "topk_encode" in e.key]
    check(enc and sum(e.count for e in enc) == 3,
          f"(B) the profiler saw no topk_encode kernel: {[e.key[:60] for e in on_card][:12]}")
    check(os.path.getsize(os.path.join(tmp, "device_trace", "device_trace.json")) > 0,
          "(B) no device trace written")
    out = {"rounds_per_s": rps, "walls_s": walls,
           "overhead": rps["untraced"] / rps["traced"] - 1, "span_ms": span_ms,
           "launches": launches, "chrome_events": len(events),
           "device_trace_topk_encode": {"key": enc[0].key[:80], "count": sum(e.count for e in enc),
                                        "device_ms": sum(e.self_device_time_total
                                                         for e in enc) / 1e3}}
    print(f"(B) traced fit: {json.dumps(out)}", flush=True)
    print(report.to_markdown(), flush=True)
    return launches, out


def microbatched_lm(torch, kernels):
    """(C): tinyllama-1.1b at full width through the microbatched CLI path:
    buckets 8, 8 and 8 (2 padded), batched prefill."""
    import contextlib
    import io

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tf

    torch.cuda.synchronize()
    kernels.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        outs = launch_serve.main(LM_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    text = buf.getvalue()
    print(text.rstrip(), flush=True)
    check(all(n == 0 for n in launches.values()), f"(C) launched kernels {launches}")
    stats = json.loads(next(line for line in text.splitlines() if line.startswith("{")))
    cfg = get_config(SERVE_ARCH)
    R, P, G = 22, 128, 32
    check(outs.shape == (R, G) and outs.dtype == np.int32, f"(C) ids {outs.shape}")
    check(bool(((outs >= 0) & (outs < cfg.vocab_size)).all()), "(C) id out of range")
    check(stats["request_bytes"] == R * P * 4 and stats["response_bytes"] == R * G * 4,
          f"(C) ledger {stats['request_bytes']} / {stats['response_bytes']} B")
    # the CLI prints its floats to 4 decimals
    check(stats["batches"] == 3 and abs(stats["pad_fraction"] - 2 / 24) < 1e-4,
          f"(C) {stats['batches']} batches, pad fraction {stats['pad_fraction']}")
    # the padding contract: the padded bucket's 6 real rows get the ids the
    # same prompts get in a full bucket of 8
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(R, P)).astype(np.int32)
    full = np.concatenate([prompts[16:], prompts[:2]])
    predict = launch_serve.lm_predict_fn(cfg, gen=G)
    ids = predict(params, torch.from_numpy(full).cuda()).cpu().numpy()
    check(np.array_equal(ids[:6], outs[16:]), "(C) padding changed a real request's ids")
    two = torch.from_numpy(prompts[:2]).cuda()
    b = launch_serve.prefill_and_decode(cfg, params, two, gen=G, cache_len=P + G + 1,
                                        prefill="batched")
    lp = launch_serve.prefill_and_decode(cfg, params, two, gen=G, cache_len=P + G + 1,
                                         prefill="loop")
    # where a bucket's time goes: one bucket of 8 under the profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eight = torch.from_numpy(prompts[:8]).cuda()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        predict(params, eight)
        torch.cuda.synchronize()
        p_wall = (time.perf_counter() - t1) * 1e3
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e3
    aten = sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and e.key.startswith("aten::"))
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:4]
    profiled = {"wall_ms": p_wall, "device_busy_ms": busy, "idle_share": 1 - busy / p_wall,
                "aten_calls_nested_included": aten, "decode_calls": G + 1,
                "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in top]}
    agree = float((b == lp).float().mean())
    first = [int((b[i] != lp[i]).nonzero()[0]) if bool((b[i] != lp[i]).any()) else G
             for i in range(2)]
    out = {"wall_s": wall, "tokens": R * G, "tokens_per_s_wall": R * G / wall,
           "tokens_per_s_busy": R * G / stats["busy_s"],
           "p50_latency_ms": stats["p50_latency_ms"], "p95_latency_ms": stats["p95_latency_ms"],
           "batched_vs_loop_ids_agree": agree, "first_disagreement": first,
           "padding_contract": True, "profiled_bucket": profiled}
    print(f"(C) microbatched LM: {json.dumps(out)}", flush=True)
    del params
    torch.cuda.empty_cache()
    return launches, out


def continuous_traced(torch, kernels):
    """(D): the first requests of the serving phase's workload, untraced and
    then inside ``activated(Tracer())``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ContinuousLMEngine
    from repro_torch.telemetry import RunReport, Tracer, trace

    cfg = get_config(SERVE_ARCH)
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    # the serving phase's workload, drawn as it draws it; its first requests
    rng = np.random.default_rng(0)
    plens = rng.integers(32, 513, size=SERVE_REQUESTS)
    gens = rng.integers(16, 129, size=SERVE_REQUESTS)[:D_REQUESTS]
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in plens][:D_REQUESTS]

    def serve():
        eng = ContinuousLMEngine(cfg, params, n_slots=SERVE_SLOTS, page_size=SERVE_PAGE,
                                 max_seq=SERVE_MAX_SEQ, device="cuda")
        tickets = [eng.submit(p, max_new=int(g)) for p, g in zip(prompts, gens)]
        steps = eng.run_until_idle()
        torch.cuda.synchronize()
        return eng, steps, [t.result() for t in tickets]

    _, _, plain = serve()
    tracer = Tracer()
    kernels.reset_launches()
    with trace.activated(tracer):
        eng, steps, ids = serve()
    launches = dict(kernels.LAUNCHES)
    check(eng.tracer is tracer, "(D) the engine did not pick up the ambient tracer")
    check(all(np.array_equal(a, b) for a, b in zip(plain, ids)),
          "(D) traced greedy ids differ from the untraced run's")
    n_layers = cfg.num_layers
    check(launches["decode_attention"] == steps * n_layers
          and launches["decode_attention_merge"] == steps * n_layers,
          f"(D) decode launches {launches}, {steps} steps × {n_layers}")
    summary = tracer.summary()
    check(summary["serve/decode_step"]["count"] == steps,
          f"(D) {summary['serve/decode_step']['count']} decode-step spans for {steps} steps")
    check(tracer.counters["serve/requests"] == D_REQUESTS,
          f"(D) serve/requests {tracer.counters['serve/requests']}")
    report = RunReport.from_serve(eng)
    print(report.to_markdown(), flush=True)
    out = {"requests": D_REQUESTS, "decode_steps": steps, "launches": {
        k: v for k, v in launches.items() if v}, "spans": {
        k: {"count": e["count"], "total_ms": 1e3 * e["total_s"]} for k, e in summary.items()},
        "counters": tracer.counters}
    print(f"(D) continuous engine under an ambient tracer: {json.dumps(out)}", flush=True)
    del eng, params
    torch.cuda.empty_cache()
    return launches, out


def serving_tracing_phase(torch, ref_a):
    """Phases (A)–(D) of the serving-and-tracing phase; returns the launches
    each drove (its counts set to 0 before it and read after) summed."""
    import tempfile

    from repro_torch import api, kernels

    t0 = time.perf_counter()
    launches = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        data = make_epsilon_shaped(torch, 0)
        out = {}
        for label, fn in (("A", fit_publish_serve), ("B", traced_fit)):
            got, out[label] = fn(torch, api, kernels, data, ref_a, tmp)
            for n, c in got.items():
                launches[n] += c
        del data
        torch.cuda.empty_cache()
        for label, fn in (("C", microbatched_lm), ("D", continuous_traced)):
            got, out[label] = fn(torch, kernels)
            for n, c in got.items():
                launches[n] += c
    print(f"serving and tracing phase: {time.perf_counter() - t0:.2f} s", flush=True)
    return launches, out


# ----------------------------------------------------------------------------
# The §4 clustering family: the nearest-centroid kernel and distributed k-means
# ----------------------------------------------------------------------------

#: the KDD Cup 1999 set as the k-means|| paper clusters it (Bahmani et al.,
#: VLDB 2012): 4,898,432 points (one above 4,898,431, for equal sites) in 42
#: dimensions over 16 sites, k = 1000, 20 EM iterations
SITES, SITE_N, KDD_D, KDD_K, KDD_ITERS = 16, 306_152, 42, 1000, 20
#: the reduced size of the rest of the family (16 sites × 20,000 × 42)
SMALL_N = 20_000
PDIST_CHUNK = 8192  # points the plain version (it materialises N × K × d) runs on
#: |kernel − plain| ≤ atol + rtol·|plain|: the JAX pdist test's jnp.allclose
#: (atol 1e-5, its default rtol 1e-5); rtol is what binds at the large shapes
PDIST_ATOL = PDIST_RTOL = 1e-5
#: (N, K, d): tests/test_kernels_pdist.py's CASES, K = 1, the design limit
#: K 1024 × d 512 (C in tiles, columns in chunks on the CUDA-core kernel),
#: duplicated centroid rows (exact ties), and N off the CUDA-core kernel's
#: 256-point pass at K 1,000 (C whole in shared memory) and at odd K and d;
#: the first 8,192 points of the main shape run last, against its 1,000
#: centroids
PDIST_SHAPES = [(500, 16, 8), (300, 7, 5), (260, 5, 3), (128, 32, 64), (1000, 3, 2),
                (65, 4, 4), (4099, 1, 42), (1000, 1024, 512), ("dup", 40, 20),
                (3001, 1000, 42), (513, 33, 17)]
#: (N, K, d) of the l1 / l∞ route past one staged centroid row (d > 58,108:
#: the split kernel and its merge), the first column past it and d 100,000
PDIST_WIDE_SHAPES = [(4096, 16, 58_109), (4096, 16, 100_000)]


def make_kdd_shaped(torch, seed: int, n_per_site: int = SITE_N):
    """A planted mixture of ``KDD_K`` Gaussian components at the KDD Cup
    1999 shape, made on the card from a seeded generator: means ~ N(0, 10²),
    unit noise, components drawn uniformly.  Returns the (sites, n, 42)
    points and ``KDD_K`` distinct rows of them as C0."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    means = 10.0 * torch.randn((KDD_K, KDD_D), generator=gen, device="cuda")
    comp = torch.randint(0, KDD_K, (SITES * n_per_site,), generator=gen, device="cuda")
    X = means[comp] + torch.randn((SITES * n_per_site, KDD_D), generator=gen, device="cuda")
    C0 = X[torch.randperm(X.shape[0], generator=gen, device="cuda")[:KDD_K]].clone()
    return X.reshape(SITES, n_per_site, KDD_D), C0


def pdist_compare(torch, X, C, metric, out=None):
    """Kernel against plain version on one input: (max |kernel − plain|,
    points whose top-2 gap clears the tolerance, points).  Fails on a
    distance outside the tolerance or an index that differs where the gap
    is clear.  ``out`` is the kernel's (index, distance) for X when a
    launch made elsewhere is held to the plain version; else it launches."""
    from repro_torch.kernels.pdist_argmin import kernel as pdk, ref as pdr
    from repro_torch.ml.clustering import pdist

    idx, dist = pdk.pdist_argmin(X, C, metric) if out is None else out
    err, clear_n = 0.0, 0
    # the plain version materialises (rows, K, d): at most 2^28 elements
    rows = max(1, min(1024, (1 << 28) // (C.shape[0] * X.shape[1])))
    for s in range(0, X.shape[0], rows):
        xs = X[s:s + rows]
        r_idx, r_dist = pdr.pdist_argmin_ref(xs, C, metric)
        tol = PDIST_ATOL + PDIST_RTOL * r_dist.abs()
        diff = (dist[s:s + rows] - r_dist).abs()
        check(bool((diff <= tol).all()), f"pdist_argmin {tuple(X.shape)}×{tuple(C.shape)} "
              f"{metric} {X.dtype}: distance off by {float(diff.max())}")
        D = pdist(xs.float(), C.float(), "l2sq" if metric == "l2" else metric)
        if C.shape[0] > 1:
            top = torch.topk(D, 2, dim=1, largest=False).values
            clear = (top[:, 1] - top[:, 0]) > tol
        else:
            clear = torch.ones_like(tol, dtype=torch.bool)
        same = idx[s:s + rows].long() == r_idx.long()
        check(bool(same[clear].all()), f"pdist_argmin {tuple(X.shape)}×{tuple(C.shape)} "
              f"{metric} {X.dtype}: index differs where the top-2 gap is clear")
        err = max(err, float(diff.max()))
        clear_n += int(clear.sum())
    return err, clear_n, X.shape[0]


TF32_OPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense (NVIDIA data sheet)


#: the first designs' times, in turns with the redesigns on an NVIDIA H100
#: 80GB HBM3 at 700 W (PERF.md §6), printed beside the new times since the
#: first designs are gone: median (min, max) of 6 runs, ms.  flash: the f32
#: CUDA-core kernel; pdist: the first l1/l∞ kernel
EARLIER_FLASH_F32_MS = {"main": (6.3892, 6.3692, 6.3980),
                        "qwen2-1.5b": (4.3769, 4.2996, 4.4211)}
EARLIER_PDIST_MS = {"l1": (0.083539, 0.083142, 0.086982),
                    "linf": (0.080922, 0.080461, 0.081171),
                    "kdd": {"l1": 29.929, "linf": 30.643}}  # the median of 3 eager runs
#: the first l2 route at the KDD shape, the CUDA-core kernel in the direct
#: form (PERF.md §6), ms; the l1/l∞ redesign took that kernel's place
EARLIER_PDIST_L2_KDD_MS = 29.629
#: points of the KDD-shape l1/l∞ launch held to the plain version: the
#: first blocks' ranges whole (every pass, the short last one included) and
#: the last block's
PDIST_KDD_HEAD, PDIST_KDD_TAIL = 262_144, 65_536


def cc_bounds(n: int, k: int, d: int = KDD_D) -> dict:
    """The l1/l∞ route's bound at (n, k, d): instruction issue, a subtract
    and an add or max (|·| an operand modifier) a term, 2 n k d f32
    instructions at ``F32_ISSUE_PER_S``; beside it the bytes of X and C
    read and the index and distance written."""
    issue = 2 * n * k * d / F32_ISSUE_PER_S * 1e3
    nbytes = (n * d + k * d) * 4 + n * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(issue, t_bytes),
            "bound_by": "operations" if issue >= t_bytes else "bytes",
            "issue_bound_ms": issue, "bytes_bound_ms": t_bytes}
#: the adversarial input: ‖x‖² ≈ 1e6 around centroids in pairs 1e-3 apart,
#: where the expanded form ‖x‖² − 2x·c + ‖c‖² cancels (N, pairs, d)
PDIST_ADVERSARIAL = (4099, 32, 42)


def make_adversarial(torch, dtype, seed: int = 7):
    N, pairs, d = PDIST_ADVERSARIAL
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.full((d,), 1000.0 / d**0.5, device="cuda")
    centers = base + torch.randn((pairs, d), generator=gen, device="cuda")
    step = torch.randn((pairs, d), generator=gen, device="cuda")
    step = 1e-3 * step / step.norm(dim=1, keepdim=True)
    C = torch.cat([centers, centers + step]).to(dtype)
    X = (base + torch.randn((N, d), generator=gen, device="cuda")).to(dtype)
    return X, C


def pdist_kernel_phase(torch, Xs, C0):
    """The nearest-centroid kernels (l2 → tensor cores, l1 and l∞ → CUDA
    cores) against their plain version at every shape, metric and type,
    the adversarial input, then times at the main shape in turns."""
    from repro_torch import kernels
    from repro_torch.kernels.pdist_argmin import kernel as pdk, ref as pdr

    gen = torch.Generator(device="cuda").manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = {"pdist_argmin": 0.0, "pdist_argmin_tc": 0.0}
    checked = 0
    chunk = Xs.reshape(-1, KDD_D)[:PDIST_CHUNK]
    for shape in PDIST_SHAPES + [("main", KDD_K, KDD_D)]:
        N, K, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            if N == "main":
                X, C = chunk.to(dtype), C0.to(dtype)
            else:
                X = torch.randn((1000 if N == "dup" else N, d), generator=gen,
                                device="cuda").to(dtype)
                C = torch.randn((K, d), generator=gen, device="cuda").to(dtype)
            if N == "dup":  # every row three times: exact ties take the first
                C = torch.cat([C, C, C])
            for metric in ("l2", "l1", "linf"):
                e, clear, n = pdist_compare(torch, X, C, metric)
                if N == "dup":
                    i3, d3 = pdk.pdist_argmin(X, C, metric)
                    i1, d1 = pdk.pdist_argmin(X, C[:K].contiguous(), metric)
                    check(torch.equal(i3, i1) and torch.equal(d3, d1),
                          f"pdist_argmin ties {metric} {dtype}: not the first index")
                err[pdk.route(metric)] = max(err[pdk.route(metric)], e)
                checked += 1
                print(f"pdist check {shape} {metric} ({pdk.route(metric)}) {str(dtype)[6:]}: "
                      f"max |kernel − plain| {e:.4g}, index compared on {clear}/{n} points",
                      flush=True)
    # the adversarial input: the guard must bring the l2 route back to the
    # direct form's answer
    for dtype in (torch.float32, torch.bfloat16):
        X, C = make_adversarial(torch, dtype)
        out = pdk.nearest_l2_tc(X, C)
        e, clear, n = pdist_compare(torch, X, C, "l2", out=out[:2])
        rechecked = int(out[2])
        check(rechecked > 0, f"pdist adversarial {dtype}: the guard re-checked no row")
        err["pdist_argmin_tc"] = max(err["pdist_argmin_tc"], e)
        checked += 1
        print(f"pdist check adversarial {PDIST_ADVERSARIAL} l2 {str(dtype)[6:]}: max |kernel − "
              f"plain| {e:.4g}, index compared on {clear}/{n} points; the guard re-checked "
              f"{rechecked} rows", flush=True)
    torch.cuda.synchronize()
    print(f"pdist phase: {checked} comparisons within atol {PDIST_ATOL} + rtol "
          f"{PDIST_RTOL}·|plain|, indices equal wherever the top-2 gap is clear", flush=True)

    # times at the main shape (4,898,432 × 42 against 1,000, l2, f32), in
    # turns: the tensor-core route, the bf16 route, and torch.cdist + min
    # (it materialises the 19.6 GB distance matrix: eager)
    X = Xs.reshape(-1, KDD_D)
    N = X.shape[0]
    nbytes = (N * KDD_D + KDD_K * KDD_D) * 4 + N * 8
    # what the function needs: one multiply-add (2 operations) per term of
    # x·c, as the expanded form does, plus the norms; the tensor-core route
    # computes x·c as three TF32 products, so its bound is 3 × 2·N·K·d at
    # the TF32 rate; the f32 bound (the same operations at the CUDA cores'
    # rate) is kept beside it
    ops = 2 * N * KDD_K * KDD_D + 2 * (N + KDD_K) * KDD_D
    f32_ms, _ = bound_ms(nbytes, ops)
    tc_ops = 3 * 2 * N * KDD_K * KDD_D
    tc_ms = max(tc_ops / TF32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if tc_ops / TF32_OPS_PER_S >= nbytes / HBM_BYTES_PER_S else "bytes"
    torch.cuda.empty_cache()
    Xb, Cb = X.bfloat16(), C0.bfloat16()  # the bf16 route: one product at 989 TFLOP/s
    t = turns_ms(torch, {
        "library": lambda: torch.cdist(X, C0).min(dim=1),
        "kernel": lambda: pdk.nearest_l2_tc(X, C0),
        "kernel_bf16": lambda: pdk.nearest_l2_tc(Xb, Cb),
    }, inner=3, rounds=3, eager=("library",))
    bf16_ops = 2 * N * KDD_K * KDD_D
    bf16_bytes = (N * KDD_D + KDD_K * KDD_D) * 2 + N * 8
    bf16_bound = max(bf16_ops / BF16_OPS_PER_S, bf16_bytes / HBM_BYTES_PER_S) * 1e3
    bf16_rechecked = int(pdk.nearest_l2_tc(Xb, Cb)[2])
    del Xb, Cb
    torch.cuda.empty_cache()
    plain_ms = eager_ms(torch, lambda: pdr.pdist_argmin_ref(chunk, C0, "l2"), inner=1, reps=5)
    rechecked = int(pdk.nearest_l2_tc(X, C0)[2])
    tc = {
        "ms": t["kernel"]["median"], "turns": t, "plain_ms": plain_ms,
        "plain_shape": [PDIST_CHUNK, KDD_D, KDD_K],
        "library_ms": t["library"]["median"], "library": "torch.cdist(X, C).min(dim=1)",
        "bound_ms": tc_ms, "bound_by": bound_by, "bound_f32_ms": f32_ms,
        "shape": [N, KDD_D, KDD_K], "bytes": nbytes, "ops_3xtf32": tc_ops,
        "earlier_ms_recorded": EARLIER_PDIST_L2_KDD_MS,
        "earlier": "the first l2 route, the CUDA-core kernel in the direct form (PERF.md)",
        "rechecked_rows": rechecked, "rechecked_share": rechecked / N,
        "bf16_ms": t["kernel_bf16"]["median"], "bf16_bound_ms": bf16_bound,
        "bf16_rechecked_rows": bf16_rechecked,
    }
    print(f"time pdist_argmin_tc main (l2, f32): {tc}", flush=True)

    # the CUDA-core route at its path's shape: kmeans(metric="l1" | "linf")
    # of the reduced family (16 × 20,000 × 42 points against 32 centroids),
    # in turns with torch.cdist(p).min(dim=1)
    Xr = X[:SITES * SMALL_N]
    Cr = C0[:32].contiguous()
    nr = Xr.shape[0]
    # first held to the plain version there, where each block makes several
    # 256-point passes: in both types, and f32 and bf16 with X one row off 16
    # bytes (the kernel's scalar loads)
    for metric in ("l1", "linf"):
        for dtype in (torch.float32, torch.bfloat16):
            Xd, Cd = X[:nr + 1].to(dtype), Cr.to(dtype)
            for what, Xv in (("", Xd[:nr]), (", X one row off 16 bytes", Xd[1:])):
                check(what == "" or Xv.data_ptr() % 16 != 0, "pdist: the view is aligned")
                e, clear, n = pdist_compare(torch, Xv, Cd, metric)
                err["pdist_argmin"] = max(err["pdist_argmin"], e)
                print(f"pdist check kmeans shape {tuple(Xv.shape)}×{tuple(Cd.shape)} {metric} "
                      f"{str(dtype)[6:]}{what}: max |kernel − plain| {e:.4g}, index compared "
                      f"on {clear}/{n} points", flush=True)
    cc = {}
    for metric, p in (("l1", 1.0), ("linf", float("inf"))):
        t1 = turns_ms(torch, {
            "library": lambda p=p: torch.cdist(Xr, Cr, p=p).min(dim=1),
            "kernel": lambda m=metric: pdk.pdist_argmin(Xr, Cr, m),
        }, inner=5, rounds=3)
        cc[metric] = {
            "ms": t1["kernel"]["median"], "turns": t1,
            "plain_ms": eager_ms(
                torch, lambda m=metric: pdr.pdist_argmin_ref(Xr[:PDIST_CHUNK], Cr, m),
                inner=1, reps=5),
            "plain_shape": [PDIST_CHUNK, KDD_D, 32],
            "library_ms": t1["library"]["median"],
            "library": f"torch.cdist(X, C, p={p}).min(dim=1)",
            **cc_bounds(nr, 32), "shape": [nr, KDD_D, 32], "metric": metric,
            "first_design_ms_recorded": EARLIER_PDIST_MS[metric],
        }
        print(f"time pdist_argmin (CUDA cores) at kmeans(metric={metric!r})'s shape, in turns "
              f"with torch.cdist: {cc[metric]}", flush=True)
    # the kernel alone at the KDD Cup 1999 shape
    kdd = {"shape": [N, KDD_D, KDD_K], **cc_bounds(N, KDD_K)}
    for metric in ("l1", "linf"):
        last = {}
        kdd[metric] = eager_ms(
            torch, lambda m=metric: last.__setitem__("out", pdk.pdist_argmin(X, C0, m)),
            inner=1, reps=3)
        idx, dist = last.pop("out")  # the last timed launch, held to the plain version
        for a, b in ((0, PDIST_KDD_HEAD), (N - PDIST_KDD_TAIL, N)):
            e, clear, n = pdist_compare(torch, X[a:b], C0, metric, out=(idx[a:b], dist[a:b]))
            err["pdist_argmin"] = max(err["pdist_argmin"], e)
            print(f"pdist check KDD shape {metric} f32, points {a}..{b}: max |kernel − plain| "
                  f"{e:.4g}, index compared on {clear}/{n} points", flush=True)
        del idx, dist
    kdd["first_design_ms_recorded"] = EARLIER_PDIST_MS["kdd"]
    print(f"time pdist_argmin (CUDA cores) alone at the KDD shape: {kdd}", flush=True)
    cc["kdd"] = kdd
    del X, Xr, Cr
    torch.cuda.empty_cache()

    # rows past one staged centroid row: the split kernel and its merge (one
    # count a call), held to the plain version in both types, then timed at
    # d 100,000 in turns with torch.cdist(p).min(dim=1)
    for N, K, d in PDIST_WIDE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            Xw = torch.randn((N, d), generator=gen, device="cuda").to(dtype)
            Cw = torch.randn((K, d), generator=gen, device="cuda").to(dtype)
            for metric in ("l1", "linf"):
                n0 = kernels.LAUNCHES["pdist_argmin"]
                e, clear, n = pdist_compare(torch, Xw, Cw, metric)
                check(kernels.LAUNCHES["pdist_argmin"] == n0 + 1, "pdist wide: one count a call")
                err["pdist_argmin"] = max(err["pdist_argmin"], e)
                print(f"pdist check wide rows {(N, K, d)} {metric} {str(dtype)[6:]} (split "
                      f"kernel, (jlen, splits) {pdk.plan_wide(N, K, d, sms)}): max |kernel − "
                      f"plain| {e:.4g}, index compared on {clear}/{n} points", flush=True)
            del Xw, Cw
    N, K, d = PDIST_WIDE_SHAPES[-1]
    Xw = torch.randn((N, d), generator=gen, device="cuda")
    Cw = torch.randn((K, d), generator=gen, device="cuda")
    wide = {"shape": [N, d, K], **cc_bounds(N, K, d)}
    for metric, p in (("l1", 1.0), ("linf", float("inf"))):
        t1 = turns_ms(torch, {
            "library": lambda p=p: torch.cdist(Xw, Cw, p=p).min(dim=1),
            "kernel": lambda m=metric: pdk.pdist_argmin(Xw, Cw, m),
        }, inner=2, rounds=3)
        wide[metric] = {
            "ms": t1["kernel"]["median"], "turns": t1,
            "plain_ms": eager_ms(torch, lambda m=metric: [
                pdr.pdist_argmin_ref(Xw[s:s + 160], Cw, m) for s in range(0, N, 160)],
                inner=1, reps=3),
            "library_ms": t1["library"]["median"],
            "library": f"torch.cdist(X, C, p={p}).min(dim=1)",
        }
        print(f"time pdist_argmin (CUDA cores, split kernel) {metric} at {(N, K, d)} f32, in "
              f"turns with torch.cdist: {wide[metric]}", flush=True)
    cc["wide"] = wide
    del Xw, Cw
    torch.cuda.empty_cache()
    return err, tc, cc


#: the §4.1 limits.  On the H100 the sound run read a relative inertia
#: difference of 0 and 0.999647 of assignments equal (the two M-steps sum
#: in different orders, so a few boundary points go the other way over 20
#: iterations), and one M-step's Allreduce from the same assignments gave
#: the centralized counts exactly (integers below 2^24 in f32) and its
#: centroids within 1.1e-5.  The planted control, one site left out of the
#: Allreduce, read 7.4e-3, 0.9796, 978 counts differing and 0.081.
IDENTITY_RTOL, IDENTITY_SAME, IDENTITY_CENTROID_ATOL = 1e-6, 0.999, 1e-4


def identity_readings(torch, clustering, Xs, res, central):
    """The §4.1 readings of one ``distributed_kmeans`` result against the
    centralized run ``central`` = (centroids, assignments, inertia): the
    relative inertia difference, the share of equal assignments, and one
    M-step from ``res``'s assignments through ``clustering.node_stats``
    (the Allreduce) against the centralized one-hot product on the union:
    clusters whose count differs, and the centroids' max |Δ|."""
    C_c, a_c, inertia_c = central
    Xall = Xs.reshape(-1, Xs.shape[-1])
    sums, counts = clustering.node_stats(Xs, res.assignments, res.centroids.shape[0])
    mean_c, counts_c = clustering._m_step(Xall, res.assignments, res.centroids.shape[0], "l2sq")
    mean_d = sums / torch.clamp_min(counts, 1.0)[:, None]
    kept = counts_c > 0
    return {
        "inertia": float(res.inertia), "inertia_centralized": inertia_c,
        "inertia_rel": abs(float(res.inertia) - inertia_c) / inertia_c,
        "assignments_equal": float((res.assignments == a_c).float().mean()),
        "centroids_max_abs_diff": float((res.centroids - C_c).abs().max()),
        "mstep_counts_differ": int((counts != counts_c).sum()),
        "mstep_centroids_max_abs_diff": float((mean_d - mean_c)[kept].abs().max()),
    }


def identity_holds(r) -> bool:
    return (r["inertia_rel"] <= IDENTITY_RTOL and r["assignments_equal"] >= IDENTITY_SAME
            and r["mstep_counts_differ"] == 0
            and r["mstep_centroids_max_abs_diff"] <= IDENTITY_CENTROID_ATOL)


def kmeans_phase(torch, Xs, C0):
    """The main path: ``distributed_kmeans`` at the KDD Cup 1999 shape, its
    final launch against the plain version, the §4.1 identity against
    centralized k-means on the union with a planted faulty Allreduce as its
    control, and where an EM iteration's time goes."""
    from repro_torch import kernels
    from repro_torch.kernels.pdist_argmin import kernel as pdk
    from repro_torch.ml import clustering

    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on")
    Xall = Xs.reshape(-1, KDD_D)
    inertia0 = float(clustering.nearest(Xall, C0, "l2sq")[1].sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # each E-step's count of rows the guard re-checked, kept on the card
    # and read after the run
    rechecks, sound_l2_tc = [], pdk.nearest_l2_tc

    def recording_l2_tc(X_, C_):
        out = sound_l2_tc(X_, C_)
        rechecks.append(out[2])
        return out

    pdk.nearest_l2_tc = recording_l2_tc
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        res = clustering.distributed_kmeans(Xs, C0, num_clusters=KDD_K, iters=KDD_ITERS)
        torch.cuda.synchronize()
    finally:
        pdk.nearest_l2_tc = sound_l2_tc
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # l2sq takes the tensor-core route: one launch an E-step, none of the
    # CUDA-core kernel
    want = {n: (KDD_ITERS + 1 if n == "pdist_argmin_tc" else 0) for n in kernels.KERNEL_NAMES}
    check(launches == want, f"distributed_kmeans launches {launches}, expected {want}")
    rechecked = [int(r) for r in rechecks]
    check(len(rechecked) == KDD_ITERS + 1, f"{len(rechecked)} E-steps recorded")
    print(f"distributed_kmeans: rows the guard re-checked in each of the {KDD_ITERS + 1} "
          f"E-steps (of {Xall.shape[0]}): {rechecked}; share {min(rechecked) / Xall.shape[0]:.6f}"
          f"–{max(rechecked) / Xall.shape[0]:.6f}", flush=True)
    inertia = float(res.inertia)
    check(bool(torch.isfinite(res.centroids).all()) and res.centroids.shape == (KDD_K, KDD_D),
          "centroids not finite of shape (1000, 42)")
    check(res.assignments.shape == (Xall.shape[0],), "assignments shape")
    check(inertia < inertia0, f"inertia {inertia} not below C0's {inertia0}")

    # where an iteration goes: the E-step and the M-step apart, on CUDA events
    def events(fn, reps=3):
        out = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        return statistics.median(out)

    assign = res.assignments
    # the main path's launches against the plain version: the E-step again
    # on the final centroids must give the final assignment and inertia
    # bit for bit, and its first and last PDIST_CHUNK rows agree with
    # pdist_argmin_ref
    i_full, d_full = clustering.nearest(Xall, res.centroids, "l2sq")
    check(torch.equal(i_full, assign) and float(d_full.sum()) == inertia,
          "the E-step on the final centroids differs from distributed_kmeans' last one")
    rows = torch.cat([torch.arange(PDIST_CHUNK, device="cuda"),
                      torch.arange(Xall.shape[0] - PDIST_CHUNK, Xall.shape[0], device="cuda")])
    full_err, clear, n = pdist_compare(torch, Xall[rows], res.centroids, "l2",
                                       out=(i_full[rows], d_full[rows]))
    print(f"pdist check of the main path's final launch (rows 0..{PDIST_CHUNK} and the last "
          f"{PDIST_CHUNK}, final centroids): max |kernel − plain| {full_err:.4g}, index "
          f"compared on {clear}/{n} points", flush=True)
    del i_full, d_full
    e_ms = events(lambda: clustering.nearest(Xall, res.centroids, "l2sq"))
    m_ms = events(lambda: clustering.node_stats(Xs, assign, KDD_K))
    # wall = iters × (E + M + host) + one final E-step
    it_ms = (wall * 1e3 - e_ms) / KDD_ITERS
    empty = int((torch.bincount(assign, minlength=KDD_K) == 0).sum())
    print(f"distributed_kmeans {SITES} sites × {SITE_N} × {KDD_D}, K {KDD_K}, {KDD_ITERS} "
          f"iterations: {wall:.4f} s, {it_ms:.4f} ms an iteration (host clock, the final "
          f"assignment taken out); E-step {e_ms:.4f} ms, M-step {m_ms:.4f} ms (CUDA events, "
          f"timed apart), the rest {it_ms - e_ms - m_ms:.4f} ms; inertia {inertia0:.6g} -> "
          f"{inertia:.6g}; {empty} clusters empty at the end; peak memory "
          f"{peak / 2**30:.3f} GiB; launches {launches}", flush=True)

    # device busy time of three iterations from the profiler, against wall
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clustering.distributed_kmeans(Xs, C0, num_clusters=KDD_K, iters=3)
        torch.cuda.synchronize()
        p_wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e3
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:5]
    idle = f"idle share {1 - busy / p_wall:.4f}" if busy > 0 else "idle share not measured"
    print(f"profiled distributed_kmeans (3 iterations + final): wall {p_wall:.4f} ms, device "
          f"busy {busy:.4f} ms, {idle}; top kernels "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms" for e in top),
          flush=True)

    # §4.1: the sufficient-statistics Allreduce is centralized k-means on the
    # union.  The centralized loop keeps an empty cluster's centroid, as
    # distributed_kmeans does (the JAX package's kmeans() sends an empty
    # cluster to the origin, so it leaves this trajectory at the first empty
    # cluster; 21 of the 1,000 are empty here).
    t0 = time.perf_counter()
    C = C0
    for _ in range(KDD_ITERS):
        a, _ = clustering.nearest(Xall, C, "l2sq")
        C_new, counts = clustering._m_step(Xall, a, KDD_K, "l2sq")
        C = torch.where(counts[:, None] > 0, C_new, C)
    a, d = clustering.nearest(Xall, C, "l2sq")
    torch.cuda.synchronize()
    c_wall = time.perf_counter() - t0
    central = (C, a, float(d.sum()))
    del C_new, counts, d
    sound = identity_readings(torch, clustering, Xs, res, central)
    print(f"§4.1 identity: centralized k-means on the union ({c_wall:.4f} s); "
          f"distributed_kmeans: {sound}", flush=True)
    check(identity_holds(sound), f"§4.1 identity fails: {sound}")

    # the planted control: an Allreduce that leaves the last site out must
    # fail the same check, or the check cannot see a faulty Allreduce
    sound_node_stats = clustering.node_stats

    def without_last_site(Xs_, assign_, K_):
        return sound_node_stats(Xs_[:-1], assign_[:-Xs_.shape[1]], K_)

    clustering.node_stats = without_last_site
    try:
        bad = clustering.distributed_kmeans(Xs, C0, num_clusters=KDD_K, iters=KDD_ITERS)
        planted = identity_readings(torch, clustering, Xs, bad, central)
    finally:
        clustering.node_stats = sound_node_stats
    print(f"§4.1 planted control (Allreduce without site {SITES - 1}): {planted}", flush=True)
    check(not identity_holds(planted), f"§4.1 check passes a faulty Allreduce: {planted}")
    del bad, central, a, C
    torch.cuda.empty_cache()
    return launches["pdist_argmin_tc"], full_err, {
        "iteration_ms": it_ms, "estep_ms": e_ms, "mstep_ms": m_ms, "peak_gib": peak / 2**30,
        "idle_share": 1 - busy / p_wall if busy > 0 else None,
        "rechecked_share_max": max(rechecked) / Xall.shape[0]}


def family_phase(torch):
    """The rest of the family at a reduced size (16 sites × 20,000 × 42):
    k-windows through ``fit``, consensus and centralized k-means, k-means++
    seeding."""
    from repro_torch import api, kernels
    from repro_torch.core import schedules
    from repro_torch.ml import clustering, kwindows

    Xs, _ = make_kdd_shaped(torch, 1, n_per_site=SMALL_N)
    W = 32
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = api.fit(kwindows.KWindowsStrategy(0, num_windows=W, r=3.0), Xs,
                  transport="sequential_server", schedule=schedules.round_robin(SITES, 1),
                  device="cuda")
    torch.cuda.synchronize()
    kw_s = time.perf_counter() - t0
    pool = SITES * W
    # the JAX package's price: each contact pushes the pooled window set and
    # is handed it back (dense), centers and halfwidths (pool, d) and alive
    # and counts (pool,), f32
    per_contact = pool * (2 * KDD_D + 2) * 4
    check(res.ledger.uplink_bytes == SITES * per_contact
          and res.ledger.downlink_bytes == SITES * per_contact,
          f"k-windows ledger {res.ledger.summary()} != {SITES} × {per_contact} each way")
    check(sum(kernels.LAUNCHES.values()) == 0, "k-windows launched a kernel")
    alive = int(res.theta.alive.sum())
    check(0 < alive <= pool and bool(torch.isfinite(res.theta.centers).all()),
          f"k-windows: {alive} windows alive")
    captured = float((kwindows.assign_points(Xs[0], res.theta) >= 0).float().mean())
    print(f"k-windows fit ({SITES} sites × {SMALL_N} × {KDD_D}, {W} windows a site): "
          f"{kw_s:.4f} s, {alive} windows after the server merge, {captured:.4f} of site 0 "
          f"captured; ledger {res.ledger.summary()}", flush=True)

    Kc, iters, em = 32, 10, 3
    Xall = Xs.reshape(-1, KDD_D)
    gen = torch.Generator(device="cuda").manual_seed(3)
    C0 = Xall[torch.randperm(Xall.shape[0], generator=gen, device="cuda")[:Kc]].clone()
    kernels.reset_launches()
    t0 = time.perf_counter()
    C, admm = clustering.consensus_kmeans(Xs, C0, iters=iters, local_em_iters=em)
    torch.cuda.synchronize()
    ck_s = time.perf_counter() - t0
    check(kernels.LAUNCHES["pdist_argmin_tc"] == iters * SITES * em,
          f"consensus_kmeans launches {kernels.LAUNCHES['pdist_argmin_tc']} != "
          f"{iters} × {SITES} × {em}")
    check(bool(torch.isfinite(C).all()) and C.shape == (Kc, KDD_D), "consensus centroids")
    print(f"consensus_kmeans K {Kc}, {iters} ADMM iterations × {em} local EM steps: "
          f"{ck_s:.4f} s, {kernels.LAUNCHES['pdist_argmin_tc']} kernel launches, residuals "
          f"{admm.history[-1].tolist()}", flush=True)

    # centralized kmeans as the JAX package defines it: l2 (argmin over
    # square roots), an empty cluster sent to the origin
    kernels.reset_launches()
    t0 = time.perf_counter()
    km = clustering.kmeans(Xall, C0, num_clusters=Kc, metric="l2", iters=iters)
    torch.cuda.synchronize()
    km_s = time.perf_counter() - t0
    check(kernels.LAUNCHES["pdist_argmin_tc"] == iters + 1, "kmeans launches")
    km0 = float(clustering.nearest(Xall, C0, "l2sq")[1].sum())
    check(bool(torch.isfinite(km.centroids).all()) and float(km.inertia) < km0,
          f"kmeans inertia {float(km.inertia)} not below C0's {km0}")
    print(f"kmeans K {Kc}, {iters} iterations on the union ({SITES * SMALL_N} points): "
          f"{km_s:.4f} s, {iters + 1} launches; inertia {km0:.6g} -> {float(km.inertia):.6g}",
          flush=True)

    kernels.reset_launches()
    t0 = time.perf_counter()
    Cpp = clustering.kmeans_pp_init(torch.Generator(device="cuda").manual_seed(4), Xs[0], KDD_K)
    torch.cuda.synchronize()
    pp_s = time.perf_counter() - t0
    check(kernels.LAUNCHES["pdist_argmin_tc"] == KDD_K - 1, "kmeans_pp_init launches")
    check(bool((clustering.nearest(Cpp, Xs[0], "l2sq")[1] == 0).all()),
          "kmeans++ centers are not data points")
    rand = Xs[0][torch.randperm(SMALL_N, generator=gen, device="cuda")[:KDD_K]]
    i_pp = float(clustering.nearest(Xs[0], Cpp, "l2sq")[1].sum())
    i_rand = float(clustering.nearest(Xs[0], rand, "l2sq")[1].sum())
    check(i_pp < i_rand, f"kmeans++ inertia {i_pp} not below random rows' {i_rand}")
    print(f"kmeans_pp_init K {KDD_K} on one site ({SMALL_N} points): {pp_s:.4f} s, "
          f"{KDD_K - 1} launches; inertia {i_pp:.6g} vs {i_rand:.6g} for random rows",
          flush=True)

    # kmeans under l1 and l∞, as the JAX package's kmeans takes them: the
    # CUDA-core route's path (each E-step one launch of it; the inertia,
    # squared l2, one launch of the tensor-core route)
    kernels.reset_launches()
    t0 = time.perf_counter()
    kms = {m: clustering.kmeans(Xall, C0, num_clusters=Kc, metric=m, iters=iters)
           for m in ("l1", "linf")}
    torch.cuda.synchronize()
    kml_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = {n: {"pdist_argmin": 2 * (iters + 1), "pdist_argmin_tc": 2}.get(n, 0)
            for n in kernels.KERNEL_NAMES}
    check(launches == want, f"kmeans l1 + linf launches {launches}, expected {want}")
    for m, r in kms.items():
        obj0 = float(clustering.nearest(Xall, C0, m)[1].sum())
        obj = float(clustering.nearest(Xall, r.centroids, m)[1].sum())
        check(bool(torch.isfinite(r.centroids).all()) and r.centroids.shape == (Kc, KDD_D)
              and obj < obj0, f"kmeans {m}: objective {obj} not below C0's {obj0}")
        print(f"kmeans K {Kc}, {iters} iterations, metric {m}: objective (sum of {m} "
              f"distances) {obj0:.6g} -> {obj:.6g}", flush=True)
    print(f"kmeans l1 + linf: {kml_s:.4f} s, launches {launches}", flush=True)
    del Xs
    torch.cuda.empty_cache()
    return launches["pdist_argmin"]


# ----------------------------------------------------------------------------
# Cache-free attention and the approximate top-k: flash attention, count, mask
# ----------------------------------------------------------------------------

#: (B, T, S, Hq, Hkv, D, causal, window, q_offset): the five shapes of
#: tests/test_kernels_flash.py (padding, window, bidirectional among them),
#: a query offset with T < S, a window that leaves rows with no key,
#: D 8, a ragged S with a bidirectional window, tinyllama-1.1b's heads at
#: B 8 × T 2048 and qwen2-1.5b's at B 2 × T 4096; then head widths past the
#: first kernels' list, causal, windowed and with a query offset (D 24, 40,
#: 80, 96, 192, 256, and D 36, which the wrapper pads to 40), and Gemma-2B's
#: 8 / 1 heads of D 256 at B 8 × T 2048
FLASH_GEMMA = (8, 2048, 2048, 8, 1, 256, True, 0, 0)
FLASH_SHAPES = [
    (2, 64, 64, 4, 2, 32, True, 0, 0), (1, 128, 128, 8, 8, 64, True, 0, 0),
    (2, 96, 96, 4, 1, 16, True, 0, 0), (2, 64, 64, 8, 2, 32, True, 24, 0),
    (1, 48, 48, 4, 4, 64, False, 0, 0), (2, 40, 100, 4, 2, 32, True, 0, 60),
    (2, 64, 64, 4, 2, 32, True, 8, 40), (1, 70, 70, 2, 1, 8, True, 0, 0),
    (2, 200, 131, 6, 3, 16, False, 50, 0),
    (8, 2048, 2048, 32, 4, 64, True, 0, 0), (2, 4096, 4096, 12, 2, 128, True, 0, 0),
    (2, 300, 300, 4, 2, 24, True, 0, 0), (2, 200, 300, 6, 3, 40, True, 64, 100),
    (1, 500, 500, 8, 2, 80, True, 128, 0), (2, 256, 256, 4, 4, 96, True, 0, 0),
    (1, 300, 400, 4, 2, 192, True, 0, 100), (2, 300, 300, 8, 1, 256, True, 100, 0),
    (1, 200, 320, 8, 1, 256, True, 0, 120), (2, 150, 150, 4, 2, 36, True, 0, 0),
    FLASH_GEMMA,
]
FLASH_MAIN = (8, 2048, 2048, 32, 4, 64, True, 0, 0)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # tests/test_kernels_flash.py:41,54
ATTN_B, ATTN_T = 8, 2048  # the attention path's prompt batch
ATTN_TOL = 3e-2  # max |Δ| of attn_apply outputs in bf16, the JAX package's bf16 limit
#: max over rows of ||Δ|| / ||y_plain|| in bf16: twice the 0.41 % read on an
#: H100 (NVIDIA H100 80GB HBM3, 700 W); the planted control's rows read >= 1.07 %
ATTN_REL_TOL = 8e-3
ATTN_TOL_F32 = 2e-5  # max |Δ| with f32 compute, the JAX package's f32 limit


def flash_bound(shape, itemsize: int, rate: float):
    """(ms, by, ops, bytes) for causal or dense attention at ``shape``: 4 D
    operations per visible (query, key) pair and head, or q, k, v and the
    output once, whichever takes longer."""
    B, T, S, Hq, Hkv, D, causal, _, _ = shape
    pairs = T * (T + 1) // 2 if causal and T == S else T * S
    ops = 4 * B * Hq * D * pairs
    nbytes = (2 * B * T * Hq * D + 2 * B * S * Hkv * D) * itemsize
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations", ops, nbytes) if t_ops >= t_bytes else (
        t_bytes, "bytes", ops, nbytes)


FLASH_QWEN = (2, 4096, 4096, 12, 2, 128, True, 0, 0)  # qwen2-1.5b's heads


def flash_kernel_phase(torch):
    """Each flash route against its plain version (``attention_ref``) at
    every shape, f32 through the 3xTF32 kernel (its prep bitwise
    ``tf32_image_ref``) and bf16 through the bf16 tensor-core kernel
    (``kernel.ROUTES``), bq/bk independence, then times in turns with SDPA
    at tinyllama-1.1b's and qwen2-1.5b's heads, in bf16 and in f32."""
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.kernels._heads import pad_heads, padded_width
    from repro_torch.kernels.flash_attention import kernel as fak, ops as fao, ref as far

    # the f32 references and SDPA's f32 timings in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.backends.cudnn.allow_tf32 is False, "TF32 is on for the f32 references")
    print("flash routes: " + ", ".join(f"{str(dt)[6:]} -> {name}"
                                       for dt, name in fak.ROUTES.items()), flush=True)
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(5)
    err = {name: 0.0 for name in fak.ROUTES.values()}
    err["flash_attention_tf32_prep"] = 0.0  # bitwise: stays 0
    err_bf16p, checked = 0.0, 0
    for shape in FLASH_SHAPES:
        B, T, S, Hq, Hkv, D, causal, window, q_offset = shape
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        for dtype in (torch.float32, torch.bfloat16):
            name = fak.route(dtype)
            q = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(dtype)
            k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
            v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
            before = dict(kernels.LAUNCHES)
            pads = kernels.PADS["flash_attention"]
            out = fao.flash_attention(q, k, v, **kw)  # pads a D that is no multiple of 8
            prep = int(dtype == torch.float32)  # the f32 route's prep launch
            check(kernels.LAUNCHES[name] == before[name] + 1
                  and kernels.LAUNCHES["flash_attention_tf32_prep"]
                  == before["flash_attention_tf32_prep"] + prep
                  and sum(kernels.LAUNCHES.values()) == sum(before.values()) + 1 + prep,
                  f"flash {dtype} did not launch {name} once")
            check(kernels.PADS["flash_attention"] == pads + int(padded_width(D) != D),
                  f"flash pad count at {shape}")
            plain = tr(far.attention_ref(tr(q), tr(k), tr(v), **kw))
            torch.cuda.synchronize()
            check(out.shape == q.shape and out.dtype == dtype, f"flash out at {shape}")
            check(bool(torch.isfinite(out).all()), f"flash non-finite at {shape} {dtype}")
            e = float((out.float() - plain.float()).abs().max())
            tol = FLASH_TOL[str(dtype).split(".")[1]]
            check(e <= tol, f"flash attention {shape} {dtype}: |kernel − plain| {e} > {tol}")
            dead = (plain.float() == 0).all(dim=-1)
            check(bool((out[dead] == 0).all()), f"flash: a row with no key is not 0 at {shape}")
            extra = ""
            if dtype == torch.bfloat16:  # and the kernel's own arithmetic (P in bf16)
                e_p = float((out.float() - tr(far.attention_bf16p(tr(q), tr(k), tr(v), **kw))
                             .float()).abs().max())
                check(e_p <= tol, f"flash tc {shape}: |kernel − attention_bf16p| {e_p} > {tol}")
                err_bf16p = max(err_bf16p, e_p)
                extra = f", against attention_bf16p {e_p:.3g}"
            else:  # the prep kernel against its plain version, bitwise
                kp, vp = (pad_heads(x, padded_width(D)) for x in (k, v))
                img, img_ref = fak.tf32_image(kp, vp), far.tf32_image_ref(kp, vp)
                check(torch.equal(img.view(torch.int32), img_ref.view(torch.int32)),
                      f"flash tf32 prep at {shape}: not bitwise tf32_image_ref")
                extra = f", prep image bitwise tf32_image_ref ({img.numel() * 4} bytes)"
                del img, img_ref, kp, vp
            err[name] = max(err[name], e)
            checked += 1
            print(f"flash check {shape} {str(dtype)[6:]} ({name}): max |kernel − plain| "
                  f"{e:.3g}{extra}, {int(dead.sum())} (row, head) pairs see no key", flush=True)
            del q, k, v, out, plain
    torch.cuda.empty_cache()
    print(f"flash phase: {checked} comparisons within 2e-5 (f32) / 3e-2 (bf16)", flush=True)

    timings = {}
    for label, shape in (("main", FLASH_MAIN), ("qwen2-1.5b", FLASH_QWEN),
                         ("gemma-2b", FLASH_GEMMA)):
        B, T, S, Hq, Hkv, D = shape[:6]
        q = torch.randn((B, T, Hq, D), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").bfloat16()
        if label == "main":  # bq/bk change nothing
            check(torch.equal(fao.flash_attention(q, k, v, bq=128, bk=128),
                              fao.flash_attention(q, k, v, bq=64, bk=32)),
                  "flash: the result depends on bq/bk")
            print("flash bq/bk: (128, 128) and (64, 32) bitwise equal at the tinyllama shape",
                  flush=True)
        qt, kt, vt = tr(q), tr(k), tr(v)
        t = turns_ms(torch, {
            "library": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            "tensor_cores": lambda: fak.flash_attention(q, k, v),
        }, inner=2, rounds=3)
        b_ms, b_by, ops, nbytes = flash_bound(shape, 2, BF16_OPS_PER_S)
        timings[("flash_attention_tc", label)] = {
            "ms": t["tensor_cores"]["median"], "ms_runs": t["tensor_cores"],
            "library_ms": t["library"]["median"], "library_runs": t["library"],
            "plain_ms": graph_ms(torch, lambda: far.attention_bf16p(qt, kt, vt),
                                 inner=1, reps=3),
            "bound_ms": b_ms, "bound_by": b_by, "ops": ops, "bytes": nbytes,
            "tflops": ops / (t["tensor_cores"]["median"] * 1e-3) / 1e12,
            "shape": list(shape), "dtype": "bfloat16",
        }
        print(f"time flash_attention_tc {label} {shape[:6]} bf16 causal (in turns with SDPA): "
              f"{timings[('flash_attention_tc', label)]}", flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

        # the f32 route at the same shape: the 3xTF32 kernel alone (on a
        # prepared image), prep + kernel, and f32 SDPA, in turns
        q = torch.randn((B, T, Hq, D), generator=gen, device="cuda")
        k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda")
        v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda")
        qt, kt, vt = tr(q), tr(k), tr(v)
        image = fak.tf32_image(k, v)
        t = turns_ms(torch, {
            "library": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            "kernel": lambda: fak.tf32_attend(q, image, S, Hkv),
            "prep + kernel": lambda: fak.flash_attention(q, k, v),
        }, inner=1, rounds=3)
        b_ms, b_by, ops, nbytes = flash_bound(shape, 4, TF32_OPS_PER_S / 3)
        f32_ms = flash_bound(shape, 4, F32_OPS_PER_S)[0]
        timings[("flash_attention_tf32", label)] = {
            "ms": t["kernel"]["median"], "ms_runs": t["kernel"],
            "route_ms": t["prep + kernel"]["median"], "route_runs": t["prep + kernel"],
            "library_ms": t["library"]["median"], "library_runs": t["library"],
            "plain_ms": graph_ms(torch, lambda: far.attention_ref(qt, kt, vt), inner=1, reps=3),
            "bound_ms": b_ms, "bound_by": b_by, "bound_f32_cuda_cores_ms": f32_ms,
            "ops": ops, "ops_3xtf32": 3 * ops, "bytes": nbytes,
            "tflops": ops / (t["kernel"]["median"] * 1e-3) / 1e12,
            "earlier_ms_recorded": EARLIER_FLASH_F32_MS.get(label),
            "earlier": "the f32 CUDA-core kernel this one replaced, timed in turns with it",
            "shape": list(shape), "dtype": "float32",
        }
        # the prep alone: k and v read once, the image written once
        p_bytes = 2 * k.numel() * 4 + image.numel() * 4
        timings[("flash_attention_tf32_prep", label)] = {
            "ms": graph_ms(torch, lambda: fak.tf32_image(k, v), inner=5, reps=10),
            "plain_ms": graph_ms(torch, lambda: far.tf32_image_ref(k, v), inner=1, reps=3),
            "library_ms": None, "bound_ms": p_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": p_bytes, "shape": [B, S, Hkv, D],
        }
        for name in ("flash_attention_tf32", "flash_attention_tf32_prep"):
            print(f"time {name} {label} {shape[:6]} f32 causal (the kernel in turns with "
                  f"f32 SDPA): {timings[(name, label)]}", flush=True)
        del q, k, v, qt, kt, vt, image
        torch.cuda.empty_cache()
    err["flash_attention_tc_vs_bf16p"] = err_bf16p
    return err, timings


def row_errors(torch, y, ref):
    """Per (b, t) row of two (B, T, d) outputs: max |y − ref| and
    ||y − ref|| / ||ref||, in f32."""
    d = y.float() - ref.float()
    return d.abs().amax(dim=-1), d.norm(dim=-1) / ref.float().norm(dim=-1).clamp_min(1e-30)


def kernel_path_bytes(cfg) -> int:
    """The most memory one kernel-path ``attn_apply`` call at B ``ATTN_B`` ×
    T ``ATTN_T`` may add: its q, k, v, attention output and layer output
    (rows of Hq·D, Hkv·D, Hkv·D, Hq·D and d_model) in f32, twice over for
    the temporaries the projections and RoPE make beside them, and no
    (T, S) logits."""
    width = 2 * (cfg.num_heads + cfg.num_kv_heads) * cfg.head_dim + cfg.d_model
    return 2 * ATTN_B * ATTN_T * width * 4


def attention_path_phase(torch, cfg=None):
    """The main path of this slice: ``attn_apply(use_kernel=True)`` for each
    of tinyllama-1.1b's 22 layers (or of ``cfg``'s) at full width on a B 8 ×
    T 2048 batch of embedded, RMS-normed prompt tokens; each output held
    against the plain ``_sdpa`` and ``_sdpa_q_chunked`` (attn_q_chunk 512).

    In bf16 each output row is held to max |Δ| <= 3e-2 and ||Δ|| / ||y||
    <= 8e-3: late rows are small (rms ≈ 0.06) and a kernel that lost a key
    there moves them by ≈ 1/sqrt(keys seen) relative, 1–3 %, far under 3e-2
    absolute.  The path then runs again with f32 compute, held at 2e-5.  A
    planted control (the kernel with ``q_offset=-1``: every query loses the
    key at its own position) must fail both checks in nearly every row of
    the prompt's second half, at the first and the last layer.
    Returns the kernel's launches on the bf16 run and the FFN leaf the top-k
    phase sparsifies."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention as attn, layers, transformer as tf
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.backends.cudnn.allow_tf32 is False, "TF32 is on for the plain paths")
    cfg = cfg or get_config(SERVE_ARCH)
    L = cfg.num_layers
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    W = tf.compute_params(params, cfg)
    leaf = params["seg0"]["l0"]["ffn"]["w_gate"]["kernel"]  # (22, 2048, 5632) f32
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(ATTN_B, ATTN_T))
    ids = torch.from_numpy(tokens).cuda()
    h = layers.embed(W["embed"], ids, compute_dtype=torch.bfloat16)
    pos = torch.arange(ATTN_T, device="cuda").expand(ATTN_B, ATTN_T)
    chunked = cfg.replace(attn_q_chunk=512)
    paths = {
        "kernel": lambda p, x: attn.attn_apply(p, cfg, x, positions=pos, use_kernel=True)[0],
        "plain _sdpa": lambda p, x: attn.attn_apply(p, cfg, x, positions=pos)[0],
        "_sdpa_q_chunked": lambda p, x: attn.attn_apply(p, chunked, x, positions=pos)[0],
    }

    def layer_input(tree, h_, li):
        lp = tree_map(lambda a: a[li], tree["seg0"])["l0"]
        return lp["mixer"], layers.rmsnorm(lp["mixer_norm"], h_, eps=cfg.rms_eps)

    stats = {n: {"wall_ms": 0.0, "device_ms": 0.0, "peak_extra_gib": 0.0} for n in paths}
    err = {n: {"max_abs": 0.0, "max_row_rel": 0.0} for n in paths if n != "kernel"}
    y_rms, y_max = [], 0.0
    for fn in paths.values():  # first calls (cuBLAS handles, the kernel's attribute)
        fn(*layer_input(W, h, 0))
    torch.cuda.synchronize()
    kernels.reset_launches()
    for li in range(L):
        p, x = layer_input(W, h, li)
        ys = {}
        for name, fn in paths.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            ys[name] = fn(p, x)
            e1.record()
            torch.cuda.synchronize()
            s = stats[name]
            s["wall_ms"] += (time.perf_counter() - t0) * 1e3
            s["device_ms"] += e0.elapsed_time(e1)
            s["peak_extra_gib"] = max(s["peak_extra_gib"],
                                      (torch.cuda.max_memory_allocated() - base) / 2**30)
        y = ys["kernel"]
        check(y.shape == (ATTN_B, ATTN_T, cfg.d_model) and y.dtype == torch.bfloat16
              and bool(torch.isfinite(y).all()), f"layer {li}: kernel output")
        y_rms.append(float(y.float().pow(2).mean().sqrt()))
        y_max = max(y_max, float(y.float().abs().max()))
        for name, e in err.items():
            a, r = row_errors(torch, y, ys[name])
            e["max_abs"] = max(e["max_abs"], float(a.max()))
            e["max_row_rel"] = max(e["max_row_rel"], float(r.max()))
        del ys, y
    launches = dict(kernels.LAUNCHES)
    want = {n: (L if n == "flash_attention_tc" else 0) for n in kernels.KERNEL_NAMES}
    check(launches == want, f"attention path launches {launches}, expected {want}")
    logits_gib = ATTN_B * cfg.num_heads * ATTN_T * ATTN_T * 4 / 2**30
    print(f"attention path: {cfg.name} ({cfg.num_heads} × {cfg.head_dim} query heads, "
          f"{cfg.num_kv_heads} KV), {L} layers × attn_apply on B {ATTN_B} × T "
          f"{ATTN_T} (bf16, full width): {launches['flash_attention_tc']} tensor-core flash "
          f"launches; "
          f"kernel output rms {min(y_rms):.4g}–{max(y_rms):.4g} a layer, max |y| {y_max:.4g}; "
          f"kernel against the plain paths: {json.dumps(err)} (limits: max |Δ| {ATTN_TOL}, "
          f"max row ||Δ||/||y|| {ATTN_REL_TOL}); f32 logits of the plain path "
          f"{logits_gib:.3f} GiB", flush=True)
    print(f"attention path (sum over {L} layers; peak = most memory one call added):",
          json.dumps(stats), flush=True)

    # the same path with f32 compute (TF32 off), at the JAX package's f32 limit
    h32 = layers.embed(params["embed"], ids, compute_dtype=torch.float32)
    err32 = {n: 0.0 for n in err}
    dev32 = {n: 0.0 for n in paths}
    kernels.reset_launches()
    for li in range(L):
        p, x = layer_input(params, h32, li)
        ys = {}
        for name, fn in paths.items():
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            ys[name] = fn(p, x)
            e1.record()
            e1.synchronize()
            dev32[name] += e0.elapsed_time(e1)
        for name in err32:
            err32[name] = max(err32[name], float(row_errors(torch, ys["kernel"], ys[name])[0].max()))
        del ys
    launches32 = dict(kernels.LAUNCHES)
    want = {n: (L if n in ("flash_attention_tf32", "flash_attention_tf32_prep") else 0)
            for n in kernels.KERNEL_NAMES}
    check(launches32 == want, f"f32 attention path launches {launches32}, expected {want}")
    print(f"attention path, f32 compute, {L} layers: max |kernel − plain| {json.dumps(err32)} "
          f"(limit {ATTN_TOL_F32}); device ms summed over the {L} layers, f32 "
          f"{json.dumps(dev32)} against bf16 "
          f"{json.dumps({n: st['device_ms'] for n, st in stats.items()})}", flush=True)
    stats["f32_device_ms"] = dev32

    # planted control: each query loses its own key; the checks must see it
    class DropOwnKey:
        @staticmethod
        def flash_attention(q, k, v, **kw):
            return fa_ops.flash_attention(q, k, v, q_offset=-1, **kw)

    late = slice(ATTN_T // 2, None)
    control = {}
    attn.fa_ops = DropOwnKey
    try:
        for tree, h_, tag in ((W, h, "bf16"), (params, h32, "f32")):
            caught = []
            for li in (0, L - 1):
                p, x = layer_input(tree, h_, li)
                a, r = row_errors(torch, paths["kernel"](p, x), paths["plain _sdpa"](p, x))
                a, r = a[:, late], r[:, late]
                hit = (a > ATTN_TOL_F32) if tag == "f32" else (r > ATTN_REL_TOL) | (a > ATTN_TOL)
                caught.append(float(hit.float().mean()))
                control[f"{tag} layer {li}"] = {
                    "caught_share": caught[-1], "min_row_rel": float(r.min()),
                    "median_row_rel": float(r.median()), "min_abs": float(a.min())}
    finally:
        attn.fa_ops = fa_ops
    print(f"attention path, planted control (q_offset=-1: each query loses its own key), "
          f"rows t >= {ATTN_T // 2}: {json.dumps(control)}", flush=True)

    for name, e in err.items():
        check(e["max_abs"] <= ATTN_TOL, f"|kernel − {name}| {e['max_abs']} > {ATTN_TOL}")
        check(e["max_row_rel"] <= ATTN_REL_TOL,
              f"row ||kernel − {name}|| / ||y|| {e['max_row_rel']} > {ATTN_REL_TOL}")
        check(err32[name] <= ATTN_TOL_F32, f"f32 |kernel − {name}| {err32[name]} > {ATTN_TOL_F32}")
    for key, c in control.items():
        check(c["caught_share"] >= 0.99, f"the planted control passed the check ({key}): {c}")
    check(stats["plain _sdpa"]["peak_extra_gib"] >= logits_gib,
          f"the plain path did not hold its {logits_gib:.2f} GiB of logits")
    # the kernel path holds no logits: it stays under what its activations
    # take, itself under the logits, so a path that held them would fail
    act_gib = kernel_path_bytes(cfg) / 2**30
    check(act_gib < logits_gib, f"the activation limit {act_gib:.3f} GiB does not "
          f"separate the kernel path from {logits_gib:.3f} GiB of logits")
    check(stats["kernel"]["peak_extra_gib"] < act_gib,
          f"the kernel path holds {stats['kernel']['peak_extra_gib']:.3f} GiB, over the "
          f"{act_gib:.3f} GiB of its activations")
    del W, params, h, h32
    torch.cuda.empty_cache()
    err["f32_max_abs"] = err32
    return ({"flash_attention_tc": launches["flash_attention_tc"],
             "flash_attention_tf32": launches32["flash_attention_tf32"],
             "flash_attention_tf32_prep": launches32["flash_attention_tf32_prep"]},
            err, stats, leaf, control)


#: sizes of tests/test_kernels_topk.py:10, 2^24, and the largest leaf
TOPK_SIZES = [(4096,), (128, 300), (10000,), (8192,), (513,), (1 << 24,)]
TOPK_F_LEAF = 0.01
#: sizes of the count's edge cases
TOPK_EDGE_SIZES = [1, 7, 513, 4099, (1 << 20) + 3, 1 << 24]


def count_edge_inputs(torch, n, dtype, offset, gen):
    """x (n elements of ``dtype``, ``offset`` elements past a 16-byte
    boundary) with NaN of either sign, ±inf, −0.0 and +0.0 among them, and
    128 unsorted thresholds with duplicates, NaN of either sign, values
    <= 0, −0.0, ±inf and exact element magnitudes among them."""
    base = torch.randn((n + offset,), generator=gen, device="cuda").to(dtype)
    x = base[offset:]
    special = [nan_of(torch, False), nan_of(torch, True), float("inf"), float("-inf"),
               -0.0, 0.0]
    for i, v in enumerate(special[:n]):
        x[(i * 7919) % n] = v
    t = torch.rand((128,), generator=gen, device="cuda") * 3.0
    t[10:30] = t[30:50].clone()
    t[50], t[51], t[52], t[53] = nan_of(torch, False), nan_of(torch, True), -1.0, 0.0
    t[54], t[55], t[56] = -0.0, float("inf"), float("-inf")
    t[57:61] = x[torch.randint(0, n, (4,), generator=gen, device="cuda")].float().abs()
    return x, t[torch.randperm(128, generator=gen, device="cuda")].contiguous()


def topk_phase(torch, leaf):
    """``count_ge`` and ``apply_threshold`` against their plain versions,
    exactly, at the JAX test sizes, 2^24 and tinyllama-1.1b's largest leaf,
    f32 and bf16, unsorted thresholds with 0 among them; then
    ``topk_sparsify`` on the leaf at k = 1 %, and times."""
    from repro_torch import kernels
    from repro_torch.kernels.topk_compress import kernel as tkk, ops as tko, ref as tkr

    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(6)
    err = {"topk_count": 0, "topk_mask": 0.0}
    for shape in TOPK_SIZES + ["leaf"]:
        for dtype in (torch.float32, torch.bfloat16):
            if shape == "leaf":
                x = leaf.to(dtype)
            else:
                x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            top = float(x.abs().max())
            t = torch.rand((tkr.NCAND,), generator=gen, device="cuda") * top
            t[3], t[50] = 0.0, float(x.reshape(-1)[7].abs())
            t = t[torch.randperm(tkr.NCAND, generator=gen, device="cuda")].contiguous()
            counts = tkk.count_ge(x, t)
            plain = tkr.count_ge_ref(x, t)
            torch.cuda.synchronize()
            err["topk_count"] = max(err["topk_count"], int((counts - plain).abs().max()))
            check(torch.equal(counts, plain), f"topk count differs at {shape} {dtype}")
            check(int(counts[t == 0].min()) == x.numel(), f"t = 0 count at {shape}")
            bits = torch.int32 if dtype == torch.float32 else torch.int16
            # four thresholds, and the first again on a view that is not on 16 bytes
            for j, xj in ((0, x), (3, x), (50, x), (int(t.argmax()), x),
                          (0, x.reshape(-1)[1:])):
                o = tkk.apply_threshold(xj, t[j:j + 1].clone())
                o_r = tkr.apply_threshold_ref(xj, t[j:j + 1])
                torch.cuda.synchronize()
                err["topk_mask"] = max(err["topk_mask"], float((o.float() - o_r.float()).abs().max()))
                check(torch.equal(o.view(bits), o_r.view(bits)),
                      f"topk mask differs at {shape} {dtype}, t = {float(t[j])}")
            del o, o_r
            print(f"topk check {shape} {str(dtype)[6:]} ({x.numel()} elements): counts "
                  f"equal (largest {int(counts.max())}), 5 masks bitwise (one of them at an "
                  f"offset of one element)", flush=True)
            del x
    # the count's edge cases: NaN of either sign, ±inf and ±0.0 among the
    # elements; thresholds with duplicates, NaN of either sign, values <= 0,
    # −0.0 and ±inf; x at 0, 1 and 3 elements past a 16-byte boundary
    for n_edge in TOPK_EDGE_SIZES:
        for dtype in (torch.float32, torch.bfloat16):
            for offset in (0, 1, 3):
                x, t = count_edge_inputs(torch, n_edge, dtype, offset, gen)
                counts = tkk.count_ge(x, t)
                plain = tkr.count_ge_ref(x, t)
                torch.cuda.synchronize()
                err["topk_count"] = max(err["topk_count"], int((counts - plain).abs().max()))
                check(torch.equal(counts, plain),
                      f"topk count differs on the edge case n={n_edge} {dtype} offset {offset}")
            print(f"topk count edge cases n={n_edge} {str(dtype)[6:]}: equal at offsets "
                  f"0, 1, 3", flush=True)
    del x
    torch.cuda.empty_cache()

    # the function on the leaf, f32, k = 1 %: launches, result, peak memory
    x = leaf
    n = x.numel()
    k = int(round(TOPK_F_LEAF * n))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = tko.topk_sparsify(x, k)
    torch.cuda.synchronize()
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    launches = {"topk_count": kernels.LAUNCHES["topk_count"],
                "topk_mask": kernels.LAUNCHES["topk_mask"]}
    check(launches == {"topk_count": 3, "topk_mask": 1}, f"topk_sparsify launches {launches}")
    check(sum(kernels.LAUNCHES.values()) == 4, f"topk_sparsify launches {kernels.LAUNCHES}")
    kept = out != 0
    survivors = int(kept.sum())
    kept_min = float(x[kept].abs().min())
    dropped_max = float(x[~kept].abs().max())
    check(survivors >= k, f"topk_sparsify kept {survivors} < k = {k}")
    check(kept_min >= dropped_max, f"kept |x| {kept_min} below dropped {dropped_max}")
    check(torch.equal(out[kept], x[kept]), "topk_sparsify changed a kept value")
    exact_t = float(torch.topk(x.abs().flatten(), k).values[-1])
    print(f"topk_sparsify on the {tuple(x.shape)} FFN leaf ({n} f32), k = {k}: "
          f"{survivors} kept ({survivors - k} above k), kept |x| ≥ {kept_min:.8g} ≥ dropped "
          f"{dropped_max:.8g}; exact k-th |x| {exact_t:.8g}; launches {launches}; peak "
          f"device memory {peak_gib:.4f} GiB above the {held / 2**30:.4f} GiB held", flush=True)
    del out, kept

    # the bracket's top, max |x|: x.abs().max() (a full |x| temporary)
    # against the one-pass vector_norm that topk_sparsify uses
    brackets = {"x.abs().max()": lambda: x.abs().max(),
                "vector_norm(x, inf)": lambda: torch.linalg.vector_norm(x, float("inf"))}
    bracket = {}
    for name, fn in brackets.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        v = fn()
        torch.cuda.synchronize()
        bracket[name] = {"peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
                         "bits": int(v.view(torch.int32))}
    check(bracket["x.abs().max()"]["bits"] == bracket["vector_norm(x, inf)"]["bits"],
          f"the bracket's max |x| differs between the two forms: {bracket}")
    for name, tm in turns_ms(torch, brackets, inner=3).items():
        bracket[name].update(tm)
    print(f"max |x| of the leaf, in turns: {bracket}", flush=True)

    lo = torch.full((1,), exact_t, device="cuda")
    # one library call with the mask's function on f32: |x| > nextafter(t, 0)
    # is |x| >= t, and hardshrink writes +0.0 elsewhere (NaN aside; x has none)
    lam = float(torch.nextafter(lo, torch.zeros_like(lo)))
    check(torch.equal(tkk.apply_threshold(x, lo).view(torch.int32),
                      F.hardshrink(x, lam).view(torch.int32)),
          "hardshrink(x, nextafter(t, 0)) differs from the mask on the leaf")
    cand = torch.linspace(0.0, float(x.abs().max()), tkr.NCAND, device="cuda")
    # the candidates of topk_sparsify's second round: ~99 % of the elements
    # fall below them all (rank 0)
    cand2 = torch.linspace(exact_t * 0.99, exact_t * 1.01, tkr.NCAND, device="cuda")
    xb = x.to(torch.bfloat16)
    cnt_bytes = 4 * n + tkr.NCAND * (4 + 8)
    # an element's rank: 8 compares (7 halving steps and a last one) and one add
    cnt_ops = 9 * n
    cnt_b_ms, cnt_b_by = bound_ms(cnt_bytes, cnt_ops)
    mask_bytes = 8 * n + 4
    cnt_t = turns_ms(torch, {"f32": lambda: tkk.count_ge(x, cand),
                             "bf16": lambda: tkk.count_ge(xb, cand),
                             "f32, second round": lambda: tkk.count_ge(x, cand2)}, inner=3)
    bf16_bytes = 2 * n + tkr.NCAND * (4 + 8)
    timings = {
        "topk_count": {
            "ms": cnt_t["f32"]["median"], "turns": cnt_t,
            "plain_ms": graph_ms(torch, lambda: tkr.count_ge_ref(x, cand), inner=1, reps=3),
            "library_ms": None,
            "bound_ms": cnt_b_ms, "bound_by": cnt_b_by, "bytes": cnt_bytes, "operations": cnt_ops,
            "bf16_bound_ms": bound_ms(bf16_bytes, cnt_ops)[0],
        },
    }
    del xb
    # the mask in turns with F.hardshrink (library, kernel, kernel, library)
    mask_t = turns_ms(torch, {"library": lambda: F.hardshrink(x, lam),
                              "kernel": lambda: tkk.apply_threshold(x, lo)}, inner=5, rounds=3)
    timings["topk_mask"] = {
        "ms": mask_t["kernel"]["median"], "turns": mask_t,
        "plain_ms": graph_ms(torch, lambda: tkr.apply_threshold_ref(x, lo), inner=1, reps=5),
        "library_ms": mask_t["library"]["median"],
        "library": "F.hardshrink(x, nextafter(t, 0)), bitwise equal",
        "bound_ms": mask_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bytes": mask_bytes,
    }
    # the whole function (graph-captured) in turns with exact torch.topk
    # (eager: library, ours, ours, library)
    whole_t = turns_ms(torch, {"torch.topk": lambda: torch.topk(x.abs().flatten(), k),
                               "topk_sparsify": lambda: tko.topk_sparsify(x, k)},
                       inner=1, eager=("torch.topk",))
    whole = {
        "topk_sparsify_ms": whole_t["topk_sparsify"]["median"],
        "torch_topk_ms": whole_t["torch.topk"]["median"], "turns": whole_t,
        "bound_ms": (4 * n + 3 * cnt_bytes + mask_bytes) / HBM_BYTES_PER_S * 1e3,
        "peak_gib": peak_gib, "bracket_max": bracket, "n": n, "k": k,
    }
    for name, tm in timings.items():
        print(f"time {name} leaf {tuple(x.shape)} f32: {tm}", flush=True)
    print(f"time topk_sparsify (3 counts + 1 mask, graph-captured: no host round trip) "
          f"against torch.topk(x.abs().flatten(), k): {whole}", flush=True)
    torch.cuda.empty_cache()

    # encode and select on the leaf as one row, at its exact k-th magnitude
    # (the training slice encodes every leaf): bitwise the plain version,
    # then times
    row = x.reshape(1, -1)
    t_row = torch.full((1,), exact_t, device="cuda")
    for name, with_res in (("topk_encode", True), ("topk_select", False)):
        o_r, res_r, cnt_r = tkr.encode_threshold_ref(row, t_row, with_residual=with_res)
        o, res, cnt = tkk.encode_threshold(row, t_row, with_residual=with_res)
        torch.cuda.synchronize()
        check(torch.equal(o.view(torch.int32), o_r.view(torch.int32))
              and torch.equal(cnt, cnt_r) and int(cnt[0]) >= k
              and (not with_res or torch.equal(res.view(torch.int32),
                                               res_r.view(torch.int32))),
              f"{name} differs from the plain version on the leaf")
        print(f"{name} on the leaf as one row: bitwise the plain version, "
              f"{int(cnt_r[0])} kept", flush=True)
        del o, res, o_r, res_r
    torch.cuda.empty_cache()
    encode_t = encode_timings(torch, row, t_row, inner=3, label="leaf")
    for name, tm in encode_t.items():
        print(f"time {name} leaf as one row {tuple(row.shape)}: {tm}", flush=True)
    torch.cuda.empty_cache()
    # the int8 wire encode of the leaf with an EF residual (route B):
    # bitwise the plain version, then in turns with the chain it replaced
    from repro_torch.kernels.int8_quant import kernel as q8k, ref as q8r

    r_row = 0.25 * torch.randn(row.shape, generator=gen, device="cuda")
    got = q8k.int8_encode(row, r_row)
    want = q8r.int8_encode_ref(row, r_row)
    torch.cuda.synchronize()
    check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
              for a, b in zip(got, want)),
          "int8 encode differs from the plain version on the leaf")
    del got, want
    torch.cuda.empty_cache()
    encode_t["int8_encode"] = int8_encode_timings(torch, row, r_row, inner=2)
    print(f"int8 encode on the leaf as one row with EF: bitwise the plain version; "
          f"time {encode_t['int8_encode']}", flush=True)
    del r_row
    torch.cuda.empty_cache()
    return launches, timings, whole, err, encode_t


# ----------------------------------------------------------------------------
# Training: tinyllama-1.1b at full width and depth through api.fit
# ----------------------------------------------------------------------------

TRAIN_ARCH = "tinyllama-1.1b"
#: the reference's train-shape settings (src/repro/launch/specs.py:46-54)
TRAIN_REMAT, TRAIN_Q_CHUNK = "full", 512
TRAIN_B, TRAIN_T = 8, 2048
TRAIN_WARM, TRAIN_TIMED = 2, 6
#: at 1e-3 (examples/train_lm_e2e.py's rate) eight steps moved the loss
#: 10.7634 -> 10.7626, inside the batch-to-batch spread of about 0.02; at
#: 1e-2 it fell 0.05 (these seeds, on an H100 80GB HBM3 at 700 W)
TRAIN_LR = 1e-2
TRAIN_TOPK, TRAIN_STALENESS = 0.01, 1


class StepClock:
    """CUDA events around calls, by label: ``wrap(fn, label)`` returns
    ``fn`` recording an event before and after each call while a step is
    open (``start``); ``read`` synchronises and sums each label's spans in
    ms.  Recording an event adds no synchronisation."""

    def __init__(self, torch):
        self.torch = torch
        self.spans = None

    def wrap(self, fn, label):
        def timed(*args, **kwargs):
            if self.spans is None:
                return fn(*args, **kwargs)
            e0 = self.torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1 = self.torch.cuda.Event(enable_timing=True)
            e1.record()
            self.spans.setdefault(label, []).append((e0, e1))
            return out

        return timed

    def start(self):
        self.spans = {}

    def read(self) -> dict:
        self.torch.cuda.synchronize()
        spans, self.spans = self.spans, None
        return {label: sum(a.elapsed_time(b) for a, b in pairs) for label, pairs in spans.items()}


def loss_by_select(torch, tf, cfg, params, batch):
    """``loss_fn`` with each layer's weights taken as ``x[r]`` instead of
    ``forward``'s one ``unbind(0)``: the same operations, another backward
    for the stacked leaves (one zero-filled stack a layer, summed)."""
    from repro_torch.models.layers import embed, rmsnorm
    from repro_torch.utils.tree import tree_map

    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
    spec = tf.segments(cfg)[0].unit[0]
    body = tf._remat_wrap(
        lambda h, p: tf.apply_layer(p, cfg, spec, h, positions=positions)[0], cfg)
    h = embed(params["embed"], tokens, compute_dtype=getattr(torch, cfg.compute_dtype))
    for r in range(cfg.num_layers):
        h = body(h, tree_map(lambda x, r=r: x[r], params["seg0"]["l0"]))
    h = rmsnorm(params["final_norm"], h, eps=cfg.rms_eps)
    return tf.chunked_ce(params, cfg, h, batch["labels"])


def train_phase(torch):
    """tinyllama-1.1b trains through ``api.fit`` as ``launch/train.py``
    drives it: ``OptimizerStrategy`` (clip 1 ∘ Adam ∘ warmup-cosine) ×
    ``delay_line(1)`` × ``topk:0.01+ef``, one fit a step resumed from the
    last carry.  Returns the encode kernel's launches and the numbers."""
    from repro_torch import api, kernels
    from repro_torch.api import transport as transport_mod
    from repro_torch.configs import get_config
    from repro_torch.core.compression import kernel_plan
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.kernels.topk_compress import ops as tk_ops, ref as tk_ref
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH).replace(remat_policy=TRAIN_REMAT, attn_q_chunk=TRAIN_Q_CHUNK)
    steps = TRAIN_WARM + TRAIN_TIMED
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    batches = synthetic_lm_batches(0, TRAIN_B, TRAIN_T, cfg.vocab_size, device="cuda")
    stream = [next(batches) for _ in range(steps)]
    torch.cuda.synchronize()
    leaves, spec = tree_flatten(params)
    n_params = sum(x.numel() for x in leaves)
    eligible = kernel_plan(params)["kernel_leaves"]
    push = sum(max(1, int(round(TRAIN_TOPK * x.numel()))) * 8 for x in leaves)
    tokens = TRAIN_B * TRAIN_T
    print(f"training {cfg.name}: {n_params:,} f32 parameters in {len(leaves)} leaves "
          f"({eligible} take the encode kernel), B {TRAIN_B} × T {TRAIN_T}, "
          f"{cfg.compute_dtype} compute, remat {cfg.remat_policy}, attn_q_chunk "
          f"{cfg.attn_q_chunk}, set-up {time.perf_counter() - t0:.4f} s", flush=True)

    optimizer = train_cli.make_optimizer(TRAIN_LR, steps)
    strategy = train_cli.make_strategy(cfg, optimizer)

    # the gradient with forward's one unbind(0) is the gradient with x[r]
    # per layer, bit for bit on every stacked leaf; and what each costs
    # (after a first backward that pays the process's one-off set-up)
    state = strategy.init_state(params, None)
    t0 = time.perf_counter()
    strategy.local_updates(params, state, None, stream[0])
    torch.cuda.synchronize()
    print(f"first forward + backward of the process: {time.perf_counter() - t0:.4f} s",
          flush=True)
    grads_at = {}
    for name, loss_of in (("unbind", None), ("select", loss_by_select)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        if loss_of is None:
            g, _ = strategy.local_updates(params, state, None, stream[0])
            g = tree_leaves(g)
        else:
            xs = [x.detach().requires_grad_() for x in leaves]
            g = torch.autograd.grad(
                loss_of(torch, tf, cfg, tree_unflatten(xs, spec), stream[0]), xs)
        e1.record()
        torch.cuda.synchronize()
        grads_at[name] = (g, e0.elapsed_time(e1), torch.cuda.max_memory_allocated())
    paths = [".".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in torch.utils._pytree.tree_flatten_with_path(params)[0]]
    for path, a, b in zip(paths, grads_at["unbind"][0], grads_at["select"][0]):
        if path.startswith("seg0"):
            check(torch.equal(a, b), f"gradient of {path}: unbind(0) differs from x[r]")
    other = max(float((a - b).abs().max()) for path, a, b in
                zip(paths, grads_at["unbind"][0], grads_at["select"][0]))
    grad_check = {name: {"device_ms": v[1], "peak_gib": v[2] / 2**30}
                  for name, v in grads_at.items()}
    grad_check["max_abs_diff_all_leaves"] = other
    print(f"gradient, forward's unbind(0) against x[r] per layer: stacked leaves "
          f"bitwise equal; {json.dumps(grad_check)}", flush=True)
    del grads_at, g, state
    torch.cuda.empty_cache()

    clock = StepClock(torch)
    wire = api.make_wire(train_cli.wire_spec(TRAIN_TOPK))
    largest = max(x.numel() for x in leaves)
    captured = {}
    originals = (strategy.local_updates, strategy.apply_update, wire.encode_updates,
                 tk_ops.topk_encode, tk_ops.encode_threshold, transport_mod.delay_push_pop)

    def capture(fn):
        def encode(c, t, *, with_residual):
            out = fn(c, t, with_residual=with_residual)
            if c.numel() == largest and "leaf" not in captured and clock.spans is not None \
                    and len(losses) == steps - 1:
                captured["leaf"] = (c, t, out)
            return out

        return encode

    strategy.local_updates = clock.wrap(originals[0], "forward + backward")
    strategy.apply_update = clock.wrap(originals[1], "clip + Adam")
    wire.encode_updates = clock.wrap(originals[2], "wire")
    tk_ops.topk_encode = clock.wrap(originals[3], "wire: c = u + r, |c|, torch.topk + kernel")
    tk_ops.encode_threshold = clock.wrap(capture(originals[4]), "wire: encode kernel")
    transport_mod.delay_push_pop = clock.wrap(originals[5], "delay line")
    losses, walls, splits, peaks, uplink = [], [], [], [], 0
    try:
        theta, carry = params, None
        del params, leaves
        kernels.reset_launches()
        for step in range(steps):
            timed = step >= TRAIN_WARM
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if timed:
                clock.start()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            res = api.fit(strategy, None, transport="delay_line", staleness=TRAIN_STALENESS,
                          wire=wire, stream=train_cli.stack_batches([stream[step]]),
                          theta0=theta, carry=carry, tag="train", device="cuda")
            e1.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            theta, carry = res.theta, res.metrics["carry"]
            losses.append(float(res.trajectory[0]))
            uplink += res.ledger.uplink_bytes
            hits = res.metrics["wire_kernel_hits"]
            check(hits["active"] and hits["kernel_leaves"] == eligible,
                  f"training step {step}: wire_kernel_hits {hits}")
            line = {"step": step + 1, "loss": losses[-1], "wall_ms": wall,
                    "tokens_per_s": tokens / wall * 1e3,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            peaks.append(line["peak_gib"])
            if timed:
                split = clock.read()
                split["fit on the device (first to last event)"] = e0.elapsed_time(e1)
                splits.append(split)
                walls.append(wall)
                line["device_ms"] = split
            print("training step:", json.dumps(line), flush=True)
        launched = dict(kernels.LAUNCHES)
    finally:
        (strategy.local_updates, strategy.apply_update, wire.encode_updates,
         tk_ops.topk_encode, tk_ops.encode_threshold, transport_mod.delay_push_pop) = originals

    check(all(math.isfinite(v) for v in losses), f"training losses not finite: {losses}")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")
    check(uplink == steps * push, f"training uplink {uplink} != {steps} × {push}")
    want = {n: (eligible * steps if n == "topk_encode" else 0) for n in kernels.KERNEL_NAMES}
    check(launched == want, f"training launches {launched}, expected {want}")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(theta)), "θ not finite")

    # the encode of the largest gradient leaf in the last step, bitwise its
    # plain version on the same rows and threshold
    c, t, (o, res_, cnt) = captured["leaf"]
    o_r, res_r, cnt_r = tk_ref.encode_threshold_ref(c, t, with_residual=True)
    torch.cuda.synchronize()
    check(torch.equal(o.view(torch.int32), o_r.view(torch.int32))
          and torch.equal(res_.view(torch.int32), res_r.view(torch.int32))
          and torch.equal(cnt, cnt_r),
          "encode of the largest gradient leaf differs from the plain version")
    k = max(1, int(round(TRAIN_TOPK * largest)))
    leaf_check = {"n": largest, "k": k, "kept": int(cnt[0]), "threshold": float(t[0])}
    print(f"encode of the largest gradient leaf (last step, one row): bitwise the plain "
          f"version, {json.dumps(leaf_check)}", flush=True)
    del c, t, o, res_, cnt, o_r, res_r, cnt_r, captured

    # where the forward + backward's device time goes: one more on the last
    # batch under the profiler, kernels grouped by kind
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        strategy.local_updates(theta, carry[1], None, stream[-1])
        torch.cuda.synchronize()
        p_wall = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e3
    kinds = {"f32 matmuls (the attention einsums)": 0.0,
             "other matmuls (the bf16 projections and head)": 0.0, "softmax": 0.0,
             "copies and casts": 0.0, "other elementwise and reductions": 0.0}
    for e in on_card:
        name = e.key.lower()
        if any(w in name for w in ("gemm", "xmma", "cutlass", "nvjet")):
            kind = ("f32 matmuls (the attention einsums)" if "f32f32" in name
                    else "other matmuls (the bf16 projections and head)")
        elif "softmax" in name:
            kind = "softmax"
        elif "copy" in name:
            kind = "copies and casts"
        else:
            kind = "other elementwise and reductions"
        kinds[kind] += e.self_device_time_total / 1e3
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:12]
    profiled = {"wall_ms": p_wall, "device_busy_ms": busy, "by_kind_ms": kinds,
                "top": [[e.key[:90], e.self_device_time_total / 1e3, e.count] for e in top]}
    print("profiled forward + backward (one batch):", json.dumps(profiled), flush=True)

    state_bytes = {"theta": theta, "adam m, v": carry[1][0], "EF residual": carry[2],
                   "delay line": carry[3].buffer}
    state_gb = {name: sum(x.numel() * x.element_size() for x in tree_leaves(tree)) / 1e9
                for name, tree in state_bytes.items()}
    med = {label: statistics.median(sp[label] for sp in splits) for label in splits[0]}
    step_s = statistics.median(walls) / 1e3
    model_flops = 6 * n_params * tokens
    summary = {
        "steps": steps, "timed": TRAIN_TIMED, "losses": losses,
        "median_wall_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "median_device_ms": med, "peak_gib": max(peaks), "state_gb": state_gb,
        "model_flops_per_step": model_flops,
        "model_flop_share": model_flops / step_s / BF16_OPS_PER_S,
        "uplink_bytes": uplink, "push_bytes": push, "encode_launches": launched["topk_encode"],
        "encode_leaf": leaf_check, "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "gradient_check": grad_check, "profiled_forward_backward": profiled,
    }
    print("training:", json.dumps(summary), flush=True)
    del theta, carry, res, stream, state_bytes
    torch.cuda.empty_cache()
    return launched["topk_encode"], summary


#: the int8 wire's training run: tinyllama-1.1b at full width, cut to 2 of
#: its 22 layers, B 2 × T 256, 3 steps
INT8_TRAIN_LAYERS, INT8_TRAIN_B, INT8_TRAIN_T, INT8_TRAIN_STEPS = 2, 2, 256, 3


def int8_training_phase(torch):
    """tinyllama-1.1b at full width (2 of its 22 layers) trains through
    ``api.fit`` as ``launch/train.py`` drives it (clip ∘ Adam ∘
    warmup-cosine × ``delay_line(1)``) with an ``int8+ef`` wire, each leaf
    one row: the norms (2,048 and 2 × 2,048 elements) take the one-launch
    encode, the matrices (up to 65.5 M elements) absmax + quant.  One fit of
    3 steps with the kernels, one with ``use_kernel=False`` (no launch):
    θ, the EF residual, the trajectory and the ledger bitwise.  Returns
    the first fit's launches and the numbers."""
    from repro_torch import api, kernels
    from repro_torch.configs import get_config
    from repro_torch.core.compression import _kernel_eligible
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.kernels.int8_quant import kernel as q8k
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_leaves

    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH).replace(num_layers=INT8_TRAIN_LAYERS)
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(1), cfg)
    it = synthetic_lm_batches(1, INT8_TRAIN_B, INT8_TRAIN_T, cfg.vocab_size, device="cuda")
    stream = train_cli.stack_batches([next(it) for _ in range(INT8_TRAIN_STEPS)])
    strategy = train_cli.make_strategy(
        cfg, train_cli.make_optimizer(TRAIN_LR, INT8_TRAIN_STEPS))
    sizes = [x.numel() for x in tree_leaves(params) if _kernel_eligible(x)]
    short = sum(n <= q8k.one_launch_max() for n in sizes)
    long_ = len(sizes) - short
    check(short > 0 and long_ > 0, f"int8 training: leaves {sizes} do not take both routes")
    runs, walls, launched = {}, {}, {}
    for use in (True, False):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        runs[use] = api.fit(strategy, None, transport="delay_line", staleness=1,
                            wire=api.Int8Wire(error_feedback=True, use_kernel=use),
                            stream=stream, theta0=params, tag="train", device="cuda")
        torch.cuda.synchronize()
        walls[use] = time.perf_counter() - t0
        launched[use] = dict(kernels.LAUNCHES)
    steps = INT8_TRAIN_STEPS
    want = {n: 0 for n in kernels.KERNEL_NAMES}
    want.update(int8_encode=steps * short, int8_absmax=steps * long_, int8_quant=steps * long_)
    check(launched[True] == want, f"int8 training launches {launched[True]}, expected {want}")
    check(not any(launched[False].values()), f"int8 training off launched {launched[False]}")
    on, off = runs[True], runs[False]

    def same(a, b):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    check(same(on.theta, off.theta) and same(on.metrics["carry"][2], off.metrics["carry"][2])
          and torch.equal(on.trajectory, off.trajectory)
          and on.ledger.summary() == off.ledger.summary(),
          "int8 training: use_kernel on differs from off (θ, EF residual, trajectory, ledger)")
    losses = [float(v) for v in on.trajectory.reshape(-1)]
    check(all(math.isfinite(v) for v in losses), f"int8 training losses {losses}")
    out = {"arch": cfg.name, "layers": INT8_TRAIN_LAYERS, "batch": INT8_TRAIN_B,
           "seq": INT8_TRAIN_T, "steps": steps, "losses": losses,
           "wall_s": {"kernel": walls[True], "use_kernel=False": walls[False]},
           "leaves_one_launch": short, "leaves_two_launches": long_,
           "largest_leaf": max(sizes),
           "launches": {n: c for n, c in launched[True].items() if c}}
    print("int8 training (kernel on ≡ off, bitwise):", json.dumps(out), flush=True)
    del params, stream, runs, on, off
    torch.cuda.empty_cache()
    return launched[True], out


# ----------------------------------------------------------------------------
# MLA, MoE and multi-token prediction: olmoe-1b-7b and minicpm3-4b served at
# full width, deepseek-v3-671b (reduced) trained with its MTP loss
# ----------------------------------------------------------------------------

MOE_ARCH, MLA_ARCH, MTP_ARCH = "olmoe-1b-7b", "minicpm3-4b", "deepseek-v3-671b"
MOE_SLOTS, MOE_PAGE, MOE_MAX_SEQ, MOE_REQUESTS = 16, 16, 512, 32
#: logits of the card against the CPU, f32 compute on both: the repo's
#: logits tolerance (tests/test_torch_models.py), atol = rtol
MOE_LOGIT_TOL = 1e-4
#: a router row whose k-th and (k+1)-th probabilities are closer than this
#: may pick another expert on the card than on the CPU (sums in another order)
TIE_GAP = 1e-6
#: |absorbed − unabsorbed| logits in f32 compute, the reference's
#: tests/test_decode_consistency.py::test_mla_absorb_matches_unabsorbed
ABSORB_TOL = 2e-3
MLA_B, MLA_P, MLA_G = 8, 128, 32
MTP_STEPS, MTP_B, MTP_T = 8, 8, 128


def olmoe_serving(torch, kernels):
    """olmoe-1b-7b at full width and depth on ``ContinuousLMEngine`` as
    ``python -m repro_torch.launch.serve --continuous`` builds it: 16
    slots, mixed prompt lengths; then the CLI itself, briefly."""
    import contextlib
    import gc
    import io

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import layers, moe, transformer as tf
    from repro_torch.serve import ContinuousLMEngine, ServeMetrics
    from repro_torch.utils.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(MOE_ARCH)
    L = cfg.num_layers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    engine = ContinuousLMEngine(cfg, params, n_slots=MOE_SLOTS, page_size=MOE_PAGE,
                                max_seq=MOE_MAX_SEQ, tag=f"serve/{cfg.name}", device="cuda")
    engine.submit(np.arange(40, dtype=np.int32), max_new=4).result()  # first-call costs
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(engine.kernel_plan["path"] == "cuda", f"olmoe plan {engine.kernel_plan}")
    n_params = sum(x.numel() for x in tree_leaves(params))

    rng = np.random.default_rng(0)
    plens = rng.integers(16, 257, size=MOE_REQUESTS)
    gens = rng.integers(16, 65, size=MOE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in plens]
    engine.metrics = ServeMetrics()
    engine.kernel_hits = {"cuda": 0, "plain": 0}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    tickets = [engine.submit(p, max_new=int(g)) for p, g in zip(prompts, gens)]
    steps = engine.run_until_idle()
    outs = [t.result() for t in tickets]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated()
    for o, g in zip(outs, gens):
        check(o.shape == (int(g),) and bool(((o >= 0) & (o < cfg.vocab_size)).all()),
              f"olmoe ticket {o.shape} != ({g},) or an id out of range")
    for name in ("decode_attention", "decode_attention_merge"):
        check(launches[name] == steps * L,
              f"olmoe: {name} launched {launches[name]} times, expected {steps} steps × {L}")
    check(all(n == 0 for name, n in launches.items()
              if name not in ("decode_attention", "decode_attention_merge")),
          f"olmoe serving launched other kernels: {launches}")
    check(engine.kernel_hits == {"cuda": stats["tokens"], "plain": 0}, "olmoe kernel_hits")
    check(stats["tokens"] == int(gens.sum()) - MOE_REQUESTS, "olmoe decode tokens")
    check(engine.ledger.uplink_bytes == 4 * int(plens.sum()), "olmoe ledger uplink")

    # one captured step of 16 live slots: the decode kernel against its plain
    # version on each layer's own inputs, the step's logits against the plain
    # step's, then where the step's time goes
    caught = [engine.submit(rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32),
                            max_new=8) for n in rng.integers(16, 257, size=MOE_SLOTS)]
    engine.step()
    engine.step()
    check(engine.sched.n_active == MOE_SLOTS, "olmoe: slots for the capture")
    W = engine._weights
    args = (torch.from_numpy(engine._last_tok[:, None].copy()).long().cuda(), engine._cache,
            torch.from_numpy(engine.sched.block.copy()).long().cuda(),
            torch.from_numpy(engine.sched.length.copy()).cuda())
    captured = olmoe_captured_step(torch, W, cfg, args)
    step, w_bytes, parts, x = decode_step_parts(torch, W, cfg, args)
    lw = tree_map(lambda t: t[0], W["seg0"])["l0"]
    a = lw["mixer"]
    parts["attention matmuls"] = (
        lambda: (layers.dense(a["wo"], layers.dense(a["wq"], x)), layers.dense(a["wk"], x),
                 layers.dense(a["wv"], x)), L,
        sum(t.numel() * t.element_size() for t in tree_leaves(a) if t.dim() == 2))
    parts["MoE FFN"] = (lambda: moe.moe_apply(lw["ffn"], cfg, x), L,
                        sum(t.numel() * t.element_size() for t in tree_leaves(lw["ffn"])))
    breakdown = step_breakdown(torch, step, parts, w_bytes)
    check(breakdown["kernel_launches"] == L, "olmoe breakdown step launches")
    engine.run_until_idle()
    check(all(len(t.result()) == 8 for t in caught), "olmoe: captured-step requests")
    out = {
        "params": n_params, "setup_s": setup_s, "requests": MOE_REQUESTS,
        "prompt_tokens": int(plens.sum()), "generated": int(gens.sum()), "serve_s": serve_s,
        "decode_steps": steps, "decode_tokens_per_s": stats["tokens_per_s"],
        "p50_step_ms": stats["p50_token_ms"], "p95_step_ms": stats["p95_token_ms"],
        "p50_ttft_ms": stats["p50_ttft_ms"], "slot_utilization": stats["slot_utilization"],
        "peak_gib": peak / 2**30, "launches": {k: launches[k] for k in
                                               ("decode_attention", "decode_attention_merge")},
        "captured_step": captured, "step_16_slots": breakdown,
    }
    print(f"olmoe-1b-7b serving ({smi_line()}): {json.dumps(out)}", flush=True)
    # tickets hold their engine: let go of every one before the CLI's model
    del engine, params, W, lw, a, args, step, parts, x, tickets, caught
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    check(held < 4.0, f"olmoe: {held:.3f} GiB still held after the engine went")

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli = launch_serve.main(["--arch", MOE_ARCH, "--continuous", "--batch", "4",
                                 "--requests", "6", "--prompt-len", "40", "--gen", "8"])
    check(cli.shape == (6, 8), f"olmoe CLI output {cli.shape}")
    check("plan={'path': 'cuda'" in buf.getvalue(), "olmoe CLI not on the decode kernel")
    out["cli_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return launches, out


def olmoe_captured_step(torch, W, cfg, args) -> dict:
    """One 16-slot ``paged_decode_step`` with the decode kernel: on every
    layer the kernel's output against its plain version on the same inputs
    (``DECODE_TOL``); then the step's logits against the plain step's, the
    plain step following the kernel step's expert choices so that a router
    near-tie moved by rounding cannot change a row's experts."""
    from repro_torch.kernels.decode_attention import ref as dar
    from repro_torch.models import attention, moe, transformer as tf

    tol = DECODE_TOL["bfloat16"]
    attend, route = attention._decode_attend, moe.route
    errs, chosen = [], []

    def checked(q1, k_all, v_all, valid_len, *, impl):
        out = attend(q1, k_all, v_all, valid_len, impl=impl)
        if impl == "cuda":
            plain = dar.decode_attention_plain(q1, k_all, v_all, valid_len)
            check(q1.dtype == torch.bfloat16 and tuple(q1.shape[1:]) == (
                cfg.num_heads, cfg.head_dim), f"olmoe decode input {q1.dtype} {q1.shape}")
            errs.append(float((out.float() - plain.float()).abs().max()))
        return out

    def recording(p, c, x):
        probs, gates, ids = route(p, c, x)
        chosen.append(ids)
        return probs, gates, ids

    flips = []

    def following(p, c, x):
        probs, _, own = route(p, c, x)
        ids = chosen[len(flips)]
        flips.append(int((own != ids).any(dim=-1).sum()))
        gates = probs.gather(-1, ids)
        return probs, gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9), ids

    lg = {}
    try:
        attention._decode_attend = checked
        for impl, hook in (("cuda", recording), ("plain", following)):
            moe.route = hook
            logits, _ = tf.paged_decode_step(W, cfg, *args, decode_attn=impl)
            lg[impl] = logits[:, 0, : cfg.vocab_size].float()
    finally:
        attention._decode_attend, moe.route = attend, route
    torch.cuda.synchronize()
    check(len(errs) == cfg.num_layers and max(errs) <= tol,
          f"olmoe decode kernel vs plain on the step's inputs: {errs} (limit {tol})")
    check(len(flips) == cfg.num_layers, f"olmoe captured step: {len(flips)} router calls")
    diff = float((lg["cuda"] - lg["plain"]).abs().max())
    top2 = lg["cuda"].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > diff
    same = lg["cuda"].argmax(-1) == lg["plain"].argmax(-1)
    check(diff <= LOGIT_TOL, f"olmoe captured step: |logits kernel − plain| {diff} > {LOGIT_TOL}")
    check(bool(same[clear].all()), "olmoe captured step: argmax differs where the margin is clear")
    return {"lengths": args[3].tolist(), "kernel_vs_plain_max_abs_err": max(errs),
            "kernel_tolerance": tol, "max_abs_logit_diff": diff, "logit_tolerance": LOGIT_TOL,
            "argmax_equal_rows": int(same.sum()), "rows_clear_margin": int(clear.sum()),
            "logit_scale": float(lg["cuda"].abs().max()),
            "rows_whose_own_routing_differed_by_layer": flips}


def _olmoe_run(torch, tf, cfg, tree, prompts, G, device, feed=None):
    """Prefill + ``G`` greedy decode steps on a dense f32 cache; the fed
    tokens are ``feed`` where given (so the CPU follows the card's path).
    Returns (logits (B, 1 + G, V) f32 on the CPU, fed tokens)."""
    B, P = prompts.shape
    cache = tf.init_cache(cfg, B, P + G, torch.float32, device=device)
    toks = torch.from_numpy(prompts).long().to(device)
    logits, cache = tf.decode_step(tree, cfg, toks, cache,
                                   positions=torch.arange(P, device=device).expand(B, P))
    out, fed = [logits[:, -1]], []
    for g in range(G):
        tok = feed[g].to(device) if feed is not None else out[-1][:, : cfg.vocab_size].argmax(-1)
        fed.append(tok.cpu())
        logits, cache = tf.decode_step(tree, cfg, tok[:, None], cache)
        out.append(logits[:, 0])
    return torch.stack(out, 1)[..., : cfg.vocab_size].float().cpu(), fed


def olmoe_parity(torch):
    """olmoe-1b-7b at full width, 2 of its 16 layers, f32 compute: the
    card's logits for a prefill and 8 decode steps against the port on the
    CPU with the same weights; expert choices equal wherever the k-th and
    (k+1)-th router probabilities are more than ``TIE_GAP`` apart; two card
    runs bitwise equal, in f32 and in bf16 compute (the combine's fixed
    slot order)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import moe, transformer as tf
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(MOE_ARCH).replace(num_layers=2, compute_dtype="float32")
    k = cfg.moe.top_k
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(1), cfg)
    on_cpu = tree_map(lambda x: x.cpu(), params)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(4, 64))
    G = 8
    route = moe.route
    calls = []

    def recording(p, c, x):
        out = route(p, c, x)
        calls.append((out[0].detach().float().cpu(), out[2].cpu()))
        return out

    t0 = time.perf_counter()
    moe.route = recording
    try:
        card, fed = _olmoe_run(torch, tf, cfg, params, prompts, G, "cuda")
        card_calls, calls[:] = list(calls), []
        host, _ = _olmoe_run(torch, tf, cfg, on_cpu, prompts, G, "cpu", feed=fed)
        host_calls = list(calls)
    finally:
        moe.route = route
    check(len(card_calls) == len(host_calls) == 2 * (1 + G), "olmoe parity: router calls")
    clear_rows = mismatched_clear = mismatched_ties = 0
    bad = torch.zeros(prompts.shape[0], dtype=torch.bool)
    for (pc, ic), (ph, ih) in zip(card_calls, host_calls):
        top = pc.sort(dim=-1, descending=True).values
        clear = (top[..., k - 1] - top[..., k]) > TIE_GAP  # (B, T)
        same = (ic == ih).all(dim=-1)
        clear_rows += int(clear.sum())
        mismatched_clear += int((clear & ~same).sum())
        mismatched_ties += int((~clear & ~same).sum())
        bad |= ~same.all(dim=1)
    check(mismatched_clear == 0, f"olmoe parity: {mismatched_clear} clear rows chose other experts")
    rows = ~bad
    diff = (card - host).abs()
    lim = MOE_LOGIT_TOL + MOE_LOGIT_TOL * host.abs()
    check(int(rows.sum()) >= prompts.shape[0] - 1, f"olmoe parity: rows {rows.tolist()}")
    check(bool((diff[rows] <= lim[rows]).all()),
          f"olmoe parity: card vs CPU logits {float(diff[rows].max())}")
    # bitwise on the card: the same run again, f32 and bf16 compute
    again, _ = _olmoe_run(torch, tf, cfg, params, prompts, G, "cuda", feed=fed)
    check(torch.equal(again, card), "olmoe parity: two f32 card runs differ")
    bf = cfg.replace(compute_dtype="bfloat16")
    W = tf.compute_params(params, bf)
    b1, _ = _olmoe_run(torch, tf, bf, W, prompts, G, "cuda", feed=fed)
    b2, _ = _olmoe_run(torch, tf, bf, W, prompts, G, "cuda", feed=fed)
    check(torch.equal(b1, b2), "olmoe parity: two bf16 card runs differ")
    out = {"layers": 2, "d_model": cfg.d_model, "experts": cfg.moe.num_experts,
           "prompt": list(prompts.shape), "decode_steps": G,
           "max_abs_logit_diff": float(diff[rows].max()), "logit_scale": float(host.abs().max()),
           "tolerance": f"atol = rtol = {MOE_LOGIT_TOL}", "rows_held": int(rows.sum()),
           "router_rows": sum(int(pc.shape[0] * pc.shape[1]) for pc, _ in card_calls),
           "router_rows_clear": clear_rows, "tie_rows_choosing_otherwise": mismatched_ties,
           "bf16_vs_f32_max_logit_diff": float((b1 - card).abs().max()),
           "bitwise_runs": {"f32": True, "bf16": True}, "seconds": time.perf_counter() - t0}
    print(f"olmoe-1b-7b card vs CPU (2 layers, f32; {smi_line()}): {json.dumps(out)}",
          flush=True)
    del params, on_cpu, W
    torch.cuda.empty_cache()
    return out


def minicpm3_phase(torch, kernels):
    """minicpm3-4b at full width and depth through ``launch.serve``'s
    microbatched path (``prefill_and_decode`` over the contiguous
    ``MLACache``), then one decode step absorbed against unabsorbed in f32."""
    import contextlib
    import io

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        outs = launch_serve.main(["--arch", MLA_ARCH, "--batch", str(MLA_B), "--requests",
                                  str(MLA_B), "--prompt-len", str(MLA_P), "--gen", str(MLA_G)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.LAUNCHES)
    text = buf.getvalue()
    print(text.rstrip(), flush=True)
    stats = json.loads(next(line for line in text.splitlines() if line.startswith("{")))
    cfg = get_config(MLA_ARCH)
    check(outs.shape == (MLA_B, MLA_G) and bool(((outs >= 0) & (outs < cfg.vocab_size)).all()),
          f"minicpm3 ids {outs.shape}")
    check(all(n == 0 for n in launches.values()),
          f"minicpm3: MLA runs no kernel (plain products, as the reference), got {launches}")
    check(stats["batches"] == 1, f"minicpm3: {stats['batches']} batches")

    # absorbed against unabsorbed, one decode step after a prefill, f32
    f32 = cfg.replace(compute_dtype="float32")
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), f32)
    B, P = 2, 16
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, size=(B, P + 1)))
    toks = toks.cuda()
    cache = tf.init_cache(f32, B, P + 1, torch.float32, device="cuda")
    _, cache = tf.decode_step(params, f32, toks[:, :P], cache,
                              positions=torch.arange(P, device="cuda").expand(B, P))
    lg = {}
    for absorb in (False, True):
        c = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, cache)
        out, _ = tf.decode_step(params, f32, toks[:, P:], c, mla_absorb=absorb)
        lg[absorb] = out[:, 0, : cfg.vocab_size]
    torch.cuda.synchronize()
    absorb_diff = float((lg[True] - lg[False]).abs().max())
    check(absorb_diff < ABSORB_TOL, f"minicpm3: absorbed vs unabsorbed {absorb_diff}")
    out = {"layers": cfg.num_layers, "kv_lora_rank": cfg.mla.kv_lora_rank,
           "batch": MLA_B, "prompt": MLA_P, "gen": MLA_G, "wall_s": wall,
           "generated_tokens_per_s_busy": MLA_B * MLA_G / stats["busy_s"],
           "generated_tokens_per_s_wall": MLA_B * MLA_G / wall, "peak_gib": peak / 2**30,
           "absorbed_vs_unabsorbed_f32": absorb_diff, "absorb_tolerance": ABSORB_TOL,
           "logit_scale": float(lg[False].abs().max())}
    print(f"minicpm3-4b serving ({smi_line()}): {json.dumps(out)}", flush=True)
    del params, cache, lg
    torch.cuda.empty_cache()
    return out


def deepseek_training(torch, kernels):
    """deepseek-v3-671b ``reduced()`` (MLA, a first-k dense layer, MoE with
    a shared expert, MTP) trains through ``launch.train`` with the top-k
    wire: the encode kernel on every leaf each step; then its loss terms on
    the trained θ and a few greedy decode steps."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import restore_dict
    from repro_torch.configs import get_config
    from repro_torch.core.compression import kernel_plan
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(MTP_ARCH).reduced()
    tmp = tempfile.mkdtemp(prefix="mtp-")
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            hist = launch_train.main([
                "--arch", MTP_ARCH, "--reduced", "--compress-topk", "0.01",
                "--steps", str(MTP_STEPS), "--batch", str(MTP_B), "--seq", str(MTP_T),
                "--lr", "1e-2", "--log-every", "1", "--ckpt-dir", tmp,
                "--ckpt-every", str(MTP_STEPS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        print(buf.getvalue().rstrip(), flush=True)
        losses = [h["loss"] for h in hist]
        # every leaf of at least 256 f32 elements takes the kernel
        plan = kernel_plan(tf.init_params(torch.Generator(), cfg, device="meta"))
        n_leaves = plan["kernel_leaves"]
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
              f"deepseek reduced: losses {losses}")
        check(launches["topk_encode"] == MTP_STEPS * n_leaves,
              f"deepseek reduced: {launches['topk_encode']} encode launches, expected "
              f"{MTP_STEPS} steps × {n_leaves} eligible leaves ({plan})")
        check(all(n == 0 for name, n in launches.items() if name != "topk_encode"),
              f"deepseek reduced launched other kernels: {launches}")
        theta = restore_dict(tmp, MTP_STEPS, device="cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = synthetic_lm_batch(gen, MTP_B, MTP_T, cfg.vocab_size, device="cuda")
    with torch.no_grad():
        total, metrics = tf.loss_fn(theta, cfg, batch)
    terms = {k: float(v) for k, v in metrics.items()}
    check(sorted(terms) == ["aux", "ce", "mtp"] and all(math.isfinite(v) for v in terms.values())
          and terms["aux"] > 0, f"deepseek reduced: loss terms {terms}")
    prompts = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, size=(4, 16))).cuda()
    ids = launch_serve.prefill_and_decode(cfg, theta, prompts, gen=8, cache_len=25)
    check(ids.shape == (4, 8) and bool(((ids >= 0) & (ids < cfg.vocab_size)).all()),
          "deepseek reduced: greedy ids")
    out = {"params": sum(x.numel() for x in tree_leaves(theta)), "kernel_leaves": plan,
           "steps": MTP_STEPS, "batch": MTP_B, "seq": MTP_T, "wall_s": wall,
           "losses": losses, "loss_terms_after": {"total": float(total), **terms},
           "encode_launches": launches["topk_encode"], "greedy_ids": ids[0].tolist()}
    print(f"deepseek-v3-671b reduced training ({smi_line()}): {json.dumps(out)}", flush=True)
    return launches["topk_encode"], out


def mla_moe_mtp_phase(torch):
    """The three archs of the MLA / MoE / MTP slice, each part's kernel
    counts set to 0 before it and read after."""
    from repro_torch import kernels

    t0 = time.perf_counter()
    decode_launches, olmoe = olmoe_serving(torch, kernels)
    parity = olmoe_parity(torch)
    minicpm3 = minicpm3_phase(torch, kernels)
    encode_launches, deepseek = deepseek_training(torch, kernels)
    out = {"olmoe": olmoe, "olmoe_parity": parity, "minicpm3": minicpm3, "deepseek": deepseek,
           "seconds": time.perf_counter() - t0}
    return decode_launches, encode_launches, out


# ----------------------------------------------------------------------------
# Recurrent, audio and VLM: qwen2-vl-2b (M-RoPE through the flash and decode
# kernels), xlstm-125m, whisper-base, jamba-1.5-large-398b and deepseek-67b
# ----------------------------------------------------------------------------

VLM_ARCH, XLSTM_ARCH, WHISPER_ARCH = "qwen2-vl-2b", "xlstm-125m", "whisper-base"
JAMBA_ARCH, DS67_ARCH = "jamba-1.5-large-398b", "deepseek-67b"
#: the VLM prefill: B 4 × T 1024, a 16 × 16 patch grid (256 positions) first
VLM_B, VLM_T, VLM_GRID = 4, 1024, 16
VLM_SLOTS, VLM_PAGE, VLM_MAX_SEQ, VLM_REQUESTS = 16, 16, 640, 32
VLM_PLEN, VLM_GLEN = (32, 512), (16, 128)  # prompt and new-token ranges
VLM_STEPS, VLM_TRAIN_B, VLM_TRAIN_T, VLM_LR = 4, 2, 1024, 3e-3
XL_B, XL_P, XL_G = 8, 128, 32
XL_STEPS, XL_TRAIN_B, XL_TRAIN_T = 8, 4, 256
#: xLSTM's two blocks (one mLSTM, one sLSTM) on the card against the CPU
XL_CHECK_B, XL_CHECK_T = 2, 300
W_B, W_G = 8, 64
J_STEPS, J_TRAIN_B, J_TRAIN_T = 8, 8, 128
#: the full-width mamba mixer on the card against the CPU: B 1 × T 384 is one
#: chunk of 256 and a padded one; decode after a prefill of one chunk
J_MIX_T, J_MIX_PREFILL = 384, 256
DS67_LAYERS, DS67_SLOTS, DS67_REQUESTS, DS67_MAX_SEQ = 4, 16, 16, 320
DS67_PLEN, DS67_GLEN = (32, 256), (16, 64)
#: the recurrent archs' training rate (deepseek-v3 reduced trains at it)
RECURRENT_LR = 1e-2
#: card against CPU in f32 compute: max |Δ| / max |y_cpu|
CARD_CPU_REL = 1e-4


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output captured; (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _state_bytes(tree) -> int:
    from repro_torch.utils.tree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if hasattr(x, "element_size"))


def mrope_grid_positions(torch, B: int, T: int, grid: int, device):
    """(3, B, T) M-RoPE ids of a ``grid`` × ``grid`` patch prefix (temporal
    0, height r, width c), then text continuing on all three streams from
    ``grid`` (one past the largest patch id), as Qwen2-VL numbers them."""
    Tv = grid * grid
    r = torch.arange(Tv, device=device)
    pos = torch.empty((3, B, T), dtype=torch.int64, device=device)
    pos[0, :, :Tv] = 0
    pos[1, :, :Tv] = r // grid
    pos[2, :, :Tv] = r % grid
    pos[:, :, Tv:] = grid + torch.arange(T - Tv, device=device)
    return pos


def dense_captured_step(torch, W, cfg, args, label: str) -> dict:
    """One 16-slot ``paged_decode_step`` with the decode kernel: on every
    layer the kernel's output against its plain version on the same inputs
    (``DECODE_TOL``), then the step's logits against the plain step's
    (``LOGIT_TOL``), argmax equal wherever the top-2 margin clears the
    difference."""
    from repro_torch.kernels.decode_attention import ref as dar
    from repro_torch.models import attention, transformer as tf

    tol = DECODE_TOL["bfloat16"]
    attend, errs = attention._decode_attend, []

    def checked(q1, k_all, v_all, valid_len, *, impl):
        out = attend(q1, k_all, v_all, valid_len, impl=impl)
        if impl == "cuda":
            check(q1.dtype == torch.bfloat16 and tuple(q1.shape[1:]) == (
                cfg.num_heads, cfg.head_dim) and k_all.shape[2] == cfg.num_kv_heads,
                f"{label} decode input {q1.dtype} {tuple(q1.shape)} {tuple(k_all.shape)}")
            plain = dar.decode_attention_plain(q1, k_all, v_all, valid_len)
            errs.append(float((out.float() - plain.float()).abs().max()))
        return out

    lg = {}
    try:
        attention._decode_attend = checked
        for impl in ("cuda", "plain"):
            logits, _ = tf.paged_decode_step(W, cfg, *args, decode_attn=impl)
            lg[impl] = logits[:, 0, : cfg.vocab_size].float()
    finally:
        attention._decode_attend = attend
    torch.cuda.synchronize()
    check(len(errs) == cfg.num_layers and max(errs) <= tol,
          f"{label} decode kernel vs plain on the step's inputs: {errs} (limit {tol})")
    diff = float((lg["cuda"] - lg["plain"]).abs().max())
    top2 = lg["cuda"].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > diff
    same = lg["cuda"].argmax(-1) == lg["plain"].argmax(-1)
    check(diff <= LOGIT_TOL, f"{label} captured step: |logits kernel − plain| {diff}")
    check(bool(same[clear].all()), f"{label} captured step: argmax differs where clear")
    return {"lengths": args[3].tolist(), "group": cfg.num_heads // cfg.num_kv_heads,
            "kernel_vs_plain_max_abs_err": max(errs), "kernel_tolerance": tol,
            "max_abs_logit_diff": diff, "logit_tolerance": LOGIT_TOL,
            "argmax_equal_rows": int(same.sum()), "rows_clear_margin": int(clear.sum()),
            "logit_scale": float(lg["cuda"].abs().max())}


def continuous_run(torch, kernels, cfg, params, *, slots, max_seq, requests, plen, glen,
                   label, seed=0):
    """``ContinuousLMEngine`` as ``launch.serve --continuous`` builds it:
    ``requests`` greedy requests (prompt lengths in ``plen``, new tokens in
    ``glen``), both decode kernels launched steps × layers and nothing else;
    then one captured step of every slot (``dense_captured_step``)."""
    import numpy as np

    from repro_torch.models import transformer as tf
    from repro_torch.serve import ContinuousLMEngine, ServeMetrics
    from repro_torch.utils.tree import tree_leaves

    L = cfg.num_layers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = ContinuousLMEngine(cfg, params, n_slots=slots, page_size=VLM_PAGE,
                                max_seq=max_seq, tag=f"serve/{cfg.name}", device="cuda")
    engine.submit(np.arange(40, dtype=np.int32), max_new=4).result()  # first-call costs
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(engine.kernel_plan["path"] == "cuda", f"{label} plan {engine.kernel_plan}")
    rng = np.random.default_rng(seed)
    plens = rng.integers(plen[0], plen[1] + 1, size=requests)
    gens = rng.integers(glen[0], glen[1] + 1, size=requests)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in plens]
    engine.metrics = ServeMetrics()
    engine.kernel_hits = {"cuda": 0, "plain": 0}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    tickets = [engine.submit(p, max_new=int(g)) for p, g in zip(prompts, gens)]
    steps = engine.run_until_idle()
    outs = [t.result() for t in tickets]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated()
    for o, g in zip(outs, gens):
        check(o.shape == (int(g),) and bool(((o >= 0) & (o < cfg.vocab_size)).all()),
              f"{label} ticket {o.shape} != ({g},) or an id out of range")
    pair = ("decode_attention", "decode_attention_merge")
    for name in pair:
        check(launches[name] == steps * L,
              f"{label}: {name} launched {launches[name]} times, expected {steps} × {L}")
    check(all(n == 0 for name, n in launches.items() if name not in pair),
          f"{label} serving launched other kernels: {launches}")
    check(engine.kernel_hits == {"cuda": stats["tokens"], "plain": 0}, f"{label} kernel_hits")
    check(stats["tokens"] == int(gens.sum()) - requests, f"{label} decode tokens")
    check(engine.ledger.uplink_bytes == 4 * int(plens.sum()), f"{label} ledger uplink")
    caught = [engine.submit(rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32),
                            max_new=8) for n in rng.integers(plen[0], plen[1] + 1, size=slots)]
    engine.step()
    engine.step()
    check(engine.sched.n_active == slots, f"{label}: slots for the capture")
    args = (torch.from_numpy(engine._last_tok[:, None].copy()).long().cuda(), engine._cache,
            torch.from_numpy(engine.sched.block.copy()).long().cuda(),
            torch.from_numpy(engine.sched.length.copy()).cuda())
    captured = dense_captured_step(torch, engine._weights, cfg, args, label)
    W = engine._weights
    captured["step_16_slots"] = host_and_device(torch, lambda: tf.paged_decode_step(
        W, cfg, *args, decode_attn="cuda"))
    # every weight the step reads once; an untied embedding only by the rows
    # looked up, a tied one in full by the head
    emb = W["embed"]["embedding"]
    w_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(W)) - (
        0 if cfg.tie_embeddings else emb.numel() * emb.element_size())
    captured["step_16_slots"]["weight_bound_ms"] = w_bytes / HBM_BYTES_PER_S * 1e3
    del W, emb
    engine.run_until_idle()
    check(all(len(t.result()) == 8 for t in caught), f"{label}: captured-step requests")
    out = {"setup_s": setup_s, "requests": requests, "prompt_tokens": int(plens.sum()),
           "generated": int(gens.sum()), "serve_s": serve_s, "decode_steps": steps,
           "decode_tokens_per_s": stats["tokens_per_s"], "p50_step_ms": stats["p50_token_ms"],
           "p95_step_ms": stats["p95_token_ms"], "p50_ttft_ms": stats["p50_ttft_ms"],
           "slot_utilization": stats["slot_utilization"], "peak_gib": peak / 2**30,
           "launches": {k: launches[k] for k in pair}, "captured_step": captured}
    del engine, tickets, caught, args
    return {k: launches[k] for k in pair}, out


def vlm_prefill(torch, kernels, W, cfg):
    """qwen2-vl-2b's plain forward end to end on B 4 × T 1024 with a 16 × 16
    patch prefix and M-RoPE ids; inside it, each of the 28 layers' attention
    also through ``attn_apply(use_kernel=True, mrope_positions=…)`` on that
    layer's own inputs (the bf16 flash kernel), held to the plain branch at
    ``ATTN_TOL`` and ``ATTN_REL_TOL`` a row; a planted control (the kernel
    with ``q_offset=-1``) must fail them at the first layer, and is
    recorded at the last."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention as attn, transformer as tf

    L, Tv = cfg.num_layers, VLM_GRID * VLM_GRID
    g = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (VLM_B, VLM_T), generator=g, device="cuda")
    # patch embeddings at the token embeddings' scale (the projector's output)
    vision = 0.02 * torch.randn((VLM_B, Tv, cfg.d_model), generator=g, device="cuda")
    mpos = mrope_grid_positions(torch, VLM_B, VLM_T, VLM_GRID, "cuda")
    plain = attn.attn_apply
    errs, control, layer = [], {}, [0]

    class DropOwnKey:
        @staticmethod
        def flash_attention(q, k, v, **kw):
            return fa_ops.flash_attention(q, k, v, q_offset=-1, **kw)

    def checked(p, c, x, *, positions, mrope_positions=None, cache=None, **kw):
        y, new = plain(p, c, x, positions=positions, mrope_positions=mrope_positions,
                       cache=cache, **kw)
        li = layer[0]
        layer[0] += 1
        yk = plain(p, c, x, positions=positions, mrope_positions=mrope_positions,
                   use_kernel=True)[0]
        check(yk.shape == y.shape and yk.dtype == torch.bfloat16
              and bool(torch.isfinite(yk).all()), f"qwen2-vl layer {li}: kernel output")
        a, r = row_errors(torch, yk, y)
        errs.append((float(a.max()), float(r.max())))
        if li in (0, L - 1):
            launched = dict(kernels.LAUNCHES)
            attn.fa_ops = DropOwnKey
            try:
                yc = plain(p, c, x, positions=positions, mrope_positions=mrope_positions,
                           use_kernel=True)[0]
            finally:
                attn.fa_ops = fa_ops
            kernels.LAUNCHES.update(launched)  # the control is a comparison, not the path
            a, r = row_errors(torch, yc, y)
            a, r = a[:, VLM_T // 2:], r[:, VLM_T // 2:]
            control[f"layer {li}"] = {
                "caught_share": float(((r > ATTN_REL_TOL) | (a > ATTN_TOL)).float().mean()),
                "median_row_rel": float(r.median())}
        return y, new

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    attn.attn_apply = checked
    try:
        with torch.no_grad():
            logits, _, _ = tf.forward(W, cfg, tokens, mrope_positions=mpos, vision_embeds=vision)
    finally:
        attn.attn_apply = plain
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = {n: (L if n == "flash_attention_tc" else 0) for n in kernels.KERNEL_NAMES}
    check(launches == want, f"qwen2-vl prefill launches {launches}, expected {want}")
    check(logits.shape == (VLM_B, VLM_T, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., : cfg.vocab_size]).all()), "qwen2-vl logits")
    max_abs = max(e[0] for e in errs)
    max_rel = max(e[1] for e in errs)
    check(len(errs) == L, f"qwen2-vl: {len(errs)} attention layers checked")
    check(max_abs <= ATTN_TOL and max_rel <= ATTN_REL_TOL,
          f"qwen2-vl flash vs plain: max |Δ| {max_abs}, row rel {max_rel}")
    # the first layer's input is the embeddings, where dropping a query's own
    # key moves its row past the limits; at the last layer the residual
    # stream is much alike across positions and the same fault moves a row
    # by ≈ 0.3 %, under the 0.8 % limit: recorded, not required
    check(control["layer 0"]["caught_share"] >= 0.99,
          f"qwen2-vl planted control passed at layer 0: {control}")
    # the M-RoPE ids matter: the same prefix with 1-D positions moves the output
    with torch.no_grad():
        flat, _, _ = tf.forward(W, cfg, tokens[:1, :Tv + 64], vision_embeds=vision[:1])
        grid, _, _ = tf.forward(W, cfg, tokens[:1, :Tv + 64], vision_embeds=vision[:1],
                                mrope_positions=mpos[:, :1, :Tv + 64].contiguous())
    moved = float((flat - grid)[..., : cfg.vocab_size].abs().max())
    check(moved > 1e-2, f"qwen2-vl: M-RoPE ids left the logits as 1-D positions do ({moved})")
    out = {"batch": VLM_B, "seq": VLM_T, "patch_prefix": Tv, "wall_s": wall,
           "flash_launches": launches["flash_attention_tc"],
           "kernel_vs_plain": {"max_abs": max_abs, "max_row_rel": max_rel},
           "limits": {"max_abs": ATTN_TOL, "max_row_rel": ATTN_REL_TOL},
           "planted_control": control,
           "logit_scale": float(logits[..., : cfg.vocab_size].abs().max()),
           "mrope_vs_1d_positions_max_logit_diff": moved}
    del logits, flat, grid
    return launches["flash_attention_tc"], out


def vlm_training(torch, kernels, cfg):
    """qwen2-vl-2b trains through ``api.fit`` as ``launch/train.py`` drives
    it (clip ∘ Adam ∘ warmup-cosine × ``delay_line(1)`` × ``topk:0.01+ef``,
    one fit a step resumed from the carry) on one batch of B 2 × T 1024 with
    the patch prefix, its M-RoPE ids and no loss on the prefix, under
    ``remat_policy="full"``: the loss falls and the encode kernel runs once
    a leaf a step."""
    from repro_torch import api
    from repro_torch.core.compression import kernel_plan
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_leaves

    cfg = cfg.replace(remat_policy="full")
    # θ under one name only: a second would keep θ_0 alive all run
    theta = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    B, T, Tv = VLM_TRAIN_B, VLM_TRAIN_T, VLM_GRID * VLM_GRID
    g = torch.Generator(device="cuda").manual_seed(12)
    batch = synthetic_lm_batch(g, B, T, cfg.vocab_size, device="cuda")
    batch["vision_embeds"] = 0.02 * torch.randn((B, Tv, cfg.d_model), generator=g,
                                                device="cuda")
    batch["mrope_positions"] = mrope_grid_positions(torch, B, T, VLM_GRID, "cuda")
    batch["loss_mask"] = torch.ones((B, T), device="cuda")
    batch["loss_mask"][:, :Tv] = 0.0
    eligible = kernel_plan(theta)["kernel_leaves"]
    strategy = train_cli.make_strategy(cfg, train_cli.make_optimizer(VLM_LR, VLM_STEPS))
    stream = train_cli.stack_batches([batch])
    carry, losses, walls = None, [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for _ in range(VLM_STEPS):
        t0 = time.perf_counter()
        res = api.fit(strategy, None, transport="delay_line", staleness=1,
                      wire=train_cli.wire_spec(0.01), stream=stream, theta0=theta, carry=carry,
                      tag="train", device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        theta, carry = res.theta, res.metrics["carry"]
        losses.append(float(res.trajectory[0]))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"qwen2-vl training losses {losses}")
    want = {n: (eligible * VLM_STEPS if n == "topk_encode" else 0) for n in kernels.KERNEL_NAMES}
    check(launches == want, f"qwen2-vl training launches {launches}, expected {want}")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(theta)), "qwen2-vl θ")
    state = {"theta": _state_bytes(theta), "adam m, v": _state_bytes(carry[1][0]),
             "EF residual": _state_bytes(carry[2]), "delay line": _state_bytes(carry[3].buffer)}
    out = {"steps": VLM_STEPS, "batch": B, "seq": T, "lr": VLM_LR, "losses": losses,
           "wall_s_a_step": walls, "peak_gib": peak / 2**30,
           "state_gb": {k: v / 1e9 for k, v in state.items()},
           "encode_launches": launches["topk_encode"], "kernel_leaves": eligible}
    del theta, carry, res, stream, batch
    return launches["topk_encode"], out


def vlm_part(torch, kernels):
    """(V) qwen2-vl-2b at full size: the VLM prefill through the flash
    kernel, the continuous engine through the decode pair (G 6, D 128),
    then training with the patch prefix."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(VLM_ARCH)
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    n_params = sum(x.numel() for x in tree_leaves(params))
    W = tf.compute_params(params, cfg)
    flash, prefill = vlm_prefill(torch, kernels, W, cfg)
    del W
    torch.cuda.empty_cache()
    decode, serving = continuous_run(
        torch, kernels, cfg, params, slots=VLM_SLOTS, max_seq=VLM_MAX_SEQ,
        requests=VLM_REQUESTS, plen=VLM_PLEN, glen=VLM_GLEN, label="qwen2-vl")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    encode, training = vlm_training(torch, kernels, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"params": n_params, "prefill": prefill, "serving": serving, "training": training}
    print(f"qwen2-vl-2b ({smi_line()}): {json.dumps(out)}", flush=True)
    return {"flash_attention_tc": flash, **decode, "topk_encode": encode}, out


def card_vs_cpu(torch, fn, params, x) -> dict:
    """``fn(params, x)`` in f32 on the card and on the CPU (TF32 off):
    max |Δ| over max |y_cpu|."""
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        y_card = fn(tree_map(lambda a: a.cuda(), params), x.cuda()).cpu()
        y_cpu = fn(params, x)
    scale = float(y_cpu.abs().max())
    rel = float((y_card - y_cpu).abs().max()) / scale
    return {"max_rel_err": rel, "scale": scale}


def cli_training(torch, kernels, arch, *, steps, batch, seq, reduced=False) -> dict:
    """``launch.train --arch arch`` with ``topk:0.01+ef`` for ``steps`` steps
    of fresh ``synthetic_lm_batches`` (seed 0), a checkpoint at the end:
    the encode kernel once a leaf a step and no other kernel, and the loss
    falls on the batches it trained on (their mean at the trained θ below
    its mean at θ_0, both recomputed here; a fresh batch of a 50k
    vocabulary tells little after 8 steps).  The first recomputed loss must
    be the CLI's first logged one, so the batches are the CLI's."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import restore_dict
    from repro_torch.configs import get_config
    from repro_torch.core.compression import kernel_plan
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as tf

    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    tmp = tempfile.mkdtemp(prefix="train-")
    argv = ["--arch", arch, "--compress-topk", "0.01", "--steps", str(steps), "--batch",
            str(batch), "--seq", str(seq), "--lr", str(RECURRENT_LR), "--log-every", "1",
            "--ckpt-dir", tmp, "--ckpt-every", str(steps)] + (["--reduced"] if reduced else [])
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        hist, _ = _quiet(launch_train.main, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        theta = restore_dict(tmp, steps, device="cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    eligible = kernel_plan(tf.init_params(torch.Generator(), cfg, device="meta"))[
        "kernel_leaves"]
    check(launches["topk_encode"] == steps * eligible and all(
        n == 0 for name, n in launches.items() if name != "topk_encode"),
        f"{arch} training launches {launches}, expected {steps} × {eligible}")
    theta0 = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    data = synthetic_lm_batches(0, batch, seq, cfg.vocab_size, device="cuda")
    at = {"theta_0": [], "trained": []}
    with torch.no_grad():
        for _ in range(steps):
            b = next(data)
            at["theta_0"].append(float(tf.loss_fn(theta0, cfg, b)[0]))
            at["trained"].append(float(tf.loss_fn(theta, cfg, b)[0]))
    logged = [h["loss"] for h in hist]
    check(abs(at["theta_0"][0] - logged[0]) <= 1e-3 * abs(logged[0]),
          f"{arch}: the recomputed first loss {at['theta_0'][0]} is not the CLI's {logged[0]}")
    before, after = (statistics.mean(v) for v in at.values())
    check(all(math.isfinite(v) for v in logged + at["trained"]) and after < before,
          f"{arch} training: mean loss on its batches {before} at θ_0, {after} trained")
    del theta, theta0
    return {"arch": cfg.name, "steps": steps, "batch": batch, "seq": seq, "lr": RECURRENT_LR,
            "logged_losses": logged, "mean_loss_on_its_batches": {"theta_0": before,
                                                                  "trained": after},
            "wall_s": wall, "encode_launches": launches["topk_encode"],
            "kernel_leaves": eligible}


def xlstm_part(torch, kernels):
    """(X) xlstm-125m at full size: served through ``launch.serve`` (loop
    prefill into the fixed-size states), trained through ``launch.train``
    with ``topk:0.01+ef``; one mLSTM and one sLSTM block in f32 on the card
    against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tf, xlstm

    cfg = get_config(XLSTM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs, text = _quiet(launch_serve.main, ["--arch", XLSTM_ARCH, "--batch", str(XL_B),
                                            "--requests", str(XL_B), "--prompt-len", str(XL_P),
                                            "--gen", str(XL_G)])
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    check("loop prefill" in text, "xlstm serving: not on loop prefill")
    check(outs.shape == (XL_B, XL_G) and bool(((outs >= 0) & (outs < cfg.vocab_size)).all()),
          f"xlstm ids {outs.shape}")
    check(all(n == 0 for n in kernels.LAUNCHES.values()),
          f"xlstm serving: the recurrent stack runs no kernel, got {dict(kernels.LAUNCHES)}")
    stats = json.loads(next(line for line in text.splitlines() if line.startswith("{")))
    state = _state_bytes(tf.init_cache(cfg, XL_B, XL_P + XL_G + 1, torch.float32, device="meta"))
    state_long = _state_bytes(tf.init_cache(cfg, XL_B, 1 << 20, torch.float32, device="meta"))
    check(state == state_long, "xlstm decode state grows with the context")
    serve_peak = torch.cuda.max_memory_allocated()

    W = tf.compute_params(tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg),
                          cfg)
    cache = tf.init_cache(cfg, XL_B, 1, torch.float32, device="cuda")
    tok = torch.zeros((XL_B, 1), dtype=torch.int64, device="cuda")
    with torch.no_grad():
        decode_step = host_and_device(torch, lambda: tf.decode_step(W, cfg, tok, cache))
    del W, cache
    train = cli_training(torch, kernels, XLSTM_ARCH, steps=XL_STEPS, batch=XL_TRAIN_B,
                         seq=XL_TRAIN_T)

    f32 = cfg.replace(compute_dtype="float32")
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((XL_CHECK_B, XL_CHECK_T, cfg.d_model), generator=gen)
    blocks = {}
    for name, init, apply in (("mlstm", xlstm.mlstm_init, xlstm.mlstm_apply),
                              ("slstm", xlstm.slstm_init, xlstm.slstm_apply)):
        p = init(gen, f32, device="cpu")
        blocks[name] = card_vs_cpu(torch, lambda p_, x_, apply=apply: apply(p_, f32, x_)[0], p, x)
        check(blocks[name]["max_rel_err"] <= CARD_CPU_REL,
              f"xlstm {name} block, card vs CPU: {blocks[name]}")
    out = {"serve": {"batch": XL_B, "prompt": XL_P, "gen": XL_G, "wall_s": serve_wall,
                     "generated_tokens_per_s_busy": XL_B * XL_G / stats["busy_s"],
                     "generated_tokens_per_s_wall": XL_B * XL_G / serve_wall,
                     "decode_state_bytes": state, "peak_gib": serve_peak / 2**30,
                     "decode_step_b8": decode_step},
           "train": train,
           "card_vs_cpu_f32": {"batch": XL_CHECK_B, "seq": XL_CHECK_T, **blocks,
                               "limit": CARD_CPU_REL}}
    print(f"xlstm-125m ({smi_line()}): {json.dumps(out)}", flush=True)
    return train["encode_launches"], out


def whisper_part(torch):
    """(W) whisper-base at full size: encode B 8 × 1,500 stub frames, 64
    greedy tokens through ``decode_step`` (bf16); in f32 the cached decode
    against the full ``decode`` on the card (2e-3, the reference's bound),
    and row 0's logits on the card against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import whisper
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(WHISPER_ARCH)
    params = whisper.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    g = torch.Generator(device="cuda").manual_seed(13)
    frames = torch.randn((W_B, cfg.encoder_seq_len, cfg.d_model), generator=g, device="cuda")
    start = torch.full((W_B, 1), cfg.vocab_size - 1, dtype=torch.int64, device="cuda")

    def greedy(c, p, n):
        """Encode, then ``n`` greedy tokens through ``decode_step`` →
        (memory, tokens (B, n + 1) with the start token, step logits)."""
        mem = whisper.encode(p, c, frames)
        cache = whisper.init_decoder_cache(c, W_B, n + 1, torch.float32, device="cuda")
        toks, steps = [start], []
        for t in range(n):
            lg, cache = whisper.decode_step(p, c, toks[-1], mem, cache, position=t)
            steps.append(lg[:, 0])
            toks.append(lg[:, -1, : c.vocab_size].argmax(-1, keepdim=True))
        return mem, torch.cat(toks, 1), torch.stack(steps, 1)

    with torch.no_grad():
        greedy(cfg, params, 2)  # first calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mem = whisper.encode(params, cfg, frames)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, toks, _ = greedy(cfg, params, W_G)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        check(toks.shape == (W_B, W_G + 1) and bool((toks < cfg.vocab_size).all()),
              "whisper greedy ids")
        cache = whisper.init_decoder_cache(cfg, W_B, W_G + 1, torch.float32, device="cuda")
        decode_step = host_and_device(torch, lambda: whisper.decode_step(
            params, cfg, toks[:, :1], mem, cache, position=0))
        del cache
        f32 = cfg.replace(compute_dtype="float32")
        mem32, toks32, steps32 = greedy(f32, params, W_G)
        full, _ = whisper.decode(params, f32, toks32[:, :-1], mem32)
        V = cfg.vocab_size
        cached_vs_full = float((steps32[..., :V] - full[..., :V]).abs().max())
        check(cached_vs_full < 2e-3, f"whisper cached vs full decode {cached_vs_full}")
        host = tree_map(lambda a: a.cpu(), params)
        card_logits = whisper.decode(params, f32, toks32[:1, :-1],
                                     whisper.encode(params, f32, frames[:1]))[0][..., :V].cpu()
        cpu_logits = whisper.decode(host, f32, toks32[:1, :-1].cpu(),
                                    whisper.encode(host, f32, frames[:1].cpu()))[0][..., :V]
    diff = (card_logits - cpu_logits).abs()
    lim = MOE_LOGIT_TOL + MOE_LOGIT_TOL * cpu_logits.abs()
    check(bool((diff <= lim).all()), f"whisper f32 card vs CPU logits {float(diff.max())}")
    check(bool((full[..., V:] == -1e30).all()), "whisper: padded vocabulary not masked")
    out = {"batch": W_B, "frames": cfg.encoder_seq_len, "gen": W_G, "encode_s": enc_s,
           "encode_and_decode_s": total_s,
           "decode_tokens_per_s": W_B * W_G / max(total_s - enc_s, 1e-9),
           "decode_step_b8": decode_step,
           "cached_vs_full_f32": cached_vs_full,
           "card_vs_cpu_f32": {"max_abs": float(diff.max()),
                               "scale": float(cpu_logits.abs().max()),
                               "tolerance": f"atol = rtol = {MOE_LOGIT_TOL}"},
           "greedy_ids_row0": toks[0, 1:17].tolist()}
    print(f"whisper-base ({smi_line()}): {json.dumps(out)}", flush=True)
    del params, host, mem, mem32, full
    torch.cuda.empty_cache()
    return out


def jamba_part(torch, kernels):
    """(J) jamba-1.5-large-398b ``reduced()`` (398 B parameters do not fit
    one card) served through ``launch.serve`` (loop prefill) and trained
    through ``launch.train`` with ``topk:0.01+ef``; one mamba mixer at full
    width in f32 on the card against the CPU, and its step-by-step decode
    after a prefill against its forward."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import cache as cache_lib, mamba
    from repro_torch.utils.tree import tree_map

    cfg = get_config(JAMBA_ARCH)
    kernels.reset_launches()
    outs, text = _quiet(launch_serve.main, ["--arch", JAMBA_ARCH, "--reduced", "--batch", "4",
                                            "--requests", "4", "--prompt-len", "64",
                                            "--gen", "16"])
    check("loop prefill" in text and outs.shape == (4, 16), "jamba serving")
    check(all(n == 0 for n in kernels.LAUNCHES.values()), "jamba serving launched a kernel")
    train = cli_training(torch, kernels, JAMBA_ARCH, steps=J_STEPS, batch=J_TRAIN_B,
                         seq=J_TRAIN_T, reduced=True)

    f32 = cfg.replace(compute_dtype="float32")
    d_inner, dt_rank, d_state, d_conv = mamba._dims(f32)
    gen = torch.Generator().manual_seed(4)
    p = mamba.mamba_init(gen, f32, device="cpu")
    x = torch.randn((1, J_MIX_T, cfg.d_model), generator=gen)
    t0 = time.perf_counter()
    mixer = card_vs_cpu(torch, lambda p_, x_: mamba.mamba_apply(p_, f32, x_)[0], p, x)
    check(mixer["max_rel_err"] <= CARD_CPU_REL, f"jamba mamba mixer, card vs CPU: {mixer}")
    pc, xc = tree_map(lambda a: a.cuda(), p), x.cuda()
    with torch.no_grad():
        full = mamba.mamba_apply(pc, f32, xc)[0]
        cache = cache_lib.mamba_cache_init(1, d_conv, d_inner, d_state, torch.float32, "cuda")
        ys = []
        y, cache = mamba.mamba_apply(pc, f32, xc[:, :J_MIX_PREFILL], cache=cache)
        ys.append(y)
        for t in range(J_MIX_PREFILL, J_MIX_T):
            y, cache = mamba.mamba_apply(pc, f32, xc[:, t:t + 1], cache=cache)
            ys.append(y)
        stepped = torch.cat(ys, 1)
    torch.cuda.synchronize()
    step_rel = float((stepped - full).abs().max()) / float(full.abs().max())
    check(step_rel <= CARD_CPU_REL, f"jamba mamba decode after prefill vs forward: {step_rel}")
    out = {"reduced_train": train,
           "mixer_full_width": {"d_model": cfg.d_model, "d_inner": d_inner, "d_state": d_state,
                                "dt_rank": dt_rank, "batch": 1, "seq": J_MIX_T,
                                "card_vs_cpu_f32": mixer,
                                "decode_after_prefill_vs_forward_rel": step_rel,
                                "limit": CARD_CPU_REL,
                                "seconds": time.perf_counter() - t0}}
    print(f"jamba-1.5-large-398b ({smi_line()}): {json.dumps(out)}", flush=True)
    del pc, xc, full, stepped, cache
    torch.cuda.empty_cache()
    return train["encode_launches"], out


def deepseek67_part(torch, kernels):
    """(D) deepseek-67b at full width, 4 of its 95 layers (the 95 are 67 B
    parameters, ≈ 134 GB in bf16): the continuous engine with 16 slots,
    the decode pair at G 8, D 128."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(DS67_ARCH).replace(num_layers=DS67_LAYERS)
    check(cfg.num_heads // cfg.num_kv_heads == 8 and cfg.head_dim == 128, "deepseek-67b heads")
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    n_params = sum(x.numel() for x in tree_leaves(params))
    decode, serving = continuous_run(
        torch, kernels, cfg, params, slots=DS67_SLOTS, max_seq=DS67_MAX_SEQ,
        requests=DS67_REQUESTS, plen=DS67_PLEN, glen=DS67_GLEN, label="deepseek-67b")
    out = {"layers": f"{DS67_LAYERS} of 95", "params": n_params, "serving": serving}
    print(f"deepseek-67b ({smi_line()}): {json.dumps(out)}", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return decode, out


def recurrent_audio_vlm_phase(torch):
    """The five archs of the recurrent / audio / VLM slice, each part's
    kernel counts set to 0 before it and read after."""
    from repro_torch import kernels

    t0 = time.perf_counter()
    launches = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    vlm_launches, vlm = vlm_part(torch, kernels)
    for name, n in vlm_launches.items():
        launches[name] += n
    xl_encode, xl = xlstm_part(torch, kernels)
    whisper = whisper_part(torch)
    j_encode, jamba = jamba_part(torch, kernels)
    ds_launches, ds67 = deepseek67_part(torch, kernels)
    launches["topk_encode"] += xl_encode + j_encode
    for name, n in ds_launches.items():
        launches[name] += n
    out = {"qwen2-vl-2b": vlm, "xlstm-125m": xl, "whisper-base": whisper,
           "jamba-1.5-large-398b": jamba, "deepseek-67b": ds67,
           "seconds": time.perf_counter() - t0}
    return launches, out


# ----------------------------------------------------------------------------
# Launch specs, sharding and the dry run: tinyllama-1.1b's decode_32k serve
# step built by launch.specs through the decode pair at S 32,768; long_500k
# on the plain windowed path; the train step's accumulation; the dry run
# ----------------------------------------------------------------------------

LAUNCH_ARCH = "tinyllama-1.1b"
#: decode_32k is B 128 × S 32,768; B is cut to 32: at 128 the bf16 cache
#: alone is 128 × 32,768 × 4 × 64 × 2 B × 2 × 22 = 94.49 GB, more than the
#: card holds; at 32 it is 23.62 GB
LAUNCH_B = 32
#: long_500k at its published shape: B 1 × S 524,288, window 8,192
LONG_B, LONG_WINDOW = 1, 8192
#: train_4k is B 256 × T 4,096; B is cut to 4, one row a microbatch
ACCUM_B, ACCUM_MB = 4, 4
#: the accumulation check in f32 compute: one Adam step moves every element
#: by ±lr, so a bf16 gradient whose sign differs between the two
#: summations would move it by 2·lr; in f32 only last-bit ties can
#: (tests/test_torch_train.py's rule: all but FEW of the elements within
#: rtol / atol, every one within 2·lr)
ACCUM_RTOL, ACCUM_ATOL, ACCUM_FEW = 1e-5, 1e-6, 2e-4
#: the accumulated f32 gradients the optimizer is handed, against the whole
#: batch's: each leaf within 1e-5 × its max |g| (tests/test_torch_train.py's
#: GRAD_TOL).  One Adam step cannot see their scale, a sum left undivided
#: by the count (×4) or divided twice (×1/4) would pass the θ check
ACCUM_GRAD_TOL = 1e-5
#: row 7's bf16 bounds, held on each of the step's 22 attention calls (the
#: pair against its plain version on that layer's own inputs): |Δ| and Δ a
#: row over the row's norm.  The step's logits and written K / V rows are
#: held to the plain step's at the serving phase's ``LOGIT_TOL``: the two
#: attention paths differ by bf16 rounding, which 22 bf16 layers carry
#: into the residual stream (measured on the CPU at full width, B 2: the
#: plain step against the same step through the pair's plain version,
#: 0.117 at most in logits of scale 3.8, 3.4 % of a row's norm)
STEP_TOL, STEP_REL_TOL = 3e-2, 8e-3


def _fill_cache(torch, cache, gen) -> int:
    """Seeded standard-normal keys and values in every layer; returns the
    cache's bytes."""
    nbytes = 0
    for seg in cache.values():
        for c in seg.values():
            for t in (c.k, c.v):
                t.normal_(generator=gen)
                nbytes += t.numel() * t.element_size()
    return nbytes


def _written_rows(torch, cache, pos: int):
    """Every layer's K and V rows at ``pos`` (the ones the step wrote)."""
    c = cache["seg0"]["l0"]
    return torch.stack([c.k[:, :, pos], c.v[:, :, pos]]).float().clone()


def _row_errors(torch, got, want) -> tuple[float, float]:
    """|Δ| and the largest Δ of a row over the row's norm (last axis)."""
    want = want.float()
    d = got.float() - want
    rel = (d.flatten(0, -2).norm(dim=-1)
           / want.flatten(0, -2).norm(dim=-1).clamp_min(1e-30)).max()
    return float(d.abs().max()), float(rel)


def _step_close(torch, got, want, what: str) -> dict:
    """A step's output against the plain step's: finite, |Δ| within
    ``LOGIT_TOL``; the row errors reported."""
    err, rel = _row_errors(torch, got, want)
    check(bool(torch.isfinite(got).all()), f"{what}: not finite")
    check(err <= LOGIT_TOL, f"{what}: |kernel step - plain step| {err} > {LOGIT_TOL}")
    return {"max_abs": err, "max_row_rel": rel, "scale": float(want.float().abs().max())}


def _profiled_step(torch, step, args) -> dict:
    """One step under the profiler: wall (ending in a synchronize), device
    busy time, its share of the wall, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e3
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:4]
    check(busy > 0, "the profiler saw no device time")
    return {"wall_ms": wall, "device_ms": busy, "idle_share": 1 - busy / wall,
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top]}


def _walls(torch, step, args, reps: int = 5) -> dict:
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"median": statistics.median(walls), "min": min(walls), "max": max(walls)}


def launch_decode(torch, kernels):
    """(L1) The decode_32k serve step of ``launch.specs.build_jitted`` on
    the host mesh, plain (the reference's default) and through the decode
    pair (``decode_attn="cuda"``), then the pair alone at this shape in
    turns with SDPA."""
    import torch.nn.functional as F

    from repro_torch.configs import SHAPES
    from repro_torch.kernels.decode_attention import kernel as dak, ref as dar
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    shape = SHAPES["decode_32k"]
    B, S_len = LAUNCH_B, shape.seq_len
    cfg = S.shape_adapted_config(LAUNCH_ARCH, "decode_32k")
    mesh = make_host_mesh()
    plain_step, args, _ = S.build_jitted(cfg, "decode", mesh, B, S_len)
    kernel_step, _, _ = S.build_jitted(cfg, "decode", mesh, B, S_len, decode_attn="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(gen, cfg)
    param_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    cache = tf.init_cache(cfg, B, S_len, torch.bfloat16, index=S_len - 1, device="cuda")
    cache_bytes = _fill_cache(torch, cache, gen)
    spec_leaves = [x for x in tree_leaves(args[1]["cache"]) if isinstance(x, torch.Tensor)]
    check([tuple(x.shape) for x in spec_leaves]
          == [tuple(x.shape) for x in tree_leaves(cache) if isinstance(x, torch.Tensor)],
          "the cache is not input_specs_for's")
    check(cache_bytes == 2 * cfg.num_layers * B * S_len * cfg.num_kv_heads * cfg.head_dim * 2,
          "cache bytes")
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device="cuda",
                           dtype=torch.int32)
    batch = {"tokens": tokens, "cache": cache}
    torch.cuda.synchronize()
    bound = {"cache_ms": cache_bytes / HBM_BYTES_PER_S * 1e3,
             "params_ms": param_bytes / HBM_BYTES_PER_S * 1e3}
    bound["step_ms"] = bound["cache_ms"] + bound["params_ms"]

    logits_p, new_p = plain_step(params, batch)
    torch.cuda.synchronize()
    check(tuple(logits_p.shape) == (B, 1, cfg.padded_vocab), "plain logits shape")
    check(new_p["seg0"]["l0"].index == S_len, "the plain step's fill index")
    rows_p = _written_rows(torch, cache, S_len - 1)
    # the kernel step, each attention call also held to the pair's plain
    # version on its own inputs (plain math: no launch)
    from repro_torch.models import attention

    attend, layer_errs = attention._decode_attend, []

    def checked(q1, k_all, v_all, valid_len, *, impl):
        out = attend(q1, k_all, v_all, valid_len, impl=impl)
        layer_errs.append(_row_errors(
            torch, out, dar.decode_attention_plain(q1, k_all, v_all, valid_len)))
        return out

    kernels.reset_launches()
    try:
        attention._decode_attend = checked
        logits_k, new_k = kernel_step(params, batch)
        torch.cuda.synchronize()
    finally:
        attention._decode_attend = attend
    launches = {n: kernels.LAUNCHES[n] for n in ("decode_attention", "decode_attention_merge")}
    check(len(layer_errs) == cfg.num_layers
          and max(e for e, _ in layer_errs) <= STEP_TOL
          and max(r for _, r in layer_errs) <= STEP_REL_TOL,
          f"decode_32k: the pair against its plain version on each layer's inputs "
          f"{layer_errs} (limits {STEP_TOL}, {STEP_REL_TOL} a row)")
    check(launches == {"decode_attention": cfg.num_layers,
                       "decode_attention_merge": cfg.num_layers},
          f"decode_32k step: decode launches {launches}, not {cfg.num_layers} each")
    check(sum(kernels.LAUNCHES.values()) == 2 * cfg.num_layers, "another kernel launched")
    rows_k = _written_rows(torch, cache, S_len - 1)
    close = {"layers": {"max_abs": max(e for e, _ in layer_errs),
                        "max_row_rel": max(r for _, r in layer_errs)},
             "logits": _step_close(torch, logits_k, logits_p, "decode_32k logits"),
             "cache_rows": _step_close(torch, rows_k, rows_p, "decode_32k cache rows")}
    check(torch.equal(rows_k[:, 0], rows_p[:, 0]), "layer 0's written rows differ")
    lk, lp = logits_k[:, 0, : cfg.vocab_size].float(), logits_p[:, 0, : cfg.vocab_size].float()
    top2 = lk.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > close["logits"]["max_abs"]
    same = lk.argmax(-1) == lp.argmax(-1)
    check(bool(same[clear].all()), "decode_32k: argmax differs where the margin is clear")
    close["logits"].update(argmax_equal_rows=int(same.sum()), rows_clear_margin=int(clear.sum()))

    kernels.reset_launches()
    timing = {"plain": {"walls": _walls(torch, plain_step, (params, batch), reps=3),
                        **_profiled_step(torch, plain_step, (params, batch))},
              "kernel": {"walls": _walls(torch, kernel_step, (params, batch)),
                         **_profiled_step(torch, kernel_step, (params, batch)),
                         "aten_ops": aten_ops(lambda: kernel_step(params, batch))}}
    kernels.reset_launches()

    # the pair alone on layer 0's cache, in turns with SDPA
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k, v = cache["seg0"]["l0"].k[0], cache["seg0"]["l0"].v[0]
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").bfloat16()
    vl = torch.full((B,), S_len, dtype=torch.int32, device="cuda")
    out = dak.decode_attention(q, k, v, vl)
    plain = dar.decode_attention_plain(q, k, v, vl)
    pair_err = float((out.float() - plain.float()).abs().max())
    check(pair_err <= DECODE_TOL["bfloat16"], f"decode pair at S {S_len}: {pair_err}")
    mask = torch.ones((B, 1, 1, S_len), dtype=torch.bool, device="cuda")
    q4, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    lib = F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask, enable_gqa=True)
    lib_err = float((lib[:, :, 0].float() - plain.float()).abs().max())
    nbytes = 2 * B * S_len * Hkv * D * 2 + 2 * q.numel() * 2 + vl.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 4 * Hq * B * S_len * D, BF16_OPS_PER_S)
    t = turns_ms(torch, {
        "library": lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True),
        "kernel": lambda: dak.decode_attention(q, k, v, vl),
    }, inner=10, rounds=3)
    pair = {"shape": [B, S_len, Hq, Hkv, D], "ms": t["kernel"]["median"], "ms_runs": t["kernel"],
            "library_ms": t["library"]["median"], "library_runs": t["library"],
            "plain_ms": graph_ms(torch, lambda: dar.decode_attention_plain(q, k, v, vl),
                                 inner=2, reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "max_abs_err": pair_err,
            "library_max_abs_err": lib_err, "splits": dak.plan_splits(
                B, Hkv, S_len, torch.cuda.get_device_properties(0).multi_processor_count)}
    kernels.reset_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    res = {"cut": "decode_32k's B 128 → 32 (the bf16 cache is 94.49 GB at 128)",
           "B": B, "S": S_len, "cache_bytes": cache_bytes, "param_bytes": param_bytes,
           "bound": bound, "launches": launches, "close": close, "steps": timing,
           "pair": pair, "peak_gib": peak}
    print(f"launch (L1) decode_32k step of {LAUNCH_ARCH} ({smi_line()}): {json.dumps(res)}",
          flush=True)
    del params, cache, batch, logits_p, logits_k, new_p, new_k, k, v
    torch.cuda.empty_cache()
    return launches, res


def launch_long(torch, kernels):
    """(L2) long_500k at B 1 × S 524,288 with the 8,192 window: the plain
    windowed step (the pair has no window: ``resolve_decode_attn``
    refuses), held to the same query against only the last 8,192
    positions."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import resolve_decode_attn

    shape = SHAPES["long_500k"]
    B, S_len = LONG_B, shape.seq_len
    check(B == shape.global_batch, "long_500k's batch")
    cfg = S.shape_adapted_config(LAUNCH_ARCH, "long_500k")
    check(cfg.sliding_window == LONG_WINDOW, "long_500k's window")
    try:
        resolve_decode_attn(True, sliding_window=cfg.sliding_window)
        check(False, "resolve_decode_attn took a window")
    except ValueError:
        pass
    step, _, _ = S.build_jitted(cfg, "decode", make_host_mesh(), B, S_len)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tf.init_params(gen, cfg)
    cache = tf.init_cache(cfg, B, S_len, torch.bfloat16, index=S_len - 1, device="cuda")
    cache_bytes = _fill_cache(torch, cache, gen)
    # the last 8,192 positions alone, the query at the same position
    last = tf.init_cache(cfg, B, LONG_WINDOW, torch.bfloat16, index=LONG_WINDOW - 1,
                         device="cuda")
    for name, c in cache["seg0"].items():
        last["seg0"][name].k.copy_(c.k[:, :, S_len - LONG_WINDOW:])
        last["seg0"][name].v.copy_(c.v[:, :, S_len - LONG_WINDOW:])
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device="cuda",
                           dtype=torch.int32)
    # each layer's windowed attention over the whole cache against the same
    # query over the last 8,192 keys alone, on the layer's own inputs
    from repro_torch.models import attention

    sdpa, layer_errs = attention._sdpa, []

    def checked(q, k, v, mask, *, scale):
        out = sdpa(q, k, v, mask, scale=scale)
        if k.shape[1] == S_len:
            m = mask.reshape(-1, S_len)
            check(bool(m[:, S_len - LONG_WINDOW:].all()) and int(m.sum()) == m.shape[0]
                  * LONG_WINDOW, "long_500k: the mask is not the last 8,192 positions")
            ones = torch.ones((q.shape[1], LONG_WINDOW), dtype=torch.bool, device=q.device)
            layer_errs.append(_row_errors(torch, out, sdpa(
                q, k[:, S_len - LONG_WINDOW:], v[:, S_len - LONG_WINDOW:], ones, scale=scale)))
        return out

    kernels.reset_launches()
    step(params, {"tokens": tokens, "cache": cache})  # warm: the row it writes is the same
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, new = step(params, {"tokens": tokens, "cache": cache})
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    try:
        attention._sdpa = checked
        step(params, {"tokens": tokens, "cache": cache})
    finally:
        attention._sdpa = sdpa
    check(len(layer_errs) == cfg.num_layers and max(e for e, _ in layer_errs) <= STEP_TOL
          and max(r for _, r in layer_errs) <= STEP_REL_TOL,
          f"long_500k: windowed against the last {LONG_WINDOW} keys a layer {layer_errs}")
    check(sum(kernels.LAUNCHES.values()) == 0, "long_500k launched a kernel")
    check(new["seg0"]["l0"].index == S_len, "long_500k's fill index")
    ref, _ = tf.decode_step(params, cfg, tokens, last, positions=torch.full(
        (B, 1), S_len - 1, dtype=torch.int64, device="cuda"))
    close = _step_close(torch, logits, ref, "long_500k logits")
    top2 = logits[:, 0, : cfg.vocab_size].topk(2, dim=-1).values
    same = bool(logits[:, 0, : cfg.vocab_size].argmax(-1) == ref[:, 0, : cfg.vocab_size]
                .argmax(-1))
    check(same or float(top2[0, 0] - top2[0, 1]) <= close["max_abs"],
          "long_500k: argmax differs where the margin is clear")
    res = {"B": B, "S": S_len, "window": LONG_WINDOW, "cache_bytes": cache_bytes,
           "path": "plain (resolve_decode_attn refuses a window)",
           "layers_vs_last_window": {"max_abs": max(e for e, _ in layer_errs),
                                     "max_row_rel": max(r for _, r in layer_errs)},
           "logits_vs_last_window": close, "argmax_equal": same,
           "wall_ms": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"launch (L2) long_500k step of {LAUNCH_ARCH}: {json.dumps(res)}", flush=True)
    del params, cache, last, logits, new, ref
    torch.cuda.empty_cache()
    return res


def launch_accumulation(torch):
    """(L3) ``make_train_step`` at train_4k's T 4,096, B 4: accumulated
    over 4 microbatches against the whole batch at once, from the same θ;
    θ after the step within tests/test_torch_train.py's f32 rule, and the
    gradients Adam is handed (the accumulated f32 sum, each microbatch's
    divided by the count) within ``ACCUM_GRAD_TOL`` of the whole batch's."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs as S
    from repro_torch.models import transformer as tf
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.utils.tree import tree_flatten

    torch.backends.cuda.matmul.allow_tf32 = False
    T = SHAPES["train_4k"].seq_len
    cfg = S.shape_adapted_config(LAUNCH_ARCH, "train_4k").replace(compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (ACCUM_B, T + 1), generator=gen, device="cuda",
                           dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
    out = {"cut": "train_4k's B 256 → 4, compute in f32", "B": ACCUM_B, "T": T}
    thetas, grads = {}, {}
    for mb in (ACCUM_MB, 1):
        params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
        adam = S.make_optimizer(cfg)

        def keep_grads(g, state, params=None, adam=adam, mb=mb):
            grads[mb] = tree_flatten(g)[0]
            return adam.update(g, state, params)

        opt = Optimizer(init=adam.init, update=keep_grads)
        state = opt.init(params)
        step = S.make_train_step(cfg, opt, microbatches=mb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        loss = float(metrics["loss"])
        check(math.isfinite(loss) and int(state["count"]) == 1, f"microbatches {mb}: step")
        out[f"microbatches {mb}"] = {"loss": loss, "wall_s": wall,
                                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        thetas[mb] = tree_flatten(params)[0]
        del state, opt
        torch.cuda.empty_cache()
    lr = 3e-4 / 100  # make_optimizer's warmup-cosine at step 1
    outside = total = 0
    worst = 0.0
    for a, b in zip(thetas[ACCUM_MB], thetas[1]):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        outside += int((d > ACCUM_ATOL + ACCUM_RTOL * b.abs()).sum())
        total += b.numel()
    check(worst <= 2 * lr and outside <= ACCUM_FEW * total,
          f"accumulated θ: {outside} of {total} outside rtol/atol, max |Δ| {worst}")
    g_worst = 0.0  # max over leaves of max |g_acc − g| / max |g|
    for a, b in zip(grads[ACCUM_MB], grads[1]):
        check(a.dtype == torch.float32, f"accumulated gradient in {a.dtype}")
        g_worst = max(g_worst, float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)))
    g_norm = (math.sqrt(sum(float(a.double().square().sum()) for a in grads[ACCUM_MB]))
              / math.sqrt(sum(float(b.double().square().sum()) for b in grads[1])))
    check(g_worst <= ACCUM_GRAD_TOL,
          f"accumulated gradients: max |Δ| / max |g| {g_worst} > {ACCUM_GRAD_TOL} "
          f"(norm ratio {g_norm})")
    check(abs(out[f"microbatches {ACCUM_MB}"]["loss"] - out["microbatches 1"]["loss"])
          <= 1e-4 * abs(out["microbatches 1"]["loss"]), "accumulated loss")
    out["theta"] = {"outside_rtol_atol": outside, "elements": total, "max_abs": worst,
                    "lr_step1": lr}
    out["grads"] = {"max_abs_over_max_g": g_worst, "limit": ACCUM_GRAD_TOL,
                    "norm_ratio": g_norm}
    print(f"launch (L3) accumulation of {LAUNCH_ARCH}: {json.dumps(out)}", flush=True)
    del thetas, grads
    torch.cuda.empty_cache()
    return out


#: (L4)'s added combinations, one per family the uneven head split or the
#: experts' FSDP dimension had failed: (arch, shape, layers kept or None)
DRYRUN_ADDED = [("minicpm3-4b", "decode_32k", None), ("whisper-base", "prefill_32k", None),
                ("xlstm-125m", "decode_32k", None), ("deepseek-v3-671b", "train_4k", 2)]
#: the same combinations' counts a device on the 16×16 fake world under
#: torch 2.13.0+cpu (the dry run on a CPU-only host): FLOPs, collective
#: bytes, argument bytes
DRYRUN_CPU_COUNTS = {
    "minicpm3-4b × decode_32k": (2877423616000.0, 185914597376.0, 2233559072),
    "whisper-base × prefill_32k": (139048910848.0, 437830144.0, 32493568),
    "xlstm-125m × decode_32k": (343302144.0, 156394080.0, 234957632),
    "deepseek-v3-671b × train_4k": (180115359137792.0, 6935197515296.0, 1316818948),
}


def dryrun_config(arch, shape, layers):
    """The shape-adapted config of ``arch``, or with ``layers`` its widths
    and sharding with the first ``layers`` layers, one dense and the rest
    MoE (deepseek-v3-671b's full 61 take minutes to count)."""
    import dataclasses

    from repro_torch.launch import specs as S

    cfg = S.shape_adapted_config(arch, shape)
    if layers is None:
        return cfg
    return cfg.replace(num_layers=layers, moe=dataclasses.replace(cfg.moe, first_k_dense=1))


def launch_dryrun(torch):
    """(L4) The dry run of tinyllama-1.1b × train_4k, then of one repaired
    combination per family (``DRYRUN_ADDED``), each on a fake world of 256
    ranks on this machine's host (counts, not timings), each printed
    beside the CPU-only host's counts."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    def one(arch, shape, config=None):
        check(not dist.is_initialized(), "a process group is up before the dry run")
        res = dryrun.run_one(arch, shape, config=config)
        check(res["status"] == "ok", f"dry run {arch} × {shape}: {res.get('error')}")
        check(not dist.is_initialized(), "the dry run left its world up")
        return res

    res = one(LAUNCH_ARCH, "train_4k")
    out = {"torch": torch.__version__, "mesh": res["mesh"], "chips": res["chips"],
           "argument_bytes_per_device": res["memory"]["argument_size_in_bytes"],
           "memtracker_peak_bytes_per_device": res["memory"]["memtracker_peak_bytes"],
           "flops_per_device": res["cost_corrected"]["flops"],
           "bytes_per_device": res["cost_corrected"]["bytes"],
           "collective_bytes_per_device": res["cost_corrected"]["coll"],
           "collectives": {k: v for k, v in res["collectives_raw"].items()
                           if k not in ("by_tier",)},
           "op_census": res["op_census"], "seconds": res["probe_s"] + res["lower_s"]}
    print(f"launch (L4) dry run {LAUNCH_ARCH} × train_4k (counts on the host): "
          f"{json.dumps(out)}", flush=True)
    added = {}
    for arch, shape, layers in DRYRUN_ADDED:
        res = one(arch, shape, dryrun_config(arch, shape, layers))
        key = f"{arch} × {shape}"
        flops, coll, args = DRYRUN_CPU_COUNTS[key]
        added[key] = {
            "status": res["status"], "layers": layers or "all",
            "flops_per_device": res["cost_corrected"]["flops"], "cpu_host_flops": flops,
            "collective_bytes_per_device": res["cost_corrected"]["coll"],
            "cpu_host_collective_bytes": coll,
            "argument_bytes_per_device": res["memory"]["argument_size_in_bytes"],
            "cpu_host_argument_bytes": args,
            "bytes_per_device": res["cost_corrected"]["bytes"],
            "memtracker_peak_bytes_per_device": res["memory"]["memtracker_peak_bytes"],
            "seconds": res["probe_s"] + res["lower_s"]}
        print(f"launch (L4) dry run {key} (counts on the host, torch {torch.__version__}, "
              f"beside torch 2.13.0+cpu's): {json.dumps(added[key])}", flush=True)
    out["added"] = added
    return out


def launch_phase(torch):
    """Launch specs and the dry run, each part's kernel counts set to 0
    before it and read after."""
    from repro_torch import kernels

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches, decode = launch_decode(torch, kernels)
    long_ = launch_long(torch, kernels)
    accum = launch_accumulation(torch)
    dry = launch_dryrun(torch)
    kernels.reset_launches()
    return launches, {"decode_32k": decode, "long_500k": long_, "accumulation": accum,
                      "dryrun": dry, "seconds": time.perf_counter() - t0}


#: the whole run's seconds before the many-client phases, as PERF.md
#: records it (NVIDIA H100 80GB HBM3, 700 W)
EARLIER_WHOLE_RUN_S = 389.47

REPLACES = {
    "topk_encode": "src/repro/kernels/topk_compress/kernel.py:73",
    "topk_select": "src/repro/kernels/topk_compress/kernel.py:106",
    "int8_absmax": "src/repro/kernels/int8_quant/kernel.py:34",
    "int8_quant": "src/repro/kernels/int8_quant/kernel.py:53",
    "int8_encode": "src/repro/kernels/int8_quant/kernel.py:53",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:31",
    "decode_attention_merge": "src/repro/kernels/decode_attention/kernel.py:74",
    "pdist_argmin": "src/repro/kernels/pdist_argmin/kernel.py:20",
    "pdist_argmin_tc": "src/repro/kernels/pdist_argmin/kernel.py:20",
    "flash_attention_tf32_prep": "src/repro/kernels/flash_attention/kernel.py:28",
    "flash_attention_tf32": "src/repro/kernels/flash_attention/kernel.py:28",
    "flash_attention_tc": "src/repro/kernels/flash_attention/kernel.py:28",
    "topk_count": "src/repro/kernels/topk_compress/kernel.py:35",
    "topk_mask": "src/repro/kernels/topk_compress/kernel.py:56",
}
SOURCES = {
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "decode_attention_merge": "src/repro_torch/csrc/decode_attention.cu",
    "pdist_argmin": "src/repro_torch/csrc/pdist_argmin.cu",
    "pdist_argmin_tc": "src/repro_torch/csrc/pdist_argmin_tc.cu",
    "flash_attention_tf32_prep": "src/repro_torch/csrc/flash_attention_tf32.cu",
    "flash_attention_tf32": "src/repro_torch/csrc/flash_attention_tf32.cu",
    "flash_attention_tc": "src/repro_torch/csrc/flash_attention_tc.cu",
    "topk_count": "src/repro_torch/csrc/topk_sparsify.cu",
    "topk_mask": "src/repro_torch/csrc/topk_sparsify.cu",
}


def main() -> int:
    if not os.path.isfile(os.path.join(SRC, "repro_torch", "__init__.py")):
        print("chip_smoke.py: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    t_run = time.perf_counter()
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    smi = smi_line()
    print(f"card: {smi}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s, all sources at once "
          f"(nvcc " + ", ".join(
              f"{n} {build.build_info(n)['seconds']:.2f} s" for n in build.SIGNATURES)
          + ")", flush=True)
    for name in build.SIGNATURES:
        print(build.build_info(name)["log"].strip(), flush=True)
    for name in ("flash_attention_tc", "flash_attention_tf32", "decode_attention",
                 "pdist_argmin_tc", "pdist_argmin"):
        print(f"ptxas {name}: " + json.dumps(ptxas_summary(build.build_info(name)["log"])),
              flush=True)
    tc, dec = build.library("flash_attention_tc"), build.library("decode_attention")
    tf32 = build.library("flash_attention_tf32")
    widths = (8, 16, 32, 64, 128, 80, 256)
    print("dynamic shared memory (bytes): flash_attention_tc " + json.dumps(
        {f"D {d}": tc.repro_flash_attention_tc_smem(d) for d in widths})
        + ", flash_attention_tf32 " + json.dumps(
            {f"D {d}": tf32.repro_flash_attention_tf32_smem(d) for d in widths})
        + ", decode split bf16 G 8 " + json.dumps(
            {f"D {d}": dec.repro_decode_attention_smem(d, 8, 1) for d in widths}), flush=True)

    err, timings = kernel_phase(torch)
    decode_err, decode_t, merge_t = decode_kernel_phase(torch)
    err.update(decode_err)
    timings[("decode_attention", "main")] = decode_t["main"]
    timings[("decode_attention_merge", "main")] = merge_t
    data = make_epsilon_shaped(torch, 0)
    launches, run_a = main_path(torch, data)
    exec_launches, executors = executors_phase(torch, data, run_a)
    for name, n in exec_launches.items():
        launches[name] += n
    many_launches, many_clients = many_clients_phase(torch, data, timings)
    for name, n in many_launches.items():
        launches[name] += n
    ref_a = run_a["res"]  # θ, trajectory and ledger for the serving phase's bitwise checks
    del data, run_a
    torch.cuda.empty_cache()
    secure = security_phase(torch)
    families = ml_families_phase(torch)
    served = serve_phase(torch)
    for name in ("decode_attention", "decode_attention_merge"):
        launches[name] = served[name]
    rh_launches, reheaded = reheaded_serve_phase(torch)  # (H1)
    for name, n in rh_launches.items():
        launches[name] += n
    st_launches, serving_tracing = serving_tracing_phase(torch, ref_a)
    for name, n in st_launches.items():
        launches[name] += n
    del ref_a
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Xs, C0 = make_kdd_shaped(torch, 0)
    torch.cuda.synchronize()
    print(f"KDD Cup 1999-shaped data {tuple(Xs.shape)} f32 on the card "
          f"({Xs.numel() * 4 / 1e9:.3f} GB) in {time.perf_counter() - t0:.4f} s", flush=True)
    pdist_err, pdist_tc_t, pdist_cc_t = pdist_kernel_phase(torch, Xs, C0)
    err.update(pdist_err)
    timings[("pdist_argmin_tc", "main")] = pdist_tc_t
    timings[("pdist_argmin", "main")] = pdist_cc_t["l1"]
    launches["pdist_argmin_tc"], full_err, kmeans_stats = kmeans_phase(torch, Xs, C0)
    err["pdist_argmin_tc"] = max(err["pdist_argmin_tc"], full_err)
    del Xs, C0
    torch.cuda.empty_cache()
    launches["pdist_argmin"] = family_phase(torch)
    wide_launches, wide_kmeans = wide_kmeans_phase(torch)  # (H3)
    launches["pdist_argmin"] += wide_launches
    print("k-means iteration:", json.dumps(kmeans_stats), flush=True)
    flash_err, flash_t = flash_kernel_phase(torch)
    err.update(flash_err)
    timings.update(flash_t)
    flash_launches, attn_err, attn_stats, leaf, attn_control = attention_path_phase(torch)
    launches.update(flash_launches)
    # (H2) the re-headed model's 22 layers, bf16 and f32
    rh_attn = attention_path_phase(torch, reheaded_config())
    check(rh_attn[0] == {n: 22 for n in flash_launches}, f"re-headed launches {rh_attn[0]}")
    for name, n in rh_attn[0].items():
        launches[name] += n
    rh_attn = {"errors": rh_attn[1], **rh_attn[2], "control": rh_attn[4]}
    tk_launches, tk_timings, tk_whole, tk_err, encode_leaf_t = topk_phase(torch, leaf)
    del leaf
    torch.cuda.empty_cache()
    launches.update(tk_launches)
    err.update(tk_err)
    for name, t in tk_timings.items():
        timings[(name, "main")] = t
    for name, t in encode_leaf_t.items():
        timings[(name, "leaf")] = t
    train_launches, train_stats = train_phase(torch)
    launches["topk_encode"] += train_launches
    int8_train_launches, _ = int8_training_phase(torch)
    for name, n in int8_train_launches.items():
        launches[name] += n
    moe_decode, moe_encode, mla_moe_mtp = mla_moe_mtp_phase(torch)
    for name in ("decode_attention", "decode_attention_merge"):
        launches[name] += moe_decode[name]
    launches["topk_encode"] += moe_encode
    rav_launches, rav = recurrent_audio_vlm_phase(torch)
    for name, n in rav_launches.items():
        launches[name] += n
    launch_launches, launch = launch_phase(torch)
    for name, n in launch_launches.items():
        launches[name] += n
    print("executors:", json.dumps(executors), flush=True)
    print("many clients:", json.dumps(many_clients), flush=True)
    print("serving and tracing:", json.dumps(serving_tracing), flush=True)
    print("security wires and private regression:", json.dumps(secure), flush=True)
    print("ml families:", json.dumps(families), flush=True)
    print("attention path:", json.dumps({"errors": attn_err, **attn_stats,
                                         "planted_control": attn_control}), flush=True)
    print("re-headed tinyllama-1.1b (Gemma-2B's 8 × 256 / 1 × 256 heads): serving",
          json.dumps(reheaded), "; attention path", json.dumps(rh_attn), "; l1 k-means at d "
          f"{WIDE_KM_D}", json.dumps(wide_kmeans), flush=True)
    print("topk_sparsify:", json.dumps(tk_whole), flush=True)
    print("MLA, MoE and MTP:", json.dumps(mla_moe_mtp), flush=True)
    print("recurrent, audio and VLM:", json.dumps(rav), flush=True)
    print("launch specs and the dry run:", json.dumps(launch), flush=True)
    print("redesigned kernels, times in turns with the library call:", json.dumps({
        "decode_attention": decode_t, "decode_attention_merge": merge_t,
        **{f"{n} {label}": t for (n, label), t in flash_t.items()},
        "pdist_argmin_tc": pdist_tc_t["turns"],
        **{f"pdist_argmin {m}": {"turns": pdist_cc_t[m]["turns"],
                                 "first_design_ms_recorded": EARLIER_PDIST_MS[m]}
           for m in ("l1", "linf")},
        "pdist_argmin alone at the KDD shape": pdist_cc_t["kdd"],
        "pdist_argmin wide rows (split kernel)": pdist_cc_t["wide"],
        "topk_mask": tk_timings["topk_mask"]["turns"],
        "topk_count leaf": tk_timings["topk_count"]["turns"],
        "topk_sparsify leaf": tk_whole["turns"],
        **{f"int8_absmax {label}": timings[("int8_absmax", label)]["turns"]
           for label in ("main", "2^24")},
        **{f"int8_encode {label}": timings[("int8_encode", label)]["turns"]
           for label in ("main", "main no EF", "sweep", "2^24", "2^24 no EF", "leaf")},
        **{f"{name} {label}": timings[(name, label)]["turns"]
           for name in ("topk_encode", "topk_select") for label in ("main", "2^24", "leaf")}}),
        flush=True)
    for name in REPLACES:
        check(launches.get(name, 0) > 0, f"kernel {name} was never launched on the main path")

    print("times at 2^24:", json.dumps({n: timings[(n, "2^24")] for n in REPLACES
                                        if (n, "2^24") in timings}))
    print(f"times at the sweep's rows ({8 * K}, {D}):", json.dumps(
        {n: timings[(n, "sweep")] for n in REPLACES if (n, "sweep") in timings}))
    print(f"times at the many-client rows ({MANY_K}, {D}):", json.dumps(
        {n: timings[(n, "100k")] for n in REPLACES if (n, "100k") in timings}))
    rows = []
    for name in REPLACES:
        t = timings[(name, "main")]
        rows.append({
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, "src/repro_torch/csrc/wire_kernels.cu"),
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(f"whole run: {time.perf_counter() - t_run:.2f} s (before the many-client "
          f"phases: {EARLIER_WHOLE_RUN_S} s recorded)", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
